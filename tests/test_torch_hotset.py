"""The port's replicated hot set (gubernator_tpu_torch/hotset.py) held to
the JAX HotSetEngine on a 4-device CPU mesh: the same pins, requests and
syncs go to both, at n = 4 replicas.  Tolerance: exact — every answer of
every replica, the pin results and, after every sync, all nine state
columns and the base of every replica are equal.  The cases are those
of tests/test_hotset.py, plus seeded streams over both algorithms and
both request paths (objects and columns)."""
import numpy as np
import pytest

from gubernator_tpu_torch.core.batch import pack_columns
from gubernator_tpu_torch.hashing import hash_key
from gubernator_tpu_torch.hotset import HotSetEngine
from gubernator_tpu_torch.types import RateLimitRequest, Status

NOW = 1_764_000_000_000
FIELDS = ("key", "meta", "limit", "duration", "eff_ms", "burst",
          "remaining", "t_ms", "expire_at")


@pytest.fixture(scope="module")
def meshes():
    from gubernator_tpu.parallel import make_mesh

    return {n: make_mesh(n=n) for n in (2, 4)}


def req(key="hk", limit=100, hits=1, duration=60_000, algorithm=0,
        burst=0):
    return dict(name="hot", unique_key=key, hits=hits, limit=limit,
                duration=duration, algorithm=algorithm, burst=burst)


def lreq(key="lk", limit=1000, hits=1, duration=60_000, burst=0):
    return req(key, limit, hits, duration, 1, burst)


def kh(key="hk"):
    return hash_key("hot", key)


class Pair:
    """One JAX and one port hot set, driven in lockstep."""

    def __init__(self, meshes, n=4, capacity=256, batch_per_chip=32):
        from gubernator_tpu.parallel.hotset import HotSetEngine as JaxHot

        self.j = JaxHot(meshes[n], capacity=capacity,
                        batch_per_chip=batch_per_chip)
        self.p = HotSetEngine(n, capacity=capacity,
                              batch_per_chip=batch_per_chip, device="cpu")
        self.n = n

    def pin(self, r, key, now, seed=None):
        from gubernator_tpu.types import RateLimitRequest as JaxReq

        a = self.j.pin(JaxReq(**r), kh(key), now, seed=seed)
        b = self.p.pin(RateLimitRequest(**r), kh(key), now, seed=seed)
        assert a == b
        assert self.j.slots == self.p.slots
        assert self.j._retired == self.p._retired
        return b

    def check(self, reqs, now):
        from gubernator_tpu.types import RateLimitRequest as JaxReq

        keys = [kh(r["unique_key"]) for r in reqs]
        want = self.j.check_batch([JaxReq(**r) for r in reqs], keys, now)
        got = self.p.check_batch([RateLimitRequest(**r) for r in reqs],
                                 keys, now)
        flat = [(int(r.status), r.limit, r.remaining, r.reset_time,
                 r.error) for r in got]
        assert flat == [(int(r.status), r.limit, r.remaining,
                         r.reset_time, r.error) for r in want]
        return got

    def check_columns(self, reqs, now):
        from gubernator_tpu.core.batch import pack_columns as jax_pack

        cols = [np.array([r[f] for r in reqs], np.int64)
                for f in ("hits", "limit", "duration", "algorithm")]
        beh = np.zeros(len(reqs), np.int64)
        burst = np.array([r["burst"] for r in reqs], np.int64)
        keys = np.array([kh(r["unique_key"]) for r in reqs], np.uint64)
        jb, _ = jax_pack(keys, *cols, beh, burst, now)
        pb, _ = pack_columns(keys, *cols, beh, burst, now)
        want = self.j.check_columns(jb, keys, now)
        got = self.p.check_columns(pb, keys, now)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g)
        return got

    def sync(self):
        self.j.sync()
        self.p.sync()
        self.assert_state()

    def assert_state(self):
        for f in FIELDS:
            want = np.asarray(getattr(self.j.state, f))
            if f == "key":  # the port keeps the uint64 hash's bit-view
                want = want.view(np.int64)
            np.testing.assert_array_equal(
                want, getattr(self.p.state, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(self.j.base_rem),
                                      self.p.base_rem.numpy())
        np.testing.assert_array_equal(np.asarray(self.j.base_t),
                                      self.p.base_t.numpy())


def test_probe_slots_match_the_step():
    """A pinned key must sit on the probe path the SoA step searches."""
    import torch

    from gubernator_tpu_torch.core.step import _probe_slots

    eng = HotSetEngine(1, capacity=256, device="cpu")
    rng = np.random.default_rng(5)
    hashes = rng.integers(1, 2**63, 64, dtype=np.int64).view(np.uint64)
    hashes = np.concatenate([hashes, hashes | np.uint64(1 << 63)])
    dev = _probe_slots(torch.from_numpy(hashes.view(np.int64)), 256)
    for h, row in zip(hashes.tolist(), dev.tolist()):
        assert eng._probe_slots_host(h) == row


def test_pin_and_serve_single_requests(meshes):
    hp = Pair(meshes)
    assert hp.pin(req(), "hk", NOW)
    assert hp.pin(req(), "hk", NOW)  # idempotent
    r = hp.check([req(hits=3)], NOW)[0]
    assert r.error == "" and (int(r.status), r.remaining) == (0, 97)
    hp.sync()


def test_replicas_diverge_then_converge(meshes):
    hp = Pair(meshes)
    hp.pin(req("c", limit=1000), "c", NOW)
    rs = hp.check([req("c", limit=1000) for _ in range(40)], NOW + 1)
    assert all(r.status == Status.UNDER_LIMIT for r in rs)
    assert min(r.remaining for r in rs) >= 1000 - 40 // hp.n - 1
    hp.sync()
    rs = hp.check([req("c", limit=1000, hits=0) for _ in range(hp.n)],
                  NOW + 2)
    assert {r.remaining for r in rs} == {960}


def test_conservation_across_syncs(meshes):
    hp = Pair(meshes)
    hp.pin(req("cons", limit=50), "cons", NOW)
    admitted = 0
    for wave in range(10):
        rs = hp.check([req("cons", limit=50) for _ in range(10)],
                      NOW + wave)
        admitted += sum(r.status == Status.UNDER_LIMIT for r in rs)
        hp.sync()
    assert admitted == 50
    assert hp.check([req("cons", limit=50, hits=0)],
                    NOW + 100)[0].remaining == 0


def test_bounded_over_admission_within_window(meshes):
    hp = Pair(meshes, batch_per_chip=64)
    hp.pin(req("w", limit=10), "w", NOW)
    rs = hp.check([req("w", limit=10) for _ in range(200)], NOW + 1)
    admitted = sum(r.status == Status.UNDER_LIMIT for r in rs)
    assert 10 <= admitted <= 10 * hp.n
    hp.sync()
    assert hp.check([req("w", limit=10, hits=0)],
                    NOW + 2)[0].remaining == 0


def test_expiry_refresh_merges(meshes):
    hp = Pair(meshes)
    hp.pin(req("e", limit=20, duration=1_000), "e", NOW)
    hp.check([req("e", limit=20, duration=1_000)] * 8, NOW + 1)
    hp.sync()
    rs = hp.check([req("e", limit=20, duration=1_000)] * 8, NOW + 5_000)
    assert all(r.status == Status.UNDER_LIMIT for r in rs)
    hp.sync()
    assert hp.check([req("e", limit=20, duration=1_000, hits=0)],
                    NOW + 5_001)[0].remaining == 12


def test_leaky_pin_serve_and_converge(meshes):
    hp = Pair(meshes)
    assert hp.pin(lreq(), "lk", NOW)
    r = hp.check([lreq(hits=3)], NOW + 1)[0]
    assert (int(r.status), r.remaining) == (0, 997)
    hp.pin(lreq("lc"), "lc", NOW)
    rs = hp.check([lreq("lc") for _ in range(40)], NOW + 1)
    assert min(r.remaining for r in rs) >= 1000 - 40 // hp.n - 1
    hp.sync()
    rs = hp.check([lreq("lc", hits=0) for _ in range(hp.n)], NOW + 2)
    assert {r.remaining for r in rs} == {960}


def test_leaky_conservation_and_replenish(meshes):
    hp = Pair(meshes, batch_per_chip=64)
    hp.pin(lreq("lcons", limit=50), "lcons", NOW)
    admitted = 0
    for wave in range(10):
        rs = hp.check([lreq("lcons", limit=50) for _ in range(10)],
                      NOW + wave)
        admitted += sum(r.status == Status.UNDER_LIMIT for r in rs)
        hp.sync()
    assert admitted == 50
    hp.pin(lreq("lr", limit=100, duration=1_000), "lr", NOW)
    hp.check([lreq("lr", limit=100, duration=1_000)] * 100, NOW + 1)
    hp.sync()
    assert hp.check([lreq("lr", limit=100, duration=1_000, hits=0)],
                    NOW + 1)[0].remaining == 0
    assert hp.check([lreq("lr", limit=100, duration=1_000, hits=0)],
                    NOW + 501)[0].remaining == 50


def test_mixed_algorithms_one_sync(meshes):
    hp = Pair(meshes)
    hp.pin(req("mt", limit=500), "mt", NOW)
    hp.pin(lreq("ml"), "ml", NOW)
    hp.check([req("mt", limit=500)] * 20 + [lreq("ml")] * 20, NOW + 1)
    hp.sync()
    rs = hp.check([req("mt", limit=500, hits=0), lreq("ml", hits=0)],
                  NOW + 2)
    assert (rs[0].remaining, rs[1].remaining) == (480, 980)


def test_probe_window_exhaustion_and_retired_reuse(meshes):
    hp = Pair(meshes, n=2, capacity=8, batch_per_chip=8)
    pinned = sum(hp.pin(req(f"x{i}"), f"x{i}", NOW) for i in range(64))
    assert 0 < pinned <= 8
    hp.p.unpin(kh("x0"))
    hp.j.unpin(kh("x0"))
    # a retired slot is reclaimed by a newcomer whose window is full
    for i in range(64, 96):
        hp.pin(req(f"x{i}"), f"x{i}", NOW)
    hp.p.unpin_all()
    hp.j.unpin_all()
    assert hp.pin(req("x0"), "x0", NOW)


def test_seeded_pin_and_row_state(meshes):
    hp = Pair(meshes)
    seed = {"remaining": 40, "t_ms": NOW - 5, "expire_at": NOW + 59_995,
            "meta": 0}
    hp.pin(req("s", limit=100), "s", NOW, seed=seed)
    hp.check([req("s", limit=100)] * 12, NOW + 1)
    hp.sync()
    want = hp.j.row_state(kh("s"))
    got = hp.p.row_state(kh("s"))
    assert {f: int(v) for f, v in got.items()} == \
        {f: int(v) for f, v in want.items()}
    assert {f: np.asarray(v).dtype for f, v in got.items()} == \
        {f: np.asarray(v).dtype for f, v in want.items()}


def stream(seed, n_keys=6, waves=12):
    """Seeded waves over token and leaky keys, with queries, refreshes
    and syncs between some waves."""
    rng = np.random.default_rng(seed)
    keys = [(f"s{seed}k{i}", int(i % 2), int(rng.integers(20, 400)),
             int(rng.choice([1_000, 60_000])), int(rng.integers(0, 3)) * 5)
            for i in range(n_keys)]
    out, t = [], NOW
    for _ in range(waves):
        t += int(rng.choice([1, 7, 400, 1_500]))
        reqs = []
        for _ in range(int(rng.integers(1, 90))):
            key, alg, lim, dur, burst = keys[int(rng.zipf(1.5)) % n_keys]
            reqs.append(req(key, lim, int(rng.integers(0, 6)), dur, alg,
                            burst))
        out.append((reqs, t, bool(rng.integers(0, 2)),
                    bool(rng.integers(0, 2))))
    return keys, out


@pytest.mark.parametrize("seed", range(3))
def test_streams_equal_jax_per_replica_and_after_sync(meshes, seed):
    hp = Pair(meshes, batch_per_chip=32)
    keys, waves = stream(seed)
    for key, alg, lim, dur, burst in keys:
        assert hp.pin(req(key, lim, 1, dur, alg, burst), key, NOW)
    for reqs, now, columnar, sync in waves:
        if columnar:
            hp.check_columns(reqs, now)
        else:
            hp.check(reqs, now)
        if sync:
            hp.sync()
    hp.sync()
