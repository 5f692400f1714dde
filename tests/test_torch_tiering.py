"""The port's cold tier (tiering.py) on the CPU against the JAX
package's: ``_host_apply`` against JAX's and against the port's own
step, then capped instances of both packages (the device table full,
the tier on) on both engines and both lanes, inline and pipelined, with
equal decisions and an equal union of the two tiers after every batch,
and decisions equal to an uncapped classic instance's.  JAX's bucket
engine runs its kernel in interpret mode on a one-device mesh.  The
tolerance is zero."""
import numpy as np
import pytest

from gubernator_tpu_torch import tiering
from gubernator_tpu_torch.config import Config
from gubernator_tpu_torch.core.batch import pack_columns
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.sharded import ShardedEngine
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

NOW = 1_765_000_000_000
CAP = 1024
GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)
DRAIN = int(Behavior.DRAIN_OVER_LIMIT)


# ---- _host_apply ---------------------------------------------------------

def random_case(rng):
    """One seeded (row or None, request columns) pair over every behavior
    flag, both algorithms, and duration / algorithm / limit changes."""
    alg = int(rng.integers(0, 2))
    beh = int(rng.choice([0, 0, RESET, DRAIN, GREG, GREG | RESET,
                          DRAIN | RESET]))
    dur = (int(rng.integers(0, 6)) if beh & GREG
           else int(rng.choice([1000, 60_000, 3_600_000])))
    req = dict(hits=int(rng.choice([0, 1, 1, 2, 5, 50])),
               limit=int(rng.choice([1, 5, 10, 1000])), duration=dur,
               algorithm=alg, behavior=beh,
               burst=int(rng.choice([0, 5, 20])),
               now=NOW + int(rng.integers(-5_000, 120_000)))
    if rng.random() < 0.2:
        return None, req
    r_alg = alg if rng.random() < 0.8 else 1 - alg
    r_dur = dur if rng.random() < 0.7 else int(rng.choice([500, 60_000]))
    r_lim = req["limit"] if rng.random() < 0.7 else int(rng.integers(1, 50))
    eff = max(r_dur, 1) if rng.random() < 0.8 else int(rng.integers(1, 9000))
    rem = (int(rng.integers(0, r_lim + 1)) if r_alg == 0
           else int(rng.integers(0, r_lim * eff + 1)))
    t = NOW - int(rng.integers(0, 90_000))
    row = ((r_alg & 1) | (int(rng.integers(0, 2)) << 1), r_lim, r_dur, eff,
           r_lim, rem, t, t + int(rng.integers(-1000, 200_000)))
    return row, req


def packed(req) -> tuple:
    """The request as the step sees it (pack_columns clamps it)."""
    batch, errs = pack_columns(
        np.array([7], np.uint64), np.array([req["hits"]]),
        np.array([req["limit"]]), np.array([req["duration"]]),
        np.array([req["algorithm"]]), np.array([req["behavior"]]),
        np.array([req["burst"]]), req["now"])
    assert not errs
    return batch


def apply_args(batch, req_now):
    return (int(batch.hits[0]), int(batch.limit[0]), int(batch.duration[0]),
            int(batch.eff_ms[0]), int(batch.greg_end[0]),
            int(batch.behavior[0]), int(batch.algorithm[0]),
            int(batch.burst[0]), req_now)


@pytest.mark.parametrize("seed", range(4))
def test_host_apply_equals_jax(seed):
    from gubernator_tpu import tiering as jax_tiering

    rng = np.random.default_rng(seed)
    for _ in range(400):
        row, req = random_case(rng)
        args = apply_args(packed(req), req["now"])
        assert tiering._host_apply(row, *args) == \
            jax_tiering._host_apply(row, *args)


@pytest.mark.parametrize("seed", range(3))
def test_host_apply_equals_the_port_step(seed):
    """The same row and request through the port's SoA step (one wave on
    a fresh table) and through _host_apply: the same answer and row."""
    rng = np.random.default_rng(100 + seed)
    kh = np.array([7], np.uint64)
    for _ in range(60):
        row, req = random_case(rng)
        # a fresh table: a removed row's slot keeps its other columns
        eng = ShardedEngine(device="cpu", capacity=CAP, batch_rows=8)
        if row is not None:
            assert eng.upsert_rows(kh, {f: np.array([v]) for f, v in zip(
                tiering.ROW_COLS, row)}) == 1
        batch = packed(req)
        st, lim, rem, rst, full = eng.check_packed(batch, kh, req["now"])
        want = tiering._host_apply(row, *apply_args(batch, req["now"]))
        assert not full[0]
        assert (int(st[0]), int(rem[0]), int(rst[0]), int(lim[0])) == \
            want[:4]
        found, cols = eng.gather_rows(kh)
        assert found[0]
        assert tuple(int(cols[f][0]) for f in tiering.ROW_COLS) == want[4]


# ---- the cold stores -----------------------------------------------------

@pytest.mark.parametrize("native", ["1", "0"])
def test_cold_store_ops(monkeypatch, native):
    """put / get / pop / contains / snapshot / put_many of the native and
    the dict store, through growth and tombstones, against a dict."""
    monkeypatch.setenv("GUBER_TIER_NATIVE", native)
    st = tiering._make_store()
    assert st.native == (native == "1")
    rng = np.random.default_rng(3)
    ref = {}
    keys = rng.integers(1, 2 ** 63, 5000).astype(np.uint64)
    for i, k in enumerate(keys.tolist()):
        row = tuple(int(v) for v in rng.integers(-2 ** 40, 2 ** 40, 8))
        st.put(k, row)
        ref[k] = row
        if i % 3 == 0:
            gone = keys[i // 2].item()
            assert st.pop(gone) == ref.pop(gone, None)
    assert len(st) == len(ref)
    for k in keys[::7].tolist():
        assert st.get(k) == ref.get(k)
    mask = st.contains_batch(keys)
    assert mask.tolist() == [k in ref for k in keys.tolist()]
    more = rng.integers(1, 2 ** 63, 300).astype(np.uint64)
    rows = rng.integers(0, 100, (300, 8))
    st.put_many(more, rows)
    for k, r in zip(more.tolist(), rows.tolist()):
        ref[k] = tuple(r)
    assert st.get_many(more[:5]) == [ref[k] for k in more[:5].tolist()]
    sk, sr = st.snapshot()
    assert dict(zip(sk.tolist(), map(tuple, sr.tolist()))) == ref


def test_native_store_build_failure_raises(monkeypatch, tmp_path):
    """The native store has no substitute when its build fails (only
    GUBER_TIER_NATIVE=0 selects the dict store)."""
    from gubernator_tpu_torch.ops import build

    bad = tmp_path / "cold.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(build, "COLD_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_wire_lib", None)
    monkeypatch.setenv("GUBER_TIER_NATIVE", "1")
    with pytest.raises(RuntimeError, match="cold.cpp"):
        tiering._make_store()


# ---- capped instances against JAX ----------------------------------------

def port_instance(engine: str, cap: int = CAP, tier: bool = True):
    return V1Instance(Config(cache_size=cap, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, engine=engine,
                             hot_set_capacity=0, tier_cold=tier))


def jax_instance(engine: str, cap: int = CAP):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine

    cls = JaxEngine if engine == "xla" else PallasServingEngine
    return JaxInstance(
        JaxConfig(cache_size=cap, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, tier_cold=True),
        engine=cls(make_mesh(n=1), capacity_per_shard=cap,
                   batch_per_shard=64))


@pytest.fixture()
def quiet(monkeypatch):
    for var in ("GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    monkeypatch.delenv("GUBER_TIER_COLD", raising=False)
    monkeypatch.setenv("GUBER_ANALYTICS", "0")
    monkeypatch.setenv("GUBER_PIPELINE", "0")
    return monkeypatch


def stream(seed: int, n_keys: int = 2600, batches: int = 4,
           ood: bool = False):
    """Batches of request dicts over more keys than a 1024-row table
    holds: TOKEN and LEAKY, flags, queries, repeated keys, and (``ood``)
    limits of 2^40 on keys of their own."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        reqs = []
        for _ in range(int(rng.integers(300, 700))):
            kid = int(rng.integers(0, n_keys))
            beh = int(rng.choice([0, 0, 0, 0, RESET, DRAIN]))
            reqs.append(dict(name="t", unique_key=f"k{kid}",
                             hits=int(rng.integers(0, 3)),
                             limit=4 + kid % 7, duration=60_000,
                             algorithm=kid % 2, behavior=beh,
                             burst=4 + kid % 7))
        if ood:
            for _ in range(20):
                kid = int(rng.integers(0, 40))
                reqs.append(dict(name="big", unique_key=f"b{kid}",
                                 hits=int(rng.integers(1, 1000)),
                                 limit=1 << 40, duration=60_000,
                                 algorithm=0, behavior=0, burst=0))
        out.append((reqs, NOW + 700 * b))
    return out


def answers(resps):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in resps]


def union(inst) -> dict:
    """key → value row over both tiers; fails on a key in both."""
    snap = inst.engine.snapshot()
    out = {}
    for i, k in enumerate(np.asarray(snap["key"]).tolist()):
        out[k] = tuple(int(snap[f][i]) for f in tiering.ROW_COLS)
    cold = inst._tier.snapshot_arrays()
    if cold is not None:
        for i, k in enumerate(np.asarray(cold["key"]).tolist()):
            assert k not in out, "a key in both tiers"
            out[k] = tuple(int(cold[f][i]) for f in tiering.ROW_COLS)
    return out


def wire_call(inst, reqs, now):
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    data = encode_get_rate_limits([RateLimitRequest(**r) for r in reqs])
    msg = pb.GetRateLimitsResp.FromString(
        inst.get_rate_limits_wire(data, now_ms=now))
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in msg.responses]


def object_call(inst, cls, reqs, now):
    return answers(inst.get_rate_limits([cls(**r) for r in reqs],
                                        now_ms=now))


def run_pair(engine, lane, batches, port_pipeline=None):
    """Both packages' capped instances over ``batches``: per batch the
    port's answers, and the unions after it, compared as they go.
    ``port_pipeline`` sets GUBER_PIPELINE for the port's dispatcher
    alone (the JAX instance keeps the environment's)."""
    import os

    from gubernator_tpu.types import RateLimitRequest as JaxReq

    jx = jax_instance(engine)
    old = os.environ.get("GUBER_PIPELINE")
    if port_pipeline is not None:
        os.environ["GUBER_PIPELINE"] = port_pipeline
    try:
        port = port_instance(engine)
    finally:
        if old is None:
            os.environ.pop("GUBER_PIPELINE", None)
        else:
            os.environ["GUBER_PIPELINE"] = old
    if port_pipeline == "1":
        assert port.dispatcher._pipelined
    got = []
    try:
        for reqs, now in batches:
            if lane == "wire":
                a = wire_call(port, reqs, now)
                b = wire_call(jx, reqs, now)
            else:
                a = object_call(port, RateLimitRequest, reqs, now)
                b = object_call(jx, JaxReq, reqs, now)
            assert a == b
            assert union(port) == union(jx)
            got.append(a)
        stats = (port._tier.stats(), jx._tier.stats())
    finally:
        port.close()
        jx.close()
    return got, stats


def uncapped_answers(batches, lane="object"):
    inst = port_instance("xla", cap=1 << 14, tier=False)
    try:
        return [wire_call(inst, reqs, now) if lane == "wire"
                else object_call(inst, RateLimitRequest, reqs, now)
                for reqs, now in batches]
    finally:
        inst.close()


@pytest.mark.parametrize("engine", ["", "xla"])
@pytest.mark.parametrize("lane", ["object", "wire"])
def test_capped_instance_equals_jax_and_uncapped(quiet, engine, lane):
    batches = stream(1 if lane == "wire" else 2)
    got, (ps, js) = run_pair(engine, lane, batches)
    assert ps["cold_keys"] == js["cold_keys"] > 0
    assert ps["cold_served"] == js["cold_served"] > 0
    assert got == uncapped_answers(batches, lane)


@pytest.mark.parametrize("engine", ["", "xla"])
def test_capped_pipelined_equals_jax(quiet, engine):
    """The port's launch / sync lane (``cold_idx`` in the token,
    GUBER_PIPELINE=1) on a columnar lane (the wire), held to the JAX
    instance's inline lane: one caller's batches in turn decide the same
    either way.  (JAX's own pipelined wire lane on the classic engine
    answered misplaced rows in this process after a bucket-engine
    instance had run, so it is not the reference here.)"""
    batches = stream(3, batches=3)
    got, (ps, js) = run_pair(engine, "wire", batches, port_pipeline="1")
    assert ps["cold_served"] == js["cold_served"] > 0
    assert got == uncapped_answers(batches, "wire")


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("lane", ["object", "wire"])
def test_out_of_domain_rows_serve_cold_on_the_bucket_engine(
        quiet, pipeline, lane):
    """Limits of 2^40 on the bucket engine: keys with no device row are
    served by the cold tier, exactly as an uncapped classic instance
    answers them, never table_full, on every path."""
    quiet.setenv("GUBER_PIPELINE", pipeline)
    batches = stream(4, batches=3, ood=True)
    inst = port_instance("")
    try:
        got = [wire_call(inst, reqs, now) if lane == "wire"
               else object_call(inst, RateLimitRequest, reqs, now)
               for reqs, now in batches]
        assert inst._tier.stats()["cold_served"] > 0
    finally:
        inst.close()
    assert got == uncapped_answers(batches, lane)
    assert not any(a[4] for b in got for a in b)


def test_out_of_domain_object_lane_equals_jax(quiet):
    """JAX's bucket engine serves out-of-domain rows from its tier on the
    inline object lane too (its check_packed)."""
    got, (ps, js) = run_pair("", "object", stream(5, batches=2, ood=True))
    assert ps["cold_served"] == js["cold_served"]


# ---- admission: promotions and demotions against JAX ----------------------

@pytest.fixture()
def slow_fold(quiet):
    """Analytics on in both packages, the worker resting long enough
    after a flush that no tap of the batch sent right after it folds
    before that batch's resolve reads the ranks."""
    from gubernator_tpu import analytics as jax_analytics
    from gubernator_tpu_torch import analytics

    quiet.setenv("GUBER_ANALYTICS", "1")
    quiet.setenv("GUBER_TIER_PROMOTE", "2")
    for mod in (analytics, jax_analytics):
        quiet.setattr(mod.KeyAnalytics, "BATCH_INTERVAL_S", 0.75)
    return quiet


def flushed_call(inst, cls, reqs, now):
    """Fold every earlier tap, then send the batch inside the worker's
    rest: its resolve reads the ranks as of the flush."""
    inst.analytics.flush()
    return object_call(inst, cls, reqs, now)


def hot_stream(seed: int, batches: int = 5):
    """Zipf traffic over 3000 keys: the hot ranks come back often enough
    to be promoted from the cold tier."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        ranks = np.minimum(rng.zipf(1.3, 400), 3000)
        out.append(([dict(name="z", unique_key=f"k{int(r)}", hits=1,
                          limit=1000, duration=600_000)
                     for r in ranks], NOW + 500 * b))
    return out


@pytest.mark.parametrize("engine", ["", "xla"])
def test_promotions_and_demotions_equal_jax(slow_fold, engine):
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    port, jx = port_instance(engine), jax_instance(engine)
    try:
        # the capped tables fill first: every later new key is cold
        fill = [dict(name="f", unique_key=f"f{i}", hits=1, limit=5,
                     duration=600_000) for i in range(1400)]
        for inst, cls in ((port, RateLimitRequest), (jx, JaxReq)):
            for a in range(0, len(fill), 700):
                flushed_call(inst, cls, fill[a:a + 700], NOW - 1)
        for reqs, now in hot_stream(6):
            assert flushed_call(port, RateLimitRequest, reqs, now) == \
                flushed_call(jx, JaxReq, reqs, now)
            assert union(port) == union(jx)
        port.analytics.flush()
        jx.analytics.flush()
        ps, js = port._tier.stats(), jx._tier.stats()
        assert ps["promotions"] == js["promotions"] > 0
        assert ps["demotions"] == js["demotions"]

        def top(inst):
            return [(e["khash"], e["key"], e["hits"], e["err"],
                     e["over_limit"])
                    for e in inst.analytics.topkeys_snapshot(64)["keys"]]

        assert top(port) == top(jx)
    finally:
        port.close()
        jx.close()


# ---- faultpoints ----------------------------------------------------------

@pytest.mark.parametrize("engine", ["", "xla"])
@pytest.mark.parametrize("point", ["tier_promote", "tier_demote"])
def test_armed_migration_points_abort_as_jax(quiet, engine, point):
    """A promotion with the point armed: the same aborts, counters and
    union in both packages; the row stays where it was."""
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    port, jx = port_instance(engine), jax_instance(engine)
    try:
        fill = [dict(name="f", unique_key=f"f{i}", hits=1, limit=5,
                     duration=600_000) for i in range(1400)]
        out = []
        for inst, cls in ((port, RateLimitRequest), (jx, JaxReq)):
            for a in range(0, len(fill), 700):
                object_call(inst, cls, fill[a:a + 700], NOW)
            cold = np.asarray(inst._tier.snapshot_arrays()["key"])
            inst.faults.arm(f"{point}:error")
            ok = [inst._tier.promote(inst.engine, int(k), 10 ** 6)
                  for k in np.sort(cold)[:20]]
            # the victim pick needs a rank feed: every resident is colder
            inst._tier.rank_fn = lambda kh: 0
            inst._tier.rank_batch = lambda khs: [0] * len(khs)
            ok += [inst._tier.promote(inst.engine, int(k), 10 ** 6)
                   for k in np.sort(cold)[20:40]]
            out.append((ok, inst._tier.stats(),
                        inst.metrics.registry.get_sample_value(
                            "gubernator_tier_migrations_aborted_total")))
        assert out[0] == out[1]
        assert out[0][1]["migrations_aborted"] > 0
        assert union(port) == union(jx)
    finally:
        port.close()
        jx.close()


# ---- restore: the bucket engine adopts what its buckets refuse -------------

def snapshot_rows(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2 ** 63, n).astype(np.uint64)
    lim = rng.integers(1, 100, n).astype(np.int64)
    lim[::50] = 1 << 40  # outside K1's domain
    alg = (rng.random(n) < 0.3).astype(np.int64)
    dur = np.full(n, 600_000, np.int64)
    rem = np.where(alg == 1, lim * dur // 2, lim // 2)
    return {"key": keys, "meta": alg.astype(np.int32), "limit": lim,
            "duration": dur, "eff_ms": dur.copy(), "burst": lim.copy(),
            "remaining": rem, "t_ms": np.full(n, NOW, np.int64),
            "expire_at": np.full(n, NOW + 600_000, np.int64)}


@pytest.mark.parametrize("seed", range(2))
def test_bucket_restore_keeps_every_row_as_jax_classic(quiet, seed):
    """Reference behavior: the JAX classic engine's restore puts the rows
    its table cannot place into the tier; the port's bucket engine does
    the same with the rows its buckets or K1's domain refuse."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
    from gubernator_tpu_torch import store

    rows = snapshot_rows(3000, seed)
    jx = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, tier_cold=True,
                  loader=jax_store.MockLoader(
                      contents=jax_store.items_from_arrays(rows))),
        engine=JaxEngine(make_mesh(n=1), capacity_per_shard=CAP,
                         batch_per_shard=64))
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, tier_cold=True,
                             hot_set_capacity=0,
                             loader=store.MockLoader(
                                 contents=store.items_from_arrays(rows))))
    try:
        want = {int(k): tuple(int(rows[f][i]) for f in tiering.ROW_COLS)
                for i, k in enumerate(rows["key"].tolist())}
        assert union(jx) == want
        got = union(port)
        assert set(got) == set(want)
        # the device tier stores a row's burst as its limit: compare the
        # device rows without it, the cold rows whole
        cold = set(port._tier.snapshot_arrays()["key"].tolist())
        for k, row in want.items():
            if k in cold:
                assert got[k] == row
            else:
                assert got[k][:4] + got[k][5:] == row[:4] + row[5:]
        assert port.engine.dropped_rows == 0
        assert len(cold) > 3000 // 50
    finally:
        port.close()
        jx.close()


def test_jax_bucket_restore_drops_what_its_tier_should_adopt(quiet):
    """The reference fault the port holds itself apart from: the JAX
    bucket engine's restore counts the rows its buckets refuse as
    dropped and never offers them to its tier."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine

    rows = snapshot_rows(3000, 0)
    jx = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, tier_cold=True,
                  loader=jax_store.MockLoader(
                      contents=jax_store.items_from_arrays(rows))),
        engine=PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                                   batch_per_shard=64))
    try:
        kept = len(jx.engine.snapshot()["key"])
        assert jx._tier.cold_keys() == 0
        assert jx.engine.dropped_rows == 3000 - kept > 0
    finally:
        jx.close()


# ---- reference behaviors the port keeps or holds itself apart from ---------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_peer_globals_upsert_bypasses_the_tier(quiet, pkg):
    """Kept as JAX has it: the receiving side of an UpdatePeerGlobals
    (a broadcast or a handover) upserts into the device table alone, so
    rows its full buckets refuse are dropped, not adopted cold."""
    from gubernator_tpu.proto import gubernator_pb2 as jpb
    from gubernator_tpu.proto import peers_pb2 as jpeers
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.proto import peers_pb2 as peers_pb

    inst = port_instance("") if pkg == "port" else jax_instance("")
    mod, pmod = (pb, peers_pb) if pkg == "port" else (jpb, jpeers)
    try:
        fill = [dict(name="f", unique_key=f"f{i}", hits=1, limit=5,
                     duration=600_000) for i in range(1400)]
        from gubernator_tpu.types import RateLimitRequest as JaxReq

        cls = RateLimitRequest if pkg == "port" else JaxReq
        for a in range(0, len(fill), 700):
            object_call(inst, cls, fill[a:a + 700], NOW)
        cold0 = inst._tier.cold_keys()
        before = len(union(inst))
        ups = [pmod.UpdatePeerGlobal(
            key=f"g_u{i}", algorithm=0, duration=600_000, created_at=NOW,
            update=mod.RateLimitResp(limit=9, remaining=7,
                                     reset_time=NOW + 600_000))
            for i in range(600)]
        inst.update_peer_globals(ups)
        got = union(inst)
        assert inst._tier.cold_keys() == cold0
        assert before < len(got) < before + 600  # some refused, dropped
    finally:
        inst.close()


def test_jax_pipelined_lane_answers_out_of_domain_rows_table_full(quiet):
    """The reference fault the port holds itself apart from: JAX's bucket
    engine serves a 2^40 row with no device row from its tier in
    ``check_packed`` but answers it table_full on the pipelined launch /
    sync lane; the port serves it cold on every lane."""
    quiet.setenv("GUBER_PIPELINE", "1")
    reqs = [dict(name="big", unique_key=f"b{i}", hits=3, limit=1 << 40,
                 duration=60_000) for i in range(4)]
    jx = jax_instance("")
    port = port_instance("")
    try:
        assert jx.dispatcher._pipelined and port.dispatcher._pipelined
        want = [(0, 1 << 40, (1 << 40) - 3, NOW + 60_000, "")] * 4
        assert wire_call(port, reqs, NOW) == want
        got = wire_call(jx, reqs, NOW)
        assert all(a[4] == "rate limit table full" for a in got)
    finally:
        jx.close()
        port.close()


# ---- the Store beside the cold tier ---------------------------------------

def store_instance(engine: str, store, cap: int = CAP, tier: bool = True):
    return V1Instance(Config(cache_size=cap, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, engine=engine,
                             hot_set_capacity=0, tier_cold=tier,
                             store=store))


FILL = [dict(name="f", unique_key=f"f{i}", hits=1, limit=5,
             duration=600_000) for i in range(1400)]


def fill(inst, cls, call):
    return [a for s in range(0, len(FILL), 700)
            for a in call(inst, cls, FILL[s:s + 700])]


def cold_with_occupant(inst, n: int) -> list:
    """(cold key, a device-resident key of its probe window) for ``n``
    cold keys of the fill, as unique_key strings."""
    from gubernator_tpu_torch.hashing import hash_key

    by_hash = {hash_key("f", r["unique_key"]): r["unique_key"] for r in FILL}
    cold = inst._tier.snapshot_arrays()
    out, taken = [], set()
    for kh in np.asarray(cold["key"]).tolist():
        occ = [by_hash.get(int(k)) for k in
               np.asarray(inst.engine.probe_occupant_keys(kh)).tolist()]
        occ = [k for k in occ if k is not None and k not in taken]
        if kh in by_hash and occ:
            out.append((by_hash[kh], occ[0]))
            taken.update((by_hash[kh], occ[0]))
        if len(out) == n:
            break
    assert len(out) == n
    return out


@pytest.mark.parametrize("engine", ["", "xla"])
@pytest.mark.parametrize("lane", ["object", "wire"])
def test_read_through_keeps_each_key_in_one_tier(quiet, engine, lane):
    """A capped instance with the tier and a MockStore: a cold key whose
    probe window has a slot free (a removed neighbour) is no Store miss,
    so its Store item never lands on the device beside the live cold
    row.  Every key is in exactly one tier after every batch, and the
    answers equal an uncapped instance's with its own Store."""
    from gubernator_tpu_torch.store import MockStore

    ps, rs = MockStore(), MockStore()
    port = store_instance(engine, ps)
    ref = store_instance("xla", rs, cap=1 << 14, tier=False)

    def call(inst, reqs, now=NOW):
        return (wire_call(inst, reqs, now) if lane == "wire"
                else object_call(inst, RateLimitRequest, reqs, now))

    try:
        assert fill(port, None, lambda i, _c, r: call(i, r)) == \
            fill(ref, None, lambda i, _c, r: call(i, r))
        union(port)
        assert port._tier.cold_keys() > 0
        pairs = cold_with_occupant(port, 6)
        for _, occ in pairs:
            assert port.remove("f", occ) and ref.remove("f", occ)
        union(port)
        for b in range(3):
            reqs = [dict(name="f", unique_key=k, hits=1, limit=5,
                         duration=600_000)
                    for pair in pairs for k in pair] + FILL[b::50]
            assert call(port, reqs, NOW + 1000 * (b + 1)) == \
                call(ref, reqs, NOW + 1000 * (b + 1))
            got = union(port)  # fails on a key in both tiers
            assert len(got) == len(ref.engine.snapshot()["key"])
        assert ps.called["get"] < rs.called["get"] + 2 * len(pairs)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("engine", ["", "xla"])
def test_read_through_adopts_what_the_table_refuses(quiet, engine):
    """A capped instance with the tier over a Store that already holds
    1400 keys (a restart with a Store and no snapshot): every request is
    a miss, and the items the full buckets refuse land cold instead of
    being dropped, so the answers continue the Store's counts as an
    uncapped instance's do."""
    from gubernator_tpu_torch.store import MockStore

    rs = MockStore()
    ref = store_instance("xla", rs, cap=1 << 14, tier=False)
    try:
        fill(ref, RateLimitRequest, lambda i, c, r: object_call(i, c, r, NOW))
        ps = MockStore(items=dict(rs.items))
        port = store_instance(engine, ps)
        try:
            got = fill(port, RateLimitRequest,
                       lambda i, c, r: object_call(i, c, r, NOW + 1000))
            want = fill(ref, RateLimitRequest,
                        lambda i, c, r: object_call(i, c, r, NOW + 1000))
            assert got == want
            assert all(a[2] == 3 for a in got)
            assert port._tier.cold_keys() > 0
            assert len(union(port)) == len(FILL)
        finally:
            port.close()
    finally:
        ref.close()


def test_jax_read_through_puts_a_cold_key_on_the_device_too(quiet):
    """The reference fault the port holds itself apart from: JAX's
    read-through consults the device table alone, so a cold key whose
    window has a free slot reads its Store item onto the device, and
    the key is then in both tiers (the cold row serves; the device copy
    goes stale)."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.hashing import hash_key as jax_hash_key
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    jx = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, tier_cold=True,
                  store=jax_store.MockStore()),
        engine=PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                                   batch_per_shard=64))
    try:
        fill(jx, JaxReq, lambda i, c, r: object_call(i, c, r, NOW))
        by_hash = {jax_hash_key("f", r["unique_key"]): r["unique_key"]
                   for r in FILL}
        cold = np.asarray(jx._tier.snapshot_arrays()["key"]).tolist()
        kh = next(k for k in cold if k in by_hash and any(
            int(o) in by_hash for o in jx.engine.probe_occupant_keys(k)))
        occ = next(int(o) for o in jx.engine.probe_occupant_keys(kh)
                   if int(o) in by_hash)
        assert jx.remove("f", by_hash[occ])
        object_call(jx, JaxReq, [dict(name="f", unique_key=by_hash[kh],
                                      hits=1, limit=5, duration=600_000)],
                    NOW + 1000)
        found, _ = jx.engine.gather_rows(np.array([kh], np.uint64))
        assert found[0] and jx._tier.resident_mask(
            np.array([kh], np.uint64))[0]
    finally:
        jx.close()
