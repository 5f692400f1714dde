"""The hot set inside the instance, on the CPU: a port V1Instance and a
JAX V1Instance with the JAX tests' hot-set settings (capacity 64,
threshold 8, tests/test_hotset_instance.py › mk_instance) get the same
streams over the object lane and the wire lane.  The JAX side runs a
one-device PallasServingEngine, so both hot sets hold one replica (the
port passes its engine's device count, as JAX passes its mesh).
Tolerance: exact — every answer, the pinned keys, the demotion counters
and the rows written back to the tables are equal.  Analytics is off on
both sides, so promotion reads the per-key counters alone."""
import numpy as np
import pytest

from gubernator_tpu_torch.config import BehaviorConfig, Config
from gubernator_tpu_torch.hashing import hash_key
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.types import (Algorithm, Behavior, PeerInfo,
                                        RateLimitRequest)
from gubernator_tpu_torch.wire import encode_get_rate_limits

from test_torch_wire import quiet_jax  # noqa: E402

NOW = 1_765_000_000_000
CAP = 1 << 10
LANES = ("object", "wire")
REASONS = ("flagged", "config_change", "membership_change")


def req(key="h1", hits=1, **kw):
    d = dict(limit=100_000, duration=600_000, behavior=int(Behavior.GLOBAL))
    d.update(kw)
    return dict(name="hotinst", unique_key=key, hits=hits, **d)


def kh(key):
    return hash_key("hotinst", key)


class Pair:
    """A port and a JAX instance with the same hot-set settings."""

    def __init__(self, monkeypatch, threshold=8, capacity=64, tier=False,
                 loader=None, jax_loader=None, sync_wait_ms=25):
        from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
        from gubernator_tpu.config import Config as JaxConfig
        from gubernator_tpu.instance import V1Instance as JaxInstance
        from gubernator_tpu.parallel import make_mesh
        from gubernator_tpu.parallel.pallas_engine import \
            PallasServingEngine

        quiet_jax(monkeypatch)
        kw = dict(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=capacity,
                  hot_promote_threshold=threshold)
        self.p = V1Instance(Config(
            device="cpu", tier_cold=tier, loader=loader,
            behaviors=BehaviorConfig(global_sync_wait_ms=sync_wait_ms),
            **kw))
        self.j = JaxInstance(
            JaxConfig(tier_cold=tier, loader=jax_loader,
                      behaviors=JaxBehaviors(
                          global_sync_wait_ms=sync_wait_ms), **kw),
            engine=PallasServingEngine(make_mesh(n=1),
                                       capacity_per_shard=CAP,
                                       batch_per_shard=64))

    def send(self, lane, reqs, now):
        """One batch to both; asserts equal answers, returns the port's
        as (status, limit, remaining, reset_time, error) tuples."""
        from gubernator_tpu.proto import gubernator_pb2 as jpb
        from gubernator_tpu.types import RateLimitRequest as JaxReq

        from gubernator_tpu_torch.proto import gubernator_pb2 as ppb

        if lane == "object":
            got = [(int(r.status), r.limit, r.remaining, r.reset_time,
                    r.error) for r in self.p.get_rate_limits(
                        [RateLimitRequest(**r) for r in reqs], now_ms=now)]
            want = [(int(r.status), r.limit, r.remaining, r.reset_time,
                     r.error) for r in self.j.get_rate_limits(
                         [JaxReq(**r) for r in reqs], now_ms=now)]
        else:
            data = encode_get_rate_limits(
                [RateLimitRequest(**r) for r in reqs])
            got = [(int(r.status), r.limit, r.remaining, r.reset_time,
                    r.error) for r in ppb.GetRateLimitsResp.FromString(
                        self.p.get_rate_limits_wire(data, now)).responses]
            want = [(int(r.status), r.limit, r.remaining, r.reset_time,
                     r.error) for r in jpb.GetRateLimitsResp.FromString(
                         self.j.get_rate_limits_wire(data, now)).responses]
        assert got == want
        return got

    def pinned(self):
        hs, js = self.p._hotset, self.j._hotset
        assert (hs is None) == (js is None)
        if hs is None:
            return set()
        assert hs.slots == js.slots
        return set(hs.slots)

    def demotions(self):
        out = []
        for inst in (self.p, self.j):
            out.append([inst.metrics.registry.get_sample_value(
                "gubernator_hotset_demotions_total", {"reason": r}) or 0.0
                for r in REASONS])
        assert out[0] == out[1]
        return dict(zip(REASONS, out[0]))

    def rows(self, keys):
        """The table rows of ``keys`` on both sides (asserted equal)."""
        karr = np.array([kh(k) for k in keys], np.uint64)
        pf, pc = self.p.engine.gather_rows(karr)
        jf, jc = self.j.engine.gather_rows(karr)
        np.testing.assert_array_equal(pf, np.asarray(jf))
        for f in ("remaining", "t_ms", "expire_at", "meta", "limit"):
            np.testing.assert_array_equal(
                np.asarray(pc[f])[pf], np.asarray(jc[f])[pf], err_msg=f)
        return pf, pc

    def sync(self):
        for inst in (self.p, self.j):
            if inst._hotset is not None:
                inst._hotset.sync()

    def close(self):
        self.p.close()
        self.j.close()


@pytest.mark.parametrize("lane", LANES)
def test_promotion_and_convergence(monkeypatch, lane):
    hp = Pair(monkeypatch, threshold=8)
    try:
        for i in range(7):
            rs = hp.send(lane, [req()], NOW + i)
            assert rs[0][0] == 0 and rs[0][4] == ""
        assert hp.pinned() == set()
        hp.send(lane, [req()], NOW + 8)  # the eighth hit promotes
        assert hp.pinned() == {kh("h1")}
        for i in range(20):
            rs = hp.send(lane, [req() for _ in range(10)], NOW + 10 + i)
            assert all(r[4] == "" for r in rs)
        hp.sync()
        rs = hp.send(lane, [req(hits=0)] * 4, NOW + 100)
        assert {r[2] for r in rs} == {100_000 - 8 - 200}
        assert hp.p._hotset.state.key.device.type == "cpu"
    finally:
        hp.close()


@pytest.mark.parametrize("lane", LANES)
def test_flagged_requests_bypass_and_demote(monkeypatch, lane):
    hp = Pair(monkeypatch, threshold=1)
    try:
        flag = int(Behavior.GLOBAL | Behavior.RESET_REMAINING)
        hp.send(lane, [req(key="flg", behavior=flag)], NOW)
        assert kh("flg") not in hp.pinned()
        hp.send(lane, [req(key="pin")], NOW + 1)
        assert hp.pinned() == {kh("pin")}
        hp.send(lane, [req(key="pin") for _ in range(5)], NOW + 2)
        # a flagged request on a pinned key demotes it, counted
        hp.send(lane, [req(key="pin", behavior=flag)], NOW + 3)
        assert hp.pinned() == set()
        assert hp.demotions()["flagged"] == 1
        hp.send(lane, [req(key="pin", hits=0)], NOW + 4)
    finally:
        hp.close()


@pytest.mark.parametrize("lane", LANES)
def test_leaky_promotes_and_demotes_keeping_consumption(monkeypatch, lane):
    hp = Pair(monkeypatch, threshold=1)
    try:
        def lr(hits=1):
            return req(key="lk", hits=hits, limit=1000, duration=600_000,
                       algorithm=int(Algorithm.LEAKY_BUCKET))

        hp.send(lane, [lr()], NOW)
        assert hp.pinned() == {kh("lk")}
        rs = hp.send(lane, [lr() for _ in range(10)], NOW + 1)
        assert all(r[0] == 0 and r[4] == "" for r in rs)
        for inst, cls in ((hp.p, PeerInfo), (hp.j, None)):
            if cls is None:
                from gubernator_tpu.types import PeerInfo as cls
            inst.set_peers([cls(grpc_address="127.0.0.1:1"),
                            cls(grpc_address="127.0.0.1:2")])
        assert hp.pinned() == set()
        assert hp.demotions()["membership_change"] == 1
        found, cols = hp.rows(["lk"])
        assert found[0] and int(cols["meta"][0]) & 1 == 1
        assert int(cols["remaining"][0]) // 600_000 == 1000 - 11
    finally:
        hp.close()


@pytest.mark.parametrize("lane", LANES)
def test_config_change_demotes_keeping_consumption(monkeypatch, lane):
    hp = Pair(monkeypatch, threshold=1)
    try:
        hp.send(lane, [req(key="cfg", limit=100)], NOW)
        assert hp.pinned() == {kh("cfg")}
        hp.send(lane, [req(key="cfg", limit=100) for _ in range(10)],
                NOW + 1)
        rs = hp.send(lane, [req(key="cfg", limit=50)], NOW + 2)
        assert hp.pinned() == set()
        assert hp.demotions()["config_change"] == 1
        assert (rs[0][1], rs[0][2]) == (50, 38)
    finally:
        hp.close()


def test_peers_joining_demote_every_pinned_key(monkeypatch):
    from gubernator_tpu.types import PeerInfo as JaxPeer

    hp = Pair(monkeypatch, threshold=1)
    try:
        keys = [f"join{i}" for i in range(5)]
        hp.send("object", [req(key=k) for k in keys], NOW)
        hp.send("wire", [req(key=k) for k in keys for _ in range(3)],
                NOW + 1)
        assert hp.pinned() == {kh(k) for k in keys}
        hp.p.set_peers([PeerInfo(grpc_address="127.0.0.1:1"),
                        PeerInfo(grpc_address="127.0.0.1:2")])
        hp.j.set_peers([JaxPeer(grpc_address="127.0.0.1:1"),
                        JaxPeer(grpc_address="127.0.0.1:2")])
        assert hp.pinned() == set()
        assert hp.demotions()["membership_change"] == len(keys)
        found, cols = hp.rows(keys)
        assert found.all()
        assert (np.asarray(cols["remaining"]) == 100_000 - 4).all()
    finally:
        hp.close()


def test_remove_demotes_then_deletes(monkeypatch):
    hp = Pair(monkeypatch, threshold=1)
    try:
        hp.send("object", [req(key="rm")], NOW)
        hp.send("object", [req(key="rm") for _ in range(3)], NOW + 1)
        assert hp.pinned() == {kh("rm")}
        assert hp.p.remove("hotinst", "rm") == hp.j.remove("hotinst", "rm")
        assert hp.pinned() == set()
        found, _ = hp.rows(["rm"])
        assert not found[0]
        hp.demotions()
        rs = hp.send("object", [req(key="rm", hits=0)], NOW + 2)
        assert rs[0][2] == 100_000
    finally:
        hp.close()


def test_snapshot_demotes_and_holds_every_pinned_row(monkeypatch,
                                                     tmp_path):
    from gubernator_tpu.store import FileLoader as JaxLoader

    from gubernator_tpu_torch.store import FileLoader

    hp = Pair(monkeypatch, threshold=1,
              loader=FileLoader(str(tmp_path / "port.npz")),
              jax_loader=JaxLoader(str(tmp_path / "jax.npz")))
    keys = [f"snap{i}" for i in range(4)]
    try:
        hp.send("object", [req(key=k) for k in keys], NOW)
        hp.send("wire", [req(key=k) for k in keys for _ in range(2)],
                NOW + 1)
        hp.sync()
        before = {k: {f: int(v) for f, v in
                      hp.p._hotset.row_state(kh(k)).items()} for k in keys}
    finally:
        hp.close()  # saves the snapshot: the pinned rows demote first
    assert hp.demotions()["membership_change"] == len(keys)
    arrays = FileLoader(str(tmp_path / "port.npz")).load_arrays()
    at = {int(k): i for i, k in enumerate(arrays["key"].tolist())}
    for k in keys:
        i = at[kh(k)]
        for f in ("remaining", "t_ms", "expire_at", "limit"):
            assert int(arrays[f][i]) == before[k][f], (k, f)
    # the round trip: a new instance restores the rows
    inst = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0,
                             loader=FileLoader(str(tmp_path / "port.npz"))))
    try:
        rs = inst.get_rate_limits([RateLimitRequest(**req(key=k, hits=0))
                                   for k in keys], now_ms=NOW + 2)
        assert [r.remaining for r in rs] == [100_000 - 3] * len(keys)
    finally:
        inst.close()


def test_tier_victim_filter_skips_pinned_keys(monkeypatch):
    hp = Pair(monkeypatch, threshold=1, tier=True)
    try:
        hp.send("object", [req(key="vic")], NOW)
        for inst in (hp.p, hp.j):
            assert inst._tier_victim_pinned(kh("vic"))
            assert not inst._tier_victim_pinned(kh("other"))
        hp.send("object", [req(key="vic", behavior=int(
            Behavior.GLOBAL | Behavior.DRAIN_OVER_LIMIT))], NOW + 1)
        for inst in (hp.p, hp.j):
            assert not inst._tier_victim_pinned(kh("vic"))
    finally:
        hp.close()


def test_off_when_capacity_is_zero(monkeypatch):
    hp = Pair(monkeypatch, threshold=1, capacity=0)
    try:
        for lane in LANES:
            hp.send(lane, [req(key="off") for _ in range(4)], NOW)
        assert hp.pinned() == set()
        assert hp.p._hotset is None
    finally:
        hp.close()


def test_hot_set_runs_on_the_engine_device(monkeypatch):
    hp = Pair(monkeypatch, threshold=1)
    try:
        hp.send("wire", [req(key="dev")], NOW)
        hs = hp.p._hotset
        assert hs.device == hp.p.engine.device and hs.n == 1
        assert hs.capacity == 64
        assert hp.p._hot_sync_loop is not None
    finally:
        hp.close()
    assert Config().hot_set_capacity == 1024
    assert Config().hot_promote_threshold == 64


def test_promotion_waits_for_batches_routed_to_the_table(monkeypatch):
    """A batch routes a key to the table and its hits cross the
    threshold; before its step runs, another caller's batch drains the
    pending promotion.  JAX pins the key then, seeded from the row
    without the first batch's hits, which land on the shadowed table
    row and are lost (ROADMAP §C.2).  The port's pin waits behind the
    promotion gate until that step is done: every hit counts."""
    import threading

    hp = Pair(monkeypatch, threshold=8)
    try:
        out = {}
        for name, inst in (("port", hp.p), ("jax", hp.j)):
            from gubernator_tpu.types import RateLimitRequest as JaxReq

            cls = RateLimitRequest if name == "port" else JaxReq
            for i in range(7):  # below the threshold: the table
                inst.get_rate_limits([cls(**req(key="k"))], now_ms=NOW + i)
            real = inst.dispatcher.check_batch
            go, done = threading.Event(), threading.Event()
            first = [True]

            def step_after_the_other_batch(reqs, now, real=real, go=go,
                                           done=done, first=first):
                if first[0]:
                    first[0] = False
                    go.set()
                    done.wait(1.0)  # the port's pin waits for this step
                return real(reqs, now)

            monkeypatch.setattr(inst.dispatcher, "check_batch",
                                step_after_the_other_batch)

            def other(inst=inst, cls=cls, go=go, done=done):
                go.wait(10)
                inst.get_rate_limits([cls(**req(key="j"))], now_ms=NOW + 20)
                done.set()

            t = threading.Thread(target=other)
            t.start()
            inst.get_rate_limits([cls(**req(key="k")) for _ in range(5)],
                                 now_ms=NOW + 10)
            t.join(10)
            monkeypatch.setattr(inst.dispatcher, "check_batch", real)
            assert inst._hotset is not None and \
                inst._hotset.is_pinned(kh("k"))
            out[name] = inst.get_rate_limits(
                [cls(**req(key="k", hits=0))], now_ms=NOW + 30)[0].remaining
    finally:
        hp.close()
    assert out["port"] == 100_000 - 12
    assert out["jax"] == 100_000 - 7  # the 5 hits of the first batch lost
