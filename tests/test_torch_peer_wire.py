"""The forward hop's codec and the GLOBAL update round trip against the JAX
package: ``stamp_req_tlvs`` and ``split_resp_items`` (csrc/wire.cpp)
give the bytes of gubernator_tpu/ops/_native on seeded streams, with and
without caller stamps; the TLV helpers of wire.py give JAX's bytes; the
owner side (``get_peer_rate_limits_wire`` and ``get_peer_rate_limits``)
answers a forwarded stream as a JAX instance does; and
``build_global_updates`` → ``update_peer_globals`` on TOKEN, LEAKY and
Gregorian rows gives JAX's UpdatePeerGlobal bytes and JAX's table rows.
Exact equality everywhere."""
import numpy as np
import pytest

from gubernator_tpu.ops import native as jax_native
from gubernator_tpu.proto import gubernator_pb2 as jax_pb
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu.wire import req_to_tlv as jax_req_to_tlv
from gubernator_tpu import wire as jax_wire
from gubernator_tpu_torch import wire
from gubernator_tpu_torch.config import Config
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.ops import native
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_765_000_000_000
CAP = 1 << 12


def seeded_reqs(seed: int, n: int, stamped: bool, cls=RateLimitRequest,
                greg: bool = True, global_share: float = 0.0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 40))
        g = greg and rng.random() < 0.1
        beh = (4 if g else 0) | (2 if rng.random() < global_share else 0)
        beh |= 8 if rng.random() < 0.03 else 0  # RESET_REMAINING
        out.append(cls(
            name=f"pw{k % 3}", unique_key=f"u{k}é" if k % 7 == 0 else f"u{k}",
            hits=int(rng.integers(0, 4)), limit=int(5 + k % 9),
            duration=int(rng.integers(0, 3)) if g
            else int(rng.choice([5_000, 60_000, 3_600_000])),
            algorithm=int(k % 2), behavior=beh,
            burst=int(rng.integers(0, 12)),
            created_at=(NOW + 10 * i if stamped and rng.random() < 0.5
                        else 0)))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("stamped", [False, True],
                         ids=["unstamped", "caller-stamped"])
def test_stamp_req_tlvs_matches_jax(seed, stamped):
    data = wire.encode_get_rate_limits(seeded_reqs(seed, 200, stamped))
    p = native.parse_get_rate_limits(data)
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(p["n"], size=120, replace=False))
    for stamp in (NOW, 1, (1 << 62) + 5):
        got = native.stamp_req_tlvs(data, p["tlv_off"][sel],
                                    p["tlv_len"][sel],
                                    p["created_at"][sel], stamp)
        want = jax_native.stamp_req_tlvs(
            data, p["tlv_off"][sel].astype(np.int64),
            p["tlv_len"][sel].astype(np.int64), p["created_at"][sel], stamp)
        assert got == want
        # every forwarded row now carries a stamp, the caller's first
        q = native.parse_get_rate_limits(got)
        np.testing.assert_array_equal(
            q["created_at"], np.where(p["created_at"][sel] > 0,
                                      p["created_at"][sel], stamp))


def test_stamp_req_tlvs_refuses_a_malformed_slice():
    data = wire.encode_get_rate_limits(seeded_reqs(0, 3, False))
    p = native.parse_get_rate_limits(data)
    for off, ln in ((p["tlv_off"] + 1, p["tlv_len"]),
                    (p["tlv_off"], p["tlv_len"] - 1),
                    (p["tlv_off"], p["tlv_len"] + len(data))):
        with pytest.raises(ValueError, match="malformed"):
            native.stamp_req_tlvs(data, off, ln, p["created_at"], NOW)
    assert native.stamp_req_tlvs(data, p["tlv_off"][:0], p["tlv_len"][:0],
                                 p["created_at"][:0], NOW) == b""


def response_stream(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    msg = jax_pb.GetRateLimitsResp()
    for _ in range(n):
        r = msg.responses.add(
            status=int(rng.integers(0, 2)), limit=int(rng.integers(0, 1 << 40)),
            remaining=int(rng.integers(0, 100)),
            reset_time=int(NOW + rng.integers(0, 1 << 30)))
        if rng.random() < 0.2:
            r.error = "rate limit table full"
        if rng.random() < 0.1:
            r.metadata["owner"] = f"127.0.0.1:{rng.integers(1, 9)}"
    return msg.SerializeToString()


@pytest.mark.parametrize("seed", range(4))
def test_split_resp_items_matches_jax(seed):
    data = response_stream(seed, 150)
    got, want = native.split_resp_items(data), jax_native.split_resp_items(data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size == 150
    for bad in (data + b"\x12\x00", data[:-1], b"\x0a\x05\x08\x01",
                b"\x0a\x02\x0f\x00"):
        assert native.split_resp_items(bad) is None
        assert jax_native.split_resp_items(bad) is None
    assert native.split_resp_items(b"")[0].size == 0


def test_error_rows_match_jax_bytes():
    msgs = ["while fetching rate limit from peer 127.0.0.1:9: boom", None,
            "peer 127.0.0.1:9 circuit open"]
    z = np.zeros(3, np.int64)
    got = native.build_responses_from_columns(
        (np.zeros(3, np.int32), z, z, z), 0, 3, msgs)
    want = jax_native.build_rate_limit_resps(np.zeros(3, np.int32), z, z, z,
                                             msgs)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_tlv_helpers_match_jax(seed):
    for req in seeded_reqs(seed, 30, True):
        t = wire.req_to_tlv(req)
        j = jax_req_to_tlv(JaxReq(**{f: getattr(req, f) for f in (
            "name", "unique_key", "hits", "limit", "duration", "algorithm",
            "behavior", "burst", "created_at")}))
        assert t == j
        assert wire.tlv_with_hits(t, 12345) == jax_wire.tlv_with_hits(j, 12345)
        assert wire.tlv_with_created(t, NOW) == \
            jax_wire.tlv_with_created(j, NOW)
        got, want = wire.req_from_tlv(t), jax_wire.req_from_tlv(j)
        for f in ("name", "unique_key", "hits", "limit", "duration",
                  "algorithm", "behavior", "burst", "created_at"):
            assert getattr(got, f) == getattr(want, f), f


# ---- the owner side and the GLOBAL round trip, against JAX instances ----

@pytest.fixture(params=["bucket", "classic"])
def engines(request, monkeypatch):
    """Factories of port and JAX instances on twin engines: the bucket
    engine beside JAX's PallasServingEngine, the classic one beside
    JAX's ShardedEngine."""
    from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine

    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    bucket = request.param == "bucket"
    made = []

    def port():
        inst = V1Instance(Config(cache_size=CAP, batch_rows=64,
                                 device="cpu", sweep_interval_ms=0,
                                 hot_set_capacity=0,
                                 engine="" if bucket else "xla"))
        made.append(inst)
        return inst

    def ref():
        engine = (PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                                      batch_per_shard=64) if bucket else None)
        inst = JaxInstance(JaxConfig(
            cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
            hot_set_capacity=0, behaviors=JaxBehaviors()),
            engine=engine)
        made.append(inst)
        return inst

    yield port, ref
    for inst in made:
        inst.close()


def peer_request_bytes(reqs) -> bytes:
    # GetPeerRateLimitsReq.requests is field 1, as GetRateLimitsReq's
    return wire.encode_get_rate_limits(reqs)


@pytest.mark.parametrize("seed", range(2))
def test_owner_side_answers_forwarded_bytes_as_jax(seed, engines):
    port, ref = (make() for make in engines)
    for b in range(4):
        reqs = seeded_reqs(10 * seed + b, 60, stamped=True,
                           global_share=0.2 if b % 2 else 0.0)
        data = peer_request_bytes(reqs)
        got = port.get_peer_rate_limits_wire(data, now_ms=NOW + 1_000 * b)
        want = ref.get_peer_rate_limits_wire(data, now_ms=NOW + 1_000 * b)
        assert got == want, b
    # GLOBAL rows marked their keys for the owner's broadcasts (closing
    # the manager runs its last ticks), and queued no hits
    gm = port.global_manager
    gm.close()
    assert gm.snapshot_stats()["broadcast_keys"] > 0
    assert gm.snapshot_stats()["hits_queued"] == 0
    assert gm.queued() == {"hit_keys": 0, "hits": 0, "update_keys": 0}


def test_owner_side_object_path_matches_jax(engines):
    port, ref = (make() for make in engines)
    reqs = seeded_reqs(5, 80, stamped=True, global_share=0.3)
    got = port.get_peer_rate_limits(reqs, now_ms=NOW)
    want = ref.get_peer_rate_limits(
        [JaxReq(**{f: getattr(r, f) for f in (
            "name", "unique_key", "hits", "limit", "duration", "algorithm",
            "behavior", "burst", "created_at")}) for r in reqs], now_ms=NOW)
    assert [(int(g.status), g.limit, g.remaining, g.reset_time, g.error)
            for g in got] == \
        [(int(w.status), w.limit, w.remaining, w.reset_time, w.error)
         for w in want]
    with pytest.raises(ValueError, match="too large"):
        port.get_peer_rate_limits(reqs * 13)


ROW_COLS = ("meta", "limit", "duration", "eff_ms", "burst", "remaining",
            "t_ms", "expire_at")


@pytest.mark.parametrize("kind", ["token", "leaky", "gregorian"])
def test_global_update_round_trip_matches_jax(kind, engines):
    from gubernator_tpu.hashing import hash_request_keys

    rng = np.random.default_rng({"token": 1, "leaky": 2, "gregorian": 3}[kind])
    keys = [f"g{i}" for i in range(24)]
    reqs = []
    for b in range(5):
        for k in keys:
            hits = int(rng.integers(0, 5))
            if kind == "gregorian":
                reqs.append((b, RateLimitRequest(
                    name="rt", unique_key=k, hits=hits, limit=20,
                    duration=int(rng.integers(0, 3)) if b == 0 else 1,
                    behavior=2 | 4, algorithm=int(k[-1] in "13579"))))
            else:
                reqs.append((b, RateLimitRequest(
                    name="rt", unique_key=k, hits=hits, limit=20,
                    duration=60_000, behavior=2, burst=25,
                    algorithm=int(kind == "leaky"))))
    port_instance, jax_instance = engines
    owner, ref_owner = port_instance(), jax_instance()
    fields = ("name", "unique_key", "hits", "limit", "duration", "algorithm",
              "behavior", "burst")
    for b in range(5):
        batch = [r for bb, r in reqs if bb == b]
        owner.get_rate_limits(batch, now_ms=NOW + 7_000 * b)
        ref_owner.get_rate_limits(
            [JaxReq(**{f: getattr(r, f) for f in fields}) for r in batch],
            now_ms=NOW + 7_000 * b)
    protos = [r for bb, r in reqs if bb == 4]
    msgs = owner.build_global_updates(protos)
    ref_msgs = ref_owner.build_global_updates(
        [JaxReq(**{f: getattr(r, f) for f in fields}) for r in protos])
    assert len(msgs) == len(ref_msgs) == len(keys)
    assert [m.SerializeToString() for m in msgs] == \
        [m.SerializeToString() for m in ref_msgs]
    replica, ref_replica = port_instance(), jax_instance()
    replica.update_peer_globals(msgs)
    ref_replica.update_peer_globals(ref_msgs)
    kh = hash_request_keys(["rt"] * len(keys), keys)
    found, cols = replica.engine.gather_rows(kh)
    ref_found, ref_cols = ref_replica.engine.gather_rows(kh)
    assert found.all() and ref_found.all()
    for c in ROW_COLS:
        np.testing.assert_array_equal(np.asarray(cols[c]),
                                      np.asarray(ref_cols[c]), err_msg=c)
    # and the replicas answer a query as each other
    probe = [RateLimitRequest(name=r.name, unique_key=r.unique_key, hits=0,
                              limit=r.limit, duration=r.duration,
                              algorithm=r.algorithm, behavior=r.behavior,
                              burst=r.burst) for r in protos]
    got = replica.get_rate_limits(probe, now_ms=NOW + 40_000)
    want = ref_replica.get_rate_limits(
        [JaxReq(**{f: getattr(r, f) for f in fields}) for r in probe],
        now_ms=NOW + 40_000)
    assert [(int(g.status), g.limit, g.remaining, g.reset_time)
            for g in got] == \
        [(int(w.status), w.limit, w.remaining, w.reset_time) for w in want]
