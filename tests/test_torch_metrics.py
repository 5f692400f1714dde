"""The port's Prometheus registry (gubernator_tpu_torch/metrics.py) held
to the JAX package's:

- every port family has a JAX namesake with the same type, help, labels
  and buckets, under the same attribute name (one help text, named
  below, is worded apart);
- the JAX families the port lacks are exactly those of the subsystems
  it has no counterpart of (listed here by subsystem);
- after one seeded stream through a JAX V1Instance and a port
  V1Instance on the CPU (object, fused, parse and protobuf lanes, then
  queue-full and drain sheds), the deterministic samples are equal:
  requests by call type, OVER_LIMIT decisions, live rows, sheds by
  reason; and a forward to a dead peer counts the same check errors,
  failed forwards and degraded serves in both (the JAX package's
  default behaviors, which the port's now equal).
"""
import socket

import pytest

from gubernator_tpu.dispatcher import ResourceExhausted as JaxShed
from gubernator_tpu.metrics import Metrics as JaxMetrics
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.config import BehaviorConfig, Config
from gubernator_tpu_torch.dispatcher import ResourceExhausted
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

from test_torch_service import caller_stream  # noqa: E402
from test_torch_wire import (CAP, ENGINES, jax_instance, port_instance,  # noqa: E402
                             quiet_jax, wire_stream)

#: JAX families of subsystems the port has no counterpart of, by subsystem
NOT_PORTED = {
    "fused Pallas serving's wave counter": {
        "gubernator_pallas_fused_waves"},
    "compile ledger": {"gubernator_jit_compiles"},
}


#: the one family whose help the port words apart: JAX's ends its
#: parentheses with a tag of the JAX project's own change log, which the
#: port's files do not carry; the rest of the text is equal
HELP_APART = {"scenario_runs"}


def families(m):
    """attribute name → (name, type, help, labels, buckets)."""
    out = {}
    for attr, c in vars(m).items():
        if hasattr(c, "_labelnames") and hasattr(c, "_type"):
            out[attr] = (c._name, c._type, c._documentation,
                         tuple(c._labelnames),
                         tuple(getattr(c, "_upper_bounds", ())))
    return out


def test_every_port_family_has_its_jax_namesake():
    port, ref = families(Metrics()), families(JaxMetrics())
    assert len(port) == 68
    for attr, fam in port.items():
        if attr in HELP_APART:
            want = ref[attr]
            assert fam[:2] + fam[3:] == want[:2] + want[3:], attr
            assert want[2].startswith(fam[2][:-1] + ", "), attr
        else:
            assert ref.get(attr) == fam, attr


def test_the_missing_families_are_the_unported_subsystems():
    port = {f[0] for f in families(Metrics()).values()}
    ref = {f[0] for f in families(JaxMetrics()).values()}
    assert port <= ref
    missing = set().union(*NOT_PORTED.values())
    assert ref - port == missing
    assert len(ref) == len(port) + len(missing)


def test_registries_are_per_instance():
    a, b = Metrics(), Metrics()
    a.over_limit_counter.inc(3)
    assert b.registry.get_sample_value("gubernator_over_limit_total") == 0
    assert b"gubernator_over_limit_total 0.0" in b.render()


def sample(m, name, **labels):
    return m.registry.get_sample_value(name, labels)


SAMPLES = [("gubernator_getratelimit_total", {"calltype": "api"}),
           ("gubernator_getratelimit_total", {"calltype": "peer"}),
           ("gubernator_over_limit_total", {}),
           ("gubernator_check_error_total", {"error": "peer_forward"}),
           ("gubernator_cache_size", {}),
           ("gubernator_admission_shed_total", {"reason": "queue_full"}),
           ("gubernator_admission_shed_total", {"reason": "draining"}),
           ("gubernator_admission_shed_total", {"reason": "deadline"})]


def drive(inst, req_cls, shed_cls):
    """The seeded stream, a health check, then one batch of each lane
    shed for a full queue and one of each after drain()."""
    for c in range(3):
        for reqs, now in caller_stream(c, 5):
            inst.get_rate_limits([req_cls(**r) for r in reqs], now_ms=now)
    for c in range(3, 6):
        for data, now in wire_stream(c, 5):
            inst.get_rate_limits_wire(data, now_ms=now)
    inst.health_check()
    reqs = [dict(name="shed", unique_key=f"s{i}", hits=1, limit=5,
                 duration=60_000) for i in range(6)]
    data = encode_get_rate_limits([RateLimitRequest(**r) for r in reqs])
    for limit in (4, None):
        if limit is None:
            inst.dispatcher.drain()
        else:
            inst.dispatcher.admission_limit = limit
        with pytest.raises(shed_cls):
            inst.get_rate_limits([req_cls(**r) for r in reqs])
        with pytest.raises(shed_cls):
            inst.get_rate_limits_wire(data)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_deterministic_samples_match_jax(monkeypatch, engine):
    quiet_jax(monkeypatch)
    ref = jax_instance(ENGINES[engine])
    try:
        drive(ref, JaxReq, JaxShed)
        want = [sample(ref.metrics, n, **lb) for n, lb in SAMPLES]
    finally:
        ref.close()
    port = port_instance(ENGINES[engine])
    try:
        drive(port, RateLimitRequest, ResourceExhausted)
        got = [sample(port.metrics, n, **lb) for n, lb in SAMPLES]
        leaks = sample(port.metrics, "gubernator_wave_buffer_leaks_total")
        pool = port.engine.wave_pool.stats()
    finally:
        port.close()
    assert got == want
    assert got[0] > 100 and got[2] > 0 and got[4] > 0
    # a shed fused batch gave its lease back
    assert got[5] == got[6] == 12 and leaks == 0 == pool["outstanding"]


def dead_address() -> str:
    """An address nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_failed_forward_counts_match_jax(monkeypatch):
    """One object-lane and one wire-lane row owned by a dead peer: each
    package counts two peer_forward check errors and two failed forwards
    (reason rpc_error) against that peer, and serves both rows degraded
    (counted by peer)."""
    from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.types import PeerInfo as JaxPeer

    quiet_jax(monkeypatch)
    me, dead = "127.0.0.1:1", dead_address()
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, advertise_address=me,
                             hot_set_capacity=0,
                             behaviors=BehaviorConfig()))
    ref = JaxInstance(JaxConfig(cache_size=CAP, batch_rows=64,
                                sweep_interval_ms=0, hot_set_capacity=0,
                                advertise_address=me,
                                behaviors=JaxBehaviors()))
    got = []
    try:
        port.set_peers([PeerInfo(grpc_address=me),
                        PeerInfo(grpc_address=dead)])
        ref.set_peers([JaxPeer(grpc_address=me), JaxPeer(grpc_address=dead)])
        key = next(f"k{i}" for i in range(200)
                   if port.owner_of(f"fwd_k{i}").info.grpc_address == dead)
        req = dict(name="fwd", unique_key=key, hits=1, limit=5,
                   duration=60_000)
        for inst, cls in ((port, RateLimitRequest), (ref, JaxReq)):
            r = inst.get_rate_limits([cls(**req)])[0]
            assert (r.error, r.metadata["degraded_peer"]) == ("", dead)
            assert inst.get_rate_limits_wire(encode_get_rate_limits(
                [RateLimitRequest(**req)]))
            got.append([sample(inst.metrics, n, **lb) for n, lb in (
                ("gubernator_check_error_total", {"error": "peer_forward"}),
                ("gubernator_forward_failed_total",
                 {"peer_addr": dead, "reason": "rpc_error"}),
                ("gubernator_getratelimit_total", {"calltype": "api"}),
                ("gubernator_degraded_served_total", {"peer_addr": dead}))])
    finally:
        port.close()
        ref.close()
    assert got[0] == got[1] == [2.0, 2.0, 2.0, 2.0]
