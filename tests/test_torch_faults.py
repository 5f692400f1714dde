"""The port's fault injection (gubernator_tpu_torch/faults.py) held to the
JAX package's (gubernator_tpu/faults.py):

- every spec both catalogs accept parses to the same points, and every
  malformed spec raises in both; a point the port's catalog lacks (its
  subsystem is not ported) raises in the port alone;
- one spec and seed fire the same sequence over 10,000 draws in both;
- the faultpoints the port has: the dispatcher's (``device_step``,
  ``dispatch_*``), ``wire_ingest``, the GLOBAL ticks, counted by
  gubernator_fault_injected and recorded by the flight recorder;
- a daemon arms and clears them through POST /debug/faults.

Decisions and texts are compared exactly."""
import json
import urllib.error
import urllib.request

import pytest

from gubernator_tpu import faults as jax_faults
from gubernator_tpu_torch import faults
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.faults import FaultInjected, FaultSet
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.telemetry import FlightRecorder
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

NOW = 1_765_000_000_000

#: points of subsystems the port has not ported (none since mesh-GLOBAL)
NOT_PORTED = ()

#: points of the Loader, the cold tier, MULTI_REGION and the mesh-GLOBAL
#: tier, ported with them
STATE_POINTS = ("snapshot", "restore", "tier_promote", "tier_demote",
                "mr_sync", "global_accum_swap", "global_psum")

VALID = [
    "peer_send:error:0.3",
    "device_step:delay:50ms",
    "peer_send@10.0.0.2:5001:error",
    "global_broadcast:error:1.0:",
    "peer_recv@127.0.0.1:9:error:0.25, dispatch_merge:delay:1ms:0.5",
    "wire_ingest",
    "dispatch_carry:delay:2s",
    "peer_circuit@h:1:error:0",
    "",
    " , ",
]

MALFORMED = [
    "no_such_point:error",
    "peer_send:explode",
    "device_step:delay",
    "device_step:delay::0.5",
    "peer_send:error:1.5",
    "peer_send:error:-0.1",
    "peer_send:error:often",
    "dispatch_sync:delay:50parsecs",
]


def points(desc: dict) -> list:
    return desc["points"]


@pytest.mark.parametrize("spec", VALID)
def test_valid_specs_parse_as_jax(spec):
    port, ref = FaultSet(seed=3), jax_faults.FaultSet(seed=3)
    got, want = port.arm(spec), ref.arm(spec)
    assert points(got) == points(want)
    assert (got["armed"], got["spec"], got["seed"]) == (
        want["armed"], want["spec"], want["seed"])


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_as_jax(spec):
    port = FaultSet()
    port.arm("peer_send:error")
    with pytest.raises(ValueError) as e_port:
        port.arm(spec)
    with pytest.raises(ValueError) as e_ref:
        jax_faults.FaultSet().arm(spec)
    # the unknown point's message lists each package's own catalog
    if not spec.startswith("no_such_point"):
        assert str(e_port.value) == str(e_ref.value)
    # a refused spec changes nothing
    assert port.describe()["spec"] == "peer_send:error" and port.armed


@pytest.mark.parametrize("point", STATE_POINTS)
def test_state_points_arm_and_describe_as_jax(point):
    """The Loader's, the cold tier's, MULTI_REGION's and the mesh-GLOBAL
    tier's points are in the catalog with the JAX package's
    description, and arm in both packages."""
    assert faults.FAULT_POINTS[point] == jax_faults.FAULT_POINTS[point]
    got = []
    for cls in (FaultSet, jax_faults.FaultSet):
        fs = cls()
        fs.arm(f"{point}:error")
        assert fs.armed
        with pytest.raises(Exception) as e:
            fs.fire(point)
        assert type(e.value).__name__ == "FaultInjected"
        got.append(fs.describe()["spec"])
    assert got[0] == got[1] == f"{point}:error"


def test_catalog_is_the_jax_catalog_less_the_unported_points():
    assert set(faults.FAULT_POINTS) == (set(jax_faults.FAULT_POINTS)
                                        - set(NOT_PORTED))
    assert FaultSet().describe()["catalog"] == sorted(faults.FAULT_POINTS)


@pytest.mark.parametrize("spec,seed,tag", [
    ("peer_send:error:0.3", 7, "10.0.0.1:5"),
    ("peer_send@10.0.0.1:5:error:0.7", 0, "10.0.0.1:5"),
    ("global_hits:error:0.01", 12345, None),
    ("device_step:delay:0ms:0.5,device_step:error:0.2", 99, None),
])
def test_seeded_draws_fire_as_jax(spec, seed, tag):
    """10,000 checks of one point: the same fire sequence, point
    counters and describe() in both packages."""
    name = spec.split(":")[0].split("@")[0]
    seqs = []
    for cls in (FaultSet, jax_faults.FaultSet):
        fs = cls(seed=seed)
        fs.arm(spec)
        seq = []
        for _ in range(10_000):
            try:
                fs.fire(name, tag)
                seq.append(0)
            except Exception as e:  # FaultInjected of either package
                assert type(e).__name__ == "FaultInjected"
                seq.append(1)
        seqs.append((seq, points(fs.describe())))
    assert seqs[0] == seqs[1]
    assert 0 < sum(seqs[0][0]) < 10_000


def test_tags_scope_a_point_and_should_reads_it():
    fs = FaultSet()
    fs.arm("peer_circuit@a:1:error,peer_send:error")
    assert fs.should("peer_circuit", "a:1")
    assert not fs.should("peer_circuit", "b:2")
    for tag in ("a:1", "b:2", None):
        with pytest.raises(FaultInjected, match="fault injected: peer_send"):
            fs.fire("peer_send", tag)
    fs.clear()
    assert not fs.armed and not fs.should("peer_circuit", "a:1")
    fs.fire("peer_send")


def test_from_env_reads_the_spec_and_seed():
    env = {"GUBER_FAULT": "peer_send:error:0.5", "GUBER_FAULT_SEED": "11"}
    port, ref = FaultSet.from_env(env), jax_faults.FaultSet.from_env(env)
    assert port.armed and port.seed == ref.seed == 11
    assert points(port.describe()) == points(ref.describe())
    assert FaultSet.from_env({"GUBER_FAULT_SEED": "x"}).seed == 0
    assert not FaultSet.from_env({}).armed
    with pytest.raises(ValueError):
        FaultSet.from_env({"GUBER_FAULT": "no_such_point:error"})


def test_fires_are_counted_and_arming_is_recorded():
    fs = FaultSet()
    fs.metrics, fs.recorder = Metrics(), FlightRecorder()
    fs.arm("device_step:error")
    for _ in range(3):
        with pytest.raises(FaultInjected):
            fs.fire("device_step")
    fs.clear()
    assert fs.metrics.registry.get_sample_value(
        "gubernator_fault_injected_total", {"point": "device_step"}) == 3
    assert [e["kind"] for e in fs.recorder.events()] == [
        "fault_armed", "fault_cleared"]


@pytest.fixture()
def inst(monkeypatch):
    monkeypatch.delenv("GUBER_FAULT", raising=False)
    monkeypatch.setenv("GUBER_PIPELINE", "0")
    i = V1Instance(Config(device="cpu", cache_size=4096, batch_rows=64,
                          sweep_interval_ms=0))
    yield i
    i.close()


def req(key="k", hits=1):
    return RateLimitRequest(name="f", unique_key=key, hits=hits, limit=5,
                            duration=60_000)


@pytest.mark.parametrize("point", ["device_step", "dispatch_enqueue",
                                   "dispatch_launch", "dispatch_merge",
                                   "dispatch_splice"])
def test_dispatcher_points_fail_the_wave_then_clear(inst, point):
    """An armed error point fails the object lane's batch with
    FaultInjected (the queued wave's path); disarmed, the next batch
    serves and its key was not debited by the failed one, except at
    dispatch_splice, which fires after the step."""
    inst.faults.arm(f"{point}:error")
    with pytest.raises(FaultInjected, match=point):
        inst.get_rate_limits([req()], now_ms=NOW)
    inst.faults.clear()
    r = inst.get_rate_limits([req(hits=0)], now_ms=NOW)[0]
    assert r.remaining == (4 if point == "dispatch_splice" else 5)
    assert inst.metrics.registry.get_sample_value(
        "gubernator_fault_injected_total", {"point": point}) == 1


def test_inline_wave_and_wire_ingest_points(inst):
    data = encode_get_rate_limits([req("w")])
    inst.faults.arm("wire_ingest:error")
    with pytest.raises(FaultInjected, match="wire_ingest"):
        inst.get_rate_limits_wire(data, NOW)
    inst.faults.arm("device_step:error")
    with pytest.raises(FaultInjected, match="device_step"):
        inst.get_rate_limits_wire(data, NOW)  # the fused lane, inline
    inst.faults.arm("device_step:delay:1ms")
    assert inst.get_rate_limits_wire(data, NOW)
    assert inst.dispatcher.inline_waves >= 1
    inst.faults.clear()


def test_dispatch_carry_fails_only_the_carried_job(monkeypatch):
    """With waves of 64 rows, a 40-row job then a 40-row job: the second
    becomes the carry; an armed dispatch_carry fails it alone."""
    import threading

    monkeypatch.setenv("GUBER_PIPELINE", "0")
    i = V1Instance(Config(device="cpu", cache_size=4096, batch_rows=8,
                          sweep_interval_ms=0))
    try:
        i.dispatcher.max_wave = 64
        i.dispatcher.max_delay_s = 0.2
        i.faults.arm("dispatch_carry:error")
        out = {}

        def call(name):
            try:
                out[name] = i.get_rate_limits(
                    [req(f"{name}{j}") for j in range(40)], now_ms=NOW)
            except FaultInjected as e:
                out[name] = e

        a = threading.Thread(target=call, args=("a",))
        b = threading.Thread(target=call, args=("b",))
        a.start()
        b.start()
        a.join()
        b.join()
        kinds = sorted(type(v).__name__ for v in out.values())
        assert kinds == ["FaultInjected", "list"], out
    finally:
        i.close()


@pytest.mark.parametrize("point,stage", [
    ("global_hits", "global hits flush"),
    ("global_broadcast", "global broadcast")])
def test_global_ticks_abort_and_report_as_jax(point, stage):
    """An armed tick point aborts the GLOBAL manager's tick before its
    queues are popped; health reads JAX's message.  Once cleared, the
    next tick runs with the queue intact."""
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.types import Behavior, PeerInfo

    me = "127.0.0.1:1"
    i = V1Instance(Config(device="cpu", cache_size=4096,
                          sweep_interval_ms=0, advertise_address=me,
                          behaviors=BehaviorConfig(
                              global_sync_wait_ms=60_000,
                              global_broadcast_interval_ms=60_000)))
    try:
        i.set_peers([PeerInfo(grpc_address=me),
                     PeerInfo(grpc_address="127.0.0.1:2")])
        key = next(f"g{j}" for j in range(200)
                   if (i.owner_of(f"f_g{j}").info.grpc_address == me)
                   == (point == "global_broadcast"))
        g = RateLimitRequest(name="f", unique_key=key, hits=2, limit=5,
                             duration=60_000, behavior=Behavior.GLOBAL)
        i.get_rate_limits([g], now_ms=NOW)
        gm = i.global_manager
        queued = gm.queued()
        i.faults.arm(f"{point}:error")
        tick = gm._hits_tick if point == "global_hits" else \
            gm._broadcast_tick
        tick()
        h = i.health_check()
        assert (h.status, h.message) == (
            "unhealthy", f"{stage}: fault injected: {point}")
        assert gm.queued() == queued
    finally:
        i.faults.clear()
        i.close()


def test_daemon_arms_and_clears_over_http(monkeypatch):
    from gubernator_tpu_torch.daemon import spawn_daemon

    monkeypatch.delenv("GUBER_FAULT", raising=False)
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=4096,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address=""))
    base = f"http://127.0.0.1:{d.http_port}/debug/faults"

    def post(body):
        r = urllib.request.Request(base, data=json.dumps(body).encode(),
                                   method="POST")
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())

    try:
        code, got = post({"spec": "device_step:error:0.5", "seed": 4})
        assert code == 200 and got["armed"] and got["seed"] == 4
        with urllib.request.urlopen(base, timeout=30) as resp:
            desc = json.loads(resp.read())
        assert desc["spec"] == "device_step:error:0.5"
        assert desc["catalog"] == sorted(faults.FAULT_POINTS)
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"spec": "no_such_point:error"})
        assert e.value.code == 400
        assert d.instance.faults.describe()["spec"] == "device_step:error:0.5"
        code, got = post({"clear": True})
        assert code == 200 and not got["armed"]
        assert [e["kind"] for e in d.instance.recorder.events(
            kind="fault_armed")] == ["fault_armed"]
    finally:
        d.close()
