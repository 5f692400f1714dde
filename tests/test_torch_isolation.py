"""The port stands alone: it imports neither JAX nor the JAX package (its
wire lane, its cluster path, one daemon's lifecycle, the cluster's
failure path, the state beyond the device table, the subprocess group,
MULTI_REGION, the hot set, the discovery backends and TLS included), and
its entry points default to the GPU, raising where there is none;
``cryptography`` loads only inside AutoTLS."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gubernator_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "gubernator_tpu_torch"


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gubernator_tpu_torch.__path__, "gubernator_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = all_modules()
    assert "gubernator_tpu_torch.ops.decide" in mods
    for m in ("peers", "peer_client", "global_manager", "discovery",
              "cluster", "interval", "netutil", "telemetry", "metrics",
              "cmd.healthcheck", "faults", "store", "tiering",
              "analytics", "multiregion", "cmd.cluster", "hotset",
              "tlsutil", "cmd.tapcost", "tracing", "slo", "memledger",
              "fleet"):
        assert f"gubernator_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_wire_lane_loads_nothing_of_the_jax_package():
    """The port's wire lane (C++ ingest, inline wave, response build and
    the protobuf lane) in a fresh process: no JAX-package module is
    loaded, and no file of gubernator_tpu/ops/ (its _native extension)
    is mapped into the process."""
    code = (
        "import sys\n"
        "from gubernator_tpu_torch.config import Config\n"
        "from gubernator_tpu_torch.instance import V1Instance\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "from gubernator_tpu_torch.wire import encode_get_rate_limits\n"
        "inst = V1Instance(Config(cache_size=4096, batch_rows=64, "
        "device='cpu', sweep_interval_ms=0))\n"
        "for extra in ({}, {'behavior': 4, 'duration': 1}, "
        "{'metadata': {'a': 'b'}}):\n"
        "    out = inst.get_rate_limits_wire(encode_get_rate_limits("
        "[R(name='n', unique_key='k', limit=5, **extra)]), "
        "1_765_000_000_000)\n"
        "    assert out, extra\n"
        "assert inst.dispatcher.inline_waves >= 2\n"
        "inst.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "maps = open('/proc/self/maps').read()\n"
        f"mapped = sorted({{l.split()[-1] for l in maps.splitlines() "
        f"if {str(ROOT / 'gubernator_tpu' / 'ops')!r} in l}})\n"
        "wire = [l for l in maps.splitlines() if 'libguberwire' in l]\n"
        "print(bad, mapped, len(wire))\n"
        "sys.exit(1 if bad or mapped or not wire else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cluster_path_loads_nothing_of_the_jax_package():
    """The cluster path (ring, forward hop over gRPC, GLOBAL manager,
    peer service) in a fresh process: two port daemons on the CPU, a
    forwarded row and a GLOBAL row through daemon 0's object and wire
    lanes; no JAX-package module is loaded."""
    code = (
        "import sys\n"
        "from gubernator_tpu_torch import cluster\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "from gubernator_tpu_torch.wire import encode_get_rate_limits\n"
        "c = cluster.start(2, device='cpu')\n"
        "try:\n"
        "    inst = c.instance_at(0)\n"
        "    far = next(i for i in range(200) if c.owner_daemon_of("
        "f'n_k{i}') is c.daemon_at(1))\n"
        "    reqs = [R(name='n', unique_key=f'k{i}', limit=5, "
        "duration=60000, behavior=2 * (i % 2)) for i in range(8)]\n"
        "    reqs.append(R(name='n', unique_key=f'k{far}', limit=5, "
        "duration=60000))\n"
        "    assert not any(r.error for r in inst.get_rate_limits(reqs))\n"
        "    assert inst.get_rate_limits_wire(encode_get_rate_limits(reqs))\n"
        "    assert inst.forwarded_rows > 0, inst.forwarded_rows\n"
        "    assert inst.global_manager is not None\n"
        "finally:\n"
        "    c.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_lifecycle_path_loads_nothing_of_the_jax_package():
    """One daemon's lifecycle in a fresh process: pipelined waves, a
    shed, /metrics, /healthz?deep=1, /debug/events, the healthcheck CLI
    and a drained close; no JAX-package module is loaded."""
    code = (
        "import os, sys, urllib.request\n"
        "os.environ['GUBER_PIPELINE'] = '1'\n"
        "from gubernator_tpu_torch.cmd import healthcheck\n"
        "from gubernator_tpu_torch.config import DaemonConfig\n"
        "from gubernator_tpu_torch.daemon import spawn_daemon\n"
        "from gubernator_tpu_torch.dispatcher import ResourceExhausted\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "from gubernator_tpu_torch.wire import encode_get_rate_limits\n"
        "d = spawn_daemon(DaemonConfig(http_listen_address='127.0.0.1:0', "
        "grpc_listen_address='', cache_size=4096, device='cpu', "
        "drain_grace_ms=50))\n"
        "inst, base = d.instance, f'http://127.0.0.1:{d.http_port}'\n"
        "assert inst.get_rate_limits_wire(encode_get_rate_limits("
        "[R(name='n', unique_key='k', limit=5)]))\n"
        "inst.dispatcher.admission_limit = 1\n"
        "try:\n"
        "    inst.get_rate_limits([R(name='n', unique_key='k', limit=5)] * 2)\n"
        "    raise SystemExit('no shed')\n"
        "except ResourceExhausted:\n"
        "    pass\n"
        "for path in ('/metrics', '/healthz?deep=1', '/debug/events'):\n"
        "    assert urllib.request.urlopen(base + path).read()\n"
        "assert healthcheck.main(['--url', base + '/healthz', "
        "'--deep']) == 0\n"
        "assert 'packed_pipelined' in [e['wave_kind'] for e in "
        "inst.recorder.events(kind='wave_launched')]\n"
        "d.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_state_path_loads_nothing_of_the_jax_package(tmp_path):
    """The state beyond the device table in a fresh process: a daemon
    with the cold tier, the analytics and a snapshot path, cold serves,
    /debug/topkeys, remove, the snapshot written at close and restored
    by a second daemon; no JAX-package module is loaded, and the native
    cold store is the host library's."""
    snap = str(tmp_path / "s.npz")
    code = (
        "import os, sys, json, urllib.request\n"
        "os.environ['GUBER_TIER_COLD'] = '1'\n"
        "from gubernator_tpu_torch.config import DaemonConfig\n"
        "from gubernator_tpu_torch.daemon import spawn_daemon\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "cfg = DaemonConfig(http_listen_address='127.0.0.1:0', "
        f"grpc_listen_address='', cache_size=1024, device='cpu', "
        f"snapshot_path={snap!r})\n"
        "d = spawn_daemon(cfg)\n"
        "inst = d.instance\n"
        "reqs = [R(name='n', unique_key=f'k{i}', limit=5, "
        "duration=60000) for i in range(1000)]\n"
        "assert not any(r.error for r in inst.get_rate_limits(reqs))\n"
        "assert inst._tier.stats()['native'] and inst._tier.cold_keys()\n"
        "top = json.loads(urllib.request.urlopen("
        "f'http://127.0.0.1:{d.http_port}/debug/topkeys').read())\n"
        "assert top['keys']\n"
        "assert inst.remove('n', 'k1')\n"
        "d.close()\n"
        "d = spawn_daemon(cfg)\n"
        "assert d.instance._tier.cold_keys() > 0\n"
        "d.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_failure_path_loads_nothing_of_the_jax_package():
    """The failure path in a fresh process: a 3-daemon port cluster on
    the CPU with short gate timings, a fault armed over HTTP, degraded
    serves, an ejection and a readmission, a handover to a 4th daemon;
    no JAX-package module is loaded."""
    code = (
        "import json, sys, time, urllib.request\n"
        "from gubernator_tpu_torch import cluster\n"
        "from gubernator_tpu_torch.config import BehaviorConfig\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "from gubernator_tpu_torch.wire import encode_get_rate_limits\n"
        "b = BehaviorConfig(peer_eject_after_ms=200, "
        "peer_readmit_after_ms=200, peer_circuit_cooldown_ms=100)\n"
        "c = cluster.start(3, device='cpu', behaviors=b, "
        "handover_on_reshard=True)\n"
        "try:\n"
        "    d0, d2 = c.daemon_at(0), c.daemon_at(2)\n"
        "    far = [f'k{i}' for i in range(300) if c.owner_daemon_of("
        "f'n_k{i}') is d2][:4]\n"
        "    reqs = [R(name='n', unique_key=k, limit=5, duration=60000) "
        "for k in far]\n"
        "    body = json.dumps({'spec': "
        "f'peer_send@{d2.advertise_address}:error'}).encode()\n"
        "    urllib.request.urlopen(urllib.request.Request("
        "f'http://127.0.0.1:{d0.http_port}/debug/faults', data=body, "
        "method='POST')).read()\n"
        "    inst = d0.instance\n"
        "    for _ in range(60):\n"
        "        assert inst.get_rate_limits_wire(encode_get_rate_limits("
        "reqs))\n"
        "        if inst.recorder.events(kind='ring_ejected'):\n"
        "            break\n"
        "        time.sleep(0.05)\n"
        "    assert inst.recorder.events(kind='ring_ejected')\n"
        "    inst.faults.clear()\n"
        "    for _ in range(100):\n"
        "        inst.get_rate_limits(reqs)\n"
        "        if inst.recorder.events(kind='ring_readmitted'):\n"
        "            break\n"
        "        time.sleep(0.05)\n"
        "    assert inst.recorder.events(kind='ring_readmitted')\n"
        "    assert inst.recorder.events(kind='degraded')\n"
        "    c.restart(2)\n"
        "finally:\n"
        "    c.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def test_group_and_region_paths_load_nothing_of_the_jax_package():
    """The subprocess group and MULTI_REGION in a fresh process: a
    2-worker CPU group answering on its shared port, then 2 regions x 1
    daemon replicating a MULTI_REGION hit; no JAX-package module is
    loaded, in this process or in the group's workers (each worker logs
    every import it makes: PYTHONPROFILEIMPORTTIME)."""
    code = (
        "import sys, time, grpc\n"
        "from gubernator_tpu_torch import cluster\n"
        "from gubernator_tpu_torch.config import DaemonConfig\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "from gubernator_tpu_torch.wire import encode_get_rate_limits\n"
        "g = cluster.start_subprocess_group(2, device='cpu', "
        "cache_size=4096, batch_rows=64, "
        "env_extra={'PYTHONPROFILEIMPORTTIME': '1'})\n"
        "try:\n"
        "    ch = grpc.insecure_channel(g.client_address)\n"
        "    out = ch.unary_unary('/pb.gubernator.V1/GetRateLimits')("
        "encode_get_rate_limits([R(name='n', unique_key='k', limit=5, "
        "duration=60000)]), timeout=30)\n"
        "    assert out\n"
        "    ch.close()\n"
        "finally:\n"
        "    g.stop(remove_logs=False)\n"
        "for lp in g.log_paths:\n"
        "    names = [ln.rsplit('|', 1)[1].strip() for ln in open(lp) "
        "if ln.startswith('import time:') and '|' in ln]\n"
        "    assert 'gubernator_tpu_torch.daemon' in names, names[-5:]\n"
        "    assert not [m for m in names if m == 'jax' or "
        "m.startswith('jax.') or m == 'gubernator_tpu' or "
        "m.startswith('gubernator_tpu.')], lp\n"
        "c = cluster.start_with([DaemonConfig(grpc_listen_address="
        "'127.0.0.1:0', http_listen_address='127.0.0.1:0', device='cpu', "
        "cache_size=4096, batch_rows=64, data_center=dc) "
        "for dc in ('east', 'west')])\n"
        "try:\n"
        "    r = R(name='n', unique_key='m', hits=3, limit=50, "
        "duration=60000, behavior=16)\n"
        "    c.instance_at(0).get_rate_limits([r])\n"
        "    q = R(name='n', unique_key='m', hits=0, limit=50, "
        "duration=60000, behavior=16)\n"
        "    for _ in range(200):\n"
        "        if c.instance_at(1).get_rate_limits([q])[0].remaining "
        "== 47:\n"
        "            break\n"
        "        time.sleep(0.05)\n"
        "    assert c.instance_at(1).get_rate_limits([q])[0].remaining "
        "== 47\n"
        "finally:\n"
        "    c.stop()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.') or m == 'cryptography')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def test_hot_set_discovery_and_tls_paths_load_nothing_of_the_jax_package(
        tmp_path):
    """A promoted GLOBAL key on the hot set, a daemon on file discovery
    and a pair of AutoTLS daemons (one forwarding to the other), in a
    fresh process: no JAX-package module is loaded, and ``cryptography``
    only once AutoTLS runs."""
    peers = tmp_path / "peers"
    code = (
        "import sys\n"
        "from gubernator_tpu_torch.config import (Config, DaemonConfig, "
        "TLSSettings)\n"
        "from gubernator_tpu_torch.daemon import spawn_daemon\n"
        "from gubernator_tpu_torch.instance import V1Instance\n"
        "from gubernator_tpu_torch.types import RateLimitRequest as R\n"
        "inst = V1Instance(Config(device='cpu', hot_set_capacity=64, "
        "hot_promote_threshold=1))\n"
        "r = R(name='n', unique_key='g', limit=9, duration=60000, "
        "behavior=2)\n"
        "inst.get_rate_limits([r]); inst.get_rate_limits([r])\n"
        "assert inst._hotset.slots\n"
        "inst.close()\n"
        f"open({str(peers)!r}, 'w').write('127.0.0.1:1\\n')\n"
        "d = spawn_daemon(DaemonConfig(device='cpu', cache_size=4096, "
        "grpc_listen_address='127.0.0.1:0', http_listen_address="
        f"'127.0.0.1:0', peer_discovery_type='file', peers_file="
        f"{str(peers)!r}))\n"
        "assert [p.info.grpc_address for p in d.instance.peers()] == "
        "['127.0.0.1:1']\n"
        "d.close()\n"
        "early = 'cryptography' in sys.modules\n"
        "d = spawn_daemon(DaemonConfig(device='cpu', cache_size=4096, "
        "grpc_listen_address='127.0.0.1:0', http_listen_address="
        "'127.0.0.1:0', tls=TLSSettings(auto_tls=True)))\n"
        "d.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gubernator_tpu' "
        "or m.startswith('gubernator_tpu.'))\n"
        "print(bad, early)\n"
        "sys.exit(1 if bad or early else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "gubernator_tpu"), (path, name)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.config import Config, DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.engine import BucketEngine
    from gubernator_tpu_torch.hotset import HotSetEngine
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.sharded import ShardedEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BucketEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        V1Instance(Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        V1Instance(Config(engine="xla"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster.start(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HotSetEngine()
    assert Config().device == DaemonConfig().device == "cuda"


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0


def test_chip_ab_refuses_without_cuda(monkeypatch):
    import chip_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_ab.main(["--old-csrc", "."])
    assert e.value.code != 0
