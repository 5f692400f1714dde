"""The port's hot set across the devices of a mesh (hotset.py with
``mesh=``): one replica on each of a 4-shard CPU mesh's devices, held to
the JAX HotSetEngine on ``make_mesh(n=4)``.  The same pins, seeded
requests (objects and columns, both algorithms) and syncs go to both;
every answer, and after every sync all nine columns and the base of
every replica, are equal (tolerance 0: integers).  An instance passes
its engine's mesh to the hot set, and builds none in mesh mode."""
import numpy as np
import pytest

from gubernator_tpu_torch.config import Config
from gubernator_tpu_torch.hashing import hash_key
from gubernator_tpu_torch.hotset import HotSetEngine
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.mesh import make_mesh
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

from test_torch_hotset import Pair, lreq, req  # noqa: E402

NOW = 1_764_000_000_000
N = 4


class MeshPair(Pair):
    """Pair with the port's replicas placed by a mesh."""

    def __init__(self, capacity=256, batch_per_chip=32):
        from gubernator_tpu.parallel import make_mesh as jax_mesh
        from gubernator_tpu.parallel.hotset import HotSetEngine as JaxHot

        self.j = JaxHot(jax_mesh(n=N), capacity=capacity,
                        batch_per_chip=batch_per_chip)
        self.p = HotSetEngine(capacity=capacity,
                              batch_per_chip=batch_per_chip,
                              mesh=make_mesh(["cpu"] * N))
        self.n = N


def test_replicas_live_on_the_mesh_devices():
    mesh = make_mesh(["cpu"] * N)
    hs = HotSetEngine(capacity=64, mesh=mesh)
    assert hs.n == N and len(hs.reps) == N
    for d, rep in enumerate(hs.reps):
        assert all(c.device == mesh.devices[d] for c in rep)
    assert hs.state.remaining.shape == (N, 64)
    assert sum(int(t.nbytes) for t in hs.table_tensors()) == \
        N * 64 * (8 * 8 + 4) + 2 * N * 64 * 8


@pytest.mark.parametrize("seed", range(3))
def test_seeded_streams_fold_as_jax(seed):
    p = MeshPair()
    rng = np.random.default_rng(seed)
    keys = [f"t{i}" for i in range(6)] + [f"l{i}" for i in range(6)]
    for k in keys:
        r = lreq(k, limit=50, burst=80) if k[0] == "l" else req(k, limit=90)
        assert p.pin(r, k, NOW)
    now = NOW
    for step in range(6):
        now += int(rng.integers(1, 400))
        batch = []
        for _ in range(int(rng.integers(20, 120))):
            k = keys[int(rng.integers(0, len(keys)))]
            hits = int(rng.integers(0, 4))
            batch.append(lreq(k, limit=50, burst=80, hits=hits)
                         if k[0] == "l" else req(k, limit=90, hits=hits))
        if step % 2:
            p.check_columns(batch, now)
        else:
            p.check(batch, now)
        p.sync()


def test_instance_hot_set_spans_the_engine_mesh():
    inst = V1Instance(Config(device="cpu", cache_size=1 << 12,
                             sweep_interval_ms=0, hot_set_capacity=64,
                             hot_promote_threshold=1),
                      mesh=make_mesh(["cpu"] * N))
    try:
        r = RateLimitRequest(name="n", unique_key="g", hits=1, limit=9,
                             duration=60_000, behavior=Behavior.GLOBAL)
        inst.get_rate_limits([r])
        inst.get_rate_limits([r])
        hs = inst._hotset
        assert hs is not None and hs.is_pinned(hash_key("n", "g"))
        assert hs.mesh is inst.engine.mesh and hs.n == N
    finally:
        inst.close()


def test_mesh_mode_builds_no_hot_set(monkeypatch):
    monkeypatch.setenv("GUBER_MESH_GLOBAL_CAP", "64")
    inst = V1Instance(Config(device="cpu", cache_size=1 << 12,
                             sweep_interval_ms=0, hot_set_capacity=64,
                             hot_promote_threshold=1, global_mode="mesh"),
                      mesh=make_mesh(["cpu"] * N))
    try:
        r = RateLimitRequest(name="n", unique_key="g", hits=1, limit=9,
                             duration=60_000, behavior=Behavior.GLOBAL)
        for _ in range(3):
            inst.get_rate_limits([r])
        assert inst._hotset is None
        assert inst._meshglobal.is_pinned(hash_key("n", "g"))
    finally:
        inst.close()
