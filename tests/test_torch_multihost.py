"""The port's multi-host bootstrap (multihost.py): two OS processes, each
hosting 2 CPU shards, form one gloo group (the stand-in for two hosts'
GPUs), fold across the process boundary and run the decision step over
the 4-shard global mesh, as tests/test_multihost.py does with JAX.

The fold of 1, 1, 2, 2 gives 6 on every shard; the SoA step's decisions
on each process's blocks, put together, equal the JAX sharded step's on
``make_mesh(n=4)`` over the same global batch (exact), its counters
summed across both processes; and the bucket step (K1's plain version on
the CPU) inserts every key of both processes.  Every process and the
test have their own timeout, so a rendezvous that hangs fails the test.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_760_000_000_000
B = 16  # rows per shard

_WORKER = r"""
import json, sys
import numpy as np
import torch
proc_id = int(sys.argv[1]); coord = sys.argv[2]
from gubernator_tpu_torch import multihost
from gubernator_tpu_torch.core.batch import RequestBatch, pack_requests
from gubernator_tpu_torch.core.table import init_soa_table, init_table
from gubernator_tpu_torch.ops.decide import decide
from gubernator_tpu_torch.types import RateLimitRequest

NOW, B = %d, %d
multihost.initialize(coord, num_processes=2, process_id=proc_id,
                     local_device_count=2, device="cpu", timeout_s=60)
mesh = multihost.global_mesh()
assert mesh.n == 4 and list(mesh.local_shards) == [2 * proc_id,
                                                   2 * proc_id + 1]
parts = multihost.process_local_batch(
    mesh, np.full((2, 8), proc_id + 1, np.int64))
fold = multihost.psum(parts)
peak = multihost.pmax(parts)
assert fold.shape == (1, 8) and (fold == 6).all(), fold
assert (peak == 2).all(), peak

reqs = [RateLimitRequest(name="mh", unique_key=f"k{proc_id}_{i}", hits=1,
                         limit=5, duration=60_000) for i in range(2 * B)]
batch, _ = pack_requests(reqs, NOW, size=2 * B)
blocks = [multihost.process_local_batch(mesh, np.asarray(c)) for c in batch]
batches = [RequestBatch(*[b[d] for b in blocks]) for d in range(2)]
states = [init_soa_table(1 << 8, dev) for dev in mesh.local_devices]
outs, (over, ins) = multihost.sharded_step(mesh, states, batches, NOW)
assert ins == 4 * B, ins

rows = [init_table(1 << 8, dev) for dev in mesh.local_devices]
bouts, (bover, bins) = multihost.sharded_step(mesh, rows, batches, NOW,
                                              step=decide)
assert bins == 4 * B, bins
assert all((o.status == 0).all() and (o.remaining == 4).all()
           for o in bouts)
multihost.shutdown()
print("RESULT " + json.dumps({
    "over": over, "ins": ins,
    "cols": [[getattr(o, f).to(torch.int64).tolist() for o in outs]
             for f in ("status", "remaining", "reset_time", "limit",
                       "err")]}))
""" % (NOW, B)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_reference():
    """The JAX sharded step over the same global batch: process 0's two
    blocks, then process 1's."""
    import jax.numpy as jnp

    from gubernator_tpu.core.batch import RequestBatch, pack_requests
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.mesh import shard_table
    from gubernator_tpu.parallel.sharded import make_sharded_step
    from gubernator_tpu.types import RateLimitRequest

    mesh = make_mesh(n=4)
    cols = []
    for p in range(2):
        reqs = [RateLimitRequest(name="mh", unique_key=f"k{p}_{i}", hits=1,
                                 limit=5, duration=60_000)
                for i in range(2 * B)]
        cols.append(pack_requests(reqs, NOW, size=2 * B)[0])
    batch = RequestBatch(*[np.concatenate([np.asarray(c[f]) for c in cols])
                           for f in range(len(RequestBatch._fields))])
    state = shard_table(mesh, 1 << 8)
    _, outs, (over, ins) = make_sharded_step(mesh)(
        state, batch, jnp.asarray(NOW, jnp.int64))
    return [np.asarray(o).astype(np.int64) for o in outs], int(over), \
        int(ins)


def test_two_process_gloo_group_folds_and_steps_as_jax(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode())
    finally:
        for p in procs:
            p.kill()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][len("RESULT "):]))
    want, over, ins = _jax_reference()
    for r in results:
        assert (r["over"], r["ins"]) == (over, ins) == (0, 4 * B)
    for k, col in enumerate(want):
        got = np.concatenate([np.concatenate(r["cols"][k])
                              for r in results])
        assert (got == col).all(), k
