"""Whole runs of the harness on the CPU at a tiny size: a sound run is
correct, and the control and each fault planted under the timed path
come out not correct.  The run on the card is marked ``gpu``."""
import json
import os
import subprocess
import sys

import pytest

import portbench.run as run
from gubernator_tpu_torch.proto import gubernator_pb2 as pb

CELL = "solo-10m.zipf-closed"
ARGS = ["--workload", CELL, "--seconds", "3", "--trace", "0", "--rehearse"]


def result(capsys, seed, plant=None, extra=()):
    assert run.main(ARGS + ["--seed", str(seed), *extra], plant=plant) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def wrap(dep, rewrite):
    """Break the served path: every GetRateLimits through the daemon's
    wire entry (in-process and over gRPC) goes through ``rewrite``."""
    inst = dep.d.instance
    entry = inst.get_rate_limits_wire
    inst.get_rate_limits_wire = lambda data, *a, **k: rewrite(entry, data)


def state_unchanged(dep):
    def rewrite(entry, data):
        req = pb.GetRateLimitsReq.FromString(data)
        for r in req.requests:
            r.hits = 0
        return entry(req.SerializeToString())
    wrap(dep, rewrite)


def half_left_out(dep):
    def rewrite(entry, data):
        req = pb.GetRateLimitsReq.FromString(data)
        keep = pb.GetRateLimitsReq(
            requests=req.requests[:len(req.requests) // 2])
        return entry(keep.SerializeToString())
    wrap(dep, rewrite)


def answer_altered(dep):
    def rewrite(entry, data):
        resp = pb.GetRateLimitsResp.FromString(entry(data))
        resp.responses[len(resp.responses) // 2].remaining += 1
        return resp.SerializeToString()
    wrap(dep, rewrite)


def test_a_sound_run_is_correct(capsys):
    out = result(capsys, 2 ** 31 + 11)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_the_control_is_not_correct(capsys):
    out = result(capsys, 2 ** 31 + 12, extra=["--control"])
    assert out["correct"] is False
    assert out["checks"]["wrong_remaining"]["value"] > 0


@pytest.mark.parametrize("fault,check", [
    (state_unchanged, "wrong_remaining"),
    (half_left_out, "calls_short"),
    (answer_altered, "wrong_remaining")])
def test_a_broken_path_is_not_correct(capsys, fault, check):
    out = result(capsys, 2 ** 31 + 13, plant=fault)
    assert out["correct"] is False
    assert out["checks"][check]["value"] > 0


def test_no_jax_in_the_harness_or_the_reference():
    # every module of the harness, and the program it drives, imported
    code = (
        "import sys, glob, os, importlib;"
        "import portbench.run as run, gubernator_tpu_torch.daemon;"
        "[importlib.import_module('portbench.' + p[:-3].replace('/', '.'))"
        " for d in ('lib', 'gen') for p in sorted(os.listdir("
        "'portbench/' + d)) if p.endswith('.py') and not p.startswith('_')"
        " for p in [d + '/' + p]];"
        "[run.reader(os.path.basename(p)[:-3])"
        " for p in glob.glob('portbench/metrics/*.py')];"
        "top = {m.split('.')[0] for m in sys.modules};"
        "bad = top & {'jax', 'jaxlib', 'flax', 'gubernator_tpu'};"
        "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=run.ROOT, timeout=120)
    # the reference alone loads NumPy and nothing of the program
    code = ("import sys, portbench.lib.ref;"
            "top = {m.split('.')[0] for m in sys.modules};"
            "bad = top & {'jax', 'gubernator_tpu', 'gubernator_tpu_torch',"
            " 'torch'};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=run.ROOT, timeout=120)


def test_a_rehearsal_holds_no_jax_when_it_prints(capsys):
    # run.main refuses (exit 4) to print a result while the process
    # holds any of these, compared by whole top-level name
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "gubernator_tpu")
    out = result(capsys, 2 ** 31 + 14)
    assert out["correct"] is True


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, os.path.join(run.ROOT, "portbench", "run.py"),
         "--workload", CELL, "--seed", str(2 ** 31 + 15), "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def _imports(path):
    import ast

    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    import glob

    return sorted(glob.glob(os.path.join(run.ROOT, "portbench", "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, run.ROOT))
def test_source_imports_no_jax(path):
    banned = {"jax", "jaxlib", "flax", "gubernator_tpu"}
    if path.endswith(os.path.join("lib", "ref.py")):
        banned |= {"gubernator_tpu_torch", "torch"}
    for name in _imports(path):
        assert name.split(".")[0] not in banned, (path, name)
