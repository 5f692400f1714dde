"""The port's scenario lab (gubernator_tpu_torch/scenarios.py and
cmd/scenario_lab.py) held to the JAX package's:

- data: every spec of the library round-trips through JSON, validates,
  and compiles (full and fast) to JAX's schedule request for request;
  the replay capture loads to JAX's waves; the spec errors, the digest,
  the judge tap and Jain's index equal JAX's;
- runs: every library spec in fast mode on the CPU through both
  packages.  Where the JAX lab replays a byte-identical decision stream
  (every spec but ``partition_reconcile``, whose degraded serves depend
  on when the ring ejects), the port's digest and counts equal JAX's
  and its parity oracle's reference.  ``partition_reconcile``: the
  oracles' verdicts equal JAX's but conservation's, which JAX now fails
  because its object-lane hits flush drops the callers' created_at and
  the virtual clock lies over a day behind the wall clock (ROADMAP
  §C.2); the port conserves;
- the runner's own contract on the port: replay determinism, the
  clock-skew twin, the scenario events and ``gubernator_scenario_runs``,
  the mesh stack's device list, and the lab's CLI.
"""
import copy
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout
from dataclasses import asdict
from pathlib import Path

import pytest

from gubernator_tpu import scenarios as jax_scn
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu.types import RateLimitResponse as JaxResp
from gubernator_tpu_torch import scenarios as scn
from gubernator_tpu_torch.cmd import scenario_lab
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse

ROOT = Path(__file__).resolve().parents[1]
LIB = ROOT / "scenarios"
SPECS = sorted(p.name for p in LIB.glob("*.json"))
NOT_BYTE_IDENTICAL = {"partition_reconcile.json"}


def raw(fn: str) -> dict:
    return json.loads((LIB / fn).read_text())


def rows_of(sched) -> list:
    return [[[tuple(asdict(r).values()) for r in c] for c in tick]
            for tick in sched]


@pytest.mark.parametrize("fn", SPECS)
def test_spec_round_trips_and_compiles_as_jax(fn):
    d = raw(fn)
    spec, ref = scn.ScenarioSpec.from_dict(copy.deepcopy(d)), \
        jax_scn.ScenarioSpec.from_dict(copy.deepcopy(d))
    assert spec.to_dict() == d == ref.to_dict()
    assert scn.ScenarioSpec.from_dict(
        json.loads(json.dumps(spec.to_dict()))) == spec
    for s, r in ((spec, ref), (spec.with_fast(), ref.with_fast())):
        assert s.to_dict() == r.to_dict()
        sched = scn.compile_schedule(s)
        assert len(sched) == s.ticks
        assert any(any(c) for c in sched)
        assert rows_of(sched) == rows_of(jax_scn.compile_schedule(r))


def test_library_covers_every_stack_and_source_kind():
    specs = scn.load_library()
    assert [s.name for s in specs] == \
        [s.name for s in jax_scn.load_library(str(LIB))]
    assert {s.stack for s in specs} == set(scn.STACKS) == \
        set(jax_scn.STACKS)
    assert scn.SOURCE_KINDS == jax_scn.SOURCE_KINDS
    assert scn.ORACLE_KINDS == jax_scn.ORACLE_KINDS
    assert (scn.NOW0, scn.SCENARIO_SCHEMA) == \
        (jax_scn.NOW0, jax_scn.SCENARIO_SCHEMA)


def test_library_directory_and_env_knobs(monkeypatch, tmp_path):
    assert Path(scn.default_scenario_dir()) == LIB
    (tmp_path / "one.json").write_text(json.dumps(raw(SPECS[0])))
    monkeypatch.setenv("GUBER_SCENARIO_DIR", str(tmp_path))
    assert [s.name for s in scn.load_library()] == \
        [scn.load_spec(str(LIB / SPECS[0])).name]
    monkeypatch.setenv("GUBER_SCENARIO_SEED", "12345")
    assert scn.ScenarioRunner(scn.load_library()[0]).spec.seed == 12345
    monkeypatch.setenv("GUBER_SCENARIO_FAST", "1")
    spec = scn.load_library()[0]
    assert scn.ScenarioRunner(spec).spec.ticks == spec.fast["ticks"]


def test_save_spec_writes_what_jax_writes(tmp_path):
    spec = scn.load_spec(str(LIB / SPECS[0]))
    scn.save_spec(spec, str(tmp_path / "p.json"))
    jax_scn.save_spec(jax_scn.load_spec(str(LIB / SPECS[0])),
                      str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_replay_capture_loads_as_jax():
    path = str(LIB / "captures" / "smoke_capture.jsonl")
    assert scn._load_capture(path) == jax_scn._load_capture(path)


@pytest.mark.parametrize("d", [
    {"name": "x", "bogus": 1}, {"name": "x", "stack": "warp"},
    {"name": "x", "sources": [{"kind": "nope"}]},
    {"name": "x", "oracles": ["vibes"]},
    {"name": "x", "clients": 3, "skew_ms": [1]},
    {"name": "x", "faults": [{"at_tick": 1}]},
    {"schema": 99, "name": "x"}], ids=str)
def test_spec_validation_rejects_as_jax(d):
    with pytest.raises(ValueError) as port:
        scn.ScenarioSpec.from_dict(dict(d))
    with pytest.raises(ValueError) as ref:
        jax_scn.ScenarioSpec.from_dict(dict(d))
    assert str(port.value) == str(ref.value)


def test_digest_judge_and_jain_as_jax():
    d, jd = scn.DecisionDigest(), jax_scn.DecisionDigest()
    for st, rem, err in ((0, 8, ""), (1, 0, ""), (0, 3, "x")):
        d.update(st, rem, err)
        jd.update(st, rem, err)
    d.update_lines(["0|1|\n", "1|0|\n"])
    jd.update_lines(["0|1|\n", "1|0|\n"])
    assert (d.hex(), d.rows) == (jd.hex(), jd.rows)

    def tap(mod, req, resp):
        j = mod.JudgeTap(delim="/")
        for b in range(3):
            reqs = [req(name=f"t{i % 3}/x", unique_key=f"k{i % 4}",
                        hits=i % 3, limit=10, duration=1000)
                    for i in range(b, b + 9)]
            resps = [resp(status=i % 2, limit=10, remaining=9 - i,
                          reset_time=1, error="e" if i == 4 else "")
                     for i in range(9)]
            j.observe(reqs, resps, 0)
        assert j.total == 0
        j.finalize()
        j.finalize()
        return (j.total, j.over_limit, j.admitted, j.attempted,
                j.tenants, j.errors, j.digest.hex(),
                sorted(j.templates))

    assert tap(scn, RateLimitRequest, RateLimitResponse) == \
        tap(jax_scn, JaxReq, JaxResp)
    for xs in ([5, 5, 5, 5], [100, 0, 0, 0], [97, 1, 1, 1], [], [3, 9]):
        assert scn.jain_index(xs) == jax_scn.jain_index(xs)


# ---- runs --------------------------------------------------------------


COUNTS = ("requests", "admitted_hits", "over_limit", "error_rows", "keys",
          "ticks", "seed", "stack", "name")


@pytest.mark.parametrize("fn", SPECS)
def test_library_runs_on_the_cpu_as_jax(fn):
    spec = scn.load_spec(str(LIB / fn))
    row = scn.ScenarioRunner(spec, fast=True, device="cpu").run(fast=True)
    ref = jax_scn.ScenarioRunner(jax_scn.load_spec(str(LIB / fn)),
                                 fast=True).run(fast=True)
    assert row["ok"], row
    assert row["device"] == "cpu" and row["errors"] == []
    assert set(row["oracles"]) == set(ref["oracles"]) == set(spec.oracles)
    if "parity" in row["oracles"]:
        assert row["oracles"]["parity"]["reference_digest"] == \
            row["decision_digest"]
    if spec.stack == "mesh":
        assert row["mesh_devices"] == ["cpu", "cpu"]
    if fn in NOT_BYTE_IDENTICAL:
        for name, o in ref["oracles"].items():
            if name != "conservation":
                assert row["oracles"][name]["ok"] == o["ok"], name
        assert row["oracles"]["fleet_audit"]["lost"] == \
            ref["oracles"]["fleet_audit"]["lost"] == 0
        return
    assert ref["ok"], ref
    assert row["decision_digest"] == ref["decision_digest"]
    assert {k: row[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    for name, o in ref["oracles"].items():
        assert row["oracles"][name]["ok"] == o["ok"], name
    if "jain_index" in ref:
        assert row["jain_index"] == ref["jain_index"]
    if "conservation" in row["oracles"]:
        assert row["oracles"]["conservation"]["keys"] == \
            ref["oracles"]["conservation"]["keys"]


def small(name="t", stack="object", **kw):
    kw.setdefault("seed", 9)
    kw.setdefault("ticks", 3)
    kw.setdefault("tick_ms", 250)
    kw.setdefault("clients", 2)
    kw.setdefault("sources", [
        {"kind": "zipf_drift", "name": "sm", "rows": 12, "n_keys": 10,
         "a0": 1.3, "a1": 1.8, "limit": 5000, "duration": 3_600_000}])
    kw.setdefault("oracles", ["parity", "conservation"])
    return scn.ScenarioSpec(name=name, stack=stack, **kw)


@pytest.mark.parametrize("stack", ["object", "wire", "tiered"])
def test_runs_replay_a_byte_identical_stream(stack):
    rows = [scn.ScenarioRunner(small(name="det", stack=stack),
                               device="cpu").run() for _ in range(2)]
    assert rows[0]["decision_digest"] == rows[1]["decision_digest"]
    assert rows[0]["ok"] and rows[1]["ok"]
    assert rows[0]["requests"] == rows[1]["requests"] > 0


def test_clock_skew_decisions_byte_identical_to_unskewed():
    def spec(skew):
        return scn.ScenarioSpec(
            name="skewpin", stack="clustered", seed=77, ticks=3,
            tick_ms=1000, clients=3, daemons=3, skew_ms=skew,
            sources=[{"kind": "zipf_drift", "name": "skw", "rows": 10,
                      "n_keys": 12, "a0": 1.4, "a1": 1.4, "limit": 5000,
                      "duration": 86_400_000}], oracles=[])

    skewed = scn.ScenarioRunner(spec([-5000, 0, 5000]), device="cpu").run()
    plain = scn.ScenarioRunner(spec([]), device="cpu").run()
    assert skewed["requests"] == plain["requests"] > 0
    assert skewed["error_rows"] == plain["error_rows"] == 0
    assert skewed["decision_digest"] == plain["decision_digest"]


def test_fairness_oracle_exact_ledger_conservation():
    spec = small(
        name="fair", ticks=4,
        sources=[{"kind": "tenant_mix", "name": "api", "rows": 40,
                  "limit": 100_000, "duration": 3_600_000,
                  "tenants": [
                      {"tenant": "abuser", "weight": 9, "n_keys": 4},
                      {"tenant": "meek", "weight": 1, "n_keys": 4}]}],
        oracles=["fairness"], expect={"jain_min": 0.1, "jain_max": 0.9})
    row = scn.ScenarioRunner(spec, device="cpu").run()
    fair = row["oracles"]["fairness"]
    assert fair["ok"] and fair["ledger_conserved"] is True
    assert fair["ledger_mismatches"] == [] and row["ok"]


class Keeping(scn.ScenarioRunner):
    """Keeps the stack it built, to read its instances after the run."""

    def _build(self):
        self.handle = super()._build()
        return self.handle


def test_scenario_events_and_runs_metric():
    r = Keeping(small(name="ev", oracles=[]), device="cpu")
    row = r.run()
    inst = r.handle.instances[0]
    started = inst.recorder.events(kind="scenario_started")
    finished = inst.recorder.events(kind="scenario_finished")
    assert [e["name"] for e in started] == ["ev"]
    assert finished[0]["ok"] is True and \
        finished[0]["digest"] == row["decision_digest"][:16]
    reg = inst.metrics.registry
    assert reg.get_sample_value("gubernator_scenario_runs_total",
                                {"verdict": "ok"}) == 1
    assert reg.get_sample_value("gubernator_scenario_runs_total",
                                {"verdict": "failed"}) in (None, 0)


def test_a_failed_oracle_counts_a_failed_run():
    spec = small(name="bad", oracles=["fairness"],
                 expect={"jain_min": 0.999, "jain_max": 1.0},
                 sources=[{"kind": "tenant_mix", "name": "api",
                           "rows": 40, "tenants": [
                               {"tenant": "a", "weight": 9, "n_keys": 2},
                               {"tenant": "b", "weight": 1,
                                "n_keys": 2}]}])
    r = Keeping(spec, device="cpu")
    assert not r.run()["ok"]
    assert r.handle.instances[0].metrics.registry.get_sample_value(
        "gubernator_scenario_runs_total", {"verdict": "failed"}) == 1


def test_parity_reference_lane_is_the_oracle_on_the_host(monkeypatch):
    built = []
    real = scn.ScenarioRunner._solo

    def solo(self, **kw):
        inst = real(self, **kw)
        built.append((self.device, type(inst.engine).__name__))
        return inst

    monkeypatch.setattr(scn.ScenarioRunner, "_solo", solo)
    row = scn.ScenarioRunner(small(name="par"), device="cpu").run()
    assert row["oracles"]["parity"]["ok"]
    assert built == [("cpu", "BucketEngine"), ("cpu", "OracleEngine")]


def test_unknown_fault_address_needs_a_cluster():
    r = scn.ScenarioRunner(small(faults=[{"at_tick": 1,
                                          "arm": "peer_send@{addr:1}:error"}]),
                           device="cpu")
    with pytest.raises(ValueError, match="clustered stack"):
        r.run()


# ---- the lab's CLI -------------------------------------------------------


def run_lab(module, argv) -> tuple:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


def jax_lab():
    spec = importlib.util.spec_from_file_location(
        "jax_scenario_lab", ROOT / "tools" / "scenario_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lab_lists_as_the_jax_lab():
    assert run_lab(scenario_lab, ["--list"]) == \
        run_lab(jax_lab(), ["--list"])
    assert run_lab(scenario_lab, ["--only", "nope"])[0] == \
        run_lab(jax_lab(), ["--only", "nope"])[0] == 2


def test_lab_runs_a_spec_and_writes_its_verdict(tmp_path):
    out = tmp_path / "v.json"
    rc, text = run_lab(scenario_lab, [
        "--only", "baseline_zipf_drift", "--only", "mesh_global", "--fast",
        "--device", "cpu", "--json", str(out)])
    assert rc == 0, text
    doc = json.loads(out.read_text())
    assert doc["all_ok"] and doc["count"] == 2
    assert doc["scenarios"]["mesh_global"]["mesh_devices"] == ["cpu", "cpu"]
    assert "mesh=cpu,cpu" in text and "all_ok=True" in text


def test_lab_exits_1_when_an_oracle_fails(tmp_path):
    spec = small(name="unfair", oracles=["fairness"],
                 expect={"jain_min": 0.999, "jain_max": 1.0},
                 sources=[{"kind": "tenant_mix", "name": "api",
                           "rows": 40, "tenants": [
                               {"tenant": "a", "weight": 9, "n_keys": 2},
                               {"tenant": "b", "weight": 1,
                                "n_keys": 2}]}])
    scn.save_spec(spec, str(tmp_path / "unfair.json"))
    rc, text = run_lab(scenario_lab, ["--dir", str(tmp_path), "--device",
                                      "cpu"])
    assert rc == 1 and "FAIL" in text
    assert os.path.exists(tmp_path / "unfair.json")
