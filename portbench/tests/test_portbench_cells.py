"""A cell, a configuration, a traffic mix and a metric are files of
their own that the harness finds by name."""
import json
import os

import portbench.run as run

REPO = run.ROOT


def test_every_name_in_the_benchmark_has_its_file():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell, cfg, traffic, e2e, per_layer = run.load_cell(w["name"])
        assert os.path.exists(os.path.join(
            REPO, "portbench", "gen", traffic["generator"] + ".py"))
        assert {m["name"] for m in e2e} >= {"setup_s"}
        assert per_layer
        for m in e2e + per_layer:
            assert callable(run.reader(m["name"]).read)


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    for d in ("configs", "traffic", "metrics"):
        (tmp_path / "portbench" / d).mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps({"name": "t", "keys": 5}))
    (tmp_path / "portbench" / "traffic" / "burst.json").write_text(
        json.dumps({"generator": "closed", "outstanding": 2}))
    (tmp_path / "portbench" / "metrics" / "new_metric.later.py").write_text(
        "def read(run):\n    return 42.0\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
        "workloads": [{"name": "tiny.burst", "config": "tiny",
                       "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "setup_s"},
                       {"name": "other", "workloads": ["x.y"]}],
        "per_layer": [{"name": "new_metric.later",
                       "workloads": ["tiny.burst"]}]}))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    cell, cfg, traffic, e2e, per_layer = run.load_cell("tiny.burst")
    assert cfg == {"name": "t", "keys": 5}
    assert traffic["outstanding"] == 2
    assert [m["name"] for m in e2e] == ["setup_s"]
    assert run.reader(per_layer[0]["name"]).read(None) == 42.0
