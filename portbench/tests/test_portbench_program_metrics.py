"""The readers of the program's step spans and counters, on /metrics
scrapes made by hand: per-wave means of the wave's host steps, per-call
means of ingest and build, the serving threads' CPU shares, the
collector's pauses and K1's roofline from its counters; and nothing
read from a program that exports none of them."""
import pytest

import portbench.run as run
from portbench.lib import prom
from portbench.lib.readers import Run

BEFORE = """
gubernator_dispatcher_wave_size_count 100.0
gubernator_phase_duration_count{phase="pack"} 100.0
gubernator_phase_duration_sum{phase="pack"} 1.0
gubernator_phase_duration_sum{phase="wave.fill"} 0.10
gubernator_phase_duration_sum{phase="wave.upload"} 0.05
gubernator_phase_duration_sum{phase="wave.plan"} 0.20
gubernator_phase_duration_sum{phase="wave.download"} 0.05
gubernator_phase_duration_count{phase="ingest"} 400.0
gubernator_phase_duration_sum{phase="ingest"} 0.4
gubernator_phase_duration_count{phase="build"} 400.0
gubernator_phase_duration_sum{phase="build"} 0.2
gubernator_phase_cpu_seconds_total{phase="wave.fill"} 0.08
gubernator_phase_cpu_seconds_total{phase="wave.plan"} 0.10
gubernator_phase_cpu_seconds_total{phase="ingest"} 0.3
gubernator_thread_cpu_seconds_total{thread="dispatcher"} 10.0
gubernator_thread_cpu_seconds_total{thread="analytics"} 2.0
gubernator_thread_cpu_seconds_total{thread="other"} 30.0
gubernator_gc_pause_seconds_sum{generation="0"} 0.5
gubernator_gc_pause_seconds_sum{generation="2"} 1.0
gubernator_k1_launches_total 100.0
gubernator_k1_rows_total 400000.0
gubernator_k1_segments_total 200000.0
"""
# the window: 50 waves, 200 calls, 10 s
AFTER = """
gubernator_dispatcher_wave_size_count 150.0
gubernator_phase_duration_count{phase="pack"} 150.0
gubernator_phase_duration_sum{phase="pack"} 9.0
gubernator_phase_duration_sum{phase="wave.fill"} 0.20
gubernator_phase_duration_sum{phase="wave.upload"} 0.10
gubernator_phase_duration_sum{phase="wave.plan"} 0.30
gubernator_phase_duration_sum{phase="wave.launch"} 0.05
gubernator_phase_duration_sum{phase="wave.download"} 0.15
gubernator_phase_duration_count{phase="ingest"} 600.0
gubernator_phase_duration_sum{phase="ingest"} 0.6
gubernator_phase_duration_count{phase="build"} 600.0
gubernator_phase_duration_sum{phase="build"} 0.3
gubernator_phase_cpu_seconds_total{phase="wave.fill"} 0.13
gubernator_phase_cpu_seconds_total{phase="wave.plan"} 0.15
gubernator_phase_cpu_seconds_total{phase="ingest"} 0.5
gubernator_thread_cpu_seconds_total{thread="dispatcher"} 17.5
gubernator_thread_cpu_seconds_total{thread="analytics"} 3.0
gubernator_thread_cpu_seconds_total{thread="other"} 50.0
gubernator_gc_pause_seconds_sum{generation="0"} 0.55
gubernator_gc_pause_seconds_sum{generation="2"} 1.05
gubernator_k1_launches_total 150.0
gubernator_k1_rows_total 600000.0
gubernator_k1_segments_total 300000.0
"""
#: what the parent's program exports of the same families
OLD = """
gubernator_dispatcher_wave_size_count 150.0
gubernator_phase_duration_count{phase="pack"} 150.0
gubernator_phase_duration_sum{phase="pack"} 9.0
"""


def _run(before, after, trace=None):
    return Run(window=(0.0, 10.0), setup_s=0.0, calls={},
               scrapes=[(prom.parse(before), prom.parse(after))],
               trace=trace)


def _k1_trace(s, launches):
    return {"kernels": {"decide_kernel_int_long": {"s": s,
                                                   "launches": launches}},
            "busy_s": 1.0, "window_s": 10.0}


@pytest.mark.parametrize("metric, want", [
    # wave.*: (0.1 + 0.05 + 0.1 + 0.05 + 0.1) s over 50 waves
    ("wave_host_ms_mean.closed", 8.0),
    ("wave_cpu_ms_mean.closed", 2.0),     # (0.05 + 0.05) s / 50
    ("plan_ms_mean.closed", 2.0),         # 0.1 s / 50
    ("copy_ms_mean.closed", 3.0),         # (0.05 + 0.1) s / 50
    ("ingest_ms_mean.closed", 1.0),       # 0.2 s / 200 calls
    ("build_ms_mean.closed", 0.5),
    ("worker_cpu_pct.closed", 75.0),      # 7.5 s of 10
    ("analytics_cpu_pct.closed", 10.0),
    ("gc_pause_ms_per_s.closed", 10.0),   # 0.1 s over 10 s
])
def test_program_readers_on_fixture_scrapes(metric, want):
    assert run.reader(metric).read(_run(BEFORE, AFTER)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "wave_host_ms_mean.closed", "wave_cpu_ms_mean.closed",
    "plan_ms_mean.closed", "copy_ms_mean.closed", "ingest_ms_mean.closed",
    "build_ms_mean.closed", "worker_cpu_pct.closed",
    "analytics_cpu_pct.closed", "gc_pause_ms_per_s.closed",
    "k1_roofline_counted.closed"])
def test_an_older_program_gives_nothing_to_read(metric):
    got = run.reader(metric).read(_run(OLD, OLD, _k1_trace(0.5, 40)))
    assert got is None


def test_k1_roofline_from_the_counters():
    k1 = run.reader("k1_roofline_counted.closed")
    # 4000 rows and 2000 segments a launch: 2,468,000 B; 40 launches in
    # the trace over 0.5 s of K1's device time
    want = 100.0 * 2_468_000 * 40 / 3.35e12 / 0.5
    assert k1.read(_run(BEFORE, AFTER, _k1_trace(0.5, 40))) == \
        pytest.approx(want)
    assert k1.read(_run(BEFORE, AFTER)) is None        # no trace
    assert k1.read(_run(BEFORE, BEFORE, _k1_trace(0.5, 40))) is None


def test_program_metrics_are_declared():
    """Each reader has its BENCHMARK.json entry, for the one cell."""
    names = {"wave_host_ms_mean.closed", "wave_cpu_ms_mean.closed",
             "plan_ms_mean.closed", "copy_ms_mean.closed",
             "ingest_ms_mean.closed", "build_ms_mean.closed",
             "worker_cpu_pct.closed", "analytics_cpu_pct.closed",
             "gc_pause_ms_per_s.closed", "k1_roofline_counted.closed"}
    *_, per_layer = run.load_cell("solo-10m.zipf-closed")
    got = {m["name"]: m for m in per_layer}
    assert names <= set(got)
    for n in names:
        assert got[n]["moves"] == "decisions_per_s"
        assert got[n]["workloads"] == ["solo-10m.zipf-closed"]
