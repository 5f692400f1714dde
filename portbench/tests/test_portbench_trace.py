"""The device trace's reduction, on raw events made by hand."""
from types import SimpleNamespace

from torch.autograd import DeviceType

import portbench.run as run
from portbench.lib import trace
from portbench.lib.readers import Run

MS = 1_000_000  # ns


def ev(name, dev, t0_ms, t1_ms, annotation=False, tid=1, shapes=()):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(t0_ms * MS),
        duration_ns=lambda: int((t1_ms - t0_ms) * MS),
        device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU,
        is_user_annotation=lambda: annotation,
        is_hidden_event=lambda: False, start_thread_id=lambda: tid,
        shapes=lambda: [list(s) for s in shapes])


def prof_of(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_is_the_union_inside_the_window():
    got = trace.reduce(prof_of([
        ev(trace.WINDOW_MARK, False, 10, 110),
        ev(trace.WINDOW_MARK, True, 10, 110, annotation=True),
        ev("ProfilerStep#1", False, 9, 111),   # no label for a gap
        ev("decide_kernel", True, 5, 20),      # clipped to 10..20
        ev("sort", True, 15, 30),              # overlaps: union 10..30
        ev("decide_kernel", True, 60, 70),
        ev("memcpy", True, 105, 120),          # clipped to 105..110
        ev("cudaMemcpyAsync", False, 31, 59),  # the host in the long gap
        ev("cudaLaunchKernel", False, 71, 72)]))
    assert abs(got["window_s"] - 0.100) < 1e-12
    assert abs(got["busy_s"] - 0.035) < 1e-12
    assert abs(got["kernels"]["decide_kernel"]["s"] - 0.020) < 1e-12
    assert got["kernels"]["decide_kernel"]["launches"] == 2
    gaps = got["breakdown"]["idle_gaps"]
    # longest first: 70..105 ms, then 30..60 ms
    assert [g[0] for g in gaps] == ["cudaLaunchKernel", "cudaMemcpyAsync"]
    assert abs(gaps[0][1] - 0.035) < 1e-12 and abs(gaps[1][1] - 0.030) < 1e-12
    assert got["breakdown"]["device_ops"][0][0] == "decide_kernel"


def test_nothing_to_read_gives_nothing():
    assert trace.reduce(prof_of([ev("decide_kernel", True, 0, 1)])) is None
    assert trace.reduce(prof_of([ev(trace.WINDOW_MARK, False, 0, 1)])) is None


def test_k1_bytes_come_from_each_wave_s_plan():
    k1 = run.reader("k1_roofline.closed")
    U, C = k1.UNIQUE, k1.CUMSUM
    events = [
        ev(trace.WINDOW_MARK, False, 10, 110),
        ev(U, False, 5, 6, shapes=[[999], []]),        # before the window
        ev(C, False, 7, 8, shapes=[[500], []]),
        # wave 1 on thread 1: a cumsum inside the unique call is not its own
        ev(U, False, 20, 24, shapes=[[4000], [], [], []]),
        ev(C, False, 21, 22, shapes=[[7], []]),
        ev(C, False, 25, 26, shapes=[[2771], []]),
        ev("decide_kernel", True, 27, 30),
        # wave 2 on thread 2, while thread 1 runs a cumsum of its own
        ev(U, False, 40, 41, tid=2, shapes=[[3000], []]),
        ev(C, False, 41.5, 42, tid=1, shapes=[[11], []]),
        ev(C, False, 43, 44, tid=2, shapes=[[2000], []]),
        ev("decide_kernel", True, 45, 48)]
    got = trace.reduce(prof_of(events), k1.HOST_OPS)
    rows, buckets = k1.waves(got["host_ops"])
    assert rows.tolist() == [4000, 3000] and buckets.tolist() == [2771, 2000]
    r = Run(window=(0.0, 0.1), setup_s=1.0, calls={}, trace=got)
    need = (2771 + 2000) * k1.BUCKET_BYTES + 7000 * k1.REQ_BYTES
    want = 100.0 * need / 3.35e12 / 0.006
    assert abs(k1.read(r) - want) < 1e-9 * want
    # a plan with no launch, or a launch with no plan: nothing to read
    got = trace.reduce(prof_of(events[:-1] + [
        ev(U, False, 60, 61, shapes=[[10], []]),
        ev(C, False, 62, 63, shapes=[[3], []]),
        ev(U, False, 70, 71, shapes=[[10], []]),
        ev(C, False, 72, 73, shapes=[[3], []])]), k1.HOST_OPS)
    assert k1.read(Run(window=(0.0, 0.1), setup_s=1.0, calls={},
                       trace=got)) is None
