"""The /metrics readers: parse, deltas over the window, histogram means."""
from portbench.lib import prom
from portbench.lib.readers import Run, hist_ms

BEFORE = """# HELP gubernator_func_duration handler durations (s)
gubernator_func_duration_count{name="grpc.GetRateLimits"} 10.0
gubernator_func_duration_sum{name="grpc.GetRateLimits"} 0.5
gubernator_func_duration_count{name="http.GetRateLimits"} 3.0
gubernator_func_duration_sum{name="http.GetRateLimits"} 9.0
gubernator_dispatcher_wave_size_count 4.0
gubernator_dispatcher_wave_size_sum 4000.0
"""
AFTER = """gubernator_func_duration_count{name="grpc.GetRateLimits"} 30.0
gubernator_func_duration_sum{name="grpc.GetRateLimits"} 1.5
gubernator_func_duration_count{name="http.GetRateLimits"} 3.0
gubernator_func_duration_sum{name="http.GetRateLimits"} 9.0
gubernator_dispatcher_wave_size_count 6.0
gubernator_dispatcher_wave_size_sum 10000.0
gubernator_batch_send_duration_count{peer_addr="a:1"} 2.0
gubernator_batch_send_duration_sum{peer_addr="a:1"} 0.01
"""


def test_parse_and_delta():
    b, a = prom.parse(BEFORE), prom.parse(AFTER)
    assert b[("gubernator_func_duration_count",
              (("name", "grpc.GetRateLimits"),))] == 10.0
    assert prom.delta(b, a, "gubernator_func_duration_count") == 20.0
    assert prom.delta(b, a, "gubernator_func_duration_count",
                      name="http.GetRateLimits") == 0.0


def test_histogram_means_over_every_process():
    one = (prom.parse(BEFORE), prom.parse(AFTER))
    run = Run(window=(0.0, 1.0), setup_s=0.0, calls={}, scrapes=[one, one])
    assert hist_ms(run, "gubernator_func_duration",
                   name="grpc.GetRateLimits") == 50.0
    assert prom.hist_mean(run.scrapes,
                          "gubernator_dispatcher_wave_size") == 3000.0
    # a series that only appears after the window counts from 0
    assert hist_ms(run, "gubernator_batch_send_duration") == 5.0
    # nothing observed: no value, not 0
    assert hist_ms(run, "gubernator_dispatcher_queue_wait") is None
