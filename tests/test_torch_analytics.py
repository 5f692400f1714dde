"""The port's heavy-hitter analytics (analytics.py) on the CPU against
the JAX package's: the Space-Saving sketch bit for bit on seeded Zipf
streams wider than its width (counts, error bounds, over-limit tallies,
top-K, merges), in Python and with its fold in C++, KeyAnalytics' /debug/topkeys and /debug/phases
documents after ``flush()``, dropped taps with a tiny queue, the device
tap on the CPU, and the daemon's endpoints.  The tolerance is zero."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import analytics
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse

NOW = 1_765_000_000_000


def zipf_waves(seed: int, n_keys: int, waves: int, size: int,
               weighted: bool):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2 ** 64 - 1, n_keys, dtype=np.uint64)
    out = []
    for w in range(waves):
        ranks = np.minimum(rng.zipf(1.1, size), n_keys) - 1
        hits = (rng.integers(0, 6, size) if weighted
                else np.ones(size, np.int64))
        over = rng.random(size) < 0.1
        out.append((keys[ranks], hits, over, NOW + w))
    return out


def both_sketches(k, width):
    from gubernator_tpu import analytics as jax_analytics

    return (analytics.HeavyHitterSketch(k=k, width=width),
            jax_analytics.HeavyHitterSketch(k=k, width=width))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_equals_jax_bit_for_bit(seed, weighted):
    """Streams over 20x the sketch's width: exact sequential Space-Saving
    admission on both sides, the same state after every wave."""
    ps, js = both_sketches(k=32, width=128)
    for kh, hits, over, t in zipf_waves(seed, 2560, 12, 1000, weighted):
        ps.update(kh, hits, over, t)
        js.update(kh, hits, over, t)
        assert ps.canonical_bytes() == js.canonical_bytes()
    assert ps.topk() == js.topk()
    assert ps.error_bound() == js.error_bound() > 0
    for kh in zipf_waves(seed, 2560, 1, 50, False)[0][0].tolist():
        assert ps.count_of(kh) == js.count_of(kh)


def test_sketch_names_and_merge_equal_jax():
    ps, js = both_sketches(k=8, width=32)
    for kh, hits, over, t in zipf_waves(5, 300, 4, 200, True):
        names = [f"n_{int(k) % 97}" for k in kh]
        ps.update(kh, hits, over, t, names=names)
        js.update(kh, hits, over, t, names=names)
    assert ps.topk() == js.topk()
    remote = zipf_waves(6, 300, 1, 300, True)[0]
    other, _ = both_sketches(k=8, width=32)
    other.update(*remote)
    entries = other.topk(32)
    ps.merge_entries(entries, other.total_weight)
    js.merge_entries(entries, other.total_weight)
    assert ps.canonical_bytes() == js.canonical_bytes()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [128, 1024])
def test_native_sketch_equals_jax_after_every_fold(seed, weighted, width):
    """The C++ fold (csrc/sketch.cpp) on streams over 20x the width:
    after every wave its state is byte-equal to the JAX sketch's and to
    the port's Python fold (its plain version), last-seen times and
    names included; count_of reads alike."""
    from gubernator_tpu import analytics as jax_analytics

    native = analytics.NativeHeavyHitterSketch(k=32, width=width)
    plain = analytics.HeavyHitterSketch(k=32, width=width)
    ref = jax_analytics.HeavyHitterSketch(k=32, width=width)
    waves = zipf_waves(seed, 20 * width, 12, 1000, weighted)
    for i, (kh, hits, over, t) in enumerate(waves):
        names = ([f"n_{int(k) % 997}" for k in kh] if i % 3 == 0
                 else None)
        for sk in (native, plain, ref):
            sk.update(kh, hits, over, t, names=names)
        assert native.canonical_bytes() == ref.canonical_bytes() == \
            plain.canonical_bytes()
        u = native._used
        for col in ("_kh", "_cnt", "_err", "_over", "_last"):
            assert np.array_equal(getattr(native, col)[:u],
                                  getattr(plain, col)[:u]), col
        assert native._names == plain._names == ref._names
    assert native.topk() == ref.topk()
    assert native.error_bound() == ref.error_bound() > 0
    for kh in waves[-1][0][:100].tolist():
        assert native.count_of(kh) == ref.count_of(kh)


def test_native_sketch_is_the_default_and_merges_as_jax():
    """KeyAnalytics folds with the native sketch; a merge (Python, on the
    same columns) after native folds still equals JAX's."""
    from gubernator_tpu import analytics as jax_analytics

    ka = analytics.KeyAnalytics()
    try:
        assert type(ka.sketch) is analytics.NativeHeavyHitterSketch
    finally:
        ka.close()
    ps = analytics.NativeHeavyHitterSketch(k=8, width=32)
    js = jax_analytics.HeavyHitterSketch(k=8, width=32)
    for kh, hits, over, t in zipf_waves(5, 300, 4, 200, True):
        ps.update(kh, hits, over, t)
        js.update(kh, hits, over, t)
    other = analytics.HeavyHitterSketch(k=8, width=32)
    other.update(*zipf_waves(6, 300, 1, 300, True)[0])
    entries = other.topk(32)
    ps.merge_entries(entries, other.total_weight)
    js.merge_entries(entries, other.total_weight)
    for kh, hits, over, t in zipf_waves(7, 300, 2, 200, False):
        ps.update(kh, hits, over, t)
        js.update(kh, hits, over, t)
    assert ps.canonical_bytes() == js.canonical_bytes()


def test_native_sketch_without_the_host_library_raises(monkeypatch,
                                                        tmp_path):
    """No compiler, no library: the native sketch raises; it does not
    fold in Python instead."""
    from gubernator_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_wire_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        analytics.NativeHeavyHitterSketch(k=8, width=32)


def both_analytics(**kw):
    from gubernator_tpu import analytics as jax_analytics

    clock = lambda: NOW / 1000  # noqa: E731 - a fixed wall clock
    return (analytics.KeyAnalytics(clock=clock, **kw),
            jax_analytics.KeyAnalytics(clock=clock, **kw))


def named_tap(reqs, over, splits=(), table_full=()):
    """An object-lane wave as the dispatcher taps it: the key hashes, the
    packed batch, result columns with ``over`` rows OVER_LIMIT (and
    ``table_full`` rows table-full), and the request lists cut at
    ``splits``."""
    from gubernator_tpu_torch.core.batch import pack_requests
    from gubernator_tpu_torch.hashing import hash_request_keys

    kh = hash_request_keys([r.name for r in reqs],
                           [r.unique_key for r in reqs])
    batch, _ = pack_requests(reqs, NOW, size=len(reqs), key_hashes=kh)
    n = len(reqs)
    full = np.zeros(n, bool)
    full[list(table_full)] = True
    status = np.where(np.asarray(over, bool) & ~full, 1, 0).astype(np.int32)
    cols = (status, np.zeros(n, np.int64), np.zeros(n, np.int64),
            np.zeros(n, np.int64), full)
    cuts = [0, *splits, n]
    lists = [list(reqs[a:b]) for a, b in zip(cuts, cuts[1:])]
    return kh, batch, cols, lists


@pytest.mark.parametrize("seed", range(3))
def test_columnar_tap_sketch_equals_jax_after_every_fold(seed):
    """The object-lane tap as columns (tap_named) against the JAX list
    tap (tap_reqs) on the same waves: byte-equal sketches and equal
    names after every fold, with evictions (a narrow sketch), hits of
    0, negative hits, hits past the leaky clamp, invalid Gregorian rows
    and table-full rows."""
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu.types import RateLimitResponse as JaxResp

    rng = np.random.default_rng(seed)
    pa, ja = both_analytics(k=8, width=32)
    try:
        for w in range(12):
            n = int(rng.integers(5, 120))
            reqs, resps, full = [], [], []
            for i in range(n):
                kid = int(rng.zipf(1.2)) % 90
                hits = int(rng.choice([0, 1, 1, 2, 7, -3, 1 << 40]))
                greg = rng.random() < 0.05
                r = dict(name=f"t{kid % 3}", unique_key=f"u{kid}",
                         hits=hits, limit=100, algorithm=kid % 2,
                         duration=99 if greg else 60_000 * (1 + kid),
                         behavior=4 if greg else 0)
                reqs.append(r)
                over = bool(rng.random() < 0.2)
                if not greg and rng.random() < 0.05:
                    full.append(i)
                    resps.append(JaxResp(error="rate limit table full"))
                elif greg:
                    resps.append(JaxResp(error="invalid gregorian"))
                else:
                    resps.append(JaxResp(status=int(over)))
            over = [int(x.status) == 1 for x in resps]
            cuts = sorted(set(rng.integers(1, n, 2).tolist()))
            pa.tap_named(*named_tap([RateLimitRequest(**r) for r in reqs],
                                    over, cuts, full))
            ja.tap_reqs([JaxReq(**r) for r in reqs], resps)
            assert pa.flush() and ja.flush()
            assert pa.sketch.canonical_bytes() == ja.sketch.canonical_bytes()
            assert pa.sketch._names == ja.sketch._names
            assert pa.stats() == ja.stats()
    finally:
        pa.close()
        ja.close()


def test_topkeys_and_phases_snapshots_equal_jax():
    """The same taps (columnar and object-lane) into both: equal
    /debug/topkeys and /debug/phases documents after flush()."""
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu.types import RateLimitResponse as JaxResp

    reqs = [dict(name="o", unique_key=f"u{j % 30}", hits=j % 4)
            for j in range(50)]
    resps = [j % 5 == 0 for j in range(50)]
    # built before the taps: each package's worker drains what its
    # queue holds, so the taps go in back to back, as before
    port_named = named_tap([RateLimitRequest(**r) for r in reqs], resps)
    jax_named = ([JaxReq(**r) for r in reqs],
                 [JaxResp(status=int(o)) for o in resps])
    pa, ja = both_analytics(k=16, width=64)
    try:
        for i, (kh, hits, over, _) in enumerate(
                zipf_waves(9, 500, 6, 400, False)):
            status = over.astype(np.int32)
            pa.tap_packed(kh, hits, status)
            ja.tap_packed(kh, hits, status)
            if i % 2:
                pa.tap_named(*port_named)
                ja.tap_reqs(*jax_named)
            for phase, secs in (("pack", 0.001 * i), ("device", 0.002),
                                ("restore", 0.5)):
                pa.observe_phase(phase, secs)
                ja.observe_phase(phase, secs)
        assert pa.flush() and ja.flush()
        got, want = pa.topkeys_snapshot(), ja.topkeys_snapshot()
        assert got == want and got["keys"]
        assert any(e["key"] for e in got["keys"])  # names learned
        assert pa.topkeys_snapshot(5) == ja.topkeys_snapshot(5)
        assert pa.phases_snapshot() == ja.phases_snapshot()
        assert pa.rank_distribution(20) == ja.rank_distribution(20)
        assert pa.stats() == ja.stats()
    finally:
        pa.close()
        ja.close()


def test_full_queue_drops_taps_as_jax(monkeypatch):
    """A tap on a full queue is dropped and counted, never waited for:
    the same counts in both packages."""
    from gubernator_tpu import analytics as jax_analytics
    from gubernator_tpu_torch.metrics import Metrics

    for mod in (analytics, jax_analytics):
        monkeypatch.setattr(mod.KeyAnalytics, "BATCH_INTERVAL_S", 1.0)
    m = Metrics()
    pa = analytics.KeyAnalytics(metrics=m, queue_cap=2)
    ja = jax_analytics.KeyAnalytics(queue_cap=2)
    try:
        kh = np.arange(1, 11, dtype=np.uint64)
        out = []
        for a in (pa, ja):
            a.flush()  # the worker rests now: the taps below queue up
            out.append([a.tap_packed(kh, np.ones(10), np.zeros(10))
                        for _ in range(5)])
        assert out[0] == out[1] == [True, True, False, False, False]
        assert pa.stats()["taps_dropped"] == ja.stats()["taps_dropped"] == 3
        assert m.registry.get_sample_value(
            "gubernator_analytics_tap_dropped_total") == 3
        pa.flush()
        ja.flush()
        assert pa.stats() == ja.stats()
    finally:
        pa.close()
        ja.close()


def test_device_tap_on_the_cpu_gates_unserved_rows():
    """tap_device takes the [4, B] tap tensor (khash, hits, over,
    served) as the step emits it: only served rows fold."""
    pa = analytics.KeyAnalytics(k=4, width=16)
    try:
        key = torch.tensor([5, 6, 7, 0], dtype=torch.int64)
        tap = torch.stack([key, torch.tensor([2, 1, 1, 1]),
                           torch.tensor([0, 1, 0, 0]),
                           torch.tensor([1, 1, 0, 0])])
        assert pa.tap_device(tap)
        assert pa.flush()
        top = {int(e["khash"], 16): (e["hits"], e["over_limit"])
               for e in pa.topkeys_snapshot()["keys"]}
        assert top == {5: (2, 0), 6: (1, 1)}
        assert pa.stats()["waves_tapped"] == 1
    finally:
        pa.close()


def test_topk_gauge_is_bounded_by_k():
    from gubernator_tpu_torch.metrics import Metrics

    m = Metrics()
    pa = analytics.KeyAnalytics(metrics=m, k=3, width=8)
    try:
        for kh, hits, over, _ in zipf_waves(2, 100, 3, 300, False):
            pa.tap_packed(kh, hits, over.astype(np.int32))
            pa.flush()
        labels = [s.labels["key"] for fam in m.registry.collect()
                  if fam.name.startswith("gubernator_topkey_overlimit")
                  for s in fam.samples]
        assert len(labels) == 3
    finally:
        pa.close()


# ---- the daemon ----------------------------------------------------------

def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(port, reqs):
    body = json.dumps({"requests": reqs}).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/v1/GetRateLimits",
                               body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())


def test_debug_topkeys_and_phases_have_jax_shape(monkeypatch):
    """/debug/topkeys and /debug/phases answer the JAX daemon's document
    shape (keys, fields, owner column), and 404 with analytics off."""
    from gubernator_tpu import analytics as jax_analytics

    monkeypatch.delenv("GUBER_ANALYTICS", raising=False)
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="", device="cpu",
                                  cache_size=1 << 12))
    try:
        for _ in range(3):
            _post(d.http_port, [{"name": "a", "unique_key": f"k{i % 7}",
                                 "hits": 1, "limit": 3, "duration": 5000}
                                for i in range(40)])
        code, top = get_json(d.http_port, "/debug/topkeys?limit=4")
        assert code == 200
        ja = jax_analytics.KeyAnalytics()
        try:
            want = ja.topkeys_snapshot()
        finally:
            ja.close()
        assert set(top) == set(want)
        assert len(top["keys"]) == 4
        assert set(top["keys"][0]) == {"khash", "key", "hits", "err",
                                       "over_limit", "last_seen_ms",
                                       "owner"}
        assert top["keys"][0]["key"].startswith("a_k")
        assert top["keys"][0]["owner"] is None  # alone: no ring
        # the 120 hits sent and the warm-up query (weight 1)
        assert top["total_hits_observed"] == 121
        code, ph = get_json(d.http_port, "/debug/phases")
        assert code == 200 and set(ph) == {"phases", "waves"}
        assert {"queue_wait", "pack", "device", "resolve"} <= set(
            ph["phases"])
        assert set(ph["phases"]["device"]) == {"count", "total_ms", "p50_ms",
                                               "p99_ms", "max_ms"}
        _, h = get_json(d.http_port, "/healthz?deep=1")
        assert h["dispatcher"]["analytics"]["waves_tapped"] > 0
    finally:
        d.close()
    monkeypatch.setenv("GUBER_ANALYTICS", "0")
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="", device="cpu",
                                  cache_size=1 << 12))
    try:
        for path in ("/debug/topkeys", "/debug/phases"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get_json(d.http_port, path)
            assert e.value.code == 404
        assert d.instance.analytics is None
    finally:
        d.close()


def test_analytics_on_by_default_and_config_defaults_equal_jax(monkeypatch):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu_torch.config import Config, setup_daemon_config
    from gubernator_tpu_torch.instance import V1Instance

    for var in ("GUBER_ANALYTICS", "GUBER_TOPK", "GUBER_SKETCH_WIDTH"):
        monkeypatch.delenv(var, raising=False)
    c, jc = Config(), JaxConfig()
    for f in ("loader", "store", "tier_cold", "tier_promote_threshold"):
        assert getattr(c, f) == getattr(jc, f)
    assert setup_daemon_config(env={}).snapshot_path == ""
    inst = V1Instance(Config(cache_size=1024, device="cpu"))
    try:
        st = inst.analytics.stats()
        assert (st["k"], st["width"]) == (256, 1024)
        assert inst.engine.tap_sink == inst.analytics.tap_device
        assert inst._tier is None
    finally:
        inst.close()
    monkeypatch.setenv("GUBER_TOPK", "10")
    monkeypatch.setenv("GUBER_SKETCH_WIDTH", "77")
    monkeypatch.setenv("GUBER_TIER_COLD", "1")
    monkeypatch.setenv("GUBER_TIER_PROMOTE", "5")
    inst = V1Instance(Config(cache_size=1024, device="cpu", engine="xla"))
    try:
        st = inst.analytics.stats()
        assert (st["k"], st["width"]) == (10, 77)
        assert inst._tier.promote_threshold == 5
        assert inst.engine.tap_sink is None  # the host taps the classic
    finally:
        inst.close()


def test_wave_taps_reach_the_sketch_on_both_engines(monkeypatch):
    """Object-lane waves tap with names (the device tap muted), wire
    waves with columns (bucket: the device tap; classic: the host)."""
    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    monkeypatch.delenv("GUBER_ANALYTICS", raising=False)
    monkeypatch.setenv("GUBER_PIPELINE", "0")
    for engine in ("", "xla"):
        inst = V1Instance(Config(cache_size=1024, device="cpu",
                                 engine=engine, sweep_interval_ms=0))
        try:
            reqs = [RateLimitRequest(name="w", unique_key=f"k{i % 5}",
                                     hits=1, limit=100, duration=60_000)
                    for i in range(50)]
            inst.get_rate_limits(reqs, now_ms=NOW)
            inst.get_rate_limits_wire(encode_get_rate_limits(reqs),
                                      now_ms=NOW)
            inst.analytics.flush()
            top = inst.analytics.topkeys_snapshot()
            assert top["total_hits_observed"] == 100
            assert {e["key"] for e in top["keys"]} == {
                f"w_k{i}" for i in range(5)}
            assert all(e["hits"] == 20 for e in top["keys"])
        finally:
            inst.close()
