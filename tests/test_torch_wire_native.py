"""The port's host wire library (csrc/wire.cpp through ops/native.py)
against the JAX package's C++ extension on the same bytes: parsed
columns, packed wave matrices, key hashes, behavior_or and response
bytes must be equal, and both must refuse the same messages."""
import numpy as np
import pytest

from gubernator_tpu.ops import native as jax_native
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.ops import native
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import _varint, encode_get_rate_limits

NOW = 1_765_000_000_000
#: the largest wave bucket of an engine with batch_rows = 64
BIG = 512


def random_requests(seed: int, n: int, ascii_keys: bool = True):
    """Requests over the whole field ranges: negative and huge values,
    TOKEN / LEAKY and unknown algorithms, every flag but Gregorian,
    created_at stamps, and (if not ascii_keys) non-ASCII keys."""
    rng = np.random.default_rng(seed)
    big = [0, 1, 7, 2 ** 30, 2 ** 40, 2 ** 53 + 5, 2 ** 62, -1, -(2 ** 40)]
    out = []
    for i in range(n):
        key = f"k{int(rng.integers(0, 50))}"
        if not ascii_keys and i % 3 == 0:
            key += "é€😀"[int(rng.integers(0, 3))]
        out.append(RateLimitRequest(
            name=f"n{int(rng.integers(0, 3))}", unique_key=key,
            hits=int(rng.choice(big)), limit=int(rng.choice(big)),
            duration=int(rng.choice([0, 1, 1000, 60_000, 2 ** 36,
                                     2 ** 60, -5])),
            algorithm=int(rng.choice([0, 1, 1, 2, -1])),
            behavior=int(rng.choice([0, 1, 2, 8, 16, 32, 2 | 8])),
            burst=int(rng.choice(big)),
            created_at=int(rng.choice([0, 0, NOW - 5, -3]))))
    return out


def both_parse(data: bytes):
    got, want = (native.parse_get_rate_limits(data),
                 jax_native.parse_get_rate_limits(data))
    assert (got is None) == (want is None)
    if want is not None:
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert native.count_req_items(data) == jax_native.count_req_items(data)
    return got


def both_pack(data: bytes, m: int):
    """pack_wire_wave into zeroed pairs of both packages; returns the
    port's result after holding matrices and outputs equal."""
    mats = [(np.zeros((8, m), np.int64), np.zeros((3, m), np.int32))
            for _ in range(2)]
    got = native.pack_wire_wave(data, NOW, *mats[0])
    want = jax_native.pack_wire_wave(data, NOW, *mats[1])
    assert (got is None) == (want is None)
    if want is not None:
        assert got[0] == want[0] and got[3] == want[3]
        for a, b in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
            assert np.array_equal(a, b)
        assert np.array_equal(mats[0][0], mats[1][0])
        assert np.array_equal(mats[0][1], mats[1][1])
    return got


@pytest.mark.parametrize("ascii_keys", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_valid_batches_match(seed, ascii_keys):
    reqs = random_requests(seed, 40, ascii_keys)
    data = encode_get_rate_limits(reqs)
    got = both_parse(data)
    assert got["n"] == len(reqs)
    packed = both_pack(data, 64)
    assert packed[0] == len(reqs)
    assert (packed[1] != 0).all()


def _tlv(payload: bytes) -> bytes:
    return b"\x0a" + _varint(len(payload)) + payload


GOOD = encode_get_rate_limits([RateLimitRequest(
    name="a", unique_key="b", hits=1, limit=5, duration=1000)])

#: messages the fused lane must refuse: (bytes, does parse take it?)
REFUSED = {
    "metadata": (encode_get_rate_limits([RateLimitRequest(
        name="a", unique_key="b", limit=5, metadata={"m": "1"})]), False),
    "empty name": (encode_get_rate_limits([RateLimitRequest(
        name="", unique_key="b", limit=5)]), False),
    "empty key": (encode_get_rate_limits([RateLimitRequest(
        name="a", unique_key="", limit=5)]), False),
    "unknown field": (GOOD + _tlv(b"\x0a\x01a\x12\x01b\x58\x01"), False),
    "unknown top-level field": (GOOD + b"\x12\x00", False),
    "fixed64 field": (_tlv(b"\x0a\x01a\x12\x01b\x19" + bytes(8)), False),
    "truncated varint": (GOOD + _tlv(b"\x0a\x01a\x12\x01b\x18\xff"), False),
    "truncated length": (GOOD[:-2], False),
    "invalid utf-8": (_tlv(b"\x0a\x01a\x12\x02\xc3\x28"), False),
    "gregorian row": (encode_get_rate_limits([RateLimitRequest(
        name="a", unique_key="b", limit=5, duration=1, behavior=4)]),
        True),
}


@pytest.mark.parametrize("shape", sorted(REFUSED))
def test_refused_messages_match(shape):
    data, parses = REFUSED[shape]
    got = both_parse(data)
    assert (got is not None) == parses
    assert both_pack(data, 64) is None


@pytest.mark.parametrize("extra", [0, 1])
def test_largest_wave_bucket_and_one_row_more(extra):
    reqs = random_requests(7, BIG + extra)
    data = encode_get_rate_limits(reqs)
    assert both_parse(data)["n"] == BIG + extra
    got = both_pack(data, BIG)
    assert (got is None) == bool(extra)


def test_empty_message():
    assert both_parse(b"")["n"] == 0
    assert native.count_req_items(b"") == 0
    assert both_pack(b"", 64)[0] == 0


def test_packed_clamps_equal_pack_columns():
    """The fused pass clamps exactly as the port's pack_columns."""
    from gubernator_tpu_torch.core.batch import pack_columns, pack_wave_host
    from gubernator_tpu_torch.hashing import mix64_np

    data = encode_get_rate_limits(random_requests(11, 64))
    p = native.parse_get_rate_limits(data)
    kh = mix64_np(p["khash_raw"])
    kh = np.where(kh == 0, np.uint64(1), kh)
    batch, errs = pack_columns(kh, p["hits"], p["limit"], p["duration"],
                               p["algorithm"], p["behavior"], p["burst"],
                               NOW, created_at=p["created_at"])
    assert not errs
    a64, a32 = np.zeros((8, 64), np.int64), np.zeros((3, 64), np.int32)
    assert native.pack_wire_wave(data, NOW, a64, a32)[0] == 64
    w64, w32 = pack_wave_host(batch)
    assert np.array_equal(a64, w64) and np.array_equal(a32, w32)


def result_columns(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, n).astype(np.int32),
            rng.choice([0, 5, 2 ** 40, 2 ** 53], n).astype(np.int64),
            rng.choice([0, 1, 99, 2 ** 53 - 1], n).astype(np.int64),
            rng.choice([0, NOW, NOW + 60_000], n).astype(np.int64),
            np.zeros(n, bool))


@pytest.mark.parametrize("errors", ["none", "some", "long", "non-ascii"])
@pytest.mark.parametrize("seed", range(2))
def test_response_bytes_match(seed, errors):
    cols = result_columns(seed, 50)
    lo, hi = (0, 50) if seed == 0 else (7, 31)
    errs = None
    if errors != "none":
        msg = {"some": "rate limit table full", "long": "x" * 300,
               "non-ascii": "ошибка ✗"}[errors]
        errs = [msg if i % 4 == 1 else (None if i % 3 else "")
                for i in range(hi - lo)]
    got = native.build_responses_from_columns(cols, lo, hi, errs)
    assert got == jax_native.build_responses_from_columns(cols, lo, hi,
                                                          errs)
    resps = pb.GetRateLimitsResp.FromString(got).responses
    assert len(resps) == hi - lo
    assert [r.limit for r in resps] == cols[1][lo:hi].tolist()


def test_response_bounds_are_checked():
    cols = result_columns(0, 4)
    with pytest.raises(ValueError):
        native.build_responses_from_columns(cols, 2, 5)
    with pytest.raises(ValueError):
        native.build_responses_from_columns(
            (cols[0][:3],) + cols[1:], 0, 3)


def test_pack_refuses_wrong_buffers():
    with pytest.raises(ValueError):
        native.pack_wire_wave(GOOD, NOW, np.zeros((8, 4), np.int32),
                              np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError):
        native.pack_wire_wave(GOOD, NOW, np.zeros((8, 8), np.int64)[:, ::2],
                              np.zeros((3, 4), np.int32))


def test_library_builds_from_the_port_sources():
    from gubernator_tpu_torch.ops import build

    lib = build.load_wire_library()
    assert build.WIRE_SOURCE.parent == build.CSRC
    assert build.CSRC.parent.name == "gubernator_tpu_torch"
    assert str(build.BUILD_DIR / build.WIRE_LIB_NAME) == lib._name


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler error surfaces: there is no substitute for the lane."""
    from gubernator_tpu_torch.ops import build

    bad = tmp_path / "wire.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "WIRE_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_wire_lib", None)
    with pytest.raises(RuntimeError, match="failed on wire.cpp"):
        build.load_wire_library()


@pytest.mark.parametrize("seed", range(3))
def test_encoder_matches_protobuf(seed):
    """The protobuf-free encoder writes what protobuf serializes, and the
    port's converters round-trip through the port's pb2 classes."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as port_pb
    from gubernator_tpu_torch.types import RateLimitResponse
    from gubernator_tpu_torch.wire import (req_from_pb, reqs_to_pb,
                                           resp_from_pb, resp_to_pb)

    reqs = [r for r in random_requests(seed, 30, ascii_keys=bool(seed))]
    # one entry each: protobuf writes a map's entries in no fixed order
    for i, r in enumerate(reqs[::7]):
        r.metadata = {"tenant": "t"} if i % 2 else {"é": ""}
    for r in reqs:
        r.created_at = 0  # field 10 is not in the pb2 schema
    data = encode_get_rate_limits(reqs)
    assert data == reqs_to_pb(reqs).SerializeToString()
    back = [req_from_pb(m) for m in
            port_pb.GetRateLimitsReq.FromString(data).requests]
    assert back == reqs
    resp = RateLimitResponse(status=1, limit=5, remaining=0, reset_time=9,
                             error="rate limit table full")
    assert resp_from_pb(port_pb.RateLimitResp.FromString(
        resp_to_pb(resp).SerializeToString())) == resp


def hash_names_and_keys(seed: int, n: int):
    """Seeded (name, unique_key) lists mixing ASCII, non-ASCII (2, 3 and
    4-byte UTF-8), empty and long strings."""
    rng = np.random.default_rng(seed)
    alphabet = ["a", "Z", "_", "0", "é", "€", "😀", "ß", " "]

    def word(i):
        kind = i % 5
        if kind == 0:
            return ""
        if kind == 1:
            return "".join(alphabet[int(j)] for j in
                           rng.integers(0, len(alphabet), 4096))
        return "".join(alphabet[int(j)] for j in
                       rng.integers(0, len(alphabet),
                                    int(rng.integers(1, 24))))

    names = [word(int(rng.integers(0, 5))) for _ in range(n)]
    keys = [word(int(rng.integers(0, 5))) for _ in range(n)]
    return names, keys


@pytest.mark.parametrize("seed", range(3))
def test_native_hashes_equal_the_jax_extension(seed):
    """Raw FNV-1a 64 of keys and of (name, key) pairs byte-equal to the
    JAX extension's, and the table key hashes equal to JAX's
    hashing module and to the port's plain Python loop (exact)."""
    from gubernator_tpu import hashing as jax_hashing
    from gubernator_tpu_torch import hashing

    names, keys = hash_names_and_keys(seed, 300)
    joined = [n + "_" + k for n, k in zip(names, keys)]
    got = native.hash_pairs(names, keys)
    assert got.tobytes() == jax_native.hash_pairs(names, keys).tobytes()
    assert native.hash_keys(joined).tobytes() == \
        jax_native.hash_keys(joined).tobytes()
    assert got.tobytes() == native.hash_keys(joined).tobytes()
    mixed = hashing.hash_request_keys(names, keys)
    assert mixed.tobytes() == jax_hashing.hash_request_keys(
        names, keys).tobytes()
    assert mixed.tobytes() == hashing.hash_request_keys_plain(
        names, keys).tobytes()
    assert hashing.hash_keys(joined).tobytes() == mixed.tobytes()
    assert hashing.hash_keys(joined).tobytes() == \
        hashing.hash_keys_plain(joined).tobytes()
    for n, k in list(zip(names, keys))[:20]:
        assert hashing.hash_key(n, k) == jax_hashing.hash_key(n, k)
    # bytes items hash as their bytes, as in the JAX extension
    bk = [k.encode() for k in joined[:10]]
    assert native.hash_keys(bk).tobytes() == \
        jax_native.hash_keys(bk).tobytes()


def test_native_hash_of_nothing_and_a_zero_remap():
    from gubernator_tpu_torch import hashing

    assert native.hash_pairs([], []).size == 0
    assert hashing.hash_keys([]).size == 0
    assert hashing.hash_keys(()).dtype == np.uint64
    # the mixed hash is never 0 (0 marks an empty table slot)
    assert (hashing.hash_keys([str(i) for i in range(2000)]) != 0).all()


@pytest.mark.parametrize("bad", ["int", "length", "surrogate"])
def test_native_hash_errors_equal_the_jax_extension(bad):
    """A non-string item, unequal lengths and a lone surrogate raise the
    JAX extension's exception types."""
    names, keys = ["a", "b"], ["x", "y"]
    if bad == "int":
        keys = ["x", 5]
        exc = TypeError
    elif bad == "length":
        keys = ["x"]
        exc = ValueError
    else:
        keys = ["x", "\ud800"]
        exc = UnicodeEncodeError
    with pytest.raises(exc):
        jax_native.hash_pairs(names, keys)
    with pytest.raises(exc):
        native.hash_pairs(names, keys)


def test_missing_host_library_raises_instead_of_hashing_in_python(
        monkeypatch, tmp_path):
    """With no compiler the library cannot be built, and the object
    lane's hashing raises: it does not fall back to the Python loop."""
    from gubernator_tpu_torch import hashing
    from gubernator_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_wire_lib", None)
    monkeypatch.setattr(build, "_wire_pylib", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        hashing.hash_request_keys(["a"], ["b"])
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        hashing.hash_keys(["a_b"])
