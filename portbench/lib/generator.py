"""The load generator: threads of the daemon's process that call the
servicer's own entry (``get_rate_limits_wire``) with request bytes.

At set-up it draws the run's calls from the seed and encodes them
(``wire.encode_rows``); through the window it sends them as its traffic
file's generator kind schedules them; after the window it reads keys
back over gRPC with calls of 0 hits and decodes every answer.  It
imports neither the program nor its reference.
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from portbench.lib import keys, wire

METHOD = "/pb.gubernator.V1/GetRateLimits"


def encode_calls(spec: dict, ranks: np.ndarray, key_index: np.ndarray,
                 hits: int) -> list:
    """Request bytes of calls whose rows name ``ranks`` ([calls, rows])."""
    data, ends = wire.encode_rows(
        spec["name"], spec["key_prefix"], key_index[ranks.ravel()],
        spec["key_width"], hits, spec["limit"], spec["duration_ms"])
    return wire.split_calls(data, ends, ranks.shape[1])


def read_back(addresses: list, calls: list) -> list:
    """Each address's answers to the read calls over gRPC, one call at
    a time."""
    import grpc

    out = []
    for addr in addresses:
        with grpc.insecure_channel(addr) as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            stub = ch.unary_unary(METHOD)
            out.append([stub(c, timeout=60) for c in calls])
    return out


class Load:
    """One run's traffic: its calls and read-back calls, encoded from the
    seed at set-up (``key_index``: the population's key index of each
    rank)."""

    def __init__(self, spec: dict, key_index: np.ndarray):
        self.traffic, self.seed = spec["traffic"], spec["seed"]
        self.pool = keys.call_pool(self.traffic, self.seed, spec["n_keys"])
        reads = keys.read_ranks(self.traffic, self.seed, spec["n_keys"],
                                self.pool)
        self.calls = encode_calls(spec, self.pool, key_index, spec["hits"])
        per = int(self.traffic["checks_per_call"])
        self.read_rows = np.resize(
            reads, -(-len(reads) // per) * per).reshape(-1, per)
        self.read_calls = encode_calls(spec, self.read_rows, key_index, 0)
        self.kind = importlib.import_module(
            f"portbench.gen.{self.traffic['generator']}")
        self.recs: list = []

    def drive(self, entry, t_start: float, t_window: float,
              t_end: float) -> None:
        """Send the calls to ``entry`` (bytes in, bytes out) from
        ``t_start`` until ``t_end`` (monotonic clock)."""
        self.recs = self.kind.run(self.traffic, self.calls, entry, t_start,
                                  t_window, t_end, self.seed)

    def collect(self, read_addresses: list) -> dict:
        """Read the keys back, then decode every answer: the run's
        records, as columns."""
        t_read = time.monotonic()
        reads_ans = read_back(read_addresses, self.read_calls)
        t_read = time.monotonic() - t_read

        t_dec = time.monotonic()
        recs = sorted(self.recs, key=lambda r: r[4])
        ok = np.array([r[5] is not None for r in recs], bool)
        cols, per_call = wire.decode_calls([r[5] for r in recs
                                            if r[5] is not None])
        rows = np.zeros(len(recs), np.int64)
        rows[ok] = per_call
        read_cols = [wire.decode_calls(a)[0] for a in reads_ans]
        return {
            "call": np.array([r[0] for r in recs], np.int64),
            "caller": np.array([r[1] for r in recs], np.int32),
            "due": np.array([r[2] for r in recs]),
            "sent": np.array([r[3] for r in recs]),
            "done": np.array([r[4] for r in recs]),
            "ok": ok, "rows": rows,
            "codes": sorted({r[6] for r in recs if r[5] is None}),
            "answers": cols, "pool": self.pool,
            "read_rows": self.read_rows.ravel(), "reads": read_cols,
            "read_s": t_read, "decode_s": time.monotonic() - t_dec}
