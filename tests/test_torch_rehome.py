"""Rows a sender's health gate rehomes, on a port cluster on the CPU:

- **the gates disagree**: daemon A's gate has ejected C, B's has not.
  A's rows of C's keys go to B on A's rehome lane (RPCs marked
  ``gubernator-rehomed``); B serves them degraded, flags them with C and
  queues their hits for C, so C ends holding every hit (object and wire
  lanes, NO_BATCHING included);
- **a reshard with handover on**: B's ring has D joined and A's has not.
  A's stale-ring forward to B is an ordinary forward: B applies it,
  flags nothing and queues nothing, and B's handover then carries the
  row to D, which ends holding every hit once;
- **a batch's rows of one owner ride one entry in order**: a caller's
  rows of one key apply on the owner as they were sent, and a
  NO_BATCHING row takes a typed call of its own.

Decisions are exact; flushes are polled by attempt."""
import threading
import time

import pytest

from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.oracle import Oracle
from gubernator_tpu_torch.peer_client import REHOMED_KEY
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import Behavior, RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

LIMIT = 10
DURATION = 600_000
ATTEMPTS = 200


@pytest.fixture(scope="module")
def trio():
    c = cluster_mod.start(3, device="cpu")
    yield c
    c.stop()


def addr(c, i):
    return c.grpc_address(i)


def peer(inst, address):
    return next(p for p in inst.peers() if p.info.grpc_address == address)


def req(name, key, hits, behavior=0):
    return RateLimitRequest(name=name, unique_key=key, hits=hits,
                            limit=LIMIT, duration=DURATION,
                            behavior=behavior)


def keys_where(pred, n, prefix):
    out, i = [], 0
    while len(out) < n:
        k = f"{prefix}{i}"
        if pred(k):
            out.append(k)
        i += 1
    return out


def send(inst, reqs, lane):
    if lane == "wire":
        return list(pb.GetRateLimitsResp.FromString(
            inst.get_rate_limits_wire(encode_get_rate_limits(reqs)))
            .responses)
    return inst.get_rate_limits(reqs)


def remaining_on(inst, name, key):
    return inst.get_rate_limits([req(name, key, 0)])[0].remaining


def degraded_served(inst, peer_addr) -> float:
    return inst.metrics.registry.get_sample_value(
        "gubernator_degraded_served_total", {"peer_addr": peer_addr}) or 0.0


def gm_stat(inst, key) -> int:
    gm = inst.global_manager
    return 0 if gm is None else gm.snapshot_stats()[key]


def poll(pred):
    for _ in range(ATTEMPTS):
        if pred():
            return True
        time.sleep(0.05)
    return pred()


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_gate_disagreement_serves_marked_rows_degraded_and_conserves(
        trio, lane, monkeypatch):
    a, b, c = (trio.instance_at(i) for i in range(3))
    b_addr, c_addr = addr(trio, 1), addr(trio, 2)
    name = f"gd_{lane}"
    # A's gate ejects C; B's and C's see C healthy
    monkeypatch.setattr(peer(a, c_addr), "route_healthy", lambda *_: False)
    monkeypatch.setattr(a, "_ensure_probe_loop", lambda: None)
    a._routing_picker()
    assert a._gate_bad == frozenset({c_addr}) and not b._gate_bad
    keys = keys_where(
        lambda k: (a.owner_of(f"{name}_{k}").info.grpc_address == c_addr
                   and a._route_owner_of(f"{name}_{k}").info.grpc_address
                   == b_addr), 5, "k")
    keys, nb = keys[:4], keys[4]
    reqs = [req(name, k, h) for k in keys for h in (1, 2)]
    sent = {k: 3 for k in keys}
    if lane == "object":
        # a NO_BATCHING row takes a typed call, marked as well
        reqs.append(req(name, nb, 3, int(Behavior.NO_BATCHING)))
        sent[nb] = 3
    on_b = peer(a, b_addr).lane_stats()
    served0 = degraded_served(b, c_addr)
    deg0 = gm_stat(b, "hits_degraded")
    resps = send(a, reqs, lane)
    flagged = [dict(r.metadata).get("degraded_peer") for r in resps]
    assert flagged == [c_addr] * len(reqs)
    assert [r.error for r in resps] == [""] * len(reqs)
    assert [r.remaining for r in resps[:2 * len(keys)]] == \
        [LIMIT - 1, LIMIT - 3] * len(keys)
    # the sender marked the rehomed rows, and only them
    after = peer(a, b_addr).lane_stats()
    assert after["rehome"]["items"] - on_b["rehome"]["items"] == \
        2 * len(keys)
    assert after["forward"]["items"] == on_b["forward"]["items"]
    assert degraded_served(b, c_addr) - served0 == len(reqs)
    assert gm_stat(b, "hits_degraded") - deg0 == sum(sent.values())
    # conservation: the membership owner ends holding every hit sent
    assert poll(lambda: all(remaining_on(c, name, k) == LIMIT - sent[k]
                            for k in sent)), \
        {k: remaining_on(c, name, k) for k in sent}
    assert poll(lambda: b.global_manager.queued()["hits"] == 0)


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_stale_ring_forward_during_a_handover_is_a_plain_apply(
        lane, monkeypatch):
    c = cluster_mod.start(3, device="cpu", handover_on_reshard=True)
    try:
        a, b, d = (c.instance_at(i) for i in range(3))
        pa, pb_, pd = (c.peer_at(i) for i in range(3))
        b_addr, d_addr = addr(c, 1), addr(c, 2)
        a.set_peers([pa, pb_])
        b.set_peers([pa, pb_])
        name = f"rs_{lane}"
        # B owns these on the ring of A and B; D owns them once it joins
        keys = keys_where(
            lambda k: (a.owner_of(f"{name}_{k}").info.grpc_address == b_addr
                       and d.owner_of(f"{name}_{k}").info.grpc_address
                       == d_addr), 4, "k")
        seed = send(a, [req(name, k, 2) for k in keys], lane)
        assert [r.remaining for r in seed] == [LIMIT - 2] * len(keys)
        # B's ring takes D in first; its handover waits for the forward
        held = []
        monkeypatch.setattr(b, "_start_handover",
                            lambda old, _name: held.append(old))
        b.set_peers([pa, pb_, pd])
        assert len(held) == 1
        served0 = degraded_served(b, d_addr)
        stale = send(a, [req(name, k, 3) for k in keys], lane)
        assert [r.remaining for r in stale] == [LIMIT - 5] * len(keys)
        assert all("degraded" not in dict(r.metadata) for r in stale)
        assert degraded_served(b, d_addr) == served0
        assert gm_stat(b, "hits_degraded") == 0
        assert peer(a, b_addr).lane_stats()["rehome"]["items"] == 0
        # the handover now carries B's rows, stale hits included, to D
        monkeypatch.undo()
        b._start_handover(held[0], "handover-under-test")
        for t in threading.enumerate():
            if t.name == "handover-under-test":
                t.join(30)
        assert poll(lambda: all(remaining_on(d, name, k) == LIMIT - 5
                                for k in keys)), \
            {k: remaining_on(d, name, k) for k in keys}
        time.sleep(0.3)  # a GLOBAL tick or two: nothing more may land
        assert [remaining_on(d, name, k) for k in keys] == \
            [LIMIT - 5] * len(keys)
    finally:
        c.stop()


def test_a_batch_rows_of_one_owner_apply_in_order(trio):
    a = trio.instance_at(0)
    b_addr = addr(trio, 1)
    name = "ord"
    key, nb = keys_where(
        lambda k: a._route_owner_of(f"{name}_{k}").info.grpc_address
        == b_addr, 2, "k")
    hits = [2, 3, 4, 1]
    reqs = [req(name, key, h) for h in hits]
    reqs.append(req(name, nb, 3, int(Behavior.NO_BATCHING)))
    before = peer(a, b_addr).lane_stats()
    got = a.get_rate_limits(reqs)
    oracle = Oracle()
    now = int(time.time() * 1000)
    want = [oracle.check(r, now) for r in reqs]
    assert [(int(r.status), r.remaining) for r in got] == \
        [(int(r.status), r.remaining) for r in want]
    after = peer(a, b_addr).lane_stats()
    assert after["forward"]["items"] - before["forward"]["items"] == 4
    assert after["forward"]["flushes"] - before["forward"]["flushes"] == 1
    assert after["single_calls"] - before["single_calls"] == 1
    assert after["rehome"]["items"] == before["rehome"]["items"]


def test_the_marked_lane_carries_its_metadata():
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.peer_client import PeerClient, is_rehomed
    from gubernator_tpu_torch.types import PeerInfo

    p = PeerClient(PeerInfo(grpc_address="127.0.0.1:1"), BehaviorConfig())
    try:
        assert p._rehome_lane.metadata == ((REHOMED_KEY, "1"),)
        assert p._forward_lane.metadata == ()
    finally:
        p.shutdown()

    class Ctx:
        def __init__(self, md):
            self.md = md

        def invocation_metadata(self):
            return self.md

    assert is_rehomed(Ctx(((REHOMED_KEY, "1"),)))
    assert not is_rehomed(Ctx((("traceparent", "00-x"),)))
    assert not is_rehomed(object())
