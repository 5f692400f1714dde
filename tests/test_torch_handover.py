"""Handover of moved rows (``handover_on_reshard``), held against the JAX
package's (tests/test_handover.py): two daemons of each package on the
CPU, the second joining with ``set_peers`` on both:

- with handover, every key reads its state from before the join
  (remaining 7 of 10), the keys the new ring gives the newcomer live on
  it and leave the first daemon;
- without handover (the default), those keys start afresh (10) and the
  others keep 7;
- a 30-day LEAKY row (its remaining a fixed point over an eff_ms past
  2^31) moves losslessly between classic-engine daemons;
- a delivery that fails leaves the rows where they are.

The two packages' daemons listen on different ports, so their rings
place keys apart: each is held to the same rule on its own ring, and
their answers per key class are compared.  Decisions are exact; moves
are polled by attempt."""
import time

import numpy as np
import pytest

from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
from gubernator_tpu.daemon import spawn_daemon as jax_spawn
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.hashing import hash_request_keys
from gubernator_tpu_torch.types import Algorithm, RateLimitRequest

from test_torch_cluster import jax_env  # noqa: F401

N_KEYS = 40
MONTH = 30 * 86_400_000
ATTEMPTS = 300


@pytest.fixture(scope="module")
def jax_mesh(jax_env):  # noqa: F811
    from gubernator_tpu.parallel import make_mesh

    return make_mesh(n=1)


def port_daemon(handover: bool, engine: str = ""):
    return spawn_daemon(DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=1 << 10, batch_rows=64, device="cpu", engine=engine,
        handover_on_reshard=handover))


def jax_daemon(mesh, handover: bool):
    return jax_spawn(JaxDaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=1 << 10, handover_on_reshard=handover), mesh=mesh)


def token(i, hits=1):
    return dict(name="ho", unique_key=f"k{i}", hits=hits, limit=10,
                duration=600_000)


def leaky(i, hits=1):
    return dict(name="ho64", unique_key=f"m{i}", hits=hits, limit=30,
                duration=MONTH, algorithm=int(Algorithm.LEAKY_BUCKET),
                burst=12)


class Pair:
    """Two daemons of one package: ``first`` serves the keys, then
    ``second`` joins."""

    def __init__(self, make, cls):
        self.make, self.cls = make, cls
        self.first = self.second = None

    def ask(self, reqs):
        return self.first.instance.get_rate_limits(
            [self.cls(**r) for r in reqs])

    def join(self):
        self.second = self.make()
        infos = [self.first.peer_info(), self.second.peer_info()]
        self.first.set_peers(infos)
        self.second.set_peers(infos)

    def moved(self, kind, n=N_KEYS):
        """Which keys the joined ring gives the newcomer."""
        addr = self.second.advertise_address
        return [self.first.instance.owner_of(
            f"{kind(i)['name']}_{kind(i)['unique_key']}").info.grpc_address
            == addr for i in range(n)]

    def close(self):
        for d in (self.first, self.second):
            if d is not None:
                d.close()


@pytest.fixture()
def pairs(jax_mesh):
    made = []

    def make(handover, engine=""):
        p = Pair(lambda: port_daemon(handover, engine), RateLimitRequest)
        j = Pair(lambda: jax_daemon(jax_mesh, handover), JaxReq)
        made.extend([p, j])
        p.first, j.first = p.make(), j.make()
        return p, j

    yield make
    for p in made:
        p.close()


def settle(pair, kind, want):
    """Poll the first daemon's answers (hits=0) until every key reads
    ``want(i)``; returns the last answers."""
    vals = []
    for _ in range(ATTEMPTS):
        vals = [r.remaining for r in pair.ask(
            [kind(i, hits=0) for i in range(N_KEYS)])]
        if all(v == want(i) for i, v in enumerate(vals)):
            break
        time.sleep(0.1)
    return vals


def test_join_hands_over_moved_rows(pairs):
    outcome = []
    for pair in pairs(True):
        assert {r.remaining for r in pair.ask(
            [token(i, hits=3) for i in range(N_KEYS)])} == {7}
        pair.join()
        moved = pair.moved(token)
        assert 0 < sum(moved) < N_KEYS
        vals = settle(pair, token, lambda i: 7)
        outcome.append(vals)
    assert outcome[0] == outcome[1] == [7] * N_KEYS


def port_rows(daemon, kind, idx):
    keys = hash_request_keys([kind(i)["name"] for i in idx],
                             [kind(i)["unique_key"] for i in idx])
    with daemon.instance._engine_mu:
        return daemon.instance.engine.gather_rows(keys)


def test_moved_rows_live_on_the_newcomer_alone(pairs):
    port, _ = pairs(True)
    port.ask([token(i, hits=3) for i in range(N_KEYS)])
    before_found, before = port_rows(port.first, token, range(N_KEYS))
    assert before_found.all()
    port.join()
    moved = np.nonzero(port.moved(token))[0]
    for _ in range(ATTEMPTS):
        found_new, cols = port_rows(port.second, token, moved)
        found_old, _ = port_rows(port.first, token, moved)
        if found_new.all() and not found_old.any():
            break
        time.sleep(0.1)
    assert found_new.all() and not found_old.any()
    for f in ("meta", "limit", "duration", "eff_ms", "remaining", "t_ms",
              "expire_at"):
        assert (cols[f] == before[f][moved]).all(), f
    # the first daemon's warm-up row moves with the keys when the new
    # ring gives it to the newcomer
    warm = port.first.instance.owner_of("_warmup_w").info.grpc_address \
        == port.second.advertise_address
    ev = port.first.instance.recorder.events(kind="handover")
    assert ev and ev[-1]["rows"] == len(moved) + warm
    assert ev[-1]["peers"] == 1


def test_join_without_handover_resets_moved_rows(pairs):
    outcome = []
    for pair in pairs(False):
        pair.ask([token(i, hits=3) for i in range(N_KEYS)])
        pair.join()
        moved = pair.moved(token)
        vals = [r.remaining for r in pair.ask(
            [token(i, hits=0) for i in range(N_KEYS)])]
        assert vals == [10 if m else 7 for m in moved]
        outcome.append(sorted(set(vals)))
    assert outcome[0] == outcome[1] == [7, 10]


def test_handover_preserves_30day_leaky_fixed_point(pairs):
    """On the classic engine (the bucket engine's leaky eff stops below
    2^31, as the JAX bucket engine's does), which the JAX daemon serves
    on the CPU too."""
    outcome = []
    for pair in pairs(True, engine="xla"):
        rs = pair.ask([leaky(i, hits=5) for i in range(N_KEYS)])
        assert all(r.error == "" for r in rs)
        assert {r.remaining for r in rs} == {7}
        pair.join()
        outcome.append(settle(pair, leaky, lambda i: 7))
    assert outcome[0] == outcome[1] == [7] * N_KEYS


def test_failed_delivery_leaves_rows_in_place(pairs, monkeypatch):
    """The newcomer refuses every UpdatePeerGlobals: after three
    attempts per chunk the first daemon keeps every row, in both
    packages, and records a handover of 0 rows."""
    from gubernator_tpu import peer_client as jax_pc
    from gubernator_tpu_torch import peer_client as port_pc

    def refuse(self, updates, *a, **k):
        raise ConnectionError("refused")

    monkeypatch.setattr(port_pc.PeerClient, "update_peer_globals", refuse)
    monkeypatch.setattr(jax_pc.PeerClient, "update_peer_globals", refuse)
    outcome = []
    port, ref = pairs(True)
    for pair in (port, ref):
        pair.ask([token(i, hits=3) for i in range(N_KEYS)])
        seq = pair.first.instance.recorder.events()[-1]["seq"]
        pair.join()
        ev = []
        for _ in range(ATTEMPTS):
            ev = pair.first.instance.recorder.events(kind="handover",
                                                     since_seq=seq)
            if ev:
                break
            time.sleep(0.1)
        errors = pair.first.instance.recorder.events(
            kind="handover_error", since_seq=seq)
        outcome.append((ev[0]["rows"] if ev else None, len(errors)))
    assert outcome[0] == outcome[1] == (0, 3)
    found, _ = port_rows(port.first, token, range(N_KEYS))
    assert found.all()


def test_restart_keeps_the_address_and_starts_afresh(jax_mesh):
    """Cluster.restart(i) stops daemon i and spawns it again on the
    address it had (peer_at), with a fresh table: a key it owned reads
    its full limit again, in both packages."""
    from gubernator_tpu import cluster as jax_cluster
    from gubernator_tpu_torch import cluster

    outcome = []
    for c, cls in ((cluster.start(2, device="cpu"), RateLimitRequest),
                   (jax_cluster.start(2, mesh=jax_mesh), JaxReq)):
        try:
            addr = c.peer_at(1).grpc_address
            k = next(i for i in range(200) if c.owner_daemon_of(
                f"ho_k{i}") is c.daemon_at(1))
            inst = c.instance_at(0)
            before = inst.get_rate_limits([cls(**token(k, hits=3))])[0]
            c.restart(1)
            after = c.instance_at(0).get_rate_limits(
                [cls(**token(k, hits=0))])[0]
            outcome.append((before.remaining, after.remaining,
                            c.peer_at(1).grpc_address == addr,
                            c.owner_daemon_of(f"ho_k{k}") is c.daemon_at(1)))
        finally:
            c.stop()
    assert outcome[0] == outcome[1] == (7, 10, True, True)
