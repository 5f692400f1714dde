#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch port (gubernator_tpu_torch): builds its
CUDA kernels, holds each against its plain PyTorch version at full size,
and drives the port's serving paths through them: the daemon on the
bucket engine (K1), a cluster of bucket-engine daemons, a group of
daemon processes sharing the card behind one client port, two regions
replicating MULTI_REGION hits, a daemon alone serving its hottest
GLOBAL keys from the hot set, daemons whose peers come from a peers
file and from gossip, a pair forwarding over TLS, the daemon on the
classic SoA engine (K2), and a daemon whose 10M keys outgrow its table,
served by the cold tier behind it.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # full size: 10M keys on each path
    python3 chip_smoke.py --only hot,membership,gossip   # those phases
    python3 chip_smoke.py --only main,cluster   # phase 5, the cluster

Phases (each prints a line with its seconds; any failure exits non-zero):

1. device: the card's name and nvidia-smi's name / power limit;
2. build: K1, K2 and K3 (gubernator_tpu_torch/csrc/*.cu) with nvcc for
   sm_90a, one nvcc per source, started together, and the host wire
   library (csrc/wire.cpp) with the host C++ compiler;
3. probe: K3 (the toolchain probe, an int32 add) against x + y on the
   (8, 128) input of tools/pallas_probe.py and on 2^24 elements;
4. kernel vs plain: a 2^25-row (4 GiB) bucket table holding 10M keys,
   then --waves (4) mixed waves of 8192 rows and one of 1024 (the
   bucket path's two wave widths; Zipf(1.1) keys, TOKEN and LEAKY, RESET
   / DRAIN / Gregorian, queries, duplicates, per-row now, one crafted
   bucket-full wave), then --main-waves (2) waves of 8192 rows of the
   main path's own traffic (Zipf(1.1) over the same keys, hits 1, one
   TOKEN config, per-row now spread like coalesced callers), through
   decide_cuda and decide_plain
   on two copies of the table: outputs, counters and the whole table
   must be equal.  Each wave prints K1's hot segments, its longest slot
   chain, and the requests it took in closed form and one by one; K1's
   launch alone is timed on a mixed and on a main-path wave;
5. main path: spawn_daemon on the GPU (bucket engine), the HTTP verify
   flow (and, where grpcio imports, the same flow over gRPC; else the
   line "grpc: not installed"), then rounds of 8 threads of
   1000-request Zipf(1.1) batches through V1Instance.get_rate_limits
   against a 10M-key table, checked per key; each round prints its
   decisions/s and latencies, every dispatcher wave and every garbage
   collection is timed on the host, and a last, shorter round runs
   under torch.profiler for the device's busy share.  K1's launch count
   must grow;
   wire path (on the same instance and table): the same traffic,
   serialized to GetRateLimitsReq bytes by the port's encoder before
   the clock starts, through V1Instance.get_rate_limits_wire (the C++
   ingest, inline, coalesced or pipelined waves, responses built as
   bytes in the callers' threads), decoded by this script and checked
   per key with the same tally; each round also prints the share of
   waves run inline, the wave pool's hits / misses / leaks (leaks must
   be 0) and the longest gen-2 collection.  K1's launch count must
   grow.
   The daemon's dispatcher runs its default on the card: the launch /
   sync pipeline (``packed_pipelined`` waves, no inline wave); at least
   one wave must launch behind another (ring slot 1).  Then:
   metrics: /metrics scraped over HTTP after the object rounds must
   count the api requests and OVER_LIMIT answers this script sent and
   saw since the daemon started (warm-up and verify flows included),
   as many wave durations as the dispatcher reports waves, and no
   leaked wave lease; /healthz?deep=1 after the wire rounds: not
   stalled, no timeout, nothing queued, the pipeline at its depth;
   the wire path again with GUBER_PIPELINE=0 (the dispatcher rebuilt on
   the same engine and table), checked per key, printed beside the
   pipelined rounds (rates, p50 / p99, inline share, the worker's lock
   wait);
   topkeys: /debug/topkeys after those rounds (every tap folded first):
   the TOPKEYS_CHECKED hottest ranks present, each count at most the
   hits sent plus its err and, with no tap dropped, at least the hits
   sent; the taps dropped are printed;
   analytics on / off, by the reference's method (bench.py ›
   _analytics_ab): on the wire lane and on the object lane, one untimed
   warm-up pair, then ANALYTICS_AB_PAIRS pairs of 8 x AB_BATCHES batches
   with the analytics on and detached (the instance's taps and device
   tap unhooked, as JAX's bench detaches them), the worker flushed
   before each detached arm; printed: each pair's off / on ratio, their
   median (the overhead), both rates and the taps dropped; then the
   fold's move alone (AB_PAIRS pairs): the analytics on in both arms,
   the Python fold against the native, the worker flushed before each
   arm (the median of the per-pair native / python ratios); then the
   analytics tap's own cost (gubernator_tpu_torch/cmd/tapcost.py on
   TAP_COST_WAVES object-lane waves: the list tap against the columnar
   tap, the serving thread's µs and the worker's CPU µs a wave); then
   key hashing native / plain: the same pairs on the object lane, the
   dispatcher's hash swapped for its Python loop in the plain arm; then
   one object round of 8 x
   profile-batches with the analytics on and one detached, each under a
   host profile (the CPU seconds of the dispatcher's and the analytics'
   workers, a stack sample every 5 ms);
   observability, after the timed rounds: one object round of 8 x
   AB_BATCHES batches, after which the tenant ledger's requests, hits,
   OVER_LIMIT and error rows grew by exactly the round's (flushed, no
   tap dropped); /debug/memory's device_bytes equal to the table's
   tensors' nbytes, printed beside torch.cuda.memory_allocated(), and
   ?advise=1 splitting exactly the row budget; /debug/slo's verdicts,
   none breached or burning; TRACE_BATCHES gRPC batches of TRACE_ROWS
   rows from one caller with sampled traceparents (the recorder's rate
   at 1): each commits one tree, the handler's span over its wave,
   whose phase children partition it exactly (the wave's share of the
   handler's time printed), then as many at the default rate 0, which
   record nothing; /debug/profile?seconds=PROFILE_S while 8 callers
   send wire batches, its rate beside a round of the same size without
   a capture, a second request answered 409, and the capture's Chrome
   trace naming K1's kernel (decide_kernel);
   admission: one round of wire traffic with the admission bound at
   ADMISSION_ROWS rows: some batches must shed (ResourceExhausted,
   queue_full), the admitted ones are checked per key, and the shed
   counter must equal the rows shed;
   drain: the daemon closes with a DRAIN_GRACE_MS drain window: within
   it /healthz answers 503 "draining" and a request still serves; after
   it a request sheds with "draining", and the flight recorder holds
   drain_started and drain_completed;
cluster: 3 daemons in this process (cluster.start_with), each with a
   2^24-row bucket table on the card and real gRPC over loopback; the
   10M keys made resident on their owners by the ring; 8 callers each
   sending phase 5's 1000-request batches to daemon (caller mod 3)
   through its gRPC front door, the keys of the 16 hottest ranks GLOBAL
   (limit 100) and of the next 16 GLOBAL with a limit of 10^9; 2 timed
   rounds of 8 x 100 batches and a profiled one of 8 x 20.  Checked:
   every non-GLOBAL key exact (phase 5's tally), touched keys held by
   their owner alone, GLOBAL keys converged on every daemon (hits=0
   probes, polled by attempt, with every queued GLOBAL hit flushed):
   the same remaining as the owner's, and on the 10^9 keys exactly the
   limit less the hits the callers sent; no failed forward or hits
   flush, no leak; each daemon launched K1.
   Prints each round's decisions/s, latencies and call breakdown, the
   share of the solo wire path's rate, the forwarded share, peer
   flushes, GLOBAL hits, broadcasts and over-admission.  The daemons run
   the JAX package's BehaviorConfig defaults (degraded serves and the
   health-gated ring on); no row of a healthy round may come back
   degraded.  Their SLO windows are CLUSTER_SLO_WINDOWS (10 s / 30 s).
   Once the GLOBAL queues drained: CLUSTER_TRACES batches of
   non-GLOBAL rows of every owner, sampled, one after another through
   daemon 0, each assembled (tracing.assemble over the three
   /debug/traces) into one tree: the handler's span, its wave, a
   peer.forward hop and under it the owner's grpc.GetPeerRateLimits and
   wave; /debug/audit on every daemon at drift 0, fold_audits
   conserved; /debug/costmodel holding broadcast and peer_flush
   samples.
   outage (on the same daemons and tables): daemons 0 and 1 arm
   peer_send@<daemon 2>:error through POST /debug/faults and 8 callers
   send the same traffic to them only (caller mod 2), with 64 keys of
   daemon 2 (OUTAGE_KEYS) at a limit of 10^9.  Windows: degraded (the
   failed forwards answered degraded, until just before the first
   health gate may eject daemon 2: no batch is in flight when a gate
   flips), rehomed (one timed round of --outage-batches once both gates
   ejected it), recovered (one timed round once the faults are cleared
   and both gates readmitted it; the callers pause across each flip,
   and a hits=0 request on a daemon's own key reads its gate).  Prints
   each window's decisions/s, p50 / p99, rows degraded and error rows,
   the ms from arming to ring_ejected and from clearing to
   ring_readmitted, the ring generations, gubernator_degraded_served
   and _fault_injected, the ms until the GLOBAL hit queues drained, K1
   launches and the over-admission of daemon 2's limit-100 keys.
   Checked: no error row but `rate limit table full` on a key of daemon
   2 where it never lived, degraded rows in the first two windows and
   none in the third, the degraded counter equal to the rows flagged,
   two generation bumps on daemons 0 and 1, the 64 keys on daemon 2 at
   exactly 10^9 less the hits sent, daemons 0 and 1's own keys exact,
   no leak.  The SLO plane: once every SLO of daemons 0 and 1 cooled
   (the GLOBAL rounds may have burned fleet_conservation),
   cmd/healthcheck.py --fail-on-burn exits 0 on both before the arming;
   at the end of each window error_ratio's fast and slow burns, its
   breach and the seconds from arming to its breach event, and the
   fleet_conservation SLO's value (hits parked for daemon 2) are
   printed; in the degraded window --fail-on-burn exits 1 exactly when
   the daemon is unhealthy or error_ratio breached; the degraded serves'
   traces are kept at sample 0 (forced), and the tenants count the
   degraded rows gubernator_degraded_served counts;
   handover: a 4th daemon (2^22 rows) joins with handover_on_reshard on
   all four (set_peers on each); every moved row it placed equals its
   state before the join, the rows its full buckets refused are exactly
   its dropped_rows count and the count its buckets predict, and no old
   owner still holds a moved row; prints the step's ms and rows moved;
   then the cluster closes with GUBER_DEBUG_DUMP_DIR set: each daemon
   leaves its event ring with its SLO verdicts, and the three cluster
   daemons their spans, as JSONL;
   group: GROUP_NODES daemon processes (cluster.start_subprocess_group:
   each its own interpreter and a 2^24-row bucket engine on the card,
   the kernels built first by this process), one SO_REUSEPORT client
   port, the cluster phase's 10M keys restored on their ring owners
   from a snapshot per worker and its traffic from 8 callers, each on a
   connection of its own (kept so that every worker holds at least
   one); prints decisions/s and p50 / p99 beside the in-process
   cluster's and the solo wire path's rates, each worker's client
   requests and forwarded rows from its /metrics (every worker must
   answer some) and its K1 launches from /debug/kernels; the 10^9 keys
   must read exactly the limit less the hits sent on every worker.
   Then the last worker is SIGKILLed while the callers send (a caller
   whose connection dies retries its batch on a new one): prints the
   ms until each survivor ejects it, the rows flagged degraded (equal
   to gubernator_degraded_served), the calls that failed at the
   transport and were retried; no error row but `rate limit table full`
   on a key of the dead worker, and the survivors' own keys exact (but
   those of a retried batch, whose first try may have applied);
   regions: 2 regions x 2 daemons in this process (dc-east, dc-west),
   2^24 rows each, phase 5's keys restored on their owner in each
   region, 8 callers over gRPC split across both regions, the 16
   hottest ranks MULTI_REGION at limit 100 (over-admission printed)
   and the next 16 at 10^9: after the sync wait and the send deadline
   (REGION_BEHAVIOR_OVERRIDES) each 10^9 key reads on its owner in each
   region exactly the limit less the hits sent to both; a further
   quiet wait changes nothing (no ping-pong); an armed mr_sync tick on
   every daemon holds every hit sent meanwhile and loses none; every
   other key exact in its region; prints decisions/s, p99 and the ms
   from the end of the traffic until every key read exact.  Then one
   more round at the default send deadline (900 ms), measured, not
   held exact: once the queues are empty and the counters still, the
   failed sends and the hits each region's 10^9 keys lost (none may
   read below the hits sent: a hit counted twice stops the run);
   hot: one daemon alone (2^cluster-log2-cap rows, the hot set's JAX
   defaults: capacity 1024, threshold 64) and an identical one at
   hot_set_capacity 0 (JAX's off), the cluster phase's traffic (the 16
   hottest ranks GLOBAL at limit 100, the next 16 at 10^9) on the object
   lane (in-process) and over gRPC on the wire lane, HOT_AB_PAIRS
   interleaved pairs a lane of 8 x HOT_BATCHES batches after a warm-up
   pair; prints decisions/s, p50 / p99, the median per-pair on / off
   ratio and its spread, promotions, the hot waves and their ms (host
   clock, CUDA events), K1 launches.  Checked: every GLOBAL rank hit 64
   times pinned; the limit-100 keys admitted exactly 100 on both (one
   replica: no over-admission); after a sync the 10^9 keys at exactly
   the limit less the hits sent; every other key exact.  Then the
   demotions: a RESET_REMAINING request (flagged), a new limit whose
   consumed hits carry into the table (config_change), remove() (JAX
   counts none), and a snapshot (membership_change = the keys pinned;
   every pinned row in the file and restored equal);
   membership: a TLS pair and a plaintext pair (2^member-log2-cap rows),
   each on file discovery over its own peers file, the certificates
   (a CA, a server certificate for 127.0.0.1 / localhost) written with
   cryptography or else openssl (neither stops the run); daemon A of
   the TLS pair alone takes GLOBAL traffic over TLS until every GLOBAL
   rank is pinned, then each file is rewritten with both daemons:
   prints the ms from the write to each daemon's new ring; every pinned
   key demoted with its row equal in A's table.  Then TLS_PAIRS
   interleaved pairs of the cluster traffic (8 x MEMBER_BATCHES
   batches, callers over gRPC to both daemons of a pair), TLS against
   plaintext: decisions/s of both, forwarded rows, no failed forward,
   every non-GLOBAL key exact; a plaintext client is refused by the TLS
   daemon (UNAVAILABLE);
   gossip: GOSSIP_NODES daemons on member-list discovery over localhost
   UDP (the gRPC port + 1): the ms until every ring holds all of them,
   then the ms until the others drop a closed one (the default dead_ms,
   15 s) and their rings hold the rest.  DNS, etcd and k8s discovery
   run in the CPU tests only: this machine has no resolver records, etcd
   or API server to point them at;
6. sweep vs plain: a 2^24-row SoA table holding 10M keys (placed with
   upsert_rows; ~30% expired, some removed) swept by K2 and by its
   plain version on two copies: key and expire_at equal, the other
   columns untouched, the live counts equal.  K2 is then timed on
   fresh copies, each followed by 128 MiB of writes and reads that flush
   the L2 cache: device time (the stream spins while the host calls
   sweep_cuda; the kernels line's "ms") and one call on an idle stream
   (the wrapper's host work inside, "one_call_ms");
7. classic main path: spawn_daemon with GUBER_ENGINE=xla on the GPU
   (2^24 rows, auto-grow to 2^25, a short sweep interval), the HTTP
   verify flow and a 2^40 limit, a 10M-key table (restored; a share
   expired), then rounds of 8 threads of 1000-request Zipf(1.1) batches
   over the live keys the table holds plus 3% brand-new keys (inserts,
   the table-full retry, the auto-grow), with an on-device grow to twice
   the rows between the rounds, checked per key and per grow (a grow
   drops few rows, and only the keys it dropped may restart), and a
   last, shorter round under torch.profiler.  Every decision step is
   timed alone with CUDA events; then one shorter checked round of
   the same traffic as wire bytes through get_rate_limits_wire (the
   pipeline on), and one more with GUBER_PIPELINE=0, printed side by
   side.  K2's launch count must grow across the object and wire rounds.
8. tiers: a daemon on the bucket engine with GUBER_TIER_COLD=1, the
   analytics on and a snapshot path, its table 2^23 rows (1 GiB, a
   quarter of phase 5's; the one cut, so the 10M keys outgrow it).
   The FileLoader writes the 10M-key population (TOKEN rows as phase 5
   has them, every 10th LEAKY, every 100th at a limit of 2^40) and the
   daemon restores it: the rows on the device plus the cold rows must
   be every row written, none dropped, each row in the tier its bucket
   predicts (every 2^40 row cold); prints the file's load and the
   restore ms, and the item path against the column path on 1M rows.
   Then rounds of phase 5's wire traffic (2 timed of 8 x 100, a
   profiled 8 x 20), every key exact whatever its tier, each printing
   decisions/s, p50 / p99, cold-served rows and their share,
   promotions, demotions, aborted migrations and the resolve ms;
   promotions and K1 launches must be > 0.  Every cold key a resolve
   offers for promotion is logged with the rank it read and the
   outcome (untracked, under the threshold, outside K1's domain, no
   colder victim, aborted, promoted), printed by the key's population
   rank (``tiers admission:``).  Then 2^40 requests on new
   keys through both lanes, answered exactly from the cold tier;
   remove() of a device and a cold key (gone, the next request fresh);
   close() writes the snapshot (ms, bytes) and a second daemon restores
   both tiers equal, row for row; last, an object-lane round with a
   counting Store on a small instance with the cold tier (on_change =
   answers, get = misses, each key in one tier) and the same traffic
   as wire bytes through the object path, answering the same.

The line before the last is a JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
#: the device every phase uses (a CPU rehearsal of the phase functions
#: sets "cpu" and stands the plain step in for K1)
DEVICE = "cuda"
NOW0 = 1_760_000_000_000
#: bytes a request moves besides its bucket: 76 B of packed request
#: columns in (8 int64 + 3 int32), 29 B of outputs (status int32,
#: remaining / reset_time / limit int64, err bool)
REQ_BYTES = 76 + 29
#: a touched bucket is read and written once; K1 moves only the 16 used
#: words (64 B) of each of its 8 slots
BUCKET_BYTES = 2 * 8 * 16 * 4
#: GPU cycles (~1 ms) the stream spins (torch.cuda._sleep) before a timed
#: launch, so that the host has queued the launch before the start event
#: completes and the event span is device time only
SLEEP_CYCLES = 2_000_000
#: bytes a timed sweep's set-up writes and reads after copying the table:
#: more than twice the H100's 50 MB L2, so the sweep reads its rows from
#: HBM
L2_FLUSH_BYTES = 128 << 20
#: the answer to a request whose probe window stayed full
TABLE_FULL = "rate limit table full"
#: most rows a grow may drop, as a share of the rows it re-places: an
#: H100 dropped 25 of ~8M live rows (3e-6) growing 2^24 -> 2^25 in this
#: script's classic phase (PERF.md); a grow losing more is a fault
GROW_DROP_MAX_SHARE = 1e-4
#: share of each classic batch sent to brand-new keys (inserts)
FRESH_SHARE = 0.03
#: how long the cluster phase polls for its GLOBAL keys to converge
CONVERGE_S = 60.0
#: rows the admission round lets queue before it sheds: under one
#: round's backlog (8 callers' 1000-row batches)
ADMISSION_ROWS = 1500
#: the phase-5 daemon's drain window (DaemonConfig.drain_grace_ms)
DRAIN_GRACE_MS = 2000
#: daemons in the cluster phase (gubernator's own functional cluster)
CLUSTER_NODES = 3
#: the hottest Zipf ranks whose requests are GLOBAL with the TOKEN
#: config's limit: their over-admission is printed
GLOBAL_RANKS = 16
#: the next ranks, GLOBAL with a limit above any run's hits: their
#: remaining never saturates, so after convergence every daemon must
#: read exactly EXACT_GLOBAL_LIMIT - the hits the callers sent
EXACT_GLOBAL_RANKS = 16
EXACT_GLOBAL_LIMIT = 10 ** 9
#: BehaviorConfig fields the cluster overrides; empty on the card (the
#: JAX package's defaults: fallback and gate on, eject and readmit at
#: 3000 ms, circuit cooldown 2000 ms); a CPU rehearsal shortens them
CLUSTER_BEHAVIOR_OVERRIDES: dict = {}
#: keys owned by daemon 2 whose debits the outage phase reads exactly
OUTAGE_KEYS = 64
OUTAGE_LIMIT = 10 ** 9
#: the degraded window's callers stop this long before the first health
#: gate is due to eject daemon 2, so that no batch is in flight when a
#: gate flips (a row rehomed to a daemon whose gate has not flipped yet
#: is absorbed into its shard: the documented transition window)
OUTAGE_MARGIN_S = 1.0
#: batches per caller available to the degraded window
OUTAGE_MAX_BATCHES = 200
#: how long a gate flip or a handover may take before the run stops
FLIP_S = 60.0
HANDOVER_S = 900.0
#: the subprocess group's worker processes, the seconds its callers send
#: before one is SIGKILLed and after both survivors ejected it, and the
#: most batches a caller has ready for that window
GROUP_NODES = 3
GROUP_KILL_WARM_S = 1.0
GROUP_KILL_AFTER_S = 2.0
GROUP_KILL_MAX_BATCHES = 400
#: the regions phase: its regions, daemons a region, and the hottest
#: ranks sent MULTI_REGION at limit 100, then at EXACT_GLOBAL_LIMIT
REGIONS = ("dc-east", "dc-west")
REGION_NODES = 2
MR_RANKS = 16
EXACT_MR_RANKS = 16
#: the regions' send deadline while every hit is checked: the JAX
#: package's MULTI_REGION tests' 5 s (a send that outlives it loses its
#: hits, in both packages, and the default 900 ms is within reach of a
#: queue of 8 callers' batches); a last round at the default measures
#: the hits its failed sends lose
REGION_BEHAVIOR_OVERRIDES = dict(multi_region_timeout_ms=5000)
#: interleaved A/B pairs after the warm-up pair, and batches per caller
#: in each arm (bench.py › _analytics_ab's discipline)
AB_PAIRS = 5
AB_BATCHES = 10
#: the analytics on / off pairs (the tap's overhead: its spread between
#: runs needs more pairs than the other A/Bs)
ANALYTICS_AB_PAIRS = 9
#: the hot phase: the interleaved pairs of a lane (default hot set
#: against hot_set_capacity 0) and each arm's batches a caller
HOT_AB_PAIRS = 3
HOT_BATCHES = 20
#: object-lane waves of 1000 rows the tap's own cost is measured on
TAP_COST_WAVES = 200
#: gubernator_hotset_demotions' reasons
HOT_REASONS = ("flagged", "config_change", "membership_change")
#: the membership phase: TLS / plaintext pairs and each arm's batches a
#: caller
TLS_PAIRS = 3
MEMBER_BATCHES = 20
#: the gossip phase's daemons
GOSSIP_NODES = 3
#: /debug/topkeys after phase 5: the hottest ranks checked, out of the
#: keys the document is asked for
TOPKEYS_CHECKED = 16
TOPKEYS_LIMIT = 64
#: phase 5's trace check: batches sent sampled, then as many unsampled,
#: one caller, rows a batch
TRACE_BATCHES = 100
TRACE_ROWS = 100
#: phase 5's profile capture: its seconds, and the batches a caller
#: sends in the round timed with it and in the one timed without
PROFILE_S = 2
PROFILE_BATCHES = 30
#: the tenant ledger's own A/B (tenants on / detached), pairs a lane
TENANT_AB_PAIRS = 3
#: the cluster phase's sampled forwards, sent one after another
CLUSTER_TRACES = 10
#: the cluster's SLO burn windows (GUBER_SLO_FAST / GUBER_SLO_SLOW; JAX's
#: defaults are 1 and 5 minutes), short enough that an SLO the healthy
#: rounds burned cools before the outage, within SLO_COOL_S
CLUSTER_SLO_WINDOWS = ("10s", "30s")
SLO_COOL_S = 30.0
#: the cluster's decision_p99 target where GUBER_SLO_P99_MS sets none
#: (JAX's default is 250 ms): three daemons in one interpreter share its GIL, and a wave's
#: device phase, launch to sync, takes those waits in (the healthy
#: rounds breached 250 ms on the card)
CLUSTER_SLO_P99_MS = "1000"
#: the tiers phase's population: every TIER_LEAKY_EVERY-th row LEAKY,
#: every TIER_OOD_EVERY-th at a limit of OOD_LIMIT (outside K1's domain)
TIER_LEAKY_EVERY = 10
TIER_OOD_EVERY = 100
OOD_LIMIT = 1 << 40
#: rows of the item path against the column path (a Loader's items are
#: Python objects: the whole population would take minutes)
ITEM_PATH_ROWS = 1_000_000


def require(ok, what: str) -> None:
    """A check that also holds under python -O."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s", flush=True)


def smoke_hashes(idx: np.ndarray) -> np.ndarray:
    """Vectorized hash of the keys "smoke_k%08d" % idx: FNV-1a over the
    fixed-width bytes, then the port's finalizer (held against
    hash_request_keys on a sample in main)."""
    from gubernator_tpu_torch.hashing import fnv1a64, mix64_np

    h = np.full(len(idx), fnv1a64(b"smoke_k"), np.uint64)
    prime = np.uint64(0x100000001B3)
    for p in range(7, -1, -1):
        digit = (idx // 10 ** p) % 10 + ord("0")
        h = (h ^ digit.astype(np.uint64)) * prime
    x = mix64_np(h)
    return np.where(x == 0, np.uint64(1), x)


def zipf_ranks(rng, a: float, n_keys: int, size: int) -> np.ndarray:
    """Zipf(a) ranks over [0, n_keys), by rejection of the tail."""
    out = np.empty(0, np.int64)
    while len(out) < size:
        z = rng.zipf(a, size=2 * size)
        out = np.concatenate([out, z[z <= n_keys] - 1])
    return out[:size]


def fit_population(n_keys: int, log2_cap: int):
    """n_keys key indices (and hashes) that all fit their 8-slot bucket
    of a 2^log2_cap-row table beside the keys the main path inserts
    itself (the daemon's warm-up key and the HTTP flow's): indices past
    a bucket's room are skipped, so every population key is resident
    after the fill."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    reserved = hash_request_keys(["_warmup", "api"], ["w", "u1"])
    idx = np.arange(int(n_keys * 1.002) + 1000, dtype=np.int64)
    keys = np.concatenate([reserved, smoke_hashes(idx)])
    bucket = (keys & np.uint64((1 << (log2_cap - 3)) - 1)).astype(np.int64)
    sel = np.nonzero(bucket_fit(bucket)[len(reserved):])[0][:n_keys]
    return idx[sel], keys[len(reserved):][sel]


def bucket_fit(bucket: np.ndarray) -> np.ndarray:
    """Mask of the entries that find room in their 8-slot bucket when
    the entries are placed in order."""
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    start = np.r_[True, sb[1:] != sb[:-1]]
    pos = np.arange(len(sb))
    rank = pos - np.maximum.accumulate(np.where(start, pos, 0))
    keep = np.zeros(len(bucket), bool)
    keep[order[rank < 8]] = True
    return keep


def fit_cluster_population(n_keys: int, log2_cap: int, ring):
    """n_keys key indices, hashes and owners (indices into
    ``ring.owner_peers()``) such that every key fits its 8-slot bucket in
    its owner's 2^log2_cap-row table beside the daemons' warm-up key:
    the keys are placed by the ring, as the cluster routes them."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    n_own = len(ring.owner_peers())
    warm = hash_request_keys(["_warmup"], ["w"])
    idx = np.arange(int(n_keys * 1.002) + 1000, dtype=np.int64)
    keys = smoke_hashes(idx)
    owners = ring.owner_indices(keys)
    nb = 1 << (log2_cap - 3)
    bucket = (np.concatenate([np.arange(n_own), owners]).astype(np.int64)
              * nb + (np.concatenate([np.repeat(warm, n_own), keys])
                      & np.uint64(nb - 1)).astype(np.int64))
    sel = np.nonzero(bucket_fit(bucket)[n_own:])[0][:n_keys]
    return idx[sel], keys[sel], owners[sel]


def token_rows(keys, limit, duration, t0, remaining=None):
    n = len(keys)
    dur = np.broadcast_to(np.asarray(duration, np.int64), (n,)).copy()
    lim = np.broadcast_to(np.asarray(limit, np.int64), (n,)).copy()
    return {"key": keys, "meta": np.zeros(n, np.int32), "limit": lim,
            "burst": lim.copy(), "duration": dur, "eff_ms": dur.copy(),
            "remaining": lim.copy() if remaining is None else remaining,
            "t_ms": np.full(n, t0, np.int64), "expire_at": t0 + dur}


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    return name, smi


def phase_build():
    from gubernator_tpu_torch.ops import build

    build.load_library()
    info = build.build_info
    print(f"K1, K2, K3 build: {info['seconds']:.2f} s "
          f"(compiled={info['built']}) -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            print("  ptxas:", line.strip(), flush=True)
    t0 = time.perf_counter()
    lib = build.load_wire_library()
    print(f"wire library build: {time.perf_counter() - t0:.2f} s "
          f"({build.cxx_path()}) -> {lib._name}", flush=True)


def make_wave(rng, pop_keys, pop_idx, rows_n, wave_no, log2_cap,
              craft_full_bucket: bool, taken: np.ndarray):
    """One wave of ``rows_n`` rows of mixed traffic as packed numpy
    matrices."""
    from gubernator_tpu_torch.core.batch import pack_columns, pack_wave_host
    from gubernator_tpu_torch.ops.decide import qualifies

    n_keys = len(pop_keys)
    pick = zipf_ranks(rng, 1.1, n_keys, rows_n)
    khash = pop_keys[pick].copy()
    kidx = pop_idx[pick].copy()
    fresh = rng.random(rows_n) < 0.03  # brand-new keys: inserts
    khash[fresh] = rng.integers(1, 2 ** 63, fresh.sum(), dtype=np.int64
                                ).astype(np.uint64)
    kidx[fresh] = rng.integers(0, 1000, fresh.sum())
    alg = (kidx % 2).astype(np.int32)
    alg ^= (rng.random(rows_n) < 0.01).astype(np.int32)  # algorithm switch
    limit = 20 + kidx % 50
    limit += 5 * (rng.random(rows_n) < 0.02)  # limit change
    duration = np.where(kidx % 7 == 0, 5_000, 60_000)
    duration = np.where(rng.random(rows_n) < 0.02, 90_000, duration)
    behavior = np.zeros(rows_n, np.int32)
    behavior |= 8 * (rng.random(rows_n) < 0.02)  # RESET_REMAINING
    behavior |= 32 * (rng.random(rows_n) < 0.03)  # DRAIN_OVER_LIMIT
    greg = rng.random(rows_n) < 0.02
    behavior |= 4 * greg  # DURATION_IS_GREGORIAN: duration is an ordinal
    duration = np.where(greg, rng.integers(0, 3, rows_n), duration)
    hits = np.where(rng.random(rows_n) < 0.1, 0,
                    rng.integers(1, 4, rows_n))
    if craft_full_bucket:
        # 12 new keys into the bucket of an existing key: overflow
        nb_mask = (1 << (log2_cap - 3)) - 1
        b = int(pop_keys[0]) & nb_mask
        hi = rng.integers(1, 2 ** 30, 12).astype(np.uint64)
        khash[:12] = (hi << np.uint64(log2_cap)) | np.uint64(b)
        alg[:12], hits[:12], behavior[:12] = 0, 1, 0
    base = NOW0 + 1_000 + 2_000 * wave_no
    created = base + np.sort(rng.integers(0, 2_000, rows_n))
    batch, errs = pack_columns(khash, hits, limit, duration, alg, behavior,
                               limit.copy(), base, created_at=created)
    require(not errs and qualifies(batch), "wave outside the kernel domain")
    taken[wave_no] = created[-1]
    return pack_wave_host(batch)


def make_main_wave(rng, pop_keys, rows_n, wave_no, taken: np.ndarray):
    """One wave of the main path's traffic (phase 5's requests: hits 1,
    limit 100, a one-hour TOKEN window) as packed numpy matrices."""
    from gubernator_tpu_torch.core.batch import pack_columns, pack_wave_host
    from gubernator_tpu_torch.ops.decide import qualifies

    khash = pop_keys[zipf_ranks(rng, 1.1, len(pop_keys), rows_n)]
    zeros = np.zeros(rows_n, np.int32)
    limit = np.full(rows_n, 100)
    base = NOW0 + 1_000 + 2_000 * wave_no
    created = base + np.sort(rng.integers(0, 2_000, rows_n))
    batch, errs = pack_columns(khash, np.ones(rows_n, np.int64), limit,
                               np.full(rows_n, 3_600_000), zeros, zeros,
                               limit.copy(), base, created_at=created)
    require(not errs and qualifies(batch), "wave outside the kernel domain")
    taken[wave_no] = created[-1]
    return pack_wave_host(batch)


def time_launch(torch, launch, reps: int = 5, spin: bool = True,
                setup=None):
    """(median ms between CUDA events around ``launch()``, median host ms
    of the call) over ``reps`` calls.  ``spin``: the stream spins in
    torch.cuda._sleep while the host makes the call, so the event span
    is device time only; else the events bracket one call on an idle
    stream, the host's part of the launch inside.  ``setup()``, when
    given, runs before each call, outside the span.  In a CPU rehearsal
    both times are the host clock's."""
    times, host = [], []
    for _ in range(reps):
        if setup is not None:
            setup()
        if DEVICE != "cuda":
            t = time.perf_counter()
            launch()
            times.append((time.perf_counter() - t) * 1e3)
            host.append(times[-1])
            continue
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        t = time.perf_counter()
        launch()
        host.append((time.perf_counter() - t) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), float(np.median(host))


def k1_inputs(torch, rows, b, now):
    """A scratch copy of the table, the wrapper's plan of the wave ``b``
    and an output matrix: what a raw K1 launch takes."""
    from gubernator_tpu_torch.ops import decide as dmod

    scratch = rows.clone()
    plan = dmod._plan(scratch, b, now)
    out = torch.zeros((dmod.N_OUT, plan.req.shape[1]), dtype=torch.int64,
                      device=rows.device)
    return scratch, plan, out


def time_raw_launch(torch, rows, b, now, hot=None):
    """K1's launch alone (no sort, no outputs) on the wave ``b``, on a
    scratch copy of the table, segments longer than ``hot`` (default
    HOT_SEGMENT) on the hot path: ``time_launch``'s (device ms, host
    ms)."""
    from gubernator_tpu_torch.ops import decide as dmod
    from gubernator_tpu_torch.ops.build import load_library

    lib = load_library()
    scratch, plan, out = k1_inputs(torch, rows, b, now)
    stream = torch.cuda.current_stream().cuda_stream
    hot = dmod.HOT_SEGMENT if hot is None else hot

    def launch():
        rc = lib.guber_decide(
            scratch.data_ptr(), plan.req.data_ptr(), plan.order.data_ptr(),
            plan.seg_bucket.data_ptr(), plan.seg_start.data_ptr(),
            plan.seg_len.data_ptr(), plan.seg_bucket.numel(),
            plan.req.shape[1], hot, None, out.data_ptr(), stream)
        require(rc == 0, f"K1 launch failed: {rc}")

    return time_launch(torch, launch)


def fill_mixed_table(torch, args, pop_idx, pop_keys):
    """Phase 4's bucket engine: every key of the population restored,
    TOKEN and LEAKY alternating, full buckets at NOW0."""
    from gubernator_tpu_torch.engine import BucketEngine

    eng = BucketEngine(device=torch.device(DEVICE),
                       capacity=1 << args.log2_cap)
    n = len(pop_keys)
    rows = token_rows(pop_keys, 20 + pop_idx % 50,
                      np.where(pop_idx % 7 == 0, 5_000, 60_000), NOW0)
    leaky = pop_idx % 2 == 1
    rows["meta"] = leaky.astype(np.int32)
    rows["remaining"] = np.where(leaky, rows["limit"] * rows["eff_ms"],
                                 rows["limit"])
    t0 = time.perf_counter()
    placed = eng.restore(rows)
    torch.cuda.synchronize()
    print(f"fill: {placed} of {n} keys placed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    require(placed == n, f"fill placed {placed} of {n} keys")
    return eng


def phase4_waves(torch, args, pop_idx, pop_keys):
    """Phase 4's waves in order, as (index, kind, rows, batch, now).
    Kinds: "warm-up" (wave 0, untimed), "mixed" (the timed full waves),
    "small" (one narrow wave, the main path's other width), then
    "main-path" (the main path's own traffic)."""
    from gubernator_tpu_torch.ops import decide as dmod

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed)
    kinds = (["warm-up"] + ["mixed"] * args.waves + ["small"]
             + ["main-path"] * args.main_waves)
    taken = np.zeros(len(kinds), np.int64)
    for w, kind in enumerate(kinds):
        rows_n = args.small_rows if kind == "small" else args.wave_rows
        if kind == "main-path":
            a64, a32 = make_main_wave(rng, pop_keys, rows_n, w, taken)
        else:
            a64, a32 = make_wave(rng, pop_keys, pop_idx, rows_n, w,
                                 args.log2_cap, w == 3, taken)
        b = dmod.batch_from_packed(torch.from_numpy(a64).to(dev),
                                   torch.from_numpy(a32).to(dev))
        yield w, kind, rows_n, b, int(taken[w])


def phase_kernel_vs_plain(torch, args, pop_idx, pop_keys):
    from gubernator_tpu_torch.ops import decide as dmod

    dev = torch.device(DEVICE)
    eng = fill_mixed_table(torch, args, pop_idx, pop_keys)
    rows_k = eng.rows
    rows_p = rows_k.clone()
    k_ms, p_ms, bound_ms, seg_max, max_err = [], [], [], [], 0
    main_ms, main_counts, mixed_counts = [], [], []
    host_ms = {"mixed": [], "main-path": []}
    errs_seen = 0
    stats = torch.zeros(len(dmod.K1_STATS), dtype=torch.int64, device=dev)
    for w, kind, rows_n, b, now in phase4_waves(torch, args, pop_idx,
                                                pop_keys):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        stats.zero_()
        torch.cuda.synchronize()
        ev[0].record()
        t = time.perf_counter()
        ok_ = dmod.decide_cuda(rows_k, b, now, stats=stats)
        host = (time.perf_counter() - t) * 1e3
        ev[1].record()
        ev[2].record()
        op_ = dmod.decide_plain(rows_p, b, now)
        ev[3].record()
        torch.cuda.synchronize()
        for f in ("status", "remaining", "reset_time", "limit", "err",
                  "over_count", "insert_count"):
            a, c = getattr(ok_, f), getattr(op_, f)
            if not torch.equal(a, c):
                raise AssertionError(f"wave {w}: K1 and plain differ in {f}")
            max_err = max(max_err, int((a.to(torch.int64)
                                        - c.to(torch.int64)).abs().max()))
        if not torch.equal(rows_k, rows_p):
            raise AssertionError(f"wave {w}: tables differ after K1/plain")
        errs_seen += int(ok_.err.sum())
        if w == 3:
            require(int(ok_.err.sum()) > 0, "crafted bucket-full wave: no err")
        plan = dmod._plan(rows_k, b, now)
        s_buckets = int(plan.seg_bucket.numel())
        live = int(plan.order.numel())
        seg_max.append(int(plan.seg_len[0]) if s_buckets else 0)
        wave_bound = ((s_buckets * BUCKET_BYTES + live * REQ_BYTES)
                      / HBM_BYTES_PER_S * 1e3)
        counts = dict(zip(dmod.K1_STATS, stats.tolist()))
        if kind in host_ms:
            host_ms[kind].append(host)
        if kind == "mixed":
            k_ms.append(ev[0].elapsed_time(ev[1]))
            p_ms.append(ev[2].elapsed_time(ev[3]))
            bound_ms.append(wave_bound)
            mixed_counts.append(counts)
            mixed = (b, now)
        elif kind == "small":
            small = {"rows": rows_n, "ms": ev[0].elapsed_time(ev[1]),
                     "plain_ms": ev[2].elapsed_time(ev[3]),
                     "bound_ms": wave_bound, "longest_chain": seg_max[-1]}
        elif kind == "main-path":
            main_ms.append(ev[0].elapsed_time(ev[1]))
            main_counts.append(counts)
            main = (b, now)
        print(f"wave {w} ({kind}, {rows_n} rows): equal; K1 "
              f"{ev[0].elapsed_time(ev[1]):.3f} ms, host {host:.3f} ms, "
              f"plain {ev[2].elapsed_time(ev[3]):.1f} ms, "
              f"{s_buckets} buckets, longest segment {seg_max[-1]}, "
              f"hot segments {counts['hot_segments']}, longest slot chain "
              f"{counts['longest_chain']}, closed form "
              f"{counts['closed_form']}, one by one {counts['serial']} "
              f"(hot) + {counts['cold']} (cold), "
              f"err rows {int(ok_.err.sum())}, "
              f"over {int(ok_.over_count)}, inserts "
              f"{int(ok_.insert_count)}, bytes bound {wave_bound:.6f} ms",
              flush=True)
    launch_ms, launch_host_ms = time_raw_launch(torch, rows_k, *main)
    launch_mixed_ms, launch_mixed_host_ms = time_raw_launch(torch, rows_k,
                                                            *mixed)
    del rows_p, eng
    torch.cuda.empty_cache()
    host = {k: float(np.mean(v)) for k, v in host_ms.items()}
    res = {"ms": float(np.mean(k_ms)), "plain_ms": float(np.mean(p_ms)),
           "bound_ms": float(np.mean(bound_ms)), "launch_ms": launch_ms,
           "launch_mixed_ms": launch_mixed_ms,
           "launch_host_ms": launch_host_ms,
           "launch_mixed_host_ms": launch_mixed_host_ms,
           "decide_cuda_host_ms": host["mixed"],
           "decide_cuda_main_host_ms": host["main-path"],
           "main_wave_ms": main_ms, "main_wave_counts": main_counts,
           "mixed_wave_counts": mixed_counts,
           "max_abs_err": max_err, "waves": args.waves,
           "main_waves": args.main_waves,
           "longest_chain_max": max(seg_max), "err_rows": errs_seen,
           "small_wave": small}
    print(f"K1 per {args.wave_rows}-row wave: decide_cuda {res['ms']} "
          f"ms on the mixed waves, {float(np.mean(main_ms))} ms on the "
          f"main-path waves (host clock {host['mixed']} / "
          f"{host['main-path']} ms); kernel launch alone {launch_mixed_ms} "
          f"ms (mixed), {launch_ms} ms (main path), device time, the "
          f"host's call {launch_mixed_host_ms} / {launch_host_ms} ms; plain "
          f"{res['plain_ms']} ms, bytes bound {res['bound_ms']} ms; per "
          f"{args.small_rows}-row wave: decide_cuda {small['ms']} ms, "
          f"plain {small['plain_ms']} ms, bytes bound {small['bound_ms']} "
          f"ms", flush=True)
    return res


def phase_main_path(torch, args, pop_idx, pop_keys):
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.types import RateLimitRequest

    limit, duration = 100, 3_600_000
    pauses: list = []
    on_gc = time_gc(pauses)
    gc.callbacks.append(on_gc)
    decide_cuda.launches = 0
    grpc = grpc_version()
    d = spawn_daemon(DaemonConfig(
        http_listen_address="127.0.0.1:0",
        grpc_listen_address="127.0.0.1:0" if grpc else "",
        cache_size=1 << args.log2_cap, batch_rows=1024, device=DEVICE,
        drain_grace_ms=DRAIN_GRACE_MS))
    inst = d.instance
    key_of = lambda r: f"k{pop_idx[r]:08d}"  # noqa: E731
    try:
        # the /metrics tally: the daemon's warm-up request, then the
        # verify flows (over gRPC too: every wire lane counts as api)
        api, over = 1, 0
        for flow in [http_verify_flow] + ([grpc_verify_flow] if grpc else []):
            n, o = flow(d.grpc_port if flow is grpc_verify_flow
                        else d.http_port)
            api += n
            over += o

        t0 = time.perf_counter()
        fill_t = int(time.time() * 1000) - 1_000
        with inst._engine_mu:
            placed = inst.engine.restore(
                token_rows(pop_keys, limit, duration, fill_t))
        print(f"fill: {placed} TOKEN keys in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        require(placed == len(pop_keys), f"fill placed {placed} keys")

        timer = WaveTimer(inst)
        rng = np.random.default_rng(args.seed + 1)
        tally = Tally(limit)
        rounds = []
        # the last round runs under torch.profiler and counts apart
        for rnd in range(args.rounds + 1):
            profiled = rnd == args.rounds
            n_b = args.profile_batches if profiled else args.batches
            per = [[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
                    for _ in range(n_b)] for _ in range(args.threads)]
            jobs = [[[RateLimitRequest(name="smoke", unique_key=key_of(r),
                                       hits=1, limit=limit,
                                       duration=duration)
                      for r in ranks] for ranks in thread]
                    for thread in per]
            device = None
            if profiled:
                out, device = profile_device(
                    torch, lambda: drive(inst.get_rate_limits, jobs))
            else:
                out = drive(inst.get_rate_limits, jobs)
            t0, wall, lat, results = out
            tally.add(per, results)
            rounds.append((t0, wall, lat, sum(
                len(b) for resps in results.values() for b in resps), device))
        launches = decide_cuda.launches
        metrics = check_metrics(d, api + tally.n_req, over + tally.over)

        def wire_per(n_rounds, profiled_last):
            return [[[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
                      for _ in range(args.profile_batches if last
                                     else args.batches)]
                     for _ in range(args.threads)]
                    for last in [False] * n_rounds + [True] * profiled_last]

        with phase("wire path"):
            # the same traffic as wire bytes, on the same table and keys,
            # through the default (pipelined) dispatcher
            decide_cuda.launches = 0
            inline = time_inline(inst.dispatcher)
            wire = wire_rounds(torch, inst, wire_per(args.rounds, True),
                               key_of, limit, duration, profile_last=True)
            wire_launches = decide_cuda.launches
            for rec in wire:
                tally.add(rec["per"], rec["results"])
            health = check_deep_health(d)
        with phase("wire path, pipeline off"):
            with pipeline_env("0"):
                rebuild_dispatcher(inst, timer)
            decide_cuda.launches = 0
            time_inline(inst.dispatcher, inline)
            off = wire_rounds(torch, inst, wire_per(args.rounds, False),
                              key_of, limit, duration, profile_last=False)
            off_launches = decide_cuda.launches
            for rec in off:
                tally.add(rec["per"], rec["results"])
            rebuild_dispatcher(inst, timer)  # the default dispatcher again
        with phase("topkeys"):
            topkeys = check_topkeys(d, tally, pop_keys)
        with phase("analytics on / off pairs"):
            # the reference's method, after the topkeys check (the
            # sketch misses the detached arms): interleaved pairs, the
            # worker flushed before each detached arm; with the sketch's
            # fold in Python (before the move to C++), then native
            ab_arms = ABArms(inst, rng, len(pop_idx), key_of, limit,
                             duration, args, tally)
            flush = lambda: inst.analytics.flush(timeout=30.0)  # noqa: E731
            ana_ab = {"wire": {}, "object": {}}
            for lane in ("wire", "object"):
                dropped0 = inst.analytics.stats()["taps_dropped"]
                ab = interleaved_pairs(
                    f"{lane} lane analytics, native fold",
                    ab_arms.runner(lane),
                    (("on", nullcontext),
                     ("off", lambda: analytics_detached(inst))),
                    before_second=flush, pairs=ANALYTICS_AB_PAIRS)
                ab["taps_dropped"] = \
                    inst.analytics.stats()["taps_dropped"] - dropped0
                ab["overhead_pct"] = (ab["median_ratio"] - 1.0) * 100
                ana_ab[lane]["native"] = ab
            noana_launches = ab_arms.launches["wire"]["off"]
            # the fold's move itself: analytics on in both arms, the
            # Python fold against the native one, the worker flushed
            # before each arm
            fold_ab = {}
            for lane in ("wire", "object"):
                dropped0 = inst.analytics.stats()["taps_dropped"]
                fold_ab[lane] = interleaved_pairs(
                    f"{lane} lane sketch fold", ab_arms.runner(lane),
                    (("python", lambda: flushed(inst, python_fold(inst))),
                     ("native", lambda: flushed(inst, nullcontext()))))
                fold_ab[lane]["taps_dropped"] = \
                    inst.analytics.stats()["taps_dropped"] - dropped0
            # the tenant ledger's share: analytics on in both arms, the
            # tenants detached in one, the worker flushed before each
            tenant_ab = {}
            for lane in ("wire", "object"):
                tenant_ab[lane] = interleaved_pairs(
                    f"{lane} lane tenant ledger", ab_arms.runner(lane),
                    (("tenants", lambda: flushed(inst, nullcontext())),
                     ("detached", lambda: flushed(
                         inst, tenants_detached(inst)))),
                    pairs=TENANT_AB_PAIRS)
        with phase("analytics tap cost"):
            from gubernator_tpu_torch.cmd.tapcost import measure

            tap_cost = measure(TAP_COST_WAVES)
            print(f"analytics tap's own cost, list / columnar: "
                  f"{json.dumps(tap_cost)}", flush=True)
        with phase("hashing native / plain pairs"):
            hash_ab = interleaved_pairs(
                "object lane key hashing", ab_arms.runner("object"),
                (("native", nullcontext), ("plain", plain_hashing)))
        with phase("object lane host profile"):
            host_profile = profiled_object_rounds(
                inst, rng, len(pop_idx), key_of, limit, duration, args,
                timer, pauses, tally)
        with phase("observability"):
            observe = phase5_observability(
                torch, d, rng, len(pop_idx), key_of, limit, duration, args,
                tally, grpc)
        with phase("admission"):
            shed = admission_round(inst, rng, len(pop_idx), key_of, limit,
                                   duration, args, tally)
        with phase("drain"):
            drain = drain_check(d)
    finally:
        d.close()  # joins the worker: every wave's record is in
        gc.callbacks.remove(on_gc)

    tally.check()
    lat_ms = np.concatenate([np.asarray(r[2]) for r in rounds[:-1]]) * 1e3
    stats = []
    for rnd, (t0, wall, lat, n_req, device) in enumerate(rounds):
        s = round_stats(wall, lat, [w for w in timer.rec
                                    if t0 <= w[0] <= t0 + wall], n_req,
                        [p for p in pauses if t0 <= p[0] <= t0 + wall])
        if rnd == args.rounds:
            s["device"] = device
        stats.append(s)
        print(f"main path round {rnd}"
              f"{' (profiled)' if rnd == args.rounds else ''}: "
              f"{json.dumps(s)}", flush=True)
    n_obj = sum(r[3] for r in rounds)
    rounds, timed = stats, stats[:-1]
    rates = [r["decisions_per_s"] for r in timed]
    # the tally holds every lane's decisions: every key exact across them
    res = {"decisions_per_s": float(np.mean(rates)),
           "decisions_per_s_min": min(rates),
           "decisions_per_s_max": max(rates),
           "requests": n_obj, "checked_requests": tally.n_req,
           "keys": len(tally.count),
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "batches": len(lat_ms), "launches": launches, "rounds": rounds,
           "metrics": metrics, "healthz_deep": health,
           "admission": shed, "drain": drain, "observability": observe}
    print(f"main path: {n_obj} decisions ({tally.n_req} with the wire, "
          f"pipeline-off and admission rounds', each key exact) over "
          f"{len(tally.count)} keys; {len(timed)} timed rounds: "
          f"{res['decisions_per_s']} decisions/s (min "
          f"{res['decisions_per_s_min']}, max {res['decisions_per_s_max']});"
          f" batch p50 {res['p50_ms']} ms p99 {res['p99_ms']} ms over "
          f"{res['batches']} batches; K1 launches {launches}", flush=True)
    require(launches > 0, "the main path never launched K1")
    res["wire"] = wire_summary(
        [wire_round_stats(rec, timer, inline, pauses) for rec in wire],
        wire, wire_launches, "wire path", profiled_last=True)
    res["wire_pipeline_off"] = wire_summary(
        [wire_round_stats(rec, timer, inline, pauses) for rec in off],
        off, off_launches, "wire path, pipeline off", profiled_last=False)
    res["pipeline"] = pipeline_compare("wire path", res["wire"],
                                       res["wire_pipeline_off"])
    res["topkeys"] = topkeys
    res["analytics_ab"] = ana_ab
    res["wire_analytics_off_launches"] = noana_launches
    res["fold_ab"] = fold_ab
    res["tenant_ab"] = tenant_ab
    res["tap_cost"] = tap_cost
    res["hash_ab"] = hash_ab
    print(f"analytics on / off, the reference's method: " + json.dumps(
        {lane: {fold: {x: ab[x] for x in (
            "overhead_pct", "median_ratio", "ratios", "on_median",
            "off_median", "taps_dropped")} for fold, ab in folds.items()}
         for lane, folds in ana_ab.items()}), flush=True)
    print(f"sketch fold native / python, analytics on: " + json.dumps(
        {lane: {x: ab[x] for x in ("median_ratio", "python_median",
                                   "native_median", "taps_dropped")}
         for lane, ab in fold_ab.items()}), flush=True)
    print(f"object lane key hashing native / plain: "
          f"{json.dumps({x: hash_ab[x] for x in ('median_ratio', 'native_median', 'plain_median')})}",
          flush=True)
    res["object_host_profile"] = host_profile
    print(f"pipeline: depth {health['pipeline_depth']}, "
          f"{res['wire']['pipelined_waves']} packed_pipelined waves, "
          f"largest slot {res['wire']['max_slot']}, inline share "
          f"{res['wire']['inline_share']}, K1 launches {wire_launches}",
          flush=True)
    require(wire_launches > 0 and off_launches > 0,
            "a wire path never launched K1")
    require(res["wire"]["pipelined_waves"] > 0
            and res["wire"]["inline_share"] == 0,
            "the wire path did not run pipelined")
    # a CPU rehearsal's few callers may always share one wave
    require(DEVICE != "cuda" or (res["wire"]["max_slot"] or 0) > 0,
            "no pipelined wave launched behind another")
    require(res["wire_pipeline_off"]["pipelined_waves"] == 0,
            "the pipeline-off rounds pipelined")
    return res


def object_jobs(per, key_of, limit: int, duration: int) -> list:
    from gubernator_tpu_torch.types import RateLimitRequest

    return [[[RateLimitRequest(name="smoke", unique_key=key_of(r), hits=1,
                               limit=limit, duration=duration)
              for r in ranks] for ranks in thread] for thread in per]


def tenant_round(inst, rng, n_keys, key_of, limit, duration, args,
                 tally) -> dict:
    """One object round of 8 x AB_BATCHES batches: after a flush, the
    tenant ledger's requests, hits, OVER_LIMIT and error rows grew by
    exactly what the round sent and was answered (an object-lane wave is
    tapped whole, table-full rows as errors)."""
    ana = inst.analytics
    require(ana.flush(timeout=60.0), "analytics flush")
    before, dropped0 = ana.tenant_totals(), ana.stats()["taps_dropped"]
    per = [[zipf_ranks(rng, 1.1, n_keys, 1000) for _ in range(AB_BATCHES)]
           for _ in range(args.threads)]
    _, wall, _, results = drive(inst.get_rate_limits,
                                object_jobs(per, key_of, limit, duration))
    tally.add(per, results)
    resps = [r for t in results.values() for b in t for r in b]
    require(ana.flush(timeout=60.0), "analytics flush")
    after = ana.tenant_totals()
    delta = {f: after[f] - before[f] for f in after}
    want = {"requests": len(resps), "hits": len(resps),
            "over_limit": sum(r.status == 1 and not r.error
                              for r in resps),
            "errors": sum(bool(r.error) for r in resps), "degraded": 0,
            "shed": 0}
    out = {"delta": delta, "tally": want, "wall_s": wall,
           "tenants": len(ana.tenants_snapshot()["tenants"]),
           "taps_dropped": ana.stats()["taps_dropped"] - dropped0}
    print(f"tenants over one object round: {json.dumps(out)}", flush=True)
    require(out["taps_dropped"] == 0, "a tap was dropped")
    require(delta == want, f"tenant totals {delta} != the round's {want}")
    return out


def memory_check(torch, d) -> dict:
    """/debug/memory: device_bytes is the enrolled tensors' nbytes (the
    table's, and the hot set's replicas if built), printed beside
    torch.cuda.memory_allocated(); ?advise=1 splits exactly the row
    budget."""
    inst = d.instance
    code, body = get_json(d.http_port, "/debug/memory")
    require(code == 200, f"/debug/memory {code}")
    tensors = sum(int(t.nbytes) for t in inst.engine.table_tensors())
    hs = inst._hotset
    if hs is not None:
        tensors += sum(int(t.nbytes) for t in
                       list(hs.state) + [hs.base_rem, hs.base_t])
    code, adv = get_json(d.http_port, "/debug/memory?advise=1")
    a = adv["advise"]
    out = {"device_bytes": body["device_bytes"], "tensor_nbytes": tensors,
           "memory_allocated": (torch.cuda.memory_allocated()
                                if DEVICE == "cuda" else None),
           "host_bytes": body["host_bytes"], "pressure": body["pressure"],
           "consumers": {n: c.get("bytes") for n, c in
                         body["consumers"].items()},
           "advise_total_rows": a["total_rows"],
           "advised": a["advised"]}
    print(f"memory ledger: {json.dumps(out)}", flush=True)
    require(body["device_bytes"] == tensors,
            f"device_bytes {body['device_bytes']} != {tensors}")
    require(sum(a["advised"].values()) == a["total_rows"],
            f"advice {a['advised']} does not split {a['total_rows']}")
    return out


def slo_check(d, label: str) -> dict:
    """/debug/slo of a healthy daemon: every verdict printed, none
    breached or burning."""
    code, body = get_json(d.http_port, "/debug/slo")
    require(code == 200, f"/debug/slo {code}")
    rows = [{k: r.get(k) for k in ("slo", "tenant", "fast_burn",
                                    "slow_burn", "breached", "value",
                                    "target")} for r in body["slos"]]
    print(f"slo verdicts, {label}: {json.dumps(rows)}", flush=True)
    thr = body["burn_threshold"]
    bad = [r for r in rows if r["breached"] or r["fast_burn"] > thr]
    require(not bad, f"SLOs burning in a healthy round: {bad}")
    return {"ticks": body["ticks"], "slos": rows}


def wave_nodes(trace) -> list:
    out = []

    def walk(n):
        if n["name"] == "wave":
            out.append(n)
        for ch in n["children"]:
            walk(ch)

    for r in trace["roots"]:
        walk(r)
    return out


def exact_partition(wave) -> bool:
    kids = wave["children"]
    return (bool(kids) and kids[0]["start"] == wave["start"]
            and kids[-1]["end"] == wave["end"]
            and all(b["start"] == a["end"] for a, b in zip(kids, kids[1:])))


def trace_check(d, rng, n_keys, key_of, limit, duration, tally) -> dict:
    """TRACE_BATCHES batches of TRACE_ROWS rows over gRPC, one caller,
    each with its own traceparent, sampled (the recorder's rate at 1):
    each trace commits one tree, the handler's span over its wave, whose
    phase children partition it exactly; then as many at the default
    rate 0: none records anything.  Prints the wave's share of the
    batch's time in the handler."""
    import grpc
    import secrets

    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.tracing import assemble

    rec = d.instance.span_recorder
    sample0 = rec.sample
    ch = grpc.insecure_channel(f"127.0.0.1:{d.grpc_port}")
    call = raw_unary(ch, "GetRateLimits")
    sent = {True: [], False: []}
    try:
        for sampled in (True, False):
            rec.sample = 1.0 if sampled else 0.0
            per = [[zipf_ranks(rng, 1.1, n_keys, TRACE_ROWS)
                    for _ in range(TRACE_BATCHES)]]
            jobs = wire_jobs(per, key_of, limit, duration)
            res = {0: []}
            for data in jobs[0]:
                tid = secrets.token_hex(16)
                out = call(data, timeout=60, metadata=[(
                    "traceparent", f"00-{tid}-{secrets.token_hex(8)}-01")])
                res[0].append(decode_responses(out))
                sent[sampled].append(tid)
            tally.add(per, res)
    finally:
        rec.sample = sample0
        ch.close()
    shares, bad = [], []
    for tid in sent[True]:
        trees = assemble(rec.spans(trace_id=tid), tid)
        waves = wave_nodes(trees[0]) if trees else []
        ok = (len(trees) == 1 and len(trees[0]["roots"]) == 1
              and trees[0]["roots"][0]["name"] == "grpc.GetRateLimits"
              and len(waves) == 1 and exact_partition(waves[0])
              and waves[0]["parent_id"] == trees[0]["roots"][0]["span_id"])
        if not ok:
            bad.append(tid)
            continue
        root = trees[0]["roots"][0]
        shares.append((waves[0]["end"] - waves[0]["start"])
                      / max(root["end"] - root["start"], 1e-9))
    leaked = [t for t in sent[False] if rec.spans(trace_id=t)]
    out = {"sampled": len(sent[True]), "trees_ok": len(shares),
           "unsampled": len(sent[False]),
           "unsampled_recorded": len(leaked),
           "wave_share_of_handler_median": (float(np.median(shares))
                                            if shares else None),
           "wave_share_of_handler_p10_p90": (
               [float(np.percentile(shares, 10)),
                float(np.percentile(shares, 90))] if shares else None),
           "recorder": rec.stats()}
    print(f"traces: {json.dumps(out)}", flush=True)
    require(not bad, f"{len(bad)} sampled batches without one partitioned "
            f"tree, e.g. {bad[:3]}")
    require(not leaked, f"{len(leaked)} unsampled batches recorded spans")
    return out


def profile_check(torch, d, rng, n_keys, key_of, limit, duration, args,
                  tally) -> dict:
    """/debug/profile?seconds=PROFILE_S while 8 callers send wire
    batches (PROFILE_BATCHES each), after a round of the same size
    without a capture: the rates side by side; a second request during
    the capture answers 409; the capture's trace names K1's kernel
    symbol (on the card)."""
    inst = d.instance

    def round_():
        per = [[zipf_ranks(rng, 1.1, n_keys, 1000)
                for _ in range(PROFILE_BATCHES)]
               for _ in range(args.threads)]
        jobs = wire_jobs(per, key_of, limit, duration)
        _, wall, lat, raw = drive(inst.get_rate_limits_wire, jobs)
        tally.add(per, {t: [decode_responses(x) for x in b]
                        for t, b in raw.items()})
        return sum(len(x) for t in per for x in t) / wall, wall

    base_rate, base_wall = round_()
    code, started = get_json(d.http_port, f"/debug/profile?seconds={PROFILE_S}")
    require(code == 200 and started.get("profiling"),
            f"/debug/profile start: {code} {started}")
    code2, second = get_json(d.http_port, "/debug/profile?seconds=1")
    cap_rate, cap_wall = round_()
    deadline = time.monotonic() + 120
    while True:
        _, st = get_json(d.http_port, "/debug/profile")
        if not st["active"] or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    require(not st["active"], "the profile capture never ended")
    with open(st["trace"], encoding="utf-8") as f:
        text = f.read()
    out = {"rate_without": base_rate, "rate_with_capture": cap_rate,
           "ratio": cap_rate / base_rate, "walls_s": [base_wall, cap_wall],
           "second_request": code2, "trace_bytes": len(text),
           "k1_symbol_in_trace": "decide_kernel" in text,
           "events": text.count('"ph"')}
    print(f"profile capture: {json.dumps(out)}", flush=True)
    require(code2 == 409, f"a second capture answered {code2}: {second}")
    require(DEVICE != "cuda" or out["k1_symbol_in_trace"],
            "the capture does not name K1's kernel")
    return out


def phase5_observability(torch, d, rng, n_keys, key_of, limit, duration,
                         args, tally, grpc) -> dict:
    """The bucket daemon's observability, after its timed rounds: the
    tenant ledger against one round's tally, the memory ledger against
    the tensors, the SLO verdicts of the healthy daemon, sampled and
    unsampled traces, and a profile capture under load."""
    require(grpc, "the trace check needs grpcio")
    inst = d.instance
    return {"tenants": tenant_round(inst, rng, n_keys, key_of, limit,
                                    duration, args, tally),
            "memory": memory_check(torch, d),
            "slo": slo_check(d, "bucket daemon after its rounds"),
            "traces": trace_check(d, rng, n_keys, key_of, limit, duration,
                                  tally),
            "profile": profile_check(torch, d, rng, n_keys, key_of, limit,
                                     duration, args, tally)}


class _RingPeer:
    def __init__(self, info):
        self.info = info


def cluster_ring(c):
    """The ring the cluster's daemons route by, rebuilt from their peer
    infos in the order they were joined."""
    from gubernator_tpu_torch.peers import ReplicatedConsistentHash

    ring = ReplicatedConsistentHash()
    for d in c.daemons:
        ring.add(_RingPeer(d.peer_info()))
    return ring


def count_steps(eng, counts: list, i: int) -> None:
    """Count the decision steps (K1 launches on the card) of one
    daemon's engine in counts[i]."""
    decide = eng._decide

    def counted(*a):
        counts[i] += 1
        return decide(*a)

    eng._decide = counted


def time_cluster_calls(inst, rec: dict) -> None:
    """Record (start s, duration s) of one daemon's client wire entry in
    rec["entry"], the device step of its owned rows inside that entry in
    rec["local"], its owner side of a forward RPC in rec["owner"], and
    each degraded serve (step and protobuf build) in rec["degraded"]."""
    inside: set = set()  # threads inside the client entry

    def timed(name, key, entry=False):
        fn = getattr(inst, name)

        def wrapper(*a, **kw):
            me = threading.get_ident()
            if entry:
                inside.add(me)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if entry:
                    inside.discard(me)
                if key != "local" or me in inside:
                    rec[key].append((t, time.perf_counter() - t))

        setattr(inst, name, wrapper)

    timed("get_rate_limits_wire", "entry", entry=True)
    timed("_packed_check_to_bytes", "local")
    timed("get_peer_rate_limits_wire", "owner")
    timed("_serve_degraded_wire", "degraded")


def call_breakdown(rec: dict, t0: float, wall: float) -> dict:
    """Mean ms of the recorded calls that started in [t0, t0 + wall]."""
    out = {}
    for k, v in rec.items():
        d = [dt for t, dt in v if t0 <= t <= t0 + wall]
        out[f"{k}_calls"] = len(d)
        out[f"{k}_ms_mean"] = float(np.mean(d) * 1e3) if d else None
    return out


def cluster_totals(c) -> dict:
    """The cluster's forward, flush and GLOBAL counters, summed over its
    daemons."""
    out = {"forwarded": 0, "forward_failures": 0, "flushes": 0,
           "flush_items": 0, "hits_queued": 0, "hits_flushed": 0,
           "hits_absorbed": 0, "flush_failures": 0, "broadcasts": 0,
           "broadcast_keys": 0, "broadcast_failures": 0, "leaks": 0}
    for d in c.daemons:
        inst = d.instance
        out["forwarded"] += inst.forwarded_rows
        out["forward_failures"] += inst.forward_failures
        out["leaks"] += inst.engine.wave_pool.stats()["leaks"]
        for p in inst.peers():
            f = p.lane_stats()["forward"]
            out["flushes"] += f["flushes"]
            out["flush_items"] += f["items"]
        if inst.global_manager is not None:
            for k, v in inst.global_manager.snapshot_stats().items():
                out[k] = out.get(k, 0) + v
    return out


def phase_cluster(torch, args, solo_rate=None):
    """3 port daemons in this process, each with its own bucket engine
    (K1) on DEVICE and real gRPC over loopback, joined by
    cluster.start_with; 10M keys made resident on their owners by the
    ring; 8 callers each sending 1000-request GetRateLimitsReq batches to
    daemon (caller mod 3) through its gRPC front door, the keys of the
    GLOBAL_RANKS hottest ranks GLOBAL, and of the EXACT_GLOBAL_RANKS
    next GLOBAL with EXACT_GLOBAL_LIMIT.  Checks: non-GLOBAL keys exact
    across the cluster, forwarded keys held by their owner alone, GLOBAL
    keys converged on every daemon with every queued hit absorbed (the
    EXACT_GLOBAL_LIMIT keys to the limit less the hits sent), no leak
    and no failed forward."""
    import grpc

    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.hashing import hash_request_keys
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    limit, duration, n_glob = 100, 3_600_000, GLOBAL_RANKS
    n_all = GLOBAL_RANKS + EXACT_GLOBAL_RANKS  # ranks below it are GLOBAL

    def limit_of(r):
        return EXACT_GLOBAL_LIMIT if n_glob <= r < n_all else limit

    # the JAX package's BehaviorConfig defaults (degraded serves and the
    # health gate on)
    behaviors = BehaviorConfig(**CLUSTER_BEHAVIOR_OVERRIDES)
    with scoped_env("GUBER_SLO_FAST", CLUSTER_SLO_WINDOWS[0]), \
            scoped_env("GUBER_SLO_SLOW", CLUSTER_SLO_WINDOWS[1]), \
            scoped_env("GUBER_SLO_P99_MS", os.environ.get(
                "GUBER_SLO_P99_MS") or CLUSTER_SLO_P99_MS):
        c = cluster.start_with([DaemonConfig(
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0",
            cache_size=1 << args.cluster_log2_cap, batch_rows=1024,
            device=DEVICE, behaviors=behaviors)
            for _ in range(CLUSTER_NODES)])
    chans = []
    try:
        n = len(c.daemons)
        ring = cluster_ring(c)
        by_addr = {d.advertise_address: i for i, d in enumerate(c.daemons)}
        owner_daemon = np.array([by_addr[p.info.grpc_address]
                                 for p in ring.owner_peers()])
        t0 = time.perf_counter()
        pop_idx, pop_keys, owner_pi = fit_cluster_population(
            args.keys, args.cluster_log2_cap, ring)
        owner = owner_daemon[owner_pi]
        sample = np.arange(0, len(pop_idx), max(len(pop_idx) // 300, 1))
        require(all(c.owner_daemon_of(f"smoke_k{pop_idx[j]:08d}")
                    is c.daemons[owner[j]] for j in sample),
                "the smoke's ring differs from the daemons'")
        fill_t = int(time.time() * 1000) - 1_000
        pop_limit = np.full(len(pop_keys), limit, np.int64)
        pop_limit[n_glob:n_all] = EXACT_GLOBAL_LIMIT
        for i, d in enumerate(c.daemons):
            mine = pop_keys[owner == i]
            with d.instance._engine_mu:
                placed = d.instance.engine.restore(token_rows(
                    mine, pop_limit[owner == i], duration, fill_t))
            require(placed == len(mine), f"daemon {i} placed {placed} of "
                    f"{len(mine)} keys")
        per_node = np.bincount(owner, minlength=n).tolist()
        print(f"cluster fill: {len(pop_keys)} TOKEN keys on their owners "
              f"{per_node} in {time.perf_counter() - t0:.2f} s", flush=True)

        steps = [0] * n
        calls_rec = {"entry": [], "local": [], "owner": [], "degraded": []}
        for i, d in enumerate(c.daemons):
            count_steps(d.instance.engine, steps, i)
            time_cluster_calls(d.instance, calls_rec)
        chans = [grpc.insecure_channel(f"127.0.0.1:{d.grpc_port}")
                 for d in c.daemons]
        calls = [raw_unary(chans[t % n], "GetRateLimits")
                 for t in range(args.threads)]
        rng = np.random.default_rng(args.seed + 3)
        tally = Tally(limit)
        glob_under = np.zeros(n_glob, np.int64)
        exact_sent = np.zeros(n_all, np.int64)  # ranks n_glob.. count
        glob_req = 0
        n_rows = 0
        decide_cuda.launches = 0
        before = cluster_totals(c)
        rounds = []
        key_of = lambda r: f"k{pop_idx[r]:08d}"  # noqa: E731
        for rnd in range(args.cluster_rounds + 1):
            profiled = rnd == args.cluster_rounds
            n_b = args.profile_batches if profiled else args.batches
            per = [[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
                    for _ in range(n_b)] for _ in range(args.threads)]
            jobs = wire_jobs(per, key_of, limit, duration,
                             lambda r: 2 if r < n_all else 0, limit_of)
            rpc = [lambda b, call=call: call(b, timeout=120)
                   for call in calls]
            device = None
            if profiled and DEVICE == "cuda":
                out, device = profile_device(torch, lambda: drive(rpc, jobs))
            else:
                out = drive(rpc, jobs)
            t_start, wall, lat, raw = out
            n_req = 0
            plain_per, plain_res = [], {}
            for t, thread in enumerate(per):
                plain_per.append([])
                plain_res[t] = []
                for ranks, data in zip(thread, raw[t]):
                    resps = decode_responses(data)
                    require(len(resps) == len(ranks), "short response")
                    require(not any(r.degraded for r in resps),
                            "a row was served degraded in the healthy "
                            "cluster")
                    n_req += len(ranks)
                    g = ranks < n_all
                    for r, resp in zip(ranks[g].tolist(),
                                       [resps[j] for j in np.nonzero(g)[0]]):
                        require(not resp.error, resp.error)
                        if r < n_glob:
                            glob_under[r] += resp.status == 0
                        else:
                            require(resp.status == 0, "a GLOBAL key "
                                    "under a limit of 10^9 went OVER")
                    exact_sent += np.bincount(ranks[g], minlength=n_all)
                    glob_req += int(g.sum())
                    plain_per[t].append(ranks[~g])
                    plain_res[t].append([resps[j]
                                         for j in np.nonzero(~g)[0]])
            tally.add(plain_per, plain_res)
            n_rows += n_req
            lat_ms = np.asarray(lat) * 1e3
            rec = {"wall_s": wall, "decisions_per_s": n_req / wall,
                   "batches": len(lat),
                   "p50_ms": float(np.percentile(lat_ms, 50)),
                   "p99_ms": float(np.percentile(lat_ms, 99)),
                   "max_ms": float(lat_ms.max()),
                   "batch_ms_mean": float(lat_ms.mean()), "lat": lat,
                   "device": device}
            # a batch's time in its daemon's entry (the rest is the gRPC
            # hop in and out), of which the local step; the owner side
            # of each forward RPC
            rec.update(call_breakdown(calls_rec, t_start, wall))
            rounds.append(rec)
            print(f"cluster round {rnd}{' (profiled)' if profiled else ''}:"
                  f" {json.dumps({k: v for k, v in rec.items() if k != 'lat'})}",
                  flush=True)
        # the rounds' K1 launches and steps, before the probes below
        launches, steps = decide_cuda.launches, list(steps)

        # every queued GLOBAL hit reaches its owner, whose broadcast then
        # reaches every replica: poll by attempt, with a deadline.  A
        # flush is counted only once its RPC returns, so the counters
        # are polled with the rest
        b = behaviors
        time.sleep((b.global_sync_wait_ms + b.global_broadcast_interval_ms)
                   / 1000.0)
        probe = encode_get_rate_limits([RateLimitRequest(
            name="smoke", unique_key=key_of(r), hits=0, limit=limit_of(r),
            duration=duration, behavior=2) for r in range(n_all)])
        want = [None] * n_glob + (
            EXACT_GLOBAL_LIMIT - exact_sent[n_glob:]).tolist()
        deadline = time.monotonic() + CONVERGE_S
        attempts = 0
        while True:
            attempts += 1
            rem = [[x.remaining for x in decode_responses(
                d.instance.get_rate_limits_wire(probe))] for d in c.daemons]
            owners_rem = [rem[by_addr[ring.get(f"smoke_{key_of(r)}")
                                      .info.grpc_address]][r]
                          for r in range(n_all)]
            queued = [d.instance.global_manager.queued()["hits"]
                      if d.instance.global_manager is not None else 0
                      for d in c.daemons]
            totals = cluster_totals(c)
            absorbed = totals["hits_queued"] == (totals["hits_flushed"]
                                                 + totals["hits_absorbed"])
            converged = (all(row == owners_rem for row in rem)
                         and all(w is None or w == o
                                 for w, o in zip(want, owners_rem))
                         and not any(queued) and absorbed)
            if converged or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        moved = {k: totals[k] - before.get(k, 0) for k in totals}
        print(f"cluster GLOBAL convergence after {attempts} attempts: "
              f"{converged}; owner remaining {owners_rem}; 10^9-limit keys "
              f"want {want[n_glob:]}; queued {queued}; hits queued "
              f"{totals['hits_queued']}, flushed {totals['hits_flushed']}, "
              f"absorbed {totals['hits_absorbed']}", flush=True)
        require(converged, f"GLOBAL keys did not converge: {rem}; want "
                f"{want}; queued {queued}; {totals}")
        # a failed broadcast is not retried (JAX's too): the convergence
        # above is what holds the replicas; it is counted and printed
        require(totals["flush_failures"] == 0,
                f"a GLOBAL hits flush failed: {totals}")
        require(totals["forward_failures"] == 0,
                f"{totals['forward_failures']} forwards failed")
        require(totals["leaks"] == 0, f"{totals['leaks']} leases leaked")
        # after the rounds' counters are read: its forwards are its own
        traces = cluster_trace_check(c, chans, rng, len(pop_idx), n_all,
                                     owner, key_of, limit, duration, tally)
        tally.check()
        # a forwarded key lives on its owner alone
        touched = np.array(sorted(tally.count), np.int64)
        pick = touched[np.linspace(0, len(touched) - 1,
                                   min(len(touched), 20_000)).astype(int)]
        kh = hash_request_keys(["smoke"] * len(pick),
                               [key_of(r) for r in pick.tolist()])
        held = np.zeros(len(pick), np.int64)
        for i, d in enumerate(c.daemons):
            with d.instance._engine_mu:
                found, _ = d.instance.engine.gather_rows(kh)
            require(not (found & (owner[pick] != i)).any(),
                    f"daemon {i} holds rows it does not own")
            held += found
        require((held == 1).all(), "a touched key is not on its owner")
        audit = cluster_audit_check(c, "after the GLOBAL queues drained")
        costmodel = cluster_costmodel_check(c)
        ctx = OutageContext(
            ring=ring, owner=owner, pop_idx=pop_idx, pop_keys=pop_keys,
            tally=tally, key_of=key_of, limit=limit, duration=duration,
            n_glob=n_glob, n_all=n_all, chans=chans, behaviors=behaviors,
            seed=args.seed + 4, fill_t=fill_t, calls_rec=calls_rec,
            healthy_rate=float(np.mean([r["decisions_per_s"]
                                        for r in rounds[:-1]])))
        outage = phase_outage(torch, args, c, ctx)
        handover = phase_handover(args, c, ctx)
        dump = close_dump_check(c)
    finally:
        for ch in chans:
            ch.close()
        c.stop()

    timed = rounds[:-1]
    lat_ms = np.concatenate([np.asarray(r["lat"]) for r in timed]) * 1e3
    rates = [r["decisions_per_s"] for r in timed]
    over = np.maximum(glob_under - limit, 0)
    res = {"nodes": n, "decisions_per_s": float(np.mean(rates)),
           "decisions_per_s_rounds": rates,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "requests": n_rows, "checked_requests": tally.n_req,
           "global_share": glob_req / n_rows,
           "forwarded_share": moved["forwarded"] / n_rows,
           "forwarded_share_of_non_global": moved["forwarded"]
           / max(n_rows - glob_req, 1),
           "peer_flushes": moved["flushes"],
           "items_per_flush": moved["flush_items"] / max(moved["flushes"], 1),
           "global_hits_queued": moved["hits_queued"],
           "global_hits_flushed": moved["hits_flushed"],
           "broadcasts": moved["broadcasts"],
           "broadcast_keys": moved["broadcast_keys"],
           "broadcast_failures": moved["broadcast_failures"],
           "global_over_admission_max": int(over.max()),
           "global_over_admission_sum": int(over.sum()),
           "exact_global_hits": int(exact_sent[n_glob:].sum()),
           "launches": launches, "steps_per_daemon": steps,
           "convergence_attempts": attempts,
           "device": rounds[-1]["device"],
           "share_of_solo_wire": (float(np.mean(rates)) / solo_rate
                                  if solo_rate else None),
           "outage": outage, "handover": handover, "traces": traces,
           "audit": audit, "costmodel": costmodel, "dump": dump}
    print(f"cluster: {n} daemons, {n_rows} decisions ({tally.n_req} "
          f"non-GLOBAL, each key exact); {len(timed)} timed rounds: "
          f"{res['decisions_per_s']} decisions/s ({rates}); batch p50 "
          f"{res['p50_ms']} ms p99 {res['p99_ms']} ms; GLOBAL share "
          f"{res['global_share']}; forwarded share {res['forwarded_share']}"
          f" ({res['forwarded_share_of_non_global']} of non-GLOBAL rows); "
          f"{res['peer_flushes']} peer flushes, {res['items_per_flush']} "
          f"items a flush; GLOBAL hits queued {res['global_hits_queued']}, "
          f"flushed {res['global_hits_flushed']}; {res['broadcasts']} "
          f"broadcasts ({res['broadcast_keys']} keys, "
          f"{res['broadcast_failures']} failed sends); GLOBAL "
          f"over-admission max {res['global_over_admission_max']} sum "
          f"{res['global_over_admission_sum']}; K1 launches {launches}, "
          f"steps per daemon {steps}; share of the solo wire path "
          f"{res['share_of_solo_wire']}", flush=True)
    require(launches > 0 and all(steps),
            f"a daemon never launched K1: {steps}")
    return res


def cluster_trace_check(c, chans, rng, n_keys, n_all, owner, key_of, limit,
                        duration, tally) -> dict:
    """CLUSTER_TRACES batches of non-GLOBAL rows of every owner, one
    after another through daemon 0's gRPC front door, each with a
    sampled traceparent (the recorders' rate at 1): ``assemble`` over
    the three daemons' /debug/traces builds one tree per trace, holding
    the handler's span, its wave, a ``peer.forward`` hop and under it
    the owner's ``grpc.GetPeerRateLimits`` and its wave; no parent is
    missing (one root)."""
    import secrets

    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.tracing import assemble

    recs = [d.instance.span_recorder for d in c.daemons]
    for r in recs:
        r.sample = 1.0
    call = raw_unary(chans[0], "GetRateLimits")
    tids, per, res = [], [[]], {0: []}
    try:
        for _ in range(CLUSTER_TRACES):
            ranks = rng.integers(n_all, n_keys, 200)
            tid = secrets.token_hex(16)
            out = call(wire_jobs([[ranks]], key_of, limit, duration)[0][0],
                       timeout=60, metadata=[(
                           "traceparent",
                           f"00-{tid}-{secrets.token_hex(8)}-01")])
            per[0].append(ranks)
            res[0].append(decode_responses(out))
            tids.append(tid)
    finally:
        for r in recs:
            r.sample = 0.0
    tally.add(per, res)
    spans = []
    for d in c.daemons:
        code, body = get_json(d.http_port, "/debug/traces")
        require(code == 200, f"/debug/traces {code}")
        spans += body["spans"]
    bad, sizes = [], []
    for tid in tids:
        trees = assemble(spans, tid)
        names, owner_waves = set(), 0

        def walk(n, under_owner):
            nonlocal owner_waves
            names.add(n["name"])
            if n["name"] == "wave" and under_owner:
                owner_waves += 1
            for ch in n["children"]:
                walk(ch, under_owner or n["name"] == "grpc.GetPeerRateLimits")

        for r in (trees[0]["roots"] if trees else []):
            walk(r, False)
        ok = (len(trees) == 1 and len(trees[0]["roots"]) == 1
              and trees[0]["roots"][0]["name"] == "grpc.GetRateLimits"
              and {"wave", "peer.forward", "grpc.GetPeerRateLimits"} <= names
              and owner_waves >= 1
              and all(exact_partition(w) for w in wave_nodes(trees[0])))
        if ok:
            sizes.append(trees[0]["spans"])
        else:
            bad.append((tid, [r["name"] for r in trees[0]["roots"]]
                        if trees else None))
    out = {"traces": len(tids), "one_tree_each": len(sizes),
           "spans_per_trace": sizes,
           "owners_of_rows": np.bincount(owner[np.concatenate(per[0])],
                                         minlength=len(c.daemons)).tolist()}
    print(f"cluster traces: {json.dumps(out)}", flush=True)
    require(not bad, f"traces not assembled into one tree: {bad[:3]}")
    return out


def cluster_audit_check(c, label: str) -> dict:
    """/debug/audit on every daemon: drift 0, and fold_audits of the
    three conserves."""
    from gubernator_tpu_torch.fleet import fold_audits, ring_verdict

    docs = []
    for d in c.daemons:
        code, doc = get_json(d.http_port, "/debug/audit")
        require(code == 200, f"/debug/audit {code}")
        docs.append(doc)
    fold = fold_audits(docs)
    out = {"drift": [x["drift"] for x in docs],
           "injected": [x["lanes"]["global"]["injected"] for x in docs],
           "applied": [x["lanes"]["global"]["applied"] for x in docs],
           "absorbed": [x["lanes"]["global"]["absorbed"] for x in docs],
           "fold": {k: fold[k] for k in ("drift", "conserved", "totals")},
           "ring_consistent": ring_verdict(docs)["consistent"]}
    print(f"audit, {label}: {json.dumps(out)}", flush=True)
    require(all(x["drift"] == 0 for x in docs) and fold["conserved"],
            f"conservation drift: {out}")
    return out


def cluster_costmodel_check(c) -> dict:
    """/debug/costmodel on every daemon: the cluster holds broadcast
    and peer_flush samples."""
    out = {}
    for i, d in enumerate(c.daemons):
        code, body = get_json(d.http_port, "/debug/costmodel")
        require(code == 200, f"/debug/costmodel {code}")
        out[i] = body["buckets"]
    phases = {b["phase"] for bs in out.values() for b in bs
              if b["samples"] > 0}
    print(f"cost model: {json.dumps(out)}", flush=True)
    require({"broadcast", "peer_flush"} <= phases,
            f"cost model phases {sorted(phases)}")
    return {"phases": sorted(phases), "buckets": out}


def close_dump_check(c) -> dict:
    """The cluster closed with GUBER_DEBUG_DUMP_DIR set: each daemon
    leaves its event ring with its SLO verdicts, and its spans, as
    JSONL."""
    import glob
    import tempfile

    dump_dir = tempfile.mkdtemp(prefix="guber_dump_")
    with scoped_env("GUBER_DEBUG_DUMP_DIR", dump_dir):
        c.stop()
    out = {"dir": dump_dir, "daemons": []}
    for i, d in enumerate(c.daemons):
        safe = "".join(ch if ch.isalnum() or ch in "-._" else "_"
                       for ch in d.advertise_address)
        ev = glob.glob(f"{dump_dir}/guber_dump_{safe}_*.jsonl")
        tr = glob.glob(f"{dump_dir}/guber_traces_{safe}_*.jsonl")
        require(len(ev) == 1, f"event dumps of {d.advertise_address}: {ev}")
        with open(ev[0], encoding="utf-8") as f:
            lines = f.read().splitlines()
        head = json.loads(lines[0])
        spans = []
        if tr:
            with open(tr[0], encoding="utf-8") as f:
                spans = f.read().splitlines()[1:]
        row = {"events": head["events"], "lines": len(lines) - 1,
               "slo_verdicts": len(head.get("slo_verdicts") or []),
               "spans": len(spans)}
        out["daemons"].append(row)
        require(row["events"] == row["lines"] > 0 and row["slo_verdicts"],
                f"dump {row}")
        # the cluster's daemons hold sampled and forced spans; the one
        # that joined for the handover may hold none (then no file)
        require(i >= CLUSTER_NODES or row["spans"] > 0,
                f"daemon {i} dumped no span")
    print(f"dumps on close: {json.dumps(out)}", flush=True)
    return out


class OutageContext(NamedTuple):
    """What the outage and handover steps take over from the cluster
    phase: its ring, population, owners (daemon per population rank),
    tally, traffic shape and channels."""

    ring: object
    owner: np.ndarray
    pop_idx: np.ndarray
    pop_keys: np.ndarray
    tally: object
    key_of: object
    limit: int
    duration: int
    n_glob: int
    n_all: int
    chans: list
    behaviors: object
    seed: int
    fill_t: int
    calls_rec: dict
    healthy_rate: float


def post_json(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def metric_total(inst, name: str) -> float:
    """The sum of a family's samples named ``name`` over its labels."""
    return sum(smp.value for fam in inst.metrics.registry.collect()
               for smp in fam.samples if smp.name == name)


def outage_ranks(ctx, log2_cap: int) -> np.ndarray:
    """OUTAGE_KEYS ranks of non-GLOBAL keys owned by daemon 2, the
    hottest first, whose buckets on daemons 0 and 1 have room for the
    rows their degraded serves create there."""
    nb = 1 << (log2_cap - 3)
    bucket = (ctx.pop_keys & np.uint64(nb - 1)).astype(np.int64)
    room = [np.bincount(bucket[ctx.owner == i], minlength=nb)
            for i in (0, 1)]
    cand = np.nonzero(ctx.owner == 2)[0]
    cand = cand[cand >= ctx.n_all]
    ok = (room[0][bucket[cand]] < 6) & (room[1][bucket[cand]] < 6)
    ranks = cand[ok][:OUTAGE_KEYS]
    require(len(ranks) == OUTAGE_KEYS, "too few outage keys")
    return ranks


def peer_of(inst, addr: str):
    return next(p for p in inst.peers() if p.info.grpc_address == addr)


def first_eject_due(c, addr: str, eject_s: float):
    """The monotonic instant the first of daemons 0 and 1 may eject
    ``addr`` (its circuit-open streak plus peer_eject_after_ms), None
    before either streak began."""
    dues = []
    for d in c.daemons[:2]:
        p = peer_of(d.instance, addr)
        with p._circ_mu:
            since = p._route_bad_since
        if since:
            dues.append(since + eject_s)
    return min(dues) if dues else None


def await_ring_events(c, kind: str, seq0: list, poke, bound_s: float):
    """Poll daemons 0 and 1 until each has recorded a ``kind`` event
    after its seq0; a daemon without one gets ``poke(i)`` (a hits=0
    request on a key it owns: the gate is read on a request).  Returns
    each daemon's first such event."""
    deadline = time.monotonic() + bound_s
    got = [None, None]
    while True:
        for i in (0, 1):
            if got[i] is None:
                ev = c.daemons[i].instance.recorder.events(
                    kind=kind, since_seq=seq0[i])
                if ev:
                    got[i] = ev[0]
                else:
                    poke(i)
        if all(got) or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    require(all(got), f"{kind} missing on a daemon: {got}")
    return got


def phase_outage(torch, args, c, ctx) -> dict:
    """The cluster's failure path on the cluster phase's daemons and
    tables: daemons 0 and 1 arm ``peer_send@<daemon 2>:error`` through
    POST /debug/faults, and 8 callers send the cluster phase's traffic
    to them only (caller mod 2), with OUTAGE_KEYS keys of daemon 2 at
    OUTAGE_LIMIT.  Windows: degraded (the failed forwards served
    degraded, until just before the first gate may eject daemon 2),
    rehomed (one timed round once both gates ejected it), recovered (one
    timed round once the faults are cleared and both gates readmitted
    it; callers pause across each flip).  Checks: no error row but
    `rate limit table full` on a key of daemon 2 served where it never
    lived; degraded rows in the first two windows and none in the last;
    gubernator_degraded_served equal to the rows flagged; two
    generation bumps on daemons 0 and 1; daemon 2's OUTAGE_KEYS rows at
    exactly OUTAGE_LIMIT less the hits sent once the queues drained;
    daemons 0 and 1's own non-GLOBAL keys exact; no lease leaked."""
    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    b = ctx.behaviors
    d2 = c.daemons[2]
    addr2 = d2.advertise_address
    out_ranks = outage_ranks(ctx, args.cluster_log2_cap)
    is_out = np.zeros(len(ctx.pop_idx), bool)
    is_out[out_ranks] = True
    # a fresh row at OUTAGE_LIMIT on their owner, so a debit reads exactly
    with d2.instance._engine_mu:
        placed = d2.instance.engine.upsert_rows(
            ctx.pop_keys[out_ranks],
            token_rows(ctx.pop_keys[out_ranks], OUTAGE_LIMIT, ctx.duration,
                       ctx.fill_t))
    require(placed == OUTAGE_KEYS, f"placed {placed} outage rows")

    def limit_of(r):
        return (OUTAGE_LIMIT if is_out[r] else EXACT_GLOBAL_LIMIT
                if ctx.n_glob <= r < ctx.n_all else ctx.limit)

    own_rank = [int(np.nonzero((ctx.owner == i) & ~is_out
                               & (np.arange(len(ctx.owner)) >= ctx.n_all)
                               )[0][0]) for i in (0, 1)]

    def poke(i):
        r = own_rank[i]
        c.daemons[i].instance.get_rate_limits_wire(encode_get_rate_limits(
            [RateLimitRequest(name="smoke", unique_key=ctx.key_of(r),
                              hits=0, limit=ctx.limit,
                              duration=ctx.duration)]))

    rng = np.random.default_rng(ctx.seed)
    calls = [raw_unary(ctx.chans[t % 2], "GetRateLimits")
             for t in range(args.threads)]
    rpc = [lambda x, call=call: call(x, timeout=120) for call in calls]

    def jobs_of(n_b):
        per = [[zipf_ranks(rng, 1.1, len(ctx.pop_idx), 1000)
                for _ in range(n_b)] for _ in range(args.threads)]
        return per, wire_jobs(per, ctx.key_of, ctx.limit, ctx.duration,
                              lambda r: 2 if r < ctx.n_all else 0, limit_of)

    sent_out = np.zeros(len(ctx.pop_idx), np.int64)
    under2 = np.zeros(len(ctx.pop_idx), np.int64)
    windows = {}

    def account(name, per, t0, wall, lat, raw):
        """One window's answers: counted, checked and tallied."""
        # every error row is `rate limit table full` (checked below)
        n_req = deg = full = 0
        plain_per, plain_res = [], {}
        for t in range(len(per)):
            plain_per.append([])
            plain_res[t] = []
            for ranks, data in zip(per[t], raw.get(t, [])):
                resps = decode_responses(data)
                require(len(resps) == len(ranks), "short response")
                n_req += len(ranks)
                own = ctx.owner[ranks]
                for r, o, resp in zip(ranks.tolist(), own.tolist(), resps):
                    deg += bool(resp.degraded)
                    if resp.error:
                        # a degraded serve inserts a row where the key
                        # never lived: its bucket may be full
                        require(resp.error == TABLE_FULL and o == 2
                                and not is_out[r], f"{name} window: "
                                f"error row for rank {r}: {resp.error}")
                        full += 1
                        continue
                    if o == 2 and r >= ctx.n_all and resp.status == 0:
                        under2[r] += 1
                np.add.at(sent_out, ranks[is_out[ranks]], 1)
                mine = (ranks >= ctx.n_all) & (own != 2)
                plain_per[t].append(ranks[mine])
                plain_res[t].append([resps[j]
                                     for j in np.nonzero(mine)[0]])
        ctx.tally.add(plain_per, plain_res)
        lat_ms = np.asarray(lat) * 1e3
        rec = {"decisions": n_req, "wall_s": wall,
               "decisions_per_s": n_req / wall if wall else None,
               "batches": len(lat),
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "share_of_healthy_cluster": (n_req / wall / ctx.healthy_rate
                                            if wall else None),
               "degraded_rows": deg, "error_rows": full}
        # a batch's time in its daemon's entry, of which the owned rows'
        # step, and the owner side of each forward RPC
        rec.update(call_breakdown(ctx.calls_rec, t0, wall))
        windows[name] = rec
        print(f"outage {name} window: {json.dumps(rec)}", flush=True)
        return rec

    insts = [d.instance for d in c.daemons]
    gen0 = [i.metrics.registry.get_sample_value("gubernator_ring_generation")
            for i in insts]
    leaks0 = sum(i.engine.wave_pool.stats()["leaks"] for i in insts)
    deg_metric0 = sum(metric_total(i, "gubernator_degraded_served_total")
                      for i in insts)
    fault_metric0 = sum(metric_total(i, "gubernator_fault_injected_total")
                        for i in insts)
    decide_cuda.launches = 0
    seq0 = [insts[i].recorder.events()[-1]["seq"] for i in (0, 1)]
    spec = f"peer_send@{addr2}:error"
    # the SLO plane, the tenants and the traces before the outage: the
    # cluster rounds' GLOBAL backlog may have burned fleet_conservation
    # (the audit drift is rarely 0 at a tick under GLOBAL load); the
    # probe runs once every SLO cooled
    cooled_s = [await_no_breach(c.daemons[i], SLO_COOL_S) for i in (0, 1)]
    burn_rc0 = [fail_on_burn(c.daemons[i]) for i in (0, 1)]
    slo_windows = {"before": outage_slo(c, time.time())}
    require(burn_rc0 == [0, 0],
            f"--fail-on-burn before the arming exited {burn_rc0}")
    for i in insts:
        require(i.analytics.flush(timeout=60.0), "analytics flush")
    tenant_deg0 = sum(i.analytics.tenant_totals()["degraded"] for i in insts)
    traces0 = [{x["trace_id"] for x in insts[i].span_recorder.spans()}
               for i in (0, 1)]

    # 1-2. the degraded window: armed, traffic until just before the
    # first gate may flip, then the callers pause until both flipped
    per, jobs = jobs_of(OUTAGE_MAX_BATCHES)
    t_arm = time.time()
    for d in c.daemons[:2]:
        got = post_json(d.http_port, "/debug/faults", {"spec": spec})
        require(got["armed"] and got["spec"] == spec, f"arming: {got}")
    eject_s = b.peer_eject_after_ms / 1000.0

    def stop():
        due = first_eject_due(c, addr2, eject_s)
        return due is not None and time.monotonic() >= due - OUTAGE_MARGIN_S

    starts: list = []
    t0, wall, lat, raw = drive(rpc, jobs, stop=stop, starts=starts)
    require(stop(), "the degraded window ran out of batches before "
            "daemon 2's circuit opened")
    for i in (0, 1):
        require(not insts[i].recorder.events(kind="ring_ejected",
                                             since_seq=seq0[i]),
                "a gate flipped while the degraded window's callers ran")
    rec = account("degraded", per, t0, wall, lat, raw)
    slo_windows["degraded"] = outage_slo(c, t_arm, check_cli=True)
    forced = [len({x["trace_id"] for x in insts[i].span_recorder.spans()}
                  - traces0[i]) for i in (0, 1)]
    opened = min(s for s in (peer_of(insts[i], addr2)._route_bad_since
                             for i in (0, 1)) if s)
    before_open = [x[1] * 1e3 for x in starts if x[0] < opened]
    rec["batches_before_circuit_open"] = len(before_open)
    rec["p99_ms_before_circuit_open"] = (
        float(np.percentile(before_open, 99)) if before_open else None)
    ejected = await_ring_events(c, "ring_ejected", seq0, poke, FLIP_S)
    eject_ms = [e["t_ms"] - t_arm * 1000 for e in ejected]
    print(f"outage: ring_ejected {eject_ms} ms after arming (daemons 0, "
          f"1); p99 before the circuit opened "
          f"{rec['p99_ms_before_circuit_open']} ms over "
          f"{len(before_open)} batches", flush=True)

    # 3. the rehomed window: both gates flipped, one timed round; then
    # the faults clear and the callers pause until both readmitted
    seq1 = [insts[i].recorder.events()[-1]["seq"] for i in (0, 1)]
    per, jobs = jobs_of(args.outage_batches)
    t0, wall, lat, raw = drive(rpc, jobs)
    account("rehomed", per, t0, wall, lat, raw)
    slo_windows["rehomed"] = outage_slo(c, t_arm)
    for i in (0, 1):
        require(not insts[i].recorder.events(kind="ring_readmitted",
                                             since_seq=seq1[i]),
                "daemon 2 readmitted while armed")
    t_clear = time.time()
    for d in c.daemons[:2]:
        got = post_json(d.http_port, "/debug/faults", {"clear": True})
        require(not got["armed"], f"clearing: {got}")
    readmitted = await_ring_events(c, "ring_readmitted", seq1, poke, FLIP_S)
    readmit_ms = [e["t_ms"] - t_clear * 1000 for e in readmitted]
    print(f"outage: ring_readmitted {readmit_ms} ms after clearing",
          flush=True)

    # 4. the recovered window, then the degraded hits drain to daemon 2
    per, jobs = jobs_of(args.outage_batches)
    t0, wall, lat, raw = drive(rpc, jobs)
    account("recovered", per, t0, wall, lat, raw)
    slo_windows["recovered"] = outage_slo(c, t_arm)
    t_drain = time.perf_counter()
    deadline = time.monotonic() + CONVERGE_S
    while True:
        totals = cluster_totals(c)
        queued = [i.global_manager.queued()["hits"]
                  if i.global_manager is not None else 0 for i in insts]
        drained = not any(queued) and totals["hits_queued"] == (
            totals["hits_flushed"] + totals["hits_absorbed"])
        if drained or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    drain_ms = (time.perf_counter() - t_drain) * 1e3
    require(drained, f"the GLOBAL hit queues did not drain: {queued}, "
            f"{totals}")
    time.sleep(b.global_sync_wait_ms / 1000.0)
    launches = decide_cuda.launches

    with d2.instance._engine_mu:
        found, cols = d2.instance.engine.gather_rows(
            ctx.pop_keys[out_ranks])
    want = OUTAGE_LIMIT - sent_out[out_ranks]
    require(found.all(), "an outage key left its owner")
    require((cols["remaining"] == want).all(),
            f"outage keys not exact on daemon 2: remaining "
            f"{cols['remaining'][:8].tolist()}, want {want[:8].tolist()}")
    ctx.tally.check()
    gen1 = [i.metrics.registry.get_sample_value("gubernator_ring_generation")
            for i in insts]
    deg_metric = sum(metric_total(i, "gubernator_degraded_served_total")
                     for i in insts) - deg_metric0
    fault_metric = sum(metric_total(i, "gubernator_fault_injected_total")
                       for i in insts) - fault_metric0
    leaks = sum(i.engine.wave_pool.stats()["leaks"] for i in insts) - leaks0
    flagged = sum(w["degraded_rows"] for w in windows.values())
    for i in insts:
        require(i.analytics.flush(timeout=60.0), "analytics flush")
    tenant_deg = sum(i.analytics.tenant_totals()["degraded"]
                     for i in insts) - tenant_deg0
    lim100 = (ctx.owner == 2) & ~is_out
    lim100[:ctx.n_all] = False
    cluster_under = np.zeros(len(ctx.pop_idx), np.int64)
    for r, v in ctx.tally.under.items():
        if r >= 0:
            cluster_under[r] = len(v)
    over = np.maximum(cluster_under + under2 - ctx.limit, 0)[lim100]
    res = {"windows": windows, "eject_ms_after_arming": eject_ms,
           "readmit_ms_after_clearing": readmit_ms,
           "ring_generation_before": gen0, "ring_generation_after": gen1,
           "degraded_served": deg_metric, "rows_flagged": flagged,
           "fault_injected": fault_metric, "drain_ms": drain_ms,
           "launches": launches, "leaks": leaks,
           "outage_hits": int(sent_out[out_ranks].sum()),
           "over_admission_max": int(over.max()) if over.size else 0,
           "over_admission_sum": int(over.sum()),
           "hits_degraded": totals.get("hits_degraded", 0),
           "healthy_cluster_decisions_per_s": ctx.healthy_rate,
           "tenant_degraded": tenant_deg,
           "forced_traces_degraded_window": forced,
           "fail_on_burn_before_arming": burn_rc0, "slo": slo_windows,
           "slo_cooled_s_before_arming": cooled_s}
    print(f"outage: {json.dumps({k: v for k, v in res.items() if k != 'windows'})}",
          flush=True)
    require(windows["degraded"]["degraded_rows"] > 0
            and windows["rehomed"]["degraded_rows"] > 0,
            "no row was served degraded during the outage")
    require(windows["recovered"]["degraded_rows"] == 0,
            "rows were served degraded after daemon 2 was readmitted")
    require(deg_metric == flagged,
            f"gubernator_degraded_served {deg_metric} != {flagged} rows "
            "flagged")
    require(tenant_deg == deg_metric,
            f"tenants count {tenant_deg} degraded rows, "
            f"gubernator_degraded_served {deg_metric}")
    require(all(forced), f"no degraded serve's trace was kept at sample "
            f"0: {forced}")
    require(all(g1 - g0 == 2 for g0, g1 in zip(gen0[:2], gen1[:2])),
            f"ring generations {gen0} -> {gen1}: not two bumps each")
    require(leaks == 0, f"{leaks} leases leaked")
    require(launches > 0, "K1 never launched in the outage phase")
    return res


def await_no_breach(d, bound_s: float) -> float:
    """Seconds until the daemon is healthy with no SLO breached (polled
    on /healthz?deep=1); fails past ``bound_s``, printing the SLOs."""
    t0 = time.monotonic()
    while True:
        _, h = get_json(d.http_port, "/healthz?deep=1")
        if h["status"] == "healthy" and not h["slo"]["breached"]:
            return time.monotonic() - t0
        if time.monotonic() - t0 >= bound_s:
            slo_check(d, f"{d.advertise_address} before the outage")
        require(time.monotonic() - t0 < bound_s,
                f"{d.advertise_address} still {h['status']}, breached "
                f"{h['slo']['breached']} after {bound_s} s")
        time.sleep(0.2)


def fail_on_burn(d) -> int:
    """``cmd/healthcheck.py --fail-on-burn``'s exit code against a
    daemon (its output kept off this script's)."""
    import contextlib
    import io

    from gubernator_tpu_torch.cmd.healthcheck import main

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(["--url", f"http://127.0.0.1:{d.http_port}/healthz",
                     "--fail-on-burn", "--timeout", "30"])


def outage_slo(c, t_arm: float, check_cli: bool = False) -> dict:
    """Daemons 0 and 1 at the end of an outage window: error_ratio's
    fast and slow burns and breach (both burns above the threshold, the
    JAX rule), the seconds from arming to its breach event, the
    fleet_conservation SLO's value (the seconds the audit drift has
    been nonzero: hits parked for daemon 2); with ``check_cli`` the
    --fail-on-burn exit code, which must be 1 exactly when the daemon
    is unhealthy (a failing hits flush) or error_ratio has breached."""
    out = {}
    for i in (0, 1):
        d = c.daemons[i]
        snap = d.instance.slo.snapshot()
        rows = {r["slo"]: r for r in snap["slos"] if "tenant" not in r}
        er, fc = rows["error_ratio"], rows["fleet_conservation"]
        breaches = [e for e in d.instance.recorder.events(kind="slo_breach")
                    if e["slo"] == "error_ratio"
                    and e["t_ms"] >= t_arm * 1000]
        row = {"error_ratio_fast_burn": er["fast_burn"],
               "error_ratio_slow_burn": er["slow_burn"],
               "error_ratio_breached": er["breached"],
               "breach_s_after_arming": (
                   (breaches[0]["t_ms"] - t_arm * 1000) / 1000
                   if breaches else None),
               "fleet_conservation_s": fc.get("value"),
               "fleet_conservation_target_s": fc.get("target"),
               "decision_p99_s": rows["decision_p99"].get("value"),
               "burn_threshold": snap["burn_threshold"]}
        if check_cli:
            code, health = get_json(d.http_port, "/healthz?deep=1")
            rc = fail_on_burn(d)
            want = int(health["status"] != "healthy"
                       or "error_ratio" in health["slo"]["breached"])
            row.update(status=health["status"],
                       breached=health["slo"]["breached"],
                       fail_on_burn_rc=rc)
            require(rc == want, f"--fail-on-burn exited {rc} on daemon {i}"
                    f" ({health['status']}, breached "
                    f"{health['slo']['breached']})")
        out[i] = row
    print(f"outage slo: {json.dumps(out)}", flush=True)
    return out


def group_worker_env(args, snap_dir: str, state: dict):
    """``worker_env`` of the group: once the workers' peer addresses are
    drawn, the 10M keys are placed by their ring (fit to each worker's
    table beside its warm-up key) and written as one snapshot per worker,
    which each worker restores at start (its Loader path); the 16
    hottest ranks at limit 100 and the next 16 at EXACT_GLOBAL_LIMIT."""
    import os

    from gubernator_tpu_torch.peers import ReplicatedConsistentHash
    from gubernator_tpu_torch.store import save_arrays
    from gubernator_tpu_torch.types import PeerInfo

    def env(i: int, addrs: list) -> dict:
        if state.get("addrs") != addrs:
            t0 = time.perf_counter()
            ring = ReplicatedConsistentHash()
            for a in addrs:
                ring.add(_RingPeer(PeerInfo(grpc_address=a)))
            pop_idx, pop_keys, owner_pi = fit_cluster_population(
                args.keys, args.cluster_log2_cap, ring)
            by_addr = {a: j for j, a in enumerate(addrs)}
            owner = np.array([by_addr[p.info.grpc_address]
                              for p in ring.owner_peers()])[owner_pi]
            lim = np.full(len(pop_keys), 100, np.int64)
            lim[GLOBAL_RANKS:GLOBAL_RANKS + EXACT_GLOBAL_RANKS] = \
                EXACT_GLOBAL_LIMIT
            fill_t = int(time.time() * 1000) - 1_000
            paths = [os.path.join(snap_dir, f"worker{j}.npz")
                     for j in range(len(addrs))]
            writers = [threading.Thread(target=save_arrays, args=(
                paths[j], token_rows(pop_keys[owner == j], lim[owner == j],
                                     3_600_000, fill_t)))
                for j in range(len(addrs))]
            for w in writers:
                w.start()
            for w in writers:
                w.join()
            state.update(addrs=list(addrs), pop_idx=pop_idx,
                         pop_keys=pop_keys, owner=owner, paths=paths,
                         write_s=time.perf_counter() - t0)
        return {"GUBER_SNAPSHOT_PATH": state["paths"][i]}

    return env


def group_metric(addr: str, name: str, labels=()) -> float:
    """One sample of a group worker's /metrics (0 when absent)."""
    return scrape_metrics(int(addr.rsplit(":", 1)[1])).get(
        (name, tuple(sorted(labels))), 0.0)


def group_api(g) -> list:
    """Each worker's GetRateLimits requests of call type api (client
    requests it answered) and peer (forwarded rows it applied)."""
    out = []
    for a in g.http_addresses:
        m = scrape_metrics(int(a.rsplit(":", 1)[1]))
        out.append((m.get(("gubernator_getratelimit_total",
                           (("calltype", "api"),)), 0.0),
                    m.get(("gubernator_getratelimit_total",
                           (("calltype", "peer"),)), 0.0)))
    return out


def group_launches(g) -> list:
    """Each worker's K1 launches since it started (GET /debug/kernels:
    the wrapper's own count in that process)."""
    out = []
    for i, a in enumerate(g.http_addresses):
        code, body = get_json(int(a.rsplit(":", 1)[1]), "/debug/kernels")
        require(code == 200, f"group worker {i}: /debug/kernels {code}")
        out.append(body["decide"])
    return out


def group_channels(g, n: int, raw_unary, encode, probe_req) -> tuple:
    """``n`` channels to the shared client port, each its own TCP
    connection, kept so that every worker holds at least one: a new
    channel's first (hits=0) call is traced to the worker whose api
    counter moved.  Returns (channels, the worker of each)."""
    import grpc

    need = len(g.procs)
    kept, where = [], []
    data = encode([probe_req])
    for _ in range(64 * n):
        if len(kept) == n:
            break
        ch = grpc.insecure_channel(
            g.client_address,
            options=[("grpc.use_local_subchannel_pool", 1)])
        before = [a for a, _ in group_api(g)]
        raw_unary(ch, "GetRateLimits")(data, timeout=60)
        moved = [i for i, (a, _) in enumerate(group_api(g))
                 if a > before[i]]
        require(len(moved) == 1, f"a probe moved {moved} workers' counters")
        w = moved[0]
        uncovered = set(range(need)) - set(where) - {w}
        if w in where and len(kept) + len(uncovered) >= n:
            ch.close()
            continue
        kept.append(ch)
        where.append(w)
    require(len(kept) == n and set(where) == set(range(need)),
            f"could not reach every worker over {n} connections: {where}")
    return kept, where


def phase_group(torch, args, cluster_rate=None, solo_rate=None) -> dict:
    """The subprocess group: GROUP_NODES worker processes (each its own
    interpreter and a 2^cluster_log2_cap-row bucket engine on DEVICE,
    the card shared), one SO_REUSEPORT client port, the cluster phase's
    10M keys restored on their ring owners from per-worker snapshots and
    its traffic from 8 callers on their own connections; then one worker
    is SIGKILLed while the callers send."""
    import shutil
    import tempfile

    import grpc

    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    limit, duration, n_glob = 100, 3_600_000, GLOBAL_RANKS
    n_all = GLOBAL_RANKS + EXACT_GLOBAL_RANKS

    def limit_of(r):
        return EXACT_GLOBAL_LIMIT if n_glob <= r < n_all else limit

    # the cluster phase's behaviors, as the workers' environment
    names = {"peer_eject_after_ms": "GUBER_PEER_EJECT_AFTER",
             "peer_readmit_after_ms": "GUBER_PEER_READMIT_AFTER"}
    env_extra = {names[k]: f"{v}ms" for k, v in
                 CLUSTER_BEHAVIOR_OVERRIDES.items() if k in names}
    snap_dir = tempfile.mkdtemp(prefix="guber-group-")
    state: dict = {}
    t0 = time.perf_counter()
    try:
        g = cluster.start_subprocess_group(
            GROUP_NODES, device=DEVICE,
            cache_size=1 << args.cluster_log2_cap, batch_rows=1024,
            ready_timeout=600.0, env_extra=env_extra,
            worker_env=group_worker_env(args, snap_dir, state),
            log_dir=snap_dir)
    except BaseException:
        shutil.rmtree(snap_dir, ignore_errors=True)
        raise
    res: dict = {"workers": GROUP_NODES, "start_s": time.perf_counter() - t0,
                 "snapshot_write_s": state["write_s"],
                 "per_worker_keys": np.bincount(
                     state["owner"], minlength=GROUP_NODES).tolist()}
    print(f"group: {GROUP_NODES} worker processes on {DEVICE} up in "
          f"{res['start_s']:.2f} s (snapshots of {res['per_worker_keys']} "
          f"keys written in {res['snapshot_write_s']:.2f} s), client port "
          f"{g.client_address}", flush=True)
    chans = []
    try:
        pop_idx, owner = state["pop_idx"], state["owner"]
        key_of = lambda r: f"k{pop_idx[r]:08d}"  # noqa: E731
        warm = RateLimitRequest(name="smoke", unique_key=key_of(n_all),
                                hits=0, limit=limit, duration=duration)
        chans, where = group_channels(g, args.threads, raw_unary,
                                      encode_get_rate_limits, warm)
        res["connections_per_worker"] = np.bincount(
            where, minlength=GROUP_NODES).tolist()
        calls = [raw_unary(ch, "GetRateLimits") for ch in chans]
        rpc = [lambda b, call=call: call(b, timeout=120) for call in calls]
        rng = np.random.default_rng(args.seed + 5)
        tally = Tally(limit)
        glob_under = np.zeros(n_glob, np.int64)
        exact_sent = np.zeros(n_all, np.int64)
        api0, launch0 = group_api(g), group_launches(g)

        def check_round(per, raw, allow_degraded=None, excluded=None):
            """Decode, check and tally one round's answers; rows of keys
            in ``allow_degraded`` (a mask over ranks) may come back
            degraded, or `rate limit table full` (a survivor's bucket
            with no room for a key that never lived there); batches in
            ``excluded`` count apart.  Returns (rows, rows degraded,
            the ranks of the table-full rows)."""
            n_req = n_deg = 0
            full = []
            plain_per, plain_res = [], {}
            for t, thread in enumerate(per):
                plain_per.append([])
                plain_res[t] = []
                for b, (ranks, data) in enumerate(zip(thread, raw[t])):
                    resps = decode_responses(data)
                    require(len(resps) == len(ranks), "short response")
                    n_req += len(ranks)
                    for r, resp in zip(ranks.tolist(), resps):
                        if (resp.error == TABLE_FULL
                                and allow_degraded is not None
                                and allow_degraded[r]):
                            full.append(r)
                            continue
                        require(not resp.error, resp.error)
                        if resp.degraded:
                            require(allow_degraded is not None
                                    and allow_degraded[r],
                                    f"key {r} of a live worker came back "
                                    "degraded")
                            n_deg += 1
                    if excluded is not None and (t, b) in excluded:
                        continue
                    g_ = ranks < n_all
                    if allow_degraded is None:
                        for r, resp in zip(
                                ranks[g_].tolist(),
                                [resps[j] for j in np.nonzero(g_)[0]]):
                            if r < n_glob:
                                glob_under[r] += resp.status == 0
                            else:
                                require(resp.status == 0, "a GLOBAL key "
                                        "under a limit of 10^9 went OVER")
                        exact_sent[:] += np.bincount(ranks[g_],
                                                     minlength=n_all)
                    keep = ~g_
                    if allow_degraded is not None:
                        keep &= ~allow_degraded[ranks]
                    plain_per[t].append(ranks[keep])
                    plain_res[t].append([resps[j]
                                         for j in np.nonzero(keep)[0]])
            tally.add(plain_per, plain_res)
            return n_req, n_deg, full

        rounds = []
        for rnd in range(args.cluster_rounds):
            per = [[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
                    for _ in range(args.batches)]
                   for _ in range(args.threads)]
            jobs = wire_jobs(per, key_of, limit, duration,
                             lambda r: 2 if r < n_all else 0, limit_of)
            t_start, wall, lat, raw = drive(rpc, jobs)
            n_req, _, _ = check_round(per, raw)
            lat_ms = np.asarray(lat) * 1e3
            rec = {"wall_s": wall, "decisions_per_s": n_req / wall,
                   "batches": len(lat),
                   "p50_ms": float(np.percentile(lat_ms, 50)),
                   "p99_ms": float(np.percentile(lat_ms, 99)),
                   "max_ms": float(lat_ms.max()), "lat": lat}
            rounds.append(rec)
            print(f"group round {rnd}: "
                  f"{json.dumps({k: v for k, v in rec.items() if k != 'lat'})}",
                  flush=True)
        launches = [b - a for a, b in zip(launch0, group_launches(g))]
        api1 = group_api(g)
        res["answered_per_worker"] = [a1 - a0 for (a0, _), (a1, _)
                                      in zip(api0, api1)]
        res["peer_rows_per_worker"] = [p1 - p0 for (_, p0), (_, p1)
                                       in zip(api0, api1)]
        # the 10^9 keys: exactly the limit less the hits sent, on every
        # worker (each probed on its own peer port, hits=0), and the
        # limit-100 keys alike on every worker
        probe = encode_get_rate_limits([RateLimitRequest(
            name="smoke", unique_key=key_of(r), hits=0, limit=limit_of(r),
            duration=duration, behavior=2) for r in range(n_all)])
        want = (EXACT_GLOBAL_LIMIT - exact_sent[n_glob:]).tolist()
        peer_chans = [grpc.insecure_channel(a) for a in g.grpc_addresses]
        t_conv = time.monotonic()
        deadline = t_conv + CONVERGE_S
        attempts = 0
        try:
            while True:
                attempts += 1
                rem = [[x.remaining for x in decode_responses(
                    raw_unary(ch, "GetRateLimits")(probe, timeout=60))]
                    for ch in peer_chans]
                converged = (all(row == rem[0] for row in rem)
                             and rem[0][n_glob:] == want)
                if converged or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for ch in peer_chans:
                ch.close()
        conv_ms = (time.monotonic() - t_conv) * 1e3
        print(f"group GLOBAL convergence after {attempts} attempts "
              f"({conv_ms:.1f} ms): {converged}; 10^9-limit keys read "
              f"{rem[0][n_glob:]}, want {want}", flush=True)
        require(converged, f"the group's GLOBAL keys did not converge: "
                f"{rem}; want {want}")
        timed_lat = np.concatenate([np.asarray(r["lat"])
                                    for r in rounds]) * 1e3
        rates = [r["decisions_per_s"] for r in rounds]
        rate = float(np.mean(rates))
        over = np.maximum(glob_under - limit, 0)
        res.update({
            "decisions_per_s": rate, "decisions_per_s_rounds": rates,
            "p50_ms": float(np.percentile(timed_lat, 50)),
            "p99_ms": float(np.percentile(timed_lat, 99)),
            "share_of_cluster": rate / cluster_rate if cluster_rate
            else None,
            "share_of_solo_wire": rate / solo_rate if solo_rate else None,
            "launches_per_worker": launches, "launches": sum(launches),
            "global_over_admission_max": int(over.max()),
            "exact_global_hits": int(exact_sent[n_glob:].sum()),
            "convergence_attempts": attempts, "convergence_ms": conv_ms,
            "device_busy_share": "not measured (the workers are other "
                                 "processes)"})
        print(f"group: {rate} decisions/s ({rates}), p50 {res['p50_ms']} "
              f"ms p99 {res['p99_ms']} ms; {res['share_of_cluster']} of "
              f"the in-process cluster's rate, {res['share_of_solo_wire']} "
              f"of the solo wire path's; connections per worker "
              f"{res['connections_per_worker']}; client requests answered "
              f"per worker {res['answered_per_worker']}, forwarded rows "
              f"applied {res['peer_rows_per_worker']}; K1 launches per "
              f"worker {launches}; GLOBAL over-admission max "
              f"{res['global_over_admission_max']}", flush=True)
        require(all(a > 0 for a in res["answered_per_worker"]),
                f"a worker answered no client request: "
                f"{res['answered_per_worker']}")
        require(DEVICE != "cuda" or all(n > 0 for n in launches),
                f"a worker never launched K1: {launches}")
        res["kill"] = group_kill(g, args, chans, rpc, rng, state, key_of,
                                 limit, duration, n_all, limit_of,
                                 check_round, raw_unary)
        tally.check(exclude=res["kill"].pop("excluded_keys"))
        res["checked_requests"] = tally.n_req
    except BaseException:
        for i in range(len(g.procs)):
            print(f"group worker {i} log tail: {g.log_tail(i)}", flush=True)
        raise
    finally:
        for ch in chans:
            ch.close()
        g.stop()
        shutil.rmtree(snap_dir, ignore_errors=True)
    return res


def group_kill(g, args, chans, rpc, rng, state, key_of, limit, duration,
               n_all, limit_of, check_round, raw_unary) -> dict:
    """SIGKILL the last worker while the 8 callers send: a caller whose
    connection dies retries its batch on a new connection (the kernel
    then picks a live worker); the survivors' forwards to the dead
    worker fail and serve its keys degraded until their health gates
    eject it, then they serve its keys rehomed (degraded too).  Runs
    until both survivors ejected it and GROUP_KILL_AFTER_S more.  No
    error row; only the dead worker's keys may come back degraded; the
    survivors' own keys stay exact, but for the keys of a batch whose
    call failed at the transport (its first try may have applied)."""
    import grpc

    pop_idx, owner = state["pop_idx"], state["owner"]
    dead = len(g.procs) - 1
    dead_addr = g.grpc_addresses[dead]
    survivors = [i for i in range(len(g.procs)) if i != dead]
    dead_key = owner == dead
    may_full = rehomed_may_fill(args, state["pop_keys"], owner, dead,
                                survivors)
    per = [[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
            for _ in range(GROUP_KILL_MAX_BATCHES)]
           for _ in range(args.threads)]
    jobs = wire_jobs(per, key_of, limit, duration,
                     lambda r: 2 if r < n_all else 0, limit_of)
    index = {id(b): (t, j) for t, thread in enumerate(jobs)
             for j, b in enumerate(thread)}
    mu = threading.Lock()
    retried: set = set()
    failures = []

    def resilient(t):
        def call(batch):
            for attempt in range(10):
                try:
                    return rpc[t](batch)
                except grpc.RpcError as e:
                    with mu:
                        failures.append((t, str(e.code())))
                        retried.add(index[id(batch)])
                    ch = grpc.insecure_channel(
                        g.client_address,
                        options=[("grpc.use_local_subchannel_pool", 1)])
                    chans[t] = ch
                    call_ = raw_unary(ch, "GetRateLimits")
                    rpc[t] = lambda b, c=call_: c(b, timeout=120)
                    time.sleep(0.05 * (attempt + 1))
            raise RuntimeError(f"caller {t}: 10 transport failures")
        return call

    seq0 = {}
    for i in survivors:
        _, body = get_json(int(g.http_addresses[i].rsplit(":", 1)[1]),
                           "/debug/events?kind=ring_ejected")
        seq0[i] = max([e["seq"] for e in body["events"]], default=0)
    deg0 = sum(group_metric(g.http_addresses[i],
                            "gubernator_degraded_served_total",
                            (("peer_addr", dead_addr),))
               for i in survivors)
    stop_at = [None]
    out: dict = {}
    runner = threading.Thread(target=lambda: out.update(res=drive(
        [resilient(t) for t in range(args.threads)], jobs,
        stop=lambda: stop_at[0] is not None
        and time.monotonic() > stop_at[0])))
    runner.start()
    time.sleep(GROUP_KILL_WARM_S)
    t_kill = time.time()
    g.kill(dead)
    ejected = {}
    deadline = time.monotonic() + FLIP_S
    while len(ejected) < len(survivors) and time.monotonic() < deadline:
        for i in survivors:
            if i in ejected:
                continue
            _, body = get_json(int(g.http_addresses[i].rsplit(":", 1)[1]),
                               "/debug/events?kind=ring_ejected")
            evs = [e for e in body["events"]
                   if e["seq"] > seq0[i] and e["peer"] == dead_addr]
            if evs:
                ejected[i] = evs[0]["t_ms"] - t_kill * 1000
        time.sleep(0.05)
    stop_at[0] = time.monotonic() + GROUP_KILL_AFTER_S
    runner.join()
    require(len(ejected) == len(survivors),
            f"the survivors did not eject the killed worker: {ejected}")
    t_start, wall, lat, raw = out["res"]
    sent_per = [thread[:len(raw[t])] for t, thread in enumerate(per)]
    excluded = set(retried)
    n_req, n_deg, full = check_round(sent_per, raw,
                                     allow_degraded=dead_key,
                                     excluded=excluded)
    full_keys = np.unique(np.asarray(full, np.int64))
    require(may_full[full_keys].all(), f"`table full` on keys "
            f"{full_keys[~may_full[full_keys]].tolist()} of the dead "
            "worker whose bucket on every survivor has room for them")
    deg = sum(group_metric(g.http_addresses[i],
                           "gubernator_degraded_served_total",
                           (("peer_addr", dead_addr),))
              for i in survivors) - deg0
    excluded_keys = set(np.nonzero(dead_key)[0].tolist())
    for t, j in excluded:
        excluded_keys.update(per[t][j].tolist())
    lat_ms = np.asarray(lat) * 1e3
    res = {"killed": dead, "eject_ms_after_kill": [ejected[i]
                                                   for i in survivors],
           "requests": n_req, "decisions_per_s": n_req / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "rows_degraded": n_deg, "degraded_served_counter": deg,
           "table_full_rows_of_the_dead_workers_keys": len(full),
           "table_full_keys": len(full_keys),
           "keys_that_may_find_no_room": int(may_full.sum()),
           "transport_failures": len(failures),
           "batches_retried": len(retried),
           "failure_codes": sorted({c for _, c in failures}),
           "keys_excluded_for_retries": len(excluded_keys) - int(
               dead_key.sum()),
           "excluded_keys": excluded_keys}
    print(f"group kill: {json.dumps({k: v for k, v in res.items() if k != 'excluded_keys'})}",
          flush=True)
    require(n_deg > 0, "no row was served degraded after the kill")
    require(deg == n_deg, f"gubernator_degraded_served counts {deg}, "
            f"{n_deg} rows came back flagged")
    return res


def rehomed_may_fill(args, pop_keys, owner, dead: int,
                     survivors) -> np.ndarray:
    """Mask of the dead worker's keys that may find their 8-slot bucket
    full on a survivor: a survivor serves any of them (degraded before
    its gate ejects the dead worker, rehomed after) into the bucket
    that already holds its own restored keys and its warm-up key, so a
    key may find no room where those and the dead worker's keys of the
    same bucket together exceed the 8 slots."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    nb = 1 << (args.cluster_log2_cap - 3)
    bucket = (pop_keys & np.uint64(nb - 1)).astype(np.int64)
    warm = int(hash_request_keys(["_warmup"], ["w"])[0] & np.uint64(nb - 1))
    dead_key = owner == dead
    dead_in = np.bincount(bucket[dead_key], minlength=nb)
    out = np.zeros(len(pop_keys), bool)
    for s in survivors:
        held = np.bincount(bucket[owner == s], minlength=nb)
        held[warm] += 1
        out |= dead_key & (held[bucket] + dead_in[bucket] > 8)
    return out


def fit_region_population(n_keys: int, log2_cap: int, rings):
    """n_keys key indices and hashes that fit their 8-slot bucket in
    their owner's 2^log2_cap-row table in EVERY region (one ring each,
    beside each daemon's warm-up key), with their owner in each region
    (indices into that ring's ``owner_peers()``)."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    warm = hash_request_keys(["_warmup"], ["w"])
    idx = np.arange(int(n_keys * 1.01) + 1000, dtype=np.int64)
    keys = smoke_hashes(idx)
    nb = 1 << (log2_cap - 3)
    ok = np.ones(len(keys), bool)
    owners = []
    for ring in rings:
        n_own = len(ring.owner_peers())
        own = ring.owner_indices(keys)
        bucket = (np.concatenate([np.arange(n_own), own]).astype(np.int64)
                  * nb + (np.concatenate([np.repeat(warm, n_own), keys])
                          & np.uint64(nb - 1)).astype(np.int64))
        ok &= bucket_fit(bucket)[n_own:]
        owners.append(own)
    sel = np.nonzero(ok)[0][:n_keys]
    return idx[sel], keys[sel], [o[sel] for o in owners]


def probe_regions(c, probe) -> list:
    """Each daemon's remaining of each probed key (its hits=0 wire
    call: a non-owner forwards it to the key's owner in its region)."""
    return [[x.remaining for x in decode_responses(
        d.instance.get_rate_limits_wire(probe))] for d in c.daemons]


def mr_queued(c) -> int:
    """MULTI_REGION hits waiting in every daemon's queue."""
    return sum(d.instance.mr_manager.queued()["hits"] for d in c.daemons
               if d.instance.mr_manager is not None)


def default_deadline_round(c, region_round, probe, n_mr, exact_sent,
                           members) -> dict:
    """One more round of the regions' traffic at the default send
    deadline (BehaviorConfig's multi_region_timeout_ms), measured, not
    held exact: a send that outlives the deadline loses its hits.  Once
    the queues are empty and the counters still, each region's 10^9
    keys read short of the hits sent to both regions by the hits its
    failed sends dropped; a key may never read below that (a hit counted
    twice).  Returns the failed sends (counted from the manager's
    warnings), the hits lost per region and the round's rate."""
    import logging

    from gubernator_tpu_torch.config import BehaviorConfig

    class Count(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.n = 0

        def emit(self, record):
            self.n += record.getMessage().startswith("multi-region sync ")

    deadline_ms = BehaviorConfig().multi_region_timeout_ms
    for d in c.daemons:
        d.instance._ensure_mr_manager().behaviors.multi_region_timeout_ms \
            = deadline_ms
    b = c.daemons[0].instance.mr_manager.behaviors
    failed = Count()
    logger = logging.getLogger("gubernator_tpu_torch.multiregion")
    logger.addHandler(failed)
    try:
        sent0 = int(exact_sent[n_mr:].sum())
        rec = region_round(f"the default {deadline_ms} ms send deadline")
        t_end = time.monotonic()
        stop = t_end + CONVERGE_S
        while mr_queued(c) and time.monotonic() < stop:
            time.sleep(0.02)
        # the last tick's sends have had their deadline; then nothing
        # may move over three more ticks
        time.sleep((b.multi_region_sync_wait_ms + deadline_ms) / 1000.0)
        while True:
            rem = probe_regions(c, probe)
            time.sleep(3 * b.multi_region_sync_wait_ms / 1000.0)
            if probe_regions(c, probe) == rem or time.monotonic() > stop:
                break
        require(probe_regions(c, probe) == rem and not mr_queued(c),
                "the regions never settled at the default send deadline")
        settle_ms = (time.monotonic() - t_end) * 1e3
    finally:
        logger.removeHandler(failed)
    want = EXACT_GLOBAL_LIMIT - exact_sent[n_mr:]
    short = {dc: np.asarray(rem[members[dc][0]][n_mr:]) - want
             for dc in members}
    require(all((v >= 0).all() for v in short.values()),
            f"a 10^9 key read below the hits sent: {short}")
    out = {**rec, "send_deadline_ms": deadline_ms, "failed_sends": failed.n,
           "hits_lost": {dc: int(v.sum()) for dc, v in short.items()},
           "keys_short": {dc: int((v > 0).sum()) for dc, v in short.items()},
           "hits_sent": int(exact_sent[n_mr:].sum()) - sent0,
           "settle_ms": settle_ms}
    print(f"regions at the default send deadline: {json.dumps(out)}",
          flush=True)
    return out


def phase_regions(torch, args, solo_rate=None) -> dict:
    """2 regions x REGION_NODES daemons in this process (dc-east,
    dc-west: the JAX package's test layout), each a
    2^cluster_log2_cap-row bucket engine on DEVICE; phase 5's 10M keys
    restored on their owner in each region; 8 callers over gRPC, half
    to each region; the MR_RANKS hottest ranks MULTI_REGION at limit 100
    and the next EXACT_MR_RANKS at EXACT_GLOBAL_LIMIT.  Checked: after
    the sync wait and timeout each 10^9 key reads, on its owner in each
    region, the limit less the hits sent to both regions; a further
    quiet wait changes nothing; an armed mr_sync tick loses no hit;
    every other key exact in its region."""
    import grpc

    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
    from gubernator_tpu_torch.grpc_api import raw_unary
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.peers import ReplicatedConsistentHash
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    limit, duration, n_mr = 100, 3_600_000, MR_RANKS
    n_all = MR_RANKS + EXACT_MR_RANKS
    mr = 16  # Behavior.MULTI_REGION

    def limit_of(r):
        return EXACT_GLOBAL_LIMIT if n_mr <= r < n_all else limit

    behaviors = BehaviorConfig(**CLUSTER_BEHAVIOR_OVERRIDES,
                               **REGION_BEHAVIOR_OVERRIDES)
    c = cluster.start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=1 << args.cluster_log2_cap, batch_rows=1024,
        device=DEVICE, data_center=dc, behaviors=behaviors)
        for dc in REGIONS for _ in range(REGION_NODES)])
    chans = []
    n_daemons = len(REGIONS) * REGION_NODES
    try:
        region_of = [d.cfg.data_center for d in c.daemons]
        members = {dc: [i for i, x in enumerate(region_of) if x == dc]
                   for dc in REGIONS}
        rings = []
        for dc in REGIONS:
            ring = ReplicatedConsistentHash()
            for i in members[dc]:
                ring.add(_RingPeer(c.daemons[i].peer_info()))
            rings.append(ring)
        t0 = time.perf_counter()
        pop_idx, pop_keys, owners_pi = fit_region_population(
            args.keys, args.cluster_log2_cap, rings)
        by_addr = {d.advertise_address: i for i, d in enumerate(c.daemons)}
        owner = [np.array([by_addr[p.info.grpc_address]
                           for p in ring.owner_peers()])[opi]
                 for ring, opi in zip(rings, owners_pi)]
        for ring, dc, own in zip(rings, REGIONS, owner):
            sample = np.arange(0, len(pop_idx), max(len(pop_idx) // 300, 1))
            inst = c.daemons[members[dc][0]].instance
            require(all(by_addr[inst.owner_of(
                f"smoke_k{pop_idx[j]:08d}").info.grpc_address] == own[j]
                for j in sample), f"the smoke's {dc} ring differs")
        fill_t = int(time.time() * 1000) - 1_000
        pop_limit = np.full(len(pop_keys), limit, np.int64)
        pop_limit[n_mr:n_all] = EXACT_GLOBAL_LIMIT
        placed = {}

        def fill(i, mine):
            with c.daemons[i].instance._engine_mu:
                placed[i] = (c.daemons[i].instance.engine.restore(token_rows(
                    pop_keys[mine], pop_limit[mine], duration, fill_t)),
                    int(mine.sum()))

        # the four daemons' restores side by side
        fills = [threading.Thread(target=fill, args=(i, own == i))
                 for own in owner for i in np.unique(own).tolist()]
        for th in fills:
            th.start()
        for th in fills:
            th.join()
        require(len(placed) == n_daemons and all(
            a == b for a, b in placed.values()), f"placed {placed}")
        print(f"regions fill: {len(pop_keys)} TOKEN keys on their owner in "
              f"each of {list(REGIONS)} in {time.perf_counter() - t0:.2f} "
              f"s", flush=True)
        n = len(c.daemons)
        chans = [grpc.insecure_channel(f"127.0.0.1:{d.grpc_port}")
                 for d in c.daemons]
        target = [t % n for t in range(args.threads)]
        calls = [raw_unary(chans[target[t]], "GetRateLimits")
                 for t in range(args.threads)]
        rpc = [lambda b, call=call: call(b, timeout=120) for call in calls]
        key_of = lambda r: f"k{pop_idx[r]:08d}"  # noqa: E731
        rng = np.random.default_rng(args.seed + 6)
        tallies = {dc: Tally(limit) for dc in REGIONS}
        mr_under = {dc: np.zeros(n_mr, np.int64) for dc in REGIONS}
        exact_sent = np.zeros(n_all, np.int64)
        decide_cuda.launches = 0

        def region_round(label: str) -> dict:
            """One round of the callers' traffic: no error row, no row
            degraded, the 10^9 keys never OVER; the other keys tallied
            per region, the MULTI_REGION keys' hits counted."""
            per = [[zipf_ranks(rng, 1.1, len(pop_idx), 1000)
                    for _ in range(args.batches)]
                   for _ in range(args.threads)]
            jobs = wire_jobs(per, key_of, limit, duration,
                             lambda r: mr if r < n_all else 0, limit_of)
            _, wall, lat, raw = drive(rpc, jobs)
            n_req = 0
            plain = {dc: ([], {}) for dc in REGIONS}
            for t, thread in enumerate(per):
                dc = region_of[target[t]]
                pp, pr = plain[dc]
                k = len(pp)
                pp.append([])
                pr[k] = []
                for ranks, data in zip(thread, raw[t]):
                    resps = decode_responses(data)
                    require(len(resps) == len(ranks), "short response")
                    n_req += len(ranks)
                    m = ranks < n_all
                    for r, resp in zip(ranks[m].tolist(),
                                       [resps[j] for j in np.nonzero(m)[0]]):
                        require(not resp.error, resp.error)
                        require(not resp.degraded, "a row was served "
                                "degraded in the healthy regions")
                        if r < n_mr:
                            mr_under[dc][r] += resp.status == 0
                        else:
                            require(resp.status == 0, "a MULTI_REGION key "
                                    "under a limit of 10^9 went OVER")
                    exact_sent[:] += np.bincount(ranks[m], minlength=n_all)
                    pp[k].append(ranks[~m])
                    pr[k].append([resps[j] for j in np.nonzero(~m)[0]])
            for dc in REGIONS:
                tallies[dc].add(*plain[dc])
            lat_ms = np.asarray(lat) * 1e3
            rec = {"wall_s": wall, "decisions_per_s": n_req / wall,
                   "batches": len(lat),
                   "p50_ms": float(np.percentile(lat_ms, 50)),
                   "p99_ms": float(np.percentile(lat_ms, 99))}
            print(f"regions round, {label}: {json.dumps(rec)}", flush=True)
            return rec

        rec = region_round(f"{behaviors.multi_region_timeout_ms} ms send "
                           "deadline")
        t_end = time.monotonic()
        launches = decide_cuda.launches
        probe = encode_get_rate_limits([RateLimitRequest(
            name="smoke", unique_key=key_of(r), hits=0, limit=limit_of(r),
            duration=duration, behavior=mr) for r in range(n_all)])
        b = behaviors

        def await_exact(sent, what: str) -> float:
            """Poll until every daemon reads each 10^9 key at exactly the
            limit less ``sent`` and no hit is queued (else stop); returns
            the last reads."""
            want = (EXACT_GLOBAL_LIMIT - sent[n_mr:]).tolist()
            deadline = time.monotonic() + CONVERGE_S
            while True:
                rem = probe_regions(c, probe)
                ok = (all(row[n_mr:] == want for row in rem)
                      and mr_queued(c) == 0)
                if ok or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            require(ok, f"{what}: the 10^9 keys read {rem}, want {want}; "
                    f"{mr_queued(c)} hits queued")
            return rem

        # polled from the end of the traffic; then read once more when
        # the sync wait and the send deadline have passed
        await_exact(exact_sent, "after the traffic")
        conv_ms = (time.monotonic() - t_end) * 1e3
        time.sleep(max(0.0, (b.multi_region_sync_wait_ms
                             + b.multi_region_timeout_ms) / 1000.0
                       - (time.monotonic() - t_end)))
        want = (EXACT_GLOBAL_LIMIT - exact_sent[n_mr:]).tolist()
        rem = probe_regions(c, probe)
        require(all(row[n_mr:] == want for row in rem),
                f"after the sync wait and the send deadline the 10^9 keys "
                f"read {rem}, want {want}")
        # a quiet wait of three more sync ticks: nothing moves (no
        # ping-pong)
        time.sleep(3 * b.multi_region_sync_wait_ms / 1000.0)
        quiet = probe_regions(c, probe)
        require(quiet == rem, f"a quiet wait moved the counters: {rem} -> "
                f"{quiet}")
        send_errors = [d.instance.mr_manager.last_error for d in c.daemons
                       if d.instance.mr_manager is not None]
        require(not any(send_errors), f"a MULTI_REGION send failed: "
                f"{send_errors}")
        # one armed mr_sync tick per daemon loses no hit
        for d in c.daemons:
            d.instance.faults.arm("mr_sync:error")
        fired0 = [sum(p["fired"] for p in d.instance.faults.describe()
                      ["points"]) for d in c.daemons]
        batch = encode_get_rate_limits([RateLimitRequest(
            name="smoke", unique_key=key_of(r), hits=1, limit=limit_of(r),
            duration=duration, behavior=mr) for r in range(n_mr, n_all)])
        for dc in REGIONS:
            decode_responses(c.daemons[members[dc][0]].instance
                             .get_rate_limits_wire(batch))
            exact_sent[n_mr:] += 1
        queued_armed = mr_queued(c)
        deadline = time.monotonic() + CONVERGE_S
        while True:
            for d in c.daemons:
                d.instance._ensure_mr_manager().poke()
            fired = [sum(p["fired"] for p in d.instance.faults.describe()
                         ["points"]) for d in c.daemons]
            if all(f > f0 for f, f0 in zip(fired, fired0)) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        require(all(f > f0 for f, f0 in zip(fired, fired0)),
                "an armed mr_sync never fired")
        held = mr_queued(c)
        require(held == queued_armed == 2 * EXACT_MR_RANKS,
                f"an aborted mr_sync tick lost hits: {held} held, "
                f"{queued_armed} queued, {2 * EXACT_MR_RANKS} sent")
        for d in c.daemons:
            d.instance.faults.clear()
        await_exact(exact_sent, "after the mr_sync fault cleared")
        over = {dc: np.maximum(u - limit, 0) for dc, u in mr_under.items()}
        over["both"] = np.maximum(sum(mr_under.values()) - limit, 0)
        default = default_deadline_round(c, region_round, probe, n_mr,
                                         exact_sent, members)
        for dc in REGIONS:
            tallies[dc].check()
        res = {"daemons": n, "regions": list(REGIONS), **rec,
               "share_of_solo_wire": (rec["decisions_per_s"] / solo_rate
                                      if solo_rate else None),
               "convergence_ms": conv_ms,
               "mr_over_admission_max": {dc: int(o.max())
                                         for dc, o in over.items()},
               "mr_over_admission_sum": {dc: int(o.sum())
                                         for dc, o in over.items()},
               "exact_mr_hits": int(exact_sent[n_mr:].sum()),
               "mr_sync_held_hits": held,
               "checked_requests": {dc: t.n_req
                                    for dc, t in tallies.items()},
               "launches": launches, "default_deadline": default}
        print(f"regions: {json.dumps(res)}", flush=True)
        require(launches > 0, "the regions never launched K1")
    finally:
        for ch in chans:
            ch.close()
        c.stop()
    return res


def phase_handover(args, c, ctx) -> dict:
    """A 4th daemon (a 2^handover_log2_cap-row table) joins the cluster
    with handover_on_reshard on every daemon, through set_peers on all
    four: each old daemon sends the rows it owned that the new ring
    gives the newcomer.  Checks: every moved row the newcomer placed
    reads back (gather_rows) equal to its state before the join; the
    rows it could not place (their 8-slot bucket full) are exactly as
    many as its buckets predict (its dropped_rows counts them, and again
    for a chunk re-sent after a deadline); no old owner still holds a
    moved row."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.hashing import hash_request_keys

    for d in c.daemons:
        d.instance.config.handover_on_reshard = True
    d3 = spawn_daemon(DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=1 << args.handover_log2_cap, batch_rows=1024,
        device=DEVICE, behaviors=ctx.behaviors, handover_on_reshard=True))
    c.daemons.append(d3)
    new_ring = cluster_ring(c)
    by_addr = {d.advertise_address: i for i, d in enumerate(c.daemons)}
    old_of = np.array([by_addr[p.info.grpc_address]
                       for p in ctx.ring.owner_peers()])
    new_of = np.array([by_addr[p.info.grpc_address]
                       for p in new_ring.owner_peers()])
    fields = ("meta", "limit", "duration", "eff_ms", "remaining", "t_ms",
              "expire_at")
    moved = []  # per old daemon: (keys, {field: values})
    for i, d in enumerate(c.daemons[:3]):
        with d.instance._engine_mu:
            snap = d.instance.engine.snapshot()
        keys = np.asarray(snap["key"], np.uint64)
        m = ((old_of[ctx.ring.owner_indices(keys)] == i)
             & (new_of[new_ring.owner_indices(keys)] == 3))
        moved.append((keys[m], {f: np.asarray(snap[f])[m] for f in fields}))
        del snap, keys
    n_moved = sum(len(k) for k, _ in moved)
    keys = np.concatenate([k for k, _ in moved])
    nb = 1 << (args.handover_log2_cap - 3)
    warm = hash_request_keys(["_warmup"], ["w"])
    cnt = np.bincount((np.concatenate([warm, keys]) & np.uint64(nb - 1))
                      .astype(np.int64), minlength=nb)
    predicted = int(np.maximum(cnt - 8, 0).sum())
    dropped0 = d3.instance.engine.dropped_rows
    seq0 = [d.instance.recorder.events()[-1]["seq"] for d in c.daemons[:3]]
    infos = [d.peer_info() for d in c.daemons]
    t0 = time.perf_counter()
    for d in c.daemons:
        d.set_peers(infos)
    deadline = time.monotonic() + HANDOVER_S
    done = [None] * 3
    while True:
        for i, d in enumerate(c.daemons[:3]):
            if done[i] is None and len(moved[i][0]):
                ev = d.instance.recorder.events(kind="handover",
                                                since_seq=seq0[i])
                done[i] = ev[0] if ev else None
        if all(x is not None or not len(moved[i][0])
               for i, x in enumerate(done)) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    ms = (time.perf_counter() - t0) * 1e3
    require(all(x is not None or not len(moved[i][0])
                for i, x in enumerate(done)), f"handover unfinished: {done}")
    sent = sum(x["rows"] for x in done if x is not None)
    dropped = d3.instance.engine.dropped_rows - dropped0
    with d3.instance._engine_mu:
        found, cols = d3.instance.engine.gather_rows(keys)
    for f in fields:
        want = np.concatenate([v[f] for _, v in moved])
        require((cols[f][found] == want[found]).all(),
                f"a handed-over row differs from its state before the "
                f"join in {f}")
    held = 0
    for i, d in enumerate(c.daemons[:3]):
        with d.instance._engine_mu:
            f_old, _ = d.instance.engine.gather_rows(moved[i][0])
        held += int(f_old.sum())
    res = {"ms": ms, "rows_moved": n_moved, "rows_sent": sent,
           "rows_placed": int(found.sum()), "rows_dropped": dropped,
           "rows_dropped_predicted": predicted, "still_on_old_owner": held,
           "table_rows": 1 << args.handover_log2_cap}
    print(f"handover: {json.dumps(res)}", flush=True)
    require(sent == n_moved, f"sent {sent} of {n_moved} moved rows")
    require(held == 0, f"{held} moved rows still on their old owner")
    # a chunk re-sent after a deadline (the upsert is idempotent) counts
    # its refused rows again in dropped_rows
    require(n_moved - int(found.sum()) == predicted <= dropped,
            f"placed {int(found.sum())} of {n_moved}; {dropped} dropped, "
            f"{predicted} predicted by the buckets")
    return res


def wire_summary(stats, recs, launches, label: str,
                 profiled_last: bool) -> dict:
    """Prints each wire round's stats and the timed rounds' summary (all
    rounds but a profiled last one)."""
    n_timed = len(stats) - 1 if profiled_last else len(stats)
    for rnd, s in enumerate(stats):
        print(f"{label} round {rnd}"
              f"{' (profiled)' if rnd >= n_timed else ''}: "
              f"{json.dumps(s)}", flush=True)
    timed = stats[:n_timed]
    lat_ms = np.concatenate([np.asarray(r["lat"])
                             for r in recs[:n_timed]]) * 1e3
    rates = [s["decisions_per_s"] for s in timed]
    waits = [s["lock_wait_share_of_wave"] for s in timed
             if "lock_wait_share_of_wave" in s]
    slots = [s["max_slot"] for s in stats if s["max_slot"] is not None]
    res = {"decisions_per_s": float(np.mean(rates)),
           "decisions_per_s_min": min(rates),
           "decisions_per_s_max": max(rates),
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "worker_busy_share": float(np.mean(
               [s["worker_busy_share"] for s in timed])),
           "inline_share": float(np.mean([s["inline_share"]
                                          for s in timed])),
           "lock_wait_share_of_wave": (float(np.mean(waits)) if waits
                                       else None),
           "pipelined_waves": sum(s["pipelined_waves"] for s in stats),
           "max_slot": max(slots) if slots else None,
           "gc_gen2_ms_max": max(s["gc_gen2_ms_max"] for s in timed),
           "pool_leaks": sum(s["pool_leaks"] for s in stats),
           "requests": sum(r["n_req"] for r in recs),
           "batches": len(lat_ms), "launches": launches, "rounds": stats}
    print(f"{label}: {res['requests']} decisions; {len(timed)} timed "
          f"rounds: {res['decisions_per_s']} decisions/s (min "
          f"{res['decisions_per_s_min']}, max {res['decisions_per_s_max']});"
          f" batch p50 {res['p50_ms']} ms p99 {res['p99_ms']} ms; worker "
          f"busy {res['worker_busy_share']}; inline share "
          f"{res['inline_share']}; worker lock wait "
          f"{res['lock_wait_share_of_wave']} of a wave; pipelined waves "
          f"{res['pipelined_waves']} (largest slot {res['max_slot']}); "
          f"longest gen-2 collection {res['gc_gen2_ms_max']} ms; pool "
          f"leaks {res['pool_leaks']}; launches {launches}", flush=True)
    return res


def pipeline_compare(label: str, on: dict, off: dict) -> dict:
    """The wire path with the pipeline on and off, side by side from one
    run: rates, p50 / p99, inline share and the worker's lock wait."""
    keys = ("decisions_per_s", "p50_ms", "p99_ms", "inline_share",
            "lock_wait_share_of_wave", "worker_busy_share",
            "pipelined_waves", "max_slot", "launches")
    out = {k: {"on": on[k], "off": off[k]} for k in keys}
    print(f"{label} pipeline on vs off: {json.dumps(out)}", flush=True)
    return out


@contextmanager
def scoped_env(name: str, value: str):
    """``name`` set to ``value`` inside (instances and dispatchers read
    their GUBER_* knobs when built), restored after."""
    import os

    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def pipeline_env(value: str):
    """GUBER_PIPELINE set to ``value`` inside (a dispatcher reads it when
    it is built), restored after."""
    return scoped_env("GUBER_PIPELINE", value)


def rebuild_dispatcher(inst, timer) -> None:
    """A new dispatcher on the instance's engine (it reads the GUBER_*
    knobs anew) in place of the current one, which finishes its waves
    and stops; the timer times the new one."""
    old = inst.dispatcher
    inst.dispatcher = inst._make_dispatcher()
    old.close()
    timer.attach(inst.dispatcher)


def scrape_metrics(port: int) -> dict:
    """GET /metrics → {(sample name, sorted label pairs): value}."""
    from prometheus_client.parser import text_string_to_metric_families

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        ctype = r.headers.get("Content-Type", "")
        text = r.read().decode()
    require(ctype.startswith("text/plain"), f"/metrics content type {ctype}")
    return {(smp.name, tuple(sorted(smp.labels.items()))): smp.value
            for fam in text_string_to_metric_families(text)
            for smp in fam.samples}


def check_metrics(d, api: int, over: int) -> dict:
    """/metrics against the script's own tally: GetRateLimits requests
    of call type api since the daemon started, OVER_LIMIT answers, the
    wave-duration histogram's count against the waves the dispatcher
    reports, and no leaked wave lease."""
    m = scrape_metrics(d.http_port)
    got = {"getratelimit_api": m[("gubernator_getratelimit_total",
                                  (("calltype", "api"),))],
           "api_sent": api,
           "over_limit": m[("gubernator_over_limit_total", ())],
           "over_answers": over,
           "wave_duration_count": m[(
               "gubernator_dispatcher_wave_duration_count", ())],
           "dispatcher_waves": d.instance.dispatcher.debug_stats()["waves"],
           "wave_buffer_leaks": m[("gubernator_wave_buffer_leaks_total",
                                   ())]}
    print(f"metrics: {json.dumps(got)}", flush=True)
    require(got["getratelimit_api"] == api,
            f"/metrics counts {got['getratelimit_api']} api requests, "
            f"{api} sent")
    require(got["over_limit"] == over,
            f"/metrics counts {got['over_limit']} OVER_LIMIT, {over} seen")
    require(got["wave_duration_count"] == got["dispatcher_waves"],
            "wave-duration histogram and dispatcher disagree on waves")
    require(got["wave_buffer_leaks"] == 0, "a wave lease leaked")
    return got


def get_json(port: int, path: str) -> tuple:
    """(HTTP status, JSON body) of a GET, error statuses included."""
    import urllib.error

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_deep_health(d) -> dict:
    """/healthz?deep=1 after the rounds: healthy, no stalled wave, no
    timed-out caller, nothing queued, the pipeline at its depth."""
    code, body = get_json(d.http_port, "/healthz?deep=1")
    disp = body["dispatcher"]
    got = {"code": code, "status": body["status"],
           "stalled": disp["stalled"], "timeouts": disp["timeouts"],
           "queued_rows": disp["admission"]["queued_rows"],
           "pipeline_depth": disp["pipeline_depth"],
           "waves": disp["waves"], "stall_events": disp["stall_events"],
           "peers": body["peers"]}
    print(f"healthz deep: {json.dumps(got)}", flush=True)
    require(code == 200 and body["status"] == "healthy", f"healthz {code}")
    require(not disp["stalled"] and disp["timeouts"] == 0
            and disp["admission"]["queued_rows"] == 0,
            f"dispatcher state {disp}")
    require(disp["pipeline_depth"] == d.instance.dispatcher.pipeline_depth
            > 0, f"pipeline depth {disp['pipeline_depth']}")
    return got


def admission_round(inst, rng, n_keys: int, key_of, limit: int,
                    duration: int, args, tally) -> dict:
    """One round of wire traffic with the admission bound lowered to
    ADMISSION_ROWS: some batches must shed with ResourceExhausted
    (queue_full), the admitted ones are checked per key, and the shed
    counter must equal the rows the callers saw shed."""
    from gubernator_tpu_torch.dispatcher import ResourceExhausted

    disp, m = inst.dispatcher, inst.metrics.registry

    def shed_count():
        return m.get_sample_value("gubernator_admission_shed_total",
                                  {"reason": "queue_full"}) or 0.0

    per = [[zipf_ranks(rng, 1.1, n_keys, 1000) for _ in range(args.batches)]
           for _ in range(args.threads)]
    jobs = wire_jobs(per, key_of, limit, duration)
    errors: list = []

    def call(data):
        try:
            return inst.get_rate_limits_wire(data)
        except ResourceExhausted as e:
            errors.append(str(e))
            return None

    shed0, saved = shed_count(), disp.admission_limit
    disp.admission_limit = ADMISSION_ROWS
    try:
        t0, wall, lat, raw = drive(call, jobs)
    finally:
        disp.admission_limit = saved
    kept = {t: [decode_responses(b) for b in raw[t] if b is not None]
            for t in raw}
    kept_per = [[ids for ids, b in zip(per[t], raw[t]) if b is not None]
                for t in range(len(per))]
    shed_rows = sum(len(ids) for t in range(len(per))
                    for ids, b in zip(per[t], raw[t]) if b is None)
    tally.add(kept_per, kept)
    got = {"limit_rows": ADMISSION_ROWS, "batches": len(lat),
           "shed_batches": len(errors), "shed_rows": shed_rows,
           "shed_counter": shed_count() - shed0,
           "admitted_decisions": sum(len(b) for r in kept.values()
                                     for b in r),
           "decisions_per_s": sum(len(b) for r in kept.values()
                                  for b in r) / wall}
    print(f"admission: {json.dumps(got)}", flush=True)
    require(errors and all("queue_full" in e for e in errors),
            f"admission round shed {len(errors)} batches")
    require(got["shed_counter"] == shed_rows,
            f"shed counter {got['shed_counter']}, {shed_rows} rows shed")
    return got


def drain_check(d) -> dict:
    """Close the daemon in a thread: within its drain window /healthz
    answers 503 "draining" and a request still serves; after it a
    request sheds with "draining"; the recorder holds drain_started and
    drain_completed."""
    from gubernator_tpu_torch.dispatcher import ResourceExhausted
    from gubernator_tpu_torch.types import RateLimitRequest

    inst, port = d.instance, d.http_port
    closer = threading.Thread(target=d.close, name="drain")
    t0 = time.perf_counter()
    closer.start()
    code = body = None
    while time.perf_counter() - t0 < DRAIN_GRACE_MS / 2000:
        code, body = get_json(port, "/healthz")
        if code == 503:
            break
        time.sleep(0.005)
    seen_ms = (time.perf_counter() - t0) * 1e3
    require(code == 503 and body["status"] == "draining",
            f"healthz during the drain: {code} {body}")
    served = post_one(port, {"name": "drain", "uniqueKey": "d1", "hits": 1,
                             "limit": 3, "duration": 5000})
    served_ms = (time.perf_counter() - t0) * 1e3
    require(not served["error"] and served["remaining"] == 2,
            f"request in the drain window: {served}")
    require(served_ms < DRAIN_GRACE_MS, "served after the drain window")
    closer.join(timeout=120)
    require(not closer.is_alive(), "close() did not return")
    closed_ms = (time.perf_counter() - t0) * 1e3
    try:
        inst.get_rate_limits([RateLimitRequest(
            name="drain", unique_key="d2", hits=1, limit=3, duration=5000)])
        shed = None
    except ResourceExhausted as e:
        shed = str(e)
    kinds = [e["kind"] for e in inst.recorder.events()]
    got = {"grace_ms": DRAIN_GRACE_MS, "draining_seen_ms": seen_ms,
           "served_ms": served_ms, "closed_ms": closed_ms,
           "shed_after": shed,
           "events": [k for k in kinds if k.startswith("drain")]}
    print(f"drain: {json.dumps(got)}", flush=True)
    require(shed is not None and "draining" in shed,
            f"a request after the drain: {shed}")
    require(closed_ms >= DRAIN_GRACE_MS, "close() returned inside the grace")
    require("drain_started" in kinds and "drain_completed" in kinds,
            f"recorder events {kinds[-5:]}")
    return got


def elapsed_ms(torch, fn, *a):
    """(fn(*a), its time in ms): CUDA events around the call on the card
    (the host clock in a CPU rehearsal)."""
    if DEVICE != "cuda":
        t = time.perf_counter()
        out = fn(*a)
        return out, (time.perf_counter() - t) * 1e3
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    out = fn(*a)
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def queued_ms(torch, fn, *a, n: int = 20) -> float:
    """Mean ms of n back-to-back calls of fn(*a): on the card the stream
    spins while the host queues them, so the events span device time
    only (in a CPU rehearsal, the host clock)."""
    if DEVICE != "cuda":
        return elapsed_ms(torch, lambda: [fn(*a) for _ in range(n)])[1] / n
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(n):
        fn(*a)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_probe(torch, args):
    """K3, the toolchain probe, through probe_add on its two inputs, then
    against the plain add: equal, and the small sum is 1,047,552."""
    from gubernator_tpu_torch.ops import probe

    dev = torch.device(DEVICE)
    small = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(
        8, 128)
    rng = np.random.default_rng(args.seed + 3)
    # full int32 range: about a quarter of the sums wrap
    big_x, big_y = (torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, 1 << 24).astype(np.int32)).to(dev)
        for _ in range(2))
    probe.probe_add_cuda.launches = 0
    out_small = probe.probe_add(small, small)
    out_big, ms = elapsed_ms(torch, probe.probe_add, big_x, big_y)
    launches = probe.probe_add_cuda.launches
    _, plain_ms = elapsed_ms(torch, probe.probe_add_plain, big_x, big_y)
    err = 0
    for got, x, y in ((out_small, small, small), (out_big, big_x, big_y)):
        want = probe.probe_add_plain(x, y)
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()))
        require(torch.equal(got, want), f"K3 on {tuple(x.shape)}")
    require(int(out_small.sum()) == 1_047_552, "K3 (8, 128) sum")
    # in turns: kernel, plain, library call (torch.add, the same
    # wrapping int32 add), five times
    runs = [[queued_ms(torch, f, big_x, big_y) for f in
             (probe.probe_add_cuda if DEVICE == "cuda" else probe.probe_add,
              probe.probe_add_plain, torch.add)] for _ in range(5)]
    times, plains, libs = (list(r) for r in zip(*runs))
    res = {"launches": launches, "max_abs_err": err,
           "ms": float(np.mean(times)), "plain_ms": float(np.mean(plains)),
           "library_ms": float(np.mean(libs)), "ms_runs": times,
           "library_ms_runs": libs,
           "bound_ms": 3 * 4 * big_x.numel() / HBM_BYTES_PER_S * 1e3,
           "first_ms": ms, "first_plain_ms": plain_ms}
    print(f"K3 probe: (8, 128) sum {int(out_small.sum())}; 2^24 elements "
          f"equal to x + y; K3 {res['ms']} ms, plain {res['plain_ms']} ms,"
          f" torch.add {res['library_ms']} ms, bytes bound "
          f"{res['bound_ms']} ms; launches {launches}", flush=True)
    require(DEVICE != "cuda" or launches == 2, "K3 was not launched")
    return res


def soa_population(n_keys: int):
    """n_keys distinct key hashes of "smoke" / "k%08d" (their indices
    too), in index order."""
    idx = np.arange(n_keys, dtype=np.int64)
    keys = smoke_hashes(idx)
    _, first = np.unique(keys, return_index=True)
    keep = np.sort(first)
    return idx[keep], keys[keep]


def sweep_table(torch, args):
    """Phase 6's table: a 2^soa_log2_cap-row SoA table holding
    ``args.keys`` keys (about 30% expired at the sweep's now, 1000 at
    exactly now, every 97th removed).  Returns (table state, now, keys,
    placed, removed)."""
    from gubernator_tpu_torch.sharded import ShardedEngine

    cap = 1 << args.soa_log2_cap
    # wide row-op waves: the fill is 153 waves, not 9,766
    eng = ShardedEngine(device=DEVICE, capacity=cap, batch_rows=1 << 16)
    rng = np.random.default_rng(args.seed + 2)
    _, keys = soa_population(args.keys)
    n = len(keys)
    now = NOW0 + 100_000
    cols = token_rows(keys, 100, 60_000, now - 30_000)
    dead = rng.random(n) < 0.3
    cols["expire_at"] = np.where(dead, now - rng.integers(0, 50_000, n),
                                 now + rng.integers(1, 3_600_000, n))
    cols["expire_at"][:1000] = now  # the boundary: dead
    t0 = time.perf_counter()
    placed = eng.upsert_rows(keys, cols)
    removed = eng.remove_rows(keys[::97])
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    print(f"SoA fill: {placed} of {n} keys placed, {removed} removed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    require(placed > 0.99 * n and removed > 0, "SoA fill")
    return eng.state, now, n, placed, removed


def reclaimable(st, now) -> int:
    """Rows of ``st`` a sweep at ``now`` reclaims: dead and not empty."""
    return int(((st.expire_at <= now)
                & ((st.key != 0) | (st.expire_at != 0))).sum())


def sweep_bound_ms(rows: int, reclaim: int) -> float:
    """K2's bytes bound: 16 B read per row (key, expire_at) and 16 B
    written per row it reclaims, at the card's memory rate."""
    return 16 * (rows + reclaim) / HBM_BYTES_PER_S * 1e3


def check_sweeps(torch, now, a, b, what: str) -> float:
    """Require two swept copies ``a`` and ``b`` of a table (state, live
    count) equal in key, expire_at and live count, with no expired row
    left; returns the largest difference (0)."""
    (sa, la), (sb, lb) = a, b
    la, lb = int(la), int(lb)
    # in float64: a difference of two 64-bit keys must not wrap
    err = max(abs(la - lb), *(
        float((getattr(sa, f).double() - getattr(sb, f).double())
              .abs().max()) for f in ("key", "expire_at")))
    require(torch.equal(sa.key, sb.key)
            and torch.equal(sa.expire_at, sb.expire_at),
            f"{what} differ in key / expire_at")
    require(la == lb == int((sa.key != 0).sum()),
            f"{what}: live counts {la} and {lb}")
    require(not bool(((sa.expire_at <= now) & (sa.key != 0)).any()),
            f"{what}: an expired row survived")
    return err


class SweepCopies:
    """A scratch copy of a SoA table's key / expire_at columns for timed
    sweeps.  ``reset()`` copies the table's columns in, then writes
    L2_FLUSH_BYTES of scratch and reads it back, so that the next sweep
    finds none of its rows in the L2 cache, as in service (a sweep a
    second), and no dirty line either: the write alone would leave ~50
    MB of them, whose write-back the sweep would pay.  ``state`` is the
    table with the copies in place of its two columns."""

    def __init__(self, torch, st):
        self.src = st
        self.state = st._replace(key=st.key.clone(),
                                 expire_at=st.expire_at.clone())
        self.flush = torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.int64,
                                 device=st.key.device)

    def reset(self) -> None:
        self.state.key.copy_(self.src.key)
        self.state.expire_at.copy_(self.src.expire_at)
        self.flush.fill_(1)
        self.flush.sum()


def time_sweep(torch, copies, sweep, now, spin: bool, prepare=None):
    """``time_launch`` of one ``sweep(copies.state, now)`` on a fresh,
    L2-flushed copy of the table (``prepare()`` after the copy, outside
    the span): (ms, host ms of the call)."""
    def setup():
        copies.reset()
        if prepare is not None:
            prepare()

    return time_launch(torch, lambda: sweep(copies.state, now), reps=1,
                       spin=spin, setup=setup)


def phase_sweep_vs_plain(torch, args):
    """Phase 6's table swept by K2 and by the plain version on two
    copies, then K2 timed on fresh, L2-flushed copies: device time (the
    stream spins while the host calls sweep_cuda) and one call on an
    idle stream (the wrapper's host work inside)."""
    from gubernator_tpu_torch.ops import sweep as swm

    st, now, n, placed, removed = sweep_table(torch, args)
    others = {f: getattr(st, f).clone() for f in st._fields
              if f not in ("key", "expire_at")}
    reclaim = reclaimable(st, now)

    def fresh():
        return st._replace(key=st.key.clone(), expire_at=st.expire_at.clone())

    sk, sp = fresh(), fresh()
    live_k = int(swm.sweep_cuda(sk, now))
    live_p = int(swm.sweep_plain(sp, now))
    err = check_sweeps(torch, now, (sk, live_k), (sp, live_p),
                       "K2 and plain")
    require(all(torch.equal(getattr(st, f), c) for f, c in others.items()),
            "a sweep touched a column other than key / expire_at")
    del sk, sp, others
    copies = SweepCopies(torch, st)
    dev, one, host = [], [], []
    for spin in (True, False):  # untimed: the first use of each measure
        time_sweep(torch, copies, swm.sweep_cuda, now, spin)
    for _ in range(args.sweep_reps):
        dev.append(time_sweep(torch, copies, swm.sweep_cuda, now, True)[0])
        ms, h = time_sweep(torch, copies, swm.sweep_cuda, now, False)
        one.append(ms)
        host.append(h)
    p_ms = []
    for _ in range(args.sweep_reps):
        copies.reset()
        p_ms.append(elapsed_ms(torch, swm.sweep_plain, copies.state, now)[1])
    res = {"rows": st.key.numel(), "keys": n, "placed": placed,
           "removed": removed, "live": live_k, "reclaimed": reclaim,
           "max_abs_err": err, "ms": float(np.mean(dev)), "ms_runs": dev,
           "one_call_ms": float(np.mean(one)), "one_call_ms_runs": one,
           "host_ms": float(np.mean(host)),
           "plain_ms": float(np.mean(p_ms)),
           "bound_ms": sweep_bound_ms(st.key.numel(), reclaim)}
    print(f"K2 sweep of 2^{args.soa_log2_cap} rows: equal (live {live_k}, "
          f"reclaimed {reclaim}); K2 device time {res['ms']} ms (runs "
          f"{dev}), one call {res['one_call_ms']} ms (runs {one}; host "
          f"{res['host_ms']} ms), plain {res['plain_ms']} ms, bytes bound "
          f"{res['bound_ms']} ms", flush=True)
    del copies, st
    return res


def phase_classic_main_path(torch, args):
    """The HTTP daemon on the classic SoA engine: verify flow, a 2^40
    limit, a 10M-key table (a share expired), then rounds of Zipf(1.1)
    traffic over the live keys the table holds, with 3% of each batch on
    brand-new keys (inserts, the table-full retry and the auto-grow) and
    a grow to twice the rows before the second round; checked per key
    and per grow; the last, shorter round runs under torch.profiler."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.ops import sweep as swm
    from gubernator_tpu_torch.sharded import ShardedEngine
    from gubernator_tpu_torch.types import RateLimitRequest

    limit, duration = 100, 3_600_000
    cap = 1 << args.soa_log2_cap
    pop_idx, pop_keys = soa_population(args.keys)
    rng = np.random.default_rng(args.seed + 4)
    expired = rng.random(len(pop_keys)) < 0.2
    pauses: list = []
    on_gc = time_gc(pauses)
    gc.callbacks.append(on_gc)
    swm.sweep_cuda.launches = 0
    d = spawn_daemon(DaemonConfig(
        http_listen_address="127.0.0.1:0", grpc_listen_address="",
        engine="xla", cache_size=cap,
        cache_autogrow_max=2 * cap, batch_rows=1024,
        sweep_interval_ms=args.classic_sweep_ms, device=DEVICE))
    try:
        eng = d.instance.engine
        require(isinstance(eng, ShardedEngine)
                and eng.cap_local == cap, "GUBER_ENGINE=xla engine")
        http_verify_flow(d.http_port)
        big = post_one(d.http_port, {"name": "big", "uniqueKey": "b1",
                                     "hits": 1, "limit": 2 ** 40,
                                     "duration": 60_000})
        require(not big["error"] and big["status"] == 0
                and big["remaining"] == 2 ** 40 - 1, f"2^40 limit: {big}")
        print(f"2^40 limit: status {big['status']} remaining "
              f"{big['remaining']}", flush=True)

        t0 = time.perf_counter()
        fill_t = int(time.time() * 1000) - 1_000
        rows = token_rows(pop_keys, limit, duration, fill_t)
        rows["expire_at"] = np.where(expired, fill_t - 1_000,
                                     rows["expire_at"])
        with d.instance._engine_mu:
            placed = eng.restore(rows)
            # the live keys the table holds, taken once: a key the fill
            # could not place (its probe window was full) would need an
            # insert that the same window can refuse again; the fresh
            # keys below are what tests inserts
            held = torch.isin(torch.from_numpy(pop_keys.view(np.int64))
                              .to(eng.device), eng.state.key).cpu().numpy()
        held &= ~expired
        print(f"fill: {placed} of {len(pop_keys)} keys restored "
              f"({int(expired.sum())} expired, {int(held.sum())} live held)"
              f" in {time.perf_counter() - t0:.2f} s", flush=True)
        require(placed > 0.99 * len(pop_keys), f"fill placed {placed}")
        cap_before, sweeps_before = eng.cap_local, eng.sweep_count
        dropped_before = eng.dropped_rows

        timer = WaveTimer(d.instance)
        steps = time_steps(torch, eng)
        lost: list = []
        record_grows(torch, eng, lost)
        tally = Tally(limit)
        rounds = []
        grow_ms = None
        n_fresh = 0
        # the last round runs under torch.profiler and counts apart
        for rnd in range(args.classic_rounds + 1):
            profiled = rnd == args.classic_rounds
            if rnd == 1:
                # an on-device grow at full size, between the rounds:
                # the counters must come through it exactly
                t0 = time.perf_counter()
                with d.instance._engine_mu:
                    eng.grow(2 * eng.cap_local)
                    if DEVICE == "cuda":
                        torch.cuda.synchronize()
                grow_ms = (time.perf_counter() - t0) * 1e3
            # the held keys no grow has dropped so far
            gone = lost_ids(pop_idx, pop_keys, lost)
            live_idx = pop_idx[held & ~np.isin(pop_idx, gone)]
            n_b = args.profile_batches if profiled else args.batches
            per, n_fresh = classic_batches(rng, live_idx, args.threads, n_b,
                                           n_fresh)
            jobs = [[[RateLimitRequest(
                name="smoke", unique_key=classic_key(i), hits=1,
                limit=limit, duration=duration) for i in ids]
                for ids in thread] for thread in per]
            device = None
            if profiled:
                out, device = profile_device(
                    torch, lambda: drive(d.instance.get_rate_limits, jobs))
            else:
                out = drive(d.instance.get_rate_limits, jobs)
            t0, wall, lat, results = out
            tally.add(per, results, frozenset(
                lost_ids(pop_idx, pop_keys, lost).tolist()))
            rounds.append((t0, wall, lat, sum(
                len(b) for resps in results.values() for b in resps),
                device))
        # K2's launches over the object rounds (the wire round's count
        # stands apart, as phase 5 keeps K1's)
        launches = swm.sweep_cuda.launches
        def classic_wire_round():
            """One shorter round of the same traffic as wire bytes,
            checked per key; returns its record."""
            nonlocal n_fresh
            gone = lost_ids(pop_idx, pop_keys, lost)
            per, n_fresh = classic_batches(
                rng, pop_idx[held & ~np.isin(pop_idx, gone)], args.threads,
                args.profile_batches, n_fresh)
            rec = wire_rounds(torch, d.instance, [per], classic_key, limit,
                              duration, profile_last=False)
            tally.add(per, rec[0]["results"], frozenset(
                lost_ids(pop_idx, pop_keys, lost).tolist()))
            return rec

        with phase("classic wire path"):
            inline = time_inline(d.instance.dispatcher)
            wire = classic_wire_round()
            wire_k2 = swm.sweep_cuda.launches - launches
        with phase("classic wire path, pipeline off"):
            with pipeline_env("0"):
                rebuild_dispatcher(d.instance, timer)
            time_inline(d.instance.dispatcher, inline)
            k2_before = swm.sweep_cuda.launches
            off = classic_wire_round()
            off_k2 = swm.sweep_cuda.launches - k2_before
        # every held key is still held, but those a grow dropped
        with d.instance._engine_mu:
            still = torch.isin(torch.from_numpy(pop_keys.view(np.int64))
                               .to(eng.device), eng.state.key).cpu().numpy()
        gone = lost_ids(pop_idx, pop_keys, lost)
        missing = pop_idx[held & ~still]
        require(np.isin(missing, gone).all(),
                f"{int((~np.isin(missing, gone)).sum())} held keys left "
                f"the table without a grow dropping them")
        n_lost = int(sum(len(g) for g in lost))
        require(n_lost == eng.dropped_rows - dropped_before,
                f"grows dropped {eng.dropped_rows - dropped_before} rows, "
                f"{n_lost} keys lost")
        res = {"capacity_before": cap_before, "capacity_after": eng.cap_local,
               "grows": len(lost), "grow_ms": grow_ms,
               "dropped_rows": n_lost, "held_keys_dropped": len(gone),
               "held_keys_missing": len(missing),
               "fresh_requests": tally.fresh,
               "fresh_table_full": tally.fresh_full,
               "dropped_keys_table_full": tally.dropped_full,
               "sweeps": eng.sweep_count - sweeps_before,
               "live_rows_last_sweep": eng.live_rows}
    finally:
        d.close()
        gc.callbacks.remove(on_gc)

    tally.check(exclude=frozenset(gone.tolist()))
    stats = []
    for rnd, (t0, wall, lat, n_req, device) in enumerate(rounds):
        s = round_stats(wall, lat, [w for w in timer.rec
                                    if t0 <= w[0] <= t0 + wall], n_req,
                        [p for p in pauses if t0 <= p[0] <= t0 + wall])
        s.update(step_stats(torch, [x for x in steps
                                    if t0 <= x[0] <= t0 + wall]))
        if rnd == args.classic_rounds:
            s["device"] = device
        stats.append(s)
        print(f"classic main path round {rnd}"
              f"{' (profiled)' if rnd == args.classic_rounds else ''}: "
              f"{json.dumps(s)}", flush=True)
    timed = stats[:-1]
    lat_ms = np.concatenate([np.asarray(r[2]) for r in rounds[:-1]]) * 1e3
    rates = [r["decisions_per_s"] for r in timed]
    timed_steps = [x for t0, wall, *_ in rounds[:-1] for x in steps
                   if t0 <= x[0] <= t0 + wall]
    res.update({
        "decisions_per_s": float(np.mean(rates)),
        "decisions_per_s_min": min(rates),
        "decisions_per_s_max": max(rates),
        "requests": tally.n_req, "keys": len(tally.count),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "engine_ms_per_wave": float(np.mean(
            [r["engine_ms_mean"] for r in timed])),
        **step_stats(torch, timed_steps),
        "batches": len(lat_ms), "launches": launches, "rounds": stats})
    print(f"classic main path: {tally.n_req} decisions over "
          f"{len(tally.count)} keys ({tally.fresh} to fresh keys, "
          f"{tally.fresh_full} of them table full), every key exact but "
          f"the {len(gone)} held keys grows dropped ({tally.dropped_full} "
          f"table-full answers to them); {len(timed)} timed "
          f"rounds: {res['decisions_per_s']} decisions/s (min "
          f"{res['decisions_per_s_min']}, max {res['decisions_per_s_max']});"
          f" batch p50 {res['p50_ms']} ms p99 {res['p99_ms']} ms; SoA "
          f"engine call {res['engine_ms_per_wave']} ms per wave, the step "
          f"alone {res['step_device_ms_mean']} device-ms "
          f"({res['step_host_ms_mean']} host-ms) over {res['steps']} "
          f"steps; capacity {res['capacity_before']} -> "
          f"{res['capacity_after']} ({res['grows']} grows, the explicit one"
          f" in {res['grow_ms']} ms, {res['dropped_rows']} rows dropped); "
          f"{res['sweeps']} sweeps; K2 launches {launches}", flush=True)
    require(DEVICE != "cuda" or launches > 0,
            "the classic path never launched K2")
    res["wire"] = wire_summary(
        [wire_round_stats(wire[0], timer, inline, pauses)], wire, wire_k2,
        "classic wire path", profiled_last=False)
    res["wire_pipeline_off"] = wire_summary(
        [wire_round_stats(off[0], timer, inline, pauses)], off, off_k2,
        "classic wire path, pipeline off", profiled_last=False)
    res["pipeline"] = pipeline_compare("classic wire path", res["wire"],
                                       res["wire_pipeline_off"])
    require(res["wire"]["pipelined_waves"] > 0
            and res["wire_pipeline_off"]["pipelined_waves"] == 0,
            "the classic wire rounds did not run with the pipeline on, "
            "then off")
    return res


def classic_key(i: int) -> str:
    """A population key, or (negative ids) a brand-new one."""
    return f"k{i:08d}" if i >= 0 else f"fresh{-i:09d}"


def classic_batches(rng, live_idx, threads: int, n_b: int, n_fresh: int):
    """Each thread's n_b batches of 1000 ids: Zipf(1.1) over the live
    keys, FRESH_SHARE of them brand-new (negative ids, numbered on from
    ``n_fresh``).  Returns (batches per thread, the new n_fresh)."""
    per = []
    for _ in range(threads):
        thread = []
        for _ in range(n_b):
            ids = live_idx[zipf_ranks(rng, 1.1, len(live_idx), 1000)]
            fresh = np.nonzero(rng.random(1000) < FRESH_SHARE)[0]
            ids[fresh] = -1 - n_fresh - np.arange(len(fresh))
            n_fresh += len(fresh)
            thread.append(ids)
        per.append(thread)
    return per, n_fresh


def lost_ids(pop_idx, pop_keys, lost: list) -> np.ndarray:
    """The population ids of the keys the grows in ``lost`` dropped."""
    if not lost:
        return pop_idx[:0]
    return pop_idx[np.isin(pop_keys.view(np.int64), np.concatenate(lost))]


def post_one(port: int, req: dict) -> dict:
    """One request through the daemon's HTTP front door."""
    body = json.dumps({"requests": [req]}).encode()
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/GetRateLimits", body,
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=60) as resp:
        return json.loads(resp.read())["responses"][0]


def http_verify_flow(port: int) -> tuple:
    """limit=3 over 5 calls: statuses [0,0,0,1,1], remaining
    [2,1,0,0,0].  Returns (requests sent, OVER_LIMIT answers)."""
    got = [post_one(port, {"name": "api", "uniqueKey": "u1", "hits": 1,
                           "limit": 3, "duration": 5000})
           for _ in range(5)]
    statuses = [g["status"] for g in got]
    remaining = [g["remaining"] for g in got]
    require(statuses == [0, 0, 0, 1, 1] and remaining == [2, 1, 0, 0, 0],
            f"HTTP flow: {statuses} {remaining}")
    print(f"HTTP flow: statuses {statuses} remaining {remaining}",
          flush=True)
    return len(got), statuses.count(1)


def grpc_version():
    """grpcio's version, or None (printed as "grpc: not installed"): the
    daemons then serve no gRPC and the gRPC flow is not run."""
    try:
        import grpc
    except ImportError:
        print("grpc: not installed", flush=True)
        return None
    print(f"grpc: {grpc.__version__}", flush=True)
    return grpc.__version__


class WireResp(NamedTuple):
    """One RateLimitResp as this script decodes it; ``degraded`` is its
    metadata's ``degraded_peer`` ("" when the row was not served
    degraded)."""

    status: int
    limit: int
    remaining: int
    reset_time: int
    error: str
    degraded: str = ""


def _metadata_entry(data: bytes) -> tuple:
    """One map<string, string> entry (key field 1, value field 2)."""
    out, i = ["", ""], 0
    while i < len(data):
        tag = data[i]
        ln = data[i + 1]
        require(tag in (0x0A, 0x12) and ln < 0x80, "metadata entry")
        out[(tag >> 3) - 1] = data[i + 2:i + 2 + ln].decode()
        i += 2 + ln
    return tuple(out)


def decode_responses(data: bytes) -> list:
    """GetRateLimitsResp bytes → [WireResp], with this script's own
    decoder (no protobuf): field 1 of the message repeats RateLimitResp,
    whose varint fields 1-4, string field 5 and metadata entries (field
    6; the ``degraded_peer`` value is kept) are read."""

    def varint(i):
        v = shift = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v, i
            shift += 7

    out, i, n = [], 0, len(data)
    while i < n:
        require(data[i] == 0x0A, f"response tag {data[i]:#x}")
        ln, i = varint(i + 1)
        end = i + ln
        f = [0, 0, 0, 0, 0]
        err = deg = ""
        while i < end:
            tag, i = varint(i)
            if tag & 7 == 0:
                require(1 <= tag >> 3 <= 4, f"varint field {tag >> 3}")
                v, i = varint(i)
                f[tag >> 3] = v - (1 << 64) if v >= 1 << 63 else v
            else:
                require(tag & 7 == 2, f"wire type {tag & 7}")
                sl, i = varint(i)
                if tag >> 3 == 5:
                    err = data[i:i + sl].decode()
                elif tag >> 3 == 6:
                    k, v = _metadata_entry(data[i:i + sl])
                    if k == "degraded_peer":
                        deg = v
                i += sl
        require(i == end, "a response overran its length")
        out.append(WireResp(f[1], f[2], f[3], f[4], err, deg))
    return out


def grpc_verify_flow(port: int) -> tuple:
    """The HTTP verify flow over gRPC: request bytes from the port's
    encoder, answers read with decode_responses.  Returns (requests
    sent, OVER_LIMIT answers)."""
    import grpc

    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    data = encode_get_rate_limits([RateLimitRequest(
        name="api", unique_key="g1", hits=1, limit=3, duration=5000)])
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        call = ch.unary_unary("/pb.gubernator.V1/GetRateLimits")
        got = [decode_responses(call(data, timeout=60))[0]
               for _ in range(5)]
    finally:
        ch.close()
    statuses = [g.status for g in got]
    remaining = [g.remaining for g in got]
    require(statuses == [0, 0, 0, 1, 1] and remaining == [2, 1, 0, 0, 0],
            f"gRPC flow: {statuses} {remaining}")
    print(f"gRPC flow: statuses {statuses} remaining {remaining}",
          flush=True)
    return len(got), statuses.count(1)


def wire_jobs(per, key_of, limit: int, duration: int,
              behavior_of=lambda i: 0, limit_of=None):
    """Each thread's batches of ids as GetRateLimitsReq bytes, built by
    the port's encoder before the clock starts (one request TLV per
    distinct key, reused; a batch is their concatenation); ``limit_of``
    gives a key its own limit in place of ``limit``."""
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import req_to_tlv

    tlv: dict = {}

    def enc(i):
        t = tlv.get(i)
        if t is None:
            t = tlv[i] = req_to_tlv(RateLimitRequest(
                name="smoke", unique_key=key_of(i), hits=1,
                limit=limit if limit_of is None else limit_of(i),
                duration=duration, behavior=behavior_of(i)))
        return t

    return [[b"".join(map(enc, np.asarray(ids).tolist())) for ids in thread]
            for thread in per]


def time_inline(disp, rec=None) -> list:
    """Time every wave a caller runs inline on ``disp``
    (run_inline_wave); appends (start s, end s) per wave to ``rec`` (a
    new list when None), which it returns."""
    run = disp.run_inline_wave
    rec = [] if rec is None else rec

    def timed(fn, *a, **k):
        t = time.perf_counter()

        def inner():
            out = fn()
            rec.append((t, time.perf_counter()))
            return out

        return run(inner, *a, **k)

    disp.run_inline_wave = timed
    return rec


def wire_rounds(torch, inst, per_rounds, key_of, limit, duration,
                profile_last: bool) -> list:
    """Drive ``per_rounds`` (per round, each thread's id batches) through
    get_rate_limits_wire; the last round runs under torch.profiler when
    ``profile_last``.  Returns one record per round: its clock window,
    latencies, decoded answers, inline-wave count, pool counters and
    device share."""
    disp, pool = inst.dispatcher, inst.engine.wave_pool
    out = []
    for rnd, per in enumerate(per_rounds):
        jobs = wire_jobs(per, key_of, limit, duration)
        inline0, pool0 = disp.inline_waves, pool.stats()
        device = None
        if profile_last and rnd == len(per_rounds) - 1:
            res, device = profile_device(
                torch, lambda: drive(inst.get_rate_limits_wire, jobs))
        else:
            res = drive(inst.get_rate_limits_wire, jobs)
        t0, wall, lat, raw = res
        pool1 = pool.stats()
        results = {t: [decode_responses(b) for b in batches]
                   for t, batches in raw.items()}
        out.append({"t0": t0, "wall": wall, "lat": lat, "per": per,
                    "results": results, "device": device,
                    "n_req": sum(len(b) for r in results.values()
                                 for b in r),
                    "inline_waves": disp.inline_waves - inline0,
                    "pool": {k: pool1[k] - pool0[k]
                             for k in ("hits", "misses", "leaks")}})
        require(pool1["leaks"] == pool0["leaks"],
                f"wave pool leaked {pool1['leaks'] - pool0['leaks']} "
                "leases")
    return out


def wire_round_stats(rec, timer, inline, pauses) -> dict:
    """round_stats of a wire round, with its inline waves beside the
    worker's (coalesced or pipelined) ones, the pipelined launches and
    their largest ring slot, and the pool's counters."""
    t0, wall = rec["t0"], rec["wall"]
    s = round_stats(wall, rec["lat"],
                    [w for w in timer.rec if t0 <= w[0] <= t0 + wall],
                    rec["n_req"],
                    [p for p in pauses if t0 <= p[0] <= t0 + wall])
    s.update(timer.pipelined(t0, wall))
    fused = [e - b for b, e in inline if t0 <= b <= t0 + wall]
    s.update({"inline_waves": rec["inline_waves"],
              "inline_share": rec["inline_waves"] / max(
                  rec["inline_waves"] + s["waves"], 1),
              "inline_fused_wave_ms_mean": float(np.mean(fused) * 1e3)
              if fused else None,
              "pool_hits": rec["pool"]["hits"],
              "pool_misses": rec["pool"]["misses"],
              "pool_leaks": rec["pool"]["leaks"]})
    s["device"] = rec["device"]
    return s


def drive(call, jobs, stop=None, starts=None):
    """Each thread calls ``call`` (get_rate_limits or
    get_rate_limits_wire, or a list of one callable per thread) on its
    batches in turn, until ``stop()`` (checked before each batch) is
    true; returns (start on the perf_counter clock, wall s, batch
    latencies s, {thread: [answer per batch sent]}).  ``starts``
    collects (batch start on the monotonic clock, latency s)."""
    lat: list = []
    results: dict = {}
    failures: list = []

    def caller(t):
        fn = call[t] if isinstance(call, list) else call
        try:
            out = []
            for batch in jobs[t]:
                if stop is not None and stop():
                    break
                m0 = time.monotonic()
                s = time.perf_counter()
                out.append(fn(batch))
                lat.append(time.perf_counter() - s)
                if starts is not None:
                    starts.append((m0, lat[-1]))
            results[t] = out
        except Exception as e:  # re-raised below, after join
            failures.append(e)

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(len(jobs))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if failures:
        raise failures[0]
    return t0, wall, lat, results


class Tally:
    """Per key: UNDER count = min(requests, limit), and the UNDER rows'
    remaining values are exactly limit-1 .. limit-count.  Keys with a
    negative id are fresh (never in the table before): a `rate limit
    table full` answer to one of them, or to a key a grow dropped (its
    probe window was full), is counted apart, not failed."""

    def __init__(self, limit: int):
        self.limit = limit
        self.n_req = 0
        self.fresh = 0
        self.fresh_full = 0
        self.dropped_full = 0
        self.under: dict = {}
        self.count: dict = {}
        #: OVER_LIMIT answers, for the /metrics check
        self.over = 0

    def add(self, per, results, dropped=frozenset()) -> None:
        from gubernator_tpu_torch.types import Status

        for t, thread in enumerate(per):
            for ranks, resps in zip(thread, results[t]):
                for r, resp in zip(np.asarray(ranks).tolist(), resps):
                    self.n_req += 1
                    self.fresh += r < 0
                    if resp.error == TABLE_FULL and r < 0:
                        self.fresh_full += 1
                        continue
                    if resp.error == TABLE_FULL and r in dropped:
                        self.dropped_full += 1
                        continue
                    require(not resp.error, resp.error)
                    self.count[r] = self.count.get(r, 0) + 1
                    if resp.status == Status.UNDER_LIMIT:
                        self.under.setdefault(r, []).append(resp.remaining)
                    else:
                        self.over += 1
                        require(resp.remaining == 0,
                                "an OVER row with remaining > 0")

    def check(self, exclude=frozenset()) -> None:
        """Every key exact, but those in ``exclude`` (keys a grow
        dropped: their counter restarts, as the table's eviction
        contract allows)."""
        for r, c in self.count.items():
            if r in exclude:
                continue
            got = sorted(self.under.get(r, []))
            m = min(c, self.limit)
            require(got == list(range(self.limit - m, self.limit)),
                    f"key {r}: {c} requests, UNDER remaining "
                    f"{got[:5]}...")


class WaitTimedLock:
    """The dispatcher's engine lock, recording how long the worker
    thread waits to take it (an inline wave in a caller's thread may
    hold it)."""

    def __init__(self, lock, worker, waits: list):
        self.lock, self.worker, self.waits = lock, worker, waits

    def __enter__(self):
        t = time.perf_counter()
        self.lock.acquire()
        if threading.current_thread() is self.worker:
            self.waits.append(time.perf_counter() - t)
        return self

    def __exit__(self, *exc):
        self.lock.release()


class WaveTimer:
    """Times every dispatcher wave on the worker thread's host clock: a
    coalesced one (``_run_wave``), and a pipelined one from its launch
    (``_launch_packed_jobs``) to its sync (``_sync_and_resolve``),
    counting only the worker's time in those two calls; the engine calls
    inside them (device work and the result download included; engine
    calls in callers' threads, and the check_packed retry inside a sync,
    are not counted apart) and the worker's wait for the engine lock.
    ``rec`` gets (start s, start + worker s, jobs, rows, engine s, lock
    wait s) per wave, ``slots`` (launch s, ring slot) per pipelined
    launch.  ``attach`` times a rebuilt dispatcher of the instance."""

    def __init__(self, inst):
        self.inst = inst
        self.rec: list = []
        self.slots: list = []
        self._engine_s: list = []
        self._wait_s: list = []
        #: wave id → the launch's part of a pipelined wave's record
        self._open: dict = {}
        self._in_engine = False
        eng = inst.engine
        for name in ("check_packed", "launch_packed", "sync_packed"):
            setattr(eng, name, self._timed_engine(getattr(eng, name)))
        self.attach(inst.dispatcher)

    def _timed_engine(self, call):
        def run(*a, **k):
            if (threading.current_thread() is not self.inst.dispatcher._thread
                    or self._in_engine):
                return call(*a, **k)
            self._in_engine = True
            t = time.perf_counter()
            try:
                return call(*a, **k)
            finally:
                self._engine_s.append(time.perf_counter() - t)
                self._in_engine = False

        return run

    def _take(self) -> tuple:
        """(engine s, lock wait s) since the last take."""
        out = (sum(self._engine_s), sum(self._wait_s))
        self._engine_s.clear()
        self._wait_s.clear()
        return out

    def attach(self, disp) -> None:
        run_wave = disp._run_wave
        launch, sync = disp._launch_packed_jobs, disp._sync_and_resolve

        def timed_wave(wave):
            self._take()
            t = time.perf_counter()
            run_wave(wave)
            self.rec.append((t, time.perf_counter(), len(wave),
                             sum(len(j) for j in wave)) + self._take())

        def timed_launch(jobs, slot):
            self._take()
            t = time.perf_counter()
            out = launch(jobs, slot)
            self.slots.append((t, slot))
            if out is not None:
                self._open[out[2]] = (t, time.perf_counter() - t, len(jobs),
                                      sum(len(j) for j in jobs)) \
                    + self._take()
            return out

        def timed_sync(jobs, token, wid):
            self._take()
            t = time.perf_counter()
            sync(jobs, token, wid)
            dur = time.perf_counter() - t
            t0, launch_s, n_jobs, rows, eng_s, wait_s = self._open.pop(wid)
            more_eng, more_wait = self._take()
            self.rec.append((t0, t0 + launch_s + dur, n_jobs, rows,
                             eng_s + more_eng, wait_s + more_wait))

        disp._run_wave = timed_wave
        disp._launch_packed_jobs = timed_launch
        disp._sync_and_resolve = timed_sync
        disp._engine_lock = WaitTimedLock(disp._engine_lock, disp._thread,
                                          self._wait_s)

    def pipelined(self, t0: float, wall: float) -> dict:
        """The pipelined launches of a window and their largest slot."""
        slots = [s for t, s in self.slots if t0 <= t <= t0 + wall]
        return {"pipelined_waves": len(slots),
                "max_slot": max(slots) if slots else None}


def time_steps(torch, eng) -> list:
    """Time every decision step the engine runs (``eng._decide``, the
    SoA step alone: no packing, upload or download) on the host clock
    and, on the card, with CUDA events around it.  Appends (start s,
    host s, start event, end event) per step to the returned list; read
    the events' times after a synchronize."""
    decide = eng._decide
    rec: list = []

    def timed_decide(*a):
        ev = None
        if DEVICE == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t = time.perf_counter()
        out = decide(*a)
        host = time.perf_counter() - t
        if ev:
            ev[1].record()
        rec.append((t, host) + (tuple(ev) if ev else (None, None)))
        return out

    eng._decide = timed_decide
    return rec


def step_stats(torch, steps) -> dict:
    """Mean host and device ms of the steps in ``steps``."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    host = [s[1] * 1e3 for s in steps]
    dev = [s[2].elapsed_time(s[3]) for s in steps if s[2] is not None]
    return {"steps": len(steps),
            "step_host_ms_mean": float(np.mean(host)) if host else None,
            "step_device_ms_mean": float(np.mean(dev)) if dev else None}


def record_grows(torch, eng, lost: list) -> None:
    """Wrap ``eng.grow`` (the explicit grow, the table-full auto-grow
    and the sweep's proactive grow all call it): for each grow, append
    to ``lost`` the int64 keys it held before and not after, and require
    that they are the rows the grow reports dropped, and few."""
    grow = eng.grow

    def recorded_grow(new_capacity):
        before = eng.state.key[eng.state.key != 0]
        dropped = grow(new_capacity)
        gone = before[~torch.isin(before, eng.state.key)].cpu().numpy()
        require(len(gone) == dropped,
                f"grow reports {dropped} dropped rows, lost {len(gone)}")
        require(dropped <= GROW_DROP_MAX_SHARE * before.numel(),
                f"grow to {new_capacity} rows dropped {dropped} of "
                f"{before.numel()}")
        print(f"grow to {new_capacity} rows: {before.numel()} rows "
              f"re-placed, {dropped} dropped", flush=True)
        lost.append(gone)
        return dropped

    eng.grow = recorded_grow


def time_gc(pauses: list):
    """A gc callback appending (start s, end s, generation) of every
    garbage collection to ``pauses``."""
    start: list = []

    def on_gc(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append((start.pop(), time.perf_counter(),
                           info["generation"]))

    return on_gc


def round_stats(wall, lat, waves, n_req, pauses) -> dict:
    """One round's decisions/s and latencies, and what its waves show:
    the worker's busy share of the wall, the engine's share of a wave
    and the worker's wait for the engine lock, and the garbage
    collections (all threads stop for them), in all and inside the
    slowest wave."""
    lat_ms = np.asarray(lat) * 1e3
    w = np.asarray(waves, dtype=np.float64).reshape(-1, 6)
    wave_s = w[:, 1] - w[:, 0]
    g = np.asarray(pauses, dtype=np.float64).reshape(-1, 3)
    gc_s = g[:, 1] - g[:, 0]
    gen2_s = gc_s[g[:, 2] == 2]
    out = {"wall_s": wall, "decisions_per_s": n_req / wall,
           "batches": len(lat), "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "max_ms": float(lat_ms.max()), "waves": len(w),
           "worker_busy_share": float(wave_s.sum() / wall),
           "gc_collections": len(g),
           "gc_gen2_collections": len(gen2_s),
           "gc_ms_total": float(gc_s.sum() * 1e3),
           "gc_ms_max": float(gc_s.max() * 1e3) if len(g) else 0.0,
           "gc_gen2_ms_max": float(gen2_s.max() * 1e3) if len(gen2_s)
           else 0.0}
    if not len(w):  # every wave of the round ran inline
        return out
    slow = int(wave_s.argmax())
    in_slow = np.clip(np.minimum(g[:, 1], w[slow, 1])
                      - np.maximum(g[:, 0], w[slow, 0]), 0, None)
    out.update({
        "jobs_per_wave": float(w[:, 2].mean()),
        "rows_per_wave": float(w[:, 3].mean()),
        "wave_ms_mean": float(wave_s.mean() * 1e3),
        "wave_ms_max": float(wave_s.max() * 1e3),
        "engine_ms_mean": float(w[:, 4].mean() * 1e3),
        "engine_share_of_wave": float(w[:, 4].sum() / wave_s.sum()),
        "lock_wait_ms_mean": float(w[:, 5].mean() * 1e3),
        "lock_wait_share_of_wave": float(w[:, 5].sum() / wave_s.sum()),
        "slowest_wave_engine_ms": float(w[slow, 4] * 1e3),
        "slowest_wave_gc_ms": float(in_slow.sum() * 1e3)})
    return out


def profile_device(torch, run):
    """Run ``run()`` under torch.profiler; returns (its result, the
    device's busy share of the profiled wall and the device time by
    kind).  The busy time is the union of the recorded device intervals
    (kernels and copies); a profiler that records no device event gives
    None, not a guess."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return out, None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_kind: dict = {}
    for s, e, name in spans:
        kind = ("K1" if "decide_kernel" in name
                else "K2" if "sweep_kernel" in name
                else "memcpy" if "Memcpy" in name
                else "memset" if "Memset" in name
                else "sort" if "sort" in name.lower() or "radix" in name.lower()
                else "other kernels")
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s) / 1e3
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return out, {"events": len(spans), "busy_ms": busy / 1e3,
                 "wall_ms": wall_us / 1e3, "busy_share": busy / wall_us,
                 "ms_by_kind": by_kind}


def check_topkeys(d, tally, key_hashes) -> dict:
    """/debug/topkeys after phase 5's rounds (all taps folded first): the
    16 hottest ranks are present, each count at most the hits sent plus
    its ``err``, and, where no tap was dropped, at least the hits sent
    (Space-Saving's bounds).  ``key_hashes[r]`` is rank r's key hash."""
    ana = d.instance.analytics
    require(ana.flush(timeout=120.0), "analytics flush timed out")
    code, doc = get_json(d.http_port, f"/debug/topkeys?limit={TOPKEYS_LIMIT}")
    require(code == 200, f"/debug/topkeys {code}")
    by_hash = {int(e["khash"], 16): e for e in doc["keys"]}
    dropped = metric_total(d.instance,
                           "gubernator_analytics_tap_dropped_total")
    rows = []
    for r in range(TOPKEYS_CHECKED):
        e = by_hash.get(int(key_hashes[r]))
        require(e is not None, f"rank {r} missing from /debug/topkeys")
        sent = tally.count.get(r, 0)
        require(e["hits"] <= sent + e["err"],
                f"rank {r}: count {e['hits']} > sent {sent} + err {e['err']}")
        if dropped == 0:
            require(e["hits"] >= sent,
                    f"rank {r}: count {e['hits']} < sent {sent}")
        rows.append({"rank": r, "sent": sent, "count": e["hits"],
                     "err": e["err"], "over_limit": e["over_limit"]})
    out = {"taps_dropped": dropped, "waves_tapped": doc["waves_tapped"],
           "tracked_keys": doc["tracked_keys"], "width": doc["width"],
           "total_hits_observed": doc["total_hits_observed"],
           "admission_error_bound": doc["admission_error_bound"],
           "hottest": rows}
    print(f"topkeys: {json.dumps(out)}", flush=True)
    return out


class HostProfile:
    """A host profile of a window: the CPU seconds of the daemon's
    long-lived threads (the dispatcher's worker, the analytics worker)
    from each thread's CPU clock and the process's, and a stack sample
    of every thread each ``period_s``, tallied per thread by the
    innermost frame of this repo's code (``waiting:`` when the leaf is
    a lock or queue wait).  The sampler takes the GIL too, so compare
    only windows that ran it."""

    THREADS = ("device-dispatcher", "key-analytics")

    def __init__(self, period_s: float = 0.005):
        self.period_s = period_s
        self.result: dict = {}

    @staticmethod
    def _cpu(t) -> float:
        return time.clock_gettime(time.pthread_getcpuclockid(t.ident))

    @staticmethod
    def _label(frame) -> str:
        import os

        leaf = os.path.basename(frame.f_code.co_filename)
        f = frame
        while f is not None:
            fn = f.f_code.co_filename
            if "gubernator_tpu_torch" in fn or fn.endswith("chip_smoke.py"):
                at = f"{os.path.basename(fn)}:{f.f_code.co_name}"
                break
            f = f.f_back
        else:
            at = f"{leaf}:{frame.f_code.co_name}"
        return f"waiting: {at}" if leaf in ("threading.py", "queue.py") \
            else at

    def _run(self) -> None:
        from collections import Counter

        while not self._stop.wait(self.period_s):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                name = names.get(ident, "")
                if name == "host-profile":
                    continue
                group = name if name in self.THREADS else "others"
                self._samples.setdefault(group, Counter())[
                    self._label(frame)] += 1
            self._n += 1

    def __enter__(self):
        self._stop = threading.Event()
        self._samples: dict = {}
        self._n = 0
        self._clock0 = {t.name: (t, self._cpu(t))
                        for t in threading.enumerate()
                        if t.name in self.THREADS}
        self._t0, self._p0 = time.perf_counter(), time.process_time()
        self._th = threading.Thread(target=self._run, name="host-profile",
                                    daemon=True)
        self._th.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._th.join()
        wall = time.perf_counter() - self._t0
        threads = {}
        for name, (t, c0) in self._clock0.items():
            if t.is_alive():
                cpu = self._cpu(t) - c0
                threads[name] = {"cpu_s": cpu, "cpu_share_of_wall": cpu / wall}
        self.result = {
            "wall_s": wall, "process_cpu_s": time.process_time() - self._p0,
            "samples": self._n, "threads": threads,
            "top": {g: [[k, v] for k, v in c.most_common(8)]
                    for g, c in sorted(self._samples.items())}}


def profiled_object_rounds(inst, rng, n_keys, key_of, limit, duration,
                           args, timer, pauses, tally) -> dict:
    """One object-lane round of 8 x ``profile_batches`` with the
    analytics on, then one detached, each under a HostProfile: where the
    host's time goes with and without the default analytics."""
    from gubernator_tpu_torch.types import RateLimitRequest

    out = {"order": ["on", "off"]}
    for state in out["order"]:
        per = [[zipf_ranks(rng, 1.1, n_keys, 1000)
                for _ in range(args.profile_batches)]
               for _ in range(args.threads)]
        jobs = [[[RateLimitRequest(name="smoke", unique_key=key_of(r),
                                   hits=1, limit=limit, duration=duration)
                  for r in ranks] for ranks in thread] for thread in per]
        with (analytics_detached(inst) if state == "off"
              else nullcontext()), HostProfile() as prof:
            t0, wall, lat, results = drive(inst.get_rate_limits, jobs)
        tally.add(per, results)
        st = round_stats(wall, lat, [w for w in timer.rec
                                     if t0 <= w[0] <= t0 + wall],
                         sum(len(b) for r in results.values() for b in r),
                         [p for p in pauses if t0 <= p[0] <= t0 + wall])
        out[state] = {"round": st, "profile": prof.result}
        print(f"object lane host profile, analytics {state}: "
              f"{json.dumps(out[state])}", flush=True)
    return out


class ABArms:
    """One arm of an interleaved A/B: 8 callers x AB_BATCHES batches of
    phase 5's traffic through one lane of the instance, every answer
    added to the tally; returns the arm's decisions/s and counts the K1
    launches of each lane and state."""

    def __init__(self, inst, rng, n_keys, key_of, limit, duration, args,
                 tally):
        self.inst, self.rng, self.n_keys = inst, rng, n_keys
        self.key_of, self.limit, self.duration = key_of, limit, duration
        self.threads, self.tally = args.threads, tally
        self.launches = {"wire": {}, "object": {}}

    def runner(self, lane: str):
        def run(state: str) -> float:
            from gubernator_tpu_torch.ops.decide import decide_cuda
            from gubernator_tpu_torch.types import RateLimitRequest

            per = [[zipf_ranks(self.rng, 1.1, self.n_keys, 1000)
                    for _ in range(AB_BATCHES)]
                   for _ in range(self.threads)]
            l0 = decide_cuda.launches
            if lane == "wire":
                jobs = wire_jobs(per, self.key_of, self.limit, self.duration)
                _, wall, _, raw = drive(self.inst.get_rate_limits_wire, jobs)
                results = {t: [decode_responses(b) for b in batches]
                           for t, batches in raw.items()}
            else:
                jobs = [[[RateLimitRequest(
                    name="smoke", unique_key=self.key_of(r), hits=1,
                    limit=self.limit, duration=self.duration)
                    for r in ranks] for ranks in thread] for thread in per]
                _, wall, _, results = drive(self.inst.get_rate_limits, jobs)
            got = self.launches[lane]
            got[state] = got.get(state, 0) + decide_cuda.launches - l0
            self.tally.add(per, results)
            return self.threads * AB_BATCHES * 1000 / wall

        return run


def interleaved_pairs(label: str, run_arm, arms, before_second=None,
                      pairs: int = None) -> dict:
    """The reference's A/B discipline (bench.py › _analytics_ab): one
    untimed warm-up pair, then ``pairs`` pairs of the same call in the
    two states of ``arms`` ((name, context factory) twice), in turn;
    ``before_second()`` runs before each second arm (the analytics
    flush, so deferred folds do not leak into the baseline).  Returns
    each state's rates and median and the median of the per-pair ratios
    second / first, which cancels the host's drift."""
    pairs = AB_PAIRS if pairs is None else pairs
    (a, ctx_a), (b, ctx_b) = arms
    rates = {a: [], b: []}
    ratios = []
    for p in range(pairs + 1):
        with ctx_a():
            ra = run_arm(a)
        if before_second is not None:
            before_second()
        with ctx_b():
            rb = run_arm(b)
        if p == 0:
            continue  # the warm-up pair is not timed
        rates[a].append(ra)
        rates[b].append(rb)
        ratios.append(rb / ra)
    out = {"pairs": pairs, "order": [a, b], "median_ratio": float(
        np.median(ratios)), "ratios": ratios,
           f"{a}_median": float(np.median(rates[a])),
           f"{b}_median": float(np.median(rates[b])),
           f"{a}_decisions_per_s": rates[a],
           f"{b}_decisions_per_s": rates[b]}
    print(f"{label} pairs ({a}, {b}): {json.dumps(out)}", flush=True)
    return out


@contextmanager
def python_fold(inst):
    """The analytics sketch's fold in Python inside (the plain version,
    byte-equal to the native fold): the before arm of the fold's move
    to C++."""
    from gubernator_tpu_torch.analytics import HeavyHitterSketch

    sketch = inst.analytics.sketch
    sketch.update = HeavyHitterSketch.update.__get__(sketch)
    try:
        yield
    finally:
        del sketch.update


@contextmanager
def flushed(inst, ctx):
    """``ctx`` entered after the analytics worker folded every tap it
    holds, so that an arm does not pay for the folds of the one
    before."""
    inst.analytics.flush(timeout=30.0)
    with ctx:
        yield


@contextmanager
def plain_hashing():
    """The object lane's key hashing swapped for its plain version (a
    Python FNV loop and numpy's finalizer) inside: the dispatcher is the
    object lane's one hashing site."""
    from gubernator_tpu_torch import dispatcher, hashing

    native = dispatcher.hash_request_keys
    dispatcher.hash_request_keys = hashing.hash_request_keys_plain
    try:
        yield
    finally:
        dispatcher.hash_request_keys = native


@contextmanager
def tenants_detached(inst):
    """The analytics on, its tenant ledger detached inside (the learn
    and flag taps and the worker's tenant folds skip)."""
    ana = inst.analytics
    tl, ana._tenants = ana._tenants, None
    try:
        yield
    finally:
        ana._tenants = tl


@contextmanager
def analytics_detached(inst):
    """The instance's analytics detached from the serving path (the
    dispatcher's taps and the engine's device tap): what an instance
    built under GUBER_ANALYTICS=0 serves with, on the same table."""
    ana, sink = inst.dispatcher.analytics, inst.engine.tap_sink
    inst.dispatcher.analytics = None
    inst.engine.tap_sink = None
    try:
        yield
    finally:
        inst.dispatcher.analytics = ana
        inst.engine.tap_sink = sink


def tier_population(n_keys: int, limit: int, duration: int, t0: int):
    """The snapshot the tiers phase restores: phase 5's key names
    (smoke_k%08d, rank r = index r), TOKEN rows at ``limit`` and full,
    every TIER_LEAKY_EVERY-th row LEAKY (full), every TIER_OOD_EVERY-th
    at a limit of 2^40 (outside K1's domain).  Returns (row columns,
    the 2^40 rows' mask)."""
    idx = np.arange(n_keys, dtype=np.int64)
    rows = token_rows(smoke_hashes(idx), limit, duration, t0)
    leaky = idx % TIER_LEAKY_EVERY == TIER_LEAKY_EVERY // 2
    ood = idx % TIER_OOD_EVERY == 0
    rows["meta"][leaky] = 1
    rows["remaining"][leaky] = limit * duration  # td units: full
    rows["limit"][ood] = OOD_LIMIT
    rows["burst"][ood] = OOD_LIMIT
    rows["remaining"][ood] = OOD_LIMIT
    return rows, ood


def predicted_cold(keys: np.ndarray, ood: np.ndarray, log2_cap: int):
    """The rows a restore into an empty 2^log2_cap-row bucket table puts
    in the cold tier: every 2^40 row, and each in-domain row that finds
    its 8-slot bucket full when the rows are placed in order."""
    nb = 1 << (log2_cap - 3)
    cold = ood.copy()
    ind = np.nonzero(~ood)[0]
    bucket = (keys[ind] & np.uint64(nb - 1)).astype(np.int64)
    cold[ind[~bucket_fit(bucket)]] = True
    return cold


def tier_union(inst) -> dict:
    """Both tiers' rows as store.py columns sorted by key."""
    parts = [inst.engine.snapshot()]
    cold = inst._tier.snapshot_arrays()
    if cold is not None:
        parts.append(cold)
    cols = {f: np.concatenate([np.asarray(p[f]) for p in parts])
            for f in parts[0]}
    order = np.argsort(cols["key"], kind="stable")
    return {f: c[order] for f, c in cols.items()}


class AdmissionLog:
    """Why each cold key that a resolve offered for admission was, or
    was not, promoted.  It wraps one TierController's rank feed,
    ``_admit``, ``promote`` and ``_pick_victim`` on the instance (the
    smoke's instrumentation, not the port's): the rank logged is the one
    ``_admit`` read.  The flight recorder's ring is overrun by wave
    events within a round, so the log is kept here."""

    BANDS = (100, 1_000, 10_000)

    def __init__(self, tier):
        from collections import Counter

        self.tier = tier
        self.offers: Counter = Counter()
        self.final: dict = {}  # khash -> (reason, rank read)
        self.promoted: list = []  # (khash, rank read)
        self._admitting, self._why = False, None
        self._saved = {f: getattr(tier, f) for f in
                       ("rank_fn", "_admit", "promote", "_pick_victim")}
        rank_fn, admit, promote, pick = self._saved.values()
        thr = tier.promote_threshold

        def logged_rank(kh):
            r = rank_fn(kh)
            if self._admitting and r < thr:
                self._note(kh, r, "untracked" if r == 0
                           else "under_threshold")
            return r

        def logged_admit(engine, khs):
            self._admitting = True
            try:
                admit(engine, khs)
            finally:
                self._admitting = False

        def logged_promote(engine, kh, rank):
            self._admitting, self._why = False, None
            row = tier.peek_row(kh)
            gate = getattr(engine, "tier_row_admissible", None)
            outside = (row is not None and gate is not None and not gate(
                tuple(row.values())))
            d0 = tier.demotions
            try:
                ok = promote(engine, kh, rank)
            finally:
                self._admitting = True
            if ok:
                why = ("promoted_evicting" if tier.demotions > d0
                       else "promoted_free_slot")
                self.promoted.append((int(kh), int(rank)))
            else:
                why = ("outside_domain" if outside
                       else self._why or "aborted")
            self._note(kh, rank, why)
            return ok

        def logged_pick(engine, kh, rank):
            v = pick(engine, kh, rank)
            if v is None:
                self._why = "no_colder_victim"
            return v

        tier.rank_fn, tier._admit = logged_rank, logged_admit
        tier.promote, tier._pick_victim = logged_promote, logged_pick

    def _note(self, kh, rank, why):
        self.offers[why] += 1
        self.final[int(kh)] = (why, int(rank))

    def close(self) -> None:
        for f, v in self._saved.items():
            setattr(self.tier, f, v)

    def summary(self, pop_keys: np.ndarray, analytics) -> dict:
        """Offers and distinct keys by reason, the distinct keys by their
        population rank's band, and each promotion's population rank
        (``pop_keys[r]`` is rank r's key hash)."""
        pop_keys = np.asarray(pop_keys).astype(np.uint64)
        order = np.argsort(pop_keys)

        def pop_rank(khs):
            khs = np.asarray(khs, np.uint64)
            at = np.clip(np.searchsorted(pop_keys[order], khs), 0,
                         len(order) - 1)
            return np.where(pop_keys[order][at] == khs, order[at], -1)

        keys = list(self.final)
        ranks = pop_rank(keys)
        edges = (0,) + self.BANDS + (len(pop_keys),)
        bands = {}
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = [self.final[k][0] for k, r in zip(keys, ranks)
                   if lo <= r < hi]
            bands[f"{lo}-{hi}"] = {w: sel.count(w) for w in sorted(set(sel))}
        reasons = [v[0] for v in self.final.values()]
        tracked = analytics.rank_distribution(limit=analytics.sketch.width)
        return {
            "threshold": self.tier.promote_threshold,
            "sketch_width": analytics.sketch.width,
            "sketch_floor": min(tracked) if tracked else 0,
            "offers": dict(self.offers),
            "keys": {w: reasons.count(w) for w in sorted(set(reasons))},
            "keys_by_population_rank": bands,
            "promoted": [{"population_rank": int(r), "sketch_rank": k}
                         for (_, k), r in zip(
                             self.promoted,
                             pop_rank([kh for kh, _ in self.promoted]))]}


def tier_stats_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in ("cold_served", "promotions",
                                     "demotions", "migrations_aborted")}


def item_path_ms(torch, rows: dict, n: int, log2_cap: int) -> dict:
    """A Loader's item path against the FileLoader's column path on the
    first ``n`` rows: items_from_arrays, arrays_from_items and a restore
    into a fresh table, against normalized_arrays and the same restore
    (each into its own table on the card)."""
    from gubernator_tpu_torch.engine import BucketEngine
    from gubernator_tpu_torch.store import (arrays_from_items,
                                            items_from_arrays,
                                            normalized_arrays)

    sub = {f: c[:n] for f, c in rows.items()}
    out = {"rows": n}
    for path in ("item", "column"):
        eng = BucketEngine(device=DEVICE, capacity=1 << log2_cap)
        t = time.perf_counter()
        arrays = (arrays_from_items(items_from_arrays(sub))
                  if path == "item" else normalized_arrays(sub))
        eng.restore(arrays)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        out[f"{path}_ms"] = (time.perf_counter() - t) * 1e3
        del eng, arrays
    return out


def tier_ood_round(inst, lane: str, n_keys: int, rounds: int = 3) -> int:
    """Requests at a limit of 2^40 on new keys (no device row) through
    one lane: every answer exact from the cold tier, none table_full.
    Returns the requests sent."""
    from gubernator_tpu_torch.hashing import hash_request_keys
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    names = [f"{lane}{i}" for i in range(n_keys)]
    used = np.zeros(n_keys, np.int64)
    sent = 0
    for rnd in range(rounds):
        hits = [(i * 7 + rnd * 13) % 1000 + 1 for i in range(n_keys)]
        reqs = [RateLimitRequest(name="big", unique_key=k, hits=h,
                                 limit=OOD_LIMIT, duration=3_600_000)
                for k, h in zip(names, hits)]
        if lane == "wire":
            out = decode_responses(inst.get_rate_limits_wire(
                encode_get_rate_limits(reqs)))
        else:
            out = inst.get_rate_limits(reqs)
        used += hits
        for i, r in enumerate(out):
            require(not r.error, f"2^40 row answered {r.error!r}")
            require((r.status, r.limit, r.remaining) ==
                    (0, OOD_LIMIT, OOD_LIMIT - int(used[i])),
                    f"2^40 row {names[i]}: {r}")
        sent += len(reqs)
    kh = hash_request_keys(["big"] * n_keys, names)
    found, _ = inst.engine.gather_rows(kh)
    require(not found.any() and inst._tier.resident_mask(kh).all(),
            "a 2^40 row left the cold tier")
    return sent


def tier_remove_check(inst, rows: dict, tally, limit: int,
                      duration: int) -> dict:
    """remove() of one device-resident and one cold TOKEN key that the
    rounds never sent to: 5 hits each first, then the remove; both gone
    from both tiers, and the next request starts a fresh bucket."""
    from gubernator_tpu_torch.types import RateLimitRequest

    keys = rows["key"]
    token = np.asarray(rows["meta"]) == 0
    token &= np.asarray(rows["limit"]) == limit
    cold = inst._tier.resident_mask(keys)
    picked = {}
    for where, mask in (("device", ~cold), ("cold", cold)):
        cand = np.nonzero(mask & token)[0]
        r = next(int(i) for i in cand[::-1] if int(i) not in tally.count)
        picked[where] = r
    out = {}
    for where, r in picked.items():
        name = f"k{r:08d}"
        req = RateLimitRequest(name="smoke", unique_key=name, hits=5,
                               limit=limit, duration=duration)
        first = inst.get_rate_limits([req])[0]
        require(first.remaining == limit - 5 and not first.error,
                f"remove {where}: {first}")
        require(inst.remove("smoke", name), f"remove {where}: no row")
        kh = keys[r:r + 1]
        found, _ = inst.engine.gather_rows(kh)
        require(not found[0] and inst._tier.peek_row(int(kh[0])) is None,
                f"remove {where}: the row is still held")
        nxt = inst.get_rate_limits([RateLimitRequest(
            name="smoke", unique_key=name, hits=1, limit=limit,
            duration=duration)])[0]
        require(nxt.remaining == limit - 1 and not nxt.error,
                f"remove {where}: next request {nxt}")
        out[where] = {"rank": r, "after_remove": nxt.remaining}
    return out


def tier_store_round(torch, threads: int, batches: int, n_keys: int,
                     seed: int) -> dict:
    """A short object-lane round with a counting Store (MockStore) on a
    small instance on the card with the cold tier, its 1024-row table
    outgrown by the keys: ``on_change`` counts the answers without an
    error and ``get`` the requests whose key neither tier held (every
    first sight of a key; a cold key is no miss), and every key seen
    ends in exactly one tier.  The same traffic as wire bytes through a
    second such instance takes the object path (a Store is set) and
    answers the same."""
    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.store import MockStore
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    rng = np.random.default_rng(seed)
    traffic = [[zipf_ranks(rng, 1.1, n_keys, 1000) for _ in range(batches)]
               for _ in range(threads)]
    stores = [MockStore(), MockStore()]
    insts = [V1Instance(Config(cache_size=1 << 10, device=DEVICE,
                               store=s, tier_cold=True)) for s in stores]
    try:
        answers, seen, misses, ok = [], set(), 0, 0
        for thread in traffic:
            for ranks in thread:
                reqs = [RateLimitRequest(name="store", unique_key=f"s{r}",
                                         hits=1, limit=50,
                                         duration=3_600_000)
                        for r in ranks.tolist()]
                misses += sum(r not in seen for r in ranks.tolist())
                seen.update(ranks.tolist())
                a = [(int(x.status), x.limit, x.remaining, x.error)
                     for x in insts[0].get_rate_limits(reqs)]
                b = [(x.status, x.limit, x.remaining, x.error)
                     for x in decode_responses(insts[1].get_rate_limits_wire(
                         encode_get_rate_limits(reqs)))]
                require(a == b, "the Store's wire lane answered otherwise")
                ok += sum(not x[3] for x in a)
                answers.append(len(a))
        calls = [dict(s.called) for s in stores]
        wire_pb2 = insts[1].metrics.registry.get_sample_value(
            "gubernator_wire_lane_requests_total", {"lane": "pb2_fallback"})
        tiers = []
        for inst in insts:
            dev = set(np.asarray(inst.engine.snapshot()["key"]).tolist())
            cold = inst._tier.snapshot_arrays()
            cold = set() if cold is None else set(
                np.asarray(cold["key"]).tolist())
            require(not dev & cold, f"{len(dev & cold)} keys in both tiers")
            require(len(dev) + len(cold) == len(seen),
                    f"{len(dev)} + {len(cold)} rows for {len(seen)} keys")
            tiers.append({"device_rows": len(dev), "cold_rows": len(cold)})
    finally:
        for inst in insts:
            inst.close()
    res = {"requests": sum(answers), "store_calls": calls[0],
           "wire_store_calls": calls[1], "misses": misses, "answered": ok,
           "wire_pb2_rows": wire_pb2, "tiers": tiers}
    print(f"tiers store: {json.dumps(res)}", flush=True)
    require(calls[0]["on_change"] == ok == sum(answers),
            f"on_change {calls[0]['on_change']} != answers {ok}")
    require(calls[0]["get"] == misses, f"get {calls[0]['get']} != misses "
            f"{misses}")
    require(calls[1] == calls[0], "the wire lane's Store calls differ")
    require(wire_pb2 == sum(answers), f"wire rows on the object path "
            f"{wire_pb2}")
    return res


def phase_tiers(torch, args) -> dict:
    """The tiers phase: a 2^tier_log2_cap-row bucket table behind which
    the cold tier holds what the 10M keys overflow; see the docstring."""
    import os
    import shutil
    import tempfile

    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.hashing import hash_request_keys
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.store import FileLoader

    limit, duration = 100, 3_600_000
    cap = args.tier_log2_cap
    n = args.keys
    res: dict = {"table_rows": 1 << cap,
                 "table_gib": (1 << cap) * 128 / 2 ** 30, "keys": n}
    print(f"tiers: a 2^{cap}-row bucket table ({res['table_gib']} GiB, a "
          f"quarter of phase 5's rows) for {n} keys: the one cut; the "
          f"cold tier holds what it cannot", flush=True)
    tmp = tempfile.mkdtemp(prefix="guber-tiers-")
    path = os.path.join(tmp, "snapshot.npz")
    pauses: list = []
    on_gc = time_gc(pauses)
    gc.callbacks.append(on_gc)
    d = d2 = None
    try:
        fill_t = int(time.time() * 1000) - 1_000
        rows, ood = tier_population(n, limit, duration, fill_t)
        t = time.perf_counter()
        FileLoader(path).save_arrays(rows)
        res["snapshot_in"] = {"write_ms": (time.perf_counter() - t) * 1e3,
                              "file_bytes": os.path.getsize(path),
                              "rows": n, "leaky_rows": int(
                                  (rows["meta"] == 1).sum()),
                              "ood_rows": int(ood.sum())}
        t = time.perf_counter()
        FileLoader(path).load_arrays()  # the file alone: decompress
        res["snapshot_in"]["load_ms"] = (time.perf_counter() - t) * 1e3
        res["item_vs_column"] = item_path_ms(
            torch, rows, min(n, ITEM_PATH_ROWS), cap)
        cfg = DaemonConfig(http_listen_address="127.0.0.1:0",
                           grpc_listen_address="", cache_size=1 << cap,
                           batch_rows=1024, device=DEVICE,
                           snapshot_path=path)
        with scoped_env("GUBER_TIER_COLD", "1"):
            t = time.perf_counter()
            d = spawn_daemon(cfg)
            spawn_ms = (time.perf_counter() - t) * 1e3
        inst = d.instance
        tier = inst._tier
        want_cold = predicted_cold(
            rows["key"], ood, inst.engine.cap_local.bit_length() - 1)
        res["snapshot_in"]["predicted_cold"] = int(want_cold.sum())
        warm = hash_request_keys(["_warmup"], ["w"])
        warm_cold = bool(tier.resident_mask(warm)[0])
        cold_mask = tier.resident_mask(rows["key"])
        dev_rows = inst.engine.occupancy() - (not warm_cold)
        cold_rows = tier.cold_keys() - warm_cold
        res["restore"] = {
            "column_path_ms": inst.analytics.phases.snapshot()["restore"][
                "total_ms"],
            "spawn_ms": spawn_ms, "device_rows": dev_rows,
            "cold_rows": cold_rows, "dropped_rows": inst.engine.dropped_rows,
            "cold_share": cold_rows / n,
            "native_store": tier.stats()["native"]}
        print(f"tiers restore: {json.dumps(res['restore'])}; item path vs "
              f"column path: {json.dumps(res['item_vs_column'])}",
              flush=True)
        require(dev_rows + cold_rows == n and inst.engine.dropped_rows == 0,
                f"restore kept {dev_rows} + {cold_rows} of {n} rows")
        require((cold_mask == want_cold).all(),
                f"{int((cold_mask != want_cold).sum())} rows in another tier "
                "than their buckets predict")
        require(cold_mask[ood].all(), "a 2^40 row on the device")

        # served: phase 5's wire traffic over the 10M keys
        key_of = lambda r: f"k{r:08d}"  # noqa: E731
        timer = WaveTimer(inst)
        tally = Tally(limit)
        rng = np.random.default_rng(args.seed + 10)
        decide_cuda.launches = 0
        rounds = []
        admission = AdmissionLog(tier)
        for rnd in range(args.rounds + 1):
            profiled = rnd == args.rounds
            per = [[zipf_ranks(rng, 1.1, n, 1000) for _ in range(
                args.profile_batches if profiled else args.batches)]
                for _ in range(args.threads)]
            s0, r0 = tier.stats(), tier.resolve_s
            rec = wire_rounds(torch, inst, [per], key_of, limit, duration,
                              profile_last=profiled)[0]
            s1 = tier.stats()
            tally.add(rec["per"], rec["results"])
            st = wire_round_stats(rec, timer, [], pauses)
            st.update(tier_stats_delta(s0, s1))
            st["cold_share"] = st["cold_served"] / rec["n_req"]
            st["resolve_ms"] = (tier.resolve_s - r0) * 1e3
            st["cold_keys"] = s1["cold_keys"]
            rounds.append((rec, st))
            print(f"tiers round {rnd}{' (profiled)' if profiled else ''}: "
                  f"{json.dumps(st)}", flush=True)
        launches = decide_cuda.launches
        admission.close()
        tally.check()
        timed = [st for _, st in rounds[:-1]]
        lat_ms = np.concatenate([np.asarray(rec["lat"])
                                 for rec, _ in rounds[:-1]]) * 1e3
        res["served"] = {
            "decisions_per_s": float(np.mean([s["decisions_per_s"]
                                              for s in timed])),
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "cold_share": float(np.mean([s["cold_share"] for s in timed])),
            "promotions": sum(s["promotions"] for _, s in rounds),
            "demotions": sum(s["demotions"] for _, s in rounds),
            "migrations_aborted": sum(s["migrations_aborted"]
                                      for _, s in rounds),
            "resolve_ms": sum(s["resolve_ms"] for _, s in rounds),
            "requests": tally.n_req, "keys": len(tally.count),
            "launches": launches,
            "device": rounds[-1][1]["device"], "rounds": [s for _, s in rounds]}
        print(f"tiers served: {tally.n_req} decisions over "
              f"{len(tally.count)} keys, each key exact; "
              f"{res['served']['decisions_per_s']} decisions/s; p50 "
              f"{res['served']['p50_ms']} ms p99 {res['served']['p99_ms']} ms; "
              f"cold share {res['served']['cold_share']}; promotions "
              f"{res['served']['promotions']}, demotions "
              f"{res['served']['demotions']}; K1 launches {launches}",
              flush=True)
        require(launches > 0, "the tiers phase never launched K1")
        res["served"]["admission"] = adm = admission.summary(
            rows["key"], inst.analytics)
        print(f"tiers admission: {json.dumps(adm)}", flush=True)
        require(adm["offers"].get("promoted_free_slot", 0)
                + adm["offers"].get("promoted_evicting", 0)
                == res["served"]["promotions"],
                "the admission log disagrees with the tier's promotions")
        require(res["served"]["promotions"] > 0, "no cold row was promoted")

        # out of domain, on both lanes
        res["ood"] = {lane: tier_ood_round(inst, lane, 64)
                      for lane in ("object", "wire")}
        res["remove"] = tier_remove_check(inst, rows, tally, limit, duration)
        print(f"tiers ood and remove: {json.dumps([res['ood'], res['remove']])}",
              flush=True)
        del rows, ood, want_cold, cold_mask

        # snapshot out and back
        before = tier_union(inst)
        stats = tier.stats()
        d.close()
        d_inst, d = inst, None
        res["snapshot_out"] = {
            "ms": d_inst.analytics.phases.snapshot()["snapshot"]["total_ms"],
            "file_bytes": os.path.getsize(path),
            "rows": len(before["key"]), "cold_rows": stats["cold_keys"]}
        del d_inst, inst, tier
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        with scoped_env("GUBER_TIER_COLD", "1"):
            d2 = spawn_daemon(cfg)
        d2.instance.loader = None  # its close saves nothing
        after = tier_union(d2.instance)
        d2.close()
        d2 = None
        keep_b = before["key"] != warm[0]
        keep_a = after["key"] != warm[0]
        for f in before:
            require(np.array_equal(before[f][keep_b], after[f][keep_a]),
                    f"snapshot round trip: column {f} differs")
        res["snapshot_out"]["restored_rows"] = int(keep_a.sum())
        print(f"tiers snapshot out and back: {json.dumps(res['snapshot_out'])}",
              flush=True)
        del before, after
        res["store"] = tier_store_round(torch, args.threads, 2, 5_000,
                                        args.seed + 11)
    finally:
        for dd in (d, d2):
            if dd is not None:
                dd.close()
        gc.callbacks.remove(on_gc)
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---- the hot set, membership and TLS, gossip ------------------------------

def key_hashes_of(ranks, key_of) -> np.ndarray:
    from gubernator_tpu_torch.hashing import hash_request_keys

    ranks = list(ranks)
    return hash_request_keys(["smoke"] * len(ranks),
                             [key_of(r) for r in ranks])


def demotions_of(inst) -> dict:
    """gubernator_hotset_demotions by reason (0 where never counted)."""
    reg = inst.metrics.registry
    return {r: int(reg.get_sample_value(
        "gubernator_hotset_demotions_total", {"reason": r}) or 0)
        for r in HOT_REASONS}


class HotTraffic:
    """The cluster phase's traffic (Zipf(1.1) over the keys, the
    GLOBAL_RANKS hottest ranks GLOBAL at limit 100, the next
    EXACT_GLOBAL_RANKS GLOBAL at 10^9) into one daemon per state, over
    gRPC (the wire lane) or in-process (the object lane); every answer
    accounted: non-GLOBAL keys in the state's tally, the limit-100 keys'
    admissions and the 10^9 keys' hits sent."""

    def __init__(self, args, daemons: dict, chans: dict, rng, n_keys,
                 batches: int):
        self.args, self.daemons, self.chans = args, daemons, chans
        self.rng, self.n_keys, self.batches = rng, n_keys, batches
        self.limit, self.duration = 100, 3_600_000
        self.n_glob = GLOBAL_RANKS
        self.n_all = GLOBAL_RANKS + EXACT_GLOBAL_RANKS
        self.tally = {s: Tally(self.limit) for s in daemons}
        self.admitted = {s: np.zeros(self.n_glob, np.int64) for s in daemons}
        self.sent = {s: np.zeros(self.n_all, np.int64) for s in daemons}
        self.lat = {}  # (lane, state) → batch latencies s
        self.on_wall = {}  # state → wall seconds of its arms

    def key_of(self, r):
        return f"k{r:08d}"

    def limit_of(self, r):
        return (EXACT_GLOBAL_LIMIT if self.n_glob <= r < self.n_all
                else self.limit)

    def behavior_of(self, r):
        return 2 if r < self.n_all else 0

    def runner(self, lane: str, ranks_of=None):
        """run(state) → decisions/s of one arm of 8 x batches."""
        def run(state: str) -> float:
            from gubernator_tpu_torch.grpc_api import raw_unary
            from gubernator_tpu_torch.types import RateLimitRequest

            draw = ranks_of or (lambda: zipf_ranks(
                self.rng, 1.1, self.n_keys, 1000))
            per = [[draw() for _ in range(self.batches)]
                   for _ in range(self.args.threads)]
            if lane == "wire":
                jobs = wire_jobs(per, self.key_of, self.limit,
                                 self.duration, self.behavior_of,
                                 self.limit_of)
                calls = [lambda b, c=raw_unary(ch, "GetRateLimits"):
                         c(b, timeout=120) for ch in self.chans[state]]
                _, wall, lat, raw = drive(calls, jobs)
                results = {t: [decode_responses(b) for b in batches]
                           for t, batches in raw.items()}
            else:
                jobs = [[[RateLimitRequest(
                    name="smoke", unique_key=self.key_of(r), hits=1,
                    limit=self.limit_of(r), duration=self.duration,
                    behavior=self.behavior_of(r)) for r in ranks.tolist()]
                    for ranks in thread] for thread in per]
                _, wall, lat, results = drive(
                    self.daemons[state].instance.get_rate_limits, jobs)
            self.account(state, per, results)
            self.lat.setdefault((lane, state), []).extend(lat)
            self.on_wall[state] = self.on_wall.get(state, 0.0) + wall
            return sum(len(r) for t in per for r in t) / wall

        return run

    def account(self, state, per, results) -> None:
        plain_per, plain_res = [], {}
        for t, thread in enumerate(per):
            plain_per.append([])
            plain_res[t] = []
            for ranks, resps in zip(thread, results[t]):
                require(len(resps) == len(ranks), "short response")
                g = ranks < self.n_all
                for r, resp in zip(ranks[g].tolist(),
                                   [resps[j] for j in np.nonzero(g)[0]]):
                    require(not resp.error, f"GLOBAL rank {r}: {resp.error}")
                    if r < self.n_glob:
                        self.admitted[state][r] += int(resp.status) == 0
                    else:
                        require(int(resp.status) == 0, "a GLOBAL key "
                                "under a limit of 10^9 went OVER")
                self.sent[state] += np.bincount(ranks[g],
                                                minlength=self.n_all)
                plain_per[t].append(ranks[~g])
                plain_res[t].append([resps[j] for j in np.nonzero(~g)[0]])
        self.tally[state].add(plain_per, plain_res)

    def latency(self, lane: str, state: str) -> dict:
        ms = np.asarray(self.lat.get((lane, state), [0.0])) * 1e3
        return {"p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99))}

    def check_global(self, state: str, inst) -> dict:
        """The limit-100 keys admitted exactly min(sent, 100) (one
        replica: no over-admission), the 10^9 keys at exactly the limit
        less the hits sent; read with hits=0 probes."""
        from gubernator_tpu_torch.types import RateLimitRequest

        sent, adm = self.sent[state], self.admitted[state]
        want_adm = np.minimum(sent[:self.n_glob], self.limit)
        require((adm == want_adm).all(), f"{state}: limit-100 keys "
                f"admitted {adm.tolist()}, want {want_adm.tolist()}")
        probe = [RateLimitRequest(
            name="smoke", unique_key=self.key_of(r), hits=0,
            limit=self.limit_of(r), duration=self.duration, behavior=2)
            for r in range(self.n_glob, self.n_all)]
        rem = [x.remaining for x in inst.get_rate_limits(probe)]
        want = (EXACT_GLOBAL_LIMIT - sent[self.n_glob:]).tolist()
        require(rem == want, f"{state}: 10^9 keys read {rem}, want {want}")
        return {"admitted_limit_100": adm.tolist(),
                "exact_hits_sent": int(sent[self.n_glob:].sum())}


def time_hot_waves(torch, hs, waves: list, steps: list) -> None:
    """Record each hot wave's host ms (its call, the wait for the hot
    set's lock included) in ``waves``, and each replica step's (host ms,
    device ms) inside the lock in ``steps``: the host's clock around the
    step, CUDA events on the stream around it (they bracket the host's
    launches and syncs too)."""
    from gubernator_tpu_torch import hotset

    run, step = hs._run_hot_wave, hotset.decide_batch

    def timed_wave(glob, now_ms):
        t = time.perf_counter()
        out = run(glob, now_ms)
        waves.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_step(state, batch, now):
        ev = None
        if DEVICE == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t = time.perf_counter()
        out = step(state, batch, now)
        host = (time.perf_counter() - t) * 1e3
        dev = None
        if ev is not None:
            ev[1].record()
            ev[1].synchronize()
            dev = ev[0].elapsed_time(ev[1])
        steps.append((host, dev))
        return out

    hs._run_hot_wave = timed_wave
    hotset.decide_batch = timed_step


def restore_hot_step() -> None:
    """Undo time_hot_waves' module-level wrap of the step."""
    from gubernator_tpu_torch import hotset
    from gubernator_tpu_torch.core.step import decide_batch

    hotset.decide_batch = decide_batch


def phase_hot(torch, args) -> dict:
    """One daemon alone on the bucket engine (the cluster phase's
    2^cluster-log2-cap rows), the JAX defaults of the hot set (capacity
    1024, threshold 64), and an identical daemon with hot_set_capacity 0
    (JAX's off): the cluster phase's traffic on the object lane and over
    gRPC on the wire lane, HOT_AB_PAIRS interleaved pairs a lane (after
    a warm-up pair).  Checks: every GLOBAL rank hit 64 times pinned, the
    limit-100 keys admitted exactly 100, the 10^9 keys at exactly the
    limit less the hits sent after a sync, every other key exact; then
    the demotions, each counted under its reason (a RESET_REMAINING
    request, a new limit whose consumed hits carry over, remove() (JAX
    counts none), a snapshot holding every pinned row and restoring
    them equal)."""
    import os
    import tempfile

    import grpc

    from gubernator_tpu_torch.config import Config, DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.ops.decide import decide_cuda
    from gubernator_tpu_torch.store import FileLoader
    from gubernator_tpu_torch.types import Behavior, RateLimitRequest

    tmp = tempfile.mkdtemp(prefix="smoke-hot-")
    snap = os.path.join(tmp, "hot.npz")

    def cfg(**kw):
        return DaemonConfig(grpc_listen_address="127.0.0.1:0",
                            http_listen_address="127.0.0.1:0",
                            cache_size=1 << args.cluster_log2_cap,
                            batch_rows=1024, device=DEVICE, **kw)

    on = spawn_daemon(cfg(snapshot_path=snap))
    off = spawn_daemon(cfg())
    chans = {}
    try:
        off.instance.config.hot_set_capacity = 0  # JAX's documented off
        inst = on.instance
        require((inst.config.hot_set_capacity,
                 inst.config.hot_promote_threshold) == (1024, 64),
                "the hot set's defaults differ from JAX's")
        hs = inst._ensure_hotset()  # what the first promotion builds
        require(hs.device.type == DEVICE and hs.n == 1,
                f"the hot set is on {hs.device}, {hs.n} replicas")
        pins, waves, steps = [], [], []
        pin = hs.pin

        def counted_pin(req, kh, now_ms, seed=None):
            ok = pin(req, kh, now_ms, seed=seed)
            pins.append((kh, ok, seed is not None))
            return ok

        hs.pin = counted_pin
        time_hot_waves(torch, hs, waves, steps)
        opts = [("grpc.use_local_subchannel_pool", 1)]
        chans = {s: [grpc.insecure_channel(f"127.0.0.1:{d.grpc_port}",
                                           options=opts)
                     for _ in range(args.threads)]
                 for s, d in (("on", on), ("off", off))}
        traffic = HotTraffic(args, {"on": on, "off": off}, chans,
                             np.random.default_rng(args.seed + 12),
                             args.keys, HOT_BATCHES)
        decide_cuda.launches = 0
        ab = {}
        for lane in ("object", "wire"):
            w0 = len(waves)
            ab[lane] = interleaved_pairs(
                f"hot set {lane} lane", traffic.runner(lane),
                (("off", nullcontext), ("on", nullcontext)),
                pairs=HOT_AB_PAIRS)
            ab[lane]["hot_waves"] = len(waves) - w0
            for s in ("on", "off"):
                ab[lane][f"{s}_latency"] = traffic.latency(lane, s)
        launches = decide_cuda.launches
        hs.sync()
        kh_all = key_hashes_of(range(traffic.n_all), traffic.key_of)
        sent = traffic.sent["on"]
        unpinned = [r for r in range(traffic.n_all)
                    if sent[r] >= 64 and not hs.is_pinned(int(kh_all[r]))]
        require(not unpinned, f"GLOBAL ranks hit 64 times, not pinned: "
                f"{unpinned}")
        glob = {s: traffic.check_global(s, d.instance)
                for s, d in (("on", on), ("off", off))}
        for s in ("on", "off"):
            traffic.tally[s].check()
        wave = np.array(waves)
        host = np.array([h for h, _ in steps])
        dev = np.array([d for _, d in steps if d is not None])
        ratios = {lane: ab[lane]["ratios"] for lane in ab}
        promoted = {k for k, ok, _ in pins if ok}
        res = {"ab": ab, "launches": launches,
               "promotions": len(promoted), "pin_calls": len(pins),
               "seeded_promotions": len({k for k, ok, sd in pins
                                         if ok and sd}),
               "pinned": len(hs.slots), "syncs": hs.sync_count,
               "hot_waves": len(wave),
               "hot_wave_ms_with_lock_wait_mean": float(wave.mean()),
               "hot_wave_ms_with_lock_wait_p99": float(
                   np.percentile(wave, 99)),
               "hot_step_host_ms_mean": float(host.mean()),
               "hot_step_host_ms_p50": float(np.percentile(host, 50)),
               "hot_step_host_ms_p99": float(np.percentile(host, 99)),
               "hot_step_device_ms_mean": (float(dev.mean()) if len(dev)
                                           else None),
               "hot_step_device_ms_p50": (float(np.percentile(dev, 50))
                                          if len(dev) else None),
               # the steps run one at a time under the hot set's lock:
               # their share of the "on" arms' wall
               "hot_step_share_of_on_wall": float(
                   host.sum() / 1e3 / traffic.on_wall["on"]),
               "global": glob,
               "checked_requests": {s: traffic.tally[s].n_req
                                    for s in traffic.tally}}
        for lane in ab:
            r = np.asarray(ratios[lane])
            res[f"{lane}_on_off_ratio_median"] = float(np.median(r))
            res[f"{lane}_on_off_ratio_spread"] = [float(r.min()),
                                                  float(r.max())]
            res[f"{lane}_decisions_per_s"] = {
                s: ab[lane][f"{s}_median"] for s in ("on", "off")}
            res[f"{lane}_latency"] = {s: ab[lane][f"{s}_latency"]
                                      for s in ("on", "off")}
        print(f"hot set: {json.dumps({k: v for k, v in res.items() if k != 'ab'})}",
              flush=True)

        # ---- the demotions, each under its reason ---------------------
        d0 = demotions_of(inst)
        kh = lambda r: int(kh_all[r])  # noqa: E731

        def one(r, **kw):
            q = dict(name="smoke", unique_key=traffic.key_of(r), hits=1,
                     limit=traffic.limit_of(r), duration=traffic.duration,
                     behavior=int(Behavior.GLOBAL))
            q.update(kw)
            return inst.get_rate_limits([RateLimitRequest(**q)])[0]

        r_flag, r_cfg, r_rm = 0, traffic.n_glob + 1, 1
        require(all(hs.is_pinned(kh(r)) for r in (r_flag, r_cfg, r_rm)),
                "a rank chosen for a demotion is not pinned")
        resp = one(r_flag, hits=0, behavior=int(
            Behavior.GLOBAL | Behavior.RESET_REMAINING))
        require(not resp.error and not hs.is_pinned(kh(r_flag)),
                "RESET_REMAINING did not demote")
        new_limit = EXACT_GLOBAL_LIMIT - 1000
        resp = one(r_cfg, limit=new_limit)
        want = EXACT_GLOBAL_LIMIT - int(sent[r_cfg]) - 1000 - 1
        require(not hs.is_pinned(kh(r_cfg)) and resp.remaining == want,
                f"a new limit: remaining {resp.remaining}, want {want} "
                "(the consumed hits carried into the table)")
        require(inst.remove("smoke", traffic.key_of(r_rm)),
                "remove() found no row")
        found, _ = inst.engine.gather_rows(np.array([kh(r_rm)], np.uint64))
        require(not hs.is_pinned(kh(r_rm)) and not found[0],
                "remove() left the key pinned or its row")
        d1 = demotions_of(inst)
        hs.sync()
        before = {k: hs.row_state(k) for k in list(hs.slots)}
        t = time.perf_counter()
        inst._save_to_loader()  # folds the pinned rows back first
        snap_ms = (time.perf_counter() - t) * 1e3
        d2 = demotions_of(inst)
        require(not hs.slots, "the snapshot left keys pinned")
        arrays = FileLoader(snap).load_arrays()
        at = {int(k): i for i, k in enumerate(arrays["key"].tolist())}
        fields = ("remaining", "t_ms", "expire_at", "limit", "meta")
        for k, row in before.items():
            require(k in at, "a pinned row is missing from the snapshot")
            require(all(int(arrays[f][at[k]]) == int(row[f])
                        for f in fields), "a pinned row differs in the "
                    "snapshot")
        back = V1Instance(Config(cache_size=1 << args.cluster_log2_cap,
                                 device=DEVICE,
                                 hot_set_capacity=0,
                                 loader=FileLoader(snap)))
        try:
            karr = np.array(sorted(before), np.uint64)
            found, cols = back.engine.gather_rows(karr)
            require(found.all() and all(
                int(cols[f][j]) == int(before[int(k)][f])
                for j, k in enumerate(karr.tolist()) for f in fields),
                "the restored pinned rows differ")
        finally:
            back.close()
        dem = {"flagged": d1["flagged"] - d0["flagged"],
               "config_change": d1["config_change"] - d0["config_change"],
               "remove_counted": sum(d1.values()) - sum(d0.values())
               - 2, "snapshot_membership_change":
               d2["membership_change"] - d1["membership_change"],
               "snapshot_rows": len(before), "snapshot_ms": snap_ms,
               "snapshot_file_rows": len(arrays["key"])}
        require(dem["flagged"] == 1 and dem["config_change"] == 1
                and dem["remove_counted"] == 0
                and dem["snapshot_membership_change"] == len(before),
                f"demotions miscounted: {dem}")
        res["demotions"] = dem
        print(f"hot set demotions: {json.dumps(dem)}", flush=True)
    finally:
        restore_hot_step()
        for cs in chans.values():
            for ch in cs:
                ch.close()
        on.close()
        off.close()
    return res


def write_certs(d: str) -> tuple:
    """One CA and a server certificate it signs for 127.0.0.1 / localhost
    as PEM files in ``d``, with ``cryptography`` where it imports, else
    with the openssl command: (ca, cert, key, how).  Neither: the run
    stops."""
    import os

    paths = tuple(os.path.join(d, n) for n in ("ca.pem", "cert.pem",
                                               "key.pem"))
    try:
        import datetime
        import ipaddress

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        x509 = None
    if x509 is not None:
        now = datetime.datetime.now(datetime.timezone.utc)

        def build(subject, issuer, pub, signer, ext):
            b = (x509.CertificateBuilder().subject_name(subject)
                 .issuer_name(issuer).public_key(pub)
                 .serial_number(x509.random_serial_number())
                 .not_valid_before(now - datetime.timedelta(minutes=5))
                 .not_valid_after(now + datetime.timedelta(days=1)))
            for e, crit in ext:
                b = b.add_extension(e, critical=crit)
            return b.sign(signer, hashes.SHA256())

        ca_key = ec.generate_private_key(ec.SECP256R1())
        ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                                "smoke-ca")])
        ca = build(ca_name, ca_name, ca_key.public_key(), ca_key,
                   [(x509.BasicConstraints(ca=True, path_length=0), True)])
        key = ec.generate_private_key(ec.SECP256R1())
        cert = build(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "smoke")]),
            ca_name, key.public_key(), ca_key,
            [(x509.SubjectAlternativeName([
                x509.DNSName("localhost"),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
              False)])
        pem = serialization.Encoding.PEM
        for p, data in zip(paths, (
                ca.public_bytes(pem), cert.public_bytes(pem),
                key.private_bytes(pem, serialization.PrivateFormat.PKCS8,
                                  serialization.NoEncryption()))):
            with open(p, "wb") as f:
                f.write(data)
        return paths + ("cryptography",)
    ext = os.path.join(d, "san.cnf")
    with open(ext, "w") as f:
        f.write("subjectAltName=IP:127.0.0.1,DNS:localhost\n")
    ca_key = os.path.join(d, "ca.key")
    csr = os.path.join(d, "req.csr")
    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
          "-nodes"]
    try:
        for cmd in (
                ["openssl", "req", "-x509", *ec, "-keyout", ca_key, "-out",
                 paths[0], "-days", "1", "-subj", "/CN=smoke-ca"],
                ["openssl", "req", *ec, "-keyout", paths[2], "-out", csr,
                 "-subj", "/CN=smoke"],
                ["openssl", "x509", "-req", "-in", csr, "-CA", paths[0],
                 "-CAkey", ca_key, "-CAcreateserial", "-out", paths[1],
                 "-days", "1", "-extfile", ext]):
            subprocess.run(cmd, check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.CalledProcessError) as e:
        require(False, "no cryptography and no working openssl: the TLS "
                f"round cannot run ({e})")
    return paths + ("openssl",)


def wait_for(pred, bound_s: float, step_s: float = 0.001) -> float:
    """Seconds until ``pred()`` held, polled every ``step_s``; the run
    stops past ``bound_s``."""
    t0 = time.monotonic()
    while not pred():
        require(time.monotonic() - t0 < bound_s, "timed out waiting")
        time.sleep(step_s)
    return time.monotonic() - t0


def write_peers(path: str, addrs) -> None:
    """The peers file, replaced whole (a reader sees the old list or the
    new one, never half)."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("".join(f"{a}\n" for a in addrs))
    os.replace(tmp, path)


def phase_membership(torch, args) -> dict:
    """Where peers come from, and TLS.  A TLS pair and a plaintext pair of
    daemons on the bucket engine (2^member-log2-cap rows), each pair on
    file discovery over its own peers file.  Daemon A of the TLS pair,
    alone, takes GLOBAL traffic over TLS until every GLOBAL rank is
    pinned; then the file is rewritten with both: the ms from the write
    to each daemon's new ring, every pinned key demoted
    (membership_change = the number pinned), each demoted row in A's
    table equal to its hot row before.  Then the cluster traffic over
    gRPC, TLS_PAIRS interleaved pairs of the TLS pair against the
    plaintext pair (a warm-up pair first), forwards between peers over
    TLS: decisions/s of both, failed forwards (none), every non-GLOBAL
    key exact; a plaintext client is refused by the TLS daemon."""
    import os
    import tempfile

    import grpc

    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.config import DaemonConfig, TLSSettings
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.ops.decide import decide_cuda

    tmp = tempfile.mkdtemp(prefix="smoke-members-")
    ca, cert, key, how = write_certs(tmp)
    tls = TLSSettings(ca_file=ca, cert_file=cert, key_file=key)
    files = {s: os.path.join(tmp, f"{s}-peers") for s in ("tls", "plain")}
    ports = {s: [cluster.free_port() for _ in range(2)]
             for s in ("tls", "plain")}
    addrs = {s: [f"127.0.0.1:{p}" for p in ports[s]] for s in ports}

    def cfg(s, i):
        return DaemonConfig(
            grpc_listen_address=addrs[s][i],
            http_listen_address="127.0.0.1:0",
            cache_size=1 << args.member_log2_cap, batch_rows=1024,
            device=DEVICE, peer_discovery_type="file",
            peers_file=files[s], tls=tls if s == "tls" else None)

    daemons = {"tls": [], "plain": []}
    chans = {}
    try:
        decide_cuda.launches = 0
        for s in files:
            write_peers(files[s], addrs[s][:1])
            daemons[s].append(spawn_daemon(cfg(s, 0)))
        a = daemons["tls"][0]
        creds = a.tls.grpc_client_credentials()
        opts = [("grpc.use_local_subchannel_pool", 1)]

        def channels(s):
            mk = ((lambda ad: grpc.secure_channel(ad, creds, options=opts))
                  if s == "tls" else
                  (lambda ad: grpc.insecure_channel(ad, options=opts)))
            return [mk(addrs[s][t % 2]) for t in range(args.threads)]

        # A alone: GLOBAL ranks only, over TLS, until all are pinned
        chans["solo"] = [grpc.secure_channel(addrs["tls"][0], creds,
                                             options=opts)]
        solo = HotTraffic(args, {"tls": a},
                          {"tls": chans["solo"] * args.threads},
                          np.random.default_rng(args.seed + 13),
                          args.keys, 10)
        solo.runner("wire", lambda: zipf_ranks(
            solo.rng, 1.1, solo.n_all, 1000))("tls")
        hs = a.instance._hotset
        require(hs is not None and len(hs.slots) == solo.n_all,
                f"{0 if hs is None else len(hs.slots)} of {solo.n_all} "
                "GLOBAL ranks pinned on the daemon alone")
        for s in files:
            daemons[s].append(spawn_daemon(cfg(s, 1)))
        hs.sync()
        before = {k: hs.row_state(k) for k in hs.slots}
        d0 = demotions_of(a.instance)
        gen0 = {s: [d.instance._ring_gen for d in daemons[s]]
                for s in files}
        join_ms = {}
        for s in ("tls", "plain"):
            t0 = time.monotonic()
            write_peers(files[s], addrs[s])
            ms = []
            for d, g0 in zip(daemons[s], gen0[s]):
                wait_for(lambda d=d, g0=g0: d.instance._ring_gen > g0
                         and len(d.instance.peers()) == 2, 30.0)
                ms.append((time.monotonic() - t0) * 1e3)
            join_ms[s] = ms
        d1 = demotions_of(a.instance)
        demoted = d1["membership_change"] - d0["membership_change"]
        require(demoted == len(before) and not hs.slots,
                f"{demoted} demoted of {len(before)} pinned")
        karr = np.array(sorted(before), np.uint64)
        found, cols = a.instance.engine.gather_rows(karr)
        fields = ("remaining", "t_ms", "expire_at", "limit")
        require(found.all() and all(
            int(cols[f][j]) == int(before[int(k)][f])
            for j, k in enumerate(karr.tolist()) for f in fields),
            "a demoted row differs from its hot row")
        print(f"membership: file write to new ring {json.dumps(join_ms)} "
              f"ms; {demoted} pinned keys demoted, rows equal", flush=True)

        # the pair over TLS against the pair in plaintext
        chans.update({s: channels(s) for s in files})
        traffic = HotTraffic(args, {s: daemons[s][0] for s in files},
                             chans, np.random.default_rng(args.seed + 14),
                             args.keys, MEMBER_BATCHES)
        ab = interleaved_pairs("membership TLS / plaintext",
                               traffic.runner("wire"),
                               (("plain", nullcontext),
                                ("tls", nullcontext)), pairs=TLS_PAIRS)
        fails = {s: sum(d.instance.forward_failures for d in daemons[s])
                 for s in files}
        fwd = {s: sum(d.instance.forwarded_rows for d in daemons[s])
               for s in files}
        require(not any(fails.values()), f"failed forwards: {fails}")
        require(fwd["tls"] > 0, "no row was forwarded over TLS")
        for s in files:
            traffic.tally[s].check()
        with grpc.insecure_channel(addrs["tls"][0]) as ch:
            try:
                ch.unary_unary("/pb.gubernator.V1/GetRateLimits")(
                    b"", timeout=10)
                refused = None
            except grpc.RpcError as e:
                refused = e.code().name
        require(refused == "UNAVAILABLE",
                f"a plaintext client was not refused: {refused}")
        launches = decide_cuda.launches
        require(launches > 0, "the membership phase never launched K1")
        res = {"certs_by": how, "join_ms": join_ms,
               "pinned_before_join": len(before), "demoted": demoted,
               "ab": ab, "tls_over_plain_median": ab["median_ratio"],
               "forwarded_rows": fwd, "failed_forwards": fails,
               "plaintext_client": refused, "launches": launches,
               "checked_requests": {s: traffic.tally[s].n_req
                                    for s in files}}
        print(f"membership and TLS: {json.dumps({k: v for k, v in res.items() if k != 'ab'})}",
              flush=True)
    finally:
        for cs in chans.values():
            for ch in cs:
                ch.close()
        for s in daemons:
            for d in daemons[s]:
                d.close()
    return res


def free_port_pair() -> int:
    """A port p with TCP p and UDP p + 1 free now (a gossip daemon binds
    its gRPC port and gossips on the next)."""
    import socket

    from gubernator_tpu_torch import cluster

    for _ in range(100):
        p = cluster.free_port()
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as u:
                u.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    require(False, "no free port pair")


def phase_gossip(torch, args) -> dict:
    """GOSSIP_NODES daemons (small tables on the card) on member-list
    discovery over localhost UDP (each gossips on its gRPC port + 1,
    seeded with the first): the ms until every ring holds all of them;
    then the last is closed, and the ms until the others drop it (after
    the gossip's dead_ms) with rings of the rest."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.ops.decide import decide_cuda

    ports = [free_port_pair() for _ in range(GOSSIP_NODES)]
    ds = []
    decide_cuda.launches = 0
    try:
        for i, p in enumerate(ports):
            ds.append(spawn_daemon(DaemonConfig(
                grpc_listen_address=f"127.0.0.1:{p}",
                http_listen_address="127.0.0.1:0", cache_size=1 << 16,
                batch_rows=1024, device=DEVICE,
                peer_discovery_type="member-list",
                memberlist_known_hosts=(
                    [f"127.0.0.1:{ports[0] + 1}"] if i else []))))
        n = len(ds)
        converge_s = wait_for(lambda: all(len(d.instance.peers()) == n
                                          for d in ds), 60.0, 0.005)
        dead_ms = ds[0].discovery.dead_s * 1e3
        gone = ds.pop()
        gone.close()
        t0 = time.monotonic()
        drop_ms = []
        for d in ds:
            wait_for(lambda d=d: len(d.instance.peers()) == n - 1,
                     dead_ms / 1e3 + 60.0, 0.005)
            drop_ms.append((time.monotonic() - t0) * 1e3)
        rings = [sorted(p.info.grpc_address for p in d.instance.peers())
                 for d in ds]
        require(all(r == sorted(f"127.0.0.1:{p}" for p in ports[:-1])
                    for r in rings), f"rings after the drop: {rings}")
        launches = decide_cuda.launches
        require(launches > 0, "the gossip daemons never launched K1")
        res = {"nodes": n, "converge_ms": converge_s * 1e3,
               "dead_ms": dead_ms, "drop_ms": drop_ms, "rings": rings,
               "launches": launches}
        print(f"gossip: {json.dumps(res)}", flush=True)
    finally:
        for d in ds:
            d.close()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-cap", type=int, default=25,
                    help="bucket-table rows (log2)")
    ap.add_argument("--soa-log2-cap", type=int, default=24,
                    help="SoA-table rows (log2)")
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--waves", type=int, default=4,
                    help="timed mixed waves in phase 4")
    ap.add_argument("--main-waves", type=int, default=2,
                    help="waves of the main path's traffic in phase 4")
    ap.add_argument("--wave-rows", type=int, default=8192)
    ap.add_argument("--small-rows", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2,
                    help="timed rounds on the bucket path")
    ap.add_argument("--classic-rounds", type=int, default=2)
    ap.add_argument("--classic-sweep-ms", type=int, default=1_000,
                    help="the classic daemon's sweep interval")
    ap.add_argument("--sweep-reps", type=int, default=5)
    ap.add_argument("--batches", type=int, default=50,
                    help="batches per thread per timed round")
    ap.add_argument("--profile-batches", type=int, default=20,
                    help="batches per thread in the profiled round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cluster-log2-cap", type=int, default=24,
                    help="each cluster daemon's bucket-table rows (log2)")
    ap.add_argument("--cluster-rounds", type=int, default=2)
    ap.add_argument("--outage-batches", type=int, default=50,
                    help="batches per caller in the outage phase's "
                         "rehomed and recovered rounds")
    ap.add_argument("--handover-log2-cap", type=int, default=22,
                    help="the joining daemon's bucket-table rows (log2)")
    ap.add_argument("--tier-log2-cap", type=int, default=23,
                    help="the tiers phase's bucket-table rows (log2)")
    ap.add_argument("--member-log2-cap", type=int, default=22,
                    help="the membership phase's bucket-table rows (log2)")
    ap.add_argument("--only", default="",
                    help="run only these phases after the build (comma-"
                         "separated: main, cluster, hot, membership, "
                         "gossip); prints their results and no kernels "
                         "or ok line")
    args = ap.parse_args(argv)

    import torch

    with phase("device"):
        name, smi = phase_device(torch)
    with phase("build"):
        phase_build()
    only = [p for p in args.only.split(",") if p]
    if only:
        def main_path(torch, args):
            return phase_main_path(torch, args, *fit_population(
                args.keys, args.log2_cap))

        runs = {"main": main_path, "cluster": phase_cluster,
                "hot": phase_hot, "membership": phase_membership,
                "gossip": phase_gossip}
        out = {}
        for p in only:
            with phase(p):
                out[p] = runs[p](torch, args)
        print(json.dumps(out), flush=True)
        return 0
    with phase("probe"):
        k3 = phase_probe(torch, args)
    with phase("population"):
        pop_idx, pop_keys = fit_population(args.keys, args.log2_cap)
        from gubernator_tpu_torch.hashing import hash_request_keys

        sample = pop_idx[:: max(len(pop_idx) // 1000, 1)]
        require((smoke_hashes(sample) == hash_request_keys(
            ["smoke"] * len(sample),
            [f"k{i:08d}" for i in sample])).all(), "vectorized hash differs")
        print(f"{len(pop_keys)} keys fit a 2^{args.log2_cap}-row table",
              flush=True)
    with phase("kernel vs plain"):
        k = phase_kernel_vs_plain(torch, args, pop_idx, pop_keys)
    with phase("main path"):
        m = phase_main_path(torch, args, pop_idx, pop_keys)
    del pop_idx, pop_keys
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("cluster"):
        cl = phase_cluster(torch, args, m["wire"]["decisions_per_s"])
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("group"):
        grp = phase_group(torch, args, cl["decisions_per_s"],
                          m["wire"]["decisions_per_s"])
    with phase("regions"):
        reg = phase_regions(torch, args, m["wire"]["decisions_per_s"])
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("hot"):
        hot = phase_hot(torch, args)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("membership"):
        mem = phase_membership(torch, args)
    with phase("gossip"):
        gos = phase_gossip(torch, args)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("sweep vs plain"):
        k2 = phase_sweep_vs_plain(torch, args)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("classic main path"):
        c = phase_classic_main_path(torch, args)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with phase("tiers"):
        tiers = phase_tiers(torch, args)
    print(json.dumps({"main_path": m, "cluster": cl, "group": grp,
                      "regions": reg, "hot": hot, "membership": mem,
                      "gossip": gos, "kernel_detail": k,
                      "classic_main_path": c, "sweep_detail": k2,
                      "probe_detail": k3, "tiers": tiers}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "decide", "route": "cuda",
         "source": "gubernator_tpu_torch/csrc/decide.cu",
         "replaces": "gubernator_tpu/ops/pallas_step.py:338",
         "launches": m["launches"], "wire_launches": m["wire"]["launches"],
         "wire_pipeline_off_launches": m["wire_pipeline_off"]["launches"],
         "cluster_launches": cl["launches"],
         "cluster_steps_per_daemon": cl["steps_per_daemon"],
         "outage_launches": cl["outage"]["launches"],
         "group_launches": grp["launches"],
         "group_launches_per_worker": grp["launches_per_worker"],
         "regions_launches": reg["launches"],
         "hot_launches": hot["launches"],
         "membership_launches": mem["launches"],
         "gossip_launches": gos["launches"],
         "wire_analytics_off_launches": m["wire_analytics_off_launches"],
         "tiers_launches": tiers["served"]["launches"],
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "launch_ms": k["launch_ms"],
         "launch_mixed_ms": k["launch_mixed_ms"]},
        {"name": "sweep", "route": "cuda",
         "source": "gubernator_tpu_torch/csrc/sweep.cu",
         "replaces": "gubernator_tpu/ops/pallas_sweep.py:48",
         "launches": c["launches"], "wire_launches": c["wire"]["launches"],
         "wire_pipeline_off_launches": c["wire_pipeline_off"]["launches"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "one_call_ms": k2["one_call_ms"]},
        {"name": "probe_add", "route": "cuda",
         "source": "gubernator_tpu_torch/csrc/probe.cu",
         "replaces": "tools/pallas_probe.py:93",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": k3["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
