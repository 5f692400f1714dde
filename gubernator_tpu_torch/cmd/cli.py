"""Load-test and debug CLI of the port: the counterpart of
gubernator_tpu/cmd/cli.py (reference: cmd/gubernator-cli/main.go), with
the same flags, key stream and output.

Load tester (gRPC by default; ``--http`` for the JSON gateway):

    python -m gubernator_tpu_torch.cmd.cli --address host:port
        [--rate-limits N] [--concurrency C] [--batch B] [--duration S]
        [--zipf A] [--limit L] [--window MS] [--http] [--json]

Each worker draws ``rng.zipf(A) % N`` keys from ``default_rng(worker)``
(uniform keys when A <= 1); ``--json`` prints one line: decisions,
decisions_per_s, over_limit, p50_ms, p99_ms, batch, concurrency, errors.

Debug subcommands (one daemon's debug endpoints):

    python -m gubernator_tpu_torch.cmd.cli debug
        {events,traces,topkeys,tenants,slo,memory,faults}
        [--url http://host:port] [--json] ...

Fleet subcommands (every daemon's endpoints, folded exactly by
fleet.py; exit 1 on a failed fetch or verdict):

    python -m gubernator_tpu_torch.cmd.cli fleet
        {status,audit,topkeys,tenants,slo,memory}
        --url http://d1:1050 --url http://d2:1050 ...

Talks to a daemon over the network only: it builds no engine and
touches no device.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def _fetch_json(url: str, timeout: float):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as f:
        return json.loads(f.read())


def _debug_main(argv) -> int:
    """``debug events``: fetch the daemon's flight-recorder ring from
    GET /debug/events (kind/since-seq filtered SERVER-side) and print
    it.  ``debug topkeys``: the heavy-hitter ledger from
    GET /debug/topkeys."""
    ap = argparse.ArgumentParser(
        prog="guber-cli debug",
        description="gubernator-tpu-torch debug introspection")
    sub = ap.add_subparsers(dest="what", required=True)
    ev = sub.add_parser("events",
                        help="dump the daemon's flight-recorder ring")
    ev.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url (or a full "
                         "/debug/events url)")
    ev.add_argument("--limit", type=int, default=0,
                    help="only the newest N events")
    ev.add_argument("--kind", default="",
                    help="only events of this kind (e.g. wave_stalled)")
    ev.add_argument("--since-seq", type=int, default=0,
                    help="only events with seq > N (incremental polls)")
    ev.add_argument("--trace", default="",
                    help="only events stamped with this trace id "
                         "(server-side filter)")
    ev.add_argument("--timeout", type=float, default=10.0)
    ev.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    tr = sub.add_parser("traces",
                        help="dump the daemon's span-recorder ring "
                             "(/debug/traces), assembled per trace")
    tr.add_argument("--url", action="append", dest="urls", default=None,
                    help="daemon HTTP base url (default "
                         "http://localhost:1050); repeat to stitch "
                         "several daemons' slices into one tree")
    tr.add_argument("--trace-id", default="",
                    help="only spans of this trace (server-side)")
    tr.add_argument("--limit", type=int, default=0,
                    help="only the newest N spans per daemon")
    tr.add_argument("--waterfall", action="store_true",
                    help="render each assembled trace as a text "
                         "waterfall")
    tr.add_argument("--timeout", type=float, default=10.0)
    tr.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    tk = sub.add_parser("topkeys",
                        help="dump the daemon's heavy-hitter key "
                             "ledger (/debug/topkeys)")
    tk.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url (or a full "
                         "/debug/topkeys url)")
    tk.add_argument("--limit", type=int, default=0,
                    help="only the heaviest N keys")
    tk.add_argument("--timeout", type=float, default=10.0)
    tk.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    tn = sub.add_parser("tenants",
                        help="dump the daemon's per-tenant RED ledger "
                             "(/debug/tenants)")
    tn.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url (or a full "
                         "/debug/tenants url)")
    tn.add_argument("--timeout", type=float, default=10.0)
    tn.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    sl = sub.add_parser("slo",
                        help="dump the daemon's SLO burn-rate verdicts "
                             "(/debug/slo)")
    sl.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url (or a full "
                         "/debug/slo url)")
    sl.add_argument("--timeout", type=float, default=10.0)
    sl.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    mm = sub.add_parser("memory",
                        help="dump the daemon's device-memory ledger "
                             "(/debug/memory)")
    mm.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url (or a full "
                         "/debug/memory url)")
    mm.add_argument("--advise", action="store_true",
                    help="include the water-filling split "
                         "recommendation (?advise=1)")
    mm.add_argument("--timeout", type=float, default=10.0)
    mm.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    fl = sub.add_parser("faults",
                        help="inspect or arm the daemon's fault-"
                             "injection points (/debug/faults)")
    fl.add_argument("--url", default="http://localhost:1050",
                    help="daemon HTTP base url")
    fl.add_argument("--set", dest="spec", default=None,
                    help="arm this fault spec (e.g. "
                         "'peer_send:error:0.3,device_step:delay:50ms')")
    fl.add_argument("--seed", type=int, default=None,
                    help="deterministic seed for the armed points")
    fl.add_argument("--clear", action="store_true",
                    help="disarm every faultpoint")
    fl.add_argument("--timeout", type=float, default=10.0)
    fl.add_argument("--json", action="store_true",
                    help="print the raw JSON document")
    args = ap.parse_args(argv)
    if args.what == "topkeys":
        return _debug_topkeys(args)
    if args.what == "tenants":
        return _debug_tenants(args)
    if args.what == "slo":
        return _debug_slo(args)
    if args.what == "memory":
        return _debug_memory(args)
    if args.what == "faults":
        return _debug_faults(args)
    if args.what == "traces":
        return _debug_traces(args)

    url = args.url
    if "/debug/events" not in url:
        url = url.rstrip("/") + "/debug/events"

    def _q(param):
        nonlocal url
        url += ("&" if "?" in url else "?") + param

    if args.limit > 0:
        _q(f"limit={args.limit}")
    if args.kind:
        # server-side filter; the client-side pass below still applies
        # (harmless, and keeps the flag working against older daemons)
        _q(f"kind={args.kind}")
    if args.since_seq > 0:
        _q(f"since_seq={args.since_seq}")
    if args.trace:
        _q(f"trace={args.trace}")
    try:
        body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    events = body.get("events", [])
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.json:
        print(json.dumps({"events": events}))
        return 0
    for e in events:
        seq, kind = e.get("seq"), e.get("kind")
        t_ms, trace = e.get("t_ms"), e.get("trace")
        rest = {k: v for k, v in e.items()
                if k not in ("seq", "kind", "t_ms", "trace")}
        line = f"#{seq} t={t_ms} {kind}"
        if trace:
            line += f" trace={trace}"
        if rest:
            line += " " + json.dumps(rest, sort_keys=True)
        print(line)
    if not events:
        print("(no events)", file=sys.stderr)
    return 0


def _debug_traces(args) -> int:
    urls = args.urls or ["http://localhost:1050"]
    spans, meta = [], []
    for base in urls:
        url = base
        if "/debug/traces" not in url:
            url = url.rstrip("/") + "/debug/traces"
        if args.trace_id:
            url += ("&" if "?" in url else "?") + f"trace_id={args.trace_id}"
        if args.limit > 0:
            url += ("&" if "?" in url else "?") + f"limit={args.limit}"
        try:
            body = _fetch_json(url, args.timeout)
        except Exception as e:  # noqa: BLE001
            print(f"fetch failed ({base}): {e!r}", file=sys.stderr)
            return 1
        spans.extend(body.get("spans", []))
        meta.append({k: body.get(k) for k in ("sample", "capacity", "dropped")})
    if args.json:
        print(json.dumps({"daemons": meta, "spans": spans}))
        return 0
    from ..tracing import assemble, render_waterfall
    traces = assemble(spans, trace_id=args.trace_id or None)
    if not traces:
        print("(no spans)", file=sys.stderr)
        return 0
    for trace in traces:
        if args.waterfall:
            print(render_waterfall(trace))
            print()
            continue
        tid = trace["trace_id"]
        print(f"trace {tid}: {trace['spans']} span(s)")

        def _walk(node, depth):
            dur_ms = (node["end"] - node["start"]) * 1e3
            line = (f"  {'  ' * depth}{node['name']} "
                    f"[{node['span_id']}] {dur_ms:.3f}ms")
            if node.get("attrs"):
                line += " " + json.dumps(node["attrs"], sort_keys=True)
            print(line)
            for c in node.get("children", []):
                _walk(c, depth + 1)

        for root in trace["roots"]:
            _walk(root, 0)
    return 0


def _debug_topkeys(args) -> int:
    url = args.url
    if "/debug/topkeys" not in url:
        url = url.rstrip("/") + "/debug/topkeys"
    if args.limit > 0:
        url += ("&" if "?" in url else "?") + f"limit={args.limit}"
    try:
        body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body))
        return 0
    print(f"top-{body.get('k')} of ~{body.get('total_hits_observed')} "
          f"hits across {body.get('waves_tapped')} waves "
          f"(width={body.get('width')}, "
          f"admission_err<={body.get('admission_error_bound')}, "
          f"dropped={body.get('taps_dropped')})")
    keys = body.get("keys", [])
    for e in keys:
        name = e.get("key") or e.get("khash")
        line = (f"{e.get('hits'):>12}  over={e.get('over_limit'):<8} "
                f"err<={e.get('err'):<6} {name}")
        if e.get("owner"):
            line += f"  owner={e['owner']}"
        print(line)
    if not keys:
        print("(no keys tracked)", file=sys.stderr)
    return 0


def _debug_tenants(args) -> int:
    """``debug tenants``: the per-tenant RED ledger round trip."""
    url = args.url
    if "/debug/tenants" not in url:
        url = url.rstrip("/") + "/debug/tenants"
    try:
        body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body))
        return 0
    if not body.get("enabled", False):
        print("tenant attribution disabled", file=sys.stderr)
        return 1
    print(f"tenants: {body.get('tenant_count')} "
          f"(delim={body.get('delim')!r} max={body.get('max_tenants')} "
          f"overflowed={body.get('overflowed')})")
    hdr = ("requests", "hits", "over_limit", "errors", "degraded",
           "shed")
    print(f"{'tenant':<24}" + "".join(f"{h:>11}" for h in hdr))
    rows = sorted(body.get("tenants", {}).items(),
                  key=lambda kv: -kv[1].get("requests", 0))
    for name, c in rows:
        print(f"{name:<24}" + "".join(f"{c.get(h, 0):>11}"
                                      for h in hdr))
    tot = body.get("totals", {})
    print(f"{'TOTAL':<24}" + "".join(f"{tot.get(h, 0):>11}"
                                     for h in hdr))
    return 0


def _debug_slo(args) -> int:
    """``debug slo``: the burn-rate verdict round trip."""
    url = args.url
    if "/debug/slo" not in url:
        url = url.rstrip("/") + "/debug/slo"
    try:
        body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body))
        return 0
    print(f"windows: fast={body.get('fast_window_s')}s "
          f"slow={body.get('slow_window_s')}s "
          f"threshold={body.get('burn_threshold')} "
          f"ticks={body.get('ticks')}")
    for r in body.get("slos", []):
        name = r["slo"]
        if r.get("tenant"):
            name += f"[{r['tenant']}]"
        state = "BREACH" if r.get("breached") else "ok"
        line = (f"  {name:<40} {state:<7} "
                f"fast={r.get('fast_burn'):<8} "
                f"slow={r.get('slow_burn'):<8}")
        if r.get("value") is not None:
            line += (f" value={r['value']} target={r['target']}")
        print(line)
    return 0


def _debug_memory(args) -> int:
    """``debug memory``: the device-memory ledger round trip."""
    url = args.url
    if "/debug/memory" not in url:
        url = url.rstrip("/") + "/debug/memory"
    if args.advise:
        url += ("&" if "?" in url else "?") + "advise=1"
    try:
        body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body))
        return 0
    print(f"device_bytes={body.get('device_bytes')} "
          f"host_bytes={body.get('host_bytes')} "
          f"pressure={body.get('pressure'):.4f} "
          f"target={body.get('pressure_target')}")
    for name, rec in sorted(body.get("consumers", {}).items()):
        if "error" in rec:
            print(f"  {name:<14} ERROR {rec['error']}")
            continue
        side = "host" if rec.get("host") else "hbm"
        line = (f"  {name:<14} {side:<4} bytes={rec['bytes']:<12} "
                f"rows={rec['occupied_rows']}/{rec['capacity_rows']}")
        if rec.get("advisable"):
            line += " advisable"
        print(line)
    adv = body.get("advise")
    if adv:
        print(f"advised split over {adv['total_rows']} rows "
              f"(floor {adv['floor_rows']}):")
        for name in sorted(adv.get("advised", {})):
            print(f"  {name:<14} {adv['current'].get(name, 0):>8} "
                  f"-> {adv['advised'][name]:>8} "
                  f"(pow2 {adv['advised_pow2'][name]})")
    return 0


def _debug_faults(args) -> int:
    """``debug faults``: round-trip the daemon's fault-injection state
    (GET /debug/faults; --set/--clear POST a new spec)."""
    import urllib.request

    url = args.url.rstrip("/") + "/debug/faults"
    try:
        if args.clear or args.spec is not None:
            payload = ({"clear": True} if args.clear
                       else {"spec": args.spec, "seed": args.seed})
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=args.timeout) as f:
                body = json.loads(f.read())
        else:
            body = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001
        print(f"fetch failed: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body))
        return 0
    state = "ARMED" if body.get("armed") else "disarmed"
    print(f"faults {state} (seed={body.get('seed')}) "
          f"spec={body.get('spec') or '-'}")
    for p in body.get("points", []):
        tag = f"@{p['tag']}" if p.get("tag") else ""
        extra = (f" delay={p['delay_ms']}ms" if p.get("delay_ms")
                 else "")
        print(f"  {p['point']}{tag}:{p['mode']} p={p['prob']}{extra} "
              f"checked={p['checked']} fired={p['fired']}")
    if not body.get("points"):
        print(f"  (catalog: {', '.join(body.get('catalog', []))})")
    return 0


def _fleet_main(argv) -> int:
    """``fleet {status,audit,topkeys,tenants,slo,memory}``: fetch the
    matching /debug endpoint from EVERY --url daemon and fold the
    documents through fleet.py's exact merges.  Exit 1 on fetch
    failure or a failed conservation/consistency verdict, so the
    command doubles as a cluster health probe."""
    ap = argparse.ArgumentParser(
        prog="guber-cli fleet",
        description="cluster-wide folds over every daemon's debug "
                    "endpoints (fleet.py)")
    sub = ap.add_subparsers(dest="what", required=True)
    helps = {
        "status": "healthz rollup + ring consistency + conservation",
        "audit": "fold the daemons' conservation audit vectors",
        "topkeys": "cluster top-K via the exact Space-Saving merge",
        "tenants": "fleet tenant RED rollup (sum-asserted)",
        "slo": "fleet SLO burn rollup (worst-of latch + summed burn)",
        "memory": "fleet memory-ledger pressure",
    }
    for what, h in helps.items():
        p = sub.add_parser(what, help=h)
        p.add_argument("--url", action="append", dest="urls",
                       default=None,
                       help="daemon HTTP base url (repeat per daemon; "
                            "default http://localhost:1050)")
        p.add_argument("--timeout", type=float, default=10.0)
        p.add_argument("--json", action="store_true",
                       help="print the raw folded JSON document")
        if what == "topkeys":
            p.add_argument("--limit", type=int, default=0,
                           help="only the heaviest N keys")
    args = ap.parse_args(argv)
    urls = args.urls or ["http://localhost:1050"]
    endpoint = {"status": "/healthz", "audit": "/debug/audit",
                "topkeys": "/debug/topkeys",
                "tenants": "/debug/tenants", "slo": "/debug/slo",
                "memory": "/debug/memory"}[args.what]

    def _fan(path):
        docs = []
        for base in urls:
            try:
                docs.append(_fetch_json(
                    base.rstrip("/") + path, args.timeout))
            except Exception as e:  # noqa: BLE001
                print(f"fetch failed ({base}{path}): {e!r}",
                      file=sys.stderr)
                return None
        return docs

    docs = _fan(endpoint)
    if docs is None:
        return 1
    from .. import fleet

    if args.what == "status":
        audits = _fan("/debug/audit")
        body = fleet.merge_status(docs, audits)
        if args.json:
            print(json.dumps(body))
        else:
            print(f"daemons: {body['healthy']}/{body['daemons']} "
                  f"healthy  peer_counts={body['peer_counts']}")
            ring = body.get("ring")
            if ring:
                state = ("consistent" if ring["consistent"] else
                         "DIVERGED(" + ",".join(ring["reasons"]) + ")")
                print(f"ring: {state}  ejected={ring['ejected']}")
            cons = body.get("conservation")
            if cons:
                print(f"conservation: drift={cons['drift']} "
                      f"{'OK' if cons['conserved'] else 'DRIFTING'}")
        ring_ok = (body.get("ring") or {}).get("consistent", True)
        cons_ok = (body.get("conservation")
                   or {}).get("conserved", True)
        return 0 if (body["healthy"] == body["daemons"] and ring_ok
                     and cons_ok) else 1
    if args.what == "audit":
        body = fleet.fold_audits(docs)
        body["ring"] = fleet.ring_verdict(docs)
        if args.json:
            print(json.dumps(body))
        else:
            t = body["totals"]
            print(f"fleet drift: {body['drift']} "
                  f"({'CONSERVED' if body['conserved'] else 'DRIFT'})"
                  f"  bound={body['bound_s']}s "
                  f"staleness<={body['staleness_bound_s']}s")
            print(f"  injected={t['injected']} applied={t['applied']} "
                  f"queued={t['queued']} in_flight={t['in_flight']} "
                  f"lost={t['lost']} deg_pending={t['deg_pending']}")
            if t["mesh_injected"] or t["mesh_folded"]:
                print(f"  mesh: injected={t['mesh_injected']} "
                      f"folded={t['mesh_folded']}")
            for r in body["per_daemon"]:
                print(f"  {r['instance'] or '?':<24} "
                      f"drift={r['drift']:<8} queued={r['queued']:<8} "
                      f"in_flight={r['in_flight']:<6} "
                      f"lost={r['lost']:<6} "
                      f"drain_age={r['drain_age_s']}s")
            ring = body["ring"]
            state = ("consistent" if ring["consistent"] else
                     "DIVERGED(" + ",".join(ring["reasons"]) + ")")
            print(f"ring: {state} across {ring['daemons']} daemon(s)")
        return 0 if (body["conserved"]
                     and body["ring"]["consistent"]) else 1
    if args.what == "topkeys":
        body = fleet.merge_topkeys(docs, k=args.limit or None)
        if args.json:
            print(json.dumps(body))
        else:
            print(f"fleet top-{body['k']} of "
                  f"~{body['total_hits_observed']} hits across "
                  f"{body['daemons']} daemon(s) "
                  f"(admission_err<={body['admission_error_bound']})")
            for e in body["keys"]:
                name = e.get("key") or e.get("khash")
                line = (f"{e.get('hits'):>12}  "
                        f"over={e.get('over_limit'):<8} "
                        f"err<={e.get('err'):<6} {name}")
                if e.get("owner"):
                    line += f"  owner={e['owner']}"
                print(line)
        return 0
    if args.what == "tenants":
        body = fleet.merge_tenants(docs)
        if args.json:
            print(json.dumps(body))
        else:
            print(f"fleet tenants: {body['tenant_count']} across "
                  f"{body['enabled_daemons']}/{body['daemons']} "
                  f"daemon(s)  "
                  f"{'SUM-OK' if body['conserved'] else 'SUM-MISMATCH'}")
            hdr = ("requests", "hits", "over_limit", "errors",
                   "degraded", "shed")
            print(f"{'tenant':<24}"
                  + "".join(f"{h:>11}" for h in hdr))
            rows = sorted(body["tenants"].items(),
                          key=lambda kv: -kv[1].get("requests", 0))
            for name, c in rows:
                print(f"{name:<24}"
                      + "".join(f"{c.get(h, 0):>11}" for h in hdr))
            tot = body["totals"]
            print(f"{'TOTAL':<24}"
                  + "".join(f"{tot.get(h, 0):>11}" for h in hdr))
        return 0 if body["conserved"] else 1
    if args.what == "slo":
        body = fleet.merge_slo(docs)
        if args.json:
            print(json.dumps(body))
        else:
            print(f"fleet SLOs across {body['daemons']} daemon(s), "
                  f"{body['ticks']} ticks; "
                  f"breached: {body['breached'] or 'none'}")
            for r in body["slos"]:
                name = r["slo"]
                if r.get("tenant"):
                    name += f"[{r['tenant']}]"
                state = "BREACH" if r["breached"] else "ok"
                line = (f"  {name:<40} {state:<7} "
                        f"fast_max={r['fast_burn_max']:<8} "
                        f"fast_sum={r['fast_burn_sum']:<8}")
                if r.get("value_max") is not None:
                    line += (f" value_max={r['value_max']} "
                             f"target={r.get('target')}")
                print(line)
        return 0
    body = fleet.merge_memory(docs)
    if args.json:
        print(json.dumps(body))
    else:
        print(f"fleet memory: device={body['device_bytes']} "
              f"host={body['host_bytes']} "
              f"max_pressure={body['max_pressure']}")
        for name, b in sorted(body["consumer_bytes"].items()):
            print(f"  {name:<14} bytes={b}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "debug":
        return _debug_main(argv[1:])
    if argv and argv[0] == "fleet":
        return _fleet_main(argv[1:])
    ap = argparse.ArgumentParser(
        description="gubernator-tpu-torch load tester")
    ap.add_argument("--address", default="localhost:1051")
    ap.add_argument("--http", action="store_true",
                    help="use the HTTP/JSON gateway instead of gRPC")
    ap.add_argument("--rate-limits", type=int, default=100_000,
                    help="distinct keys")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--duration", type=float, default=10.0, help="seconds")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="Zipf skew (0 = uniform)")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--window", type=int, default=10_000, help="ms")
    ap.add_argument("--json", action="store_true", help="one-line JSON out")
    args = ap.parse_args(argv)

    from ..client import Client, HttpClient
    from ..types import RateLimitRequest

    def draw_keys(rng, n):
        if args.zipf > 1.0:
            return rng.zipf(args.zipf, size=n) % args.rate_limits
        return rng.integers(0, args.rate_limits, size=n)

    def mk_client():
        if args.http:
            return HttpClient(f"http://{args.address}")
        return Client(args.address)

    stop = time.monotonic() + args.duration
    lats: list = []
    counts = [0] * args.concurrency
    over = [0] * args.concurrency
    errs: list = []
    lock = threading.Lock()

    def worker(w: int):
        c = mk_client()
        rng = np.random.default_rng(w)  # Generator is not thread-safe
        while time.monotonic() < stop:
            keys = draw_keys(rng, args.batch)
            reqs = [RateLimitRequest(
                name="load", unique_key=f"k{k}", hits=1, limit=args.limit,
                duration=args.window) for k in keys]
            t0 = time.perf_counter()
            try:
                resps = c.get_rate_limits(reqs)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errs.append(str(e) or repr(e))
                return
            dt = time.perf_counter() - t0
            counts[w] += len(resps)
            over[w] += sum(1 for r in resps if int(r.status) == 1)
            with lock:
                lats.append(dt * 1000)

    threads = [threading.Thread(target=worker, args=(w,),
                                name=f"cli-bench-{w}")
               for w in range(args.concurrency)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.monotonic() - t_start

    total = sum(counts)
    out = {
        "decisions": total,
        "decisions_per_s": round(total / max(elapsed, 1e-9)),
        "over_limit": sum(over),
        "p50_ms": round(float(np.percentile(lats, 50)), 3) if lats else None,
        "p99_ms": round(float(np.percentile(lats, 99)), 3) if lats else None,
        "batch": args.batch,
        "concurrency": args.concurrency,
        "errors": errs[:3],
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"decisions: {out['decisions']} "
              f"({out['decisions_per_s']}/s)  over_limit: {out['over_limit']}")
        print(f"latency: p50={out['p50_ms']}ms p99={out['p99_ms']}ms "
              f"(batch={args.batch} x{args.concurrency} workers)")
        for e in errs[:3]:
            print("ERROR:", e, file=sys.stderr)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
