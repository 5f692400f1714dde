"""Container healthcheck: exit 0 iff the daemon reports healthy (the
port's copy of gubernator_tpu/cmd/healthcheck.py).

Usage: python -m gubernator_tpu_torch.cmd.healthcheck [--url URL]
[--timeout S] [--deep] [--fail-on-stall]

``--deep`` asks for the daemon's deep health (``/healthz?deep=1``) and
prints its dispatcher block (queue depth, last-wave age, stalled state).
A stalled wave does not fail the check by itself (a first-use kernel
build recovers on its own, and a restart mid-build makes it worse)
unless ``--fail-on-stall`` is also given.  The JAX CLI's
``--fail-on-burn`` waits for the SLO slice.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from urllib.parse import urlencode, urlsplit, urlunsplit


def _with_deep(url: str) -> str:
    """``url`` with deep=1 appended to its query string."""
    parts = urlsplit(url)
    q = parts.query + ("&" if parts.query else "") + urlencode({"deep": 1})
    return urlunsplit((parts.scheme, parts.netloc, parts.path, q,
                       parts.fragment))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://localhost:1050/v1/HealthCheck")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--deep", action="store_true",
                    help="request dispatcher queue/wave/stall state "
                         "(/healthz?deep=1) and print it")
    ap.add_argument("--fail-on-stall", action="store_true",
                    help="with --deep: exit 1 when the dispatcher "
                         "reports a stalled wave")
    args = ap.parse_args(argv)
    url = _with_deep(args.url) if args.deep else args.url
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as f:
            body = json.loads(f.read())
    except Exception as e:  # noqa: BLE001 - any failure is "unhealthy"
        # the repr: str() of a socket timeout can be empty
        print(f"unhealthy: {e!r}", file=sys.stderr)
        return 1
    if body.get("status") != "healthy":
        print(f"unhealthy: {body}", file=sys.stderr)
        return 1
    disp = body.get("dispatcher")
    if args.deep and disp is not None:
        print("dispatcher:", json.dumps(disp, sort_keys=True))
        if disp.get("stalled"):
            print("WARNING: dispatcher reports a stalled wave "
                  f"(oldest_wave_age_s={disp.get('oldest_wave_age_s')}, "
                  f"threshold={disp.get('stall_threshold_s')}s)",
                  file=sys.stderr)
            if args.fail_on_stall:
                return 1
    print("healthy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
