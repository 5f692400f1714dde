"""Start a local cluster of port daemons (the port of
gubernator_tpu/cmd/cluster.py; cmd/gubernator-cluster/main.go).

Usage: python -m gubernator_tpu_torch.cmd.cluster [--count N]
           [--base-port P] [--device cuda|cpu]
       python -m gubernator_tpu_torch.cmd.cluster --group [--count N]
           [--client-port P] [--device cuda|cpu]

Without --group the daemons run in this process on ports base-port,
base-port + 1, ... (gRPC, HTTP per daemon).  With --group each daemon is
an OS process of its own (its own interpreter and engine; on cuda they
share the card) and all of them serve clients on one SO_REUSEPORT port
(cluster.py › start_subprocess_group).  Serves until SIGINT / SIGTERM.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="local gubernator-tpu-torch "
                                             "cluster")
    ap.add_argument("--count", type=int, default=4)
    ap.add_argument("--base-port", type=int, default=9080)
    ap.add_argument("--cache-size", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda",
                    help="each daemon's device (cuda or cpu)")
    ap.add_argument("--group", action="store_true",
                    help="a SO_REUSEPORT group of daemon processes "
                         "sharing one client port")
    ap.add_argument("--client-port", type=int, default=0,
                    help="with --group: the shared client port "
                         "(0 = any free port)")
    args = ap.parse_args(argv)
    if args.group and args.base_port != ap.get_default("base_port"):
        ap.error("--base-port applies only without --group (group "
                 "workers take free peer ports; --client-port sets the "
                 "shared one)")

    def serve(handle) -> None:
        # handlers only after start-up, so Ctrl-C still interrupts a
        # slow start
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        stop.wait()
        handle.stop()

    if args.group:
        from ..cluster import start_subprocess_group

        g = start_subprocess_group(args.count, device=args.device,
                                   cache_size=args.cache_size,
                                   client_port=args.client_port)
        print(f"group client={g.client_address}", flush=True)
        for i, addr in enumerate(g.grpc_addresses):
            print(f"worker[{i}] peer-grpc={addr} "
                  f"http={g.http_addresses[i]}", flush=True)
        serve(g)
        return 0

    from ..cluster import start_with
    from ..config import DaemonConfig

    c = start_with([DaemonConfig(
        grpc_listen_address=f"127.0.0.1:{args.base_port + 2 * i}",
        http_listen_address=f"127.0.0.1:{args.base_port + 2 * i + 1}",
        cache_size=args.cache_size, device=args.device)
        for i in range(args.count)])
    for i, d in enumerate(c.daemons):
        print(f"daemon[{i}] grpc={d.advertise_address} "
              f"http={d.cfg.http_listen_address}", flush=True)
    serve(c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
