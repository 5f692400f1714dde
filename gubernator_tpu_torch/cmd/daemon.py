"""The daemon binary: config → spawn → wait for a signal.

Usage: python -m gubernator_tpu_torch.cmd.daemon [--config FILE]
(GUBER_GRPC_ADDRESS, GUBER_HTTP_ADDRESS, GUBER_CACHE_SIZE,
GUBER_BATCH_ROWS, GUBER_ENGINE, GUBER_CACHE_AUTOGROW_MAX, GUBER_DEVICE,
GUBER_LOG_LEVEL, and for a cluster GUBER_PEER_DISCOVERY_TYPE,
GUBER_PEERS, GUBER_ADVERTISE_ADDRESS, GUBER_CLIENT_ADDRESS (a shared
SO_REUSEPORT client port), GUBER_DATA_CENTER, GUBER_INSTANCE_ID,
GUBER_BATCH_*, GUBER_GLOBAL_* and GUBER_MULTI_REGION_* apply; see
config.py; an empty GUBER_GRPC_ADDRESS serves no gRPC and no
peers).  Serves on the GPU unless GUBER_DEVICE=cpu, through the bucket
engine unless GUBER_ENGINE=xla selects the classic SoA engine.
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="gubernator-tpu-torch daemon")
    ap.add_argument("--config", default="", help="KEY=value config file")
    ap.add_argument("--grpc", default=None,
                    help="override GUBER_GRPC_ADDRESS (\"\" = no gRPC)")
    ap.add_argument("--http", default="", help="override GUBER_HTTP_ADDRESS")
    ap.add_argument("--device", default="", help="override GUBER_DEVICE")
    args = ap.parse_args(argv)

    from ..config import setup_daemon_config
    from ..daemon import spawn_daemon

    cfg = setup_daemon_config(conf_file=args.config)
    if args.grpc is not None:
        cfg.grpc_listen_address = args.grpc
    if args.http:
        cfg.http_listen_address = args.http
    if args.device:
        cfg.device = args.device
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    d = spawn_daemon(cfg)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"gubernator-tpu-torch {cfg.instance_id or ''} listening "
          f"grpc={cfg.grpc_listen_address or 'off'} (port {d.grpc_port}) "
          f"client={cfg.client_listen_address or 'off'} "
          f"dc={cfg.data_center or '-'} "
          f"advertise={d.advertise_address or '-'} "
          f"peers={len(d.instance.peers())} "
          f"http={cfg.http_listen_address} "
          f"device={cfg.device} "
          f"engine={type(d.instance.engine).__name__}", flush=True)
    stop.wait()
    d.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
