"""Configuration: the subset of gubernator_tpu/config.py that the port's
single-daemon slice reads, plus the ``device`` it serves on.

Layering is the JAX package's: defaults < ``KEY=value`` config file <
environment (``GUBER_*``).  Keys the port does not read yet (peers,
TLS, ...) are ignored, so the repository's example.conf loads as is.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class Config:
    """Core-instance configuration."""

    #: Rows in the device counter table (rounded up to a power of two;
    #: the instance serves at least 1024).
    cache_size: int = 1 << 16
    #: Rows of the small wave bucket (the big one is 8×).
    batch_rows: int = 1024
    #: Upper bound (rows) for the classic engine's on-device auto-grow
    #: when the table fills with live keys (0 disables); rounded down to
    #: a power of two.  The bucket engine has no grow.
    cache_autogrow_max: int = 0
    #: Serving engine (GUBER_ENGINE): "" / "auto" / "pallas" = the bucket
    #: engine (K1; counters < 2^30), "xla" / "sharded" = the classic SoA
    #: engine (the full value domain, auto-grow).  Anything else raises.
    engine: str = ""
    #: Milliseconds between expired-row sweeps (0 disables).
    sweep_interval_ms: int = 30_000
    #: Device the engine serves on: "cuda" (default; raises without a
    #: GPU) or "cpu" (the plain PyTorch step).
    device: str = "cuda"

    def set_defaults(self) -> "Config":
        """Normalize invalid values (config.go › SetDefaults)."""
        if self.cache_size <= 0:
            self.cache_size = 1 << 16
        self.cache_size = 1 << (self.cache_size - 1).bit_length()
        if self.batch_rows <= 0:
            self.batch_rows = 1024
        return self


@dataclass
class DaemonConfig:
    """Everything needed to spawn a daemon."""

    http_listen_address: str = "localhost:1050"
    #: gRPC front door (V1 GetRateLimits / HealthCheck and
    #: grpc.health.v1); "" serves none.  Needs grpcio: with an address
    #: set and no grpcio the daemon raises.
    grpc_listen_address: str = "localhost:1051"
    cache_size: int = 1 << 16
    batch_rows: int = 1024
    cache_autogrow_max: int = 0
    engine: str = ""
    sweep_interval_ms: int = 30_000
    device: str = "cuda"
    log_level: str = "info"

    def instance_config(self) -> Config:
        return Config(cache_size=self.cache_size,
                      batch_rows=self.batch_rows,
                      cache_autogrow_max=self.cache_autogrow_max,
                      engine=self.engine,
                      sweep_interval_ms=self.sweep_interval_ms,
                      device=self.device).set_defaults()


def load_conf_file(path: str) -> Dict[str, str]:
    """Parse a ``KEY=value`` config file: blank lines and #-comments
    ignored."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(
                    f"invalid config line (want KEY=value): {line!r}")
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def setup_daemon_config(conf_file: str = "",
                        env: Optional[Dict[str, str]] = None
                        ) -> DaemonConfig:
    """DaemonConfig from defaults < config file < environment.  ``env``
    replaces os.environ (hermetic tests)."""
    conf = load_conf_file(conf_file) if conf_file else {}
    conf.update(os.environ if env is None else env)
    d = DaemonConfig()
    d.http_listen_address = conf.get("GUBER_HTTP_ADDRESS",
                                     d.http_listen_address)
    d.grpc_listen_address = conf.get("GUBER_GRPC_ADDRESS",
                                     d.grpc_listen_address)
    d.cache_size = int(conf.get("GUBER_CACHE_SIZE", d.cache_size))
    d.batch_rows = int(conf.get("GUBER_BATCH_ROWS", d.batch_rows))
    d.cache_autogrow_max = int(conf.get("GUBER_CACHE_AUTOGROW_MAX",
                                        d.cache_autogrow_max))
    d.engine = conf.get("GUBER_ENGINE", d.engine)
    d.device = conf.get("GUBER_DEVICE", d.device)
    d.log_level = conf.get("GUBER_LOG_LEVEL", d.log_level)
    return d
