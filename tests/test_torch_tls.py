"""TLS in the port (gubernator_tpu_torch/tlsutil.py and its wiring), on
the CPU: GUBER_TLS_* parsing equal to the JAX package's
(tests/test_config.py › test_tls_from_env), the AutoTLS round trip over
gRPC and HTTPS, client auth required (tests/test_daemon.py), two port
daemons forwarding to each other over TLS with file certificates, a
plaintext client refused, and every setting the port cannot honor
raising at startup.  Tolerance: exact answers."""
import json
import ssl
import urllib.request

import pytest

from gubernator_tpu_torch import cluster
from gubernator_tpu_torch.config import (DaemonConfig, TLSSettings,
                                         setup_daemon_config)
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.tlsutil import check_tls_settings, setup_tls

grpc = pytest.importorskip("grpc")


def daemon_cfg(**kw):
    return DaemonConfig(grpc_listen_address="127.0.0.1:0",
                        http_listen_address="127.0.0.1:0",
                        cache_size=1 << 10, device="cpu", **kw)


def check(channel, name, key, limit=3, hits=1, behavior=0):
    stub = channel.unary_unary(
        "/pb.gubernator.V1/GetRateLimits",
        request_serializer=pb.GetRateLimitsReq.SerializeToString,
        response_deserializer=pb.GetRateLimitsResp.FromString)
    req = pb.GetRateLimitsReq()
    r = req.requests.add()
    r.name, r.unique_key, r.hits = name, key, hits
    r.limit, r.duration, r.behavior = limit, 60_000, behavior
    return stub(req, timeout=10).responses[0]


@pytest.mark.parametrize("env", [
    {"GUBER_TLS_AUTO": "true"},
    {"GUBER_TLS_CERT": "/c.pem", "GUBER_TLS_KEY": "/k.pem",
     "GUBER_TLS_CLIENT_AUTH": "verify"},
    {"GUBER_TLS_CA": "/ca.pem", "GUBER_TLS_CERT": "/c.pem",
     "GUBER_TLS_KEY": "/k.pem", "GUBER_TLS_AUTO": "0",
     "GUBER_TLS_CLIENT_AUTH": "require-any",
     "GUBER_TLS_CLIENT_AUTH_CA_CERT": "/cca.pem",
     "GUBER_TLS_INSECURE_SKIP_VERIFY": "yes"},
    {},
])
def test_tls_settings_parse_as_jax(env):
    from dataclasses import asdict

    from gubernator_tpu.config import setup_daemon_config as jax_setup

    got, want = setup_daemon_config(env=env), jax_setup(env=env)
    assert (got.tls is None) == (want.tls is None)
    if got.tls is not None:
        assert asdict(got.tls) == asdict(want.tls)


def test_auto_tls_round_trip_over_grpc_and_https():
    d = spawn_daemon(daemon_cfg(tls=TLSSettings(auto_tls=True)))
    try:
        creds = d.tls.grpc_client_credentials()
        with grpc.secure_channel(f"localhost:{d.grpc_port}", creds) as ch:
            r = check(ch, "tls_test", "k1")
            assert (r.status, r.remaining, r.error) == (0, 2, "")
        ctx = ssl.create_default_context(cadata=d.tls.ca_pem.decode())
        with urllib.request.urlopen(
                f"https://localhost:{d.http_port}/healthz", timeout=10,
                context=ctx) as resp:
            assert json.loads(resp.read())["status"] == "healthy"
    finally:
        d.close()


def test_client_auth_required():
    d = spawn_daemon(daemon_cfg(tls=TLSSettings(auto_tls=True,
                                                client_auth="require-any")))
    try:
        good = d.tls.grpc_client_credentials()  # carries the daemon cert
        with grpc.secure_channel(f"localhost:{d.grpc_port}", good) as ch:
            assert check(ch, "tls_auth", "k1").error == ""
        bad = grpc.ssl_channel_credentials(root_certificates=d.tls.ca_pem)
        with grpc.secure_channel(f"localhost:{d.grpc_port}", bad) as ch:
            with pytest.raises(grpc.RpcError):
                check(ch, "tls_auth", "k2")
    finally:
        d.close()


def test_plaintext_client_is_refused():
    d = spawn_daemon(daemon_cfg(tls=TLSSettings(auto_tls=True)))
    try:
        with grpc.insecure_channel(f"127.0.0.1:{d.grpc_port}") as ch:
            with pytest.raises(grpc.RpcError) as e:
                check(ch, "plain", "k")
            assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{d.http_port}/healthz",
                                   timeout=5)
    finally:
        d.close()


def test_two_daemons_forward_over_tls(tmp_path):
    import chip_smoke

    ca, cert, key, _ = chip_smoke.write_certs(str(tmp_path))
    tls = TLSSettings(ca_file=ca, cert_file=cert, key_file=key)
    c = cluster.start_with([daemon_cfg(tls=tls), daemon_cfg(tls=tls)])
    try:
        d0 = c.daemon_at(0)
        other = c.daemon_at(1).advertise_address
        keys = [f"k{i}" for i in range(64)]
        remote = [k for k in keys
                  if d0.instance.owner_of(f"tlsfwd_{k}").info.grpc_address
                  == other]
        assert remote
        creds = d0.tls.grpc_client_credentials()
        with grpc.secure_channel(f"localhost:{d0.grpc_port}", creds) as ch:
            for hits in (1, 2):
                for k in remote[:8]:
                    r = check(ch, "tlsfwd", k, limit=10, hits=hits)
                    assert r.error == ""
            # GLOBAL rows too: answered here, reconciled over TLS
            g = check(ch, "tlsglob", "g", limit=10, behavior=2)
            assert g.error == ""
            assert [check(ch, "tlsfwd", k, limit=10, hits=0).remaining
                    for k in remote[:8]] == [7] * 8
        inst = d0.instance
        assert inst.forwarded_rows >= 16 and inst.forward_failures == 0
    finally:
        c.stop()


@pytest.mark.parametrize("settings, match", [
    (TLSSettings(auto_tls=True, insecure_skip_verify=True),
     "INSECURE_SKIP_VERIFY"),
    (TLSSettings(auto_tls=True, client_auth="request"), "CLIENT_AUTH"),
    (TLSSettings(auto_tls=True, client_auth="sometimes"), "CLIENT_AUTH"),
    (TLSSettings(cert_file="/c.pem"), "without GUBER_TLS_KEY"),
    (TLSSettings(key_file="/k.pem", auto_tls=True), "without GUBER_TLS_CERT"),
    (TLSSettings(ca_file="/ca.pem"), "alone serves nothing"),
])
def test_settings_the_port_cannot_honor_raise(settings, match):
    with pytest.raises(ValueError, match=match):
        check_tls_settings(settings)
    with pytest.raises(ValueError, match=match):
        setup_tls(settings)
    with pytest.raises(ValueError, match=match):
        spawn_daemon(daemon_cfg(tls=settings))


@pytest.mark.parametrize("env", [
    {"GUBER_TLS_KEY": "/k.pem"},
    {"GUBER_TLS_CLIENT_AUTH": "verify", "GUBER_TLS_AUTO": "false"},
    {"GUBER_TLS_INSECURE_SKIP_VERIFY": "true"},
])
def test_tls_keys_while_tls_is_off_raise(env):
    """JAX drops these and serves in plaintext; the port refuses."""
    from gubernator_tpu.config import setup_daemon_config as jax_setup

    assert jax_setup(env=env).tls is None
    with pytest.raises(ValueError, match="while TLS is off"):
        setup_daemon_config(env=env)


def test_tls_help_entries_and_defaults_equal_jax():
    from dataclasses import asdict

    from gubernator_tpu.config import ENV_REGISTRY
    from gubernator_tpu.config import TLSSettings as JaxTLS

    from gubernator_tpu_torch.config import HELP

    assert asdict(TLSSettings()) == asdict(JaxTLS())
    tls_keys = {k for k in ENV_REGISTRY if k.startswith("GUBER_TLS_")}
    assert tls_keys <= set(HELP)
    assert setup_daemon_config(env={"GUBER_TLS_AUTO": "false"}).tls is None
