"""TLS: certificates from files or a self-signed set made in memory (the
port of gubernator_tpu/tlsutil.py; tls.go › SetupTLS / TLSConfig).

``setup_tls`` turns the daemon's ``TLSSettings`` into a ``TLSContext``
whose credentials the gRPC listeners, the shared client port, the peer
clients and the HTTP listener use.  AutoTLS makes a throwaway CA and a
server certificate (SAN: localhost, 127.0.0.1, the host name) with
``cryptography``, imported only there.  With client auth on, a peer
dials with its own daemon certificate, as AutoTLS deployments of the
reference do.

A setting the port cannot honor raises (``check_tls_settings``), where
the JAX package ignores it: GUBER_TLS_INSECURE_SKIP_VERIFY (gRPC's
Python channels cannot skip verification), client auth ``request`` (a
gRPC server either requires a client certificate or asks for none) or
an unknown mode, a certificate without its key or a key without its
certificate, and a CA file with neither a certificate nor AutoTLS.
``require-any`` is served as ``verify``: the client certificate is
required and checked against the CA (JAX's reading of both modes).
"""
from __future__ import annotations

import datetime
import os
import ssl
import tempfile
from dataclasses import dataclass
from typing import Optional

from .config import TLSSettings

#: client-auth modes that require a client certificate
_REQUIRE = ("require-any", "verify")


def check_tls_settings(s: TLSSettings) -> None:
    """Raise ValueError for a setting the port cannot honor."""
    if s.insecure_skip_verify:
        raise ValueError(
            "GUBER_TLS_INSECURE_SKIP_VERIFY cannot be honored: gRPC's "
            "Python channels always verify the server certificate; give "
            "the peers the CA instead (GUBER_TLS_CA)")
    if s.client_auth not in ("none",) + _REQUIRE:
        raise ValueError(
            f"GUBER_TLS_CLIENT_AUTH={s.client_auth!r} cannot be honored "
            "(want none, require-any or verify: a gRPC server either "
            "requires a client certificate or asks for none)")
    if s.cert_file and not s.key_file:
        raise ValueError("GUBER_TLS_CERT is set without GUBER_TLS_KEY")
    if s.key_file and not s.cert_file:
        raise ValueError("GUBER_TLS_KEY is set without GUBER_TLS_CERT")
    if not s.cert_file and not s.auto_tls:
        raise ValueError("GUBER_TLS_CA alone serves nothing: set "
                         "GUBER_TLS_CERT and GUBER_TLS_KEY, or "
                         "GUBER_TLS_AUTO")


@dataclass
class TLSContext:
    """The PEMs the gRPC and HTTP listeners and the peer clients share."""

    settings: TLSSettings
    ca_pem: bytes = b""
    cert_pem: bytes = b""
    key_pem: bytes = b""
    client_ca_pem: bytes = b""

    def grpc_server_credentials(self):
        import grpc

        require = self.settings.client_auth in _REQUIRE
        root = self.client_ca_pem or self.ca_pem
        return grpc.ssl_server_credentials(
            [(self.key_pem, self.cert_pem)],
            root_certificates=root if require else None,
            require_client_auth=require)

    def grpc_client_credentials(self):
        """The credentials peers and clients dial a TLS daemon with; with
        client auth on, the daemon's certificate is the client's."""
        import grpc

        require = self.settings.client_auth in _REQUIRE
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca_pem or None,
            private_key=self.key_pem if require else None,
            certificate_chain=self.cert_pem if require else None)

    def http_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # load_cert_chain reads files: the PEMs are staged in a private
        # temporary directory, removed as soon as they are loaded
        with tempfile.TemporaryDirectory(prefix="gubtls-") as d:
            cert, key = os.path.join(d, "c.pem"), os.path.join(d, "k.pem")
            with open(cert, "wb") as f:
                f.write(self.cert_pem)
            with open(key, "wb") as f:
                os.fchmod(f.fileno(), 0o600)
                f.write(self.key_pem)
            ctx.load_cert_chain(cert, key)
            if self.settings.client_auth in _REQUIRE:
                ctx.verify_mode = ssl.CERT_REQUIRED
                ca = os.path.join(d, "ca.pem")
                with open(ca, "wb") as f:
                    f.write(self.client_ca_pem or self.ca_pem)
                ctx.load_verify_locations(ca)
        return ctx


def setup_tls(settings: Optional[TLSSettings]) -> Optional[TLSContext]:
    """reference: tls.go › SetupTLS.  None without settings; raises for
    a setting the port cannot honor."""
    if settings is None:
        return None
    check_tls_settings(settings)
    ctx = TLSContext(settings=settings)
    if settings.auto_tls and not settings.cert_file:
        _generate_auto_tls(ctx)
    else:
        with open(settings.cert_file, "rb") as f:
            ctx.cert_pem = f.read()
        with open(settings.key_file, "rb") as f:
            ctx.key_pem = f.read()
        if settings.ca_file:
            with open(settings.ca_file, "rb") as f:
                ctx.ca_pem = f.read()
    if settings.client_auth_ca_file:
        with open(settings.client_auth_ca_file, "rb") as f:
            ctx.client_ca_pem = f.read()
    return ctx


def _generate_auto_tls(ctx: TLSContext) -> None:
    """A self-signed CA and a server certificate it signs (tls.go's
    AutoTLS)."""
    import ipaddress
    import socket

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    def make_key():
        return ec.generate_private_key(ec.SECP256R1())

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = make_key()
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                            "gubernator-tpu-auto-ca")])
    ca_cert = (x509.CertificateBuilder()
               .subject_name(ca_name).issuer_name(ca_name)
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(days=365))
               .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    key = make_key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "gubernator-tpu")])
    san = x509.SubjectAlternativeName([
        x509.DNSName("localhost"),
        x509.DNSName(socket.gethostname()),
        x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
    ])
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(ca_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(san, critical=False)
            .sign(ca_key, hashes.SHA256()))
    pem = serialization.Encoding.PEM
    ctx.ca_pem = ca_cert.public_bytes(pem)
    ctx.cert_pem = cert.public_bytes(pem) + ctx.ca_pem
    ctx.key_pem = key.private_bytes(
        pem, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
