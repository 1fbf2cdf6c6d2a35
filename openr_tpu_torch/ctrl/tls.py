"""mTLS for the ctrl transport (port of `openr_tpu.ctrl.tls`; reference: wangle TLS + peer-name ACL on
the thrift server, openr/Main.cpp:546-612).

Both sides present CA-signed certificates; the server additionally gates
connections on the client certificate's CommonName matching an ACL regex
(the reference's peer-name allowlist).  Hostname verification is
deliberately off on the client — routers connect by link-local/loopback
address, and identity is the certificate name, exactly as in the
reference's deployment model.
"""

from __future__ import annotations

import re
import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass(slots=True)
class TlsConfig:
    cert_path: str
    key_path: str
    ca_path: str
    acl_regex: str = ".*"  # peer-CN allowlist (server side, and clients
    # verify the server's CN against it too — hostname checking is off,
    # so without this any CA-signed cert could impersonate a ctrl server)


def server_context(cfg: TlsConfig) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_path, cfg.key_path)
    ctx.load_verify_locations(cfg.ca_path)
    ctx.verify_mode = ssl.CERT_REQUIRED  # mTLS: clients must present certs
    return ctx


def client_context(cfg: TlsConfig) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cfg.cert_path, cfg.key_path)
    ctx.load_verify_locations(cfg.ca_path)
    ctx.check_hostname = False  # identity = certificate name, not address
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def peer_common_name(ssl_object) -> Optional[str]:
    """CommonName of the peer certificate, or None."""
    cert = ssl_object.getpeercert()
    if not cert:
        return None
    for rdn in cert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                return value
    return None


def check_acl(cfg: TlsConfig, common_name: Optional[str]) -> bool:
    if common_name is None:
        return False
    return re.fullmatch(cfg.acl_regex, common_name) is not None


def verify_peer(cfg: TlsConfig, ssl_object) -> str:
    """Post-handshake peer-identity check for *clients*.

    With check_hostname off, the CA signature alone says nothing about
    *which* node we reached — a CA-signed cert the server-side ACL would
    reject (e.g. a decommissioned or rogue node) could otherwise
    impersonate a ctrl server / KvStore peer.  Mirrors the server's
    check_acl gate in the other direction; returns the verified CN.
    """
    cn = peer_common_name(ssl_object)
    if not check_acl(cfg, cn):
        raise ssl.SSLCertVerificationError(
            f"server certificate CN {cn!r} rejected by ACL {cfg.acl_regex!r}"
        )
    return cn
