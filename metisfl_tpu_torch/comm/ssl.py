"""TLS for the gRPC transport.

The port's copy of the JAX package's ``comm/ssl.py``. One self-signed
certificate pair serves every service of a federation; clients trust its
public certificate as their root. ``generate_self_signed`` needs the
``cryptography`` package, and only when it is called.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class SSLConfig:
    """Federation TLS settings (part of :class:`FederationConfig`)."""

    enabled: bool = False
    cert_path: str = ""       # PEM certificate (server identity + client root)
    key_path: str = ""        # PEM private key (server side only)
    # extra DNS/IP subject-alt-names when DriverSession generates the pair
    hosts: List[str] = field(default_factory=list)


def generate_self_signed(
    out_dir: str,
    common_name: str = "metisfl-tpu",
    hosts: Optional[List[str]] = None,
    days: int = 3650,
) -> Tuple[str, str]:
    """Write ``cert.pem``/``key.pem`` under ``out_dir`` and return the paths.

    The cert covers localhost + loopback by default plus any extra ``hosts``
    so one pair serves a whole localhost federation (and, via the ``hosts``
    list, remote learner machines on a shared filesystem).
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    alt_names: List[x509.GeneralName] = [
        x509.DNSName("localhost"),
        x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
    ]
    for host in hosts or []:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(host)))
        except ValueError:
            alt_names.append(x509.DNSName(host))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(alt_names), critical=False)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )

    os.makedirs(out_dir, exist_ok=True)
    cert_path = os.path.join(out_dir, "cert.pem")
    key_path = os.path.join(out_dir, "key.pem")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))
    os.chmod(key_path, 0o600)
    return cert_path, key_path


def server_credentials(ssl: SSLConfig):
    """gRPC server credentials from an enabled :class:`SSLConfig`."""
    import grpc

    with open(ssl.key_path, "rb") as f:
        key = f.read()
    with open(ssl.cert_path, "rb") as f:
        cert = f.read()
    return grpc.ssl_server_credentials([(key, cert)])


def channel_credentials(ssl: SSLConfig):
    """gRPC channel credentials trusting the federation's public cert."""
    import grpc

    with open(ssl.cert_path, "rb") as f:
        cert = f.read()
    return grpc.ssl_channel_credentials(root_certificates=cert)
