"""TLS certificate management (self-signed CA + per-service certs).

Reference parity (agent-core/src/tls.rs:52-80+): generates a self-signed CA
and CA-signed server certificates. The reference uses rcgen in-process; here
openssl does the work. As in the reference, servers currently start without
TLS (main.rs:794-798) — this is the scaffolding used by cert rotation and
the proactive generator's expiry checks.
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional

from .proactive import cert_expiry_days  # re-exported for convenience

__all__ = ["TlsManager", "cert_expiry_days"]


def _openssl(*argv: str) -> None:
    proc = subprocess.run(
        ["openssl", *argv], capture_output=True, text=True, timeout=60
    )
    if proc.returncode != 0:
        raise RuntimeError(f"openssl {argv[0]} failed: {proc.stderr[:300]}")


class TlsManager:
    def __init__(self, cert_dir: str = "/tmp/aios/certs"):
        self.cert_dir = Path(cert_dir)
        self.cert_dir.mkdir(parents=True, exist_ok=True)

    @property
    def ca_cert(self) -> Path:
        return self.cert_dir / "ca.crt"

    @property
    def ca_key(self) -> Path:
        return self.cert_dir / "ca.key"

    def ensure_ca(self, days: int = 3650) -> Path:
        if self.ca_cert.exists():
            return self.ca_cert
        _openssl(
            "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(self.ca_key), "-out", str(self.ca_cert),
            "-days", str(days), "-subj", "/CN=aiOS-CA",
        )
        return self.ca_cert

    def server_cert(self, name: str, days: int = 365) -> tuple[Path, Path]:
        """CA-signed server cert for a service; returns (cert, key)."""
        self.ensure_ca()
        key = self.cert_dir / f"{name}.key"
        csr = self.cert_dir / f"{name}.csr"
        crt = self.cert_dir / f"{name}.crt"
        _openssl(
            "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(key), "-out", str(csr),
            "-subj", f"/CN={name}.aios.local",
        )
        _openssl(
            "x509", "-req", "-in", str(csr),
            "-CA", str(self.ca_cert), "-CAkey", str(self.ca_key),
            "-CAcreateserial", "-out", str(crt), "-days", str(days),
        )
        csr.unlink(missing_ok=True)
        return crt, key

    def rotate(self, name: str) -> tuple[Path, Path]:
        for suffix in (".crt", ".key"):
            (self.cert_dir / f"{name}{suffix}").unlink(missing_ok=True)
        return self.server_cert(name)

    def expiry_days(self, name: str) -> Optional[int]:
        return cert_expiry_days(str(self.cert_dir / f"{name}.crt"))
