"""net.* / firewall.* / web.* / email.* — network tools.

Reference: tools/src/{net,firewall(+firewall_apply.rs nftables),web,email}/
(14 handlers). Zero-egress hosts degrade with clear errors on the paths that
need the internet; local operations (interfaces, port scan on localhost,
webhooks to localhost services) work everywhere.
"""

from __future__ import annotations

import json
import smtplib
import socket
import subprocess
import time
from email.message import EmailMessage

import psutil

from . import ToolError, ToolSpec, run_cmd

# ---------------------------------------------------------------------------
# net.*
# ---------------------------------------------------------------------------


def net_interfaces(args: dict) -> dict:
    out = []
    stats = psutil.net_if_stats()
    for name, addrs in psutil.net_if_addrs().items():
        st = stats.get(name)
        out.append(
            {
                "name": name,
                "up": bool(st.isup) if st else False,
                "mtu": st.mtu if st else 0,
                "addresses": [
                    {"family": str(a.family.name), "address": a.address}
                    for a in addrs
                ],
            }
        )
    return {"interfaces": out}


def net_ping(args: dict) -> dict:
    host = args.get("host", "8.8.8.8")
    count = min(int(args.get("count", 3)), 10)
    try:
        out = run_cmd(["ping", "-c", str(count), "-W", "2", host], timeout=30)
        return {"host": host, "output": out["stdout"].splitlines()[-2:],
                "reachable": True}
    except ToolError:
        # fall back to a TCP connect probe (ping may be missing/unprivileged)
        t0 = time.time()
        try:
            with socket.create_connection((host, 53), timeout=3):
                pass
            return {"host": host, "reachable": True,
                    "rtt_ms": round((time.time() - t0) * 1000, 1),
                    "method": "tcp-connect"}
        except OSError:
            return {"host": host, "reachable": False, "method": "tcp-connect"}


def net_dns(args: dict) -> dict:
    host = args.get("host") or args.get("hostname")
    if not host:
        raise ToolError("missing host")
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror as exc:
        raise ToolError(f"DNS resolution failed for {host}: {exc}") from exc
    addrs = sorted({i[4][0] for i in infos})
    return {"host": host, "addresses": addrs}


def net_http_get(args: dict) -> dict:
    url = args.get("url")
    if not url:
        raise ToolError("missing url")
    import urllib.request

    req = urllib.request.Request(url, headers={"User-Agent": "aios-tpu/0.1"})
    try:
        with urllib.request.urlopen(req, timeout=float(args.get("timeout", 15))) as resp:
            body = resp.read(256 * 1024)
            return {
                "url": url,
                "status": resp.status,
                "headers": dict(list(resp.headers.items())[:20]),
                "body": body.decode("utf-8", "replace"),
            }
    except OSError as exc:
        raise ToolError(f"GET {url} failed: {exc}") from exc


def net_port_scan(args: dict) -> dict:
    host = args.get("host", "127.0.0.1")
    ports = args.get("ports") or [22, 80, 443, 9090, 50051, 50052, 50053, 50054, 50055]
    open_ports = []
    for port in list(ports)[:1024]:
        try:
            with socket.create_connection((host, int(port)), timeout=0.5):
                open_ports.append(int(port))
        except OSError:
            continue
    return {"host": host, "open_ports": open_ports, "scanned": len(ports)}


# ---------------------------------------------------------------------------
# firewall.* — nftables wrappers (reference: firewall_apply.rs)
# ---------------------------------------------------------------------------


def firewall_rules(args: dict) -> dict:
    out = run_cmd(["nft", "list", "ruleset"], timeout=15)
    return {"ruleset": out["stdout"].splitlines()[:500]}


def firewall_add_rule(args: dict) -> dict:
    rule = args.get("rule")
    if not rule:
        raise ToolError("missing rule (nft syntax, e.g. 'add rule inet aios input tcp dport 22 accept')")
    run_cmd(["nft", *str(rule).split()], timeout=15)
    return {"added": rule}


def firewall_delete_rule(args: dict) -> dict:
    handle = args.get("handle")
    chain = args.get("chain", "input")
    table = args.get("table", "aios")
    if handle is None:
        raise ToolError("missing rule handle")
    run_cmd(
        ["nft", "delete", "rule", "inet", table, chain, "handle", str(handle)],
        timeout=15,
    )
    return {"deleted_handle": handle}


# ---------------------------------------------------------------------------
# web.*
# ---------------------------------------------------------------------------


def web_http_request(args: dict) -> dict:
    import urllib.request

    url = args.get("url")
    if not url:
        raise ToolError("missing url")
    method = args.get("method", "GET").upper()
    body = args.get("body", "")
    headers = {"User-Agent": "aios-tpu/0.1", **(args.get("headers") or {})}
    req = urllib.request.Request(
        url, data=body.encode() if body else None, headers=headers, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=float(args.get("timeout", 20))) as resp:
            return {
                "status": resp.status,
                "body": resp.read(256 * 1024).decode("utf-8", "replace"),
            }
    except OSError as exc:
        raise ToolError(f"{method} {url} failed: {exc}") from exc


def web_scrape(args: dict) -> dict:
    got = web_http_request({**args, "method": "GET"})
    import re

    text = re.sub(r"<script.*?</script>|<style.*?</style>", " ", got["body"],
                  flags=re.S | re.I)
    text = re.sub(r"<[^>]+>", " ", text)
    text = re.sub(r"\s+", " ", text).strip()
    links = re.findall(r'href=["\'](https?://[^"\']+)', got["body"])[:50]
    return {"url": args.get("url"), "text": text[:20_000], "links": links}


def web_webhook(args: dict) -> dict:
    payload = json.dumps(args.get("payload") or {})
    return web_http_request(
        {
            "url": args.get("url"),
            "method": "POST",
            "body": payload,
            "headers": {"Content-Type": "application/json"},
            "timeout": args.get("timeout", 15),
        }
    )


def web_download(args: dict) -> dict:
    import urllib.request

    url, dest = args.get("url"), args.get("dest")
    if not url or not dest:
        raise ToolError("missing url or dest")
    try:
        urllib.request.urlretrieve(url, dest)  # noqa: S310
    except OSError as exc:
        raise ToolError(f"download {url} failed: {exc}") from exc
    import os

    return {"url": url, "dest": dest, "bytes": os.path.getsize(dest)}


def web_api_call(args: dict) -> dict:
    out = web_http_request(args)
    try:
        out["json"] = json.loads(out["body"])
    except ValueError:
        pass
    return out


# ---------------------------------------------------------------------------
# email.send
# ---------------------------------------------------------------------------


def email_send(args: dict) -> dict:
    to = args.get("to")
    subject = args.get("subject", "")
    body = args.get("body", "")
    if not to:
        raise ToolError("missing 'to'")
    host = args.get("smtp_host", "127.0.0.1")
    port = int(args.get("smtp_port", 25))
    msg = EmailMessage()
    msg["From"] = args.get("from", "aios@localhost")
    msg["To"] = to
    msg["Subject"] = subject
    msg.set_content(body)
    try:
        with smtplib.SMTP(host, port, timeout=10) as smtp:
            smtp.send_message(msg)
    except OSError as exc:
        raise ToolError(f"SMTP {host}:{port} failed: {exc}") from exc
    return {"to": to, "subject": subject, "relay": f"{host}:{port}"}


TOOLS = {
    "net.interfaces": ToolSpec(net_interfaces, "List network interfaces",
                               idempotent=True),
    "net.ping": ToolSpec(net_ping, "Ping / TCP-probe a host", idempotent=True),
    "net.dns": ToolSpec(net_dns, "Resolve a hostname", idempotent=True),
    "net.http_get": ToolSpec(net_http_get, "HTTP GET a url", idempotent=True),
    "net.port_scan": ToolSpec(net_port_scan, "TCP connect scan",
                              idempotent=True),
    "firewall.rules": ToolSpec(firewall_rules, "List nftables ruleset",
                               idempotent=True),
    "firewall.add_rule": ToolSpec(firewall_add_rule, "Add an nft rule",
                                  requires_confirmation=True),
    "firewall.delete_rule": ToolSpec(firewall_delete_rule,
                                     "Delete an nft rule by handle",
                                     requires_confirmation=True),
    "web.http_request": ToolSpec(web_http_request, "Arbitrary HTTP request"),
    "web.scrape": ToolSpec(web_scrape, "Fetch a page and extract text/links",
                           idempotent=True),
    "web.webhook": ToolSpec(web_webhook, "POST a JSON payload to a webhook"),
    "web.download": ToolSpec(web_download, "Download a url to a file"),
    "web.api_call": ToolSpec(web_api_call, "HTTP call with JSON parsing"),
    "email.send": ToolSpec(email_send, "Send an email via SMTP relay"),
}
