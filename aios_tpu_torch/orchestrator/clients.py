"""Lazy gRPC clients to the four services + discovery + health probing.

Reference parity:
  * ServiceClients (agent-core/src/clients.rs): lazily-connected channel per
    service with env-overridable addresses (clients.rs:37-44), 3-attempt
    connect retry then lazy reconnect (73-97), optional discovery resolution
    behind AIOS_USE_DISCOVERY (57-70);
  * ServiceRegistry (agent-core/src/discovery.rs): static-default registry
    with heartbeat expiry (discovery.rs:58-82);
  * HealthChecker (agent-core/src/health.rs): TCP-connect prober on a 10 s
    interval with consecutive-failure counting (health.rs:33-96).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import rpc
from ..services import (
    AIRuntimeStub,
    ApiGatewayStub,
    MemoryServiceStub,
    ToolRegistryStub,
    service_address,
)


class ServiceClients:
    """One lazily-created stub per service; channels cached and reset on
    failure by callers."""

    def __init__(
        self,
        runtime_addr: Optional[str] = None,
        tools_addr: Optional[str] = None,
        memory_addr: Optional[str] = None,
        gateway_addr: Optional[str] = None,
    ):
        self.addresses = {
            "runtime": runtime_addr or service_address("runtime"),
            "tools": tools_addr or service_address("tools"),
            "memory": memory_addr or service_address("memory"),
            "gateway": gateway_addr or service_address("gateway"),
        }
        self._stubs: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _stub(self, name: str, cls):
        with self._lock:
            stub = self._stubs.get(name)
            if stub is None:
                stub = cls(rpc.insecure_channel(self.addresses[name]))
                self._stubs[name] = stub
            return stub

    def reset(self, name: str) -> None:
        with self._lock:
            self._stubs.pop(name, None)

    @property
    def runtime(self) -> AIRuntimeStub:  # type: ignore[valid-type]
        return self._stub("runtime", AIRuntimeStub)

    @property
    def tools(self) -> ToolRegistryStub:  # type: ignore[valid-type]
        return self._stub("tools", ToolRegistryStub)

    @property
    def memory(self) -> MemoryServiceStub:  # type: ignore[valid-type]
        return self._stub("memory", MemoryServiceStub)

    @property
    def gateway(self) -> ApiGatewayStub:  # type: ignore[valid-type]
        return self._stub("gateway", ApiGatewayStub)


@dataclass
class ServiceEntry:
    name: str
    address: str
    port: int
    protocol: str = "grpc"
    status: str = "unknown"
    registered_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.monotonic)


class ServiceRegistry:
    """Static-default discovery registry with heartbeat expiry."""

    HEARTBEAT_EXPIRY = 60.0

    def __init__(self):
        self._services: Dict[str, ServiceEntry] = {}
        self._lock = threading.Lock()
        for name in ("orchestrator", "tools", "memory", "gateway", "runtime"):
            host, port = service_address(name).rsplit(":", 1)
            self.register(ServiceEntry(name=name, address=host, port=int(port)))

    def register(self, entry: ServiceEntry) -> None:
        with self._lock:
            self._services[entry.name] = entry

    def heartbeat(self, name: str) -> bool:
        with self._lock:
            e = self._services.get(name)
            if e is None:
                return False
            e.last_heartbeat = time.monotonic()
            return True

    def resolve(self, name: str) -> Optional[str]:
        with self._lock:
            e = self._services.get(name)
        if e is None:
            return None
        return f"{e.address}:{e.port}"

    def live_services(self) -> List[ServiceEntry]:
        with self._lock:
            return [
                e
                for e in self._services.values()
                if time.monotonic() - e.last_heartbeat < self.HEARTBEAT_EXPIRY
            ]


class HealthChecker:
    """TCP-connect prober with consecutive-failure counters."""

    def __init__(self, interval: float = 10.0,
                 on_failure: Optional[Callable[[str, int], None]] = None):
        self.interval = interval
        self.on_failure = on_failure
        self.targets: Dict[str, str] = {
            name: service_address(name)
            for name in ("runtime", "tools", "memory", "gateway")
        }
        self.consecutive_failures: Dict[str, int] = {}
        self.status: Dict[str, bool] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def failure_snapshot(self) -> Dict[str, int]:
        """Locked copy of the consecutive-failure counters — the health
        thread mutates the dict under the lock, so readers (proactive
        feed, console health panel) must not iterate it bare."""
        with self._lock:
            return dict(self.consecutive_failures)

    def probe(self, address: str, timeout: float = 2.0) -> bool:
        host, port = address.rsplit(":", 1)
        try:
            with socket.create_connection((host, int(port)), timeout=timeout):
                return True
        except OSError:
            return False

    def check_all(self) -> Dict[str, bool]:
        results = {}
        for name, addr in self.targets.items():
            healthy = self.probe(addr)
            results[name] = healthy
            with self._lock:
                self.status[name] = healthy
                if healthy:
                    self.consecutive_failures[name] = 0
                else:
                    n = self.consecutive_failures.get(name, 0) + 1
                    self.consecutive_failures[name] = n
                    if self.on_failure is not None:
                        self.on_failure(name, n)
        return results

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.check_all()
                except Exception:  # noqa: BLE001
                    pass

        self._thread = threading.Thread(target=loop, name="health-checker",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
