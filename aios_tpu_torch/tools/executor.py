"""The tool execution pipeline.

Reference parity (tools/src/executor.rs:503-633): every Execute runs
  validate -> capability check -> rate limit -> backup-if-reversible ->
  handler -> audit
with the hash-chained ledger recording success and failure alike. The
executor also owns the dynamic side of the registry: plugin-backed tools
(auto-registered on plugin.create, main.rs:171-174) and externally
Register()-ed tool definitions.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .audit import AuditLog
from .backup import BackupManager
from .capabilities import CapabilityChecker, requirements_for
from .handlers import ToolError, ToolSpec, collect_all
from .plugins import PluginManager
from .ratelimit import RateLimiter
from .secrets import SecretManager


@dataclass
class ExecutionResult:
    success: bool
    output: Dict[str, Any]
    error: str = ""
    execution_id: str = ""
    duration_ms: int = 0
    backup_id: str = ""


class ToolExecutor:
    def __init__(
        self,
        audit_path: str = ":memory:",
        backup_dir: str = "/tmp/aios/backups",
        plugin_dir: str = "/tmp/aios/plugins",
        secrets_path: str = "/etc/aios/secrets.toml",
    ):
        self.registry: Dict[str, ToolSpec] = collect_all()
        self.capabilities = CapabilityChecker()
        self.rate_limiter = RateLimiter()
        self.audit = AuditLog(audit_path)
        self.backups = BackupManager(backup_dir)
        self.plugins = PluginManager(plugin_dir)
        self.secrets = SecretManager(secrets_path)
        self.external_tools: Dict[str, dict] = {}  # Register()-ed definitions
        self._lock = threading.Lock()
        self._wire_context_tools()
        self._register_plugin_namespace()
        self.rescan_plugins()

    # -- context-dependent handlers ----------------------------------------

    def _wire_context_tools(self) -> None:
        """Replace placeholder handlers that need executor state."""

        def sec_grant(args: dict) -> dict:
            agent, caps = args.get("agent_id"), args.get("capabilities", [])
            if not agent or not caps:
                raise ToolError("need agent_id and capabilities")
            self.capabilities.grant(agent, caps)
            return {"agent_id": agent, "granted": caps}

        def sec_revoke(args: dict) -> dict:
            agent = args.get("agent_id")
            if not agent:
                raise ToolError("need agent_id")
            self.capabilities.revoke(
                agent, args.get("capabilities", []), all_=args.get("all", False)
            )
            return {"agent_id": agent, "revoked": args.get("capabilities", [])}

        def sec_audit(args: dict) -> dict:
            ok, bad_seq = self.audit.verify_chain()
            return {"chain_valid": ok, "first_bad_seq": bad_seq,
                    "records": self.audit.count()}

        def sec_audit_query(args: dict) -> dict:
            return {
                "records": self.audit.query(
                    agent_id=args.get("agent_id", ""),
                    tool_name=args.get("tool_name", ""),
                    limit=int(args.get("limit", 100)),
                )
            }

        self.registry["sec.grant"] = ToolSpec(
            sec_grant, "Grant capabilities to an agent")
        self.registry["sec.revoke"] = ToolSpec(
            sec_revoke, "Revoke capabilities from an agent")
        self.registry["sec.audit"] = ToolSpec(
            sec_audit, "Verify the audit hash chain", idempotent=True)
        self.registry["sec.audit_query"] = ToolSpec(
            sec_audit_query, "Query the audit ledger", idempotent=True)

    def _register_plugin_namespace(self) -> None:
        pm = self.plugins

        def plugin_create(args: dict) -> dict:
            meta = pm.create(
                name=args.get("name", ""),
                code=args.get("code", ""),
                description=args.get("description", ""),
                capabilities=args.get("capabilities"),
                requirements=args.get("requirements"),
                next_plugins=args.get("next_plugins"),
                output_mode=args.get("output_mode", "pipe"),
            )
            self.rescan_plugins()  # auto-register (main.rs:171-174)
            return {"created": meta["name"], "registered_tool": f"plugin.x.{meta['name']}"}

        def plugin_from_template(args: dict) -> dict:
            meta = pm.from_template(args.get("name", ""), args.get("template", ""))
            self.rescan_plugins()
            return {"created": meta["name"]}

        def plugin_list(args: dict) -> dict:
            return {"plugins": pm.list()}

        def plugin_delete(args: dict) -> dict:
            name = args.get("name", "")
            removed = pm.delete(name)
            self.registry.pop(f"plugin.x.{name}", None)
            return {"deleted": removed}

        def plugin_install_deps(args: dict) -> dict:
            return pm.install_deps(args.get("name", ""))

        self.registry["plugin.create"] = ToolSpec(
            plugin_create, "Create (and register) a Python plugin")
        self.registry["plugin.from_template"] = ToolSpec(
            plugin_from_template, "Create a plugin from a template")
        self.registry["plugin.list"] = ToolSpec(
            plugin_list, "List installed plugins", idempotent=True)
        self.registry["plugin.delete"] = ToolSpec(
            plugin_delete, "Delete a plugin")
        self.registry["plugin.install_deps"] = ToolSpec(
            plugin_install_deps, "pip-install a plugin's requirements")

    def rescan_plugins(self) -> int:
        """(Re)register every stored plugin as tool `plugin.x.<name>`."""
        count = 0
        for meta in self.plugins.list():
            name = meta["name"]

            def run_plugin(args: dict, _name=name) -> dict:
                return self.plugins.execute(_name, args)

            self.registry[f"plugin.x.{name}"] = ToolSpec(
                run_plugin, meta.get("description") or f"plugin {name}"
            )
            count += 1
        return count

    # -- pipeline -----------------------------------------------------------

    def execute(
        self,
        agent_id: str,
        tool_name: str,
        input_json: bytes,
        task_id: str = "",
        reason: str = "",
    ) -> ExecutionResult:
        t0 = time.time()
        execution_id = str(uuid.uuid4())

        def fail(error: str) -> ExecutionResult:
            self.audit.record(agent_id, tool_name, input_json, b"", False, error)
            return ExecutionResult(
                success=False,
                output={},
                error=error,
                execution_id=execution_id,
                duration_ms=int((time.time() - t0) * 1000),
            )

        # 1. validate
        spec = self.registry.get(tool_name)
        if spec is None:
            return fail(f"unknown tool {tool_name}")
        try:
            args = json.loads(input_json.decode("utf-8")) if input_json else {}
            if not isinstance(args, dict):
                raise ValueError("input must be a JSON object")
        except ValueError as exc:
            return fail(f"invalid input JSON: {exc}")

        # 2. capability check
        ok, why = self.capabilities.check(agent_id, tool_name)
        if not ok:
            return fail(why)

        # 3. rate limit
        ok, why = self.rate_limiter.check(agent_id, tool_name)
        if not ok:
            return fail(why)

        # 4. backup if reversible
        backup_id = ""
        if spec.reversible and spec.target_arg and args.get(spec.target_arg):
            try:
                self.backups.backup_path_for(
                    execution_id, str(args[spec.target_arg])
                )
                backup_id = execution_id
            except OSError as exc:
                return fail(f"backup failed: {exc}")

        # 5. execute
        try:
            output = spec.fn(args)
            success, error = True, ""
        except ToolError as exc:
            output, success, error = {}, False, str(exc)
        except Exception as exc:  # noqa: BLE001 — handler bug, not a crash
            output, success, error = {}, False, f"handler error: {exc!r}"

        # 6. audit
        out_bytes = json.dumps(output).encode()
        self.audit.record(agent_id, tool_name, input_json, out_bytes, success, reason)

        return ExecutionResult(
            success=success,
            output=output,
            error=error,
            execution_id=execution_id,
            duration_ms=int((time.time() - t0) * 1000),
            backup_id=backup_id,
        )

    def rollback(self, execution_id: str, reason: str = "") -> tuple[bool, str]:
        ok, msg = self.backups.rollback(execution_id)
        self.audit.record("rollback", "rollback", execution_id.encode(),
                          msg.encode(), ok, reason)
        return ok, msg

    # -- definitions --------------------------------------------------------

    def definition(self, tool_name: str) -> Optional[dict]:
        spec = self.registry.get(tool_name)
        if spec is None:
            return self.external_tools.get(tool_name)
        caps, risk = requirements_for(tool_name)
        namespace = tool_name.split(".", 1)[0]
        return {
            "name": tool_name,
            "namespace": namespace,
            "version": spec.version,
            "description": spec.description,
            "required_capabilities": caps,
            "risk_level": risk,
            "requires_confirmation": spec.requires_confirmation,
            "idempotent": spec.idempotent,
            "reversible": spec.reversible,
            "timeout_ms": spec.timeout_ms,
            "rollback_tool": "rollback" if spec.reversible else "",
        }

    def list_definitions(self, namespace: str = "") -> list[dict]:
        names = sorted(self.registry) + sorted(self.external_tools)
        defs = [self.definition(n) for n in names]
        if namespace:
            defs = [d for d in defs if d and d["namespace"] == namespace]
        return [d for d in defs if d]

    def register_external(self, definition: dict, handler_address: str) -> None:
        definition = dict(definition)
        definition["handler_address"] = handler_address
        with self._lock:
            self.external_tools[definition["name"]] = definition

    def deregister(self, tool_name: str) -> bool:
        with self._lock:
            if tool_name in self.external_tools:
                del self.external_tools[tool_name]
                return True
        if tool_name.startswith("plugin.x."):
            return self.registry.pop(tool_name, None) is not None
        return False
