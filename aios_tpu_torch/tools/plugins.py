"""Self-evolution: AI-authored Python plugins.

Reference parity (tools/src/plugin/, SURVEY.md row 3i): `plugin.create`
accepts {name, description, code (must define `main(input_data) -> dict`),
capabilities, requirements, next_plugins, output_mode}; plugins are stored in
the plugin dir with a `.meta.json` sidecar, auto-registered as callable tools
on create, executed inside the sandbox (network allowed, /tmp writable,
main.rs:129-167), and chainable via pipe (output feeds the next plugin's
input) or merge (outputs are merged into one dict) (main.rs:177-244).
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

from .handlers import ToolError
from .sandbox import ResourceLimits, Sandbox

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]{1,48}$")

# stdin JSON -> plugin.main -> stdout JSON, run inside the sandbox
_RUNNER = """\
import json, sys, importlib.util
spec = importlib.util.spec_from_file_location("aios_plugin", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
payload = json.loads(sys.stdin.read() or "{}")
result = mod.main(payload)
if not isinstance(result, dict):
    result = {"result": result}
print(json.dumps(result))
"""

TEMPLATES = {
    "basic": (
        "def main(input_data):\n"
        "    return {'echo': input_data}\n"
    ),
    "http_check": (
        "import urllib.request\n\n"
        "def main(input_data):\n"
        "    url = input_data.get('url', 'http://127.0.0.1:9090/api/health')\n"
        "    try:\n"
        "        with urllib.request.urlopen(url, timeout=5) as r:\n"
        "            return {'status': r.status, 'ok': r.status == 200}\n"
        "    except OSError as e:\n"
        "        return {'ok': False, 'error': str(e)}\n"
    ),
    "file_summary": (
        "def main(input_data):\n"
        "    path = input_data['path']\n"
        "    text = open(path, errors='replace').read()\n"
        "    lines = text.splitlines()\n"
        "    return {'path': path, 'lines': len(lines), 'chars': len(text)}\n"
    ),
}


class PluginManager:
    def __init__(self, plugin_dir: str = "/tmp/aios/plugins"):
        self.plugin_dir = Path(plugin_dir)
        self.plugin_dir.mkdir(parents=True, exist_ok=True)
        self._runner = self.plugin_dir / "_runner.py"
        self._runner.write_text(_RUNNER)
        self.sandbox = Sandbox(
            limits=ResourceLimits(wall_timeout=30.0),
            writable_paths=["/tmp"],
            allow_network=True,
        )

    # -- lifecycle ----------------------------------------------------------

    def validate(self, name: str, code: str) -> None:
        if not _NAME_RE.match(name):
            raise ToolError(
                f"invalid plugin name {name!r} (lowercase, digits, underscore)"
            )
        if "def main(" not in code:
            raise ToolError("plugin code must define main(input_data) -> dict")
        try:
            compile(code, f"<plugin:{name}>", "exec")
        except SyntaxError as exc:
            raise ToolError(f"plugin syntax error: {exc}") from exc

    def create(
        self,
        name: str,
        code: str,
        description: str = "",
        capabilities: Optional[List[str]] = None,
        requirements: Optional[List[str]] = None,
        next_plugins: Optional[List[str]] = None,
        output_mode: str = "pipe",
    ) -> Dict[str, Any]:
        self.validate(name, code)
        if output_mode not in ("pipe", "merge"):
            raise ToolError(f"output_mode must be pipe|merge, got {output_mode}")
        (self.plugin_dir / f"{name}.py").write_text(code)
        meta = {
            "name": name,
            "description": description,
            "capabilities": capabilities or [],
            "requirements": requirements or [],
            "next_plugins": next_plugins or [],
            "output_mode": output_mode,
        }
        (self.plugin_dir / f"{name}.meta.json").write_text(json.dumps(meta))
        return meta

    def from_template(self, name: str, template: str, **kw) -> Dict[str, Any]:
        code = TEMPLATES.get(template)
        if code is None:
            raise ToolError(f"unknown template {template}; have {list(TEMPLATES)}")
        return self.create(name, code, description=f"from template {template}", **kw)

    def delete(self, name: str) -> bool:
        removed = False
        for suffix in (".py", ".meta.json"):
            p = self.plugin_dir / f"{name}{suffix}"
            if p.exists():
                p.unlink()
                removed = True
        return removed

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for meta_file in sorted(self.plugin_dir.glob("*.meta.json")):
            try:
                out.append(json.loads(meta_file.read_text()))
            except ValueError:
                continue
        return out

    def get_meta(self, name: str) -> Optional[Dict[str, Any]]:
        p = self.plugin_dir / f"{name}.meta.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def install_deps(self, name: str) -> Dict[str, Any]:
        meta = self.get_meta(name)
        if meta is None:
            raise ToolError(f"plugin {name} not found")
        reqs = meta.get("requirements", [])
        if not reqs:
            return {"installed": [], "note": "no requirements"}
        if shutil.which("pip") is None:
            raise ToolError("pip unavailable; cannot install plugin deps")
        import subprocess

        proc = subprocess.run(
            ["pip", "install", "--quiet", *reqs],
            capture_output=True,
            text=True,
            timeout=300,
        )
        if proc.returncode != 0:
            raise ToolError(f"pip install failed: {proc.stderr[-500:]}")
        return {"installed": reqs}

    # -- execution ----------------------------------------------------------

    def execute(
        self, name: str, input_data: Dict[str, Any], _depth: int = 0
    ) -> Dict[str, Any]:
        """Run a plugin in the sandbox; follow its chain (pipe/merge)."""
        if _depth > 5:
            raise ToolError("plugin chain too deep (max 5)")
        path = self.plugin_dir / f"{name}.py"
        if not path.exists():
            raise ToolError(f"plugin {name} not found")
        meta = self.get_meta(name) or {}
        try:
            proc = self.sandbox.run(
                ["python3", str(self._runner), str(path)],
                stdin_data=json.dumps(input_data).encode(),
            )
        except Exception as exc:  # TimeoutExpired etc.
            raise ToolError(f"plugin {name} failed to run: {exc}") from exc
        if proc.returncode != 0:
            raise ToolError(
                f"plugin {name} exited {proc.returncode}: "
                f"{proc.stderr.decode('utf-8', 'replace')[-500:]}"
            )
        try:
            result = json.loads(proc.stdout.decode("utf-8", "replace"))
        except ValueError as exc:
            raise ToolError(f"plugin {name} printed non-JSON output") from exc

        chain = meta.get("next_plugins") or []
        mode = meta.get("output_mode", "pipe")
        for nxt in chain:
            nxt_result = self.execute(nxt, result, _depth=_depth + 1)
            if mode == "merge":
                result = {**result, **nxt_result}
            else:  # pipe
                result = nxt_result
        return result
