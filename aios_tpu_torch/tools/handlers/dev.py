"""git.* / code.* / self.* / container.* — developer & self-management tools.

Reference: tools/src/{git,code,self_update,container}/ (22 handlers).
Containers use podman (falling back to docker) as the reference does;
self.update/rebuild operate on this repo checkout instead of cargo builds.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from . import ToolError, ToolSpec, run_cmd

# ---------------------------------------------------------------------------
# git.*
# ---------------------------------------------------------------------------


def _git(repo: str, *argv: str, timeout: float = 60) -> dict:
    if not repo:
        raise ToolError("missing repo path")
    return run_cmd(["git", "-C", repo, *argv], timeout=timeout)


def git_init(args: dict) -> dict:
    path = args.get("path")
    if not path:
        raise ToolError("missing path")
    Path(path).mkdir(parents=True, exist_ok=True)
    run_cmd(["git", "init", path], timeout=30)
    return {"initialized": path}


def git_clone(args: dict) -> dict:
    url, dest = args.get("url"), args.get("dest")
    if not url or not dest:
        raise ToolError("missing url or dest")
    out = run_cmd(["git", "clone", "--depth", "1", url, dest], timeout=300)
    return {"cloned": url, "dest": dest, "log": out["stderr"][-500:]}


def git_add(args: dict) -> dict:
    _git(args.get("repo", ""), "add", *(args.get("paths") or ["."]))
    return {"added": args.get("paths") or ["."]}


def git_commit(args: dict) -> dict:
    msg = args.get("message", "aios automated commit")
    out = _git(
        args.get("repo", ""),
        "-c", "user.email=aios@localhost", "-c", "user.name=aios",
        "commit", "-m", msg,
    )
    return {"committed": msg, "log": out["stdout"][-500:]}


def git_push(args: dict) -> dict:
    out = _git(args.get("repo", ""), "push", timeout=120)
    return {"pushed": True, "log": out["stderr"][-500:]}


def git_pull(args: dict) -> dict:
    out = _git(args.get("repo", ""), "pull", "--ff-only", timeout=120)
    return {"pulled": True, "log": out["stdout"][-500:]}


def git_branch(args: dict) -> dict:
    name = args.get("name")
    if name:
        _git(args.get("repo", ""), "checkout", "-b", name)
        return {"created": name}
    out = _git(args.get("repo", ""), "branch", "--list")
    return {"branches": [b.strip("* ") for b in out["stdout"].splitlines()]}


def git_status(args: dict) -> dict:
    out = _git(args.get("repo", ""), "status", "--porcelain")
    return {"dirty": bool(out["stdout"].strip()),
            "files": out["stdout"].splitlines()[:100]}


def git_log(args: dict) -> dict:
    out = _git(args.get("repo", ""), "log", "--oneline", "-n",
               str(args.get("limit", 20)))
    return {"log": out["stdout"].splitlines()}


def git_diff(args: dict) -> dict:
    out = _git(args.get("repo", ""), "diff", "--stat")
    return {"diff": out["stdout"][-10_000:]}


# ---------------------------------------------------------------------------
# code.*
# ---------------------------------------------------------------------------

_SCAFFOLDS = {
    "python": {
        "main.py": "def main():\n    print('hello from {name}')\n\n\n"
                   "if __name__ == '__main__':\n    main()\n",
        "README.md": "# {name}\n",
        "requirements.txt": "",
    },
    "web": {
        "index.html": "<!doctype html><title>{name}</title><h1>{name}</h1>\n",
        "style.css": "body {{ font-family: sans-serif; }}\n",
    },
}


def code_scaffold(args: dict) -> dict:
    name = args.get("name", "project")
    kind = args.get("kind", "python")
    dest = Path(args.get("dest", f"/tmp/aios/projects/{name}"))
    template = _SCAFFOLDS.get(kind)
    if template is None:
        raise ToolError(f"unknown scaffold kind {kind}; have {list(_SCAFFOLDS)}")
    dest.mkdir(parents=True, exist_ok=True)
    written = []
    for fname, content in template.items():
        (dest / fname).write_text(content.format(name=name))
        written.append(str(dest / fname))
    return {"project": name, "kind": kind, "files": written}


def code_generate(args: dict) -> dict:
    """AI code generation is routed through the runtime/gateway by the
    executor (this handler is replaced there); standalone it only writes
    provided content."""
    dest = args.get("dest")
    content = args.get("content")
    if not dest or content is None:
        raise ToolError(
            "code.generate without an AI backend needs dest + content"
        )
    p = Path(dest)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(content)
    return {"written": str(p), "bytes": len(content)}


# ---------------------------------------------------------------------------
# self.* — framework self-management (reference: tools/src/self_update/)
# ---------------------------------------------------------------------------


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def self_inspect(args: dict) -> dict:
    root = _repo_root()
    py_files = list(root.glob("aios_tpu_torch/**/*.py"))
    return {
        "root": str(root),
        "python": sys.version.split()[0],
        "modules": len(py_files),
        "loc": sum(len(f.read_text(errors="ignore").splitlines())
                   for f in py_files),
    }


def self_update(args: dict) -> dict:
    out = run_cmd(["git", "-C", str(_repo_root()), "pull", "--ff-only"],
                  timeout=120)
    return {"updated": True, "log": out["stdout"][-500:]}


def self_rebuild(args: dict) -> dict:
    """Regenerate protos + recompile native components."""
    root = _repo_root()
    steps = []
    gen = root / "scripts" / "gen_protos.py"
    if gen.exists():
        run_cmd([sys.executable, str(gen)], timeout=120)
        steps.append("protos")
    native = root / "aios_tpu_torch" / "native" / "build.py"
    if native.exists():
        run_cmd([sys.executable, str(native)], timeout=300)
        steps.append("native")
    return {"rebuilt": steps}


def self_health(args: dict) -> dict:
    import socket

    from ...services import DEFAULT_PORTS

    status = {}
    for name, port in DEFAULT_PORTS.items():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.5):
                status[name] = "up"
        except OSError:
            status[name] = "down"
    return {"services": status}


# ---------------------------------------------------------------------------
# container.* — podman (fallback docker)
# ---------------------------------------------------------------------------


def _container_cli() -> str:
    for cli in ("podman", "docker"):
        if shutil.which(cli):
            return cli
    raise ToolError("no container runtime (podman/docker) on this host")


def container_create(args: dict) -> dict:
    image = args.get("image")
    if not image:
        raise ToolError("missing image")
    cli = _container_cli()
    argv = [cli, "create", "--name", args.get("name", ""), image]
    argv = [a for a in argv if a]
    out = run_cmd(argv, timeout=300)
    return {"container_id": out["stdout"].strip()}


def container_start(args: dict) -> dict:
    out = run_cmd([_container_cli(), "start", args.get("name", "")], timeout=60)
    return {"started": out["stdout"].strip()}


def container_stop(args: dict) -> dict:
    out = run_cmd([_container_cli(), "stop", args.get("name", "")], timeout=60)
    return {"stopped": out["stdout"].strip()}


def container_list(args: dict) -> dict:
    out = run_cmd([_container_cli(), "ps", "-a", "--format", "json"], timeout=30)
    try:
        containers = json.loads(out["stdout"] or "[]")
    except ValueError:
        containers = out["stdout"].splitlines()
    return {"containers": containers if isinstance(containers, list) else []}


def container_exec(args: dict) -> dict:
    name, cmd = args.get("name"), args.get("command")
    if not name or not cmd:
        raise ToolError("missing name or command")
    out = run_cmd([_container_cli(), "exec", name, "sh", "-c", cmd], timeout=120)
    return {"stdout": out["stdout"], "exit_code": out["exit_code"]}


def container_logs(args: dict) -> dict:
    out = run_cmd(
        [_container_cli(), "logs", "--tail", str(args.get("lines", 100)),
         args.get("name", "")],
        timeout=30,
    )
    return {"logs": (out["stdout"] + out["stderr"]).splitlines()[-200:]}


TOOLS = {
    "git.init": ToolSpec(git_init, "Initialize a git repo", idempotent=True),
    "git.clone": ToolSpec(git_clone, "Shallow-clone a repo",
                          timeout_ms=300_000),
    "git.add": ToolSpec(git_add, "Stage paths"),
    "git.commit": ToolSpec(git_commit, "Commit staged changes"),
    "git.push": ToolSpec(git_push, "Push to remote", timeout_ms=120_000),
    "git.pull": ToolSpec(git_pull, "Fast-forward pull", timeout_ms=120_000),
    "git.branch": ToolSpec(git_branch, "List/create branches"),
    "git.status": ToolSpec(git_status, "Working tree status", idempotent=True),
    "git.log": ToolSpec(git_log, "Recent commits", idempotent=True),
    "git.diff": ToolSpec(git_diff, "Diff stat", idempotent=True),
    "code.scaffold": ToolSpec(code_scaffold, "Scaffold a project skeleton"),
    "code.generate": ToolSpec(code_generate, "AI-assisted code generation"),
    "self.inspect": ToolSpec(self_inspect, "Framework source inventory",
                             idempotent=True),
    "self.update": ToolSpec(self_update, "git pull the framework",
                            requires_confirmation=True),
    "self.rebuild": ToolSpec(self_rebuild, "Regenerate protos/native code",
                             timeout_ms=300_000),
    "self.health": ToolSpec(self_health, "Probe all aiOS service ports",
                            idempotent=True),
    "container.create": ToolSpec(container_create, "Create a container"),
    "container.start": ToolSpec(container_start, "Start a container"),
    "container.stop": ToolSpec(container_stop, "Stop a container"),
    "container.list": ToolSpec(container_list, "List containers",
                               idempotent=True),
    "container.exec": ToolSpec(container_exec, "Exec a command in a container"),
    "container.logs": ToolSpec(container_logs, "Container logs",
                               idempotent=True),
}
