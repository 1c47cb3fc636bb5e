"""fs.* — filesystem tools (reference: tools/src/fs/, 13 handlers)."""

from __future__ import annotations

import os
import shutil
import stat as stat_mod
from pathlib import Path

from . import ToolError, ToolSpec

MAX_READ = 256 * 1024


def _path(args: dict, key: str = "path") -> Path:
    raw = args.get(key)
    if not raw:
        raise ToolError(f"missing required arg '{key}'")
    return Path(raw)


def fs_read(args: dict) -> dict:
    p = _path(args)
    if not p.is_file():
        raise ToolError(f"{p} is not a file")
    data = p.read_bytes()[: int(args.get("max_bytes", MAX_READ))]
    return {"path": str(p), "content": data.decode("utf-8", "replace"),
            "bytes": len(data)}


def fs_write(args: dict) -> dict:
    p = _path(args)
    content = args.get("content", "")
    append = bool(args.get("append", False))
    p.parent.mkdir(parents=True, exist_ok=True)
    mode = "a" if append else "w"
    with open(p, mode, encoding="utf-8") as f:
        f.write(content)
    return {"path": str(p), "bytes_written": len(content.encode()), "append": append}


def fs_delete(args: dict) -> dict:
    p = _path(args)
    if not p.exists():
        raise ToolError(f"{p} does not exist")
    if p.is_dir():
        if not args.get("recursive", False):
            raise ToolError(f"{p} is a directory; pass recursive=true")
        shutil.rmtree(p)
    else:
        p.unlink()
    return {"deleted": str(p)}


def fs_list(args: dict) -> dict:
    p = _path(args)
    if not p.is_dir():
        raise ToolError(f"{p} is not a directory")
    entries = []
    for child in sorted(p.iterdir())[: int(args.get("limit", 500))]:
        try:
            st = child.stat()
            entries.append(
                {
                    "name": child.name,
                    "type": "dir" if child.is_dir() else "file",
                    "size": st.st_size,
                    "mtime": int(st.st_mtime),
                }
            )
        except OSError:
            continue
    return {"path": str(p), "entries": entries, "count": len(entries)}


def fs_stat(args: dict) -> dict:
    p = _path(args)
    if not p.exists():
        raise ToolError(f"{p} does not exist")
    st = p.stat()
    return {
        "path": str(p),
        "size": st.st_size,
        "mode": oct(st.st_mode),
        "uid": st.st_uid,
        "gid": st.st_gid,
        "mtime": int(st.st_mtime),
        "is_dir": p.is_dir(),
        "is_symlink": p.is_symlink(),
    }


def fs_mkdir(args: dict) -> dict:
    p = _path(args)
    p.mkdir(parents=bool(args.get("parents", True)), exist_ok=True)
    return {"created": str(p)}


def fs_move(args: dict) -> dict:
    src, dst = _path(args, "src"), _path(args, "dst")
    if not src.exists():
        raise ToolError(f"{src} does not exist")
    shutil.move(str(src), str(dst))
    return {"moved": str(src), "to": str(dst)}


def fs_copy(args: dict) -> dict:
    src, dst = _path(args, "src"), _path(args, "dst")
    if not src.exists():
        raise ToolError(f"{src} does not exist")
    if src.is_dir():
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy2(src, dst)
    return {"copied": str(src), "to": str(dst)}


def fs_chmod(args: dict) -> dict:
    p = _path(args)
    mode = args.get("mode")
    if mode is None:
        raise ToolError("missing required arg 'mode' (octal string)")
    p.chmod(int(str(mode), 8))
    return {"path": str(p), "mode": str(mode)}


def fs_chown(args: dict) -> dict:
    p = _path(args)
    uid = int(args.get("uid", -1))
    gid = int(args.get("gid", -1))
    try:
        os.chown(p, uid, gid)
    except PermissionError as exc:
        raise ToolError(f"chown {p}: {exc}") from exc
    return {"path": str(p), "uid": uid, "gid": gid}


def fs_symlink(args: dict) -> dict:
    target, link = _path(args, "target"), _path(args, "link")
    if link.exists():
        raise ToolError(f"{link} already exists")
    link.symlink_to(target)
    return {"link": str(link), "target": str(target)}


def fs_search(args: dict) -> dict:
    p = _path(args)
    pattern = args.get("pattern", "*")
    content = args.get("content", "")
    limit = int(args.get("limit", 100))
    hits = []
    for f in p.rglob(pattern):
        if len(hits) >= limit:
            break
        if content:
            try:
                if f.is_file() and content in f.read_text(errors="ignore"):
                    hits.append(str(f))
            except OSError:
                continue
        else:
            hits.append(str(f))
    return {"matches": hits, "count": len(hits)}


def fs_disk_usage(args: dict) -> dict:
    p = Path(args.get("path", "/"))
    usage = shutil.disk_usage(p)
    return {
        "path": str(p),
        "total_gb": round(usage.total / 1e9, 2),
        "used_gb": round(usage.used / 1e9, 2),
        "free_gb": round(usage.free / 1e9, 2),
        "percent_used": round(usage.used / usage.total * 100, 1),
    }


TOOLS = {
    "fs.read": ToolSpec(fs_read, "Read a file's contents", idempotent=True),
    "fs.write": ToolSpec(
        fs_write, "Write/append content to a file",
        reversible=True, target_arg="path",
    ),
    "fs.delete": ToolSpec(
        fs_delete, "Delete a file or directory",
        reversible=True, target_arg="path", requires_confirmation=True,
    ),
    "fs.list": ToolSpec(fs_list, "List directory entries", idempotent=True),
    "fs.stat": ToolSpec(fs_stat, "Stat a path", idempotent=True),
    "fs.mkdir": ToolSpec(fs_mkdir, "Create a directory", idempotent=True),
    "fs.move": ToolSpec(fs_move, "Move/rename a path", reversible=True,
                        target_arg="src"),
    "fs.copy": ToolSpec(fs_copy, "Copy a file or tree", reversible=True,
                        target_arg="dst"),
    "fs.chmod": ToolSpec(fs_chmod, "Change file mode", reversible=True,
                         target_arg="path"),
    "fs.chown": ToolSpec(fs_chown, "Change file ownership", reversible=True,
                         target_arg="path"),
    "fs.symlink": ToolSpec(fs_symlink, "Create a symlink"),
    "fs.search": ToolSpec(fs_search, "Search files by glob and content",
                          idempotent=True),
    "fs.disk_usage": ToolSpec(fs_disk_usage, "Filesystem usage summary",
                              idempotent=True),
}
