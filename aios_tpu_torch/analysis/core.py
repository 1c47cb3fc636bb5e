"""Shared AST substrate for the static rules in :mod:`aios_tpu_torch.analysis`.

Every rule works from the same three primitives so there is ONE way to
read the tree:

  * :class:`ModuleInfo` — a parsed module: AST with parent links, raw
    source lines, class/function tables, and the per-line waiver map;
  * :class:`Finding` — one diagnostic, ``rule`` id + ``path:line`` +
    message, with the waiver resolution already applied;
  * the call helpers (:func:`callee_chain`, :func:`string_call_args`,
    :func:`assigned_string_literals`, :func:`names_used_in`) — the
    AST-shaped replacements for the regex greps the lint tests used to
    carry.

Waiver pragma grammar (inline, same line as the finding or the governing
``with`` statement)::

    # aios: waive(<rule-id>): <mandatory justification>

A waiver with no justification text does not waive anything — it instead
raises its own ``waiver-reason`` finding, so the rationale lives at the
call site or the pragma goes.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

WAIVE_RE = re.compile(
    r"#\s*aios:\s*waive\(\s*([a-z0-9_-]+)\s*\)\s*(?::\s*(\S.*))?"
)


@dataclass
class Finding:
    """One diagnostic. ``path`` is repo-relative, ``line`` 1-indexed."""

    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    waive_reason: str = ""

    def render(self) -> str:
        tag = " [waived]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "waived": self.waived,
            "waive_reason": self.waive_reason,
        }


@dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str  # "Class.method" or "func"
    class_name: Optional[str]


@dataclass
class ClassInfo:
    node: ast.ClassDef
    bases: Tuple[str, ...]  # base names as written (dotted tails kept)


class ModuleInfo:
    """A parsed module plus the lookup tables every rule needs."""

    def __init__(self, name: str, path: str, source: str) -> None:
        self.name = name  # dotted module name, e.g. "aios_tpu_torch.engine.paged"
        self.path = path  # repo-relative path used in findings
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        _link_parents(self.tree)
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self._index_defs()
        # line -> [(rule, reason)] waivers; empty reason kept (and flagged)
        self.waivers: Dict[int, List[Tuple[str, str]]] = {}
        self._index_waivers()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_path(cls, name: str, path: Path, rel: str) -> "ModuleInfo":
        return cls(name, rel, path.read_text())

    @classmethod
    def from_source(cls, source: str, name: str = "fixture",
                    path: str = "<fixture>") -> "ModuleInfo":
        """Inline-snippet constructor for the rule tests."""
        return cls(name, path, source)

    # -- indexing -----------------------------------------------------------

    def _index_defs(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                bases = tuple(
                    _dotted_tail(b) for b in node.bases if _dotted_tail(b)
                )
                self.classes[node.name] = ClassInfo(node, bases)
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        q = f"{node.name}.{sub.name}"
                        self.functions[q] = FuncInfo(sub, q, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = FuncInfo(node, node.name, None)

    def _index_waivers(self) -> None:
        for i, text in enumerate(self.lines, start=1):
            m = WAIVE_RE.search(text)
            if not m:
                continue
            rule, reason = m.group(1), (m.group(2) or "").strip()
            line = i
            if text.lstrip().startswith("#"):
                # a standalone pragma governs the next code line (stacked
                # pragmas skip over each other and other comments)
                j = i
                while j < len(self.lines) and (
                    not self.lines[j].strip()
                    or self.lines[j].lstrip().startswith("#")
                ):
                    j += 1
                line = j + 1 if j < len(self.lines) else i
            self.waivers.setdefault(line, []).append((rule, reason))

    # -- waiver resolution --------------------------------------------------

    def waiver_for(self, rule: str, *lines: int) -> Optional[str]:
        """The justification text if any of ``lines`` carries a waiver
        for ``rule`` (or the catch-all id ``all``); None otherwise.
        Empty-reason waivers never match — they are findings themselves."""
        for ln in lines:
            for r, reason in self.waivers.get(ln, ()):  # usually empty
                if r in (rule, "all") and reason:
                    return reason
        return None

    def finding(self, rule: str, line: int, message: str,
                *extra_lines: int) -> Finding:
        """Build a finding, resolving waivers at ``line`` plus any
        ``extra_lines`` (e.g. the governing ``with`` statement)."""
        reason = self.waiver_for(rule, line, *extra_lines)
        return Finding(rule, self.path, line, message,
                       waived=reason is not None,
                       waive_reason=reason or "")

    # -- structure helpers --------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[FuncInfo]:
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls = getattr(cur, "_aios_parent", None)
                if isinstance(cls, ast.ClassDef):
                    return self.functions.get(f"{cls.name}.{cur.name}")
                if isinstance(cls, ast.Module):
                    return self.functions.get(cur.name)
                # nested function: attribute to the outer def
                cur = cls
                continue
            cur = getattr(cur, "_aios_parent", None)
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[str]:
        cur = node
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = getattr(cur, "_aios_parent", None)
        return None

    def ancestry(self, class_name: str) -> List[str]:
        """``class_name`` plus its in-module base chain (names only)."""
        out, seen = [], set()
        stack = [class_name]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            out.append(c)
            info = self.classes.get(c)
            if info:
                stack.extend(info.bases)
        return out

    def subclasses_of(self, class_name: str) -> List[str]:
        return [
            name for name in self.classes
            if class_name in self.ancestry(name)
        ]


def _link_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._aios_parent = node  # type: ignore[attr-defined]


def _dotted_tail(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


# -- call-shape helpers ------------------------------------------------------


def callee_chain(call: ast.Call) -> List[str]:
    """The dotted name chain of a call's callee, outermost first.

    ``jax.block_until_ready(x)`` -> ``["jax", "block_until_ready"]``;
    ``self._step_fn(n)(args)`` (outer call) -> ``["()", "_step_fn"]`` —
    a leading ``"()"`` marks calling the RESULT of an inner call, whose
    own chain is reported at its own Call node."""
    out: List[str] = []
    cur: ast.AST = call.func
    while True:
        if isinstance(cur, ast.Attribute):
            out.append(cur.attr)
            cur = cur.value
        elif isinstance(cur, ast.Name):
            out.append(cur.id)
            break
        elif isinstance(cur, ast.Call):
            out.append("()")
            break
        else:
            break
    out.reverse()
    return out


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def string_call_args(
    root: ast.AST,
    method_names: Sequence[str],
    arg_index: int = 0,
) -> List[Tuple[str, int]]:
    """``(literal, line)`` for every call whose terminal callee name is
    in ``method_names`` and whose ``arg_index``-th positional argument is
    a string literal. The AST replacement for the lint tests' call-site
    regexes — immune to line wrapping and argument whitespace."""
    out: List[Tuple[str, int]] = []
    for call in iter_calls(root):
        chain = callee_chain(call)
        if not chain or chain[-1] not in method_names:
            continue
        if len(call.args) > arg_index:
            arg = call.args[arg_index]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((arg.value, arg.lineno))
    return out


def assigned_string_literals(
    root: ast.AST, attr_name: str
) -> List[Tuple[str, int]]:
    """String literals bound to ``<attr_name>`` anywhere a value can be
    handed to it: attribute assignments (``live.abort_reason = "..."``)
    AND keyword arguments (``self._finish(x, abort_reason="...")``) —
    the old regex lint covered both shapes, so the AST walker must too.
    F-string literal heads count."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(root):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            if any(
                isinstance(t, ast.Attribute) and t.attr == attr_name
                for t in targets
            ):
                lit = _string_head(node.value)
                if lit is not None:
                    out.append((lit, node.lineno))
        elif isinstance(node, ast.keyword) and node.arg == attr_name:
            lit = _string_head(node.value)
            if lit is not None:
                out.append((lit, node.value.lineno))
    return out


def _string_head(val: Optional[ast.AST]) -> Optional[str]:
    """A plain str literal, or the leading literal text of an f-string."""
    if isinstance(val, ast.Constant) and isinstance(val.value, str):
        return val.value
    if isinstance(val, ast.JoinedStr) and val.values:
        head = val.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    return None


def call_string_heads(
    root: ast.AST, callee: str, arg_index: int = 0
) -> List[Tuple[str, int]]:
    """Like :func:`string_call_args` but also accepts f-string arguments,
    returning their literal head (``_terminate_outstanding(f"evicted: {x}")``
    -> ``"evicted: "``)."""
    out: List[Tuple[str, int]] = []
    for call in iter_calls(root):
        chain = callee_chain(call)
        if not chain or chain[-1] != callee:
            continue
        if len(call.args) > arg_index:
            lit = _string_head(call.args[arg_index])
            if lit is not None:
                out.append((lit, call.lineno))
    return out


def names_used_in(func_node: ast.AST) -> set:
    """Every bare identifier and attribute name referenced in a function
    body — the AST replacement for ``"X" in inspect.getsource(fn)``."""
    out = set()
    for node in ast.walk(func_node):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def string_constants(
    root: ast.AST, pattern: "re.Pattern[str]"
) -> List[Tuple[str, int]]:
    """All string constants fully matching ``pattern`` with their lines."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(root):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if pattern.fullmatch(node.value):
                out.append((node.value, node.lineno))
    return out


# -- module loading ----------------------------------------------------------


def load_package(pkg_root: Path, repo_root: Path,
                 package: str = "aios_tpu_torch") -> List[ModuleInfo]:
    """Parse every ``*.py`` under ``pkg_root`` into ModuleInfos (sorted by
    module name; ``proto_gen`` generated stubs are skipped — machine
    output, not ours to lint)."""
    mods: List[ModuleInfo] = []
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(repo_root).as_posix()
        if "/proto_gen/" in f"/{rel}":
            continue
        parts = list(path.relative_to(pkg_root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join([package] + parts)
        mods.append(ModuleInfo.from_path(name, path, rel))
    return mods


def module_info_for(module) -> ModuleInfo:
    """ModuleInfo for an already-imported module object — the entry point
    the migrated lint tests use (``inspect.getsource`` equivalent)."""
    import inspect

    path = inspect.getsourcefile(module)
    assert path, f"no source for {module!r}"
    return ModuleInfo(module.__name__, path, Path(path).read_text())
