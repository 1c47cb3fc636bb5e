"""The rule engine: the static rules over the shared AST substrate.

The rule catalog and the waiver policy are the package docstring
(:mod:`aios_tpu_torch.analysis`); what is specific to the port (its
locks, its hazard shapes, the modules each rule watches) is declared in
:mod:`.registry`.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import registry as reg
from .core import (
    Finding,
    FuncInfo,
    ModuleInfo,
    callee_chain,
    iter_calls,
    load_package,
    string_constants,
)

__all__ = ["RULE_IDS", "Analyzer", "run_analysis"]

RULE_IDS = (
    "lock-dispatch",
    "lock-readback",
    "lock-rpc",
    "lock-order",
    "guarded-by",
    "graph-warmup",
    "silent-except",
    "knob-docs",
    "metric-catalog",
    "waiver-reason",
)

GUARDED_BY_RE = re.compile(r"#:\s*guarded_by\s+(\w+)")
_SELF_ASSIGN_RE = re.compile(r"self\.(\w+)")

# container mutators rule guarded-by treats as writes
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "add", "update",
    "setdefault", "move_to_end", "sort", "rotate",
})


class Analyzer:
    """Runs the rule set over a list of ModuleInfos.

    ``config_doc`` is the text of docs/CONFIG.md (injectable for the
    fixture tests); when None and ``repo_root`` is set, it is read from
    disk. A custom ``registry`` lets tests seed violations with a
    two-line fixture registry instead of the production one."""

    def __init__(
        self,
        modules: Sequence[ModuleInfo],
        registry: reg.Registry = reg.DEFAULT,
        repo_root: Optional[Path] = None,
        config_doc: Optional[str] = None,
    ) -> None:
        self.modules = list(modules)
        self.by_name: Dict[str, ModuleInfo] = {m.name: m for m in modules}
        self.reg = registry
        self.repo_root = repo_root
        self._config_doc = config_doc
        self.findings: List[Finding] = []
        self._seen: Set[Tuple] = set()

    # -- public -------------------------------------------------------------

    def run(self, rules: Optional[Sequence[str]] = None) -> List[Finding]:
        want = set(rules) if rules else set(RULE_IDS)
        self.findings = []
        self._seen = set()
        self._edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._edge_visited: Set[Tuple[str, str, str]] = set()
        if want & {"lock-dispatch", "lock-readback", "lock-rpc",
                   "lock-order"}:
            self._run_lock_scopes()
        if "lock-order" in want:
            self._check_lock_cycles()
        if "guarded-by" in want:
            self._check_guarded_by()
        if "graph-warmup" in want:
            self._check_dispatch_hygiene()
        if "silent-except" in want:
            self._check_silent_except()
        if "knob-docs" in want:
            self._check_knob_drift()
        if "metric-catalog" in want:
            self._check_metric_catalog()
        if "waiver-reason" in want:
            self._check_waivers()
        self.findings = [f for f in self.findings if f.rule in want]
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    # -- lock resolution ----------------------------------------------------

    def _decl_for_class_attr(
        self, mi: ModuleInfo, class_name: Optional[str], attr: str
    ) -> Optional[reg.LockDecl]:
        if class_name is None:
            return None
        ancestry = mi.ancestry(class_name)
        for d in self.reg.locks:
            if d.module == mi.name and d.attr == attr and (
                d.class_name in ancestry
            ):
                return d
        return None

    def _decl_for_global(
        self, module: str, name: str
    ) -> Optional[reg.LockDecl]:
        """The declared module-level lock ``<module>.<name>``, if any."""
        for d in self.reg.locks:
            if d.module_level and d.module == module and d.attr == name:
                return d
        return None

    def _lock_for_with_item(
        self, mi: ModuleInfo, func: Optional[FuncInfo], expr: ast.AST
    ) -> Optional[reg.LockDecl]:
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            owner, attr = expr.value.id, expr.attr
            if owner == "self" and func is not None:
                return self._decl_for_class_attr(mi, func.class_name, attr)
            # `<global-or-param>.attr` — only registry globals resolve
            tgt = self.reg.global_types.get(owner)
            if tgt is not None:
                tmod = self.by_name.get(tgt[0])
                if tmod is not None:
                    return self._decl_for_class_attr(tmod, tgt[1], attr)
        if isinstance(expr, ast.Name):
            if func is not None:
                name = self.reg.local_locks.get(
                    (mi.name, func.qualname, expr.id)
                )
                if name is not None:
                    return self.reg.lock_named(name)
            # a module-level lock of this module (`with _capture_lock:`)
            return self._decl_for_global(mi.name, expr.id)
        return None

    def _resolve_callee(
        self, mi: ModuleInfo, func: Optional[FuncInfo], call: ast.Call
    ) -> Optional[Tuple[ModuleInfo, FuncInfo]]:
        """One-level static call resolution: bare module functions,
        ``self.method`` (through in-module bases), ``ClassName.method``,
        ``self.<typed-field>.method`` via the registry's FIELD_TYPES, and
        registered dynamic hooks (``self.<hook>(...)``)."""
        f = call.func
        if isinstance(f, ast.Name):
            fi = mi.functions.get(f.id)
            return (mi, fi) if fi else None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        if isinstance(base, ast.Name):
            if base.id == "self" and func is not None:
                hook = self.reg.hook_targets.get((mi.name, f.attr))
                if hook is not None:
                    hmod = self.by_name.get(hook[0])
                    if hmod is not None:
                        hfn = hmod.functions.get(hook[1])
                        if hfn is not None:
                            return (hmod, hfn)
                if func.class_name:
                    for cls in mi.ancestry(func.class_name):
                        fi = mi.functions.get(f"{cls}.{f.attr}")
                        if fi:
                            return (mi, fi)
                return None
            if base.id in mi.classes:  # ClassName.static_method(...)
                fi = mi.functions.get(f"{base.id}.{f.attr}")
                return (mi, fi) if fi else None
            tgt = self.reg.global_types.get(base.id)
            if tgt is not None:
                return self._method_on(tgt, f.attr)
        if isinstance(base, ast.Attribute):
            if (
                isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and func is not None
                and func.class_name
            ):
                for cls in mi.ancestry(func.class_name):
                    tgt = self.reg.field_types.get(
                        (mi.name, cls, base.attr)
                    )
                    if tgt is not None:
                        return self._method_on(tgt, f.attr)
            # dotted singletons (`flightrec.RECORDER.event(...)`)
            tgt = self.reg.global_types.get(base.attr)
            if tgt is not None:
                return self._method_on(tgt, f.attr)
        return None

    def _method_on(
        self, tgt: Tuple[str, str], method: str
    ) -> Optional[Tuple[ModuleInfo, FuncInfo]]:
        tmod = self.by_name.get(tgt[0])
        if tmod is None:
            return None
        for cls in [tgt[1]] + tmod.subclasses_of(tgt[1]):
            fi = tmod.functions.get(f"{cls}.{method}")
            if fi:
                return (tmod, fi)
        return None

    # -- hazard classification ----------------------------------------------

    @staticmethod
    def _hazard_class(call: ast.Call) -> Optional[Tuple[str, str]]:
        """(hazard, description) for a call, else None."""
        chain = callee_chain(call)
        if not chain:
            return None
        term = chain[-1]
        dotted = ".".join(chain)
        if term in reg.READBACK_TERMINALS or (
            term == "to" and _to_host(call)
        ):
            return ("readback", dotted)
        if term in reg.DISPATCH_TERMINALS:
            return ("dispatch", dotted)
        if term in reg.RPC_TERMINALS or (
            term == reg.RPC_JOIN and _thread_join(call)
        ) or any(
            reg.RPC_CHAIN_MARKER in seg.lower() for seg in chain[:-1]
        ):
            return ("rpc", dotted)
        return None

    # -- rule 1 + rule 2 edge collection -------------------------------------

    def _run_lock_scopes(self) -> None:
        for mi in self.modules:
            for node in ast.walk(mi.tree):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                func = mi.enclosing_function(node)
                for item in node.items:
                    decl = self._lock_for_with_item(
                        mi, func, item.context_expr
                    )
                    if decl is None:
                        continue
                    held = self._context_locks(mi, func) if func else ()
                    for outer in held:
                        self._edge(outer, decl.name, mi, node.lineno)
                    self._scan_scope(
                        mi, func, decl, node.body, node.lineno
                    )
            # caller-held contexts: whole function bodies under a lock
            for (mod, qual), held in self.reg.context_fns.items():
                if mod != mi.name:
                    continue
                fi = mi.functions.get(qual)
                if fi is None:
                    continue
                for name in held:
                    decl = self.reg.lock_named(name)
                    if decl is not None:
                        self._scan_scope(
                            mi, fi, decl, fi.node.body, fi.node.lineno,
                            context=True,
                        )

    def _context_locks(
        self, mi: ModuleInfo, func: Optional[FuncInfo]
    ) -> Tuple[str, ...]:
        if func is None:
            return ()
        return self.reg.context_fns.get((mi.name, func.qualname), ())

    def _scan_scope(
        self,
        mi: ModuleInfo,
        func: Optional[FuncInfo],
        decl: reg.LockDecl,
        body: Sequence[ast.stmt],
        scope_line: int,
        context: bool = False,
    ) -> None:
        """Scan a lock body (or caller-held context function body): direct
        hazards, nested acquisitions (lock-order edges), and ONE level of
        resolvable calls."""
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        inner = self._lock_for_with_item(
                            mi, func, item.context_expr
                        )
                        if inner is not None and inner.name != decl.name:
                            self._edge(
                                decl.name, inner.name, mi, sub.lineno
                            )
                if not isinstance(sub, ast.Call):
                    continue
                hz = self._hazard_class(sub)
                if hz is not None and hz[0] in decl.forbids:
                    self._hazard_finding(
                        mi, decl, sub.lineno, hz, scope_line
                    )
                resolved = self._resolve_callee(mi, func, sub)
                if resolved is not None:
                    cmod, cfn = resolved
                    if not (cmod is mi and func is not None
                            and cfn.qualname == func.qualname):
                        self._scan_callee(
                            mi, decl, sub.lineno, scope_line, cmod, cfn,
                            depth=1,
                        )

    # hazards are reported one call level deep; the
    # acquired-while-holding EDGES keep resolving a few levels further,
    # because cross-object acquisitions (engine lock -> prefix-index
    # lock) sit behind thin accessor methods.
    _EDGE_DEPTH = 4

    def _scan_callee(
        self,
        call_mi: ModuleInfo,
        decl: reg.LockDecl,
        call_line: int,
        scope_line: int,
        cmod: ModuleInfo,
        cfn: FuncInfo,
        depth: int,
    ) -> None:
        """Hazards one level deep, lock-order edges up to _EDGE_DEPTH."""
        # keyed on depth==1 so an edges-only visit at depth>1 never
        # swallows a later hazard-reporting visit at depth 1
        vkey = (decl.name, cmod.name, cfn.qualname, depth == 1)
        if vkey in self._edge_visited:
            return
        self._edge_visited.add(vkey)
        for sub in ast.walk(cfn.node):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    inner = self._lock_for_with_item(cmod, cfn,
                                                     item.context_expr)
                    if inner is not None and inner.name != decl.name:
                        self._edge(decl.name, inner.name, cmod, sub.lineno)
            if not isinstance(sub, ast.Call):
                continue
            if depth < self._EDGE_DEPTH:
                resolved = self._resolve_callee(cmod, cfn, sub)
                if resolved is not None:
                    self._scan_callee(
                        call_mi, decl, call_line, scope_line,
                        resolved[0], resolved[1], depth + 1,
                    )
            if depth > 1:
                continue  # hazard attribution stays one level deep
            hz = self._hazard_class(sub)
            if hz is not None and hz[0] in decl.forbids:
                # waivable at the inner hazard line, the call site, or
                # the governing with statement
                key = ("lock-" + hz[0], cmod.path, sub.lineno, decl.name)
                if key in self._seen:
                    continue
                self._seen.add(key)
                reason = (
                    cmod.waiver_for("lock-" + hz[0], sub.lineno)
                    or call_mi.waiver_for(
                        "lock-" + hz[0], call_line, scope_line
                    )
                )
                self.findings.append(Finding(
                    "lock-" + hz[0], cmod.path, sub.lineno,
                    f"{hz[1]}(...) runs under lock '{decl.name}' via "
                    f"{cfn.qualname} (called at {call_mi.path}:"
                    f"{call_line}) — {_HAZARD_WHY[hz[0]]}",
                    waived=reason is not None,
                    waive_reason=reason or "",
                ))

    def _hazard_finding(
        self,
        mi: ModuleInfo,
        decl: reg.LockDecl,
        line: int,
        hz: Tuple[str, str],
        scope_line: int,
    ) -> None:
        rule = "lock-" + hz[0]
        key = (rule, mi.path, line, decl.name)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(mi.finding(
            rule, line,
            f"{hz[1]}(...) inside `with` body of lock '{decl.name}' — "
            f"{_HAZARD_WHY[hz[0]]}",
            scope_line,
        ))

    # -- rule 2: cycles ------------------------------------------------------

    def _edge(self, a: str, b: str, mi: ModuleInfo, line: int) -> None:
        if a == b:
            return
        self._edges.setdefault((a, b), (mi.path, line))

    def _check_lock_cycles(self) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self._edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(graph):
            path: List[str] = []
            self._dfs_cycles(start, graph, path, set(), seen_cycles)
        for cyc in sorted(seen_cycles):
            closed = list(cyc) + [cyc[0]]
            evidence = []
            for a, b in zip(closed, closed[1:]):
                p, ln = self._edges[(a, b)]
                evidence.append(f"{a}->{b} at {p}:{ln}")
            p0, l0 = self._edges[(closed[0], closed[1])]
            mi = next(
                (m for m in self.modules if m.path == p0), None
            )
            msg = (
                "lock-order cycle: " + " -> ".join(closed)
                + " (" + "; ".join(evidence) + ")"
            )
            waiver_lines = [
                self._edges[(a, b)][1]
                for a, b in zip(closed, closed[1:])
                if self._edges[(a, b)][0] == p0
            ]
            if mi is not None:
                self.findings.append(
                    mi.finding("lock-order", l0, msg, *waiver_lines)
                )
            else:
                self.findings.append(Finding("lock-order", p0, l0, msg))

    def _dfs_cycles(self, node, graph, path, on_path, out) -> None:
        if node in on_path:
            i = path.index(node)
            cyc = tuple(path[i:])
            # canonicalize rotation so each cycle reports once
            k = cyc.index(min(cyc))
            out.add(cyc[k:] + cyc[:k])
            return
        path.append(node)
        on_path.add(node)
        for nxt in sorted(graph.get(node, ())):
            self._dfs_cycles(nxt, graph, path, on_path, out)
        path.pop()
        on_path.discard(node)

    # -- rule 3: guarded-by --------------------------------------------------

    def _check_guarded_by(self) -> None:
        for mi in self.modules:
            guarded = self._guarded_fields(mi)
            if not guarded:
                continue
            for node in ast.walk(mi.tree):
                hit = self._mutation_of(node, guarded)
                if hit is None:
                    continue
                field_name, decl = hit
                func = mi.enclosing_function(node)
                if func is not None and func.node.name in (
                    "__init__", "__del__"
                ):
                    continue
                if self._under_lock(mi, func, node, decl):
                    continue
                self.findings.append(mi.finding(
                    "guarded-by", node.lineno,
                    f"write to '{field_name}' (guarded_by {decl.attr} — "
                    f"lock '{decl.name}') outside its lock",
                ))

    def _guarded_fields(
        self, mi: ModuleInfo
    ) -> Dict[str, reg.LockDecl]:
        """field name -> guard decl, from `#: guarded_by <attr>` trailing
        comments on `self.<field> = ...` lines."""
        out: Dict[str, reg.LockDecl] = {}
        for node in ast.walk(mi.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            line = (
                mi.lines[node.lineno - 1]
                if node.lineno - 1 < len(mi.lines) else ""
            )
            m = GUARDED_BY_RE.search(line)
            if not m and node.lineno >= 2:
                # standalone `#: guarded_by <attr>` on the line above
                above = mi.lines[node.lineno - 2]
                if above.lstrip().startswith("#"):
                    m = GUARDED_BY_RE.search(above)
            if not m:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name
                ) and t.value.id == "self":
                    cls = mi.enclosing_class(node)
                    decl = self._decl_for_class_attr(mi, cls, m.group(1))
                    if decl is not None:
                        out[t.attr] = decl
        return out

    @staticmethod
    def _mutation_of(
        node: ast.AST, guarded: Dict[str, reg.LockDecl]
    ) -> Optional[Tuple[str, reg.LockDecl]]:
        def attr_hit(expr) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and expr.attr in guarded:
                return expr.attr
            return None

        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                f = attr_hit(t)
                if f:
                    return (f, guarded[f])
                if isinstance(t, ast.Subscript):
                    f = attr_hit(t.value)
                    if f:
                        return (f, guarded[f])
        if isinstance(node, ast.Delete):
            for t in node.targets:
                f = attr_hit(t)
                if f is None and isinstance(t, ast.Subscript):
                    f = attr_hit(t.value)
                if f:
                    return (f, guarded[f])
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr in MUTATORS:
            f = attr_hit(node.func.value)
            if f:
                return (f, guarded[f])
        return None

    def _under_lock(
        self,
        mi: ModuleInfo,
        func: Optional[FuncInfo],
        node: ast.AST,
        decl: reg.LockDecl,
    ) -> bool:
        if decl.name in self._context_locks(mi, func):
            return True
        cur = getattr(node, "_aios_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    got = self._lock_for_with_item(
                        mi, func, item.context_expr
                    )
                    if got is not None and got.name == decl.name:
                        return True
            cur = getattr(cur, "_aios_parent", None)
        return False

    # -- rule 4: dispatch hygiene (graph-warmup) ----------------------------

    def _reach(
        self,
        starts: List[Tuple[ModuleInfo, FuncInfo]],
        stop=None,
        rule: str = "",
    ) -> Dict[Tuple[str, str], str]:
        """Functions reachable from ``starts`` over name-resolved calls:
        {(module, qualname): the start it was reached from}. A function
        ``stop`` accepts is not entered (unless it is a start), and a call
        on a line waived for ``rule`` is not followed."""
        reached: Dict[Tuple[str, str], str] = {}
        frontier: List[Tuple[ModuleInfo, FuncInfo, str]] = []
        for mi, fi in starts:
            reached[(mi.name, fi.qualname)] = fi.qualname
            frontier.append((mi, fi, fi.qualname))
        while frontier:
            mi, fi, origin = frontier.pop()
            for call in iter_calls(fi.node):
                if rule and mi.waiver_for(rule, call.lineno):
                    continue
                resolved = self._resolve_callee(mi, fi, call)
                if resolved is None:
                    continue
                cmod, cfn = resolved
                key = (cmod.name, cfn.qualname)
                if key in reached or (stop is not None and stop(cfn)):
                    continue
                reached[key] = origin
                frontier.append((cmod, cfn, origin))
        return reached

    def _check_dispatch_hygiene(self) -> None:
        """graph-warmup: a graph capture in a serving-path module runs
        behind a warmup root (``warmup`` / ``capture_*``), and no serving
        entry reaches it except through such a root or a waived call, so
        ``graph_captures`` stays flat while serving."""
        mods = [
            self.by_name[m]
            for m in self.reg.dispatch_hygiene_modules
            if m in self.by_name
        ]
        if not mods:
            return

        def named(pattern):
            return [(mi, fi) for mi in mods for fi in mi.functions.values()
                    if pattern.match(fi.node.name)]

        def is_root(fi: FuncInfo) -> bool:
            return bool(reg.WARMUP_ROOT_RE.match(fi.node.name))

        warmed = self._reach(named(reg.WARMUP_ROOT_RE))
        served = self._reach(named(reg.SERVING_ENTRY_RE), stop=is_root,
                             rule="graph-warmup")
        for mi in mods:
            for call in iter_calls(mi.tree):
                chain = callee_chain(call)
                if not chain or chain[-1] not in reg.CAPTURE_TERMINALS:
                    continue
                fn = mi.enclosing_function(call)
                where = fn.qualname if fn else "<module>"
                key = (mi.name, where)
                if key not in warmed:
                    self.findings.append(mi.finding(
                        "graph-warmup", call.lineno,
                        f"{'.'.join(chain)}(...) in {where} is not reachable "
                        f"from a warmup root (warmup/capture_*): the graph "
                        f"is captured on the serving hot path",
                    ))
                elif key in served:
                    self.findings.append(mi.finding(
                        "graph-warmup", call.lineno,
                        f"{'.'.join(chain)}(...) in {where} is reachable "
                        f"from the serving entry {served[key]} without a "
                        f"warmup root: a graph missing there is captured "
                        f"while serving",
                    ))

    # -- rule: silent-except (fault paths must not be black holes) -----------

    @staticmethod
    def _is_broad_handler(node: ast.ExceptHandler) -> bool:
        def broad(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in reg.BROAD_EXCEPTION_NAMES
            if isinstance(expr, ast.Attribute):
                return expr.attr in reg.BROAD_EXCEPTION_NAMES
            return False

        t = node.type
        if t is None:  # bare `except:`
            return True
        if isinstance(t, ast.Tuple):
            return any(broad(e) for e in t.elts)
        return broad(t)

    def _handler_records(self, node: ast.ExceptHandler) -> bool:
        """Whether the handler body records the failure: re-raises, logs
        it, lands an abort/terminal cause, or forwards to the abort
        plumbing (registry SILENT_EXCEPT_RECORDERS)."""
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    return True
                if isinstance(sub, ast.Call):
                    chain = callee_chain(sub)
                    if chain and chain[-1] in self.reg.silent_except_recorders:
                        return True
                if isinstance(sub, ast.keyword) and sub.arg == "abort_reason":
                    return True
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    targets = (
                        sub.targets if isinstance(sub, ast.Assign)
                        else [sub.target]
                    )
                    if any(
                        isinstance(t, ast.Attribute)
                        and t.attr == "abort_reason"
                        for t in targets
                    ):
                        return True
        return False

    def _check_silent_except(self) -> None:
        for mi in self.modules:
            if not mi.name.startswith(
                tuple(self.reg.silent_except_prefixes)
            ):
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not self._is_broad_handler(node):
                    continue
                if self._handler_records(node):
                    continue
                self.findings.append(mi.finding(
                    "silent-except", node.lineno,
                    "broad except handler swallows the failure without "
                    "recording it (no raise / log / abort cause) — fault "
                    "paths must not be observability black holes; record "
                    "the failure or waive with a reason",
                ))

    # -- rule 5: knob/docs drift + metric catalog ----------------------------

    def _config_doc_text(self) -> Optional[str]:
        if self._config_doc is not None:
            return self._config_doc
        if self.repo_root is None:
            return None
        p = self.repo_root / reg.CONFIG_DOC
        return p.read_text() if p.exists() else None

    def _declared_knobs(self) -> Set[Tuple[str, int, str]]:
        """The knob names that the registry's declared tuples of knobs the
        port does not read (``UNPORTED_KNOBS``, ``NOT_CARRIED_KNOBS``)
        hold, as (module, line, name)."""
        out: Set[Tuple[str, int, str]] = set()
        for mod, var in self.reg.knob_declarations:
            mi = self.by_name.get(mod)
            if mi is None:
                continue
            for node in mi.tree.body:
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                else:
                    continue
                if any(isinstance(t, ast.Name) and t.id == var
                       for t in targets):
                    out |= {(mi.name, line, name) for name, line
                            in string_constants(node, reg.KNOB_RE)}
        return out

    def _check_knob_drift(self) -> None:
        """Every knob string in the tree is a row of the config doc, and
        every row is read by the tree or named by a declared tuple of knobs
        the port does not read."""
        doc = self._config_doc_text()
        if doc is None:
            return
        doc_names = set(reg.KNOB_RE.findall(doc))
        declared = self._declared_knobs()
        read: Set[str] = set()
        for mi in self.modules:
            for name, line in string_constants(mi.tree, reg.KNOB_RE):
                if name not in doc_names:
                    self.findings.append(mi.finding(
                        "knob-docs", line,
                        f"env knob {name} is read here but missing from "
                        f"{reg.CONFIG_DOC}",
                    ))
                if (mi.name, line, name) not in declared:
                    read.add(name)
        accounted = read | {name for _, _, name in declared}
        for stale in sorted(doc_names - accounted):
            line = next(
                (i for i, t in enumerate(doc.splitlines(), 1) if stale in t),
                1,
            )
            self.findings.append(Finding(
                "knob-docs", reg.CONFIG_DOC, line,
                f"{reg.CONFIG_DOC} documents {stale} but nothing in the "
                f"tree reads it and no declaration names it (stale row, "
                f"or a knob to add to UNPORTED_KNOBS / NOT_CARRIED_KNOBS)",
            ))

    def _check_metric_catalog(self) -> None:
        for mi in self.modules:
            if mi.name in reg.METRIC_CATALOG_MODULES:
                continue
            for call in iter_calls(mi.tree):
                chain = callee_chain(call)
                if not chain or chain[-1] not in reg.METRIC_CTORS:
                    continue
                if not call.args:
                    continue
                arg = call.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ) and arg.value.startswith(reg.METRIC_PREFIX):
                    self.findings.append(mi.finding(
                        "metric-catalog", call.lineno,
                        f"instrument {arg.value!r} constructed outside "
                        f"obs/instruments.py — add it to the catalog so "
                        f"it is reviewed with the others",
                    ))

    # -- meta: waiver hygiene ------------------------------------------------

    def _check_waivers(self) -> None:
        from .core import WAIVE_RE

        for mi in self.modules:
            for line, text in enumerate(mi.lines, start=1):
                m = WAIVE_RE.search(text)
                if not m:
                    continue
                for rule, reason in [
                    (m.group(1), (m.group(2) or "").strip())
                ]:
                    if rule not in RULE_IDS and rule != "all":
                        self.findings.append(Finding(
                            "waiver-reason", mi.path, line,
                            f"waiver names unknown rule {rule!r} "
                            f"(known: {', '.join(RULE_IDS)})",
                        ))
                    elif not reason:
                        self.findings.append(Finding(
                            "waiver-reason", mi.path, line,
                            f"waiver for {rule!r} carries no "
                            f"justification — the reason is mandatory "
                            f"(# aios: waive({rule}): <why>)",
                        ))


_HAZARD_WHY = {
    "dispatch": "a graph replay/capture or eager dispatch stalls every "
                "thread sharing the lock (router probes, scrape callbacks, "
                "the scheduler)",
    "readback": "a device->host sync holds the lock for the whole "
                "transfer",
    "rpc": "a blocking wait under a lock invites deadlock and "
           "convoying",
}


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: a copy to the host."""
    args = list(call.args[:1]) + [
        k.value for k in call.keywords if k.arg == "device"
    ]
    return any(
        isinstance(a, ast.Constant) and a.value == reg.READBACK_TO_DEVICE
        for a in args
    )


def _thread_join(call: ast.Call) -> bool:
    """``t.join()``, ``t.join(5)`` or ``t.join(timeout=...)`` (a thread's or
    a queue's join), never ``sep.join(parts)`` or ``os.path.join(...)``."""
    f = call.func
    if not isinstance(f, ast.Attribute) or isinstance(
        f.value, (ast.Constant, ast.JoinedStr)
    ):
        return False
    if isinstance(f.value, ast.Attribute) and f.value.attr == "path":
        return False
    if any(k.arg == "timeout" for k in call.keywords):
        return True
    if not call.args:
        return True
    a = call.args[0]
    return len(call.args) == 1 and isinstance(a, ast.Constant) and (
        isinstance(a.value, (int, float)) and not isinstance(a.value, bool)
    )


def run_analysis(
    rules: Optional[Sequence[str]] = None,
    registry: reg.Registry = reg.DEFAULT,
    repo_root: Optional[Path] = None,
) -> List[Finding]:
    """Analyze the ``aios_tpu_torch`` tree (the CLI and the tier-1 test
    share this entry point)."""
    pkg_root = Path(__file__).resolve().parents[1]
    root = repo_root or pkg_root.parent
    modules = load_package(pkg_root, root)
    return Analyzer(modules, registry, repo_root=root).run(rules)
