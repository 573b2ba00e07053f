"""Lock-discipline static analysis for the async fleet (stdlib ``ast`` only).

Layer 1 of the concurrency toolkit.  Driven by lightweight comment
directives in the source being checked:

``# guarded-by: <lock>``
    On a field assignment (usually in ``__init__``): every read/write of
    that ``self.<field>`` elsewhere in the class must happen inside a
    ``with self.<lock>`` scope.  ``<lock>`` may be dotted
    (``_client._lock``) to name a lock owned by a collaborator attribute.

``# holds: <lock>[, <lock>...]``
    On a ``def`` line: the method is documented to be called with the
    lock(s) already held (private helpers).  Checked bodies start with
    those locks in the held set.

``lock-order: A.x -> B.y`` (as a ``#``-comment)
    Module-level declaration of a cross-class acquisition edge the AST
    pass cannot see (e.g. a callback chain).  Participates in cycle
    detection.

``# concheck: disable=<rule>[,<rule>...]``
    Inline waiver for this line.  Always pair with a reason.

Rules
-----
- ``guarded-by``         guarded field accessed outside its lock
- ``lock-order``         cycle in the static lock-acquisition graph
- ``blocking-under-lock``  ``time.sleep`` / ``.wait()`` / ``.result()`` /
                         ``.join()`` / engine ``.step()`` while holding a lock
- ``cond-wait-loop``     ``Condition.wait`` not wrapped in a predicate loop
- ``thread-join``        ``threading.Thread`` started but never joined
- ``busy-wait``          polling loop (short constant ``time.sleep`` in a
                         ``while``, or ``while not x.wait(timeout=<short>)``)

Lock identity is canonical: ``ClassName.attr`` after resolving condition
aliases (``Condition(self._lock)`` counts as ``_lock``) and collaborator
types via ``__init__`` parameter annotations.  The extractor merges
with-statement nesting, same-class call-graph closure, ``# holds:``
context and declared ``# lock-order:`` edges into one graph and fails on
cycles.  Nested functions and lambdas are analyzed with an *empty* held
set (closures run later, possibly without the lock) — except predicates
passed to ``Condition.wait_for``, which run with the condition's lock held.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["Violation", "CheckResult", "check_source", "check_paths", "RULES"]

RULES = (
    "guarded-by",
    "lock-order",
    "blocking-under-lock",
    "cond-wait-loop",
    "thread-join",
    "busy-wait",
)

_RE_DISABLE = re.compile(r"#\s*concheck:\s*disable=([\w\-, ]+)")
_RE_GUARDED = re.compile(r"#\s*guarded-by:\s*([\w.]+)")
_RE_HOLDS = re.compile(r"#\s*holds:\s*([\w., ]+)")
_RE_LOCK_ORDER = re.compile(r"#\s*lock-order:\s*([\w.]+)\s*->\s*([\w.]+)")

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition", "Event": "event"}
_FACTORY_CTORS = {"new_lock": "lock", "new_rlock": "rlock", "new_condition": "condition"}

# Short sleeps/timeouts below these thresholds inside a loop are polling.
_BUSY_SLEEP_MAX_S = 0.05
_POLL_WAIT_MAX_S = 0.25


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


@dataclass
class CheckResult:
    violations: List[Violation]
    graph: dict

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclass
class _ClassInfo:
    name: str
    path: str
    # attr -> kind ("lock" | "rlock" | "condition" | "event")
    locks: Dict[str, str] = field(default_factory=dict)
    # condition attr -> lock attr it wraps (Condition(self._lock))
    aliases: Dict[str, str] = field(default_factory=dict)
    # guarded field -> lock spec (possibly dotted), as written in the directive
    guarded: Dict[str, str] = field(default_factory=dict)
    # attr -> collaborator class name (from __init__ param annotations)
    attr_classes: Dict[str, str] = field(default_factory=dict)


class _FileCtx:
    def __init__(self, path: str, src: str) -> None:
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)

    def disabled(self, line: int) -> Set[str]:
        """Waivers on the reported line, or in pure-comment lines directly
        above it (room for a reasoned multi-line justification)."""
        out: Set[str] = set()
        if not 1 <= line <= len(self.lines):
            return out
        m = _RE_DISABLE.search(self.lines[line - 1])
        if m:
            out |= {r.strip() for r in m.group(1).split(",") if r.strip()}
        ln = line - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith("#"):
            m = _RE_DISABLE.search(self.lines[ln - 1])
            if m:
                out |= {r.strip() for r in m.group(1).split(",") if r.strip()}
            ln -= 1
        return out

    def line_directive(self, regex: re.Pattern, lo: int, hi: int) -> Optional[re.Match]:
        for ln in range(lo, min(hi, len(self.lines)) + 1):
            m = regex.search(self.lines[ln - 1])
            if m:
                return m
        return None


def _ann_to_name(node: Optional[ast.expr]) -> Optional[str]:
    """'RolloutClient' from annotations like RolloutClient, "RolloutClient",
    Optional["RolloutClient"]."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        m = re.search(r"[A-Za-z_]\w*$", node.value.strip())
        return m.group(0) if m else None
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Tuple) and sl.elts:
            return _ann_to_name(sl.elts[0])
        return _ann_to_name(sl)  # Optional[X] / list[X]
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _self_path(node: ast.expr) -> Optional[List[str]]:
    """['_client', '_lock'] for self._client._lock; None if not a self path."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self":
        return list(reversed(parts))
    return None


def _const_number(node: ast.expr) -> Optional[float]:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_number(node.operand)
        return -inner if inner is not None else None
    return None


class _Analyzer:
    """Two-pass checker over a set of parsed files sharing a class registry."""

    def __init__(self) -> None:
        self.files: List[_FileCtx] = []
        self.classes: Dict[str, _ClassInfo] = {}
        self.violations: List[Violation] = []
        # lambdas already analyzed with a non-empty held set (wait_for preds)
        self._handled_lambdas: Set[int] = set()
        # canonical edges: (from, to) -> (path, line) of first observation
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # (class, method) -> set of canonical locks acquired directly
        self.direct_acquires: Dict[Tuple[str, str], Set[str]] = {}
        # (class, method) -> set of same-class methods it calls
        self.self_calls: Dict[Tuple[str, str], Set[str]] = {}
        # deferred interprocedural edge requests:
        # (held snapshot, class, callee, path, line)
        self.deferred: List[Tuple[Set[str], str, str, str, int]] = []

    # ---------------- discovery ----------------

    def add_source(self, src: str, path: str) -> None:
        ctx = _FileCtx(path, src)
        self.files.append(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._discover_class(ctx, node)

    def _discover_class(self, ctx: _FileCtx, cls: ast.ClassDef) -> None:
        info = self.classes.setdefault(cls.name, _ClassInfo(cls.name, ctx.path))
        init_params: Dict[str, str] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name == "__init__":
                    for a in item.args.args + item.args.kwonlyargs:
                        nm = _ann_to_name(a.annotation)
                        if nm:
                            init_params[a.arg] = nm
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Assign):
                        targets, value = sub.targets, sub.value
                    elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                        targets, value = [sub.target], sub.value
                    else:
                        continue
                    for tgt in targets:
                        p = _self_path(tgt)
                        if p is None or len(p) != 1:
                            continue
                        attr = p[0]
                        self._record_attr(ctx, info, init_params, attr, value, sub)

    def _record_attr(
        self,
        ctx: _FileCtx,
        info: _ClassInfo,
        init_params: Dict[str, str],
        attr: str,
        value: ast.expr,
        stmt: ast.stmt,
    ) -> None:
        end = getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
        m = ctx.line_directive(_RE_GUARDED, stmt.lineno, end)
        if m:
            info.guarded[attr] = m.group(1)
        if isinstance(value, ast.Call):
            fn = value.func
            kind = None
            if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "threading" and fn.attr in _LOCK_CTORS:
                kind = _LOCK_CTORS[fn.attr]
            elif isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
                kind = _LOCK_CTORS[fn.id]
            elif isinstance(fn, ast.Name) and fn.id in _FACTORY_CTORS:
                kind = _FACTORY_CTORS[fn.id]
            if kind:
                info.locks[attr] = kind
                if kind == "condition" and value.args:
                    wrapped = _self_path(value.args[0])
                    if wrapped and len(wrapped) == 1:
                        info.aliases[attr] = wrapped[0]
        elif isinstance(value, ast.Name) and value.id in init_params:
            info.attr_classes[attr] = init_params[value.id]

    # ---------------- lock identity ----------------

    def _canonical(self, cls: str, parts: List[str]) -> str:
        """Canonical lock id for a self-path within class ``cls``."""
        info = self.classes.get(cls)
        if info is None:
            return f"{cls}.{'.'.join(parts)}"
        if len(parts) == 1:
            attr = parts[0]
            seen = set()
            while attr in info.aliases and attr not in seen:
                seen.add(attr)
                attr = info.aliases[attr]
            return f"{cls}.{attr}"
        owner = info.attr_classes.get(parts[0])
        if owner is not None:
            return self._canonical(owner, parts[1:])
        return f"{cls}.{'.'.join(parts)}"

    def _lock_kind(self, cls: str, parts: List[str]) -> Optional[str]:
        info = self.classes.get(cls)
        if info is None:
            return None
        if len(parts) == 1:
            return info.locks.get(parts[0])
        owner = info.attr_classes.get(parts[0])
        if owner is not None:
            return self._lock_kind(owner, parts[1:])
        return None

    # ---------------- checking ----------------

    def check(self) -> CheckResult:
        for ctx in self.files:
            self._check_file(ctx)
        self._interprocedural_edges()
        self._cycle_check()
        self.violations.sort(key=lambda v: (v.path, v.line, v.rule))
        return CheckResult(self.violations, self._graph())

    def _check_file(self, ctx: _FileCtx) -> None:
        # declared cross-class edges
        for i, line in enumerate(ctx.lines, start=1):
            m = _RE_LOCK_ORDER.search(line)
            if m:
                self.edges.setdefault((m.group(1), m.group(2)), (ctx.path, i))
        self._check_thread_join(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._check_method(ctx, node.name, item)
        # loop rules also apply outside classes (module-level functions)
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(ctx, cls=None, meth=node.name, body=node.body,
                           held=set(), in_while=False)

    def _report(self, ctx: _FileCtx, rule: str, line: int, msg: str) -> None:
        if rule in ctx.disabled(line):
            return
        self.violations.append(Violation(rule, ctx.path, line, msg))

    # -- per-method walk --

    def _check_method(
        self, ctx: _FileCtx, cls: str, fn: ast.FunctionDef
    ) -> None:
        held: Set[str] = set()
        end = fn.body[0].lineno if fn.body else fn.lineno
        m = ctx.line_directive(_RE_HOLDS, fn.lineno, max(fn.lineno, end - 1))
        if m:
            for spec in m.group(1).split(","):
                spec = spec.strip()
                if spec:
                    held.add(self._canonical(cls, spec.split(".")))
        key = (cls, fn.name)
        self.direct_acquires.setdefault(key, set())
        self.self_calls.setdefault(key, set())
        self._walk(ctx, cls, fn.name, fn.body, held, in_while=False,
                   skip_guard=(fn.name == "__init__"))

    def _walk(
        self,
        ctx: _FileCtx,
        cls: Optional[str],
        meth: str,
        body: List[ast.stmt],
        held: Set[str],
        in_while: bool,
        skip_guard: bool = False,
    ) -> None:
        for stmt in body:
            self._walk_stmt(ctx, cls, meth, stmt, held, in_while, skip_guard)

    def _walk_stmt(self, ctx, cls, meth, stmt, held, in_while, skip_guard) -> None:
        if isinstance(stmt, ast.With):
            new_held = set(held)
            for item in stmt.items:
                lock_id = self._with_lock_id(cls, item.context_expr)
                if lock_id is not None:
                    if cls is not None:
                        self.direct_acquires.setdefault((cls, meth), set()).add(lock_id)
                    for h in new_held:
                        if h != lock_id and (h, lock_id) not in self.edges:
                            self.edges[(h, lock_id)] = (ctx.path, stmt.lineno)
                    new_held = new_held | {lock_id}
                else:
                    self._walk_expr(ctx, cls, meth, item.context_expr, held,
                                    in_while, skip_guard)
            self._walk(ctx, cls, meth, stmt.body, new_held, in_while, skip_guard)
            return
        if isinstance(stmt, ast.While):
            self._check_busy_wait(ctx, cls, stmt, held)
            self._walk_expr(ctx, cls, meth, stmt.test, held, True, skip_guard)
            self._walk(ctx, cls, meth, stmt.body, held, True, skip_guard)
            self._walk(ctx, cls, meth, stmt.orelse, held, in_while, skip_guard)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested function: runs later, not under current locks.
            inner_held: Set[str] = set()
            end = stmt.body[0].lineno if stmt.body else stmt.lineno
            m = ctx.line_directive(_RE_HOLDS, stmt.lineno, max(stmt.lineno, end - 1))
            if m and cls is not None:
                for spec in m.group(1).split(","):
                    if spec.strip():
                        inner_held.add(self._canonical(cls, spec.strip().split(".")))
            self._walk(ctx, cls, f"{meth}.<nested {stmt.name}>", stmt.body,
                       inner_held, False, skip_guard)
            return
        if isinstance(stmt, ast.ClassDef):
            return  # nested classes discovered separately
        # generic statement: walk its expressions/children
        for _child_field, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self._walk_expr(ctx, cls, meth, value, held, in_while, skip_guard)
            elif isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self._walk(ctx, cls, meth, value, held, in_while, skip_guard)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._walk_expr(ctx, cls, meth, v, held, in_while,
                                            skip_guard)
                        elif isinstance(v, ast.stmt):
                            self._walk_stmt(ctx, cls, meth, v, held, in_while,
                                            skip_guard)
                        elif isinstance(v, ast.excepthandler):
                            self._walk(ctx, cls, meth, v.body, held, in_while,
                                       skip_guard)
                        elif isinstance(v, ast.withitem):  # pragma: no cover
                            self._walk_expr(ctx, cls, meth, v.context_expr, held,
                                            in_while, skip_guard)

    def _walk_expr(self, ctx, cls, meth, expr, held, in_while, skip_guard) -> None:
        for node in self._iter_expr(expr):
            if isinstance(node, ast.Lambda):
                if id(node) not in self._handled_lambdas:
                    self._walk_expr(ctx, cls, meth, node.body, set(), False,
                                    skip_guard)
                continue
            if isinstance(node, ast.Call):
                self._check_call(ctx, cls, meth, node, held, in_while)
            elif isinstance(node, ast.Attribute) and not skip_guard:
                self._check_guarded(ctx, cls, node, held)

    def _iter_expr(self, expr: ast.expr):
        """Walk an expression, NOT descending into lambdas (yielded whole) and
        special-casing Condition.wait_for predicates (handled in _check_call)."""
        stack = [expr]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, ast.Lambda):
                continue  # caller decides the held set for the body
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    stack.append(child)
                elif isinstance(child, (ast.comprehension, ast.keyword,
                                        ast.FormattedValue)):
                    stack.append(child)  # type: ignore[arg-type]

    # -- rules --

    def _with_lock_id(self, cls: Optional[str], expr: ast.expr) -> Optional[str]:
        if cls is None:
            return None
        parts = _self_path(expr)
        if parts is None:
            return None
        kind = self._lock_kind(cls, parts)
        if kind in ("lock", "rlock", "condition"):
            return self._canonical(cls, parts)
        return None

    def _check_guarded(
        self, ctx: _FileCtx, cls: Optional[str], node: ast.Attribute, held: Set[str]
    ) -> None:
        if cls is None:
            return
        info = self.classes.get(cls)
        if info is None:
            return
        parts = _self_path(node)
        if parts is None or len(parts) != 1:
            return
        attr = parts[0]
        guard_spec = info.guarded.get(attr)
        if guard_spec is None:
            return
        guard_id = self._canonical(cls, guard_spec.split("."))
        if guard_id not in held:
            self._report(
                ctx, "guarded-by", node.lineno,
                f"{cls}.{attr} is guarded by {guard_id} but accessed without it "
                f"(held: {sorted(held) or 'nothing'})",
            )

    def _check_call(
        self, ctx: _FileCtx, cls: Optional[str], meth: str,
        node: ast.Call, held: Set[str], in_while: bool,
    ) -> None:
        fn = node.func
        # same-class call: defer interprocedural lock-order edges
        if (
            cls is not None
            and isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
        ):
            self.self_calls.setdefault((cls, meth), set()).add(fn.attr)
            if held:
                self.deferred.append((set(held), cls, fn.attr, ctx.path, node.lineno))

        if isinstance(fn, ast.Attribute):
            recv_parts = _self_path(fn.value) if cls is not None else None
            recv_kind = (
                self._lock_kind(cls, recv_parts) if (cls and recv_parts) else None
            )
            recv_is_held_cond = (
                recv_kind == "condition"
                and self._canonical(cls, recv_parts) in held  # type: ignore[arg-type]
            )
            # condition-wait predicate loop rule
            if fn.attr == "wait" and recv_kind == "condition" and not in_while:
                self._report(
                    ctx, "cond-wait-loop", node.lineno,
                    f"Condition.wait on self.{'.'.join(recv_parts)} outside a "
                    "while-predicate loop (spurious wakeups / missed signals)",
                )
            # wait_for predicates run WITH the condition's lock held
            if fn.attr == "wait_for" and recv_is_held_cond:
                lock_id = self._canonical(cls, recv_parts)  # type: ignore[arg-type]
                for arg in node.args:
                    if isinstance(arg, ast.Lambda):
                        self._handled_lambdas.add(id(arg))
                        self._walk_expr(ctx, cls, meth, arg.body,
                                        held | {lock_id}, in_while, False)
            # blocking-call-under-lock
            if held:
                self._check_blocking(ctx, fn, node, held, recv_is_held_cond)
        elif isinstance(fn, ast.Name) and held and fn.id == "sleep":
            self._report(
                ctx, "blocking-under-lock", node.lineno,
                f"sleep() while holding {sorted(held)}",
            )

    def _check_blocking(
        self, ctx: _FileCtx, fn: ast.Attribute, node: ast.Call,
        held: Set[str], recv_is_held_cond: bool,
    ) -> None:
        recv_src = ast.unparse(fn.value)
        if fn.attr == "sleep" and recv_src == "time":
            self._report(
                ctx, "blocking-under-lock", node.lineno,
                f"time.sleep while holding {sorted(held)}",
            )
        elif fn.attr in ("wait", "wait_for"):
            if not recv_is_held_cond:
                self._report(
                    ctx, "blocking-under-lock", node.lineno,
                    f"{recv_src}.{fn.attr}() while holding {sorted(held)} "
                    "(waiting on a foreign primitive under a lock can deadlock)",
                )
        elif fn.attr in ("result", "join"):
            self._report(
                ctx, "blocking-under-lock", node.lineno,
                f"{recv_src}.{fn.attr}() while holding {sorted(held)}",
            )
        elif fn.attr == "step" and ("engine" in recv_src or "proxy" in recv_src):
            self._report(
                ctx, "blocking-under-lock", node.lineno,
                f"engine step {recv_src}.step() while holding {sorted(held)}",
            )

    def _check_busy_wait(
        self, ctx: _FileCtx, cls: Optional[str], loop: ast.While, held: Set[str]
    ) -> None:
        # pattern A: while ...: time.sleep(<= _BUSY_SLEEP_MAX_S)
        stack: List[ast.AST] = [loop]
        flat: List[ast.AST] = []
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) \
                    and cur is not loop:
                continue  # closures run later, their sleeps aren't this loop's
            flat.append(cur)
            stack.extend(ast.iter_child_nodes(cur))
        for node in flat:
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                f = node.func
                if f.attr == "sleep" and isinstance(f.value, ast.Name) \
                        and f.value.id == "time" and node.args:
                    val = _const_number(node.args[0])
                    if val is not None and 0 < val <= _BUSY_SLEEP_MAX_S:
                        self._report(
                            ctx, "busy-wait", node.lineno,
                            f"polling loop: time.sleep({val:g}) in a while loop — "
                            "use a Condition/Event wait",
                        )
        # pattern B: a short const-timeout .wait re-polled every iteration —
        # in the while-condition OR the loop body.  Timed waits on a HELD
        # condition are exempt: that is the correct predicate-loop shape.
        for node in flat:
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "wait":
                if cls is not None:
                    recv = _self_path(node.func.value)
                    if recv and self._lock_kind(cls, recv) == "condition" \
                            and self._canonical(cls, recv) in held:
                        continue
                timeout = None
                if node.args:
                    timeout = _const_number(node.args[0])
                for kw in node.keywords:
                    if kw.arg == "timeout":
                        timeout = _const_number(kw.value)
                if timeout is not None and 0 < timeout <= _POLL_WAIT_MAX_S:
                    self._report(
                        ctx, "busy-wait", loop.lineno,
                        f"timed-wait poll loop: every iteration re-polls "
                        f".wait(timeout={timeout:g}) — wake it by "
                        "event/abort instead",
                    )

    def _check_thread_join(self, ctx: _FileCtx) -> None:
        # aliases: `w = self._watchdog` means joining `w` joins `_watchdog`
        aliases: Dict[str, Set[str]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute):
                aliases.setdefault(node.targets[0].id, set()).add(node.value.attr)
        joined: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                recv = node.func.value
                if isinstance(recv, ast.Attribute):
                    joined.add(recv.attr)
                elif isinstance(recv, ast.Name):
                    joined.add(recv.id)
                    joined |= aliases.get(recv.id, set())
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and self._is_thread_ctor(node.func)):
                continue
            target = self._thread_storage_name(ctx, node)
            if target is None:
                continue  # e.g. appended to a list; leak fixture still catches
            if target not in joined:
                self._report(
                    ctx, "thread-join", node.lineno,
                    f"threading.Thread stored in '{target}' is never joined in "
                    "this module — shutdown path leaks the thread",
                )

    @staticmethod
    def _is_thread_ctor(fn: ast.expr) -> bool:
        if isinstance(fn, ast.Attribute) and fn.attr == "Thread" \
                and isinstance(fn.value, ast.Name) and fn.value.id == "threading":
            return True
        return isinstance(fn, ast.Name) and fn.id == "Thread"

    def _thread_storage_name(self, ctx: _FileCtx, call: ast.Call) -> Optional[str]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and node.value is call:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Attribute):
                    return tgt.attr
                if isinstance(tgt, ast.Name):
                    return tgt.id
        return None

    # ---------------- lock graph ----------------

    def _interprocedural_edges(self) -> None:
        # transitive closure of same-class method acquire sets
        acquires = {k: set(v) for k, v in self.direct_acquires.items()}
        changed = True
        while changed:
            changed = False
            for (cls, meth), callees in self.self_calls.items():
                cur = acquires.setdefault((cls, meth), set())
                for callee in callees:
                    extra = acquires.get((cls, callee))
                    if extra and not extra <= cur:
                        cur |= extra
                        changed = True
        for held, cls, callee, path, line in self.deferred:
            for lock in acquires.get((cls, callee), set()):
                if lock in held:
                    continue  # already held → reentrant, not an ordering edge
                for h in held:
                    self.edges.setdefault((h, lock), (path, line))

    def _cycle_check(self) -> None:
        graph: Dict[str, List[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        color: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(node: str) -> Optional[List[str]]:
            color[node] = 1
            stack.append(node)
            for nxt in graph[node]:
                if color.get(nxt, 0) == 1:
                    return stack[stack.index(nxt):] + [nxt]
                if color.get(nxt, 0) == 0:
                    cyc = dfs(nxt)
                    if cyc:
                        return cyc
            stack.pop()
            color[node] = 2
            return None

        for node in sorted(graph):
            if color.get(node, 0) == 0:
                cyc = dfs(node)
                if cyc:
                    closing = (cyc[-2], cyc[-1])
                    path, line = self.edges.get(closing, ("<lock-graph>", 0))
                    ctx = next((f for f in self.files if f.path == path), None)
                    if ctx is not None and "lock-order" in ctx.disabled(line):
                        return
                    self.violations.append(
                        Violation(
                            "lock-order", path, line,
                            "cycle in lock-acquisition graph: "
                            + " -> ".join(cyc),
                        )
                    )
                    return  # one cycle report is enough; fix and re-run

    def _graph(self) -> dict:
        nodes = sorted({n for e in self.edges for n in e})
        return {
            "source": "static",
            "nodes": nodes,
            "edges": [
                {"from": a, "to": b, "at": f"{p}:{ln}"}
                for (a, b), (p, ln) in sorted(self.edges.items())
            ],
        }


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def check_source(src: str, path: str = "<string>") -> CheckResult:
    """Check a single source string (used by the self-tests)."""
    an = _Analyzer()
    an.add_source(src, path)
    return an.check()


def check_paths(paths: List[str]) -> CheckResult:
    """Check every ``.py`` file under the given files/directories together
    (one shared class registry and lock graph)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for name in sorted(names):
                    if name.endswith(".py"):
                        files.append(os.path.join(root, name))
        elif p.endswith(".py"):
            files.append(p)
    an = _Analyzer()
    for f in sorted(set(files)):
        with open(f, "r", encoding="utf-8") as fh:
            an.add_source(fh.read(), f)
    return an.check()
