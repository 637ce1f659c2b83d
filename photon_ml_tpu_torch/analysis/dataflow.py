"""Flow-sensitive, interprocedural dataflow: the passes behind R13-R16.

Where ``project.py`` answers "who calls whom, and which locks are held?",
this module adds the two ingredients those facts alone cannot express:

- a per-function **control-flow graph** over the stdlib AST (normal edges,
  loop back-edges, and exception edges routed through handlers and
  ``finally`` blocks), so "released on all paths" is a dataflow fact, not
  a grep;
- **worklist fixpoints over the call graph** (reusing the symbol table's
  facade/attr-type resolution), so lock acquisitions and graph-capture
  reachability propagate across call edges instead of stopping at the
  function boundary.

Four rules run on top:

R13 lock-order deadlock: every ``with lock:`` acquisition is an edge
    held-lock -> acquired-lock in a global lock-acquisition graph; a call
    made while holding a lock contributes edges to every lock the callee
    may (transitively) acquire. A cycle means two threads can deadlock by
    acquiring the same locks in opposite orders. The intended global order
    is pinned with ``# photon: lock-order[LockA < LockB]`` (lock names are
    ``Class.attr`` for instance locks, the bare global name for module
    locks); the annotation vouches the contrary edge is impossible and is
    itself checked for use by R12.

R14 resource lifecycle: a Thread / WorkerPool / socket / file / mmap /
    HTTPServer bound to a local name must be closed (joined / stopped /
    shut down) on **every** CFG path, including the paths an exception
    takes. ``with`` blocks and ``try/finally`` release on all paths;
    daemon threads are exempt by design; returning the object, storing it
    on an attribute, or passing it to another call transfers ownership
    (the ``pool=`` idiom in ``io/data.py``) and ends local responsibility.

R15 graph-capture hazards: reachability from a CUDA graph capture region
    (a ``with torch.cuda.graph(...):`` body, or the statements between
    ``capture_begin()`` and ``capture_end()``) is computed over the call
    graph, so a helper three calls below the captured code is held to
    capture discipline too. Python runs once, at capture; the card replays
    what was recorded. Inside reachable scopes: a Python ``if`` / ``while``
    / short-circuit on a tensor, ``float()`` / ``int()`` / ``bool()`` /
    ``.item()`` coercions and host syncs (``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``synchronize``), and host-side mutation of closed-over
    state (``global`` / ``nonlocal`` / ``self.attr`` writes run at capture,
    not per replay). A legitimately static operand is declared with ``#
    photon: static-arg[name]`` on the ``def`` line (validated against the
    real parameter list).

R16 fault-site inventory: the literal ``faults.check(<site>)`` /
    ``faults.corrupt(<site>, ...)`` / ``io_call(..., site=<site>)`` call
    sites, the checked-in ``robust/fault_sites.json``, the port's
    fault-site table, and an at-least-one-test-exercises-it scan of the
    configured test files must agree four ways — the R10 refusal-ledger pattern applied to chaos sites.
    Regenerate the inventory with ``--write-fault-inventory``.

The CFG is deliberately small: one node per statement, ghost nodes for
joins, a merged ``finally`` body (all completion modes flow through one
copy — phantom paths this merge adds can only create extra *reports*,
never hide one). ``break``/``continue``/``return`` route through every
enclosing ``finally`` before reaching their target.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import json
import os
import re
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from .config import LintConfig
from .project import (
    Annotation,
    ProjectFinding,
    _dotted_name,
    _SymbolTable,
    _Scope,
    _type_of_call,
)
from .rules import (
    _dotted,
    _host_sync,
    _names_in_branchable,
    _param_names,
    _sync_call,
    _tensor_taint,
    capture_regions,
    region_nodes,
)

FAULT_INVENTORY_VERSION = 1

_LOCK_ORDER_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_.]*)\s*<\s*([A-Za-z_][A-Za-z0-9_.]*)\s*$"
)


# --------------------------------------------------------------------------
# control-flow graph


class _CFG:
    """One node per statement (plus ghost join/handler/finally nodes).
    ``succ`` are normal-flow edges; ``exc`` are exception edges. ``exit``
    is normal completion (fallthrough or return), ``raised`` the escape of
    an unhandled exception."""

    def __init__(self) -> None:
        self.stmt: List[Optional[ast.stmt]] = []
        self.succ: List[Set[int]] = []
        self.exc: List[Set[int]] = []
        self.entry = self._new(None)
        self.exit = self._new(None)
        self.raised = self._new(None)

    def _new(self, stmt: Optional[ast.stmt]) -> int:
        self.stmt.append(stmt)
        self.succ.append(set())
        self.exc.append(set())
        return len(self.stmt) - 1


def _may_raise(stmt: ast.stmt) -> bool:
    """Whether executing the statement can plausibly raise: calls, raises,
    and asserts. Attribute/subscript errors exist too, but flagging every
    ``a.b`` would drown the exception-path analysis in noise."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Call, ast.Raise, ast.Assert)):
            return True
    return False


class _CFGBuilder:
    def __init__(self) -> None:
        self.cfg = _CFG()
        # innermost-last: where an exception thrown "here" can land
        self.exc_stack: List[List[int]] = [[self.cfg.raised]]
        # entry nodes of enclosing finally blocks, outermost-first
        self.fin_stack: List[int] = []
        # (break_sink, continue_target, fin_depth) per enclosing loop
        self.loop_stack: List[Tuple[int, int, int]] = []
        # finally entry -> extra targets its exit nodes must reach (jumps
        # routed through it); consumed when the owning try is finished
        self.pending: Dict[int, Set[int]] = {}

    def build(self, body: Sequence[ast.stmt]) -> _CFG:
        out = self._stmts(body, {self.cfg.entry})
        for n in out:
            self.cfg.succ[n].add(self.cfg.exit)
        return self.cfg

    # -- plumbing ----------------------------------------------------------

    def _exc_targets(self) -> List[int]:
        return self.exc_stack[-1]

    def _route_jump(self, node: int, target: int, fin_depth: int) -> None:
        """Wire a return/break/continue from ``node`` to ``target``, running
        every enclosing finally below ``fin_depth`` on the way (innermost
        first)."""
        fins = self.fin_stack[fin_depth:]
        if not fins:
            self.cfg.succ[node].add(target)
            return
        self.cfg.succ[node].add(fins[-1])
        for i in range(len(fins) - 1, 0, -1):
            self.pending.setdefault(fins[i], set()).add(fins[i - 1])
        self.pending.setdefault(fins[0], set()).add(target)

    # -- statement sequences ----------------------------------------------

    def _stmts(self, stmts: Sequence[ast.stmt], frontier: Set[int]) -> Set[int]:
        for stmt in stmts:
            frontier = self._stmt(stmt, frontier)
        return frontier

    def _stmt(self, stmt: ast.stmt, frontier: Set[int]) -> Set[int]:
        cfg = self.cfg
        node = cfg._new(stmt)
        for f in frontier:
            cfg.succ[f].add(node)

        if isinstance(stmt, (ast.If,)):
            body_out = self._stmts(stmt.body, {node})
            orelse_out = self._stmts(stmt.orelse, {node}) if stmt.orelse else {node}
            if _may_raise_expr(stmt.test):
                cfg.exc[node].update(self._exc_targets())
            return body_out | orelse_out

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            after = cfg._new(None)
            if isinstance(stmt, ast.While):
                head_exits = not (
                    isinstance(stmt.test, ast.Constant) and stmt.test.value
                )
            else:
                head_exits = True  # iterator exhaustion
                cfg.exc[node].update(self._exc_targets())
            if isinstance(stmt, ast.While) and _may_raise_expr(stmt.test):
                cfg.exc[node].update(self._exc_targets())
            self.loop_stack.append((after, node, len(self.fin_stack)))
            body_out = self._stmts(stmt.body, {node})
            for n in body_out:
                cfg.succ[n].add(node)  # back edge
            self.loop_stack.pop()
            if head_exits:
                orelse_out = (
                    self._stmts(stmt.orelse, {node}) if stmt.orelse else {node}
                )
                for n in orelse_out:
                    cfg.succ[n].add(after)
            return {after}

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # only the context expressions / __enter__ run at this node; the
            # body's statements get their own nodes (and their own exc edges)
            if any(_may_raise_expr(i.context_expr) for i in stmt.items):
                cfg.exc[node].update(self._exc_targets())
            return self._stmts(stmt.body, {node})

        if isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            return self._try(stmt, node)

        if isinstance(stmt, ast.Match):
            outs: Set[int] = {node}
            for case in stmt.cases:
                outs |= self._stmts(case.body, {node})
            return outs

        if isinstance(stmt, ast.Return):
            self._route_jump(node, cfg.exit, 0)
            if _may_raise(stmt):
                cfg.exc[node].update(self._exc_targets())
            return set()

        if isinstance(stmt, ast.Raise):
            cfg.exc[node].update(self._exc_targets())
            return set()

        if isinstance(stmt, ast.Break) and self.loop_stack:
            sink, _, depth = self.loop_stack[-1]
            self._route_jump(node, sink, depth)
            return set()

        if isinstance(stmt, ast.Continue) and self.loop_stack:
            _, head, depth = self.loop_stack[-1]
            self._route_jump(node, head, depth)
            return set()

        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return {node}  # separate scope; the def itself cannot raise

        if _may_raise(stmt):
            cfg.exc[node].update(self._exc_targets())
        return {node}

    def _try(self, stmt: ast.Try, node: int) -> Set[int]:
        cfg = self.cfg
        catch_nodes = [cfg._new(None) for _ in stmt.handlers]
        fin_entry = cfg._new(None) if stmt.finalbody else None

        # an exception in the body reaches each handler, or — uncaught —
        # escapes via the finally (when present) or the outer targets; a
        # catch-all handler absorbs the escape (else `except: cleanup();
        # raise` could never satisfy the exception-path analysis)
        catch_all = any(
            h.type is None
            or (
                isinstance(h.type, ast.Name)
                and h.type.id in ("Exception", "BaseException")
            )
            for h in stmt.handlers
        )
        escalation: List[int]
        if catch_all:
            escalation = []
        elif fin_entry is not None:
            escalation = [fin_entry]
        else:
            escalation = list(self._exc_targets())
        self.exc_stack.append(catch_nodes + escalation)
        if fin_entry is not None:
            self.fin_stack.append(fin_entry)
        body_out = self._stmts(stmt.body, {node})
        self.exc_stack.pop()

        # orelse and handler bodies are not protected by this try's handlers
        if fin_entry is not None:
            self.exc_stack.append([fin_entry])
        orelse_out = (
            self._stmts(stmt.orelse, body_out) if stmt.orelse else body_out
        )
        handler_outs: Set[int] = set()
        for ghost, h in zip(catch_nodes, stmt.handlers):
            handler_outs |= self._stmts(h.body, {ghost})
        if fin_entry is not None:
            self.exc_stack.pop()
            self.fin_stack.pop()

        if fin_entry is None:
            return orelse_out | handler_outs

        for n in orelse_out | handler_outs:
            cfg.succ[n].add(fin_entry)
        fin_out = self._stmts(stmt.finalbody, {fin_entry})
        # the merged finally continues every way it was entered: normally to
        # the next statement (the returned frontier), exceptionally outward,
        # and to any jump target routed through it
        for n in fin_out:
            cfg.exc[n].update(self._exc_targets())
            for target in self.pending.pop(fin_entry, ()):
                cfg.succ[n].add(target)
        return fin_out


def _may_raise_expr(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) for n in ast.walk(expr))


def build_cfg(fn: ast.AST) -> _CFG:
    """The statement-level CFG of one function body."""
    return _CFGBuilder().build(getattr(fn, "body", []))


# --------------------------------------------------------------------------
# R14: resource lifecycle


# constructor tails that produce a releasable resource, by kind
_RESOURCE_CLASS_TAILS = {
    "WorkerPool": "worker pool",
    "PrefetchQueue": "prefetch queue",
    "ThreadPoolExecutor": "executor",
    "ProcessPoolExecutor": "executor",
    "HTTPServer": "HTTP server",
    "ThreadingHTTPServer": "HTTP server",
    "TCPServer": "socket server",
    "ThreadingTCPServer": "socket server",
    "UDPServer": "socket server",
}
_RELEASE_METHODS = {
    "close",
    "join",
    "stop",
    "shutdown",
    "server_close",
    "release",
    "terminate",
    "detach",
    "unlink",
}

_OPEN, _CLOSED, _PENDING = "open", "closed", "pending"


def _resource_kind(
    value: ast.AST, aliases: Dict[str, str]
) -> Optional[Tuple[str, bool]]:
    """(kind, starts_pending) when ``value`` constructs a tracked resource.
    Threads start *pending*: an unstarted thread holds no OS resource, so
    only a ``.start()``ed non-daemon thread must be joined or handed off."""
    ty = _type_of_call(value, aliases)
    if ty is None:
        return None
    if ty in ("threading.Thread", "threading.Timer"):
        assert isinstance(value, ast.Call)
        for kw in value.keywords:
            if (
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value
            ):
                return None  # daemon threads die with the process, by design
        return ("thread", True)
    if ty in ("socket.socket", "socket.create_connection", "socket.create_server"):
        return ("socket", False)
    if ty in ("open", "io.open"):
        return ("file", False)
    if ty == "mmap.mmap":
        return ("mmap", False)
    tail = ty.rsplit(".", 1)[-1]
    kind = _RESOURCE_CLASS_TAILS.get(tail)
    if kind is not None:
        return (kind, False)
    return None


@dataclasses.dataclass
class _Resource:
    kind: str
    line: int
    statuses: FrozenSet[str]


_State = Dict[str, _Resource]


def _merge_states(a: _State, b: _State) -> _State:
    out = dict(a)
    for var, res in b.items():
        cur = out.get(var)
        if cur is None or (cur.kind, cur.line) != (res.kind, res.line):
            out[var] = res
        elif cur.statuses != res.statuses:
            out[var] = _Resource(cur.kind, cur.line, cur.statuses | res.statuses)
    return out


def _states_equal(a: _State, b: _State) -> bool:
    if a.keys() != b.keys():
        return False
    return all(
        a[k].kind == b[k].kind
        and a[k].line == b[k].line
        and a[k].statuses == b[k].statuses
        for k in a
    )


def _scan_roots(stmt: ast.stmt) -> List[ast.AST]:
    """The expression roots a compound statement's CFG node *itself*
    evaluates — its nested statements have their own nodes, so scanning the
    whole subtree here would e.g. see a ``finally``'s close at the ``try``
    header and call the resource released before anything ran."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(
        stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ):
        return []
    return [stmt]


def _escape_roots(stmt: ast.stmt) -> List[ast.AST]:
    """Like ``_scan_roots`` but a nested def/class scans its whole body: a
    closure capturing the resource takes shared ownership (it may be the
    designated closer), so local responsibility ends."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return [stmt]
    if isinstance(stmt, (ast.If, ast.While)):
        return []  # branch tests (`if sock:`, `if f is None`) do not escape
    return _scan_roots(stmt)


def _mentions_escape(stmt: ast.stmt, var: str) -> bool:
    """Whether this node lets ``var`` escape local ownership: returned,
    raised, yielded, stored anywhere but a fresh local name, aliased,
    passed as a call argument, or captured by a nested def. Method calls
    *on* the resource and branch tests do not escape it."""
    for root in _escape_roots(stmt):
        # any mention inside a nested def/lambda/class is a closure capture
        # — shared ownership — even a plain `f.close()` receiver there
        inner: Set[int] = set()
        for d in ast.walk(root):
            if isinstance(
                d,
                (
                    ast.FunctionDef,
                    ast.AsyncFunctionDef,
                    ast.Lambda,
                    ast.ClassDef,
                ),
            ):
                inner.update(id(n) for n in ast.walk(d) if n is not d)
        receiver_loads: Set[int] = set()
        for node in ast.walk(root):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == var
                and isinstance(node.value.ctx, ast.Load)
                and id(node.value) not in inner
            ):
                receiver_loads.add(id(node.value))
        for node in ast.walk(root):
            if (
                isinstance(node, ast.Name)
                and node.id == var
                and isinstance(node.ctx, ast.Load)
                and id(node) not in receiver_loads
            ):
                return True
    return False


def _released_methods(roots: Sequence[ast.AST], state: _State) -> Set[str]:
    """Tracked vars a release-method call in these expressions closes."""
    out: Set[str] = set()
    for root in roots:
        for node in ast.walk(root):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RELEASE_METHODS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in state
            ):
                out.add(node.func.value.id)
    return out


def _r14_transfer(
    stmt: Optional[ast.stmt], state: _State, aliases: Dict[str, str]
) -> Tuple[_State, Set[str], Set[str]]:
    """(post-state, vars created by this statement, vars started by it).
    Exception edges carry the post-state minus the created vars — if the
    constructor itself raised, there is nothing to leak — and with started
    threads reverted to pending: if ``.start()`` raised, nothing ran."""
    if stmt is None:
        return state, set(), set()
    out = dict(state)
    created: Set[str] = set()
    started: Set[str] = set()

    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        # a with-managed resource is released on every path by __exit__
        for item in stmt.items:
            ce = item.context_expr
            if isinstance(ce, ast.Name) and ce.id in out:
                res = out[ce.id]
                out[ce.id] = _Resource(res.kind, res.line, frozenset({_CLOSED}))
        return out, created, started

    roots = _scan_roots(stmt)

    # releases happen before escapes so `x.close(); return x` stays clean
    for var in _released_methods(roots, out):
        res = out[var]
        status = frozenset({_CLOSED})
        out[var] = _Resource(res.kind, res.line, status)

    # thread start: pending -> open; `x.daemon = True` exempts
    for node in (n for root in roots for n in ast.walk(root)):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "start"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in out
        ):
            res = out[node.func.value.id]
            if _PENDING in res.statuses:
                out[node.func.value.id] = _Resource(
                    res.kind, res.line, frozenset({_OPEN})
                )
                started.add(node.func.value.id)
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Attribute)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id in out
            and node.targets[0].attr == "daemon"
            and isinstance(node.value, ast.Constant)
            and node.value.value
        ):
            out.pop(node.targets[0].value.id, None)

    # escapes: ownership transferred, no longer our problem
    for var in [v for v in out if _mentions_escape(stmt, v)]:
        out.pop(var, None)

    # creations (last: `x = socket.socket()` must not self-escape on the
    # constructor argument scan above)
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        t = stmt.targets[0]
        if isinstance(t, ast.Name):
            rk = _resource_kind(stmt.value, aliases)
            if rk is not None:
                kind, pending = rk
                out[t.id] = _Resource(
                    kind,
                    stmt.lineno,
                    frozenset({_PENDING if pending else _OPEN}),
                )
                created.add(t.id)
            elif t.id in out and not isinstance(stmt.value, ast.Name):
                out.pop(t.id)  # rebound to something else
    return out, created, started


def run_r14(table: _SymbolTable) -> List[ProjectFinding]:
    findings: List[ProjectFinding] = []
    seen: Set[Tuple[str, int]] = set()
    for key in sorted(table.scopes):
        scope = table.scopes[key]
        mod = table.modules[scope.file]
        fn = scope.node
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cfg = build_cfg(fn)
        n = len(cfg.stmt)
        in_states: List[Optional[_State]] = [None] * n
        in_states[cfg.entry] = {}
        work = [cfg.entry]
        # forward may-analysis to a fixpoint: statuses accumulate per path
        guard = 0
        while work and guard < 50 * n + 1000:
            guard += 1
            node = work.pop()
            state = in_states[node] or {}
            post, created, started = _r14_transfer(
                cfg.stmt[node], state, mod.aliases
            )
            exc_post = dict(post)
            for var in created:
                exc_post.pop(var, None)
                if var in state:
                    exc_post[var] = state[var]
            for var in started:
                res = exc_post.get(var)
                if res is not None:
                    exc_post[var] = _Resource(
                        res.kind, res.line, frozenset({_PENDING})
                    )
            for target, carried in (
                *((s, post) for s in cfg.succ[node]),
                *((s, exc_post) for s in cfg.exc[node]),
            ):
                merged = (
                    dict(carried)
                    if in_states[target] is None
                    else _merge_states(in_states[target], carried)
                )
                if in_states[target] is None or not _states_equal(
                    in_states[target], merged
                ):
                    in_states[target] = merged
                    work.append(target)

        exit_state = in_states[cfg.exit] or {}
        raised_state = in_states[cfg.raised] or {}
        for var in sorted(exit_state):
            res = exit_state[var]
            if _OPEN in res.statuses and (scope.file, res.line) not in seen:
                seen.add((scope.file, res.line))
                findings.append(
                    ProjectFinding(
                        file=scope.file,
                        line=res.line,
                        col=0,
                        rule="R14",
                        message=(
                            f"{res.kind} {var!r} created here is not "
                            "closed/joined/stopped on every path out of "
                            f"{_qual_display(scope)} — release it in a "
                            "finally, use `with`, or hand ownership off "
                            "(return it / store it / pass it on)"
                        ),
                    )
                )
        for var in sorted(raised_state):
            res = raised_state[var]
            if _OPEN in res.statuses and (scope.file, res.line) not in seen:
                seen.add((scope.file, res.line))
                findings.append(
                    ProjectFinding(
                        file=scope.file,
                        line=res.line,
                        col=0,
                        rule="R14",
                        message=(
                            f"{res.kind} {var!r} created here leaks when an "
                            f"exception escapes {_qual_display(scope)} — "
                            "move the release into try/finally or use "
                            "`with` so the exception path releases it too"
                        ),
                    )
                )
    return findings


def _qual_display(scope: _Scope) -> str:
    return f"{scope.qualname}()"


# --------------------------------------------------------------------------
# R13: lock-order deadlock detection


def _canon_lock(scope: _Scope, guard: str) -> str:
    """Guard names from the body walker are ``self.attr`` (ambiguous across
    classes) or ``file:name`` (already canonical). Qualify the former with
    the scope's class so the global lock graph never conflates two classes'
    ``_lock`` attributes."""
    if guard.startswith("self.") and scope.class_name:
        return f"{scope.file}::{scope.class_name}.{guard[5:]}"
    return guard


def _lock_display(canon: str, table: _SymbolTable) -> str:
    if "::" in canon:
        return canon.split("::", 1)[1]  # Class.attr
    if ":" in canon:
        file, name = canon.split(":", 1)
        mod = table.modules.get(file)
        return f"{mod.dotted}.{name}" if mod else name
    return canon


def _resolve_lock_token(
    token: str, known: Mapping[str, str]
) -> Optional[List[str]]:
    """Canonical lock ids a ``lock-order[...]`` token names: an exact
    ``Class.attr`` / dotted-global display match, or a bare attribute name
    (matching every class that has it — the annotation then pins the order
    for all of them)."""
    exact = [c for c, disp in known.items() if disp == token]
    if exact:
        return exact
    suffix = [
        c
        for c, disp in known.items()
        if disp.rsplit(".", 1)[-1] == token
    ]
    return suffix or None


def run_r13(
    table: _SymbolTable,
    annotations: Sequence[Annotation],
) -> Tuple[List[ProjectFinding], List[str], Set[Tuple[str, int]]]:
    findings: List[ProjectFinding] = []
    errors: List[str] = []
    used: Set[Tuple[str, int]] = set()

    # transitive may-acquire per scope (worklist over reversed call edges)
    local_acquires: Dict[Tuple[str, str], Set[str]] = {}
    callers_of: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for key, scope in table.scopes.items():
        local_acquires[key] = {
            _canon_lock(scope, lock) for (lock, _held, _line) in scope.acquires
        }
        for cs in scope.calls:
            callers_of.setdefault(cs.callee, []).append(key)
    may_acquire = {k: set(v) for k, v in local_acquires.items()}
    work = [k for k, v in may_acquire.items() if v]
    while work:
        key = work.pop()
        for caller in callers_of.get(key, ()):
            if caller not in may_acquire:
                continue
            before = len(may_acquire[caller])
            may_acquire[caller] |= may_acquire[key]
            if len(may_acquire[caller]) != before:
                work.append(caller)

    # edges held -> acquired, with a witness site each
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add_edge(held: str, acquired: str, file: str, line: int, how: str):
        if held != acquired:
            edges.setdefault((held, acquired), (file, line, how))

    for key in sorted(table.scopes):
        scope = table.scopes[key]
        for lock, held, line in scope.acquires:
            acq = _canon_lock(scope, lock)
            for h in held:
                add_edge(
                    _canon_lock(scope, h), acq, scope.file, line, "acquired"
                )
        for cs in scope.calls:
            if not cs.guards:
                continue
            callee_locks = may_acquire.get(cs.callee, set())
            for h in cs.guards:
                hc = _canon_lock(scope, h)
                for acq in callee_locks:
                    if acq in {_canon_lock(scope, g) for g in cs.guards}:
                        continue  # already held across the call
                    add_edge(
                        hc,
                        acq,
                        scope.file,
                        cs.line,
                        f"acquired inside {cs.callee[1]}()",
                    )

    known: Dict[str, str] = {}
    for canon in {l for e in edges for l in e} | {
        l for acc in local_acquires.values() for l in acc
    }:
        known[canon] = _lock_display(canon, table)

    # lock-order annotations: validated, then the contrary edge is dropped
    for ann in annotations:
        if ann.kind != "lock-order":
            continue
        m = _LOCK_ORDER_RE.match(ann.lock or "")
        if m is None:
            errors.append(
                f"annotation: {ann.file}:{ann.line}: lock-order"
                f"[{ann.lock}] is malformed — expected "
                "'lock-order[LockA < LockB]' with lock names like "
                "'Class.attr' or a module-level lock name"
            )
            continue
        first = _resolve_lock_token(m.group(1), known)
        second = _resolve_lock_token(m.group(2), known)
        for tok, res in ((m.group(1), first), (m.group(2), second)):
            if res is None:
                errors.append(
                    f"{ann.file}:{ann.line}: lock-order[{ann.lock}] names "
                    f"unknown lock {tok!r} (known: "
                    f"{sorted(set(known.values())) or 'none'})"
                )
        if first is None or second is None:
            continue
        for a in first:
            for b in second:
                if (b, a) in edges:
                    edges.pop((b, a))
                    used.add((ann.file, ann.line))

    # cycles: strongly connected components of the remaining edge set
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    for comp in _sccs(graph):
        if len(comp) < 2:
            continue
        comp_sorted = sorted(comp, key=lambda c: known.get(c, c))
        names = " / ".join(known.get(c, c) for c in comp_sorted)
        witnesses = sorted(
            (known.get(a, a), known.get(b, b), edges[(a, b)])
            for (a, b) in edges
            if a in comp and b in comp
        )
        detail = "; ".join(
            f"{a} held while {b} {w[2]} at {w[0]}:{w[1]}"
            for a, b, w in witnesses[:4]
        )
        file, line, _ = witnesses[0][2]
        da, db = witnesses[0][0], witnesses[0][1]
        findings.append(
            ProjectFinding(
                file=file,
                line=line,
                col=0,
                rule="R13",
                message=(
                    f"lock-order cycle between {names}: {detail} — two "
                    "threads taking these locks in opposite orders "
                    "deadlock; fix one side's order, or pin the intended "
                    f"global order with # photon: lock-order[{da} < {db}] "
                    "and an invariant comment at the vouched-safe site"
                ),
            )
        )
    return findings, errors, used


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Tarjan, iteratively (lint runs on deep graphs with small stacks)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    for root in sorted(graph):
        if root in index:
            continue
        work: List[Tuple[str, List[str]]] = [(root, sorted(graph[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, succs = work[-1]
            if succs:
                w = succs.pop(0)
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, sorted(graph[w])))
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            else:
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
                if low[v] == index[v]:
                    comp: Set[str] = set()
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.add(w)
                        if w == v:
                            break
                    out.append(comp)
    return out


# --------------------------------------------------------------------------
# R15: graph-capture hazards by call-graph reachability


def _capture_callees(
    scope: _Scope, aliases: Dict[str, str]
) -> Set[Tuple[str, str]]:
    """Scopes called from inside a capture region of ``scope``'s body."""
    fn = scope.node
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    lines: Set[int] = set()
    for region in capture_regions(fn, aliases):
        for node in region_nodes(region):
            if isinstance(node, ast.Call):
                lines.add(node.lineno)
    return {cs.callee for cs in scope.calls if cs.line in lines}


def _static_arg_annotations(
    annotations: Sequence[Annotation],
    table: _SymbolTable,
) -> Tuple[Dict[Tuple[str, str], Set[Tuple[str, Annotation]]], List[str]]:
    """static-arg annotations resolved to (scope key -> {(param, ann)}),
    validated against the real parameter list."""
    out: Dict[Tuple[str, str], Set[Tuple[str, Annotation]]] = {}
    errors: List[str] = []
    for ann in annotations:
        if ann.kind != "static-arg":
            continue
        owner: Optional[_Scope] = None
        for key, scope in table.scopes.items():
            fn = scope.node
            if key[0] != ann.file or not isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            first = min(
                [fn.lineno]
                + [d.lineno for d in (fn.decorator_list or [])]
            )
            if first <= ann.line <= fn.body[0].lineno:
                owner = scope
                break
        if owner is None:
            errors.append(
                f"{ann.file}:{ann.line}: static-arg annotation is not "
                "attached to a function definition"
            )
            continue
        params = set(_param_names(owner.node))
        if ann.lock not in params:
            errors.append(
                f"{ann.file}:{ann.line}: static-arg[{ann.lock}] matches no "
                f"parameter of {owner.qualname}() (parameters: "
                f"{sorted(params)})"
            )
            continue
        out.setdefault(owner.key, set()).add((ann.lock, ann))
    return out, errors


def run_r15(
    table: _SymbolTable,
    annotations: Sequence[Annotation],
) -> Tuple[List[ProjectFinding], List[str], Set[Tuple[str, int]]]:
    findings: List[ProjectFinding] = []
    used: Set[Tuple[str, int]] = set()

    static_by_scope, errors = _static_arg_annotations(annotations, table)

    # reachability from the capture regions, with the capturing scope as the
    # witness for the message; the regions themselves belong to R2
    via: Dict[Tuple[str, str], Tuple[str, str]] = {}
    work = []
    for key in sorted(table.scopes):
        scope = table.scopes[key]
        mod = table.modules[scope.file]
        for callee in sorted(_capture_callees(scope, mod.aliases)):
            if callee in table.scopes and callee not in via:
                via[callee] = key
                work.append(callee)
    while work:
        key = work.pop()
        scope = table.scopes.get(key)
        if scope is None:
            continue
        for cs in scope.calls:
            if cs.callee in table.scopes and cs.callee not in via:
                via[cs.callee] = via[key]
                work.append(cs.callee)

    for key in sorted(via):
        scope = table.scopes[key]
        fn = scope.node
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mod = table.modules[scope.file]
        aliases = mod.aliases
        root_name = table.scopes[via[key]].qualname
        excused: Dict[str, Annotation] = {
            name: ann for name, ann in static_by_scope.get(key, ())
        }
        traced = _tensor_taint(fn, aliases) - set(excused)
        suspects = traced | set(excused)
        reach = f"reachable from CUDA graph capture in {root_name}()"

        def flag(line: int, col: int, message: str) -> None:
            findings.append(
                ProjectFinding(
                    file=scope.file, line=line, col=col, rule="R15",
                    message=message,
                )
            )

        def excuse_or_flag(names: Set[str], line: int, col: int, what: str):
            for name in sorted(names):
                if name in excused:
                    used.add((excused[name].file, excused[name].line))
                    continue
                flag(
                    line,
                    col,
                    f"{what} tensor value {name!r} in {scope.qualname}(), "
                    f"{reach} — Python runs once at capture and the card "
                    "replays the recording: use torch.where, hoist the "
                    "value out of the capture, or declare # photon: "
                    f"static-arg[{name}] on the def line if it is "
                    "legitimately static",
                )

        for node in _own_nodes_of(fn):
            if isinstance(node, (ast.If, ast.While)):
                names = _names_in_branchable(node.test, aliases)
                excuse_or_flag(
                    names & suspects,
                    node.lineno,
                    node.col_offset,
                    "Python branch on",
                )
            elif isinstance(node, ast.BoolOp):
                names = _names_in_branchable(node, aliases)
                excuse_or_flag(
                    names & suspects,
                    node.lineno,
                    node.col_offset,
                    "short-circuit on",
                )
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if (
                    d in ("float", "int", "bool")
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in suspects
                ):
                    excuse_or_flag(
                        {node.args[0].id},
                        node.lineno,
                        node.col_offset,
                        f"{d}() coercion of",
                    )
                    continue
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "item"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in suspects
                ):
                    excuse_or_flag(
                        {node.func.value.id},
                        node.lineno,
                        node.col_offset,
                        ".item() coercion of",
                    )
                    continue
                what = _host_sync(node, traced, aliases) or _sync_call(
                    node, aliases
                )
                if what:
                    flag(
                        node.lineno,
                        node.col_offset,
                        f"{what} syncs the host in {scope.qualname}(), "
                        f"{reach} — a sync is illegal while the stream "
                        "captures: move it before the capture or after the "
                        "replay",
                    )
        # host-side mutation of closed-over state
        declared: Set[str] = set()
        for node in _own_nodes_of(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                declared.update(node.names)
        for node in _own_nodes_of(fn):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in declared:
                    flag(
                        node.lineno,
                        node.col_offset,
                        f"write to closed-over {t.id!r} in "
                        f"{scope.qualname}() runs once at capture, not per "
                        "replay — a capture-reachable function must not "
                        "mutate host state (return the value instead)",
                    )
                elif (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    flag(
                        node.lineno,
                        node.col_offset,
                        f"write to self.{t.attr} in {scope.qualname}() "
                        "runs once at capture, not per replay — a "
                        "capture-reachable method must not mutate host "
                        "state (return the value instead)",
                    )
    return findings, errors, used


def _own_nodes_of(fn: ast.AST) -> List[ast.AST]:
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


# --------------------------------------------------------------------------
# R16: fault-site inventory


@dataclasses.dataclass(frozen=True)
class FaultSite:
    site: str
    file: str
    line: int


def extract_fault_sites(sources: Mapping[str, str]) -> List[FaultSite]:
    """Literal chaos-site declarations: ``faults.check(<site>)`` /
    ``faults.corrupt(<site>, ...)`` and ``io_call(..., site=<site>)``.
    Dynamic sites (a variable argument) are invisible to the inventory and
    deliberately skipped — their literal spellings appear at the io_call
    layer."""
    out: List[FaultSite] = []
    for rel in sorted(sources):
        try:
            tree = ast.parse(sources[rel], filename=rel)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            site: Optional[str] = None
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("check", "corrupt")
                and (_dotted_name(node.func.value) or "").split(".")[-1]
                == "faults"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                site = node.args[0].value
            else:
                d = _dotted_name(node.func) or ""
                if d.split(".")[-1] == "io_call":
                    for kw in node.keywords:
                        if (
                            kw.arg == "site"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)
                        ):
                            site = kw.value.value
            if site:
                out.append(FaultSite(site=site, file=rel, line=node.lineno))
    return out


@dataclasses.dataclass(frozen=True)
class FaultRow:
    site: str
    line: int


def parse_fault_table(markdown: str) -> List[FaultRow]:
    """Rows of the ``| fault site | ... |`` table: the backticked site name
    in the first column (same parser discipline as the refusal ledger)."""
    rows: List[FaultRow] = []
    in_table = False
    for lineno, line in enumerate(markdown.splitlines(), start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if not in_table:
            if cells and cells[0].lower() == "fault site":
                in_table = True
            continue
        if cells and set(cells[0]) <= {"-", " ", ":"}:
            continue
        site = cells[0]
        if site.startswith("`") and site.endswith("`"):
            site = site[1:-1]
        if site:
            rows.append(FaultRow(site=site, line=lineno))
    return rows


def build_fault_inventory(sites: Sequence[FaultSite]) -> Dict:
    """One entry per distinct site with the modules declaring it. No line
    numbers on purpose — the inventory should churn only when the chaos
    surface does, not when code moves."""
    by_site: Dict[str, Set[str]] = {}
    for s in sites:
        by_site.setdefault(s.site, set()).add(s.file)
    return {
        "version": FAULT_INVENTORY_VERSION,
        "sites": [
            {"site": site, "modules": sorted(by_site[site])}
            for site in sorted(by_site)
        ],
    }


def render_fault_inventory(doc: Dict) -> str:
    return json.dumps(doc, indent=2) + "\n"


def _test_files(root: str, tests: str) -> List[str]:
    """The test files R16 scans: every ``.py`` under ``tests`` when it names
    a directory, else the files its glob pattern matches."""
    path = os.path.join(root, tests)
    if os.path.isdir(path):
        out: List[str] = []
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            out.extend(
                os.path.join(dirpath, n)
                for n in sorted(filenames)
                if n.endswith(".py")
            )
        return out
    return sorted(glob.glob(path))


def _test_literals(root: str, tests: str) -> List[str]:
    """Every string literal in the test files, for site-exercise checks."""
    out: List[str] = []
    for path in _test_files(root, tests):
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                out.append(node.value)
    return out


def run_r16(
    sources: Mapping[str, str], config: LintConfig
) -> Tuple[List[ProjectFinding], Optional[Dict]]:
    sites = extract_fault_sites(sources)
    inventory = build_fault_inventory(sites)

    docs_path = os.path.join(config.root, config.fault_docs)
    docs_rows: List[FaultRow] = []
    docs_exists = os.path.isfile(docs_path)
    if docs_exists:
        with open(docs_path, encoding="utf-8") as f:
            docs_rows = parse_fault_table(f.read())

    inv_path = os.path.join(config.root, config.fault_inventory)
    inv_exists = os.path.isfile(inv_path)
    if not sites and not docs_rows and not inv_exists:
        return [], None  # no chaos machinery in this tree at all

    findings: List[ProjectFinding] = []

    def add(file: str, line: int, message: str) -> None:
        findings.append(
            ProjectFinding(
                file=file, line=line, col=0, rule="R16", message=message
            )
        )

    first_site: Dict[str, FaultSite] = {}
    for s in sites:
        first_site.setdefault(s.site, s)
    documented = {r.site for r in docs_rows}

    # code -> docs
    for site in sorted(first_site):
        if site not in documented:
            s = first_site[site]
            add(
                s.file,
                s.line,
                f"fault site {site!r} is not documented in the "
                f"{config.fault_docs} fault-site table — every "
                "PHOTON_FAULTS site must be discoverable from the docs",
            )
    # docs -> code
    for row in docs_rows:
        if row.site not in first_site:
            add(
                config.fault_docs,
                row.line,
                f"documented fault site {row.site!r} matches no "
                "faults.check/corrupt or io_call site= literal — stale "
                "docs or a renamed site",
            )
    # code -> tests: at least one test must exercise each site
    literals = _test_literals(config.root, config.fault_tests)
    for site in sorted(first_site):
        if not any(site in lit for lit in literals):
            s = first_site[site]
            add(
                s.file,
                s.line,
                f"no test exercises fault site {site!r} (no string literal "
                f"in {config.fault_tests} mentions it) — add a "
                "PHOTON_FAULTS / faults.configure case",
            )

    # inventory staleness (byte-for-byte, like refusals.json)
    want = render_fault_inventory(inventory)
    have = None
    if inv_exists:
        with open(inv_path, encoding="utf-8") as f:
            have = f.read()
    if have != want:
        state = "stale" if have is not None else "missing"
        add(
            config.fault_inventory,
            1,
            f"fault inventory is {state}; regenerate with "
            "--write-fault-inventory",
        )
    return findings, inventory
