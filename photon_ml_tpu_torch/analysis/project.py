"""Whole-program analysis: the cross-module passes behind rules R9-R11.

Where ``rules.py`` checks one module at a time, this pass first builds a
package-wide picture — a symbol table of every class / method / function, a
call graph between them, and the set of thread entrypoints — and then runs
three analyses no single file can express:

R9 thread-context races. Thread entrypoints are discovered structurally
   (``threading.Thread(target=...)`` / ``threading.Timer``, ``.submit(fn)``
   worker-pool handoffs, ``.add_done_callback`` completion callbacks,
   ``BaseHTTPRequestHandler`` subclasses) plus the configured
   ``thread_entrypoints`` for callbacks the graph cannot resolve (a bound
   method stored on another object and invoked from its thread). Each
   entrypoint seeds a distinct execution context; contexts propagate through
   the call graph. An instance attribute or module global *written* in one
   context and *read or written* in another must have a common lock held on
   both sides — held lexically (``with self._lock:``) or inherited from the
   call sites (a private helper whose every caller already holds the lock).
   Intent that the graph cannot see is declared on the attribute's assignment
   line:

       self._live = live  # photon: guarded-by[_refresh_lock]
       self._value = None  # photon: thread-confined — handoff via _done Event

   ``guarded-by`` names must resolve to a real lock attribute (unknown names
   are an analysis error, like an unknown ``ignore[RULE]``); both annotation
   kinds are themselves checked for use (rule R12 flags an annotation that
   suppresses nothing).

R10 refusal-ledger consistency. Every ``raise ValueError(...)`` /
   ``NotImplementedError(...)`` with a statically-known message template is
   extracted and cross-checked against the README refusal ledger (shared
   with the JAX package: the port refuses in its words) and the
   ``tests/test_torch_support_matrix.py`` pins: a documented fragment with no
   matching raise site, a pin absent from the ledger, a ledger row no pin
   covers, and a refusal-phrased raise the ledger omits are all findings. A
   message may be held in a module-level string constant (the port words a
   refusal once and raises it from several sites), and a pin whose
   exception is ``None`` marks a row the port departs from on purpose (the
   combination runs; its test holds what it does instead), which then needs
   no raise site.
   The matched ledger becomes the machine-readable ``analysis/refusals.json``
   inventory (regenerate with ``--write-refusal-inventory``; a stale or
   missing inventory fails the run, like a stale ``lint_baseline.json``).

R11 metric-name contract. Every literal ``photon_*`` series registered via
   ``.counter/.gauge/.histogram/.summary(...)`` is collected with its kind
   and (where syntactically chained) label keys; the pass enforces the
   naming conventions (counters end ``_total``, nothing else does, no
   Prometheus-reserved suffixes, lowercase snake_case) and flags label-set
   disagreement within a family and drift between code and the port's
   metrics documentation — in both directions.

Fragment matching is anchored: a ledger fragment matches a message template
only if the match starts inside a literal segment (a placeholder may absorb
interior runs). Without the anchor, any template containing a placeholder
would match every fragment — the placeholder could *be* the fragment.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from .config import LintConfig

REFUSAL_INVENTORY_VERSION = 1

# execution-context token for code reachable from public entry points
MAIN_CONTEXT = "main"

_LOCK_TYPES = {"Lock", "RLock", "Condition"}
# synchronization objects that are safe to share by construction: their own
# methods are the handoff protocol, so cross-context access is the point
_SYNC_TYPES = {
    "Event",
    "Queue",
    "SimpleQueue",
    "LifoQueue",
    "PriorityQueue",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Thread",
    "Timer",
}

_ANNOTATION_RE = re.compile(
    r"#\s*photon:\s*(?:guarded-by\[([A-Za-z0-9_.]+)\]|(thread-confined)"
    r"|lock-order\[([^\]]+)\]|static-arg\[([A-Za-z0-9_]+)\])"
)

_REFUSAL_PHRASES = (
    "not supported",
    "not composable",
    "unsupported",
    "exceeds the supported",
)


# --------------------------------------------------------------------------
# data model


@dataclasses.dataclass(frozen=True)
class ProjectFinding:
    file: str
    line: int
    col: int
    rule: str
    message: str


@dataclasses.dataclass(frozen=True)
class Annotation:
    """A ``guarded-by``/``thread-confined`` comment, resolved to the code
    line it applies to (inline, or the next code line when standalone)."""

    file: str
    line: int  # the code line the annotation governs
    kind: str  # "guarded-by" | "thread-confined" | "lock-order" | "static-arg"
    # the bracket payload: the guarded-by lock, the "A < B" lock-order pair,
    # or the static-arg parameter name (None for thread-confined)
    lock: Optional[str]


@dataclasses.dataclass
class _Access:
    var: Tuple  # shared-variable key (see _attr_key/_global_key)
    write: bool
    line: int
    guards: FrozenSet[str]  # lexically held locks at the access


@dataclasses.dataclass
class _CallSite:
    callee: Tuple[str, str]  # scope key (file, qualname)
    guards: FrozenSet[str]  # lexically held locks at the call
    line: int = 0  # call site, for R13 lock-order witnesses


@dataclasses.dataclass
class _Scope:
    file: str
    qualname: str
    node: ast.AST  # FunctionDef / AsyncFunctionDef / Lambda
    class_name: Optional[str]  # enclosing class, if a method
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    calls: List[_CallSite] = dataclasses.field(default_factory=list)
    # callables handed to another thread from this scope: Thread targets,
    # pool submissions, completion callbacks
    spawns: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    # lock acquisitions: (lock, locks already held, line) per `with lock:`,
    # the raw material of R13's lock-order graph
    acquires: List[Tuple[str, FrozenSet[str], int]] = dataclasses.field(
        default_factory=list
    )

    @property
    def key(self) -> Tuple[str, str]:
        return (self.file, self.qualname)

    @property
    def is_public(self) -> bool:
        name = self.qualname.rsplit(".", 1)[-1]
        if name.startswith("__") and name.endswith("__"):
            return True  # dunder protocol methods are called from anywhere
        return not name.startswith("_")

    @property
    def is_init(self) -> bool:
        return self.qualname.rsplit(".", 1)[-1] == "__init__"


@dataclasses.dataclass
class _Class:
    file: str
    name: str
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    sync_attrs: Set[str] = dataclasses.field(default_factory=set)
    # self.<attr> = SomeClass(...) -> the class key, for obj.method() edges
    attr_types: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    # unresolved constructor type names, resolved once every module is indexed
    attr_types_raw: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    # every line holding an assignment to self.<attr>, for annotations
    attr_assign_lines: Dict[int, Set[str]] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class _ModuleInfo:
    file: str
    tree: ast.Module
    dotted: str  # photon_ml_tpu_torch.serving.refresh
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    classes: Dict[str, _Class] = dataclasses.field(default_factory=dict)
    lock_globals: Set[str] = dataclasses.field(default_factory=set)
    # module globals declared `global NAME` somewhere (i.e. actually mutated)
    mutated_globals: Set[str] = dataclasses.field(default_factory=set)
    global_assign_lines: Dict[int, Set[str]] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class ProjectResult:
    findings: List[ProjectFinding]
    errors: List[str]
    annotations: List[Annotation]
    used_annotations: Set[Tuple[str, int]]
    refusal_inventory: Optional[Dict] = None
    fault_inventory: Optional[Dict] = None


# --------------------------------------------------------------------------
# shared helpers


def _dotted_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _module_dotted(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def _import_aliases(tree: ast.Module, dotted: str) -> Dict[str, str]:
    """local name -> fully dotted target, with relative imports resolved
    against the importing module's package."""
    out: Dict[str, str] = {}
    package = dotted.rsplit(".", 1)[0] if "." in dotted else dotted
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[: len(parts) - (node.level - 1)]
                base = ".".join(parts + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
    return out


def _type_of_call(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The canonical dotted type name a ``X(...)`` call constructs."""
    if not isinstance(node, ast.Call):
        return None
    dotted = _dotted_name(node.func)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _own_statements(fn: ast.AST) -> List[ast.stmt]:
    """The function's body statements; nested def/class bodies are their own
    scopes and are walked separately."""
    return list(getattr(fn, "body", []))


def _qual_tail(qualname: str) -> str:
    return qualname.rsplit(".", 1)[-1]


# --------------------------------------------------------------------------
# annotations


def parse_annotations(source: str, relpath: str) -> List[Annotation]:
    """``guarded-by[...]`` / ``thread-confined`` comments, attached to the
    code line they govern (same standalone-comment rule as ``ignore``)."""
    out: List[Annotation] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _ANNOTATION_RE.search(tok.string)
        if not m:
            continue
        target = tok.start[0]
        if tok.line.strip().startswith("#"):
            target += 1
            while target <= len(lines) and (
                not lines[target - 1].strip()
                or lines[target - 1].lstrip().startswith("#")
            ):
                target += 1
        if m.group(1):
            kind, payload = "guarded-by", m.group(1)
        elif m.group(2):
            kind, payload = "thread-confined", None
        elif m.group(3):
            kind, payload = "lock-order", m.group(3)
        else:
            kind, payload = "static-arg", m.group(4)
        out.append(
            Annotation(file=relpath, line=target, kind=kind, lock=payload)
        )
    return out


# --------------------------------------------------------------------------
# symbol table


def _attr_key(cls: _Class, attr: str) -> Tuple:
    return ("attr", cls.file, cls.name, attr)


def _global_key(mod: _ModuleInfo, name: str) -> Tuple:
    return ("global", mod.file, name)


class _SymbolTable:
    def __init__(self, sources: Mapping[str, str]):
        self.modules: Dict[str, _ModuleInfo] = {}
        self.scopes: Dict[Tuple[str, str], _Scope] = {}
        self.by_dotted: Dict[str, Tuple[str, str]] = {}  # funcs + classes
        self.class_by_dotted: Dict[str, Tuple[str, str]] = {}
        self.errors: List[str] = []
        for rel in sorted(sources):
            try:
                tree = ast.parse(sources[rel], filename=rel)
            except SyntaxError:
                continue  # per-file pass already reports it
            self._index_module(rel, tree)
        self.mod_by_dotted: Dict[str, _ModuleInfo] = {
            m.dotted: m for m in self.modules.values()
        }
        for mod in self.modules.values():
            for cls in mod.classes.values():
                for attr, ty in cls.attr_types_raw.items():
                    target = self._resolve_class_dotted(ty, mod)
                    if target is not None:
                        cls.attr_types[attr] = target

    def resolve_dotted(self, full: str) -> str:
        """Follow ``from .x import y`` re-export facades until the name lands
        on a known function or class — ``photon_ml_tpu_torch.obs.swallowed_error``
        is really ``photon_ml_tpu_torch.obs.run.swallowed_error``."""
        seen: Set[str] = set()
        while (
            full not in self.by_dotted
            and full not in self.class_by_dotted
            and full not in seen
        ):
            seen.add(full)
            modpath, _, sym = full.rpartition(".")
            mod = self.mod_by_dotted.get(modpath)
            if mod is None or sym not in mod.aliases:
                break
            full = mod.aliases[sym]
        return full

    def _index_module(self, rel: str, tree: ast.Module) -> None:
        dotted = _module_dotted(rel)
        mod = _ModuleInfo(file=rel, tree=tree, dotted=dotted)
        mod.aliases = _import_aliases(tree, dotted)
        self.modules[rel] = mod
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(mod, stmt, stmt.name, None)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(mod, stmt)
            elif isinstance(stmt, ast.Assign):
                ty = _type_of_call(stmt.value, mod.aliases)
                if ty and ty.startswith("threading."):
                    kind = ty.split(".")[-1]
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and kind in _LOCK_TYPES:
                            mod.lock_globals.add(t.id)
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                mod.mutated_globals.update(node.names)

    def _index_class(self, mod: _ModuleInfo, node: ast.ClassDef) -> None:
        cls = _Class(file=mod.file, name=node.name)
        mod.classes[node.name] = cls
        self.class_by_dotted[f"{mod.dotted}.{node.name}"] = (
            mod.file,
            node.name,
        )
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = self._index_function(
                    mod, stmt, f"{node.name}.{stmt.name}", node.name
                )
                cls.methods[stmt.name] = key
        # attr classification from every method body (not just __init__)
        for body_fn in ast.walk(node):
            if not isinstance(body_fn, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                body_fn.targets
                if isinstance(body_fn, ast.Assign)
                else [body_fn.target]
            )
            value = body_fn.value
            for t in targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                cls.attr_assign_lines.setdefault(t.lineno, set()).add(t.attr)
                ty = _type_of_call(value, mod.aliases) if value else None
                if ty is None:
                    continue
                head, _, tail = ty.rpartition(".")
                if head == "threading" or ty in _LOCK_TYPES | _SYNC_TYPES:
                    name = tail or ty
                    if name in _LOCK_TYPES:
                        cls.lock_attrs.add(t.attr)
                    elif name in _SYNC_TYPES:
                        cls.sync_attrs.add(t.attr)
                elif head == "queue" and tail in _SYNC_TYPES:
                    cls.sync_attrs.add(t.attr)
                else:
                    cls.attr_types_raw[t.attr] = ty

    def _resolve_class_dotted(
        self, ty: str, mod: _ModuleInfo
    ) -> Optional[Tuple[str, str]]:
        if ty in mod.classes:
            return (mod.file, ty)
        # alias-of-a-symbol: `from .store import ModelStore` gives
        # ModelStore -> photon_ml_tpu_torch.serving.store.ModelStore directly;
        # package facades resolve one more hop
        resolved = self.resolve_dotted(mod.aliases.get(ty, ty))
        return self.class_by_dotted.get(resolved)

    def _index_function(
        self,
        mod: _ModuleInfo,
        node: ast.AST,
        qualname: str,
        class_name: Optional[str],
    ) -> Tuple[str, str]:
        scope = _Scope(
            file=mod.file, qualname=qualname, node=node, class_name=class_name
        )
        self.scopes[scope.key] = scope
        if class_name is None and "." not in qualname:
            mod.functions[qualname] = scope.key
            self.by_dotted[f"{mod.dotted}.{qualname}"] = scope.key
        for stmt in ast.walk(node):
            if stmt is node:
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested defs get their own scope; re-walk guard below keeps
                # each body from being indexed twice
                if getattr(stmt, "_photon_indexed", False):
                    continue
                stmt._photon_indexed = True  # type: ignore[attr-defined]
                self._index_function(
                    mod,
                    stmt,
                    f"{qualname}.<locals>.{stmt.name}",
                    class_name,
                )
        return scope.key


# --------------------------------------------------------------------------
# R9: accesses, call graph, contexts, races


class _BodyWalker:
    """One pass over a scope's own statements, tracking the lexically held
    locks through ``with`` blocks and collecting attribute/global accesses,
    call edges, and thread spawns."""

    def __init__(self, table: _SymbolTable, mod: _ModuleInfo, scope: _Scope):
        self.table = table
        self.mod = mod
        self.scope = scope
        self.cls = (
            mod.classes.get(scope.class_name) if scope.class_name else None
        )
        self.local_types: Dict[str, Tuple[str, str]] = {}
        self.local_names: Set[str] = set()
        self.globals_declared: Set[str] = set()
        fn = scope.node
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                self.local_names.add(a.arg)

    # -- lock naming -------------------------------------------------------

    def _guard_name(self, expr: ast.AST) -> Optional[str]:
        """Canonical name of the lock a ``with`` item holds, if we can tell."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cls is not None
            and expr.attr in self.cls.lock_attrs
        ):
            return f"self.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.mod.lock_globals:
            return f"{self.mod.file}:{expr.id}"
        dotted = _dotted_name(expr)
        if dotted and "." in dotted:
            head, _, tail = dotted.partition(".")
            target = self.mod.aliases.get(head)
            for other in self.table.modules.values():
                if other.dotted == target and tail in other.lock_globals:
                    return f"{other.file}:{tail}"
        return None

    # -- callable references ----------------------------------------------

    def _callable_ref(self, expr: ast.AST) -> List[Tuple[str, str]]:
        """Scope keys an expression used as a callable may denote."""
        if isinstance(expr, ast.Lambda):
            out: List[Tuple[str, str]] = []
            for node in ast.walk(expr.body):
                if isinstance(node, ast.Call):
                    out.extend(self._callable_ref(node.func))
            return out
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cls is not None
        ):
            if expr.attr in self.cls.methods:
                return [self.cls.methods[expr.attr]]
            # self.<obj>.<method> handled by the caller via attr_types
            return []
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Attribute
        ):
            inner = expr.value
            if (
                isinstance(inner.value, ast.Name)
                and inner.value.id == "self"
                and self.cls is not None
                and inner.attr in self.cls.attr_types
            ):
                cfile, cname = self.cls.attr_types[inner.attr]
                target = self.table.modules[cfile].classes[cname]
                if expr.attr in target.methods:
                    return [target.methods[expr.attr]]
            return []
        if isinstance(expr, ast.Name):
            name = expr.id
            nested = f"{self.scope.qualname}.<locals>.{name}"
            if (self.scope.file, nested) in self.table.scopes:
                return [(self.scope.file, nested)]
            if name in self.local_types:
                cfile, cname = self.local_types[name]
                target = self.table.modules[cfile].classes[cname]
                if "__init__" in target.methods:
                    return [target.methods["__init__"]]
                return []
            if name in self.mod.functions:
                return [self.mod.functions[name]]
            resolved = self.mod.aliases.get(name)
            if resolved:
                resolved = self.table.resolve_dotted(resolved)
                if resolved in self.table.by_dotted:
                    return [self.table.by_dotted[resolved]]
                if resolved in self.table.class_by_dotted:
                    cfile, cname = self.table.class_by_dotted[resolved]
                    target = self.table.modules[cfile].classes[cname]
                    if "__init__" in target.methods:
                        return [target.methods["__init__"]]
            if name in self.mod.classes:
                target = self.mod.classes[name]
                if "__init__" in target.methods:
                    return [target.methods["__init__"]]
            return []
        if isinstance(expr, ast.Attribute):
            dotted = _dotted_name(expr)
            if dotted:
                head, _, rest = dotted.partition(".")
                base = self.mod.aliases.get(head, head)
                full = f"{base}.{rest}" if rest else base
                full = self.table.resolve_dotted(full)
                if full in self.table.by_dotted:
                    return [self.table.by_dotted[full]]
                if full in self.table.class_by_dotted:
                    cfile, cname = self.table.class_by_dotted[full]
                    target = self.table.modules[cfile].classes[cname]
                    if "__init__" in target.methods:
                        return [target.methods["__init__"]]
            # local_var.method()
            if isinstance(expr.value, ast.Name):
                vname = expr.value.id
                if vname in self.local_types:
                    cfile, cname = self.local_types[vname]
                    target = self.table.modules[cfile].classes[cname]
                    if expr.attr in target.methods:
                        return [target.methods[expr.attr]]
        return []

    # -- the walk ----------------------------------------------------------

    def walk(self) -> None:
        self._walk_stmts(_own_statements(self.scope.node), frozenset())

    def _walk_stmts(
        self, stmts: Sequence[ast.stmt], guards: FrozenSet[str]
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # separate scope
            if isinstance(stmt, ast.ClassDef):
                continue
            if isinstance(stmt, ast.Global):
                self.globals_declared.update(stmt.names)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = guards
                for item in stmt.items:
                    self._walk_expr(item.context_expr, guards)
                    g = self._guard_name(item.context_expr)
                    if g is not None:
                        self.scope.acquires.append((g, inner, stmt.lineno))
                        inner = inner | {g}
                self._walk_stmts(stmt.body, inner)
                continue
            # compound statements: recurse into child statement lists with
            # the same guard set, and visit this statement's own expressions
            for field in ("body", "orelse", "finalbody"):
                if getattr(stmt, field, None) and not isinstance(
                    stmt, (ast.With, ast.AsyncWith)
                ):
                    self._walk_stmts(getattr(stmt, field), guards)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk_stmts(h.body, guards)
            self._visit_own_exprs(stmt, guards)

    def _visit_own_exprs(self, stmt: ast.stmt, guards: FrozenSet[str]) -> None:
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            nodes = value if isinstance(value, list) else [value]
            for node in nodes:
                if isinstance(node, ast.expr):
                    self._walk_expr(node, guards)
        # record local binding types for Assign: v = ClassName(...)
        if isinstance(stmt, ast.Assign):
            ty = _type_of_call(stmt.value, self.mod.aliases)
            resolved = (
                self.table._resolve_class_dotted(ty, self.mod) if ty else None
            )
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self.local_names.add(t.id)
                    if resolved is not None:
                        self.local_types[t.id] = resolved
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(stmt.target, ast.Name):
                self.local_names.add(stmt.target.id)
        elif isinstance(stmt, ast.For):
            if isinstance(stmt.target, ast.Name):
                self.local_names.add(stmt.target.id)

    def _walk_expr(self, expr: ast.AST, guards: FrozenSet[str]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda,)):
                continue  # bodies analyzed only when resolved as callbacks
            if isinstance(node, ast.Attribute):
                self._record_attr(node, guards)
            elif isinstance(node, ast.Name):
                self._record_global(node, guards)
            elif isinstance(node, ast.Call):
                self._record_call(node, guards)

    def _record_attr(self, node: ast.Attribute, guards: FrozenSet[str]) -> None:
        if not (
            isinstance(node.value, ast.Name) and node.value.id == "self"
        ):
            return
        if self.cls is None:
            return
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        self.scope.accesses.append(
            _Access(
                var=_attr_key(self.cls, node.attr),
                write=write,
                line=node.lineno,
                guards=guards,
            )
        )

    def _record_global(self, node: ast.Name, guards: FrozenSet[str]) -> None:
        name = node.id
        if name not in self.mod.mutated_globals:
            return
        if name in self.globals_declared:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
        elif name in self.local_names or isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            return  # local shadow, not the module global
        else:
            write = False
        self.scope.accesses.append(
            _Access(
                var=_global_key(self.mod, name),
                write=write,
                line=node.lineno,
                guards=guards,
            )
        )

    def _record_call(self, node: ast.Call, guards: FrozenSet[str]) -> None:
        # thread spawn shapes
        ty = _type_of_call(node, self.mod.aliases)
        if ty in ("threading.Thread", "threading.Timer"):
            for kw in node.keywords:
                if kw.arg in ("target", "function"):
                    self.scope.spawns.extend(self._callable_ref(kw.value))
            if ty == "threading.Timer" and len(node.args) >= 2:
                self.scope.spawns.extend(self._callable_ref(node.args[1]))
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "submit" and node.args:
                self.scope.spawns.extend(self._callable_ref(node.args[0]))
            elif node.func.attr == "add_done_callback" and node.args:
                self.scope.spawns.extend(self._callable_ref(node.args[0]))
        for callee in self._callable_ref(node.func):
            self.scope.calls.append(
                _CallSite(callee=callee, guards=guards, line=node.lineno)
            )


def _http_handler_scopes(table: _SymbolTable) -> Set[Tuple[str, str]]:
    """Methods of BaseHTTPRequestHandler subclasses run on server threads."""
    out: Set[Tuple[str, str]] = set()
    for mod in table.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for base in node.bases:
                dotted = _dotted_name(base) or ""
                if dotted.split(".")[-1] == "BaseHTTPRequestHandler":
                    prefix = None
                    for key, scope in table.scopes.items():
                        tail = scope.qualname.split(".")
                        if (
                            key[0] == mod.file
                            and node.name in tail
                            and isinstance(
                                scope.node,
                                (ast.FunctionDef, ast.AsyncFunctionDef),
                            )
                        ):
                            out.add(key)
                    _ = prefix
    return out


def _resolve_entrypoints(
    table: _SymbolTable, config: LintConfig
) -> Tuple[Set[Tuple[str, str]], List[str]]:
    """Configured ``file.py::Qual.name`` entrypoints, validated."""
    out: Set[Tuple[str, str]] = set()
    errors: List[str] = []
    for spec in config.thread_entrypoints:
        file, sep, qual = spec.partition("::")
        key = (file, qual)
        if not sep or key not in table.scopes:
            errors.append(
                f"thread_entrypoints: {spec!r} does not name a known "
                "function (expected 'path/to/file.py::Class.method')"
            )
            continue
        out.add(key)
    return out, errors


def _propagate_contexts(
    table: _SymbolTable, worker_roots: Set[Tuple[str, str]]
) -> Dict[Tuple[str, str], Set[str]]:
    """Execution contexts per scope: seed worker roots with their own token
    and public scopes with "main", then flow along call edges."""
    callers_of: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for scope in table.scopes.values():
        for cs in scope.calls:
            callers_of.setdefault(cs.callee, []).append(scope.key)
    called = set(callers_of)

    ctx: Dict[Tuple[str, str], Set[str]] = {
        k: set() for k in table.scopes
    }
    work: List[Tuple[str, str]] = []

    def seed(key: Tuple[str, str], token: str) -> None:
        if token not in ctx[key]:
            ctx[key].add(token)
            work.append(key)

    for key in worker_roots:
        seed(key, f"{key[0]}::{key[1]}")
    for key, scope in table.scopes.items():
        if key in worker_roots:
            continue
        if scope.is_public or key not in called:
            seed(key, MAIN_CONTEXT)

    while work:
        key = work.pop()
        scope = table.scopes.get(key)
        if scope is None:
            continue
        for cs in scope.calls:
            if cs.callee not in ctx:
                continue
            before = len(ctx[cs.callee])
            ctx[cs.callee].update(ctx[key])
            if len(ctx[cs.callee]) != before:
                work.append(cs.callee)
    return ctx


def _inherited_guards(
    table: _SymbolTable, worker_roots: Set[Tuple[str, str]]
) -> Dict[Tuple[str, str], FrozenSet[str]]:
    """Locks provably held on entry to each scope: the intersection over all
    call sites of (locks held at the site + the caller's own inherited set).
    Roots — worker entrypoints and public API — inherit nothing: they can be
    invoked with no locks held."""
    sites_of: Dict[Tuple[str, str], List[Tuple[Tuple[str, str], FrozenSet[str]]]] = {}
    for scope in table.scopes.values():
        for cs in scope.calls:
            sites_of.setdefault(cs.callee, []).append((scope.key, cs.guards))

    universe = frozenset(
        g for s in table.scopes.values() for a in s.accesses for g in a.guards
    ) | frozenset(
        g for s in table.scopes.values() for c in s.calls for g in c.guards
    )
    inherited: Dict[Tuple[str, str], FrozenSet[str]] = {}
    for key, scope in table.scopes.items():
        is_root = (
            key in worker_roots or scope.is_public or key not in sites_of
        )
        inherited[key] = frozenset() if is_root else universe

    changed = True
    while changed:
        changed = False
        for key in table.scopes:
            if not inherited[key]:
                continue
            sites = sites_of.get(key, [])
            acc: Optional[FrozenSet[str]] = None
            for caller, guards in sites:
                held = guards | inherited.get(caller, frozenset())
                acc = held if acc is None else (acc & held)
            new = acc if acc is not None else frozenset()
            if new != inherited[key]:
                inherited[key] = new
                changed = True
    return inherited


def _describe_context(tokens: Set[str]) -> str:
    names = sorted(
        t if t == MAIN_CONTEXT else t.split("::")[-1] for t in tokens
    )
    return "/".join(names)


def walk_bodies(table: _SymbolTable) -> None:
    """Populate every scope's accesses/calls/spawns/acquires. Idempotent:
    R9, R13 and R15 all need the walked table, in any order, exactly once."""
    if getattr(table, "_bodies_walked", False):
        return
    table._bodies_walked = True
    for scope in table.scopes.values():
        mod = table.modules[scope.file]
        _BodyWalker(table, mod, scope).walk()


def run_r9(
    table: _SymbolTable,
    config: LintConfig,
    annotations: Sequence[Annotation],
) -> Tuple[List[ProjectFinding], List[str], Set[Tuple[str, int]]]:
    errors: List[str] = []
    findings: List[ProjectFinding] = []
    used: Set[Tuple[str, int]] = set()

    walk_bodies(table)

    worker_roots: Set[Tuple[str, str]] = set()
    for scope in table.scopes.values():
        worker_roots.update(scope.spawns)
    worker_roots |= _http_handler_scopes(table)
    configured, cfg_errors = _resolve_entrypoints(table, config)
    worker_roots |= configured
    errors.extend(cfg_errors)

    ctx = _propagate_contexts(table, worker_roots)
    inherited = _inherited_guards(table, worker_roots)

    # resolve annotations to shared-variable keys, validating guarded-by
    # (lock-order / static-arg belong to R13 / R15 — not resolved here)
    ann_by_var: Dict[Tuple, Annotation] = {}
    for ann in annotations:
        if ann.kind not in ("guarded-by", "thread-confined"):
            continue
        mod = table.modules.get(ann.file)
        if mod is None:
            continue
        resolved_vars: List[Tuple] = []
        for cls in mod.classes.values():
            for attr in cls.attr_assign_lines.get(ann.line, ()):
                resolved_vars.append(_attr_key(cls, attr))
                if ann.kind == "guarded-by" and ann.lock is not None:
                    lock = ann.lock[5:] if ann.lock.startswith("self.") else ann.lock
                    if lock not in cls.lock_attrs:
                        errors.append(
                            f"{ann.file}:{ann.line}: guarded-by[{ann.lock}] "
                            f"names no lock attribute of {cls.name} "
                            f"(known: {sorted(cls.lock_attrs) or 'none'})"
                        )
        for name in mod.global_assign_lines.get(ann.line, ()):
            resolved_vars.append(_global_key(mod, name))
            if ann.kind == "guarded-by" and ann.lock is not None:
                if ann.lock not in mod.lock_globals:
                    errors.append(
                        f"{ann.file}:{ann.line}: guarded-by[{ann.lock}] "
                        f"names no module-level lock (known: "
                        f"{sorted(mod.lock_globals) or 'none'})"
                    )
        if not resolved_vars:
            errors.append(
                f"{ann.file}:{ann.line}: photon: {ann.kind} annotation is "
                "not attached to an attribute or global assignment"
            )
        for var in resolved_vars:
            ann_by_var[var] = ann

    # collect accesses per shared variable
    accesses: Dict[Tuple, List[Tuple[_Scope, _Access]]] = {}
    for scope in table.scopes.values():
        if scope.is_init:
            continue  # construction happens before the object is shared
        for acc in scope.accesses:
            accesses.setdefault(acc.var, []).append((scope, acc))

    for var in sorted(accesses, key=repr):
        kind, file, *rest = var
        if kind == "attr":
            cls = table.modules[file].classes[rest[0]]
            if rest[1] in cls.lock_attrs | cls.sync_attrs:
                continue
            label = f"{rest[0]}.{rest[1]}"
        else:
            mod = table.modules[file]
            if rest[0] in mod.lock_globals:
                continue
            label = f"{table.modules[file].dotted}.{rest[0]}"
        entries = [
            (s, a, frozenset(a.guards | inherited.get(s.key, frozenset())))
            for s, a in accesses[var]
            if ctx.get(s.key)
        ]
        conflict = None
        for s1, a1, g1 in entries:
            if not a1.write:
                continue
            for s2, a2, g2 in entries:
                c1, c2 = ctx[s1.key], ctx[s2.key]
                if len(c1 | c2) < 2 and not (len(c1) > 1):
                    continue
                if c1 == c2 and len(c1) == 1:
                    continue
                if g1 & g2:
                    continue
                conflict = (s1, a1, s2, a2)
                break
            if conflict:
                break
        if conflict is None:
            continue
        ann = ann_by_var.get(var)
        if ann is not None:
            used.add((ann.file, ann.line))
            continue
        s1, a1, s2, a2 = conflict
        what = "written" if a2.write else "read"
        findings.append(
            ProjectFinding(
                file=s1.file,
                line=a1.line,
                col=0,
                rule="R9",
                message=(
                    f"{label} written in context "
                    f"[{_describe_context(ctx[s1.key])}] here and {what} in "
                    f"context [{_describe_context(ctx[s2.key])}] at "
                    f"{s2.file}:{a2.line} with no common lock — guard both "
                    "sides with one lock, or annotate the assignment with "
                    "# photon: guarded-by[lock_attr] / # photon: "
                    "thread-confined"
                ),
            )
        )
    return findings, errors, used


# --------------------------------------------------------------------------
# R10: refusal-ledger consistency


@dataclasses.dataclass(frozen=True)
class RaiseSite:
    file: str
    line: int
    exception: str
    segments: Tuple[Optional[str], ...]  # None = placeholder


def _msg_segments(
    node: ast.AST, consts: Optional[Mapping[str, List[Optional[str]]]] = None
) -> Optional[List[Optional[str]]]:
    """Template segments of a message expression: literal strings with None
    placeholders for runtime values; None result = not statically knowable.
    ``consts`` maps the names of module-level string constants to their
    segments: a message held in a constant (the port words a refusal once
    and raises it from several sites) is as knowable as a literal."""
    consts = consts or {}
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.Name) and node.id in consts:
        return list(consts[node.id])
    if isinstance(node, ast.JoinedStr):
        out: List[Optional[str]] = []
        for value in node.values:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                out.append(value.value)
            elif (
                isinstance(value, ast.FormattedValue)
                and isinstance(value.value, ast.Name)
                and value.value.id in consts
                and value.format_spec is None
                and value.conversion == -1
            ):
                out.extend(consts[value.value.id])
            else:
                out.append(None)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _msg_segments(node.left, consts)
        right = _msg_segments(node.right, consts)
        if left is None or right is None:
            return None
        return left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        base = _msg_segments(node.left, consts)
        if base is None or len(base) != 1 or base[0] is None:
            return None
        parts = re.split(r"%[-#0-9.+ ]*[srdfgxeo%]", base[0])
        out = []
        for i, p in enumerate(parts):
            if i:
                out.append(None)
            out.append(p)
        return out
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "format"
    ):
        base = _msg_segments(node.func.value, consts)
        if base is None or len(base) != 1 or base[0] is None:
            return None
        parts = re.split(r"\{[^{}]*\}", base[0])
        out = []
        for i, p in enumerate(parts):
            if i:
                out.append(None)
            out.append(p)
        return out
    return None


def _string_constants(
    trees: Mapping[str, ast.Module]
) -> Dict[str, Dict[str, List[Optional[str]]]]:
    """Per module, the string constants it can name: its own module-level
    ``NAME = <literal message>`` assignments, plus those it imports by name
    (``from .mod import NAME``, at any depth) from another module of the
    package whose name is unambiguous."""
    own: Dict[str, Dict[str, List[Optional[str]]]] = {}
    for rel, tree in trees.items():
        table: Dict[str, List[Optional[str]]] = {}
        for stmt in tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
            ):
                segs = _msg_segments(stmt.value)
                if segs is not None:
                    table[stmt.targets[0].id] = segs
        own[rel] = table
    defined: Dict[str, List[List[Optional[str]]]] = {}
    for table in own.values():
        for name, segs in table.items():
            defined.setdefault(name, []).append(segs)
    out: Dict[str, Dict[str, List[Optional[str]]]] = {}
    for rel, tree in trees.items():
        table = dict(own[rel])
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    found = defined.get(a.name, [])
                    if len(found) == 1 and (a.asname or a.name) not in table:
                        table[a.asname or a.name] = found[0]
        out[rel] = table
    return out


def _message_alternatives(
    node: ast.AST, consts: Mapping[str, List[Optional[str]]]
) -> List[List[Optional[str]]]:
    """The templates a raise's message can take: one, or one per branch of
    a conditional expression choosing between knowable messages."""
    if isinstance(node, ast.IfExp):
        return _message_alternatives(node.body, consts) + _message_alternatives(
            node.orelse, consts
        )
    segments = _msg_segments(node, consts)
    return [] if segments is None else [segments]


def _merge_segments(
    segments: Sequence[Optional[str]],
) -> Tuple[Optional[str], ...]:
    out: List[Optional[str]] = []
    for seg in segments:
        if seg is None:
            if not out or out[-1] is not None:
                out.append(None)
        elif out and out[-1] is not None:
            out[-1] += seg
        else:
            out.append(seg)
    return tuple(out)


def fragment_matches_template(
    fragment: str, segments: Sequence[Optional[str]]
) -> bool:
    """Whether some instantiation of the template contains ``fragment``,
    with the match anchored to start inside a literal segment. Placeholders
    absorb arbitrary interior runs; a match that would live entirely inside
    one placeholder does not count (it would be vacuously true)."""

    def rec(si: int, off: int, fp: int) -> bool:
        if fp == len(fragment):
            return True
        if si >= len(segments):
            return False
        seg = segments[si]
        if seg is None:
            return any(
                rec(si + 1, 0, fp + take)
                for take in range(len(fragment) - fp + 1)
            )
        avail = seg[off:]
        n = min(len(avail), len(fragment) - fp)
        if avail[:n] != fragment[fp : fp + n]:
            return False
        if fp + n == len(fragment):
            return True
        if n < len(avail):
            return False  # fragment diverges inside this literal
        return rec(si + 1, 0, fp + n)

    for si, seg in enumerate(segments):
        if seg is None:
            continue
        for off in range(len(seg)):
            if seg[off] == fragment[0] and rec(si, off, 0):
                return True
    return False


def extract_raise_sites(sources: Mapping[str, str]) -> List[RaiseSite]:
    trees: Dict[str, ast.Module] = {}
    for rel in sorted(sources):
        try:
            trees[rel] = ast.parse(sources[rel], filename=rel)
        except SyntaxError:
            continue
    constants = _string_constants(trees)
    out: List[RaiseSite] = []
    for rel in sorted(trees):
        for node in ast.walk(trees[rel]):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            if not isinstance(exc, ast.Call) or not exc.args:
                continue
            name = _dotted_name(exc.func)
            if name is None:
                continue
            exc_name = name.split(".")[-1]
            # PlanError is the execution planner's typed refusal (a
            # ValueError subclass, plan/planner.py) — its sites ARE the
            # ledger's canonical raise sites
            if exc_name not in ("ValueError", "NotImplementedError", "PlanError"):
                continue
            for segments in _message_alternatives(exc.args[0], constants[rel]):
                merged = _merge_segments(segments)
                if not any(s for s in merged if s):
                    continue
                out.append(
                    RaiseSite(
                        file=rel,
                        line=node.lineno,
                        exception=exc_name,
                        segments=merged,
                    )
                )
    return out


@dataclasses.dataclass(frozen=True)
class LedgerRow:
    fragment: str
    line: int


def parse_refusal_ledger(markdown: str) -> List[LedgerRow]:
    """Rows of the ``| refused combination | message contains | ... |``
    table: the backticked fragment in the second column."""
    rows: List[LedgerRow] = []
    in_table = False
    for lineno, line in enumerate(markdown.splitlines(), start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if not in_table:
            if cells and cells[0] == "refused combination":
                in_table = True
            continue
        if cells and set(cells[0]) <= {"-", " ", ":"}:
            continue
        if len(cells) < 2:
            continue
        frag = cells[1].strip()
        if frag.startswith("`") and frag.endswith("`"):
            frag = frag[1:-1]
        if frag:
            rows.append(LedgerRow(fragment=frag, line=lineno))
    return rows


@dataclasses.dataclass(frozen=True)
class TestPin:
    fragment: str
    exception: str
    line: int


def parse_test_pins(source: str) -> List[TestPin]:
    """The (fragment, exception) pins from the CASES list of the support-
    matrix test, read statically (adjacent string literals are one Constant
    by the time the parser is done)."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    pins: List[TestPin] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "CASES" for t in node.targets
        ):
            continue
        if not isinstance(node.value, ast.List):
            continue
        for elt in node.value.elts:
            if not isinstance(elt, (ast.Tuple, ast.List)) or len(elt.elts) < 3:
                continue
            frag_node, exc_node = elt.elts[1], elt.elts[2]
            if not (
                isinstance(frag_node, ast.Constant)
                and isinstance(frag_node.value, str)
            ):
                continue
            exc = _dotted_name(exc_node) or ""
            pins.append(
                TestPin(
                    fragment=frag_node.value,
                    exception=exc.split(".")[-1],
                    line=frag_node.lineno,
                )
            )
    return pins


def build_refusal_inventory(
    ledger: Sequence[LedgerRow], sites: Sequence[RaiseSite]
) -> Dict:
    """The machine-readable contract: one entry per documented refusal, with
    the exception type(s) and modules of the raise sites enforcing it. No
    line numbers on purpose — the inventory should churn only when the
    contract does, not when code moves."""
    entries = []
    for row in sorted(ledger, key=lambda r: r.fragment):
        matched = [
            s for s in sites if fragment_matches_template(row.fragment, s.segments)
        ]
        entries.append(
            {
                "fragment": row.fragment,
                "exceptions": sorted({s.exception for s in matched}),
                "modules": sorted({s.file for s in matched}),
            }
        )
    return {"version": REFUSAL_INVENTORY_VERSION, "refusals": entries}


def render_refusal_inventory(doc: Dict) -> str:
    return json.dumps(doc, indent=2) + "\n"


def _has_refusal_phrase(segments: Sequence[Optional[str]]) -> bool:
    text = " ".join(s for s in segments if s)
    return any(p in text for p in _REFUSAL_PHRASES)


def run_r10(
    sources: Mapping[str, str], config: LintConfig
) -> Tuple[List[ProjectFinding], Optional[Dict]]:
    docs_path = os.path.join(config.root, config.refusal_docs)
    if not os.path.isfile(docs_path):
        return [], None
    with open(docs_path, encoding="utf-8") as f:
        docs_text = f.read()
    ledger = parse_refusal_ledger(docs_text)
    if not ledger:
        return [], None

    findings: List[ProjectFinding] = []
    sites = extract_raise_sites(sources)
    inventory = build_refusal_inventory(ledger, sites)

    def add(file: str, line: int, message: str) -> None:
        findings.append(
            ProjectFinding(file=file, line=line, col=0, rule="R10", message=message)
        )

    pins: List[TestPin] = []
    tests_path = os.path.join(config.root, config.refusal_tests)
    if os.path.isfile(tests_path):
        with open(tests_path, encoding="utf-8") as f:
            pins = parse_test_pins(f.read())
    # a pin with no exception (None) marks a row the package departs from on
    # purpose: the combination runs, and its test holds what it does instead
    departed = {pin.fragment for pin in pins if not pin.exception}

    # docs -> code: every documented fragment must have a raise site
    for row, entry in zip(
        sorted(ledger, key=lambda r: r.fragment), inventory["refusals"]
    ):
        if not entry["modules"] and not any(
            frag in row.fragment for frag in departed
        ):
            add(
                config.refusal_docs,
                row.line,
                f"ledger fragment {row.fragment!r} matches no raise site — "
                "the documented refusal is not enforced anywhere",
            )

    # tests <-> docs
    if os.path.isfile(tests_path):
        for pin in pins:
            if not any(pin.fragment in row.fragment for row in ledger):
                add(
                    config.refusal_tests,
                    pin.line,
                    f"test pin {pin.fragment!r} appears in no refusal-ledger "
                    "row — the pinned refusal is undocumented",
                )
        for row in ledger:
            if not any(pin.fragment in row.fragment for pin in pins):
                add(
                    config.refusal_docs,
                    row.line,
                    f"ledger fragment {row.fragment!r} is pinned by no "
                    f"{config.refusal_tests} case — the documented refusal "
                    "is untested",
                )

    # code -> docs: refusal-phrased raises the ledger does not cover
    for site in sites:
        if not _has_refusal_phrase(site.segments):
            continue
        if any(
            fragment_matches_template(row.fragment, site.segments)
            for row in ledger
        ):
            continue
        add(
            site.file,
            site.line,
            f"{site.exception} message reads like a support-matrix refusal "
            "but matches no refusal-ledger row — document it in "
            f"{config.refusal_docs} (or # photon: ignore[R10] if it is an "
            "internal guard, not a configuration refusal)",
        )

    # inventory staleness (byte-for-byte, like the baseline)
    inv_path = os.path.join(config.root, config.refusal_inventory)
    want = render_refusal_inventory(inventory)
    have = None
    if os.path.isfile(inv_path):
        with open(inv_path, encoding="utf-8") as f:
            have = f.read()
    if have != want:
        state = "stale" if have is not None else "missing"
        add(
            config.refusal_inventory,
            1,
            f"refusal inventory is {state}; regenerate with "
            "--write-refusal-inventory",
        )
    return findings, inventory


# --------------------------------------------------------------------------
# R11: metric-name contract


_METRIC_KINDS = {"counter", "gauge", "histogram", "summary"}
_USE_METHODS = {"inc", "dec", "set", "observe", "time"}
_METRIC_NAME_RE = re.compile(r"^photon_[a-z0-9_]+$")
_DOC_TOKEN_RE = re.compile(r"photon_[a-z0-9_]+_?\*?")


@dataclasses.dataclass(frozen=True)
class MetricSite:
    name: str
    kind: str
    file: str
    line: int
    labels: Optional[Tuple[str, ...]]  # None = not syntactically chained
    # an f-string name like f"photon_device_{direction}_bytes_total": name
    # holds the literal prefix, and only prefix-based doc matching applies
    dynamic: bool = False


def extract_metric_sites(sources: Mapping[str, str]) -> List[MetricSite]:
    out: List[MetricSite] = []
    for rel in sorted(sources):
        try:
            tree = ast.parse(sources[rel], filename=rel)
        except SyntaxError:
            continue
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_KINDS
                and node.args
            ):
                continue
            arg = node.args[0]
            name = dynamic = None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name, dynamic = arg.value, False
            elif (
                isinstance(arg, ast.JoinedStr)
                and arg.values
                and isinstance(arg.values[0], ast.Constant)
                and isinstance(arg.values[0].value, str)
            ):
                name, dynamic = arg.values[0].value, True
            if name is None or not name.startswith("photon_"):
                continue
            labels: Optional[Tuple[str, ...]] = None
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                grand = parents.get(parent)
                chained = (
                    isinstance(grand, ast.Call) and grand.func is parent
                )
                if chained and parent.attr == "labels":
                    kws = [kw.arg for kw in grand.keywords if kw.arg]
                    if len(kws) == len(grand.keywords):
                        labels = tuple(sorted(kws))
                elif chained and parent.attr in _USE_METHODS:
                    labels = ()
            out.append(
                MetricSite(
                    name=name,
                    kind=node.func.attr,
                    file=rel,
                    line=node.lineno,
                    labels=labels,
                    dynamic=dynamic,
                )
            )
    return out


def run_r11(
    sources: Mapping[str, str], config: LintConfig
) -> List[ProjectFinding]:
    findings: List[ProjectFinding] = []

    def add(file: str, line: int, message: str) -> None:
        findings.append(
            ProjectFinding(file=file, line=line, col=0, rule="R11", message=message)
        )

    sites = extract_metric_sites(sources)
    families: Dict[str, List[MetricSite]] = {}
    dynamic_prefixes: Dict[str, MetricSite] = {}
    for site in sites:
        if site.dynamic:
            dynamic_prefixes.setdefault(site.name, site)
        else:
            families.setdefault(site.name, []).append(site)

    for name in sorted(families):
        fam = families[name]
        first = fam[0]
        if not _METRIC_NAME_RE.match(name):
            add(
                first.file,
                first.line,
                f"metric name {name!r} is not lowercase photon_ snake_case",
            )
        kinds = sorted({s.kind for s in fam})
        if len(kinds) > 1:
            offender = next(s for s in fam if s.kind != first.kind)
            add(
                offender.file,
                offender.line,
                f"metric {name!r} registered as {offender.kind} here but as "
                f"{first.kind} at {first.file}:{first.line} — one family, "
                "one kind",
            )
        kind = first.kind
        if kind == "counter" and not name.endswith("_total"):
            add(
                first.file,
                first.line,
                f"counter {name!r} must end in _total (Prometheus counter "
                "convention)",
            )
        if kind != "counter" and name.endswith("_total"):
            add(
                first.file,
                first.line,
                f"{kind} {name!r} must not end in _total (reserved for "
                "counters)",
            )
        if any(name.endswith(s) for s in ("_count", "_sum", "_bucket")):
            add(
                first.file,
                first.line,
                f"metric {name!r} ends in a suffix Prometheus reserves for "
                "histogram/summary series (_count/_sum/_bucket)",
            )
        labeled = [s for s in fam if s.labels is not None]
        label_sets = sorted({s.labels for s in labeled})
        if len(label_sets) > 1:
            ref = labeled[0]
            offender = next(s for s in labeled if s.labels != ref.labels)
            add(
                offender.file,
                offender.line,
                f"metric {name!r} used with labels {list(offender.labels)} "
                f"here but {list(ref.labels)} at {ref.file}:{ref.line} — "
                "label keys must agree across a family",
            )

    # docs drift, both directions
    docs_tokens: Dict[str, int] = {}
    docs_ok = False
    for rel in config.metric_docs:
        path = os.path.join(config.root, rel)
        if not os.path.isfile(path):
            continue
        docs_ok = True
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                for m in _DOC_TOKEN_RE.finditer(line):
                    docs_tokens.setdefault(m.group(0), lineno)
    if docs_ok:
        plain = {t for t in docs_tokens if not t.endswith(("_", "_*", "*"))}
        prefixes = {
            t.rstrip("*").rstrip("_") + "_"
            for t in docs_tokens
            if t.endswith(("_", "_*", "*"))
        }
        for name in sorted(families):
            if name in plain or any(name.startswith(p) for p in prefixes):
                continue
            first = families[name][0]
            add(
                first.file,
                first.line,
                f"metric {name!r} is not documented in "
                f"{'/'.join(config.metric_docs)} — every series a dashboard "
                "can scrape must be in the metrics reference",
            )
        for dyn in sorted(dynamic_prefixes):
            if any(tok.startswith(dyn) for tok in docs_tokens):
                continue
            site = dynamic_prefixes[dyn]
            add(
                site.file,
                site.line,
                f"dynamically-named metric family {dyn + '*'!r} has no "
                f"{'/'.join(config.metric_docs)} entry starting with its "
                "literal prefix",
            )
        for token in sorted(docs_tokens):
            if token == "photon_ml_tpu" or token.startswith("photon_ml_tpu"):
                continue
            if any(token.startswith(d) for d in dynamic_prefixes):
                continue
            if token in plain and token not in families:
                add(
                    config.metric_docs[0],
                    docs_tokens[token],
                    f"documented metric {token!r} is registered nowhere in "
                    "the package — stale docs or a renamed series",
                )
            prefix = token.rstrip("*").rstrip("_") + "_"
            if token not in plain and not any(
                n.startswith(prefix) for n in families
            ):
                add(
                    config.metric_docs[0],
                    docs_tokens[token],
                    f"documented metric prefix {token!r} matches no "
                    "registered series",
                )
    return findings


# --------------------------------------------------------------------------
# entry point


PROJECT_RULE_IDS = ("R9", "R10", "R11", "R13", "R14", "R15", "R16")

# rules that need the symbol table (and, bar R14, the walked bodies)
_TABLE_RULES = ("R9", "R13", "R14", "R15")


def analyze_project(
    sources: Mapping[str, str],
    config: Optional[LintConfig] = None,
    rules: Optional[Sequence[str]] = None,
) -> ProjectResult:
    """Run the cross-module passes over ``{relpath: source}``. R10/R11/R16
    read their docs/tests/inventory counterparts from ``config.root``."""
    # the dataflow passes import from this module; import lazily to keep the
    # package import graph acyclic
    from . import dataflow

    config = config or LintConfig()
    enabled = set(rules) if rules is not None else set(PROJECT_RULE_IDS)
    findings: List[ProjectFinding] = []
    errors: List[str] = []
    annotations: List[Annotation] = []
    used: Set[Tuple[str, int]] = set()
    inventory: Optional[Dict] = None
    fault_inventory: Optional[Dict] = None

    for rel in sorted(sources):
        annotations.extend(parse_annotations(sources[rel], rel))

    table: Optional[_SymbolTable] = None
    if enabled & set(_TABLE_RULES):
        table = _SymbolTable(sources)
        walk_bodies(table)

    if "R9" in enabled:
        # record global assignment lines for annotation resolution
        for mod in table.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Name)
                            and t.id in mod.mutated_globals
                        ):
                            mod.global_assign_lines.setdefault(
                                node.lineno, set()
                            ).add(t.id)
        r9, r9_errors, r9_used = run_r9(table, config, annotations)
        findings.extend(r9)
        errors.extend(r9_errors)
        used |= r9_used
    if "R10" in enabled:
        r10, inventory = run_r10(sources, config)
        findings.extend(r10)
    if "R11" in enabled:
        findings.extend(run_r11(sources, config))
    if "R13" in enabled:
        r13, r13_errors, r13_used = dataflow.run_r13(table, annotations)
        findings.extend(r13)
        errors.extend(r13_errors)
        used |= r13_used
    if "R14" in enabled:
        findings.extend(dataflow.run_r14(table))
    if "R15" in enabled:
        r15, r15_errors, r15_used = dataflow.run_r15(table, annotations)
        findings.extend(r15)
        errors.extend(r15_errors)
        used |= r15_used
    if "R16" in enabled:
        r16, fault_inventory = dataflow.run_r16(sources, config)
        findings.extend(r16)

    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return ProjectResult(
        findings=findings,
        errors=errors,
        annotations=annotations,
        used_annotations=used,
        refusal_inventory=inventory,
        fault_inventory=fault_inventory,
    )
