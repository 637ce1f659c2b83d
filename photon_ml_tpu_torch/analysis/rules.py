"""The port's lint rules (stdlib ``ast`` only).

R1 implicit-device-transfer: in the configured hot-loop modules, a host
   coercion of a ``torch.Tensor`` — ``float()`` / ``int()`` / ``bool()``,
   ``.tolist()``, ``.numpy()``, ``np.asarray()`` / ``np.array()`` — any
   ``.item()``, ``.cpu()`` or ``.to("cpu")`` call, and a Python ``if`` /
   ``while`` / conditional expression or a ``for`` loop on a tensor. Each
   blocks the host thread on the card (a device->host copy waits for every
   kernel queued before it) and none announces itself. Keep the value on the
   card, or fetch explicitly through ``device.fetch`` /
   ``analysis.runtime.logged_fetch`` (counted by obs and lifted past the
   runtime transfer guard).

R2 graph-capture hazard: inside a ``with torch.cuda.graph(...):`` block or
   between ``capture_begin()`` and ``capture_end()`` — the port's trace-once,
   replay-many region — a Python branch on a tensor, a host coercion of one
   (as R1 lists them), an f-string formatting one, or a synchronizing call
   (``torch.cuda.synchronize``, ``.synchronize()``, ``nonzero``,
   ``unique``, ``masked_select``). A branch is decided once at capture and
   replayed for every later input; a sync is illegal while a stream
   captures.

R3 dtype-discipline: hardcoded ``4`` / ``8`` itemsize multipliers in
   byte-accounting code (an f64 dataset under-counted by 2x),
   ``np.float32(...)`` casts and ``.astype(np.float32)`` where the dtype
   should be derived from the data, and — in the configured dtype-strict
   modules — ``torch.tensor(...)`` / ``torch.as_tensor(...)`` without an
   explicit dtype (silently follows the input's or the default dtype).

R4 swallow-and-continue: ``except Exception`` (or bare ``except``) whose
   handler neither re-raises at its top level nor increments an obs counter
   — errors that vanish without a trace in metrics.jsonl. Narrow the
   exception type, re-raise, or call ``obs.swallowed_error(site)``.

R5 non-atomic-write: a direct ``open(..., "w"/"a"/"x")`` (or ``io.open``)
   in the configured atomic-write modules (``io/``, ``robust/``). A crash
   mid-write leaves a torn file the next run half-reads; persistence in
   those trees must go through ``robust.atomic.atomic_write*`` (temp +
   fsync + rename), or carry an explicit ``# photon: ignore[R5]`` stating
   why rename semantics are wrong (e.g. append-only logs).

R6 nan-handling: (a) ``x == nan`` / ``x != nan`` against ``torch.nan`` /
   ``np.nan`` / ``math.nan`` / ``float("nan")`` anywhere — NaN compares
   unequal to everything including itself, so the test is constant (use
   ``torch.isnan`` / ``np.isnan``); (b) in the hot-loop modules,
   ``torch.where(torch.isnan(...), ...)`` or ``nan_to_num`` inside a
   function that increments no obs counter — silently patching NaNs in a hot
   loop hides numerical divergence from every downstream defense (solver
   rollback, coordinate rejection). Count the occurrence, or reject via the
   divergence machinery instead of papering over it.

R7 wall-clock-timing: a direct ``time.time()`` / ``time.perf_counter()`` /
   ``time.monotonic()`` call in the configured timing-strict modules. The
   timeline profiler attributes only what flows through spans: route the
   section through ``obs.span(...)`` / ``timed(...)`` and read the span's
   duration, or suppress cross-thread timestamp plumbing per site.

R8 foreign-import: any import of ``jax``, ``jaxlib`` or ``photon_ml_tpu``
   (the JAX package) anywhere in the port, at any depth — the port runs
   where neither exists — and a module-level ``import torch`` /
   ``from torch... import`` in the configured torch-free modules (the
   lint's static half, the planner, the tuner, the host-only utilities),
   even one wrapped in ``try``/``except``. Import torch inside the function
   that needs it, or under ``if TYPE_CHECKING:`` for annotations.

R9 thread-context-race (whole-program; ``analysis/project.py``): an
   instance attribute or mutated module global written in one execution
   context (a thread entrypoint, discovered or configured) and read or
   written in another without a common lock held on both sides — held
   lexically via ``with self._lock:`` or provably inherited from every call
   site. Declare intent the call graph cannot see on the assignment line:
   ``# photon: guarded-by[lock_attr]`` (validated against the class's real
   lock attributes) or ``# photon: thread-confined`` for
   handoff-at-a-barrier patterns (written by one thread, read by another
   only after an Event/join rendezvous).

R10 refusal-ledger-drift (whole-program): the typed-refusal raise sites,
   the README refusal-ledger table, the support-matrix test pins, and the
   checked-in ``refusals.json`` inventory must agree. A documented fragment
   no raise site produces, a pin the ledger omits, a ledger row no pin
   covers, a refusal-phrased raise the ledger does not document, and a
   stale inventory are each findings.

R11 metric-contract (whole-program): every literal ``photon_*`` series
   registration is checked against the naming conventions (counters end
   ``_total`` and nothing else does; no Prometheus-reserved
   ``_count``/``_sum``/``_bucket`` suffixes; lowercase snake_case), one
   kind and one label-key set per family, and two-way drift against the
   README metrics reference.

R12 unused-suppression: a ``# photon: ignore[RULE]`` that suppresses no
   finding, or a ``guarded-by``/``thread-confined``/``lock-order``/
   ``static-arg`` annotation its rule never needed, is itself a finding
   (mypy's warn-unused-ignores) — stale suppressions silently disable
   future findings at that site. Only checked for rules that actually ran.

R13 lock-order-deadlock (whole-program; ``analysis/dataflow.py``): every
   ``with lock:`` acquisition while other locks are held adds a held->
   acquired edge to a global lock-acquisition graph, and a call made while
   holding a lock adds edges to every lock the callee may transitively
   acquire (propagated over the call graph). A cycle means two threads can
   take the same locks in opposite orders and deadlock. Pin the intended
   global order with ``# photon: lock-order[LockA < LockB]`` (lock names
   are ``Class.attr`` for instance locks, the bare name for module-level
   locks; validated against the known lock set) — the annotation vouches
   the contrary order is unreachable and deletes that edge.

R14 resource-lifecycle (whole-program): a Thread / WorkerPool / socket /
   file / mmap / HTTPServer object bound to a local name must be closed,
   joined, stopped or shut down on *every* control-flow path out of the
   function — including the paths an exception takes (per-function CFG
   with exception edges). ``with`` and ``try/finally`` release on all
   paths; ``daemon=True`` threads are exempt by design; returning the
   object, storing it on an attribute, or passing it to another call
   transfers ownership and ends local responsibility (the ``pool=`` idiom
   in ``io/data.py``).

R15 graph-capture-reachable hazard (whole-program): reachability from a
   CUDA graph capture region (R2's regions) is computed over the call graph,
   so helpers the captured code calls are held to capture discipline too,
   not just the region itself (R2 covers that). In capture-reachable
   functions: a Python ``if``/``while``/short-circuit on a tensor,
   ``float()``/``int()``/``bool()``/``.item()`` coercions, host syncs
   (``.cpu()``, ``.tolist()``, ``.numpy()``, ``synchronize``), and host-side
   mutation of closed-over state (``global``/``nonlocal``/``self.attr``
   writes run once at capture, not per replay). Declare a legitimately
   static operand with ``# photon: static-arg[name]`` on the ``def`` line
   (validated against the real parameter list).

R16 fault-site-inventory (whole-program): the literal
   ``faults.check``/``faults.corrupt`` call sites and ``io_call(...,
   site=...)`` declarations, the checked-in ``faults.json`` inventory, the
   README fault-site table, and an at-least-one-test-exercises-it scan of
   ``tests/`` string literals must agree four ways (the R10 refusal-ledger
   pattern applied to the chaos surface). A stale or missing inventory is
   a finding; regenerate with ``--write-fault-inventory``.

Taint tracking is deliberately local and conservative: names become
"tensor-typed" through parameter annotations (``Tensor``, ``torch.Tensor``)
and through assignment from expressions rooted at ``torch.`` calls or other
tainted names; host-valued attributes (``.shape``, ``.dtype``, ``.device``)
and host-valued calls (``t.numel()``, ``torch.cuda.*``, the explicit
fetches) stop propagation. False negatives are accepted (the runtime
transfer guard backstops them); false positives should be rare enough to
suppress by hand.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "R1": "implicit device->host sync in a hot-loop module",
    "R2": "host sync or tensor branch inside CUDA graph capture",
    "R3": "dtype discipline (hardcoded itemsize / dtype literal)",
    "R4": "swallowed exception (no re-raise, no obs counter)",
    "R5": "non-atomic file write in an atomic-write module",
    "R6": "NaN mishandling (== nan compare / uncounted isnan patch)",
    "R7": "direct wall-clock timing in a timing-strict module (use obs.span/timed)",
    "R8": "jax / JAX-package import in the port, or torch import in a torch-free module",
    "R9": "cross-thread shared-state access with no common lock",
    "R10": "refusal ledger drift (code / README / test pins / refusals.json)",
    "R11": "photon_* metric-name contract violation",
    "R12": "unused suppression or annotation",
    "R13": "lock-order cycle across the call graph (deadlock hazard)",
    "R14": "resource not released on every path (incl. exception edges)",
    "R15": "host sync or tensor branch in a function reachable from graph capture",
    "R16": "fault-site inventory drift (code / inventory / docs / tests)",
}

# attributes whose value is host metadata, not a tensor: reading them off a
# tensor neither syncs nor yields a tensor
_HOST_ATTRS = {
    "shape",
    "dtype",
    "ndim",
    "size",
    "nbytes",
    "itemsize",
    "device",
    "is_cuda",
    "is_sparse",
    "layout",
    "requires_grad",
    "coordinate_id",
    "name",
}

# torch-rooted callables that return host values (not tensors)
_HOST_VALUED_CALLS = {
    "torch.is_tensor",
    "torch.is_floating_point",
    "torch.is_complex",
    "torch.numel",
    "torch.device",
    "torch.finfo",
    "torch.iinfo",
    "torch.get_default_dtype",
    "torch.promote_types",
    "torch.result_type",
    "torch.can_cast",
    "torch.Size",
    "torch.Generator",
    "torch.no_grad",
    "torch.inference_mode",
    "torch.manual_seed",
    "torch.get_num_threads",
}
# torch namespaces whose callables return host objects (devices, streams,
# events, work handles, counters), never tensors
_HOST_VALUED_PREFIXES = (
    "torch.cuda.",
    "torch.distributed.",
    "torch.backends.",
    "torch.version.",
    "torch.profiler.",
    "torch.utils.",
    "torch.testing.",
    "torch.multiprocessing.",
)

# tensor methods that return host values: the syncing ones (flagged by R1
# on their own) and the metadata ones (no sync at all)
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_HOST_VALUED_METHODS = _SYNC_METHODS | {
    "size",
    "dim",
    "numel",
    "nelement",
    "element_size",
    "stride",
    "data_ptr",
    "storage_offset",
    "is_contiguous",
    "is_floating_point",
    "get_device",
    "synchronize",
}

_ARRAY_ANNOTATIONS = {"Tensor", "torch.Tensor"}

# calls that synchronize the host with the card whatever their arguments:
# an explicit wait, or an op whose output shape depends on the data
_SYNC_CALLS = {
    "torch.cuda.synchronize",
    "torch.nonzero",
    "torch.unique",
    "torch.masked_select",
}
_SYNC_CALL_METHODS = {"synchronize", "nonzero", "unique", "masked_select"}

# the contexts that capture a CUDA graph
_GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

_ITEMSIZE_CONTEXT_RE = re.compile(
    r"bytes|itemsize|budget|hbm|frombuffer|memmap", re.IGNORECASE
)


@dataclasses.dataclass(frozen=True)
class RawFinding:
    line: int
    col: int
    rule: str
    message: str


AddFn = Callable[[int, int, str, str], None]


# --------------------------------------------------------------------------
# shared helpers


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """local name -> canonical dotted module ('F' -> 'torch.nn.functional')."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _canon(dotted: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _is_torch_rooted(canonical: Optional[str]) -> bool:
    return bool(canonical) and (
        canonical == "torch" or canonical.startswith("torch.")
    )


def _is_host_valued_call(canonical: Optional[str]) -> bool:
    return bool(canonical) and (
        canonical in _HOST_VALUED_CALLS
        or canonical.startswith(_HOST_VALUED_PREFIXES)
    )


def _annotation_is_array(ann: Optional[ast.AST]) -> bool:
    """The annotation is a tensor: ``Tensor``, ``Optional[Tensor]``, a union
    holding one, or one of these as a string. A container of tensors
    (``Sequence[Tensor]``, ``Mapping[str, Tensor]``) is not: its iteration
    and truth test stay on the host."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if _dotted(ann) in _ARRAY_ANNOTATIONS:
        return True
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _annotation_is_array(ann.left) or _annotation_is_array(ann.right)
    if isinstance(ann, ast.Subscript) and (_dotted(ann.value) or "").split(".")[
        -1
    ] in ("Optional", "Union"):
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return any(_annotation_is_array(e) for e in elts)
    return False


def _param_names(fn) -> List[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)] + [
        p.arg for p in (a.vararg, a.kwarg) if p is not None
    ]


def _expr_is_tensor(node: ast.AST, tainted: Set[str], aliases: Dict[str, str]) -> bool:
    """Conservative 'this expression evaluates to a tensor'."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_ATTRS:
            return False
        d = _canon(_dotted(node), aliases)
        if d and _is_torch_rooted(d):
            # bare torch.float32 / torch.Tensor etc.: dtype/class objects
            return False
        return _expr_is_tensor(node.value, tainted, aliases)
    if isinstance(node, ast.Call):
        d = _canon(_dotted(node.func), aliases)
        if d:
            if _is_host_valued_call(d):
                return False
            if _is_torch_rooted(d):
                return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _HOST_VALUED_METHODS:
                return False
            # method call on a tensor receiver: x.to(...), x.sum(), ...
            return _expr_is_tensor(node.func.value, tainted, aliases)
        return False
    if isinstance(node, ast.BinOp):
        return _expr_is_tensor(node.left, tainted, aliases) or _expr_is_tensor(
            node.right, tainted, aliases
        )
    if isinstance(node, ast.UnaryOp):
        return _expr_is_tensor(node.operand, tainted, aliases)
    if isinstance(node, ast.Compare):
        return _expr_is_tensor(node.left, tainted, aliases) or any(
            _expr_is_tensor(c, tainted, aliases) for c in node.comparators
        )
    if isinstance(node, ast.Subscript):
        return _expr_is_tensor(node.value, tainted, aliases)
    if isinstance(node, ast.IfExp):
        return _expr_is_tensor(node.body, tainted, aliases) or _expr_is_tensor(
            node.orelse, tainted, aliases
        )
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_expr_is_tensor(e, tainted, aliases) for e in node.elts)
    return False


def _own_nodes(fn) -> List[ast.AST]:
    """All nodes of a function body EXCLUDING nested function/class bodies
    (those are analyzed in their own scope)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _propagate_taint(
    fn, seed: Set[str], aliases: Dict[str, str], rounds: int = 3
) -> Set[str]:
    """Fixpoint (bounded) over single-name assignments in the function's own
    scope: a name assigned a tensor expression becomes tensor-typed."""
    tainted = set(seed)
    nodes = _own_nodes(fn)
    for _ in range(rounds):
        before = len(tainted)
        for node in nodes:
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            if value is None or not _expr_is_tensor(value, tainted, aliases):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
        if len(tainted) == before:
            break
    return tainted


def _tensor_taint(fn, aliases: Dict[str, str]) -> Set[str]:
    """Names of ``fn``'s own scope that hold tensors: ``Tensor``-annotated
    parameters and what torch-rooted expressions are assigned to."""
    seed = {
        p.arg
        for p in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs)
        if _annotation_is_array(p.annotation)
    }
    return _propagate_taint(fn, seed, aliases)


class _Module:
    """Parsed module + shared lookups for the rule passes."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.aliases = _import_aliases(tree)
        self.functions: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)

    def walk_functions(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


def _to_cpu(node: ast.Call, aliases: Dict[str, str]) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    for arg in [*node.args, *(kw.value for kw in node.keywords if kw.arg == "device")]:
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return True
        if (
            isinstance(arg, ast.Call)
            and _canon(_dotted(arg.func), aliases) == "torch.device"
            and arg.args
            and isinstance(arg.args[0], ast.Constant)
            and arg.args[0].value == "cpu"
        ):
            return True
    return False


def _host_sync(
    node: ast.Call, tainted: Set[str], aliases: Dict[str, str]
) -> Optional[str]:
    """What makes ``node`` an implicit device->host sync, or None: a host
    coercion of a tensor, or a call that always copies to the host."""
    d = _canon(_dotted(node.func), aliases)
    if isinstance(node.func, ast.Attribute) and not node.args and not node.keywords:
        attr = node.func.attr
        if attr in ("item", "cpu"):
            return f".{attr}()"
        if attr in ("tolist", "numpy") and _expr_is_tensor(
            node.func.value, tainted, aliases
        ):
            return f".{attr}() on a tensor"
    if _to_cpu(node, aliases):
        return '.to("cpu")'
    if not node.args:
        return None
    first = node.args[0]
    if d in ("float", "int", "bool") and len(node.args) == 1:
        if _expr_is_tensor(first, tainted, aliases):
            return f"{d}() on a tensor"
    elif d in ("numpy.asarray", "numpy.array"):
        if _expr_is_tensor(first, tainted, aliases):
            return f"{d.replace('numpy', 'np')}() on a tensor"
    return None


def _sync_call(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """An explicit wait, or an op whose output shape depends on the data."""
    d = _canon(_dotted(node.func), aliases)
    if d in _SYNC_CALLS:
        return f"{d}()"
    if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_CALL_METHODS:
        return f".{node.func.attr}()"
    return None


# --------------------------------------------------------------------------
# R1: implicit device->host sync in hot-loop modules


def _run_r1(mod: _Module, add: AddFn) -> None:
    aliases = mod.aliases
    for fn in mod.walk_functions():
        tainted = _tensor_taint(fn, aliases)
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                what = _host_sync(node, tainted, aliases)
                if what:
                    add(
                        node.lineno,
                        node.col_offset,
                        "R1",
                        f"{what} blocks on an implicit device->host sync; "
                        "fetch explicitly via device.fetch / "
                        "analysis.runtime.logged_fetch, or keep the value on "
                        "the card",
                    )
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                hit = _names_in_branchable(node.test, aliases) & tainted
                if hit:
                    add(
                        node.lineno,
                        node.col_offset,
                        "R1",
                        f"Python branch on tensor value(s) {sorted(hit)} "
                        "syncs the card to decide it; fetch the flag "
                        "explicitly (device.fetch / logged_fetch) or keep "
                        "the choice on the card (torch.where)",
                    )
            elif isinstance(node, (ast.For, ast.comprehension)):
                if _expr_is_tensor(node.iter, tainted, aliases):
                    add(
                        node.iter.lineno,
                        node.iter.col_offset,
                        "R1",
                        "Python loop over a tensor walks the card's elements "
                        "from the host one by one; fetch it once explicitly "
                        "or vectorize",
                    )


# --------------------------------------------------------------------------
# R2: CUDA graph capture hazards


def _graph_context(item: ast.withitem, aliases: Dict[str, str]) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and (
        _canon(_dotted(expr.func), aliases) in _GRAPH_CONTEXTS
    )


def _call_attr(stmt: ast.stmt, attr: str) -> bool:
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Call)
        and isinstance(stmt.value.func, ast.Attribute)
        and stmt.value.func.attr == attr
    )


def capture_regions(fn, aliases: Dict[str, str]) -> List[List[ast.stmt]]:
    """The statement runs of ``fn``'s own scope that execute while a CUDA
    graph captures: each ``with torch.cuda.graph(...):`` body, and the
    statements between ``g.capture_begin()`` and ``g.capture_end()`` in one
    block (through the end of the block if the end is missing)."""
    regions: List[List[ast.stmt]] = []

    def visit(stmts: Sequence[ast.stmt]) -> None:
        run: Optional[List[ast.stmt]] = None
        for stmt in stmts:
            if run is not None:
                if _call_attr(stmt, "capture_end"):
                    regions.append(run)
                    run = None
                else:
                    run.append(stmt)
                continue
            if _call_attr(stmt, "capture_begin"):
                run = []
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
                _graph_context(i, aliases) for i in stmt.items
            ):
                regions.append(list(stmt.body))
                continue
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            for field in ("body", "orelse", "finalbody"):
                visit(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                visit(h.body)
        if run is not None:
            regions.append(run)

    visit(fn.body)
    return regions


def region_nodes(region: Sequence[ast.stmt]) -> List[ast.AST]:
    """Every node of a capture region, nested function bodies excluded."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(region)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _run_r2(mod: _Module, add: AddFn) -> None:
    aliases = mod.aliases
    for fn in mod.walk_functions():
        regions = capture_regions(fn, aliases)
        if not regions:
            continue
        tainted = _tensor_taint(fn, aliases)
        where = f"inside CUDA graph capture in {fn.name}()"
        for region in regions:
            for node in region_nodes(region):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    hit = _names_in_branchable(node.test, aliases) & tainted
                    if hit:
                        add(
                            node.lineno,
                            node.col_offset,
                            "R2",
                            f"Python branch on tensor value(s) {sorted(hit)} "
                            f"{where}: the branch is decided once at capture "
                            "and replayed for every later input; use "
                            "torch.where",
                        )
                elif isinstance(node, ast.Call):
                    what = _host_sync(node, tainted, aliases) or _sync_call(
                        node, aliases
                    )
                    if what:
                        add(
                            node.lineno,
                            node.col_offset,
                            "R2",
                            f"{what} syncs the host {where}: a sync is "
                            "illegal while the stream captures; move it "
                            "before the capture or after the replay",
                        )
                elif isinstance(node, ast.JoinedStr):
                    hit: Set[str] = set()
                    for v in node.values:
                        if isinstance(v, ast.FormattedValue):
                            hit |= _names_in_branchable(v.value, aliases) & tainted
                    if hit:
                        add(
                            node.lineno,
                            node.col_offset,
                            "R2",
                            f"f-string formats tensor value(s) {sorted(hit)} "
                            f"{where}: formatting fetches the value, a sync "
                            "the capture cannot hold",
                        )


def _names_in_branchable(test: ast.AST, aliases: Dict[str, str]) -> Set[str]:
    """Names referenced by a test expression, excluding host-valued contexts:
    ``x is None`` checks, ``.shape``-like attributes, len()/isinstance()/
    hasattr()/getattr() arguments, and host-valued calls."""
    names: Set[str] = set()
    skip_roots = (ast.Lambda,)

    def visit(node: ast.AST) -> None:
        if isinstance(node, skip_roots):
            return
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            return
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return
            visit(node.value)
            return
        if isinstance(node, ast.Call):
            d = _canon(_dotted(node.func), aliases)
            if d in ("len", "isinstance", "hasattr", "getattr", "type") or (
                _is_host_valued_call(d)
            ):
                return
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_VALUED_METHODS:
                    return
                visit(node.func.value)
            for a in node.args:
                visit(a)
            for kw in node.keywords:
                visit(kw.value)
            return
        if isinstance(node, ast.Name):
            names.add(node.id)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(test)
    return names


# --------------------------------------------------------------------------
# R3: dtype discipline


def _simple_statements(tree: ast.Module):
    """(enclosing_function_name, stmt) for statements that own their whole
    subtree (no nested statements), so identifier context is local."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fname = node.name
            for sub in _own_nodes(node):
                if isinstance(
                    sub, (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Return, ast.Expr)
                ):
                    yield fname, sub


def _run_r3(mod: _Module, dtype_strict: bool, add: AddFn) -> None:
    aliases = mod.aliases
    flagged: Set[Tuple[int, int]] = set()
    for fname, stmt in _simple_statements(mod.tree):
        idents = [fname]
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name):
                idents.append(node.id)
            elif isinstance(node, ast.Attribute):
                idents.append(node.attr)
        if not _ITEMSIZE_CONTEXT_RE.search(" ".join(idents)):
            continue
        for node in ast.walk(stmt):
            if not isinstance(node, ast.BinOp) or not isinstance(node.op, ast.Mult):
                continue
            for side in (node.left, node.right):
                if (
                    isinstance(side, ast.Constant)
                    and side.value in (4, 8)
                    and side.value is not True
                    and (side.lineno, side.col_offset) not in flagged
                ):
                    flagged.add((side.lineno, side.col_offset))
                    add(
                        side.lineno,
                        side.col_offset,
                        "R3",
                        f"hardcoded itemsize {side.value} in byte accounting; "
                        "derive it from the array's dtype.itemsize (an x64 "
                        "run makes this estimate wrong by 2x)",
                    )
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _canon(_dotted(node.func), aliases)
        if d == "numpy.float32":
            add(
                node.lineno,
                node.col_offset,
                "R3",
                "np.float32(...) cast: derive the dtype from the data "
                "(torch.promote_types / x.dtype) instead of pinning f32",
            )
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
            if node.args:
                arg = node.args[0]
                ad = _canon(_dotted(arg), aliases)
                if ad == "numpy.float32" or (
                    isinstance(arg, ast.Constant) and arg.value == "float32"
                ):
                    add(
                        node.lineno,
                        node.col_offset,
                        "R3",
                        ".astype(float32) literal: derive the dtype from the "
                        "data instead of pinning f32",
                    )
        elif dtype_strict and d in ("torch.tensor", "torch.as_tensor"):
            # torch.tensor takes dtype by keyword only; as_tensor's second
            # positional parameter is the dtype
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords) or (
                d == "torch.as_tensor" and len(node.args) >= 2
            )
            if not has_dtype:
                add(
                    node.lineno,
                    node.col_offset,
                    "R3",
                    f"{d}(...) without an explicit dtype in a "
                    "dtype-strict module: the result silently follows the "
                    "input's or the default dtype; pass dtype= derived from "
                    "the inputs",
                )


# --------------------------------------------------------------------------
# R4: swallow-and-continue


def _handler_is_accounted(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-raises at its top level or increments an obs
    counter anywhere in its body. A call whose final segment ENDS WITH
    ``swallowed_error`` also counts, so modules below obs in the import graph
    can route through a lazy-import wrapper (e.g. ``_swallowed_error``)."""
    for stmt in handler.body:
        if isinstance(stmt, ast.Raise):
            return True
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            seg = d.split(".")[-1] if d else ""
            if seg == "inc" or seg.endswith("swallowed_error"):
                return True
    return False


def _run_r4(mod: _Module, add: AddFn) -> None:
    aliases = mod.aliases
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None
        if node.type is not None:
            types = (
                node.type.elts if isinstance(node.type, ast.Tuple) else [node.type]
            )
            for t in types:
                d = _canon(_dotted(t), aliases) or ""
                if d.split(".")[-1] in ("Exception", "BaseException"):
                    broad = True
        if broad and not _handler_is_accounted(node):
            add(
                node.lineno,
                node.col_offset,
                "R4",
                "broad except swallows errors invisibly: narrow the type, "
                "re-raise at the handler's top level, or call "
                "obs.swallowed_error(site) so the swallow shows up in "
                "metrics.jsonl",
            )


# --------------------------------------------------------------------------
# R5: non-atomic file writes in atomic-write modules


def _open_write_mode(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """The literal write mode of an ``open()`` / ``io.open()`` call, or None
    when the call isn't an open or the mode isn't a write mode. A non-literal
    mode is returned as ``"?"`` (flagged: it may be a write)."""
    d = _canon(_dotted(node.func), aliases)
    if d not in ("open", "io.open"):
        return None
    mode_node: Optional[ast.AST] = None
    if len(node.args) >= 2:
        mode_node = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return None  # default "r"
    if isinstance(mode_node, ast.Constant) and isinstance(mode_node.value, str):
        mode = mode_node.value
        return mode if any(c in mode for c in "wax+") else None
    return "?"


def _run_r5(mod: _Module, add: AddFn) -> None:
    aliases = mod.aliases
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        mode = _open_write_mode(node, aliases)
        if mode is None:
            continue
        what = (
            f"open(..., {mode!r})"
            if mode != "?"
            else "open() with a non-literal mode"
        )
        add(
            node.lineno,
            node.col_offset,
            "R5",
            f"{what} in an atomic-write module: a crash mid-write leaves a "
            "torn file; write through robust.atomic.atomic_write* "
            "(temp+fsync+rename) or justify with # photon: ignore[R5]",
        )


# --------------------------------------------------------------------------
# R6: NaN mishandling

_NAN_CONSTANTS = {"torch.nan", "numpy.nan", "math.nan", "numpy.NaN", "numpy.NAN"}
_WHERE_CALLS = {"torch.where", "numpy.where"}
_ISNAN_CALLS = {"torch.isnan", "numpy.isnan"}
_NAN_TO_NUM_CALLS = {"torch.nan_to_num", "numpy.nan_to_num"}


def _is_nan_expr(node: ast.AST, aliases: Dict[str, str]) -> bool:
    d = _canon(_dotted(node), aliases)
    if d in _NAN_CONSTANTS:
        return True
    # float("nan") / float("NaN")
    if (
        isinstance(node, ast.Call)
        and _canon(_dotted(node.func), aliases) == "float"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
        and node.args[0].value.lower() == "nan"
    ):
        return True
    return False


def _function_has_counter(fn) -> bool:
    """Same accounting convention as R4's handler check: a call whose final
    segment is ``inc`` or ends with ``swallowed_error`` marks the function as
    making its degraded path visible in metrics."""
    for node in _own_nodes(fn):
        if isinstance(node, ast.Call):
            # attr check, not _dotted: the idiomatic chain is
            # registry.counter(...).inc(...) whose base is a Call
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr == "inc"
                or node.func.attr.endswith("swallowed_error")
            ):
                return True
            d = _dotted(node.func)
            if d and d.split(".")[-1].endswith("swallowed_error"):
                return True
    return False


def _run_r6(mod: _Module, hot: bool, add: AddFn) -> None:
    aliases = mod.aliases
    # (a) == / != against a NaN constant: always-constant comparison
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            continue
        operands = [node.left, *node.comparators]
        if any(_is_nan_expr(o, aliases) for o in operands):
            add(
                node.lineno,
                node.col_offset,
                "R6",
                "comparison against nan is constant (NaN != NaN by IEEE 754): "
                "== nan is always False, != nan always True; use "
                "torch.isnan/np.isnan",
            )
    if not hot:
        return
    # (b) torch.where(torch.isnan(...), ...) or nan_to_num in a hot module
    # with no counter in the enclosing function: the NaN is silently
    # replaced, invisible to the divergence defenses
    for fn in mod.walk_functions():
        counted = None  # lazy: only compute when a candidate patch shows up
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _canon(_dotted(node.func), aliases)
            if d in _NAN_TO_NUM_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("nan_to_num", "nan_to_num_")
            ):
                what = "nan_to_num(...)"
            elif d in _WHERE_CALLS and node.args and any(
                isinstance(sub, ast.Call)
                and (
                    _canon(_dotted(sub.func), aliases) in _ISNAN_CALLS
                    or (
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "isnan"
                    )
                )
                for sub in ast.walk(node.args[0])
            ):
                what = "where(isnan(...))"
            else:
                continue
            if counted is None:
                counted = _function_has_counter(fn)
            if not counted:
                add(
                    node.lineno,
                    node.col_offset,
                    "R6",
                    f"{what} in hot function {fn.name}() silently "
                    "patches NaNs with no counter: increment an obs counter "
                    "alongside the patch, or reject the value through the "
                    "divergence machinery (isfinite + rollback) instead",
                )


# --------------------------------------------------------------------------
# R7: direct wall-clock timing in timing-strict modules
#
# The timeline profiler (obs/timeline.py) can only attribute what flows
# through spans. A bare time.time()/time.perf_counter() pair in a hot-loop
# module measures something the timeline cannot see — the measurement is
# invisible to phase attribution, Chrome-trace export, and the JSONL stream.
# Route the section through obs.span(...) / utils.timed(...) and read the
# span's duration_s instead. Cross-thread timestamp plumbing that cannot be
# a span (e.g. enqueue stamps handed to another thread) suppresses with a
# per-site ignore[R7] comment.

_TIMING_CALLS = {"time.time", "time.perf_counter", "time.monotonic"}


def _run_r7(mod: _Module, add: AddFn) -> None:
    aliases = mod.aliases
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canonical = _canon(_dotted(node.func), aliases)
        if canonical in _TIMING_CALLS:
            add(
                node.lineno,
                node.col_offset,
                "R7",
                f"direct {canonical}() timing in a timing-strict module is "
                "invisible to the timeline profiler: wrap the section in "
                "obs.span(...)/timed(...) and read span.duration_s (suppress "
                "cross-thread timestamp plumbing with # photon: ignore[R7])",
            )


# --------------------------------------------------------------------------
# R8: foreign imports
#
# The port runs where neither JAX nor the JAX package is installed, so any
# import of either — at module level, inside a function, under
# TYPE_CHECKING — is a finding in every module. Separately, the torch-free
# modules (the lint's static half, the planner, the tuner, host-only
# utilities) must import without torch: only their *module-level* torch
# imports are flagged (a function-level import inside the one code path that
# needs it is the sanctioned pattern; `if TYPE_CHECKING:` blocks never run).
# A try/except-guarded top-level import is still flagged: with torch
# installed it drags the whole stack into every importer anyway.

_FOREIGN_ROOTS = ("jax", "jaxlib", "photon_ml_tpu")


def _is_foreign(module: str) -> bool:
    return any(module == r or module.startswith(r + ".") for r in _FOREIGN_ROOTS)


def _is_torch(module: str) -> bool:
    return module == "torch" or module.startswith("torch.")


def _run_r8(mod: _Module, torch_free: bool, add: AddFn) -> None:
    for node in ast.walk(mod.tree):
        names: List[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if _is_foreign(name):
                add(
                    node.lineno,
                    node.col_offset,
                    "R8",
                    f"import of `{name}` in the port: the port imports "
                    "neither JAX nor the JAX package, at any depth — keep "
                    "its own copy of what it needs",
                )
    if not torch_free:
        return

    def flag(node: ast.stmt, what: str) -> None:
        add(
            node.lineno,
            node.col_offset,
            "R8",
            f"module-level `{what}` in a torch-free module: it must import "
            "without torch — move the import inside the function that "
            "needs it, or under `if TYPE_CHECKING:`",
        )

    def is_type_checking(test: ast.expr) -> bool:
        return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
            isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
        )

    def visit(stmts: Sequence[ast.stmt]) -> None:
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # function-level imports are the sanctioned pattern
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_torch(alias.name):
                        flag(node, f"import {alias.name}")
            elif isinstance(node, ast.ImportFrom):
                m = node.module or ""
                if node.level == 0 and _is_torch(m):
                    flag(node, f"from {m} import ...")
            elif isinstance(node, ast.If):
                if not is_type_checking(node.test):
                    visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
                visit(node.finalbody)
            elif isinstance(node, (ast.With, ast.ClassDef)):
                visit(node.body)

    visit(mod.tree.body)


def run_rules(
    tree: ast.Module,
    *,
    hot: bool,
    dtype_strict: bool,
    atomic: bool = False,
    timing: bool = False,
    torch_free: bool = False,
    rules: Optional[Sequence[str]] = None,
) -> List[RawFinding]:
    """All rule passes over one parsed module. ``hot`` enables R1 and R6's
    patch subrule; ``dtype_strict`` enables R3's torch.tensor-without-dtype
    subrule; ``atomic`` enables R5 (direct-write detection in persistence
    modules); ``timing`` enables R7 (wall-clock timing outside
    obs.span/timed); ``torch_free`` enables R8's module-level torch-import
    half (its foreign-import half runs everywhere)."""
    mod = _Module(tree)
    out: List[RawFinding] = []
    enabled = set(rules) if rules is not None else set(RULES)

    def add(line: int, col: int, r: str, message: str) -> None:
        if r in enabled:
            out.append(RawFinding(line=line, col=col, rule=r, message=message))

    if hot and "R1" in enabled:
        _run_r1(mod, add)
    if "R2" in enabled:
        _run_r2(mod, add)
    if "R3" in enabled:
        _run_r3(mod, dtype_strict, add)
    if "R4" in enabled:
        _run_r4(mod, add)
    if atomic and "R5" in enabled:
        _run_r5(mod, add)
    if "R6" in enabled:
        _run_r6(mod, hot, add)
    if timing and "R7" in enabled:
        _run_r7(mod, add)
    if "R8" in enabled:
        _run_r8(mod, torch_free, add)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


# --------------------------------------------------------------------------
# --explain: per-rule documentation, sourced from this module's docstring so
# the CLI text and the reference text are one artifact and cannot drift.


def _docstring_sections() -> Dict[str, str]:
    """The ``R<n> ...`` paragraphs of the module docstring, keyed by rule."""
    sections: Dict[str, str] = {}
    current: Optional[str] = None
    buf: List[str] = []
    for line in (__doc__ or "").splitlines():
        m = re.match(r"^(R\d+)\s", line)
        if m and m.group(1) in RULES:
            if current is not None:
                sections[current] = "\n".join(buf).rstrip()
            current, buf = m.group(1), [line]
        elif current is not None and (not line or line.startswith(" ")):
            buf.append(line)
        elif current is not None:
            sections[current] = "\n".join(buf).rstrip()
            current, buf = None, []
    if current is not None:
        sections[current] = "\n".join(buf).rstrip()
    return sections


# (bad, good) minimal examples per rule, printed by --explain
RULE_EXAMPLES: Dict[str, Tuple[str, str]] = {
    "R1": (
        "loss = float(loss_dev)          # blocks on device->host sync",
        'loss = float(logged_fetch("cd.loss", loss_dev))  # counted, attributed',
    ),
    "R2": (
        "with torch.cuda.graph(g):\n    if x.sum() > 0:      # decided once, replayed for every input\n        y.copy_(x)",
        "with torch.cuda.graph(g):\n    y.copy_(torch.where(x.sum() > 0, x, y))",
    ),
    "R3": (
        "hbm_bytes = n_rows * n_cols * 4   # wrong for x64 inputs",
        "hbm_bytes = n_rows * n_cols * arr.dtype.itemsize",
    ),
    "R4": (
        "except Exception:\n    pass                    # error vanishes from metrics.jsonl",
        'except Exception:\n    obs.swallowed_error("decode")\n    part = None',
    ),
    "R5": (
        'with open(ckpt_path, "w") as f:   # torn file on crash\n    f.write(payload)',
        "atomic_write_text(ckpt_path, payload)  # temp + fsync + rename",
    ),
    "R6": (
        "if x == torch.nan:               # always False",
        "if torch.isnan(x).any():",
    ),
    "R7": (
        "t0 = time.perf_counter()\nsolve()\ndt = time.perf_counter() - t0   # invisible to the timeline",
        'with obs.span("solver.solve"):\n    solve()',
    ),
    "R8": (
        "import torch                      # at module level in plan/",
        "def resolve_device():\n    import torch  # only the caller that needs it pays",
    ),
    "R9": (
        "def _worker(self):\n    self._live = snap          # worker thread writes\n"
        "def poke(self):\n    return self._live          # main thread reads, no lock",
        "def _worker(self):\n    with self._lock:\n        self._live = snap\n"
        "def poke(self):\n    with self._lock:\n        return self._live\n"
        "# or, when a barrier transfers ownership:\n"
        "self._value = None  # photon: thread-confined — read only after _done.wait()",
    ),
    "R10": (
        'raise ValueError("streaming is not supported with mesh sharding")\n'
        "# ...but no README refusal-ledger row / test pin mentions it",
        "# README ledger row + tests/test_support_matrix.py pin + refusals.json\n"
        "# entry all match the raise site (regenerate with\n"
        "# --write-refusal-inventory)",
    ),
    "R11": (
        'REG.counter("photon_requests")    # counter without _total',
        'REG.counter("photon_requests_total")',
    ),
    "R12": (
        "x = compute()  # photon: ignore[R4] — but nothing fires here",
        "x = compute()  # stale suppression deleted",
    ),
    "R13": (
        "def flip(self):\n    with self._lock:\n        self._store.put(k)   # Store.put takes Store._lock\n"
        "# elsewhere: Store.drain() holds Store._lock, then calls back into\n"
        "# a method that takes self._lock — opposite order, deadlock",
        "# release before calling into the other object:\n"
        "def flip(self):\n    with self._lock:\n        k = self._key\n    self._store.put(k)\n"
        "# or pin the one true order (vouches the contrary edge is unreachable):\n"
        "# photon: lock-order[Scorer._lock < Store._lock]",
    ),
    "R14": (
        "def serve(self):\n    t = threading.Thread(target=self._run)\n    t.start()\n"
        "    self._warmup()        # raises -> t never joined, thread leaks",
        "def serve(self):\n    t = threading.Thread(target=self._run)\n    t.start()\n"
        "    try:\n        self._warmup()\n    finally:\n        self._stop.set()\n        t.join()",
    ),
    "R15": (
        "with torch.cuda.graph(g):\n    out.copy_(_clip(w - 0.1 * grad))\n"
        "def _clip(x: Tensor):\n    if x.sum() > 1e3:     # tensor in a Python `if`, one\n"
        "        return x / 10.0   # call below the capture: decided once\n    return x",
        "def _clip(x: Tensor):\n    return torch.where(x.sum() > 1e3, x / 10.0, x)\n"
        "# or, if the operand really is static per capture:\n"
        "def _clip(x, cap):  # photon: static-arg[cap]\n    ...",
    ),
    "R16": (
        "faults.check(<new site>)          # a new chaos site...\n"
        "# ...absent from fault_sites.json, the fault-site table, and\n"
        "# every tests/test_torch_*.py string literal",
        "# fault-site table row + a PHOTON_FAULTS test case naming the\n"
        "# site; fault_sites.json regenerated with --write-fault-inventory",
    ),
}


def explain_rule(rule: str) -> str:
    """Human-readable doc block for one rule: summary, rationale, examples."""
    sections = _docstring_sections()
    out = [f"{rule}: {RULES[rule]}", ""]
    doc = sections.get(rule)
    if doc:
        out.extend([doc, ""])
    bad, good = RULE_EXAMPLES[rule]
    out.append("bad:")
    out.extend(f"    {line}" for line in bad.splitlines())
    out.append("good:")
    out.extend(f"    {line}" for line in good.splitlines())
    return "\n".join(out)
