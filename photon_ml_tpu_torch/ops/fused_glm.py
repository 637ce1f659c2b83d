"""Single-sweep dense GLM aggregates: the CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_glm.py``:

- ``fused_value_grad``: ``(sum_i wt_i l_i, X^T(wt*dz), sum_i wt_i dz_i)``
  with ``z = X.eff_coef + offsets`` (replaces ``_vg_kernel``);
- ``fused_hessian_vector``: ``(X^T(c*u), sum_i c_i u_i)`` with
  ``c = wt*l''(z)`` and ``u = X.eff_v + vshift`` (replaces ``_hv_kernel``);
- ``fused_hessian_stats``: ``s2 = (X*X)^T c`` and, with ``need_shifts``,
  ``s1 = X^T c`` and ``s0 = sum_i c_i`` (replaces ``_hd_kernel``).

and, over a batch sharded across ``torch.distributed`` ranks (B4, replacing
``_shard_psum_call`` and the ``sharded_*`` wrappers):

- ``sharded_value_grad``, ``sharded_hessian_vector``, ``sharded_hessian_stats``:
  each rank runs the kernel above on its row shard, its finalize writing the
  totals (the f32 values widened to float64) into the rank's row of the
  group's cached ``[world, width]`` slot buffer; one all-gather fills the
  other rows (``DataParallelGroup.gather_slots``: on NCCL in stream order,
  with no host wait), and ``rank_order_sum``, a kernel of its own, adds the
  rows in rank order in float64 into the f32 outputs, so that every rank
  gets bitwise the same numbers. On the CPU the plain versions' outputs go
  into the slot row and ``rank_order_sum_plain`` adds them. ``group=None``
  is the one-process call.

and over the row slices of a streamed batch (``game/fe_streaming.py``):

- ``slice_value_grad``, ``slice_hessian_vector``: slice k's kernel writes its
  totals into row k of the pass's ``[n_slices, width]`` float64 slot buffer
  (``slice_slots``), the same finalize-into-slot mode; at the end of the
  pass ``slices_total`` adds the rows in slice order with the same
  ``rank_order_sum`` kernel, a fixed left-to-right order with no float
  atomics. A sparse slice's products (the segment kernel) go into the slots
  through ``fill_slot``.

``offsets`` already carry the normalization margin shift, so the shift and
factor algebra stays in ``ops/glm.py``. The kernels live in
``csrc/fused_glm.cu``; each wrapper launches its kernel for a CUDA tensor and
raises on anything the kernel does not take, and runs the plain version only
for a tensor that lies on the CPU. The plain versions are the unfused
compositions (X read twice for value+grad, three times for Hv, two or three
times for the Hessian stats) with the kernel's bf16 rounding points: the
coefficients round to X's dtype, and so does the per-row weight before the
column product. ``x*x`` is taken in the compute dtype, where the square of a
bf16 value is exact (the TPU kernel rounds it to bf16 for its bf16 dot).

``LAUNCHES`` counts the kernel launches of each wrapper, and
``SHARDED_LAUNCHES`` those of the ``sharded_*`` wrappers over a group (one
per call whose rank launched its kernel); ``SUM_LAUNCHES`` those of the
rank-order sum kernel; ``SHIFT_LAUNCHES`` B3's launches with the
normalization shift terms; ``OBJECTIVE_ROUTES`` the route each solve took
(``game/problem.py``); ``ROUTES`` counts the same
launches by the body that ran them: the ring body with its tiles by bulk
copy (``ring_bulk_copy``) or by plain loads (``ring_plain_loads``, rows not
16-byte aligned), or the staged body (``staged``: the Hessian statistics,
and value+grad and Hv wider than ``RING_MAX_D``). Nothing else touches them
but ``reset_launch_counts``.

Launch plans are cached per (device, mode, dtype, n, d, alignment, body):
the plan sets the kernel's shared-memory attribute and queries occupancy,
which is host time the solvers would otherwise pay on every evaluation.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_lib, lane_reduce, sparse
from .losses import PointwiseLoss

Tensor = torch.Tensor

LAUNCHES = {"fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 0}
SHARDED_LAUNCHES = {"sharded_value_grad": 0, "sharded_hessian_vector": 0, "sharded_hessian_stats": 0}
SUM_LAUNCHES = {"rank_order_sum": 0}
# B3's launches with the normalization shift terms (a part of LAUNCHES'
# fused_hessian_stats)
SHIFT_LAUNCHES = {"fused_hessian_stats": 0}
ROUTES = {"ring_bulk_copy": 0, "ring_plain_loads": 0, "staged": 0}
# the objective route of each solve (game/problem.py ``_fusion_mode``)
OBJECTIVE_ROUTES = {
    "dense_kernel": 0, "sparse_kernel": 0, "tiled_kernel": 0, "tiled_dense": 0, "plain_cpu": 0, "plain_float64": 0,
}

# sweep modes, bodies, finalizes and launch steps of csrc/fused_glm.cu
# (enum Mode, enum Body, enum Finalize, kStep*)
VG, HV, HD, HD_SHIFTS = 0, 1, 2, 3
STAGED, RING = 0, 1
FINALIZE_SERIAL, FINALIZE_TREE = 0, 1
STEP_MAIN, STEP_FINALIZE = 1, 2
RING_MAX_D = 1024  # kRingMaxD: 32 columns per lane held in registers

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    """Zero every counter: these, the objective routes, the segment
    kernel's ``sparse.SPARSE_LAUNCHES`` and the lane reduction's
    ``lane_reduce.LANE_LAUNCHES``."""
    for counts in (LAUNCHES, SHARDED_LAUNCHES, SUM_LAUNCHES, SHIFT_LAUNCHES, ROUTES, OBJECTIVE_ROUTES):
        for k in counts:
            counts[k] = 0
    sparse.reset_launch_counts()
    lane_reduce.reset_launch_counts()


def _round_like_x(v: Tensor, x_dtype: torch.dtype) -> Tensor:
    """The kernel's rounding point: a bf16 X rounds the value to f32 and
    then to bf16 (the reference rounds its f32 value)."""
    if x_dtype == torch.bfloat16:
        return v.to(torch.float32).to(torch.bfloat16).to(v.dtype)
    return v


def _compute_dtype(x: Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    if compute_dtype is not None:
        return compute_dtype
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def value_grad_plain(
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``fused_value_grad``: two ``torch.mv`` sweeps of X.
    ``compute_dtype`` (float64 for a reference) widens the already-rounded
    inputs; by default it is f32 for a bf16 X and X's own dtype otherwise."""
    cd = _compute_dtype(x, compute_dtype)
    xc = x.to(cd)
    coef = eff_coef.to(x.dtype).to(cd)
    z = torch.mv(xc, coef) + offsets.to(cd)
    l, dz = loss.loss_and_dz(z, labels.to(cd))
    wt = weights.to(cd)
    wdz = wt * dz
    grad = torch.mv(xc.T, _round_like_x(wdz, x.dtype))
    return torch.sum(wt * l), grad, torch.sum(wdz)


def hessian_vector_plain(
    x: Tensor,
    eff_coef: Tensor,
    eff_v: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    vshift,
    loss: PointwiseLoss,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain version of ``fused_hessian_vector``: three ``torch.mv`` sweeps."""
    cd = _compute_dtype(x, compute_dtype)
    xc = x.to(cd)
    z = torch.mv(xc, eff_coef.to(x.dtype).to(cd)) + offsets.to(cd)
    u = torch.mv(xc, eff_v.to(x.dtype).to(cd)) + torch.as_tensor(vshift, dtype=cd, device=x.device)
    cu = weights.to(cd) * loss.d2z(z, labels.to(cd)) * u
    hv = torch.mv(xc.T, _round_like_x(cu, x.dtype))
    return hv, torch.sum(cu)


def hessian_stats_plain(
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    need_shifts: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """Plain version of ``fused_hessian_stats``: ``(s2, s1, s0)``, the last
    two ``None`` without ``need_shifts``."""
    cd = _compute_dtype(x, compute_dtype)
    xc = x.to(cd)
    z = torch.mv(xc, eff_coef.to(x.dtype).to(cd)) + offsets.to(cd)
    c = weights.to(cd) * loss.d2z(z, labels.to(cd))
    cr = _round_like_x(c, x.dtype)
    s2 = torch.mv((xc * xc).T, cr)
    if not need_shifts:
        return s2, None, None
    return s2, torch.mv(xc.T, cr), torch.sum(c)


def _vec(name: str, t: Tensor, n: int, device: torch.device, dtype: torch.dtype) -> Tensor:
    if t.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    return t.to(dtype).contiguous()


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("fused_glm")
    if lib.fused_glm_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        pi = ctypes.POINTER(i)
        lib.fused_glm_plan.argtypes = [i, i, ll, i, i, i, pi, pi, pi, ctypes.POINTER(ll)]
        lib.fused_glm_plan.restype = i
        lib.fused_glm_blocks_per_sm.argtypes = [i, i, i, i, ll, pi]
        lib.fused_glm_blocks_per_sm.restype = i
        lib.fused_glm_launch.argtypes = [
            i, i, i, i, i, p, p, p, p, p, p, p, ll, i, i, i, i, i, ll, i, p, p, p, p,
        ]
        lib.fused_glm_launch.restype = i
        lib.rank_order_sum_launch.argtypes = [p, i, i, p, p]
        lib.rank_order_sum_launch.restype = i
    return lib


def _out_width(mode: int, d: int) -> int:
    return {VG: d + 2, HV: d + 1, HD: d, HD_SHIFTS: 2 * d + 1}[mode]


def _split(mode: int, d: int, out: Tensor) -> tuple:
    """A wrapper's outputs as views of the flat ``[_out_width]`` output:
    the column sums first, then the scalars (value+grad: ``(value, grad,
    sum wt*dz)``; Hv: ``(hv, sum c*u)``; the Hessian stats: ``(s2, s1, s0)``,
    the last two ``None`` without shifts)."""
    if mode == VG:
        return out[d], out[:d], out[d + 1]
    if mode == HV:
        return out[:d], out[d]
    if mode == HD:
        return out, None, None
    return out[:d], out[d : 2 * d], out[2 * d]


def _flat(mode: int, outs: tuple) -> Tensor:
    """The inverse of ``_split``: a plain version's outputs as one float64
    row in the kernel's output layout."""
    parts = (outs[1], outs[0], outs[2]) if mode == VG else outs
    return torch.cat([o.reshape(-1).to(torch.float64) for o in parts if o is not None])


def body_for(mode: int, d: int) -> int:
    """The body a sweep runs: the ring for value+grad and Hv up to
    ``RING_MAX_D`` columns, the staged body otherwise."""
    return RING if mode in (VG, HV) and d <= RING_MAX_D else STAGED


_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}
_PLAN_CACHE_SIZE = 256


def _plan(lib, key: tuple) -> Tuple[int, int, int, int]:
    """``(grid, rows_per_tile, stages, smem)`` of ``key`` = (device index,
    mode, bf16, n, d, vec16, body), from the cache or from
    ``fused_glm_plan`` (on the current device)."""
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    _, mode, bf16, n, d, vec16, body = key
    grid, rows, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = lib.fused_glm_plan(
        mode, bf16, n, d, body, vec16,
        ctypes.byref(grid), ctypes.byref(rows), ctypes.byref(stages), ctypes.byref(smem),
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_glm_plan failed for n={n}, d={d}, {'bf16' if bf16 else 'f32'}, body {body}: "
            f"CUDA error {rc} (cudaErrorInvalidValue=1: one staged row of X plus its [d] "
            "vectors does not fit in a block's shared memory)"
        )
    if len(_PLANS) >= _PLAN_CACHE_SIZE:
        _PLANS.clear()
    plan = (grid.value, rows.value, stages.value, smem.value)
    _PLANS[key] = plan
    return plan


def _launch(
    mode: int, x, coef, v, labels, offsets, weights, vshift, loss: PointwiseLoss,
    body: Optional[int] = None, finalize: int = FINALIZE_TREE, steps: int = STEP_MAIN | STEP_FINALIZE,
    slot: Optional[Tensor] = None,
) -> Tensor:
    """Check the operands, then run one sweep of ``mode``; returns the
    flat f32 output (see ``_out_width``) or, given a ``slot`` (a contiguous
    float64 ``[_out_width]`` CUDA row, B4's), writes the f32 totals widened
    to float64 there and returns it. ``body`` (default ``body_for``),
    ``finalize`` and ``steps`` select the previous design's body, the
    serial finalize or one step alone, for timing them against each other
    (``chip_smoke.py``)."""
    if x.dim() != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 X, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("X must be contiguous (row-major)")
    n, d = x.shape
    dev = x.device
    coef = _vec("eff_coef", coef, d, dev, x.dtype)
    hv = mode == HV
    if hv:
        v = _vec("eff_v", v, d, dev, x.dtype)
        vshift = torch.as_tensor(vshift, device=dev).to(torch.float32).reshape(1)
    y = _vec("labels", labels, n, dev, torch.float32)
    off = _vec("offsets", offsets, n, dev, torch.float32)
    wt = _vec("weights", weights, n, dev, torch.float32)
    bf16 = int(x.dtype == torch.bfloat16)
    vec16 = int((d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0)
    body = body_for(mode, d) if body is None else body

    lib = _library()
    with torch.cuda.device(dev):
        grid, rows, stages, smem = _plan(lib, (dev.index, mode, bf16, n, d, vec16, body))
        width = _out_width(mode, d)
        if slot is not None and (
            slot.shape != (width,) or slot.dtype != torch.float64 or slot.device != dev
            or not slot.is_contiguous()
        ):
            raise ValueError(
                f"the slot must be a contiguous float64 ({width},) row on {dev}, got "
                f"{slot.dtype} {tuple(slot.shape)} on {slot.device}"
            )
        part = torch.empty((grid, width), dtype=torch.float32, device=dev)
        out = torch.empty(width, dtype=torch.float32, device=dev) if slot is None else None
        rc = lib.fused_glm_launch(
            mode, bf16, body, finalize, steps, x.data_ptr(), coef.data_ptr(),
            v.data_ptr() if hv else None, y.data_ptr(), off.data_ptr(), wt.data_ptr(),
            vshift.data_ptr() if hv else None, n, d, loss.code, grid, rows, stages, smem, vec16,
            part.data_ptr(), None if out is None else out.data_ptr(),
            None if slot is None else slot.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_glm_launch failed: CUDA error {rc}")
    ROUTES[route_name(body, vec16)] += 1
    return slot if out is None else out


def route_name(body: int, vec16: int) -> str:
    """The ``ROUTES`` key of a launch."""
    if body == STAGED:
        return "staged"
    return "ring_bulk_copy" if vec16 else "ring_plain_loads"


def plan_of(x: Tensor, mode: int, body: Optional[int] = None) -> dict:
    """The launch plan of a sweep of ``mode`` over the CUDA tensor ``x``,
    with the blocks per SM that the occupancy calculator allows it: for the
    record (``chip_smoke.py`` prints it)."""
    n, d = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    vec16 = int((d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0)
    body = body_for(mode, d) if body is None else body
    lib = _library()
    with torch.cuda.device(x.device):
        grid, rows, stages, smem = _plan(lib, (x.device.index, mode, bf16, n, d, vec16, body))
        per_sm = ctypes.c_int()
        rc = lib.fused_glm_blocks_per_sm(mode, bf16, body, vec16, smem, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"fused_glm_blocks_per_sm failed: CUDA error {rc}")
    return {
        "body": "ring" if body == RING else "staged", "route": route_name(body, vec16),
        "grid": grid, "rows_per_tile": rows, "stages": stages, "smem_bytes": smem,
        "blocks_per_sm": per_sm.value,
    }


def _require_cuda(x: Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the fused GLM kernels run on CUDA tensors (plain version on CPU only), got {x.device}"
        )


def fused_value_grad(
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One sweep of dense X: ``(sum wt*l, X^T(wt*dz), sum wt*dz)``, f32 outputs
    on the card. A CPU tensor takes ``value_grad_plain``."""
    if x.device.type == "cpu":
        return value_grad_plain(x, eff_coef, labels, offsets, weights, loss)
    _require_cuda(x)
    out = _launch(VG, x, eff_coef, None, labels, offsets, weights, None, loss)
    LAUNCHES["fused_value_grad"] += 1
    return _split(VG, x.shape[1], out)


def fused_hessian_vector(
    x: Tensor,
    eff_coef: Tensor,
    eff_v: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    vshift,
    loss: PointwiseLoss,
) -> Tuple[Tensor, Tensor]:
    """One sweep of dense X: ``(X^T(c*u), sum c*u)``, f32 outputs on the card.
    A CPU tensor takes ``hessian_vector_plain``."""
    if x.device.type == "cpu":
        return hessian_vector_plain(x, eff_coef, eff_v, labels, offsets, weights, vshift, loss)
    _require_cuda(x)
    out = _launch(HV, x, eff_coef, eff_v, labels, offsets, weights, vshift, loss)
    LAUNCHES["fused_hessian_vector"] += 1
    return _split(HV, x.shape[1], out)


def fused_hessian_stats(
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    need_shifts: bool = False,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """One sweep of dense X: ``(s2, s1, s0)`` with ``c = wt*l''(z)``,
    ``s2 = (X*X)^T c``, ``s1 = X^T c`` and ``s0 = sum c`` (the last two
    ``None`` without ``need_shifts``), f32 outputs on the card. A CPU tensor
    takes ``hessian_stats_plain``."""
    if x.device.type == "cpu":
        return hessian_stats_plain(x, eff_coef, labels, offsets, weights, loss, need_shifts)
    _require_cuda(x)
    mode = HD_SHIFTS if need_shifts else HD
    out = _launch(mode, x, eff_coef, None, labels, offsets, weights, None, loss)
    LAUNCHES["fused_hessian_stats"] += 1
    SHIFT_LAUNCHES["fused_hessian_stats"] += int(need_shifts)
    return _split(mode, x.shape[1], out)


def rank_order_sum_plain(slots: Tensor, dtype: torch.dtype) -> Tensor:
    """Plain version of ``rank_order_sum``: the rows of ``slots`` added in
    rank order in float64, cast to ``dtype``; a fresh tensor, never a view
    of ``slots``."""
    acc = slots[0].clone()
    for r in range(1, slots.shape[0]):
        acc += slots[r]
    return acc.to(dtype)


def rank_order_sum(slots: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """B4's sum over ranks: column j of the ``[world, width]`` float64
    ``slots`` added in rank order in float64 (``s[0] + s[1] + ...``) and
    written as ``dtype`` into a new ``[width]`` tensor: on the card one CUDA
    launch, float32 only (the kernels' and the card's plain sweeps' outputs);
    a CPU tensor takes ``rank_order_sum_plain`` (float64 too, for a float64
    batch)."""
    if slots.device.type == "cpu":
        return rank_order_sum_plain(slots, dtype)
    _require_cuda(slots)
    if slots.dim() != 2 or slots.dtype != torch.float64 or not slots.is_contiguous():
        raise ValueError(
            f"slots must be a contiguous float64 [world, width] tensor, got {slots.dtype} "
            f"{tuple(slots.shape)}"
        )
    if dtype != torch.float32:
        raise TypeError(f"the rank-order sum kernel writes float32, got {dtype}")
    world, width = slots.shape
    out = torch.empty(width, dtype=dtype, device=slots.device)
    lib = _library()
    with torch.cuda.device(slots.device):
        rc = lib.rank_order_sum_launch(
            slots.data_ptr(), world, width, out.data_ptr(), torch.cuda.current_stream(slots.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rank_order_sum_launch failed for world {world}, width {width}: CUDA error {rc}")
    SUM_LAUNCHES["rank_order_sum"] += 1
    return out


_KERNEL_NAMES = {VG: "fused_value_grad", HV: "fused_hessian_vector", HD: "fused_hessian_stats",
                 HD_SHIFTS: "fused_hessian_stats"}


def _plain(mode: int, x, coef, v, labels, offsets, weights, vshift, loss: PointwiseLoss) -> tuple:
    """The plain version of a sweep of ``mode``."""
    if mode == VG:
        return value_grad_plain(x, coef, labels, offsets, weights, loss)
    if mode == HV:
        return hessian_vector_plain(x, coef, v, labels, offsets, weights, vshift, loss)
    return hessian_stats_plain(x, coef, labels, offsets, weights, loss, mode == HD_SHIFTS)


def _sharded(group, name: str, mode: int, plain: bool, x: Tensor, coef, v, labels, offsets, weights,
             vshift, loss: PointwiseLoss) -> tuple:
    """B4 over ``group``: this rank's totals into its row of the group's slot
    buffer (on the card the finalize writes them; on the CPU, or with
    ``plain``, the plain version's outputs are copied there), the rows
    gathered from every rank, and the rank-order sum split into the
    wrapper's outputs. ``SHARDED_LAUNCHES`` counts the calls whose rank
    launched its kernel."""
    width = _out_width(mode, x.shape[1])
    slots = group.slot_buffer(width, x.device)
    launch = not plain and x.device.type != "cpu"
    if launch:
        _require_cuda(x)
        _launch(mode, x, coef, v, labels, offsets, weights, vshift, loss, slot=slots[group.rank])
        LAUNCHES[_KERNEL_NAMES[mode]] += 1
        SHIFT_LAUNCHES["fused_hessian_stats"] += int(mode == HD_SHIFTS)
        dtype = torch.float32
    else:
        outs = _plain(mode, x, coef, v, labels, offsets, weights, vshift, loss)
        dtype = outs[0].dtype
        slots[group.rank] = _flat(mode, outs)
    group.gather_slots(slots)
    # the sum kernel writes float32: a float64 batch's sweep (the route
    # plain_float64) sums by the plain version, as DataParallelGroup.sum does
    total = rank_order_sum(slots, dtype) if dtype == torch.float32 else rank_order_sum_plain(slots, dtype)
    if launch:
        SHARDED_LAUNCHES[name] += 1
    return _split(mode, x.shape[1], total)


def sharded_value_grad(
    group,
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    plain: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``fused_value_grad`` over a row-sharded batch: this rank's rows
    through the kernel (``plain=True``: through ``value_grad_plain``, the
    reference run), then the three aggregates summed over ``group``'s
    ranks. ``group=None`` is the unsharded call."""
    if group is None:
        sweep = value_grad_plain if plain else fused_value_grad
        return sweep(x, eff_coef, labels, offsets, weights, loss)
    return _sharded(group, "sharded_value_grad", VG, plain, x, eff_coef, None, labels, offsets,
                    weights, None, loss)


def sharded_hessian_vector(
    group,
    x: Tensor,
    eff_coef: Tensor,
    eff_v: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    vshift,
    loss: PointwiseLoss,
    plain: bool = False,
) -> Tuple[Tensor, Tensor]:
    """``fused_hessian_vector`` over a row-sharded batch (see
    ``sharded_value_grad``)."""
    if group is None:
        sweep = hessian_vector_plain if plain else fused_hessian_vector
        return sweep(x, eff_coef, eff_v, labels, offsets, weights, vshift, loss)
    return _sharded(group, "sharded_hessian_vector", HV, plain, x, eff_coef, eff_v, labels, offsets,
                    weights, vshift, loss)


def sharded_hessian_stats(
    group,
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    need_shifts: bool = False,
    plain: bool = False,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """``fused_hessian_stats`` over a row-sharded batch (see
    ``sharded_value_grad``)."""
    if group is None:
        sweep = hessian_stats_plain if plain else fused_hessian_stats
        return sweep(x, eff_coef, labels, offsets, weights, loss, need_shifts)
    mode = HD_SHIFTS if need_shifts else HD
    return _sharded(group, "sharded_hessian_stats", mode, plain, x, eff_coef, None, labels, offsets,
                    weights, None, loss)


def slice_slots(n_slices: int, mode: int, d: int, device) -> Tensor:
    """The ``[n_slices, width]`` float64 slot buffer of a streamed pass: row
    k takes slice k's totals (``slice_value_grad`` /
    ``slice_hessian_vector`` / ``fill_slot``), ``slices_total`` adds the
    rows in slice order. Allocate it once and reuse it for every pass."""
    return torch.zeros((n_slices, _out_width(mode, d)), dtype=torch.float64, device=device)


def fill_slot(slots: Tensor, k: int, mode: int, outs: tuple) -> None:
    """Row k of ``slots`` from a sweep's outputs in the wrappers' order
    (value+grad: ``(value, grad, sum wt*dz)``; Hv: ``(hv, sum c*u)``),
    widened to float64: the sparse slices' products and the plain
    versions go into the slots this way."""
    slots[k].copy_(_flat(mode, outs))


def _slice(slots: Tensor, k: int, mode: int, plain: bool, x: Tensor, coef, v, labels,
           offsets, weights, vshift, loss: PointwiseLoss) -> None:
    """One row slice's sweep of ``mode`` into row k of ``slots``: on the card
    the kernel's finalize writes its f32 totals widened to float64 there
    (B4's slot mode); on the CPU, or with ``plain``, the plain version's
    outputs are copied there."""
    if slots.device != x.device:
        raise ValueError(f"the slots are on {slots.device}, X on {x.device}")
    if not plain and x.device.type != "cpu":
        _require_cuda(x)
        _launch(mode, x, coef, v, labels, offsets, weights, vshift, loss, slot=slots[k])
        LAUNCHES[_KERNEL_NAMES[mode]] += 1
        return
    fill_slot(slots, k, mode, _plain(mode, x, coef, v, labels, offsets, weights, vshift, loss))


def slice_value_grad(
    slots: Tensor,
    k: int,
    x: Tensor,
    eff_coef: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    loss: PointwiseLoss,
    plain: bool = False,
) -> None:
    """``fused_value_grad`` over row slice k of a streamed batch, its totals
    into row k of ``slots`` (``slice_slots(.., VG, ..)``); ``plain=True``
    runs ``value_grad_plain`` on the card, the reference run."""
    _slice(slots, k, VG, plain, x, eff_coef, None, labels, offsets, weights, None, loss)


def slice_hessian_vector(
    slots: Tensor,
    k: int,
    x: Tensor,
    eff_coef: Tensor,
    eff_v: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    vshift,
    loss: PointwiseLoss,
    plain: bool = False,
) -> None:
    """``fused_hessian_vector`` over row slice k of a streamed batch (see
    ``slice_value_grad``)."""
    _slice(slots, k, HV, plain, x, eff_coef, eff_v, labels, offsets, weights, vshift, loss)


def slices_total(slots: Tensor, mode: int, d: int, dtype: torch.dtype) -> tuple:
    """The pass's totals: the rows of ``slots`` added in slice order in
    float64 (``rank_order_sum``: one launch on the card for float32
    outputs; the plain version on the CPU and for a float64 batch), split
    into the wrapper's outputs (``_split``). A fixed left-to-right order, so
    a pass's bits do not change from run to run."""
    if slots.device.type == "cpu" or dtype != torch.float32:
        total = rank_order_sum_plain(slots, dtype)
    else:
        total = rank_order_sum(slots, dtype)
    return _split(mode, d, total)


def sweep_bytes(n: int, d: int, x_dtype: torch.dtype, mode: int) -> int:
    """Bytes one call must move: X, the [d] vector(s) in X's dtype, labels,
    offsets and weights (f32) read once; the outputs written once."""
    item = torch.empty((), dtype=x_dtype).element_size()
    hv = mode == HV
    reads = n * d * item + d * item * (2 if hv else 1) + 3 * n * 4 + (4 if hv else 0)
    return reads + 4 * _out_width(mode, d)


def sweep_flops(n: int, d: int, mode: int) -> int:
    """Operations of one call, a multiply-add counted as 2: the row dot(s)
    and the column accumulation(s); the Hessian stats also square x."""
    per_element = {VG: 4, HV: 6, HD: 5, HD_SHIFTS: 7}[mode]
    return per_element * n * d
