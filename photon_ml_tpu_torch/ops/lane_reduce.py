"""V1, the lane reduction of the vmapped random-effect solve: the CUDA
kernel, its wrapper and its plain PyTorch version.

    out[o, i] = sum_r a[o, r, i] * b[o, r, i]      (b absent: 1)

``lane_reduce(a, b, dim)`` sums over the last axis (``dim=-1``: a 2-D
``[E, S]`` lane stack or a 3-D ``[E, K, S]`` block) or over the middle axis
of a 3-D block (``dim=1``); ``b`` broadcasts against ``a`` and is read in
place. Its plain version is ``torch.sum(a * b, dim)``.

On the card the order of the adds depends on the reduced length alone,
never on how many outputs there are (``csrc/lane_reduce.cu``: a warp per
output with a fixed lane stride and butterfly on the last axis, a thread per
output in index order on the middle axis), so an entity's sums have the
same bits in a stack of one as within a stack of 32,768. PyTorch's own CUDA
sums choose their thread layout from the number of outputs too, which gave
an entity solved in a small stack other bits (ROADMAP C7). A CPU tensor
takes the plain version: on the CPU a last-axis ``torch.sum`` already adds
each row in the same order whatever the number of rows.

``LANE_LAUNCHES`` counts the kernel's launches by axis;
``fused_glm.reset_launch_counts`` clears it with the other counters.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib

Tensor = torch.Tensor

AXES = ("last", "middle")
LANE_LAUNCHES = {axis: 0 for axis in AXES}

# (a's dtype, b's dtype) -> the kernel's kind (csrc/lane_reduce.cu)
_KINDS = {
    (torch.float32, torch.float32): 0,
    (torch.float64, torch.float64): 1,
    (torch.bfloat16, torch.float32): 2,
}


def reset_launch_counts() -> None:
    for k in LANE_LAUNCHES:
        LANE_LAUNCHES[k] = 0


def lane_reduce_plain(a: Tensor, b: Optional[Tensor] = None, dim: int = -1) -> Tensor:
    """Plain version of ``lane_reduce``: ``torch.sum`` of the product."""
    return torch.sum(a if b is None else a * b, dim=dim)


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("lane_reduce")
    if lib.lane_reduce_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.lane_reduce_launch.argtypes = [i, i, i, p, p, p] + [ll] * 12 + [p]
        lib.lane_reduce_launch.restype = i
    return lib


def _grid(t: Tensor, dim: int):
    """(O1, O2, R, I) and t's strides over them, for a 2-D or 3-D ``t``
    reduced over its last axis or over the middle axis of three."""
    s = t.stride()
    if t.dim() == 2 and dim == -1:
        E, S = t.shape
        return (E, 1, S, 1), (s[0], 0, s[1], 0)
    if t.dim() == 3 and dim == -1:
        P, Q, R = t.shape
        return (P, Q, R, 1), (s[0], s[1], s[2], 0)
    if t.dim() == 3 and dim == 1:
        P, R, I = t.shape
        return (P, 1, R, I), (s[0], 0, s[1], s[2])
    raise ValueError(
        f"the lane reduction sums the last axis of a 2-D or 3-D tensor or the middle axis of a 3-D one, "
        f"got shape {tuple(t.shape)} over dim {dim}"
    )


def lane_reduce(a: Tensor, b: Optional[Tensor] = None, dim: int = -1) -> Tensor:
    """``sum_r a * b`` over ``dim`` (-1, or 1 of a 3-D ``a``): on the card
    one launch of V1, counted in ``LANE_LAUNCHES``; a CPU tensor takes
    ``lane_reduce_plain``. The kernel takes float32, float64, or bfloat16
    ``a`` with a float32 ``b``, and raises on anything else."""
    if a.device.type == "cpu":
        return lane_reduce_plain(a, b, dim)
    if a.device.type != "cuda":
        raise ValueError(f"the lane reduction runs on CUDA tensors (plain version on CPU only), got {a.device}")
    if dim == a.dim() - 1:
        dim = -1
    kind = _KINDS.get((a.dtype, a.dtype if b is None else b.dtype))
    if kind is None:
        raise TypeError(
            f"the lane reduction takes float32 or float64 operands, or bfloat16 with float32, got {a.dtype} and "
            f"{None if b is None else b.dtype}"
        )
    if b is not None:
        if b.device != a.device:
            raise ValueError(f"a is on {a.device}, b on {b.device}")
        a, b = torch.broadcast_tensors(a, b)
    (O1, O2, R, I), sa = _grid(a, dim)
    sb = (0, 0, 0, 0) if b is None else _grid(b, dim)[1]
    out_dtype = a.dtype if b is None else b.dtype
    out_shape = a.shape[:dim] + a.shape[dim + 1 :] if dim != -1 else a.shape[:-1]
    out = torch.empty(out_shape, dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if R == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.lane_reduce_launch(
            kind, int(b is not None), int(dim == 1), a.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), O1, O2, R, I, *sa, *sb,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"the lane reduction failed over {tuple(a.shape)} (dim {dim}): CUDA error {rc}")
    LANE_LAUNCHES["middle" if dim == 1 else "last"] += 1
    return out
