"""The segmented gather-dot of the sparse layouts: the CUDA kernel, its
wrapper and its plain PyTorch version.

Every product of an ELL or sorted-COO ``FeatureMatrix`` (``ops/features.py``:
``matvec``, ``rmatvec`` and ``sq_rmatvec``) is one call of

    out[s] = sum_{j in segment s} src[gather[j]] * val[j]     (or val[j]**2)

over a ``Segments`` plan that the matrix builds once on the host: segment
pointers ``ptr`` (int64 ``[n_seg + 1]``) or a uniform segment length, the
gather index of every entry (int32) and its value. It replaces the XLA
gathers and scatter-adds of the JAX package's ``ops/features.py``
(``:103-172``; they are not Pallas kernels). The kernel (``csrc/sparse_glm.cu``)
sums each segment in double in a fixed order and writes each output once,
with no atomics: two launches give the same bits. ``index_add_``, the
PyTorch call that computes the same function, adds with atomics on the card.

``segment_dot`` launches the kernel for CUDA tensors (float32 ``src``,
float32 or bfloat16 values) and raises on anything it does not take; a CPU
tensor takes ``segment_dot_plain`` (gather, multiply, ``index_add_`` in
float64). ``SPARSE_LAUNCHES`` counts the kernel's launches by product;
``fused_glm.reset_launch_counts`` clears it with the other counters.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_lib

Tensor = torch.Tensor

PRODUCTS = tuple(
    f"{layout}_{product}" for layout in ("ell", "coo") for product in ("matvec", "rmatvec", "sq_rmatvec")
)
SPARSE_LAUNCHES = {name: 0 for name in PRODUCTS}

_VALUE_DTYPES = (torch.float32, torch.bfloat16)


# a segment of more entries is cut into chunks of this many, a warp each
# (see csrc/sparse_glm.cu)
CHUNK = 4096


class Segments(NamedTuple):
    """One product's segments: ``ptr`` (int64 ``[n_seg + 1]``, or None for
    uniform segments of ``seg_len`` entries), ``gather`` (int32 ``[nnz]``,
    the source index of each entry) and ``val`` (``[nnz]``); and the plan
    of the segments longer than ``CHUNK`` entries (``make_segments`` builds
    it; None where there are none): ``long_ids`` (int64, their segment
    ids), ``chunk_first`` (int64 ``[n_long + 1]``, each one's first chunk)
    and ``chunk_owner`` (int32, each chunk's long segment)."""

    ptr: Optional[Tensor]
    seg_len: int
    gather: Tensor
    val: Tensor
    long_ids: Optional[Tensor] = None
    chunk_first: Optional[Tensor] = None
    chunk_owner: Optional[Tensor] = None

    def segment_ids(self, n_seg: int) -> Tensor:
        """The segment of every entry (int64 ``[nnz]``)."""
        seg = torch.arange(n_seg, device=self.gather.device)
        if self.ptr is None:
            return seg.repeat_interleave(self.seg_len)
        return seg.repeat_interleave(self.ptr.diff())


def make_segments(counts: np.ndarray, gather: Tensor, val: Tensor, uniform: bool = False) -> Segments:
    """The segments of ``counts[s]`` consecutive entries each, built on the
    host: int64 pointers (none for ``uniform`` segments, all of
    ``counts[0]`` entries, unless they are longer than ``CHUNK``) and the
    long segments' chunk plan, on ``gather``'s device."""
    dev = gather.device
    counts = np.asarray(counts, dtype=np.int64)
    long_ids = np.flatnonzero(counts > CHUNK)
    seg_len = int(counts[0]) if uniform and counts.size else 0
    ptr = None
    if not uniform or long_ids.size:
        ptr = np.zeros(counts.size + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        ptr = torch.from_numpy(ptr).to(dev)
    if not long_ids.size:
        return Segments(ptr, seg_len, gather, val)
    n_chunks = -(-counts[long_ids] // CHUNK)
    chunk_first = np.zeros(long_ids.size + 1, dtype=np.int64)
    np.cumsum(n_chunks, out=chunk_first[1:])
    owner = np.repeat(np.arange(long_ids.size, dtype=np.int32), n_chunks)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return Segments(ptr, 0, gather, val, to(long_ids), to(chunk_first), to(owner))


def reset_launch_counts() -> None:
    for k in SPARSE_LAUNCHES:
        SPARSE_LAUNCHES[k] = 0


def segment_dot_plain(seg: Segments, n_seg: int, src: Tensor, square: bool = False) -> Tensor:
    """Plain version of ``segment_dot``: the terms gathered and multiplied in
    float64, added by ``index_add_`` into a float64 ``[n_seg]``, cast to the
    product's dtype (the wider of ``src``'s and the values')."""
    v = seg.val.to(torch.float64)
    if square:
        v = v * v
    terms = src.to(torch.float64)[seg.gather.long()] * v
    out = torch.zeros(n_seg, dtype=torch.float64, device=src.device)
    out.index_add_(0, seg.segment_ids(n_seg), terms)
    return out.to(torch.promote_types(src.dtype, seg.val.dtype))


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("sparse_glm")
    if lib.segment_dot_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.segment_dot_launch.argtypes = [i, i, p, ll, ll, p, p, p, p, ll, ll, ll, p, p, p, p, p]
        lib.segment_dot_launch.restype = i
    return lib


def _check(seg: Segments, n_seg: int, src: Tensor) -> None:
    dev = src.device
    if src.dtype != torch.float32 or src.dim() != 1 or not src.is_contiguous():
        raise TypeError(f"the segment kernel takes a contiguous 1-D float32 src, got {src.dtype} {tuple(src.shape)}")
    if seg.val.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the segment kernel takes float32 or bfloat16 values, got {seg.val.dtype}")
    if seg.gather.dtype != torch.int32:
        raise TypeError(f"the segment kernel takes an int32 gather index, got {seg.gather.dtype}")
    if seg.gather.shape != seg.val.shape or seg.gather.dim() != 1:
        raise ValueError(f"gather {tuple(seg.gather.shape)} and values {tuple(seg.val.shape)} must be 1-D alike")
    tensors = [seg.gather, seg.val]
    if seg.long_ids is not None:
        if seg.ptr is None or seg.chunk_first.dtype != torch.int64 or seg.chunk_owner.dtype != torch.int32:
            raise ValueError("a long-segment plan needs ptr, int64 chunk_first and int32 chunk_owner")
        tensors += [seg.long_ids, seg.chunk_first, seg.chunk_owner]
    if seg.ptr is not None:
        if seg.ptr.dtype != torch.int64 or seg.ptr.shape != (n_seg + 1,):
            raise ValueError(f"ptr must be int64 ({n_seg + 1},), got {seg.ptr.dtype} {tuple(seg.ptr.shape)}")
        tensors.append(seg.ptr)
    elif n_seg * seg.seg_len != seg.gather.shape[0]:
        raise ValueError(f"{n_seg} segments of {seg.seg_len} entries do not cover {seg.gather.shape[0]} entries")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"the segments are on {t.device}, src on {dev}")
        if not t.is_contiguous():
            raise ValueError("the segments' tensors must be contiguous")


def segment_dot(name: str, seg: Segments, n_seg: int, src: Tensor, square: bool = False) -> Tensor:
    """``out[s] = sum_j src[gather[j]] * val[j]`` (``val**2`` with ``square``)
    over the ``n_seg`` segments of ``seg``: on the card one launch of the
    kernel (and of its finalize where ``seg`` has long segments), float32
    out, counted in ``SPARSE_LAUNCHES[name]``; a CPU tensor takes
    ``segment_dot_plain``. Segments without a plan are summed a warp each,
    whatever their length."""
    if src.device.type == "cpu":
        return segment_dot_plain(seg, n_seg, src, square)
    if src.device.type != "cuda":
        raise ValueError(f"the segment kernel runs on CUDA tensors (plain version on CPU only), got {src.device}")
    if name not in SPARSE_LAUNCHES:
        raise KeyError(f"unknown sparse product {name!r}; one of {PRODUCTS}")
    _check(seg, n_seg, src)
    out = torch.empty(n_seg, dtype=torch.float32, device=src.device)
    if n_seg == 0:
        return out
    lib = _library()
    plan = seg.long_ids is not None
    n_long = seg.long_ids.shape[0] if plan else 0
    n_chunks = seg.chunk_owner.shape[0] if plan else 0
    partial = torch.empty(n_chunks, dtype=torch.float64, device=src.device) if plan else None
    addr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(src.device):
        rc = lib.segment_dot_launch(
            int(seg.val.dtype == torch.bfloat16), int(square), addr(seg.ptr), seg.seg_len, n_seg,
            seg.gather.data_ptr(), seg.val.data_ptr(), src.data_ptr(), out.data_ptr(),
            CHUNK if plan else 0, n_chunks, n_long, addr(seg.chunk_owner), addr(seg.chunk_first),
            addr(seg.long_ids), addr(partial), torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"segment_dot_launch failed for {name} over {n_seg} segments: CUDA error {rc}")
    SPARSE_LAUNCHES[name] += 1
    return out

