"""The segmented gather-dot of the sparse layouts: the CUDA kernel, its
wrapper and its plain PyTorch version.

Every product of an ELL or sorted-COO ``FeatureMatrix`` (``ops/features.py``:
``matvec``, ``rmatvec`` and ``sq_rmatvec``) is one call of

    out[s] = sum_{j in segment s} src[gather[j]] * val[j]     (or val[j]**2)

over a ``Segments`` that the matrix builds once on the host: the gather
index of every entry (int32), its value, and the segments in one of two
forms (``csrc/sparse_glm.cu`` has a kernel for each):

- **row groups** (``row_segments``, for ``matvec``): segment pointers
  (int32 ``[n_seg + 1]``, int64 past 2**31 entries) or a uniform segment
  length (the ELL rows), and the ``group`` of lanes that sums a segment,
  picked from the mean segment length (``group_width``);
- **keys** (``key_segments``, for ``rmatvec`` and ``sq_rmatvec``, and for a
  ``matvec`` with a row longer than ``LONG_SEGMENT`` entries): the
  entries in segment order carry their segment as an int32 key, and
  ``joins`` lists the keys whose entries cross a tile of ``TILE`` entries
  (``key_joins``), whose carries a second launch adds.

It replaces the XLA gathers and scatter-adds of the JAX package's
``ops/features.py`` (``:103-172``; they are not Pallas kernels). The kernel
sums each output in double in an order that the layout alone fixes and
writes each output once, with no atomics: two launches give the same bits.
``index_add_``, the PyTorch call that computes the same function, adds with
atomics on the card.

``segment_dot`` launches the kernel for CUDA tensors (float32 ``src``,
float32 or bfloat16 values) and raises on anything it does not take; a CPU
tensor takes ``segment_dot_plain`` (gather, multiply, ``index_add_`` in
float64). ``SPARSE_LAUNCHES`` counts the kernel's launches by product;
``fused_glm.reset_launch_counts`` clears it with the other counters.

S2, the lane-wide products of the lambda-lane sweeps (``matmat`` and
``rmatmat``), is ``segment_dot_lanes``: the same segments over a row-major
``src [n_src, L]``,

    out[s, l] = sum_{j in segment s} src[gather[j], l] * val[j],

``[n_seg, L]`` float32 out, from the same kernels and the same launch
(``csrc/sparse_glm.cu``): each pass over the entries takes a panel of up to
``PANEL`` columns, walked in sub-chunks of ``SUB`` columns, every column by
S1's operations in S1's order, so that column l is, bit for bit, the product
``segment_dot`` gives for column l alone: ``segment_dot`` is the launch at
L = 1. ``lane_plan`` mirrors the kernel's panels and sub-chunks. Both share
the plain version ``segment_dot_plain``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_lib

Tensor = torch.Tensor

PRODUCTS = tuple(
    f"{layout}_{product}"
    for layout in ("ell", "coo")
    for product in ("matvec", "rmatvec", "sq_rmatvec", "matmat", "rmatmat")
)
LANE_PRODUCTS = tuple(name for name in PRODUCTS if name.endswith("matmat"))
SINGLE_PRODUCTS = tuple(name for name in PRODUCTS if name not in LANE_PRODUCTS)
SPARSE_LAUNCHES = {name: 0 for name in PRODUCTS}

_VALUE_DTYPES = (torch.float32, torch.bfloat16)

GROUPS = (4, 8, 16, 32)  # lanes a row group may have
LANE_ENTRIES = 4  # entries a row-group lane takes a pass (csrc/sparse_glm.cu kLaneEntries)
TILE = 256  # entries a warp tile of the key walk (kTile)
PANEL = 16  # S2: columns a pass over the entries (kPanel)
SUB = 4  # S2: columns a sub-chunk of a panel (kSub)
# a row segment of more entries sends its product to the key walk, where a
# long segment is many lanes' runs instead of one group's passes
LONG_SEGMENT = 512
_INT32_MAX = 2**31 - 1


class Segments(NamedTuple):
    """One product's segments over ``gather`` (int32 ``[nnz]``, the source
    index of each entry) and ``val`` (``[nnz]``). Row groups: ``ptr``
    (int32 or int64 ``[n_seg + 1]``, or None for uniform segments of
    ``seg_len`` entries) and ``group``, the lanes that sum a segment. Keys:
    ``keys`` (int32 ``[nnz]``, ascending, the segment of each entry, each
    below ``n_keys``) and ``joins`` (int32 ``[n_joins, 3]``: key, first
    tile, last tile of each key that crosses a ``TILE`` boundary)."""

    ptr: Optional[Tensor]
    seg_len: int
    gather: Tensor
    val: Tensor
    group: int = 0
    keys: Optional[Tensor] = None
    joins: Optional[Tensor] = None
    n_keys: int = 0

    def segment_ids(self, n_seg: int) -> Tensor:
        """The segment of every entry (int64 ``[nnz]``)."""
        if self.keys is not None:
            return self.keys.long()
        seg = torch.arange(n_seg, device=self.gather.device)
        if self.ptr is None:
            return seg.repeat_interleave(self.seg_len)
        return seg.repeat_interleave(self.ptr.diff().long())


def group_width(mean_len: float) -> int:
    """The lanes of a row group: the fewest (at least 4) whose passes of
    ``LANE_ENTRIES`` entries cover a segment of the mean length at once."""
    for g in GROUPS:
        if g * LANE_ENTRIES >= mean_len:
            return g
    return GROUPS[-1]


def key_joins(keys: np.ndarray, tile: int = TILE) -> np.ndarray:
    """int32 ``[n_joins, 3]``: each key whose entries cross a boundary of
    ``tile`` entries, with the tiles of its first and last entries, in key
    order (``keys`` ascending)."""
    keys = np.asarray(keys)
    b = np.arange(tile, keys.size, tile)
    cross = b[keys[b - 1] == keys[b]]
    if not cross.size:
        return np.zeros((0, 3), dtype=np.int32)
    k = keys[cross]
    new = np.concatenate([[True], k[1:] != k[:-1]])
    ends = np.concatenate([new[1:], [True]])
    return np.stack([k[new], cross[new] // tile - 1, cross[ends] // tile], axis=1).astype(np.int32)


def key_segments(keys: np.ndarray, n_seg: int, gather: Tensor, val: Tensor,
                 key_tensor: Optional[Tensor] = None) -> Segments:
    """The key form over entries whose segments ``keys`` (ascending, each
    below ``n_seg``) names: the keys on ``gather``'s device (``key_tensor``
    where the layout already holds them there, as COO's ``coo_cols``) and
    their joins."""
    dev = gather.device
    keys = np.asarray(keys)
    if keys.size and (keys[0] < 0 or keys[-1] >= n_seg or np.any(keys[1:] < keys[:-1])):
        raise ValueError(f"keys must ascend within [0, {n_seg})")
    if key_tensor is None:
        key_tensor = torch.from_numpy(keys.astype(np.int32)).to(dev)
    return Segments(None, 0, gather, val, keys=key_tensor, joins=torch.from_numpy(key_joins(keys)).to(dev),
                    n_keys=n_seg)


def row_segments(counts: np.ndarray, gather: Tensor, val: Tensor, uniform: bool = False) -> Segments:
    """The segments of ``counts[s]`` consecutive entries each, built on the
    host: row groups with int32 pointers (int64 past 2**31 entries; none for
    ``uniform`` segments, all of ``counts[0]`` entries) and the group width
    from the mean length; the key form where a segment is longer than
    ``LONG_SEGMENT``."""
    dev = gather.device
    counts = np.asarray(counts, dtype=np.int64)
    n_seg, nnz = counts.size, int(counts.sum())
    if n_seg and counts.max() > LONG_SEGMENT:
        return key_segments(np.repeat(np.arange(n_seg, dtype=np.int32), counts), n_seg, gather, val)
    group = group_width(nnz / n_seg if n_seg else 0.0)
    if uniform:
        return Segments(None, int(counts[0]) if n_seg else 0, gather, val, group)
    ptr = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    if nnz <= _INT32_MAX:
        ptr = ptr.astype(np.int32)
    return Segments(torch.from_numpy(ptr).to(dev), 0, gather, val, group)


class Panel(NamedTuple):
    """One pass of S2 over the entries: columns ``[first, first + width)``
    in a kernel of ``capacity`` columns, walked in ``subs``, the
    ``(first column, width)`` of each sub-chunk."""

    first: int
    width: int
    capacity: int
    subs: tuple


def panel_capacity(width: int) -> int:
    """The kernel a panel of ``width`` (1 to ``PANEL``) columns takes: one
    column (S1), else the multiple of ``SUB`` that holds it."""
    if not 1 <= width <= PANEL:
        raise ValueError(f"a panel has 1 to {PANEL} columns, got {width}")
    return 1 if width == 1 else -(-width // SUB) * SUB


def lane_plan(L: int) -> tuple:
    """The panels S2 runs for ``L`` columns, as ``csrc/sparse_glm.cu``
    ``run_panels`` does: ``L // PANEL`` full panels (one launch, the grid's
    y axis), then one of the ``L % PANEL`` columns left; each panel's
    columns in sub-chunks of ``SUB``, the last of ``width % SUB``."""
    if not 1 <= L <= _MAX_LANES:
        raise ValueError(f"the lane-wide segment kernel takes 1 to {_MAX_LANES} lanes, got {L}")
    widths = [PANEL] * (L // PANEL) + ([L % PANEL] if L % PANEL else [])
    panels, first = [], 0
    for width in widths:
        subs = tuple((first + c, min(SUB, width - c)) for c in range(0, width, SUB))
        panels.append(Panel(first, width, panel_capacity(width), subs))
        first += width
    return tuple(panels)


def reset_launch_counts() -> None:
    for k in SPARSE_LAUNCHES:
        SPARSE_LAUNCHES[k] = 0


def segment_dot_plain(seg: Segments, n_seg: int, src: Tensor, square: bool = False) -> Tensor:
    """Plain version of ``segment_dot`` (``src [n_src]``) and of
    ``segment_dot_lanes`` (``src [n_src, L]``): the terms gathered and
    multiplied in float64, added by ``index_add_`` into a float64
    ``[n_seg]`` or ``[n_seg, L]``, cast to the product's dtype (the wider of
    ``src``'s and the values'). Column l takes the operations that column l
    alone takes."""
    v = seg.val.to(torch.float64)
    if square:
        v = v * v
    terms = src.to(torch.float64)[seg.gather.long()]
    terms = terms * (v if src.dim() == 1 else v[:, None])
    out = torch.zeros((n_seg, *src.shape[1:]), dtype=torch.float64, device=src.device)
    out.index_add_(0, seg.segment_ids(n_seg), terms)
    return out.to(torch.promote_types(src.dtype, seg.val.dtype))


def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("sparse_glm")
    if lib.segment_rows_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.segment_rows_launch.argtypes = [i, i, i, p, p, ll, ll, p, p, p, p, i, p]
        lib.segment_rows_launch.restype = i
        lib.segment_keys_launch.argtypes = [i, i, p, p, p, ll, ll, p, ll, p, p, p, p, i, p]
        lib.segment_keys_launch.restype = i
        for fn in ("segment_tile_entries", "segment_panel_columns", "segment_sub_columns"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.segment_panel_capacity.argtypes = [i]
        lib.segment_panel_capacity.restype = i
        if lib.segment_tile_entries() != TILE:
            raise RuntimeError(f"csrc/sparse_glm.cu tiles {lib.segment_tile_entries()} entries, ops/sparse.py {TILE}")
        kernel = (lib.segment_panel_columns(), lib.segment_sub_columns(),
                  [lib.segment_panel_capacity(w) for w in range(1, PANEL + 1)])
        mirror = (PANEL, SUB, [panel_capacity(w) for w in range(1, PANEL + 1)])
        if kernel != mirror:
            raise RuntimeError(f"csrc/sparse_glm.cu plans its panels as {kernel} (panel, sub-chunk, capacities), "
                               f"ops/sparse.py as {mirror}")
    return lib


_MAX_LANES = 65535 * PANEL  # the kernel's grid puts the full panels on its y axis


def _check(seg: Segments, n_seg: int, src: Tensor, lanes: bool) -> None:
    dev = src.device
    ndim = 2 if lanes else 1
    if src.dtype != torch.float32 or src.dim() != ndim or not src.is_contiguous():
        raise TypeError(
            f"the segment kernel takes a contiguous {ndim}-D float32 src, got {src.dtype} {tuple(src.shape)}"
        )
    if lanes and not 1 <= src.shape[1] <= _MAX_LANES:
        raise ValueError(f"the lane-wide segment kernel takes 1 to {_MAX_LANES} lanes, got {src.shape[1]}")
    if seg.val.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the segment kernel takes float32 or bfloat16 values, got {seg.val.dtype}")
    if seg.gather.dtype != torch.int32:
        raise TypeError(f"the segment kernel takes an int32 gather index, got {seg.gather.dtype}")
    if seg.gather.shape != seg.val.shape or seg.gather.dim() != 1:
        raise ValueError(f"gather {tuple(seg.gather.shape)} and values {tuple(seg.val.shape)} must be 1-D alike")
    nnz = seg.gather.shape[0]
    tensors = [seg.gather, seg.val]
    if seg.keys is not None:
        if seg.keys.dtype != torch.int32 or seg.keys.shape != (nnz,) or n_seg != seg.n_keys or n_seg > _INT32_MAX:
            raise ValueError(f"keys must be int32 ({nnz},) over the {seg.n_keys} segments they were built for "
                             f"(fewer than 2**31), got {seg.keys.dtype} {tuple(seg.keys.shape)} over {n_seg}")
        if seg.joins is None or seg.joins.dtype != torch.int32 or seg.joins.dim() != 2 or seg.joins.shape[1] != 3:
            raise ValueError("keys need their joins, int32 [n_joins, 3] (sparse.key_joins)")
        tensors += [seg.keys, seg.joins]
    else:
        if seg.group not in GROUPS:
            raise ValueError(f"row groups take {GROUPS} lanes, got {seg.group}")
        if seg.ptr is not None:
            if seg.ptr.dtype not in (torch.int32, torch.int64) or seg.ptr.shape != (n_seg + 1,):
                raise ValueError(f"ptr must be int32 or int64 ({n_seg + 1},), got {seg.ptr.dtype} "
                                 f"{tuple(seg.ptr.shape)}")
            tensors.append(seg.ptr)
        elif n_seg * seg.seg_len != nnz:
            raise ValueError(f"{n_seg} segments of {seg.seg_len} entries do not cover {nnz} entries")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"the segments are on {t.device}, src on {dev}")
        if not t.is_contiguous():
            raise ValueError("the segments' tensors must be contiguous")


def segment_dot(name: str, seg: Segments, n_seg: int, src: Tensor, square: bool = False) -> Tensor:
    """``out[s] = sum_j src[gather[j]] * val[j]`` (``val**2`` with ``square``)
    over the ``n_seg`` segments of ``seg``: on the card one launch of the
    kernel of ``seg``'s form (and of the joins' kernel where keys cross a
    tile), float32 out, counted in ``SPARSE_LAUNCHES[name]``; a CPU tensor
    takes ``segment_dot_plain``."""
    return _segment_dot(name, SINGLE_PRODUCTS, seg, n_seg, src, square)


def segment_dot_lanes(name: str, seg: Segments, n_seg: int, src: Tensor) -> Tensor:
    """S2: ``out[s, l] = sum_j src[gather[j], l] * val[j]`` over the
    ``n_seg`` segments of ``seg`` for a row-major ``src [n_src, L]``: the
    launch of ``segment_dot`` at L columns, float32 ``[n_seg, L]`` out,
    counted in ``SPARSE_LAUNCHES[name]``; a CPU tensor takes
    ``segment_dot_plain``. Column l equals ``segment_dot`` on column l bit
    for bit."""
    return _segment_dot(name, LANE_PRODUCTS, seg, n_seg, src, False)


def _segment_dot(name: str, names: tuple, seg: Segments, n_seg: int, src: Tensor, square: bool) -> Tensor:
    if src.device.type == "cpu":
        return segment_dot_plain(seg, n_seg, src, square)
    if src.device.type != "cuda":
        raise ValueError(f"the segment kernel runs on CUDA tensors (plain version on CPU only), got {src.device}")
    if name not in names:
        raise KeyError(f"unknown sparse product {name!r}; one of {names}")
    lanes = names is LANE_PRODUCTS
    _check(seg, n_seg, src, lanes)
    L = src.shape[1] if lanes else 1
    out = torch.empty((n_seg, L), dtype=torch.float32, device=src.device)
    if n_seg:
        lib = _library()
        bf16 = int(seg.val.dtype == torch.bfloat16)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            if seg.keys is not None:
                nnz, n_joins = seg.gather.shape[0], seg.joins.shape[0]
                carries = torch.empty((2, -(-nnz // TILE) * L if n_joins else 0), dtype=torch.float64,
                                      device=src.device)
                rc = lib.segment_keys_launch(
                    bf16, int(square), seg.keys.data_ptr(), seg.gather.data_ptr(), seg.val.data_ptr(), nnz, n_seg,
                    seg.joins.data_ptr() if n_joins else None, n_joins, src.data_ptr(), out.data_ptr(),
                    carries[0].data_ptr() if n_joins else None, carries[1].data_ptr() if n_joins else None, L,
                    stream,
                )
            else:
                ptr = seg.ptr
                rc = lib.segment_rows_launch(
                    bf16, int(square), seg.group,
                    ptr.data_ptr() if ptr is not None and ptr.dtype == torch.int32 else None,
                    ptr.data_ptr() if ptr is not None and ptr.dtype == torch.int64 else None,
                    seg.seg_len, n_seg, seg.gather.data_ptr(), seg.val.data_ptr(), src.data_ptr(), out.data_ptr(), L,
                    stream,
                )
        if rc != 0:
            raise RuntimeError(f"the segment kernel failed for {name} over {n_seg} segments: CUDA error {rc}")
        SPARSE_LAUNCHES[name] += 1
    return out if lanes else out.view(n_seg)
