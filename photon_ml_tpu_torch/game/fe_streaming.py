"""Out-of-core fixed-effect training: row slices streamed through the card.

The JAX package's ``game/fe_streaming.py`` on the port. The fixed effect's
rows stay in host memory (``game.data.HostRowBatch``: dense or ELL planes,
page-locked for a card) and only budget-sized row slices of the feature
planes are on the card at a time; the slice size comes from the
``hbm.budget.mb`` contract, halved for double buffering. A training ELL
slice carries its column segments beside its planes (the key form its
``rmatvec`` runs on), built on the host once per batch and slice size and
kept with the batch (``HostRowBatch.cache``), and is sized with them
(``staged_row_nbytes``); scoring copies the planes alone, as ``matvec``
needs no column segments.

Each evaluation is one pass over the slices. Slice k's partial sums
(``ops/glm.py``'s ``slice_*_into``) go into row k of the pass's
``[n_slices, width]`` float64 slot buffer: a dense slice's B1 / B2 kernel
writes its totals there (the finalize-into-slot mode of B4), an ELL slice's
products run through S1 and are copied there. At the end of the pass the
``rank_order_sum`` kernel adds the rows in slice order: a fixed left-to-right
reduction with no float atomics, so passes are bitwise stable run to run.
The per-evaluation algebra (normalization shifts and factors, prior, L2)
applies once to the totals (``finalize_*``).

On the card the copies run on a copy stream of their own:

- slice k+1's copy (``copy_(non_blocking=True)`` from page-locked memory) is
  issued before slice k's kernel, so the copy overlaps the compute;
- the compute stream waits on the copy's event before the kernel reads the
  slice;
- the copy into a buffer waits on an event recorded after the kernel that
  read that buffer two slices back, so the double buffer is never
  overwritten while a kernel still reads it;
- the two dense slice buffers are allocated once and reused (their blocks
  never pass from one stream to another; ``record_stream`` on the copy
  stream keeps their release behind any copy still queued). An ELL slice's
  planes and column segments are allocated on the copy stream and handed to
  the compute stream with ``record_stream``.

The ``[n]`` scalar planes (labels, offsets, weights, and the residual scores
the coordinate adds) stay on the device, as in the JAX package: the budget
governs the ``n * d`` feature mass.

Every slice is ``step`` rows but the last, which copies only the rows the
batch has (the kernels' launch plans are cached per row count, so a pass
uses at most two). The optimizer is the port's host loop
(``optimize.optimize``), its O(d) vectors on the device; each value+grad or
Hessian-vector product is one pass.

Across processes (``group``, a ``parallel.mesh.DataParallelGroup`` of more
than one rank) each rank streams its own rows, and a pass's slot rows are
every rank's: the rank writes its ``[n_slots, width]`` block of a
``[world * n_slots, width]`` float64 buffer, one ``gather_slots`` fills the
other ranks' blocks, and one ``rank_order_sum`` adds all the rows in (rank,
slice) order and casts once, so every rank holds the same bits and a pass
launches one sum, as in one process. ``n_slots`` is the largest slice count
of any rank (the ranks' row counts and ELL widths differ); a rank's rows
past its own slices stay zero, which adds nothing. (The JAX package sums
the per-host totals on the host in process order.) With one rank the pass
is the one-process pass.

At pipeline depth >= 2 (``game/pipeline.py``) staging moves to a background
thread (``utils.futures.PrefetchQueue``) under the same byte budget, with
the same copy stream and events, cycling over the slices so that the next
pass's first slice is staged while the optimizer works on the last pass's
result. Slice geometry and the order of the sums do not change, so the
results are bitwise depth 1's. The stream counters count a slice when a pass
consumes it, so the stager's look-ahead copy past a solve's last pass leaves
them at slices x passes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np

import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..ops.features import FeatureMatrix, LabeledBatch
from ..ops.fused_glm import HV, VG, slice_slots, slices_total
from ..ops.glm import (
    finalize_hessian_vector,
    finalize_value_grad,
    slice_hessian_vector_into,
    slice_value_grad_into,
)
from ..ops.losses import PointwiseLoss
from ..ops.normalization import NormalizationContext, identity_normalization
from ..ops.sparse import Segments, row_segments
from ..utils.futures import PrefetchQueue
from . import pipeline

Tensor = torch.Tensor

# ELL index planes are int32 (the builders make them so)
_ELL_INDEX_ITEMSIZE = 4
# slice row counts are rounded to this multiple (not a byte itemsize)
_ROW_MULTIPLE = 8
_KERNEL_X_DTYPES = (torch.float32, torch.bfloat16)
# the site label of the scoring stream's series (training: fe.train)
_SCORE_SITE = "fe.score"


def estimate_fe_batch_bytes(
    n_rows: int,
    dim: int,
    layout: str,
    ell_width: int = 0,
    feature_itemsize: int = 4,
    scalar_itemsize: int = 4,
) -> int:
    """Device bytes of a resident fixed-effect batch of this shape (features
    plus labels, offsets and weights): ``build_fixed_effect_dataset``
    streams when this exceeds its ``hbm_budget_bytes``."""
    if layout == "dense":
        feat = n_rows * dim * feature_itemsize
    elif layout == "ell":
        feat = n_rows * ell_width * (feature_itemsize + _ELL_INDEX_ITEMSIZE)
    else:
        raise ValueError(f"estimate_fe_batch_bytes: layout must be dense|ell, got {layout!r}")
    return int(feat + 3 * n_rows * scalar_itemsize)


def rows_per_slice(budget_bytes: int, feature_row_nbytes: int, multiple: int = _ROW_MULTIPLE) -> int:
    """Rows per streamed slice under ``budget_bytes``: two slices of feature
    planes resident at once (the double buffer), rounded down to a row
    multiple, at least one multiple."""
    r = max(budget_bytes // max(2 * feature_row_nbytes, 1), multiple)
    return int(r // multiple * multiple)


def _step(budget_bytes: int, row_nbytes: int, n: int) -> int:
    """The rows of a slice: ``rows_per_slice``, never wider than the batch
    itself (its row count rounded up to the row multiple)."""
    return min(rows_per_slice(budget_bytes, row_nbytes), -(-n // _ROW_MULTIPLE) * _ROW_MULTIPLE)


def stream_route(host_batch, device: torch.device) -> str:
    """The route a streamed batch's passes take (``game/problem.py``'s
    ``batch_route`` for the slices): ``dense_kernel`` / ``sparse_kernel``
    for float32 / bfloat16 features on a card, ``plain_float64`` for a
    float64 batch there, ``plain_cpu`` on the CPU."""
    feats = host_batch.dense if host_batch.dense is not None else host_batch.ell_val
    if device.type == "cpu":
        return "plain_cpu"
    if device.type != "cuda":
        raise ValueError(f"streamed batches run on a CUDA device or the CPU, got {device}")
    if torch.float64 in (feats.dtype, host_batch.labels.dtype):
        return "plain_float64"
    if feats.dtype not in _KERNEL_X_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 features, got {feats.dtype}")
    return "dense_kernel" if host_batch.dense is not None else "sparse_kernel"


def staged_row_nbytes(host_batch) -> int:
    """The device bytes one row of a slice takes: a dense row's features,
    or an ELL row's planes plus its column segments (the entries again,
    sorted by column with their rows: the key form of ``ops/sparse.py``),
    and a byte an entry bounding the key joins (12 bytes per ``TILE`` of
    256 entries). Slices are sized by this, so that two of them stay within
    the budget on the card."""
    if host_batch.dense is not None:
        return host_batch.feature_row_nbytes()
    width = host_batch.ell_idx.shape[1]
    return 2 * host_batch.feature_row_nbytes() + width * (_ELL_INDEX_ITEMSIZE + 1)


_KEY_TENSORS = ("gather", "val", "keys", "joins")


def _ell_key_segments(hb, step: int) -> List[Segments]:
    """Each ELL slice's column segments (the key form ``rmatvec`` runs on)
    for slices of ``step`` rows: built on the host once per batch and step
    and kept with the batch, page-locked when its planes are."""
    cache = hb.cache()
    segs = cache.get(("ell_key_segments", step))
    if segs is None:
        segs = []
        for s0 in range(0, hb.n_rows, step):
            m = FeatureMatrix(dim=hb.dim, idx=hb.ell_idx[s0 : s0 + step], val=hb.ell_val[s0 : s0 + step])
            col = m.col_segments
            if hb.is_pinned():
                col = col._replace(**{k: getattr(col, k).pin_memory() for k in _KEY_TENSORS})
            segs.append(col)
        cache[("ell_key_segments", step)] = segs
    return segs


def _ell_matrix(dim: int, idx: Tensor, val: Tensor, col: Optional[Segments]) -> FeatureMatrix:
    """An ELL slice's matrix over planes on their device: its row segments
    (uniform rows, views of the planes: no host work) and the column
    segments it was staged with (None when scoring)."""
    rows = row_segments(np.full(idx.shape[0], idx.shape[1]), idx.reshape(-1), val.reshape(-1), uniform=True)
    return FeatureMatrix.from_segments(dim, idx, val, rows, col)


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


@dataclasses.dataclass
class _Staged:
    """A slice on the device: its matrix, the event its copy recorded (None
    on the CPU), the dense buffer it occupies (-1 for none), its bytes, and
    its staging span's (start, seconds) on the host clock."""

    features: FeatureMatrix
    copied: Optional[torch.cuda.Event]
    buffer: int
    nbytes: int
    stage_span: tuple = (0.0, 0.0)


class _SliceStager:
    """The copies of a streamed batch's row slices to ``device``, in the
    discipline of the module docstring: the planes, and for training
    (``keys``) an ELL slice's column segments. On the CPU a slice is the
    host slice itself."""

    def __init__(self, hb, step: int, n_slices: int, device: torch.device, keys: bool):
        self.hb = hb
        self.step = step
        self.n_slices = n_slices
        self.device = device
        self.cuda = device.type == "cuda"
        self._claims = 0
        self._keys: Optional[List[Segments]] = None
        if hb.dense is None and keys:
            self._keys = _ell_key_segments(hb, step)
        if not self.cuda:
            return
        # the stream the consumer's kernels run on, captured on its thread
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        self.consumed = [torch.cuda.Event(), torch.cuda.Event()]
        self.buffers: List[Tensor] = []
        if hb.dense is not None:
            for _ in range(2):
                buf = torch.empty((step, hb.dim), dtype=hb.dense.dtype, device=device)
                buf.record_stream(self.copy_stream)
                self.buffers.append(buf)

    def _host_planes(self, k: int):
        s0 = k * self.step
        if self.hb.dense is not None:
            return (self.hb.dense[s0 : s0 + self.step],)
        return (self.hb.ell_idx[s0 : s0 + self.step], self.hb.ell_val[s0 : s0 + self.step])

    def _key_tensors(self, k: int) -> List[Tensor]:
        return [] if self._keys is None else [getattr(self._keys[k], n) for n in _KEY_TENSORS]

    def slice_nbytes(self, k: int) -> int:
        return _nbytes(list(self._host_planes(k)) + self._key_tensors(k))

    def stage(self, k: int) -> _Staged:
        """Issue slice k's copy on the copy stream; the consumer's kernel
        waits for it on the device (``before_use``), never the host."""
        nbytes = self.slice_nbytes(k)
        planes = self._host_planes(k)
        col = None if self._keys is None else self._keys[k]
        if not self.cuda:
            if self.hb.dense is not None:
                return _Staged(FeatureMatrix(dim=self.hb.dim, dense=planes[0]), None, -1, nbytes)
            return _Staged(_ell_matrix(self.hb.dim, *planes, col), None, -1, nbytes)
        claim = self._claims
        self._claims += 1
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy_stream):
            b = claim % 2
            # the kernel that read this buffer two slices back must be done
            self.copy_stream.wait_event(self.consumed[b])
            if self.hb.dense is not None:
                buf = self.buffers[b][: planes[0].shape[0]]
                buf.copy_(planes[0], non_blocking=True)
                feats = FeatureMatrix(dim=self.hb.dim, dense=buf)
            else:
                put = lambda t: t.to(self.device, non_blocking=True)  # noqa: E731
                idx, val = put(planes[0]), put(planes[1])
                if col is not None:
                    col = col._replace(**{n: put(getattr(col, n)) for n in _KEY_TENSORS})
                feats = _ell_matrix(self.hb.dim, idx, val, col)
                for t in [idx, val] + ([] if col is None else [getattr(col, n) for n in _KEY_TENSORS]):
                    t.record_stream(self.compute)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        return _Staged(feats, copied, b, nbytes)

    def before_use(self, staged: _Staged) -> None:
        if staged.copied is not None:
            self.compute.wait_event(staged.copied)

    def after_use(self, staged: _Staged) -> None:
        if staged.copied is not None:
            self.consumed[staged.buffer].record(self.compute)


class StreamedFEObjective:
    """Row-sliced, double-buffered fixed-effect GLM objective:
    ``value_and_grad(w)`` / ``hessian_vector(w, v)`` take coefficients on
    the device (or host arrays) and return device tensors, each call one
    full streamed pass over the batch. ``plain=True`` runs the plain
    versions of the kernels on the card, a reference pass. Over a ``group``
    ``host_batch`` holds this rank's rows and ``residual_scores`` their
    residual, and each pass sums every rank's (module docstring)."""

    def __init__(
        self,
        loss: PointwiseLoss,
        host_batch,  # game.data.HostRowBatch
        budget_bytes: int,
        norm: Optional[NormalizationContext] = None,
        l2_weight: float = 0.0,
        prior_mean: Optional[Tensor] = None,
        prior_precision: Optional[Tensor] = None,
        residual_scores: Optional[Tensor] = None,  # device f[n] or None
        pipeline_depth: Optional[int] = None,  # None -> pipeline.active_depth()
        device: DeviceLike = None,
        plain: bool = False,
        group=None,  # parallel.mesh.DataParallelGroup: this rank's rows of a pass over every rank's
    ):
        dev = resolve_device(device)
        self.device = dev
        self.loss = loss
        self.route = stream_route(host_batch, dev)
        self.plain = plain or self.route == "plain_float64"
        hb = host_batch.pinned() if dev.type == "cuda" else host_batch
        self.hb = hb
        self.budget_bytes = int(budget_bytes)
        self.dim = int(hb.dim)
        n = hb.n_rows
        self.n_rows = n
        self.sdt = hb.labels.dtype
        self.norm = (identity_normalization() if norm is None else norm).to(dev)
        self._l2 = float(l2_weight)
        self._pm = None if prior_mean is None else prior_mean.to(device=dev, dtype=self.sdt)
        self._pp = None if prior_precision is None else prior_precision.to(device=dev, dtype=self.sdt)

        row_bytes = staged_row_nbytes(hb)
        step = _step(self.budget_bytes, row_bytes, n)
        self.step = step
        self.n_slices = -(-n // step)
        self._stager = _SliceStager(hb, step, self.n_slices, dev, keys=True)

        # the device-resident scalar planes
        dl, do, dw = (t.to(device=dev, dtype=self.sdt) for t in (hb.labels, hb.offsets, hb.weights))
        if dev.type == "cuda":
            obs.add_device_put_bytes("fe_streaming.resident", 3 * n * dl.element_size())
        if residual_scores is not None:
            do = do + residual_scores.to(device=dev, dtype=self.sdt)
        self._scalar_slices = [
            (dl[k * step : (k + 1) * step], do[k * step : (k + 1) * step], dw[k * step : (k + 1) * step])
            for k in range(self.n_slices)
        ]
        self.group = group if group is not None and group.world_size > 1 else None
        if self.group is None:
            self._slots = {mode: slice_slots(self.n_slices, mode, self.dim, dev) for mode in (VG, HV)}
        else:
            # every rank's slot rows in one buffer, this rank's block of it
            # written by its slices: (rank, slice) order
            world, rank = self.group.world_size, self.group.rank
            (counts,) = self.group.gather_rows([torch.tensor([self.n_slices], dtype=torch.float64)])
            n_slots = int(counts.max())
            self._rank_slots = {mode: slice_slots(world * n_slots, mode, self.dim, dev) for mode in (VG, HV)}
            self._slots = {mode: buf[rank * n_slots : (rank + 1) * n_slots] for mode, buf in self._rank_slots.items()}
        self.stats = {
            "vg_passes": 0,
            "hvp_passes": 0,
            "slices": 0,
            "staged_bytes": 0,
            "max_slice_bytes": 0,
            "stage_seconds": 0.0,
        }
        # sweep pipelining: depth >= 2 stages on a background thread whose
        # queue the same byte budget bounds (queued + held slice bytes <=
        # budget, an empty queue admits one: the double buffer's worst
        # case), cycling over 0..n_slices-1 in the order every pass reads
        self.pipeline_depth = pipeline.active_depth() if pipeline_depth is None else int(pipeline_depth)
        self._anchor = pipeline.stage_anchor()
        self._slice_cost = step * row_bytes
        self._prefetch: Optional[PrefetchQueue] = None
        # (start, end) host wall intervals behind photon_stream_overlap_ratio
        self._intervals = {"stage": [], "collect": [], "pass": []}

    # -- staging --------------------------------------------------------------

    def _acquire(self, k: int) -> _Staged:
        """Slice k staged: inline at depth 1, popped from the background
        stager at depth >= 2 (started on first use)."""
        if self.pipeline_depth <= 1 or self.n_slices <= 1:
            return self._stage(k)
        if self._prefetch is None:
            # depth 1 of the queue: one slice queued or in flight beside
            # the one the kernels hold, the double buffer's two, whatever
            # the sweep's depth (the budget admits no third)
            self._prefetch = PrefetchQueue(
                lambda i: self._stage(i, parent=self._anchor, background=True),
                self.n_slices,
                depth=1,
                cyclic=True,
                cost=lambda i: self._slice_cost,
                budget=self.budget_bytes,
                name="photon-fe-stage",
            )
        idx, staged = self._prefetch.get()
        if idx != k:
            raise RuntimeError(f"fe_streaming prefetch out of order: staged slice {idx}, consumer wants {k}")
        return staged

    def _stage(self, k: int, parent: Optional[obs.Span] = None, background: bool = False) -> _Staged:
        """Issue slice k's copy to the device. On the stager thread
        ``parent`` anchors the span under the sweep (contextvar ancestry
        does not cross threads). The span is the host's staging work (the
        dispatch of the copy), as the JAX package's is: the copy itself
        runs on the copy stream, overlapped with the compute stream."""
        bind = torch.cuda.device(self.device) if background and self.device.type == "cuda" else contextlib.nullcontext()
        with bind, obs.span("fe_stream.stage", parent=parent, phase="stage", slice=k) as sp:
            staged = self._stager.stage(k)
        staged.stage_span = (sp.start_perf, sp.duration_s)
        return staged

    def _consume(self, staged: _Staged) -> None:
        """A slice a pass reads, into the stream counters: counted here and
        not where it was staged, so that a look-ahead copy no pass reads
        leaves no trace in them."""
        start, seconds = staged.stage_span
        self.stats["slices"] += 1
        self.stats["staged_bytes"] += staged.nbytes
        self.stats["max_slice_bytes"] = max(self.stats["max_slice_bytes"], staged.nbytes)
        self.stats["stage_seconds"] += seconds
        self._intervals["stage"].append((start, start + seconds))
        obs.current_run().registry.histogram(
            "photon_stream_slice_stage_seconds", "host wall per H2D slice-staging dispatch"
        ).observe(seconds)
        if self.device.type == "cuda":
            obs.add_device_put_bytes("fe_streaming.stage", staged.nbytes)

    # -- objective ------------------------------------------------------------

    def _pass(self, kind: str, mode: int, partials) -> tuple:
        """One pass: each slice's sweep writes its slot row, then the rows
        are added in slice order (over a group: every rank's rows, in
        (rank, slice) order). Inline, slice k+1's copy is issued before
        slice k's kernel; from the background stager slice k+1 is taken
        after slice k's kernel is queued, which releases the buffer of
        slice k-1 to the stager only once its reader is queued."""
        slots = self._slots[mode]
        background = self.pipeline_depth > 1 and self.n_slices > 1
        with obs.span("fe_stream.pass", kind=kind, n_slices=self.n_slices) as pp:
            staged = self._acquire(0)
            for k in range(self.n_slices):
                more = k + 1 < self.n_slices
                nxt = self._acquire(k + 1) if more and not background else None  # overlaps slice k
                labels, offsets, weights = self._scalar_slices[k]
                self._stager.before_use(staged)
                self._consume(staged)
                partials(LabeledBatch(staged.features, labels, offsets, weights), slots, k)
                self._stager.after_use(staged)
                staged = self._acquire(k + 1) if more and background else nxt
            if self.group is not None:
                full = self._rank_slots[mode]
                self.group.gather_slots(full.view(self.group.world_size, -1))
                slots = full
            totals = slices_total(slots, mode, self.dim, self.sdt)
        self._intervals["pass"].append((pp.start_perf, pp.start_perf + pp.duration_s))
        with obs.span("fe_stream.collect", phase="collect", kind=kind) as cp:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self._intervals["collect"].append((cp.start_perf, cp.start_perf + cp.duration_s))
        return totals

    def _coef(self, w) -> Tensor:
        return torch.as_tensor(w, dtype=self.sdt, device=self.device)

    def value_and_grad(self, w):
        """One streamed pass: (objective value, gradient) on the device."""
        coef = self._coef(w)
        eff, mshift = self.norm.effective_coefficients(coef)
        self.stats["vg_passes"] += 1

        def partials(batch, slots, k):
            slice_value_grad_into(slots, k, self.loss, batch, eff, mshift, plain=self.plain)

        value_sum, grad_sum, wdz_sum = self._pass("vg", VG, partials)
        return finalize_value_grad(coef, value_sum, grad_sum, wdz_sum, self.norm, self._l2, self._pm, self._pp)

    def hessian_vector(self, w, v) -> Tensor:
        """One streamed pass of H(w) v (the TRON inner-CG product)."""
        coef = self._coef(w)
        vv = self._coef(v)
        eff, mshift = self.norm.effective_coefficients(coef)
        eff_v, vshift = self.norm.effective_coefficients(vv)
        self.stats["hvp_passes"] += 1

        def partials(batch, slots, k):
            slice_hessian_vector_into(slots, k, self.loss, batch, eff, mshift, eff_v, vshift, plain=self.plain)

        hv_sum, csum = self._pass("hvp", HV, partials)
        return finalize_hessian_vector(vv, hv_sum, csum, self.norm, self._l2, self._pp)

    def close(self) -> None:
        """Stop the background stager (idempotent). A copy in flight lands
        harmlessly in a buffer nobody reads."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None

    # -- metrics --------------------------------------------------------------

    def record_metrics(self, site: str, solve_seconds: float) -> None:
        """The stream counters of one completed solve; ``site`` tells the FE
        stream (``fe.train``) from the RE stream (``re.train``)."""
        reg = obs.current_run().registry
        st = self.stats
        reg.counter("photon_stream_slices_total", "streamed slices staged through the chip").labels(
            site=site).inc(st["slices"])
        reg.counter("photon_stream_staged_bytes_total", "host bytes staged to device").labels(
            site=site).inc(st["staged_bytes"])
        passes = reg.counter("photon_stream_passes_total", "full streamed passes over the batch")
        passes.labels(site=site, kind="vg").inc(st["vg_passes"])
        passes.labels(site=site, kind="hvp").inc(st["hvp_passes"])
        reg.gauge("photon_stream_budget_bytes", "configured HBM budget").labels(site=site).set(self.budget_bytes)
        reg.gauge("photon_stream_actual_slice_bytes", "largest slice actually staged").labels(
            site=site).set(st["max_slice_bytes"])
        reg.gauge(
            "photon_stream_budget_headroom_bytes", "budget minus double-buffered peak (negative = over budget)"
        ).labels(site=site).set(self.budget_bytes - 2 * st["max_slice_bytes"])
        reg.gauge(
            "photon_stream_stage_seconds", "host wall spent dispatching H2D stages (overlapped under compute)"
        ).labels(site=site).set(st["stage_seconds"])
        reg.gauge("photon_stream_solve_seconds", "wall of the whole streamed solve").labels(
            site=site).set(solve_seconds)
        # the measured overlap: the share of the background stager's
        # staging wall that ran inside the passes' and collects' windows
        # (the JAX package's measure). Inline staging (depth 1) runs on the
        # solve thread between the kernels it feeds: it scores 0.
        if self.pipeline_depth <= 1 or self._prefetch is None:
            measured = 0.0
        else:
            measured = obs.overlap_ratio(self._intervals["stage"], self._intervals["pass"] + self._intervals["collect"])
        reg.gauge(
            "photon_stream_overlap_ratio", "fraction of staging wall overlapped with in-flight compute"
        ).labels(site=site).set(measured)
        if self._prefetch is not None:
            reg.gauge(
                "photon_stream_inflight_peak_bytes", "peak staged bytes in flight (queued + held), bounded by the budget"
            ).labels(site=site).set(self._prefetch.peak_inflight)


def score_streamed_fe(
    host_batch,  # game.data.HostRowBatch
    means: Tensor,  # f[d] model coefficients (original space)
    budget_bytes: int,
    score_dtype: torch.dtype,
    device: DeviceLike = None,
    plain: bool = False,
) -> Tensor:
    """Scores ``[n]`` of every row against ``means``, streaming row slices
    of the host planes through ``device`` double-buffered as in training
    (on the card a dense slice's product is ``torch.mv``, as the resident
    ``matvec`` is, an ELL slice's S1; ``plain`` sends the sparse products to
    their plain version). Returns device scores in ``score_dtype``."""
    dev = resolve_device(device)
    hb = host_batch.pinned() if dev.type == "cuda" else host_batch
    n = hb.n_rows
    step = _step(budget_bytes, staged_row_nbytes(hb), n)
    n_slices = -(-n // step)
    w = means.to(device=dev, dtype=score_dtype)
    # matvec reads the row segments alone: the planes are all it stages
    stager = _SliceStager(hb, step, n_slices, dev, keys=False)
    parts = []
    staged = stager.stage(0)
    for k in range(n_slices):
        nxt = stager.stage(k + 1) if k + 1 < n_slices else None
        stager.before_use(staged)
        parts.append(staged.features.matvec(w, plain=plain).to(score_dtype))
        stager.after_use(staged)
        if dev.type == "cuda":
            obs.add_device_put_bytes("fe_streaming.score_stage", staged.nbytes)
        staged = nxt
    obs.current_run().registry.counter(
        "photon_stream_slices_total", "streamed slices staged through the chip"
    ).labels(site=_SCORE_SITE).inc(n_slices)
    return parts[0] if len(parts) == 1 else torch.cat(parts)
