"""Out-of-core random-effect training: entity-block slices streamed through the card.

The JAX package's ``game/streaming.py`` on the port. A streamed dataset
keeps its entity blocks in host memory (page-locked for a card) and
streams fixed-size entity slices through the device:

- the slice size comes from an explicit byte budget, halved for double
  buffering;
- slice i+1's copy is issued on a copy stream of its own before slice i's
  solve runs, so the copy overlaps the solve; the slice's tensors are
  allocated on the copy stream and handed to the compute stream with
  ``record_stream``, and the solve waits on the copy's event;
- each slice's results are fetched to host memory as soon as its solve
  ends, so the device holds about two slices of data and one slice's solver
  state whatever the model's size.

Slices respect the size buckets (``coordinate._size_buckets``), so each
solve keeps its bucket's ``(K, S)`` shapes. Each slice is solved by the
coordinate's solver: the vmapped solve (``_train_blocks``, its reductions
V1 on the card), whose entity results do not depend on the other entities
of the stack, gives the in-memory solve's bits; the packed solve
(``_train_blocks_packed``) agrees to the solve bound. At pipeline depth
>= 2 (``game/pipeline.py``) staging moves to a background thread under the
same byte budget, with its own copy stream and events; slice geometry and
order do not change, so the results are depth 1's bit for bit.

Scoring streams the per-entity coefficient table through the device the
same way (``score_streamed``): the rows are regrouped by entity slice once,
so a score sweep is O(n) whatever the slice count.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..analysis.runtime import device_put
from ..device import DeviceLike, fetch, resolve_device
from ..models.game import ell_support_positions
from ..optimize import SolverResult
from ..optimize.common import ConvergenceReason
from ..utils.futures import PrefetchQueue
from . import pipeline

Tensor = torch.Tensor

# proj_cols / active_rows are int32 index planes (the builders make them so)
_INDEX_ITEMSIZE = 4
# the site label of the stream series (FE: fe.train / fe.score)
_TRAIN_SITE, _SCORE_SITE = "re.train", "re.score"
_RESULT_FIELDS = ("coefficients", "gradient", "loss", "iterations", "reason", "loss_history", "grad_norm_history")


def estimate_block_bytes(E: int, K: int, S: int, feature_itemsize: int = 4, scalar_itemsize: int = 4) -> int:
    """Device bytes of resident entity blocks of this shape: features,
    labels / offsets / weights (``scalar_itemsize``, 8 for a float64
    dataset), proj_cols and active_rows."""
    return E * K * S * feature_itemsize + 3 * E * K * scalar_itemsize + E * (S + K) * _INDEX_ITEMSIZE


def entities_per_slice(
    budget_bytes: int,
    K: int,
    S: int,
    feature_itemsize: int = 4,
    multiple: int = 8,
    scalar_itemsize: int = 4,
) -> int:
    """Entities per streamed slice under ``budget_bytes``: two slices of
    blocks resident (the double buffer) plus four ``[E_s, S]`` solver-state
    planes per entity (start, prior mean, coefficients, gradient) in the
    label dtype, rounded down to ``multiple``, at least one multiple."""
    state_planes = 4
    per_entity = (
        2 * (K * S * feature_itemsize + 3 * K * scalar_itemsize + (S + K) * _INDEX_ITEMSIZE)
        + state_planes * S * scalar_itemsize
    )
    e = max(budget_bytes // max(per_entity, 1), multiple)
    return int(e // multiple * multiple)


class _EntityStager:
    """The copies of entity slices to ``device``: on the card on a copy
    stream, each slice's tensors allocated there and handed to the compute
    stream (captured on the consumer's thread) with ``record_stream``; on
    the CPU a slice is its host tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.copy_stream = torch.cuda.Stream(device)

    def stage(self, host):
        """``(tensors, copied event)``: the copies issued on the copy
        stream; the solve waits for them on the device (``before_use``)."""
        if not self.cuda:
            return [t.contiguous() for t in host], None
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy_stream):
            dev = []
            for t in host:
                if not t.is_contiguous():
                    # a bucket's window is strided: gather it into page-locked
                    # memory first, so that the copy stays asynchronous
                    t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                d = t.to(self.device, non_blocking=True)
                d.record_stream(self.compute)
                dev.append(d)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        return dev, copied

    def before_use(self, copied) -> None:
        if copied is not None:
            self.compute.wait_event(copied)


def solve_streamed(
    blocks_np,  # EntityBlocks holding host tensors
    segments,  # [(start, end, K_b, S_b)] from _size_buckets (or one segment)
    residual_scores: Optional[Tensor],  # device f[n] or None
    w0_np: Tensor,  # [E, S] host
    prior_mean_np: Tensor,
    prior_prec_np: Tensor,
    budget_bytes: int,
    train_fn,  # coordinate._train_blocks or _train_blocks_packed
    solver_kwargs: dict,
    pipeline_depth: Optional[int] = None,  # None -> pipeline.active_depth()
    device: DeviceLike = None,
) -> SolverResult:
    """The double-buffered streamed solve over every entity slice; returns
    a ``SolverResult`` of host tensors in entity order (``syncs`` the sum of
    the slices' and one fetch a slice).

    At ``pipeline_depth`` >= 2 staging moves to a background thread bounded
    by the same byte budget (queued + held slice bytes <= ``budget_bytes``,
    an empty queue admits one: the inline double buffer's worst case).
    Slice geometry and solve order do not change, so the outputs are the
    serial loop's bit for bit."""
    dev = resolve_device(device)
    depth = pipeline.active_depth() if pipeline_depth is None else int(pipeline_depth)
    anchor = pipeline.stage_anchor()
    E, K, S = blocks_np.features.shape
    feat_itemsize = blocks_np.features.element_size()
    # the solve dtype follows the labels (features may be narrower)
    sdt = blocks_np.labels.dtype
    s_item = blocks_np.labels.element_size()

    slices = []
    for start, end, kb, sb in segments:
        step = max(min(entities_per_slice(budget_bytes, kb, sb, feat_itemsize, scalar_itemsize=s_item), end - start), 8)
        for s0 in range(start, end, step):
            slices.append((s0, min(s0 + step, end), kb, sb))

    T = solver_kwargs["max_iterations"] + 1
    out = {
        "coefficients": torch.zeros((E, S), dtype=sdt),
        "gradient": torch.zeros((E, S), dtype=sdt),
        "loss": torch.zeros(E, dtype=sdt),
        "iterations": torch.zeros(E, dtype=torch.int32),
        "reason": torch.full((E,), int(ConvergenceReason.NOT_CONVERGED), dtype=torch.int32),
        "loss_history": torch.full((E, T), float("nan"), dtype=sdt),
        "grad_norm_history": torch.full((E, T), float("nan"), dtype=sdt),
    }
    syncs = 0
    if not slices:
        # every segment was empty: zero coefficients, NOT_CONVERGED, NaN
        # histories
        return SolverResult(**out)

    staged_stats = {"total_bytes": 0, "max_slice_bytes": 0}
    intervals = {"stage": [], "collect": []}
    stager = _EntityStager(dev)

    def _host(sl):
        s0, s1, kb, sb = sl
        return (
            blocks_np.features[s0:s1, :kb, :sb],
            blocks_np.labels[s0:s1, :kb],
            blocks_np.offsets[s0:s1, :kb],
            blocks_np.weights[s0:s1, :kb],
            blocks_np.active_rows[s0:s1, :kb],
            w0_np[s0:s1, :sb],
            prior_mean_np[s0:s1, :sb],
            prior_prec_np[s0:s1, :sb],
        )

    def _slice_bytes(sl) -> int:
        return int(sum(t.numel() * t.element_size() for t in _host(sl)))

    def stage(sl, parent=None, background=False):
        bind = torch.cuda.device(dev) if background and stager.cuda else contextlib.nullcontext()
        with bind, obs.span("re_stream.stage", parent=parent, phase="stage", slice=sl[0]) as sp:
            nbytes = _slice_bytes(sl)
            staged_stats["total_bytes"] += nbytes
            staged_stats["max_slice_bytes"] = max(staged_stats["max_slice_bytes"], nbytes)
            if stager.cuda:
                obs.add_device_put_bytes("streaming.stage", nbytes)
            staged = stager.stage(_host(sl))
        intervals["stage"].append((sp.start_perf, sp.start_perf + sp.duration_s))
        return staged

    def solve(staged):
        tensors, copied = staged
        stager.before_use(copied)
        feats, labels, offsets, weights, active_rows, w0, pm, pp = tensors
        if residual_scores is not None:
            res = residual_scores[torch.clamp(active_rows, min=0).long()] * (active_rows >= 0)
            offsets = offsets + res.to(offsets.dtype)
        return train_fn(feats, labels, offsets, weights, w0, pm, pp, **solver_kwargs)

    def collect(sl, res):
        nonlocal syncs
        s0, s1, _, sb = sl
        with obs.span("re_stream.collect", phase="collect", slice=s0) as cp:
            host = fetch("streaming.collect", [getattr(res, f) for f in _RESULT_FIELDS])
        intervals["collect"].append((cp.start_perf, cp.start_perf + cp.duration_s))
        syncs += res.syncs + 1
        for f, a in zip(_RESULT_FIELDS, host):
            a = torch.from_numpy(a)
            dst = out[f][s0:s1, :sb] if f in ("coefficients", "gradient") else out[f][s0:s1]
            if dst.dtype != a.dtype:
                out[f] = out[f].to(a.dtype)
                dst = out[f][s0:s1, :sb] if f in ("coefficients", "gradient") else out[f][s0:s1]
            dst.copy_(a)

    est_max_slice = max(_slice_bytes(sl) for sl in slices)
    prefetch = None
    if depth > 1 and len(slices) > 1:
        prefetch = PrefetchQueue(
            lambda i: stage(slices[i], parent=anchor, background=True),
            len(slices),
            depth=depth,
            cost=lambda i: _slice_bytes(slices[i]),
            budget=budget_bytes,
            name="photon-re-stage",
        )

    def acquire(i):
        if prefetch is None:
            return stage(slices[i])
        idx, staged = prefetch.get()
        if idx != i:
            raise RuntimeError(f"re streaming prefetch out of order: staged slice {idx}, consumer wants {i}")
        return staged

    try:
        with obs.span("stream.solve", n_slices=len(slices), budget_bytes=int(budget_bytes)):
            staged = acquire(0)
            for i, sl in enumerate(slices):
                # inline, slice i+1's copy is issued before slice i's solve;
                # the background stager is already copying it
                nxt = acquire(i + 1) if prefetch is None and i + 1 < len(slices) else None
                res = solve(staged)
                collect(sl, res)
                del staged, res
                if i + 1 < len(slices):
                    staged = nxt if prefetch is None else acquire(i + 1)
    finally:
        if prefetch is not None:
            prefetch.close()

    reg = obs.current_run().registry
    site = dict(site=_TRAIN_SITE)
    reg.counter("photon_stream_slices_total", "streamed slices staged through the chip").labels(
        **site).inc(len(slices))
    reg.counter("photon_stream_staged_bytes_total", "host bytes staged to device").labels(
        **site).inc(staged_stats["total_bytes"])
    reg.gauge("photon_stream_budget_bytes", "configured HBM budget").labels(**site).set(budget_bytes)
    reg.gauge(
        "photon_stream_estimated_slice_bytes", "largest slice footprint by the block-byte estimator"
    ).labels(**site).set(est_max_slice)
    reg.gauge("photon_stream_actual_slice_bytes", "largest slice actually staged").labels(
        **site).set(staged_stats["max_slice_bytes"])
    reg.gauge(
        "photon_stream_budget_headroom_bytes", "budget minus double-buffered peak (negative = over budget)"
    ).labels(**site).set(budget_bytes - 2 * staged_stats["max_slice_bytes"])
    reg.gauge(
        "photon_stream_overlap_ratio", "fraction of staging wall overlapped with in-flight compute"
    ).labels(**site).set(obs.overlap_ratio(intervals["stage"], intervals["collect"]))
    if prefetch is not None:
        reg.gauge(
            "photon_stream_inflight_peak_bytes", "peak staged bytes in flight (queued + held), bounded by the budget"
        ).labels(**site).set(prefetch.peak_inflight)
    return SolverResult(**out, syncs=syncs)


class StreamedScoreCache:
    """The one-time regroup of rows by entity slice (plus the x_sub
    densification) that score sweeps reuse.

    ``slice_rows[k]`` holds the row indices whose entity lies in slice k,
    padded with the out-of-range sentinel ``n`` to a power of two;
    ``device_rows`` is the padded row count a sweep gathers (at most 2n
    whatever the slice count)."""

    def __init__(self, x_sub, step, slice_rows, device_rows):
        self.x_sub = x_sub  # [n, S] device
        self.step = step
        self.slice_rows = slice_rows  # per-slice device i32[m_k], pad = n
        self.device_rows = device_rows


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def score_streamed(
    coef_values_np: Tensor,  # [E, S] host model table
    proj_cols_np: Tensor,  # [E, S] host support layout
    row_entity: Tensor,  # device i32[n]
    ell_idx: Tensor,  # device i32[n, F]
    ell_val: Tensor,  # device f[n, F]
    budget_bytes: int,
    cache: Optional[StreamedScoreCache] = None,
    score_dtype: Optional[torch.dtype] = None,
) -> tuple:
    """Scores ``[n]`` of every row against a host-resident per-entity
    coefficient table, streaming entity slices of the table through the
    rows' device. Returns ``(scores, cache)``; reuse the cache across
    sweeps. The cache holds x_sub, the rows' features in the entity-subspace
    layout (row-sized ``[n, S]``, device-resident like the ELL arrays, summed
    feature by feature in the order ``models.game.ell_row_subspace`` sums
    them), and the rows regrouped by slice, so that slice k touches only its
    own rows: a sweep is O(n) whatever the slice count."""
    E, S = coef_values_np.shape
    n = row_entity.shape[0]
    dev = row_entity.device
    itemsize = coef_values_np.element_size()
    # photon: ignore[R3] — the //8*8 below rounds to the 8-entity lane
    # multiple (matches entities_per_slice), not an itemsize
    step = max(int(budget_bytes // max(S * itemsize * 2, 1)) // 8 * 8, 8)
    if score_dtype is None:
        score_dtype = torch.promote_types(ell_val.dtype, torch.float32)

    if cache is None or cache.x_sub is None:
        x_sub = torch.zeros((n, S), dtype=ell_val.dtype, device=dev)
        rows = torch.arange(n, device=dev)
        zero = torch.zeros((), dtype=ell_val.dtype, device=dev)
        for s0 in range(0, E, step):
            s1 = min(s0 + step, E)
            pc = device_put(proj_cols_np[s0:s1], dev)
            in_sl = (row_entity >= s0) & (row_entity < s1)
            # rows outside the slice resolve against entity 0's layout; their
            # contribution is masked to zero
            loc = torch.where(in_sl, row_entity - s0, torch.zeros_like(row_entity))
            pos, hit = ell_support_positions(pc, loc, ell_idx)
            hit = hit & in_sl[:, None]
            for f in range(ell_idx.shape[1]):
                p = pos[:, f].long()
                x_sub[rows, p] = x_sub[rows, p] + torch.where(hit[:, f], ell_val[:, f], zero)
        cache = StreamedScoreCache(x_sub, -1, None, 0)

    if cache.step != step or cache.slice_rows is None:
        # one-time regroup: rows sorted by entity are contiguous by slice;
        # each slice's rows pad to a power of two with the sentinel n
        (re_np,) = fetch("streaming.score_regroup", [row_entity])
        re_np = re_np.astype(np.int64)
        order = np.argsort(re_np, kind="stable")
        edges = np.arange(0, E + step, step)[: (E + step - 1) // step + 1]
        bounds = np.searchsorted(re_np[order], edges)
        slice_rows = []
        device_rows = 0
        for k in range(len(edges) - 1):
            rows_k = order[bounds[k] : bounds[k + 1]]
            if len(rows_k) == 0:
                slice_rows.append(None)
                continue
            m = _pow2_ceil(len(rows_k))
            padded = np.full(m, n, dtype=np.int32)
            padded[: len(rows_k)] = rows_k
            slice_rows.append(device_put(padded, dev))
            device_rows += m
        cache = StreamedScoreCache(cache.x_sub, step, slice_rows, device_rows)
        obs.current_run().registry.gauge(
            "photon_stream_score_device_rows",
            "padded rows gathered per streamed score sweep (O(n), flat in slice count)",
        ).labels(site=_SCORE_SITE).set(device_rows)

    xsub_wide = cache.x_sub.to(score_dtype)  # cast once per sweep
    scores = torch.zeros(n, dtype=score_dtype, device=dev)
    n_slices = (E + step - 1) // step
    for k in range(n_slices):
        idx = cache.slice_rows[k]
        if idx is None:
            continue
        s0 = k * step
        s1 = min(s0 + step, E)
        w = device_put(coef_values_np[s0:s1], dev)
        if dev.type == "cuda":
            obs.add_device_put_bytes("streaming.score_stage", w.numel() * w.element_size())
        valid = idx < n
        safe = torch.clamp(idx, max=n - 1).long()
        loc = torch.where(valid, row_entity[safe] - s0, torch.zeros_like(idx)).long()
        wr = w[loc].to(score_dtype)  # [m, S]
        part = torch.sum(wr * xsub_wide[safe], dim=1)
        # padding rows add an exact zero to row n - 1: no masked compaction,
        # so no host synchronize
        scores.index_add_(0, safe, torch.where(valid, part, torch.zeros_like(part)))
    obs.current_run().registry.counter(
        "photon_stream_slices_total", "streamed slices staged through the chip"
    ).labels(site=_SCORE_SITE).inc(n_slices)
    return scores, cache
