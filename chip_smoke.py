#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--d 1024] [--users 20000] [--d-re 32] [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi); TF32 off for matmul and cuDNN;
2. build every CUDA source of photon_ml_tpu_torch/csrc with nvcc for sm_90a
   (one nvcc per source, started together) and print -Xptxas -v;
3. hold each kernel against its plain PyTorch version, computed in float64
   from the same rounded inputs: all 4 losses, f32 and bf16 X, aligned and
   ragged row counts, small shapes and the main path's n x d, the Hessian
   statistics with and without the normalization shifts. Bounds are the
   reference suite's: value and s0 rtol 2e-6; gradient, Hv (with their
   scalar sums), s2 and s1 max-abs error <= 3e-5 * max(|ref|, 1); then B4's
   parts: the rank-order sum kernel against its plain version (bitwise, worlds
   1, 2, 4 and 8 at the main path's output widths) and the finalize's slot
   form against the f32 output widened (bitwise, B1-B3 at n x d);
4. the fixed-effect path: bench-shaped logistic data made on the card from
   --seed, batch_from_dense -> GLMProblem(TRON, tol 1e-6, 10 iterations,
   L2 1.0).run -> model.score -> auc, with every launch counter at 0 before
   and read after; the same solve with the plain versions forced must agree
   at rtol 1e-3, atol 1e-5, and the card's solve of a small problem must
   reach the CPU solve's loss at rtol 1e-5; then one L-BFGS solve;
5. the GLMix sweep, the main path: bench.py's build_data (n x d dense fixed
   effect, --users users with --d-re per-user features, Zipf-skewed), one
   CoordinateDescent sweep of FixedEffectCoordinate (TRON tol 1e-6, 10
   iterations, L2 1.0, SIMPLE variance: kernels B1, B2, B3) and
   RandomEffectCoordinate (packed batched L-BFGS tol 1e-6, 30 iterations,
   L2 1.0, active cap 256), three timed sweeps after a warm-up one (five
   before the data-parallel phase joined the run's time limit), with
   every launch counter at 0 before them and read after (B3 launches once
   per fixed-effect solve). The same sweep with the
   plain versions forced must agree, and so must a small sweep on the card
   and on the CPU: fixed-effect coefficients and variances at rtol 1e-3 /
   atol 1e-5; random-effect coefficients at atol 5e-3 and per-entity loss
   at atol 1e-4, on identical residuals (the other side's random effect
   retrained on this side's fixed-effect scores). Random effects chained on
   two fixed effects are printed, not held: at bench shapes two fixed
   effects that agree to 1e-8 leave a capped user's loss (~1.7e4, with the
   count/cap weight rescale) apart by ~2e-4 (PERF.md).
   Prints the median sweep's wall seconds and examples/s with the spread,
   the coordinates' shares of the wall, syncs per coordinate and the
   training AUC; then one more sweep under torch.profiler (the device's busy
   share of the sweep, the top device operations);
6. the data-parallel GLMix sweep (kernel B4: B1-B3 on each rank's rows, the
   finalize writing into the rank's row of a float64 slot buffer, one
   all-gather over torch.distributed and the rank-order sum kernel), in
   processes started by photon_ml_tpu_torch.parallel.spawn, the kernels
   built here first:
   (a) B4 on 4 gloo ranks sharing the card against the float64 plain
   versions on the whole batch, at n and n-1 rows, f32 and bf16 X, logistic,
   Hessian statistics with and without shifts, at the bounds of phase 3;
   every rank bitwise alike, and bitwise equal to the all-reduce path (the rank's
   f32 outputs into a zero slot buffer, an all-reduce, a loop); at n rows
   each function's time per call in turns with the all-reduce path (prev, new, new,
   prev), its collective alone (both designs) and the rank's kernel alone;
   (b) the sweep of phase 5 on 4 gloo ranks (each rank reads its rows of the
   fixed effect's X from a memory-mapped .npy the parent wrote, builds the
   random effect and keeps its entity range), one warm-up and three timed
   sweeps, walls on rank 0 between barriers after a synchronize on every
   rank, launch counters at 0 before them; held against phase 5's sweep:
   fixed-effect coefficients and variances rtol 1e-3 / atol 1e-5,
   random-effect coefficients atol 5e-3 and per-entity loss atol 1e-4 on
   identical residuals (phase 5's random effect retrained on the 4-rank
   fixed effect's scores); prints examples/s, shares, each rank's RE wall
   and padded work, syncs and collectives per coordinate;
   (c) the same sweep over NCCL with one rank per card, one warm-up and
   three timed sweeps, the median printed beside phase 5's: on a one-card
   machine one rank, whose fixed-effect coefficients and variances must
   equal phase 5's bitwise; B4's three functions timed there as in (a), a
   B4 call of each with CUDA's sync debug mode at "error" and
   torch.cuda.synchronize counted (no host synchronize allowed), and the
   device operations of one profiled call;
7. each kernel timed with CUDA events beside its bound (bytes over 3.35 TB/s,
   or operations over the dtype's peak) and its plain version (the rank-order
   sum, a few microseconds, replayed from a CUDA graph, beside torch.sum over
   the ranks); B1 and B2 in
   turns with the previous design (the staged body and the serial finalize,
   prev/new/new/prev), each body's main kernel and finalize alone (replayed
   from a CUDA graph), the launch plan (grid, blocks per SM, rows per tile,
   stages, shared bytes), and torch.mv(X, coef) as the time to read X once;
8. diagnostic variants of the segment kernel (SEGMENT_VARIANTS: contiguous
   reads in place of the gathers, the key walk without its output stores,
   the gathers under an L2 evict-last policy, the earlier design as it is
   and with streamed entries) on the sparse shape's products, replayed from CUDA
   graphs in turns, and ELL matvec with w of 10, 20 and 30 MB beside d's
   40; then of the ring body (RING_VARIANTS: margins in f32, no margins, no
   column sums, neither), each computing wrong sums, timed in turns with
   the ring to show what each part of its work costs;
9. the sparse fixed effects (run after phase 6 and before phase 7), every
   sparse product one launch of the segment kernel (csrc/sparse_glm.cu:
   row groups for matvec, a key walk over int32 keys for rmatvec and
   sq_rmatvec):
   (a) the kernel against its float64 plain version for all six products
   (ELL and COO matvec, rmatvec, sq_rmatvec), f32 and bf16 values, at
   bench.py's sparse shape (n=200,000, d=10,000,000, 32 entries a row) and a
   small ragged one (a full column, an empty column, empty rows, repeated
   pairs): max-abs error <= 3e-5 * max(|ref|, 1), and two launches give the
   same bits; (b) bench.py's sparse configuration at that shape through
   RawDataset.to_batch (COO, then ELL) and GLMProblem.run (logistic,
   L-BFGS tol 1e-9, 20 iterations, L2 1.0): the segment kernel's launches
   counted from 0 (the plain and dense counters must stay 0), two runs with
   the same bits, held against the plain route on the card by loss at
   rtol 1e-5, examples * iterations / s printed, each batch's companion
   bytes (the segments' tensors beyond the layout's own arrays) printed,
   and one more solve under torch.profiler (device time by kernel name,
   the segment kernel's time per launch inside the solve, the card's busy
   share of the solve's wall); then one OWL-QN solve (L1
   1.0, SIMPLE variance) on COO, its nonzeros printed, its loss held the
   same way and its variances at rtol 1e-3; (c) phase 5's
   sweep with its global shard sparse (n=500,000 rows of 32 entries over
   d=10,000,000, build_fixed_effect_dataset(layout="auto") picks ELL; FE
   TRON + SIMPLE variance, RE phase 5's), a warm-up and three timed sweeps
   with the counters at 0 before them, held against the plain route on the
   card at phase 5's bounds. Phase 7 then times each product at the sparse
   shape beside its bound (segment_bytes: entries, source and output once;
   the design's own bytes and a sector per gather beside), in turns with
   the earlier design (csrc/sparse_glm_warp.cu: prev, new, new, prev), both
   also replayed from a CUDA graph, its plain version, index_add_ and a
   cuSPARSE CSR SpMV (torch.mv on a sparse CSR tensor).

    python3 chip_smoke.py --only timing    # card, build, then one phase

runs a subset of phases 3-9 (check, fe, glmix, dp, nccl, sparse, timing, variants)
and then reports not ok; "nccl" is phase 6 (c) alone after phase 5 (for a
machine with several cards: one NCCL rank per card).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when there is no card or no port to run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per dtype
REPLACES = {
    "fused_value_grad": "photon_ml_tpu/ops/pallas_glm.py:165",
    "fused_hessian_vector": "photon_ml_tpu/ops/pallas_glm.py:203",
    "fused_hessian_stats": "photon_ml_tpu/ops/pallas_glm.py:238",
    "sharded_value_grad": "photon_ml_tpu/ops/pallas_glm.py:361",
    "sharded_hessian_vector": "photon_ml_tpu/ops/pallas_glm.py:390",
    "sharded_hessian_stats": "photon_ml_tpu/ops/pallas_glm.py:517",
    "rank_order_sum": "photon_ml_tpu/ops/pallas_glm.py:345",
}
KERNELS = tuple(REPLACES)
# the segment kernel replaces the JAX package's XLA gathers and scatter-adds
# (no Pallas kernel); by the product that each of its lines times
SPARSE_REPLACES = {
    "matvec": "photon_ml_tpu/ops/features.py:103",
    "rmatvec": "photon_ml_tpu/ops/features.py:130",
    "sq_rmatvec": "photon_ml_tpu/ops/features.py:160",
}
DESIGN = {
    "fused_value_grad": "ring: a producer warp keeps row tiles in flight by cp.async.bulk on mbarriers "
                        "(2 stages per consumer warp; 7 consumer warps, 16 KB tiles for f32, 11 and 8 KB "
                        "for bf16), a consumer warp takes 4 rows at a time with the coefficients in double "
                        "in registers and its column partials in registers; tree finalize",
    "fused_hessian_vector": "ring, as fused_value_grad; v in double in registers (f32) or in shared "
                            "memory (bf16); tree finalize",
    "fused_hessian_stats": "staged: 16-byte loads into shared tiles, a warp per row, a thread per "
                           "column; tree finalize",
    "rank_order_sum": "one thread per column adds the [world, width] float64 slot rows in rank order "
                      "in double and writes f32; no atomics",
    "segment_dot": "matvec: row groups of 4-32 lanes a segment (8 at 32 entries a row), each lane 4 "
                   "consecutive entries a pass by 16-byte loads, all its gathers issued before its first add, a "
                   "butterfly over the group; rmatvec and sq_rmatvec (and matvec with a row over 512 entries): "
                   "a key walk over int32 keys with no per-column pointer, a warp a tile of 256 entries, 8 a "
                   "lane, runs of equal keys added in entry order, a segmented scan over the lanes, float64 "
                   "carries for keys that cross tiles added in tile order by a second small kernel, each tile's "
                   "outputs (empty columns as zeros) staged in shared memory and stored coalesced; entries "
                   "streamed with evict-first loads; double sums, each output written once; no atomics",
}
PREV_SEGMENT_DESIGN = (
    "a warp per 32 consecutive segments over int64 pointers: a segment of at most 4 entries summed by its lane, "
    "a longer one by the whole warp; segments of more than 4,096 entries cut into chunks, a warp each, added "
    "by a second kernel (csrc/sparse_glm_warp.cu)")
B4_DESIGN = ("the rank's B1-B3 with its tree finalize writing the f32 totals widened to float64 into the "
             "rank's row of the group's cached [world, width] slot buffer; one in-place all-gather (NCCL: "
             "on the card in stream order, timed by CUDA events, no host synchronize; gloo: staged through "
             "a host buffer); the rank_order_sum kernel into the f32 outputs")
# B4's per-rank compute is B1-B3 (csrc/fused_glm.cu); its wrappers and the
# rank-order sum live in ops/fused_glm.py
SOURCES = {
    name: "photon_ml_tpu_torch/ops/fused_glm.py" if name.startswith("sharded_")
    else "photon_ml_tpu_torch/csrc/fused_glm.cu"
    for name in KERNELS
}
SUM_WORLDS = (1, 2, 4, 8)  # worlds of phase 3's rank-order sum check
# B4 name -> the one-rank kernel each rank runs (B1-B3)
B4_OF = {
    "sharded_value_grad": "fused_value_grad",
    "sharded_hessian_vector": "fused_hessian_vector",
    "sharded_hessian_stats": "fused_hessian_stats",
}
SWEEPS = 3  # timed GLMix sweeps; launches are counted over all of them
DP_RANKS = 4  # gloo ranks sharing the card in phase 6 (a) and (b)
DP_TIMEOUT_S = 300.0  # each spawn of phase 6, start to join


def log(*parts) -> None:
    print(*parts, flush=True)


class Phases:
    def __init__(self) -> None:
        self.failed = []

    def run(self, name, fn, *args):
        log(f"== phase: {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase is reported and the script goes on
            traceback.print_exc()
            self.failed.append(name)
            log(f"== phase {name}: FAILED after {time.perf_counter() - t0:.1f}s")
            return None
        log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f}s")
        return out


def card(torch):
    from photon_ml_tpu_torch.device import nvidia_smi_identity

    out = nvidia_smi_identity()
    if not out:
        raise RuntimeError("nvidia-smi did not report the card's name and power limit")
    log(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return out


def build():
    from photon_ml_tpu_torch.ops import cuda_lib

    names = cuda_lib.all_sources()
    t0 = time.perf_counter()
    logs = cuda_lib.build(names)
    log(f"built {list(names)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "error", "warning")):
                log(f"  [{name}] {line.strip()}")
    return logs


def make_inputs(torch, gen, n, d, loss_name, xdt, dev):
    x = torch.randn((n, d), generator=gen, device=dev).to(xdt)
    coef = torch.randn(d, generator=gen, device=dev) * (0.5 / math.sqrt(d))
    v = torch.randn(d, generator=gen, device=dev)
    y = (torch.rand(n, generator=gen, device=dev) > 0.5).float()
    if loss_name == "poisson":
        y = y * 2
    off = torch.randn(n, generator=gen, device=dev) * 0.1
    wt = torch.rand(n, generator=gen, device=dev) + 0.5
    vshift = torch.randn((), generator=gen, device=dev) * 0.1
    return x, coef, v, y, off, wt, vshift


def errors(torch, inputs, loss):
    """Kernel against the float64 plain version on the same inputs: returns
    (value rel err, grad max-abs err, grad bound, Hv max-abs err, Hv bound)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    x, coef, v, y, off, wt, vshift = inputs
    val, grad, wdz = fg.fused_value_grad(x, coef, y, off, wt, loss)
    hv, csum = fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)
    torch.cuda.synchronize()
    f64 = torch.float64
    rval, rgrad, rwdz = fg.value_grad_plain(x, coef, y, off, wt, loss, compute_dtype=f64)
    rhv, rcsum = fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss, compute_dtype=f64)

    def vec_err(got, ref):
        got = got.to(f64)
        return float((got - ref).abs().max()), 3e-5 * max(float(ref.abs().max()), 1.0)

    g_err, g_bound = vec_err(torch.cat([grad, wdz.reshape(1)]), torch.cat([rgrad, rwdz.reshape(1)]))
    h_err, h_bound = vec_err(torch.cat([hv, csum.reshape(1)]), torch.cat([rhv, rcsum.reshape(1)]))
    v_rel = abs(float(val) - float(rval)) / max(abs(float(rval)), 1e-30)
    finite = all(bool(torch.isfinite(t).all()) for t in (val, grad, wdz, hv, csum))
    return v_rel, g_err, g_bound, h_err, h_bound, finite, float(grad.sub(rgrad).abs().max()), float(hv.sub(rhv).abs().max())


def stats_errors(torch, inputs, loss, need_shifts):
    """B3 against its float64 plain version: returns (s2/s1 max-abs err,
    bound, s0 rel err, finite, s2 max-abs err)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    x, coef, _, y, off, wt, _ = inputs
    s2, s1, s0 = fg.fused_hessian_stats(x, coef, y, off, wt, loss, need_shifts)
    torch.cuda.synchronize()
    r2, r1, r0 = fg.hessian_stats_plain(x, coef, y, off, wt, loss, need_shifts, compute_dtype=torch.float64)
    got, ref = s2.double(), r2
    if need_shifts:
        got, ref = torch.cat([s2.double(), s1.double()]), torch.cat([r2, r1])
    err = float((got - ref).abs().max())
    bound = 3e-5 * max(float(ref.abs().max()), 1.0)
    s0_rel = abs(float(s0) - float(r0)) / max(abs(float(r0)), 1e-30) if need_shifts else 0.0
    finite = bool(torch.isfinite(s2).all()) and (not need_shifts or bool(torch.isfinite(s1).all()))
    return err, bound, s0_rel, finite, float((s2.double() - r2).abs().max())


def check_kernels(torch, n_full, d_full, seed):
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    cases = []
    for n, d in ((4096, 1024), (4099, 1024), (4101, 203), (n_full, d_full), (n_full - 1, d_full)):
        for xname in ("float32", "bfloat16"):
            for loss_name in ("logistic", "squared", "poisson", "smoothed_hinge"):
                cases.append((n, d, xname, loss_name))
    bad = []
    main_errs = {}
    for i, (n, d, xname, loss_name) in enumerate(cases):
        gen.manual_seed(seed * 1000 + i)
        inputs = make_inputs(torch, gen, n, d, loss_name, getattr(torch, xname), dev)
        v_rel, g_err, g_bound, h_err, h_bound, finite, g_abs, h_abs = errors(torch, inputs, LOSSES[loss_name])
        ok = finite and v_rel <= 2e-6 and g_err <= g_bound and h_err <= h_bound
        log(f"  check n={n} d={d} {xname:8s} {loss_name:14s} value_rel={v_rel:.2e} "
            f"grad_err={g_err:.3e}/{g_bound:.3e} hv_err={h_err:.3e}/{h_bound:.3e} "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            bad.append((n, d, xname, loss_name))
        if (n, d, xname, loss_name) == (n_full, d_full, "float32", "logistic"):
            main_errs = {"fused_value_grad": g_abs, "fused_hessian_vector": h_abs}
        for need_shifts in (False, True):
            err, bound, s0_rel, finite, s2_abs = stats_errors(torch, inputs, LOSSES[loss_name], need_shifts)
            ok = finite and err <= bound and s0_rel <= 2e-6
            log(f"  check n={n} d={d} {xname:8s} {loss_name:14s} hessian_stats shifts={int(need_shifts)} "
                f"s2s1_err={err:.3e}/{bound:.3e} s0_rel={s0_rel:.2e} {'ok' if ok else 'MISS'}")
            if not ok:
                bad.append((n, d, xname, loss_name, "stats", need_shifts))
            # the main path's fixed effect has no normalization: no shifts
            if (n, d, xname, loss_name, need_shifts) == (n_full, d_full, "float32", "logistic", False):
                main_errs["fused_hessian_stats"] = s2_abs
        del inputs
        torch.cuda.empty_cache()
    main_errs["rank_order_sum"], parts_bad = check_b4_parts(torch, gen, n_full, d_full, seed)
    bad += parts_bad
    if bad:
        raise AssertionError(f"kernels disagree with the float64 plain version on {bad}")
    return main_errs


def check_b4_parts(torch, gen, n, d, seed):
    """B4's two new parts on the card. The rank-order sum kernel against its
    plain version, bitwise, on random float64 slots of wide magnitudes
    (worlds SUM_WORLDS, the main path's output widths); the finalize's slot
    form against the f32 output widened, bitwise, for B1-B3 at n x d f32.
    Returns (the sum's max-abs error, the cases that missed)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    bad, err = [], 0.0
    saved = dict(fg.SUM_LAUNCHES)
    for world in SUM_WORLDS:
        for mode in (fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS):
            width = fg._out_width(mode, d)
            gen.manual_seed(seed * 131 + world * 7 + mode)
            scale = 10.0 ** torch.randint(-8, 9, (world, width), generator=gen, device=dev).double()
            slots = torch.randn((world, width), generator=gen, device=dev, dtype=torch.float64) * scale
            got = fg.rank_order_sum(slots, torch.float32)
            want = fg.rank_order_sum_plain(slots, torch.float32)
            same = _same_bits(got, want)
            err = max(err, float((got.double() - want.double()).abs().max()))
            if not same:
                bad.append(("rank_order_sum", world, width))
    fg.SUM_LAUNCHES.update(saved)  # checks are not main-path launches
    log(f"  check rank_order_sum kernel vs plain, worlds {SUM_WORLDS}, widths "
        f"{[fg._out_width(m, d) for m in (fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS)]}: bitwise equal "
        f"{not bad} (max abs diff {err:.3e})")
    gen.manual_seed(seed + 11)
    x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", torch.float32, dev)
    saved = dict(fg.ROUTES)
    for mode in (fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS):
        hv = mode == fg.HV
        operands = (x, coef, v if hv else None, y, off, wt, vshift if hv else None, LOSSES["logistic"])
        out = fg._launch(mode, *operands)
        slot = torch.empty(fg._out_width(mode, d), dtype=torch.float64, device=dev)
        fg._launch(mode, *operands, slot=slot)
        same = _same_bits(slot, out.double())
        log(f"  check finalize into the slot, mode {mode}, n={n} d={d} float32: the f32 output "
            f"widened, bitwise: {same}")
        if not same:
            bad.append(("slot finalize", mode))
    fg.ROUTES.update(saved)
    del x
    torch.cuda.empty_cache()
    return err, bad


def bench_data(torch, n, d, seed, dev):
    """bench.py's build_data without the random-effect term: standard-normal
    X with a constant last column, labels from a logistic model."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    x[:, -1] = 1.0
    w = torch.randn(d, generator=gen, device=dev) / math.sqrt(d)
    y = (torch.rand(n, generator=gen, device=dev) < torch.sigmoid(torch.mv(x, w))).float()
    return x, y


def solve(torch, batch, optimizer_cfg, plain=False):
    from photon_ml_tpu_torch.evaluation.device import auc
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    problem = GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(
            optimizer=optimizer_cfg, regularization=RegularizationContext("L2"), reg_weight=1.0
        ),
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, res = problem.run(batch, plain=plain)
    scores = model.score(batch)
    a = auc(scores, batch.labels, batch.weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return model, res, scores, float(a), wall


def allclose(a, b, rtol=1e-3, atol=1e-5):
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    worst = float(((a - b).abs() - (atol + rtol * b.abs())).max())
    return worst <= 0.0, float((a - b).abs().max())


def fe_path(torch, n, d, seed):
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

    dev = torch.device("cuda")
    x, y = bench_data(torch, n, d, seed, dev)
    batch = batch_from_dense(x, y)
    tron = OptimizerConfig(optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=10)

    # a first, untimed solve loads PyTorch's own lazily loaded kernels
    # (sort, scan, ...) so that neither timed solve pays for it
    solve(torch, batch, tron)
    fg.reset_launch_counts()
    model, res, scores, a, wall = solve(torch, batch, tron)
    launches = dict(fg.LAUNCHES)
    loss = float(res.loss)
    log(f"  TRON kernels: iterations={res.iterations} reason={res.reason} loss={loss:.6f} "
        f"auc={a:.6f} wall_s={wall:.3f} syncs={res.syncs} launches={launches} by body {dict(fg.ROUTES)}")
    problems = []
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"]) <= 0:
        problems.append(f"a kernel of the fixed-effect path was not launched: {launches}")
    if not (math.isfinite(loss) and bool(torch.isfinite(scores).all()) and scores.shape == (n,)):
        problems.append("non-finite loss or scores, or scores of the wrong shape")
    if not (0.5 < a <= 1.0):
        problems.append(f"AUC {a} out of (0.5, 1]")

    fg.reset_launch_counts()
    model_p, res_p, _, a_p, wall_p = solve(torch, batch, tron, plain=True)
    log(f"  TRON plain:   iterations={res_p.iterations} reason={res_p.reason} "
        f"loss={float(res_p.loss):.6f} auc={a_p:.6f} wall_s={wall_p:.3f} launches={dict(fg.LAUNCHES)}")
    if any(fg.LAUNCHES.values()):
        problems.append("the plain solve launched a kernel")
    ok, diff = allclose(model.coefficients.means, model_p.coefficients.means)
    log(f"  kernel vs plain coefficients: max abs diff {diff:.3e} (rtol 1e-3, atol 1e-5) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"kernel and plain solves disagree (max abs diff {diff:.3e})")

    # a small problem: the card's kernel solve against the CPU's plain solve.
    # Both stop where the f32 loss stops resolving, so the reference is the
    # objective value each reaches (the CPU tests' rtol 1e-5 on the loss).
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    xs, ys = x[:4096, :64].contiguous(), y[:4096]
    _, r_card, *_ = solve(torch, batch_from_dense(xs, ys), tron)
    _, r_cpu = GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(optimizer=tron, regularization=RegularizationContext("L2"), reg_weight=1.0),
    ).run(batch_from_dense(xs.cpu(), ys.cpu(), device="cpu"))
    l_card, l_cpu = float(r_card.loss), float(r_cpu.loss)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    ok = rel <= 1e-5
    log(f"  small problem card vs CPU: iterations {r_card.iterations}/{r_cpu.iterations} "
        f"loss {l_card:.6f}/{l_cpu:.6f} rel diff {rel:.2e} (rtol 1e-5) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"card and CPU solves of a small problem reach different losses ({rel:.2e})")

    fg.reset_launch_counts()
    _, res_l, scores_l, a_l, wall_l = solve(torch, batch, OptimizerConfig())
    log(f"  L-BFGS kernels: iterations={res_l.iterations} reason={res_l.reason} "
        f"loss={float(res_l.loss):.6f} auc={a_l:.6f} wall_s={wall_l:.3f} syncs={res_l.syncs} "
        f"launches={dict(fg.LAUNCHES)}")
    if fg.LAUNCHES["fused_value_grad"] <= 0 or not math.isfinite(float(res_l.loss)):
        problems.append("the L-BFGS solve did not run through fused_value_grad or diverged")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def build_data(n=500_000, d_fixed=1024, n_users=20_000, d_re=32, seed=0):
    """bench.py's build_data, copied: dense global features with a constant
    last column, Zipf(1.1)-skewed user assignment, per-user features with
    an intercept column, labels from a logistic model of both.

    Returns (gx, y, ex, ids): dense global features, labels, per-user
    features, user ids."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((n, d_fixed), dtype=np.float32)
    gx[:, -1] = 1.0
    w = (rng.standard_normal(d_fixed) / np.sqrt(d_fixed)).astype(gx.dtype)
    z = gx @ w
    probs = 1.0 / np.arange(1, n_users + 1) ** 1.1
    probs /= probs.sum()
    assign = rng.choice(n_users, size=n, p=probs)
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    w_u = (rng.standard_normal((n_users, d_re)) / np.sqrt(d_re)).astype(ex.dtype)
    z = z + np.einsum("nd,nd->n", ex, w_u[assign])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(gx.dtype)
    ids = np.char.add("u", assign.astype(str)).astype(object)
    return gx, y, ex, ids


def glmix_coordinates(data, dev, plain=False, group=None, fe_dataset=None):
    """bench.py's product-path datasets and coordinates on ``dev``: the
    fixed effect batches the dense matrix; the random effect runs the real
    build on a userShard-only RawDataset with active cap 256. With a
    ``group``, the fixed effect's batch is this rank's rows (read from
    ``gx``, which may be memory-mapped) and the random effect keeps the
    rank's entity range. ``fe_dataset`` replaces the dense fixed effect
    (the sparse phase's)."""
    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinate, FixedEffectDataset, GLMOptimizationConfig,
        RandomEffectCoordinate, build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType
    from photon_ml_tpu_torch.parallel import local_batch, row_range, shard_random_effect_dataset

    gx, y, ex, ids = data
    n, d_re = ex.shape
    raw = RawDataset(
        n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"userShard": (
            np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n),
            ex.reshape(-1).astype(np.float64),
        )},
        shard_dims={"userShard": d_re}, id_tags={"userId": ids},
    )
    reg = dict(regularization=RegularizationContext("L2"), reg_weight=1.0)
    cfg_fe = GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=10),
        variance_type="SIMPLE", **reg,
    )
    cfg_re = GLMOptimizationConfig(optimizer=OptimizerConfig(tolerance=1e-6, max_iterations=30), **reg)
    if fe_dataset is not None:
        fe_ds = fe_dataset
    elif group is None:
        fe_ds = FixedEffectDataset("global", "global", batch=batch_from_dense(gx, y, device=dev))
    else:
        start, stop = row_range(n, group)
        rows = batch_from_dense(np.array(gx[start:stop]), y[start:stop], device=dev)
        fe_ds = FixedEffectDataset("global", "global", batch=local_batch(rows, n, group), true_n_rows=n)
    re_ds = build_random_effect_dataset(
        raw, "per-user", "userShard", "userId", active_cap=256, device=dev,
        pad_entities_to_multiple=1 if group is None else group.world_size,
    )
    if group is not None:
        re_ds = shard_random_effect_dataset(re_ds, group)
    return {
        "global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=cfg_fe, plain=plain),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=cfg_re),
    }


def sweep(torch, coords):
    """One CoordinateDescent sweep; (result, wall seconds) on the host clock
    around work that ends in a device synchronize (over a group: between two
    barriers, after a synchronize on every rank)."""
    from photon_ml_tpu_torch.game import CoordinateDescent

    dev = coords["global"].dataset.batch.device
    group = coords["global"].group
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        group.barrier()
    t0 = time.perf_counter()
    result = CoordinateDescent(coords, n_iterations=1).run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        group.barrier()
    return result, time.perf_counter() - t0


def training_auc(coords, result):
    from photon_ml_tpu_torch.evaluation.device import auc

    batch = coords["global"].dataset.batch
    scores = sum(coords[name].score(result.model[name]) for name in coords)
    return float(auc(scores + batch.offsets, batch.labels, batch.weights)), scores


def hold(problems, what, got, ref, rtol, atol):
    ok, diff = allclose(got, ref, rtol=rtol, atol=atol)
    log(f"  {what}: max abs diff {diff:.3e} (rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"{what} disagree (max abs diff {diff:.3e})")


def hold_sweeps(problems, label, a, b, re_b):
    """The sweep bounds: fixed-effect coefficients and variances rtol 1e-3 /
    atol 1e-5; random-effect coefficients atol 5e-3, per-entity loss atol
    1e-4. ``re_b`` is b's random-effect (model, result) retrained on a's
    fixed-effect scores, so that the random effects compare on identical
    residuals. The random effects as each sweep chained them on its own
    fixed effect are printed beside, for the record."""
    fa, fb = a.model["global"].coefficients, b.model["global"].coefficients
    hold(problems, f"{label} FE coefficients", fa.means, fb.means, 1e-3, 1e-5)
    hold(problems, f"{label} FE variances", fa.variances, fb.variances, 1e-3, 1e-5)
    rb_model, rb_res = re_b
    hold(problems, f"{label} RE coefficients", a.model["per-user"].coef_values, rb_model.coef_values, 0.0, 5e-3)
    hold(problems, f"{label} RE loss", a.solver_results["per-user"].loss, rb_res.loss, 0.0, 1e-4)
    _, coef = allclose(a.model["per-user"].coef_values, b.model["per-user"].coef_values, 0.0, 5e-3)
    _, loss = allclose(a.solver_results["per-user"].loss, b.solver_results["per-user"].loss, 0.0, 1e-4)
    worst = int(
        (a.solver_results["per-user"].loss.cpu() - b.solver_results["per-user"].loss.cpu()).abs().argmax()
    )
    log(f"  (for the record) {label} RE chained on each sweep's own FE: max abs diff "
        f"coefficients {coef:.3e}, loss {loss:.3e} (entity row {worst}, loss "
        f"{float(a.solver_results['per-user'].loss[worst]):.4f})")


def retrain_re(coords, res_a, coords_b):
    """coords_b's random effect retrained on res_a's fixed-effect scores
    (in one sweep, the random effect's whole residual)."""
    fe_scores = coords["global"].score(res_a.model["global"])
    dev = coords_b["per-user"].dataset.device
    return coords_b["per-user"].train(fe_scores.to(dev), None)


def device_profile(torch, fn):
    """``fn()`` under torch.profiler: its result and the device's own events
    (kernels, copies, memsets) as (device us, count, name) rows; the
    operators that launched them carry the same device time again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return out, sorted(rows, reverse=True)


def log_profile(what, wall, rows, top=12):
    """Prints the busy share of ``wall`` and the top device operations;
    returns the device's busy seconds."""
    busy = sum(r[0] for r in rows) * 1e-6
    log(f"  {what}: wall_s={wall:.4f} device_busy_s={busy:.4f} busy_share={busy / wall:.3f} "
        f"idle_share={1 - busy / wall:.3f} device_ops={sum(r[1] for r in rows)}")
    for us, count, key in rows[:top]:
        log(f"    {us * 1e-3:9.3f} ms  x{count:6d}  {key[:90]}")
    return busy


def profile_sweep(torch, coords):
    """One more sweep under torch.profiler: the device's busy share of the
    sweep's wall and the device operations that fill it."""
    (_, wall), rows = device_profile(torch, lambda: sweep(torch, coords))
    log_profile("profiled sweep", wall, rows)


def glmix_path(torch, n, d, users, d_re, seed):
    from photon_ml_tpu_torch.ops import fused_glm as fg

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_data(n, d, users, d_re, seed)
    coords = glmix_coordinates(data, dev)
    re_ds = coords["per-user"].dataset
    E, K, S = re_ds.blocks.features.shape
    from photon_ml_tpu_torch.game.coordinate import _size_buckets

    buckets = _size_buckets(re_ds)
    log(f"  data + datasets built in {time.perf_counter() - t0:.1f}s: n={n} d={d} users={users} "
        f"d_re={d_re}; RE blocks E={E} K={K} S={S}, buckets (start, end, K, S) {buckets}")

    # an untimed first sweep loads PyTorch's lazily loaded kernels; then
    # SWEEPS timed sweeps, each a fresh CoordinateDescent run (the median
    # is reported: the sweep is launch-bound, so its host-clock wall moves
    # with the host's load)
    sweep(torch, coords)
    fg.reset_launch_counts()
    runs = sorted((sweep(torch, coords) for _ in range(SWEEPS)), key=lambda rw: rw[1])
    launches, routes = dict(fg.LAUNCHES), dict(fg.ROUTES)
    res, wall = runs[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    fe_r, re_r = res.solver_results["global"], res.solver_results["per-user"]
    log(f"  GLMix sweep (kernels), median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) "
        f"shares FE={res.seconds['global'] / wall:.3f} RE={res.seconds['per-user'] / wall:.3f} "
        f"syncs={res.syncs} launches={launches} by body {routes} train_auc={a:.6f}")
    log(f"  FE: iterations={fe_r.iterations} reason={fe_r.reason} loss={float(fe_r.loss):.6f}; "
        f"RE: lanes={int(re_r.loss.shape[0])} max_iterations={int(re_r.iterations.max())} "
        f"reasons={torch.bincount(re_r.reason.cpu().long(), minlength=6).tolist()} "
        f"loss_sum={float(re_r.loss.sum()):.4f}")
    problems = []
    if min(launches.values()) <= 0:
        problems.append(f"a kernel of the GLMix sweep was not launched: {launches}")
    if routes["ring_bulk_copy"] != launches["fused_value_grad"] + launches["fused_hessian_vector"]:
        problems.append(f"B1/B2 did not all run the ring body's bulk-copy route: {routes}")
    if launches["fused_hessian_stats"] != SWEEPS:
        problems.append(
            f"B3 launched {launches['fused_hessian_stats']} times for {SWEEPS} fixed-effect solves"
        )
    var = res.model["global"].coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) or not bool((var > 0).all()):
        problems.append("SIMPLE variances missing, non-finite or not positive")
    if not (0.5 < a <= 1.0):
        problems.append(f"training AUC {a} out of (0.5, 1]")
    if res.rejections != {"global": 0, "per-user": 0}:
        problems.append(f"the divergence guard rejected an update: {res.rejections}")
    profile_sweep(torch, coords)

    # the same sweep with the plain versions forced
    plain = dict(coords, **{"global": dataclasses.replace(coords["global"], plain=True)})
    fg.reset_launch_counts()
    res_p, wall_p = sweep(torch, plain)
    log(f"  GLMix sweep (plain): wall_s={wall_p:.4f} examples_per_s={n / wall_p:.1f} "
        f"shares FE={res_p.seconds['global'] / wall_p:.3f} RE={res_p.seconds['per-user'] / wall_p:.3f} "
        f"syncs={res_p.syncs} launches={dict(fg.LAUNCHES)}")
    if any(fg.LAUNCHES.values()):
        problems.append("the plain sweep launched a kernel")
    hold_sweeps(problems, "kernel vs plain sweep:", res, res_p, retrain_re(coords, res, plain))
    del plain, res_p

    # a small sweep on the card and on the CPU
    small = build_data(20_000, 64, 300, 8, seed + 1)
    c_card = glmix_coordinates(small, dev)
    c_cpu = glmix_coordinates(small, torch.device("cpu"))
    r_card, _ = sweep(torch, c_card)
    r_cpu, _ = sweep(torch, c_cpu)
    hold_sweeps(problems, "small sweep card vs CPU:", r_card, r_cpu, retrain_re(c_card, r_card, c_cpu))
    if problems:
        raise AssertionError("; ".join(problems))
    return {
        "launches": launches, "routes": routes, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
        "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
        "syncs": res.syncs, "train_auc": a,
        # for the data-parallel phase: the data, the one-card coordinates and
        # the median sweep's result
        "state": {"data": data, "coords": coords, "result": res, "wall_s": wall},
    }


# ------------------------------------------------- phase 6: data parallel
#
# The rank bodies below run in processes that photon_ml_tpu_torch.parallel.
# spawn starts: each imports this file as a module, so they must stay at
# module level, import what they need themselves and return CPU tensors.


def _b4_inputs(torch, n, d, xname, seed, dev):
    """The B4 check's inputs, the same in every process on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 7919 + n * 3 + (xname == "bfloat16"))
    return make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)


def _b4_calls(fg, group, x, coef, v, y, off, wt, vshift, loss):
    """B4's three functions as the main path calls them (the Hessian
    statistics without and with shifts): name -> a call."""
    return {
        "sharded_value_grad": lambda: fg.sharded_value_grad(group, x, coef, y, off, wt, loss),
        "sharded_hessian_vector": lambda: fg.sharded_hessian_vector(group, x, coef, v, y, off, wt, vshift, loss),
        "sharded_hessian_stats": lambda: fg.sharded_hessian_stats(group, x, coef, y, off, wt, loss, False),
        "sharded_hessian_stats_shifts": lambda: fg.sharded_hessian_stats(group, x, coef, y, off, wt, loss, True),
    }


def _b4_kernels(fg, x, coef, v, y, off, wt, vshift, loss):
    """The rank's unsharded kernel of each of ``_b4_calls``: name -> (mode,
    a call)."""
    return {
        "sharded_value_grad": (fg.VG, lambda: fg.fused_value_grad(x, coef, y, off, wt, loss)),
        "sharded_hessian_vector": (fg.HV, lambda: fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)),
        "sharded_hessian_stats": (fg.HD, lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, False)),
        "sharded_hessian_stats_shifts": (fg.HD_SHIFTS, lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, True)),
    }


def _all_reduce_slot_sum(torch, group, flat):
    """The previous design's collective, kept here to time it in turns with the
    redesign:
    a device synchronize, the rank's float64 row in a zero [world, width]
    buffer (on the host for gloo), one all_reduce(SUM), the rows added in
    rank order, the sum back on the device, a synchronize."""
    import torch.distributed as dist

    dev = flat.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host = torch.device("cpu") if group.backend == "gloo" else dev
    buf = torch.zeros((group.world_size, flat.numel()), dtype=torch.float64, device=host)
    buf[group.rank] = flat.to(host)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.process_group)
    acc = buf[0]
    for r in range(1, group.world_size):
        acc = acc + buf[r]
    acc = acc.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return acc


def _all_reduce_b4(torch, group, outs):
    """The previous design's B4 around the rank's unsharded outputs: widened
    to float64 and concatenated, ``_all_reduce_slot_sum``, split and cast back."""
    parts = [o for o in outs if o is not None]
    total = _all_reduce_slot_sum(torch, group, torch.cat([o.reshape(-1).to(torch.float64) for o in parts]))
    summed, at = [], 0
    for o in parts:
        summed.append(total[at : at + o.numel()].reshape(o.shape).to(o.dtype))
        at += o.numel()
    it = iter(summed)
    return tuple(None if o is None else next(it) for o in outs)


def _host_ms(torch, group, fn, reps):
    """Per-call host milliseconds of ``fn`` on every rank at once: the loop
    starts after a barrier and ends in a device synchronize, so the clock
    holds every call's device work."""
    sync = torch.cuda.synchronize if group.device.type == "cuda" else (lambda _: None)
    for _ in range(3):
        fn()
    sync(group.device)
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(group.device)
    return (time.perf_counter() - t0) / reps * 1e3


def _b4_times(torch, fg, group, d, calls, kernels, reps=20):
    """Each B4 function on the rank's shard (``d`` columns), ms per call
    (``_host_ms``): the call in turns with the all-reduce path (prev, new, new,
    prev); its collective alone, the all-gather of the cached slot buffer
    and the previous design's all-reduce path; the rank's kernel alone; and the
    collective's own time per call as ``collective_seconds`` reads it (CUDA
    events over NCCL, the host clock between synchronizes over gloo) over
    ``reps`` calls."""
    out = {}
    for name, call in calls.items():
        mode, kernel = kernels[name]
        prev = lambda kernel=kernel: _all_reduce_b4(torch, group, kernel())  # noqa: E731
        runs = [_host_ms(torch, group, f, reps) for f in (prev, call, call, prev)]
        width = fg._out_width(mode, d)
        slots = group.slot_buffer(width, group.device)
        flat = torch.zeros(width, dtype=torch.float64, device=group.device)
        c0 = (group.collectives, group.collective_seconds)
        for _ in range(reps):
            call()
        c1 = (group.collectives, group.collective_seconds)
        out[name] = {
            "ms": min(runs[1:3]), "ms_runs": runs[1:3],
            "prev_ms": min(runs[0], runs[3]), "prev_ms_runs": [runs[0], runs[3]],
            "collective_ms": _host_ms(torch, group, lambda: group.gather_slots(slots), reps),
            "prev_collective_ms": _host_ms(torch, group, lambda: _all_reduce_slot_sum(torch, group, flat), reps),
            "kernel_ms": _host_ms(torch, group, kernel, reps),
            "collective_own_ms": (c1[1] - c0[1]) / max(c1[0] - c0[0], 1) * 1e3,
            "collectives_per_call": (c1[0] - c0[0]) / reps,
        }
    return out


def _same_as_prev(torch, group, calls, kernels):
    """Whether each B4 function gives bitwise the all-reduce path's outputs on this rank."""
    same = {}
    for name, call in calls.items():
        new, old = call(), _all_reduce_b4(torch, group, kernels[name][1]())
        same[name] = all(_same_bits(a, b) for a, b in zip(new, old))
    return same


def _staging_ms(torch, group, width):
    """The collective's parts alone, every rank at once (ms per call): the
    all-gather of the [world, width] float64 slot buffer where it lies
    (host for gloo), the previous design's all-reduce of the same buffer and of one element
    (the latency alone), a device synchronize, and (gloo) the copies of a
    width-wide float64 row to the host and of the buffer back."""
    import torch.distributed as dist

    host = group.device if group.backend == "nccl" else torch.device("cpu")
    buf = group.slot_buffer(width, host)
    zeros = torch.zeros((group.world_size, width), dtype=torch.float64, device=host)
    row = torch.zeros(width, dtype=torch.float64, device=group.device)
    one = torch.zeros(1, dtype=torch.float64, device=host)
    out = {
        "all_gather": _host_ms(torch, group, lambda: group._all_gather(buf), 20),
        "all_reduce": _host_ms(torch, group, lambda: dist.all_reduce(zeros), 20),
        "all_reduce_one_element": _host_ms(torch, group, lambda: dist.all_reduce(one), 20),
    }
    if group.device.type == "cuda":
        out["synchronize"] = _host_ms(torch, group, lambda: torch.cuda.synchronize(group.device), 20)
    if group.backend == "gloo" and group.device.type == "cuda":
        out["to_host"] = _host_ms(torch, group, lambda: row.to("cpu"), 20)
        out["to_device"] = _host_ms(torch, group, lambda: buf.to(group.device), 20)
    return out


def _host_syncs(torch, calls):
    """Each call once with CUDA's sync debug mode at "error" and
    torch.cuda.synchronize counting its calls: (synchronizes, the calls that
    raised for a synchronizing CUDA operation)."""
    real, count, raised = torch.cuda.synchronize, [0], []

    def counting(*a, **k):
        count[0] += 1
        return real(*a, **k)

    torch.cuda.synchronize = counting
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as e:  # the debug mode's error, reported as a check
                raised.append(f"{name}: {str(e).splitlines()[0]}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = real
    return count[0], raised


def _device_ops(torch, call):
    """The device operations of one call under torch.profiler: (name,
    count) pairs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def dp_b4_rank(group, n, d, seed):
    """Phase 6 (a), on one rank: B4 on the rank's rows of each case, bitwise
    against the all-reduce path on the same rows, and at n rows the times of
    ``_b4_times``."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.parallel import row_range

    dev, loss = group.device, LOSSES["logistic"]
    outs, times, same = {}, {}, {}
    for xname in ("float32", "bfloat16"):
        for nn in (n, n - 1):
            x, coef, v, y, off, wt, vshift = _b4_inputs(torch, nn, d, xname, seed, dev)
            start, stop = row_range(nn, group)
            share = -(-nn // group.world_size)
            pad = lambda a: torch.cat([a[start:stop], a.new_zeros((share - (stop - start),) + a.shape[1:])])  # noqa: E731
            xs, ys, offs, wts = pad(x), pad(y), pad(off), pad(wt)
            del x
            torch.cuda.empty_cache()
            operands = (xs, coef, v, ys, offs, wts, vshift, loss)
            calls, kernels = _b4_calls(fg, group, *operands), _b4_kernels(fg, *operands)
            outs[(nn, xname)] = {
                name: tuple(None if o is None else o.cpu() for o in call()) for name, call in calls.items()
            }
            same[(nn, xname)] = _same_as_prev(torch, group, calls, kernels)
            if nn == n:
                times[xname] = _b4_times(torch, fg, group, d, calls, kernels)
                if xname == "float32":
                    times[xname]["staging"] = _staging_ms(torch, group, fg._out_width(fg.VG, d))
            del xs
            torch.cuda.empty_cache()
    return {"outs": outs, "times": times, "same_as_prev": same, "device": str(dev), "backend": group.backend}


def dp_sweep_rank(group, data_dir, sweeps):
    """Phase 6 (b) and (c), on one rank: the GLMix sweep over sharded
    datasets built from the parent's files, one untimed sweep and
    ``sweeps`` timed ones. Returns the rank's walls, per-coordinate seconds,
    syncs and collectives, launch counts, its random-effect solve (entities,
    bucket shape, padded and real cells), B4's times on its rows
    (``_b4_times``) and whether B4 gives the all-reduce path's bits there; over NCCL also
    the host synchronizes of one call of each B4 function and the device
    operations of one value+grad call; and from rank 0 the model, the random
    effect's per-entity loss and the fixed effect's scores."""
    import torch

    from photon_ml_tpu_torch.evaluation.device import auc
    from photon_ml_tpu_torch.game.coordinate import _size_buckets
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.parallel import entity_range

    t0 = time.perf_counter()
    gx = np.load(f"{data_dir}/gx.npy", mmap_mode="r")
    y, ex = np.load(f"{data_dir}/y.npy"), np.load(f"{data_dir}/ex.npy")
    ids = np.load(f"{data_dir}/ids.npy").astype(object)
    n = gx.shape[0]
    coords = glmix_coordinates((gx, y, ex, ids), group.device, group=group)
    del gx
    build_s = time.perf_counter() - t0
    re_ds = coords["per-user"].dataset
    E = re_ds.num_entities
    lo, hi = entity_range(E, group)
    e_local = hi - lo
    segs = _size_buckets(re_ds, align=e_local if group.world_size > 1 else 1) or [(0, E, None, None)]
    mine = [(s, e, kb, sb) for s, e, kb, sb in segs if s < hi and lo < e]
    _, K, S = re_ds.blocks.features.shape
    counts, sdims = re_ds.entity_counts[lo:hi], re_ds.entity_subspace_dims[lo:hi]
    padded = sum((min(e, hi) - max(s, lo)) * (kb or K) * (sb or S) for s, e, kb, sb in mine)

    sweep(torch, coords)  # loads PyTorch's lazily loaded kernels
    fg.reset_launch_counts()
    runs = [sweep(torch, coords) for _ in range(sweeps)]
    launches, sharded, sums = dict(fg.LAUNCHES), dict(fg.SHARDED_LAUNCHES), dict(fg.SUM_LAUNCHES)
    res = sorted(runs, key=lambda rw: rw[1])[len(runs) // 2][0]
    out = {
        "rank": group.rank, "world": group.world_size, "backend": group.backend,
        "device": str(group.device), "build_s": build_s,
        "walls": [w for _, w in runs], "seconds": dict(res.seconds), "syncs": dict(res.syncs),
        "collectives": dict(res.collectives), "collective_s": dict(res.collective_seconds),
        "launches": launches, "sharded": sharded, "sums": sums,
        "re": {
            "entities": (lo, hi), "buckets": [(kb, sb) for _, _, kb, sb in mine],
            "padded_cells": int(padded), "real_cells": int(np.sum(counts * sdims)),
            "rows": int(np.sum(counts)),
        },
        "rejections": dict(res.rejections),
    }
    # B4 as the sweep calls it, on this rank's rows (every rank at once),
    # after the launch counts were read
    from photon_ml_tpu_torch.ops.losses import LOSSES

    b = coords["global"].dataset.batch
    x = b.features.dense
    coef = res.model["global"].coefficients.means.to(x.device)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(17)
    v = torch.randn(x.shape[1], generator=gen, device=x.device)
    operands = (x, coef, v, b.labels, b.offsets, b.weights, torch.tensor(0.1, device=x.device), LOSSES["logistic"])
    calls, kernels = _b4_calls(fg, group, *operands), _b4_kernels(fg, *operands)
    out["b4_same_as_prev"] = _same_as_prev(torch, group, calls, kernels)
    out["b4"] = _b4_times(torch, fg, group, x.shape[1], calls, kernels)
    if group.backend == "nccl":
        torch.cuda.synchronize()
        out["b4_host_syncs"], out["b4_sync_errors"] = _host_syncs(torch, calls)
        out["b4_device_ops"] = _device_ops(torch, calls["sharded_value_grad"])
    # scoring the fixed effect gathers across the ranks: every rank scores
    fe_scores = coords["global"].score(res.model["global"])
    re_scores = coords["per-user"].score(res.model["per-user"])
    if group.rank == 0:
        fe = res.model["global"].coefficients
        ones = torch.ones_like(fe_scores)
        yt = torch.as_tensor(y, device=fe_scores.device)
        out.update(
            fe_means=fe.means.cpu(), fe_variances=fe.variances.cpu(), fe_scores=fe_scores.cpu(),
            fe_iterations=res.solver_results["global"].iterations,
            re_values=res.model["per-user"].coef_values.cpu(),
            re_loss=res.solver_results["per-user"].loss.cpu(),
            train_auc=float(auc(fe_scores + re_scores, yt, ones)),
        )
    return out


def _ref_b4(torch, fg, x, coef, v, y, off, wt, vshift, loss):
    """The float64 plain versions on the whole batch, in B4's output form."""
    f64 = torch.float64
    return {
        "sharded_value_grad": fg.value_grad_plain(x, coef, y, off, wt, loss, compute_dtype=f64),
        "sharded_hessian_vector": fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss, compute_dtype=f64),
        "sharded_hessian_stats": fg.hessian_stats_plain(x, coef, y, off, wt, loss, False, compute_dtype=f64),
        "sharded_hessian_stats_shifts": fg.hessian_stats_plain(x, coef, y, off, wt, loss, True, compute_dtype=f64),
    }


def _b4_errors(torch, got, ref):
    """(ok, {name: (vector err, bound, scalar rel err)}) at phase 3's bounds:
    the value and s0 rtol 2e-6; the vectors with their scalar sums max-abs
    <= 3e-5 * max(|ref|, 1)."""
    report, ok = {}, True
    for name, r in ref.items():
        g = got[name]
        if name == "sharded_value_grad":
            vec_g, vec_r = torch.cat([g[1].double(), g[2].double().reshape(1)]), torch.cat([r[1], r[2].reshape(1)])
            scal = (float(g[0]), float(r[0]))
        elif name == "sharded_hessian_vector":
            vec_g, vec_r = torch.cat([g[0].double(), g[1].double().reshape(1)]), torch.cat([r[0], r[1].reshape(1)])
            scal = None
        elif name == "sharded_hessian_stats":
            vec_g, vec_r, scal = g[0].double(), r[0], None
        else:
            vec_g, vec_r = torch.cat([g[0].double(), g[1].double()]), torch.cat([r[0], r[1]])
            scal = (float(g[2]), float(r[2]))
        vec_r = vec_r.cpu()
        err = float((vec_g - vec_r).abs().max())
        bound = 3e-5 * max(float(vec_r.abs().max()), 1.0)
        rel = abs(scal[0] - scal[1]) / max(abs(scal[1]), 1e-30) if scal else 0.0
        finite = all(bool(torch.isfinite(o).all()) for o in g if o is not None)
        good = finite and err <= bound and rel <= 2e-6
        ok &= good
        report[name] = (err, bound, rel, good)
    return ok, report


def _same_bits(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8)
    )


def log_b4_time(where, name, t, worst):
    """One line of B4's times (``_b4_times``) on rank 0."""
    log(f"  time B4 {where} {name:28s} {t['ms']:.4f} ms/call on rank 0 (runs "
        f"{'/'.join(f'{u:.4f}' for u in t['ms_runs'])}; slowest rank {worst:.4f}); the all-reduce path "
        f"{t['prev_ms']:.4f} ({'/'.join(f'{u:.4f}' for u in t['prev_ms_runs'])}); collective alone "
        f"{t['collective_ms']:.4f} (all-reduce path {t['prev_collective_ms']:.4f}); its own time in the call "
        f"{t['collective_own_ms']:.4f} ({t['collectives_per_call']:.0f} a call); rank's kernel alone "
        f"{t['kernel_ms']:.4f}; call - kernel {t['ms'] - t['kernel_ms']:+.4f}")


def launch_problems(ranks, backend):
    """Every rank launched each kernel of the data-parallel sweep, and one
    rank-order sum per B4 call whose rank launched its kernel."""
    problems = []
    for r in ranks:
        if min(r["sharded"].values()) <= 0 or min(r["launches"].values()) <= 0:
            problems.append(f"{backend} rank {r['rank']}: a kernel of the data-parallel sweep was not launched")
        if r["sums"]["rank_order_sum"] != sum(r["sharded"].values()):
            problems.append(f"{backend} rank {r['rank']}: {r['sums']} rank-order sums for B4 calls {r['sharded']}")
    return problems


def dp_path(torch, n, d, seed, state, device="cuda", gloo=True):
    """Phase 6: the data-parallel GLMix sweep; (a), (b), (c) as in the
    module docstring (``gloo=False``: (c) alone). ``device="cpu"``
    rehearses (a) and (b) on the CPU at a small size (the plain versions,
    no nccl)."""
    import tempfile

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.parallel import spawn

    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_lib.load("fused_glm")  # built here, so that no two ranks run nvcc
    problems = []
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        if gloo:
            # (a) B4 against the float64 plain versions on the whole batch
            t0 = time.perf_counter()
            ranks = spawn(dp_b4_rank, DP_RANKS, "gloo", device, args=(n, d, seed),
                          timeout_s=DP_TIMEOUT_S, store_dir=tmp)
            log(f"  (a) B4 on {DP_RANKS} gloo ranks on {ranks[0]['device']} "
                f"(backend {ranks[0]['backend']}, world {DP_RANKS}): ranks done in {time.perf_counter() - t0:.1f}s")
            errs = {}
            for (nn, xname), got in ranks[0]["outs"].items():
                x, coef, v, y, off, wt, vshift = _b4_inputs(torch, nn, d, xname, seed, dev)
                ref = _ref_b4(torch, fg, x, coef, v, y, off, wt, vshift, LOSSES["logistic"])
                del x
                torch.cuda.empty_cache()
                ok, rep = _b4_errors(torch, got, ref)
                same = all(
                    _same_bits(a, b)
                    for r in ranks[1:] for name in got for a, b in zip(r["outs"][(nn, xname)][name], got[name])
                )
                for name, (err, bound, rel, good) in rep.items():
                    log(f"  check B4 gloo world={DP_RANKS} n={nn} d={d} {xname:8s} {name:28s} "
                        f"err={err:.3e}/{bound:.3e} scalar_rel={rel:.2e} {'ok' if good else 'MISS'}")
                prev = all(all(r["same_as_prev"][(nn, xname)].values()) for r in ranks)
                log(f"  B4 gloo world={DP_RANKS} n={nn} {xname}: every rank bitwise alike: {same}; "
                    f"every rank bitwise the all-reduce path: {prev}")
                if not (ok and same and prev):
                    problems.append(f"B4 n={nn} {xname}: bounds ok {ok}, ranks alike {same}, the all-reduce path's bits {prev}")
                if (nn, xname) == (n, "float32"):
                    errs = {name: rep[name][0] for name in B4_OF}
            times = {}
            for xname, row in ranks[0]["times"].items():
                for name, t in row.items():
                    if name == "staging":
                        continue
                    worst = max(r["times"][xname][name]["ms"] for r in ranks)
                    log_b4_time(f"gloo world={DP_RANKS} {xname:8s}", name, t, worst)
                times[xname] = row
            st = ranks[0]["times"]["float32"]["staging"]
            log(f"  the collective's parts alone, ms per call on rank 0 of {DP_RANKS} (gloo): "
                + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
            report["b4"] = {"errors": errs, "times": times}
            del ranks

        # the sweep's data for (b) and (c), and phase 5's one-card sweep
        gx, y, ex, ids = state["data"]
        t0 = time.perf_counter()
        np.save(f"{tmp}/gx.npy", gx)
        np.save(f"{tmp}/y.npy", y)
        np.save(f"{tmp}/ex.npy", ex)
        np.save(f"{tmp}/ids.npy", np.asarray(ids, dtype=str))
        log(f"  wrote the sweep's data for the ranks in {time.perf_counter() - t0:.1f}s")
        one, coords = state["result"], state["coords"]
        f1 = one.model["global"].coefficients
        if gloo:
            # (b) the 4-rank sweep against phase 5's one-card sweep
            t0 = time.perf_counter()
            ranks = spawn(dp_sweep_rank, DP_RANKS, "gloo", device, args=(tmp, SWEEPS),
                          timeout_s=DP_TIMEOUT_S, store_dir=tmp)
            log(f"  (b) sweep on {DP_RANKS} gloo ranks: ranks done in {time.perf_counter() - t0:.1f}s "
                f"(builds {', '.join(f'{r['build_s']:.1f}' for r in ranks)} s)")
            r0 = ranks[0]
            walls = sorted(r0["walls"])
            wall = walls[len(walls) // 2]
            log(f"  data-parallel sweep (backend gloo, world {DP_RANKS}, one card), median of {SWEEPS}: "
                f"wall_s={wall:.4f} examples_per_s={n / wall:.1f} (walls {', '.join(f'{w:.4f}' for w in r0['walls'])}) "
                f"shares FE={r0['seconds']['global'] / wall:.3f} RE={r0['seconds']['per-user'] / wall:.3f} "
                f"train_auc={r0['train_auc']:.6f}")
            for r in ranks:
                log(f"    rank {r['rank']} of {r['world']} ({r['backend']}): RE wall {r['seconds']['per-user']:.4f} s, FE {r['seconds']['global']:.4f} s; "
                    f"entities {r['re']['entities']} buckets (K, S) {r['re']['buckets']} "
                    f"padded cells {r['re']['padded_cells']} real cells {r['re']['real_cells']} rows {r['re']['rows']}; "
                    f"syncs {r['syncs']} collectives {r['collectives']} "
                    f"collective_s {{{', '.join(f'{k}: {v:.4f}' for k, v in r['collective_s'].items())}}}; "
                    f"launches {r['launches']} {r['sharded']} {r['sums']}")
            for name, t in r0["b4"].items():
                log_b4_time(f"gloo world={DP_RANKS} sweep rows", name, t, max(r["b4"][name]["ms"] for r in ranks))
            if any(r["rejections"] != {"global": 0, "per-user": 0} for r in ranks):
                problems.append("the divergence guard rejected an update on a rank")
            problems += launch_problems(ranks, "gloo")
            for r in ranks:
                if not all(r["b4_same_as_prev"].values()):
                    problems.append(f"gloo rank {r['rank']}: B4 differs from the all-reduce path {r['b4_same_as_prev']}")
            if not (0.5 < r0["train_auc"] <= 1.0):
                problems.append(f"data-parallel training AUC {r0['train_auc']} out of (0.5, 1]")
            hold(problems, "4 ranks vs one card: FE coefficients", r0["fe_means"], f1.means, 1e-3, 1e-5)
            hold(problems, "4 ranks vs one card: FE variances", r0["fe_variances"], f1.variances, 1e-3, 1e-5)
            E1 = one.model["per-user"].coef_values.shape[0]
            re1, res1 = coords["per-user"].train(r0["fe_scores"].to(dev), None)
            hold(problems, "4 ranks vs one card: RE coefficients (identical residuals)",
                 r0["re_values"][:E1], re1.coef_values, 0.0, 5e-3)
            hold(problems, "4 ranks vs one card: RE loss (identical residuals)",
                 r0["re_loss"][:E1], res1.loss, 0.0, 1e-4)
            _, coef = allclose(r0["re_values"][:E1], one.model["per-user"].coef_values, 0.0, 5e-3)
            _, loss = allclose(r0["re_loss"][:E1], one.solver_results["per-user"].loss, 0.0, 1e-4)
            log(f"  (for the record) RE chained on each sweep's own FE: max abs diff coefficients "
                f"{coef:.3e}, loss {loss:.3e}")
            report["sweep"] = {
                "wall_s": wall, "walls": r0["walls"], "examples_per_s": n / wall,
                "fe_share": r0["seconds"]["global"] / wall, "re_share": r0["seconds"]["per-user"] / wall,
                "re_walls": [r["seconds"]["per-user"] for r in ranks],
                "sharded": [r["sharded"] for r in ranks], "launches": [r["launches"] for r in ranks],
                "collectives": r0["collectives"], "syncs": r0["syncs"], "b4": r0["b4"],
                "sums": [r["sums"] for r in ranks],
            }
            del ranks

        # (c) NCCL, one rank per card
        if dev.type != "cuda":
            if problems:
                raise AssertionError("; ".join(problems))
            return report
        world = torch.cuda.device_count()
        t0 = time.perf_counter()
        ranks = spawn(dp_sweep_rank, world, "nccl", "cuda", args=(tmp, SWEEPS),
                      timeout_s=DP_TIMEOUT_S, store_dir=tmp)
        r0 = ranks[0]
        walls = sorted(r0["walls"])
        wall = walls[len(walls) // 2]
        log(f"  (c) sweep over nccl (backend nccl, world {world}, one rank per card), median of {SWEEPS}: "
            f"wall_s={wall:.4f} examples_per_s={n / wall:.1f} (walls {', '.join(f'{w:.4f}' for w in r0['walls'])}); "
            f"one card in phase 5: median wall_s={state['wall_s']:.4f}, the nccl sweep {wall / state['wall_s']:.3f}x it; "
            f"ranks done in {time.perf_counter() - t0:.1f}s; shares FE={r0['seconds']['global'] / wall:.3f} "
            f"RE={r0['seconds']['per-user'] / wall:.3f}; syncs {r0['syncs']} collectives {r0['collectives']} "
            f"collective_s {{{', '.join(f'{k}: {v:.6f}' for k, v in r0['collective_s'].items())}}}; "
            f"launches {r0['launches']} {r0['sharded']} {r0['sums']}")
        for name, t in r0["b4"].items():
            log_b4_time(f"nccl world={world}", name, t, max(r["b4"][name]["ms"] for r in ranks))
        log(f"  nccl B4: host synchronizes in one call of each function: {r0['b4_host_syncs']} "
            f"(sync debug errors: {r0['b4_sync_errors'] or 'none'}); bitwise the all-reduce path: {r0['b4_same_as_prev']}; "
            f"device operations of one value+grad call: {r0['b4_device_ops']}")
        problems += launch_problems(ranks, "nccl")
        for r in ranks:
            if r["b4_host_syncs"] or r["b4_sync_errors"]:
                problems.append(f"nccl rank {r['rank']}: a B4 call synchronized the host "
                                f"({r['b4_host_syncs']} synchronizes, {r['b4_sync_errors']})")
            if not all(r["b4_same_as_prev"].values()):
                problems.append(f"nccl rank {r['rank']}: B4 differs from the all-reduce path {r['b4_same_as_prev']}")
        if world == 1:
            for what, a, b in (("coefficients", r0["fe_means"], f1.means.cpu()),
                               ("variances", r0["fe_variances"], f1.variances.cpu())):
                same = _same_bits(a, b)
                log(f"  nccl world 1 vs one card: FE {what} bitwise equal: {same}")
                if not same:
                    problems.append(f"nccl world 1: FE {what} differ from the one-card sweep")
        else:
            hold(problems, f"nccl world {world} vs one card: FE coefficients", r0["fe_means"], f1.means, 1e-3, 1e-5)
            hold(problems, f"nccl world {world} vs one card: FE variances", r0["fe_variances"], f1.variances, 1e-3, 1e-5)
        report["nccl"] = {
            "world": world, "wall_s": wall, "walls": r0["walls"], "one_card_wall_s": state["wall_s"],
            "sharded": r0["sharded"], "sums": r0["sums"], "launches": r0["launches"], "b4": r0["b4"],
            "host_syncs": r0["b4_host_syncs"], "device_ops": r0["b4_device_ops"],
        }
    if problems:
        raise AssertionError("; ".join(problems))
    return report


def time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of ``reps``
    calls, between CUDA events: a step as short as the finalize (a few us)
    would otherwise measure the host's launch time (~50 us a call). Three
    replays after a warm one; the lowest."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del g
    return best


def timings(torch, n, d, seed):
    """Per-call times at the main path's shape; the X of the main path is 2 GB
    (f32), far above the 50 MB L2, so every call reads it from device memory.
    B1 and B2 are timed in turns with the previous design (the staged body
    and the serial finalize: prev, new, new, prev), each body's main kernel
    and finalize alone, the ring's plain-load route on the same aligned X,
    and torch.mv(X, coef), the time to read X once (a yardstick, not a
    library call: it computes another function)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    out = {}
    loss = LOSSES["logistic"]
    for xname in ("float32", "bfloat16"):
        gen.manual_seed(seed + 7)
        x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)
        saved, saved_routes = dict(fg.LAUNCHES), dict(fg.ROUTES)
        row = {}
        cx = coef.to(x.dtype)
        read_a = time_ms(torch, lambda: torch.mv(x, cx), 20)
        for name, kern, plain, mode, operands in (
            ("fused_value_grad",
             lambda: fg.fused_value_grad(x, coef, y, off, wt, loss),
             lambda: fg.value_grad_plain(x, coef, y, off, wt, loss), fg.VG,
             (x, coef, None, y, off, wt, None, loss)),
            ("fused_hessian_vector",
             lambda: fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss),
             lambda: fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss), fg.HV,
             (x, coef, v, y, off, wt, vshift, loss)),
            # as the main path calls it: no normalization, so no shifts
            ("fused_hessian_stats",
             lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, False),
             lambda: fg.hessian_stats_plain(x, coef, y, off, wt, loss, False), fg.HD,
             (x, coef, None, y, off, wt, None, loss)),
        ):
            launch = lambda **kw: fg._launch(mode, *operands, **kw)  # noqa: E731
            prev = lambda: launch(body=fg.STAGED, finalize=fg.FINALIZE_SERIAL)  # noqa: E731
            plain_a = time_ms(torch, plain, 10)
            prev_a = time_ms(torch, prev, 20)
            ms_a = time_ms(torch, kern, 20)
            ms_b = time_ms(torch, kern, 20)
            prev_b = time_ms(torch, prev, 20)
            plain_b = time_ms(torch, plain, 10)
            main_ms = graph_ms(torch, lambda: launch(steps=fg.STEP_MAIN), 10)
            fin_ms = graph_ms(torch, lambda: launch(steps=fg.STEP_FINALIZE), 20)
            prev_main = graph_ms(torch, lambda: launch(body=fg.STAGED, steps=fg.STEP_MAIN), 10)
            prev_fin = graph_ms(
                torch, lambda: launch(body=fg.STAGED, finalize=fg.FINALIZE_SERIAL, steps=fg.STEP_FINALIZE), 20
            )
            nbytes = fg.sweep_bytes(n, d, x.dtype, mode)
            ops = fg.sweep_flops(n, d, mode)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[xname] * 1e3
            plan = fg.plan_of(x, mode)
            ms = min(ms_a, ms_b)
            row[name] = {
                "ms": ms, "ms_runs": [ms_a, ms_b],
                "plain_ms": min(plain_a, plain_b), "plain_ms_runs": [plain_a, plain_b],
                "prev_ms": min(prev_a, prev_b), "prev_ms_runs": [prev_a, prev_b],
                "main_ms": main_ms, "finalize_ms": fin_ms,
                "prev_main_ms": prev_main, "prev_finalize_ms": prev_fin,
                "read_x_ms": read_a,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops, "plan": plan,
            }
            log(f"  time {xname:8s} {name:22s} kernel {ms_a:.4f}/{ms_b:.4f} ms "
                f"(graph-timed: main {main_ms:.4f} + finalize {fin_ms:.4f}; {plan['body']} body, route {plan['route']}, "
                f"grid {plan['grid']}, {plan['blocks_per_sm']} blocks/SM, {plan['rows_per_tile']} rows/tile, "
                f"{plan['stages']} stages, {plan['smem_bytes']} B smem)  "
                f"previous design {prev_a:.4f}/{prev_b:.4f} ms (graph-timed: main {prev_main:.4f} + serial finalize {prev_fin:.4f})  "
                + f"plain(unfused composition) {plain_a:.4f}/{plain_b:.4f} ms  read X once (torch.mv) {read_a:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms ({row[name]['bound_by']}, {nbytes} B)  "
                f"achieved {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s ({max(t_bytes, t_ops) / ms:.1%} of the bound)")
        fg.LAUNCHES.update(saved)  # timing launches are not main-path launches
        fg.ROUTES.update(saved_routes)
        out[xname] = row
        del x
        torch.cuda.empty_cache()
    out["rank_order_sum"] = time_rank_order_sum(torch, d, seed)
    return out


def time_rank_order_sum(torch, d, seed):
    """The rank-order sum at the data-parallel path's shapes (value+grad's
    width d + 2, worlds 1 and DP_RANKS), each call replayed from a CUDA
    graph: the kernel, its plain version (a loop of adds and a cast), and
    torch.sum over the ranks (float64 out, its own order) as the library's
    yardstick. Bound: the slots read once and the f32 row written once."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    saved = dict(fg.SUM_LAUNCHES)
    out = {}
    width = fg._out_width(fg.VG, d)
    for world in (1, DP_RANKS):
        slots = torch.randn((world, width), generator=gen, device=dev, dtype=torch.float64)
        nbytes = world * width * 8 + width * 4
        row = {
            "ms": graph_ms(torch, lambda: fg.rank_order_sum(slots), 50),
            "plain_ms": graph_ms(torch, lambda: fg.rank_order_sum_plain(slots, torch.float32), 50),
            "library_ms": graph_ms(torch, lambda: torch.sum(slots, dim=0), 50),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
            "world": world, "width": width,
        }
        out[world] = row
        log(f"  time rank_order_sum world={world} width={width}: kernel {row['ms']:.4f} ms (graph-timed)  "
            f"plain {row['plain_ms']:.4f} ms  torch.sum over ranks {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.6f} ms (bytes, {nbytes} B)")
    fg.SUM_LAUNCHES.update(saved)
    return out


# Diagnostic variants of the ring body (csrc/fused_glm.cu): each removes or
# cheapens one part of the consumer's work, so that its time says what that
# part costs. They compute wrong sums; nothing but phase 8 loads them.
_RING_MARGIN = """                const double xd = (double)xv[e];
                za[q] = fma(cd[i * VEC + e], xd, za[q]);
                if constexpr (HV) ua[q] = fma(SV ? vs[(i * VEC + e) * 32 + lane] : vd[i * VEC + e], xd, ua[q]);"""
_RING_COLUMNS = """            float xv[VEC];
            lane_chunk<T, VEC>(xr, d, lane, i, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = fmaf(wq, xv[e], acc[i * VEC + e]);"""
_RING_COEF = """    if constexpr (HV && !SV) lane_vector<T, VEC>(v, d, lane, vd);"""
RING_VARIANTS = {
    "ring": [],
    # margins in f32 FMAs on f32 coefficients: no conversion, no double FMA
    "f32_margins": [
        ("double za[B], ua[B];", "float za[B], ua[B];"),
        (_RING_MARGIN, """                za[q] = fmaf(cf[i * VEC + e], xv[e], za[q]);
                if constexpr (HV) ua[q] = fmaf(vf[i * VEC + e], xv[e], ua[q]);"""),
        (_RING_COEF, _RING_COEF + """
    float cf[kLaneCols], vf[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      cf[c] = (float)cd[c];
      vf[c] = SV ? (float)vs[c * 32 + lane] : (float)vd[c];
    }"""),
    ],
    # each row's x read from the tile and summed, nothing multiplied
    "no_margins": [("double za[B], ua[B];", "float za[B], ua[B];"),
                   (_RING_MARGIN, "                za[q] += xv[e];")],
    # the second read of each row and its column FMAs left out
    "no_columns": [(_RING_COLUMNS, "            acc[i * VEC] += wq;")],
    # the ring, the losses and the bookkeeping alone
    "no_compute": [("double za[B], ua[B];", "float za[B], ua[B];"),
                   (_RING_MARGIN, "                za[q] += xv[e];"),
                   (_RING_COLUMNS, "            acc[i * VEC] += wq;")],
}


def ring_variants(torch, n, d, seed):
    """Each RING_VARIANTS entry built from csrc/fused_glm.cu and timed (CUDA
    events, B1 and B2 at n x d, logistic, f32 and bf16) in turns: the
    variants in order, then in reverse."""
    import ctypes
    import subprocess

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    base = (cuda_lib.CSRC_DIR / "fused_glm.cu").read_text()
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in RING_VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ring variant {name}: the source no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = fg._library()
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on ring variant {name}:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("fused_glm_plan", "fused_glm_launch", "fused_glm_blocks_per_sm"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    loss = LOSSES["logistic"]
    library, plans = fg._library, dict(fg._PLANS)
    out = {}
    try:
        for xname in ("float32", "bfloat16"):
            gen.manual_seed(seed + 7)
            x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)
            for fname, mode, operands in (
                ("fused_value_grad", fg.VG, (x, coef, None, y, off, wt, None, loss)),
                ("fused_hessian_vector", fg.HV, (x, coef, v, y, off, wt, vshift, loss)),
            ):
                runs = {}
                for name in list(libs) + list(libs)[::-1]:
                    fg._library, fg._PLANS = (lambda lib=libs[name]: lib), {}
                    runs.setdefault(name, []).append(time_ms(torch, lambda: fg._launch(mode, *operands), 20))
                out[(xname, fname)] = runs
                log(f"  ring variants {xname:8s} {fname:22s} " + "  ".join(
                    f"{name} {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for name, t in runs.items()) + " ms")
            del x
            torch.cuda.empty_cache()
    finally:
        fg._library, fg._PLANS = library, plans
    return out


# Diagnostic variants of the segment kernel (csrc/sparse_glm.cu) and of its
# earlier design (csrc/sparse_glm_warp.cu), built and timed like the ring's:
# each changes one part, so that its time says what that part costs. Those
# marked so compute wrong sums; nothing but phase 8 loads them.
_SEG_ROW_GATHER = "x[e] = idx[e] >= 0 ? gather_src(src, idx[e]) : 0.0f;"
_SEG_KEY_GATHER = "x[e] = e < cnt ? gather_src(src, idx[e]) : 0.0f;"
_SEG_STORE = "for (int c = lane; c < n; c += kWarp) out[w0 + c] = win[c];"
_SEG_GATHER_FN = "__device__ __forceinline__ float gather_src(const float* __restrict__ src, int i) { return __ldg(src + i); }"
SEGMENT_VARIANTS = {
    "segment": ("sparse_glm", []),
    # wrong sums: entry j reads src[j] (row groups; j < d at the sparse
    # shape) or src[j mod 2^17] (key walk; 2^17 < n): the stream without
    # the gathers
    "contiguous_src": ("sparse_glm", [
        (_SEG_ROW_GATHER, "x[e] = idx[e] >= 0 ? gather_src(src, (int)(j + e)) : 0.0f;"),
        (_SEG_KEY_GATHER, "x[e] = e < cnt ? gather_src(src, (int)((base + e) & 131071)) : 0.0f;"),
    ]),
    # wrong sums: the key walk's window built but not stored
    "no_output_stores": ("sparse_glm", [
        (_SEG_STORE, "for (int c = lane; c < n; c += kWarp) if (win[c] == 1234.5f) out[w0 + c] = win[c];"),
    ]),
    # the gathers under an L2 evict-last cache policy (same sums)
    "l2_evict_last": ("sparse_glm", [(_SEG_GATHER_FN, """__device__ __forceinline__ float gather_src(const float* __restrict__ src, int i) {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  float x;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(x) : "l"(src + i), "l"(policy));
  return x;
}""")]),
    # the earlier design as it is, and with its entries streamed (__ldcs;
    # same sums)
    "earlier": ("sparse_glm_warp", []),
    "earlier_streamed": ("sparse_glm_warp", [
        ("const double v = widen(val[j]);", "const double v = widen(__ldcs(val + j));"),
        ("return (double)src[gather[j]] * (SQ ? v * v : v);",
         "return (double)src[__ldcs(gather + j)] * (SQ ? v * v : v);"),
    ]),
}
MATVEC_W_COLUMNS = (2_500_000, 5_000_000, 7_500_000)  # w of 10, 20 and 30 MB beside d's 40


def segment_variants(torch, seed, batches=None):
    """Each SEGMENT_VARIANTS entry built from its source and timed on the
    sparse shape's products (f32), each launch replayed from a CUDA graph,
    in turns: the variants in order, then in reverse. Then ELL matvec over
    the same rows with their columns taken modulo each MATVEC_W_COLUMNS
    (a smaller w, the same gathers), in turns with the full d."""
    import ctypes
    import subprocess

    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import cuda_lib, sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, edits) in SEGMENT_VARIANTS.items():
        text = (cuda_lib.CSRC_DIR / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"segment variant {name}: the source no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = sparse._library()
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on segment variant {name}:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        if SEGMENT_VARIANTS[name][0] == "sparse_glm":
            for fn in ("segment_rows_launch", "segment_keys_launch"):
                getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    if batches is None:
        raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                         shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
        batches = {layout: raw.to_batch("global", layout=layout) for layout in ("coo", "ell")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    library = sparse._library
    out = {}
    try:
        for layout, batch in batches.items():
            f = batch.features
            w = torch.randn(f.dim, generator=gen, device=dev)
            c = torch.randn(f.n_rows, generator=gen, device=dev)
            for name, (seg, n_seg, src, square) in _segment_calls(f, layout, c, w).items():
                if square:
                    continue
                design = warp_design(torch, seg, n_seg)
                runs = {}
                for v in list(libs) + list(libs)[::-1]:
                    if SEGMENT_VARIANTS[v][0] == "sparse_glm":
                        sparse._library = lambda lib=libs[v]: lib
                        fn = lambda: sparse.segment_dot(name, seg, n_seg, src)  # noqa: E731
                    else:
                        fn = lambda lib=libs[v]: warp_segment_dot(torch, design, seg, n_seg, src, lib=lib)  # noqa: E731
                    runs.setdefault(v, []).append(graph_ms(torch, fn, 20))
                sparse._library = library
                out[name] = runs
                log(f"  segment variants {name:12s} " + "  ".join(
                    f"{v} {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for v, t in runs.items()) + " ms")
                del design
        # ELL matvec with a smaller w: the same rows, columns modulo d'
        mats = {SPARSE_D: batches["ell"].features}
        for dd in MATVEC_W_COLUMNS:
            mats[dd] = batch_from_coo(rows, cols % dd, vals, y, dd, layout="ell").features
        ws = {dd: torch.randn(dd, generator=gen, device=dev) for dd in mats}
        runs = {}
        for dd in list(mats) + list(mats)[::-1]:
            fn = lambda dd=dd: sparse.segment_dot("ell_matvec", mats[dd].row_segments, SPARSE_N, ws[dd])  # noqa: E731
            runs.setdefault(dd, []).append(graph_ms(torch, fn, 20))
        out["ell_matvec_by_w"] = {dd * 4: t for dd, t in runs.items()}
        log("  ell_matvec by the size of w: " + "  ".join(
            f"{dd * 4 / 1e6:.0f} MB {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for dd, t in runs.items()) + " ms")
        del mats, ws
    finally:
        sparse._library = library
        sparse.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 9: sparse fixed effects
#
# bench.py's sparse configuration (bench_sparse_huge_d: n rows of k entries
# over d columns, uniform columns, values N(0, 0.3^2), labels from a
# logistic model of 1,000 hot columns), and its pairing with phase 5's
# random effect. Every sparse product is one launch of the segment kernel
# (csrc/sparse_glm.cu, ops/sparse.py).

SPARSE_N, SPARSE_D, SPARSE_K = 200_000, 10_000_000, 32
SPARSE_GLMIX_N = 500_000  # the GLMix pairing's rows (phase 5's n)
SPARSE_ITERS = 20  # bench.py's L-BFGS iterations on the sparse configuration
SPARSE_PRODUCTS = tuple(
    f"{layout}_{product}" for layout in ("coo", "ell") for product in ("matvec", "rmatvec", "sq_rmatvec")
)


def sparse_triplets(n, d, k, seed):
    """bench.py's bench_sparse_huge_d data from ``seed``: (rows, cols,
    vals, labels, hot-column logits)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k).astype(np.int64)
    cols = rng.integers(0, d, size=n * k).astype(np.int64)
    vals = (rng.normal(size=n * k) * 0.3).astype(np.float64)
    w_true = np.zeros(d)
    hot = rng.integers(0, d, size=1000)
    w_true[hot] = rng.normal(size=len(hot))
    logits = np.bincount(rows, weights=vals * w_true[cols], minlength=n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return rows, cols, vals, y, logits


def ragged_triplets(n, d, seed):
    """A small ragged shape with a full column (3), an empty one (d - 1),
    empty rows and repeated (row, col) pairs, in a shuffled order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 13, size=n)
    counts[::7] = 0
    rows = np.concatenate([np.repeat(np.arange(n), counts), np.arange(n)])
    cols = np.concatenate([rng.integers(0, d - 1, size=int(counts.sum())), np.full(n, 3)])
    pick = rng.integers(0, len(rows), size=len(rows) // 20 + 1)
    rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    order = rng.permutation(len(rows))
    return rows[order], cols[order], (rng.normal(size=len(rows)) * 0.3)[order], (rng.random(n) > 0.5) * 1.0


def _segment_calls(f, layout, src_rows, src_cols):
    """The three products of a matrix: name -> (segments, n_seg, src, square)."""
    return {
        f"{layout}_matvec": (f.row_segments, f.n_rows, src_cols, False),
        f"{layout}_rmatvec": (f.col_segments, f.dim, src_rows, False),
        f"{layout}_sq_rmatvec": (f.col_segments, f.dim, src_rows, True),
    }


def sparse_check(torch, seed, n, d, k):
    """(a) The segment kernel against its float64 plain version for all six
    products, ELL and COO, f32 and bf16 values, at the sparse shape and a
    small ragged one: max-abs error <= 3e-5 * max(|ref|, 1), and two
    launches give the same bits. Returns the max-abs errors at the sparse
    shape in f32, by product."""
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    dev = torch.device("cuda")
    saved = dict(sparse.SPARSE_LAUNCHES)
    gen = torch.Generator(device=dev)
    shapes = {"sparse": sparse_triplets(n, d, k, seed)[:4] + (n, d), "ragged": ragged_triplets(5000, 3000, seed) + (
        5000, 3000)}
    bad, errs = [], {}
    for shape, (rows, cols, vals, y, nn, dd) in shapes.items():
        for layout in ("coo", "ell"):
            for fname in ("float32", "bfloat16"):
                f = batch_from_coo(rows, cols, vals, y, dd, layout=layout, feature_dtype=getattr(torch, fname)).features
                gen.manual_seed(seed + nn)
                w = torch.randn(dd, generator=gen, device=dev)
                c = torch.randn(nn, generator=gen, device=dev)
                for name, (seg, n_seg, src, square) in _segment_calls(f, layout, c, w).items():
                    a = sparse.segment_dot(name, seg, n_seg, src, square)
                    b = sparse.segment_dot(name, seg, n_seg, src, square)
                    torch.cuda.synchronize()
                    ref = sparse.segment_dot_plain(seg, n_seg, src.double(), square)
                    err = float((a.double() - ref).abs().max())
                    bound = 3e-5 * max(float(ref.abs().max()), 1.0)
                    same = _same_bits(a, b)
                    ok = err <= bound and same and bool(torch.isfinite(a).all())
                    log(f"  check segment kernel {shape:6s} {layout} {fname:8s} {name:15s} segments={n_seg} "
                        f"entries={seg.gather.shape[0]} err={err:.3e}/{bound:.3e} same bits twice={same} "
                        f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        bad.append((shape, layout, fname, name))
                    if shape == "sparse" and fname == "float32":
                        errs[name] = err
                del f
        torch.cuda.empty_cache()
    sparse.SPARSE_LAUNCHES.update(saved)  # checks are not main-path launches
    if bad:
        raise AssertionError(f"the segment kernel disagrees with its float64 plain version on {bad}")
    return errs


def _sparse_problem(torch, optimizer, l1=0.0, variance_type="NONE"):
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    return GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=optimizer, regularization=RegularizationContext("L1" if l1 else "L2"), reg_weight=l1 or 1.0,
        variance_type=variance_type,
    ))


def _counted_run(torch, problem, batch, plain=False):
    """A solve on the card with every counter at 0 before it: (model,
    result, wall seconds, sparse launches, dense launches, routes)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    torch.cuda.synchronize()
    fg.reset_launch_counts()
    t0 = time.perf_counter()
    model, res = problem.run(batch, plain=plain)
    float(res.loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return model, res, wall, dict(sparse.SPARSE_LAUNCHES), dict(fg.LAUNCHES), dict(fg.OBJECTIVE_ROUTES)


# the segment kernel's device functions (csrc/sparse_glm.cu), as the
# profiler names them
S1_KERNELS = tuple(f"(anonymous namespace)::{k}" for k in (
    "row_group_kernel", "key_walk_kernel", "join_kernel", "zero_kernel"))


def _layout_arrays(f):
    return [t for t in (f.idx, f.val, f.coo_cols, f.coo_rows, f.coo_vals) if t is not None]


def companion_bytes(f):
    """Device bytes that a sparse ``FeatureMatrix`` holds for its products
    beyond its own arrays: the tensors of its row and column segments that
    are neither the layout's (idx/val, or the coo_* triplets) nor views of
    them, each counted once."""
    own = {t.untyped_storage().data_ptr() for t in _layout_arrays(f)}
    seen, total = set(), 0
    for seg in (f.row_segments, f.col_segments):
        for t in (seg.ptr, seg.gather, seg.val, seg.keys, seg.joins):
            if t is None:
                continue
            ptr = t.untyped_storage().data_ptr()
            if ptr not in own and ptr not in seen:
                seen.add(ptr)
                total += t.untyped_storage().nbytes()
    return total


def profile_sparse_solve(torch, layout, problem, batch):
    """One sparse L-BFGS solve under torch.profiler: device time by kernel
    name, the segment kernel's device time per launch inside the solve
    (where the L2 holds what the solver left there) and the card's busy
    share of the solve's wall."""
    (_, res, wall, launches, _, _), rows = device_profile(torch, lambda: _counted_run(torch, problem, batch))
    busy = log_profile(f"profiled {layout} L-BFGS solve ({res.iterations} iterations)", wall, rows, top=15)
    s1 = [r for r in rows if any(k in r[2] for k in S1_KERNELS)]
    s1_ms = sum(r[0] for r in s1) * 1e-3
    n = sum(launches.values())
    for us, count, key in s1:
        log(f"    S1 {key[:70]}: {us * 1e-3 / count:.4f} ms a launch over {count}")
    log(f"    S1 in the solve: {s1_ms:.4f} ms over {n} product launches, {s1_ms / max(n, 1):.4f} ms a product; "
        f"{s1_ms * 1e-3 / busy:.1%} of the device's busy time, {s1_ms * 1e-3 / wall:.1%} of the wall")
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall, "s1_ms": s1_ms, "s1_launches": n,
            "s1_ms_per_launch": s1_ms / max(n, 1),
            "by_kernel": [{"name": key, "ms": us * 1e-3, "count": count} for us, count, key in rows[:15]]}


def sparse_path(torch, seed, n, d, k):
    """(b) bench.py's sparse configuration at full size through
    RawDataset.to_batch (COO, then ELL) and GLMProblem.run: logistic loss,
    L-BFGS tol 1e-9 for SPARSE_ITERS iterations, L2 1.0. Each solve runs
    twice (the same bits), is held against the plain route on the card by
    loss (rtol 1e-5), and prints examples * iterations / s; then one OWL-QN
    solve (L1 1.0) on COO with SIMPLE variance (the COO Hessian diagonal
    once), held the same way, its variances at rtol 1e-3."""
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    t0 = time.perf_counter()
    rows, cols, vals, y, _ = sparse_triplets(n, d, k, seed)
    raw = RawDataset(n_rows=n, labels=y, offsets=np.zeros(n), weights=np.ones(n),
                     shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": d}, id_tags={})
    log(f"  sparse data n={n} d={d} k={k} made in {time.perf_counter() - t0:.1f}s")
    lbfgs = OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS)
    problems, report, batches = [], {"launches": {}}, {}
    for layout in ("coo", "ell"):
        t0 = time.perf_counter()
        batch = raw.to_batch("global", layout=layout)
        torch.cuda.synchronize()
        cb = companion_bytes(batch.features)
        report.setdefault("companion_bytes", {})[layout] = cb
        log(f"  {layout} batch (with its segments) built in {time.perf_counter() - t0:.1f}s; companions "
            f"{cb / 1e6:.1f} MB beside the layout's {sum(t.numel() * t.element_size() for t in _layout_arrays(batch.features)) / 1e6:.1f} MB")
        problem = _sparse_problem(torch, lbfgs)
        _counted_run(torch, problem, batch)  # loads PyTorch's lazily loaded kernels
        model, res, wall, launches, dense, routes = _counted_run(torch, problem, batch)
        model2, res2, wall2, *_ = _counted_run(torch, problem, batch)
        _, res_p, wall_p, launches_p, _, routes_p = _counted_run(torch, problem, batch, plain=True)
        loss, loss_p = float(res.loss), float(res_p.loss)
        rel = abs(loss - loss_p) / abs(loss_p)
        same = _same_bits(model.coefficients.means, model2.coefficients.means) and _same_bits(res.loss, res2.loss)
        rate = n * res.iterations / min(wall, wall2)
        log(f"  {layout} L-BFGS kernels: iterations={res.iterations} reason={res.reason} loss={loss:.6f} "
            f"wall_s={wall:.4f}/{wall2:.4f} syncs={res.syncs} examples*iterations/s={rate:.1f} launches={launches} "
            f"routes={ {r: v for r, v in routes.items() if v} }; plain: iterations={res_p.iterations} "
            f"loss={loss_p:.6f} wall_s={wall_p:.4f} launches={sum(launches_p.values())}; loss rel diff {rel:.2e} "
            f"(rtol 1e-5); same bits on two runs: {same}")
        if launches[f"{layout}_matvec"] <= 0 or launches[f"{layout}_rmatvec"] <= 0:
            problems.append(f"{layout}: the solve did not run through the segment kernel: {launches}")
        if routes["sparse_kernel"] != 1 or routes["plain_float64"] or routes["plain_cpu"] or any(dense.values()):
            problems.append(f"{layout}: a plain or dense route ran on the kernel path: {routes} {dense}")
        if any(launches_p.values()) or routes_p["sparse_kernel"]:
            problems.append(f"{layout}: the plain solve launched the kernel")
        if not (rel <= 1e-5 and same and math.isfinite(loss)):
            problems.append(f"{layout}: loss rel diff {rel:.2e} vs plain, same bits {same}")
        report["launches"] = {p: report["launches"].get(p, 0) + v for p, v in launches.items()}
        report[layout] = {"iterations": res.iterations, "wall_s": min(wall, wall2), "examples_iters_per_s": rate,
                          "loss": loss, "plain_loss": loss_p, "syncs": res.syncs,
                          "profile": profile_sparse_solve(torch, layout, problem, batch)}
        batches[layout] = batch
    # OWL-QN on the COO batch, with SIMPLE variance: the COO Hessian
    # diagonal (coo_sq_rmatvec) once
    problem = _sparse_problem(torch, lbfgs, l1=1.0, variance_type="SIMPLE")
    batch = batches["coo"]
    model, res, wall, launches, _, _ = _counted_run(torch, problem, batch)
    model_p, res_p, _, _, _, _ = _counted_run(torch, problem, batch, plain=True)
    nnz = int((model.coefficients.means != 0).sum())
    rel = abs(float(res.loss) - float(res_p.loss)) / abs(float(res_p.loss))
    var, var_p = model.coefficients.variances, model_p.coefficients.variances
    var_err = float(((var - var_p).abs() / var_p.abs()).max())
    log(f"  coo OWL-QN (L1 1.0): iterations={res.iterations} reason={res.reason} loss={float(res.loss):.6f} "
        f"nonzeros={nnz} of {d} wall_s={wall:.4f} launches={launches}; plain loss {float(res_p.loss):.6f}, "
        f"rel diff {rel:.2e} (rtol 1e-5); variances max rel diff {var_err:.2e} (rtol 1e-3)")
    if not rel <= 1e-5 or launches["coo_matvec"] <= 0 or launches["coo_sq_rmatvec"] != 1 or not var_err <= 1e-3:
        problems.append(f"OWL-QN: loss rel diff {rel:.2e} vs plain, variances {var_err:.2e}, launches {launches}")
    report["launches"] = {p: report["launches"].get(p, 0) + v for p, v in launches.items()}
    report["owlqn"] = {"nonzeros": nnz, "iterations": res.iterations, "loss": float(res.loss)}
    if problems:
        raise AssertionError("; ".join(problems))
    report["batches"] = batches
    return report


def sparse_glmix_data(n, d, k, users, d_re, seed):
    """The GLMix pairing: bench.py's sparse rows (k entries over d columns)
    as the global shard and build_data's Zipf(1.1) users with d_re
    per-user features, labels from a logistic model of both."""
    rows, cols, vals, _, z = sparse_triplets(n, d, k, seed)
    rng = np.random.default_rng(seed + 1)
    probs = 1.0 / np.arange(1, users + 1) ** 1.1
    assign = rng.choice(users, size=n, p=probs / probs.sum())
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    w_u = (rng.standard_normal((users, d_re)) / np.sqrt(d_re)).astype(ex.dtype)
    z = z + np.einsum("nd,nd->n", ex, w_u[assign])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    ids = np.char.add("u", assign.astype(str)).astype(object)
    raw_kw = dict(n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
                  shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": d}, id_tags={})
    return raw_kw, (None, y, ex, ids)


def sparse_glmix(torch, seed, n, d, k, users, d_re):
    """(c) Phase 5's sweep with its global shard sparse: n rows of k entries
    over d columns, build_fixed_effect_dataset(layout="auto") picks ELL;
    FE TRON tol 1e-6, 10 iterations, L2 1.0, SIMPLE variance; RE phase 5's.
    One warm-up sweep, then SWEEPS timed ones (the median), counters at 0
    before them and read after; held against the same sweep on the plain
    route on the card at phase 5's bounds."""
    from photon_ml_tpu_torch.game import build_fixed_effect_dataset
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    t0 = time.perf_counter()
    raw_kw, data = sparse_glmix_data(n, d, k, users, d_re, seed)
    fe_ds = build_fixed_effect_dataset(RawDataset(**raw_kw), "global", "global", layout="auto")
    coords = glmix_coordinates(data, torch.device("cuda"), fe_dataset=fe_ds)
    log(f"  sparse GLMix data + datasets built in {time.perf_counter() - t0:.1f}s: n={n} d={d} k={k} "
        f"layout={fe_ds.batch.features.layout} users={users} d_re={d_re}")
    problems = []
    if fe_ds.batch.features.layout != "ell":
        problems.append(f"layout auto picked {fe_ds.batch.features.layout}, not ell")
    sweep(torch, coords)
    fg.reset_launch_counts()
    runs = [sweep(torch, coords) for _ in range(SWEEPS)]
    launches, dense, routes = dict(sparse.SPARSE_LAUNCHES), dict(fg.LAUNCHES), dict(fg.OBJECTIVE_ROUTES)
    same = all(_same_bits(r.model["global"].coefficients.means, runs[0][0].model["global"].coefficients.means)
               for r, _ in runs)
    res, wall = sorted(runs, key=lambda rw: rw[1])[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    fe_r = res.solver_results["global"]
    log(f"  sparse GLMix sweep (kernels), median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) shares FE={res.seconds['global'] / wall:.3f} "
        f"RE={res.seconds['per-user'] / wall:.3f} syncs={res.syncs} launches={launches} routes="
        f"{ {r: v for r, v in routes.items() if v} } train_auc={a:.6f}; FE iterations={fe_r.iterations} "
        f"reason={fe_r.reason} loss={float(fe_r.loss):.6f}; FE bits equal over the sweeps: {same}")
    if min(launches["ell_matvec"], launches["ell_rmatvec"]) <= 0 or launches["ell_sq_rmatvec"] != SWEEPS:
        problems.append(f"the sparse sweep did not run the segment kernel as expected: {launches}")
    if routes["sparse_kernel"] != SWEEPS or routes["plain_float64"] or routes["plain_cpu"] or any(dense.values()):
        problems.append(f"a plain or dense route ran on the sparse sweep: {routes} {dense}")
    var = res.model["global"].coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) or not bool((var > 0).all()):
        problems.append("SIMPLE variances missing, non-finite or not positive")
    if not (0.5 < a <= 1.0):
        problems.append(f"training AUC {a} out of (0.5, 1]")
    plain = dict(coords, **{"global": dataclasses.replace(coords["global"], plain=True)})
    fg.reset_launch_counts()
    res_p, wall_p = sweep(torch, plain)
    log(f"  sparse GLMix sweep (plain): wall_s={wall_p:.4f} launches={sum(sparse.SPARSE_LAUNCHES.values())}")
    if any(sparse.SPARSE_LAUNCHES.values()):
        problems.append("the plain sweep launched the segment kernel")
    hold_sweeps(problems, "sparse kernel vs plain sweep:", res, res_p, retrain_re(coords, res, plain))
    if problems:
        raise AssertionError("; ".join(problems))
    return {"launches": launches, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
            "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
            "syncs": res.syncs, "train_auc": a}


def sparse_phase(torch, seed, users, d_re):
    out = {"errors": sparse_check(torch, seed, SPARSE_N, SPARSE_D, SPARSE_K)}
    out["path"] = sparse_path(torch, seed, SPARSE_N, SPARSE_D, SPARSE_K)
    torch.cuda.empty_cache()
    out["glmix"] = sparse_glmix(torch, seed, SPARSE_GLMIX_N, SPARSE_D, SPARSE_K, users, d_re)
    return out


def time_sparse(torch, seed, batches=None):
    """Phase 7's row for the segment kernel: each product at the sparse
    shape (f32 values), CUDA events over 20 launches after 3, two rounds,
    the earlier design (``warp_segment_dot``) in turns with it (prev, new,
    new, prev) and both replayed from a CUDA graph, beside its bound
    (``segment_bytes``'s function bytes over 3.35 TB/s, or its operations;
    the design's bytes and the worst case of a sector per gather beside),
    its plain version, index_add_ (the gather, the product and an atomic
    float32 index_add_, three launches) and one cuSPARSE CSR SpMV through
    torch.sparse computing the same product (library_ms)."""
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    dev = torch.device("cuda")
    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    if batches is None:
        raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                         shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
        batches = {layout: raw.to_batch("global", layout=layout) for layout in ("coo", "ell")}
    # the same rows with an intercept column (d - 1, 1.0 in every row): one
    # segment of n entries in rmatvec, a skewed case the main path lacks
    every = np.arange(SPARSE_N)
    batches = dict(batches, skewed=batch_from_coo(
        np.concatenate([rows, every]), np.concatenate([cols, np.full(SPARSE_N, SPARSE_D - 1)]),
        np.concatenate([vals, np.ones(SPARSE_N)]), y, SPARSE_D, layout="coo"))
    saved = dict(sparse.SPARSE_LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    out = {}
    for layout, batch in batches.items():
        f = batch.features
        w = torch.randn(f.dim, generator=gen, device=dev)
        c = torch.randn(f.n_rows, generator=gen, device=dev)
        calls = _segment_calls(f, f.layout, c, w)
        if layout == "skewed":
            calls = {"coo_rmatvec": calls["coo_rmatvec"]}
        for name, (seg, n_seg, src, square) in calls.items():
            key = name if layout != "skewed" else f"{name}_with_intercept"
            n_src = src.shape[0]
            ids = seg.segment_ids(n_seg)
            gather = seg.gather.long()
            val = seg.val * seg.val if square else seg.val
            if seg.keys is not None:  # the key form's CSR pointers, for the library call
                ptr = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
                ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n_seg), 0)
            else:
                ptr = seg.ptr if seg.ptr is not None else torch.arange(n_seg + 1, device=dev) * seg.seg_len
            library = lambda: torch.mv(csr, src)  # noqa: E731
            with warnings.catch_warnings():  # torch marks its sparse CSR tensors beta
                warnings.simplefilter("ignore")
                csr = torch.sparse_csr_tensor(ptr.to(torch.int32), seg.gather, val, size=(n_seg, n_src))
                library()
            acc = torch.empty(n_seg, device=dev)

            def by_index_add():
                acc.zero_()
                return acc.index_add_(0, ids, src[gather] * val)

            kern = lambda: sparse.segment_dot(name, seg, n_seg, src, square)  # noqa: E731
            plain = lambda: sparse.segment_dot_plain(seg, n_seg, src, square)  # noqa: E731
            design = warp_design(torch, seg, n_seg)
            prev = lambda: warp_segment_dot(torch, design, seg, n_seg, src, square)  # noqa: E731
            lib_err = float((library().double() - plain().double()).abs().max())
            prev_err = float((prev().double() - plain().double()).abs().max())
            runs = {key: [] for key in ("ms", "prev_ms", "plain_ms", "index_add_ms", "library_ms")}
            for _ in range(2):  # two rounds, each in turns: plain, library, index_add_, prev, kernel, kernel, prev
                runs["plain_ms"].append(time_ms(torch, plain, 5))
                runs["library_ms"].append(time_ms(torch, library, 20))
                runs["index_add_ms"].append(time_ms(torch, by_index_add, 20))
                runs["prev_ms"].append(time_ms(torch, prev, 20))
                runs["ms"].append(time_ms(torch, kern, 20))
                runs["ms"].append(time_ms(torch, kern, 20))
                runs["prev_ms"].append(time_ms(torch, prev, 20))
            # each design's kernels alone, replayed from a CUDA graph (no host launch time)
            graph = {"graph_ms": graph_ms(torch, kern, 20), "prev_graph_ms": graph_ms(torch, prev, 20)}
            nbytes = segment_bytes(seg, n_seg, n_src)
            ops = segment_flops(seg, square)
            t_bytes, t_ops = nbytes["function"] / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
            row = {key: min(v) for key, v in runs.items()}
            row.update({f"{key}_runs": v for key, v in runs.items()})
            prev_bytes = nbytes["function"] + design["bytes"]
            row.update(graph)
            row.update({"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "design_bound_ms": nbytes["design"] / HBM_BYTES_PER_S * 1e3,
                        "prev_design_bound_ms": prev_bytes / HBM_BYTES_PER_S * 1e3,
                        "sector_ms": nbytes["sectors"] / HBM_BYTES_PER_S * 1e3,
                        "bytes": nbytes["function"], "design_bytes": nbytes["design"], "prev_design_bytes": prev_bytes,
                        "sector_bytes": nbytes["sectors"], "ops": ops, "segments": n_seg,
                        "entries": seg.gather.shape[0], "library_max_abs_diff": lib_err, "prev_max_abs_diff": prev_err,
                        "form": "keys" if seg.keys is not None else f"row groups of {seg.group}"})
            out[key] = row
            log(f"  time segment kernel {key:15s} ({row['form']}) segments={n_seg} entries={seg.gather.shape[0]}: "
                f"kernel {'/'.join(f'{t:.4f}' for t in runs['ms'])} ms (graph {row['graph_ms']:.4f})  earlier design "
                f"{'/'.join(f'{t:.4f}' for t in runs['prev_ms'])} ms (graph {row['prev_graph_ms']:.4f}, max abs diff "
                f"{prev_err:.2e})  plain {'/'.join(f'{t:.4f}' for t in runs['plain_ms'])} "
                f"ms  index_add_ (gather, product, atomic add) {'/'.join(f'{t:.4f}' for t in runs['index_add_ms'])} ms  "
                f"cuSPARSE CSR SpMV (torch.mv on a sparse CSR tensor) "
                f"{'/'.join(f'{t:.4f}' for t in runs['library_ms'])} ms (max abs diff {lib_err:.2e})  "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {nbytes['function']} B): "
                f"{row['bound_ms'] / row['ms']:.1%} of it; with the design's own bytes "
                f"{row['design_bound_ms']:.4f} ms ({nbytes['design']} B): "
                f"{row['design_bound_ms'] / row['ms']:.1%} (the earlier design's {row['prev_design_bound_ms']:.4f} ms); "
                f"a sector per gather (worst case, not a bound) {row['sector_ms']:.4f} ms")
            del csr, ids, gather, acc, design
        torch.cuda.empty_cache()
    sparse.SPARSE_LAUNCHES.update(saved)
    return out


# The segment kernel's earlier design (csrc/sparse_glm_warp.cu: a warp per
# 32 segments, int64 pointers over every segment, a chunk plan for the
# segments over WARP_CHUNK entries), timed in turns with the current one in
# phase 7 as its yardstick. Nothing on the main path calls it.
WARP_CHUNK = 4096


def warp_design(torch, seg, n_seg):
    """The earlier design's companions of a product: its int64 pointers
    (none for the uniform ELL rows) and the chunk plan of its segments over
    WARP_CHUNK entries, over ``seg``'s entries, gather and values."""
    dev = seg.gather.device
    uniform = seg.keys is None and seg.ptr is None
    counts = np.full(n_seg, seg.seg_len) if uniform else np.bincount(
        seg.segment_ids(n_seg).cpu().numpy(), minlength=n_seg)
    long_ids = np.flatnonzero(counts > WARP_CHUNK)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ptr = None
    if not uniform or long_ids.size:
        ptr = to(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
    plan = None
    if long_ids.size:
        n_chunks = -(-counts[long_ids] // WARP_CHUNK)
        plan = (to(long_ids.astype(np.int64)), to(np.concatenate([[0], np.cumsum(n_chunks)]).astype(np.int64)),
                to(np.repeat(np.arange(long_ids.size, dtype=np.int32), n_chunks)))
    return {"ptr": ptr, "seg_len": seg.seg_len if uniform and not long_ids.size else 0, "plan": plan,
            "bytes": (0 if ptr is None else 8 * (n_seg + 1)) + (0 if plan is None else (
                8 * long_ids.size + 8 * (long_ids.size + 1) + (4 + 16) * int(plan[2].shape[0])))}


def warp_segment_dot(torch, design, seg, n_seg, src, square=False, lib=None):
    """One launch of the earlier design (and of its chunk finalize where it
    has a plan) over ``design`` = ``warp_design(...)``: float32 out; ``lib``
    a variant's library (phase 8) in place of csrc/sparse_glm_warp.cu's."""
    import ctypes

    from photon_ml_tpu_torch.ops import cuda_lib

    lib = lib or cuda_lib.load("sparse_glm_warp")
    if lib.segment_dot_warp_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.segment_dot_warp_launch.argtypes = [i, i, p, ll, ll, p, p, p, p, ll, ll, ll, p, p, p, p, p]
        lib.segment_dot_warp_launch.restype = i
    out = torch.empty(n_seg, dtype=torch.float32, device=src.device)
    plan = design["plan"]
    long_ids, chunk_first, owner = plan if plan is not None else (None, None, None)
    n_chunks = 0 if plan is None else owner.shape[0]
    partial = torch.empty(n_chunks, dtype=torch.float64, device=src.device)
    addr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.segment_dot_warp_launch(
        int(seg.val.dtype == torch.bfloat16), int(square), addr(design["ptr"]), design["seg_len"], n_seg,
        seg.gather.data_ptr(), seg.val.data_ptr(), src.data_ptr(), out.data_ptr(),
        WARP_CHUNK if plan is not None else 0, n_chunks, 0 if plan is None else long_ids.shape[0], addr(owner),
        addr(chunk_first), addr(long_ids), addr(partial) if n_chunks else None,
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the earlier segment design failed over {n_seg} segments: CUDA error {rc}")
    return out


def sparse_entries(sp, times):
    """The segment kernel's lines of the kernels JSON, one per product:
    ``launches`` over the sparse phase's main paths (the (b) kernel solves
    and the (c) timed sweeps, each counted from 0), ``max_abs_err`` from
    (a) at the sparse shape in f32, times from phase 7."""
    sp = sp or {}
    path = (sp.get("path") or {}).get("launches", {})
    glmix = (sp.get("glmix") or {}).get("launches", {})
    entries = []
    for name in SPARSE_PRODUCTS:
        t = (times or {}).get("sparse", {}).get(name, {})
        entries.append({
            "name": f"segment_dot:{name}", "route": "cuda", "source": "photon_ml_tpu_torch/csrc/sparse_glm.cu",
            "replaces": SPARSE_REPLACES[name.split("_", 1)[1]],
            "launches": path.get(name, 0) + glmix.get(name, 0),
            "launches_sparse_solves": path.get(name, 0), "launches_sparse_glmix": glmix.get(name, 0),
            "max_abs_err": (sp.get("errors") or {}).get(name),
            "ms": t.get("ms"), "prev_ms": t.get("prev_ms"), "graph_ms": t.get("graph_ms"),
            "prev_graph_ms": t.get("prev_graph_ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "design_bound_ms": t.get("design_bound_ms"),
            "prev_design_bound_ms": t.get("prev_design_bound_ms"), "form": t.get("form"),
            "sector_ms": t.get("sector_ms"), "library_ms": t.get("library_ms"),
            "library": "cuSPARSE CSR SpMV (torch.mv on a sparse CSR tensor)",
            "index_add_ms": t.get("index_add_ms"), "dtype": "float32 values and src, double sums",
            "segments": t.get("segments"), "entries": t.get("entries"), "design": DESIGN["segment_dot"],
            "prev_design": PREV_SEGMENT_DESIGN,
            "companion_bytes": ((sp.get("path") or {}).get("companion_bytes") or {}).get(name.split("_", 1)[0]),
            "solve_ms_per_launch": (((sp.get("path") or {}).get(name.split("_", 1)[0]) or {}).get("profile")
                                    or {}).get("s1_ms_per_launch"),
        })
    return entries


def segment_bytes(seg, n_seg, n_src):
    """Bytes of one segment product (``ops/sparse.py`` ``Segments``), three
    ways:

    - ``function``, the bound: what the product must move. Each entry's
      int32 source index and its value read once, the ``n_src`` float32
      source read once, the float32 output written once. At the sparse
      shape both sources (w, 40 MB; c, 0.8 MB) fit the 50 MB L2, so a gather
      costs no sector of its own;
    - ``design``: ``function`` plus what this design adds: the row groups'
      segment pointers (none for uniform ELL rows), or the key walk's int32
      keys, its joins and their float64 carries (one written by each tile
      of a join and read by the join);
    - ``sectors``: the worst case, each gathered source value a 32-byte
      sector of its own, with the design's additions. Not a bound."""
    nnz = seg.gather.shape[0]
    entries = nnz * (4 + seg.val.element_size())
    if seg.keys is not None:
        tiles = int((seg.joins[:, 2] - seg.joins[:, 1] + 1).sum()) if seg.joins.shape[0] else 0
        own = 4 * nnz + 12 * seg.joins.shape[0] + 2 * 8 * tiles
    else:
        own = 0 if seg.ptr is None else seg.ptr.element_size() * (n_seg + 1)
    function = entries + 4 * n_src + 4 * n_seg
    return {"function": function, "design": function + own, "sectors": entries + 32 * nnz + 4 * n_seg + own}


def segment_flops(seg, square=False):
    """Operations of one segment product: a multiply and an add per entry
    (one more multiply for the square)."""
    return (3 if square else 2) * seg.gather.shape[0]


def b4_bound_ms(n, d, mode, world):
    """Least time of one B4 call per card, from bytes over 3.35 TB/s (the
    operations take less): the card's rows of X and their [n] vectors read
    once, the [d] vectors read, the slot row written, the gathered
    [world, width] slots read by the sum and the f32 outputs written. With
    DP_RANKS gloo ranks sharing one card, that card streams every rank's
    rows: call it with world 1 and the whole padded n."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm as fg

    width = fg._out_width(mode, d)
    rows = fg.sweep_bytes(-(-n // world), d, torch.float32, mode) - 4 * width
    return (rows + 8 * width + 8 * world * width + 4 * width) / HBM_BYTES_PER_S * 1e3


def b4_entry(name, n, d, dp, times):
    """B4's line of the kernels JSON. ``launches``: its calls over the
    4-rank gloo sweeps, summed over the ranks (per rank beside), and over
    the NCCL sweeps. ``ms``: one call at n x d f32 on rank 0 of 4 gloo ranks
    sharing the card, with the all-reduce path timed in turns (``prev_ms``), the
    collective alone and the rank's kernel alone beside; ``nccl_*`` the same
    over NCCL, one rank per card (world ``nccl_world``), on the sweep's
    rows. ``plain_ms``: the unsharded plain version on the whole batch
    (phase 7). ``bound_ms``: the gloo configuration's (one card streams all
    of X), ``nccl_bound_ms`` one card's of the NCCL world. No PyTorch call
    computes it: NCCL and gloo move bytes, they compute none of B4's sums."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    mode = {"sharded_value_grad": fg.VG, "sharded_hessian_vector": fg.HV, "sharded_hessian_stats": fg.HD}[name]
    share = -(-n // DP_RANKS)
    b4 = (dp or {}).get("b4", {})
    t32 = b4.get("times", {}).get("float32", {}).get(name, {})
    sweep = (dp or {}).get("sweep") or {}
    nccl = (dp or {}).get("nccl") or {}
    tn = nccl.get("b4", {}).get(name, {})
    world = nccl.get("world", 1)
    per_rank = [r[name] for r in sweep.get("sharded", [])]
    plain = (times or {}).get("float32", {}).get(B4_OF[name], {})
    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "sum_source": SOURCES["rank_order_sum"], "design": B4_DESIGN,
        "launches": sum(per_rank), "launches_per_rank": per_rank,
        "launches_nccl": nccl.get("sharded", {}).get(name, 0),
        "max_abs_err": b4.get("errors", {}).get(name),
        "ms": t32.get("ms"), "prev_ms": t32.get("prev_ms"), "collective_ms": t32.get("collective_ms"),
        "prev_collective_ms": t32.get("prev_collective_ms"), "rank_kernel_ms": t32.get("kernel_ms"),
        "plain_ms": plain.get("plain_ms"),
        "bound_ms": b4_bound_ms(share * DP_RANKS, d, mode, 1), "bound_by": "bytes",
        "bound_ms_per_card_p4": b4_bound_ms(share * DP_RANKS, d, mode, DP_RANKS),
        "library_ms": None, "dtype": "float32", "world": DP_RANKS, "backend": "gloo",
        "bf16_ms": b4.get("times", {}).get("bfloat16", {}).get(name, {}).get("ms"),
        "nccl_world": world, "nccl_ms": tn.get("ms"), "nccl_prev_ms": tn.get("prev_ms"),
        "nccl_collective_ms": tn.get("collective_ms"), "nccl_collective_own_ms": tn.get("collective_own_ms"),
        "nccl_prev_collective_ms": tn.get("prev_collective_ms"), "nccl_rank_kernel_ms": tn.get("kernel_ms"),
        "nccl_bound_ms": b4_bound_ms(n, d, mode, world),
    }


def sum_entry(dp, times, errs):
    """The rank-order sum's line of the kernels JSON: launches over the
    data-parallel sweeps (gloo, summed over the ranks; NCCL beside), its
    time at the 4-rank value+grad shape (phase 7; world 1 beside)."""
    t = (times or {}).get("rank_order_sum", {})
    t4, t1 = t.get(DP_RANKS, {}), t.get(1, {})
    sweep = (dp or {}).get("sweep") or {}
    nccl = (dp or {}).get("nccl") or {}
    return {
        "name": "rank_order_sum", "route": "cuda", "source": SOURCES["rank_order_sum"],
        "replaces": REPLACES["rank_order_sum"], "design": DESIGN["rank_order_sum"],
        "launches": sum(r["rank_order_sum"] for r in sweep.get("sums", [])),
        "launches_per_rank": [r["rank_order_sum"] for r in sweep.get("sums", [])],
        "launches_nccl": nccl.get("sums", {}).get("rank_order_sum", 0),
        "max_abs_err": (errs or {}).get("rank_order_sum"),
        "ms": t4.get("ms"), "plain_ms": t4.get("plain_ms"), "bound_ms": t4.get("bound_ms"),
        "bound_by": "bytes", "library_ms": t4.get("library_ms"), "dtype": "float64 in, float32 out",
        "world": DP_RANKS, "width": t4.get("width"),
        "world1_ms": t1.get("ms"), "world1_plain_ms": t1.get("plain_ms"), "world1_library_ms": t1.get("library_ms"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--d-re", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated subset of check,fe,glmix,dp,nccl,sparse,timing,variants to run after "
                         "card and build (for iterating on one phase; the result is then not ok)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    want = lambda phase: not only or phase in only  # noqa: E731

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import photon_ml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    phases = Phases()
    smi = phases.run("card", card, torch)
    phases.run("build", build)
    errs = fe_launches = glmix = dp = times = None
    if want("check"):
        errs = phases.run("kernels vs float64 plain", check_kernels, torch, args.n, args.d, args.seed)
    if want("fe"):
        fe_launches = phases.run("fixed-effect path", fe_path, torch, args.n, args.d, args.seed)
    if want("glmix") or want("dp") or want("nccl"):
        glmix = phases.run(
            "GLMix sweep (main path)", glmix_path, torch, args.n, args.d, args.users, args.d_re, args.seed
        )
    state = (glmix or {}).pop("state", None)
    if not (want("dp") or want("nccl")):
        pass
    elif state is None:
        log("== phase: data-parallel GLMix sweep needs the one-card sweep's results")
        phases.failed.append("data-parallel GLMix sweep")
    else:
        dp = phases.run(
            "data-parallel GLMix sweep", dp_path, torch, args.n, args.d, args.seed, state, "cuda", want("dp")
        )
    del state
    torch.cuda.empty_cache()
    sp = None
    if want("sparse"):
        sp = phases.run("sparse fixed effects", sparse_phase, torch, args.seed, args.users, args.d_re)
    batches = (sp or {}).get("path", {}).pop("batches", None)
    if want("timing"):
        times = phases.run("timing", timings, torch, args.n, args.d, args.seed)
        sparse_times = phases.run("timing (segment kernel)", time_sparse, torch, args.seed, batches)
        if times is not None:
            times["sparse"] = sparse_times or {}
    torch.cuda.empty_cache()
    if want("variants"):
        phases.run("segment kernel variants", segment_variants, torch, args.seed, batches)
    del batches
    torch.cuda.empty_cache()
    if want("variants"):
        phases.run("ring variants", ring_variants, torch, args.n, args.d, args.seed)
    if only:
        phases.failed.append(f"only {sorted(only)} ran")

    if glmix:
        log(f"GLMix sweep: {args.n / glmix['wall_s']:.1f} examples/s (median wall {glmix['wall_s']:.4f} s "
            f"of {min(glmix['walls']):.4f}-{max(glmix['walls']):.4f}, "
            f"FE share {glmix['fe_share']:.3f}, RE share {glmix['re_share']:.3f}, "
            f"syncs {glmix['syncs']}, train AUC {glmix['train_auc']:.6f}) on {smi}")
    if dp:
        sw = dp.get("sweep")
        if sw:
            log(f"data-parallel GLMix sweep (backend gloo, world {DP_RANKS}, one card): "
                f"{sw['examples_per_s']:.1f} examples/s (median wall {sw['wall_s']:.4f} s, "
                f"FE share {sw['fe_share']:.3f}, RE share {sw['re_share']:.3f}, RE walls per rank "
                f"{', '.join(f'{w:.4f}' for w in sw['re_walls'])} s, syncs {sw['syncs']}, "
                f"collectives {sw['collectives']})")
        log(f"data-parallel GLMix sweep over nccl, world {dp['nccl']['world']}: "
            f"median wall {dp['nccl']['wall_s']:.4f} s against one card's {dp['nccl']['one_card_wall_s']:.4f} s, "
            f"B4 value+grad {dp['nccl']['b4']['sharded_value_grad']['ms']:.4f} ms/call (the all-reduce path "
            f"{dp['nccl']['b4']['sharded_value_grad']['prev_ms']:.4f}), host synchronizes in B4 "
            f"{dp['nccl']['host_syncs']}; on {smi}")
    launches = (glmix or {}).get("launches", {})
    kernels = []
    for name in KERNELS:
        if name in B4_OF:
            kernels.append(b4_entry(name, args.n, args.d, dp, times))
            continue
        if name == "rank_order_sum":
            kernels.append(sum_entry(dp, times, errs))
            continue
        t = (times or {}).get("float32", {}).get(name, {})
        t16 = (times or {}).get("bfloat16", {}).get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches.get(name, 0),
            "launches_fixed_effect_path": (fe_launches or {}).get(name, 0),
            "launches_data_parallel_per_rank": [
                r[name] for r in ((dp or {}).get("sweep") or {}).get("launches", [])
            ],
            "max_abs_err": (errs or {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "library_ms": None, "dtype": "float32",
            "design": DESIGN[name], "route_launches": {
                k: v for k, v in ((glmix or {}).get("routes") or {}).items() if v
            } if name != "fused_hessian_stats" else None,
            "prev_ms": t.get("prev_ms"), "main_ms": t.get("main_ms"),
            "finalize_ms": t.get("finalize_ms"), "prev_finalize_ms": t.get("prev_finalize_ms"),
            "read_x_ms": t.get("read_x_ms"), "plan": t.get("plan"),
            **{f"bf16_{k}": t16.get(k) for k in ("ms", "prev_ms", "finalize_ms", "read_x_ms", "bound_ms")},
        })
    kernels += sparse_entries(sp, times)
    if sp:
        path, sg = sp["path"], sp["glmix"]
        log(f"sparse fixed effect (n={SPARSE_N}, d={SPARSE_D}, k={SPARSE_K}, L-BFGS at most {SPARSE_ITERS} "
            f"iterations, ran {path['coo']['iterations']} (COO) and {path['ell']['iterations']} (ELL)): "
            f"COO {path['coo']['examples_iters_per_s']:.1f} and ELL {path['ell']['examples_iters_per_s']:.1f} "
            f"examples*iterations/s; OWL-QN (L1 1.0) nonzeros {path['owlqn']['nonzeros']}; sparse GLMix sweep "
            f"(n={SPARSE_GLMIX_N}, ELL) {sg['examples_per_s']:.1f} examples/s (median wall {sg['wall_s']:.4f} s, "
            f"FE share {sg['fe_share']:.3f}, RE share {sg['re_share']:.3f}) on {smi}")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    ok = not phases.failed
    if not ok:
        log(f"failed phases: {phases.failed}")
    print(json.dumps({
        "ok": ok,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
