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
   scalar sums), s2 and s1 max-abs error <= 3e-5 * max(|ref|, 1);
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
   L2 1.0, active cap 256), five timed sweeps after a warm-up one, with
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
6. each kernel timed with CUDA events beside its bound (bytes over 3.35 TB/s,
   or operations over the dtype's peak) and its plain version.

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

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per dtype
REPLACES = {
    "fused_value_grad": "photon_ml_tpu/ops/pallas_glm.py:165",
    "fused_hessian_vector": "photon_ml_tpu/ops/pallas_glm.py:203",
    "fused_hessian_stats": "photon_ml_tpu/ops/pallas_glm.py:238",
}
KERNELS = tuple(REPLACES)
SWEEPS = 5  # timed GLMix sweeps; launches are counted over all of them
SOURCE = "photon_ml_tpu_torch/csrc/fused_glm.cu"


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
    if bad:
        raise AssertionError(f"kernels disagree with the float64 plain version on {bad}")
    return main_errs


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
        f"auc={a:.6f} wall_s={wall:.3f} syncs={res.syncs} launches={launches}")
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


def glmix_coordinates(data, dev, plain=False):
    """bench.py's product-path datasets and coordinates on ``dev``: the
    fixed effect batches the dense matrix; the random effect runs the real
    build on a userShard-only RawDataset with active cap 256."""
    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinate, FixedEffectDataset, GLMOptimizationConfig,
        RandomEffectCoordinate, build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

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
    fe_ds = FixedEffectDataset("global", "global", batch=batch_from_dense(gx, y, device=dev))
    re_ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", active_cap=256, device=dev)
    return {
        "global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=cfg_fe, plain=plain),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=cfg_re),
    }


def sweep(torch, coords):
    """One CoordinateDescent sweep; (result, wall seconds) on the host clock
    around work that ends in a device synchronize."""
    from photon_ml_tpu_torch.game import CoordinateDescent

    dev = coords["global"].dataset.batch.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = CoordinateDescent(coords, n_iterations=1).run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
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


def profile_sweep(torch, coords):
    """One more sweep under torch.profiler: the device's busy share of the
    sweep's wall and the device operations that fill it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sweep(torch, coords)
    rows = []
    for e in prof.key_averages():
        # the device's own events (kernels, copies, memsets): the operators
        # that launched them carry the same device time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    log(f"  profiled sweep: wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"busy_share={busy / wall:.3f} idle_share={1 - busy / wall:.3f} device_ops={launches}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"    {us * 1e-3:9.3f} ms  x{count:6d}  {key[:90]}")


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
    launches = dict(fg.LAUNCHES)
    res, wall = runs[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    fe_r, re_r = res.solver_results["global"], res.solver_results["per-user"]
    log(f"  GLMix sweep (kernels), median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) "
        f"shares FE={res.seconds['global'] / wall:.3f} RE={res.seconds['per-user'] / wall:.3f} "
        f"syncs={res.syncs} launches={launches} train_auc={a:.6f}")
    log(f"  FE: iterations={fe_r.iterations} reason={fe_r.reason} loss={float(fe_r.loss):.6f}; "
        f"RE: lanes={int(re_r.loss.shape[0])} max_iterations={int(re_r.iterations.max())} "
        f"reasons={torch.bincount(re_r.reason.cpu().long(), minlength=6).tolist()} "
        f"loss_sum={float(re_r.loss.sum()):.4f}")
    problems = []
    if min(launches.values()) <= 0:
        problems.append(f"a kernel of the GLMix sweep was not launched: {launches}")
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
        "launches": launches, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
        "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
        "syncs": res.syncs, "train_auc": a,
    }


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


def timings(torch, n, d, seed):
    """Per-call times at the main path's shape; the X of the main path is 2 GB
    (f32), far above the 50 MB L2, so every call reads it from device memory."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    out = {}
    loss = LOSSES["logistic"]
    for xname in ("float32", "bfloat16"):
        gen.manual_seed(seed + 7)
        x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)
        saved = dict(fg.LAUNCHES)
        row = {}
        for name, kern, plain, mode in (
            ("fused_value_grad",
             lambda: fg.fused_value_grad(x, coef, y, off, wt, loss),
             lambda: fg.value_grad_plain(x, coef, y, off, wt, loss), fg.VG),
            ("fused_hessian_vector",
             lambda: fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss),
             lambda: fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss), fg.HV),
            # as the main path calls it: no normalization, so no shifts
            ("fused_hessian_stats",
             lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, False),
             lambda: fg.hessian_stats_plain(x, coef, y, off, wt, loss, False), fg.HD),
        ):
            plain_a = time_ms(torch, plain, 10)
            ms_a = time_ms(torch, kern, 20)
            ms_b = time_ms(torch, kern, 20)
            plain_b = time_ms(torch, plain, 10)
            nbytes = fg.sweep_bytes(n, d, x.dtype, mode)
            ops = fg.sweep_flops(n, d, mode)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[xname] * 1e3
            row[name] = {
                "ms": min(ms_a, ms_b), "ms_runs": [ms_a, ms_b],
                "plain_ms": min(plain_a, plain_b), "plain_ms_runs": [plain_a, plain_b],
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
            }
            log(f"  time {xname:8s} {name:22s} kernel {ms_a:.4f}/{ms_b:.4f} ms  "
                f"plain(unfused composition) {plain_a:.4f}/{plain_b:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms ({row[name]['bound_by']}, {nbytes} B)  "
                f"achieved {nbytes / (min(ms_a, ms_b) * 1e-3) / 1e12:.3f} TB/s")
        fg.LAUNCHES.update(saved)  # timing launches are not main-path launches
        out[xname] = row
        del x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--d-re", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    errs = phases.run("kernels vs float64 plain", check_kernels, torch, args.n, args.d, args.seed)
    fe_launches = phases.run("fixed-effect path", fe_path, torch, args.n, args.d, args.seed)
    glmix = phases.run(
        "GLMix sweep (main path)", glmix_path, torch, args.n, args.d, args.users, args.d_re, args.seed
    )
    times = phases.run("timing", timings, torch, args.n, args.d, args.seed)

    if glmix:
        log(f"GLMix sweep: {args.n / glmix['wall_s']:.1f} examples/s (median wall {glmix['wall_s']:.4f} s "
            f"of {min(glmix['walls']):.4f}-{max(glmix['walls']):.4f}, "
            f"FE share {glmix['fe_share']:.3f}, RE share {glmix['re_share']:.3f}, "
            f"syncs {glmix['syncs']}, train AUC {glmix['train_auc']:.6f}) on {smi}")
    launches = (glmix or {}).get("launches", {})
    kernels = []
    for name in KERNELS:
        t = (times or {}).get("float32", {}).get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches.get(name, 0),
            "launches_fixed_effect_path": (fe_launches or {}).get(name, 0),
            "max_abs_err": (errs or {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "library_ms": None, "dtype": "float32",
            "bf16_ms": (times or {}).get("bfloat16", {}).get(name, {}).get("ms"),
        })
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
