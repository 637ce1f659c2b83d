"""Rank bodies for the data-parallel tests of the PyTorch port.

``photon_ml_tpu_torch.parallel.spawn`` starts each rank in a fresh process
that imports this module by name; it imports neither JAX nor the JAX
package, so no rank loads them. Every body takes the rank's
``DataParallelGroup`` and numpy inputs, runs the port's sharded path and
returns numpy results (the caller compares them with the JAX package and
across ranks). The module defines no test of its own: pytest collects
nothing here, and tests/test_torch_parallel.py and tests/test_torch_cuda.py
spawn its functions.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FixedEffectCoordinate,
    FixedEffectDataset,
    GLMOptimizationConfig,
    GLMProblem,
    RandomEffectCoordinate,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.ops import fused_glm as fg
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import (
    shard_batch,
    shard_fixed_effect_dataset,
    shard_random_effect_dataset,
)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def b4_outputs(group, case, device="cpu", dtype=torch.float32, plain=False):
    """B4's three functions on this rank's rows of one case (``x, coef, v,
    y, off, wt, vshift`` and a loss name) in ``dtype`` (``plain``: the
    plain versions, as the route plain_float64 runs them): the raw sums, as
    numpy."""
    loss = LOSSES[case["loss"]]
    batch = batch_from_dense(
        case["x"], case["y"], offsets=case["off"], weights=case["wt"], dtype=dtype, device=device
    )
    if group is not None:
        batch = shard_batch(batch, group)
    x = batch.features.dense
    coef, v = _t(case["coef"], device).to(dtype), _t(case["v"], device).to(dtype)
    vshift = torch.tensor(case["vshift"], dtype=dtype, device=device)
    args = (x, coef, batch.labels, batch.offsets, batch.weights)
    vg = fg.sharded_value_grad(group, *args, loss, plain=plain)
    hv = fg.sharded_hessian_vector(
        group, x, coef, v, batch.labels, batch.offsets, batch.weights, vshift, loss, plain=plain
    )
    hd = fg.sharded_hessian_stats(group, *args, loss, False, plain=plain)
    hds = fg.sharded_hessian_stats(group, *args, loss, True, plain=plain)
    return {k: tuple(_np(o) for o in outs) for k, outs in (("vg", vg), ("hv", hv), ("hd", hd), ("hds", hds))}


def _all_reduce_sum(group, outs):
    """The B4 reduction as first written, kept here as the reference of the
    bitwise check: the rank's outputs flattened in float64 into its slot of a
    zero ``[world, width]`` buffer (a host buffer on gloo), one
    ``all_reduce(SUM)`` filling every slot, the slots added in rank order in
    float64, each sum cast back to its output's dtype."""
    import torch.distributed as dist

    parts = [o for o in outs if o is not None]
    flat = torch.cat([o.reshape(-1).to(torch.float64) for o in parts])
    host = torch.device("cpu") if group.backend == "gloo" else flat.device
    buf = torch.zeros((group.world_size, flat.numel()), dtype=torch.float64, device=host)
    buf[group.rank] = flat.to(host)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.process_group)
    acc = buf[0]
    for r in range(1, group.world_size):
        acc = acc + buf[r]
    acc = acc.to(flat.device)
    summed, at = [], 0
    for o in parts:
        summed.append(acc[at : at + o.numel()].reshape(o.shape).to(o.dtype))
        at += o.numel()
    it = iter(summed)
    return tuple(None if o is None else next(it) for o in outs)


def b4_all_reduce_outputs(group, case, device="cpu"):
    """``b4_outputs`` through the all-reduce formulation above: the rank's
    unsharded calls on its rows, then ``_all_reduce_sum``."""
    loss = LOSSES[case["loss"]]
    batch = shard_batch(
        batch_from_dense(case["x"], case["y"], offsets=case["off"], weights=case["wt"], device=device),
        group,
    )
    x = batch.features.dense
    coef, v = _t(case["coef"], device), _t(case["v"], device)
    vshift = torch.tensor(case["vshift"], device=device)
    rows = (batch.labels, batch.offsets, batch.weights)
    calls = (
        ("vg", lambda: fg.fused_value_grad(x, coef, *rows, loss)),
        ("hv", lambda: fg.fused_hessian_vector(x, coef, v, *rows, vshift, loss)),
        ("hd", lambda: fg.fused_hessian_stats(x, coef, *rows, loss, False)),
        ("hds", lambda: fg.fused_hessian_stats(x, coef, *rows, loss, True)),
    )
    return {k: tuple(_np(o) for o in _all_reduce_sum(group, call())) for k, call in calls}


def gather_inputs(rank):
    """Per-rank tensors for the exactness check of the row gather: float32,
    float64 (wide magnitudes, inf, NaN) and integers up to 2**52."""
    rng = np.random.default_rng(100 + rank)
    f64 = rng.standard_normal((3, 4)) * 10.0 ** rng.integers(-300, 300, (3, 4))
    f64[0, 0], f64[1, 1] = np.inf, np.nan
    return [
        f64,
        rng.standard_normal((2, 5)).astype(np.float32),
        rng.integers(-(2**31), 2**31 - 1, (5,), dtype=np.int64).astype(np.int32),
        rng.integers(-(2**52), 2**52, (2, 2), dtype=np.int64),
    ]


def _padding_values(group, payload):
    """The f64 objective value of a whole batch and of its row shards."""
    x, y = payload["x"], payload["y"]
    whole = batch_from_dense(x, y, dtype=torch.float64, device="cpu")
    w = torch.ones(x.shape[1], dtype=torch.float64)
    shard = shard_batch(whole, group)
    loss = LOSSES["logistic"]
    v_whole = float(GLMObjective(loss=loss, batch=whole).value(w))
    v_shard = float(GLMObjective(loss=loss, batch=shard).value(w))
    return {"whole": v_whole, "shard": v_shard, "rows": shard.n_rows}


def _solve(group, payload):
    """GLMProblem.run (L-BFGS) on this rank's rows."""
    batch = batch_from_dense(
        payload["x"], payload["y"], offsets=payload["off"], weights=payload["wt"], device="cpu"
    )
    if group is not None:
        batch = shard_batch(batch, group)
    problem = GLMProblem(
        task="logistic_regression",
        config=GLMOptimizationConfig(
            optimizer=OptimizerConfig(tolerance=1e-9, max_iterations=60),
            regularization=RegularizationContext("L2"),
            reg_weight=1.0,
        ),
    )
    model, res = problem.run(batch)
    return {"means": _np(model.coefficients.means), "loss": float(res.loss), "iterations": res.iterations}


def glmix_coordinates(group, payload, dtype, sharded=True, device="cpu"):
    """The two GLMix coordinates of ``payload`` (dense ``gx``, RawDataset
    fields, optimizer settings) on ``device``, sharded over ``group`` when
    ``sharded``."""
    raw = RawDataset(**payload["raw"])
    reg = dict(regularization=RegularizationContext("L2"), reg_weight=1.0)
    fe_cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(**payload["fe_opt"]), **reg, **payload.get("fe_extra", {}))
    re_cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(**payload["re_opt"]), **reg)
    fe_ds = FixedEffectDataset(
        "global", "global", batch=batch_from_dense(payload["gx"], raw.labels, dtype=dtype, device=device)
    )
    re_ds = build_random_effect_dataset(
        raw, "per-user", payload["re_shard"], "userId", dtype=dtype, device=device,
        pad_entities_to_multiple=payload["pad_entities"], active_cap=payload.get("active_cap"),
    )
    if sharded:
        fe_ds = shard_fixed_effect_dataset(fe_ds, group)
        re_ds = shard_random_effect_dataset(re_ds, group)
    return {
        "global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=fe_cfg),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=re_cfg),
    }


def _descent(group, payload, dtype=torch.float64, sharded=True, device="cpu"):
    coords = glmix_coordinates(group, payload, dtype, sharded, device)
    res = CoordinateDescent(coords, n_iterations=payload["sweeps"]).run()
    fe_scores = coords["global"].score(res.model["global"])
    scores = fe_scores + coords["per-user"].score(res.model["per-user"])
    fe = res.model["global"].coefficients
    # the random effect read back from numpy has lost its provenance mark:
    # a warm start from it and its scores take the layout-comparing paths
    re_coord, re_model = coords["per-user"], res.model["per-user"]
    carried = convert.game_model_from_numpy(convert.game_model_to_numpy(res.model), dtype=dtype, device=device)
    warm = {
        "own": _np(re_coord.train(fe_scores, re_model)[0].coef_values),
        "carried": _np(re_coord.train(fe_scores, carried["per-user"])[0].coef_values),
        "score_own": _np(re_coord.score(re_model)),
        "score_carried": _np(re_coord.score(carried["per-user"])),
    }
    return {
        "warm": warm,
        "fe_scores": _np(fe_scores),
        "fe_means": _np(fe.means),
        "fe_variances": _np(fe.variances),
        "re_values": _np(res.model["per-user"].coef_values),
        "re_loss": _np(res.solver_results["per-user"].loss),
        "scores": _np(scores),
        "model": convert.game_model_to_numpy(res.model),
        "collectives": dict(res.collectives),
    }


def checks(group, payload):
    """Every multi-rank check the payload names, on this rank."""
    out = {}
    if "b4" in payload:
        before = (group.collectives, group.collective_seconds)
        out["b4"] = [b4_outputs(group, case) for case in payload["b4"]]
        out["b4_collectives"] = (group.collectives - before[0], group.collective_seconds - before[1])
        out["b4_all_reduce"] = [b4_all_reduce_outputs(group, case) for case in payload["b4"]]
    if "gather" in payload:
        parts = [torch.from_numpy(a) for a in gather_inputs(group.rank)]
        before = group.collectives
        out["gather"] = [_np(t) for t in group.gather_rows(parts)]
        out["gather_collectives"] = group.collectives - before
    if "pad" in payload:
        out["pad"] = _padding_values(group, payload["pad"])
    if "solve" in payload:
        out["solve"] = _solve(group, payload["solve"])
    if "cd" in payload:
        out["cd"] = _descent(group, payload["cd"])
    return out


def world_one(group, payload):
    """The same calls through a one-rank group and with no group at all:
    (group run, unsharded run) pairs for the caller to compare bitwise."""
    case = payload["b4"]
    fe = dict(payload["cd"], fe_extra={"variance_type": "SIMPLE"})
    fe["fe_opt"] = dict(fe["fe_opt"], optimizer_type="TRON")
    return {
        "b4": (b4_outputs(group, case), b4_outputs(None, case)),
        "b4_all_reduce": (b4_outputs(group, case), b4_all_reduce_outputs(group, case)),
        "solve": (_solve(group, payload["solve"]), _solve(None, payload["solve"])),
        "cd": (
            _descent(group, fe, torch.float32, sharded=True),
            _descent(group, fe, torch.float32, sharded=False),
        ),
    }


def descent_on_card(group, payload):
    """The f32 GLMix descent of ``payload`` on the rank's card, sharded."""
    return _descent(group, payload, torch.float32, True, group.device)


def card_case(dev, n, d, seed):
    """A logistic B4 case made on the card from ``seed`` (the same numbers
    in every process on the same card), as numpy."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    draw = {
        "x": torch.randn((n, d), generator=g, device=dev),
        "coef": torch.randn(d, generator=g, device=dev) * (0.5 / d**0.5),
        "v": torch.randn(d, generator=g, device=dev),
        "y": (torch.rand(n, generator=g, device=dev) > 0.5).float(),
        "off": torch.randn(n, generator=g, device=dev) * 0.1,
        "wt": torch.rand(n, generator=g, device=dev) + 0.5,
    }
    return dict({k: _np(t) for k, t in draw.items()}, loss="logistic", vshift=0.25)


def b4_on_card(group, n, d, seed):
    """B4 on this rank's rows of ``card_case``, with the launch counts of
    the rank's calls."""
    case = card_case(group.device, n, d, seed)
    fg.reset_launch_counts()
    out = b4_outputs(group, case, device=group.device)
    return {"outs": out, "launches": dict(fg.LAUNCHES), "sharded": dict(fg.SHARDED_LAUNCHES)}


def b4_float64_on_card(group, n, d, seed):
    """``card_case`` in float64 through B4's plain versions on the rank's
    card (the route plain_float64), with the launch counts."""
    case = card_case(group.device, n, d, seed)
    fg.reset_launch_counts()
    out = b4_outputs(group, case, device=group.device, dtype=torch.float64, plain=True)
    return {"outs": out, "launches": dict(fg.LAUNCHES), "sums": dict(fg.SUM_LAUNCHES)}


def b4_on_card_both(group, n, d, seed):
    """``card_case`` through B4 and through ``_all_reduce_sum``, on the
    rank's card, for the bitwise comparison."""
    case = card_case(group.device, n, d, seed)
    return {
        "b4": b4_outputs(group, case, device=group.device),
        "all_reduce": b4_all_reduce_outputs(group, case, device=group.device),
    }


def b4_without_host_sync(group, n, d, seed):
    """B4's four calls on the rank's card with CUDA's sync debug mode at
    "error" and ``torch.cuda.synchronize`` counting its calls, after a
    warm-up of the same calls (which also makes the backend's communicator).
    Returns the synchronizes, the collectives and their seconds, the launch
    counts, and the outputs of both runs, of the unsharded calls and of
    ``_all_reduce_sum``."""
    case = card_case(group.device, n, d, seed)
    dev = group.device
    batch = shard_batch(
        batch_from_dense(case["x"], case["y"], offsets=case["off"], weights=case["wt"], device=dev), group
    )
    x, rows = batch.features.dense, (batch.labels, batch.offsets, batch.weights)
    coef, v = _t(case["coef"], dev), _t(case["v"], dev)
    vshift = torch.tensor(case["vshift"], device=dev)
    loss = LOSSES[case["loss"]]

    def calls():
        return {
            "vg": fg.sharded_value_grad(group, x, coef, *rows, loss),
            "hv": fg.sharded_hessian_vector(group, x, coef, v, *rows, vshift, loss),
            "hd": fg.sharded_hessian_stats(group, x, coef, *rows, loss, False),
            "hds": fg.sharded_hessian_stats(group, x, coef, *rows, loss, True),
        }

    warm = calls()
    torch.cuda.synchronize(dev)
    fg.reset_launch_counts()
    before = (group.collectives, group.collective_seconds)
    real, syncs = torch.cuda.synchronize, []
    torch.cuda.synchronize = lambda *a, **k: (syncs.append(1), real(*a, **k))[1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = real
    counts = {
        "launches": dict(fg.LAUNCHES), "sharded": dict(fg.SHARDED_LAUNCHES), "sums": dict(fg.SUM_LAUNCHES),
        "collectives": group.collectives - before[0], "seconds": group.collective_seconds - before[1],
    }
    as_np = lambda outs: {k: tuple(_np(o) for o in v) for k, v in outs.items()}  # noqa: E731
    return dict(
        counts, syncs=len(syncs), got=as_np(got), warm=as_np(warm),
        unsharded=b4_outputs(None, case, device=dev), all_reduce=b4_all_reduce_outputs(group, case, device=dev),
    )


def fail_on_rank_one(group):
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    group.barrier()  # rank 0 waits here until it is stopped


def hang(group, seconds):
    import time

    time.sleep(seconds)


def full_variance(group, payload):
    """FULL variance (the Hessian and the diagonal of its inverse) of
    ``payload``'s logistic batch at ``w``: this rank's rows over ``group``,
    or the whole batch with ``group=None``; with ``payload["chunk_bytes"]``
    the Hessian is built and summed over the ranks in chunks of that many
    bytes."""
    from photon_ml_tpu_torch.ops import glm

    if payload.get("chunk_bytes"):
        glm.HESSIAN_CHUNK_BYTES = payload["chunk_bytes"]
    batch = batch_from_dense(payload["x"], payload["y"], dtype=torch.float64, device="cpu")
    if group is not None:
        batch = shard_batch(batch, group)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch, l2=0.5)
    w = _t(payload["w"])
    return {"hessian": _np(obj.hessian_matrix(w)), "variances": _np(compute_variances(obj, w, "FULL"))}


def full_variance_on_card(group, payload):
    """The FULL Hessian of ``payload``'s logistic batch over ``group`` on
    the rank's card: float32 through the rank-order sum kernel, then with
    ``plain=True`` (no launch), and a float64 batch with and without
    ``plain`` (without it the kernel refuses float64). Returns the
    Hessians, the unsharded float32 one, and the kernel's launches."""
    dev = group.device

    def objective(dtype, plain=False, shard=True):
        batch = batch_from_dense(payload["x"], payload["y"], dtype=dtype, device=dev)
        batch = shard_batch(batch, group) if shard else batch
        return GLMObjective(loss=LOSSES["logistic"], batch=batch, l2=1.0, plain=plain)

    w = _t(payload["w"], dev)
    fg.reset_launch_counts()
    out = {"kernel": _np(objective(torch.float32).hessian_matrix(w.float()))}
    out["launches"] = dict(fg.SUM_LAUNCHES)
    out["plain"] = _np(objective(torch.float32, plain=True).hessian_matrix(w.float()))
    out["unsharded"] = _np(objective(torch.float32, shard=False).hessian_matrix(w.float()))
    out["float64_plain"] = _np(objective(torch.float64, plain=True).hessian_matrix(w.double()))
    try:
        objective(torch.float64).hessian_matrix(w.double())
        out["float64_refused"] = ""
    except TypeError as e:
        out["float64_refused"] = str(e)
    out["launches_after"] = dict(fg.SUM_LAUNCHES)
    return out


def down_sampled_weights(group, payload):
    """``game/sampling.py``'s down-sampled weights of this rank's shard of
    ``payload``'s batch (with the whole batch's row count, as the fixed
    effect passes it), cut to the rank's real rows."""
    from photon_ml_tpu_torch.game.sampling import down_sample
    from photon_ml_tpu_torch.parallel import row_range

    n = payload["y"].shape[0]
    batch = batch_from_dense(payload["x"], payload["y"], weights=payload["wt"], device="cpu")
    batch = shard_batch(batch, group)
    out = down_sample(batch, payload["task"], payload["rate"], payload["seed"], n_rows=n)
    start, stop = row_range(n, group)
    return _np(out.weights[: stop - start])
