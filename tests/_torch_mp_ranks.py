"""Rank bodies of the port's cross-process random-effect build tests
(tests/test_torch_re_build.py, test_torch_multihost.py, test_torch_cuda.py)
and of its streamed coordinates across ranks (tests/test_torch_stream_ranks.py).

``photon_ml_tpu_torch.parallel.spawn`` starts each rank in a fresh process
that imports this module by name; it imports neither JAX nor the JAX
package. A body takes the rank's ``DataParallelGroup``, cuts the rank's row
range out of a whole dataset's arrays (``host_row_range``), pads it to the
common share as ``cli.train`` does, builds through
``game.data_mp.build_random_effect_dataset_global`` and returns host
arrays."""

from __future__ import annotations

import os

import numpy as np
import torch

from photon_ml_tpu_torch.game import GLMOptimizationConfig, RandomEffectCoordinate, build_fixed_effect_dataset
from photon_ml_tpu_torch.game.data_mp import build_random_effect_dataset_global
from photon_ml_tpu_torch.game.fe_streaming import StreamedFEObjective
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.ops import fused_glm as fg
from photon_ml_tpu_torch.ops import sparse
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import equal_host_share, host_row_range

BLOCK_FIELDS = ("features", "labels", "offsets", "weights", "proj_cols", "active_rows")


def local_raw(raw_fields: dict, rank: int, world: int) -> RawDataset:
    """The rank's rows of a whole dataset, padded to the common share, with
    its first global row."""
    raw = RawDataset(**raw_fields)
    r0, r1 = host_row_range(raw.n_rows, rank, world)
    loc = raw.subset(np.arange(r0, r1))
    loc.global_row_start = r0
    return loc.pad_rows(equal_host_share(raw.n_rows, world))


def _host(ds) -> dict:
    out = {f: getattr(ds.blocks, f).cpu().clone() for f in BLOCK_FIELDS}
    out.update(
        entity_ids=[str(e) for e in ds.entity_ids],
        row_entity=ds.row_entity.cpu().clone(),
        ell_idx=ds.ell_idx.cpu().clone(),
        ell_val=ds.ell_val.cpu().clone(),
        passive_rows=np.asarray(ds.passive_rows),
        entity_counts=np.asarray(ds.entity_counts),
        entity_subspace_dims=np.asarray(ds.entity_subspace_dims),
        host_proj_cols=np.asarray(ds.host_proj_cols),
        n_rows=ds.n_rows,
    )
    return out


def builds(group, payload):
    """Every case of ``payload["cases"]`` (keyword sets of the build) on
    this rank, on ``payload["device"]`` (the CPU by default); with
    ``payload["train"]`` also a vmapped random-effect solve over the first
    case's dataset (coefficients and scores, whole)."""
    device = payload.get("device", "cpu")
    raw = local_raw(payload["raw"], group.rank, group.world_size)
    out = []
    for kw in payload["cases"]:
        ds = build_random_effect_dataset_global(
            raw, "re", payload["shard"], payload["re_type"], group, device=device, **kw
        )
        out.append(_host(ds))
    train = payload.get("train")
    if train:
        ds = build_random_effect_dataset_global(
            raw, "re", payload["shard"], payload["re_type"], group, device=device, dtype=torch.float64,
            **payload["cases"][0],
        )
        cfg = GLMOptimizationConfig(
            optimizer=OptimizerConfig(tolerance=train["tolerance"], max_iterations=train["max_iterations"]),
            regularization=RegularizationContext("L2"),
            reg_weight=train["reg_weight"],
        )
        os.environ["PHOTON_RE_SOLVER"] = "vmapped"
        coord = RandomEffectCoordinate(dataset=ds, task="logistic_regression", config=cfg)
        model, res = coord.train(None)
        scores = coord.score(model)
        out.append({
            "coef_values": model.coef_values.cpu().clone(), "entity_ids": [str(e) for e in model.entity_ids],
            "coef_indices": model.coef_indices.cpu().clone(), "scores": scores.cpu().clone(),
            "loss": res.loss.cpu().clone(),
        })
    return out


def streamed_objective(group, payload):
    """A streamed fixed effect over the ranks: for each layout of
    ``payload["layouts"]`` the rank's dataset built under a budget below its
    share (in ``payload["dtype"]``, float64 by default, on
    ``payload["device"]``, the CPU by default), then one value+grad and one
    Hv pass of ``StreamedFEObjective`` over its rows (its block of the
    global residual) at ``payload["w"]`` / ``payload["v"]``, each summed
    over every rank; with each layout's launches of B1, B2, the rank-order
    sum and S1."""
    device = payload.get("device", "cpu")
    dtype = getattr(torch, payload.get("dtype", "float64"))
    raw = local_raw(payload["raw"], group.rank, group.world_size)
    r0 = group.rank * raw.n_rows
    n_true = raw.true_rows if raw.true_rows is not None else raw.n_rows
    residual = torch.as_tensor(payload["residual"][r0 : r0 + n_true])
    counters = (fg.LAUNCHES, fg.SUM_LAUNCHES, sparse.SPARSE_LAUNCHES)
    out = {}
    for layout in payload["layouts"]:
        before = [dict(c) for c in counters]
        ds = build_fixed_effect_dataset(raw, "global", payload["shard"], dtype=dtype, layout=layout,
                                        hbm_budget_bytes=payload["budget"], group=group, device=device)
        obj = StreamedFEObjective(get_loss("logistic_regression"), ds.host_batch, payload["budget"],
                                  l2_weight=payload["l2"], residual_scores=residual, device=device, group=group)
        value, grad = obj.value_and_grad(torch.as_tensor(payload["w"]))
        hv = obj.hessian_vector(torch.as_tensor(payload["w"]), torch.as_tensor(payload["v"]))
        launches = {k: v - b[k] for c, b in zip(counters, before) for k, v in c.items() if v - b[k]}
        out[layout] = {"value": value.cpu().clone(), "grad": grad.cpu().clone(), "hv": hv.cpu().clone(),
                       "streamed": ds.streamed, "host_rows": ds.host_batch.n_rows, "n_rows": ds.n_rows,
                       "n_slices": obj.n_slices, "host_layout": ds.host_batch.layout, "launches": launches,
                       "ell_width": None if ds.host_batch.ell_idx is None else int(ds.host_batch.ell_idx.shape[1])}
    return out


def streamed_random_effect(group, payload):
    """A random effect built across the ranks under a budget below the
    rank's blocks, then trained streamed by each solver of
    ``payload["solvers"]``: the model's table, its layout and its entity
    ids, and the rank's entity range."""
    raw = local_raw(payload["raw"], group.rank, group.world_size)
    ds = build_random_effect_dataset_global(raw, "re", payload["shard"], payload["re_type"], group,
                                            dtype=torch.float64, hbm_budget_bytes=payload["budget"], device="cpu")
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=payload["tolerance"], max_iterations=payload["max_iterations"]),
        regularization=RegularizationContext("L2"),
        reg_weight=payload["reg_weight"],
    )
    out = {"streamed": ds.streamed, "range": ds.entity_shard_range, "block_rows": ds.blocks.features.shape[0]}
    for solver in payload["solvers"]:
        os.environ["PHOTON_RE_SOLVER"] = solver
        coord = RandomEffectCoordinate(dataset=ds, task="logistic_regression", config=cfg)
        model, res = coord.train(None)
        out[solver] = {
            "coef_values": model.coef_values.cpu().clone(), "coef_indices": model.coef_indices.cpu().clone(),
            "entity_ids": [str(e) for e in model.entity_ids], "loss": res.loss.cpu().clone(),
            "scores": coord.score(model).cpu().clone(),
        }
    return out
