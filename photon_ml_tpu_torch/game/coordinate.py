"""GAME coordinates: the training and scoring unit of coordinate descent.

Counterpart of the JAX package's ``game/coordinate.py``:

- ``FixedEffectCoordinate``: one GLM solve over the whole resident batch,
  dense or sparse (``GLMProblem.run``: the CUDA kernels on the card), with
  the other coordinates' scores added to the offsets;
- ``RandomEffectCoordinate``: all entities' problems solved in lockstep by
  the batched L-BFGS or TRON, one solve per power-of-two size bucket
  (``_size_buckets``): over entity-minor stacks by default
  (``_train_blocks_packed``), or with ``PHOTON_RE_SOLVER=vmapped`` over
  entity-leading ones with per-lane history cursors (``_train_blocks``,
  the JAX package's vmapped solve, whose entity results do not depend on
  the other entities of their bucket). The solvers run as torch ops, since
  the JAX package's random-effect path is XLA code and not a Pallas kernel.

Scores returned by coordinates never include the base offsets: the
coordinate-descent loop owns residual composition.

A tiled fixed effect (``parallel/sparse.py``) solves on every rank of its
(data x model) grid and scores through its tiles: the model comes back
whole on every rank and is trimmed to the shard's true dimension, and the
scores are its data row's block, gathered over the data axis as a row
shard's are. Random effects keep the data axis only (the JAX package
shards entity blocks over "data"): the ranks of a data row hold the same
entities and end bitwise alike.

On datasets sharded over a data-parallel group (``parallel.mesh``), every
rank runs the same calls: the fixed effect solves over its row shard with
every sweep summed across the ranks and returns the same model on every
rank, its scores gathered into the whole ``[n]``; the random effect solves
the rank's entity range and gathers every rank's results, so its model is
whole on every rank and scores as an unsharded one does (a dataset built
across processes, ``game/data_mp.py``, scores its rank's rows and gathers
every rank's). Scores, residuals and models are the same, bitwise, on every
rank.

The fixed effect down-samples its training batch when its config asks
(``game/sampling.py``: a keep mask drawn on the batch's device from a
``torch.Generator`` seeded with ``down_sampling_seed``; over a data-parallel
group every rank draws the whole mask and keeps its rows).

Both coordinates carry the fault site ``solver.value_and_grad`` on the
effective offsets of their solve (``robust.faults``).

Both coordinates train lambda lanes too (``train_lanes`` / ``score_lanes``,
the sweep executor ``game/lanes.py``): the fixed effect through
``GLMProblem.run_lanes`` (``[d, L]``), the random effect through
``_train_blocks_packed_lanes``, one entity-minor ``[S, E, L]`` solve over
the full ``[E, K, S]`` blocks without size buckets, as the JAX package
does (a bucket's padding would land on the lane axis).

Incremental training: a ``prior_model`` centres each coordinate's L2 on a
prior model (the fixed effect's through ``GLMProblem``'s prior, the random
effect's as per-entity prior means and precisions projected into the day's
blocks), and ``ModelCoordinate`` locks a pretrained model (partial
retraining).

Streamed (out-of-core) datasets, the JAX package's: the fixed effect trains
through ``GLMProblem.run_streamed`` (row slices of the host batch through
the card, ``game/fe_streaming.py``) and scores by streaming the same
slices; the random effect solves entity slices of its host blocks one after
another with the same solvers (``game/streaming.py``), its model a table in
host memory, and scores by streaming that table. Neither takes trial lanes.
Across processes each rank streams its own share: the fixed effect its
true rows (each pass summed over the ranks in (rank, slice) order), the
random effect its ``entity_shard_range`` (the results gathered in rank
order, so every rank holds the whole table); both score the rank's rows
and gather every rank's into the padded global row space.
The streamed fixed effect refuses down-sampling (and, in
``run_streamed``, variances), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import fetch
from ..models.coefficients import Coefficients
from ..models.game import (
    FixedEffectModel,
    RandomEffectModel,
    ell_row_subspace,
    score_entity_rows_dense,
    score_entity_rows_dense_lanes,
)
from ..ops.lane_reduce import lane_reduce
from ..ops.losses import get_loss
from ..ops.normalization import NormalizationContext
from ..optimize import OptimizerType, SolverResult, SyncCounter, solve_lbfgs, solve_tron
from ..optimize.common import LEADING, MINOR, abs_tolerances
from ..robust import faults
from .data import FixedEffectDataset, RandomEffectDataset
from .problem import GLMOptimizationConfig, GLMProblem, batch_route
from .sampling import down_sample, local_rows

Tensor = torch.Tensor


class Coordinate:
    """Base coordinate API."""

    coordinate_id: str

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    @property
    def group(self):
        """The data-parallel group the coordinate's dataset is sharded
        over, or None."""
        return None

    def train(self, residual_scores: Optional[Tensor], initial_model):
        """-> (model, SolverResult). residual_scores f[n] are the OTHER
        coordinates' summed scores, added to base offsets for this solve."""
        raise NotImplementedError

    def score(self, model) -> Tensor:
        """Per-sample scores of this coordinate's model, excluding offsets."""
        raise NotImplementedError


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    """Whole-dataset GLM solve over a resident batch (dense, ELL or sorted
    COO). ``plain=True`` runs the plain PyTorch versions of the kernels on
    the card, in the solve and in the scores: a reference sweep to hold the
    kernels' sweep against."""

    dataset: FixedEffectDataset
    task: str
    config: GLMOptimizationConfig
    normalization: Optional[NormalizationContext] = None
    down_sampling_seed: int = 0
    # incremental training: regularize toward this model instead of zero
    prior_model: Optional[FixedEffectModel] = None
    plain: bool = False

    def __post_init__(self):
        self.coordinate_id = self.dataset.coordinate_id

    @property
    def n_rows(self) -> int:
        return self.dataset.n_rows

    @property
    def group(self):
        return self.dataset.group if self.dataset.streamed else self.dataset.batch.group

    def train(
        self,
        residual_scores: Optional[Tensor],
        initial_model: Optional[FixedEffectModel] = None,
    ) -> Tuple[FixedEffectModel, SolverResult]:
        if self.dataset.streamed:
            return self._train_streamed(residual_scores, initial_model)
        batch = self.dataset.batch
        if residual_scores is not None:
            residual = residual_scores.to(batch.offsets.dtype)
            if batch.group is not None:
                residual = local_rows(residual, batch.n_rows, batch.group)
            batch = dataclasses.replace(batch, offsets=batch.offsets + residual)
        if self.config.down_sampling_rate < 1.0:
            batch = down_sample(
                batch, self.task, self.config.down_sampling_rate, self.down_sampling_seed,
                n_rows=self.dataset.n_rows,
            )
        if faults.active():
            # fault site solver.value_and_grad: the effective offsets of
            # this solve
            batch = dataclasses.replace(batch, offsets=faults.corrupt("solver.value_and_grad", batch.offsets))
        glm, result = self._problem().run(
            batch, initial_model=initial_model.model if initial_model else None, plain=self.plain
        )
        # models live in the shard's true feature space: a tiled batch's
        # solution (whole on every rank of its grid) loses its padding
        d_true = self.dataset.dim
        if glm.coefficients.means.shape[0] > d_true:
            c = glm.coefficients
            glm = dataclasses.replace(glm, coefficients=Coefficients(
                means=c.means[:d_true], variances=None if c.variances is None else c.variances[:d_true],
            ))
        return FixedEffectModel(model=glm, feature_shard=self.dataset.feature_shard), result

    def _problem(self) -> GLMProblem:
        return GLMProblem(
            task=self.task,
            config=self.config,
            normalization=self.normalization,
            prior=self.prior_model.model.coefficients if self.prior_model else None,
        )

    def _train_streamed(
        self,
        residual_scores: Optional[Tensor],
        initial_model: Optional[FixedEffectModel] = None,
    ) -> Tuple[FixedEffectModel, SolverResult]:
        """The out-of-core solve: the host rows streamed through the card in
        double-buffered row slices (``GLMProblem.run_streamed``). Over a
        group the objective gets the rank's block of the global residual,
        trimmed of the padding rows, and each pass sums every rank's."""
        ds = self.dataset
        hb = ds.host_batch
        if ds.group is not None and residual_scores is not None:
            share = ds.n_rows // ds.group.world_size
            residual_scores = local_rows(residual_scores, share, ds.group)[: hb.n_rows]
        if self.config.down_sampling_rate < 1.0:
            raise ValueError(
                f"coordinate {self.coordinate_id}: down_sampling_rate < 1 is"
                " not supported on the streamed fixed-effect path; raise"
                " hbm.budget.mb so the batch is HBM-resident, or disable"
                " down-sampling"
            )
        if faults.active():
            # the resident path's fault site, on the host offsets of this solve
            hb = dataclasses.replace(hb, offsets=faults.corrupt("solver.value_and_grad", hb.offsets))
        glm, result = self._problem().run_streamed(
            hb, ds.hbm_budget_bytes, residual_scores=residual_scores,
            initial_model=initial_model.model if initial_model else None, device=ds.device, plain=self.plain,
            group=ds.group,
        )
        return FixedEffectModel(model=glm, feature_shard=ds.feature_shard), result

    def score(self, model: FixedEffectModel) -> Tensor:
        if self.dataset.streamed:
            from .fe_streaming import score_streamed_fe

            ds = self.dataset
            dtype = ds.host_batch.labels.dtype
            means = model.model.coefficients.means.to(device=ds.device, dtype=dtype)
            plain = self.plain or dtype == torch.float64
            scores = score_streamed_fe(ds.host_batch, means, ds.hbm_budget_bytes, dtype, device=ds.device, plain=plain)
            if ds.group is not None:
                # the rank's rows padded to its share, then every rank's in
                # rank order: the padded global row space
                share = ds.n_rows // ds.group.world_size
                scores = torch.cat([scores, scores.new_zeros(share - scores.shape[0])])
                (scores,) = ds.group.gather_rows([scores])
            return scores
        # compute in the dataset's dtype: a warm-start model in another dtype
        # must not change the dtype of the score stream
        batch = self.dataset.batch
        dtype = batch.labels.dtype
        means = model.model.coefficients.means.to(device=batch.device, dtype=dtype)
        # a float64 batch on the card scores by the plain versions, as it solves
        plain = self.plain or batch_route(batch) == "plain_float64"
        f = batch.features
        if f.layout == "tiled":
            # the rank's model slice of the padded means
            if means.shape[0] < f.dim:
                means = torch.cat([means, means.new_zeros(f.dim - means.shape[0])])
            means = f.mesh.model_slice(means)
        scores = f.matvec(means, plain=plain)
        if batch.group is not None:
            # every rank's rows, in rank order, then the padding cut off
            (scores,) = batch.group.gather_rows([scores])
            scores = scores[: self.dataset.n_rows]
        return scores

    def train_lanes(
        self,
        residual_lanes: Tensor,  # f[n, L] per-lane residual scores
        l2_lanes,  # f[L] per-lane L2 weights
        w0_lanes: Optional[Tensor] = None,  # f[d_true, L] warm start
    ) -> Tuple[Tensor, SolverResult]:
        """Lane-stacked train: L lambda candidates share this batch and one
        solve. Returns (coefficients f[d_true, L], per-lane SolverResult).
        The fault site mirrors :meth:`train`: flat index 0 of the ``[n, L]``
        offsets is row 0 of lane 0, so an injected NaN poisons one lane."""
        _refuse_streamed_lanes(self)
        if self.config.down_sampling_rate < 1.0:
            raise ValueError("down-sampling is not supported with trial-lanes")
        batch = self.dataset.batch
        L = residual_lanes.shape[1]
        residual_lanes = residual_lanes.to(batch.offsets.dtype)
        n_pad = batch.n_rows - residual_lanes.shape[0]
        if n_pad > 0:
            residual_lanes = torch.cat([residual_lanes, residual_lanes.new_zeros((n_pad, L))])
        offsets_lanes = batch.offsets[:, None] + residual_lanes
        if faults.active():
            offsets_lanes = faults.corrupt("solver.value_and_grad", offsets_lanes)
        if w0_lanes is not None and w0_lanes.shape[0] < batch.dim:
            w0_lanes = torch.cat([w0_lanes, w0_lanes.new_zeros((batch.dim - w0_lanes.shape[0], L))])
        W, result = self._problem().run_lanes(batch, offsets_lanes, l2_lanes, w0=w0_lanes, plain=self.plain)
        return W[: self.dataset.dim], result

    def score_lanes(self, W: Tensor) -> Tensor:
        """Per-sample scores ``[n, L]`` of lane-stacked coefficients
        ``W[d, L]``: one ``matmat`` for every lane."""
        batch = self.dataset.batch
        W = W.to(device=batch.device, dtype=batch.labels.dtype)
        d_pad = batch.dim - W.shape[0]
        if d_pad > 0:
            W = torch.cat([W, W.new_zeros((d_pad, W.shape[1]))])
        plain = self.plain or batch_route(batch) == "plain_float64"
        return batch.features.matmat(W, plain=plain)[: self.dataset.n_rows]


@dataclasses.dataclass
class RandomEffectCoordinate(Coordinate):
    """Entity-blocked batched solves: every entity is one lane of one
    lockstep L-BFGS per size bucket, each lane converging and freezing on
    its own."""

    dataset: RandomEffectDataset
    task: str
    config: GLMOptimizationConfig
    # incremental training: per-entity prior means and precisions
    prior_model: Optional[RandomEffectModel] = None

    def __post_init__(self):
        self.coordinate_id = self.dataset.coordinate_id

    @property
    def n_rows(self) -> int:
        return self.dataset.n_rows

    @property
    def group(self):
        return self.dataset.group

    def train(
        self,
        residual_scores: Optional[Tensor],
        initial_model: Optional[RandomEffectModel] = None,
    ) -> Tuple[RandomEffectModel, SolverResult]:
        if self.dataset.streamed:
            return self._train_streamed(residual_scores, initial_model)
        train = _train_fn()
        ds = self.dataset
        group = ds.group
        blocks = ds.blocks
        E, K, S = blocks.features.shape  # E: this rank's entities when sharded
        # solver state stays in the wide dtype: features may be stored bf16
        dtype, dev = blocks.labels.dtype, blocks.labels.device

        if residual_scores is not None:
            rows = torch.clamp(blocks.active_rows, min=0).long()
            res_blocks = residual_scores[rows] * (blocks.active_rows >= 0)
            offsets = blocks.offsets + res_blocks.to(dtype)
        else:
            offsets = blocks.offsets
        if faults.active():
            # the fixed effect's fault site; flat index 0 of the [E, K]
            # offsets is entity 0's first row, so exactly one lane diverges
            offsets = faults.corrupt("solver.value_and_grad", offsets)
        lo = 0 if group is None else group.rank * E
        if initial_model is not None:
            w0 = _project_model_values(ds, initial_model, initial_model.coef_values, dtype)
            w0 = w0[lo : lo + E]
        else:
            w0 = torch.zeros((E, S), dtype=dtype, device=dev)
        prior_mean, prior_prec = self._prior(dtype)
        prior_mean, prior_prec = prior_mean[lo : lo + E], prior_prec[lo : lo + E]

        solver_kwargs = self._solver_kwargs()
        # over several ranks the segments come from the global counts with
        # their bounds snapped up to the ranks' entity chunks (the JAX
        # package's align), so each is a union of whole rank ranges: a rank
        # solves the one its range lies in
        sharded = group is not None and group.world_size > 1
        segments = _size_buckets(ds, align=E if sharded else 1)
        if segments is not None and sharded:
            segments = [(0, E, kb, sb) for start, end, kb, sb in segments if start <= lo < end]
        if segments is None:
            results = train(
                blocks.features, blocks.labels, offsets, blocks.weights,
                w0, prior_mean, prior_prec, **solver_kwargs,
            )
        else:
            # size-bucketed solves: entities are sorted by descending row
            # count, so each (K, S)-rounded bucket is a contiguous segment and
            # small entities do not pay the padding of the largest
            parts = []
            for start, end, kb, sb in segments:
                parts.append(
                    train(
                        blocks.features[start:end, :kb, :sb],
                        blocks.labels[start:end, :kb],
                        offsets[start:end, :kb],
                        blocks.weights[start:end, :kb],
                        w0[start:end, :sb],
                        prior_mean[start:end, :sb],
                        prior_prec[start:end, :sb],
                        **solver_kwargs,
                    )
                )
            results = _concat_results(parts, S)
        if group is not None:
            results = _gather_results(results, group)
        coef_indices = _layout(ds)
        valid = coef_indices >= 0
        model = RandomEffectModel(
            random_effect_type=ds.random_effect_type,
            feature_shard=ds.feature_shard,
            task=self.task,
            entity_ids=ds.entity_ids,
            coef_indices=coef_indices,
            coef_values=torch.where(valid, results.coefficients, torch.zeros((), dtype=dtype, device=dev)),
        )
        # provenance mark (a weakref, so the model does not pin the dataset):
        # this model's support layout is this dataset's block layout, so
        # score() takes the cached fast path without comparing index arrays
        object.__setattr__(model, "_support_layout_of", weakref.ref(ds))
        return model, results

    def train_lanes(
        self,
        residual_lanes: Tensor,  # f[n, L] per-lane residual scores
        l2_lanes,  # f[L] per-lane L2 weights
        w0_lanes: Optional[Tensor] = None,  # f[E, S, L] warm start
    ) -> Tuple[Tensor, SolverResult]:
        """Lane-stacked train: every (entity, lambda) pair is one lockstep
        solver lane. Returns (coef_values f[E, S, L] zeroed outside each
        entity's support, SolverResult with loss and reason ``[E, L]``).

        No size buckets: they pad the trailing axis, which here is the lane
        axis; one full-shape solve keeps the layout plain, as in the JAX
        package. The fault site mirrors :meth:`train`: flat index 0 of the
        ``[E, K, L]`` offsets is entity 0, row 0, lane 0."""
        _refuse_streamed_lanes(self)
        if self.prior_model is not None:
            raise ValueError("regularize-by-prior is not supported with trial-lanes")
        ds = self.dataset
        if ds.group is not None:
            raise ValueError("trial-lanes sweeps are single-process: an entity-sharded dataset takes no lanes")
        blocks = ds.blocks
        E, K, S = blocks.features.shape
        dtype, dev = blocks.labels.dtype, blocks.labels.device
        L = residual_lanes.shape[1]
        rows = torch.clamp(blocks.active_rows, min=0).long()
        res = residual_lanes[rows] * (blocks.active_rows >= 0)[:, :, None]
        offsets_lanes = blocks.offsets[:, :, None] + res.to(dtype)
        if faults.active():
            offsets_lanes = faults.corrupt("solver.value_and_grad", offsets_lanes)
        if w0_lanes is None:
            w0 = torch.zeros((E, S, L), dtype=dtype, device=dev)
        else:
            w0 = w0_lanes.to(device=dev, dtype=dtype)
        solver_kwargs = self._solver_kwargs()
        if solver_kwargs.pop("l1") > 0.0:
            raise ValueError(
                "trial-lanes sweeps support L2 regularization only (the "
                "OWL-QN l1 weight is compile-time static, not a per-lane "
                "operand)"
            )
        del solver_kwargs["l2"]  # replaced by the per-lane l2_lanes operand
        results = _train_blocks_packed_lanes(
            blocks.features, blocks.labels, offsets_lanes, blocks.weights, w0,
            torch.as_tensor(l2_lanes, dtype=dtype, device=dev), **solver_kwargs,
        )
        valid = blocks.proj_cols >= 0
        W = torch.where(valid[:, :, None], results.coefficients, torch.zeros((), dtype=dtype, device=dev))
        return W, results

    def score_lanes(self, coef_values: Tensor) -> Tensor:
        """Per-sample scores ``[n, L]`` of lane-stacked per-entity
        coefficients ``[E, S, L]``, through the dataset's cached densified
        subspace (one row gather and a dot for all L lanes)."""
        ds = self.dataset
        cache = getattr(ds, "_score_xsub_cache", None)
        if cache is None:
            cache = ell_row_subspace(_layout(ds), ds.row_entity, ds.ell_idx, ds.ell_val)
            object.__setattr__(ds, "_score_xsub_cache", cache)
        score_dt = torch.promote_types(ds.ell_val.dtype, ds.blocks.labels.dtype)
        vals = coef_values.to(device=ds.device, dtype=score_dt)
        return score_entity_rows_dense_lanes(vals, ds.row_entity, cache.to(score_dt))

    def _train_streamed(
        self,
        residual_scores: Optional[Tensor],
        initial_model: Optional[RandomEffectModel] = None,
    ) -> Tuple[RandomEffectModel, SolverResult]:
        """The out-of-core solve: host blocks streamed through the card in
        double-buffered entity slices (``game/streaming.py``); the model's
        tables stay in host memory. Built across processes
        (``entity_shard_range``): the warm start and the priors are
        projected in the global entity layout and cut to the rank's range,
        the residual stays whole (the blocks index the padded global rows),
        the rank solves its range and every rank's results are gathered in
        rank order, so every rank holds the whole table."""
        from .streaming import solve_streamed

        ds = self.dataset
        blocks = ds.blocks  # host tensors: the rank's range when sharded
        E, K, S = blocks.features.shape
        dtype = blocks.labels.dtype  # the solve dtype (features may be narrower)
        shard = ds.entity_shard_range
        if initial_model is not None:
            w0 = _project_model_values(ds, initial_model, initial_model.coef_values, dtype)
        else:
            w0 = torch.zeros((ds.num_entities, S), dtype=dtype)
        prior_mean, prior_prec = self._prior(dtype)
        if shard is not None:
            lo, hi = shard
            w0, prior_mean, prior_prec = w0[lo:hi], prior_mean[lo:hi], prior_prec[lo:hi]
        segments = _size_buckets(ds, entity_range=shard) or [(0, E, K, S)]
        results = solve_streamed(
            blocks, segments, residual_scores, w0, prior_mean, prior_prec, ds.hbm_budget_bytes,
            _train_fn(), self._solver_kwargs(), device=ds.device,
        )
        coef_indices = blocks.proj_cols
        if shard is not None:
            results = _gather_results(results, ds.group)
            coef_indices = torch.as_tensor(ds.host_proj_cols, dtype=torch.int32)
        valid = coef_indices >= 0
        model = RandomEffectModel(
            random_effect_type=ds.random_effect_type,
            feature_shard=ds.feature_shard,
            task=self.task,
            entity_ids=ds.entity_ids,
            coef_indices=coef_indices,
            coef_values=torch.where(valid, results.coefficients, torch.zeros((), dtype=results.coefficients.dtype)),
        )
        object.__setattr__(model, "_support_layout_of", weakref.ref(ds))
        return model, results

    def _score_streamed(self, model: RandomEffectModel) -> Tensor:
        """Scores of the rows a streamed dataset's scoring arrays hold: the
        model's table, in this dataset's whole layout and in host memory,
        streamed through the rows' device (``streaming.score_streamed``, its
        cache on the dataset)."""
        from .streaming import score_streamed

        ds = self.dataset
        sdt = ds.blocks.labels.dtype
        same_ids = model.entity_ids is ds.entity_ids or list(map(str, ds.entity_ids)) == list(
            map(str, model.entity_ids))
        if same_ids and self._support_layout_matches(model):
            vals = model.coef_values
            if vals.device.type != "cpu":
                (host,) = fetch("coordinate.stream_score_model", [vals])
                vals = torch.from_numpy(host)
            vals = vals.to(sdt)
        else:
            vals = _project_model_values(ds, model, model.coef_values, sdt)
        # the rows index global block rows: the whole layout
        scores, cache = score_streamed(
            vals, _layout(ds), ds.row_entity, ds.ell_idx, ds.ell_val, ds.hbm_budget_bytes,
            getattr(ds, "_stream_xsub_cache", None), score_dtype=torch.promote_types(ds.ell_val.dtype, sdt),
        )
        object.__setattr__(ds, "_stream_xsub_cache", cache)
        return scores

    def _prior(self, dtype) -> Tuple[Tensor, Tensor]:
        """Per-entity prior means and precisions ``[E, S]`` in the dataset's
        block layout: zeros and ones (plain L2) without a prior model, else
        the prior's values projected by (entity, feature column), and
        ``1 / max(variance, 1e-12)`` where the prior carries a variance for
        the entry. An entry the prior lacks (an entity new to the day, or a
        column new to a known entity) takes mean 0 and precision 1."""
        layout = _layout(self.dataset)
        E, S = layout.shape
        dev = self.dataset.blocks.labels.device
        prior = self.prior_model
        if prior is None:
            return (torch.zeros((E, S), dtype=dtype, device=dev),
                    torch.ones((E, S), dtype=dtype, device=dev))
        mean = _project_model_values(self.dataset, prior, prior.coef_values, dtype)
        if prior.variances is None:
            return mean, torch.ones((E, S), dtype=dtype, device=dev)
        var = _project_model_values(self.dataset, prior, prior.variances, dtype, fill=1.0)
        return mean, 1.0 / torch.clamp(var, min=1e-12)

    def _solver_kwargs(self) -> dict:
        cfg = self.config
        solver_cfg = cfg.solver_config()
        return dict(
            task=self.task,
            l2=cfg.regularization.l2_weight(cfg.reg_weight),
            l1=solver_cfg.l1_weight,
            optimizer_type=OptimizerType(solver_cfg.normalized_type()).value,
            tolerance=solver_cfg.tolerance,
            max_iterations=solver_cfg.max_iterations,
            num_corrections=solver_cfg.num_corrections,
            max_cg_iterations=solver_cfg.max_cg_iterations,
            max_improvement_failures=solver_cfg.max_improvement_failures,
        )

    def _support_layout_matches(self, model: RandomEffectModel) -> bool:
        """True when model.coef_indices is this dataset's own block layout
        (the coordinate-descent case): by provenance, by identity, or else by
        comparing the index arrays (one fetch)."""
        ds = self.dataset
        prov = getattr(model, "_support_layout_of", None)
        if prov is not None and prov() is ds:
            return True
        ci = model.coef_indices
        pc = _layout(ds)
        if ci is pc:
            return True
        return tuple(ci.shape) == tuple(pc.shape) and bool(torch.equal(ci.to(pc.device), pc))

    def score(self, model: RandomEffectModel) -> Tensor:
        ds = self.dataset
        scores = self._score_streamed(model) if ds.streamed else self._score_rows(model)
        if ds.local_rows:
            # built across processes: every rank's padded rows, in rank order
            (scores,) = ds.group.gather_rows([scores])
        return scores

    def _score_rows(self, model: RandomEffectModel) -> Tensor:
        """Scores of the rows the dataset's scoring arrays hold."""
        ds = self.dataset
        row_entity = ds.row_entity
        score_dt = torch.promote_types(ds.ell_val.dtype, ds.blocks.labels.dtype)
        ds_ids = list(map(str, ds.entity_ids))
        m_ids = list(map(str, model.entity_ids))
        if ds_ids == m_ids and self._support_layout_matches(model):
            # coordinate-descent hot path: densify the rows' features into
            # the entity-subspace layout once (cached on the dataset); each
            # score is then a row gather and an elementwise dot
            cache = getattr(ds, "_score_xsub_cache", None)
            if cache is None:
                cache = ell_row_subspace(model.coef_indices, row_entity, ds.ell_idx, ds.ell_val)
                object.__setattr__(ds, "_score_xsub_cache", cache)
            vals = model.coef_values.to(device=ds.device, dtype=score_dt)
            return score_entity_rows_dense(vals, row_entity, cache.to(score_dt))
        # the model's entity rows or support differ from this dataset's (a
        # model loaded from elsewhere): remap block rows to model rows by id
        if ds_ids != m_ids:
            block_to_model = torch.as_tensor(
                model.rows_for(ds.entity_ids), dtype=torch.int32, device=ds.device
            )
            row_entity = torch.where(
                row_entity >= 0, block_to_model[torch.clamp(row_entity, min=0).long()], -1
            ).to(torch.int32)
        scoring = dataclasses.replace(
            model,
            coef_indices=model.coef_indices.to(ds.device),
            coef_values=model.coef_values.to(device=ds.device, dtype=score_dt),
        )
        return scoring.score_ell_rows(row_entity, ds.ell_idx, ds.ell_val.to(score_dt))


@dataclasses.dataclass
class ModelCoordinate(Coordinate):
    """A locked coordinate (partial retraining): scores a pretrained model
    through its inner coordinate and never retrains, training to
    ``(locked_model, None)``."""

    inner: Coordinate
    locked_model: Union[FixedEffectModel, RandomEffectModel]

    def __post_init__(self):
        self.coordinate_id = self.inner.coordinate_id

    @property
    def n_rows(self) -> int:
        return self.inner.n_rows

    @property
    def group(self):
        return self.inner.group

    def train(self, residual_scores, initial_model=None):
        return self.locked_model, None

    def score(self, model=None) -> Tensor:
        return self.inner.score(self.locked_model)


def _layout(ds: RandomEffectDataset) -> Tensor:
    """The dataset's whole support layout ``[E, S]`` on its device: the
    blocks' own, or for entity-sharded blocks ``host_proj_cols`` (uploaded
    once and cached on the dataset)."""
    if ds.group is None:
        return ds.blocks.proj_cols
    cached = getattr(ds, "_layout_cache", None)
    if cached is None:
        cached = torch.as_tensor(ds.host_proj_cols, dtype=torch.int32, device=ds.device)
        object.__setattr__(ds, "_layout_cache", cached)
    return cached


def _gather_results(res: SolverResult, group) -> SolverResult:
    """Every rank's entity-major ``SolverResult`` rows, in rank order, on
    every rank (one collective); ``syncs`` stays this rank's own count."""
    fields = ("coefficients", "loss", "gradient", "iterations", "reason", "loss_history", "grad_norm_history")
    whole = group.gather_rows([getattr(res, f) for f in fields])
    return SolverResult(**dict(zip(fields, whole)), syncs=res.syncs)


def _refuse_streamed_lanes(coordinate) -> None:
    if coordinate.dataset.streamed:
        raise ValueError(
            "trial-lanes sweeps require HBM-resident coordinates"
            f" (coordinate {coordinate.coordinate_id} is streamed)"
        )


def _train_fn():
    """The random-effect solve ``_re_solver_mode`` selects."""
    return _train_blocks if _re_solver_mode() == "vmapped" else _train_blocks_packed


def _re_solver_mode() -> str:
    """Random-effect solver selection, as in the JAX package: 'packed'
    (the default, entity-minor lockstep solves) or 'vmapped' (entity-leading
    lockstep solves with per-lane history, whose entity results do not
    depend on their bucket's other entities). Unknown values raise."""
    mode = os.environ.get("PHOTON_RE_SOLVER", "packed").strip().lower()
    if mode not in ("packed", "vmapped"):
        raise ValueError(f"PHOTON_RE_SOLVER={mode!r}: expected 'packed' or 'vmapped'")
    return mode


def _project_model_values(
    dataset: RandomEffectDataset, model: RandomEffectModel, values: Tensor, dtype, fill: float = 0.0
) -> Tensor:
    """Project per-entity values stored in ``model``'s (entity, support)
    layout into this dataset's entity/subspace block layout; an entry the
    model lacks (an entity or a column it does not carry) takes
    ``fill``. The same layout is reused as it is; any other goes through one
    vectorized sorted-key lookup on the host."""
    dev = dataset.blocks.labels.device
    layout = _layout(dataset)
    E, S = layout.shape
    prov = getattr(model, "_support_layout_of", None)
    if prov is not None and prov() is dataset:
        return values.to(device=dev, dtype=dtype)
    pc_host = layout.cpu().numpy()
    idx = model.coef_indices.cpu().numpy()
    if (
        idx.shape == (E, S)
        and model.num_entities == E
        and np.array_equal(idx, pc_host)
        and list(map(str, model.entity_ids)) == list(map(str, dataset.entity_ids))
    ):
        return values.to(device=dev, dtype=dtype)
    dim = int(max(int(pc_host.max(initial=0)), int(idx.max(initial=0))) + 1)
    vals = values.detach().cpu().double().numpy()
    me, ms = np.nonzero(idx >= 0)
    mkeys = me.astype(np.int64) * dim + idx[me, ms]
    order = np.argsort(mkeys, kind="stable")
    mkeys_s = mkeys[order]
    mvals_s = vals[me, ms][order]
    rows = model.rows_for(dataset.entity_ids)  # [E] model row or -1
    de, dsl = np.nonzero((pc_host >= 0) & (rows[:, None] >= 0))
    dkeys = rows[de].astype(np.int64) * dim + pc_host[de, dsl]
    w0 = np.full((E, S), fill)
    if len(mkeys_s) and len(dkeys):
        # side='right' - 1: among duplicate support columns the last stored
        # value wins
        pos = np.clip(np.searchsorted(mkeys_s, dkeys, side="right") - 1, 0, None)
        hit = mkeys_s[pos] == dkeys
        w0[de[hit], dsl[hit]] = mvals_s[pos[hit]]
    return torch.as_tensor(w0).to(device=dev, dtype=dtype)


def _pow2_ceil(x: np.ndarray) -> np.ndarray:
    """Exact elementwise 2**ceil(log2(max(x, 1))) for int64 inputs < 2^53."""
    v = np.maximum(np.asarray(x, dtype=np.int64), 1) - 1
    return np.int64(1) << np.frexp(v.astype(np.float64))[1].astype(np.int64)


def _size_buckets(dataset: RandomEffectDataset, min_dim: int = 8, align: int = 1,
                  entity_range: Optional[Tuple[int, int]] = None):
    """Contiguous entity segments with power-of-2-rounded (K, S) block shapes.

    Returns [(start, end, K_b, S_b)] over all the dataset's entities, or
    None when per-entity stats are unavailable or bucketing cannot shrink
    anything. ``align`` snaps segment bounds up to multiples of the ranks'
    entity chunk, so that no segment splits a rank's range (counts are
    non-increasing, so the merged head of the next run still fits the larger
    preceding block shape). ``entity_range`` (a streamed dataset's
    ``entity_shard_range``): the segments cut to ``[lo, hi)``, relative to
    ``lo``, each keeping its whole-dataset shape, so that an entity solves
    in the block shape it has in one process. (The JAX package buckets the
    range's own entities instead.)"""
    counts = dataset.entity_counts
    svec = dataset.entity_subspace_dims
    if counts is None or svec is None or len(counts) == 0:
        return None
    E = dataset.num_entities
    _, K, S = dataset.blocks.features.shape

    kb_of = np.minimum(
        np.maximum(_pow2_ceil(np.asarray(counts[:E], dtype=np.int64)), min_dim), K
    )
    bounds = np.flatnonzero(np.diff(kb_of)) + 1  # starts of new equal-K runs
    if align > 1:
        bounds = np.unique(-(-bounds // align) * align)
    bounds = bounds[(bounds > 0) & (bounds < E)]
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [E]])

    sv = np.asarray(svec[:E], dtype=np.int64)
    sb_of = np.minimum(np.maximum(_pow2_ceil(np.maximum.reduceat(sv, starts)), min_dim), S)
    segments = [
        (int(s), int(e), int(kb_of[s]), int(sb))  # counts non-increasing => max K
        for s, e, sb in zip(starts, ends, sb_of)
    ]
    if len(segments) == 1 and segments[0][2] >= K and segments[0][3] >= S:
        return None
    if entity_range is not None:
        lo, hi = entity_range
        segments = [(max(s, lo) - lo, min(e, hi) - lo, kb, sb) for s, e, kb, sb in segments if s < hi and e > lo]
    return segments


def _concat_results(parts, S: int) -> SolverResult:
    """Stitch per-bucket SolverResults back into entity order, zero-padding
    coefficients/gradients to the global subspace dim; the syncs add up."""

    def pad_cols(a):
        if a.shape[-1] == S:
            return a
        return torch.nn.functional.pad(a, (0, S - a.shape[-1]))

    return SolverResult(
        coefficients=torch.cat([pad_cols(p.coefficients) for p in parts]),
        loss=torch.cat([p.loss for p in parts]),
        gradient=torch.cat([pad_cols(p.gradient) for p in parts]),
        iterations=torch.cat([p.iterations for p in parts]),
        reason=torch.cat([p.reason for p in parts]),
        loss_history=torch.cat([p.loss_history for p in parts]),
        grad_norm_history=torch.cat([p.grad_norm_history for p in parts]),
        syncs=sum(p.syncs for p in parts),
    )


def _solve_blocks(
    value_and_grad, hessian_vector, w0: Tensor, *, entity_leading: bool, l1: float, optimizer_type: str,
    tolerance: float, max_iterations: int, num_corrections: int, max_cg_iterations: int,
    max_improvement_failures: int,
) -> SolverResult:
    """The per-lane tolerances from the zero state, then one lockstep TRON
    or L-BFGS (OWL-QN with ``l1``) over the stack ``w0``."""
    syncs = SyncCounter()
    loss_tol, grad_tol = abs_tolerances(
        value_and_grad, w0, tolerance, lanes=LEADING if entity_leading else MINOR
    )
    if optimizer_type == OptimizerType.TRON.value:
        return solve_tron(
            value_and_grad, hessian_vector, w0, loss_tol, grad_tol,
            max_iterations=max_iterations, max_cg_iterations=max_cg_iterations,
            max_improvement_failures=max_improvement_failures, syncs=syncs,
            entity_leading=entity_leading,
        )
    return solve_lbfgs(
        value_and_grad, w0, loss_tol, grad_tol,
        max_iterations=max_iterations, num_corrections=num_corrections, l1_weight=l1,
        syncs=syncs, batched=True, entity_leading=entity_leading,
    )


# On the CPU, PyTorch computes an elementwise transcendental (exp, sigmoid,
# ...) by SIMD for whole blocks of vector width and by scalar code for a
# block's tail, and the two may differ in the last bit; and it cuts a
# tensor of GRAIN elements or more into one piece per thread at offsets that
# depend on its size. _lane_pointwise pads each lane's row to a multiple of
# _CPU_VECTOR_BLOCK elements and calls the loss on row blocks under GRAIN
# elements, so that every element takes the SIMD path whatever the number
# of lanes. (On the card every element runs the same code.) Both constants
# are ATen's: the SIMD block is ``vectorized_loop``'s ``2 * Vec::size()``
# (ATen/native/cpu/Loops.h), 32 floats or 16 doubles under AVX-512, and
# 64 is a multiple of it for every ISA PyTorch builds; the grain is
# ``at::internal::GRAIN_SIZE`` (ATen/TensorIterator.h), which Python cannot
# read. tests/test_torch_re_solvers.py holds an entity's bits alone and
# within a bucket, and fails if either changes.
_CPU_VECTOR_BLOCK = 64
_CPU_GRAIN = 32768


def _lane_pointwise(fn, z: Tensor, y: Tensor):
    """``fn(z, y)`` (one tensor or a tuple of them) for ``[E, K]`` lanes,
    each element's bits independent of the other lanes."""
    E, K = z.shape
    if z.device.type != "cpu" or E == 0:
        return fn(z, y)
    pad = -K % _CPU_VECTOR_BLOCK
    zp = torch.nn.functional.pad(z, (0, pad))
    yp = torch.nn.functional.pad(y, (0, pad))
    rows = max(1, (_CPU_GRAIN - 1) // (K + pad))
    parts = [fn(zp[i : i + rows], yp[i : i + rows]) for i in range(0, E, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[j] for p in parts])[:, :K] for j in range(len(parts[0])))
    return torch.cat(parts)[:, :K]


def _train_blocks(
    features: Tensor,  # [E, K, S]
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    w0: Tensor,  # [E, S]
    prior_mean: Tensor,  # [E, S]; zeros = plain L2
    prior_prec: Tensor,  # [E, S]; ones = plain L2
    *,
    task: str,
    l2: float,
    l1: float,
    optimizer_type: str,
    tolerance: float,
    max_iterations: int,
    num_corrections: int,
    max_cg_iterations: int,
    max_improvement_failures: int,
) -> SolverResult:
    """The JAX package's vmapped per-entity solve: entity-leading stacks
    (features ``[E, K, S]``, coefficients ``[E, S]``), every reduction over
    a trailing axis, one lockstep solve in which each lane keeps its own
    L-BFGS history cursor and line search, or its own TRON radius and CG
    state (``entity_leading=True`` of the solvers). No operation mixes
    lanes, each lane's sums run in the same order whatever E is (every
    reduction is the lane reduction, ``ops/lane_reduce.py``: V1 on the
    card, whose order depends on the reduced length alone), and the
    loss's elementwise functions take the same path for every element
    (``_lane_pointwise``), so an entity's result does not depend on the
    other entities of its stack. Each entity's objective value sums in
    float64, as in ``_train_blocks_packed``."""
    loss = get_loss(task)
    X = features  # [E, K, S]; a narrower dtype promotes in the products
    y = labels
    off = offsets.to(labels.dtype)
    wt = weights
    pm, pp = prior_mean, prior_prec

    def margins(w):  # [E, S] -> [E, K]
        return lane_reduce(X, w[:, None, :]) + off

    def value_and_grad(w):  # [E, S] -> ([E] float64, [E, S])
        lvals, dz = _lane_pointwise(loss.loss_and_dz, margins(w), y)
        grad = lane_reduce(X, (wt * dz)[:, :, None], dim=1)
        delta = w - pm
        value = lane_reduce((wt * lvals).double()) + 0.5 * l2 * lane_reduce((pp * delta * delta).double())
        return value, grad + l2 * pp * delta

    def hessian_vector(w, v):  # the margins recomputed, as the JAX package does
        c = wt * _lane_pointwise(loss.d2z, margins(w), y) * lane_reduce(X, v[:, None, :])
        return lane_reduce(X, c[:, :, None], dim=1) + l2 * pp * v

    res = _solve_blocks(
        value_and_grad, hessian_vector, w0, entity_leading=True, l1=l1,
        optimizer_type=optimizer_type, tolerance=tolerance, max_iterations=max_iterations,
        num_corrections=num_corrections, max_cg_iterations=max_cg_iterations,
        max_improvement_failures=max_improvement_failures,
    )
    # the solvers keep histories [T, E]; results are entity-major
    return dataclasses.replace(
        res, loss_history=res.loss_history.T, grad_norm_history=res.grad_norm_history.T
    )


def _train_blocks_packed(
    features: Tensor,  # [E, K, S]
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    w0: Tensor,  # [E, S]
    prior_mean: Tensor,  # [E, S]; zeros = plain L2
    prior_prec: Tensor,  # [E, S]; ones = plain L2
    *,
    task: str,
    l2: float,
    l1: float,
    optimizer_type: str,
    tolerance: float,
    max_iterations: int,
    num_corrections: int,
    max_cg_iterations: int,
    max_improvement_failures: int,
) -> SolverResult:
    """Entity-minor lockstep solve over all entity blocks: the data is
    transposed so the entity axis is minor (features [K, S, E],
    coefficients [S, E]), every solver op is elementwise over the entities,
    and the per-entity reductions are axis-0 sums. Returns the result in
    entity-major layout (coefficients [E, S], histories [E, T]).

    Unlike the JAX package, each entity's objective value sums in float64
    (the gradient and the iterate stay in the solve dtype). An entity capped
    at ``active_cap`` rows carries the count/cap weight rescale, which puts
    its loss in the thousands at bench shapes (about 3e4 for the largest
    user of bench.py's data): there one float32 ulp (~2e-3) exceeds the
    packed solve's loss bound (atol 1e-4), and the line search's Armijo test
    would compare values at that resolution.

    TRON's Hessian-vector product recomputes the margins from the iterate,
    as the JAX package's does."""
    loss = get_loss(task)
    # features may be stored narrower (bf16); products promote to the
    # labels' (solve) dtype
    F = features.permute(1, 2, 0).contiguous()  # [K, S, E]
    y = labels.T.contiguous()  # [K, E]
    off = offsets.T.to(labels.dtype).contiguous()
    wt = weights.T.contiguous()
    w0t = w0.T.contiguous()  # [S, E]
    pm = prior_mean.T.contiguous()
    pp = prior_prec.T.contiguous()

    def value_and_grad(w):  # [S, E] -> ([E] float64, [S, E])
        z = torch.sum(F * w[None, :, :], dim=1) + off  # [K, E]
        lvals, dz = loss.loss_and_dz(z, y)
        wdz = wt * dz
        grad = torch.sum(F * wdz[:, None, :], dim=0)  # [S, E]
        delta = w - pm
        # the per-entity value sums in float64 (see the note in the docstring)
        value = torch.sum((wt * lvals).double(), dim=0) + 0.5 * l2 * torch.sum(
            (pp * delta * delta).double(), dim=0
        )
        grad = grad + l2 * pp * delta
        return value, grad

    def hessian_vector(w, v):
        z = torch.sum(F * w[None, :, :], dim=1) + off
        c = wt * loss.d2z(z, y) * torch.sum(F * v[None, :, :], dim=1)  # [K, E]
        return torch.sum(F * c[:, None, :], dim=0) + l2 * pp * v

    res = _solve_blocks(
        value_and_grad, hessian_vector, w0t, entity_leading=False, l1=l1,
        optimizer_type=optimizer_type, tolerance=tolerance, max_iterations=max_iterations,
        num_corrections=num_corrections, max_cg_iterations=max_cg_iterations,
        max_improvement_failures=max_improvement_failures,
    )
    return SolverResult(
        coefficients=res.coefficients.T,
        loss=res.loss,
        gradient=res.gradient.T,
        iterations=res.iterations,
        reason=res.reason,
        loss_history=res.loss_history.T,
        grad_norm_history=res.grad_norm_history.T,
        syncs=res.syncs,
    )


def _train_blocks_packed_lanes(
    features: Tensor,  # [E, K, S]
    labels: Tensor,  # [E, K]
    offsets_lanes: Tensor,  # [E, K, L] residual-composed per-lane offsets
    weights: Tensor,  # [E, K]
    w0: Tensor,  # [E, S, L]
    l2_lanes: Tensor,  # f[L]
    *,
    task: str,
    optimizer_type: str,
    tolerance: float,
    max_iterations: int,
    num_corrections: int,
    max_cg_iterations: int,
    max_improvement_failures: int,
) -> SolverResult:
    """The entity-minor lockstep solve widened by the lambda-lane axis (the
    JAX package's ``_train_blocks_packed_lanes``): the solver lanes are the
    (entity, lambda) pairs, coefficients ``[S, E, L]``, every per-problem
    reduction axis 0, the L2 weights broadcast from the trailing lane axis.
    The products are batched matrix products over the entities
    (``[E, K, S] @ [E, S, L]``, as the JAX package's einsums), so no
    ``[K, S, E, L]`` term is ever formed. Each value sums in float64, as in
    ``_train_blocks_packed``. Returns the result entity-major:
    coefficients ``[E, S, L]``, loss and reason ``[E, L]``, histories
    ``[E, L, T]``."""
    loss = get_loss(task)
    dtype = labels.dtype
    X = features.to(dtype)  # [E, K, S]; a narrower storage dtype widens once
    Xt = X.transpose(1, 2)  # [E, S, K]
    y = labels[:, :, None]  # [E, K, 1]
    off = offsets_lanes.to(dtype)  # [E, K, L]
    wt = weights[:, :, None]
    E, _, S = X.shape
    L = w0.shape[2]
    # the solvers take the (entity, lambda) lanes flattened: [S, E * L]
    w0t = w0.permute(1, 0, 2).to(dtype).reshape(S, E * L)

    def margins(w):  # [S, E, L] -> [E, K, L]
        return torch.bmm(X, w.permute(1, 0, 2))

    def value_and_grad(wf):  # [S, E * L] -> ([E * L] float64, [S, E * L])
        w = wf.reshape(S, E, L)
        lvals, dz = loss.loss_and_dz(margins(w) + off, y)
        grad = torch.bmm(Xt, wt * dz).permute(1, 0, 2)
        value = torch.sum((wt * lvals).double(), dim=1) + 0.5 * l2_lanes.double() * torch.sum(
            (w * w).double(), dim=0
        )
        return value.reshape(E * L), (grad + l2_lanes * w).reshape(S, E * L)

    def hessian_vector(wf, vf):
        w, v = wf.reshape(S, E, L), vf.reshape(S, E, L)
        c = wt * loss.d2z(margins(w) + off, y) * margins(v)  # [E, K, L]
        return (torch.bmm(Xt, c).permute(1, 0, 2) + l2_lanes * v).reshape(S, E * L)

    res = _solve_blocks(
        value_and_grad, hessian_vector, w0t, entity_leading=False, l1=0.0,
        optimizer_type=optimizer_type, tolerance=tolerance, max_iterations=max_iterations,
        num_corrections=num_corrections, max_cg_iterations=max_cg_iterations,
        max_improvement_failures=max_improvement_failures,
    )
    T = res.loss_history.shape[0]
    return SolverResult(
        coefficients=res.coefficients.reshape(S, E, L).permute(1, 0, 2),
        loss=res.loss.reshape(E, L),
        gradient=res.gradient.reshape(S, E, L).permute(1, 0, 2),
        iterations=res.iterations.reshape(E, L),
        reason=res.reason.reshape(E, L),
        loss_history=res.loss_history.reshape(T, E, L).permute(1, 2, 0),
        grad_norm_history=res.grad_norm_history.reshape(T, E, L).permute(1, 2, 0),
        syncs=res.syncs,
    )
