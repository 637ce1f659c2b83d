"""Day-chained incremental retraining with no-degrade promotion gates.

The JAX package's ``game/incremental.py`` on the port. Walk a
time-partitioned feed one day at a time, warm-start day k+1 from day k's
accepted model with prior-centred L2 (``CoordinateConfig.
regularize_by_prior``), re-solve only what the new rows touch, gate the
candidate behind a per-metric no-degrade check against the live model, and
publish accepted models into a serving root (``serving.refresh.
publish_snapshot``).

Partial re-solve falls out of the data layout: a day's ``RawDataset``
holds exactly the entities its rows touch, so the day's coordinate descent
trains those entities only. :func:`merge_models` then grows the accepted
prior:

- entities untouched by the day carry forward **bitwise** (their
  coefficient rows are copied on the host, never recomputed);
- touched entities take the day's re-solved rows (their support widened to
  the merged padded width with the ``-1`` sentinel);
- entities new to the day are appended (their warm start and prior were
  mean 0, precision 1).

Promotion is refused, not assumed: :func:`no_degrade_gate` scores the
candidate and the live model on the same held-out rows (``GameTransformer``:
S1's ELL matvec for a fixed effect on the card) and rejects the candidate
if any requested metric degrades beyond ``margin``. A rejection is typed and
counted (``photon_retrain_rejected_total{reason=}``) and the previous
snapshot keeps serving.

Each day's stage walls (read, train, merge, gate, save, publish; each ends
in a device synchronize) are returned in ``ChainResult.day_seconds`` and
observed in ``photon_retrain_stage_seconds{stage=}``.

Fault sites (``PHOTON_FAULTS``):

- ``retrain.day``: checked once per chain day before any of its work; a
  ``kill`` there is the crash-between-days drill (the ledger resumes).
- ``retrain.publish``: checked right before snapshot publication; an
  ``io`` error there is the torn-publish drill (the decision is already in
  the ledger; the next cycle's :func:`_ensure_published` repairs the store).

Mid-day kills resume through the boundary checkpoints: each day's descent
runs under a ``robust.CheckpointManager`` whose manifests carry the chain
position and the ledger so far (``base_meta``), and the chain state file
marks the day in progress.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..device import fetch
from ..evaluation import build_suite
from ..models.game import GameModel, RandomEffectModel
from ..robust import faults
from ..robust.atomic import atomic_write_json
from ..robust.checkpoint import CheckpointManager
from ..robust.retry import io_call

logger = logging.getLogger("photon_ml_tpu_torch")

CHAIN_STATE_NAME = "chain-state.json"
_CHAIN_STATE_VERSION = 1
STAGES = ("read", "train", "merge", "gate", "save", "publish")


# -- random-effect growth ----------------------------------------------------


def grow_random_effect(prior: RandomEffectModel, update: RandomEffectModel) -> RandomEffectModel:
    """Merge a day's re-solved entities into ``prior``.

    Entities in ``update`` take their re-solved rows; entities only in
    ``prior`` carry forward bitwise; entities new to ``update`` are appended
    after the prior rows. The padded support width widens to fit both sides
    (indices padded with ``-1``, values with 0, in ``np.result_type`` of the
    two value dtypes), so untouched rows score identically. The merge runs
    on the host after one fetch of each side; the merged model goes to the
    update's device.

    Variances merge only when BOTH sides carry them (a means-only update
    invalidates the prior's variances of the touched rows, so the merged
    model drops them rather than serving a mix)."""
    if prior.random_effect_type != update.random_effect_type:
        raise ValueError(
            "cannot merge random-effect models of different types: "
            f"{prior.random_effect_type!r} vs {update.random_effect_type!r}"
        )
    if prior.feature_shard != update.feature_shard:
        raise ValueError(
            "cannot merge random-effect models of different feature shards: "
            f"{prior.feature_shard!r} vs {update.feature_shard!r}"
        )
    with_var = prior.variances is not None and update.variances is not None

    def side(m):
        return fetch("retrain.merge", [m.coef_indices, m.coef_values] + ([m.variances] if with_var else []))

    p = side(prior)
    u = side(update)
    S = max(p[0].shape[1], u[0].shape[1])
    val_dt = np.result_type(p[1].dtype, u[1].dtype)

    def widen(a, pad):
        if a.shape[1] == S:
            return a
        return np.pad(a, ((0, 0), (0, S - a.shape[1])), constant_values=pad)

    # destination row for every update entity: the prior's row when it
    # exists (re-solved in place), else a fresh appended row (growth)
    dest = np.empty(update.num_entities, dtype=np.int64)
    ids = list(map(str, prior.entity_ids))
    for e, ent in enumerate(update.entity_ids):
        r = prior.entity_row(ent)
        if r < 0:
            r = len(ids)
            ids.append(str(ent))
        dest[e] = r
    E_out = len(ids)

    def merged(k, pad, dt):
        out = np.full((E_out, S), pad, dtype=dt)
        out[: prior.num_entities] = widen(p[k], pad).astype(dt, copy=False)
        out[dest] = widen(u[k], pad).astype(dt, copy=False)
        return torch.from_numpy(out).to(update.coef_values.device)

    return RandomEffectModel(
        random_effect_type=prior.random_effect_type,
        feature_shard=prior.feature_shard,
        task=update.task,
        entity_ids=np.asarray(ids, dtype=object),
        coef_indices=merged(0, -1, np.int32),
        coef_values=merged(1, 0, val_dt),
        variances=merged(2, 0, val_dt) if with_var else None,
    )


def merge_models(prior: Optional[GameModel], update: GameModel) -> Tuple[GameModel, Dict[str, int]]:
    """Fold a day's trained model into the accepted prior.

    Fixed effects are whole-model replacements (every row carries the global
    features, so the day re-solves them entirely). Random effects grow by
    :func:`grow_random_effect`. Coordinates absent from the update carry
    forward untouched. Returns ``(merged, touched)``: ``touched`` maps each
    random-effect coordinate to the number of entities the day re-solved or
    added."""
    if prior is None:
        touched = {name: m.num_entities for name, m in update.models.items() if isinstance(m, RandomEffectModel)}
        return update, touched
    merged = dict(prior.models)
    touched: Dict[str, int] = {}
    for name, m in update.models.items():
        old = merged.get(name)
        if isinstance(m, RandomEffectModel) and isinstance(old, RandomEffectModel):
            merged[name] = grow_random_effect(old, m)
            touched[name] = m.num_entities
        else:
            merged[name] = m
            if isinstance(m, RandomEffectModel):
                touched[name] = m.num_entities
    return GameModel(models=merged, task=update.task), touched


# -- the no-degrade promotion gate -------------------------------------------


@dataclasses.dataclass(frozen=True)
class GateDecision:
    """Outcome of one candidate-vs-live promotion check."""

    accepted: bool
    reason: str  # "accepted" | "first-publish" | "non-finite" | "degraded:<metric>"
    candidate_metrics: Dict[str, float]
    live_metrics: Optional[Dict[str, float]] = None


def no_degrade_gate(
    candidate: GameModel,
    live: Optional[GameModel],
    validation,
    evaluator_specs: Sequence[str],
    margin: float = 0.0,
    dtype=None,
) -> GateDecision:
    """Score candidate and live on the SAME held-out rows and refuse the
    candidate if any requested metric degrades beyond ``margin`` in that
    metric's own direction (a per-group ``AUC:groupId`` degrades when the
    unweighted mean of its per-group AUCs drops). A candidate with
    non-finite scores or a NaN metric is refused outright; a live metric
    that is not finite cannot veto. With no live model the candidate is
    accepted (``first-publish``). Both models score through
    ``GameTransformer`` on their own device."""
    from ..estimators.game_estimator import GameTransformer

    dtype = torch.float32 if dtype is None else dtype
    with obs.span("retrain.gate"):
        scores, evaluation = GameTransformer(model=candidate, dtype=dtype).transform(validation, evaluator_specs)
        cand_metrics = dict(evaluation.metrics)
        if not np.all(np.isfinite(scores)) or any(not np.isfinite(v) for v in cand_metrics.values()):
            return GateDecision(False, "non-finite", cand_metrics, None)
        if live is None:
            return GateDecision(True, "first-publish", cand_metrics, None)
        _, live_eval = GameTransformer(model=live, dtype=dtype).transform(validation, evaluator_specs)
        live_metrics = dict(live_eval.metrics)
        suite = build_suite(evaluator_specs, validation.labels, validation.weights, id_tags=validation.id_tags)
        for ev in suite.evaluators:
            cand_v = cand_metrics[ev.name]
            live_v = live_metrics[ev.name]
            if not np.isfinite(live_v):
                continue  # a broken live metric cannot veto an improvement
            degraded = live_v - cand_v > margin if ev.higher_is_better else cand_v - live_v > margin
            if degraded:
                return GateDecision(False, f"degraded:{ev.name}", cand_metrics, live_metrics)
        return GateDecision(True, "accepted", cand_metrics, live_metrics)


# -- the day chain -----------------------------------------------------------


@dataclasses.dataclass
class DayRecord:
    """One ledger row: the chain's decision for one day."""

    day: str
    index: int
    accepted: bool
    reason: str
    rows: int
    touched_entities: Dict[str, int]
    snapshot: Optional[str] = None
    published: bool = False
    metrics: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class ChainResult:
    """Final state of one :func:`run_chain` invocation."""

    model: Optional[GameModel]  # the live (last accepted) model
    ledger: List[DayRecord]
    rows_touched: int  # rows the incremental chain actually trained on
    rows_cumulative: int  # rows a daily from-scratch retrain would have touched
    # day label -> stage -> seconds, for the days this invocation processed
    # (not persisted: the ledger stays bit-identical across resumes)
    day_seconds: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def rows_touched_fraction(self) -> float:
        return self.rows_touched / max(self.rows_cumulative, 1)


def _record_decision(decision: GateDecision, day_index: int) -> None:
    outcome = "accepted" if decision.accepted else "rejected"
    registry = obs.current_run().registry
    registry.counter("photon_retrain_days_total", "chain days processed, by promotion outcome").labels(
        outcome=outcome
    ).inc()
    if not decision.accepted:
        registry.counter(
            "photon_retrain_rejected_total", "candidate models refused by the no-degrade promotion gate"
        ).labels(reason=decision.reason).inc()
    registry.gauge("photon_retrain_day_index", "index of the chain day last processed").set(float(day_index))


def _load_chain_state(chain_dir: Optional[str]) -> dict:
    fresh = {"version": _CHAIN_STATE_VERSION, "days": [], "in_progress": None}
    if not chain_dir:
        return fresh
    path = os.path.join(chain_dir, CHAIN_STATE_NAME)
    if not os.path.exists(path):
        return fresh

    def _read():
        with open(path) as f:
            return json.load(f)

    state = io_call(_read, site="io.chain_state")
    if state.get("version") != _CHAIN_STATE_VERSION:
        raise ValueError(f"{path}: unsupported chain-state version {state.get('version')!r}")
    return state


def _save_chain_state(chain_dir: Optional[str], state: dict) -> None:
    if not chain_dir:
        return
    os.makedirs(chain_dir, exist_ok=True)
    io_call(atomic_write_json, os.path.join(chain_dir, CHAIN_STATE_NAME), state, indent=2, site="io.chain_state")


def _ledger_meta(ledger: Sequence[DayRecord]) -> List[dict]:
    return [dataclasses.asdict(r) for r in ledger]


def _ensure_published(serving_root: str, record: DayRecord, model: GameModel) -> bool:
    """Repair path: make the last accepted decision visible in the serving
    store. Called at the top of every cycle: a torn publish (a crash or IO
    error between the gate decision and the store flip) leaves the old
    snapshot serving until this makes the accepted one live. Idempotent: an
    already-live snapshot is a no-op."""
    from ..serving import refresh

    if record.snapshot is None:
        return False
    if refresh.current_snapshot(serving_root) == record.snapshot and os.path.isdir(
        refresh.snapshot_path(serving_root, record.snapshot)
    ):
        return True
    try:
        faults.check("retrain.publish")
        refresh.publish_snapshot(serving_root, record.snapshot, game_model=model, replace=True)
    except OSError:
        obs.swallowed_error("retrain.publish")
        return False
    obs.current_run().registry.counter(
        "photon_retrain_published_total", "accepted snapshots published into the serving store"
    ).inc()
    return True


@contextlib.contextmanager
def _stage(name: str, seconds: Dict[str, float], device):
    """Time one stage of a chain day into ``seconds[name]``, ending in a
    device synchronize, and observe it in ``photon_retrain_stage_seconds``."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    seconds[name] = seconds.get(name, 0.0) + dt
    obs.current_run().registry.histogram(
        "photon_retrain_stage_seconds", "wall of one stage of a chain day"
    ).labels(stage=name).observe(dt)


DayData = Union["RawDataset", Callable[[], "RawDataset"]]  # noqa: F821


def run_chain(
    estimator,
    days: Sequence[Tuple[str, DayData]],
    validation,
    *,
    initial_model: Optional[GameModel] = None,
    chain_dir: Optional[str] = None,
    serving_root: Optional[str] = None,
    snapshot_prefix: str = "retrain",
    evaluator_specs: Optional[Sequence[str]] = None,
    gate_margin: float = 0.0,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 3,
    index_maps: Optional[Mapping[str, object]] = None,
    dtype=None,
) -> ChainResult:
    """Walk ``days`` (ordered ``(label, dataset-or-thunk)`` pairs), training
    each day warm-started from the last ACCEPTED model with prior-centred
    L2, gating every candidate through :func:`no_degrade_gate`, and
    publishing accepted models into ``serving_root``. Training runs on the
    estimator's device; ``dtype`` is the gate's scoring dtype (float32 by
    default).

    ``chain_dir`` makes the chain durable: the day ledger persists in
    ``chain-state.json``, accepted models are saved under ``models/`` (when
    ``index_maps`` are given), and each day's boundary checkpoints (with
    ``checkpoint_every``) carry the chain position in their manifests. A
    re-invocation over the same ``days`` resumes: decided days are skipped
    (their thunks never load), a day killed in its descent resumes from its
    newest valid boundary checkpoint, and a torn publish is repaired before
    any new work."""
    from ..io.model_io import load_game_model, save_game_model

    dtype = torch.float32 if dtype is None else dtype
    device = getattr(estimator, "device", None)
    specs = list(evaluator_specs or estimator.evaluator_specs or ["RMSE"])

    state = _load_chain_state(chain_dir)
    ledger = [DayRecord(**d) for d in state["days"]]
    rows_touched = int(state.get("rows_touched", 0))
    rows_cumulative = int(state.get("rows_cumulative", 0))
    rows_seen = int(state.get("rows_seen", 0))
    day_seconds: Dict[str, Dict[str, float]] = {}

    live = initial_model
    if ledger and state.get("live_model_dir") and index_maps is not None:
        # resume: the last accepted model reloads from the chain's own store
        live = load_game_model(
            state["live_model_dir"], index_maps, task=estimator.task, device=device, dtype=estimator.dtype
        )

    last_accepted = next((r for r in reversed(ledger) if r.accepted), None)
    if serving_root and last_accepted is not None and live is not None:
        if _ensure_published(serving_root, last_accepted, live):
            if not last_accepted.published:
                last_accepted.published = True
                state["days"] = _ledger_meta(ledger)
                _save_chain_state(chain_dir, state)

    for day_index, (label, data) in enumerate(days):
        if day_index < len(ledger):
            continue  # decided on an earlier invocation; the ledger is durable
        faults.check("retrain.day")
        seconds: Dict[str, float] = {}
        t_day = time.perf_counter()
        with _stage("read", seconds, device):
            raw = data() if callable(data) else data
        resume_snap = None
        mgr = None
        if chain_dir and checkpoint_every:
            mgr = CheckpointManager(
                os.path.join(chain_dir, "checkpoints", f"day-{day_index:04d}"),
                keep_last=checkpoint_keep,
                every=checkpoint_every,
                base_meta={"chain_day": label, "chain_day_index": day_index, "chain_ledger": _ledger_meta(ledger)},
            )
            if state.get("in_progress") == label:
                resume_snap = mgr.latest_valid(device=device if device is not None else "cpu")
                if resume_snap is not None:
                    logger.info("day %s: resuming mid-day from boundary step %s", label,
                                resume_snap.manifest.get("step"))
        state["in_progress"] = label
        _save_chain_state(chain_dir, state)

        for cc in estimator.coordinate_configs:
            # prior-centred L2 only once a prior exists; day 0 is plain L2
            cc.regularize_by_prior = live is not None

        with obs.span("retrain.day", day=label):
            boundary_fn = None
            if mgr is not None:
                boundary_fn = lambda _w, st, _m=mgr: _m.on_boundary(st)  # noqa: E731
            with _stage("train", seconds, device):
                results = estimator.fit(
                    raw, validation=validation, initial_model=live, boundary_fn=boundary_fn,
                    resume_state=resume_snap,
                )
                day_model = estimator.select_best(results).model
            with _stage("merge", seconds, device):
                candidate, touched = merge_models(live, day_model)
            with _stage("gate", seconds, device):
                decision = no_degrade_gate(candidate, live, validation, specs, margin=gate_margin, dtype=dtype)

        _record_decision(decision, day_index)
        rows_seen += int(raw.n_rows)
        rows_touched += int(raw.n_rows)
        rows_cumulative += rows_seen  # a from-scratch daily retrain refits the union

        record = DayRecord(
            day=label,
            index=day_index,
            accepted=decision.accepted,
            reason=decision.reason,
            rows=int(raw.n_rows),
            touched_entities=touched,
            metrics=decision.candidate_metrics,
        )
        if decision.accepted:
            live = candidate
            record.snapshot = f"{snapshot_prefix}-{label}"
            if chain_dir and index_maps is not None:
                model_dir = os.path.join(chain_dir, "models", f"day-{label}")
                with _stage("save", seconds, device):
                    save_game_model(model_dir, live, index_maps)
                state["live_model_dir"] = model_dir
            if serving_root:
                with _stage("publish", seconds, device):
                    record.published = _ensure_published(serving_root, record, live)
        else:
            logger.warning(
                "day %s: candidate refused by the promotion gate (%s); the previous model keeps serving",
                label, decision.reason,
            )

        ledger.append(record)
        state["days"] = _ledger_meta(ledger)
        state["in_progress"] = None
        state["rows_touched"] = rows_touched
        state["rows_cumulative"] = rows_cumulative
        state["rows_seen"] = rows_seen
        _save_chain_state(chain_dir, state)
        seconds["day"] = time.perf_counter() - t_day
        day_seconds[label] = seconds

    return ChainResult(
        model=live,
        ledger=ledger,
        rows_touched=rows_touched,
        rows_cumulative=rows_cumulative,
        day_seconds=day_seconds,
    )
