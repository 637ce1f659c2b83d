"""The execution planner: resolve the run's configuration up front.

The JAX package's ``plan/planner.py`` on the port. ``resolve`` takes every
per-coordinate knob (layout, feature dtype, HBM budget) and the run-level
topology (mesh, process count, pipeline depth, trial lanes) and decides,
before any data is read or any device memory committed, the routing each
coordinate takes, or raises one typed :class:`PlanError`.

The port resolves the compositions it runs on one card: resident and
streamed (``hbm_budget_mb``: out-of-core row slices of a fixed effect, entity
slices of a random effect) coordinates, dense / ELL / sorted-COO
fixed-effect layouts, float32 or bfloat16 feature storage, the serial and
the pipelined sweep (``pipeline_depth`` > 1), incremental training
(regularize-by-prior and locked coordinates) and trial lanes
(``check_lane_composition`` and ``check_retrain_composition`` refuse what
the lane path and the retrain chain do not compose with, and
``_check_coordinate`` what the streamed fixed effect does not, in the JAX
package's words). Several processes (``n_processes`` > 1, ``--distributed``)
resolve with no mesh or with a (data x model) grid of the world size (one
card a rank: the JAX mesh's counterpart); a fixed effect is dense (under a
model axis its rows sharded over the data axis and replicated over the
model axis, the JAX package's "row+model-sharded"), or ``layout='tiled'``
(the (data x model)-tiled sparse batch, which needs a mesh, in the JAX
package's words, and takes no ``feature_dtype``). Over processes a
coordinate streams as well (each rank streams its own rows, or
its own entity range, under the per-rank budget: the JAX package's
"host-sharded rows (streamed slices)" and "entity-sharded (host-resident
blocks)"), a streamed fixed effect dense or ELL, and the sweep pipelines
(also on the tiled grid). What the JAX package refuses stays refused in its
words: a resident ELL or COO fixed effect over processes, a budget on a
fixed effect that is not row-sliceable, and trial lanes over processes.
What the port has not ported is refused with a ``PlanError`` that names its
ROADMAP item (A10): a grid other than the process count.
``plan_fingerprint`` and ``check_checkpoint_topology`` are the JAX package's,
so a checkpoint's manifest speaks the same topology contract.

The module imports no torch: a plan resolves (``cli train --explain-plan``)
on a host with no card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional, Sequence, Tuple


class PlanError(ValueError):
    """A configuration the execution planner refuses (a ``ValueError``)."""


A10 = "ROADMAP A10"
# slice row counts round to this multiple (game/fe_streaming.py's)
_ROW_MULTIPLE = 8


def not_ported(what: str, item: str) -> PlanError:
    """The refusal of a composition the port has not ported yet."""
    return PlanError(f"{what} is not ported yet ({item})")


# -- resolved plan types -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoordinatePlan:
    """The routing one coordinate takes under the resolved plan."""

    name: str
    kind: str  # "fixed-effect" | "random-effect"
    layout: str
    feature_dtype: str
    residency: str  # "resident" | "streamed"
    sharding: str  # "single-device" | "row-sharded" | "entity-sharded"
    pipelined: bool
    hbm_budget_mb: Optional[int] = None
    geometry: Dict[str, object] = dataclasses.field(default_factory=dict)
    notes: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["notes"] = list(self.notes)
        return d


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The full resolved execution configuration for one training run."""

    coordinates: Tuple[CoordinatePlan, ...]
    mesh_axes: Optional[Dict[str, int]]
    n_processes: int
    pipeline_depth: int
    trial_lanes: int
    normalization: str
    distributed: bool

    def to_dict(self) -> Dict[str, object]:
        return {
            "coordinates": [c.to_dict() for c in self.coordinates],
            "mesh_axes": dict(self.mesh_axes) if self.mesh_axes else None,
            "n_processes": self.n_processes,
            "pipeline_depth": self.pipeline_depth,
            "trial_lanes": self.trial_lanes,
            "normalization": self.normalization,
            "distributed": self.distributed,
        }

    def pretty(self) -> str:
        mesh = (
            " ".join(f"{k}={v}" for k, v in self.mesh_axes.items())
            if self.mesh_axes
            else "none (single device)"
        )
        lines = [
            "execution plan",
            f"  topology: {self.n_processes} process(es), mesh {mesh}",
            f"  pipeline depth: {self.pipeline_depth}"
            + (" (staging/solve/eval overlap)" if self.pipeline_depth > 1 else " (serial)"),
            f"  trial lanes: {self.trial_lanes}",
            f"  normalization: {self.normalization}",
            "  coordinates:",
        ]
        for c in self.coordinates:
            head = (
                f"    {c.name}: {c.kind}, layout={c.layout}, "
                f"feature_dtype={c.feature_dtype}, {c.residency}, {c.sharding}"
            )
            if c.pipelined:
                head += ", pipelined"
            lines.append(head)
            for k in sorted(c.geometry):
                lines.append(f"      {k}: {c.geometry[k]}")
            for n in c.notes:
                lines.append(f"      note: {n}")
        return "\n".join(lines)


# -- mesh introspection (dict, tuple or None) --------------------------------

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _mesh_axes(mesh) -> Optional[Dict[str, int]]:
    """Normalize a mesh spec to {"data": n, "model": n} (None -> no mesh)."""
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {DATA_AXIS: int(mesh.get(DATA_AXIS, 1)),
                MODEL_AXIS: int(mesh.get(MODEL_AXIS, 1))}
    if isinstance(mesh, (tuple, list)):
        n_data = int(mesh[0])
        n_model = int(mesh[1]) if len(mesh) > 1 else 1
        return {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    shape = getattr(mesh, "shape", None)  # a parallel.mesh.MeshGroup
    if isinstance(shape, Mapping):
        return _mesh_axes(dict(shape))
    raise TypeError(f"cannot interpret mesh spec {mesh!r}")


def dtype_name(feature_dtype) -> str:
    """"float32" for None, else the dtype's short name ("bfloat16")."""
    if feature_dtype is None:
        return "float32"
    return str(feature_dtype).rsplit(".", 1)[-1]


# -- legality checks ---------------------------------------------------------


def _check_coordinate(cc, axes=None) -> None:
    if cc.feature_dtype is not None and cc.layout == "tiled":
        # the JAX package's words
        raise PlanError(
            f"coordinate {cc.name}: feature_dtype is not supported "
            "with layout='tiled'"
        )
    if cc.hbm_budget_mb is not None and not cc.is_random_effect:
        # the streamed fixed effect slices the row axis: only row-major
        # layouts stream; a streamed pass never forms the Hessian; down-
        # sampling is a resident-batch operation (the JAX package's words)
        if cc.layout not in ("auto", "dense", "ell"):
            raise PlanError(
                f"coordinate {cc.name}: hbm_budget_mb on a fixed "
                "effect requires a row-sliceable layout "
                f"(auto|dense|ell), got layout={cc.layout!r}"
            )
        if cc.config.variance_type.upper() != "NONE":
            raise PlanError(
                f"coordinate {cc.name}: variance="
                f"{cc.config.variance_type.upper()} is not supported "
                "with hbm_budget_mb on a fixed effect (out-of-core "
                "row slices never materialize the Hessian); use "
                "variance=NONE"
            )
        if cc.config.down_sampling_rate < 1.0:
            raise PlanError(
                f"coordinate {cc.name}: down_sampling_rate < 1 is not "
                "supported with hbm_budget_mb on a fixed effect"
            )
    if cc.layout == "tiled" and axes is None:
        raise PlanError(
            f"coordinate {cc.name}: layout='tiled' requires the "
            "estimator to be built with a device mesh"
        )
    if cc.feature_dtype is not None and dtype_name(cc.feature_dtype) not in ("float32", "bfloat16"):
        raise PlanError(f"coordinate {cc.name}: feature_dtype must be float32 or bfloat16")


def _rows_per_slice(budget_bytes: int, row_bytes: int) -> int:
    """``game.fe_streaming.rows_per_slice`` for a dense row of
    ``row_bytes`` (copied: the planner imports no torch)."""
    r = max(budget_bytes // max(2 * row_bytes, 1), _ROW_MULTIPLE)
    return int(r // _ROW_MULTIPLE * _ROW_MULTIPLE)


def check_multiprocess_mesh(n_processes: int, mesh) -> None:
    """The topologies the port runs: one process, or ``n_processes`` ranks
    of one card each, with no mesh or a (data x model) grid of
    ``data * model`` = the process count (the JAX mesh, one device a rank,
    laid out row-major: ``parallel.mesh.make_mesh``). A grid of another
    size is ROADMAP A10."""
    axes = _mesh_axes(mesh)
    if axes is None:
        return
    if axes[DATA_AXIS] * axes[MODEL_AXIS] != max(int(n_processes), 1):
        raise not_ported(
            f"a mesh of data={axes[DATA_AXIS]} x model={axes[MODEL_AXIS]} devices over {n_processes} process(es) "
            "(the port runs one card a process: data * model must equal the process count)", A10,
        )


def _sharding(cc, axes, multi: bool) -> str:
    """The JAX package's sharding label of a coordinate: a streamed one
    spread over processes or a mesh streams each rank's own share."""
    spread = multi or axes is not None
    if cc.hbm_budget_mb is not None and spread:
        if cc.is_random_effect:
            return "entity-sharded (host-resident blocks)"
        return "host-sharded rows (streamed slices)"
    if cc.is_random_effect:
        return "entity-sharded" if multi else "single-device"
    if cc.layout == "tiled" or (axes is not None and axes[MODEL_AXIS] > 1):
        return "row+model-sharded"
    return "row-sharded" if multi else "single-device"


def _check_multiprocess_coordinate(cc, axes, multi: bool) -> None:
    """A resident sparse fixed effect over several processes or a mesh, in
    the JAX package's words: a COO batch is not row-partitionable, and a
    resident ELL batch's width is its local rows' max nnz, so the ranks'
    shapes would disagree (a streamed ELL never crosses a rank: its width
    is the rank's own). The words are ``parallel.mesh``'s, imported here
    only to refuse: the planner imports no torch."""
    if cc.is_random_effect or cc.hbm_budget_mb is not None:
        return
    if cc.layout in ("coo", "sparse") and (multi or axes is not None):
        from ..parallel.mesh import SHARD_COO_REFUSAL

        raise PlanError(SHARD_COO_REFUSAL)
    if cc.layout == "ell" and multi:
        from ..parallel.mesh import MULTI_ELL_REFUSAL

        raise PlanError(MULTI_ELL_REFUSAL)


def check_lane_composition(
    coordinate_configs: Sequence,
    n_lanes: int,
    *,
    mesh=None,
    n_processes: int = 1,
    distributed: bool = False,
    pipeline_depth: int = 1,
    partial_retrain_locked: Sequence[str] = (),
) -> None:
    """Refuse compositions the trial-lane path does not support. The
    messages are the JAX package's, verbatim (its README support matrix and
    tests/test_support_matrix.py pin them)."""
    if n_lanes < 1:
        raise PlanError(f"trial-lanes must be >= 1: {n_lanes}")
    if _mesh_axes(mesh) is not None:
        raise PlanError(
            "trial-lanes sweeps are single-chip: not composable with a "
            "device mesh (the lane axis already fills the chip; shard "
            "trials across hosts instead)"
        )
    if distributed or n_processes > 1:
        raise PlanError(
            "trial-lanes sweeps are single-process: not composable with "
            "multi-process training"
        )
    if pipeline_depth > 1:
        raise PlanError(
            "trial-lanes sweeps drive their own lane schedule: not "
            "composable with pipeline_depth > 1"
        )
    if partial_retrain_locked:
        raise PlanError(
            "partial retraining (locked coordinates) is not supported "
            "with trial-lanes"
        )
    for cc in coordinate_configs:
        where = f"coordinate {cc.name}"
        if cc.hbm_budget_mb is not None:
            raise PlanError(
                f"{where}: trial-lanes sweeps require HBM-resident "
                "coordinates (hbm_budget_mb streams the data; the lane "
                "axis multiplies its residency)"
            )
        if cc.config.regularization.reg_type in ("L1", "ELASTIC_NET"):
            raise PlanError(
                f"{where}: trial-lanes sweeps support L2 regularization "
                "only (the OWL-QN l1 weight is compile-time static, not a "
                "per-lane operand)"
            )
        if cc.config.variance_type.upper() != "NONE":
            raise PlanError(
                f"{where}: trial-lanes sweeps require variance=NONE"
            )
        if cc.config.down_sampling_rate < 1.0:
            raise PlanError(
                f"{where}: down-sampling is not supported with trial-lanes"
            )
        if cc.normalization is not None:
            raise PlanError(
                f"{where}: feature normalization is not supported with "
                "trial-lanes"
            )
        if cc.regularize_by_prior:
            raise PlanError(
                f"{where}: regularize-by-prior is not supported with "
                "trial-lanes"
            )


def check_retrain_composition(
    distributed: bool, trial_lanes: int, streamed_coordinates=()
) -> None:
    """The JAX package's refusals of the incremental-retrain compositions,
    copied verbatim: the day chain is a local control loop, trial lanes have
    no per-lane prior, and streamed coordinates never materialize the
    host-resident models the per-day merge carries forward."""
    if distributed:
        raise PlanError(
            "incremental retrain is single-process: not composable with "
            "--distributed (the day chain's ledger, model merge and serving "
            "publish are host-local; shard the feed by day across hosts "
            "instead)"
        )
    if trial_lanes and trial_lanes > 1:
        raise PlanError(
            "incremental retrain warm-starts with regularize-by-prior: not "
            "composable with --trial-lanes (the lane solver has no per-lane "
            "prior operand)"
        )
    streamed = [str(c) for c in streamed_coordinates if c]
    if streamed:
        raise PlanError(
            "incremental retrain requires HBM-resident coordinates: not "
            "composable with hbm.budget.mb streaming (the per-day entity "
            f"merge carries host-resident models forward) — remove "
            f"hbm.budget.mb from {sorted(streamed)}"
        )


def check_fleet_composition(
    model_names: Sequence[str],
    front_replicas: Optional[Sequence[str]] = None,
) -> None:
    """The JAX package's refusals of the illegal serving-fleet compositions,
    copied: the multi-model ``ModelSet`` and the replica front
    (``serving/fleet.py``, ``serving/front.py``) both route by name, so
    ambiguous names and unroutable replica addresses are plan errors.

    ``model_names`` is the fleet's model list as given (ordered, possibly
    repeated: ``--models`` flags, ModelSet pairs); ``front_replicas`` is
    the replica address list handed to the least-loaded front."""
    seen = set()
    for name in model_names:
        if name in seen:
            raise PlanError(
                f"duplicate model name in the serving fleet: {name!r} — "
                "request-protocol model= routing needs one bulkhead per "
                "name; give each resident snapshot a distinct --models name"
            )
        seen.add(name)
    for addr in front_replicas or ():
        host, sep, port = str(addr).rpartition(":")
        if not sep or not host or not port.isdigit():
            raise PlanError(
                "the replica front routes over TCP replicas: not composable "
                f"with AF_UNIX socket paths (got {addr!r}; give each "
                "replica a host:port --listen address)"
            )


# -- checkpoint topology (resume legality across topology changes) ----------


def plan_fingerprint(plan: ExecutionPlan) -> str:
    """A stable digest of the plan facts that must MATCH for a checkpoint
    to be resumable: the coordinate set and each coordinate's layout,
    feature dtype, kind and residency, plus the normalization mode (the
    JAX package's digest of the same facts)."""
    facts = {
        "coordinates": [
            {
                "name": c.name,
                "kind": c.kind,
                "layout": c.layout,
                "feature_dtype": c.feature_dtype,
                "residency": c.residency,
            }
            for c in plan.coordinates
        ],
        "normalization": plan.normalization,
    }
    blob = json.dumps(facts, sort_keys=True).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def check_checkpoint_topology(saved: Mapping, current: Mapping) -> None:
    """Judge whether a checkpoint written under ``saved`` topology may be
    restored by a run under ``current`` topology (keys, each optional:
    ``n_processes``, ``mesh_axes``, ``global_rows``, ``plan_fingerprint``).
    The JAX package's rules, copied: the same topology resumes; a
    model-axis change, a process-count change whose global row totals
    disagree, and a changed plan fingerprint raise."""

    def _axes(t: Mapping) -> Optional[Dict[str, int]]:
        try:
            return _mesh_axes(t.get("mesh_axes"))
        except TypeError:
            return None

    saved_model = (_axes(saved) or {}).get(MODEL_AXIS, 1)
    current_model = (_axes(current) or {}).get(MODEL_AXIS, 1)
    if saved_model != current_model:
        raise PlanError(
            "checkpoint mesh reshape across the model axis is not "
            f"supported: the checkpoint was saved with model={saved_model}, "
            f"this run uses model={current_model}; resume on a mesh with "
            "the same model axis (data-axis reshapes are the legal ones)"
        )
    saved_p, current_p = saved.get("n_processes"), current.get("n_processes")
    saved_rows = saved.get("global_rows")
    current_rows = current.get("global_rows")
    if (
        saved_p is not None
        and current_p is not None
        and int(saved_p) != int(current_p)
        and saved_rows is not None
        and current_rows is not None
        and int(saved_rows) != int(current_rows)
    ):
        raise PlanError(
            "cannot resume: the process count changed and no legal reshape "
            f"exists — the padded global row totals disagree ({saved_rows} "
            f"rows saved under {saved_p} process(es), {current_rows} under "
            f"{current_p}: per-host padding rows would land inside the "
            "data); rerun with the original process count, or a row count "
            "whose per-host padding agrees"
        )
    saved_fp = saved.get("plan_fingerprint")
    current_fp = current.get("plan_fingerprint")
    if saved_fp and current_fp and saved_fp != current_fp:
        raise PlanError(
            "resuming across a changed execution plan is not supported: "
            f"the checkpoint's plan fingerprint {saved_fp} != this run's "
            f"{current_fp} (the coordinate set, a layout, a feature dtype "
            "or a residency changed — the snapshot would silently train a "
            "different model); rerun the original configuration or start a "
            "fresh checkpoint directory"
        )


# -- the planner -------------------------------------------------------------


def resolve(
    coordinate_configs: Sequence,
    *,
    mesh=None,
    n_processes: int = 1,
    pipeline_depth: int = 1,
    trial_lanes: int = 1,
    distributed: bool = False,
    partial_retrain_locked: Sequence[str] = (),
    normalization: str = "NONE",
    dims: Optional[Dict[str, int]] = None,
) -> ExecutionPlan:
    """Resolve the execution configuration, or raise one typed PlanError.

    ``coordinate_configs`` are ``CoordinateConfig``-shaped objects (name,
    feature_shard, layout, feature_dtype, hbm_budget_mb, is_random_effect,
    regularize_by_prior). ``dims`` optionally maps feature-shard name ->
    dimension; a fixed effect on ``layout=auto`` then records the layout
    the batch build picks (dense up to d = 4,096, ELL above)."""
    if pipeline_depth < 1:
        raise PlanError(f"pipeline depth must be >= 1: {pipeline_depth}")
    multi = distributed or n_processes > 1
    check_multiprocess_mesh(n_processes, mesh)
    if trial_lanes > 1:
        check_lane_composition(
            coordinate_configs, trial_lanes, mesh=mesh, n_processes=n_processes, distributed=distributed,
            pipeline_depth=pipeline_depth, partial_retrain_locked=partial_retrain_locked,
        )
    elif trial_lanes < 1:
        raise PlanError(f"trial-lanes must be >= 1: {trial_lanes}")

    plans = []
    axes = _mesh_axes(mesh)
    for cc in coordinate_configs:
        _check_coordinate(cc, axes)
        _check_multiprocess_coordinate(cc, axes, multi)
        geometry: Dict[str, object] = {}
        dim = (dims or {}).get(cc.feature_shard)
        if dim is not None:
            geometry["dim"] = int(dim)
            if not cc.is_random_effect and cc.layout == "auto":
                geometry["batch_layout"] = "dense" if dim <= 4096 else "ell"
        if not cc.is_random_effect and cc.layout == "tiled":
            geometry["grid"] = f"data={axes[DATA_AXIS]} x model={axes[MODEL_AXIS]}"
            if dim is not None:
                # the rank's tile: its data row's rows, its model slice's columns
                geometry["tile_columns"] = -(-int(dim) // axes[MODEL_AXIS])
                geometry["dim_padded"] = geometry["tile_columns"] * axes[MODEL_AXIS]
        if cc.is_random_effect and (axes is not None or multi):
            # the JAX package's: the data axis, here the process count
            geometry["entity_shards"] = axes[DATA_AXIS] if axes is not None else int(n_processes)
        notes: Tuple[str, ...] = ()
        if cc.hbm_budget_mb is not None:
            budget = int(cc.hbm_budget_mb) * (1 << 20)
            geometry["budget_bytes"] = budget
            if dim is not None and not cc.is_random_effect:
                row_bytes = int(dim) * (2 if dtype_name(cc.feature_dtype) == "bfloat16" else 4)
                geometry["rows_per_slice"] = _rows_per_slice(budget, row_bytes)
                geometry["slice_row_bytes"] = row_bytes
            # the JAX package's: a fixed effect's with its slice geometry
            if n_processes > 1 and (cc.is_random_effect or dim is not None):
                geometry["hosts_streaming"] = int(n_processes)
            if multi or axes is not None:
                notes += (
                    "streamed under a mesh: each host streams its own shard "
                    "(FE: local row slices; RE: local entity blocks) under the "
                    "per-host budget",
                )
            notes += ("streams only when the build estimate exceeds the budget; a batch that fits stays resident",)
        plans.append(
            CoordinatePlan(
                name=cc.name,
                kind="random-effect" if cc.is_random_effect else "fixed-effect",
                layout=cc.layout,
                feature_dtype=dtype_name(cc.feature_dtype),
                residency="streamed" if cc.hbm_budget_mb is not None else "resident",
                sharding=_sharding(cc, axes, multi),
                pipelined=pipeline_depth > 1,
                hbm_budget_mb=cc.hbm_budget_mb,
                geometry=geometry,
                notes=notes,
            )
        )

    return ExecutionPlan(
        coordinates=tuple(plans),
        mesh_axes=_mesh_axes(mesh),
        n_processes=int(n_processes),
        pipeline_depth=pipeline_depth,
        trial_lanes=trial_lanes,
        normalization=normalization,
        distributed=bool(distributed),
    )
