"""GAME training driver.

The JAX package's ``cli/train.py`` on the port. Reference: photon-client
.../cli/game/training/GameTrainingDriver.scala:54-854 (§3.1 call stack):
read+index data -> validate -> normalization -> expand optimization
configs -> GameEstimator.fit -> model selection (output mode ALL/BEST) ->
save models in Photon ML's layout.

Usage:
  python -m photon_ml_tpu_torch.cli.train \\
    --input-data train.avro --validation-data val.avro \\
    --task logistic_regression \\
    --feature-shard name=globalShard,bags=features \\
    --feature-shard name=userShard,bags=userFeatures \\
    --coordinate name=global,shard=globalShard,optimizer=TRON,reg.type=L2,reg.weights=1|10 \\
    --coordinate name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1 \\
    --evaluators AUC,LOGISTIC_LOSS --output-dir out/ [--device cpu] [--dtype float64]

Hyperparameter tuning (GameTrainingDriver.scala:642-673): with
``--validation-data``, ``--hyper-parameter-tuning RANDOM|BAYESIAN`` searches
each coordinate's log regularization weight for
``--hyper-parameter-tuning-iter`` trials after the grid, seeded with the
grid's results; ``--trial-lanes K`` trains each batch of K candidates as
lambda lanes of one solve (``game/lanes.py``); ``--hyper-parameter-config``
and ``--hyper-parameter-prior`` set and shrink the search ranges; every
observation is written to ``hyperparameter-prior.json``. ``--output-mode
TUNED`` saves the best of the grid and the trials.

Datasets, normalization and models live on ``--device`` (the card by
default; without a card the driver raises unless ``--device cpu`` is given,
which runs the kernels' plain versions). ``--dtype`` is the solve's float
type (float32 by default; the JAX package takes its default float).

``--checkpoint-dir`` saves the model after every sweep and each finished
grid configuration (rerunning the same command resumes from the last
completed unit); ``--checkpoint-every N`` adds boundary snapshots of the
whole coordinate-descent state every N coordinate updates, and
``--resume`` continues from the newest valid one bit for bit.
``PHOTON_FAULTS`` injects faults at the port's sites
(``robust/fault_sites.json``).

Telemetry, as in the JAX package: ``--metrics-out DIR`` writes
metrics.jsonl, metrics.prom and run_summary.json, and installs a flight
recorder that dumps ``DIR/flight/flight-<kind>-<n>.json`` when a solver
diverges, an update is rejected or the run crashes; ``--trace-out PATH``
writes the run's Chrome trace (one complete event per span, loadable at
ui.perfetto.dev) and puts the per-sweep phase attribution under
``timeline`` in run_summary.json (beside the trace without
``--metrics-out``); ``--status-port P`` serves ``/metrics``, ``/healthz``
and ``/statusz`` while the run lasts (0: a free port); ``--report-out DIR``
writes report.json and report.html after the run, built from the artifacts
on disk as ``cli.report`` rebuilds them (the metrics directory defaults to
it). Memory is sampled at every sweep boundary and once at the end: host
RSS and the run's card's allocator counters.

Incremental training (GameTrainingDriver's warm start): ``--model-input-dir``
warm-starts every coordinate from a saved GAME model; with
``--incremental-training`` (which requires it) each coordinate's L2 is
centred on that model, after ``io.model_io.check_prior_compatibility`` has
checked the model's features against the current index (logged);
``--partial-retrain-locked a,b`` keeps those coordinates at the loaded
model and trains the rest. ``cli.retrain`` chains this day by day.

Out-of-core training: ``hbm.budget.mb=N`` in a ``--coordinate`` spec streams
that coordinate when its device bytes exceed N MiB (the fixed effect's row
slices, the random effect's entity slices, through the card), and
``--pipeline-depth 2`` overlaps staging, solve and validation across the
sweep (``game/pipeline.py``); the report's streaming block reads their
``photon_stream_*`` series. Both compose with ``--distributed``: each
process streams its own rows and its own entity range under the budget
(a process's own ``photon_stream_*`` series go to its ``metrics.p<i>.*``),
each pass of the fixed effect is summed over the processes, and the
validation runs on the main thread.

Several processes: ``--distributed coordinator=HOST:PORT,process=I,n=P``
(or ``auto`` under torchrun) joins P processes, one card each (the backend
follows from the devices: NCCL where every rank on the host has a card of
its own, gloo where ranks share one or run on the CPU; run_summary.json
records which ran). Each process reads its own row range of the input
(``--feature-index-dir`` is required, so that every process indexes
alike), pads it to the common share, and builds its shard of the fixed
effect and its entity range of the random effect (the cross-process build,
``game/data_mp.py``); every sweep's B1-B3 sums are joined by B4, so every
process holds the same models. The validation data is read whole on every
process. Only process 0 writes outputs, summaries and checkpoint state;
resume state and checkpointed models load on process 0 and are broadcast,
so no shared file system is needed (a boundary checkpoint is the two-phase
save of ``robust/checkpoint.py``). ``--mesh-shape data=P`` names the same
topology. ``--mesh-shape data=D,model=M`` over ``n=D*M`` processes lays
them out as a (data x model) grid (``parallel.mesh.make_mesh``): a
``layout=tiled`` fixed effect solves on every rank of the grid, each data
row of M processes reads its rows, a dense fixed effect is that data row's
row shard replicated over the model axis (each model column runs B1-B3
through B4 over its data subgroup), the random effects are built over the
data axis, and the ranks of a data row hold the same models; only world
rank 0 writes. Liveness (``robust/distributed.py``):
``--collective-timeout`` bounds every barrier (the sweep boundaries and
the object collectives' entries; 0 disarms), ``--heartbeat-interval`` and
``--heartbeat-timeout`` run the heartbeat plane under
``<checkpoint-dir|metrics-out>/heartbeats``; a dead peer ends the run with
a typed ``DistributedTimeoutError`` or ``PeerLostError``, a ``peer_lost``
flight-recorder dump and a non-zero exit. Process i > 0 (its world rank)
streams its telemetry to ``metrics.p<i>.jsonl`` / ``.prom`` and
``flight.p<i>/`` beside the coordinator's (``cli.fleetz`` merges them).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import logging
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..device import pin_device, resolve_device
from ..estimators.game_estimator import GameEstimator, GameResult, GameTransformer
from ..io.data import read_avro_dataset, read_avro_dataset_chunked, resolve_ingest_workers
from ..io.model_io import load_game_model, save_game_model
from ..ops.normalization import build_normalization
from ..parallel import multihost
from ..plan import PlanError, plan_fingerprint
from ..robust import CheckpointManager, atomic_write, atomic_write_json, faults
from ..robust import distributed as robust_dist
from ..robust.checkpoint import CheckpointIncompatibleError, to_device
from ..tuning.rescaling import HyperparameterConfig, ParamRange
from ..tuning.tuner import get_tuner
from ..utils.futures import WorkerPool
from ..utils.logging import setup_logging
from ..utils.stats import compute_feature_statistics, save_feature_statistics
from .params import (
    add_common_io_args,
    build_shard_configs,
    parse_coordinate,
    parse_input_columns,
    parse_mesh_shape,
    parse_pipeline_depth,
    plan_host_row_split,
    resolve_input_paths,
)

logger = logging.getLogger("photon_ml_tpu_torch")

OUTPUT_MODE_ALL = "ALL"
OUTPUT_MODE_BEST = "BEST"
OUTPUT_MODE_TUNED = "TUNED"

DTYPES = {"float32": torch.float32, "float64": torch.float64}
NORMALIZATIONS = ["NONE", "STANDARDIZATION", "SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE"]
DEFAULT_COORDINATE = "name=global,shard=global,optimizer=LBFGS,reg.type=L2,reg.weights=1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch game training driver")
    add_common_io_args(p)
    p.add_argument("--validation-data", default=None)
    p.add_argument("--task", default="logistic_regression")
    p.add_argument("--coordinate", action="append", default=[],
                   help="coordinate configuration spec (repeatable, ordered)")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--validation-frequency", default="COORDINATE", choices=["COORDINATE", "SWEEP"],
                   help="evaluate validation metrics after every coordinate update or once per sweep")
    p.add_argument("--evaluators", default="", help="comma-separated evaluator specs")
    p.add_argument("--validate-data", default="disabled", choices=["full", "sample", "quarantine", "disabled"],
                   help="input data validation: 'full' checks every row and fails on problems, 'sample' "
                        "~1%% of rows (seeded by --seed), 'quarantine' zero-weights offending rows "
                        "(photon_rows_quarantined_total), 'disabled' skips it")
    p.add_argument("--seed", type=int, default=0, help="run seed for seeded subsampling")
    p.add_argument("--no-divergence-guard", action="store_true",
                   help="disable the coordinate-descent divergence guard (and its fetch per update)")
    p.add_argument("--coordinate-rejection-tolerance", type=float, default=None,
                   help="additionally reject an update whose training loss regresses more than this")
    p.add_argument("--pipeline-depth", type=parse_pipeline_depth, default=1,
                   help="sweep pipelining depth: 1 is the serial sweep; 2 or more overlaps streamed "
                        "staging, the solve and validation evaluation, with the serial run's bits")
    p.add_argument("--explain-plan", action="store_true",
                   help="dry run: resolve the execution plan from the flags alone, print it and exit 0 "
                        "without reading data or touching a device; a refused configuration prints its "
                        "PlanError and exits 1")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--output-mode", default=OUTPUT_MODE_BEST,
                   choices=[OUTPUT_MODE_ALL, OUTPUT_MODE_BEST, OUTPUT_MODE_TUNED])
    p.add_argument("--model-input-dir", default=None,
                   help="warm-start GAME model directory (every coordinate starts from it)")
    p.add_argument("--incremental-training", action="store_true",
                   help="regularize each coordinate toward the --model-input-dir model (prior-centred L2)")
    p.add_argument("--partial-retrain-locked", default="",
                   help="comma-separated coordinates kept at the --model-input-dir model, not retrained")
    p.add_argument("--normalization", default="NONE", choices=NORMALIZATIONS)
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0)
    p.add_argument("--compute-feature-stats", action="store_true")
    p.add_argument("--hyper-parameter-tuning", default="NONE", choices=["NONE", "RANDOM", "BAYESIAN"],
                   help="search the coordinates' regularization weights after the grid (needs "
                        "--validation-data): RANDOM (Sobol) or BAYESIAN (Gaussian process)")
    p.add_argument("--hyper-parameter-tuning-iter", type=int, default=10)
    p.add_argument("--trial-lanes", type=int, default=1,
                   help="tuning trials trained together as lambda lanes of one batched solve "
                        "(game/lanes.py); 1 = the sequential trial loop")
    p.add_argument("--hyper-parameter-config", default=None,
                   help="JSON tuning config (tuning_mode + variables map); overrides the default "
                        "per-coordinate log-reg-weight ranges")
    p.add_argument("--hyper-parameter-prior", default=None,
                   help="JSON prior observations ({'records': [...]}) that shrink the search range "
                        "around the GP-predicted best prior candidate")
    p.add_argument("--hyper-parameter-shrink-radius", type=float, default=0.25)
    p.add_argument("--mesh-shape", default="",
                   help="data=D[,model=M]: the D*M processes of --distributed as a (data x model) grid, one "
                        "card each (a model axis shards layout=tiled fixed effects over the whole grid and "
                        "replicates dense ones over the model axis)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the model after every coordinate-descent sweep (and each finished grid "
                        "config); rerunning the same command resumes from the last completed unit")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="additionally snapshot the whole coordinate-descent state every N "
                        "coordinate-update boundaries under <checkpoint-dir>/cd-boundaries; 0 disables")
    p.add_argument("--checkpoint-keep", type=int, default=3, help="boundary checkpoints retained")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest VALID boundary checkpoint under "
                        "<checkpoint-dir>/cd-boundaries, bit-identical to the uninterrupted run")
    p.add_argument("--distributed", default=None,
                   help="several processes: 'coordinator=HOST:PORT,process=I,n=P' (or 'auto' for torchrun's "
                        "environment); each process reads its own row range and only process 0 writes outputs")
    p.add_argument("--collective-timeout", type=float, default=60.0,
                   help="several processes: budget in seconds for the guarded collectives and the per-sweep "
                        "liveness barrier; a dead peer raises a typed DistributedTimeoutError within it (and a "
                        "peer_lost flight-recorder dump) instead of hanging. 0 disables")
    p.add_argument("--heartbeat-interval", type=float, default=1.0,
                   help="several processes: seconds between the liveness records each process writes under "
                        "<checkpoint-dir|metrics-out>/heartbeats (the photon_dist_heartbeat_age_seconds{process=} "
                        "gauge; they name the stale peer in a timeout). 0 disables the heartbeat plane")
    p.add_argument("--heartbeat-timeout", type=float, default=10.0,
                   help="several processes: a peer whose newest heartbeat is older than this many seconds is "
                        "reported as presumed lost")
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--metrics-out", default=None,
                   help="directory for run telemetry: metrics.jsonl (one line per span / per-sweep "
                        "metrics flush), metrics.prom (Prometheus text), run_summary.json and flight/ "
                        "(flight-recorder postmortems of divergences, rejections and crashes)")
    p.add_argument("--trace-out", default=None,
                   help="write the run's Chrome trace here (ui.perfetto.dev); the per-sweep phase "
                        "attribution goes under 'timeline' in run_summary.json")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve live /metrics, /healthz and /statusz on this port while the run lasts "
                        "(0 = a free port)")
    p.add_argument("--report-out", default=None,
                   help="write report.json and report.html here after the run, from the artifacts on "
                        "disk (--metrics-out defaults to this directory)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    return p


def run(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, args.log_file)
    if args.explain_plan:
        # dry run: resolve and print the execution plan from the flags
        # alone; no data read, no device touched
        return _explain_plan(args)
    # PHOTON_FAULTS / PHOTON_FAULTS_SEED; an absent variable clears any
    # injector a previous in-process run installed
    faults.install_from_env()
    device = resolve_device(args.device)
    group = None
    if args.distributed:
        # the rank binds its card before the group forms; a rank whose
        # card is missing raised in resolve_device above
        group = multihost.initialize_from_spec(args.distributed, device=device)
        logger.info("distributed: process %d/%d over %s on %s", group.rank, group.world_size, group.backend,
                    group.device)
        # span and JSONL lane identity, so that merged telemetry stays
        # attributable
        obs.set_process_index(group.rank)
        axes = parse_mesh_shape(args.mesh_shape)
        if axes is not None and axes["model"] > 1:
            # the grid before the reads: each data row reads its own rows
            from ..parallel.mesh import make_mesh
            from ..plan.planner import check_multiprocess_mesh

            check_multiprocess_mesh(group.world_size, axes)
            mesh = make_mesh(axes["data"], axes["model"], group=group)
            multihost.set_grid(mesh)
            logger.info("grid: process %d at data %d, model %d of data=%d x model=%d", group.rank,
                        mesh.data_index, mesh.model_index, mesh.n_data, mesh.n_model)
    try:
        return _run_group(args, device, group)
    except robust_dist.DistributedError:
        # a dead peer: tearing the group down would wait on it
        group = None
        raise
    finally:
        if group is not None:
            multihost.shutdown()


def _run_group(args, device, group) -> Dict:
    """The run once this process has joined its group (or runs alone)."""
    coordinator = multihost.is_coordinator()
    # every process streams its own telemetry, so that cli.fleetz can merge
    # the fleet's view; the coordinator keeps the bare file names
    suffix = "" if coordinator else f".p{multihost.world_rank()}"

    t_run0 = time.perf_counter()
    run_t = None
    prev_run = None
    sinks = []
    recorder = None
    flight = None
    status_server = None
    if args.report_out and not args.metrics_out:
        # the report is rebuilt from the artifacts on disk: without a
        # metrics directory its trajectories would have nothing to read, so
        # the report directory doubles as it
        args.metrics_out = args.report_out
    if args.metrics_out or args.trace_out or args.status_port is not None:
        run_t = obs.RunTelemetry()
        obs.record_build_info(run_t.registry)
        if args.metrics_out:
            os.makedirs(args.metrics_out, exist_ok=True)
            # anomaly postmortems (solver divergence, coordinate rejection,
            # crash, a lost peer): the last window of spans and metrics, one
            # dump an incident
            flight = obs.FlightRecorder(os.path.join(args.metrics_out, f"flight{suffix}"), run=run_t)
            sinks += [
                obs.JsonlSink(os.path.join(args.metrics_out, f"metrics{suffix}.jsonl")),
                obs.PrometheusSink(os.path.join(args.metrics_out, f"metrics{suffix}.prom")),
                flight,
            ]
        if args.trace_out and coordinator:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)), exist_ok=True)
            recorder = obs.TimelineRecorder()
            sinks.append(recorder)
        for sink in sinks:
            run_t.register_listener(sink)
        prev_run = obs.set_current_run(run_t)
        if group is not None:
            run_t.distributed = {"backend": group.backend, "world_size": group.world_size}
        if args.status_port is not None and coordinator:
            status_server = obs.IntrospectionServer(run_t, port=args.status_port)
            logger.info("introspection endpoints -> http://127.0.0.1:%d/{metrics,healthz,statusz}",
                        status_server.port)
    # the liveness plane (robust.distributed): heartbeat records in a shared
    # directory and a process-wide collective budget, so that a dead peer is
    # a bounded-time typed failure instead of a hang
    hb_writer = None
    if group is not None and group.world_size > 1:
        hb_root = args.checkpoint_dir or args.metrics_out
        hb_dir = os.path.join(hb_root, "heartbeats") if hb_root else None
        if hb_dir and args.heartbeat_interval > 0:
            hb_writer = robust_dist.HeartbeatWriter(hb_dir, group.rank, interval_s=args.heartbeat_interval).start()
        robust_dist.configure_collectives(args.collective_timeout, run_dir=hb_dir,
                                          stale_after_s=args.heartbeat_timeout)
    try:
        summary = _run_training(args, device, run_t, sinks, t_run0, recorder)
    except BaseException as exc:
        # crash-flush: an abort (an injected SimulatedKill included) still
        # dumps its postmortem and leaves run_summary.json, marked
        # "aborted", with the timeline of the spans that closed before it
        if flight is not None:
            # a collective timeout or a stale peer is this process's view of
            # a PEER's death: its own trigger kind
            kind = "peer_lost" if isinstance(exc, robust_dist.DistributedError) else "crash"
            try:
                flight.trigger(kind, detail=f"{type(exc).__name__}: {exc}")
            except Exception:
                obs.swallowed_error("cli.flightrec_crash_dump")
        if run_t is not None and coordinator:
            try:
                _write_run_summary(args, run_t, recorder, t_run0, aborted=True)
            except Exception:
                obs.swallowed_error("cli.run_summary_flush")
                logger.exception("could not flush partial run summary")
        raise
    finally:
        if hb_writer is not None:
            hb_writer.stop()
        robust_dist.clear_collectives()
        if status_server is not None:
            status_server.stop()
        if run_t is not None:
            # the final flush: the last metrics.jsonl line and metrics.prom
            run_t.close()
            obs.set_current_run(prev_run)
    if args.report_out and coordinator:
        _emit_report(args)
    return summary


def _explain_plan(args) -> Dict:
    """``--explain-plan``: resolve the ExecutionPlan from the parsed flags and
    print it, reading no data and touching no device. A refused
    configuration prints its PlanError and exits 1."""
    from ..plan import resolve as resolve_plan

    try:
        coords = [parse_coordinate(s) for s in (args.coordinate or [DEFAULT_COORDINATE])]
        n_processes = 1
        if args.distributed and args.distributed != "auto":
            n_processes = multihost.parse_spec(args.distributed)["n"]
        if args.incremental_training:
            for cc in coords:
                cc.regularize_by_prior = True
        dims = None
        if args.feature_index_dir:
            from ..io.index_map import load_partitioned

            try:
                dims = {s: load_partitioned(args.feature_index_dir, s).size for s in build_shard_configs(args)}
            except (OSError, ValueError, KeyError):
                # the dims only enrich the printed plan; a dry run never fails on them
                dims = None
        plan = resolve_plan(
            coords, trial_lanes=args.trial_lanes, normalization=args.normalization, dims=dims,
            partial_retrain_locked=_locked(args), pipeline_depth=args.pipeline_depth,
            mesh=parse_mesh_shape(args.mesh_shape), n_processes=n_processes, distributed=bool(args.distributed),
        )
    except PlanError as e:
        print(f"plan refused: {e}", file=sys.stderr)
        raise SystemExit(1)
    print(plan.pretty())
    return {"plan": plan.to_dict()}


def normalize_fixed_effects(normalization: str, coords, raw, index_maps, dtype, device) -> None:
    """Set each fixed-effect coordinate's normalization (``NONE`` leaves
    them unnormalized) from the feature statistics of ``raw``."""
    if normalization == "NONE":
        return
    for cc in coords:
        if not cc.is_random_effect:
            stats = compute_feature_statistics(raw, cc.feature_shard)
            cc.normalization = build_normalization(
                normalization, stats["mean"], stats["variance"], stats["max_magnitude"],
                intercept_index=index_maps[cc.feature_shard].intercept_index, dtype=dtype, device=device,
            )


def _locked(args) -> List[str]:
    return [c for c in args.partial_retrain_locked.split(",") if c]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_training(args, device, run_t, sinks, t_run0, recorder) -> Dict:
    dtype = DTYPES[args.dtype]
    stage_seconds: Dict[str, float] = {}
    t_stage = [time.perf_counter()]

    def stage_done(name):
        _sync(device)
        t1 = time.perf_counter()
        stage_seconds[name] = stage_seconds.get(name, 0.0) + t1 - t_stage[0]
        t_stage[0] = t1

    shards = build_shard_configs(args)
    id_tags = [t for t in args.id_tags.split(",") if t]
    coords = [parse_coordinate(s) for s in (args.coordinate or [DEFAULT_COORDINATE])]
    for cc in coords:
        if cc.is_random_effect and cc.random_effect_type not in id_tags:
            id_tags.append(cc.random_effect_type)

    input_paths = resolve_input_paths(args)
    input_columns = parse_input_columns(args)
    logger.info("reading training data from %s", input_paths)
    index_maps = None
    if args.feature_index_dir:
        from ..io.index_map import load_partitioned

        index_maps = {s: load_partitioned(args.feature_index_dir, s) for s in shards}

    n_proc = multihost.process_count()
    row_range = equal_share = part_counts = None
    if n_proc > 1:
        if index_maps is None:
            raise SystemExit(
                "multi-process training requires --feature-index-dir (index maps built per process would "
                "disagree across processes)"
            )
        row_range, part_counts = plan_host_row_split(input_paths)
        total_rows = sum(part_counts.values())
        # every process pads its range to one share, so that the padded
        # global row space is the processes' shares in process order
        equal_share = multihost.equal_host_share(total_rows)
        logger.info("process %d reads rows [%d, %d) of %d (padded to %d)", multihost.process_index(),
                    row_range[0], row_range[1], total_rows, equal_share)
    ingest_pool = None
    if n_proc == 1:
        # pooled ingest: parts decode concurrently on the shared pool, and
        # the SAME pool later runs the background validation decode
        n_ingest_workers = resolve_ingest_workers(args.ingest_workers)
        ingest_pool = WorkerPool(n_ingest_workers, name="photon-ingest")
    try:
        if ingest_pool is not None:
            raw, index_maps = read_avro_dataset_chunked(
                input_paths, shards, index_maps=index_maps, id_tag_columns=id_tags,
                response_column=args.response_column, columns=input_columns,
                workers=n_ingest_workers, pool=ingest_pool,
            )
        else:
            # several processes: this process's row range, read on the main
            # thread (the collectives' order must not depend on a pool)
            raw, index_maps = read_avro_dataset(
                input_paths, shards, index_maps=index_maps, id_tag_columns=id_tags,
                response_column=args.response_column, columns=input_columns,
                row_range=row_range, part_counts=part_counts,
            )
            raw.global_row_start = row_range[0]
        if args.validate_data != "disabled":
            from ..io import validators

            mode = {
                "full": validators.VALIDATE_FULL,
                "sample": validators.VALIDATE_SAMPLE,
                "quarantine": validators.VALIDATE_QUARANTINE,
            }[args.validate_data]
            validators.validate_dataset(raw, args.task, mode, rng_seed=args.seed)
        if equal_share is not None:
            # after validation: pad rows are zero-weight rows that would
            # dilute a sample and trip nothing
            raw = raw.pad_rows(equal_share)
        logger.info("training rows: %d; shard dims: %s", raw.n_rows, raw.shard_dims)

        validation = None
        if args.validation_data:
            def _read_validation():
                v, _ = read_avro_dataset(
                    args.validation_data, shards, index_maps=index_maps, id_tag_columns=id_tags,
                    response_column=args.response_column, columns=input_columns,
                )
                return v

            if ingest_pool is not None:
                # decoded on the ingest pool while the training datasets build
                validation = ingest_pool.submit(_read_validation)
            else:
                # several processes: whole on every process, on the main thread
                validation = _read_validation()
    finally:
        if ingest_pool is not None:
            # stop accepting work; the queued validation decode still drains
            ingest_pool.close()
    stage_done("read")

    # normalization from feature statistics (GameTrainingDriver:555-571)
    normalize_fixed_effects(args.normalization, coords, raw, index_maps, dtype, device)
    if args.compute_feature_stats:
        for shard in shards:
            # a collective over several processes: every process computes,
            # the coordinator writes
            stats = compute_feature_statistics(raw, shard)
            if multihost.is_coordinator():
                os.makedirs(args.output_dir, exist_ok=True)
                save_feature_statistics(
                    os.path.join(args.output_dir, f"feature-stats-{shard}.avro"), stats, index_maps[shard],
                )
    stage_done("statistics")

    initial_model = None
    if args.model_input_dir:
        if args.incremental_training:
            # the prior's features against the current index BEFORE the
            # load: load_game_model keys coefficients by (name, term) and
            # drops features the index cannot host, harmless for a warm
            # start, fatal for a prior (a dropped feature's prior would
            # re-centre at zero); a permuted index remaps, a missing
            # feature raises
            from ..io.model_io import check_prior_compatibility

            compat = check_prior_compatibility(args.model_input_dir, index_maps)
            logger.info(
                "incremental prior feature-index compatibility: %s",
                ", ".join(f"{s}={v}" for s, v in sorted(compat.items())),
            )
        initial_model = load_game_model(args.model_input_dir, index_maps, task=args.task, device=device, dtype=dtype)
    if args.incremental_training:
        if initial_model is None:
            raise SystemExit("--incremental-training requires --model-input-dir")
        for cc in coords:
            cc.regularize_by_prior = True
    if initial_model is not None:
        stage_done("model_input")

    estimator = GameEstimator(
        task=args.task,
        coordinate_configs=coords,
        n_cd_iterations=args.coordinate_descent_iterations,
        evaluator_specs=[e for e in args.evaluators.split(",") if e],
        dtype=dtype,
        validation_frequency=args.validation_frequency,
        divergence_guard=not args.no_divergence_guard,
        rejection_tolerance=args.coordinate_rejection_tolerance,
        partial_retrain_locked=_locked(args),
        mesh=multihost.current_grid() or parse_mesh_shape(args.mesh_shape),
        pipeline_depth=args.pipeline_depth,
        device=device,
    )
    if args.trial_lanes > 1:
        from ..game.lanes import check_lane_composition

        # the lane refusals before any dataset build or grid training; the
        # lane path checks again in fit_lanes
        check_lane_composition(estimator, args.trial_lanes, distributed=bool(args.distributed))
    for sink in sinks:
        # estimator lifecycle events land in the same JSONL stream
        estimator.register_listener(sink)
    if run_t is not None:
        run_t.execution_plan = estimator.execution_plan.to_dict()

    # datasets are reg-weight-independent: built once, lazily (an idempotent
    # rerun of a completed checkpoint must not pay the device build)
    datasets_cache: Dict[str, object] = {}

    def get_datasets():
        if "d" not in datasets_cache:
            t0 = time.perf_counter()
            datasets_cache["d"] = estimator.prepare_datasets(raw)
            _sync(device)
            stage_seconds["datasets"] = time.perf_counter() - t0
        return datasets_cache["d"]

    cd_manager = None
    resume_snap = None
    ckpt_topology = None
    if args.checkpoint_every or args.resume:
        # the topology both sides of a checkpoint speak: global_rows is the
        # PADDED total (one share a process), so the number itself says
        # whether the processes' shard boundaries agree across counts
        ckpt_topology = {
            "n_processes": n_proc,
            "mesh_axes": estimator.execution_plan.mesh_axes,
            "plan_fingerprint": plan_fingerprint(estimator.execution_plan),
            "global_rows": int(raw.n_rows) * n_proc,
        }
    if args.checkpoint_every:
        if not args.checkpoint_dir:
            raise SystemExit("--checkpoint-every requires --checkpoint-dir")
        cd_manager = CheckpointManager(
            os.path.join(args.checkpoint_dir, "cd-boundaries"),
            keep_last=args.checkpoint_keep,
            every=args.checkpoint_every,
            process=multihost.process_index(),
            n_processes=n_proc,
            replica=multihost.model_index() > 0,
            topology={"mesh_axes": ckpt_topology["mesh_axes"], "plan_fingerprint": ckpt_topology["plan_fingerprint"]},
        )
    if args.resume:
        if not args.checkpoint_dir:
            raise SystemExit("--resume requires --checkpoint-dir")
        mgr = cd_manager or CheckpointManager(
            os.path.join(args.checkpoint_dir, "cd-boundaries"), keep_last=args.checkpoint_keep,
        )
        # boundary checkpoints are the coordinator's: it reads, and the
        # snapshot (or its refusal) is broadcast, so no shared file system
        # is needed and every process stops on a refused topology
        many = multihost.world_size() > 1
        if multihost.is_coordinator():
            try:
                resume_snap = mgr.latest_valid(
                    expect_coordinate_order=[cc.name for cc in coords],
                    expect_topology=ckpt_topology,
                    device="cpu" if many else device,
                )
            except (PlanError, CheckpointIncompatibleError) as e:
                if not many:
                    raise
                resume_snap = e
        if many:
            resume_snap = multihost.broadcast_object(resume_snap)
            if isinstance(resume_snap, (PlanError, CheckpointIncompatibleError)):
                raise resume_snap
            resume_snap = to_device(resume_snap, device)
        if resume_snap is None:
            logger.info("--resume: no valid boundary checkpoint; starting fresh")

    ckpt = None
    with obs.span("train"):
        if args.checkpoint_dir:
            ckpt = _Checkpoint.open(args, coords, index_maps, device, dtype)
            results = ckpt.fit_grid(
                estimator, raw, validation, get_datasets, initial_model,
                cd_manager=cd_manager, resume_snapshot=resume_snap,
            )
        else:
            results = estimator.fit(raw, validation=validation, initial_model=initial_model, datasets=get_datasets())
    stage_done("train")
    stage_seconds["train"] -= stage_seconds.get("datasets", 0.0)

    # hyperparameter tuning (GameTrainingDriver:642-673)
    tuned_results: List[GameResult] = []
    if args.hyper_parameter_tuning != "NONE" and validation is not None:
        with obs.span("tuning"):
            tuned_results = _run_tuning(
                args, estimator, raw, _resolve_validation(validation), coords, results,
                ckpt=ckpt, datasets_fn=get_datasets, resume_snap=resume_snap,
            )
        stage_done("tuning")
    all_results = list(results) + tuned_results

    best = estimator.select_best(all_results)
    summary = {
        "task": args.task,
        "configs": [
            {
                "reg_weights": r.config,
                "metrics": None if r.evaluation is None else r.evaluation.metrics,
                "rejections": r.rejections,
            }
            for r in all_results
        ],
        "best": {
            "reg_weights": best.config,
            "metrics": None if best.evaluation is None else best.evaluation.metrics,
        },
    }
    # every process's best model by its bits: the processes must agree
    summary["best"]["model_sha256"] = model_digest(best.model)
    logger.info("best model sha256 %s (process %d)", summary["best"]["model_sha256"], multihost.world_rank())
    if not multihost.is_coordinator():
        # only process 0 writes outputs (the reference's driver-to-HDFS
        # role); run_summary.json is one document a run
        summary["stage_seconds"] = stage_seconds
        return summary
    os.makedirs(args.output_dir, exist_ok=True)
    to_save = all_results if args.output_mode == OUTPUT_MODE_ALL else [best]
    for i, r in enumerate(to_save):
        name = "best" if r is best and args.output_mode != OUTPUT_MODE_ALL else f"model-{i}"
        save_game_model(
            os.path.join(args.output_dir, "models", name),
            r.model,
            index_maps,
            metadata={"regWeights": r.config},
            sparsity_threshold=args.model_sparsity_threshold,
        )
    stage_done("write_models")
    summary["stage_seconds"] = stage_seconds
    summary["wall_seconds"] = time.perf_counter() - t_run0
    atomic_write_json(os.path.join(args.output_dir, "training-summary.json"), summary, indent=2, default=float)
    if run_t is not None:
        _write_run_summary(args, run_t, recorder, t_run0, summary=summary)
    logger.info("saved %d model(s) to %s", len(to_save), args.output_dir)
    return summary


def _write_run_summary(args, run_t, recorder, t_run0, summary=None, aborted=False) -> None:
    """Write run_summary.json from the run's registry (beside the metrics,
    else beside the trace) and the Chrome trace. On an abort ``summary`` is
    None, the document carries ``"aborted": true`` and the timeline holds
    every span that closed before the abort."""
    # a final sample, so that the watermarks are there even for a run that
    # never reached a sweep boundary: the run's card, its index filled in on
    # the thread that ran it
    card = pin_device(args.device)
    obs.sample_memory(run_t.registry, devices=[card] if card.type == "cuda" else ())
    doc = obs.build_run_summary(run_t.registry, total_wall_seconds=time.perf_counter() - t_run0)
    doc["task"] = args.task if summary is None else summary["task"]
    plan = getattr(run_t, "execution_plan", None)
    if plan is not None:
        doc["plan"] = plan
    # a run of several processes: the backend that joined them
    distributed = getattr(run_t, "distributed", None)
    if distributed is not None:
        doc["distributed"] = distributed
    if summary is not None:
        doc["best"] = summary["best"]
        doc["stage_seconds"] = summary["stage_seconds"]
    if aborted:
        doc["aborted"] = True
    if recorder is not None:
        # on the normal path the "train" span has closed by here, so the
        # timeline holds the whole run
        doc["timeline"] = recorder.phase_attribution()
        recorder.write_chrome_trace(args.trace_out)
        logger.info("chrome trace -> %s (load at ui.perfetto.dev)", args.trace_out)
    if args.metrics_out or args.trace_out:
        # --trace-out without --metrics-out: beside the trace
        summary_dir = args.metrics_out or os.path.dirname(os.path.abspath(args.trace_out))
        atomic_write_json(os.path.join(summary_dir, "run_summary.json"), doc, indent=2, default=float)


def _emit_report(args) -> None:
    """Build report.json and report.html under --report-out from the
    artifacts just written to disk (run_summary.json, metrics.jsonl,
    training-summary.json, the saved models), not from any in-memory state,
    so that a later ``cli.report`` over the same directory rebuilds
    report.json byte for byte."""
    from ..obs import report as report_mod

    try:
        inputs = report_mod.collect_training_inputs(
            summary_dir=args.metrics_out,
            output_dir=args.output_dir,
            checkpoint_dir=args.checkpoint_dir,
            feature_index_dir=args.feature_index_dir,
        )
        paths = report_mod.write_report(report_mod.build_report(inputs), args.report_out)
    except Exception:
        # the report is a post-hoc convenience: a rendering fault must not
        # turn a finished (and saved) training run into a failure
        obs.swallowed_error("cli.report_out")
        logger.exception("training report generation failed")
        return
    logger.info("training report -> %s", paths["html"])


def _resolve_validation(validation):
    """Unwrap a deferred validation dataset (the background decode's future)."""
    return validation.result() if hasattr(validation, "result") else validation


def _tuning_weights(hp: HyperparameterConfig, names: List[str], unit_vec) -> Dict[str, float]:
    """A candidate's unit vector -> {coordinate: native reg weight}."""
    native = hp.scale_up(unit_vec)
    return {n.removesuffix(".reg_weight"): float(v) for n, v in zip(names, native)}


def model_digest(model) -> str:
    """The sha256 of a GAME model's bits: each coordinate's name, then a
    fixed effect's means and variances, or a random effect's entity ids,
    support columns and values."""
    h = hashlib.sha256()
    for name in sorted(model.models):
        m = model.models[name]
        h.update(name.encode())
        if hasattr(m, "coef_values"):
            h.update("\0".join(map(str, m.entity_ids)).encode())
            tensors = (m.coef_indices, m.coef_values)
        else:
            tensors = (m.model.coefficients.means, m.model.coefficients.variances)
        for t in tensors:
            if t is not None:
                h.update(torch.as_tensor(t).detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run_tuning(args, estimator, raw, validation, coords, prior_results, ckpt=None, datasets_fn=None,
                resume_snap=None) -> List[GameResult]:
    """Random (Sobol) or Gaussian-process search over the per-coordinate
    log10 reg weights (GameEstimatorEvaluationFunction: candidate <-> (log
    lambda, ...)), the JAX package's ``_run_tuning``.

    The grid's results seed the tuner as observations (GameTrainingDriver.
    scala:666), so the GP starts warm. A JSON tuning config overrides the
    ranges; prior observations shrink them around the GP-predicted best.
    Sequential trials (``evaluate``) train one configuration each through
    ``GameEstimator.fit``; with ``--trial-lanes K`` a batch of K candidates
    trains as lambda lanes of one ``fit_lanes`` run (``evaluate_batch``).

    With ``ckpt`` every finished trial is recorded (model, metrics, unit
    vector; lanes in lane order), and a resumed run replays the recorded
    trials as observations and runs only the rest: the Sobol sequence does
    not depend on how it is chunked, so the count of recorded trials alone
    realigns it (``skip=``), even after a kill in the middle of a batch."""
    from ..tuning import Observation, prior_to_json

    tunable = [cc.name for cc in coords if cc.name not in estimator.partial_retrain_locked]
    hp = _build_tuning_config(args, tunable)
    names = [p.name for p in hp.params]
    sign = -1.0 if _higher_is_better(args.evaluators) else 1.0
    registry = obs.current_run().registry
    results: List[GameResult] = []

    def trial_estimator(cfgs) -> GameEstimator:
        return GameEstimator(
            task=args.task,
            coordinate_configs=cfgs,
            n_cd_iterations=args.coordinate_descent_iterations,
            evaluator_specs=[e for e in args.evaluators.split(",") if e],
            dtype=estimator.dtype,
            partial_retrain_locked=list(estimator.partial_retrain_locked),
            mesh=estimator.mesh,
            validation_frequency=estimator.validation_frequency,
            divergence_guard=estimator.divergence_guard,
            rejection_tolerance=estimator.rejection_tolerance,
            pipeline_depth=estimator.pipeline_depth,
            device=estimator.device,
        )

    def evaluate(unit_vec):
        faults.check("tuning.trial")
        weights = _tuning_weights(hp, names, unit_vec)
        cfgs = [dataclasses.replace(cc, reg_weights=(weights.get(cc.name, cc.config.reg_weight),)) for cc in coords]
        r = trial_estimator(cfgs).fit(
            raw, validation=validation, datasets=datasets_fn() if datasets_fn is not None else None,
        )[0]
        results.append(r)
        # the tuner minimizes; higher-is-better metrics are negated
        value = sign * r.evaluation.primary_metric
        if ckpt is not None:
            ckpt.record_trial(unit_vec, value, r)
        registry.counter("photon_tuning_trials_total", "tuning trials completed").inc()
        return value, r

    def evaluate_batch(cands):
        """A whole candidate batch as lambda lanes of one run: every lane
        shares each coordinate's data residency and solve."""
        combos = []
        for unit_vec in cands:
            weights = _tuning_weights(hp, names, unit_vec)
            combos.append({cc.name: weights.get(cc.name, cc.config.reg_weight) for cc in coords})
        with obs.span("tuning.batch", phase="tuning", lanes=len(cands)) as span:
            lane_results = trial_estimator(list(coords)).fit_lanes(
                raw, combos, validation=validation, datasets=datasets_fn() if datasets_fn is not None else None,
            )
        registry.histogram(
            "photon_tuning_batch_wall_seconds", "wall time of one lane-batched tuning trial batch"
        ).observe(span.duration_s)
        out = []
        for unit_vec, r in zip(cands, lane_results):
            # lanes record in lane order: a fault in the middle of a batch
            # leaves a recorded prefix whose count realigns the candidates
            faults.check("tuning.trial")
            results.append(r)
            value = sign * r.evaluation.primary_metric
            if ckpt is not None:
                ckpt.record_trial(unit_vec, value, r, lane=r.trackers.get("lane"))
            registry.counter("photon_tuning_trials_total", "tuning trials completed").inc()
            out.append((value, r))
        return out

    # the grid's results seed the tuner (convertObservations); a grid point
    # outside the search range is skipped (scale_down would clip it to the
    # cube's edge and attach a far-away point's metric there)
    observations = []
    for r in prior_results or []:
        if r.evaluation is None:
            continue
        native = _native_vec(r, names)
        if any(not (p.min <= v <= p.max) for p, v in zip(hp.params, native)):
            continue
        observations.append(
            Observation(candidate=hp.scale_down(native), value=sign * r.evaluation.primary_metric, artifact=r)
        )

    # replay the checkpointed trials and run only the rest of the budget
    n_iter = args.hyper_parameter_tuning_iter
    if ckpt is not None:
        for rec in ckpt.completed_trials():
            r = ckpt._reconstruct(rec)
            results.append(r)
            observations.append(Observation(candidate=np.asarray(rec["unit"]), value=float(rec["value"]), artifact=r))
        n_done = len(ckpt.completed_trials())
        if resume_snap is not None:
            # a boundary manifest records the trial count when it was
            # written: candidates it proves were drawn are burnt, so that the
            # deterministic sequence stays aligned (skip=)
            from_manifest = int(resume_snap.manifest.get("tuner_trials", 0))
            if from_manifest > n_done:
                logger.warning("checkpoint manifest records %d tuning trials but state has %d; skipping the "
                               "%d lost candidates", from_manifest, n_done, from_manifest - n_done)
                n_done = from_manifest
        if n_done:
            logger.info("checkpoint: %d/%d tuning trials already run", n_done, n_iter)
        n_iter = max(n_iter - n_done, 0)

    if n_iter > 0:
        tuner = get_tuner(args.hyper_parameter_tuning)
        skip = args.hyper_parameter_tuning_iter - n_iter
        if args.trial_lanes > 1:
            from ..game.lanes import check_lane_composition

            check_lane_composition(estimator, args.trial_lanes)
            tuner.search_batched(
                n_iter, hp.dim, evaluate_batch, args.trial_lanes, observations=observations,
                discrete_params=hp.discrete_dims(), seed=0, skip=skip,
            )
        else:
            tuner.search(
                n_iter, hp.dim, evaluate, observations=observations, discrete_params=hp.discrete_dims(), seed=0,
                skip=skip,
            )

    # every (grid and tuned) observation, as a reusable prior file
    priors = [
        (_native_vec(r, names), r.evaluation.primary_metric)
        for r in list(prior_results or []) + results
        if r.evaluation is not None
    ]
    if multihost.is_coordinator():
        os.makedirs(args.output_dir, exist_ok=True)
        with atomic_write(os.path.join(args.output_dir, "hyperparameter-prior.json"), "w") as f:
            f.write(prior_to_json(names, priors))
    return results


def _native_vec(result: GameResult, names: List[str]) -> np.ndarray:
    """GameResult -> native hyperparameter vector ordered by ``names``
    (vectorizeParams; names are '<coordinate>.reg_weight')."""
    return np.asarray([result.config.get(n.removesuffix(".reg_weight"), 1.0) for n in names])


def _build_tuning_config(args, tunable: List[str]) -> HyperparameterConfig:
    """Default per-coordinate log-lambda ranges, optionally overridden by a
    JSON tuning config and shrunk around prior observations."""
    from ..tuning import config_from_json, get_bounds

    if args.hyper_parameter_config:
        with open(args.hyper_parameter_config) as f:
            _, hp = config_from_json(f.read())
        tunable_names = {f"{n}.reg_weight" for n in tunable}
        bad = [p.name for p in hp.params if p.name not in tunable_names]
        if bad:
            raise SystemExit(
                f"--hyper-parameter-config variables {bad} do not name tunable coordinates; expected names "
                f"among {sorted(tunable_names)}"
            )
    else:
        hp = HyperparameterConfig(
            params=[ParamRange(name=f"{n}.reg_weight", min=1e-4, max=1e4, transform="LOG") for n in tunable]
        )
    if args.hyper_parameter_prior:
        with open(args.hyper_parameter_prior) as f:
            lower, upper = get_bounds(
                hp, f.read(), radius=args.hyper_parameter_shrink_radius,
                higher_is_better=_higher_is_better(args.evaluators),
            )
        hp = HyperparameterConfig(
            params=[dataclasses.replace(p, min=float(lo), max=float(hi)) for p, lo, hi in zip(hp.params, lower, upper)]
        )
    return hp


def _higher_is_better(evaluators: str) -> bool:
    from ..evaluation.evaluators import build_evaluator

    specs = [e for e in evaluators.split(",") if e]
    if not specs:
        return False
    return build_evaluator(specs[0]).higher_is_better


class _Checkpoint:
    """Per-sweep crash-recovery checkpointing across reg-weight grids and
    tuning trials.

    State (``checkpoint-state.json``, version 2, atomically replaced; the
    JAX package's layout):
      grid           expanded combo list this run must train, in order
      completed      per finished combo: model dir + validation metrics
      current        mid-combo progress: index, completed sweeps, model dir
      tuning_trials  per finished tuning trial: unit vector, value, model
                     dir (and, for lanes, the lane index and count)

    Resume = rerun the same command: finished combos and trials reconstruct
    from their saved models + recorded metrics, the in-flight combo
    warm-starts from its last completed sweep, or, with a boundary snapshot
    further along, continues mid-sweep from it, and tuning resumes with the
    recorded trials as observations. With --validation-data, best-model tracking
    within a combo resumed from a per-sweep record restarts at the resume
    point (the record stores last-sweep models, not the tracked best)."""

    def __init__(self, args, coords, index_maps, state, state_path, device, dtype):
        self.args = args
        self.coords = coords
        self.index_maps = index_maps
        self.state = state
        self.state_path = state_path
        self.dir = args.checkpoint_dir
        self.device = device
        self.dtype = dtype

    @classmethod
    def open(cls, args, coords, index_maps, device, dtype):
        names = [cc.name for cc in coords]
        combos = [dict(zip(names, map(float, c))) for c in itertools.product(*[cc.grid() for cc in coords])]
        state_path = os.path.join(args.checkpoint_dir, "checkpoint-state.json")
        state = None
        if os.path.exists(state_path):
            with open(state_path) as f:
                state = json.load(f)
        if multihost.world_size() > 1:
            # the coordinator's state is authoritative (it is the only
            # writer): every process runs the coordinator's, so the
            # collective schedules stay aligned without a shared file system
            views = multihost.allgather_object(json.dumps(state, sort_keys=True))
            if len(set(views)) != 1:
                logger.warning("checkpoint states differ across processes (no shared file system); adopting "
                               "the coordinator's state")
            # on a grid the views are the rank's model column's
            state = json.loads(views[0] if multihost.current_grid() is None else multihost.broadcast_object(views[0]))
        if state is None:
            state = {
                "version": 2,
                "grid": combos,
                "n_cd_iterations": args.coordinate_descent_iterations,
                "completed": [],
                "current": None,
                "tuning_trials": [],
            }
        elif state.get("version") != 2:
            raise SystemExit(
                f"checkpoint at {args.checkpoint_dir} uses state version {state.get('version')}; this "
                "build writes version 2 — pass a fresh --checkpoint-dir"
            )
        elif state.get("grid") != combos:
            raise SystemExit(
                f"checkpoint at {args.checkpoint_dir} was written for grid {state.get('grid')}, not "
                f"{combos}; pass a fresh --checkpoint-dir"
            )
        elif state.get("n_cd_iterations") != args.coordinate_descent_iterations:
            raise SystemExit(
                f"checkpoint at {args.checkpoint_dir} was written for {state.get('n_cd_iterations')} "
                "coordinate-descent iterations; resume with the same --coordinate-descent-iterations "
                "(completed configurations trained that many sweeps)"
            )
        if args.validation_data:
            logger.warning(
                "--checkpoint-dir with --validation-data: on resume, best-model tracking only sees "
                "post-resume sweeps of the in-flight configuration"
            )
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        return cls(args, coords, index_maps, state, state_path, device, dtype)

    def _write(self):
        if multihost.is_coordinator():
            atomic_write_json(self.state_path, self.state)

    def _load_model(self, model_dir):
        if multihost.world_size() > 1:
            # the model files exist where the coordinator wrote them: it
            # loads, and one broadcast carries the model to the others
            model = None
            if multihost.is_coordinator():
                model = load_game_model(
                    os.path.join(self.dir, model_dir), self.index_maps, task=self.args.task, device="cpu",
                    dtype=self.dtype,
                )
            return to_device(multihost.broadcast_object(model), self.device)
        return load_game_model(
            os.path.join(self.dir, model_dir), self.index_maps, task=self.args.task,
            device=self.device, dtype=self.dtype,
        )

    def _save_model(self, model_dir, game_model, reg_weights):
        if multihost.is_coordinator():
            save_game_model(
                os.path.join(self.dir, model_dir), game_model, self.index_maps,
                metadata={"regWeights": reg_weights},
            )

    def _reconstruct(self, rec):
        ev = None
        if rec.get("metrics"):
            from ..evaluation.suite import EvaluationResults

            ev = EvaluationResults(primary_name=rec["primary_name"], metrics=rec["metrics"])
        return GameResult(model=self._load_model(rec["model_dir"]), config=rec["reg_weights"],
                          evaluation=ev, trackers={})

    def fit_grid(self, estimator, raw, validation, datasets_fn, initial_model=None, cd_manager=None,
                 resume_snapshot=None):
        """``initial_model`` warm-starts the first configuration (and is the
        prior of an incremental run). ``cd_manager`` (robust.CheckpointManager) adds coordinate-update-
        boundary snapshots on top of the per-sweep model saves;
        ``resume_snapshot`` resumes its combo mid-sweep, bit-identical.
        Whichever record is further along wins; boundary manifests carry
        ``combo_index`` / ``sweep_offset`` so a snapshot written during a
        sweep-level-resumed run maps back to global sweep numbering."""
        validation = _resolve_validation(validation)
        combos = self.state["grid"]
        n_iter = self.args.coordinate_descent_iterations
        results: List[GameResult] = []
        prev = initial_model
        for rec in self.state["completed"]:
            r = self._reconstruct(rec)
            results.append(r)
            prev = r.model
        if self.state["completed"]:
            logger.info("checkpoint: %d/%d configurations already trained",
                        len(self.state["completed"]), len(combos))

        for k in range(len(results), len(combos)):
            done = 0
            cur = self.state.get("current")
            if cur and cur.get("index") == k and cur.get("completed_sweeps", 0) > 0:
                done = int(cur["completed_sweeps"])
            snap = None
            if resume_snapshot is not None and int(resume_snapshot.manifest.get("combo_index", -1)) == k:
                snap = resume_snapshot
                # the sweeps the snapshot has completed: a snapshot after a
                # sweep's last coordinate is as far along as that sweep's
                # per-sweep record, and it also carries the best-model
                # ledger, which the per-sweep record does not
                last = int(snap.coordinate_index) == len(snap.manifest["coordinate_order"]) - 1
                snap_global = int(snap.manifest.get("sweep_offset", 0)) + int(snap.iteration) + int(last)
                if snap_global < done:
                    logger.info("config %d: per-sweep record (%d sweeps) is ahead of the boundary snapshot "
                                "(%d sweeps); using the former", k, done, snap_global)
                    snap = None
            if snap is not None:
                done = int(snap.manifest.get("sweep_offset", 0))
                logger.info("resuming config %d from boundary snapshot %s (iter %d after coordinate %s)",
                            k, snap.path, snap.iteration, snap.coordinate)
            elif done > 0:
                prev = self._load_model(cur["model_dir"])
                logger.info("resuming config %d from sweep %d/%d", k, done, n_iter)

            def sweep_fn(reg_weights, iteration, game_model, _k=k, _done=done):
                j = _done + iteration + 1
                model_dir = f"config-{_k:03d}-sweep-{j:04d}"
                self._save_model(model_dir, game_model, reg_weights)
                self.state["current"] = {"index": _k, "completed_sweeps": j, "model_dir": model_dir}
                self._write()
                prev_dir = os.path.join(self.dir, f"config-{_k:03d}-sweep-{j - 1:04d}")
                if multihost.is_coordinator() and os.path.isdir(prev_dir):
                    shutil.rmtree(prev_dir, ignore_errors=True)

            boundary = None
            if cd_manager is not None:
                n_trials = len(self.state.get("tuning_trials", []))

                def boundary(reg_weights, st, _k=k, _done=done, _n=n_trials):
                    cd_manager.on_boundary(_local_boundary_state(st), meta={
                        "reg_weights": reg_weights,
                        "combo_index": _k,
                        "sweep_offset": _done,
                        "tuner_trials": _n,
                    })

            if snap is not None:
                # fine-grained resume: descent continues mid-sweep from the
                # snapshot (the iteration count of the run that wrote it)
                r = estimator.fit(
                    raw, validation=validation, initial_model=prev, checkpoint_fn=sweep_fn,
                    datasets=datasets_fn(), combos=[combos[k]],
                    n_cd_iterations=int(snap.manifest["n_iterations"]),
                    boundary_fn=boundary, resume_state=snap,
                )[0]
            elif n_iter - done <= 0:
                # crashed between the last sweep save and the completion
                # record: the model is trained, only its metrics are lost;
                # recover them by scoring the validation set
                ev = None
                if validation is not None:
                    ev = GameTransformer(model=prev, dtype=estimator.dtype, device=estimator.device).transform(
                        validation, evaluator_specs=estimator.evaluator_specs or ["RMSE"],
                    )[1]
                r = GameResult(model=prev, config=combos[k], evaluation=ev, trackers={})
            else:
                r = estimator.fit(
                    raw, validation=validation, initial_model=prev, checkpoint_fn=sweep_fn,
                    datasets=datasets_fn(), combos=[combos[k]], n_cd_iterations=n_iter - done,
                    boundary_fn=boundary,
                )[0]
            self._finish_combo(k, combos, r, n_iter)
            results.append(r)
            prev = r.model
        return results

    def _finish_combo(self, k, combos, r: GameResult, n_iter):
        """Record config ``k`` as completed: final model, metrics, state
        flip, per-sweep model cleanup."""
        final_dir = f"config-{k:03d}-final"
        self._save_model(final_dir, r.model, combos[k])
        self.state["completed"].append({
            "reg_weights": combos[k],
            "model_dir": final_dir,
            "metrics": None if r.evaluation is None else r.evaluation.metrics,
            "primary_name": None if r.evaluation is None else r.evaluation.primary_name,
        })
        self.state["current"] = None
        self._write()
        last = os.path.join(self.dir, f"config-{k:03d}-sweep-{n_iter:04d}")
        if multihost.is_coordinator() and os.path.isdir(last):
            shutil.rmtree(last, ignore_errors=True)

    # -- tuning trials --------------------------------------------------------

    def completed_trials(self):
        return list(self.state.get("tuning_trials", []))

    def record_trial(self, unit_vec, value, result: GameResult, lane=None):
        """Save a finished trial's model and record it. ``lane``: a lane
        batch's trial passes its lane tracker; lanes record in lane order,
        so the trial count alone realigns the candidate sequence."""
        i = len(self.state["tuning_trials"])
        model_dir = f"tuning-{i:03d}"
        self._save_model(model_dir, result.model, result.config)
        rec = {
            "unit": [float(x) for x in np.asarray(unit_vec).ravel()],
            "value": float(value),
            "reg_weights": result.config,
            "model_dir": model_dir,
            "metrics": None if result.evaluation is None else result.evaluation.metrics,
            "primary_name": None if result.evaluation is None else result.evaluation.primary_name,
        }
        if lane is not None:
            rec["lane"] = {"index": int(lane.get("index", 0)), "n_lanes": int(lane.get("n_lanes", 1))}
        self.state["tuning_trials"].append(rec)
        self._write()


def _local_boundary_state(state):
    """The boundary state a process checkpoints: over several processes
    its own rows of the summed scores, which every process holds whole
    over the padded global row space (the two-phase save's shard)."""
    n = multihost.process_count()
    if n == 1 or state.summed_scores is None:
        return state
    share = state.summed_scores.shape[0] // n
    lo = multihost.process_index() * share
    return dataclasses.replace(state, summed_scores=state.summed_scores[lo : lo + share])


def main():
    try:
        run(sys.argv[1:])
    except robust_dist.DistributedError as e:
        # a lost peer: the typed error, then a hard exit, since an orderly
        # interpreter exit would tear down a process group that waits on it
        logger.exception("distributed run failed: %s", type(e).__name__)
        print(f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(70)


if __name__ == "__main__":
    main()
