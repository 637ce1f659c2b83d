"""Crash-safe coordinate-descent checkpoints: digest manifests, keep-last-K.

The JAX package's ``robust/checkpoint.py`` on the port. The
reference's fault tolerance is RDD lineage: lose an executor mid-sweep and
Spark recomputes the lost partitions. A process has no lineage, so the
replacement is snapshot-based: at coordinate-update boundaries (between
updates the whole algorithm state is a handful of host-reachable values) the
:class:`CheckpointManager` persists the outer-loop state, and a resumed
process replays the remaining updates bit for bit.

On-disk layout, one directory per checkpoint::

    <dir>/ckpt-000007/
        state.pkl        # pickled payload (models, scores, best-so-far, ...)
        MANIFEST.json    # written LAST: schema/compat keys + sha256(payload)

Both files are written via :mod:`robust.atomic` (temp + fsync + rename) and
the manifest lands only after the payload is durable, so the manifest's
existence certifies the checkpoint: restore validates the digest before
unpickling a single byte, a torn payload or manifest is skipped with a
warning, and :meth:`CheckpointManager.latest_valid` falls back to the next
older checkpoint. A checkpoint whose coordinate configuration or execution
plan does not match the resuming run is REJECTED instead of half-loaded.

The payload loads on any machine: every tensor in it (models, best models,
summed scores) is a CPU tensor in its own dtype, never a pickled CUDA
tensor, and :meth:`latest_valid` moves the models and scores onto the
``device`` it is given.

Counters in the obs registry: ``photon_checkpoint_saves_total``,
``photon_checkpoint_bytes_total``, ``photon_checkpoint_save_seconds``,
``photon_checkpoint_restore_total``, and
``photon_checkpoint_skipped_total{reason=}`` for restore fallbacks.

**Several processes** save by the JAX package's two-phase protocol: every
process constructs a manager over the same directory name (its own disk or
a shared one) and calls :meth:`CheckpointManager.on_boundary`. Phase one,
each process writes its rows of the summed scores (``shard-p<i>.pkl``) and
confirms the shard's sha256 over ``parallel.multihost.allgather_object``;
phase two, the coordinator alone, after every shard confirmed, writes the
payload and then the manifest, which records every shard's digest and the
run's topology (process count, mesh axes, plan fingerprint, padded global
rows). The manifest is the commit point: a save torn at any stage (a shard,
the payload, or a kill just before the manifest; the ``dist.commit`` fault
site brackets both phases) leaves no manifest, so restore falls back to the
previous consistent step as it does past a corrupt single-process save.
Restore checks every shard's digest and concatenates the shards in process
order into the padded global row space; ``plan.check_checkpoint_topology``
judges the recorded topology. The coordinator alone reads a checkpoint in
``cli.train`` and broadcasts it, so no shared file system is needed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import shutil
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike
from . import faults
from .atomic import atomic_write_bytes, atomic_write_json
from .retry import io_call

logger = logging.getLogger("photon_ml_tpu_torch")

MANIFEST_NAME = "MANIFEST.json"
PAYLOAD_NAME = "state.pkl"
SHARD_PREFIX = "shard-p"
MANIFEST_VERSION = 1
_DIR_PREFIX = "ckpt-"


class CheckpointError(Exception):
    """Base class for checkpoint restore problems."""


class CheckpointIncompatibleError(CheckpointError):
    """The newest valid checkpoint was written by a different run
    configuration; resuming from it would silently train the wrong model."""


@dataclasses.dataclass
class CheckpointSnapshot:
    """A restored coordinate-descent boundary state (the duck type
    ``CoordinateDescent(resume_state=...)`` consumes)."""

    iteration: int
    coordinate_index: int
    coordinate: str
    models: Dict[str, object]
    summed_scores: Optional[object]  # tensor [n], or None before any accepted update
    best_eval: Optional[object]
    best_models: Dict[str, object]
    evaluations: List
    tracker_summaries: Dict[str, str]
    manifest: dict
    path: str
    # the divergence guard's regression baselines
    train_losses: Dict[str, float] = dataclasses.field(default_factory=dict)


def to_device(obj, device):
    """``obj`` with every tensor in it moved to ``device`` (detached):
    tensors, dicts, lists, tuples and dataclass instances are walked (a
    dataclass is rebuilt from its init fields, so what a model caches
    outside them, such as a weak reference to its dataset, is dropped);
    anything else passes through."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj) if f.init
        })
    return obj


def _registry():
    from .. import obs

    return obs.current_run().registry


def _count_skip(reason: str) -> None:
    _registry().counter(
        "photon_checkpoint_skipped_total",
        "checkpoints skipped during restore, by reason",
    ).labels(reason=reason).inc()


class CheckpointManager:
    """Saves/restores coordinate-descent boundary state under one directory.

    ``every``: save on every N-th boundary notification (:meth:`on_boundary`
    counts them); ``keep_last``: checkpoints retained after rotation;
    ``fsync``: durability of the temp-write path (tests turn it off for
    speed, production leaves it on). ``base_meta`` is merged into every
    manifest; ``topology`` (the plan fingerprint, the process count) is
    stamped into every manifest and judged on restore by
    ``plan.check_checkpoint_topology``.

    ``process`` / ``n_processes`` select the two-phase protocol (module
    docstring): a boundary state then carries this process's rows of the
    summed scores, and the confirmations ride ``exchange``, by default the
    guarded ``parallel.multihost.allgather_object`` (a test passes its
    own)."""

    def __init__(
        self,
        directory: str,
        keep_last: int = 3,
        every: int = 1,
        fsync: bool = True,
        base_meta: Optional[dict] = None,
        process: int = 0,
        n_processes: int = 1,
        topology: Optional[dict] = None,
        exchange=None,
    ):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1: {keep_last}")
        if every < 1:
            raise ValueError(f"every must be >= 1: {every}")
        if n_processes < 1:
            raise ValueError(f"n_processes must be >= 1: {n_processes}")
        if not 0 <= process < n_processes:
            raise ValueError(f"process must be in [0, {n_processes}): {process}")
        self.directory = directory
        self.keep_last = keep_last
        self.every = every
        self.fsync = fsync
        self.process = int(process)
        self.n_processes = int(n_processes)
        self.topology = dict(topology or {})
        self.exchange = exchange
        self.base_meta = dict(base_meta or {})
        self._boundaries = 0
        os.makedirs(directory, exist_ok=True)
        steps = self._steps_on_disk()
        self._seq = (max(steps) + 1) if steps else 0

    # -- saving ---------------------------------------------------------------

    def on_boundary(self, state, meta: Optional[dict] = None) -> Optional[str]:
        """Coordinate-update boundary notification; saves every N-th one.
        ``state`` is descent's ``CDBoundaryState``. The ``cd.boundary`` /
        ``cd.boundary_saved`` fault sites bracket the save so tests can kill
        either right before or right after persistence."""
        faults.check("cd.boundary")
        self._boundaries += 1
        if self._boundaries % self.every:
            return None
        path = self.save(state, meta)
        faults.check("cd.boundary_saved")
        return path

    def save(self, state, meta: Optional[dict] = None) -> str:
        """Persist one boundary state; returns the checkpoint directory.
        A manager of several processes saves by the two-phase protocol."""
        if self.n_processes > 1:
            return self._save_distributed(state, meta)
        t0 = time.perf_counter()
        payload = self._payload_dict(state)
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(blob).hexdigest()
        name = f"{_DIR_PREFIX}{self._seq:06d}"
        ckpt_dir = os.path.join(self.directory, name)
        os.makedirs(ckpt_dir, exist_ok=True)
        io_call(
            atomic_write_bytes,
            os.path.join(ckpt_dir, PAYLOAD_NAME),
            blob,
            fsync=self.fsync,
            site="checkpoint.write",
        )
        summed = payload["summed_scores"]
        manifest = {
            "version": MANIFEST_VERSION,
            "step": self._seq,
            "iteration": int(state.iteration),
            "coordinate_index": int(state.coordinate_index),
            "coordinate": state.coordinate,
            "coordinate_order": list(state.coordinate_order),
            "n_iterations": int(state.n_iterations),
            "payload": PAYLOAD_NAME,
            "sha256": digest,
            "bytes": len(blob),
            "created_unix": time.time(),
            "topology": self._topology_meta(0 if summed is None else int(summed.shape[0])),
            **self.base_meta,
            **(meta or {}),
        }
        io_call(
            atomic_write_json,
            os.path.join(ckpt_dir, MANIFEST_NAME),
            manifest,
            fsync=self.fsync,
            indent=2,
            site="checkpoint.manifest",
        )
        self._seq += 1
        self._count_save(len(blob), time.perf_counter() - t0)
        self._rotate()
        logger.info(
            "checkpoint %s: iter %d coordinate %s (%d bytes, %.3fs)",
            name, payload["iteration"], payload["coordinate"], len(blob),
            time.perf_counter() - t0,
        )
        return ckpt_dir

    @staticmethod
    def _count_save(n_bytes: int, seconds: float) -> None:
        reg = _registry()
        reg.counter("photon_checkpoint_saves_total", "boundary checkpoints written").inc()
        reg.counter("photon_checkpoint_bytes_total", "checkpoint payload bytes written").inc(n_bytes)
        reg.histogram("photon_checkpoint_save_seconds", "wall per boundary checkpoint save").observe(seconds)

    def _topology_meta(self, global_rows: int) -> dict:
        return {**self.topology, "n_processes": self.n_processes, "global_rows": int(global_rows)}

    def _save_distributed(self, state, meta: Optional[dict] = None) -> str:
        """The two-phase save across ``n_processes`` (module docstring).
        Phase one (every process): write the local summed-score shard and
        confirm its digest over the exchange. Phase two (the coordinator):
        the payload, then the commit point, the manifest. The
        ``dist.commit`` fault site fires at phase one's entry and again on
        the coordinator right before the manifest."""
        t0 = time.perf_counter()
        faults.check("dist.commit")
        name = f"{_DIR_PREFIX}{self._seq:06d}"
        ckpt_dir = os.path.join(self.directory, name)
        os.makedirs(ckpt_dir, exist_ok=True)
        local = to_device(state.summed_scores, "cpu")
        shard_blob = pickle.dumps(
            {"process": self.process, "summed_scores": local}, protocol=pickle.HIGHEST_PROTOCOL
        )
        shard_name = f"{SHARD_PREFIX}{self.process}.pkl"
        io_call(
            atomic_write_bytes,
            os.path.join(ckpt_dir, shard_name),
            shard_blob,
            fsync=self.fsync,
            site="checkpoint.write",
        )
        confirm = {
            "process": self.process,
            "file": shard_name,
            "sha256": hashlib.sha256(shard_blob).hexdigest(),
            "bytes": len(shard_blob),
            "rows": 0 if local is None else int(local.shape[0]),
        }
        exchange = self.exchange
        if exchange is None:
            from ..parallel import multihost

            exchange = multihost.allgather_object
        confirms = sorted(exchange(confirm), key=lambda c: c["process"])
        # every process passes the exchange in lockstep, so the next
        # boundary's directory name agrees even if this commit tears
        self._seq += 1
        if self.process != 0:
            return ckpt_dir
        payload = self._payload_dict(state, summed_scores=None)
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        io_call(
            atomic_write_bytes,
            os.path.join(ckpt_dir, PAYLOAD_NAME),
            blob,
            fsync=self.fsync,
            site="checkpoint.write",
        )
        # the commit point: shards and payload are durable, the manifest is
        # not; a kill here is the torn save restore must survive
        faults.check("dist.commit")
        manifest = {
            "version": MANIFEST_VERSION,
            "step": self._seq - 1,
            "iteration": int(state.iteration),
            "coordinate_index": int(state.coordinate_index),
            "coordinate": state.coordinate,
            "coordinate_order": list(state.coordinate_order),
            "n_iterations": int(state.n_iterations),
            "payload": PAYLOAD_NAME,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
            "created_unix": time.time(),
            "shards": confirms,
            "topology": self._topology_meta(sum(c["rows"] for c in confirms)),
            **self.base_meta,
            **(meta or {}),
        }
        io_call(
            atomic_write_json,
            os.path.join(ckpt_dir, MANIFEST_NAME),
            manifest,
            fsync=self.fsync,
            indent=2,
            site="checkpoint.manifest",
        )
        total_bytes = len(blob) + sum(c["bytes"] for c in confirms)
        self._count_save(total_bytes, time.perf_counter() - t0)
        self._rotate()
        logger.info(
            "checkpoint %s: iter %d coordinate %s (%d processes, %d bytes, %.3fs)",
            name, manifest["iteration"], manifest["coordinate"], self.n_processes, total_bytes,
            time.perf_counter() - t0,
        )
        return ckpt_dir

    @staticmethod
    def _payload_dict(state, summed_scores=True) -> dict:
        """The boundary state for the payload, its tensors on the host;
        ``summed_scores=None``: without them (they live in the shards)."""
        return {
            "iteration": int(state.iteration),
            "coordinate_index": int(state.coordinate_index),
            "coordinate": state.coordinate,
            "models": to_device(dict(state.models), "cpu"),
            "summed_scores": None if summed_scores is None else to_device(state.summed_scores, "cpu"),
            "best_eval": state.best_eval,
            "best_models": to_device(dict(state.best_models), "cpu"),
            "evaluations": list(state.evaluations),
            "tracker_summaries": {
                name: t.to_summary_string() for name, t in state.trackers.items()
            },
            "train_losses": {
                k: float(v)
                for k, v in (getattr(state, "train_losses", None) or {}).items()
            },
        }

    def _rotate(self) -> None:
        steps = sorted(self._steps_on_disk())
        for step in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(
                os.path.join(self.directory, f"{_DIR_PREFIX}{step:06d}"),
                ignore_errors=True,
            )

    def _steps_on_disk(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_DIR_PREFIX):
                try:
                    out.append(int(name[len(_DIR_PREFIX):]))
                except ValueError:
                    continue
        return out

    # -- restoring ------------------------------------------------------------

    def latest_valid(
        self,
        expect_coordinate_order: Optional[Sequence[str]] = None,
        expect_n_iterations: Optional[int] = None,
        expect_topology: Optional[dict] = None,
        device: DeviceLike = "cpu",
    ) -> Optional[CheckpointSnapshot]:
        """Newest checkpoint that passes manifest + digest validation,
        falling back past corrupt ones (each skip warned and counted), its
        models, best models and summed scores on ``device``. ``expect_*``
        pins the run configuration: the newest VALID checkpoint failing
        those checks raises :class:`CheckpointIncompatibleError`
        (resuming an incompatible snapshot, or skipping to a stale
        compatible one, would both train the wrong model).
        ``expect_topology`` is judged by ``plan.check_checkpoint_topology``."""
        for step in sorted(self._steps_on_disk(), reverse=True):
            name = f"{_DIR_PREFIX}{step:06d}"
            ckpt_dir = os.path.join(self.directory, name)
            try:
                manifest, payload = self._load_validated(ckpt_dir)
            except (OSError, ValueError, KeyError, pickle.UnpicklingError, EOFError) as e:
                logger.warning("checkpoint %s unusable (%s); falling back", name, e)
                _count_skip("corrupt")
                continue
            if (
                expect_coordinate_order is not None
                and manifest["coordinate_order"] != list(expect_coordinate_order)
            ):
                raise CheckpointIncompatibleError(
                    f"checkpoint {ckpt_dir} was written for coordinates "
                    f"{manifest['coordinate_order']}, this run trains "
                    f"{list(expect_coordinate_order)}; refusing to resume — "
                    "pass a fresh checkpoint directory"
                )
            if (
                expect_n_iterations is not None
                and manifest["n_iterations"] != expect_n_iterations
            ):
                raise CheckpointIncompatibleError(
                    f"checkpoint {ckpt_dir} was written for "
                    f"{manifest['n_iterations']} coordinate-descent "
                    f"iterations, this run uses {expect_n_iterations}; "
                    "refusing to resume — pass a fresh checkpoint directory"
                )
            if expect_topology is not None:
                from ..plan import PlanError, check_checkpoint_topology

                try:
                    check_checkpoint_topology(manifest.get("topology") or {}, expect_topology)
                except PlanError as e:
                    raise CheckpointIncompatibleError(f"checkpoint {ckpt_dir}: {e}") from e
            _registry().counter(
                "photon_checkpoint_restore_total", "checkpoints restored"
            ).inc()
            logger.info(
                "resuming from checkpoint %s: iter %d after coordinate %s",
                name, payload["iteration"], payload["coordinate"],
            )
            return CheckpointSnapshot(
                iteration=payload["iteration"],
                coordinate_index=payload["coordinate_index"],
                coordinate=payload["coordinate"],
                models=to_device(payload["models"], device),
                summed_scores=to_device(payload["summed_scores"], device),
                best_eval=payload["best_eval"],
                best_models=to_device(payload["best_models"], device),
                evaluations=payload["evaluations"],
                tracker_summaries=payload["tracker_summaries"],
                manifest=manifest,
                path=ckpt_dir,
                train_losses=payload.get("train_losses", {}),
            )
        return None

    def _load_validated(self, ckpt_dir: str):
        """Manifest + digest-checked payload of one checkpoint dir; raises
        on any inconsistency (caller decides skip vs abort)."""
        with open(os.path.join(ckpt_dir, MANIFEST_NAME), encoding="utf-8") as f:
            manifest = json.load(f)
        if manifest.get("version") != MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {manifest.get('version')!r} != "
                f"{MANIFEST_VERSION}"
            )
        for key in ("sha256", "payload", "coordinate_order", "n_iterations"):
            if key not in manifest:
                raise KeyError(f"manifest missing {key!r}")

        def read_payload():
            with open(os.path.join(ckpt_dir, manifest["payload"]), "rb") as f:
                return f.read()

        blob = io_call(read_payload, site="checkpoint.read")
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest["sha256"]:
            raise ValueError(
                f"payload digest {digest[:12]}... != manifest "
                f"{manifest['sha256'][:12]}... (truncated or corrupt write)"
            )
        # the digest certifies the bytes this program wrote
        payload = pickle.loads(blob)
        shards = manifest.get("shards")
        if shards:
            # a two-phase save: the summed scores live in the per-process
            # shards; each digest is checked, and the shards concatenate in
            # process order into the padded global row order (which is also
            # how a legal reshape under another process count reassembles)
            parts = []
            for rec in sorted(shards, key=lambda r: r["process"]):
                shard_path = os.path.join(ckpt_dir, rec["file"])

                def read_shard(path=shard_path):
                    with open(path, "rb") as f:
                        return f.read()

                sblob = io_call(read_shard, site="checkpoint.read")
                sdigest = hashlib.sha256(sblob).hexdigest()
                if sdigest != rec["sha256"]:
                    raise ValueError(
                        f"shard {rec['file']} digest {sdigest[:12]}... != manifest "
                        f"{rec['sha256'][:12]}... (torn multi-process save)"
                    )
                parts.append(pickle.loads(sblob)["summed_scores"])
            if all(p is None for p in parts):
                payload["summed_scores"] = None
            elif all(isinstance(p, torch.Tensor) for p in parts):
                payload["summed_scores"] = torch.cat(parts)
            else:
                payload["summed_scores"] = np.concatenate([np.asarray(p) for p in parts])
        return manifest, payload

    def checkpoints(self) -> List[str]:
        """Checkpoint directories on disk, oldest first (for tests/tools)."""
        return [
            os.path.join(self.directory, f"{_DIR_PREFIX}{s:06d}")
            for s in sorted(self._steps_on_disk())
        ]
