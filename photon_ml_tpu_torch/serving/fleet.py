"""Multi-model residency: N named snapshots resident in one process, each
behind its own bulkhead (the JAX package's ``serving/fleet.py`` on the
port).

The GLMix deployment story is many per-market / per-surface model variants
(the reference trains one GAME model set per market); one resident process
per variant wastes a warm accelerator, but naive co-residency couples their
failure domains. :class:`ModelSet` holds N named models over one store root
and isolates them three ways:

- **per-model bulkheads** — every model owns one ``MicroBatcher``: its own
  worker thread, pending bound, deadline-budget admission, and service-rate
  EWMA. A delay storm on one model stalls that model's worker only; its
  queue fills, its requests shed (typed, counted under its ``model=``
  label), and every other model's batches drain untouched.
- **staggered refresh** — every serving-root model owns one
  ``RefreshWatcher``, so snapshots flip independently: a torn publish on
  one model is swallowed (``serving.refresh``) and retried by *that*
  watcher while the other models keep flipping on their own schedules.
- **shared kernels, not shared state** — every model's fixed effects go
  through the one S1 library the process loads once (``ops/cuda_lib.py``),
  which takes the coefficient table as an argument, and a ladder batch's
  uniform-width segments need no host pointer build; residency costs one
  mmap store + one device table set per model, no further build.

Model sources are heterogeneous: a serving root (CURRENT + snapshots/,
watched), a bare store directory or opened ``ModelStore`` (fixed), or a
built ``ScoreEngine``. ``discover_fleet`` maps a fleet root — one
directory with one serving root per model subdirectory — into the
``models=`` mapping ``cli serve --fleet-root`` serves.

Routing is by name: ``resolve(None)`` is the default model; an unknown (or
``warm_async=True`` still-warming) name raises :class:`UnknownModelError`,
which the socket layer answers as a typed ``bad_request``
kind=``unknown_model`` — never silently scored against the default.
Duplicate names are refused up front through the support-matrix ledger
(``plan.check_fleet_composition``).
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .. import obs
from ..device import DeviceLike, pin_device
from ..plan import check_fleet_composition
from .batcher import MicroBatcher, RequestTrace
from .engine import ScoreEngine, ScoreRequest
from .refresh import CURRENT_POINTER, RefreshWatcher, open_current
from .store import STORE_META, ModelStore

ModelSource = Union[str, ModelStore, ScoreEngine]


class UnknownModelError(LookupError):
    """A request named a model this fleet does not hold (or holds but has
    not finished warming). The socket layer maps it to a typed
    ``bad_request`` kind=``unknown_model`` response; in-process callers see
    this exception directly. ``model`` is the requested name."""

    kind = "unknown_model"

    def __init__(self, model: Optional[str], message: str):
        super().__init__(message)
        self.model = model


class _ModelEntry:
    """One resident model: source + engine + bulkhead + optional watcher."""

    def __init__(self, name: str):
        self.name = name
        self.serving_root: Optional[str] = None
        self.snapshot_name: Optional[str] = None
        self.engine: Optional[ScoreEngine] = None
        self.batcher: Optional[MicroBatcher] = None
        self.watcher: Optional[RefreshWatcher] = None
        self.ready = threading.Event()


def discover_fleet(fleet_root: str) -> Dict[str, str]:
    """Map a fleet root (one serving root, or bare store dir, per model
    subdirectory) to a sorted ``{model_name: path}`` mapping."""
    models: Dict[str, str] = {}
    for name in sorted(os.listdir(fleet_root)):
        path = os.path.join(fleet_root, name)
        if not os.path.isdir(path):
            continue
        if os.path.exists(os.path.join(path, CURRENT_POINTER)) or os.path.exists(
            os.path.join(path, STORE_META)
        ):
            models[name] = path
    if not models:
        raise FileNotFoundError(
            f"{fleet_root}: no model subdirectories (each model needs a "
            f"serving root with {CURRENT_POINTER}, or a bare store dir)"
        )
    return models


class ModelSet:
    """N named resident models over one store root, one bulkhead each.

    ``models`` maps name -> source (or is a sequence of (name, source)
    pairs — the order-preserving spelling ``--models`` uses, where a
    repeated name is refused through the support-matrix ledger). The first
    name is the default model unless ``default_model`` says otherwise.
    ``per_model`` optionally overrides the shared batcher settings for
    individual models (each bulkhead's admission budget is its own either
    way). ``warm_async=True`` builds + warms engines on background threads;
    until a model's ladder is warm it answers :class:`UnknownModelError`
    (the socket layer's ``unknown_model``) instead of serving cold.

    Engines built here from stores live on ``device`` (the caller's current
    card if None; resolved and pinned up front, so a flip on a watcher
    thread stays on that card, and a set that builds engines raises at
    construction where there is no card); a set of ready-made engines needs
    no device.
    """

    def __init__(
        self,
        models: Union[Mapping[str, ModelSource], Sequence[Tuple[str, ModelSource]]],
        default_model: Optional[str] = None,
        max_batch: int = 256,
        max_latency_ms: float = 2.0,
        max_pending: int = 1024,
        slow_request_ms: Optional[float] = None,
        per_model: Optional[Mapping[str, Mapping]] = None,
        poll_seconds: float = 0.2,
        dtype=torch.float32,
        warm_async: bool = False,
        device: DeviceLike = None,
    ):
        pairs = (
            list(models.items())
            if isinstance(models, Mapping)
            else [(str(n), s) for n, s in models]
        )
        if not pairs:
            raise ValueError("ModelSet needs at least one model")
        check_fleet_composition([n for n, _ in pairs])
        if default_model is not None and default_model not in {n for n, _ in pairs}:
            raise ValueError(
                f"default model {default_model!r} is not in the fleet: "
                f"{sorted(n for n, _ in pairs)}"
            )
        self.default_model: str = default_model or pairs[0][0]
        self.dtype = dtype
        builds = any(isinstance(src, (str, os.PathLike, ModelStore)) for _, src in pairs)
        # pinned here: engines are built later, on watcher threads too
        self.device = pin_device(device) if builds else device
        self.poll_seconds = float(poll_seconds)
        self._batcher_opts = dict(
            max_batch=max_batch,
            max_latency_ms=max_latency_ms,
            max_pending=max_pending,
            slow_request_ms=slow_request_ms,
        )
        # one lock for every entry's engine swap: flips are rare and the
        # critical section is one attribute assignment
        self._lock = threading.Lock()
        self._entries: Dict[str, _ModelEntry] = {}
        self._warm_threads: List[threading.Thread] = []
        try:
            for name, source in pairs:
                entry = _ModelEntry(name)
                opts = dict(self._batcher_opts)
                opts.update((per_model or {}).get(name, {}))
                entry.batcher = MicroBatcher(
                    functools.partial(self._entry_engine, entry),
                    model=name,
                    **opts,
                )
                self._entries[name] = entry
                if warm_async:
                    t = threading.Thread(
                        target=functools.partial(self._open_entry, entry, source),
                        name=f"photon-serving-warm-{name}",
                        daemon=True,
                    )
                    self._warm_threads.append(t)
                    t.start()
                else:
                    self._open_entry(entry, source)
        except BaseException:
            self.close()
            raise

    # -- construction / refresh flips ----------------------------------------

    def _open_entry(self, entry: _ModelEntry, source: ModelSource) -> None:
        """Open one model's source, build + warm its engine, and (for a
        serving root) start its own RefreshWatcher — the staggered-refresh
        unit: each watcher flips its model independently, so a torn publish
        on one model never stalls another's flip."""
        try:
            if isinstance(source, ModelStore):
                self._install(entry, None, source)
            elif not isinstance(source, (str, os.PathLike)):
                # a ready-made engine, duck-typed (anything with
                # score_requests; tests use fakes), warmed when it knows how
                engine = source
                warm = getattr(engine, "warm", None)
                if warm is not None:
                    warm()
                with self._lock:
                    entry.engine = engine
            else:
                root = str(source)
                if os.path.exists(os.path.join(root, CURRENT_POINTER)):
                    entry.serving_root = root
                    snap, store = open_current(root)
                    self._install(entry, snap, store)
                    entry.watcher = RefreshWatcher(
                        root,
                        functools.partial(self._install, entry),
                        poll_seconds=self.poll_seconds,
                        live=snap,
                        model=entry.name,
                    )
                else:
                    self._install(entry, None, ModelStore.open(root))
        except Exception:
            # a model that failed to open must not take down its siblings
            # (the warm_async path runs on a background thread): it stays
            # not-ready — requests naming it get the typed unknown_model
            # refusal — and the failure is counted, never swallowed silently
            obs.swallowed_error("serving.fleet")
            return
        entry.ready.set()

    def _install(
        self, entry: _ModelEntry, snapshot: Optional[str], store: ModelStore
    ) -> None:
        """Build the engine for a freshly opened store, then flip ``entry``'s
        live reference in one assignment. Warm before the flip: a flip must
        not stall in-flight traffic on a build (the S1 library loads once a
        process, so warming the Nth model builds nothing). Called at open time and from the entry's
        RefreshWatcher thread on every staggered flip: the new tables are
        staged on the device before the swap, and a batch scores on the one
        engine it captured, never on a mix of two."""
        live = entry.ready.is_set()
        if live:
            # /healthz answers 503 for exactly the mid-publish window, so a
            # load balancer (or the replica front) drains this replica while
            # the flip is in flight — scoring keeps working on the old
            # engine until the one-assignment swap below
            obs.current_run().status.update(refresh_in_progress=True)
        try:
            engine = ScoreEngine.from_store(store, dtype=self.dtype, device=self.device)
            engine.warm()
            with self._lock:
                entry.engine = engine
                entry.snapshot_name = snapshot
        finally:
            if live:
                obs.current_run().status.update(refresh_in_progress=False)
        self._publish_status()

    def _entry_engine(self, entry: _ModelEntry) -> ScoreEngine:
        with self._lock:
            return entry.engine

    def _publish_status(self) -> None:
        # serving_snapshot (singular) keeps the pre-fleet /statusz contract:
        # the default model's live snapshot; serving_snapshots is the
        # per-model breakdown the fleet statusz section renders
        default = self._entries.get(self.default_model)
        obs.current_run().status.update(
            serving_snapshot=None if default is None else default.snapshot_name,
            serving_snapshots={
                n: e.snapshot_name for n, e in self._entries.items()
            },
        )

    # -- routing surface ------------------------------------------------------

    @property
    def names(self) -> List[str]:
        return list(self._entries)

    @property
    def snapshot_names(self) -> Dict[str, Optional[str]]:
        return {n: e.snapshot_name for n, e in self._entries.items()}

    def resolve(self, model: Optional[str]) -> str:
        """The resolved model name for a requested one (None -> default);
        raises :class:`UnknownModelError` for names this fleet does not
        hold or has not finished warming."""
        name = self.default_model if model is None else str(model)
        entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(
                model,
                f"unknown model {name!r}: this fleet holds "
                f"{sorted(self._entries)}",
            )
        if not entry.ready.is_set():
            raise UnknownModelError(
                model, f"model {name!r} is still warming; retry shortly"
            )
        return name

    def submit(
        self,
        request: ScoreRequest,
        deadline_s: Optional[float] = None,
        trace: Optional[RequestTrace] = None,
        model: Optional[str] = None,
    ):
        """Route one request to its model's bulkhead; returns the batcher's
        Future. ``model`` (explicit arg, else ``request.model``) picks the
        bulkhead; admission refusals raise the model's own ShedError."""
        name = self.resolve(model if model is not None else request.model)
        return self._entries[name].batcher.submit(
            request, deadline_s=deadline_s, trace=trace
        )

    def warm_wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every model is ready (warm_async construction);
        returns False on timeout."""
        for t in self._warm_threads:
            t.join(timeout=timeout)
        return all(e.ready.is_set() for e in self._entries.values())

    def queue_stats(self, model: Optional[str] = None) -> dict:
        """Live admission-queue view: one model's (by name), or — with
        ``model=None`` on a multi-model set — the fleet aggregate (summed
        pending, max drain estimate: the worst bulkhead gates the fleet)."""
        if model is not None or len(self._entries) == 1:
            name = self.resolve(model)
            return self._entries[name].batcher.queue_stats()
        per = {
            n: e.batcher.queue_stats() for n, e in self._entries.items()
        }
        return {
            "pending": sum(s["pending"] for s in per.values()),
            "ewma_service_seconds": None,
            "drain_estimate_seconds": max(
                s["drain_estimate_seconds"] for s in per.values()
            ),
            "models": per,
        }

    def poke_refresh(self, model: Optional[str] = None) -> None:
        """Force an immediate CURRENT check on one model's watcher (by
        name) or all of them (tests; avoids poll sleeps)."""
        entries = (
            self._entries.values()
            if model is None
            else [self._entries[self.resolve(model)]]
        )
        for e in entries:
            if e.watcher is not None:
                e.watcher.poke()

    def close(self) -> None:
        for t in self._warm_threads:
            t.join(timeout=5.0)
        for e in self._entries.values():
            if e.watcher is not None:
                e.watcher.stop()
            if e.batcher is not None:
                e.batcher.close()
