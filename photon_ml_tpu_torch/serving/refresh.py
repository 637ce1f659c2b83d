"""Zero-downtime model refresh: atomic snapshot publication and a watcher
that flips the live store mid-traffic (the JAX package's
``serving/refresh.py`` on the port).

Publication layout (one serving root per deployed model)::

    serving_root/
      CURRENT                # text file: the live snapshot's name
      snapshots/<name>/      # one mmap store each (serving.store layout)

``publish_snapshot`` builds the store in a hidden temp directory, renames it
into ``snapshots/<name>`` (one atomic directory rename), then rewrites
``CURRENT`` through ``robust.atomic``: a reader sees either the old pointer
or the new one, never a half-built store. The layout is the JAX package's,
so either package's server can serve the other's snapshots.

``RefreshWatcher`` polls ``CURRENT``; on a change it opens the new store
*beside* the live one and hands it to the server, which stages the new
engine on the device and then swaps a single engine reference between
microbatches (see ``serving.batcher``): requests in flight finish on the old
snapshot, the next batch scores on the new one, and nothing blocks.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Callable, Mapping, Optional

from .. import obs
from ..robust import faults
from ..robust.atomic import atomic_write_text
from ..robust.retry import io_call
from .store import ModelStore, build_store, build_store_from_model

CURRENT_POINTER = "CURRENT"
SNAPSHOT_DIR = "snapshots"


def snapshot_path(serving_root: str, name: str) -> str:
    return os.path.join(serving_root, SNAPSHOT_DIR, name)


def publish_snapshot(
    serving_root: str,
    name: str,
    game_model=None,
    model_dir: Optional[str] = None,
    index_maps: Optional[Mapping[str, object]] = None,
    task: Optional[str] = None,
    replace: bool = False,
) -> str:
    """Build ``name`` from either an in-memory GameModel or an Avro model
    directory, publish it atomically, and point ``CURRENT`` at it.

    ``replace=True`` is the torn-publish repair (the retrain chain's next
    cycle): a stale half-built ``.tmp-<name>`` from a crashed publish is
    discarded, and a ``name`` that already finished publishing is reused as
    it is, only ``CURRENT`` re-pointed. Without it a completed snapshot name
    is refused (snapshots are immutable once published)."""
    if (game_model is None) == (model_dir is None):
        raise ValueError("pass exactly one of game_model / model_dir")
    final = snapshot_path(serving_root, name)
    tmp = os.path.join(serving_root, SNAPSHOT_DIR, f".tmp-{name}")
    pointer = os.path.join(serving_root, CURRENT_POINTER)
    if os.path.exists(final):
        if not replace:
            raise FileExistsError(f"snapshot already published: {final}")
        # the store build committed; a retry only needs the pointer flip
        atomic_write_text(pointer, name + "\n")
        return final
    if replace and os.path.exists(tmp):
        shutil.rmtree(tmp)  # the half-built leftover of a torn publish
    os.makedirs(os.path.dirname(final), exist_ok=True)
    if game_model is not None:
        build_store_from_model(game_model, tmp)
    else:
        build_store(model_dir, index_maps or {}, tmp, task=task)
    os.rename(tmp, final)  # atomic directory publish
    atomic_write_text(pointer, name + "\n")
    return final


def current_snapshot(serving_root: str) -> Optional[str]:
    """The live snapshot's name, or None before the first publish."""
    path = os.path.join(serving_root, CURRENT_POINTER)
    if not os.path.exists(path):
        return None

    def _read():
        with open(path) as f:
            return f.read().strip()

    return io_call(_read, site="io.serving_store") or None


def open_current(serving_root: str):
    """(name, ModelStore) of the live snapshot; raises if none is published."""
    name = current_snapshot(serving_root)
    if name is None:
        raise FileNotFoundError(f"{serving_root}: no published snapshot (no {CURRENT_POINTER})")
    return name, ModelStore.open(snapshot_path(serving_root, name))


class RefreshWatcher:
    """Background poller that loads newly published snapshots and hands them
    to ``on_flip(name, store)``. Counted in ``photon_serving_refresh_total``;
    a failed load leaves the live model serving and is counted via
    ``obs.swallowed_error('serving.refresh')``."""

    def __init__(
        self,
        serving_root: str,
        on_flip: Callable[[str, ModelStore], None],
        poll_seconds: float = 0.2,
        live: Optional[str] = None,
        model: str = "default",
    ):
        self.serving_root = serving_root
        self._on_flip = on_flip
        self.poll_seconds = float(poll_seconds)
        self._live = live
        # fleet identity: each resident model has its own watcher (flips
        # never synchronize across models), so the flip count and span
        # carry the model= label
        self.model = str(model)
        # serializes _check between the poll thread and poke() callers: both
        # run the read-compare-flip of _live, and an unserialized pair could
        # load the same snapshot twice or publish flips out of order
        self._check_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"photon-serving-refresh-{self.model}", daemon=True,
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    def poke(self) -> None:
        """Check for a new snapshot now (tests; avoids poll-interval sleeps)."""
        self._check()

    def _check(self) -> None:
        with self._check_lock:
            try:
                # the refresh chaos site: PHOTON_FAULTS serving.refresh:delay
                # stalls a flip mid-poll, serving.refresh:io raises into the
                # swallow-and-retry path below while the live model serves on
                faults.check("serving.refresh")
                name = current_snapshot(self.serving_root)
                if name is None or name == self._live:
                    return
                # retry with backoff inside the poll (photon_retry_attempts_total
                # {site=}): a transient error while opening the snapshot
                # recovers within this poll
                store = io_call(
                    ModelStore.open, snapshot_path(self.serving_root, name), site="io.serving_store",
                )
            except Exception:
                # a torn or late publish must not take down serving: keep the
                # live model, count the failure, retry next poll
                obs.swallowed_error("serving.refresh")
                return
            with obs.span("serving.refresh.flip", snapshot=name, model=self.model):
                self._on_flip(name, store)
            self._live = name
            obs.current_run().registry.counter(
                "photon_serving_refresh_total",
                "model snapshots flipped in without downtime",
            ).labels(model=self.model).inc()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._check()
            self._stop.wait(self.poll_seconds)
