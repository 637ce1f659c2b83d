"""Atomic snapshot publication: the publish side of the JAX package's
``serving/refresh.py``.

Publication layout (one serving root per deployed model)::

    serving_root/
      CURRENT                # text file: the live snapshot's name
      snapshots/<name>/      # one mmap store each (serving.store layout)

``publish_snapshot`` builds the store in a hidden temp directory, renames it
into ``snapshots/<name>`` (one atomic directory rename), then rewrites
``CURRENT`` through ``robust.atomic``: a reader sees either the old pointer
or the new one, never a half-built store. The layout is the JAX package's,
so either package's server can serve the other's snapshots.

The watcher that flips a running server to a newly published snapshot
(``RefreshWatcher``) is ROADMAP A9.
"""

from __future__ import annotations

import os
import shutil
from typing import Mapping, Optional

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
