"""Scoring and publication: the batch part of the JAX package's
``serving`` (the ``ScoreEngine`` under ``cli.score`` and
``GameTransformer``), its mmap model store (``store``) and the publish side
of its snapshot refresh (``refresh``: ``publish_snapshot``,
``current_snapshot``, ``open_current``). The resident server, its request
batcher, the refresh watcher and the fleet are ROADMAP A9."""

from .engine import EllRows, ScoreEngine
from .refresh import current_snapshot, open_current, publish_snapshot, snapshot_path
from .store import ModelStore, build_store, build_store_from_model, discover_shards

__all__ = [
    "EllRows",
    "ModelStore",
    "ScoreEngine",
    "build_store",
    "build_store_from_model",
    "current_snapshot",
    "discover_shards",
    "open_current",
    "publish_snapshot",
    "snapshot_path",
]
