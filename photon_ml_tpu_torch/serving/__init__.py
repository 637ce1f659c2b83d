"""Scoring: the batch part of the JAX package's ``serving`` (the
``ScoreEngine`` under ``cli.score`` and ``GameTransformer``). The resident
server, its request batcher, model store, snapshot refresh and fleet are
ROADMAP A9."""

from .engine import EllRows, ScoreEngine

__all__ = ["EllRows", "ScoreEngine"]
