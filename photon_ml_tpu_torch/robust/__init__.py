"""Crash-safe writes and bounded retry for the port's IO (``atomic``,
``retry``). Checkpoints, fault injection and the distributed liveness plane
come with ROADMAP A13 and A10."""

from .atomic import atomic_write, atomic_write_bytes, atomic_write_json, atomic_write_text
from .retry import DEFAULT_IO_POLICY, RetryPolicy, io_call

__all__ = [
    "DEFAULT_IO_POLICY",
    "RetryPolicy",
    "atomic_write",
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_text",
    "io_call",
]
