"""Fault tolerance for the port's training runs (the JAX package's
``robust``, single-process):

- :mod:`robust.atomic`: write-temp + fsync + atomic-rename file creation
  (readers never see a torn file);
- :mod:`robust.retry`: seeded, bounded exponential-backoff retry around IO
  sites, counted in ``photon_retry_attempts_total{site=}``;
- :mod:`robust.checkpoint`: coordinate-update-boundary snapshots of the
  coordinate-descent loop with digest-bearing manifests and keep-last-K
  rotation (kill the process anywhere and ``--resume`` replays the
  remaining updates bit for bit);
- :mod:`robust.faults`: a deterministic, seeded fault injector (default
  off, env-activated) that makes the other three testable.

``cli.train --checkpoint-dir D --checkpoint-every N`` / ``--resume`` wire
this end to end. The distributed liveness plane (heartbeats, bounded-time
barriers) and the two-phase multi-process checkpoint are ROADMAP A10.
"""

from .atomic import atomic_write, atomic_write_bytes, atomic_write_json, atomic_write_text
from .checkpoint import (
    CheckpointError,
    CheckpointIncompatibleError,
    CheckpointManager,
    CheckpointSnapshot,
)
from .faults import FaultInjector, FaultSpec, InjectedIOError, SimulatedKill, parse_faults
from .retry import DEFAULT_IO_POLICY, RetryPolicy, io_call

__all__ = [
    "CheckpointError",
    "CheckpointIncompatibleError",
    "CheckpointManager",
    "CheckpointSnapshot",
    "DEFAULT_IO_POLICY",
    "FaultInjector",
    "FaultSpec",
    "InjectedIOError",
    "RetryPolicy",
    "SimulatedKill",
    "atomic_write",
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_text",
    "io_call",
    "parse_faults",
]
