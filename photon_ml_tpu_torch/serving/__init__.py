"""Resident GLMix scoring service on the card (the JAX package's
``serving``, ported).

Pieces, composable or standalone:

- ``store``   — mmap model store: open-not-parse startup, host RSS
  independent of entity count.
- ``engine``  — the one score assembly, shared by batch scoring
  (``cli.score`` / ``GameTransformer``) and the resident request path:
  S1's ELL matvec for the fixed effects, ``score_entity_ell`` for the
  random effects.
- ``batcher`` — microbatching under a max-latency / max-batch policy, with
  deadline-budget admission control (bounded queue, typed ``ShedError``
  refusals).
- ``refresh`` — atomic snapshot publication + zero-downtime flips.
- ``server``  — the composed resident service (+ AF_UNIX / TCP JSON-lines
  front, byte-compatible with the JAX package's).
- ``fleet``   — multi-model residency: N named snapshots in one process,
  each behind its own bulkhead (batcher + refresh watcher), routed by the
  request protocol's ``model=`` field.
- ``front``   — the least-loaded replica front: N ``cli serve`` replicas
  behind one address, health-checked via ``/healthz``, with idempotent
  trace_id resubmit when a replica dies mid-request.
- ``loadgen`` — open-loop Poisson load generation measuring latency from
  intended send time (the coordinated-omission-proof harness behind
  ``chip_smoke.py --only serving``'s knee sweep).
"""

from .batcher import SERVING_LATENCY_BUCKETS, MicroBatcher, ShedError
from .engine import LADDER_ROWS, LADDER_WIDTH, EllRows, ScoreEngine, ScoreRequest
from .fleet import ModelSet, UnknownModelError, discover_fleet
from .front import LeastLoadedFront, serve_front_socket
from .loadgen import (
    OpenLoopResult,
    find_knee,
    poisson_intended_times,
    run_mixed_open_loop,
    run_open_loop,
    simulate_fifo_closed_loop,
    simulate_fifo_open_loop,
    sweep_open_loop,
)
from .refresh import (
    RefreshWatcher,
    current_snapshot,
    open_current,
    publish_snapshot,
    snapshot_path,
)
from .server import (
    MAX_REQUEST_LINE_BYTES,
    BadRequestError,
    ScoringServer,
    serve_socket,
)
from .store import (
    ModelStore,
    build_store,
    build_store_from_model,
    discover_shards,
)

__all__ = [
    "SERVING_LATENCY_BUCKETS",
    "MicroBatcher",
    "ShedError",
    "LADDER_ROWS",
    "LADDER_WIDTH",
    "EllRows",
    "ScoreEngine",
    "ScoreRequest",
    "ModelSet",
    "UnknownModelError",
    "discover_fleet",
    "LeastLoadedFront",
    "serve_front_socket",
    "OpenLoopResult",
    "find_knee",
    "poisson_intended_times",
    "run_mixed_open_loop",
    "run_open_loop",
    "simulate_fifo_closed_loop",
    "simulate_fifo_open_loop",
    "sweep_open_loop",
    "RefreshWatcher",
    "current_snapshot",
    "open_current",
    "publish_snapshot",
    "snapshot_path",
    "MAX_REQUEST_LINE_BYTES",
    "BadRequestError",
    "ScoringServer",
    "serve_socket",
    "ModelStore",
    "build_store",
    "build_store_from_model",
    "discover_shards",
]
