"""Distributed fault tolerance: heartbeats and bounded-time collectives.

The JAX package's ``robust/distributed.py`` on the port. The reference
survives executor loss because Spark's scheduler notices a dead executor
(missed heartbeats) and fails the stage within a bounded time. A group of
``torch.distributed`` processes has none of that by default: one dead or
stalled rank leaves its peers blocked in the next collective until the
process group's own timeout. This module is the liveness layer:

- **Heartbeat plane**: each process runs a :class:`HeartbeatWriter` daemon
  thread that writes a liveness record (``heartbeat-p<i>.json``, a strictly
  increasing ``seq`` and a wall stamp) into the run's shared directory via
  :mod:`robust.atomic`, so a reader never sees a torn record. Peers read the
  ages with :func:`heartbeat_ages` (the
  ``photon_dist_heartbeat_age_seconds{process=}`` gauge), and
  :func:`check_peers` raises a typed :class:`PeerLostError` for a peer whose
  record is stale or absent. The plane is host file IO only: it never
  touches a card.

- **Bounded-time collectives**: :func:`barrier_with_timeout` meets every
  process within a deadline. The JAX package waits at a barrier of its
  coordination service; here the barrier is ``monitored_barrier`` over gloo
  (the default group when it is gloo, else the gloo side group that
  ``parallel.multihost.initialize`` makes beside NCCL), with
  ``wait_all_ranks=True`` so that process 0 names every rank that never
  arrived. A dead peer turns the hang into a typed
  :class:`DistributedTimeoutError` within the budget, counted in
  ``photon_dist_collective_timeouts_total{barrier=}`` and decorated with
  the peers the heartbeat plane finds stale. :func:`configure_collectives`
  arms a process-wide budget; :func:`guard_collective` is the barrier the
  object collectives of ``parallel/multihost.py`` meet at first, and
  ``game/descent.py`` calls :func:`sweep_barrier` at every sweep boundary,
  so a death within a sweep is found at the next boundary. On a timeout
  ``cli.train`` dumps a ``peer_lost`` flight-recorder postmortem and exits
  non-zero.

What the budget bounds: the barriers (every sweep boundary, and the entry of
every object collective: the dataset build's planning exchange, the
two-phase checkpoint's confirmations, the broadcast of resume state). The
row-data collectives inside a sweep (B4's slot gathers, the score and
result gathers) are not preceded by a barrier: over gloo a dead peer
closes its connections and they fail at once; over NCCL they end only at
the process group's timeout (``parallel.multihost.DEFAULT_TIMEOUT_S``).

Fault sites (:mod:`robust.faults`): ``dist.heartbeat`` fires on every
heartbeat write (``io`` starves the record so that peers see it age,
``kill`` takes the heartbeat thread down), ``dist.collective`` at sweep
boundary barriers only (``delay`` holds this process out of the rendezvous,
``kill`` is the kill-a-worker drill). The two-phase checkpoint has its own
``dist.commit`` site in :mod:`robust.checkpoint`.

One process: every entry point is a no-op, but the fault site still fires,
so the semantics stay testable without a group.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional

from . import faults
from .atomic import atomic_write_json

logger = logging.getLogger("photon_ml_tpu_torch")

HEARTBEAT_PREFIX = "heartbeat-p"

# the texts of a barrier that failed because a peer is gone: a deadline run
# out, or the transport noticing the dead peer first (a closed or reset
# connection). Anything else (a mis-addressed store, a refused
# configuration) re-raises untranslated.
_LIVENESS_MARKERS = (
    "DEADLINE", "TIMED OUT", "TIMEOUT", "UNAVAILABLE", "DISCONNECT", "ABORTED", "SHUT DOWN",
    "SHUTTING DOWN", "HEARTBEAT", "BARRIER FAILED", "MONITOREDBARRIER", "CONNECTION CLOSED",
    "CONNECTION RESET", "BROKEN PIPE",
)
_MISSING_RANKS = re.compile(r"Ranks? ([\d, ]+) failed to pass monitoredBarrier")


class DistributedError(RuntimeError):
    """Base class for distributed liveness failures."""


class PeerLostError(DistributedError):
    """A peer process's heartbeat is stale or absent: it is presumed dead
    (or wedged), and collectives involving it will not complete."""


class DistributedTimeoutError(DistributedError):
    """A collective rendezvous did not complete within the configured
    budget: at least one peer never arrived. Raised instead of hanging."""


def _registry():
    from .. import obs

    return obs.current_run().registry


# -- the heartbeat plane ------------------------------------------------------


def heartbeat_path(run_dir: str, process: int) -> str:
    return os.path.join(run_dir, f"{HEARTBEAT_PREFIX}{int(process)}.json")


def write_heartbeat(run_dir: str, process: int, seq: int, fsync: bool = False) -> str:
    """Write one liveness record (atomic: temp + rename, never torn).
    ``seq`` is the writer's beat counter (a wedged writer shows as a seq
    that stops advancing, whatever the clocks say); ``unix`` is what
    :func:`heartbeat_ages` measures against."""
    faults.check("dist.heartbeat")
    path = heartbeat_path(run_dir, process)
    atomic_write_json(
        path,
        {"process": int(process), "seq": int(seq), "unix": time.time(), "pid": os.getpid()},
        fsync=fsync,
    )
    return path


def read_heartbeats(run_dir: str) -> Dict[int, dict]:
    """Every liveness record under ``run_dir``, by process index. An
    unreadable record is skipped (it reads as a missing peer)."""
    out: Dict[int, dict] = {}
    if not os.path.isdir(run_dir):
        return out
    for name in os.listdir(run_dir):
        if not name.startswith(HEARTBEAT_PREFIX) or not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(run_dir, name), encoding="utf-8") as f:
                rec = json.load(f)
            out[int(rec["process"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def heartbeat_ages(run_dir: str, now: Optional[float] = None, record_metric: bool = True) -> Dict[int, float]:
    """Seconds since each process's last beat, by process index; also sets
    the ``photon_dist_heartbeat_age_seconds{process=}`` gauge."""
    now = time.time() if now is None else now
    ages = {p: max(0.0, now - float(rec.get("unix", 0.0))) for p, rec in read_heartbeats(run_dir).items()}
    if record_metric and ages:
        gauge = _registry().gauge(
            "photon_dist_heartbeat_age_seconds", "seconds since each process's last liveness beat"
        )
        for p, age in ages.items():
            gauge.labels(process=str(p)).set(age)
    return ages


def stale_peers(
    run_dir: str,
    n_processes: int,
    stale_after_s: float,
    self_process: Optional[int] = None,
    now: Optional[float] = None,
) -> List[int]:
    """Peer process indices whose heartbeat is older than ``stale_after_s``
    or absent (never started, or unreadable)."""
    ages = heartbeat_ages(run_dir, now=now)
    return [
        p for p in range(int(n_processes))
        if p != self_process and ages.get(p, float("inf")) > stale_after_s
    ]


def check_peers(
    run_dir: str,
    n_processes: int,
    stale_after_s: float,
    self_process: Optional[int] = None,
    now: Optional[float] = None,
) -> None:
    """Raise :class:`PeerLostError` naming every stale or absent peer."""
    stale = stale_peers(run_dir, n_processes, stale_after_s, self_process=self_process, now=now)
    if stale:
        ages = heartbeat_ages(run_dir, now=now, record_metric=False)
        detail = ", ".join(f"p{p}={ages[p]:.1f}s" if p in ages else f"p{p}=never" for p in stale)
        raise PeerLostError(
            f"peer process(es) {stale} presumed lost: last heartbeat older "
            f"than {stale_after_s:.1f}s ({detail}) under {run_dir}"
        )


class HeartbeatWriter:
    """Daemon thread beating every ``interval_s`` into ``run_dir``.

    A failed beat (a transient file system error, or an injected
    ``dist.heartbeat:io``) is swallowed and counted, and the next beat
    repairs the record; only a ``dist.heartbeat:kill`` (a
    :class:`~robust.faults.SimulatedKill`, a ``BaseException``) takes the
    thread down: the process computes on while its peers stop hearing from
    it."""

    def __init__(self, run_dir: str, process: int, interval_s: float = 1.0, fsync: bool = False):
        if interval_s <= 0:
            raise ValueError(f"heartbeat interval must be > 0: {interval_s}")
        self.run_dir = run_dir
        self.process = int(process)
        self.interval_s = float(interval_s)
        self.fsync = fsync
        self.seq = 0
        os.makedirs(run_dir, exist_ok=True)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=f"photon-heartbeat-p{self.process}", daemon=True)

    def start(self) -> "HeartbeatWriter":
        self.beat()  # the first record lands before any peer could check
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def beat(self) -> None:
        """One synchronous liveness write (the thread loop's body)."""
        # the main thread writes once in start(), before the beat thread
        # exists; after that only the beat thread touches seq
        self.seq = self.seq + 1
        write_heartbeat(self.run_dir, self.process, self.seq, fsync=self.fsync)

    def _run(self) -> None:
        from .. import obs

        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception:
                # transient: the record ages one more interval
                obs.swallowed_error("dist.heartbeat")


# -- bounded-time collectives -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveGuard:
    """The armed collective-timeout configuration (process-wide)."""

    timeout_s: float
    run_dir: Optional[str] = None  # heartbeat directory, for timeout diagnosis
    stale_after_s: float = 10.0


_guard: Optional[CollectiveGuard] = None
_barrier_lock = threading.Lock()
_barrier_seq: Dict[str, int] = {}


def configure_collectives(timeout_s: float, run_dir: Optional[str] = None, stale_after_s: float = 10.0) -> None:
    """Arm the process-wide collective budget (``cli.train`` does for runs
    of several processes; ``timeout_s <= 0`` disarms). Every process arms
    the same budget; the barrier ids are call-ordered, so the configuration
    itself needs no collective."""
    global _guard
    if timeout_s and timeout_s > 0:
        _guard = CollectiveGuard(timeout_s=float(timeout_s), run_dir=run_dir, stale_after_s=float(stale_after_s))
    else:
        _guard = None


def clear_collectives() -> None:
    """Disarm, and reset the barrier sequence numbers."""
    global _guard
    _guard = None
    with _barrier_lock:
        _barrier_seq.clear()


def collective_timeout() -> Optional[float]:
    g = _guard
    return g.timeout_s if g is not None else None


def _process_count() -> int:
    """Every process of the world (on a grid as well: each rank beats and
    meets at the barriers)."""
    from ..parallel import multihost

    return multihost.world_size()


class _MonitoredBarrier:
    """The barrier client over ``torch.distributed``: every rank meets at a
    gloo ``monitored_barrier``. Process 0 waits for each peer within the
    timeout and names every one that never arrived; a peer waits for
    process 0's release within the same timeout."""

    def wait_at_barrier(self, barrier_id: str, timeout_in_ms: int) -> None:
        import torch.distributed as dist

        from ..parallel import multihost

        dist.monitored_barrier(
            group=multihost.side_group(), timeout=datetime.timedelta(milliseconds=timeout_in_ms),
            wait_all_ranks=True,
        )


def _barrier_client():
    """The client barriers wait on: the monitored barrier of the process
    group this process joined, or None without one."""
    import torch.distributed as dist

    return _MonitoredBarrier() if dist.is_available() and dist.is_initialized() else None


def _next_barrier_id(name: str) -> str:
    # unique per use and the same on every process: calls are SPMD-ordered,
    # so a per-name counter agrees everywhere
    with _barrier_lock:
        n = _barrier_seq.get(name, 0) + 1
        _barrier_seq[name] = n
    return f"photon:{name}:{n}"


def barrier_with_timeout(
    name: str,
    timeout_s: Optional[float] = None,
    fault_site: Optional[str] = "dist.collective",
) -> None:
    """Meet every process within ``timeout_s`` (the armed budget by
    default) or raise :class:`DistributedTimeoutError`.

    The fault site fires before the rendezvous: ``dist.collective:delay``
    holds this process out of the barrier, ``dist.collective:kill`` dies at
    it. One process: the site fires and the rendezvous is a no-op."""
    if fault_site:
        faults.check(fault_site)
    g = _guard
    budget = timeout_s if timeout_s is not None else (g.timeout_s if g is not None else None)
    if _process_count() == 1:
        return
    if budget is None:
        return  # unarmed: the collectives keep their blocking shape
    client = _barrier_client()
    if client is None:
        logger.warning("collective budget armed but no process group; barrier %s degraded to a no-op", name)
        return
    barrier_id = _next_barrier_id(name)
    t0 = time.perf_counter()
    try:
        client.wait_at_barrier(barrier_id, int(budget * 1000))
    except Exception as e:
        text = str(e)
        if not any(marker in text.upper() for marker in _LIVENESS_MARKERS):
            raise
        detail = ""
        missing = _MISSING_RANKS.search(text)
        if missing:
            ranks = sorted(int(r) for r in re.findall(r"\d+", missing.group(1)))
            detail += f"; peers that never arrived: {ranks}"
        if g is not None and g.run_dir:
            try:
                # a closed connection names no rank: the heartbeat plane
                # does, once the dead peer's record ages past the staleness
                # bound (waited for within what is left of the budget)
                stale = _stale_within(g, t0 + budget if not missing else t0)
                if stale:
                    detail += f"; heartbeat-stale peers: {stale}"
            except Exception:
                from .. import obs

                obs.swallowed_error("dist.timeout_diagnosis")
        waited = time.perf_counter() - t0
        _registry().counter(
            "photon_dist_collective_timeouts_total", "guarded collectives that hit the budget instead of hanging"
        ).labels(barrier=name).inc()
        raise DistributedTimeoutError(
            f"collective barrier {barrier_id!r} timed out after {waited:.1f}s "
            f"(budget {budget:.1f}s): a peer process never arrived{detail}"
        ) from e


def _stale_within(g: CollectiveGuard, deadline: float) -> List[int]:
    """The heartbeat-stale peers, polled until one shows or the
    ``perf_counter`` deadline passes (one look when it has)."""
    from ..parallel import multihost

    while True:
        stale = stale_peers(g.run_dir, _process_count(), g.stale_after_s, self_process=multihost.world_rank())
        if stale or time.perf_counter() >= deadline:
            return stale
        time.sleep(0.1)


def guard_collective(name: str) -> None:
    """The barrier before an object collective of ``parallel/multihost.py``:
    when every process reaches it within the budget, the collective that
    follows has all its participants. A no-op unless a budget is armed, and
    it never fires the fault site (the drill schedules kills at sweep
    boundaries, where the count is the sweep index)."""
    if _guard is None:
        return
    barrier_with_timeout(f"pre:{name}", fault_site=None)


def sweep_barrier(iteration: int) -> None:
    """The sweep-boundary rendezvous (``game/descent.py``): fires the
    ``dist.collective`` fault site once a sweep (the drill's schedule),
    then meets every process under the armed budget and records the
    peers' heartbeat ages (``photon_dist_heartbeat_age_seconds``). A no-op
    beyond the site when unarmed or with one process."""
    if _guard is None and _process_count() == 1:
        faults.check("dist.collective")
        return
    barrier_with_timeout(f"cd.sweep.{int(iteration)}")
    g = _guard
    if g is not None and g.run_dir:
        # every process passed: the peers' heartbeat ages into the gauge
        heartbeat_ages(g.run_dir)
