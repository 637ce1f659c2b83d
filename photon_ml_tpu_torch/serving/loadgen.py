"""Open-loop load generation for the resident scorer (the JAX package's
``serving/loadgen.py``, copied: numpy and the standard library only).

A closed-loop client (send, wait, send) can never measure overload: each
client caps its own in-flight work at 1, so offered load collapses to served
load and queueing delay hides inside the think time — the *coordinated
omission* artifact. This module drives the server the way production
traffic does: arrivals are a seeded Poisson process at a target offered
QPS, sent on schedule whether or not earlier requests have returned, and
every latency is measured from the request's **intended** send time — if
the dispatcher (or the server's queue) falls behind, the backlog shows up
in the numbers instead of silently stretching the arrival schedule.

The pure-math core is separated from the wall clock so the accounting
itself is unit-testable:

- :func:`poisson_intended_times` — the seeded arrival schedule;
- :func:`simulate_fifo_open_loop` / :func:`simulate_fifo_closed_loop` —
  the same FIFO server measured both ways, proving where closed-loop
  measurement hides queueing delay (pinned in ``tests/test_torch_overload.py``);
- :func:`run_open_loop` — drive a real ``submit`` callable (a
  ``ScoringServer`` / ``MicroBatcher``) at one offered QPS;
- :func:`find_knee` — locate the saturation knee in a sweep: the highest
  offered load the server still serves (served >= ``served_fraction`` x
  offered).

``chip_smoke.py --only serving`` sweeps offered load on the card through
this module and reports the knee.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .batcher import ShedError


def _now() -> float:
    # photon: ignore[R7] — the load generator's one clock read: intended-
    # send-time arithmetic and cross-thread completion stamps, not a
    # measured section a span could bracket
    return time.perf_counter()


# -- pure math ---------------------------------------------------------------


def poisson_intended_times(
    offered_qps: float, duration_s: float, seed: int = 0
) -> np.ndarray:
    """Intended send offsets (seconds from epoch start) of a Poisson arrival
    process at ``offered_qps`` over ``duration_s`` — exponential
    inter-arrivals, seeded, so a given (qps, duration, seed) always yields
    the same schedule."""
    if offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0: {offered_qps}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0: {duration_s}")
    rng = np.random.default_rng(seed)
    # draw in chunks until the schedule passes duration_s
    out: List[np.ndarray] = []
    t = 0.0
    chunk = max(16, int(offered_qps * duration_s * 1.2))
    while t <= duration_s:
        gaps = rng.exponential(1.0 / offered_qps, size=chunk)
        times = t + np.cumsum(gaps)
        out.append(times)
        t = float(times[-1])
    times = np.concatenate(out)
    return times[times <= duration_s]


def simulate_fifo_open_loop(
    intended: Sequence[float], service_s: Sequence[float]
) -> List[float]:
    """Latencies through a single FIFO server, measured from each request's
    INTENDED send time: request k begins when both it has arrived and the
    server is free, so a stall's backlog lands on every request scheduled
    during it. This is the accounting :func:`run_open_loop` implements
    against a real server."""
    free_at = 0.0
    out: List[float] = []
    for a, s in zip(intended, service_s):
        begin = max(float(a), free_at)
        free_at = begin + float(s)
        out.append(free_at - float(a))
    return out


def simulate_fifo_closed_loop(service_s: Sequence[float]) -> List[float]:
    """What a closed-loop client measures on the same server: it sends the
    next request only after the previous response, so the server is always
    free at send time and the measured latency is exactly the service time.
    A 1-second stall appears in ONE sample instead of delaying every
    request scheduled during it — coordinated omission."""
    return [float(s) for s in service_s]


# -- one open-loop step against a real server --------------------------------


@dataclasses.dataclass
class OpenLoopResult:
    """One offered-QPS step. Latency quantiles are over *admitted completed*
    requests, measured from intended send time; ``sent`` counts every
    dispatch attempt, so ``sent == completed + shed_admission +
    shed_expired + errors`` (no request unaccounted for)."""

    offered_qps: float
    duration_s: float
    sent: int
    completed: int
    shed_admission: Dict[str, int]
    shed_expired: int
    errors: int
    served_qps: float
    achieved_offered_qps: float
    latency_mean_s: float
    latency_p50_s: float
    latency_p99_s: float

    @property
    def shed_total(self) -> int:
        return sum(self.shed_admission.values()) + self.shed_expired

    @property
    def served_fraction(self) -> float:
        return self.completed / max(self.sent, 1)


def run_open_loop(
    submit: Callable[..., object],
    requests: Sequence[object],
    offered_qps: float,
    duration_s: float,
    seed: int = 0,
    deadline_s: Optional[float] = None,
    drain_timeout_s: float = 30.0,
) -> OpenLoopResult:
    """Drive ``submit(request[, deadline_s])`` at ``offered_qps`` Poisson
    arrivals for ``duration_s``; requests cycle through ``requests``.

    The dispatcher sends on the intended schedule even when it is running
    late (late dispatch is *measured* as latency, never dropped from the
    schedule), admission refusals (:class:`ShedError` from ``submit``) are
    counted, and in-queue expiries / engine errors are collected from the
    returned futures. Returns after every dispatched request has a
    response or ``drain_timeout_s`` passes."""
    times = poisson_intended_times(offered_qps, duration_s, seed=seed)
    lock = threading.Lock()
    latencies: List[float] = []
    shed_admission: Dict[str, int] = {}
    shed_expired = 0
    errors = 0
    futures = []

    def _complete(fut, intended_at: float) -> None:
        nonlocal shed_expired, errors
        done = _now()
        exc = fut.exception()
        with lock:
            if exc is None:
                latencies.append(done - intended_at)
            elif isinstance(exc, ShedError):
                shed_expired += 1
            else:
                errors += 1

    t_start = _now()
    for k, offset in enumerate(times):
        intended = t_start + float(offset)
        while True:
            delta = intended - _now()
            if delta <= 0:
                break
            time.sleep(min(delta, 0.001))
        req = requests[k % len(requests)]
        try:
            fut = submit(req) if deadline_s is None else submit(req, deadline_s)
        except ShedError as exc:
            with lock:
                shed_admission[exc.reason] = shed_admission.get(exc.reason, 0) + 1
            continue
        futures.append(fut)
        fut.add_done_callback(lambda f, t=intended: _complete(f, t))
    futures_wait(futures, timeout=drain_timeout_s)
    t_end = _now()

    with lock:
        lats = np.asarray(latencies, dtype=np.float64)
        shed_adm = dict(shed_admission)
        n_expired, n_errors = shed_expired, errors
    wall = max(t_end - t_start, 1e-9)
    return OpenLoopResult(
        offered_qps=float(offered_qps),
        duration_s=float(duration_s),
        sent=len(times),
        completed=int(lats.size),
        shed_admission=shed_adm,
        shed_expired=n_expired,
        errors=n_errors,
        served_qps=float(lats.size / wall),
        achieved_offered_qps=float(len(times) / wall),
        latency_mean_s=float(lats.mean()) if lats.size else 0.0,
        latency_p50_s=float(np.percentile(lats, 50)) if lats.size else 0.0,
        latency_p99_s=float(np.percentile(lats, 99)) if lats.size else 0.0,
    )


# -- mixed multi-stream load (the bulkhead isolation drill) ------------------


def run_mixed_open_loop(
    submit: Callable[..., object],
    streams: Dict[str, dict],
    duration_s: float,
    seed: int = 0,
    drain_timeout_s: float = 30.0,
) -> Dict[str, OpenLoopResult]:
    """Drive several open-loop streams *concurrently* against one ``submit``
    — the multi-model isolation drill: a storm stream hammering one model
    must not move a victim stream's latency, because each model sits behind
    its own bulkhead (see ``serving.fleet``).

    ``streams`` maps a stream name to ``{"requests": [...], "offered_qps":
    q}`` (optional ``"deadline_s"``); each stream's requests should already
    carry the routing they need (e.g. ``ScoreRequest.model``). Each stream
    gets its own dispatcher thread and a seed derived from its (sorted)
    position, so the per-stream accounting invariant — ``sent == completed
    + shed + errors`` — holds independently per stream."""
    results: Dict[str, OpenLoopResult] = {}
    failures: Dict[str, BaseException] = {}

    def _run(name: str, spec: dict, stream_seed: int) -> None:
        try:
            results[name] = run_open_loop(
                submit,
                spec["requests"],
                spec["offered_qps"],
                duration_s,
                seed=stream_seed,
                deadline_s=spec.get("deadline_s"),
                drain_timeout_s=drain_timeout_s,
            )
        except BaseException as exc:  # photon: ignore[R4] — parked, re-raised by the caller after join
            failures[name] = exc

    threads = [
        threading.Thread(
            target=_run,
            args=(name, streams[name], seed + i),
            name=f"photon-loadgen-{name}",
        )
        for i, name in enumerate(sorted(streams))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        name, exc = sorted(failures.items())[0]
        raise RuntimeError(f"mixed load stream {name!r} failed: {exc!r}") from exc
    return results


# -- sweep + knee ------------------------------------------------------------


def sweep_open_loop(
    submit: Callable[..., object],
    requests: Sequence[object],
    qps_steps: Sequence[float],
    duration_s: float,
    seed: int = 0,
    deadline_s: Optional[float] = None,
) -> List[OpenLoopResult]:
    """One :func:`run_open_loop` step per offered QPS, ascending, each with
    a distinct derived seed so schedules are independent."""
    return [
        run_open_loop(
            submit,
            requests,
            qps,
            duration_s,
            seed=seed + i,
            deadline_s=deadline_s,
        )
        for i, qps in enumerate(sorted(qps_steps))
    ]


def find_knee(
    steps: Sequence[OpenLoopResult], served_fraction: float = 0.9
) -> Optional[OpenLoopResult]:
    """The saturation knee of a sweep: the highest offered-QPS step whose
    served throughput still tracks offered load (served_qps >=
    ``served_fraction`` x offered_qps). Returns None when even the lightest
    step is past saturation."""
    knee = None
    for s in sorted(steps, key=lambda s: s.offered_qps):
        if s.served_qps >= served_fraction * s.offered_qps:
            knee = s
    return knee
