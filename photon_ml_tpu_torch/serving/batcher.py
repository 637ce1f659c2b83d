"""Request microbatching + deadline-budget admission control for the
resident scorer: the JAX package's ``serving/batcher.py`` on the port.

Concurrent callers submit single requests; one worker thread drains them
into batches under a max-latency / max-batch policy (the serving analogue of
Spark's partition batching): the first request in a batch waits at most
``max_latency_ms``, and a batch closes early at ``max_batch`` rows. Each
batch is scored by ONE engine reference captured at drain time — the
atomicity unit of a zero-downtime model flip: a refresh swaps the engine
*between* batches, so no batch can mix coefficients from two snapshots.

Past the saturation knee an unbounded queue converts overload into unbounded
tail latency for *everyone*; this batcher refuses instead of queueing:

- the pending queue is bounded (``max_pending``); a submit against a full
  queue is shed with reason ``queue_full``;
- each request may carry a deadline budget. Admission estimates the queue's
  drain time from a live service-rate EWMA (batch wall / batch rows, updated
  after every scored batch) and sheds immediately — reason ``deadline`` —
  when the request could not be scored inside its budget anyway;
- requests whose deadline expires *while queued* (the estimate is an
  estimate) are shed at drain time with reason ``expired``, before the
  engine ever sees them — never scored late, never silently dropped.

Every shed is a typed :class:`ShedError` (callers and the socket front can
tell refusal from failure) and a counted refusal in
``photon_serving_shed_total{model=,reason=}``; offered load lands in
``photon_serving_offered_total{model=}`` whether admitted or not, so
offered-vs-served-vs-shed rates are all derivable from one scrape.

A batcher is also the per-model **bulkhead** of the multi-model fleet
(``serving.fleet``): each resident model owns one batcher — its own worker
thread, pending bound, deadline budget, and service-rate EWMA — and every
serving metric this module records carries the batcher's ``model=`` label,
so a delay storm on one model sheds (and counts) against that model alone.
The chaos site follows the same keying: ``serving.score`` fires for every
batch on every model, and the dynamic per-model spelling
``serving.score.<model>`` lets a ``PHOTON_FAULTS`` storm target exactly one
model's batches (the isolation drill in ``tests/test_torch_serving_fleet.py``).

Every completed request lands in the obs layer:
``photon_serving_request_latency_seconds`` (histogram, enqueue->result),
``photon_serving_batch_size`` (histogram), ``photon_serving_requests_total``
and ``photon_serving_request_errors_total`` (counters), plus live
``photon_serving_queue_depth`` / ``photon_serving_drain_estimate_seconds``
gauges for the admission queue. The Prometheus exposition renders
p50/p95/p99 gauges for every histogram family.

On the card the worker thread launches the engine's kernels itself, on the
default stream: before each batch it makes the engine's device its own
current device (a CUDA device is per thread), so a worker never launches on
another card than the one its engine's tables live on.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import torch

from .. import obs
from ..robust import faults
from .engine import ScoreEngine, ScoreRequest

logger = logging.getLogger("photon_ml_tpu_torch")

# Serving latencies are sub-millisecond to tens of ms — the seconds-scale
# DEFAULT_BUCKETS would put every observation in the first bucket and make
# the quantile estimates useless.
SERVING_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 1.0, 5.0,
)

_SHED_HELP = "requests refused by admission control instead of queued to death"
_OFFERED_HELP = "requests offered to the batcher (admitted + shed)"


@dataclasses.dataclass
class RequestTrace:
    """Per-request trace context threaded through the batcher: the request's
    ``trace_id`` (assigned at socket accept, echoed on every response) and
    the root span the per-stage spans (``serving.admit`` /
    ``serving.batch`` / ``serving.score``) parent under. Free when no sink
    is listening — stage spans are only built for traced requests on an
    active run."""

    trace_id: str
    parent: Optional[obs.Span] = None


def _stage_span(
    trace: Optional[RequestTrace],
    name: str,
    start_perf: float,
    end_perf: float,
    **attrs,
) -> None:
    """Emit one per-stage span for a traced request; no-op untraced/passive."""
    if trace is None or not obs.active():
        return
    obs.record_span(
        name,
        start_perf,
        end_perf,
        parent=trace.parent,
        trace_id=trace.trace_id,
        **attrs,
    )


class ShedError(RuntimeError):
    """A request refused by admission control (reason: ``queue_full`` — the
    bounded pending queue was full; ``deadline`` — the drain-time estimate
    said the deadline budget could not be met; ``expired`` — the deadline
    passed while the request waited in the queue). A shed is a *refusal
    with a response*, distinct from an engine failure."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def _bind_device(engine) -> None:
    """Make ``engine``'s CUDA device the calling thread's current device."""
    dev = getattr(engine, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda" and dev.index is not None:
        if torch.cuda.current_device() != dev.index:
            torch.cuda.set_device(dev)


class MicroBatcher:
    """Queue + worker thread turning concurrent requests into engine calls,
    fronted by deadline-budget admission control (see module docstring)."""

    def __init__(
        self,
        engine_fn: Callable[[], ScoreEngine],
        max_batch: int = 256,
        max_latency_ms: float = 2.0,
        max_pending: int = 1024,
        ewma_alpha: float = 0.2,
        slow_request_ms: Optional[float] = None,
        model: str = "default",
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._engine_fn = engine_fn
        # bulkhead identity: the model= label on every metric below, and the
        # per-model chaos-site suffix (serving.score.<model>)
        self.model = str(model)
        self._model_site = f"serving.score.{self.model}"
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_ms) / 1e3
        self.max_pending = int(max_pending)
        self._ewma_alpha = float(ewma_alpha)
        # slow-request threshold (enqueue->scored); None disables the log
        # line + photon_serving_slow_requests_total counting
        self.slow_request_s = (
            None if slow_request_ms is None else float(slow_request_ms) / 1e3
        )
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = threading.Event()
        # one lock guards the admission state: pending count + service EWMA
        self._lock = threading.Lock()
        self._pending = 0
        self._ewma_per_req: Optional[float] = None
        self._worker = threading.Thread(
            target=self._run,
            name=f"photon-serving-batcher-{self.model}",
            daemon=True,
        )
        self._worker.start()

    # -- admission state ------------------------------------------------------

    def queue_stats(self) -> dict:
        """Live admission-queue view: pending requests, the service-rate
        EWMA (seconds per request), and the drain-time estimate a request
        admitted right now would wait behind."""
        with self._lock:
            pending, ewma = self._pending, self._ewma_per_req
        return {
            "pending": pending,
            "ewma_service_seconds": ewma,
            "drain_estimate_seconds": pending * ewma if ewma else 0.0,
        }

    def _publish_queue_gauges(self, reg) -> None:
        stats = self.queue_stats()
        reg.gauge(
            "photon_serving_queue_depth", "admission queue: pending requests"
        ).labels(model=self.model).set(stats["pending"])
        reg.gauge(
            "photon_serving_drain_estimate_seconds",
            "admission queue: estimated drain time from the service-rate EWMA",
        ).labels(model=self.model).set(stats["drain_estimate_seconds"])

    def _dec_pending(self, n: int) -> None:
        with self._lock:
            self._pending -= n

    # -- client side ---------------------------------------------------------

    def submit(
        self,
        request: ScoreRequest,
        deadline_s: Optional[float] = None,
        trace: Optional[RequestTrace] = None,
    ) -> Future:
        """Enqueue one request; the Future resolves to its float64 score.

        ``deadline_s`` is the request's latency budget in seconds from now.
        A request that the admission controller predicts cannot meet its
        budget (or that meets a full queue) raises :class:`ShedError`
        immediately; one whose deadline expires while queued gets the same
        error through its Future. ``trace`` (socket front) threads the
        request's trace_id through every stage: the admission decision,
        the queue wait, and the scored batch each land as a span parented
        under the request."""
        if self._closed.is_set():
            raise RuntimeError("MicroBatcher is closed")
        # photon: ignore[R7] — cross-thread enqueue stamp: the matching read
        # happens on the worker thread, so a span cannot bracket it
        now = time.perf_counter()
        deadline = None if deadline_s is None else now + float(deadline_s)
        reason = msg = None
        with self._lock:
            if self._pending >= self.max_pending:
                reason, msg = "queue_full", (
                    f"admission queue full ({self._pending} pending >= "
                    f"max_pending={self.max_pending})"
                )
            elif deadline is not None:
                # the new request drains behind everything pending plus its
                # own service time; no EWMA yet (cold server) admits
                drain = (self._pending + 1) * (self._ewma_per_req or 0.0)
                if now + drain > deadline:
                    reason, msg = "deadline", (
                        f"cannot meet deadline budget {deadline_s * 1e3:.1f}ms: "
                        f"estimated drain {drain * 1e3:.1f}ms behind "
                        f"{self._pending} pending requests"
                    )
            if reason is None:
                self._pending += 1
        reg = obs.current_run().registry
        reg.counter("photon_serving_offered_total", _OFFERED_HELP).labels(
            model=self.model
        ).inc()
        # photon: ignore[R7] — closes the admission-stage interval opened by
        # the enqueue stamp; lands on the span timeline via record_span (the
        # decision spans the lock, so no context manager can bracket it)
        admitted = time.perf_counter()
        _stage_span(
            trace, "serving.admit", now, admitted,
            outcome=reason or "admitted",
        )
        if reason is not None:
            reg.counter("photon_serving_shed_total", _SHED_HELP).labels(
                model=self.model, reason=reason
            ).inc()
            self._publish_queue_gauges(reg)
            raise ShedError(reason, msg)
        fut: Future = Future()
        self._q.put((request, now, deadline, fut, trace))
        self._publish_queue_gauges(reg)
        return fut

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._worker.join(timeout=timeout)

    # -- worker side ---------------------------------------------------------

    def _drain_batch(self) -> List[tuple]:
        """Block for a first request, then fill until max_batch or the first
        request's latency budget is spent."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = first[1] + self.max_latency_s
        while len(batch) < self.max_batch:
            # photon: ignore[R7] — deadline arithmetic against the enqueue
            # stamp, not a measured section
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not (self._closed.is_set() and self._q.empty()):
            batch = self._drain_batch()
            if not batch:
                continue
            reg = obs.current_run().registry
            # deadline check at the last moment before scoring: requests that
            # expired while queued are shed — a counted, typed response,
            # never a silent drop and never a wasted engine slot
            # photon: ignore[R7] — expiry check against the enqueue stamps
            now = time.perf_counter()
            live, expired = [], []
            for item in batch:
                _, t0, deadline, _, _ = item
                (expired if deadline is not None and now > deadline else live).append(item)
            if expired:
                reg.counter("photon_serving_shed_total", _SHED_HELP).labels(
                    model=self.model, reason="expired"
                ).inc(len(expired))
                for _, t0, _, fut, trace in expired:
                    _stage_span(
                        trace, "serving.batch", t0, now, outcome="expired"
                    )
                    fut.set_exception(
                        ShedError(
                            "expired",
                            f"deadline expired after {(now - t0) * 1e3:.1f}ms in queue",
                        )
                    )
                self._dec_pending(len(expired))
            if not live:
                self._publish_queue_gauges(reg)
                continue
            # ONE engine per batch: the flip atomicity unit (see module doc)
            engine = self._engine_fn()
            try:
                # the slow-engine chaos site: PHOTON_FAULTS
                # serving.score:delay50:... stalls here (exactly what a
                # degraded accelerator does), serving.score:io:... raises
                # into the counted error path below. The second, per-model
                # spelling keys a storm to ONE bulkhead: a
                # serving.score.<model>:delay spec stalls only that model's
                # batches — every other model's worker sails past it
                faults.check("serving.score")
                faults.check(self._model_site)
                _bind_device(engine)
                # photon: ignore[R7] — service-rate sample for the admission
                # EWMA; paired read below, crosses the engine call
                t_score = time.perf_counter()
                scores = engine.score_requests([b[0] for b in live])
            except Exception as exc:
                # the error propagates to every caller through its Future —
                # counted, not swallowed
                errors = reg.counter(
                    "photon_serving_request_errors_total",
                    "requests failed inside the score engine",
                ).labels(model=self.model)
                errors.inc(len(live))
                for _, t0, _, fut, trace in live:
                    _stage_span(
                        trace, "serving.batch", t0, now, outcome="error"
                    )
                    fut.set_exception(exc)
                self._dec_pending(len(live))
                self._publish_queue_gauges(reg)
                continue
            # photon: ignore[R7] — closes the cross-thread latency interval
            # opened at submit(); feeds the latency histogram directly
            done = time.perf_counter()
            per_req = (done - t_score) / len(live)
            with self._lock:
                self._ewma_per_req = (
                    per_req
                    if self._ewma_per_req is None
                    else self._ewma_alpha * per_req
                    + (1.0 - self._ewma_alpha) * self._ewma_per_req
                )
            lat = reg.histogram(
                "photon_serving_request_latency_seconds",
                "request latency, enqueue to scored",
                buckets=SERVING_LATENCY_BUCKETS,
            ).labels(model=self.model)
            n_slow = 0
            for i, (_, t0, _, fut, trace) in enumerate(live):
                fut.set_result(float(scores[i]))
                total_s = done - t0
                lat.observe(total_s)
                # per-stage spans for traced requests: queue wait + batch
                # formation (enqueue -> engine start), then the scored batch
                _stage_span(
                    trace, "serving.batch", t0, t_score, outcome="scored"
                )
                _stage_span(
                    trace, "serving.score", t_score, done, batch_size=len(live)
                )
                if (
                    self.slow_request_s is not None
                    and total_s > self.slow_request_s
                ):
                    n_slow += 1
                    logger.warning(
                        "slow request%s: %.1fms total "
                        "(queue+batch %.1fms, score %.1fms, batch=%d)",
                        f" trace_id={trace.trace_id}" if trace else "",
                        total_s * 1e3,
                        (t_score - t0) * 1e3,
                        (done - t_score) * 1e3,
                        len(live),
                    )
            if n_slow:
                reg.counter(
                    "photon_serving_slow_requests_total",
                    "completed requests slower than the slow-request threshold",
                ).labels(model=self.model).inc(n_slow)
            self._dec_pending(len(live))
            reg.counter(
                "photon_serving_requests_total", "requests scored"
            ).labels(model=self.model).inc(len(live))
            reg.histogram(
                "photon_serving_batch_size",
                "rows per scored microbatch",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
            ).labels(model=self.model).observe(len(live))
            self._publish_queue_gauges(reg)
