"""Sweep-level pipelining: the pipeline depth's plumbing and the eval lane.

The JAX package's ``game/pipeline.py`` on the port. The sweep has three
resource lanes, host staging and host-to-device copies, the solve, and
the validation evaluation, which the serial sweep runs strictly in order.
This module lets them overlap without changing a bit of the result:

- :func:`pipelined` / :func:`active_depth` / :func:`stage_anchor` carry the
  sweep's pipeline depth and anchor span down to the streaming layers
  (``fe_streaming`` / ``streaming``) through a contextvar. Depth 1, the
  default, is the serial loop; the streaming layers stage on a background
  thread (with its own copy stream) only at depth >= 2.
- :class:`EvalLane` runs the validation evaluations on one daemon worker in
  submit order, at most ``capacity`` snapshots in flight, so that
  coordinate k's evaluation overlaps coordinate k+1's solve. Results drain
  in FIFO order, the serial loop's order, which keeps the best-model
  choices and the evaluation ledger bitwise those of depth 1.

A JAX snapshot is immutable; a torch tensor is not. The lane is handed the
models dict of an accepted update, whose tensors nothing writes in place
afterwards (the solvers clone their start, every update makes new
tensors), so the snapshot is the dict alone. The worker binds the caller's
card (``device.pin_device``) and runs on the caller's CUDA stream, so its
kernels are ordered after the update that produced the snapshot, and the
caching allocator sees one stream: no ``record_stream`` is needed.

Worker-thread spans are parented on the sweep's anchor span (contextvar
ancestry does not cross threads), which keeps them outermost phase spans in
``obs.timeline``'s attribution.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
from typing import Callable, List, Optional, Tuple

import torch

from .. import obs
from ..device import DeviceLike, pin_device

_ctx: contextvars.ContextVar = contextvars.ContextVar("photon_torch_pipeline", default=None)


@contextlib.contextmanager
def pipelined(depth: int, anchor: Optional[obs.Span] = None):
    """Declare a pipelined region of ``depth`` (>= 1); streaming layers
    constructed inside pick the depth up via :func:`active_depth` and parent
    their worker-thread spans on ``anchor`` (normally the sweep span)."""
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1: {depth}")
    token = _ctx.set((int(depth), anchor))
    try:
        yield
    finally:
        _ctx.reset(token)


def active_depth() -> int:
    state = _ctx.get()
    return state[0] if state is not None else 1


def stage_anchor() -> Optional[obs.Span]:
    state = _ctx.get()
    return state[1] if state is not None else None


@contextlib.contextmanager
def closing(lane: Optional["EvalLane"]):
    """Close ``lane`` on exit (None is fine)."""
    try:
        yield lane
    finally:
        if lane is not None:
            lane.close()


class EvalLane:
    """Ordered background evaluation lane for the coordinate-descent sweep.

    One daemon worker runs ``fn(snapshot)`` per submitted task strictly in
    submit order; :meth:`submit` blocks while ``capacity`` results are
    unconsumed. The consumer drains ``(iteration, coordinate, result)``
    triples: :meth:`drain_ready` without blocking, :meth:`drain_all` before
    any point that must see the serial loop's state (checkpoint boundaries,
    the sweep's end). A worker exception is parked in order and re-raised
    at the drain that would have returned its result; the lane is then
    closed. ``device`` is the card the worker binds, with the caller's
    current stream on it (None or a CPU device binds nothing)."""

    def __init__(
        self,
        fn: Callable[[dict], object],
        capacity: int,
        anchor: Optional[obs.Span] = None,
        name: str = "photon-eval",
        device: DeviceLike = None,
    ):
        if capacity < 1:
            raise ValueError(f"eval lane capacity must be >= 1: {capacity}")
        self._fn = fn
        self._capacity = int(capacity)
        self._anchor = anchor
        self._device = None if device is None else pin_device(device)
        # the worker runs on the stream the caller's loop runs on
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.current_stream(self._device)
        self._tasks: collections.deque = collections.deque()
        # (iteration, coordinate, result, error) in submit order
        self._done: collections.deque = collections.deque()
        self._inflight = 0
        self._closed = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._work, name=name, daemon=True)
        self._thread.start()

    def _bound(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _work(self) -> None:
        with self._bound():
            while True:
                with self._cv:
                    while not self._tasks and not self._closed:
                        self._cv.wait()
                    if self._closed:
                        return
                    it, coord, snapshot = self._tasks.popleft()
                try:
                    with obs.span("cd.eval", parent=self._anchor, phase="eval", iteration=it, coordinate=coord):
                        result, error = self._fn(snapshot), None
                # photon: ignore[R4] — parked, re-raised at the matching drain
                except BaseException as e:
                    result, error = None, e
                with self._cv:
                    self._done.append((it, coord, result, error))
                    self._cv.notify_all()
                    if error is not None:
                        self._closed = True
                        return

    def submit(self, iteration: int, coordinate: str, snapshot: dict) -> None:
        """Queue ``fn(snapshot)``; blocks while ``capacity`` results are
        still unconsumed (submitted but not yet drained)."""
        with self._cv:
            while not self._closed and self._inflight - len(self._done) >= self._capacity:
                self._cv.wait()
            if self._closed and not self._done:
                raise RuntimeError("EvalLane is closed")
            self._inflight += 1
            self._tasks.append((iteration, coordinate, snapshot))
            self._cv.notify_all()

    def _pop_done(self) -> Tuple[int, str, object]:
        it, coord, result, error = self._done.popleft()
        self._inflight -= 1
        if error is not None:
            raise error
        return it, coord, result

    def drain_ready(self) -> List[Tuple[int, str, object]]:
        """Completed results so far, in submit order; never blocks."""
        out: List[Tuple[int, str, object]] = []
        with self._cv:
            while self._done:
                out.append(self._pop_done())
            self._cv.notify_all()
        return out

    def drain_all(self) -> List[Tuple[int, str, object]]:
        """Block until every submitted task has completed, then return all
        unconsumed results in submit order."""
        out: List[Tuple[int, str, object]] = []
        with self._cv:
            while self._inflight > 0:
                while not self._done:
                    if self._closed and self._inflight > len(self._done):
                        raise RuntimeError("EvalLane worker died")
                    self._cv.wait()
                out.append(self._pop_done())
            self._cv.notify_all()
        return out

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._tasks.clear()
            self._cv.notify_all()
