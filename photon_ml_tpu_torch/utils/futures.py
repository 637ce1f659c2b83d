"""Daemon-thread futures, worker pools, and bounded prefetch queues.

The JAX package's ``utils/futures.py``, copied: the chunked ingest reader
(``io/data.py``) decodes part files through a :class:`PrefetchQueue`, a
bounded-depth producer lane over an N-worker :class:`WorkerPool`.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional, Tuple


class DaemonFuture:
    """Future-shaped handle on a fn run in a DAEMON thread.

    Replaces ThreadPoolExecutor for background decodes: executor threads are
    non-daemon and concurrent.futures joins them at interpreter exit, so a
    training crash mid-decode used to block process exit on a full decode
    nobody will consume. A daemon thread is abandoned at exit — a crash
    anywhere exits bounded. The flip side: "cancellation" is only ever
    not-waiting; work that already STARTED runs to completion in the
    background (the thread starts on construction, so a live decode is never
    killed, merely never joined)."""

    def __init__(self, fn):
        self._done = threading.Event()
        # ownership handoff at the _done barrier: _work (the daemon thread)
        # is the only writer, and result() reads only after _done.wait()
        self._value = None  # photon: thread-confined
        self._error = None  # photon: thread-confined

        def _work():
            try:
                self._value = fn()
            # photon: ignore[R4] — future semantics: stored, re-raised in result()
            except BaseException as e:
                self._error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(
            target=_work, name="photon-bg-decode", daemon=True
        )
        self._thread.start()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("background work still running")
        if self._error is not None:
            raise self._error
        return self._value


class PoolFuture:
    """Future-shaped handle on a fn submitted to a :class:`WorkerPool`.

    Same ``done()``/``result()`` surface as :class:`DaemonFuture` so callers
    holding either kind (cli/train's validation decode) stay agnostic. The
    fn runs on a pool worker instead of a dedicated thread; the crash
    contract is the pool's (daemon workers, never joined)."""

    def __init__(self):
        self._done = threading.Event()
        self._value = None
        self._error = None

    def _run(self, fn) -> None:
        try:
            self._value = fn()
        # photon: ignore[R4] — future semantics: stored, re-raised in result()
        except BaseException as e:
            self._error = e
        finally:
            self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("background work still running")
        if self._error is not None:
            raise self._error
        return self._value


class WorkerPool:
    """``workers`` daemon threads draining a FIFO task deque.

    The fleet-decode analogue of :class:`DaemonFuture`: submissions run in
    submit order (exactly sequential at ``workers=1``), each behind a
    :class:`PoolFuture`. Same crash contract — workers are daemon threads
    that are never joined, so a process crash abandons in-flight work
    instead of blocking exit on it.

    :meth:`close` stops accepting NEW submissions but lets already-queued
    tasks drain: a caller may submit background work and close the pool
    immediately, keeping the handle alive only through the future."""

    def __init__(self, workers: int = 1, name: str = "photon-pool"):
        if workers < 1:
            raise ValueError(f"worker pool size must be >= 1: {workers}")
        self.workers = int(workers)
        self._tasks: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        for k in range(self.workers):
            threading.Thread(
                target=self._work, name=f"{name}-{k}", daemon=True
            ).start()

    def submit(self, fn: Callable[[], object]) -> PoolFuture:
        fut = PoolFuture()
        with self._cv:
            if self._closed:
                raise RuntimeError("WorkerPool is closed")
            self._tasks.append((fn, fut))
            self._cv.notify()
        return fut

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._tasks:
                    if self._closed:
                        return
                    self._cv.wait()
                fn, fut = self._tasks.popleft()
            fut._run(fn)

    def close(self) -> None:
        """Stop accepting work; queued tasks still drain (daemon threads,
        never joined — in-flight work is abandoned at process exit)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class PrefetchQueue:
    """Bounded-depth generalization of :class:`DaemonFuture`'s one-item
    lookahead: ``workers`` pool workers produce ``produce(i)`` for
    ``i in 0..count-1`` (forever, cyclically, when ``cyclic=True``)
    concurrently, a sequencer re-emits finished items in production order,
    and :meth:`get` pops them FIFO. ``workers=1`` (the default) calls
    ``produce`` strictly sequentially in index order — behaviorally
    identical to the original single-daemon-worker queue.

    ``cost``/``budget`` bound the bytes in flight across the WHOLE pipeline:
    queued items, PLUS the item the consumer currently holds, PLUS every
    item any worker is currently producing. An item's cost is charged when
    its index is claimed (before ``produce`` starts) and released when the
    consumer moves past it, so N workers cannot collectively overshoot a
    bounded-RSS cap by starting N decodes at once. An empty pipeline always
    admits one item so progress is possible — the same 2-resident worst
    case (held + one in flight) as the inline double buffer this replaces.
    ``budget_stalls`` counts admissions deferred by the budget;
    ``peak_inflight`` is the high-water mark of charged bytes.

    Depth bounds the pipeline the same way: queued + staged + producing
    items never exceed ``depth``.

    Same crash contract as DaemonFuture: workers are daemon threads, an
    in-flight ``produce`` runs to completion but is never joined
    (:meth:`close` drops queued items without waiting), and a producer
    error is re-emitted in production order and re-raised by the matching
    :meth:`get` — items produced after the failing index are discarded,
    never emitted out of order."""

    def __init__(
        self,
        produce: Callable[[int], object],
        count: int,
        depth: int = 2,
        *,
        cyclic: bool = False,
        cost: Optional[Callable[[int], int]] = None,
        budget: Optional[int] = None,
        name: str = "photon-prefetch",
        workers: int = 1,
        pool: Optional[WorkerPool] = None,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1: {depth}")
        if count < 1:
            raise ValueError(f"prefetch count must be >= 1: {count}")
        if workers < 1:
            raise ValueError(f"prefetch workers must be >= 1: {workers}")
        self._produce = produce
        self._count = int(count)
        self._depth = int(depth)
        self._cyclic = bool(cyclic)
        self._cost = cost
        self._budget = budget
        # (index, item, cost, error) in production order, ready for get()
        self._q: collections.deque = collections.deque()
        # finished out of order: global claim -> (index, item, cost, error)
        self._staging: dict = {}
        self._next = 0  # next global claim (produce index = claim % count)
        self._emit = 0  # next claim the sequencer re-emits into _q
        self._n_producing = 0
        self._outstanding = 0  # dispatched pool tasks that have not claimed yet
        self._held_cost = 0  # the item the consumer holds still occupies RSS
        self._inflight = 0  # queued + staged + producing + held cost
        self.peak_inflight = 0
        self.budget_stalls = 0
        self._closed = False
        self._exhausted = False
        self._draining = False  # an error is staged: stop claiming/emitting
        self._cv = threading.Condition()
        self._own_pool = pool is None
        self._pool = WorkerPool(workers, name=name) if pool is None else pool
        with self._cv:
            self._dispatch()

    def _claim(self) -> Optional[Tuple[int, int, int]]:
        """Claim the next produce index (under the lock, at task execution
        time) or return None when nothing is admissible — the task then
        no-ops and :meth:`get` re-dispatches when capacity frees up."""
        if self._closed or self._draining:
            return None
        if not self._cyclic and self._next >= self._count:
            return None
        idx = self._next % self._count if self._cyclic else self._next
        pipeline = len(self._q) + len(self._staging) + self._n_producing
        if pipeline >= self._depth:
            return None
        c = int(self._cost(idx)) if self._cost is not None else 0
        if self._budget is not None and pipeline > 0:
            if self._inflight + c > self._budget:
                self.budget_stalls += 1
                return None
        g = self._next
        self._next += 1
        self._n_producing += 1
        self._inflight += c
        self.peak_inflight = max(self.peak_inflight, self._inflight)
        return g, idx, c

    def _sequence(self) -> None:
        """Move contiguously-finished staged items into the FIFO (under the
        lock); stop at an error so it re-raises in production order."""
        while not self._draining and self._emit in self._staging:
            idx, item, c, error = self._staging.pop(self._emit)
            self._q.append((idx, item, c, error))
            self._emit += 1
            if error is not None:
                self._draining = True
        if not self._cyclic and not self._draining and self._emit >= self._count:
            self._exhausted = True

    def _dispatch(self) -> None:
        """Top up outstanding pool tasks to cover free pipeline slots (under
        the lock). Over-dispatch is harmless: a task that finds no
        admissible claim simply no-ops."""
        if self._closed or self._draining or self._exhausted:
            return
        pipeline = len(self._q) + len(self._staging) + self._n_producing
        want = self._depth - pipeline - self._outstanding
        if not self._cyclic:
            want = min(want, self._count - self._next - self._outstanding)
        for _ in range(want):
            self._outstanding += 1
            self._pool.submit(self._task)

    def _task(self) -> None:
        with self._cv:
            self._outstanding -= 1
            claim = self._claim()
            if claim is None:
                return
            g, idx, c = claim
        try:
            item, error = self._produce(idx), None
        # photon: ignore[R4] — future semantics: parked, re-raised in get()
        except BaseException as e:
            item, error = None, e
        with self._cv:
            self._n_producing -= 1
            if self._closed:
                return  # close() already reset the accounting; discard
            self._staging[g] = (idx, item, c, error)
            self._sequence()
            self._cv.notify_all()

    def get(self) -> Tuple[int, object]:
        """Pop the next item in production order (blocks until staged);
        implicitly releases the previously returned item's budget share."""
        with self._cv:
            while not self._q:
                if self._closed:
                    raise RuntimeError("PrefetchQueue is closed")
                if self._exhausted:
                    raise RuntimeError("PrefetchQueue is exhausted")
                self._dispatch()
                self._cv.wait()
            idx, item, c, error = self._q.popleft()
            self._inflight -= self._held_cost
            self._held_cost = c
            self._dispatch()
            self._cv.notify_all()
        if error is not None:
            self.close()
            raise error
        return idx, item

    def qsize(self) -> int:
        with self._cv:
            return len(self._q)

    def close(self) -> None:
        """Stop the workers and drop queued items; an in-flight ``produce``
        runs to completion in the background (never joined)."""
        with self._cv:
            self._closed = True
            self._q.clear()
            self._staging.clear()
            self._inflight = self._held_cost
            self._cv.notify_all()
        if self._own_pool:
            self._pool.close()
