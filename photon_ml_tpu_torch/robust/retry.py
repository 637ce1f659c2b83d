"""Bounded, seeded retry with exponential backoff + jitter.

The Spark reference gets task-level retry from its scheduler (four attempts
per task by default); a transient NFS hiccup re-runs the task and the job
never notices. Here every Avro read, index-map load, and model / checkpoint
write is one syscall failure away from discarding hours of training. This
module is the port of that scheduler behavior to library form: wrap the IO
call in a :class:`RetryPolicy` and transient failures are retried with
exponential backoff, while exhausted budgets re-raise the ORIGINAL error
(never a wrapper — callers' except clauses and tests keep matching).

Properties the tests pin down:

- bounded: at most ``max_attempts`` calls, then the last exception re-raises;
- classified: only ``retryable`` exception types retry — everything else
  (including :class:`robust.faults.SimulatedKill`, a BaseException)
  propagates immediately;
- seeded: jitter comes from ``random.Random(seed)``, so backoff schedules
  are reproducible in tests and across resumed runs;
- observable: every retried failure increments
  ``photon_retry_attempts_total{site=}`` in the current obs registry, so a
  flaky filesystem shows up in run_summary.json instead of only in latency.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, List, Tuple, Type

logger = logging.getLogger("photon_ml_tpu_torch")


def _count_retry(site: str, delay: float) -> None:
    # lazy import: obs's sinks import robust.atomic, so robust imports obs
    # at call time
    from .. import obs

    reg = obs.current_run().registry
    reg.counter(
        "photon_retry_attempts_total",
        "IO attempts that failed and were retried, by site",
    ).labels(site=site).inc()
    reg.histogram(
        "photon_retry_backoff_seconds",
        "backoff slept before an IO retry, by site",
    ).labels(site=site).observe(delay)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay ``base_delay * multiplier**k``, capped at
    ``max_delay``, each delay jittered uniformly in ``[1-jitter, 1+jitter]``
    by a generator seeded per :meth:`call` (deterministic schedules)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    retryable: Tuple[Type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1]: {self.jitter}")

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def delays(self) -> List[float]:
        """The jittered sleep schedule between attempts (len max_attempts-1)."""
        rng = random.Random(self.seed)
        out = []
        for k in range(self.max_attempts - 1):
            d = min(self.base_delay * self.multiplier**k, self.max_delay)
            out.append(d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
        return out

    def call(
        self,
        fn: Callable,
        *args,
        site: str = "unlabeled",
        sleep: Callable[[float], None] = time.sleep,
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)`` under this policy. Retries only
        classified-retryable exceptions; after ``max_attempts`` failures the
        original (last) exception re-raises unchanged."""
        delays = self.delays()
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                if attempt == self.max_attempts - 1:
                    raise
                _count_retry(site, delays[attempt])
                logger.warning(
                    "retryable failure at %s (attempt %d/%d): %s; retrying "
                    "in %.3fs",
                    site, attempt + 1, self.max_attempts, e, delays[attempt],
                )
                sleep(delays[attempt])
        raise AssertionError("unreachable")  # pragma: no cover

    def wrap(self, site: str, sleep: Callable[[float], None] = time.sleep):
        """Decorator form: ``@policy.wrap("io.avro_read")``."""

        def deco(fn):
            def inner(*args, **kwargs):
                return self.call(fn, *args, site=site, sleep=sleep, **kwargs)

            inner.__name__ = getattr(fn, "__name__", "wrapped")
            inner.__doc__ = fn.__doc__
            return inner

        return deco


# The shared default for library IO sites. Module-level so the CLI (or a
# test) can swap one policy for every site at once; sites that need a
# different budget construct their own.
DEFAULT_IO_POLICY = RetryPolicy()


def io_call(fn: Callable, *args, site: str, **kwargs):
    """``DEFAULT_IO_POLICY.call`` with the fault-injection hook folded in:
    the injector fires BEFORE the real call, so an injected transient error
    exercises the same retry path a real one would."""
    from . import faults

    def attempt():
        faults.check(site)
        return fn(*args, **kwargs)

    return DEFAULT_IO_POLICY.call(attempt, site=site)
