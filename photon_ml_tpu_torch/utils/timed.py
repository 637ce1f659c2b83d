"""Named wall-clock sections (reference: photon-lib .../util/Timed.scala:33-83,
used at every driver/estimator stage).

The JAX package's ``utils/timed.py``: ``timed`` logs the section's wall time
and opens an ``obs`` span of the same name, so every timed section nests in
the run's span tree and reaches its sinks. With no sink registered the span
is host bookkeeping only. The host clock does not wait for the card: a
section that must include its device work ends in a fetch or a synchronize.
"""

from __future__ import annotations

import contextlib
import logging
import time

from ..obs.tracing import span

logger = logging.getLogger("photon_ml_tpu_torch")


@contextlib.contextmanager
def timed(name: str, level: int = logging.DEBUG, **attrs):
    """Log the section's wall time; extra kwargs become span attributes
    (e.g. ``phase=``)."""
    t0 = time.perf_counter()
    try:
        with span(name, **attrs):
            yield
    finally:
        logger.log(level, "%s took %.3fs", name, time.perf_counter() - t0)
