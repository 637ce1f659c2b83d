"""Sweep timeline profiler: Chrome-trace export and per-sweep phase attribution.

The JAX package's ``obs/timeline.py`` on the port, copied.

``TimelineRecorder`` is an :class:`~photon_ml_tpu_torch.utils.events.EventListener`
that collects every closed span of a run and answers two questions the
counters alone cannot:

- *what does the run look like over time* — ``chrome_trace()`` renders the
  span tree as Chrome-trace / Perfetto JSON (one "X" complete event per span,
  lanes keyed by process index and OS thread), loadable at ui.perfetto.dev;
- *what serialized against what inside a sweep* — ``phase_attribution()``
  splits each ``cd.sweep``'s wall time across phase-tagged descendants
  (stage / solve / score / eval / checkpoint, per coordinate) and reports an
  overlap factor ``1 - critical_path / sum_of_phases``. A fully serial sweep
  scores 0; sweep pipelining must move this number.

Spans close on the host clock, which does not wait for the card: a phase is
charged the card's work that the host waits for while that phase's span is
open, not the work it launched.

Spans close children-before-parents (context managers unwind inside-out), so
once a ``cd.sweep`` span arrives every descendant is already recorded.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from ..utils.events import EventListener
from .tracing import Span, SpanEvent

# Span names whose closure marks one complete coordinate-descent sweep.
SWEEP_SPAN_NAME = "cd.sweep"

# Attribute key that tags a span as belonging to a pipeline phase.
PHASE_ATTR = "phase"


def _start(s: Span) -> float:
    """Monotonic start when available (same clock as duration_s); spans built
    by hand (tests, replay) may only carry start_unix."""
    return s.start_perf if s.start_perf else s.start_unix


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    total += cur_end - cur_start
    return total


def interval_overlap_seconds(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    """Seconds where the union of ``a`` and the union of ``b`` coincide
    (inclusion-exclusion over the interval unions)."""
    return max(0.0, _union_seconds(a) + _union_seconds(b) - _union_seconds(a + b))


def overlap_ratio(
    stage: List[Tuple[float, float]], compute: List[Tuple[float, float]]
) -> float:
    """Fraction of staging wall time spent concurrently with compute/collect
    work: ``overlap(stage, compute) / union(stage)``. A serial loop (stage,
    then compute, never both) scores 0; a perfectly hidden stage scores 1.
    The JAX package's streamed-overlap gauge reads it."""
    stage_union = _union_seconds(stage)
    if stage_union <= 0.0:
        return 0.0
    return interval_overlap_seconds(stage, compute) / stage_union


class TimelineRecorder(EventListener):
    """Collects closed spans; thread-safe (sinks can run on any thread)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    def handle(self, event) -> None:
        if isinstance(event, SpanEvent):
            with self._lock:
                self._spans.append(event.span)

    def close(self) -> None:  # nothing buffered externally
        pass

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    # -- Chrome-trace export ---------------------------------------------------

    def chrome_trace(self) -> dict:
        """Render as a Chrome-trace JSON object (Perfetto-loadable).

        One "X" (complete) event per span: ``ts``/``dur`` in microseconds,
        ``pid`` = process index, ``tid`` = OS thread id, span identity and
        attrs under ``args``. "M" metadata events name the lanes.
        """
        spans = self.spans()
        events: List[dict] = []
        lanes: Dict[Tuple[int, int], str] = {}
        for s in spans:
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": _start(s) * 1e6,
                    "dur": (s.duration_s or 0.0) * 1e6,
                    "pid": s.process_index,
                    "tid": s.thread_id,
                    "cat": "photon",
                    "args": {
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        **{k: _jsonable(v) for k, v in s.attrs.items()},
                    },
                }
            )
            lanes.setdefault((s.process_index, s.thread_id), s.thread_name)
        events.sort(key=lambda e: e["ts"])
        # wall-clock alignment for cross-process stitching (obs.fleet):
        # per-process ts comes from perf_counter, whose origin differs per
        # process; exporting unix-minus-perf lets a stitcher rebase every
        # process's events onto the one shared wall clock
        offsets = [
            s.start_unix - s.start_perf
            for s in spans
            if s.start_perf and s.start_unix
        ]
        other = {}
        if offsets:
            other["unix_minus_perf_s"] = max(offsets)
        meta: List[dict] = []
        for (pid, tid), tname in sorted(lanes.items()):
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": f"photon process {pid}"},
                }
            )
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname or f"thread {tid}"},
                }
            )
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if other:
            doc["otherData"] = other
        return doc

    def write_chrome_trace(self, path: str) -> None:
        from ..robust.atomic import atomic_write_json

        atomic_write_json(path, self.chrome_trace(), default=str)

    # -- phase attribution -----------------------------------------------------

    def phase_attribution(self) -> dict:
        """Per-sweep wall-time split across phase-tagged spans.

        For each ``cd.sweep`` span, its phase-tagged descendants are clipped
        to the sweep window and reduced to::

            wall_seconds         sweep span duration
            phases               {phase: summed clipped seconds}
            coordinates          {coordinate: {phase: seconds}}
            nested_phases        {phase: seconds} for phase spans inside
                                 another phase span (fe_stream.stage inside
                                 the solve — already inside solve wall time)
            critical_path_seconds  length of the union of phase intervals
            other_seconds        wall - critical_path (un-attributed time)
            sum_of_phases_seconds
            overlap_factor       1 - critical_path / sum_of_phases

        Only OUTERMOST phase spans feed ``phases`` and the overlap math — a
        phase span nested inside another phase span (staging dispatched from
        within a solve) is wall time its ancestor already owns, so it lands
        in ``nested_phases`` instead of double-counting. With that rule,
        ``critical_path + other == wall`` holds exactly by construction, a
        fully serial sweep scores ``overlap_factor`` 0, and the factor rises
        only with genuine wall-clock overlap between phases — the number sweep
        pipelining must raise.
        """
        spans = self.spans()
        by_id = {s.span_id: s for s in spans}
        sweeps = [s for s in spans if s.name == SWEEP_SPAN_NAME]

        def sweep_ancestor(s: Span) -> Optional[Span]:
            seen = set()
            cur = s.parent_id
            while cur is not None and cur not in seen:
                seen.add(cur)
                parent = by_id.get(cur)
                if parent is None:
                    return None
                if parent.name == SWEEP_SPAN_NAME:
                    return parent
                cur = parent.parent_id
            return None

        def has_phased_ancestor_below(s: Span, sweep: Span) -> bool:
            cur = s.parent_id
            while cur is not None:
                parent = by_id.get(cur)
                if parent is None or parent is sweep:
                    return False
                if parent.attrs.get(PHASE_ATTR):
                    return True
                cur = parent.parent_id
            return False

        per_sweep: List[dict] = []
        for sweep in sweeps:
            wall = float(sweep.duration_s or 0.0)
            lo = _start(sweep)
            hi = lo + wall
            phases: Dict[str, float] = {}
            nested: Dict[str, float] = {}
            coords: Dict[str, Dict[str, float]] = {}
            intervals: List[Tuple[float, float]] = []
            for s in spans:
                phase = s.attrs.get(PHASE_ATTR)
                if not phase or s.duration_s is None:
                    continue
                if sweep_ancestor(s) is not sweep:
                    continue
                start = max(lo, _start(s))
                end = min(hi, _start(s) + s.duration_s)
                if end <= start:
                    continue
                dur = end - start
                phase = str(phase)
                if has_phased_ancestor_below(s, sweep):
                    nested[phase] = nested.get(phase, 0.0) + dur
                    continue
                phases[phase] = phases.get(phase, 0.0) + dur
                coord = s.attrs.get("coordinate")
                if coord is not None:
                    cp = coords.setdefault(str(coord), {})
                    cp[phase] = cp.get(phase, 0.0) + dur
                intervals.append((start, end))
            union = _union_seconds(intervals)
            union = min(union, wall)  # guard float noise at the clip edges
            total = sum(phases.values())
            per_sweep.append(
                {
                    "iteration": sweep.attrs.get("iteration"),
                    "wall_seconds": wall,
                    "phases": phases,
                    "nested_phases": nested,
                    "coordinates": coords,
                    "critical_path_seconds": union,
                    "other_seconds": wall - union,
                    "sum_of_phases_seconds": total,
                    "overlap_factor": (1.0 - union / total) if total > 0 else 0.0,
                }
            )

        agg_phases: Dict[str, float] = {}
        agg_wall = agg_union = agg_total = 0.0
        for rec in per_sweep:
            agg_wall += rec["wall_seconds"]
            agg_union += rec["critical_path_seconds"]
            agg_total += rec["sum_of_phases_seconds"]
            for phase, secs in rec["phases"].items():
                agg_phases[phase] = agg_phases.get(phase, 0.0) + secs
        return {
            "n_sweeps": len(per_sweep),
            "sweeps": per_sweep,
            "total": {
                "wall_seconds": agg_wall,
                "phases": agg_phases,
                "critical_path_seconds": agg_union,
                "other_seconds": agg_wall - agg_union,
                "sum_of_phases_seconds": agg_total,
                "overlap_factor": (1.0 - agg_union / agg_total)
                if agg_total > 0
                else 0.0,
            },
        }


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)
