"""Post-hoc model & convergence diagnostics: the pure math behind the run
report (obs/report.py).

Reference: the photon-client Diagnostics side renders per-model training
reports — coefficient summaries, fitting diagnostics, feature importance —
next to every GLMix fit. These functions are that layer, copied from the
JAX package's ``obs/diagnostics.py``, computed from SAVED artifacts (model avro files, metrics.jsonl
snapshots) rather than live training state, so `cli report` can run on a dev
box with no accelerator stack.

Everything here is numpy-only and float64; inputs are plain sequences/arrays
of host floats, so both packages give equal numbers on equal inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

COEFFICIENT_QUANTILES: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0)


def coefficient_summary(
    values: Sequence[float],
    names: Optional[Sequence[str]] = None,
    n_features_total: Optional[int] = None,
    top_k: int = 20,
) -> dict:
    """Per-coordinate coefficient diagnostics: L1/L2 norms, sparsity,
    quantiles of the stored values, and the top-k features by |weight|.

    ``values`` are the NONZERO coefficients a saved model records (model_io
    drops sub-threshold entries at save time); ``n_features_total`` is the
    feature-space dimension for the sparsity denominator — when None (no
    feature index available) the recorded count is used and sparsity reads
    0.0 by construction.
    """
    a = np.asarray(list(values), dtype=np.float64).ravel()
    n_recorded = int(a.size)
    total = int(n_features_total) if n_features_total else n_recorded
    nnz = int(np.count_nonzero(a))
    out = {
        "n_nonzero": nnz,
        "n_recorded": n_recorded,
        "n_features_total": total,
        "sparsity": 1.0 - (nnz / total) if total else 0.0,
        "l1_norm": float(np.abs(a).sum()),
        "l2_norm": float(math.sqrt(float((a * a).sum()))),
        "max_abs": float(np.abs(a).max()) if n_recorded else 0.0,
        "quantiles": {
            f"p{int(q * 100)}": (float(np.quantile(a, q)) if n_recorded else 0.0)
            for q in COEFFICIENT_QUANTILES
        },
    }
    top: List[dict] = []
    if names is not None and n_recorded:
        order = np.argsort(-np.abs(a), kind="stable")[: max(int(top_k), 0)]
        top = [
            {"feature": str(names[int(i)]), "weight": float(a[int(i)])}
            for i in order
        ]
    out["top_features"] = top
    return out


def shrinkage_summary(
    norms: Sequence[float], counts: Sequence[int]
) -> dict:
    """Random-effect shrinkage evidence: per-entity coefficient L2 norm
    binned by the entity's support size (its recorded nonzero feature
    count — true training row counts are not persisted in the artifacts, and
    support size is the closest saved proxy).

    Bins are log2 on counts: bin b holds entities with count in
    ``[2**b, 2**(b+1))``; count 0 lands in its own "0" bin. Per bin:
    n_entities, mean / min / max norm. The shrinkage story the reference's
    diagnostics tell — small-data entities pulled toward zero — reads off
    the mean-norm column rising with the bin index.

    Hand-computable oracle (pinned by tests): ``bin = floor(log2(count))``,
    ``mean_norm = sum(norms in bin)/n``.
    """
    n = np.asarray(list(norms), dtype=np.float64).ravel()
    c = np.asarray(list(counts), dtype=np.int64).ravel()
    if n.shape != c.shape:
        raise ValueError(
            f"norms and counts must align: {n.shape} vs {c.shape}"
        )
    bins: Dict[str, List[float]] = {}
    for norm, count in zip(n.tolist(), c.tolist()):
        if count <= 0:
            key = "0"
        else:
            b = int(math.floor(math.log2(count)))
            key = f"[{2 ** b},{2 ** (b + 1)})"
        bins.setdefault(key, []).append(norm)

    def _lo(key: str) -> int:
        return 0 if key == "0" else int(key[1:].split(",", 1)[0])

    histogram = [
        {
            "support": key,
            "n_entities": len(vals),
            "mean_norm": float(np.mean(vals)),
            "min_norm": float(np.min(vals)),
            "max_norm": float(np.max(vals)),
        }
        for key, vals in sorted(bins.items(), key=lambda kv: _lo(kv[0]))
    ]
    return {
        "n_entities": int(n.size),
        "norm_quantiles": {
            f"p{int(q * 100)}": (float(np.quantile(n, q)) if n.size else 0.0)
            for q in COEFFICIENT_QUANTILES
        },
        "histogram": histogram,
    }


# ---------------------------------------------------------------------------
# trajectory extraction from the metrics.jsonl stream


def iter_metric_snapshots(lines: Iterable[str]) -> Iterable[List[dict]]:
    """Yield the ``metrics`` list of every type=metrics row of a JSONL
    stream, in file order (one per CD sweep flush + one at close).
    Non-JSON / non-metrics lines are skipped, torn trailing lines included —
    a report over a crashed run's stream must not raise."""
    import json

    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("type") == "metrics":
            yield row.get("metrics") or []


def gauge_trajectories(
    snapshots: Sequence[List[dict]], name: str, label: str
) -> Dict[str, List[Optional[float]]]:
    """Per-``label``-value series of a gauge across snapshots. A snapshot
    where the series does not exist yet contributes None (e.g. a coordinate
    whose first accepted update came in sweep 2), so every series has
    one entry per snapshot and plots align."""
    keys: List[str] = []
    for snap in snapshots:
        for m in snap:
            if m.get("name") == name and m.get("kind") == "gauge":
                k = str(m.get("labels", {}).get(label, ""))
                if k not in keys:
                    keys.append(k)
    out: Dict[str, List[Optional[float]]] = {k: [] for k in keys}
    for snap in snapshots:
        seen: Dict[str, float] = {}
        for m in snap:
            if m.get("name") == name and m.get("kind") == "gauge":
                seen[str(m.get("labels", {}).get(label, ""))] = float(m["value"])
        for k in keys:
            out[k].append(seen.get(k))
    return out


def validation_trajectories(
    snapshots: Sequence[List[dict]],
) -> Dict[str, List[Optional[float]]]:
    """Per-metric validation series (photon_validation_metric, collapsed
    over the coordinate label: the gauge holds the metric after the latest
    update, so the last write per snapshot is the sweep-end value)."""
    keys: List[str] = []
    for snap in snapshots:
        for m in snap:
            if m.get("name") == "photon_validation_metric":
                k = str(m.get("labels", {}).get("metric", ""))
                if k not in keys:
                    keys.append(k)
    out: Dict[str, List[Optional[float]]] = {k: [] for k in keys}
    for snap in snapshots:
        seen: Dict[str, float] = {}
        for m in snap:
            if m.get("name") == "photon_validation_metric":
                seen[str(m.get("labels", {}).get("metric", ""))] = float(m["value"])
        for k in keys:
            out[k].append(seen.get(k))
    return out
