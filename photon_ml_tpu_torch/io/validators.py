"""Input data validation.

Reference: photon-client .../data/DataValidators.scala (405 lines): per-task
row checks — finite features/offsets/weights, label ranges (binary labels in
{0,1}/{-1,1}, non-negative Poisson counts), nonzero weights — in FULL (all
rows) or SAMPLE mode, failing the job with a count of offending rows.

This port adds a third active mode the reference lacks: QUARANTINE scans
every row like FULL, but instead of failing the job it zero-weights the
offending rows (and zeroes their non-finite labels/offsets/feature values —
a zero weight alone is not enough, ``0 * NaN`` is still NaN in the weighted
loss) and lets training proceed on the clean remainder. It logs the count
and adds it to ``photon_rows_quarantined_total`` in the run's metrics
registry, as the JAX package does.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from .data import RawDataset

logger = logging.getLogger("photon_ml_tpu_torch")

VALIDATE_FULL = "VALIDATE_FULL"
VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
VALIDATE_QUARANTINE = "VALIDATE_QUARANTINE"
VALIDATE_DISABLED = "DISABLED"


class DataValidationError(ValueError):
    pass


def _sample(mask_len: int, mode: str, rng_seed: int = 0) -> np.ndarray:
    if mode == VALIDATE_FULL:
        return np.arange(mask_len)
    rng = np.random.default_rng(rng_seed)
    take = max(1, mask_len // 100)
    return rng.choice(mask_len, size=min(take, mask_len), replace=False)


def _bad_label_mask(labels: np.ndarray, task: str) -> np.ndarray:
    """Rows whose label fails the task's range check (non-finite included)."""
    bad = ~np.isfinite(labels)
    t = task.lower()
    if t in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        bad |= ~np.isin(labels, (0.0, 1.0, -1.0))
    elif t == "poisson_regression":
        # NaN comparisons are False — the isfinite term above catches those
        bad |= labels < 0
    return bad


def validate_dataset(
    raw: RawDataset,
    task: str,
    mode: str = VALIDATE_FULL,
    rng_seed: int = 0,
) -> int:
    """Validate (or repair) ``raw`` for training ``task``.

    FULL / SAMPLE: raise :class:`DataValidationError` listing every failed
    check with its offending-row count
    (DataValidators.sanityCheckDataFrameForTraining semantics); SAMPLE draws
    ~1% of rows seeded by ``rng_seed`` — thread the run seed so reruns check
    the same rows. QUARANTINE: full scan, zero-weight + sanitize offending
    rows in place instead of raising. Returns the number of quarantined rows
    (0 for the raising modes and DISABLED).
    """
    if mode == VALIDATE_DISABLED:
        return 0
    if mode == VALIDATE_QUARANTINE:
        return _quarantine(raw, task)
    if mode not in (VALIDATE_FULL, VALIDATE_SAMPLE):
        raise ValueError(
            f"validation mode must be one of {VALIDATE_FULL}, "
            f"{VALIDATE_SAMPLE}, {VALIDATE_QUARANTINE}, {VALIDATE_DISABLED}: "
            f"{mode!r}"
        )
    rows = _sample(raw.n_rows, mode, rng_seed)
    problems: List[str] = []

    labels = raw.labels[rows]
    if not np.all(np.isfinite(labels)):
        problems.append(f"{np.sum(~np.isfinite(labels))} non-finite labels")
    t = task.lower()
    if t in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        ok = np.isin(labels, (0.0, 1.0, -1.0))
        if not np.all(ok):
            problems.append(
                f"{np.sum(~ok)} labels outside {{0,1,-1}} for binary task {task}"
            )
    elif t == "poisson_regression":
        if np.any(labels < 0):
            problems.append(f"{np.sum(labels < 0)} negative labels for Poisson")

    bad_off = ~np.isfinite(raw.offsets[rows])
    if np.any(bad_off):
        problems.append(f"{np.sum(bad_off)} non-finite offsets")
    w = raw.weights[rows]
    bad_w = ~np.isfinite(w) | (w < 0)
    if np.any(bad_w):
        problems.append(f"{np.sum(bad_w)} non-finite or negative weights")
    if np.all(w == 0):
        problems.append("all sampled weights are zero")

    for shard, (r, c, v) in raw.shard_coo.items():
        if mode == VALIDATE_FULL:
            bad = ~np.isfinite(v)
        else:
            in_sample = np.isin(r, rows)
            bad = in_sample & ~np.isfinite(v)
        if np.any(bad):
            # counted per ROW, not per value: "how many samples are poisoned"
            # is the actionable number, one row can hold many bad values
            problems.append(
                f"shard {shard}: {np.sum(bad)} non-finite feature values "
                f"across {len(np.unique(r[bad]))} rows"
            )
        d = raw.shard_dims[shard]
        if len(c) and (c.min() < 0 or c.max() >= d):
            oob = (c < 0) | (c >= d)
            problems.append(
                f"shard {shard}: {np.sum(oob)} feature indices out of range "
                f"[0, {d}) across {len(np.unique(r[oob]))} rows"
            )

    if problems:
        raise DataValidationError(
            "input data failed validation: " + "; ".join(problems)
        )
    logger.info("data validation passed (%s, %d rows checked)", mode, len(rows))
    return 0


def _quarantine(raw: RawDataset, task: str) -> int:
    """Zero-weight every offending row in place; returns how many.

    A quarantined row must be numerically INERT, not just weightless:
    weighted losses compute ``weight * loss(label, score)`` and
    ``0 * NaN == NaN``, so its label/offset/feature values are zeroed too.
    Out-of-range feature indices stay a hard error even here — they corrupt
    OTHER rows' coefficients through the scatter, so there is no safe way to
    train around them.
    """
    bad = _bad_label_mask(raw.labels, task)
    bad |= ~np.isfinite(raw.offsets)
    bad |= ~np.isfinite(raw.weights) | (raw.weights < 0)
    for shard, (r, c, v) in raw.shard_coo.items():
        d = raw.shard_dims[shard]
        if len(c) and (c.min() < 0 or c.max() >= d):
            oob = (c < 0) | (c >= d)
            raise DataValidationError(
                f"shard {shard}: {np.sum(oob)} feature indices out of range "
                f"[0, {d}) across {len(np.unique(r[oob]))} rows; QUARANTINE "
                "cannot repair index corruption"
            )
        bad_v = ~np.isfinite(v)
        if np.any(bad_v):
            np.logical_or.at(bad, r[bad_v], True)
            v = v.copy()
            v[bad_v] = 0.0
            raw.shard_coo[shard] = (r, c, v)
    count = int(np.sum(bad))
    if count:
        raw.labels = np.where(bad, 0.0, raw.labels)
        raw.offsets = np.where(bad, 0.0, raw.offsets)
        raw.weights = np.where(bad, 0.0, raw.weights)
        if np.all(raw.weights == 0):
            raise DataValidationError(
                f"QUARANTINE zero-weighted all {count} rows; nothing left "
                "to train on"
            )
        from .. import obs

        obs.current_run().registry.counter(
            "photon_rows_quarantined_total",
            "input rows zero-weighted by QUARANTINE validation",
        ).inc(count)
        logger.warning(
            "data validation quarantined %d/%d rows (zero-weighted)",
            count, raw.n_rows,
        )
    else:
        logger.info("data validation passed (%s, %d rows checked)",
                    VALIDATE_QUARANTINE, raw.n_rows)
    return count
