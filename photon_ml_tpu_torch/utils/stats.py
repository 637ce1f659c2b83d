"""Per-feature summary statistics.

Reference: photon-lib .../stat/FeatureDataStatistics.scala:44-139 (mean, var,
min, max, numNonZeros per feature) written by
ModelProcessingUtils.writeBasicStatistics as FeatureSummarizationResultAvro
records (GameTrainingDriver.scala:581-612). Also feeds NormalizationContext
construction.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..io.avro import write_avro_file
from ..io.data import RawDataset
from ..io.index_map import IndexMap, split_feature_key
from ..io.schemas import FEATURE_SUMMARIZATION_RESULT_AVRO
from ..robust.retry import io_call


def compute_feature_statistics(raw: RawDataset, shard: str) -> Dict[str, np.ndarray]:
    """Weighted-count statistics over a shard's COO features (zeros included
    in mean/variance via implicit zero entries, matching a dense summary).

    Several processes: each computes the moment sums over its own rows;
    every process's sums are gathered (``parallel.multihost.allgather_object``)
    and added in process order in float64 (the minima and maxima taken the
    same way), so that every process returns the global statistics, bitwise
    alike on every process."""
    rows, cols, vals = raw.shard_coo[shard]
    d = raw.shard_dims[shard]
    # padded rows (multi-process equal-share) carry no features and must not
    # inflate the count denominator
    n = raw.true_rows if raw.true_rows is not None else raw.n_rows
    s1 = np.zeros(d)
    s2 = np.zeros(d)
    np.add.at(s1, cols, vals)
    np.add.at(s2, cols, vals * vals)
    nnz = np.bincount(cols, minlength=d).astype(np.float64)
    fmin = np.zeros(d)
    fmax = np.zeros(d)
    np.minimum.at(fmin, cols, vals)
    np.maximum.at(fmax, cols, vals)

    from ..parallel import multihost

    if multihost.process_count() > 1:
        parts = multihost.allgather_object((s1, s2, nnz, fmin, fmax, n))
        s1, s2, nnz, fmin, fmax, n = parts[0]
        for p1, p2, pn, pmin, pmax, pc in parts[1:]:
            s1, s2, nnz = s1 + p1, s2 + p2, nnz + pn
            fmin, fmax = np.minimum(fmin, pmin), np.maximum(fmax, pmax)
            n = n + pc

    mean = s1 / max(n, 1)
    var = np.maximum(s2 / max(n, 1) - mean**2, 0.0)
    max_mag = np.maximum(np.abs(fmin), np.abs(fmax))
    return {
        "mean": mean,
        "variance": var,
        "min": fmin,
        "max": fmax,
        "num_nonzeros": nnz,
        "max_magnitude": max_mag,
        "count": np.full(d, float(n)),
    }


def save_feature_statistics(path: str, stats: Dict[str, np.ndarray], index_map: IndexMap):
    """Write FeatureSummarizationResultAvro records (one per feature)."""
    d = len(index_map)

    def records():
        for i in range(d):
            key = index_map.get_feature_name(i)
            if key is None:
                continue
            name, term = split_feature_key(key)
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "mean": float(stats["mean"][i]),
                    "variance": float(stats["variance"][i]),
                    "min": float(stats["min"][i]),
                    "max": float(stats["max"][i]),
                    "numNonzeros": float(stats["num_nonzeros"][i]),
                },
            }

    # atomic via write_avro_file; transient failures retry (Spark task-retry
    # parity — a stats write must not kill a run that just finished training)
    io_call(
        write_avro_file, path, FEATURE_SUMMARIZATION_RESULT_AVRO, list(records()),
        site="io.stats_save",
    )
