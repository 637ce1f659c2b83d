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

    One process only: the JAX package's multi-process branch (moment sums
    over each host's rows, gathered and combined) is ROADMAP A10's, and a
    world of more than one process raises."""
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

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "feature statistics over several processes (the gathered moment sums) are not ported yet (ROADMAP A10)"
        )

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
