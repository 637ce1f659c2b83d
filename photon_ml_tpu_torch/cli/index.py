"""Feature indexing driver: build partitioned immutable index stores.

Reference: photon-client .../index/FeatureIndexingDriver.scala:168-298 (§3.5):
extract distinct (name, term) per shard from data -> write hash-partitioned
off-heap stores (PalDB there; flat binary stores here) consumed at read time.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from ..io.avro import iter_avro_directory
from ..io.data import build_index_maps
from ..io.index_map import save_partitioned
from ..utils.logging import setup_logging
from .params import add_common_io_args, build_shard_configs, resolve_input_paths

logger = logging.getLogger("photon_ml_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch feature indexing driver")
    add_common_io_args(p)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-partitions", type=int, default=1)
    p.add_argument("--log-level", default="INFO")
    return p


def _input_paths(args):
    paths = resolve_input_paths(args)
    return [paths] if isinstance(paths, str) else paths


def run(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    shards = build_shard_configs(args)
    records = [
        r
        for path in _input_paths(args)
        for r in iter_avro_directory(path)
    ]
    index_maps = build_index_maps(records, shards)
    for shard, imap in index_maps.items():
        save_partitioned(imap, args.output_dir, args.num_partitions, shard)
        logger.info("shard %s: %d features indexed", shard, len(imap))
    return index_maps


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
