"""Name-and-term feature bags driver.

Reference: photon-client .../NameAndTermFeatureBagsDriver.scala:148-219:
extract the distinct (name, term) pairs per feature bag from the data and
write them as text files (one "name<TAB>term" per line, the NameAndTerm
STRING_DELIMITER format) for later feature-map construction. The JAX
package's ``cli/feature_bags.py``, copied.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

from ..io.avro import iter_avro_directory
from ..utils.logging import setup_logging
from .params import add_common_io_args, resolve_input_paths

logger = logging.getLogger("photon_ml_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch name-and-term feature bags driver")
    add_common_io_args(p)
    p.add_argument("--feature-bags", required=True, help="comma-separated bag columns")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--log-level", default="INFO")
    return p


def _input_paths(args):
    paths = resolve_input_paths(args)
    return [paths] if isinstance(paths, str) else paths


def run(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    bags = [b for b in args.feature_bags.split(",") if b]
    seen: Dict[str, Set[Tuple[str, str]]] = {b: set() for b in bags}
    for rec in (r for path in _input_paths(args) for r in iter_avro_directory(path)):
        for bag in bags:
            for f in rec.get(bag) or ():
                term = f.get("term")
                seen[bag].add((f["name"], "" if term is None else str(term)))
    os.makedirs(args.output_dir, exist_ok=True)
    for bag, pairs in seen.items():
        path = os.path.join(args.output_dir, bag)
        with open(path, "w") as out:
            for name, term in sorted(pairs):
                out.write(f"{name}\t{term}\n")
        logger.info("bag %s: %d distinct features -> %s", bag, len(pairs), path)
    return seen


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
