"""``python -m photon_ml_tpu_torch.analysis`` — the port's lint CLI.

With no arguments it lints the port with the settings of ``config.py``;
``--config FILE`` reads a ``[tool.photon-lint]`` section from FILE instead.
Exit codes: 0 clean, 1 active findings (or parse/analysis errors), 2 usage
or configuration error — a bad flag, a bad config key, an unknown
``thread_entrypoints`` spec, or a malformed annotation grammar (the
*input* to the linter is wrong, as opposed to the linted code).
Human output is one ``path:line:col: RULE message`` block per finding;
``--json`` emits a machine-readable report for CI annotation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .config import load_config
from .engine import (
    analyze_paths,
    load_baseline,
    write_baseline,
    write_fault_inventory,
    write_refusal_inventory,
)
from .rules import RULES, explain_rule

# --json report layout version; bump on breaking shape changes
# (v3: adds config_errors; R13-R16 findings appear in findings[])
JSON_SCHEMA_VERSION = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.analysis",
        description="The port's static analysis: per-file rules R1-R8 plus "
        "the whole-program passes R9-R16 (thread races, lock-order cycles, "
        "resource lifecycles, graph-capture hazards, refusal-ledger / "
        "fault-site / metric contracts, unused suppressions), configured "
        "by photon_ml_tpu_torch/analysis/config.py",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: configured paths)",
    )
    p.add_argument(
        "--config",
        help="a TOML file to read [tool.photon-lint] from (default: the "
        "port's settings in config.py)",
    )
    p.add_argument("--baseline", help="override the configured baseline path")
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="report grandfathered findings too",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="write current unsuppressed findings as the new baseline and exit 0",
    )
    p.add_argument(
        "--rule",
        action="append",
        choices=sorted(RULES),
        help="run only these rules (repeatable)",
    )
    p.add_argument(
        "--cache",
        action="store_true",
        help="reuse mtime+size-keyed results from .photon-lint-cache/ "
        "(whole-run and per-file)",
    )
    p.add_argument("--json", action="store_true", help="JSON report on stdout")
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    p.add_argument(
        "--explain",
        metavar="RULE",
        choices=sorted(RULES),
        help="print one rule's doc, rationale, and good/bad example, then exit",
    )
    p.add_argument(
        "--write-refusal-inventory",
        action="store_true",
        help="regenerate the refusal inventory from the README ledger and "
        "the package's raise sites, then exit 0",
    )
    p.add_argument(
        "--write-fault-inventory",
        action="store_true",
        help="regenerate the fault inventory from the package's literal "
        "fault-injection sites, then exit 0",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if args.explain:
        print(explain_rule(args.explain))
        return 0
    try:
        config = load_config(pyproject=args.config)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_refusal_inventory:
        path, n = write_refusal_inventory(config)
        print(f"wrote {n} refusal(s) to {path}")
        return 0

    if args.write_fault_inventory:
        path, n = write_fault_inventory(config)
        print(f"wrote {n} fault site(s) to {path}")
        return 0

    baseline_path = args.baseline or config.baseline_path
    try:
        baseline = None if args.no_baseline else load_baseline(baseline_path)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    result = analyze_paths(
        paths=args.paths or None,
        config=config,
        baseline=None if args.write_baseline else baseline,
        rules=args.rule,
        cache=args.cache,
    )

    if args.write_baseline:
        n = write_baseline(result.findings, baseline_path)
        print(f"wrote {n} finding(s) to {baseline_path}")
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "schema_version": JSON_SCHEMA_VERSION,
                    "files_scanned": result.files_scanned,
                    "parse_errors": result.parse_errors,
                    "config_errors": result.config_errors,
                    "findings": [f.to_dict() for f in result.findings],
                    "active": len(result.active),
                    "ok": result.ok,
                },
                indent=2,
            )
        )
    else:
        for f in result.findings:
            if f.suppressed:
                continue
            tag = " [baselined]" if f.baselined else ""
            print(f"{f.file}:{f.line}:{f.col}: {f.rule}{tag} {f.message}")
            if f.code:
                print(f"    {f.code}")
        for err in result.parse_errors:
            print(f"parse error: {err}", file=sys.stderr)
        for err in result.config_errors:
            print(f"config error: {err}", file=sys.stderr)
        n_sup = sum(1 for f in result.findings if f.suppressed)
        n_base = sum(1 for f in result.findings if f.baselined)
        print(
            f"{len(result.active)} active finding(s) "
            f"({n_sup} suppressed, {n_base} baselined) "
            f"in {result.files_scanned} file(s)"
        )
    if result.config_errors:
        return 2
    return 0 if result.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
