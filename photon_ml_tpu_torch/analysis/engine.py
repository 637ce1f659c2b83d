"""Lint engine: file walking, suppression comments, baseline bookkeeping.

Suppression is per line and per rule::

    x = float(score_sum)  # photon: ignore[R1] — logged two lines up

A comment that has a line to itself suppresses the next code line instead
(for justifications too long to share the line)::

    # photon: ignore[R4] — future semantics: stored, re-raised in result()
    except BaseException as e:

Multiple rules separate with commas (``# photon: ignore[R1,R3]``). There is
deliberately no blanket ignore-all spelling: every suppression names the
rule it silences, so a future rule cannot be pre-silenced by accident.

The baseline file grandfathers findings that predate the linter (or that a
rule change newly surfaces) without blocking CI. Entries match on
``(file, rule, stripped source line)`` — robust against unrelated edits
moving lines — and matching is multiset-aware: three identical offending
lines need three baseline entries. Regenerate with ``--write-baseline``;
shrink it over time by fixing what it lists.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import pickle
import re
import tokenize
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .config import LintConfig
from .project import PROJECT_RULE_IDS, Annotation, analyze_project
from .rules import RULES, run_rules

_SUPPRESS_RE = re.compile(r"#\s*photon:\s*ignore\[([A-Za-z0-9_,\s]+)\]")

BASELINE_VERSION = 1

# incremental-lint cache (the --cache flag). Entries are keyed by content
# stats (mtime_ns + size per input), so an edit — including to the README
# ledger, the inventories, or the tests the project passes read — misses.
CACHE_DIR_NAME = ".photon-lint-cache"
CACHE_VERSION = 1

# project errors with these prefixes are *configuration* mistakes (bad
# config entry, malformed annotation grammar) — the CLI exits 2 for
# them, distinctly from unreadable/unparseable files (exit 1)
_CONFIG_ERROR_PREFIXES = ("thread_entrypoints:", "annotation:")


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str  # posix relpath from the config root
    line: int
    col: int
    rule: str
    message: str
    code: str  # stripped source line
    suppressed: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        """Counts against the exit code."""
        return not (self.suppressed or self.baselined)

    def key(self) -> Tuple[str, str, str]:
        return (self.file, self.rule, self.code)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_scanned: int
    parse_errors: List[str] = dataclasses.field(default_factory=list)
    # configuration mistakes (unknown thread_entrypoints spec, malformed
    # annotation grammar): the user's input is wrong, not the linted code —
    # reported separately so the CLI can exit 2, like a bad config key
    config_errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if f.active]

    @property
    def ok(self) -> bool:
        return (
            not self.active and not self.parse_errors and not self.config_errors
        )


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line -> suppressed rules, from real COMMENT tokens only (a docstring
    that *mentions* the ignore syntax must not suppress anything). Inline
    comments suppress their own line; a comment owning the whole line
    suppresses the next code line (skipping blanks and further comments)."""
    out: Dict[int, Set[str]] = {}
    lines = source.splitlines()
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        lineno = tok.start[0]
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        bad = rules - set(RULES)
        if bad:
            raise ValueError(
                f"line {lineno}: photon: ignore names unknown rule(s) "
                f"{sorted(bad)}; known: {sorted(RULES)}"
            )
        if tok.line.strip().startswith("#"):
            # standalone comment: applies to the next code line
            target = lineno + 1
            while target <= len(lines) and (
                not lines[target - 1].strip()
                or lines[target - 1].lstrip().startswith("#")
            ):
                target += 1
            out.setdefault(target, set()).update(rules)
        else:
            out.setdefault(lineno, set()).update(rules)
    return out


def analyze_source(
    source: str,
    relpath: str,
    config: Optional[LintConfig] = None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one module's source. ``relpath`` decides which module-scoped
    rules apply (hot-loop R1, dtype-strict R3 subrule)."""
    config = config or LintConfig()
    tree = ast.parse(source, filename=relpath)
    raw = run_rules(
        tree,
        hot=config.is_hot(relpath),
        dtype_strict=config.is_dtype_strict(relpath),
        atomic=config.is_atomic_write(relpath),
        timing=config.is_timing_strict(relpath),
        torch_free=config.is_torch_free(relpath),
        rules=rules,
    )
    sup = _suppressions(source)
    lines = source.splitlines()
    findings = []
    for rf in raw:
        code = lines[rf.line - 1].strip() if 0 < rf.line <= len(lines) else ""
        findings.append(
            Finding(
                file=relpath,
                line=rf.line,
                col=rf.col,
                rule=rf.rule,
                message=rf.message,
                code=code,
                suppressed=rf.rule in sup.get(rf.line, ()),
            )
        )
    return findings


def iter_python_files(paths: Sequence[str], config: LintConfig) -> List[str]:
    """Absolute paths of the .py files to lint, config excludes applied."""
    out: List[str] = []
    for p in paths:
        p = p if os.path.isabs(p) else os.path.join(config.root, p)
        if os.path.isfile(p):
            out.append(os.path.abspath(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if d not in ("__pycache__", ".git")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.abspath(os.path.join(dirpath, name)))
    root = os.path.abspath(config.root)
    filtered = []
    for path in out:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        if not config.is_excluded(rel):
            filtered.append(path)
    return filtered


# --------------------------------------------------------------------------
# incremental-lint cache


def _stat_token(path: str) -> Tuple[str, int, int]:
    """(path, mtime_ns, size), or zeros when the file is absent — absence is
    itself a cacheable state (e.g. no baseline checked in yet)."""
    try:
        st = os.stat(path)
        return (path, st.st_mtime_ns, st.st_size)
    except OSError:
        return (path, 0, 0)


def _aux_input_paths(config: LintConfig) -> List[str]:
    """Non-linted files whose content the project passes read: docs tables,
    inventories, and the test files R10/R16 scan for pins/site literals."""
    from .dataflow import _test_files

    root = os.path.abspath(config.root)
    out = [
        os.path.join(root, config.refusal_docs),
        os.path.join(root, config.refusal_inventory),
        os.path.join(root, config.refusal_tests),
        os.path.join(root, config.fault_docs),
        os.path.join(root, config.fault_inventory),
    ]
    out.extend(os.path.join(root, d) for d in config.metric_docs)
    out.extend(_test_files(root, config.fault_tests))
    return out


def _run_cache_key(
    files: Sequence[str],
    config: LintConfig,
    baseline: Optional[Counter],
    rules: Optional[Sequence[str]],
    run_project: bool,
) -> str:
    h = hashlib.sha256()
    h.update(repr((CACHE_VERSION, config, sorted(rules or []), rules is None,
                   run_project)).encode())
    if baseline:
        h.update(repr(sorted(baseline.items())).encode())
    for path in files:
        h.update(repr(_stat_token(path)).encode())
    for path in _aux_input_paths(config):
        h.update(repr(_stat_token(path)).encode())
    return h.hexdigest()


def _file_cache_key(
    config: LintConfig, rules: Optional[Sequence[str]], rel: str, path: str
) -> str:
    h = hashlib.sha256()
    h.update(
        repr(
            (CACHE_VERSION, config, sorted(rules or []), rules is None, rel)
        ).encode()
    )
    h.update(repr(_stat_token(path)).encode())
    return h.hexdigest()


def _cache_load(cache_dir: str, key: str):
    try:
        with open(os.path.join(cache_dir, key + ".pickle"), "rb") as f:
            payload = pickle.load(f)
        if payload.get("version") == CACHE_VERSION:
            return payload["value"]
    except (OSError, pickle.PickleError, EOFError, ValueError, KeyError,
            AttributeError, ImportError, IndexError, TypeError):
        pass  # missing / corrupt / unpicklable: a plain miss
    return None


def _cache_store(cache_dir: str, key: str, value) -> None:
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = os.path.join(cache_dir, f".tmp-{os.getpid()}-{key}")
        with open(tmp, "wb") as f:
            pickle.dump({"version": CACHE_VERSION, "value": value}, f)
        os.replace(tmp, os.path.join(cache_dir, key + ".pickle"))
    except OSError:
        pass  # a cache that cannot be written is just a slow cache


def analyze_paths(
    paths: Optional[Sequence[str]] = None,
    config: Optional[LintConfig] = None,
    baseline: Optional[Counter] = None,
    rules: Optional[Sequence[str]] = None,
    project: Optional[bool] = None,
    cache: bool = False,
) -> LintResult:
    """Lint files/directories; default paths come from the config.

    The whole-program passes (R9-R11 and R13-R16, plus R12's
    unused-suppression sweep) need the complete package to build an honest
    call graph, so they run only on full configured-path runs — linting an
    explicit file subset stays per-file. ``project`` overrides the
    auto-detection either way.

    ``cache=True`` keeps mtime+size-keyed entries under
    ``.photon-lint-cache/`` in the config root: the whole run's result when
    nothing changed (the fast path the tier-1 self-check takes), and
    per-file parse/rule results so an edit re-lints only the touched file
    before the project passes rerun.
    """
    config = config or LintConfig()
    files = iter_python_files(paths or config.paths, config)
    root = os.path.abspath(config.root)
    run_project = project if project is not None else paths is None
    cache_dir = os.path.join(root, CACHE_DIR_NAME)
    run_key = None
    if cache:
        run_key = _run_cache_key(files, config, baseline, rules, run_project)
        hit = _cache_load(cache_dir, "run-" + run_key)
        if isinstance(hit, LintResult):
            return hit
    findings: List[Finding] = []
    errors: List[str] = []
    config_errors: List[str] = []
    sources: Dict[str, str] = {}
    sup_maps: Dict[str, Dict[int, Set[str]]] = {}
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            errors.append(f"cannot read {rel}: {e}")
            continue
        file_key = _file_cache_key(config, rules, rel, path) if cache else None
        cached = _cache_load(cache_dir, "file-" + file_key) if cache else None
        if cached is not None:
            file_findings, sup = cached
        else:
            try:
                file_findings = analyze_source(source, rel, config, rules=rules)
                sup = _suppressions(source)
            except (SyntaxError, ValueError) as e:
                errors.append(f"{rel}: {e}")
                continue
            if cache:
                _cache_store(
                    cache_dir, "file-" + file_key, (file_findings, sup)
                )
        findings.extend(file_findings)
        sources[rel] = source
        sup_maps[rel] = sup

    enabled = set(rules) if rules is not None else set(RULES)
    rules_run = set(enabled)
    if not run_project:
        rules_run -= set(PROJECT_RULE_IDS)
    annotations: List[Annotation] = []
    used_ann: Set[Tuple[str, int]] = set()
    if run_project and enabled & set(PROJECT_RULE_IDS):
        pres = analyze_project(sources, config, rules=sorted(enabled))
        for err in pres.errors:
            if err.startswith(_CONFIG_ERROR_PREFIXES):
                config_errors.append(err)
            else:
                errors.append(err)
        annotations = pres.annotations
        used_ann = pres.used_annotations
        for pf in pres.findings:
            findings.append(
                Finding(
                    file=pf.file,
                    line=pf.line,
                    col=pf.col,
                    rule=pf.rule,
                    message=pf.message,
                    code=_source_line(sources, root, pf.file, pf.line),
                    suppressed=pf.rule
                    in sup_maps.get(pf.file, {}).get(pf.line, ()),
                )
            )
    if run_project and "R12" in enabled:
        findings.extend(
            _unused_suppression_findings(
                sources, sup_maps, findings, annotations, used_ann, rules_run
            )
        )
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    if baseline:
        findings = apply_baseline(findings, baseline)
    result = LintResult(
        findings=findings,
        files_scanned=len(files),
        parse_errors=errors,
        config_errors=config_errors,
    )
    if cache and run_key is not None:
        _cache_store(cache_dir, "run-" + run_key, result)
    return result


def _source_line(
    sources: Dict[str, str], root: str, rel: str, line: int
) -> str:
    """The stripped source line backing a finding — from the scanned sources
    when possible, else from disk (R10/R11 findings land on README rows,
    test pins, and the inventories, none of which are linted files)."""
    text = sources.get(rel)
    if text is None:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            return ""
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return ""
    lines = text.splitlines()
    return lines[line - 1].strip() if 0 < line <= len(lines) else ""


def _unused_suppression_findings(
    sources: Dict[str, str],
    sup_maps: Dict[str, Dict[int, Set[str]]],
    findings: Sequence[Finding],
    annotations: Sequence[Annotation],
    used_annotations: Set[Tuple[str, int]],
    rules_run: Set[str],
) -> List[Finding]:
    """R12: suppressions and annotations that silenced nothing. Checked only
    for rules that actually ran this invocation — a ``--rule R8`` pass must
    not declare every R4 ignore stale."""
    used = {(f.file, f.line, f.rule) for f in findings if f.suppressed}
    out: List[Finding] = []
    for rel in sorted(sup_maps):
        lines = sources[rel].splitlines()
        for line, rules_at in sorted(sup_maps[rel].items()):
            for rule in sorted(rules_at):
                if rule == "R12" or rule not in rules_run:
                    continue
                if (rel, line, rule) in used:
                    continue
                code = (
                    lines[line - 1].strip() if 0 < line <= len(lines) else ""
                )
                out.append(
                    Finding(
                        file=rel,
                        line=line,
                        col=0,
                        rule="R12",
                        message=(
                            f"photon: ignore[{rule}] suppresses no finding — "
                            "delete the stale suppression"
                        ),
                        code=code,
                        suppressed="R12" in sup_maps[rel].get(line, ()),
                    )
                )
    # each annotation kind belongs to one rule; its staleness is judged only
    # when that rule ran (a --rule R8 pass must not declare them all stale)
    ann_rule = {
        "guarded-by": "R9",
        "thread-confined": "R9",
        "lock-order": "R13",
        "static-arg": "R15",
    }
    ann_excuse = {
        "R9": (
            "the attribute is not shared across thread contexts; delete "
            "the stale annotation"
        ),
        "R13": (
            "no contrary lock-acquisition edge exists; delete the stale "
            "annotation"
        ),
        "R15": (
            "the parameter never reaches host control flow in a "
            "capture-reachable scope; delete the stale annotation"
        ),
    }
    for ann in annotations:
        rule = ann_rule.get(ann.kind, "R9")
        if rule not in rules_run:
            continue
        if (ann.file, ann.line) in used_annotations:
            continue
        lines = sources.get(ann.file, "").splitlines()
        code = (
            lines[ann.line - 1].strip()
            if 0 < ann.line <= len(lines)
            else ""
        )
        out.append(
            Finding(
                file=ann.file,
                line=ann.line,
                col=0,
                rule="R12",
                message=(
                    f"photon: {ann.kind} annotation suppresses no {rule} "
                    f"finding — {ann_excuse[rule]}"
                ),
                code=code,
                suppressed="R12"
                in sup_maps.get(ann.file, {}).get(ann.line, ()),
            )
        )
    return out


# --------------------------------------------------------------------------
# baseline


def load_baseline(path: str) -> Counter:
    """(file, rule, code) multiset from a baseline JSON file; empty when the
    file does not exist (a missing baseline means nothing is grandfathered)."""
    if not os.path.isfile(path):
        return Counter()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: baseline version {data.get('version')!r} != "
            f"{BASELINE_VERSION}; regenerate with --write-baseline"
        )
    return Counter(
        (e["file"], e["rule"], e["code"]) for e in data.get("findings", [])
    )


def apply_baseline(findings: List[Finding], baseline: Counter) -> List[Finding]:
    remaining = Counter(baseline)
    out = []
    for f in findings:
        if not f.suppressed and remaining.get(f.key(), 0) > 0:
            remaining[f.key()] -= 1
            f = dataclasses.replace(f, baselined=True)
        out.append(f)
    return out


def write_baseline(findings: Sequence[Finding], path: str) -> int:
    """Write all unsuppressed findings as the new baseline; returns count."""
    entries = [
        {"file": f.file, "rule": f.rule, "code": f.code}
        for f in sorted(findings, key=lambda f: (f.file, f.line, f.col))
        if not f.suppressed
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {"version": BASELINE_VERSION, "findings": entries}, f, indent=2
        )
        f.write("\n")
    return len(entries)


# --------------------------------------------------------------------------
# refusal inventory (R10's --write-refusal-inventory counterpart)


def write_refusal_inventory(config: LintConfig) -> Tuple[str, int]:
    """Regenerate the refusal inventory from the current tree: the README
    ledger rows matched against the package's raise sites. Returns (path, entries).
    Same contract as --write-baseline: the checked-in file must be
    byte-identical to a fresh run or the R10 pass fails."""
    from .project import (
        build_refusal_inventory,
        extract_raise_sites,
        parse_refusal_ledger,
        render_refusal_inventory,
    )

    root = os.path.abspath(config.root)
    sources: Dict[str, str] = {}
    for path in iter_python_files(config.paths, config):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                sources[rel] = f.read()
        except OSError:
            continue
    docs_path = os.path.join(config.root, config.refusal_docs)
    ledger = []
    if os.path.isfile(docs_path):
        with open(docs_path, encoding="utf-8") as f:
            ledger = parse_refusal_ledger(f.read())
    doc = build_refusal_inventory(ledger, extract_raise_sites(sources))
    out_path = os.path.join(config.root, config.refusal_inventory)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(render_refusal_inventory(doc))
    return out_path, len(doc["refusals"])


def write_fault_inventory(config: LintConfig) -> Tuple[str, int]:
    """Regenerate the fault inventory from the current tree's literal
    fault-injection sites (R16's --write-fault-inventory counterpart).
    Same contract as the refusal inventory: the checked-in file must be
    byte-identical to a fresh render or the R16 pass fails."""
    from .dataflow import (
        build_fault_inventory,
        extract_fault_sites,
        render_fault_inventory,
    )

    root = os.path.abspath(config.root)
    sources: Dict[str, str] = {}
    for path in iter_python_files(config.paths, config):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                sources[rel] = f.read()
        except OSError:
            continue
    doc = build_fault_inventory(extract_fault_sites(sources))
    out_path = os.path.join(config.root, config.fault_inventory)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(render_fault_inventory(doc))
    return out_path, len(doc["sites"])
