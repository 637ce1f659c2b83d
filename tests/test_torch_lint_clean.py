"""Tier-1 self-check: the port passes its own static analysis.

This is the port's lint gate in test form — the same settings, baseline and
rule set as ``python -m photon_ml_tpu_torch.analysis`` (the settings of
``photon_ml_tpu_torch/analysis/config.py``). A new unsuppressed finding
anywhere in ``photon_ml_tpu_torch/`` fails this test with the finding list
in the assertion message; fix it, suppress it with a reasoned ``# photon:
ignore[Rn]``, or (for a deliberate grandfathering) add it to the port's
``analysis/lint_baseline.json`` via --write-baseline."""

import os
import subprocess
import sys

import pytest

from photon_ml_tpu_torch.analysis import analyze_paths, load_baseline, load_config
from photon_ml_tpu_torch.analysis.engine import iter_python_files
from photon_ml_tpu_torch.analysis.project import analyze_project, render_refusal_inventory


@pytest.fixture(scope="module")
def config():
    return load_config()


@pytest.fixture(scope="module")
def package_sources(config):
    root = os.path.abspath(config.root)
    sources = {}
    for path in iter_python_files(config.paths, config):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            sources[rel] = f.read()
    return sources


def test_port_is_lint_clean(config):
    # a FULL configured run: the whole-program passes (R9-R16) too
    baseline = load_baseline(config.baseline_path)
    result = analyze_paths(config=config, baseline=baseline)
    assert not result.parse_errors, result.parse_errors
    assert not result.config_errors, result.config_errors
    assert not result.active, "\n" + "\n".join(
        f"{f.file}:{f.line}:{f.col}: {f.rule} {f.message}\n    {f.code}" for f in result.active
    )
    assert result.files_scanned > 50  # the walk really covered the port


def test_race_annotations_are_consulted(config, package_sources):
    """The R9 pass really runs and really validates: no annotation errors,
    and the port's guarded-by/thread-confined annotations are consumed by
    actual race findings."""
    res = analyze_project(package_sources, config, rules=("R9",))
    assert res.errors == []
    assert res.annotations, "expected race annotations in the port"
    assert res.used_annotations, "annotations exist but excuse no race"


def test_refusal_inventory_is_fresh(config, package_sources):
    """The port's refusals.json is byte-identical to a fresh regeneration,
    and every documented refusal the port does not depart from is enforced
    by at least one of its raise sites."""
    from photon_ml_tpu_torch.analysis.project import parse_test_pins

    res = analyze_project(package_sources, config, rules=("R10",))
    assert res.refusal_inventory is not None, "README ledger not found"
    want = render_refusal_inventory(res.refusal_inventory)
    with open(os.path.join(config.root, config.refusal_inventory), encoding="utf-8") as f:
        assert f.read() == want, "stale: run --write-refusal-inventory"
    with open(os.path.join(config.root, config.refusal_tests), encoding="utf-8") as f:
        departed = {p.fragment for p in parse_test_pins(f.read()) if not p.exception}
    assert departed == {"multi-process training requires a device mesh spanning all global devices"}
    for entry in res.refusal_inventory["refusals"]:
        if entry["fragment"] in departed:
            assert entry["modules"] == [], entry["fragment"]
            continue
        assert entry["modules"], f"unenforced refusal: {entry['fragment']!r}"
        assert entry["exceptions"], entry["fragment"]


def test_dataflow_rules_are_zero_active(config, package_sources):
    """R13-R16 hold on the port with NO baseline net: no lock-order cycle,
    no resource leaked on any CFG path, no hazard reachable from a CUDA
    graph capture, no fault-site drift."""
    res = analyze_project(package_sources, config, rules=("R13", "R14", "R15", "R16"))
    assert res.errors == []
    assert res.findings == [], "\n" + "\n".join(f"{f.file}:{f.line}: {f.rule} {f.message}" for f in res.findings)


def test_fault_inventory_is_fresh(config, package_sources):
    """robust/fault_sites.json is byte-identical to a fresh regeneration
    (tests/test_torch_robust.py holds it against the sources' literals as
    well), and every inventoried site names at least one declaring module."""
    from photon_ml_tpu_torch.analysis.dataflow import (
        build_fault_inventory,
        extract_fault_sites,
        render_fault_inventory,
    )

    doc = build_fault_inventory(extract_fault_sites(package_sources))
    with open(os.path.join(config.root, config.fault_inventory), encoding="utf-8") as f:
        assert f.read() == render_fault_inventory(doc), "stale: run --write-fault-inventory"
    assert doc["sites"], "expected fault sites in the port"
    for entry in doc["sites"]:
        assert entry["modules"], f"siteless entry: {entry['site']!r}"


def test_cached_lint_matches_uncached(config, tmp_path, monkeypatch):
    """--cache is a pure speedup: identical findings, and the second run
    really is served from the run-level cache entry."""
    from photon_ml_tpu_torch.analysis import engine

    plain = analyze_paths(config=config)
    monkeypatch.setattr(engine, "CACHE_DIR_NAME", str(tmp_path / engine.CACHE_DIR_NAME))
    cold = analyze_paths(config=config, cache=True)
    loads = []
    real_load = engine._cache_load
    monkeypatch.setattr(engine, "_cache_load", lambda d, k: loads.append(k) or real_load(d, k))
    warm = analyze_paths(config=config, cache=True)
    assert loads and loads[0].startswith("run-") and len(loads) == 1
    for result in (cold, warm):
        assert [f.to_dict() for f in result.findings] == [f.to_dict() for f in plain.findings]
        assert result.files_scanned == plain.files_scanned


_NO_JAX = r"""
import runpy
import sys

for name in ("jax", "jaxlib", "photon_ml_tpu", "torch"):
    sys.modules[name] = None  # an import of any of them now raises
sys.argv = ["photon_ml_tpu_torch.analysis", "--list-rules"]
runpy.run_module("photon_ml_tpu_torch.analysis", run_name="__main__", alter_sys=True)
"""


def test_cli_runs_without_jax_the_jax_package_or_torch(config):
    """``python -m photon_ml_tpu_torch.analysis --list-rules`` with jax,
    jaxlib, the JAX package and torch blocked: the static half imports
    none of them."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=config.root, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=config.root),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith("R1 ")
    assert "R16" in proc.stdout
