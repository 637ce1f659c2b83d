"""Lint configuration of the port: the defaults below, or a TOML file.

The port's settings live in this module, in one place: every consumer — the
``python -m photon_ml_tpu_torch.analysis`` CLI, the tier-1 self-check test
(tests/test_torch_lint_clean.py) and any editor integration — reads them
through :func:`load_config`, so the hot-loop module list and the baseline
path cannot drift between them. pyproject.toml's ``[tool.photon-lint]``
section belongs to the JAX package's lint; the port reads a
``[tool.photon-lint]`` section only from a file passed with ``--config``
(a vendored copy, or a test's small tree).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import tomllib
from typing import Dict, Optional, Sequence, Tuple

SECTION = "tool.photon-lint"

# The checkout that holds this package: the default root of every path below.
PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# R1 (implicit device transfer) applies here: the modules whose inner loops
# must never block on an unlogged device->host sync. The JAX package's list,
# plus two modules of the port's own (see the comments below).
DEFAULT_HOT_LOOP_MODULES: Tuple[str, ...] = (
    "photon_ml_tpu_torch/game/descent.py",
    "photon_ml_tpu_torch/game/coordinate.py",
    "photon_ml_tpu_torch/game/streaming.py",
    "photon_ml_tpu_torch/game/pipeline.py",
    "photon_ml_tpu_torch/optimize/*",
    # the serving request path: every device->host fetch must be a counted
    # logged_fetch; an implicit sync stalls the resident scorer's microbatch
    "photon_ml_tpu_torch/serving/*",
    # the lane-batched sweep executor and tuning loop: a stray fetch inside
    # the lane CD loop serializes all K trials at once
    "photon_ml_tpu_torch/game/lanes.py",
    "photon_ml_tpu_torch/tuning/*",
    # the day-chain driver: an unlogged fetch stalls the chain between days
    "photon_ml_tpu_torch/game/incremental.py",
    # the planner resolves before any device setup; any device->host traffic
    # there is a bug
    "photon_ml_tpu_torch/plan/*",
    # the port's own: the out-of-core fixed effect streams its row slices
    # through B1/B2 in every evaluation of every solver iteration, so a sync
    # there is paid slices x passes times a sweep
    "photon_ml_tpu_torch/game/fe_streaming.py",
    # the port's own: B4's all-gather and the tiled objective's collectives
    # run in every evaluation across ranks; a host sync there stalls every
    # rank at once
    "photon_ml_tpu_torch/parallel/mesh.py",
)
# R3's torch.tensor/torch.as_tensor-without-dtype subrule applies here: the
# kernel layer, where an implicit default dtype is always a bug.
DEFAULT_DTYPE_STRICT_MODULES: Tuple[str, ...] = ("photon_ml_tpu_torch/ops/*",)
# R5 (non-atomic file write): the persistence layer, where a torn file on
# crash breaks checkpoint/resume guarantees.
DEFAULT_ATOMIC_WRITE_MODULES: Tuple[str, ...] = (
    "photon_ml_tpu_torch/io/*",
    "photon_ml_tpu_torch/robust/*",
)
# R7 (direct wall-clock timing) applies here: the modules whose sections must
# appear on the sweep timeline. The JAX package's list with the port's paths.
DEFAULT_TIMING_STRICT_MODULES: Tuple[str, ...] = (
    "photon_ml_tpu_torch/game/descent.py",
    "photon_ml_tpu_torch/game/coordinate.py",
    "photon_ml_tpu_torch/game/streaming.py",
    "photon_ml_tpu_torch/game/fe_streaming.py",
    "photon_ml_tpu_torch/game/pipeline.py",
    "photon_ml_tpu_torch/game/problem.py",
    "photon_ml_tpu_torch/optimize/*",
    "photon_ml_tpu_torch/serving/*",
    "photon_ml_tpu_torch/utils/futures.py",
    "photon_ml_tpu_torch/plan/*",
    "photon_ml_tpu_torch/io/data.py",
    "photon_ml_tpu_torch/game/lanes.py",
    "photon_ml_tpu_torch/tuning/*",
    "photon_ml_tpu_torch/game/incremental.py",
)
# R8's second half applies here: modules that import without torch and must
# go on doing so (no module-level `import torch`). The lint itself (its
# static half) runs where no torch is installed; the planner resolves before
# any device setup; the tuner is numpy/scipy; the Avro column and schema
# code, the kernel build helper and the plain utilities are host-only.
DEFAULT_TORCH_FREE_MODULES: Tuple[str, ...] = (
    "photon_ml_tpu_torch/__init__.py",
    "photon_ml_tpu_torch/analysis/__init__.py",
    "photon_ml_tpu_torch/analysis/__main__.py",
    "photon_ml_tpu_torch/analysis/cli.py",
    "photon_ml_tpu_torch/analysis/config.py",
    "photon_ml_tpu_torch/analysis/dataflow.py",
    "photon_ml_tpu_torch/analysis/engine.py",
    "photon_ml_tpu_torch/analysis/project.py",
    "photon_ml_tpu_torch/analysis/rules.py",
    "photon_ml_tpu_torch/plan/*",
    "photon_ml_tpu_torch/tuning/*",
    "photon_ml_tpu_torch/io/columns.py",
    "photon_ml_tpu_torch/io/schemas.py",
    "photon_ml_tpu_torch/ops/cuda_lib.py",
    "photon_ml_tpu_torch/native/__init__.py",
    "photon_ml_tpu_torch/testing/generators.py",
    "photon_ml_tpu_torch/utils/dates.py",
    "photon_ml_tpu_torch/utils/events.py",
    "photon_ml_tpu_torch/utils/futures.py",
    "photon_ml_tpu_torch/utils/logging.py",
)
# R9: entrypoints the call graph cannot discover structurally (the JAX
# package's list with the port's paths). ModelSet._install is the
# RefreshWatcher's on_flip callback (each model's poll thread); fleet warm-up
# runs one _open_entry thread per model; the replica front runs a reader
# thread per replica and a maintenance thread; ThreadingHTTPServer runs the
# introspection and fleet handlers on per-request threads; the flight
# recorder hears the training thread, the batcher worker and HTTP threads.
DEFAULT_THREAD_ENTRYPOINTS: Tuple[str, ...] = (
    "photon_ml_tpu_torch/serving/fleet.py::ModelSet._install",
    "photon_ml_tpu_torch/serving/fleet.py::ModelSet._open_entry",
    "photon_ml_tpu_torch/serving/front.py::LeastLoadedFront._read_loop",
    "photon_ml_tpu_torch/serving/front.py::LeastLoadedFront._maintain",
    "photon_ml_tpu_torch/obs/http.py::IntrospectionServer.run",
    "photon_ml_tpu_torch/obs/http.py::IntrospectionServer.statusz",
    "photon_ml_tpu_torch/obs/http.py::IntrospectionServer._render_metrics",
    "photon_ml_tpu_torch/obs/http.py::IntrospectionServer._shed_rate",
    "photon_ml_tpu_torch/obs/fleet.py::FleetAggregator.scrape_once",
    "photon_ml_tpu_torch/obs/fleet.py::FleetAggregator.merged_snapshot",
    "photon_ml_tpu_torch/obs/fleet.py::FleetAggregator.render",
    "photon_ml_tpu_torch/obs/fleet.py::FleetAggregator.statusz",
    "photon_ml_tpu_torch/obs/fleet.py::FleetServer._render_metrics",
    "photon_ml_tpu_torch/obs/flightrec.py::FlightRecorder.handle",
    "photon_ml_tpu_torch/obs/flightrec.py::FlightRecorder.trigger",
)
# the port's own contracts document: its metrics reference (R11) and its
# fault-site table (R16). README.md holds the JAX package's, which the JAX
# lint reads in both directions, so the port's cannot live there.
CONTRACTS_DOC = "photon_ml_tpu_torch/analysis/CONTRACTS.md"


def _match(relpath: str, patterns: Sequence[str]) -> bool:
    """fnmatch against posix relpaths; a pattern naming a directory (no glob
    meta, no .py suffix) matches everything under it."""
    for pat in patterns:
        if fnmatch.fnmatch(relpath, pat):
            return True
        if not any(c in pat for c in "*?[") and not pat.endswith(".py"):
            if relpath == pat or relpath.startswith(pat.rstrip("/") + "/"):
                return True
    return False


@dataclasses.dataclass(frozen=True)
class LintConfig:
    paths: Tuple[str, ...] = ("photon_ml_tpu_torch",)
    baseline: str = "photon_ml_tpu_torch/analysis/lint_baseline.json"
    exclude: Tuple[str, ...] = ()
    hot_loop_modules: Tuple[str, ...] = DEFAULT_HOT_LOOP_MODULES
    dtype_strict_modules: Tuple[str, ...] = DEFAULT_DTYPE_STRICT_MODULES
    atomic_write_modules: Tuple[str, ...] = DEFAULT_ATOMIC_WRITE_MODULES
    timing_strict_modules: Tuple[str, ...] = DEFAULT_TIMING_STRICT_MODULES
    torch_free_modules: Tuple[str, ...] = DEFAULT_TORCH_FREE_MODULES
    # R9: extra thread entrypoints ("path/to/file.py::Class.method") the call
    # graph cannot discover structurally — e.g. a bound method handed to
    # another object's constructor and invoked from that object's thread.
    # Unknown specs are a config error, like an unknown ignore[RULE].
    # The port's own list (DEFAULT_THREAD_ENTRYPOINTS) names functions of
    # the port, so load_config applies it to the port's run only.
    thread_entrypoints: Tuple[str, ...] = ()
    # R10: the refusal-ledger triangle — machine-readable inventory, the
    # README ledger table (shared with the JAX package: the port refuses in
    # its words), and the port's support-matrix test.
    refusal_inventory: str = "photon_ml_tpu_torch/analysis/refusals.json"
    refusal_docs: str = "README.md"
    refusal_tests: str = "tests/test_torch_support_matrix.py"
    # R11: where photon_* series must be documented.
    metric_docs: Tuple[str, ...] = (CONTRACTS_DOC,)
    # R16: the fault-site quadrangle — machine-readable inventory, the
    # fault-site table, and the test files (a directory, or a glob of files)
    # whose string literals must exercise every site.
    fault_inventory: str = "photon_ml_tpu_torch/robust/fault_sites.json"
    fault_docs: str = CONTRACTS_DOC
    fault_tests: str = "tests/test_torch_*.py"
    root: str = "."

    def is_hot(self, relpath: str) -> bool:
        return _match(relpath, self.hot_loop_modules)

    def is_dtype_strict(self, relpath: str) -> bool:
        return _match(relpath, self.dtype_strict_modules)

    def is_atomic_write(self, relpath: str) -> bool:
        return _match(relpath, self.atomic_write_modules)

    def is_timing_strict(self, relpath: str) -> bool:
        return _match(relpath, self.timing_strict_modules)

    def is_torch_free(self, relpath: str) -> bool:
        return _match(relpath, self.torch_free_modules)

    def is_excluded(self, relpath: str) -> bool:
        return _match(relpath, self.exclude)

    @property
    def baseline_path(self) -> str:
        return os.path.join(self.root, self.baseline)


def _read_section(path: str, section: str) -> Dict[str, object]:
    """The values of ``[section]`` (a dotted table name) in a TOML file."""
    with open(path, "rb") as f:
        node: object = tomllib.load(f)
    for part in section.split("."):
        if not isinstance(node, dict) or part not in node:
            return {}
        node = node[part]
    return dict(node) if isinstance(node, dict) else {}


def load_config(
    pyproject: Optional[str] = None, root: Optional[str] = None
) -> LintConfig:
    """The port's settings rooted at the checkout that holds the package, or,
    with ``pyproject``, LintConfig from that file's ``[tool.photon-lint]``
    (rooted at its directory) over the defaults."""
    if pyproject is None:
        return LintConfig(
            root=root or PACKAGE_ROOT,
            thread_entrypoints=DEFAULT_THREAD_ENTRYPOINTS,
        )
    if root is None:
        root = os.path.dirname(os.path.abspath(pyproject)) or "."
    values: Dict[str, object] = {}
    if os.path.isfile(pyproject):
        values = _read_section(pyproject, SECTION)
    known = {f.name for f in dataclasses.fields(LintConfig)} - {"root"}
    unknown = set(values) - {k.replace("-", "_") for k in known} - known
    if unknown:
        raise ValueError(
            f"[{SECTION}] has unknown keys {sorted(unknown)}; expected "
            f"{sorted(known)}"
        )
    kwargs = {}
    for field in known:
        if field in values:
            v = values[field]
            kwargs[field] = tuple(v) if isinstance(v, list) else v
    return LintConfig(root=root, **kwargs)
