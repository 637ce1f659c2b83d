"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem, _fusion_mode
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.normalization import build_normalization

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_CHECK = r"""
import sys
import photon_ml_tpu_torch
import photon_ml_tpu_torch.convert, photon_ml_tpu_torch.device
import photon_ml_tpu_torch.evaluation.device, photon_ml_tpu_torch.game.problem
import photon_ml_tpu_torch.ops.cuda_lib, photon_ml_tpu_torch.ops.fused_glm
import photon_ml_tpu_torch.ops.sparse, photon_ml_tpu_torch.ops.features, photon_ml_tpu_torch.optimize.lbfgs
import photon_ml_tpu_torch.optimize.driver, photon_ml_tpu_torch.optimize.tron
import photon_ml_tpu_torch.optimize.trackers, photon_ml_tpu_torch.game.sampling
import photon_ml_tpu_torch.ops.glm
import photon_ml_tpu_torch.game.coordinate, photon_ml_tpu_torch.game.data
import photon_ml_tpu_torch.game.descent, photon_ml_tpu_torch.models.game
import photon_ml_tpu_torch.io.data, photon_ml_tpu_torch.evaluation.suite
import photon_ml_tpu_torch.parallel, photon_ml_tpu_torch.parallel.mesh
import photon_ml_tpu_torch.parallel.multihost, photon_ml_tpu_torch.ops.lane_reduce
import photon_ml_tpu_torch.io.avro, photon_ml_tpu_torch.io.index_map, photon_ml_tpu_torch.io.model_io
import photon_ml_tpu_torch.io.validators, photon_ml_tpu_torch.io.columns, photon_ml_tpu_torch.io.schemas
import photon_ml_tpu_torch.native, photon_ml_tpu_torch.robust.atomic, photon_ml_tpu_torch.robust.retry
import photon_ml_tpu_torch.utils.futures, photon_ml_tpu_torch.utils.dates, photon_ml_tpu_torch.utils.logging
import photon_ml_tpu_torch.utils.stats, photon_ml_tpu_torch.testing.generators
import photon_ml_tpu_torch.estimators.model_training, photon_ml_tpu_torch.cli.params
import photon_ml_tpu_torch.cli.glm, photon_ml_tpu_torch.cli.index
import photon_ml_tpu_torch.cli.train, photon_ml_tpu_torch.cli.score, photon_ml_tpu_torch.cli.feature_bags
import photon_ml_tpu_torch.obs, photon_ml_tpu_torch.obs.metrics, photon_ml_tpu_torch.obs.tracing
import photon_ml_tpu_torch.obs.run, photon_ml_tpu_torch.obs.sinks, photon_ml_tpu_torch.utils.events
import photon_ml_tpu_torch.utils.timed, photon_ml_tpu_torch.robust.faults, photon_ml_tpu_torch.robust.checkpoint
import photon_ml_tpu_torch.plan, photon_ml_tpu_torch.plan.planner, photon_ml_tpu_torch.serving
import photon_ml_tpu_torch.serving.engine, photon_ml_tpu_torch.estimators.game_estimator
import photon_ml_tpu_torch.game.lanes, photon_ml_tpu_torch.tuning, photon_ml_tpu_torch.tuning.tuner
import photon_ml_tpu_torch.tuning.search, photon_ml_tpu_torch.tuning.shrink, photon_ml_tpu_torch.tuning.serialization
import photon_ml_tpu_torch.game.incremental, photon_ml_tpu_torch.cli.retrain
import photon_ml_tpu_torch.serving.store, photon_ml_tpu_torch.serving.refresh
sys.path.insert(0, "tests")
import test_torch_parallel_ranks
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m == "photon_ml_tpu" or m.startswith("photon_ml_tpu.")
)
print("BAD:" + ",".join(bad))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    line = [l for l in out.splitlines() if l.startswith("BAD:")][-1]
    assert line == "BAD:", f"photon_ml_tpu_torch imported {line[4:]}"


def test_port_sources_name_no_jax_import():
    """No module of the port, not chip_smoke.py and not the card tests or
    the data-parallel rank bodies has an import of jax or of the JAX package (photon_ml_tpu_torch shares the prefix, so match the
    module name exactly)."""
    import ast

    files = sorted((ROOT / "photon_ml_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "test_torch_parallel_ranks.py",
    ]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "photon_ml_tpu"), f"{path}: imports {name}"


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 3), np.float32)
    y = np.zeros(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_from_dense(x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Coefficients.zeros(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.model_from_numpy("logistic_regression", np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_normalization("SCALE_WITH_MAX_MAGNITUDE", None, None, np.ones(3), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GLMProblem("logistic_regression", GLMOptimizationConfig()).zero_model(3)
    # asked for explicitly, the CPU works
    assert batch_from_dense(x, y, device="cpu").device.type == "cpu"


def test_fusion_mode_rule():
    x = np.zeros((4, 3), np.float32)
    y = np.zeros(4, np.float32)
    assert _fusion_mode(batch_from_dense(x, y, device="cpu")) == ("plain_cpu", None)
    meta = batch_from_dense(x, y, device="cpu")
    meta = type(meta)(
        features=type(meta.features)(dim=3, dense=torch.zeros((4, 3), device="meta")),
        labels=meta.labels, offsets=meta.offsets, weights=meta.weights,
    )
    with pytest.raises(ValueError):
        _fusion_mode(meta)
