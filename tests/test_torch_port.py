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
import importlib
import pkgutil
import sys
import photon_ml_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(photon_ml_tpu_torch.__path__, "photon_ml_tpu_torch."))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "tests")
import test_torch_parallel_ranks
import _torch_tiled_ranks
import _torch_feature_shard_ranks
import _torch_mp_ranks
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m == "photon_ml_tpu" or m.startswith("photon_ml_tpu.")
)
print("MODULES:" + ",".join(names))
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
    # every module of the package was imported, the serving stack included
    modules = set([l for l in out.splitlines() if l.startswith("MODULES:")][-1][8:].split(","))
    files = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "photon_ml_tpu_torch").rglob("*.py")
    } - {"photon_ml_tpu_torch"}
    assert modules == files
    assert {"photon_ml_tpu_torch.serving.batcher", "photon_ml_tpu_torch.cli.serve",
            "photon_ml_tpu_torch.obs.http", "photon_ml_tpu_torch.robust.distributed",
            "photon_ml_tpu_torch.game.data_mp", "photon_ml_tpu_torch.parallel.sparse",
            "photon_ml_tpu_torch.parallel.mesh"} <= modules


def test_port_sources_name_no_jax_import():
    """No module of the port, not chip_smoke.py and not the card tests, the
    data-parallel, cross-process build, streamed, tiled and feature-shard
    rank bodies or the launcher of the multi-process tests has an import of
    jax or of the JAX package (photon_ml_tpu_torch shares the prefix, so
    match the module name exactly)."""
    import ast

    files = sorted((ROOT / "photon_ml_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "test_torch_parallel_ranks.py", ROOT / "tests" / "_torch_mp_ranks.py",
        ROOT / "tests" / "_torch_tiled_ranks.py", ROOT / "tests" / "_torch_mp_common.py",
        ROOT / "tests" / "_torch_feature_shard_ranks.py",
    ]
    assert ROOT / "photon_ml_tpu_torch" / "parallel" / "sparse.py" in files
    assert ROOT / "photon_ml_tpu_torch" / "parallel" / "mesh.py" in files
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


@pytest.mark.parametrize("kind", ["LBFGS", "OWLQN", "LBFGSB", "TRON"])
def test_one_process_solves_keep_their_bits_through_the_axis_hook(kind):
    """Every reduction of a one-problem solve goes through the coefficient
    axis hook (optimize.common): on one process (LOCAL, and a ModelAxis over
    a group of one rank) a total is its partial, so the solve's bits are
    those of the solve without the hook, on the solver tests' problem
    (tests/test_torch_solvers.py's logistic data)."""
    from photon_ml_tpu_torch.ops.glm import GLMObjective
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.optimize import LOCAL, ModelAxis, OptimizerConfig, optimize
    from photon_ml_tpu_torch.parallel import DataParallelGroup

    rng = np.random.default_rng(0)
    n, d = 200, 12
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-x @ rng.standard_normal(d)))).astype(np.float32)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, device="cpu"), l2=0.5)
    box = (torch.full((d,), -0.2), torch.full((d,), 0.2)) if kind == "LBFGSB" else None
    cfg = OptimizerConfig(optimizer_type="TRON" if kind == "TRON" else "LBFGS", tolerance=1e-9,
                          max_iterations=40, l1_weight=0.3 if kind == "OWLQN" else 0.0, box_constraints=box)
    w0 = torch.zeros(d)
    runs = [optimize(obj.value_and_grad, w0, cfg, hvp=obj.hessian_vector, **kw) for kw in (
        {}, {"axis": LOCAL}, {"axis": ModelAxis(DataParallelGroup(0, 1, "cpu", "gloo"))})]
    for r in runs[1:]:
        assert torch.equal(r.coefficients, runs[0].coefficients) and torch.equal(r.loss, runs[0].loss)
        assert (r.iterations, r.reason, r.syncs) == (runs[0].iterations, runs[0].reason, runs[0].syncs)
    parts = (torch.tensor(1.5), torch.tensor(-2.0))
    assert all(a is b for a, b in zip(LOCAL.total(*parts), parts))
