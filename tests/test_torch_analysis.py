"""The port's static analysis and runtime transfer guard
(``photon_ml_tpu_torch.analysis``), held against the JAX package's
(``photon_ml_tpu.analysis``).

Every test of tests/test_analysis.py has a counterpart here:

- the framework-neutral rules (R4, R5, R7, R9-R14 and the suppression
  machinery) run the JAX suite's own source fixtures through both packages'
  analyzers, which must report the same findings — rule, file, line, column
  and message — besides what the JAX test expects of them;
- the rules the port reads in torch (R1, R2, R3, R6, R8, R15) get torch
  fixtures that mirror the JAX cases: fires, silent outside the scoped
  modules, suppressed inline, clean through the explicit fetch;
- baseline, config, CLI, R10, R16 and cache mechanics run through the
  port's entry points as the JAX tests run through the JAX package's;
- the runtime guard's cases run on a CPU torch with the card's sync-debug
  mode faked (the setter records what it is asked), plus a thread test; the
  raising itself is held on the card in tests/test_torch_cuda.py.
"""

import json
import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import test_analysis as jax_tests
from photon_ml_tpu.analysis import LintConfig as JaxLintConfig
from photon_ml_tpu.analysis import analyze_paths as jax_analyze_paths
from photon_ml_tpu.analysis import analyze_source as jax_analyze_source
from photon_ml_tpu.analysis.project import analyze_project as jax_analyze_project
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.analysis import (
    LintConfig,
    allow_transfers,
    analyze_paths,
    analyze_source,
    guard_level,
    load_baseline,
    load_config,
    logged_fetch,
    transfer_guard,
    write_baseline,
)
from photon_ml_tpu_torch.analysis import runtime
from photon_ml_tpu_torch.analysis.cli import JSON_SCHEMA_VERSION
from photon_ml_tpu_torch.analysis.cli import main as lint_main
from photon_ml_tpu_torch.analysis.engine import write_fault_inventory, write_refusal_inventory
from photon_ml_tpu_torch.analysis.project import analyze_project, fragment_matches_template
from photon_ml_tpu_torch.analysis.rules import RULES, explain_rule

HOT = "photon_ml_tpu_torch/game/descent.py"  # a hot-loop module
COLD = "photon_ml_tpu_torch/models/somewhere.py"
OPS = "photon_ml_tpu_torch/ops/somekernel.py"  # dtype-strict
TORCH_FREE = "photon_ml_tpu_torch/plan/planner.py"  # torch-free


def findings(src, relpath=COLD, **kwargs):
    return analyze_source(textwrap.dedent(src), relpath, **kwargs)


def rules_of(fs):
    return [f.rule for f in fs if f.active]


def suppressed_of(fs):
    return [f.rule for f in fs if f.suppressed]


def _port_path(jax_relpath):
    return jax_relpath.replace("photon_ml_tpu/", "photon_ml_tpu_torch/", 1)


def _key(fs):
    return [(f.rule, f.line, f.col, f.message, f.suppressed) for f in fs]


# ------------------------------------------ parity: the per-file neutral rules

ATOMIC = jax_tests.ATOMIC
TIMING = jax_tests.TIMING

# (JAX test, relpath in the JAX package, source, active rules, suppressed)
PER_FILE = {
    "test_r4_swallowing_handler": (jax_tests.COLD, """
        def f():
            try:
                work()
            except Exception:
                pass
        """, ["R4"], []),
    "test_r4_bare_except": (jax_tests.COLD, """
        def f():
            try:
                work()
            except:
                log()
        """, ["R4"], []),
    "test_r4_counted_handler_clean": (jax_tests.COLD, """
        def f():
            try:
                work()
            except Exception:
                obs.swallowed_error("site")
        """, [], []),
    "test_r4_reraising_handler_clean": (jax_tests.COLD, """
        def f():
            try:
                work()
            except Exception as e:
                log(e)
                raise
        """, [], []),
    "test_r4_narrow_handler_clean": (jax_tests.COLD, """
        def f():
            try:
                work()
            except ValueError:
                pass
        """, [], []),
    "test_r5_fires_in_atomic_write_module": (ATOMIC, jax_tests.R5_SRC, ["R5"], []),
    "test_r5_fires_in_robust_package": ("photon_ml_tpu/robust/newmod.py", jax_tests.R5_SRC, ["R5"], []),
    "test_r5_silent_outside_atomic_modules": (jax_tests.COLD, jax_tests.R5_SRC, [], []),
    "test_r5_read_mode_clean": (ATOMIC, """
        def f(path):
            with open(path, "rb") as fh:
                return fh.read()
        """, [], []),
    "test_r5_flags_append_exclusive_and_update_modes": (ATOMIC, """
        def f(path):
            a = open(path, "ab")
            b = open(path, mode="x")
            c = open(path, "r+")
        """, ["R5", "R5", "R5"], []),
    "test_r5_nonliteral_mode_flagged": (ATOMIC, """
        def f(path, mode):
            return open(path, mode)
        """, ["R5"], []),
    "test_r5_suppressed_inline": (ATOMIC, """
        def f(path):
            # photon: ignore[R5] — append-only event log, rename would truncate
            return open(path, "a")
        """, [], ["R5"]),
    "test_r5_clean_via_atomic_write": (ATOMIC, """
        from photon_ml_tpu_torch.robust.atomic import atomic_write

        def f(path, doc):
            with atomic_write(path, "w") as fh:
                fh.write(doc)
        """, [], []),
    "test_r7_fires_in_timing_strict_module": (TIMING, jax_tests.R7_SRC, ["R7", "R7"], []),
    "test_r7_silent_outside_timing_strict_modules": (jax_tests.COLD, jax_tests.R7_SRC, [], []),
    "test_r7_catches_aliased_imports": (TIMING, """
        import time as _time
        from time import perf_counter

        def solve():
            a = _time.time()
            b = perf_counter()
            c = _time.monotonic()
        """, ["R7", "R7", "R7"], []),
    "test_r7_span_and_timed_clean": (TIMING, """
        from photon_ml_tpu_torch import obs
        from photon_ml_tpu_torch.utils.timed import timed

        def solve():
            with obs.span("solve", phase="solve") as sp:
                work()
            with timed("score"):
                work()
            return sp.duration_s
        """, [], []),
    "test_r7_suppressed_inline": (TIMING, """
        import time

        def submit(q, req):
            # photon: ignore[R7] — cross-thread enqueue stamp, cannot be a span
            q.put((req, time.perf_counter()))
        """, [], ["R7"]),
    "test_standalone_comment_suppresses_next_line": (jax_tests.COLD, """
        def f():
            try:
                work()
            # photon: ignore[R4] — close() failures are best-effort by contract
            except Exception:
                pass
        """, [], ["R4"]),
    "test_docstring_mention_does_not_suppress": (jax_tests.COLD, '''
        def f():
            """Suppress with  # photon: ignore[R4]  on the offending line."""
            try:
                work()
            except Exception:
                pass
        ''', ["R4"], []),
}


@pytest.mark.parametrize("case", sorted(PER_FILE))
def test_per_file_rules_match_the_jax_package(case):
    """Both analyzers report the same findings on the JAX suite's fixture,
    and what the JAX test expects of it."""
    relpath, src, active, suppressed = PER_FILE[case]
    src = textwrap.dedent(src)
    theirs = jax_analyze_source(src, relpath, config=JaxLintConfig())
    ours = analyze_source(src, _port_path(relpath), config=LintConfig())
    assert _key(ours) == _key(theirs)
    assert rules_of(ours) == active
    assert suppressed_of(ours) == suppressed
    if case == "test_r5_fires_in_atomic_write_module":
        assert "atomic_write" in ours[0].message
    if case == "test_r5_nonliteral_mode_flagged":
        assert "non-literal mode" in ours[0].message
    if case == "test_r7_fires_in_timing_strict_module":
        assert "obs.span" in ours[0].message


def test_unknown_rule_in_ignore_is_an_error():
    src = "x = 1  # photon: ignore[R99]\n"
    with pytest.raises(ValueError, match="unknown rule"):
        jax_analyze_source(src, jax_tests.COLD)
    with pytest.raises(ValueError, match="unknown rule"):
        findings(src)


# ---------------------------------------------------------------- R1 (torch)

R1_SRC = """
    import torch

    def f(scores):
        s = torch.sum(scores)
        return float(s)
    """


def test_r1_fires_in_hot_module():
    fs = findings(R1_SRC, HOT)
    assert rules_of(fs) == ["R1"]
    assert fs[0].code == "return float(s)"


def test_r1_silent_outside_hot_modules():
    assert rules_of(findings(R1_SRC, COLD)) == []


def test_r1_suppressed_inline():
    src = """
    import torch

    def f(scores):
        s = torch.sum(scores)
        return float(s)  # photon: ignore[R1]
    """
    fs = findings(src, HOT)
    assert rules_of(fs) == []
    assert suppressed_of(fs) == ["R1"]


@pytest.mark.parametrize("fetch", [
    "float(logged_fetch('cd.loss', s))",
    "float(fetch('cd.loss', [s])[0])",
    "float(device_get(s))",
])
def test_r1_clean_via_explicit_fetch(fetch):
    src = f"""
    import torch
    from photon_ml_tpu_torch.analysis.runtime import device_get, logged_fetch
    from photon_ml_tpu_torch.device import fetch

    def f(scores):
        s = torch.sum(scores)
        return {fetch}
    """
    assert rules_of(findings(src, HOT)) == []


def test_r1_np_asarray_on_device_value():
    src = """
    import numpy as np
    import torch

    def f(scores):
        s = torch.cumsum(scores, 0)
        return np.asarray(s)
    """
    assert rules_of(findings(src, HOT)) == ["R1"]


def test_r1_annotation_taint_and_item():
    src = """
    from torch import Tensor

    def f(x: Tensor):
        return x.item()
    """
    assert rules_of(findings(src, HOT)) == ["R1"]


def test_r1_host_attrs_stop_taint():
    src = """
    import torch

    def f(scores):
        s = torch.sum(scores, 0)
        return float(s.shape[0]) + int(s.numel()) + int(s.dim())
    """
    assert rules_of(findings(src, HOT)) == []


@pytest.mark.parametrize("expr", ["x.tolist()", "x.numpy()", "x.cpu()", 'x.to("cpu")',
                                  'x.to(device="cpu")', 'x.to(torch.device("cpu"))'])
def test_r1_flags_the_torch_host_copies(expr):
    src = f"""
    import torch

    def f(x: torch.Tensor):
        return {expr}
    """
    fs = findings(src, HOT)
    assert rules_of(fs) == ["R1"]
    assert "device->host sync" in fs[0].message


def test_r1_branch_and_iteration_on_a_tensor():
    src = """
    import torch
    from typing import Optional, Sequence

    def f(x: Optional[torch.Tensor], parts: Sequence[torch.Tensor]):
        y = torch.exp(x)
        if y.sum() > 0:
            pass
        z = 1 if y.max() else 0
        for v in y:
            pass
        for p in parts:  # a list of tensors: the loop stays on the host
            pass
        if x is None or x.shape[0] == 0:
            return z
    """
    fs = findings(src, HOT)
    assert rules_of(fs) == ["R1", "R1", "R1"]
    assert [f.line for f in fs] == [7, 9, 10]


def test_r1_to_a_card_is_clean():
    src = """
    import torch

    def f(x: torch.Tensor, dev):
        return x.to("cuda"), x.to(dev), x.to(torch.float64)
    """
    assert rules_of(findings(src, HOT)) == []


# ---------------------------------------------------------------- R2 (torch)


def test_r2_branch_on_tensor_in_graph_capture():
    src = """
    import torch

    def f(x: torch.Tensor, y: torch.Tensor, g):
        with torch.cuda.graph(g):
            if x.sum() > 0:
                y.copy_(x)
        if x.sum() > 0:  # outside the capture: R1's business
            pass
    """
    fs = findings(src)
    assert rules_of(fs) == ["R2"]
    assert fs[0].line == 6 and "replayed" in fs[0].message


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()", "x.item()", "x.cpu()", "float(x)",
                                  "x.nonzero()", "torch.unique(x)", "stream.synchronize()"])
def test_r2_sync_inside_capture_begin_end(call):
    src = f"""
    import torch

    def f(x: torch.Tensor, g, stream):
        g.capture_begin()
        y = x * 2
        {call}
        g.capture_end()
        {call}
    """
    fs = findings(src)
    assert rules_of(fs) == ["R2"]
    assert fs[0].line == 7 and "illegal while the stream captures" in fs[0].message


def test_r2_fstring_of_tensor_in_capture():
    src = """
    import torch

    def f(x: torch.Tensor, g):
        with torch.cuda.graph(g):
            print(f"value is {x}")
    """
    assert rules_of(findings(src)) == ["R2"]


def test_r2_clean_capture():
    src = """
    import torch

    def f(x: torch.Tensor, y: torch.Tensor, n: int, g):
        with torch.cuda.graph(g):
            if n > 3:
                y.copy_(torch.where(x > 0, x, y) * n)
            if x.shape[0] > 1:
                y.mul_(2)
        g.replay()
    """
    assert rules_of(findings(src)) == []


# ---------------------------------------------------------------- R3


def test_r3_hardcoded_itemsize():
    src = """
    def block_bytes(n_rows, n_cols):
        total_bytes = n_rows * n_cols * 4
        return total_bytes
    """
    assert rules_of(findings(src)) == ["R3"]


def test_r3_itemsize_needs_byte_context():
    src = """
    def quadruple(n):
        total = n * 4
        return total
    """
    assert rules_of(findings(src)) == []


def test_r3_float32_literal_cast():
    src = """
    import numpy as np

    def f(x):
        return x.astype(np.float32)
    """
    assert rules_of(findings(src)) == ["R3"]


@pytest.mark.parametrize("call", ["torch.tensor(x)", "torch.as_tensor(x)", "torch.as_tensor(x, device=dev)"])
def test_r3_dtype_strict_constructor(call):
    src = f"""
    import torch

    def f(x, dev):
        return {call}
    """
    assert rules_of(findings(src, OPS)) == ["R3"]
    assert rules_of(findings(src, COLD)) == []  # only strict modules


@pytest.mark.parametrize("call", ["torch.tensor(x, dtype=torch.int32)", "torch.as_tensor(x, torch.int32)",
                                  "torch.as_tensor(x, dtype=x.dtype, device=dev)"])
def test_r3_constructor_with_dtype_clean(call):
    src = f"""
    import torch

    def f(x, dev):
        return {call}
    """
    assert rules_of(findings(src, OPS)) == []


# ---------------------------------------------------------------- R6 (torch)


def test_r6_nan_compare_fires_anywhere():
    src = """
    import math
    import numpy as np
    import torch

    def f(x):
        if x == torch.nan:
            return 0
        if x != np.nan:
            return 1
        if x == math.nan:
            return 2
        if x == float("nan"):
            return 3
    """
    fs = findings(src, COLD)
    assert rules_of(fs) == ["R6"] * 4
    assert "IEEE 754" in fs[0].message


def test_r6_ordinary_compares_clean():
    src = """
    import torch

    def f(x, nan_count):
        if nan_count == 0 and x != 1.0:
            return torch.isnan(x)
    """
    assert rules_of(findings(src, COLD)) == []


@pytest.mark.parametrize("patch", ["torch.where(torch.isnan(x), 0.0, x)", "torch.where(x.isnan(), 0.0, x)",
                                   "torch.nan_to_num(x)", "x.nan_to_num_(0.0)"])
def test_r6_uncounted_isnan_patch_fires_in_hot_module(patch):
    src = f"""
    import torch

    def patch(x):
        return {patch}
    """
    fs = findings(src, HOT)
    assert rules_of(fs) == ["R6"]
    assert "counter" in fs[0].message


def test_r6_isnan_patch_silent_outside_hot_modules():
    src = """
    import torch

    def patch(x):
        return torch.where(torch.isnan(x), 0.0, x)
    """
    assert rules_of(findings(src, COLD)) == []


def test_r6_counted_isnan_patch_clean():
    src = """
    import torch
    from photon_ml_tpu_torch import obs

    def patch(x):
        y = torch.where(torch.isnan(x), 0.0, x)
        obs.current_run().registry.counter("c", "h").inc()
        return y
    """
    assert rules_of(findings(src, HOT)) == []


def test_r6_isfinite_where_clean():
    src = """
    import torch

    def commit(x, new):
        return torch.where(torch.isfinite(new), new, x)
    """
    assert rules_of(findings(src, HOT)) == []


def test_r6_suppressed_inline():
    src = """
    import torch

    def patch(x):
        # photon: ignore[R6] — display-only path, NaNs already counted upstream
        return torch.where(torch.isnan(x), 0.0, x)
    """
    fs = findings(src, HOT)
    assert rules_of(fs) == []
    assert suppressed_of(fs) == ["R6"]


# ---------------------------------------------------------------- R8 (torch)

R8_SRC = """
    import jax
    import jax.numpy as jnp
    from jax import tree_util
    import photon_ml_tpu
    from photon_ml_tpu.analysis import rules
    import jaxlib
    import photon_ml_tpu_torch
    """


def test_r8_fires_on_jax_and_the_jax_package_anywhere():
    fs = findings(R8_SRC, COLD)
    assert rules_of(fs) == ["R8"] * 6
    assert [f.line for f in fs] == [2, 3, 4, 5, 6, 7]
    assert "imports neither JAX nor the JAX package" in fs[0].message


def test_r8_fires_on_function_level_and_type_checking_jax_imports():
    src = """
    from typing import TYPE_CHECKING

    if TYPE_CHECKING:
        import jax

    def f():
        from photon_ml_tpu import obs
    """
    assert rules_of(findings(src, COLD)) == ["R8", "R8"]


R8_TORCH_SRC = """
    import torch
    import torch.nn.functional as F
    from torch import Tensor
    """


def test_r8_fires_on_torch_in_a_torch_free_module():
    fs = findings(R8_TORCH_SRC, TORCH_FREE)
    assert rules_of(fs) == ["R8", "R8", "R8"]
    assert "torch-free" in fs[0].message


def test_r8_torch_silent_outside_torch_free_modules():
    assert rules_of(findings(R8_TORCH_SRC, COLD)) == []


def test_r8_allows_function_level_and_type_checking_torch_imports():
    src = """
    from typing import TYPE_CHECKING

    if TYPE_CHECKING:
        import torch

    def fetch(x):
        import torch

        return torch.as_tensor(x)
    """
    assert rules_of(findings(src, TORCH_FREE)) == []


def test_r8_catches_try_guarded_and_nested_module_imports():
    src = """
    try:
        import torch
    except ImportError:
        torch = None

    if True:
        from torch.utils import data
    """
    assert rules_of(findings(src, TORCH_FREE)) == ["R8", "R8"]


def test_r8_suppressed_inline():
    src = """
    import torch  # photon: ignore[R8]
    """
    fs = findings(src, TORCH_FREE)
    assert rules_of(fs) == []
    assert suppressed_of(fs) == ["R8"]


def test_r8_torch_free_modules_lint_clean():
    """The shipped torch-free modules satisfy their own rule, the port's
    whole tree imports no JAX, and each module declared torch-free really
    imports without torch."""
    import subprocess

    config = load_config()
    declared = []
    for rel in sorted(_package_sources(config)):
        with open(os.path.join(config.root, rel), encoding="utf-8") as f:
            fs = analyze_source(f.read(), rel, config=config, rules=["R8"])
        assert rules_of(fs) == [], rel
        if config.is_torch_free(rel):
            declared.append(rel)
    assert {"photon_ml_tpu_torch/analysis/rules.py", "photon_ml_tpu_torch/plan/planner.py"} <= set(declared)
    modules = [r[:-3].replace("/", ".").removesuffix(".__init__") for r in declared]
    code = "import sys; sys.modules['torch'] = None\n" + "".join(f"import {m}\n" for m in modules)
    subprocess.run([sys.executable, "-c", code], cwd=config.root, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=config.root))


def _package_sources(config):
    from photon_ml_tpu_torch.analysis.engine import iter_python_files

    root = os.path.abspath(config.root)
    return {os.path.relpath(p, root).replace(os.sep, "/") for p in iter_python_files(config.paths, config)}


# ---------------------------------------------------------------- baseline


def _mini_repo(tmp_path, source=jax_tests.BAD_MODULE):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(source)
    return LintConfig(paths=("pkg",), root=str(tmp_path), baseline="lint_baseline.json")


def test_baseline_roundtrip(tmp_path):
    cfg = _mini_repo(tmp_path)
    result = analyze_paths(config=cfg)
    assert [f.rule for f in result.active] == ["R4"]
    write_baseline(result.findings, cfg.baseline_path)
    again = analyze_paths(config=cfg, baseline=load_baseline(cfg.baseline_path))
    assert again.active == []
    assert [f.rule for f in again.findings if f.baselined] == ["R4"]


def test_baseline_is_a_multiset(tmp_path):
    cfg = _mini_repo(tmp_path)
    write_baseline(analyze_paths(config=cfg).findings, cfg.baseline_path)
    (tmp_path / "pkg" / "mod.py").write_text(
        jax_tests.BAD_MODULE + jax_tests.BAD_MODULE.replace("f()", "g()"))
    result = analyze_paths(config=cfg, baseline=load_baseline(cfg.baseline_path))
    assert len([f for f in result.findings if f.rule == "R4"]) == 2
    assert len(result.active) == 1


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(str(tmp_path / "nope.json")) == {}


# ---------------------------------------------------------------- config


def test_load_config_from_pyproject(tmp_path):
    py = tmp_path / "pyproject.toml"
    py.write_text(textwrap.dedent("""
        [project]
        name = "x"

        [tool.photon-lint]
        paths = ["pkg"]
        baseline = "base.json"
        hot_loop_modules = [
            "pkg/hot.py",  # trailing comment
            "pkg/loops/*",
        ]
        torch_free_modules = ["pkg/light.py"]
        fault_tests = "tests/test_*.py"
        """))
    cfg = load_config(pyproject=str(py))
    assert cfg.paths == ("pkg",)
    assert cfg.baseline == "base.json"
    assert cfg.hot_loop_modules == ("pkg/hot.py", "pkg/loops/*")
    assert cfg.is_hot("pkg/loops/inner.py") and not cfg.is_hot("pkg/cold.py")
    assert cfg.is_torch_free("pkg/light.py") and not cfg.is_torch_free("pkg/hot.py")
    assert cfg.fault_tests == "tests/test_*.py"
    assert cfg.thread_entrypoints == ()
    assert cfg.root == str(tmp_path)


def test_load_config_rejects_unknown_keys(tmp_path):
    py = tmp_path / "pyproject.toml"
    py.write_text("[tool.photon-lint]\ntypo_key = 1\n")
    with pytest.raises(ValueError, match="unknown keys"):
        load_config(pyproject=str(py))
    # the JAX package's key for its R8 scope is not the port's
    py.write_text('[tool.photon-lint]\njax_free_modules = ["x"]\n')
    with pytest.raises(ValueError, match="unknown keys"):
        load_config(pyproject=str(py))


def test_default_config_is_the_ports():
    cfg = load_config()
    assert cfg.paths == ("photon_ml_tpu_torch",)
    assert os.path.isfile(os.path.join(cfg.root, "photon_ml_tpu_torch", "__init__.py"))
    assert cfg.baseline == "photon_ml_tpu_torch/analysis/lint_baseline.json"
    assert cfg.refusal_inventory == "photon_ml_tpu_torch/analysis/refusals.json"
    assert cfg.fault_inventory == "photon_ml_tpu_torch/robust/fault_sites.json"
    assert cfg.refusal_tests == "tests/test_torch_support_matrix.py"
    assert cfg.is_hot("photon_ml_tpu_torch/game/descent.py")
    assert cfg.is_hot("photon_ml_tpu_torch/parallel/mesh.py")
    assert cfg.is_hot("photon_ml_tpu_torch/game/fe_streaming.py")
    assert not cfg.is_hot("photon_ml_tpu/game/descent.py")
    # the JAX package's lists, with the port's paths
    jax_cfg = jax_tests.load_config(os.path.join(cfg.root, "pyproject.toml"))
    for field, covers in (("hot_loop_modules", cfg.is_hot), ("timing_strict_modules", cfg.is_timing_strict),
                          ("atomic_write_modules", cfg.is_atomic_write), ("dtype_strict_modules", cfg.is_dtype_strict)):
        for pattern in getattr(jax_cfg, field):
            assert covers(_port_path(pattern).replace("*", "example.py")), (field, pattern)
    assert {_port_path(p) for p in jax_cfg.thread_entrypoints} == set(cfg.thread_entrypoints)


# ---------------------------------------------------------------- CLI


def _write_pyproject(tmp_path, extra=""):
    (tmp_path / "pyproject.toml").write_text('[tool.photon-lint]\npaths = ["pkg"]\n' + extra)
    return str(tmp_path / "pyproject.toml")


def test_cli_exit_codes_and_json(tmp_path, capsys):
    _mini_repo(tmp_path)
    py = _write_pyproject(tmp_path, 'baseline = "lint_baseline.json"\n')
    assert lint_main(["--config", py, "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["active"] == 1 and not report["ok"]
    assert report["findings"][0]["rule"] == "R4"
    assert lint_main(["--config", py, "--write-baseline"]) == 0
    capsys.readouterr()
    assert lint_main(["--config", py]) == 0  # baselined now
    assert "baselined" in capsys.readouterr().out
    (tmp_path / "pkg" / "mod.py").write_text("x = 1\n")
    os.remove(tmp_path / "lint_baseline.json")
    assert lint_main(["--config", py]) == 0


def test_cli_rule_filter(tmp_path, capsys):
    _mini_repo(tmp_path)
    py = _write_pyproject(tmp_path)
    assert lint_main(["--config", py, "--rule", "R1"]) == 0
    assert lint_main(["--config", py, "--rule", "R4"]) == 1
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out
    assert "graph capture" in out


def test_cli_parse_error_fails(tmp_path, capsys):
    _mini_repo(tmp_path, source="def broken(:\n")
    py = _write_pyproject(tmp_path)
    assert lint_main(["--config", py]) == 1
    assert "parse error" in capsys.readouterr().err


# ------------------------------------- parity: the whole-program neutral rules


def _both_project(sources, rules, **cfg):
    """Both packages' analyze_project on the same sources and settings;
    asserts they agree on findings, errors and annotations."""
    srcs = {rel: textwrap.dedent(src) for rel, src in sources.items()}
    theirs = jax_analyze_project(srcs, JaxLintConfig(**cfg), rules=rules)
    ours = analyze_project(srcs, LintConfig(**cfg), rules=rules)

    def key(res):
        return (
            [(f.rule, f.file, f.line, f.col, f.message) for f in res.findings],
            sorted(res.errors),
            sorted(res.used_annotations),
            [(a.file, a.line, a.kind, a.lock) for a in res.annotations],
        )

    assert key(ours) == key(theirs)
    return ours


def _with(base, old, new):
    return {rel: src.replace(old, new) for rel, src in base.items()}


LOCKED_WORKER = {"pkg/worker.py": """
    import threading

    class Worker:
        def __init__(self):
            self.lock = threading.Lock()
            self.value = 0
            self.thread = threading.Thread(target=self._work)

        def start(self):
            self.thread.start()

        def _work(self):
            with self.lock:
                self.value = 1

        def read(self):
            with self.lock:
                return self.value
    """}

GUARDED_WORKER = {"pkg/worker.py": """
    import threading

    class Worker:
        def __init__(self):
            self.lock = threading.Lock()
            self.value = 0  # photon: guarded-by[lock]
            self.thread = threading.Thread(target=self._work)

        def start(self):
            self.thread.start()

        def _work(self):
            self.value = 1

        def read(self):
            return self.value
    """}

POOL_JOB = {"pkg/pool.py": """
    from concurrent.futures import ThreadPoolExecutor

    class Job:
        def __init__(self, pool):
            self.progress = 0
            self.pool = pool

        def start(self):
            self.pool.submit(self._run)

        def _run(self):
            self.progress = 1

        def read(self):
            return self.progress
    """}

R14_THREAD = {"pkg/mod.py": """
    import threading


    def spawn(fn):
        t = threading.Thread(target=fn)
        t.start()
    """}

R14_OWNERSHIP = {"pkg/mod.py": """
    import threading


    def spawn(fn):
        t = threading.Thread(target=fn)
        t.start()
        return t


    def spawn_into(fn, registry):
        t = threading.Thread(target=fn)
        t.start()
        registry.append(t)


    def joined(fn):
        t = threading.Thread(target=fn)
        t.start()
        try:
            fn()
        finally:
            t.join()


    def daemon(fn):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
    """}

R14_SOCKET_LEAK = {"pkg/mod.py": """
    import socket


    def serve(path, run):
        sock = socket.socket()
        sock.bind(path)
        with sock:
            run()
    """}

R14_SOCKET_CLEAN = {"pkg/mod.py": """
    import socket


    def serve(path, run):
        sock = socket.socket()
        try:
            sock.bind(path)
        except BaseException:
            sock.close()
            raise
        with sock:
            run()
    """}

_DEADLOCK = jax_tests.DEADLOCK["pkg/locks.py"]

# (JAX test, sources, rules, settings, active rules); what else the JAX
# test asserts is checked in test_project_rules_match_the_jax_package below
PROJECT = {
    "test_r9_flags_unguarded_cross_thread_write": (jax_tests.RACY_WORKER, ("R9",), {}, ["R9"]),
    "test_r9_lock_on_both_sides_is_clean": (LOCKED_WORKER, ("R9",), {}, []),
    "test_r9_guarded_by_annotation_excuses_and_is_marked_used": (GUARDED_WORKER, ("R9",), {}, []),
    "test_r9_thread_confined_annotation_excuses": (
        _with(jax_tests.RACY_WORKER, "self.value = 0", "self.value = 0  # photon: thread-confined"),
        ("R9",), {}, []),
    "test_r9_guarded_by_unknown_lock_is_an_error": (
        _with(jax_tests.RACY_WORKER, "self.value = 0", "self.value = 0  # photon: guarded-by[nope]"),
        ("R9",), {}, None),
    "test_r9_unattached_annotation_is_an_error": (
        {"pkg/mod.py": "def f():\n    x = 1  # photon: thread-confined\n    return x\n"}, ("R9",), {}, None),
    "test_r9_thread_entrypoints_create_worker_roots": (
        jax_tests.SVC, ("R9",), {"thread_entrypoints": ("pkg/svc.py::Svc._poll",)}, ["R9"]),
    "test_r9_thread_entrypoints_create_worker_roots[unconfigured]": (jax_tests.SVC, ("R9",), {}, []),
    "test_r9_unknown_thread_entrypoint_is_an_error": (
        jax_tests.SVC, ("R9",), {"thread_entrypoints": ("pkg/svc.py::Nope.f",)}, None),
    "test_r9_submitted_callable_runs_in_pool_context": (POOL_JOB, ("R9",), {}, ["R9"]),
    "test_r13_flags_lock_order_cycle": (jax_tests.DEADLOCK, ("R13",), {}, ["R13"]),
    "test_r13_lock_order_annotation_excuses_the_vouched_edge": (
        {"pkg/locks.py": _DEADLOCK.replace("def f():", "# photon: lock-order[L1 < L2]\n    def f():")},
        ("R13",), {}, []),
    "test_r13_malformed_annotation_is_a_config_error": (
        {"pkg/locks.py": _DEADLOCK.replace("def f():", "# photon: lock-order[L1 >> L2]\n    def f():")},
        ("R13",), {}, None),
    "test_r13_unknown_lock_name_is_an_error": (
        {"pkg/locks.py": _DEADLOCK.replace("def f():", "# photon: lock-order[L1 < NOPE]\n    def f():")},
        ("R13",), {}, None),
    "test_r13_consistent_nesting_is_clean": (
        {"pkg/locks.py": _DEADLOCK.replace("with L2:\n            h()", "h()")}, ("R13",), {}, []),
    "test_r14_flags_unjoined_thread": (R14_THREAD, ("R14",), {}, ["R14"]),
    "test_r14_ownership_transfer_is_clean": (R14_OWNERSHIP, ("R14",), {}, []),
    "test_r14_flags_exception_path_leak": (R14_SOCKET_LEAK, ("R14",), {}, ["R14"]),
    "test_r14_catch_all_cleanup_handler_is_clean": (R14_SOCKET_CLEAN, ("R14",), {}, []),
}


@pytest.mark.parametrize("case", sorted(PROJECT))
def test_project_rules_match_the_jax_package(case):
    sources, rules, cfg, active = PROJECT[case]
    res = _both_project(sources, rules, **cfg)
    msgs = [f.message for f in res.findings]
    if active is not None:
        assert [f.rule for f in res.findings] == active
        assert res.errors == []
    errors = " | ".join(res.errors)
    if case == "test_r9_flags_unguarded_cross_thread_write":
        assert "Worker.value" in msgs[0] and "no common lock" in msgs[0]
    elif case == "test_r9_guarded_by_annotation_excuses_and_is_marked_used":
        assert res.used_annotations == {("pkg/worker.py", 7)}
    elif case == "test_r9_thread_confined_annotation_excuses":
        assert len(res.used_annotations) == 1
    elif case == "test_r9_guarded_by_unknown_lock_is_an_error":
        assert "names no lock attribute" in errors
    elif case == "test_r9_unattached_annotation_is_an_error":
        assert "not attached" in errors
    elif case == "test_r9_thread_entrypoints_create_worker_roots":
        assert "Svc.state" in msgs[0]
    elif case == "test_r9_unknown_thread_entrypoint_is_an_error":
        assert "thread_entrypoints" in errors
    elif case == "test_r13_flags_lock_order_cycle":
        assert "lock-order cycle" in msgs[0] and "pkg.locks.L1" in msgs[0] and "inside h()" in msgs[0]
    elif case == "test_r13_lock_order_annotation_excuses_the_vouched_edge":
        assert res.used_annotations
    elif case == "test_r13_malformed_annotation_is_a_config_error":
        assert any(e.startswith("annotation:") and "malformed" in e for e in res.errors)
    elif case == "test_r13_unknown_lock_name_is_an_error":
        assert "unknown lock 'NOPE'" in errors and "known:" in errors
    elif case == "test_r14_flags_unjoined_thread":
        assert "thread 't'" in msgs[0] and "spawn()" in msgs[0]
    elif case == "test_r14_flags_exception_path_leak":
        assert "exception escapes serve()" in msgs[0]


# ------------------------------------------------ R10 (refusal-ledger contract)

_R10_CFG = dict(refusal_inventory="refusals.json", refusal_tests="tests/test_support_matrix.py")


def _r10_repo(tmp_path, **kw):
    jax_tests._r10_repo(tmp_path, **kw)
    sources = {"pkg/mod.py": (tmp_path / "pkg" / "mod.py").read_text()}
    return (JaxLintConfig(paths=("pkg",), root=str(tmp_path)),
            LintConfig(paths=("pkg",), root=str(tmp_path), **_R10_CFG), sources)


def _r10(cfgs, sources):
    """R10 from both packages (the same README, pins and inventory); they
    agree on every finding and on the inventory."""
    jax_cfg, cfg = cfgs
    theirs = jax_analyze_project(sources, jax_cfg, rules=("R10",))
    ours = analyze_project(sources, cfg, rules=("R10",))
    assert [(f.file, f.line, f.message) for f in ours.findings] == [
        (f.file, f.line, f.message) for f in theirs.findings]
    assert ours.refusal_inventory == theirs.refusal_inventory
    return ours


def test_r10_consistent_repo_is_clean(tmp_path):
    jax_cfg, cfg, sources = _r10_repo(tmp_path)
    path, n = write_refusal_inventory(cfg)
    assert n == 1 and os.path.isfile(path)
    res = _r10((jax_cfg, cfg), sources)
    assert res.findings == []
    assert res.refusal_inventory["refusals"][0]["modules"] == ["pkg/mod.py"]
    assert res.refusal_inventory["refusals"][0]["exceptions"] == ["ValueError"]


def test_r10_ledger_fragment_with_no_raise_site(tmp_path):
    jax_cfg, cfg, sources = _r10_repo(tmp_path, ledger_rows=(
        "| lbfgs + box | `lbfgs with box constraints is not supported` | `pkg/mod.py` |\n"
        "| ghost | `this refusal is enforced nowhere` | `pkg/mod.py` |\n"))
    write_refusal_inventory(cfg)
    msgs = [f.message for f in _r10((jax_cfg, cfg), sources).findings]
    assert any("matches no raise site" in m for m in msgs)
    assert any("pinned by no" in m for m in msgs)


def test_r10_pin_with_no_ledger_row(tmp_path):
    jax_cfg, cfg, sources = _r10_repo(tmp_path, pins=jax_tests.R10_PINS.replace(
        "]\n", '    ("ghost", "pinned but undocumented", ValueError),\n]\n'))
    write_refusal_inventory(cfg)
    res = _r10((jax_cfg, cfg), sources)
    assert [f.file for f in res.findings] == ["tests/test_support_matrix.py"]
    assert "appears in no refusal-ledger row" in res.findings[0].message


def test_r10_refusal_phrased_raise_must_be_documented(tmp_path):
    jax_cfg, cfg, sources = _r10_repo(tmp_path, module_src=jax_tests.R10_MODULE + '''

def other(layout):
    if layout == "tiled":
        raise ValueError(f"layout {layout} is not supported here")
''')
    write_refusal_inventory(cfg)
    res = _r10((jax_cfg, cfg), sources)
    assert len(res.findings) == 1
    assert res.findings[0].file == "pkg/mod.py"
    assert "matches no refusal-ledger row" in res.findings[0].message


def test_r10_inventory_staleness_is_byte_exact(tmp_path):
    jax_cfg, cfg, sources = _r10_repo(tmp_path)
    msgs = [f.message for f in _r10((jax_cfg, cfg), sources).findings]
    assert any("refusal inventory is missing" in m for m in msgs)
    path, _ = write_refusal_inventory(cfg)
    assert _r10((jax_cfg, cfg), sources).findings == []
    with open(path, "a") as f:
        f.write("\n")
    msgs = [f.message for f in _r10((jax_cfg, cfg), sources).findings]
    assert any("refusal inventory is stale" in m for m in msgs)


def test_r10_skipped_without_a_ledger(tmp_path):
    cfg = LintConfig(paths=("pkg",), root=str(tmp_path))
    res = analyze_project({"pkg/mod.py": textwrap.dedent(jax_tests.R10_MODULE)}, cfg, rules=("R10",))
    assert res.findings == [] and res.refusal_inventory is None


def test_fragment_matches_template():
    from photon_ml_tpu.analysis.project import fragment_matches_template as jax_matches

    segs = ["solver ", None, " does not support box constraints"]
    cases = [("does not support box", segs, True), ("solver", segs, True),
             ("solver lbfgs does not support", segs, True), ("zzz", segs, False),
             ("anything", ["prefix ", None], False), ("does not support ropes", segs, False)]
    for frag, s, want in cases:
        assert fragment_matches_template(frag, s) is want is jax_matches(frag, s)


def test_r10_reads_messages_held_in_constants_and_departures(tmp_path):
    """The port's two readings beyond the JAX package's: a refusal worded
    once in a module constant (raised directly, imported, inside an f-string
    or one branch of a conditional) is a raise site; a pin whose exception
    is None marks a row the port departs from, which needs no raise site."""
    (tmp_path / "README.md").write_text(jax_tests.LEDGER_HEADER + "".join(
        f"| {f} | `{f}` | x |\n" for f in ("alpha is not supported", "beta is not supported",
                                            "gamma is not supported", "delta is not supported")))
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_support_matrix.py").write_text(
        "CASES = [\n" + "".join(f'    ("{f}", "{f} is not supported", {e}),\n'
                                for f, e in (("alpha", "ValueError"), ("beta", "NotImplementedError"),
                                             ("gamma", "NotImplementedError"), ("delta", "None"))) + "]\n")
    words = 'ALPHA = "alpha is not supported"\nBETA = (\n    "beta is not "\n    "supported"\n)\n'
    user = textwrap.dedent('''
        from .words import ALPHA, BETA

        GAMMA = "gamma is not supported"


        def f(kind, where):
            if kind == 0:
                raise ValueError(ALPHA)
            if kind == 1:
                raise NotImplementedError(f"{where}: {BETA}")
            raise NotImplementedError(GAMMA if where else BETA)
    ''')
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "words.py").write_text(words)
    (pkg / "user.py").write_text(user)
    cfg = LintConfig(paths=("pkg",), root=str(tmp_path), **_R10_CFG)
    sources = {"pkg/words.py": words, "pkg/user.py": user}
    write_refusal_inventory(cfg)
    res = analyze_project(sources, cfg, rules=("R10",))
    assert res.findings == []
    modules = {e["fragment"]: e["modules"] for e in res.refusal_inventory["refusals"]}
    assert modules == {"alpha is not supported": ["pkg/user.py"], "beta is not supported": ["pkg/user.py"],
                       "gamma is not supported": ["pkg/user.py"], "delta is not supported": []}
    # without its departure pin the unenforced row is a finding again
    pins = tmp_path / "tests" / "test_support_matrix.py"
    pins.write_text(pins.read_text().replace('"delta", "delta is not supported", None', '"x", "alpha", ValueError'))
    msgs = [f.message for f in analyze_project(sources, cfg, rules=("R10",)).findings]
    assert any("'delta is not supported' matches no raise site" in m for m in msgs)


# ------------------------------------------------ R11 (metric contract)


def _r11(src, config_kw=None):
    cfg = config_kw or {"root": "/nonexistent", "metric_docs": ()}
    return _both_project({"pkg/m.py": src}, ("R11",), **cfg).findings


R11_CASES = {
    "test_r11_counter_must_end_total": ('''
        def f(reg):
            reg.counter("photon_foo", "help").inc()
        ''', "must end in _total"),
    "test_r11_non_counter_must_not_end_total": ('''
        def f(reg):
            reg.gauge("photon_bar_total", "help").set(1)
        ''', "must not end in _total"),
    "test_r11_one_kind_per_family": ('''
        def f(reg):
            reg.counter("photon_x_total", "help").inc()

        def g(reg):
            reg.gauge("photon_x_total", "help").set(1)
        ''', "one family, one kind"),
    "test_r11_label_sets_must_agree": ('''
        def f(reg):
            reg.counter("photon_x_total", "help").labels(site=1).inc()

        def g(reg):
            reg.counter("photon_x_total", "help").labels(kind=2).inc()
        ''', "label keys must agree"),
    "test_r11_reserved_suffixes_rejected": ('''
        def f(reg):
            reg.gauge("photon_x_count", "help").set(1)
        ''', "reserves"),
    "test_r11_consistent_family_is_clean": ('''
        def f(reg):
            reg.counter("photon_x_total", "help").labels(site=1).inc()

        def g(reg):
            reg.counter("photon_x_total", "help").labels(site=2).inc(3)
        ''', None),
}


@pytest.mark.parametrize("case", sorted(R11_CASES))
def test_r11_matches_the_jax_package(case):
    src, want = R11_CASES[case]
    fs = _r11(src)
    if want is None:
        assert fs == []
    else:
        assert any(want in f.message for f in fs)


def test_r11_doc_drift_both_directions(tmp_path):
    (tmp_path / "METRICS.md").write_text("documented: photon_a_total and photon_c_total\n")
    msgs = [f.message for f in _r11('''
        def f(reg):
            reg.counter("photon_a_total", "help").inc()
            reg.counter("photon_b_total", "help").inc()
        ''', {"root": str(tmp_path), "metric_docs": ("METRICS.md",)})]
    assert any("'photon_b_total' is not documented" in m for m in msgs)
    assert any("'photon_c_total' is registered nowhere" in m for m in msgs)
    assert not any("photon_a_total" in m for m in msgs)


def test_r11_dynamic_prefix_families_match_docs_by_prefix(tmp_path):
    src = '''
    def f(reg, direction):
        reg.counter(
            f"photon_dev_{direction}_bytes_total", "help"
        ).labels(site="x").inc()
    '''
    cfg = {"root": str(tmp_path), "metric_docs": ("METRICS.md",)}
    (tmp_path / "METRICS.md").write_text("photon_dev_fetch_bytes_total\n")
    assert _r11(src, cfg) == []
    (tmp_path / "METRICS.md").write_text("no metrics here\n")
    assert any("dynamically-named metric family" in f.message for f in _r11(src, cfg))


# --------------------------------------------- R12 (unused suppressions)


def _both_paths(tmp_path, source, **kw):
    """analyze_paths of both packages over one small tree; they agree."""
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(source)
    theirs = jax_analyze_paths(config=JaxLintConfig(paths=("pkg",), root=str(tmp_path)), **kw)
    ours = analyze_paths(config=LintConfig(paths=("pkg",), root=str(tmp_path)), **kw)
    assert [f.to_dict() for f in ours.findings] == [f.to_dict() for f in theirs.findings]
    return ours


def test_r12_unused_suppression_flagged_on_full_runs(tmp_path):
    result = _both_paths(tmp_path, "x = 1  # photon: ignore[R4]\n")
    assert [f.rule for f in result.active] == ["R12"]
    assert "suppresses no finding" in result.active[0].message
    assert _both_paths(tmp_path, "x = 1  # photon: ignore[R4]\n", paths=("pkg",)).active == []


def test_r12_used_suppression_is_not_flagged(tmp_path):
    src = jax_tests.BAD_MODULE.replace("except Exception:", "except Exception:  # photon: ignore[R4]")
    assert _both_paths(tmp_path, src).active == []


def test_r12_unused_annotation_flagged(tmp_path):
    result = _both_paths(tmp_path, textwrap.dedent("""
        import threading

        class C:
            def __init__(self):
                self.lock = threading.Lock()
                self.x = 0  # photon: thread-confined
        """))
    assert [f.rule for f in result.active] == ["R12"]
    assert "annotation suppresses no R9 finding" in result.active[0].message


def test_unused_lock_order_and_static_arg_annotations_are_r12(tmp_path):
    result = _both_paths(tmp_path, textwrap.dedent("""
        import threading

        L1 = threading.Lock()
        L2 = threading.Lock()


        # photon: lock-order[L1 < L2]
        def f():
            with L1:
                pass
        """))
    assert [f.rule for f in result.active] == ["R12"]
    assert "lock-order annotation suppresses no R13" in result.active[0].message


# --------------------------------------------------- explain / schema


def test_every_rule_has_an_explanation():
    for rule in RULES:
        text = explain_rule(rule)
        assert rule in text
        assert "bad" in text.lower() and "good" in text.lower()
    for rule in ("R1", "R2", "R6", "R8", "R15"):
        assert "torch" in explain_rule(rule)


def test_cli_explain(capsys):
    assert lint_main(["--explain", "R9"]) == 0
    out = capsys.readouterr().out
    assert "R9" in out and "guarded-by" in out
    assert lint_main(["--explain", "R2"]) == 0
    assert "torch.cuda.graph" in capsys.readouterr().out


def test_cli_json_carries_schema_version(tmp_path, capsys):
    _mini_repo(tmp_path)
    py = _write_pyproject(tmp_path)
    assert lint_main(["--config", py, "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["schema_version"] == JSON_SCHEMA_VERSION


def test_cli_write_refusal_inventory(tmp_path, capsys):
    _r10_repo(tmp_path)
    py = _write_pyproject(tmp_path, 'refusal_inventory = "refusals.json"\n'
                          'refusal_tests = "tests/test_support_matrix.py"\n')
    assert lint_main(["--config", py, "--write-refusal-inventory"]) == 0
    assert "wrote 1 refusal(s)" in capsys.readouterr().out
    inv = json.loads((tmp_path / "refusals.json").read_text())
    assert inv["refusals"][0]["modules"] == ["pkg/mod.py"]


def test_cli_write_fault_inventory(tmp_path, capsys):
    _r16_repo(tmp_path)
    py = _write_pyproject(tmp_path, 'fault_inventory = "faults.json"\n')
    assert lint_main(["--config", py, "--write-fault-inventory"]) == 0
    assert "wrote 1 fault site(s)" in capsys.readouterr().out
    assert json.loads((tmp_path / "faults.json").read_text())["sites"][0]["site"] == "demo.boundary"


# --------------------------------------------------------- the runtime guard


class _FakeCard:
    """A card as the guard sees it, on a CPU torch: is_available, and a
    sync-debug mode whose setter records what it is asked."""

    def __init__(self, monkeypatch, start=0):
        self.mode = start
        self.calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.calls.append(mode)
        self.mode = mode


def test_transfer_guard_sets_the_card_mode(monkeypatch):
    """The CPU counterpart of the JAX package's
    test_transfer_guard_blocks_implicit_fetch: on the card the guard puts
    CUDA's sync debug mode at "error" (tests/test_torch_cuda.py holds that
    an implicit fetch then raises) and restores the mode it found."""
    card = _FakeCard(monkeypatch, start="warn")
    with transfer_guard():
        assert card.mode == "error"
        with transfer_guard("log"):
            assert card.mode == "warn"
        assert card.mode == "error"
    assert card.mode == "warn"
    with transfer_guard(device="cpu"):  # a CPU sweep touches nothing
        assert guard_level() == "disallow"
    assert card.calls == ["error", "warn", "error", "warn"]


def test_transfer_guard_is_a_noop_without_a_card():
    assert not torch.cuda.is_available()
    with transfer_guard(device="cuda"):
        assert guard_level() == "disallow"
        x = torch.arange(4.0)
        assert float(x.sum()) == 6.0


def test_transfer_guard_level_plumbing():
    assert guard_level() is None
    with transfer_guard():
        assert guard_level() == "disallow"
        with allow_transfers():
            assert guard_level() == "allow"
        assert guard_level() == "disallow"
    assert guard_level() is None


def test_transfer_guard_level_restored_on_error(monkeypatch):
    card = _FakeCard(monkeypatch)
    with pytest.raises(RuntimeError):
        with transfer_guard():
            raise RuntimeError("boom")
    assert guard_level() is None
    assert card.mode == 0 and not runtime._guards


def test_logged_fetch_allowed_and_counted_under_guard():
    x = torch.arange(8, dtype=torch.float32)
    with obs.use_run(obs.RunTelemetry()) as run:
        with transfer_guard():
            out = logged_fetch("test.fetch", x)
        assert isinstance(out, np.ndarray)
        assert out.nbytes == 32 and np.array_equal(out, x.numpy())
        snap = {(m["name"], m["labels"].get("site")): m["value"] for m in run.registry.snapshot()}
        assert snap[("photon_device_fetch_bytes_total", "test.fetch")] == 32.0


def test_logged_fetch_sequences_and_bfloat16():
    tree = [torch.ones(3, dtype=torch.float64), (torch.zeros(2, dtype=torch.int32), np.ones(5)),
            torch.ones(4, dtype=torch.bfloat16)]
    with obs.use_run(obs.RunTelemetry()) as run:
        out = logged_fetch("test.tree", tree)
        total = run.registry.counter("photon_device_fetch_bytes_total").labels(site="test.tree").value
    assert total == 3 * 8 + 2 * 4 + 4 * 2  # the numpy leaf is not counted
    assert out[0].dtype == np.float64 and isinstance(out[1], tuple) and out[1][1] is tree[1][1]
    assert out[2].dtype == np.float32 and np.array_equal(out[2], np.ones(4))


def test_device_put_stages_values_without_a_lift(monkeypatch):
    """device_put is the JAX package's jax.device_put: the value on the
    device in the dtype asked for, by a non-blocking copy that needs no
    lift of the guard (tests/test_torch_cuda.py holds that it does not
    raise where a blocking upload does)."""
    card = _FakeCard(monkeypatch)
    with transfer_guard():
        a = runtime.device_put(np.arange(3), "cpu", torch.float64)
        b = runtime.device_put(0.5, "cpu", torch.float32)
        c = runtime.device_put(torch.ones(2, dtype=torch.float64), "cpu")
    assert card.calls == ["error", 0]  # the guard in and out, no lift
    assert a.dtype == torch.float64 and a.tolist() == [0.0, 1.0, 2.0]
    assert b.dtype == torch.float32 and b.item() == 0.5
    assert c.dtype == torch.float64 and c.tolist() == [1.0, 1.0]


def test_logged_fetch_numpy_passthrough_uncounted():
    a = np.arange(4.0)
    with obs.use_run(obs.RunTelemetry()) as run:
        out = logged_fetch("test.noop", a)
        assert out is a
        assert run.registry.snapshot() == []


def test_allow_transfers_lifts_guard(monkeypatch):
    card = _FakeCard(monkeypatch)
    x = torch.ones((3,))
    with transfer_guard():
        assert card.mode == "error"
        with allow_transfers():
            assert card.mode == 0
            assert float(torch.sum(x)) == 3.0
        assert card.mode == "error"
    assert card.mode == 0


def test_guard_env_override_off(monkeypatch):
    monkeypatch.setenv("PHOTON_TRANSFER_GUARD", "off")
    card = _FakeCard(monkeypatch)
    with transfer_guard():
        assert guard_level() == "allow"
        assert card.mode == 0
        assert float(torch.ones((2,)).sum()) == 2.0


def test_guard_env_override_log(monkeypatch):
    monkeypatch.setenv("PHOTON_TRANSFER_GUARD", "log")
    card = _FakeCard(monkeypatch)
    with transfer_guard():
        assert guard_level() == "log" and card.mode == "warn"


def test_guard_env_override_invalid(monkeypatch):
    monkeypatch.setenv("PHOTON_TRANSFER_GUARD", "sideways")
    with pytest.raises(ValueError, match="PHOTON_TRANSFER_GUARD"):
        with transfer_guard():
            pass


def test_two_threads_fetching_under_one_guard(monkeypatch):
    """The lift is process-wide: while any thread holds one the mode stays
    0, and the guard's mode comes back only when the last is released.
    Every copy the two threads make runs with the mode at 0, and the mode
    is never restored while a lift is held."""
    card = _FakeCard(monkeypatch)
    restores_under_lift = []
    real_set = card.set

    def checked_set(mode):
        if mode == "error" and runtime._lifts:
            restores_under_lift.append(runtime._lifts)
        real_set(mode)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", checked_set)
    modes_at_copy = []
    real_cpu = torch.Tensor.cpu

    def checking_cpu(self, *a, **k):
        modes_at_copy.append(card.mode)
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", checking_cpu)
    errors = []
    start = threading.Barrier(2)

    def fetcher(k):
        try:
            start.wait()
            for i in range(300):
                out = logged_fetch(f"test.thread{k}", torch.full((64,), float(i)))
                assert out[0] == i
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads' lifts finely
    try:
        with obs.use_run(obs.RunTelemetry()) as run:
            with transfer_guard():
                threads = [threading.Thread(target=fetcher, args=(k,)) for k in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
                assert card.mode == "error"
            counted = [run.registry.counter("photon_device_fetch_bytes_total").labels(site=f"test.thread{k}").value
                       for k in range(2)]
    finally:
        sys.setswitchinterval(switch)
    assert errors == []
    assert modes_at_copy and set(modes_at_copy) == {0}
    assert restores_under_lift == []
    assert counted == [300 * 64 * 4] * 2
    assert card.mode == 0 and runtime._lifts == 0 and not runtime._guards
    # each lift toggles the mode at most once each way: 0 -> lifted ... -> error
    assert card.calls[0] == "error" and card.calls[-1] == 0
    assert all(a != b for a, b in zip(card.calls, card.calls[1:]))


def test_guarded_sweep_matches_an_unguarded_one(monkeypatch):
    """A CoordinateDescent sweep enters the guard (at the level it
    reports) and gives the same models and fetch counters by site with the
    guard on and off."""
    from photon_ml_tpu_torch.game import descent

    levels = []
    real_guard = descent.transfer_guard

    def spying_guard(*a, **k):
        levels.append(runtime._guard_level(a[0] if a else k.get("level", "disallow")))
        return real_guard(*a, **k)

    monkeypatch.setattr(descent, "transfer_guard", spying_guard)
    from test_torch_robust import _cfg  # the robust suite's small GLMix config
    from photon_ml_tpu_torch.evaluation import build_suite
    from photon_ml_tpu_torch.game import (
        CoordinateDescent, FixedEffectCoordinate, RandomEffectCoordinate, ValidationContext,
        build_fixed_effect_dataset, build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.testing import generate_mixed_effect_data
    from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

    raw = mixed_data_to_raw_dataset(generate_mixed_effect_data(n=300, d_fixed=4, re_specs={"userId": (12, 3)},
                                                               seed=5))

    def run(env):
        if env is None:
            monkeypatch.delenv("PHOTON_TRANSFER_GUARD", raising=False)
        else:
            monkeypatch.setenv("PHOTON_TRANSFER_GUARD", env)
        fe = build_fixed_effect_dataset(raw, "global", "global", dtype=torch.float64, device="cpu")
        re = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=torch.float64,
                                         device="cpu")
        coords = {"global": FixedEffectCoordinate(dataset=fe, task="logistic_regression", config=_cfg()),
                  "per-user": RandomEffectCoordinate(dataset=re, task="logistic_regression", config=_cfg())}
        validation = ValidationContext(suite=build_suite(["AUC", "LOGISTIC_LOSS"], raw.labels),
                                       score_fns={n: coords[n].score for n in coords}, offsets=raw.offsets)
        with obs.use_run(obs.RunTelemetry()) as tel:
            res = CoordinateDescent(coords, n_iterations=2, validation=validation).run()
            fetched = {m["labels"]["site"]: m["value"] for m in tel.registry.snapshot()
                       if m["name"] == "photon_device_fetch_bytes_total"}
        return res, fetched

    guarded, g_fetched = run(None)
    off, o_fetched = run("off")
    assert levels == ["disallow"] * 2 + ["allow"] * 2
    assert g_fetched == o_fetched and g_fetched.get("cd.update_guard") == 4 * 16
    assert torch.equal(guarded.model["global"].coefficients.means, off.model["global"].coefficients.means)
    assert torch.equal(guarded.model["per-user"].coef_values, off.model["per-user"].coef_values)


# ------------------------------------------------ R15 (graph-capture reachability)

R15_TP = {"pkg/mod.py": """
    import torch
    from torch import Tensor


    def helper(x: Tensor):
        if x.sum() > 0:
            return torch.log(x)
        return x


    def f(x: Tensor, out: Tensor, g):
        with torch.cuda.graph(g):
            out.copy_(helper(x))
    """}


def proj(sources, rules=("R15",), config=None):
    return analyze_project({rel: textwrap.dedent(src) for rel, src in sources.items()}, config or LintConfig(),
                           rules=rules)


def test_r15_flags_branch_in_capture_reachable_helper():
    res = proj(R15_TP)
    assert [f.rule for f in res.findings] == ["R15"]
    msg = res.findings[0].message
    assert "Python branch on tensor value 'x'" in msg
    assert "helper()" in msg and "reachable from CUDA graph capture in f()" in msg


def test_r15_static_arg_annotation_excuses_the_param():
    res = proj({"pkg/mod.py": """
        import torch
        from torch import Tensor


        def helper(x: Tensor, n: Tensor):  # photon: static-arg[n]
            if n > 3:
                return torch.log(x)
            return x


        def f(x: Tensor, n, out: Tensor, g):
            g.capture_begin()
            out.copy_(helper(x, n))
            g.capture_end()
        """})
    assert res.findings == [] and res.errors == []
    assert res.used_annotations


def test_r15_flags_float_coercion_sync_and_host_mutation():
    res = proj({"pkg/mod.py": """
        import torch
        from torch import Tensor

        count = 0


        def helper(x: Tensor):
            global count
            count = count + 1
            torch.cuda.synchronize()
            return float(x) * 2.0


        def f(x: Tensor, g):
            with torch.cuda.graph(g):
                helper(x)
        """})
    msgs = sorted(f.message for f in res.findings)
    assert len(msgs) == 3
    assert any("float() coercion" in m for m in msgs)
    assert any("torch.cuda.synchronize() syncs the host" in m for m in msgs)
    assert any("write to closed-over 'count'" in m for m in msgs)


def test_r15_unreachable_helper_is_clean():
    src = R15_TP["pkg/mod.py"].replace("with torch.cuda.graph(g):", "if g is not None:")
    assert proj({"pkg/mod.py": src}).findings == []
    # called before the capture: not reachable from it either
    src = R15_TP["pkg/mod.py"].replace("    out.copy_(helper(x))", "    pass\n        helper(x)")
    assert proj({"pkg/mod.py": src}).findings == []


def test_r15_static_arg_on_nonparam_is_an_error():
    res = proj({"pkg/mod.py": """
        import torch
        from torch import Tensor


        def helper(x: Tensor):  # photon: static-arg[nope]
            return x


        def f(x: Tensor, g):
            with torch.cuda.graph(g):
                helper(x)
        """})
    assert any("matches no parameter" in e for e in res.errors)


# ------------------------------------------------ R16 (fault-site inventory)

FAULT_DOCS = jax_tests.FAULT_DOCS
FAULTY_MOD = jax_tests.FAULTY_MOD.replace("photon_ml_tpu.robust", "photon_ml_tpu_torch.robust")


def _r16_repo(tmp_path, docs=FAULT_DOCS, test_literal='"demo.boundary"'):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(FAULTY_MOD)
    (tmp_path / "FAULTS.md").write_text(docs)
    tests = tmp_path / "tests"
    tests.mkdir(exist_ok=True)
    (tests / "test_torch_demo.py").write_text(f"SITE = {test_literal}\n")
    (tests / "test_other.py").write_text('SITE = "demo.boundary"\n')  # not a port test
    cfg = LintConfig(paths=("pkg",), root=str(tmp_path), fault_inventory="faults.json", fault_docs="FAULTS.md")
    return cfg, {"pkg/mod.py": FAULTY_MOD}


def test_r16_consistent_repo_is_clean(tmp_path):
    cfg, sources = _r16_repo(tmp_path)
    path, n = write_fault_inventory(cfg)
    assert n == 1 and os.path.isfile(path)
    assert analyze_project(sources, cfg, rules=("R16",)).findings == []


def test_r16_flags_missing_and_stale_inventory(tmp_path):
    cfg, sources = _r16_repo(tmp_path)
    res = analyze_project(sources, cfg, rules=("R16",))
    assert any("fault inventory is missing" in f.message for f in res.findings)
    path, _ = write_fault_inventory(cfg)
    with open(path, "a") as f:
        f.write("\n")
    res = analyze_project(sources, cfg, rules=("R16",))
    assert any("fault inventory is stale" in f.message for f in res.findings)


def test_r16_flags_undocumented_and_untested_sites(tmp_path):
    """Only the configured test files count: a literal in a test file
    outside tests/test_torch_*.py exercises nothing of the port."""
    cfg, sources = _r16_repo(tmp_path, docs="# Demo\n", test_literal='"unrelated"')
    msgs = [f.message for f in analyze_project(sources, cfg, rules=("R16",)).findings]
    assert any("not documented" in m for m in msgs)
    assert any("no test exercises fault site" in m and "tests/test_torch_*.py" in m for m in msgs)


def test_r16_flags_stale_docs_row(tmp_path):
    cfg, sources = _r16_repo(tmp_path, docs=FAULT_DOCS + "| `demo.renamed` | `pkg/mod.py` | gone |\n")
    msgs = [f.message for f in analyze_project(sources, cfg, rules=("R16",)).findings]
    assert any("documented fault site 'demo.renamed' matches no" in m for m in msgs)


# ------------------------------------------------ incremental cache


def test_cache_results_match_and_edits_reparse(tmp_path):
    cfg = _mini_repo(tmp_path)
    cfg = LintConfig(paths=cfg.paths, root=cfg.root, fault_inventory="faults.json", fault_docs="FAULTS.md")
    cold = analyze_paths(config=cfg, cache=True)
    assert [f.rule for f in cold.active] == ["R4"]
    assert os.path.isdir(os.path.join(str(tmp_path), ".photon-lint-cache"))
    warm = analyze_paths(config=cfg, cache=True)
    assert [f.to_dict() for f in warm.findings] == [f.to_dict() for f in cold.findings]
    (tmp_path / "pkg" / "mod.py").write_text("x = 1\n")
    assert analyze_paths(config=cfg, cache=True).active == []
    # an aux-input edit (the fault docs, a port test file) invalidates the run cache
    (tmp_path / "pkg" / "mod.py").write_text(FAULTY_MOD)
    assert any(f.rule == "R16" for f in analyze_paths(config=cfg, cache=True).active)
    (tmp_path / "FAULTS.md").write_text(FAULT_DOCS)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_demo.py").write_text('SITE = "demo.boundary"\n')
    write_fault_inventory(cfg)
    assert analyze_paths(config=cfg, cache=True).active == []


def test_cache_corrupt_entry_is_a_miss(tmp_path):
    cfg = _mini_repo(tmp_path)
    analyze_paths(config=cfg, cache=True)
    cache_dir = os.path.join(str(tmp_path), ".photon-lint-cache")
    for name in os.listdir(cache_dir):
        with open(os.path.join(cache_dir, name), "wb") as f:
            f.write(b"not a pickle")
    assert [f.rule for f in analyze_paths(config=cfg, cache=True).active] == ["R4"]


# ------------------------------------------------ config-error exit codes


def test_cli_unknown_thread_entrypoint_exits_2(tmp_path, capsys):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text("x = 1\n")
    py = _write_pyproject(tmp_path, 'thread_entrypoints = ["pkg/mod.py::Nope.run"]\n')
    assert lint_main(["--config", py]) == 2
    err = capsys.readouterr().err
    assert "config error:" in err and "thread_entrypoints:" in err
    assert "does not name a known function" in err


def test_cli_malformed_annotation_exits_2(tmp_path, capsys):
    _mini_repo(tmp_path, source=(
        "import threading\n\nL1 = threading.Lock()\n\n\n"
        "# photon: lock-order[L1 >]\ndef f():\n    with L1:\n        pass\n"))
    py = _write_pyproject(tmp_path)
    assert lint_main(["--config", py]) == 2
    err = capsys.readouterr().err
    assert "config error:" in err and "annotation:" in err and "malformed" in err


def test_cli_unreadable_file_exits_1_not_2(tmp_path, capsys):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    os.symlink(str(tmp_path / "gone.py"), str(pkg / "mod.py"))
    py = _write_pyproject(tmp_path)
    assert lint_main(["--config", py]) == 1
    err = capsys.readouterr().err
    assert "parse error:" in err and "cannot read" in err
    assert "config error:" not in err
