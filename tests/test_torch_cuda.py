"""Card-only tests of the port's CUDA kernels and of the slice on the card.

They skip without a CUDA card (decided inside a fixture, so every pytest
worker collects the same tests). On a machine with a card, nvcc and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the rest of the
suite.) This file imports no JAX. Kernels are held against their plain
versions computed in float64 from the same rounded inputs, at the reference
suite's bounds: value rtol 2e-6; gradient, Hv and the Hessian statistics
max-abs error <= 3e-5 * max(|ref|, 1); the Hessian stats' scalar s0 rtol
2e-6. A GLMix sweep on the card is held against the plain versions' sweep
at the solve bounds (fixed effect rtol 1e-3 / atol 1e-5; random effect
coefficients atol 5e-3, loss atol 1e-4 on identical residuals). The
sparse segment kernel is held against its float64 plain version at the
gradient bound and must give the same bits on two launches; a float64 batch
on the card takes the counted ``plain_float64`` route and reaches the CPU's
float64 solve (loss rtol 1e-9). Across processes: ``cli.train
--distributed`` on two gloo ranks sharing the card against the one-process
card fit (each coordinate's accepted loss rtol 1e-5, validation AUC within
2e-3, the random effect keyed by entity id at atol 5e-3), the
cross-rank random-effect build on the card bitwise its CPU build, and the
dense feature-axis shard on a (2 x 2) grid of ranks sharing the card
against the same grid's CPU passes.
"""

import dataclasses
import math

import pytest
import torch

from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem, _fusion_mode
from photon_ml_tpu_torch.ops import fused_glm as fg
from photon_ml_tpu_torch.ops import sparse
from photon_ml_tpu_torch.ops.features import batch_from_coo, batch_from_dense
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fg.reset_launch_counts()
    return torch.device("cuda")


def _inputs(dev, n, d, xdt, seed, poisson=False, base=0):
    """``base``: X starts that many elements into its buffer (1: a base
    pointer off 16 bytes, so the ring body stages tiles with plain loads)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((n * d + base,), generator=g, device=dev).to(xdt)[base:].view(n, d)
    coef = torch.randn(d, generator=g, device=dev) * (0.5 / math.sqrt(d))
    v = torch.randn(d, generator=g, device=dev)
    y = (torch.rand(n, generator=g, device=dev) > 0.5).float() * (2 if poisson else 1)
    off = torch.randn(n, generator=g, device=dev) * 0.1
    wt = torch.rand(n, generator=g, device=dev) + 0.5
    vshift = torch.randn((), generator=g, device=dev) * 0.1
    return x, coef, v, y, off, wt, vshift


def _assert_vec(got, ref, what):
    err = float((got.double() - ref).abs().max())
    bound = 3e-5 * max(float(ref.abs().max()), 1.0)
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


# Ring body edges (f32 d=1,024: 8 rows a tile, bf16: 16; 4 stages): fewer
# rows than a tile, stages x rows and one either side, rows enough for every
# block to wrap the ring; d at and above RING_MAX_D (the staged body); a base
# pointer off 16 bytes (base=1: the ring's plain-load route).
RING_EDGES = [
    (5, 1024, 0), (31, 1024, 0), (32, 1024, 0), (33, 1024, 0), (63, 1024, 0), (64, 1024, 0),
    (65, 1024, 0), (9001, 1024, 0), (300, 1025, 0), (300, 1032, 0), (777, 203, 1), (4097, 256, 1),
]


@pytest.mark.parametrize("loss_name", sorted(LOSSES))
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,base", [(4096, 256, 0), (4099, 256, 0), (777, 203, 0), (5, 1, 0), (33, 4096, 0)] + RING_EDGES)
def test_kernels_match_float64_plain(cuda, loss_name, xdt, n, d, base):
    x, coef, v, y, off, wt, vshift = _inputs(
        cuda, n, d, xdt, seed=n + d, poisson=loss_name == "poisson", base=base
    )
    loss = LOSSES[loss_name]
    val, grad, wdz = fg.fused_value_grad(x, coef, y, off, wt, loss)
    hv, csum = fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)
    torch.cuda.synchronize()
    assert grad.dtype == torch.float32 and grad.shape == (d,) and hv.shape == (d,)
    f64 = torch.float64
    rv, rg, rw = fg.value_grad_plain(x, coef, y, off, wt, loss, compute_dtype=f64)
    rh, rc = fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss, compute_dtype=f64)
    assert abs(float(val) - float(rv)) <= 2e-6 * abs(float(rv)) + 1e-30
    _assert_vec(torch.cat([grad, wdz.reshape(1)]), torch.cat([rg, rw.reshape(1)]), "gradient")
    _assert_vec(torch.cat([hv, csum.reshape(1)]), torch.cat([rh, rc.reshape(1)]), "Hv")
    assert fg.LAUNCHES == {"fused_value_grad": 1, "fused_hessian_vector": 1, "fused_hessian_stats": 0}
    aligned = (d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    route = "staged" if d > fg.RING_MAX_D else ("ring_bulk_copy" if aligned else "ring_plain_loads")
    assert fg.ROUTES == dict({"ring_bulk_copy": 0, "ring_plain_loads": 0, "staged": 0}, **{route: 2})


@pytest.mark.parametrize("need_shifts", [False, True], ids=["no-shifts", "shifts"])
@pytest.mark.parametrize("loss_name", sorted(LOSSES))
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(4096, 256), (4099, 256), (777, 203), (5, 1), (33, 4096)])
def test_hessian_stats_match_float64_plain(cuda, loss_name, xdt, n, d, need_shifts):
    x, coef, _, y, off, wt, _ = _inputs(cuda, n, d, xdt, seed=3 * n + d, poisson=loss_name == "poisson")
    loss = LOSSES[loss_name]
    s2, s1, s0 = fg.fused_hessian_stats(x, coef, y, off, wt, loss, need_shifts)
    torch.cuda.synchronize()
    assert s2.dtype == torch.float32 and s2.shape == (d,)
    r2, r1, r0 = fg.hessian_stats_plain(x, coef, y, off, wt, loss, need_shifts, compute_dtype=torch.float64)
    _assert_vec(s2, r2, "s2")
    if need_shifts:
        _assert_vec(s1, r1, "s1")
        assert abs(float(s0) - float(r0)) <= 2e-6 * abs(float(r0)) + 1e-30
    else:
        assert s1 is None and s0 is None
    assert fg.LAUNCHES == {"fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 1}


def test_hessian_stats_are_bitwise_stable(cuda):
    x, coef, _, y, off, wt, _ = _inputs(cuda, 100_003, 512, torch.float32, seed=4)
    loss = LOSSES["smoothed_hinge"]
    for need_shifts in (False, True):
        a = fg.fused_hessian_stats(x, coef, y, off, wt, loss, need_shifts)
        b = fg.fused_hessian_stats(x, coef, y, off, wt, loss, need_shifts)
        assert all(p is None and q is None or torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 1024])
def test_kernels_are_deterministic_and_ignore_empty_batches(cuda, xdt, d):
    x, coef, v, y, off, wt, vshift = _inputs(cuda, 100_003, d, xdt, seed=1)
    loss = LOSSES["logistic"]
    a = fg.fused_value_grad(x, coef, y, off, wt, loss)
    b = fg.fused_value_grad(x, coef, y, off, wt, loss)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    h1 = fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)
    h2 = fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)
    assert all(torch.equal(p, q) for p, q in zip(h1, h2))
    # zero rows: every sum is 0
    val, grad, wdz = fg.fused_value_grad(x[:0], coef, y[:0], off[:0], wt[:0], loss)
    assert float(val) == 0.0 and float(grad.abs().max()) == 0.0 and float(wdz) == 0.0


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x, coef, v, y, off, wt, vshift = _inputs(cuda, 64, 32, torch.float32, seed=2)
    loss = LOSSES["logistic"]
    with pytest.raises(TypeError):
        fg.fused_value_grad(x.double(), coef, y, off, wt, loss)
    with pytest.raises(ValueError, match="contiguous"):
        fg.fused_value_grad(x.t().contiguous().t(), coef, y, off, wt, loss)
    with pytest.raises(ValueError, match="shape"):
        fg.fused_value_grad(x, coef[:-1], y, off, wt, loss)
    with pytest.raises(ValueError, match="is on"):
        fg.fused_value_grad(x, coef.cpu(), y, off, wt, loss)
    with pytest.raises(RuntimeError, match="fused_glm_plan"):
        wide = torch.zeros((2, 20_000), device=cuda)
        fg.fused_hessian_vector(wide, wide[0], wide[0], y[:2], off[:2], wt[:2], vshift, loss)
    with pytest.raises(RuntimeError, match="fused_glm_plan"):
        fg.fused_hessian_stats(wide, wide[0], y[:2], off[:2], wt[:2], loss, True)
    assert fg.LAUNCHES == {"fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 0}
    # a float64 batch takes the plain versions on the card, counted as its route
    f64_batch = batch_from_dense(x.double(), y, dtype=torch.float64)
    assert _fusion_mode(f64_batch) == ("plain_float64", None)
    assert _fusion_mode(batch_from_dense(x, y)) == ("dense_kernel", None)
    assert fg.OBJECTIVE_ROUTES == {"dense_kernel": 1, "sparse_kernel": 0, "tiled_kernel": 0, "tiled_dense": 0,
                                   "plain_cpu": 0, "plain_float64": 1}
    with pytest.raises(TypeError):
        _fusion_mode(batch_from_dense(x, y, feature_dtype=torch.float16))


def _card_problem(dev, optimizer, n=20_000, d=128):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn((n, d), generator=g, device=dev)
    x[:, -1] = 1.0
    w = torch.randn(d, generator=g, device=dev) / math.sqrt(d)
    y = (torch.rand(n, generator=g, device=dev) < torch.sigmoid(x @ w)).float()
    problem = GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(
            optimizer=OptimizerConfig(optimizer_type=optimizer, tolerance=1e-6, max_iterations=30),
            regularization=RegularizationContext("L2"), reg_weight=1.0,
        ),
    )
    return problem, x, y


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_solve_on_card_matches_plain_and_cpu(cuda, optimizer):
    """f32: the kernels' solve against the plain versions' solve on the card
    and against the CPU's solve, at the reference's end-to-end bound."""
    problem, x, y = _card_problem(cuda, optimizer)
    batch = batch_from_dense(x, y)
    m_k, r_k = problem.run(batch)
    assert fg.LAUNCHES["fused_value_grad"] > 0
    if optimizer == "TRON":
        assert fg.LAUNCHES["fused_hessian_vector"] > 0
    fg.reset_launch_counts()
    m_p, r_p = problem.run(batch, plain=True)
    assert fg.LAUNCHES == {"fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 0}
    m_c, r_c = problem.run(batch_from_dense(x.cpu(), y.cpu(), device="cpu"))
    for other in (m_p, m_c):
        torch.testing.assert_close(
            m_k.coefficients.means.cpu(), other.coefficients.means.cpu(), rtol=1e-3, atol=1e-5
        )
    assert r_k.reason != 0 and math.isfinite(float(r_k.loss))


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_bf16_solve_on_card_reaches_the_f32_optimum(cuda, optimizer):
    """bf16 X: the JAX suite's own bf16 contract (tests/test_bf16_features.py,
    the fused bf16 solve's loss within 1% of the f32 solve's), with the
    loss of each solve measured by the same f32 objective on f32 X."""
    problem, x, y = _card_problem(cuda, optimizer)
    m16, r16 = problem.run(batch_from_dense(x, y, feature_dtype=torch.bfloat16))
    assert fg.LAUNCHES["fused_value_grad"] > 0
    f32_batch = batch_from_dense(x, y)
    m32, _ = problem.run(f32_batch)
    obj = problem.objective(f32_batch)
    l16 = float(obj.value(m16.coefficients.means))
    l32 = float(obj.value(m32.coefficients.means))
    assert math.isfinite(l16) and l16 <= l32 * 1.01


def _glmix_draws(n=20_000, d=64, users=300, d_re=8, seed=9):
    """A small bench-shaped GLMix problem's host arrays: the fixed effect's
    X and labels, and the random effect's rows as a RawDataset."""
    import numpy as np

    from photon_ml_tpu_torch.io.data import RawDataset

    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((n, d), dtype=np.float32)
    gx[:, -1] = 1.0
    probs = 1.0 / np.arange(1, users + 1) ** 1.1
    assign = rng.choice(users, size=n, p=probs / probs.sum())
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    z = gx @ (rng.standard_normal(d) / np.sqrt(d)) + np.einsum(
        "nd,nd->n", ex, rng.standard_normal((users, d_re))[assign] / np.sqrt(d_re)
    )
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    raw = RawDataset(
        n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"u": (np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n), ex.reshape(-1).astype(np.float64))},
        shard_dims={"u": d_re}, id_tags={"userId": np.char.add("u", assign.astype(str)).astype(object)},
    )
    return gx, y, raw


def _glmix_on(dev, n=20_000, d=64, users=300, d_re=8, seed=9):
    """A small bench-shaped GLMix problem built on ``dev``."""
    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinate, FixedEffectDataset, RandomEffectCoordinate,
        build_random_effect_dataset,
    )

    gx, y, raw = _glmix_draws(n, d, users, d_re, seed)
    reg = dict(regularization=RegularizationContext("L2"), reg_weight=1.0)
    fe_cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type="TRON", tolerance=1e-6, max_iterations=10),
        variance_type="SIMPLE", **reg,
    )
    re_cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(tolerance=1e-6, max_iterations=30), **reg)
    fe = FixedEffectCoordinate(
        dataset=FixedEffectDataset("global", "global", batch=batch_from_dense(gx, y, device=dev)),
        task="logistic_regression", config=fe_cfg,
    )
    re_ = RandomEffectCoordinate(
        dataset=build_random_effect_dataset(raw, "per-user", "u", "userId", active_cap=64, device=dev),
        task="logistic_regression", config=re_cfg,
    )
    return {"global": fe, "per-user": re_}


def test_glmix_sweep_on_card_matches_plain(cuda):
    """One GLMix sweep through B1, B2 and B3 on the card, against the same
    sweep with the plain versions forced."""
    import dataclasses

    from photon_ml_tpu_torch.game import CoordinateDescent

    coords = _glmix_on(cuda)
    r_k = CoordinateDescent(coords, n_iterations=1).run()
    assert min(fg.LAUNCHES.values()) > 0 and fg.LAUNCHES["fused_hessian_stats"] == 1
    fg.reset_launch_counts()
    plain = dict(coords, **{"global": dataclasses.replace(coords["global"], plain=True)})
    r_p = CoordinateDescent(plain, n_iterations=1).run()
    assert fg.LAUNCHES == {"fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 0}
    fk, fp = r_k.model["global"].coefficients, r_p.model["global"].coefficients
    torch.testing.assert_close(fk.means, fp.means, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(fk.variances, fp.variances, rtol=1e-3, atol=1e-5)
    # the random effect on identical residuals (chained on two fixed effects
    # a capped user's weighted loss moves with its residual; ROADMAP C4)
    re_model, re_res = plain["per-user"].train(coords["global"].score(r_k.model["global"]), None)
    torch.testing.assert_close(r_k.model["per-user"].coef_values, re_model.coef_values, rtol=0, atol=5e-3)
    torch.testing.assert_close(r_k.solver_results["per-user"].loss, re_res.loss, rtol=0, atol=1e-4)


def _ranks_for(backend):
    """World size of a card test over ranks: two gloo ranks sharing the
    first card, or one NCCL rank per card (NCCL takes no two ranks of one
    card, so it needs two cards or more)."""
    if backend == "gloo":
        return 2
    if torch.cuda.device_count() < 2:
        pytest.skip("one NCCL rank per card needs two cards or more")
    return torch.cuda.device_count()


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_b4_over_ranks_matches_float64_plain(cuda, tmp_path, backend):
    """B4: each rank runs B1-B3 on its rows (n ragged on the ranks) and the
    sums add in rank order; held against the float64 plain versions on the
    whole batch, and rank against rank bitwise."""
    import numpy as np
    import test_torch_parallel_ranks as ranks

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.parallel import spawn

    cuda_lib.load("fused_glm")  # build once here, not in every rank
    n, d, seed = 20_003, 256, 5
    outs = spawn(
        "test_torch_parallel_ranks:b4_on_card", _ranks_for(backend), backend, "cuda", args=(n, d, seed),
        timeout_s=300, store_dir=tmp_path,
    )
    case = ranks.card_case(cuda, n, d, seed)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items() if isinstance(v, np.ndarray)}
    loss, f64 = LOSSES["logistic"], torch.float64
    rows = (t["y"], t["off"], t["wt"])
    rv, rg, rw = fg.value_grad_plain(t["x"], t["coef"], *rows, loss, compute_dtype=f64)
    rh, rc = fg.hessian_vector_plain(t["x"], t["coef"], t["v"], *rows, 0.25, loss, compute_dtype=f64)
    r2, r1, r0 = fg.hessian_stats_plain(t["x"], t["coef"], *rows, loss, True, compute_dtype=f64)
    got = {k: tuple(None if o is None else torch.from_numpy(o).to(cuda) for o in v) for k, v in outs[0]["outs"].items()}
    assert abs(float(got["vg"][0]) - float(rv)) <= 2e-6 * abs(float(rv))
    _assert_vec(torch.cat([got["vg"][1], got["vg"][2].reshape(1)]), torch.cat([rg, rw.reshape(1)]), "gradient")
    _assert_vec(torch.cat([got["hv"][0], got["hv"][1].reshape(1)]), torch.cat([rh, rc.reshape(1)]), "Hv")
    _assert_vec(got["hd"][0], r2, "s2")
    _assert_vec(torch.cat([got["hds"][0], got["hds"][1]]), torch.cat([r2, r1]), "s2, s1")
    assert abs(float(got["hds"][2]) - float(r0)) <= 2e-6 * abs(float(r0))
    for out in outs:
        assert out["launches"] == {"fused_value_grad": 1, "fused_hessian_vector": 1, "fused_hessian_stats": 2}
        assert out["sharded"] == {"sharded_value_grad": 1, "sharded_hessian_vector": 1, "sharded_hessian_stats": 2}
        for k, v in out["outs"].items():
            for a, b in zip(v, outs[0]["outs"][k]):
                assert (a is None and b is None) or np.array_equal(a, b), k


def test_float64_b4_over_ranks_on_card_sums_by_the_plain_version(cuda, tmp_path):
    """A float64 batch over ranks on the card (the route plain_float64, as
    ``cli.train --dtype float64 --distributed`` runs it): B4's plain sweeps
    add their slot rows by the plain rank-order sum, the sum kernel writing
    float32 only; held against the float64 plain versions on the whole
    batch at rtol 1e-12, rank against rank bitwise, no kernel launched."""
    import numpy as np
    import test_torch_parallel_ranks as ranks

    from photon_ml_tpu_torch.parallel import spawn

    n, d, seed = 20_003, 256, 5
    outs = spawn("test_torch_parallel_ranks:b4_float64_on_card", _ranks_for("gloo"), "gloo", "cuda",
                 args=(n, d, seed), timeout_s=300, store_dir=tmp_path)
    case = ranks.card_case(cuda, n, d, seed)
    t = {k: torch.from_numpy(v).to(cuda).double() for k, v in case.items() if isinstance(v, np.ndarray)}
    loss = LOSSES["logistic"]
    rows = (t["y"], t["off"], t["wt"])
    ref = {
        "vg": fg.value_grad_plain(t["x"], t["coef"], *rows, loss),
        "hv": fg.hessian_vector_plain(t["x"], t["coef"], t["v"], *rows, 0.25, loss),
        "hd": fg.hessian_stats_plain(t["x"], t["coef"], *rows, loss, False),
        "hds": fg.hessian_stats_plain(t["x"], t["coef"], *rows, loss, True),
    }
    for k, want in ref.items():
        for got, w in zip(outs[0]["outs"][k], want):
            if w is None:
                assert got is None, k
                continue
            torch.testing.assert_close(torch.from_numpy(np.asarray(got)).to(cuda), w, rtol=1e-12, atol=1e-9)
    for out in outs:
        assert not any(out["launches"].values()) and not any(out["sums"].values())
        for k, v in out["outs"].items():
            assert all(_same_bits(a, b) for a, b in zip(v, outs[0]["outs"][k])), k


def _same_bits(a, b) -> bool:
    """Two numpy outputs (or both None) bitwise equal, 0-d arrays too."""
    import numpy as np

    if a is None or b is None:
        return a is None and b is None
    bits = lambda t: np.ascontiguousarray(t).reshape(-1).view(np.uint8)  # noqa: E731
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(bits(a), bits(b))


@pytest.mark.parametrize("width", [1, 33, 1026, 2049, 1024 * 1024])  # the last: FULL's d x d at d = 1,024
@pytest.mark.parametrize("world", range(1, 9))
def test_rank_order_sum_matches_plain_bitwise(cuda, world, width):
    g = torch.Generator(device=cuda)
    g.manual_seed(world * 10_000 + width)
    scale = 10.0 ** torch.randint(-8, 9, (world, width), generator=g, device=cuda).double()
    slots = torch.randn((world, width), generator=g, device=cuda, dtype=torch.float64) * scale
    got = fg.rank_order_sum(slots)
    want = fg.rank_order_sum_plain(slots.cpu(), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (width,)
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    assert fg.SUM_LAUNCHES == {"rank_order_sum": 1}
    with pytest.raises(TypeError, match="float32"):
        fg.rank_order_sum(slots, torch.float64)
    with pytest.raises(ValueError, match="float64"):
        fg.rank_order_sum(slots.float())
    assert fg.SUM_LAUNCHES == {"rank_order_sum": 1}


@pytest.mark.parametrize("mode", [fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS], ids=["vg", "hv", "hd", "hd_shifts"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,base", [(9001, 1024, 0), (777, 203, 1), (300, 1032, 0)])
def test_finalize_into_the_slot_is_the_widened_f32_output(cuda, mode, xdt, n, d, base):
    """B4's output form: the finalize's float64 slot row equals the f32
    output widened, bitwise, for every body (ring with bulk copies or plain
    loads, staged)."""
    x, coef, v, y, off, wt, vshift = _inputs(cuda, n, d, xdt, seed=n + d + mode, base=base)
    hv = mode == fg.HV
    operands = (x, coef, v if hv else None, y, off, wt, vshift if hv else None, LOSSES["logistic"])
    out = fg._launch(mode, *operands)
    slots = torch.full((3, fg._out_width(mode, d)), float("nan"), dtype=torch.float64, device=cuda)
    got = fg._launch(mode, *operands, slot=slots[1])
    assert got.data_ptr() == slots[1].data_ptr()
    assert torch.equal(slots[1].view(torch.int64), out.double().view(torch.int64))
    assert bool(slots[0].isnan().all()) and bool(slots[2].isnan().all())  # other rows untouched
    with pytest.raises(ValueError, match="slot"):
        fg._launch(mode, *operands, slot=slots[1, 1:])


def test_nccl_b4_call_makes_no_host_synchronize(cuda, tmp_path):
    """One NCCL rank: each B4 call is the rank's kernel, its finalize into
    the slot, one stream-ordered all-gather and one rank-order sum, with no
    host synchronize (CUDA's sync debug mode at "error", and
    torch.cuda.synchronize counted); its outputs are bitwise the unsharded
    call's and the all-reduce formulation's, and collective_seconds then
    reads the four collectives."""
    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.parallel import spawn

    cuda_lib.load("fused_glm")
    (out,) = spawn("test_torch_parallel_ranks:b4_without_host_sync", 1, "nccl", "cuda",
                   args=(20_003, 256, 7), timeout_s=300, store_dir=tmp_path)
    assert out["syncs"] == 0
    assert out["launches"] == {"fused_value_grad": 1, "fused_hessian_vector": 1, "fused_hessian_stats": 2}
    assert out["sharded"] == {"sharded_value_grad": 1, "sharded_hessian_vector": 1, "sharded_hessian_stats": 2}
    assert out["sums"] == {"rank_order_sum": 4}
    assert out["collectives"] == 4 and out["seconds"] >= 0.0
    for other in ("warm", "unsharded", "all_reduce"):
        for k, v in out["got"].items():
            for a, b in zip(v, out[other][k]):
                assert _same_bits(a, b), (other, k)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_b4_on_card_is_bitwise_the_all_reduce_formulation(cuda, tmp_path, backend):
    """B4 over ranks on the card (two gloo ranks sharing it, or one NCCL
    rank per card) against the zero-buffer all-reduce and its loop, on the
    same shards: bitwise, on every rank."""
    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.parallel import spawn

    cuda_lib.load("fused_glm")
    outs = spawn("test_torch_parallel_ranks:b4_on_card_both", _ranks_for(backend), backend, "cuda",
                 args=(20_003, 256, 9), timeout_s=300, store_dir=tmp_path)
    for out in outs:
        for k, v in out["b4"].items():
            for a, b, c in zip(v, out["all_reduce"][k], outs[0]["b4"][k]):
                assert _same_bits(a, b) and _same_bits(a, c), k


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_glmix_sweep_over_ranks_matches_one_card(cuda, tmp_path, backend):
    """One f32 GLMix sweep over sharded datasets on the card (two gloo ranks
    sharing it, or one NCCL rank per card) against the same sweep on one
    card: fixed effect rtol 1e-3 / atol 1e-5, random effect atol 5e-3 and
    loss atol 1e-4 on identical residuals (the one-card random effect
    retrained on the ranks' fixed-effect scores); every rank alike."""
    import numpy as np
    import test_torch_parallel_ranks as ranks

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.parallel import spawn

    cuda_lib.load("fused_glm")
    world = _ranks_for(backend)
    rng = np.random.default_rng(11)
    n, d, users, d_re = 20_003, 64, 300, 8
    gx = rng.standard_normal((n, d)).astype(np.float32)
    gx[:, -1] = 1.0
    probs = 1.0 / np.arange(1, users + 1) ** 1.1
    assign = rng.choice(users, size=n, p=probs / probs.sum())
    ex = rng.standard_normal((n, d_re)).astype(np.float32)
    ex[:, -1] = 1.0
    z = gx @ (rng.standard_normal(d) / np.sqrt(d)) + np.einsum(
        "nd,nd->n", ex, rng.standard_normal((users, d_re))[assign] / np.sqrt(d_re)
    )
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    payload = dict(
        raw=dict(
            n_rows=n, labels=y, offsets=np.zeros(n), weights=np.ones(n),
            shard_coo={"u": (np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n), ex.reshape(-1).astype(np.float64))},
            shard_dims={"u": d_re}, id_tags={"userId": np.char.add("u", assign.astype(str)).astype(object)},
        ),
        gx=gx, fe_opt=dict(optimizer_type="TRON", tolerance=1e-6, max_iterations=10),
        fe_extra=dict(variance_type="SIMPLE"), re_opt=dict(tolerance=1e-6, max_iterations=30),
        re_shard="u", pad_entities=world, active_cap=64, sweeps=1,
    )
    outs = spawn("test_torch_parallel_ranks:descent_on_card", world, backend, "cuda", args=(payload,),
                 timeout_s=300, store_dir=tmp_path)
    for out in outs[1:]:
        for key in ("fe_means", "fe_variances", "re_values", "re_loss", "scores"):
            assert np.array_equal(out[key], outs[0][key]), key
    got = outs[0]
    one = ranks._descent(None, dict(payload, pad_entities=1), torch.float32, sharded=False, device=cuda)
    torch.testing.assert_close(torch.from_numpy(got["fe_means"]), torch.from_numpy(one["fe_means"]), rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(torch.from_numpy(got["fe_variances"]), torch.from_numpy(one["fe_variances"]), rtol=1e-3, atol=1e-5)
    coords = ranks.glmix_coordinates(None, dict(payload, pad_entities=1), torch.float32, sharded=False, device=cuda)
    re_model, re_res = coords["per-user"].train(torch.from_numpy(got["fe_scores"]).to(cuda), None)
    E = re_model.coef_values.shape[0]
    torch.testing.assert_close(torch.from_numpy(got["re_values"][:E]), re_model.coef_values.cpu(), rtol=0, atol=5e-3)
    torch.testing.assert_close(torch.from_numpy(got["re_loss"][:E]), re_res.loss.cpu(), rtol=0, atol=1e-4)


# ------------------------------------------------------------ sparse (S1)


def _sparse_triplets(n, d, seed, per_row=6):
    """Ragged rows (0 to 2 * per_row entries, every 7th row empty), column 3
    in every row (a full column), the last column in none, some repeated
    (row, col) pairs, in a shuffled input order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 * per_row + 1, size=n)
    counts[::7] = 0
    rows = np.concatenate([np.repeat(np.arange(n), counts), np.arange(n)])
    cols = np.concatenate([rng.integers(0, d - 1, size=int(counts.sum())), np.full(n, 3)])
    pick = rng.integers(0, len(rows), size=len(rows) // 20 + 1)
    rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    vals = rng.normal(size=len(rows)) * 0.3
    order = rng.permutation(len(rows))
    y = (rng.random(n) > 0.5).astype(np.float32)
    return rows[order], cols[order], vals[order], y


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("fdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(37, 11), (5000, 300), (20_000, 1_000_000)])
def test_segment_kernel_matches_float64_plain_and_repeats_its_bits(cuda, layout, fdt, n, d):
    rows, cols, vals, y = _sparse_triplets(n, d, seed=n + d)
    f = batch_from_coo(rows, cols, vals, y, d, layout=layout, feature_dtype=fdt).features
    g = torch.Generator(device=cuda)
    g.manual_seed(n)
    w = torch.randn(d, generator=g, device=cuda)
    c = torch.randn(n, generator=g, device=cuda)
    for direction, seg, n_seg, src in (("matvec", f.row_segments, n, w), ("rmatvec", f.col_segments, d, c)):
        for square in ((False,) if direction == "matvec" else (False, True)):
            name = f"{layout}_{'sq_rmatvec' if square else direction}"
            before = sparse.SPARSE_LAUNCHES[name]
            a = sparse.segment_dot(name, seg, n_seg, src, square)
            b = sparse.segment_dot(name, seg, n_seg, src, square)
            torch.cuda.synchronize()
            assert sparse.SPARSE_LAUNCHES[name] == before + 2
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{name}: two launches differ"
            ref = sparse.segment_dot_plain(seg, n_seg, src.double(), square)
            _assert_vec(a, ref, name)
            assert a.shape == (n_seg,) and a.dtype == torch.float32


def _edge_matrix(case, layout, fdt):
    """The segment kernel's edges, as a FeatureMatrix on the card:

    - ``runs``: columns of 1 to 5,000 entries, so that runs of equal keys
      cross lanes (8 entries), warps (a tile of 256) and blocks (8 tiles),
      and a row of 3,000 entries (past LONG_SEGMENT: matvec takes the key
      walk too);
    - ``intercept``: an intercept column, one entry in every row, crossing
      more tiles than one lane of the joins adds alone;
    - ``padding``: ELL rows of 0 to 12 entries, padded in column 0; COO
      padded to a multiple of 4,096 entries in column d - 1 / row 0;
    - ``gaps``: the first 1,000 columns and the last ~100,000 empty, and a
      gap of ~900,000 empty columns between the used ones.
    """
    import numpy as np

    from photon_ml_tpu_torch.ops.features import FeatureMatrix, sorted_coo_matrix

    rng = np.random.default_rng(len(case) + len(layout))
    n, d = 6000, 20_000
    if case == "runs":
        lengths = [1, 7, 8, 9, 255, 256, 257, 511, 2047, 2048, 2049, 5000]
        cols = np.concatenate([np.full(m, 10 + 37 * i) for i, m in enumerate(lengths)] +
                              [rng.integers(0, d, size=20_000), np.arange(3000) % d])
        rows = np.concatenate([rng.integers(0, n, size=sum(lengths) + 20_000), np.full(3000, 17)])
    elif case == "intercept":
        rows = np.concatenate([np.repeat(np.arange(n), 5), np.arange(n)])
        cols = np.concatenate([rng.integers(0, d - 1, size=5 * n), np.full(n, d - 1)])
    elif case == "padding":
        counts = rng.integers(0, 13, size=n)
        rows = np.repeat(np.arange(n), counts)
        cols = rng.integers(1, d, size=rows.size)
    else:
        d = 1_000_000
        rows = rng.integers(0, n, size=30_000)
        cols = np.where(rng.random(30_000) < 0.5, rng.integers(1000, 1100, size=30_000),
                        rng.integers(900_000, 900_010, size=30_000))
    vals = rng.normal(size=rows.size) * 0.3
    if layout == "coo" and case == "padding":
        return sorted_coo_matrix(rows, cols, vals, n, d, dtype=fdt, pad_to_multiple=4096, device="cuda"), n, d
    f = batch_from_coo(rows, cols, vals, np.zeros(n), d, layout=layout, feature_dtype=fdt).features
    if layout == "ell" and case == "padding":
        assert bool((f.idx == 0).any()) and isinstance(f, FeatureMatrix)
    return f, n, d


@pytest.mark.parametrize("case", ["runs", "intercept", "padding", "gaps"])
@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("fdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_segment_kernel_edges_match_float64_plain_and_repeat_their_bits(cuda, case, layout, fdt):
    """Every product (the square too) at the segment kernel's edges against
    its float64 plain version at the gradient bound, the same bits on two
    launches, each launch counted."""
    f, n, d = _edge_matrix(case, layout, fdt)
    if case == "runs":
        assert f.row_segments.keys is not None  # the 3,000-entry row
    if case == "padding" and layout == "coo":
        assert f.row_segments.keys is not None and int(f.coo_cols[-1]) == d - 1
    assert f.col_segments.joins.shape[0] > 0
    g = torch.Generator(device=cuda)
    g.manual_seed(d)
    w = torch.randn(d, generator=g, device=cuda)
    c = torch.randn(n, generator=g, device=cuda)
    for direction, seg, n_seg, src, square in (("matvec", f.row_segments, n, w, False),
                                               ("rmatvec", f.col_segments, d, c, False),
                                               ("sq_rmatvec", f.col_segments, d, c, True)):
        name = f"{layout}_{direction}"
        before = sparse.SPARSE_LAUNCHES[name]
        a = sparse.segment_dot(name, seg, n_seg, src, square)
        b = sparse.segment_dot(name, seg, n_seg, src, square)
        torch.cuda.synchronize()
        assert sparse.SPARSE_LAUNCHES[name] == before + 2
        assert a.shape == (n_seg,) and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{case} {name}: two launches differ"
        _assert_vec(a, sparse.segment_dot_plain(seg, n_seg, src.double(), square), f"{case} {name}")
        if case == "gaps" and direction != "matvec":
            assert not bool(a[:1000].any()) and not bool(a[900_010:].any()) and not bool(a[1100:900_000].any())


@pytest.mark.parametrize("L", [1, 3, 4, 7, 8, 16, 40])
@pytest.mark.parametrize("case", ["runs", "intercept", "padding", "gaps"])
@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("fdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_lane_segment_kernel_matches_float64_plain_and_s1_columns(cuda, case, layout, fdt, L):
    """S2 (matmat and rmatmat) at the segment kernel's edges: against its
    float64 plain version at the gradient bound, each column bitwise S1's
    on that column, the same bits on two launches, each launch counted."""
    f, n, d = _edge_matrix(case, layout, fdt)
    g = torch.Generator(device=cuda)
    g.manual_seed(d + L)
    for direction, single, seg, n_seg, n_src in (("matmat", "matvec", f.row_segments, n, d),
                                                 ("rmatmat", "rmatvec", f.col_segments, d, n)):
        src = torch.randn((n_src, L), generator=g, device=cuda)
        name = f"{layout}_{direction}"
        before = sparse.SPARSE_LAUNCHES[name]
        a = sparse.segment_dot_lanes(name, seg, n_seg, src)
        b = sparse.segment_dot_lanes(name, seg, n_seg, src)
        torch.cuda.synchronize()
        assert sparse.SPARSE_LAUNCHES[name] == before + 2
        assert a.shape == (n_seg, L) and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{case} {name}: two launches differ"
        _assert_vec(a, sparse.segment_dot_plain(seg, n_seg, src.double()), f"{case} {name} L={L}")
        for col in range(L):
            s1 = sparse.segment_dot(f"{layout}_{single}", seg, n_seg, src[:, col].contiguous())
            assert torch.equal(a[:, col].contiguous().view(torch.int32), s1.view(torch.int32)), (
                f"{case} {name} L={L}: column {col} differs from S1's")


def test_lane_segment_kernel_refuses_what_it_does_not_take(cuda):
    f, n, d = _edge_matrix("runs", "coo", torch.float32)
    with pytest.raises(TypeError):
        sparse.segment_dot_lanes("coo_rmatmat", f.col_segments, d, torch.randn(n, device=cuda))
    with pytest.raises(TypeError):
        sparse.segment_dot_lanes("coo_rmatmat", f.col_segments, d, torch.randn((n, 2), device=cuda).double())
    with pytest.raises(KeyError):
        sparse.segment_dot_lanes("coo_rmatvec", f.col_segments, d, torch.randn((n, 2), device=cuda))
    with pytest.raises(KeyError):
        sparse.segment_dot("coo_rmatmat", f.col_segments, d, torch.randn(n, device=cuda))


def test_lane_fit_on_card_matches_the_cpu(cuda):
    """fit_lanes on the card (dense FE and the RE lane solve) against the
    same fit on the CPU: coefficients at the packed solve's bound."""
    import numpy as np

    from photon_ml_tpu_torch.estimators import CoordinateConfig, GameEstimator
    from photon_ml_tpu_torch.testing import generate_mixed_effect_data
    from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

    raw = mixed_data_to_raw_dataset(generate_mixed_effect_data(n=900, d_fixed=6, re_specs={"userId": (12, 3)},
                                                               seed=29))
    opt = OptimizerConfig(tolerance=1e-8, max_iterations=100)
    cfg = GLMOptimizationConfig(optimizer=opt, regularization=RegularizationContext("L2"))
    ccs = [CoordinateConfig(name="global", feature_shard="global", config=cfg),
           CoordinateConfig(name="per-user", feature_shard="userShard", random_effect_type="userId", config=cfg)]
    combos = [{"global": lam, "per-user": lam} for lam in (0.01, 0.1, 1.0, 10.0)]
    fits = {dev: GameEstimator("logistic_regression", ccs, n_cd_iterations=2, device=dev).fit_lanes(raw, combos)
            for dev in ("cuda", "cpu")}
    for card, cpu in zip(fits["cuda"], fits["cpu"]):
        np.testing.assert_allclose(card.model["global"].model.coefficients.means.cpu().numpy(),
                                   cpu.model["global"].model.coefficients.means.numpy(), atol=5e-3, rtol=0)
        np.testing.assert_allclose(card.model["per-user"].coef_values.cpu().numpy(),
                                   cpu.model["per-user"].coef_values.numpy(), atol=5e-3, rtol=0)


def test_segment_kernel_writes_zeros_without_entries(cuda):
    """A key walk over no entries writes every output as 0 (one launch)."""
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    import numpy as np

    seg = sparse.key_segments(np.zeros(0, dtype=np.int32), 5000, empty, torch.zeros(0, device=cuda))
    out = sparse.segment_dot("coo_rmatvec", seg, 5000, torch.randn(10, device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (5000,) and not bool(out.any()) and sparse.SPARSE_LAUNCHES["coo_rmatvec"] == 1


def test_segment_kernel_refuses_what_it_does_not_take(cuda):
    rows, cols, vals, y = _sparse_triplets(50, 20, seed=1)
    f = batch_from_coo(rows, cols, vals, y, 20, layout="coo").features
    seg = f.col_segments
    c = torch.randn(50, device=cuda)
    with pytest.raises(TypeError, match="float32 src"):
        sparse.segment_dot("coo_rmatvec", seg, 20, c.double())
    with pytest.raises(TypeError, match="int32"):
        sparse.segment_dot("coo_rmatvec", seg._replace(gather=seg.gather.long()), 20, c)
    with pytest.raises(ValueError, match="keys"):
        sparse.segment_dot("coo_rmatvec", seg._replace(keys=seg.keys.long()), 20, c)
    with pytest.raises(ValueError, match="keys"):  # fewer outputs than the keys index
        sparse.segment_dot("coo_rmatvec", seg, 19, c)
    with pytest.raises(ValueError, match="joins"):
        sparse.segment_dot("coo_rmatvec", seg._replace(joins=None), 20, c)
    with pytest.raises(ValueError, match="ptr"):
        sparse.segment_dot("coo_matvec", f.row_segments, 49, torch.randn(20, device=cuda))
    with pytest.raises(ValueError, match="is on|are on"):
        sparse.segment_dot("coo_rmatvec", seg._replace(val=seg.val.cpu()), 20, c)
    assert not any(sparse.SPARSE_LAUNCHES.values())
    # a float64 operand of a sparse product on the card is refused unless the
    # caller asks for the plain version (the plain_float64 route does)
    f64 = batch_from_coo(rows, cols, vals, y, 20, dtype=torch.float64, layout="ell").features
    with pytest.raises(TypeError, match="float32 src"):
        f64.rmatvec(c.double())
    with pytest.raises(TypeError, match="float32 or bfloat16 values"):
        f64.rmatvec(c)
    with pytest.raises(TypeError, match="float32 src"):
        f.matvec(torch.zeros(20, dtype=torch.float64, device=cuda))
    out = f64.rmatvec(c.double(), plain=True)
    assert out.dtype == torch.float64 and not any(sparse.SPARSE_LAUNCHES.values())


def _sparse_problem(optimizer, l1=0.0):
    reg = RegularizationContext("L1" if l1 else "L2")
    return GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(
            optimizer=OptimizerConfig(optimizer_type=optimizer, tolerance=1e-6, max_iterations=30),
            regularization=reg, reg_weight=l1 or 1.0, variance_type="SIMPLE",
        ),
    )


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("optimizer,l1", [("TRON", 0.0), ("LBFGS", 0.0), ("LBFGS", 2.0)],
                         ids=["tron", "lbfgs", "owlqn"])
def test_sparse_solve_on_card_runs_the_kernel_and_matches_plain(cuda, layout, optimizer, l1):
    """f32 on the card: the sparse solve through the segment kernel (the
    route ``sparse_kernel``, every product's launches counted), against the
    plain versions on the card by loss (rtol 1e-5) and coefficients at the
    end-to-end bound; two runs give the same bits."""
    import numpy as np

    rows, cols, vals, _ = _sparse_triplets(20_000, 50_000, seed=4)
    rng = np.random.default_rng(4)
    z = np.bincount(rows, weights=vals * rng.normal(size=50_000)[cols] * 3, minlength=20_000)
    y = (rng.random(20_000) < 1 / (1 + np.exp(-z))).astype(np.float32)
    batch = batch_from_coo(rows, cols, vals, y, 50_000, layout=layout)
    problem = _sparse_problem(optimizer, l1)
    m_k, r_k = problem.run(batch)
    assert fg.OBJECTIVE_ROUTES["sparse_kernel"] == 1 and fg.OBJECTIVE_ROUTES["plain_float64"] == 0
    assert sparse.SPARSE_LAUNCHES[f"{layout}_matvec"] > 0 and sparse.SPARSE_LAUNCHES[f"{layout}_rmatvec"] > 0
    assert sparse.SPARSE_LAUNCHES[f"{layout}_sq_rmatvec"] == 1  # SIMPLE variance, once per solve
    m_k2, _ = problem.run(batch)
    assert torch.equal(m_k.coefficients.means, m_k2.coefficients.means)
    fg.reset_launch_counts()
    m_p, r_p = problem.run(batch, plain=True)
    assert not any(sparse.SPARSE_LAUNCHES.values())
    assert abs(float(r_k.loss) - float(r_p.loss)) <= 1e-5 * abs(float(r_p.loss))
    torch.testing.assert_close(m_k.coefficients.means, m_p.coefficients.means, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "ell", "coo"])
def test_float64_batch_on_card_takes_the_counted_plain_route(cuda, layout):
    """ROADMAP C6: a float64 batch trains on the card through the plain
    versions, counted as ``plain_float64``, and reaches the CPU's float64
    solve (loss rtol 1e-9)."""
    rows, cols, vals, y = _sparse_triplets(3000, 40, seed=7)

    def build(device):
        if layout == "dense":
            import numpy as np

            x = np.zeros((3000, 40))
            np.add.at(x, (rows, cols), vals)
            return batch_from_dense(x, y, dtype=torch.float64, device=device)
        return batch_from_coo(rows, cols, vals, y, 40, dtype=torch.float64, layout=layout, device=device)

    problem = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type="TRON", tolerance=1e-9, max_iterations=50),
        regularization=RegularizationContext("L2"), reg_weight=1.0, variance_type="SIMPLE",
    ))
    m_g, r_g = problem.run(build(cuda))
    assert fg.OBJECTIVE_ROUTES == {"dense_kernel": 0, "sparse_kernel": 0, "tiled_kernel": 0, "tiled_dense": 0,
                                   "plain_cpu": 0, "plain_float64": 1}
    assert not any(fg.LAUNCHES.values()) and not any(sparse.SPARSE_LAUNCHES.values())
    m_c, r_c = problem.run(build("cpu"))
    assert abs(float(r_g.loss) - float(r_c.loss)) <= 1e-9 * abs(float(r_c.loss))
    torch.testing.assert_close(m_g.coefficients.means.cpu(), m_c.coefficients.means, rtol=1e-6, atol=1e-9)
    assert m_g.coefficients.means.dtype == torch.float64
    # a fixed-effect coordinate scores such a batch by the plain versions too
    from photon_ml_tpu_torch.game import FixedEffectCoordinate
    from photon_ml_tpu_torch.game.data import FixedEffectDataset
    from photon_ml_tpu_torch.models.game import FixedEffectModel

    fg.reset_launch_counts()
    coords = [FixedEffectCoordinate(FixedEffectDataset("global", "global", build(dev)), "logistic_regression",
                                    problem.config) for dev in (cuda, "cpu")]
    scores = [c.score(FixedEffectModel(m, "global")) for c, m in zip(coords, (m_g, m_c))]
    assert not any(fg.OBJECTIVE_ROUTES.values()) and not any(sparse.SPARSE_LAUNCHES.values())
    assert scores[0].dtype == torch.float64
    torch.testing.assert_close(scores[0].cpu(), scores[1], rtol=1e-6, atol=1e-9)


# ----------------------------------------- solvers, FULL variance, sampling


def test_hessian_matrix_on_card_ignores_tf32_and_matches_float64(cuda):
    """FULL variance at d = 1,024: the Hessian's product runs in float64,
    so TF32 settings leave its bits alone; against the float64 Hessian at
    the Hessian products' bound (max-abs <= 3e-5 * max(|ref|, 1)), and the
    variances against the float64 inverse's diagonal at rtol 1e-3."""
    from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances

    x, coef, _, y, off, wt, _ = _inputs(cuda, 20_000, 1024, torch.float32, 41)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, off, wt, device=cuda), l2=1.0)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        h = obj.hessian_matrix(coef)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        h_tf32 = obj.hessian_matrix(coef)
        var = compute_variances(obj, coef, "FULL")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert h.dtype == torch.float32 and torch.equal(h, h_tf32)
    o64 = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(
        x.double(), y.double(), off.double(), wt.double(), device=cuda), l2=1.0)
    h64 = o64.hessian_matrix(coef.double())
    _assert_vec(h.reshape(-1), h64.reshape(-1), "FULL Hessian")
    var64 = torch.diagonal(torch.linalg.inv(h64))
    torch.testing.assert_close(var.double(), var64, rtol=1e-3, atol=0)
    assert fg.LAUNCHES["fused_hessian_stats"] == 0


def test_full_hessian_over_an_nccl_rank_sums_by_the_kernel(cuda, tmp_path):
    """One NCCL rank at d = 1,024: the float32 Hessian over the group takes
    the rank-order sum kernel (one launch: the d x d partial in one piece)
    and equals the plain route and the unsharded Hessian bitwise; with
    ``plain=True`` no kernel launches; a float64 batch runs only with
    ``plain``, and without it the kernel refuses float64."""
    import numpy as np

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.parallel import spawn

    cuda_lib.load("fused_glm")
    rng = np.random.default_rng(47)
    n, d = 5_000, 1024
    payload = dict(x=rng.standard_normal((n, d)) * 0.1, y=(rng.random(n) > 0.5).astype(np.float64),
                   w=rng.standard_normal(d) * 0.05)
    (out,) = spawn("test_torch_parallel_ranks:full_variance_on_card", 1, "nccl", "cuda", args=(payload,),
                   timeout_s=300, store_dir=tmp_path)
    assert out["launches"] == {"rank_order_sum": 1}
    assert out["kernel"].dtype == np.float32 and out["kernel"].shape == (d, d)
    assert _same_bits(out["kernel"], out["plain"]) and _same_bits(out["kernel"], out["unsharded"])
    assert "float32" in out["float64_refused"]
    assert out["launches_after"] == {"rank_order_sum": 1}
    np.testing.assert_allclose(out["kernel"], out["float64_plain"], rtol=0, atol=3e-5 * max(1.0, np.abs(out["float64_plain"]).max()))


def test_full_variance_solve_on_card_runs_b1_b2_and_not_b3(cuda):
    x, _, _, y, _, _, _ = _inputs(cuda, 30_000, 256, torch.float32, 43)
    problem = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type="TRON", tolerance=1e-6, max_iterations=10),
        regularization=RegularizationContext("L2"), reg_weight=1.0, variance_type="FULL"))
    model, res = problem.run(batch_from_dense(x, y, device=cuda))
    assert fg.LAUNCHES["fused_value_grad"] > 0 and fg.LAUNCHES["fused_hessian_vector"] > 0
    assert fg.LAUNCHES["fused_hessian_stats"] == 0
    fg.reset_launch_counts()
    model_p, _ = problem.run(batch_from_dense(x, y, device=cuda), plain=True)
    assert not any(fg.LAUNCHES.values())
    torch.testing.assert_close(model.coefficients.variances, model_p.coefficients.variances, rtol=1e-3, atol=1e-5)


def _re_blocks(dev, dtype, seed=0, E=300, K=12, S=9):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    F = torch.randn((E, K, S), generator=g, dtype=torch.float64)
    z = torch.einsum("eks,es->ek", F, torch.randn((E, S), generator=g, dtype=torch.float64))
    y = (torch.rand((E, K), generator=g, dtype=torch.float64) < torch.sigmoid(z)).double()
    off = torch.randn((E, K), generator=g, dtype=torch.float64) * 0.1
    wt = torch.ones((E, K), dtype=torch.float64)
    wt[:, 10:] = 0.0
    y[:, 10:] = 0.0
    arrays = [F, y, off, wt, torch.zeros((E, S)), torch.zeros((E, S)), torch.ones((E, S))]
    return [a.to(device=dev, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("mode,opt", [("packed", "TRON"), ("vmapped", "LBFGS"), ("vmapped", "TRON")])
def test_random_effect_solvers_on_card_match_the_cpu(cuda, mode, opt):
    """The packed TRON and the vmapped solves on the card against the same
    solves on the CPU, at the packed solve's bounds (f32: coefficients
    atol 5e-3, loss atol 1e-4)."""
    from photon_ml_tpu_torch.game.coordinate import _train_blocks, _train_blocks_packed

    fn = _train_blocks_packed if mode == "packed" else _train_blocks
    kw = dict(task="logistic_regression", l2=0.1, l1=0.0, optimizer_type=opt, tolerance=1e-7, max_iterations=80,
              num_corrections=10, max_cg_iterations=20, max_improvement_failures=5)
    rc = fn(*_re_blocks(cuda, torch.float32), **kw)
    rh = fn(*_re_blocks("cpu", torch.float32), **kw)
    torch.testing.assert_close(rc.coefficients.cpu(), rh.coefficients, rtol=0, atol=5e-3)
    torch.testing.assert_close(rc.loss.cpu(), rh.loss, rtol=0, atol=1e-4)
    assert bool((rc.reason != 0).all())


def test_down_sampling_draws_on_the_card(cuda):
    """The mask is drawn on the card from the seed (the same seed, the
    same mask), and applying a given mask gives the CPU's bits."""
    from photon_ml_tpu_torch.game import sampling

    a = sampling.draw_keep_mask(1_000_003, 0.25, 9, cuda)
    assert a.device.type == "cuda" and torch.equal(a, sampling.draw_keep_mask(1_000_003, 0.25, 9, cuda))
    assert abs(float(a.double().mean()) - 0.25) < 0.005
    x, _, _, y, _, wt, _ = _inputs(cuda, 5000, 8, torch.float32, 44)
    keep = a[:5000]
    got = sampling.apply_keep_mask(batch_from_dense(x, y, weights=wt, device=cuda), "logistic_regression", 0.25, keep)
    want = sampling.apply_keep_mask(batch_from_dense(x.cpu(), y.cpu(), weights=wt.cpu(), device="cpu"),
                                    "logistic_regression", 0.25, keep.cpu())
    assert torch.equal(got.weights.cpu(), want.weights)


# (E, K, S) of the whole stack and the stacks solved alone: a small shape,
# and the billion-coefficient slice's (ROADMAP C7: before the lane reduction
# V1, a stack of one or eleven entities summed in another order there)
BUCKET_SHAPES = [((3000, 12, 9), (slice(7, 8), slice(1000, 1011), slice(0, 512))),
                 ((32768, 16, 256), (slice(0, 1), slice(1000, 1011)))]


@pytest.mark.parametrize("shape,stacks", BUCKET_SHAPES, ids=["3000x12x9", "32768x16x256"])
@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_vmapped_entities_on_card_do_not_depend_on_their_bucket(cuda, opt, shape, stacks):
    """The vmapped solve on the card: an entity solved alone, or in a small
    stack, ends with the bits it has within the whole stack; its sums are
    V1's, whose order depends on the reduced length alone."""
    from photon_ml_tpu_torch.game.coordinate import _train_blocks
    from photon_ml_tpu_torch.ops import lane_reduce

    E, K, S = shape
    args = _re_blocks(cuda, torch.float32, seed=3, E=E, K=K, S=S)
    kw = dict(task="logistic_regression", l2=0.1, l1=0.0, optimizer_type=opt, tolerance=1e-7, max_iterations=80,
              num_corrections=10, max_cg_iterations=20, max_improvement_failures=5)
    whole = _train_blocks(*args, **kw)
    assert min(lane_reduce.LANE_LAUNCHES.values()) > 0
    for rows in stacks:
        part = _train_blocks(*(a[rows] for a in args), **kw)
        for name in ("coefficients", "loss", "iterations", "reason"):
            assert torch.equal(getattr(part, name), getattr(whole, name)[rows]), (rows, name)


@pytest.mark.parametrize("length", [1, 9, 16, 256, 257])
@pytest.mark.parametrize("axis", ["last", "middle", "lanes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_lane_reduce_matches_its_plain_version(cuda, length, axis, dtype):
    """V1 against ``torch.sum`` of the product in float64 from the same
    rounded inputs (max-abs error <= 3e-5 * max(|ref|, 1)), with a broadcast
    ``b`` and without one; one launch each; the same bits twice and within
    a larger stack."""
    from photon_ml_tpu_torch.ops import lane_reduce as lr

    g = torch.Generator(device=cuda)
    g.manual_seed(length)
    shapes = {"last": ((37, 5, length), (37, 1, length), -1), "middle": ((37, length, 5), (37, length, 1), 1),
              "lanes": ((37, length), (37, length), -1)}
    a_shape, b_shape, dim = shapes[axis]
    a = torch.randn(a_shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(b_shape, generator=g, device=cuda).to(torch.float32 if dtype == torch.bfloat16 else dtype)
    lr.reset_launch_counts()
    got = lr.lane_reduce(a, b, dim)
    assert lr.LANE_LAUNCHES == {"last": int(dim == -1), "middle": int(dim == 1)}
    assert got.dtype == b.dtype and got.shape == lr.lane_reduce_plain(a, b, dim).shape
    _assert_vec(got, lr.lane_reduce_plain(a.double(), b.double(), dim), f"V1 {axis} {length}")
    assert torch.equal(got, lr.lane_reduce(a, b, dim))
    assert torch.equal(got[3:4], lr.lane_reduce(a[3:4], b[3:4], dim))
    if dtype != torch.bfloat16:
        _assert_vec(lr.lane_reduce(a, None, dim), lr.lane_reduce_plain(a.double(), None, dim), f"V1 {axis} sum")
    else:
        with pytest.raises(TypeError):
            lr.lane_reduce(a, None, dim)


def test_glm_driver_on_card_runs_b3_with_shifts(cuda, tmp_path):
    """A small legacy-driver run on the card (STANDARDIZATION + SIMPLE): B1,
    B2 and B3 with its shift terms launch, and each saved model reloads onto
    the card bitwise."""
    import numpy as np

    from photon_ml_tpu_torch.cli import glm
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_glm, read_avro_dataset, write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_glm_data

    x, y, _ = generate_glm_data(n=600, d=9, seed=2, noise=1.0)
    x = x[:, :8] * np.linspace(0.5, 4, 8) + np.linspace(-1, 3, 8)
    recs = [{"label": float(y[i]), "features": [{"name": f"f{j}", "term": "", "value": float(x[i, j])}
                                                for j in range(8)]} for i in range(600)]
    train, val = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
    write_avro_file(train, TRAINING_EXAMPLE_AVRO, recs[:450])
    write_avro_file(val, TRAINING_EXAMPLE_AVRO, recs[450:])
    out = str(tmp_path / "out")
    fg.reset_launch_counts()
    summary = glm.run(["--input-data", train, "--validation-data", val, "--output-dir", out, "--optimizer", "TRON",
                       "--normalization", "STANDARDIZATION", "--variance-type", "SIMPLE",
                       "--regularization-weights", "0.1|1|10", "--evaluators", "AUC", "--log-level", "WARNING"])
    assert summary["stage"] == "VALIDATED"
    assert min(fg.LAUNCHES.values()) > 0 and fg.SHIFT_LAUNCHES["fused_hessian_stats"] > 0
    _, imaps = read_avro_dataset(train, {"global": FeatureShardConfig(("features",))})
    for m in summary["models"]:
        sub = f"{out}/lambda-{m['reg_weight']}"
        back = load_glm(f"{sub}/model.avro", imaps["global"])
        assert back.coefficients.means.device.type == "cuda" and back.coefficients.variances is not None
        with open(f"{sub}/model.txt") as f:
            text = np.asarray([np.float32(line.split("\t")[1]) for line in f.read().strip().split("\n")])
        assert np.array_equal(back.coefficients.means.cpu().numpy(), text)


def _game_fixture(tmp_path):
    """tests/test_cli.py's GAME fixture (900 rows, 5 global features, 15
    users with 3 features each), written by the port's Avro writer."""
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data

    recs = generate_game_records(generate_mixed_effect_data(n=900, d_fixed=5, re_specs={"userId": (15, 3)}, seed=31))
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    train, val = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
    write_avro_file(train, schema, recs[:600])
    write_avro_file(val, schema, recs[600:])
    return train, val


_GAME_SHARDS = ["--feature-shard", "name=globalShard,bags=features",
                "--feature-shard", "name=userShard,bags=userFeatures"]


def test_game_driver_on_card_launches_the_kernels_and_resumes_bitwise(cuda, tmp_path, monkeypatch):
    """cli.train on the card (TRON + SIMPLE + STANDARDIZATION fixed effect,
    L-BFGS per-user effect, AUC on validation): B1, B2, B3 with its shift
    terms and S1's ELL matvec (validation scoring) launch; killed right
    after the third boundary checkpoint and resumed, every saved
    coefficient equals the straight run's bit for bit."""
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset
    from photon_ml_tpu_torch.robust import SimulatedKill, faults

    train_p, val_p = _game_fixture(tmp_path)

    def argv(out, extra=()):
        return ["--input-data", train_p, "--validation-data", val_p, *_GAME_SHARDS,
                "--coordinate", "name=global,shard=globalShard,optimizer=TRON,tolerance=1e-6,max.iter=10,"
                                "reg.type=L2,reg.weights=1,variance=SIMPLE",
                "--coordinate", "name=per-user,shard=userShard,re.type=userId,tolerance=1e-6,max.iter=30,"
                                "reg.type=L2,reg.weights=1,active.cap=256",
                "--normalization", "STANDARDIZATION", "--coordinate-descent-iterations", "2",
                "--evaluators", "AUC", "--output-dir", out, "--log-level", "WARNING", *extra]

    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    fg.reset_launch_counts()
    straight = train.run(argv(str(tmp_path / "straight")))
    assert straight["best"]["metrics"]["AUC"] > 0.65
    assert fg.LAUNCHES["fused_value_grad"] > 0 and fg.LAUNCHES["fused_hessian_vector"] > 0
    assert fg.SHIFT_LAUNCHES["fused_hessian_stats"] > 0 and sparse.SPARSE_LAUNCHES["ell_matvec"] > 0
    resumed_out = str(tmp_path / "resumed")
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    monkeypatch.setenv("PHOTON_FAULTS", "cd.boundary_saved:kill:3")
    with pytest.raises(SimulatedKill):
        train.run(argv(resumed_out, ck))
    monkeypatch.delenv("PHOTON_FAULTS")
    resumed = train.run(argv(resumed_out, ck + ["--resume"]))
    faults.clear()
    assert resumed["best"] == straight["best"]
    _, maps = read_avro_dataset(train_p, {"globalShard": FeatureShardConfig(("features",)),
                                          "userShard": FeatureShardConfig(("userFeatures",))})
    a = load_game_model(f"{tmp_path}/straight/models/best", maps, task="logistic_regression")
    b = load_game_model(f"{resumed_out}/models/best", maps, task="logistic_regression")
    assert b["global"].model.coefficients.means.device.type == "cuda"
    for x, y in ((a["global"].model.coefficients.means, b["global"].model.coefficients.means),
                 (a["global"].model.coefficients.variances, b["global"].model.coefficients.variances),
                 (a["per-user"].coef_values, b["per-user"].coef_values)):
        assert torch.equal(x, y)


def test_game_driver_on_card_observed_run_launches_and_saves_the_same(cuda, tmp_path, monkeypatch):
    """cli.train with --metrics-out, --trace-out, --status-port and
    --report-out launches B1, B2, B3 with shifts and S1 as often as the bare
    run and saves the same bits; run_summary.json holds the run's card's
    allocator peak under its cuda:N label, and the timeline one entry a
    sweep; a memory sample from another thread with the pinned device reads
    that card."""
    import json
    import threading

    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.device import pin_device
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset

    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    train_p, val_p = _game_fixture(tmp_path)
    argv = ["--input-data", train_p, "--validation-data", val_p, *_GAME_SHARDS,
            "--coordinate", "name=global,shard=globalShard,optimizer=TRON,tolerance=1e-6,max.iter=10,"
                            "reg.type=L2,reg.weights=1,variance=SIMPLE",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,tolerance=1e-6,max.iter=30,"
                            "reg.type=L2,reg.weights=1",
            "--normalization", "STANDARDIZATION", "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC", "--log-level", "WARNING"]
    counts = []
    for out, extra in (("bare", []), ("observed", ["--metrics-out", str(tmp_path / "m"), "--trace-out",
                                                   str(tmp_path / "t.json"), "--status-port", "0",
                                                   "--report-out", str(tmp_path / "r")])):
        fg.reset_launch_counts()
        sparse.reset_launch_counts()
        train.run(argv + ["--output-dir", str(tmp_path / out), *extra])
        counts.append((dict(fg.LAUNCHES), fg.SHIFT_LAUNCHES["fused_hessian_stats"],
                       sparse.SPARSE_LAUNCHES["ell_matvec"]))
    assert counts[0] == counts[1] and counts[0][1] > 0 and counts[0][2] > 0
    _, maps = read_avro_dataset(train_p, {"globalShard": FeatureShardConfig(("features",)),
                                          "userShard": FeatureShardConfig(("userFeatures",))})
    a, b = (load_game_model(str(tmp_path / o / "models" / "best"), maps, task="logistic_regression")
            for o in ("bare", "observed"))
    assert torch.equal(a["global"].model.coefficients.means, b["global"].model.coefficients.means)
    assert torch.equal(a["per-user"].coef_values, b["per-user"].coef_values)

    card = pin_device("cuda")
    rs = json.load(open(tmp_path / "m" / "run_summary.json"))
    peak = [m["value"] for m in rs["metrics"]
            if m["name"] == "photon_mem_device_peak_bytes_in_use" and m["labels"] == {"device": str(card)}]
    assert len(peak) == 1 and 0 < peak[0] <= torch.cuda.get_device_properties(card).total_memory
    assert rs["timeline"]["n_sweeps"] == 2 and (tmp_path / "r" / "report.json").exists()
    registry = obs.MetricsRegistry()
    reader = threading.Thread(target=obs.sample_memory, args=(registry,), kwargs={"devices": [card]})
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive()
    assert [m["labels"] for m in registry.snapshot() if m["name"] == "photon_mem_device_bytes_limit"] == [
        {"device": str(card)}]


def test_retrain_chain_on_card_day_fixed_effects_match_plain(cuda, tmp_path):
    """A three-day chain (``game.incremental.run_chain``) on the card: a
    TRON + SIMPLE fixed effect and a per-user L-BFGS effect, both centred on
    the accepted model from day 2, a boundary checkpoint every update. B1,
    B2, B3 and S1 (the gate's scoring) launch; each day's first fixed-effect
    update, replayed on its identical inputs (the prior reloaded from the
    chain's saved model), is bitwise the chain's through the kernels and
    within rtol 1e-3 / atol 1e-5 of the plain route (means and variances);
    the published snapshot holds the live model's fixed effect bitwise."""
    import os

    import numpy as np

    from photon_ml_tpu_torch.estimators import CoordinateConfig, GameEstimator
    from photon_ml_tpu_torch.game import incremental
    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.robust import CheckpointManager
    from photon_ml_tpu_torch.robust.checkpoint import to_device
    from photon_ml_tpu_torch.serving import refresh
    from photon_ml_tpu_torch.testing import generate_mixed_effect_data
    from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

    d_fixed, d_re, per_day = 16, 4, 6000
    data = generate_mixed_effect_data(n=4 * per_day, d_fixed=d_fixed, re_specs={"userId": (40, d_re)}, seed=7)
    raw = mixed_data_to_raw_dataset(data)
    rows = np.arange(data.n)
    days = [(f"2026010{k + 1}", raw.subset(rows[k * per_day:(k + 1) * per_day])) for k in range(3)]
    val = raw.subset(rows[3 * per_day:])
    maps = {"global": IndexMap.from_name_terms([(f"g{j}", "") for j in range(d_fixed)], add_intercept=False),
            "userShard": IndexMap.from_name_terms([(f"u{j}", "") for j in range(d_re)], add_intercept=False)}

    def estimator(prior=False):
        from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig as Cfg

        fe = Cfg(optimizer=OptimizerConfig(optimizer_type="TRON", tolerance=1e-7, max_iterations=30),
                 regularization=RegularizationContext("L2"), reg_weight=1.0, variance_type="SIMPLE")
        re_ = Cfg(optimizer=OptimizerConfig(tolerance=1e-6, max_iterations=30),
                  regularization=RegularizationContext("L2"), reg_weight=1.0)
        cfgs = [CoordinateConfig(name="global", feature_shard="global", config=fe, regularize_by_prior=prior),
                CoordinateConfig(name="per-user", feature_shard="userShard", random_effect_type="userId", config=re_,
                                 regularize_by_prior=prior)]
        return GameEstimator("logistic_regression", cfgs, n_cd_iterations=2, evaluator_specs=["AUC"], device=cuda)

    chain, srv = str(tmp_path / "chain"), str(tmp_path / "serving")
    fg.reset_launch_counts()
    res = incremental.run_chain(estimator(), days, val, chain_dir=chain, serving_root=srv, gate_margin=0.05,
                                checkpoint_every=1, checkpoint_keep=4, index_maps=maps)
    assert fg.LAUNCHES["fused_value_grad"] > 0 and fg.LAUNCHES["fused_hessian_vector"] > 0
    assert fg.LAUNCHES["fused_hessian_stats"] > 0 and sparse.SPARSE_LAUNCHES["ell_matvec"] > 0
    assert all(r.accepted for r in res.ledger)
    prior = None
    for k, (label, day) in enumerate(days):
        mgr = CheckpointManager(os.path.join(chain, "checkpoints", f"day-{k:04d}"), keep_last=4)
        first = to_device(mgr._load_validated(mgr.checkpoints()[0])[1]["models"]["global"], cuda)
        est = estimator(prior is not None)
        coords = est._make_coordinates(est.prepare_datasets(day), {"global": 1.0, "per-user": 1.0},
                                       {} if prior is None else dict(prior.models))
        residual = initial = None
        if prior is not None:
            fe_s = coords["global"].score(prior["global"])
            residual = (fe_s + coords["per-user"].score(prior["per-user"])) - fe_s
            initial = prior["global"]
        got, _ = coords["global"].train(residual, initial_model=initial)
        plain, _ = dataclasses.replace(coords["global"], plain=True).train(residual, initial_model=initial)
        want = first.model.coefficients
        assert torch.equal(got.model.coefficients.means, want.means), label
        for a, b in ((want.means, plain.model.coefficients.means),
                     (want.variances, plain.model.coefficients.variances)):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
        prior = load_game_model(os.path.join(chain, "models", f"day-{label}"), maps, task="logistic_regression",
                                device=cuda)
    _, opened = refresh.open_current(srv)
    assert torch.equal(torch.from_numpy(np.array(opened.coords[0].weights)),
                       res.model["global"].model.coefficients.means.cpu())


def test_score_engine_on_card_runs_s1_and_matches_plain(cuda, tmp_path):
    """ScoreEngine.score_dataset on the card: one S1 launch per fixed
    effect, scores at rtol 1e-5 of the plain route's and of the CPU's, and
    equal bit for bit to GameTransformer's and to cli.score's."""
    import numpy as np

    from photon_ml_tpu_torch.cli import score, train
    from photon_ml_tpu_torch.estimators import GameTransformer
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset
    from photon_ml_tpu_torch.serving import ScoreEngine

    train_p, val_p = _game_fixture(tmp_path)
    out = str(tmp_path / "out")
    train.run(["--input-data", train_p, *_GAME_SHARDS,
               "--coordinate", "name=global,shard=globalShard,reg.type=L2,reg.weights=1",
               "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
               "--output-dir", out, "--log-level", "WARNING"])
    val, maps = read_avro_dataset(val_p, {"globalShard": FeatureShardConfig(("features",)),
                                          "userShard": FeatureShardConfig(("userFeatures",))},
                                  id_tag_columns=["userId"])
    model = load_game_model(f"{out}/models/best", maps, task="logistic_regression")
    sparse.reset_launch_counts()
    got = ScoreEngine.from_model(model).score_dataset(val)
    assert sparse.SPARSE_LAUNCHES["ell_matvec"] == 1
    plain = ScoreEngine.from_model(model, plain=True).score_dataset(val)
    assert sparse.SPARSE_LAUNCHES["ell_matvec"] == 1
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    cpu = load_game_model(f"{out}/models/best", maps, task="logistic_regression", device="cpu")
    np.testing.assert_allclose(got, ScoreEngine.from_model(cpu).score_dataset(val), rtol=1e-5, atol=1e-6)
    total, _ = GameTransformer(model=model).transform(val)
    assert np.array_equal(got, total)
    scores, _ = score.run(["--input-data", val_p, *_GAME_SHARDS, "--id-tags", "userId",
                           "--model-input-dir", f"{out}/models/best", "--output-dir", str(tmp_path / "s"),
                           "--log-level", "WARNING"])
    assert np.array_equal(scores, got)


def _serving_parts(seed, d=64, users=50, d_re=8, fe_shift=0.0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"task": "logistic_regression", "models": {
        "global": {"kind": "fixed", "feature_shard": "globalShard", "task": "logistic_regression",
                   "means": (rng.standard_normal(d) + fe_shift).astype(np.float32), "variances": None},
        "per-user": {"kind": "random", "random_effect_type": "userId", "feature_shard": "userShard",
                     "task": "logistic_regression",
                     "entity_ids": np.asarray([f"u{i}" for i in range(users)], dtype=object),
                     "coef_indices": np.sort(rng.integers(0, d_re, size=(users, 4), dtype=np.int32), axis=1),
                     "coef_values": rng.standard_normal((users, 4)).astype(np.float32), "variances": None},
    }}


def _serving_requests(seed, n, d=64, d_re=8, users=50):
    import numpy as np

    from photon_ml_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(seed)
    return [ScoreRequest(
        features={"globalShard": (tuple(rng.integers(0, d, size=16).tolist()), tuple(rng.standard_normal(16).tolist())),
                  "userShard": (tuple(rng.integers(0, d_re, size=4).tolist()), tuple(rng.standard_normal(4).tolist()))},
        ids={"userId": f"u{rng.integers(0, users + 10)}"}, offset=float(rng.standard_normal()),
    ) for _ in range(n)]


def test_resident_engine_on_card_one_s1_a_batch_and_matches_plain(cuda, tmp_path):
    """ScoreEngine.from_store on the card: warm() then one S1 launch a
    request batch at every rung, scores at S1's bound (3e-5 * max(|ref|, 1))
    of the plain route and of the CPU engine's, the resident path bitwise
    the batch path at the rung's width."""
    import numpy as np

    from photon_ml_tpu_torch import convert, serving

    store = serving.ModelStore.open(serving.build_store_from_model(
        convert.game_model_from_numpy(_serving_parts(0), device="cpu"), str(tmp_path / "s")))
    engine = serving.ScoreEngine.from_store(store)
    assert engine.device.type == "cuda" and engine.device.index is not None
    engine.warm()
    plain = serving.ScoreEngine.from_store(store, plain=True)
    cpu = serving.ScoreEngine.from_store(store, device="cpu")
    for n in (1, 8, 64, 256, 1024):
        reqs = _serving_requests(n, n)
        sparse.reset_launch_counts()
        got = engine.score_requests(reqs)
        assert sparse.SPARSE_LAUNCHES["ell_matvec"] == 1
        for ref in (plain.score_requests(reqs), cpu.score_requests(reqs)):
            assert np.all(np.abs(got - ref) <= 3e-5 * np.maximum(np.abs(ref), 1.0))
        assert np.array_equal(got, engine.score_ell(*engine.assemble(reqs, count_cold=False))[:n])


def test_same_shape_models_load_s1_once(cuda, tmp_path, monkeypatch):
    """The card's half of tests/test_torch_serving_fleet.py's
    shared-executables case: once one engine is warm, warming the Nth
    same-shape model neither builds nor loads a library, and its ladder
    batches need no segment pointers."""
    from photon_ml_tpu_torch import convert, serving
    from photon_ml_tpu_torch.ops import cuda_lib

    stores = [serving.ModelStore.open(serving.build_store_from_model(
        convert.game_model_from_numpy(_serving_parts(0, fe_shift=k), device="cpu"), str(tmp_path / f"m{k}")))
        for k in range(3)]
    serving.ScoreEngine.from_store(stores[0]).warm()
    loaded = dict(cuda_lib._loaded)
    builds = []
    monkeypatch.setattr(cuda_lib, "build", lambda names: builds.append(names))
    sparse.reset_launch_counts()
    for store in stores[1:]:
        engine = serving.ScoreEngine.from_store(store)
        engine.warm()
        engine.score_requests(_serving_requests(1, 100))
    assert builds == [] and cuda_lib._loaded == loaded
    assert sparse.SPARSE_LAUNCHES["ell_matvec"] == 4


def test_serving_fleet_on_card_threads_and_a_live_flip(cuda, tmp_path):
    """Two resident models behind their own batcher threads on the card,
    each request scored on its own model; a flip of one model mid-stream
    loses nothing and lands every later response on the new snapshot."""
    import numpy as np

    from photon_ml_tpu_torch import convert, obs, serving

    roots = {m: str(tmp_path / m) for m in ("a", "b")}
    for k, (m, root) in enumerate(roots.items()):
        serving.publish_snapshot(root, "v1", game_model=convert.game_model_from_numpy(
            _serving_parts(k), device="cpu"))
    reqs = _serving_requests(5, 64)
    want = {m: serving.ScoreEngine.from_store(serving.open_current(r)[1]).score_requests(reqs, count_cold=False)
            for m, r in roots.items()}
    with obs.use_run(obs.RunTelemetry()):
        server = serving.ScoringServer(models=roots, max_latency_ms=1.0, poll_seconds=3600.0)
        try:
            for m in roots:
                got = [f.result(timeout=60.0) for f in [server.submit(r, model=m) for r in reqs]]
                assert np.all(np.abs(np.asarray(got) - want[m]) <= 3e-5 * np.maximum(np.abs(want[m]), 1.0))
            serving.publish_snapshot(roots["a"], "v2", game_model=convert.game_model_from_numpy(
                _serving_parts(0, fe_shift=1.0), device="cpu"))
            server.poke_refresh("a")
            assert server.snapshot_names == {"a": "v2", "b": "v1"}
            # the flip built its engine on the watcher's thread, on the set's card
            card = torch.device("cuda", torch.cuda.current_device())
            assert {e.engine.device for e in server._models._entries.values()} == {card}
            v2 = serving.ScoreEngine.from_store(serving.open_current(roots["a"])[1]).score_requests(
                reqs, count_cold=False)
            got = [f.result(timeout=60.0) for f in [server.submit(r, model="a") for r in reqs]]
            assert np.all(np.abs(np.asarray(got) - v2) <= 3e-5 * np.maximum(np.abs(v2), 1.0))
        finally:
            server.close()


def test_memory_sample_reads_the_card(cuda):
    """obs.sample_memory's device block from the caching allocator: bytes
    in use, the peak and the card's total memory, in photon_mem_device_*."""
    from photon_ml_tpu_torch import obs

    x = torch.ones(1 << 20, device="cuda")
    reg = obs.MetricsRegistry()
    obs.sample_memory(reg, devices=[torch.device("cuda", 0)])
    block = obs.memory_block(reg.snapshot())["devices"]["cuda:0"]
    assert block["bytes_in_use"] >= x.numel() * 4
    assert block["peak_bytes_in_use"] >= block["bytes_in_use"]
    assert block["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory


# -------------------------------------------------- out-of-core training


def _host_rows(dev, n, d, xdt, seed):
    """A dense streamed batch's host rows (page-locked) and the same rows
    resident on ``dev``."""
    from photon_ml_tpu_torch.game.data import HostRowBatch

    x, _, _, y, off, wt, _ = _inputs(torch.device("cpu"), n, d, xdt, seed)
    host = HostRowBatch(dim=d, labels=y, offsets=off, weights=wt, dense=x.pin_memory())
    return host, batch_from_dense(x.to(dev), y.to(dev), off.to(dev), wt.to(dev), feature_dtype=xdt, device=dev)


# (rows, budget in rows of the double buffer): 1, 3 and 16 slices; a step
# that leaves a short tail
SLICE_CASES = [(4096, 4096), (3 * 1024, 1024), (16 * 512, 512), (5000, 1024)]


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,rows", SLICE_CASES, ids=["1-slice", "3-slices", "16-slices", "short-tail"])
def test_slot_mode_slices_match_plain_and_the_resident_objective(cuda, n, rows, xdt):
    """Each slice's B1 / B2 writes its totals into its slot row: every row
    against the slice's plain version computed in float64 from the same
    rounded inputs (the kernel bounds), the pass against the resident
    objective, B1 and B2 launched once a slice a pass and the sum kernel
    once a pass; the plain pass launches nothing."""
    from photon_ml_tpu_torch.game.fe_streaming import StreamedFEObjective
    from photon_ml_tpu_torch.ops.glm import GLMObjective

    d = 256
    host, batch = _host_rows(cuda, n, d, xdt, seed=5)
    budget = 2 * rows * host.feature_row_nbytes()
    loss = LOSSES["logistic"]
    obj = StreamedFEObjective(loss, host, budget, l2_weight=0.5, device=cuda)
    ref = StreamedFEObjective(loss, host, budget, l2_weight=0.5, device=cuda, plain=True)
    assert obj.n_slices == -(-n // rows) and obj.route == "dense_kernel"
    w = torch.randn(d, generator=torch.Generator().manual_seed(1)).to(cuda) * 0.05
    fg.reset_launch_counts()
    v, g = obj.value_and_grad(w)
    hv = obj.hessian_vector(w, w)
    assert fg.LAUNCHES["fused_value_grad"] == fg.LAUNCHES["fused_hessian_vector"] == obj.n_slices
    assert fg.SUM_LAUNCHES["rank_order_sum"] == 2
    launches = dict(fg.LAUNCHES)
    ref.value_and_grad(w)
    ref.hessian_vector(w, w)
    assert fg.LAUNCHES == launches  # the plain pass launches nothing
    for k in range(obj.n_slices):
        x = obj._stager._host_planes(k)[0].to(cuda)
        y, off, wt = obj._scalar_slices[k]
        f64 = dict(compute_dtype=torch.float64)
        rv, rg, _ = fg.value_grad_plain(x, w, y, off, wt, loss, **f64)
        rh, _ = fg.hessian_vector_plain(x, w, w, y, off, wt, 0.0, loss, **f64)
        got_vg, got_hv = obj._slots[fg.VG][k], obj._slots[fg.HV][k]
        _assert_vec(got_vg[:d], rg, f"slice {k} gradient")
        _assert_vec(got_hv[:d], rh, f"slice {k} Hv")
        assert abs(float(got_vg[d]) - float(rv)) <= 2e-6 * abs(float(rv)), f"slice {k} value"
    rv, rg = GLMObjective(loss=loss, batch=batch, l2=0.5).value_and_grad(w)
    rhv = GLMObjective(loss=loss, batch=batch, l2=0.5).hessian_vector(w, w)
    assert abs(float(v) - float(rv)) <= 2e-6 * abs(float(rv))
    _assert_vec(g, rg.double(), "streamed grad")
    _assert_vec(hv, rhv.double(), "streamed Hv")


def test_double_buffer_under_the_copy_stream_is_bitwise_stable(cuda):
    """Three passes over 16 slices through the two buffers and the copy
    stream, the compute stream kept busy between them: the same bits each
    time, and the stager's bytes at most the budget."""
    from photon_ml_tpu_torch.game.fe_streaming import StreamedFEObjective

    host, _ = _host_rows(cuda, 16 * 512, 512, torch.float32, seed=7)
    budget = 2 * 512 * host.feature_row_nbytes()
    obj = StreamedFEObjective(LOSSES["logistic"], host, budget, device=cuda)
    w = torch.full((512,), 0.01, device=cuda)
    passes = []
    for _ in range(3):
        # long work queued on the compute stream: a copy that did not wait
        # for the kernel two slices back would overwrite its buffer
        torch.cuda._sleep(1_000_000)
        passes.append(obj.value_and_grad(w))
    for v, g in passes[1:]:
        assert float(v) == float(passes[0][0]) and torch.equal(g, passes[0][1])
    assert 2 * obj.stats["max_slice_bytes"] <= budget
    assert sum(b.numel() * b.element_size() for b in obj._stager.buffers) <= budget


def test_streamed_random_effect_vmapped_is_bitwise_the_in_memory_solve(cuda, monkeypatch):
    """The vmapped solve over streamed entity slices (V1 on the card) ends
    with the in-memory solve's bits."""
    import dataclasses

    from photon_ml_tpu_torch.game import build_random_effect_dataset
    from photon_ml_tpu_torch.ops import lane_reduce

    monkeypatch.setenv("PHOTON_RE_SOLVER", "vmapped")
    coords = _glmix_on(cuda)
    re_ = coords["per-user"]
    ds = re_.dataset
    _, _, raw = _glmix_draws()
    streamed = build_random_effect_dataset(raw, "per-user", "u", "userId", active_cap=64, device=cuda,
                                           hbm_budget_bytes=64 << 10)
    assert streamed.streamed
    residual = coords["global"].score(coords["global"].train(None)[0])
    lane_reduce.reset_launch_counts()
    m_mem, r_mem = re_.train(residual)
    m_str, r_str = dataclasses.replace(re_, dataset=streamed).train(residual)
    assert min(lane_reduce.LANE_LAUNCHES.values()) > 0
    assert torch.equal(m_str.coef_values, m_mem.coef_values.cpu())
    assert torch.equal(r_str.iterations, r_mem.iterations.cpu())
    assert ds.blocks.features.shape == streamed.blocks.features.shape


def test_pipeline_depth_2_on_card_is_bitwise_depth_1(cuda):
    """A two-sweep GLMix fit with a streamed fixed effect and a streamed
    random effect on the card: depth 2 (background stagers, the eval lane)
    gives depth 1's models and ledger bit for bit."""
    import numpy as np

    from photon_ml_tpu_torch.evaluation import build_suite
    from photon_ml_tpu_torch.game import (
        CoordinateDescent, FixedEffectCoordinate, RandomEffectCoordinate, ValidationContext,
        build_fixed_effect_dataset, build_random_effect_dataset,
    )

    from photon_ml_tpu_torch.io.data import RawDataset

    gx, _, raw = _glmix_draws()
    n, d = gx.shape
    gx_raw = RawDataset(
        n_rows=n, labels=raw.labels, offsets=raw.offsets, weights=raw.weights,
        shard_coo={"global": (np.repeat(np.arange(n), d), np.tile(np.arange(d), n), gx.reshape(-1).astype(np.float64))},
        shard_dims={"global": d}, id_tags={},
    )

    def make():
        coords = _glmix_on(cuda)
        fe = build_fixed_effect_dataset(gx_raw, "global", "global", hbm_budget_bytes=256 << 10, device=cuda)
        re_ds = build_random_effect_dataset(raw, "per-user", "u", "userId", active_cap=64, device=cuda,
                                            hbm_budget_bytes=64 << 10)
        assert fe.streamed and re_ds.streamed
        fe_cfg = dataclasses.replace(coords["global"].config, variance_type="NONE")
        coords = {
            "global": FixedEffectCoordinate(dataset=fe, task="logistic_regression", config=fe_cfg),
            "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression",
                                               config=coords["per-user"].config),
        }
        val = ValidationContext(suite=build_suite(["AUC"], raw.labels), offsets=np.zeros(raw.n_rows),
                                score_fns={k: c.score for k, c in coords.items()})
        return coords, val

    runs = []
    for depth in (1, 2):
        coords, val = make()
        runs.append((coords, CoordinateDescent(coords, n_iterations=2, validation=val, pipeline_depth=depth).run()))
    (c1, r1), (_, r2) = runs
    for name in c1:
        assert torch.equal(c1[name].score(r1.model[name]), c1[name].score(r2.model[name]))
    assert [(n, e.primary_metric) for n, e in r1.evaluations] == [(n, e.primary_metric) for n, e in r2.evaluations]


def test_distributed_cli_train_over_ranks_on_card_matches_one_card(cuda, tmp_path):
    """Two ``cli.train --distributed`` ranks sharing the card over gloo (each
    reads its own rows; B1-B3 on each rank joined by B4) against the
    one-process fit on the card, in float32 and so at ROADMAP C5's bounds
    (two float32 solves that sum in different orders stop at the loss's
    resolution): each coordinate's last accepted training loss at rtol
    1e-5, the validation AUC within 2e-3, the random effect keyed by entity
    id at atol 5e-3; B1, B2, B3 with shifts launch in the one-process fit."""
    import json

    from _torch_mp_common import assert_ok, build_index, launch
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.io.index_map import load_partitioned
    from photon_ml_tpu_torch.io.model_io import load_game_model

    train_p, val_p = _game_fixture(tmp_path)
    index_dir = build_index(train_p, _GAME_SHARDS, tmp_path / "index")
    argv = ["--input-data", train_p, "--validation-data", val_p, *_GAME_SHARDS, "--feature-index-dir", index_dir,
            "--coordinate", "name=global,shard=globalShard,optimizer=TRON,tolerance=1e-6,max.iter=10,"
                            "reg.type=L2,reg.weights=1,variance=SIMPLE",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,tolerance=1e-6,max.iter=30,"
                            "reg.type=L2,reg.weights=1,active.cap=256",
            "--normalization", "STANDARDIZATION", "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC", "--log-level", "WARNING", "--device", "cuda"]
    assert_ok(launch("train", argv + ["--output-dir", str(tmp_path / "two"), "--metrics-out", str(tmp_path / "m2")]))
    one = train.run(argv + ["--output-dir", str(tmp_path / "one"), "--metrics-out", str(tmp_path / "m1")])
    assert fg.LAUNCHES["fused_value_grad"] > 0 and fg.SHIFT_LAUNCHES["fused_hessian_stats"] > 0
    docs = []
    for m in ("m2", "m1"):
        with open(tmp_path / m / "run_summary.json") as f:
            docs.append(json.load(f))
    assert docs[0]["distributed"] == {"backend": "gloo", "world_size": 2} and "distributed" not in docs[1]
    losses = [{m["labels"]["coordinate"]: m["value"] for m in d["metrics"] if m["name"] == "photon_cd_accepted_loss"}
              for d in docs]
    assert set(losses[0]) == set(losses[1]) == {"global", "per-user"}
    for name in losses[0]:
        assert losses[0][name] == pytest.approx(losses[1][name], rel=1e-5), name
    assert abs(docs[0]["best"]["metrics"]["AUC"] - one["best"]["metrics"]["AUC"]) <= 2e-3
    maps = {s: load_partitioned(index_dir, s) for s in ("globalShard", "userShard")}
    a = load_game_model(str(tmp_path / "two" / "models" / "best"), maps, task="logistic_regression")
    b = load_game_model(str(tmp_path / "one" / "models" / "best"), maps, task="logistic_regression")
    ra, rb = a["per-user"], b["per-user"]
    ids = [str(e) for e in rb.entity_ids if not str(e).startswith("__pad")]
    dim = len(maps["userShard"])
    da = torch.as_tensor(ra.dense_coefficients(dim))[torch.as_tensor(ra.rows_for(ids))]
    db = torch.as_tensor(rb.dense_coefficients(dim))[torch.as_tensor(rb.rows_for(ids))]
    torch.testing.assert_close(da, db, rtol=0, atol=5e-3)


def _streamed_fields(n=40001, d=128, seed=13):
    """n rows of d features, 4-12 entries a row (the second half's rows
    carry more, so the ranks' ELL widths differ), as RawDataset fields."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nnz = np.where(np.arange(n) < (n + 1) // 2, rng.integers(4, 8, n), rng.integers(8, 13, n))
    rows = np.repeat(np.arange(n), nnz)
    cols = np.concatenate([np.sort(rng.choice(d, k, replace=False)) for k in nnz])
    return dict(
        n_rows=n, labels=(rng.uniform(size=n) < 0.5).astype(np.float64), offsets=0.1 * rng.normal(size=n),
        weights=rng.uniform(0.5, 2.0, n), shard_coo={"g": (rows, cols, rng.normal(size=len(rows)))},
        shard_dims={"g": d}, id_tags={},
    )


def test_streamed_objective_over_ranks_on_card(cuda, tmp_path):
    """The streamed fixed effect over two gloo ranks sharing the card, dense
    and ELL, float32: each rank streams its own rows (B1 / B2 into its slot
    rows, S1 on ELL slices) and each pass adds both ranks' slot rows by one
    rank-order sum; the ranks bitwise alike; value, gradient and Hv against
    the same two ranks' float64 pass on the CPU at the kernels' bounds
    (value rtol 2e-6; gradient and Hv max-abs <= 3e-5 * max(|ref|, 1))."""
    import numpy as np

    from photon_ml_tpu_torch.parallel import spawn

    fields = _streamed_fields()
    d = fields["shard_dims"]["g"]
    rng = np.random.default_rng(3)
    base = dict(raw=fields, shard="g", layouts=("dense", "ell"), budget=1 << 20, l2=0.7,
                w=rng.normal(size=d) / np.sqrt(d), v=rng.normal(size=d), residual=0.3 * rng.normal(size=fields["n_rows"]))
    runs = {}
    for device, dtype in (("cuda", "float32"), ("cpu", "float64")):
        runs[device] = spawn("_torch_mp_ranks:streamed_objective", 2, "gloo", device,
                             args=(dict(base, device=device, dtype=dtype),), timeout_s=300.0, store_dir=tmp_path)
    for layout in ("dense", "ell"):
        (a, b), (ref, _) = runs["cuda"], runs["cpu"]
        a, b, ref = a[layout], b[layout], ref[layout]
        for key in ("value", "grad", "hv"):
            assert _same_bits(a[key].numpy(), b[key].numpy()), (layout, key)
        torch.testing.assert_close(a["value"].double(), ref["value"], rtol=2e-6, atol=0)
        for key in ("grad", "hv"):
            err = float((a[key].double() - ref[key]).abs().max())
            assert err <= 3e-5 * max(float(ref[key].abs().max()), 1.0), (layout, key, err)
        for r in runs["cuda"]:
            got = r[layout]["launches"]
            assert got["rank_order_sum"] == 2, (layout, got)  # one a pass, over both ranks' slot rows
            if layout == "dense":
                k = r[layout]["n_slices"]
                assert k > 1 and got["fused_value_grad"] == got["fused_hessian_vector"] == k, got
            else:
                assert got.get("ell_matvec", 0) > 0 and got.get("ell_rmatvec", 0) > 0 and "fused_value_grad" not in got
    assert runs["cuda"][0]["ell"]["ell_width"] < runs["cuda"][1]["ell"]["ell_width"]


def test_cross_rank_re_build_on_card_is_bitwise_its_cpu_build(cuda, tmp_path):
    """``game.data_mp.build_random_effect_dataset_global`` on two gloo ranks
    sharing the card: every block array, scoring array and table bitwise the
    same two ranks' build on the CPU."""
    import numpy as np

    from photon_ml_tpu_torch.parallel import spawn
    from photon_ml_tpu_torch.testing import generate_mixed_effect_data
    from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

    raw = mixed_data_to_raw_dataset(
        generate_mixed_effect_data(n=2001, d_fixed=4, re_specs={"userId": (120, 9)}, seed=5, entity_skew=1.4))
    raw = {f: getattr(raw, f) for f in ("n_rows", "labels", "offsets", "weights", "shard_coo", "shard_dims", "id_tags")}
    cases = [dict(active_cap=None, pad_entities_to_multiple=8), dict(active_cap=8, active_lower_bound=3),
             dict(active_cap=8, features_to_samples_ratio=0.5)]
    runs = {}
    for device in ("cuda", "cpu"):
        payload = dict(raw=raw, shard="userShard", re_type="userId", cases=cases, device=device)
        runs[device] = spawn("_torch_mp_ranks:builds", 2, "gloo", device, args=(payload,), timeout_s=300.0,
                             store_dir=tmp_path)
    for rank in range(2):
        for case in range(len(cases)):
            got, want = runs["cuda"][rank][case], runs["cpu"][rank][case]
            assert set(got) == set(want)
            for key, value in got.items():
                if isinstance(value, torch.Tensor):
                    assert _same_bits(value, want[key]), (rank, case, key)
                elif isinstance(value, np.ndarray):
                    assert np.array_equal(value, want[key]), (rank, case, key)
                else:
                    assert value == want[key], (rank, case, key)


def test_dense_feature_shard_over_ranks_on_card(cuda, tmp_path):
    """The dense feature-axis shard on a (2 x 2) grid of gloo ranks sharing
    the card, float32: the tiles' products (``torch.mv`` on the tile, the
    same bits twice), value, gradient, Hv and the Hessian diagonal against
    the same grid's float64 pass on the CPU at the kernels' bounds (value
    rtol 2e-6; the vectors max-abs <= 3e-5 * max(|ref|, 1)), every rank of
    a subgroup with the same bits; the TRON solve with SIMPLE variances
    through the ``tiled_dense`` route and the rank-order sum against the
    same grid's float32 solve on the CPU at the solve bounds (rtol 1e-3 /
    atol 1e-5; both at tolerance 1e-6, ROADMAP C3)."""
    import numpy as np

    from photon_ml_tpu_torch.parallel import spawn

    rng = np.random.default_rng(5)
    n, d = 4001, 301  # ragged on both axes
    x = rng.normal(size=(n, d)) / np.sqrt(d)
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ rng.normal(size=d))))).astype(np.float64)
    base = dict(x=x, y=y, w=rng.normal(size=d) * 0.3, v=rng.normal(size=d), l2=0.5)
    runs = {}
    for device, dtype, tol in (("cuda", "float32", 1e-6), ("cpu", "float32", 1e-6), ("cpu", "float64", 1e-9)):
        runs[device, dtype] = spawn("_torch_feature_shard_ranks:dense_tiles_on_card", 4, "gloo", device,
                                    args=(dict(base, device=device, dtype=dtype, tolerance=tol),), timeout_s=300.0,
                                    store_dir=tmp_path)
    card = runs["cuda", "float32"]
    for r, want, solve in zip(card, runs["cpu", "float64"], runs["cpu", "float32"]):
        assert r["device"].startswith("cuda") and r["same_bits"]
        assert r["routes"]["tiled_dense"] == 1 and r["sums"]["rank_order_sum"] > 0, r
        torch.testing.assert_close(r["value"].double(), want["value"], rtol=2e-6, atol=0)
        for key in ("z", "g", "hv", "hd"):
            err = float((r[key].double() - want[key]).abs().max())
            assert err <= 3e-5 * max(float(want[key].abs().max()), 1.0), (r["pos"], key, err)
        torch.testing.assert_close(r["means"][:d], solve["means"][:d], rtol=1e-3, atol=1e-5)
        torch.testing.assert_close(r["var"][:d], solve["var"][:d], rtol=1e-3, atol=1e-5)
    for key, axis in (("z", 0), ("g", 1), ("hv", 1), ("means", None)):
        for a in card:
            for b in card:
                if axis is None or a["pos"][axis] == b["pos"][axis]:
                    assert _same_bits(a[key].numpy(), b[key].numpy()), (key, a["pos"], b["pos"])
