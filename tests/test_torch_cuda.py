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
float64 solve (loss rtol 1e-9).
"""

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
    assert fg.OBJECTIVE_ROUTES == {"dense_kernel": 1, "sparse_kernel": 0, "plain_cpu": 0, "plain_float64": 1}
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


def _glmix_on(dev, n=20_000, d=64, users=300, d_re=8, seed=9):
    """A small bench-shaped GLMix problem built on ``dev``."""
    import numpy as np

    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinate, FixedEffectDataset, RandomEffectCoordinate,
        build_random_effect_dataset,
    )
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


def _same_bits(a, b) -> bool:
    """Two numpy outputs (or both None) bitwise equal, 0-d arrays too."""
    import numpy as np

    if a is None or b is None:
        return a is None and b is None
    bits = lambda t: np.ascontiguousarray(t).reshape(-1).view(np.uint8)  # noqa: E731
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(bits(a), bits(b))


@pytest.mark.parametrize("width", [1, 33, 1026, 2049])
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
    assert fg.OBJECTIVE_ROUTES == {"dense_kernel": 0, "sparse_kernel": 0, "plain_cpu": 0, "plain_float64": 1}
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
