"""The PyTorch port's (data x model)-tiled fixed effect against the JAX package.

Every case of tests/test_sparse_tiled.py at its shapes and bounds: the tiled
products on the (1, 1), (8, 1), (1, 8), (4, 2) and (2, 4) grids (rtol 1e-10
in float64), the sharded L-BFGS solve against the replicated solve (atol
1e-8), value (rtol 1e-12), gradient and Hessian diagonal (rtol 1e-9), the
FULL Hessian on tiles (rtol 1e-9 / atol 1e-12, the padded block the
identity times 1 + l2) and its variances, normalization, and the FULL
ceiling. The JAX package runs in this process on its 8 virtual CPU devices
(tests/conftest.py); the port runs as 8 gloo ranks on the CPU, started once
by ``parallel.spawn`` (rank bodies in tests/_torch_tiled_ranks.py), every
grid laid out over the same world in turn, or in this process for the 1 x 1
grid. Ranks of one data row must hold bitwise the same margins, ranks of
one model column the same gradient slice, and every rank of a solve the
same iteration count and reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.game.problem import GLMOptimizationConfig as JGLMOptimizationConfig
from photon_ml_tpu.game.problem import GLMProblem as JGLMProblem
from photon_ml_tpu.ops import GLMObjective as JGLMObjective
from photon_ml_tpu.ops import LOGISTIC, batch_from_dense
from photon_ml_tpu.ops.features import sorted_coo_matrix
from photon_ml_tpu.ops.glm import compute_variances as j_compute_variances
from photon_ml_tpu.ops.normalization import build_normalization as j_build_normalization
from photon_ml_tpu.ops.regularization import RegularizationContext as JRegularizationContext
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizerConfig
from photon_ml_tpu.optimize import optimize as j_optimize
from photon_ml_tpu.parallel import make_mesh as j_make_mesh
from photon_ml_tpu.parallel.sparse import replicated_coefficients as j_replicated
from photon_ml_tpu.parallel.sparse import tile_sparse_matrix as j_tile
from photon_ml_tpu.parallel.sparse import tiled_sparse_batch as j_tiled_batch

from photon_ml_tpu_torch.parallel import spawn
from photon_ml_tpu_torch.parallel.mesh import make_mesh

import _torch_tiled_ranks as ranks

SHAPES = [(8, 1), (1, 8), (4, 2), (2, 4)]
ALL_SHAPES = [(1, 1)] + SHAPES
TIMEOUT_S = 240.0


def _random_coo(rng, n, d, k):
    """tests/test_sparse_tiled.py's ``_random_coo``."""
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, d, size=n * k)
    vals = rng.normal(size=n * k)
    keys = rows.astype(np.int64) * d + cols
    uniq, inv = np.unique(keys, return_inverse=True)
    merged = np.zeros(len(uniq))
    np.add.at(merged, inv, vals)
    return (uniq // d).astype(np.int64), (uniq % d).astype(np.int64), merged


def _dense_of(rows, cols, vals, n, d):
    x = np.zeros((n, d))
    np.add.at(x, (rows, cols), vals)
    return x


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    n, d = 96, 200
    rows, cols, vals = _random_coo(rng, n, d, 4)
    cases["products"] = dict(rows=rows, cols=cols, vals=vals, n=n, d=d, w=rng.normal(size=d), c=rng.normal(size=n))
    n, d = 400, 257  # d deliberately not a multiple of the model axis
    rows, cols, vals = _random_coo(rng, n, d, 6)
    x = _dense_of(rows, cols, vals, n, d)
    logits = x @ (rng.normal(size=d) * 0.5)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    cases["solve"] = dict(rows=rows, cols=cols, vals=vals, y=y, d=d, n=n, lam=0.5)
    n, d = 128, 97
    rows, cols, vals = _random_coo(rng, n, d, 3)
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    cases["value_grad"] = dict(rows=rows, cols=cols, vals=vals, y=y, d=d, n=n, w=rng.normal(size=d),
                               v=rng.normal(size=d))
    n, d = 128, 101  # padded dims on every model axis but 1
    rows, cols, vals = _random_coo(rng, n, d, 3)
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    cases["full"] = dict(rows=rows, cols=cols, vals=vals, y=y, d=d, n=n, w=rng.normal(size=d) * 0.3)
    n, d = 300, 101
    rows, cols, vals = _random_coo(rng, n, d - 1, 4)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.full(n, d - 1)])
    vals = np.concatenate([vals, np.ones(n)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    x = _dense_of(rows, cols, vals, n, d)
    x[:, : d - 1] *= 1.0 + 9.0 * rng.uniform(size=d - 1)
    vals = x[rows, cols]
    logits = x @ (rng.normal(size=d) * 0.3)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    cases["normalized"] = dict(rows=rows, cols=cols, vals=vals, y=y, d=d, n=n, mean=x.mean(0), var=x.var(0),
                               absmax=np.abs(x).max(0))
    n = 64
    rows, cols, vals = _random_coo(rng, n, 50, 3)
    cases["ceiling"] = dict(rows=rows, cols=cols, vals=vals, y=(rng.uniform(size=n) < 0.5).astype(np.float64))
    return cases


CASES = _cases()
GRIDS = [
    ((8, 1), ["products", "solve", "value_grad", "full"]),
    ((1, 8), ["products", "solve", "value_grad", "full"]),
    ((4, 2), ["products", "solve", "value_grad", "full", "normalized", "ceiling"]),
    ((2, 4), ["products", "solve", "value_grad", "full"]),
]


def _estimator_raw():
    """tests/test_scale_paths.py's estimator data: 800 rows, d_fixed 10,
    24 users of 5 features and 12 items of 4, seed 21."""
    from photon_ml_tpu_torch.testing import generate_mixed_effect_data, mixed_data_to_raw_dataset

    return mixed_data_to_raw_dataset(generate_mixed_effect_data(
        n=800, d_fixed=10, re_specs={"userId": (24, 5), "itemId": (12, 4)}, seed=21,
    ))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Every rank's results on every grid: ``{shape: [rank results]}``,
    the 1 x 1 grid from this process, and the estimator case's under
    ``"estimator"``."""
    raw = _estimator_raw()
    est = dict(grid=(4, 2), raw={f: getattr(raw, f) for f in (
        "n_rows", "labels", "offsets", "weights", "shard_coo", "shard_dims", "id_tags", "uids")})
    out = spawn(
        "_torch_tiled_ranks:grid_checks", 8, "gloo", "cpu", args=(dict(grids=GRIDS, cases=CASES, estimator=est),),
        timeout_s=TIMEOUT_S, store_dir=tmp_path_factory.mktemp("tiled"),
    )
    by_shape = {tuple(s): [r[tuple(s)] for r in out] for s, _ in GRIDS}
    by_shape["estimator"] = [r["estimator"] for r in out]
    mesh = make_mesh(1, 1, device="cpu")
    by_shape[(1, 1)] = [{"pos": (0, 0), **{k: ranks.CHECKS[k](mesh, CASES[k]) for k in GRIDS[2][1]}}]
    return by_shape


def _rows_whole(results, key, name):
    """The whole ``[n_pad]`` vector from each data row's block, after
    holding every rank of a data row to the same bits."""
    blocks = {}
    for r in results:
        i, _ = r["pos"]
        got = r[name][key]
        if i in blocks:
            np.testing.assert_array_equal(got, blocks[i], err_msg=f"{name}.{key}: data row {i} disagrees")
        blocks[i] = got
    return np.concatenate([blocks[i] for i in sorted(blocks)])


def _cols_whole(results, key, name):
    """The whole ``[dim]`` vector from each model column's slice, after
    holding every rank of a model column to the same bits."""
    slices = {}
    for r in results:
        _, j = r["pos"]
        got = r[name][key]
        if j in slices:
            np.testing.assert_array_equal(got, slices[j], err_msg=f"{name}.{key}: model column {j} disagrees")
        slices[j] = got
    return np.concatenate([slices[j] for j in sorted(slices)])


def _same_everywhere(results, name, key):
    first = results[0][name][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[name][key], first, err_msg=f"{name}.{key} differs across ranks")
    return first


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's products of the products case: its single-device
    sorted COO, and its (2 x 4)-tiled matrix (padded sizes and products)."""
    c = CASES["products"]
    coo = sorted_coo_matrix(c["rows"], c["cols"], c["vals"], n_rows=c["n"], dim=c["d"], dtype=jnp.float64)
    w, cv = jnp.asarray(c["w"]), jnp.asarray(c["c"])
    mesh = j_make_mesh(n_data=2, n_model=4)
    fm = j_tile(c["rows"], c["cols"], c["vals"], c["n"], c["d"], mesh, dtype=jnp.float64)
    wp = np.zeros(fm.dim)
    wp[: c["d"]] = c["w"]
    cp = np.zeros(fm.n_rows)
    cp[: c["n"]] = c["c"]
    tiled = (np.asarray(fm.matvec(j_replicated(wp, mesh, jnp.float64))), np.asarray(fm.rmatvec(jnp.asarray(cp))),
             np.asarray(fm.sq_rmatvec(jnp.asarray(cp))))
    return (np.asarray(coo.matvec(w)), np.asarray(coo.rmatvec(cv)), np.asarray(coo.sq_rmatvec(cv))), tiled, fm


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_tiled_products_match_the_jax_package(grid, jax_products, shape):
    """matvec, rmatvec and sq_rmatvec on every grid against the JAX
    package's sorted-COO products (and, on its (2 x 4) grid, its tiled
    ones, padded sizes included) at rtol 1e-10 in float64."""
    c = CASES["products"]
    n, d = c["n"], c["d"]
    (z_ref, g_ref, g2_ref), tiled_ref, fm = jax_products
    res = grid[shape]
    z = _rows_whole(res, "z", "products")
    g = _cols_whole(res, "g", "products")
    g2 = _cols_whole(res, "g2", "products")
    np.testing.assert_allclose(z[:n], z_ref, rtol=1e-10)
    np.testing.assert_allclose(g[:d], g_ref, rtol=1e-10)
    np.testing.assert_allclose(g2[:d], g2_ref, rtol=1e-10)
    assert np.all(z[n:] == 0) and np.all(g[d:] == 0)
    x = _dense_of(c["rows"], c["cols"], c["vals"], n, d)
    np.testing.assert_allclose(z[:n], x @ c["w"], rtol=1e-10)
    if shape == (2, 4):
        assert res[0]["products"]["dim"] == fm.dim and res[0]["products"]["n_rows"] == fm.n_rows
        for got, ref in zip((z, g, g2), tiled_ref):
            np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.fixture(scope="module")
def jax_solve():
    c = CASES["solve"]
    x = _dense_of(c["rows"], c["cols"], c["vals"], c["n"], c["d"])
    cfg = JOptimizerConfig(tolerance=1e-10, max_iterations=200)
    obj = JGLMObjective(loss=LOGISTIC, batch=batch_from_dense(x, c["y"], dtype=jnp.float64), l2=c["lam"])
    ref = j_optimize(obj.value_and_grad, jnp.zeros(c["d"], jnp.float64), cfg)
    mesh = j_make_mesh(n_data=2, n_model=4)
    tb = j_tiled_batch(c["rows"], c["cols"], c["vals"], c["y"], c["d"], mesh, dtype=jnp.float64)
    obj_t = JGLMObjective(loss=LOGISTIC, batch=tb, l2=c["lam"])
    tiled = j_optimize(obj_t.value_and_grad, j_replicated(np.zeros(tb.features.dim), mesh, jnp.float64), cfg)
    return np.asarray(ref.coefficients), np.asarray(tiled.coefficients)


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_sharded_solve_equals_replicated_solve(grid, jax_solve, shape):
    """The headline invariant: L-BFGS on every tiled grid lands on the
    replicated dense solve's coefficients (and the JAX package's tiled
    solve's), with every rank agreeing on the iterations and the reason."""
    ref, jax_tiled = jax_solve
    d = CASES["solve"]["d"]
    res = grid[shape]
    for key in ("iterations", "reason", "loss"):
        _same_everywhere(res, "solve", key)
    w = _cols_whole(res, "w", "solve")
    np.testing.assert_allclose(w[:d], ref, atol=1e-8)
    np.testing.assert_allclose(w[:d], jax_tiled[:d], atol=1e-8)
    assert np.all(w[d:] == 0)


@pytest.fixture(scope="module")
def jax_value_grad():
    """The JAX package's dense objective at the value_grad case's point:
    the reference its tiled objective is held to."""
    c = CASES["value_grad"]
    x = _dense_of(c["rows"], c["cols"], c["vals"], c["n"], c["d"])
    obj = JGLMObjective(loss=LOGISTIC, batch=batch_from_dense(x, c["y"], dtype=jnp.float64), l2=0.25)
    w = jnp.asarray(c["w"])
    v, g = obj.value_and_grad(w)
    return (float(v), np.asarray(g), np.asarray(obj.hessian_diagonal(w)),
            np.asarray(obj.hessian_vector(w, jnp.asarray(c["v"]))))


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_tiled_objective_value_grad_parity(grid, jax_value_grad, shape):
    """Value (rtol 1e-12), gradient, Hessian diagonal and Hessian-vector
    product (rtol 1e-9) on every grid against the JAX package's dense
    objective, as tests/test_sparse_tiled.py holds its tiled one."""
    v_ref, g_ref, hd_ref, hv_ref = jax_value_grad
    d = CASES["value_grad"]["d"]
    res = grid[shape]
    value = _same_everywhere(res, "value_grad", "value")
    np.testing.assert_allclose(value, v_ref, rtol=1e-12)
    for key, ref in (("g", g_ref), ("hd", hd_ref), ("hv", hv_ref)):
        np.testing.assert_allclose(_cols_whole(res, key, "value_grad")[:d], ref, rtol=1e-9, err_msg=key)


@pytest.fixture(scope="module")
def jax_full():
    c = CASES["full"]
    x = _dense_of(c["rows"], c["cols"], c["vals"], c["n"], c["d"])
    obj = JGLMObjective(loss=LOGISTIC, batch=batch_from_dense(x, c["y"], dtype=jnp.float64), l2=0.25)
    w = jnp.asarray(c["w"])
    return (np.asarray(obj.hessian_matrix(w)), np.asarray(j_compute_variances(obj, w, "FULL")),
            np.asarray(j_compute_variances(obj, w, "SIMPLE")))


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_tiled_full_variance_matches_dense(grid, jax_full, shape):
    """FULL on tiles: the Hessian equals the dense one, the padded block is
    the identity times 1 + l2 and inert, the variances match the dense FULL
    path, and a 16-row chunk (several chunks a rank) gives the same X^T C X."""
    h_d, v_d, s_d = jax_full
    d = CASES["full"]["d"]
    res = grid[shape]
    h = _same_everywhere(res, "full", "h")
    np.testing.assert_allclose(h[:d, :d], h_d, rtol=1e-9, atol=1e-12)
    pad = res[0]["full"]["dim"] - d
    if pad:
        np.testing.assert_allclose(h[d:, d:], np.eye(pad) * (1.0 + 0.25))
        assert np.all(h[:d, d:] == 0) and np.all(h[d:, :d] == 0)
    var = _same_everywhere(res, "full", "var")
    np.testing.assert_allclose(var[:d], v_d, rtol=1e-8)
    np.testing.assert_allclose(_same_everywhere(res, "full", "simple")[:d], s_d, rtol=1e-9)
    chunked = _cols_whole([{**r, "full": {"h": r["full"]["chunked"]}} for r in res], "h", "full")
    np.testing.assert_allclose(chunked[:d, :d], h_d - 0.25 * np.eye(d), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 1), (4, 2)])
def test_tiled_normalization_matches_dense(grid, shape):
    """STANDARDIZATION on tiles: GLMProblem.run with FULL variances lands on
    the JAX package's dense solve (original space; variances transformed)."""
    c = CASES["normalized"]
    d = c["d"]
    norm = j_build_normalization(
        "STANDARDIZATION", c["mean"], c["var"], c["absmax"], intercept_index=d - 1, dtype=jnp.float64,
    )
    cfg = JGLMOptimizationConfig(
        optimizer=JOptimizerConfig(tolerance=1e-10, max_iterations=200),
        regularization=JRegularizationContext("L2"), reg_weight=0.5, variance_type="FULL",
    )
    x = _dense_of(c["rows"], c["cols"], c["vals"], c["n"], d)
    m_dense, _ = JGLMProblem(task="logistic_regression", config=cfg, normalization=norm).run(
        batch_from_dense(x, c["y"], dtype=jnp.float64)
    )
    res = grid[shape]
    for key in ("iterations", "reason"):
        _same_everywhere(res, "normalized", key)
    w = _same_everywhere(res, "normalized", "means")
    np.testing.assert_allclose(w[:d], np.asarray(m_dense.coefficients.means), atol=1e-7)
    assert np.all(w[d:] == 0)
    v = _same_everywhere(res, "normalized", "var")
    np.testing.assert_allclose(v[:d], np.asarray(m_dense.coefficients.variances), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (4, 2)])
def test_full_variance_dim_ceiling_consistent(grid, shape):
    """An over-ceiling tiled batch raises the ceiling's ValueError before
    the solve and from hessian_matrix, on every rank."""
    for r in grid[shape]:
        for where in ("run", "hessian_matrix"):
            assert r["ceiling"][where] is not None and "variance=FULL" in r["ceiling"][where], where


def test_estimator_tiled_fixed_effect_matches_dense(grid):
    """tests/test_scale_paths.py's estimator case: GameEstimator with a
    tiled fixed effect on a (4 x 2) grid and two random effects (each data
    row of ranks its own rows) against the JAX package's one-process dense
    fit, rtol 2e-3 / atol 2e-3; the fixed effect trimmed to its true
    dimension, every rank holding the same bits."""
    from photon_ml_tpu.estimators.game_estimator import CoordinateConfig as JCoordinateConfig
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JGameEstimator
    from photon_ml_tpu.testing.generators import generate_mixed_effect_data as j_generate
    from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as j_to_raw

    raw = j_to_raw(j_generate(n=800, d_fixed=10, re_specs={"userId": (24, 5), "itemId": (12, 4)}, seed=21))
    cfg = JGLMOptimizationConfig(
        optimizer=JOptimizerConfig(tolerance=1e-8, max_iterations=40),
        regularization=JRegularizationContext("L2"), reg_weight=1.0,
    )
    coords = [JCoordinateConfig(name="global", feature_shard="global", config=cfg, layout="dense")] + [
        JCoordinateConfig(name=name, feature_shard=shard, config=cfg, random_effect_type=tag)
        for name, shard, tag in (("per-user", "userShard", "userId"), ("per-item", "itemShard", "itemId"))
    ]
    ref = JGameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=2).fit(raw)[-1]
    res = grid["estimator"]
    w = _same_everywhere([{"e": r} for r in res], "e", "global")
    w_ref = np.asarray(ref.model["global"].model.coefficients.means)
    assert w.shape == w_ref.shape  # padding trimmed back to the true d
    np.testing.assert_allclose(w, w_ref, rtol=2e-3, atol=2e-3)
    for name, shard in (("per-user", "userShard"), ("per-item", "itemShard")):
        re = ref.model[name]
        ids = [str(e) for e in re.entity_ids if not str(e).startswith("__pad")]
        dense = np.asarray(re.dense_coefficients(raw.shard_dims[shard]))[re.rows_for(ids)]
        for r in res:
            assert sorted(r[name]) == sorted(ids)
            got = np.stack([r[name][e] for e in ids])
            np.testing.assert_array_equal(got, np.stack([res[0][name][e] for e in ids]))
            np.testing.assert_allclose(got, dense, rtol=2e-3, atol=2e-3)
