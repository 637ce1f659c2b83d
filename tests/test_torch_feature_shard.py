"""The PyTorch port's dense feature-axis shard against the JAX package.

``shard_batch(batch, mesh, shard_features_dim=True)`` keeps a rank's dense
tile of X on a (data x model) grid of ranks, ``shard_coefficients`` its
model slice of the coefficients, and ``GLMObjective`` / TRON / L-BFGS run
the tiled branch over the tiles. Held here, in float64:

- tests/test_parallel.py:93 ``test_feature_dim_sharding`` on the (2, 4),
  (4, 2), (1, 8) and (8, 1) grids against the JAX package's own
  feature-sharded batch on its mesh: value rtol 1e-12, gradient rtol
  1e-11, and the tile's products and layout;
- Hv, the Hessian diagonal and SIMPLE with the normalization's shifts and
  factors (d = 13, not a multiple of the model axis) against the JAX
  package's jnp path on the whole batch, rtol 1e-11;
- FULL on dense tiles against the JAX ``hessian_matrix`` of the whole
  batch (rtol 1e-9 / atol 1e-12, the padded block the identity times
  1 + l2) and its variances;
- TRON with SIMPLE and L-BFGS through ``GLMProblem.run`` at tolerance 1e-9
  against the JAX package's whole-batch solves, coefficients rtol 1e-3 /
  atol 1e-5;
- tests/test_scale_paths.py's estimator case with ``coords("dense")`` on a
  (4, 2) grid against the JAX ``GameEstimator(mesh=make_mesh(4, 2))`` in one
  process: FE rtol 1e-3 / atol 1e-5, RE atol 5e-3, the validation loss
  atol 1e-4; the dense fixed effect replicated over the model axis, its M
  replicas (and every rank's models) bitwise alike.

Every rank of a data row must hold the same margins, every rank of a model
column the same gradient slice, and every rank of a solve the same
iterations and reason. The JAX package runs in this process on its 8
virtual CPU devices (tests/conftest.py); the port runs as 8 gloo ranks,
started once (rank bodies in tests/_torch_feature_shard_ranks.py), every
grid laid out over the same world in turn, and the 1 x 1 grid in this
process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.game.problem import GLMOptimizationConfig as JGLMOptimizationConfig
from photon_ml_tpu.game.problem import GLMProblem as JGLMProblem
from photon_ml_tpu.ops import GLMObjective as JGLMObjective
from photon_ml_tpu.ops import LOGISTIC, batch_from_dense
from photon_ml_tpu.ops.glm import compute_variances as j_compute_variances
from photon_ml_tpu.ops.normalization import build_normalization as j_build_normalization
from photon_ml_tpu.ops.regularization import RegularizationContext as JRegularizationContext
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizerConfig
from photon_ml_tpu.parallel import make_mesh as j_make_mesh
from photon_ml_tpu.parallel import shard_batch as j_shard_batch
from photon_ml_tpu.parallel import shard_coefficients as j_shard_coefficients
from photon_ml_tpu.testing import generate_glm_data

from photon_ml_tpu_torch.parallel import spawn
from photon_ml_tpu_torch.parallel.mesh import make_mesh

import _torch_feature_shard_ranks as ranks

SHAPES = [(2, 4), (4, 2), (1, 8), (8, 1)]
ALL_SHAPES = [(1, 1)] + SHAPES
CHECKS = ["feature_dim", "second_order", "full", "solves"]
TIMEOUT_S = 240.0


def _logistic(rng, n, d, scale=0.5):
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0  # the intercept column
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(x @ (rng.normal(size=d) * scale))))).astype(np.float64)
    return x, y


def _cases():
    rng = np.random.default_rng(0)
    x, y, _ = generate_glm_data(n=64, d=16, seed=4)
    cases = {"feature_dim": dict(x=np.asarray(x, np.float64), y=np.asarray(y, np.float64),
                                 w=np.linspace(-1, 1, 16), c=rng.normal(size=64))}
    x, y = _logistic(rng, 90, 13)
    x[:, :-1] = x[:, :-1] * (1.0 + 4.0 * rng.uniform(size=12)) + rng.normal(size=12)
    cases["second_order"] = dict(x=x, y=y, w=rng.normal(size=13) * 0.3, v=rng.normal(size=13), mean=x.mean(0),
                                 var=x.var(0), absmax=np.abs(x).max(0))
    x, y = _logistic(rng, 70, 13)
    cases["full"] = dict(x=x, y=y, w=rng.normal(size=13) * 0.3)
    x, y = _logistic(rng, 200, 13)
    cases["solves"] = dict(x=x, y=y)
    return cases


CASES = _cases()


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
    grids = [(s, CHECKS) for s in SHAPES]
    out = spawn(
        "_torch_feature_shard_ranks:grid_checks", 8, "gloo", "cpu",
        args=(dict(grids=grids, cases=CASES, estimator=est),), timeout_s=TIMEOUT_S,
        store_dir=tmp_path_factory.mktemp("feature_shard"),
    )
    by_shape = {s: [r[s] for r in out] for s in SHAPES}
    by_shape["estimator"] = [r["estimator"] for r in out]
    mesh = make_mesh(1, 1, device="cpu")
    by_shape[(1, 1)] = [{"pos": (0, 0), **{k: ranks.CHECKS[k](mesh, CASES[k]) for k in CHECKS}}]
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


def _same_everywhere(results, get, what):
    first = get(results[0])
    for r in results[1:]:
        np.testing.assert_array_equal(get(r), first, err_msg=f"{what} differs across ranks")
    return first


@pytest.fixture(scope="module")
def jax_feature_dim():
    """The JAX package's feature-sharded batch on each of its meshes
    (tests/test_parallel.py:93), and its whole-batch products."""
    c = CASES["feature_dim"]
    batch = batch_from_dense(c["x"], c["y"], dtype=jnp.float64)
    w = jnp.asarray(c["w"])
    out = {}
    for shape in ALL_SHAPES:
        mesh = j_make_mesh(n_data=shape[0], n_model=shape[1])
        sharded = j_shard_batch(batch, mesh, shard_features_dim=True)
        v, g = jax.jit(JGLMObjective(loss=LOGISTIC, batch=sharded).value_and_grad)(j_shard_coefficients(w, mesh))
        out[shape] = (float(v), np.asarray(g))
    x = batch.features
    cv = jnp.asarray(c["c"])
    return out, (np.asarray(x.matvec(w)), np.asarray(x.rmatvec(cv)), np.asarray(x.sq_rmatvec(cv)))


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_feature_dim_sharding_matches_the_jax_package(grid, jax_feature_dim, shape):
    """tests/test_parallel.py:93 on the port's grid: value rtol 1e-12 and
    gradient rtol 1e-11 against the JAX package's feature-sharded batch on
    the same mesh shape (and its whole batch); the tile's products, its
    layout and its whole matrix."""
    c = CASES["feature_dim"]
    n, d = c["x"].shape
    by_mesh, (z_ref, xtc_ref, x2tc_ref) = jax_feature_dim
    v_ref, g_ref = by_mesh[shape]
    res = grid[shape]
    value = _same_everywhere(res, lambda r: r["feature_dim"]["value"], "value")
    np.testing.assert_allclose(value, v_ref, rtol=1e-12)
    np.testing.assert_allclose(_cols_whole(res, "g", "feature_dim"), g_ref, rtol=1e-11)
    np.testing.assert_allclose(_rows_whole(res, "z", "feature_dim")[:n], z_ref, rtol=1e-12)
    np.testing.assert_allclose(_cols_whole(res, "xtc", "feature_dim")[:d], xtc_ref, rtol=1e-12)
    np.testing.assert_allclose(_cols_whole(res, "x2tc", "feature_dim")[:d], x2tc_ref, rtol=1e-12)
    D, M = shape
    for r in res:
        f = r["feature_dim"]
        assert f["tile_shape"] == (-(-n // D), d // M) and (f["dim"], f["n_rows"]) == (d, n)
        assert f["group"] == (None if shape == (1, 1) else D)
        np.testing.assert_array_equal(f["dense"], c["x"])


@pytest.fixture(scope="module")
def jax_second_order():
    c = CASES["second_order"]
    d = c["x"].shape[1]
    norm = j_build_normalization("STANDARDIZATION", c["mean"], c["var"], c["absmax"], intercept_index=d - 1,
                                 dtype=jnp.float64)
    cfg = JGLMOptimizationConfig(regularization=JRegularizationContext("L2"), reg_weight=0.3)
    obj = JGLMProblem(task="logistic_regression", config=cfg, normalization=norm).objective(
        batch_from_dense(c["x"], c["y"], dtype=jnp.float64))
    w, v = jnp.asarray(c["w"]), jnp.asarray(c["v"])
    value, g = obj.value_and_grad(w)
    return dict(value=float(value), g=np.asarray(g), hv=np.asarray(obj.hessian_vector(w, v)),
                hd=np.asarray(obj.hessian_diagonal(w)), simple=np.asarray(j_compute_variances(obj, w, "SIMPLE")))


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_second_order_terms_with_shifts_match_the_jax_package(grid, jax_second_order, shape):
    """Hv, the Hessian diagonal and SIMPLE's variances (with the
    STANDARDIZATION shifts and factors and L2) on dense tiles of d = 13
    against the JAX package's jnp path on the whole batch, rtol 1e-11; the
    padded columns carry zero gradient and the L2 term alone."""
    d = CASES["second_order"]["x"].shape[1]
    ref = jax_second_order
    res = grid[shape]
    value = _same_everywhere(res, lambda r: r["second_order"]["value"], "value")
    np.testing.assert_allclose(value, ref["value"], rtol=1e-12)
    for key in ("g", "hv", "hd"):
        got = _cols_whole(res, key, "second_order")
        np.testing.assert_allclose(got[:d], ref[key], rtol=1e-11, atol=1e-12, err_msg=key)
    simple = _same_everywhere(res, lambda r: r["second_order"]["simple"], "SIMPLE")
    np.testing.assert_allclose(simple[:d], ref["simple"], rtol=1e-11)
    assert np.all(_cols_whole(res, "g", "second_order")[d:] == 0)


@pytest.fixture(scope="module")
def jax_full():
    c = CASES["full"]
    obj = JGLMObjective(loss=LOGISTIC, batch=batch_from_dense(c["x"], c["y"], dtype=jnp.float64), l2=0.25)
    w = jnp.asarray(c["w"])
    return np.asarray(obj.hessian_matrix(w)), np.asarray(j_compute_variances(obj, w, "FULL"))


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_full_on_dense_tiles_matches_the_jax_hessian(grid, jax_full, shape):
    """FULL on dense tiles: the whole Hessian on every rank equals the JAX
    package's ``hessian_matrix`` of the whole batch, the padded block is
    the identity times 1 + l2 and inert, the variances match, and a 5-row
    chunk (several chunks a rank) gives the same X^T C X."""
    h_ref, v_ref = jax_full
    d = CASES["full"]["x"].shape[1]
    res = grid[shape]
    h = _same_everywhere(res, lambda r: r["full"]["h"], "the Hessian")
    np.testing.assert_allclose(h[:d, :d], h_ref, rtol=1e-9, atol=1e-12)
    pad = res[0]["full"]["dim"] - d
    if pad:
        np.testing.assert_allclose(h[d:, d:], np.eye(pad) * (1.0 + 0.25))
        assert np.all(h[:d, d:] == 0) and np.all(h[d:, :d] == 0)
    var = _same_everywhere(res, lambda r: r["full"]["var"], "FULL variances")
    np.testing.assert_allclose(var[:d], v_ref, rtol=1e-8)
    chunked = _cols_whole([{**r, "full": {"h": r["full"]["chunked"]}} for r in res], "h", "full")
    np.testing.assert_allclose(chunked[:d, :d], h_ref - 0.25 * np.eye(d), rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def jax_solves():
    c = CASES["solves"]
    batch = batch_from_dense(c["x"], c["y"], dtype=jnp.float64)
    out = {}
    for name in ("TRON", "LBFGS"):
        cfg = JGLMOptimizationConfig(
            optimizer=JOptimizerConfig(optimizer_type=name, tolerance=1e-9, max_iterations=200),
            regularization=JRegularizationContext("L2"), reg_weight=0.5,
            variance_type="SIMPLE" if name == "TRON" else "NONE",
        )
        model, _ = JGLMProblem(task="logistic_regression", config=cfg).run(batch)
        co = model.coefficients
        out[name] = (np.asarray(co.means), None if co.variances is None else np.asarray(co.variances))
    return out


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_solves_on_dense_tiles_match_the_jax_package(grid, jax_solves, shape, optimizer):
    """TRON (with SIMPLE variances) and L-BFGS through ``GLMProblem.run`` on
    the dense tiles at tolerance 1e-9 in float64 land on the JAX package's
    whole-batch solve, coefficients rtol 1e-3 / atol 1e-5 (ROADMAP C3);
    every rank ends with the same model, iterations and reason, and the
    padding at zero."""
    d = CASES["solves"]["x"].shape[1]
    means_ref, var_ref = jax_solves[optimizer]
    res = grid[shape]
    for key in ("iterations", "reason", "loss"):
        _same_everywhere(res, lambda r: r["solves"][optimizer][key], key)
    means = _same_everywhere(res, lambda r: r["solves"][optimizer]["means"], "means")
    np.testing.assert_allclose(means[:d], means_ref, rtol=1e-3, atol=1e-5)
    assert np.all(means[d:] == 0)
    if var_ref is not None:
        var = _same_everywhere(res, lambda r: r["solves"][optimizer]["var"], "variances")
        np.testing.assert_allclose(var[:d], var_ref, rtol=1e-3, atol=1e-5)


def test_estimator_dense_fixed_effect_on_a_grid_matches_the_jax_mesh(grid):
    """tests/test_scale_paths.py's estimator case with ``coords("dense")``:
    the port's GameEstimator on a (4 x 2) grid of 8 ranks (the dense fixed
    effect replicated over the model axis, each model column solving over
    its data subgroup, ``row+model-sharded``) against the JAX package's
    GameEstimator(mesh=make_mesh(4, 2)) in one process, both in float64:
    FE rtol 1e-3 / atol 1e-5, RE atol 5e-3, the validation logistic loss
    atol 1e-4 and AUC within 1e-4; every rank's models bitwise alike (the
    M replicas of the fixed effect among them)."""
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
    est = JGameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=2,
                         mesh=j_make_mesh(n_data=4, n_model=2), evaluator_specs=["AUC", "LOGISTIC_LOSS"],
                         dtype=jnp.float64)
    ref = est.fit(raw, validation=raw)[-1]
    res = grid["estimator"]
    assert [c.sharding for c in est.execution_plan.coordinates] == res[0]["plan"] == [
        "row+model-sharded", "entity-sharded", "entity-sharded"]
    for r in res:
        # every rank solved its fixed effect on its data subgroup's rows
        assert r["routes"]["plain_cpu"] > 0 and r["routes"]["tiled_dense"] == 0
    w = _same_everywhere(res, lambda r: r["global"], "the fixed effect")
    np.testing.assert_allclose(w, np.asarray(ref.model["global"].model.coefficients.means), rtol=1e-3, atol=1e-5)
    metrics = _same_everywhere(res, lambda r: np.asarray([r["metrics"]["LOGISTIC_LOSS"], r["metrics"]["AUC"]]),
                               "the metrics")
    assert abs(metrics[0] - ref.evaluation.metrics["LOGISTIC_LOSS"]) <= 1e-4
    assert abs(metrics[1] - ref.evaluation.metrics["AUC"]) <= 1e-4
    for name, shard in (("per-user", "userShard"), ("per-item", "itemShard")):
        re = ref.model[name]
        ids = [str(e) for e in re.entity_ids if not str(e).startswith("__pad")]
        dense = np.asarray(re.dense_coefficients(raw.shard_dims[shard]))[re.rows_for(ids)]
        got = _same_everywhere(res, lambda r: np.stack([r[name][e] for e in ids]), name)
        np.testing.assert_allclose(got, dense, rtol=0, atol=5e-3)
