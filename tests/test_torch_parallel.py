"""The port's data-parallel path (B4 and the sharded GLMix sweep) on the CPU,
over gloo with 1, 2 and 4 processes, held against the JAX package on its
virtual mesh (``make_mesh(n_data=4)`` of the conftest's 8 CPU devices).

The ranks run in processes started by ``photon_ml_tpu_torch.parallel.spawn``
(the ``spawn`` start method, a ``file://`` store under the test's temporary
directory, every spawn and join under a 120 s timeout); their bodies live in
``tests/test_torch_parallel_ranks.py``, which imports no JAX. Each module-scoped
fixture spawns once and feeds several tests. Bounds are the JAX suite's:

- B4 against ``sharded_*`` in interpret mode (tests/test_pallas_glm.py):
  value rtol 2e-6; gradient, Hv and the Hessian statistics max-abs error
  <= 3e-5 * max(|ref|, 1); the scalar sums rtol 2e-5 / atol 1e-4, as
  tests/test_torch_ops.py holds the unsharded kernels' sums;
- ``GLMProblem.run`` on 4 ranks against the JAX sharded solve: loss rtol
  1e-5, coefficients max-abs <= 5e-3 * max(|ref|, 1)
  (test_pallas_glm.py::test_end_to_end_sharded_solve);
- the float64 two-sweep GLMix descent against the JAX mesh run: atol 1e-7
  (test_parallel.py::test_full_game_descent_on_mesh);
- a one-rank group against no group, and every rank against every other:
  bitwise equal;
- B4 (slot rows gathered by an all-gather into the group's cached buffer,
  then the rank-order sum) against B4 as first formulated (a zero slot
  buffer filled by an all-reduce, the slots added by a loop), computed on
  each rank from the same shard: bitwise equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from photon_ml_tpu.game import CoordinateDescent as JaxCD
from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import GLMProblem as JaxProblem
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game import build_fixed_effect_dataset as jax_build_fe
from photon_ml_tpu.game import build_random_effect_dataset as jax_build_re
from photon_ml_tpu.game.coordinate import _size_buckets as jax_size_buckets
from photon_ml_tpu.models.coefficients import Coefficients as JaxCoefficients
from photon_ml_tpu.models.game import FixedEffectModel as JaxFEModel
from photon_ml_tpu.models.game import RandomEffectModel as JaxREModel
from photon_ml_tpu.models.glm import model_for_task as jax_model_for_task
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOpt
from photon_ml_tpu.parallel import make_mesh
from photon_ml_tpu.parallel import shard_batch as jax_shard_batch
from photon_ml_tpu.parallel import shard_entity_blocks as jax_shard_entity_blocks
from photon_ml_tpu.parallel.multihost import equal_host_share as jax_equal_host_share
from photon_ml_tpu.parallel.multihost import host_row_range as jax_host_row_range
from photon_ml_tpu.testing import generate_mixed_effect_data
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset
from photon_ml_tpu_torch.game import build_random_effect_dataset
from photon_ml_tpu_torch.game.coordinate import _size_buckets
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.ops import fused_glm as fg
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.parallel import (
    DataParallelGroup,
    MeshGroup,
    entity_range,
    equal_host_share,
    host_row_range,
    local_batch,
    row_range,
    shard_batch,
    shard_coefficients,
    spawn,
)

F32 = np.float32
TIMEOUT_S = 120.0
B4_N, B4_D = pallas_glm.MIN_FUSED_ROWS + 13, 128  # ragged on every world size
B4_LOSSES = ("logistic", "poisson")


def _b4_case(seed, loss, n=B4_N, d=B4_D):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(F32)
    return dict(
        loss=loss,
        x=rng.standard_normal((n, d)).astype(F32),
        y=y * 2 if loss == "poisson" else y,
        off=(rng.standard_normal(n) * 0.1).astype(F32),
        wt=(rng.random(n) + 0.5).astype(F32),
        coef=(rng.standard_normal(d) * 0.1).astype(F32),
        v=rng.standard_normal(d).astype(F32),
        vshift=0.25,
    )


def _mixed():
    """test_parallel.py::test_full_game_descent_on_mesh's data."""
    data = generate_mixed_effect_data(n=640, d_fixed=6, re_specs={"userId": (16, 3)}, seed=13)
    return data, mixed_data_to_raw_dataset(data)


def _cd_payload(raw, gx, sweeps=2, pad_entities=4):
    opt = dict(tolerance=1e-8, max_iterations=100)
    fields = ("n_rows", "labels", "offsets", "weights", "shard_coo", "shard_dims", "id_tags")
    return dict(
        raw={f: getattr(raw, f) for f in fields}, gx=np.asarray(gx, np.float64), fe_opt=opt,
        re_opt=opt, re_shard="userShard", pad_entities=pad_entities, sweeps=sweeps,
    )


def _solve_payload():
    rng = np.random.default_rng(1)
    n, d = pallas_glm.MIN_FUSED_ROWS, B4_D
    return dict(
        x=rng.standard_normal((n, d)).astype(F32), y=(rng.random(n) > 0.5).astype(F32),
        off=(rng.standard_normal(n) * 0.1).astype(F32), wt=(rng.random(n) + 0.5).astype(F32),
    )


def _pad_payload():
    rng = np.random.default_rng(2)
    return dict(x=rng.standard_normal((102, 6)), y=(rng.random(102) > 0.5).astype(np.float64))


def _run(tmp_path_factory, fn, world, payload):
    store = tmp_path_factory.mktemp(f"world{world}")
    return spawn(
        f"test_torch_parallel_ranks:{fn}", world, "gloo", "cpu", args=(payload,),
        timeout_s=TIMEOUT_S, store_dir=store,
    )


@pytest.fixture(scope="module")
def b4_cases():
    return [_b4_case(10 + i, loss) for i, loss in enumerate(B4_LOSSES)]


@pytest.fixture(scope="module")
def four(tmp_path_factory, b4_cases):
    data, raw = _mixed()
    payload = dict(
        b4=b4_cases, gather=True, pad=_pad_payload(), solve=_solve_payload(),
        cd=_cd_payload(raw, data.global_x),
    )
    return _run(tmp_path_factory, "checks", 4, payload)


@pytest.fixture(scope="module")
def two(tmp_path_factory, b4_cases):
    return _run(tmp_path_factory, "checks", 2, dict(b4=b4_cases, gather=True, pad=_pad_payload()))


@pytest.fixture(scope="module")
def worlds(four, two):
    return {4: four, 2: two}


@pytest.fixture(scope="module")
def jax_b4(b4_cases):
    """JAX ``sharded_*`` (Pallas interpret mode) on a 4-way data mesh."""
    mesh = make_mesh(n_data=4)
    refs = []
    for case in b4_cases:
        b = jax_shard_batch(
            jax_batch(case["x"], case["y"], offsets=case["off"], weights=case["wt"], dtype=jnp.float32),
            mesh,
        )
        loss = JAX_LOSSES[case["loss"]]
        args = (mesh, b.features.dense, jnp.asarray(case["coef"]))
        rows = (b.labels, b.offsets, b.weights)
        vg = pallas_glm.sharded_value_grad(*args, *rows, loss, interpret=True)
        hv = pallas_glm.sharded_hessian_vector(
            *args, jnp.asarray(case["v"]), *rows, jnp.asarray(case["vshift"], jnp.float32), loss,
            interpret=True,
        )
        hd = pallas_glm.sharded_hessian_stats(*args, *rows, loss, interpret=True)
        hds = pallas_glm.sharded_hessian_stats(*args, *rows, loss, interpret=True, need_shifts=True)
        refs.append({
            k: tuple(None if o is None else np.asarray(o) for o in outs)
            for k, outs in (("vg", vg), ("hv", hv), ("hd", hd), ("hds", hds))
        })
    return refs


def _close_vec(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref))
    bound = 3e-5 * max(np.max(np.abs(ref)), 1.0)
    assert err <= bound, f"{what}: max-abs error {err:.3e} > bound {bound:.3e}"


def _close_sum(got, ref, what):
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-5, atol=1e-4, err_msg=what)


def _same(a, b, path="out"):
    """Bitwise equality of nested results (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype == object:
        assert list(a) == list(b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = lambda t: np.ascontiguousarray(t).reshape(-1).view(np.uint8)  # noqa: E731
        assert np.array_equal(bits(a), bits(b)), f"{path} differs bitwise"
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


# ----------------------------------------------------------------- B4 on ranks


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case_i", range(len(B4_LOSSES)), ids=B4_LOSSES)
def test_b4_matches_jax_sharded_kernels(worlds, jax_b4, world, case_i):
    got, ref = worlds[world][0]["b4"][case_i], jax_b4[case_i]
    np.testing.assert_allclose(float(got["vg"][0]), float(ref["vg"][0]), rtol=2e-6)
    _close_vec(got["vg"][1], ref["vg"][1], "gradient")
    _close_sum(got["vg"][2], ref["vg"][2], "sum of wt*dz")
    _close_vec(got["hv"][0], ref["hv"][0], "Hv")
    _close_sum(got["hv"][1], ref["hv"][1], "sum of c*u")
    _close_vec(got["hd"][0], ref["hd"][0], "s2 without shifts")
    assert got["hd"][1] is None and got["hd"][2] is None
    _close_vec(got["hds"][0], ref["hds"][0], "s2")
    _close_vec(got["hds"][1], ref["hds"][1], "s1")
    _close_sum(got["hds"][2], ref["hds"][2], "s0")


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_gets_bitwise_the_same_sums(worlds, world):
    """The rank-order float64 sum: replicated solver loops see one value."""
    results = worlds[world]
    for r in range(1, world):
        _same(results[r]["b4"], results[0]["b4"], f"rank {r} b4")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_b4_is_bitwise_the_all_reduce_formulation(worlds, one, world):
    """Every function, with and without shifts, on ragged n: the
    all-gathered slot rows and the rank-order sum give the bits of the
    zero-buffer all-reduce and its loop, on every rank."""
    if world == 1:
        got, want = one["b4_all_reduce"]
        _same(got, want, "world 1 b4")
        return
    for rank, out in enumerate(worlds[world]):
        for i, (got, want) in enumerate(zip(out["b4"], out["b4_all_reduce"])):
            _same(got, want, f"rank {rank} case {i}")


@pytest.mark.parametrize("world", [2, 4])
def test_collective_seconds_count_every_b4_call(worlds, b4_cases, world):
    """One collective per B4 call (four calls a case), with non-negative
    seconds, read through ``collective_seconds``."""
    for out in worlds[world]:
        count, seconds = out["b4_collectives"]
        assert count == 4 * len(b4_cases)
        assert seconds >= 0.0


def test_slot_buffers_are_cached_per_width_and_device():
    g = DataParallelGroup(1, 3, "cpu", "gloo")
    a = g.slot_buffer(10, "cpu")
    assert a.shape == (3, 10) and a.dtype == torch.float64
    assert g.slot_buffer(10, torch.device("cpu")) is a
    b = g.slot_buffer(11, "cpu")
    assert b is not a and b.shape == (3, 11) and g.slot_buffer(10, "cpu") is a
    for w in range(12, 40):  # the cache stays bounded
        g.slot_buffer(w, "cpu")
    assert len(g._slots) <= 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_rank_order_sum_plain_adds_rows_in_rank_order(world, dtype):
    rng = np.random.default_rng(world)
    slots = rng.standard_normal((world, 33)) * 10.0 ** rng.integers(-8, 9, (world, 33))
    want = slots[0].copy()
    for r in range(1, world):
        want = want + slots[r]
    t = torch.from_numpy(slots)
    got = fg.rank_order_sum(t, dtype)
    assert got.dtype == dtype
    _same(got.numpy(), want.astype(np.float64 if dtype == torch.float64 else np.float32), "sum")
    got += 1.0  # a fresh tensor, never a view of the slots
    assert np.array_equal(t.numpy(), slots)
    if world == 3:  # rank order, not any other: (1e16 + 1) - 1e16 == 0
        order = torch.tensor([[1e16], [1.0], [-1e16]], dtype=torch.float64)
        assert float(fg.rank_order_sum(order, torch.float64)[0]) == 0.0


@pytest.mark.parametrize("mode", [fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS], ids=["vg", "hv", "hd", "hd_shifts"])
def test_split_and_flat_are_inverse(mode):
    d = 5
    flat = torch.arange(fg._out_width(mode, d), dtype=torch.float64)
    outs = fg._split(mode, d, flat)
    assert torch.equal(fg._flat(mode, outs), flat)
    if mode == fg.VG:  # (value, grad, sum wt*dz), as the plain version returns them
        assert float(outs[0]) == d and torch.equal(outs[1], flat[:d]) and float(outs[2]) == d + 1


@pytest.mark.parametrize("world", [2, 4])
def test_row_padding_is_invisible(worlds, world):
    """102 rows pad to a multiple of the world with zero-weight rows."""
    for out in worlds[world]:
        pad = out["pad"]
        assert pad["rows"] == -(-102 // world)
        np.testing.assert_allclose(pad["shard"], pad["whole"], rtol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_slot_gather_is_exact(worlds, world):
    want = [
        np.concatenate([ranks.gather_inputs(r)[i] for r in range(world)])
        for i in range(len(ranks.gather_inputs(0)))
    ]
    for out in worlds[world]:
        assert out["gather_collectives"] == 1  # four tensors, one collective
        _same(out["gather"], want, "gathered")


# ------------------------------------------------------- solve and descent


@pytest.fixture(scope="module")
def jax_solve():
    p = _solve_payload()
    batch = jax_batch(p["x"], p["y"], offsets=p["off"], weights=p["wt"], dtype=jnp.float32)
    problem = JaxProblem(
        task="logistic_regression",
        config=JaxConfig(
            optimizer=JaxOpt(tolerance=1e-9, max_iterations=60), regularization=JaxReg("L2"),
            reg_weight=1.0,
        ),
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_PALLAS", "interpret")
        model, res = problem.run(jax_shard_batch(batch, make_mesh(n_data=4)))
    return np.asarray(model.coefficients.means), float(res.loss)


def test_sharded_solve_matches_jax(four, jax_solve):
    means, loss = jax_solve
    got = four[0]["solve"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert np.max(np.abs(got["means"] - means)) <= 5e-3 * max(np.max(np.abs(means)), 1.0)
    for r in range(1, 4):
        _same(four[r]["solve"], got, f"rank {r} solve")


@pytest.fixture(scope="module")
def jax_descent():
    """test_parallel.py::test_full_game_descent_on_mesh's mesh run, on a
    4-way data mesh, and the local JAX coordinates for scoring."""
    _, raw = _mixed()
    mesh = make_mesh(n_data=4)
    cfg = JaxConfig(optimizer=JaxOpt(tolerance=1e-8, max_iterations=100), regularization=JaxReg("L2"), reg_weight=1.0)

    def coords(sharded):
        fe_ds = jax_build_fe(raw, "global", "global", dtype=jnp.float64)
        re_ds = jax_build_re(
            raw, "per-user", "userShard", "userId", dtype=jnp.float64, pad_entities_to_multiple=4
        )
        if sharded:
            fe_ds = dataclasses.replace(fe_ds, batch=jax_shard_batch(fe_ds.batch, mesh))
            re_ds = dataclasses.replace(re_ds, blocks=jax_shard_entity_blocks(re_ds.blocks, mesh))
        return {
            "global": JaxFEC(dataset=fe_ds, task="logistic_regression", config=cfg),
            "per-user": JaxREC(dataset=re_ds, task="logistic_regression", config=cfg),
        }

    return JaxCD(coords(True), n_iterations=2).run(), coords(False)


def test_glmix_descent_matches_jax_mesh(four, jax_descent):
    jr, _ = jax_descent
    got = four[0]["cd"]
    np.testing.assert_allclose(
        got["fe_means"], np.asarray(jr.model["global"].model.coefficients.means), atol=1e-7
    )
    np.testing.assert_allclose(got["re_values"], np.asarray(jr.model["per-user"].coef_values), atol=1e-7)
    for r in range(1, 4):
        _same(four[r]["cd"], got, f"rank {r} descent")
    # every update of both coordinates went through collectives
    assert min(got["collectives"].values()) > 0


def test_a_carried_model_warm_starts_and_scores_as_its_own(four):
    """A 4-rank random-effect model read back from numpy (no provenance)
    warm-starts the entity-sharded coordinate and scores exactly as the
    model it came from."""
    warm = four[0]["cd"]["warm"]
    _same(warm["carried"], warm["own"], "warm start")
    _same(warm["score_carried"], warm["score_own"], "scores")


def test_four_rank_model_converts_and_scores_in_jax(four, jax_descent):
    _, jc = jax_descent
    parts = four[0]["cd"]["model"]
    fe, re_ = parts["models"]["global"], parts["models"]["per-user"]
    jfe = JaxFEModel(
        model=jax_model_for_task(fe["task"], JaxCoefficients(means=jnp.asarray(fe["means"]))),
        feature_shard=fe["feature_shard"],
    )
    jre = JaxREModel(
        random_effect_type=re_["random_effect_type"], feature_shard=re_["feature_shard"],
        task=re_["task"], entity_ids=np.asarray(re_["entity_ids"], dtype=object),
        coef_indices=jnp.asarray(re_["coef_indices"]), coef_values=jnp.asarray(re_["coef_values"]),
    )
    jscores = np.asarray(jc["global"].score(jfe)) + np.asarray(jc["per-user"].score(jre))
    np.testing.assert_allclose(four[0]["cd"]["scores"], jscores, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------- world one


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    data, raw = _mixed()
    cd = _cd_payload(raw, data.global_x, sweeps=1, pad_entities=1)
    cd["fe_opt"] = dict(tolerance=1e-6, max_iterations=10)
    payload = dict(b4=_b4_case(7, "logistic"), solve=_solve_payload(), cd=cd)
    return _run(tmp_path_factory, "world_one", 1, payload)[0]


@pytest.mark.parametrize("what", ["b4", "solve", "cd"])
def test_one_rank_group_is_bitwise_the_unsharded_path(one, what):
    got, want = one[what]
    if what == "cd":
        # the collective counts are the one thing that differs
        assert min(got.pop("collectives").values()) > 0
        assert set(want.pop("collectives").values()) == {0}
    _same(got, want, what)


# ------------------------------------------------------ host-side helpers


def test_row_splits_match_the_jax_package():
    for n, p in ((100, 8), (4109, 4), (499_999, 4), (7, 3)):
        assert equal_host_share(n, p) == jax_equal_host_share(n, p)
        for i in range(p):
            assert host_row_range(n, i, p) == jax_host_row_range(n, i, p)
            start, stop = row_range(n, DataParallelGroup(i, p, "cpu", "gloo"))
            share = equal_host_share(n, p)
            assert (start, stop) == (min(i * share, n), min((i + 1) * share, n))


def test_shard_batch_keeps_each_ranks_rows_and_pads_the_last():
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal((10, 3)).astype(F32), np.ones(10, F32)
    whole = batch_from_dense(x, y, device="cpu")
    shards = [shard_batch(whole, DataParallelGroup(r, 4, "cpu", "gloo")) for r in range(4)]
    assert [s.n_rows for s in shards] == [3] * 4
    np.testing.assert_array_equal(torch.cat([s.features.dense for s in shards])[:10].numpy(), x)
    np.testing.assert_array_equal(shards[3].weights.numpy(), [1, 0, 0])
    # a rank that read only its own rows makes the same shard
    g3 = DataParallelGroup(3, 4, "cpu", "gloo")
    own = local_batch(batch_from_dense(x[9:], y[9:], device="cpu"), 10, g3)
    for a, b in ((own.features.dense, shards[3].features.dense), (own.weights, shards[3].weights)):
        assert torch.equal(a, b)
    assert own.group is g3 and shards[3].group.rank == 3
    # the dense feature-axis shard: each rank of a 2 x 2 grid keeps its tile
    # of X zero-padded to [10, 4] (cut from the whole batch, no collective)
    # and its model slice of the coefficients; a data-only group over
    # processes has no model axis (the JAX package's words)
    xp = np.zeros((10, 4), F32)
    xp[:, :3] = x
    for r in range(4):
        i, j = divmod(r, 2)
        grid = MeshGroup(2, 2, i, j, DataParallelGroup(i, 2, "cpu", "gloo"), DataParallelGroup(j, 2, "cpu", "gloo"),
                         DataParallelGroup(r, 4, "cpu", "gloo"))
        tb = shard_batch(whole, grid, shard_features_dim=True)
        np.testing.assert_array_equal(tb.features.tile.dense.numpy(), xp[i * 5 : (i + 1) * 5, j * 2 : (j + 1) * 2])
        np.testing.assert_array_equal(tb.weights.numpy(), np.ones(5, F32))
        assert tb.group is grid.data and (tb.features.dim, tb.features.dim_true, tb.features.n_rows) == (4, 3, 10)
        np.testing.assert_array_equal(shard_coefficients(np.arange(3, dtype=F32), grid).numpy(),
                                      np.r_[np.arange(3, dtype=F32), 0][j * 2 : (j + 1) * 2])
    with pytest.raises(NotImplementedError, match="model-axis sharding across processes is not supported yet"):
        shard_batch(whole, g3, shard_features_dim=True)
    with pytest.raises(ValueError, match="already sharded"):
        shard_batch(shards[0], g3)
    with pytest.raises(ValueError, match="rows"):
        local_batch(whole, 10, g3)


def test_entity_ranges_and_aligned_buckets_match_the_jax_package():
    """The bucket rule with ``align`` (the ranks' entity chunk) is the JAX
    package's, at a skewed shape where aligning merges buckets."""
    gen = generate_mixed_effect_data(n=6000, d_fixed=4, re_specs={"userId": (300, 5)}, seed=4)
    jraw = mixed_data_to_raw_dataset(gen)
    fields = ("n_rows", "labels", "offsets", "weights", "shard_coo", "shard_dims", "id_tags")
    traw = RawDataset(**{f: getattr(jraw, f) for f in fields})
    kw = dict(active_cap=256, pad_entities_to_multiple=4)
    jd = jax_build_re(jraw, "per-user", "userShard", "userId", **kw)
    td = build_random_effect_dataset(traw, "per-user", "userShard", "userId", device="cpu", **kw)
    E = td.num_entities
    assert E % 4 == 0
    for align in (1, E // 4, E // 2):
        assert _size_buckets(td, align=align) == jax_size_buckets(jd, align=align)
    aligned = _size_buckets(td, align=E // 4)
    assert all(s % (E // 4) == 0 for s, _, _, _ in aligned)
    assert [entity_range(E, DataParallelGroup(r, 4, "cpu", "gloo")) for r in range(4)] == [
        (r * E // 4, (r + 1) * E // 4) for r in range(4)
    ]
    with pytest.raises(ValueError, match="pad_entities_to_multiple=3"):
        entity_range(E + 1, DataParallelGroup(0, 3, "cpu", "gloo"))


def test_spawn_reports_a_failed_rank_and_a_hung_one(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn("test_torch_parallel_ranks:fail_on_rank_one", 2, "gloo", "cpu", timeout_s=TIMEOUT_S, store_dir=tmp_path)
    with pytest.raises(TimeoutError, match=r"ranks \[0\]"):
        spawn("test_torch_parallel_ranks:hang", 1, "gloo", "cpu", args=(60.0,), timeout_s=8.0, store_dir=tmp_path)
    assert not list(tmp_path.iterdir())  # each run's directory is removed
