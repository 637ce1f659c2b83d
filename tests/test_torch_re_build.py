"""The port's cross-process random-effect build
(``photon_ml_tpu_torch.game.data_mp.build_random_effect_dataset_global``)
on two gloo CPU ranks against the JAX package's builds, on the cases of
tests/test_re_build.py's ``TestGlobalBuildParity`` (rank bodies in
``tests/_torch_mp_ranks.py``, one spawn under a 120 s timeout):

- at caps and lower bounds (None, 1), (8, 1) and (8, 3), the plan, the
  reservoir order and the block contents, keyed by entity id, bitwise the
  JAX package's host build (``build_random_effect_dataset``) and its
  single-process ``build_random_effect_dataset_global``: the entity order,
  every block array (the active rows mapped from the padded global row
  space back to true rows), the support layout, the entity counts and
  subspace dims, the passive rows, and the scoring arrays on the true rows;
- Pearson selection (``features_to_samples_ratio``): the same kept columns
  and subspace dims as the JAX host build (bitwise: both select in float64
  on the 1e-12 grid);
- a vmapped random-effect solve over the two-rank build: bitwise the
  port's one-process solve, and the JAX package's host-build solve at the
  packed solve's bounds (ROADMAP: coefficients atol 5e-3, loss atol 1e-4),
  its scores on the true rows likewise.

The two ranks split 701 rows 351 / 350, so rank 1's padded row ids are
shifted from its true ones."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game import build_random_effect_dataset as jax_build
from photon_ml_tpu.game.data_mp import build_random_effect_dataset_global as jax_build_global
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOpt
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.testing import generate_mixed_effect_data
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset
from photon_ml_tpu_torch.game import build_random_effect_dataset
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.parallel import equal_host_share, host_row_range, spawn

N, WORLD, TIMEOUT_S = 701, 2, 120.0
CASES = [(None, 1), (8, 1), (8, 3)]
PEARSON = dict(active_cap=8, pad_entities_to_multiple=8, features_to_samples_ratio=0.5)
TRAIN = dict(tolerance=1e-10, max_iterations=50, reg_weight=0.7)
FIELDS = ("n_rows", "labels", "offsets", "weights", "shard_coo", "shard_dims", "id_tags")


def _kw(cap, lower):
    return dict(active_cap=cap, active_lower_bound=lower, pad_entities_to_multiple=8)


@pytest.fixture(scope="module")
def jraw():
    return mixed_data_to_raw_dataset(
        generate_mixed_effect_data(n=N, d_fixed=4, re_specs={"userId": (60, 9)}, seed=5, entity_skew=1.4)
    )


@pytest.fixture(scope="module")
def ranks(jraw, tmp_path_factory):
    payload = dict(
        raw={f: getattr(jraw, f) for f in FIELDS}, shard="userShard", re_type="userId",
        cases=[_kw(*c) for c in CASES] + [PEARSON], train=TRAIN,
    )
    return spawn("_torch_mp_ranks:builds", WORLD, "gloo", "cpu", args=(payload,), timeout_s=TIMEOUT_S,
                 store_dir=tmp_path_factory.mktemp("re_build"))


def _true_ids(padded):
    """Padded global row ids (rank r's row i at r * share + i) -> true ids."""
    share = equal_host_share(N, WORLD)
    starts = np.asarray([host_row_range(N, r, WORLD)[0] for r in range(WORLD)])
    p = np.asarray(padded, np.int64)
    return np.where(p >= 0, starts[np.clip(p // share, 0, WORLD - 1)] + p % share, -1)


def _real_padded_rows():
    share = equal_host_share(N, WORLD)
    sizes = [host_row_range(N, r, WORLD)[1] - host_row_range(N, r, WORLD)[0] for r in range(WORLD)]
    return np.concatenate([np.arange(share) < sizes[r] for r in range(WORLD)])


def _whole(ranks, i, field):
    return torch.cat([r[i][field] for r in ranks]).numpy()


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"cap{c}-lower{lo}" for c, lo in CASES])
def test_two_rank_build_is_the_single_process_plan_and_blocks(jraw, ranks, case):
    kw = _kw(*CASES[case])
    ref = jax_build(jraw, "re", "userShard", "userId", **kw)
    ref_g = jax_build_global(jraw, "re", "userShard", "userId", mesh=make_mesh(n_data=8), **kw)
    got = ranks[0][case]
    assert all(r[case]["entity_ids"] == got["entity_ids"] for r in ranks)
    assert got["entity_ids"] == [str(e) for e in ref.entity_ids] == [str(e) for e in ref_g.entity_ids]
    assert got["n_rows"] == WORLD * equal_host_share(N, WORLD)
    for f in ("features", "labels", "offsets", "weights", "proj_cols"):
        want = np.asarray(getattr(ref.blocks, f))
        ours = _whole(ranks, case, f)
        if f in ("features", "labels", "offsets", "weights"):
            # the port keeps float32 blocks; the JAX build's are float64
            assert np.array_equal(ours, want.astype(ours.dtype)), f
        else:
            assert np.array_equal(ours, want), f
    active = _whole(ranks, case, "active_rows")
    assert np.array_equal(_true_ids(active), np.asarray(ref.blocks.active_rows))
    assert np.array_equal(_true_ids(active), np.asarray(ref_g.blocks.active_rows))
    assert np.array_equal(got["host_proj_cols"], np.asarray(ref.blocks.proj_cols))
    assert np.array_equal(got["entity_counts"], ref.entity_counts)
    assert np.array_equal(got["entity_subspace_dims"], ref.entity_subspace_dims)
    assert np.array_equal(np.sort(_true_ids(got["passive_rows"])), np.sort(np.asarray(ref.passive_rows)))
    real = _real_padded_rows()
    row_entity = _whole(ranks, case, "row_entity")
    assert np.array_equal(row_entity[real], np.asarray(ref.row_entity)) and np.all(row_entity[~real] == -1)
    F = np.asarray(ref.ell_idx).shape[1]
    ell_idx, ell_val = _whole(ranks, case, "ell_idx"), _whole(ranks, case, "ell_val")
    assert np.array_equal(ell_idx[real][:, :F], np.asarray(ref.ell_idx))
    assert np.array_equal(ell_val[real][:, :F], np.asarray(ref.ell_val).astype(np.float32))
    # the port's own one-process build, bitwise
    traw = RawDataset(**{f: getattr(jraw, f) for f in FIELDS})
    one = build_random_effect_dataset(traw, "re", "userShard", "userId", device="cpu", **kw)
    for f in ("features", "labels", "offsets", "weights", "proj_cols"):
        assert torch.equal(torch.from_numpy(_whole(ranks, case, f)), getattr(one.blocks, f)), f


def test_two_rank_pearson_selection_agrees(jraw, ranks):
    ref = jax_build(jraw, "re", "userShard", "userId", **PEARSON)
    got = ranks[0][len(CASES)]
    assert np.array_equal(got["entity_subspace_dims"], ref.entity_subspace_dims)
    assert np.array_equal(got["host_proj_cols"], np.asarray(ref.blocks.proj_cols))
    feats = _whole(ranks, len(CASES), "features")
    assert np.array_equal(feats, np.asarray(ref.blocks.features).astype(feats.dtype))


def test_training_on_the_two_rank_build_matches(jraw, ranks, monkeypatch):
    """A vmapped solve over the two-rank build: the same on both ranks,
    bitwise the port's one-process solve, and at the packed solve's bounds
    from the JAX package's solve over its host build."""
    monkeypatch.setenv("PHOTON_RE_SOLVER", "vmapped")
    from photon_ml_tpu_torch.game import GLMOptimizationConfig, RandomEffectCoordinate
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    a, b = ranks[0][-1], ranks[1][-1]
    assert torch.equal(a["coef_values"], b["coef_values"]) and torch.equal(a["scores"], b["scores"])
    traw = RawDataset(**{f: getattr(jraw, f) for f in FIELDS})
    one = build_random_effect_dataset(traw, "re", "userShard", "userId", device="cpu", dtype=torch.float64,
                                      **_kw(*CASES[0]))
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=TRAIN["tolerance"], max_iterations=TRAIN["max_iterations"]),
        regularization=RegularizationContext("L2"), reg_weight=TRAIN["reg_weight"],
    )
    coord = RandomEffectCoordinate(dataset=one, task="logistic_regression", config=cfg)
    model, res = coord.train(None)
    assert torch.equal(a["coef_values"], model.coef_values)
    real = _real_padded_rows()
    scores = a["scores"].numpy()
    assert np.array_equal(scores[real], coord.score(model).numpy()) and np.all(scores[~real] == 0.0)

    jds = jax_build(jraw, "re", "userShard", "userId", **_kw(*CASES[0]))
    jcfg = JaxConfig(optimizer=JaxOpt(tolerance=TRAIN["tolerance"], max_iterations=TRAIN["max_iterations"]),
                     regularization=JaxReg("L2"), reg_weight=TRAIN["reg_weight"])
    jcoord = JaxREC(dataset=jds, task="logistic_regression", config=jcfg)
    jmodel, jres = jcoord.train(None)
    np.testing.assert_allclose(a["coef_values"].numpy(), np.asarray(jmodel.coef_values), rtol=0, atol=5e-3)
    np.testing.assert_allclose(a["loss"].numpy(), np.asarray(jres.loss), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores[real], np.asarray(jcoord.score(jmodel)), rtol=0, atol=5e-3)
