"""Fixed-effect down-sampling in the port against the JAX package, on the
CPU.

The two packages draw their keep masks from different generators
(``jax.random`` there, a seeded ``torch.Generator`` here), so the port's
draw and its application are separate functions: the application is held
bitwise against the JAX package's ``down_sample`` given the JAX package's
own mask, computed in the test; the draw is held to its seed, to its rate,
and to the world size it must not depend on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game.data import FixedEffectDataset as JaxFEDataset
from photon_ml_tpu.game.sampling import down_sample as jax_down_sample
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOpt
from photon_ml_tpu_torch.game import FixedEffectCoordinate, FixedEffectDataset, GLMOptimizationConfig
from photon_ml_tpu_torch.game import sampling
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import spawn

TASKS = ["logistic_regression", "linear_regression"]


def _data(seed, n=500, d=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = (rng.random(n) > 0.6).astype(np.float64)
    wt = rng.random(n) + 0.5
    return x, y, wt


def _jax_mask(seed, n, rate):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n,)) < rate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("task", TASKS)
def test_down_sampled_weights_equal_jax_given_its_mask(task, rate, dtype):
    x, y, wt = _data(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    seed = 7
    want = jax_down_sample(jax_batch(x, y, weights=wt, dtype=jdt), task, rate, seed).weights
    keep = torch.from_numpy(_jax_mask(seed, len(y), rate))
    got = sampling.apply_keep_mask(batch_from_dense(x, y, weights=wt, dtype=dtype, device="cpu"), task, rate, keep)
    assert got.weights.dtype == dtype
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want))
    if sampling.is_binary_task(task):
        # every positive kept at its weight
        pos = y > 0.5
        np.testing.assert_array_equal(got.weights.numpy()[pos], wt.astype(got.weights.numpy().dtype)[pos])


def test_the_same_seed_draws_the_same_mask():
    a = sampling.draw_keep_mask(100_000, 0.3, 11, "cpu")
    b = sampling.draw_keep_mask(100_000, 0.3, 11, "cpu")
    c = sampling.draw_keep_mask(100_000, 0.3, 12, "cpu")
    assert a.dtype == torch.bool and torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.double().mean()) - 0.3) < 0.01
    for bad in (0.0, 1.5, -0.2):
        with pytest.raises(ValueError, match="rate"):
            sampling.draw_keep_mask(10, bad, 0, "cpu")
    batch = batch_from_dense(*_data(2)[:2], device="cpu")
    assert sampling.down_sample(batch, "logistic_regression", 1.0) is batch


def test_down_sampling_is_independent_of_the_world_size(tmp_path):
    """Two gloo ranks each draw the whole mask and keep their rows: their
    weights, in rank order, are the whole batch's, bitwise (n odd, so the
    last rank holds a padding row)."""
    x, y, wt = _data(3, n=301)
    payload = dict(x=x, y=y, wt=wt, task="logistic_regression", rate=0.35, seed=5)
    out = spawn("test_torch_parallel_ranks:down_sampled_weights", 2, "gloo", "cpu", args=(payload,),
                timeout_s=120.0, store_dir=tmp_path)
    whole = sampling.down_sample(batch_from_dense(x, y, weights=wt, device="cpu"), payload["task"], 0.35, 5)
    np.testing.assert_array_equal(np.concatenate(out), whole.weights.numpy())


def test_down_sampled_fixed_effect_matches_jax_given_its_mask(monkeypatch):
    """FixedEffectCoordinate with down_sampling_rate 0.5 in both packages,
    the port's draw replaced by the JAX package's mask: the same solve on
    the same weights, in float64 (coefficients rtol 1e-6, loss rtol 1e-9);
    the residual scores go into the offsets before the weights change."""
    x, y, wt = _data(4, n=800)
    rate, seed = 0.5, 3
    monkeypatch.setattr(sampling, "draw_keep_mask",
                        lambda n, r, s, device: torch.from_numpy(_jax_mask(s, n, r)).to(device))
    opt = dict(tolerance=1e-10, max_iterations=100)
    jcfg = JaxConfig(optimizer=JaxOpt(**opt), regularization=JaxReg("L2"), reg_weight=1.0, down_sampling_rate=rate)
    tcfg = GLMOptimizationConfig(optimizer=OptimizerConfig(**opt), regularization=RegularizationContext("L2"),
                                 reg_weight=1.0, down_sampling_rate=rate)
    jc = JaxFEC(dataset=JaxFEDataset("g", "g", batch=jax_batch(x, y, weights=wt, dtype=jnp.float64)),
                task="logistic_regression", config=jcfg, down_sampling_seed=seed)
    tc = FixedEffectCoordinate(dataset=FixedEffectDataset("g", "g", batch=batch_from_dense(
        x, y, weights=wt, dtype=torch.float64, device="cpu")), task="logistic_regression", config=tcfg,
        down_sampling_seed=seed)
    residual = np.random.default_rng(6).standard_normal(len(y)) * 0.2
    jm, jr = jc.train(jnp.asarray(residual))
    tm, tr = tc.train(torch.from_numpy(residual))
    np.testing.assert_allclose(tm.model.coefficients.means.numpy(), np.asarray(jm.model.coefficients.means),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-9)
    # the full-rate solve differs: down-sampling changed the problem
    full = dataclasses.replace(tc, config=dataclasses.replace(tcfg, down_sampling_rate=1.0))
    assert abs(float(full.train(torch.from_numpy(residual))[1].loss) - float(tr.loss)) > 1e-3
