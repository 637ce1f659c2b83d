"""The port's copy of the tuning package (``photon_ml_tpu_torch.tuning``)
against the JAX package's (``photon_ml_tpu.tuning``): the 15 cases of
tests/test_tuning.py with their seeds, each run through both packages.
Both are numpy and scipy, so every output (candidates, GP posteriors, EI
values, rescaling, serialization, shrunk bounds) must be bitwise equal; the
reference's own assertions then hold on the port's outputs."""

import numpy as np
import pytest

import photon_ml_tpu.tuning as ref_tuning
import photon_ml_tpu_torch.tuning as port_tuning
from photon_ml_tpu.tuning import rescaling as ref_rescaling
from photon_ml_tpu_torch.tuning import rescaling as port_rescaling

PACKAGES = {"ref": (ref_tuning, ref_rescaling), "port": (port_tuning, port_rescaling)}


def _both(case):
    """Run ``case(tuning, rescaling)`` through each package; the outputs
    must be equal bit for bit (arrays, floats, nested containers)."""
    ref = case(*PACKAGES["ref"])
    port = case(*PACKAGES["port"])
    _assert_bitwise(port, ref)
    return port


def _assert_bitwise(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    elif isinstance(a, (np.ndarray, np.generic, float, int)):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes(), f"{x} != {y}"
    else:
        assert a == b


def _obs(observations):
    return [(np.asarray(o.candidate), float(o.value)) for o in observations]


def test_kernels_psd():
    def case(T, _):
        x = np.random.default_rng(0).uniform(size=(20, 3))
        return [k.cov(x) for k in (T.RBF(lengthscale=np.asarray([0.5])), T.Matern52(lengthscale=np.asarray([0.5])))]

    for kern, k in zip((port_tuning.RBF(), port_tuning.Matern52()), _both(case)):
        np.testing.assert_allclose(k, k.T, atol=1e-12)
        assert np.linalg.eigvalsh(k).min() > -1e-9
        np.testing.assert_allclose(np.diag(k), kern.amplitude, rtol=1e-10)


def test_gp_interpolates_noise_free():
    def case(T, _):
        x = np.random.default_rng(0).uniform(size=(12, 1)) * 4
        gp = T.GaussianProcessModel(T.Matern52(noise=1e-8, lengthscale=np.asarray([1.0])), x, np.sin(x[:, 0]))
        return [x, *gp.predict(x), *gp.predict(np.linspace(0.2, 3.8, 25)[:, None])]

    x, mu, var, mu2, _ = _both(case)
    np.testing.assert_allclose(mu, np.sin(x[:, 0]), atol=1e-4)
    assert var.max() < 1e-4
    assert np.abs(mu2 - np.sin(np.linspace(0.2, 3.8, 25))).max() < 0.1


def test_gp_estimator_fits_reasonably():
    def case(T, _):
        rng = np.random.default_rng(0)
        x = rng.uniform(size=(25, 2))
        y = np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] + 0.05 * rng.normal(size=25)
        post = T.GaussianProcessEstimator(seed=1).fit(x, y)
        return [y, *post.predict(x)]

    y, mu, _ = _both(case)
    assert np.corrcoef(mu, y)[0, 1] > 0.95


def test_slice_sampler_matches_gaussian():
    def case(T, _):
        logp = lambda x: float(-0.5 * ((x[0] - 2.0) / 1.5) ** 2)  # noqa: E731
        return T.slice_sample(logp, np.zeros(1), 3000, np.random.default_rng(3), burn_in=50)

    samples = _both(case)
    assert abs(samples.mean() - 2.0) < 0.15
    assert abs(samples.std() - 1.5) < 0.2


def test_expected_improvement_properties():
    def case(T, _):
        return [
            T.expected_improvement(0.0, np.asarray([-1.0, 0.0, 1.0]), np.asarray([1.0, 1.0, 1.0])),
            T.expected_improvement(0.0, np.asarray([1.0, 1.0]), np.asarray([0.01, 4.0])),
        ]

    ei, ei2 = _both(case)
    assert ei[0] > ei[1] > ei[2]
    assert ei2[1] > ei2[0]


def test_rescaling_round_trip():
    def case(T, R):
        cfg = T.HyperparameterConfig(params=[
            T.ParamRange("lambda", 1e-4, 1e4, transform="LOG"),
            T.ParamRange("alpha", 0.0, 1.0),
            T.ParamRange("depth", 1, 10, discrete=True),
        ])
        native = cfg.scale_up(np.asarray([0.5, 0.25, 0.47]))
        back = T.HyperparameterConfig.from_json(cfg.to_json())
        return [native, cfg.scale_down(native), cfg.to_json(), back == cfg]

    native, unit, _, same = _both(case)
    np.testing.assert_allclose(native[0], 1.0, rtol=1e-10)
    assert native[1] == 0.25 and native[2] == round(native[2])
    np.testing.assert_allclose(unit[:2], [0.5, 0.25], atol=1e-12)
    assert same


def _quadratic_eval(x):
    # minimum at (0.3, 0.7)
    return float((x[0] - 0.3) ** 2 + (x[1] - 0.7) ** 2), None


def test_random_search_runs():
    obs = _both(lambda T, _: _obs(T.RandomSearch(2, _quadratic_eval, seed=5).find(16)))
    assert len(obs) == 16 and min(v for _, v in obs) < 0.15


def test_bayesian_beats_random():
    def case(T, _):
        rs = _obs(T.RandomSearch(2, _quadratic_eval, seed=11).find(25))
        gp = _obs(T.GaussianProcessSearch(2, _quadratic_eval, seed=11).find(25))
        return rs, gp

    rs, gp = _both(case)
    gp_best = min(v for _, v in gp)
    assert gp_best <= min(v for _, v in rs) + 1e-9 and gp_best < 0.01


def test_bayesian_with_discrete_dim():
    def ev(x):
        return float((x[0] - 0.5) ** 2 + x[1]), None

    obs = _both(lambda T, _: _obs(T.GaussianProcessSearch(2, ev, discrete_params={1: 3}, seed=2).find(12)))
    assert {round(c[1], 6) for c, _ in obs} <= {0.0, 0.5, 1.0}


def test_tuner_factory():
    def case(T, _):
        assert isinstance(T.get_tuner("DUMMY"), T.DummyTuner)
        assert isinstance(T.get_tuner("BAYESIAN"), T.BayesianTuner)
        with pytest.raises(ValueError):
            T.get_tuner("nope")
        return [T.get_tuner("DUMMY").search(5, 2, _quadratic_eval), _obs(T.get_tuner("RANDOM").search(4, 2, _quadratic_eval))]

    dummy, rand = _both(case)
    assert dummy == [] and len(rand) == 4


def test_config_from_json_reference_shape():
    text = (
        '{"tuning_mode": "BAYESIAN", "variables": {'
        '"global.reg_weight": {"type": "DOUBLE", "min": 1e-4, "max": 1e4, "transform": "LOG"},'
        '"alpha": {"type": "DOUBLE", "min": 0.0, "max": 1.0},'
        '"k": {"type": "INT", "min": 0, "max": 8, "transform": "SQRT"}}}'
    )

    def case(T, _):
        mode, hp = T.config_from_json(text)
        mode2, _ = T.config_from_json('{"tuning_mode": "ATLAS", "variables": {}}')
        with pytest.raises(ValueError):
            T.config_from_json('{"tuning_mode": "RANDOM"}')
        with pytest.raises(ValueError):
            T.config_from_json('{"variables": {"a": {"min": 0, "max": 1, "transform": "EXP"}}}')
        return [mode, mode2, hp.to_json(), hp.discrete_dims(), [(p.name, p.transform, p.discrete) for p in hp.params]]

    mode, mode2, _, dims, params = _both(case)
    assert mode == "BAYESIAN" and mode2 == "NONE"
    assert params == [("global.reg_weight", "LOG", False), ("alpha", params[1][1], False), ("k", "SQRT", True)]
    assert dims == {2: 9}


def test_sqrt_transform_round_trip():
    def case(_, R):
        p = R.ParamRange(name="x", min=1.0, max=100.0, transform="SQRT")
        ups = [p.scale_up(u) for u in (0.0, 0.25, 0.5, 1.0)]
        return [ups, [p.scale_down(v) for v in ups]]

    ups, downs = _both(case)
    assert all(1.0 <= v <= 100.0 for v in ups)
    np.testing.assert_allclose(downs, [0.0, 0.25, 0.5, 1.0], atol=1e-12)
    np.testing.assert_allclose(ups[2], 30.25)


def test_prior_json_round_trip_with_defaults():
    names = ["a", "b"]
    priors = [(np.array([0.1, 2.0]), 0.75), (np.array([10.0, 4.0]), 0.9)]
    partial = '{"records": [{"a": "1.0", "evaluationValue": "0.5"}]}'

    def case(T, _):
        text = T.prior_to_json(names, priors)
        with pytest.raises(KeyError):
            T.prior_from_json(partial, {}, names)
        return [text, T.prior_from_json(text, {}, names), T.prior_from_json(partial, {"b": 7.0}, names)]

    _, back, vecs = _both(case)
    for (x0, v0), (x1, v1) in zip(priors, back):
        np.testing.assert_allclose(x0, x1)
        assert v0 == v1
    np.testing.assert_allclose(vecs[0][0], [1.0, 7.0])


def test_shrink_search_range_bounds():
    lams = np.array([1e-4, 1e-2, 1.0, 1e2, 1e4, 0.1, 10.0])
    vals = [float(-(np.log10(l)) ** 2) for l in lams]

    def case(T, _):
        hp = T.HyperparameterConfig(params=[T.ParamRange(name="lam", min=1e-4, max=1e4, transform="LOG")])
        prior = T.prior_to_json(["lam"], [(np.array([l]), v) for l, v in zip(lams, vals)])
        return list(T.get_bounds(hp, prior, radius=0.2, seed=3))

    lo, hi = _both(case)
    assert lo.shape == (1,) and hi.shape == (1,)
    assert 1e-4 <= lo[0] < 1.0 < hi[0] <= 1e4
    assert hi[0] / lo[0] < 1e7


def test_tuner_accepts_grid_observations():
    def case(T, _):
        def ev(x):
            return float((x[0] - 0.3) ** 2), None

        seeds = [T.Observation(candidate=np.array([u]), value=float((u - 0.3) ** 2)) for u in (0.05, 0.35, 0.65, 0.95)]
        return _obs(T.BayesianTuner().search(6, 1, ev, observations=seeds, seed=7))

    obs = _both(case)
    assert len(obs) == 6 and min(v for _, v in obs) < 0.01
