"""The port's legacy GLM driver (``photon_ml_tpu_torch.cli.glm``, run with
``--device cpu``) against the JAX package's (``photon_ml_tpu.cli.glm``) on
generated fixtures shaped like tests/test_legacy_driver.py's heart data (13
features on different scales, an Avro train/validation pair and the same
rows as LIBSVM text): the same stage; per lambda the loss at rtol 1e-5 and,
for the port's float64 run (the JAX package's dtype under the suite's
x64), the coefficients at rtol 1e-3 / atol 1e-5; validation AUC within
1e-4; the same model.txt keys; and each package's Avro models load in the
other."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu import io as ref_io
from photon_ml_tpu.cli import glm as ref_glm
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu.testing import generate_glm_data
from photon_ml_tpu_torch import io as port_io
from photon_ml_tpu_torch.cli import glm as port_glm

N_TRAIN, N_VAL, D = 300, 100, 13


@pytest.fixture(scope="module")
def heart_like(tmp_path_factory):
    """Logistic rows over 13 named features with heart.avro's spread of
    scales and offsets, as Avro (train, validation) and as LIBSVM text."""
    d = tmp_path_factory.mktemp("heart_like")
    x, y, _ = generate_glm_data(n=N_TRAIN + N_VAL, d=D + 1, seed=3, noise=1.0)
    x = x[:, :D] * np.linspace(0.5, 20.0, D) + np.linspace(-3.0, 50.0, D)
    recs = [{"label": float(y[i]),
             "features": [{"name": f"f{j}", "term": "", "value": float(x[i, j])} for j in range(D)]}
            for i in range(N_TRAIN + N_VAL)]
    train, val = str(d / "train.avro"), str(d / "validation.avro")
    ref_io.write_avro_file(train, TRAINING_EXAMPLE_AVRO, recs[:N_TRAIN])
    ref_io.write_avro_file(val, TRAINING_EXAMPLE_AVRO, recs[N_TRAIN:])
    txt = str(d / "train.txt")
    with open(txt, "w") as f:
        for i in range(N_TRAIN):
            f.write(("+1" if y[i] > 0 else "-1") + " " + " ".join(f"{j + 1}:{x[i, j]:.6f}" for j in range(D)) + "\n")
    cmap = str(d / "constraints.json")
    with open(cmap, "w") as f:
        json.dump({key: [-0.01, 0.01] for key in [f"f{j}\x01" for j in range(D)] + [ref_io.INTERCEPT_KEY]}, f)
    return {"train": train, "val": val, "txt": txt, "cmap": cmap}


CASES = {
    "avro": lambda fx: ["--input-data", fx["train"], "--validation-data", fx["val"], "--optimizer", "TRON",
                        "--max-iterations", "30", "--regularization-type", "L2",
                        "--regularization-weights", "0.1|1|10", "--normalization", "STANDARDIZATION",
                        "--evaluators", "AUC"],
    "libsvm": lambda fx: ["--input-data", fx["txt"], "--input-format", "LIBSVM", "--regularization-type", "L2",
                          "--regularization-weights", "1", "--normalization", "STANDARDIZATION"],
    "box_constraints": lambda fx: ["--input-data", fx["train"], "--optimizer", "LBFGSB",
                                   "--regularization-weights", "1", "--constraint-map", fx["cmap"]],
    "standardization_simple": lambda fx: ["--input-data", fx["train"], "--validation-data", fx["val"],
                                          "--optimizer", "TRON", "--regularization-type", "L2",
                                          "--regularization-weights", "0.1|1|10",
                                          "--normalization", "STANDARDIZATION", "--variance-type", "SIMPLE",
                                          "--evaluators", "AUC"],
}


def _model_txt(path):
    with open(path) as f:
        pairs = [line.split("\t") for line in f.read().strip().split("\n")]
    return [k for k, _ in pairs], np.asarray([float(v) for _, v in pairs])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_driver_matches_the_reference(tmp_path, heart_like, case, dtype):
    argv = CASES[case](heart_like) + ["--log-level", "WARNING"]
    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = ref_glm.run(argv + ["--output-dir", ref_out])
    got = port_glm.run(argv + ["--output-dir", port_out, "--device", "cpu", "--dtype", dtype])
    assert got["stage"] == ref["stage"]
    assert got["best_reg_weight"] == ref["best_reg_weight"]
    assert [m["reg_weight"] for m in got["models"]] == [m["reg_weight"] for m in ref["models"]]
    for m_got, m_ref in zip(got["models"], ref["models"]):
        np.testing.assert_allclose(m_got["loss"], m_ref["loss"], rtol=1e-5)
        if m_ref["metrics"] is not None:
            assert abs(m_got["metrics"]["AUC"] - m_ref["metrics"]["AUC"]) <= 1e-4
        sub = f"lambda-{m_ref['reg_weight']}"
        keys_r, coef_r = _model_txt(os.path.join(ref_out, sub, "model.txt"))
        keys_p, coef_p = _model_txt(os.path.join(port_out, sub, "model.txt"))
        assert keys_p == keys_r
        if dtype == "float64":
            # the JAX package trains in float64 under the suite's x64; a
            # float32 solve stops at its own point (ROADMAP C3) and is held
            # by its loss and AUC above
            np.testing.assert_allclose(coef_p, coef_r, rtol=1e-3, atol=1e-5)
        if case == "box_constraints":
            assert np.all(np.abs(coef_p) <= 0.01 + 1e-9)
        if case == "libsvm":
            continue
        # each package's Avro model loads in the other, coefficients bitwise
        # equal to what the other package wrote in model.txt's order
        _, imaps_r = ref_io.read_avro_dataset(heart_like["train"], {"global": ref_io.FeatureShardConfig(("features",))})
        _, imaps_p = port_io.read_avro_dataset(heart_like["train"],
                                               {"global": port_io.FeatureShardConfig(("features",))})
        from_port = ref_io.load_glm(os.path.join(port_out, sub, "model.avro"), imaps_r["global"])
        from_ref = port_io.load_glm(os.path.join(ref_out, sub, "model.avro"), imaps_p["global"], device="cpu",
                                    dtype=torch.float64)
        # model.txt prints each float at its own precision
        np.testing.assert_array_equal(np.asarray(from_port.coefficients.means).astype(dtype), coef_p.astype(dtype))
        np.testing.assert_array_equal(from_ref.coefficients.means.numpy(), coef_r)
        assert (from_ref.coefficients.variances is None) == (from_port.coefficients.variances is None)
        if case == "standardization_simple":
            assert from_port.coefficients.variances is not None
            np.testing.assert_allclose(np.asarray(from_port.coefficients.variances),
                                       from_ref.coefficients.variances.numpy(), rtol=1e-3, atol=1e-5)
    assert set(got["stage_seconds"]) >= {"read", "validate", "statistics", "train", "write_models"}


def test_port_driver_runs_on_the_card_by_default(heart_like, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_glm.run(["--input-data", heart_like["train"], "--output-dir", str(tmp_path / "o")])
