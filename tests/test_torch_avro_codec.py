"""The port's Avro codec against the JAX package's. The port compiles a
schema into one encoder and one decoder a file (and keeps each string's
encoding), and writes a random effect's model records already encoded, so
its files are held to the bytes the JAX package's record-by-record encoder
writes for the same records, schemas and models (the sync marker, drawn at
random a file, pinned), and what it reads to what the JAX package's
decoder reads from the same files, whole and by row range."""

import os
import random

import numpy as np
import pytest
import torch

from photon_ml_tpu import io as ref_io
from photon_ml_tpu.io import index_map as ref_index_map
from photon_ml_tpu.models import Coefficients as RefCoefficients
from photon_ml_tpu.models import LogisticRegressionModel as RefLogistic
from photon_ml_tpu.models.game import FixedEffectModel as RefFE
from photon_ml_tpu.models.game import GameModel as RefGame
from photon_ml_tpu.models.game import RandomEffectModel as RefRE
from photon_ml_tpu_torch import io as port_io
from photon_ml_tpu_torch.io import avro as port_avro
from photon_ml_tpu_torch.io import index_map as port_index_map
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import LogisticRegressionModel


@pytest.fixture
def pinned_sync(monkeypatch):
    """Both packages draw a file's sync marker from os.urandom."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(7, 7 + n)))


# a recursive record with every kind of field the writer encodes
SCHEMA = {"type": "record", "name": "Node", "namespace": "t", "fields": [
    {"name": "any", "type": ["null", "string", "long", "double", "boolean", "bytes"]},
    {"name": "items", "type": {"type": "array", "items": {"type": "record", "name": "Item", "fields": [
        {"name": "name", "type": "string"}, {"name": "value", "type": "float"}]}}},
    {"name": "tags", "type": {"type": "map", "values": ["null", "long"]}, "default": {}},
    {"name": "kind", "type": {"type": "enum", "name": "Kind", "symbols": ["A", "B", "C"]}},
    {"name": "digest", "type": {"type": "fixed", "name": "Digest", "size": 3}},
    {"name": "first", "type": "Item", "default": {"name": "z", "value": 1.0}},
    {"name": "blob", "type": {"type": "union", "types": ["null", "bytes"]}},
    {"name": "count", "type": "long"},
    {"name": "flag", "type": "boolean", "default": False},
    {"name": "next", "type": ["null", "Node"], "default": None},
]}


def _records(n, seed):
    rng = random.Random(seed)

    def node(depth):
        rec = {
            "any": rng.choice([None, "sé", "", 5, -7, 2.5, True, False, 10 ** 12, b"\x00\x01"]),
            "items": [{"name": rng.choice(["f1", "f2", "ü" * rng.randint(0, 90)]), "value": rng.random()}
                      for _ in range(rng.randint(0, 5))],
            "tags": {str(k): rng.choice([None, -(10 ** 15), 3]) for k in range(rng.randint(0, 3))},
            "kind": rng.choice("ABC"), "digest": b"abc", "blob": rng.choice([None, b"", b"\x00" * 300]),
            "count": rng.choice([0, -1, 1, 63, 64, -64, -65, 2047, 2048, 4095, 4096, 2 ** 62, -(2 ** 63), 2 ** 63 - 1]),
        }
        if rng.random() < 0.5:
            rec["first"] = {"name": "x" * rng.randint(0, 70), "value": -rng.random()}
        if rng.random() < 0.3:
            rec["flag"] = True
        if depth < 3 and rng.random() < 0.5:
            rec["next"] = node(depth + 1)
        return rec

    return [node(0) for _ in range(n)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("block", [1, 7, 4000])
def test_writer_bytes_are_the_reference_writers(tmp_path, pinned_sync, codec, block):
    recs = _records(300, seed=block)
    p_ref, p_port = str(tmp_path / "ref.avro"), str(tmp_path / "port.avro")
    ref_io.write_avro_file(p_ref, SCHEMA, recs, codec=codec, sync_interval_records=block)
    port_avro.write_avro_file(p_port, SCHEMA, recs, codec=codec, sync_interval_records=block)
    assert open(p_port, "rb").read() == open(p_ref, "rb").read()
    assert port_avro.read_avro_file(p_port)[1] == ref_io.read_avro_file(p_ref)[1]


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("block", [1, 7, 4000])
def test_reader_reads_what_the_reference_reads(tmp_path, codec, block):
    recs = _records(300, seed=100 + block)
    path = str(tmp_path / "ref.avro")
    ref_io.write_avro_file(path, SCHEMA, recs, codec=codec, sync_interval_records=block)
    schema, got = port_avro.read_avro_file(path)
    ref_schema, want = ref_io.read_avro_file(path)
    assert schema == ref_schema and got == want
    for row_range in ((0, 1), (5, 299), (150, 150), (290, 1000)):
        assert port_avro.read_avro_file(path, row_range=row_range)[1] == want[row_range[0]:row_range[1]]


@pytest.mark.parametrize("bad, error", [
    ({"any": 1.5j}, ValueError),  # no union branch takes it
    ({"count": None}, TypeError),
    ({"kind": "D"}, ValueError),  # not a symbol
])
def test_writer_refuses_what_the_reference_refuses(tmp_path, bad, error):
    rec = {**_records(1, seed=3)[0], **bad}
    for write in (ref_io.write_avro_file, port_avro.write_avro_file):
        with pytest.raises(error):
            write(str(tmp_path / "x.avro"), SCHEMA, [rec])
    missing = {k: v for k, v in _records(1, seed=4)[0].items() if k != "count"}
    for write in (ref_io.write_avro_file, port_avro.write_avro_file):
        with pytest.raises(KeyError, match="count"):
            write(str(tmp_path / "y.avro"), SCHEMA, [missing])


def test_encoded_records_are_written_as_they_are(tmp_path, pinned_sync):
    """``encoded=True`` takes each record's encoding: the file is the one
    the schema's encoder writes."""
    from photon_ml_tpu_torch.io.avro import _encoder, parse_schema

    recs = _records(50, seed=9)
    schema, env = parse_schema(SCHEMA)
    encode = _encoder(schema, env)
    encoded = []
    for rec in recs:
        chunks = []
        encode(chunks.append, rec)
        encoded.append(b"".join(chunks))
    a, b = str(tmp_path / "a.avro"), str(tmp_path / "b.avro")
    port_avro.write_avro_file(a, SCHEMA, recs, sync_interval_records=8)
    port_avro.write_avro_file(b, SCHEMA, encoded, sync_interval_records=8, encoded=True)
    assert open(a, "rb").read() == open(b, "rb").read()


def _models(n_entities, width, dtype, with_variances, seed=5):
    rng = np.random.default_rng(seed)
    fe = rng.normal(size=6).astype(dtype)
    idx = np.stack([rng.permutation(width) for _ in range(n_entities)]).astype(np.int32) if n_entities else (
        np.zeros((0, width), np.int32))
    idx[::3, -2:] = -1
    val = np.where(idx >= 0, rng.normal(size=idx.shape), 0.0).astype(dtype)
    val[::5, 0] = 0.0
    var = np.where(idx >= 0, rng.uniform(0.1, 1, size=idx.shape), 0.0).astype(dtype) if with_variances else None
    ids = np.asarray([f"u{e}" for e in range(n_entities)], dtype=object)
    ref = RefGame(models={
        "global": RefFE(model=RefLogistic(RefCoefficients(fe)), feature_shard="globalShard"),
        "per-user": RefRE(random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
                          entity_ids=ids, coef_indices=idx, coef_values=val, variances=var),
    }, task="logistic_regression")
    port = GameModel(models={
        "global": FixedEffectModel(model=LogisticRegressionModel(Coefficients(torch.from_numpy(fe))),
                                   feature_shard="globalShard"),
        "per-user": RandomEffectModel(random_effect_type="userId", feature_shard="userShard",
                                      task="logistic_regression", entity_ids=ids, coef_indices=torch.from_numpy(idx),
                                      coef_values=torch.from_numpy(val),
                                      variances=None if var is None else torch.from_numpy(var)),
    }, task="logistic_regression")
    return ref, port


@pytest.mark.parametrize("n_entities, records_per_file", [(0, 10), (40, 100_000), (40, 10), (37, 10)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_variances, threshold", [(True, 0.0), (False, 0.0), (True, 0.5)])
def test_game_model_files_are_the_reference_packages(tmp_path, pinned_sync, n_entities, records_per_file, dtype,
                                                     with_variances, threshold):
    """A GAME model saved by either package: the same files, byte for byte
    (the random effect's part files included, an empty last part when the
    records fill whole files), and the port loads its own back."""
    width = 4
    pairs = [(f"g{j}", "t" if j % 2 else "") for j in range(5)]
    upairs = [(f"u{j}", "x" * j) for j in range(width)]
    imaps_r = {"globalShard": ref_index_map.IndexMap.from_name_terms(pairs),
               "userShard": ref_index_map.IndexMap.from_name_terms(upairs, add_intercept=False)}
    imaps_p = {"globalShard": port_index_map.IndexMap.from_name_terms(pairs),
               "userShard": port_index_map.IndexMap.from_name_terms(upairs, add_intercept=False)}
    ref, port = _models(n_entities, width, dtype, with_variances)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_io.save_game_model(d_ref, ref, imaps_r, sparsity_threshold=threshold, records_per_file=records_per_file)
    port_io.save_game_model(d_port, port, imaps_p, sparsity_threshold=threshold, records_per_file=records_per_file)

    def files(root):
        return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)

    assert files(d_port) == files(d_ref)
    for f in files(d_ref):
        assert open(os.path.join(d_port, f), "rb").read() == open(os.path.join(d_ref, f), "rb").read(), f
    back = port_io.load_game_model(d_port, imaps_p, device="cpu", dtype=torch.float64)
    assert list(back["per-user"].entity_ids) == [f"u{e}" for e in range(n_entities)]
