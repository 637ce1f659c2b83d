"""The port's data and model IO against the JAX package's, on the same
seeded fixtures: Avro written by either package reads into the other's
``RawDataset`` bit for bit (both engines, the chunked reader at 1, 2 and 4
workers, LIBSVM), schema resolution and the column remap, index maps across
the packages, the validators' decisions, feature statistics, and GLM and
GAME models saved by one package and loaded by the other."""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.io.model_io  # noqa: F401  (ref_io.model_io below: the submodule is no package attribute until imported)
from photon_ml_tpu import io as ref_io
from photon_ml_tpu import native as ref_native
from photon_ml_tpu.io import index_map as ref_index_map
from photon_ml_tpu.io import validators as ref_validators
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu.models import Coefficients as RefCoefficients
from photon_ml_tpu.models import LogisticRegressionModel as RefLogistic
from photon_ml_tpu.models.game import FixedEffectModel as RefFE
from photon_ml_tpu.models.game import GameModel as RefGame
from photon_ml_tpu.models.game import RandomEffectModel as RefRE
from photon_ml_tpu.utils.stats import compute_feature_statistics as ref_stats
from photon_ml_tpu_torch import io as port_io
from photon_ml_tpu_torch import native as port_native
from photon_ml_tpu_torch.io import avro as port_avro
from photon_ml_tpu_torch.io import data as port_data
from photon_ml_tpu_torch.io import index_map as port_index_map
from photon_ml_tpu_torch.io import validators as port_validators
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import LogisticRegressionModel
from photon_ml_tpu_torch.utils.stats import compute_feature_statistics as port_stats

ENGINES = ("python", "native")
needs_native = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()), reason="native decoder not built (no g++/zlib)"
)

USER_SCHEMA = {
    **TRAINING_EXAMPLE_AVRO,
    "fields": TRAINING_EXAMPLE_AVRO["fields"]
    + [{"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}],
}
SHARDS = {"global": ("features",), "user": ("userFeatures",)}


def _shards(pkg):
    return {s: pkg.FeatureShardConfig(bags) for s, bags in SHARDS.items()}


def _mk_records(n=60, d=8, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        cols = rng.choice(d, size=int(rng.integers(1, d)), replace=False)
        ucols = rng.choice(4, size=int(rng.integers(0, 3)), replace=False)
        recs.append({
            "uid": f"uid{i}",
            "label": float(rng.integers(0, 2)),
            "features": [{"name": f"f{c}", "term": "t", "value": float(rng.normal())} for c in cols],
            "userFeatures": [{"name": f"u{c}", "term": "", "value": float(rng.normal())} for c in ucols],
            "metadataMap": {"userId": f"u{i % 7}"},
            "weight": 1.0 + float(rng.uniform()),
            "offset": float(rng.normal() * 0.1),
        })
    return recs


def _write_parts(write, root, n_parts=4, per_part=40, seed=5):
    recs = _mk_records(n=n_parts * per_part, seed=seed)
    os.makedirs(root)
    for i in range(n_parts):
        write(os.path.join(root, f"part-{i:05d}.avro"), USER_SCHEMA, recs[i * per_part : (i + 1) * per_part])
    return root


def _assert_same_dataset(a, b):
    """Bit for bit, COO entry order included."""
    assert a.n_rows == b.n_rows
    for f in ("labels", "offsets", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.shard_dims == b.shard_dims
    assert set(a.shard_coo) == set(b.shard_coo)
    for s in a.shard_coo:
        for x, y in zip(a.shard_coo[s], b.shard_coo[s]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert set(a.id_tags) == set(b.id_tags)
    for t in a.id_tags:
        assert list(a.id_tags[t]) == list(b.id_tags[t])
    assert (a.uids is None) == (b.uids is None)
    if a.uids is not None:
        assert list(a.uids) == list(b.uids)


def _dense(ds, s):
    r, c, v = ds.shard_coo[s]
    x = np.zeros((ds.n_rows, ds.shard_dims[s]))
    x[r, c] = v
    return x


def _same_maps(a, b):
    assert {s: dict(m.items()) for s, m in a.items()} == {s: dict(m.items()) for s, m in b.items()}


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_files_read_across_packages(tmp_path, codec):
    recs = _mk_records(n=25)
    p_ref, p_port = str(tmp_path / "ref.avro"), str(tmp_path / "port.avro")
    ref_io.write_avro_file(p_ref, USER_SCHEMA, recs, codec=codec)
    port_avro.write_avro_file(p_port, USER_SCHEMA, recs, codec=codec)
    for p in (p_ref, p_port):
        s_ref, back_ref = ref_io.read_avro_file(p)
        s_port, back_port = port_avro.read_avro_file(p)
        assert back_ref == back_port == recs
        assert s_ref == s_port
        assert port_avro.count_avro_rows(p) == 25


@pytest.mark.parametrize("engine", [pytest.param(e, marks=needs_native) if e == "native" else e for e in ENGINES])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_avro_reads_into_the_same_raw_dataset(tmp_path, engine, writer):
    """Avro written by either package reads into bit-equal RawDatasets in
    both packages, with index maps built from the data and prebuilt."""
    write = ref_io.write_avro_file if writer == "reference" else port_avro.write_avro_file
    path = _write_parts(write, str(tmp_path / "parts"))
    ref, maps_r = ref_io.read_avro_dataset(path, _shards(ref_io), id_tag_columns=["userId"], engine=engine)
    port, maps_p = port_io.read_avro_dataset(path, _shards(port_io), id_tag_columns=["userId"], engine=engine)
    _assert_same_dataset(ref, port)
    _same_maps(maps_r, maps_p)
    window, _ = port_io.read_avro_dataset(path, _shards(port_io), index_maps=maps_p, id_tag_columns=["userId"],
                                          engine=engine, row_range=(37, 101))
    ref_window, _ = ref_io.read_avro_dataset(path, _shards(ref_io), index_maps=maps_r, id_tag_columns=["userId"],
                                             engine=engine, row_range=(37, 101))
    _assert_same_dataset(ref_window, window)


@pytest.mark.parametrize("engine", [pytest.param(e, marks=needs_native) if e == "native" else e for e in ENGINES])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_chunked_reader_at_any_worker_count(tmp_path, engine, workers):
    """The chunked reader gives the reference's monolithic dataset bit for
    bit at 1, 2 and 4 workers, and counts the parts its engine decoded."""
    path = _write_parts(ref_io.write_avro_file, str(tmp_path / "parts"), n_parts=5)
    ref, maps_r = ref_io.read_avro_dataset(path, _shards(ref_io), id_tag_columns=["userId"], engine=engine)
    port_data.reset_decoded_parts()
    got, maps_p = port_io.read_avro_dataset_chunked(
        path, _shards(port_io), id_tag_columns=["userId"], engine=engine, workers=workers
    )
    _assert_same_dataset(ref, got)
    _same_maps(maps_r, maps_p)
    # python: a keys pass and a data pass over every part; native: one pass
    assert port_data.DECODED_PARTS == {"native": 5 if engine == "native" else 0,
                                       "python": 10 if engine == "python" else 0}


@needs_native
def test_native_and_python_engines_agree(tmp_path):
    path = _write_parts(port_avro.write_avro_file, str(tmp_path / "parts"))
    py, maps_py = port_io.read_avro_dataset(path, _shards(port_io), id_tag_columns=["userId"], engine="python")
    nat, maps_nat = port_io.read_avro_dataset(path, _shards(port_io), id_tag_columns=["userId"], engine="native")
    _same_maps(maps_py, maps_nat)
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(py, f), getattr(nat, f))
    assert list(py.uids) == list(nat.uids) and list(py.id_tags["userId"]) == list(nat.id_tags["userId"])
    for s in SHARDS:
        np.testing.assert_array_equal(_dense(py, s), _dense(nat, s))


def test_native_engine_refuses_reader_schema_and_unknown_engine(tmp_path):
    p = str(tmp_path / "a.avro")
    port_avro.write_avro_file(p, USER_SCHEMA, _mk_records(n=3))
    with pytest.raises(ValueError, match="reader_schema"):
        port_io.read_avro_dataset(p, _shards(port_io), engine="native", reader_schema=USER_SCHEMA)
    with pytest.raises(ValueError, match="unknown engine"):
        port_io.read_avro_dataset(p, _shards(port_io), engine="fast")


def test_libsvm_reads_like_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    p = str(tmp_path / "data.libsvm")
    with open(p, "w") as f:
        for _ in range(40):
            cols = sorted(rng.choice(np.arange(1, 12), size=int(rng.integers(1, 6)), replace=False))
            f.write(("+1" if rng.random() < 0.5 else "-1") + " "
                    + " ".join(f"{c}:{rng.normal():.6f}" for c in cols) + "\n")
    for kw in ({}, {"dim": 15}, {"add_intercept": False}):
        _assert_same_dataset(ref_io.read_libsvm(p, **kw), port_io.read_libsvm(p, **kw))


def test_schema_resolution_evolved_matches_reference(tmp_path):
    """Mirrors tests/test_io.py: a reader field gains a default, a writer
    field is dropped, int promotes to double."""
    writer_schema = {"type": "record", "name": "Row", "fields": [
        {"name": "label", "type": "int"}, {"name": "legacy", "type": "string"},
        {"name": "weight", "type": ["null", "float"], "default": None}]}
    recs = [{"label": 1, "legacy": "drop-me", "weight": 2.5}, {"label": 0, "legacy": "x", "weight": None}]
    p = str(tmp_path / "old.avro")
    port_avro.write_avro_file(p, writer_schema, recs)
    reader_schema = {"type": "record", "name": "Row", "fields": [
        {"name": "label", "type": "double"}, {"name": "weight", "type": ["null", "float"], "default": None},
        {"name": "offset", "type": "double", "default": 0.25}]}
    _, out = port_avro.read_avro_file(p, reader_schema=reader_schema)
    assert out == ref_io.read_avro_file(p, reader_schema=reader_schema)[1]
    assert out[0] == {"label": 1.0, "weight": 2.5, "offset": 0.25} and isinstance(out[0]["label"], float)
    assert port_avro.read_avro_file(p)[1][0]["legacy"] == "drop-me"
    bad_reader = {"type": "record", "name": "Row", "fields": [{"name": "brand_new", "type": "double"}]}
    with pytest.raises(ValueError, match="no default"):
        port_avro.read_avro_file(p, reader_schema=bad_reader)


def test_schema_resolution_nested_and_union_matches_reference(tmp_path):
    feat = {"type": "record", "name": "Feat", "fields": [
        {"name": "name", "type": "string"}, {"name": "value", "type": "float"}]}
    writer_schema = {"type": "record", "name": "Example", "fields": [
        {"name": "features", "type": {"type": "array", "items": feat}}, {"name": "response", "type": "int"}]}
    p = str(tmp_path / "nested.avro")
    ref_io.write_avro_file(p, writer_schema, [{"features": [{"name": "a", "value": 1.5}], "response": 1}])
    reader_feat = {"type": "record", "name": "Feat", "fields": [
        {"name": "name", "type": "string"}, {"name": "value", "type": "double"},
        {"name": "term", "type": "string", "default": ""}]}
    reader_schema = {"type": "record", "name": "Example", "fields": [
        {"name": "features", "type": {"type": "array", "items": reader_feat}},
        {"name": "response", "type": ["null", "double"]}]}
    _, out = port_avro.read_avro_file(p, reader_schema=reader_schema)
    assert out == ref_io.read_avro_file(p, reader_schema=reader_schema)[1]
    assert out[0]["features"] == [{"name": "a", "value": 1.5, "term": ""}] and out[0]["response"] == 1.0
    # the dataset reader resolves through the same schema (Python codec)
    shards = {"g": port_io.FeatureShardConfig(("features",))}
    ds, _ = port_io.read_avro_dataset(p, shards, reader_schema=reader_schema, response_column="response")
    ref_ds, _ = ref_io.read_avro_dataset(p, {"g": ref_io.FeatureShardConfig(("features",))},
                                         reader_schema=reader_schema, response_column="response")
    _assert_same_dataset(ref_ds, ds)


@pytest.mark.parametrize("engine", [pytest.param(e, marks=needs_native) if e == "native" else e for e in ENGINES])
def test_input_columns_remap_matches_reference(tmp_path, engine):
    schema = {"type": "record", "name": "Custom", "fields": [
        {"name": "target", "type": "double"}, {"name": "importance", "type": "double"},
        {"name": "baseline", "type": "double"}, {"name": "rowId", "type": "string"},
        {"name": "tags", "type": {"type": "map", "values": "string"}},
        {"name": "features", "type": {"type": "array", "items": {"type": "record", "name": "FeatureAvro", "fields": [
            {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
            {"name": "value", "type": "double"}]}}}]}
    recs = [{"target": float(i % 2), "importance": 2.0 + i, "baseline": 0.5 * i, "rowId": f"r{i}",
             "tags": {"userId": f"u{i % 3}"}, "features": [{"name": "f", "term": "", "value": 3.0 + i}]}
            for i in range(6)]
    p = str(tmp_path / "custom.avro")
    port_avro.write_avro_file(p, schema, recs)
    spec = "response=target,weight=importance,offset=baseline,uid=rowId,metadataMap=tags"
    got, _ = port_io.read_avro_dataset(p, {"global": port_io.FeatureShardConfig(("features",))},
                                       id_tag_columns=["userId"], response_column="target",
                                       columns=port_io.InputColumnsNames.from_spec(spec), engine=engine)
    ref, _ = ref_io.read_avro_dataset(p, {"global": ref_io.FeatureShardConfig(("features",))},
                                      id_tag_columns=["userId"], response_column="target",
                                      columns=ref_io.InputColumnsNames.from_spec(spec), engine=engine)
    _assert_same_dataset(ref, got)
    assert got.labels[1] == 1.0 and got.weights[0] == 2.0 and got.uids[2] == "r2" and got.id_tags["userId"][4] == "u1"
    with pytest.raises(ValueError, match="unique"):
        port_io.InputColumnsNames.from_spec("response=weight")


@needs_native
def test_native_randomized_schema_parity(tmp_path):
    """Mirrors tests/test_native.py's fuzz: random record schemas decode
    alike through the port's two engines and the JAX package's Python
    codec."""
    rng = random.Random(20260730)

    def random_schema(case):
        fields = [{"name": "label", "type": rng.choice(
            ["double", ["int", "double"], ["double", "float", "int", "long", "boolean", "string"]])}]
        if rng.random() < 0.7:
            fields.append({"name": "weight", "type": rng.choice(
                ["float", ["null", "float"], ["null", "int", "double"]]), "default": None})
        if rng.random() < 0.7:
            fields.append({"name": "offset", "type": ["null", "long", "double"], "default": None})
        if rng.random() < 0.6:
            fields.append({"name": "uid", "type": ["null", "string", "long", "int"], "default": None})
        fields.append({"name": f"junk{case}", "type": rng.choice([
            {"type": "enum", "name": f"E{case}", "symbols": ["A", "B", "C"]},
            {"type": "fixed", "name": f"X{case}", "size": 5},
            {"type": "array", "items": ["null", "string", "double"]},
            {"type": "map", "values": ["null", "long"]},
            {"type": "record", "name": f"N{case}", "fields": [
                {"name": "a", "type": ["null", "string"]}, {"name": "b", "type": "double"}]},
        ])})
        if rng.random() < 0.8:
            fields.append({"name": "metadataMap", "type": rng.choice([
                {"type": "map", "values": "string"},
                ["null", {"type": "map", "values": ["boolean", "long", "string"]}],
            ]), "default": None})
        fields.append({"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": rng.choice(["string", ["null", "string"]])},
                {"name": "value", "type": rng.choice(["double", "float", ["int", "double"]])}]}}})
        return {"type": "record", "name": f"Case{case}", "fields": fields}

    def random_value(t):
        if isinstance(t, list):
            return random_value(rng.choice(t))
        if isinstance(t, dict):
            tt = t["type"]
            if tt == "enum":
                return rng.choice(t["symbols"])
            if tt == "fixed":
                return bytes(rng.randrange(256) for _ in range(t["size"]))
            if tt == "array":
                return [random_value(t["items"]) for _ in range(rng.randrange(3))]
            if tt == "map":
                return {f"k{i}": random_value(t["values"]) for i in range(rng.randrange(3))}
            return {f["name"]: random_value(f["type"]) for f in t["fields"]}
        if t == "null":
            return None
        if t == "boolean":
            return rng.random() < 0.5
        if t in ("int", "long"):
            return rng.randrange(-1000, 1000)
        if t in ("float", "double"):
            return round(rng.uniform(-5, 5), 3)
        return rng.choice(["0.5", "x", "café", "", "-3"])

    for case in range(20):
        schema = random_schema(case)
        by_name = {f["name"]: f["type"] for f in schema["fields"]}
        item = by_name["features"]["items"]["fields"]
        recs = []
        for _ in range(rng.randrange(1, 40)):
            rec = {}
            for f in schema["fields"]:
                if f["name"] == "label":
                    while True:
                        v = random_value(f["type"])
                        try:
                            float(v)
                            break
                        except (TypeError, ValueError):
                            continue
                    rec["label"] = v
                elif f["name"] == "features":
                    rec["features"] = [{"name": f"f{rng.randrange(6)}", "term": random_value(item[1]["type"]),
                                        "value": random_value(item[2]["type"])} for _ in range(rng.randrange(5))]
                else:
                    rec[f["name"]] = random_value(f["type"])
            recs.append(rec)
        p = str(tmp_path / f"fuzz{case}.avro")
        port_avro.write_avro_file(p, schema, recs, codec=rng.choice(["null", "deflate"]))
        kw = dict(id_tag_columns=["k0"])
        py, im = port_io.read_avro_dataset(p, {"global": port_io.FeatureShardConfig(("features",))},
                                           engine="python", **kw)
        nat, im_n = port_io.read_avro_dataset(p, {"global": port_io.FeatureShardConfig(("features",))},
                                              engine="native", **kw)
        ref, _ = ref_io.read_avro_dataset(p, {"global": ref_io.FeatureShardConfig(("features",))},
                                          engine="python", **kw)
        _assert_same_dataset(ref, py)
        assert sorted(im_n["global"].keys()) == sorted(im["global"].keys()), case
        for f in ("labels", "offsets", "weights"):
            np.testing.assert_array_equal(getattr(py, f), getattr(nat, f))
        assert list(py.uids) == list(nat.uids) and list(py.id_tags["k0"]) == list(nat.id_tags["k0"])
        np.testing.assert_array_equal(_dense(py, "global"), _dense(nat, "global"))


KEYS = [f"f{i:04d}\x01t{i % 7}" for i in range(300)]


@pytest.mark.parametrize("store", ["json", "mmap", "partitioned"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_index_maps_load_across_packages(tmp_path, store, writer):
    w_mod, r_mod = (ref_index_map, port_index_map) if writer == "reference" else (port_index_map, ref_index_map)
    imap = w_mod.IndexMap.from_keys(KEYS, add_intercept=True)
    if store == "json":
        p = str(tmp_path / "imap.bin")
        imap.save(p)
        back = r_mod.IndexMap.load(p)
    elif store == "mmap":
        p = str(tmp_path / "store.bin")
        w_mod.MmapIndexMap.write(imap.items(), p)
        back = r_mod.MmapIndexMap.open(p)
    else:
        out = str(tmp_path / "parts")
        w_mod.save_partitioned(imap, out, num_partitions=4, shard="global")
        back = r_mod.load_partitioned(out, "global")
        assert isinstance(back, r_mod.PartitionedIndexMap)
    assert len(back) == len(imap) and dict(back.items()) == dict(imap.items())
    assert back.intercept_index == imap.intercept_index
    for i in (0, 17, len(imap) - 1):
        assert back.get_feature_name(i) == imap.get_feature_name(i)
    assert back.get_index("missing") == -1


def test_v1_index_store_loads_in_the_port(tmp_path):
    imap = ref_index_map.IndexMap.from_keys(["a\x01", "b\x01x"], add_intercept=True)
    out = str(tmp_path / "v1")
    os.makedirs(out)
    imap.save(os.path.join(out, "index-g-00000.bin"))
    with open(os.path.join(out, "_index-g-meta.json"), "w") as f:
        json.dump({"shard": "g", "numPartitions": 1, "size": len(imap)}, f)
    assert dict(port_index_map.load_partitioned(out, "g").items()) == dict(imap.items())
    assert port_index_map.split_feature_key(port_index_map.feature_key("a", "b")) == ("a", "b")


def test_index_driver_writes_maps_the_reference_loads(tmp_path):
    from photon_ml_tpu_torch.cli import index as port_index

    path = _write_parts(port_avro.write_avro_file, str(tmp_path / "parts"), n_parts=2)
    out = str(tmp_path / "index")
    maps = port_index.run(["--input-data", path, "--output-dir", out, "--num-partitions", "3",
                           "--feature-shard", "name=global,bags=features",
                           "--feature-shard", "name=user,bags=userFeatures", "--log-level", "WARNING"])
    _, ref_maps = ref_io.read_avro_dataset(path, _shards(ref_io), engine="python")
    for s in SHARDS:
        assert dict(ref_index_map.load_partitioned(out, s).items()) == dict(ref_maps[s].items())
        assert dict(maps[s].items()) == dict(ref_maps[s].items())


def _raw(pkg, n=6, bad_offsets=(), bad_labels=(), bad_values=(), bad_weights=(), oob_cols=()):
    """tests/test_legacy_driver.py's corrupted linear-regression rows."""
    labels = np.linspace(-1.0, 1.0, n)
    offsets, weights = np.zeros(n), np.ones(n)
    cols, vals = np.zeros(n, dtype=np.int64), np.ones(n)
    labels[list(bad_labels)] = np.nan
    offsets[list(bad_offsets)] = np.inf
    weights[list(bad_weights)] = -1.0
    vals[list(bad_values)] = np.nan
    cols[list(oob_cols)] = 7
    return pkg.RawDataset(n_rows=n, labels=labels, offsets=offsets, weights=weights,
                          shard_coo={"global": (np.arange(n), cols, vals)}, shard_dims={"global": 2}, id_tags={})


def _decision(validators, pkg, kw, task, mode, seed=0):
    raw = _raw(pkg, **kw)
    try:
        count = validators.validate_dataset(raw, task, mode, rng_seed=seed)
    except (validators.DataValidationError, ValueError) as e:
        return type(e).__name__, str(e), None
    return "ok", count, raw


VALIDATION_CASES = [
    ({}, "linear_regression", "VALIDATE_FULL"),
    ({"bad_offsets": (0, 3), "bad_values": (2,)}, "linear_regression", "VALIDATE_FULL"),
    ({"bad_labels": (1,)}, "logistic_regression", "VALIDATE_FULL"),
    ({}, "logistic_regression", "VALIDATE_FULL"),
    ({"bad_weights": (4,)}, "poisson_regression", "VALIDATE_FULL"),
    ({"n": 300, "bad_labels": (17,)}, "linear_regression", "VALIDATE_SAMPLE"),
    ({"bad_labels": (0,), "bad_offsets": (1,), "bad_values": (2,), "bad_weights": (3,)}, "linear_regression",
     "VALIDATE_QUARANTINE"),
    ({"n": 3, "bad_labels": (0, 1, 2)}, "linear_regression", "VALIDATE_QUARANTINE"),
    ({"oob_cols": (1,)}, "linear_regression", "VALIDATE_QUARANTINE"),
    ({"oob_cols": (1,)}, "linear_regression", "VALIDATE_FULL"),
    ({"bad_labels": (0,)}, "linear_regression", "DISABLED"),
    ({}, "linear_regression", "SOMETIMES"),
]


@pytest.mark.parametrize("kw,task,mode", VALIDATION_CASES)
def test_validators_decide_like_the_reference(kw, task, mode):
    """The same verdict, message, quarantine count and repaired rows; SAMPLE
    draws its rows from the run seed in both packages."""
    seeds = range(12) if mode == "VALIDATE_SAMPLE" else (0,)
    for seed in seeds:
        ref = _decision(ref_validators, ref_io, kw, task, mode, seed)
        got = _decision(port_validators, port_data, kw, task, mode, seed)
        assert got[:2] == ref[:2]
        if ref[0] == "ok":
            _assert_same_dataset(ref[2], got[2])
    if mode == "VALIDATE_SAMPLE":
        np.testing.assert_array_equal(port_validators._sample(300, mode, 5), ref_validators._sample(300, mode, 5))


@pytest.mark.parametrize("true_rows", [None, 50])
def test_feature_statistics_equal_the_reference(tmp_path, true_rows):
    path = _write_parts(ref_io.write_avro_file, str(tmp_path / "parts"), n_parts=2)
    ref, _ = ref_io.read_avro_dataset(path, _shards(ref_io), engine="python")
    got, _ = port_io.read_avro_dataset(path, _shards(port_io), engine="python")
    if true_rows is not None:
        ref, got = ref.pad_rows(ref.n_rows + 7), got.pad_rows(got.n_rows + 7)
        assert got.true_rows == ref.true_rows == 80
    for s in SHARDS:
        a, b = ref_stats(ref, s), port_stats(got, s)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _ref_glm(means, variances):
    return RefLogistic(RefCoefficients(means=jnp.asarray(means), variances=jnp.asarray(variances)))


def _port_glm(means, variances, dtype):
    return LogisticRegressionModel(Coefficients(means=torch.tensor(means, dtype=dtype),
                                                variances=torch.tensor(variances, dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_glm_models_load_across_packages(tmp_path, dtype):
    """A model saved by either package loads in the other with bitwise
    coefficients and variances (float32 models keep their bits through the
    records' doubles)."""
    im_r = ref_index_map.IndexMap.from_name_terms([("f0", ""), ("f1", "t"), ("f2", "")])
    im_p = port_index_map.IndexMap.from_name_terms([("f0", ""), ("f1", "t"), ("f2", "")])
    rng = np.random.default_rng(7)
    means = rng.normal(size=4).astype(np.float32 if dtype == torch.float32 else np.float64)
    variances = rng.uniform(0.1, 1.0, size=4).astype(means.dtype)
    p_port, p_ref = str(tmp_path / "port" / "part-00000.avro"), str(tmp_path / "ref" / "part-00000.avro")
    port_io.save_glm(p_port, _port_glm(means, variances, dtype), im_p, model_id="m")
    ref_io.save_glm(p_ref, _ref_glm(means, variances), im_r, model_id="m")
    for p in (p_port, p_ref):
        back_ref = ref_io.load_glm(p, im_r)
        back_port = port_io.load_glm(p, im_p, device="cpu", dtype=dtype)
        assert isinstance(back_port, LogisticRegressionModel)
        assert back_port.coefficients.means.dtype == dtype
        for got, ref in ((back_port.coefficients.means, back_ref.coefficients.means),
                         (back_port.coefficients.variances, back_ref.coefficients.variances)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(means.dtype))
        np.testing.assert_array_equal(back_port.coefficients.means.numpy(), means)
        np.testing.assert_array_equal(back_port.coefficients.variances.numpy(), variances)


def _game_models(dtype):
    rng = np.random.default_rng(11)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    fe_means = rng.normal(size=3).astype(np_dt)
    idx = np.asarray([[0, 2, -1], [1, -1, -1], [0, 1, 2]], np.int32)
    val = np.where(idx >= 0, rng.normal(size=idx.shape), 0.0).astype(np_dt)
    var = np.where(idx >= 0, rng.uniform(0.1, 1, size=idx.shape), 0.0).astype(np_dt)
    ids = np.asarray(["uA", "uB", "uC"], dtype=object)
    ref = RefGame(models={
        "global": RefFE(model=RefLogistic(RefCoefficients(jnp.asarray(fe_means))), feature_shard="globalShard"),
        "per-user": RefRE(random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
                          entity_ids=ids, coef_indices=jnp.asarray(idx), coef_values=jnp.asarray(val),
                          variances=jnp.asarray(var)),
    }, task="logistic_regression")
    port = GameModel(models={
        "global": FixedEffectModel(model=LogisticRegressionModel(Coefficients(torch.tensor(fe_means))),
                                   feature_shard="globalShard"),
        "per-user": RandomEffectModel(random_effect_type="userId", feature_shard="userShard",
                                      task="logistic_regression", entity_ids=ids, coef_indices=torch.tensor(idx),
                                      coef_values=torch.tensor(val), variances=torch.tensor(var)),
    }, task="logistic_regression")
    return ref, port, fe_means, val, var


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_game_models_load_across_packages(tmp_path, dtype, writer):
    pairs = [("g0", ""), ("g1", "")]
    upairs = [("u0", ""), ("u1", ""), ("u2", "x")]
    imaps_r = {"globalShard": ref_index_map.IndexMap.from_name_terms(pairs),
               "userShard": ref_index_map.IndexMap.from_name_terms(upairs, add_intercept=False)}
    imaps_p = {"globalShard": port_index_map.IndexMap.from_name_terms(pairs),
               "userShard": port_index_map.IndexMap.from_name_terms(upairs, add_intercept=False)}
    ref_model, port_model, fe_means, val, var = _game_models(dtype)
    d = str(tmp_path / "gameModel")
    if writer == "reference":
        ref_io.save_game_model(d, ref_model, imaps_r)
    else:
        port_io.save_game_model(d, port_model, imaps_p)
    meta = json.load(open(os.path.join(d, "model-metadata.json")))
    assert meta["featureIndexFingerprint"] == ref_io.model_io.index_fingerprint(imaps_r)
    back_r = ref_io.load_game_model(d, imaps_r)
    back_p = port_io.load_game_model(d, imaps_p, device="cpu", dtype=dtype)
    assert back_p.task == back_r.task and set(back_p.coordinates()) == {"global", "per-user"}
    np.testing.assert_array_equal(back_p["global"].model.coefficients.means.numpy(), fe_means)
    np.testing.assert_array_equal(back_p["global"].model.coefficients.means.numpy(),
                                  np.asarray(back_r["global"].model.coefficients.means).astype(fe_means.dtype))
    re_p, re_r = back_p["per-user"], back_r["per-user"]
    assert list(re_p.entity_ids) == list(re_r.entity_ids) == ["uA", "uB", "uC"]
    np.testing.assert_array_equal(re_p.coef_indices.numpy(), np.asarray(re_r.coef_indices))
    for got, ref, want in ((re_p.coef_values, re_r.coef_values, val), (re_p.variances, re_r.variances, var)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(want.dtype))
        mask = re_p.coef_indices.numpy() >= 0
        np.testing.assert_array_equal(got.numpy()[mask], want[mask])
    assert port_io.model_io.check_prior_compatibility(d, imaps_p) == {"globalShard": "exact", "userShard": "exact"}


def test_loaded_models_land_on_the_card_by_default(tmp_path, monkeypatch):
    im = port_index_map.IndexMap.from_name_terms([("f0", "")])
    p = str(tmp_path / "m.avro")
    port_io.save_glm(p, _port_glm(np.zeros(2, np.float32), np.ones(2, np.float32), torch.float32), im)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_io.load_glm(p, im)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_io.load_game_model(str(tmp_path), {})
