"""Parity of the PyTorch port's sparse layouts (ELL and sorted COO) with the
JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU with x64, as the reference suite runs) and its counterpart in
``photon_ml_tpu_torch`` with ``device="cpu"``, where every sparse product
takes the plain version of the segment kernel (``ops/sparse.py``). Bounds:
host-built arrays equal bit for bit; float64 products rtol 1e-12, float32
and bf16 ones at the gradient bound, max-abs error <= 3e-5 * max(|ref|, 1);
the objective's value rtol 2e-6 and the rest at the gradient bound
(tests/test_pallas_glm.py); float64 solves at tol 1e-9 to coefficients
rtol 1e-3 / atol 1e-5; the sweep at tests/test_torch_glmix.py's bounds.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import CoordinateDescent as JaxCD
from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game.data import build_fixed_effect_dataset as jax_build_fe
from photon_ml_tpu.game.data import build_random_effect_dataset as jax_build_re
from photon_ml_tpu.game.problem import GLMProblem as JaxProblem
from photon_ml_tpu.io.data import RawDataset as JaxRaw
from photon_ml_tpu.ops.features import batch_from_coo as jax_batch_from_coo
from photon_ml_tpu.ops.features import pad_batch as jax_pad_batch
from photon_ml_tpu.ops.features import sorted_coo_matrix as jax_sorted_coo
from photon_ml_tpu.ops.glm import GLMObjective as JaxObjective
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FixedEffectCoordinate,
    GLMOptimizationConfig,
    GLMProblem,
    RandomEffectCoordinate,
    build_fixed_effect_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.problem import _fusion_mode, batch_route
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.ops import fused_glm, sparse
from photon_ml_tpu_torch.ops.features import FeatureMatrix, batch_from_coo, pad_batch, sorted_coo_matrix
from photon_ml_tpu_torch.ops.glm import GLMObjective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel.mesh import shard_batch

LAYOUTS = ("ell", "coo")
DTYPES = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close_vec(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref))
    bound = 3e-5 * max(np.max(np.abs(ref)), 1.0)
    assert err <= bound, f"{what}: max-abs error {err:.3e} > bound {bound:.3e}"


def _triplets(rng, n=60, d=40, full_column=True, dupes=True, empty_rows=True, integer=False):
    """Ragged COO triplets in a shuffled input order: 0-7 entries a row,
    some rows empty, column 3 in every row (a full column), some repeated
    (row, col) pairs, column d-2 in no row (an empty column)."""
    counts = rng.integers(0, 8, size=n)
    if empty_rows:
        counts[::7] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, d - 2, size=len(rows))
    cols[cols == d - 2] = 0
    if full_column:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.full(n, 3)])
    if dupes:
        pick = rng.integers(0, len(rows), size=max(len(rows) // 10, 1))
        rows = np.concatenate([rows, rows[pick]])
        cols = np.concatenate([cols, cols[pick]])
    vals = rng.integers(-4, 5, size=len(rows)).astype(np.float64) if integer else rng.normal(size=len(rows))
    order = rng.permutation(len(rows))
    return rows[order].astype(np.int64), cols[order].astype(np.int64), vals[order]


def _labels(rng, n):
    y = (rng.random(n) > 0.5).astype(np.float64)
    off = rng.standard_normal(n) * 0.1
    wt = rng.random(n) + 0.5
    return y, off, wt


def _pair(rng, layout, dtype_name="float64", feature_dtype=None, n=60, d=40, **kw):
    rows, cols, vals = _triplets(rng, n, d, **kw)
    y, off, wt = _labels(rng, n)
    tdt, jdt = DTYPES[dtype_name]
    jfd = {None: None, torch.bfloat16: jnp.bfloat16}[feature_dtype]
    jb = jax_batch_from_coo(rows, cols, vals, y, d, off, wt, dtype=jdt, layout=layout, feature_dtype=jfd)
    tb = batch_from_coo(rows, cols, vals, y, d, off, wt, dtype=tdt, layout=layout, feature_dtype=feature_dtype,
                        device="cpu")
    return jb, tb


def _same_arrays(tf, jf):
    assert tf.layout == jf.layout and tf.dim == jf.dim and tf.n_rows == jf.n_rows
    names = ("idx", "val") if jf.layout == "ell" else ("coo_cols", "coo_rows", "coo_vals")
    for name in names:
        got, want = getattr(tf, name), np.asarray(getattr(jf, name))
        if got.dtype == torch.bfloat16:
            got, want = got.float().numpy(), want.astype(np.float32)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


# ------------------------------------------------------------- host builds


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype_name,feature_dtype", [
    ("float64", None), ("float32", None), ("float32", torch.bfloat16),
], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("max_nnz", [None, 2], ids=["all", "max_nnz2"])
def test_batch_from_coo_equals_jax(rng, layout, dtype_name, feature_dtype, max_nnz):
    rows, cols, vals = _triplets(rng)
    y, off, wt = _labels(rng, 60)
    tdt, jdt = DTYPES[dtype_name]
    jfd = None if feature_dtype is None else jnp.bfloat16
    jb = jax_batch_from_coo(rows, cols, vals, y, 40, off, wt, max_nnz=max_nnz, dtype=jdt, layout=layout,
                            feature_dtype=jfd)
    tb = batch_from_coo(rows, cols, vals, y, 40, off, wt, max_nnz=max_nnz, dtype=tdt, layout=layout,
                        feature_dtype=feature_dtype, device="cpu")
    _same_arrays(tb.features, jb.features)
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))


@pytest.mark.parametrize("pad_to_multiple", [1, 8])
def test_sorted_coo_matrix_equals_jax(rng, pad_to_multiple):
    rows, cols, vals = _triplets(rng)
    jf = jax_sorted_coo(rows, cols, vals, 60, 40, dtype=jnp.float32, pad_to_multiple=pad_to_multiple)
    tf = sorted_coo_matrix(rows, cols, vals, 60, 40, dtype=torch.float32, pad_to_multiple=pad_to_multiple,
                           device="cpu")
    _same_arrays(tf, jf)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pad_batch_equals_jax(rng, layout):
    jb, tb = _pair(rng, layout, "float32")
    jp, tp = jax_pad_batch(jb, 67), pad_batch(tb, 67)
    _same_arrays(tp.features, jp.features)
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    # the padded rows hold no entries: they score 0 in every layout
    w = _t(rng.standard_normal(40))
    assert float(tp.features.matvec(w.float())[60:].abs().sum()) == 0.0


def _raw_pair(rng, n, d):
    rows, cols, vals = _triplets(rng, n, d)
    y, off, wt = _labels(rng, n)
    kw = dict(n_rows=n, labels=y, offsets=off, weights=wt, shard_coo={"s": (rows, cols, vals)},
              shard_dims={"s": d}, id_tags={})
    return JaxRaw(**kw), RawDataset(**kw)


@pytest.mark.parametrize("layout,d", [
    ("auto", 40), ("auto", 4097), ("dense", 40), ("ell", 40), ("sparse", 40), ("coo", 40), ("coo", 4097),
])
def test_raw_dataset_to_batch_equals_jax(rng, layout, d):
    jraw, traw = _raw_pair(rng, 60, d)
    jb = jraw.to_batch("s", dtype=jnp.float32, layout=layout)
    tb = traw.to_batch("s", dtype=torch.float32, layout=layout, device="cpu")
    want_layout = ("dense" if d <= 4096 else "ell") if layout == "auto" else (
        "ell" if layout == "sparse" else layout)
    assert tb.features.layout == want_layout
    if want_layout == "dense":
        assert np.array_equal(tb.features.dense.numpy(), np.asarray(jb.features.dense))
    else:
        _same_arrays(tb.features, jb.features)
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))


def test_build_fixed_effect_dataset_equals_jax(rng):
    jraw, traw = _raw_pair(rng, 60, 5000)
    jd = jax_build_fe(jraw, "fe", "s", dtype=jnp.float32)
    td = build_fixed_effect_dataset(traw, "fe", "s", dtype=torch.float32, device="cpu")
    assert td.batch.features.layout == "ell" == jd.batch.features.layout
    _same_arrays(td.batch.features, jd.batch.features)
    assert (td.n_rows, td.dim) == (jd.n_rows, jd.dim) == (60, 5000)


# ------------------------------------------------------ companion segments


def _loop(seg, n_seg, src, square=False):
    """The segments' products by a numpy loop: segment by segment over the
    pointers or the uniform rows, entry by entry over the keys."""
    out = np.zeros(n_seg)
    gather, val = seg.gather.numpy(), _np(seg.val).astype(np.float64)
    term = lambda j: src[gather[j]] * (val[j] ** 2 if square else val[j])  # noqa: E731
    if seg.keys is not None:
        for j, key in enumerate(seg.keys.tolist()):
            out[key] += term(j)
        return out
    for s in range(n_seg):
        a, b = (s * seg.seg_len, (s + 1) * seg.seg_len) if seg.ptr is None else (
            int(seg.ptr[s]), int(seg.ptr[s + 1]))
        for j in range(a, b):
            out[s] += term(j)
    return out


def _joins_loop(keys, tile):
    """The joins by a loop over the tiles: a key whose entries cross a tile
    boundary, with the tiles of its first and last entries."""
    joins = []
    for b in range(tile, len(keys), tile):
        if keys[b - 1] != keys[b]:
            continue
        key = int(keys[b])
        if joins and joins[-1][0] == key:
            joins[-1][2] = b // tile
        else:
            first = min(j for j in range(len(keys)) if keys[j] == key)
            joins.append([key, first // tile, b // tile])
    return np.array(joins, dtype=np.int32).reshape(-1, 3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_companion_segments_reproduce_the_products(rng, layout):
    """Integer values, so every order of summation is exact: the segments
    built for matvec (rows) and for rmatvec (columns) reproduce X w, X^T c
    and (X*X)^T c of a loop over the original layout's entries exactly, and
    the plain version reproduces the segments."""
    rows, cols, vals = _triplets(rng, integer=True)
    n, d = 60, 40
    y, _, _ = _labels(rng, n)
    f = batch_from_coo(rows, cols, vals, y, d, dtype=torch.float64, layout=layout, device="cpu").features
    w = rng.integers(-3, 4, size=d).astype(np.float64)
    c = rng.integers(-3, 4, size=n).astype(np.float64)
    xw, xtc, x2tc = np.zeros(n), np.zeros(d), np.zeros(d)
    if layout == "ell":
        entries = [(i, int(f.idx[i, j]), float(f.val[i, j])) for i in range(n) for j in range(f.idx.shape[1])]
    else:
        entries = list(zip(f.coo_rows.tolist(), f.coo_cols.tolist(), f.coo_vals.tolist()))
    for r, col, v in entries:
        xw[r] += v * w[col]
        xtc[col] += v * c[r]
        x2tc[col] += v * v * c[r]
    assert np.array_equal(_loop(f.row_segments, n, w), xw)
    assert np.array_equal(_loop(f.col_segments, d, c), xtc)
    assert np.array_equal(_loop(f.col_segments, d, c, square=True), x2tc)
    assert np.array_equal(f.matvec(_t(w)).numpy(), xw)
    assert np.array_equal(f.rmatvec(_t(c)).numpy(), xtc)
    assert np.array_equal(f.sq_rmatvec(_t(c)).numpy(), x2tc)
    # the column segments hold every entry once, in column order, keyed by
    # their column, with no per-column pointer
    seg = f.col_segments
    keys = seg.keys.numpy()
    assert seg.ptr is None and seg.keys.dtype == torch.int32 and len(keys) == len(entries)
    assert bool(np.all(keys[1:] >= keys[:-1]))
    counts = np.bincount(keys, minlength=d)
    assert counts[d - 2] == 0  # the empty column
    assert counts[3] >= n  # the full column
    assert np.array_equal(seg.joins.numpy(), _joins_loop(keys, sparse.TILE))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_long_segments_take_the_key_walk(rng, layout, monkeypatch):
    """A row longer than ``sparse.LONG_SEGMENT`` entries (here, with a small
    threshold, the ELL rows and the longer COO rows) sends ``matvec`` to the
    key form, its rows as keys; the columns always take it, and a long
    column (the full column 3) is just a run of equal keys, with no plan of
    its own beyond the joins; the products stay exact."""
    monkeypatch.setattr(sparse, "LONG_SEGMENT", 5)
    rows, cols, vals = _triplets(rng, integer=True)
    y, _, _ = _labels(rng, 60)
    f = batch_from_coo(rows, cols, vals, y, 40, dtype=torch.float64, layout=layout, device="cpu").features
    if layout == "ell":
        counts = np.full(60, f.idx.shape[1])
    else:
        counts = np.bincount(f.coo_rows.numpy(), minlength=60)
    assert counts.max() > 5
    for seg, n_seg, row_counts in ((f.row_segments, 60, counts), (f.col_segments, 40, None)):
        keys = seg.keys.numpy()
        assert seg.ptr is None and seg.group == 0 and seg.keys.dtype == torch.int32
        if row_counts is not None:
            assert np.array_equal(keys, np.repeat(np.arange(n_seg), row_counts))
        assert np.array_equal(seg.joins.numpy(), _joins_loop(keys, sparse.TILE))
        assert np.array_equal(seg.segment_ids(n_seg).numpy(), keys)
    assert np.bincount(f.col_segments.keys.numpy(), minlength=40)[3] >= 60
    w = rng.integers(-3, 4, size=40).astype(np.float64)
    c = rng.integers(-3, 4, size=60).astype(np.float64)
    dense = f.to_dense().numpy()
    assert np.array_equal(f.matvec(_t(w)).numpy(), dense @ w)
    assert np.array_equal(f.rmatvec(_t(c)).numpy(), dense.T @ c)


@pytest.mark.parametrize("tile", [1, 2, 8, 256])
@pytest.mark.parametrize("shape", ["uniform", "one_key", "runs", "intercept"])
def test_key_joins_match_a_loop(tile, shape):
    """The joins that the key walk's second launch adds: each key whose
    entries cross a tile boundary with its first and last tiles, in key
    order, as a loop over the tiles finds them."""
    rng = np.random.default_rng(tile)
    keys = {
        "uniform": np.sort(rng.integers(0, 3000, 2000)),
        "one_key": np.full(700, 5),
        "runs": np.sort(rng.integers(0, 40, 1500)),
        "intercept": np.sort(np.concatenate([rng.integers(0, 500, 600), np.full(900, 250)])),
    }[shape].astype(np.int32)
    got = sparse.key_joins(keys, tile)
    assert got.dtype == np.int32 and np.array_equal(got, _joins_loop(keys, tile))
    # every crossing boundary lies inside exactly one join
    for b in range(tile, len(keys), tile):
        inside = [(k, u, w) for k, u, w in got if u * tile < b <= w * tile]
        assert len(inside) == (keys[b - 1] == keys[b]) and all(k == keys[b] for k, _, _ in inside)


@pytest.mark.parametrize("mean,group", [(0.0, 4), (1.0, 4), (16.0, 4), (16.5, 8), (32.0, 8), (33.0, 16),
                                        (64.0, 16), (100.0, 32), (5000.0, 32)])
def test_group_width_covers_the_mean_segment(mean, group):
    """The row groups' width: the fewest lanes, at least 4, whose passes of
    LANE_ENTRIES entries cover a segment of the mean length."""
    assert sparse.group_width(mean) == group


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_segments_are_row_groups(rng, layout):
    """matvec's segments: the ELL rows as uniform segments, the COO rows
    with int32 pointers, each with the group width of its mean row."""
    rows, cols, vals = _triplets(rng)
    y, _, _ = _labels(rng, 60)
    f = batch_from_coo(rows, cols, vals, y, 40, layout=layout, device="cpu").features
    seg = f.row_segments
    assert seg.keys is None and seg.group == sparse.group_width(seg.gather.shape[0] / 60)
    if layout == "ell":
        assert seg.ptr is None and seg.seg_len == f.idx.shape[1]
    else:
        counts = np.bincount(f.coo_rows.numpy(), minlength=60)
        assert seg.ptr.dtype == torch.int32
        assert np.array_equal(seg.ptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_segments_keep_a_stable_order(rng, layout):
    """Within a column (ELL) or a row (COO) the companion keeps the entries
    in their stored order: the first entry of a segment is the earliest."""
    jb, tb = _pair(rng, layout, "float32")
    f = tb.features
    if layout == "ell":
        seg, k = f.col_segments, f.idx.shape[1]
        flat = f.idx.reshape(-1).numpy()
        order = np.argsort(flat, kind="stable")
        assert np.array_equal(seg.gather.numpy(), (order // k).astype(np.int32))
        assert np.array_equal(seg.val.numpy(), f.val.reshape(-1).numpy()[order])
        assert np.array_equal(seg.keys.numpy(), flat[order])
    else:
        seg = f.row_segments
        order = np.argsort(f.coo_rows.numpy(), kind="stable")
        assert np.array_equal(seg.gather.numpy(), f.coo_cols.numpy()[order])
        assert np.array_equal(seg.val.numpy(), f.coo_vals.numpy()[order])
        assert seg.ptr.dtype == torch.int32
        # the columns' keys are coo_cols itself: no copy
        assert f.col_segments.keys is f.coo_cols


# ---------------------------------------------------------------- products


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["f64", "f32", "bf16"])
def test_products_match_jax(rng, layout, case):
    dtype_name, fdt = {"f64": ("float64", None), "f32": ("float32", None), "bf16": ("float32", torch.bfloat16)}[case]
    jb, tb = _pair(rng, layout, dtype_name, feature_dtype=fdt)
    np_dt = np.float64 if case == "f64" else np.float32
    w = rng.standard_normal(40).astype(np_dt)
    c = rng.standard_normal(60).astype(np_dt)
    jf, tf = jb.features, tb.features
    pairs = [
        ("matvec", tf.matvec(_t(w)), jf.matvec(jnp.asarray(w))),
        ("rmatvec", tf.rmatvec(_t(c)), jf.rmatvec(jnp.asarray(c))),
        ("sq_rmatvec", tf.sq_rmatvec(_t(c)), jf.sq_rmatvec(jnp.asarray(c))),
        ("to_dense", tf.to_dense(), jf.to_dense()),
    ]
    for what, got, want in pairs:
        got, want = _np(got), np.asarray(want, np.float64 if case == "f64" else np.float32)
        assert got.shape == want.shape, what
        if case == "f64":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13, err_msg=what)
        else:
            _close_vec(got, want, what)


def test_segment_dot_plain_writes_empty_segments_and_counts_nothing():
    seg = sparse.Segments(torch.tensor([0, 2, 2, 3]), 0, torch.tensor([1, 0, 1], dtype=torch.int32),
                          torch.tensor([1.0, 2.0, 3.0]))
    fused_glm.reset_launch_counts()
    out = sparse.segment_dot("coo_matvec", seg, 3, torch.tensor([10.0, 20.0]))
    assert out.tolist() == [40.0, 0.0, 60.0] and out.dtype == torch.float32
    assert sparse.segment_dot("coo_sq_rmatvec", seg, 3, torch.tensor([10.0, 20.0]), square=True).tolist() == [
        60.0, 0.0, 180.0]
    assert set(sparse.SPARSE_LAUNCHES) == set(sparse.PRODUCTS) and not any(sparse.SPARSE_LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        sparse.segment_dot("coo_matvec", seg, 3, torch.zeros(2, device="meta"))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_segment_bound_counts_what_the_product_moves():
    """chip_smoke.py's bound for the segment kernel: each entry's index and
    value, the source and the output once; the design's pointers, keys,
    joins and carries apart; a sector per gathered value only as the worst
    case."""
    cs = _chip_smoke()
    seg = sparse.Segments(torch.tensor([0, 2, 2, 3]), 0, torch.tensor([1, 0, 1], dtype=torch.int32),
                          torch.tensor([1.0, 2.0, 3.0]))
    function = 3 * (4 + 4) + 4 * 2 + 4 * 3
    assert cs.segment_bytes(seg, 3, 2) == {
        "function": function, "design": function + 8 * 4, "sectors": 3 * (4 + 4 + 32) + 4 * 3 + 8 * 4}
    assert cs.segment_flops(seg) == 6 and cs.segment_flops(seg, square=True) == 9
    # ELL rows: uniform segments, no pointers; bf16 values are 2 bytes an entry
    ell = batch_from_coo(np.repeat(np.arange(4), 2), np.arange(8) % 5, np.ones(8), np.zeros(4), 5,
                         layout="ell", dtype=torch.bfloat16, device="cpu").features.row_segments
    assert ell.ptr is None
    b = cs.segment_bytes(ell, 4, 5)
    assert b["function"] == b["design"] == 8 * (4 + 2) + 4 * 5 + 4 * 4
    # the key walk adds its int32 keys, the joins and their float64 carries
    # (each tile of a join writes one and the join reads it) to the design's
    # bytes: a segment of TILE + 1 entries crosses one boundary
    n = sparse.TILE + 1
    keyed = sparse.key_segments(np.repeat(np.arange(2, dtype=np.int32), [n, 1]), 2,
                                torch.zeros(n + 1, dtype=torch.int32), torch.ones(n + 1))
    assert keyed.joins.tolist() == [[0, 0, 1]]
    b = cs.segment_bytes(keyed, 2, 1)
    assert b["function"] == (n + 1) * 8 + 4 + 4 * 2
    assert b["design"] - b["function"] == 4 * (n + 1) + 12 + 2 * 8 * 2
    # COO rows: int32 pointers
    coo = batch_from_coo(np.repeat(np.arange(4), 2), np.arange(8) % 5, np.ones(8), np.zeros(4), 5,
                         layout="coo", device="cpu").features.row_segments
    b = cs.segment_bytes(coo, 4, 5)
    assert b["design"] - b["function"] == 4 * 5


def test_segment_bound_counts_each_gathered_source_row_once():
    """A gather that skips source rows and repeats others: the bound reads
    each gathered row once (S1: one float; S2: its L floats) and no row
    that no entry reaches."""
    cs = _chip_smoke()
    gather = torch.tensor([3, 3, 0, 5, 3, 0], dtype=torch.int32)
    seg = sparse.Segments(torch.tensor([0, 2, 2, 6]), 0, gather, torch.ones(6))
    assert cs.gathered_rows(seg, 8) == 3
    entries = 6 * (4 + 4)
    assert cs.segment_bytes(seg, 3, 8)["function"] == entries + 4 * 3 + 4 * 3
    for L in (1, 7, 40):
        assert cs.s2_bytes(seg, 3, 8, L) == entries + 4 * L * (3 + 3)
        assert cs.s2_bytes(seg, 3, 8, L, rows=3) == cs.s2_bytes(seg, 3, 8, L)
    with pytest.raises(ValueError, match="rows of a source of 2"):
        cs.gathered_rows(seg, 2)


# --------------------------------------------------------------- objective


def _norms(rng, d, kind):
    if kind == "none":
        return None, None
    factors = (rng.random(d) + 0.5)
    shifts = (rng.random(d) - 0.5) * 0.2
    return factors, shifts


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant", ["plain", "shifts", "prior"])
@pytest.mark.parametrize("loss_name", ["logistic", "poisson"])
def test_objective_matches_jax(rng, layout, variant, loss_name):
    jb, tb = _pair(rng, layout, "float32")
    d = 40
    factors, shifts = _norms(rng, d, "shifts" if variant == "shifts" else "none")
    jnorm = tnorm = None
    if factors is not None:
        jnorm = JaxNorm(jnp.asarray(factors, jnp.float32), jnp.asarray(shifts, jnp.float32), None)
        tnorm = NormalizationContext(_t(factors.astype(np.float32)), _t(shifts.astype(np.float32)), None)
    prior = {}
    if variant == "prior":
        pm = (rng.standard_normal(d) * 0.2).astype(np.float32)
        pp = (rng.random(d) + 0.5).astype(np.float32)
        prior = dict(prior_mean=pm, prior_precision=pp)
    jobj = JaxObjective(loss=JAX_LOSSES[loss_name], batch=jb, l2=0.7, norm=jnorm,
                        **{k: jnp.asarray(v) for k, v in prior.items()})
    tobj = GLMObjective(loss=LOSSES[loss_name], batch=tb, l2=0.7, norm=tnorm,
                        **{k: _t(v) for k, v in prior.items()})
    w = (rng.standard_normal(d) * 0.3).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    jv, jg = jobj.value_and_grad(jnp.asarray(w))
    tv, tg = tobj.value_and_grad(_t(w))
    np.testing.assert_allclose(float(tv), float(jv), rtol=2e-6)
    _close_vec(tg.numpy(), jg, "gradient")
    _close_vec(tobj.hessian_vector(_t(w), _t(v)).numpy(), jobj.hessian_vector(jnp.asarray(w), jnp.asarray(v)), "Hv")
    _close_vec(tobj.hessian_diagonal(_t(w)).numpy(), jobj.hessian_diagonal(jnp.asarray(w)), "Hessian diagonal")


def test_objective_counts_its_products_on_the_plain_route(rng):
    """On the CPU the sparse products take the plain version: no launch is
    counted, and the solve's route is ``plain_cpu``."""
    _, tb = _pair(rng, "coo", "float32")
    fused_glm.reset_launch_counts()
    assert batch_route(tb) == "plain_cpu" and not any(fused_glm.OBJECTIVE_ROUTES.values())
    assert _fusion_mode(tb) == ("plain_cpu", None)
    assert fused_glm.OBJECTIVE_ROUTES == {"dense_kernel": 0, "sparse_kernel": 0, "tiled_kernel": 0, "tiled_dense": 0,
                                          "plain_cpu": 1, "plain_float64": 0}
    GLMObjective(loss=LOSSES["logistic"], batch=tb).value_and_grad(torch.zeros(40))
    assert not any(sparse.SPARSE_LAUNCHES.values())


# ------------------------------------------------------------------ solves


def _solve_pair(rng, layout, optimizer, l1=0.0, n=400, d=30):
    rows, cols, vals = _triplets(rng, n, d)
    w_true = rng.standard_normal(d)
    z = np.bincount(rows, weights=vals * w_true[cols], minlength=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    opt = dict(optimizer_type=optimizer, tolerance=1e-9, max_iterations=200)
    reg = "L1" if l1 else "L2"
    jb = jax_batch_from_coo(rows, cols, vals, y, d, dtype=jnp.float64, layout=layout)
    tb = batch_from_coo(rows, cols, vals, y, d, dtype=torch.float64, layout=layout, device="cpu")
    jm, jr = JaxProblem("logistic_regression", JaxConfig(
        optimizer=JaxOptConfig(**opt), regularization=JaxReg(reg), reg_weight=l1 or 1.0)).run(jb)
    tm, tr = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(**opt), regularization=RegularizationContext(reg), reg_weight=l1 or 1.0)).run(tb)
    return jm, jr, tm, tr


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_solve_matches_jax(rng, layout, optimizer):
    jm, jr, tm, tr = _solve_pair(rng, layout, optimizer)
    np.testing.assert_allclose(
        tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-9)
    assert tr.reason != 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_owlqn_solve_matches_jax_with_the_same_support(rng, layout):
    jm, jr, tm, tr = _solve_pair(rng, layout, "LBFGS", l1=4.0)
    got, want = tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert np.array_equal(got == 0.0, want == 0.0) and (want == 0.0).any()


# ------------------------------------------------------------------- sweep


def _sweep_data(seed, n=1500, d_fixed=6000, k=6, n_users=40, d_re=4):
    """A sparse global shard (k entries a row over d_fixed columns, so that
    the auto layout picks ELL) and bench.py's Zipf-skewed users with
    per-user features and an intercept."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, d_fixed, size=n * k)
    cols[::k] = d_fixed - 1  # an intercept-like column in every row
    vals = rng.normal(size=n * k) * 0.5
    vals[::k] = 1.0
    w = rng.normal(size=d_fixed)
    z = np.bincount(rows, weights=vals * w[cols], minlength=n)
    probs = 1.0 / np.arange(1, n_users + 1) ** 1.1
    assign = rng.choice(n_users, size=n, p=probs / probs.sum())
    ex = rng.standard_normal((n, d_re))
    ex[:, -1] = 1.0
    z = z + np.einsum("nd,nd->n", ex, rng.standard_normal((n_users, d_re))[assign])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    kw = dict(
        n_rows=n, labels=y, offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"global": (rows, cols, vals), "userShard": (
            np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n), ex.reshape(-1))},
        shard_dims={"global": d_fixed, "userShard": d_re},
        id_tags={"userId": np.char.add("u", assign.astype(str)).astype(object)},
    )
    return JaxRaw(**kw), RawDataset(**kw)


def test_sweep_with_an_ell_fixed_effect_matches_jax():
    """Two float64 sweeps of a sparse fixed effect (ELL, TRON with SIMPLE
    variance) and a per-user random effect (packed L-BFGS), at the bounds of
    tests/test_torch_glmix.py: FE coefficients and variances rtol 1e-3 /
    atol 1e-5, RE coefficients atol 5e-3, per-entity loss atol 1e-4."""
    jraw, traw = _sweep_data(2)
    fe_opt = dict(optimizer_type="TRON", tolerance=1e-9, max_iterations=10)
    re_opt = dict(tolerance=1e-6, max_iterations=30)
    jfe = JaxConfig(optimizer=JaxOptConfig(**fe_opt), regularization=JaxReg("L2"), reg_weight=1.0,
                    variance_type="SIMPLE")
    jre = JaxConfig(optimizer=JaxOptConfig(**re_opt), regularization=JaxReg("L2"), reg_weight=1.0)
    tfe = GLMOptimizationConfig(optimizer=OptimizerConfig(**fe_opt), regularization=RegularizationContext("L2"),
                                reg_weight=1.0, variance_type="SIMPLE")
    tre = GLMOptimizationConfig(optimizer=OptimizerConfig(**re_opt), regularization=RegularizationContext("L2"),
                                reg_weight=1.0)
    jfe_ds = jax_build_fe(jraw, "global", "global", dtype=jnp.float64)
    tfe_ds = build_fixed_effect_dataset(traw, "global", "global", dtype=torch.float64, device="cpu")
    assert tfe_ds.batch.features.layout == "ell"
    jc = {
        "global": JaxFEC(dataset=jfe_ds, task="logistic_regression", config=jfe),
        "per-user": JaxREC(dataset=jax_build_re(jraw, "per-user", "userShard", "userId", dtype=jnp.float64),
                           task="logistic_regression", config=jre),
    }
    tc = {
        "global": FixedEffectCoordinate(dataset=tfe_ds, task="logistic_regression", config=tfe),
        "per-user": RandomEffectCoordinate(
            dataset=build_random_effect_dataset(traw, "per-user", "userShard", "userId", dtype=torch.float64,
                                                device="cpu"),
            task="logistic_regression", config=tre),
    }
    jr = JaxCD(jc, n_iterations=2).run()
    tr = CoordinateDescent(tc, n_iterations=2).run()
    tf, jf = tr.model["global"].coefficients, jr.model["global"].coefficients
    np.testing.assert_allclose(tf.means.numpy(), np.asarray(jf.means), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tf.variances.numpy(), np.asarray(jf.variances), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tr.model["per-user"].coef_values.numpy(),
                               np.asarray(jr.model["per-user"].coef_values), atol=5e-3)
    np.testing.assert_allclose(tr.solver_results["per-user"].loss.numpy(),
                               np.asarray(jr.trackers["per-user"].result.loss), atol=1e-4)


# ---------------------------------------------------------------- refusals


def test_the_remaining_sparse_refusals_name_their_items(rng):
    jb, tb = _pair(rng, "ell", "float32")
    f = tb.features
    # the streamed row slice is ported: the JAX package's ELL window
    _close_vec(f.slice_rows(8, 4).to_dense().numpy(), jb.features.slice_rows(8, 4).to_dense(), "ell slice_rows")
    # the lane products are ported (S2's plain version on the CPU)
    W = rng.standard_normal((40, 2)).astype(np.float32)
    C = rng.standard_normal((60, 2)).astype(np.float32)
    _close_vec(f.matmat(_t(W)).numpy(), jb.features.matmat(jnp.asarray(W)), "ell matmat")
    _close_vec(f.rmatmat(_t(C)).numpy(), jb.features.rmatmat(jnp.asarray(C)), "ell rmatmat")
    jraw, traw = _raw_pair(rng, 10, 8)
    # the tiled layout is ported (tests/test_torch_tiled.py): on a 1 x 1
    # grid the tile is the JAX package's whole tile, and without a mesh
    # both packages refuse in the same words
    from photon_ml_tpu.parallel import make_mesh as jax_make_mesh
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(1, 1, device="cpu")
    tt = traw.to_batch("s", layout="tiled", mesh=grid)
    jt = jraw.to_batch("s", dtype=jnp.float32, layout="tiled", mesh=jax_make_mesh(n_data=1, n_model=1))
    assert tt.features.layout == "tiled" and (tt.features.dim, tt.features.n_rows) == (jt.features.dim, jt.features.n_rows)
    for ours, theirs in (("coo_cols", "lcol"), ("coo_rows", "lrow"), ("coo_vals", "lval")):
        want = np.asarray(getattr(jt.features, theirs)).reshape(-1)
        got = getattr(tt.features.tile, ours).numpy()
        assert np.array_equal(got[: want.size], want) and np.all(got[want.size:] == 0 if ours != "coo_cols" else True)
    for bad, words in ((dict(layout="tiled"), "requires a device mesh"),
                       (dict(layout="tiled", mesh=grid, feature_dtype=torch.bfloat16), "feature_dtype")):
        with pytest.raises(ValueError, match=words):
            traw.to_batch("s", **bad)
        with pytest.raises(ValueError, match=words):
            jraw.to_batch("s", **{**bad, "mesh": jax_make_mesh(n_data=1, n_model=1) if "mesh" in bad else None,
                                  "feature_dtype": jnp.bfloat16 if "feature_dtype" in bad else None})
    with pytest.raises(ValueError, match="layout"):
        traw.to_batch("s", layout="csr", device="cpu")
    # a budget below the batch streams it (tests/test_torch_fe_streaming.py)
    assert build_fixed_effect_dataset(traw, "fe", "s", hbm_budget_bytes=1, device="cpu").streamed
    ds = build_fixed_effect_dataset(traw, "fe", "s", layout="tiled", mesh=grid, device="cpu")
    assert ds.batch.features.layout == "tiled" and (ds.n_rows, ds.dim) == (10, 8)

    from photon_ml_tpu_torch.parallel import DataParallelGroup

    class _Grid:
        n_model, n_data, world = 2, 2, object()
        data = DataParallelGroup(1, 2, "cpu", "gloo")

    # a dense fixed effect under a model axis is ported: the rank's row
    # shard over the grid's data axis (each model column its replica), as
    # the JAX package's shard_batch(batch, mesh)
    ds = build_fixed_effect_dataset(traw, "fe", "s", mesh=_Grid(), device="cpu")
    assert ds.batch.features.is_dense and ds.batch.group is _Grid.data and ds.true_n_rows == 20

    class _Group:
        world_size, rank, device = 2, 0, torch.device("cpu")

    # a row-sharded ELL batch over processes: the JAX package's refusal
    with pytest.raises(NotImplementedError, match="multi-process ELL sharding is not supported"):
        shard_batch(tb, _Group())


def test_feature_matrix_validates_its_layout():
    with pytest.raises(ValueError, match="exactly one"):
        FeatureMatrix(dim=4)
    with pytest.raises(ValueError, match="both idx and val"):
        FeatureMatrix(dim=4, idx=torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="sorted"):
        FeatureMatrix(dim=4, coo_cols=torch.tensor([2, 1], dtype=torch.int32),
                      coo_rows=torch.tensor([0, 1], dtype=torch.int32), coo_vals=torch.ones(2), coo_n_rows=2)
    with pytest.raises(ValueError, match="out of"):
        FeatureMatrix(dim=4, idx=torch.full((2, 1), 4, dtype=torch.int32), val=torch.ones((2, 1)))
