"""The plain versions of the dense group aggregate, the gather and the
scatter (what their wrappers run for CPU tensors) against the numpy
statement of the probes they replace and against the JAX functions they
serve, on inputs made with numpy from a seed.

Integers exact; float64 sums to 1e-12 relative.  The CUDA kernels
themselves run only on a card: ``chip_smoke.py`` and the tests marked
``cuda`` hold them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto1_tpu_torch.ops.kernels import _build
from presto1_tpu_torch.ops.kernels import dense_group_agg as D
from presto1_tpu_torch.ops.kernels import gather as G
from presto1_tpu_torch.ops.kernels import scatter as S

torch.set_num_threads(1)

_RNG = np.random.RandomState(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ dense aggregate


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_histogram_is_bincount(dtype):
    """No slot: the probes' histogram (counts of values over 256 bins)."""
    vals = _RNG.randint(0, 256, 1 << 14).astype(dtype)
    got = D.dense_group_agg(_t(vals), 256, [], [])
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.bincount(vals, minlength=256))
    first = np.full(256, len(vals))
    np.minimum.at(first, vals, np.arange(len(vals)))
    np.testing.assert_array_equal(got.first_row.numpy(), first)
    assert got.table.shape == (256, 0)
    # the one-hot compare + sum the probe computes per grid step
    onehot = (jnp.asarray(vals)[:, None] == jnp.arange(256)[None, :])
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(onehot.sum(axis=0)))


def _numpy_slot(op, x, valid, sel):
    m = sel if valid is None else sel & valid
    if op == "count":
        return int(m.sum())
    if x.dtype == np.float64:
        if op == "sum":
            return float(x[m].sum())
        if not m.any():
            return np.inf if op == "min" else -np.inf
        return float(x[m].min() if op == "min" else x[m].max())
    x64 = x.astype(np.int64)
    if op == "low":
        x64 = x64 & 0xFFFFFFFF
    elif op == "high":
        x64 = x64 >> 32
    if op in ("min", "max"):
        info = np.iinfo(x.dtype)
        if not m.any():
            return int(info.max if op == "min" else info.min)
        return int(x64[m].min() if op == "min" else x64[m].max())
    with np.errstate(over="ignore"):
        return int(x64[m].sum(dtype=np.int64))


@pytest.mark.parametrize("groups", [1, 12, 13, 100])
@pytest.mark.parametrize("n", [0, 1, 3, 500])
def test_dense_group_agg_plain_matches_numpy(n, groups):
    word = _RNG.randint(-1, groups + 2, n).astype(np.int64)
    i64 = _RNG.randint(-2 ** 62, 2 ** 62, n)
    i32 = _RNG.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    f64 = _RNG.uniform(-1e6, 3e6, n)
    flag = _RNG.rand(n) > 0.5
    valid = _RNG.rand(n) > 0.3
    cols = [i64, i32, f64, flag]
    slots = [("sum", 0, None), ("low", 0, valid), ("high", 0, None),
             ("sum", 1, valid), ("min", 1, None), ("max", 1, valid),
             ("min", 0, valid), ("max", 0, None), ("sum", 2, None),
             ("sum", 2, valid), ("min", 2, valid), ("max", 2, None),
             ("sum", 3, None), ("count", None, valid), ("count", None, None)]
    got = D.dense_group_agg(
        _t(word), groups, [_t(c) for c in cols],
        [(op, c, None if v is None else _t(v)) for op, c, v in slots])
    assert got.counts.dtype == got.first_row.dtype == torch.int64
    for g in range(groups):
        sel = word == g
        assert int(got.counts[g]) == int(sel.sum())
        assert int(got.first_row[g]) == (int(np.flatnonzero(sel)[0])
                                         if sel.any() else n)
        for k, (op, c, v) in enumerate(slots):
            want = _numpy_slot(op, None if c is None else cols[c], v, sel)
            have = got.slot(k)[g].item()
            if isinstance(want, float):
                assert have == pytest.approx(want, rel=1e-12), (g, k, op)
            else:
                assert have == want, (g, k, op)
    assert got.slot(4).dtype == torch.int32  # min/max keep the column type
    assert got.slot(8).dtype == torch.float64
    assert got.slot(0).dtype == torch.int64


@pytest.mark.parametrize("op,col", [
    ("sum", 0), ("low", 0), ("high", 0), ("min", 0), ("max", 0), ("sum", 1),
    ("min", 1), ("max", 1), ("sum", 2), ("min", 2), ("max", 2),
    ("count", None)])
def test_dense_group_agg_identity_of_an_empty_input(op, col):
    """What the wrapper builds for an input of no rows on a card (it
    launches nothing there) is what the plain version computes."""
    cols = [torch.zeros(0, dtype=dt)
            for dt in (torch.int64, torch.int32, torch.float64)]
    plain = D.dense_group_agg_plain(torch.zeros(0, dtype=torch.int64), 3,
                                    cols, [(op, col, None)])
    bits = D._identity_bits(op, plain.slot_dtypes[0])
    assert plain.table.tolist() == [[bits]] * 3
    assert plain.counts.tolist() == plain.first_row.tolist() == [0, 0, 0]


def test_dense_group_agg_word_dtype_and_views():
    n = 300
    word = _RNG.randint(0, 13, n + 1)
    x = _RNG.randint(-10 ** 12, 10 ** 12, n + 1)
    a = D.dense_group_agg(_t(word)[1:], 12, [_t(x)[1:]], [("sum", 0, None)])
    b = D.dense_group_agg(_t(word.astype(np.int32))[1:].contiguous(), 12,
                          [_t(x[1:])], [("sum", 0, None)])
    assert torch.equal(a.counts, b.counts) and torch.equal(a.table, b.table)
    assert int(a.counts.sum()) == int((word[1:] < 12).sum())


@pytest.mark.parametrize("bad", [
    lambda w, x: D.dense_group_agg(w.to(torch.int16), 4, [x], []),
    lambda w, x: D.dense_group_agg(w, 0, [x], []),
    lambda w, x: D.dense_group_agg(w, 257, [x], []),
    lambda w, x: D.dense_group_agg(w, 4, [x[:5]], []),
    lambda w, x: D.dense_group_agg(w, 4, [x.to(torch.float32)], []),
    lambda w, x: D.dense_group_agg(w, 4, [x], [("median", 0, None)]),
    lambda w, x: D.dense_group_agg(w, 4, [x], [("sum", 1, None)]),
    lambda w, x: D.dense_group_agg(w, 4, [x], [("count", 0, None)]),
    lambda w, x: D.dense_group_agg(w, 4, [x.to(torch.float64)],
                                   [("low", 0, None)]),
    lambda w, x: D.dense_group_agg(w, 4, [x], [("sum", 0, x)]),
    lambda w, x: D.dense_group_agg(w[::2], 4, [], []),
    lambda w, x: D.dense_group_agg(w, 4, [x] * 33, []),
])
def test_dense_group_agg_rejects(bad):
    w = torch.zeros(10, dtype=torch.int64)
    x = torch.ones(10, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        bad(w, x)


# --------------------------------------------------------------------- gather


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_is_take(idx_dtype):
    """``t1``: ``take(x, idx)`` of 2048 int32; ``t1b``: rows of [1024, 128];
    out-of-range indices clamp like ``jnp.take(mode="clip")``."""
    x = _RNG.randint(-2 ** 31, 2 ** 31 - 1, 2048).astype(np.int32)
    perm = _RNG.permutation(2048).astype(idx_dtype)
    got, = G.gather_rows([_t(x)], _t(perm))
    np.testing.assert_array_equal(got.numpy(), x[perm])
    m = _RNG.uniform(size=(1024, 128)).astype(np.float32)
    idx = _RNG.randint(-5, 1030, 1024).astype(idx_dtype)
    got, = G.gather_rows([_t(m)], _t(idx))
    want = np.asarray(jnp.take(jnp.asarray(m), jnp.asarray(idx), axis=0,
                               mode="clip"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), m[np.clip(idx, 0, 1023)])


@pytest.mark.parametrize("shape", [(512, 128), (64, 7)])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_is_numpy(axis, shape):
    """``t1c`` / ``t1d``: ``take_along_axis`` on axis 0 / axis 1."""
    x = _RNG.randint(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32)
    idx = _RNG.randint(0, shape[axis], shape).astype(np.int32)
    got = G.take_along_axis(_t(x), _t(idx), axis)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(x, idx, axis))
    # another extent along the axis, and indices out of range: clamped
    other = (9, shape[1]) if axis == 0 else (shape[0], 9)
    wild = _RNG.randint(-3, shape[axis] + 3, other).astype(np.int64)
    got = G.take_along_axis(_t(x), _t(wild), axis)
    np.testing.assert_array_equal(
        got.numpy(),
        np.take_along_axis(x, np.clip(wild, 0, shape[axis] - 1), axis))


def test_gather_rows_many_types_one_call():
    n = 257
    srcs = [_RNG.rand(n) > 0.5, _RNG.randint(-100, 100, n).astype(np.int8),
            _RNG.randint(-100, 100, n).astype(np.int16),
            _RNG.randint(-100, 100, n).astype(np.int32),
            _RNG.randint(-2 ** 62, 2 ** 62, n), _RNG.rand(n).astype(np.float32),
            _RNG.rand(n), _RNG.randint(0, 9, (n, 5))]
    idx = _RNG.randint(-7, n + 7, 100)
    got = G.gather_rows([_t(s) for s in srcs], _t(idx))
    for s, g in zip(srcs, got):
        assert g.numpy().dtype == s.dtype
        np.testing.assert_array_equal(g.numpy(), s[np.clip(idx, 0, n - 1)])
    empty = G.gather_rows([torch.zeros((0,), dtype=torch.int64),
                           torch.zeros((0, 3), dtype=torch.int32)],
                          _t(np.array([0, 5])))
    assert empty[0].tolist() == [0, 0] and empty[1].shape == (2, 3)
    assert G.gather_rows([], _t(idx)) == []
    assert G.gather_rows([_t(srcs[4])], _t(idx[:0]))[0].shape == (0,)


@pytest.mark.parametrize("bad", [
    lambda x, i: G.gather_rows([x], i.to(torch.float32)),
    lambda x, i: G.gather_rows([x], i[None]),
    lambda x, i: G.gather_rows([x, x[:3]], i),
    lambda x, i: G.gather_rows([x[::2]], i),
    lambda x, i: G.gather_rows([x[None, None]], i),
    lambda x, i: G.gather_rows([x.numpy()], i),
    lambda x, i: G.take_along_axis(x, i, 0),
    lambda x, i: G.take_along_axis(x[None], i[None], 2),
    lambda x, i: G.take_along_axis(x[None], i[None, :3], 0),
])
def test_gather_rejects(bad):
    x = torch.arange(10)
    i = torch.arange(4)
    with pytest.raises((TypeError, ValueError)):
        bad(x, i)


# -------------------------------------------------------------------- scatter


@pytest.mark.parametrize("n", [2048, 8192])
def test_scatter_is_permutation_set(n):
    """``t2``: ``zeros.at[idx].set(x)``; ``t8``: the store loop
    ``out[idx[i]] = x[i]``."""
    x = _RNG.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    perm = _RNG.permutation(n).astype(np.int32)
    got = S.scatter_distinct(_t(perm), _t(x), n)
    want = np.zeros(n, np.int32)
    want[perm] = x
    np.testing.assert_array_equal(got.numpy(), want)
    jwant = jnp.zeros((n,), jnp.int32).at[jnp.asarray(perm)].set(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("x_dtype", [np.int32, np.int64, np.float64, None])
@pytest.mark.parametrize("n", [0, 1, 3, 777])
def test_scatter_mask_and_dropped_targets(n, x_dtype):
    perm = _RNG.permutation(n).astype(np.int64) - 2  # two targets below 0
    mask = _RNG.rand(n) > 0.4
    size = max(n - 5, 1)  # and a few past the end
    x = None if x_dtype is None else \
        _RNG.randint(-1000, 1000, n).astype(x_dtype)
    got = S.scatter_distinct(_t(perm), None if x is None else _t(x), size,
                             _t(mask))
    want = np.zeros(size, np.int64 if x is None else x_dtype)
    for i in range(n):
        if mask[i] and 0 <= perm[i] < size:
            want[perm[i]] = i if x is None else x[i]
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    same = S.scatter_distinct(_t(perm.astype(np.int32)),
                              None if x is None else _t(x), size, _t(mask))
    np.testing.assert_array_equal(same.numpy(), want)  # int32 index


@pytest.mark.parametrize("bad", [
    lambda i, x, m: S.scatter_distinct(i.to(torch.int16), x, 4),
    lambda i, x, m: S.scatter_distinct(i[None], x, 4),
    lambda i, x, m: S.scatter_distinct(i, x[:3], 4),
    lambda i, x, m: S.scatter_distinct(i, x.to(torch.float32), 4),
    lambda i, x, m: S.scatter_distinct(i, x, 4, m.to(torch.int32)),
    lambda i, x, m: S.scatter_distinct(i, x, -1),
    lambda i, x, m: S.scatter_distinct(i[::2], x[::2], 4),
])
def test_scatter_rejects(bad):
    i = torch.arange(8)
    x = torch.arange(8)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        bad(i, x, m)


# ------------------------------------------------- a CUDA tensor never falls back


class _OnCuda(torch.Tensor):
    """A tensor that claims to lie on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["dense_group_agg", "gather",
                                  "take_along_axis", "scatter"])
def test_cuda_tensor_launches_or_raises(monkeypatch, name):
    """For a tensor on a CUDA device a wrapper goes to its kernel and never
    to the plain version: when the build fails it raises, and the launch
    counter does not move."""
    called = []

    def failing_load(lib):
        called.append(f"build:{lib}")
        raise _build.KernelBuildError("nvcc failed: injected")

    monkeypatch.setattr(_build, "load", failing_load)
    fake = torch.arange(8).as_subclass(_OnCuda)
    assert isinstance(fake, torch.Tensor) and fake.device.type == "cuda"
    mod, plain, call = {
        "dense_group_agg": (D, "dense_group_agg_plain",
                            lambda: D.dense_group_agg(fake, 4, [fake],
                                                      [("sum", 0, None)])),
        "gather": (G, "gather_rows_plain",
                   lambda: G.gather_rows([fake], fake)),
        "take_along_axis": (G, "take_along_axis_plain",
                            lambda: G.take_along_axis(
                                fake.reshape(2, 4), fake.reshape(2, 4), 0)),
        "scatter": (S, "scatter_distinct_plain",
                    lambda: S.scatter_distinct(fake, fake, 8)),
    }[name]
    monkeypatch.setattr(mod, plain, lambda *a: called.append("plain"))
    before = mod.LAUNCHES
    with pytest.raises(_build.KernelBuildError, match="injected"):
        call()
    lib = "gather" if name == "take_along_axis" else name
    assert called == [f"build:{lib}"]
    assert mod.LAUNCHES == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The three CUDA kernels against their plain versions (needs a card;
    run with ``pytest -m cuda`` where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    n = 100_003
    word = _t(_RNG.randint(0, 14, n)).cuda()
    x = _t(_RNG.randint(-10 ** 12, 10 ** 12, n)).cuda()
    f = _t(_RNG.rand(n)).cuda()
    slots = [("sum", 0, None), ("low", 0, None), ("high", 0, None),
             ("min", 0, None), ("sum", 1, None), ("max", 1, None)]
    a = D.dense_group_agg(word, 13, [x, f], slots)
    b = D.dense_group_agg_plain(word, 13, [x, f], slots)
    assert torch.equal(a.counts, b.counts)
    assert torch.equal(a.first_row, b.first_row)
    for k in range(len(slots)):
        if a.slot(k).dtype == torch.float64:
            torch.testing.assert_close(a.slot(k), b.slot(k), rtol=1e-9,
                                       atol=0)
        else:
            assert torch.equal(a.slot(k), b.slot(k))
    idx = _t(_RNG.randint(-5, n + 5, 50_000)).cuda()
    for got, want in zip(G.gather_rows([x, f, word.to(torch.int32)], idx),
                         G.gather_rows_plain([x, f, word.to(torch.int32)],
                                             idx)):
        assert torch.equal(got, want)
    perm = _t(_RNG.permutation(n)).cuda()
    assert torch.equal(S.scatter_distinct(perm, x, n),
                       S.scatter_distinct_plain(perm, x, n))
