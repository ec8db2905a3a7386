"""The dynamic-copy kernel's plain version and ``batch.concat_batches``
against the JAX package's ``concat_batches`` on the same numpy inputs, the
wrapper's argument checks, and a CUDA tensor that never falls back.

Exact everywhere: the function moves bits.  Rows past the total are zeros in
the port and a repeat of the second part's last row in the JAX package (both
garbage by contract), so the comparison stops at the total and the port's
tail is checked to be zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto1_tpu.batch as j_batch
import presto1_tpu_torch.batch as t_batch
from presto1_tpu.batch import Column as JColumn, RecordBatch as JRecordBatch
from presto1_tpu_torch.ops.kernels import _build, dyncopy as DC

from torch_parity import assert_batches_equal, both_batches

torch.set_num_threads(1)
_RNG = np.random.RandomState(20240607)

DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32,
          np.float64]


def _values(shape, dt):
    if dt == np.bool_:
        return _RNG.rand(*shape) > 0.5
    if np.dtype(dt).kind == "f":
        return _RNG.randn(*shape).astype(dt)
    info = np.iinfo(dt)
    return _RNG.randint(max(info.min, -2**62), min(info.max, 2**62), shape,
                        dtype=np.int64).astype(dt)


def _numpy_concat(columns, counts, capacity):
    """The function in numpy: per column, each part's first clamped count
    of rows one after another, zero rows after; None = all-True rows."""
    rows = []
    for p in range(len(counts)):
        rows.append(next(c[p] for c in columns if c[p] is not None).shape[0])
    live = [min(max(int(c), 0), r) for c, r in zip(counts, rows)]
    out = []
    for col in columns:
        entries = [x for x in col if x is not None]
        width = max((x.shape[1] for x in entries), default=0) \
            if entries[0].ndim == 2 else None
        shape = (capacity,) if width is None else (capacity, width)
        o = np.zeros(shape, entries[0].dtype)
        at = 0
        for p, x in enumerate(col):
            n = min(live[p], max(capacity - at, 0))
            if x is None:
                o[at:at + n] = True
            elif width is None:
                o[at:at + n] = x[:n]
            else:
                o[at:at + n, :x.shape[1]] = x[:n]
            at += live[p]
        out.append(o)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


CASES = [
    # (part row counts, counts, capacity)
    ((2048,), (1000,), 2048),
    ((2048,), (0,), 128),
    ((2048, 2048), (7, 2048), 4096),
    ((300, 1, 129), (300, 1, 129), 512),
    ((300, 1, 129), (500, 9, -3), 512),        # past capacity, below zero
    ((300, 1, 129), (300, 1, 129), 200),       # truncated by the capacity
    ((1000, 0), (1000, 0), 1024),              # an empty part (FULL join)
    ((0, 1000), (0, 1000), 1024),
    ((64,) * 32, tuple(range(0, 64, 2)), 2048),  # 32 parts (t6x)
    ((5, 7), (5, 7), 0),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_concat_rows_plain_every_width(case, dt):
    rows, counts, capacity = case
    cols = [[_values((n,), dt) for n in rows]]
    want = _numpy_concat(cols, counts, capacity)
    got = DC.concat_rows([[_t(x) for x in c] for c in cols],
                         torch.tensor(counts, dtype=torch.int64), capacity)
    for w, g in zip(want, got):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_concat_rows_nested_widths_and_missing_validity():
    a = [_values((40, 3), np.int64), _values((40,), np.int32),
         _values((40,), np.bool_)]
    b = [_values((25, 7), np.int64), _values((25,), np.int32), None]
    cols = [[a[i], b[i]] for i in range(3)]
    want = _numpy_concat(cols, (38, 25), 128)
    got = DC.concat_rows([[_t(x) for x in c] for c in cols],
                         torch.tensor([38, 25]), 128)
    assert tuple(got[0].shape) == (128, 7)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_concat_rows_plain_index_arithmetic_matches_reference_union():
    """The plain version is the JAX package's Union arithmetic (iota,
    offsets, clamped take, ``where``) with clamped counts: on the live rows
    it equals ``jnp`` doing the same on the same inputs."""
    parts = [_values((n,), np.int64) for n in (50, 20, 70)]
    counts = [50, 13, 70]
    cap = 256
    i = jnp.arange(cap, dtype=jnp.int64)
    data, offset = None, 0
    for c, d in zip(counts, parts):
        local = i - offset
        sel = (local >= 0) & (local < c)
        g = jnp.take(jnp.asarray(d), jnp.clip(local, 0, d.shape[0] - 1),
                     mode="clip")
        data = jnp.where(sel, g, 0 if data is None else data)
        offset += c
    got = DC.concat_rows_plain([[_t(x) for x in parts]],
                               torch.tensor(counts), cap)[0]
    np.testing.assert_array_equal(got.numpy()[:sum(counts)],
                                  np.asarray(data)[:sum(counts)])
    assert not got[sum(counts):].any()


def _pair(na, nb, cap, validity=(True, False), nested=False):
    spec_a, spec_b = {}, {}
    for name, dt, t in (("i", np.int64, "bigint"), ("f", np.float64, "double"),
                        ("d", np.int32, "date"), ("s", np.int16, "smallint")):
        for spec, n, v in ((spec_a, na, validity[0]), (spec_b, nb,
                                                       validity[1])):
            data = np.zeros(cap, dt)
            data[:n] = _values((n,), dt)
            valid = None
            if v:
                valid = np.zeros(cap, bool)
                valid[:n] = _RNG.rand(n) > 0.3
            spec[name] = (data, valid, t)
    d = np.array(["a", "b", "c"])
    for spec, n in ((spec_a, na), (spec_b, nb)):
        codes = np.zeros(cap, np.int32)
        codes[:n] = _RNG.randint(0, 3, n)
        spec["v"] = (codes, None, "varchar", d)
    return both_batches(spec_a, na), both_batches(spec_b, nb)


@pytest.mark.parametrize("na,nb,validity", [
    (100, 50, (True, False)), (100, 50, (False, True)),
    (100, 50, (True, True)), (100, 50, (False, False)),
    (0, 128, (True, False)), (128, 0, (False, True)), (1, 1, (True, True)),
])
def test_concat_batches_matches_reference(na, nb, validity):
    (ja, ta), (jb, tb) = _pair(na, nb, 128, validity)
    cap = 384
    want = j_batch.concat_batches(ja, jb, cap)
    got = t_batch.concat_batches(ta, tb, cap)
    assert int(got.num_rows) == na + nb
    assert_batches_equal(want, got)
    for c in got.columns.values():
        assert not c.data[na + nb:].any()
        if c.validity is not None:
            assert not c.validity[na + nb:].any()


def test_concat_batches_nested_pads_the_narrower():
    """``[n, W]`` columns of two widths: the narrower padded with zeros,
    lengths carried along, as the JAX package pads them."""
    from presto1_tpu.types import ArrayType as JArray, BIGINT as JBIG
    from presto1_tpu_torch.types import ArrayType as TArray, BIGINT as TBIG

    a = _values((128, 2), np.int64)
    b = _values((128, 5), np.int64)
    la = _RNG.randint(0, 3, 128).astype(np.int32)
    lb = _RNG.randint(0, 6, 128).astype(np.int32)
    ja = JRecordBatch({"x": JColumn(jnp.asarray(a), JArray(JBIG),
                                    lengths=jnp.asarray(la))}, 60)
    jb = JRecordBatch({"x": JColumn(jnp.asarray(b), JArray(JBIG),
                                    lengths=jnp.asarray(lb))}, 40)
    ta = t_batch.RecordBatch({"x": t_batch.Column(_t(a), TArray(TBIG),
                                                  lengths=_t(la))}, 60)
    tb = t_batch.RecordBatch({"x": t_batch.Column(_t(b), TArray(TBIG),
                                                  lengths=_t(lb))}, 40)
    want = j_batch.concat_batches(ja, jb, 256)
    got = t_batch.concat_batches(ta, tb, 256)
    assert tuple(got["x"].data.shape) == (256, 5)
    np.testing.assert_array_equal(got["x"].data[:100].numpy(),
                                  np.asarray(want["x"].data)[:100])
    np.testing.assert_array_equal(got["x"].lengths[:100].numpy(),
                                  np.asarray(want["x"].lengths)[:100])


def test_concat_batches_counts_stay_on_the_device():
    """Counts that are 0-d tensors (a compiled fragment's) need no sync."""
    (ja, ta), (jb, tb) = _pair(90, 70, 128)
    ta = t_batch.RecordBatch(ta.columns, torch.tensor(90))
    tb = t_batch.RecordBatch(tb.columns, torch.tensor(70))
    got = t_batch.concat_batches(ta, tb, 256)
    assert isinstance(got.num_rows, torch.Tensor) and int(got.num_rows) == 160
    assert_batches_equal(j_batch.concat_batches(ja, jb, 256),
                         t_batch.RecordBatch(got.columns, 160))


# ------------------------------------------------------------ argument checks


@pytest.mark.parametrize("bad", [
    "noncontiguous", "dtype_mix", "none_in_int", "all_none", "k_too_big",
    "rows_mismatch", "rank_mix", "counts_dtype", "wide_dtype",
])
def test_concat_rows_rejects(bad):
    x = torch.arange(20, dtype=torch.int64)
    cols, counts = [[x, x]], torch.tensor([3, 4])
    if bad == "noncontiguous":
        cols = [[x[::2], x[::2]]]
    elif bad == "dtype_mix":
        cols = [[x, x.to(torch.int32)]]
    elif bad == "none_in_int":
        cols = [[x, None]]
    elif bad == "all_none":
        cols = [[None, None]]
    elif bad == "k_too_big":
        cols = [[x] * 33]
        counts = torch.zeros(33, dtype=torch.int64)
    elif bad == "rows_mismatch":
        cols = [[x, x], [x[:5], x]]
    elif bad == "rank_mix":
        cols = [[x, x.reshape(10, 2)]]
    elif bad == "counts_dtype":
        counts = counts.to(torch.int32)
    elif bad == "wide_dtype":
        cols = [[x.to(torch.complex128), x.to(torch.complex128)]]
    with pytest.raises((TypeError, ValueError)):
        DC.concat_rows(cols, counts, 64)


class _OnCuda(torch.Tensor):
    """A tensor that claims to lie on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """For tensors on a CUDA device the wrapper goes to its kernel and never
    to the plain version: when the build fails it raises, and the launch
    counter does not move."""
    called = []

    def failing_load(lib):
        called.append(f"build:{lib}")
        raise _build.KernelBuildError("nvcc failed: injected")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(DC, "concat_rows_plain",
                        lambda *a: called.append("plain"))
    fake = torch.arange(8).as_subclass(_OnCuda)
    counts = torch.tensor([3, 0]).as_subclass(_OnCuda)
    before = DC.LAUNCHES
    with pytest.raises(_build.KernelBuildError, match="injected"):
        DC.concat_rows([[fake, fake]], counts, 16)
    assert called == ["build:dyncopy"]
    assert DC.LAUNCHES == before


def test_cpu_tensors_launch_nothing():
    before = DC.LAUNCHES
    DC.concat_rows([[torch.arange(5), torch.arange(3)]],
                   torch.tensor([5, 3]), 8)
    assert DC.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (needs a card; run with
    ``pytest -m cuda`` where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cols = [[_t(_values((n,), dt)).cuda() for n in (3000, 1, 2049)]
            for dt in DTYPES]
    cols.append([_t(_values((3000, 3), np.int64)).cuda(),
                 _t(_values((1, 7), np.int64)).cuda(),
                 _t(_values((2049, 2), np.int64)).cuda()])
    for counts in ((3000, 1, 2049), (5000, 9, -1), (0, 0, 17)):
        c = torch.tensor(counts, dtype=torch.int64, device="cuda")
        for capacity in (1, 4096, 8192):
            got = DC.concat_rows(cols, c, capacity)
            want = DC.concat_rows_plain(cols, c, capacity)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
