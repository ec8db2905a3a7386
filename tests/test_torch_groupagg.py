"""The port's key packing, multi-operand sort, segmented reductions and
grouped aggregation against the JAX package's, on the same numpy inputs, on
the CPU (where the JAX functions take their own CPU branch).

Integers, decimals, counts, validity and group order exact; doubles to 1e-6
relative (summation order differs).  Key columns of dead slots are garbage
by contract: only the first ``num_rows`` groups are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.ops.common as j_common
import presto1_tpu.ops.hashagg as j_agg
import presto1_tpu.ops.segments as j_seg
import presto1_tpu_torch.ops.common as t_common
import presto1_tpu_torch.ops.hashagg as t_agg
import presto1_tpu_torch.ops.segments as t_seg
from presto1_tpu_torch.ops.kernels import dense_group_agg as D

from torch_parity import assert_batches_equal, both_batches

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)

N = 384
_RNG = np.random.RandomState(5)
_FLAGS = np.array(["A", "N", "R"])
_STATUS = np.array(["F", "O"])
SPEC = {
    "flag": (_RNG.randint(0, 3, N).astype(np.int32), None, "varchar", _FLAGS),
    "status": (_RNG.randint(0, 2, N).astype(np.int32), None, "varchar",
               _STATUS),
    "k": (_RNG.randint(0, 60, N), None, "bigint"),
    "kn": (_RNG.randint(-5, 5, N), _RNG.rand(N) > 0.2, "bigint"),
    "wide1": (_RNG.randint(-2 ** 40, 2 ** 40, N) // 2 ** 36 * 2 ** 36, None,
              "bigint"),
    "wide2": (_RNG.randint(0, 4, N) * 2 ** 38, None, "bigint"),
    "d": (_RNG.randint(9000, 9008, N).astype(np.int32), None, "date"),
    "p": (_RNG.randint(0, 10 ** 7, N), None, "decimal(12,2)"),
    "pn": (_RNG.randint(-10 ** 7, 10 ** 7, N), _RNG.rand(N) > 0.5,
           "decimal(12,2)"),
    "w": (_RNG.randint(-10 ** 17, 10 ** 17, N), None, "decimal(18,2)"),
    "x": (_RNG.uniform(-100, 100, N), None, "double"),
    "xn": (_RNG.uniform(-100, 100, N), _RNG.rand(N) > 0.3, "double"),
    "i": (_RNG.randint(-1000, 1000, N).astype(np.int32), None, "integer"),
    "b": (_RNG.randint(-10 ** 6, 10 ** 6, N), _RNG.rand(N) > 0.2, "bigint"),
}
# a column that depends on k alone (a ``carry`` candidate)
SPEC["name_of_k"] = (SPEC["k"][0] * 7 + 1, None, "bigint")
# sorted on k: the clustered path's input
_ORDER = np.argsort(SPEC["k"][0], kind="stable")
SORTED_SPEC = {n: (v[0][_ORDER], None if v[1] is None else v[1][_ORDER])
               + tuple(v[2:]) for n, v in SPEC.items()}

KEYSETS = {
    "q1_flags": ["flag", "status"],          # 3 x 2 domain: the dense path
    "dense_nullable": ["kn"],                # dense, NULL key group
    "sixty": ["k"],                          # > 32 groups: the sort path
    "date_flag": ["d", "flag"],
    "nullable_pair": ["kn", "status"],
    "two_words": ["wide1", "wide2", "k"],    # does not fit one 63-bit word
}
AGGSETS = {
    "q1": [("sum", "p", "s"), ("sum", "w", "sw"), ("avg", "p", "a"),
           ("avg", "w", "aw"), ("count_star", None, "n")],
    "nullable": [("sum", "pn", "s"), ("avg", "pn", "a"), ("count", "pn", "c"),
                 ("min", "pn", "mn"), ("max", "pn", "mx"), ("sum", "b", "sb"),
                 ("count", "b", "cb")],
    "minmax": [("min", "p", "mn"), ("max", "p", "mx"), ("min", "i", "mi"),
               ("max", "d", "md"), ("min", "x", "mx_"), ("max", "xn", "mxn"),
               ("min", "flag", "mf"), ("sum", "i", "si"), ("avg", "i", "ai")],
    "double": [("sum", "x", "s"), ("avg", "x", "a"), ("sum", "xn", "sn"),
               ("avg", "xn", "an"), ("count", "xn", "cn")],
    "count_only": [("count_star", None, "n")],
}


def _ranges(batch, names, num_rows, mod):
    return mod.key_ranges([batch[n] for n in names], num_rows)


_COMMON = {j_agg: j_common, t_agg: t_common}


def _group(mod, batch, keys, aggs, num_rows, max_groups, mask, carry=(),
           clustered=False, checks=None):
    ranges = _ranges(batch, keys, num_rows, _COMMON[mod])
    return mod.group_aggregate(
        [(k, batch[k]) for k in keys],
        [mod.AggSpec(fn, None if c is None else batch[c], name,
                     param=param[0] if param else None)
         for fn, c, name, *param in aggs],
        num_rows, ranges, max_groups, mask=mask,
        carry=[(c, batch[c]) for c in carry], checks=checks,
        clustered=clustered)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_rows", [N, 200])
@pytest.mark.parametrize("aggs", sorted(AGGSETS))
@pytest.mark.parametrize("keys", sorted(KEYSETS))
def test_group_aggregate(keys, aggs, num_rows, masked):
    jb, tb = both_batches(SPEC, num_rows)
    mask = (_RNG.rand(N) > 0.4) if masked else None
    jchecks, tchecks = [], []
    jo = _group(j_agg, jb, KEYSETS[keys], AGGSETS[aggs],
                num_rows, 128, None if mask is None else jnp.asarray(mask),
                checks=jchecks)
    launches = D.LAUNCHES
    to = _group(t_agg, tb, KEYSETS[keys], AGGSETS[aggs],
                num_rows, 128, None if mask is None else torch.from_numpy(mask),
                checks=tchecks)
    assert D.LAUNCHES == launches  # CPU tensors never launch the kernel
    assert not isinstance(to.num_rows, int) and to.num_rows.dim() == 0
    assert_batches_equal(jo, to, f"{keys}/{aggs}")
    assert [bool(c) for c in jchecks] == [bool(c) for c in tchecks]
    assert len(tchecks) == sum(1 for fn, c, *_ in AGGSETS[aggs]
                               if fn == "sum" and c == "w")


def test_dense_path_is_taken_for_q1_flags_only(monkeypatch):
    """3 x 2 flags go to the dense kernel's wrapper, 60 keys do not."""
    _, tb = both_batches(SPEC)
    calls = []
    real = t_agg.dense_group_agg
    monkeypatch.setattr(t_agg, "dense_group_agg",
                        lambda *a: calls.append(a[1]) or real(*a))
    _group(t_agg, tb, KEYSETS["q1_flags"], AGGSETS["q1"], N, 128, None)
    assert calls == [12]  # (3 + 1) x (2 + 1) candidate words
    _group(t_agg, tb, KEYSETS["sixty"], AGGSETS["q1"], N, 128, None)
    assert calls == [12]
    # a percentile keeps even a tiny domain on the sort path
    _group(t_agg, tb, KEYSETS["q1_flags"], [("median", "p", "m")], N, 128,
           None)
    assert calls == [12]
    assert t_agg.DENSE_MAX_GROUPS == j_agg.DENSE_MAX_GROUPS == 32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("keys", ["q1_flags", "sixty", "nullable_pair"])
def test_percentiles(keys, masked):
    aggs = [("median", "p", "med"), ("approx_percentile", "x", "p90", 0.9),
            ("approx_percentile", "pn", "p10", 0.1), ("median", "xn", "mn"),
            ("sum", "p", "s"), ("median", "flag", "mf")]
    jb, tb = both_batches(SPEC, 300)
    mask = (_RNG.rand(N) > 0.3) if masked else None
    jo = _group(j_agg, jb, KEYSETS[keys], aggs, 300, 128,
                None if mask is None else jnp.asarray(mask))
    to = _group(t_agg, tb, KEYSETS[keys], aggs, 300, 128,
                None if mask is None else torch.from_numpy(mask))
    assert_batches_equal(jo, to, keys)


@pytest.mark.parametrize("num_rows", [N, 123, 0])
def test_global_percentiles(num_rows):
    jb, tb = both_batches(SPEC, num_rows)
    aggs = [("median", "p", "med"), ("approx_percentile", "x", "p90", 0.9),
            ("approx_percentile", "pn", "p10", 0.1), ("median", "xn", "mn")]
    mask = _RNG.rand(N) > 0.4

    def run(mod, b, m):
        return mod.global_aggregate(
            [mod.AggSpec(fn, b[c], name, param=p[0] if p else None)
             for fn, c, name, *p in aggs], num_rows, N, mask=m)

    assert_batches_equal(run(j_agg, jb, jnp.asarray(mask)),
                         run(t_agg, tb, torch.from_numpy(mask)), "global")


@pytest.mark.parametrize("carry", [(), ("name_of_k",)])
def test_clustered_and_carry(carry):
    """Input sorted on the key: ``clustered=True`` skips the grouping sort
    and must give what the sorting path gives; ``carry`` columns come from
    each group's representative row."""
    jb, tb = both_batches(SORTED_SPEC, 300)
    aggs = AGGSETS["q1"] + [("min", "pn", "mn"), ("max", "x", "mx"),
                            ("median", "p", "med")]
    jo = _group(j_agg, jb, ["k"], aggs, 300, 128, None, carry, True)
    to = _group(t_agg, tb, ["k"], aggs, 300, 128, None, carry, True)
    assert_batches_equal(jo, to, "clustered")
    plain = _group(t_agg, tb, ["k"], aggs, 300, 128, None, carry, False)
    assert to.to_pylist() == plain.to_pylist()
    if carry:
        k = to["k"].data[:int(to.num_rows)]
        assert torch.equal(to["name_of_k"].data[:len(k)], k * 7 + 1)
    # with a mask the flag is dropped and the sorting path runs
    mask = _RNG.rand(N) > 0.5
    jo = _group(j_agg, jb, ["k"], aggs, 300, 128, jnp.asarray(mask), carry,
                True)
    to = _group(t_agg, tb, ["k"], aggs, 300, 128, torch.from_numpy(mask),
                carry, True)
    assert_batches_equal(jo, to, "clustered+mask")


def test_unsafe_decimal_sum_guard():
    """decimal(18,2) sums cannot be proven safe: the limb path appends one
    guard per sum, true while every group's total fits, on either branch."""
    n = 256
    for overflow in (False, True):
        vals = np.full(n, 11 * 10 ** 16 if overflow else 10 ** 15, np.int64)
        for nkeys in (3, 60):
            spec = {"g": (np.arange(n) % nkeys, None, "bigint"),
                    "w": (vals, None, "decimal(18,2)")}
            jb, tb = both_batches(spec)
            jc, tc = [], []
            jo = _group(j_agg, jb, ["g"], [("sum", "w", "s")], n, 128, None,
                        checks=jc)
            to = _group(t_agg, tb, ["g"], [("sum", "w", "s")], n, 128, None,
                        checks=tc)
            assert len(jc) == len(tc) == 1
            # 85 rows of 1.1e17 leave the device decimal; 4 rows do not
            fits = not (overflow and nkeys == 3)
            assert bool(jc[0]) == bool(tc[0]) == fits
            if fits:
                assert_batches_equal(jo, to, "guarded")
            assert str(to["s"].type) == "decimal(38,2)"


def test_num_rows_as_device_scalar_and_capacity():
    """Inside a compiled fragment ``num_rows`` is a 0-d tensor; a
    ``max_groups`` beyond the row count pads."""
    _, tb = both_batches(SPEC, N)
    for keys in ("q1_flags", "sixty"):
        a = _group(t_agg, tb, KEYSETS[keys], AGGSETS["q1"], 100, 512, None)
        ranges = _ranges(tb, KEYSETS[keys], 100, t_common)
        b = t_agg.group_aggregate(
            [(k, tb[k]) for k in KEYSETS[keys]],
            [t_agg.AggSpec(fn, None if c is None else tb[c], name)
             for fn, c, name in AGGSETS["q1"]],
            torch.tensor(100), ranges, 512)
        assert a.capacity() == b.capacity() == 512
        assert a.to_pylist() == b.to_pylist()


# ------------------------------------------------------------------ common.py


@pytest.mark.parametrize("null_high", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("keys", sorted(KEYSETS))
def test_pack_key_words(keys, masked, null_high):
    jb, tb = both_batches(SPEC, 300)
    names = KEYSETS[keys]
    mask = (_RNG.rand(N) > 0.5) if masked else None
    ranges = _ranges(jb, names, 300, j_common)
    assert ranges == _ranges(tb, names, 300, t_common)
    jw = j_common.pack_key_words(
        [jb[n] for n in names], ranges, 300,
        None if mask is None else jnp.asarray(mask), null_high)
    tw = t_common.pack_key_words(
        [tb[n] for n in names], ranges, 300,
        None if mask is None else torch.from_numpy(mask), null_high)
    assert len(jw) == len(tw) == (2 if keys == "two_words" else 1)
    for a, b in zip(jw, tw):
        assert b.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    dead = np.arange(N) >= 300
    if mask is not None:
        dead |= ~mask
    assert (tw[0].numpy()[dead] == np.iinfo(np.int64).max).all()
    if len(tw) == 1:
        np.testing.assert_array_equal(
            np.asarray(j_common.pack_keys([jb[n] for n in names], ranges,
                                          300)),
            t_common.pack_keys([tb[n] for n in names], ranges, 300).numpy())
    np.testing.assert_array_equal(
        np.asarray(j_common.mix_key_word(
            [jb[n] for n in names], ranges, 300,
            None if mask is None else jnp.asarray(mask), null_high)),
        t_common.mix_key_word(
            [tb[n] for n in names], ranges, 300,
            None if mask is None else torch.from_numpy(mask),
            null_high).numpy())


@pytest.mark.parametrize("keys", ["q1_flags", "dense_nullable"])
def test_pack_dense_word(keys):
    jb, tb = both_batches(SPEC, 300)
    names = KEYSETS[keys]
    mask = _RNG.rand(N) > 0.5
    ranges = _ranges(jb, names, 300, j_common)
    for m in (None, mask):
        jw = j_agg.pack_dense_word([jb[n] for n in names], ranges, 300,
                                   None if m is None else jnp.asarray(m))
        tw = t_agg.pack_dense_word([tb[n] for n in names], ranges, 300,
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_narrow_i32_and_searchsorted():
    w = np.array([0, 5, 2 ** 20, np.iinfo(np.int64).max], np.int64)
    for bits in (21, 30, 31, 40):
        a = np.asarray(j_common.narrow_i32(jnp.asarray(w), bits))
        b = t_common.narrow_i32(torch.from_numpy(w), bits).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a = np.sort(_RNG.randint(0, 50, 200))
    v = _RNG.randint(-3, 55, 64)
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            np.asarray(j_common.searchsorted_fast(jnp.asarray(a),
                                                  jnp.asarray(v), side)),
            t_common.searchsorted_fast(torch.from_numpy(a),
                                       torch.from_numpy(v), side).numpy())
    assert not hasattr(t_common, "searchsorted_cosort")
    assert not hasattr(t_common, "_wide_sort_rows")


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_sort_multi_is_lax_sort(num_keys):
    """Lexicographic over the first ``num_keys`` operands, the rest ride;
    int8 keys, INT64_MAX sentinels last, stable on ties."""
    n = 500
    dead = (_RNG.rand(n) > 0.8).astype(np.int8)
    k1 = np.where(dead, np.iinfo(np.int64).max, _RNG.randint(0, 6, n))
    k2 = _RNG.randint(-3, 3, n).astype(np.int32)
    pay_f = _RNG.rand(n)
    pay_b = (_RNG.rand(n) > 0.5).astype(np.int8)
    ops = [dead, k1, k2, np.arange(n), pay_f, pay_b]
    want = jax.lax.sort(tuple(jnp.asarray(o) for o in ops),
                        num_keys=num_keys, is_stable=True)
    got = t_common.sort_multi([torch.from_numpy(o) for o in ops], num_keys)
    assert len(got) == len(ops)
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    perm = t_common.sort_permutation(
        [torch.from_numpy(o) for o in ops[:num_keys]])
    np.testing.assert_array_equal(perm.numpy(), got[3].numpy())
    with pytest.raises(ValueError):
        t_common.sort_multi([torch.from_numpy(dead)], 2)


# ---------------------------------------------------------------- segments.py


def _segments():
    gid = np.sort(_RNG.randint(0, 40, N))
    gid[300:] = 64  # dead tail: the out-of-range id
    return gid


def test_segment_bounds_and_sums():
    gid = _segments()
    js, je = j_seg.segment_bounds(jnp.asarray(gid), 64)
    ts, te = t_seg.segment_bounds(torch.from_numpy(gid), 64)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    for dtype in (np.int64, np.float64):
        vals = (_RNG.randint(-10 ** 9, 10 ** 9, N)).astype(dtype)
        a = np.asarray(j_seg.sorted_segment_sum(jnp.asarray(vals), js, je))
        b = t_seg.sorted_segment_sum(torch.from_numpy(vals), ts, te).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6)
        if dtype == np.int64:
            np.testing.assert_array_equal(a, b)
        m = np.stack([vals, vals[::-1], np.ones(N, dtype)], axis=1)
        a = np.asarray(j_seg.sorted_segment_sum_multi(jnp.asarray(m), js, je))
        b = t_seg.sorted_segment_sum_multi(
            [torch.from_numpy(np.ascontiguousarray(m[:, j]))
             for j in range(3)], ts, te).numpy()
        assert a.shape == b.shape == (64, 3)
        np.testing.assert_allclose(b, a, rtol=1e-6)
    v = _RNG.randint(-2 ** 62, 2 ** 62, N)
    np.testing.assert_allclose(
        t_agg._exact_sum_f64(torch.from_numpy(v), ts, te).numpy(),
        np.asarray(j_agg._exact_sum_f64(jnp.asarray(v), js, je)), rtol=1e-12)


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_minmax_by_value_sort(dtype, is_min):
    jb, tb = both_batches(SPEC, 300)
    ranges = _ranges(jb, ["k"], 300, j_common)
    jw = j_common.pack_key_words([jb["k"]], ranges, 300)
    tw = t_common.pack_key_words([tb["k"]], ranges, 300)
    js = j_agg._group_structure(jw, 128)
    ts = t_agg._group_structure(tw, 128)
    vals = _RNG.randint(-1000, 1000, N).astype(dtype)
    valid = _RNG.rand(N) > 0.3
    for v in (None, valid):
        a = j_seg.minmax_by_value_sort(
            jw, jnp.asarray(vals), js[3], js[4], is_min,
            None if v is None else jnp.asarray(v))
        b = t_seg.minmax_by_value_sort(
            tw, torch.from_numpy(vals), ts[3], ts[4], is_min,
            None if v is None else torch.from_numpy(v))
        g = int(ts[2])
        np.testing.assert_array_equal(np.asarray(a)[:g], b.numpy()[:g])


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("max_groups", [64, 128, 512])
def test_group_structure(max_groups, clustered):
    """order, gid, group count, starts, ends, representatives and the
    payload that rode the sort; ``max_groups`` beyond the rows pads."""
    spec = SORTED_SPEC if clustered else SPEC
    jb, tb = both_batches(spec, 300)
    ranges = _ranges(jb, ["k"], 300, j_common)
    jw = j_common.pack_key_words([jb["k"]], ranges, 300)
    tw = t_common.pack_key_words([tb["k"]], ranges, 300)
    pay = spec["p"][0]
    jo = j_agg._group_structure(jw, max_groups, (jnp.asarray(pay),),
                                clustered)
    to = t_agg._group_structure(tw, max_groups, (torch.from_numpy(pay),),
                                clustered)
    g = int(to[2])
    assert g == int(jo[2]) == len(np.unique(spec["k"][0][:300]))
    np.testing.assert_array_equal(np.asarray(jo[0]), to[0].numpy())  # order
    np.testing.assert_array_equal(np.asarray(jo[1]), to[1].numpy())  # gids
    for i in (3, 4):  # starts, ends: dead slots hold n_real on both sides
        np.testing.assert_array_equal(np.asarray(jo[i]), to[i].numpy())
    np.testing.assert_array_equal(np.asarray(jo[5])[:g], to[5].numpy()[:g])
    np.testing.assert_array_equal(np.asarray(jo[6][0]), to[6][0].numpy())
