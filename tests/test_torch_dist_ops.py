"""The port's mesh operators (``presto1_tpu_torch/parallel/``) against the
JAX package's on the 8-virtual-device CPU mesh, the same numpy inputs on
both sides (at most 8 x 256 rows a shard): ``distributed_group_aggregate``
(with and without a mask and carry columns, on the dense and the sorting
path), ``distributed_global_aggregate``, ``distributed_hash_join`` (inner,
left, semi and anti, with a residual), ``broadcast_hash_join``,
``distributed_topn``, ``skew_aware_join`` (single and multi-key), the
exchange's overflow error, ``dryrun_q1`` and ``dryrun_join``.

Integers, decimals, dates and codes exact, doubles to 1e-6 relative.  The
rows of a stage's result are compared as a set where their order is the
order of shards (any order is the contract); the reference defects C16-C18
are shown on inputs where the JAX package's answer differs from its own
single-device operator, and the port's does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.expr.ir as j_ir
import presto1_tpu.ops.hashagg as j_hashagg
import presto1_tpu.parallel.dist_agg as j_agg
import presto1_tpu.parallel.dist_join as j_dj
import presto1_tpu.parallel.distributed as j_distributed
import presto1_tpu.parallel.skew as j_skew
import presto1_tpu.types as j_types
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.ops.hashagg as t_hashagg
import presto1_tpu_torch.ops.join as t_join
import presto1_tpu_torch.parallel.dist_agg as t_agg
import presto1_tpu_torch.parallel.dist_join as t_dj
import presto1_tpu_torch.parallel.distributed as t_distributed
import presto1_tpu_torch.parallel.skew as t_skew
import presto1_tpu_torch.types as t_types
from presto1_tpu.batch import round_capacity

from torch_parity import both_batches

torch.set_num_threads(1)

N = 8


@pytest.fixture(scope="module")
def j_mesh():
    assert len(jax.devices()) >= N, "need 8 virtual devices (see conftest)"
    return j_distributed.make_mesh(N)


@pytest.fixture(scope="module")
def t_mesh():
    return t_distributed.make_mesh(N, device="cpu")


def _rows(batch):
    """The batch's live rows as tuples of plain Python values."""
    out = []
    for r in batch.to_pylist():
        out.append(tuple(None if v is None else
                         (float(v) if isinstance(v, (float, np.floating))
                          else v.item() if isinstance(v, np.generic) else v)
                         for v in r))
    return out


def _key(row):
    return tuple((v is None, 0 if v is None or isinstance(v, float) else v)
                 for v in row)


def assert_same_rows(got, want, ordered=False):
    """Equal column sets and rows (as a multiset unless ``ordered``):
    floats to 1e-6 relative, everything else exactly.  (The JAX package's
    stage results come back through ``shard_map`` with their columns in
    name order.)"""
    assert sorted(got.names) == sorted(want.names)
    got, want = _rows(got), _rows(want.select(got.names))
    assert len(got) == len(want), (len(got), len(want))
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) or isinstance(a, float):
                assert a is not None and b is not None, (g, w)
                assert a == pytest.approx(b, rel=1e-6, abs=1e-9), (g, w)
            else:
                assert a == b, (g, w)


# ------------------------------------------------------------ aggregation


def _agg_batches(seed, n_rows, key_hi, cap=2048):
    rng = np.random.RandomState(seed)

    def pad(a, dtype):
        out = np.zeros(cap, dtype)
        out[:n_rows] = a
        return out

    k = rng.randint(0, key_hi, n_rows)
    spec = {
        "k": (pad(k, np.int64), None, "bigint"),
        "c": (pad(k * 10 + 3, np.int64), None, "bigint"),  # carried
        "x": (pad(rng.randint(-50, 1000, n_rows), np.int64),
              pad(rng.rand(n_rows) > 0.1, bool), "bigint"),
        "d": (pad(rng.randint(-10**6, 10**7, n_rows), np.int64),
              None, "decimal(12,2)"),
        "f": (pad(rng.normal(size=n_rows) * 100, np.float64), None,
              "double"),
    }
    mask = pad(rng.rand(n_rows) > 0.3, bool)
    jb, tb = both_batches(spec, num_rows=n_rows)
    return jb, tb, mask


# min and max over columns without NULLs: over a nullable one the JAX
# package's answer is wrong (C17, below)
_AGGS = (("sum", "x"), ("count", "x"), ("count_star", None), ("min", "d"),
         ("max", "f"), ("avg", "x"), ("sum", "f"), ("avg", "d"),
         ("sum", "d"), ("max", "d"))


def _specs(mod, batch):
    return [mod.AggSpec(fn, None if a is None else batch[a], f"a{i}")
            for i, (fn, a) in enumerate(_AGGS)]


@pytest.mark.parametrize("key_hi", [3, 100], ids=["dense", "sorting"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("carry", [False, True], ids=["keys", "carry"])
def test_group_aggregate_matches_the_reference(j_mesh, t_mesh, key_hi,
                                               masked, carry):
    n_rows = 2000
    jb, tb, mask = _agg_batches(7, n_rows, key_hi)
    ranges = [(0, key_hi - 1)]
    max_groups = round_capacity(key_hi)
    cols = ["k", "c"] if carry else ["k"]
    carry_names = ["c"] if carry else []
    want = j_agg.distributed_group_aggregate(
        j_mesh, ["k"], {c: jb[c] for c in cols}, _specs(j_hashagg, jb),
        n_rows, ranges, max_groups,
        mask=jnp.asarray(mask) if masked else None, carry_names=carry_names)
    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {c: tb[c] for c in cols}, _specs(t_hashagg, tb),
        n_rows, ranges, max_groups,
        mask=torch.from_numpy(mask) if masked else None,
        carry_names=carry_names)
    assert list(got.columns) == list(want.columns)
    for name in got.columns:
        assert str(got[name].type) == str(want[name].type), name
    assert_same_rows(got, want)
    # and the port's single-device operator
    local = t_hashagg.group_aggregate(
        [("k", tb["k"])], _specs(t_hashagg, tb), n_rows, ranges,
        max_groups, mask=torch.from_numpy(mask) if masked else None,
        carry=[("c", tb["c"])] if carry else ())
    assert_same_rows(got, local)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_global_aggregate_matches_the_reference(j_mesh, t_mesh, masked):
    n_rows = 1900
    jb, tb, mask = _agg_batches(8, n_rows, 5)
    want = j_agg.distributed_global_aggregate(
        j_mesh, _specs(j_hashagg, jb), n_rows,
        mask=jnp.asarray(mask) if masked else None)
    got = t_agg.distributed_global_aggregate(
        t_mesh, _specs(t_hashagg, tb), n_rows,
        mask=torch.from_numpy(mask) if masked else None)
    assert int(got.num_rows) == 1
    assert_same_rows(got, want)


def test_a_null_partial_stays_null_c17(j_mesh, t_mesh):
    """C17: the JAX package drops the partials' validity before the final
    combine.  A group whose values are NULL on every shard then answers 0
    for its sum and the sentinel for its min and max, and on the sorting
    path a group NULL on one shard adds that shard's 0 to its min.  The
    port keeps the validity and equals both packages' single-device
    operators."""
    n_rows = 2048
    k = np.where(np.arange(n_rows) < 1024, 0, 1)
    x = np.arange(n_rows) + 100
    spec = {"k": (k, None, "bigint"),
            "x": (x, np.arange(n_rows) >= 1024, "bigint")}
    jb, tb = both_batches(spec, num_rows=n_rows)
    aggs = (("sum", "x"), ("min", "x"), ("max", "x"), ("count", "x"))

    def specs(mod, b, aggs):
        return [mod.AggSpec(fn, b[a], f"a{i}")
                for i, (fn, a) in enumerate(aggs)]

    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {"k": tb["k"]}, specs(t_hashagg, tb, aggs), n_rows,
        [(0, 1)], 128)
    ref = j_agg.distributed_group_aggregate(
        j_mesh, ["k"], {"k": jb["k"]}, specs(j_hashagg, jb, aggs), n_rows,
        [(0, 1)], 128)
    s = int(x[1024:].sum())
    assert sorted(_rows(got), key=_key) == [
        (0, None, None, None, 0), (1, s, 1124, 2147, 1024)]
    assert sorted(_rows(ref), key=_key)[0] == (0, 0, np.iinfo(np.int64).max,
                                               np.iinfo(np.int64).min, 0)
    # (the JAX package's dense single-device path has a defect of its own
    # here, C20: its sorting path is held instead)
    for mod, b, ranges in ((t_hashagg, tb, [(0, 1)]),
                           (j_hashagg, jb, [(0, 100)])):
        local = mod.group_aggregate([("k", b["k"])], specs(mod, b, aggs),
                                    n_rows, ranges, 128)
        assert sorted(_rows(local), key=_key) == sorted(_rows(got),
                                                        key=_key)

    # the sorting path: 100 groups, ~2.5 rows a group on a shard, 10 % NULL
    jb, tb, _ = _agg_batches(7, 2000, 100)
    aggs = (("min", "x"),)
    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {"k": tb["k"]}, specs(t_hashagg, tb, aggs), 2000,
        [(0, 99)], 128)
    ref = j_agg.distributed_group_aggregate(
        j_mesh, ["k"], {"k": jb["k"]}, specs(j_hashagg, jb, aggs), 2000,
        [(0, 99)], 128)
    local = t_hashagg.group_aggregate([("k", tb["k"])],
                                      specs(t_hashagg, tb, aggs), 2000,
                                      [(0, 99)], 128)
    assert_same_rows(got, local)
    assert dict(_rows(ref))[33] == 0 and dict(_rows(got))[33] == 125


def test_global_count_star_counts_every_row_c18(j_mesh, t_mesh):
    """C18: count(*) alone over 2,000 rows.  The JAX package's constant key
    has 128 rows, so it counts at most 128 a shard (1,024); the port counts
    2,000."""
    got = t_agg.distributed_global_aggregate(
        t_mesh, [t_hashagg.AggSpec("count_star", None, "c")], 2000)
    ref = j_agg.distributed_global_aggregate(
        j_mesh, [j_hashagg.AggSpec("count_star", None, "c")], 2000)
    assert _rows(got) == [(2000,)]
    assert _rows(ref) == [(1024,)]


# ------------------------------------------------------------------ joins


def _join_batches(seed, np_rows=1500, nb_rows=600, cap_p=2048, cap_b=1024,
                  unique=True):
    rng = np.random.RandomState(seed)

    def pad(a, cap, dtype=np.int64):
        out = np.zeros(cap, dtype)
        out[:len(a)] = a
        return out

    pk = rng.randint(0, 900, np_rows)
    bk = rng.permutation(1000)[:nb_rows] if unique \
        else rng.randint(0, 700, nb_rows)
    probe = {"pk": (pad(pk, cap_p), None, "bigint"),
             "pv": (pad(np.arange(np_rows), cap_p), None, "bigint"),
             "pf": (pad(rng.normal(size=np_rows), cap_p, np.float64),
                    pad(rng.rand(np_rows) > 0.1, cap_p, bool), "double")}
    build = {"bk": (pad(bk, cap_b), None, "bigint"),
             "bv": (pad(rng.randint(0, 1500, nb_rows), cap_b), None,
                    "bigint"),
             "bd": (pad(rng.randint(0, 10**6, nb_rows), cap_b),
                    pad(rng.rand(nb_rows) > 0.2, cap_b, bool),
                    "decimal(10,2)")}
    jp, tp = both_batches(probe, num_rows=np_rows)
    jb, tb = both_batches(build, num_rows=nb_rows)
    return jp, tp, jb, tb


def _residual(I):
    return I.call("<", I.ColumnRef("pv", I.BIGINT), I.ColumnRef("bv",
                                                                 I.BIGINT))


_J = type("J", (), {"call": staticmethod(j_ir.call),
                    "ColumnRef": j_ir.ColumnRef, "BIGINT": j_types.BIGINT})
_T = type("T", (), {"call": staticmethod(t_ir.call),
                    "ColumnRef": t_ir.ColumnRef, "BIGINT": t_types.BIGINT})

_KINDS = [("inner", False, False), ("inner", True, False),
          ("inner", False, True), ("semi", False, False),
          ("semi", True, False), ("anti", False, False),
          ("anti", True, False), ("left", False, False),
          ("left", False, True)]
_IDS = [f"{k}{'-residual' if r else ''}{'-unique' if u else ''}"
        for k, r, u in _KINDS]


def _fanout(kind, unique):
    """Output rows a probe row may need, as ``Engine.sql_distributed``
    sizes a shard's join capacity."""
    return 1 if unique or kind in ("semi", "anti") else 4


def _quotas(jp, jb, np_rows, nb_rows):
    pw = np.asarray(j_dj.route_word(jp, ["pk"], [(0, 999)], np_rows))
    bw = np.asarray(j_dj.route_word(jb, ["bk"], [(0, 999)], nb_rows))
    pq = t_dj.exchange_quota(pw, np_rows, N,
                             t_dj.prep_shard_rows(jp.capacity(), N))
    bq = t_dj.exchange_quota(bw, nb_rows, N,
                             t_dj.prep_shard_rows(jb.capacity(), N))
    return round_capacity(max(pq, 128)), round_capacity(max(bq, 128))


@pytest.mark.parametrize("kind,residual,unique", _KINDS, ids=_IDS)
def test_repartitioned_join_matches_the_reference(j_mesh, t_mesh, kind,
                                                  residual, unique):
    np_rows, nb_rows = 1500, 600
    jp, tp, jb, tb = _join_batches(11, unique=unique)
    quotas = _quotas(jp, jb, np_rows, nb_rows)
    cap = round_capacity(N * quotas[0] * _fanout(kind, unique))
    ranges = [(0, 999)]
    want = j_dj.distributed_hash_join(
        j_mesh, jp, jb, ["pk"], ["bk"], kind, ranges, quotas, cap,
        residual=_residual(_J) if residual else None, build_unique=unique)
    got = t_dj.distributed_hash_join(
        t_mesh, tp, tb, ["pk"], ["bk"], kind, ranges, quotas, cap,
        residual=_residual(_T) if residual else None, build_unique=unique)
    assert_same_rows(got, want)
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], kind, ranges, 8192,
                             residual=_residual(_T) if residual else None,
                             build_unique=unique)
    assert_same_rows(got, local)


@pytest.mark.parametrize("kind,residual,unique", _KINDS, ids=_IDS)
def test_broadcast_join_matches_the_reference(j_mesh, t_mesh, kind,
                                              residual, unique):
    jp, tp, jb, tb = _join_batches(12, unique=unique)
    cap = round_capacity(max(t_dj.prep_shard_rows(jp.capacity(), N)
                             * _fanout(kind, unique), 128))
    ranges = [(0, 999)]
    want = j_dj.broadcast_hash_join(
        j_mesh, jp, jb, ["pk"], ["bk"], kind, ranges, cap,
        residual=_residual(_J) if residual else None, build_unique=unique)
    got = t_dj.broadcast_hash_join(
        t_mesh, tp, tb, ["pk"], ["bk"], kind, ranges, cap,
        residual=_residual(_T) if residual else None, build_unique=unique)
    assert_same_rows(got, want)


@pytest.mark.parametrize("kind,residual,unique",
                         [("semi", True, False), ("anti", True, False),
                          ("left", False, True)],
                         ids=["semi-residual", "anti-residual",
                              "left-unique"])
def test_a_shard_result_narrower_than_its_capacity_c21(j_mesh, t_mesh, kind,
                                                       residual, unique):
    """C21: a semi or anti join with a residual, and the N:1 LEFT lookup,
    answer a shard's result at its probe capacity (256 rows here), not at
    ``local_capacity``.  The JAX package's ``_stitch`` strides the shards'
    results by ``local_capacity`` (2,048), so it reads zeros for every
    shard but the first; the port concatenates each shard's live rows
    whatever their capacity and equals the single-device join."""
    jp, tp, jb, tb = _join_batches(12, unique=unique)
    ranges = [(0, 999)]
    want = j_dj.broadcast_hash_join(
        j_mesh, jp, jb, ["pk"], ["bk"], kind, ranges, 2048,
        residual=_residual(_J) if residual else None, build_unique=unique)
    got = t_dj.broadcast_hash_join(
        t_mesh, tp, tb, ["pk"], ["bk"], kind, ranges, 2048,
        residual=_residual(_T) if residual else None, build_unique=unique)
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], kind, ranges, 8192,
                             residual=_residual(_T) if residual else None,
                             build_unique=unique)
    assert_same_rows(got, local)
    assert int(want.num_rows) == int(local.num_rows)
    shard0 = set(range(256))
    ref_pv = _rows(want.select(["pv"]))
    assert {v for (v,) in ref_pv} - shard0 == set()
    assert ref_pv.count((0,)) > 1


def test_join_capacity_error_names_what_a_shard_needs(t_mesh):
    jp, tp, jb, tb = _join_batches(13, unique=False)
    with pytest.raises(t_dj.JoinCapacityError) as e:
        t_dj.broadcast_hash_join(t_mesh, tp, tb, ["pk"], ["bk"], "inner",
                                 [(0, 999)], 128)
    got = t_dj.broadcast_hash_join(t_mesh, tp, tb, ["pk"], ["bk"], "inner",
                                   [(0, 999)], round_capacity(e.value.needed))
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], "inner", [(0, 999)],
                             8192)
    assert_same_rows(got, local)


def test_exchange_overflow_raises(j_mesh, t_mesh):
    """Rows beyond a src->dst quota raise in both packages, never vanish."""
    np_rows, nb_rows = 2000, 1000
    spec_p = {"pk": (np.full(np_rows, 7, np.int64), None, "bigint"),
              "pv": (np.arange(np_rows), None, "bigint")}
    spec_b = {"bk": (np.arange(nb_rows), None, "bigint"),
              "bv": (np.arange(nb_rows) * 10, None, "bigint")}
    jp, tp = both_batches(spec_p)
    jb, tb = both_batches(spec_b)
    for mod, mesh, p, b in ((j_dj, j_mesh, jp, jb), (t_dj, t_mesh, tp, tb)):
        with pytest.raises(RuntimeError, match="exchange overflow"):
            mod.distributed_hash_join(mesh, p, b, ["pk"], ["bk"], "inner",
                                      [(0, 1500)], (64, 64), 2048)


# ----------------------------------------------------------------- top-N


@pytest.mark.parametrize("k", [1, 10, 300])
def test_topn_matches_the_reference(j_mesh, t_mesh, k):
    n_rows = 1800
    rng = np.random.RandomState(k)
    spec = {"a": (np.round(rng.normal(size=2048), 1),
                  rng.rand(2048) > 0.1, "double"),
            "b": (rng.randint(-20, 20, 2048), None, "bigint"),
            "v": (np.arange(2048), None, "bigint")}
    jb, tb = both_batches(spec, num_rows=n_rows)
    orders = [(False, None), (True, None)]
    want = j_distributed.distributed_topn(j_mesh, jb, ["a", "b"], orders, k)
    got = t_distributed.distributed_topn(t_mesh, tb, ["a", "b"], orders, k)
    # each shard's candidates: its first min(k, 256) rows in order, the
    # last shard holding 1800 - 7 * 256 = 8 live rows
    per = min(k, 256)
    assert int(got.num_rows) == int(want.num_rows) == 7 * per + min(per, 8)
    assert_same_rows(got, want)


# ------------------------------------------------------------------ skew


def _skew_single(seed):
    rng = np.random.RandomState(seed)
    np_rows = 2048
    pk = np.where(rng.rand(np_rows) < 0.6, 7,
                  rng.randint(0, 500, np_rows)).astype(np.int64)
    bk = np.arange(500, dtype=np.int64)
    probe = {"pk": (pk, None, "bigint"),
             "pv": (np.arange(np_rows), None, "bigint")}
    build = {"bk": (bk, None, "bigint"), "bv": (bk * 10, None, "bigint")}
    return probe, build, ["pk"], ["bk"], [(0, 500)], None


def _skew_multi(seed):
    rng = np.random.RandomState(seed)
    np_rows = 2048
    hot = rng.rand(np_rows) < 0.6
    k1 = np.where(hot, 7, rng.randint(0, 60, np_rows)).astype(np.int64)
    k2 = np.where(hot, 3, rng.randint(0, 8, np_rows)).astype(np.int64)
    probe = {"p1": (k1, None, "bigint"), "p2": (k2, None, "bigint"),
             "pv": (np.arange(np_rows), None, "bigint")}
    build = {"b1": (np.repeat(np.arange(60, dtype=np.int64), 8), None,
                    "bigint"),
             "b2": (np.tile(np.arange(8, dtype=np.int64), 60), None,
                    "bigint"),
             "bv": (np.arange(480), None, "bigint")}
    return probe, build, ["p1", "p2"], ["b1", "b2"], [(0, 60), (0, 8)], \
        _residual


@pytest.mark.parametrize("case", [_skew_single, _skew_multi],
                         ids=["single", "multi_key_residual"])
def test_skew_aware_join_matches_the_reference(j_mesh, t_mesh, case):
    probe, build, pkeys, bkeys, ranges, residual = case(9)
    jp, tp = both_batches(probe)
    jb, tb = both_batches(build)
    pw = np.asarray(j_dj.route_word(jp, pkeys, ranges, jp.num_rows))
    bw = np.asarray(j_dj.route_word(jb, bkeys, ranges, jb.num_rows))
    np.testing.assert_array_equal(
        t_dj.route_word(tp, pkeys, ranges, tp.num_rows).numpy(), pw)
    hot = t_skew.detect_hot_keys(pw, jp.num_rows, N)
    np.testing.assert_array_equal(
        hot, j_skew.detect_hot_keys(pw, jp.num_rows, N))
    assert hot.size == 1
    want = j_skew.skew_aware_join(
        j_mesh, jp, jb, pkeys, bkeys, ranges, hot, pw, bw,
        residual=residual(_J) if residual else None)
    got = t_skew.skew_aware_join(
        t_mesh, tp, tb, pkeys, bkeys, ranges, hot, pw, bw,
        residual=residual(_T) if residual else None)
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert_same_rows(got, want)


def test_skew_cold_half_retries_its_capacity_c16(j_mesh, t_mesh):
    """C16: a hot key (55 % of the probe rows) sends the join down the
    hybrid path; a cold key with 40 % of the rows meets four build rows, so
    its shard's cold output (3,010 rows) outgrows the cold half's capacity
    (twice the cold rows).  The JAX package raises JoinCapacityError; the
    port retries at the capacity the error names and equals the
    single-device join."""
    rng = np.random.RandomState(2)
    r = rng.rand(2048)
    pk = np.where(r < 0.55, 7, np.where(r < 0.95, 11,
                                        rng.randint(20, 500, 2048)))
    bk = np.concatenate([np.arange(500), [11, 11, 11]])
    probe = {"pk": (pk.astype(np.int64), None, "bigint"),
             "pv": (np.arange(2048), None, "bigint")}
    build = {"bk": (bk.astype(np.int64), None, "bigint"),
             "bv": (np.arange(len(bk)), None, "bigint")}
    jp, tp = both_batches(probe)
    jb, tb = both_batches(build)
    ranges = [(0, 500)]
    pw = np.asarray(j_dj.route_word(jp, ["pk"], ranges, 2048))
    bw = np.asarray(j_dj.route_word(jb, ["bk"], ranges, len(bk)))
    hot = t_skew.detect_hot_keys(pw, 2048, N)
    with pytest.raises(j_dj.JoinCapacityError):
        j_skew.skew_aware_join(j_mesh, jp, jb, "pk", "bk", ranges, hot, pw,
                               bw)
    got = t_skew.skew_aware_join(t_mesh, tp, tb, "pk", "bk", ranges, hot,
                                 pw, bw)
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], "inner", ranges, 8192)
    assert int(got.num_rows) == int(local.num_rows) == 4295
    assert_same_rows(got, local)


# ----------------------------------------------------------------- steps


def test_dryrun_q1_matches_the_reference(j_mesh, t_mesh):
    want = j_distributed.dryrun_q1(j_mesh)
    got = t_distributed.dryrun_q1(t_mesh)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the single-device step on the same rows
    single = t_distributed.distributed_q1_step(None, 8)(
        *(torch.from_numpy(v) for v in
          t_distributed.dryrun_q1_columns(256 * N).values()), 256 * N)
    np.testing.assert_array_equal(single["count_order"].numpy(),
                                  np.asarray(want["count_order"]))


def test_dryrun_join_matches_the_reference(j_mesh, t_mesh):
    assert t_distributed.dryrun_join(t_mesh) == \
        j_distributed.dryrun_join(j_mesh)
    assert t_distributed.dryrun_join(t_mesh)[1] == N * 256
