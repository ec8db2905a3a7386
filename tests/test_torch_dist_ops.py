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

The JAX package's mesh operators run in a child process of the test process
(``ReferenceProcess``: one a module, kept alive, asked for one answer at a
time).  A test builds its numpy inputs once and sends them, with the
scalar arguments, to a ``_ref_*`` adapter there, which makes the JAX
package's batches of them and calls the operator.  Their
collectives on the 8-virtual-device CPU mesh can deadlock under load, and
XLA then aborts the process after its 40 s rendezvous timeout (ROADMAP C0):
the abort now ends that child, which is started again and asked again,
never the test process.  Every comparison is the one the test made before.
"""

import os
import pickle
import select
import subprocess
import sys
import tempfile
import warnings

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

# the child's loop: read (function name, arguments), answer (status, value)
_CHILD = r"""
import importlib, os, pickle, sys
sys.path.insert(0, sys.argv[1])
out = os.fdopen(os.dup(1), "wb")
os.dup2(2, 1)  # anything the child prints goes to its log, not the pipe
import conftest  # the test session's JAX setup: 8 virtual CPU devices
module = importlib.import_module(sys.argv[2])
while True:
    try:
        name, args = pickle.load(sys.stdin.buffer)
    except EOFError:
        break
    try:
        reply = ("ok", module._portable(getattr(module, name)(*args)))
    except Exception as e:
        reply = ("raised", type(e).__name__, str(e))
    pickle.dump(reply, out)
    out.flush()
"""

# what XLA writes before it aborts a deadlocked collective (C0)
_C0_ABORT = "Termination timeout for `all reduce"


class ReferenceRaised(Exception):
    """The JAX package's function raised ``type_name``: ``message``."""

    def __init__(self, type_name, message):
        super().__init__(f"{type_name}: {message}")
        self.type_name, self.message = type_name, message


class ReferenceProcess:
    """A child process that runs the ``_ref_*`` functions of a test module
    (the JAX package's mesh operators) one request at a time: ``ref(name,
    *args)`` answers ``_ref_<name>(*args)`` run there, ``args`` pickled.  A child that
    XLA aborted for a deadlocked collective (C0) is started again and the
    request asked again, at most ``attempts`` times; any other death of the
    child, or an answer slower than ``timeout_s``, fails the test."""

    def __init__(self, module: str, attempts: int = 3,
                 timeout_s: float = 300.0):
        self.module, self.attempts, self.timeout_s = module, attempts, \
            timeout_s
        self.proc = None
        self.log = None
        self.aborts = 0

    def _start(self):
        tests = os.path.dirname(os.path.abspath(__file__))
        self.log = tempfile.TemporaryFile()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(tests)]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, tests, self.module],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.log, env=env)

    def _log_text(self) -> str:
        self.log.seek(0)
        return self.log.read().decode(errors="replace")

    def close(self):
        if self.proc is not None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
            self.proc.stdout.close()
            self.log.close()
            self.proc = None

    def __call__(self, name, *args):
        for _ in range(self.attempts):
            if self.proc is None or self.proc.poll() is not None:
                if self.proc is not None:
                    self.proc.stdout.close()
                    self.log.close()
                self._start()
            pickle.dump((f"_ref_{name}", args), self.proc.stdin)
            self.proc.stdin.flush()
            ready, _, _ = select.select([self.proc.stdout], [], [],
                                        self.timeout_s)
            if not ready:
                self.proc.kill()
                self.proc.wait(timeout=30)
                raise AssertionError(f"the reference process gave no answer "
                                     f"to {name} in {self.timeout_s} s")
            try:
                reply = pickle.load(self.proc.stdout)
            except EOFError:
                self.proc.wait(timeout=30)
                text = self._log_text()
                if _C0_ABORT not in text:
                    raise AssertionError(
                        f"the reference process died on {name} "
                        f"(exit {self.proc.returncode}):\n{text[-3000:]}")
                self.aborts += 1  # ROADMAP C0: ask a new child again
                warnings.warn(f"C0: XLA aborted the reference process on "
                              f"{name}; asking a new one")
                continue
            if reply[0] == "raised":
                raise ReferenceRaised(reply[1], reply[2])
            return _unportable(reply[1])
        raise AssertionError(f"XLA aborted the reference process on "
                             f"{name} {self.attempts} times")


def _portable(x):
    """A reference answer as plain data: a batch as the JAX package's page
    bytes (``exec/pages.py``, which the port reads back), arrays as numpy."""
    from presto1_tpu.batch import RecordBatch as JBatch
    from presto1_tpu.exec.pages import serialize_batch

    if isinstance(x, JBatch):
        return ("batch", serialize_batch(x))
    if isinstance(x, dict):
        return {k: _portable(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_portable(v) for v in x)
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def _unportable(x):
    """``_portable``'s data back: a batch as the port's batch on the CPU."""
    from presto1_tpu_torch.exec.pages import deserialize_batch

    if isinstance(x, tuple) and len(x) == 2 and x[0] == "batch" \
            and isinstance(x[1], bytes):
        return deserialize_batch(x[1])
    if isinstance(x, dict):
        return {k: _unportable(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_unportable(v) for v in x)
    return x


_J_MESH = []


def _j_mesh():
    """The JAX package's 8-device mesh (made in the reference process)."""
    if not _J_MESH:
        assert len(jax.devices()) >= N, "need 8 virtual devices (conftest)"
        _J_MESH.append(j_distributed.make_mesh(N))
    return _J_MESH[0]


@pytest.fixture(scope="module")
def ref():
    proc = ReferenceProcess("test_torch_dist_ops")
    yield proc
    proc.close()


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


def _agg_inputs(seed, n_rows, key_hi, cap=2048):
    """(spec, mask): the batch's numpy columns and a row mask."""
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
    return spec, pad(rng.rand(n_rows) > 0.3, bool)


# min and max over columns without NULLs: over a nullable one the JAX
# package's answer is wrong (C17, below)
_AGGS = (("sum", "x"), ("count", "x"), ("count_star", None), ("min", "d"),
         ("max", "f"), ("avg", "x"), ("sum", "f"), ("avg", "d"),
         ("sum", "d"), ("max", "d"))


def _specs(mod, batch, aggs=_AGGS):
    return [mod.AggSpec(fn, None if a is None else batch[a], f"a{i}")
            for i, (fn, a) in enumerate(aggs)]


def _ref_group_aggregate(spec, n_rows, keys, cols, aggs, ranges, max_groups,
                         mask=None, carry_names=()):
    jb, _ = both_batches(spec, num_rows=n_rows)
    return j_agg.distributed_group_aggregate(
        _j_mesh(), keys, {c: jb[c] for c in cols}, _specs(j_hashagg, jb, aggs),
        n_rows, ranges, max_groups,
        mask=None if mask is None else jnp.asarray(mask),
        carry_names=list(carry_names))


def _ref_global_aggregate(spec, n_rows, aggs, mask=None):
    jb = both_batches(spec, num_rows=n_rows)[0] if spec else None
    return j_agg.distributed_global_aggregate(
        _j_mesh(), _specs(j_hashagg, jb, aggs), n_rows,
        mask=None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("key_hi", [3, 100], ids=["dense", "sorting"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("carry", [False, True], ids=["keys", "carry"])
def test_group_aggregate_matches_the_reference(ref, t_mesh, key_hi,
                                               masked, carry):
    n_rows = 2000
    spec, mask = _agg_inputs(7, n_rows, key_hi)
    _, tb = both_batches(spec, num_rows=n_rows)
    mask = mask if masked else None
    ranges = [(0, key_hi - 1)]
    max_groups = round_capacity(key_hi)
    cols = ["k", "c"] if carry else ["k"]
    carry_names = ["c"] if carry else []
    want = ref("group_aggregate", spec, n_rows, ["k"], cols, _AGGS, ranges,
               max_groups, mask, carry_names)
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {c: tb[c] for c in cols}, _specs(t_hashagg, tb),
        n_rows, ranges, max_groups, mask=t_mask, carry_names=carry_names)
    assert list(got.columns) == list(want.columns)
    for name in got.columns:
        assert str(got[name].type) == str(want[name].type), name
    assert_same_rows(got, want)
    # and the port's single-device operator
    local = t_hashagg.group_aggregate(
        [("k", tb["k"])], _specs(t_hashagg, tb), n_rows, ranges,
        max_groups, mask=t_mask, carry=[("c", tb["c"])] if carry else ())
    assert_same_rows(got, local)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_global_aggregate_matches_the_reference(ref, t_mesh, masked):
    n_rows = 1900
    spec, mask = _agg_inputs(8, n_rows, 5)
    _, tb = both_batches(spec, num_rows=n_rows)
    mask = mask if masked else None
    want = ref("global_aggregate", spec, n_rows, _AGGS, mask)
    got = t_agg.distributed_global_aggregate(
        t_mesh, _specs(t_hashagg, tb), n_rows,
        mask=None if mask is None else torch.from_numpy(mask))
    assert int(got.num_rows) == 1
    assert_same_rows(got, want)


def test_a_null_partial_stays_null_c17(ref, t_mesh):
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
    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {"k": tb["k"]}, _specs(t_hashagg, tb, aggs), n_rows,
        [(0, 1)], 128)
    want = ref("group_aggregate", spec, n_rows, ["k"], ["k"], aggs, [(0, 1)],
               128)
    s = int(x[1024:].sum())
    assert sorted(_rows(got), key=_key) == [
        (0, None, None, None, 0), (1, s, 1124, 2147, 1024)]
    assert sorted(_rows(want), key=_key)[0] == (
        0, 0, np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0)
    # (the JAX package's dense single-device path has a defect of its own
    # here, C20: its sorting path is held instead)
    for mod, b, ranges in ((t_hashagg, tb, [(0, 1)]),
                           (j_hashagg, jb, [(0, 100)])):
        local = mod.group_aggregate([("k", b["k"])], _specs(mod, b, aggs),
                                    n_rows, ranges, 128)
        assert sorted(_rows(local), key=_key) == sorted(_rows(got),
                                                        key=_key)

    # the sorting path: 100 groups, ~2.5 rows a group on a shard, 10 % NULL
    spec, _ = _agg_inputs(7, 2000, 100)
    _, tb = both_batches(spec, num_rows=2000)
    aggs = (("min", "x"),)
    got = t_agg.distributed_group_aggregate(
        t_mesh, ["k"], {"k": tb["k"]}, _specs(t_hashagg, tb, aggs), 2000,
        [(0, 99)], 128)
    want = ref("group_aggregate", spec, 2000, ["k"], ["k"], aggs, [(0, 99)],
               128)
    local = t_hashagg.group_aggregate([("k", tb["k"])],
                                      _specs(t_hashagg, tb, aggs), 2000,
                                      [(0, 99)], 128)
    assert_same_rows(got, local)
    assert dict(_rows(want))[33] == 0 and dict(_rows(got))[33] == 125


def test_global_count_star_counts_every_row_c18(ref, t_mesh):
    """C18: count(*) alone over 2,000 rows.  The JAX package's constant key
    has 128 rows, so it counts at most 128 a shard (1,024); the port counts
    2,000."""
    aggs = (("count_star", None),)
    got = t_agg.distributed_global_aggregate(
        t_mesh, _specs(t_hashagg, None, aggs), 2000)
    assert _rows(got) == [(2000,)]
    assert _rows(ref("global_aggregate", None, 2000, aggs)) == [(1024,)]


# ------------------------------------------------------------------ joins


def _join_inputs(seed, np_rows=1500, nb_rows=600, cap_p=2048, cap_b=1024,
                 unique=True):
    """(probe spec, its rows, build spec, its rows)."""
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
    return probe, np_rows, build, nb_rows


def _both_sides(probe, np_rows, build, nb_rows):
    """(JAX probe, port probe, JAX build, port build)."""
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


def _ref_join(fn, inputs, args, residual=False, unique=False):
    """The JAX package's ``dist_join.<fn>(mesh, probe, build, *args)`` on
    the batches of ``inputs`` (``_join_inputs``' layout)."""
    jp, _, jb, _ = _both_sides(*inputs)
    return getattr(j_dj, fn)(
        _j_mesh(), jp, jb, *args,
        residual=_residual(_J) if residual else None, build_unique=unique)


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
def test_repartitioned_join_matches_the_reference(ref, t_mesh, kind,
                                                  residual, unique):
    inputs = _join_inputs(11, unique=unique)
    jp, tp, jb, tb = _both_sides(*inputs)
    quotas = _quotas(jp, jb, inputs[1], inputs[3])
    cap = round_capacity(N * quotas[0] * _fanout(kind, unique))
    ranges = [(0, 999)]
    want = ref("join", "distributed_hash_join", inputs,
               (["pk"], ["bk"], kind, ranges, quotas, cap), residual, unique)
    got = t_dj.distributed_hash_join(
        t_mesh, tp, tb, ["pk"], ["bk"], kind, ranges, quotas, cap,
        residual=_residual(_T) if residual else None, build_unique=unique)
    assert_same_rows(got, want)
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], kind, ranges, 8192,
                             residual=_residual(_T) if residual else None,
                             build_unique=unique)
    assert_same_rows(got, local)


@pytest.mark.parametrize("kind,residual,unique", _KINDS, ids=_IDS)
def test_broadcast_join_matches_the_reference(ref, t_mesh, kind,
                                              residual, unique):
    inputs = _join_inputs(12, unique=unique)
    jp, tp, jb, tb = _both_sides(*inputs)
    cap = round_capacity(max(t_dj.prep_shard_rows(jp.capacity(), N)
                             * _fanout(kind, unique), 128))
    ranges = [(0, 999)]
    want = ref("join", "broadcast_hash_join", inputs,
               (["pk"], ["bk"], kind, ranges, cap), residual, unique)
    got = t_dj.broadcast_hash_join(
        t_mesh, tp, tb, ["pk"], ["bk"], kind, ranges, cap,
        residual=_residual(_T) if residual else None, build_unique=unique)
    assert_same_rows(got, want)


@pytest.mark.parametrize("kind,residual,unique",
                         [("semi", True, False), ("anti", True, False),
                          ("left", False, True)],
                         ids=["semi-residual", "anti-residual",
                              "left-unique"])
def test_a_shard_result_narrower_than_its_capacity_c21(ref, t_mesh, kind,
                                                       residual, unique):
    """C21: a semi or anti join with a residual, and the N:1 LEFT lookup,
    answer a shard's result at its probe capacity (256 rows here), not at
    ``local_capacity``.  The JAX package's ``_stitch`` strides the shards'
    results by ``local_capacity`` (2,048), so it reads zeros for every
    shard but the first; the port concatenates each shard's live rows
    whatever their capacity and equals the single-device join."""
    inputs = _join_inputs(12, unique=unique)
    _, tp, _, tb = _both_sides(*inputs)
    ranges = [(0, 999)]
    want = ref("join", "broadcast_hash_join", inputs,
               (["pk"], ["bk"], kind, ranges, 2048), residual, unique)
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
    _, tp, _, tb = _both_sides(*_join_inputs(13, unique=False))
    with pytest.raises(t_dj.JoinCapacityError) as e:
        t_dj.broadcast_hash_join(t_mesh, tp, tb, ["pk"], ["bk"], "inner",
                                 [(0, 999)], 128)
    got = t_dj.broadcast_hash_join(t_mesh, tp, tb, ["pk"], ["bk"], "inner",
                                   [(0, 999)], round_capacity(e.value.needed))
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], "inner", [(0, 999)],
                             8192)
    assert_same_rows(got, local)


def test_exchange_overflow_raises(ref, t_mesh):
    """Rows beyond a src->dst quota raise in both packages, never vanish."""
    np_rows, nb_rows = 2000, 1000
    probe = {"pk": (np.full(np_rows, 7, np.int64), None, "bigint"),
             "pv": (np.arange(np_rows), None, "bigint")}
    build = {"bk": (np.arange(nb_rows), None, "bigint"),
             "bv": (np.arange(nb_rows) * 10, None, "bigint")}
    inputs = (probe, np_rows, build, nb_rows)
    _, tp, _, tb = _both_sides(*inputs)
    args = (["pk"], ["bk"], "inner", [(0, 1500)], (64, 64), 2048)
    with pytest.raises(ReferenceRaised) as e:
        ref("join", "distributed_hash_join", inputs, args)
    assert e.value.type_name == "RuntimeError"
    assert "exchange overflow" in e.value.message
    with pytest.raises(RuntimeError, match="exchange overflow"):
        t_dj.distributed_hash_join(t_mesh, tp, tb, *args)


# ----------------------------------------------------------------- top-N


def _ref_topn(spec, num_rows, keys, orders, k):
    jb, _ = both_batches(spec, num_rows=num_rows)
    return j_distributed.distributed_topn(_j_mesh(), jb, keys, orders, k)


@pytest.mark.parametrize("k", [1, 10, 300])
def test_topn_matches_the_reference(ref, t_mesh, k):
    rng = np.random.RandomState(k)
    spec = {"a": (np.round(rng.normal(size=2048), 1),
                  rng.rand(2048) > 0.1, "double"),
            "b": (rng.randint(-20, 20, 2048), None, "bigint"),
            "v": (np.arange(2048), None, "bigint")}
    _, tb = both_batches(spec, num_rows=1800)
    orders = [(False, None), (True, None)]
    want = ref("topn", spec, 1800, ["a", "b"], orders, k)
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
    return probe, build, ["pk"], ["bk"], [(0, 500)], False


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
    return probe, build, ["p1", "p2"], ["b1", "b2"], [(0, 60), (0, 8)], True


def _ref_skew_join(probe, build, pkeys, bkeys, ranges, hot, pw, bw,
                   residual):
    jp, _ = both_batches(probe)
    jb, _ = both_batches(build)
    return j_skew.skew_aware_join(
        _j_mesh(), jp, jb, pkeys, bkeys, ranges, hot, pw, bw,
        residual=_residual(_J) if residual else None)


@pytest.mark.parametrize("case", [_skew_single, _skew_multi],
                         ids=["single", "multi_key_residual"])
def test_skew_aware_join_matches_the_reference(ref, t_mesh, case):
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
    want = ref("skew_join", probe, build, pkeys, bkeys, ranges, hot, pw, bw,
               residual)
    got = t_skew.skew_aware_join(
        t_mesh, tp, tb, pkeys, bkeys, ranges, hot, pw, bw,
        residual=_residual(_T) if residual else None)
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert_same_rows(got, want)


def test_skew_cold_half_retries_its_capacity_c16(ref, t_mesh):
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
    with pytest.raises(ReferenceRaised) as e:
        ref("skew_join", probe, build, "pk", "bk", ranges, hot, pw, bw,
            False)
    assert e.value.type_name == j_dj.JoinCapacityError.__name__
    got = t_skew.skew_aware_join(t_mesh, tp, tb, "pk", "bk", ranges, hot,
                                 pw, bw)
    local = t_join.hash_join(tp, tb, ["pk"], ["bk"], "inner", ranges, 8192)
    assert int(got.num_rows) == int(local.num_rows) == 4295
    assert_same_rows(got, local)


# ----------------------------------------------------------------- steps


def _ref_dryrun(name):
    return getattr(j_distributed, f"dryrun_{name}")(_j_mesh())


def test_dryrun_q1_matches_the_reference(ref, t_mesh):
    want = ref("dryrun", "q1")
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


def test_dryrun_join_matches_the_reference(ref, t_mesh):
    assert t_distributed.dryrun_join(t_mesh) == ref("dryrun", "join")
    assert t_distributed.dryrun_join(t_mesh)[1] == N * 256
