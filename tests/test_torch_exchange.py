"""The port's hash exchange (``presto1_tpu_torch/parallel/exchange.py``)
against the JAX package's: ``partition_of`` against the plain ``jnp``
function and against ``exchange_quota``'s numpy, and ``all_to_all_by_key``
over 8 shards against the JAX function run inside ``shard_map`` over the
8-virtual-device CPU mesh (as ``tests/test_distributed.py`` runs it).
Received arrays, keys, the valid mask and the dropped-row counts equal
exactly, at a quota that fits and at quotas that drop rows.  The JAX
function runs in a child process (``ReferenceProcess`` of
``test_torch_dist_ops.py``: an XLA abort of a deadlocked collective, ROADMAP
C0, ends the child, never the test process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import presto1_tpu.parallel.dist_join as j_dist_join
import presto1_tpu.parallel.exchange as j_exchange
import presto1_tpu_torch.parallel.dist_join as t_dist_join
import presto1_tpu_torch.parallel.distributed as t_distributed
import presto1_tpu_torch.parallel.exchange as t_exchange

from test_torch_dist_ops import ReferenceProcess, _j_mesh, _portable  # noqa

torch.set_num_threads(1)

N = 8
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref():
    proc = ReferenceProcess("test_torch_exchange")
    yield proc
    proc.close()


@pytest.fixture(scope="module")
def t_mesh():
    return t_distributed.make_mesh(N, device="cpu")


def _keys(seed: int, n: int) -> np.ndarray:
    """Small keys, negative keys and keys near +-2^63."""
    rng = np.random.RandomState(seed)
    edge = np.array([0, 1, -1, I64.max, I64.min, I64.max - 1, I64.min + 1,
                     1 << 62, -(1 << 62), (1 << 33) - 1, -(1 << 33)],
                    np.int64)
    rand = rng.randint(I64.min, I64.max, n, dtype=np.int64)
    small = rng.randint(-40, 40, n).astype(np.int64)
    return np.concatenate([edge, rand, small])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13])
def test_partition_of_matches_the_reference(n):
    key = _keys(n, 500)
    want = np.asarray(j_exchange.partition_of(jnp.asarray(key), n))
    got = t_exchange.partition_of(torch.from_numpy(key), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("n", [2, 8])
def test_partition_of_matches_exchange_quota(n):
    """``exchange_quota``'s numpy hash sends each row where
    ``partition_of`` does: the histogram of (source shard, destination)
    taken from ``partition_of`` has the quota's maximum, and the
    reference's histogram (``np.add.at``) agrees."""
    key = _keys(10 + n, 3000)
    rows = len(key)
    shard = t_dist_join.prep_shard_rows(rows, n)
    dest = t_exchange.partition_of(torch.from_numpy(key), n).numpy()
    hist = np.zeros((n + 1, n), np.int64)
    np.add.at(hist, (np.arange(rows) // shard, dest), 1)
    quota = t_dist_join.exchange_quota(key, rows, n, shard)
    assert quota == hist.max()
    assert quota == j_dist_join.exchange_quota(key, rows, n, shard)
    assert t_dist_join.exchange_quota(key, 0, n, shard) == 0


def _inputs(seed: int, per: int):
    rng = np.random.RandomState(seed)
    cap = N * per
    key = np.where(rng.rand(cap) < 0.2, rng.randint(-5, 5, cap),
                   rng.randint(0, 37, cap)).astype(np.int64)
    arrays = {
        "v": np.arange(cap, dtype=np.int64) * 7 - 100,
        "f": rng.normal(size=cap),
        "b": rng.rand(cap) < 0.5,
        "m": rng.randint(-9, 9, (cap, 3)).astype(np.int32),
    }
    # each shard's own live-row count, some shards full, one empty
    num_valid = np.array([per, per - 5, 0, per // 2, per, 1, per - 1, per],
                         np.int64)
    return arrays, key, num_valid


def _ref_all_to_all(arrays, key, num_valid, quota):
    """The JAX package's ``all_to_all_by_key`` inside ``shard_map`` (run in
    the reference process)."""
    def step(arrs, key, nv):
        out, k, valid, dropped = j_exchange.all_to_all_by_key(
            arrs, key, nv[0], "d", quota)
        return out, k, valid, jnp.reshape(dropped, (1,))

    f = jax.jit(shard_map(
        step, mesh=_j_mesh(),
        in_specs=(dict.fromkeys(arrays, P("d")), P("d"), P("d")),
        out_specs=P("d")))
    out, k, valid, dropped = f(
        {n: jnp.asarray(a) for n, a in arrays.items()}, jnp.asarray(key),
        jnp.asarray(num_valid))
    return ({n: np.asarray(a) for n, a in out.items()}, np.asarray(k),
            np.asarray(valid), np.asarray(dropped))


def _port(t_mesh, arrays, key, num_valid, quota):
    per = len(key) // N
    shards = [{n: torch.from_numpy(a[s * per:(s + 1) * per])
               for n, a in arrays.items()} for s in range(N)]
    keys = t_distributed.shard_rows(t_mesh, torch.from_numpy(key))
    out, k, valid, dropped = t_exchange.all_to_all_by_key(
        shards, keys, [int(v) for v in num_valid], t_mesh, quota)
    return ({n: torch.cat([o[n] for o in out]).numpy() for n in arrays},
            torch.cat(k).numpy(), torch.cat(valid).numpy(),
            torch.stack(dropped).numpy())


def _over_quota(key, num_valid, per, quota) -> np.ndarray:
    """numpy: rows each shard cannot send (beyond quota per destination)."""
    dest = np.asarray(t_exchange.partition_of(torch.from_numpy(key), N))
    out = []
    for s in range(N):
        d = dest[s * per:s * per + num_valid[s]]
        c = np.bincount(d, minlength=N)
        out.append(int(np.maximum(c - quota, 0).sum()))
    return np.array(out)


def _flat(arrays):
    """The JAX package takes a 2-D array along its flattened axis
    (``jnp.take`` without an axis, exchange.py:80: ROADMAP C19), so it gets
    the matrix's columns as 1-D arrays; the port moves whole rows."""
    flat = {n: a for n, a in arrays.items() if a.ndim == 1}
    flat.update({f"m{j}": arrays["m"][:, j] for j in range(3)})
    return flat


@pytest.mark.parametrize("quota", [64, 5, 1])
def test_all_to_all_by_key_matches_the_reference(ref, t_mesh, quota):
    per = 64
    arrays, key, num_valid = _inputs(3, per)
    want = ref("all_to_all", _flat(arrays), key, num_valid, quota)
    got = _port(t_mesh, arrays, key, num_valid, quota)
    for j in range(3):
        np.testing.assert_array_equal(got[0]["m"][:, j], want[0][f"m{j}"])
    for name in arrays:
        if name == "m":
            continue
        assert got[0][name].dtype == want[0][name].dtype, name
        assert got[0][name].shape == (N * N * quota,)
        np.testing.assert_array_equal(got[0][name], want[0][name],
                                      err_msg=name)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3],
                                  _over_quota(key, num_valid, per, quota))
    if quota == 64:
        assert got[3].sum() == 0
        # every live row arrived once, at the shard its key names
        assert got[2].sum() == num_valid.sum()
        arrived = got[1].reshape(N, -1)
        ok = got[2].reshape(N, -1)
        for d in range(N):
            dest = t_exchange.partition_of(
                torch.from_numpy(arrived[d][ok[d]]), N).numpy()
            assert (dest == d).all()
        live = np.concatenate([np.arange(s * per, s * per + num_valid[s])
                               for s in range(N)])
        assert got[0]["v"][got[2]].sum() == arrays["v"][live].sum()
    else:
        assert got[3].sum() > 0


def test_mesh_of_listed_devices_and_its_limits():
    mesh = t_distributed.make_mesh(3, device=["cpu", "cpu", "cpu", "cpu"])
    assert mesh.size == 3 and all(d.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError):
        t_distributed.make_mesh(3, device=["cpu"])
    with pytest.raises(ValueError):
        t_distributed.make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        t_distributed.make_mesh(33, device="cpu")
    with pytest.raises(ValueError):
        t_distributed.shard_rows(mesh, torch.arange(10))
    parts = t_distributed.shard_rows(mesh, torch.arange(12))
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11]]
    assert t_distributed.replicate(mesh, 5) == [5, 5, 5]


def test_a_matrix_column_moves_whole_rows_c19(ref, t_mesh):
    """C19: the JAX package packs a 2-D array with ``jnp.take`` and no
    axis (``presto1_tpu/parallel/exchange.py:80``), which indexes the
    flattened matrix: a ``[rows, 3]`` column arrives as ``[n * quota]``
    single elements.  The port moves whole rows: ``[n * quota, 3]``, each
    row the one its key's row held."""
    per, quota = 64, 64
    arrays, key, num_valid = _inputs(3, per)
    want = ref("all_to_all", {"m": arrays["m"]}, key, num_valid, quota)
    assert want[0]["m"].shape == (N * N * quota,)
    got = _port(t_mesh, {"m": arrays["m"], "v": arrays["v"]}, key,
                num_valid, quota)
    assert got[0]["m"].shape == (N * N * quota, 3)
    rows = (got[0]["v"][got[2]] + 100) // 7  # the source row of each slot
    np.testing.assert_array_equal(got[0]["m"][got[2]], arrays["m"][rows])
