"""Distributed query steps: SPMD plan fragments over a mesh of shards.

Where the reference schedules N identical tasks per stage and shuffles
pages over HTTP (``execution/SqlStageExecution.java:384``,
``SystemPartitioningHandle`` FIXED_HASH_DISTRIBUTION), here a stage is one
plain function called once for each shard of a :class:`Mesh`, in shard
order (the JAX package's ``shard_map`` step; ``jax.lax.axis_index`` is the
loop index):

* source stages read row-sharded table columns (splits become shard rows),
* FIXED_HASH exchanges are ``all_to_all_by_key`` (exchange.py),
* broadcast distribution is a replicated column (one per shard),
* partial->final aggregation is a local dense aggregate per shard and a
  sum over shards (the JAX package's ``psum``), or a key repartition and a
  local final.

A mesh is n logical shards, each on a torch device: by default all on one
card, so an exchange moves no byte between devices.  The functions here are
building blocks used by ``Engine.sql_distributed`` and by
``entry.dryrun_multichip``.

The JAX package caches each stage's compiled XLA program on a structural
signature (``cached_program``, ``_STAGE_PROGRAMS``).  Eager torch compiles
nothing, so there is no such cache here, nor its signature functions.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Sequence

import numpy as np
import torch

from ..ops.common import iota
from ..ops.kernels.dense_group_agg import dense_group_agg
from ..ops.kernels.dyncopy import MAX_PARTS
from ..ops.kernels.gather import gather_rows
from .exchange import all_to_all_by_key


class Mesh:
    """n logical shards and the torch device each one lives on."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        # the receive side of an exchange concatenates one block a shard
        # in one launch of the dynamic-copy kernel
        if not 1 <= len(self.devices) <= MAX_PARTS:
            raise ValueError(f"a mesh holds 1 to {MAX_PARTS} shards, not "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards: all on ``device``, or on the first
    ``n_devices`` of a list of devices."""
    if isinstance(device, (list, tuple)):
        if len(device) < n_devices:
            raise ValueError(f"{n_devices} shards, {len(device)} devices")
        return Mesh(device[:n_devices])
    return Mesh([device] * n_devices)


def shard_rows(mesh: Mesh, arr: torch.Tensor) -> List[torch.Tensor]:
    """``arr`` split by rows into equal shards, one on each shard's
    device."""
    n = mesh.size
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split into {n} "
                         f"equal shards")
    rows = arr.shape[0] // n
    return [arr[s * rows:(s + 1) * rows].to(dev, non_blocking=True)
            for s, dev in enumerate(mesh.devices)]


def replicate(mesh: Mesh, arr) -> list:
    """``arr`` on every shard's device (a Python value as it is)."""
    if not isinstance(arr, torch.Tensor):
        return [arr] * mesh.size
    return [arr.to(dev, non_blocking=True) for dev in mesh.devices]


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one tensor a shard, on the first shard's device."""
    dev = parts[0].device
    return reduce(torch.add, [p.to(dev, non_blocking=True) for p in parts])


# ---------------------------------------------------------------- aggregate


def local_dense_group_sums(gids, num_groups: int,
                           values: List[torch.Tensor], mask):
    """Per-shard partial aggregation into a dense [num_groups] table, one
    pass of the ``dense_group_agg`` kernel.  gids must be globally
    consistent (e.g. packed key words); num_groups at most 256."""
    word = torch.where(mask, gids, num_groups).contiguous()
    agg = dense_group_agg(word, num_groups,
                          [v.contiguous() for v in values],
                          [("sum", k, None) for k in range(len(values))])
    return [agg.slot(k) for k in range(len(values))], agg.counts


def distributed_q1_step(mesh, num_groups: int):
    """The flagship fragment: TPC-H Q1 as one SPMD step.

    Per shard: predicate mask -> dense group ids from the packed flag pair
    -> partial dense sums -> a sum over the shards (the FIXED_HASH exchange
    for a tiny group domain degenerates to an all-reduce, exactly as the
    reference's partial->final aggregation exchange would with 6 groups).
    ``mesh=None`` gives the single-device variant (tensors, no shards);
    with a mesh every argument is a list of one value a shard.
    """

    def local(returnflag, linestatus, qty, price, disc, tax, shipdate,
              num_valid):
        live = iota(returnflag.shape[0], returnflag.device) < num_valid
        mask = live & (shipdate <= 10471)  # 1998-09-02
        gids = (returnflag.to(torch.int64) * 2
                + linestatus.to(torch.int64))
        disc_price = price * (100 - disc)          # scale 4
        charge = disc_price * (100 + tax)          # scale 6 (limb-split sum)
        lo = charge & 0xFFFFFFFF
        hi = charge >> 32
        return local_dense_group_sums(
            gids, num_groups, [qty, price, disc_price, lo, hi, disc], mask)

    def finish(sums, counts):
        sq, sp, sdp, clo, chi, sdisc = sums
        charge_f = (chi.to(torch.float64) * 4294967296.0
                    + clo.to(torch.float64))
        cnt = torch.clamp(counts, min=1)
        return {
            "sum_qty": sq, "sum_base_price": sp, "sum_disc_price": sdp,
            "sum_charge": charge_f,
            "avg_qty": sq.to(torch.float64) / (cnt * 100),
            "avg_price": sp.to(torch.float64) / (cnt * 100),
            "avg_disc": sdisc.to(torch.float64) / (cnt * 100),
            "count_order": counts,
        }

    if mesh is None:
        def step(*args):
            return finish(*local(*args))

        return step

    def step(*sharded):
        parts = [local(*(a[s] for a in sharded)) for s in range(mesh.size)]
        # partial -> final: the dense tables summed over the shards
        sums = [psum([p[0][k] for p in parts]) for k in range(6)]
        return finish(sums, psum([p[1] for p in parts]))

    return step


def distributed_join_agg_step(mesh: Mesh, quota: int, build_cap: int):
    """A repartitioned join fragment: both sides exchanged by key
    (FIXED_HASH), then a local sorted-probe join and partial aggregation.

    The shape of TPC-H Q3/Q5-style stages: shuffle lineitem and orders by
    orderkey, join locally, aggregate partially, reduce.  Every argument
    is a list of one value a shard.
    """
    sent = torch.iinfo(torch.int64).max

    def step(l_key, l_val, l_valid, o_key, o_val, o_valid):
        larr, lkey, lmask, _ldrop = all_to_all_by_key(
            [{"val": v} for v in l_val], l_key, l_valid, mesh, quota)
        oarr, okey, omask, _odrop = all_to_all_by_key(
            [{"val": v} for v in o_val], o_key, o_valid, mesh, quota)
        totals, rows = [], []
        for s in range(mesh.size):
            # local join: sort the build side, searchsorted probe
            # (ops/join.py design)
            bk = torch.where(omask[s], okey[s], sent)
            bk_sorted, order = torch.sort(bk, stable=True)
            (bval_sorted,) = gather_rows([oarr[s]["val"]], order)
            pk = torch.where(lmask[s], lkey[s], -1)
            lo = torch.searchsorted(bk_sorted, pk)
            hi = torch.searchsorted(bk_sorted, pk, right=True)
            matched = (hi > lo) & lmask[s]
            bpos = torch.clamp(lo, 0, build_cap - 1)
            (bval,) = gather_rows([bval_sorted], bpos)
            joined = torch.where(matched, larr[s]["val"] + bval, 0)
            totals.append(torch.sum(joined))
            rows.append(torch.sum(matched.to(torch.int64)))
        return psum(totals), psum(rows)

    return step


def dryrun_q1_columns(cap: int) -> dict:
    """``dryrun_q1``'s host columns over ``cap`` rows (the JAX package's
    seeded numpy inputs)."""
    rng = np.random.RandomState(0)
    return dict(
        returnflag=rng.randint(0, 3, cap).astype(np.int64),
        linestatus=rng.randint(0, 2, cap).astype(np.int64),
        qty=rng.randint(100, 5000, cap).astype(np.int64),
        price=rng.randint(90000, 200000, cap).astype(np.int64),
        disc=rng.randint(0, 11, cap).astype(np.int64),
        tax=rng.randint(0, 9, cap).astype(np.int64),
        shipdate=rng.randint(8000, 10600, cap).astype(np.int64),
    )


def dryrun_join_columns(cap: int) -> dict:
    """``dryrun_join``'s host columns over ``cap`` rows."""
    rng = np.random.RandomState(1)
    return dict(l_key=rng.randint(0, cap, cap).astype(np.int64),
                l_val=rng.randint(0, 100, cap).astype(np.int64),
                o_key=np.arange(cap, dtype=np.int64),
                o_val=rng.randint(0, 100, cap).astype(np.int64))


def dryrun_q1(mesh: Mesh, rows_per_shard: int = 256):
    """Run the Q1 SPMD step over the mesh on seeded columns (the JAX
    package's numpy inputs: ``np.random.RandomState(0)``)."""
    cols = dryrun_q1_columns(rows_per_shard * mesh.size)
    dev = mesh.devices[0]
    sharded = {k: shard_rows(mesh, torch.from_numpy(v).to(dev))
               for k, v in cols.items()}
    step = distributed_q1_step(mesh, num_groups=8)
    return step(sharded["returnflag"], sharded["linestatus"],
                sharded["qty"], sharded["price"], sharded["disc"],
                sharded["tax"], sharded["shipdate"],
                replicate(mesh, rows_per_shard))


def dryrun_join(mesh: Mesh, rows_per_shard: int = 256):
    """Run the repartitioned-join step over the mesh on seeded columns
    (``np.random.RandomState(1)``); returns (sum of joined values, joined
    rows)."""
    n = mesh.size
    cols = dryrun_join_columns(rows_per_shard * n)
    dev = mesh.devices[0]
    sh = {k: shard_rows(mesh, torch.from_numpy(v).to(dev))
          for k, v in cols.items()}
    quota = rows_per_shard * 2
    step = distributed_join_agg_step(mesh, quota, build_cap=n * quota)
    nv = replicate(mesh, rows_per_shard)
    total, rows = step(sh["l_key"], sh["l_val"], nv, sh["o_key"],
                       sh["o_val"], nv)
    total, rows = torch.stack([total, rows]).tolist()
    return int(total), int(rows)


# ---------------------------------------------------------------- top-N


def distributed_topn(mesh: Mesh, batch, key_names, orders, k: int):
    """Distributed TopN on the mesh: each shard sorts its row slice and
    keeps its local top-k; the union of candidates (``n * k`` rows --
    tiny) goes back to the caller for the final local sort.  The mesh
    analog of the reference's per-worker ``TopNOperator`` + single merge
    node (``operator/TopNOperator.java:37``, ``docs/.../dist-sort.rst``);
    every shard's candidate set provably contains any global top-k row.
    """
    from ..ops.sort import SortKey, sort_batch
    from .dist_join import _prep, _rebuild, _rows_on_shard, _stitch

    arrays, meta, vnames, rows = _prep(mesh, batch)
    kk = max(1, min(int(k), int(rows)))
    outs = []
    for s in range(mesh.size):
        b = _rebuild(arrays[s], meta, vnames, None,
                     _rows_on_shard(batch.num_rows, s, rows))
        keys = [SortKey(b[nm], asc, nf)
                for nm, (asc, nf) in zip(key_names, orders)]
        outs.append(sort_batch(b, keys, limit=kk))
    return _stitch(mesh, outs, kk)
