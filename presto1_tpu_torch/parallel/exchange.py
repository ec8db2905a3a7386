"""Distributed exchange: hash repartitioning over a mesh of shards.

The replacement for the reference's HTTP page shuffle
(``operator/PartitionedOutputOperator.java:406`` partition loop +
``operator/ExchangeClient.java:56`` pull protocol + ``PagesSerde`` wire
format): rows are routed by key hash, packed into static ``[n, quota]``
send slots, and the transfer is an all-to-all.  No serde (fixed-width
columns), no token/ack protocol, no backpressure machinery (static quotas
per src->dst pair, sized by the planner's discovery pass).

The JAX package runs this inside ``shard_map`` with ``jax.lax.all_to_all``.
Here a mesh is a list of shards (``distributed.Mesh``), every argument that
differs by shard is a list in shard order, and the all-to-all is the
transpose of the stacked ``[n_src, n_dst, quota]`` send buffers: shard ``d``
receives the blocks ``send[s][d]`` in ``s`` order, moved by
``Tensor.to(device)`` (no copy when both shards live on one card) and laid
out ``[n * quota]`` by the dynamic-copy kernel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..batch import take_clamped
from ..ops.common import iota
from ..ops.kernels.dyncopy import concat_rows
from ..ops.kernels.gather import gather_rows

# golden-ratio multiplicative-hash constant, as signed int64
_MIX = int(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))


def partition_of(key: torch.Tensor, n: int) -> torch.Tensor:
    """Destination shard for each row: multiplicative hash of the key
    (int64 product wrapping, arithmetic shift, floor modulo -- the JAX
    package's and ``dist_join.exchange_quota``'s arithmetic).

    (The reference's LocalPartitionGenerator / raw-hash routing,
    ``operator/PartitionedLookupSource.java:144``.)"""
    h = (key.to(torch.int64) * _MIX) >> 33
    return torch.remainder(h, n).to(torch.int32)


def _pack(arrays: Dict[str, torch.Tensor], key: torch.Tensor, num_valid,
          n: int, quota: int):
    """One shard's send side: its rows in a stable order by destination,
    the first ``quota`` rows of each destination in ``[n * quota]`` slots
    (zeros past a destination's count).  Returns (packed arrays, packed
    key, per-destination counts [n], dropped rows, 0-d)."""
    dev = key.device
    cap = key.shape[0]
    live = iota(cap, dev) < num_valid
    dest = torch.where(live, partition_of(key, n), n)  # dead rows: nowhere
    dest_sorted, order = torch.sort(dest, stable=True)
    start = torch.searchsorted(
        dest_sorted, torch.arange(n + 1, dtype=torch.int32, device=dev))
    raw_counts = start[1:] - start[:-1]
    counts = torch.clamp(raw_counts, max=quota)
    dropped = torch.sum(raw_counts - counts)
    slot = torch.arange(quota, dtype=torch.int64, device=dev)
    slot_src = (start[:n, None] + slot[None, :]).reshape(-1)  # [n*quota]
    slot_ok = (slot[None, :] < counts[:, None]).reshape(-1)
    # the reference's jnp.take(..., mode="clip"): both gathers clamp
    slot_row = take_clamped(order, slot_src)
    names = list(arrays)
    packed = gather_rows([arrays[k].contiguous() for k in names]
                         + [key.contiguous()], slot_row)

    def zeroed(buf: torch.Tensor) -> torch.Tensor:
        ok = slot_ok if buf.dim() == 1 else slot_ok[:, None]
        return torch.where(ok, buf, torch.zeros((), dtype=buf.dtype,
                                                device=dev))

    packed = [zeroed(b) for b in packed]
    return dict(zip(names, packed[:-1])), packed[-1], counts, dropped


def all_to_all_by_key(
    arrays: Sequence[Dict[str, torch.Tensor]],
    key: Sequence[torch.Tensor],
    num_valid: Sequence,
    mesh,
    quota: int,
) -> Tuple[List[Dict[str, torch.Tensor]], List[torch.Tensor],
           List[torch.Tensor], List[torch.Tensor]]:
    """Repartition every shard's rows so equal keys land on the same shard.

    ``arrays``, ``key`` and ``num_valid`` hold one entry a shard (shard
    order).  Every shard packs its rows into an ``[n, quota]`` send buffer
    (quota = max rows per src->dst pair, sized by the discovery pass) and
    one all-to-all moves everything.

    Rows beyond a src->dst quota cannot be sent in a static-shape buffer;
    they are counted, NOT silently dropped: the fourth return value holds
    each shard's dropped-row count (a 0-d tensor on its device), and
    callers must check it on the host (raise, or retry with a larger quota)
    before trusting the result.

    Returns, per shard: received arrays flattened to ``[n*quota]``, the
    received key, the valid-row mask and the dropped-row count.
    """
    n = mesh.size
    sent = [_pack(arrays[s], key[s], num_valid[s], n, quota)
            for s in range(n)]
    names = list(arrays[0])
    recv, recv_key, valid = [], [], []
    for d, dev in enumerate(mesh.devices):
        def block(t: torch.Tensor) -> torch.Tensor:
            return t[d * quota:(d + 1) * quota].to(dev, non_blocking=True)

        columns = [[block(sent[s][0][name]) for s in range(n)]
                   for name in names]
        columns.append([block(sent[s][1]) for s in range(n)])
        full = torch.full((n,), quota, dtype=torch.int64, device=dev)
        moved = concat_rows(columns, full, n * quota)
        recv.append(dict(zip(names, moved[:-1])))
        recv_key.append(moved[-1])
        recv_counts = torch.stack([sent[s][2][d].to(dev, non_blocking=True)
                                   for s in range(n)])
        slot = torch.arange(quota, dtype=torch.int64, device=dev)
        valid.append((slot[None, :] < recv_counts[:, None]).reshape(-1))
    return recv, recv_key, valid, [s[3] for s in sent]
