"""Skew detection and skew-resistant distributed join (mesh plane).

The reference has no automatic in-engine skew handling (SURVEY §2.8 --
cost model only); the north star requires it.  Design:

* **detect** -- the discovery pass already computes exact per-key
  histograms on the host (``exchange_quota``); keys whose probe-side row
  count exceeds ``threshold x fair_share`` are "hot".  Detection runs on
  the ROUTE WORD (the packed composite of every equi key -- the same word
  the exchange routes on), so any key arity is covered.
* **split** -- hot keys would overload one shard under hash routing, so
  the join splits: cold rows take the normal repartitioned path
  (``dist_join.distributed_hash_join``), hot probe rows STAY where they are
  and the (few) build rows for hot keys are **broadcast** -- the classic
  partitioned+broadcast hybrid.
* **merge** -- both halves use the same local join operator (residuals
  included: each candidate pair lives in exactly one half, so the
  residual evaluates once per pair); results concatenate.

The cold half starts from the JAX package's per-shard capacity (twice the
cold rows) and, like every repartitioned join of ``Engine.sql_distributed``,
retries at the capacity a ``JoinCapacityError`` names (ROADMAP C16: the JAX
package raises there).
"""

from __future__ import annotations

import numpy as np

from ..batch import RecordBatch, concat_batches, round_capacity, to_device
from ..ops.filter import compact
from .dist_join import (JoinCapacityError, _local_join,
                        distributed_hash_join, exchange_quota,
                        prep_shard_rows)


def detect_hot_keys(key_host: np.ndarray, n_rows: int, n_dev: int,
                    threshold: float = 4.0) -> np.ndarray:
    """Key words whose row count exceeds threshold x (n_rows / n_dev) --
    any one of them would make a shard's quota blow past fair share.
    ``key_host`` is the packed route word, so composite keys are one
    value here."""
    keys, counts = np.unique(key_host[:n_rows], return_counts=True)
    fair = max(n_rows / max(n_dev, 1), 1.0)
    return keys[counts > threshold * fair]


def _hot_rows(batch: RecordBatch, words: np.ndarray,
              hot_words: np.ndarray) -> np.ndarray:
    """Host mask over the batch's capacity: live rows whose word is hot."""
    n_rows = int(batch.num_rows)
    hot = np.zeros(batch.capacity(), bool)
    hot[:n_rows] = np.isin(words[:n_rows], hot_words)
    return hot


def _select(batch: RecordBatch, keep: np.ndarray) -> RecordBatch:
    """The rows where the host mask ``keep`` holds, compacted on the
    batch's device, with their count on the host."""
    n = int(keep.sum())
    dev = next(iter(batch.columns.values())).data.device
    out = compact(batch, to_device(keep, dev), round_capacity(max(n, 1)))
    return RecordBatch(out.columns, n)


def skew_aware_join(
    mesh,
    probe: RecordBatch,
    build: RecordBatch,
    probe_keys,
    build_keys,
    ranges,
    hot_words: np.ndarray,
    probe_words: np.ndarray,
    build_words: np.ndarray,
    residual=None,
    build_unique: bool = False,
) -> RecordBatch:
    """Inner join resilient to probe-side key skew (discovery-time
    hot-word list over the packed composite key).  Cold slice ->
    repartitioned mesh join; hot slice -> local probe x broadcast build.
    Multi-key and residual conditions ride both halves unchanged."""
    if isinstance(probe_keys, str):  # single-key callers (tests)
        probe_keys, build_keys = [probe_keys], [build_keys]
    n_dev = mesh.size
    n_rows = int(probe.num_rows)
    hot_p = _hot_rows(probe, probe_words, hot_words)
    hot_probe = _select(probe, hot_p)
    cold = _select(probe, (np.arange(len(hot_p)) < n_rows) & ~hot_p)
    hot_build = _select(build, _hot_rows(build, build_words, hot_words))
    n_hot, n_cold = hot_probe.num_rows, cold.num_rows

    # cold half: normal repartitioned mesh join (the cold probe slice
    # re-derives its quota -- the hot rows are exactly the ones that made
    # the original histogram spike)
    shard_rows = prep_shard_rows(cold.capacity(), n_dev)
    cold_words = probe_words[:n_rows][~hot_p[:n_rows]]
    pq = exchange_quota(cold_words, n_cold, n_dev, shard_rows)
    b_rows = int(build.num_rows)
    b_shard_rows = prep_shard_rows(build.capacity(), n_dev)
    bq = exchange_quota(build_words, b_rows, n_dev, b_shard_rows)
    local_cap = round_capacity(max(n_cold * 2, 128))
    while True:
        try:
            cold_out = distributed_hash_join(
                mesh, cold, build, list(probe_keys), list(build_keys),
                "inner", ranges,
                (round_capacity(max(pq, 128)), round_capacity(max(bq, 128))),
                local_cap, residual=residual, build_unique=build_unique)
            break
        except JoinCapacityError as e:
            local_cap = round_capacity(e.needed)

    # hot half: broadcast the (small) hot build slice; probe rows join
    # where they already live -- one local join, no shuffle of the hot rows
    # (at the capacity its candidate pairs need, where the JAX package
    # keeps four a hot row whatever they need)
    hot_cap = round_capacity(max(n_hot * 4, 128))
    while True:
        hot_out, need = _local_join(hot_probe, hot_build, probe_keys,
                                    build_keys, "inner", ranges, hot_cap,
                                    residual, build_unique)
        need = int(need)
        if need <= hot_cap:
            break
        hot_cap = round_capacity(need)

    hot_n = int(hot_out.num_rows)
    cold_n = int(cold_out.num_rows)
    cap = round_capacity(max(cold_n + hot_n, 1))
    cold_out = RecordBatch(cold_out.columns, cold_n)
    # align column sets (order may differ)
    hot_cols = {name: hot_out.columns[name] for name in cold_out.columns}
    return concat_batches(cold_out,
                          RecordBatch(hot_cols, hot_n), cap)
