"""The scatter family's and the dense group aggregate's CUDA kernels on a
card, against their plain versions, ``torch.nonzero`` and ``torch.bincount``:
exact.  Every test here is marked ``cuda`` and skips without a card.  The
file imports nothing of the JAX package, so that it runs on a machine that
has none: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_scatter_dense_on_card.py``.  The plans and the plain
versions are CPU-tested in ``test_torch_kernel_paths.py``.
"""

import numpy as np
import pytest
import torch

from presto1_tpu_torch.ops.kernels import dense_group_agg as D
from presto1_tpu_torch.ops.kernels import scatter as S


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["int", "general"])
def test_dense_paths_match_plain_on_card(card, path):
    """Each path of ``dense_group_agg`` that takes an integer recipe equals
    the plain version exactly, views off the 16-byte grid included."""
    rng = np.random.RandomState(11)
    n = 100_003
    word = _t(rng.randint(-1, 14, n)).to(card)
    cols = [_t(rng.randint(-2 ** 62, 2 ** 62, n)).to(card),
            _t(rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32))
            .to(card), _t(rng.rand(n) > 0.5).to(card)]
    valid = _t(rng.rand(n) > 0.3).to(card)
    slots = [("sum", 0, None), ("low", 0, valid), ("high", 0, None),
             ("min", 1, None), ("max", 0, valid), ("sum", 2, None),
             ("count", None, valid)]
    for lo in (0, 1):
        w = word[lo:]
        cs = [c[lo:] for c in cols]
        ss = [(op, c, None if v is None else v[lo:]) for op, c, v in slots]
        got = D._dense_group_agg(w, 13, cs, ss, path)
        want = D.dense_group_agg_plain(w, 13, cs, ss)
        assert torch.equal(got.counts, want.counts)
        assert torch.equal(got.first_row, want.first_row)
        for k in range(len(ss)):
            assert torch.equal(got.slot(k), want.slot(k))


@pytest.mark.cuda
def test_histogram_path_matches_bincount_on_card(card):
    rng = np.random.RandomState(12)
    for dt in (np.int32, np.int64):
        v = _t(rng.randint(0, 256, 1 << 20).astype(dt)).to(card)
        for lo in (0, 1, 3):
            got = D.dense_group_agg(v[lo:], 256, [], [])
            assert torch.equal(got.counts,
                               torch.bincount(v[lo:], minlength=256))
            want = D.dense_group_agg_plain(v[lo:], 256, [], [])
            assert torch.equal(got.first_row, want.first_row)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.036, 1.0])
def test_compact_matches_nonzero_on_card(card, density):
    rng = np.random.RandomState(13)
    full = _t(rng.rand(1_000_019) < density).to(card)
    for lo in (0, 5):
        m = full[lo:]
        want = torch.nonzero(m)[:, 0]
        for capacity in (0, want.shape[0] // 2, want.shape[0] + 33):
            idx, count = S.compact(m, capacity)
            live = min(capacity, want.shape[0])
            assert int(count) == want.shape[0]
            assert torch.equal(idx[:live], want[:live])
            assert not bool(idx[live:].any())


@pytest.mark.cuda
def test_compact_bodies_match_nonzero_on_card(card):
    """The look-back against ``torch.nonzero``: views off the 16-byte grid,
    capacities below and above the count, and the outputs of a replayed
    CUDA graph (each captured call zeroes its own state)."""
    rng = np.random.RandomState(15)
    full = _t(rng.rand(2_000_019) < 0.036).to(card)
    for lo in (0, 5):
        m = full[lo:]
        want = torch.nonzero(m)[:, 0]
        for capacity in (0, want.shape[0] // 2, want.shape[0] + 33):
            idx, count = S.compact(m, capacity)
            live = min(capacity, want.shape[0])
            assert int(count) == want.shape[0]
            assert torch.equal(idx[:live], want[:live])
            assert not bool(idx[live:].any())
    graph, outs = torch.cuda.CUDAGraph(), []
    S.compact(full, 99_999)
    with torch.cuda.graph(graph):
        for _ in range(5):
            outs.append(S.compact(full, 99_999))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    want_idx, want_count = S.compact_plain(full, 99_999)
    for idx, count in outs:
        assert torch.equal(idx, want_idx) and torch.equal(count, want_count)


@pytest.mark.cuda
def test_compact_graphs_captured_twice_replay_apart(card):
    """Two graphs captured on one capture stream, the first never replayed
    before the second is captured and replayed, then both replayed on two
    streams at once: each answers its own mask (no state is shared)."""
    rng = np.random.RandomState(16)
    masks = [_t(rng.rand(3_000_017) < d).to(card) for d in (0.036, 0.5)]
    for m in masks:
        S.compact(m, 7)
    torch.cuda.synchronize()
    graphs, outs = [], []
    for m in masks:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append([S.compact(m, m.shape[0]) for _ in range(3)])
    graphs[1].replay()
    streams = [torch.cuda.Stream() for _ in graphs]
    torch.cuda.synchronize()
    for _ in range(3):
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
    torch.cuda.synchronize()
    for m, got in zip(masks, outs):
        want_idx, want_count = S.compact_plain(m, m.shape[0])
        for idx, count in got:
            assert torch.equal(idx, want_idx)
            assert torch.equal(count, want_count)


@pytest.mark.cuda
def test_scatter_columns_match_plain_on_card(card):
    rng = np.random.RandomState(14)
    n = 300_007
    perm = _t(rng.permutation(n)).to(card)
    mask = _t(rng.rand(n) > 0.96).to(card)
    xs = [perm.to(torch.int32), perm, perm.to(torch.float64)]
    got = S.scatter_distinct(perm, xs, n, mask)
    want = S.scatter_distinct_plain(perm, xs, n, mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
