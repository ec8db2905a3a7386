"""The redesigned dense group aggregate and scatter family: their launch
plans (pure Python, the same on every machine), and the plain versions their
wrappers run for CPU tensors against the JAX package's functions, on inputs
made with numpy from a seed.  Everything exact.

The CUDA kernels run only on a card: ``chip_smoke.py`` and the tests of
``test_torch_scatter_dense_on_card.py`` hold each path against these plain
versions there.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.ops.join as j_join
import presto1_tpu.ops.segments as j_seg
import presto1_tpu_torch.ops.join as t_join
import presto1_tpu_torch.ops.segments as t_seg
from presto1_tpu_torch.ops.kernels import _build
from presto1_tpu_torch.ops.kernels import dense_group_agg as D
from presto1_tpu_torch.ops.kernels import scatter as S

from torch_parity import assert_batches_equal, both_batches

torch.set_num_threads(1)

H100_SMS = 132
I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- compaction


@pytest.mark.parametrize("extra", [-3, 0, 100])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097])
@pytest.mark.parametrize("density", [0.0, 0.001, 0.036, 0.5, 1.0])
def test_compact_matches_reference(density, n, extra):
    """``compact_indices`` (the port's, through ``compact``'s plain version)
    against the JAX package's: the kept rows in order, zeros past the
    count, the untruncated count; capacity below, at and above the count."""
    rng = np.random.RandomState(int(density * 1000) + n)
    mask = rng.rand(n) < density
    capacity = max(int(mask.sum()) + extra, 0)
    j_idx, j_count = j_seg.compact_indices(jnp.asarray(mask), capacity)
    t_idx, t_count = t_seg.compact_indices(_t(mask), capacity)
    p_idx, p_count = S.compact(_t(mask), capacity)
    assert t_idx.dtype == torch.int64 and tuple(t_idx.shape) == (capacity,)
    assert t_count.dim() == 0 and t_count.dtype == torch.int64
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert int(t_count) == int(j_count) == int(mask.sum())
    assert torch.equal(p_idx, t_idx) and torch.equal(p_count, t_count)


def test_compact_of_a_view():
    """A mask that starts inside its storage (the kernel reads it from the
    16-byte boundary below) compacts like a copy of it."""
    rng = np.random.RandomState(5)
    full = _t(rng.rand(4133) < 0.3)
    for lo in (1, 7, 15):
        view = full[lo:lo + 4100]
        got = t_seg.compact_indices(view, 2000)
        want = j_seg.compact_indices(jnp.asarray(view.numpy()), 2000)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("bad", [
    lambda m: S.compact(m.to(torch.int32), 4),
    lambda m: S.compact(m[None], 4),
    lambda m: S.compact(m[::2], 4),
    lambda m: S.compact(m, -1),
])
def test_compact_rejects(bad):
    with pytest.raises((TypeError, ValueError)):
        bad(torch.ones(8, dtype=torch.bool))


# ------------------------------------------------ scatter of several columns


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [0, 1, 17, 777])
def test_scatter_columns_match_reference(n, idx_dtype):
    """One call with several value columns (mixed widths, as many as one
    launch takes) equals one call a column, and the JAX statement
    ``zeros.at[t].set(x, mode="drop")`` over the kept rows."""
    rng = np.random.RandomState(n)
    perm = rng.permutation(n).astype(idx_dtype) - 2  # two targets below 0
    mask = rng.rand(n) > 0.4
    size = max(n - 5, 1)  # and a few past the end
    xs = ([rng.randint(-1000, 1000, n).astype(dt) for dt in
           (np.int32, np.int64, np.float64)] * 3)[:S.MAX_COLUMNS]
    got = S.scatter_distinct(_t(perm), [_t(x) for x in xs], size, _t(mask))
    assert isinstance(got, list) and len(got) == len(xs)
    keep = mask & (perm >= 0) & (perm < size)
    target = jnp.asarray(np.where(keep, perm, size).astype(np.int64))
    for x, g in zip(xs, got):
        one = S.scatter_distinct(_t(perm), _t(x), size, _t(mask))
        assert torch.equal(g, one)
        want = jnp.zeros((size,), x.dtype).at[target].set(jnp.asarray(x),
                                                          mode="drop")
        assert g.numpy().dtype == x.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_scatter_columns_reject():
    i = torch.arange(8)
    with pytest.raises(ValueError):
        S.scatter_distinct(i, [], 8)
    with pytest.raises(ValueError):
        S.scatter_distinct(i, [i, i[:3]], 8)
    with pytest.raises(TypeError):
        S.scatter_distinct(i, [i, i.to(torch.float32)], 8)
    with pytest.raises(ValueError):  # more than one launch takes
        S.scatter_distinct(i, [i] * (S.MAX_COLUMNS + 1), 8)


@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_join_scatters_once(kind, seed, monkeypatch):
    """``merge_join`` compacts its build entries' key and origin in ONE
    scatter call of two columns, and still equals the JAX package's
    ``merge_join``."""
    rng = np.random.RandomState(seed)
    bk = rng.permutation(300)[:150] if kind == "inner" \
        else rng.randint(0, 300, 150)
    pk = rng.randint(0, 320, 600)
    cap = 640
    jp, tp = both_batches({"k": (np.r_[pk, np.zeros(cap - 600, np.int64)],
                                 None, "bigint"),
                           "pv": (np.arange(cap), None, "bigint")},
                          num_rows=600)
    jb, tb = both_batches({"bk": (np.r_[bk, np.zeros(106, np.int64)], None,
                                  "bigint"),
                           "bv": (np.arange(256), None, "bigint")},
                          num_rows=150)
    ranges = [(0, 320)]
    calls = []
    orig = t_join.scatter_distinct

    def spy(idx, x, size, mask=None):
        calls.append(x)
        return orig(idx, x, size, mask)

    monkeypatch.setattr(t_join, "scatter_distinct", spy)
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], kind, ranges, cap)
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], kind, ranges, cap)
    assert len(calls) == 1 and isinstance(calls[0], list) \
        and len(calls[0]) == 2
    assert_batches_equal(want, got, kind)


# ------------------------------------------------------------ launch plans


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 32_768,
                               32_769, 6_002_010, 2 ** 31 + 5])
@pytest.mark.parametrize("head", [0, 1, 15])
@pytest.mark.parametrize("sms", [1, H100_SMS])
def test_compact_route_covers_the_mask(n, head, sms):
    """The look-back's partition: tiles of THREADS * SPAN_WORDS words cover
    the mask, one block a tile up to the occupancy's blocks on every SM
    (on one SM, 7 blocks take every tile in turn)."""
    asked = []

    def occupancy():
        asked.append(1)
        return 7

    plan = S.compact_route(n, head, sms, occupancy)
    words = -(-(head + n) // S.LANE_ROWS)
    assert asked == [1]
    assert plan.tiles == -(-words // (S.THREADS * S.SPAN_WORDS))
    assert (plan.tiles - 1) * S.THREADS * S.SPAN_WORDS < words
    assert plan.blocks == min(plan.tiles, sms * 7) >= 1


@pytest.mark.parametrize("n", [1, 4097, 2 ** 20 - 1, 2 ** 20, 2_880_404,
                               6_002_010])
def test_compact_route_choice(n):
    """``compact`` plans the one look-back launch at every size the engine
    calls it at, and takes no other route."""
    occ = lambda: 8  # noqa: E731
    plan = S.compact_route(n, 0, H100_SMS, occ)
    assert plan == S.CompactPlan(min(plan.tiles, H100_SMS * 8), plan.tiles)
    with pytest.raises(TypeError):
        S.compact_route(n, 3, H100_SMS, occ, "lookback")


@pytest.mark.parametrize("head", range(16))
def test_compact_of_views_at_every_head_matches_reference(head):
    """A mask view starting ``head`` bytes past a 16-byte boundary, the
    capacity below, at and above the count and 0: the port's compaction
    (its plain version on the CPU) against the JAX package's."""
    rng = np.random.RandomState(head)
    full = rng.rand(4129 + 16) < 0.3
    view_host = full[head:head + 4129]
    view = _t(full)[head:head + 4129]
    assert view.data_ptr() % 16 == (_t(full).data_ptr() + head) % 16
    k = int(view_host.sum())
    for capacity in (0, k // 2, k, k + 7):
        j_idx, j_count = j_seg.compact_indices(jnp.asarray(view_host),
                                               capacity)
        p_idx, p_count = S.compact(view, capacity)
        np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
        assert int(p_count) == int(j_count) == k


@pytest.mark.parametrize("capacity", [0, 1, 9])
def test_compact_of_an_empty_mask_matches_reference(capacity):
    mask = np.zeros((0,), bool)
    j_idx, j_count = j_seg.compact_indices(jnp.asarray(mask), capacity)
    p_idx, p_count = S.compact(_t(mask), capacity)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    assert int(p_count) == int(j_count) == 0
    assert p_count.dim() == 0 and p_idx.dtype == torch.int64


class _FakeCompact:
    """Stands for the scatter library's compaction: records each launch,
    with whether its state read all zero when it began, carries the launch
    out on host memory from its arguments alone, and then leaves the state
    dirty, as the kernel leaves its ticket and flags."""

    def __init__(self):
        self.launches = []

    def p1_compact_blocks_per_sm(self):
        return 8

    def p1_compact_one(self, base, head, n, tiles, blocks, out, capacity,
                       count_out, state, stream):
        words = S.STATE_WORDS + tiles
        zero = not any(ctypes.string_at(state, 8 * words))
        self.launches.append({"tiles": tiles, "blocks": blocks,
                              "state": state, "count_out": count_out,
                              "zero": zero, "stream": stream})
        assert base % 16 == 0 and 0 <= head < 16
        mask = np.frombuffer(ctypes.string_at(base + head, n), np.uint8)
        rows = np.nonzero(mask)[0].astype(np.int64)
        got = np.zeros(capacity, np.int64)
        got[:min(capacity, rows.size)] = rows[:capacity]
        ctypes.memmove(out, got.ctypes.data, got.nbytes)
        ctypes.memmove(count_out, np.int64(rows.size).tobytes(), 8)
        ctypes.memset(state, 0xFF, 8 * words)
        return 0


@pytest.fixture
def fake_compact(monkeypatch):
    """``compact`` on ``_OnCuda`` tensors through ``_FakeCompact``, on
    stream 77 of a card of H100_SMS SMs."""
    lib = _FakeCompact()
    monkeypatch.setattr(S, "_library", lambda: lib)
    monkeypatch.setattr(S, "_OCCUPANCY", {})
    monkeypatch.setattr(_build, "launch_on", lambda dev, launch: launch(77))
    monkeypatch.setattr(_build, "sm_count", lambda dev: H100_SMS)
    return lib


@pytest.mark.parametrize("rows", [1, 4097, 70_013, 2 ** 20 + 5])
@pytest.mark.parametrize("capturing", [False, True])
def test_compact_is_one_launch_of_its_route(monkeypatch, fake_compact, rows,
                                            capturing):
    """On a CUDA tensor ``compact`` makes ONE launch of the look-back, the
    same inside a CUDA graph capture as outside one, and its result is the
    plain version's."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    rng = np.random.RandomState(5)
    full = rng.rand(rows + 3) < 0.3
    for lo in (0, 3):
        mask = _t(full).as_subclass(_OnCuda)[lo:lo + rows]
        want_idx, want_count = S.compact_plain(_t(full)[lo:lo + rows], 9000)
        before = S.COMPACT_LAUNCHES
        idx, count = S.compact(mask, 9000)
        assert S.COMPACT_LAUNCHES - before == 1
        assert torch.equal(idx.as_subclass(torch.Tensor), want_idx)
        assert int(count.as_subclass(torch.Tensor)) == int(want_count)
        plan = S.compact_route(rows, mask.data_ptr() % 16, H100_SMS,
                               lambda: 8)
        launch = fake_compact.launches[-1]
        assert (launch["tiles"], launch["blocks"]) == plan
        assert launch["zero"]
    assert len(fake_compact.launches) == 2
    assert {d["stream"] for d in fake_compact.launches} == {77}


@pytest.mark.parametrize("tiles", [1, 367, 4097])
@pytest.mark.parametrize("capturing", [False, True])
def test_compact_state_is_zeroed_and_its_own_per_call(monkeypatch,
                                                      fake_compact, tiles,
                                                      capturing):
    """Each call's look-back state reads all zero when its launch begins
    (the kernel leaves it dirty), holds ``STATE_WORDS`` words and a flag
    for each of the call's tiles, follows the count the call returns in
    one allocation, and overlaps no state or result of another call whose
    result is still alive: the same inside a capture as outside one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    n = tiles * S.THREADS * S.SPAN_WORDS * S.LANE_ROWS
    mask = torch.zeros(n, dtype=torch.bool)
    mask[::n // 5 + 1] = True
    mask = mask.as_subclass(_OnCuda)
    for _ in range(2):  # freed at once: the next call may get its memory
        S.compact(mask, 8)
    results = [S.compact(mask, 8) for _ in range(3)]
    assert all(d["zero"] for d in fake_compact.launches[:2])
    held = []
    for (idx, count), d in zip(results, fake_compact.launches[2:]):
        storage = count.untyped_storage()
        assert d["zero"] and d["tiles"] == tiles
        assert d["count_out"] == storage.data_ptr() == count.data_ptr()
        assert d["state"] == d["count_out"] + 8
        assert storage.nbytes() == 8 * (1 + S.STATE_WORDS + tiles)
        assert idx.as_subclass(torch.Tensor)[:5].tolist() == \
            list(range(0, n, n // 5 + 1))[:5]
        held += [(d["state"], storage.nbytes() - 8),
                 (idx.data_ptr(), 8 * idx.numel())]
    held.sort()
    assert all(a + size <= b for (a, size), (b, _) in zip(held, held[1:]))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 2 ** 23])
@pytest.mark.parametrize("head", [0, 1, 15])
def test_scatter_plan(n, head):
    """One warp step (512 rows) a warp at least; at most 8 blocks an SM."""
    blocks = S.scatter_plan(n, head, H100_SMS)
    steps = -(-(head + n) // S.WARP_ROWS)
    assert 1 <= blocks <= H100_SMS * 8
    assert blocks * (S.THREADS // 32) >= min(steps, H100_SMS * 64)
    assert blocks == 1 or (blocks - 1) * (S.THREADS // 32) < steps


Q1_SLOTS = [("sum", 0, None), ("sum", 1, None), ("low", 2, None),
            ("high", 2, None), ("low", 3, None), ("high", 3, None),
            ("low", 0, None), ("high", 0, None), ("low", 1, None),
            ("high", 1, None), ("low", 4, None), ("high", 4, None)]


def test_dense_plan_q1_takes_the_int_path():
    """TPC-H Q1's recipe (12 slots over 5 int64 columns, 12 groups): every
    slot plain, so a thread holds a table of 12 x 14 cells (1,344 B) and 2
    stage slots of 6 x 16 B (192 B): 144 threads, one block an SM."""
    plan = D.plan_dense(6_002_010, 12, [I64] * 5, Q1_SLOTS, H100_SMS)
    assert plan == D.DensePlan("int", 144, H100_SMS, 144 * 1536)
    assert plan.shared <= D.BLOCK_SHARED


@pytest.mark.parametrize("groups,slots,dtypes,path", [
    (256, [], [], "hist"),                              # the histogram
    (1, [], [], "hist"),
    (12, [("sum", 0, None)], [F64], "general"),         # a float64 slot
    (12, [("sum", 0, None), ("sum", 1, None)], [I64, F64], "general"),
    (12, [("min", 0, None)], [F64], "general"),
    (12, [("count", None, None)], [], "int"),          # counts only
    (12, [("sum", 0, 7), ("max", 1, 8)], [I32, BOOL], "int"),
    (32, [("sum", 0, None)] * 11, [I64], "int"),       # 64 threads
    (32, [("sum", 0, None)] * 12, [I64], "general"),   # too few
    (1, [("sum", 0, None)] * 64, [I64], "int"),        # any slot count
    (1, [("count", None, None)] * 5, [], "int"),
    (256, [("sum", 0, None)], [I64], "general"),       # 37: too few
    (1, [("sum", c, None) for c in range(6)], [I64] * 6, "int"),
    (1, [("sum", c, None) for c in range(7)], [I64] * 7, "general"),
    (1, [("sum", c, c) for c in range(3)], [I64] * 3, "int"),
    (1, [("sum", c, c) for c in range(4)], [I64] * 4, "general"),
    (1, [("sum", 0, 7)] * 7, [I64], "int"),            # one validity
])
def test_dense_plan_path(groups, slots, dtypes, path):
    """Which recipe takes which path: integer-only recipes of at most 8
    distinct value and validity columns whose thread tables leave room for
    64 threads take ``int``; no slot, ``hist``; the rest ``general``."""
    plan = D.plan_dense(1000, groups, dtypes, slots, H100_SMS)
    assert plan.path == path
    assert plan.shared <= D.BLOCK_SHARED


def test_dense_plan_shared_memory_never_exceeds_a_block():
    """Every plan the wrapper can make, at every group count and slot count
    the kernel takes, for integer and float64 recipes: within the 232,448
    bytes of dynamic shared memory a block may use, and the threads a
    block a multiple of 16 (32 but on the int path)."""
    for groups in (1, 2, 12, 13, 32, 33, 100, 255, 256):
        for k in (0, 1, 2, 5, 12, 13, 17, 31, 32, 33, 64):
            for dt in (I64, F64):
                slots = [("sum", 0, None)] * k
                for n in (1, 17, 2 ** 23):
                    plan = D.plan_dense(n, groups, [dt], slots, H100_SMS)
                    assert plan.shared <= D.BLOCK_SHARED, (groups, k, dt)
                    assert plan.threads % (16 if plan.path == "int"
                                           else 32) == 0
                    assert plan.threads >= 32
                    assert 1 <= plan.blocks <= H100_SMS * 8
                    if k == 0:
                        assert plan.path == "hist"
                    elif dt == F64:
                        assert plan.path == "general"


@pytest.mark.parametrize("path,slots,dtypes", [
    ("int", [("sum", 0, None)], [F64]),
    ("int", [("sum", 0, None), ("max", 1, None)], [I64, F64]),
    ("int", [], []),
    ("hist", [("sum", 0, None)], [I64]),
])
def test_dense_plan_refuses_a_path_the_recipe_cannot_take(path, slots,
                                                          dtypes):
    with pytest.raises(ValueError):
        D.plan_dense(100, 12, dtypes, slots, H100_SMS, path)


def _source_constants(name):
    text = (Path(_build.CSRC) / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9]+);", text)}


def test_dense_geometry_matches_the_source():
    """The planner's copy of the kernel's layout constants is the source's
    (the library reports the same numbers on the card, where a mismatch
    raises before any launch)."""
    c = _source_constants("dense_group_agg")
    assert (D.BLOCK_SHARED, D.GENERAL_SHARED, D.GENERAL_MAX_THREADS,
            D.INT_COLUMNS, D.INT_STAGES, D.INT_PLAIN,
            D.HIST_THREADS) == (
        c["kBlockShared"], 200 * 1024, c["kMaxWarps"] * 32, c["kIntCols"],
        c["kStages"], c["kMaxPlain"], c["kHistMaxThreads"])
    text = (Path(_build.CSRC) / "dense_group_agg.cu").read_text()
    assert "kSharedBudget = 200 * 1024;" in text
    enum = re.search(r"enum Path \{([^}]*)\}", text).group(1)
    assert {k.lower(): int(v) for k, v in
            re.findall(r"kPath(\w+) = ([0-9]+)", enum)} == D.PATHS


def test_scatter_geometry_matches_the_source():
    c = _source_constants("scatter")
    assert (S.THREADS, S.LANE_ROWS, S.MAX_COLUMNS) == (
        c["kThreads"], c["kLaneRows"], c["kMaxCols"])
    assert (S.STATE_WORDS, S.SPAN_WORDS) == (c["kStateWords"],
                                             c["kSpanWords"])


def test_dense_plan_hist_rows_fit_32_bits():
    assert D.plan_dense(2 ** 32 - 2, 4, [], [], H100_SMS).path == "hist"
    assert D.plan_dense(2 ** 32 - 1, 4, [], [], H100_SMS).path == "general"


def test_sm_count_is_looked_up_once_per_device(monkeypatch):
    """The wrappers size their grids by ``_build.sm_count``, which asks the
    device once and then answers from its cache."""
    asked = []

    class Props:
        multi_processor_count = 132

    def props(index):
        asked.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(_build, "_SMS", {})
    dev = torch.device("cuda", 3)
    assert [_build.sm_count(dev) for _ in range(5)] == [132] * 5
    assert asked == [3]


# ------------------------------------------- a CUDA tensor never falls back


class _OnCuda(torch.Tensor):
    """A tensor that claims to lie on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("call", ["compact", "scatter_columns"])
def test_cuda_tensor_launches_or_raises(monkeypatch, call):
    """For a tensor on a CUDA device the compaction and the scatter of
    several columns go to the kernel and never to the plain versions: when
    the build fails they raise, and the launch counters do not move."""
    called = []

    def failing_load(lib):
        called.append(f"build:{lib}")
        raise _build.KernelBuildError("nvcc failed: injected")

    monkeypatch.setattr(_build, "load", failing_load)
    for plain in ("compact_plain", "scatter_distinct_plain"):
        monkeypatch.setattr(S, plain, lambda *a: called.append("plain"))
    mask = torch.ones(8, dtype=torch.bool).as_subclass(_OnCuda)
    fake = torch.arange(8).as_subclass(_OnCuda)
    before = (S.LAUNCHES, S.COMPACT_LAUNCHES)
    with pytest.raises(_build.KernelBuildError, match="injected"):
        if call == "compact":
            S.compact(mask, 8)
        else:
            S.scatter_distinct(fake, [fake, fake], 8, mask)
    assert called == ["build:scatter"]
    assert (S.LAUNCHES, S.COMPACT_LAUNCHES) == before
