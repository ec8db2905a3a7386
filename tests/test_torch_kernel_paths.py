"""The redesigned dense group aggregate and scatter family: their launch
plans (pure Python, the same on every machine), and the plain versions their
wrappers run for CPU tensors against the JAX package's functions, on inputs
made with numpy from a seed.  Everything exact.

The CUDA kernels run only on a card: ``chip_smoke.py`` and the tests marked
``cuda`` below hold each path against these plain versions there.
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


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 2 ** 23])
@pytest.mark.parametrize("head", [0, 1, 15])
@pytest.mark.parametrize("sms", [1, H100_SMS])
def test_compact_plan_covers_the_mask(n, head, sms):
    """The two compaction passes' partition: whole tiles, every 16-byte
    word of the mask in exactly one block, no empty block, at most 8
    blocks an SM."""
    blocks, chunk = S.compact_plan(n, head, sms)
    words = -(-(head + n) // S.LANE_ROWS)
    assert chunk % S.THREADS == 0 and chunk >= S.THREADS
    assert 1 <= blocks <= max(1, sms * 8)
    assert blocks * chunk >= words
    assert blocks == 1 or (blocks - 1) * chunk < words
    if n == 2 ** 23 and sms == H100_SMS:
        # 524,288 words (one more off the grid) in 2,048 tiles: two a block
        assert chunk == 2 * S.THREADS and blocks in (1024, 1025)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 32_768,
                               32_769, 6_002_010, 2 ** 31 + 5])
@pytest.mark.parametrize("head", [0, 1, 15])
def test_compact_route_covers_the_mask(n, head):
    """The look-back's partition: tiles of THREADS * SPAN_WORDS words cover
    the mask, one block a tile up to the occupancy's blocks on every SM."""
    asked = []

    def occupancy():
        asked.append(1)
        return 7

    plan = S.compact_route(n, head, H100_SMS, occupancy)
    words = -(-(head + n) // S.LANE_ROWS)
    assert plan.route == "lookback" and asked == [1]
    assert plan.tiles == -(-words // (S.THREADS * S.SPAN_WORDS))
    assert (plan.tiles - 1) * S.THREADS * S.SPAN_WORDS < words
    assert plan.blocks == min(plan.tiles, H100_SMS * 7) and plan.chunk == 0


@pytest.mark.parametrize("n,route", [
    (1, "lookback"), (4097, "lookback"), (2 ** 20 - 1, "lookback"),
    (2 ** 20, "lookback"), (2_880_404, "lookback"),
    (6_002_010, "lookback")])
def test_compact_route_choice(n, route):
    """``compact`` plans the look-back at every size; the two-pass body,
    asked for by name, keeps ``compact_plan``'s partition and asks no
    occupancy; an unknown route raises."""
    occ = lambda: 8  # noqa: E731
    plan = S.compact_route(n, 0, H100_SMS, occ)
    assert plan.route == route and plan.chunk == 0
    two = S.compact_route(n, 3, H100_SMS, lambda: 1 / 0, "two_pass")
    assert (two.route, two.tiles) == ("two_pass", 0)
    assert (two.blocks, two.chunk) == S.compact_plan(n, 3, H100_SMS)
    with pytest.raises(ValueError):
        S.compact_route(10, 0, H100_SMS, occ, "cooperative")


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


def test_compact_state_is_kept_per_device_and_stream(monkeypatch):
    """The look-back's state outside a graph capture: one zeroed buffer
    per (device, stream), reused call after call; a call with more tiles
    than it holds gets a larger one in its place."""
    monkeypatch.setattr(S, "_STATE", {})
    cpu = torch.device("cpu")
    a = S._state(cpu, 5, 10, False)
    assert a.dtype == torch.int64 and not bool(a.any())
    assert a.numel() == S.STATE_WORDS + S.MIN_STATE_TILES
    assert S._state(cpu, 5, S.MIN_STATE_TILES, False) is a
    b = S._state(cpu, 6, 10, False)
    assert b is not a
    c = S._state(cpu, 5, S.MIN_STATE_TILES + 1, False)
    assert c is not a and c.numel() == S.STATE_WORDS + S.MIN_STATE_TILES + 1
    assert S._state(cpu, 5, 3, False) is c


@pytest.mark.parametrize("captures", [1, 2, 5])
def test_captured_compactions_take_reserved_states(monkeypatch, captures):
    """In a graph capture each launch takes a zeroed buffer that
    ``reserve_graph_states`` set aside, for good: never the stream's own
    buffer, never one another launch took, none zeroed during the capture;
    none left (or none large enough) raises."""
    monkeypatch.setattr(S, "_STATE", {})
    monkeypatch.setattr(S, "_SPARE", {})
    monkeypatch.setattr(S, "_CAPTURED", [])
    cpu = torch.device("cpu")
    eager = S._state(cpu, 5, 10, False)
    with pytest.raises(RuntimeError, match="reserve_graph_states"):
        S._state(cpu, 5, 10, True)
    S.reserve_graph_states(cpu, captures)
    S.reserve_graph_states(cpu, 1, tiles=20)
    got = [S._state(cpu, 5, 10, True) for _ in range(captures)]
    assert all(st is not eager for st in got)
    assert len({id(st) for st in got}) == captures
    assert all(st.numel() == S.STATE_WORDS + S.MIN_STATE_TILES
               and not bool(st.any()) for st in got)
    # a buffer too small for the launch is passed over, and stays set aside
    with pytest.raises(RuntimeError, match="reserve_graph_states"):
        S._state(cpu, 5, 21, True)
    small = S._state(cpu, 5, 20, True)
    assert small.numel() == S.STATE_WORDS + 20
    assert S._CAPTURED == got + [small] and S._SPARE[None] == []
    assert S._state(cpu, 5, 10, False) is eager


class _FakeCompact:
    """Stands for the scatter library's compactions: records each launch
    and carries it out on host memory from its arguments alone."""

    def __init__(self):
        self.launches = []

    def p1_compact_blocks_per_sm(self):
        return 8

    def p1_compact(self, base, head, n, chunk, blocks, counts, out,
                   capacity, count_out, stream):
        self.launches.append({"route": "two_pass", "blocks": blocks,
                              "chunk": chunk, "stream": stream})
        return self._carry_out(base, head, n, out, capacity, count_out)

    def p1_compact_one(self, base, head, n, tiles, blocks, out, capacity,
                       count_out, state, stream):
        self.launches.append({"route": "lookback", "tiles": tiles,
                              "blocks": blocks, "state": state,
                              "stream": stream})
        return self._carry_out(base, head, n, out, capacity, count_out)

    @staticmethod
    def _carry_out(base, head, n, out, capacity, count_out):
        assert base % 16 == 0 and 0 <= head < 16
        mask = np.frombuffer(ctypes.string_at(base + head, n), np.uint8)
        rows = np.nonzero(mask)[0].astype(np.int64)
        got = np.zeros(capacity, np.int64)
        got[:min(capacity, rows.size)] = rows[:capacity]
        ctypes.memmove(out, got.ctypes.data, got.nbytes)
        ctypes.memmove(count_out, np.int64(rows.size).tobytes(), 8)
        return 0


@pytest.mark.parametrize("route,rows", [("lookback", 70_013),
                                        ("two_pass", 70_013),
                                        (None, 70_013), (None, 2 ** 20 + 5)])
@pytest.mark.parametrize("capturing", [False, True])
def test_compact_is_one_launch_of_its_route(monkeypatch, route, rows,
                                            capturing):
    """On a CUDA tensor ``compact`` (``route`` None) makes ONE launch of the
    look-back, with the state ``_state`` gives for the stream and for
    whether it is capturing; ``_compact`` by name launches that route; the
    result is the plain version's."""
    lib = _FakeCompact()
    monkeypatch.setattr(S, "_library", lambda: lib)
    monkeypatch.setattr(S, "_OCCUPANCY", {})
    monkeypatch.setattr(S, "_capturing", lambda: capturing)
    monkeypatch.setattr(_build, "launch_on", lambda dev, launch: launch(77))
    monkeypatch.setattr(_build, "sm_count", lambda dev: H100_SMS)
    states = []

    def state(dev, stream, tiles, capture):
        states.append((stream, tiles, capture))
        return torch.zeros(S.STATE_WORDS + tiles, dtype=torch.int64)

    monkeypatch.setattr(S, "_state", state)
    rng = np.random.RandomState(5)
    full = rng.rand(rows + 3) < 0.3
    for lo in (0, 3):
        mask = _t(full).as_subclass(_OnCuda)[lo:lo + rows]
        want_idx, want_count = S.compact_plain(_t(full)[lo:lo + rows], 9000)
        before = S.COMPACT_LAUNCHES
        idx, count = S.compact(mask, 9000) if route is None \
            else S._compact(mask, 9000, route)
        assert S.COMPACT_LAUNCHES - before == 1
        assert torch.equal(idx.as_subclass(torch.Tensor), want_idx)
        assert int(count.as_subclass(torch.Tensor)) == int(want_count)
    assert [d["route"] for d in lib.launches] == [route or "lookback"] * 2
    assert {d["stream"] for d in lib.launches} == {77}
    one_launch = [d for d in lib.launches if d["route"] == "lookback"]
    assert states == [(77, d["tiles"], capturing) for d in one_launch]


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


# -------------------------------------------------------- on the card only


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
@pytest.mark.parametrize("route", ["lookback", "two_pass"])
def test_compact_bodies_match_nonzero_on_card(card, route):
    """Both compaction bodies against ``torch.nonzero``: views off the
    16-byte grid, capacities below and above the count, and the outputs of
    a replayed CUDA graph (the look-back's state is left zero)."""
    rng = np.random.RandomState(15)
    full = _t(rng.rand(2_000_019) < 0.036).to(card)
    for lo in (0, 5):
        m = full[lo:]
        want = torch.nonzero(m)[:, 0]
        for capacity in (0, want.shape[0] // 2, want.shape[0] + 33):
            idx, count = S._compact(m, capacity, route)
            live = min(capacity, want.shape[0])
            assert int(count) == want.shape[0]
            assert torch.equal(idx[:live], want[:live])
            assert not bool(idx[live:].any())
    graph, outs = torch.cuda.CUDAGraph(), []
    S._compact(full, 99_999, route)
    S.reserve_graph_states(card, 5)
    with torch.cuda.graph(graph):
        for _ in range(5):
            outs.append(S._compact(full, 99_999, route))
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
    streams at once: each answers its own mask (no state is shared), and
    a capture with no state set aside raises before it records a launch."""
    rng = np.random.RandomState(16)
    masks = [_t(rng.rand(3_000_017) < d).to(card) for d in (0.036, 0.5)]
    for m in masks:
        S.compact(m, 7)
    torch.cuda.synchronize()
    S._SPARE.pop(card.index, None)
    with pytest.raises(RuntimeError, match="reserve_graph_states"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            S.compact(masks[0], 7)
    graphs, outs = [], []
    for m in masks:
        S.reserve_graph_states(card, 3)
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
