"""The launch plans and parameter structs of the redesigned ``gather`` and
``dyncopy`` kernels, on the CPU.

``plan_gather`` (rows a thread, column groups under an L2 budget, 32-bit
offsets only where they fit) and ``dyncopy_plan`` (tiles and grid); the
wrappers' struct layouts against the CUDA sources' declarations; one launch
a ``gather_rows`` / ``concat_rows`` call whatever the element widths,
counted through a fake library that executes the packed descriptor on
CUDA-typed tensors (so the descriptor is checked against the plain
versions); launch-or-raise.  Exact everywhere: the functions move bits.
Tests marked ``cuda`` hold the kernels against the plain versions on a card
(``pytest -m cuda``) and skip elsewhere.
"""

import ctypes
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from presto1_tpu_torch.ops.kernels import _build, dyncopy as DC, gather as G

torch.set_num_threads(1)

H100_SMS = 132
H100_L2 = 52_428_800


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(rng, shape, dt):
    if dt == np.bool_:
        return rng.rand(*shape) > 0.5
    if np.dtype(dt).kind == "f":
        return rng.randn(*shape).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(max(info.min, -2**62), min(info.max, 2**62), shape,
                       dtype=np.int64).astype(dt)


DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32,
          np.float64]


# ------------------------------------------------------------ plan_gather


@pytest.mark.parametrize("width", [8, 4, 2, 1])
def test_plan_gather_rows_per_thread(width):
    """Four rows a thread at every width (measured fastest): the grid of a
    call covers its rows at ``ROWS_PER_THREAD`` a thread whatever the word
    width, and the source's ``kRows`` is the same constant."""
    assert G.ROWS_PER_THREAD == _constants(_source("gather"))["kRows"] == 4
    rows = 1_000_003
    tiles = -(-rows // (G.THREADS * G.ROWS_PER_THREAD))
    for units in ([(width, 1)], [(width, 1), (1, 1)], [(width, 7)]):
        plan = G.plan_gather(rows, 1000, units, H100_SMS, H100_L2)
        assert plan.blocks == tiles


@pytest.mark.parametrize("n,units,groups", [
    (6_002_010, [(8, 1)], 1),                # one column: no split
    (6_002_010, [(8, 1)] * 4, 4),            # 192 MB: 25 MB a group
    (6_002_010, [(4, 1)] * 6, 6),            # 144 MB
    (1_000_000, [(8, 1)] * 6, 2),            # 48 MB: 3 columns a group
    (1_000_000, [(8, 1), (1, 1)] * 2, 1),    # 18 MB fits the budget
    (3_000_000, [(8, 1)] * 2 + [(1, 1)] * 3, 5),  # by the widest word
])
def test_plan_gather_groups_under_the_l2_budget(n, units, groups):
    """Groups of units on blockIdx.y only when the sources exceed half the
    L2, each group's sources (at its widest word) within that budget or a
    group of one unit, every unit in exactly one group."""
    plan = G.plan_gather(n, n, units, H100_SMS, H100_L2)
    budget = H100_L2 // 2
    assert plan.groups == groups
    assert plan.groups * plan.per_group >= len(units)
    assert (plan.groups - 1) * plan.per_group < len(units)
    if plan.groups > 1:
        widest = max(w for w, _ in units)
        assert plan.per_group == 1 or plan.per_group * n * widest <= budget
    else:
        assert plan.per_group == len(units)


@pytest.mark.parametrize("n,units,keep", [
    (2_880_404, [(8, 1)], True),          # 23 MB: fits
    (6_002_010, [(8, 1)], False),         # 48 MB: one unit, beyond
    (2_880_404, [(8, 1)] * 5, True),      # 5 groups of 23 MB
    (4_000_000, [(8, 1)] * 3, False),     # groups of one 32 MB unit
    (6_002_010, [(8, 1)] * 4, False),     # groups of one 48 MB unit
    (1_000_000, [(8, 1), (1, 1)] * 2, True),
])
def test_plan_gather_keeps_sources_only_where_a_group_fits(n, units, keep):
    """The evict-last policy only where the sources of a group fit half the
    L2: marking more than it holds measured slower than no hint."""
    plan = G.plan_gather(n, n, units, H100_SMS, H100_L2)
    assert plan.keep is keep


@pytest.mark.parametrize("n,units,wide", [
    (6_002_010, [(8, 1)], False),
    (2 ** 29, [(8, 1)], False),               # 4 GiB exactly fits
    (2 ** 29 + 1, [(8, 1)], True),
    (2 ** 32, [(1, 1)], False),
    (2 ** 32 + 1, [(1, 1)], True),
    (100_000_000, [(8, 5)], False),           # rows of 40 bytes: 4.0e9
    (200_000_000, [(8, 5)], True),
    (200_000_000, [(4, 1), (8, 5)], True),
    (200_000_000, [(4, 1), (2, 3)], False),
])
def test_plan_gather_32_bit_offsets_only_where_they_fit(n, units, wide):
    assert G.plan_gather(10, n, units, H100_SMS, H100_L2).wide is wide


@pytest.mark.parametrize("rows", [1, 3, 1023, 1024, 6_002_010, 10 ** 9])
@pytest.mark.parametrize("n", [7, 6_002_010])
def test_plan_gather_grid(rows, n):
    """Every row tile has a thread (grid-stride beyond); no empty block;
    at most BLOCKS_PER_SM blocks an SM in one group, GROUP_BLOCKS_PER_SM
    (one resident wave) a group with groups."""
    plan = G.plan_gather(rows, n, [(8, 1)] * 4, H100_SMS, H100_L2)
    assert plan.groups == (1 if n == 7 else 4)
    per_sm = G.BLOCKS_PER_SM if plan.groups == 1 else G.GROUP_BLOCKS_PER_SM
    tiles = -(-rows // G.ROWS_PER_THREAD)
    assert 1 <= plan.blocks <= H100_SMS * per_sm
    assert plan.blocks == min(-(-tiles // G.THREADS), H100_SMS * per_sm)


def test_gather_units_of_matrices():
    """A 1-D column is one unit; an [n, W] matrix one unit per word of its
    row, the widest word (at most 8 bytes) dividing the row and both
    addresses."""
    a = torch.zeros((4, 3), dtype=torch.int64)
    b = torch.zeros((4, 5), dtype=torch.int16)
    c = torch.zeros((4, 2), dtype=torch.int32)
    d = torch.zeros((5,), dtype=torch.int8)
    outs = [torch.zeros_like(t) for t in (a, b, c, d)]
    units = G._units([a, b, c, d], outs)
    assert [(lw, k) for _, _, lw, k in units] == \
        [(3, 3)] * 3 + [(1, 5)] * 5 + [(3, 1), (0, 1)]
    assert [s - a.data_ptr() for s, _, _, _ in units[:3]] == [0, 8, 16]
    assert [d_ - outs[1].data_ptr() for _, d_, _, _ in units[3:8]] == \
        [0, 2, 4, 6, 8]
    # an address off the word: narrower words
    v = torch.zeros((9, 2), dtype=torch.int32).view(-1)[1:17].view(4, 4)
    (u,) = {(lw, k) for _, _, lw, k in G._units([v], [torch.zeros_like(v)])}
    assert u == (2, 4)


# ------------------------------------------------------------ dyncopy_plan


@pytest.mark.parametrize("col_bytes", [[1], [16], [DC.TILE_BYTES],
                                       [DC.TILE_BYTES + 1, 3, 0],
                                       [34_567_232] * 8 + [4_325_376]])
def test_dyncopy_plan_tiles_cover_every_word(col_bytes):
    tile0, tiles, blocks = DC.dyncopy_plan(col_bytes, H100_SMS)
    assert tile0[0] == 0
    for c, b in enumerate(col_bytes):
        end = tile0[c + 1] if c + 1 < len(col_bytes) else tiles
        assert (end - tile0[c]) * DC.TILE_BYTES >= b
        assert b == 0 or (end - tile0[c] - 1) * DC.TILE_BYTES < b
    assert 1 <= blocks <= max(1, min(tiles, H100_SMS * DC.BLOCKS_PER_SM))


# -------------------------------------------------------------- plan_take


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("width", [2, 3, 5, 7, 9, 33, 128, 1000, 2 ** 20 + 7,
                                   2 ** 31 - 1])
def test_take_magic_divides_every_element_number(width, bits):
    """The take body's row number: a multiply-high by the width's magic
    number and two shifts equal ``e // width`` for element numbers across
    the offsets' whole range."""
    rng = np.random.RandomState(width % 997)
    magic, shift = G.take_magic(width, bits)
    assert 0 < magic < 2 ** bits and 0 <= shift < bits
    top = 2 ** bits
    es = {0, 1, width - 1, width, width + 1, 2 * width - 1, top - 1,
          top - width, (top // width) * width, (top // width) * width - 1}
    es |= {int(v) for v in rng.randint(0, 2 ** 31, 300)}
    es |= {int(v) * 2 ** (bits - 31) + int(u) for v, u in
           zip(rng.randint(0, 2 ** 31, 300), rng.randint(0, 2 ** 31, 300))
           if int(v) * 2 ** (bits - 31) + int(u) < top}
    for e in es:
        t = (e * magic) >> bits
        assert (t + ((e - t) >> 1)) >> shift == e // width, e


def test_take_magic_of_width_one_divides_nothing():
    assert G.take_magic(1, 32) == G.take_magic(1, 64) == (0, 0)
    with pytest.raises(ValueError):
        G.take_magic(0, 32)


def _take_plan(total=1000, width=1, x_numel=1000, x_bytes=8, idx_bytes=8,
               idx_addr=4096, out_addr=8192, occupancy=lambda wide: 8):
    return G.plan_take(total, width, x_numel, x_bytes, idx_bytes, idx_addr,
                       out_addr, H100_SMS, occupancy, H100_L2)


@pytest.mark.parametrize("x_numel,total,wide", [
    (2 ** 31 - 1, 1000, False), (2 ** 31, 1000, True),
    (1000, 2 ** 31 - 1, False), (1000, 2 ** 31, True),
    (24 * 6_002_010, 12_004_020, False)])
def test_plan_take_32_bit_offsets_only_where_they_fit(x_numel, total, wide):
    plan = _take_plan(total=total, x_numel=x_numel)
    assert plan.wide == wide
    assert (plan.magic, plan.shift) == (0, 0)  # width 1
    plan = _take_plan(total=total, width=3, x_numel=x_numel)
    assert (plan.magic, plan.shift) == G.take_magic(3, 64 if wide else 32)


@pytest.mark.parametrize("idx_bytes", [4, 8])
@pytest.mark.parametrize("lo", [0, 1, 2, 3])
def test_plan_take_reads_the_index_from_a_16_byte_boundary(idx_bytes, lo):
    """The index is read as 16-byte vectors from the boundary at or below
    its first element: a view ``lo`` elements in has ``head`` elements
    below it; the output is stored a vector at a time only where both
    start on the boundary."""
    addr = 4096 + lo * idx_bytes
    plan = _take_plan(idx_bytes=idx_bytes, idx_addr=addr)
    assert plan.base == addr - addr % 16 and plan.base % 16 == 0
    assert plan.head == (addr % 16) // idx_bytes < 16 // idx_bytes
    assert plan.vec_out == (plan.head == 0)
    assert not _take_plan(idx_bytes=idx_bytes, out_addr=8200).vec_out


def test_plan_take_keeps_x_only_where_it_fits_half_the_l2():
    half = H100_L2 // 2
    assert _take_plan(x_numel=half // 8).keep
    assert not _take_plan(x_numel=half // 8 + 1).keep
    assert _take_plan(x_numel=half, x_bytes=1).keep


@pytest.mark.parametrize("total", [1, 7, 2048, 2049, 12_004_020, 10 ** 9])
@pytest.mark.parametrize("idx_bytes", [4, 8])
def test_plan_take_grid_from_the_occupancy(total, idx_bytes):
    """TAKE_LOADS elements a thread, grid-stride beyond the occupancy the
    library reports for the chosen variant (asked with its offsets)."""
    asked = []

    def occupancy(wide):
        asked.append(wide)
        return 6

    plan = _take_plan(total=total, idx_bytes=idx_bytes, x_numel=10 ** 9,
                      occupancy=occupancy)
    vectors = -(-total // (16 // idx_bytes))
    per_block = G.THREADS * G.TAKE_LOADS // (16 // idx_bytes)
    assert plan.blocks == max(1, min(-(-vectors // per_block),
                                     H100_SMS * 6))
    assert asked == [plan.wide]
    assert plan.blocks * per_block >= vectors or plan.blocks == H100_SMS * 6


def test_plan_take_at_the_engine_calls():
    """The window's doubling-table lookup (x [24 n, 1] int64, 12,004,020
    ends, axis 0) and element_at's lane of [n, 2] int64: 32-bit offsets,
    no division, x too large to keep in L2, a full card."""
    n = 6_002_010
    window = _take_plan(total=2 * n, x_numel=24 * n)
    element_at = _take_plan(total=n, x_numel=2 * n)
    for plan in (window, element_at):
        assert not plan.wide and not plan.keep and plan.vec_out
        assert (plan.magic, plan.shift) == (0, 0)
        assert plan.blocks == H100_SMS * 8

# ------------------------------------------------- layouts against sources


def _source(name):
    return (Path(_build.CSRC) / f"{name}.cu").read_text()


def _constants(text):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9]+);", text)}


_C_TYPES = {"const void*": "Q", "void*": "Q", "const int64_t*": "Q",
            "int64_t": "q", "int32_t": "i"}


def _struct_format(text, name, constants):
    """The struct module format of ``struct <name> {...}`` in a CUDA
    source: pointer, int64_t and int32_t fields, arrays of them and of
    earlier structs, sized by the source's constants."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    fmt = ""
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*(\w+)(?:\[(\w+)\])?;", line)
        ctype, count = m.group(1).strip(), m.group(3)
        item = _C_TYPES.get(ctype) or _struct_format(text, ctype, constants)
        fmt += item * (constants[count] if count else 1)
    return fmt


def _expanded(fmt):
    """A struct format with every repeat count written out, empty pads
    dropped."""
    fmt = re.sub(r"(?<![0-9])0x", "", fmt)
    return re.sub(r"([0-9]+)([a-zA-Z])", lambda m: m.group(2) *
                  int(m.group(1)), fmt)


def test_gather_geometry_and_params_match_the_source():
    text = _source("gather")
    c = _constants(text)
    assert (G.THREADS, G.MAX_UNITS, G.LOADS, G.MAX_PAIRS,
            G.ROWS_PER_THREAD) == (c["kThreads"], c["kMaxUnits"],
                                   c["kLoads"], c["kMaxPairs"], c["kRows"])
    fmt = "<" + _struct_format(text, "Params", c)
    assert _expanded(G._packer(G.MAX_UNITS).format) == fmt
    for count in (1, 9, G.MAX_UNITS):
        assert G._packer(count).size == struct.calcsize(fmt)


def test_take_params_match_the_source():
    text = _source("gather")
    c = _constants(text)
    assert G.TAKE_LOADS == c["kTakeLoads"]
    assert G._TAKE.format == "<" + _struct_format(text, "TakeParams", c)


def test_dyncopy_geometry_and_params_match_the_source():
    text = _source("dyncopy")
    c = _constants(text)
    assert (DC.THREADS, DC.WORDS, DC.MAX_PARTS, DC.MAX_COLS,
            DC.MAX_PAIRS) == (c["kThreads"], c["kWords"], c["kMaxParts"],
                              c["kMaxCols"], c["kMaxPairs"])
    assert DC.TILE_BYTES == c["kThreads"] * c["kWords"] * 16
    fmt = "<" + _struct_format(text, "Params", c)
    assert struct.calcsize(fmt) < 4096  # no large kernel parameters needed
    full = DC._packer(DC.MAX_COLS, DC.MAX_PAIRS)
    assert _expanded(full.format) == fmt
    for cols, pairs in ((1, 1), (9, 18), (40, 80)):
        assert DC._packer(cols, pairs).size == full.size


# ------------------------- one launch a call, through a library that fakes it


class _OnCuda(torch.Tensor):
    """A tensor that claims to lie on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(a):
    return _t(a).as_subclass(_OnCuda)


def _plain(t):
    return None if t is None else t.as_subclass(torch.Tensor)


def _read(ptr, nbytes):
    return np.frombuffer(ctypes.string_at(ptr, nbytes), np.uint8)


def _write(ptr, data):
    data = np.ascontiguousarray(data, np.uint8)
    ctypes.memmove(ptr, data.ctypes.data, data.nbytes)


class _FakeGather:
    """Stands for the gather library: records each launch of the row body
    and carries it out on host memory from the packed ``Params`` alone."""

    def __init__(self):
        self.launches = []

    def p1_gather_rows(self, params, idx_w, wide, blocks, groups, stream):
        idx, rows, n, count, per_group, keep, _ = struct.unpack_from(
            "<Qqqiiii", params)
        units = [struct.unpack_from("<QQii", params, 40 + 24 * u)
                 for u in range(count)]
        self.launches.append({"count": count, "per_group": per_group,
                              "groups": groups, "units": units})
        assert groups * per_group >= count
        g = np.frombuffer(_read(idx, rows * idx_w).tobytes(),
                          np.int32 if idx_w == 4 else np.int64)
        g = np.clip(g.astype(np.int64), 0, n - 1)
        for src, dst, lw, k in units:
            w = 1 << lw
            rows_in = _read(src, ((n - 1) * k + 1) * w)
            words = np.stack([rows_in[(g * k) * w + b] for b in range(w)], 1)
            out = _read(dst, ((rows - 1) * k + 1) * w).copy()
            for b in range(w):
                out[np.arange(rows) * k * w + b] = words[:, b]
            _write(dst, out)
        return 0


def _fake_library(monkeypatch, module, lib):
    monkeypatch.setattr(module, "_library", lambda: lib)
    monkeypatch.setattr(_build, "launch_on", lambda dev, launch: launch(0))
    monkeypatch.setattr(_build, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(_build, "l2_bytes", lambda dev: H100_L2)


class _FakeTake:
    """Stands for the gather library's take body: records each launch and
    carries it out on host memory from the packed ``TakeParams`` alone, the
    row number by the magic number the wrapper packed."""

    def __init__(self):
        self.launches = []
        self.asked = []

    def p1_take_blocks_per_sm(self, lt, idx_w, wide, axis):
        self.asked.append((lt, idx_w, wide, axis))
        return 8

    def p1_take_along_axis(self, params, lt, idx_w, wide, axis, blocks,
                           stream):
        (x, base, out, total, n, wx, width, magic, shift, head, keep,
         vec_out) = G._TAKE.unpack(params)
        self.launches.append({"head": head, "wide": wide, "axis": axis,
                              "blocks": blocks, "vec_out": vec_out})
        assert base % 16 == 0 and 0 <= head < 16 // idx_w
        bits, magic = (64 if wide else 32), magic % 2 ** 64
        ix = np.frombuffer(_read(base, (head + total) * idx_w).tobytes(),
                           np.int32 if idx_w == 4 else np.int64)[head:]
        g = np.clip(ix.astype(np.int64), 0, n - 1)
        e = np.arange(total)
        if width == 1:
            i, j = e, np.zeros_like(e)
        else:
            t = np.array([(int(v) * magic) >> bits for v in e], np.int64)
            i = (t + ((e - t) >> 1)) >> shift
            assert np.array_equal(i, e // width)
            j = e - i * width
        off = g * wx + j if axis == 0 else i * wx + g
        w = 1 << lt
        src = _read(x, (int(off.max()) + 1) * w).reshape(-1, w)
        _write(out, src[off].reshape(-1))
        return 0


@pytest.mark.parametrize("axis,rows,width,xshape", [
    (0, 101, 33, (257, 33)), (1, 257, 9, (257, 33)), (0, 777, 1, (1000, 1)),
    (1, 300, 1, (300, 2)), (0, 1, 1, (5, 1)), (1, 1, 1, (1, 1))])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("lo", [0, 1, 3])
def test_take_along_axis_one_launch_of_the_take_body(monkeypatch, axis, rows,
                                                     width, xshape,
                                                     idx_dtype, lo):
    """Both axes, width 1 and wider, both index widths, index views off the
    16-byte boundary, indices out of range on both sides: ONE launch of the
    take body, whose descriptor alone gives numpy's take_along_axis of the
    clamped index, for every element width."""
    lib = _FakeTake()
    _fake_library(monkeypatch, G, lib)
    monkeypatch.setattr(G, "_TAKE_OCCUPANCY", {})
    rng = np.random.RandomState(rows + width + lo)
    n = xshape[axis]
    flat = rng.randint(-3, n + 3, lo + rows * width).astype(idx_dtype)
    idx_host = flat[lo:].reshape(rows, width)
    idx = _fake(flat)[lo:].view(rows, width)
    for dt in DTYPES:
        x_host = _values(rng, xshape, dt)
        before = (G.TAKE_LAUNCHES, G.LAUNCHES)
        got = G.take_along_axis(_fake(x_host), idx, axis)
        assert (G.TAKE_LAUNCHES - before[0], G.LAUNCHES - before[1]) == (1, 0)
        want = np.take_along_axis(x_host, np.clip(idx_host, 0, n - 1), axis)
        np.testing.assert_array_equal(_plain(got).numpy(), want)
        assert _plain(got).dtype == _t(x_host).dtype
    assert len(lib.launches) == len(DTYPES)
    assert {d["head"] for d in lib.launches} == {
        (idx.data_ptr() % 16) // idx.element_size()}
    assert all(d["axis"] == axis and not d["wide"] for d in lib.launches)
    assert {a[3] for a in lib.asked} == {axis}


def test_take_along_axis_empty_index_launches_nothing(monkeypatch):
    lib = _FakeTake()
    _fake_library(monkeypatch, G, lib)
    x = _fake(np.arange(12).reshape(4, 3))
    got = G.take_along_axis(x, _fake(np.zeros((0, 3), np.int64)), 0)
    assert tuple(got.shape) == (0, 3) and not lib.launches
    with pytest.raises(IndexError):
        G.take_along_axis(_fake(np.zeros((0, 3))),
                          _fake(np.zeros((2, 3), np.int64)), 0)


@pytest.mark.parametrize("shape,idx_shape,axis", [
    ((5, 3), (0, 3), 0), ((5, 3), (1, 3), 0), ((1, 1), (1, 1), 1),
    ((4, 6), (4, 1), 1), ((6, 4), (9, 4), 0), ((3, 7), (3, 11), 1)])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_take_along_axis_plain_matches_numpy(shape, idx_shape, axis,
                                             idx_dtype):
    """The plain version (what the wrapper runs on the CPU) against numpy's
    take_along_axis of the clamped index: empty and one-element inputs,
    wild indices far outside the axis."""
    rng = np.random.RandomState(sum(shape) + sum(idx_shape))
    x = rng.randint(-99, 99, shape)
    n = shape[axis]
    idx = rng.randint(-2 ** 30, 2 ** 30, idx_shape).astype(idx_dtype)
    idx.flat[:2] = [-1, n] if idx.size >= 2 else idx.flat[:2]
    want = np.take_along_axis(x, np.clip(idx, 0, n - 1), axis)
    for fn in (G.take_along_axis, G.take_along_axis_plain):
        np.testing.assert_array_equal(fn(_t(x), _t(idx), axis).numpy(), want)


@pytest.mark.parametrize("bad", [
    lambda x, i: G.take_along_axis(x[0], i, 0),
    lambda x, i: G.take_along_axis(x, i[0], 0),
    lambda x, i: G.take_along_axis(x, i.to(torch.int16), 0),
    lambda x, i: G.take_along_axis(x, i, 2),
    lambda x, i: G.take_along_axis(x, i[:, :2], 0),
    lambda x, i: G.take_along_axis(x.t(), i.t(), 1),
    lambda x, i: G.take_along_axis(x.to(torch.complex128), i, 0)])
def test_take_along_axis_rejects(bad):
    """The wrapper's argument checks: 2-D tensors, an int32/int64 index
    matching x off the axis, axis 0 or 1, contiguous, 1/2/4/8-byte
    elements."""
    x = torch.arange(12).view(4, 3)
    i = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        bad(x, i)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_rows_one_launch_for_mixed_widths(monkeypatch, idx_dtype,
                                                 seed):
    """Every element width, nested rows of three widths and both index
    widths: ONE launch, whose descriptor alone gives the plain version's
    result (indices out of range clamped)."""
    rng = np.random.RandomState(seed)
    n, m = 301, 257
    arrays = [_values(rng, (n,), dt) for dt in DTYPES] + [
        _values(rng, (n, 3), np.int64), _values(rng, (n, 5), np.int16),
        _values(rng, (n, 2), np.int32)]
    idx = rng.randint(-5, n + 5, m).astype(idx_dtype)
    lib = _FakeGather()
    _fake_library(monkeypatch, G, lib)
    before = G.LAUNCHES
    got = G.gather_rows([_fake(a) for a in arrays], _fake(idx))
    assert G.LAUNCHES - before == 1 and len(lib.launches) == 1
    assert lib.launches[0]["count"] == 7 + 3 + 5 + 1
    want = G.gather_rows_plain([_t(a) for a in arrays], _t(idx))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_plain(a), b)


def test_gather_rows_splits_beyond_the_struct(monkeypatch):
    """70 columns are 70 units: two launches of at most MAX_UNITS, each
    counted."""
    rng = np.random.RandomState(2)
    arrays = [_values(rng, (50,), np.int32) for _ in range(70)]
    idx = rng.randint(0, 50, 40)
    lib = _FakeGather()
    _fake_library(monkeypatch, G, lib)
    before = G.LAUNCHES
    got = G.gather_rows([_fake(a) for a in arrays], _fake(idx))
    assert G.LAUNCHES - before == 2
    assert [x["count"] for x in lib.launches] == [G.MAX_UNITS, 70 - G.MAX_UNITS]
    for a, b in zip(got, G.gather_rows_plain([_t(a) for a in arrays],
                                             _t(idx))):
        assert torch.equal(_plain(a), b)


def test_gather_rows_groups_its_units_beyond_the_budget(monkeypatch):
    """Sources beyond half the L2 go on blockIdx.y groups, in one launch."""
    rng = np.random.RandomState(3)
    arrays = [_values(rng, (64,), np.int64) for _ in range(5)]
    idx = rng.randint(0, 64, 100)
    lib = _FakeGather()
    _fake_library(monkeypatch, G, lib)
    monkeypatch.setattr(_build, "l2_bytes", lambda dev: 2 * 64 * 8 * 2)
    got = G.gather_rows([_fake(a) for a in arrays], _fake(idx))
    (launch,) = lib.launches
    assert (launch["groups"], launch["per_group"]) == (3, 2)
    for a, b in zip(got, G.gather_rows_plain([_t(a) for a in arrays],
                                             _t(idx))):
        assert torch.equal(_plain(a), b)


def test_gather_rows_empty_calls_launch_nothing(monkeypatch):
    lib = _FakeGather()
    _fake_library(monkeypatch, G, lib)
    x = _fake(np.arange(5))
    assert G.gather_rows([], _fake(np.arange(3))) == []
    assert G.gather_rows([x], _fake(np.zeros(0, np.int64)))[0].shape == (0,)
    empty = G.gather_rows([_fake(np.zeros(0, np.int32))], _fake(np.arange(3)))
    assert torch.equal(_plain(empty[0]), torch.zeros(3, dtype=torch.int32))
    assert G.gather_rows([_fake(np.zeros((5, 0)))],
                         _fake(np.arange(3)))[0].shape == (3, 0)
    assert lib.launches == []


class _FakeDyncopy:
    """Stands for the dyncopy library: records each launch and carries it
    out on host memory from the packed ``Params`` alone."""

    def __init__(self):
        self.launches = []

    def p1_dyncopy(self, params, blocks, stream):
        head = struct.unpack_from(f"<Qqqiiii{DC.MAX_PARTS}q", params)
        counts_ptr, capacity, tiles, k, ncols, fill = head[:6]
        caps = head[7:7 + k]
        at_cols = struct.calcsize(f"<Qqqiiii{DC.MAX_PARTS}q")
        cols = [struct.unpack_from("<Qqqii", params, at_cols + 32 * c)
                for c in range(ncols)]
        at_pairs = at_cols + 32 * DC.MAX_COLS
        pairs = [struct.unpack_from("<Qq", params, at_pairs + 16 * q)
                 for q in range(ncols * k)]
        self.launches.append({"cols": ncols, "k": k, "tiles": tiles})
        counts = np.frombuffer(_read(counts_ptr, 8 * k).tobytes(), np.int64)
        live = np.minimum(np.maximum(counts, 0), caps)
        off = np.concatenate([[0], np.cumsum(live)])
        for dst, rb, tile0, pair0, _ in cols:
            out = np.zeros(capacity * rb, np.uint8)
            for p in range(k):
                src, srb = pairs[pair0 + p]
                rows = int(min(live[p], max(capacity - off[p], 0)))
                if rows <= 0:
                    continue
                if src == 0:
                    part = np.full((rows, rb), fill, np.uint8)
                else:
                    part = np.zeros((rows, rb), np.uint8)
                    part[:, :srb] = _read(src, rows * srb).reshape(rows, srb)
                out[off[p] * rb:(off[p] + rows) * rb] = part.reshape(-1)
            _write(dst, out)
        return 0


def _columns(rng, sizes):
    cols = [[_values(rng, (n,), dt) for n in sizes] for dt in DTYPES]
    cols.append([_values(rng, (n, 3 if p else 7), np.int64)
                 for p, n in enumerate(sizes)])
    cols.append([None if p == 1 else _values(rng, (n,), np.bool_)
                 for p, n in enumerate(sizes)])
    return cols


@pytest.mark.parametrize("counts", [(1001, 777, 33), (999, 3, 31),
                                    (0, 777, 5), (5000, -2, 10 ** 12)])
@pytest.mark.parametrize("capacity", [1, 17, 2048])
def test_concat_rows_one_launch_for_mixed_widths(monkeypatch, counts,
                                                 capacity):
    """Seven element widths, nested rows of two widths and a validity mask
    one part lacks, at odd row offsets: ONE launch, whose descriptor alone
    gives the plain version's result."""
    rng = np.random.RandomState(sum(counts) % 1000 + capacity)
    cols = _columns(rng, (1001, 777, 33))
    lib = _FakeDyncopy()
    _fake_library(monkeypatch, DC, lib)
    before = DC.LAUNCHES
    fc = [[None if a is None else _fake(a) for a in c] for c in cols]
    got = DC.concat_rows(fc, _fake(np.array(counts, np.int64)), capacity)
    assert DC.LAUNCHES - before == 1 and len(lib.launches) == 1
    assert lib.launches[0]["cols"] == len(cols)
    pc = [[None if a is None else _t(a) for a in c] for c in cols]
    want = DC.concat_rows_plain(pc, torch.tensor(counts), capacity)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_plain(a), b)


def test_concat_rows_splits_beyond_the_struct(monkeypatch):
    """80 columns of 2 parts: MAX_COLS columns a launch, each counted; 20
    columns of 8 parts: MAX_PAIRS // 8 columns a launch."""
    rng = np.random.RandomState(4)
    lib = _FakeDyncopy()
    _fake_library(monkeypatch, DC, lib)
    for parts, ncols in ((2, 80), (8, 20)):
        cols = [[_values(rng, (40 + p,), np.int16) for p in range(parts)]
                for _ in range(ncols)]
        counts = np.arange(parts, dtype=np.int64) * 3 + 1
        lib.launches.clear()
        before = DC.LAUNCHES
        got = DC.concat_rows([[_fake(a) for a in c] for c in cols],
                             _fake(counts), 300)
        per = min(DC.MAX_COLS, DC.MAX_PAIRS // parts)
        assert [x["cols"] for x in lib.launches] == \
            [min(per, ncols - at) for at in range(0, ncols, per)]
        assert DC.LAUNCHES - before == len(lib.launches)
        want = DC.concat_rows_plain([[_t(a) for a in c] for c in cols],
                                    _t(counts), 300)
        for a, b in zip(got, want):
            assert torch.equal(_plain(a), b)


def test_concat_rows_capacity_0_launches_nothing(monkeypatch):
    lib = _FakeDyncopy()
    _fake_library(monkeypatch, DC, lib)
    got = DC.concat_rows([[_fake(np.arange(4)), _fake(np.arange(2))]],
                         _fake(np.array([4, 2])), 0)
    assert got[0].shape == (0,) and lib.launches == []


# ------------------------------------------------------- launch or raise


@pytest.mark.parametrize("call", ["gather_mixed", "take_along_axis",
                                  "concat_mixed"])
def test_cuda_tensor_launches_or_raises(monkeypatch, call):
    """For tensors on a CUDA device the wrappers go to their kernels and
    never to the plain versions: a failed build raises, and the launch
    counters do not move."""
    called = []

    def failing_load(lib):
        called.append(f"build:{lib}")
        raise _build.KernelBuildError("nvcc failed: injected")

    monkeypatch.setattr(_build, "load", failing_load)
    for mod, plain in ((G, "gather_rows_plain"), (G, "take_along_axis_plain"),
                       (DC, "concat_rows_plain")):
        monkeypatch.setattr(mod, plain, lambda *a: called.append("plain"))
    i64 = _fake(np.arange(8))
    i8 = _fake(np.arange(8, dtype=np.int8))
    before = (G.LAUNCHES, DC.LAUNCHES)
    with pytest.raises(_build.KernelBuildError, match="injected"):
        if call == "gather_mixed":
            G.gather_rows([i64, i8, _fake(np.zeros((8, 3)))], i64)
        elif call == "take_along_axis":
            G.take_along_axis(i64.reshape(2, 4), i64.reshape(2, 4) % 2, 0)
        else:
            DC.concat_rows([[i64, i64], [i8, i8], [None, i8 > 2]],
                           _fake(np.array([3, 5])), 16)
    assert called == [f"build:{'dyncopy' if 'concat' in call else 'gather'}"]
    assert (G.LAUNCHES, DC.LAUNCHES) == before


@pytest.mark.parametrize("module", ["gather", "dyncopy"])
def test_a_failed_launch_raises(monkeypatch, module):
    """A launch the library refuses (a non-zero code) raises and is not
    counted."""
    class Refusing:
        def p1_gather_rows(self, *a):
            return -3

        def p1_dyncopy(self, *a):
            return 700

    mod = G if module == "gather" else DC
    _fake_library(monkeypatch, mod, Refusing())
    before = mod.LAUNCHES
    x = _fake(np.arange(8))
    with pytest.raises(RuntimeError, match="launch failed"):
        if module == "gather":
            G.gather_rows([x, x.to(torch.int16)], x)
        else:
            DC.concat_rows([[x, x]], _fake(np.array([3, 5])), 16)
    assert mod.LAUNCHES == before


def test_l2_size_is_looked_up_once_per_device(monkeypatch):
    asked = []

    class Props:
        L2_cache_size = H100_L2

    def props(index):
        asked.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(_build, "_L2", {})
    dev = torch.device("cuda", 2)
    assert [_build.l2_bytes(dev) for _ in range(4)] == [H100_L2] * 4
    assert asked == [2]


@pytest.mark.parametrize("current,target,entered", [(0, 0, False),
                                                    (0, 1, True)])
def test_launch_on_enters_the_device_only_when_it_is_not_current(
        monkeypatch, current, target, entered):
    events = []

    class Guard:
        def __init__(self, index):
            events.append(("enter", index))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            events.append("exit")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    got = _build.launch_on(torch.device("cuda", target),
                           lambda stream: ("launched", stream))
    assert got == ("launched", 1000 + target)
    assert events == ([("enter", target), "exit"] if entered else [])


# -------------------------------------------------------- on the card only


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gather_new_shapes_on_card(card, monkeypatch):
    """More than 32 columns in one launch, mixed widths with nested rows,
    column groups (under an L2 budget made small), unaligned outputs."""
    rng = np.random.RandomState(21)
    n, m = 100_003, 70_001
    srcs = [_t(_values(rng, (n,), dt)).to(card) for dt in DTYPES * 5] + [
        _t(_values(rng, (n, 3), np.int64)).to(card),
        _t(_values(rng, (n, 5), np.int16)).to(card)]
    for idt in (np.int32, np.int64):
        idx = _t(rng.randint(-5, n + 5, m).astype(idt)).to(card)
        before = G.LAUNCHES
        got = G.gather_rows(srcs, idx)
        assert G.LAUNCHES - before == 1
        want = G.gather_rows_plain(srcs, idx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        outs = [s.new_empty((m + 1,) + tuple(s.shape[1:]))[1:] for s in srcs]
        G._gather(srcs, outs, idx)
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
        with monkeypatch.context() as patch:
            patch.setattr(_build, "l2_bytes", lambda dev: 4 * n * 8)
            units = [(1 << lw, k) for _, _, lw, k in G._units(srcs, outs)]
            assert G.plan_gather(m, n, units, H100_SMS,
                                 _build.l2_bytes(card)).groups > 1
            for a, b in zip(G.gather_rows(srcs, idx), want):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_take_body_on_card(card):
    """The take body against the plain version: both axes, width 1 and
    wider, index views off the 16-byte grid, every element width, one
    launch a call."""
    rng = np.random.RandomState(23)
    for dt in DTYPES:
        x = _t(_values(rng, (999, 7), dt)).to(card)
        for idt in (np.int32, np.int64):
            for lo in range(4):
                flat = _t(rng.randint(-9, 1009, lo + 500 * 7).astype(idt))
                for axis, idx in ((0, flat.to(card)[lo:].view(500, 7)),
                                  (1, flat.to(card)[lo:lo + 999 * 3]
                                   .view(999, 3).remainder(9) - 1),
                                  (1, flat.to(card)[lo:lo + 999]
                                   .view(999, 1).remainder(9) - 1)):
                    before = G.TAKE_LAUNCHES
                    got = G.take_along_axis(x, idx.contiguous(), axis)
                    assert G.TAKE_LAUNCHES - before == 1
                    want = G.take_along_axis_plain(x, idx.contiguous(), axis)
                    assert torch.equal(got, want)


@pytest.mark.cuda
def test_dyncopy_new_shapes_on_card(card):
    """Odd row offsets for int32, int16 and bool, several widths and nested
    rows in one launch, more than 32 pairs."""
    rng = np.random.RandomState(22)
    cols = [[_t(a).to(card) if a is not None else None for a in c]
            for c in _columns(rng, (1001, 777, 33))]
    for counts in ((1001, 777, 33), (999, 3, 31), (0, 777, 5)):
        c = torch.tensor(counts, dtype=torch.int64, device=card)
        for capacity in (17, 2048):
            before = DC.LAUNCHES
            got = DC.concat_rows(cols, c, capacity)
            assert DC.LAUNCHES - before == 1
            for a, b in zip(got, DC.concat_rows_plain(cols, c, capacity)):
                assert torch.equal(a, b)
    many = [[_t(_values(rng, (409 + p,), dt)).to(card) for p in range(2)]
            for dt in DTYPES * 6]
    c = torch.tensor([400, 77], dtype=torch.int64, device=card)
    got = DC.concat_rows(many, c, 500)
    for a, b in zip(got, DC.concat_rows_plain(many, c, 500)):
        assert torch.equal(a, b)
