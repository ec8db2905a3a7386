#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the main paths of ``presto1_tpu_torch`` on the card -- TPC-H Q6, Q1
and the revenue view of Q15 at scale factor 1 through ``Engine.sql`` and
``Engine.compile(...)`` / ``CompiledQuery.block_run`` -- builds every
hand-written kernel from the sources in this checkout, holds each against
its plain PyTorch version on the card (integers exactly, float64 sums to
1e-9 relative), shows from the launch counters that the main paths went
through them, and times kernel, plain version, library call and engine.  Every phase prints one JSON line; any failed phase
raises, and the exit code is then non-zero.  It needs one CUDA device, the
CUDA toolkit (``nvcc``) and no network.  ``P1_TPCH_CACHE=<dir>`` keeps the
generated TPC-H columns on disk between runs.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
its error against the plain version, its time on the device (a CUDA-graph
replay, so the host's cost of a call is not in it), the plain version's time
and its bound (the larger of bytes moved over the card's published memory rate
and operations over its published rate; ``copy_bound_ms`` gives the same
bytes over the device-to-device copy rate measured in this run).
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the non-tensor-core arithmetic rate the integer work is held against.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = 67e12
# integer operations a row of the filter+product-sum: five compares, four
# ands, one 64-bit multiply (four 32-bit ones), mask, shift, three adds
FILTER_SUM_OPS_PER_ROW = 18

Q6_BOUNDS = (8766, 9131, 5, 7, 2400)


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of the CUDA-event time of ``reps`` calls, per
    call, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Time of one call of ``fn`` on the device alone: ``reps`` calls are
    captured into one CUDA graph, and the median over ``trials`` of the
    CUDA-event time of a replay is divided by ``reps``.  A replay enqueues
    nothing from Python, so the host's cost of a call (which exceeds a short
    kernel's time) stays out of the number."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    del graph
    return statistics.median(out)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    say("device", **info)
    return info


def phase_build() -> None:
    from presto1_tpu_torch.ops.kernels import _build

    t0 = time.time()
    info = _build.build_all()
    log = "\n".join(i["log"] for i in info.values())
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sorted({ln.strip() for ln in log.splitlines()
                     if "spill" in ln and "0 bytes spill stores, "
                     "0 bytes spill loads" not in ln})
    say("build", seconds=time.time() - t0, sources=sorted(info),
        nvcc_seconds={n: i["seconds"] for n, i in info.items()},
        kernels_compiled=len(registers),
        max_registers=max(registers, default=None), spills=spills)


def _columns(n: int, dtypes, gen) -> tuple:
    """Synthetic Q6-like columns on the card: ship days, discount cents,
    quantity and price in hundredths."""
    def col(lo, hi, dt):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=dt)

    ds, dd, dq, dp = dtypes
    hi_price = 10_500_000 if dp == torch.int64 else 2_000_000
    return (col(8036, 10562, ds), col(0, 11, dd), col(100, 5001, dq),
            col(90_000, hi_price, dp))


def phase_kernel_check(gen) -> float:
    """Kernel against plain version on the card, exactly, over the shapes
    the CPU tests use, unaligned views, and full-size synthetic columns."""
    from presto1_tpu_torch.ops.kernels import filter_sum as F

    i32, i64 = torch.int32, torch.int64
    dtype_sets = {"all_int32": (i32, i32, i32, i32),
                  "engine": (i32, i64, i64, i64),
                  "all_int64": (i64, i64, i64, i64),
                  "mixed": (i64, i32, i64, i32)}
    bound_sets = {"q6": Q6_BOUNDS,
                  "all_pass": (-2**62, 2**62, -2**62, 2**62, 2**62),
                  "all_fail": (0, 0, 0, 0, 0)}
    worst = 0
    cases = 0

    def hold(cols, bounds, what):
        nonlocal worst, cases
        got = torch.stack(F.range_filter_limb_sums(*cols, bounds))
        torch.cuda.synchronize()
        want = torch.stack(F.range_filter_limb_sums_plain(*cols, bounds))
        err = int((got - want).abs().max())
        worst = max(worst, err)
        cases += 1
        if err != 0:
            raise AssertionError(
                f"filter_sum kernel disagrees with its plain version "
                f"({what}): kernel {got.tolist()} plain {want.tolist()}")

    for dname, dts in dtype_sets.items():
        for n in (0, 1, 3, 4, 5, 2047, 2048, 2049, 10_000, 1_000_003):
            cols = _columns(n, dts, gen)
            for bname, b in bound_sets.items():
                hold(cols, b, f"{dname} n={n} {bname}")
        # views that start off a 16-byte boundary take the one-row path
        cols = tuple(c[1:] for c in _columns(70_001, dts, gen))
        hold(cols, Q6_BOUNDS, f"{dname} unaligned")
        # wide products of either sign: the high limb carries real bits
        s, d, q, _ = _columns(50_000, dts, gen)
        wide = torch.randint(-2**40, 2**40, (50_000,), generator=gen,
                             device="cuda", dtype=i64)
        if dts[3] == i64:
            hold((s, d, q, wide), bound_sets["all_pass"], f"{dname} wide")
    big = 0
    for dname in ("all_int32", "engine"):
        for n in (6_002_010, 2**27):
            cols = _columns(n, dtype_sets[dname], gen)
            hold(cols, Q6_BOUNDS, f"{dname} n={n}")
            big += 1
            del cols
    # bounds handed over as a device tensor, and the (sum, count) entry
    cols = _columns(100_000, dtype_sets["engine"], gen)
    b_dev = torch.tensor(Q6_BOUNDS, dtype=i64, device="cuda")
    s1, c1 = F.range_filter_product_sum(*cols, b_dev)
    s2, c2 = F.range_filter_product_sum_plain(*cols, b_dev)
    torch.cuda.synchronize()
    if int(s1) != int(s2) or int(c1) != int(c2):
        raise AssertionError("range_filter_product_sum disagrees with its "
                             "plain version")
    say("kernel_check", kernel="filter_sum", cases=cases + 1,
        full_size_cases=big, max_abs_err=worst, tolerance=0)
    return float(worst)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / max(|want|, tiny); 0 where both are equal
    (infinities and NaNs included)."""
    same = (got == want) | (got.isnan() & want.isnan())
    d = torch.where(same, torch.zeros_like(got), (got - want).abs()
                    / want.abs().clamp(min=1e-300))
    return float(d.max()) if d.numel() else 0.0


def _abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over two tensors of one shape and type, measured
    (integers in int64, everything else in float64); 0.0 for empty ones."""
    if got.numel() == 0:
        return 0.0
    wide = torch.float64 if got.dtype.is_floating_point else torch.int64
    return float((got.to(wide) - want.to(wide)).abs().max())


def _q1_like(n: int, gen, groups: int = 12, dead_share: float = 0.02):
    """A dense word and value columns shaped like TPC-H Q1's at ``n`` rows:
    4 of ``groups`` words carry almost all rows, ``dead_share`` of the rows
    hold the sentinel; five int64 decimal columns and Q1's 12 slots."""
    r = torch.rand((n,), generator=gen, device="cuda")
    live = torch.tensor([1, 2, 7, 8], device="cuda")[
        torch.randint(0, 4, (n,), generator=gen, device="cuda")]
    word = torch.where(r < dead_share, groups, live).to(torch.int64)

    def col(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int64)

    qty, price, disc = col(100, 5001), col(90_000, 10_500_000), col(0, 11)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + col(0, 9))
    columns = [qty, price, disc_price, charge, disc]
    slots = [("sum", 0, None), ("sum", 1, None), ("low", 2, None),
             ("high", 2, None), ("low", 3, None), ("high", 3, None),
             ("low", 0, None), ("high", 0, None), ("low", 1, None),
             ("high", 1, None), ("low", 4, None), ("high", 4, None)]
    return word, columns, slots


def _mixed_case(n: int, groups: int, gen, word_dtype=torch.int64):
    """Every column type and every op the dense aggregate takes, with
    validity on some slots and words outside the domain on both sides."""
    word = torch.randint(-1, groups + 2, (n,), generator=gen, device="cuda",
                         dtype=word_dtype)
    i64 = torch.randint(-2**62, 2**62, (n,), generator=gen, device="cuda",
                        dtype=torch.int64)
    i32 = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                        device="cuda", dtype=torch.int32)
    f64 = (torch.rand((n,), generator=gen, device="cuda",
                      dtype=torch.float64) - 0.25) * 1e6
    flag = torch.rand((n,), generator=gen, device="cuda") > 0.5
    valid = torch.rand((n,), generator=gen, device="cuda") > 0.3
    columns = [i64, i32, f64, flag]
    slots = [("sum", 0, None), ("low", 0, valid), ("high", 0, None),
             ("sum", 1, valid), ("min", 1, None), ("max", 1, valid),
             ("min", 0, valid), ("max", 0, None), ("sum", 2, None),
             ("sum", 2, valid), ("min", 2, valid), ("max", 2, None),
             ("sum", 3, None), ("count", None, valid),
             ("count", None, None), ("low", 1, None), ("high", 1, None)]
    return word, columns, slots


def phase_kernel_check_dense(gen) -> dict:
    """``dense_group_agg`` against its plain version on the card: integer
    outputs exactly, float64 outputs to 1e-9 relative (the summation order
    differs), and two runs of the kernel bit for bit."""
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D

    worst_int, worst_rel, cases = 0, 0.0, 0

    def hold(word, groups, columns, slots, what):
        nonlocal worst_int, worst_rel, cases
        got = D.dense_group_agg(word, groups, columns, slots)
        again = D.dense_group_agg(word, groups, columns, slots)
        torch.cuda.synchronize()
        want = D.dense_group_agg_plain(word, groups, columns, slots)
        for name in ("counts", "first_row", "table"):
            if not torch.equal(getattr(got, name), getattr(again, name)):
                raise AssertionError(f"dense_group_agg: two runs differ in "
                                     f"{name} ({what})")
        pairs = [("counts", got.counts, want.counts),
                 ("first_row", got.first_row, want.first_row)]
        pairs += [(f"slot {k} {slots[k][0]}", got.slot(k), want.slot(k))
                  for k in range(len(slots))]
        for name, a, b in pairs:
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"dense_group_agg {name}: {a.dtype} "
                                     f"{tuple(a.shape)} vs plain {b.dtype} "
                                     f"{tuple(b.shape)} ({what})")
            if a.dtype == torch.float64:
                rel = _rel_err(a, b)
                worst_rel = max(worst_rel, rel)
                if not rel <= 1e-9:
                    raise AssertionError(
                        f"dense_group_agg {name}: relative error {rel} "
                        f"against its plain version ({what})")
            else:
                err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
                    if a.numel() else 0
                worst_int = max(worst_int, err)
                if err != 0:
                    raise AssertionError(
                        f"dense_group_agg {name} disagrees with its plain "
                        f"version ({what}): kernel {a.tolist()} plain "
                        f"{b.tolist()}")
        cases += 1

    # the probes' own shape: 2^23 int32 values over 256 bins, no slot
    vals = torch.randint(0, 256, (2**23,), generator=gen, device="cuda",
                         dtype=torch.int32)
    hold(vals, 256, [], [], "histogram 2^23 x 256")
    hist = D.dense_group_agg(vals, 256, [], []).counts
    if not torch.equal(hist, torch.bincount(vals, minlength=256)):
        raise AssertionError("histogram disagrees with torch.bincount")
    # the engine's shape: Q1's domain and recipe at SF1's row count
    word, columns, slots = _q1_like(6_002_010, gen)
    hold(word, 12, columns, slots, "Q1 recipe, 6,002,010 rows")
    hold(word.to(torch.int32), 12, columns, slots, "Q1 recipe, int32 word")
    for n in (0, 1, 3, 2047, 2049, 1_000_003):
        for groups in (1, 12, 13, 100):
            for wdt in (torch.int64, torch.int32):
                word, columns, slots = _mixed_case(n, groups, gen, wdt)
                hold(word, groups, columns, slots,
                     f"mixed n={n} G={groups} {wdt}")
    # 256 groups x 17 slots: more than 48 KB of shared memory a block
    word, columns, slots = _mixed_case(300_001, 256, gen)
    hold(word, 256, columns, slots, "mixed G=256")
    # views that start off a 16-byte boundary
    word, columns, slots = _mixed_case(70_001, 13, gen)
    hold(word[1:], 13, [c[1:] for c in columns],
         [(op, c, None if v is None else v[1:]) for op, c, v in slots],
         "unaligned views")
    # all rows dead, and all rows in one group
    word, columns, slots = _mixed_case(50_000, 12, gen)
    hold(torch.full_like(word, 12), 12, columns, slots, "all dead")
    hold(torch.full_like(word, 5), 12, columns, slots, "one group")
    say("kernel_check", kernel="dense_group_agg", cases=cases,
        max_abs_err=worst_int, f64_max_rel_err=worst_rel,
        tolerance={"integers": 0, "float64_relative": 1e-9,
                   "two_runs": "bit-equal"})
    return {"max_abs_err": float(worst_int), "f64_max_rel_err": worst_rel}


_MOVE_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
                torch.int64, torch.float32, torch.float64)


def _values(shape, dtype, gen) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen, device="cuda") > 0.5
    if dtype.is_floating_point:
        return torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -2**62), min(info.max, 2**62)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=dtype)


def phase_kernel_check_gather(gen) -> dict:
    """``gather_rows`` / ``take_along_axis`` against their plain versions on
    the card, exactly."""
    from presto1_tpu_torch.ops.kernels import gather as G

    cases, worst = 0, 0.0

    def hold_rows(sources, idx, what):
        nonlocal cases, worst
        got = G.gather_rows(sources, idx)
        torch.cuda.synchronize()
        want = G.gather_rows_plain(sources, idx)
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"gather_rows source {k}: {a.dtype} "
                                     f"{tuple(a.shape)} vs plain {b.dtype} "
                                     f"{tuple(b.shape)} ({what})")
            worst = max(worst, _abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"gather_rows source {k} disagrees "
                                     f"with its plain version ({what})")
        cases += 1

    def hold_axis(x, idx, axis, what):
        nonlocal cases, worst
        got = G.take_along_axis(x, idx, axis)
        torch.cuda.synchronize()
        want = G.take_along_axis_plain(x, idx, axis)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"take_along_axis axis {axis}: type or "
                                 f"shape differs from the plain version's "
                                 f"({what})")
        worst = max(worst, _abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"take_along_axis axis {axis} disagrees "
                                 f"with its plain version ({what})")
        cases += 1

    def index(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    # the probes' own shapes
    perm = torch.randperm(2048, generator=gen, device="cuda")
    hold_rows([_values((2048,), torch.int32, gen)], perm.to(torch.int32),
              "2048 int32 permutation")
    hold_rows([_values((1024, 128), torch.float32, gen)],
              index(0, 1024, (1024,), torch.int32), "[1024,128] rows")
    for rows in (512, 8192):
        x = _values((rows, 128), torch.int32, gen)
        hold_axis(x, index(0, rows, (rows, 128), torch.int32), 0,
                  f"[{rows},128] axis 0")
        hold_axis(x, index(0, 128, (rows, 128), torch.int32), 1,
                  f"[{rows},128] axis 1")
    # the engine's shapes: a batch's columns at a 6M-row permutation
    n = 6_002_010
    perm = torch.randperm(n, generator=gen, device="cuda")
    batch = [_values((n,), dt, gen) for dt in
             (torch.int64, torch.int64, torch.float64, torch.int32,
              torch.int32, torch.bool)]
    hold_rows(batch, perm, "6,002,010-row batch, int64 index")
    hold_rows(batch, perm.to(torch.int32), "6,002,010-row batch, int32 index")
    del batch, perm
    for n in (0, 1, 3, 2047, 2049, 1_000_003):
        for m in (0, 1, 2049):
            srcs = [_values((n,), dt, gen) for dt in _MOVE_DTYPES]
            srcs.append(_values((n, 5), torch.int64, gen))
            # indices out of range on both sides: clamped
            for idt in (torch.int32, torch.int64):
                hold_rows(srcs, index(-7, n + 7, (m,), idt),
                          f"n={n} m={m} {idt}")
    # more columns of one width than one launch holds
    srcs = [_values((4099,), torch.int32, gen) for _ in range(70)]
    hold_rows(srcs, index(-3, 5000, (777,)), "70 columns of one width")
    # views that start off a 16-byte boundary
    srcs = [_values((70_001,), dt, gen)[1:] for dt in _MOVE_DTYPES]
    hold_rows(srcs, index(0, 70_000, (33_333,))[1:], "unaligned views")
    for dt in _MOVE_DTYPES:
        x = _values((257, 33), dt, gen)
        for idt in (torch.int32, torch.int64):
            hold_axis(x, index(-2, 260, (100, 33), idt), 0, f"{dt} axis 0")
            hold_axis(x, index(-2, 40, (257, 9), idt), 1, f"{dt} axis 1")
    say("kernel_check", kernel="gather", cases=cases, max_abs_err=worst,
        tolerance=0)
    return {"max_abs_err": worst}


def phase_kernel_check_scatter(gen) -> dict:
    """``scatter_distinct`` against its plain version on the card, exactly,
    and ``compact_indices`` (prefix sum + this kernel) against
    ``torch.nonzero``."""
    from presto1_tpu_torch.ops.kernels import scatter as S
    from presto1_tpu_torch.ops.segments import compact_indices

    cases, worst = 0, 0.0

    def hold(idx, x, size, mask, what):
        nonlocal cases, worst
        got = S.scatter_distinct(idx, x, size, mask)
        torch.cuda.synchronize()
        want = S.scatter_distinct_plain(idx, x, size, mask)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"scatter_distinct: {got.dtype} "
                                 f"{tuple(got.shape)} vs plain {want.dtype} "
                                 f"{tuple(want.shape)} ({what})")
        worst = max(worst, _abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"scatter_distinct disagrees with its "
                                 f"plain version ({what})")
        cases += 1

    # the probes' own shapes: permutations of 2048 and 8192
    for n in (2048, 8192):
        perm = torch.randperm(n, generator=gen, device="cuda")
        hold(perm.to(torch.int32), _values((n,), torch.int32, gen), n, None,
             f"{n} int32 permutation")
    for n in (0, 1, 3, 2047, 2049, 1_000_003):
        perm = torch.randperm(n, generator=gen, device="cuda")
        mask = torch.rand((n,), generator=gen, device="cuda") > 0.5
        for idt in (torch.int32, torch.int64):
            for xdt in (torch.int32, torch.int64, torch.float64):
                hold(perm.to(idt), _values((n,), xdt, gen), n, None,
                     f"n={n} {idt} {xdt}")
                hold(perm.to(idt), _values((n,), xdt, gen), n, mask,
                     f"n={n} {idt} {xdt} masked")
            # the row numbers themselves; targets past a short output and
            # below zero are dropped
            hold(perm.to(idt), None, n, mask, f"n={n} iota")
            hold(perm.to(idt) - 5, None, max(n // 2, 1), None,
                 f"n={n} out of range")
    # views that start off a 16-byte boundary
    perm = torch.randperm(70_001, generator=gen, device="cuda")
    hold(perm[1:], _values((70_001,), torch.float64, gen)[1:], 70_001,
         (perm > 9)[1:], "unaligned views")
    # the engine's shape: compaction of a 6M-row mask at the density of the
    # Q15 view's ship-date window (91 of 2526 days)
    n = 6_002_010
    mask = torch.rand((n,), generator=gen, device="cuda") < 91 / 2526
    rank = torch.cumsum(mask, dim=0) - 1
    for capacity in (n, 262_144, 1000):
        hold(rank, None, capacity, mask,
             f"compaction of 6,002,010 rows into {capacity}")
        hold(rank.to(torch.int32), _values((n,), torch.float64, gen),
             capacity, mask, f"6,002,010 masked rows into {capacity}")
        idx, count = compact_indices(mask, capacity)
        torch.cuda.synchronize()
        want = torch.nonzero(mask)[:, 0]
        live = min(capacity, int(want.shape[0]))
        if int(count) != int(want.shape[0]) \
                or not torch.equal(idx[:live], want[:live]) \
                or int(idx[live:].abs().sum()) != 0:
            raise AssertionError(f"compact_indices disagrees with "
                                 f"torch.nonzero (capacity {capacity})")
        cases += 1
    say("kernel_check", kernel="scatter", cases=cases, max_abs_err=worst,
        tolerance=0)
    return {"max_abs_err": worst, "mask": mask}


def phase_copy_bandwidth() -> float:
    """Device-to-device ``copy_`` of 1 GiB; bytes/s counting the read and
    the write."""
    nbytes = 1 << 30
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda").random_(0, 255)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10, trials=10)
    rate = 2 * nbytes / (ms * 1e-3)
    say("copy_bandwidth", gib=1, ms=ms, bytes_per_s=rate,
        counts="read + write")
    return rate


def _numpy_q6(host: dict):
    m = ((host["l_shipdate"] >= Q6_BOUNDS[0])
         & (host["l_shipdate"] < Q6_BOUNDS[1])
         & (host["l_discount"] >= Q6_BOUNDS[2])
         & (host["l_discount"] <= Q6_BOUNDS[3])
         & (host["l_quantity"] < Q6_BOUNDS[4]))
    prod = host["l_extendedprice"].astype(np.int64) \
        * host["l_discount"].astype(np.int64)
    return int(prod[m].sum()), int(m.sum())


def _load(catalog, names) -> tuple:
    """Columns of lineitem on the card; (device columns, host arrays,
    seconds the load took -- generation on the host included)."""
    t0 = time.time()
    lineitem = catalog.table("lineitem")
    dev_cols = {c: lineitem.column(c) for c in names}
    torch.cuda.synchronize()
    load_s = time.time() - t0
    host = {c: col.data.cpu().numpy() for c, col in dev_cols.items()}
    return dev_cols, host, load_s


def _run_ms(q, reps: int) -> float:
    """ms per compiled run: median of 5 CUDA-event timings of
    ``block_run(reps)``."""
    return time_ms(lambda: q.block_run(reps=reps), reps=1, trials=5) / reps


def _profile(cq, reps: int = 5) -> dict:
    """Device time of a compiled run by kernel name, from ``torch.profiler``
    over ``reps`` runs: the sum, and the dozen largest.  Where the profiler
    sees no device activity the sum is None and nothing is claimed."""
    from torch.profiler import ProfilerActivity, profile

    cq.block_run(reps=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cq.block_run(reps=reps)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator's row repeats its kernels' time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key[:72], us / reps / 1e3, ev.count / reps))
    rows.sort(key=lambda r: -r[1])
    if not rows:
        return {"device_ms_per_run": None, "top": []}
    return {"device_ms_per_run": sum(r[1] for r in rows),
            "kernels_per_run": sum(r[2] for r in rows),
            "top": [list(r) for r in rows[:12]]}


def _assert_resident(cq, n: int) -> None:
    if not all(t.is_cuda for t in cq.inputs.values()) or \
            {t.shape[0] for t in cq.inputs.values()} != {n}:
        raise AssertionError("scan inputs are not resident on the card")


def phase_q6_engine(catalog) -> dict:
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.executor import CompiledQuery
    from presto1_tpu_torch.ops.filter import filter_mask
    from presto1_tpu_torch.ops.hashagg import AggSpec, global_aggregate
    from presto1_tpu_torch.expr.eval import eval_expr
    from presto1_tpu_torch.ops.kernels import filter_sum as F
    from presto1_tpu_torch.tpch.queries import QUERIES

    lineitem = catalog.table("lineitem")
    names = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    dev_cols, host, load_s = _load(catalog, names)
    n = lineitem.num_rows
    want_sum, want_cnt = _numpy_q6(host)
    if want_cnt == 0:
        raise AssertionError("Q6 selects no row: the data is wrong")

    engine = Engine(catalog, device="cuda")
    sql = QUERIES[6]

    def revenue(batch) -> int:
        c = batch["revenue"]
        if batch.num_rows != 1 or tuple(c.data.shape) != (1,) \
                or not c.data.is_cuda or str(c.type) != "decimal(38,4)":
            raise AssertionError(f"unexpected Q6 output: {batch}")
        if not bool(c.validity[0]):
            raise AssertionError("Q6 revenue is NULL")
        return int(c.data[0])

    # ---- the main path, with the launch counter read around each step
    F.LAUNCHES = 0
    got_sql = revenue(engine.sql(sql))
    after_sql = F.LAUNCHES
    cq = engine.compile(sql)
    after_compile = F.LAUNCHES
    got_cq = revenue(cq())
    after_call = F.LAUNCHES
    reps = 20
    rows_out = cq.block_run(reps=reps)
    launches = F.LAUNCHES
    steps = (after_sql, after_compile - after_sql, after_call - after_compile,
             launches - after_call)
    if steps != (1, 1, 1, reps):
        raise AssertionError(f"launches per step {steps}, expected "
                             f"(1, 1, 1, {reps}): the main path did not go "
                             f"through the kernel once per run")
    if rows_out != 1:
        raise AssertionError(f"block_run returned {rows_out} rows")
    _assert_resident(cq, n)
    for what, got in (("Engine.sql", got_sql), ("CompiledQuery()", got_cq)):
        if got != want_sum:
            raise AssertionError(f"{what}: revenue {got} != numpy "
                                 f"{want_sum}")

    # ---- the generic operators on the same device batch
    plan = engine.plan(sql)
    agg_node = plan.child
    filt = agg_node.child
    scan = filt.child
    below = lineitem.batch(list(scan.symbols.keys()), "cuda")
    below = type(below)({scan.symbols[c]: col
                         for c, col in below.columns.items()},
                        below.num_rows)
    mask = filter_mask(filt.predicate, below)
    checks: list = []
    a = agg_node.aggs[0]
    generic = global_aggregate(
        [AggSpec(a.fn, eval_expr(a.arg, below), a.symbol)],
        below.num_rows, below.capacity(), mask=mask, checks=checks)
    g = generic[a.symbol]
    if int(g.data[0]) != want_sum or not bool(g.validity[0]) \
            or not all(bool(c) for c in checks) or len(checks) != 1:
        raise AssertionError("generic filter_mask + global_aggregate "
                             "disagrees with numpy")
    if int(mask.sum()) != want_cnt:
        raise AssertionError("generic mask count disagrees with numpy")

    # ---- steady-state time of a compiled run: routed through the kernel,
    # and the same plan on the generic operators, in turns
    cq_generic = CompiledQuery(catalog, plan, device="cuda",
                               route_kernels=False)
    if revenue(cq_generic()) != want_sum:
        raise AssertionError("generic compiled path disagrees with numpy")

    g1 = _run_ms(cq_generic, reps)
    k1 = _run_ms(cq, reps)
    k2 = _run_ms(cq, reps)
    g2 = _run_ms(cq_generic, reps)
    routed_ms = (k1 + k2) / 2
    generic_ms = (g1 + g2) / 2
    out = {
        "sf": catalog.sf, "lineitem_rows": n, "load_seconds": load_s,
        "revenue_unscaled": got_sql, "revenue": got_sql / 10_000,
        "rows_selected": want_cnt, "launches": launches,
        "launches_per_step": {"sql": steps[0], "compile": steps[1],
                              "call": steps[2], f"block_run_{reps}": steps[3]},
        "routed_ms_per_run": routed_ms, "routed_ms_trials": [k1, k2],
        "generic_ms_per_run": generic_ms, "generic_ms_trials": [g1, g2],
        "routed_rows_per_s": n / (routed_ms * 1e-3),
        "generic_rows_per_s": n / (generic_ms * 1e-3),
        "agrees_with": ["numpy int64", "generic operators",
                        "generic compiled path"],
    }
    say("q6_engine", **out)
    ship, disc, qty, price = (dev_cols[c].data for c in names)
    return {"launches": launches, "cols": (ship, disc, qty, price)}


class _Tap:
    """While active, records the arguments of the largest call (by bytes of
    tensor arguments) of a kernel wrapper, wherever the port bound its name.
    Used outside the launch-counted steps, to time each kernel afterwards at
    the shapes the main path gave it."""

    def __init__(self, name: str, modules):
        self.name, self.modules = name, modules
        self.args, self.bytes = None, -1

    @staticmethod
    def _nbytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (list, tuple)):
            return sum(_Tap._nbytes(y) for y in x)
        return 0

    def __enter__(self):
        self.orig = getattr(self.modules[0], self.name)

        def tapped(*args, **kwargs):
            size = self._nbytes(args)
            if size > self.bytes:
                self.args, self.bytes = args, size
            return self.orig(*args, **kwargs)

        for m in self.modules:
            setattr(m, self.name, tapped)
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            setattr(m, self.name, self.orig)


def _engine_steps(engine, sql: str, check, reps: int) -> dict:
    """Drive one statement down the main path -- ``Engine.sql``,
    ``Engine.compile`` (its discovery run), ``cq()``, ``block_run(reps)`` --
    with every kernel's launch counter set to 0 just before and read around
    each step.  ``check(batch)`` holds a result against the host reference."""
    from presto1_tpu_torch.ops.kernels import (
        dense_group_agg as D, filter_sum as F, gather as G, scatter as S)

    mods = {"filter_sum": F, "dense_group_agg": D, "gather": G, "scatter": S}
    for m in mods.values():
        m.LAUNCHES = 0

    def read():
        return {k: m.LAUNCHES for k, m in mods.items()}

    marks = [read()]
    eager = engine.sql(sql)
    marks.append(read())
    cq = engine.compile(sql)
    marks.append(read())
    compiled = cq()
    marks.append(read())
    rows_out = cq.block_run(reps=reps)
    marks.append(read())
    check(eager, "Engine.sql")
    check(compiled, "CompiledQuery()")
    if rows_out != compiled.num_rows:
        raise AssertionError(f"block_run returned {rows_out} rows, cq() "
                             f"{compiled.num_rows}")
    names = ("sql", "compile", "call", f"block_run_{reps}")
    steps = {k: {s: marks[i + 1][k] - marks[i][k]
                 for i, s in enumerate(names)} for k in mods}
    for k, st in steps.items():
        if st[names[3]] != reps * st["call"]:
            raise AssertionError(
                f"{k}: launches per step {st}: a compiled run does not "
                f"launch the same kernels every time")
    return {"cq": cq, "eager": eager, "compiled": compiled,
            "launches": marks[-1], "launches_per_step": steps}


def _same_batches(a, b, what: str) -> None:
    """Eager against compiled: every live value and validity bit equal
    (float64 to 1e-9 relative)."""
    if a.names != b.names or a.num_rows != b.num_rows:
        raise AssertionError(f"{what}: eager and compiled differ in shape")
    n = a.num_rows
    for name in a.names:
        x, y = a[name], b[name]
        if (x.validity is None) != (y.validity is None) or (
                x.validity is not None
                and not torch.equal(x.validity[:n], y.validity[:n])):
            raise AssertionError(f"{what}: validity of {name} differs")
        dx, dy = x.data[:n], y.data[:n]
        ok = (_rel_err(dx, dy) <= 1e-9) if dx.dtype.is_floating_point \
            else torch.equal(dx, dy)
        if not ok:
            raise AssertionError(f"{what}: eager and compiled differ in "
                                 f"{name}")


def _numpy_q1(host: dict, flags, statuses) -> list:
    """TPC-H Q1 over the host columns in exact integer arithmetic: rows of
    (flag, status, sum_qty, sum_base_price, sum_disc_price, sum_charge,
    avg_qty, avg_price, avg_disc, count) ordered by (flag, status); sums are
    unscaled integers at scales 2, 2, 4, 6."""
    m = host["l_shipdate"] <= 10471  # date '1998-12-01' - 90 days
    rf, ls = host["l_returnflag"][m], host["l_linestatus"][m]
    qty, price = host["l_quantity"][m], host["l_extendedprice"][m]
    disc, tax = host["l_discount"][m], host["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    for f in range(len(flags)):
        for s in range(len(statuses)):
            g = (rf == f) & (ls == s)
            c = int(g.sum())
            if c == 0:
                continue
            sq, sp, sd = int(qty[g].sum()), int(price[g].sum()), \
                int(disc[g].sum())
            rows.append((str(flags[f]), str(statuses[s]), sq, sp,
                         int(disc_price[g].sum()), int(charge[g].sum()),
                         sq / (c * 100), sp / (c * 100), sd / (c * 100), c))
    return rows


def phase_q1_engine(catalog) -> dict:
    """TPC-H Q1 at the catalog's scale factor: dense grouped aggregation
    through ``dense_group_agg``, then the sort of its few groups."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.ops import hashagg as H
    from presto1_tpu_torch.tpch.queries import QUERIES

    lineitem = catalog.table("lineitem")
    names = ("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax")
    dev_cols, host, load_s = _load(catalog, names)
    n = lineitem.num_rows
    want = _numpy_q1(host, dev_cols["l_returnflag"].dictionary,
                     dev_cols["l_linestatus"].dictionary)
    if len(want) != 4:
        raise AssertionError(f"Q1 reference has {len(want)} groups, not 4: "
                             f"the data is wrong")
    types = ["varchar", "varchar", "decimal(38,2)", "decimal(38,2)",
             "decimal(38,4)", "decimal(38,6)", "double", "double", "double",
             "bigint"]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected Q1 output columns")
        if batch.num_rows != len(want):
            raise AssertionError(f"{what}: {batch.num_rows} groups, numpy "
                                 f"{len(want)}")
        k = batch.num_rows
        for c in cols:
            if c.validity is not None and not bool(c.validity[:k].all()):
                raise AssertionError(f"{what}: NULL in Q1's output")
        got = [list(cols[0].decode(k)), list(cols[1].decode(k))]
        got += [c.data[:k].cpu().tolist() for c in cols[2:]]
        for r, row in enumerate(want):
            for j, w in enumerate(row):
                g = got[j][r]
                ok = abs(g - w) <= 1e-9 * abs(w) if types[j] == "double" \
                    else g == w
                if not ok:
                    raise AssertionError(
                        f"{what}: Q1 row {r} column {j}: {g!r} != numpy "
                        f"{w!r}")

    engine = Engine(catalog, device="cuda")
    sql = QUERIES[1]
    reps = 20
    run = _engine_steps(engine, sql, check, reps)
    _same_batches(run["eager"], run["compiled"], "Q1")
    steps = run["launches_per_step"]
    if steps["dense_group_agg"] != {"sql": 1, "compile": 1, "call": 1,
                                    f"block_run_{reps}": reps}:
        raise AssertionError(f"Q1 launched dense_group_agg "
                             f"{steps['dense_group_agg']}: not once per run")
    if steps["gather"]["call"] < 1 or steps["scatter"]["call"] < 1:
        raise AssertionError("Q1 did not go through gather and scatter")
    _assert_resident(run["cq"], n)
    with _Tap("dense_group_agg", [H]) as tap:  # outside the counted steps
        check(engine.sql(sql), "Engine.sql (tapped)")
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    ms = sum(ms_trials) / 2
    say("q1_engine", sf=catalog.sf, lineitem_rows=n, load_seconds=load_s,
        groups=len(want), rows=[list(r) for r in want],
        launches=run["launches"], launches_per_step=steps,
        ms_per_run=ms, ms_trials=ms_trials, rows_per_s=n / (ms * 1e-3),
        profile=_profile(run["cq"]),
        agrees_with=["numpy int64 (sums and counts exactly, averages to "
                     "1e-9 relative)", "eager == compiled"])
    word, groups, columns, slots = tap.args
    return {"launches": run["launches"], "ms_per_run": ms,
            "dense_args": (word, groups, list(columns), list(slots))}


def _numpy_q15_view(host: dict):
    """Supplier numbers and unscaled (scale 4) revenues of the Q15 view."""
    m = (host["l_shipdate"] >= 9496) & (host["l_shipdate"] < 9587)
    supp = host["l_suppkey"][m]
    rev = host["l_extendedprice"][m] * (100 - host["l_discount"][m])
    keys, inverse = np.unique(supp, return_inverse=True)
    sums = np.zeros(len(keys), dtype=np.int64)
    np.add.at(sums, inverse, rev)
    return keys, sums, int(m.sum())


def phase_q15view_engine(catalog) -> dict:
    """The revenue view of TPC-H Q15 at the catalog's scale factor: the sort
    branch of the grouped aggregation (sort, gather, prefix sums, compaction
    of the group boundaries through scatter), then the sort of its groups."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.ops import common as C, hashagg as H, \
        segments as SEG
    from presto1_tpu_torch.ops.kernels import gather as G, scatter as S
    from presto1_tpu_torch.tpch.queries import Q15_REVENUE_VIEW

    lineitem = catalog.table("lineitem")
    names = ("l_shipdate", "l_suppkey", "l_extendedprice", "l_discount")
    dev_cols, host, load_s = _load(catalog, names)
    n = lineitem.num_rows
    want_keys, want_sums, selected = _numpy_q15_view(host)
    if len(want_keys) < 1000 * min(catalog.sf, 1.0):
        raise AssertionError("the Q15 view has too few groups: the data is "
                             "wrong")

    def check(batch, what):
        k, r = batch["supplier_no"], batch["total_revenue"]
        if str(k.type) != "bigint" or str(r.type) != "decimal(38,4)" \
                or not (k.data.is_cuda and r.data.is_cuda):
            raise AssertionError(f"{what}: unexpected view output columns")
        if batch.num_rows != len(want_keys):
            raise AssertionError(f"{what}: {batch.num_rows} groups, numpy "
                                 f"{len(want_keys)}")
        g = batch.num_rows
        if not bool(r.validity[:g].all()):
            raise AssertionError(f"{what}: NULL revenue")
        if not np.array_equal(k.data[:g].cpu().numpy(), want_keys) or \
                not np.array_equal(r.data[:g].cpu().numpy(), want_sums):
            raise AssertionError(f"{what}: the view disagrees with numpy")

    engine = Engine(catalog, device="cuda")
    reps = 20
    run = _engine_steps(engine, Q15_REVENUE_VIEW, check, reps)
    _same_batches(run["eager"], run["compiled"], "Q15 view")
    steps = run["launches_per_step"]
    if steps["gather"]["call"] < 1 or steps["scatter"]["call"] < 1:
        raise AssertionError("the Q15 view did not go through gather and "
                             "scatter")
    if steps["dense_group_agg"]["call"] != 0:
        raise AssertionError("the Q15 view took the dense path")
    _assert_resident(run["cq"], n)
    # outside the counted steps: the largest gather and scatter of a run
    with _Tap("gather_rows", [G, C, H, SEG]) as gtap, \
            _Tap("scatter_distinct", [S, SEG]) as stap:
        check(engine.sql(Q15_REVENUE_VIEW), "Engine.sql (tapped)")
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    ms = sum(ms_trials) / 2
    say("q15view_engine", sf=catalog.sf, lineitem_rows=n,
        load_seconds=load_s, groups=len(want_keys), rows_selected=selected,
        first_rows=[[int(a), int(b)] for a, b in
                    zip(want_keys[:3], want_sums[:3])],
        launches=run["launches"], launches_per_step=steps,
        ms_per_run=ms, ms_trials=ms_trials, rows_per_s=n / (ms * 1e-3),
        profile=_profile(run["cq"]),
        agrees_with=["numpy int64 exactly", "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": ms,
            "gather_args": gtap.args, "scatter_args": stap.args}


def _bounds(nbytes: int, ops: float, copy_rate: float) -> dict:
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "copy_bound_ms": nbytes / copy_rate * 1e3}


def kernel_times(cols, copy_rate: float) -> dict:
    from presto1_tpu_torch.ops.kernels import filter_sum as F

    n = cols[0].shape[0]
    b = torch.tensor(Q6_BOUNDS, dtype=torch.int64, device="cuda")
    nbytes = sum(c.element_size() for c in cols) * n + 3 * 8
    ms = device_ms(lambda: F.range_filter_limb_sums(*cols, b))
    plain_ms = device_ms(lambda: F.range_filter_limb_sums_plain(*cols, b),
                         reps=5)
    # the same calls enqueued from Python back to back: what a caller sees
    # when the host's cost of a call exceeds the kernel's time
    call_ms = time_ms(lambda: F.range_filter_limb_sums(*cols, b))
    return {"n": n, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
            **_bounds(nbytes, FILTER_SUM_OPS_PER_ROW * n, copy_rate),
            "bytes_per_s": nbytes / (ms * 1e-3)}


def dense_times(word, groups, columns, slots, copy_rate: float,
                library=None) -> dict:
    """``dense_group_agg`` at one shape.  Bytes: the word, every value
    column and every distinct validity column once, and the outputs.
    Operations: per row and slot a select and an add, plus the compare."""
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D

    n = word.shape[0]
    valids = {v.data_ptr() for _, _, v in slots if v is not None}
    nbytes = n * (word.element_size()
                  + sum(c.element_size() for c in columns) + len(valids)) \
        + groups * (len(slots) + 2) * 8
    out = {"n": n, "groups": groups, "columns": len(columns),
           "slots": len(slots),
           "ms": device_ms(lambda: D.dense_group_agg(word, groups, columns,
                                                     slots)),
           "plain_ms": time_ms(lambda: D.dense_group_agg_plain(
               word, groups, columns, slots), reps=2, trials=3),
           "call_ms": time_ms(lambda: D.dense_group_agg(word, groups,
                                                        columns, slots)),
           **_bounds(nbytes, n * (2 * len(slots) + 2), copy_rate),
           # bincount reads its result's size back, so it cannot be captured
           # into a graph: CUDA events around calls enqueued from Python
           "library_ms": None if library is None else time_ms(library)}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def gather_times(sources, idx, copy_rate: float) -> dict:
    """``gather_rows`` at one shape.  Bytes: the index once, one source
    element read and one output element written per output element."""
    from presto1_tpu_torch.ops.kernels import gather as G

    sources = list(sources)
    m = idx.shape[0]
    per_row = sum(s.element_size() * (s.numel() // max(s.shape[0], 1))
                  for s in sources)
    nbytes = m * (idx.element_size() + 2 * per_row)
    long_idx = idx.to(torch.int64)

    def library():
        return [s.index_select(0, long_idx) for s in sources]

    out = {"rows_out": m, "rows_in": int(sources[0].shape[0]),
           "sources": [f"{s.dtype}{list(s.shape[1:])}" for s in sources],
           "index": str(idx.dtype),
           "ms": device_ms(lambda: G.gather_rows(sources, idx)),
           "plain_ms": device_ms(lambda: G.gather_rows_plain(sources, idx)),
           "call_ms": time_ms(lambda: G.gather_rows(sources, idx)),
           **_bounds(nbytes, m * len(sources), copy_rate),
           "library_ms": device_ms(library),
           "library_call": "torch.index_select, once per source, on "
                           "indices already in range"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def scatter_times(idx, x, size, mask, copy_rate: float) -> dict:
    """``scatter_distinct`` at one shape.  Bytes the function needs: the
    mask once; the index only where the mask holds, counted as the 32-byte
    sectors of ``idx`` that hold such a row (the whole of ``idx`` without a
    mask); the kept rows' values; and the output once (it is zero-filled)."""
    from presto1_tpu_torch.ops.kernels import scatter as S

    n = idx.shape[0]
    t = idx.to(torch.int64)
    keep = (t >= 0) & (t < size)
    if mask is not None:
        keep = keep & mask
    kept = int(keep.sum())
    width = x.element_size() if x is not None else 8
    idx_w = idx.element_size()
    idx_bytes = n * idx_w
    sectors = None
    if mask is not None:
        per = 32 // idx_w  # rows of idx in one sector
        padded = torch.zeros((-(-n // per) * per,), dtype=torch.bool,
                             device="cuda")
        padded[:n] = mask
        sectors = int(padded.view(-1, per).any(dim=1).sum())
        idx_bytes = min(idx_bytes, sectors * 32)
    nbytes = (0 if mask is None else n) + idx_bytes \
        + (kept * width if x is not None else 0) + size * width
    target = torch.where(keep, t, size)
    vals = x if x is not None else torch.arange(n, device="cuda")

    def library():
        return torch.zeros((size + 1,), dtype=vals.dtype,
                           device="cuda").scatter_(0, target, vals)

    out = {"rows": n, "size": size, "kept": kept,
           "masked": mask is not None, "iota": x is None,
           "index_sectors_read": sectors, "index_bytes": idx_bytes,
           "ms": device_ms(lambda: S.scatter_distinct(idx, x, size, mask)),
           "plain_ms": device_ms(lambda: S.scatter_distinct_plain(
               idx, x, size, mask)),
           "call_ms": time_ms(lambda: S.scatter_distinct(idx, x, size,
                                                         mask)),
           **_bounds(nbytes, n, copy_rate),
           "library_ms": device_ms(library),
           "library_call": "Tensor.scatter_ into zeros, targets and values "
                           "made beforehand"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA device only")
    import presto1_tpu_torch  # noqa: F401 -- fail before printing anything
    from presto1_tpu_torch.exec.catalog import TpchCatalog

    device = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20240607)
    err = phase_kernel_check(gen)
    dense_err = phase_kernel_check_dense(gen)
    gather_err = phase_kernel_check_gather(gen)
    scatter_err = phase_kernel_check_scatter(gen)
    copy_rate = phase_copy_bandwidth()
    catalog = TpchCatalog(sf=1.0, device="cuda")
    q6 = phase_q6_engine(catalog)
    q1 = phase_q1_engine(catalog)
    q15 = phase_q15view_engine(catalog)
    launches = {k: q6["launches"] if k == "filter_sum"
                else q1["launches"][k] + q15["launches"][k]
                for k in q1["launches"]}

    card = device["nvidia_smi"]
    at_engine = kernel_times(q6["cols"], copy_rate)
    i32, i64 = torch.int32, torch.int64
    big = kernel_times(_columns(2**27, (i32, i64, i64, i64), gen), copy_rate)
    small32 = kernel_times(
        tuple(c.to(i32) for c in q6["cols"]), copy_rate)

    dense_q1 = dense_times(*q1["dense_args"], copy_rate)
    vals = torch.randint(0, 256, (2**23,), generator=gen, device="cuda",
                         dtype=i32)
    dense_hist = dense_times(vals, 256, [], [], copy_rate,
                             library=lambda: torch.bincount(vals,
                                                            minlength=256))
    gather_q15 = gather_times(*q15["gather_args"], copy_rate)
    n = q6["cols"][0].shape[0]
    perm = torch.randperm(n, generator=gen, device="cuda")
    gather_one = gather_times([q6["cols"][3]], perm, copy_rate)
    gather_one32 = gather_times([q6["cols"][0]], perm.to(i32), copy_rate)
    scatter_q15 = scatter_times(*q15["scatter_args"], copy_rate)
    scatter_perm = scatter_times(perm, q6["cols"][3], n, None, copy_rate)
    mask = scatter_err.pop("mask")
    rank = torch.cumsum(mask, dim=0) - 1
    scatter_compact = scatter_times(rank, None, 262_144, mask, copy_rate)

    def entry(name, replaces, launches_n, err_info, at, **more):
        return {"name": name, "route": "cuda",
                "source": f"presto1_tpu_torch/ops/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches_n,
                **err_info, "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at.get("library_ms"), "card": card, **more}

    kernels = [
        entry("filter_sum", "presto1_tpu/ops/kernels/filter_sum.py:84",
              launches["filter_sum"], {"max_abs_err": err}, at_engine,
              shape="TPC-H SF1 lineitem, int32 + 3 x int64 columns",
              at_engine_shape=at_engine, at_engine_shape_all_int32=small32,
              at_2p27_rows=big),
        entry("dense_group_agg",
              "experiments/pallas_primitives2.py:263, "
              "experiments/pallas_primitives3.py:57",
              launches["dense_group_agg"], dense_err, dense_q1,
              shape="TPC-H Q1 at SF1: 12-word domain, its 12 slots over 5 "
                    "int64 columns, as the engine hands them over",
              at_engine_shape=dense_q1, at_histogram_2p23_x_256=dense_hist),
        entry("scatter",
              "experiments/pallas_primitives.py:102, "
              "experiments/pallas_primitives.py:250",
              launches["scatter"], {"max_abs_err": scatter_err["max_abs_err"]},
              scatter_q15,
              shape="the Q15 view's largest scatter at SF1: compaction of "
                    "the group boundaries among 6,002,010 sorted rows",
              at_engine_shape=scatter_q15,
              at_compaction_of_view_density_mask=scatter_compact,
              at_6m_row_permutation_int64=scatter_perm),
        entry("gather",
              "experiments/pallas_primitives.py:54, "
              "experiments/pallas_primitives.py:78, "
              "experiments/pallas_primitives2.py:227, "
              "experiments/pallas_primitives3.py:33",
              launches["gather"], {"max_abs_err": gather_err["max_abs_err"]},
              gather_q15,
              shape="the Q15 view's largest gather at SF1: every operand of "
                    "the grouping sort through the row permutation",
              at_engine_shape=gather_q15,
              at_one_int64_column_6m_permutation=gather_one,
              at_one_int32_column_int32_index=gather_one32),
    ]
    say("engine_summary", card=card,
        q1_ms_per_run=q1["ms_per_run"], q15view_ms_per_run=q15["ms_per_run"],
        q1_dense_kernel_ms=dense_q1["ms"],
        q15view_largest_gather_ms=gather_q15["ms"],
        q15view_largest_scatter_ms=scatter_q15["ms"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
