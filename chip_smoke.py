#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the main paths of ``presto1_tpu_torch`` on the card -- TPC-H Q6, Q1,
the revenue view of Q15 and Q3, and TPC-DS Q27 (ROLLUP: joins and a Union)
and Q93 (a LEFT join), all at scale factor 1, through ``Engine.sql`` and
``Engine.compile(...)`` / ``CompiledQuery.block_run`` -- builds every
hand-written kernel from the sources in this checkout, holds each against
its plain PyTorch version on the card (integers exactly, float64 sums to
1e-9 relative), shows from the launch counters that the main paths went
through them, checks that a compiled run never waits for the host (one run
of each statement under ``torch.cuda.set_sync_debug_mode("error")``), and
times kernel, plain version, library call and engine.  Every phase prints
one JSON line; any failed phase raises, and the exit code is then non-zero.  It needs one CUDA device, the
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


def in_turns(fns: dict, rounds: int = 4) -> dict:
    """``device_ms`` of each of ``fns`` taken in turns, forwards then
    backwards (A B C, C B A, ...): the median of ``rounds`` timings each,
    so that a drift of the card's state during the comparison falls on
    every candidate alike."""
    times = {name: [] for name in fns}
    order = list(fns)
    for k in range(rounds):
        for name in order if k % 2 == 0 else order[::-1]:
            times[name].append(device_ms(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


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


def phase_build():
    """Build every kernel source and the sector-read microbenchmark, every
    ``nvcc`` started together; returns the microbenchmark's library."""
    from presto1_tpu_torch.ops.kernels import _build

    t0 = time.time()
    finish_sector_reads = start_sector_reads_build()
    info = _build.build_all()
    sector_lib, sector_log = finish_sector_reads()
    log = "\n".join(i["log"] for i in info.values())
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sorted({ln.strip() for ln in log.splitlines()
                     if "spill" in ln and "0 bytes spill stores, "
                     "0 bytes spill loads" not in ln})
    frames = [int(f) for f in re.findall(r"(\d+) bytes stack frame", log)]
    # registers and spills of each entry (the end of its mangled name,
    # which carries the template arguments), largest first
    per_kernel, spilled, name = {}, {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)[-48:]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name and int(m.group(1)):
            spilled[name] = ln.strip()
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            per_kernel[name] = int(m.group(1))
            name = None
    say("build", seconds=time.time() - t0, sources=sorted(info),
        nvcc_seconds={n: i["seconds"] for n, i in info.items()},
        kernels_compiled=len(registers),
        max_registers=max(registers, default=None),
        max_stack_frame_bytes=max(frames, default=None), spills=spills,
        registers_by_kernel=dict(sorted(per_kernel.items(),
                                        key=lambda kv: -kv[1])[:24]),
        spills_by_kernel=spilled,
        sector_reads_registers=[int(r) for r in re.findall(
            r"Used (\d+) registers", sector_log)])
    return sector_lib


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


def _int_case(n: int, groups: int, gen, word_dtype=torch.int64,
              valid: bool = False):
    """An integer-only recipe (the int path's): every integer op over two
    int64, an int32 and a bool column, four slots reading the first int64
    column and four the int32 one; validity on some slots when ``valid``.
    11 slots: at 32 groups the int path's thread tables leave room for
    fewer than 64 threads, so the wrapper takes the general path there and
    the check forces the int path at 32 threads."""
    word = torch.randint(-1, groups + 1, (n,), generator=gen, device="cuda",
                         dtype=word_dtype)
    i64 = torch.randint(-2**62, 2**62, (n,), generator=gen, device="cuda",
                        dtype=torch.int64)
    i32 = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                        device="cuda", dtype=torch.int32)
    flag = torch.rand((n,), generator=gen, device="cuda") > 0.5
    other = torch.randint(-2**40, 2**40, (n,), generator=gen, device="cuda",
                          dtype=torch.int64)
    v1 = v2 = None
    if valid:
        v1 = torch.rand((n,), generator=gen, device="cuda") > 0.3
        v2 = torch.rand((n,), generator=gen, device="cuda") > 0.6
    columns = [i64, i32, flag, other]
    slots = [("sum", 0, None), ("low", 0, v1), ("high", 0, None),
             ("min", 0, v2), ("sum", 1, v2), ("min", 1, None),
             ("max", 1, v1), ("high", 1, v2), ("sum", 2, None),
             ("count", None, v1), ("max", 3, None)]
    return word, columns, slots


def phase_kernel_check_dense(gen) -> dict:
    """``dense_group_agg`` against its plain version on the card: integer
    outputs exactly, float64 outputs to 1e-9 relative (the summation order
    differs), and two runs of the kernel bit for bit -- through the path
    the wrapper picks and through every other path that takes the recipe
    (``int``, ``general``, ``hist``)."""
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D

    worst_int, worst_rel, cases = 0, 0.0, 0
    by_path = {}

    def hold(word, groups, columns, slots, what,
             paths=("int", "general", "hist")):
        nonlocal worst_int, worst_rel, cases
        want = D.dense_group_agg_plain(word, groups, columns, slots)
        n = word.shape[0]
        picked = None
        if n:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            desc = ([c.dtype for c in columns],
                    [(op, c, None if v is None else v.data_ptr())
                     for op, c, v in slots])
            picked = D.plan_dense(n, groups, *desc, sms).path
        for path in (None,) + tuple(p for p in paths if p != picked):
            if path is not None:
                if not n:
                    continue
                try:
                    D.plan_dense(n, groups, *desc, sms, path)
                except ValueError:
                    continue  # the recipe does not fit that path
            got = D._dense_group_agg(word, groups, columns, slots, path)
            again = D._dense_group_agg(word, groups, columns, slots, path)
            torch.cuda.synchronize()
            tag = f"{what}, path {path or picked}"
            for name in ("counts", "first_row", "table"):
                if not torch.equal(getattr(got, name), getattr(again, name)):
                    raise AssertionError(f"dense_group_agg: two runs differ "
                                         f"in {name} ({tag})")
            pairs = [("counts", got.counts, want.counts),
                     ("first_row", got.first_row, want.first_row)]
            pairs += [(f"slot {k} {slots[k][0]}", got.slot(k), want.slot(k))
                      for k in range(len(slots))]
            for name, a, b in pairs:
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(
                        f"dense_group_agg {name}: {a.dtype} "
                        f"{tuple(a.shape)} vs plain {b.dtype} "
                        f"{tuple(b.shape)} ({tag})")
                if a.dtype == torch.float64:
                    rel = _rel_err(a, b)
                    worst_rel = max(worst_rel, rel)
                    if not rel <= 1e-9:
                        raise AssertionError(
                            f"dense_group_agg {name}: relative error {rel} "
                            f"against its plain version ({tag})")
                else:
                    err = int((a.to(torch.int64) - b.to(torch.int64))
                              .abs().max()) if a.numel() else 0
                    worst_int = max(worst_int, err)
                    if err != 0:
                        raise AssertionError(
                            f"dense_group_agg {name} disagrees with its "
                            f"plain version ({tag}): kernel {a.tolist()} "
                            f"plain {b.tolist()}")
            key = path or picked or "no launch"
            by_path[key] = by_path.get(key, 0) + 1
            cases += 1
        return picked

    # the probes' own shape: 2^23 int32 values over 256 bins, no slot
    vals = torch.randint(0, 256, (2**23,), generator=gen, device="cuda",
                         dtype=torch.int32)
    if hold(vals, 256, [], [], "histogram 2^23 x 256") != "hist":
        raise AssertionError("the histogram did not take the hist path")
    hist = D.dense_group_agg(vals, 256, [], []).counts
    if not torch.equal(hist, torch.bincount(vals, minlength=256)):
        raise AssertionError("histogram disagrees with torch.bincount")
    # histograms of both word types, off the 16-byte grid, few rows
    for wdt in (torch.int32, torch.int64):
        w = torch.randint(-2, 40, (100_003,), generator=gen, device="cuda",
                          dtype=wdt)
        for lo in (0, 1, 3):
            for n in (1, 3, 5, 17, 4099, 100_000):
                hold(w[lo:lo + n], 37, [], [],
                     f"histogram {wdt}, rows {lo}..{lo + n}")
        hold(torch.full((70_001,), 4, dtype=wdt, device="cuda"), 37, [], [],
             f"histogram {wdt}, one bin")
    # the engine's shape: Q1's domain and recipe at SF1's row count
    word, columns, slots = _q1_like(6_002_010, gen)
    if hold(word, 12, columns, slots, "Q1 recipe, 6,002,010 rows") != "int":
        raise AssertionError("Q1's recipe did not take the int path")
    hold(word.to(torch.int32), 12, columns, slots, "Q1 recipe, int32 word")
    # integer-only recipes at 1, 12, 32 and 256 groups (256: past the int
    # path's budget, so the general path)
    for groups in (1, 12, 32, 256):
        for n in (1, 2, 3, 4099, 1_000_003):
            for wdt in (torch.int64, torch.int32):
                for valid in (False, True):
                    word, columns, slots = _int_case(n, groups, gen, wdt,
                                                     valid)
                    hold(word, groups, columns, slots,
                         f"integer recipe n={n} G={groups} {wdt} "
                         f"valid={valid}")
    # views off the 16-byte grid: all shifted alike by one and by two
    # elements (int64 and int32 words, with and without validity), and the
    # word shifted against its columns
    for wdt in (torch.int64, torch.int32):
        for valid in (False, True):
            word, columns, slots = _int_case(70_002, 12, gen, wdt, valid)
            for lo in (1, 2):
                shift = [(op, c, None if v is None else v[lo:])
                         for op, c, v in slots]
                hold(word[lo:], 12, [c[lo:] for c in columns], shift,
                     f"integer recipe, views from row {lo}, {wdt} word, "
                     f"valid={valid}")
    word, columns, slots = _int_case(70_002, 12, gen, valid=True)
    shift = [(op, c, None if v is None else v[1:]) for op, c, v in slots]
    keep = [(op, c, None if v is None else v[:-1]) for op, c, v in slots]
    hold(word[1:], 12, [c[:-1] for c in columns], keep,
         "integer recipe, word off its columns' grid")
    hold(word[:-1], 12, [c[1:] for c in columns], shift,
         "integer recipe, columns off the word's grid")
    # float64 slots next to integer ones, every op, validity (general path)
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
    for case in (_mixed_case, _int_case):
        word, columns, slots = case(50_000, 12, gen)
        hold(torch.full_like(word, 12), 12, columns, slots, "all dead")
        hold(torch.full_like(word, 5), 12, columns, slots, "one group")
    say("kernel_check", kernel="dense_group_agg", cases=cases,
        cases_by_path=by_path, max_abs_err=worst_int,
        f64_max_rel_err=worst_rel,
        tolerance={"integers": 0, "float64_relative": 1e-9,
                   "two_runs": "bit-equal"})
    return {"max_abs_err": float(worst_int), "f64_max_rel_err": worst_rel,
            "cases_by_path": by_path}


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
    the card, exactly: the probes' shapes, a batch at a 6M permutation,
    edge sizes, more than 32 columns and mixed widths with nested rows in
    one launch, unaligned sources and outputs, sources beyond the L2
    budget (column groups), 64-bit offsets."""
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
    # the row body's own shapes: more than 32 columns in ONE launch, mixed
    # 1/2/4/8-byte columns with nested [n, W] sources in one launch, both
    # index widths
    launches = {}

    def one_call(sources, idx, what):
        before = G.LAUNCHES
        hold_rows(sources, idx, what)
        launches[what] = G.LAUNCHES - before

    mixed = [_values((100_003,), dt, gen) for dt in _MOVE_DTYPES * 6]
    one_call(mixed, index(-5, 100_010, (70_001,)), "42 columns, 7 widths")
    nested = [_values((50_001,), dt, gen) for dt in _MOVE_DTYPES] + [
        _values((50_001, 3), torch.int64, gen),
        _values((50_001, 5), torch.int16, gen),
        _values((50_001, 2), torch.int32, gen)]
    for idt in (torch.int32, torch.int64):
        one_call(nested, index(-5, 50_010, (33_335,), idt),
                 f"mixed widths and nested rows, {idt}")
    for what, n_launch in launches.items():
        if n_launch != 1:
            raise AssertionError(f"gather_rows made {n_launch} launches for "
                                 f"{what}; one is the design")
    # outputs that start off a 16-byte boundary (views of larger buffers)
    srcs = [_values((40_000,), dt, gen) for dt in _MOVE_DTYPES]
    idx = index(0, 40_000, (30_001,), torch.int32)
    outs = [s.new_empty((30_001 + 3,))[3:] for s in srcs]
    G._gather(srcs, outs, idx)
    torch.cuda.synchronize()
    for a, b in zip(outs, G.gather_rows_plain(srcs, idx)):
        worst = max(worst, _abs_err(a, b))
        if not torch.equal(a, b):
            raise AssertionError("gather into unaligned outputs disagrees")
    cases += 1
    # sources beyond the L2 budget through a random index: column groups
    n = 6_002_010
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    big = [_values((n,), torch.int64, gen) for _ in range(4)]
    plan = G.plan_gather(n, n, [(8, 1)] * 4, 1, l2)
    if plan.groups < 2:
        raise AssertionError(f"4 int64 columns of {n} rows took one pass "
                             f"under an L2 of {l2} bytes: {plan}")
    perm = torch.randperm(n, generator=gen, device="cuda")
    hold_rows(big, perm, f"4 x int64 of 6M rows, {plan.groups} groups")
    del big, perm
    # 64-bit offsets: a 1-D int8 source of more than 4 GiB
    huge = torch.empty((2**32 + 4099,), dtype=torch.int8, device="cuda")
    huge[-70_000:] = _values((70_000,), torch.int8, gen)
    hold_rows([huge], index(2**32 - 60_000, 2**32 + 4099, (100_001,)),
              "int8 source past 4 GiB (64-bit offsets)")
    del huge
    say("kernel_check", kernel="gather", cases=cases, max_abs_err=worst,
        tolerance=0, launches_per_call=launches)
    return {"max_abs_err": worst}


def phase_kernel_check_scatter(gen) -> dict:
    """``scatter_distinct`` against its plain version on the card, exactly
    (one column and several sharing the index and mask), and ``compact``
    against ``torch.nonzero`` and its plain version."""
    from presto1_tpu_torch.ops.kernels import scatter as S
    from presto1_tpu_torch.ops.segments import compact_indices

    cases, worst = 0, 0.0

    def hold(idx, x, size, mask, what):
        nonlocal cases, worst
        got = S.scatter_distinct(idx, x, size, mask)
        torch.cuda.synchronize()
        want = S.scatter_distinct_plain(idx, x, size, mask)
        if isinstance(x, list) != isinstance(got, list):
            raise AssertionError(f"scatter_distinct: a list is answered by "
                                 f"a list ({what})")
        for a, b in zip(*((got, want) if isinstance(got, list)
                          else ([got], [want])), strict=True):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"scatter_distinct: {a.dtype} "
                                     f"{tuple(a.shape)} vs plain {b.dtype} "
                                     f"{tuple(b.shape)} ({what})")
            worst = max(worst, _abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"scatter_distinct disagrees with its "
                                     f"plain version ({what})")
        cases += 1

    compactions = 0

    def hold_compact(mask, capacity, what):
        nonlocal compactions, worst
        idx, count = S.compact(mask, capacity)
        torch.cuda.synchronize()
        want = torch.nonzero(mask)[:, 0]
        live = min(capacity, int(want.shape[0]))
        plain_idx, plain_count = S.compact_plain(mask, capacity)
        if idx.dtype != torch.int64 or tuple(idx.shape) != (capacity,) \
                or count.dtype != plain_count.dtype or count.dim() != 0:
            raise AssertionError(f"compact: {idx.dtype} {tuple(idx.shape)}, "
                                 f"count {count.dtype} {tuple(count.shape)} "
                                 f"({what})")
        if int(count) != int(want.shape[0]) \
                or not torch.equal(idx[:live], want[:live]) \
                or bool(idx[live:].any()):
            raise AssertionError(f"compact disagrees with torch.nonzero "
                                 f"({what})")
        if not torch.equal(idx, plain_idx) \
                or not torch.equal(count, plain_count):
            raise AssertionError(f"compact disagrees with its plain version "
                                 f"({what})")
        worst = max(worst, _abs_err(idx, plain_idx))
        compactions += 1

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
            # several columns through one index and mask: mixed widths, and
            # as many columns as one launch takes
            xs = [_values((n,), dt, gen) for dt in
                  (torch.int32, torch.int64, torch.float64)]
            hold(perm.to(idt), xs, n, mask, f"n={n} {idt} 3 columns")
            hold(perm.to(idt) - 5, (xs * 3)[:S.MAX_COLUMNS],
                 max(n // 2, 1), None,
                 f"n={n} {idt} {S.MAX_COLUMNS} columns, out of range")
    try:  # more columns than one launch takes: refused, not split
        S.scatter_distinct(perm, [perm] * (S.MAX_COLUMNS + 1), n)
    except ValueError:
        pass
    else:
        raise AssertionError(f"scatter_distinct took {S.MAX_COLUMNS + 1} "
                             f"columns")
    # views that start off a 16-byte boundary
    perm = torch.randperm(70_001, generator=gen, device="cuda")
    hold(perm[1:], _values((70_001,), torch.float64, gen)[1:], 70_001,
         (perm > 9)[1:], "unaligned views")
    for lo in (1, 5, 15):
        m = (torch.rand((70_016,), generator=gen, device="cuda") < 0.3)[lo:]
        p = torch.randperm(m.shape[0], generator=gen, device="cuda")
        hold(p, [p.to(torch.int32), p], m.shape[0], m,
             f"mask {lo} bytes off the grid, 2 columns")
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
        hold(rank, [_values((n,), torch.int32, gen), rank.to(torch.int32)],
             capacity, mask, f"merge_join's two columns into {capacity}")
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
    # the compaction: densities 0, 0.1 %, 3.6 %, 50 % and 100 %; row counts
    # around the 16-row lane and the 4096-row tile; capacities below, at
    # and above the count; views off the 16-byte grid
    for density in (0.0, 0.001, 0.036, 0.5, 1.0):
        for n in (1, 15, 16, 17, 4095, 4097, 1_000_003, 6_002_010):
            m = torch.rand((n + 15,), generator=gen, device="cuda") < density
            if density == 1.0:
                m[:] = True
            for lo in ((0, 7, 15) if n < 10**6 else (0, 3)):
                view = m[lo:lo + n]
                k = int(view.sum())
                for capacity in sorted({0, k // 2, k, k + 100, n + 17}):
                    hold_compact(view, capacity,
                                 f"density {density}, n={n}, {lo} bytes off "
                                 f"the grid, capacity {capacity}")
    say("kernel_check", kernel="scatter", cases=cases, max_abs_err=worst,
        compactions=compactions, tolerance=0)
    return {"max_abs_err": worst, "mask": mask, "compactions": compactions}


def phase_kernel_check_dyncopy(gen) -> dict:
    """``concat_rows`` against the plain version on the card, exactly: the probes' own shapes, a two-part UNION ALL at
    fact-table size, a FULL join's shape with an empty part, nested rows of
    two widths, counts of 0, at capacity, past capacity and below zero,
    every element width, more pairs than one launch holds, views off a
    16-byte boundary, parts at odd row offsets, and one launch for every
    call of several widths."""
    from presto1_tpu_torch.batch import round_capacity
    from presto1_tpu_torch.ops.kernels import dyncopy as DC

    cases, worst = 0, 0.0

    def hold(columns, counts, capacity, what):
        """The kernel against the plain version; returns the kernel's
        launches for the call."""
        nonlocal cases, worst
        counts = torch.tensor(counts, dtype=torch.int64, device="cuda")
        want = DC.concat_rows_plain(columns, counts, capacity)
        before = DC.LAUNCHES
        got = DC.concat_rows(columns, counts, capacity)
        torch.cuda.synchronize()
        launched = DC.LAUNCHES - before
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(
                    f"concat_rows column {k}: {a.dtype} {tuple(a.shape)} "
                    f"vs plain {b.dtype} {tuple(b.shape)} ({what})")
            worst = max(worst, _abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"concat_rows column {k} disagrees with its plain "
                    f"version ({what})")
        cases += 1
        return launched

    def part(n, dtypes, width=None):
        return [_values((n,) if width is None else (n, width), dt, gen)
                for dt in dtypes]

    i32, i64 = torch.int32, torch.int64
    # the probes' own shapes: int32 copies of a dynamic size (t3), to a
    # dynamic offset (t4, t4b/c), 2-D rows (t4a, t5b), many small copies
    # at dynamic offsets (t6, t6x, t6p)
    src = part(8192, [i32])[0]
    for n in (0, 1, 1000, 8192):
        hold([[src]], [n], 8192, f"t3 one part, {n} of 8192")
    a, b = part(2048, [i32])[0], part(2048, [i32])[0]
    for na, nb in ((0, 5), (7, 2048), (1024, 1024), (2048, 2048)):
        hold([[a, b]], [na, nb], 4096, f"t4 two parts {na}+{nb}")
    a, b = part(1024, [i32], 128)[0], part(1024, [i32], 128)[0]
    hold([[a, b]], [300, 700], 1024, "t4a/t5b [1024,128] rows")
    smalls = [part(64, [i32])[0] for _ in range(32)]
    counts = torch.randint(0, 65, (32,), generator=gen, device="cuda")
    hold([smalls], counts.tolist(), 2048, "t6x 32 parts of 64 rows")
    # the engine's shape at fact-table size: a two-part UNION ALL of 8
    # int64 columns, store_sales' and catalog_sales' SF1 row counts, with a
    # validity mask on one side
    na, nb = 2_880_404, 1_441_548
    cols_a, cols_b = part(na, [i64] * 8), part(nb, [i64] * 8)
    mask_b = torch.rand((nb,), generator=gen, device="cuda") > 0.02
    fact = [[x, y] for x, y in zip(cols_a, cols_b)] + [[None, mask_b]]
    cap = round_capacity(na + nb)
    hold(fact, [na, nb], cap, "UNION ALL 2,880,404 + 1,441,548 rows")
    hold(fact, [na - 17, nb - 3], cap, "UNION ALL, short counts")
    # a FULL join's shape: the anti part (or the pairs) empty
    for counts in ((na, 0), (0, nb)):
        hold(fact, list(counts), cap, f"FULL join, counts {counts}")
    # nested [n, W] rows of two widths, their lengths and validity
    a = [_values((1000, 3), i64, gen), _values((1000,), i32, gen),
         _values((1000,), torch.bool, gen)]
    b = [_values((500, 7), i64, gen), _values((500,), i32, gen), None]
    hold([[a[0], b[0]], [a[1], b[1]], [a[2], b[2]]], [1000, 480], 1536,
         "nested widths 3 and 7")
    hold([[a[0], b[0]]], [999, 500], 1500, "nested, count at capacity")
    # counts of 0, at capacity, past it and below zero: clamped
    a, b, c = (part(n, _MOVE_DTYPES) for n in (3000, 1, 2049))
    cols = [list(t) for t in zip(a, b, c)]
    for counts in ((0, 0, 0), (3000, 1, 2049), (5000, 9, 10**12),
                   (-4, 1, -1), (17, 0, 2049)):
        for capacity in (1, 2048, 5050, 8192):
            hold(cols, list(counts), capacity,
                 f"every width, counts {counts}, capacity {capacity}")
    # more pairs than one launch holds (80 int32 columns of 2 parts)
    a, b = part(4099, [i32] * 40), part(777, [i32] * 40)
    hold([list(t) for t in zip(a, b)], [4000, 777], 5000, "80 pairs")
    # 16-byte rows, and views that start off a 16-byte boundary
    a, b = part(7001, [i64], 2)[0], part(3001, [i64], 2)[0]
    hold([[a, b]], [7001, 3001], 10240, "16-byte rows")
    a = [t[1:] for t in part(70_001, _MOVE_DTYPES)]
    b = [t[3:] for t in part(20_003, _MOVE_DTYPES)]
    hold([list(t) for t in zip(a, b)], [69_000, 20_000], 90_000,
         "unaligned views")
    hold([list(t) for t in zip(a, b)], [69_000, 20_000], 0, "capacity 0")
    # ONE launch a call: parts at odd row offsets for int32, int16 and bool
    # columns, three widths (and a nested column) in one call, more than 32
    # (column, part) pairs
    launches = {}

    def one_call(columns, counts, capacity, what):
        launches[what] = hold(columns, counts, capacity, what)

    odd = [part(n, [i32, torch.int16, torch.bool]) for n in (1001, 777, 33)]
    cols = [list(t) for t in zip(*odd)]
    for counts in ((1001, 777, 33), (999, 775, 31), (1, 3, 5), (0, 777, 1)):
        one_call(cols, list(counts), 2048,
                 f"odd row offsets, counts {counts}")
    three = [part(n, [i64, i32, torch.bool]) + [_values((n, 3), i64, gen)]
             for n in (5003, 4001, 3)]
    cols = [list(t) for t in zip(*three)]
    cols[2][1] = None  # a part without a validity mask
    one_call(cols, [5003, 3999, 3], 10_000, "3 widths and a nested column")
    a = part(1003, [i32, torch.int16, torch.bool, i64] * 10)
    b = part(501, [i32, torch.int16, torch.bool, i64] * 10)
    one_call([list(t) for t in zip(a, b)], [1001, 501], 2000,
             "80 pairs of 4 widths")
    for what, n_launch in launches.items():
        if n_launch != 1:
            raise AssertionError(f"concat_rows made {n_launch} launches for "
                                 f"{what}; one is the design")
    say("kernel_check", kernel="dyncopy", cases=cases, max_abs_err=worst,
        tolerance=0, launches_per_call=launches)
    return {"max_abs_err": worst,
            "fact_args": (fact, torch.tensor([na, nb], dtype=i64,
                                             device="cuda"), cap)}


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


def _cuda_rows(fn, reps: int, units: int = 0) -> list:
    """(kernel name, ms, launches) of ``reps`` calls of ``fn`` from
    ``torch.profiler``'s device rows, divided by ``units`` (default: by
    ``reps``), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator's row repeats its kernels' time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            per = units or reps
            rows.append((ev.key[:72], us / per / 1e3, ev.count / per))
    rows.sort(key=lambda r: -r[1])
    return rows


def kernel_rows_ms(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` as the sum of its kernel rows in
    ``torch.profiler`` (memsets included), after two warm-up calls: for
    calls that read a value back to the host (``torch.bincount``,
    ``torch.nonzero``), which a CUDA graph cannot capture and whose
    enqueued-event time includes the readback.  None where the profiler
    sees no device activity."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    rows = _cuda_rows(fn, reps)
    if not rows:
        return {"ms": None, "kernels": None, "rows": []}
    return {"ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "rows": [list(r) for r in rows[:6]]}


def _profile(cq, reps: int = 5) -> dict:
    """Device time of a compiled run by kernel name, from ``torch.profiler``
    over ``reps`` runs: the sum, and the dozen largest.  Where the profiler
    sees no device activity the sum is None and nothing is claimed."""
    cq.block_run(reps=2)
    rows = _cuda_rows(lambda: cq.block_run(reps=reps), 1, units=reps)
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
    tensor arguments) of a kernel wrapper, wherever the port bound its name,
    and the largest call of each kind (dtypes and ranks of the arguments).
    Used outside the launch-counted steps, to hold each kernel against its
    plain version and to time it afterwards at the shapes the main path gave
    it."""

    def __init__(self, name: str, modules):
        self.name, self.modules = name, modules
        self.args, self.bytes = None, -1
        self.calls = {}  # kind of call -> (bytes, args, kwargs)

    @staticmethod
    def _kind(x):
        if isinstance(x, torch.Tensor):
            return (str(x.dtype), x.dim())
        if isinstance(x, (list, tuple)):
            return tuple(_Tap._kind(y) for y in x)
        return type(x).__name__

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
            size = self._nbytes(args) + self._nbytes(list(kwargs.values()))
            if size > self.bytes:
                self.args, self.bytes = args, size
            kind = self._kind((args, sorted(kwargs.items())))
            if size > self.calls.get(kind, (-1,))[0]:
                self.calls[kind] = (size, args, kwargs)
            return self.orig(*args, **kwargs)

        for m in self.modules:
            setattr(m, self.name, tapped)
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            setattr(m, self.name, self.orig)


def _launch_counters() -> dict:
    """Every kernel wrapper's launch counter: name -> (module, attribute).
    ``compact`` counts calls of the compaction, each of which launches the
    scatter source's two compaction kernels."""
    from presto1_tpu_torch.ops.kernels import (
        dense_group_agg as D, dyncopy as DC, filter_sum as F, gather as G,
        scatter as S)

    return {"filter_sum": (F, "LAUNCHES"), "dense_group_agg": (D, "LAUNCHES"),
            "gather": (G, "LAUNCHES"), "scatter": (S, "LAUNCHES"),
            "compact": (S, "COMPACT_LAUNCHES"), "dyncopy": (DC, "LAUNCHES")}


def _kernel_taps():
    """Taps on ``gather_rows``, ``scatter_distinct`` and ``compact`` in
    every module of the port that binds them."""
    from presto1_tpu_torch.ops import common as C, hashagg as H, \
        join as J, segments as SEG
    from presto1_tpu_torch.ops.kernels import gather as G, scatter as S

    # batch.py looks gather_rows up in G at each call
    return (_Tap("gather_rows", [G, C, H, SEG, J]),
            _Tap("scatter_distinct", [S, J]), _Tap("compact", [S, SEG]))


# the wrapper each launch counter's kernel is tapped at
_TAPPED = {"gather": "gather_rows", "scatter": "scatter_distinct",
           "compact": "compact"}


def _hold_taps(what: str, taps, must) -> dict:
    """Every call a tap kept (the largest of each kind a path made) through
    the kernel and through its plain version on the same inputs: equal by
    ``torch.equal``, or the run fails.  ``must`` names the wrappers the path
    has to have called: a tap among them that caught no call fails the run
    (a module that reached the kernel around the tapped name).  Returns,
    per kernel, the calls held and the measured largest |difference|."""
    from presto1_tpu_torch.ops.kernels import gather as G, scatter as S

    plain = {"gather_rows": G.gather_rows_plain,
             "scatter_distinct": S.scatter_distinct_plain,
             "compact": S.compact_plain}
    out = {}
    for tap in taps:
        worst, most = 0.0, 0
        for kind, (size, args, kwargs) in tap.calls.items():
            got = tap.orig(*args, **kwargs)
            want = plain[tap.name](*args, **kwargs)
            if isinstance(got, torch.Tensor):
                got, want = [got], [want]
            for a, b in zip(got, want, strict=True):
                if a.shape != b.shape or a.dtype != b.dtype \
                        or not torch.equal(a, b):
                    raise AssertionError(
                        f"{tap.name} disagrees with its plain version on "
                        f"{what}'s call {kind}")
                worst = max(worst, _abs_err(a, b))
            most = max(most, size)
        if not tap.calls and tap.name in must:
            raise AssertionError(f"{what} made no call of {tap.name}")
        out[tap.name] = {"calls_held": len(tap.calls),
                         "largest_input_bytes": most, "max_abs_err": worst}
    return out


def _engine_steps(engine, sql: str, check, reps: int) -> dict:
    """Drive one statement down the main path -- ``Engine.sql``,
    ``Engine.compile`` (its discovery run), ``cq()``, ``block_run(reps)`` --
    with every kernel's launch counter set to 0 just before and read around
    each step, then one more compiled run with PyTorch's synchronisation
    check set to raise.  ``check(batch)`` holds a result against the host
    reference."""
    counters = _launch_counters()
    for m, attr in counters.values():
        setattr(m, attr, 0)

    def read():
        return {k: getattr(m, attr) for k, (m, attr) in counters.items()}

    marks = [read()]
    eager = engine.sql(sql)
    marks.append(read())
    cq = engine.compile(sql)
    marks.append(read())
    compiled = cq()
    marks.append(read())
    rows_out = cq.block_run(reps=reps)
    marks.append(read())
    # a compiled run enqueues its work without waiting for the card: a
    # synchronising call anywhere in its fragments raises here (the one
    # readback is not part of ``_run``)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cq._run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(eager, "Engine.sql")
    check(compiled, "CompiledQuery()")
    if rows_out != compiled.num_rows:
        raise AssertionError(f"block_run returned {rows_out} rows, cq() "
                             f"{compiled.num_rows}")
    names = ("sql", "compile", "call", f"block_run_{reps}")
    steps = {k: {s: marks[i + 1][k] - marks[i][k]
                 for i, s in enumerate(names)} for k in counters}
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
    if steps["gather"]["call"] < 1 or steps["compact"]["call"] < 1:
        raise AssertionError("Q1 did not go through gather and the "
                             "compaction")
    _assert_resident(run["cq"], n)
    with _Tap("dense_group_agg", [H]) as tap:  # outside the counted steps
        check(engine.sql(sql), "Engine.sql (tapped)")
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    ms = sum(ms_trials) / 2
    profile = _profile(run["cq"])
    say("q1_engine", sf=catalog.sf, lineitem_rows=n, load_seconds=load_s,
        groups=len(want), rows=[list(r) for r in want],
        launches=run["launches"], launches_per_step=steps,
        ms_per_run=ms, ms_trials=ms_trials, rows_per_s=n / (ms * 1e-3),
        profile=profile,
        agrees_with=["numpy int64 (sums and counts exactly, averages to "
                     "1e-9 relative)", "eager == compiled"])
    word, groups, columns, slots = tap.args
    return {"launches": run["launches"], "ms_per_run": ms,
            "profile": profile,
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
    if steps["gather"]["call"] < 1 or steps["compact"]["call"] < 1:
        raise AssertionError("the Q15 view did not go through gather and "
                             "the compaction")
    if steps["dense_group_agg"]["call"] != 0:
        raise AssertionError("the Q15 view took the dense path")
    _assert_resident(run["cq"], n)
    # outside the counted steps: the gathers and scatters of a run
    taps = _kernel_taps()
    with taps[0], taps[1], taps[2]:
        check(engine.sql(Q15_REVENUE_VIEW), "Engine.sql (tapped)")
    held = _hold_taps("the Q15 view", taps, must=("gather_rows", "compact"))
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    ms = sum(ms_trials) / 2
    profile = _profile(run["cq"])
    say("q15view_engine", sf=catalog.sf, lineitem_rows=n,
        load_seconds=load_s, groups=len(want_keys), rows_selected=selected,
        first_rows=[[int(a), int(b)] for a, b in
                    zip(want_keys[:3], want_sums[:3])],
        launches=run["launches"], launches_per_step=steps,
        ms_per_run=ms, ms_trials=ms_trials, rows_per_s=n / (ms * 1e-3),
        profile=profile, held_against_plain=held,
        agrees_with=["numpy int64 exactly", "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": ms, "held": held,
            "profile": profile,
            "gather_args": taps[0].args, "compact_args": taps[2].args}


def _load_columns(catalog, table: str, names) -> tuple:
    """Columns of one table on the card; (host data, host validity or None,
    seconds the load took -- generation on the host included)."""
    t0 = time.time()
    t = catalog.table(table)
    dev = {c: t.column(c) for c in names}
    torch.cuda.synchronize()
    load_s = time.time() - t0
    data = {c: col.data.cpu().numpy() for c, col in dev.items()}
    valid = {c: None if col.validity is None else col.validity.cpu().numpy()
             for c, col in dev.items()}
    dicts = {c: col.dictionary for c, col in dev.items()}
    return data, valid, dicts, load_s


def _day(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01"))
               .astype(int))


def _code(dictionary, value: str) -> int:
    hits = np.nonzero(np.asarray(dictionary) == value)[0]
    if len(hits) != 1:
        raise AssertionError(f"{value!r} is not in the dictionary")
    return int(hits[0])


def _lookup(keys, values, at, valid=None):
    """values[k] for k in ``at`` where ``keys`` holds k (keys unique); a
    boolean of where it does."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    pos = np.clip(np.searchsorted(ks, at), 0, max(len(ks) - 1, 0))
    hit = (ks[pos] == at) if len(ks) else np.zeros(len(at), bool)
    if valid is not None:
        hit = hit & valid
    return values[order][pos], hit


def _engine_phase(name: str, engine, sql: str, check, reps: int = 20,
                  need=()) -> dict:
    """One statement down the main path with the launch counters read
    around each step; eager equals compiled; ms per run, the profile and
    the launches of every kernel on this path.  ``need``: kernels that
    must have launched in every compiled run, and whose wrappers the tapped
    eager run must have called."""
    run = _engine_steps(engine, sql, check, reps)
    _same_batches(run["eager"], run["compiled"], name)
    steps = run["launches_per_step"]
    for k in need:
        if steps[k]["call"] < 1:
            raise AssertionError(f"{name} did not go through {k} in a "
                                 f"compiled run: {steps[k]}")
    if not all(t.is_cuda for t in run["cq"].inputs.values()):
        raise AssertionError(f"{name}: scan inputs are not on the card")
    # outside the counted steps: every kind of gather, scatter and
    # compaction call the path makes, at its largest, against the plain
    # versions
    taps = _kernel_taps()
    with taps[0], taps[1], taps[2]:
        check(engine.sql(sql), "Engine.sql (tapped)")
    held = _hold_taps(name, taps, must=[_TAPPED[k] for k in need
                                        if k in _TAPPED])
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    return {"run": run, "ms": sum(ms_trials) / 2, "ms_trials": ms_trials,
            "profile": _profile(run["cq"]), "held": held,
            "gather_args": taps[0].args, "scatter_args": taps[1].args,
            "compact_args": taps[2].args}


def _numpy_q3(li, orders, cust, seg_code: int) -> list:
    """TPC-H Q3 over host columns in int64: the top 10 (orderkey, unscaled
    revenue at scale 4, orderdate, shippriority)."""
    d = _day("1995-03-15")
    ok_cust = np.isin(orders["o_custkey"],
                      cust["c_custkey"][cust["c_mktsegment"] == seg_code])
    osel = ok_cust & (orders["o_orderdate"] < d)
    okeys = orders["o_orderkey"][osel]
    lsel = (li["l_shipdate"] > d) & np.isin(li["l_orderkey"], okeys)
    lk = li["l_orderkey"][lsel]
    rev = li["l_extendedprice"][lsel] * (100 - li["l_discount"][lsel])
    order = np.argsort(lk, kind="stable")
    lk, rev = lk[order], rev[order]
    keys, starts = np.unique(lk, return_index=True)
    sums = np.add.reduceat(rev, starts) if len(keys) else rev[:0]
    odate, _ = _lookup(orders["o_orderkey"], orders["o_orderdate"], keys)
    prio, _ = _lookup(orders["o_orderkey"], orders["o_shippriority"], keys)
    top = np.lexsort((keys, odate, -sums))[:10]
    return [(int(keys[i]), int(sums[i]), int(odate[i]), int(prio[i]))
            for i in top]


def phase_q3_engine(catalog) -> dict:
    """TPC-H Q3 at the catalog's scale factor: two N:1 inner joins through
    ``merge_join`` (sort, scans, compaction through scatter, payload through
    gather), a clustered grouped aggregate and a TopN."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpch.queries import QUERIES

    t0 = time.time()
    li, _, _, _ = _load_columns(catalog, "lineitem",
                                ("l_orderkey", "l_extendedprice",
                                 "l_discount", "l_shipdate"))
    orders, _, _, _ = _load_columns(catalog, "orders",
                                    ("o_orderkey", "o_custkey", "o_orderdate",
                                     "o_shippriority"))
    cust, _, cdicts, _ = _load_columns(catalog, "customer",
                                       ("c_custkey", "c_mktsegment"))
    load_s = time.time() - t0
    want = _numpy_q3(li, orders, cust,
                     _code(cdicts["c_mktsegment"], "BUILDING"))
    if len(want) != 10:
        raise AssertionError("Q3 reference has fewer than 10 rows: the data "
                             "is wrong")
    types = ["bigint", "decimal(38,4)", "date", "integer"]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected Q3 output columns")
        if batch.num_rows != 10:
            raise AssertionError(f"{what}: {batch.num_rows} rows, not 10")
        for c in cols:
            if c.validity is not None and not bool(c.validity[:10].all()):
                raise AssertionError(f"{what}: NULL in Q3's output")
        got = list(zip(*[c.data[:10].cpu().tolist() for c in cols]))
        if got != want:
            raise AssertionError(f"{what}: Q3 {got} != numpy {want}")

    engine = Engine(catalog, device="cuda")
    out = _engine_phase("Q3", engine, QUERIES[3], check,
                        need=("gather", "scatter", "compact"))
    run = out["run"]
    say("q3_engine", sf=catalog.sf, load_seconds=load_s,
        lineitem_rows=catalog.table("lineitem").num_rows,
        orders_rows=catalog.table("orders").num_rows,
        customer_rows=catalog.table("customer").num_rows,
        rows=[list(r) for r in want], launches=run["launches"],
        launches_per_step=run["launches_per_step"], ms_per_run=out["ms"],
        ms_trials=out["ms_trials"], profile=out["profile"],
        held_against_plain=out["held"],
        agrees_with=["numpy int64 exactly (top 10 rows)",
                     "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "scatter_args": out["scatter_args"],
            "gather_args": out["gather_args"]}


def _numpy_q27(catalog) -> tuple:
    """TPC-DS Q27 over host columns: rows of (i_item_id, s_state, four
    averages) in the statement's order, every ROLLUP level; averages as
    the engine computes them (the int64 sum as a double over count x
    10^scale).  Returns (rows, load seconds)."""
    t0 = time.time()
    ss, ssv, _, _ = _load_columns(
        catalog, "store_sales",
        ("ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk", "ss_store_sk",
         "ss_quantity", "ss_list_price", "ss_sales_price", "ss_coupon_amt"))
    cd, _, cdd, _ = _load_columns(
        catalog, "customer_demographics",
        ("cd_demo_sk", "cd_gender", "cd_marital_status",
         "cd_education_status"))
    dd, _, _, _ = _load_columns(catalog, "date_dim", ("d_date_sk", "d_year"))
    st, _, std, _ = _load_columns(catalog, "store", ("s_store_sk", "s_state"))
    it, _, itd, _ = _load_columns(catalog, "item",
                                  ("i_item_sk", "i_item_id", "i_manager_id"))
    load_s = time.time() - t0
    cd_ok = ((cd["cd_gender"] == _code(cdd["cd_gender"], "F"))
             & (cd["cd_marital_status"] == _code(cdd["cd_marital_status"],
                                                 "W"))
             & (cd["cd_education_status"]
                == _code(cdd["cd_education_status"], "Primary")))
    ok1, hit1 = _lookup(cd["cd_demo_sk"], cd_ok, ss["ss_cdemo_sk"],
                        ssv["ss_cdemo_sk"])
    ok2, hit2 = _lookup(dd["d_date_sk"], dd["d_year"] == 1998,
                        ss["ss_sold_date_sk"], ssv["ss_sold_date_sk"])
    item_ok = it["i_manager_id"] == 5
    ok3, hit3 = _lookup(it["i_item_sk"], item_ok, ss["ss_item_sk"],
                        ssv["ss_item_sk"])
    item_id, _ = _lookup(it["i_item_sk"], it["i_item_id"], ss["ss_item_sk"])
    state, hit4 = _lookup(st["s_store_sk"], st["s_state"],
                          ss["ss_store_sk"], ssv["ss_store_sk"])
    m = ok1 & hit1 & ok2 & hit2 & ok3 & hit3 & hit4
    ids = itd["i_item_id"][item_id[m]]
    states = std["s_state"][state[m]]
    vals = [ss[c][m].astype(np.int64) for c in
            ("ss_quantity", "ss_list_price", "ss_coupon_amt",
             "ss_sales_price")]
    scales = (1, 100, 100, 100)

    def avgs(sel):
        c = int(sel.sum())
        return [float(v[sel].sum()) / (c * s) for v, s in zip(vals, scales)]

    rows = []
    for i in sorted(set(ids.tolist())):
        mi = ids == i
        for s in sorted(set(states[mi].tolist())):
            rows.append((i, s, *avgs(mi & (states == s))))
        rows.append((i, None, *avgs(mi)))
    if m.any():
        rows.append((None, None, *avgs(np.ones(int(m.sum()), bool))))
    return rows, int(m.sum()), load_s


def phase_q27_engine(catalog) -> dict:
    """TPC-DS Q27 at the catalog's scale factor: three Aggregates over four
    N:1 inner joins each (twelve ``merge_join`` calls), their rows put
    together by the Union through ``dyncopy``, and the final Sort."""
    from presto1_tpu_torch.exec import executor as X
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.ops.kernels import dyncopy as DC
    from presto1_tpu_torch.tpcds.queries import QUERIES

    want, joined, load_s = _numpy_q27(catalog)
    if joined < 10 or len(want) < 3:
        raise AssertionError(f"Q27 joins {joined} rows into {len(want)}: "
                             f"the data is wrong")
    types = ["varchar", "varchar", "double", "double", "double", "double"]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected Q27 output columns")
        if batch.num_rows != len(want):
            raise AssertionError(f"{what}: {batch.num_rows} rows, numpy "
                                 f"{len(want)}")
        k = batch.num_rows
        got = [list(c.decode(k)) for c in cols]
        for r, row in enumerate(want):
            for j, w in enumerate(row):
                g = got[j][r]
                if j >= 2:
                    ok = g is not None and abs(g - w) <= 1e-9 * abs(w)
                else:
                    ok = (g is None and w is None) or (g is not None
                                                       and str(g) == w)
                if not ok:
                    raise AssertionError(f"{what}: Q27 row {r} column {j}: "
                                         f"{g!r} != numpy {w!r}")

    engine = Engine(catalog, device="cuda")
    sql = QUERIES[27]
    out = _engine_phase("Q27", engine, sql, check,
                        need=("gather", "scatter", "compact", "dyncopy"))
    run = out["run"]
    with _Tap("concat_rows", [DC, X]) as tap:  # outside the counted steps
        check(engine.sql(sql), "Engine.sql (tapped)")
    say("q27_engine", sf=catalog.sf, load_seconds=load_s,
        store_sales_rows=catalog.table("store_sales").num_rows,
        rows_joined=joined, rows=len(want), first_rows=want[:3],
        launches=run["launches"], launches_per_step=run["launches_per_step"],
        ms_per_run=out["ms"], ms_trials=out["ms_trials"],
        profile=out["profile"], held_against_plain=out["held"],
        agrees_with=["numpy (keys exactly, averages to 1e-9 relative)",
                     "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "union_args": tap.args, "gather_args": out["gather_args"]}


def _numpy_q93(catalog) -> tuple:
    """TPC-DS Q93 over host columns in int64: the first 100 rows of
    (customer or None, unscaled net sales at scale 2)."""
    t0 = time.time()
    ss, ssv, _, _ = _load_columns(
        catalog, "store_sales",
        ("ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity",
         "ss_sales_price"))
    sr, srv, _, _ = _load_columns(
        catalog, "store_returns",
        ("sr_item_sk", "sr_ticket_number", "sr_return_quantity"))
    load_s = time.time() - t0

    def valid(v, c, n):
        return np.ones(n, bool) if v[c] is None else v[c]

    n, nr = len(ss["ss_item_sk"]), len(sr["sr_item_sk"])
    # (item, ticket) of a return is unique: pack both into one word
    width = int(max(ss["ss_ticket_number"].max(),
                    sr["sr_ticket_number"].max())).bit_length()
    rkey = (sr["sr_item_sk"] << width) | sr["sr_ticket_number"]
    skey = (ss["ss_item_sk"] << width) | ss["ss_ticket_number"]
    rvalid = valid(srv, "sr_item_sk", nr) & valid(srv, "sr_ticket_number", nr)
    ret, hit = _lookup(rkey[rvalid], sr["sr_return_quantity"][rvalid], skey,
                       valid(ssv, "ss_item_sk", n)
                       & valid(ssv, "ss_ticket_number", n))
    qty = ss["ss_quantity"].astype(np.int64)
    act = np.where(hit, qty - ret, qty) * ss["ss_sales_price"]
    cust = ss["ss_customer_sk"]
    cvalid = valid(ssv, "ss_customer_sk", n)
    null_key = int(cust.max()) + 1  # sorts after every customer
    key = np.where(cvalid, cust, null_key)
    keys, inverse = np.unique(key, return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inverse, act)
    top = np.lexsort((keys, sums))[:100]
    return [(None if keys[i] == null_key else int(keys[i]), int(sums[i]))
            for i in top], int(hit.sum()), load_s


def phase_q93_engine(catalog) -> dict:
    """TPC-DS Q93 at the catalog's scale factor: store_sales LEFT JOIN
    store_returns on a two-column key through ``_probe_ranges`` and the N:1
    LEFT lookup, then a grouped sum and a TopN."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpcds.queries import QUERIES

    want, matched, load_s = _numpy_q93(catalog)
    if len(want) != 100 or matched == 0:
        raise AssertionError("Q93 reference is empty or matched no return: "
                             "the data is wrong")

    def check(batch, what):
        k, s = batch["ss_customer_sk"], batch["sumsales"]
        if str(k.type) != "bigint" or str(s.type) != "decimal(38,2)" \
                or not (k.data.is_cuda and s.data.is_cuda):
            raise AssertionError(f"{what}: unexpected Q93 output columns")
        if batch.num_rows != 100:
            raise AssertionError(f"{what}: {batch.num_rows} rows, not 100")
        if not bool(s.validity[:100].all()):
            raise AssertionError(f"{what}: NULL net sales")
        kv = k.validity[:100].cpu().tolist() if k.validity is not None \
            else [True] * 100
        got = [(int(a) if v else None, int(b)) for a, b, v in
               zip(k.data[:100].cpu().tolist(), s.data[:100].cpu().tolist(),
                   kv)]
        if got != want:
            raise AssertionError(f"{what}: Q93 disagrees with numpy")

    engine = Engine(catalog, device="cuda")
    out = _engine_phase("Q93", engine, QUERIES[93], check,
                        need=("gather", "compact"))
    run = out["run"]
    say("q93_engine", sf=catalog.sf, load_seconds=load_s,
        store_sales_rows=catalog.table("store_sales").num_rows,
        store_returns_rows=catalog.table("store_returns").num_rows,
        rows_matched=matched, first_rows=want[:3],
        null_customer_rank=next((i for i, r in enumerate(want)
                                 if r[0] is None), None),
        launches=run["launches"], launches_per_step=run["launches_per_step"],
        ms_per_run=out["ms"], ms_trials=out["ms_trials"],
        profile=out["profile"], held_against_plain=out["held"],
        agrees_with=["numpy int64 exactly (100 rows)", "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "gather_args": out["gather_args"]}


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


class _UncachedSmCount:
    """While active, the kernel wrappers look the device's SM count up with
    ``torch.cuda.get_device_properties`` on every call, as they did before
    ``_build.sm_count`` cached it: the "before" of a wrapper's host cost."""

    def __enter__(self):
        from presto1_tpu_torch.ops.kernels import _build

        self.build, self.orig = _build, _build.sm_count
        _build.sm_count = lambda dev: torch.cuda.get_device_properties(
            dev).multi_processor_count
        return self

    def __exit__(self, *exc):
        self.build.sm_count = self.orig


def _call_ms(fn) -> dict:
    """What a caller sees of ``fn`` enqueued from Python back to back (the
    host's cost of a call, where it exceeds the kernel's time), with the SM
    count cached and, before, looked up on every call."""
    with _UncachedSmCount():
        before = time_ms(fn)
    return {"call_ms": time_ms(fn), "call_ms_uncached_sm_count": before}


def dense_times(word, groups, columns, slots, copy_rate: float,
                library=None) -> dict:
    """``dense_group_agg`` at one shape, through the path the wrapper picks
    and through every other path that takes the recipe (the candidates).
    Bytes: the word, every value column and every distinct validity column
    once, and the outputs.  Operations: per row and slot a select and an
    add, plus the compare."""
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D

    n = word.shape[0]
    valids = {v.data_ptr() for _, _, v in slots if v is not None}
    nbytes = n * (word.element_size()
                  + sum(c.element_size() for c in columns) + len(valids)) \
        + groups * (len(slots) + 2) * 8
    desc = ([c.dtype for c in columns],
            [(op, c, None if v is None else v.data_ptr())
             for op, c, v in slots])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = D.plan_dense(n, groups, *desc, sms)
    paths = {}
    for path in ("int", "general", "hist"):
        try:
            other = D.plan_dense(n, groups, *desc, sms, path)
        except ValueError:
            continue
        paths[path] = {"ms": device_ms(lambda: D._dense_group_agg(
            word, groups, columns, slots, path)), "threads": other.threads,
            "blocks": other.blocks, "shared_bytes": other.shared}
    out = {"n": n, "groups": groups, "columns": len(columns),
           "slots": len(slots), "path": plan.path,
           "ms": paths[plan.path]["ms"], "paths": paths,
           "plain_ms": time_ms(lambda: D.dense_group_agg_plain(
               word, groups, columns, slots), reps=2, trials=3),
           **_call_ms(lambda: D.dense_group_agg(word, groups, columns,
                                                slots)),
           **_bounds(nbytes, n * (2 * len(slots) + 2), copy_rate),
           "library_ms": None}
    if library is not None:
        # bincount reads its result's size back, so it cannot be captured
        # into a graph: its kernel rows in the profiler, and beside them
        # CUDA events around calls enqueued from Python (readback included)
        rows = kernel_rows_ms(library)
        out.update(library_ms=rows["ms"], library_kernels=rows["kernels"],
                   library_rows=rows["rows"],
                   library_enqueued_ms=time_ms(library))
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def _strided_gather_rows(sources, idx):
    """``gather_rows`` as the earlier design made it, for the same-run
    comparison: the same argument checks, outputs allocated one by one,
    then one launch of the strided body (the earlier kernel, kept for
    ``take_along_axis``) per element width of the 1-D columns (32 columns
    a launch) and one per ``[n, W]`` matrix, each inside
    ``torch.cuda.device``.  Launches made here count in no launch
    counter."""
    import ctypes

    from presto1_tpu_torch.ops.kernels import _build, gather as G

    sources = list(sources)
    G._check_idx(idx, 1)
    for k, s in enumerate(sources):
        if not isinstance(s, torch.Tensor) or s.device != idx.device \
                or s.dim() not in (1, 2) \
                or s.shape[0] != sources[0].shape[0] \
                or s.element_size() not in (1, 2, 4, 8) \
                or not s.is_contiguous():
            raise ValueError(f"sources[{k}]")
    lib = G._library()
    m, n = idx.shape[0], sources[0].shape[0]
    idx = idx.contiguous()
    outs = [torch.empty((m,) + tuple(s.shape[1:]), dtype=s.dtype,
                        device=s.device) for s in sources]

    def launch(srcs, dsts, width, strides):
        dev = idx.device
        blocks = max(1, min(-(-(m * width) // G.THREADS),
                            _build.sm_count(dev) * 16))
        ptrs = ctypes.c_void_p * len(srcs)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.p1_gather_strided(
                ptrs(*[t.data_ptr() for t in srcs]),
                ptrs(*[t.data_ptr() for t in dsts]), len(srcs),
                srcs[0].element_size(), idx.data_ptr(), idx.element_size(),
                m, width, n, (ctypes.c_int64 * 5)(*strides), blocks, stream)
        if err != 0:
            raise RuntimeError(f"strided gather launch failed: error {err}")

    by_width: dict = {}
    for k, s in enumerate(sources):
        if s.dim() == 1:
            by_width.setdefault(s.element_size(), []).append(k)
    for ks in by_width.values():
        for at in range(0, len(ks), G.MAX_PAIRS):
            part = ks[at:at + G.MAX_PAIRS]
            launch([sources[k] for k in part], [outs[k] for k in part], 1,
                   (1, 0, 1, 0, 0))
    for k, s in enumerate(sources):
        if s.dim() == 2 and s.shape[1] > 0:
            w = s.shape[1]
            launch([s], [outs[k]], w, (1, 0, w, 0, 1))
    return outs


# Random 32-byte sector reads and nothing else: no index stream, no output,
# one 4-byte load at the start of a hashed random sector, L loads a thread
# issued before any is used.  The yardstick of a random gather on this card,
# measured apart from any gather.
SECTOR_READS_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// murmur3's 32-bit finaliser: consecutive inputs to unrelated outputs
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// `rounds` rounds a thread of L independent loads, each of the first word
// of a random one of `sectors` 32-byte sectors of `src`
template <int L>
__global__ void __launch_bounds__(kThreads)
sector_reads(const uint32_t* __restrict__ src, uint32_t sectors, int rounds,
             uint32_t seed, uint32_t* __restrict__ sink) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  uint32_t acc = 0;
#pragma unroll 1
  for (int k = 0; k < rounds; ++k) {
    uint32_t v[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t h = mix(seed + (t * rounds + k) * L + l);
      v[l] = __ldg(src + 8 * static_cast<uint64_t>(__umulhi(h, sectors)));
    }
#pragma unroll
    for (int l = 0; l < L; ++l) acc += v[l];
  }
  if (acc == 0xffffffffu) sink[0] = acc;  // keeps the loads; a zero source
}

template <int L>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sector_reads<L>,
                                                kThreads, 0);
  return n;
}

template <int L>
int launch(const void* src, uint32_t sectors, int rounds, int blocks,
           uint32_t seed, void* sink, void* stream) {
  sector_reads<L><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), sectors, rounds, seed,
      static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// resident blocks an SM at `loads` loads a thread; 0 for another count
extern "C" int p1_sector_blocks_per_sm(int loads) {
  switch (loads) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 4: return blocks_per_sm<4>();
    case 8: return blocks_per_sm<8>();
    case 16: return blocks_per_sm<16>();
    case 32: return blocks_per_sm<32>();
    default: return 0;
  }
}

// `blocks` blocks of `rounds` rounds of `loads` loads a thread
extern "C" int p1_sector_reads(const void* src, uint32_t sectors, int loads,
                               int rounds, int blocks, uint32_t seed,
                               void* sink, void* stream) {
  switch (loads) {
    case 1: return launch<1>(src, sectors, rounds, blocks, seed, sink, stream);
    case 2: return launch<2>(src, sectors, rounds, blocks, seed, sink, stream);
    case 4: return launch<4>(src, sectors, rounds, blocks, seed, sink, stream);
    case 8: return launch<8>(src, sectors, rounds, blocks, seed, sink, stream);
    case 16:
      return launch<16>(src, sectors, rounds, blocks, seed, sink, stream);
    case 32:
      return launch<32>(src, sectors, rounds, blocks, seed, sink, stream);
    default: return -1;
  }
}
"""
SECTOR_LOADS = (1, 2, 4, 8, 16, 32)  # loads in flight a thread, swept


def start_sector_reads_build():
    """Start ``nvcc`` for ``SECTOR_READS_CU`` in the kernels' build
    directory; returns a function that waits for it and loads the
    library."""
    import ctypes
    import hashlib

    from presto1_tpu_torch.ops.kernels import _build

    digest = hashlib.sha1(SECTOR_READS_CU.encode()).hexdigest()[:12]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"sector_reads-{digest}.cu"
    out = _build.BUILD_DIR / f"libsector_reads-{digest}.so"
    src.write_text(SECTOR_READS_CU)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the sector-read "
                               f"microbenchmark:\n{log}")
        lib = ctypes.CDLL(str(out))
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.p1_sector_blocks_per_sm.argtypes = [i]
        lib.p1_sector_blocks_per_sm.restype = i
        lib.p1_sector_reads.argtypes = [p, ctypes.c_uint32, i, i, i,
                                        ctypes.c_uint32, p, p]
        lib.p1_sector_reads.restype = i
        return lib, log
    return finish


def sector_rate(lib, nbytes: int, loads: int) -> dict:
    """Random 32-byte sector reads per second from a zeroed source of
    ``nbytes``, by ``SECTOR_READS_CU`` at ``loads`` loads in flight a
    thread, every SM at the occupancy the kernel allows, 2^25 reads a
    launch, by graph replay."""
    from presto1_tpu_torch.ops.kernels import _build

    src = torch.zeros((nbytes // 4,), dtype=torch.int32, device="cuda")
    sink = torch.zeros((1,), dtype=torch.int32, device="cuda")
    per_sm = lib.p1_sector_blocks_per_sm(loads)
    blocks = _build.sm_count(src.device) * per_sm
    rounds = -(-(1 << 25) // (blocks * 256 * loads))
    sectors = nbytes // 32

    def run():
        err = lib.p1_sector_reads(src.data_ptr(), sectors, loads, rounds,
                                  blocks, 12345, sink.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"sector reads launch failed: error {err}")

    ms = device_ms(run, reps=5)
    reads = blocks * 256 * rounds * loads
    return {"source_bytes": nbytes, "loads_in_flight": loads,
            "blocks_per_sm": per_sm, "reads": reads, "ms": ms,
            "sectors_per_s": reads / (ms * 1e-3)}


def phase_random_sector_rate(gen, lib) -> dict:
    """The card's random 32-byte sector reads per second (``sector_rate``,
    sector reads and nothing else), swept over 1 to 32 loads in flight a
    thread, from int32 sources of half the L2 (``L2_cache_size``), of the
    L2's size and of four times it.  Beside each, the gather kernel and
    ``index_select`` at 2^24 random sector reads from the same source
    (their int32 index and output streams besides)."""
    from presto1_tpu_torch.ops.kernels import _build, gather as G

    l2 = _build.l2_bytes(torch.device("cuda", 0))
    m = 1 << 24
    rates = {"l2_bytes": l2, "microbenchmark": "SECTOR_READS_CU"}
    for name, nbytes in (("half_l2", l2 // 2), ("l2", l2),
                         ("four_l2", 4 * l2)):
        sweep = {loads: sector_rate(lib, nbytes, loads)
                 for loads in SECTOR_LOADS}
        best = max(sweep, key=lambda k: sweep[k]["sectors_per_s"])
        rate = sweep[best]["sectors_per_s"]
        src = torch.zeros((nbytes // 4,), dtype=torch.int32, device="cuda")
        idx = (torch.randint(0, nbytes // 32, (m,), generator=gen,
                             device="cuda") * 8).to(torch.int32)
        gather_ms = device_ms(lambda: G.gather_rows([src], idx))
        library_ms = device_ms(lambda: src.index_select(0, idx))
        rates[name] = {
            "source_bytes": nbytes, "by_loads_in_flight": sweep,
            "best_loads_in_flight": best, "sectors_per_s": rate,
            "sector_bytes_per_s": 32 * rate,
            "gather_reads": m, "gather_ms": gather_ms,
            "gather_sectors_per_s": m / (gather_ms * 1e-3),
            "index_select_ms": library_ms,
            "index_select_sectors_per_s": m / (library_ms * 1e-3),
            "gather_share_of_rate": m / (gather_ms * 1e-3) / rate}
        del src, idx
    say("random_sector_rate", **rates)
    return rates


def gather_times(sources, idx, copy_rate: float, sector_lib=None) -> dict:
    """``gather_rows`` at one shape.  Bytes: the index once, each distinct
    source row it names read once (what this index needs: a repeated row
    comes from the caches), one output row written per index.  The
    kernel beside the earlier design's body and launch pattern
    (``_strided_gather_rows``) and ``index_select``, in turns by graph
    replay; the host's cost of a call (``call_ms``) beside the earlier
    pattern's; and the random-sector yardstick: one sector a word of a
    distinct row, at the card's rate (``sector_rate``, 8 loads in flight)
    from a source of the bytes one column group of the plan reads (all the
    sources in one pass).  The yardstick is meant for a random index: a
    local one shares its sectors."""
    from presto1_tpu_torch.ops.kernels import _build, gather as G

    sources = list(sources)
    idx = idx.contiguous()
    m, n = idx.shape[0], sources[0].shape[0]
    per_row = sum(s.element_size() * (s.numel() // max(s.shape[0], 1))
                  for s in sources)
    long_idx = idx.to(torch.int64)
    distinct = int(torch.unique(long_idx.clamp(0, n - 1)).numel())
    nbytes = m * (idx.element_size() + per_row) + distinct * per_row
    outs = [s.new_empty((m,) + tuple(s.shape[1:])) for s in sources]
    units = [(1 << lw, k) for _, _, lw, k in G._units(sources, outs)]
    plan = G.plan_gather(m, n, units, _build.sm_count(idx.device),
                         _build.l2_bytes(idx.device))

    def library():
        return [s.index_select(0, long_idx) for s in sources]

    turns = in_turns({"ms": lambda: G.gather_rows(sources, idx),
                      "strided_ms": lambda: _strided_gather_rows(sources,
                                                                 idx),
                      "library_ms": library})
    out = {"rows_out": m, "rows_in": n, "distinct_rows_read": distinct,
           "sources": [f"{s.dtype}{list(s.shape[1:])}" for s in sources],
           "index": str(idx.dtype), "units": len(units),
           "plan": plan._asdict(), **turns,
           "timed": "ms, strided_ms and library_ms in turns (in_turns)",
           "plain_ms": device_ms(lambda: G.gather_rows_plain(sources, idx)),
           "call_ms": time_ms(lambda: G.gather_rows(sources, idx)),
           "strided_call_ms": time_ms(lambda: _strided_gather_rows(sources,
                                                                   idx)),
           **_bounds(nbytes, m * len(sources), copy_rate),
           "library_call": "torch.index_select, once per source, on "
                           "indices already in range"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    if sector_lib is not None:
        group_bytes = (n * sum(w for w, _ in units) if plan.groups == 1
                       else n * plan.per_group * max(w for w, _ in units))
        rate = sector_rate(sector_lib, group_bytes, 8)
        out["sector_rate"] = rate
        out["sector_reads"] = distinct * len(units)
        out["sector_yardstick_ms"] = \
            distinct * len(units) / rate["sectors_per_s"] * 1e3
        out["share_of_sector_yardstick"] = \
            out["sector_yardstick_ms"] / out["ms"]
    return out


def gather_small_call(gen) -> dict:
    """The host's cost of a small ``gather_rows`` call, as fill Q27: 1,000
    rows of 3 columns in 2 widths (int64, int64, int32), a random int64
    index; ``call_ms`` of the wrapper beside the earlier pattern's
    (``_strided_gather_rows``), and the device time of each."""
    from presto1_tpu_torch.ops.kernels import gather as G

    n = 1000
    srcs = [_values((n,), dt, gen) for dt in (torch.int64, torch.int64,
                                              torch.int32)]
    idx = torch.randint(0, n, (n,), generator=gen, device="cuda")
    return {"rows": n, "sources": ["int64", "int64", "int32"],
            "call_ms": time_ms(lambda: G.gather_rows(srcs, idx)),
            "strided_call_ms": time_ms(lambda: _strided_gather_rows(srcs, idx)),
            "ms": device_ms(lambda: G.gather_rows(srcs, idx)),
            "strided_ms": device_ms(lambda: _strided_gather_rows(srcs, idx))}


def scatter_times(idx, x, size, mask, copy_rate: float) -> dict:
    """``scatter_distinct`` at one shape (``x`` one column or a list of
    columns).  Bytes the function needs: the mask once; the index and the
    values only where the mask holds, counted as the 32-byte sectors of
    each that hold such a row (the whole index and the kept rows' values
    without a mask); and the outputs once (they are zero-filled)."""
    from presto1_tpu_torch.ops.kernels import scatter as S

    n = idx.shape[0]
    t = idx.to(torch.int64)
    keep = (t >= 0) & (t < size)
    if mask is not None:
        keep = keep & mask
    kept = int(keep.sum())
    xs = x if isinstance(x, list) else [x]
    widths = [c.element_size() for c in xs]

    def sector_bytes(w: int) -> int:
        """Bytes of the 32-byte sectors of an array of ``w``-byte elements
        that hold a row where the mask holds."""
        per = 32 // w
        padded = torch.zeros((-(-n // per) * per,), dtype=torch.bool,
                             device="cuda")
        padded[:n] = mask
        return min(n * w, 32 * int(padded.view(-1, per).any(dim=1).sum()))

    if mask is None:
        idx_bytes, x_bytes = n * idx.element_size(), kept * sum(widths)
    else:
        idx_bytes = sector_bytes(idx.element_size())
        x_bytes = sum(sector_bytes(w) for w in widths)
    nbytes = (0 if mask is None else n) + idx_bytes + x_bytes \
        + sum(size * w for w in widths)
    target = torch.where(keep, t, size)

    def library():
        return [torch.zeros((size + 1,), dtype=v.dtype,
                            device="cuda").scatter_(0, target, v)
                for v in xs]

    out = {"rows": n, "size": size, "kept": kept, "columns": len(xs),
           "masked": mask is not None,
           "index_bytes": idx_bytes, "value_bytes": x_bytes,
           "ms": device_ms(lambda: S.scatter_distinct(idx, x, size, mask)),
           "plain_ms": device_ms(lambda: S.scatter_distinct_plain(
               idx, x, size, mask)),
           **_call_ms(lambda: S.scatter_distinct(idx, x, size, mask)),
           **_bounds(nbytes, n, copy_rate),
           "library_ms": device_ms(library),
           "library_call": "Tensor.scatter_ into zeros, once per column, "
                           "targets and values made beforehand"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def compact_times(mask, capacity: int, copy_rate: float) -> dict:
    """``compact`` at one shape.  Bytes the function needs: the mask once,
    ``capacity`` indices and the count written once.  Each of its two
    kernels beside the bytes it needs (the count pass: the mask and the
    chunk counts; the write pass: the mask, the chunk counts, the indices
    and the count), and the device time of one one-element fill, the least
    a launch in a graph costs.  Beside it, the composition it replaced in
    ``compact_indices`` (sum, prefix sum, ``- 1``, then ``scatter_distinct``
    with its zero fill: the redesigned scatter kernel, the row numbers made
    beforehand) by graph replay and by its kernel rows, and
    ``torch.nonzero`` (the same indices without the padding, sized on the
    host) by its kernel rows."""
    from presto1_tpu_torch.ops.kernels import _build, scatter as S

    n = mask.shape[0]
    kept = int(mask.sum())
    nbytes = n + capacity * 8 + 8
    row_numbers = torch.arange(n, device="cuda")

    def composition():
        count = torch.sum(mask)
        rank = torch.cumsum(mask, dim=0) - 1
        return S.scatter_distinct(rank, row_numbers, capacity, mask), count

    blocks, _ = S.compact_plan(n, mask.data_ptr() % 16,
                               _build.sm_count(mask.device))
    pass_bytes = {"compact_count": n + 8 * blocks,
                  "compact_write": n + 8 * blocks + capacity * 8 + 8}
    one = torch.empty((1,), dtype=torch.int64, device="cuda")
    rows = kernel_rows_ms(lambda: S.compact(mask, capacity))
    passes = {name: {"ms": ms, "bytes": pass_bytes[key],
                     "bound_ms": pass_bytes[key] / H100_BYTES_PER_S * 1e3}
              for name, ms, _ in rows["rows"]
              for key in pass_bytes if key in name}
    old_rows = kernel_rows_ms(composition)
    lib = kernel_rows_ms(lambda: torch.nonzero(mask))
    out = {"rows": n, "capacity": capacity, "kept": kept,
           "ms": device_ms(lambda: S.compact(mask, capacity)),
           "kernel_rows_ms": rows["ms"], "kernels": rows["kernels"],
           "kernel_rows": rows["rows"], "passes": passes,
           "one_element_fill_ms": device_ms(lambda: one.zero_()),
           "plain_ms": device_ms(lambda: S.compact_plain(mask, capacity)),
           **_call_ms(lambda: S.compact(mask, capacity)),
           **_bounds(nbytes, n, copy_rate),
           "old_composition_ms": device_ms(composition),
           "old_composition_kernel_rows_ms": old_rows["ms"],
           "old_composition_kernels": old_rows["kernels"],
           "old_composition_rows": old_rows["rows"],
           "old_composition_call_ms": time_ms(composition),
           "library_ms": lib["ms"], "library_kernels": lib["kernels"],
           "library_call": "torch.nonzero (sizes its result on the host; "
                           "its kernel rows only)"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def dyncopy_times(columns, counts, capacity: int, copy_rate: float) -> dict:
    """``concat_rows`` at one shape.  Bytes the function needs: each part's
    live rows read once (a None entry reads nothing) and ``capacity`` rows
    of every column written once, plus the counts.  The library call is
    ``torch.cat`` of the live prefixes, with the counts known on the host
    (it writes no zero tail)."""
    from presto1_tpu_torch.ops.kernels import dyncopy as DC

    k = counts.shape[0]
    host = counts.tolist()
    rows = [next(c[p] for c in columns if c[p] is not None).shape[0]
            for p in range(k)]
    live = [min(max(c, 0), r) for c, r in zip(host, rows)]

    def row_bytes(t):
        return t.element_size() * (t.numel() // max(t.shape[0], 1))

    read = sum(live[p] * row_bytes(t) for col in columns
               for p, t in enumerate(col) if t is not None)
    outs = DC.concat_rows(columns, counts, capacity)
    write = sum(capacity * row_bytes(o) for o in outs)
    nbytes = read + write + 8 * k
    fills = [[torch.ones((live[p],) + tuple(next(
        x for x in col if x is not None).shape[1:]), dtype=torch.bool,
        device="cuda") if t is None else t[:live[p]]
        for p, t in enumerate(col)] for col in columns]

    def library():
        return [torch.cat(parts, dim=0) for parts in fills]

    # the same function: the live prefixes into the output, then the zero
    # tail (the counts known on the host)
    total = sum(live)
    dsts = [torch.empty_like(o) for o in outs]

    def library_same():
        for dst, parts in zip(dsts, fills):
            torch.cat(parts, dim=0, out=dst[:total])
            dst[total:].zero_()

    turns = {"ms": lambda: DC.concat_rows(columns, counts, capacity),
             "library_ms": library}
    if total <= capacity:
        turns["library_same_function_ms"] = library_same
    out = {"parts": k, "columns": len(columns), "capacity": capacity,
           "live_rows": sum(live), "read_bytes": read, "write_bytes": write,
           "library_same_function_ms": None, **in_turns(turns),
           "timed": "ms and the library calls in turns (in_turns)",
           "plain_ms": device_ms(lambda: DC.concat_rows_plain(
               columns, counts, capacity), reps=5),
           **_call_ms(lambda: DC.concat_rows(columns, counts, capacity)),
           **_bounds(nbytes, 0, copy_rate),
           "library_call": "torch.cat of the live prefixes, counts known "
                           "on the host, no zero tail",
           "library_same_function_call": "torch.cat of the live prefixes "
                                         "into the output's first rows, then "
                                         "zero_() of the rest, counts known "
                                         "on the host"}
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA device only")
    import presto1_tpu_torch  # noqa: F401 -- fail before printing anything
    from presto1_tpu_torch.exec.catalog import TpchCatalog
    from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog

    device = phase_device()
    sector_lib = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20240607)
    err = phase_kernel_check(gen)
    dense_err = phase_kernel_check_dense(gen)
    gather_err = phase_kernel_check_gather(gen)
    scatter_err = phase_kernel_check_scatter(gen)
    dyncopy_err = phase_kernel_check_dyncopy(gen)
    copy_rate = phase_copy_bandwidth()
    sector_rates = phase_random_sector_rate(gen, sector_lib)
    catalog = TpchCatalog(sf=1.0, device="cuda")
    q6 = phase_q6_engine(catalog)
    q1 = phase_q1_engine(catalog)
    q15 = phase_q15view_engine(catalog)
    q3 = phase_q3_engine(catalog)
    ds = TpcdsCatalog(sf=1.0, device="cuda")
    q27 = phase_q27_engine(ds)
    q93 = phase_q93_engine(ds)
    paths = (q1, q15, q3, q27, q93)
    launches = {k: q6["launches"] if k == "filter_sum"
                else sum(p["launches"][k] for p in paths)
                for k in q1["launches"]}
    # the main paths' own gather and scatter calls, held against the plain
    # versions in each phase, count in the kernels' measured error
    compact_err = {"max_abs_err": scatter_err["max_abs_err"],
                   "compactions_checked": scatter_err.pop("compactions")}
    for held_err, name in ((gather_err, "gather_rows"),
                           (scatter_err, "scatter_distinct"),
                           (compact_err, "compact")):
        held_err["max_abs_err"] = max(
            [held_err["max_abs_err"]]
            + [p["held"][name]["max_abs_err"] for p in (q15, q3, q27, q93)])
        held_err["held_at_main_path_calls"] = {
            q: p["held"][name]["calls_held"] for q, p in
            (("q15_view", q15), ("q3", q3), ("q27", q27), ("q93", q93))}

    from presto1_tpu_torch.ops.kernels import dyncopy as DC

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
    gather_q15, gather_q3, gather_q27, gather_q93 = (
        gather_times(*p["gather_args"], copy_rate, sector_lib)
        for p in (q15, q3, q27, q93))
    n = q6["cols"][0].shape[0]
    perm = torch.randperm(n, generator=gen, device="cuda")
    gather_one = gather_times([q6["cols"][3]], perm, copy_rate, sector_lib)
    gather_one32 = gather_times([q6["cols"][0]], perm.to(i32), copy_rate,
                                sector_lib)
    gather_small = gather_small_call(gen)
    scatter_q3 = scatter_times(*q3["scatter_args"], copy_rate)
    scatter_perm = scatter_times(perm, q6["cols"][3], n, None, copy_rate)
    mask = scatter_err.pop("mask")
    rank = torch.cumsum(mask, dim=0) - 1
    # the row numbers made beforehand: the kernel reads them at kept rows
    scatter_compact = scatter_times(
        rank, torch.arange(mask.shape[0], device="cuda"), 262_144, mask,
        copy_rate)
    compact_q15 = compact_times(*q15["compact_args"], copy_rate)
    compact_mask = compact_times(mask, 262_144, copy_rate)
    # the Q27 Union's parts as the engine handed them over, against the
    # plain version too, then timed; and the fact-table UNION ALL
    union_cols, union_counts, union_cap = q27["union_args"]
    got = DC.concat_rows(union_cols, union_counts, union_cap)
    want = DC.concat_rows_plain(union_cols, union_counts, union_cap)
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError("dyncopy disagrees with its plain version "
                                 "on Q27's Union")
    dyncopy_err["max_abs_err"] = max(
        [dyncopy_err["max_abs_err"]] + [_abs_err(a, b)
                                        for a, b in zip(got, want)])
    dyncopy_q27 = dyncopy_times(union_cols, union_counts, union_cap,
                                copy_rate)
    dyncopy_fact = dyncopy_times(*dyncopy_err.pop("fact_args"), copy_rate)

    def entry(name, replaces, launches_n, err_info, at, source=None,
              **more):
        return {"name": name, "route": "cuda",
                "source": "presto1_tpu_torch/ops/kernels/csrc/"
                          f"{source or name}.cu",
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
              launches["scatter"],
              {k: scatter_err[k]
               for k in ("max_abs_err", "held_at_main_path_calls")},
              scatter_q3,
              shape="Q3's largest scatter at SF1: merge_join's two columns "
                    "(sorted keys, origins) of the build entries through "
                    "one rank and mask",
              at_engine_shape=scatter_q3,
              at_compaction_of_view_density_mask=scatter_compact,
              at_6m_row_permutation_int64=scatter_perm),
        entry("compact",
              "experiments/pallas_primitives.py:102, "
              "experiments/pallas_primitives.py:250",
              launches["compact"],
              {k: compact_err[k] for k in ("max_abs_err",
                                           "held_at_main_path_calls",
                                           "compactions_checked")},
              compact_q15, source="scatter",
              shape="the Q15 view's largest compaction at SF1: the group "
                    "boundaries among 6,002,010 sorted rows",
              launches_counted="calls of compact (two kernels each)",
              at_engine_shape=compact_q15,
              at_view_density_mask_into_262144=compact_mask),
        entry("gather",
              "experiments/pallas_primitives.py:54, "
              "experiments/pallas_primitives.py:78, "
              "experiments/pallas_primitives2.py:227, "
              "experiments/pallas_primitives3.py:33",
              launches["gather"],
              {k: gather_err[k]
               for k in ("max_abs_err", "held_at_main_path_calls")},
              gather_q15,
              shape="the Q15 view's largest gather at SF1: every operand of "
                    "the grouping sort through the row permutation",
              at_engine_shape=gather_q15,
              at_q27_largest_call=gather_q27, at_q93_largest_call=gather_q93,
              at_q3_largest_call=gather_q3,
              at_one_int64_column_6m_permutation=gather_one,
              at_one_int32_column_int32_index=gather_one32,
              at_1000_rows_3_columns_2_widths=gather_small,
              random_sector_rate=sector_rates),
    ]
    kernels.append(entry(
        "dyncopy",
        "experiments/pallas_primitives.py:131, "
        "experiments/pallas_primitives.py:159, "
        "experiments/pallas_primitives.py:188, "
        "experiments/pallas_primitives.py:219, "
        "experiments/pallas_primitives2.py:51, "
        "experiments/pallas_primitives2.py:80, "
        "experiments/pallas_primitives2.py:110, "
        "experiments/pallas_primitives2.py:142, "
        "experiments/pallas_primitives2.py:192",
        launches["dyncopy"], {"max_abs_err": dyncopy_err["max_abs_err"]},
        dyncopy_q27,
        shape="TPC-DS Q27 at SF1: the Union of its three ROLLUP levels, "
              "as the engine hands the parts over",
        at_engine_shape=dyncopy_q27,
        at_union_all_2880404_plus_1441548_rows_8_int64=dyncopy_fact))
    for k in kernels:
        if not isinstance(k["max_abs_err"], (int, float)) \
                or k["max_abs_err"] != 0:
            raise AssertionError(f"{k['name']}: max_abs_err "
                                 f"{k['max_abs_err']!r}, not 0")
    say("engine_summary", card=card,
        q3_ms_per_run=q3["ms_per_run"], q27_ms_per_run=q27["ms_per_run"],
        q93_ms_per_run=q93["ms_per_run"],
        q27_union_dyncopy_ms=dyncopy_q27["ms"],
        fact_union_dyncopy_ms=dyncopy_fact["ms"],
        q1_ms_per_run=q1["ms_per_run"], q15view_ms_per_run=q15["ms_per_run"],
        q1_dense_kernel_ms=dense_q1["ms"],
        q15view_largest_gather_ms=gather_q15["ms"],
        largest_gather_ms={k: {"ms": g["ms"],
                               "strided_ms": g["strided_ms"],
                               "index_select_ms": g["library_ms"],
                               "bound_ms": g["bound_ms"]}
                           for k, g in (("q15_view", gather_q15),
                                        ("q3", gather_q3),
                                        ("q27", gather_q27),
                                        ("q93", gather_q93))},
        launches_by_path={k: p["launches"] for k, p in (
            ("q1", q1), ("q15_view", q15), ("q3", q3), ("q27", q27),
            ("q93", q93))},
        q15view_largest_compaction_ms=compact_q15["ms"],
        q3_largest_scatter_ms=scatter_q3["ms"],
        device_ms_per_run={k: p["profile"].get("device_ms_per_run")
                           for k, p in (("q1", q1), ("q15_view", q15),
                                        ("q3", q3), ("q27", q27),
                                        ("q93", q93))},
        kernels_per_run={k: p["profile"].get("kernels_per_run")
                         for k, p in (("q1", q1), ("q15_view", q15),
                                      ("q3", q3), ("q27", q27),
                                      ("q93", q93))})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
