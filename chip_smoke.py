#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the main paths of ``presto1_tpu_torch`` on the card -- TPC-H Q6, Q1,
the revenue view of Q15, Q3 and Q7 (civil dates), a statement of four
window functions over every lineitem row, and TPC-DS Q27 (ROLLUP: joins and
a Union), Q93 (a LEFT join) and Q98 (a window over an aggregate), all at
scale factor 1, through ``Engine.sql`` and
``Engine.compile(...)`` / ``CompiledQuery.block_run`` -- builds every
hand-written kernel from the sources in this checkout, holds each against
its plain PyTorch version on the card (integers exactly, float64 sums to
1e-9 relative), shows from the launch counters that the main paths went
through them, checks that a compiled run never waits for the host (one run
of each statement under ``torch.cuda.set_sync_debug_mode("error")``), and
times kernel, plain version, library call and engine.  Then the bounded
device-memory paths at SF1: the page-locked PCIe rate, ``query_max_memory``
around Q1's eager working set, Q1 / Q3 / Q18 spilled through host RAM at a
16 MiB threshold, ``Engine.compile_grouped`` (Q1 at K = 2, 4, 8, Q6, Q3;
Q18 refused) from a catalog that never uploads lineitem whole, sampled
against full discovery, and the compiled Q3's EXPLAIN ANALYZE.  Then the
rest of the statement surface over the SF1 lineitem (``statements_engine``):
three DISTINCT aggregates in one query, approx_distinct of three columns
globally and by l_returnflag (held against a numpy twin of the sketch),
UNNEST of a lambda-filtered array, array functions over columns, CREATE
TABLE AS / INSERT (one refused at its accounted working set less one byte,
one spilled) / DROP / SHOW over a memory table on the card with Q1 and Q6
over it, and the system tables.  Then the mesh plane (``mesh_engine``) on 8
logical shards of the card: ``dryrun_q1`` / ``dryrun_join`` at 2^19 rows a
shard against numpy, the hash exchange of lineitem's l_orderkey at its quota
and at half of it, ``Engine.sql_distributed(sql, 8)`` on Q1, Q3, a LEFT
join, a DISTINCT, an ORDER BY ... LIMIT and a skew join at SF1 against
``Engine.sql``, and all 22 TPC-H queries at SF 0.01.  The
generated TPC-H columns are kept in ``.tpch_cache`` beside this script
(or ``P1_TPCH_CACHE``).  Every phase prints
one JSON line; any failed phase raises, and the exit code is then non-zero.  It needs one CUDA device, the
CUDA toolkit (``nvcc``) and no network.

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

import contextlib
import json
import os
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


def _plain(x):
    """A numpy scalar as its Python value (for ``json.dumps``)."""
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}, default=_plain), flush=True)


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


def _warm_up_for_capture(fn, reps: int) -> None:
    """Two calls of ``fn``, then a zeroed compaction state set aside for
    every compaction that ``reps`` calls captured into a graph will make
    (``scatter.reserve_graph_states``), synchronised."""
    from presto1_tpu_torch.ops.kernels import scatter as S

    before = S.COMPACT_LAUNCHES
    for _ in range(2):
        fn()
    need = -(-(S.COMPACT_LAUNCHES - before) // 2) * reps
    dev = torch.device("cuda", torch.cuda.current_device())
    have = len(S._SPARE.get(dev.index, ()))
    if need > have:
        S.reserve_graph_states(dev, need - have)
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Time of one call of ``fn`` on the device alone: ``reps`` calls are
    captured into one CUDA graph, and the median over ``trials`` of the
    CUDA-event time of a replay is divided by ``reps``.  A replay enqueues
    nothing from Python, so the host's cost of a call (which exceeds a short
    kernel's time) stays out of the number."""
    _warm_up_for_capture(fn, reps)
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


def replay_outputs(fn, reps: int = 20):
    """What the last of ``reps`` calls of ``fn`` captured into one CUDA
    graph returns after the graph was replayed three times (as
    ``device_ms`` captures and replays them), synchronised."""
    _warm_up_for_capture(fn, reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    out = tuple(t.clone() for t in out) if isinstance(out, tuple) \
        else out.clone()
    del graph
    return out


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
    # the take body: x of more than 2^31 elements (64-bit offsets), on
    # both axes
    x = huge[:2**31 + 5]
    hold_axis(x.view(-1, 1), index(2**31 - 60_000, 2**31 + 9, (100_001, 1)),
              0, "int8 x of 2^31 + 5 rows (64-bit offsets)")
    hold_axis(x.view(1, -1), index(2**31 - 60_000, 2**31 + 9, (1, 100_001)),
              1, "int8 x of one 2^31 + 5 row (64-bit offsets)")
    del huge, x
    take_launches = {}

    def one_take(x, idx, axis, what):
        before = G.TAKE_LAUNCHES
        hold_axis(x, idx, axis, what)
        take_launches[what] = G.TAKE_LAUNCHES - before

    # index views off the 16-byte grid (the body reads 16-byte vectors from
    # the boundary below), width 1 and wider on both axes, every element
    # width, both index widths, wild indices, one-element calls
    for dt in _MOVE_DTYPES:
        x = _values((1000, 3), dt, gen)
        col = _values((1000, 1), dt, gen)
        for idt in (torch.int32, torch.int64):
            for lo in range(4):
                flat = index(-9, 1009, (lo + 600 * 3,), idt)
                one_take(x, flat[lo:].view(600, 3), 0,
                         f"{dt} {idt} axis 0, index {lo} in")
                flat = index(-9, 12, (lo + 1000 * 5,), idt)
                one_take(x, flat[lo:].view(1000, 5), 1,
                         f"{dt} {idt} axis 1 width 5, index {lo} in")
                flat = index(-2**30, 2**30, (lo + 777,), idt)
                one_take(col, flat[lo:].view(777, 1), 0,
                         f"{dt} {idt} column, wild index {lo} in")
                flat = index(-5, 8, (lo + 1000,), idt)
                one_take(x, flat[lo:].view(1000, 1), 1,
                         f"{dt} {idt} axis 1 width 1, index {lo} in")
            one_take(col, index(-3, 2000, (1, 1), idt), 0,
                     f"{dt} {idt} one element")
            empty = G.take_along_axis(x, index(0, 3, (0, 3), idt), 0)
            if tuple(empty.shape) != (0, 3) or empty.dtype != x.dtype:
                raise AssertionError("take_along_axis of an empty index")
    # the engine's two calls: the window's doubling table (24 levels of
    # 6,002,010 int64, both ends of every frame) and element_at's lane of
    # an [n, 2] int64 matrix
    n = 6_002_010
    table = _values((24 * n, 1), torch.int64, gen)
    rows = torch.arange(n, device="cuda")
    level = torch.randint(0, 24, (n,), generator=gen, device="cuda")
    ends = torch.stack([level * n + rows, level * n + (rows - 2).clamp(
        min=0)], 1).reshape(-1, 1).contiguous()
    one_take(table, ends, 0, "the window's doubling table")
    del table, ends, level
    one_take(_values((n, 2), torch.int64, gen), index(-1, 3, (n, 1)), 1,
             "element_at's [6,002,010, 2] int64")
    for what, n_launch in take_launches.items():
        if n_launch != 1:
            raise AssertionError(f"take_along_axis made {n_launch} launches "
                                 f"for {what}; one is the design")
    say("kernel_check", kernel="gather", cases=cases, max_abs_err=worst,
        tolerance=0, launches_per_call=launches,
        take_body_cases=len(take_launches))
    return {"max_abs_err": worst}


# the compaction's bodies: the one-launch look-back ``compact`` takes, and
# the earlier two-pass body it is timed against
COMPACT_ROUTES = ("lookback", "two_pass")


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

    def hold_compact(mask, capacity, what, route="lookback", got=None):
        nonlocal compactions, worst
        idx, count = got or S._compact(mask, capacity, route)
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
    # the compaction, by both bodies: all false, 0.1 %, 3.6 %, 50 % and all
    # true; row counts around the 16-row lane, the 4096-row tile of the
    # two-pass body and the 16,384-row tile of the look-back; capacities
    # below, at and above the count; views 0-15 bytes off the 16-byte grid
    launches = {}
    for route in COMPACT_ROUTES:
        for density in (0.0, 0.001, 0.036, 0.5, 1.0):
            for n in (1, 15, 16, 17, 4095, 4096, 4097, 16_385, 32_769,
                      1_000_003, 6_002_010):
                m = torch.rand((n + 15,), generator=gen,
                               device="cuda") < density
                if density == 1.0:
                    m[:] = True
                heads = range(16) if n in (17, 4097, 16_385) else \
                    (0, 7, 15) if n < 10**6 else (0, 3)
                for lo in heads:
                    view = m[lo:lo + n]
                    k = int(view.sum())
                    for capacity in sorted({0, k // 2, k, k + 100, n + 17}):
                        before = S.COMPACT_LAUNCHES
                        hold_compact(view, capacity,
                                     f"{route}, density {density}, "
                                     f"n={n}, {lo} bytes off the grid, "
                                     f"capacity {capacity}", route)
                        launches.setdefault(route, set()).add(
                            S.COMPACT_LAUNCHES - before)
    # a CUDA graph's replay: 20 calls captured, replayed, and the last
    # call's indices and count held (the state the look-back keeps between
    # launches is left zero by each)
    replayed = {}
    n = 6_002_010
    for route in COMPACT_ROUTES:
        for what, m, capacity in (
                ("3.6 % into 262,144", mask[:n], 262_144),
                ("all true into n", torch.ones((n,), dtype=torch.bool,
                                               device="cuda"), n),
                ("4097 rows 5 bytes off the grid",
                 torch.rand((4102,), generator=gen, device="cuda")[5:]
                 < 0.3, 5000)):
            hold_compact(m, capacity, f"{route} replayed, {what}",
                         got=replay_outputs(lambda: S._compact(
                             m, capacity, route)))
            replayed[f"{route}: {what}"] = "held"
    # two graphs captured on the one capture stream, the first not replayed
    # before the second is captured and replayed, then both replayed on two
    # streams at once: each answers its own mask (each captured launch has
    # a state of its own); a capture with no state set aside is refused
    twins = [(torch.rand((n,), generator=gen, device="cuda") < d)
             for d in (0.036, 0.5)]
    for m in twins:
        S.compact(m, n)
    torch.cuda.synchronize()
    S._SPARE.pop(torch.cuda.current_device(), None)
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            S.compact(twins[0], n)
    except RuntimeError as e:
        if "reserve_graph_states" not in str(e):
            raise
    else:
        raise AssertionError("a compaction was captured with no state set "
                             "aside")
    graphs, twin_outs = [], []
    for m in twins:
        S.reserve_graph_states(m.device, 3)
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            twin_outs.append([S.compact(m, n) for _ in range(3)])
    graphs[1].replay()
    streams = [torch.cuda.Stream() for _ in graphs]
    torch.cuda.synchronize()
    for _ in range(3):
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
    torch.cuda.synchronize()
    for k, (m, outs) in enumerate(zip(twins, twin_outs)):
        for j, got in enumerate(outs):
            hold_compact(m, n, f"graph {k} of two captured apart, call {j}",
                         got=got)
    replayed["two graphs captured apart, replayed at once"] = "held"
    del graphs, twin_outs, twins
    if any(v != {1} for v in launches.values()):
        raise AssertionError(f"compact counted {launches} launches a call; "
                             f"one is the design")
    say("kernel_check", kernel="compact", compactions=compactions,
        launches_per_call={k: sorted(v) for k, v in launches.items()},
        graph_replays=replayed, tolerance=0)
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


# spin kernels each profile starts with: the profiler has dropped the
# first device events of a session (11 in a run of this script on an H100,
# so that one kernel a call counted 0.45 over 20 calls), and these absorb
# them; their rows are left out
PROFILE_LEAD = 32


def _cuda_rows(fn, reps: int, units: int = 0) -> list:
    """(kernel name, ms, launches) of ``reps`` calls of ``fn`` from
    ``torch.profiler``'s device rows, divided by ``units`` (default: by
    ``reps``), largest first; ``PROFILE_LEAD`` spin kernels go first and
    are not counted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "spin_kernel" in ev.key:
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
        self.sizes = []  # bytes of tensor arguments, every call in order

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
            self.sizes.append(size)
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


def _kernel_taps():
    """Taps on ``gather_rows``, ``scatter_distinct``, ``compact``,
    ``take_along_axis``, ``concat_rows`` and ``dense_group_agg`` in every
    module of the port that binds them."""
    from presto1_tpu_torch.exec import executor as X
    from presto1_tpu_torch.ops import common as C, hashagg as H, \
        join as J, segments as SEG, window as W
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D, \
        dyncopy as DC, gather as G, scatter as S
    from presto1_tpu_torch.parallel import dist_join as PJ, \
        distributed as PD, exchange as PE

    # batch.py looks gather_rows up in G at each call, expr/eval.py
    # take_along_axis and batch.concat_many concat_rows likewise; the
    # executor binds gather_rows (Unnest, MarkDistinct) and scatter_distinct
    # (MarkDistinct); the mesh plane binds gather_rows (the exchange's pack,
    # the received rows' compaction, the dryrun join), concat_rows (the
    # exchange's receive side) and dense_group_agg (the Q1 step)
    return (_Tap("gather_rows", [G, C, H, SEG, J, W, X, PE, PJ, PD]),
            _Tap("scatter_distinct", [S, J, W, X]), _Tap("compact", [S, SEG]),
            _Tap("take_along_axis", [G, W]),
            _Tap("concat_rows", [DC, PE, X]),
            _Tap("dense_group_agg", [D, H, PD]))


# the wrapper each launch counter's kernel is tapped at
_TAPPED = {"gather": "gather_rows", "scatter": "scatter_distinct",
           "compact": "compact", "take_along_axis": "take_along_axis",
           "dyncopy": "concat_rows", "dense_group_agg": "dense_group_agg"}


def _outputs(x) -> list:
    """A wrapper's result as a list of tensors (``dense_group_agg``'s
    counts, first rows and every slot in its own type)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x.counts, x.first_row] + [x.slot(k)
                                      for k in range(x.table.shape[1])]


def _hold_taps(what: str, taps, must) -> dict:
    """Every call a tap kept (the largest of each kind a path made) through
    the kernel and through its plain version on the same inputs: equal by
    ``torch.equal`` (a float64 sum of ``dense_group_agg`` to 1e-9 relative,
    as its kernel check holds it: the summation order differs), or the run
    fails.  ``must`` names the wrappers the path has to have called: a tap
    among them that caught no call fails the run (a module that reached the
    kernel around the tapped name).  Returns, per kernel, the calls held,
    the measured largest |difference| of the exact outputs and the largest
    relative difference of the summed ones."""
    from presto1_tpu_torch.ops.kernels import dense_group_agg as D, \
        dyncopy as DC, filter_sum as F, gather as G, scatter as S

    plain = {"range_filter_limb_sums": F.range_filter_limb_sums_plain,
             "gather_rows": G.gather_rows_plain,
             "scatter_distinct": S.scatter_distinct_plain,
             "compact": S.compact_plain,
             "take_along_axis": G.take_along_axis_plain,
             "concat_rows": DC.concat_rows_plain,
             "dense_group_agg": D.dense_group_agg_plain}
    out = {}
    for tap in taps:
        worst, worst_rel, most = 0.0, 0.0, 0
        for kind, (size, args, kwargs) in tap.calls.items():
            got = _outputs(tap.orig(*args, **kwargs))
            want = _outputs(plain[tap.name](*args, **kwargs))
            for a, b in zip(got, want, strict=True):
                summed = tap.name == "dense_group_agg" \
                    and a.dtype == torch.float64
                if a.shape != b.shape or a.dtype != b.dtype or not (
                        _rel_err(a, b) <= 1e-9 if summed
                        else torch.equal(a, b)):
                    raise AssertionError(
                        f"{tap.name} disagrees with its plain version on "
                        f"{what}'s call {kind}")
                if summed:
                    worst_rel = max(worst_rel, _rel_err(a, b))
                else:
                    worst = max(worst, _abs_err(a, b))
            most = max(most, size)
        if not tap.calls and tap.name in must:
            raise AssertionError(f"{what} made no call of {tap.name}")
        out[tap.name] = {"calls_held": len(tap.calls),
                         "largest_input_bytes": most, "max_abs_err": worst,
                         "max_rel_err_of_float64_sums": worst_rel}
    return out


def _engine_steps(engine, sql: str, check, reps: int) -> dict:
    """Drive one statement down the main path -- ``Engine.sql``,
    ``Engine.compile`` (its discovery run), ``cq()``, ``block_run(reps)`` --
    with every kernel's launch counter set to 0 just before and read around
    each step, then one more compiled run with PyTorch's synchronisation
    check set to raise.  ``check(batch)`` holds a result against the host
    reference."""
    read = _counting()
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
                 for i, s in enumerate(names)} for k in marks[0]}
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
            "profile": profile, "ms_trials": ms_trials,
            "compact_rows": list(taps[2].sizes),
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
    with contextlib.ExitStack() as stack:
        for tap in taps:
            stack.enter_context(tap)
        check(engine.sql(sql), "Engine.sql (tapped)")
    held = _hold_taps(name, taps, must=[_TAPPED[k] for k in need
                                        if k in _TAPPED])
    ms_trials = [_run_ms(run["cq"], reps) for _ in range(2)]
    return {"run": run, "ms": sum(ms_trials) / 2, "ms_trials": ms_trials,
            "profile": _profile(run["cq"]), "held": held,
            "gather_args": taps[0].args, "scatter_args": taps[1].args,
            "compact_args": taps[2].args, "take_args": taps[3].args,
            # a bool mask's bytes are its rows
            "compact_rows": list(taps[2].sizes)}


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
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"],
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
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"],
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
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"],
            "gather_args": out["gather_args"]}


def _numpy_q7(catalog) -> tuple:
    """TPC-H Q7 (clause 2.4.7: NATION1 FRANCE, NATION2 GERMANY) over host
    columns in int64: rows of (supp_nation, cust_nation, l_year, unscaled
    revenue at scale 4) in the statement's order."""
    t0 = time.time()
    li, _, _, _ = _load_columns(catalog, "lineitem",
                                ("l_orderkey", "l_suppkey", "l_extendedprice",
                                 "l_discount", "l_shipdate"))
    orders, _, _, _ = _load_columns(catalog, "orders",
                                    ("o_orderkey", "o_custkey"))
    cust, _, _, _ = _load_columns(catalog, "customer",
                                  ("c_custkey", "c_nationkey"))
    supp, _, _, _ = _load_columns(catalog, "supplier",
                                  ("s_suppkey", "s_nationkey"))
    nat, _, ndicts, _ = _load_columns(catalog, "nation",
                                      ("n_nationkey", "n_name"))
    load_s = time.time() - t0
    names = np.asarray(ndicts["n_name"])[nat["n_name"]]
    m = (li["l_shipdate"] >= _day("1995-01-01")) \
        & (li["l_shipdate"] <= _day("1996-12-31"))
    sn, h1 = _lookup(supp["s_suppkey"], supp["s_nationkey"],
                     li["l_suppkey"][m])
    ck, h2 = _lookup(orders["o_orderkey"], orders["o_custkey"],
                     li["l_orderkey"][m])
    cn, h3 = _lookup(cust["c_custkey"], cust["c_nationkey"], ck)
    sname, h4 = _lookup(nat["n_nationkey"], names, sn)
    cname, h5 = _lookup(nat["n_nationkey"], names, cn)
    keep = h1 & h2 & h3 & h4 & h5 & (
        ((sname == "FRANCE") & (cname == "GERMANY"))
        | ((sname == "GERMANY") & (cname == "FRANCE")))
    year = li["l_shipdate"][m].astype("datetime64[D]") \
        .astype("datetime64[Y]").astype(np.int64) + 1970
    volume = li["l_extendedprice"][m].astype(np.int64) \
        * (100 - li["l_discount"][m].astype(np.int64))
    rows = []
    for s_ in sorted(set(sname[keep].tolist())):
        for c_ in sorted(set(cname[keep].tolist())):
            for y in sorted(set(year[keep].tolist())):
                g = keep & (sname == s_) & (cname == c_) & (year == y)
                if g.any():
                    rows.append((s_, c_, y, int(volume[g].sum())))
    return rows, int(keep.sum()), load_s


def phase_q7_engine(catalog) -> dict:
    """TPC-H Q7 at the catalog's scale factor: the civil-date slice.
    ``extract(year from l_shipdate)`` over the lineitem rows of two years,
    five N:1 inner joins (supplier, orders, customer and the nation table
    twice) and a grouped sum of the four (nation, nation, year) groups."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpch.queries import QUERIES

    want, joined, load_s = _numpy_q7(catalog)
    if len(want) != 4:
        raise AssertionError(f"Q7 reference has {len(want)} rows, not 4: "
                             f"the data is wrong")
    types = ["varchar", "varchar", "bigint", "decimal(38,4)"]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected Q7 output columns")
        if batch.num_rows != len(want):
            raise AssertionError(f"{what}: {batch.num_rows} rows, numpy "
                                 f"{len(want)}")
        k = batch.num_rows
        for c in cols:
            if c.validity is not None and not bool(c.validity[:k].all()):
                raise AssertionError(f"{what}: NULL in Q7's output")
        got = list(zip([str(v) for v in cols[0].decode(k)],
                       [str(v) for v in cols[1].decode(k)],
                       *[c.data[:k].cpu().tolist() for c in cols[2:]]))
        if got != want:
            raise AssertionError(f"{what}: Q7 {got} != numpy {want}")

    engine = Engine(catalog, device="cuda")
    out = _engine_phase("Q7", engine, QUERIES[7], check,
                        need=("gather", "scatter", "compact"))
    run = out["run"]
    say("q7_engine", sf=catalog.sf, load_seconds=load_s,
        lineitem_rows=catalog.table("lineitem").num_rows,
        supplier_rows=catalog.table("supplier").num_rows,
        rows_joined=joined, rows=[list(r) for r in want],
        launches=run["launches"], launches_per_step=run["launches_per_step"],
        ms_per_run=out["ms"], ms_trials=out["ms_trials"],
        profile=out["profile"], held_against_plain=out["held"],
        agrees_with=["numpy int64 exactly (4 rows)", "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"]}


def _numpy_q98(catalog) -> tuple:
    """TPC-DS Q98 over host columns: the groups of (i_item_id, i_item_desc,
    i_category, i_class, i_current_price) with their unscaled revenue and
    the ratio as the engine computes it (the revenue times 100.0000 as a
    double over the class's revenue as a double), in the statement's order,
    the first 100; NULL is None and sorts last."""
    t0 = time.time()
    ss, ssv, _, _ = _load_columns(
        catalog, "store_sales",
        ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    it, itv, itd, _ = _load_columns(
        catalog, "item", ("i_item_sk", "i_item_id", "i_item_desc",
                          "i_category", "i_class", "i_current_price"))
    dd, ddv, _, _ = _load_columns(catalog, "date_dim",
                                  ("d_date_sk", "d_date"))
    load_s = time.time() - t0
    n = len(ss["ss_item_sk"])

    def valid(v, c, k):
        return np.ones(k, bool) if v[c] is None else v[c]

    day_ok = valid(ddv, "d_date", len(dd["d_date"])) \
        & (dd["d_date"] >= _day("1999-02-22")) \
        & (dd["d_date"] <= _day("1999-03-24"))
    ok_d, hit_d = _lookup(dd["d_date_sk"], day_ok, ss["ss_sold_date_sk"],
                          valid(ssv, "ss_sold_date_sk", n))
    row, hit_i = _lookup(it["i_item_sk"], np.arange(len(it["i_item_sk"])),
                         ss["ss_item_sk"], valid(ssv, "ss_item_sk", n))

    def values(c):
        """Item column ``c`` as Python values per item row (None = NULL)."""
        data = it[c]
        if itd[c] is not None:
            data = np.asarray(itd[c])[data]
        ok = valid(itv, c, len(data))
        return [v if o else None for v, o in zip(data.tolist(), ok)]

    cols = {c: values(c) for c in ("i_item_id", "i_item_desc", "i_category",
                                   "i_class", "i_current_price")}
    m = ok_d & hit_d & hit_i
    price = ss["ss_ext_sales_price"]
    pvalid = valid(ssv, "ss_ext_sales_price", n)
    groups = {}
    for r, p, pv in zip(row[m].tolist(), price[m].tolist(),
                        pvalid[m].tolist()):
        if cols["i_category"][r] not in ("Sports", "Books", "Home"):
            continue
        key = tuple(cols[c][r] for c in cols)
        s_ = groups.setdefault(key, [0, 0])
        if pv:
            s_[0] += p
            s_[1] += 1
    revenue = {k: (s_[0] if s_[1] else None) for k, s_ in groups.items()}
    by_class = {}
    for k, r in revenue.items():
        if r is not None:
            by_class.setdefault(k[3], []).append(r)
    rows = []
    for k, r in revenue.items():
        total = sum(by_class[k[3]]) if k[3] in by_class else None
        ratio = None if r is None or total is None else \
            (float(r * 1_000_000) / 1e6) / (float(total) / 100)
        rows.append((*k, r, ratio))

    def last_null(v):
        return (v is None, v if v is not None else 0)

    rows.sort(key=lambda t: (last_null(t[2]), last_null(t[3]),
                             last_null(t[0]), last_null(t[1]),
                             last_null(t[6])))
    return rows[:100], int(m.sum()), len(rows), load_s


def phase_q98_engine(catalog) -> dict:
    """TPC-DS Q98 at the catalog's scale factor: a window over an
    aggregate (the revenue of each item as a share of its class's) after
    the joins of store_sales with date_dim and item, then a TopN."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpcds.queries import QUERIES

    want, joined, groups, load_s = _numpy_q98(catalog)
    if len(want) != 100 or groups <= 100:
        raise AssertionError(f"Q98 reference has {groups} groups: the data "
                             f"is wrong")
    types = ["varchar", "varchar", "varchar", "varchar", "decimal(7,2)",
             "decimal(38,2)", "double"]

    def order_key(r):
        return r[2], r[3], r[0], r[1]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected Q98 output columns")
        if batch.num_rows != len(want):
            raise AssertionError(f"{what}: {batch.num_rows} rows, numpy "
                                 f"{len(want)}")
        k = batch.num_rows
        got = [list(c.decode(k)) for c in cols[:4]]
        for c in cols[4:]:
            data = c.data[:k].cpu().tolist()
            ok = [True] * k if c.validity is None \
                else c.validity[:k].cpu().tolist()
            got.append([d if o else None for d, o in zip(data, ok)])
        got = [tuple(None if v is None else (str(v) if j < 4 else v)
                     for j, v in enumerate(r)) for r in zip(*got)]
        # the ORDER BY keys row by row; the ratio to 1e-9 relative
        for r, (g, w) in enumerate(zip(got, want)):
            same_ratio = (g[6] is None and w[6] is None) or (
                g[6] is not None and w[6] is not None
                and abs(g[6] - w[6]) <= 1e-9 * abs(w[6]))
            if order_key(g) != order_key(w) or not same_ratio:
                raise AssertionError(f"{what}: Q98 row {r}: {g} != numpy "
                                     f"{w}")
        # and every row's price and revenue, where ties of the keys may
        # order rows either way
        if sorted(map(str, (r[:6] for r in got))) != \
                sorted(map(str, (r[:6] for r in want))):
            raise AssertionError(f"{what}: Q98's rows differ from numpy's")

    engine = Engine(catalog, device="cuda")
    out = _engine_phase("Q98", engine, QUERIES[98], check,
                        need=("gather", "scatter", "compact"))
    run = out["run"]
    say("q98_engine", sf=catalog.sf, load_seconds=load_s,
        store_sales_rows=catalog.table("store_sales").num_rows,
        rows_joined=joined, groups=groups, first_rows=want[:3],
        launches=run["launches"], launches_per_step=run["launches_per_step"],
        ms_per_run=out["ms"], ms_trials=out["ms_trials"],
        profile=out["profile"], held_against_plain=out["held"],
        agrees_with=["numpy (keys and sums exactly, ratios to 1e-9 "
                     "relative)", "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"]}


WINDOW_SQL = """select l_orderkey, l_linenumber, l_suppkey,
    row_number() over (partition by l_orderkey order by l_linenumber) rn,
    rank() over (partition by l_orderkey order by l_linenumber) rk,
    sum(l_quantity) over (partition by l_orderkey) qty,
    min(l_extendedprice) over (partition by l_suppkey
        order by l_shipdate, l_orderkey, l_linenumber
        rows between 3 preceding and current row) mn
from lineitem"""


def _numpy_window(li: dict) -> dict:
    """``WINDOW_SQL`` over host columns in int64, in the table's row
    order."""
    ok, ln, sk = li["l_orderkey"], li["l_linenumber"], li["l_suppkey"]
    n = len(ok)
    at = np.arange(n)
    o1 = np.lexsort((at, ln, ok))
    sok, sln = ok[o1], ln[o1]
    part = np.r_[True, sok[1:] != sok[:-1]]
    peer = part | np.r_[True, sln[1:] != sln[:-1]]
    pstart = np.maximum.accumulate(np.where(part, at, 0))
    qstart = np.maximum.accumulate(np.where(peer, at, 0))
    rn, rk = np.empty(n, np.int64), np.empty(n, np.int64)
    rn[o1] = at - pstart + 1
    rk[o1] = qstart - pstart + 1
    keys, inverse = np.unique(ok, return_inverse=True)
    total = np.zeros(len(keys), np.int64)
    np.add.at(total, inverse, li["l_quantity"].astype(np.int64))
    o2 = np.lexsort((at, ln, ok, li["l_shipdate"], sk))
    s2 = sk[o2]
    v = li["l_extendedprice"][o2].astype(np.int64)
    low = v.copy()
    for k in (1, 2, 3):
        same = np.r_[np.zeros(k, bool), s2[k:] == s2[:-k]]
        prev = np.r_[np.zeros(k, np.int64), v[:-k]]
        low = np.where(same, np.minimum(low, prev), low)
    mn = np.empty(n, np.int64)
    mn[o2] = low
    return {"l_orderkey": ok, "l_linenumber": ln, "l_suppkey": sk,
            "rn": rn, "rk": rk, "qty": total[inverse], "mn": mn}


def phase_window_engine(catalog) -> dict:
    """``WINDOW_SQL`` over every lineitem row: four windows, each one sort
    of the table by its partition and order keys, partition and peer
    bounds through the compaction, inputs through the gather, a sliding
    min through the doubling table read by ``take_along_axis``, and the
    results back to row order through ``scatter_distinct``."""
    from presto1_tpu_torch.exec.engine import Engine

    t0 = time.time()
    li, _, _, _ = _load_columns(catalog, "lineitem",
                                ("l_orderkey", "l_linenumber", "l_suppkey",
                                 "l_quantity", "l_extendedprice",
                                 "l_shipdate"))
    load_s = time.time() - t0
    t0 = time.time()
    want = _numpy_window(li)
    numpy_s = time.time() - t0
    n = len(want["rn"])
    types = ["bigint", "integer", "bigint", "bigint", "bigint",
             "decimal(38,2)", "decimal(12,2)"]

    def check(batch, what):
        cols = list(batch.columns.values())
        if [str(c.type) for c in cols] != types or \
                not all(c.data.is_cuda for c in cols):
            raise AssertionError(f"{what}: unexpected window output columns")
        if batch.num_rows != n:
            raise AssertionError(f"{what}: {batch.num_rows} rows, not {n}")
        for name, c in batch.columns.items():
            if c.validity is not None and not bool(c.validity[:n].all()):
                raise AssertionError(f"{what}: NULL in {name}")
            got = c.data[:n].cpu().numpy().astype(np.int64)
            if not np.array_equal(got, want[name].astype(np.int64)):
                bad = int(np.argmax(got != want[name]))
                raise AssertionError(
                    f"{what}: {name} at row {bad}: {got[bad]} != numpy "
                    f"{want[name][bad]}")

    engine = Engine(catalog, device="cuda")
    out = _engine_phase("window", engine, WINDOW_SQL, check,
                        need=("gather", "scatter", "compact",
                              "take_along_axis"))
    run = out["run"]
    say("window_engine", sf=catalog.sf, lineitem_rows=n,
        load_seconds=load_s, numpy_seconds=numpy_s, statement=WINDOW_SQL,
        launches=run["launches"], launches_per_step=run["launches_per_step"],
        ms_per_run=out["ms"], ms_trials=out["ms_trials"],
        profile=out["profile"], held_against_plain=out["held"],
        agrees_with=["numpy int64 exactly (every row of 7 columns)",
                     "eager == compiled"])
    return {"launches": run["launches"], "ms_per_run": out["ms"],
            "profile": out["profile"], "held": out["held"],
            "ms_trials": out["ms_trials"], "compact_rows": out["compact_rows"],
            "take_args": out["take_args"]}


# ------------------------------------------------------------------------
# Bounded device memory: per-query limits, spilling through host RAM,
# grouped compiled execution, sampled discovery and EXPLAIN ANALYZE.

SPILL_THRESHOLD = 16 << 20  # bytes: every SF1 join and aggregation below
# spills into 4 or more partitions


def phase_pcie_rate() -> dict:
    """Page-locked host -> device and device -> host ``copy_`` of 256 MiB,
    CUDA events: the bound of every spill and every grouped upload."""
    nbytes = 256 << 20
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.random_(0, 255)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), reps=5,
                  trials=5)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), reps=5,
                  trials=5)
    out = {"h2d_bytes_per_s": nbytes / (h2d * 1e-3),
           "d2h_bytes_per_s": nbytes / (d2h * 1e-3)}
    say("pcie_rate", mib=256, h2d_ms=h2d, d2h_ms=d2h, **out,
        memory="page-locked host")
    return out


def _rows(batch) -> list:
    """A batch's live rows as tuples: strings decoded, decimals unscaled."""
    k = batch.num_rows
    cols = []
    for c in batch.columns.values():
        if c.validity is not None and not bool(c.validity[:k].all()):
            raise AssertionError("NULL in a checked result")
        cols.append(list(c.decode(k)) if c.dictionary is not None
                    else c.data[:k].cpu().tolist())
    return [tuple(r) for r in zip(*cols)]


def _match(got: list, want: list, what: str) -> None:
    """Row for row: floats to 1e-9 relative, everything else exactly."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, expected "
                             f"{len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w, strict=True)):
            ok = abs(a - b) <= 1e-9 * abs(b) if isinstance(b, float) \
                else a == b
            if not ok:
                raise AssertionError(f"{what}: row {r} column {j}: {a!r} "
                                     f"!= {b!r}")


def _numpy_q18(li, orders, cust, cdicts) -> list:
    """TPC-H Q18 over host columns in int64: (c_name, c_custkey,
    o_orderkey, o_orderdate, o_totalprice, unscaled sum(l_quantity))."""
    okey = orders["o_orderkey"]
    sums = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                       minlength=int(okey.max()) + 1
                       ).astype(np.int64)  # exact: every sum < 2**53
    sel = sums[okey] > 30000  # sum(l_quantity) > 300 at scale 2
    keys = okey[sel]
    ckey = orders["o_custkey"][sel]
    code, _ = _lookup(cust["c_custkey"], cust["c_name"], ckey)
    names = np.asarray(cdicts["c_name"])[code]
    odate, total = orders["o_orderdate"][sel], orders["o_totalprice"][sel]
    top = np.lexsort((odate, -total))[:100]
    return [(str(names[i]), int(ckey[i]), int(keys[i]), int(odate[i]),
             int(total[i]), int(sums[keys[i]])) for i in top]


def _bounded_references(catalog) -> dict:
    """numpy answers of TPC-H Q1, Q3, Q6 and Q18 over the catalog's host
    columns, as the engine's output rows (see ``_rows``)."""
    li, _, ldicts, _ = _load_columns(
        catalog, "lineitem", ("l_orderkey", "l_quantity", "l_extendedprice",
                              "l_discount", "l_tax", "l_returnflag",
                              "l_linestatus", "l_shipdate"))
    orders, _, _, _ = _load_columns(
        catalog, "orders", ("o_orderkey", "o_custkey", "o_orderdate",
                            "o_shippriority", "o_totalprice"))
    cust, _, cdicts, _ = _load_columns(
        catalog, "customer", ("c_custkey", "c_mktsegment", "c_name"))
    s6, _ = _numpy_q6(li)
    return {
        1: _numpy_q1(li, ldicts["l_returnflag"], ldicts["l_linestatus"]),
        3: _numpy_q3(li, orders, cust,
                     _code(cdicts["c_mktsegment"], "BUILDING")),
        6: [(s6,)],
        18: _numpy_q18(li, orders, cust, cdicts),
    }


def _counting():
    """Set every launch counter to 0; returns a reader of them."""
    from presto1_tpu_torch.ops.kernels import launch_counters

    counters = launch_counters()
    for m, attr in counters.values():
        setattr(m, attr, 0)
    return lambda: {k: getattr(m, attr) for k, (m, attr) in counters.items()}


def phase_memory_limit(catalog) -> None:
    """``query_max_memory`` on the card: below TPC-H Q1's eager working set
    ``Engine.sql`` raises ``ExceededMemoryLimitError``; at it, it answers.
    The accounted peak beside the allocator's for the same statement."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.executor import Executor, _node_at
    from presto1_tpu_torch.exec.memory import (ExceededMemoryLimitError,
                                               QueryMemoryContext)
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.tpch.queries import QUERIES

    sql = QUERIES[1]
    plan = Engine(catalog, device="cuda").plan(sql)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ctx = QueryMemoryContext("q1", max_bytes=None)
    Executor(catalog, memory=ctx, device="cuda").execute(plan)
    torch.cuda.synchronize()
    allocator_peak = torch.cuda.max_memory_allocated() - start
    limits = {}
    for limit in (ctx.peak - 1, ctx.peak):
        s = Session()
        s.set("query_max_memory", limit)
        try:
            rows = Engine(catalog, session=s, device="cuda").sql(sql).num_rows
            limits[limit] = f"answered {rows} rows"
        except ExceededMemoryLimitError as e:
            limits[limit] = f"raised: {e}"
    if not limits[ctx.peak - 1].startswith("raised") or \
            not limits[ctx.peak].startswith("answered 4"):
        raise AssertionError(f"query_max_memory not enforced: {limits}")
    say("memory_limit", statement="TPC-H Q1 eager", accounted_peak=ctx.peak,
        allocator_peak_above_start=allocator_peak,
        allocator_peak=torch.cuda.max_memory_allocated(),
        resident_before=start,
        outcome={str(k): v for k, v in limits.items()})


def phase_spill_engine(catalog, refs, pcie) -> dict:
    """Eager ``Engine.sql`` of TPC-H Q1, Q3 and Q18 with a 16 MiB spill
    threshold: every large aggregation and join partitioned through
    page-locked host RAM.  Each answer against numpy and the unbounded
    run; each spilled operator's partitions and bytes; launches by
    kernel."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.exec.stats import QueryStats
    from presto1_tpu_torch.sql.logical import Aggregate, Join
    from presto1_tpu_torch.tpch.queries import QUERIES

    s = Session()
    s.set("spill_threshold", SPILL_THRESHOLD)
    engine = Engine(catalog, session=s, device="cuda")
    plain = Engine(catalog, device="cuda")
    out, total = {}, {}
    for q in (1, 3, 18):
        sql = QUERIES[q]
        read = _counting()
        stats = QueryStats()
        torch.cuda.synchronize()
        t0 = time.time()
        got = engine.sql(sql, stats=stats)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        launches = read()
        _match(_rows(got), refs[q], f"spilled Q{q} vs numpy")
        _same_batches(got, plain.sql(sql), f"spilled Q{q} vs unbounded")
        plan = engine.plan(sql)
        spilled = []
        for path, op in sorted(stats.operators.items()):
            if op.spill:
                node = plan
                for i in path:
                    node = node.children[i]
                what = (f"Join {node.kind}" if isinstance(node, Join)
                        else f"Aggregate by {','.join(node.group)}"
                        if isinstance(node, Aggregate) else op.name)
                spilled.append({"path": list(path), "operator": what,
                                **op.spill})
        to_host = sum(x["to_host_bytes"] for x in spilled)
        from_host = sum(x["from_host_bytes"] for x in spilled)
        bound_ms = 1e3 * (to_host / pcie["d2h_bytes_per_s"]
                          + from_host / pcie["h2d_bytes_per_s"])
        out[q] = {"ms": ms, "spilled": spilled, "to_host_bytes": to_host,
                  "from_host_bytes": from_host, "pcie_bound_ms": bound_ms,
                  "launches": launches}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    # the operators this phase must have partitioned 4 ways or more
    q3_join = [x for x in out[3]["spilled"]
               if x["operator"] == "Join inner" and x["partitions"] >= 4]
    q18_agg = [x for x in out[18]["spilled"]
               if x["operator"].startswith("Aggregate by l_orderkey")
               and x["partitions"] >= 4]
    if not q3_join or not q18_agg:
        raise AssertionError("Q3's lineitem join or Q18's group by "
                             "l_orderkey did not spill 4 ways")
    for k in ("dense_group_agg", "gather", "compact", "scatter"):
        if total[k] < 1:
            raise AssertionError(f"the spill paths never launched {k}")
    # outside the counted runs: the spilled Q18's gather, scatter and
    # compaction calls, the largest of each kind, against the plain versions
    taps = _kernel_taps()
    with contextlib.ExitStack() as stack:
        for tap in taps:
            stack.enter_context(tap)
        _match(_rows(engine.sql(QUERIES[18])), refs[18], "spilled Q18 "
               "(tapped)")
    held = _hold_taps("spilled Q18", taps,
                      must=["gather_rows", "scatter_distinct", "compact"])
    say("spill_engine", spill_threshold=SPILL_THRESHOLD, statements=out,
        held_against_plain=held,
        agrees_with=["numpy int64 exactly (averages to 1e-9 relative)",
                     "the unbounded Engine.sql"])
    return {"launches": total, "statements": out, "held": held}


def phase_grouped_engine(fresh, refs, plain) -> dict:
    """``Engine.compile_grouped`` from a catalog that has never uploaded
    lineitem whole: TPC-H Q1 at K = 2, 4 and 8, Q6 at K = 8 (each shard's
    partial through ``filter_sum``), Q3 at K = 4; then the ungrouped
    compiled Q1 from the same catalog, measured the same way (peak device
    memory above the phase's start).  Q18 is refused."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.ops.kernels import dyncopy as DC
    from presto1_tpu_torch.tpch.queries import QUERIES

    engine = Engine(fresh, device="cuda")
    lineitem = fresh.table("lineitem")
    out, total = {}, {}

    def measured(make, run):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        read = _counting()
        t0 = time.time()
        q = make()
        first = run(q)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        launches_first = read()
        read = _counting()
        t0 = time.time()
        again = run(q)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        return q, first, again, {
            "first_call_s": first_s, "run_ms": ms,
            "peak_bytes_above_start": torch.cuda.max_memory_allocated()
            - start, "launches_first_call": launches_first,
            "launches": read()}

    for q, k in ((1, 2), (1, 4), (1, 8), (6, 8), (3, 4)):
        gq, first, again, m = measured(
            lambda: engine.compile_grouped(QUERIES[q], n_groups=k),
            lambda g: g())
        for got, what in ((first, "first"), (again, "second")):
            _match(_rows(got), refs[q], f"grouped Q{q} K={k} ({what} call) "
                   "vs numpy")
            # (a grouped count is a final sum, so it carries a validity
            # mask the unbounded count does not: values are compared)
            _match(_rows(got), _rows(plain[q]),
                   f"grouped Q{q} K={k} vs unbounded")
        if lineitem._cache:
            raise AssertionError("a grouped query uploaded lineitem whole")
        # one shard's compiled program never waits for the host
        cq = next(iter(gq._programs.values()))
        inputs, ready = gq._upload(0, torch.cuda.Stream())
        torch.cuda.current_stream().wait_event(ready)
        cq.inputs = inputs
        torch.cuda.set_sync_debug_mode("error")
        try:
            cq._run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        cq.inputs = None
        out[f"q{q}_k{k}"] = {"info": dict(gq.info), **m}
        for name, v in m["launches"].items():
            total[name] = total.get(name, 0) + v
    for name in ("dense_group_agg", "filter_sum", "dyncopy"):
        if total[name] < 1:
            raise AssertionError(f"grouped runs never launched {name}")
    if out["q6_k8"]["launches"]["filter_sum"] != 8:
        raise AssertionError("grouped Q6's shards lost the filter_sum "
                             f"route: {out['q6_k8']['launches']}")
    try:
        engine.compile_grouped(QUERIES[18], n_groups=4)
        raise AssertionError("grouped Q18 was not refused")
    except ValueError as e:
        refused = str(e)
    # the merge of grouped Q3's partials, as the engine hands them over,
    # against the plain version
    with _Tap("concat_rows", [DC]) as tap:
        engine.compile_grouped(QUERIES[3], n_groups=4)()
    merge_err = 0.0
    for _, (size, args, kwargs) in tap.calls.items():
        for a, b in zip(DC.concat_rows(*args, **kwargs),
                        DC.concat_rows_plain(*args, **kwargs), strict=True):
            if not torch.equal(a, b):
                raise AssertionError("dyncopy disagrees with its plain "
                                     "version at the grouped merge")
            merge_err = max(merge_err, _abs_err(a, b))
    _, first, _, m = measured(lambda: engine.compile(QUERIES[1]),
                              lambda c: c())
    _match(_rows(first), refs[1], "ungrouped compiled Q1 vs numpy")
    out["q1_ungrouped"] = m
    ratio = out["q1_k8"]["peak_bytes_above_start"] \
        / m["peak_bytes_above_start"]
    if ratio > 0.5:
        raise AssertionError(f"grouped Q1 at K=8 peaks at {ratio:.3f} of "
                             "the ungrouped compiled Q1")
    say("grouped_engine", runs=out, q1_k8_peak_over_ungrouped=ratio,
        q18_refused=refused, merge_max_abs_err=merge_err,
        merge_calls_held=len(tap.calls),
        agrees_with=["numpy int64 exactly (averages to 1e-9 relative)",
                     "the unbounded Engine.sql"])
    return {"launches": total, "runs": out, "merge_err": merge_err}


def phase_sampled_discovery(catalog, refs) -> dict:
    """``Engine.compile(sql, sample={"lineitem": 3})`` against
    ``sample=None`` for TPC-H Q1, Q3 and Q18: equal answers (and numpy's),
    discovery seconds both ways, in turns; one sampled run under the
    synchronisation check; a deliberately small margin raises
    ``ExecError``."""
    from presto1_tpu_torch.exec import sampling
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.executor import CompiledQuery, ExecError
    from presto1_tpu_torch.tpch.queries import QUERIES

    engine = Engine(catalog, device="cuda")
    sample = {"lineitem": 3}
    out = {}
    for q in (1, 3, 18):
        sql = QUERIES[q]
        secs = {"full": [], "sampled": []}
        for order in (("full", "sampled"), ("sampled", "full")):
            for how in order:
                torch.cuda.synchronize()
                t0 = time.time()
                cq = engine.compile(sql, sample=None if how == "full"
                                    else sample)
                torch.cuda.synchronize()
                secs[how].append(time.time() - t0)
                got = cq()
                _match(_rows(got), refs[q], f"Q{q} discovery {how} vs "
                       "numpy")
                if how == "sampled":
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        cq._run()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    caps = dict(cq._caps)
        out[f"q{q}"] = {"discovery_s": secs, "sampled_caps": {
            "/".join(map(str, p)): c for p, c in caps.items()}}
    floor = sampling.CAP_FLOOR
    try:
        sampling.CAP_FLOOR = 1
        small = CompiledQuery(catalog, engine.plan(QUERIES[3]),
                              sample={"lineitem": 64}, sample_margin=0.001,
                              device="cuda")
    finally:
        sampling.CAP_FLOOR = floor
    try:
        small()
        raise AssertionError("an under-extrapolated run did not raise")
    except ExecError as e:
        raised = str(e)
    say("sampled_discovery", sample=sample, statements=out,
        small_margin_raised=raised,
        agrees_with=["numpy int64 exactly", "full discovery"])
    return out


def phase_explain_analyze(catalog) -> str:
    """EXPLAIN ANALYZE of the compiled TPC-H Q3: each fragment's
    steady-state time between CUDA events, rows and output bytes."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.tpch.queries import QUERIES

    s = Session()
    s.set("compile_queries", True)
    text = Engine(catalog, session=s, device="cuda").explain_analyze(
        QUERIES[3])
    print(text, flush=True)
    say("explain_analyze", statement="TPC-H Q3", lines=text.count("\n") + 1)
    return text


# ------------------------------------------------------------------------
# The rest of the single-device statement surface: several DISTINCT
# aggregates (MarkDistinct), approx_distinct (the HLL device hashes), UNNEST
# over a lambda, array functions over columns, CREATE TABLE AS / INSERT /
# DROP / SHOW over a memory table, and the system tables.

S1_SQL = ("select l_returnflag, l_linestatus, count(distinct l_partkey), "
          "count(distinct l_suppkey), count(distinct l_orderkey), count(*) "
          "from lineitem group by l_returnflag, l_linestatus")
S2_COLUMNS = ("l_orderkey", "l_partkey", "l_extendedprice")
S3_SQL = ("select count(*), sum(e), max(e) from lineitem cross join "
          "unnest(filter(array[l_partkey, l_suppkey, l_orderkey], "
          "x -> x % 3 = 0)) as t(e)")
S4_SQL = (
    "select sum(element_at(array[l_partkey, l_suppkey], "
    "1 + l_linenumber % 2)), "
    "sum(case when contains(array[l_partkey, l_suppkey], l_linenumber) "
    "then 1 else 0 end), "
    "sum(array_position(array[l_linenumber, l_suppkey % 7, l_partkey % 7], "
    "3)), "
    "sum(cardinality(filter(array[l_partkey, l_suppkey, l_orderkey], "
    "x -> x % 2 = 0))), "
    "sum(element_at(transform(array[l_partkey, l_suppkey], "
    "x -> x + l_orderkey), 2)), "
    "sum(case when any_match(array[l_partkey, l_suppkey], "
    "x -> x > l_orderkey) then 1 else 0 end) from lineitem")
COPY_COLUMNS = ("l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                "l_discount", "l_tax", "l_shipdate", "l_returnflag",
                "l_linestatus")
CTAS_SQL = ("create table li_copy as select " + ", ".join(COPY_COLUMNS)
            + " from lineitem")
INSERT_SQL = ("insert into li_copy select " + ", ".join(COPY_COLUMNS)
              + " from lineitem where l_shipdate >= date '1998-01-01'")
# a join, so that the INSERT's query has an operator that spills
INSERT_JOIN_QUERY = ("select " + ", ".join(COPY_COLUMNS)
                     + " from lineitem, orders where l_orderkey = o_orderkey"
                     " and o_orderdate >= date '1998-07-01'")
HLL_M, HLL_P = 2048, 11


def _numpy_splitmix63(v: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer of int64 values in uint64, masked to 63
    bits."""
    with np.errstate(over="ignore"):
        x = v.astype(np.int64).view(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        return (x & np.uint64((1 << 63) - 1)).astype(np.int64)


def _numpy_hll(values: np.ndarray, groups: np.ndarray, n_groups: int):
    """approx_distinct per group as the planner's sketch computes it:
    2,048 registers of the max leading-zero run, the raw estimator with the
    linear-counting correction.  Also the exact distinct counts."""
    h = _numpy_splitmix63(values)
    reg = h & (HLL_M - 1)
    w = h >> HLL_P  # < 2**52: exact in a float64, so frexp is its length
    rho = 64 - np.frexp(w.astype(np.float64))[1].astype(np.int64) - HLL_P
    key = groups.astype(np.int64) * HLL_M + reg
    packed = np.unique(key * 64 + rho)  # sorted: a key's max rho is last
    keys = packed // 64
    last = np.r_[keys[1:] != keys[:-1], True]
    keys, rmax = keys[last], packed[last] % 64
    g = keys // HLL_M
    alpha = 0.7213 / (1.0 + 1.079 / HLL_M)
    est, exact = [], []
    for k in range(n_groups):
        r = rmax[g == k]
        v0 = HLL_M - len(r)
        raw = alpha * HLL_M * HLL_M / (float(np.sum(2.0 ** -r)) + v0)
        e = HLL_M * np.log(HLL_M / v0) if raw <= 2.5 * HLL_M and v0 > 0 \
            else raw
        est.append(int(np.floor(e + 0.5)))
        exact.append(int(len(np.unique(values[groups == k]))))
    return est, exact


def _distinct_by_group(groups, values, n_groups) -> np.ndarray:
    u = np.unique(groups.astype(np.int64) * (int(values.max()) + 1)
                  + values.astype(np.int64))
    return np.bincount(u // (int(values.max()) + 1), minlength=n_groups)


def _table_host(table) -> tuple:
    cols = {c: table.host_column(c) for c in table.column_order}
    return ({c: np.asarray(col.data) for c, col in cols.items()},
            {c: col.validity for c, col in cols.items()},
            {c: col.dictionary for c, col in cols.items()})


def phase_statements_engine(catalog) -> dict:
    """S1-S6 over the SF1 lineitem: several DISTINCT aggregates, one
    approx_distinct a statement (globally and by l_returnflag), UNNEST of a
    filtered array, array functions over columns, CREATE TABLE AS / INSERT
    (refused at its accounted working set less one byte, then spilled) /
    DROP / SHOW over a memory table on the card, and the system tables.
    Every query statement down the main path (eager, compile, ``cq()``,
    ``block_run``, a compiled run under the synchronisation check), against
    int64 numpy over the same host columns."""
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.executor import Executor, _node_at
    from presto1_tpu_torch.exec.memory import (ExceededMemoryLimitError,
                                               QueryMemoryContext)
    from presto1_tpu_torch.exec.stats import QueryStats
    from presto1_tpu_torch.sql.logical import Join
    from presto1_tpu_torch.tpch.queries import QUERIES

    names = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
             "l_quantity", "l_extendedprice", "l_discount", "l_tax",
             "l_shipdate", "l_returnflag", "l_linestatus")
    li, _, ldicts, _ = _load_columns(catalog, "lineitem", names)
    n = len(li["l_orderkey"])
    engine = Engine(catalog, device=catalog.device)
    # the engine's sql calls, counted: the statements the system table of
    # queries has to list
    plain_sql, ran = engine.sql, [0]

    def counted_sql(*a, **k):
        ran[0] += 1
        return plain_sql(*a, **k)

    engine.sql = counted_sql
    results, launches = {}, {}

    def statement(key, sql, want, need=()):
        def check(batch, what):
            got = sorted(_rows(batch))
            _match(got, sorted(want), f"{key} {what}")

        out = _engine_phase(key, engine, sql, check, need=need)
        run = out["run"]
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        results[key] = {"statement": sql, "ms_per_run": out["ms"],
                        "ms_trials": out["ms_trials"],
                        "profile": out["profile"],
                        "launches": run["launches"],
                        "launches_per_compiled_run": {
                            k: s["call"]
                            for k, s in run["launches_per_step"].items()},
                        "held_against_plain": out["held"],
                        "compact_rows": out["compact_rows"]}
        return out

    # S1: three DISTINCT aggregates and a count, grouped
    g = li["l_returnflag"].astype(np.int64) * len(ldicts["l_linestatus"]) \
        + li["l_linestatus"]
    ng = len(ldicts["l_returnflag"]) * len(ldicts["l_linestatus"])
    d = {c: _distinct_by_group(g, li[c], ng)
         for c in ("l_partkey", "l_suppkey", "l_orderkey")}
    cnt = np.bincount(g, minlength=ng)
    nls = len(ldicts["l_linestatus"])
    want = [(str(ldicts["l_returnflag"][k // nls]),
             str(ldicts["l_linestatus"][k % nls]), int(d["l_partkey"][k]),
             int(d["l_suppkey"][k]), int(d["l_orderkey"][k]), int(cnt[k]))
            for k in range(ng) if cnt[k]]
    statement("S1_distinct", S1_SQL, want, need=("gather", "scatter"))

    # S2: one sketch a statement, globally and grouped by l_returnflag
    hll = {}
    rf = li["l_returnflag"]
    nrf = len(ldicts["l_returnflag"])
    for col in S2_COLUMNS:
        est, exact = _numpy_hll(li[col], np.zeros(n, np.int64), 1)
        gest, gexact = _numpy_hll(li[col], rf, nrf)
        for e, x in zip(est + gest, exact + gexact):
            if abs(e - x) > 3 * 1.04 / np.sqrt(HLL_M) * x:
                raise AssertionError(f"approx_distinct({col}): the numpy "
                                     f"sketch {e} is off {x} by more than "
                                     f"3 standard errors")
        statement(f"S2_approx_{col}",
                  f"select approx_distinct({col}) from lineitem",
                  [(est[0],)])
        present = np.bincount(rf, minlength=nrf) > 0
        statement(f"S2_approx_{col}_by_flag",
                  f"select l_returnflag, approx_distinct({col}) from "
                  "lineitem group by l_returnflag",
                  [(str(ldicts["l_returnflag"][k]), gest[k])
                   for k in range(nrf) if present[k]])
        hll[col] = {"global": {"estimate": est[0], "exact": exact[0]},
                    "by_l_returnflag": {
                        str(ldicts["l_returnflag"][k]):
                        {"estimate": gest[k], "exact": gexact[k]}
                        for k in range(nrf) if present[k]}}

    # S3: UNNEST of a lambda-filtered array; lengths 0..3 by row
    v = np.concatenate([li["l_partkey"], li["l_suppkey"], li["l_orderkey"]])
    v = v[v % 3 == 0].astype(np.int64)
    statement("S3_unnest", S3_SQL, [(len(v), int(v.sum()), int(v.max()))],
              need=("gather", "compact"))

    # S4: array functions over columns
    pk, sk, ok_ = (li[c].astype(np.int64) for c in
                   ("l_partkey", "l_suppkey", "l_orderkey"))
    ln = li["l_linenumber"].astype(np.int64)
    pos = np.where(ln == 3, 1, np.where(sk % 7 == 3, 2,
                                        np.where(pk % 7 == 3, 3, 0)))
    want = [(int(np.where(ln % 2 == 0, pk, sk).sum()),
             int(((pk == ln) | (sk == ln)).sum()), int(pos.sum()),
             int((pk % 2 == 0).sum() + (sk % 2 == 0).sum()
                 + (ok_ % 2 == 0).sum()),
             int((sk + ok_).sum()), int(((pk > ok_) | (sk > ok_)).sum()))]
    statement("S4_array_functions", S4_SQL, want,
              need=("gather", "take_along_axis"))

    # S5: writes read back
    def timed(sql, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = engine.execute_statement(sql, **kw)
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    def count(table) -> int:
        return engine.execute_statement(
            f"select count(*) from {table}").to_pylist()[0][0]

    row_bytes = sum(li[c].itemsize for c in COPY_COLUMNS)
    out, ctas_ms = timed(CTAS_SQL)
    table = catalog.table("li_copy")
    if out.to_pylist() != [(n,)] or count("li_copy") != n:
        raise AssertionError("CREATE TABLE AS did not store every row")
    host, valid, dicts = _table_host(table)
    for c in COPY_COLUMNS:
        if valid[c] is not None or not np.array_equal(host[c], li[c]) or (
                (dicts[c] is None) != (ldicts[c] is None)) or (
                dicts[c] is not None
                and not np.array_equal(dicts[c], ldicts[c])):
            raise AssertionError(f"li_copy.{c} is not lineitem's column")
    ins = li["l_shipdate"] >= _day("1998-01-01")
    out, insert_ms = timed(INSERT_SQL)
    inserted = out.to_pylist()[0][0]
    if inserted != int(ins.sum()) or count("li_copy") != n + inserted:
        raise AssertionError(f"INSERT returned {inserted} rows; "
                             f"{count('li_copy') - n} were read back")
    both = {c: np.concatenate([li[c], li[c][ins]]) for c in COPY_COLUMNS}
    s6, _ = _numpy_q6(both)
    statement("S5_q6_li_copy", re.sub(r"\blineitem\b", "li_copy",
                                      QUERIES[6]), [(s6,)],
              need=("filter_sum",))
    statement("S5_q1_li_copy", re.sub(r"\blineitem\b", "li_copy",
                                      QUERIES[1]),
              _numpy_q1(both, ldicts["l_returnflag"],
                        ldicts["l_linestatus"]),
              need=("dense_group_agg",))
    # the INSERT's query under its accounted working set less one byte:
    # refused, the table unchanged; then unlimited, spilled at 16 MiB
    ctx = QueryMemoryContext("insert", max_bytes=None)
    Executor(catalog, memory=ctx, device=catalog.device).execute(
        engine.plan(INSERT_JOIN_QUERY))
    before = count("li_copy")
    engine.session.set("query_max_memory", ctx.peak - 1)
    try:
        engine.execute_statement(f"insert into li_copy {INSERT_JOIN_QUERY}")
        raise AssertionError("the INSERT ran above its memory limit")
    except ExceededMemoryLimitError as e:
        refused = str(e)
    finally:
        engine.session.set("query_max_memory", 0)
    if count("li_copy") != before:
        raise AssertionError("a refused INSERT changed the table")
    orders, _, _, _ = _load_columns(catalog, "orders",
                                    ("o_orderkey", "o_orderdate"))
    late = orders["o_orderkey"][orders["o_orderdate"]
                                >= _day("1998-07-01")]
    join_rows = int(np.isin(li["l_orderkey"], late).sum())
    engine.session.set("spill_threshold", SPILL_THRESHOLD)
    stats = QueryStats()
    try:
        out, spilled_insert_ms = timed(
            f"insert into li_copy {INSERT_JOIN_QUERY}", stats=stats)
    finally:
        engine.session.set("spill_threshold", 0)
    plan = engine.plan(INSERT_JOIN_QUERY)
    spilled = [{"path": list(p), **op.spill}
               for p, op in stats.operators.items()
               if op.spill and isinstance(_node_at(plan, p), Join)]
    if not spilled or out.to_pylist() != [(join_rows,)] or \
            count("li_copy") != before + join_rows:
        raise AssertionError(f"the spilled INSERT: {out.to_pylist()} rows "
                             f"of {join_rows}, spilled joins {spilled}")
    engine.execute_statement("drop table li_copy")
    tables = [r[0] for r in engine.execute_statement("show tables")
              .to_pylist()]
    if "li_copy" in tables or "li_copy" in catalog:
        raise AssertionError("li_copy outlived DROP TABLE")
    writes = {
        "ctas": {"ms": ctas_ms, "rows": n, "device_to_host_bytes":
                 n * row_bytes},
        "insert_select": {"ms": insert_ms, "rows": inserted,
                          "device_to_host_bytes": inserted * row_bytes},
        "insert_refused": {"limit": ctx.peak - 1, "accounted_peak": ctx.peak,
                           "error": refused},
        "insert_spilled": {"ms": spilled_insert_ms, "rows": join_rows,
                           "spill_threshold": SPILL_THRESHOLD,
                           "spilled_joins": spilled},
        "row_bytes": row_bytes}

    # S6: the system tables
    del engine.sql
    ran = ran[0]
    q = engine.sql("select count(*) from system.runtime.queries"
                   ).to_pylist()[0][0]
    if q != ran + 1:  # the statements above, and this one (running)
        raise AssertionError(f"system.runtime.queries lists {q} "
                             f"statements; the phase ran {ran} + 1")
    nodes = engine.sql("select node_id, device from system.runtime.nodes"
                       ).to_pylist()
    name = torch.cuda.get_device_name(0)
    if len(nodes) != 1 or name not in str(nodes[0][1]):
        raise AssertionError(f"system.runtime.nodes: {nodes}")
    mem = engine.sql("select pool, capacity_bytes from "
                     "system.runtime.memory").to_pylist()
    total = torch.cuda.mem_get_info()[1]
    if not any(name in str(p) and c == total for p, c in mem):
        raise AssertionError(f"system.runtime.memory: {mem}")
    for k in ("gather", "compact", "scatter", "take_along_axis"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"the statements never launched {k}")
    held = {}
    for r in results.values():
        for k, h in r["held_against_plain"].items():
            cur = held.setdefault(k, {"calls_held": 0, "max_abs_err": 0.0,
                                      "max_rel_err_of_float64_sums": 0.0})
            cur["calls_held"] += h["calls_held"]
            for e in ("max_abs_err", "max_rel_err_of_float64_sums"):
                cur[e] = max(cur[e], h[e])
    say("statements_engine", sf=catalog.sf, lineitem_rows=n,
        statements=results, approx_distinct=hll, writes=writes,
        system_tables={"queries_listed": q, "sql_calls": ran,
                       "nodes": [list(map(str, r)) for r in nodes],
                       "memory": [[str(p), int(c)] for p, c in mem]},
        launches=launches, held_against_plain=held,
        agrees_with=["numpy int64 exactly (averages to 1e-9 relative)",
                     "eager == compiled", "the numpy HLL sketch exactly"])
    x = torch.stack([catalog.table("lineitem").column(c).data
                     for c in ("l_partkey", "l_suppkey")], dim=1)
    at = (catalog.table("lineitem").column("l_linenumber").data % 2
          ).to(torch.int64)[:, None].contiguous()
    return {"launches": launches, "held": held, "results": results,
            "writes": writes, "element_at_args": (x.contiguous(), at)}


MESH_SHARDS = 8
MESH_DRYRUN_ROWS = 1 << 19  # rows a shard of dryrun_q1 / dryrun_join
# the mesh statements beside TPC-H Q1 and Q3 (tests/test_distributed.py and
# __graft_entry__.py); the Q16 shape orders by every group key, so that ties
# in its count cannot order two engines' rows differently
MESH_LEFT_SQL = ("select c.c_custkey, count(o.o_orderkey) n "
                 "from customer c left join orders o "
                 "on c.c_custkey = o.o_custkey "
                 "group by c.c_custkey order by n desc, c.c_custkey limit 20")
MESH_DISTINCT_SQL = ("select p_brand, p_type, count(distinct ps_suppkey) as "
                     "cnt from partsupp, part where p_partkey = ps_partkey "
                     "and p_brand <> 'Brand#45' group by p_brand, p_type "
                     "order by cnt desc, p_brand, p_type limit 20")
MESH_TOPN_SQL = ("select o_custkey, o_totalprice from orders "
                 "order by o_totalprice desc, o_custkey limit 50")
MESH_SKEW_TABLES = (
    "create table skewp as select "
    "(case when l_linenumber > 1 then 1 else l_orderkey end) pk, "
    "l_extendedprice pv from lineitem",
    "create table skewb as select o_orderkey bk, o_totalprice bv "
    "from orders union all "
    "select o_orderkey + 10000000 bk, o_totalprice bv from orders")
MESH_SKEW_SQL = "select count(*) c, sum(pv) s from skewp, skewb where pk = bk"
MESH_EVEN_SQL = "select count(*) c from lineitem, skewb where l_orderkey = bk"
_MESH_KINDS = ("repartition_joins", "broadcast_joins", "group_aggs",
               "global_aggs", "skew_joins", "topn_sorts")


def _same_result(a, b, what: str) -> None:
    """Two engines' answers: the same columns and rows, every validity bit
    and value equal (strings decoded, float64 to 1e-9 relative)."""
    n = int(a.num_rows)
    if list(a.names) != list(b.names) or n != int(b.num_rows):
        raise AssertionError(f"{what}: {a.names} x {n} rows against "
                             f"{b.names} x {int(b.num_rows)}")
    for name in a.names:
        x, y = a[name], b[name]
        vx = torch.ones(n, dtype=torch.bool) if x.validity is None \
            else x.validity[:n].cpu()
        vy = torch.ones(n, dtype=torch.bool) if y.validity is None \
            else y.validity[:n].cpu()
        if not torch.equal(vx, vy):
            raise AssertionError(f"{what}: NULLs of {name} differ")
        if x.dictionary is not None or y.dictionary is not None:
            if list(x.decode(n)) != list(y.decode(n)):
                raise AssertionError(f"{what}: strings of {name} differ")
            continue
        dx, dy = x.data[:n].cpu(), y.data[:n].cpu()
        if dx.dtype != dy.dtype:
            raise AssertionError(f"{what}: {name} is {dx.dtype} against "
                                 f"{dy.dtype}")
        dx, dy = dx[vx], dy[vy]
        ok = (_rel_err(dx, dy) <= 1e-9) if dx.dtype.is_floating_point \
            else torch.equal(dx, dy)
        if not ok:
            raise AssertionError(f"{what}: values of {name} differ")


def _numpy_dryrun_q1(cols: dict) -> dict:
    """``distributed_q1_step``'s eight groups over the host columns: int64
    sums per group, the charge's 32-bit limbs recombined in float64 as the
    step does."""
    m = cols["shipdate"] <= 10471
    g = cols["returnflag"] * 2 + cols["linestatus"]
    disc_price = cols["price"] * (100 - cols["disc"])
    charge = disc_price * (100 + cols["tax"])
    vals = {"qty": cols["qty"], "price": cols["price"], "dp": disc_price,
            "lo": charge & 0xFFFFFFFF, "hi": charge >> 32,
            "disc": cols["disc"]}
    sums = {k: np.array([int(v[m & (g == j)].sum()) for j in range(8)],
                        np.int64) for k, v in vals.items()}
    counts = np.array([int((m & (g == j)).sum()) for j in range(8)],
                      np.int64)
    cnt = np.maximum(counts, 1)
    return {"sum_qty": sums["qty"], "sum_base_price": sums["price"],
            "sum_disc_price": sums["dp"],
            "sum_charge": sums["hi"].astype(np.float64) * 4294967296.0
            + sums["lo"].astype(np.float64),
            "avg_qty": sums["qty"].astype(np.float64) / (cnt * 100),
            "avg_price": sums["price"].astype(np.float64) / (cnt * 100),
            "avg_disc": sums["disc"].astype(np.float64) / (cnt * 100),
            "count_order": counts,
            "exact_charge": [int(charge[m & (g == j)].sum())
                             for j in range(8)]}


def _mesh_dryruns(mesh, rows_per_shard: int) -> dict:
    """``dryrun_q1`` and ``dryrun_join`` at ``rows_per_shard`` rows a shard,
    held against numpy over the same seeded host columns: every Q1 group's
    integer sums and count exactly, its float64 results to the bit (the
    charge's exact sum to 1 ulp), the join's total and rows exactly."""
    from presto1_tpu_torch.parallel import distributed as DI

    cap = rows_per_shard * mesh.size
    t0 = time.time()
    got = DI.dryrun_q1(mesh, rows_per_shard)
    torch.cuda.synchronize()
    q1_s = time.time() - t0
    want = _numpy_dryrun_q1(DI.dryrun_q1_columns(cap))
    for name, g in got.items():
        g, w = g.cpu().numpy(), want[name]
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"dryrun_q1 {name}: {g} != numpy {w}")
    for j, exact in enumerate(want["exact_charge"]):
        if abs(float(got["sum_charge"][j]) - exact) > \
                np.spacing(float(exact)):
            raise AssertionError(f"dryrun_q1 group {j}: charge "
                                 f"{float(got['sum_charge'][j])} against "
                                 f"the exact {exact}")
    t0 = time.time()
    total, rows = DI.dryrun_join(mesh, rows_per_shard)
    join_s = time.time() - t0
    cols = DI.dryrun_join_columns(cap)
    want_total = int(cols["l_val"].sum() + cols["o_val"][cols["l_key"]].sum())
    if (total, rows) != (want_total, cap):
        raise AssertionError(f"dryrun_join: ({total}, {rows}) != numpy "
                             f"({want_total}, {cap})")
    return {"rows_per_shard": rows_per_shard, "rows": cap,
            "q1_groups_counted": int((want["count_order"] > 0).sum()),
            "q1_seconds": q1_s, "join_seconds": join_s,
            "join_total": total, "join_rows": rows}


def _numpy_partition(key: np.ndarray, n: int) -> np.ndarray:
    """``exchange.partition_of`` in numpy: the int64 product wraps, the
    shift is arithmetic, the modulo floors."""
    mix = np.uint64(0x9E3779B97F4A7C15).astype(np.int64)
    return ((key.astype(np.int64) * mix) >> 33) % n


def _mesh_exchange(mesh, catalog, copy_rate: float) -> dict:
    """The hash exchange over lineitem's l_orderkey with two int64
    payloads, row-sharded as ``sql_distributed`` shards a table: at
    ``exchange_quota``'s quota every row arrives once, at the shard its key
    names, and the payload sums are kept; at half that quota the dropped
    rows are numpy's count of rows over quota, and
    ``distributed_hash_join`` of lineitem with orders raises its overflow
    error.  Device ms of the round trip (CUDA events), its bytes, and those
    bytes over the measured copy rate."""
    from presto1_tpu_torch.batch import RecordBatch
    from presto1_tpu_torch.parallel.dist_join import (
        distributed_hash_join, exchange_quota, prep_shard_rows)
    from presto1_tpu_torch.parallel.distributed import shard_rows
    from presto1_tpu_torch.parallel.exchange import (all_to_all_by_key,
                                                     partition_of)

    n_dev = mesh.size
    li = catalog.table("lineitem")
    n = li.num_rows
    names = ("l_orderkey", "l_partkey", "l_extendedprice")
    cols = [li.column(c).data[:n].to(torch.int64) for c in names]
    host = [c.cpu().numpy() for c in cols]
    rows = prep_shard_rows(n, n_dev)

    def sharded(t):
        pad = torch.zeros(rows * n_dev - n, dtype=t.dtype, device=t.device)
        return shard_rows(mesh, torch.cat([t, pad]))

    keys, pa, pb = (sharded(c) for c in cols)
    live = [min(max(n - s * rows, 0), rows) for s in range(n_dev)]
    arrays = [{"a": pa[s], "b": pb[s]} for s in range(n_dev)]
    quota = exchange_quota(host[0], n, n_dev, rows)

    def run(q):
        return all_to_all_by_key(arrays, keys, live, mesh, q)

    recv, rkey, valid, dropped = run(quota)
    arrived = sum(int(v.sum()) for v in valid)
    if arrived != n or any(int(d) for d in dropped):
        raise AssertionError(f"exchange at quota {quota}: {arrived} of {n} "
                             f"rows arrived, dropped {dropped}")
    for j, name in enumerate(("a", "b")):
        got = sum(int(torch.where(valid[d], recv[d][name], 0).sum())
                  for d in range(n_dev))
        if got != int(host[j + 1].sum()):
            raise AssertionError(f"exchange: {names[j + 1]} sums to {got} "
                                 f"after, {int(host[j + 1].sum())} before")
    for d in range(n_dev):
        if not bool((partition_of(rkey[d][valid[d]], n_dev) == d).all()):
            raise AssertionError(f"exchange: shard {d} received a key of "
                                 f"another shard")
    dest = _numpy_partition(host[0], n_dev)
    half = quota // 2
    want_drop = []
    for s in range(n_dev):
        c = np.bincount(dest[s * rows:s * rows + live[s]], minlength=n_dev)
        want_drop.append(int(np.maximum(c - half, 0).sum()))
    got_drop = [int(d) for d in run(half)[3]]
    if got_drop != want_drop:
        raise AssertionError(f"exchange at quota {half}: dropped {got_drop}"
                             f", numpy {want_drop}")
    orders = catalog.table("orders")
    ok = orders.column("o_orderkey")
    probe = RecordBatch({"l_orderkey": li.column("l_orderkey")}, n)
    build = RecordBatch({"o_orderkey": ok}, orders.num_rows)
    b_rows = prep_shard_rows(orders.num_rows, n_dev)
    bq = exchange_quota(ok.data.cpu().numpy(), orders.num_rows, n_dev,
                        b_rows)
    hi = int(max(host[0].max(), int(ok.data.max())))
    try:
        distributed_hash_join(mesh, probe, build, ["l_orderkey"],
                              ["o_orderkey"], "inner", [(0, hi)],
                              (half, bq), n_dev * quota)
        raise AssertionError("distributed_hash_join ran at half the quota")
    except RuntimeError as e:
        if "exchange overflow" not in str(e):
            raise
        overflow = str(e)
    ms = time_ms(lambda: run(quota), reps=5, trials=3)
    row_bytes = 8 * len(names)
    nbytes = n * row_bytes + n_dev * n_dev * quota * row_bytes
    copy_ms = nbytes / copy_rate * 1e3
    return {"rows": n, "shards": n_dev, "rows_a_shard": rows,
            "quota": quota, "received_slots": n_dev * n_dev * quota,
            "half_quota": half, "dropped_at_half": got_drop,
            "overflow_error": overflow[:160], "ms": ms,
            "bytes_moved": nbytes,
            "bytes_counted": "every input row once (key + 2 payloads), "
                             "the [n * n * quota] received layout once",
            "copy_bound_ms": copy_ms, "share_of_copy_rate": copy_ms / ms}


def phase_mesh_engine(catalog, refs: dict, copy_rate: float,
                      small_sf: float = 0.01,
                      rows_per_shard: int = MESH_DRYRUN_ROWS) -> dict:
    """The mesh plane on one card: ``n = 8`` logical shards (``make_mesh(8)``,
    every shard on this device).  ``dryrun_q1`` / ``dryrun_join`` at
    ``rows_per_shard`` rows a shard against numpy; the exchange round trip
    over lineitem's l_orderkey at its quota and at half of it; then
    ``Engine.sql_distributed(sql, 8)`` on TPC-H Q1, Q3, a Q13-shape LEFT
    join, a Q16-shape DISTINCT, an ORDER BY ... LIMIT 50 and a skew join
    (and an even-keyed join that must not take the skew path) over the SF1
    catalog, each equal to ``Engine.sql`` (Q1 and Q3 to numpy too), with
    wall ms, device ms and kernels a run for both; and all 22 TPC-H queries
    at ``small_sf``.  The launch counters are read around the mesh path
    (dryruns, exchange, the SF1 statements): ``gather``, ``compact``,
    ``dyncopy`` and ``dense_group_agg`` must each have launched, and every
    tapped call of the SF1 statements is held against its plain version."""
    from presto1_tpu_torch.exec.catalog import TpchCatalog
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.parallel.distributed import make_mesh
    from presto1_tpu_torch.testing.verifier import compare_frames
    from presto1_tpu_torch.tpch.queries import QUERIES

    t_phase = time.time()
    mesh = make_mesh(MESH_SHARDS, device=catalog.device)
    read = _counting()
    dry = _mesh_dryruns(mesh, rows_per_shard)
    exchange = _mesh_exchange(mesh, catalog, copy_rate)
    launches = read()  # the exchange's overflow join is on the mesh path
    engine = Engine(catalog, device=catalog.device)
    for sql in MESH_SKEW_TABLES:
        engine.execute_statement(sql)
    statements = {"q1": QUERIES[1], "q3": QUERIES[3],
                  "q13_left_join": MESH_LEFT_SQL,
                  "q16_distinct": MESH_DISTINCT_SQL,
                  "orderby_limit_50": MESH_TOPN_SQL,
                  "skew_join": MESH_SKEW_SQL, "even_join": MESH_EVEN_SQL}

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3

    def profiled(fn) -> dict:
        rows = _cuda_rows(fn, 1)
        if not rows:
            return {"device_ms": None, "kernels": None}
        return {"device_ms": sum(r[1] for r in rows),
                "kernels": sum(r[2] for r in rows)}

    results, taps = {}, _kernel_taps()
    kinds = dict.fromkeys(_MESH_KINDS, 0)
    for key, sql in statements.items():
        single = engine.sql(sql)
        engine.sql_distributed(sql, MESH_SHARDS)  # warm-up
        info: dict = {}
        read = _counting()
        with contextlib.ExitStack() as stack:
            for tap in taps:
                stack.enter_context(tap)
            got = engine.sql_distributed(sql, MESH_SHARDS, info=info)
        torch.cuda.synchronize()
        used = read()
        for k, v in used.items():
            launches[k] += v
        _same_result(got, single, f"mesh {key} against Engine.sql")
        if key in ("q1", "q3"):
            _match(_rows(got), refs[int(key[1:])], f"mesh {key} vs numpy")
        if info["mesh_stages"] < 1:
            raise AssertionError(f"mesh {key} ran no mesh stage: {info}")
        for k in _MESH_KINDS:
            kinds[k] += info[k]
        if key == "skew_join" and info["skew_joins"] != 1:
            raise AssertionError(f"the skew join took no skew path: {info}")
        if key == "even_join" and info["skew_joins"] != 0:
            raise AssertionError(f"the even-keyed join took the skew path: "
                                 f"{info}")
        results[key] = {
            "info": info, "rows": int(got.num_rows),
            "sql_distributed_wall_ms": [wall_ms(
                lambda: engine.sql_distributed(sql, MESH_SHARDS))
                for _ in range(2)],
            "sql_wall_ms": [wall_ms(lambda: engine.sql(sql))
                            for _ in range(2)],
            "sql_distributed_profile": profiled(
                lambda: engine.sql_distributed(sql, MESH_SHARDS)),
            "sql_profile": profiled(lambda: engine.sql(sql)),
            "launches": used}
    held = _hold_taps("the mesh statements", taps,
                      must=("gather_rows", "compact", "concat_rows",
                            "dense_group_agg"))
    for k in _MESH_KINDS:
        if kinds[k] < 1:
            raise AssertionError(f"no SF1 mesh statement took a {k} stage: "
                                 f"{kinds}")
    for k in ("gather", "compact", "dyncopy", "dense_group_agg"):
        if launches[k] < 1:
            raise AssertionError(f"the mesh path never launched {k}")
    for t in ("skewp", "skewb"):
        engine.execute_statement(f"drop table {t}")
    sf1_s = time.time() - t_phase

    small = Engine(TpchCatalog(sf=small_sf, device=catalog.device),
                   device=catalog.device)
    t0 = time.time()
    small_infos = {}
    for q in range(1, 23):
        info = {}
        a = small.sql_distributed(QUERIES[q], MESH_SHARDS, info=info)
        err = compare_frames(a.to_pandas(), small.sql(QUERIES[q]).to_pandas())
        if err is not None or info["mesh_stages"] < 1:
            raise AssertionError(f"SF{small_sf} Q{q} on the mesh: {err}, "
                                 f"{info}")
        small_infos[q] = info
    small_s = time.time() - t0
    say("mesh_engine", shards=MESH_SHARDS, sf=catalog.sf,
        devices=[str(d) for d in mesh.devices], dryruns=dry,
        exchange=exchange, statements=results, stage_kinds=kinds,
        launches=launches, held_against_plain=held,
        tpch22={"sf": small_sf, "seconds": small_s, "info": small_infos},
        seconds=time.time() - t_phase, sf1_seconds=sf1_s,
        agrees_with=["Engine.sql on the card (values exactly, float64 to "
                     "1e-9 relative)", "numpy int64 (Q1, Q3, the dryruns)",
                     f"Engine.sql at SF{small_sf} (compare_frames)"])
    return {"launches": launches, "held": held, "statements": results,
            "exchange": exchange}


# ------------------------------------------------------------------------
# The server plane: a coordinator and worker processes on this card over the
# HTTP task and results protocol (``MultiHostRunner``), a coordinator in
# front of an engine queried through the DB-API over HTTP, and worker
# servers in this process, where the kernel taps reach them.

SERVER_WORKERS = 2
SERVER_SQL_KEYS = (1, 6, 3)
SERVER_FAMILIES = ("filter_sum", "dense_group_agg", "gather",
                   "take_along_axis", "scatter", "compact", "dyncopy")
# the other stage kinds, each against Engine.sql: (key, sql, engine options)
SERVER_EXTRA = (
    ("broadcast_join",
     "select n_name, count(*) c, sum(s_acctbal) b from supplier, nation "
     "where s_nationkey = n_nationkey group by n_name order by n_name",
     {}),
    ("skew_join",
     "select l_linenumber, count(*) c, sum(l_quantity) q "
     "from lineitem, nation where l_linenumber = n_nationkey "
     "group by l_linenumber order by l_linenumber",
     {"broadcast_threshold": 0, "dynamic_filtering": False,
      "skew_threshold": 0.7, "shards_per_node": 2}),
    ("orderby_limit",
     "select l_orderkey, l_extendedprice from lineitem "
     "order by l_extendedprice desc, l_orderkey limit 10", {}),
    ("distinct",
     "select l_returnflag, count(distinct l_suppkey) d from lineitem "
     "group by l_returnflag order by l_returnflag", {}),
)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _worker_metrics(registry) -> dict:
    """Every counter of every active worker's ``/v1/metrics``, summed over
    the workers (over HTTP, as any client reads them)."""
    from urllib import request as urlrequest

    out: dict = {}
    for node in registry.active_nodes():
        with urlrequest.urlopen(f"{node.uri}/v1/metrics",
                                timeout=30) as resp:
            for m in json.loads(resp.read().decode())["metrics"]:
                out[m["name"]] = out.get(m["name"], 0.0) + m["total"]
    return out


def _metric_diff(after: dict, before: dict, prefix: str) -> dict:
    return {k[len(prefix):]: after.get(k, 0.0) - before.get(k, 0.0)
            for k in sorted(set(after) | set(before)) if k.startswith(prefix)}


def _json_rows(batch) -> list:
    """A batch's rows as the coordinator puts them on the wire (JSON)."""
    from presto1_tpu_torch.server.coordinator import (_json_fallback,
                                                      _json_value)

    return json.loads(json.dumps(
        [[_json_value(v) for v in row] for row in batch.to_pylist()],
        default=_json_fallback))


def _stage_shares(info: dict) -> dict:
    """From a statement's stage statistics: the slowest task's wall, its
    exchange wait, and the ms every task spent making and reading pages,
    summed (the serde's share of the tasks' walls)."""
    tasks_wall = sum(ss["wallMs"] * ss["tasks"] for ss in info["stage_stats"])
    serde = sum(sum(ss["taskSerializeMs"]) + sum(ss["taskDecodeMs"])
                for ss in info["stage_stats"])
    return {
        "stages": [{"stage": ss["stage"], "distribution": ss["distribution"],
                    "table": ss["table"], "tasks": ss["tasks"],
                    "wall_ms": ss["wallMs"], "fetch_ms": ss["fetchMs"],
                    "serialize_ms": ss["taskSerializeMs"],
                    "decode_ms": ss["taskDecodeMs"],
                    "bytes_in": ss["taskBytesIn"],
                    "routes": ss["taskRoutes"]}
                   for ss in info["stage_stats"]],
        "task_serde_ms": serde,
        "coordinator_decode_ms": info["coordinator_decode_ms"],
        "serde_share_of_task_walls": serde / tasks_wall if tasks_wall else 0,
        "exchange_bytes_in": info["exchange_bytes_in"],
        "coordinator_bytes": info["coordinator_bytes"]}


def _server_statement(eng, local, sql: str, what: str, reps: int = 2,
                      ref=None) -> dict:
    """One statement through ``MultiHostEngine.sql`` (warm-up, then
    ``reps`` timed calls, the last with stage statistics) against
    ``Engine.sql`` on the card: wall ms of both, equal results."""
    device = local.device
    single = local.sql(sql)
    t0 = time.time()
    first = eng.sql(sql)
    _sync(device)
    first_ms = (time.time() - t0) * 1e3
    _same_result(first, single, f"{what}: first run against Engine.sql")
    walls, info = [], {}
    for k in range(reps):
        t0 = time.time()
        got = eng.sql(sql, info=info if k == reps - 1 else None,
                      operator_stats=False)
        _sync(device)
        walls.append((time.time() - t0) * 1e3)
    _same_result(got, single, f"{what} against Engine.sql")
    if ref is not None:
        _match(_rows(got), ref, f"{what} against numpy")
    sql_walls = []
    for _ in range(reps):
        t0 = time.time()
        local.sql(sql)
        _sync(device)
        sql_walls.append((time.time() - t0) * 1e3)
    return {"rows": int(got.num_rows), "first_wall_ms": first_ms,
            "wall_ms": walls, "engine_sql_wall_ms": sql_walls,
            **_stage_shares(info)}


def _in_process_cluster(schema: str, device, n: int = SERVER_WORKERS):
    """``n`` worker servers in this process announcing to a discovery
    server, and a coordinator engine over them: (engine, workers, stop)."""
    from presto1_tpu_torch.exec.catalog import TpchCatalog
    from presto1_tpu_torch.exec.dist_engine import MultiHostEngine
    from presto1_tpu_torch.server.discovery import NodeRegistry
    from presto1_tpu_torch.server.worker import WorkerServer
    from presto1_tpu_torch.testing.dist_runner import DiscoveryServer

    reg = NodeRegistry(probe_interval_s=0.25).start()
    disc = DiscoveryServer(reg).start()
    workers = []

    def stop():
        for w in workers:
            w.stop()
        reg.stop()
        disc.stop()

    try:
        for _ in range(n):
            workers.append(WorkerServer(
                f"tpch:{schema}", device=device,
                coordinator=f"http://127.0.0.1:{disc.port}",
                announce_interval_s=0.2).start())
        deadline = time.time() + 60
        while len(reg.active_nodes()) < n:
            if time.time() > deadline:
                raise TimeoutError("in-process workers did not announce")
            time.sleep(0.05)
        eng = MultiHostEngine(TpchCatalog(schema, device=device), reg,
                              device=device)
    except BaseException:
        stop()
        raise
    return eng, workers, stop


def phase_server_engine(catalog, refs: dict, cache: str,
                        schema: str = "sf1", log_dir=None) -> dict:
    """The server plane on the card.

    (a) ``MultiHostRunner``: a ``DiscoveryServer`` and two worker processes
    (``python -m presto1_tpu_torch.server.worker --device cuda``, catalog
    ``tpch:<schema>``, fragments compiled on first sight) answer TPC-H Q1,
    Q6 and Q3 through ``MultiHostEngine.sql`` -- equal to ``Engine.sql`` on
    the card and to numpy -- then a broadcast join, a skew-aware
    repartition join, an ORDER BY ... LIMIT (the k-way merge) and a
    DISTINCT aggregate, each equal to ``Engine.sql``, and
    ``explain_analyze`` of Q3.  The workers' ``/v1/metrics`` are read
    around the statements: no task failed, Q1 / Q6 / Q3 ran no fragment
    eagerly, and ``filter_sum``, ``dense_group_agg``, ``gather`` and
    ``compact`` launched in the worker processes.  Every worker process is
    killed in a ``finally`` and must have exited.
    (b) Two ``WorkerServer``s in this process: Q1, Q6 and Q3 over HTTP
    with every kernel wrapper tapped, each tapped call held against its
    plain version; one profiled run of each (device ms against wall).
    (c) A ``CoordinatorServer`` in front of ``Engine`` on the card, queried
    through ``client/dbapi.py`` over HTTP: Q1 and Q6 rows equal to
    ``Engine.sql``'s."""
    from presto1_tpu_torch.exec.engine import Engine

    t_phase = time.time()
    device = catalog.device
    local = Engine(catalog, device=device)
    # the workers (processes and in-process) read the columns this script
    # wrote, and compile every fragment on first sight
    saved = {k: os.environ.get(k) for k in ("P1_TPCH_CACHE",
                                            "P1_WORKER_COMPILE")}
    os.environ["P1_TPCH_CACHE"] = cache
    os.environ["P1_WORKER_COMPILE"] = "always"
    try:
        out = _server_phase(catalog, local, refs, schema, log_dir, t_phase)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    say("server_engine", **out["summary"])
    return out


def _server_phase(catalog, local, refs, schema, log_dir, t_phase) -> dict:
    from presto1_tpu_torch.client import dbapi
    from presto1_tpu_torch.exec.dist_engine import MultiHostEngine
    from presto1_tpu_torch.ops.kernels import filter_sum as F
    from presto1_tpu_torch.exec import executor as X
    from presto1_tpu_torch.server.coordinator import CoordinatorServer
    from presto1_tpu_torch.testing.dist_runner import MultiHostRunner
    from presto1_tpu_torch.tpch.queries import QUERIES

    device = catalog.device
    runner = None
    try:
        # (a) worker processes
        t0 = time.time()
        runner = MultiHostRunner(
            SERVER_WORKERS, f"tpch:{schema}", shards_per_node=1,
            device=str(device), log_dir=log_dir)
        start_s = time.time() - t0
        pids = [p.pid for p in runner.workers]
        m0 = _worker_metrics(runner.registry)
        statements = {}
        for q in SERVER_SQL_KEYS:
            statements[f"q{q}"] = _server_statement(
                runner.engine, local, QUERIES[q], f"server Q{q}",
                ref=refs.get(q))
        m1 = _worker_metrics(runner.registry)
        main = _metric_diff(m1, m0, "worker.")
        main_launches = _metric_diff(m1, m0, "kernel.")
        if main.get("eager_fragments", 0) != 0:
            raise AssertionError(f"Q1 / Q6 / Q3 ran {main['eager_fragments']}"
                                 f" fragments eagerly on the workers")
        for fam in ("filter_sum", "dense_group_agg", "gather", "compact"):
            if main_launches.get(f"{fam}.launches", 0) < 1:
                raise AssertionError(f"the workers never launched {fam} on "
                                     f"Q1 / Q6 / Q3: {main_launches}")
        extras = {}
        for key, sql, opts in SERVER_EXTRA:
            eng = MultiHostEngine(runner.engine.catalog, runner.registry,
                                  device=device, **opts) \
                if opts else runner.engine
            extras[key] = _server_statement(eng, local, sql,
                                            f"server {key}", reps=1)
            info = {}
            eng.sql(sql, info=info, operator_stats=False)
            extras[key]["info"] = {k: info[k] for k in (
                "stages", "broadcast_sources", "skew_joins",
                "merged_stages", "sorted_stages", "exchange_tasks")}
        checks = {"broadcast_join": ("broadcast_sources", 1),
                  "skew_join": ("skew_joins", 1),
                  "orderby_limit": ("merged_stages", 1),
                  "distinct": ("exchange_tasks", 2)}
        for key, (field, least) in checks.items():
            if extras[key]["info"][field] < least:
                raise AssertionError(f"server {key}: {field} "
                                     f"{extras[key]['info'][field]}")
        t0 = time.time()
        explain = runner.engine.explain_analyze(QUERIES[3])
        explain_ms = (time.time() - t0) * 1e3
        if "Stage 0" not in explain or "ms across" not in explain:
            raise AssertionError(f"explain_analyze: {explain[:400]}")
        m2 = _worker_metrics(runner.registry)
        totals = _metric_diff(m2, m0, "worker.")
        if totals.get("tasks_failed", 0) != 0 or m2.get(
                "worker.tasks_failed", 0) != 0:
            raise AssertionError(f"worker tasks failed: {totals}")
        server_launches = {fam: int(m2.get(f"kernel.{fam}.launches", 0))
                           for fam in SERVER_FAMILIES}
    finally:
        if runner is not None:
            runner.close()
    if runner is not None and any(p.poll() is None for p in runner.workers):
        raise AssertionError("a worker process outlived the phase")

    # (b) worker servers in this process, kernel wrappers tapped
    eng, workers, stop = _in_process_cluster(schema, device)
    try:
        for q in SERVER_SQL_KEYS:  # first sightings: discovery + compile
            eng.sql(QUERIES[q])
        # the reference answers first: only the server path runs counted
        want = {q: local.sql(QUERIES[q]) for q in SERVER_SQL_KEYS}
        _sync(device)
        taps = _kernel_taps() + (_Tap("range_filter_limb_sums", [F, X]),)
        read = _counting()
        with contextlib.ExitStack() as stack:
            for tap in taps:
                stack.enter_context(tap)
            got = {q: eng.sql(QUERIES[q]) for q in SERVER_SQL_KEYS}
            _sync(device)
        in_process_launches = read()
        for q in SERVER_SQL_KEYS:
            _same_result(got[q], want[q], f"in-process server Q{q}")
        held = _hold_taps("the server statements", taps,
                          must=("gather_rows", "compact", "dense_group_agg",
                                "range_filter_limb_sums"))
        profiled = {}
        for q in SERVER_SQL_KEYS:
            _sync(device)
            t0 = time.time()
            eng.sql(QUERIES[q])
            _sync(device)
            wall = (time.time() - t0) * 1e3
            rows = _cuda_rows(lambda: eng.sql(QUERIES[q]), 1) \
                if torch.device(device).type == "cuda" else []
            dev = sum(r[1] for r in rows) if rows else None
            profiled[f"q{q}"] = {
                "wall_ms": wall, "device_ms": dev,
                "kernels": sum(r[2] for r in rows) if rows else None,
                "idle_share": None if dev is None else 1 - dev / wall,
                "top": [list(r) for r in rows[:6]]}
        routes = sorted({t.route for w in workers
                         for t in list(w.runtime.tasks.values())})
    finally:
        stop()

    # (c) a coordinator on the card, queried through the DB-API over HTTP
    srv = CoordinatorServer(local).start()
    try:
        conn = dbapi.connect(f"http://127.0.0.1:{srv.port}")
        dbapi_rows = {}
        for q in (1, 6):
            cur = conn.cursor().execute(QUERIES[q])
            got = [list(r) for r in cur.fetchall()]
            want = _json_rows(local.sql(QUERIES[q]))
            if got != want:
                raise AssertionError(f"dbapi Q{q} over HTTP: {got[:2]} "
                                     f"against Engine.sql {want[:2]}")
            dbapi_rows[f"q{q}"] = len(got)
    finally:
        srv.stop()

    summary = {
        "sf": catalog.sf, "workers": SERVER_WORKERS, "worker_pids": pids,
        "workers_exited": True, "start_seconds": start_s,
        "statements": statements, "extras": extras,
        "worker_counters_q1_q6_q3": main,
        "worker_launches_q1_q6_q3": main_launches,
        "worker_counters_phase": totals,
        "server_launches": server_launches,
        "explain_analyze_ms": explain_ms,
        "explain_analyze_lines": explain.count("\n") + 1,
        "in_process": {"launches": in_process_launches, "held": held,
                       "profiled": profiled, "routes": routes},
        "dbapi_rows": dbapi_rows,
        "seconds": time.time() - t_phase,
        "agrees_with": ["Engine.sql on the card (values exactly, float64 "
                        "to 1e-9 relative)", "numpy int64 (Q1, Q3, Q6)",
                        "the plain versions (every tapped call)"]}
    return {"launches": in_process_launches, "held": held,
            "server_launches": server_launches, "summary": summary}


def _strided_take_along_axis(x, idx, axis: int):
    """``take_along_axis`` as the earlier design made it, for the
    same-run comparison: one launch of the strided body (an element a
    thread, a 64-bit division by the width for each, at most 16 blocks an
    SM).  Launches made here count in no launch counter."""
    rows, width = idx.shape
    out = x.new_empty((rows, width))
    wx = x.shape[1]
    _strided_launch([x], [out], idx, rows, width, x.shape[axis],
                    (width, 1, wx, 0, 1) if axis == 0
                    else (width, 1, 1, wx, 0))
    return out


def take_times(x, idx, axis: int, copy_rate: float, sector_lib=None) -> dict:
    """``take_along_axis`` at one shape: the take body, the earlier strided
    body (``_strided_take_along_axis``) and ``torch.gather`` on the index
    clamped beforehand (the same function: the wrapper clamps), in turns.
    Bytes: the index once, each distinct source element it names once, the
    output once.  Beside them the 32-byte sectors of x the index names,
    and the card's random sector rate from a source of x's bytes
    (``sector_rate``, 8 loads in flight): the time those sectors would take
    if they were random."""
    from presto1_tpu_torch.ops.kernels import _build, gather as G

    n = x.shape[axis]
    clamped = idx.clamp(0, n - 1).to(torch.int64)
    # the element of x each index element names
    if axis == 0:
        elem = clamped * x.shape[1] + torch.arange(
            idx.shape[1], device="cuda")[None, :]
    else:
        elem = torch.arange(idx.shape[0], device="cuda")[:, None] \
            * x.shape[1] + clamped
    distinct = int(torch.unique(elem.view(-1)).numel())
    sectors = int(torch.unique(
        (elem.view(-1) * x.element_size()) // 32).numel())
    del elem
    nbytes = idx.numel() * (idx.element_size() + x.element_size()) \
        + distinct * x.element_size()
    turns = in_turns({
        "ms": lambda: G.take_along_axis(x, idx, axis),
        "old_strided_ms": lambda: _strided_take_along_axis(x, idx, axis),
        "library_ms": lambda: torch.gather(x, axis, clamped)})
    rows = kernel_rows_ms(lambda: G.take_along_axis(x, idx, axis))
    plan = G.plan_take(
        idx.numel(), idx.shape[1], x.numel(), x.element_size(),
        idx.element_size(), idx.data_ptr(), 0, _build.sm_count(x.device),
        lambda wide: G._TAKE_OCCUPANCY[(x.device.index,
                                        G._LOG2[x.element_size()],
                                        idx.element_size(), int(wide),
                                        axis)],
        _build.l2_bytes(x.device))
    out = {"x": f"{x.dtype}{list(x.shape)}",
           "idx": f"{idx.dtype}{list(idx.shape)}", "axis": axis,
           "plan": plan._asdict(), "distinct_elements_read": distinct,
           "sectors_of_x_named": sectors, **turns,
           "timed": "ms, old_strided_ms and library_ms in turns (in_turns)",
           "kernel_rows_ms": rows["ms"], "kernels": rows["kernels"],
           "plain_ms": device_ms(lambda: G.take_along_axis_plain(x, idx,
                                                                 axis)),
           **_call_ms(lambda: G.take_along_axis(x, idx, axis)),
           **_bounds(nbytes, idx.numel(), copy_rate),
           "library_call": "torch.gather on indices already in range"}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    if sector_lib is not None:
        rate = sector_rate(sector_lib, x.numel() * x.element_size(), 8)
        out["sector_rate_at_x_bytes"] = rate
        out["random_sector_ms"] = sectors / rate["sectors_per_s"] * 1e3
    return out


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


def _strided_launch(srcs, dsts, idx, rows: int, width: int, n: int,
                    strides) -> None:
    """One launch of the strided body (``p1_gather_strided``), the earlier
    design's gather: up to 32 (source, destination) pairs of one element
    width through ``idx``, ``rows * width`` elements, strides as in
    ``csrc/gather.cu``; a grid of an element a thread, at most 16 blocks an
    SM, entered inside ``torch.cuda.device``."""
    import ctypes

    from presto1_tpu_torch.ops.kernels import _build, gather as G

    lib = G._library()
    dev = idx.device
    blocks = max(1, min(-(-(rows * width) // G.THREADS),
                        _build.sm_count(dev) * 16))
    ptrs = ctypes.c_void_p * len(srcs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p1_gather_strided(
            ptrs(*[t.data_ptr() for t in srcs]),
            ptrs(*[t.data_ptr() for t in dsts]), len(srcs),
            srcs[0].element_size(), idx.data_ptr(), idx.element_size(),
            rows, width, n, (ctypes.c_int64 * 5)(*strides), blocks, stream)
    if err != 0:
        raise RuntimeError(f"strided gather launch failed: error {err}")


def _strided_gather_rows(sources, idx):
    """``gather_rows`` as the earlier design made it, for the same-run
    comparison: the same argument checks, outputs allocated one by one,
    then one launch of the strided body per element width of the 1-D
    columns (32 columns a launch) and one per ``[n, W]`` matrix.  Launches
    made here count in no launch counter."""
    from presto1_tpu_torch.ops.kernels import gather as G

    sources = list(sources)
    G._check_idx(idx, 1)
    for k, s in enumerate(sources):
        if not isinstance(s, torch.Tensor) or s.device != idx.device \
                or s.dim() not in (1, 2) \
                or s.shape[0] != sources[0].shape[0] \
                or s.element_size() not in (1, 2, 4, 8) \
                or not s.is_contiguous():
            raise ValueError(f"sources[{k}]")
    m, n = idx.shape[0], sources[0].shape[0]
    idx = idx.contiguous()
    outs = [torch.empty((m,) + tuple(s.shape[1:]), dtype=s.dtype,
                        device=s.device) for s in sources]
    by_width: dict = {}
    for k, s in enumerate(sources):
        if s.dim() == 1:
            by_width.setdefault(s.element_size(), []).append(k)
    for ks in by_width.values():
        for at in range(0, len(ks), G.MAX_PAIRS):
            part = ks[at:at + G.MAX_PAIRS]
            _strided_launch([sources[k] for k in part],
                            [outs[k] for k in part], idx, m, 1, n,
                            (1, 0, 1, 0, 0))
    for k, s in enumerate(sources):
        if s.dim() == 2 and s.shape[1] > 0:
            w = s.shape[1]
            _strided_launch([s], [outs[k]], idx, m, w, n, (1, 0, w, 0, 1))
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
    ``capacity`` indices and the count written once.  Both bodies -- the
    one-launch look-back and the earlier two-pass body -- by graph replay
    in turns, ``ms`` the look-back (the route ``compact`` takes);
    the planned call's kernel rows (one kernel a call is the design) and
    the two-pass body's rows beside the bytes each of its passes needs
    (the count pass: the mask and the chunk counts; the write pass: the
    mask, the chunk counts, the indices and the count); the device time of
    a one-element fill, the least a launch in a graph costs; and
    ``torch.nonzero`` (the same indices without the padding, sized on the
    host) by its kernel rows, measured right after the turns."""
    from presto1_tpu_torch.ops.kernels import _build, scatter as S

    n = mask.shape[0]
    kept = int(mask.sum())
    nbytes = n + capacity * 8 + 8
    S.compact(mask, capacity)  # the occupancy is asked once
    plan = S.compact_route(n, mask.data_ptr() % 16,
                           _build.sm_count(mask.device),
                           lambda: S._OCCUPANCY[mask.device.index])
    turns = in_turns({f"{r}_ms": (lambda r=r: S._compact(mask, capacity, r))
                      for r in COMPACT_ROUTES})
    library = kernel_rows_ms(lambda: torch.nonzero(mask))
    rows = kernel_rows_ms(lambda: S.compact(mask, capacity))
    two = kernel_rows_ms(lambda: S._compact(mask, capacity, "two_pass"))
    blocks, _ = S.compact_plan(n, mask.data_ptr() % 16,
                               _build.sm_count(mask.device))
    pass_bytes = {"compact_count": n + 8 * blocks,
                  "compact_write": n + 8 * blocks + capacity * 8 + 8}
    passes = {name: {"ms": ms, "bytes": pass_bytes[key],
                     "bound_ms": pass_bytes[key] / H100_BYTES_PER_S * 1e3}
              for name, ms, _ in two["rows"]
              for key in pass_bytes if key in name}
    one = torch.empty((1,), dtype=torch.int64, device="cuda")
    out = {"rows": n, "capacity": capacity, "kept": kept,
           "plan": plan._asdict(),
           "ms": turns[f"{plan.route}_ms"],
           **turns, "timed": "every body in turns (in_turns)",
           "kernel_rows_ms": rows["ms"], "kernels": rows["kernels"],
           "kernel_rows": rows["rows"],
           "two_pass_kernel_rows_ms": two["ms"],
           "two_pass_kernels": two["kernels"], "two_pass_passes": passes,
           "one_element_fill_ms": device_ms(lambda: one.zero_()),
           "plain_ms": device_ms(lambda: S.compact_plain(mask, capacity)),
           **_call_ms(lambda: S.compact(mask, capacity)),
           **_bounds(nbytes, n, copy_rate),
           "library_ms": library["ms"], "library_kernels": library["kernels"],
           "library_call": "torch.nonzero (sizes its result on the host; "
                           "its kernel rows only)"}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["bytes_per_s"] = nbytes / (out["ms"] * 1e-3)
    return out


def compact_calls_by_rows(calls: dict, device_ms_per_run: dict,
                          trials: dict, gen) -> dict:
    """The compaction calls each statement made in its tapped run, by mask
    rows, split at 2^20; and what the two-pass body would save on the
    calls below 2^20 rows if ``compact`` took it there.  At every distinct
    row count below 2^20 both bodies are timed in turns on masks of 3.6 %
    and 50 % (capacity the count plus 288); a call is given the larger of
    the two savings (look-back minus two-pass; negative where the
    look-back is faster).  Each statement's summed saving stands beside
    its device ms a run and the gap between its two timed trials (the
    end-to-end metric's own spread in this run)."""
    from presto1_tpu_torch.ops.kernels import scatter as S

    split = 1 << 20
    small = sorted({r for rows in calls.values() for r in rows
                    if 0 < r < split})
    saving = {}
    for n in small:
        worst = None
        for density in (0.036, 0.5):
            m = torch.rand((n,), generator=gen, device="cuda") < density
            capacity = int(m.sum()) + 288
            t = in_turns({r: (lambda r=r: S._compact(m, capacity, r))
                          for r in COMPACT_ROUTES})
            d = t["lookback"] - t["two_pass"]
            worst = d if worst is None else max(worst, d)
        saving[n] = worst
    out = {"split_rows": split, "by_statement": {}}
    for key, rows in calls.items():
        below = [r for r in rows if 0 < r < split]
        saved = sum(saving[r] for r in below)
        spread = trials.get(key)
        out["by_statement"][key] = {
            "calls": len(rows), "below_split": len(below),
            "at_or_above_split": sum(r >= split for r in rows),
            "rows_below_split": sorted(below),
            "two_pass_saves_ms": saved,
            "device_ms_per_run": device_ms_per_run.get(key),
            "trial_spread_ms": spread}
    out["lookback_minus_two_pass_ms_by_rows"] = saving
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
    # the generated TPC-H columns go to disk once, so that a second catalog
    # (the grouped phase's, which must never have uploaded lineitem whole)
    # reads them back instead of generating them again
    cache = os.environ.get("P1_TPCH_CACHE") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".tpch_cache")
    catalog = TpchCatalog(sf=1.0, device="cuda", cache_dir=cache)
    q6 = phase_q6_engine(catalog)
    q1 = phase_q1_engine(catalog)
    q15 = phase_q15view_engine(catalog)
    q3 = phase_q3_engine(catalog)
    q7 = phase_q7_engine(catalog)
    win = phase_window_engine(catalog)
    pcie = phase_pcie_rate()
    refs = _bounded_references(catalog)
    phase_memory_limit(catalog)
    spilled = phase_spill_engine(catalog, refs, pcie)
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpch.queries import QUERIES

    plain = {q: Engine(catalog, device="cuda").sql(QUERIES[q])
             for q in (1, 3, 6)}
    grouped = phase_grouped_engine(
        TpchCatalog(sf=1.0, device="cuda", cache_dir=cache), refs, plain)
    del plain
    sampled = phase_sampled_discovery(catalog, refs)
    phase_explain_analyze(catalog)
    stm = phase_statements_engine(catalog)
    mesh = phase_mesh_engine(catalog, refs, copy_rate)
    server = phase_server_engine(
        catalog, refs, cache,
        log_dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".smoke_logs", "server_workers"))
    ds = TpcdsCatalog(sf=1.0, device="cuda")
    q27 = phase_q27_engine(ds)
    q93 = phase_q93_engine(ds)
    q98 = phase_q98_engine(ds)
    paths = (q1, q15, q3, q27, q93, q7, q98, win, spilled, grouped, stm,
             mesh, server)
    launches = {k: q6["launches"] * (k == "filter_sum")
                + sum(p["launches"][k] for p in paths)
                for k in q1["launches"]}
    held_paths = (("q15_view", q15), ("q3", q3), ("q27", q27), ("q93", q93),
                  ("q7", q7), ("q98", q98), ("window", win),
                  ("statements", stm), ("mesh", mesh), ("server", server))
    # the main paths' own gather and scatter calls, held against the plain
    # versions in each phase, count in the kernels' measured error
    compact_err = {"max_abs_err": scatter_err["max_abs_err"],
                   "compactions_checked": scatter_err.pop("compactions")}
    # take_along_axis shares the gather check's shapes (both axes)
    take_err = {"max_abs_err": gather_err["max_abs_err"]}
    for held_err, name in ((gather_err, "gather_rows"),
                           (scatter_err, "scatter_distinct"),
                           (compact_err, "compact"),
                           (take_err, "take_along_axis"),
                           (dyncopy_err, "concat_rows"),
                           (dense_err, "dense_group_agg")):
        held_err["max_abs_err"] = max(
            [held_err["max_abs_err"]]
            + [p["held"][name]["max_abs_err"] for _, p in held_paths])
        held_err["held_at_main_path_calls"] = {
            q: p["held"][name]["calls_held"] for q, p in held_paths}
    dense_err["f64_max_rel_err"] = max(
        [dense_err["f64_max_rel_err"]]
        + [p["held"]["dense_group_agg"]["max_rel_err_of_float64_sums"]
           for _, p in held_paths])

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
    # the filter's and the merge join's dense shapes: half and all of
    # 6,002,010 rows kept, into n
    half = torch.rand((n,), generator=gen, device="cuda") < 0.5
    compact_half = compact_times(half, n, copy_rate)
    compact_all = compact_times(torch.ones_like(half), n, copy_rate)
    del half
    # each statement's compaction calls by rows, and what the two-pass body
    # would save on those below 2^20 rows
    keyed = {"q15_view": q15, "q3": q3, "q27": q27, "q93": q93, "q7": q7,
             "q98": q98, "window": win, **stm["results"]}
    by_rows = compact_calls_by_rows(
        {k: p["compact_rows"] for k, p in keyed.items()},
        {k: p["profile"].get("device_ms_per_run") for k, p in keyed.items()},
        {k: abs(p["ms_trials"][0] - p["ms_trials"][1])
         for k, p in keyed.items()}, gen)
    say("compaction_calls_by_rows", **by_rows)
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
    table, ends = win["take_args"]  # the window reads along axis 0
    take_window = take_times(table, ends, 0, copy_rate, sector_lib)
    # element_at's shape: one lane a row of a [6,002,010, 2] int64 matrix
    take_element_at = take_times(*stm.pop("element_at_args"), 1, copy_rate)
    dyncopy_fact = dyncopy_times(*dyncopy_err.pop("fact_args"), copy_rate)

    def entry(name, replaces, launches_n, err_info, at, source=None,
              **more):
        return {"name": name, "route": "cuda",
                "source": "presto1_tpu_torch/ops/kernels/csrc/"
                          f"{source or name}.cu",
                "replaces": replaces, "launches": launches_n,
                # launches in the server phase's worker processes
                "server_launches": server["server_launches"][name],
                **err_info, "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at.get("library_ms"), "card": card, **more}

    # the server phase's own calls of filter_sum, held in this process
    err = max(err, server["held"]["range_filter_limb_sums"]["max_abs_err"])
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
              launches_counted="calls of compact (one kernel each)",
              at_engine_shape=compact_q15,
              at_view_density_mask_into_262144=compact_mask,
              at_half_of_6002010_into_n=compact_half,
              at_all_of_6002010_into_n=compact_all,
              calls_by_rows=by_rows),
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
        launches["dyncopy"],
        {k: dyncopy_err[k] for k in ("max_abs_err",
                                     "held_at_main_path_calls")},
        dyncopy_q27,
        shape="TPC-DS Q27 at SF1: the Union of its three ROLLUP levels, "
              "as the engine hands the parts over",
        at_engine_shape=dyncopy_q27,
        at_union_all_2880404_plus_1441548_rows_8_int64=dyncopy_fact))
    kernels.append(entry(
        "take_along_axis",
        "experiments/pallas_primitives2.py:227, "
        "experiments/pallas_primitives3.py:33",
        launches["take_along_axis"],
        {k: take_err[k] for k in ("max_abs_err", "held_at_main_path_calls")},
        take_window, source="gather",
        shape="the window statement's sliding min at SF1: both ends of "
              "every frame read from the doubling table of lineitem's "
              "extended prices in one call",
        at_engine_shape=take_window,
        at_element_at_shape=take_element_at))
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
        q7_ms_per_run=q7["ms_per_run"], q98_ms_per_run=q98["ms_per_run"],
        window_ms_per_run=win["ms_per_run"],
        window_take_along_axis_ms=take_window["ms"],
        element_at_take_along_axis=take_element_at,
        statements_ms_per_run={k: r["ms_per_run"]
                               for k, r in stm["results"].items()},
        statements_device_ms_per_run={
            k: r["profile"].get("device_ms_per_run")
            for k, r in stm["results"].items()},
        statements_kernels_per_run={
            k: r["profile"].get("kernels_per_run")
            for k, r in stm["results"].items()},
        statements_writes=stm["writes"],
        launches_by_path={k: p["launches"] for k, p in (
            ("q1", q1), ("q15_view", q15), ("q3", q3), ("q27", q27),
            ("q93", q93), ("q7", q7), ("q98", q98), ("window", win),
            ("spill_q1_q3_q18", spilled), ("grouped", grouped),
            ("statements", stm), ("mesh", mesh),
            ("server_in_process", server))},
        mesh_wall_ms={k: {"sql_distributed": r["sql_distributed_wall_ms"],
                          "sql": r["sql_wall_ms"]}
                      for k, r in mesh["statements"].items()},
        mesh_device_ms={k: {"sql_distributed":
                            r["sql_distributed_profile"]["device_ms"],
                            "sql": r["sql_profile"]["device_ms"]}
                        for k, r in mesh["statements"].items()},
        mesh_exchange={k: mesh["exchange"][k]
                       for k in ("ms", "bytes_moved", "copy_bound_ms",
                                 "share_of_copy_rate")},
        server_wall_ms={k: {"multihost": r["wall_ms"],
                            "engine_sql": r["engine_sql_wall_ms"]}
                        for k, r in server["summary"]["statements"].items()},
        server_launches=server["server_launches"],
        pcie_rate=pcie,
        spill_ms={q: st["ms"] for q, st in spilled["statements"].items()},
        grouped_peak_bytes={k: r["peak_bytes_above_start"]
                            for k, r in grouped["runs"].items()},
        discovery_s={k: r["discovery_s"] for k, r in sampled.items()},
        q15view_largest_compaction_ms=compact_q15["ms"],
        compaction_ms={k: {f: c[f] for f in (
            "ms", "lookback_ms", "two_pass_ms", "library_ms", "bound_ms",
            "kernels")}
                       for k, c in (("view", compact_q15),
                                    ("mask_3.6%_262144", compact_mask),
                                    ("half_into_n", compact_half),
                                    ("all_into_n", compact_all))},
        take_along_axis_ms={k: {f: t[f] for f in ("ms", "old_strided_ms",
                                                  "library_ms", "bound_ms")}
                            for k, t in (("window", take_window),
                                         ("element_at", take_element_at))},
        q3_largest_scatter_ms=scatter_q3["ms"],
        device_ms_per_run={k: p["profile"].get("device_ms_per_run")
                           for k, p in (("q1", q1), ("q15_view", q15),
                                        ("q3", q3), ("q27", q27),
                                        ("q93", q93), ("q7", q7),
                                        ("q98", q98), ("window", win))},
        kernels_per_run={k: p["profile"].get("kernels_per_run")
                         for k, p in (("q1", q1), ("q15_view", q15),
                                      ("q3", q3), ("q27", q27),
                                      ("q93", q93), ("q7", q7),
                                      ("q98", q98), ("window", win))})
    print(json.dumps({"kernels": kernels}, default=_plain), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
