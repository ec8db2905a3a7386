"""The control of the comparison that decides ``correct``: the reference
itself, put in the program's place and computed one precision down
(decimals as float64 numbers, doubles as float32).  It has to come out
not correct.  The benchmark's runs never run it.

    python3 perfbench/control.py --workload tpch-sf1.join --seeds 1 2 3

prints, for each seed, the numbers a run compares (wrong answers among the
instances, the largest relative error of a double) beside the
configuration's limits.  Each seed draws the cell's parameter instances
(the mix's own ``instance_seed`` gives the instances a run sends).  It needs no card: the reference runs on the host.
"""

from __future__ import annotations

import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    __package__ = "perfbench"

from perfbench.data.store import Store  # noqa: E402
from perfbench.harness import HERE, ROOT, cell_of, load_json  # noqa: E402
from perfbench.reference.common import judge  # noqa: E402
from perfbench.traffic import Traffic  # noqa: E402


def readings(traffic: Traffic, store: Store) -> dict:
    """The control's answer to every instance, judged against the
    reference's."""
    wrong, worst, n = 0, 0.0, 0
    for name, module in traffic.templates.items():
        tables = {t: {c: store.column(t, c) for c in cols}
                  for t, cols in module.COLUMNS.items()}
        ctx = module.prepare(tables)
        for inst in traffic.by_template[name]:
            want = module.answer(ctx, inst.params)
            got = module.answer(ctx, inst.params, lower=True)
            got = got if module.LIMIT is None else got[:module.LIMIT]
            ok, err = judge(got, want, module.OUTPUT, module.ORDER_KEY,
                            module.LIMIT)
            n += 1
            wrong += not ok
            worst = max(worst, err)
    out = {"wrong_answers": wrong, "answers": n}
    if any("double" in m.OUTPUT for m in traffic.templates.values()):
        out["double_rel_err"] = worst
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(bench, args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, entry["file"]))
    config["name"] = cell["config"]
    mix = load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))
    store = Store(config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(Traffic(mix, config["suite"], seed,
                             instance_seed=seed), store)
        r.update(workload=args.workload, seed=seed, limits=config["limits"],
                 seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
