"""Interactive SQL console (the trino-cli analog, ``client/trino-cli``).

Usage:
    python -m presto1_tpu_torch.client.cli --server http://127.0.0.1:8080
    python -m presto1_tpu_torch.client.cli --local tiny      # in-process
    python -m presto1_tpu_torch.client.cli --local tiny --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def format_table(columns, rows, max_rows: int = 100) -> str:
    names = [c["name"] for c in columns]
    shown = rows[:max_rows]
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in shown]
    widths = [
        max([len(n)] + [len(r[i]) for r in cells]) for i, n in enumerate(names)
    ]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(names, widths)), sep]
    for r in cells:
        out.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
    if len(rows) > max_rows:
        out.append(f"... ({len(rows)} rows total)")
    else:
        out.append(f"({len(rows)} rows)")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="presto1")
    ap.add_argument("--server", help="coordinator URL")
    ap.add_argument("--local", metavar="SCHEMA",
                    help="run an in-process engine on a TPC-H schema")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the --local engine (default: "
                         "cuda; cpu runs without a card)")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    args = ap.parse_args(argv)

    if args.local:
        from ..exec.catalog import TpchCatalog
        from ..exec.engine import Engine

        engine = Engine(TpchCatalog(args.local, device=args.device),
                        device=args.device)

        def run(sql):
            out = engine.sql(sql)
            n = out.num_rows if isinstance(out.num_rows, int) else int(out.num_rows)
            cols = [{"name": name, "type": str(c.type)}
                    for name, c in out.columns.items()]
            decoded = {name: c.decode(n) for name, c in out.columns.items()}
            rows = [[decoded[name][i] for name in decoded] for i in range(n)]
            return cols, rows
    else:
        from .http_client import Client

        client = Client(args.server or "http://127.0.0.1:8080")
        run = client.execute

    def one(sql):
        t0 = time.time()
        try:
            cols, rows = run(sql)
            print(format_table(cols, rows))
            print(f"[{time.time() - t0:.2f}s]")
        except Exception as e:  # noqa: BLE001 — console surface
            print(f"error: {e}", file=sys.stderr)

    if args.execute:
        one(args.execute)
        return

    buf = []
    while True:
        try:
            line = input("presto1> " if not buf else "      -> ")
        except EOFError:
            break
        if line.strip().lower() in ("quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            one("\n".join(buf).rstrip().rstrip(";"))
            buf = []


if __name__ == "__main__":
    main()
