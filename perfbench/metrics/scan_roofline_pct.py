"""Operators and kernels: the bytes the traced queries must scan, over
the device's busy time at the card's published memory rate, in %.

A query must read each column its template references once.  Its bytes
are the benchmark's own count, at a fixed logical width per SQL type
(``WIDTH``), whatever the program stores: a VARCHAR of at most 256
distinct values counts its 1-byte code, a wider one a 4-byte code; NULL
masks count nothing."""

WIDTH = {"bigint": 8, "decimal": 8, "double": 8, "integer": 4, "date": 4}
LOW_CARDINALITY = 256


def column_bytes(store, table: str, column: str) -> int:
    t = store.type(table, column)
    if t.is_string:
        distinct = len(store.column(table, column).dictionary)
        width = 1 if distinct <= LOW_CARDINALITY else 4
    else:
        width = WIDTH[t.kind]
    return width * store.num_rows(table)


def template_bytes(store, module) -> int:
    return sum(column_bytes(store, t, c)
               for t, cols in module.COLUMNS.items() for c in cols)


def read(run):
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if peak is None or run.trace.busy_s <= 0:
        return None
    total = sum(template_bytes(run.store, i.module) for i in run.traced)
    return 100.0 * total / (run.trace.busy_s * peak)
