"""Entry points of the port (the JAX package's ``__graft_entry__.py``).

``entry(device)`` -- the single-device step of the flagship fragment
                     (TPC-H Q1: filter -> group -> aggregate) and its
                     seeded arguments on ``device``.
``dryrun_multichip(n_devices, device)`` -- builds an n-shard mesh and runs
                     the distributed query steps (row-sharded scans, the
                     key exchange, partial->final aggregation) on small
                     shapes, then four statements through
                     ``Engine.sql_distributed``, each held against
                     ``Engine.sql``.
``serve(schema, port, device)`` -- a coordinator (the statement protocol,
                     ``server/coordinator.py``) in front of an ``Engine`` on
                     a TPC-H schema on ``device``: the README's coordinator
                     recipe; query it with ``client/cli.py --server`` or
                     ``client/dbapi.py``.

    python -m presto1_tpu_torch.entry [n_devices] [device]
    python -m presto1_tpu_torch.entry serve [schema] [port] [device]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(step, args): ``step(*args)`` is TPC-H Q1's fragment over 1,024
    seeded rows on ``device``."""
    from .parallel.distributed import distributed_q1_step

    step = distributed_q1_step(None, num_groups=8)
    cap = 1024
    rng = np.random.RandomState(0)

    def col(lo, hi):
        return torch.from_numpy(
            rng.randint(lo, hi, cap).astype(np.int64)).to(device)

    args = (col(0, 3), col(0, 2), col(100, 5000), col(90000, 200000),
            col(0, 11), col(0, 9), col(8000, 10600), cap)
    return step, args


# the mini-suite of dryrun_multichip: all four stage kinds (repartition /
# broadcast / group / global) plus the distributed TopN, the breadth of the
# reference's DistributedQueryRunner gate
# (testing/trino-testing/DistributedQueryRunner.java:99-149)
DRYRUN_CASES = {
    # join-heavy: repartition + broadcast joins, grouped agg
    "q3-joins": 3,
    # agg-heavy: row-sharded scan, partial->final group agg
    "q1-agg": 1,
    # distinct aggregate over a repartitioned join
    "q16-distinct": (
        "select p_brand, p_type, count(distinct ps_suppkey) as cnt "
        "from partsupp, part where p_partkey = ps_partkey "
        "and p_brand <> 'Brand#45' "
        "group by p_brand, p_type order by cnt desc, p_brand limit 20"),
    # ORDER BY ... LIMIT: per-shard TopN + a local merge
    "orderby-topn": (
        "select o_custkey, o_totalprice from orders "
        "order by o_totalprice desc, o_custkey limit 50"),
}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the mesh plane on an ``n_devices``-shard mesh on ``device``;
    raises on any disagreement.  Returns each statement's stage ``info``."""
    from .exec.catalog import TpchCatalog
    from .exec.engine import Engine
    from .parallel.distributed import dryrun_join, dryrun_q1, make_mesh
    from .testing.verifier import compare_frames
    from .tpch.queries import QUERIES

    mesh = make_mesh(n_devices, device=device)
    if int(dryrun_q1(mesh)["count_order"].sum()) <= 0:
        raise AssertionError("the Q1 step counted no row")
    if dryrun_join(mesh)[1] <= 0:
        raise AssertionError("the join step joined no row")

    eng = Engine(TpchCatalog(sf=0.001, device=device), device=device)
    infos = {}
    for name, sql in DRYRUN_CASES.items():
        if isinstance(sql, int):
            sql = QUERIES[sql]
        info: dict = {}
        a = eng.sql_distributed(sql, n_devices, info=info).to_pandas()
        b = eng.sql(sql).to_pandas()
        err = compare_frames(a, b)
        if err is not None:
            raise AssertionError(f"{name}: {err}")
        if info["mesh_stages"] < 1:
            raise AssertionError(f"{name} ran no mesh stage: {info}")
        infos[name] = info
    return infos


def serve(schema: str = "tiny", port: int = 8080, device="cuda"):
    """A started ``CoordinatorServer`` over ``Engine(TpchCatalog(schema))``
    on ``device``, listening on ``port`` (0: any free port)."""
    from .exec.catalog import TpchCatalog
    from .exec.engine import Engine
    from .server.coordinator import CoordinatorServer

    engine = Engine(TpchCatalog(schema, device=device), device=device)
    return CoordinatorServer(engine, port=port).start()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        import time

        srv = serve(sys.argv[2] if len(sys.argv) > 2 else "tiny",
                    int(sys.argv[3]) if len(sys.argv) > 3 else 8080,
                    sys.argv[4] if len(sys.argv) > 4 else "cuda")
        print("listening on", srv.port, flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
        sys.exit(0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    for k, v in dryrun_multichip(n, dev).items():
        print(k, v)
