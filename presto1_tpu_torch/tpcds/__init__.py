"""TPC-DS connector analog (reference: plugin/trino-tpcds, 1,645 LoC).

Schema-complete (all 24 tables, spec column lists and types) with a
deterministic vectorized generator.  The reference plugin wraps the
teradata dsdgen library; this environment has no such library and no
egress, so the generator is hash-based with spec row counts at SF1 and
simplified value distributions — correctness tests compare engine
results against a pandas oracle over the identical generated data.
"""
