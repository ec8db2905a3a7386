"""Hand-written CUDA kernels (``csrc/*.cu``) and their wrappers.

``COUNTERS`` names every wrapper's launch counter, by kernel family, once:
``launch_counters()`` resolves them and ``launch_counts()`` reads them (the
numbers a worker serves in its ``/v1/metrics`` snapshot, so that the kernels
a worker process launched can be read from another process).
"""

import importlib

# family -> (wrapper module, counter attribute); ``compact`` counts calls of
# the compaction (a zero-fill of its state and one kernel each),
# ``take_along_axis`` the take body's launches, ``gather`` the row body's
COUNTERS = {"filter_sum": ("filter_sum", "LAUNCHES"),
            "dense_group_agg": ("dense_group_agg", "LAUNCHES"),
            "gather": ("gather", "LAUNCHES"),
            "scatter": ("scatter", "LAUNCHES"),
            "compact": ("scatter", "COMPACT_LAUNCHES"),
            "dyncopy": ("dyncopy", "LAUNCHES"),
            "take_along_axis": ("gather", "TAKE_LAUNCHES")}


def launch_counters() -> dict:
    """{family: (module, attribute)} of every launch counter."""
    return {fam: (importlib.import_module(f"{__name__}.{mod}"), attr)
            for fam, (mod, attr) in COUNTERS.items()}


def launch_counts() -> dict:
    """{family: launches so far in this process}."""
    return {fam: getattr(m, attr)
            for fam, (m, attr) in launch_counters().items()}
