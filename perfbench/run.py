"""Run one cell of the port's benchmark on the CUDA device it starts on.

    python3 perfbench/run.py --workload tpch-sf1.join --seed 7 \
        --seconds 20 --trace 0

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
with the numbers compared beside their limits last, under ``checks``.
Set-up, trace and check details go to standard error.  Exits non-zero,
printing no result, without a CUDA device, or if JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compiler cache of a run stays inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "perfbench", ".cache", sub)
sys.path.insert(0, ROOT)
# one process with one compute thread: the host sets the pace of every
# cell, and idle pool threads of torch and OpenMP only add to its jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
