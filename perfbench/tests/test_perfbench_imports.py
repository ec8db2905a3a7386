"""No module of the benchmark loads JAX or the JAX package, and the
reference and the data load nothing of the program: imports are read from
the sources, comparing whole top-level names (the port's own name begins
with the JAX package's)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "presto1_tpu"}


def sources():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "data"])
def test_reference_and_data_import_nothing_of_the_program(sub):
    for path in sources():
        if os.path.relpath(path, HERE).startswith(sub + os.sep):
            names = set(top_names(path))
            assert "presto1_tpu_torch" not in names, path
            assert not names & FORBIDDEN, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole (CPU, SF 0.01) run in a fresh process leaves none of the
    forbidden modules in ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import run, forbidden_modules\n"
        "out = run('tpch-sf1.scan', 5, 0.5, False, device='cpu',\n"
        "          config_override={'scale_factor': 0.01}, data_cache=None)\n"
        "assert out['correct'], out\n"
        "print(forbidden_modules())\n" % os.path.dirname(HERE))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
