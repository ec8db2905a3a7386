"""The port's fused range-filter + product-sum against the JAX package's
Pallas kernel (interpret mode) and numpy, on the CPU.

Everything here is integer arithmetic and is compared exactly.  On the CPU
the port's wrapper takes its plain version because the tensors lie on the
CPU; the CUDA kernel itself is held against the plain version on a card by
``chip_smoke.py`` and by the test marked ``cuda`` below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto1_tpu.batch import Column as JColumn
from presto1_tpu.ops.hashagg import AggSpec as JAggSpec
from presto1_tpu.ops.hashagg import global_aggregate as j_global_aggregate
from presto1_tpu.ops.kernels.filter_sum import (
    range_filter_product_sum as j_range_filter_product_sum,
)
from presto1_tpu.types import DecimalType
from presto1_tpu_torch.ops.kernels import _build
from presto1_tpu_torch.ops.kernels import filter_sum as F

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)

Q6_BOUNDS = [8766, 9131, 5, 7, 2400]
BOUNDS = {
    "q6": Q6_BOUNDS,
    "all_pass": [-2**31, 2**31 - 1, -2**31, 2**31 - 1, 2**31 - 1],
    "all_fail": [0, 0, 0, 0, 0],
}


def make_columns(n, seed=7, dtype=np.int32, price_hi=10_000_000):
    """The inputs of tests/test_ops.py's Pallas kernel test, at length n."""
    rng = np.random.RandomState(seed)
    ship = rng.randint(8000, 10600, n).astype(np.int32)
    disc = rng.randint(0, 11, n).astype(dtype)
    qty = rng.randint(100, 5000, n).astype(dtype)
    price = rng.randint(90000, price_hi, n).astype(dtype)
    return ship, disc, qty, price


def numpy_answer(ship, disc, qty, price, b):
    mask = ((ship >= b[0]) & (ship < b[1]) & (disc >= b[2]) & (disc <= b[3])
            & (qty < b[4]))
    return int((price.astype(np.int64) * disc)[mask].sum()), int(mask.sum())


def torch_cols(cols):
    return tuple(torch.from_numpy(c) for c in cols)


@pytest.mark.parametrize("bname", sorted(BOUNDS))
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 10_000])
def test_matches_pallas_interpret_and_numpy(n, bname):
    cols = make_columns(n)
    b = BOUNDS[bname]
    s, c = F.range_filter_product_sum(*torch_cols(cols),
                                      torch.tensor(b, dtype=torch.int64))
    assert s.dtype == torch.int64 and c.dtype == torch.int64
    assert s.dim() == 0 and c.dim() == 0
    assert (int(s), int(c)) == numpy_answer(*cols, b)
    if n:  # the Pallas wrapper cannot reshape zero rows
        js, jc = j_range_filter_product_sum(
            *(jnp.asarray(x) for x in cols), jnp.asarray(b, jnp.int32),
            interpret=True)
        assert (int(s), int(c)) == (int(js), int(jc))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_column_dtypes(dtype):
    """Columns are read in the dtype they are stored in; bounds may be a
    list, a CPU tensor of either integer dtype, or int64 beyond int32."""
    cols = make_columns(5000, seed=11, dtype=dtype)
    want = numpy_answer(*cols, Q6_BOUNDS)
    for b in (Q6_BOUNDS, torch.tensor(Q6_BOUNDS, dtype=torch.int32),
              torch.tensor(Q6_BOUNDS, dtype=torch.int64)):
        s, c = F.range_filter_product_sum(*torch_cols(cols), b)
        assert (int(s), int(c)) == want
    wide = [-2**40, 2**40, -2**40, 2**40, 2**40]
    s, c = F.range_filter_product_sum(*torch_cols(cols), wide)
    assert (int(s), int(c)) == numpy_answer(*cols, wide)


def test_limb_sums_match_reference_global_aggregate():
    """``range_filter_limb_sums`` hands on the limb sums the generic
    aggregate keeps: hold them, and the recombined total, against the JAX
    package's ``global_aggregate`` on int64 prices up to 10^10 (beyond what
    the Pallas kernel accepts)."""
    rng = np.random.RandomState(3)
    n = 20_000
    ship = rng.randint(8000, 10600, n).astype(np.int32)
    disc = rng.randint(0, 11, n).astype(np.int64)
    qty = rng.randint(100, 5000, n).astype(np.int64)
    price = rng.randint(-10**10, 10**10, n).astype(np.int64)
    b = Q6_BOUNDS
    slo, shi, cnt = F.range_filter_limb_sums(
        *torch_cols((ship, disc, qty, price)), b)
    mask = ((ship >= b[0]) & (ship < b[1]) & (disc >= b[2]) & (disc <= b[3])
            & (qty < b[4]))
    prod = price * disc
    assert int(slo) == int((prod[mask] & 0xFFFFFFFF).sum())
    assert int(shi) == int((prod[mask] >> 32).sum())
    assert int(cnt) == int(mask.sum())
    checks = []
    ref = j_global_aggregate(
        [JAggSpec("sum", JColumn(jnp.asarray(prod), DecimalType(38, 4)),
                  "s")], n, n, mask=jnp.asarray(mask), checks=checks)
    assert int(shi) * 2**32 + int(slo) == int(ref["s"].data[0])
    assert bool(ref["s"].validity[0]) == (int(cnt) > 0)
    assert len(checks) == 1 and bool(checks[0])
    sp, cp = F.range_filter_product_sum_plain(
        *torch_cols((ship, disc, qty, price)), b)
    assert int(sp) == int(ref["s"].data[0]) and int(cp) == int(cnt)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "stride", "length",
                                 "not_tensor", "bounds"])
def test_wrapper_rejects(bad):
    ship, disc, qty, price = torch_cols(make_columns(64))
    b = Q6_BOUNDS
    if bad == "dtype":
        with pytest.raises(TypeError):
            F.range_filter_product_sum(ship, disc.double(), qty, price, b)
    elif bad == "ndim":
        with pytest.raises(ValueError):
            F.range_filter_product_sum(ship.reshape(8, 8), disc, qty, price, b)
    elif bad == "stride":
        with pytest.raises(ValueError):
            F.range_filter_product_sum(ship[::2], disc[::2], qty[::2],
                                       price.repeat(2)[::4], b)
    elif bad == "length":
        with pytest.raises(ValueError):
            F.range_filter_product_sum(ship, disc[:10], qty, price, b)
    elif bad == "not_tensor":
        with pytest.raises(TypeError):
            F.range_filter_product_sum(ship.numpy(), disc, qty, price, b)
    else:
        with pytest.raises(Exception):
            F.range_filter_product_sum(ship, disc, qty, price, [1, 2, 3])


class _FakeCudaColumn:
    """A stand-in tensor that claims to lie on a CUDA device."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """For a tensor on a CUDA device the wrapper goes to the kernel and
    never to the plain version: when the build fails, it raises, and
    the launch counter does not move."""
    cols = [_FakeCudaColumn(t) for t in torch_cols(make_columns(256))]
    called = []
    monkeypatch.setattr(F, "range_filter_limb_sums_plain",
                        lambda *a: called.append("plain"))
    monkeypatch.setattr(F, "_check", lambda *a: None)

    def failing_load(name):
        called.append(f"build:{name}")
        raise _build.KernelBuildError("nvcc failed: injected")

    monkeypatch.setattr(_build, "load", failing_load)
    before = F.LAUNCHES
    with pytest.raises(_build.KernelBuildError, match="injected"):
        F.range_filter_limb_sums(*cols, Q6_BOUNDS)
    assert called == ["build:filter_sum"]
    assert F.LAUNCHES == before


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No nvcc: first use raises and says what it looked for; nothing is
    built or loaded when the module is imported."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("filter_sum")
    assert _build.sources() == ["dense_group_agg", "filter_sum", "gather",
                                "scatter"]


def test_build_reports_compiler_output(monkeypatch, tmp_path):
    """A failed build raises with the compiler's output."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'filter_sum.cu(1): error: injected' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.KernelBuildError,
                       match="error: injected") as ei:
        _build.load("filter_sum")
    assert "exit 2" in str(ei.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, exactly (needs a card;
    run with ``pytest -m cuda`` where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype in (np.int32, np.int64):
        for n in (0, 1, 2049, 100_003):
            cols = tuple(t.cuda() for t in
                         torch_cols(make_columns(n, dtype=dtype)))
            got = F.range_filter_limb_sums(*cols, Q6_BOUNDS)
            want = F.range_filter_limb_sums_plain(*cols, Q6_BOUNDS)
            torch.cuda.synchronize()
            assert [int(x) for x in got] == [int(x) for x in want]
