"""Fused range-filter + product-sum: one pass over four integer columns.

The shape of TPC-H Q6 (scan -> filter -> sum(a*b)) and of any
filter-aggregate partial.  Eager tensor code evaluates the predicate, the
product and the limb sums as a dozen passes with full-length temporaries;
the kernel reads each column once and writes 24 bytes a block.

Replaces the Pallas kernel of the JAX package,
``presto1_tpu/ops/kernels/filter_sum.py`` (``_kernel3`` under
``_call_kernel``, entry ``range_filter_product_sum``).  That kernel casts
every column to int32, pads to a multiple of 2048 rows, walks a sequential
grid that revisits three int32 accumulator tiles, and splits the product
into 16-bit limbs because its target is a 32-bit machine.  None of that
carries over: the CUDA kernel (``csrc/filter_sum.cu``) reads the columns in
the dtype they are stored in (int32 or int64 each), masks the ragged edge
itself, multiplies in int64 and accumulates the two 32-bit limb sums and
the count that the engine's generic aggregate accumulates, so either path
hands the same three numbers to the same overflow guard.

Bound on an H100: memory.  Bytes moved = n * (sum of the four element
sizes): 28 bytes a row at the engine's dtypes (int32 date, three int64
decimals), 16 at all-int32; the integer work is a dozen operations a row.
The design keeps loads 16 bytes wide with neighbouring threads on
neighbouring addresses, sums in registers, and reduces once per block.

``range_filter_product_sum_plain`` is the same function in plain tensor
ops.  The wrappers take it only for tensors that lie on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernel by this module's wrappers (and nothing else)
LAUNCHES = 0

_INT_DTYPES = (torch.int32, torch.int64)
_LIMB_MASK = (1 << 32) - 1


def _mask(ship, disc, qty, bounds):
    return ((ship >= bounds[0]) & (ship < bounds[1])
            & (disc >= bounds[2]) & (disc <= bounds[3])
            & (qty < bounds[4]))


def range_filter_limb_sums_plain(ship, disc, qty, price, bounds):
    """Plain-tensor version of ``range_filter_limb_sums``."""
    bounds = torch.as_tensor(bounds).to(device=ship.device,
                                        dtype=torch.int64)
    m = _mask(ship.to(torch.int64), disc.to(torch.int64),
              qty.to(torch.int64), bounds)
    p = torch.where(m, price.to(torch.int64) * disc.to(torch.int64), 0)
    return (torch.sum(p & _LIMB_MASK), torch.sum(p >> 32),
            torch.sum(m).to(torch.int64))


def range_filter_product_sum_plain(ship, disc, qty, price, bounds):
    """Plain-tensor version of ``range_filter_product_sum``."""
    slo, shi, cnt = range_filter_limb_sums_plain(ship, disc, qty, price,
                                                 bounds)
    return shi * (1 << 32) + slo, cnt


def _check(ship, disc, qty, price):
    cols = {"ship": ship, "disc": disc, "qty": qty, "price": price}
    for name, t in cols.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t)}")
        if t.dtype not in _INT_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not int32/int64")
        if t.dim() != 1:
            raise ValueError(f"{name}: expected 1-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
        if t.device != ship.device:
            raise ValueError(f"{name}: on {t.device}, ship on {ship.device}")
        if t.shape[0] != ship.shape[0]:
            raise ValueError(f"{name}: length {t.shape[0]} != "
                             f"{ship.shape[0]}")


def _library():
    lib = _build.load("filter_sum")
    fn = lib.p1_filter_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, i, p, i, p, p, ctypes.c_int64, i, p]
        fn.restype = ctypes.c_int
        lib.p1_filter_sum_rows_per_block.argtypes = []
        lib.p1_filter_sum_rows_per_block.restype = ctypes.c_int
    return lib


def _launch(ship, disc, qty, price, bounds):
    """Launch the CUDA kernel; returns the [3] int64 (slo, shi, cnt)."""
    global LAUNCHES
    dev = ship.device
    n = ship.shape[0]
    if n == 0:  # nothing to read: no launch
        return torch.zeros((3,), dtype=torch.int64, device=dev)
    lib = _library()
    bounds = torch.as_tensor(bounds).to(device=dev, dtype=torch.int64)
    if bounds.shape != (5,):
        raise ValueError(f"bounds: expected 5 values, got shape "
                         f"{tuple(bounds.shape)}")
    bounds = bounds.contiguous()
    rows_per_block = lib.p1_filter_sum_rows_per_block()
    sms = _build.sm_count(dev)
    blocks = max(1, min(-(-n // rows_per_block), sms * 8))
    partials = torch.empty((blocks, 3), dtype=torch.int64, device=dev)
    err = _build.launch_on(dev, lambda stream: lib.p1_filter_sum(
        ship.data_ptr(), ship.element_size(),
        disc.data_ptr(), disc.element_size(),
        qty.data_ptr(), qty.element_size(),
        price.data_ptr(), price.element_size(),
        bounds.data_ptr(), partials.data_ptr(), n, blocks, stream))
    if err != 0:
        raise RuntimeError(f"filter_sum kernel launch failed: CUDA error "
                           f"{err} (n={n}, blocks={blocks})")
    LAUNCHES += 1
    return torch.sum(partials, dim=0)


def range_filter_limb_sums(ship, disc, qty, price, bounds):
    """(slo, shi, cnt) over rows passing the range predicate, 0-d int64
    tensors on the inputs' device: with ``p = price * disc`` in int64,
    ``slo = sum(p & 0xFFFFFFFF)``, ``shi = sum(p >> 32)``, ``cnt`` the
    number of passing rows; ``shi * 2**32 + slo`` is the exact sum.

    bounds = [ship_lo, ship_hi_excl, disc_lo, disc_hi, qty_hi_excl] (int64;
    a tensor on any device or a sequence).  Columns are 1-D contiguous
    int32/int64 tensors of one length on one device."""
    _check(ship, disc, qty, price)
    if ship.device.type == "cpu":
        return range_filter_limb_sums_plain(ship, disc, qty, price, bounds)
    if ship.device.type != "cuda":
        raise ValueError(f"unsupported device {ship.device}")
    out = _launch(ship, disc, qty, price, bounds)
    return out[0], out[1], out[2]


def range_filter_product_sum(ship, disc, qty, price, bounds):
    """sum(price*disc), count over rows passing the range predicate.

    bounds = [ship_lo, ship_hi_excl, disc_lo, disc_hi, qty_hi_excl].
    Returns (sum int64, count int64) as 0-d tensors on the inputs' device.
    """
    slo, shi, cnt = range_filter_limb_sums(ship, disc, qty, price, bounds)
    return shi * (1 << 32) + slo, cnt
