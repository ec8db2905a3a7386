"""Helpers for the ``test_torch_*`` files: the same numpy inputs through the
JAX package and through the PyTorch port, and exact comparison of what comes
back.  The port's side goes through ``presto1_tpu_torch.testing.parity``;
taking the JAX package's batches apart happens here, with ``np.asarray``.
"""

import types as _pytypes

import jax.numpy as jnp
import numpy as np

import presto1_tpu.expr.ir as j_ir
import presto1_tpu.types as j_types
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.types as t_types
from presto1_tpu.batch import Column as JColumn, RecordBatch as JRecordBatch
from presto1_tpu_torch.testing.parity import batch_from_numpy_parts

# one namespace per implementation, so a test writes an expression once:
# ``lambda I: I.call("<", I.col("a", I.BIGINT), I.lit(3))``
J = _pytypes.SimpleNamespace(
    lit=j_ir.lit, col=j_ir.col, call=j_ir.call, Literal=j_ir.Literal,
    **{k: getattr(j_types, k) for k in
       ("BIGINT", "INTEGER", "DOUBLE", "BOOLEAN", "DATE", "VARCHAR",
        "REAL", "TIMESTAMP", "DecimalType")})
T = _pytypes.SimpleNamespace(
    lit=t_ir.lit, col=t_ir.col, call=t_ir.call, Literal=t_ir.Literal,
    **{k: getattr(t_types, k) for k in
       ("BIGINT", "INTEGER", "DOUBLE", "BOOLEAN", "DATE", "VARCHAR",
        "REAL", "TIMESTAMP", "DecimalType")})


def both_batches(spec, num_rows=None):
    """``spec``: {name: (data, validity or None, type string[, dictionary])}.
    Returns (JAX-package batch, port batch on the CPU)."""
    jcols, parts = {}, {}
    n = None
    for name, item in spec.items():
        data, validity, tstr = item[:3]
        dictionary = item[3] if len(item) > 3 else None
        data = np.asarray(data)
        n = len(data) if n is None else n
        jcols[name] = JColumn(
            jnp.asarray(data), j_types.parse_type_str(tstr),
            validity=None if validity is None
            else jnp.asarray(np.asarray(validity, bool)),
            dictionary=dictionary)
        parts[name] = {"data": data, "type": tstr, "dictionary": dictionary,
                       "validity": None if validity is None
                       else np.asarray(validity, bool)}
    rows = n if num_rows is None else num_rows
    return (JRecordBatch(jcols, rows),
            batch_from_numpy_parts(parts, rows, device="cpu"))


def jax_parts(batch):
    """A JAX-package batch as numpy parts (the layout of
    ``batch_to_numpy_parts``)."""
    def get(a):
        return None if a is None else np.asarray(a)

    return {name: {"data": get(c.data), "validity": get(c.validity),
                   "type": str(c.type), "dictionary": c.dictionary}
            for name, c in batch.columns.items()}, int(batch.num_rows)


def assert_columns_equal(jcol, tcol, rows=None, what=""):
    """Exact for everything but float data, which is held to 1e-6 relative
    (summation order differs between the two implementations)."""
    jd = np.asarray(jcol.data)
    td = tcol.data.detach().cpu().numpy()
    assert str(jcol.type) == str(tcol.type), what
    assert jd.shape == td.shape, (what, jd.shape, td.shape)
    assert jd.dtype == td.dtype, (what, jd.dtype, td.dtype)
    jv = None if jcol.validity is None else np.asarray(jcol.validity)
    tv = None if tcol.validity is None else tcol.validity.cpu().numpy()
    assert (jv is None) == (tv is None), (what, jv, tv)
    sl = slice(None) if rows is None else slice(0, rows)
    if jv is not None:
        np.testing.assert_array_equal(jv[sl], tv[sl], err_msg=what)
    if jd.dtype.kind == "f":
        np.testing.assert_allclose(td[sl], jd[sl], rtol=1e-6, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(td[sl], jd[sl], err_msg=what)
    if jcol.dictionary is not None or tcol.dictionary is not None:
        np.testing.assert_array_equal(np.asarray(jcol.dictionary),
                                      np.asarray(tcol.dictionary))


def assert_batches_equal(jb, tb, what=""):
    assert list(jb.columns) == list(tb.columns), what
    n = int(jb.num_rows)
    assert n == int(tb.num_rows), (what, n, int(tb.num_rows))
    for name in jb.columns:
        assert_columns_equal(jb[name], tb[name], rows=n,
                             what=f"{what}:{name}")


__all__ = ["J", "T", "both_batches", "jax_parts", "assert_columns_equal",
           "assert_batches_equal", "no_host_sync", "assert_frames_equal",
           "same_answer"]


def no_host_sync(monkeypatch):
    """From here on (until ``monkeypatch`` undoes it), every call that would
    make the host wait for a CUDA device -- a tensor read into Python, a copy
    to the host, an upload, a data-dependent shape -- raises.  A compiled run
    of the port must make none of them between its start and its one
    readback."""
    import torch

    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"host sync inside a compiled run: {name}")
        return call

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    for name in ("tensor", "from_numpy", "nonzero", "unique", "bincount",
                 "masked_select"):
        monkeypatch.setattr(torch, name, refuse(name))


def assert_frames_equal(got, want, ordered: bool = True, what=""):
    """Two ``to_pandas()`` results: the same column names, rows and NULLs;
    doubles to 1e-6 relative, everything else exact.  ``ordered=False``
    compares the rows as multisets (a statement without ORDER BY)."""
    import numpy as np

    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), (what, len(got), len(want))
    if not ordered:
        def canon(df):
            key = [tuple((v is None or v != v, "" if v is None or v != v
                          else str(v)) for v in row)
                   for row in df.itertuples(index=False)]
            return df.iloc[sorted(range(len(df)), key=key.__getitem__)
                           ].reset_index(drop=True)
        got, want = canon(got), canon(want)
    for c in got.columns:
        g, w = got[c], want[c]
        assert list(g.isna()) == list(w.isna()), (what, c)
        g, w = g[~g.isna()], w[~w.isna()]
        if w.dtype.kind == "f" or g.dtype.kind == "f" or any(
                isinstance(v, (float, np.floating)) for v in w):
            np.testing.assert_allclose(g.to_numpy(float), w.to_numpy(float),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {c}")
        else:
            assert list(g) == list(w), (what, c)


def same_answer(engine, reference, sql, ordered: bool = True):
    """The port's ``engine.sql(sql).to_pandas()``, held equal to the JAX
    package's answer to the same statement."""
    got = engine.sql(sql).to_pandas()
    assert_frames_equal(got, reference.sql(sql).to_pandas(), ordered, sql)
    return got
