"""The port's page wire format (``exec/pages.py``) against the JAX
package's on the CPU: ``serialize_batch`` gives the same bytes for the same
batch (flat, nested, row, decimal, date, dictionary and all-NULL columns,
compressed or not), each package reads the other's pages back, and
``concat_batches`` / ``_to_device`` give the same columns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.pages as JP
import presto1_tpu.types as j_types
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.pages as TP
import presto1_tpu_torch.types as t_types
from presto1_tpu.batch import Column as JColumn, RecordBatch as JRecordBatch
from presto1_tpu_torch.batch import Column as TColumn, \
    RecordBatch as TRecordBatch

torch.set_num_threads(1)


def _both(spec, rows):
    """{name: (data, validity | None, type string, dictionary | None,
    lengths | None, map values | None)} -> (JAX-package batch, port
    batch)."""
    jcols, tcols = {}, {}
    for name, (data, valid, tstr, dic, lens, mv) in spec.items():
        def j(a):
            return None if a is None else jnp.asarray(a)

        def t(a):
            return None if a is None else torch.from_numpy(np.array(a))

        jcols[name] = JColumn(j(data), j_types.parse_type_str(tstr),
                              validity=j(valid), dictionary=dic,
                              lengths=j(lens), map_values=j(mv))
        tcols[name] = TColumn(t(data), t_types.parse_type_str(tstr),
                              validity=t(valid), dictionary=dic,
                              lengths=t(lens), map_values=t(mv))
    return JRecordBatch(jcols, rows), TRecordBatch(tcols, rows)


def _spec(kind, n=40, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.7
    if kind == "flat":
        return {"b": (rng.integers(-9, 9, n), None, "bigint", None, None,
                      None),
                "i": (rng.integers(0, 9, n).astype(np.int32), valid,
                      "integer", None, None, None),
                "x": (rng.normal(size=n), valid, "double", None, None, None),
                "f": (rng.random(n) < 0.5, None, "boolean", None, None,
                      None)}
    if kind == "decimal_date":
        return {"p": (rng.integers(-10**15, 10**15, n), valid,
                      "decimal(18,2)", None, None, None),
                "d": (rng.integers(-100, 20000, n).astype(np.int32), None,
                      "date", None, None, None)}
    if kind == "dictionary":
        dic = np.array(["", "apple", "fig", "pear", "été"])
        return {"s": (rng.integers(0, 5, n).astype(np.int32), valid,
                      "varchar", dic, None, None)}
    if kind == "nested":
        w = 4
        return {"a": (rng.integers(-9, 9, (n, w)), valid, "array(bigint)",
                      None, rng.integers(0, w + 1, n).astype(np.int32),
                      None),
                "m": (rng.integers(0, 9, (n, w)), None, "map(bigint,bigint)",
                      None, rng.integers(0, w + 1, n).astype(np.int32),
                      rng.integers(-99, 99, (n, w)))}
    if kind == "all_null":
        return {"z": (np.zeros(n, np.int64), np.zeros(n, bool), "bigint",
                      None, None, None),
                "s": (np.zeros(n, np.int32), np.zeros(n, bool), "varchar",
                      np.array([], dtype="U1"), None, None)}
    raise KeyError(kind)


KINDS = ["flat", "decimal_date", "dictionary", "nested", "all_null"]


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_serialize_batch_is_byte_identical(kind, compress):
    jb, tb = _both(_spec(kind), 33)  # fewer live rows than the capacity
    page = TP.serialize_batch(tb, compress=compress)
    assert page == JP.serialize_batch(jb, compress=compress)
    # each package reads the other's page back
    back = TP.deserialize_batch(JP.serialize_batch(jb, compress=compress))
    assert back.to_pylist() == tb.to_pylist()
    assert JP.deserialize_batch(page).to_pylist() == jb.to_pylist()


def test_row_output_is_byte_identical():
    """A row-valued select item (flattened to its fields) and a decimal
    aggregate, as each engine answers them."""
    je = j_engine.Engine(j_catalog.TpchCatalog(sf=0.001))
    te = t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                         device="cpu")
    for sql in ("select row(l_orderkey, l_quantity) r from lineitem "
                "order by l_orderkey, l_linenumber limit 7",
                "select l_returnflag, sum(l_extendedprice) s, "
                "avg(l_discount) a from lineitem group by l_returnflag "
                "order by 1"):
        assert TP.serialize_batch(te.sql(sql)) == \
            JP.serialize_batch(je.sql(sql))


def test_deserialize_places_on_the_device_asked():
    _, tb = _both(_spec("nested"), 40)
    back = TP.deserialize_batch(TP.serialize_batch(tb), device="meta")
    for c in back.columns.values():
        for part in (c.data, c.validity, c.lengths, c.map_values):
            assert part is None or part.device.type == "meta"
    host = TP.deserialize_batch(TP.serialize_batch(tb))
    assert host["a"].data.device.type == "cpu"


def test_bad_pages_are_refused():
    _, tb = _both(_spec("flat"), 40)
    page = bytearray(TP.serialize_batch(tb))
    with pytest.raises(ValueError, match="magic"):
        TP.deserialize_batch(b"XXXX" + bytes(page[4:]))
    page[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        TP.deserialize_batch(bytes(page))


@pytest.mark.parametrize("kind", KINDS)
def test_concat_batches_matches_reference(kind):
    """Host pages merged (dictionaries re-encoded against their union,
    element matrices padded to the widest), then placed padded on a device
    by ``_to_device``."""
    parts = []
    for seed, rows in ((1, 17), (2, 40), (3, 5)):
        spec = _spec(kind, n=40, seed=seed)
        if kind == "nested" and seed == 2:  # a wider element matrix
            spec["a"] = (np.tile(spec["a"][0], 2), *spec["a"][1:])
            spec["m"] = (np.tile(spec["m"][0], 2), spec["m"][1],
                         spec["m"][2], None, spec["m"][4],
                         np.tile(spec["m"][5], 2))
        if kind == "dictionary" and seed == 3:
            spec["s"] = (spec["s"][0], spec["s"][1], "varchar",
                         np.array(["apple", "kiwi", "zz", "a", "b"]), None,
                         None)
        parts.append(_both(spec, rows))
    got = TP.concat_batches([TP.deserialize_batch(TP.serialize_batch(t))
                             for _, t in parts])
    if kind == "all_null":
        # the JAX package indexes an all-NULL column's empty dictionary
        # (ROADMAP C14); the port merges the pages
        with pytest.raises(IndexError):
            JP.concat_batches([j for j, _ in parts], device=False)
        assert got.num_rows == 62 and not got["s"].validity.any()
        assert got.to_pylist() == [(None, None)] * 62
        return
    want = JP.concat_batches([JP.deserialize_batch(JP.serialize_batch(j))
                              for j, _ in parts], device=False)
    assert got.num_rows == want.num_rows == 62
    assert TP.serialize_batch(got) == JP.serialize_batch(want)
    placed = TP.concat_batches([t for _, t in parts], device="cpu")
    wplaced = JP.concat_batches([j for j, _ in parts], device=True)
    for name, c in placed.columns.items():
        w = wplaced[name]
        assert c.data.shape == np.asarray(w.data).shape
        for part in ("data", "validity", "lengths", "map_values"):
            a, b = getattr(c, part), getattr(w, part)
            assert (a is None) == (b is None), (name, part)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
