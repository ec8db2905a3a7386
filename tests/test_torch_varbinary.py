"""VARBINARY and the binary function family in the port: the cases of
``tests/test_varbinary.py`` retargeted to ``presto1_tpu_torch`` on the CPU,
and the casts between varbinary and the text kinds (ROADMAP C25).

Varbinary is dictionary-coded like varchar, its entries the latin-1 image
of the bytes.  A cast from varchar or char re-encodes the entries as UTF-8
(as ``to_utf8`` and Trino do), and a cast to varchar or char decodes them
(as ``from_utf8``); char <-> varchar share their codes.  The JAX package
shares codes between every pair of string kinds, so it answers the text's
latin-1 image: each C25 case below puts its answer beside the port's.
"""

import base64
import hashlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.batch as j_batch
import presto1_tpu.expr.eval as j_eval
import presto1_tpu.expr.ir as j_ir
import presto1_tpu.types as j_types
import presto1_tpu_torch.batch as t_batch
import presto1_tpu_torch.expr.eval as t_eval
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.types as t_types
from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    return Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def reference():
    return JEngine(JTpchCatalog(sf=0.001))


def one(engine, expr):
    out = engine.sql(f"select {expr} x").to_pandas()
    return out.x[0]


def both(engine, reference, expr):
    """``one(engine, expr)``, held equal to the JAX package's answer."""
    got = one(engine, expr)
    want = one(reference, expr)
    assert type(got) is type(want) and got == want, (expr, got, want)
    return got


def frames(engine, reference, sql):
    """The port's result of ``sql`` as a DataFrame, held equal to the JAX
    package's."""
    got = engine.sql(sql).to_pandas()
    want = reference.sql(sql).to_pandas()
    assert list(got.columns) == list(want.columns)
    assert got.values.tolist() == want.values.tolist()
    return got


# ------------------------------------- the reference file's cases, retargeted


def test_binary_literal_and_concat(engine, reference):
    assert both(engine, reference, "X'AB01'") == b"\xab\x01"
    assert both(engine, reference, "X'01' || X'02FF'") == b"\x01\x02\xff"
    assert both(engine, reference, "length(X'AB01CD')") == 3


def test_utf8_hex_base64_round_trips(engine, reference):
    assert both(engine, reference, "to_utf8('hello')") == b"hello"
    assert both(engine, reference, "from_utf8(to_utf8('héllo'))") == "héllo"
    assert both(engine, reference, "to_hex(to_utf8('hello'))") == \
        b"hello".hex().upper()
    assert both(engine, reference, "from_hex('414243')") == b"ABC"
    assert both(engine, reference, "to_base64(to_utf8('hi'))") == \
        base64.b64encode(b"hi").decode()
    assert both(engine, reference, "from_base64('aGk=')") == b"hi"


def test_digests_match_hashlib(engine, reference):
    for fn in ("md5", "sha1", "sha256", "sha512"):
        got = both(engine, reference, f"{fn}(to_utf8('abc'))")
        assert got == getattr(hashlib, fn)(b"abc").digest()
    assert both(engine, reference, "crc32(to_utf8('abc'))") == \
        zlib.crc32(b"abc")


def test_digest_over_column(engine, reference):
    out = frames(engine, reference,
                 "select n_name, md5(to_utf8(n_name)) d from nation")
    for _, r in out.iterrows():
        assert r.d == hashlib.md5(r.n_name.encode()).digest()


def test_varbinary_order_by_is_byte_order(engine, reference):
    # latin-1 image ordering == byte ordering (includes bytes > 0x7f)
    out = frames(engine, reference,
                 "select md5(to_utf8(n_name)) d from nation order by d")
    vals = list(out.d)
    assert vals == sorted(vals)


def test_varbinary_group_by_and_equality(engine, reference):
    out = frames(engine, reference,
                 "select count(*) c, to_utf8(substr(n_name, 1, 1)) k "
                 "from nation group by 2 order by c desc, k limit 1")
    assert out.k[0] == b"I" and out.c[0] == 4  # INDIA/INDONESIA/IRAN/IRAQ
    sql = ("select n_name from nation "
           "where to_utf8(n_name) = X'414C4745524941'")
    rows = engine.sql(sql).to_pylist()
    assert rows == [("ALGERIA",)] == reference.sql(sql).to_pylist()


def test_no_implicit_varchar_varbinary_coercion(engine):
    with pytest.raises(TypeError):
        t_types.common_supertype(t_types.VARCHAR, t_types.VARBINARY)
    with pytest.raises(TypeError):
        j_types.common_supertype(j_types.VARCHAR, j_types.VARBINARY)


def test_varchar_legacy_hex_form(engine, reference):
    # varchar-argument digests keep the hex-string convenience form
    got = frames(engine, reference,
                 "select md5(n_name) h, n_name from nation "
                 "order by n_name limit 1")
    assert got.h[0] == hashlib.md5(b"ALGERIA").hexdigest()


def test_cast_identity_and_decimal_from_string(engine, reference):
    assert both(engine, reference, "cast('abc' as varchar)") == "abc"
    assert float(both(engine, reference,
                      "cast('1.50' as decimal(5,2))")) == 1.5


# ------------------------------------------------------------------ C25


def test_cast_varchar_to_varbinary_is_utf8_c25(engine, reference):
    """``cast('é' as varbinary)`` is the text's UTF-8 bytes, as
    ``to_utf8``; the JAX package answers its latin-1 image."""
    assert one(engine, "cast('é' as varbinary)") == b"\xc3\xa9"
    assert one(engine, "to_utf8('é')") == b"\xc3\xa9"
    assert one(engine, "length(cast('é' as varbinary))") == 2
    assert one(reference, "cast('é' as varbinary)") == b"\xe9"
    assert one(reference, "to_utf8('é')") == b"\xc3\xa9"


def test_cast_of_text_beyond_latin1_to_varbinary_c25(engine, reference):
    """Text that latin-1 cannot hold casts to its UTF-8 bytes; the JAX
    package raises."""
    assert one(engine, "cast('日本' as varbinary)") == "日本".encode()
    with pytest.raises(UnicodeEncodeError):
        one(reference, "cast('日本' as varbinary)")


def test_cast_varbinary_to_varchar_decodes_utf8_c25(engine, reference):
    """``cast(to_utf8('é') as varchar)`` is ``'é'``, as ``from_utf8``; the
    JAX package answers the bytes read as latin-1."""
    assert one(engine, "cast(to_utf8('é') as varchar)") == "é"
    assert one(engine, "from_utf8(to_utf8('é'))") == "é"
    assert one(engine, "cast(cast('日本' as varbinary) as varchar)") == "日本"
    assert one(reference, "cast(to_utf8('é') as varchar)") == "Ã©"


def test_cast_over_a_column_c25(engine, reference):
    """A cast folded over a dictionary column: TPC-H names are ASCII, so
    the two packages agree, and the round trip is the identity."""
    sql = ("select n_name, cast(n_name as varbinary) b, "
           "cast(cast(n_name as varbinary) as varchar) t from nation "
           "order by n_name")
    got = engine.sql(sql).to_pylist()
    assert [r[1] for r in got] == [r[0].encode() for r in got]
    assert [r[2] for r in got] == [r[0] for r in got]
    assert got == reference.sql(sql).to_pylist()


# each package's batch, IR and types, for a cast on the device side
_PORT = (t_batch, t_ir, t_types, t_eval, lambda c: torch.tensor(c))
_REFERENCE = (j_batch, j_ir, j_types, j_eval, lambda c: jnp.asarray(c))


def _cast(package, codes, dictionary, source, target):
    """``cast(s as target)`` of a ``source`` column (its codes and sorted
    dictionary) evaluated on the device side of ``package``, where no fold
    reaches it: (codes, dictionary) of the result."""
    batch, ir, types, ev, array = package
    src, tgt = types.parse_type_str(source), types.parse_type_str(target)
    col = batch.Column(array(np.asarray(codes, np.int32)), src,
                       dictionary=np.asarray(dictionary))
    out = ev.eval_expr(ir.Call("cast", (ir.ColumnRef("s", src),), tgt),
                       batch.RecordBatch({"s": col}, len(codes)))
    return np.asarray(out.data).tolist(), list(out.dictionary)


@pytest.mark.parametrize("source", ["varchar", "char(4)"])
def test_device_cast_to_varbinary_recodes_the_dictionary_c25(source):
    """On the device side (a string value no fold reached) the entries are
    re-encoded and the codes kept: UTF-8 keeps distinct strings distinct
    and in order.  The JAX package keeps the entries."""
    dictionary = ["a", "é", "日本"]
    codes = [2, 0, 1, 1]
    got = _cast(_PORT, codes, dictionary, source, "varbinary")
    assert got == (codes, ["a", "\xc3\xa9",
                           "日本".encode().decode("latin-1")])
    ref = _cast(_REFERENCE, codes, dictionary, source, "varbinary")
    assert ref == (codes, dictionary)


def test_device_cast_to_varchar_merges_equal_strings_c25():
    """varbinary -> varchar decodes as ``from_utf8`` does (an invalid
    sequence becomes U+FFFD), and where two entries decode to one string
    their codes become one, so that equal strings have one code."""
    dictionary = ["A", "\xc3\xa9", "\xfe", "\xff"]  # b'A', 'é', 2 invalid
    codes = [3, 2, 1, 0, 3]
    codes_out, dict_out = _cast(_PORT, codes, dictionary, "varbinary",
                                "varchar")
    assert dict_out == ["A", "é", "\ufffd"]
    assert codes_out == [2, 2, 1, 0, 2]
    ref = _cast(_REFERENCE, codes, dictionary, "varbinary", "varchar")
    assert ref == (codes, dictionary)


@pytest.mark.parametrize("source,target", [("char(2)", "varchar"),
                                           ("varchar", "char(2)")])
def test_char_and_varchar_keep_their_codes_c25(source, target):
    """char <-> varchar share codes and dictionary in both packages."""
    dictionary = ["ab", "cd", "é"]
    codes = [2, 1, 0]
    src = t_types.parse_type_str(source)
    col = t_batch.Column(torch.tensor(codes, dtype=torch.int32), src,
                         dictionary=np.asarray(dictionary))
    batch = t_batch.RecordBatch({"s": col}, 3)
    out = t_eval.eval_expr(
        t_ir.Call("cast", (t_ir.ColumnRef("s", src),),
                  t_types.parse_type_str(target)), batch)
    assert out.data is col.data and out.dictionary is col.dictionary
    for package in (_PORT, _REFERENCE):
        assert _cast(package, codes, dictionary, source, target) == \
            (codes, dictionary)
