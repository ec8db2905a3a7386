"""The port's k-way merge of sorted task outputs
(``presto1_tpu_torch/exec/merge.py``): the twin of
``tests/test_multihost.py::test_merge_sorted_batches_unit`` -- engineered
sorted runs with a DESC double key that has NULLs, a varchar key whose runs
each carry their own dictionary, and a bigint key -- against pandas and
against the JAX package's ``merge_sorted_batches`` on the same runs.
Strings, integers and NULLs exact, doubles exact (they are only moved).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import presto1_tpu.batch as j_batch
import presto1_tpu.exec.merge as j_merge
import presto1_tpu.expr.ir as j_ir
import presto1_tpu.types as j_types
import presto1_tpu_torch.batch as t_batch
import presto1_tpu_torch.exec.merge as t_merge
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.types as t_types

torch.set_num_threads(1)

WORDS = np.array(["ape", "bee", "cat", "dog", "eel"])


def _runs(seed: int, n_runs: int):
    """``n_runs`` pandas frames, each sorted by (a DESC NULLS LAST, s, b),
    and the numpy columns of each: (a, a_valid, codes, dictionary, b)."""
    rng = np.random.default_rng(seed)
    frames, parts = [], []
    for _ in range(n_runs):
        n = int(rng.integers(1, 200))
        a = np.round(rng.normal(size=n), 1)
        # pandas ties -0.0 with 0.0; the engines' float order does not
        a = np.where(a == 0, 0.0, a)
        av = rng.random(n) > 0.1
        s = rng.integers(0, 5, n)
        b = rng.integers(-10, 10, n).astype(np.int64)
        df = pd.DataFrame({"a": np.where(av, a, np.nan), "s": WORDS[s],
                           "b": b})
        df = df.sort_values(["a", "s", "b"], ascending=[False, True, True],
                            na_position="last", kind="stable")
        frames.append(df)
        d, codes = np.unique(df.s.values, return_inverse=True)
        parts.append((df.a.fillna(0.0).to_numpy(copy=True),
                      ~df.a.isna().to_numpy(), codes.astype(np.int32), d,
                      df.b.to_numpy(copy=True)))
    return frames, parts


def _keys(ir, types):
    # nulls_first=False on the DESC key is pandas' na_position="last" (the
    # engines' default for DESC is NULLS FIRST)
    return [(ir.ColumnRef("a", types.DOUBLE), False, False),
            (ir.ColumnRef("s", types.VARCHAR), True, None),
            (ir.ColumnRef("b", types.BIGINT), True, None)]


def _port_runs(parts):
    C, T = t_batch.Column, t_types
    return [t_batch.RecordBatch(
        {"a": C(torch.from_numpy(a), T.DOUBLE,
                validity=torch.from_numpy(av)),
         "s": C(torch.from_numpy(c), T.VARCHAR, dictionary=d),
         "b": C(torch.from_numpy(b), T.BIGINT)}, len(b))
        for a, av, c, d, b in parts]


def _ref_runs(parts):
    C, T = j_batch.Column, j_types
    return [j_batch.RecordBatch(
        {"a": C(a, T.DOUBLE, validity=av), "s": C(c, T.VARCHAR,
                                                  dictionary=d),
         "b": C(b, T.BIGINT)}, len(b))
        for a, av, c, d, b in parts]


@pytest.mark.parametrize("device", ["cpu", None], ids=["placed", "host"])
@pytest.mark.parametrize("seed,n_runs", [(3, 5), (4, 1), (5, 8)])
def test_merge_sorted_batches_unit(seed, n_runs, device):
    frames, parts = _runs(seed, n_runs)
    out = t_merge.merge_sorted_batches(_port_runs(parts),
                                       _keys(t_ir, t_types), device=device)
    got = out.to_pandas()
    exp = pd.concat(frames).sort_values(
        ["a", "s", "b"], ascending=[False, True, True], na_position="last",
        kind="stable").reset_index(drop=True)
    assert list(got.s) == list(exp.s)
    assert list(got.b) == list(exp.b)
    a = got.a.astype(float)
    assert (a.isna().values == exp.a.isna().values).all()
    np.testing.assert_array_equal(a.fillna(0).values, exp.a.fillna(0).values)
    if device is not None:
        assert out["b"].data.device == torch.device(device)
        assert out.capacity() == t_batch.round_capacity(len(exp))

    ref = j_merge.merge_sorted_batches(_ref_runs(parts),
                                       _keys(j_ir, j_types)).to_pandas()
    pd.testing.assert_frame_equal(got, ref, check_dtype=False)


def test_merge_of_nothing_and_without_keys():
    assert t_merge.merge_sorted_batches([None, None], [], device=None) is None
    _, parts = _runs(6, 3)
    runs = _port_runs(parts)
    out = t_merge.merge_sorted_batches(runs, [], device=None)
    assert list(out.to_pandas().b) == list(
        np.concatenate([p[4] for p in parts]))
