"""Row closures see one row, as the reference's vmap shows it.

The reference runs every row closure (map, filter, key_by, map_values,
the expansions) under jax.vmap, so the closure sees one scalar row, and a
reduce binop one 1-D array: ndim 0, shape (), size 1, jnp's methods
(astype, copy, the reductions, reshape, T) and Python's round() and
divmod() with jnp's result dtypes. The port runs a closure on whole
column tensors and shows it each column through coltypes.RowView, which
hides the column's leading dims. These cases are F24-F26 of the roadmap:
before the view, a closure that read the row's shape got wrong rows with
no error, and one that called a row method or round() / divmod() left
the device.

Each case builds one lineage on both packages (the reference on its
8-device CPU mesh under the card's plans, the port at
Context(device="cpu", n_shards=8)) and compares the outcome whole, in
tests/test_torch_fallthrough.py's form: node kind, to_debug_string
lines, rows with their element types, or the exception's class.
"""

import numpy as np
import pytest
import torch

from test_torch_fallthrough import ACCEL_PLANS, N_SHARDS, check
from test_torch_rdd_host import REF_CONF
import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import coltypes
from vega_tpu_torch import dense_rdd


@pytest.fixture(scope="module")
def ctxs():
    from vega_tpu.env import Env

    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in REF_CONF}
    for k, val in REF_CONF.items():
        setattr(conf, k, val)
    port = vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS)
    try:
        yield ref, port
    finally:
        port.stop()
        for k, val in old.items():
            setattr(conf, k, val)
        ref.stop()


K = np.array([0, 1, 2, 3] * 3, np.int32)
V = np.arange(12, dtype=np.int32) - 4
F = np.arange(12, dtype=np.float32) * np.float32(0.4)
U16 = np.arange(12, dtype=np.uint16) * 5000
U32 = np.arange(12, dtype=np.uint32) * 400_000_000


def _range(c):
    return c.dense_range(12)


def _kv(c):
    return c.dense_from_numpy(K, V)


def _floats(c):
    return c.dense_from_numpy(F)


# F24: a closure that reads the row's shape
F24 = {
    "map_ndim": lambda c: _range(c).map(lambda x: (x, x.ndim)),
    "map_ndim_uint16": lambda c: c.dense_from_numpy(U16).map(
        lambda x: (x, x.ndim)),
    "filter_ndim": lambda c: _range(c).filter(lambda x: x.ndim == 0),
    "map_values_ndim": lambda c: _kv(c).map_values(lambda w: w + w.ndim),
    "binop_ndim": lambda c: _kv(c).reduce_by_key(
        lambda a, b: a + b + a.ndim),
    "key_by_ndim": lambda c: _range(c).key_by(lambda x: x.ndim),
    "map_shape": lambda c: _range(c).map(lambda x: x.shape),
}

# F25: a row's array methods
F25 = {
    "astype_float32": lambda c: _range(c).map(
        lambda x: x.astype(np.float32)),
    "astype_int32": lambda c: _floats(c).map(lambda x: x.astype(np.int32)),
    "map_values_astype": lambda c: _kv(c).map_values(
        lambda w: w.astype(np.float32)),
    "copy": lambda c: _range(c).map(lambda x: x.copy()),
    "size": lambda c: _range(c).map(lambda x: (x, x.size)),
    "reshape_scalar": lambda c: _range(c).map(lambda x: x.reshape(())),
    "T": lambda c: _range(c).map(lambda x: x.T),
    "sum": lambda c: _range(c).map(lambda x: x.sum()),
    "mean": lambda c: _range(c).map(lambda x: x.mean()),
    "max": lambda c: _range(c).map(lambda x: x.max()),
    "min": lambda c: _range(c).map(lambda x: x.min()),
    "any": lambda c: _range(c).map(lambda x: (x > 5).any()),
    "all": lambda c: _range(c).map(lambda x: (x > 5).all()),
    "binop_astype": lambda c: _kv(c).reduce_by_key(
        lambda a, b: (a + b).astype(np.int32)),
}

# F26: round() and divmod()
F26 = {
    "round_digits": lambda c: _floats(c).map(lambda x: round(x, 1)),
    "map_values_round": lambda c: c.dense_from_numpy(K, F).map_values(
        lambda w: round(w, 2)),
    "round_float": lambda c: _floats(c).map(lambda x: round(x)),
    "round_int": lambda c: _range(c).map(lambda x: round(x)),
    "divmod": lambda c: _range(c).map(lambda x: divmod(x, 4)),
    "divmod_reduce_add": lambda c: _range(c).map(
        lambda x: divmod(x, 4)).reduce_by_key(op="add"),
    "divmod_float": lambda c: _floats(c).map(lambda x: divmod(x, 1.5)),
    "filter_divmod": lambda c: _range(c).filter(
        lambda x: divmod(x, 3)[1] == 0),
}

FAULTS = {**F24, **F25, **F26}


def test_the_fault_catalogue_has_29_cases():
    assert (len(F24), len(F25), len(F26)) == (7, 14, 8)


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_row_closure_sees_one_row(ctxs, name):
    """Node kind, debug lines and typed rows equal the reference's
    (before the row view each case differed: wrong rows, a host node, or
    an error)."""
    check(ctxs, FAULTS[name])


# uint16 / uint32 columns: the view carries RowTensor's wrap
UNSIGNED = {
    "uint16_astype_wraps": lambda c: c.dense_from_numpy(U16).map(
        lambda x: (x + 60000).astype(np.uint16)),
    "uint16_mean": lambda c: c.dense_from_numpy(U16).map(lambda x: x.mean()),
    "uint16_square_as_int32": lambda c: c.dense_from_numpy(U16).map(
        lambda x: (x * x).astype(np.int32)),
    "uint16_binop_astype": lambda c: c.dense_from_numpy(K, U16).reduce_by_key(
        lambda a, b: (a + b).astype(np.uint16)),
    "uint32_sum_wraps": lambda c: c.dense_from_numpy(U32).map(
        lambda x: (x * 3).sum()),
    "uint32_round_is_int32": lambda c: c.dense_from_numpy(U32).map(
        lambda x: round(x)),
    "uint32_round_digits": lambda c: c.dense_from_numpy(U32).map(
        lambda x: round(x, 1)),
    "uint32_divmod": lambda c: c.dense_from_numpy(U32).map(
        lambda x: divmod(x, 7)),
    "uint32_astype_uint16": lambda c: c.dense_from_numpy(U32).map(
        lambda x: x.astype(np.uint16)),
    "int32_astype_uint32": lambda c: _kv(c).map_values(
        lambda w: w.astype(np.uint32)),
}


@pytest.mark.parametrize("name", sorted(UNSIGNED))
def test_unsigned_wrap_survives_the_view(ctxs, name):
    check(ctxs, UNSIGNED[name])


# jnp's dtypes and refusals, and the trace's refusals through the view
SEMANTICS = {
    "int8_sum_is_int32": lambda c: c.dense_from_numpy(
        np.arange(12, dtype=np.int8) * 20).map(lambda x: x.sum()),
    "int8_mean": lambda c: c.dense_from_numpy(
        np.arange(12, dtype=np.int8)).map(lambda x: x.mean()),
    "bool_sum": lambda c: _range(c).map(lambda x: (x > 5).sum()),
    "bool_mean": lambda c: _range(c).map(lambda x: (x > 5).mean()),
    "bool_round_refuses": lambda c: _range(c).map(lambda x: round(x > 3)),
    "int_round_negative_digits": lambda c: _range(c).map(
        lambda x: round(x, -1)),
    "float16_round": lambda c: c.dense_from_numpy(
        F.astype(np.float16)).map(lambda x: round(x, 1)),
    "rdivmod": lambda c: _range(c).map(lambda x: divmod(100, x + 1)),
    "divmod_past_int32": lambda c: _range(c).map(
        lambda x: divmod(x, 2**40)),
    "numpy_after_astype": lambda c: _range(c).map(
        lambda x: np.sqrt(x.astype(np.float32))),
    "len_of_a_row": lambda c: _range(c).map(lambda x: len(x)),
    "iterate_a_row": lambda c: _range(c).map(lambda x: list(x)),
    "size_is_no_method": lambda c: _range(c).map(lambda x: x.size()),
    "reshape_to_one": lambda c: _range(c).map(lambda x: x.reshape(1)),
    "flatten": lambda c: _range(c).map(lambda x: x.flatten()),
    "in_place_add": lambda c: _range(c).map(lambda x: (x.__iadd__(1), x)),
    "reduce_astype": lambda c: _range(c).reduce(
        lambda a, b: (a + b).astype(np.int32)),
    "reduce_ndim": lambda c: _range(c).reduce(lambda a, b: a + b + a.ndim),
}


@pytest.mark.parametrize("name", sorted(SEMANTICS))
def test_view_semantics_match_the_reference(ctxs, name):
    check(ctxs, SEMANTICS[name])


# ---------------------------------------------------------------------------
# the view itself
# ---------------------------------------------------------------------------


def test_view_copies_nothing():
    """The view of a stored int32 / float32 column is the column (one
    data pointer); the main path's closure gives plain stored columns."""
    col = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    view = dense_rdd._row_view({"v": col}, (("v", torch.int32),))["v"]
    assert isinstance(view, coltypes.RowView)
    assert view.data_ptr() == col.data_ptr()
    assert (view.ndim, tuple(view.shape), view.size) == (0, (), 1)
    schema, cols_fn = dense_rdd._trace_row_fn(
        lambda x: (x % 5, x * 0.5), (("v", torch.int32),), 2)
    assert schema == (("k", torch.int32), ("v", torch.float32))
    out = cols_fn({"v": col})
    assert all(type(t) is torch.Tensor for t in out.values())
    assert torch.equal(out["k"], col % 5)
    assert torch.equal(out["v"], col * 0.5)


def test_ops_keep_the_view_and_count_dims_from_the_row():
    x = coltypes.row_view(torch.arange(6, dtype=torch.int32).reshape(2, 3))
    s = torch.stack([x, x + 1])
    assert isinstance(s, coltypes.RowView)
    assert tuple(s.shape) == (2,) and s.ndim == 1
    assert tuple(coltypes.plain(s).shape) == (2, 3, 2)
    assert torch.equal(coltypes.plain(s.sum()), coltypes.plain(2 * x + 1))
    assert torch.equal(coltypes.plain(s[1]), coltypes.plain(x + 1))
    assert torch.equal(coltypes.plain(s.max(0).values), coltypes.plain(x + 1))
    assert tuple(s.reshape(2, 1).shape) == (2, 1)
    assert tuple(s.unsqueeze(0).T.shape) == (2, 1)
    assert [tuple(r.shape) for r in s] == [(), ()]
    with pytest.raises(TypeError):
        iter(x)


def test_in_place_operators_leave_the_column_alone():
    col = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    x = coltypes.row_view(col)
    y = x
    y += 10
    assert torch.equal(col, torch.arange(6, dtype=torch.int32).reshape(2, 3))
    assert torch.equal(coltypes.plain(y), col + 10)
    with pytest.raises(TypeError):
        x.add_(1)
    with pytest.raises(TypeError):
        x[0] = 1


def test_binop_operands_are_one_dimensional():
    seen = []

    def binop(a, b):
        seen.append((a.ndim, b.ndim))
        return a + b

    f = dense_rdd._check_binop(binop, [torch.int32], "test")
    out = f(torch.ones((2, 5), dtype=torch.int32),
            torch.ones((2, 5), dtype=torch.int32))
    assert type(out) is torch.Tensor and out.shape == (2, 5)
    out = f(torch.tensor(3, dtype=torch.int32),
            torch.tensor(4, dtype=torch.int32))
    assert int(out) == 7
    assert seen == [(1, 1), (1, 1), (0, 0)]
