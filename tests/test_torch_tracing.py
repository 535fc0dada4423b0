"""The reference's literal rule, as the port applies it while it traces
user code (vega_tpu_torch/tracing.py).

With 64-bit types off, jax's trace refuses any Python int outside int32,
whatever the dtype of the array it meets: jax.eval_shape raises "An
overflow was encountered while parsing an argument". The port traces user
code under tracing.int32_literals(), which raises OverflowError on the
same pairs. Each case traces one operator over one column dtype (the
int32, bool and float32 block dtypes and each logical dtype of
coltypes.py) with one constant, on both sides, and holds the port's
raising to jax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu_torch as vt
from vega_tpu_torch import coltypes, dense_rdd, tracing
from vega_tpu_torch.errors import VegaError

DTYPES = {"int32": torch.int32, "bool": torch.bool,
          "float32": torch.float32, **{
              str(dt).replace("torch.", ""): dt for dt in coltypes.PHYSICAL}}
LITERALS = (2**31 - 1, 2**31, -2**31 - 1, 2**40, 40000, -1)
# name -> (jax form, port form) of one operator over a column and a
# constant
OPS = {
    "add": (lambda a, c: a + c, lambda a, c: a + c),
    "radd": (lambda a, c: c + a, lambda a, c: c + a),
    "mul": (lambda a, c: a * c, lambda a, c: a * c),
    "lt": (lambda a, c: a < c, lambda a, c: a < c),
    "eq": (lambda a, c: a == c, lambda a, c: a == c),
    "where": (lambda a, c: jnp.where(a == a, a, c),
              lambda a, c: torch.where(a == a, a, c)),
    "clamp": (lambda a, c: jnp.clip(a, max=c),
              lambda a, c: a.clamp(max=c)),
    "clamp_min": (lambda a, c: jnp.clip(a, c), lambda a, c: torch.clamp(
        a, min=c)),
}


def _jax_raises(dt: torch.dtype, op, c) -> bool:
    npdt = coltypes.numpy_dtype(dt)
    try:
        jax.eval_shape(lambda a: op(a, c), jax.ShapeDtypeStruct((4,), npdt))
    except OverflowError:
        return True
    return False


def _port_raises(dt: torch.dtype, op, c) -> bool:
    col = dense_rdd._probe(dt, (1, 0))
    try:
        with tracing.int32_literals():
            op(col, c)
    except OverflowError:
        return True
    except (RuntimeError, TypeError):
        # torch has no such kernel for the dtype (a bool clamp): the
        # constant passed the rule
        return False
    return False


@pytest.mark.parametrize("literal", LITERALS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_literal_rule_is_jaxs(dtype, literal):
    """Every operator: the port raises exactly where jax.eval_shape
    raises."""
    dt = DTYPES[dtype]
    for name, (jop, pop) in OPS.items():
        want = _jax_raises(dt, jop, literal)
        assert _port_raises(dt, pop, literal) == want, (dtype, literal, name)
        # the rule is the range of the constant alone
        assert want == (not -2**31 <= literal <= 2**31 - 1), (dtype, name)


def test_the_rule_looks_into_keywords_tuples_and_lists():
    x = torch.zeros(3, dtype=torch.int32)
    with tracing.int32_literals():
        for call in (lambda: torch.clamp(x, max=2**40),
                     lambda: torch.full((3,), 2**40),
                     lambda: x.new_tensor([1, 2**40]),
                     lambda: torch.tensor((2**40,))):
            with pytest.raises(OverflowError, match="outside int32"):
                call()
        # a bool is not an int past int32; a float past it is no int
        assert (x + True).dtype == torch.int32
        assert (x + 2.0**40).dtype == torch.float32
        # numpy scalars pass, as jax converts them without a word
        x + np.int64(2**40)


def test_the_rule_holds_only_while_tracing():
    x = torch.zeros(3, dtype=torch.int32)
    with tracing.int32_literals():
        with pytest.raises(OverflowError):
            x + 2**40
    assert (x.to(torch.int64) + 2**40).tolist() == [2**40] * 3


def test_port_constants_inside_an_op_do_not_trip_it():
    """A uint32 column's row form masks with 0xFFFFFFFF inside its own
    operators: that is not the user's constant."""
    u = dense_rdd._probe(torch.uint32, (1, 0))
    with tracing.int32_literals():
        assert coltypes.logical_dtype(u + 1) == torch.uint32
        assert coltypes.logical_dtype(u * 3 - 7) == torch.uint32


def test_frame_stages_run_outside_the_rule():
    """The rule decides the reference's tier of a frame plan and nothing
    else: the port's host-tier stage computes a wide column with its
    int64 bounds and masks (columns.WideInt) and hashes its two-word key
    (hash32_pair) with the rule off."""
    from vega_tpu_torch.frame import col

    with vt.Context(device="cpu", n_shards=4) as ctx:
        q = ctx.create_frame(w=np.array([2**40, -3, 2**40]),
                             x=np.arange(3)).with_column(
            "p", col("w") * 3 + 2**35).group_by("p").count()
        assert "-- reference tier: host" in q.explain()
        assert sorted(q.collect()) == [(2**35 - 9, 1), (3 * 2**40 + 2**35, 2)]


def test_row_function_traced_under_the_rule():
    """The RDD API builds a row function under the rule: a constant past
    int32 fails the device trace, and the node takes the host tier's row
    form (exact int64, as the reference's host tier computes Python
    ints); the same function at int32 constants runs on the device
    trace."""
    with vt.Context(device="cpu", n_shards=4) as ctx:
        d = ctx.dense_range(8)
        with pytest.raises(dense_rdd._LiteralRefusal, match="outside int32"):
            dense_rdd._MapRDD(d, lambda x: x * 2**33)
        host = d.map(lambda x: x * 2**33)
        assert host.host_rows and host.collect()[:2] == [0, 2**33]
        dev = d.map(lambda x: x * 2**30)
        assert not dev.host_rows and dev.collect()[:2] == [0, 2**30]
