"""Expansions and sampling of vega_tpu_torch against vega_tpu, on the CPU.

map_expand and flat_map_ragged: the port's row functions get whole column
tensors, so a row's outputs come with a trailing dim (torch.stack([...],
dim=-1)) where the reference's vmapped closure returns a (factor,) array.
sample: the reference's threefry stream (PRNGKey, fold_in, uniform under
jax_threefry_partitionable) written in torch int64 ops, bit for bit. Each
lineage runs through a vega_tpu Context("local") on the 8-device CPU mesh
and through vega_tpu_torch's Context(device="cpu", n_shards=8), both under
the card's plans (xla sorts, fused_sort, no table plan). Integer results
are bit-identical with equal per-shard counts and row order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


@pytest.fixture()
def ctxs():
    """(reference, port) Contexts under the card's plans."""
    from vega_tpu.env import Env

    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in ACCEL_PLANS}
    for k, val in ACCEL_PLANS.items():
        setattr(conf, k, val)
    port = vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS)
    try:
        yield ref, port
    finally:
        port.stop()
        for k, val in old.items():
            setattr(conf, k, val)
        ref.stop()


def _same(got, exp):
    """The same rows in the same order and the same placement."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert got.collect() == exp.collect()


# ---------------------------------------------------------------------------
# map_expand
# ---------------------------------------------------------------------------

# (port closure, reference closure, factor) per case
EXPAND_CASES = {
    "values": (lambda x: torch.stack([x, x + 1000], dim=-1),
               lambda x: jnp.stack([x, x + 1000]), 2),
    "pairs": (lambda x: (torch.stack([x % 3, x % 3], dim=-1),
                         torch.stack([x, x * 2], dim=-1)),
              lambda x: (jnp.stack([x % 3, x % 3]), jnp.stack([x, x * 2])),
              2),
    "float pairs, factor 3": (
        lambda x: (torch.stack([x % 5] * 3, dim=-1),
                   torch.stack([x * 0.5, x * 1.5, x * 2.5], dim=-1)),
        lambda x: (jnp.stack([x % 5] * 3),
                   jnp.stack([x * 0.5, x * 1.5, x * 2.5])), 3),
    "factor 1": (lambda x: (x * 3)[..., None], lambda x: (x * 3)[None], 1),
}


@pytest.mark.parametrize("n", [100, 3])  # 3 rows leave five shards empty
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_map_expand_matches_reference(ctxs, case, n):
    """Per-shard rows and order equal the reference's, empty shards
    included; a keyed payload feeds reduce_by_key."""
    ref, port = ctxs
    pf, rf, factor = EXPAND_CASES[case]
    got = port.dense_range(n).map_expand(pf, factor)
    exp = ref.dense_range(n).map_expand(rf, factor)
    _same(got, exp)
    assert got.count() == n * factor
    if got.is_pair:
        assert sorted(got.reduce_by_key(op="add").collect()) == \
            sorted(exp.reduce_by_key(op="add").collect())


def test_map_expand_checks_at_build(ctxs):
    """factor <= 0 raises, as in the reference; so does an output without
    the trailing factor dim (checked on the empty probe, nothing runs)."""
    ref, port = ctxs
    d = port.dense_range(10)
    with pytest.raises(v.VegaError):
        ref.dense_range(10).map_expand(lambda x: jnp.stack([x]), 0)
    with pytest.raises(VegaError, match="positive"):
        d.map_expand(lambda x: x[..., None], 0)
    with pytest.raises(VegaError, match="trailing dim"):
        d.map_expand(lambda x: torch.stack([x, x]), 2)  # leading dim
    with pytest.raises(VegaError, match="trailing dim"):
        d.map_expand(lambda x: x, 2)
    with pytest.raises(VegaError, match="host tier"):
        port.dense_from_numpy(np.array([2**40], np.int64)).map_expand(
            lambda x: x[..., None], 1)


# ---------------------------------------------------------------------------
# flat_map_ragged
# ---------------------------------------------------------------------------

RAGGED_CASES = {
    "x % 4 copies": (lambda x: (torch.stack([x] * 3, dim=-1), x % 4),
                     lambda x: (jnp.full((3,), x), x % 4), 3),
    "n_valid clipped both ways": (
        lambda x: (torch.stack([x, -x, x * 7], dim=-1), x % 7 - 2),
        lambda x: (jnp.stack([x, -x, x * 7]), x % 7 - 2), 3),
    "keyed, constant n_valid": (
        lambda x: ((torch.stack([x % 7, x % 7], dim=-1),
                    torch.stack([x, x * 0 + 1], dim=-1)), 2),
        lambda x: ((jnp.stack([x % 7, x % 7]), jnp.stack([x, x * 0 + 1])),
                   jnp.int32(2)), 2),
}


@pytest.mark.parametrize("n", [2_000, 5])
@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_flat_map_ragged_matches_reference(ctxs, case, n):
    """Per-shard rows and order equal the reference's: n_valid clipped to
    [0, max_out], empty shards emit nothing."""
    ref, port = ctxs
    pf, rf, max_out = RAGGED_CASES[case]
    got = port.dense_range(n).flat_map_ragged(pf, max_out)
    exp = ref.dense_range(n).flat_map_ragged(rf, max_out)
    _same(got, exp)
    if got.is_pair:
        _same(got.reduce_by_key(op="add"), exp.reduce_by_key(op="add"))


def test_flat_map_ragged_checks_at_build(ctxs):
    _ref, port = ctxs
    d = port.dense_range(10)
    with pytest.raises(VegaError, match="positive"):
        d.flat_map_ragged(lambda x: (x[..., None], 1), 0)
    with pytest.raises(VegaError, match="payload, n_valid"):
        d.flat_map_ragged(lambda x: x[..., None], 1)
    with pytest.raises(VegaError, match="trailing dim"):
        d.flat_map_ragged(lambda x: (x, 1), 2)
    with pytest.raises(VegaError, match="one scalar per row"):
        d.flat_map_ragged(lambda x: (torch.stack([x, x], -1), x.sum()), 2)


def test_digit_flat_map_then_reduce(ctxs):
    """examples/streamed_billion_rows.py's digit histogram, written for
    the port's convention: each number emits its decimal digits."""
    ref, port = ctxs

    def port_digits(x):
        pows = torch.tensor([10 ** i for i in range(5)], dtype=torch.int32,
                            device=x.device)
        digits = (x[..., None] // pows) % 10
        n = 1 + (x >= 10).to(torch.int32) + (x >= 100).to(torch.int32) \
            + (x >= 1000).to(torch.int32) + (x >= 10000).to(torch.int32)
        return (digits, torch.ones_like(digits)), n

    def ref_digits(x):
        pows = jnp.array([10 ** i for i in range(5)], jnp.int32)
        digits = (x // pows) % 10
        n = 1 + (x >= 10) + (x >= 100) + (x >= 1000) + (x >= 10000)
        return (digits, jnp.ones_like(digits)), n.astype(jnp.int32)

    got = port.dense_range(20_000).flat_map_ragged(port_digits, 5) \
        .reduce_by_key(op="add")
    exp = ref.dense_range(20_000).flat_map_ragged(ref_digits, 5) \
        .reduce_by_key(op="add")
    _same(got, exp)
    digits = np.concatenate([list(map(int, str(x))) for x in range(20_000)])
    assert dict(got.collect()) == dict(enumerate(
        np.bincount(digits).tolist()))


# ---------------------------------------------------------------------------
# the random stream and sample
# ---------------------------------------------------------------------------

SEEDS = [0, 7, 42, -1, 2**31 - 1, -2**31]


def _words(x):
    return [int(w) for w in np.asarray(x).reshape(-1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _words(key) == list(kernels.prng_key(seed))
    for data in (0, 1, 7, 12345, 2**32 - 1):
        assert _words(jax.random.fold_in(key, data)) == list(
            kernels.fold_in(*kernels.prng_key(seed), data))


def test_threefry2x32_matches_jax():
    """The block cipher at random keys and counters, as tensors."""
    from jax._src import prng

    rng = np.random.RandomState(5)
    for _ in range(4):
        k = rng.randint(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
        x = rng.randint(0, 2**32, size=(2, 257), dtype=np.uint64).astype(
            np.uint32)
        exp = prng.threefry2x32_p.bind(
            jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
            jnp.asarray(x[1]))
        got = kernels.threefry2x32(int(k[0]), int(k[1]),
                                   torch.from_numpy(x[0].astype(np.int64)),
                                   torch.from_numpy(x[1].astype(np.int64)))
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(e).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (1000,), (4, 300), (2, 3, 50)])
@pytest.mark.parametrize("seed", [0, 7, -1])
def test_uniform_matches_jax(seed, shape):
    """jax.random.uniform's float32 bits at several keys and shapes (the
    flat position is the counter)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    exp = np.asarray(jax.random.uniform(key, shape))
    k0, k1 = kernels.fold_in(*kernels.prng_key(seed), 3)
    got = kernels.uniform_f32(k0, k1, torch.arange(int(np.prod(shape))))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  exp.reshape(-1).view(np.int32))


@pytest.mark.parametrize("source", ["range", "ragged keyed", "reduced"])
def test_sample_rows_match_reference(ctxs, source):
    """The kept rows, per shard and in order, equal the reference's."""
    ref, port = ctxs
    keys = np.random.RandomState(2).randint(0, 300, size=3_001).astype(
        np.int32)

    def run(ctx):
        if source == "range":
            d = ctx.dense_range(10_000)
        elif source == "ragged keyed":
            d = ctx.dense_from_numpy(keys, np.arange(3_001, dtype=np.int32))
        else:
            d = ctx.dense_from_numpy(keys, np.arange(3_001, dtype=np.int32)) \
                .reduce_by_key(op="add")
        return d.sample(False, 0.2, seed=7)

    got, exp = run(port), run(ref)
    _same(got, exp)
    if source == "range":
        assert 1_700 < got.count() < 2_300


def test_sample_with_replacement_and_seeds(ctxs):
    """With replacement is the reference's host tier's; seed None is 0; a
    seed past int32 raises (the reference's PRNGKey takes int32 without
    x64)."""
    _ref, port = ctxs
    d = port.dense_range(1_000)
    with pytest.raises(VegaError, match="host tier"):
        d.sample(True, 0.5, seed=1)
    assert d.sample(False, 0.3).collect() == \
        d.sample(False, 0.3, seed=0).collect()
    with pytest.raises(VegaError, match="int32"):
        d.sample(False, 0.3, seed=2**40)
