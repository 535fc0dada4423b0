"""The sort forms of vega_tpu_torch against vega_tpu's, on the CPU.

radix_sort_perm, packed_sort_perm, sort_by_column (ascending and
descending) and bucket_key_sort of vega_tpu_torch.kernels, shard-batched,
against the vega_tpu.tpu.kernels functions called shard by shard on the
same numpy inputs. On the CPU the radix passes run the plain versions of
digit_hist and partition_pos, the reference its radix_hist / radix_pos
(bincount and one-hot ranks). Permutations and sorted columns must be
bit-identical: int32 and float32 edge values (INT32_MIN / INT32_MAX, -0.0
and +0.0, +-inf, NaN), duplicate keys, ragged counts and an empty shard.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vega_tpu.tpu import kernels as ref_kernels
from vega_tpu.tpu import pallas_kernels as ref_pallas
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

I32 = np.iinfo(np.int32)
N_SHARDS = 4
CAP = 700
COUNTS = np.array([700, 0, 333, 699], dtype=np.int32)  # one empty shard
INT_EDGES = np.array([I32.min, I32.max, -1, 0, 1, I32.min + 1, I32.max - 1],
                     dtype=np.int32)
FLOAT_EDGES = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 1.5, -1.5,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny], dtype=np.float32)
IMPLS = ["radix", "radix4", "packed"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys(dtype, seed):
    """[N_SHARDS, CAP] keys: many duplicates (stability shows), the edge
    values spread over every shard, garbage in the ghost rows."""
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        keys = rng.randint(-40, 40, size=(N_SHARDS, CAP)).astype(np.int32)
        edges = INT_EDGES
    else:
        keys = (rng.randint(-40, 40, size=(N_SHARDS, CAP)) * 0.25).astype(
            np.float32)
        edges = FLOAT_EDGES
    for s in range(N_SHARDS):
        at = rng.choice(CAP, size=3 * len(edges), replace=False)
        keys[s, at] = np.tile(edges, 3)
    return keys


def _assert_same(got, exp):
    """Bit-identical, NaN payloads included."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if got.dtype == np.float32:
        got, exp = got.view(np.int32), exp.view(np.int32)
    np.testing.assert_array_equal(got, exp)


def _ref_words(keys_s):
    return ref_kernels.orderable_words([jnp.asarray(keys_s)])


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_orderable_words_match_reference(dtype):
    keys = _keys(dtype, 1)
    got = kernels.orderable_words([_t(keys)])[0]
    assert got.dtype == torch.int64
    for s in range(N_SHARDS):
        exp = np.asarray(_ref_words(keys[s])[0]).astype(np.int64)
        np.testing.assert_array_equal(got[s].numpy(), exp)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("bits", [8, 4])
def test_radix_sort_perm_matches_reference(bits, dtype, descending):
    keys = _keys(dtype, 2 + bits)
    words = kernels.orderable_words([_t(keys)])
    got = kernels.radix_sort_perm(words, _t(COUNTS), descending, bits=bits)
    assert got.dtype == torch.int64
    for s in range(N_SHARDS):
        exp = ref_kernels.radix_sort_perm(
            _ref_words(keys[s]), jnp.int32(COUNTS[s]), descending, bits=bits)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(exp))


@pytest.mark.parametrize("bits", [8, 4])
def test_radix_sort_perm_narrow_most_significant_word(bits):
    """A key word and an 8-bit bucket word above it (one pass at 8 bits,
    two at 4): the radix form of the (bucket, key) sort."""
    rng = np.random.RandomState(3)
    keys = _keys(np.int32, 5)
    bucket = rng.randint(0, 9, size=(N_SHARDS, CAP)).astype(np.int32)
    words = kernels.orderable_words([_t(keys)]) + [_t(bucket).to(torch.int64)]
    got = kernels.radix_sort_perm(words, _t(COUNTS), bits=bits,
                                  word_bits=[32, 8])
    for s in range(N_SHARDS):
        ref_words = _ref_words(keys[s]) + [
            jnp.asarray(bucket[s]).astype(jnp.uint32)]
        exp = ref_kernels.radix_sort_perm(
            ref_words, jnp.int32(COUNTS[s]), bits=bits, word_bits=[32, 8])
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(exp))


def test_radix_sort_perm_refuses_descending_narrow_words():
    words = [torch.zeros((1, 8), dtype=torch.int64)]
    with pytest.raises(VegaError):
        kernels.radix_sort_perm(words, torch.tensor([8], dtype=torch.int32),
                                descending=True, word_bits=[8])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_packed_sort_perm_matches_reference(dtype, descending):
    keys = _keys(dtype, 6)
    words = kernels.orderable_words([_t(keys)])
    got = kernels.packed_sort_perm(words, _t(COUNTS), descending)
    for s in range(N_SHARDS):
        exp = ref_kernels.packed_sort_perm(
            _ref_words(keys[s]), jnp.int32(COUNTS[s]), descending)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(exp))


def test_packed_sort_perm_constant_high_word():
    """Two words, the high one constant over the valid rows (where the
    reference skips its pass on the device): this port runs the pass, and
    the permutation is the same."""
    lo = _keys(np.int32, 7)
    hi = np.full((N_SHARDS, CAP), 5, dtype=np.int32)
    hi[:, -50:] = 9  # differs only in ghost rows of the ragged shards
    words = kernels.orderable_words([_t(lo), _t(hi)])
    got = kernels.packed_sort_perm(words, _t(COUNTS))
    for s in range(N_SHARDS):
        exp = ref_kernels.packed_sort_perm(
            ref_kernels.orderable_words([jnp.asarray(lo[s]),
                                         jnp.asarray(hi[s])]),
            jnp.int32(COUNTS[s]))
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(exp))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("impl", IMPLS + ["xla"])
def test_sort_by_column_matches_reference(impl, dtype, descending):
    keys = _keys(dtype, 8)
    vals = np.arange(N_SHARDS * CAP, dtype=np.int32).reshape(N_SHARDS, CAP)
    got = kernels.sort_by_column({"k": _t(keys), "v": _t(vals)}, _t(COUNTS),
                                 "k", descending=descending, impl=impl)
    for s in range(N_SHARDS):
        exp = ref_kernels.sort_by_column(
            {"k": jnp.asarray(keys[s]), "v": jnp.asarray(vals[s])},
            jnp.int32(COUNTS[s]), "k", descending=descending, impl=impl)
        # The port keeps every valid row before the ghost rows. The
        # reference's xla form masks ghosts with +inf, which its valid NaN
        # keys sort after (ROADMAP queue 3, F5): its order with the valid
        # rows moved first, stably, is the port's.
        first = np.argsort(np.asarray(exp["v"]) - s * CAP >= COUNTS[s],
                           kind="stable")
        for nm in ("k", "v"):
            _assert_same(got[nm][s].numpy(), np.asarray(exp[nm])[first])


@pytest.mark.parametrize("impl", IMPLS + ["xla"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_bucket_key_sort_matches_reference(impl, dtype):
    n = 8
    rng = np.random.RandomState(9)
    keys = _keys(dtype, 10)
    vals = rng.rand(N_SHARDS, CAP).astype(np.float32)
    mask = np.arange(CAP)[None, :] < COUNTS[:, None]
    bucket = np.where(mask, rng.randint(0, n, size=(N_SHARDS, CAP)),
                      n).astype(np.int32)
    got, got_b = kernels.bucket_key_sort(
        {"k": _t(keys), "v": _t(vals)}, _t(COUNTS), _t(bucket), "k",
        impl=impl, n_shards=n)
    for s in range(N_SHARDS):
        exp, exp_b = ref_kernels.bucket_key_sort(
            {"k": jnp.asarray(keys[s]), "v": jnp.asarray(vals[s])},
            jnp.int32(COUNTS[s]), jnp.asarray(bucket[s]), "k", impl=impl,
            n_shards=n)
        _assert_same(got_b[s].numpy(), exp_b)
        for nm in ("k", "v"):
            _assert_same(got[nm][s].numpy(), exp[nm])


@pytest.mark.parametrize("impl", ["packed", "xla"])
def test_group_by_bucket_past_64_shards_matches_reference(impl):
    """More than 64 shards take the sort by bucket: the packed sort under
    'packed', torch's stable sort otherwise; the same order either way."""
    n = 70
    rng = np.random.RandomState(11)
    bucket = rng.randint(0, n + 1, size=(2, 900)).astype(np.int32)
    vals = rng.rand(2, 900).astype(np.float32)
    got, got_to, got_starts = kernels._group_by_bucket(
        {"v": _t(vals)}, _t(bucket), n, sort_impl=impl)
    for s in range(2):
        exp, exp_to, exp_starts = ref_kernels._group_by_bucket(
            {"v": jnp.asarray(vals[s])}, jnp.asarray(bucket[s]), n,
            sort_impl=impl)
        _assert_same(got["v"][s].numpy(), exp["v"])
        np.testing.assert_array_equal(got_to[s].numpy(), np.asarray(exp_to))
        np.testing.assert_array_equal(got_starts[s].numpy(),
                                      np.asarray(exp_starts))


@pytest.mark.parametrize("impl", IMPLS)
def test_partition_by_bucket_with_plan_args(impl):
    """sort_impl changes nothing below 65 shards; the port's one form
    equals the reference's default form."""
    rng = np.random.RandomState(12)
    n = 8
    bucket = rng.randint(0, n + 1, size=(2, 1500)).astype(np.int32)
    keys = rng.randint(-9, 9, size=(2, 1500)).astype(np.int32)
    got, got_b = kernels.partition_by_bucket(
        {"k": _t(keys)}, _t(bucket), n, sort_impl=impl)
    for s in range(2):
        exp, exp_b = ref_kernels.partition_by_bucket(
            {"k": jnp.asarray(keys[s])}, jnp.asarray(bucket[s]), n,
            sort_impl=impl)
        np.testing.assert_array_equal(got_b[s].numpy(), np.asarray(exp_b))
        np.testing.assert_array_equal(got["k"][s].numpy(),
                                      np.asarray(exp["k"]))


@pytest.mark.parametrize("n_bins", [16, 256])
def test_radix_dispatchers_are_the_kernels(n_bins):
    """A radix pass's digit_hist / partition_pos at 2^bits bins equal the
    reference's radix_hist / radix_pos shard by shard: on a CPU tensor
    the plain versions, and no launch."""
    rng = np.random.RandomState(n_bins)
    d_np = rng.randint(0, n_bins, size=(3, 2000)).astype(np.int32)
    d = _t(d_np)
    before = dict(cuda_kernels.LAUNCHES)
    hist = cuda_kernels.digit_hist(d, n_bins)
    starts = (torch.cumsum(hist, 1, dtype=torch.int32) - hist).contiguous()
    pos = cuda_kernels.partition_pos(d, n_bins, starts)
    assert cuda_kernels.LAUNCHES == before
    for s in range(3):
        exp_hist = ref_pallas.radix_hist(jnp.asarray(d_np[s]), n_bins)
        np.testing.assert_array_equal(hist[s].numpy(), np.asarray(exp_hist))
        exp_pos = ref_pallas.radix_pos(jnp.asarray(d_np[s]),
                                       jnp.asarray(starts[s].numpy()), n_bins)
        np.testing.assert_array_equal(pos[s].numpy(), np.asarray(exp_pos))
        np.testing.assert_array_equal(np.sort(pos[s].numpy()),
                                      np.arange(2000))


@pytest.mark.parametrize("n_bins", [257, 301])
def test_bucket_hist_past_the_kernel_range(n_bins):
    """Above 256 bins bucket_hist counts by a per-shard bincount (the
    reference dispatcher's rule there); digit_hist keeps refusing."""
    rng = np.random.RandomState(n_bins)
    b = rng.randint(0, n_bins, size=(3, 5000)).astype(np.int32)
    got = cuda_kernels.bucket_hist(_t(b), n_bins).numpy()
    exp = np.stack([np.bincount(row, minlength=n_bins) for row in b])
    np.testing.assert_array_equal(got, exp)
    assert got.dtype == np.int32
    with pytest.raises(VegaError, match="n_bins"):
        cuda_kernels.digit_hist(_t(b), n_bins)
