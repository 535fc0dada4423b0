"""vega_tpu_torch kernels against the JAX package on identical inputs.

The plain versions of the three CUDA kernels (what the wrappers run on a
CPU tensor) are held bit-identical to the Pallas kernels in interpret mode,
as tests/test_tpu_kernels.py runs them, and the shard-batched module
functions of vega_tpu_torch.kernels to their vega_tpu.tpu.kernels
counterparts called shard by shard. Integers compare exactly; float sums
within rtol=1e-6 (float32 sums may be taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vega_tpu.tpu import kernels as ref_kernels
from vega_tpu.tpu.pallas_kernels import (digit_hist_pallas,
                                         hash_bucket_pallas,
                                         partition_pos_pallas)
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

I32 = np.iinfo(np.int32)
EDGE_KEYS = np.array([0, -1, I32.min, I32.max, 1, -2, I32.min + 1,
                      I32.max - 1, 0x7FEB352D, -0x7B935975], dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batched_keys(rng, n_shards, cap):
    keys = rng.randint(I32.min, I32.max, size=(n_shards, cap),
                       dtype=np.int64).astype(np.int32)
    flat = keys.reshape(-1)
    flat[:len(EDGE_KEYS)] = EDGE_KEYS[:flat.size]
    return keys


# ---------------------------------------------------------------- hash_bucket
@pytest.mark.parametrize("n_buckets", [1, 8, 9, 65])
def test_hash32_matches_reference(n_buckets):
    keys = np.concatenate([EDGE_KEYS, np.random.RandomState(0).randint(
        I32.min, I32.max, size=4000, dtype=np.int64).astype(np.int32)])
    exp_hash = np.asarray(ref_kernels.hash32(jnp.asarray(keys)))
    got_hash = cuda_kernels.hash32(_t(keys)).numpy()
    np.testing.assert_array_equal(got_hash, exp_hash.astype(np.int64))
    exp = np.asarray((ref_kernels.hash32(jnp.asarray(keys))
                      % jnp.uint32(n_buckets)).astype(jnp.int32))
    got = cuda_kernels.hash_bucket_plain(_t(keys)[None, :], n_buckets)
    np.testing.assert_array_equal(got.numpy()[0], exp)


@pytest.mark.parametrize("n_buckets", [1, 8, 9, 65])
@pytest.mark.parametrize("cap", [1, 127, 1025, 3000])
def test_hash_bucket_matches_pallas(n_buckets, cap):
    """Batched [n_shards, cap] against the Pallas kernel shard by shard,
    ragged lengths included; the CPU wrapper runs the plain version."""
    keys = _batched_keys(np.random.RandomState(cap + n_buckets), 3, cap)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.hash_bucket(_t(keys), n_buckets).numpy()
    assert cuda_kernels.LAUNCHES == before  # no kernel launch on the CPU
    for s in range(keys.shape[0]):
        exp = hash_bucket_pallas(jnp.asarray(keys[s]), n_buckets,
                                 interpret=True)
        np.testing.assert_array_equal(got[s], np.asarray(exp))


# ---------------------------------------------------------------- digit_hist
# 256 bins compile slowly in interpret mode: one (skewed, multi-tile) case
@pytest.mark.parametrize("n_bins,cap,skew", [
    (9, 1000, False), (9, 2500, True), (65, 1000, False), (65, 2500, True),
    (256, 2500, True)])
def test_digit_hist_matches_pallas(n_bins, cap, skew):
    rng = np.random.RandomState(n_bins * 7 + cap)
    digits = rng.randint(0, n_bins, size=(2, cap)).astype(np.int32)
    if skew:  # most rows in one bin, spread over every tile
        digits[rng.rand(2, cap) < 0.9] = n_bins // 2
    got = cuda_kernels.digit_hist(_t(digits), n_bins).numpy()
    assert got.shape == (2, n_bins) and got.dtype == np.int32
    for s in range(2):
        exp = digit_hist_pallas(jnp.asarray(digits[s]), n_bins,
                                interpret=True)
        np.testing.assert_array_equal(got[s], np.asarray(exp))


def test_digit_hist_skips_out_of_range_digits():
    digits = np.array([[0, 1, 1, 5, -1, 2, I32.min, 3, I32.max]],
                      dtype=np.int32)  # 3 == n_bins
    got = cuda_kernels.digit_hist_plain(_t(digits), 3).numpy()
    np.testing.assert_array_equal(got, [[1, 2, 1]])
    got = cuda_kernels.digit_hist(_t(digits), 3).numpy()
    np.testing.assert_array_equal(got, [[1, 2, 1]])


# ---------------------------------------------------------- partition_pos
def _starts_of(bucket, n_bins):
    counts = np.stack([np.bincount(b, minlength=n_bins) for b in bucket])
    return (np.cumsum(counts, axis=1) - counts).astype(np.int32)


@pytest.mark.parametrize("n_bins,cap,skew", [
    (9, 777, False), (9, 3000, True), (65, 777, False), (65, 3000, True),
    (256, 3000, True)])
def test_partition_pos_matches_pallas(n_bins, cap, skew):
    """Stability across tiles: many equal buckets spread over several of
    the Pallas kernel's 1024-row tiles must keep their row order. (The CUDA
    kernel's 4096-row tiles are checked on the card by chip_smoke.py; on
    the CPU the wrapper runs the plain version.)"""
    rng = np.random.RandomState(n_bins + cap)
    bucket = rng.randint(0, n_bins, size=(2, cap)).astype(np.int32)
    if skew:
        bucket[rng.rand(2, cap) < 0.8] = 3
    starts = _starts_of(bucket, n_bins)
    got = cuda_kernels.partition_pos(_t(bucket), n_bins, _t(starts)).numpy()
    for s in range(2):
        exp = partition_pos_pallas(jnp.asarray(bucket[s]), n_bins,
                                   jnp.asarray(starts[s]), True)
        np.testing.assert_array_equal(got[s], np.asarray(exp))
        # a permutation when starts is the exclusive prefix of the counts
        np.testing.assert_array_equal(np.sort(got[s]), np.arange(cap))


def test_partition_pos_arbitrary_starts():
    """starts need not be a prefix of the counts: each row's position is
    its bin's start plus its rank among earlier equal rows."""
    bucket = np.array([[2, 0, 2, 1, 2, 0]], dtype=np.int32)
    starts = np.array([[100, 50, 7]], dtype=np.int32)
    got = cuda_kernels.partition_pos(_t(bucket), 3, _t(starts))
    np.testing.assert_array_equal(got.numpy(), [[7, 100, 8, 50, 9, 101]])


def _partition_pos_loop(bucket, n_bins, starts):
    """Row-by-row reference: -1 for a bin outside [0, n_bins)."""
    pos = np.full(bucket.shape, -1, dtype=np.int64)
    for s in range(bucket.shape[0]):
        seen = np.zeros(n_bins, dtype=np.int64)
        for i, b in enumerate(bucket[s]):
            if 0 <= b < n_bins:
                pos[s, i] = starts[s, b] + seen[b]
                seen[b] += 1
    return pos.astype(np.int32)


@pytest.mark.parametrize("n_bins", [1, 9, 256])
def test_partition_pos_out_of_range_bins_get_minus_one(n_bins):
    """Rows whose bin is -1, n_bins or INT32_MIN get -1 and do not move the
    ranks of the rows around them; a shard may hold no row in range."""
    rng = np.random.RandomState(n_bins)
    bucket = rng.randint(0, n_bins, size=(3, 600)).astype(np.int32)
    bad = rng.rand(3, 600) < 0.2
    bucket[bad] = rng.choice([-1, n_bins, I32.min, I32.max], size=bad.sum())
    bucket[2] = n_bins  # a shard with every row out of range
    starts = rng.randint(-50, 50, size=(3, n_bins)).astype(np.int32)
    got = cuda_kernels.partition_pos(_t(bucket), n_bins, _t(starts)).numpy()
    np.testing.assert_array_equal(got,
                                  _partition_pos_loop(bucket, n_bins, starts))
    assert (got[bucket != np.clip(bucket, 0, n_bins - 1)] == -1).all()


@pytest.mark.parametrize("cap", [0, 1, 4097])
def test_partition_pos_and_digit_hist_edge_shapes(cap):
    """The plain versions (what the wrappers run on a CPU tensor) against
    the Pallas kernels in interpret mode at edge shapes: one bin; every row
    in one bin; a ghost-only shard; no rows; cap not a multiple of 4. The
    CUDA kernels meet the same shapes on the card in chip_smoke.py."""
    rng = np.random.RandomState(cap)
    for n_bins in (1, 9):
        bucket = np.full((4, cap), n_bins - 1, dtype=np.int32)
        if cap:
            bucket[1] = rng.randint(0, n_bins, size=cap)
        starts = _starts_of(bucket, n_bins) if cap else \
            np.zeros((4, n_bins), dtype=np.int32)
        got = cuda_kernels.partition_pos(_t(bucket), n_bins,
                                         _t(starts)).numpy()
        hist = cuda_kernels.digit_hist(_t(bucket), n_bins).numpy()
        assert got.shape == (4, cap) and hist.shape == (4, n_bins)
        if not cap:  # the Pallas kernels take no empty input
            np.testing.assert_array_equal(hist, 0)
            continue
        for s in range(4):
            exp = partition_pos_pallas(jnp.asarray(bucket[s]), n_bins,
                                       jnp.asarray(starts[s]), True)
            np.testing.assert_array_equal(got[s], np.asarray(exp))
            exp = digit_hist_pallas(jnp.asarray(bucket[s]), n_bins,
                                    interpret=True)
            np.testing.assert_array_equal(hist[s], np.asarray(exp))


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(VegaError):
        cuda_kernels.hash_bucket(torch.zeros(8, dtype=torch.int32), 8)
    with pytest.raises(VegaError):
        cuda_kernels.hash_bucket(torch.zeros((2, 8), dtype=torch.int64), 8)
    with pytest.raises(VegaError):  # neither CPU nor CUDA
        cuda_kernels.hash_bucket(
            torch.zeros((2, 8), dtype=torch.int32, device="meta"), 8)
    with pytest.raises(VegaError):
        cuda_kernels.digit_hist(torch.zeros((4, 2), dtype=torch.int32).t(), 4)
    with pytest.raises(VegaError):
        cuda_kernels.digit_hist(torch.zeros((2, 8), dtype=torch.int32), 257)
    with pytest.raises(VegaError):
        cuda_kernels.partition_pos(
            torch.zeros((2, 8), dtype=torch.int32), 4,
            torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(VegaError):
        cuda_kernels.partition_pos(
            torch.zeros((2, 8), dtype=torch.int32), 300,
            torch.zeros((2, 300), dtype=torch.int32))


# ------------------------------------------------------- module functions
N_SHARDS = 4


def test_compact_matches_reference():
    rng = np.random.RandomState(1)
    cap, out_cap = 300, 200
    vals = rng.randint(-1000, 1000, size=(N_SHARDS, cap)).astype(np.int32)
    fl = rng.rand(N_SHARDS, cap).astype(np.float32)
    keep = rng.rand(N_SHARDS, cap) < np.array([0.2, 0.5, 0.8, 1.0])[:, None]
    got, got_count = kernels.compact({"a": _t(vals), "b": _t(fl)}, _t(keep),
                                     out_cap)
    for s in range(N_SHARDS):
        exp, exp_count = ref_kernels.compact(
            {"a": jnp.asarray(vals[s]), "b": jnp.asarray(fl[s])},
            jnp.asarray(keep[s]), out_cap)
        assert int(got_count[s]) == int(exp_count)
        for n in ("a", "b"):
            np.testing.assert_array_equal(got[n][s].numpy(),
                                          np.asarray(exp[n]))


@pytest.mark.parametrize("pregrouped", [False, True])
def test_group_by_bucket_matches_reference(pregrouped):
    rng = np.random.RandomState(2)
    n, cap = 8, 2500
    bucket = rng.randint(0, n + 1, size=(2, cap)).astype(np.int32)
    bucket[0, rng.rand(cap) < 0.7] = 5  # skewed shard
    if pregrouped:
        bucket = np.sort(bucket, axis=1)
    vals = rng.rand(2, cap).astype(np.float32)
    for s in range(2):
        jb = jnp.asarray(bucket[s])
        if pregrouped:
            exp_to, exp_starts = ref_kernels.pregrouped_group(jb, n)
            got_to, got_starts = kernels.pregrouped_group(_t(bucket), n)
        else:
            exp_cols, exp_to, exp_starts = ref_kernels._group_by_bucket(
                {"v": jnp.asarray(vals[s])}, jb, n)
            got_cols, got_to, got_starts = kernels._group_by_bucket(
                {"v": _t(vals)}, _t(bucket), n)
            np.testing.assert_array_equal(got_cols["v"][s].numpy(),
                                          np.asarray(exp_cols["v"]))
        np.testing.assert_array_equal(got_to[s].numpy(), np.asarray(exp_to))
        np.testing.assert_array_equal(got_starts[s].numpy(),
                                      np.asarray(exp_starts))


def test_bucket_key_sort_matches_reference():
    rng = np.random.RandomState(3)
    n, cap = 8, 400
    keys = rng.randint(-50, 50, size=(N_SHARDS, cap)).astype(np.int32)
    keys[:, :4] = [I32.min, I32.max, -1, 0]
    vals = np.arange(N_SHARDS * cap, dtype=np.float32).reshape(N_SHARDS, cap)
    count = np.array([400, 0, 123, 399], dtype=np.int32)
    mask = np.arange(cap)[None, :] < count[:, None]
    bucket = np.where(mask, rng.randint(0, n, size=(N_SHARDS, cap)),
                      n).astype(np.int32)
    got, got_b = kernels.bucket_key_sort({"k": _t(keys), "v": _t(vals)},
                                         _t(count), _t(bucket), "k")
    for s in range(N_SHARDS):
        exp, exp_b = ref_kernels.bucket_key_sort(
            {"k": jnp.asarray(keys[s]), "v": jnp.asarray(vals[s])},
            jnp.int32(count[s]), jnp.asarray(bucket[s]), "k")
        np.testing.assert_array_equal(got_b[s].numpy(), np.asarray(exp_b))
        for nm in ("k", "v"):
            np.testing.assert_array_equal(got[nm][s].numpy(),
                                          np.asarray(exp[nm]))


@pytest.mark.parametrize("op", ["add", "min", "max", "prod"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_reduce_named_matches_reference(op, dtype):
    rng = np.random.RandomState(4)
    cap = 512
    keys = rng.randint(0, 40, size=(N_SHARDS, cap)).astype(np.int32)
    if op == "prod":
        vals = rng.choice([1, 2, -1], size=(N_SHARDS, cap)).astype(dtype)
    else:
        vals = rng.randint(-1000, 1000, size=(N_SHARDS, cap)).astype(dtype)
    count = np.array([512, 0, 77, 300], dtype=np.int32)
    got, got_count = kernels.segment_reduce_named(
        {"k": _t(keys), "v": _t(vals)}, _t(count), "k", op)
    for s in range(N_SHARDS):
        exp, exp_count = ref_kernels.segment_reduce_named(
            {"k": jnp.asarray(keys[s]), "v": jnp.asarray(vals[s])},
            jnp.int32(count[s]), "k", op)
        assert int(got_count[s]) == int(exp_count)
        np.testing.assert_array_equal(got["k"][s].numpy(),
                                      np.asarray(exp["k"]))
        if dtype == np.int32:
            np.testing.assert_array_equal(got["v"][s].numpy(),
                                          np.asarray(exp["v"]))
        else:
            np.testing.assert_allclose(got["v"][s].numpy(),
                                       np.asarray(exp["v"]), rtol=1e-6)


def test_merge_join_expand_matches_reference():
    """Duplicate keys on both sides: the full dup x dup product, with a
    capacity too small for it reporting the exact total."""
    rng = np.random.RandomState(5)
    lcap, rcap = 256, 128
    lk = rng.randint(0, 30, size=(N_SHARDS, lcap)).astype(np.int32)
    rk = rng.randint(0, 30, size=(N_SHARDS, rcap)).astype(np.int32)
    lv = rng.rand(N_SHARDS, lcap).astype(np.float32)
    rv = rng.randint(0, 99, size=(N_SHARDS, rcap)).astype(np.int32)
    lcount = np.array([256, 10, 0, 200], dtype=np.int32)
    rcount = np.array([128, 100, 50, 0], dtype=np.int32)
    for out_cap in (4096, 256):
        got, got_count, got_total = kernels.merge_join_expand(
            {"k": _t(lk), "v": _t(lv)}, _t(lcount),
            {"k": _t(rk), "v": _t(rv)}, _t(rcount), "k", out_cap)
        for s in range(N_SHARDS):
            exp, exp_count, exp_total = ref_kernels.merge_join_expand(
                {"k": jnp.asarray(lk[s]), "v": jnp.asarray(lv[s])},
                jnp.int32(lcount[s]),
                {"k": jnp.asarray(rk[s]), "v": jnp.asarray(rv[s])},
                jnp.int32(rcount[s]), "k", out_cap)
            assert int(got_total[s]) == int(exp_total)
            c = int(exp_count)
            assert int(got_count[s]) == c
            for nm in ("k", "v", "r_v"):
                np.testing.assert_array_equal(got[nm][s].numpy()[:c],
                                              np.asarray(exp[nm])[:c])


def test_partition_by_bucket_matches_reference():
    rng = np.random.RandomState(6)
    n, cap = 8, 1500
    bucket = rng.randint(0, n + 1, size=(2, cap)).astype(np.int32)
    keys = rng.randint(-9, 9, size=(2, cap)).astype(np.int32)
    got, got_b = kernels.partition_by_bucket({"k": _t(keys)}, _t(bucket), n)
    for s in range(2):
        exp, exp_b = ref_kernels.partition_by_bucket(
            {"k": jnp.asarray(keys[s])}, jnp.asarray(bucket[s]), n)
        np.testing.assert_array_equal(got_b[s].numpy(), np.asarray(exp_b))
        np.testing.assert_array_equal(got["k"][s].numpy(),
                                      np.asarray(exp["k"]))


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
def test_row_cumsum_is_a_per_shard_scan(dtype):
    x = torch.from_numpy(np.random.RandomState(7).randint(
        0, 3, size=(5, 1001))).to(dtype)
    got = kernels.row_cumsum(x)
    assert got.dtype == torch.int64
    torch.testing.assert_close(got, torch.cumsum(x.to(torch.int64), dim=1),
                               rtol=0, atol=0)
