"""Two-column int64 keys in vega_tpu_torch against vega_tpu, on the CPU.

The word encoding (encode_i64 / decode_i64), the bucket hash hash32_pair,
the two-word searchsorted2 and the range partitioner range_bucket (both
directions, int32 / float32 / wide keys) must be bit-identical to the
vega_tpu.tpu functions on random words that include 0, -1, INT32_MIN and
INT32_MAX; the wide sort_by_column equal to the reference's under every
sort form. A reference Block with a wide key carries across and groups
equal. What the reference hands to its host tier over a wide key (a
join with a float key, a cartesian of a pair side, a source no block
holds) is the port's host RDD layer's; nothing computes on the high word
alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.tpu import block as ref_block
from vega_tpu.tpu import kernels as ref_kernels
from vega_tpu.tpu import mesh as ref_mesh
import vega_tpu_torch as vt
from vega_tpu_torch import block as port_block
from vega_tpu_torch import dense_rdd as port_dense
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
I32 = np.iinfo(np.int32)
WORD_EDGES = np.array([0, -1, I32.min, I32.max, 1, I32.min + 1],
                      dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(n, seed):
    """n random int32 words with every edge word present."""
    rng = np.random.RandomState(seed)
    w = rng.randint(I32.min, I32.max, size=n, dtype=np.int64).astype(np.int32)
    w[:len(WORD_EDGES)] = WORD_EDGES
    return w


@pytest.fixture()
def port_ctx():
    with vt.Context(device="cpu", n_shards=N_SHARDS) as context:
        yield context


def test_encode_i64_matches_reference():
    rng = np.random.RandomState(1)
    a = rng.randint(-2**62, 2**62, size=5_000, dtype=np.int64)
    a[:8] = [0, -1, 2**63 - 1, -2**63, I32.min, I32.max, I32.max + 1,
             I32.min - 1]
    got, exp = port_block.encode_i64(a), ref_block.encode_i64(a)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype == np.int32
        np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(port_block.decode_i64(*got), a)
    # the device reassembly is the host decode
    np.testing.assert_array_equal(
        kernels.wide_i64(_t(got[0]), _t(got[1])).numpy(), a)


def test_hash32_pair_matches_reference():
    hi = _words(20_000, 2)
    lo = np.roll(_words(20_000, 3), 7)
    lo[:36] = np.repeat(WORD_EDGES, 6)
    hi[:36] = np.tile(WORD_EDGES, 6)  # every pair of edge words
    got = kernels.hash32_pair(_t(hi)[None, :], _t(lo)[None, :])[0].numpy()
    exp = np.asarray(ref_kernels.hash32_pair(jnp.asarray(hi),
                                             jnp.asarray(lo))).astype(np.int64)
    np.testing.assert_array_equal(got, exp)
    for n in (8, 9, 65):
        buckets = port_dense._bucket_cols(
            {"k": _t(hi)[None, :], "k.lo": _t(lo)[None, :]}, n)
        np.testing.assert_array_equal(buckets[0].numpy(), exp % n)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted2_matches_reference(side):
    rh = np.sort(np.random.RandomState(4).choice(WORD_EDGES, 300)
                 ).astype(np.int32)
    rl = _words(300, 5)
    order = np.lexsort([rl, rh])
    rh, rl = rh[order], rl[order]
    qh = np.concatenate([rh, np.random.RandomState(6).choice(WORD_EDGES, 700)
                         ]).astype(np.int32)
    ql = np.concatenate([rl, _words(700, 7)]).astype(np.int32)
    got = kernels.searchsorted2(_t(rh), _t(rl), _t(qh).view(10, 100),
                                _t(ql).view(10, 100), side)
    exp = ref_kernels.searchsorted2(jnp.asarray(rh), jnp.asarray(rl),
                                    jnp.asarray(qh), jnp.asarray(ql), side)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(exp))


def _bounds_and_keys(kind, ascending):
    """Sorted bounds (descending when not ascending) and keys of a kind."""
    rng = np.random.RandomState(8)
    if kind == "int32":
        keys = _words(4_000, 9)
        bounds = np.sort(rng.choice(keys, 7))
    elif kind == "float32":
        keys = (rng.randn(4_000) * 100).astype(np.float32)
        keys[:7] = [np.inf, -np.inf, -0.0, 0.0, np.nan, -np.nan, 1e-40]
        bounds = rng.choice(keys[7:], 7)
        bounds[3] = 0.0
        bounds = np.sort(bounds).astype(np.float32)
    else:
        keys = rng.randint(-2**62, 2**62, size=4_000, dtype=np.int64)
        keys[:6] = [0, -1, I32.min, I32.max, 2**62, -2**62]
        bounds = np.sort(rng.choice(keys, 7))
        bounds[2] = bounds[3]  # a repeated bound
        keys[10:17] = bounds
    if not ascending:
        bounds = bounds[::-1].copy()
    return bounds, keys


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("kind", ["int32", "float32", "wide"])
def test_range_bucket_matches_reference(kind, ascending):
    """Also pins NaN keys (float32): both packages put them past every
    bound in either direction (the last shard). A subnormal key
    differs by the reference's platform (ROADMAP queue 3). On the card
    the port's range_bucket equals its CPU result on float32 subnormal
    keys and bounds, both directions (chip_smoke.py phase 8f, NVIDIA
    H100): the port orders subnormals as IEEE does on both devices."""
    bounds, keys = _bounds_and_keys(kind, ascending)
    if kind == "wide":
        bh, bl = port_block.encode_i64(bounds)
        kh, kl = port_block.encode_i64(keys)
        got = kernels.range_bucket(_t(bh), _t(kh).view(8, 500), ascending,
                                   _t(bl), _t(kl).view(8, 500))
        exp = ref_kernels.range_bucket(jnp.asarray(bh), jnp.asarray(kh),
                                       ascending, jnp.asarray(bl),
                                       jnp.asarray(kl))
    else:
        got = kernels.range_bucket(_t(bounds), _t(keys).view(8, 500),
                                   ascending)
        exp = ref_kernels.range_bucket(jnp.asarray(bounds),
                                       jnp.asarray(keys), ascending)
    assert got.dtype == torch.int32
    got, exp = got.reshape(-1).numpy(), np.asarray(exp)
    if kind == "float32":
        # XLA:CPU flushes subnormals to zero, so the reference puts 1e-40
        # where 0.0 goes; the port compares as IEEE does (numpy agrees)
        sub = (keys != 0) & (np.abs(keys) < np.finfo(np.float32).tiny)
        flip = 1 if ascending else -1
        np.testing.assert_array_equal(
            got[sub], np.searchsorted(flip * bounds, flip * keys[sub]))
        got, exp = got[~sub], exp[~sub]
        nan = np.isnan(keys[~sub])
        assert (got[nan] == 7).all()  # past every bound, either way
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("impl", ["xla", "packed", "radix", "radix4"])
def test_wide_sort_by_column_matches_reference(impl, descending):
    """Ghost rows take the orderable maximum of both words; a valid key at
    that maximum ties with them and stays first."""
    rng = np.random.RandomState(10)
    cap, counts = 600, np.array([600, 0, 311, 599], dtype=np.int32)
    a = rng.randint(-50, 50, size=(4, cap)).astype(np.int64) << 31
    a[:, :4] = [2**63 - 1, -2**63, 0, -1]  # both words at their extremes
    hi, lo = port_block.encode_i64(a.reshape(-1))
    hi, lo = hi.reshape(4, cap), lo.reshape(4, cap)
    vals = np.arange(4 * cap, dtype=np.int32).reshape(4, cap)
    got = kernels.sort_by_column({"k": _t(hi), "k.lo": _t(lo), "v": _t(vals)},
                                 _t(counts), "k", descending=descending,
                                 impl=impl, lo_name="k.lo")
    for s in range(4):
        exp = ref_kernels.sort_by_column(
            {"k": jnp.asarray(hi[s]), "k.lo": jnp.asarray(lo[s]),
             "v": jnp.asarray(vals[s])}, jnp.int32(counts[s]), "k",
            descending=descending, lo_name="k.lo", impl=impl)
        for nm in ("k", "k.lo", "v"):
            np.testing.assert_array_equal(got[nm][s].numpy(),
                                          np.asarray(exp[nm]))


def test_block_round_trip_and_encoding(port_ctx):
    """from_numpy encodes a key beyond int32 (an in-range int64 key stays
    narrow); every host read reassembles the int64."""
    keys = np.array([2**40, -5, 2**40, 7, -2**50], dtype=np.int64)
    r = port_ctx.dense_from_numpy(keys, np.arange(5, dtype=np.float64))
    assert [nm for nm, _ in r._schema()] == ["k", "k.lo", "v"]
    assert r.collect() == list(zip(keys.tolist(), [0.0, 1.0, 2.0, 3.0, 4.0]))
    arrays = r.collect_arrays()
    assert arrays["k"].dtype == np.int64 and list(arrays) == ["k", "v"]
    assert r.block().shard_rows(0)["k"].tolist() == [2**40]
    narrow = port_ctx.dense_from_numpy(keys % 100, np.arange(5))
    assert [nm for nm, _ in narrow._schema()] == ["k", "v"]


def test_reference_block_with_wide_key_carries_across(port_ctx):
    rng = np.random.RandomState(11)
    keys = (1 << 40) + rng.randint(0, 300, size=3_001).astype(np.int64)
    vals = rng.rand(3_001).astype(np.float32)
    ref = ref_block.from_numpy({"k": keys, "v": vals},
                               ref_mesh.default_mesh())
    assert "k.lo" in ref.cols
    cols = {n: np.asarray(c) for n, c in ref.cols.items()}
    blk = port_block.from_reference_arrays(cols, ref.counts_np, ref.capacity,
                                           port_ctx.mesh)
    exp, got = ref.to_numpy(), blk.to_numpy()
    assert list(got) == list(exp) == ["k", "v"]
    for n in exp:
        np.testing.assert_array_equal(got[n], exp[n])
    for s in range(N_SHARDS):
        for n, col in blk.shard_rows(s).items():
            np.testing.assert_array_equal(col, ref.shard_rows(s)[n])
    from vega_tpu.tpu.dense_rdd import dense_from_block

    got_g = port_dense.dense_from_block(port_ctx, blk).group_by_key()
    with v.Context("local", num_workers=2) as rctx:
        exp_g = dense_from_block(rctx, ref).group_by_key()
        np.testing.assert_array_equal(got_g.block().counts_np,
                                      exp_g.block().counts_np)
        assert sorted(got_g.collect()) == sorted(exp_g.collect())
    with pytest.raises(VegaError, match="high word"):
        port_block.from_reference_arrays({"k.lo": cols["k.lo"]},
                                         ref.counts_np, ref.capacity,
                                         port_ctx.mesh)


def test_refusals(port_ctx):
    """What the reference hands to its host tier is the port's host RDD
    layer's (keys that cannot meet on the device, a source no block
    holds, a cartesian of a pair side), with the host's rows; what its
    device forms refuse raises VegaError. Row functions over a wide
    key run in the host tier's row form (host_rows.py), with the host's
    rows: the key an exact int, the float32 value a Python float. Wide
    values, wide-key reduces and joins, and an int32 key meeting an int64
    one run; nothing computes on the high word alone."""
    wide = port_ctx.dense_from_numpy(np.array([2**40, 3], dtype=np.int64),
                                     np.array([1.0, 2.0]))
    narrow = port_ctx.dense_from_numpy(np.array([1, 3], dtype=np.int32),
                                       np.array([1.0, 2.0]))
    doubled = wide.map(lambda kv: (kv[0], kv[1] * 2))
    assert doubled.host_rows
    assert doubled.collect() == [(2**40, 2.0), (3, 4.0)]
    assert wide.filter(lambda kv: kv[1] > 1).collect() == [(3, 2.0)]
    floats = port_ctx.dense_from_numpy(np.array([3.0, 1.0], np.float32),
                                       np.ones(2))
    got = wide.join(floats)  # float against int64: Python's equality
    assert not isinstance(got, port_dense.DenseRDD)
    assert got.collect() == [(3, (2.0, 1.0))]
    assert dict(wide.reduce_by_key(op="add").collect()) == {2**40: 1.0,
                                                            3: 2.0}
    assert wide.join(narrow).collect() == [(3, (2.0, 2.0))]
    assert narrow.join(wide).collect() == [(3, (2.0, 2.0))]
    assert sorted(wide.cogroup(narrow).collect()) == [
        (1, ([], [1.0])), (3, ([2.0], [2.0])), (2**40, ([1.0], []))]
    wide_v = port_ctx.dense_from_numpy(np.array([1, 2], dtype=np.int32),
                                       np.array([2**40, 1], dtype=np.int64))
    assert wide_v.collect() == [(1, 2**40), (2, 1)]
    with pytest.raises(VegaError, match="reserved"):
        port_block.from_numpy({"k.lo": np.zeros(3, np.int64)}, port_ctx.mesh)
    u64 = port_ctx.dense_from_numpy(np.array([2**63], dtype=np.uint64),
                                    np.zeros(1))  # no block holds it
    assert not isinstance(u64, port_dense.DenseRDD)
    assert u64.collect() == [(2**63, 0.0)]
    with pytest.raises(VegaError, match="canonical"):
        narrow.join(narrow).group_by_key()
    assert sorted(narrow.cogroup(floats).collect()) == [
        (1, ([1.0], [1.0])), (3, ([2.0], [1.0]))]
    assert narrow.cartesian(port_ctx.dense_range(2)).collect() == [
        ((1, 1.0), 0), ((1, 1.0), 1), ((3, 2.0), 0), ((3, 2.0), 1)]
    # what runs on a wide key does not touch the high word alone: keys
    # equal in the high word stay apart
    same_hi = port_ctx.dense_from_numpy(
        np.array([2**40, 2**40 + 1, 2**40], dtype=np.int64),
        np.array([1, 2, 3], dtype=np.int32))
    assert sorted(same_hi.group_by_key().collect()) == [
        (2**40, [1, 3]), (2**40 + 1, [2])]
    assert same_hi.sort_by_key(False).take(1) == [(2**40 + 1, 2)]
