"""Shard-batched device algorithms of the dense tier.

Counterpart of vega_tpu/tpu/kernels.py. The reference runs each function
per shard inside shard_map; here every column is the batched
[n_shards, capacity] tensor and `count` is int[n_shards], so one call covers
all shards. Row placement and per-shard row order equal the reference's.

On a multi-process mesh (mesh.py) the columns hold this process's
n_local shards; only the exchange (bucket_exchange, given the mesh)
crosses processes.

Everything stays static-shape: raggedness is (count, validity mask), never a
dynamic dimension, so nothing here waits for the device except where a
caller fetches counts and overflow flags. Capacity overflow is reported per
shard as a flag the caller checks before it retries larger.

Every sort form of the reference is ported (dense_sort_impl): `xla` (stable
torch sorts), `packed` (one int64 sort of (word << 31) | position per
word), and `radix` / `radix4` (stable LSD passes of 8- or 4-bit digits, each
through the digit_hist and partition_pos kernels at 256 or 16 bins).
A two-column int64 key (block.KEY_LO) sorts, hashes (hash32_pair) and
range-partitions (searchsorted2, range_bucket) by both words. Traced
reduces (segment_reduce_sorted) run a log-step segmented scan in plain
torch ops; value actions reduce per shard (masked_reduce). Wide int64
values add exactly as two int64 addends (wide_sum_words, wide_from_sums);
the reference's pairwise forms (wide_add, wide_add_checked, wide_select)
are here too, bit-identical. threefry2x32, prng_key, fold_in and
uniform_f32 are jax.random's stream in int64 ops (sample's).
gf256_accumulate is the coded shuffle's GF(256) decode step over the
port's own log / exp tables (GF_EXP, GF_LOG).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from vega_tpu_torch import cuda_kernels
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch.errors import VegaError

Cols = Dict[str, torch.Tensor]

INT32_MAX = 2**31 - 1
INT32_MIN = -2**31

# ---------------------------------------------------------------------------
# plan resolution
# ---------------------------------------------------------------------------

SORT_IMPLS = ("auto", "xla", "packed", "radix", "radix4")
RBK_PLANS = ("auto", "fused_sort", "sort_partition")
TABLE_PLANS = ("auto", "on", "off")


def resolve_backend_mode(name: str, value: str, allowed: tuple,
                         cpu_choice: str, other_choice: str,
                         device: torch.device) -> str:
    """Validate a per-backend plan setting (dense_sort_impl,
    dense_rbk_plan, dense_table_plan) and resolve 'auto' by the device the
    Context runs on, as the reference resolves it by backend: cpu_choice on
    the CPU, other_choice on an accelerator. A misspelt value raises rather
    than silently running the default."""
    if value not in allowed:
        raise VegaError(
            f"{name} must be one of {', '.join(repr(a) for a in allowed)}; "
            f"got {value!r}")
    if value == "auto":
        return cpu_choice if torch.device(device).type == "cpu" \
            else other_choice
    return value

# ---------------------------------------------------------------------------
# hashing / masks / compaction
# ---------------------------------------------------------------------------

hash32 = cuda_kernels.hash32


def hash32_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The bucket hash of a two-column int64 key, bit-identical to
    vega_tpu.tpu.kernels.hash32_pair: a hash-combine of the two words'
    lowbias32 digests and one more finalizer round. uint32 arithmetic is
    emulated in int64 masked to 32 bits at every step that could carry
    past it; returns int64 values in [0, 2^32)."""
    a = hash32(hi)
    b = hash32(lo)
    x = a ^ ((b + 0x9E3779B9 + ((a << 6) & _WORD_MAX) + (a >> 2)) & _WORD_MAX)
    x = x ^ (x >> 16)
    x = cuda_kernels._mul32(x, 0x7FEB352D)
    return x ^ (x >> 15)


def wide_i64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 a (hi, biased-lo) word pair encodes (block.decode_i64 on
    the device): its order is the pair's lexicographic signed order."""
    return (hi.to(torch.int64) << 32) | (
        (lo.to(torch.int64) & _WORD_MAX) ^ 0x80000000)


def searchsorted2(rh: torch.Tensor, rl: torch.Tensor, qh: torch.Tensor,
                  ql: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Positions of queries (qh, ql) in 1-D rows (rh, rl) sorted by (rh
    major, rl minor), lexicographic signed compare: the reference's
    two-word binary search. Each word pair is one int64 here (wide_i64
    keeps the order), so one torch.searchsorted does it. Returns int64 of
    the queries' shape."""
    rows = wide_i64(rh, rl).contiguous()
    return torch.searchsorted(rows, wide_i64(qh, ql).contiguous(),
                              right=side == "right")


def range_bucket(bounds: torch.Tensor, keys: torch.Tensor, ascending: bool,
                 bounds_lo: Optional[torch.Tensor] = None,
                 keys_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Range-partition bucket ids (int32, keys' shape) from sorted split
    bounds (1-D): sort_by_key's partitioner, shared by its exchange and
    its sizing histogram. Descending flips ints with bitwise-not (negation
    wraps INT32_MIN onto itself) and negates floats, as the reference
    does; (bounds_lo, keys_lo) carry a two-column int64 key's low words.
    A NaN key goes past every bound in either direction (the last
    bucket), as the comparator sort puts it last either way; the bounds
    hold no NaN."""
    if keys.dtype.is_floating_point:
        nan = torch.isnan(keys)
        b = _range_bucket(bounds, torch.where(nan, 0.0, keys), ascending,
                          None, None)
        return torch.where(nan, bounds.shape[0], b)
    return _range_bucket(bounds, keys, ascending, bounds_lo, keys_lo)


def _range_bucket(bounds, keys, ascending, bounds_lo, keys_lo):
    if not ascending:
        # on both words of a wide key, bitwise-not reverses the pair order
        bounds, keys = _order_flip(bounds), _order_flip(keys)
        if bounds_lo is not None:
            bounds_lo, keys_lo = _order_flip(bounds_lo), _order_flip(keys_lo)
    if bounds_lo is None:
        return torch.searchsorted(bounds.contiguous(),
                                  keys.contiguous()).to(torch.int32)
    return searchsorted2(bounds, bounds_lo, keys, keys_lo).to(torch.int32)


def valid_mask(capacity: int, count: torch.Tensor) -> torch.Tensor:
    """[n_shards, capacity] bool: row i of shard s is valid iff
    i < count[s]."""
    return (torch.arange(capacity, device=count.device)[None, :]
            < count[:, None])


def _shard_offsets(n_shards: int, width: int, device) -> torch.Tensor:
    return torch.arange(n_shards, device=device, dtype=torch.int64)[:, None] \
        * width


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 prefix sums along dim 1 of [n_shards, capacity],
    taken as ONE scan over the flattened tensor minus each row's offset:
    torch's dim-1 scan runs a row per block, which leaves the card nearly
    idle with 8 rows; exact, since the sums are integers."""
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64).view(x.shape)
    before = torch.zeros_like(flat[:, :1])
    before[1:] = flat[:-1, -1:]
    return flat - before


def _scatter_rows(col: torch.Tensor, idx: torch.Tensor,
                  out_capacity: int) -> torch.Tensor:
    """dst[s, idx[s, i]] = col[s, i] into a zeroed [n_shards, out_capacity]
    tensor; rows whose idx is out of [0, out_capacity) are dropped (the
    reference's .at[idx].set(mode="drop"))."""
    n_shards = col.shape[0]
    ok = (idx >= 0) & (idx < out_capacity)
    flat = torch.where(
        ok, idx + _shard_offsets(n_shards, out_capacity, col.device),
        n_shards * out_capacity)
    dst = col.new_zeros((n_shards * out_capacity + 1,) + col.shape[2:])
    dst.index_put_((flat.reshape(-1),), col.reshape((-1,) + col.shape[2:]))
    return dst[:-1].view((n_shards, out_capacity) + col.shape[2:])


def compact(cols: Cols, keep: torch.Tensor,
            out_capacity: int) -> Tuple[Cols, torch.Tensor]:
    """Move each shard's rows where keep is True to its front, stably;
    returns (cols [n_shards, out_capacity], new_count int32[n_shards]).
    Rows past out_capacity are dropped; new_count still counts them, so the
    caller can see the overflow."""
    pos = row_cumsum(keep) - 1
    idx = torch.where(keep, pos, out_capacity)
    out = {n: _scatter_rows(c, idx, out_capacity) for n, c in cols.items()}
    return out, keep.sum(dim=1).to(torch.int32)


def gather_rows(cols: Cols, idx: torch.Tensor) -> Cols:
    """out[s, j] = col[s, idx[s, j]] for every column."""
    return {n: torch.gather(c, 1, idx) for n, c in cols.items()}


# ---------------------------------------------------------------------------
# exchange: the device shuffle on one device
# ---------------------------------------------------------------------------


def passthrough_exchange(cols: Cols, count: torch.Tensor, capacity: int,
                         out_capacity: int):
    """Rows stay on their shard: re-capacity the block. Returns
    (cols, count, overflow[n_shards])."""
    out, new_count = compact(cols, valid_mask(capacity, count), out_capacity)
    return out, new_count, new_count > out_capacity


def _group_by_bucket(cols: Cols, bucket: torch.Tensor, n_shards: int,
                     sort_impl: str = "xla"):
    """Stable-group each shard's rows by target bucket (values in
    [0, n_shards], n_shards the ghost bucket of invalid rows); returns
    (grouped cols, counts_to int32[n_shards, n_shards],
    starts int[n_shards, n_shards]).

    Up to 64 shards a counting partition: the histogram kernel gives the
    per-bucket counts and the rank kernel each row's position, one scatter
    per column places it. More shards take the stable sort by bucket: the
    packed sort under sort_impl='packed', else torch's stable sort.

    The reference's prefer_low_memory has no counterpart: the rank kernel
    streams in O(cap) on the card and its plain version is one stable sort,
    so neither builds the O(cap * n_shards) one-hot intermediates that the
    reference's low-memory form avoids."""
    counts_all = cuda_kernels.bucket_hist(bucket, n_shards + 1)
    counts_to = counts_all[:, :n_shards]
    starts_all = (torch.cumsum(counts_all, dim=1, dtype=torch.int32)
                  - counts_all)
    starts = starts_all[:, :n_shards]
    if n_shards <= 64:
        pos = cuda_kernels.partition_pos(bucket, n_shards + 1,
                                         starts_all.contiguous())
        capacity = bucket.shape[1]
        grouped = {name: _scatter_rows(col, pos.to(torch.int64), capacity)
                   for name, col in cols.items()}
        return grouped, counts_to, starts
    if sort_impl == "packed":
        every_row = torch.full((bucket.shape[0],), bucket.shape[1],
                               dtype=torch.int32, device=bucket.device)
        order = packed_sort_perm(orderable_words([bucket]), every_row)
    else:
        order = torch.sort(bucket, dim=1, stable=True).indices
    return gather_rows(cols, order), counts_to, starts


def partition_by_bucket(cols: Cols, bucket: torch.Tensor, n_shards: int,
                        sort_impl: str = "xla"
                        ) -> Tuple[Cols, torch.Tensor]:
    """Stable counting partition: each shard's rows become contiguous per
    bucket (the ghost bucket last), in-bucket order kept: the
    sort_partition reduce plan's grouping step. Returns (grouped cols,
    grouped bucket)."""
    grouped, _cto, _starts = _group_by_bucket(
        dict(cols, __bucket=bucket), bucket, n_shards, sort_impl=sort_impl)
    b = grouped.pop("__bucket")
    return grouped, b


def pregrouped_group(bucket: torch.Tensor, n_shards: int):
    """(counts_to, starts) for rows already contiguous per bucket: the
    histogram shortcut instead of _group_by_bucket."""
    counts_all = cuda_kernels.bucket_hist(bucket, n_shards + 1)
    counts_to = counts_all[:, :n_shards]
    starts = (torch.cumsum(counts_all, dim=1, dtype=torch.int32)
              - counts_all)[:, :n_shards]
    return counts_to, starts


def bucket_exchange(cols: Cols, count: torch.Tensor, bucket: torch.Tensor,
                    n_shards: int, slot_capacity: int, out_capacity: int,
                    pregrouped: bool = False, sort_impl: str = "xla",
                    mesh=None):
    """All-to-all by bucket id. Returns (cols [n_local, out_capacity],
    new_count int32[n_local], overflow bool[n_local]); n_shards is the
    global shard count (the buckets), n_local the leading dim of the
    columns (n_shards on one device).

    Send side: group each shard's rows by target (or trust a pregrouped
    layout) and cut n_shards slots of slot_capacity rows. The wire: where
    the reference runs lax.all_to_all over ICI, the [src, dst, slot] send
    buffers become [dst, src * slot]: on one device a gather, across the
    processes of a multi-process mesh (mesh given, mesh.collective) one
    all_to_all_single per column with equal splits
    (mesh.exchange_shards), plus one for the slot counts. Receive side:
    mask and compact the received rows."""
    capacity = bucket.shape[1]
    if n_shards == 1:
        return passthrough_exchange(cols, count, capacity, out_capacity)
    mask = valid_mask(capacity, count)
    bucket = torch.where(mask, bucket, n_shards)  # invalid rows -> ghost
    if pregrouped:
        counts_to, starts = pregrouped_group(bucket, n_shards)
        sorted_cols = cols
    else:
        sorted_cols, counts_to, starts = _group_by_bucket(
            cols, bucket, n_shards, sort_impl=sort_impl)
    overflow_send = (counts_to > slot_capacity).any(dim=1)

    dev = bucket.device
    slot_ar = torch.arange(slot_capacity, device=dev)
    # [src, dst, slot]: row of the sender's grouped block that fills a slot
    slot_rows = (starts.to(torch.int64)[:, :, None] + slot_ar).clamp_(
        0, capacity - 1)
    slot_valid = slot_ar < counts_to[:, :, None]
    send_counts = torch.clamp(counts_to, max=slot_capacity)
    across = mesh is not None and mesh.collective
    n_local = bucket.shape[0]
    recv_counts = (mesh_lib.exchange_shards(mesh, send_counts[:, :, None])
                   [:, :, 0] if across else send_counts.t())  # [dst, src]

    received: Cols = {}
    flat_rows = slot_rows.view(n_local, -1)
    for name, col in sorted_cols.items():
        buf = torch.gather(col, 1, flat_rows).view(n_local, n_shards,
                                                   slot_capacity)
        buf = torch.where(slot_valid, buf, torch.zeros((), dtype=col.dtype,
                                                       device=dev))
        received[name] = (mesh_lib.exchange_shards(mesh, buf) if across
                          else buf.transpose(0, 1)).reshape(
                              n_local, n_shards * slot_capacity)
    recv_valid = (slot_ar < recv_counts[:, :, None]).reshape(
        n_local, n_shards * slot_capacity)
    new_count = recv_counts.sum(dim=1).to(torch.int32)
    out_cols, _ = compact(received, recv_valid, out_capacity)
    return out_cols, new_count, overflow_send | (new_count > out_capacity)


# ---------------------------------------------------------------------------
# sorts: the `xla` form (stable torch sorts), the `packed` form (one int64
# sort per word) and the `radix` / `radix4` forms (LSD passes through the
# digit_hist and partition_pos kernels)
# ---------------------------------------------------------------------------

_WORD_MAX = 0xFFFFFFFF  # the largest orderable word


def _orderable_u32(col: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) whose order equals the column's order (int32:
    sign bit flipped; float32: sign-magnitude flip). torch has no uint32
    arithmetic on every device, so words are int64 holding uint32 values:
    bit-identical to the reference's uint32 words."""
    if col.dtype == torch.int32:
        return (col.to(torch.int64) & _WORD_MAX) ^ 0x80000000
    if col.dtype == torch.float32:
        u = col.view(torch.int32).to(torch.int64) & _WORD_MAX
        neg = (u >> 31) != 0
        return torch.where(neg, u ^ _WORD_MAX, u ^ 0x80000000)
    raise VegaError(f"sort keys must be int32 or float32, got {col.dtype}")


def orderable_words(cols) -> List[torch.Tensor]:
    """[_orderable_u32(c)] for a sequence of 32-bit columns: the one site
    that builds radix and packed words from columns."""
    return [_orderable_u32(c) for c in cols]


def _radix_supported(key: torch.Tensor) -> bool:
    return key.dtype in (torch.int32, torch.float32)


def _order_flip(col: torch.Tensor) -> torch.Tensor:
    """The descending flip: bitwise-not for ints (negation wraps INT32_MIN
    onto itself), negation for floats (exact)."""
    return -col if col.dtype.is_floating_point else torch.bitwise_not(col)


def _comparator_key(col: torch.Tensor) -> torch.Tensor:
    """A float column as the reference's comparator sort sees it: -0.0
    ties +0.0 and every NaN ties every other, after +inf. Canonical values
    give torch's sort the same ties on every device."""
    if not col.dtype.is_floating_point:
        return col
    col = torch.where(col == 0, 0.0, col)
    return torch.where(torch.isnan(col), float("nan"), col)


def _orderable_max(col: torch.Tensor):
    """The column dtype's largest value, as a Python scalar: a scalar
    tensor built on the card would be a host-to-device copy, which torch
    follows with a stream synchronize, stalling the host behind every
    launch still in flight (a deferred exchange's above all)."""
    if col.dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(col.dtype).max


def radix_sort_perm(words: List[torch.Tensor], count: torch.Tensor,
                    descending: bool = False, bits: int = 8,
                    word_bits: Optional[List[int]] = None) -> torch.Tensor:
    """Stable LSD radix sort permutation of each shard's rows over
    orderable words (int64 [n_shards, cap] holding uint32 values, LEAST
    significant word first); ghost rows (index >= count) sink to the end.
    Returns int64 [n_shards, cap]: output row j of shard s is source row
    perm[s, j] (gather_rows semantics).

    Each pass extracts one digit per row as contiguous int32, counts the
    digits (digit_hist, the reference's radix_hist), takes each shard's
    exclusive prefix as the starts, ranks the rows (partition_pos, the
    reference's radix_pos) and scatters the still-needed words and the
    permutation to their positions; payload columns move once, through the
    returned permutation. word_bits gives each word's significant width
    (default 32 each): a bucket id carried as the most significant word at
    8 bits costs one pass instead of four. Narrow words must be bounded by
    their width; descending needs full-width words (the flip is
    w ^ 0xFFFFFFFF, the reference's ~w on uint32)."""
    if word_bits is None:
        word_bits = [32] * len(words)
    if descending and any(b != 32 for b in word_bits):
        raise VegaError("radix_sort_perm: descending needs 32-bit words")
    n_shards, cap = words[0].shape
    mask = valid_mask(cap, count)
    active = []
    for w, wb in zip(words, word_bits):
        if descending:
            w = w ^ _WORD_MAX
        # ghosts get the word's maximum on every pass: they start last
        # and stay last under stability
        active.append(torch.where(mask, w, (1 << wb) - 1))
    widths = list(word_bits)
    perm = torch.arange(cap, device=count.device).expand(n_shards,
                                                         cap).contiguous()
    n_bins = 1 << bits
    while active:
        for shift in range(0, widths[0], bits):
            digits = ((active[0] >> shift) & (n_bins - 1)).to(torch.int32)
            hist = cuda_kernels.digit_hist(digits, n_bins)
            starts = (torch.cumsum(hist, dim=1, dtype=torch.int32)
                      - hist).contiguous()
            # a full permutation of each shard: every digit is in range
            pos = cuda_kernels.partition_pos(digits, n_bins,
                                             starts).to(torch.int64)
            active = [torch.empty_like(a).scatter_(1, pos, a)
                      for a in active]
            perm = torch.empty_like(perm).scatter_(1, pos, perm)
        active = active[1:]  # this word's digits are consumed
        widths = widths[1:]
    return perm


def packed_sort_perm(words: List[torch.Tensor], count: torch.Tensor,
                     descending: bool = False) -> torch.Tensor:
    """Stable sort permutation over orderable words (LSD first) from one
    int64 sort per word of (word << 31) | position: the position in the
    low 31 bits is the stability tie-break, so each pass is a sort of
    distinct values. Ghost rows (index >= count) get the maximal word and,
    tying with valid rows at most, stay behind them by position. Returns
    int64 [n_shards, cap].

    The reference skips a more-significant word that is constant over the
    valid rows with a device-side lax.cond; running that pass gives the
    identical permutation (every valid row ties, ghosts stay last), so this
    runs it and never asks the host. Needs cap < 2^31 (the position must
    fit 31 bits; word << 31 then stays below 2^63)."""
    n_shards, cap = words[0].shape
    if cap >= (1 << 31):
        raise VegaError("packed_sort_perm: capacity must fit 31 bits")
    mask = valid_mask(cap, count)
    position = torch.arange(cap, device=count.device)
    order = None
    for w in words:  # LSD -> MSD: one stable pass per word
        if descending:
            w = w ^ _WORD_MAX
        w = torch.where(mask, w, _WORD_MAX)
        wp = w if order is None else torch.gather(w, 1, order)
        pos = torch.sort((wp << 31) | position, dim=1).values & INT32_MAX
        order = pos if order is None else torch.gather(order, 1, pos)
    return order


def _sort_words_perm(words, count, impl: str, descending: bool = False,
                     word_bits=None) -> torch.Tensor:
    """The permutation of the packed or radix form over orderable words."""
    if impl == "packed":
        return packed_sort_perm(words, count, descending)
    return radix_sort_perm(words, count, descending,
                           bits=4 if impl == "radix4" else 8,
                           word_bits=word_bits)


def sort_by_column(cols: Cols, count: torch.Tensor, key_name: str,
                   descending: bool = False, impl: str = "xla",
                   lo_name: Optional[str] = None) -> Cols:
    """Stable sort of each shard's valid rows by one column, or by a
    two-column int64 key when lo_name names its low word; invalid rows
    sink to the end. impl (the Context's dense_sort_impl) 'radix' /
    'radix4' / 'packed' sorts int32, float32 and wide keys by their
    orderable words (a wide key's are [lo, hi]: the stored low word's
    signed order is the true low word's unsigned order); 'xla' (and any
    other key dtype) takes torch's stable sort, for a wide key one sort of
    the int64 the pair encodes (the same order)."""
    key = cols[key_name]
    if impl in ("radix", "radix4", "packed") and (
            lo_name is not None or _radix_supported(key)):
        words = orderable_words([cols[lo_name], key] if lo_name is not None
                                else [key])
        order = _sort_words_perm(words, count, impl, descending)
        return gather_rows(cols, order)
    return gather_rows(cols, torch.sort(
        _sort_column(key, count, descending,
                     None if lo_name is None else cols[lo_name]),
        dim=1, stable=True).indices)


def _sort_column(key: torch.Tensor, count: torch.Tensor, descending: bool,
                 lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The column one stable torch sort orders a shard's rows by (the
    reference's comparator sort: descending flips the key first), invalid
    rows after every valid one. A float32 key sorts as its canonical
    comparator words (-0.0 ties +0.0, every NaN ties every other, after
    +inf, in either direction), invalid rows at 2^32, past every word;
    the reference masks them with +inf, which a valid NaN sorts after
    (its NaN keys vanish in an exchange). An integer key (a wide key as
    the int64 its words encode) holds its dtype's maximum on invalid
    rows, which a valid row may tie: valid rows are a prefix, so
    stability keeps them first."""
    mask = valid_mask(key.shape[1], count)
    if lo is not None:
        key = wide_i64(key, lo)
    if descending:
        key = _order_flip(key)
    if key.dtype == torch.float32:
        return torch.where(mask, _orderable_u32(_comparator_key(key)),
                           1 << 32)
    return torch.where(mask, _comparator_key(key), _orderable_max(key))


def bucket_key_sort(cols: Cols, count: torch.Tensor, bucket: torch.Tensor,
                    key_name: str, impl: str = "xla",
                    n_shards: Optional[int] = None,
                    lo_name: Optional[str] = None
                    ) -> Tuple[Cols, torch.Tensor]:
    """One stable sort per shard by (bucket major, key minor). Rows become
    bucket-grouped with a key-sorted run per bucket, feeding both the
    presorted map-side combine and a pregrouped exchange. The caller has
    ghosted invalid rows (bucket = n_shards) so they sink to the end.
    Returns (cols, bucket), both permuted. lo_name names a two-column
    int64 key's low word: the key words are [lo, hi].

    impl 'xla': a single stable sort of the packed int64
    (bucket << 32) | orderable(key); for a wide key, a stable sort of the
    int64 the words encode, then a stable sort by bucket. 'radix' /
    'radix4': the key's word passes plus one narrow pass (two at 4 bits)
    for the bucket as an 8-bit most significant word, which needs
    n_shards < 255 so the ghost bucket fits; more shards keep the 'xla'
    form. 'packed': one packed pass per key word, then one for the bucket
    word."""
    key = cols[key_name]
    words_ok = lo_name is not None or _radix_supported(key)
    key_words = (lambda: orderable_words(
        [cols[lo_name], key] if lo_name is not None else [key]))
    if impl.startswith("radix") and n_shards is not None \
            and n_shards < 255 and words_ok:
        words = key_words() + [bucket.to(torch.int64)]
        order = _sort_words_perm(words, count, impl,
                                 word_bits=[32] * (len(words) - 1) + [8])
    elif impl == "packed" and words_ok:
        order = _sort_words_perm(key_words() + orderable_words([bucket]),
                                 count, impl)
    elif lo_name is not None:
        by_key = torch.sort(wide_i64(key, cols[lo_name]), dim=1,
                            stable=True).indices
        order = torch.gather(by_key, 1, torch.sort(
            torch.gather(bucket, 1, by_key), dim=1, stable=True).indices)
    else:
        # ghosted buckets already order the invalid rows last; canonical
        # floats give the words the comparator sort's ties
        packed = (bucket.to(torch.int64) << 32) | _orderable_u32(
            _comparator_key(key))
        order = torch.sort(packed, dim=1, stable=True).indices
    return gather_rows(cols, order), torch.gather(bucket, 1, order)


# ---------------------------------------------------------------------------
# selection: take_ordered / top
# ---------------------------------------------------------------------------


def topk_values(vals: torch.Tensor, count: torch.Tensor, k: int,
                largest: bool) -> torch.Tensor:
    """Each shard's k largest (or smallest) values, best first, as
    [n_shards, k]; rows past a shard's count are the reference's
    sentinels (-inf / INT32_MIN for largest, +inf / INT32_MAX for
    smallest). Selected over orderable words, i.e. in the total order
    lax.top_k uses (-NaN < -inf, -0.0 < +0.0, +inf < +NaN), so the chosen
    values are the reference's bit for bit, except that ghost rows take a
    word past every value's: the reference's sentinels rank before a
    valid +NaN when the smallest are taken (or a -NaN when the largest),
    and a shard with fewer rows than k loses it to them."""
    if largest:
        sentinel = float("-inf") if vals.dtype.is_floating_point \
            else INT32_MIN
    else:
        sentinel = _orderable_max(vals)
    words = torch.where(valid_mask(vals.shape[1], count),
                        _orderable_u32(vals), -1 if largest else 1 << 32)
    idx = torch.topk(words, k, dim=1, largest=largest, sorted=True).indices
    return torch.where(valid_mask(k, count), torch.gather(vals, 1, idx),
                       sentinel)


def row_sort_perm(cols: Sequence[torch.Tensor], count: torch.Tensor,
                  descending: bool, impl: str = "xla") -> torch.Tensor:
    """Stable permutation of each shard's rows in lexicographic order of
    the columns (first column most significant), ghost rows last:
    take_ordered / top's row sort. 'radix' / 'radix4' / 'packed' (32-bit
    columns only) sort every column's orderable word, as the reference
    does; 'xla' is the reference's one stable lax.sort over (invalid flag,
    every column, each flipped when descending: floats negated, ints
    bitwise-not) as stable torch sorts, least significant column first."""
    if impl in ("radix", "radix4", "packed"):
        return _sort_words_perm(orderable_words(list(reversed(cols))), count,
                                impl, descending)
    n_shards, cap = cols[0].shape

    def stable_pass(order, key):
        step = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        return torch.gather(order, 1, step)

    order = torch.arange(cap, device=count.device).expand(n_shards,
                                                          cap).contiguous()
    for col in reversed(cols):
        order = stable_pass(order, _comparator_key(
            _order_flip(col) if descending else col))
    return stable_pass(order, (~valid_mask(cap, count)).to(torch.int32))


# ---------------------------------------------------------------------------
# sorted-run segment operations (the reduce side)
# ---------------------------------------------------------------------------

SEGMENT_OPS = ("add", "min", "max", "prod")


def segment_reduce_named(cols: Cols, count: torch.Tensor, key_name: str,
                         op, presorted: bool = False,
                         sort_impl: str = "xla",
                         lo_name: Optional[str] = None
                         ) -> Tuple[Cols, torch.Tensor]:
    """Per-shard reduce of every value column over runs of equal keys with
    a named monoid (add/min/max/prod), one for every column or a mapping
    {column: monoid}. Returns compacted (cols, count): segment i of shard
    s in row i, key-sorted, zeros past the count. Unless presorted, the
    rows are first sorted by key with sort_impl. lo_name names a
    two-column int64 key's low word, which rides with the key. Each NaN
    key is a segment of its own (NaN != NaN)."""
    key_set = [key_name] if lo_name is None else [key_name, lo_name]
    for o in (set(op.values()) if isinstance(op, Mapping) else (op,)):
        if o not in SEGMENT_OPS:
            raise VegaError(f"unknown segment op {o!r}; expected one of "
                            f"{SEGMENT_OPS}")
    if not isinstance(op, Mapping):
        op = dict.fromkeys(cols, op)
    if not presorted:
        cols = sort_by_column(cols, count, key_name, impl=sort_impl,
                              lo_name=lo_name)
    keys = cols[key_name]
    n_shards, capacity = keys.shape
    mask = valid_mask(capacity, count)
    first = run_heads([cols[nm] for nm in key_set]) & mask
    seg_ids = row_cumsum(first) - 1
    n_segments = first.sum(dim=1).to(torch.int32)
    offsets = _shard_offsets(n_shards, capacity, keys.device)
    dump = n_shards * capacity  # dropped rows land in one extra slot
    flat_seg = torch.where(mask, seg_ids + offsets, dump).reshape(-1)
    seg_valid = valid_mask(capacity, n_segments)
    out: Cols = {}
    # the value columns of one monoid and dtype reduce together, as the
    # columns of one [rows, width] tensor
    batches: Dict[tuple, List[str]] = {}
    for name, col in cols.items():
        if name not in key_set:
            batches.setdefault((op[name], col.dtype), []).append(name)
    for (col_op, dtype), names in batches.items():
        src = (cols[names[0]].reshape(-1) if len(names) == 1 else
               torch.stack([cols[nm].reshape(-1) for nm in names], dim=1))
        if dtype == torch.bool:
            # CUDA's scatter_reduce_ has no bool form: min / max of 0 / 1
            src = src.to(torch.int32)
        acc = src.new_zeros((dump + 1,) + src.shape[1:])
        if col_op == "add":
            acc.index_add_(0, flat_seg, src)
        else:
            reduce = {"min": "amin", "max": "amax", "prod": "prod"}[col_op]
            idx = (flat_seg if len(names) == 1 else
                   flat_seg.unsqueeze(1).expand(-1, len(names)))
            acc.scatter_reduce_(0, idx, src, reduce, include_self=False)
        acc = acc.to(dtype)
        zero = torch.zeros((), dtype=dtype, device=src.device)
        for i, name in enumerate(names):
            vals = (acc if len(names) == 1 else acc[:, i])[:-1]
            out[name] = torch.where(seg_valid,
                                    vals.reshape(n_shards, capacity), zero)
    out = {nm: out[nm] for nm in cols if nm in out}
    # key of segment i = key at the i-th segment start
    flat_first = torch.where(first, seg_ids + offsets, dump).reshape(-1)
    for nm in key_set:
        key_out = cols[nm].new_zeros(dump + 1)
        key_out.index_put_((flat_first,), cols[nm].reshape(-1))
        out[nm] = key_out[:-1].view(n_shards, capacity)
    return out, n_segments


def run_heads(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n_shards, cap] bool: row 0 and every row whose key (any of the
    key's words) differs from the row before it."""
    first = torch.ones_like(key_cols[0], dtype=torch.bool)
    diff = key_cols[0][:, 1:] != key_cols[0][:, :-1]
    for kc in key_cols[1:]:
        diff |= kc[:, 1:] != kc[:, :-1]
    first[:, 1:] = diff
    return first


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def ragged_expand(counts_per_row: torch.Tensor, out_capacity: int):
    """Slot ownership for ragged expansion, per shard: row i emits
    counts_per_row[s, i] contiguous output slots. Returns (owner, offset,
    total): output slot j of shard s belongs to row owner[s, j] at position
    offset[s, j] of that row's run; total[s] is the exact output size,
    saturated to INT32_MAX (the reference's int32 wrap guard), so the
    caller fails loudly instead of truncating."""
    n_shards, n_rows = counts_per_row.shape
    m = counts_per_row.to(torch.int64)
    starts = row_cumsum(m) - m
    total = torch.clamp(m.sum(dim=1), max=INT32_MAX)
    j = torch.arange(out_capacity, device=m.device).expand(
        n_shards, out_capacity).contiguous()
    owner = (torch.searchsorted(starts, j, right=True) - 1).clamp_(
        0, max(n_rows - 1, 0))
    offset = j - torch.gather(starts, 1, owner)
    return owner, offset, total


def merge_join_expand(left: Cols, left_count: torch.Tensor, right: Cols,
                      right_count: torch.Tensor, key_name: str,
                      out_capacity: int, outer: bool = False,
                      fill_value=0, left_sorted: bool = False,
                      right_sorted: bool = False, sort_impl: str = "xla",
                      lo_name: Optional[str] = None):
    """Per-shard sort-merge join with duplicate keys on both sides (the
    full dup x dup product per key; left outer keeps unmatched left rows
    with fill_value). Output rows follow the left sort order in a fixed
    out_capacity. Returns (cols, count, total): count = min(total,
    out_capacity) and total the exact product size, which the caller uses
    to size one exact retry. Right value columns come out as "r_<name>".
    fill_value is one scalar for every right column or a mapping {right
    column: its stored fill word}. An unsorted side is sorted by key with
    sort_impl. lo_name names a two-column int64 key's low word (searched
    as the int64 the words encode). A NaN key matches nothing, as NaN !=
    NaN, and -0.0 matches 0.0."""
    if not left_sorted:
        left = sort_by_column(left, left_count, key_name, impl=sort_impl,
                              lo_name=lo_name)
    if not right_sorted:
        right = sort_by_column(right, right_count, key_name, impl=sort_impl,
                               lo_name=lo_name)
    lkeys = left[key_name]
    lcap, rcap = lkeys.shape[1], right[key_name].shape[1]
    # the search columns: sorted right rows, invalid ones at the end
    rsearch = _sort_column(right[key_name], right_count, False,
                           None if lo_name is None else right[lo_name])
    lsearch = lkeys
    if lo_name is not None:
        lsearch = wide_i64(lsearch, left[lo_name])
    elif lsearch.dtype == torch.float32:
        lsearch = _orderable_u32(_comparator_key(lsearch))
    rsearch, lsearch = rsearch.contiguous(), lsearch.contiguous()
    lmask = valid_mask(lcap, left_count)
    rc = right_count.to(torch.int64)[:, None]
    # Per-left-row match range in the sorted right rows; min() clips the
    # sentinel padding out when a valid key equals the sentinel.
    lo = torch.minimum(torch.searchsorted(rsearch, lsearch), rc)
    hi = torch.minimum(torch.searchsorted(rsearch, lsearch, right=True), rc)
    n_match = hi - lo
    if lkeys.dtype.is_floating_point:
        n_match = torch.where(torch.isnan(lkeys), 0, n_match)
    if outer:
        m = torch.where(lmask, torch.clamp(n_match, min=1), 0)
    else:
        m = torch.where(lmask, n_match, 0)
    li, off, total = ragged_expand(m, out_capacity)
    ri = (torch.gather(lo, 1, li) + off).clamp_(0, rcap - 1)
    row_matched = torch.gather(n_match > 0, 1, li)
    out: Cols = {key_name: torch.gather(lkeys, 1, li)}
    for name, col in left.items():
        if name != key_name:
            out[name] = torch.gather(col, 1, li)
    for name, col in right.items():
        if name in (key_name, lo_name):
            continue
        taken = torch.gather(col, 1, ri)
        if outer:
            fill = (fill_value[name] if isinstance(fill_value, Mapping)
                    else fill_value)
            taken = torch.where(row_matched, taken,
                                _fill_scalar(fill, col.dtype))
        out[f"r_{name}"] = taken
    count = torch.clamp(total, max=out_capacity).to(torch.int32)
    return out, count, total


def _fill_scalar(fill_value, dtype: torch.dtype):
    """fill_value cast to a column's dtype, as the reference's
    jnp.asarray(fill_value, dtype=col.dtype): a float fill over an integer
    column truncates toward zero (0.5 -> 0, -1.5 -> -1), so torch.where
    keeps the column's dtype instead of promoting it to float. Returned as
    a Python scalar: a tensor built on the card would be a copy and a
    synchronize. A fill the dtype cannot hold raises."""
    try:
        if dtype.is_floating_point:
            return float(fill_value)
        value = int(fill_value)
    except (TypeError, ValueError, OverflowError) as e:
        raise VegaError(f"fill_value {fill_value!r} has no {dtype} "
                        "form") from e
    info = torch.iinfo(dtype)
    if not info.min <= value <= info.max:
        raise VegaError(f"fill_value {fill_value!r} is outside {dtype}")
    return value


# ---------------------------------------------------------------------------
# traced reduces and per-shard value reductions
# ---------------------------------------------------------------------------


def segment_reduce_sorted(cols: Cols, count: torch.Tensor, key_name: str,
                          combine, presorted: bool = False,
                          sort_impl: str = "xla",
                          lo_name: Optional[str] = None
                          ) -> Tuple[Cols, torch.Tensor]:
    """Per-shard reduce over runs of equal keys with a traced combiner
    (value-column dict x value-column dict -> value-column dict): the
    reference's segmented associative scan, whose segment ends carry each
    run's reduction. Returns compacted (cols, count), key-sorted, the key
    (and lo_name, a two-column int64 key's low word) riding along.

    lax.associative_scan has no torch counterpart on the card, so the scan
    is the log-step (Hillis-Steele) form along dim 1: ceil(log2 cap)
    steps, each combining every row with the row `step` before it over
    whole shifted tensors, unless the row's window already holds a segment
    start; the start flags OR along. Plain torch ops: it runs the same on
    the CPU and on the card. Integer combiners give the reference's bits;
    float ones associate in another order."""
    if not presorted:
        cols = sort_by_column(cols, count, key_name, impl=sort_impl,
                              lo_name=lo_name)
    keys = cols[key_name]
    n_shards, capacity = keys.shape
    key_set = [key_name] if lo_name is None else [key_name, lo_name]
    first = run_heads([cols[nm] for nm in key_set])
    vals = {nm: c for nm, c in cols.items() if nm not in key_set}
    flags = first
    step = 1
    while step < capacity:
        head = {nm: v[:, step:] for nm, v in vals.items()}
        merged = combine({nm: v[:, :-step] for nm, v in vals.items()}, head)
        starts = flags[:, step:]
        vals = {nm: torch.cat([v[:, :step], torch.where(
            starts, head[nm], merged[nm])], dim=1)
            for nm, v in vals.items()}
        flags = torch.cat([flags[:, :step], flags[:, :-step] | starts],
                          dim=1)
        step *= 2
    mask = valid_mask(capacity, count)
    next_first = torch.ones_like(first)
    next_first[:, :-1] = first[:, 1:]
    last = torch.arange(capacity, device=keys.device)[None, :] \
        == (count.to(torch.int64) - 1)[:, None]
    out = dict(vals)
    for nm in key_set:
        out[nm] = cols[nm]
    return compact(out, mask & (next_first | last), capacity)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, two's complement: an int32 sum as the
    reference's int32 accumulator wraps it."""
    return (((x + 2**31) & _WORD_MAX) - 2**31).to(torch.int32)


def masked_reduce(col: torch.Tensor, count: torch.Tensor,
                  op: str) -> torch.Tensor:
    """Each shard's add / min / max over its valid rows: [n_shards]
    partials in the column's dtype (an int32 sum wraps like the
    reference's); an empty shard gives the op's identity (0, the dtype's
    max for min, its min for max)."""
    mask = valid_mask(col.shape[1], count)
    if op == "add":
        if col.dtype.is_floating_point:
            return torch.where(mask, col, 0).sum(dim=1, dtype=col.dtype)
        return _wrap_i32(torch.where(mask, col, 0).sum(dim=1,
                                                       dtype=torch.int64))
    if op == "min":
        return torch.where(mask, col, _orderable_max(col)).amin(dim=1)
    if op == "max":
        low = float("-inf") if col.dtype.is_floating_point \
            else torch.iinfo(col.dtype).min
        return torch.where(mask, col, low).amax(dim=1)
    raise VegaError(f"unknown reduction {op!r}")


# ---------------------------------------------------------------------------
# wide (two-column int64) value arithmetic
# ---------------------------------------------------------------------------


def _wide_unbias(lo: torch.Tensor) -> torch.Tensor:
    """Stored (biased int32) low word -> the true unsigned low word, as
    int64 in [0, 2^32)."""
    return (lo.to(torch.int64) & _WORD_MAX) ^ 0x80000000


def _wide_rebias(lo_u: torch.Tensor) -> torch.Tensor:
    """An unsigned low word (int64 in [0, 2^32)) -> the stored int32."""
    return _wrap_i32(lo_u ^ 0x80000000)


def wide_add(a_hi, a_lo, b_hi, b_lo):
    """int64 addition over the wide (hi int32, biased-lo int32) encoding,
    bit-identical to the reference's: the unsigned low words add with a
    carry into the high word, wrapping mod 2^64."""
    s = _wide_unbias(a_lo) + _wide_unbias(b_lo)
    hi = a_hi.to(torch.int64) + b_hi.to(torch.int64) + (s >> 32)
    return _wrap_i32(hi), _wide_rebias(s & _WORD_MAX)


def wide_add_checked(a_hi, a_lo, b_hi, b_lo):
    """wide_add plus the reference's signed-overflow predicate: operands
    of one sign whose sum's sign differs wrapped past the int64 range."""
    r_hi, r_lo = wide_add(a_hi, a_lo, b_hi, b_lo)
    ovf = ((a_hi < 0) == (b_hi < 0)) & ((r_hi < 0) != (a_hi < 0))
    return r_hi, r_lo, ovf


def wide_select(a_hi, a_lo, b_hi, b_lo, take_min: bool):
    """Lexicographic (hi, biased-lo) min / max: signed compares of the
    stored words are int64 order."""
    a_less = (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))
    pick_a = a_less if take_min else ~a_less
    return torch.where(pick_a, a_hi, b_hi), torch.where(pick_a, a_lo, b_lo)


def wide_words(x: torch.Tensor):
    """int64 -> its stored (hi int32, biased-lo int32) words: the inverse
    of wide_i64 (block.encode_i64 on the device)."""
    return (x >> 32).to(torch.int32), _wide_rebias(x & _WORD_MAX)


def wide_sum_words(hi: torch.Tensor, lo: torch.Tensor):
    """A wide column as two int64 addends whose sums are exact: the high
    words as they are and the unsigned low words. Summed over fewer than
    2^31 rows neither sum can wrap (|hi sum| < 2^62, lo sum < 2^63), so
    wide_from_sums recovers the exact total and knows whether it fits
    int64: the overflow decision is exact, where the reference's sticky
    pairwise flag is conservative and refolds on the host."""
    return hi.to(torch.int64), _wide_unbias(lo)


def wide_from_sums(hi_sum: torch.Tensor, lo_sum: torch.Tensor):
    """(hi int32, biased-lo int32, out_of_range bool) of the exact total
    hi_sum * 2^32 + lo_sum: out_of_range where it lies outside int64
    (the words then hold its value mod 2^64)."""
    hi = hi_sum + (lo_sum >> 32)
    return (_wrap_i32(hi), _wide_rebias(lo_sum & _WORD_MAX),
            (hi < INT32_MIN) | (hi > INT32_MAX))


def f64_order(bits: torch.Tensor) -> torch.Tensor:
    """The int64 bits of float64 values -> int64 words in the floats'
    order (a negative float's magnitude bits flipped); its own inverse."""
    return bits ^ ((bits >> 63) & (2**63 - 1))


_QUIET_NAN = 0x7FF8000000000000
_NAN_ROW_BITS = (1 << 50) - 1


def f64_key(x: torch.Tensor, order: torch.Tensor,
            side: Optional[int] = None) -> torch.Tensor:
    """A float64 exchange key as the int64 (wide key words) whose order and
    equality are those of Python floats, as the reference's host tier
    keys them: -0.0 reads as 0.0, so the two zeros are one key; a NaN,
    which equals nothing there, takes a quiet NaN whose payload is its
    row's order (int64, unique per row), after +inf, and side 0 or 1 sets
    bit 50, so a NaN of one join side never meets one of the other.
    side None (a sort) gives every NaN one key after +inf."""
    x = torch.where(x == 0, 0.0, x).contiguous()
    bits = x.view(torch.int64)
    if side is None:
        nan = torch.full_like(bits, _QUIET_NAN)
    else:
        nan = _QUIET_NAN | (side << 50) | (order & _NAN_ROW_BITS)
    return f64_order(torch.where(torch.isnan(x), nan, bits))


def f64_from_key(words: torch.Tensor,
                 negative_zero: torch.Tensor) -> torch.Tensor:
    """The float64 values of f64_key's words; negative_zero (bool) gives a
    zero key its sign back."""
    x = f64_order(words).contiguous().view(torch.float64)
    return torch.where((x == 0) & negative_zero, -0.0, x)


# ---------------------------------------------------------------------------
# the random stream: threefry2x32 as jax.random computes it
# ---------------------------------------------------------------------------

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of jax.random, on
    uint32 values held in int64 and masked to 32 bits after every add:
    key words (k0, k1) and counter words (x0, x1), each a Python int or
    an int64 tensor (they broadcast). Returns the two output words, bit
    for bit jax's threefry2x32_p on the same inputs, on every device."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _WORD_MAX
    x1 = (x1 + ks[1]) & _WORD_MAX
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _WORD_MAX
            x1 = (((x1 << r) & _WORD_MAX) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _WORD_MAX
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _WORD_MAX
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) (jax_enable_x64 off) for a seed in the
    int32 range: the key words (0, seed mod 2^32)."""
    if not INT32_MIN <= seed <= INT32_MAX:
        raise VegaError(f"seed {seed} is outside the int32 range that the "
                        "reference's PRNGKey takes without x64")
    return 0, seed & _WORD_MAX


def fold_in(k0, k1, data):
    """jax.random.fold_in: the key words of threefry2x32(key, (0, data)),
    data a Python int or an int64 tensor of uint32 values."""
    return threefry2x32(k0, k1, 0, data)


def uniform_f32(k0, k1, index: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 at flat positions `index`
    (int64 below 2^32) under jax_threefry_partitionable: the bits of
    position i are the xor of threefry2x32(key, (0, i))'s two words, the
    top 23 become the mantissa of a float in [1, 2), and 1 is
    subtracted."""
    b0, b1 = threefry2x32(k0, k1, 0, index)
    f = ((b0 ^ b1) >> 9) | 0x3F800000
    return f.to(torch.int32).view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# GF(256) decode (the coded shuffle's, vega_tpu/shuffle/coding.py)
# ---------------------------------------------------------------------------

def _build_gf_tables():
    """GF(256) exp / log tables, primitive polynomial 0x11D, generator 2;
    exp doubled to 512 entries so that log(a) + log(b) needs no mod 255
    (the port's copy of the reference's coding._build_tables)."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)  # log[0] stays 0; callers mask
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_gf_tables()
_GF_TILE = 1 << 25  # input bytes per tile: bounds the int32 index transients
_gf_device_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _gf_tables_on(dev: torch.device):
    """The tables on `dev`, copied once: a host-to-device copy inside a
    call could not be captured in a CUDA graph."""
    tabs = _gf_device_tables.get(dev)
    if tabs is None:
        tabs = (torch.from_numpy(GF_EXP).to(dev),
                torch.from_numpy(GF_LOG.astype(np.int64)).to(dev))
        _gf_device_tables[dev] = tabs
    return tabs


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of x [n >= 1, T], a halving tree."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        top = x[:h] ^ x[h:2 * h]
        if x.shape[0] % 2:
            top[0] ^= x[2 * h]
        x = top
    return x[0]


def gf256_accumulate(blocks, coeffs, device=None) -> torch.Tensor:
    """out = XOR_i c_i * B_i over GF(256): the decode step of the coded
    shuffle (the reference's kernels.gf256_accumulate). blocks: uint8
    [n, L] byte rows, coeffs: uint8 [n] (all ones for the XOR scheme,
    Cauchy entries for rs(k, m)); returns uint8 [L], bit-identical to
    coding._accumulate_np.

    Runs on the device of a tensor input; numpy input goes to
    mesh.resolve_device(device), the card unless device says otherwise.
    Each member's 256-entry product row c_i * b comes from the log gathers
    and the exp gather with the zero operands masked, as in the
    reference; then each byte is one gather from its member's row (int32
    indices), tiled over columns so the transients stay near 5 bytes per
    byte of a tile, and the members' products are XORed in a halving
    tree."""
    if isinstance(blocks, torch.Tensor):
        dev = blocks.device
    elif isinstance(coeffs, torch.Tensor):
        dev = coeffs.device
    else:
        dev = mesh_lib.resolve_device(device)
    if not isinstance(blocks, torch.Tensor):
        blocks = torch.from_numpy(np.ascontiguousarray(blocks,
                                                       dtype=np.uint8))
    if not isinstance(coeffs, torch.Tensor):
        coeffs = torch.from_numpy(np.ascontiguousarray(coeffs,
                                                       dtype=np.uint8))
    blocks = blocks.to(device=dev, dtype=torch.uint8)
    coeffs = coeffs.to(device=dev, dtype=torch.uint8).reshape(-1)
    if blocks.dim() != 2 or coeffs.shape[0] != blocks.shape[0]:
        raise VegaError(f"gf256_accumulate: blocks [n, L] and coeffs [n], "
                        f"got {tuple(blocks.shape)} and "
                        f"{tuple(coeffs.shape)}")
    n, width = blocks.shape
    out = torch.zeros(width, dtype=torch.uint8, device=dev)
    if n == 0 or width == 0:
        return out
    exp_t, log_t = _gf_tables_on(dev)
    byte = torch.arange(256, device=dev)
    rows = exp_t[log_t[byte][None, :] + log_t[coeffs.long()][:, None]]
    rows = torch.where((byte == 0)[None, :] | (coeffs == 0)[:, None],
                       torch.zeros((), dtype=torch.uint8, device=dev), rows)
    flat = rows.reshape(-1)  # member i's row at [256 * i, 256 * i + 256)
    base = (torch.arange(n, device=dev, dtype=torch.int32) * 256)[:, None]
    tile = max(1, _GF_TILE // n)
    for s in range(0, width, tile):
        e = min(width, s + tile)
        idx = blocks[:, s:e].to(torch.int32) + base
        prod = flat.index_select(0, idx.reshape(-1)).view(n, e - s)
        out[s:e] = _xor_rows(prod)
    return out
