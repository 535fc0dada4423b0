"""HyperLogLog over device columns: the reference's count_approx_distinct
(vega_tpu/utils/hll.py), with its sketch built on the device.

The reference adds each host row to a sketch of m = 2^p registers through
partitioner.hash_key, a splitmix64-based hash of the row's Python value,
merges the partitions' registers with a max and estimates on the host.
The port computes hash_key over whole columns as int64 torch ops (the
words wrap mod 2^64 as the reference masks them; right shifts are made
logical with a mask):

    row value             hash_key
    bool                  splitmix64(int(b))
    int (int32, a narrow  splitmix64(v mod 2^64)
    or uint32 column, a
    wide int64 pair)
    float                 an integral value in [-2^63, 2^63) as its int,
                          else splitmix64 of its float64 bits (a float32
                          NaN keeps its payload, as the host's float()
                          does)
    str                   splitmix64(FNV-1a of its UTF-8 bytes), hashed
                          once per dictionary entry on the host and
                          gathered by code
    tuple (a (k, v) row,  h = 0x345678; h = splitmix64((h * 1000003) ^
    several columns)      hash_key(item)) for each item

Each shard's registers are one scatter_reduce_(amax) over its 2^p slots;
the shards' registers are read in one host_get and merged with a max, and
estimate() runs on the host on the merged registers, as the reference's
does, so the estimate equals the reference's integer."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from vega_tpu_torch import partitioner


def _signed(x: int) -> int:
    """A 64-bit word as the int64 that holds its bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def precision_for(relative_sd: float) -> int:
    """The smallest precision whose standard error (1.04 / sqrt(m)) meets
    relative_sd, in [4, 18]."""
    p = math.ceil(2 * math.log2(1.04 / relative_sd))
    return max(4, min(18, p))


def estimate(registers: np.ndarray) -> int:
    """The reference's HyperLogLog.estimate over merged registers: the
    bias-corrected raw estimate, linear counting in the small range, the
    large-range correction at the top."""
    m = float(registers.size)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv_sum = float(np.sum(np.exp2(-registers.astype(np.float64))))
    raw = alpha * m * m / inv_sum
    if raw <= 2.5 * m:
        zeros = int(np.count_nonzero(registers == 0))
        if zeros:
            return int(round(m * math.log(m / zeros)))
        return int(round(raw))
    two64 = 2.0 ** 64
    if raw > two64 / 30.0:
        return int(round(-two64 * math.log1p(-raw / two64)))
    return int(round(raw))


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The reference's splitmix64 over int64 words (mod 2^64)."""
    x = x + _GOLDEN
    x = (x ^ _lshr(x, 30)) * _M1
    x = (x ^ _lshr(x, 27)) * _M2
    return x ^ _lshr(x, 31)


def hash_strings(dictionary: np.ndarray) -> np.ndarray:
    """int64 hash_key of each entry of a string column's dictionary."""
    out = np.empty(len(dictionary), np.int64)
    for i, s in enumerate(dictionary.tolist()):
        out[i] = _signed(partitioner.hash_key(str(s)))
    return out


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    """The float64 bits the host's float() gives a float column's values;
    a float32 NaN keeps its sign and payload, quieted, as the host's
    conversion keeps them."""
    x64 = x.to(torch.float64)
    bits = x64.view(torch.int64)
    if x.dtype == torch.float32:
        b32 = x.view(torch.int32).to(torch.int64)
        nan = ((b32 & (1 << 31)) << 32) | 0x7FF8000000000000 \
            | ((b32 & 0x7FFFFF) << 29)
        bits = torch.where(torch.isnan(x), nan, bits)
    return bits


def hash_column(col: torch.Tensor, kind: str,
                codes_hash: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 hash_key of each value of one logical column: kind "bool",
    "int" (int64 values), "float" (a float tensor) or "str" (col the
    codes, codes_hash the dictionary's hashes on the column's device)."""
    if kind == "str":
        return codes_hash[col.to(torch.int64)]
    if kind in ("bool", "int"):
        return splitmix64(col.to(torch.int64))
    x64 = col.to(torch.float64)
    integral = torch.isfinite(x64) & (x64 == torch.trunc(x64)) \
        & (x64 >= -2.0 ** 63) & (x64 < 2.0 ** 63)
    ival = torch.where(integral, x64, 0.0).to(torch.int64)
    return splitmix64(torch.where(integral, ival, _float_bits(col)))


def hash_tuple(hashes: List[torch.Tensor]) -> torch.Tensor:
    """hash_key of a tuple from its items' hashes."""
    h = torch.full_like(hashes[0], 0x345678)
    for item in hashes:
        h = splitmix64((h * 1000003) ^ item)
    return h


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """The bit length of int64 words read as unsigned (0 for 0)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        t = _lshr(x, s)
        big = t != 0
        n = n + torch.where(big, s, 0)
        x = torch.where(big, t, x)
    return n + (x != 0).to(torch.int64)


def registers(h: torch.Tensor, valid: torch.Tensor, p: int) -> torch.Tensor:
    """Each shard's [2^p] registers (int32) of the hashes h of its valid
    rows: slot h >> (64 - p), rank the leading zeros of the other 64 - p
    bits plus one, one scatter_reduce_(amax) a shard."""
    idx = _lshr(h, 64 - p)
    rest = h << p
    rank = torch.where(rest == 0, 64 - p + 1, 64 - _bit_length(rest) + 1)
    rank = torch.where(valid, rank, 0).to(torch.int32)
    reg = torch.zeros((h.shape[0], 1 << p), dtype=torch.int32,
                      device=h.device)
    return reg.scatter_reduce_(1, idx, rank, "amax")


def row_registers(rows, p: int) -> np.ndarray:
    """The [2^p] registers (uint8) of host rows, one hash_key a row: a
    host RDD partition's sketch, as the reference's HyperLogLog.add
    builds it."""
    reg = np.zeros(1 << p, np.uint8)
    for x in rows:
        h = partitioner.hash_key(x)
        idx = h >> (64 - p)
        rest = (h << p) & partitioner.MASK
        rank = 64 - p + 1 if rest == 0 else 64 - rest.bit_length() + 1
        if rank > reg[idx]:
            reg[idx] = rank
    return reg
