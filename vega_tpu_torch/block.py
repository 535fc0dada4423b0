"""Columnar partition blocks: the dense tier's unit of data.

Counterpart of vega_tpu/tpu/block.py. A Block holds named columns, each a
[n_shards, capacity] tensor on the mesh's device, plus a per-shard valid-row
count: rows [0, counts[s]) of row s are shard s's valid rows. Static
capacity keeps shapes stable; raggedness lives in `counts`, never in shapes.

The block dtype contract is the reference's 32-bit one (_check_dtype):
int64 narrows to int32 when its values fit; float64 narrows to float32.
An int64 column beyond int32, the KEY or a value, takes the reference's
two-column encoding (<name> = high word, <name>.lo = biased low word;
encode_key_columns, encode_value_columns) and host reads reassemble it.
A string column becomes int32 rank codes plus its sorted dictionary in
Block.dicts (dict_encoding.py); host reads decode it (_decode_dict_cols).
An int8 / int16 / uint8 / uint16 / uint32 / float16 column is stored in 32
bits under its logical dtype in Block.logical (coltypes.py), which host
reads restore. The key column is one value per row: a key with trailing
dims is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vega_tpu_torch import coltypes
from vega_tpu_torch import dict_encoding
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.mesh import ShardMesh

KEY = "k"  # canonical key column
VALUE = "v"  # canonical value column
# Wide (two-column int64) keys and values, as in the reference: <name>
# holds the high 32 bits (signed: keeps the order) and <name>.lo the low 32
# bits with the sign bit flipped, so signed (<name>, <name>.lo) order is
# int64 order.
LO_SUFFIX = ".lo"
KEY_LO = KEY + LO_SUFFIX
_LO_BIAS = np.uint32(0x80000000)


def lo_of(name: str) -> str:
    return name + LO_SUFFIX


def is_lo(name: str) -> bool:
    return name.endswith(LO_SUFFIX)


def wide_value_pairs(names) -> dict:
    """{base: base + '.lo'} for every wide value column pair (not the
    key's) among names."""
    s = set(names)
    return {nm: lo_of(nm) for nm in names
            if not is_lo(nm) and nm != KEY and lo_of(nm) in s}


def encode_i64(src: np.ndarray):
    """int64 column -> (hi int32, biased-lo int32), order-preserving."""
    a = src.astype(np.int64, copy=False)
    hi = (a >> 32).astype(np.int32)
    lo = ((a & np.int64(0xFFFFFFFF)).astype(np.uint32)
          ^ _LO_BIAS).view(np.int32)
    return hi, lo


def decode_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of encode_i64."""
    lo_u = (np.asarray(lo).view(np.uint32) ^ _LO_BIAS).astype(np.int64)
    return (np.asarray(hi).astype(np.int64) << 32) | lo_u


def decode_wide_cols(cols: dict) -> dict:
    """Reassemble every (name, name.lo) pair, key or value, into one int64
    column for host reads; other columns pass through, order kept."""
    if not any(is_lo(n) for n in cols):
        return cols
    return {name: (col if lo_of(name) not in cols
                   else decode_i64(col, cols[lo_of(name)]))
            for name, col in cols.items() if not is_lo(name)}


def _decode_dict_cols(cols: dict, dicts) -> dict:
    """Dictionary-encoded int32 code columns back to their strings, for
    host reads; other columns pass through, order kept. Runs after
    decode_wide_cols (a dictionary column never has a '.lo' word)."""
    if not dicts:
        return cols
    return {name: (dicts[name][np.asarray(col)] if name in dicts else col)
            for name, col in cols.items()}


@dataclasses.dataclass
class Block:
    cols: Dict[str, torch.Tensor]  # each [n_shards, capacity]
    counts: torch.Tensor  # int32[n_shards], valid rows per shard
    capacity: int  # per-shard row capacity (static)
    mesh: ShardMesh
    # Host copy of counts, cached: constructors that know the counts
    # (from_numpy, block_range, exchanges that fetched them with the
    # overflow flags) pass them in; otherwise the first counts_np fetches.
    counts_host: Optional[np.ndarray] = None
    # Blocks of deferred exchanges (dense_rdd's speculative launches) carry
    # a settle callable: it fetches every pending overflow flag in one
    # transfer and, on a failed speculation, repairs this block IN PLACE
    # (same object) from a clean rerun. Every host read settles first:
    # reading an unsettled block could observe capacity-truncated data.
    settle: Optional[Callable[[], None]] = None
    # Dictionaries of the string columns: {name -> sorted host numpy array},
    # the column holding int32 codes into it. Host metadata only, never on
    # the device; None when no column is dictionary-encoded.
    dicts: Optional[Dict[str, np.ndarray]] = None
    # Logical dtypes of the columns stored in 32 bits under another dtype
    # ({name -> torch dtype}, coltypes.py); host reads restore them. None
    # when no column is one.
    logical: Optional[Dict[str, torch.dtype]] = None

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def counts_np(self) -> np.ndarray:
        if self.settle is not None:
            self.settle()  # may replace cols/counts/capacity in place
        if self.counts_host is None:
            self.counts_host = self.counts.cpu().numpy().astype(np.int32)
        return self.counts_host

    @property
    def num_rows(self) -> int:
        return int(np.sum(self.counts_np))

    @property
    def nbytes(self) -> int:
        """Device bytes of the columns at full static capacity (padding
        rows occupy memory like any others; counts excluded): the
        lifetime LRU's accounting. Sizing before materialization, which
        has only row counts, is stream.planned_chunk_rows'."""
        return sum(c.numel() * c.element_size() for c in self.cols.values())

    def _host_cols(self) -> Dict[str, np.ndarray]:
        return {name: c.cpu().numpy() for name, c in self.cols.items()}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Valid rows of every column on the host, shard order preserved.
        counts_np settles first, so the columns read are the settled
        ones."""
        counts = self.counts_np
        host = self._host_cols()
        return self._decode({
            name: np.concatenate([col[s, :counts[s]]
                                  for s in range(self.n_shards)])
            for name, col in host.items()})

    def _decode(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Stored host columns as the user's: wide pairs reassembled,
        logical dtypes restored, strings decoded."""
        return _decode_dict_cols(coltypes.decode_cols(
            decode_wide_cols(cols), self.logical), self.dicts)

    def shard_rows(self, shard: int, limit: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Shard `shard`'s valid rows on the host (the first `limit` of
        them when given), wide keys reassembled, strings decoded."""
        c = int(self.counts_np[shard])
        if limit is not None:
            c = min(c, limit)
        return self._decode({name: col[shard, :c].cpu().numpy()
                             for name, col in self.cols.items()})


def _round_capacity(c: int) -> int:
    """Round per-shard capacity to a shape-stable bucket: the next power of
    two (>= 128) up to 1M rows, the next multiple of 1M above (the
    reference's block._round_capacity)."""
    c = max(c, 128)
    if c <= (1 << 20):
        return 1 << (c - 1).bit_length()
    step = 1 << 20
    return -(-c // step) * step


def _check_dtype(name: str, src: np.ndarray):
    """The 32-bit block dtype contract: (stored array, logical dtype or
    None). 64-bit inputs narrow, refusing loudly where narrowing would
    silently corrupt; int8 / int16 / uint8 / uint16 / uint32 / float16
    are stored in 32 bits under their logical dtype (coltypes.py); the
    key column must hold one value per row."""
    if name == KEY and src.ndim != 1:
        raise VegaError(
            f"the key column must be 1-D (one key per row), got shape "
            f"{src.shape}: a tuple key has no device form")
    if src.dtype.kind in "OUS":
        raise VegaError(
            f"column {name!r} has dtype {src.dtype} which has no device "
            "representation (a string column is dictionary-encoded "
            "first; an object column of anything but strings has none)")
    if src.dtype in (np.int64, np.uint64):
        info = np.iinfo(np.int32)
        if len(src) and (src.min() < info.min or src.max() > info.max):
            raise VegaError(
                f"column {name!r} has {src.dtype} values outside int32 "
                "range — values would silently collide")
        return src.astype(np.int32), None
    if src.dtype == np.float64:
        return src.astype(np.float32), None
    return coltypes.from_numpy(src)


def encode_key_columns(columns: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Split an int64 KEY beyond int32 into (KEY, KEY_LO), KEY_LO right
    after KEY; an in-range integer key keeps the narrow path
    (_check_dtype). Already-encoded columns pass through."""
    if KEY_LO in columns:
        if KEY not in columns or \
                np.asarray(columns[KEY_LO]).dtype != np.int32:
            raise VegaError(f"column name {KEY_LO!r} is reserved for the "
                            "low word of two-column int64 keys")
        return columns
    src = columns.get(KEY)
    if src is None:
        return columns
    src = np.asarray(src)
    if src.dtype not in (np.int64, np.uint64) or len(src) == 0:
        return columns
    if src.dtype == np.uint64 and src.max() > np.uint64(2**63 - 1):
        raise VegaError("uint64 keys beyond int64 range have no device "
                        "representation")
    info = np.iinfo(np.int32)
    if info.min <= src.min() and src.max() <= info.max:
        return columns  # fits int32; _check_dtype narrows it
    hi, lo = encode_i64(src)
    out: Dict[str, np.ndarray] = {}
    for name, col in columns.items():
        if name == KEY:
            out[KEY] = hi
            out[KEY_LO] = lo
        else:
            out[name] = col
    return out


def encode_value_columns(columns: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Split every int64 / uint64 value column beyond int32 into the wide
    (name, name.lo) pair, the low word right after its column; in-range
    integers keep the narrow path (_check_dtype). A pre-encoded '.lo'
    column passes through; uint64 beyond int64 raises."""
    out: Dict[str, np.ndarray] = {}
    for name, col in columns.items():
        src = np.asarray(col)
        if is_lo(name) or name == KEY or \
                src.dtype not in (np.int64, np.uint64) or len(src) == 0:
            out[name] = col
            continue
        if src.dtype == np.uint64 and src.max() > np.uint64(2**63 - 1):
            raise VegaError(f"uint64 column {name!r} beyond int64 range has "
                            "no device representation")
        info = np.iinfo(np.int32)
        if info.min <= src.min() and src.max() <= info.max:
            out[name] = col
            continue
        out[name], out[lo_of(name)] = encode_i64(src)
    return out


def from_numpy(columns: Dict[str, np.ndarray], mesh: ShardMesh,
               capacity: Optional[int] = None,
               dicts: Optional[Dict[str, np.ndarray]] = None,
               dict_enabled: bool = True) -> Block:
    """Row-shard host columns (equal lengths) over the mesh: shard s gets
    rows [s*per, (s+1)*per), per = ceil(n / n_shards), like the reference's
    from_numpy. String columns are dictionary-encoded first (dicts: the
    dictionaries of code columns a caller encoded already; dict_enabled
    False makes a string column raise), then int64 columns beyond int32,
    as there."""
    n_shards = mesh.n_shards
    columns, dicts = dict_encoding.encode_string_columns(
        dict(columns), dicts, enabled=dict_enabled)
    columns = encode_value_columns(encode_key_columns(columns))
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    per = -(-n // n_shards) if n else 0
    cap = _round_capacity(capacity or max(per, 1))
    counts = np.array([max(0, min(per, n - s * per)) for s in range(n_shards)],
                      dtype=np.int32)
    cols = {}
    logical = {}
    for name in names:
        src, dt = _check_dtype(name, np.asarray(columns[name]))
        if dt is not None:
            logical[name] = dt
        if len(src) != n:
            raise VegaError(f"column {name!r} has {len(src)} rows, "
                            f"expected {n}")
        dst = np.zeros((n_shards, cap) + src.shape[1:], dtype=src.dtype)
        for s in range(n_shards):
            c = counts[s]
            if c:
                dst[s, :c] = src[s * per:s * per + c]
        cols[name] = torch.from_numpy(dst).to(mesh.device)
    return Block(cols=cols, counts=torch.from_numpy(counts).to(mesh.device),
                 capacity=cap, mesh=mesh, counts_host=counts, dicts=dicts,
                 logical=logical or None)


def from_reference_arrays(cols: Dict[str, np.ndarray], counts: np.ndarray,
                          capacity: int, mesh: ShardMesh) -> Block:
    """Carry a vega_tpu Block's exported state across with identical
    placement: flat [n_shards * capacity] columns laid out as the reference
    lays them out (rows [s*capacity, s*capacity + counts[s]) are shard s's)
    plus the per-shard counts. Wide (name, name.lo) words carry across as
    they are."""
    for name in cols:
        if is_lo(name) and name[:-len(LO_SUFFIX)] not in cols:
            raise VegaError(f"column {name!r} needs its high word "
                            f"{name[:-len(LO_SUFFIX)]!r}")
    counts = np.asarray(counts, dtype=np.int32).reshape(-1)
    if counts.shape[0] != mesh.n_shards:
        raise VegaError(f"counts has {counts.shape[0]} shards, the mesh "
                        f"{mesh.n_shards}")
    if counts.size and (counts.min() < 0 or counts.max() > capacity):
        raise VegaError("counts must lie in [0, capacity]")
    out = {}
    logical = {}
    for name, col in cols.items():
        col, dt = _check_dtype(name, np.asarray(col))
        if dt is not None:
            logical[name] = dt
        if col.shape[0] != mesh.n_shards * capacity:
            raise VegaError(
                f"column {name!r} has {col.shape[0]} rows, expected "
                f"n_shards * capacity = {mesh.n_shards * capacity}")
        out[name] = torch.from_numpy(np.array(
            col.reshape((mesh.n_shards, capacity) + col.shape[1:]))
        ).to(mesh.device)
    return Block(cols=out, counts=torch.from_numpy(counts.copy()).to(
        mesh.device), capacity=capacity, mesh=mesh,
        counts_host=counts.copy(), logical=logical or None)


def block_range(n: int, mesh: ShardMesh, dtype=torch.int32,
                start: int = 0) -> Block:
    """Iota block built on the device: shard s holds
    [start + s*per, start + s*per + counts[s]) in its valid rows, and the
    iota continues through its padding rows, as in the reference (whose
    int32 shard base makes a narrow or unsigned integer dtype int32)."""
    n_shards = mesh.n_shards
    per = -(-n // n_shards)
    cap = _round_capacity(per)
    counts = np.array([max(0, min(per, n - s * per)) for s in range(n_shards)],
                      dtype=np.int32)
    dev = mesh.device
    vals = (start + torch.arange(n_shards, device=dev,
                                 dtype=torch.int64)[:, None] * per
            + torch.arange(cap, device=dev, dtype=torch.int64)[None, :])
    if coltypes.is_logical(dtype) and not dtype.is_floating_point:
        # the reference adds an iota of the dtype to an int32 shard base,
        # which promotes a narrow or unsigned integer iota to int32
        dtype = torch.int32
    # float16 is stored in float32 under its logical dtype (coltypes.py)
    return Block(cols={VALUE: coltypes.to_physical(vals, dtype)},
                 counts=torch.from_numpy(counts).to(dev), capacity=cap,
                 mesh=mesh, counts_host=counts,
                 logical={VALUE: dtype} if coltypes.is_logical(dtype)
                 else None)
