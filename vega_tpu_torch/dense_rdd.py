"""Dense lineage: RDD nodes whose partitions are shard rows of Blocks.

Counterpart of vega_tpu/tpu/dense_rdd.py. Sources (dense_range,
dense_from_numpy) and map feed the keyed nodes: reduce_by_key(op=), join,
group_by_key, sort_by_key and cogroup (two group_by_keys), the cartesian
product, and the actions count / collect / take / take_ordered / top.
Each node materializes once into a Block ([n_shards, capacity] columns on
one device). Narrow nodes (map) are not materialized in front of an
exchange: their chain is applied to the root block's columns inside the
exchange, once per materialization.

Every plan of the reference is ported; the Context resolves them
(context.py): dense_sort_impl (xla / packed / radix / radix4) for every
sort of an exchange, dense_rbk_plan (fused_sort: one (bucket, key) sort
feeds the map-side combine and a pregrouped exchange; sort_partition: a
key sort, the combine, then a counting partition by bucket) and
dense_table_plan (a warm reduce whose key range was observed small runs as
a dense per-key table, with no sort and no row exchange).

Exchanges run the reference's _run_exchange in both its forms. Blocking:
the counts, the extra outputs and the overflow flags come back in one
fetch, and an overflow retries at larger capacities, up to 6 rounds.
Deferred (a hinted or fixed-capacity launch, unless a repair is running):
the launch keeps its flags on the device and records a pending entry on
the Context; the next host read (Block.counts_np, to_numpy, shard_rows, or
DenseRDD.block()) settles every pending entry in one fetch and repairs a
failed speculation, and what depends on it, in place.

An int64 key beyond int32 is the two-column (KEY, KEY_LO) encoding:
group_by_key, sort_by_key, cogroup of two such sides, take and
take_ordered / top run on it; map, reduce_by_key, join and a cogroup
against a narrow side raise VegaError until a later slice ports them.
There is no host tier to fall back to: a row function that does not run
on column tensors raises VegaError, and so does every request the
reference would hand to its host tier.
"""

from __future__ import annotations

import hashlib
import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import kernels
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch.block import KEY, KEY_LO, VALUE, Block
from vega_tpu_torch.errors import VegaError

log = logging.getLogger(__name__)

Schema = Tuple[Tuple[str, torch.dtype], ...]

_HINT_STORE_MAX = 4096
_EXCHANGE_ROUNDS = 6
_SORT_SAMPLE = 4096  # sort_by_key's key samples, over all shards
# the cartesian gate on the CPU, which has no free-memory query as cheap as
# the card's: the reference's default dense_hbm_budget
CPU_CARTESIAN_BUDGET = 4 << 30


def _fp(f) -> str:
    """Structural fingerprint of a row function for capacity-hint keys:
    its code and constants plus the values its closure captured. Two
    functions that collide only share a capacity guess; the overflow retry
    keeps that safe."""
    code = getattr(f, "__code__", None)
    if code is None:
        return f"id:{id(f)}"
    cells = tuple(repr(c.cell_contents) for c in (f.__closure__ or ()))
    blob = repr((code.co_code, code.co_consts, code.co_names, cells))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class DenseRDD:
    """Base dense node. Subclasses implement _materialize() -> Block and
    _schema()."""

    def __init__(self, ctx, mesh, parents: Sequence["DenseRDD"] = ()):
        self.context = ctx
        self.mesh = mesh
        self._dense_parents = tuple(parents)
        self._block: Optional[Block] = None

    # --- device plane -------------------------------------------------------
    def block(self) -> Block:
        """This node's Block, materialized once and SETTLED: a pending
        deferred exchange is verified (and repaired on overflow) before the
        block is handed out."""
        blk = self.block_spec()
        if blk.settle is not None:
            blk.settle()
        return blk

    def block_spec(self) -> Block:
        """block() without settlement: the Block may still carry an
        unverified overflow flag. Only for exchange materializers, which
        register their own pending entry, so a failed speculation
        invalidates and repairs them too; everything else uses block()."""
        if self._block is None:
            self._block = self._materialize()
        return self._block

    def _materialize(self) -> Block:
        raise NotImplementedError

    def _schema(self) -> Schema:
        """(name, dtype) of the output columns, without materializing."""
        raise NotImplementedError

    def _fp_extra(self):
        return ()

    def _lineage_fp(self):
        """Structural identity of the lineage (node types and parameters,
        not node identities): a re-run of the same pipeline shares it."""
        memo = getattr(self, "_fp_memo", None)
        if memo is None:
            memo = (type(self).__name__, self._fp_extra()) + tuple(
                p._lineage_fp() for p in self._dense_parents)
            self._fp_memo = memo
        return memo

    def _counts_fp(self):
        """Leaf sources' counts: the input sizes under the lineage."""
        if not self._dense_parents:
            return self.block().counts_np.tobytes()
        return tuple(p._counts_fp() for p in self._dense_parents)

    def _hint_key(self, *extra):
        return (self._lineage_fp(), self._counts_fp(), extra)

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def is_pair(self) -> bool:
        return KEY in dict(self._schema())

    @property
    def wide_key(self) -> bool:
        """True when the key is the two-column int64 encoding."""
        return KEY_LO in dict(self._schema())

    def _refuse_wide(self, op: str) -> None:
        if self.wide_key:
            raise VegaError(
                f"{op} over a two-column int64 key comes with a later slice "
                "of vega_tpu_torch; only group_by_key, sort_by_key, cogroup "
                "of two int64-keyed sides, take and take_ordered / top run "
                "on it now")

    @property
    def hash_placed(self) -> bool:
        """True when every key's rows provably live only on shard
        hash(key) % n (the output of a hash exchange): a downstream keyed
        exchange over it is elided."""
        return False

    @property
    def key_sorted(self) -> bool:
        """True when each shard's valid rows are provably key-sorted."""
        return False

    def _settle_placement(self) -> None:
        """Make hash_placed/key_sorted answer for the materialized node."""

    # --- transformations ----------------------------------------------------
    def map(self, f: Callable) -> "DenseRDD":
        """Row map run on whole column tensors: f gets the row's columns
        (x, or (k, v) for a pair) as [n_shards, capacity] tensors and
        returns a value or a (key, value) pair of them."""
        self._refuse_wide("map")
        return _MapRDD(self, f)

    def reduce_by_key(self, func=None, *, op: Optional[str] = None):
        """Device shuffle: map-side combine, exchange, reduce-side merge.
        Only the named ops add/min/max/prod are ported."""
        if not self.is_pair:
            raise VegaError("reduce_by_key on non-pair DenseRDD")
        self._refuse_wide("reduce_by_key")
        if op is None:
            raise VegaError(
                "vega_tpu_torch reduces only with a named op "
                f"({', '.join(kernels.SEGMENT_OPS)}); traced reduce "
                f"functions ({func!r}) are not ported yet")
        if op not in kernels.SEGMENT_OPS:
            raise VegaError(f"unknown op {op!r}; expected one of "
                            f"{kernels.SEGMENT_OPS}")
        return _ReduceByKeyRDD(self, op)

    def join(self, other: "DenseRDD") -> "DenseRDD":
        """Device sort-merge inner join with full duplicate-key semantics:
        (k, (lv, rv)) rows."""
        if not (isinstance(other, DenseRDD) and self.is_pair
                and other.is_pair):
            raise VegaError("join needs two dense pair RDDs")
        if other.mesh != self.mesh:
            raise VegaError("join sides live on different meshes")
        self._refuse_wide("join")
        other._refuse_wide("join")
        for side in (self, other):
            if [nm for nm, _ in side._schema()] != [KEY, VALUE]:
                raise VegaError("join needs the canonical (k, v) layout on "
                                f"both sides, got {side._schema()}")
        lk, rk = dict(self._schema())[KEY], dict(other._schema())[KEY]
        if lk != rk:
            raise VegaError(f"join key dtypes differ ({lk} vs {rk}): equal "
                            "keys would hash apart")
        return _JoinRDD(self, other)

    def _check_keyed(self, op: str) -> None:
        if not self.is_pair:
            raise VegaError(f"{op} on non-pair DenseRDD")
        names = [nm for nm, _ in self._schema() if nm not in (KEY, KEY_LO)]
        if names != [VALUE]:
            raise VegaError(f"{op} needs the canonical (k, v) layout, got "
                            f"{self._schema()}")

    def group_by_key(self) -> "DenseRDD":
        """Device group_by_key: exchange by key hash, sort within each
        shard; collect() assembles (key, [values]) on the host and
        collect_grouped() returns the columnar form."""
        self._check_keyed("group_by_key")
        return _GroupByKeyRDD(self)

    def sort_by_key(self, ascending: bool = True) -> "DenseRDD":
        """Distributed sample sort: strided key samples fetched in one
        transfer give host range bounds, then a range exchange and a local
        sort."""
        if not self.is_pair:
            raise VegaError("sort_by_key on non-pair DenseRDD")
        return _SortByKeyRDD(self, ascending)

    def cogroup(self, other: "DenseRDD") -> "_DenseCoGroupRDD":
        """Dense-dense cogroup: both sides group by key on the device
        (equal keys hash to one shard); (k, ([lvs], [rvs])) assembly, or
        its columnar form, happens on the host."""
        if not isinstance(other, DenseRDD) or other.mesh != self.mesh:
            raise VegaError("cogroup needs two dense pair RDDs on one mesh")
        self._check_keyed("cogroup")
        other._check_keyed("cogroup")
        if self.wide_key != other.wide_key:
            raise VegaError(
                "cogroup of a two-column int64 key against an int32 key "
                "(the reference's _WidenKeyRDD) comes with a later slice of "
                "vega_tpu_torch")
        lk, rk = dict(self._schema())[KEY], dict(other._schema())[KEY]
        if lk != rk:
            raise VegaError(f"cogroup key dtypes differ ({lk} vs {rk}): "
                            "equal keys would hash apart")
        return _DenseCoGroupRDD(self, other)

    def cartesian(self, other: "DenseRDD") -> "DenseRDD":
        """Device cross product of two value RDDs as (left, right) pairs:
        the right side is replicated and each shard ragged-expands its
        left rows against it. A product whose estimated footprint passes
        the device's free memory raises VegaError (there is no host tier
        to stream it)."""
        if not (isinstance(other, DenseRDD) and other.mesh == self.mesh
                and [n for n, _ in self._schema()] == [VALUE]
                and [n for n, _ in other._schema()] == [VALUE]):
            raise VegaError("cartesian needs two dense value RDDs (one "
                            "column each) on one mesh")
        return _CartesianDenseRDD(self, other)

    # --- actions ------------------------------------------------------------
    def count(self) -> int:
        return self.block().num_rows

    def collect(self) -> list:
        cols = self.block().to_numpy()
        if KEY not in cols:
            return cols[VALUE].tolist()
        return list(zip(cols[KEY].tolist(), cols[VALUE].tolist()))

    def collect_arrays(self) -> Dict[str, np.ndarray]:
        """Columnar collect: no per-row Python objects."""
        return self.block().to_numpy()

    def take(self, n: int) -> list:
        """The first n rows in shard order, read shard by shard (only the
        rows still needed from each), never a full collect."""
        out: list = []
        blk = self.block()
        for s in range(blk.n_shards):
            rows = blk.shard_rows(s, limit=max(n - len(out), 0))
            if list(rows) == [VALUE]:
                out.extend(rows[VALUE].tolist())
            else:
                out.extend(zip(*[c.tolist() for c in rows.values()]))
            if len(out) >= n:
                break
        return out[:n]

    def take_ordered(self, n: int, key=None) -> list:
        """The n smallest elements: a per-shard top-k (values) or row sort
        (pairs, ordered like host tuples: key, then value), then a merge
        of the n_shards * n survivors on the host."""
        if key is not None:
            raise VegaError("take_ordered(key=...) needs the host tier, "
                            "which vega_tpu_torch does not have")
        if self.is_pair:
            return self._device_topk_rows(n, largest=False)
        return self._device_topk(n, largest=False)

    def top(self, n: int, key=None) -> list:
        """The n largest elements, as take_ordered orders them, reversed."""
        if key is not None:
            raise VegaError("top(key=...) needs the host tier, which "
                            "vega_tpu_torch does not have")
        if self.is_pair:
            return self._device_topk_rows(n, largest=True)
        return self._device_topk(n, largest=True)

    def _device_topk(self, n: int, largest: bool) -> list:
        blk = self.block()
        k = min(n, blk.capacity)
        best = kernels.topk_values(blk.cols[VALUE], blk.counts, k,
                                   largest).cpu().numpy()
        n_valid = np.minimum(blk.counts_np, k)
        candidates = np.sort(np.concatenate(
            [best[s, :n_valid[s]] for s in range(blk.n_shards)]))
        if largest:
            candidates = candidates[::-1]
        return candidates[:n].tolist()

    def _device_topk_rows(self, n: int, largest: bool) -> list:
        """First / last n rows in the order of the tuples collect() emits:
        per shard, one stable row sort over (validity, every column in
        schema order; a wide key's (KEY, KEY_LO) words sit adjacent, so
        schema order is int64 order), the first n taken; the host merges
        the survivors with the same lexicographic order. As on the host,
        the result is well-defined only for NaN-free data."""
        blk = self.block()
        schema = self._schema()
        names = [nm for nm, _ in schema]
        k = min(max(n, 1), blk.capacity)
        impl = self.context.dense_sort_impl
        use_words = impl in ("radix", "radix4", "packed") and all(
            dt in (torch.int32, torch.float32) for _, dt in schema)
        cols = [blk.cols[nm] for nm in names]
        order = kernels.row_sort_perm(cols, blk.counts, largest,
                                      impl if use_words else "xla")[:, :k]
        per_col = [torch.gather(c, 1, order).cpu().numpy() for c in cols]
        n_valid = np.minimum(blk.counts_np, k)
        keep = [s for s in range(blk.n_shards) if n_valid[s]]
        if not keep:
            return []
        merged = block_lib._decode_key_cols(
            {nm: np.concatenate([col[s, :n_valid[s]] for s in keep])
             for nm, col in zip(names, per_col)})
        order_cols = list(merged.values())
        # np.lexsort: the last key is primary; stable like the device sort
        order_host = np.lexsort([c if not largest else
                                 (-c if np.issubdtype(c.dtype, np.floating)
                                  else ~c)
                                 for c in reversed(order_cols)])
        return [tuple(c[i].item() for c in order_cols)
                for i in order_host[:n]]


class _SourceRDD(DenseRDD):
    def __init__(self, ctx, blk: Block):
        super().__init__(ctx, blk.mesh)
        self._block = blk

    def _materialize(self) -> Block:
        return self._block

    def _schema(self):
        return tuple((n, c.dtype) for n, c in self._block.cols.items())

    def _fp_extra(self):
        return (tuple((n, str(c.dtype)) for n, c in self._block.cols.items()),
                self._block.capacity)


def dense_range(ctx, n: int, dtype=torch.int32) -> DenseRDD:
    """Iota source built on the device (int32 by default)."""
    return _SourceRDD(ctx, block_lib.block_range(n, ctx.mesh, dtype))


def dense_from_numpy(ctx, columns) -> DenseRDD:
    """columns: one array (values) or two arrays (keys, values)."""
    if len(columns) == 1:
        cols = {VALUE: np.asarray(columns[0])}
    elif len(columns) == 2:
        cols = {KEY: np.asarray(columns[0]), VALUE: np.asarray(columns[1])}
    else:
        raise VegaError("dense_from_numpy takes (values) or (keys, values); "
                        "named multi-column sources are not ported yet")
    return _SourceRDD(ctx, block_lib.from_numpy(cols, ctx.mesh))


def dense_from_block(ctx, blk: Block) -> DenseRDD:
    """Source over an existing Block (e.g. one from_reference_arrays
    carried across from vega_tpu)."""
    return _SourceRDD(ctx, blk)


# ---------------------------------------------------------------------------
# narrow nodes
# ---------------------------------------------------------------------------


def _cols_to_row(cols, schema):
    if KEY in dict(schema):
        return (cols[KEY], cols[VALUE])
    return cols[VALUE]


def _trace_row_fn(f, schema, mesh):
    """Run f once on tiny column tensors of the schema to learn its output
    structure; returns (out_schema, cols_fn), where cols_fn maps a column
    dict to a column dict. A function that does not run on tensors, or
    returns anything but a tensor or a pair of tensors, raises VegaError
    (there is no host tier to fall back to)."""
    probe = {n: torch.zeros((mesh.n_shards, 1), dtype=dt, device=mesh.device)
             for n, dt in schema}
    try:
        out = f(_cols_to_row(probe, schema))
    except Exception as e:  # noqa: BLE001 — any failure means "not ported"
        raise VegaError(
            f"row function {f!r} does not run on column tensors ({e}); "
            "vega_tpu_torch has no host tier to fall back to") from e

    def as_col(x, what):
        if not isinstance(x, torch.Tensor):
            raise VegaError(f"row function {what} must be a tensor computed "
                            f"from the row, got {type(x).__name__}")
        if x.shape != (mesh.n_shards, 1):
            raise VegaError(f"row function {what} must be one scalar per "
                            f"row, got shape {tuple(x.shape)} for one row "
                            "per shard")
        return x

    if isinstance(out, tuple) and len(out) == 2:
        k, v = as_col(out[0], "key"), as_col(out[1], "value")
        out_schema = ((KEY, k.dtype), (VALUE, v.dtype))

        def cols_fn(cols):
            k, v = f(_cols_to_row(cols, schema))
            return {KEY: k, VALUE: v}
    else:
        v = as_col(out, "output")
        out_schema = ((VALUE, v.dtype),)

        def cols_fn(cols):
            return {VALUE: f(_cols_to_row(cols, schema))}

    for name, dt in out_schema:
        if dt not in (torch.int32, torch.float32):
            raise VegaError(
                f"row function output {name!r} has dtype {dt}; the block "
                "dtype contract is 32-bit (int32/float32)")
    return out_schema, cols_fn


class _NarrowRDD(DenseRDD):
    """A narrow op: shard-local (cols, count) -> (cols, count)."""

    def __init__(self, parent: DenseRDD, out_schema):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._out_schema = tuple(out_schema)

    def _schema(self):
        return self._out_schema

    def _shard_fn(self, cols, count):
        raise NotImplementedError

    def _materialize(self) -> Block:
        chain, root = _narrow_chain(self)
        blk = root.block()
        cols, count = _apply_chain(chain, dict(blk.cols), blk.counts)
        return Block(cols=cols, counts=count, capacity=blk.capacity,
                     mesh=self.mesh, counts_host=blk.counts_host)


class _MapRDD(_NarrowRDD):
    def __init__(self, parent: DenseRDD, f):
        out_schema, cols_fn = _trace_row_fn(f, parent._schema(), parent.mesh)
        super().__init__(parent, out_schema)
        self._cols_fn = cols_fn
        self._user_fn = f

    def _fp_extra(self):
        return (_fp(self._user_fn),)

    def _shard_fn(self, cols, count):
        out = self._cols_fn(cols)
        return {n: c.contiguous() for n, c in out.items()}, count


def _narrow_chain(node):
    """(chain, root): the longest not-yet-materialized narrow run ending at
    `node` (possibly empty) and the nearest materialization point above
    it. Exchanges apply the chain to the root's columns themselves instead
    of materializing an intermediate block."""
    chain: List[_NarrowRDD] = []
    cur = node
    while isinstance(cur, _NarrowRDD) and cur._block is None:
        chain.append(cur)
        cur = cur.parent
    chain.reverse()
    return chain, cur


def _apply_chain(chain, cols, count):
    for nd in chain:
        cols, count = nd._shard_fn(cols, count)
    return cols, count


def _chain_source(chain, blk: Block):
    """A callable giving (cols, count): the root block's columns with the
    narrow chain applied, computed at the first call and reused by every
    later one (the sizing histograms and each build round). An exchange
    reads its root unsettled (block_spec); its blocking path settles the
    backlog first, where a repair may replace the root's columns in place,
    so the first call must come at launch, never before."""
    memo = []

    def source():
        if not memo:
            memo.append(_apply_chain(chain, dict(blk.cols), blk.counts))
        return memo[0]
    return source


# ---------------------------------------------------------------------------
# exchange nodes
# ---------------------------------------------------------------------------


def _cap_round(c: int) -> int:
    return block_lib._round_capacity(c)


def _exchange_capacities(counts: np.ndarray, n_shards: int,
                         attempt: int) -> Tuple[int, int]:
    """Heuristic slot/out capacities with growth on retry."""
    max_count = int(counts.max()) if counts.size else 1
    total = int(counts.sum())
    grow = 2 ** attempt
    slot = min(
        _cap_round(max_count),
        _cap_round((math.ceil(max_count / max(n_shards, 1)) * 2 + 64) * grow),
    )
    out = min(
        _cap_round(total),
        _cap_round((math.ceil(total / max(n_shards, 1)) * 2 + 64) * grow),
    )
    return slot, out


def _histogram_capacities(hists: List[np.ndarray], attempt: int,
                          slot_hists: Optional[List[np.ndarray]] = None
                          ) -> Tuple[int, int]:
    """Exact slot/out capacities from [n_shards, n_shards] destination
    histograms (hist[s, t] = rows shard s sends to target t): slot holds the
    largest cell, out the largest per-target column sum. slot_hists, when
    given, restricts slot sizing to the sides that send."""
    grow = 2 ** attempt
    src = hists if slot_hists is None else slot_hists
    slot = max((int(h.max()) for h in src), default=1)
    out = max(int(h.sum(axis=0).max()) for h in hists)
    return _cap_round(max(slot, 1) * grow), _cap_round(max(out, 1) * grow)


def _bucket_cols(cols, n: int) -> torch.Tensor:
    """Hash-bucket each row by its key: an int32 / float32 key through the
    hash_bucket kernel; a two-column int64 key by hash32_pair of both
    words (torch ops, as the reference computes it outside its kernel),
    so equal int64 keys, and only those, share a bucket."""
    if KEY_LO in cols:
        return (kernels.hash32_pair(cols[KEY], cols[KEY_LO]) % n).to(
            torch.int32)
    key = cols[KEY]
    if key.dtype == torch.float32:
        key = key.view(torch.int32)
    if key.dtype != torch.int32:
        raise VegaError(f"keys must be int32 or float32, got {key.dtype}")
    return cuda_kernels.hash_bucket(key.contiguous(), n)


def _elide_out_cap(blk: Block) -> int:
    """Output capacity of an elided exchange: rows stay put, so the largest
    shard count bounds it when host-known, else the parent's capacity."""
    if blk.counts_host is not None and blk.counts_host.size:
        return block_lib._round_capacity(max(int(blk.counts_host.max()), 1))
    return blk.capacity


def _head(count: torch.Tensor, extras, overflow: torch.Tensor
          ) -> torch.Tensor:
    """One flat int64 device tensor of what a host read needs from a
    launch: [count | extras... | overflow], n_shards entries each, so the
    lot comes back in one transfer."""
    return torch.cat([count.to(torch.int64)]
                     + [e.to(torch.int64) for e in extras]
                     + [overflow.to(torch.int64)])


def _remember(store: dict, key, value) -> None:
    """Insert with refreshed recency (pop, then insert at the young end)
    and bound the store, dropping its oldest entries."""
    store.pop(key, None)
    store[key] = value
    while len(store) > _HINT_STORE_MAX:
        store.pop(next(iter(store)))


def _settle_pending(ctx) -> None:
    """Verify every deferred exchange of the Context in ONE device fetch;
    repair failures in place (the reference's _settle_pending).

    Per entry, in launch order: commit (write counts_host, refresh the
    capacity hint, run on_success) when its flags are clean, its validator
    agrees and no failed entry lies in its lineage; otherwise it fails.
    Every failed entry's node is invalidated and rebuilt under _no_defer
    (the blocking, histogram-sized path), and the clean result is copied
    into the SAME Block object, so every reference a caller holds sees the
    repair. If settlement dies part-way (a validator's hard error), every
    entry not yet committed goes back on the backlog, in order."""
    pend = ctx._pending
    if not pend:
        return
    entries = list(pend)
    pend.clear()  # repairs below re-enter _run_exchange -> _settle_pending
    hint_store = ctx._capacity_hints

    def depends_on(rdd, failed_rdds) -> bool:
        seen, stack = set(), [rdd]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if id(node) in failed_rdds:
                return True
            stack.extend(node._dense_parents)
        return False

    failed: List[dict] = []
    failed_rdds: set = set()
    i = 0
    try:
        fetched = torch.cat([e["head"] for e in entries]).cpu().numpy()
        offset = 0
        for i, e in enumerate(entries):
            n = e["rdd"].n_shards
            rows = 2 + e["n_extra"]
            parts = fetched[offset:offset + rows * n].reshape(rows, n)
            offset += rows * n
            head, overflow = list(parts[:-1]), parts[-1]
            if not (failed_rdds and depends_on(e["rdd"], failed_rdds)):
                ok = not overflow.any()
                validator_said_no = False
                if ok and e["validate"] is not None:
                    ok = e["validate"](head)  # may raise (join product)
                    validator_said_no = not ok
                if ok:
                    # clean flags and no failed ancestor: commit, even after
                    # an unrelated entry failed
                    blk = e["block"]
                    blk.counts_host = head[0].astype(np.int32)
                    blk.settle = None
                    if e["hint_key"] is not None:
                        _remember(hint_store, e["hint_key"], e["caps"])
                    if e["on_success"] is not None:
                        e["on_success"](head)
                    continue
                # an overflow means the hinted capacities were wrong: drop
                # the hint so the repair sizes from histograms (a validator
                # failure keeps it: the validator stashed its own fix)
                if e["hint_key"] is not None and not validator_said_no:
                    hint_store.pop(e["hint_key"], None)
            failed.append(e)
            failed_rdds.add(id(e["rdd"]))
    except BaseException:
        # every entry not committed goes back, failed ones included:
        # re-processing is idempotent, a stranded entry would serve
        # truncated data
        pend[:0] = failed + entries[i:]
        raise
    if not failed:
        return
    log.info("deferred exchange failed (%d of %d entries); repairing",
             len(failed), len(entries))
    for e in failed:
        e["rdd"]._block = None
        # until repaired, reads through held references fail loudly
        e["block"].settle = _unrepaired_raise
    ctx._no_defer = True
    try:
        for e in failed:
            rdd, old = e["rdd"], e["block"]
            fresh = rdd.block()  # blocking path: sized, fetched, verified
            old.cols = fresh.cols
            old.counts = fresh.counts
            old.capacity = fresh.capacity
            old.counts_host = fresh.counts_np
            old.settle = None
            rdd._block = old  # keep the object identity callers hold
    finally:
        ctx._no_defer = False


def _unrepaired_raise():
    raise VegaError(
        "deferred block was invalidated by an exchange overflow and its "
        "repair did not complete; re-run the pipeline")


class _ExchangeRDD(DenseRDD):
    """Common exchange loop: run the exchange, check the overflow flags,
    retry with grown capacities; or launch deferred and settle later."""

    _last_counts_host: Optional[np.ndarray] = None
    _last_extra_host: Optional[List[np.ndarray]] = None
    _last_attempts = 0
    _deferred_entry: Optional[dict] = None

    def _attach_pending(self, blk: Block) -> Block:
        """Register the deferred entry _run_exchange left behind (if any)
        against the just-built Block; returns blk either way."""
        entry, self._deferred_entry = self._deferred_entry, None
        if entry is None:
            return blk
        entry["block"] = blk
        ctx = self.context
        ctx._pending.append(entry)
        blk.settle = lambda: _settle_pending(ctx)
        return blk

    def _dest_histogram(self, bucket: torch.Tensor,
                        count: torch.Tensor) -> np.ndarray:
        """hist[s, t] = valid rows shard s will send to target t, fetched
        as one tiny [n, n] array; buys exactly-sized exchange
        capacities."""
        n = self.n_shards
        bucket = torch.where(kernels.valid_mask(bucket.shape[1], count),
                             bucket, n)
        return cuda_kernels.bucket_hist(bucket, n + 1)[:, :n].cpu().numpy()

    def _hash_histogram(self, cols, count) -> Optional[np.ndarray]:
        """The destination histogram under hash bucketing."""
        if self.n_shards == 1:
            return None
        return self._dest_histogram(_bucket_cols(cols, self.n_shards), count)

    def _range_histogram(self, cols, count, bounds, ascending: bool,
                         bounds_lo=None) -> Optional[np.ndarray]:
        """The destination histogram under range partitioning (sort_by_key),
        through the exchange's own range_bucket."""
        if self.n_shards == 1:
            return None
        return self._dest_histogram(kernels.range_bucket(
            bounds, cols[KEY], ascending, bounds_lo=bounds_lo,
            keys_lo=cols.get(KEY_LO)), count)

    def _run_exchange(self, build, counts, make_hists=None, hint_key=None,
                      fixed_caps=None, validate=None, on_success=None):
        """Run `build(slot, out_cap) -> ((count, extras, cols), overflow)`
        with capacity sizing: `fixed_caps` (elided passthroughs, the table
        plan), else a capacity hint remembered for this lineage and input
        sizes, else exact histograms from make_hists(), else the heuristic
        growth on `counts()`. Returns (count, extras, cols, out_cap).

        Deferred (fixed or hinted caps, unless a repair is running): one
        launch without a fetch; the flags stay on the device in a pending
        entry that _attach_pending registers and the next host read
        settles, where `validate(head)` (a False sends the entry to repair)
        and `on_success(head)` run. Blocking: settle the backlog first
        (sizing must not trust truncated blocks), then each round fetches
        counts, extras and overflow flags in one transfer; an overflow
        retries, at most 6 rounds."""
        n = self.n_shards
        ctx = self.context
        hint_store = ctx._capacity_hints
        hinted = hint_key is not None and hint_key in hint_store
        if (fixed_caps is not None or hinted) and not ctx._no_defer:
            slot, out_cap = (fixed_caps if fixed_caps is not None
                             else hint_store[hint_key])
            (count, extras, cols), overflow = build(slot, out_cap)
            self._last_attempts = 1
            self._last_counts_host = None
            self._last_extra_host = None
            self._deferred_entry = dict(
                rdd=self, head=_head(count, extras, overflow),
                n_extra=len(extras),
                hint_key=None if fixed_caps is not None else hint_key,
                caps=(slot, out_cap), validate=validate,
                on_success=on_success)
            return count, extras, cols, out_cap
        _settle_pending(ctx)
        hist_pair = None
        attempt = 0
        for round_i in range(_EXCHANGE_ROUNDS):
            if fixed_caps is not None and round_i == 0:
                slot, out_cap = fixed_caps
            elif hinted and round_i == 0:
                slot, out_cap = hint_store[hint_key]
            else:
                if hist_pair is None:
                    hist_pair = make_hists() if make_hists else ([], None)
                hs = [h for h in hist_pair[0] if h is not None]
                if hs:
                    slot, out_cap = _histogram_capacities(hs, attempt,
                                                          hist_pair[1])
                else:
                    slot, out_cap = _exchange_capacities(counts(), n, attempt)
                attempt += 1
            (count, extras, cols), overflow = build(slot, out_cap)
            self._last_attempts = round_i + 1
            parts = _head(count, extras, overflow).cpu().numpy().reshape(
                2 + len(extras), n)
            if not parts[-1].any():
                self._last_counts_host = parts[0].astype(np.int32)
                self._last_extra_host = list(parts[1:-1])
                if hint_key is not None:
                    _remember(hint_store, hint_key, (slot, out_cap))
                return count, extras, cols, out_cap
            log.info("exchange overflow (slot=%d out=%d), retrying", slot,
                     out_cap)
        raise VegaError(
            "exchange capacity overflow after retries — key skew exceeds "
            "capacity growth; repartition the data")


class _ReduceByKeyRDD(_ExchangeRDD):
    """reduce_by_key with a named op under the Context's plans.
    fused_sort: one stable (bucket, key) sort feeds the presorted map-side
    combine and a pregrouped exchange. sort_partition: a key-only sort, the
    presorted combine, then a stable counting partition by bucket and a
    pregrouped exchange. The reduce side sorts and merges. A hash-placed
    parent elides the exchange. With the table plan on, a warm run whose
    key range was observed small reduces through a dense table instead."""

    _table_plan = False  # whether the last materialization took the table

    def __init__(self, parent: DenseRDD, op: str):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._op = op

    @property
    def hash_placed(self) -> bool:
        return self._block is not None

    @property
    def key_sorted(self) -> bool:
        return self._block is not None

    def _settle_placement(self) -> None:
        self.block_spec()

    def _schema(self):
        return self.parent._schema()

    def _fp_extra(self):
        return (self._op,)

    def _bank_range(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Remember the observed key range of this lineage and input sizes
        (per-shard minima and maxima; empty shards report INT32_MAX /
        INT32_MIN and fall out of the global min / max)."""
        kmin, kmax = int(lo.min()), int(hi.max())
        if kmin <= kmax:
            _remember(self.context._key_range_hints, self._hint_key(),
                      (kmin, kmax))

    def _table_range(self, capacity: int) -> Optional[Tuple[int, int]]:
        """(kmin, spread) of the table from the remembered key range, or
        None: kmin aligned down to 4096 and the spread rounded to a
        capacity bucket (a wider table is sound: extra slots end with no
        rows and emit nothing), capped at min(2^22, 2 * capacity * n)."""
        rng = self.context._key_range_hints.get(self._hint_key())
        if rng is None:
            return None
        kmin = (int(rng[0]) >> 12) << 12  # floor, sign-safe
        spread = block_lib._round_capacity(int(rng[1]) - kmin + 1)
        if 0 < spread <= min(1 << 22, 2 * capacity * self.n_shards) \
                and kmin + spread - 1 <= kernels.INT32_MAX:
            return kmin, spread
        return None

    def _materialize(self) -> Block:
        n = self.n_shards
        op = self._op
        ctx = self.context
        sort_impl = ctx.dense_sort_impl
        plan = ctx.dense_rbk_plan
        self.parent._settle_placement()
        elide = self.parent.hash_placed and n > 1
        elide_sorted = elide and self.parent.key_sorted
        chain, root = (_narrow_chain(self.parent) if n > 1 and not elide
                       else ([], self.parent))
        blk = root.block_spec()  # we register our own pending entry
        source = _chain_source(chain, blk)
        schema = self.parent._schema()
        names = [nm for nm, _ in schema]
        # The table plan, and the key-range learning that arms it: named
        # add/min/max over one 32-bit value column with an int32 key.
        vnames = [nm for nm in names if nm != KEY]
        learn_range = (
            ctx.dense_table_plan == "on" and op in ("add", "min", "max")
            and len(vnames) == 1 and dict(schema)[KEY] == torch.int32
            and dict(schema)[vnames[0]] in (torch.int32, torch.float32))
        table = (self._table_range(blk.capacity)
                 if learn_range and not elide else None)
        # _no_defer is checked right before the launch: under a repair the
        # table plan is off, and a bad range repairs through the standard
        # plan below
        if table is not None and not ctx._no_defer:
            self._table_plan = True
            return self._run_table_plan(source, vnames[0], *table)
        self._table_plan = False

        def build(slot, out_cap):
            cols, count = source()
            cols = dict(cols)
            if n > 1 and not elide and plan == "sort_partition":
                # key-only sort -> presorted map-side combine -> counting
                # partition of the (often much smaller) combined rows;
                # equal keys share a bucket, so combining across bucket
                # boundaries is safe
                cols = kernels.sort_by_column(cols, count, KEY,
                                              impl=sort_impl)
                cols, count = kernels.segment_reduce_named(
                    cols, count, KEY, op, presorted=True)
                capacity = cols[KEY].shape[1]
                bucket = torch.where(kernels.valid_mask(capacity, count),
                                     _bucket_cols(cols, n), n)
                cols, bucket = kernels.partition_by_bucket(
                    cols, bucket, n, sort_impl=sort_impl)
                cols, count, overflow = kernels.bucket_exchange(
                    cols, count, bucket, n, slot, out_cap, pregrouped=True)
            elif n > 1 and not elide:
                capacity = cols[KEY].shape[1]
                mask = kernels.valid_mask(capacity, count)
                bucket = torch.where(mask, _bucket_cols(cols, n), n)
                cols, bucket = kernels.bucket_key_sort(
                    cols, count, bucket, KEY, impl=sort_impl, n_shards=n)
                # map-side combine over the (bucket, key)-sorted rows
                cols, count = kernels.segment_reduce_named(
                    cols, count, KEY, op, presorted=True)
                # compact kept (bucket, key) order; re-derive the combined
                # rows' buckets from their keys
                bucket = _bucket_cols(cols, n)
                cols, count, overflow = kernels.bucket_exchange(
                    cols, count, bucket, n, slot, out_cap, pregrouped=True)
            elif not elide:
                bucket = torch.zeros_like(cols[KEY], dtype=torch.int32)
                cols, count, overflow = kernels.bucket_exchange(
                    cols, count, bucket, n, slot, out_cap,
                    sort_impl=sort_impl)
            else:
                cols, count, overflow = kernels.passthrough_exchange(
                    cols, count, cols[KEY].shape[1], out_cap)
            # reduce-side merge
            cols, count = kernels.segment_reduce_named(
                cols, count, KEY, op, presorted=elide_sorted,
                sort_impl=sort_impl)
            extras = []
            if learn_range:
                # the output's key range rides the counts fetch: it arms
                # the table plan for the next warm run
                keys = cols[KEY]
                mask = kernels.valid_mask(keys.shape[1], count)
                extras = [torch.where(mask, keys, kernels.INT32_MAX).amin(1),
                          torch.where(mask, keys, kernels.INT32_MIN).amax(1)]
            return (count, extras, {nm: cols[nm] for nm in names}), overflow

        # deferred launches bank the range when they commit
        on_success = ((lambda head: self._bank_range(head[-2], head[-1]))
                      if learn_range else None)
        if elide:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                fixed_caps=(0, _elide_out_cap(blk)), on_success=on_success)
        else:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                make_hists=lambda: (
                    [self._hash_histogram(*source())], None),
                hint_key=self._hint_key(), on_success=on_success)
        if learn_range and self._last_extra_host is not None:
            self._bank_range(*self._last_extra_host[-2:])  # blocking path
        return self._attach_pending(Block(
            cols=cols, counts=count, capacity=out_cap, mesh=self.mesh,
            counts_host=self._last_counts_host))

    def _run_table_plan(self, source, vname: str, kmin: int,
                        spread: int) -> Block:
        """The reduce as a dense table over keys [kmin, kmin + spread):
        each shard scatters its rows into its own [spread] table, the
        tables reduce over the shard dimension (the reference's
        collective), and each shard keeps the keys it owns
        (hash_bucket(key) == s, count > 0) through compact. No sort, no
        row exchange; the output is hash-placed and key-sorted.

        Always a deferred fixed-capacity launch: a valid key outside the
        range (checked on the raw key values, never by a subtraction that
        could wrap) or an output overflow sets the shard's flag, and
        settlement repairs through the standard plan."""
        n = self.n_shards
        op = self._op
        out_cap = block_lib._round_capacity(
            min(spread, int(spread / max(n, 1) * 1.3) + 128))

        def build(slot, out_cap_):
            src_cols, src_count = source()
            keys, vals = src_cols[KEY], src_cols[vname]
            dev = keys.device
            valid = kernels.valid_mask(keys.shape[1], src_count)
            in_range = (keys >= kmin) & (keys <= kmin + spread - 1)
            bad = (valid & ~in_range).any(dim=1)
            # dropped rows land in slot `spread` of their shard's table
            idx = torch.where(valid & in_range, keys.to(torch.int64) - kmin,
                              spread)
            flat = (idx + torch.arange(n, device=dev)[:, None]
                    * (spread + 1)).reshape(-1)
            size = n * (spread + 1)
            if op == "add":
                tbl = vals.new_zeros(size).index_add_(0, flat,
                                                      vals.reshape(-1))
                tbl = tbl.view(n, spread + 1)[:, :spread].sum(
                    dim=0, dtype=vals.dtype)
            else:
                # the identity of the op fills keys a shard does not hold
                # and the reduction over shards is the op itself
                if vals.dtype.is_floating_point:
                    init = float("inf") if op == "min" else float("-inf")
                else:
                    init = kernels.INT32_MAX if op == "min" \
                        else kernels.INT32_MIN
                tbl = vals.new_full((size,), init).scatter_reduce_(
                    0, flat, vals.reshape(-1), "amin" if op == "min"
                    else "amax")
                tbl = tbl.view(n, spread + 1)[:, :spread]
                tbl = tbl.amin(dim=0) if op == "min" else tbl.amax(dim=0)
            cnt = torch.zeros(size, dtype=torch.int32, device=dev)
            cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
            cnt = cnt.view(n, spread + 1)[:, :spread].sum(dim=0)
            table_keys = (kmin + torch.arange(spread, device=dev)).to(
                torch.int32)
            owner = _bucket_cols({KEY: table_keys[None, :]}, n)
            mine = (owner == torch.arange(n, device=dev)[:, None]) \
                & (cnt > 0)[None, :]  # absent keys emit no row
            out, count = kernels.compact(
                {KEY: table_keys.expand(n, spread),
                 vname: tbl.expand(n, spread)}, mine, out_cap_)
            return (count, [], out), bad | (count > out_cap_)

        count, _, cols, _ = self._run_exchange(
            build, None, fixed_caps=(0, out_cap))
        return self._attach_pending(Block(
            cols=cols, counts=count, capacity=out_cap, mesh=self.mesh,
            counts_host=self._last_counts_host))


class _JoinRDD(_ExchangeRDD):
    """Device sort-merge inner join with full duplicate-key semantics. A
    hash-placed side (a reduce output) skips its exchange; a product
    beyond the exchange-sized capacity reruns once at its exact size."""

    def __init__(self, left: DenseRDD, right: DenseRDD):
        super().__init__(left.context, left.mesh, [left, right])
        self.left = left
        self.right = right

    @property
    def hash_placed(self) -> bool:
        return True  # joined rows stay on their key's shard

    @property
    def key_sorted(self) -> bool:
        return True  # output follows the left sort order

    def _schema(self):
        ls, rs = dict(self.left._schema()), dict(self.right._schema())
        return ((KEY, ls[KEY]), ("lv", ls[VALUE]), ("rv", rs[VALUE]))

    def _materialize(self) -> Block:
        n = self.n_shards
        sort_impl = self.context.dense_sort_impl
        self.left._settle_placement()
        self.right._settle_placement()
        l_elide = self.left.hash_placed and n > 1
        r_elide = self.right.hash_placed and n > 1
        l_sorted = l_elide and self.left.key_sorted
        r_sorted = r_elide and self.right.key_sorted

        def side_input(node, elide):
            chain, root = (_narrow_chain(node) if n > 1 and not elide
                           else ([], node))
            blk = root.block_spec()  # we register our own pending entry
            return blk, _chain_source(chain, blk)

        lblk, lsource = side_input(self.left, l_elide)
        rblk, rsource = side_input(self.right, r_elide)
        join_cap_override: List[Optional[int]] = [None]
        join_cap_used = [0]

        def one_side(source, elide, slot, out_cap):
            cols, count = source()
            cols = dict(cols)
            if elide:
                return kernels.passthrough_exchange(
                    cols, count, cols[KEY].shape[1], out_cap)
            bucket = (_bucket_cols(cols, n) if n > 1
                      else torch.zeros_like(cols[KEY], dtype=torch.int32))
            return kernels.bucket_exchange(cols, count, bucket, n, slot,
                                           out_cap, sort_impl=sort_impl)

        def build(slot, out_cap):
            join_cap = join_cap_override[0] or out_cap
            join_cap_used[0] = join_cap
            lc, lcount, lof = one_side(lsource, l_elide, slot, out_cap)
            rc, rcount, rof = one_side(rsource, r_elide, slot, out_cap)
            joined, jcount, jtotal = kernels.merge_join_expand(
                lc, lcount, rc, rcount, KEY, join_cap,
                left_sorted=l_sorted, right_sorted=r_sorted,
                sort_impl=sort_impl)
            cols = {KEY: joined[KEY], "lv": joined[VALUE],
                    "rv": joined[f"r_{VALUE}"]}
            return (jcount, [jtotal], cols), lof | rof

        counts_fn = lambda: np.concatenate([lblk.counts_np, rblk.counts_np])

        def make_hists():
            # blocking path only (after settlement), so counts_np is free
            hs = [np.diag(lblk.counts_np) if l_elide
                  else self._hash_histogram(*lsource()),
                  np.diag(rblk.counts_np) if r_elide
                  else self._hash_histogram(*rsource())]
            # elided (diagonal) sides never send: keep them out of slots
            return hs, [h for h, el in zip(hs, (l_elide, r_elide)) if not el]

        hint = self._hint_key()
        hint_store = self.context._capacity_hints
        jc_key = (hint, "join_cap")
        if jc_key in hint_store:
            join_cap_override[0] = hint_store[jc_key]

        def validate(head) -> bool:
            """The product-size policy of both paths: raise past 2^31 rows
            on a shard; a product beyond the capacity used stashes its
            exact capacity for the rerun and fails."""
            jtot = int(head[1].max(initial=0))
            if jtot >= kernels.INT32_MAX:
                raise VegaError(
                    "dense join product exceeds 2^31 rows on one shard — "
                    "cannot materialize; filter or pre-aggregate the heavy "
                    "keys")
            if jtot > join_cap_used[0]:
                hint_store[jc_key] = _cap_round(jtot)
                return False
            return True

        def on_success(_head):
            if join_cap_override[0]:
                _remember(hint_store, jc_key, join_cap_override[0])

        def run():
            return self._run_exchange(build, counts_fn, make_hists=make_hists,
                                      hint_key=hint, validate=validate,
                                      on_success=on_success)

        count, _, cols, _ = run()
        if self._deferred_entry is None:
            # blocking path: the same checks the deferred entry runs at
            # settlement; the kernel reported the exact product size, so
            # one resized rerun is guaranteed to fit
            if not validate([None, self._last_extra_host[0]]):
                join_cap_override[0] = hint_store[jc_key]
                count, _, cols, _ = run()
            if self._deferred_entry is None and join_cap_override[0]:
                on_success(None)
        return self._attach_pending(Block(
            cols=cols, counts=count, capacity=join_cap_used[0],
            mesh=self.mesh, counts_host=self._last_counts_host))

    def collect(self) -> list:
        cols = self.block().to_numpy()
        return [(k, (lv, rv)) for k, lv, rv in zip(
            cols[KEY].tolist(), cols["lv"].tolist(), cols["rv"].tolist())]


class _GroupByKeyRDD(_ExchangeRDD):
    """Hash exchange, then a local key sort: the block holds key-sorted
    runs per shard. A hash-placed parent (a reduce or group output) skips
    the exchange, a key-sorted one the sort too. The launch defers like
    the reduce's (hinted capacities, settled at the next host read)."""

    hash_placed = True  # output rows live on shard hash(key) % n
    key_sorted = True

    def __init__(self, parent: DenseRDD):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent

    def _schema(self):
        return self.parent._schema()

    def _materialize(self) -> Block:
        n = self.n_shards
        sort_impl = self.context.dense_sort_impl
        self.parent._settle_placement()
        elide = self.parent.hash_placed and n > 1
        elide_sorted = elide and self.parent.key_sorted
        chain, root = (_narrow_chain(self.parent) if n > 1 and not elide
                       else ([], self.parent))
        blk = root.block_spec()  # we register our own pending entry
        source = _chain_source(chain, blk)
        names = [nm for nm, _ in self.parent._schema()]
        lo_name = KEY_LO if KEY_LO in names else None

        def build(slot, out_cap):
            cols, count = source()
            cols = dict(cols)
            if elide:
                cols, count, overflow = kernels.passthrough_exchange(
                    cols, count, cols[KEY].shape[1], out_cap)
            else:
                bucket = (_bucket_cols(cols, n) if n > 1
                          else torch.zeros_like(cols[KEY], dtype=torch.int32))
                cols, count, overflow = kernels.bucket_exchange(
                    cols, count, bucket, n, slot, out_cap,
                    sort_impl=sort_impl)
            if not elide_sorted:
                cols = kernels.sort_by_column(cols, count, KEY,
                                              impl=sort_impl,
                                              lo_name=lo_name)
            return (count, [], {nm: cols[nm] for nm in names}), overflow

        if elide:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                fixed_caps=(0, _elide_out_cap(blk)))
        else:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                make_hists=lambda: ([self._hash_histogram(*source())], None),
                hint_key=self._hint_key())
        return self._attach_pending(Block(
            cols=cols, counts=count, capacity=out_cap, mesh=self.mesh,
            counts_host=self._last_counts_host))

    def count(self) -> int:
        """The number of groups (distinct keys): first-of-run flags summed
        on the device over each shard's sorted runs."""
        blk = self.block()
        first = _run_starts(blk.cols, blk.counts)
        return int(first.sum())

    def collect_grouped(self):
        """Columnar grouped collect: (keys, offsets, values), group i's
        values being values[offsets[i]:offsets[i+1]]; no per-row or
        per-key Python objects. Shards are key-sorted and hash-disjoint,
        so one vectorized pass over the concatenated rows finds every
        boundary."""
        cols = self.block().to_numpy()
        return _grouped_columnar(cols[KEY], cols[VALUE])

    def collect(self) -> list:
        cols = self.block().to_numpy()
        return list(_sorted_runs(cols[KEY], cols[VALUE]))


def _run_starts(cols, count) -> torch.Tensor:
    """[n_shards, cap] bool: valid rows that start a run of equal keys
    (both words of a wide key) in key-sorted shards."""
    keys = cols[KEY]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    if KEY_LO in cols:
        lo = cols[KEY_LO]
        first[:, 1:] |= lo[:, 1:] != lo[:, :-1]
    return first & kernels.valid_mask(keys.shape[1], count)


class _SortByKeyRDD(_ExchangeRDD):
    """Sample sort: a strided sample of each shard's keys comes back with
    the post-chain counts in one transfer (the one blocking read), the
    host picks n - 1 range bounds, then a range exchange and a local sort
    in the requested direction."""

    def __init__(self, parent: DenseRDD, ascending: bool):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self.ascending = ascending

    def _fp_extra(self):
        return (self.ascending,)

    def _schema(self):
        return self.parent._schema()

    def _sample(self, source, capacity: int):
        """(post-chain counts, sampled keys per shard): the reference's
        strided sampler, stride = max(1, count // m) over 2m positions
        clipped to the capacity, fetched in one transfer as int64 words."""
        n = self.n_shards
        m = max(1, _SORT_SAMPLE // n)
        cols, count = source()
        keycols = [cols[KEY]] + ([cols[KEY_LO]] if KEY_LO in cols else [])
        stride = torch.clamp(count.to(torch.int64) // m, min=1)
        pos = (torch.arange(2 * m, device=count.device)[None, :]
               * stride[:, None]).clamp_(0, max(capacity - 1, 0))
        parts = [count.to(torch.int64)] + [
            torch.gather(kc.view(torch.int32) if kc.dtype.is_floating_point
                         else kc, 1, pos).to(torch.int64).reshape(-1)
            for kc in keycols]
        fetched = torch.cat(parts).cpu().numpy()
        counts_host = fetched[:n].astype(np.int32)
        words = [fetched[n + i * n * 2 * m:n + (i + 1) * n * 2 * m]
                 .astype(np.int32).reshape(n, 2 * m)
                 for i in range(len(keycols))]
        if cols[KEY].dtype == torch.float32:
            words[0] = words[0].view(np.float32)
        samples = []
        for s in range(n):
            c = int(counts_host[s])
            if c == 0:
                continue
            stride_s = max(1, c // m)
            n_valid = min(2 * m, -(-c // stride_s))
            keys = words[0][s, :n_valid]
            if len(words) == 2:
                keys = block_lib.decode_i64(keys, words[1][s, :n_valid])
            samples.append(keys)
        return counts_host, samples

    def _bounds(self, samples) -> np.ndarray:
        """n - 1 range bounds from the sorted samples (reversed when
        descending): allk[int(len * i / n)], as the reference picks
        them."""
        n = self.n_shards
        if samples:
            allk = np.sort(np.concatenate(samples))
            if not self.ascending:
                allk = allk[::-1]
            return allk[[int(len(allk) * i / n) for i in range(1, n)]]
        if self.wide_key:
            return np.zeros((n - 1,), np.int64)
        dt = dict(self.parent._schema())[KEY]
        return np.zeros((n - 1,), np.float32 if dt == torch.float32
                        else np.int32)

    def _materialize(self) -> Block:
        n = self.n_shards
        sort_impl = self.context.dense_sort_impl
        ascending = self.ascending
        chain, root = (_narrow_chain(self.parent) if n > 1
                       else ([], self.parent))
        blk = root.block()  # settled: the sampler reads it now
        source = _chain_source(chain, blk)
        names = [nm for nm, _ in self.parent._schema()]
        lo_name = KEY_LO if KEY_LO in names else None
        counts_host, samples = self._sample(source, blk.capacity)
        bounds = self._bounds_host = self._bounds(samples)
        # the bounds go to the device once per materialization
        dev = self.mesh.device
        if lo_name is not None:
            hi, lo = block_lib.encode_i64(bounds)
            bounds_dev = torch.from_numpy(hi).to(dev)
            bounds_lo_dev = torch.from_numpy(lo).to(dev)
        else:
            bounds_dev = torch.from_numpy(np.ascontiguousarray(bounds)).to(dev)
            bounds_lo_dev = None

        def build(slot, out_cap):
            cols, count = source()
            cols = dict(cols)
            if n == 1:
                bucket = torch.zeros_like(cols[KEY], dtype=torch.int32)
            else:
                bucket = kernels.range_bucket(
                    bounds_dev, cols[KEY], ascending, bounds_lo=bounds_lo_dev,
                    keys_lo=cols.get(lo_name))
            cols, count, overflow = kernels.bucket_exchange(
                cols, count, bucket, n, slot, out_cap, sort_impl=sort_impl)
            cols = kernels.sort_by_column(cols, count, KEY,
                                          descending=not ascending,
                                          impl=sort_impl, lo_name=lo_name)
            return (count, [], {nm: cols[nm] for nm in names}), overflow

        count, _, cols, out_cap = self._run_exchange(
            build, lambda: counts_host,
            make_hists=lambda: ([self._range_histogram(
                *source(), bounds_dev, ascending, bounds_lo_dev)], None),
            # the bounds come from the data: the same data gives the same
            # bounds, a changed distribution others, so they key the hint
            # with the post-chain counts the sampler fetched
            hint_key=self._hint_key(counts_host.tobytes(), bounds.tobytes()))
        return self._attach_pending(Block(
            cols=cols, counts=count, capacity=out_cap, mesh=self.mesh,
            counts_host=self._last_counts_host))


def _cartesian_budget(device: torch.device) -> int:
    """Bytes a cartesian product may take: on the card, its free memory
    plus what PyTorch's allocator holds unused; on the CPU,
    CPU_CARTESIAN_BUDGET."""
    if device.type != "cuda":
        return CPU_CARTESIAN_BUDGET
    free, _total = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)


class _CartesianDenseRDD(DenseRDD):
    """Device cross product: the right side replicated, each shard
    ragged-expanding its left rows against every right row (m = right
    total per valid left row). The parents materialize at construction:
    the memory gate needs real counts."""

    def __init__(self, left: DenseRDD, right: DenseRDD):
        lblk = left.block()
        rblk = right.block()
        r_total = rblk.num_rows
        l_counts = lblk.counts_np
        max_l = int(l_counts.max()) if l_counts.size else 0
        out_cap = block_lib._round_capacity(max(max_l * max(r_total, 1), 1))
        # per product row: its two columns and ragged_expand's four int64
        # slot indices (slot, owner, offset, run start)
        row_bytes = sum(c.element_size() for c in lblk.cols.values()) + \
            sum(c.element_size() for c in rblk.cols.values()) + 4 * 8
        need = lblk.n_shards * out_cap * row_bytes
        budget = _cartesian_budget(left.mesh.device)
        if need > budget:
            raise VegaError(
                f"cartesian product (~{out_cap} rows per shard, ~{need} "
                f"bytes) exceeds the device's free memory ({budget} bytes); "
                "vega_tpu_torch has no host tier to stream it")
        super().__init__(left.context, left.mesh, [left, right])
        self.left = left
        self.right = right
        self._r_total = r_total
        self._out_cap = out_cap

    def _schema(self):
        # canonical (KEY, VALUE): the product is a pair RDD
        return ((KEY, dict(self.left._schema())[VALUE]),
                (VALUE, dict(self.right._schema())[VALUE]))

    def _materialize(self) -> Block:
        lblk = self.left.block()
        r_total, out_cap = self._r_total, self._out_cap
        if r_total == 0:
            # an empty right side gives an empty product
            schema = dict(self._schema())
            return block_lib.from_numpy(
                {KEY: torch.zeros(0, dtype=schema[KEY]).numpy(),
                 VALUE: torch.zeros(0, dtype=schema[VALUE]).numpy()},
                self.mesh)
        # the right side's valid rows in shard order, compacted on the card
        rblk = self.right.block()
        rcol = rblk.cols[VALUE]
        keep = kernels.valid_mask(rcol.shape[1], rblk.counts).reshape(1, -1)
        rvals = kernels.compact({VALUE: rcol.reshape(1, -1)}, keep,
                                r_total)[0][VALUE][0]
        lvals = lblk.cols[VALUE]
        m = torch.where(kernels.valid_mask(lvals.shape[1], lblk.counts),
                        r_total, 0)
        owner, off, total = kernels.ragged_expand(m, out_cap)
        return Block(cols={KEY: torch.gather(lvals, 1, owner),
                           VALUE: rvals[off.clamp(0, r_total - 1)]},
                     counts=total.to(torch.int32), capacity=out_cap,
                     mesh=self.mesh)


def _grouped_columnar(keys: np.ndarray, vals: np.ndarray):
    """(group_keys, offsets, values) from key-sorted runs: group i's values
    are values[offsets[i]:offsets[i+1]]. Rows of different shards never
    share a key (hash placement), so a key change marks every boundary,
    shard boundaries included."""
    if len(keys) == 0:
        return keys, np.zeros(1, dtype=np.int64), vals
    starts = np.concatenate(
        [[0], np.flatnonzero(keys[1:] != keys[:-1]) + 1]).astype(np.int64)
    offsets = np.concatenate([starts, [len(keys)]])
    return keys[starts], offsets, vals


def _sorted_runs(keys: np.ndarray, vals: np.ndarray):
    """(key, [values]) pairs from key-sorted runs: the host view of
    _grouped_columnar, with Python cost per group, never per row."""
    group_keys, offsets, values = _grouped_columnar(keys, vals)
    for i, k in enumerate(group_keys.tolist()):
        yield k, values[offsets[i]:offsets[i + 1]].tolist()


class _DenseCoGroupRDD:
    """cogroup over two device group_by_keys (one hash placement, so
    co-keyed rows share a shard). The reference's node is a host-tier RDD;
    the port has no host tier, so this object carries its three actions:
    collect, collect_grouped and count."""

    def __init__(self, left: DenseRDD, right: DenseRDD):
        self.left_grouped = _GroupByKeyRDD(left)
        self.right_grouped = _GroupByKeyRDD(right)
        self.mesh = left.mesh

    def collect(self) -> list:
        """(k, ([lvs], [rvs])) per key: shard by shard, keys ascending
        within a shard, from the columnar form."""
        keys, lo, lv, ro, rv = self.collect_grouped()
        return [(k, (lv[lo[i]:lo[i + 1]].tolist(),
                     rv[ro[i]:ro[i + 1]].tolist()))
                for i, k in enumerate(keys.tolist())]

    def collect_grouped(self):
        """Columnar cogroup: (keys, l_offsets, l_values, r_offsets,
        r_values); group i's left values are
        l_values[l_offsets[i]:l_offsets[i+1]] (resp. right). Per shard the
        two sides align with one union and searchsorted pass; no per-row
        or per-key Python."""
        def expand_offsets(gk, goff, union):
            # gk is a subset of the sorted union: one scatter places each
            # group's length at its union slot
            lengths = np.zeros(len(union), dtype=np.int64)
            lengths[np.searchsorted(union, gk)] = goff[1:] - goff[:-1]
            return np.concatenate([[0], np.cumsum(lengths)])

        lblk = self.left_grouped.block()
        rblk = self.right_grouped.block()
        lall, rall = lblk.to_numpy(), rblk.to_numpy()
        lsplit = np.cumsum(lblk.counts_np)[:-1]
        rsplit = np.cumsum(rblk.counts_np)[:-1]
        lk_s, lv_s = (np.split(lall[KEY], lsplit),
                      np.split(lall[VALUE], lsplit))
        rk_s, rv_s = (np.split(rall[KEY], rsplit),
                      np.split(rall[VALUE], rsplit))
        keys_parts, lv_parts, rv_parts = [], [], []
        lo_parts, ro_parts = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)]
        l_base = r_base = 0
        for s in range(self.mesh.n_shards):
            lk, loff, lv = _grouped_columnar(lk_s[s], lv_s[s])
            rk, roff, rv = _grouped_columnar(rk_s[s], rv_s[s])
            union = np.union1d(lk, rk)
            if not len(union):
                continue
            keys_parts.append(union)
            lo = expand_offsets(lk, loff, union)
            ro = expand_offsets(rk, roff, union)
            lo_parts.append(lo[1:] + l_base)
            ro_parts.append(ro[1:] + r_base)
            l_base += lo[-1]
            r_base += ro[-1]
            lv_parts.append(lv)
            rv_parts.append(rv)
        if not keys_parts:
            zero = np.zeros(1, np.int64)
            return (lall[KEY][:0], zero, lall[VALUE][:0], zero,
                    rall[VALUE][:0])
        return (np.concatenate(keys_parts), np.concatenate(lo_parts),
                np.concatenate(lv_parts), np.concatenate(ro_parts),
                np.concatenate(rv_parts))

    def count(self) -> int:
        """The number of keys in the union of both sides, column-wise:
        each side's group keys come from its key columns alone (one fetch
        each), and per shard |L| + |R| - |L & R|. The reference counts its
        host RDD's per-key Python lists, which at millions of keys takes
        minutes; the count is the same."""
        total = 0
        for lk, rk in zip(_shard_group_keys(self.left_grouped.block()),
                          _shard_group_keys(self.right_grouped.block())):
            total += len(lk) + len(rk) - len(
                np.intersect1d(lk, rk, assume_unique=True))
        return total


def _shard_group_keys(blk: Block) -> List[np.ndarray]:
    """Each shard's distinct keys (int64 for a wide key), from a grouped
    block's key-sorted runs: the first-of-run mask and the key words come
    back in one transfer per column, never the values."""
    counts = blk.counts_np
    key_cols = {nm: c for nm, c in blk.cols.items() if nm in (KEY, KEY_LO)}
    first = _run_starts(key_cols, blk.counts).cpu().numpy()
    host = block_lib._decode_key_cols(
        {nm: c.cpu().numpy() for nm, c in key_cols.items()})[KEY]
    return [host[s, :counts[s]][first[s, :counts[s]]]
            for s in range(blk.n_shards)]
