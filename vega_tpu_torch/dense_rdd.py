"""Dense lineage: RDD nodes whose partitions are shard rows of Blocks.

Counterpart of vega_tpu/tpu/dense_rdd.py. Sources (dense_range,
dense_from_numpy, dense_from_columns with named columns) and the narrow
nodes (map, filter, map_values, select, rename, keys / values, sample, the
ones column of count_by_key_dense, the key widening of a mixed-width join,
and dense_pipeline, the frame layer's whole-stage node)
and the expansions (map_expand, flat_map_ragged) feed the keyed nodes:
reduce_by_key (a named
op, or a traced binop through a segmented scan), join and
left_outer_join, group_by_key, sort_by_key and cogroup (two
group_by_keys), the set ops built on them (distinct, intersection,
subtract), union, zip, zip_with_index, the cartesian product, and the
actions count / collect / take / take_ordered / top / reduce / sum / min
/ max / mean / stats / histogram / count_by_value. Each node materializes
once into a Block ([n_shards, capacity] columns on one device). Narrow
nodes are not materialized in front of an exchange: their chain is
applied to the root block's columns inside the exchange, once per
materialization (program_mints() counts those applications); a chain
break (_chainable False) materializes through a chain of its own. Nodes
that keep keys and row order (filter, map_values,
select of the key, rename, the ones column) pass a parent's hash placement
and key order through, so the next exchange over them is elided.

Every plan of the reference is ported; the Context resolves them
(context.py): dense_sort_impl (xla / packed / radix / radix4) for every
sort of an exchange, dense_rbk_plan (fused_sort: one (bucket, key) sort
feeds the map-side combine and a pregrouped exchange; sort_partition: a
key sort, the combine, then a counting partition by bucket) and
dense_table_plan (a warm reduce whose key range was observed small runs as
a dense per-key table, with no sort and no row exchange).

Each exchange launch runs the program _ExchangeRDD._resolve_exchange picks
at its capacities: under dense_exchange="auto" the exchange planner's
(exchange_plan.py: the one-shot kernels.bucket_exchange when its estimated
peak fits dense_hbm_budget, else ring.staged_exchange with the largest
group that fits, else ring.ring_exchange), or the program the Context or
the op's exchange= keyword forces. Elided exchanges plan nothing.

Exchanges run the reference's _run_exchange in both its forms. Blocking:
the counts, the extra outputs and the overflow flags come back in one
fetch, and an overflow retries at larger capacities, up to 6 rounds.
Deferred (a hinted or fixed-capacity launch, unless a repair is running):
the launch keeps its flags on the device and records a pending entry on
the Context; the next host read (Block.counts_np, to_numpy, shard_rows, or
DenseRDD.block()) settles every pending entry in one fetch and repairs a
failed speculation, and what depends on it, in place.

Row functions and binops are traced once on empty probe columns (dtypes,
no values), as the reference traces on abstract values: a Python
constant broadcasts to a column of the reference's weak type, bool columns
are carried, 64-bit outputs narrow to 32 bits, and a branch on a value
raises VegaError when the op is built.

A string column is int32 rank codes plus a host dictionary (_dicts, known
from the lineage; block.dicts once materialized), decoded at host reads.
Binary ops put two sides' dictionaries onto their merged one first
(_unify_dict_cols: _DictUnifyRDD's remap gather, its table doubled and
retried on overflow); a row function over a string column raises.

An int64 column beyond int32, key or value, is the two-column (<name>,
<name>.lo) encoding. Every keyed op runs on a wide key (an int32 key
meeting it in a join or cogroup widens, _WidenKeyRDD); named reduces run
exactly over wide values, a total outside int64 raising VegaError. Row
functions over a wide column have no device row form.
There is no host tier to fall back to: a row function that does not run
on column tensors raises VegaError, and so does every request the
reference would hand to its host tier.

Block lifetime (the reference's single-process LRU): a node that
materializes registers its block in the Context's LRU; past
Context.dense_hbm_budget the least recently used blocks are dropped and
their nodes rematerialize from lineage when read again. Sources never
register (their block is the data), and neither the node just registered
nor a block whose settlement is pending is evicted. A node persisted at
a disk level (persist("MEMORY_AND_DISK") or "DISK_ONLY") is demoted
instead of dropped: its settled block is written to the Context's disk
store (store/disk.py) as an .npz snapshot of its padded columns and
counts, and its next access promotes it back to the device with the same
placement, without recomputing its lineage; a corrupt or unreadable
snapshot is a miss, and the node recomputes. save_npz writes a
node's valid rows as a plain .npz of column arrays, which dense_load_npz
reloads as a source, streamed (stream.py) when it exceeds the budget.
"""

from __future__ import annotations

import hashlib
import io
import logging
import math
import operator
import os
import time
import weakref
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import coltypes
from vega_tpu_torch import dict_encoding
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch import stream
from vega_tpu_torch.block import KEY, KEY_LO, VALUE, Block
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.store import StorageLevel

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


def _canonical_monoid_codes():
    """co_code of the canonical monoid lambdas for this interpreter."""
    return {
        (lambda a, b: a + b).__code__.co_code: "add",
        (lambda a, b: a * b).__code__.co_code: "prod",
    }


_MONOID_CODES = _canonical_monoid_codes()


def _infer_named_op(func) -> Optional[str]:
    """The named op a binop is, recognized soundly (the port's copy of
    vega_tpu/rdd/pair.py's): operator.add / mul, builtin min / max, and
    lambdas whose bytecode equals the canonical `lambda a, b: a + b` /
    `a * b` with no free variables, names or constants. Anything else runs
    as a traced binop."""
    if func is operator.add:
        return "add"
    if func is operator.mul:
        return "prod"
    if func is min:
        return "min"
    if func is max:
        return "max"
    code = getattr(func, "__code__", None)
    if (code is not None and code.co_argcount == 2
            and not code.co_freevars and not code.co_names
            and code.co_consts in ((), (None,))
            and getattr(func, "__closure__", None) is None):
        return _MONOID_CODES.get(code.co_code)
    return None


HOST_TIER_SUFFIX = (": the reference hands this to its host tier, which "
                    "vega_tpu_torch does not have")


def _no_host_tier(what: str) -> VegaError:
    """The error for a request the reference hands to its host tier."""
    return VegaError(what + HOST_TIER_SUFFIX)


# The reference's RDD API: the public names of vega_tpu/rdd/base.py's RDD
# with its pair ops (rdd/pair.py), and its DenseRDD's to_rdd. The port's
# own copy (it imports nothing of vega_tpu); a name a port object does not
# define raises VegaError ending in HOST_TIER_SUFFIX (_HostTierRefusals).
REFERENCE_RDD_API = frozenset((
    "aggregate", "aggregate_by_key", "cache", "cached_splits", "cartesian",
    "checkpoint", "coalesce", "cogroup", "collect", "collect_as_map",
    "collect_async", "combine_by_key", "compute", "count", "count_approx",
    "count_approx_distinct", "count_async", "count_by_key",
    "count_by_value", "count_by_value_approx", "dense", "distinct",
    "filter", "first", "flat_map", "flat_map_values", "fold",
    "fold_by_key", "for_each", "for_each_partition", "full_outer_join",
    "get_dependencies", "glom", "group_by", "group_by_key", "group_with",
    "histogram", "id", "intersection", "is_empty", "is_pinned", "iterator",
    "join", "key_by", "keys", "left_outer_join", "lookup", "map",
    "map_partitions", "map_partitions_with_index", "map_values",
    "mask_keys", "max", "mean_approx", "min", "num_partitions",
    "partition_by", "partition_by_key", "partitioner", "persist", "pin",
    "pipe", "preferred_locations", "random_split", "reduce", "reduce_async",
    "reduce_by_key", "repartition", "right_outer_join", "sample",
    "save_as_text_file", "sort_by", "sort_by_key", "splits", "stats",
    "subtract", "subtract_by_key", "take", "take_ordered", "take_sample",
    "to_debug_string", "to_local_iterator", "top", "union", "unpersist",
    "values", "zip", "zip_with_index", "to_rdd"))


class HostTierRefusal(VegaError, AttributeError):
    """A reference RDD API name that a port object does not define: a
    VegaError ending in HOST_TIER_SUFFIX, and an AttributeError too, so
    hasattr() and getattr(obj, name, default) keep their contract."""


def _host_name_refused(owner: str, name: str) -> HostTierRefusal:
    return HostTierRefusal(f"{owner}.{name}" + HOST_TIER_SUFFIX)


class _HostTierRefusals:
    """A reference RDD API name (REFERENCE_RDD_API) that the class does
    not define raises HostTierRefusal when read, as the reference answers
    it on its host tier; any other missing name stays a plain
    AttributeError, so a misspelt name of the port's own still fails as
    one."""

    def __getattr__(self, name):
        if name in REFERENCE_RDD_API:
            raise _host_name_refused(type(self).__name__, name)
        raise AttributeError(f"{type(self).__name__!r} object has no "
                             f"attribute {name!r}")


# ---------------------------------------------------------------------------
# block lifetime: the reference's single-process LRU (dense_rdd.py:207-333)
# ---------------------------------------------------------------------------

def _lifetime_touch(rdd) -> None:
    lru = rdd.context._dense_block_lru
    ref = lru.pop(rdd.rdd_id, None)
    if ref is not None:
        lru[rdd.rdd_id] = ref  # re-insert at the most recent end


def _lifetime_register(rdd) -> None:
    lru = rdd.context._dense_block_lru
    lru.pop(rdd.rdd_id, None)
    lru[rdd.rdd_id] = weakref.ref(rdd)
    _lifetime_evict(rdd.context, keep=rdd.rdd_id)


def _lifetime_forget(rdd) -> None:
    rdd.context._dense_block_lru.pop(rdd.rdd_id, None)


def _lifetime_sweep(lru: dict) -> Tuple[int, list]:
    """(live tracked bytes, live keys least recently used first); prunes
    entries whose node died or holds no block."""
    live = []
    total = 0
    for key in list(lru):
        rdd = lru[key]()
        blk = rdd._block if rdd is not None else None
        if blk is None:
            del lru[key]
            continue
        total += blk.nbytes
        live.append(key)
    return total, live


def dense_hbm_in_use(ctx) -> int:
    """Tracked device bytes of materialized dense intermediates, sources
    excluded (the reference's meaning; not the allocator's count)."""
    return _lifetime_sweep(ctx._dense_block_lru)[0]


def _lifetime_evict(ctx, keep: Optional[int] = None) -> None:
    """Drop least recently used blocks until the tracked bytes fit
    ctx.dense_hbm_budget, sparing `keep` and every block whose settlement
    is pending (it must settle or repair through the same object). A
    node persisted at a disk level is demoted to the disk store first;
    the byte accounting is the same either way."""
    lru = ctx._dense_block_lru
    total, live = _lifetime_sweep(lru)
    for key in live:
        if total <= ctx.dense_hbm_budget:
            break
        if key == keep:
            continue
        rdd = lru[key]()
        blk = rdd._block if rdd is not None else None
        if blk is None or blk.settle is not None:
            continue  # collected since the sweep (the next one prunes it)
        level = rdd._storage_level
        if level is not None and level.use_disk:
            _demote_block_to_disk(rdd, blk)
        total -= blk.nbytes
        rdd._block = None
        del lru[key]
        log.debug("dense lifetime: evicted block of rdd %s (%d bytes)",
                  rdd.rdd_id, blk.nbytes)


# Step times (ms) of the newest demotion (to_host_ms, savez_ms, write_ms:
# the store's crc32 and file) and promotion (read_crc_ms, extract_ms,
# to_device_ms), for diagnostics; also logged at DEBUG.
SPILL_STEPS: Dict[str, Dict[str, float]] = {"demote": {}, "promote": {}}


def _dense_spill_key(rdd) -> str:
    return f"dense-{rdd.rdd_id}"


def _demote_block_to_disk(rdd, blk: Block) -> None:
    """Write an evicted node's settled block to the Context's disk store as
    the reference's snapshot: an np.savez of counts, capacity and each
    column flattened to [n_shards * capacity] under col:<name>, padding
    rows included, so that promotion places every row where it was (the
    node's hash_placed / key_sorted stay true). Code columns only: the
    dictionaries re-attach from the lineage in block_spec. A write that
    fails with OSError is logged and the node recomputes when read."""
    store = rdd.context._spill
    key = _dense_spill_key(rdd)
    if store.contains_raw(key):
        return  # a node's block never changes: one snapshot serves
    t0 = time.perf_counter()
    arrays = {f"col:{nm}": c.reshape((-1,) + c.shape[2:])
              for nm, c in blk._host_cols().items()}
    t1 = time.perf_counter()
    buf = io.BytesIO()
    np.savez(buf, counts=blk.counts_np, capacity=np.int64(blk.capacity),
             **arrays)
    t2 = time.perf_counter()
    try:
        store.spill_raw(key, buf.getbuffer())
    except OSError:
        log.exception("dense block spill failed; the node will recompute")
        return
    _record_spill_steps("demote", rdd, ("to_host_ms", "savez_ms", "write_ms"),
                        (t0, t1, t2, time.perf_counter()))


def _load_spilled_block(rdd) -> Optional[Block]:
    """Promote a demoted node's block back onto the device, every column
    with its own dtype (a checksummed read through the disk store). None
    (the node recomputes) for a node not persisted at a disk level, no
    snapshot, a corrupt or unreadable one, or one of another shard
    count."""
    level = rdd._storage_level
    if level is None or not level.use_disk:
        return None
    store = rdd.context._spill
    key = _dense_spill_key(rdd)
    t0 = time.perf_counter()
    data = store.read_raw(key)
    if data is None:
        return None
    t1 = time.perf_counter()
    try:
        with np.load(io.BytesIO(data)) as z:
            counts = np.asarray(z["counts"], dtype=np.int32)
            capacity = int(z["capacity"])
            cols = {nm[len("col:"):]: z[nm]
                    for nm in z.files if nm.startswith("col:")}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        log.warning("dense spill snapshot unreadable; recomputing",
                    exc_info=True)
        store.remove_raw(key)
        return None
    n = rdd.n_shards
    if len(counts) != n:
        return None  # another shard count than the node's: recompute
    t2 = time.perf_counter()
    dev = rdd.mesh.device
    # a copy from pageable host memory returns once it has landed
    blk = Block(
        cols={nm: torch.from_numpy(c.reshape((n, capacity) + c.shape[1:]))
              .to(dev) for nm, c in cols.items()},
        counts=torch.from_numpy(counts).to(dev), capacity=capacity,
        mesh=rdd.mesh, counts_host=counts)
    _record_spill_steps("promote", rdd,
                        ("read_crc_ms", "extract_ms", "to_device_ms"),
                        (t0, t1, t2, time.perf_counter()))
    return blk


def _record_spill_steps(kind: str, rdd, names, stamps) -> None:
    """SPILL_STEPS[kind] = {name i: ms from stamps[i] to stamps[i + 1]}."""
    steps = {name: (b - a) * 1e3
             for name, a, b in zip(names, stamps, stamps[1:])}
    SPILL_STEPS[kind] = steps
    log.debug("dense %s of rdd %s: %s", kind, rdd.rdd_id,
              ", ".join(f"{n} {ms:.3f}" for n, ms in steps.items()))


class DenseRDD(_HostTierRefusals):
    """Base dense node. Subclasses implement _materialize() -> Block and
    _schema()."""

    _storage_level: Optional[StorageLevel] = None

    def __init__(self, ctx, mesh, parents: Sequence["DenseRDD"] = ()):
        self.context = ctx
        self.mesh = mesh
        self.rdd_id = next(ctx._rdd_ids)
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
        blk = self._block
        if blk is None:
            # a demoted block promotes from the disk store (a disk hit,
            # not a recompute); anything else rematerializes from lineage
            blk = _load_spilled_block(self)
            if blk is None:
                blk = self._materialize()
            if blk.dicts is None:
                # the one place the dictionaries of string columns attach:
                # materializers build plain code-column blocks, and the
                # lineage's dictionaries (_dicts) hang on here so host
                # reads decode (sources carry theirs from from_numpy)
                d = self._dicts()
                if d:
                    blk.dicts = dict(d)
            if blk.logical is None:
                # likewise the logical dtypes of columns stored in 32 bits
                # (coltypes.py), from the schema
                blk.logical = coltypes.logical_of(self._schema()) or None
            self._block = blk
            # sources set _block when built and never take this branch
            _lifetime_register(self)
        else:
            _lifetime_touch(self)
        return blk

    def persist(self, level=None) -> "DenseRDD":
        """Storage level of this node's block (a StorageLevel, its name in
        any case or its value; None is MEMORY_ONLY). The block is
        materialized once either way; at MEMORY_AND_DISK or DISK_ONLY an
        eviction past dense_hbm_budget demotes it to the Context's disk
        store and the next access promotes it back instead of
        recomputing. DISK_ONLY behaves like MEMORY_AND_DISK: a dense
        block must be on the device to compute. Returns self."""
        self._storage_level = StorageLevel.coerce(level)
        return self

    def unpersist(self) -> "DenseRDD":
        """Release this node's block (a pending settlement settles first,
        so a Block a caller holds never reads truncated data) and its disk
        snapshot; the next access rematerializes it from lineage. Returns
        self."""
        blk = self._block
        if blk is not None:
            if blk.settle is not None:
                blk.settle()
            self._block = None
            _lifetime_forget(self)
        self.context._spill.remove_raw(_dense_spill_key(self))
        return self

    def _materialize(self) -> Block:
        raise NotImplementedError

    def _schema(self) -> Schema:
        """(name, dtype) of the output columns, without materializing."""
        raise NotImplementedError

    def _fp_extra(self):
        return ()

    def _dicts(self) -> Dict[str, np.ndarray]:
        """{column name -> sorted host dictionary} of every string
        (dictionary-encoded) column of this node's output, known from the
        lineage without materializing. By default the parents' (the first
        parent wins a name), kept to this node's schema; a node that mints
        or moves columns sets _dict_renames ({out name -> parent name}),
        which replaces the walk ({}: every output column is new).
        Memoized."""
        memo = getattr(self, "_dicts_memo", None)
        if memo is not None:
            return memo
        parent_dicts: Dict[str, np.ndarray] = {}
        for p in self._dense_parents:
            for nm, d in p._dicts().items():
                parent_dicts.setdefault(nm, d)
        renames = getattr(self, "_dict_renames", None)
        if renames is not None:
            out = {out_nm: parent_dicts[src]
                   for out_nm, src in renames.items() if src in parent_dicts}
        else:
            out = parent_dicts
        names = {nm for nm, _ in self._schema()}
        res = {nm: d for nm, d in out.items() if nm in names}
        self._dicts_memo = res
        return res

    def _refuse_dict_rows(self, op: str) -> None:
        """A row function over a string column would see its int32 codes,
        not the strings: the reference hands it to its host tier, where
        it sees the strings."""
        d = self._dicts()
        if d:
            raise _no_host_tier(f"{op} over the string (dictionary-encoded) "
                                f"columns {sorted(d)}")

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

    def _wide_value(self) -> bool:
        """True when VALUE is the two-column int64 encoding."""
        return block_lib.lo_of(VALUE) in dict(self._schema())

    def _refuse_wide_rows(self, op: str) -> None:
        """A row function has no row form over a wide key or value (an
        int64 scalar, which the reference's 32-bit trace cannot hold): the
        reference hands it to its host tier."""
        if any(block_lib.is_lo(nm) for nm in self.columns):
            raise _no_host_tier(f"{op} over a two-column int64 column (no "
                                "device row form)")

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self._schema()]

    def _value_names(self) -> List[str]:
        return [n for n, _ in self._schema() if n not in (KEY, KEY_LO)]

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

    def _check_sortable_key(self, op: str) -> None:
        """A bool key has no device exchange: the reference's key sorts
        refuse it (a ValueError from its sentinel of the key dtype), so
        the port refuses it when the op is built."""
        if dict(self._schema()).get(KEY) == torch.bool:
            raise VegaError(f"{op} over a bool key: the reference's device "
                            "sorts refuse a bool key; cast it to int32 "
                            "first")

    # --- transformations ----------------------------------------------------
    def map(self, f: Callable) -> "DenseRDD":
        """Row map run on whole column tensors: f gets the row's columns
        (x, or (k, v) for a pair) as [n_shards, capacity] tensors and
        returns a value or a (key, value) pair, each a tensor of that
        shape or a Python constant (broadcast to a column: int -> int32,
        float -> float32, bool -> bool). int64 / float64 outputs narrow to
        int32 / float32, as the reference's 32-bit trace gives them."""
        self._refuse_wide_rows("map")
        self._refuse_dict_rows("map")
        return _MapRDD(self, f)

    def filter(self, predicate: Callable) -> "DenseRDD":
        """Keep the rows whose predicate (run on whole column tensors, as
        map's f) is true; each shard compacts stably, so placement and key
        order pass through."""
        self._refuse_wide_rows("filter")
        self._refuse_dict_rows("filter")
        return _FilterRDD(self, predicate)

    def map_expand(self, f: Callable, factor: int) -> "DenseRDD":
        """Fixed-arity flat map: f gets the row's columns as map's f does
        and returns `factor` outputs per row with a trailing dim of
        `factor` (e.g. torch.stack([x, x + 1000], dim=-1)), one such
        tensor or a (key, value) pair of them. Row i's outputs come out
        contiguous and in order, at capacity round(capacity * factor)."""
        self._refuse_wide_rows("map_expand")
        self._refuse_dict_rows("map_expand")
        return _MapExpandRDD(self, f, factor)

    def flat_map_ragged(self, f: Callable,
                        max_out_per_row: int) -> "DenseRDD":
        """Variable-arity flat map with a bound: f returns (payload,
        n_valid), the payload as map_expand's with a trailing dim of
        max_out_per_row and n_valid (a tensor of the row shape, or a
        constant) how many of a row's leading entries are real, clipped
        to [0, max_out_per_row]. Output capacity is capacity *
        max_out_per_row, so nothing can overflow."""
        self._refuse_wide_rows("flat_map_ragged")
        self._refuse_dict_rows("flat_map_ragged")
        return _FlatMapRaggedRDD(self, f, max_out_per_row)

    def sample(self, with_replacement: bool, fraction: float,
               seed: Optional[int] = None) -> "DenseRDD":
        """Bernoulli sampling on the device: row i of shard s stays when
        jax.random.uniform(fold_in(PRNGKey(seed), s), ...)[i] < fraction,
        the reference's threefry stream bit for bit (kernels.threefry2x32),
        so the rows kept equal the reference's on every device. Sampling
        with replacement (Poisson) is the reference's host tier's."""
        if with_replacement:
            raise _no_host_tier("sample(with_replacement=True)")
        return _SampleRDD(self, fraction, seed or 0)

    def key_by(self, f: Callable) -> "DenseRDD":
        return self.map(lambda x: (f(x), x))

    def map_values(self, f: Callable) -> "DenseRDD":
        """f over the one value column, keys (and a wide key's low word)
        untouched, so placement and key order pass through."""
        if not self.is_pair:
            raise VegaError("map_values on non-pair DenseRDD")
        value_names = self._value_names()
        if block_lib.wide_value_pairs(value_names):
            raise _no_host_tier("map_values over a wide int64 value column "
                                "(no device row form)")
        if len(value_names) != 1:
            raise VegaError(
                "map_values needs exactly one value column (have "
                f"{value_names}); use select(...) or a tuple-valued "
                "reduce_by_key on multi-column blocks")
        if value_names[0] in self._dicts():
            raise _no_host_tier("map_values over a string "
                                "(dictionary-encoded) value column")
        return _MapValuesRDD(self, f)

    def select(self, *names: str) -> "DenseRDD":
        """Project a subset of columns, in the order given. Selecting a
        wide key keeps its low word; the low word alone is refused (it
        would decode to nothing on host reads)."""
        schema = dict(self._schema())
        for n in names:
            if n not in schema:
                raise VegaError(f"no such column: {n!r}")
            base = n[:-len(block_lib.LO_SUFFIX)]
            if block_lib.is_lo(n) and base not in names:
                raise VegaError(
                    f"{n!r} is the low word of a wide int64 column; select "
                    f"{base!r} instead (the pair travels together)")
        expanded = []
        for n in names:
            expanded.append(n)
            lo = block_lib.lo_of(n)
            if lo in schema and lo not in names:
                expanded.append(lo)
        return _SelectRDD(self, tuple(expanded))

    def rename(self, mapping: dict) -> "DenseRDD":
        """Rename value columns; a wide column's low word follows it. The
        key columns cannot be renamed (or renamed onto), nor can a column
        take the reserved '.lo' suffix."""
        schema = dict(self._schema())
        for old, new in mapping.items():
            if old not in schema:
                raise VegaError(f"no such column: {old!r}")
            if old in (KEY, KEY_LO) or new in (KEY, KEY_LO):
                raise VegaError(
                    "the key columns cannot be renamed (or renamed onto): a "
                    "value column renamed to the key name would fabricate a "
                    "pair RDD out of non-key data")
            if block_lib.is_lo(old) or block_lib.is_lo(new):
                raise VegaError(
                    f"the {block_lib.LO_SUFFIX!r} suffix is reserved for "
                    "wide int64 low words; rename the base column instead")
        full = dict(mapping)
        for old, new in mapping.items():
            if block_lib.lo_of(old) in schema:
                full[block_lib.lo_of(old)] = block_lib.lo_of(new)
        out_names = [full.get(nm, nm) for nm in schema]
        if len(set(out_names)) != len(out_names):
            raise VegaError(f"rename would collide columns: {out_names}")
        return _RenameRDD(self, full)

    def keys_dense(self) -> "DenseRDD":
        """The key column as a value RDD."""
        if self.wide_key:
            raise _no_host_tier("keys_dense of a two-column int64 key (one "
                                "value column cannot hold it)")
        return _ProjectRDD(self, KEY)

    def values_dense(self) -> "DenseRDD":
        """The value column as a value RDD; a wide value keeps its pair."""
        if self._wide_value():
            return self.select(VALUE)
        return _ProjectRDD(self, VALUE)

    def reduce_by_key(self, func=None, *, op: Optional[str] = None,
                      exchange: Optional[str] = None):
        """Device shuffle: map-side combine, exchange, reduce-side merge of
        every value column per key (a wide key's two words are the key).
        A named op (add/min/max/prod, or a binop _infer_named_op
        recognizes) takes the segment fast path; any other binop runs
        traced, through kernels.segment_reduce_sorted: a scalar binop over
        one value column, a tuple binop (one scalar per column) over
        several. Wide int64 values take add / min / max, exact: a total
        outside int64 raises VegaError. String values take min / max (of
        their rank codes). exchange= forces the exchange's program
        (all_to_all, staged, ring) or plans it (auto); None follows the
        Context's dense_exchange."""
        if not self.is_pair:
            raise VegaError("reduce_by_key on non-pair DenseRDD")
        if op is None and func is None:
            raise TypeError("need func or op")
        wide = block_lib.wide_value_pairs(self.columns)
        if op is None:
            op = _infer_named_op(func)
        dict_vals = sorted(nm for nm in self._dicts()
                           if nm not in (KEY, KEY_LO))
        if dict_vals and op not in ("min", "max"):
            # rank codes: min / max of codes are those of the strings; any
            # other fold would compute on code values
            raise _no_host_tier(f"reduce_by_key over the string "
                                f"(dictionary-encoded) value columns "
                                f"{dict_vals} with op={op!r} (only min / "
                                "max have a meaning on the codes)")
        if op is None or (wide and func is not None and op == "prod"):
            if wide:
                raise _no_host_tier("a traced binop over wide int64 values "
                                    "(no scalar row form)")
            return _with_exchange(_ReduceByKeyRDD(self, None, func),
                                  exchange)
        if op not in kernels.SEGMENT_OPS:
            raise VegaError(f"unknown op {op!r}; expected one of "
                            f"{kernels.SEGMENT_OPS}")
        if op == "prod" and wide:
            raise VegaError("reduce_by_key(op='prod') over int64 (wide) "
                            "values has no device path; the reference's "
                            "host tier keeps exact products")
        return _with_exchange(_ReduceByKeyRDD(self, op), exchange)

    def sum_by_key(self) -> "DenseRDD":
        return self.reduce_by_key(op="add")

    def count_by_key_dense(self) -> "DenseRDD":
        """(key, occurrence count) pairs over any keyed block (pair,
        key-only or named): a ones column replaces the value columns before
        the exchange moves any data, then reduce_by_key(op="add")."""
        if not self.is_pair:
            raise VegaError("count_by_key_dense on un-keyed DenseRDD")
        return _OnesValueRDD(self).reduce_by_key(op="add")

    def combine_by_key(self, create_combiner: Callable,
                       merge_value: Callable, merge_combiners: Callable,
                       *, exchange: Optional[str] = None) -> "DenseRDD":
        """map_values(create_combiner), then a reduce by merge_combiners
        (named when _infer_named_op recognizes it, else traced): the host
        semantics under the combiner contract merge_value(c, v) ==
        merge_combiners(c, create_combiner(v))."""
        if not self.is_pair:
            raise VegaError("combine_by_key on non-pair DenseRDD")
        if block_lib.wide_value_pairs(self.columns):
            raise _no_host_tier("combine_by_key over wide int64 values (no "
                                "device row form)")
        if any(nm not in (KEY, KEY_LO) for nm in self._dicts()):
            raise _no_host_tier("combine_by_key over string "
                                "(dictionary-encoded) values")
        if not self._value_names():
            raise VegaError("combine_by_key needs a value column")
        mapped = _MapValuesRDD(self, create_combiner)
        op = _infer_named_op(merge_combiners)
        return _with_exchange(
            _ReduceByKeyRDD(mapped, op, None if op else merge_combiners),
            exchange)

    def _join_sides(self, other, op: str):
        """The checks join, left_outer_join and cogroup share: two dense
        pair RDDs on one mesh, each in the canonical (k, v) layout (the
        join names its outputs lv / rv); returns the sides _align_keys
        makes key-compatible. A streamed operand joins as its resident
        build."""
        other = _resident(other)
        if not isinstance(other, DenseRDD) or other.mesh != self.mesh:
            raise VegaError(f"{op} needs two dense pair RDDs on one mesh")
        for side in (self, other):
            side._check_keyed(op)
        return _align_keys(self, other, op)

    def join(self, other: "DenseRDD", *,
             exchange: Optional[str] = None) -> "DenseRDD":
        """Device sort-merge inner join with full duplicate-key semantics:
        (k, (lv, rv)) rows. An int32 key meeting an int64 one widens;
        string keys of two dictionaries meet on their merged one.
        exchange= as reduce_by_key's."""
        return _with_exchange(_JoinRDD(*self._join_sides(other, "join")),
                              exchange)

    def left_outer_join(self, other: "DenseRDD", fill_value=0, *,
                        exchange: Optional[str] = None) -> "DenseRDD":
        """Device left-outer join (duplicate keys on both sides): a left
        row with no match keeps fill_value, cast to the right column's
        dtype, in rv. exchange= as reduce_by_key's."""
        if fill_value is None:
            raise _no_host_tier("left_outer_join with fill_value=None (a "
                                "dense column cannot hold None)")
        other = _resident(other)
        if isinstance(other, DenseRDD) and other._wide_value():
            raise _no_host_tier("left_outer_join with a wide int64 right "
                                "value (the fill would land in its encoded "
                                "words)")
        if isinstance(other, DenseRDD) and any(
                nm not in (KEY, KEY_LO) for nm in other._dicts()):
            raise _no_host_tier("left_outer_join with a string right value "
                                "(the fill would land in its codes)")
        return _with_exchange(
            _JoinRDD(*self._join_sides(other, "left_outer_join"),
                     outer=True, fill_value=fill_value), exchange)

    def _check_keyed(self, op: str) -> None:
        if not self.is_pair:
            raise VegaError(f"{op} on non-pair DenseRDD")
        if self._value_names() not in ([VALUE],
                                       [VALUE, block_lib.lo_of(VALUE)]):
            raise VegaError(
                f"{op} needs the canonical (k, v) layout, got "
                f"{self._schema()}; select(...) down to one value column "
                f"and rename(...) it to {VALUE!r} first")

    def group_by_key(self, *, exchange: Optional[str] = None
                     ) -> "DenseRDD":
        """Device group_by_key: exchange by key hash, sort within each
        shard; collect() assembles (key, [values]) on the host and
        collect_grouped() returns the columnar form. exchange= as
        reduce_by_key's."""
        self._check_keyed("group_by_key")
        return _with_exchange(_GroupByKeyRDD(self), exchange)

    def sort_by_key(self, ascending: bool = True, *,
                    exchange: Optional[str] = None) -> "DenseRDD":
        """Distributed sample sort: strided key samples fetched in one
        transfer give host range bounds, then a range exchange and a local
        sort (string keys sort by their rank codes, so as strings).
        exchange= as reduce_by_key's."""
        if not self.is_pair:
            raise VegaError("sort_by_key on non-pair DenseRDD")
        return _with_exchange(_SortByKeyRDD(self, ascending), exchange)

    def cogroup(self, other: "DenseRDD") -> "_DenseCoGroupRDD":
        """Dense-dense cogroup: both sides group by key on the device
        (equal keys hash to one shard); (k, ([lvs], [rvs])) assembly, or
        its columnar form, happens on the host."""
        return _DenseCoGroupRDD(*self._join_sides(other, "cogroup"))

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
        if self._dicts() or other._dicts():
            raise _no_host_tier("cartesian of string (dictionary-encoded) "
                                "values")
        return _CartesianDenseRDD(self, other)

    def _one_value_column(self, op: str) -> None:
        if self.columns != [VALUE]:
            raise VegaError(f"{op} needs a value RDD of one {VALUE!r} column "
                            f"(columns: {self.columns})")

    def distinct(self) -> "DenseRDD":
        """Each value once: the value moves to the key, a keyed
        min-reduce dedups it, the keys come back as values."""
        if self.is_pair:
            raise _no_host_tier("distinct over pairs")
        self._refuse_wide_rows("distinct")
        self._one_value_column("distinct")
        return _ReduceByKeyRDD(_value_to_key(self, _value_key_zero),
                               "min").keys_dense()

    def _set_op_sides(self, other, op: str):
        """Value RDDs on one mesh with equal value dtypes: an int32 2 and
        a float32 2.0 hash apart on the device but compare equal on the
        host, so a mismatch is the host tier's. Returns the two sides,
        string values put onto one dictionary (_unify_dict_cols)."""
        if not isinstance(other, DenseRDD) or other.mesh != self.mesh:
            raise VegaError(f"{op} needs two dense RDDs on one mesh")
        if self.is_pair or other.is_pair:
            raise _no_host_tier(f"{op} over pairs")
        self._refuse_wide_rows(op)
        other._refuse_wide_rows(op)
        self._one_value_column(op)
        other._one_value_column(op)
        ld, rd = dict(self._schema())[VALUE], dict(other._schema())[VALUE]
        if ld != rd:
            raise _no_host_tier(f"{op} of value dtypes {ld} and {rd}")
        return _unify_or_refuse(self, other, (VALUE,), op)

    def intersection(self, other: "DenseRDD") -> "DenseRDD":
        """The values of both, each once: both sides dedup through a keyed
        reduce (hash-placed and key-sorted, so the join elides both
        exchanges and sorts), then the joined keys. String values meet on
        their merged dictionary."""
        left, right = self._set_op_sides(other, "intersection")

        def dedup(side):
            return _ReduceByKeyRDD(_value_to_key(side, _value_key_zero),
                                   "min")
        return _JoinRDD(dedup(left), dedup(right)).keys_dense()

    def subtract(self, other: "DenseRDD") -> "DenseRDD":
        """self's values (duplicates kept) that never occur in other: a
        left outer join against other's deduped values marked 1 (fill 0),
        filtered on the mark; the marks side is a reduce output, so its
        exchange is elided."""
        left, right = self._set_op_sides(other, "subtract")
        keyed = _value_to_key(left, _value_key_one)
        marks = _ReduceByKeyRDD(_value_to_key(right, _value_key_one), "min")
        joined = _JoinRDD(keyed, marks, outer=True, fill_value=0)
        return _FilterRDD(joined.select(KEY, "rv"), _unmarked).keys_dense()

    def union(self, other: "DenseRDD") -> "DenseRDD":
        """Per-shard concatenation of two RDDs of one schema (a streamed
        operand as its resident build); string columns of two
        dictionaries meet on their merged one."""
        other = _resident(other)
        if not isinstance(other, DenseRDD) or other.mesh != self.mesh:
            raise VegaError("union needs two dense RDDs on one mesh")
        if dict(self._schema()) != dict(other._schema()):
            raise _no_host_tier(f"union of schemas {self._schema()} and "
                                f"{other._schema()}")
        return _DenseUnionRDD(*_unify_or_refuse(
            self, other, self.columns, "union"))

    def zip(self, other: "DenseRDD") -> "DenseRDD":
        """(left value, right value) pairs of co-indexed rows: the shards'
        counts must be equal."""
        if not (isinstance(other, DenseRDD) and other.mesh == self.mesh
                and self.columns == [VALUE] and other.columns == [VALUE]):
            raise _no_host_tier("zip of anything but two one-column value "
                                "RDDs on one mesh")
        return _DenseZipRDD(self, other)

    def zip_with_index(self) -> "DenseRDD":
        """(value, global index) pairs: each shard's offset is the count
        of the shards before it, on the device."""
        if self.is_pair:
            raise VegaError("zip_with_index on pair DenseRDD — use values()")
        self._refuse_wide_rows("zip_with_index")
        self._one_value_column("zip_with_index")
        return _ZipWithIndexRDD(self)

    # --- actions ------------------------------------------------------------
    def count(self) -> int:
        return self.block().num_rows

    def collect(self) -> list:
        return _host_rows(self.block().to_numpy())

    def collect_arrays(self) -> Dict[str, np.ndarray]:
        """Columnar collect: no per-row Python objects."""
        return self.block().to_numpy()

    def save_npz(self, path: str) -> str:
        """Write the settled block's valid rows, in shard order, as one
        .npz of column arrays (wide int64 columns as one int64 array),
        through a .tmp file replaced into place: the dense checkpoint,
        which dense_load_npz re-sources with no lineage. Grouped and
        joined nodes, whose elements are derived from their columns,
        refuse. Returns path."""
        if type(self).collect is not DenseRDD.collect:
            raise VegaError(
                "save_npz persists raw columns; this RDD's elements are "
                "derived from them (grouped/joined) — save an upstream RDD "
                "or collect() instead")
        cols = self.block().to_numpy()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # a file object: savez keeps the name
            np.savez(f, **cols)
        os.replace(tmp, path)
        return path

    def take(self, n: int) -> list:
        """The first n rows in shard order, read shard by shard (only the
        rows still needed from each), never a full collect."""
        out: list = []
        blk = self.block()
        for s in range(blk.n_shards):
            out.extend(_host_rows(blk.shard_rows(s,
                                                 limit=max(n - len(out), 0))))
            if len(out) >= n:
                break
        return out[:n]

    # --- the host RDD API's device forms ------------------------------------
    def first(self):
        """The first row in shard order (take(1)); an empty RDD raises."""
        rows = self.take(1)
        if not rows:
            raise VegaError("first() of empty RDD")
        return rows[0]

    def is_empty(self) -> bool:
        """Whether no shard holds a row: the per-shard counts, one fetch
        (never a pass over the rows)."""
        return self.block().num_rows == 0

    def keys(self) -> "DenseRDD":
        """The keys as a value DenseRDD (keys_dense); the reference gives a
        host RDD."""
        if not self.is_pair:
            raise VegaError("keys() on non-pair DenseRDD")
        return self.keys_dense()

    def values(self) -> "DenseRDD":
        """The values as a value DenseRDD (values_dense); the reference
        gives a host RDD."""
        if not self.is_pair:
            raise VegaError("values() on non-pair DenseRDD")
        return self.values_dense()

    def count_by_key(self) -> dict:
        """{key: rows under it} as Python ints: count_by_key_dense on the
        device, collected."""
        return {k: int(c) for k, c in self.count_by_key_dense().collect()}

    def collect_as_map(self) -> dict:
        """dict(collect()): with duplicate keys the last row in collect()
        order wins, as the reference's dict over its collect()."""
        return dict(self.collect())

    def lookup(self, key) -> list:
        """The values of the rows under `key`, in row order: a device mask
        on the key column(s) compacts each shard, and only the matching
        rows come back. A key no row can hold (outside the key's dtype, a
        string absent from the dictionary) gives []."""
        self._check_keyed("lookup")
        words = self._key_words(key)
        if words is None:
            return []

        def matching(cols, count):
            like = cols[KEY]
            keep = kernels.valid_mask(like.shape[1], count)
            for nm, w in words.items():
                keep = keep & (cols[nm] == w)
            return kernels.compact(cols, keep, like.shape[1])
        names = self.columns
        node = dense_pipeline(self, matching, self._schema(),
                              ("lookup", repr(key)),
                              dict_renames={nm: nm for nm in names})
        return [v for _, v in node.collect()]

    def _key_words(self, key) -> Optional[dict]:
        """{key column: stored word} of rows whose key equals `key`; None
        when no row can hold it."""
        kd = self._dicts().get(KEY)
        if kd is not None:
            i = int(np.searchsorted(kd, key)) if isinstance(
                key, (str, np.str_)) else len(kd)
            return {KEY: i} if i < len(kd) and kd[i] == key else None
        if isinstance(key, (bool, np.bool_)) or not isinstance(
                key, (int, float, np.integer, np.floating)):
            return None
        dt = dict(self._schema())[KEY]
        if dt.is_floating_point:
            # a key the column's float dtype does not hold exactly equals
            # no row (the reference compares the rows' Python floats)
            held = coltypes.numpy_dtype(dt).type(key)
            return {KEY: float(held)} if float(held) == float(key) else None
        if key != int(key):
            return None
        k = int(key)
        if self.wide_key:
            if not -2**63 <= k < 2**63:
                return None
            hi, lo = block_lib.encode_i64(np.array([k], np.int64))
            return {KEY: int(hi[0]), KEY_LO: int(lo[0])}
        if dt == torch.int32 and not \
                kernels.INT32_MIN <= k <= kernels.INT32_MAX:
            return None
        try:
            return {KEY: coltypes.stored_scalar(k, dt)}
        except VegaError:
            return None  # outside the key's dtype

    def right_outer_join(self, other: "DenseRDD") -> "_DenseRightOuterJoin":
        """(k, (lv or None, rv)) for every row of other: the device inner
        join, plus other's rows whose key self lacks, with None on the
        left. A dense column cannot hold None, so the result is an object
        in _DenseCoGroupRDD's style whose collect() assembles the rows on
        the host (count() needs no rows). The device left_outer_join fills
        a missing side with a value, not None."""
        return _DenseRightOuterJoin(*self._join_sides(other,
                                                      "right_outer_join"))

    # --- value actions ------------------------------------------------------
    def _value_block(self, op: str, wide_ok: bool = False) -> Block:
        if self.is_pair:
            raise VegaError(f"{op}() on pair DenseRDD — reduce values "
                            "instead")
        if not (wide_ok and self._wide_value()):
            self._refuse_wide_rows(op)
            self._one_value_column(op)
        return self.block()

    def _named_reduce(self, op: str):
        """One per-shard masked reduce, the n_shards partials fetched at
        once and reduced on the host as the reference reduces them. A
        string column takes min / max of its rank codes, decoded."""
        vdict = self._dicts().get(VALUE)
        if vdict is not None and op == "add":
            raise VegaError(
                "sum() over a string (dictionary-encoded) column has no "
                "meaning; min()/max() are the defined string reductions")
        blk = self._value_block(op, wide_ok=True)
        if self._wide_value():
            return _named_reduce_wide(blk, op)
        if vdict is not None:
            # empty shards report the op's identity, never a code
            partials, counts = _fetch_words([kernels.masked_reduce(
                blk.cols[VALUE], blk.counts, op), blk.counts])
            picked = partials[counts > 0]
            if not picked.size:
                raise VegaError(f"{op}() of empty DenseRDD")
            code = picked.min() if op == "min" else picked.max()
            return vdict[int(code)].item()
        dt = dict(self._schema())[VALUE]
        col = blk.cols[VALUE]
        if op == "add" and dt in (torch.uint8, torch.uint16, torch.uint32):
            # unsigned: int64 partials per shard, summed on the host as
            # Python ints, exact; the reference's uint32 partial wraps
            # once a shard's sum passes 2^32 (pinned in
            # tests/test_torch_dtypes.py)
            u = coltypes.to_row(col, dt).to(torch.int64)
            parts = torch.where(kernels.valid_mask(u.shape[1], blk.counts),
                                u, 0).sum(dim=1).cpu().numpy()
            return sum(int(x) for x in parts)
        partials = kernels.masked_reduce(col, blk.counts, op).cpu().numpy()
        if op == "add":
            total = partials.sum(axis=0)
            # float16 partials are the reference's float16 words
            return (np.float16(total) if dt == torch.float16
                    else total).item()
        # stored words order as their logical values: pick, then restore
        ext = partials.min(axis=0) if op == "min" else partials.max(axis=0)
        return coltypes.to_numpy(np.asarray(ext), dt).item()

    def sum(self):
        return self._named_reduce("add")

    def min(self):
        return self._named_reduce("min")

    def max(self):
        return self._named_reduce("max")

    def mean(self):
        n = self.count()
        if n == 0:
            raise VegaError("mean of empty DenseRDD")
        return self.sum() / n

    def reduce(self, f: Callable):
        """A traced binop: each shard folds its rows through the segmented
        scan (one segment), the n_shards partials and their non-empty
        flags come back in one fetch, and the host folds them with f on
        CPU tensors. An empty RDD raises."""
        if self.is_pair:
            raise _no_host_tier("reduce(f) over pairs")
        self._refuse_wide_rows("reduce(f)")
        self._refuse_dict_rows("reduce(f)")
        dtype = dict(self._schema()).get(VALUE)
        binop = _check_binop(f, [dtype], "reduce")
        blk = self._value_block("reduce")
        inputs = _row_inputs({VALUE: blk.cols[VALUE]}, blk.counts)
        if inputs is None:
            raise VegaError("reduce() of empty RDD")
        vals = inputs[VALUE]  # padded rows: a valid row's values (CPU)
        keyed = {"__k": torch.zeros_like(vals, dtype=torch.int32),
                 VALUE: vals}
        out, n_out = kernels.segment_reduce_sorted(
            keyed, blk.counts, "__k",
            lambda a, b: {VALUE: binop(a[VALUE], b[VALUE])}, presorted=True)
        partials, nonempty = _fetch_words(
            [out[VALUE][:, 0], (n_out > 0).to(torch.int32)])
        picked = [torch.from_numpy(partials[s:s + 1])[0]
                  for s in range(len(nonempty)) if nonempty[s]]
        if not picked:
            raise VegaError("reduce() of empty RDD")
        acc = picked[0]
        for x in picked[1:]:
            acc = binop(acc, x)
        return coltypes.to_numpy(acc.numpy(), dtype).item()

    def stats(self) -> dict:
        """count / mean / stdev / min / max in one pass and one fetch:
        float32 partials (sum, sum of squares, min, max) per shard and the
        integer counts, combined on the host as the reference combines
        them."""
        self._refuse_dict_rows("stats")
        blk = self._value_block("stats")
        v = coltypes.to_float32(blk.cols[VALUE], dict(self._schema())[VALUE])
        parts = torch.stack([kernels.masked_reduce(v, blk.counts, "add"),
                             kernels.masked_reduce(v * v, blk.counts, "add"),
                             kernels.masked_reduce(v, blk.counts, "min"),
                             kernels.masked_reduce(v, blk.counts, "max")],
                            dim=1)
        counts, parts = _fetch_words([blk.counts, parts])
        n = int(counts.sum())
        s = float(parts[:, 0].sum())
        ss = float(parts[:, 1].sum())
        valid = counts > 0
        mn = float(parts[valid, 2].min()) if valid.any() else float("inf")
        mx = float(parts[valid, 3].max()) if valid.any() else float("-inf")
        mean = s / n if n else float("nan")
        var = max(0.0, ss / n - mean * mean) if n else float("nan")
        return {"count": n, "mean": mean,
                "stdev": math.sqrt(var) if n else float("nan"),
                "min": mn, "max": mx}

    def _min_max(self):
        """min and max in one pass and one fetch."""
        blk = self._value_block("histogram")
        vals = blk.cols[VALUE]
        parts = torch.stack([kernels.masked_reduce(vals, blk.counts, "min"),
                             kernels.masked_reduce(vals, blk.counts, "max")],
                            dim=1)
        parts, counts = _fetch_words([parts, blk.counts])
        valid = counts > 0
        if not valid.any():
            raise VegaError("min/max of empty DenseRDD")
        parts = coltypes.to_numpy(parts, dict(self._schema())[VALUE])
        return parts[valid, 0].min().item(), parts[valid, 1].max().item()

    def histogram(self, buckets):
        """(edges, counts): `buckets` edges, or that many even buckets
        between min and max. Values and edges compare in float32, a value
        lands in searchsorted(edges, v, right) - 1, clipped to the last
        bucket, and values outside [edges[0], edges[-1]] are dropped; the
        per-shard counts are summed on the card and fetched once."""
        self._refuse_dict_rows("histogram")
        blk = self._value_block("histogram")
        if isinstance(buckets, int):
            lo, hi = self._min_max()
            if lo == hi:
                return [lo, hi], [self.count()]
            step = (hi - lo) / buckets
            edges = [lo + i * step for i in range(buckets)] + [hi]
        else:
            edges = list(buckets)
        n_bins = len(edges) - 1
        dev = self.mesh.device
        bnds = torch.tensor(edges, dtype=torch.float32, device=dev)
        v = coltypes.to_float32(blk.cols[VALUE], dict(self._schema())[VALUE])
        mask = kernels.valid_mask(v.shape[1], blk.counts) \
            & (v >= bnds[0]) & (v <= bnds[-1])
        idx = (torch.searchsorted(bnds, v, right=True) - 1).clamp_(
            0, n_bins - 1)
        idx = torch.where(mask, idx, n_bins)
        counts = torch.bincount(idx.reshape(-1), minlength=n_bins + 1)
        return edges, counts[:n_bins].cpu().tolist()

    def count_by_value(self) -> dict:
        """{value: occurrences}: the value moves to the key, a ones column
        rides it through reduce_by_key(op="add")."""
        if self.is_pair:
            raise _no_host_tier("count_by_value over pairs")
        self._refuse_wide_rows("count_by_value")
        self._one_value_column("count_by_value")
        return dict(_ReduceByKeyRDD(_value_to_key(self, _value_key_one),
                                    "add").collect())

    def take_ordered(self, n: int, key=None) -> list:
        """The n smallest elements: a per-shard top-k (values) or row sort
        (pairs, ordered like host tuples: key, then value), then a merge
        of the n_shards * n survivors on the host."""
        if key is not None:
            raise VegaError("take_ordered(key=...) needs the host tier, "
                            "which vega_tpu_torch does not have")
        return self._device_topk(n, largest=False)

    def top(self, n: int, key=None) -> list:
        """The n largest elements, as take_ordered orders them, reversed."""
        if key is not None:
            raise VegaError("top(key=...) needs the host tier, which "
                            "vega_tpu_torch does not have")
        return self._device_topk(n, largest=True)

    def _device_topk(self, n: int, largest: bool) -> list:
        """Values: a per-shard top-k of the value column; pairs, named
        blocks and a wide value: the row sort of _device_topk_rows (a
        wide value's rows are 1-tuples, unwrapped)."""
        if self.is_pair:
            return self._device_topk_rows(n, largest)
        if self._wide_value():
            return [r[0] for r in self._device_topk_rows(n, largest)]
        blk = self.block()
        k = min(n, blk.capacity)
        best = kernels.topk_values(blk.cols[VALUE], blk.counts, k,
                                   largest).cpu().numpy()
        n_valid = np.minimum(blk.counts_np, k)
        candidates = np.sort(np.concatenate(
            [best[s, :n_valid[s]] for s in range(blk.n_shards)]))
        if largest:
            candidates = candidates[::-1]
        vdict = self._dicts().get(VALUE)
        if vdict is not None:
            # rank codes order as their strings: decode the survivors
            candidates = vdict[candidates[:n].astype(np.int64)]
        # stored words order as their logical values (coltypes.py)
        return coltypes.to_numpy(candidates[:n],
                                 dict(self._schema())[VALUE]).tolist()

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
        merged = block_lib.decode_wide_cols(
            {nm: np.concatenate([col[s, :n_valid[s]] for s in keep])
             for nm, col in zip(names, per_col)})
        order_cols = list(merged.values())
        # np.lexsort: the last key is primary; stable like the device sort
        # (string columns as their rank codes, which order as the strings)
        order_host = np.lexsort([c if not largest else
                                 (-c if np.issubdtype(c.dtype, np.floating)
                                  else ~c)
                                 for c in reversed(order_cols)])
        out_cols = list(block_lib._decode_dict_cols(coltypes.decode_cols(
            merged, coltypes.logical_of(schema)), self._dicts()).values())
        return [tuple(c[i].item() for c in out_cols)
                for i in order_host[:n]]


class _SourceRDD(DenseRDD):
    """A Block as data. hash_placed declares its rows hash-placed (a
    streamed fold's accumulator), so the next keyed exchange is elided."""

    def __init__(self, ctx, blk: Block, hash_placed: bool = False):
        super().__init__(ctx, blk.mesh)
        self._block = blk
        self._hash_placed = hash_placed

    @property
    def hash_placed(self) -> bool:
        return self._hash_placed

    def _materialize(self) -> Block:
        return self._block

    def unpersist(self) -> "DenseRDD":
        """No-op: a source's block is its data, with no lineage to
        rebuild it from."""
        return self

    def _schema(self):
        logical = self._block.logical or {}
        return tuple((n, logical.get(n, c.dtype))
                     for n, c in self._block.cols.items())

    def _dicts(self):
        return dict(self._block.dicts or {})

    def _fp_extra(self):
        return (tuple((n, str(dt)) for n, dt in self._schema()),
                self._block.capacity, self._hash_placed)


def _resident(rdd):
    """A streamed operand's resident build; anything else as it is."""
    if isinstance(rdd, stream.StreamedDenseRDD):
        return rdd.resident()
    return rdd


def dense_range(ctx, n: int, dtype=torch.int32,
                chunk_rows: Optional[int] = None):
    """Iota source built on the device (int32 by default). When the
    planned exchange of the whole block would pass ctx.dense_hbm_budget
    (stream.planned_chunk_rows: the planner under dense_exchange="auto",
    else 6x its bytes), or chunk_rows is given and below n, a
    StreamedDenseRDD of chunks instead."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = stream.planned_chunk_rows(n, itemsize, ctx.dense_hbm_budget,
                                     chunk_rows, n_shards=ctx.mesh.n_shards,
                                     exchange=ctx.dense_exchange)
    if rows is not None and rows < n:
        return stream.streamed_range(ctx, n, rows, dtype)
    return _SourceRDD(ctx, block_lib.block_range(n, ctx.mesh, dtype))


def dense_from_numpy(ctx, columns) -> DenseRDD:
    """columns: one array (values), two arrays (keys, values), or three
    and more, named c0, c1, ... (an un-keyed named block)."""
    if len(columns) == 1:
        cols = {VALUE: np.asarray(columns[0])}
    elif len(columns) == 2:
        cols = {KEY: np.asarray(columns[0]), VALUE: np.asarray(columns[1])}
    else:
        cols = {f"c{i}": np.asarray(c) for i, c in enumerate(columns)}
    return _SourceRDD(ctx, block_lib.from_numpy(
        cols, ctx.mesh, dict_enabled=ctx.dense_dict_enabled))


def dense_from_columns(ctx, columns: Optional[dict] = None,
                       key: Optional[str] = None, **kwcolumns) -> DenseRDD:
    """Named-column source: any number of columns, from a dict (any names,
    "key" included) and / or keywords; key= names the column that becomes
    the shuffle key KEY. reduce_by_key with a named op then reduces every
    other column per key, e.g. a parquet table with no pivoting:

        rdd = ctx.dense_from_columns(pq.read_table(p).to_pydict(), key="ip")
        per_ip = rdd.reduce_by_key(op="add")
    """
    named = {}
    for source in (columns or {}), kwcolumns:
        for name, col in source.items():
            if name in named:
                raise VegaError(f"duplicate column {name!r}")
            if block_lib.is_lo(name):
                raise VegaError(
                    f"column name {name!r} is reserved (the "
                    f"{block_lib.LO_SUFFIX!r} suffix marks low words of "
                    "two-column int64 encodings) — rename the column")
            named[name] = np.asarray(col)
    lengths = {name: len(col) for name, col in named.items()}
    if len(set(lengths.values())) > 1:
        raise VegaError(f"columns have unequal lengths: {lengths}")
    if key is not None:
        if key not in named:
            raise VegaError(f"key column {key!r} not in columns")
        if KEY in named and key != KEY:
            raise VegaError(f"column {KEY!r} already exists; key={key!r} "
                            "would overwrite it — rename one of them")
        named[KEY] = named.pop(key)
    return _SourceRDD(ctx, block_lib.from_numpy(
        named, ctx.mesh, dict_enabled=ctx.dense_dict_enabled))


def dense_from_block(ctx, blk: Block, hash_placed: bool = False
                     ) -> DenseRDD:
    """Source over an existing Block (e.g. one from_reference_arrays
    carried across from vega_tpu); hash_placed as _SourceRDD's."""
    return _SourceRDD(ctx, blk, hash_placed=hash_placed)


def dense_load_npz(ctx, path: str, chunk_rows: Optional[int] = None):
    """Load a file save_npz wrote (in either package), re-sharded onto
    ctx's shards: a source, or a StreamedDenseRDD when its planned
    exchange would pass the budget, as dense_range's (the host holds the
    file once; the device one chunk), or chunk_rows is given and below its
    rows. String columns (saved decoded) are dictionary-encoded again."""
    with np.load(path, allow_pickle=False) as data:
        cols = {n: data[n] for n in data.files}
    n = len(next(iter(cols.values()))) if cols else 0
    bytes_per_row = sum(
        c.dtype.itemsize * int(np.prod(c.shape[1:], dtype=np.int64))
        for c in cols.values()) or 1
    rows = stream.planned_chunk_rows(n, bytes_per_row, ctx.dense_hbm_budget,
                                     chunk_rows, n_shards=ctx.mesh.n_shards,
                                     exchange=ctx.dense_exchange)
    if rows is not None and rows < n:
        return stream.streamed_npz(ctx, cols, rows)
    return _SourceRDD(ctx, block_lib.from_numpy(
        cols, ctx.mesh, dict_enabled=ctx.dense_dict_enabled))


# ---------------------------------------------------------------------------
# narrow nodes
# ---------------------------------------------------------------------------


def _cols_to_row(cols, schema):
    """The row a row function sees, as the reference forms it: (k, v) for
    the canonical pair, v for one value column, else a tuple of every
    column in schema order (a key-only block gives a 1-tuple)."""
    names = [n for n, _ in schema]
    if set(names) == {KEY, VALUE}:
        return (cols[KEY], cols[VALUE])
    if names == [VALUE]:
        return cols[VALUE]
    return tuple(cols[n] for n in names)


def _host_rows(cols: Dict[str, np.ndarray]) -> list:
    """Host rows in the same forms: values, (k, v) pairs, or tuples of
    every column in block order."""
    names = list(cols)
    if names == [VALUE]:
        return cols[VALUE].tolist()
    if set(names) == {KEY, VALUE}:
        return list(zip(cols[KEY].tolist(), cols[VALUE].tolist()))
    return list(zip(*[cols[n].tolist() for n in names]))


def _value_to_key(side: DenseRDD, f) -> "_MapRDD":
    """The value moved to the key by one of the set ops' own row
    functions: a string value's dictionary follows it to the key."""
    keyed = _MapRDD(side, f)
    keyed._dict_renames = {KEY: VALUE}
    return keyed


def _value_key_zero(v):
    return v, torch.zeros_like(v, dtype=torch.int32)


def _value_key_one(v):
    return v, torch.ones_like(v, dtype=torch.int32)


def _unmarked(row):
    return row[1] == 0


def _fetch_words(tensors) -> List[np.ndarray]:
    """Several int32 / float32 tensors (other integers as int32) in ONE
    device-to-host transfer: their bits as one int32 vector, split and
    viewed back as numpy arrays of their own dtypes and shapes."""
    tensors = [t if t.dtype in (torch.int32, torch.float32)
               else t.to(torch.int32) for t in tensors]
    host = torch.cat([t.contiguous().view(torch.int32).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, offset = [], 0
    for t in tensors:
        np_dtype = np.float32 if t.dtype == torch.float32 else np.int32
        out.append(host[offset:offset + t.numel()].view(np_dtype)
                   .reshape(tuple(t.shape)))
        offset += t.numel()
    return out


def _named_reduce_wide(blk: Block, op: str) -> int:
    """sum / min / max of a keyless wide VALUE as a Python int. add: each
    shard's exact int64 sums of the high words and of the unsigned low
    words (kernels.wide_sum_words) come back in one fetch, and the host
    adds them as Python ints, so a total past int64 is the exact bignum
    with no refold of the rows. min / max: each shard's extreme of the
    int64 the words encode; an empty RDD raises."""
    hi, lo = blk.cols[VALUE], blk.cols[block_lib.lo_of(VALUE)]
    mask = kernels.valid_mask(hi.shape[1], blk.counts)
    if op == "add":
        h, low = kernels.wide_sum_words(hi, lo)
        hs, ls = torch.stack([torch.where(mask, h, 0).sum(dim=1),
                              torch.where(mask, low, 0).sum(dim=1)]
                             ).cpu().numpy()
        return sum(int(a) << 32 for a in hs) + sum(int(b) for b in ls)
    info = torch.iinfo(torch.int64)
    w = torch.where(mask, kernels.wide_i64(hi, lo),
                    info.max if op == "min" else info.min)
    ext = w.amin(dim=1) if op == "min" else w.amax(dim=1)
    ext, counts = torch.stack([ext, blk.counts.to(torch.int64)]
                              ).cpu().numpy()
    picked = [int(x) for x, c in zip(ext, counts) if c > 0]
    if not picked:
        raise VegaError(f"{op}() of empty DenseRDD")
    return min(picked) if op == "min" else max(picked)


# ---------------------------------------------------------------------------
# tracing: row functions and binops run once on empty probe columns
# ---------------------------------------------------------------------------
# 64-bit outputs narrow to 32 bits, as the reference's trace (jax_enable_x64
# off) gives them: the low 32 bits of add / sub / mul agree
# (coltypes.logical_dtype). The narrow and unsigned dtypes are logical
# column dtypes stored in 32 bits (coltypes.py).
_COLUMN_DTYPES = (torch.int32, torch.float32, torch.bool) + tuple(
    coltypes.PHYSICAL)


def _probe_cols(schema, n_shards: int):
    """Probe columns of a schema: [n_shards, 0] tensors on the CPU, dtypes
    and no values, as the reference traces on abstract values. Nothing is
    computed, so no value can raise (100 // x), and control flow on a
    value (an `if`, max() of two tensors) raises, as bool() of a tensor
    with no values does. Empty tensors rather than the meta device: the
    first meta op of a process imports torch's meta registrations, which
    took seconds on the card's machine (PERF.md section 6). A logical
    column probes in its row form (coltypes.to_row)."""
    return {n: _probe(dt, (n_shards, 0)) for n, dt in schema}


def _probe(dt: torch.dtype, shape) -> torch.Tensor:
    return coltypes.to_row(torch.empty(shape, dtype=coltypes.physical(dt)),
                           dt)


def _row_view(cols, schema):
    """Stored columns as row functions see them (coltypes.to_row): the
    logical columns converted, the rest as they are."""
    return {nm: coltypes.to_row(cols[nm], dt) for nm, dt in schema
            if nm in cols}


def _traced(f, args, what: str):
    """f(*args) on probe tensors; a failure means f does not run on column
    tensors: the reference would hand it to its host tier."""
    try:
        return f(*args)
    except Exception as e:  # noqa: BLE001 — any failure means "no trace"
        raise _no_host_tier(f"{what} {f!r} does not run on column tensors "
                            f"({type(e).__name__}: {e})") from e


def _column_dtype(x, shape, what: str) -> torch.dtype:
    """The logical block dtype of one traced output. A tensor computed
    from the row (of the probe's shape) keeps its logical dtype
    (coltypes.logical_dtype: 64-bit dtypes narrow, a uint16 / uint32
    RowTensor is its own); a constant (a Python or numpy scalar)
    broadcasts with the reference's weak type: int -> int32, float ->
    float32, bool -> bool."""
    if isinstance(x, torch.Tensor):
        if tuple(x.shape) != tuple(shape):
            raise VegaError(f"{what} must be one scalar per row, got shape "
                            f"{tuple(x.shape)} for rows {tuple(shape)} (a "
                            "constant is a Python scalar)")
        dt = coltypes.logical_dtype(x)
    elif isinstance(x, (bool, np.bool_)):
        dt = torch.bool
    elif isinstance(x, int):
        if not kernels.INT32_MIN <= x <= kernels.INT32_MAX:
            raise _no_host_tier(f"{what}: constant {x} outside int32")
        dt = torch.int32
    elif isinstance(x, float):
        dt = torch.float32
    elif isinstance(x, np.generic):
        dt = torch.from_numpy(np.asarray(x)).dtype
    else:
        raise _no_host_tier(f"{what} of type {type(x).__name__} (neither a "
                            "tensor nor a constant)")
    if dt not in _COLUMN_DTYPES:
        raise VegaError(f"{what} has dtype {dt}; the block dtype contract "
                        "is int32 / float32 / bool and the narrow int8 / "
                        "int16 / uint8 / uint16 / uint32 / float16")
    return dt


def _as_column(x, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """One output as a stored column of like's [n_shards, capacity] shape
    and device for its traced (logical) dtype: a constant broadcasts, a
    tensor casts (coltypes.to_physical)."""
    if not isinstance(x, torch.Tensor):
        value = x.item() if isinstance(x, np.generic) else x
        return torch.full(like.shape[:2], coltypes.stored_scalar(value, dtype),
                          dtype=coltypes.physical(dtype), device=like.device)
    return coltypes.to_physical(x, dtype)


def _row_inputs(cols, count):
    """The columns a row function runs on. On the CPU, where torch raises
    on integer division by zero, each padded row takes a valid row's
    values (its shard's first row, or the first non-empty shard's for an
    empty shard); valid rows keep theirs. None when no shard holds a
    valid row: the caller emits zero columns without calling the
    function. The card computes padded rows without trapping, and every
    caller masks them out after, so it gets the columns as they are."""
    like = next(iter(cols.values()))
    if like.device.type != "cpu":
        return cols
    nonempty = count > 0
    if not bool(nonempty.any()):
        return None
    src = int(torch.argmax(nonempty.to(torch.int32)))
    mask = kernels.valid_mask(like.shape[1], count)
    out = {}
    for nm, c in cols.items():
        tail = (1,) * (c.dim() - 2)
        fill = torch.where(nonempty.view((-1, 1) + tail), c[:, :1],
                           c[src:src + 1, :1])
        out[nm] = torch.where(mask.view(mask.shape + tail), c, fill)
    return out


def _zero_cols(schema, like: torch.Tensor):
    return {nm: torch.zeros(like.shape[:2], dtype=coltypes.physical(dt),
                            device=like.device)
            for nm, dt in schema}


def _check_binop(func, dtypes, what: str):
    """The reference's checks of a traced binop, traced once on probe
    columns: over one value column it maps two column tensors to one of
    the same dtype; over several, two tuples of them to a tuple with one
    such tensor per column (64-bit outputs narrow, as in row functions).
    Returns the binop over stored columns: a logical column's values go
    in as the row form (coltypes.to_row) and the result comes back stored,
    wrapped to its dtype. A binop that fails the checks, or branches on a
    value, raises VegaError when the op is built. (A traced + of two bool
    columns is a logical or, as jnp's; the NAMED add / prod over bool is
    what the reference refuses: _ReduceByKeyRDD.)"""
    probe = [_probe(dt, (1, 0)) for dt in dtypes]
    arg = probe[0] if len(probe) == 1 else tuple(probe)
    out = _traced(func, (arg, arg), f"{what} binop")
    outs = [out] if len(probe) == 1 else out
    if not isinstance(outs, (tuple, list)) or len(outs) != len(probe):
        raise _no_host_tier(f"{what} binop over {len(probe)} value columns "
                            f"must return a {len(probe)}-tuple")
    for p, o, dt in zip(probe, outs, dtypes):
        if not isinstance(o, torch.Tensor) or o.shape != p.shape:
            raise _no_host_tier(f"{what} binop must return one scalar per "
                                "value column")
        if coltypes.logical_dtype(o) != dt:
            raise _no_host_tier(
                f"{what} binop changes the value dtype ({dt} -> "
                f"{coltypes.logical_dtype(o)}); cast the column first so the block schema "
                "stays truthful")

    if len(dtypes) == 1:
        dt0 = dtypes[0]
        return lambda a, b: coltypes.to_physical(
            func(coltypes.to_row(a, dt0), coltypes.to_row(b, dt0)), dt0)
    return lambda a, b: tuple(
        coltypes.to_physical(x, dt) for x, dt in zip(
            func(tuple(coltypes.to_row(c, dt) for c, dt in zip(a, dtypes)),
                 tuple(coltypes.to_row(c, dt) for c, dt in zip(b, dtypes))),
            dtypes))


def _trace_row_fn(f, schema, n_shards: int):
    """Trace f once on probe columns to learn its output structure: a
    value or a (key, value) pair, each a column or a constant
    (_column_dtype). Returns (out_schema, cols_fn), where cols_fn maps a
    column dict to a column dict; anything else raises VegaError (there
    is no host tier to fall back to)."""
    shape = (n_shards, 0)
    out = _traced(f, (_cols_to_row(_probe_cols(schema, n_shards), schema),),
                  "row function")
    pair = isinstance(out, tuple) and len(out) == 2
    names = (KEY, VALUE) if pair else (VALUE,)
    out_schema = tuple(
        (nm, _column_dtype(x, shape, f"row function output {nm!r}"))
        for nm, x in zip(names, out if pair else (out,)))

    def cols_fn(cols):
        res = f(_cols_to_row(_row_view(cols, schema), schema))
        like = next(iter(cols.values()))
        return {nm: _as_column(x, dt, like).contiguous()
                for (nm, dt), x in zip(out_schema, res if pair else (res,))}
    return out_schema, cols_fn


class _NarrowRDD(DenseRDD):
    """A narrow op: shard-local (cols, count) -> (cols, count).
    _keeps_counts: the op keeps every row (not a filter). _keeps_placement:
    it keeps keys and row order, so the parent's hash placement and key
    order hold for it too. _chainable False: a chain break, which
    materializes through a chain of its own (_ColsPipelineRDD unfused)."""

    _keeps_counts = True
    _keeps_placement = False
    _chainable = True

    def __init__(self, parent: DenseRDD, out_schema):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._out_schema = tuple(out_schema)

    def _schema(self):
        return self._out_schema

    @property
    def hash_placed(self) -> bool:
        return self._keeps_placement and self.parent.hash_placed

    @property
    def key_sorted(self) -> bool:
        return self._keeps_placement and self.parent.key_sorted

    def _settle_placement(self) -> None:
        if self._keeps_placement:
            self.parent._settle_placement()

    def _shard_fn(self, cols, count):
        raise NotImplementedError

    def _materialize(self) -> Block:
        chain, root = _narrow_chain(self)
        blk = root.block()
        cols, count = _apply_chain(chain, dict(blk.cols), blk.counts)
        keeps = all(nd._keeps_counts for nd in chain)
        return Block(cols=cols, counts=count, capacity=blk.capacity,
                     mesh=self.mesh,
                     counts_host=blk.counts_host if keeps else None)


class _MapRDD(_NarrowRDD):
    def __init__(self, parent: DenseRDD, f):
        out_schema, cols_fn = _trace_row_fn(f, parent._schema(),
                                            parent.n_shards)
        super().__init__(parent, out_schema)
        self._cols_fn = cols_fn
        self._user_fn = f
        # the function mints its outputs: no dictionary rides through
        # (the set ops' own functions, which move a value to the key, set
        # {KEY: VALUE}: _value_to_key)
        self._dict_renames = {}

    def _fp_extra(self):
        return (_fp(self._user_fn),)

    def _shard_fn(self, cols, count):
        inputs = _row_inputs(cols, count)
        if inputs is None:
            return _zero_cols(self._out_schema,
                              next(iter(cols.values()))), count
        return self._cols_fn(inputs), count


class _FilterRDD(_NarrowRDD):
    """Rows whose predicate holds, compacted stably in each shard."""

    _keeps_counts = False
    _keeps_placement = True

    def __init__(self, parent: DenseRDD, pred):
        schema = parent._schema()
        n = parent.n_shards
        _column_dtype(_traced(pred, (_cols_to_row(_probe_cols(schema, n),
                                                  schema),),
                              "filter predicate"),
                      (n, 0), "filter predicate")
        super().__init__(parent, schema)
        self._pred = pred

    def _fp_extra(self):
        return (_fp(self._pred),)

    def _shard_fn(self, cols, count):
        like = next(iter(cols.values()))
        keep = kernels.valid_mask(like.shape[1], count)
        inputs = _row_inputs(cols, count)
        if inputs is not None:
            keep = keep & _as_column(self._pred(_cols_to_row(
                _row_view(inputs, self._out_schema), self._out_schema)),
                torch.bool, like)
        return kernels.compact(cols, keep, like.shape[1])


class _MapValuesRDD(_NarrowRDD):
    """f over the first value column (map_values has checked there is one;
    combine_by_key takes the first, as the reference does); the key
    columns pass through."""

    _keeps_placement = True

    def __init__(self, parent: DenseRDD, f):
        pschema = dict(parent._schema())
        self._vname = parent._value_names()[0]
        n = parent.n_shards
        self._in_dtype = pschema[self._vname]
        probe = _probe_cols([(self._vname, self._in_dtype)], n)
        self._dtype = _column_dtype(
            _traced(f, (probe[self._vname],), "map_values function"),
            (n, 0), "map_values output")
        key_schema = tuple((nm, pschema[nm]) for nm in (KEY, KEY_LO)
                           if nm in pschema)
        super().__init__(parent, key_schema + ((self._vname, self._dtype),))
        self._f = f
        self._dict_renames = {KEY: KEY}  # the value is minted by f

    def _fp_extra(self):
        return (_fp(self._f),)

    def _shard_fn(self, cols, count):
        out = {nm: cols[nm] for nm, _ in self._out_schema
               if nm != self._vname}
        col = cols[self._vname]
        inputs = _row_inputs({self._vname: col}, count)
        out[self._vname] = (
            torch.zeros(col.shape[:2], dtype=coltypes.physical(self._dtype),
                        device=col.device)
            if inputs is None else
            _as_column(self._f(coltypes.to_row(inputs[self._vname],
                                               self._in_dtype)),
                       self._dtype, col).contiguous())
        return out, count


class _WidenKeyRDD(_NarrowRDD):
    """An int32 KEY re-encoded as the two-column int64 key (hi = the sign
    word, lo = the bits with the sign bit flipped: block.encode_i64 on the
    device), so the side can meet an int64-keyed one in a join or
    cogroup: equal keys hash alike under hash32_pair. Placement resets
    (the default False): the int32 hash says nothing about the pair
    hash's."""

    def __init__(self, parent: DenseRDD):
        out = []
        for nm, dt in parent._schema():
            out.append((nm, dt))
            if nm == KEY:
                out.append((KEY_LO, torch.int32))
        super().__init__(parent, tuple(out))

    def _shard_fn(self, cols, count):
        out = {}
        for nm, col in cols.items():
            if nm == KEY:
                out[KEY] = col >> 31
                out[KEY_LO] = col ^ kernels.INT32_MIN
            else:
                out[nm] = col
        return out, count


def _align_keys(a: DenseRDD, b: DenseRDD, op: str):
    """Two pair sides made key-compatible for the device: equal keys must
    hash to one shard and compare equal in the merge. String keys of two
    dictionaries are remapped onto their merged one (_unify_dict_cols).
    Sides of one key dtype and width pass as they are; an int32 key
    meeting a two-column int64 key widens (_WidenKeyRDD). Any other mix
    raises: an int32 2 and a float32 2.0 hash apart on the device but
    compare equal on the host, so the reference hands it to its host
    tier."""
    a, b = _unify_or_refuse(a, b, (KEY,), op)
    sa, sb = dict(a._schema()), dict(b._schema())
    if a.wide_key == b.wide_key:
        if sa[KEY] == sb[KEY]:
            return a, b
    else:
        narrow = b if a.wide_key else a
        if dict(narrow._schema())[KEY] == torch.int32:
            widened = _WidenKeyRDD(narrow)
            return (a, widened) if a.wide_key else (widened, b)
    describe = {True: "two-column int64"}
    raise _no_host_tier(
        f"{op}: key dtypes differ ({describe.get(a.wide_key, sa[KEY])} vs "
        f"{describe.get(b.wide_key, sb[KEY])}), and equal keys would hash "
        "apart on the device")


class _DictUnification:
    """The host merge of one binary op's dictionaries, shared by both
    sides' _DictUnifyRDD, so it runs once and both sides agree on the
    merged codes. Lazy: building the op merges nothing."""

    def __init__(self, left_dicts, right_dicts, names):
        self.names = tuple(names)
        self._left = {nm: left_dicts[nm] for nm in self.names}
        self._right = {nm: right_dicts[nm] for nm in self.names}
        self._memo = None

    def tables(self):
        """(merged, left_maps, right_maps): per name the merged sorted
        dictionary and each side's int32 remap (old code -> merged
        code)."""
        if self._memo is None:
            merged, lmaps, rmaps = {}, {}, {}
            for nm in self.names:
                merged[nm], lmaps[nm], rmaps[nm] = dict_encoding.merge_dicts(
                    self._left[nm], self._right[nm])
            self._memo = (merged, lmaps, rmaps)
        return self._memo

    def token(self):
        """A cheap identity for capacity-hint keys: the input
        dictionaries' sizes and ends (a collision only shares a hint)."""
        out = []
        for nm in self.names:
            for d in (self._left[nm], self._right[nm]):
                out.append((nm, len(d), str(d[0]) if len(d) else "",
                            str(d[-1]) if len(d) else ""))
        return tuple(out)


_DICT_REMAP_ROUNDS = 8


class _DictUnifyRDD(DenseRDD):
    """One side's codes remapped onto the merged dictionary: one device
    gather per unified column through a remap table staged at
    Context.dense_dict_capacity entries (at least 128). The staged size
    is a real capacity: a valid code at or past the staged prefix (checked
    on the raw codes) sets the overflow flag, and the remap reruns with
    the capacity doubled, at most 8 rounds. The remap keeps order (sorted
    dictionaries in, a sorted merge out), so key order survives; hash
    placement does not (the codes that hash changed). A chain break: it
    materializes its parent and runs on its own, as the reference's
    _chainable = False node."""

    def __init__(self, parent: DenseRDD, unif: _DictUnification, side: int):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._unif = unif
        self._side = side
        self._dict_retries = 0  # overflow -> doubled-capacity rounds

    def _schema(self):
        return self.parent._schema()

    def _fp_extra(self):
        return ("dict_unify", self._side, self._unif.token())

    def _dicts(self):
        merged = self._unif.tables()[0]
        out = dict(self.parent._dicts())
        for nm in self._unif.names:
            if nm in out:
                out[nm] = merged[nm]
        return out

    @property
    def key_sorted(self) -> bool:
        return self.parent.key_sorted  # the remap keeps order

    def _settle_placement(self) -> None:
        self.parent._settle_placement()

    def _materialize(self) -> Block:
        blk = self.parent.block()
        _, lmaps, rmaps = self._unif.tables()
        side_tables = lmaps if self._side == 0 else rmaps
        names = self._unif.names  # string columns of both sides' schema
        dev = self.mesh.device
        cap_tab = max(128, self.context.dense_dict_capacity)
        valid = kernels.valid_mask(blk.capacity, blk.counts)
        for _round in range(_DICT_REMAP_ROUNDS):
            out = dict(blk.cols)
            flag = torch.zeros((), dtype=torch.bool, device=dev)
            for nm in names:
                staged_n = min(len(side_tables[nm]), cap_tab)
                tab = np.zeros(cap_tab, dtype=np.int32)
                tab[:staged_n] = side_tables[nm][:staged_n]
                tab = torch.from_numpy(tab).to(dev)
                codes = blk.cols[nm]
                flag = flag | (valid & ((codes < 0) | (codes >= staged_n))
                               ).any()
                out[nm] = tab[codes.clamp(0, cap_tab - 1).to(torch.int64)]
            if not bool(flag):
                return Block(cols=out, counts=blk.counts,
                             capacity=blk.capacity, mesh=self.mesh,
                             counts_host=blk.counts_host)
            self._dict_retries += 1
            cap_tab *= 2
        raise VegaError(
            f"dictionary remap overflowed "
            f"{max(len(side_tables[nm]) for nm in names)} entries after "
            f"{_DICT_REMAP_ROUNDS} capacity-doubling retries — raise "
            "dense_dict_capacity")


def _unify_dict_cols(a: DenseRDD, b: DenseRDD, names):
    """The two sides with the named string columns put onto one merged
    dictionary, so equal codes are equal strings: (a, b) as they are when
    nothing needs a remap (no string column, or one dictionary object on
    both sides); None when a name is a string column on one side only
    (codes against plain values compare only on the host)."""
    da, db = a._dicts(), b._dicts()
    shared = [nm for nm in names if nm in da or nm in db]
    if not shared:
        return a, b
    if any((nm in da) != (nm in db) for nm in shared):
        return None
    todo = [nm for nm in shared if da[nm] is not db[nm]]
    if not todo:
        return a, b
    unif = _DictUnification(da, db, todo)
    return _DictUnifyRDD(a, unif, 0), _DictUnifyRDD(b, unif, 1)


def _unify_or_refuse(a: DenseRDD, b: DenseRDD, names, op: str):
    """_unify_dict_cols, raising where the reference hands the op to its
    host tier (a string column against plain values)."""
    pair = _unify_dict_cols(a, b, names)
    if pair is None:
        raise _no_host_tier(f"{op} of a string (dictionary-encoded) column "
                            "against plain values")
    return pair


class _SampleRDD(_NarrowRDD):
    """Per-shard Bernoulli sampling on the reference's stream: shard s
    keys threefry with fold_in(PRNGKey(seed), s), row i keeps when
    uniform(key)[i] < fraction, and the kept rows compact stably (so
    placement and key order pass through)."""

    _keeps_counts = False
    _keeps_placement = True

    def __init__(self, parent: DenseRDD, fraction: float, seed: int):
        super().__init__(parent, parent._schema())
        self._fraction = float(fraction)
        self._key = kernels.prng_key(int(seed))

    def _fp_extra(self):
        return (self._fraction, self._key)

    def _shard_fn(self, cols, count):
        like = next(iter(cols.values()))
        n_shards, cap = like.shape[:2]
        dev = like.device
        k0, k1 = kernels.fold_in(
            *self._key, torch.arange(n_shards, device=dev)[:, None])
        u = kernels.uniform_f32(k0, k1, torch.arange(cap, device=dev))
        keep = (u < self._fraction) & kernels.valid_mask(cap, count)
        return kernels.compact(cols, keep, cap)


class _SelectRDD(_NarrowRDD):
    def __init__(self, parent: DenseRDD, names):
        pschema = dict(parent._schema())
        super().__init__(parent, tuple((n, pschema[n]) for n in names))
        self._names = tuple(names)
        self._keeps_placement = KEY in self._names

    def _fp_extra(self):
        return (self._names,)

    def _shard_fn(self, cols, count):
        return {n: cols[n] for n in self._names}, count


class _RenameRDD(_NarrowRDD):
    """Value-column rename: keys untouched, so placement and order
    survive."""

    _keeps_placement = True

    def __init__(self, parent: DenseRDD, mapping: dict):
        super().__init__(parent, tuple(
            (mapping.get(nm, nm), dt) for nm, dt in parent._schema()))
        self._mapping = dict(mapping)
        # dictionaries follow their columns to the new names
        self._dict_renames = {mapping.get(nm, nm): nm
                              for nm, _ in parent._schema()}

    def _fp_extra(self):
        return (tuple(sorted(self._mapping.items())),)

    def _shard_fn(self, cols, count):
        return {self._mapping.get(nm, nm): col
                for nm, col in cols.items()}, count


class _OnesValueRDD(_NarrowRDD):
    """The key columns and an int32 ones VALUE column: count_by_key_dense's
    map side (the value columns are dropped before the exchange moves any
    data; the VALUE name keeps the (k, count) row form)."""

    _keeps_placement = True

    def __init__(self, parent: DenseRDD):
        pschema = dict(parent._schema())
        out = [(nm, pschema[nm]) for nm in (KEY, KEY_LO) if nm in pschema]
        super().__init__(parent, tuple(out) + ((VALUE, torch.int32),))
        self._dict_renames = {KEY: KEY}  # VALUE is fresh ones

    def _shard_fn(self, cols, count):
        out = {nm: cols[nm] for nm in (KEY, KEY_LO) if nm in cols}
        out[VALUE] = torch.ones_like(cols[KEY], dtype=torch.int32)
        return out, count


class _ProjectRDD(_NarrowRDD):
    """One column as the VALUE of a value RDD (keys_dense /
    values_dense)."""

    def __init__(self, parent: DenseRDD, col: str):
        pschema = dict(parent._schema())
        if col not in pschema:
            raise VegaError(f"no {col!r} column on this DenseRDD (columns: "
                            f"{list(pschema)})")
        super().__init__(parent, ((VALUE, pschema[col]),))
        self._col = col
        self._dict_renames = {VALUE: col}

    def _fp_extra(self):
        return (self._col,)

    def _shard_fn(self, cols, count):
        return {VALUE: cols[self._col]}, count


class _ColsPipelineRDD(_NarrowRDD):
    """One narrow node applying a whole (cols, count) -> (cols, count)
    stage with a declared output schema: the frame planner lowers a
    select / filter / with_column run onto one, so the stage rides the
    next exchange's chain like any narrow node. fused=False makes it a
    chain break: it materializes through a chain of its own over its
    materialized parent (the frame's unfused leg). token is the stage's
    structural description (keys capacity hints); dict_renames maps the
    output columns that pass a string parent column through to it."""

    _keeps_counts = False  # a stage may filter

    def __init__(self, parent: DenseRDD, cols_fn, out_schema, token,
                 fused: bool = True, dict_renames=None):
        super().__init__(parent, out_schema)
        self._cols_fn = cols_fn
        self._user_fn = token
        self._dict_renames = dict(dict_renames or {})
        if not fused:
            self._chainable = False

    def _fp_extra(self):
        return (repr(self._user_fn),)

    def _shard_fn(self, cols, count):
        return self._cols_fn(cols, count)

    def _materialize(self) -> Block:
        if self._chainable:
            return _NarrowRDD._materialize(self)
        blk = self.parent.block()
        cols, count = _apply_chain([self], dict(blk.cols), blk.counts)
        return Block(cols=cols, counts=count, capacity=blk.capacity,
                     mesh=self.mesh)


def dense_pipeline(parent: DenseRDD, cols_fn, out_schema, token,
                   fused: bool = True, dict_renames=None) -> DenseRDD:
    """A _ColsPipelineRDD (the frame planner's whole-stage node):
    out_schema ((name, dtype), ...), token a stable description of the
    stage, dict_renames {output column -> string parent column it passes
    through}."""
    return _ColsPipelineRDD(parent, cols_fn, out_schema, token, fused=fused,
                            dict_renames=dict_renames)


def _payload_schema(payload, n_shards: int, width: int, what: str):
    """The schema of an expansion's payload: one tensor (VALUE) or a
    (key, value) pair of them, each computed from the row with a trailing
    dim of `width` (probe shape [n_shards, 0, width])."""
    shape = (n_shards, 0, width)
    pair = isinstance(payload, tuple) and len(payload) == 2
    out = []
    for nm, x in zip((KEY, VALUE) if pair else (VALUE,),
                     payload if pair else (payload,)):
        if not (isinstance(x, torch.Tensor) and tuple(x.shape) == shape):
            raise _no_host_tier(
                f"{what} output {nm!r} must be a tensor computed from the "
                f"row with a trailing dim of {width} (e.g. torch.stack(..., "
                "dim=-1))")
        out.append((nm, _column_dtype(x, shape, f"{what} output {nm!r}")))
    return tuple(out)


class _ExpandRDD(DenseRDD):
    """Base of the expansion nodes (map_expand, flat_map_ragged): each
    output row set has its own capacity, so the node is a chain break: it
    materializes its parent and runs on its own, never fused into the
    next exchange (the reference's _chainable = False)."""

    def __init__(self, parent: DenseRDD, f, width: int, what: str):
        if width <= 0:
            raise VegaError(f"{what} needs a positive output width, got "
                            f"{width}")
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._f = f
        self._width = width
        self._dict_renames = {}  # f mints its outputs
        schema = parent._schema()
        self._probe_out = _traced(f, (_cols_to_row(_probe_cols(
            schema, parent.n_shards), schema),), what)

    def _schema(self):
        return self._out_schema

    def _fp_extra(self):
        return (_fp(self._f), self._width)

    def _run(self):
        """(f's output on the parent's rows, parent block, output
        capacity); the output is None when no shard holds a row."""
        blk = self.parent.block()
        cap_out = block_lib._round_capacity(blk.capacity * self._width)
        inputs = _row_inputs(dict(blk.cols), blk.counts)
        if inputs is None:
            return None, blk, cap_out
        schema = self.parent._schema()
        return self._f(_cols_to_row(_row_view(inputs, schema), schema)), \
            blk, cap_out

    def _payload(self, payload):
        """The payload's columns as [n_shards, capacity * width] tensors
        of the traced dtypes, row i's outputs at [i * width, (i+1) *
        width)."""
        pair = len(self._out_schema) == 2
        return {nm: coltypes.to_physical(x, dt).reshape(x.shape[0], -1)
                for (nm, dt), x in zip(self._out_schema,
                                       payload if pair else (payload,))}

    def _empty(self, blk: Block, cap_out: int) -> Block:
        like = next(iter(blk.cols.values()))
        cols = {nm: torch.zeros((like.shape[0], cap_out),
                                dtype=coltypes.physical(dt),
                                device=like.device)
                for nm, dt in self._out_schema}
        return Block(cols=cols, counts=torch.zeros_like(blk.counts),
                     capacity=cap_out, mesh=self.mesh,
                     counts_host=np.zeros(self.n_shards, np.int32))


class _MapExpandRDD(_ExpandRDD):
    """Fixed-factor expansion: row i of a shard becomes output rows
    [i * factor, (i+1) * factor), in order; the valid rows stay a prefix,
    count * factor long, at capacity round(capacity * factor)."""

    def __init__(self, parent: DenseRDD, f, factor: int):
        super().__init__(parent, f, factor, "map_expand")
        self._out_schema = _payload_schema(
            self._probe_out, parent.n_shards, factor, "map_expand")

    def _materialize(self) -> Block:
        payload, blk, cap_out = self._run()
        if payload is None:
            return self._empty(blk, cap_out)
        cols = {nm: torch.nn.functional.pad(flat, (0, cap_out - flat.shape[1]))
                for nm, flat in self._payload(payload).items()}
        counts_host = (None if blk.counts_host is None
                       else blk.counts_host * self._width)
        return Block(cols=cols, counts=blk.counts * self._width,
                     capacity=cap_out, mesh=self.mesh,
                     counts_host=counts_host)


class _FlatMapRaggedRDD(_ExpandRDD):
    """Bounded variable-arity expansion: f(row) -> (payload, n_valid).
    n_valid clips to [0, max_out] (0 on invalid rows); each output slot
    finds its row by kernels.ragged_expand and gathers its entry. Output
    capacity is capacity * max_out, so it cannot overflow."""

    def __init__(self, parent: DenseRDD, f, max_out: int):
        super().__init__(parent, f, max_out, "flat_map_ragged")
        out = self._probe_out
        if not (isinstance(out, tuple) and len(out) == 2):
            raise _no_host_tier("flat_map_ragged function must return "
                                "(payload, n_valid)")
        self._out_schema = _payload_schema(
            out[0], parent.n_shards, max_out, "flat_map_ragged")
        _column_dtype(out[1], (parent.n_shards, 0),
                      "flat_map_ragged n_valid")

    def _materialize(self) -> Block:
        out, blk, cap_out = self._run()
        if out is None:
            return self._empty(blk, cap_out)
        payload, n_valid = out
        like = next(iter(blk.cols.values()))
        n_valid = _as_column(n_valid, torch.int64, like)
        m = torch.where(kernels.valid_mask(like.shape[1], blk.counts),
                        n_valid.clamp(0, self._width), 0)
        owner, off, total = kernels.ragged_expand(m, cap_out)
        idx = owner * self._width + off.clamp_(0, self._width - 1)
        cols = {nm: torch.gather(flat, 1, idx)
                for nm, flat in self._payload(payload).items()}
        return Block(cols=cols, counts=total.to(torch.int32),
                     capacity=cap_out, mesh=self.mesh)


def _narrow_chain(node):
    """(chain, root): the longest not-yet-materialized chainable narrow run
    ending at `node` (possibly empty) and the nearest materialization
    point above it. Exchanges apply the chain to the root's columns
    themselves instead of materializing an intermediate block."""
    chain: List[_NarrowRDD] = []
    cur = node
    while isinstance(cur, _NarrowRDD) and cur._block is None \
            and cur._chainable:
        chain.append(cur)
        cur = cur.parent
    chain.reverse()
    return chain, cur


# narrow-chain applications in this process (non-empty chains only)
_CHAIN_APPLIES = 0


def program_mints() -> int:
    """Narrow chains applied in this process: the port's counterpart of
    the reference's program_mints(), which counts compiled shard programs.
    The port compiles nothing and caches nothing, so it counts each
    application of a non-empty chain: a fused frame stage applies one, an
    unfused one (hint(fuse=False)) one per verb, and a warm rerun applies
    them again."""
    return _CHAIN_APPLIES


def _apply_chain(chain, cols, count):
    global _CHAIN_APPLIES
    if chain:
        _CHAIN_APPLIES += 1
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


def _bucket_cols(cols, n: int, key_dtype=None) -> torch.Tensor:
    """Hash-bucket each row by its key: an int32 / float32 key through the
    hash_bucket kernel, a logical key (key_dtype, the schema's) by the word
    coltypes.hash_input gives it (the reference's bits); a two-column
    int64 key by hash32_pair of both words (torch ops, as the reference
    computes it outside its kernel), so equal int64 keys, and only those,
    share a bucket."""
    if KEY_LO in cols:
        return (kernels.hash32_pair(cols[KEY], cols[KEY_LO]) % n).to(
            torch.int32)
    key = coltypes.hash_input(cols[KEY], key_dtype)
    if key.dtype == torch.float32:
        key = key.view(torch.int32)
    if key.dtype != torch.int32:
        raise VegaError(f"keys must be int32 or float32, got {key.dtype}")
    return cuda_kernels.hash_bucket(key.contiguous(), n)


def _wide_working_form(cols, wide: dict, op: Optional[str]):
    """A named reduce's working form of each wide value pair {name:
    name.lo}: for add, its two exact int64 addends
    (kernels.wide_sum_words) in the pair's columns; for min / max, the
    int64 the pair encodes in the name column, the low word dropped. The
    segment ops, sorts and exchanges carry either form like any column."""
    cols = dict(cols)
    for nm, lo in wide.items():
        if op == "add":
            cols[nm], cols[lo] = kernels.wide_sum_words(cols[nm], cols[lo])
        else:
            cols[nm] = kernels.wide_i64(cols[nm], cols.pop(lo))
    return cols


def _wide_stored_form(cols, count, wide: dict, op: Optional[str]):
    """The reduced working form back in the stored (int32, biased int32)
    words. Returns (cols, out_of_range): out_of_range[s] is set when a
    valid row of shard s holds an add total outside int64."""
    out_of_range = torch.zeros_like(count, dtype=torch.bool)
    if not wide:
        return cols, out_of_range
    cols = dict(cols)
    mask = kernels.valid_mask(cols[KEY].shape[1], count)
    for nm, lo in wide.items():
        if op == "add":
            cols[nm], cols[lo], bad = kernels.wide_from_sums(cols[nm],
                                                             cols[lo])
            out_of_range |= (bad & mask).any(dim=1)
        else:
            cols[nm], cols[lo] = kernels.wide_words(cols[nm])
    return cols, out_of_range


def _logical_form(cols, logical: dict, op: Optional[str],
                  back: bool = False):
    """A named reduce's form of the logical value columns {name: dtype}:
    add / prod run on a uint32's unbiased bits (coltypes.reduce_form, its
    own inverse), and back=True wraps each narrow result mod 2^width
    (coltypes.wrap), so the stored result is the reference's. min / max
    compare the stored words as they are."""
    if not logical or op not in ("add", "prod"):
        return cols
    cols = dict(cols)
    for nm, dt in logical.items():
        col = coltypes.reduce_form(cols[nm], dt)
        cols[nm] = coltypes.wrap(col, dt) if back else col
    return cols


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


def _with_exchange(node, exchange: Optional[str]):
    """An op's exchange= keyword: forces (or, 'auto', plans) the node's
    exchange program; None keeps the Context's dense_exchange."""
    if exchange is not None:
        node.exchange_mode = exchange_plan.check_mode(exchange)
    return node


class _ExchangeRDD(DenseRDD):
    """Common exchange loop: run the exchange, check the overflow flags,
    retry with grown capacities; or launch deferred and settle later. The
    exchange's program (one-shot all_to_all, staged or ring) is resolved
    per launch by exchange_plan.py under dense_exchange="auto", or forced
    by the Context's dense_exchange or the node's exchange_mode."""

    _last_counts_host: Optional[np.ndarray] = None
    _last_extra_host: Optional[List[np.ndarray]] = None
    _last_attempts = 0
    _deferred_entry: Optional[dict] = None
    _exchange_mode: Optional[str] = None
    # the last launch's plan; None at one shard and on elided paths, which
    # plan nothing
    _exchange_plan: Optional[exchange_plan.ExchangePlan] = None

    @property
    def exchange_mode(self) -> str:
        return self._exchange_mode or self.context.dense_exchange

    @exchange_mode.setter
    def exchange_mode(self, mode: str) -> None:
        self._exchange_mode = mode

    def _resolve_exchange(self, blks, slot_capacity: int,
                          out_capacity: int):
        """The exchange function of ONE launch, planned at its capacities
        (a retry's grown slot may change the plan): a forced mode takes its
        program; 'auto' the fewest-rounds program whose estimated
        per-shard peak fits dense_hbm_budget. blks are the operand blocks
        the launch moves (a join's non-elided sides, modeled together).
        Records the plan on the node (_exchange_plan), in the module
        counters and in Context.exchange_plans()."""
        n = self.n_shards
        if n == 1:
            return kernels.bucket_exchange  # the passthrough plans nothing
        budget = self.context.dense_hbm_budget
        blocks = [(b.capacity, exchange_plan.block_row_bytes(b))
                  for b in blks]
        plan = exchange_plan.plan_exchange(
            n_shards=n, capacity=max(cap for cap, _ in blocks),
            slot_capacity=slot_capacity, out_capacity=out_capacity,
            row_bytes=max(rb for _, rb in blocks), budget_bytes=budget,
            mode=self.exchange_mode, blocks=blocks)
        self._exchange_plan = plan
        exchange_plan.record_plan(plan)
        exchange_plan.add_to_summary(self.context._exchange_plans, plan)
        return exchange_plan.exchange_callable(plan)

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

    def _key_dtype(self):
        """The key's logical dtype (the hash's input form)."""
        return dict(self._schema()).get(KEY)

    def _hash_histogram(self, cols, count) -> Optional[np.ndarray]:
        """The destination histogram under hash bucketing."""
        if self.n_shards == 1:
            return None
        return self._dest_histogram(
            _bucket_cols(cols, self.n_shards, self._key_dtype()), count)

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
    """reduce_by_key of every value column, with a named op or a traced
    binop (func; op None), under the Context's plans. fused_sort: one
    stable (bucket, key) sort feeds the presorted map-side combine and a
    pregrouped exchange. sort_partition: a key-only sort, the presorted
    combine, then a stable counting partition by bucket and a pregrouped
    exchange. The reduce side sorts and merges. A hash-placed parent
    elides the exchange. With the table plan on, a warm run of a named op
    whose key range was observed small reduces through a dense table
    instead."""

    _table_plan = False  # whether the last materialization took the table

    def __init__(self, parent: DenseRDD, op: Optional[str], func=None):
        parent._check_sortable_key("reduce_by_key")
        if op in ("add", "prod"):
            pschema = parent._schema()
            bools = [nm for nm, dt in pschema
                     if dt == torch.bool and nm not in (KEY, KEY_LO)]
            if bools:
                jnp_op = "add" if op == "add" else "mul"
                raise VegaError(
                    f"reduce_by_key(op={op!r}) over the bool value columns "
                    f"{bools}: the reference refuses it ({jnp_op} does not "
                    "accept dtype bool); cast to int32 first to count")
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._op = op
        self._func = func
        self._value_cols = parent._value_names()
        if func is not None:
            if not self._value_cols:
                raise VegaError("reduce_by_key(func) needs a value column; "
                                "count_by_key_dense counts a key-only block")
            dtypes = dict(parent._schema())
            self._func = _check_binop(
                func, [dtypes[nm] for nm in self._value_cols],
                "reduce_by_key")
            self._user_fn = func

    def _segment_reduce(self, cols, count, presorted: bool,
                        sort_impl: str = "xla"):
        """The combine of both sides: the named op's segment reduce, or
        the traced binop's segmented scan (a scalar binop over one value
        column, a tuple binop over several), whose padded rows hold a
        valid row's values on the CPU (_row_inputs): the scan combines
        them too, and discards them. A wide key's low word rides with the
        key."""
        lo_name = KEY_LO if KEY_LO in cols else None
        if self._op is not None:
            return kernels.segment_reduce_named(
                cols, count, KEY, self._op, presorted=presorted,
                sort_impl=sort_impl, lo_name=lo_name)
        f, names = self._func, self._value_cols
        if not presorted:
            cols = kernels.sort_by_column(cols, count, KEY, impl=sort_impl,
                                          lo_name=lo_name)
        inputs = _row_inputs({nm: cols[nm] for nm in names}, count)
        if inputs is None:  # no valid row: nothing to combine
            return kernels.compact(cols, kernels.valid_mask(
                cols[KEY].shape[1], count), cols[KEY].shape[1])
        cols = dict(cols, **inputs)
        if len(names) == 1:
            nm0 = names[0]

            def combine(a, b):
                return {nm0: f(a[nm0], b[nm0])}
        else:
            def combine(a, b):
                return dict(zip(names, f(tuple(a[nm] for nm in names),
                                         tuple(b[nm] for nm in names))))
        return kernels.segment_reduce_sorted(
            cols, count, KEY, combine, presorted=True, lo_name=lo_name)

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
        return (self._op or _fp(self._user_fn),)

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
        lo_name = KEY_LO if KEY_LO in names else None
        # wide value pairs reduce in their exact working form; logical
        # (narrow, uint32) value columns in 32 bits, wrapped back after
        wide = block_lib.wide_value_pairs(names) if op else {}
        logical = ({nm: dt for nm, dt in coltypes.logical_of(schema).items()
                    if nm not in (KEY, KEY_LO)} if op else {})
        key_dt = dict(schema)[KEY]
        track_range = bool(wide) and op == "add"
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
            # an elided exchange plans nothing
            exchange = (None if elide else
                        self._resolve_exchange((blk,), slot, out_cap))
            cols, count = source()
            cols = _wide_working_form(cols, wide, op)
            cols = _logical_form(cols, logical, op)
            if n > 1 and not elide and plan == "sort_partition":
                # key-only sort -> presorted map-side combine -> counting
                # partition of the (often much smaller) combined rows;
                # equal keys share a bucket, so combining across bucket
                # boundaries is safe
                cols = kernels.sort_by_column(cols, count, KEY,
                                              impl=sort_impl,
                                              lo_name=lo_name)
                cols, count = self._segment_reduce(cols, count,
                                                   presorted=True)
                capacity = cols[KEY].shape[1]
                bucket = torch.where(kernels.valid_mask(capacity, count),
                                     _bucket_cols(cols, n, key_dt), n)
                cols, bucket = kernels.partition_by_bucket(
                    cols, bucket, n, sort_impl=sort_impl)
                cols, count, overflow = exchange(
                    cols, count, bucket, n, slot, out_cap, pregrouped=True)
            elif n > 1 and not elide:
                capacity = cols[KEY].shape[1]
                mask = kernels.valid_mask(capacity, count)
                bucket = torch.where(mask, _bucket_cols(cols, n, key_dt), n)
                cols, bucket = kernels.bucket_key_sort(
                    cols, count, bucket, KEY, impl=sort_impl, n_shards=n,
                    lo_name=lo_name)
                # map-side combine over the (bucket, key)-sorted rows
                cols, count = self._segment_reduce(cols, count,
                                                   presorted=True)
                # compact kept (bucket, key) order; re-derive the combined
                # rows' buckets from their keys
                bucket = _bucket_cols(cols, n, key_dt)
                cols, count, overflow = exchange(
                    cols, count, bucket, n, slot, out_cap, pregrouped=True)
            elif not elide:
                bucket = torch.zeros_like(cols[KEY], dtype=torch.int32)
                cols, count, overflow = exchange(
                    cols, count, bucket, n, slot, out_cap,
                    sort_impl=sort_impl)
            else:
                cols, count, overflow = kernels.passthrough_exchange(
                    cols, count, cols[KEY].shape[1], out_cap)
            # reduce-side merge
            cols, count = self._segment_reduce(
                cols, count, presorted=elide_sorted, sort_impl=sort_impl)
            cols, out_of_range = _wide_stored_form(cols, count, wide, op)
            cols = _logical_form(cols, logical, op, back=True)
            extras = [out_of_range] if track_range else []
            if learn_range:
                # the output's key range rides the counts fetch: it arms
                # the table plan for the next warm run
                keys = cols[KEY]
                mask = kernels.valid_mask(keys.shape[1], count)
                extras = [torch.where(mask, keys, kernels.INT32_MAX).amin(1),
                          torch.where(mask, keys, kernels.INT32_MIN).amax(1)]
            return (count, extras, {nm: cols[nm] for nm in names}), overflow

        # deferred launches bank the range when they commit; a wide sum
        # outside int64 fails its settlement, and the repair's blocking
        # rerun raises
        on_success = ((lambda head: self._bank_range(head[-2], head[-1]))
                      if learn_range else None)
        validate = ((lambda head: not head[1].any()) if track_range
                    else None)
        if elide:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                fixed_caps=(0, _elide_out_cap(blk)), validate=validate,
                on_success=on_success)
        else:
            count, _, cols, out_cap = self._run_exchange(
                build, lambda: blk.counts_np,
                make_hists=lambda: (
                    [self._hash_histogram(*source())], None),
                hint_key=self._hint_key(), validate=validate,
                on_success=on_success)
        extra = self._last_extra_host  # None on the deferred path
        if track_range and extra is not None and extra[0].any():
            raise VegaError(
                "reduce_by_key(op='add'): an exact total of a wide int64 "
                "column lies outside the int64 range and has no device "
                "representation (the reference's host tier keeps exact "
                "bignum sums)")
        if learn_range and extra is not None:
            self._bank_range(*extra[-2:])  # blocking path
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
    """Device sort-merge join with full duplicate-key semantics: inner, or
    left outer (outer=True: an unmatched left row keeps fill_value in rv).
    A hash-placed side (a reduce output) skips its exchange; a product
    beyond the exchange-sized capacity reruns once at its exact size."""

    def __init__(self, left: DenseRDD, right: DenseRDD, outer: bool = False,
                 fill_value=0):
        left._check_sortable_key("join")
        super().__init__(left.context, left.mesh, [left, right])
        self.left = left
        self.right = right
        self.outer = outer
        self.fill_value = fill_value

    def _fp_extra(self):
        # repr keeps a NaN fill's hints stable (nan != nan)
        return (self.outer, repr(self.fill_value))

    @property
    def hash_placed(self) -> bool:
        return True  # joined rows stay on their key's shard

    @property
    def key_sorted(self) -> bool:
        return True  # output follows the left sort order

    def _dicts(self):
        """The key's dictionary (both sides share it: _align_keys unified
        them), and each side's value dictionary under lv / rv."""
        out = {}
        ld, rd = self.left._dicts(), self.right._dicts()
        if KEY in ld:
            out[KEY] = ld[KEY]
        for prefix, side_d, side in (("lv", ld, self.left),
                                     ("rv", rd, self.right)):
            for nm, _dt in side._schema():
                if nm not in (KEY, KEY_LO) and nm in side_d:
                    out[_join_name(nm, prefix)] = side_d[nm]
        return out

    def _schema(self):
        """(k[, k.lo], lv[, lv.lo], rv[, rv.lo]): a wide key or value
        keeps its pair."""
        out = [(nm, dt) for nm, dt in self.left._schema()
               if nm in (KEY, KEY_LO)]
        for side, prefix in ((self.left, "lv"), (self.right, "rv")):
            out += [(_join_name(nm, prefix), dt)
                    for nm, dt in side._schema() if nm not in (KEY, KEY_LO)]
        return tuple(out)

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

        schema = dict(self._schema())
        names = list(schema)
        key_dt = schema[KEY]
        # a logical right value takes the fill as its stored word
        fill = (coltypes.stored_scalar(self.fill_value, schema["rv"])
                if self.outer else self.fill_value)
        lblk, lsource = side_input(self.left, l_elide)
        rblk, rsource = side_input(self.right, r_elide)
        join_cap_override: List[Optional[int]] = [None]
        join_cap_used = [0]

        def one_side(source, elide, slot, out_cap, exchange):
            cols, count = source()
            cols = dict(cols)
            if elide:
                return kernels.passthrough_exchange(
                    cols, count, cols[KEY].shape[1], out_cap)
            bucket = (_bucket_cols(cols, n, key_dt) if n > 1
                      else torch.zeros_like(cols[KEY], dtype=torch.int32))
            return exchange(cols, count, bucket, n, slot, out_cap,
                            sort_impl=sort_impl)

        def build(slot, out_cap):
            join_cap = join_cap_override[0] or out_cap
            join_cap_used[0] = join_cap
            moving = [b for b, el in ((lblk, l_elide), (rblk, r_elide))
                      if not el]
            # both sides elided: nothing moves, nothing is planned
            exchange = (self._resolve_exchange(moving, slot, out_cap)
                        if moving else None)
            lc, lcount, lof = one_side(lsource, l_elide, slot, out_cap,
                                       exchange)
            rc, rcount, rof = one_side(rsource, r_elide, slot, out_cap,
                                       exchange)
            joined, jcount, jtotal = kernels.merge_join_expand(
                lc, lcount, rc, rcount, KEY, join_cap, outer=self.outer,
                fill_value=fill, left_sorted=l_sorted,
                right_sorted=r_sorted, sort_impl=sort_impl,
                lo_name=KEY_LO if KEY_LO in lc else None)
            cols = {}
            for nm, col in joined.items():
                right = nm.startswith("r_")
                base = nm[2:] if right else nm
                cols[base if base in (KEY, KEY_LO) else _join_name(
                    base, "rv" if right else "lv")] = col
            return (jcount, [jtotal], {nm: cols[nm] for nm in names}), \
                lof | rof

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
        cols = self.block().to_numpy()  # wide pairs decoded
        return [(k, (lv, rv)) for k, lv, rv in zip(
            cols[KEY].tolist(), cols["lv"].tolist(), cols["rv"].tolist())]


def _join_name(nm: str, prefix: str) -> str:
    """VALUE -> lv / rv and VALUE.lo -> lv.lo / rv.lo."""
    return block_lib.lo_of(prefix) if block_lib.is_lo(nm) else prefix


class _GroupByKeyRDD(_ExchangeRDD):
    """Hash exchange, then a local key sort: the block holds key-sorted
    runs per shard. A hash-placed parent (a reduce or group output) skips
    the exchange, a key-sorted one the sort too. The launch defers like
    the reduce's (hinted capacities, settled at the next host read)."""

    hash_placed = True  # output rows live on shard hash(key) % n
    key_sorted = True

    def __init__(self, parent: DenseRDD):
        parent._check_sortable_key("group_by_key")
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
                exchange = self._resolve_exchange((blk,), slot, out_cap)
                bucket = (_bucket_cols(cols, n, self._key_dtype()) if n > 1
                          else torch.zeros_like(cols[KEY], dtype=torch.int32))
                cols, count, overflow = exchange(
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
    first = kernels.run_heads([cols[nm] for nm in (KEY, KEY_LO)
                               if nm in cols])
    return first & kernels.valid_mask(first.shape[1], count)


class _SortByKeyRDD(_ExchangeRDD):
    """Sample sort: a strided sample of each shard's keys comes back with
    the post-chain counts in one transfer (the one blocking read), the
    host picks n - 1 range bounds, then a range exchange and a local sort
    in the requested direction."""

    def __init__(self, parent: DenseRDD, ascending: bool):
        parent._check_sortable_key("sort_by_key")
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
        # a NaN key goes to the last range (range_bucket), never a bound
        samples = [x[~np.isnan(x)] if x.dtype.kind == "f" else x
                   for x in samples]
        samples = [x for x in samples if len(x)]
        if samples:
            allk = np.sort(np.concatenate(samples))
            if not self.ascending:
                allk = allk[::-1]
            return allk[[int(len(allk) * i / n) for i in range(1, n)]]
        if self.wide_key:
            return np.zeros((n - 1,), np.int64)
        dt = coltypes.physical(dict(self.parent._schema())[KEY])
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
            exchange = self._resolve_exchange((blk,), slot, out_cap)
            cols, count = source()
            cols = dict(cols)
            if n == 1:
                bucket = torch.zeros_like(cols[KEY], dtype=torch.int32)
            else:
                bucket = kernels.range_bucket(
                    bounds_dev, cols[KEY], ascending, bounds_lo=bounds_lo_dev,
                    keys_lo=cols.get(lo_name))
            cols, count, overflow = exchange(
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
                {nm: np.zeros(0, dtype=coltypes.numpy_dtype(schema[nm]))
                 for nm in (KEY, VALUE)}, self.mesh)
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


class _DenseUnionRDD(DenseRDD):
    """Per-shard concatenation of two RDDs of one schema: each shard's
    rows of the first, then of the second, compacted into a capacity
    sized from the host counts when both sides know them (else the sum of
    the capacities). Hash-placed when both sides are."""

    def __init__(self, first: DenseRDD, second: DenseRDD):
        super().__init__(first.context, first.mesh, [first, second])
        self.first = first
        self.second = second

    @property
    def hash_placed(self) -> bool:
        return self.first.hash_placed and self.second.hash_placed

    def _settle_placement(self) -> None:
        self.first._settle_placement()
        self.second._settle_placement()

    def _schema(self):
        return self.first._schema()

    def _materialize(self) -> Block:
        a, b = self.first.block(), self.second.block()
        counts_host = None
        if a.counts_host is not None and b.counts_host is not None:
            counts_host = a.counts_host + b.counts_host
            out_cap = block_lib._round_capacity(
                max(int(counts_host.max()), 1))
        else:
            out_cap = block_lib._round_capacity(a.capacity + b.capacity)
        idx = torch.arange(a.capacity + b.capacity,
                           device=self.mesh.device)[None, :]
        keep = (idx < a.counts[:, None]) | (
            (idx >= a.capacity) & (idx < a.capacity + b.counts[:, None]))
        cols, count = kernels.compact(
            {nm: torch.cat([a.cols[nm], b.cols[nm]], dim=1)
             for nm, _ in self._schema()}, keep, out_cap)
        return Block(cols=cols, counts=count, capacity=out_cap,
                     mesh=self.mesh, counts_host=counts_host)


class _DenseZipRDD(DenseRDD):
    """(left value, right value) of co-indexed rows; the per-shard counts
    must be equal."""

    def __init__(self, left: DenseRDD, right: DenseRDD):
        super().__init__(left.context, left.mesh, [left, right])
        self.left = left
        self.right = right

    def _schema(self):
        return ((KEY, dict(self.left._schema())[VALUE]),
                (VALUE, dict(self.right._schema())[VALUE]))

    def _dicts(self):
        # each side keeps its own dictionary (a zip compares nothing)
        out = {}
        ld = self.left._dicts().get(VALUE)
        rd = self.right._dicts().get(VALUE)
        if ld is not None:
            out[KEY] = ld
        if rd is not None:
            out[VALUE] = rd
        return out

    def _materialize(self) -> Block:
        lb, rb = self.left.block(), self.right.block()
        if not np.array_equal(lb.counts_np, rb.counts_np):
            raise VegaError(
                "dense zip requires equal per-shard counts; repartition "
                "first (vega_tpu_torch has no host tier to zip rows)")
        cap = max(lb.capacity, rb.capacity)

        def padded(col):
            if col.shape[1] == cap:
                return col
            out = col.new_zeros((col.shape[0], cap))
            out[:, :col.shape[1]] = col
            return out
        return Block(cols={KEY: padded(lb.cols[VALUE]),
                           VALUE: padded(rb.cols[VALUE])},
                     counts=lb.counts, capacity=cap, mesh=self.mesh,
                     counts_host=lb.counts_np)


class _ZipWithIndexRDD(DenseRDD):
    """(value, global index): shard s's rows count on from the rows of the
    shards before it (an exclusive cumsum of the counts on the device)."""

    def __init__(self, parent: DenseRDD):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._dict_renames = {KEY: VALUE}  # the index is fresh

    def _schema(self):
        return ((KEY, dict(self.parent._schema())[VALUE]),
                (VALUE, torch.int32))

    def _materialize(self) -> Block:
        blk = self.parent.block()
        counts = blk.counts.to(torch.int64)
        offsets = torch.cumsum(counts, 0) - counts
        pos = (offsets[:, None] + torch.arange(
            blk.capacity, device=counts.device)[None, :]).to(torch.int32)
        return Block(cols={KEY: blk.cols[VALUE], VALUE: pos},
                     counts=blk.counts, capacity=blk.capacity,
                     mesh=self.mesh, counts_host=blk.counts_host)


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


class _DenseCoGroupRDD(_HostTierRefusals):
    """cogroup over two device group_by_keys (one hash placement, so
    co-keyed rows share a shard). The reference's node is a host-tier RDD;
    the port has no host tier, so this object carries its three actions:
    collect, collect_grouped and count (every other name of the
    reference's RDD API raises VegaError)."""

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


def _last_unmarked(row):
    return row[-1] == 0


class _DenseRightOuterJoin(_HostTierRefusals):
    """right_outer_join's result: the device inner join of the two sides,
    and the right side's rows whose key the left lacks (a left outer join
    of the right against the left's deduplicated keys, marked 1, kept
    where the mark is the fill 0). collect() gives (k, (lv, rv)) rows, then
    (k, (None, rv)) rows; count() sums the two row counts. Every other
    name of the reference's RDD API raises VegaError."""

    def __init__(self, left: DenseRDD, right: DenseRDD):
        self.mesh = left.mesh
        self.inner = _JoinRDD(left, right)
        marks = _ReduceByKeyRDD(_OnesValueRDD(left), "min")
        probe = _JoinRDD(right, marks, outer=True, fill_value=0)
        self.unmatched = _FilterRDD(probe, _last_unmarked).select(KEY, "lv")

    def collect(self) -> list:
        cols = self.unmatched.collect_arrays()
        return self.inner.collect() + [
            (k, (None, rv)) for k, rv in zip(cols[KEY].tolist(),
                                             cols["lv"].tolist())]

    def count(self) -> int:
        return self.inner.count() + self.unmatched.count()


def _shard_group_keys(blk: Block) -> List[np.ndarray]:
    """Each shard's distinct keys (int64 for a wide key), from a grouped
    block's key-sorted runs: the first-of-run mask and the key words come
    back in one transfer per column, never the values."""
    counts = blk.counts_np
    key_cols = {nm: c for nm, c in blk.cols.items() if nm in (KEY, KEY_LO)}
    first = _run_starts(key_cols, blk.counts).cpu().numpy()
    host = block_lib.decode_wide_cols(
        {nm: c.cpu().numpy() for nm, c in key_cols.items()})[KEY]
    return [host[s, :counts[s]][first[s, :counts[s]]]
            for s in range(blk.n_shards)]
