"""Device forms of the RDD API names the reference answers on its host tier.

The reference's DenseRDD inherits these from its host RDD (vega_tpu/rdd/
base.py), which runs them over the rows of each partition; on the port a
partition is a shard, and each name computes on the device what the host
tier computes over those rows:

* sample(True, fraction, seed): the reference's PoissonSampler stream per
  shard (random.py), each row repeated on the device (_PoissonSampleRDD).
* random_split(weights, seed): one _CellSampleRDD per weight band, each
  keeping the rows whose BernoulliCellSampler draw falls in its band.
* count_approx_distinct(relative_sd): HyperLogLog registers built on the
  device from the rows' hash_key (hll.py), estimated on the host.
* collect_async / count_async / reduce_async: the device work here, the
  read on a job of the job server (scheduler/jobserver.py submit_call).

The other host-tier names (take_sample, count_approx, mean_approx,
count_by_value_approx, to_local_iterator,
for_each, for_each_partition, save_as_text_file, ...) are the host RDD's
own (rdd/base.py), over the shards' rows (DenseRDD.compute) and the
device forms above.

The draws of the samplers stay on the host (numpy, per shard); only the
repeat counts or keep masks travel to the device, once."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import coltypes
from vega_tpu_torch import dense_rdd as dr
from vega_tpu_torch import hll
from vega_tpu_torch import kernels
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch import random as vrandom
from vega_tpu_torch.block import Block
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.rdd.base import RDD


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _local_rows(mesh, blk: Block, per_shard, dtype) -> np.ndarray:
    """[n_local, capacity] host array of this process's shards, row i of
    shard s holding per_shard(s, count)[i] (zeros past the count)."""
    counts = blk.counts_np
    out = np.zeros((mesh.n_local, blk.capacity), dtype)
    for i in range(mesh.n_local):
        s = mesh.first_shard + i
        c = int(counts[s])
        out[i, :c] = per_shard(s, c)
    return out


class _PoissonSampleRDD(dr.DenseRDD):
    """sample(True, fraction, seed): row i of shard s repeated
    rng.poisson(fraction) times, its copies adjacent and in row order, as
    the reference's PoissonSampler yields them. A chain break: the draws
    need the parent's host counts."""

    def __init__(self, parent: dr.DenseRDD, fraction: float,
                 seed: Optional[int]):
        super().__init__(parent.context, parent.mesh, [parent])
        self.parent = parent
        self._sampler = vrandom.PoissonSampler(fraction, seed)

    def _schema(self):
        return self.parent._schema()

    def _fp_extra(self):
        return ("poisson", self._sampler.fraction, self._sampler.seed)

    def _materialize(self) -> Block:
        blk = self.parent.block()
        mesh = self.mesh
        counts = blk.counts_np
        # every process draws every shard's stream: the output capacity
        # (the largest total) is then the same everywhere with no fetch
        reps = [self._sampler.counts(int(counts[s]), s)
                for s in range(self.n_shards)]
        totals = np.array([int(r.sum()) for r in reps], np.int64)
        if totals.max(initial=0) > kernels.INT32_MAX:
            raise VegaError("sample(with_replacement=True): a shard's "
                            "sample passes 2^31 rows")
        cap = block_lib._round_capacity(max(int(totals.max(initial=0)), 1))
        local = _local_rows(mesh, blk, lambda s, c: reps[s][:c], np.int64)
        m = torch.from_numpy(local).to(mesh.device)  # the one copy
        owner, _, _ = kernels.ragged_expand(m, cap)
        counts_out = totals.astype(np.int32)
        cols = {}
        for nm, c in blk.cols.items():  # a value may have trailing dims
            idx = owner.view(owner.shape + (1,) * (c.dim() - 2))
            cols[nm] = torch.gather(c, 1, idx.expand(
                owner.shape + c.shape[2:]))
        return Block(cols=cols, counts=mesh_lib.host_put(mesh, counts_out),
                     capacity=cap, mesh=mesh, counts_host=counts_out)


class _CellSampleRDD(dr._NarrowRDD):
    """One band [lb, ub) of random_split: shard s keeps row i when the
    i-th draw of its BernoulliCellSampler stream falls in the band, and
    compacts stably (placement and key order pass through). Every band
    of a split draws the same streams. A chain break: the draws need the
    parent's host counts."""

    _keeps_counts = False
    _keeps_placement = True
    _chainable = False

    def __init__(self, parent: dr.DenseRDD, lb: float, ub: float,
                 seed: Optional[int]):
        super().__init__(parent, parent._schema())
        self._sampler = vrandom.BernoulliCellSampler(lb, ub, seed=seed)

    def _fp_extra(self):
        s = self._sampler
        return ("cell", s.lb, s.ub, s.seed)

    def _materialize(self) -> Block:
        blk = self.parent.block()
        mesh = self.mesh
        sampler = self._sampler
        keep = _local_rows(mesh, blk, lambda s, c: sampler.keep(
            sampler.draws(c, s)), bool)
        keep = torch.from_numpy(keep).to(mesh.device)  # the one copy
        cols, count = kernels.compact(dict(blk.cols), keep, blk.capacity)
        return Block(cols=cols, counts=count, capacity=blk.capacity,
                     mesh=mesh)


def random_split(node, weights, seed=None) -> List[dr.DenseRDD]:
    """The reference's random_split: the weights normalized into bands
    [0, w0), [w0, w0 + w1), ..., one _CellSampleRDD each."""
    total = sum(weights)
    bounds = [0.0]
    for w in weights:
        bounds.append(bounds[-1] + w / total)
    return [_CellSampleRDD(node, lb, ub, seed)
            for lb, ub in zip(bounds, bounds[1:])]


# ---------------------------------------------------------------------------
# count_approx_distinct
# ---------------------------------------------------------------------------


def _column_hash(node, blk: Block, name: str) -> torch.Tensor:
    """hash_key of each value of one logical column (a wide pair by its
    base name)."""
    schema = dict(node._schema())
    dicts = node._dicts()
    col = blk.cols[name]
    lo = block_lib.lo_of(name)
    if name in dicts:
        table = torch.from_numpy(hll.hash_strings(dicts[name])).to(
            col.device)
        return hll.hash_column(col, "str", table)
    if lo in blk.cols:
        return hll.hash_column(kernels.wide_i64(col, blk.cols[lo]), "int")
    dt = schema[name]
    if dt == torch.bool:
        return hll.hash_column(col, "bool")
    row = coltypes.to_row(col, dt)
    if isinstance(row, coltypes.RowTensor):
        row = row.as_subclass(torch.Tensor)
    return hll.hash_column(row, "float" if dt.is_floating_point else "int")


def count_approx_distinct(node, relative_sd: float = 0.05) -> int:
    """The reference's HyperLogLog estimate of the number of distinct
    rows, its registers built on the device. Where a row holds a list (a
    grouped node, a column with trailing dims), the host RDD layer's,
    which fails hashing it as the reference's does."""
    p = hll.precision_for(relative_sd)
    tree = node._row_tree()
    blk = node.block()
    if tree is None or any(c.dim() > 2 for c in blk.cols.values()):
        return RDD.count_approx_distinct(node, relative_sd)

    def hashed(tree):
        if isinstance(tree, tuple):
            return hll.hash_tuple([hashed(t) for t in tree])
        return _column_hash(node, blk, tree)

    h = hashed(tree)
    valid = kernels.valid_mask(blk.capacity, blk.counts)
    reg = hll.registers(h, valid, p).to(torch.uint8)
    merged = mesh_lib.host_get(blk.mesh, reg).max(axis=0)
    return hll.estimate(merged)


# ---------------------------------------------------------------------------
# asynchronous actions
# ---------------------------------------------------------------------------


def collect_async(node):
    """The lineage materializes here; the job's thread reads the block
    and forms the rows (across processes the rows are read here too)."""
    blk = node.block()
    if blk.mesh.collective:
        rows = node._collect_block(blk)
        return node.context._submit_call(lambda: rows)
    return node.context._submit_call(lambda: node._collect_block(blk))


def count_async(node):
    if type(node).count is not dr.DenseRDD.count or node.mesh.collective:
        n = node.count()
        return node.context._submit_call(lambda: n)
    blk = node.block()
    return node.context._submit_call(lambda: blk.num_rows)


def reduce_async(node, f):
    """reduce(f)'s checks and device launch here, its fetch and host fold
    on the job's thread (here too across processes); an empty RDD raises
    VegaError through the future."""
    finish = node._reduce_launch(f, traced=False)
    if node.mesh.collective:
        try:
            value = finish()
        except Exception as e:  # noqa: BLE001 — surfaces via result()
            err = e

            def fail():
                raise err
            return node.context._submit_call(fail)
        return node.context._submit_call(lambda: value)
    return node.context._submit_call(finish)
