"""DStreams: the port's copy of vega_tpu/streaming/dstream.py.

A DStream is a recipe: a chain of transformations rooted at one input
stream. Every batch interval the StreamingContext makes the input's
blocks a StreamBlockRDD (one partition per block) and applies the recipe
to it, giving an ordinary host lineage (rdd/): its rows can be lifted
onto the card with dense() like any other.

Only the output operations (foreach_rdd, update_state_by_key) do work.
window(n) widens the input to the last n batches' blocks; a block leaves
the store once no window reaches it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


class StreamBlockRDD(RDD):
    """One micro-batch's input: one partition per receiver block, read
    from the store (its replay handle on a miss)."""

    def __init__(self, ctx, blocks: List):
        super().__init__(ctx)
        self._blocks = list(blocks)

    @property
    def num_partitions(self) -> int:
        return max(1, len(self._blocks))

    def splits(self) -> List[Split]:
        if not self._blocks:
            return [Split(0, payload=None)]
        return [Split(i, payload=b) for i, b in enumerate(self._blocks)]

    def compute(self, split: Split, task_context=None) -> Iterator:
        block = split.payload
        if block is None:
            return iter(())
        return iter(block.records())


class DStream:
    """A transformation recipe over one input stream: source is the root
    InputStream (context.py); window_intervals is how many recent
    batches of blocks feed one compilation (1: this batch only)."""

    def __init__(self, sctx, source, transform: Optional[Callable] = None,
                 window: int = 1):
        self.sctx = sctx
        self.source = source
        self._transform = transform if transform is not None else (
            lambda rdd: rdd)
        self.window_intervals = window

    # --- transformations ----------------------------------------------------
    def _derive(self, f: Callable[[RDD], RDD]) -> "DStream":
        inner = self._transform
        return DStream(self.sctx, self.source,
                       lambda rdd: f(inner(rdd)), self.window_intervals)

    def map(self, f: Callable) -> "DStream":
        return self._derive(lambda rdd: rdd.map(f))

    def filter(self, f: Callable) -> "DStream":
        return self._derive(lambda rdd: rdd.filter(f))

    def flat_map(self, f: Callable) -> "DStream":
        return self._derive(lambda rdd: rdd.flat_map(f))

    def map_partitions(self, f: Callable) -> "DStream":
        return self._derive(lambda rdd: rdd.map_partitions(f))

    def reduce_by_key(self, func: Callable,
                      partitioner_or_num: Any = None) -> "DStream":
        return self._derive(
            lambda rdd: rdd.reduce_by_key(func, partitioner_or_num))

    def window(self, length_intervals: int) -> "DStream":
        """The input widened to the last length_intervals batches (a
        sliding aggregate, recomputed every batch from kept blocks)."""
        if length_intervals < 1:
            raise ValueError("window length must be >= 1 interval")
        return DStream(self.sctx, self.source, self._transform,
                       max(self.window_intervals, length_intervals))

    # --- outputs ------------------------------------------------------------
    def foreach_rdd(self, fn: Callable[[RDD, int], Any]) -> "DStream":
        """fn(rdd, batch_id) every batch, on the batch loop's thread, whose
        "pool" property is the stream's pool."""
        self.sctx._register_output(self, fn)
        return self

    def update_state_by_key(self, func: Optional[Callable] = None, *,
                            op: Optional[str] = None,
                            num_partitions: int = 2):
        """A stateful fold over (key, value) records; returns the
        StatefulStream handle. Exactly one of:
          op    a named monoid ('add', 'min', 'max', 'prod'): each batch
                is reduced by key on the Context's device
                (state_fold.fold_pairs_device) where its pairs have a
                dense form, on the host otherwise, with the same result,
                and combined with the old state by the same op;
          func  func(values, old_state) -> new_state on the host, values
                the key's batch values in offset order; None deletes the
                key."""
        if (func is None) == (op is None):
            raise ValueError(
                "update_state_by_key takes exactly one of func= or op=")
        return self.sctx._register_stateful(self, func=func, op=op,
                                            num_partitions=num_partitions)

    # --- compile ------------------------------------------------------------
    def compile(self, batch_rdd: RDD) -> RDD:
        """One interval: the recipe applied to the batch's input RDD."""
        return self._transform(batch_rdd)
