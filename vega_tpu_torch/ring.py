"""Ring and staged exchanges: bounded-memory alternatives to all_to_all.

Counterpart of vega_tpu/tpu/ring.py, with kernels.bucket_exchange's
contract: (cols [n_shards, out_capacity], count int32[n_shards],
overflow bool[n_shards]). kernels.bucket_exchange builds its [src, dst,
slot] send buffers for all n targets at once, so its transients grow with
n^2 slots per column on the one device that holds every shard. These move
rows in rounds of `group` shifts instead: in the round of shifts s, each
shard i sends the slot of rows bound for shard (i + s) % n. On one device
that is a gather, for each receiver j, from the grouped block of source
(j - s) % n at starts[(j - s) % n, j] (the reference's ppermute by s), and
each round's arrivals land in one scatter per column at each receiver's
running write position. No buffer spans all n targets: a round holds
group slots of each shard per column (the gathered rows and the scatter's
index), within the 3 * group * slot rows the planner charges
(exchange_plan.transient_rows), over ceil((n - 1) / group) rounds.

Arrival order equals the reference's: a receiver's own rows first, then
those of shards (j - 1) % n, (j - 2) % n, ... in round order, so a collect
with duplicate keys equals the reference's ring leg row for row.

group = 1 is the classic ring (ring_exchange); group = n - 1 is one round
as wide as the one-shot's buffers. The planner (exchange_plan.py) picks
the group per launch; Context(dense_exchange=...) or an op's exchange=
forces a program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from vega_tpu_torch import kernels

Cols = Dict[str, torch.Tensor]


def ring_exchange(cols: Cols, count: torch.Tensor, bucket: torch.Tensor,
                  n_shards: int, slot_capacity: int, out_capacity: int,
                  pregrouped: bool = False, sort_impl: str = "xla"
                  ) -> Tuple[Cols, torch.Tensor, torch.Tensor]:
    """kernels.bucket_exchange's drop-in at one slot per round: the
    staged exchange at group = 1, n - 1 rounds."""
    return staged_exchange(cols, count, bucket, n_shards, slot_capacity,
                           out_capacity, pregrouped=pregrouped,
                           sort_impl=sort_impl, group=1)


def staged_exchange(cols: Cols, count: torch.Tensor, bucket: torch.Tensor,
                    n_shards: int, slot_capacity: int, out_capacity: int,
                    pregrouped: bool = False, sort_impl: str = "xla",
                    group: int = 1
                    ) -> Tuple[Cols, torch.Tensor, torch.Tensor]:
    """The exchange in ceil((n - 1) / group) rounds of `group` shifts,
    after a round 0 that keeps each shard's own bucket. pregrouped: rows
    are already contiguous per bucket, so grouping is the histogram alone;
    else _group_by_bucket groups them (the digit_hist and partition_pos
    kernels). A shard's overflow flag is set when it has more rows for a
    target than slot_capacity, or receives more than out_capacity."""
    capacity = bucket.shape[1]
    if n_shards == 1:
        return kernels.passthrough_exchange(cols, count, capacity,
                                            out_capacity)
    group = max(1, min(int(group), n_shards - 1))
    mask = kernels.valid_mask(capacity, count)
    bucket = torch.where(mask, bucket, n_shards)  # invalid rows -> ghost
    if pregrouped:
        counts_to, starts = kernels.pregrouped_group(bucket, n_shards)
        grouped = cols
    else:
        grouped, counts_to, starts = kernels._group_by_bucket(
            cols, bucket, n_shards, sort_impl=sort_impl)
    overflow = (counts_to > slot_capacity).any(dim=1)
    counts_to = counts_to.to(torch.int64).clamp_(max=slot_capacity)
    starts = starts.to(torch.int64)

    dev = bucket.device
    recv = torch.arange(n_shards, device=dev)            # receiver j
    slot_ar = torch.arange(slot_capacity, device=dev)
    dump = n_shards * out_capacity                         # dropped rows
    flat_in = {nm: c.reshape((-1,) + c.shape[2:]) for nm, c in
               grouped.items()}
    out = {nm: c.new_zeros((dump + 1,) + c.shape[2:])
           for nm, c in cols.items()}
    write_pos = torch.zeros(n_shards, dtype=torch.int64, device=dev)

    def append_round(shifts):
        """Receive the slots of `shifts` and append them, in shift order,
        at each receiver's write position: one gather and one scatter per
        column over the round's [n, g * slot] rows."""
        nonlocal write_pos
        s = torch.tensor(shifts, dtype=torch.int64, device=dev)
        src = (recv[:, None] - s[None, :]) % n_shards       # [n, g]
        rows = counts_to[src, recv[:, None]]                 # [n, g]
        start = starts[src, recv[:, None]]
        at = (start[:, :, None] + slot_ar).clamp_(max=capacity - 1)
        gather_idx = (src[:, :, None] * capacity + at).reshape(-1)
        offs = torch.cumsum(rows, dim=1) - rows              # exclusive
        pos = write_pos[:, None, None] + offs[:, :, None] + slot_ar
        keep = (slot_ar < rows[:, :, None]) & (pos < out_capacity)
        dest = torch.where(keep, recv[:, None, None] * out_capacity + pos,
                           dump).reshape(-1)
        del at, pos, keep
        for nm, col in flat_in.items():
            out[nm].index_put_((dest,), col.index_select(0, gather_idx))
        write_pos = write_pos + rows.sum(dim=1)

    append_round([0])  # round 0: each shard keeps its own bucket
    for r0 in range(1, n_shards, group):
        append_round(list(range(r0, min(r0 + group, n_shards))))
    total_in = write_pos
    out_cols = {nm: buf[:-1].view((n_shards, out_capacity) + buf.shape[1:])
                for nm, buf in out.items()}
    return out_cols, total_in.to(torch.int32), \
        overflow | (total_in > out_capacity)
