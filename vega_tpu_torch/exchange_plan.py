"""The exchange planner: a cost model that picks each exchange's program.

Counterpart of vega_tpu/tpu/exchange_plan.py, the same model and the same
choices. Given the launch-time facts of one exchange (shards, the static
per-shard capacity, slot and output capacities, row bytes) it estimates
each program's per-shard transient high-water mark and picks the program
with the fewest rounds whose estimate fits Context.dense_hbm_budget:

  all_to_all  kernels.bucket_exchange: one round; its [n_shards, slot]
              send and receive buffers per column grow with the shards;
  staged      ring.staged_exchange(group=g): ceil((n-1)/g) rounds of g
              shifts each, at most 3 * g slots per column live at once;
              the largest g that fits;
  ring        the staged program at g = 1, n-1 rounds: the least peak any
              program has, chosen when no larger group fits (even when it
              does not fit either: some program must run).

The estimate only chooses between programs that are all correct: the
(cols, count, overflow) contract, the n_shards == 1 passthrough and the
overflow -> grown-capacity retry hold for each.

Consumers: dense_rdd._ExchangeRDD._resolve_exchange (one plan per launch
under Context(dense_exchange="auto") or a forced program), and
stream.planned_chunk_rows (chunk sizing under "auto").

Across processes (Context(multihost=...)) every rank plans each launch
from the same global inputs (capacities sized from host_get's global
counts and histograms), so all ranks pick the same program and group and
run the same collectives. As in the reference (dense_rdd.py:3363), a
launch plans each shard against the whole dense_hbm_budget, at any
world size; only stream chunking (planned_stream_rows) divides it.

One recorded difference (memory_sharing_factor): the reference divides
the budget by n on its CPU backend only, where its n shards are virtual
devices of one memory; the port's n shards are always rows of tensors on
one device, so it divides by n on every device.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Optional

import numpy as np

from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)

MODES = ("auto", "all_to_all", "ring", "staged")


def check_mode(mode: str) -> str:
    """mode itself when it is one of MODES, else the reference's
    VegaError."""
    if mode not in MODES:
        raise VegaError(
            f"dense_exchange must be one of "
            f"{', '.join(repr(m) for m in MODES)}; got {mode!r}")
    return mode


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """One exchange launch's planned program. est_peak_bytes is the
    modeled per-shard transient high-water mark (operand block, its
    bucket-grouped copy, the program's buffers and the compacted output,
    all at static capacities); rounds counts exchange rounds (1 for the
    one-shot all_to_all, n-1 for ring, ceil((n-1)/group) for staged)."""

    program: str            # "all_to_all" | "ring" | "staged"
    n_shards: int
    rounds: int
    group: int              # shifts per round (staged; 1 ring, n-1 one-shot)
    est_peak_bytes: int     # per-shard transient estimate
    est_bytes_moved: int    # per-shard bytes moved (equal for every program)
    budget_bytes: int
    fits: bool              # est_peak_bytes <= budget_bytes


def row_bytes_of(dtypes_and_trailing) -> int:
    """Per-row bytes of a column schema: itemsize times the product of
    the trailing dims, summed over (dtype, trailing_shape) pairs."""
    total = 0
    for dt, trailing in dtypes_and_trailing:
        n = 1
        for d in trailing:
            n *= int(d)
        total += dt.itemsize * n
    return max(total, 1)


def block_row_bytes(blk) -> int:
    """Per-row bytes of a Block's columns ([n_shards, capacity, ...]
    tensors; trailing dims included)."""
    return row_bytes_of((c.dtype, c.shape[2:]) for c in blk.cols.values())


def transient_rows(program: str, n_shards: int, slot_capacity: int,
                   group: int = 1) -> int:
    """Program buffer rows live at once per column, per shard: the
    one-shot's send buffer and its received mirror (2 x [n, slot]); the
    staged / ring round's send slots, received slots and the append's
    contiguous copy (3 x [group, slot])."""
    if program == "all_to_all":
        return 2 * n_shards * slot_capacity
    if program == "ring":
        return 3 * slot_capacity
    return 3 * group * slot_capacity  # staged


def estimate_peak_bytes(program: str, n_shards: int, capacity: int,
                        slot_capacity: int, out_capacity: int,
                        row_bytes: int, group: int = 1,
                        blocks=None) -> int:
    """Per-shard transient estimate of one exchange program: operand +
    bucket-grouped copy + program buffers + compacted output; the
    n_shards == 1 passthrough builds neither buffers nor a grouped copy.

    blocks, [(capacity, row_bytes), ...], models a launch that moves
    several operand blocks (a join's two sides): every operand and output
    is live across the launch, but the sides exchange one after the
    other, so only the costliest side's grouped copy and buffers add to
    the peak. One block gives the one-block formula."""
    if blocks is None:
        blocks = [(capacity, row_bytes)]
    if n_shards == 1:
        return sum((cap + out_capacity) * rb for cap, rb in blocks)
    trans = transient_rows(program, n_shards, slot_capacity, group)
    resident = sum((cap + out_capacity) * rb for cap, rb in blocks)
    exchanging = max(cap * rb + trans * rb for cap, rb in blocks)
    return resident + exchanging


def _plan(program: str, n_shards: int, capacity: int, slot_capacity: int,
          out_capacity: int, row_bytes: int, budget_bytes: int,
          group: int, rounds: int, blocks=None) -> ExchangePlan:
    peak = estimate_peak_bytes(program, n_shards, capacity, slot_capacity,
                               out_capacity, row_bytes, group,
                               blocks=blocks)
    # worst case every valid row leaves its shard: capacity rows out and
    # up to out_capacity rows in, summed over the blocks the launch moves
    moved = sum(
        (min(cap, (n_shards - 1) * slot_capacity) + out_capacity) * rb
        for cap, rb in (blocks or [(capacity, row_bytes)])
    ) if n_shards > 1 else 0
    return ExchangePlan(
        program=program, n_shards=n_shards, rounds=rounds, group=group,
        est_peak_bytes=peak, est_bytes_moved=moved,
        budget_bytes=budget_bytes, fits=peak <= budget_bytes,
    )


def plan_exchange(n_shards: int, capacity: int, slot_capacity: int,
                  out_capacity: int, row_bytes: int, budget_bytes: int,
                  mode: str = "auto", blocks=None) -> ExchangePlan:
    """Plan one exchange launch. A forced mode takes its program (staged
    still picks the largest group that fits); "auto" takes the one-shot
    when it fits, else the staged program with the largest group that
    fits, else ring, logged when even ring does not fit. blocks as in
    estimate_peak_bytes (capacity / row_bytes then seed only the
    one-block case)."""
    check_mode(mode)
    if n_shards <= 1:
        # the passthrough: no exchange, no rounds
        return _plan("all_to_all", max(n_shards, 1), capacity,
                     slot_capacity, out_capacity, row_bytes, budget_bytes,
                     group=0, rounds=0, blocks=blocks)

    def one_shot():
        return _plan("all_to_all", n_shards, capacity, slot_capacity,
                     out_capacity, row_bytes, budget_bytes,
                     group=n_shards - 1, rounds=1, blocks=blocks)

    def ring():
        return _plan("ring", n_shards, capacity, slot_capacity,
                     out_capacity, row_bytes, budget_bytes,
                     group=1, rounds=n_shards - 1, blocks=blocks)

    def staged(group: int):
        rounds = -(-(n_shards - 1) // group)
        return _plan("staged", n_shards, capacity, slot_capacity,
                     out_capacity, row_bytes, budget_bytes,
                     group=group, rounds=rounds, blocks=blocks)

    if mode == "all_to_all":
        return one_shot()
    if mode == "ring":
        return ring()
    if mode == "staged":
        for g in range(n_shards - 1, 1, -1):
            p = staged(g)
            if p.fits:
                return p
        return staged(1)
    # auto; with the 3x slot coefficient a large group can cost more than
    # the one-shot (3(n-1) against 2n slots for n > 3): it then never fits
    # a budget the one-shot missed, and the search steps down
    p = one_shot()
    if p.fits:
        return p
    for g in range(n_shards - 1, 1, -1):
        s = staged(g)
        if s.fits:
            return s
    r = ring()
    if not r.fits:
        log.info(
            "exchange planner: even the ring program's estimated peak "
            "(%d B) exceeds dense_hbm_budget (%d B) — running it anyway "
            "(minimum possible footprint); shrink the block or stream",
            r.est_peak_bytes, r.budget_bytes)
    return r


def exchange_callable(plan: ExchangePlan):
    """The exchange function of a plan, the staged group bound: each takes
    the (cols, count, bucket, n_shards, slot, out_capacity, pregrouped=,
    sort_impl=) call every exchange site makes."""
    if plan.program == "ring":
        from vega_tpu_torch.ring import ring_exchange

        return ring_exchange
    if plan.program == "staged":
        from vega_tpu_torch.ring import staged_exchange

        return functools.partial(staged_exchange, group=plan.group)
    from vega_tpu_torch import kernels

    return kernels.bucket_exchange


# ---------------------------------------------------------------------------
# observability: module counters (the reference's); Context.exchange_plans
# aggregates per Context (new_plan_summary / add_to_summary)
# ---------------------------------------------------------------------------

_counters_lock = named_lock("exchange_plan._counters_lock")
_PLAN_COUNTS: Dict[str, int] = {}
_LAST_PLAN: Optional[ExchangePlan] = None


def record_plan(plan: ExchangePlan) -> None:
    global _LAST_PLAN
    with _counters_lock:
        _PLAN_COUNTS[plan.program] = _PLAN_COUNTS.get(plan.program, 0) + 1
        _LAST_PLAN = plan


def plan_counters() -> Dict[str, int]:
    """Launches planned per program since the process started or the
    last reset."""
    with _counters_lock:
        return dict(_PLAN_COUNTS)


def last_plan() -> Optional[ExchangePlan]:
    with _counters_lock:
        return _LAST_PLAN


def reset_plan_counters() -> None:
    global _LAST_PLAN
    with _counters_lock:
        _PLAN_COUNTS.clear()
        _LAST_PLAN = None


def new_plan_summary() -> Dict[str, int]:
    """The reference's metrics_summary()["exchange_plans"] fields."""
    return {"all_to_all": 0, "staged": 0, "ring": 0, "staged_rounds": 0,
            "max_est_peak_bytes": 0, "over_budget": 0}


def add_to_summary(summary: Dict[str, int], plan: ExchangePlan) -> None:
    """Fold one plan into a summary, as the reference's MetricsListener
    folds its DenseExchangePlanned event."""
    summary[plan.program] = summary.get(plan.program, 0) + 1
    if plan.program == "staged":
        summary["staged_rounds"] += plan.rounds
    summary["max_est_peak_bytes"] = max(summary["max_est_peak_bytes"],
                                        plan.est_peak_bytes)
    if not plan.fits:
        summary["over_budget"] += 1


# ---------------------------------------------------------------------------
# derived sizing: the per-shard budget share and streamed chunking
# ---------------------------------------------------------------------------


def memory_sharing_factor(n_shards: int) -> int:
    """How many shards share one memory space: the divisor between
    dense_hbm_budget and the budget one shard's exchange plans against.
    The port's n shards are rows of tensors on one device, on the CPU and
    on the card alike, so it is n (for n > 1) on every device. The
    reference gives n on its CPU backend (virtual devices of one host,
    which equals this) and 1 on a TPU or GPU, where each shard owns a
    device."""
    return n_shards if n_shards > 1 else 1


def per_shard_budget(n_shards: int, budget_bytes: int) -> int:
    """The budget one shard's exchange plans against."""
    return max(budget_bytes // memory_sharing_factor(n_shards), 1)


def _heuristic_caps(total_rows: int, n_shards: int):
    """The capacities an exchange over total_rows would run at: the
    per-shard capacity of an even split, slot and out from the launch's
    own sizing (dense_rdd._exchange_capacities) fed even per-shard counts,
    so the two cannot drift apart."""
    from vega_tpu_torch.block import _round_capacity
    from vega_tpu_torch.dense_rdd import _exchange_capacities

    n = max(n_shards, 1)
    per = max(-(-total_rows // n), 1)
    slot, out = _exchange_capacities(
        np.full(n, per, dtype=np.int64), n, attempt=0)
    return _round_capacity(per), slot, out


def predict_for_rows(total_rows: int, row_bytes: int, n_shards: int,
                     budget_bytes: int) -> ExchangePlan:
    """Plan an exchange from a row count before anything materializes,
    against the per-shard budget share."""
    cap, slot, out = _heuristic_caps(total_rows, n_shards)
    return plan_exchange(n_shards, cap, slot, out, row_bytes,
                         per_shard_budget(n_shards, budget_bytes),
                         mode="auto")


def planned_stream_rows(n_rows: int, bytes_per_row: int,
                        budget_bytes: int,
                        n_shards: int) -> Optional[int]:
    """Chunk rows of a streamed source: the largest chunk whose aggregate
    planned exchange peak (the per-shard plan against the per-shard
    budget share, times the shards sharing the memory) fits the budget;
    None when the whole source fits. A bounded plan's transients are a
    slice of the block, so chunks grow past the 6x rule's. The fit is
    monotone in rows (within one program peaks grow with capacity; at a
    switch the planner steps down to a cheaper program), as the binary
    search needs."""
    factor = memory_sharing_factor(n_shards)
    share = per_shard_budget(n_shards, budget_bytes)

    def fits(rows: int) -> bool:
        cap, slot, out = _heuristic_caps(rows, n_shards)
        plan = plan_exchange(n_shards, cap, slot, out, bytes_per_row,
                             share, mode="auto")
        return factor * plan.est_peak_bytes <= budget_bytes

    if fits(n_rows):
        return None
    lo, hi = 1, n_rows
    while lo < hi:  # the most rows whose aggregate peak fits
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return max(lo, 1)
