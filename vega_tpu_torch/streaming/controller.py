"""Backpressure for the streaming plane: the port's copy of
vega_tpu/streaming/controller.py.

The bound is stream_queue_max_blocks receiver blocks landed and not yet
consumed by a completed batch, across all receivers. While the stream's
pool falls behind (its recent job-wall p95, MetricsListener.pool_latency,
above the batch interval) the bound halves. At the bound a receiver
parks until a batch drains blocks ("block": lossless) or drops the block
while advancing its offsets ("shed": counted).

load_signal() gives the pending blocks as queued demand to the elastic
fleet's controller (scheduler/elastic.py), as the reference's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from vega_tpu_torch.errors import VegaError

BACKPRESSURE_MODES = ("block", "shed")


class RateController:
    def __init__(self, conf, metrics, pool: str, interval_s: float):
        self.mode = conf.stream_backpressure_mode
        if self.mode not in BACKPRESSURE_MODES:
            raise VegaError(
                f"stream_backpressure_mode must be 'block' or 'shed', "
                f"got {self.mode!r}")
        self.max_blocks = max(1, conf.stream_queue_max_blocks)
        self.metrics = metrics
        self.pool = pool
        self.interval_s = interval_s
        # a plain Condition: the witness does not wrap one (wait() releases
        # and re-acquires it behind the wrapper's back)
        self._cond = threading.Condition()
        self._pending = 0
        self.max_depth_seen = 0
        self.shed_blocks = 0
        self.throttled_offers = 0

    # --- receivers ----------------------------------------------------------
    def offer_block(self, stop_event) -> str:
        """Called before a block lands: "land", "shed" (drop it, advance
        the offsets) or "stop" (the receiver stops while parked)."""
        bound = self._effective_bound()
        with self._cond:
            if self._pending < bound:
                return "land"
            self.throttled_offers += 1
            if self.mode == "shed":
                self.shed_blocks += 1
                return "shed"
            while self._pending >= self._effective_bound():
                self._cond.wait(0.05)
                if stop_event.is_set():
                    return "stop"
            return "land"

    def block_landed(self) -> None:
        with self._cond:
            self._pending += 1
            if self._pending > self.max_depth_seen:
                self.max_depth_seen = self._pending

    # --- batch loop ---------------------------------------------------------
    def blocks_consumed(self, n: int) -> None:
        """A batch of n blocks completed: the queue drains and parked
        receivers wake."""
        if n <= 0:
            return
        with self._cond:
            self._pending = max(0, self._pending - n)
            self._cond.notify_all()

    # --- signals ------------------------------------------------------------
    def _effective_bound(self) -> int:
        if self.behind():
            return max(1, self.max_blocks // 2)
        return self.max_blocks

    def behind(self) -> bool:
        lat = self.metrics.pool_latency().get(self.pool)
        return bool(lat) and lat["p95_s"] > self.interval_s

    def pending_blocks(self) -> int:
        with self._cond:
            return self._pending

    def load_signal(self) -> int:
        """Pending blocks, read as queued work units."""
        return self.pending_blocks()

    def status(self) -> Dict[str, Any]:
        lat = self.metrics.pool_latency().get(self.pool, {})
        with self._cond:
            pending = self._pending
            max_depth = self.max_depth_seen
            shed = self.shed_blocks
            throttled = self.throttled_offers
        return {
            "mode": self.mode,
            "interval_s": self.interval_s,
            "pending_blocks": pending,
            "queue_max_blocks": self.max_blocks,
            "max_depth_seen": max_depth,
            "shed_blocks": shed,
            "throttled_offers": throttled,
            "behind": bool(lat) and lat.get("p95_s", 0.0) > self.interval_s,
            "pool_latency": lat,
        }
