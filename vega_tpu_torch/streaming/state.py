"""Exactly-once streaming state: the port's copy of
vega_tpu/streaming/state.py.

Every state change goes through StateStore.apply_batch, which (1) merges
the batch's per-key updates into the in-memory state, (2) writes the
whole state through CheckpointRDD.write (part files, each to a temporary
name replaced into place) and (3) publishes one (batch_id, offsets,
state_dir) record through the CommitLog. A crash at any point leaves the
previous commit or the new one; recover() loads the latest committed
state and gives the offsets to resume the sources from, so the
uncommitted batch replays and gives the same state.

Batch ids are monotone, so a replayed commit (batch_id at or below the
last committed) is found by one compare and skipped: counted in
duplicate_commits and posted as StateCheckpointed(duplicate=True).
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import time
from typing import Any, Dict, Optional

from vega_tpu_torch.scheduler import events
from vega_tpu_torch.rdd.checkpoint import CheckpointRDD, CommitLog

log = logging.getLogger(__name__)


class StateStore:
    """Per-key state of one stateful stream, committed exactly once."""

    KEEP_STATE_DIRS = 2  # the latest commit's and the one before it

    def __init__(self, ctx, directory: str, num_partitions: int = 2):
        self.ctx = ctx
        self.directory = directory
        self.num_partitions = max(1, num_partitions)
        os.makedirs(directory, exist_ok=True)
        self.log = CommitLog(os.path.join(directory, "commits"))
        self._state: Dict[Any, Any] = {}
        self.last_committed_batch = -1
        self.commits = 0
        self.duplicate_commits = 0

    # --- queries ------------------------------------------------------------
    def snapshot(self) -> Dict[Any, Any]:
        return dict(self._state)

    def get(self, key, default=None):
        return self._state.get(key, default)

    # --- recovery -----------------------------------------------------------
    def recover(self) -> Optional[Dict[int, int]]:
        """Load the latest committed state; returns its source offsets
        ({stream_id: offset}), or None when nothing has committed."""
        rec = self.log.latest()
        if rec is None:
            return None
        state_dir = rec["state_dir"]
        state: Dict[Any, Any] = {}
        for i in range(rec["num_partitions"]):
            path = os.path.join(state_dir, f"part-{i:05d}.ckpt")
            with open(path, "rb") as f:
                state.update(pickle.load(f))
        self._state = state
        self.last_committed_batch = rec["batch_id"]
        log.info("streaming state recovered: batch %d, %d keys",
                 self.last_committed_batch, len(state))
        return {int(k): v for k, v in rec.get("offsets", {}).items()}

    # --- commit -------------------------------------------------------------
    def apply_batch(self, batch_id: int, offsets: Dict[int, int],
                    updates: Dict[Any, Any]) -> bool:
        """Merge updates (each touched key's new value; None deletes the
        key), write the state, publish the commit. False, with no effect,
        for a batch_id already committed."""
        start = time.time()
        if batch_id <= self.last_committed_batch:
            self.duplicate_commits += 1
            self._emit(batch_id, duplicate=True, wall_s=0.0)
            log.warning("duplicate state commit for batch %d skipped "
                        "(last committed %d)", batch_id,
                        self.last_committed_batch)
            return False
        for key, value in updates.items():
            if value is None:
                self._state.pop(key, None)
            else:
                self._state[key] = value
        state_dir = os.path.join(self.directory, f"state-{batch_id:010d}")
        try:
            items = sorted(self._state.items())
        except TypeError:  # keys of mixed types: by repr
            items = sorted(self._state.items(), key=lambda kv: repr(kv[0]))
        CheckpointRDD.write(
            self.ctx.parallelize(items, self.num_partitions), state_dir)
        self.log.commit(batch_id, {
            "offsets": {str(k): v for k, v in offsets.items()},
            "state_dir": state_dir,
            "num_partitions": self.num_partitions,
            "keys": len(self._state),
        })
        self.last_committed_batch = batch_id
        self.commits += 1
        self._prune()
        self._emit(batch_id, duplicate=False, wall_s=time.time() - start)
        return True

    # --- internal -----------------------------------------------------------
    def _prune(self) -> None:
        """Remove the state directories older than the last
        KEEP_STATE_DIRS; the small commit records stay."""
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith("state-"))
        except OSError:
            return
        for name in names[:-self.KEEP_STATE_DIRS]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)

    def _emit(self, batch_id: int, duplicate: bool, wall_s: float) -> None:
        self.ctx.bus.post(events.StateCheckpointed(
            batch_id=batch_id, keys=len(self._state),
            wall_s=round(wall_s, 6), duplicate=duplicate))
