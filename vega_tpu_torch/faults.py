"""Fault injection for the local runtime: the port's copy of the hooks of
vega_tpu/faults.py that the local scheduler, the shuffle store and the
streaming receivers consult.

  maybe_slow_task()           local backend, inside a task's timed
                              window: the first SLOW_TASKS tasks sleep
                              SLOW_TASK_S seconds (a straggler)
  corrupt_spilled(disk, key)  shuffle store, after a bucket spills: flip
                              the last payload byte of the first
                              CORRUPT_SPILL_N spilled buckets (the
                              checksummed read turns it into a miss)
  maybe_crash_receiver(n)     streaming receiver, after it lands a block:
                              raise once it has landed
                              RECEIVER_CRASH_AFTER_BLOCKS blocks

Each is armed in process by configure(field=value) (the reference also
reads VEGA_TPU_FAULT_* environment variables, for its worker processes);
every decision counts down (the first N), none is random. The
reference's hooks of its executors and shuffle servers, and its
VEGA_TPU_FAULT_* variables, wait for ROADMAP queue 1 item 11:
configure() with one of them, and a distributed Context started with
one of the variables set, raise VegaError naming the item."""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from vega_tpu_torch.errors import VegaError

log = logging.getLogger(__name__)


class FaultInjector:
    def __init__(self):
        self.slow_tasks = 0
        self.slow_task_s = 5.0
        self.corrupt_spill_n = 0
        self.receiver_crash_after_blocks = 0
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self.slow_tasks or self.corrupt_spill_n
                    or self.receiver_crash_after_blocks)

    def maybe_slow_task(self) -> None:
        if not (self.active and self.slow_tasks):
            return
        with self._lock:
            if self.slow_tasks <= 0:
                return
            self.slow_tasks -= 1
        log.warning("FAULT: slowing task by %.1fs (straggler)",
                    self.slow_task_s)
        time.sleep(self.slow_task_s)

    def maybe_crash_receiver(self, blocks_landed: int) -> None:
        if not (self.active and self.receiver_crash_after_blocks):
            return
        with self._lock:
            if self.receiver_crash_after_blocks <= 0 \
                    or blocks_landed < self.receiver_crash_after_blocks:
                return
            self.receiver_crash_after_blocks = 0
        log.warning("FAULT: crashing streaming receiver after %d blocks",
                    blocks_landed)
        raise RuntimeError("FAULT: injected receiver crash")

    def corrupt_spilled(self, disk_store, key: str) -> None:
        if not (self.active and self.corrupt_spill_n):
            return
        with self._lock:
            if self.corrupt_spill_n <= 0:
                return
            self.corrupt_spill_n -= 1
        path = disk_store.path_of(key)
        if path is None:
            return
        try:
            with open(path, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
        except OSError:
            log.warning("FAULT: corrupt_spilled(%s) could not write", key)
            return
        log.warning("FAULT: corrupted spilled bucket %s", key)


# the reference's executor and shuffle-server hooks (not ported yet)
REFERENCE_ONLY_FIELDS = (
    "kill_after_tasks", "hang_tasks", "suppress_heartbeats",
    "fetch_drop_n", "fetch_delay_s", "fetch_stream_drop_n",
    "fetch_drop_after_buckets", "push_drop_n", "merged_delay_s",
    "parity_corrupt_n", "drop_binary_n", "decommission_hang_s",
    "stats_dir")
_NOT_PORTED = ("is not ported yet: ROADMAP queue 1 item 11 (the worker, "
               "shuffle-server and elastic fault hooks)")


def check_environ(environ=None) -> None:
    """VegaError when a VEGA_TPU_FAULT_* variable is set."""
    env = os.environ if environ is None else environ
    names = sorted(k for k in env if k.startswith("VEGA_TPU_FAULT_"))
    if names:
        raise VegaError(f"{', '.join(names)} {_NOT_PORTED}")


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def get() -> FaultInjector:
    """The process's injector (nothing armed until configure)."""
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = FaultInjector()
    return _injector


def configure(**fields) -> FaultInjector:
    """A fresh injector with the given fields armed."""
    global _injector
    with _injector_lock:
        inj = FaultInjector()
        for name, value in fields.items():
            if name in REFERENCE_ONLY_FIELDS:
                raise VegaError(f"fault field {name} {_NOT_PORTED}")
            if not hasattr(inj, name):
                raise AttributeError(f"unknown fault field: {name}")
            setattr(inj, name, value)
        _injector = inj
    return inj


def reset() -> None:
    """Disarm every hook."""
    global _injector
    with _injector_lock:
        _injector = None
