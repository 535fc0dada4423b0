"""Broadcast variables: the port's copy of vega_tpu/broadcast.py.

In one process a Broadcast is a holder: its value is shared by reference
through a module-level table keyed by the broadcast's id. Pickling
carries the id and the pickled value (pickled once, at the first
pickling), so a copy in a process that has no entry for the id
unpickles the value on first use and keeps it (the reference keeps it in
its BROADCAST cache key space). unpersist() drops both. As in the
reference, .value after unpersist() of a broadcast never pickled raises
TypeError (there is no payload to read), and a pickled one still gives
its payload's value. The payload is pickled by serialization.py, which
sends functions by value as the reference's cloudpickle does; an
executor process (mode="distributed") unpickles it once and keeps it.
"""

from __future__ import annotations

import itertools
import pickle
from typing import Any

from vega_tpu_torch import serialization
from vega_tpu_torch.lint.sync_witness import named_lock

_next_id = itertools.count(0)
_local_values: dict = {}
# values unpickled from a payload, by id
_loaded: dict = {}
_lock = named_lock("broadcast._lock")


class Broadcast:
    def __init__(self, _ctx, value: Any):
        self.id = next(_next_id)
        with _lock:
            _local_values[self.id] = value
        self._payload = None  # pickled at the first pickling

    @property
    def value(self) -> Any:
        with _lock:
            if self.id in _local_values:
                return _local_values[self.id]
            if self.id in _loaded:
                return _loaded[self.id]
        value = pickle.loads(self._payload)
        with _lock:
            _loaded[self.id] = value
        return value

    def unpersist(self) -> None:
        with _lock:
            _local_values.pop(self.id, None)
            _loaded.pop(self.id, None)

    def __getstate__(self):
        if self._payload is None:
            with _lock:
                value = _local_values.get(self.id)
            self._payload = serialization.dumps(value)
        return {"id": self.id, "_payload": self._payload}

    def __setstate__(self, state):
        self.id = state["id"]
        self._payload = state["_payload"]
