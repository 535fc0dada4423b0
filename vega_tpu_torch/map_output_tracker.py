"""Map-output locations: the port's copy of vega_tpu/map_output_tracker.py
for the local runtime.

Per shuffle, one ordered location list per map output ("local" in this
process); an output is available while its list holds a location. The
DAG scheduler registers a map stage's outputs when the stage completes
and unregisters one on a fetch failure, which bumps the generation;
reduce tasks read the lists through get_server_uri_lists, which waits on
a condition until every output of the shuffle has a location. The
reference's replica, parity and per-bucket-size accounting belong to its
distributed backend and are not here."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

from vega_tpu_torch.errors import MapOutputError

Locs = Union[None, str, List[str]]


def _as_list(uri: Locs) -> List[str]:
    if uri is None:
        return []
    if isinstance(uri, str):
        return [uri]
    return [u for u in uri if u]


class MapOutputTracker:
    def __init__(self):
        # shuffle_id -> per-map_id ordered location list (empty: missing)
        self._outputs: Dict[int, List[List[str]]] = {}
        self._generation = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def register_shuffle(self, shuffle_id: int, num_maps: int) -> None:
        with self._lock:
            if shuffle_id not in self._outputs:
                self._outputs[shuffle_id] = [[] for _ in range(num_maps)]

    def register_map_outputs(self, shuffle_id: int,
                             uris: List[Locs]) -> None:
        with self._cond:
            self._outputs[shuffle_id] = [_as_list(u) for u in uris]
            self._cond.notify_all()

    def unregister_map_output(self, shuffle_id: int, map_id: int,
                              uri: Optional[str]) -> None:
        """A fetch failure: drop the failed location; bumps the
        generation."""
        with self._cond:
            locs = self._outputs.get(shuffle_id)
            if locs is None:
                raise MapOutputError(f"unknown shuffle {shuffle_id}")
            locs[map_id] = [u for u in locs[map_id] if u != uri]
            self._generation += 1
            self._cond.notify_all()

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._outputs.pop(shuffle_id, None)

    def _wait_complete(self, shuffle_id: int, timeout: float) -> None:
        ok = self._cond.wait_for(
            lambda: shuffle_id in self._outputs
            and all(self._outputs[shuffle_id]), timeout=timeout)
        if not ok:
            raise MapOutputError(
                f"timed out waiting for map outputs of shuffle {shuffle_id}")

    def get_server_uri_lists(self, shuffle_id: int,
                             timeout: float = 60.0) -> List[List[str]]:
        with self._cond:
            self._wait_complete(shuffle_id, timeout)
            return [list(lst) for lst in self._outputs[shuffle_id]]

    def has_outputs(self, shuffle_id: int) -> bool:
        with self._lock:
            locs = self._outputs.get(shuffle_id)
            return locs is not None and all(locs)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation
