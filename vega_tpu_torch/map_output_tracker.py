"""Map-output locations: the port's copy of vega_tpu/map_output_tracker.py.

Per shuffle, one ordered location list per map output: "local" (this
process's store), or executors' shuffle-server URIs, the primary first
and then the replicas written under shuffle_replication > 1; an output
is available while its list holds a location. The DAG scheduler
registers a map stage's outputs when the stage completes and unregisters
one on a fetch failure, which bumps the generation; a lost executor's
server is dropped from every list in one sweep
(unregister_server_outputs). Reduce tasks read the lists through
get_server_uri_lists, which waits on a condition until every output of
the shuffle has a location; executors ask over the driver service
(distributed/driver_service.py). Per-bucket sizes (register_map_sizes)
rank the servers a reduce task prefers (top_reduce_locations).

Under shuffle_coding the tracker also keeps each shuffle's parity groups
(register_parity: which parity server folded which map output into which
group, at which index). When a lost server would leave an output with
no location but a group held elsewhere can still decode it (no more
than m of its members lost), unregister_server_outputs puts the
pseudo-location "coded:<parity server>/<group>" there instead: the
output stays available and the fetcher decodes it. A pseudo-location
serves no bytes, and it goes with the parity server behind it."""

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
        # shuffle_id -> map_id -> per-reduce bucket bytes (advisory:
        # reduce-side placement only)
        self._sizes: Dict[int, Dict[int, List[int]]] = {}
        # shuffle_id -> (parity_uri, group_id) -> {"scheme", "k", "m",
        # "members": {map_id: index}} (registered by the map tasks, maybe
        # before their stage's outputs are)
        self._parity: Dict[int, Dict[tuple, dict]] = {}
        self._generation = 0
        # plain, as vega_tpu's is: the witness does not wrap a Condition's
        # lock (wait() releases and re-acquires it behind the wrapper)
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

    def unregister_server_outputs(self, uri: str) -> int:
        """A lost executor: uri dropped from every location list of every
        shuffle, the generation bumped once; returns the entries it was
        dropped from (an output with a replica left stays available). The
        parity groups uri held go with it, and so do their coded:
        locations; an output left with none that a surviving group
        decodes gets that group's coded: location."""
        removed = 0
        dead_prefix = f"coded:{uri}/"
        with self._cond:
            for groups in self._parity.values():
                for key in [k for k in groups if k[0] == uri]:
                    del groups[key]
            covered = self._covered_if_lost(uri)
            for shuffle_id, locs in self._outputs.items():
                for i, lst in enumerate(locs):
                    if uri in lst:
                        removed += 1
                    kept = [u for u in lst
                            if u != uri and not u.startswith(dead_prefix)]
                    if not kept and lst:
                        pseudo = covered.get((shuffle_id, i))
                        if pseudo is not None:
                            kept = [pseudo]
                    if kept != lst:
                        locs[i] = kept
            if removed:
                self._generation += 1
                self._cond.notify_all()
        return removed

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._outputs.pop(shuffle_id, None)
            self._sizes.pop(shuffle_id, None)
            self._parity.pop(shuffle_id, None)

    def outputs_on_server(self, uri: str):
        """(shuffle_id, map_id, location list, per-reduce sizes or None)
        of every output uri holds."""
        with self._lock:
            out = []
            for shuffle_id, locs in self._outputs.items():
                sizes = self._sizes.get(shuffle_id, {})
                for map_id, lst in enumerate(locs):
                    if uri in lst:
                        row = sizes.get(map_id)
                        out.append((shuffle_id, map_id, list(lst),
                                    list(row) if row else None))
            return out

    def server_bytes(self, uri: str) -> int:
        """The registered bucket bytes uri holds."""
        total = 0
        with self._lock:
            for shuffle_id, locs in self._outputs.items():
                sizes = self._sizes.get(shuffle_id, {})
                for map_id, lst in enumerate(locs):
                    if uri in lst:
                        total += sum(sizes.get(map_id, ()))
        return total

    def replace_location(self, shuffle_id: int, map_id: int,
                         old_uri: str, new_uri: str) -> None:
        """old_uri swapped for new_uri in one output's list, in place
        (order kept, duplicates collapsed); no generation bump."""
        with self._cond:
            locs = self._outputs.get(shuffle_id)
            if locs is None or map_id >= len(locs):
                return
            replaced = [new_uri if u == old_uri else u for u in locs[map_id]]
            locs[map_id] = list(dict.fromkeys(replaced))
            self._cond.notify_all()

    # --- the coded shuffle (shuffle/coding.py) ------------------------------
    def register_parity(self, shuffle_id: int, parity_uri: str,
                        group_id: int, map_id: int, idx: int,
                        scheme: str, k: int, m: int) -> None:
        """parity_uri folded map_id into group_id at index idx (a repeat
        of the same assignment changes nothing)."""
        with self._lock:
            groups = self._parity.setdefault(shuffle_id, {})
            g = groups.setdefault((parity_uri, group_id),
                                  {"scheme": scheme, "k": k, "m": m,
                                   "members": {}})
            g["members"][map_id] = idx

    def get_parity_map(self, shuffle_id: int) -> Dict:
        """{(parity_uri, group_id): {"scheme", "k", "m", "members":
        {map_id: index}}} of the shuffle, a copy; empty without coding."""
        with self._lock:
            groups = self._parity.get(shuffle_id, {})
            return {key: {"scheme": g["scheme"], "k": g["k"], "m": g["m"],
                          "members": dict(g["members"])}
                    for key, g in groups.items()}

    def decodable_without(self, uri: str) -> Dict:
        """{(shuffle_id, map_id): coded location} of every output whose
        only real location is uri and that a group held elsewhere would
        decode (the elastic fleet's decommission counts these)."""
        with self._lock:
            return self._covered_if_lost(uri)

    def coded_locations(self, shuffle_id: int) -> Dict[int, str]:
        """{map_id: coded location} of the outputs that only a decode
        serves now (the DAG scheduler keeps them available)."""
        with self._lock:
            locs = self._outputs.get(shuffle_id)
            if locs is None:
                return {}
            return {i: lst[0] for i, lst in enumerate(locs)
                    if lst and all(u.startswith("coded:") for u in lst)}

    def _covered_if_lost(self, uri: str) -> Dict:
        """Under self._lock: for each group not held on uri, the members
        with no real location but uri; when there are between 1 and m of
        them, each is covered by the group's coded location."""
        covered: Dict = {}
        for shuffle_id, groups in self._parity.items():
            locs = self._outputs.get(shuffle_id)
            if locs is None:
                continue
            for (puri, gid), g in groups.items():
                if puri == uri:
                    continue
                missing = []
                in_range = True
                for mid in g["members"]:
                    if not 0 <= mid < len(locs):
                        in_range = False
                        break
                    real = [u for u in locs[mid]
                            if u != uri and not u.startswith("coded:")]
                    if not real and locs[mid]:
                        missing.append(mid)
                if in_range and missing and len(missing) <= g["m"]:
                    pseudo = f"coded:{puri}/{gid}"
                    for mid in missing:
                        covered[(shuffle_id, mid)] = pseudo
        return covered

    def register_map_sizes(self, shuffle_id: int,
                           sizes_by_map: Dict[int, List[int]]) -> None:
        """Per-reduce bucket bytes of some map outputs (overwritten when
        a map output is recomputed)."""
        with self._lock:
            dst = self._sizes.setdefault(shuffle_id, {})
            for map_id, sizes in sizes_by_map.items():
                dst[map_id] = list(sizes)

    def top_reduce_locations(self, shuffle_id: int, reduce_id: int,
                             limit: int = 2) -> List[str]:
        """The servers holding most of reduce_id's input bytes, most
        first (every location of an output holds its whole bucket row);
        empty when no sizes were registered."""
        totals: Dict[str, int] = {}
        with self._lock:
            sizes = self._sizes.get(shuffle_id)
            locs = self._outputs.get(shuffle_id)
            if not sizes or locs is None:
                return []
            for map_id, row in sizes.items():
                if not (0 <= map_id < len(locs)) or reduce_id >= len(row):
                    continue
                for uri in locs[map_id]:
                    totals[uri] = totals.get(uri, 0) + row[reduce_id]
        ranked = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
        return [uri for uri, nbytes in ranked[:limit] if nbytes > 0]

    def _wait_complete(self, shuffle_id: int, timeout: float) -> None:
        ok = self._cond.wait_for(
            lambda: shuffle_id in self._outputs
            and all(self._outputs[shuffle_id]), timeout=timeout)
        if not ok:
            raise MapOutputError(
                f"timed out waiting for map outputs of shuffle {shuffle_id}")

    def get_server_uris(self, shuffle_id: int,
                        timeout: float = 60.0) -> List[str]:
        """Each output's primary (first) location, once all have one."""
        with self._cond:
            self._wait_complete(shuffle_id, timeout)
            return [lst[0] for lst in self._outputs[shuffle_id]]

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

    def increment_generation(self) -> None:
        with self._lock:
            self._generation += 1
