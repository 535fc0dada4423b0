"""A unit of scheduling: the port's copy of vega_tpu/scheduler/stage.py.

A shuffle-map stage runs its RDD's partitions into a ShuffleDependency's
buckets; a result stage runs the job's function. output_locs[partition]
lists the locations of a map output, newest first; a shuffle-map stage is
available when every partition has one."""

from __future__ import annotations

from typing import List, Optional

from vega_tpu_torch.dependency import ShuffleDependency


class Stage:
    def __init__(self, stage_id: int, rdd,
                 shuffle_dep: Optional[ShuffleDependency],
                 parents: List["Stage"]):
        self.id = stage_id
        self.rdd = rdd
        self.shuffle_dep = shuffle_dep  # None: a result stage
        self.parents = parents
        self.num_partitions = rdd.num_partitions
        self.output_locs: List[List[str]] = [
            [] for _ in range(self.num_partitions)]
        # map_id -> per-reduce bucket bytes (the map tasks' results)
        self.bucket_sizes: dict = {}
        # the stage's StageBinary (task.py), built at first submission and
        # reused by retries, resubmissions and later jobs, and the lineage
        # token it was built under (dag.py _lineage_token)
        self.task_binary = None
        self.task_binary_token = None

    @property
    def is_shuffle_map(self) -> bool:
        return self.shuffle_dep is not None

    @property
    def num_available_outputs(self) -> int:
        return sum(1 for locs in self.output_locs if locs)

    @property
    def is_available(self) -> bool:
        if not self.is_shuffle_map:
            return not self.parents
        return self.num_available_outputs == self.num_partitions

    def add_output_loc(self, partition: int, uri) -> None:
        """uri is a map task's result: a location, a list of them, or the
        (locations, bucket sizes) pair."""
        if isinstance(uri, tuple):
            uri, sizes = uri
            self.bucket_sizes[partition] = list(sizes)
        uris = [uri] if isinstance(uri, str) else list(uri)
        self.output_locs[partition] = uris + [
            u for u in self.output_locs[partition] if u not in uris]

    def remove_output_loc(self, partition: int, uri) -> None:
        self.output_locs[partition] = [
            u for u in self.output_locs[partition] if u != uri]

    def remove_outputs_on_server(self, uri: str) -> None:
        """A lost executor's server out of every partition's locations
        (one list replaced at a time)."""
        for p in range(self.num_partitions):
            if uri in self.output_locs[p]:
                self.remove_output_loc(p, uri)

    def __repr__(self):
        kind = "shuffle" if self.is_shuffle_map else "result"
        return f"Stage(id={self.id}, {kind}, rdd={self.rdd.rdd_id})"
