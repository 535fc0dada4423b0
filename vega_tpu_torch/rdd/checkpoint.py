"""A checkpointed RDD: partitions written to disk, lineage cut; the port's
copy of vega_tpu/rdd/checkpoint.py.

Each partition is written as part-NNNNN.ckpt, the standard library
pickle of its row list, to a temporary name replaced into place; the
CheckpointRDD reads them back with no dependencies. (The reference pickles
with cloudpickle, which reads these files too; the port's files are plain
pickle and cannot hold a closure.) Across processes (Context(multihost=))
every process computes the partitions and process 0 alone writes them; the
others wait for it and then read the same files, so the directory must be
one they all see.

CommitLog (streaming/state.py's exactly-once seam) publishes one JSON
record per committed batch and repoints latest.commit, each written to a
temporary name and replaced into place, as the reference's does."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Iterator, Optional

from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


def rank0_writes(rdd: RDD, path: str, write, what: str) -> None:
    """Run write(tc, it) over every partition of rdd into the directory
    path. Across processes every process computes each partition and
    process 0 writes; one collective then tells every process whether it
    did (its error raises there, a VegaError elsewhere)."""
    import torch

    from vega_tpu_torch import mesh as mesh_lib

    mesh = rdd.context.mesh
    writer = mesh.rank == 0
    error = None
    try:
        if writer:
            os.makedirs(path, exist_ok=True)
        rdd.context.run_job(
            rdd, write if writer else lambda _tc, it: sum(1 for _ in it))
    except Exception as e:  # raised below, after every process knows
        if not mesh.collective:
            raise
        error = e
    if mesh.collective:
        ok = mesh_lib.host_get(mesh, torch.tensor(
            [error is None] * mesh.n_local, device=mesh.device))
        if error is not None:
            raise error
        if not ok.all():
            raise VegaError(f"{what}: process 0 could not write the files "
                            f"under {path}")


class CheckpointRDD(RDD):
    def __init__(self, ctx, directory: str, num_partitions: int):
        super().__init__(ctx)
        self.directory = directory
        self._num_partitions = num_partitions

    @staticmethod
    def write(rdd: RDD, directory: str) -> "CheckpointRDD":
        def write_partition(tc, it):
            path = os.path.join(directory, f"part-{tc.split_index:05d}.ckpt")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(list(it), f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
            return tc.split_index

        rank0_writes(rdd, directory, write_partition, "checkpoint")
        return CheckpointRDD(rdd.context, directory, rdd.num_partitions)

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def compute(self, split: Split, task_context=None) -> Iterator:
        path = os.path.join(self.directory, f"part-{split.index:05d}.ckpt")
        with open(path, "rb") as f:
            return iter(pickle.load(f))


class CommitLog:
    """Atomic, monotone commit records over checkpointed artifacts.

    The state parts are written first (CheckpointRDD.write), then one
    record naming (batch_id, source offsets, state directory), so a crash
    at any point leaves the previous commit or the new one, never a torn
    record. Recovery reads the one latest record."""

    LATEST = "latest.commit"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def commit(self, batch_id: int, payload: Dict[str, Any]) -> str:
        """Publish payload as batch_id's record: the per-batch file (kept
        as the audit trail), then latest.commit. Returns the per-batch
        path."""
        record = dict(payload, batch_id=batch_id)
        data = json.dumps(record, sort_keys=True)
        path = os.path.join(self.directory, f"commit-{batch_id:010d}.json")
        for target in (path, os.path.join(self.directory, self.LATEST)):
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, target)
        return path

    def latest(self) -> Optional[Dict[str, Any]]:
        """The last committed record; None before any commit (a missing
        or torn latest.commit reads as none)."""
        try:
            with open(os.path.join(self.directory, self.LATEST)) as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None
