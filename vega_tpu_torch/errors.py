"""Error types of vega_tpu_torch (its own copy of vega_tpu.errors.VegaError:
the port imports nothing of the JAX package)."""


class VegaError(Exception):
    """Base class for all framework errors."""


class KernelError(VegaError):
    """A hand-written kernel could not be built, could not take its input
    or failed to launch: a failure of the card or of the port, never a
    refusal of the data, so no caller turns it into a host fallback."""


class CollectiveError(VegaError):
    """A collective across processes could not complete (a peer is lost,
    or did not reach it within the group's timeout): a failure of the
    group, never a refusal of the data."""


class CancelledError(VegaError):
    """An asynchronous action was cancelled before it completed."""


class JobRejectedError(VegaError):
    """Admission refused a job at submission: its pool already holds its
    bound of jobs in flight under admission_mode="reject"
    (scheduler/jobserver.py). The
    reference's fields: pool, queued, bound."""

    def __init__(self, pool, queued, bound):
        self.pool = pool
        self.queued = queued
        self.bound = bound
        super().__init__(
            f"pool {pool!r} is full: {queued} jobs in flight >= "
            f"pool_max_queued={bound} (admission_mode=reject)")


class PartialJobError(VegaError):
    """An approximate job's final value did not come within the wait."""


class ShuffleError(VegaError):
    """The shuffle plane could not serve a reduce task its buckets."""


class FetchFailedError(ShuffleError):
    """A reduce task could not read one map output's bucket: the DAG
    scheduler unregisters that output and resubmits its map stage
    (scheduler/dag.py). The reference's fields: server_uri, shuffle_id,
    map_id, reduce_id."""

    def __init__(self, server_uri, shuffle_id, map_id, reduce_id,
                 message=""):
        self.server_uri = server_uri
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.reduce_id = reduce_id
        self.message = message
        super().__init__(
            message or f"fetch failed: shuffle={shuffle_id} map={map_id} "
            f"reduce={reduce_id} from {server_uri}")

    def __reduce__(self):
        return (FetchFailedError, (self.server_uri, self.shuffle_id,
                                   self.map_id, self.reduce_id,
                                   self.message))


class MapOutputError(VegaError):
    """The map-output tracker could not answer (an unknown shuffle, or
    outputs that did not register within the wait)."""


class TaskError(VegaError):
    """A task failed max_failures times: the job aborts with this error,
    raised from the task's last exception."""

    def __init__(self, message, remote_traceback=None):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class TaskCancelledError(VegaError):
    """A task attempt was cancelled before it ran (the losing copy of a
    speculated pair, or an attempt of a cancelled job); it never counts
    against max_failures."""


class NetworkError(VegaError):
    """A connection of the distributed backend failed: a connect refused
    or timed out, a peer that hung up mid-message, an error reply."""
