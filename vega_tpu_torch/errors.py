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
    bound of jobs in flight under admission_mode="reject" (jobs.py). The
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
