"""Error types of vega_tpu_torch (its own copy of vega_tpu.errors.VegaError:
the port imports nothing of the JAX package)."""


class VegaError(Exception):
    """Base class for all framework errors."""


class KernelError(VegaError):
    """A hand-written kernel could not be built, could not take its input
    or failed to launch: a failure of the card or of the port, never a
    refusal of the data, so no caller turns it into a host fallback."""
