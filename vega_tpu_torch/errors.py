"""Error type of vega_tpu_torch (its own copy of vega_tpu.errors.VegaError:
the port imports nothing of the JAX package)."""


class VegaError(Exception):
    """Base class for all framework errors."""
