"""Results of the approximate actions (the port's copy of vega_tpu/partial):
count_approx, mean_approx and count_by_value_approx compute their exact
value on the device and return it as a final PartialResult of
BoundedDouble(x, 1.0, x, x), the value the reference's evaluators give once
every partition has merged."""

from vega_tpu_torch.partial.bounded_double import BoundedDouble
from vega_tpu_torch.partial.partial_result import PartialResult

__all__ = ["BoundedDouble", "PartialResult", "final"]


def final(x) -> BoundedDouble:
    """The evaluators' value on a finished job: BoundedDouble(x, 1.0, x, x)
    over float(x)."""
    x = float(x)
    return BoundedDouble(x, 1.0, x, x)
