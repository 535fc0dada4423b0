"""Results of the approximate actions (the port's copy of vega_tpu/partial):
count_approx, count_by_value_approx and mean_approx, of a host RDD and of
a DenseRDD alike, merge each finished partition into their evaluator
(count_evaluator.py, grouped_count_evaluator.py, mean_evaluator.py)
through Context.run_approximate_job, and give its estimate when the
deadline passes first, its final value later."""

from vega_tpu_torch.partial.bounded_double import BoundedDouble
from vega_tpu_torch.partial.partial_result import PartialResult

__all__ = ["BoundedDouble", "PartialResult"]
