"""Approximate count with Poisson bounds: the port's copy of
vega_tpu/partial/count_evaluator.py.

With p = outputs merged / total outputs and observed sum S, the complete
count is taken as Poisson of mean S / p, its interval from the normal
approximation; once every output merged, the exact count."""

from __future__ import annotations

import math

from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.partial.bounded_double import BoundedDouble


def _z_for_confidence(conf: float) -> float:
    """The two-sided normal quantile of a confidence (a rational
    approximation of the probit)."""
    p = 1.0 - (1.0 - conf) / 2.0
    if p <= 0.5:
        return 0.0
    t = math.sqrt(-2.0 * math.log(1.0 - p))
    return t - (2.30753 + 0.27061 * t) / (1.0 + 0.99229 * t + 0.04481 * t * t)


class CountEvaluator:
    def __init__(self, total_outputs: int, confidence: float):
        self.total_outputs = total_outputs
        self.confidence = confidence
        self.outputs_merged = 0
        self.sum = 0
        self._lock = named_lock("partial.count_evaluator.CountEvaluator._lock")

    def merge(self, _output_id: int, task_result: int) -> None:
        with self._lock:
            self.outputs_merged += 1
            self.sum += task_result

    def current_result(self) -> BoundedDouble:
        with self._lock:
            merged, total = self.outputs_merged, self.sum
        if merged == self.total_outputs:
            return BoundedDouble(float(total), 1.0, float(total),
                                 float(total))
        if merged == 0 or total == 0:
            return BoundedDouble(0.0, 0.0, 0.0, float("inf"))
        p = merged / self.total_outputs
        mean = total / p
        var = total * (1 - p) / (p * p)
        z = _z_for_confidence(self.confidence)
        sd = math.sqrt(var)
        return BoundedDouble(mean, self.confidence, max(0.0, mean - z * sd),
                             mean + z * sd)
