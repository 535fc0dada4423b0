"""Approximate mean: the port's copy of
vega_tpu/partial/mean_evaluator.py. Tasks report (count, sum, sum of
squares); the interval is the normal one of the sample mean."""

from __future__ import annotations

import math

from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.partial.bounded_double import BoundedDouble
from vega_tpu_torch.partial.count_evaluator import _z_for_confidence


class MeanEvaluator:
    def __init__(self, total_outputs: int, confidence: float):
        self.total_outputs = total_outputs
        self.confidence = confidence
        self.outputs_merged = 0
        self.count = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self._lock = named_lock("partial.mean_evaluator.MeanEvaluator._lock")

    def merge(self, _output_id: int, task_result) -> None:
        n, s, ss = task_result
        with self._lock:
            self.outputs_merged += 1
            self.count += n
            self.sum += s
            self.sum_sq += ss

    def current_result(self) -> BoundedDouble:
        with self._lock:
            merged, n, s, ss = (self.outputs_merged, self.count, self.sum,
                                self.sum_sq)
        if n == 0:
            return BoundedDouble(float("nan"), 0.0, float("nan"),
                                 float("nan"))
        mean = s / n
        if merged == self.total_outputs:
            return BoundedDouble(mean, 1.0, mean, mean)
        variance = max(0.0, ss / n - mean * mean)
        sd_mean = math.sqrt(variance / n)
        z = _z_for_confidence(self.confidence)
        return BoundedDouble(mean, self.confidence, mean - z * sd_mean,
                             mean + z * sd_mean)
