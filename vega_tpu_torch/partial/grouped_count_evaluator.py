"""Approximate count by value: the port's copy of
vega_tpu/partial/grouped_count_evaluator.py (each value's count
extrapolated as CountEvaluator extrapolates the total)."""

from __future__ import annotations

import math
from typing import Dict

from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.partial.bounded_double import BoundedDouble
from vega_tpu_torch.partial.count_evaluator import _z_for_confidence


class GroupedCountEvaluator:
    def __init__(self, total_outputs: int, confidence: float):
        self.total_outputs = total_outputs
        self.confidence = confidence
        self.outputs_merged = 0
        self.sums: Dict = {}
        self._lock = named_lock(
            "partial.grouped_count_evaluator.GroupedCountEvaluator._lock")

    def merge(self, _output_id: int, task_result: Dict) -> None:
        with self._lock:
            self.outputs_merged += 1
            for k, v in task_result.items():
                self.sums[k] = self.sums.get(k, 0) + v

    def current_result(self) -> Dict:
        with self._lock:
            merged = self.outputs_merged
            sums = dict(self.sums)
        if merged == self.total_outputs:
            return {k: BoundedDouble(float(v), 1.0, float(v), float(v))
                    for k, v in sums.items()}
        if merged == 0:
            return {}
        p = merged / self.total_outputs
        z = _z_for_confidence(self.confidence)
        out = {}
        for k, v in sums.items():
            mean = v / p
            sd = math.sqrt(v * (1 - p) / (p * p))
            out[k] = BoundedDouble(mean, self.confidence,
                                   max(0.0, mean - z * sd), mean + z * sd)
        return out
