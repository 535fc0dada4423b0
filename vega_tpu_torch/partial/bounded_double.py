"""A value with a confidence interval (the reference's
partial/bounded_double.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BoundedDouble:
    mean: float
    confidence: float
    low: float
    high: float

    def __repr__(self):
        return (f"[{self.low:.3f}, {self.high:.3f}] "
                f"(mean={self.mean:.3f}, conf={self.confidence})")
