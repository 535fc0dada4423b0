"""The reference's host-tier samplers (vega_tpu/utils/random.py), drawn per
shard with numpy.

The reference's host tier samples a partition row by row from a numpy
PCG64 stream seeded [seed, split_seed] (seed None: 0xC0FFEE), split_seed
the partition's index; on the port a partition is a shard. Its
PoissonSampler draws one rng.poisson(lam) a row, its BernoulliCellSampler
one rng.random() a row. The port draws the same stream for a shard in one
vectorised call (size = the shard's row count), which gives the scalar
draws' values in their order (tests/test_torch_host_actions.py checks
both distributions), copies the draws to the device once and applies them
to the column tensors there.

A host RDD (rdd/) samples its rows through the same samplers' sample()
(PartitionwiseSampledRDD), and without replacement through
BernoulliSampler, the reference's with its gap sampling, which draws one
scalar per kept row or per coin. A DenseRDD samples without replacement on
the device (the reference's threefry form, dense_rdd._SampleRDD)."""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np

DEFAULT_SEED = 0xC0FFEE
# below this fraction BernoulliSampler skips geometric gaps instead of
# drawing a coin a row (the reference's threshold)
GAP_SAMPLING_FRACTION_THRESHOLD = 0.4


def rng(seed: Optional[int], split_seed: int) -> np.random.Generator:
    """The reference's RandomSampler._rng: PCG64([seed, split_seed])."""
    base = seed if seed is not None else DEFAULT_SEED
    return np.random.Generator(np.random.PCG64([base, split_seed]))


class PoissonSampler:
    """Sampling with replacement: row i of a partition is repeated
    rng.poisson(fraction) times; a fraction <= 0 keeps nothing and draws
    nothing."""

    def __init__(self, fraction: float, seed: Optional[int] = None):
        self.fraction = float(fraction)
        self.seed = seed

    def counts(self, n: int, split_seed: int) -> np.ndarray:
        """int64[n]: each row's repeat count in the partition's stream."""
        if self.fraction <= 0.0:
            return np.zeros(n, np.int64)
        return rng(self.seed, split_seed).poisson(
            self.fraction, size=n).astype(np.int64)

    def sample(self, items, split_seed: int) -> Iterator:
        """A host partition's sample: each row repeated its count."""
        rows = list(items)
        for item, c in zip(rows, self.counts(len(rows), split_seed).tolist()):
            for _ in range(c):
                yield item


class BernoulliSampler:
    """Sampling without replacement, the reference's host form: a row
    stays with probability fraction; at a fraction up to
    GAP_SAMPLING_FRACTION_THRESHOLD the stream draws the gap to the next
    kept row (geometric) instead of a coin a row."""

    def __init__(self, fraction: float, seed: Optional[int] = None):
        self.fraction = float(fraction)
        self.seed = seed

    def sample(self, items, split_seed: int) -> Iterator:
        p = self.fraction
        if p <= 0.0:
            return
        r = rng(self.seed, split_seed)
        if p >= 1.0:
            yield from items
            return
        if p <= GAP_SAMPLING_FRACTION_THRESHOLD:
            log1mp = math.log1p(-p)
            skip = int(math.log(r.random() or 1e-300) / log1mp)
            for item in items:
                if skip > 0:
                    skip -= 1
                    continue
                yield item
                skip = int(math.log(r.random() or 1e-300) / log1mp)
        else:
            for item in items:
                if r.random() < p:
                    yield item


class BernoulliCellSampler:
    """random_split's band: row i stays when its draw x satisfies
    lb <= x < ub. Every band of one split draws the same stream, so the
    bands are disjoint and cover every row."""

    def __init__(self, lb: float, ub: float, seed: Optional[int] = None):
        self.lb = float(lb)
        self.ub = float(ub)
        self.seed = seed

    def draws(self, n: int, split_seed: int) -> np.ndarray:
        """float64[n]: each row's draw in the partition's stream."""
        return rng(self.seed, split_seed).random(size=n)

    def keep(self, draws):
        """Which draws the band keeps (numpy or torch, elementwise)."""
        return (draws >= self.lb) & (draws < self.ub)

    def sample(self, items, split_seed: int) -> Iterator:
        """A host partition's rows whose draw falls in the band."""
        rows = list(items)
        keep = self.keep(self.draws(len(rows), split_seed)).tolist()
        return (x for x, k in zip(rows, keep) if k)


def compute_fraction_for_sample_size(size: int, total: int,
                                     with_replacement: bool) -> float:
    """The oversampling fraction take_sample draws with, so that the
    sample holds `size` rows with high probability (the reference's)."""
    if with_replacement and size < 12:
        return float(size) / total * 4.0
    frac = float(size) / total
    delta = 1e-4
    gamma = -math.log(delta) / total
    return min(1.0, max(1e-10, frac + gamma + math.sqrt(
        gamma * gamma + 2 * gamma * frac)))
