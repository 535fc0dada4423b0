"""The host RDD layer: lazy lineages of Python-row partitions run in one
process (base.py), the port's copy of vega_tpu/rdd/."""

from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.rdd.narrow import (FlatMapperRDD, MapPartitionsRDD,
                                       MapperRDD, ParallelCollectionRDD,
                                       PartitionwiseSampledRDD,
                                       ZippedPartitionsRDD)
from vega_tpu_torch.rdd.shuffled import ShuffledRDD
from vega_tpu_torch.rdd.cogrouped import CoGroupedRDD
from vega_tpu_torch.rdd.cartesian import CartesianRDD
from vega_tpu_torch.rdd.coalesced import CoalescedRDD
from vega_tpu_torch.rdd.union import UnionRDD
from vega_tpu_torch.rdd.checkpoint import CheckpointRDD

__all__ = ["RDD", "CartesianRDD", "CheckpointRDD", "CoGroupedRDD",
           "CoalescedRDD", "FlatMapperRDD", "MapPartitionsRDD", "MapperRDD",
           "ParallelCollectionRDD", "PartitionwiseSampledRDD", "ShuffledRDD",
           "UnionRDD", "ZippedPartitionsRDD"]
