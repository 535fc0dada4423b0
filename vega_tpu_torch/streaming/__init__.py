"""Micro-batch streaming (discretized streams): the port's copy of
vega_tpu/streaming/.

Receivers land offset-tracked, replayable blocks in the Context's stream
block store; every interval those blocks become an ordinary host RDD
lineage (rdd/), run through the Context's job worker in the stream's
pool; a stateful fold reduces each batch on the Context's device
(state_fold.fold_pairs_device, the hand kernels' reduce) and commits
(batch_id, offsets, state) through the checkpoint machinery
(exactly-once); a rate controller bounds ingest by the pool's batch-wall
percentiles.
"""

from vega_tpu_torch.streaming.context import StreamingContext
from vega_tpu_torch.streaming.dstream import DStream
from vega_tpu_torch.streaming.source import (FileTailSource, GeneratorSource,
                                             SocketSource)

__all__ = [
    "StreamingContext",
    "DStream",
    "GeneratorSource",
    "FileTailSource",
    "SocketSource",
]
