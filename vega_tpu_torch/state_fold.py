"""Device fold for streaming state: the counterpart of
vega_tpu/tpu/state_fold.py.

A micro-batch's update_state_by_key with a named monoid op ('add', 'min',
'max', 'prod') is a segment reduce over its (key, value) pairs: the dense
tier's reduce_by_key(op=...). fold_pairs_device builds a pair block from
the batch's host pairs, reduces it on the Context's device and hands back a
{key: value} dict of Python scalars for the state commit.

The contract is the reference's: only the named ops take this path, and
None (the caller folds on the host) is returned for another op, for keys
whose numpy kind is not integer, for values that are not numeric, and for
anything the dense tier refuses with VegaError (an int64 total outside the
int64 range, for one). Integer results equal a host fold exactly.

One deliberate departure: the reference also turns every other exception
into None. Here any other failure propagates, so no failure of the card
hides behind a host fold: a torch CUDA error, a KernelError (a hand
kernel that does not build or launch) and a CollectiveError (a
collective across processes that cannot complete), which are VegaErrors
but no refusal of the data.

Across processes (Context(multihost=...)) every process passes the same
pairs, the reduce runs over the global shards, and every process gets the
same dict (its collect reads through mesh.host_get).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import CollectiveError, KernelError, VegaError

log = logging.getLogger(__name__)

_NAMED_OPS = ("add", "min", "max", "prod")


def fold_pairs_device(ctx, pairs, op: str) -> Optional[Dict]:
    """Reduce `pairs` ([(k, v), ...], non-empty) by key with the named op
    `op` on ctx's device. Returns {key: folded value} with Python scalars,
    or None when the caller must fold on the host."""
    if op not in _NAMED_OPS:
        return None
    try:
        keys = np.asarray([k for k, _ in pairs])
        vals = np.asarray([v for _, v in pairs])
    except (TypeError, ValueError):
        return None
    if keys.dtype.kind not in "iu" or vals.dtype.kind not in "iuf":
        # non-integer keys or non-numeric values have no dense encoding
        return None
    try:
        rdd = ctx.dense_from_numpy(keys, vals)
        if not isinstance(rdd, dense_rdd.DenseRDD):
            # keys no block holds came back as the host tier's rows
            return None
        out = dict(rdd.reduce_by_key(op=op).collect())
    except (KernelError, CollectiveError):
        raise
    except VegaError as e:
        log.info("streaming state fold left to the host: %s", e)
        return None
    # host-native scalars, so committed state round-trips alike whichever
    # tier folded it
    return {_pyval(k): _pyval(v) for k, v in out.items()}


def _pyval(x):
    # a lookup, not a caught AttributeError: collect() already gives
    # Python scalars, and a raise a value costs more than the fold's reduce
    item = getattr(x, "item", None)
    return x if item is None else item()
