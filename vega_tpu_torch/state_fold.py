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
hides behind a host fold: a torch CUDA error, and a KernelError (a hand
kernel that does not build or launch), which is a VegaError but no
refusal of the data.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from vega_tpu_torch.errors import KernelError, VegaError

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
        reduced = ctx.dense_from_numpy(keys, vals).reduce_by_key(op=op)
        out = dict(reduced.collect())
    except KernelError:
        raise
    except VegaError as e:
        log.info("streaming state fold left to the host: %s", e)
        return None
    # host-native scalars, so committed state round-trips alike whichever
    # tier folded it
    return {_pyval(k): _pyval(v) for k, v in out.items()}


def _pyval(x):
    try:
        return x.item()
    except AttributeError:
        return x
