"""Task encoding: the port's copy of vega_tpu/serialization.py's dumps /
loads, over the standard library's pickle (protocol 5).

The reference pickles with cloudpickle, which carries lambdas and local
closures by value; the port must not depend on it, so a stage whose
lineage or function holds a lambda or a local closure cannot make the
round trip that serialize_tasks_locally=True asks for: dumps raises
VegaError naming the function. Module-level functions, classes and
functools.partial over them pass. The reference's wire framing belongs to
its distributed backend and is not here."""

from __future__ import annotations

import pickle

from vega_tpu_torch.errors import VegaError

_PROTO = 5


def dumps(obj) -> bytes:
    try:
        return pickle.dumps(obj, protocol=_PROTO)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise VegaError(
            f"cannot serialize the task with the standard library's pickle "
            f"({e}); use module-level functions, or leave "
            "serialize_tasks_locally off") from e


def loads(data: bytes):
    return pickle.loads(data)
