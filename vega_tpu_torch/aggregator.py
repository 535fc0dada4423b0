"""The shuffle's combiner triple: the port's copy of vega_tpu/aggregator.py.

create_combiner / merge_value / merge_combiners as in the reference;
default() is group_by_key's list-collecting aggregator. op_name names a
recognized monoid (add / min / max / prod) and is_group marks the
list-collecting one: the shuffle picks the native runtime's C++ combine
and merge by them (dependency.py, native.py). The combiner
functions the port makes itself are module-level, so a stage binary
pickles with the standard library (serialization.py)."""

from __future__ import annotations

from typing import Callable, Optional


class Aggregator:
    __slots__ = ("create_combiner", "merge_value", "merge_combiners",
                 "op_name", "is_group")

    def __init__(self, create_combiner: Callable, merge_value: Callable,
                 merge_combiners: Callable, op_name: Optional[str] = None,
                 is_group: bool = False):
        self.create_combiner = create_combiner
        self.merge_value = merge_value
        self.merge_combiners = merge_combiners
        self.op_name = op_name
        self.is_group = is_group

    @staticmethod
    def default() -> "Aggregator":
        """The list-collecting aggregator of group_by_key and cogroup."""
        return Aggregator(create_combiner=singleton,
                          merge_value=_append, merge_combiners=_extend,
                          is_group=True)


def identity(v):
    return v


def singleton(v):
    return [v]


def _append(c, v):
    c.append(v)
    return c


def _extend(c1, c2):
    c1.extend(c2)
    return c1
