"""Partition descriptors: the port's copy of vega_tpu/split.py.

A Split is a partition's index plus an optional payload the RDD that made
it reads back (a ParallelCollectionRDD's slice, a CartesianRDD's pair of
parent indices, a CoalescedRDD's group)."""

from __future__ import annotations

from typing import Any


class Split:
    __slots__ = ("index", "payload")

    def __init__(self, index: int, payload: Any = None):
        self.index = index
        self.payload = payload

    def __repr__(self):
        return f"Split({self.index})"

    def __eq__(self, other):
        return isinstance(other, Split) and other.index == self.index

    def __hash__(self):
        return hash(("Split", self.index))
