"""The result of an approximate action (the reference's
partial/partial_result.py), final only.

The port's approximate actions finish on the device before they return, so
every result they give is final: the reference can also hand back a
non-final estimate when its deadline passes first. This holder therefore
keeps the reference's surface for a final value only."""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

R = TypeVar("R")


class PartialResult(Generic[R]):
    def __init__(self, value: R):
        self._value = value

    @property
    def initial_value(self) -> R:
        return self._value

    @property
    def is_initial_value_final(self) -> bool:
        return True

    def get_final_value(self, timeout: Optional[float] = None) -> R:
        """The final value; it is there already, so timeout is unused."""
        return self._value

    def on_complete(self, handler: Callable[[R], None]
                    ) -> "PartialResult[R]":
        """Calls handler with the final value at once."""
        handler(self._value)
        return self

    def on_fail(self, handler: Callable[[BaseException], None]
                ) -> "PartialResult[R]":
        """A final result has not failed: handler is never called."""
        return self

    def __repr__(self):
        return f"PartialResult(final: {self._value})"
