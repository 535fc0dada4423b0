"""The result of an approximate action (the reference's
partial/partial_result.py), final only.

The port's approximate actions finish before they return, so every result
they give is final, or failed: the reference can also hand back a
non-final estimate when its deadline passes first. This holder therefore
keeps the reference's surface for a final value, or for a job that failed
(the reference's set_failure: the initial value None, get_final_value
raising the job's exception)."""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

R = TypeVar("R")


class PartialResult(Generic[R]):
    def __init__(self, value: R, failure: Optional[BaseException] = None):
        self._value = value
        self._failure = failure

    @property
    def initial_value(self) -> R:
        return self._value

    @property
    def is_initial_value_final(self) -> bool:
        return self._failure is None

    def get_final_value(self, timeout: Optional[float] = None) -> R:
        """The final value, there already (timeout is unused), or the
        failed job's exception raised."""
        if self._failure is not None:
            raise self._failure
        return self._value

    def on_complete(self, handler: Callable[[R], None]
                    ) -> "PartialResult[R]":
        """Calls handler with the final value at once (never on a failed
        job)."""
        if self._failure is None:
            handler(self._value)
        return self

    def on_fail(self, handler: Callable[[BaseException], None]
                ) -> "PartialResult[R]":
        """Calls handler with a failed job's exception at once."""
        if self._failure is not None:
            handler(self._failure)
        return self

    def __repr__(self):
        state = "final" if self._failure is None else "failed"
        return f"PartialResult({state}: {self._value})"
