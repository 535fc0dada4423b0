"""The result of an approximate action: the port's copy of the
reference's partial/partial_result.py.

A result is final, or failed (the reference's set_failure: the initial
value None, get_final_value raising the job's exception), or, when
Context.run_approximate_job's deadline passes first, the current
estimate, not final: the job goes on, and set_final_value / set_failure
settle the result when it ends, calling the on_complete / on_fail
handler then."""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

from vega_tpu_torch.errors import PartialJobError
from vega_tpu_torch.lint.sync_witness import named_lock

R = TypeVar("R")


class PartialResult(Generic[R]):
    def __init__(self, value: R, failure: Optional[BaseException] = None,
                 is_final: bool = True):
        self._value = value
        self._failure = failure
        self._final = is_final and failure is None
        self._event = threading.Event()
        self._completion_handler: Optional[Callable[[R], None]] = None
        self._failure_handler: Optional[
            Callable[[BaseException], None]] = None
        self._lock = named_lock("partial.partial_result.PartialResult._lock")
        if is_final or failure is not None:
            self._event.set()

    @property
    def initial_value(self) -> R:
        return self._value

    @property
    def is_initial_value_final(self) -> bool:
        return self._final

    def get_final_value(self, timeout: Optional[float] = None) -> R:
        """The final value, once there (PartialJobError if timeout passes
        first), or the failed job's exception raised."""
        if not self._event.wait(timeout):
            raise PartialJobError("timed out waiting for final value")
        if self._failure is not None:
            raise self._failure
        return self._value

    def on_complete(self, handler: Callable[[R], None]
                    ) -> "PartialResult[R]":
        """Calls handler with the final value: at once when final, else
        when it comes (never on a failed job)."""
        with self._lock:
            self._completion_handler = handler
            final = self._final
        if final:
            handler(self._value)
        return self

    def on_fail(self, handler: Callable[[BaseException], None]
                ) -> "PartialResult[R]":
        """Calls handler with a failed job's exception, at once or when
        it fails."""
        with self._lock:
            self._failure_handler = handler
            failure = self._failure
        if failure is not None:
            handler(failure)
        return self

    # --- the producer's side ------------------------------------------------
    def set_final_value(self, value: R) -> None:
        with self._lock:
            self._value = value
            self._final = True
            handler = self._completion_handler
        self._event.set()
        if handler:
            handler(value)

    def set_failure(self, exc: BaseException) -> None:
        with self._lock:
            self._failure = exc
            handler = self._failure_handler
        self._event.set()
        if handler:
            handler(exc)

    def __repr__(self):
        state = ("failed" if self._failure is not None
                 else "final" if self._final else "partial")
        return f"PartialResult({state}: {self._value})"
