"""Runtime lock-order sanitizer: the dynamic half of VG003.

Static lock-order analysis (vega_tpu_torch/lint/rules.py VG003) sees lexical
nesting and one resolvable call hop; it cannot see orders that only arise
through callbacks, scheduler interleavings, or data-dependent paths. Under
``VEGA_TPU_DEBUG_SYNC=1`` the project's named locks are wrapped so every
acquisition is recorded into a global order graph per thread:

- acquiring B while holding A adds the edge A -> B (first-site attributed);
- acquiring B while a path B -> ... -> A already exists for some held A is
  an ORDER INVERSION: two threads running both orders concurrently can
  deadlock. The witness raises :class:`LockOrderError` at the acquisition
  site (the earliest, most debuggable moment) AND records the inversion, so
  even if a broad handler swallows the raise, ``check_clean()`` still
  fails the run;
- re-acquiring a non-reentrant witnessed lock on the same thread is an
  immediate self-deadlock report instead of a silent hang.

With the flag unset (the default, and every production path)
:func:`named_lock` returns a plain ``threading.Lock``/``RLock`` — zero
overhead, zero behavior change. The wrapper intentionally does NOT support
``threading.Condition`` (Condition pokes lock internals); condition locks
(map_output_tracker, the job server's admission, the rate controller)
stay plain.

Role witnesses (vegalint v3) ride the same flag: the long-lived threads
call :func:`note_thread_role` at their entry point, which cross-checks
the OBSERVED thread identity against the declared role map
(vega_tpu_torch/lint/callgraph.ROLES — the same table the static VG016/VG019
rules propagate from), and driver-only functions call
:func:`assert_role` so a confined thread (worker task handler, streaming
receiver) reaching one fails the run with the offending call path. Both
record into the witness even when the raise is swallowed, so
``check_clean()`` still fails the session. With the flag unset every
role function is a no-op.

This module must import nothing beyond the stdlib: core modules construct
locks at import time, before torch or the rest of vega_tpu_torch is
loaded. (callgraph is imported lazily, only under the debug flag — it is
stdlib-pure too, but keeping the import-time surface minimal is the
contract.)
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """Two locks acquired in opposite orders (or a self-deadlock)."""


class RoleError(AssertionError):
    """Observed thread identity disagrees with the declared role map, or
    a confined thread reached a driver-only function."""


def enabled() -> bool:
    return os.environ.get("VEGA_TPU_DEBUG_SYNC") == "1"


class _Witness:
    """Global acquisition-order graph. One per process."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards the graph, never held while
        # blocking on a witnessed lock (check / record bracket the inner
        # acquire, they do not span it)
        # edge a -> b: b acquired while a held; value = first observed site
        self._edges: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()
        self.inversions: List[str] = []
        # every name a witness lock was built under, acquired or not
        self.names: Set[str] = set()
        # role -> thread names observed carrying it (role witnesses)
        self.roles_observed: Dict[str, Set[str]] = {}
        self.role_violations: List[str] = []

    # ------------------------------------------------------------ per thread
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # ---------------------------------------------------------------- graph
    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        if src == dst:
            return [src]
        parent = {src: src}
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for (a, b) in self._edges:
                    if a != u or b in parent:
                        continue
                    parent[b] = u
                    if b == dst:
                        path = [b]
                        while path[-1] != src:
                            path.append(parent[path[-1]])
                        return list(reversed(path))
                    nxt.append(b)
            frontier = nxt
        return None

    def _site(self, depth: int = 3) -> str:
        try:
            f = sys._getframe(depth)
            return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
        except (ValueError, AttributeError):
            return "?"

    # ------------------------------------------------------------- protocol
    def before_acquire(self, name: str, reentrant: bool) -> None:
        held = self._held()
        if name in held:
            if reentrant:
                return
            msg = (f"self-deadlock: non-reentrant lock '{name}' "
                   f"re-acquired on {threading.current_thread().name} "
                   f"at {self._site()} while already held")
            with self._mu:
                self.inversions.append(msg)
            raise LockOrderError(msg)
        with self._mu:
            for h in held:
                path = self._path(name, h)
                if path is None:
                    continue
                first = self._edges.get((path[0], path[1]), "?") \
                    if len(path) > 1 else "?"
                msg = (
                    f"lock-order inversion: acquiring '{name}' while "
                    f"holding '{h}' on "
                    f"{threading.current_thread().name} at "
                    f"{self._site()}, but the reverse order "
                    f"{' -> '.join(path)} was already observed "
                    f"(first at {first}); concurrent threads running "
                    "both orders deadlock")
                self.inversions.append(msg)
                raise LockOrderError(msg)

    def after_acquire(self, name: str, reentrant: bool) -> None:
        held = self._held()
        if reentrant and name in held:
            return  # recursive level, no new edges
        site = self._site()
        with self._mu:
            for h in held:
                self._edges.setdefault((h, name), site)
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        # Out-of-stack-order release is legal (Python locks allow it);
        # drop the most recent occurrence.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # --------------------------------------------------------------- roles
    def _call_path(self, skip: int = 2) -> str:
        """Compact caller chain for violation messages (innermost last)."""
        frames = traceback.extract_stack()[:-skip]
        tail = [f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in frames[-6:]]
        return " -> ".join(tail)

    def note_role(self, role: str) -> None:
        from vega_tpu_torch.lint import callgraph  # lazy: debug-flag-only path

        spec = callgraph.ROLES.get(role)
        tname = threading.current_thread().name
        if spec is None:
            msg = (f"role witness: '{role}' noted on thread '{tname}' is "
                   f"not in the declared role map "
                   f"(callgraph.ROLES) — add it there first; at "
                   f"{self._call_path()}")
            with self._mu:
                self.role_violations.append(msg)
            raise RoleError(msg)
        prefixes = spec["thread_prefixes"]
        if prefixes and not any(tname.startswith(p) for p in prefixes):
            msg = (f"role witness: thread '{tname}' noted role '{role}' "
                   f"but the declared map expects a name starting with "
                   f"{prefixes} — the static role map and the runtime "
                   f"disagree; fix whichever is wrong; at "
                   f"{self._call_path()}")
            with self._mu:
                self.role_violations.append(msg)
            raise RoleError(msg)
        self._tls.role = role
        with self._mu:
            self.roles_observed.setdefault(role, set()).add(tname)

    def current_role(self) -> Optional[str]:
        return getattr(self._tls, "role", None)

    def check_role(self, allowed: Tuple[str, ...]) -> None:
        from vega_tpu_torch.lint import callgraph  # lazy: debug-flag-only path

        role = self.current_role()
        if role is None or role not in callgraph.CONFINED_ROLES \
                or role in allowed:
            return  # un-noted threads and unconfined roles always pass
        msg = (f"role confinement violated: driver-only function reached "
               f"from confined role '{role}' on thread "
               f"'{threading.current_thread().name}' via "
               f"{self._call_path(skip=3)}")
        with self._mu:
            self.role_violations.append(msg)
        raise RoleError(msg)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        with self._mu:
            return {
                "locks": len({n for e in self._edges for n in e}),
                "names": sorted(self.names),
                "edges": len(self._edges),
                "inversions": list(self.inversions),
                "roles": {r: sorted(t)
                          for r, t in self.roles_observed.items()},
                "role_violations": list(self.role_violations),
            }


_WITNESS = _Witness()


def witness() -> _Witness:
    return _WITNESS


def check_clean() -> None:
    """Raise if any inversion OR role violation was recorded this process
    — even one whose in-place error was swallowed by a broad handler
    (exactly the blindness VG005 exists for)."""
    st = witness().stats()
    inv = st["inversions"]
    if inv:
        raise LockOrderError(
            f"{len(inv)} lock-order inversion(s) recorded:\n"
            + "\n".join(inv))
    rv = st["role_violations"]
    if rv:
        raise RoleError(
            f"{len(rv)} role violation(s) recorded:\n" + "\n".join(rv))


def note_thread_role(role: str) -> None:
    """Record the calling thread's declared role (no-op unless
    VEGA_TPU_DEBUG_SYNC=1). Placed at the entry point of each long-lived
    role thread; cross-checks the observed thread name against
    callgraph.ROLES and fails the run on disagreement."""
    if enabled():
        _WITNESS.note_role(role)


def current_role() -> Optional[str]:
    return _WITNESS.current_role() if enabled() else None


def assert_role(*allowed: str) -> None:
    """Guard for driver-only functions (no-op unless
    VEGA_TPU_DEBUG_SYNC=1): raises RoleError when called from a thread
    noted with a CONFINED role (worker task handler, streaming receiver)
    not in `allowed`. Un-noted threads — the driver main thread, test
    threads — always pass; this is the runtime mirror of VG019, not a
    general ACL."""
    if enabled():
        _WITNESS.check_role(allowed)


class WitnessLock:
    """threading.Lock with acquisition-order witnessing. API-compatible
    for `with`, acquire(blocking, timeout), release(), locked()."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()
        with _WITNESS._mu:
            _WITNESS.names.add(name)

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _WITNESS.before_acquire(self.name, self._reentrant)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _WITNESS.after_acquire(self.name, self._reentrant)
        return got

    def release(self) -> None:
        # Order matters: pop the witness record only after the inner
        # release cannot fail (releasing an unheld lock raises).
        self._inner.release()
        _WITNESS.on_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class WitnessRLock(WitnessLock):
    """Reentrant variant: recursive re-acquisition is legal and adds no
    edges; the witness entry pops on the outermost release only."""

    _reentrant = True

    def __init__(self, name: str):
        super().__init__(name)
        self._depth_tls = threading.local()

    def _make_inner(self):
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _WITNESS.before_acquire(self.name, True)
        got = self._inner.acquire(blocking, timeout)
        if got:
            depth = getattr(self._depth_tls, "d", 0)
            if depth == 0:
                _WITNESS.after_acquire(self.name, True)
            self._depth_tls.d = depth + 1
        return got

    def release(self) -> None:
        self._inner.release()
        depth = getattr(self._depth_tls, "d", 1) - 1
        self._depth_tls.d = depth
        if depth == 0:
            _WITNESS.on_release(self.name)


def named_lock(name: str, reentrant: bool = False, force: bool = False):
    """The project's lock constructor. Returns a plain threading lock
    unless VEGA_TPU_DEBUG_SYNC=1 (or force=True, for the witness's own
    tests), in which case the acquisition order of every named lock is
    recorded per thread and inversions raise LockOrderError."""
    if force or enabled():
        return WitnessRLock(name) if reentrant else WitnessLock(name)
    return threading.RLock() if reentrant else threading.Lock()
