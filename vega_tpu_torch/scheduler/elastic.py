"""The elastic executor fleet: the port's copy of
vega_tpu/scheduler/elastic.py.

ElasticController, a driver thread over a DistributedBackend, samples the
load every quarter of elastic_decision_interval_s (the arbiter's running
and queued tasks, and any registered load signal, per executor slot) and
acts when a watermark has held for a whole interval:

- scale up: demand per slot above elastic_scale_up_threshold spawns
  enough executors (backend.add_executor, in parallel; ExecutorAdded) to
  bring it back to the threshold, up to elastic_max_executors;
- scale down: load below elastic_scale_down_threshold with nothing queued
  decommissions one victim (fewest tasks in flight, then fewest
  registered shuffle bytes), down to elastic_min_executors.

A decommission (also callable directly) claims the slot (it takes no new
task and leaves the shuffle peers), waits up to decommission_timeout_s
for its tasks, then migrates its shuffle outputs: an output with another
real location, or one its parity group decodes, moves no bytes; a sole
copy is fetched off the victim and pushed (put_many) to a survivor, and
the tracker and the DAG scheduler's stages take the new location; what
cannot move is scrubbed for recompute. Then the worker is reaped and
ExecutorDecommissioned posted. A drain that times out (the
VEGA_TPU_FAULT_DECOMMISSION_HANG_S hook) goes to the executor-lost path
instead. Context.fleet_status() reports the controller's state.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from vega_tpu_torch import faults
from vega_tpu_torch.errors import FetchFailedError, NetworkError, VegaError
from vega_tpu_torch.lint.sync_witness import (
    assert_role,
    named_lock,
    note_thread_role,
)
from vega_tpu_torch.scheduler import events as ev

log = logging.getLogger(__name__)


class ElasticController:
    """Driver-side autoscaler over a DistributedBackend fleet.

    One background thread samples load every quarter decision interval
    and acts when a watermark has HELD for a full
    ``elastic_decision_interval_s`` — a single bursty sample never flaps
    the fleet. All actions run on the controller thread; ``decommission``
    is also a public entry (tests, operators) and is safe to call with
    the loop stopped."""

    def __init__(self, backend, arbiter, scheduler, conf, bus, env):
        self.backend = backend
        self.arbiter = arbiter
        self.scheduler = scheduler
        self.conf = conf
        self.bus = bus
        self.env = env  # the driver's Env: its trackers
        self._lock = named_lock("scheduler.elastic.ElasticController._lock")
        self._stop_event = threading.Event()
        # Context teardown (as opposed to merely pausing the control
        # loop): a mid-ladder decommission abandons itself on THIS flag
        # only, so an operator who stopped the loop can still retire
        # executors manually.
        self._teardown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Watermark clocks: when the load first crossed each threshold
        # (None = not currently crossed).
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_signal: Dict[str, float] = {}
        # Executor-seconds integral (the A/B's cost metric): fleet size
        # integrated over wall time, updated at every fleet change and
        # on read.
        self._track_t = time.monotonic()
        self._track_n = self._live_count()
        self._executor_seconds = 0.0
        self.counters: Dict[str, int] = {
            "scale_ups": 0, "scale_downs": 0, "scale_up_failures": 0,
        }
        # External demand feeds (streaming backpressure controller et
        # al.): zero-arg callables returning extra queued work units,
        # summed into _decide's demand each sample.
        self._load_signals: List = []

    def add_load_signal(self, fn) -> None:
        """Register an extra demand source for the control loop — e.g.
        the streaming RateController's pending-block count, so sustained
        stream pressure scales the fleet like a deep batch queue does.
        A signal that raises reads as 0 for that sample."""
        with self._lock:
            self._load_signals.append(fn)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._loop, name="elastic-controller", daemon=True)
            self._thread.start()

    def stop(self, teardown: bool = False) -> None:
        """Stop the control loop. ``teardown=True`` (Context.stop) also
        poisons in-flight/later decommissions — the backend is going
        away; a plain stop() merely pauses autoscaling and manual
        ``decommission`` keeps working."""
        if teardown:
            self._teardown.set()
        self._stop_event.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)

    # ------------------------------------------------------------- signals
    def _live_count(self) -> int:
        return len([row for row in self.backend.fleet_snapshot()
                    if row["alive"] and not row["draining"]])

    def _note_fleet(self) -> None:
        """Advance the executor-seconds integral to now."""
        with self._lock:
            now = time.monotonic()
            self._executor_seconds += self._track_n * (now - self._track_t)
            self._track_t = now
            self._track_n = self._live_count()

    def executor_seconds(self) -> float:
        """Fleet-size integral over wall time since construction — the
        cost side of the elastic A/B (a static max-size fleet pays
        max * wall)."""
        self._note_fleet()
        with self._lock:
            return self._executor_seconds

    def status(self) -> Dict:
        with self._lock:
            signal = dict(self._last_signal)
            counters = dict(self.counters)
        return {
            "enabled": bool(getattr(self.conf, "elastic_enabled", False)),
            "running": self._thread is not None,
            "min_executors": int(self.conf.elastic_min_executors),
            "max_executors": int(self.conf.elastic_max_executors),
            "live_executors": self._live_count(),
            "executor_seconds": round(self.executor_seconds(), 3),
            "last_signal": signal,
            **counters,
        }

    # ---------------------------------------------------------- decisions
    def _loop(self) -> None:
        note_thread_role("elastic")
        interval = max(0.05,
                       float(self.conf.elastic_decision_interval_s))
        while not self._stop_event.wait(max(0.05, interval / 4.0)):
            try:
                self._decide(interval)
            except Exception:  # noqa: BLE001 — the control loop must survive
                log.exception("elastic decision failed")

    def _decide(self, interval: float) -> None:
        conf = self.conf
        stats = self.arbiter.stats()
        live = self._live_count()
        slots = max(1, live) * max(1, int(conf.num_workers))
        with self._lock:
            signals = list(self._load_signals)
        extra = 0
        for fn in signals:
            try:
                extra += max(0, int(fn()))
            except Exception:  # noqa: BLE001 — a bad feed must not stop the loop
                log.debug("elastic load signal failed", exc_info=True)
        demand = stats["running"] + stats["queued"] + extra
        load = demand / slots
        now = time.monotonic()
        self._last_signal = {
            "running": stats["running"], "queued": stats["queued"],
            "extra": extra,
            "live": live, "slots": slots, "load": round(load, 4),
        }
        self._note_fleet()
        up_thr = float(conf.elastic_scale_up_threshold)
        down_thr = float(conf.elastic_scale_down_threshold)
        if load > up_thr and live < int(conf.elastic_max_executors):
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= interval:
                self._above_since = None
                self._scale_up(demand, live)
        elif load < down_thr and stats["queued"] == 0 \
                and live > int(conf.elastic_min_executors):
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= interval:
                self._below_since = None
                self._scale_down()
        else:
            self._above_since = None
            self._below_since = None

    def _scale_up(self, demand: int, live: int) -> None:
        """Spawn enough executors to bring demand-per-slot back to the
        threshold, bounded by elastic_max_executors. The batch spawns IN
        PARALLEL (one launch thread per new slot): each worker's
        readiness gate is ~1s of mostly-waiting, and a burst that needs
        two executors must not pay it twice in series — ramp latency is
        exactly what the A/B charges the elastic leg."""
        conf = self.conf
        per_exec = max(1, int(conf.num_workers)) \
            * max(1e-9, float(conf.elastic_scale_up_threshold))
        want = int(math.ceil(demand / per_exec))
        target = min(int(conf.elastic_max_executors),
                     max(live + 1, want))
        n = max(0, target - live)
        if n == 0 or self._stop_event.is_set():
            return

        def spawn() -> None:
            try:
                self.backend.add_executor()
            except (NetworkError, ValueError) as e:
                log.warning("elastic scale-up failed: %s", e)
                with self._lock:
                    self.counters["scale_up_failures"] += 1
                return
            with self._lock:
                self.counters["scale_ups"] += 1
            self._note_fleet()

        threads = [threading.Thread(target=spawn, daemon=True,
                                    name=f"elastic-spawn-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=45.0)
        # A new peer joined: drop the 5s-TTL shuffle-peer cache so the
        # driver's push/replica planes see it promptly.
        from vega_tpu_torch import dependency as _dependency

        _dependency._invalidate_peer_cache()

    def _pick_victim(self) -> Optional[str]:
        """Fewest in-flight dispatches first, then least registered
        shuffle bytes (MapOutputTracker size accounting), then id —
        the slot whose retirement costs the least migration work."""
        rows = [r for r in self.backend.fleet_snapshot()
                if r["alive"] and not r["draining"]]
        if len(rows) <= int(self.conf.elastic_min_executors):
            return None
        tracker = self.env.map_output_tracker
        workers = self.backend.service.workers

        def shuffle_bytes(executor_id: str) -> int:
            info = workers.get(executor_id) or {}
            uri = info.get("shuffle_uri")
            if not uri or tracker is None \
                    or not hasattr(tracker, "server_bytes"):
                return 0
            return tracker.server_bytes(uri)

        ranked = sorted(rows, key=lambda r: (
            r["inflight"], shuffle_bytes(r["executor_id"]),
            r["executor_id"]))
        return ranked[0]["executor_id"]

    def _scale_down(self) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        try:
            self.decommission(victim, reason="sustained idle fleet")
        except VegaError as e:
            # Benign race: the victim died or was claimed between the
            # snapshot and the claim — not an error, just next tick's
            # problem. Counted only on success.
            log.info("scale-down of %s skipped: %s", victim, e)
            return
        with self._lock:
            self.counters["scale_downs"] += 1

    # ------------------------------------------------------ decommission
    def decommission(self, executor_id: str,
                     reason: str = "scale-down") -> Dict:
        """Gracefully retire one executor (the ladder in the module
        docstring). Returns the migration accounting; also posted as
        ``ExecutorDecommissioned``. Safe against a wedged victim: the
        drain escalates to the executor-lost path at
        ``decommission_timeout_s``. Refuses to shrink a LIVE fleet below
        ``elastic_min_executors`` — with the control loop off nothing
        would ever add capacity back (lower the bound first to retire the
        last executors on purpose). An unexpected error mid-ladder
        releases the drain claim so the slot is not stranded draining."""
        assert_role("elastic")  # fleet mutation: driver-side control only
        backend = self.backend
        conf = self.conf
        t0 = time.time()
        info = backend.service.workers.get(executor_id) or {}
        uri = info.get("shuffle_uri")
        host = info.get("host", "")
        # Claim + min-fleet floor in ONE atomic backend step: racing
        # decommissions can neither double-run one victim's ladder nor
        # jointly shrink the fleet below the floor via different victims.
        floor = max(0, int(conf.elastic_min_executors))
        claim = backend.claim_decommission(executor_id, min_live=floor)
        if claim == "floor":
            raise VegaError(
                f"decommissioning {executor_id!r} would shrink the fleet "
                f"below elastic_min_executors={floor}; lower the bound "
                "first if that is intended")
        if claim != "ok":
            raise VegaError(
                f"executor {executor_id!r} unknown or already "
                "decommissioning")
        log.info("decommissioning %s (%s); draining up to %.1fs",
                 executor_id, reason, conf.decommission_timeout_s)
        try:
            return self._decommission_claimed(executor_id, uri, host, t0)
        except BaseException:
            # The ladder died unexpectedly (a bug, an unwrapped OSError):
            # release the drain claim so the slot is not silently
            # stranded — excluded from placement, never reaped, never
            # respawned — for the process lifetime. A no-op when
            # remove_executor already reaped the slot.
            backend.release_decommission(executor_id)
            raise

    def _decommission_claimed(self, executor_id: str, uri: Optional[str],
                              host: str, t0: float) -> Dict:
        """The ladder proper; the caller holds the drain claim."""
        backend = self.backend
        conf = self.conf
        # The driver's peer cache must stop naming the victim NOW (worker
        # copies age out on their 5s TTL; the registry itself already
        # excludes draining slots).
        from vega_tpu_torch import dependency as _dependency

        _dependency._invalidate_peer_cache()
        # Drain: wait for the victim's in-flight dispatches. The fault
        # hook models a wedged victim by holding the slot "busy" past the
        # timeout — same observable as a task that never finishes.
        hang_s = faults.get().decommission_hang(executor_id)
        hang_until = time.time() + hang_s
        deadline = time.time() + float(conf.decommission_timeout_s)
        counts = {"migrated_outputs": 0, "migrated_bytes": 0,
                  "replica_covered": 0, "recomputed_outputs": 0}
        drained = False
        while time.time() < deadline:
            if self._teardown.is_set():
                # Context.stop() raced a mid-drain decommission: abandon
                # it rather than drive migration/reap against a backend
                # that is tearing down (a mere control-loop stop() does
                # NOT land here — manual decommission keeps working). The
                # claim is released; the stopping backend reaps the
                # process itself.
                log.info("decommission of %s abandoned: context "
                         "teardown", executor_id)
                backend.release_decommission(executor_id)
                return {"executor_id": executor_id, "aborted": True,
                        "forced": False,
                        "duration_s": time.time() - t0, **counts}
            busy = backend.executor_inflight().get(executor_id, 0)
            if busy == 0 and time.time() >= hang_until:
                drained = True
                break
            time.sleep(0.05)
        if drained:
            counts = self._migrate(uri)
        else:
            # Escalate: the executor-lost path tears down the
            # victim's sockets, bulk-unregisters its outputs (replicas
            # keep serving), scrubs stages and fails affected jobs'
            # stages proactively. Everything unreplicated recomputes.
            log.warning("decommission drain of %s timed out; escalating "
                        "to the executor-lost path", executor_id)
            tracker = self.env.map_output_tracker
            covered: Dict = {}
            if uri and tracker is not None \
                    and hasattr(tracker, "decodable_without"):
                try:
                    covered = tracker.decodable_without(uri)
                except Exception as e:  # noqa: BLE001 — accounting only
                    log.warning("parity-coverage lookup for %s failed "
                                "(%s); counting as recompute", uri, e)
                    covered = {}
            if uri and tracker is not None \
                    and hasattr(tracker, "outputs_on_server"):
                for _sid, _mid, locs, _sizes in \
                        tracker.outputs_on_server(uri):
                    # Parity-covered sole copies (shuffle_coding != none)
                    # count as covered: the lost-path sweep installs their
                    # coded: pseudo-locations and reducers reconstruct.
                    if len(locs) > 1 or (_sid, _mid) in covered:
                        counts["replica_covered"] += 1
                    else:
                        counts["recomputed_outputs"] += 1
            backend.declare_lost(executor_id, "decommission drain timeout")
        # Cached partitions died with the process on either path.
        cache_tracker = self.env.cache_tracker
        if cache_tracker is not None \
                and hasattr(cache_tracker, "drop_executor"):
            cache_tracker.drop_executor(executor_id)
        backend.remove_executor(executor_id, graceful=drained)
        self._note_fleet()
        duration = time.time() - t0
        log.info("decommissioned %s in %.2fs (%s): %s", executor_id,
                 duration, "drained" if drained else "FORCED", counts)
        event = ev.ExecutorDecommissioned(
            executor_id=executor_id, host=host, forced=not drained,
            duration_s=duration, **counts)
        sink = self.bus.post if self.bus is not None \
            else getattr(backend, "event_sink", None)
        if sink is not None:
            sink(event)
        return {"executor_id": executor_id, "forced": not drained,
                "duration_s": duration, **counts}

    def _migrate(self, uri: Optional[str]) -> Dict[str, int]:
        """Move the victim's live shuffle state to survivors: replica-
        covered outputs just drop the leaving location; sole-copy bucket
        rows are fetched off the (still-serving) victim and re-pushed to
        a surviving peer over the replication plane's put_many, then the
        tracker and cached stages rebind to the survivor. Unknown bucket
        counts or a failed copy degrade to scrub-and-recompute — never
        a wrong answer, never a stranded reducer."""
        counts = {"migrated_outputs": 0, "migrated_bytes": 0,
                  "replica_covered": 0, "recomputed_outputs": 0}
        tracker = self.env.map_output_tracker
        if not uri or tracker is None \
                or not hasattr(tracker, "outputs_on_server"):
            return counts
        from vega_tpu_torch.distributed.shuffle_server import (
            check_status, fetch_remote, push_buckets_remote)

        manifest = tracker.outputs_on_server(uri)
        survivors = [u for u in self.backend.shuffle_peer_uris()
                     if u != uri]
        # Coded shuffle: outputs whose ONLY copy sits on the victim but
        # whose parity group (hosted on a survivor) can still decode them.
        # Treated like replica-covered — no bytes move; the sweep below
        # installs their coded: pseudo-locations and the rebind points
        # cached stages at them, so reducers reconstruct on demand.
        parity_covered: Dict = {}
        if hasattr(tracker, "decodable_without"):
            try:
                parity_covered = tracker.decodable_without(uri)
            except Exception as e:  # noqa: BLE001 — coverage is best-effort
                log.warning("parity-coverage lookup for %s failed (%s); "
                            "sole copies migrate or recompute", uri, e)
                parity_covered = {}
        rebind: Dict[Tuple[int, int], str] = {}
        lost: Set[Tuple[int, int]] = set()
        rotation = 0
        # Probed lazily before the first byte moves: a victim that is
        # already dead/wedged (an operator can decommission a non-alive
        # slot) must short-circuit every sole-copy row straight to the
        # recompute path instead of burning fetch_retries per bucket.
        victim_up: Optional[bool] = None
        for shuffle_id, map_id, locs, sizes in manifest:
            if self._teardown.is_set():
                # Context teardown mid-migration: stop moving bytes.
                # Untouched sole-copy entries fall into the sweep's scrub
                # path — recompute-on-demand, which is moot for a
                # stopping context and never wrong for a surviving one.
                break
            if any(u != uri and not u.startswith("coded:") for u in locs):
                counts["replica_covered"] += 1
                continue
            pseudo = parity_covered.get((shuffle_id, map_id))
            if pseudo is not None:
                counts["replica_covered"] += 1
                rebind[(shuffle_id, map_id)] = pseudo
                continue
            if victim_up is None and survivors and sizes is not None:
                victim_up = check_status(uri, timeout=5.0) is not None
                if not victim_up:
                    log.warning("decommission victim %s is unreachable; "
                                "scrubbing its sole-copy outputs for "
                                "recompute instead of migrating", uri)
            if not survivors or sizes is None or not victim_up:
                # No peer to take the row, an unknown reduce count (no
                # size accounting), or an unreachable victim: recompute
                # path.
                lost.add((shuffle_id, map_id))
                counts["recomputed_outputs"] += 1
                continue
            target = survivors[rotation % len(survivors)]
            rotation += 1
            try:
                blobs = [fetch_remote(uri, shuffle_id, map_id, reduce_id)
                         for reduce_id in range(len(sizes))]
                push_buckets_remote(target, shuffle_id, map_id, blobs)
            except (NetworkError, FetchFailedError) as e:
                log.warning("migration of shuffle %d map %d off %s "
                            "failed (%s); scrubbing for recompute",
                            shuffle_id, map_id, uri, e)
                lost.add((shuffle_id, map_id))
                counts["recomputed_outputs"] += 1
                continue
            tracker.replace_location(shuffle_id, map_id, uri, target)
            rebind[(shuffle_id, map_id)] = target
            counts["migrated_outputs"] += 1
            counts["migrated_bytes"] += sum(len(b) for b in blobs)
        # One sweep drops the victim everywhere it still appears
        # (replica-covered and lost entries) with ONE generation bump so
        # in-flight reducers re-resolve; if only rebinds happened the
        # sweep removes nothing, so bump explicitly — locations changed.
        removed = tracker.unregister_server_outputs(uri)
        if not removed and (rebind or lost) \
                and hasattr(tracker, "increment_generation"):
            tracker.increment_generation()
        if self.scheduler is not None and (manifest or rebind or lost):
            self.scheduler.apply_decommission(uri, rebind, lost)
        return counts
