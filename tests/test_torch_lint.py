"""The port's vegalint (vega_tpu_torch.lint) held against vega_tpu's.

Every ported rule, VG000 and VG002-VG020, runs on a fixture that fires
and one that stays silent, written into tmp trees as tests/test_lint.py
writes them: the reference's engine reads the vega_tpu layout, the port's
the same source rewritten to vega_tpu_torch's names (its flat device
modules stand where tpu/ stands; VG002 and VG006 speak torch where the
reference speaks jax, on the same lines). Both engines must give the
same rule ids on the same lines. VG001 guards a jax shim the port does
not have and is the one rule not ported.

Then the port's own sweep (vega_tpu_torch and chip_smoke.py) is clean,
each suppression justified and the warm sweep fully cached and fast; the
two engines keep caches of their own; the role map resolves against the
port's tree; and the CUDA build cannot wait without bound.
"""

import json
import os
import stat
import textwrap
import time

import pytest

from vega_tpu.lint import callgraph as ref_callgraph
from vega_tpu.lint import engine as ref_engine
from vega_tpu.lint.engine import run_lint as ref_run_lint
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch.errors import KernelError
from vega_tpu_torch.lint import callgraph
from vega_tpu_torch.lint import engine
from vega_tpu_torch.lint.__main__ import main
from vega_tpu_torch.lint.engine import all_rules, gather_extracts, run_lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SWEEP = [os.path.join(ROOT, "vega_tpu_torch"),
              os.path.join(ROOT, "chip_smoke.py")]
REF_SWEEP = [os.path.join(ROOT, "vega_tpu"), os.path.join(ROOT, "tests"),
             os.path.join(ROOT, "bench.py")]


def _port_path(ref_rel):
    """vega_tpu/tpu/x.py -> vega_tpu_torch/x.py; vega_tpu/y -> ..._torch/y."""
    if ref_rel.startswith("vega_tpu/tpu/"):
        return "vega_tpu_torch/" + ref_rel[len("vega_tpu/tpu/"):]
    return "vega_tpu_torch/" + ref_rel[len("vega_tpu/"):]


def _port_src(src):
    return src.replace("vega_tpu.", "vega_tpu_torch.").replace(
        "vega_tpu/", "vega_tpu_torch/")


def F(ref_rel, src, port_rel=None, port_src=None):
    """One fixture file: the reference's path and source, and the port's
    where they are not the plain rewrite."""
    return (ref_rel, textwrap.dedent(src), port_rel or _port_path(ref_rel),
            textwrap.dedent(port_src) if port_src is not None
            else _port_src(textwrap.dedent(src)))


def C(rule_id, case, fires, *files, select=True):
    return pytest.param(rule_id, fires, list(files),
                        [rule_id] if select else None,
                        id=f"{rule_id}-{case}-{'fires' if fires else 'silent'}")


_VG010_ENV_PY = """\
    import dataclasses

    @dataclasses.dataclass
    class Configuration:
        frob_interval_s: float = 1.0
        safe_knob: int = 3
    """

_VG011_EVENTS_PY = """\
    import dataclasses

    @dataclasses.dataclass
    class Event:
        time: float = 0.0

    @dataclasses.dataclass
    class FrobDone(Event):
        frob_id: int = -1
        wall_s: float = 0.0

    @dataclasses.dataclass
    class FrobLost(Event):
        frob_id: int = -1

    class MetricsListener:
        def on_event(self, event):
            if isinstance(event, FrobDone):
                self.total = getattr(self, "total", 0) + event.wall_s
    """

CASES = [
    # ------------------------------------------------------------ VG000
    C("VG000", "pragma-without-justification", True, F("vega_tpu/newmod.py", """\
        def f(sock):
            # vegalint: ignore[VG005]
            return sock
        """), select=False),
    C("VG000", "unused-and-unknown-pragmas", True, F("vega_tpu/newmod.py", """\
        def fine():
            return 1  # vegalint: ignore[VG004] — nothing fires here

        def typo():
            return 2  # vegalint: ignore[VG999] — no such rule
        """), select=False),
    C("VG000", "justified-pragma", False, F("vega_tpu/scheduler/newsvc.py", """\
        def dispatch(sock):
            try:
                return sock.recv(4)
            # vegalint: ignore[VG005] — fixture: the caller logs
            except Exception:
                return None
        """), select=False),
    C("VG000", "pragma-in-docstring", False, F("vega_tpu/newmod.py", '''\
        """Docs may say # vegalint: ignore[VG004] without being one."""
        '''), select=False),
    # ------------------------------------------------------------ VG002
    C("VG002", "import-time-probe", True, F("vega_tpu/newmod.py", """\
        import jax
        N = len(jax.devices())
        """, port_src="""\
        import torch
        N = torch.cuda.device_count()
        """)),
    C("VG002", "module-level-call-to-probing-fn", True, F("vega_tpu/newmod.py", """\
        import jax

        def probe():
            return jax.default_backend()

        BACKEND = probe()
        """, port_src="""\
        import torch

        def probe():
            return torch.cuda.get_device_name(0)

        BACKEND = probe()
        """)),
    C("VG002", "else-of-main-guard", True, F("vega_tpu/newmod.py", """\
        import jax

        if __name__ == "__main__":
            pass
        else:
            N = len(jax.devices())
        """, port_src="""\
        import torch

        if __name__ == "__main__":
            pass
        else:
            N = torch.cuda.is_available()
        """)),
    C("VG002", "inside-functions-and-main-guard", False, F("vega_tpu/newmod.py", """\
        import jax

        def backend():
            return jax.default_backend()

        if __name__ == "__main__":
            print(jax.devices())
        """, port_src="""\
        import torch

        def backend():
            return torch.cuda.current_device()

        if __name__ == "__main__":
            print(torch.cuda.device_count())
        """)),
    # ------------------------------------------------------------ VG003
    C("VG003", "lock-order-cycle", True, F("vega_tpu/newmod.py", """\
        import threading

        a_lock = threading.Lock()
        b_lock = threading.Lock()

        def forward():
            with a_lock:
                with b_lock:
                    pass

        def backward():
            with b_lock:
                with a_lock:
                    pass
        """)),
    C("VG003", "consistent-order", False, F("vega_tpu/newmod.py", """\
        import threading

        a_lock = threading.Lock()
        b_lock = threading.Lock()

        def one():
            with a_lock:
                with b_lock:
                    pass

        def two():
            with a_lock:
                with b_lock:
                    pass
        """)),
    C("VG003", "blocking-call-under-cache-lock", True, F("vega_tpu/newcache.py", """\
        import threading

        class ThingCache:
            def __init__(self):
                self._lock = threading.Lock()

            def read(self, mesh_lib, arr):
                with self._lock:
                    return mesh_lib.host_get(arr)
        """)),
    C("VG003", "one-call-hop-and-nested-def", False, F("vega_tpu/newcache.py", """\
        import threading

        class ThingStore:
            def __init__(self):
                self._lock = threading.Lock()

            def _fetch(self, mesh_lib, arr):
                return mesh_lib.host_get(arr)

            def read(self, arr):
                with self._lock:
                    def later():
                        return arr.result()
                    return later
        """)),
    C("VG003", "named-lock-self-deadlock", True, F("vega_tpu/newmod.py", """\
        from vega_tpu.lint.sync_witness import named_lock

        big_lock = named_lock("newmod.big_lock")

        def recurse():
            with big_lock:
                with big_lock:
                    pass
        """)),
    C("VG003", "reentrant-named-lock", False, F("vega_tpu/newmod.py", """\
        from vega_tpu.lint.sync_witness import named_lock

        big_lock = named_lock("newmod.big_lock", reentrant=True)

        def recurse():
            with big_lock:
                with big_lock:
                    pass
        """)),
    # ------------------------------------------------------------ VG004
    C("VG004", "materializing-reader", True, F("vega_tpu/tpu/newrdd.py", """\
        class Node:
            @property
            def hash_placed(self):
                self._settle_placement()
                return self._hash_placed

            @property
            def key_sorted(self):
                return self.block().sorted
        """)),
    C("VG004", "pure-reader", False, F("vega_tpu/tpu/newrdd.py", """\
        class Node:
            @property
            def hash_placed(self):
                return self.parent.hash_placed

            @property
            def key_sorted(self):
                return False
        """)),
    # ------------------------------------------------------------ VG005
    C("VG005", "blind-broad-except", True, F("vega_tpu/distributed/newsvc.py", """\
        def dispatch(sock):
            try:
                return sock.recv(4)
            except Exception:
                return None
        """)),
    C("VG005", "logged-or-reraised", False, F("vega_tpu/shuffle/newfetch.py", """\
        import logging

        log = logging.getLogger("vega_tpu")

        def a(sock):
            try:
                return sock.recv(4)
            except Exception:
                log.exception("recv failed")
                return None

        def b(sock):
            try:
                return sock.recv(4)
            except BaseException as exc:
                raise RuntimeError("fetch failed") from exc
        """)),
    C("VG005", "out-of-scope-dir", False, F("vega_tpu/io/newreader.py", """\
        def parse(s):
            try:
                return int(s)
            except Exception:
                return None
        """)),
    # ------------------------------------------------------------ VG006
    C("VG006", "host-syncs-in-kernel-module", True, F("vega_tpu/tpu/kernels.py", """\
        import jax.numpy as jnp

        def shard_op(col, count):
            n = int(jnp.sum(col))
            hits = jnp.nonzero(col)[0]
            return col.max().item(), n, hits
        """, port_src="""\
        import torch

        def shard_op(col, count):
            n = int(torch.sum(col))
            hits = torch.nonzero(col)[0]
            return col.max().item(), n, hits
        """)),
    C("VG006", "fn-handed-to-a-compiler", True, F("vega_tpu/tpu/newrdd.py", """\
        import jax.numpy as jnp

        def plan(mesh):
            def step(col, count):
                return jnp.unique(col)

            return _shard_program(mesh, step, 2, None)
        """, port_rel="vega_tpu_torch/dense_rdd.py", port_src="""\
        import torch

        def plan(mesh):
            def step(col, count):
                return col.unique()

            return torch.compile(step)
        """)),
    C("VG006", "static-size-and-host-code", False, F("vega_tpu/tpu/kernels.py", """\
        import jax.numpy as jnp

        def shard_op(col, capacity):
            hits = jnp.nonzero(col, size=capacity, fill_value=0)[0]
            return hits

        def shard_op2(col, n):
            for _ in range(max(1, int(n).bit_length())):
                col = col * 2
            return col
        """, port_src="""\
        import torch

        def shard_op(col, capacity):
            hits = torch.nonzero_static(col, size=capacity)[:, 0]
            return hits

        def shard_op2(col, n):
            for _ in range(max(1, int(n).bit_length())):
                col = col * 2
            return col
        """)),
    C("VG006", "host-fold-outside-device-functions", False, F("vega_tpu/tpu/newrdd.py", """\
        import numpy as np

        def collect_scalar(partials):
            return np.asarray(partials).sum().item()
        """, port_rel="vega_tpu_torch/dense_rdd.py")),
    # ------------------------------------------------------------ VG007
    C("VG007", "shared-pool-submit-then-wait", True, F("vega_tpu/scheduler/newsched.py", """\
        class Backend:
            def run_sync(self, task):
                fut = self._pool.submit(task.run)
                return fut.result()
        """)),
    C("VG007", "local-pool-or-timeout", False, F("vega_tpu/scheduler/newsched.py", """\
        from concurrent.futures import ThreadPoolExecutor

        def run_batch(tasks):
            with ThreadPoolExecutor(2) as tp:
                futs = [tp.submit(t) for t in tasks]
                return [f.result() for f in futs]

        class Backend:
            def run_bounded(self, task, conf):
                fut = self._pool.submit(task.run)
                return fut.result(timeout=conf.poll_timeout_s)
        """)),
    # ------------------------------------------------------------ VG008
    C("VG008", "direct-scheduler-entry", True, F("vega_tpu/tpu/newplane.py", """\
        def run_now(self, rdd, func):
            return self.scheduler.run_job(rdd, func)

        def run_listener(scheduler, rdd, func, parts, cb):
            return scheduler.run_job_with_listener(rdd, func, parts, cb)

        def run_inner(self, rdd, func, parts):
            return self.sched._run_job_inner(rdd, func, parts, None)
        """)),
    C("VG008", "context-facade", False, F("vega_tpu/tpu/newplane.py", """\
        def run_via_facade(ctx, rdd, func):
            return ctx.run_job(rdd, func)

        def run_via_context_attr(self, rdd, func):
            return self.context.run_job(rdd, func)
        """)),
    C("VG008", "allowed-files", False, *[F(rel, """\
        def drive(self, rdd, func, parts, job):
            return self.scheduler._run_job_inner(rdd, func, parts,
                                                 None, job=job)
        """) for rel in ("vega_tpu/context.py", "vega_tpu/rdd/newact.py",
                         "vega_tpu/scheduler/jobserver.py")]),
    # ------------------------------------------------------------ VG009
    C("VG009", "unmatched-send-and-dead-arm", True, F("vega_tpu/distributed/newproto.py", """\
        from vega_tpu.distributed import protocol

        def client(sock):
            protocol.send_msg(sock, "frob", 1)

        def handler(sock):
            msg_type, payload = protocol.recv_msg(sock)
            if msg_type == "defrob":
                protocol.send_msg(sock, "frob_done", None)
        """)),
    C("VG009", "matched-grammar", False, F("vega_tpu/distributed/newproto.py", """\
        from vega_tpu.distributed import protocol

        def client(sock):
            protocol.send_msg(sock, "frob", 1)
            reply_type, _ = protocol.recv_msg(sock)
            if reply_type == "frob_done":
                return True

        def handler(sock):
            msg_type, payload = protocol.recv_msg(sock)
            if msg_type == "frob":
                protocol.send_msg(sock, "frob_done", None)
        """)),
    # ------------------------------------------------------------ VG010
    C("VG010", "unpropagated-read-and-typo", True,
      F("vega_tpu/env.py", _VG010_ENV_PY),
      F("vega_tpu/distributed/backend.py", """\
        def launch(conf):
            return {"VEGA_TPU_" "SAFE_KNOB": str(conf.safe_knob)}
        """),
      F("vega_tpu/distributed/worker.py", """\
        import os

        def serve(conf):
            period = conf.frob_interval_s       # read, not propagated
            typo = os.environ.get("VEGA_TPU_" "FROB_INTRVAL_S")
            return period, typo
        """)),
    C("VG010", "propagated-and-resolvable", False,
      F("vega_tpu/env.py", _VG010_ENV_PY),
      F("vega_tpu/distributed/backend.py", """\
        def launch(conf):
            return {
                "VEGA_TPU_" "FROB_INTERVAL_S": str(conf.frob_interval_s),
                "VEGA_TPU_" "SAFE_KNOB": str(conf.safe_knob),
            }
        """),
      F("vega_tpu/distributed/worker.py", """\
        import os

        def serve(conf):
            period = conf.frob_interval_s
            ok = os.environ.get("VEGA_TPU_" "SAFE_KNOB")
            return period, ok
        """)),
    # ------------------------------------------------------------ VG011
    C("VG011", "misspelled-read-and-unaggregated-emit", True,
      F("vega_tpu/scheduler/events.py", _VG011_EVENTS_PY),
      F("vega_tpu/scheduler/newlistener.py", """\
        from vega_tpu.scheduler.events import FrobDone, FrobLost

        class Watcher:
            def on_event(self, event):
                if isinstance(event, FrobDone):
                    print(event.walls_s)        # misspelled field
                print(event.no_such_field)      # on no event class

        def emit(bus, fid):
            bus.post(FrobLost(frob_id=fid))     # never aggregated
        """)),
    C("VG011", "conforming-listener", False,
      F("vega_tpu/scheduler/events.py", _VG011_EVENTS_PY),
      F("vega_tpu/scheduler/newlistener.py", """\
        from vega_tpu.scheduler.events import FrobDone

        class Watcher:
            def on_event(self, event):
                if isinstance(event, FrobDone):
                    print(event.frob_id, event.wall_s, event.time)
                print(event.time)

        def emit(bus, fid):
            bus.post(FrobDone(frob_id=fid))     # aggregated
        """)),
    # ------------------------------------------------------------ VG012
    C("VG012", "unbounded-socket-ops", True, F("vega_tpu/distributed/newio.py", """\
        import socket

        def fetch(sock, fut):
            sock.settimeout(None)
            data = sock.recv(4096)
            peer = socket.create_connection(("h", 1))
            return data, fut.result()
        """)),
    C("VG012", "streaming-receiver-read", True, F("vega_tpu/streaming/badrecv.py", """\
        def pull(sock):
            return sock.recv(4096)
        """)),
    C("VG012", "deadlined-ops", False, F("vega_tpu/distributed/newio.py", """\
        import socket

        def fetch(sock, fut, deadline_s):
            sock.settimeout(deadline_s)
            peer = socket.create_connection(("h", 1), timeout=deadline_s)
            return fut.result(timeout=deadline_s)
        """)),
    C("VG012", "out-of-scope-dir", False, F("vega_tpu/scheduler/newsched2.py", """\
        def wait(fut):
            return fut.result()
        """)),
    # ------------------------------------------------------------ VG013
    C("VG013", "materializing-calls-in-planning", True, F("vega_tpu/frame/newplanner.py", """\
        def lower(node, rdd):
            rows = rdd.collect()
            blk = node.block()
            counts = blk.counts_np
            return rows, counts
        """)),
    C("VG013", "lazy-planning-api-and-outside", False,
      F("vega_tpu/frame/newplanner.py", """\
        def lower(node, exprs):
            staged = node.reduce_by_key(op="add")
            return staged.sort_by_key(ascending=True)
        """),
      F("vega_tpu/frame/api.py", """\
        def collect_columns(compiled):
            return compiled.rdd.collect_arrays()
        """),
      F("vega_tpu/tpu/newthing.py", """\
        def read(rdd):
            return rdd.collect()
        """)),
    # ------------------------------------------------------------ VG014
    C("VG014", "missing-single-shard-gate", True, F("vega_tpu/tpu/newx.py", """\
        def shiny_exchange(cols, count, bucket, n_shards, slot_capacity,
                           out_capacity):
            return cols, count, False
        """, port_rel="vega_tpu_torch/ring.py")),
    C("VG014", "return-breaks-the-triple", True, F("vega_tpu/tpu/newx2.py", """\
        def lossy_exchange(cols, count, bucket, n_shards, slot_capacity,
                           out_capacity):
            if n_shards == 1:
                return passthrough_exchange(cols, count, 4, out_capacity)
            return cols, count
        """, port_rel="vega_tpu_torch/kernels.py")),
    C("VG014", "conforming-exchange", False, F("vega_tpu/tpu/newx3.py", """\
        def blocked_exchange(cols, count, bucket, n_shards, slot_capacity,
                             out_capacity, group=1):
            if n_shards == 1:
                return passthrough_exchange(cols, count, 4, out_capacity)
            if group == 1:
                return ring_exchange(cols, count, bucket, n_shards,
                                     slot_capacity, out_capacity)
            return cols, count, False
        """, port_rel="vega_tpu_torch/ring.py")),
    C("VG014", "exempt-shapes", False,
      F("vega_tpu/tpu/newx4.py", """\
        def plan_some_exchange(n_shards, capacity, slot_capacity):
            return capacity

        def _inner_exchange(cols, count, bucket, n_shards):
            return cols
        """, port_rel="vega_tpu_torch/exchange_plan.py"),
      F("vega_tpu/other/newx5.py", """\
        def weird_exchange(cols, count, bucket, n_shards):
            return cols
        """)),
    # ------------------------------------------------------------ VG015
    C("VG015", "state-mutation-outside-commit-api", True, F("vega_tpu/streaming/rogue.py", """\
        from vega_tpu.rdd.checkpoint import CheckpointRDD, CommitLog

        def hack(store, rdd):
            store._state["k"] = 1
            store.last_committed_batch = 7
            log = CommitLog("/tmp/x")
            CheckpointRDD.write(rdd, "/tmp/y")
        """)),
    C("VG015", "state-py-reads-and-outside", False,
      F("vega_tpu/streaming/state.py", """\
        class StateStore:
            def __init__(self):
                self._state = {}
                self.last_committed_batch = -1
        """),
      F("vega_tpu/streaming/ctx2.py", """\
        def tick(store, batch_id, offsets, updates):
            frontier = store.last_committed_batch
            return store.apply_batch(batch_id, offsets, updates)
        """),
      F("vega_tpu/other/free.py", """\
        class Thing:
            def __init__(self):
                self._state = {}
        """)),
    # ------------------------------------------------------------ VG016
    C("VG016", "blocking-op-through-the-call-graph", True, F("vega_tpu/scheduler/elastic.py", """\
        class ElasticController:
            def _loop(self):
                self._decide()

            def _decide(self):
                self._drain_all()

            def _drain_all(self):
                for t in self.threads:
                    t.join()
        """)),
    C("VG016", "unbounded-build-from-the-dag-loop", True, F("vega_tpu/scheduler/dag.py", """\
        import subprocess

        class DAGScheduler:
            def _run_job_inner(self, rdd):
                return self._build(rdd)

            def _build(self, rdd):
                return subprocess.run(["nvcc", rdd], check=False)
        """)),
    C("VG016", "spawn-boundary-ends-the-role", False, F("vega_tpu/scheduler/elastic.py", """\
        import threading

        class ElasticController:
            def _loop(self):
                threading.Thread(target=self._kill, daemon=True).start()

            def _kill(self):
                self.proc.wait()
        """)),
    C("VG016", "bounded-waits", False, F("vega_tpu/scheduler/elastic.py", """\
        import subprocess

        class ElasticController:
            def _loop(self):
                self._decide()

            def _decide(self):
                for t in self.threads:
                    t.join(timeout=45.0)
                self.future.result(timeout=10.0)
                subprocess.run(["true"], timeout=300.0, check=False)
        """)),
    C("VG016", "unreachable-blocking-op", False, F("vega_tpu/scheduler/helpers.py", """\
        def drain_all(threads):
            for t in threads:
                t.join()
        """)),
    # ------------------------------------------------------------ VG017
    C("VG017", "driver-handle-capture", True, F("vega_tpu/rdd/newop.py", """\
        def bad(rdd, owner):
            sched = owner.scheduler
            return rdd.map(lambda x: (sched, x))
        """)),
    C("VG017", "env-and-lock-captures", True, F("vega_tpu/rdd/newop.py", """\
        import threading

        from vega_tpu.env import Env

        def bad_env(rdd):
            env = Env.get()
            return rdd.filter(lambda x: env is not None)

        def bad_lock(rdd):
            mu = threading.Lock()

            def body(it):
                with mu:
                    yield from it

            return rdd.map_partitions(body)
        """)),
    C("VG017", "plain-data-capture", False, F("vega_tpu/rdd/newop.py", """\
        def good(rdd, n):
            scale = n * 2
            return rdd.map(lambda x: x * scale)
        """)),
    # ------------------------------------------------------------ VG018
    C("VG018", "unreleased-socket", True, F("vega_tpu/distributed/newio.py", """\
        import socket

        def bad(host, port):
            s = socket.create_connection((host, port), timeout=5.0)
            s.sendall(b"ping")
            s.close()
        """)),
    C("VG018", "released-or-transferred", False, F("vega_tpu/distributed/newio.py", """\
        import socket
        from contextlib import closing

        def finally_release(host, port):
            s = socket.create_connection((host, port), timeout=5.0)
            try:
                s.sendall(b"ping")
            finally:
                s.close()

        def closing_release(host, port):
            with closing(socket.create_connection((host, port),
                                                  timeout=5.0)) as s:
                s.sendall(b"ping")

        def ownership_transfer(host, port):
            s = socket.create_connection((host, port), timeout=5.0)
            return s

        def stored_transfer(pool, host, port):
            s = socket.create_connection((host, port), timeout=5.0)
            pool.register(s)
        """)),
    C("VG018", "out-of-scope-dir", False, F("vega_tpu/rdd/newio.py", """\
        import socket

        def bad(host, port):
            s = socket.create_connection((host, port), timeout=5.0)
            s.sendall(b"ping")
        """)),
    # ------------------------------------------------------------ VG019
    C("VG019", "annotated-driver-only-reachable", True, F("vega_tpu/distributed/worker.py", """\
        class _TaskHandler:
            def handle(self):
                self._bootstrap()

            def _bootstrap(self):
                reset_mesh()

        # vegalint: role[driver-only]
        def reset_mesh():
            pass
        """)),
    C("VG019", "unreachable-from-confined-roles", False, F("vega_tpu/distributed/worker.py", """\
        class _TaskHandler:
            def handle(self):
                pass

        # vegalint: role[driver-only]
        def reset_mesh():
            pass

        def driver_entry():
            reset_mesh()
        """)),
    # ------------------------------------------------------------ VG020
    C("VG020", "object-dtype-in-device-tier", True, F("vega_tpu/tpu/badcol.py", """\
        import numpy as np

        def build(xs, col):
            a = np.array(xs, dtype=object)
            b = np.empty(len(xs), np.object_)
            c = col.astype("O")
            d = np.full((3,), 0, dtype="object")
            ufn = np.frompyfunc(str, 1, 1)
            return a, b, c, d, ufn
        """, port_rel="vega_tpu_torch/block.py")),
    C("VG020", "clean-dtypes-dict-encoding-host-tier", False,
      F("vega_tpu/tpu/goodcol.py", """\
        import numpy as np

        def build(xs, col):
            a = np.array(xs, dtype=np.int32)
            b = col.astype(np.int64)
            c = np.full((3,), "O")  # fill VALUE, not a dtype
            return a, b, c
        """, port_rel="vega_tpu_torch/stream.py"),
      F("vega_tpu/tpu/dict_encoding.py", """\
        import numpy as np

        def normalize(src):
            return src.astype(object)
        """),
      F("vega_tpu/rdd/rows.py", """\
        import numpy as np

        def pivot(rows):
            return np.array(rows, dtype=object)
        """)),
]


def _write_tree(root, files):
    for rel, src in files:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def _sites(result, root, rels):
    """(file index, rule, line) of each unsuppressed finding."""
    index = {str(root / rel).replace(os.sep, "/"): i
             for i, rel in enumerate(rels)}
    return sorted((index.get(f.path, -1), f.rule, f.line)
                  for f in result.findings)


@pytest.mark.parametrize("rule_id,fires,files,select", CASES)
def test_rule_matches_reference(tmp_path, rule_id, fires, files, select):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    _write_tree(ref_root, [(r, s) for r, s, _pr, _ps in files])
    _write_tree(port_root, [(pr, ps) for _r, _s, pr, ps in files])
    ref = ref_run_lint([str(ref_root)], select=select, cache=False)
    port = run_lint([str(port_root)], select=select, cache=False)
    assert not ref.errors and not port.errors, (ref.errors, port.errors)
    want = _sites(ref, ref_root, [r for r, _s, _pr, _ps in files])
    got = _sites(port, port_root, [pr for _r, _s, pr, _ps in files])
    assert got == want, [f.render() for f in port.findings]
    if fires:
        assert want and {rule for _i, rule, _l in want} == {rule_id}
    else:
        assert not want


def test_every_rule_but_vg001_is_ported_and_fixtured():
    ref_rules = set(ref_engine.all_rules())
    port_rules = set(all_rules())
    assert port_rules == ref_rules - {"VG001"}
    assert engine.NOT_PORTED[0] == "VG001"
    cased = {p.values[0] for p in CASES}
    assert cased == port_rules | {"VG000"}
    for rule_id in cased:
        fired = {p.values[1] for p in CASES if p.values[0] == rule_id}
        assert fired == {True, False}, rule_id


def test_list_rules_names_the_rule_not_ported(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in all_rules():
        assert f"{rule_id}  " in out
    assert "VG001  (not ported)" in out and "compat.py" in out


def test_vg003_resolves_a_foreign_rlock_by_its_unique_attribute(tmp_path):
    """A reentrant lock reached through another object (the dense
    lineage re-entering Context._dense_lock) is the port's one
    resolution past the reference's: vega_tpu's rule reads the foreign
    lock as opaque and non-reentrant."""
    src = """\
        import threading

        class Context:
            def __init__(self):
                self._dense_lock = threading.RLock()

        def materialize(ctx):
            with ctx._dense_lock:
                with ctx._dense_lock:
                    pass
        """
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    _write_tree(ref_root, [("vega_tpu/newctx.py", textwrap.dedent(src))])
    _write_tree(port_root, [("vega_tpu_torch/newctx.py",
                             textwrap.dedent(src))])
    ref = ref_run_lint([str(ref_root)], select=["VG003"], cache=False)
    port = run_lint([str(port_root)], select=["VG003"], cache=False)
    assert [f.rule for f in ref.findings] == ["VG003"]
    assert "self-deadlock" in ref.findings[0].message
    assert not port.findings


def test_role_map_counterparts_resolve_against_the_port():
    """Every role of the reference's map has its counterpart, with the
    same thread names and the same critical / confined split, and every
    entry and driver-only seed names a real def of the port's tree."""
    assert set(callgraph.ROLES) == set(ref_callgraph.ROLES)
    for role, spec in ref_callgraph.ROLES.items():
        mine = callgraph.ROLES[role]
        for key in ("thread_prefixes", "critical", "confined"):
            assert mine[key] == spec[key], (role, key)
        assert len(mine["entries"]) == len(spec["entries"]), role
        for ref_entry, entry in zip(spec["entries"], mine["entries"]):
            assert entry.rsplit(".", 2)[-2:] == ref_entry.rsplit(".", 2)[-2:]
    records = gather_extracts([PORT_SWEEP[0]], "callgraph", cache=False)
    g = callgraph.build_graph(records)
    missing = [f"{role}: {e}" for role, spec in callgraph.ROLES.items()
               for e in spec["entries"] if e not in g.defs]
    missing += [f"seed: {s}" for s in callgraph.DRIVER_ONLY_SEEDS
                if s not in g.defs]
    assert not missing, missing
    roles, _parent = callgraph.propagate_roles(g)
    assert "reaper" in roles.get(
        "vega_tpu_torch.distributed.backend.DistributedBackend._sweep", ())
    assert "dag-loop" in roles.get(
        "vega_tpu_torch.cuda_kernels.build", ())


def test_port_sweep_is_clean_and_fast():
    """python -m vega_tpu_torch.lint vega_tpu_torch chip_smoke.py: zero
    unsuppressed findings, each suppression justified, and the warm
    sweep served whole from the cache in under 2 s (a CPU budget, as the
    reference's)."""
    res = run_lint(PORT_SWEEP)
    assert res.ok, "\n".join(f.render() for f in res.findings)
    assert res.suppressed and all(f.justification for f in res.suppressed)
    t0 = time.time()
    warm = run_lint(PORT_SWEEP)
    elapsed = time.time() - t0
    assert warm.ok
    assert warm.cache_hits == warm.files, (warm.cache_hits, warm.files)
    assert elapsed < 2, f"cached lint took {elapsed:.1f}s, budget is 2s"


def test_cli_sweep_exits_zero(tmp_path):
    out = tmp_path / "vegalint.json"
    assert main([*PORT_SWEEP, "--json-out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["schema"] == 2
    assert all(f["pragma"] == "justified" for f in doc["suppressed"])


def test_both_engines_keep_caches_of_their_own(tmp_path, monkeypatch):
    """The two copies of vegalint lint one checkout with caches of their
    own, by default and under one VEGA_TPU_LINT_CACHE: run back to back,
    each warm sweep is still served whole from its cache."""
    assert engine._cache_path() != ref_engine._cache_path()
    monkeypatch.setenv("VEGA_TPU_LINT_CACHE", str(tmp_path / "cache.pkl"))
    assert engine._cache_path() != ref_engine._cache_path()
    for _ in range(2):
        ref = ref_run_lint(REF_SWEEP)
        port = run_lint(PORT_SWEEP)
    assert ref.ok and port.ok
    assert ref.cache_hits == ref.files, (ref.cache_hits, ref.files)
    assert port.cache_hits == port.files, (port.cache_hits, port.files)


def test_cli_explain_role(tmp_path, capsys):
    p = tmp_path / "vega_tpu_torch" / "scheduler" / "elastic.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent("""\
        class ElasticController:
            def _loop(self):
                self._decide()

            def _decide(self):
                pass
        """))
    rc = main([str(tmp_path), "--explain-role",
               "ElasticController._decide", "--output", "json",
               "--no-cache"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["schema"] == 2
    (match,) = doc["matches"]
    assert match["function"] == \
        "vega_tpu_torch.scheduler.elastic.ElasticController._decide"
    assert match["roles"]["elastic"][0].endswith("._loop")
    assert main([str(tmp_path), "--explain-role", "nope", "--no-cache"]) == 2
    capsys.readouterr()


def test_cli_changed_mode(tmp_path, monkeypatch, capsys):
    """--changed: instant pass when nothing moved; a narrow run for a
    file outside the package; the full sweep when vega_tpu_torch/
    changed."""
    monkeypatch.setenv("VEGA_TPU_LINT_CACHE", str(tmp_path / "cache.pkl"))
    mod = tmp_path / "tree" / "vega_tpu_torch" / "mod.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("x = 1\n")
    script = tmp_path / "tree" / "tools" / "script.py"
    script.parent.mkdir(parents=True)
    script.write_text("y = 2\n")
    paths = [str(tmp_path / "tree")]
    assert main(paths + ["--changed"]) == 0  # no stamp: full sweep
    assert "2 file(s)" in capsys.readouterr().out
    assert main(paths + ["--changed"]) == 0
    assert "0 file(s)" in capsys.readouterr().out
    time.sleep(0.01)
    script.write_text("y = 3\n")
    assert main(paths + ["--changed"]) == 0
    assert "1 file(s)" in capsys.readouterr().out
    time.sleep(0.01)
    mod.write_text("x = 2\n")
    assert main(paths + ["--changed"]) == 0
    assert "2 file(s)" in capsys.readouterr().out


def test_module_names_anchor_on_the_port(tmp_path):
    p = tmp_path / "a" / "vega_tpu_torch" / "shuffle" / "store.py"
    p.parent.mkdir(parents=True)
    p.write_text("def f():\n    return 1\n")
    ctx = engine.FileCtx(str(p), str(p).replace(os.sep, "/"),
                         p.read_text())
    assert ctx.module == "vega_tpu_torch.shuffle.store"


def test_cuda_build_is_bounded(tmp_path, monkeypatch):
    """A compiler that outlasts the build's limit is killed and the build
    raises KernelError naming the command; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 30 &\nsleep 30\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    assert cuda_kernels.BUILD_TIMEOUT_S == 300.0
    monkeypatch.setattr(cuda_kernels, "BUILD_TIMEOUT_S", 0.5)
    monkeypatch.setattr(cuda_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_kernels, "LIBRARY",
                        str(tmp_path / "build" / "lib.so"))
    t0 = time.time()
    with pytest.raises(KernelError, match="did not finish within 0.5 s"
                       ) as err:
        cuda_kernels.build()
    assert time.time() - t0 < 10
    assert str(fake) in str(err.value)
    assert not os.listdir(tmp_path / "build")
