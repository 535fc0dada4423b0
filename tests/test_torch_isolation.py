"""vega_tpu_torch stands alone: it imports neither jax nor vega_tpu, runs
with both unimportable, and never runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import vega_tpu_torch as vt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "vega_tpu", "cloudpickle")
# the host RDD layer's modules (each the port's own copy of the
# reference's pure-Python module of the same name)
HOST_LAYER = ("split", "partitioner", "dependency", "aggregator",
              "bounded_priority_queue", "rdd", "rdd.base", "rdd.narrow",
              "rdd.pair", "rdd.shuffled", "rdd.cogrouped", "rdd.union",
              "rdd.cartesian", "rdd.coalesced", "rdd.checkpoint",
              "broadcast", "io", "io.readers", "streaming",
              "streaming.context", "streaming.dstream", "streaming.source",
              "streaming.state", "streaming.controller",
              # the local runtime
              "env", "serialization", "cache", "cache_tracker", "faults",
              "store.tiered", "map_output_tracker", "shuffle",
              "shuffle.store", "shuffle.fetcher", "scheduler",
              "scheduler.stage", "scheduler.task", "scheduler.dag",
              "scheduler.local_backend", "scheduler.events",
              "scheduler.jobserver", "partial.count_evaluator",
              "partial.grouped_count_evaluator", "partial.mean_evaluator",
              # the distributed backend
              "distributed", "distributed.protocol",
              "distributed.driver_service", "distributed.shuffle_server",
              "distributed.worker", "distributed.backend",
              # the native runtime, the push plan, the coded shuffle,
              # hosts files and the elastic fleet
              "native", "shuffle.premerge", "shuffle.coding", "hosts",
              "scheduler.elastic")


def _port_files():
    pkg = os.path.join(ROOT, "vega_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x != "_build"]  # build outputs only
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_vega_tpu():
    files = _port_files()
    assert len(files) > 5 and os.path.exists(files[0])
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_port_runs_with_jax_and_vega_tpu_unimportable():
    script = """
import sys
for name in ("jax", "jaxlib", "vega_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import vega_tpu_torch as vt
with vt.Context(device="cpu", n_shards=8) as ctx:
    kv = ctx.dense_range(5000).map(lambda x: (x % 100, x * 0.5))
    table = ctx.dense_from_numpy(np.arange(100, dtype=np.int32),
                                 np.arange(100, dtype=np.float32) * 2.0)
    joined = kv.reduce_by_key(op="add").join(table)
    assert joined.count() == 100
    rows = dict(joined.collect())
    assert rows[7] == (sum(x * 0.5 for x in range(7, 5000, 100)), 14.0)
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_host_layer_modules_stand_alone():
    """Every module of the host RDD layer is among the files checked
    above, and imports and runs a host lineage (a shuffle, a cogroup, a
    checkpoint, dense()) with jax, vega_tpu and cloudpickle unimportable
    (rows are pickled with the standard library)."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in HOST_LAYER:
        path = os.path.join("vega_tpu_torch", *mod.split("."))
        assert path + ".py" in files or \
            os.path.join(path, "__init__.py") in files, mod
    script = """
import importlib, sys, tempfile
for name in ("jax", "jaxlib", "vega_tpu", "cloudpickle"):
    sys.modules[name] = None  # any import of them now raises ImportError
for mod in %r:
    importlib.import_module("vega_tpu_torch." + mod)
import operator
import vega_tpu_torch as vt
with vt.Context(device="cpu", n_shards=4) as ctx:
    rows = [(i %% 7, i) for i in range(200)]
    red = ctx.parallelize(rows, 3).reduce_by_key(operator.add)
    assert sorted(red.collect()) == sorted(
        (k, sum(v for kk, v in rows if kk == k)) for k in range(7))
    cg = red.cogroup(ctx.range(5).map(lambda x: (x, -x)), red)
    assert cg.count() == 7
    with tempfile.TemporaryDirectory() as d:
        node = red.map_values(str).checkpoint(d)
        assert node.glom().count() == 3 and node.get_dependencies() == []
    assert ctx.parallelize(rows, 3).dense().reduce_by_key(
        op="add").count() == 7
    with tempfile.TemporaryDirectory() as d:
        with open(d + "/a.txt", "w") as fh:
            fh.write("".join(f"{i %% 7},{i}\\n" for i in range(200)))
        lines = ctx.text_file(d).map(
            lambda s: tuple(int(x) for x in s.split(",")))
        assert sorted(lines.dense().reduce_by_key(op="add").collect()) == \
            sorted(red.collect())
        assert ctx.broadcast([1]).value == [1]
        assert ctx.submit_job(red, lambda tc, it: 1).result(30) == [1] * 3
        stream = ctx.stream_from_generator(
            lambda i: (i %% 7, i) if i < 200 else None,
            checkpoint_dir=d + "/ckpt")
        handle = stream.update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert sctx.await_batches(1, 30)
        while sctx.status()["receivers"][0]["next_offset"] < 200 or \
                sctx._offsets.get(0, 0) < 200:
            import time
            time.sleep(0.02)
        sctx.stop()
        assert handle.snapshot() == dict(red.collect())
print("OK")
""" % (HOST_LAYER,)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_frame_layer_runs_without_pyarrow():
    """The frame package imports pyarrow only inside its parquet helpers:
    with pyarrow (and jax, vega_tpu) unimportable, frames over in-memory
    columns still build and run."""
    script = """
import sys
for name in ("jax", "jaxlib", "vega_tpu", "pyarrow"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import vega_tpu_torch as vt
from vega_tpu_torch.frame import F, col
with vt.Context(device="cpu", n_shards=8) as ctx:
    df = ctx.create_frame(k=np.arange(1000) % 7, x=np.arange(1000))
    rows = (df.filter(col("x") < 500).group_by("k")
            .agg(F.sum("x", "s")).sort("k").collect())
    assert rows == [(k, sum(range(k, 500, 7))) for k in range(7)], rows
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_context_without_device_never_runs_on_cpu():
    if torch.cuda.is_available():
        with vt.Context() as ctx:
            assert ctx.device.type == "cuda"
    else:
        with pytest.raises(vt.VegaError, match="device='cpu'"):
            vt.Context()
    with pytest.raises(vt.VegaError):
        vt.Context(device="cpu", n_shards=0)


def test_spill_fold_and_decode_run_with_jax_and_vega_tpu_unimportable():
    """The walk covers store/ and state_fold.py, and persist / the spill
    tier, fold_pairs_device and gf256_accumulate run with jax and
    vega_tpu unimportable."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("store/__init__.py", "store/level.py", "store/disk.py",
                "state_fold.py", "kernels.py"):
        assert os.path.join("vega_tpu_torch", rel) in files
    script = """
import sys
for name in ("jax", "jaxlib", "vega_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd, kernels, state_fold
with vt.Context(device="cpu", n_shards=8) as ctx:
    r = (ctx.dense_range(5000).map(lambda x: (x % 100, x))
         .reduce_by_key(op="add").persist("MEMORY_AND_DISK"))
    want = dict(r.collect())
    ctx.dense_hbm_budget = 0
    dense_rdd._lifetime_evict(ctx)
    assert dict(r.collect()) == want
    assert ctx.spill_status()["promote_count"] == 1
    assert state_fold.fold_pairs_device(ctx, [(1, 2), (1, 3)], "add") == {1: 5}
out = kernels.gf256_accumulate(np.array([[1, 2], [3, 4]], np.uint8),
                               np.array([1, 1], np.uint8), device="cpu")
assert out.tolist() == [2, 6]
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_distributed_backend_and_executors_stand_alone():
    """A distributed Context runs with jax, vega_tpu and cloudpickle
    unimportable in the driver, and its executor processes import none of
    them (nor initialize CUDA): a lambda, a DenseRDD's rows and a shuffle
    cross the wire with the standard library's pickle alone."""
    script = """
import sys
for name in ("jax", "jaxlib", "vega_tpu", "cloudpickle"):
    sys.modules[name] = None  # any import of them now raises ImportError
import vega_tpu_torch as vt

def report(_it):
    import sys
    import torch
    return [(sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "vega_tpu", "cloudpickle")),
             torch.cuda.is_initialized())]

with vt.Context(mode="distributed", device="cpu", n_shards=4,
                num_executors=1, num_workers=2) as ctx:
    assert ctx.parallelize(range(4), 2).map_partitions(report).collect() \
        == [([], False)] * 2
    red = ctx.dense_range(400).map(lambda x: (x % 5, x)).to_rdd() \
        .reduce_by_key(lambda a, b: a + b, 3)
    assert sorted(red.collect()) == [(k, sum(range(k, 400, 5)))
                                     for k in range(5)]
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
