"""The RDD API's host-tier names and the host-row form of vega_tpu_torch
across processes (Context(multihost=...)) against its own one-process run,
on the CPU over gloo.

The harness is tests/test_torch_multihost.py's (_start_pair, _finish,
_close): one session of 2 processes x 2 global shards, and the port's
world 1 (one process, the same 4 shards) in the test process. Both run
the same ops (_OPS_SRC) on data from one numpy seed; each op is a
parametrised case compared rank by rank with world 1: integers, rows,
file bytes and estimates bit-identical, floats within rtol 1e-5, rows in
the order the action gives them, so placement shows.

The ops: count_approx_distinct over pairs and strings; take_sample with
and without replacement; sample(True) and random_split; to_local_iterator
(the block read once, on the calling thread, then shard by shard);
save_as_text_file to one directory, written by process 0 alone; the
async actions, two of them submitted back to back; a closure past int32
in the host-row form, whose overflow flags every rank reads. And the host
RDD layer (vega_tpu_torch/rdd/), which every rank runs over all shards
(the replicated program; DenseRDD.splits() reads the block once on the
calling thread): glom, coalesce, repartition, to_rdd().map_partitions,
flat_map_values, pipe, compute, the cogroup and outer-join results, a
cogroup of three sides, parallelize(...).dense() and a checkpoint that
process 0 writes to one directory and both ranks read back; a checkpoint
with no directory, which a single process writes under its session
directory and two processes refuse (no such directory is shared).
"""

import json
import os

import pytest

from test_torch_multihost import (SESSION_TIMEOUT_S, _close, _finish,
                                  _start_pair)

_OPS_SRC = '''
import operator
import os

import numpy as np

SEED = 2718


def data():
    rng = np.random.default_rng(SEED)
    n = 6_000
    return dict(
        k=rng.integers(0, 97, size=n).astype(np.int32),
        v=rng.integers(-1000, 1000, size=n).astype(np.int32),
        x=rng.standard_normal(n).astype(np.float32),
        s=np.array([f"w{i:03d}" for i in range(60)])[
            rng.integers(0, 60, size=n)])


def _rows(rows):
    return [list(r) if isinstance(r, tuple) else r for r in rows]


def run_ops(ctx, tmp):
    d = data()
    pairs = ctx.dense_from_numpy(d["k"], d["v"])
    out = {
        "hll_pairs": pairs.count_approx_distinct(0.01),
        "hll_strings": ctx.dense_from_numpy(d["s"]).count_approx_distinct(),
        "take_sample": _rows(pairs.take_sample(False, 50, 7)),
        "take_sample_replacement": _rows(pairs.take_sample(True, 50, 7)),
        "sample_poisson": _rows(pairs.sample(True, 0.2, 3).collect()),
        "random_split": [_rows(b.collect())
                         for b in pairs.random_split([0.7, 0.3], 5)],
        "to_local_iterator": _rows(pairs.reduce_by_key(
            operator.add).to_local_iterator()),
    }
    path = os.path.join(tmp, "text")
    ctx.dense_from_numpy(d["k"], d["x"]).save_as_text_file(path)
    out["text_files"] = sorted(os.listdir(path))
    out["text_bytes"] = "".join(
        open(os.path.join(path, f)).read() for f in sorted(os.listdir(path)))
    red = pairs.reduce_by_key(operator.add)
    a, b = red.count_async(), red.collect_async()
    out["count_async"] = a.result(60)
    out["collect_async"] = _rows(b.result(60))
    out["reduce_async"] = ctx.dense_from_numpy(d["v"]).reduce_async(
        operator.add).result(60)
    out["host_rows"] = _rows(sorted(pairs.map_values(
        lambda v: v * 2**33).reduce_by_key(operator.add).collect()))
    try:
        pairs.map_values(lambda v: v * 2**60).collect()
        out["host_rows_overflow"] = None
    except Exception as e:
        out["host_rows_overflow"] = type(e).__name__
    table = ctx.dense_from_numpy(np.arange(120, dtype=np.int32),
                                 np.arange(120, dtype=np.float32) * 2)
    out["host_glom_sizes"] = red.glom().map(len).collect()
    out["host_coalesce"] = _rows(red.coalesce(3).glom().collect())
    out["host_repartition"] = _rows(red.repartition(3).glom().collect())
    out["host_to_rdd"] = _rows(red.to_rdd().map_partitions(
        lambda it: ((k, v * 2) for k, v in it)).collect())
    out["host_flat_map_values"] = _rows(red.flat_map_values(
        lambda v: [v, -v]).collect())
    out["host_pipe"] = red.pipe("cat").collect()
    out["host_compute"] = [_rows(red.compute(sp)) for sp in red.splits()]
    out["host_cogroup"] = _rows(red.cogroup(table).map_values(
        lambda lr: (len(lr[0]), sum(lr[1]))).collect())
    out["host_cogroup_count"] = red.cogroup(table).count()
    out["host_right_outer"] = _rows(red.right_outer_join(table).collect())
    out["host_cogroup3"] = _rows(red.cogroup(table, pairs).map_values(
        lambda g: [len(x) for x in g]).collect())
    out["host_parallelize_dense"] = _rows(ctx.parallelize(
        [(i % 50, i) for i in range(3000)], 5).dense().reduce_by_key(
            operator.add).collect())
    ck = red.map_values(lambda v: v + 1).checkpoint(os.path.join(tmp, "ck"))
    out["host_checkpoint"] = _rows(ck.glom().collect())
    out["host_checkpoint_files"] = sorted(os.listdir(os.path.join(tmp, "ck")))
    try:
        out["host_checkpoint_no_dir"] = _rows(red.map_values(
            lambda v: v + 1).checkpoint().glom().collect())
    except Exception as e:
        out["host_checkpoint_no_dir"] = type(e).__name__
    return out
'''

_PORT_SCRIPT = '''
import json
import os
import signal
import sys

sys.path.insert(0, "__REPO__")
signal.alarm(__ALARM__)  # a divergence hangs in a collective

import vega_tpu_torch as vt

exec(open(sys.argv[4]).read())
coordinator, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
# one directory for both ranks: process 0 writes the text files
tmp = os.path.join(os.path.dirname(out_path), "shared")
os.makedirs(tmp, exist_ok=True)
ctx = vt.Context(device="cpu", n_shards=4, multihost=dict(
    coordinator=coordinator, num_processes=2, process_id=pid))
try:
    res = {"world": ctx.mesh.world, "ops": run_ops(ctx, tmp)}
    with open(out_path, "w") as f:
        json.dump(res, f)
    print("PORT_OPS_OK", pid, flush=True)
finally:
    ctx.stop()
'''


def _port_world1(tmp):
    import vega_tpu_torch as vt

    scope: dict = {}
    exec(_OPS_SRC, scope)
    os.makedirs(tmp, exist_ok=True)
    with vt.Context(device="cpu", n_shards=4) as ctx:
        return json.loads(json.dumps(scope["run_ops"](ctx, str(tmp))))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost_host")
    procs, outs = _start_pair(tmp, "port", _PORT_SCRIPT, SESSION_TIMEOUT_S,
                              ops_src=_OPS_SRC)
    world1 = _port_world1(tmp / "world1")
    for rc, out, err in _finish(procs, SESSION_TIMEOUT_S):
        assert rc == 0 and "PORT_OPS_OK" in out, \
            f"port session rc={rc}\n{out}\n{err[-3000:]}"
    return {"port": [json.loads(p.read_text()) for p in outs],
            "world1": world1}


OPS = ["hll_pairs", "hll_strings", "take_sample", "take_sample_replacement",
       "sample_poisson", "random_split", "to_local_iterator", "text_files",
       "text_bytes", "count_async", "collect_async", "reduce_async",
       "host_rows", "host_rows_overflow", "host_glom_sizes",
       "host_coalesce", "host_repartition", "host_to_rdd",
       "host_flat_map_values", "host_pipe", "host_compute", "host_cogroup",
       "host_cogroup_count", "host_right_outer", "host_cogroup3",
       "host_parallelize_dense", "host_checkpoint", "host_checkpoint_files"]


@pytest.mark.parametrize("op", OPS)
def test_two_processes_equal_one_process(sessions, op):
    """World 2 against the port's world 1 at the same 4 global shards."""
    for rank in (0, 1):
        assert sessions["port"][rank]["world"] == 2
        _close(sessions["port"][rank]["ops"][op], sessions["world1"][op],
               f"rank{rank}:{op}")


def test_one_writer_and_the_overflow_on_every_rank(sessions):
    """Both ranks return from save_as_text_file with the four part files
    in place (process 0 wrote them; no temporary file is left), and both
    raise on the row that leaves int64."""
    for rank in (0, 1):
        ops = sessions["port"][rank]["ops"]
        assert ops["text_files"] == [f"part-{s:05d}" for s in range(4)]
        assert ops["host_rows_overflow"] == "VegaError"


def test_checkpoint_without_a_directory_refuses_across_processes(sessions):
    """checkpoint() with no directory: world 1 writes it under the
    Context's session directory and reads back the rows of the named
    directory's checkpoint; at world 2 every rank raises VegaError before
    any job (each process's session directory is its own)."""
    assert sessions["world1"]["host_checkpoint_no_dir"] == \
        sessions["world1"]["host_checkpoint"]
    for rank in (0, 1):
        assert sessions["port"][rank]["ops"]["host_checkpoint_no_dir"] == \
            "VegaError"
