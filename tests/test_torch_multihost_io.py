"""String columns, npz checkpoints, the frame layer and the streaming
state fold of vega_tpu_torch across processes (Context(multihost=...))
against the reference's own two-process runs, on the CPU over gloo.

The harness is tests/test_torch_multihost.py's (_start_pair, _finish,
_close): the reference in two sessions of 2 processes x 2 CPU devices,
the port in one session of 2 processes x 2 global shards, all three at
once, and the port's world 1 (one process, the same 4 shards) in the test
process. Every process runs the same ops (_OPS_SRC) on data from one numpy
seed; each op is a parametrised case compared rank by rank with the
reference and with world 1: integers and strings bit-identical, floats
within rtol 1e-5, rows in collect() order, so placement shows.

The ops: string reduce_by_key (collected, taken, looked up, as a map)
joined against a table of another dictionary, string sort_by_key and
group_by_key; a dictionary overflow
that only rank 0's shards hit (dense_dict_capacity=16 stages the remap at
its 128-entry floor; the left side's 200-entry dictionary has its codes
past 128 only in the rows of global shards 0-1), whose retry every rank
must take together; an npz round trip (a string key and an int32 pair) at
a path of each process's own, reloaded resident and streamed; frame_ab's
query shape (filter -> group_by.agg -> join -> sort) over create_frame, a
frame group-by over string keys, and read_parquet of a file each process
writes with pyarrow under a pushed-down filter; fold_pairs_device for
add / min / max / prod and a tuple key (None).

One port-only case pins a recorded difference: both ranks save_npz to ONE
path; the port's first rank to name a path writes it alone, where the
reference has every process write the same .tmp and replace it. Another
runs a frame stage of wide int64 arithmetic after a filter that empties
rank 1's shards, whose overflow flag both ranks must read (the reference
answers that plan on its host tier).
"""

import json
import os

import pytest

from test_torch_multihost import (SESSION_TIMEOUT_S, _close, _finish,
                                  _start_pair)

_OPS_SRC = '''
import os

import numpy as np

SEED = 4321
GROUPS = []  # (part, function): run_ops runs one part or all
WORDS = np.array([f"w{i:03d}" for i in range(60)])


class RefApi:
    """The calls that differ in the reference (vega_tpu)."""

    def __init__(self, tmp):
        self.tmp = tmp
        import vega_tpu.frame as frame

        self.frame = frame

    @staticmethod
    def set_dict_capacity(ctx, n):
        from vega_tpu.env import Env

        Env.get().conf.dense_dict_capacity = n

    @staticmethod
    def fold(ctx, pairs, op):
        from vega_tpu.tpu.state_fold import fold_pairs_device

        return fold_pairs_device(ctx, pairs, op)


class PortApi:
    """The same calls in the port (vega_tpu_torch)."""

    def __init__(self, tmp):
        self.tmp = tmp
        import vega_tpu_torch.frame as frame

        self.frame = frame

    @staticmethod
    def set_dict_capacity(ctx, n):
        ctx.dense_dict_capacity = n

    @staticmethod
    def fold(ctx, pairs, op):
        from vega_tpu_torch.state_fold import fold_pairs_device

        return fold_pairs_device(ctx, pairs, op)


def group(part):
    def register(fn):
        GROUPS.append((part, fn))
        return fn
    return register


def _rows(pairs):
    return [list(r) if isinstance(r, tuple) else r for r in pairs]


def _flat(rows):
    return [[k, *v] if isinstance(v, tuple) else [k, v] for k, v in rows]


def _retries(rdd):
    """The doubling retries of each dictionary remap in rdd's lineage."""
    seen, todo, out = [], [rdd], []
    while todo:
        node = todo.pop()
        if any(node is s for s in seen):
            continue
        seen.append(node)
        if type(node).__name__ == "_DictUnifyRDD":
            out.append(node._dict_retries)
        todo.extend(getattr(node, "_dense_parents", ()))
        for attr in ("parent", "left", "right"):
            child = getattr(node, attr, None)
            if child is not None:
                todo.append(child)
    return sorted(out)


def data():
    rng = np.random.default_rng(SEED)
    n = 6_000
    return dict(
        skeys=WORDS[rng.integers(0, len(WORDS), size=n)],
        ikeys=rng.integers(0, 97, size=n).astype(np.int32),
        ivals=rng.integers(-1000, 1000, size=n).astype(np.int32),
        fvals=rng.standard_normal(n).astype(np.float32),
        perm=rng.permutation(2_000))


@group(0)
def strings(ctx, api, d):
    red = ctx.dense_from_numpy(d["skeys"], d["ivals"]).reduce_by_key(
        op="add")
    # the table's dictionary differs from the reduce's: the join unifies
    tk = np.array([f"w{i:03d}" for i in range(30, 90, 2)])
    joined = red.join(ctx.dense_from_numpy(
        tk, np.arange(len(tk), dtype=np.int32)))
    uniq = np.array([f"s{i:05d}" for i in d["perm"]])
    grouped = ctx.dense_from_numpy(d["skeys"], d["ivals"]).group_by_key()
    return {
        "string_reduce": _rows(red.collect()),
        "string_reduce_float": _rows(ctx.dense_from_numpy(
            d["skeys"], d["fvals"]).reduce_by_key(op="add").collect()),
        "string_reduce_join": _flat(joined.collect()),
        "string_join_retries": _retries(joined),
        "string_host_reads": [_rows(red.take(7)), red.lookup("w007"),
                              sorted(red.collect_as_map().items())[:5]],
        "string_sort_by_key": _rows(ctx.dense_from_numpy(
            uniq, d["perm"].astype(np.int32)).sort_by_key().collect()),
        "string_group_by_key": [[k, sorted(vs)]
                                for k, vs in grouped.collect()]}


@group(0)
def dict_overflow(ctx, api, d):
    # 4 global shards of 1,000 rows: rows 0-1999 are global shards 0-1
    # (rank 0's), and only they hold the codes past 128
    left = np.array([f"o{i:03d}" for i in range(200)])
    lk = np.concatenate([left[np.arange(2_000) % 200],
                         left[np.arange(2_000) % 100]])
    rk = np.array([f"o{i:03d}" for i in range(0, 200, 3)])
    api.set_dict_capacity(ctx, 16)
    try:
        joined = ctx.dense_from_numpy(
            lk, np.arange(4_000, dtype=np.int32)).join(
                ctx.dense_from_numpy(
                    rk, np.arange(len(rk), dtype=np.int32) * 5))
        rows = _flat(joined.collect())
        retries = _retries(joined)
    finally:
        api.set_dict_capacity(ctx, 65536)
    return {"overflow_join": rows, "overflow_retries": retries}


@group(1)
def npz(ctx, api, d):
    path = os.path.join(api.tmp, "ckpt", "pairs.npz")
    src = ctx.dense_from_columns(
        {"s": d["skeys"], "a": d["ikeys"], "b": d["ivals"]}, key="s")
    saved = src.save_npz(path)
    resident = ctx.dense_load_npz(path)
    streamed = ctx.dense_load_npz(path, chunk_rows=1_000)
    return {
        "npz_saved": [saved == path, os.path.exists(path),
                      os.path.exists(path + ".tmp")],
        "npz_resident": _rows(resident.collect()),
        "npz_streamed": [streamed.n_chunks, streamed.count()],
        "npz_streamed_reduce": _rows(streamed.select("k", "a").reduce_by_key(
            op="add").collect()),
        "npz_streamed_max": _rows(streamed.select("k", "b").reduce_by_key(
            op="max").collect())}


@group(1)
def frames(ctx, api, d):
    F, col = api.frame.F, api.frame.col
    rng = np.random.default_rng(SEED + 1)
    n = 6_000
    ev = ctx.create_frame(
        k=rng.integers(0, 300, size=n).astype(np.int32),
        x=rng.integers(0, 1000, size=n).astype(np.int32),
        z=rng.standard_normal(n).astype(np.float32))
    dm = ctx.create_frame(k=np.arange(0, 300, 2, dtype=np.int32),
                          y=np.arange(150, dtype=np.int32) * 3)
    q = (ev.filter(col("x") < 500).group_by("k").agg(F.sum("x", "sx"))
         .join(dm.group_by("k").agg(F.sum("y", "sy")), on="k").sort("k"))
    sf = ctx.create_frame(w=d["skeys"], x=d["ivals"], z=d["fvals"])
    sq = sf.group_by("w").agg(F.sum("x", "sx"), F.count("n"),
                              F.max("z", "mz")).sort("w")
    return {
        "frame_query": _rows(q.hint(tier="device").collect()),
        "frame_string_group_by": _rows(sq.hint(tier="device").collect()),
        "frame_unsorted_group_by": _rows(
            ev.group_by("k").agg(F.min("x", "mx")).hint(tier="device")
            .collect())}


@group(1)
def parquet(ctx, api, d):
    import pyarrow as pa
    import pyarrow.parquet as pq

    F, col = api.frame.F, api.frame.col
    pdir = os.path.join(api.tmp, "events")
    os.makedirs(pdir, exist_ok=True)
    pq.write_table(pa.table({"k": d["ikeys"], "x": d["ivals"],
                             "w": d["skeys"]}),
                   os.path.join(pdir, "part0.parquet"))
    q = (ctx.read_parquet(pdir).filter(col("x") < 0).group_by("w")
         .agg(F.sum("k", "sk")).sort("w"))
    return {"parquet_filter_group_by": _rows(
        q.hint(tier="device").collect())}


@group(1)
def fold(ctx, api, d):
    pairs = list(zip(d["ikeys"].tolist(), d["ivals"].tolist()))
    small = list(zip(d["ikeys"][:600].tolist(),
                     (np.abs(d["ivals"][:600]) % 3 + 1).tolist()))
    out = {}
    for op in ("add", "min", "max", "prod"):
        got = api.fold(ctx, small if op == "prod" else pairs, op)
        out["fold_" + op] = sorted([k, v] for k, v in got.items())
    out["fold_tuple_key"] = api.fold(ctx, [((1, 2), 3), ((1, 2), 4)],
                                     "add")
    return out


def run_ops(ctx, api, part=None):
    d = data()
    out = {}
    for p, fn in GROUPS:
        if part is None or p == part:
            out.update(fn(ctx, api, d))
    return out
'''

_REF_SCRIPT = '''
import json
import os
import signal
import sys

sys.path.insert(0, "__REPO__")
from _cpu_mesh import force_cpu_mesh

force_cpu_mesh(2, assert_count=False)
signal.alarm(__ALARM__)  # a divergence hangs in a collective

import vega_tpu as v
from vega_tpu.frame import planner

exec(open(sys.argv[4]).read())
coordinator, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
tmp = out_path + ".d"
os.makedirs(tmp, exist_ok=True)
ctx = v.Context("local", multihost=dict(
    coordinator=coordinator, num_processes=2, process_id=pid))
try:
    fallbacks = planner.fallback_count()
    res = run_ops(ctx, RefApi(tmp), part=__PART__)
    res["frame_fallbacks"] = planner.fallback_count() - fallbacks
    with open(out_path, "w") as f:
        json.dump(res, f)
    print("REF_OPS_OK", pid, flush=True)
finally:
    ctx.stop()
'''

_PORT_SCRIPT = '''
import json
import os
import signal
import sys

sys.path.insert(0, "__REPO__")
signal.alarm(__ALARM__)  # a divergence hangs in a collective

import numpy as np

import vega_tpu_torch as vt
from vega_tpu_torch import mesh as mesh_lib

exec(open(sys.argv[4]).read())
coordinator, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
tmp = out_path + ".d"
os.makedirs(tmp, exist_ok=True)
ctx = vt.Context(device="cpu", n_shards=4, multihost=dict(
    coordinator=coordinator, num_processes=2, process_id=pid))
try:
    res = {"world": ctx.mesh.world, "ops": run_ops(ctx, PortApi(tmp))}
    # ONE path for both ranks: the first rank to name it writes it
    shared = os.path.join(os.path.dirname(out_path), "shared", "one.npz")
    d = data()
    node = ctx.dense_from_columns(
        {"s": d["skeys"], "a": d["ikeys"], "b": d["ivals"]}, key="s")
    before = dict(mesh_lib.WIRE)
    got = node.save_npz(shared)
    res["shared"] = dict(
        returned=got == shared, exists=os.path.exists(shared),
        host_gets=mesh_lib.WIRE["host_get"] - before["host_get"],
        tmp_left=os.path.exists(shared + ".tmp"),
        reloaded=[list(r) for r in ctx.dense_load_npz(shared).collect()])
    # a wide int64 stage after a filter that leaves rank 1's shards with
    # no row: the stage's overflow flag is still read on both ranks
    from vega_tpu_torch.frame import col

    wide = ctx.create_frame(k=np.arange(40), big=(1 << 40) + np.arange(40))
    res["wide_after_filter"] = sorted(list(r) for r in wide.filter(
        col("k") < 5).with_column("b2", col("big") * 2).collect())
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
    with vt.Context(device="cpu", n_shards=4) as ctx:
        res = scope["run_ops"](ctx, scope["PortApi"](str(tmp)))
        d = scope["data"]()
        shared = ctx.dense_from_columns(
            {"s": d["skeys"], "a": d["ikeys"], "b": d["ivals"]},
            key="s").collect()
    return json.loads(json.dumps(res)), json.loads(json.dumps(shared))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost_io")
    refs = [_start_pair(tmp, f"ref{part}", _REF_SCRIPT, SESSION_TIMEOUT_S,
                        part=part, ops_src=_OPS_SRC) for part in (0, 1)]
    port_procs, port_outs = _start_pair(tmp, "port", _PORT_SCRIPT,
                                        SESSION_TIMEOUT_S, ops_src=_OPS_SRC)
    world1, shared_rows = _port_world1(tmp / "world1")
    for rc, out, err in _finish(port_procs, SESSION_TIMEOUT_S):
        assert rc == 0 and "PORT_OPS_OK" in out, \
            f"port session rc={rc}\n{out}\n{err[-3000:]}"
    ref, fallbacks = {}, []
    for procs, outs in refs:
        for rc, out, err in _finish(procs, SESSION_TIMEOUT_S):
            assert rc == 0 and "REF_OPS_OK" in out, \
                f"reference session rc={rc}\n{out}\n{err[-3000:]}"
        for rank_out in outs:
            got = json.loads(rank_out.read_text())
            fallbacks.append(got.pop("frame_fallbacks"))
            if rank_out is outs[0]:
                ref.update(got)
            else:
                for op, val in got.items():  # the reference's ranks agree
                    _close(val, ref[op], f"reference rank 1:{op}")
    port = [json.loads(p.read_text()) for p in port_outs]
    return {"port": port, "ref": ref, "world1": world1,
            "shared_rows": shared_rows, "ref_fallbacks": fallbacks}


OPS = ["string_reduce", "string_reduce_float", "string_reduce_join",
       "string_join_retries", "string_host_reads", "string_sort_by_key",
       "string_group_by_key",
       "overflow_join", "overflow_retries", "npz_saved", "npz_resident",
       "npz_streamed", "npz_streamed_reduce", "npz_streamed_max",
       "frame_query", "frame_string_group_by", "frame_unsorted_group_by",
       "parquet_filter_group_by", "fold_add", "fold_min", "fold_max",
       "fold_prod", "fold_tuple_key"]


@pytest.mark.parametrize("op", OPS)
def test_two_processes_equal_reference(sessions, op):
    """Each rank of the port's two-process run returns what the
    reference's two-process run returns."""
    for rank in (0, 1):
        _close(sessions["port"][rank]["ops"][op], sessions["ref"][op],
               f"rank{rank}:{op}")


@pytest.mark.parametrize("op", OPS)
def test_two_processes_equal_one_process(sessions, op):
    """World 2 against the port's world 1 at the same 4 global shards."""
    for rank in (0, 1):
        _close(sessions["port"][rank]["ops"][op], sessions["world1"][op],
               f"rank{rank}:{op}")


def test_overflow_retried_on_every_rank(sessions):
    """Only rank 0's shards overflow the 128-entry remap table, yet both
    ranks' left remaps retry once (the flag is read through one
    mesh.host_get) and the right remaps not at all, as the reference's."""
    assert sessions["ref"]["overflow_retries"] == [0, 1]
    for rank in (0, 1):
        assert sessions["port"][rank]["ops"]["overflow_retries"] == [0, 1]


def test_reference_frames_ran_on_device(sessions):
    """The reference's frame queries took its device tier: its planner
    fell back to the host tier nowhere, on either rank."""
    assert sessions["ref_fallbacks"] == [0, 0, 0, 0]


def test_save_npz_to_one_path_has_one_writer(sessions):
    """A recorded difference: both ranks save_npz to ONE path. The port's
    first rank to name the path writes it alone, then a one-byte host_get
    tells both it is in place: both return the path, the file reloads
    equal to world 1's rows and no .tmp is left. The reference
    (vega_tpu/tpu/dense_rdd.py:1946-1950) has every process write
    path + ".tmp" and os.replace it, which races: one process's replace
    finds the .tmp already moved (FileNotFoundError), and its next
    collective then fails on the other process."""
    for rank in (0, 1):
        got = sessions["port"][rank]["shared"]
        assert got["returned"] and got["exists"] and not got["tmp_left"]
        assert got["host_gets"] == 3  # to_numpy's gather, the tags, the ack
        _close(got["reloaded"], sessions["shared_rows"], f"rank{rank}")


def test_wide_stage_reads_its_flag_on_every_rank(sessions):
    """A frame stage with wide int64 arithmetic reads its overflow flag
    through one mesh.host_get, a collective: a rank whose shards hold no
    row after the stage's filter (rank 1 here) must read it too, or the
    other rank waits alone. Both ranks return the exact rows."""
    want = [[k, (1 << 40) + k, 2 * ((1 << 40) + k)] for k in range(5)]
    for rank in (0, 1):
        assert sessions["port"][rank]["wide_after_filter"] == want
