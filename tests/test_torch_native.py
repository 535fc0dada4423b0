"""The native shuffle runtime of vega_tpu_torch (native.py over
csrc/vega_native.cpp) against vega_tpu's (native.py over
native/vega_native.cpp), on the CPU.

The same seeded rows go through both libraries: their VN01 / VG01 frames
are equal byte for byte, the C++ equals its Python twins, and jobs
through both packages' local runtimes give equal rows, in the same
order (both merge in the same C++ hash map). Counterparts of
tests/test_native.py's 15 tests, then the port's own: the build under a
lock from several threads and processes at once, and a failed build
that raises.
"""

import multiprocessing
import operator
import os
import threading

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu import native as ref_native
import vega_tpu_torch as vt
from vega_tpu_torch import native
from vega_tpu_torch.dependency import NATIVE_GROUP_MAGIC, NATIVE_MAGIC
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.partitioner import HashPartitioner

nat = native.get()
ref_nat = ref_native.get()
needs_ref = pytest.mark.skipif(ref_nat is None,
                               reason="the reference's native build is "
                                      "unavailable")


@pytest.fixture(scope="module")
def ctxs():
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    ref = v.Context("local", num_workers=2)
    port = vt.Context(device="cpu", n_shards=2, num_workers=2)
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _rows(seed, n=5_000, keys=97, floats=True):
    rng = np.random.default_rng(seed)
    ks = rng.integers(-keys, keys, n).tolist()
    if floats:
        vs = (rng.standard_normal(n) * 100).tolist()
    else:
        vs = rng.integers(-10**6, 10**6, n).tolist()
    return list(zip(ks, vs))


# --- the library itself (tests/test_native.py) ------------------------------


def test_hash_parity_with_python():
    keys = np.array([0, 1, -1, 42, 2**40, -(2**40), 7_777_777],
                    dtype=np.int64)
    got = np.frombuffer(nat.hash_i64(keys.tobytes(), 8), dtype=np.int64)
    part = HashPartitioner(8)
    assert got.tolist() == [part.get_partition(int(k)) for k in keys]
    if ref_nat is not None:
        assert nat.hash_i64(keys.tobytes(), 8) == \
            ref_nat.hash_i64(keys.tobytes(), 8)


def test_bucket_reduce_matches_python_dict():
    rows = [(i % 97, float(i)) for i in range(10_000)]
    blobs, all_int = nat.bucket_reduce_pairs(rows, 4, native.OP_ADD)
    assert all_int == 0
    merged = dict(nat.merge_encoded([(b, 0) for b in blobs if b],
                                    native.OP_ADD))
    expected = {}
    for k, x in rows:
        expected[k] = expected.get(k, 0.0) + x
    assert merged == pytest.approx(expected)
    part = HashPartitioner(4)
    for b, blob in enumerate(blobs):
        for k, _v in nat.decode_pairs(blob, False):
            assert part.get_partition(k) == b


def test_int_value_round_trip():
    blobs, all_int = nat.bucket_reduce_pairs([(5, 2), (5, 3)], 2,
                                             native.OP_ADD)
    assert all_int == 1
    merged = nat.merge_encoded([(b, 1) for b in blobs if b], native.OP_ADD)
    assert merged == [(5, 5)] and isinstance(merged[0][1], int)


def test_large_int_values_stay_exact():
    blobs, all_int = nat.bucket_reduce_pairs([(1, 2**60), (1, 3)], 1,
                                             native.OP_ADD)
    assert all_int == 1
    assert nat.merge_encoded([(b, 1) for b in blobs], native.OP_ADD) == \
        [(1, 2**60 + 3)]


def test_int_overflow_rejects_not_demotes():
    big = 2**62
    assert nat.bucket_reduce_pairs([(1, big)] * 3, 1, native.OP_ADD) is None
    blobs, all_int = nat.bucket_reduce_pairs([(1, big)], 1, native.OP_ADD)
    assert all_int == 1
    assert nat.merge_encoded([(blobs[0], 1), (blobs[0], 1)],
                             native.OP_ADD) is None
    fblobs, f_int = nat.bucket_reduce_pairs(
        [(1, float(big)), (1, float(big))], 1, native.OP_ADD)
    assert f_int == 0
    merged = dict(nat.merge_encoded([(fblobs[0], 0)], native.OP_ADD))
    assert merged[1] == pytest.approx(2.0 * big, rel=1e-12)


def test_sound_monoid_inference():
    from vega_tpu.rdd.pair import _infer_named_op
    from vega_tpu_torch.rdd.pair import infer_named_op

    cap = 100
    funcs = [lambda a, b: a + b, lambda x, y: x + y, lambda a, b: a * b,
             operator.add, min, max, lambda x, y: min(x + y, 100),
             lambda x, y: min(x + y, cap), lambda a, b: a - b]
    got = [infer_named_op(f) for f in funcs]
    assert got == [_infer_named_op(f) for f in funcs] == \
        ["add", "add", "prod", "add", "min", "max", None, None, None]


def test_non_numeric_falls_back():
    assert nat.bucket_reduce_pairs([("key", 1)], 2, native.OP_ADD) is None
    assert nat.bucket_reduce_pairs([(1, "value")], 2, native.OP_ADD) is None
    assert nat.bucket_reduce_pairs([(1.5, 2.0)], 2, native.OP_ADD) is None
    assert nat.encode_pairs([object()]) is None


def test_encode_decode_round_trip():
    rows = [(1, 2.5), (-3, 4.0), (2**40, -1.0)]
    blob, is_int = nat.encode_pairs(rows)
    assert is_int == 0
    assert nat.decode_pairs(blob, False) == rows
    assert native.decode_pairs_py(blob, False) == rows
    int_rows = [(7, 2**60), (8, -5)]
    blob, is_int = nat.encode_pairs(int_rows)
    assert is_int == 1
    assert nat.decode_pairs(blob, True) == int_rows
    assert native.decode_pairs_py(blob, True) == int_rows


@pytest.mark.parametrize("op,expected", [(native.OP_ADD, 7.0),
                                         (native.OP_MIN, 3.0),
                                         (native.OP_MAX, 4.0),
                                         (native.OP_PROD, 12.0)])
def test_ops(op, expected):
    blobs, _ = nat.bucket_reduce_pairs([(1, 3.0), (1, 4.0)], 1, op)
    assert dict(nat.merge_encoded([(b, 0) for b in blobs], op)) == \
        {1: expected}


# --- bit for bit against the reference's library ----------------------------


@needs_ref
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["add", "min", "max", "prod"])
@pytest.mark.parametrize("floats", [True, False])
def test_frames_equal_the_references_bytes(seed, op, floats):
    rows = _rows(seed, floats=floats)
    if op == "prod" and not floats:
        rows = [(k, (x % 3) - 1) for k, x in rows]
    got = nat.bucket_reduce_pairs(rows, 7, native.OP_BY_NAME[op])
    want = ref_nat.bucket_reduce_pairs(rows, 7, ref_native.OP_BY_NAME[op])
    assert got == want
    assert nat.bucket_pairs(rows, 5) == ref_nat.bucket_pairs(rows, 5)
    assert nat.encode_pairs(rows) == ref_nat.encode_pairs(rows)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cpp_merge_equals_its_python_twins(seed, op):
    """merge_encoded and the streaming merge in C++ give the Python
    twins' pairs (float sums to 1e-12: the same additions, in hash-map
    order against first-seen order)."""
    rows = _rows(seed)
    blobs, all_int = nat.bucket_reduce_pairs(rows, 3, native.OP_BY_NAME[op])
    flagged = [(b, all_int) for b in blobs] * 2
    cpp = dict(nat.merge_encoded(flagged, native.OP_BY_NAME[op]))
    py = dict(native.merge_encoded_py(flagged, op))
    assert cpp.keys() == py.keys()
    assert cpp == pytest.approx(py, rel=1e-12)
    streams = []
    for use_native in (True, False):
        merger = native.StreamingMerge(op, native=use_native)
        for blob, flag in flagged:
            merger.feed(memoryview(blob), bool(flag))
        streams.append(dict(merger.finish()))
    assert streams[0] == pytest.approx(streams[1], rel=1e-12)
    assert streams[0] == pytest.approx(py, rel=1e-12)
    if ref_nat is not None:
        assert nat.merge_encoded(flagged, native.OP_BY_NAME[op]) == \
            ref_nat.merge_encoded(flagged, ref_native.OP_BY_NAME[op])


# --- jobs through both packages (tests/test_native.py) -----------------------


def _both(ctxs, run):
    ref, port = ctxs
    return run(ref), run(port)


def _same_rows(got):
    """Both packages' rows equal, in order where the reference merged in
    its native hash map too (else its pickled path's order differs)."""
    if ref_nat is None:
        assert sorted(got[0]) == sorted(got[1])
    else:
        assert got[0] == got[1]


def test_host_shuffle_native_path_equivalence(ctxs):
    data = [(i % 50, float(i)) for i in range(5_000)]

    def run(c):
        fast = c.parallelize(data, 4).reduce_by_key(lambda a, b: a + b, 4)
        slow = c.parallelize(data, 4).combine_by_key(
            lambda x: x, lambda a, b: a + b, lambda a, b: a + b, 4)
        joined = dict(fast.join(slow).collect())
        return fast.collect(), dict(slow.collect()), joined

    got = _both(ctxs, run)
    _same_rows((got[0][0], got[1][0]))
    assert dict(got[1][0]) == pytest.approx(got[1][1])
    for k, (a, b) in got[1][2].items():
        assert a == pytest.approx(b)


def test_stored_frames_equal_the_references(ctxs):
    """The map stage's stored buckets: VN01 for a named monoid, VG01 for
    a group, byte for byte the reference's."""
    from vega_tpu.env import Env

    data = _rows(5, n=2_000, floats=False)
    ref, port = ctxs
    frames = []
    for ctx, store in ((ref, lambda: Env.get().shuffle_store),
                       (port, lambda: port.env.shuffle_store)):
        red = ctx.parallelize(data, 3).reduce_by_key(operator.add, 4)
        grp = ctx.parallelize(data, 3).group_by_key(2)
        red.collect()
        grp.collect()
        frames.append(
            [store().get(red.shuffle_id, m, r) for m in range(3)
             for r in range(4)]
            + [store().get(grp.shuffle_id, m, r) for m in range(3)
               for r in range(2)])
    if ref_nat is not None:
        assert frames[0] == frames[1]
    assert all(f[:4] == NATIVE_MAGIC for f in frames[1][:12])
    assert all(f[:4] == NATIVE_GROUP_MAGIC for f in frames[1][12:])


def test_mixed_numeric_and_python_partitions(ctxs):
    def make(idx, it):
        for k, x in it:
            if idx == 0:
                yield (np.int64(k).item(), x)
            else:
                yield (k, x)

    data = [(i % 10, 1) for i in range(1_000)]
    got = _both(ctxs, lambda c: dict(
        c.parallelize(data, 3).map_partitions_with_index(make)
        .reduce_by_key(lambda a, b: a + b, 2).collect()))
    assert got[0] == got[1] == {k: 100 for k in range(10)}


def test_native_group_path_parity(ctxs):
    data = [(i % 23, float(i)) for i in range(4_000)]

    def run(c):
        fast = c.parallelize(data, 4).group_by_key(4).collect()
        mixed = dict(c.parallelize([(1, "a"), (1, "b"), (2, "c")], 2)
                     .group_by_key(2).collect())
        return fast, sorted(mixed[1])

    got = _both(ctxs, run)
    _same_rows((got[0][0], got[1][0]))
    assert got[0][1] == got[1][1]
    expected = {}
    for k, x in data:
        expected.setdefault(k, []).append(x)
    fast = dict(got[1][0])
    assert set(fast) == set(expected)
    for k in expected:
        assert sorted(fast[k]) == sorted(expected[k])
    assert got[1][1] == ["a", "b"]


def test_native_group_path_cogroup(ctxs):
    def run(c):
        a = c.parallelize([(i % 5, i) for i in range(100)], 3)
        b = c.parallelize([(i % 5, i * 10) for i in range(50)], 3)
        return {k: (sorted(x), sorted(y))
                for k, (x, y) in a.cogroup(b).collect()}

    got = _both(ctxs, run)
    assert got[0] == got[1]
    for k in range(5):
        assert got[1][k] == ([x for x in range(100) if x % 5 == k],
                             [x * 10 for x in range(50) if x % 5 == k])


def test_mixed_value_types_preserve_fidelity(ctxs):
    big = 2**60 + 1

    def run(c):
        g = dict(c.parallelize([(1, 2), (1, 2.5)], 1).group_by_key(1)
                 .collect())
        g2 = dict(c.parallelize([(1, big), (1, 0.5)], 1).group_by_key(1)
                  .collect())
        r = dict(c.parallelize([(1, 2), (1, 3), (2, 2.5)], 1)
                 .reduce_by_key(lambda a, b: a + b, 1).collect())
        return (g, [type(x).__name__ for x in g[1]], g2,
                {k: (x, type(x).__name__) for k, x in r.items()})

    got = _both(ctxs, run)
    assert got[0] == got[1]
    g, types, g2, r = got[1]
    assert 2 in g[1] and 2.5 in g[1] and "int" in types
    assert big in g2[1]
    assert r[1] == (5, "int")


def test_int64_overflow_rejects_to_exact_python(ctxs):
    big = 2**40

    def run(c):
        got = dict(c.parallelize([(1, big), (1, big), (1, 8), (2, 5)], 2)
                   .reduce_by_key(lambda a, b: a * b, 2).collect())
        gs = dict(c.parallelize([(1, 2**62)] * 3, 1)
                  .reduce_by_key(lambda a, b: a + b, 1).collect())
        gm = dict(c.parallelize([(1, 2**62), (1, 2**62)], 2)
                  .reduce_by_key(lambda a, b: a + b, 1).collect())
        return got, gs, gm

    got = _both(ctxs, run)
    assert got[0] == got[1] == ({1: big * big * 8, 2: 5}, {1: 3 * 2**62},
                                {1: 2**63})
    assert all(isinstance(x, int) for d in got[1] for x in d.values())


@pytest.mark.parametrize("seed", [6, 7])
def test_seeded_jobs_give_the_references_rows_in_order(ctxs, seed):
    """min / max / add over seeded int and float rows: the same rows, in
    the same order, from both packages' local runtimes."""
    rows_i = _rows(seed, n=3_000, keys=300, floats=False)
    rows_f = _rows(seed, n=3_000, keys=300, floats=True)

    def run(c):
        return [c.parallelize(rows_i, 4).reduce_by_key(min, 3).collect(),
                c.parallelize(rows_i, 4).reduce_by_key(max, 5).collect(),
                c.parallelize(rows_i, 4).reduce_by_key(operator.add, 2)
                .collect(),
                c.parallelize(rows_f, 4).reduce_by_key(max, 3).collect()]

    got = _both(ctxs, run)
    for a, b in zip(*got):
        _same_rows((a, b))


# --- the build ---------------------------------------------------------------


def _build_in(build_dir, out):
    try:
        out.put(native.build(build_dir))
    except Exception as e:  # noqa: BLE001 — reported to the test
        out.put(f"error: {e}")


def test_concurrent_builds_make_one_library(tmp_path):
    """Four threads and three processes build into one empty directory at
    once: every one gets the same path, the file loads and works, and no
    temporary file is left beside it."""
    build_dir = str(tmp_path / "build")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_in, args=(build_dir, q))
             for _ in range(3)]
    for p in procs:
        p.start()
    results = []
    lock = threading.Lock()

    def in_thread():
        path = native.build(build_dir)
        with lock:
            results.append(path)

    threads = [threading.Thread(target=in_thread) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for p in procs:
        p.join(timeout=300)
    results += [q.get(timeout=5) for _ in procs]
    want = native.library_path(build_dir)
    assert results == [want] * 7
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(want), ".vega_native.lock"])
    mod = native.load(want)
    assert mod.decode_pairs(mod.encode_pairs([(3, 4)])[0], True) == [(3, 4)]


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'no such compiler here' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    with pytest.raises(VegaError, match="no such compiler here"):
        native.build(str(tmp_path / "build"))
    assert not os.path.exists(native.library_path(str(tmp_path / "build")))


def test_an_executor_never_compiles(tmp_path, monkeypatch):
    """With VEGA_TPU_NATIVE_LIB set (an executor) get() loads that file;
    a path that is not there raises instead of building."""
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setenv(native.LIB_ENV, str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "build", lambda *a: pytest.fail("built"))
    with pytest.raises(VegaError, match="never compiles"):
        native.get()
    monkeypatch.setenv(native.LIB_ENV, native.library_path())
    assert native.get().hash_i64(np.int64(5).tobytes(), 3) == \
        nat.hash_i64(np.int64(5).tobytes(), 3)
