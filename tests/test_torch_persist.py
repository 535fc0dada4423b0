"""persist(level) and the spill tier of vega_tpu_torch against vega_tpu, on
the CPU.

A node persisted at MEMORY_AND_DISK (or DISK_ONLY, which behaves alike for
dense nodes) is demoted to the disk store when the lifetime LRU evicts it,
and its next access promotes the snapshot back instead of recomputing its
lineage; both packages are driven through the same scenarios (the
reference's tests/test_dense.py spill tests) and must give equal rows and
equal counters. The reference's budget and store are its Env's (set here
and restored after); both run on 8 shards under the card's plans.
"""

import os

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.store import StorageLevel
from vega_tpu_torch.store import disk as port_disk

N_SHARDS = 8
PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
         "dense_sort_impl": "xla"}


class _Ctxs:
    def __init__(self, spill_dir):
        from vega_tpu.env import Env

        self.ref = v.Context("local", num_workers=2)
        conf = Env.get().conf
        keys = list(PLANS) + ["dense_exchange"]
        self._restore = {k: getattr(conf, k) for k in keys}
        for k, val in dict(PLANS, dense_exchange="all_to_all").items():
            setattr(conf, k, val)
        self.port = vt.Context(device="cpu", n_shards=N_SHARDS,
                               dense_exchange="all_to_all",
                               spill_dir=str(spill_dir), **PLANS)

    def stop(self):
        from vega_tpu.env import Env

        self.port.stop()
        for k, val in self._restore.items():
            setattr(Env.get().conf, k, val)
        self.ref.stop()


@pytest.fixture()
def ctxs(tmp_path):
    c = _Ctxs(tmp_path)
    try:
        yield c
    finally:
        c.stop()


def _evict_all(ctxs):
    """A demotion sweep at a zero budget in both packages."""
    from vega_tpu.env import Env
    from vega_tpu.tpu import dense_rdd as ref_dr

    conf = Env.get().conf
    old = conf.dense_hbm_budget
    conf.dense_hbm_budget = 0
    try:
        ref_dr._lifetime_evict(ctxs.ref)
    finally:
        conf.dense_hbm_budget = old
    old = ctxs.port.dense_hbm_budget
    ctxs.port.dense_hbm_budget = 0
    try:
        dense_rdd._lifetime_evict(ctxs.port)
    finally:
        ctxs.port.dense_hbm_budget = old


def _ref_status():
    from vega_tpu.env import Env

    return Env.get().cache.status()


def _ref_contains(node):
    from vega_tpu.env import Env
    from vega_tpu.tpu import dense_rdd as ref_dr

    return Env.get().cache.contains_raw(ref_dr._dense_spill_key(node))


def _poison(node):
    def refuse():
        raise AssertionError("a promoted access must not recompute")
    node._materialize = refuse


def _persisted_reduce(ctx, level, n=20_000, k=100):
    return (ctx.dense_range(n).map(lambda x: (x % k, x))
            .reduce_by_key(op="add").persist(level))


def test_spilled_block_parity(ctxs):
    """The reference's test_dense_spilled_block_parity in both packages:
    the demoted block promotes with no recompute, equal to the host fold
    and to the reference, hash_placed survives and the downstream reduce
    elides its exchange, and unpersist drops the snapshot."""
    from vega_tpu.store import StorageLevel as RefLevel

    n, k = 20_000, 100
    port = _persisted_reduce(ctxs.port, StorageLevel.MEMORY_AND_DISK, n, k)
    ref = _persisted_reduce(ctxs.ref, RefLevel.MEMORY_AND_DISK, n, k)
    exp = {}
    for i in range(n):
        exp[i % k] = exp.get(i % k, 0) + i
    assert dict(port.collect()) == dict(ref.collect()) == exp
    counts = port.block().counts_np.copy()

    _evict_all(ctxs)
    assert port._block is None and ref._block is None
    assert ctxs.port.spill_status()["spilled_bytes"] > 0
    assert _ref_status()["spilled_bytes"] > 0
    assert ctxs.port.spill_status()["spill_count"] == 1

    _poison(port)
    _poison(ref)
    got, want = dict(port.collect()), dict(ref.collect())
    assert got == want == exp
    assert port._block is not None and ref._block is not None
    assert ctxs.port.spill_status()["promote_count"] == 1
    assert _ref_status()["promote_count"] > 0
    np.testing.assert_array_equal(port.block().counts_np, counts)

    assert port.hash_placed and ref.hash_placed
    del port.__dict__["_materialize"]
    del ref.__dict__["_materialize"]
    again, ragain = port.reduce_by_key(op="add"), ref.reduce_by_key(op="add")
    assert dict(again.collect()) == dict(ragain.collect()) == exp
    assert again._exchange_plan is None and ragain._exchange_plan is None

    key = dense_rdd._dense_spill_key(port)
    path = ctxs.port._spill.path_of(key)
    assert os.path.exists(path)
    port.unpersist()
    ref.unpersist()
    assert not ctxs.port._spill.contains_raw(key) and not _ref_contains(ref)
    assert not os.path.exists(path)
    assert ctxs.port.spill_status()["disk_entries"] == 0


def test_unspilled_eviction_still_recomputes(ctxs):
    """Without a disk level an eviction drops the block, writes nothing,
    and the next access recomputes from lineage."""
    port = ctxs.port.dense_range(10_000).map(lambda x: x * 3)
    ref = ctxs.ref.dense_range(10_000).map(lambda x: x * 3)
    total = port.sum()
    assert total == ref.sum()
    _evict_all(ctxs)
    assert port._block is None and ref._block is None
    assert not ctxs.port._spill.contains_raw(dense_rdd._dense_spill_key(port))
    assert not _ref_contains(ref)
    assert ctxs.port.spill_status()["spill_count"] == 0
    assert port.sum() == ref.sum() == total
    assert not os.path.exists(ctxs.port._spill.root)


@pytest.mark.parametrize("level", [StorageLevel.DISK_ONLY, "disk_only",
                                   "DISK_ONLY"])
def test_disk_only_behaves_like_memory_and_disk(ctxs, level):
    """DISK_ONLY keeps the block on the device until an eviction, then
    demotes and promotes it as MEMORY_AND_DISK does."""
    port = _persisted_reduce(ctxs.port, level)
    ref = _persisted_reduce(ctxs.ref, "disk_only")
    before = dict(port.collect())
    assert before == dict(ref.collect())
    assert port._storage_level is StorageLevel.DISK_ONLY
    assert port._block is not None  # computed on the device as ever
    _evict_all(ctxs)
    _poison(port)
    assert dict(port.collect()) == before
    st = ctxs.port.spill_status()
    assert st["spill_count"] == st["promote_count"] == 1


def test_corrupt_snapshot_is_a_miss(ctxs):
    """One flipped byte in the snapshot: the checksummed read misses,
    counts in disk_read_errors, drops the file, and the node recomputes
    equal rows, in both packages."""
    from vega_tpu.env import Env
    from vega_tpu.tpu import dense_rdd as ref_dr

    port = _persisted_reduce(ctxs.port, "MEMORY_AND_DISK")
    ref = _persisted_reduce(ctxs.ref, "MEMORY_AND_DISK")
    before = dict(port.collect())
    assert before == dict(ref.collect())
    _evict_all(ctxs)
    paths = [ctxs.port._spill.path_of(dense_rdd._dense_spill_key(port)),
             Env.get().cache.disk.path_of(ref_dr._dense_spill_key(ref))]
    for path in paths:
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
    assert dict(port.collect()) == dict(ref.collect()) == before
    st = ctxs.port.spill_status()
    assert st["disk_read_errors"] == _ref_status()["disk_read_errors"] == 1
    assert st["promote_count"] == 0 and st["disk_entries"] == 0
    assert not any(os.path.exists(p) for p in paths)
    # the recomputed block demotes afresh at the next eviction
    _evict_all(ctxs)
    _poison(port)
    assert dict(port.collect()) == before
    assert ctxs.port.spill_status()["spill_count"] == 2


def test_string_keyed_reduce_survives_spill(ctxs):
    """A string-keyed reduce demotes its int32 codes; the promoted block
    takes its dictionary back from the lineage and decodes as the
    reference's does."""
    rng = np.random.RandomState(4)
    words = np.array([f"w{i:03d}" for i in range(60)])
    keys = words[rng.randint(0, 60, size=3_000)]
    vals = rng.randint(0, 1000, size=3_000).astype(np.int32)
    port = ctxs.port.dense_from_numpy(keys, vals).reduce_by_key(
        op="add").persist("MEMORY_AND_DISK")
    ref = ctxs.ref.dense_from_numpy(keys, vals).reduce_by_key(
        op="add").persist("MEMORY_AND_DISK")
    exp = dict(ref.collect())
    assert dict(port.collect()) == exp
    _evict_all(ctxs)
    assert port._block is None
    _poison(port)
    _poison(ref)
    assert dict(port.collect()) == dict(ref.collect()) == exp
    assert port.block().dicts is not None
    assert ctxs.port.spill_status()["promote_count"] == 1


def test_wide_keyed_reduce_survives_spill(ctxs):
    """A reduce over int64 keys beyond int32 (the two-column encoding)
    promotes both key words and equals the reference's."""
    rng = np.random.RandomState(5)
    keys = (rng.randint(0, 40, size=2_000).astype(np.int64) << 40) - 7
    vals = rng.randint(-50, 50, size=2_000).astype(np.int32)
    port = ctxs.port.dense_from_numpy(keys, vals).reduce_by_key(
        op="add").persist("MEMORY_AND_DISK")
    ref = ctxs.ref.dense_from_numpy(keys, vals).reduce_by_key(
        op="add").persist("MEMORY_AND_DISK")
    exp = dict(ref.collect())
    assert dict(port.collect()) == exp
    assert port.wide_key
    _evict_all(ctxs)
    _poison(port)
    assert dict(port.collect()) == exp
    assert port.hash_placed
    del port.__dict__["_materialize"]
    assert dict(port.reduce_by_key(op="max").collect()) == exp


def test_snapshot_of_another_shard_count_is_a_miss(ctxs):
    """A snapshot whose counts do not have the node's shard count is not
    promoted: the node recomputes."""
    import io

    port = _persisted_reduce(ctxs.port, "MEMORY_AND_DISK")
    before = dict(port.collect())
    port.unpersist()
    buf = io.BytesIO()
    np.savez(buf, counts=np.zeros(4, np.int32), capacity=np.int64(128),
             **{"col:k": np.zeros(512, np.int32),
                "col:v": np.zeros(512, np.int32)})
    ctxs.port._spill.spill_raw(dense_rdd._dense_spill_key(port),
                               buf.getvalue())
    assert dense_rdd._load_spilled_block(port) is None
    assert dict(port.collect()) == before


def test_failed_spill_leaves_the_node_to_recompute(ctxs, monkeypatch):
    """A spill that raises OSError (a full disk) is logged; the block is
    dropped all the same and the node recomputes."""
    port = _persisted_reduce(ctxs.port, "MEMORY_AND_DISK")
    before = dict(port.collect())

    def full(key, data):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ctxs.port._spill, "spill_raw", full)
    _evict_all(ctxs)
    assert port._block is None
    assert ctxs.port.spill_status()["disk_entries"] == 0
    assert dict(port.collect()) == before


def test_stop_removes_the_session_directory(tmp_path):
    """The store lives in <spill_dir>/session-<id>/cache, made at the
    first demotion; stop() removes the session directory and leaves
    spill_dir itself."""
    ctx = vt.Context(device="cpu", n_shards=N_SHARDS, spill_dir=str(tmp_path))
    root = ctx._spill.root
    session = os.path.dirname(root)
    assert os.path.basename(root) == "cache"
    assert os.path.dirname(session) == str(tmp_path)
    assert os.path.basename(session).startswith("session-")
    assert not os.path.exists(session)  # nothing written yet
    node = _persisted_reduce(ctx, "MEMORY_AND_DISK")
    node.count()
    ctx.dense_hbm_budget = 0
    dense_rdd._lifetime_evict(ctx)
    assert len(os.listdir(root)) == 1
    ctx.stop()
    assert not os.path.exists(session) and os.path.isdir(tmp_path)


def test_default_spill_root_is_under_the_temp_dir(tmp_path, monkeypatch):
    """With no spill_dir the store lives under
    tempfile.gettempdir()/vega-tpu/spill, one session per Context."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with vt.Context(device="cpu", n_shards=N_SHARDS) as a, \
            vt.Context(device="cpu", n_shards=N_SHARDS) as b:
        ra, rb = a._spill.root, b._spill.root
        base = os.path.join(str(tmp_path), "vega-tpu", "spill")
        assert os.path.dirname(os.path.dirname(ra)) == base
        assert os.path.dirname(ra) != os.path.dirname(rb)


def test_disk_store_round_trip_and_truncation(tmp_path):
    """The port's DiskStore: put / get round trip, byte accounting, a
    truncated file reads as a miss, a missing one is dropped quietly."""
    store = port_disk.DiskStore(str(tmp_path / "c"))
    assert store.put("a/b c", b"hello") == 5
    assert bytes(store.get("a/b c")) == b"hello"
    assert store.used_bytes == 5 and len(store) == 1
    name = os.path.basename(store.path_of("a/b c"))
    assert name.startswith("a_b_c.") and name.endswith(".blk")
    store.put("t", b"x" * 100)
    with open(store.path_of("t"), "r+b") as fh:
        fh.truncate(30)
    assert store.get("t") is None and store.read_errors == 1
    store.put("m", b"y")
    os.unlink(store.path_of("m"))
    assert store.get("m") is None and store.read_errors == 1
    assert len(store) == 1 and store.used_bytes == 5
    store.close()
    assert not os.path.exists(store.root)


def test_disk_store_counts_spills_and_promotes(tmp_path):
    """spill_raw / read_raw are put / get counted under the reference's
    status() keys; plain put / get, a miss and a removal count nothing
    but the bytes on disk."""
    store = port_disk.DiskStore(str(tmp_path / "c"))
    store.put("p", b"z" * 7)
    assert bytes(store.get("p")) == b"z" * 7
    assert store.spill_raw("s", b"abc") == 3
    assert bytes(store.read_raw("s")) == b"abc"
    assert store.read_raw("absent") is None
    assert store.contains_raw("s") and not store.contains_raw("absent")
    assert store.status() == {
        "disk_bytes": 10, "disk_entries": 2, "spill_count": 1,
        "spilled_bytes": 3, "promote_count": 1, "promoted_bytes": 3,
        "disk_read_errors": 0}
    assert store.remove_raw("s") == 3 and store.remove_raw("s") == 0
    assert store.status()["disk_bytes"] == 7
    store.close()


_LEVEL_INPUTS = [None, "memory_only", "MEMORY_ONLY", "Memory_And_Disk",
                 "memory_and_disk", "DISK_ONLY", "disk_only", "disk",
                 "", 3, 1.5]


@pytest.mark.parametrize("value", _LEVEL_INPUTS)
def test_storage_level_coerce_matches_reference(value):
    """coerce agrees with the reference's on names, values, case, None
    and invalid inputs (ValueError in both)."""
    from vega_tpu.store import StorageLevel as RefLevel

    try:
        want = RefLevel.coerce(value)
    except ValueError:
        with pytest.raises(ValueError):
            StorageLevel.coerce(value)
        return
    got = StorageLevel.coerce(value)
    assert (got.name, got.value) == (want.name, want.value)
    assert (got.use_memory, got.use_disk) == (want.use_memory,
                                              want.use_disk)


def test_storage_level_members_match_reference():
    from vega_tpu.store import StorageLevel as RefLevel

    for lvl in RefLevel:
        got = StorageLevel.coerce(lvl.name)
        assert StorageLevel.coerce(got) is got
        assert (got.value, got.use_memory, got.use_disk) == (
            lvl.value, lvl.use_memory, lvl.use_disk)
    assert [x.name for x in StorageLevel] == [x.name for x in RefLevel]
