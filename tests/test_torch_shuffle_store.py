"""The port's shuffle store (vega_tpu_torch/shuffle/store.py) and its
reduce-side fetch against vega_tpu's, on the CPU.

Counterparts of tests/test_store.py's shuffle-store tests (the memory
budget spills the oldest buckets, spill_all and status, remove_shuffle)
and of tests/test_chaos.py::test_corrupt_spill_recovery_local_mode (a
corrupt spilled bucket reads as missing, the reduce task's fetch fails,
the map stage is resubmitted and the result is right), plus the budget
spill end to end and a missing bucket raising FetchFailedError. Each runs
the same calls through both packages and compares what they observe.
"""

import os

import pytest

import vega_tpu as v
from vega_tpu import faults as ref_faults
from vega_tpu.shuffle.store import ShuffleStore as RefStore
import vega_tpu_torch as vt
from vega_tpu_torch import faults as port_faults
from vega_tpu_torch.errors import FetchFailedError
from vega_tpu_torch.shuffle.fetcher import ShuffleFetcher
from vega_tpu_torch.shuffle.store import ShuffleStore as PortStore

STORES = {"ref": RefStore, "port": PortStore}


def _ctx(pkg, **kw):
    if pkg == "ref":
        return v.Context("local", num_workers=4, **kw)
    return vt.Context(device="cpu", n_shards=4, num_workers=4, **kw)


def test_shuffle_store_memory_budget_spills_oldest(tmp_path):
    out = []
    for pkg, store_cls in STORES.items():
        root = str(tmp_path / pkg)
        store = store_cls(spill_dir=root, spill_threshold=10_000,
                          memory_budget=250)
        for r in range(5):
            store.put(1, 0, r, bytes([r]) * 100)
        st = store.status()
        served = [store.get(1, 0, r) == bytes([r]) * 100 for r in range(5)]
        store.close()
        out.append((st["disk_entries"], st["mem_bytes"], st["mem_entries"],
                    st["spilled_bytes"], served, os.path.exists(root)))
    assert out[1] == out[0]
    assert out[1][0] >= 2 and out[1][1] <= 250 and not out[1][5]


def test_shuffle_spill_all_and_status(tmp_path):
    out = []
    for pkg, store_cls in STORES.items():
        store = store_cls(spill_dir=str(tmp_path / pkg))
        store.put(2, 1, 0, b"abc")
        store.put(2, 1, 1, b"def")
        mem = store.status()["mem_entries"]
        spilled = store.spill_all()
        st = store.status()
        got = store.get(2, 1, 1)
        store.remove_shuffle(2)
        out.append((mem, spilled, st["mem_entries"], st["disk_entries"],
                    got, len(store)))
    assert out[1] == out[0] == (2, 2, 0, 2, b"def", 0)


def test_shuffle_threshold_sends_a_large_bucket_to_disk(tmp_path):
    out = []
    for pkg, store_cls in STORES.items():
        store = store_cls(spill_dir=str(tmp_path / pkg), spill_threshold=10)
        store.put(3, 0, 0, b"x" * 100)
        store.put(3, 0, 1, b"y" * 5)
        st = store.status()
        out.append((st["mem_entries"], st["disk_entries"],
                    store.get(3, 0, 0), store.contains(3, 0, 1)))
        store.close()
    assert out[1] == out[0] == (1, 1, b"x" * 100, True)


def test_corrupt_spill_recovery_local_mode():
    """Every bucket spills (threshold 1 byte), the first one spilled is
    corrupted: its checksummed read is a miss, the reduce fetch fails,
    the map stage is resubmitted and the result is right."""
    out = []
    for pkg, faults in (("ref", ref_faults), ("port", port_faults)):
        faults.configure(corrupt_spill_n=1)
        try:
            with _ctx(pkg, shuffle_spill_threshold=1,
                      resubmit_timeout_s=0.2) as ctx:
                pairs = ctx.parallelize([(i % 3, 1) for i in range(90)], 4)
                got = dict(pairs.reduce_by_key(lambda a, b: a + b,
                                               3).collect())
                errors = ctx.storage_status()["shuffle"]["read_errors"]
                resubmitted = ctx.metrics_summary()["stages_resubmitted"]
                out.append((got, errors >= 1, resubmitted >= 1))
        finally:
            faults.reset()
    assert out[1] == out[0] == ({0: 30, 1: 30, 2: 30}, True, True)


def test_budget_spill_end_to_end():
    """A shuffle past its memory budget spills buckets to disk and reads
    them back: the same rows as with no spill, and the spills counted."""
    rows = [(i % 97, i) for i in range(20_000)]
    out = []
    for pkg in ("ref", "port"):
        with _ctx(pkg, shuffle_memory_budget=4096) as ctx:
            got = sorted(ctx.parallelize(rows, 8)
                         .reduce_by_key(lambda a, b: a + b, 6).collect())
            st = ctx.storage_status()["shuffle"]
            summary = ctx.metrics_summary()
            out.append((got, st["spill_count"] > 0,
                        summary["spilled_bytes"].get("shuffle", 0) > 0))
    assert out[1] == out[0] and out[1][1] and out[1][2]


def test_missing_bucket_raises_fetch_failed():
    with vt.Context(device="cpu", n_shards=4) as ctx:
        rdd = ctx.parallelize([(i % 4, i) for i in range(40)], 4) \
            .reduce_by_key(lambda a, b: a + b, 2)
        rdd.collect()
        ctx.env.shuffle_store._mem.pop((rdd.shuffle_id, 1, 0))
        with pytest.raises(FetchFailedError) as info:
            list(ShuffleFetcher.fetch(ctx.env, rdd.shuffle_id, 0))
        err = info.value
        assert (err.server_uri, err.shuffle_id, err.map_id,
                err.reduce_id) == ("local", rdd.shuffle_id, 1, 0)
        assert sorted(ShuffleFetcher.fetch(ctx.env, rdd.shuffle_id, 1))
