"""The port's partition cache (vega_tpu_torch/cache.py, store/tiered.py,
cache_tracker.py) against vega_tpu's, on the CPU.

Counterparts of the TieredCache and tracker tests of tests/test_store.py:
eviction demotes and a get promotes, MEMORY_ONLY eviction drops,
DISK_ONLY skips memory, an oversize value goes to disk (logged once),
remove_datum clears both tiers, a fresh put invalidates a stale disk
copy, a get mid-demotion never misses, and end to end a persisted RDD
past the memory cap is served from disk with no recompute, an oversize
partition too, and unpersist clears both tiers. Each runs the same calls
through both packages and compares what they observe.
"""

import threading

import pytest

import vega_tpu as v
from vega_tpu import cache as ref_cache
from vega_tpu import store as ref_store
from vega_tpu.env import Env as RefEnv
import vega_tpu_torch as vt
from vega_tpu_torch import cache as port_cache
from vega_tpu_torch import store as port_store
from vega_tpu_torch.store.tiered import TieredCache as PortTiered

PKGS = {
    "ref": (ref_cache, ref_store.DiskStore, ref_store.TieredCache,
            ref_store.StorageLevel),
    "port": (port_cache, port_store.DiskStore, PortTiered,
             port_store.StorageLevel),
}
BIG = list(range(500))  # ~14 KB by _sizeof: two fit in 30 KB, a third evicts


def _tiered(pkg, tmp_path, capacity, disk_cls=None):
    cache_mod, disk, tiered, _ = PKGS[pkg]
    return tiered(cache_mod.BoundedMemoryCache(capacity),
                  (disk_cls or disk)(str(tmp_path / pkg / "cache")))


def _both(run, tmp_path):
    return [run(pkg, tmp_path) for pkg in ("ref", "port")]


def test_sizeof_equals_reference():
    rows = [BIG, [(i, str(i)) for i in range(100)], {i: [i] for i in
                                                    range(300)}, []]
    assert [port_cache._sizeof(r) for r in rows] == \
        [ref_cache._sizeof(r) for r in rows]


def test_eviction_demotes_and_get_promotes(tmp_path):
    def run(pkg, tmp_path):
        cache_mod, _, _, level = PKGS[pkg]
        rdd = cache_mod.KeySpace.RDD
        cache = _tiered(pkg, tmp_path, 30_000)
        cache.set_level(rdd, 1, level.MEMORY_AND_DISK)
        for p in range(3):
            cache.put(rdd, 1, p, BIG)
        spilled = cache.spill_count
        on_disk = cache.disk_used_bytes > 0
        got = cache.get(rdd, 1, 0)
        return spilled, on_disk, got == BIG, cache.promote_count

    ref, port = _both(run, tmp_path)
    assert port == ref and port[0] >= 1 and port[3] >= 1


def test_memory_only_eviction_still_drops(tmp_path):
    def run(pkg, tmp_path):
        rdd = PKGS[pkg][0].KeySpace.RDD
        cache = _tiered(pkg, tmp_path, 30_000)
        for p in range(3):
            cache.put(rdd, 1, p, BIG)
        return cache.get(rdd, 1, 0), cache.spill_count, cache.evictions

    ref, port = _both(run, tmp_path)
    assert port == ref == (None, 0, 1)


def test_disk_only_skips_memory(tmp_path):
    def run(pkg, tmp_path):
        cache_mod, _, _, level = PKGS[pkg]
        cache = _tiered(pkg, tmp_path, 1 << 20)
        cache.put(cache_mod.KeySpace.RDD, 7, 0, [1, 2, 3],
                  level=level.DISK_ONLY)
        return (cache.used_bytes, cache.disk_used_bytes > 0,
                cache.get(cache_mod.KeySpace.RDD, 7, 0))

    ref, port = _both(run, tmp_path)
    assert port == ref == (0, True, [1, 2, 3])


def test_oversize_value_routed_to_disk(tmp_path, caplog):
    def run(pkg, tmp_path):
        cache_mod, _, _, level = PKGS[pkg]
        rdd = cache_mod.KeySpace.RDD
        cache = _tiered(pkg, tmp_path, 1_000)
        cache.set_level(rdd, 3, level.MEMORY_AND_DISK)
        huge = list(range(5_000))
        caplog.clear()
        with caplog.at_level("WARNING"):
            ok = (cache.put(rdd, 3, 0, huge), cache.put(rdd, 3, 1, huge))
        logs = [r for r in caplog.records
                if "larger than the memory capacity" in r.getMessage()]
        return ok, cache.used_bytes, cache.get(rdd, 3, 0) == huge, len(logs)

    ref, port = _both(run, tmp_path)
    assert port == ref == ((True, True), 0, True, 1)


def test_remove_datum_clears_both_tiers(tmp_path):
    def run(pkg, tmp_path):
        cache_mod, _, _, level = PKGS[pkg]
        rdd = cache_mod.KeySpace.RDD
        cache = _tiered(pkg, tmp_path, 30_000)
        cache.set_level(rdd, 1, level.MEMORY_AND_DISK)
        for p in range(3):
            cache.put(rdd, 1, p, BIG)
        held = cache.disk_used_bytes > 0 or cache.used_bytes > 0
        cache.remove_datum(rdd, 1)
        return (held, cache.used_bytes, cache.disk_used_bytes,
                [cache.get(rdd, 1, p) for p in range(3)])

    ref, port = _both(run, tmp_path)
    assert port == ref == (True, 0, 0, [None] * 3)


def test_fresh_put_invalidates_stale_disk_copy(tmp_path):
    def run(pkg, tmp_path):
        cache_mod, _, _, level = PKGS[pkg]
        rdd = cache_mod.KeySpace.RDD
        cache = _tiered(pkg, tmp_path, 30_000)
        cache.set_level(rdd, 1, level.MEMORY_AND_DISK)
        for p in range(3):
            cache.put(rdd, 1, p, BIG)
        demoted = cache.disk.contains("cache-rdd-1-0")
        cache.put(rdd, 1, 0, [42])
        return demoted, cache.disk.contains("cache-rdd-1-0"), \
            cache.get(rdd, 1, 0)

    ref, port = _both(run, tmp_path)
    assert port == ref == (True, False, [42])


def test_concurrent_get_during_demotion_never_misses(tmp_path):
    """A get landing while the victim's demotion is mid-write finds it in
    one tier (the disk write is gated open while it is probed)."""
    def run(pkg, tmp_path):
        cache_mod, disk, _, level = PKGS[pkg]
        rdd = cache_mod.KeySpace.RDD
        write_started = threading.Event()
        release_write = threading.Event()

        class GatedDisk(disk):
            def put(self, key, data):
                if key == "cache-rdd-1-0" and not release_write.is_set():
                    write_started.set()
                    release_write.wait(5.0)
                return super().put(key, data)

        cache = _tiered(pkg, tmp_path, 30_000, GatedDisk)
        cache.set_level(rdd, 1, level.MEMORY_AND_DISK)
        cache.put(rdd, 1, 0, BIG)
        cache.put(rdd, 1, 1, BIG)
        evictor = threading.Thread(target=cache.put, args=(rdd, 1, 2, BIG))
        evictor.start()
        reached = write_started.wait(5.0)
        mid = cache.get(rdd, 1, 0)
        release_write.set()
        evictor.join(5.0)
        return reached, mid == BIG, cache.get(rdd, 1, 0) == BIG

    ref, port = _both(run, tmp_path)
    assert port == ref == (True, True, True)


# --- end to end through a Context ------------------------------------------


def _ctx(pkg, cap):
    if pkg == "ref":
        return v.Context("local", num_workers=2, cache_capacity_bytes=cap)
    return vt.Context(device="cpu", n_shards=4, num_workers=2,
                      cache_capacity_bytes=cap)


def _env(pkg, ctx):
    return RefEnv.get() if pkg == "ref" else ctx.env


def test_spill_roundtrip_zero_recompute():
    """Past the memory cap a MEMORY_AND_DISK node's second action
    recomputes nothing: every memory miss is a disk hit, counted in
    storage_status and on the bus."""
    out = []
    for pkg in ("ref", "port"):
        calls = []
        with _ctx(pkg, 50_000) as ctx:
            level = PKGS[pkg][3]

            def probe(x):
                calls.append(x)
                return x

            data = list(range(4_000))
            rdd = ctx.parallelize(data, 8).map(probe).persist(
                level.MEMORY_AND_DISK)
            first = rdd.collect() == data
            n_first = len(calls)
            spills = ctx.storage_status()["cache"]["spill_count"] > 0
            second = rdd.collect() == data
            promotes = ctx.storage_status()["cache"]["promote_count"] > 0
            summary = ctx.metrics_summary()
            out.append((first, n_first, spills, second, len(calls) - n_first,
                        promotes, summary["spilled_bytes"].get("cache", 0) > 0,
                        summary["promoted_bytes"].get("cache", 0) > 0))
    assert out[1] == out[0] == (True, 4000, True, True, 0, True, True, True)


def test_oversize_partition_served_end_to_end():
    out = []
    for pkg in ("ref", "port"):
        calls = []
        with _ctx(pkg, 10_000) as ctx:
            def probe(x):
                calls.append(x)
                return x

            data = list(range(2_000))
            rdd = ctx.parallelize(data, 2).map(probe).persist(
                PKGS[pkg][3].MEMORY_AND_DISK)
            ok = rdd.collect() == data
            n_first = len(calls)
            ok2 = rdd.collect() == data
            out.append((ok, ok2, len(calls) - n_first,
                        ctx.storage_status()["cache"]["disk_bytes"] > 0))
    assert out[1] == out[0] == (True, True, 0, True)


def test_unpersist_clears_disk_tier_too():
    out = []
    for pkg in ("ref", "port"):
        with _ctx(pkg, 20_000) as ctx:
            rdd = ctx.parallelize(list(range(4_000)), 8).persist(
                PKGS[pkg][3].MEMORY_AND_DISK)
            rdd.count()
            env = _env(pkg, ctx)
            held = env.cache.used_bytes > 0 or env.cache.disk_used_bytes > 0
            rdd.unpersist()
            out.append((held, env.cache.used_bytes))
    assert out[1] == out[0] == (True, 0)


def test_tracker_registers_cached_partitions():
    """get_or_compute registers each computed partition's location with
    the cache tracker, and the scheduler prefers it."""
    out = []
    for pkg in ("ref", "port"):
        with _ctx(pkg, 1 << 20) as ctx:
            rdd = ctx.parallelize(list(range(100)), 4).cache()
            rdd.count()
            tracker = _env(pkg, ctx).cache_tracker
            snap = tracker.get_location_snapshot().get(rdd.rdd_id, {})
            locs = ctx.scheduler._get_preferred_locs(rdd, 2)
            out.append((sorted(snap.items()), locs))
    assert out[1] == out[0] == ([(p, ["local"]) for p in range(4)],
                                ["local"])


@pytest.mark.parametrize("level", ["memory_only", "memory_and_disk",
                                   "disk_only"])
def test_persisted_levels_serve_equal_rows(level):
    """Each StorageLevel serves the rows it computed once, equal to the
    reference's."""
    out = []
    for pkg in ("ref", "port"):
        calls = []
        with _ctx(pkg, 1 << 20) as ctx:
            def probe(x):
                calls.append(x)
                return (x % 7, x)

            rdd = ctx.parallelize(list(range(300)), 3).map(probe) \
                .persist(level)
            a = rdd.collect()
            b = rdd.reduce_by_key(lambda x, y: x + y, 2).collect()
            out.append((a, sorted(b), len(calls)))
    assert out[1] == out[0]
