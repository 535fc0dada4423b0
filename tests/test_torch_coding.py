"""The coded shuffle of vega_tpu_torch (shuffle/coding.py, the store's
parity fold, the tracker's parity registry, the server's put_parity /
get_parity and the fetcher's reconstruction) against vega_tpu's, on the
CPU.

The same seeded buckets are folded in both packages: the VP01 frames are
equal byte for byte, and so are the GF(256) decodes; the decode's
kernels.gf256_accumulate on the CPU equals the numpy twin
(_accumulate_np) bit for bit. Then jobs over a fleet of each package
under shuffle_coding="xor" give the same rows, with every map output's
row folded into a parity group. Counterparts of tests/test_coding.py's
16 tests.
"""

import pickle

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.shuffle import coding as ref_coding
import vega_tpu_torch as vt
from vega_tpu_torch import faults, kernels
from vega_tpu_torch.distributed.shuffle_server import (
    ShuffleServer, check_status, fetch_parity_remote, put_parity_remote)
from vega_tpu_torch.env import Configuration
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.map_output_tracker import MapOutputTracker
from vega_tpu_torch.shuffle import coding
from vega_tpu_torch.shuffle import fetcher as fetcher_mod
from vega_tpu_torch.shuffle.store import ShuffleStore


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    yield
    faults.reset()


# --- the algebra (tests/test_coding.py:39-174) ------------------------------


def test_gf256_algebra_sanity():
    for a in (1, 2, 3, 7, 91, 128, 200, 255):
        assert coding.gf_mul(a, coding.gf_inv(a)) == 1
    assert coding.gf_mul(0, 77) == 0
    with pytest.raises(ZeroDivisionError):
        coding.gf_inv(0)
    rng = np.random.RandomState(7)
    blocks = rng.randint(0, 256, size=(3, 64)).astype(np.uint8)
    coeffs = np.array([5, 1, 250], dtype=np.uint8)
    got = coding._accumulate_np(blocks, coeffs)
    want = np.zeros(64, dtype=np.uint8)
    for i in range(3):
        for j in range(64):
            want[j] ^= coding.gf_mul(int(coeffs[i]), int(blocks[i, j]))
    assert np.array_equal(got, want)
    assert np.array_equal(coding.GF_EXP, ref_coding.GF_EXP)
    assert np.array_equal(coding.GF_LOG, ref_coding.GF_LOG)


def test_parity_map_id_reserved_and_collision_free():
    seen = set()
    for gid in range(64):
        for unit in range(coding.MAX_PARITY_UNITS):
            key = coding.parity_map_id(gid, unit)
            assert key < 0 and key == ref_coding.parity_map_id(gid, unit)
            seen.add(key)
    assert len(seen) == 64 * coding.MAX_PARITY_UNITS


def test_xor_fold_decode_round_trip():
    members = {7: b"alpha-bucket", 9: b"bz", 12: b"gamma!"}
    frame = ref_frame = None
    for idx, (mid, raw) in enumerate(sorted(members.items())):
        frame = coding.fold_frame(frame, "xor", 4, 0, mid, idx, raw)
        ref_frame = ref_coding.fold_frame(ref_frame, "xor", 4, 0, mid, idx,
                                          raw)
    assert frame == ref_frame
    header, payload = coding.parse_frame(frame)
    assert header["scheme"] == "xor" and header["k"] == 4
    for lost in members:
        survivors = {m: d for m, d in members.items() if m != lost}
        out = coding.decode_group("xor", 4, [(0, header, payload)],
                                  header["members"], survivors, [lost])
        assert out == {lost: members[lost]}


def test_rs_two_losses_decode_with_two_units():
    members = {1: b"x" * 40, 3: b"yyyy", 5: b"zzzzzzzz" * 3, 8: b"w" * 17}
    frames = []
    for unit in range(2):
        fr = None
        for idx, (mid, raw) in enumerate(sorted(members.items())):
            fr = coding.fold_frame(fr, "rs", 4, unit, mid, idx, raw)
        frames.append((unit,) + coding.parse_frame(fr))
    hdr = frames[0][1]
    for lost in ((1, 5), (3, 8), (1, 8)):
        survivors = {m: d for m, d in members.items() if m not in lost}
        out = coding.decode_group("rs", 4, frames, hdr["members"],
                                  survivors, sorted(lost))
        assert out == {m: members[m] for m in lost}
    with pytest.raises(ValueError):
        coding.decode_group("rs", 4, frames, hdr["members"],
                            {8: members[8]}, [1, 3, 5])


def test_corrupt_frame_reads_as_missing_and_fold_rejects():
    frame = coding.fold_frame(None, "xor", 4, 0, 2, 0, b"payload-bytes")
    assert coding.parse_frame(frame) is not None
    flipped = bytearray(frame)
    flipped[len(flipped) // 2] ^= 0xFF
    assert coding.parse_frame(bytes(flipped)) is None
    assert coding.parse_frame(b"") is None
    assert coding.parse_frame(b"NOPE" + frame[4:]) is None
    with pytest.raises(ValueError):
        coding.fold_frame(bytes(flipped), "xor", 4, 0, 3, 1, b"more")
    with pytest.raises(ValueError):
        coding.fold_frame(frame, "xor", 4, 0, 2, 0, b"payload-bytes")
    with pytest.raises(ValueError):
        coding.fold_frame(frame, "rs", 4, 0, 3, 1, b"more")


def test_spec_from_conf_parsing():
    class C:
        def __init__(self, coding_s, k=4, m=1):
            self.shuffle_coding = coding_s
            self.coding_group_k = k
            self.coding_parity_m = m

    cases = [C("none"), C(""), C("off"), C("xor"), C("xor", k=6, m=3),
             C("rs", k=5, m=2), C("rs(6,2)"), C("RS(6, 2)"), C("rsx"),
             C("rs(a,b)"), C("lrc"), C("rs(1,99)"), C("rs(999,0)")]
    got = [coding.spec_from_conf(c) for c in cases]
    assert got == [ref_coding.spec_from_conf(c) for c in cases] == [
        None, None, None, ("xor", 4, 1), ("xor", 6, 1), ("rs", 5, 2),
        ("rs", 6, 2), ("rs", 6, 2), None, None, None, ("rs", 2, 8),
        ("rs", 128, 1)]


def test_wire_pack_round_trip_and_compression():
    rows = pickle.dumps([(i % 10, i) for i in range(500)])
    packed = coding.wire_pack(rows)
    assert coding.wire_unpack(packed) == rows
    assert packed == ref_coding.wire_pack(rows)
    assert len(packed) < len(rows)


@pytest.mark.parametrize("shape", [(4, 257), (1, 1), (6, 4096), (3, 0)])
def test_accumulate_device_path_matches_numpy_twin(shape):
    """The decode's gf256_accumulate on an explicit device (the CPU here)
    equals _accumulate_np bit for bit; with no device given it refuses
    rather than guess (the card is absent here)."""
    rng = np.random.RandomState(3)
    blocks = rng.randint(0, 256, size=shape).astype(np.uint8)
    coeffs = rng.randint(0, 256, size=shape[0]).astype(np.uint8)
    coeffs[0] = 0
    host = coding._accumulate_np(blocks, coeffs)
    dev = coding.accumulate(blocks, coeffs, "cpu")
    assert dev.dtype == np.uint8 and np.array_equal(host, dev)
    assert np.array_equal(host, ref_coding._accumulate_np(blocks, coeffs))
    with pytest.raises(VegaError):
        kernels.gf256_accumulate(blocks, coeffs, device=None)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme,k,m", [("xor", 4, 1), ("rs", 4, 2),
                                        ("rs", 6, 3)])
def test_seeded_frames_and_decodes_equal_the_references(seed, scheme, k, m):
    """Seeded buckets of uneven lengths folded unit by unit in both
    packages: equal VP01 bytes; every loss pattern up to m decodes to the
    members' bytes in both."""
    rng = np.random.default_rng(seed)
    members = {int(mid): rng.integers(0, 256, int(rng.integers(1, 300)),
                                      dtype=np.uint8).tobytes()
               for mid in rng.choice(50, size=k, replace=False)}
    frames, ref_frames = [], []
    for unit in range(m):
        fr = rf = None
        for idx, (mid, raw) in enumerate(sorted(members.items())):
            fr = coding.fold_frame(fr, scheme, k, unit, mid, idx, raw)
            rf = ref_coding.fold_frame(rf, scheme, k, unit, mid, idx, raw)
        assert fr == rf
        frames.append((unit,) + coding.parse_frame(fr))
        ref_frames.append((unit,) + ref_coding.parse_frame(rf))
    hdr = frames[0][1]
    ids = sorted(members)
    for lost in (ids[:m], ids[-m:], ids[1:1 + m]):
        survivors = {mid: members[mid] for mid in ids if mid not in lost}
        got = coding.decode_group(scheme, k, frames, hdr["members"],
                                  survivors, lost)
        want = ref_coding.decode_group(scheme, k, ref_frames,
                                       hdr["members"], survivors, lost)
        assert got == want == {mid: members[mid] for mid in lost}


# --- the store, the tracker, the server (tests/test_coding.py:176-362) -------


def test_store_fold_parity_accumulates_under_reserved_key(tmp_path):
    store = ShuffleStore(spill_dir=str(tmp_path / "spill"))
    try:
        store.fold_parity(0, group_id=2, unit=0, reduce_id=1, map_id=4,
                          idx=0, scheme="xor", k=4, raw=b"aaaa")
        store.fold_parity(0, group_id=2, unit=0, reduce_id=1, map_id=6,
                          idx=1, scheme="xor", k=4, raw=b"bbbbbb")
        blob = store.get(0, coding.parity_map_id(2, 0), 1)
        header, payload = coding.parse_frame(blob)
        assert header["members"] == {4: (0, 4), 6: (1, 6)}
        out = coding.decode_group("xor", 4, [(0, header, payload)],
                                  header["members"], {4: b"aaaa"}, [6])
        assert out == {6: b"bbbbbb"}
        status = store.status()
        assert status["parity_folds"] == 2 and status["parity_bytes"] > 0
        store.remove_shuffle(0)
        assert store.get(0, coding.parity_map_id(2, 0), 1) is None
    finally:
        store.close()


def _tracked(uris=("a:1", "b:1", "a:1")):
    t = MapOutputTracker()
    t.register_shuffle(0, len(uris))
    t.register_map_outputs(0, list(uris))
    return t


def test_tracker_parity_registry_round_trip():
    t = _tracked()
    t.register_parity(0, "b:1", 0, map_id=0, idx=0, scheme="xor", k=4, m=1)
    t.register_parity(0, "b:1", 0, map_id=2, idx=1, scheme="xor", k=4, m=1)
    t.register_parity(0, "b:1", 0, map_id=2, idx=1, scheme="xor", k=4, m=1)
    assert t.get_parity_map(0) == {("b:1", 0): {
        "scheme": "xor", "k": 4, "m": 1, "members": {0: 0, 2: 1}}}
    t.unregister_shuffle(0)
    assert t.get_parity_map(0) == {}


def test_tracker_decodable_without_and_pseudo_install():
    t = _tracked()
    t.register_parity(0, "b:1", 0, map_id=0, idx=0, scheme="xor", k=4, m=1)
    t.register_parity(0, "b:1", 0, map_id=2, idx=1, scheme="xor", k=4, m=1)
    assert t.decodable_without("a:1") == {}
    t2 = _tracked()
    t2.register_parity(0, "b:1", 0, map_id=0, idx=0, scheme="xor", k=4, m=1)
    t2.register_parity(0, "b:1", 1, map_id=2, idx=0, scheme="xor", k=4, m=1)
    assert t2.decodable_without("a:1") == {(0, 0): "coded:b:1/0",
                                           (0, 2): "coded:b:1/1"}
    assert t2.decodable_without("b:1") == {}
    gen = t2.generation
    assert t2.unregister_server_outputs("a:1") == 2
    assert t2.generation == gen + 1
    assert t2.get_server_uri_lists(0, timeout=1.0) == [
        ["coded:b:1/0"], ["b:1"], ["coded:b:1/1"]]
    assert t2.has_outputs(0)
    assert t2.coded_locations(0) == {0: "coded:b:1/0", 2: "coded:b:1/1"}


def test_tracker_losing_parity_server_strips_pseudo_locations():
    t = _tracked()
    t.register_parity(0, "b:1", 0, map_id=0, idx=0, scheme="xor", k=4, m=1)
    t.unregister_server_outputs("a:1")
    assert t._outputs[0][0] == ["coded:b:1/0"]
    t.unregister_server_outputs("b:1")
    assert t._outputs[0][0] == []
    assert t.get_parity_map(0) == {}
    assert not t.has_outputs(0)


def test_assign_parity_member_origin_exclusive_and_memoized(tmp_path):
    store = ShuffleStore(spill_dir=str(tmp_path / "s"))
    server = ShuffleServer(store)
    try:
        a = server.assign_parity_member(0, 1, "w1:1", "xor", 4, 1)
        b = server.assign_parity_member(0, 2, "w2:1", "xor", 4, 1)
        assert a == (0, 0, True) and b == (0, 1, True)
        c = server.assign_parity_member(0, 3, "w1:1", "xor", 4, 1)
        assert c[0] != a[0] and c[2]
        assert server.assign_parity_member(0, 1, "w1:1", "xor", 4, 1) == \
            (a[0], a[1], False)
        server.drop_parity_member(0, 3)
        d = server.assign_parity_member(0, 3, "w1:1", "xor", 4, 1)
        assert d[2] and d[:2] != c[:2]
        e = server.assign_parity_member(0, 9, "w3:1", "rs", 4, 2)
        assert e[0] not in (a[0], c[0], d[0])
    finally:
        server.stop()
        store.close()


def test_put_get_parity_socket_round_trip(tmp_path):
    store = ShuffleStore(spill_dir=str(tmp_path / "s"))
    server = ShuffleServer(store)
    try:
        rows = {3: [b"m3-r0" * 10, b"m3-r1"], 5: [b"m5-r0", b"m5-r1" * 7]}
        assigned = {}
        for mid, origin in ((3, "w1:1"), (5, "w2:1")):
            assigned[mid] = put_parity_remote(
                server.uri, 0, mid, origin, "xor", 4, 1,
                [coding.wire_pack(b) for b in rows[mid]])
        (g3, i3), (g5, i5) = assigned[3], assigned[5]
        assert g3 == g5 and {i3, i5} == {0, 1}
        assert store.parity_folds == 4
        for rid in range(2):
            fr = fetch_parity_remote(server.uri, 0, g3, 0, rid)
            unit, header, payload = fr
            assert unit == 0
            assert header["members"] == {3: (i3, len(rows[3][rid])),
                                         5: (i5, len(rows[5][rid]))}
            out = coding.decode_group("xor", 4, [fr], header["members"],
                                      {3: rows[3][rid]}, [5])
            assert out == {5: rows[5][rid]}
        assert fetch_parity_remote(server.uri, 0, g3, 1, 0) is None
        assert fetch_parity_remote(server.uri, 0, 99, 0, 0) is None
    finally:
        server.stop()
        store.close()


def test_parity_corrupt_fault_reads_as_missing(tmp_path):
    store = ShuffleStore(spill_dir=str(tmp_path / "s"))
    server = ShuffleServer(store)
    try:
        put_parity_remote(server.uri, 0, 1, "w1:1", "xor", 4, 1,
                          [coding.wire_pack(b"bucket-bytes")])
        stats_dir = str(tmp_path / "stats")
        faults.configure(parity_corrupt_n=1, stats_dir=stats_dir)
        assert fetch_parity_remote(server.uri, 0, 0, 0, 0) is None
        assert [s for s in faults.read_stats(stats_dir)
                if s["fault"] == "parity_corrupt"]
        fr = fetch_parity_remote(server.uri, 0, 0, 0, 0)
        out = coding.decode_group("xor", 4, [fr], fr[1]["members"], {}, [1])
        assert out == {1: b"bucket-bytes"}
    finally:
        server.stop()
        store.close()


def test_reconstruct_recovers_lost_server_buckets(tmp_path):
    """Maps 0 and 2 on server A, map 1 on B, A's rows folded on B: with A
    failed, _reconstruct decodes A's buckets bit for bit from B's parity
    and B's surviving member (on the driver's device, the CPU here); a
    dead parity server fails them instead of raising."""
    import types

    store_a = ShuffleStore(spill_dir=str(tmp_path / "a"))
    store_b = ShuffleStore(spill_dir=str(tmp_path / "b"))
    server_a = ShuffleServer(store_a)
    server_b = ShuffleServer(store_b)
    try:
        n_red = 2
        buckets = {m: [f"m{m}-r{r}".encode() * (m + 1) for r in range(n_red)]
                   for m in range(3)}
        for m in (0, 2):
            for r in range(n_red):
                store_a.put(0, m, r, buckets[m][r])
        for r in range(n_red):
            store_b.put(0, 1, r, buckets[1][r])
        tracker = MapOutputTracker()
        tracker.register_shuffle(0, 3)
        tracker.register_map_outputs(
            0, [server_a.uri, server_b.uri, server_a.uri])
        for mid, origin in ((0, server_a.uri), (2, server_a.uri),
                            (1, server_b.uri)):
            gid, idx = put_parity_remote(
                server_b.uri, 0, mid, origin, "xor", 4, 1,
                [coding.wire_pack(b) for b in buckets[mid]])
            tracker.register_parity(0, server_b.uri, gid, mid, idx,
                                    "xor", 4, 1)
        env = types.SimpleNamespace(
            conf=Configuration(), map_output_tracker=tracker,
            shuffle_server=None, shuffle_store=ShuffleStore(),
            fetch_event_sink=None, decode_device="cpu")
        failed = {server_a.uri}
        tracker.unregister_server_outputs(server_a.uri)
        lists = tracker.get_server_uri_lists(0)
        assert all(u.startswith("coded:") for u in lists[0])
        for rid in range(n_red):
            stats = {"round_trips": 0, "parity_decodes": 0,
                     "decode_bytes": 0}
            recovered, failed_now = fetcher_mod._reconstruct(
                env, tracker, lists, 0, rid, [0, 2], failed, stats)
            assert failed_now == set()
            assert {m: recovered[m] for m in range(3)} == \
                {m: buckets[m][rid] for m in range(3)}
            assert stats["parity_decodes"] == 2
            assert stats["decode_bytes"] == \
                len(buckets[0][rid]) + len(buckets[2][rid])
        # and through fetch_stream: the coded: locations are decoded
        fetcher_mod.reset_stats()
        got = list(fetcher_mod.ShuffleFetcher.fetch_stream(env, 0, 1))
        assert sorted(got) == sorted(buckets[m][1] for m in range(3))
        st = fetcher_mod.stats_snapshot()
        assert (st["coded_failovers"], st["parity_decodes"]) == (1, 2)
        recovered, failed_now = fetcher_mod._reconstruct(
            env, tracker, lists, 0, 0, [0, 2], failed | {server_b.uri},
            {"round_trips": 0, "parity_decodes": 0, "decode_bytes": 0})
        assert recovered == {} and failed_now == {0, 2}
    finally:
        server_a.stop()
        server_b.stop()
        store_a.close()
        store_b.close()


def test_bad_coding_setting_is_refused():
    for bad in ("lrc", "rs(a,b)", 3):
        with pytest.raises(VegaError, match="shuffle_coding"):
            vt.Context(device="cpu", n_shards=2, shuffle_coding=bad)


# --- jobs over a fleet of each package ---------------------------------------


@pytest.fixture(scope="module")
def fleets():
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    fleet = dict(shuffle_coding="xor", executor_max_restarts=0,
                 executor_reap_interval_s=0.5)
    ref = v.Context("distributed", num_workers=2, num_executors=3, **fleet)
    try:
        port = vt.Context(mode="distributed", device="cpu", n_shards=2,
                          num_executors=3, num_workers=2, **fleet)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_coded_jobs_give_the_references_rows(fleets, seed):
    """A named monoid, a group and a join of seeded rows under
    shuffle_coding="xor": equal rows, and every map output's row of the
    port's fleet folded into one parity group (parity_pushes)."""
    rng = np.random.default_rng(seed)
    rows = list(zip(rng.integers(0, 60, 1500).tolist(),
                    rng.integers(-1000, 1000, 1500).tolist()))
    port = fleets[1]
    before = sum(s["redundancy"]["parity_pushes"]
                 for s in port._backend.worker_stats().values())
    got = []
    for ctx in fleets:
        pairs = ctx.parallelize(rows, 6)
        got.append((
            sorted(pairs.reduce_by_key(lambda a, b: a + b, 4).collect()),
            sorted((k, sorted(vs)) for k, vs in
                   pairs.group_by_key(3).collect()),
            sorted(pairs.filter(lambda kv: kv[0] < 5)
                   .join(ctx.parallelize([(k, -k) for k in range(10)], 2))
                   .collect())))
    assert got[0] == got[1]
    after = sum(s["redundancy"]["parity_pushes"]
                for s in port._backend.worker_stats().values())
    # reduce 6, group 6, join 6 + 2 map outputs
    assert after - before == 6 + 6 + 6 + 2
    status = [check_status(info["shuffle_uri"])
              for info in port._backend.service.workers.values()]
    assert sum(s["parity_folds"] for s in status) > 0
