"""Smoke run of vega_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card: print the card's name and power limit (nvidia-smi) and build
     the CUDA kernels from vega_tpu_torch/csrc at first use;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, exactly (all three are integer functions): at the main path's
     shapes; at edge shapes (a ghost-only shard inside a batch, cap not a
     multiple of 4, an unaligned base, one bin, every row in one bin,
     out-of-range bins and digits, arbitrary starts) at 1/9/16/65/256 bins;
     at the radix shapes [8, 3145728] x 256 and x 16 bins, uniform and 90%
     skewed (768 look-back tiles per shard); partition_pos 50 times on
     one input, every result equal. Then each one's time (20 launches per
     event pair replayed from a CUDA graph, L2 flushed before each of 5
     runs: median, min, max), bound, plain version's time and yardstick
     call, at the main path's shapes and at the radix shapes;
  3. main path: Context(n_shards=8) on the card runs the bench pipeline
     dense_range(N).map(lambda x: (x % K, x * 0.5)).reduce_by_key(op="add")
     .join(K-row table).count() at N = 20,000,000 rows and K = 1,000,000
     keys; the result must equal a plain numpy reference, and every
     kernel's launch count must have grown during that run; the reduce's
     exchange, planned under dense_exchange="auto", must be all_to_all.
     Then the warm rows/s, median of 3 runs, and the launches of one warm
     run. The
     Context's 'auto' plans must have resolved to xla / fused_sort / off,
     and each warm join's block must carry a pending settlement before
     count() (its fetches deferred) and none after;
  4. plans: the same pipeline at 8 shards in a fresh Context under each of
     dense_sort_impl="radix", "radix4", "packed", dense_rbk_plan=
     "sort_partition" with "radix", and dense_table_plan="on": the cold run
     equals numpy, three warm runs give a median rows/s, and every kernel
     launches in the cold and in a warm run. On the radix plans one warm
     run's digit_hist and partition_pos launches exceed the default plan's
     by at least the radix passes of the plan's sorts (radix_passes). The
     table plan's warm run must take the table, and a run with a poisoned
     key-range hint must be repaired and equal numpy;
  5. keyed: BASELINE configs 1, 4 and 5 (benchmarks/suite.py's
     generators), each in a fresh Context(n_shards=8): config 1
     group_by_key().collect_grouped() over 10M (int64 key beyond int32,
     float64 value) pairs with 250,000 keys; config 4 cogroup of two
     50M-row int32-keyed sides (count() and collect_grouped()) and the
     cartesian product of two 10,000-row sides (count()); config 5
     sort_by_key().take(10) and take_ordered(10) over 125M pairs with
     int64 keys uniform in [-2^45, 2^45). A cold run equals numpy, three
     warm runs give a median rows/s (the host build of the sources and
     each step timed apart), and the cold and first warm run must launch
     digit_hist and partition_pos (config 4 hash_bucket too); the peak
     device memory is reported;
  6. named, narrow, set and action ops: (a) BASELINE config 3, the word
     count dense_from_columns({"word_id": ids}, key="word_id")
     .count_by_key_dense().collect() over 100M ids with 2.5M distinct
     (suite.py's generator), as phase 5 runs a config: the collected dict
     equals np.bincount exactly, and hash_bucket and digit_hist launch
     (the fused_sort reduce's exchange is pregrouped, so partition_pos is
     not on this path); (b) at the main path's size (N = 20M, K = 1M),
     each new op once cold (launches counted from 0, result against
     numpy: integers exactly, float sums within stated tolerances, min /
     max and histogram bins exactly) and three warm runs (median ms,
     rows/s): map + filter + map_values, the
     traced reduce_by_key(xor) (it must take the segmented scan),
     left_outer_join, distinct / intersection / subtract, union / zip /
     zip_with_index, sum / mean / min / max / stats / histogram(10) and
     reduce(xor); every kernel launches in them;
  7. row functions, wide int64 columns, expansions and sample, in one
     Context, each line timed as 6(b)'s (cold with launches counted from
     0, then three warm runs): (a) config 3's ids the Spark way,
     map(lambda w: (w, 1)).reduce_by_key(op="add").collect() and the same
     with reduce_by_key(lambda a, b: a + b) (which must take the named
     add), both equal to np.bincount; (b) int64 values 2^33 + (i * 7919)
     mod 10^6 under keys i mod K at N = 20M: reduce_by_key add / min / max
     exact against numpy, the sums joined to phase 3's table,
     values_dense().sum() / min() / max(), and 1,000 rows of 2^62 under one
     key (the reduce raises "int64 range", the keyless sum is the exact
     bignum; the port has no host fold); (c) config 1's int64 keys:
     reduce_by_key(op="add") (float sums within rtol 1e-5), its join
     against a 250,000-row table of the same keys, and a left_outer_join
     of a mixed-width side (half the keys beyond int32) against an int32
     table, which widens; (d) map_expand (factor 4) and the digit
     flat_map_ragged (max_out 8) of dense_range(N), each reduced and
     exact; (e) sample(False, 0.01, seed=7) of dense_range(N) equal row
     for row to the port's CPU run, its count within 6 sigma, and
     threefry / fold_in / uniform equal to jax's known answers; (f) the
     queue-3 inputs (constant outputs, 100 // x, bool columns, NaN keys
     through reduce / group / join / sort) exact at their small sizes.
     (a), (b) and (d) must launch hash_bucket and digit_hist, the joins
     partition_pos too; wide keys (c) hash in torch ops;
  8. streamed sources, npz checkpoints and the block lifetime, in a fresh
     Context(n_shards=8, dense_exchange="all_to_all") at the default 4 GiB
     budget (the legacy chunking; 9b runs (a) under the planner): (a)
     BASELINE's north
     star with no cut (benchmarks/stream_1b.py): dense_range(1e9) must be
     a StreamedDenseRDD of 6 chunks of 178,257,920 rows, and
     .map(lambda x: (x % K, x)).reduce_by_key(op="add").join(K-row table
     of 2k).count() == K = 1e6, every joined row exact ((1000k +
     499,500,000,000) mod 2^32 as int32, and 2k), cold once and 3 warm
     runs (rows/s = N / wall), each chunk's fold ms, the launches of each
     run (all three kernels), peak memory beside the budget; (b)
     take_ordered(10) / top(10) of the stream, exact; (c) the streamed
     join .map((x % K, x)).join(table).count() == N, the table re-placed
     once per run (by the partition_pos launches), the first chunk's
     joined rows exact as columns on the card; (d) save_npz /
     dense_load_npz of (a)'s reduced block (resident and 8 chunks) and of
     config 1's 10M pairs (4 chunks; the streamed reduce equals the
     resident one), under chiprun_out/, removed after; (e) bench-main at
     a 256 MiB budget: streamed and resident with a held block evicted
     and rematerialized equal, numpy-checked, dense_hbm_in_use() bounded
     after each materialization, unpersist() releasing its bytes (the
     source streams in 3 chunks under the planner); (f) range_bucket of
     float32 subnormals on the card equal to the CPU's;
  9. the exchange planner's programs and string columns: (a) at
     bench-main's 20M int32 pairs over 1M keys with dense_table_plan="off",
     group_by_key().count() (every row crosses) and reduce_by_key(op="add")
     .join(1M-row table).count(), each under forced all_to_all, forced
     staged (at a budget half way between the all_to_all and ring legs'
     estimates of the largest launch, so the planner's staged search takes
     a group of 2 or more) and forced ring: each planned exchange measured
     (the allocator's peak over the call above what was allocated at its
     start), the step's peak, the plan, warm ms (median of 3, ended by a
     synchronize); every leg equal to the all_to_all leg and to numpy, and
     the measured exchange peaks ordered all_to_all > staged >= ring,
     printed beside the model's 8 x est_peak_bytes; (b) stream-1b under
     dense_exchange="auto": dense_range(1e9) in the planner's 5 chunks of
     221,249,536 rows, the pipeline and checks of 8a, beside 8a's 6 chunks;
     (c) benchmarks/strings_ab.py's query: 10M rows of sku-%06d keys over
     100,000 words reduced, joined with a 100,000-row dims table (half its
     words shared: a merged dictionary of 150,000 words, past the default
     65,536-entry remap table, so each side retries once), sorted and
     collected, the host encode and each device step timed apart, exact
     against numpy; (d) the reduced string block through save_npz /
     dense_load_npz in 4 chunks, exact;
 10. the frame layer (vega_tpu_torch/frame): (a) benchmarks/frame_ab.py's
     query at 20M events rows (6 int64 columns, k uniform over 1M keys)
     and a 1M-row dims table, filter(x < 600) -> group_by(k).agg(sum) ->
     join(dims.group_by(k).agg(sum)) -> sort(k) -> collect_columns(), as
     the hand-written DenseRDD chain, the frame under hint(fuse=False,
     pushdown=False) and the fused frame: a cold run of each (all three
     bit-identical and equal to numpy; the fused leg must launch
     hash_bucket and digit_hist), then three interleaved warm rounds (ms,
     rows/s, the host build apart, the step peak, launches); (b) the
     mixed aggregates sum / min / max / count / mean on (a)'s events (the
     traced tuple combiner; integers exact, the mean within rtol 1e-5);
     (c) 2M rows of sku-%06d string keys grouped and joined to a
     100,000-row dims frame on the key, exact, the host encode apart;
     (d) an untraceable UDF raising VegaError at explain() before any
     device work. All on create_frame: the card's machine has no pyarrow,
     so the parquet scan is held against the reference on the CPU only;
 11. persist(level), the GF(256) decode and the streaming fold: (a)
     bench-main's reduce persist("MEMORY_AND_DISK") at K = 1M and K = 20M
     (every row its own key, a [8, 3145728] block): demoted under a zero
     budget (spill ms, snapshot bytes), promoted 3 times with
     _materialize poisoned (promote ms to a synchronize; no kernel
     launched; equal to numpy), hash-placed, a downstream reduce eliding
     its exchange with no launch, the join with phase 3's table equal to
     numpy, one flipped byte in the snapshot read as a miss and
     recomputed (disk_read_errors 1), unpersist removing the file and
     stop() the session directory, then the warm recompute ms; (b)
     kernels.gf256_accumulate at [4, 67108864] and [128, 1048576] under
     the XOR, RS Cauchy and masked coefficients, bit-identical to a numpy
     twin, a seeded small input's digest equal to the reference's, median
     ms beside the bound and the peak; (c) state_fold.fold_pairs_device
     on 1M Python (int, int) pairs over 100,000 keys, add / min / max /
     prod exact against a dict fold with Python ints, the host build
     apart, a kernel launched per op, and a total beyond int64 None;
 12. narrow and uint32 columns, the host API's device forms and
     ctx.profiler, each line a cold run checked against numpy and three
     warm runs (host build of the sources from numpy apart), the cold
     run's launches and peak: (a) network-flow rollups at N = 20M rows:
     uint16 ports (65,536 keys) with int32 bytes reduced and joined to a
     65,536-row uint16 table, sorted (take(10)); int8 flags
     count_by_value() over 256 values; int8 values whose per-key sums
     wrap (numpy's int8 wrap); float16 readings over 1M int32 keys (rtol
     2e-3 of numpy's float16 sums); the uint16 reduce+join must launch
     all three kernels; (b) 20M rows over 1M uint32 IPv4 addresses, half
     >= 2^31: reduce+join to the address table (all three kernels),
     sort_by_key().take(10) both ways in unsigned order, a uint32 value
     column reduced (add wraps mod 2^32) and its exact sum(); each value
     reduce of (a) and (b) also timed with count() alone; (c) on
     bench-main's reduce: first, is_empty, keys().count(), values().sum(),
     count_by_key of the 20M pairs, collect_as_map, lookup x3 and a
     right_outer_join with a 1M-row table half missing (None exactly
     where numpy says), each exact and timed warm; (d) one warm bench-main
     run inside ctx.profiler(), twice: counts equal to an unprofiled
     run's, the first trace naming hash_bucket_kernel,
     digit_hist_*_kernel and partition_pos_kernel, its five longest
     device ops and device busy share, profiled beside unprofiled ms,
     the profiler's start / stop / write ms of each session, and a third
     session over the int8 value reduce with its collect: its ms, device
     busy ms over its span and its eight longest device ops (the traces
     under chiprun_out/phase12_trace, removed after); (e) a named bool
     add raising VegaError, tuple keys folding to
     None, a 2-D key raising VegaError (not KernelError). Prints phase
     12's wall time.
Prints the radix-shape rows, the main path's rows/s, each plan's line,
each keyed config's line, config 3's line, one line per new op, one line
per phase-7 line and phase 7's summary, one line per phase-8 item, one
line per phase-9 leg and item, one line per phase-10 leg and item, one
line per phase-11 size, gf256 row and fold op, one line per phase-12
item, the kernel table as one JSON line (with phases 6-12's launches
beside the main path's), the card line,
and last {"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.

Exits non-zero without a result when no CUDA card is visible.

    python3 chip_smoke.py --main-path-ab DIR_A DIR_B DIR_B DIR_A

runs only phase 3, of each checkout DIR in turns (its own chip_smoke.py
and package, a process each): the main path of two trees in one call.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

N_ROWS = 20_000_000
N_KEYS = 1_000_000
N_SHARDS = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit peak
L2_FLUSH_BYTES = 64 << 20      # written before each timed run (L2: 50 MB)
LAUNCHES_PER_RUN = 20          # back-to-back calls between two events
RUNS = 5                       # timed runs per kernel: median, min, max
REPEATS = 50                   # partition_pos launches on one input
C1_ROWS, C1_KEYS = 10_000_000, 250_000   # phase 5, config 1
C4_ROWS, C4_CART = 50_000_000, 10_000    # config 4: each side; m
C5_ROWS = 125_000_000                    # config 5
C3_ROWS = 100_000_000                    # phase 6, config 3
# phase 4: (label, Context settings); the default plan is phase 3's
PLANS = [
    ("radix", dict(dense_sort_impl="radix")),
    ("radix4", dict(dense_sort_impl="radix4")),
    ("packed", dict(dense_sort_impl="packed")),
    ("sort_partition+radix", dict(dense_rbk_plan="sort_partition",
                                  dense_sort_impl="radix")),
    ("table", dict(dense_table_plan="on")),
]
SOURCE = "vega_tpu_torch/csrc/shuffle_kernels.cu"
REPLACES = {
    "hash_bucket": "vega_tpu/tpu/pallas_kernels.py:42",
    "digit_hist": "vega_tpu/tpu/pallas_kernels.py:182",
    "partition_pos": "vega_tpu/tpu/pallas_kernels.py:128",
}


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=False)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


_FLUSH = []  # the 64 MB tensor written before each timed run


def time_ms(torch, fns, graph=True, launches=LAUNCHES_PER_RUN, runs=RUNS):
    """One call's time on the card: `launches` back-to-back calls (cycling
    over fns, e.g. over copies of an input that together exceed L2) between
    two CUDA events, divided by `launches`; the median, min and max over
    `runs` such runs. Before each run a 64 MB tensor is written, which
    flushes the card's 50 MB L2. With graph, the calls are captured once in
    a CUDA graph and replayed, so the host's per-call cost (tens of
    microseconds through ctypes) does not pace the card; plain versions and
    library calls, which may synchronise, are called eagerly."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    for fn in fns:  # warm-up, outside any capture
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(launches):
                fns[i % len(fns)]()
        torch.cuda.synchronize()

        def run():
            g.replay()
    else:
        def run():
            for i in range(launches):
                fns[i % len(fns)]()
    times = []
    for r in range(runs):
        _FLUSH[0].fill_(r)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return dict(ms=statistics.median(times), ms_min=min(times),
                ms_max=max(times))


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_equal(torch, name, got, exp):
    torch.cuda.synchronize()
    if got.shape != exp.shape or not torch.equal(got, exp):
        diff = (got.to(torch.int64) - exp.to(torch.int64)).abs()
        fail(f"{name}: kernel disagrees with its plain version at "
             f"{int((diff != 0).sum())} places (max |diff| "
             f"{int(diff.max())})")
    log(f"{name}: equal to the plain version, shape {tuple(got.shape)}")


def starts_of(torch, ck, b, nb):
    """Exclusive prefix of the per-shard bin counts: a permutation's
    starts."""
    h = ck.digit_hist_plain(b, nb)
    return (torch.cumsum(h, 1, dtype=torch.int32) - h).contiguous()


def hist_bytes(rows, n, nb):
    """digit_hist: each digit read once, the [n, nb] counts written once."""
    return 4 * rows + 4 * n * nb


def pos_bytes(n, cap, nb):
    """partition_pos: each bucket read and each position written once, the
    starts read once. The kernel's look-back scratch is not the function's
    and is reported beside the bound (scratch_bytes), not in it."""
    return 8 * n * cap + 4 * n * nb


def pos_scratch_bytes(ck, n, cap, nb):
    """The look-back's status words and ticket, each zeroed, written and
    read once."""
    return 12 * ck.partition_pos_scratch_words(n, cap, nb)


def edge_inputs(torch, gen, dev, nb):
    """(label, [N_SHARDS, cap] int32) edge cases for a kernel at nb bins."""
    n = N_SHARDS
    i32 = torch.int32

    def rand_bins(cap):
        return torch.randint(0, nb, (n, cap), generator=gen, device=dev,
                             dtype=i32)

    cases = []
    b = rand_bins(3 * 4096 + 5)
    b[3] = nb - 1  # a shard of length 0: every row a ghost
    cases.append(("empty shard in batch", b))
    cases.append(("cap % 4 == 3", rand_bins(2 * 4097 + 3)))
    flat = torch.randint(0, nb, (n * 8192 + 1,), generator=gen, device=dev,
                         dtype=i32)
    unaligned = flat[1:].view(n, 8192)  # contiguous, 4 B past a boundary
    if unaligned.data_ptr() % 16 == 0 or not unaligned.is_contiguous():
        fail("the unaligned-base case is not unaligned")
    cases.append(("unaligned base", unaligned))
    cases.append(("every row in one bin",
                  torch.full((n, 20000), nb // 2, device=dev, dtype=i32)))
    b = rand_bins(50001)
    bad = torch.rand((n, 50001), generator=gen, device=dev) < 0.1
    outside = torch.tensor([-1, nb, -2**31], device=dev, dtype=i32)
    pick = torch.randint(0, 3, (n, 50001), generator=gen, device=dev)
    cases.append(("out-of-range bins", torch.where(bad, outside[pick], b)))
    return cases


def check_kernels(torch, ck, inp):
    """Every kernel against its plain version on the card: the main path's
    shapes, edge shapes and the radix shape; exact, as all three are
    integer functions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n = N_SHARDS
    i32 = torch.int32

    def rand_keys(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(i32)

    # hash_bucket: main keys, random keys with edge values, ragged lengths
    edge = torch.tensor([0, -1, -2**31, 2**31 - 1], dtype=i32, device=dev)
    for nb in (n, 9, 65, 1):
        keys = rand_keys((n, 1_000_003))
        keys[0, :4] = edge
        check_equal(
            torch, f"hash_bucket n={nb} cap=1000003",
            ck.hash_bucket(keys, nb), ck.hash_bucket_plain(keys, nb))
    check_equal(
        torch, "hash_bucket main", ck.hash_bucket(inp["main_keys"], n),
        ck.hash_bucket_plain(inp["main_keys"], n))
    flat = rand_keys((3 * 4096 + 1,))
    sliced = flat[1:].view(3, 4096)  # unaligned base: the scalar path
    check_equal(torch, "hash_bucket cap=4096 unaligned base",
                ck.hash_bucket(sliced, n), ck.hash_bucket_plain(sliced, n))

    # the main path's shapes
    check_equal(
        torch, "digit_hist main",
        ck.digit_hist(inp["main_bucket"], n + 1),
        ck.digit_hist_plain(inp["main_bucket"], n + 1))
    check_equal(
        torch, "partition_pos main",
        ck.partition_pos(inp["join_bucket"], n + 1, inp["join_starts"]),
        ck.partition_pos_plain(inp["join_bucket"], n + 1, inp["join_starts"]))

    # edge shapes at 1/9/16/65/256 bins
    for nb in (1, 9, 16, 65, 256):
        for label, b in edge_inputs(torch, gen, dev, nb):
            check_equal(torch, f"digit_hist {label} bins={nb}",
                        ck.digit_hist(b, nb), ck.digit_hist_plain(b, nb))
            st = starts_of(torch, ck, b, nb)
            check_equal(torch, f"partition_pos {label} bins={nb}",
                        ck.partition_pos(b, nb, st),
                        ck.partition_pos_plain(b, nb, st))
        b = torch.randint(0, nb, (n, 1_000_003), generator=gen, device=dev,
                          dtype=i32)
        st = torch.randint(-1000, 1000, (n, nb), generator=gen, device=dev,
                           dtype=i32)
        check_equal(torch, f"partition_pos arbitrary starts bins={nb}",
                    ck.partition_pos(b, nb, st),
                    ck.partition_pos_plain(b, nb, st))
        check_equal(torch, f"digit_hist cap=1000003 bins={nb}",
                    ck.digit_hist(b, nb), ck.digit_hist_plain(b, nb))

    # the radix shape: [8, main_cap] at 256 bins, uniform and skewed, and
    # partition_pos at 9 bins; many tiles per shard
    tiles = ck.partition_pos_scratch_words(1, inp["main_cap"], 1) - 1
    if tiles < 700:
        fail(f"the radix shape has only {tiles} look-back tiles per shard")
    for prefix, nb in (("radix", 256), ("radix16", 16)):
        for label in ("uniform", "skewed"):
            d, st = inp[f"{prefix}_{label}"], inp[f"{prefix}_{label}_starts"]
            check_equal(torch, f"digit_hist radix {label} bins={nb}",
                        ck.digit_hist(d, nb), ck.digit_hist_plain(d, nb))
            check_equal(torch, f"partition_pos radix {label} bins={nb} "
                        f"({tiles} tiles per shard)",
                        ck.partition_pos(d, nb, st),
                        ck.partition_pos_plain(d, nb, st))
    check_equal(torch, "partition_pos main-cap bins=9",
                ck.partition_pos(inp["main_bucket"], n + 1,
                                 inp["main_starts"]),
                ck.partition_pos_plain(inp["main_bucket"], n + 1,
                                       inp["main_starts"]))

    # repeats: an ordering race in the look-back would show as a result
    # that differs from run to run
    for label, b, nb, st in (
            ("radix skewed", inp["radix_skewed"], 256,
             inp["radix_skewed_starts"]),
            ("main", inp["join_bucket"], n + 1, inp["join_starts"])):
        exp = ck.partition_pos_plain(b, nb, st)
        for rep in range(REPEATS):
            if not torch.equal(ck.partition_pos(b, nb, st), exp):
                fail(f"partition_pos {label}: launch {rep + 1} of "
                     f"{REPEATS} differs from the plain version")
        log(f"partition_pos {label}: {REPEATS} launches all equal")


def make_inputs(torch, ck, main_cap, join_cap):
    """The kernels' inputs at the main path's shapes and the radix shape."""
    from vega_tpu_torch import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_SHARDS
    i32 = torch.int32
    inp = dict(main_cap=main_cap, join_cap=join_cap)
    # the map's keys over [8, cap] for the reduce, bucketed and ghosted
    per = math.ceil(N_ROWS / n)
    x = (torch.arange(n, device=dev)[:, None] * per
         + torch.arange(main_cap, device=dev)[None, :])
    inp["main_keys"] = (x % N_KEYS).to(i32).contiguous()
    counts = torch.full((n,), per, device=dev, dtype=i32)
    counts[-1] = N_ROWS - per * (n - 1)
    mask = kernels.valid_mask(main_cap, counts)
    inp["main_bucket"] = torch.where(
        mask, ck.hash_bucket_plain(inp["main_keys"], n), n).to(i32)
    inp["main_starts"] = starts_of(torch, ck, inp["main_bucket"], n + 1)
    # the K-row table's keys for the join side's counting partition
    tper = math.ceil(N_KEYS / n)
    tkeys = (torch.arange(n, device=dev)[:, None] * tper
             + torch.arange(join_cap, device=dev)[None, :]).to(i32)
    tcounts = torch.full((n,), tper, device=dev, dtype=i32)
    tcounts[-1] = N_KEYS - tper * (n - 1)
    tmask = kernels.valid_mask(join_cap, tcounts)
    inp["join_bucket"] = torch.where(
        tmask, ck.hash_bucket_plain(tkeys, n), n).to(i32).contiguous()
    inp["join_starts"] = starts_of(torch, ck, inp["join_bucket"], n + 1)
    # one radix pass's digits over the main capacity, 8-bit (radix) and
    # 4-bit (radix4): uniform, and 90% of rows in one bin
    skew = torch.rand((n, main_cap), generator=gen, device=dev) < 0.9
    for prefix, nb in (("radix", 256), ("radix16", 16)):
        d = torch.randint(0, nb, (n, main_cap), generator=gen, device=dev,
                          dtype=i32)
        inp[f"{prefix}_uniform"] = d
        inp[f"{prefix}_skewed"] = torch.where(skew, nb // 3, d).to(i32)
        for label in ("uniform", "skewed"):
            inp[f"{prefix}_{label}_starts"] = starts_of(
                torch, ck, inp[f"{prefix}_{label}"], nb)
    return inp


def flat_bins(torch, b, nb):
    """bincount's input: shard s's bin v as s * nb + v."""
    return (b.to(torch.int64) + torch.arange(
        b.shape[0], device=b.device)[:, None] * nb).reshape(-1)


def argsort_pos(torch, b, ar):
    """vega_tpu's _xla_argsort_pos formulation: a stable sort and one
    scatter_ (two PyTorch calls) give each row's place in bin order."""
    order = torch.sort(b, dim=1, stable=True).indices
    out = torch.empty_like(order)
    out.scatter_(1, order, ar)
    return out


def time_kernels(torch, ck, inp):
    """Times, bounds, plain versions and yardsticks: the main path's
    shapes (the kernel line's rows) and the radix shape."""
    n = N_SHARDS
    main_cap, join_cap = inp["main_cap"], inp["join_cap"]
    rows_main, rows_join = n * main_cap, n * join_cap
    table, radix = [], []

    def row(name, shape, n_bins, t_kernel, t_plain, t_bound, library,
            **extra):
        return dict(name=name, shape=shape, n_bins=n_bins,
                    ms=t_kernel["ms"], ms_min=t_kernel["ms_min"],
                    ms_max=t_kernel["ms_max"], plain_ms=t_plain["ms"],
                    bound_ms=t_bound[0], bound_by=t_bound[1],
                    bound_share=t_bound[0] / t_kernel["ms"],
                    library_ms=library, max_abs_err=0.0, **extra)

    keys = inp["main_keys"]
    table.append(row(
        "hash_bucket", [n, main_cap], None,
        time_ms(torch, lambda: ck.hash_bucket(keys, n)),
        time_ms(torch, lambda: ck.hash_bucket_plain(keys, n), graph=False),
        bound(8 * rows_main, 10 * rows_main), None,
        l2="input 100 MB, larger than L2"))

    def hist_row(label, b, nb, into):
        flat = flat_bins(torch, b, nb)
        lib = time_ms(torch, lambda: torch.bincount(flat, minlength=n * nb),
                      graph=False)
        into.append(row(
            "digit_hist", list(b.shape), nb,
            time_ms(torch, lambda: ck.digit_hist(b, nb)),
            time_ms(torch, lambda: ck.digit_hist_plain(b, nb), graph=False),
            bound(hist_bytes(b.numel(), n, nb), 2 * b.numel()),
            lib["ms"], input=label, library_call="torch.bincount",
            l2="input 100 MB, larger than L2"))

    def pos_row(label, b, nb, st, into, l2, copies=1):
        cap = b.shape[1]
        ar = torch.arange(cap, device=b.device).expand(n, cap).contiguous()
        yard = time_ms(torch, lambda: argsort_pos(torch, b, ar), graph=False)
        bs = [b] + [b.clone() for _ in range(copies - 1)]
        into.append(row(
            "partition_pos", list(b.shape), nb,
            time_ms(torch, [lambda bb=bb: ck.partition_pos(bb, nb, st)
                            for bb in bs]),
            time_ms(torch, lambda: ck.partition_pos_plain(b, nb, st),
                    graph=False),
            bound(pos_bytes(n, cap, nb), 4 * b.numel()), None,
            input=label, l2=l2, launches_per_call=1,
            scratch_bytes=pos_scratch_bytes(ck, n, cap, nb),
            argsort_scatter_ms=yard["ms"],
            argsort_scatter="torch.sort(stable) + scatter_: two calls"))

    hist_row("main path: ghosted buckets", inp["main_bucket"], n + 1, table)
    pos_row("main path: join side's ghosted buckets", inp["join_bucket"],
            n + 1, inp["join_starts"], table,
            "warm: the 4 MB input stays in L2 across the run, as on the "
            "main path, where it was just written")
    # the join shape again with 16 copies of its input (64 MB): cold
    pos_row("main path: join side, cold", inp["join_bucket"], n + 1,
            inp["join_starts"], radix,
            "cold: 16 copies of the input, 64 MB, cycled", copies=16)
    pos_row("main-cap ghosted buckets", inp["main_bucket"], n + 1,
            inp["main_starts"], radix, "input 100 MB, larger than L2")
    for prefix, nb in (("radix", 256), ("radix16", 16)):
        for label in ("uniform", "skewed"):
            d = inp[f"{prefix}_{label}"]
            hist_row(f"radix {label}", d, nb, radix)
            pos_row(f"radix {label}", d, nb, inp[f"{prefix}_{label}_starts"],
                    radix, "input 100 MB, larger than L2")
    for r in table + radix:
        log(f"{r['name']} {r['shape']} bins={r['n_bins']} "
            f"{r.get('input', '')}: {r['ms']:.4f} ms "
            f"({r['ms_min']:.4f}-{r['ms_max']:.4f}), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({100 * r['bound_share']:.0f}%), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, "
            f"argsort+scatter {r.get('argsort_scatter_ms')}")
    return table, radix


def pipeline(ctx, np):
    kv = ctx.dense_range(N_ROWS).map(lambda x: (x % N_KEYS, x * 0.5))
    reduced = kv.reduce_by_key(op="add")
    table = ctx.dense_from_numpy(np.arange(N_KEYS, dtype=np.int32),
                                 np.arange(N_KEYS, dtype=np.float32) * 2.0)
    return reduced.join(table)


def check_numpy(np, joined, what):
    """The joined rows against numpy: every key once, sums within rtol
    1e-5 of the float64 reference, table values exact. Returns the max
    relative error of the sums and the host arrays made for the check."""
    got = joined.collect_arrays()
    x = np.arange(N_ROWS, dtype=np.int64)
    sums = np.bincount(x % N_KEYS, weights=x * 0.5, minlength=N_KEYS)
    order = np.argsort(got["k"], kind="stable")
    if not np.array_equal(got["k"][order], np.arange(N_KEYS)):
        fail(f"{what}: joined keys differ from the numpy reference")
    lv = got["lv"][order].astype(np.float64)
    rel = np.abs(lv - sums) / np.maximum(np.abs(sums), 1e-30)
    if not np.allclose(lv, sums, rtol=1e-5, atol=0):
        fail(f"{what}: reduced sums differ from numpy: max rel err "
             f"{rel.max():.3g}")
    if not np.array_equal(got["rv"][order], np.arange(N_KEYS) * 2.0):
        fail(f"{what}: table values differ from the numpy reference")
    log(f"{what} matches numpy: max rel err of sums {rel.max():.3g}")
    return float(rel.max()), (got, x, sums, order, lv, rel)


def check_launched(launches, what):
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched in {what}")


def run_plan(torch, np, ck, vt, label, settings):
    """One Context under `settings`: the cold run (launches counted from
    0, result against numpy), then three timed warm runs (rows/s; launches
    of the first counted from 0), then one untimed warm run whose join must
    carry a pending settlement before count() and none after (and, under
    the table plan, must take the table and equal numpy). Each timed run
    reports its host-side build apart from its count(), which is also timed
    on CUDA events. Under the table plan one more run with a poisoned (too
    small) key-range hint must be repaired and equal numpy."""
    ctx = vt.Context(n_shards=N_SHARDS, **settings)
    if ctx.device.type != "cuda":
        fail(f"Context() chose {ctx.device}, not the card")
    plans = dict(dense_sort_impl=ctx.dense_sort_impl,
                 dense_rbk_plan=ctx.dense_rbk_plan,
                 dense_table_plan=ctx.dense_table_plan)
    ck.reset_launches()
    t0 = time.perf_counter()
    joined = pipeline(ctx, np)
    count = joined.count()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log(f"{label} (cold): count={count} in {cold_s:.3f} s, launches "
        f"{launches}, plans {plans}")
    if count != N_KEYS:
        fail(f"{label}: count() = {count}, expected {N_KEYS}")
    check_launched(launches, f"the {label} cold run")
    # the cold run's lineage and the check's host arrays stay alive until
    # the Context stops, as phase 3 always kept them: freed before the
    # warm runs, they let glibc hand a warm run's host build (the K-row
    # table's arrays) fresh pages, whose first touch slows that build by
    # 7-15 ms a run (scripts/warm_split.py, PERF.md)
    rel, cold_arrays = check_numpy(np, joined, f"{label} (cold)")
    cold = joined
    plan = joined.left._exchange_plan  # the reduce's exchange
    exchange = None if plan is None else dict(
        program=plan.program, group=plan.group, rounds=plan.rounds,
        est_peak_bytes=plan.est_peak_bytes, fits=plan.fits,
        budget_bytes=plan.budget_bytes)
    warm, build_ms, count_ms, count_dev_ms = [], [], [], []
    ck.reset_launches()
    for i in range(3):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        joined = pipeline(ctx, np)
        t1 = time.perf_counter()
        ev0.record()
        c = joined.count()
        ev1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del joined
        warm.append(t2 - t0)
        # the host-side build of the lineage and its K-row table, and
        # count() on the host clock and between events on the stream
        build_ms.append((t1 - t0) * 1e3)
        count_ms.append((t2 - t1) * 1e3)
        count_dev_ms.append(ev0.elapsed_time(ev1))
        if i == 0:
            warm_launches = dict(ck.LAUNCHES)
            check_launched(warm_launches, f"the {label} warm run")
        if c != N_KEYS:
            fail(f"{label}: warm run count() = {c}")
    joined = pipeline(ctx, np)
    blk = joined.block_spec()
    deferred = blk.settle is not None
    if joined.count() != N_KEYS or not deferred or blk.settle is not None:
        fail(f"{label}: warm join's block had pending settlement {deferred} "
             f"before count() and {blk.settle is not None} after; expected "
             "True, then False")
    table_taken = joined.left._table_plan
    if plans["dense_table_plan"] == "on":
        if not table_taken:
            fail(f"{label}: the warm run did not take the table plan")
        rel = max(rel, check_numpy(np, joined, f"{label} (warm)")[0])
    del joined, blk
    med = statistics.median(warm)
    res = dict(label=label, settings=settings, plans=plans, count=count,
               cold_s=cold_s, warm_s=warm, median_s=med,
               warm_build_ms=build_ms, warm_count_ms=count_ms,
               warm_count_device_ms=count_dev_ms,
               rows_per_s=N_ROWS / med, max_rel_err=rel, launches=launches,
               warm_launches=warm_launches, warm_deferred=True,
               table_taken=table_taken, exchange=exchange)
    log(f"{label} warm: {warm} s, median {med:.4f} s, "
        f"{N_ROWS / med:,.0f} rows/s; host build {build_ms} ms, count() "
        f"{count_ms} ms on the host, {count_dev_ms} ms on the stream; "
        "launches of one warm run "
        f"{warm_launches}; each warm join deferred its fetches to count()")
    if plans["dense_table_plan"] == "on":
        joined = pipeline(ctx, np)
        reduced = joined.left
        ctx._key_range_hints[reduced._hint_key()] = (0, 99)  # too small
        t0 = time.perf_counter()
        joined.block_spec()
        if not reduced._table_plan:
            fail(f"{label}: the poisoned run did not launch the table plan")
        c = joined.count()
        torch.cuda.synchronize()
        # settlement saw the range flag and rebuilt the reduce through the
        # standard plan, in place
        if reduced._table_plan:
            fail(f"{label}: the poisoned table launch was not repaired")
        if c != N_KEYS:
            fail(f"{label}: poisoned run count() = {c}")
        res["poisoned"] = dict(
            s=time.perf_counter() - t0, table_launched=True, repaired=True,
            max_rel_err=check_numpy(
                np, joined, f"{label} (poisoned range, repaired)")[0])
    ctx.stop()
    del cold, cold_arrays
    return res


def phase_main_path(torch, np, ck, vt):
    res = run_plan(torch, np, ck, vt, "main path", {})
    if res["plans"] != dict(dense_sort_impl="xla", dense_rbk_plan="fused_sort",
                            dense_table_plan="off"):
        fail(f"'auto' resolved to {res['plans']} on the card, expected "
             "xla / fused_sort / off")
    # dense_exchange="auto" at the default budget plans the one-shot
    if (res["exchange"] or {}).get("program") != "all_to_all":
        fail(f"the main path's exchange planned {res['exchange']}, "
             "expected all_to_all")
    log(f"main path exchange plan: {res['exchange']}")
    return res


def radix_passes(settings):
    """Digit passes of one warm run's radix sorts, from the sorts the code
    runs: fused_sort sorts (bucket, key) with a 32-bit key word and the
    8-bit bucket word; sort_partition sorts the key alone; then both sort
    the reduce side's keys (32 bits) and the join's right side (32 bits;
    the left side, a reduce output, is elided and already sorted). Each
    word of w bits takes ceil(w / bits) passes, and each pass launches
    digit_hist and partition_pos once."""
    impl = settings.get("dense_sort_impl")
    if impl not in ("radix", "radix4"):
        return 0
    bits = 4 if impl == "radix4" else 8
    words = ([32, 32, 32] if settings.get("dense_rbk_plan") == "sort_partition"
             else [32, 8, 32, 32])
    return sum(-(-w // bits) for w in words)


def phase_plans(torch, np, ck, vt, default):
    out = []
    for label, settings in PLANS:
        res = run_plan(torch, np, ck, vt, label, settings)
        passes = radix_passes(settings)
        res["radix_passes"] = passes
        for name in ("digit_hist", "partition_pos"):
            more = res["warm_launches"][name] - default["warm_launches"][name]
            if passes and more < passes:
                fail(f"{label}: a warm run launched {name} {more} times more "
                     f"than the default plan; its radix sorts take {passes} "
                     "passes")
        log(f"{label}: {passes} radix passes per warm run; warm launches "
            f"{res['warm_launches']} vs default {default['warm_launches']}")
        out.append(res)
        torch.cuda.empty_cache()
    return out


def valid_sum(torch, blk, name):
    """The int64 sum of a column's valid rows, on the card."""
    from vega_tpu_torch import kernels
    col = blk.cols[name]
    mask = kernels.valid_mask(col.shape[1], blk.counts)
    return int(torch.where(mask, col.to(torch.int64), 0).sum())


def config1_data(np):
    """BASELINE config 1 (benchmarks/suite.py:56-61) at 10M pairs."""
    n = C1_ROWS
    i = np.arange(n, dtype=np.int64)
    return dict(keys=(1 << 40) + (i * 2654435761 % C1_KEYS), vals=i * 0.5)


def config1_run(ctx, data):
    """(held sources, steps): each step stores its result in `out`."""
    src = ctx.dense_from_numpy(data["keys"], data["vals"])
    grouped = src.group_by_key()
    return src, [
        ("group_by_key (settled block)", lambda out: grouped.block()),
        ("collect_grouped()",
         lambda out: out.update(grouped=grouped.collect_grouped()))]


def config1_check(np, data, got):
    """Group keys and sizes equal np.unique's; each group's values, as a
    multiset, equal numpy's (float64 narrowed to float32 by the 32-bit
    contract)."""
    gk, offs, gv = got["grouped"]
    keys, vals = data["keys"], data["vals"].astype(np.float32)
    uk, uc = np.unique(keys, return_counts=True)
    order = np.argsort(gk, kind="stable")
    if not (np.array_equal(gk[order], uk)
            and np.array_equal(np.diff(offs)[order], uc)):
        fail("config 1: group keys or sizes differ from np.unique")
    row_keys = np.repeat(gk, np.diff(offs))
    g = np.lexsort([gv, row_keys])
    e = np.lexsort([vals, keys])
    if not (np.array_equal(row_keys[g], keys[e])
            and np.array_equal(gv[g], vals[e])):
        fail("config 1: grouped values differ from numpy")
    return dict(groups=int(len(gk)))


def config4_data(np):
    """BASELINE config 4 (benchmarks/suite.py:157-166) at two sides of
    50M rows, k = n / 20, and a 10,000-row cartesian side."""
    n, k = C4_ROWS, C4_ROWS // 20
    i = np.arange(n, dtype=np.int32)
    return dict(ak=i % k, av=i.astype(np.float32), bk=(i * 3) % k,
                bv=i.astype(np.float32) * 2.0, k=k,
                cx=np.arange(C4_CART, dtype=np.int32))


def config4_run(ctx, data):
    a = ctx.dense_from_numpy(data["ak"], data["av"])
    b = ctx.dense_from_numpy(data["bk"], data["bv"])
    cx = ctx.dense_from_numpy(data["cx"])
    cy = ctx.dense_from_numpy(data["cx"])
    cg = a.cogroup(b)

    def cartesian(out):
        out["cart"] = cx.cartesian(cy)
        out["cart_count"] = out["cart"].count()
    return (a, b, cx, cy), [
        ("cogroup: both sides grouped (settled blocks)",
         lambda out: (cg.left_grouped.block(), cg.right_grouped.block())),
        ("cogroup count()", lambda out: out.update(count=cg.count())),
        ("cogroup collect_grouped()",
         lambda out: out.update(grouped=cg.collect_grouped())),
        ("cartesian count()", cartesian)]


def config4_check(np, torch, data, got):
    """count = the key union's size; per-key left / right sizes equal
    np.bincount; per-key left / right value sums equal np.bincount's with
    weights, exactly (every value is an integer below 2^27 and a key has
    about 20, so float64 sums them exactly in any order); cartesian count
    = m^2 and each product column's int64 sum = m * sum(cx)."""
    count, (keys, lo, lv, ro, rv) = got["count"], got["grouped"]
    cart_count, cart = got["cart_count"], got["cart"]
    k, m = data["k"], C4_CART
    lsize = np.bincount(data["ak"], minlength=k)
    rsize = np.bincount(data["bk"], minlength=k)
    union = np.flatnonzero(lsize + rsize)
    if count != len(union) or not np.array_equal(np.sort(keys), union):
        fail(f"config 4: cogroup count {count}, union {len(union)}")
    if not (np.array_equal(np.diff(lo), lsize[keys])
            and np.array_equal(np.diff(ro), rsize[keys])):
        fail("config 4: per-key group sizes differ from np.bincount")
    group = np.arange(len(keys))
    for side, offs, vals, src_k, src_v in (("left", lo, lv, "ak", "av"),
                                           ("right", ro, rv, "bk", "bv")):
        got_sum = np.bincount(np.repeat(group, np.diff(offs)), weights=vals,
                              minlength=len(keys))
        want_sum = np.bincount(data[src_k], weights=data[src_v],
                               minlength=k)[keys]
        if not np.array_equal(got_sum, want_sum):
            fail(f"config 4: per-key {side} value sums differ from numpy")
    blk = cart.block()
    want = m * int(data["cx"].astype(np.int64).sum())
    sums = [valid_sum(torch, blk, nm) for nm in ("k", "v")]
    if cart_count != m * m or sums != [want, want]:
        fail(f"config 4: cartesian count {cart_count} sums {sums}, "
             f"expected {m * m} and {want}")
    return dict(keys=int(count), cartesian_rows=int(cart_count))


def config5_data(np):
    """BASELINE config 5 (benchmarks/suite.py:201-204) at 125M pairs."""
    rng = np.random.default_rng(7)
    keys = rng.integers(-(1 << 45), 1 << 45, size=C5_ROWS, dtype=np.int64)
    return dict(keys=keys,
                vals=rng.standard_normal(C5_ROWS).astype(np.float32))


def config5_run(ctx, data):
    r = ctx.dense_from_numpy(data["keys"], data["vals"])
    srt = r.sort_by_key()
    return r, [
        ("sort_by_key (settled block)",
         lambda out: out.update(srt=srt, blk=srt.block())),
        ("take(10)", lambda out: out.update(first=srt.take(10))),
        ("take_ordered(10)", lambda out: out.update(top=r.take_ordered(10)))]


def value_sums(np, torch, blk, keys, vals):
    """Values travel with their keys through the sort: the value sum and
    the sum of value x (key & 0xFFFF), in float64 on the card shard by
    shard, equal numpy's within 1e-9 of the sum of the terms' magnitudes.
    Float64 sums of float32 terms in any order err by ~1e-14 of it; one
    value dropped or moved to a key of other low bits moves a sum by more
    than that bound."""
    counts = blk.counts_np
    got = [0.0, 0.0]
    for s in range(len(counts)):
        v = blk.cols["v"][s, :counts[s]].double()
        # the biased low word keeps the key's low 16 bits
        w = (blk.cols["k.lo"][s, :counts[s]] & 0xFFFF).double()
        got[0] += float(v.sum())
        got[1] += float((v * w).sum())
    v64 = vals.astype(np.float64)
    w64 = (keys & 0xFFFF).astype(np.float64)
    want = [float(v64.sum()), float(np.dot(w64, v64))]
    mag = [float(np.abs(v64).sum()), float(np.dot(w64, np.abs(v64)))]
    for what, g, e, m in zip(("value sum", "key-weighted value sum"), got,
                             want, mag):
        if not abs(g - e) <= 1e-9 * m:
            fail(f"config 5: sorted {what} {g!r}, numpy {e!r}")


def config5_check(np, torch, data, got):
    """The sorted block: count equal, keys non-decreasing within and
    across shards, key sum (mod 2^64) equal, and the values still with
    their keys (value_sums); take(10) = numpy's stable sort's first 10
    (key, value) rows; take_ordered(10) = the 10 smallest (key, value)
    tuples."""
    from vega_tpu_torch import kernels
    srt, first, top = got["srt"], got["first"], got["top"]
    keys, vals = data["keys"], data["vals"]
    blk = srt.block()
    counts = blk.counts_np
    if int(counts.sum()) != len(keys):
        fail(f"config 5: sorted count {int(counts.sum())}")
    k64 = kernels.wide_i64(blk.cols["k"], blk.cols["k.lo"])
    mask = kernels.valid_mask(k64.shape[1], blk.counts)
    inner = (k64[:, 1:] >= k64[:, :-1]) | ~mask[:, 1:]
    if not bool(inner.all()):
        fail("config 5: keys decrease inside a shard")
    ends = [(int(k64[s, 0]), int(k64[s, counts[s] - 1]))
            for s in range(len(counts)) if counts[s]]
    if any(ends[i][1] > ends[i + 1][0] for i in range(len(ends) - 1)):
        fail("config 5: keys decrease across shards")
    # the int64 sum mod 2^64 from the words: no sum can overflow
    hi_sum = valid_sum(torch, blk, "k")
    lo_sum = int(torch.where(mask, (blk.cols["k.lo"].to(torch.int64)
                                    & 0xFFFFFFFF) ^ 0x80000000, 0).sum())
    got_sum = ((hi_sum << 32) + lo_sum) % (1 << 64)
    if got_sum != int(keys.view(np.uint64).sum(dtype=np.uint64)):
        fail("config 5: sorted key sum differs from numpy's")
    value_sums(np, torch, blk, keys, vals)
    cut = np.sort(np.partition(keys, 10)[:11])[9]
    pick = np.flatnonzero(keys <= cut)  # in arrival order
    first_rows = pick[np.argsort(keys[pick], kind="stable")][:10]
    if first != list(zip(keys[first_rows].tolist(),
                         vals[first_rows].tolist())):
        fail("config 5: take(10) differs from numpy's stable sort")
    rows = sorted(zip(keys[pick].tolist(), vals[pick].tolist()))[:10]
    if top != rows:
        fail("config 5: take_ordered(10) differs from numpy")
    return dict(first_keys=[k_ for k_, _ in first])


def step_memory(torch, ctx):
    """The allocator's bytes in use and its peak so far, beside the
    Context's tracked block bytes (dense_hbm_in_use)."""
    return dict(allocated=torch.cuda.memory_allocated(),
                peak=torch.cuda.max_memory_allocated(),
                tracked=ctx.dense_hbm_in_use())


def run_steps(torch, run, ctx, data):
    """One run: the host build of the sources, then each step, timed
    apart (host clock, a synchronize after each), with step_memory after
    the build and after each step. Returns (held, out, build ms,
    [step ms], whole s, [memory]) and the step labels."""
    t0 = time.perf_counter()
    held, steps = run(ctx, data)
    t1 = time.perf_counter()
    out, step_ms = {}, []
    mem = [step_memory(torch, ctx)]
    for _label, fn in steps:
        s0 = time.perf_counter()
        fn(out)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        mem.append(step_memory(torch, ctx))
    return (held, out, (t1 - t0) * 1e3, step_ms,
            time.perf_counter() - t0, mem), [label for label, _ in steps]


def run_config(torch, np, ck, vt, label, rows, data, run, check, must):
    """A cold run checked against numpy, then three warm runs (host build
    of the sources and each step timed apart), in one fresh Context; the
    launches of the cold and the first warm run, and the peak device
    memory."""
    ctx = vt.Context(n_shards=N_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    (held, got, _b, cold_steps, cold_s, cold_mem), labels = run_steps(
        torch, run, ctx, data)
    cold_launches = dict(ck.LAUNCHES)
    checked = check(got)
    del got, held
    warm, build_ms, step_ms = [], [], []
    warm_launches = None
    for i in range(3):
        torch.cuda.synchronize()
        ck.reset_launches()
        (held, got, b_ms, s_ms, whole, _m), _ = run_steps(torch, run, ctx,
                                                          data)
        warm.append(whole)
        build_ms.append(b_ms)
        step_ms.append(s_ms)
        if i == 0:
            warm_launches = dict(ck.LAUNCHES)
        del got, held
    peak = torch.cuda.max_memory_allocated()
    ctx.stop()
    for what, launches in (("cold", cold_launches), ("warm", warm_launches)):
        for name in must:
            if launches[name] <= 0:
                fail(f"{label}: kernel {name} was not launched in the "
                     f"{what} run")
    med = statistics.median(warm)
    steps = {lb: statistics.median(r[i] for r in step_ms)
             for i, lb in enumerate(labels)}
    res = dict(label=label, rows=rows, cold_s=cold_s,
               cold_step_ms=dict(zip(labels, cold_steps)), warm_s=warm,
               median_s=med, rows_per_s=rows / med, warm_build_ms=build_ms,
               warm_step_ms=[dict(zip(labels, r)) for r in step_ms],
               median_step_ms=steps, launches=cold_launches,
               warm_launches=warm_launches, peak_bytes=peak, check=checked,
               cold_memory=dict(zip(["host build"] + labels, cold_mem)))
    log(f"{label}: {rows / med:,.0f} rows/s warm median of 3 ({warm} s; "
        f"host build {build_ms} ms; median step ms {steps}), cold "
        f"{cold_s:.3f} s, launches cold {cold_launches} warm "
        f"{warm_launches}, peak {peak} B, {checked}")
    torch.cuda.empty_cache()
    return res


def phase_keyed(torch, np, ck, vt):
    """Phase 5: BASELINE configs 1, 4 and 5 on the card."""
    out = []
    hdu = ("hash_bucket", "digit_hist", "partition_pos")
    for label, rows, make, run, check, must in (
            ("config 1: group_by_key, int64 keys", C1_ROWS, config1_data,
             config1_run, lambda d, g: config1_check(np, d, g), hdu[1:]),
            ("config 4: cogroup + cartesian", 2 * C4_ROWS + C4_CART ** 2,
             config4_data, config4_run,
             lambda d, g: config4_check(np, torch, d, g), hdu),
            ("config 5: sort_by_key + take_ordered, int64 keys", C5_ROWS,
             config5_data, config5_run,
             lambda d, g: config5_check(np, torch, d, g), hdu[1:])):
        data = make(np)
        out.append(run_config(torch, np, ck, vt, label, rows, data, run,
                              lambda g, d=data, c=check: c(d, g), must))
        del data
    return out


def config3_data(np):
    """BASELINE config 3 (benchmarks/suite.py:105-118): the parquet
    column's word ids, n = 100M and k = n / 40, built with numpy (the
    parquet read stays the host tier's)."""
    n = C3_ROWS
    k = max(1000, n // 40)
    ids = ((np.arange(n, dtype=np.uint64) * np.uint64(11400714819323198485))
           % np.uint64(k)).astype(np.int32)
    return dict(ids=ids, k=k)


def config3_run(ctx, data):
    """suite.py's dev_run: dense_from_columns(key=) is the host build; the
    word count up to a settled block, then its collect into a dict."""
    src = ctx.dense_from_columns({"word_id": data["ids"]}, key="word_id")
    counted = src.count_by_key_dense()
    return src, [
        ("count_by_key_dense (settled block)",
         lambda out: counted.block()),
        ("collect()", lambda out: out.update(counts=dict(counted.collect())))]


def config3_check(np, data, got):
    """The collected dict equals np.bincount(ids) over its nonzero ids,
    exactly."""
    counts, want = got["counts"], np.bincount(data["ids"],
                                              minlength=data["k"])
    nz = np.flatnonzero(want)
    keys = np.fromiter(counts.keys(), np.int64, len(counts))
    vals = np.fromiter(counts.values(), np.int64, len(counts))
    order = np.argsort(keys)
    if not (len(counts) == len(nz) and np.array_equal(keys[order], nz)
            and np.array_equal(vals[order], want[nz])):
        fail("config 3: word counts differ from np.bincount")
    return dict(words=int(len(counts)), rows=int(vals.sum()))


def time_op(torch, ck, label, rows, run, check):
    """One op of phase 6(b): the cold run with the launch counts set to 0
    just before it and read just after, its result checked by check(out);
    then three warm runs, each ended by a synchronize (host clock, ms)."""
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ck.LAUNCHES)
    checked = check(out)
    del out
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        del out
    med = statistics.median(warm)
    res = dict(label=label, rows=rows, cold_ms=cold_ms, warm_ms=warm,
               median_ms=med, rows_per_s=rows / (med / 1e3),
               launches=launches, check=checked)
    log(f"{label}: {med:.3f} ms warm median of 3 ({warm}), "
        f"{res['rows_per_s']:,.0f} rows/s, cold {cold_ms:.3f} ms, launches "
        f"{launches}, {checked}")
    return res


def expect(what, ok):
    if not ok:
        fail(f"new ops: {what} differs from numpy")


def new_op_cases(torch, np, ctx):
    """(label, rows, run, check) of phase 6(b) at the main path's size.
    Sources are built once and held; run() drives one op over them to a
    settled block (or an action's value); check() holds the cold result
    against numpy: integers exactly, float sums and stdev within stated
    tolerances, min / max and histogram bins exactly."""
    n, k = N_ROWS, N_KEYS
    x = np.arange(n, dtype=np.int64)
    keep = x % 3 != 0
    v = x ^ 0x5A5A
    xor = np.bitwise_xor.reduce(np.where(keep, v, 0).reshape(n // k, k), 0)

    def kv():
        return ctx.dense_range(n).map(lambda r: (r % N_KEYS, r)) \
            .filter(lambda r: r[1] % 3 != 0).map_values(lambda r: r ^ 0x5A5A)

    def xor_reduce():
        return kv().reduce_by_key(lambda a, b: a ^ b)

    def check_kv(node):
        got = node.block().to_numpy()
        expect("filter / map_values", np.array_equal(got["k"], (x % k)[keep])
               and np.array_equal(got["v"], v[keep]))
        return dict(rows=int(keep.sum()))

    def check_xor(node):
        if node._op is not None:
            fail(f"reduce_by_key(xor) took the named op {node._op!r}, not "
                 "the segmented scan")
        got = node.block().to_numpy()
        o = np.argsort(got["k"])
        expect("reduce_by_key(xor)", np.array_equal(got["k"][o], np.arange(k))
               and np.array_equal(got["v"][o], xor))
        return dict(keys=int(len(o)), scan=True)

    red = xor_reduce()
    red.block()
    tk = np.arange(0, k, 2, dtype=np.int32)
    table = ctx.dense_from_numpy(tk, (tk // 2 * 7).astype(np.int32))

    def check_join(node):
        got = node.block().to_numpy()
        o = np.argsort(got["k"])
        kk = got["k"][o]
        expect("left_outer_join", len(o) == k and np.array_equal(
            kk, np.arange(k)) and np.array_equal(got["lv"][o], xor)
            and np.array_equal(got["rv"][o],
                               np.where(kk % 2 == 0, kk // 2 * 7, -1)))
        return dict(rows=int(len(o)), unmatched=int((got["rv"] == -1).sum()))

    a_np, b_np = x % (n // 7), x % (n // 11)
    a, b = ctx.dense_from_numpy(a_np), ctx.dense_from_numpy(b_np)

    def check_set(want):
        def check(node):
            got = np.sort(node.block().to_numpy()["v"])
            expect("a set op", np.array_equal(got, want))
            return dict(rows=int(len(got)))
        return check

    ua, ub = ctx.dense_range(n), ctx.dense_range(n).map(lambda r: r * 3)
    per = -(-n // N_SHARDS)
    union_want = np.concatenate([np.concatenate([
        x[s * per:(s + 1) * per], 3 * x[s * per:(s + 1) * per]])
        for s in range(N_SHARDS)])

    def check_cols(what, want):
        def check(node):
            got = node.block().to_numpy()
            expect(what, all(np.array_equal(got[c], w)
                             for c, w in want.items()))
            return dict(rows=int(len(next(iter(got.values())))))
        return check

    halves = ctx.dense_range(n).map(lambda r: r * 0.5)
    halves.block()
    h64 = x * 0.5  # exact in float64
    h32 = x.astype(np.float32) * np.float32(0.5)  # the card's values

    def close(what, got, want, rtol):
        if not abs(got - want) <= rtol * abs(want):
            fail(f"new ops: {what} {got!r}, numpy {want!r} (rtol {rtol})")
        return dict(value=got, numpy=want, rel_err=abs(got - want)
                    / abs(want), rtol=rtol)

    def check_stats(st):
        ok = (st["count"] == n and st["min"] == float(h32.min())
              and st["max"] == float(h32.max()))
        expect("stats count / min / max", ok)
        return dict(mean=close("stats mean", st["mean"], h64.mean(), 1e-5),
                    stdev=close("stats stdev", st["stdev"], h64.std(),
                                1e-4))

    def check_min_max(got):
        expect("min / max", got == (float(h32.min()), float(h32.max())))
        return dict(min=got[0], max=got[1])

    def check_hist(res):
        edges, counts = res
        e32 = np.asarray(edges, dtype=np.float32)
        nb = len(edges) - 1
        mask = (h32 >= e32[0]) & (h32 <= e32[-1])
        idx = np.clip(np.searchsorted(e32, h32, side="right") - 1, 0, nb - 1)
        want = np.bincount(idx[mask], minlength=nb)
        expect("histogram(10)", len(counts) == nb == 10
               and edges[0] == float(h32.min())
               and edges[-1] == float(h32.max())
               and np.array_equal(np.asarray(counts), want))
        return dict(counts=list(counts))

    # n - 1 rows: the xor of 0..n-1 is 0 when 4 divides n
    ints = ctx.dense_range(n - 1)
    ints.block()
    xor_all = int(np.bitwise_xor.reduce(x[:-1].astype(np.int32)))

    def check_reduce(got):
        expect("reduce(xor)", got == xor_all)
        return dict(value=got)

    def built(make):
        def run():
            node = make()
            node.block()
            return node
        return run

    return [
        ("map + filter + map_values", n, built(kv), check_kv),
        ("reduce_by_key(lambda a, b: a ^ b)", int(keep.sum()),
         built(xor_reduce), check_xor),
        ("left_outer_join(K/2 even keys, fill_value=-1)", k,
         built(lambda: red.left_outer_join(table, fill_value=-1)),
         check_join),
        ("distinct", n, built(a.distinct), check_set(np.unique(a_np))),
        ("intersection", 2 * n, built(lambda: a.intersection(b)),
         check_set(np.intersect1d(a_np, b_np))),
        ("subtract", 2 * n, built(lambda: a.subtract(b)),
         check_set(np.sort(a_np[~np.isin(a_np, b_np)]))),
        ("union", 2 * n, built(lambda: ua.union(ub)),
         check_cols("union", {"v": union_want})),
        ("zip", 2 * n, built(lambda: ua.zip(ub)),
         check_cols("zip", {"k": x, "v": 3 * x})),
        ("zip_with_index", n, built(ub.zip_with_index),
         check_cols("zip_with_index", {"k": 3 * x, "v": x})),
        ("sum", n, halves.sum,
         lambda got: close("sum", got, h64.sum(), 1e-5)),
        ("mean", n, halves.mean,
         lambda got: close("mean", got, h64.mean(), 1e-5)),
        ("min / max", n, lambda: (halves.min(), halves.max()),
         check_min_max),
        ("stats", n, halves.stats, check_stats),
        ("histogram(10)", n, lambda: halves.histogram(10), check_hist),
        ("reduce(lambda a, b: a ^ b)", n - 1,
         lambda: ints.reduce(lambda p, q: p ^ q), check_reduce),
    ]


def phase_new_ops(torch, np, ck, vt):
    """Phase 6(b): every new op at the main path's size in one Context;
    the launch counts of the cold runs are summed and every kernel must
    have launched in them."""
    ctx = vt.Context(n_shards=N_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cases = new_op_cases(torch, np, ctx)
    setup_s = time.perf_counter() - t0
    out = [time_op(torch, ck, *case) for case in cases]
    peak = torch.cuda.max_memory_allocated()
    ctx.stop()
    launches = {name: sum(r["launches"][name] for r in out)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 6(b)'s cold runs")
    torch.cuda.empty_cache()
    return dict(ops=out, launches=launches, peak_bytes=peak,
                setup_s=setup_s)


# ---------------------------------------------------------------------------
# phase 7: the row-function repairs, wide int64 values and keys, the
# expansions and sample
# ---------------------------------------------------------------------------

# threefry2x32 of jax 0.9.0 (jax._src.prng.threefry2x32_p) at fixed
# ((key words), (counter words)) -> (output words), computed once with jax
# on the CPU: this script imports no jax
THREEFRY_KAT = [
    ((0, 7), (0, 0), (3625411723, 1954958720)),
    ((0, 7), (0, 1), (195045567, 4062205631)),
    ((0, 7), (0, 12345), (3187294848, 248916179)),
    ((0x12345678, 0x9ABCDEF0), (0xDEADBEEF, 0x01234567),
     (4091565387, 4026977628)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (481924860, 3137350631)),
]
# jax.random.fold_in(PRNGKey(7), 3) and the float32 bits of
# jax.random.uniform(that key, (4,))
FOLD_IN_KAT = ((7, 3), (276534068, 1641862660))
UNIFORM_KAT = [1047323352, 1050808692, 1061857446, 1057546926]
SAMPLE_FRACTION, SAMPLE_SEED = 0.01, 7
WIDE_BASE = 1 << 33


def p7_check(what, ok):
    if not ok:
        fail(f"phase 7: {what}")


def p7_line(torch, ck, label, rows, run, check, must=()):
    """One phase-7 line: time_op's cold run (launches counted from 0) and
    three warm runs; `must` names the kernels the cold run must launch."""
    res = time_op(torch, ck, label, rows, run, check)
    for name in must:
        if res["launches"][name] <= 0:
            fail(f"phase 7 {label}: kernel {name} was not launched")
    return res


def p7_wordcount(torch, np, ck, ctx, c3):
    """(a) BASELINE config 3 the Spark way: map(lambda w: (w, 1)), then
    the named add and the add closure (which must take the named add)."""
    src = ctx.dense_from_numpy(c3["ids"])
    src.block()

    def named():
        return dict(src.map(lambda w: (w, 1)).reduce_by_key(op="add")
                    .collect())

    def closure():
        node = src.map(lambda w: (w, 1)).reduce_by_key(lambda a, b: a + b)
        p7_check("reduce_by_key(lambda a, b: a + b) took the named add",
                 node._op == "add")
        return dict(node.collect())

    def check(got):
        return config3_check(np, c3, {"counts": got})

    must = ("hash_bucket", "digit_hist")
    return [p7_line(torch, ck, "7a word count map((w, 1)).reduce_by_key("
                    "op='add').collect()", C3_ROWS, named, check, must),
            p7_line(torch, ck, "7a word count reduce_by_key(lambda a, b: "
                    "a + b).collect()", C3_ROWS, closure, check, must)]


def p7_wide_values(torch, np, ck, vt, ctx):
    """(b) int64 values beyond int32 (the (v, v.lo) pair) at the main
    path's size: the named reduces, a join of the sums against phase 3's
    table, the keyless actions, and the overflow case."""
    n, k = N_ROWS, N_KEYS
    i = np.arange(n, dtype=np.int64)
    vals = WIDE_BASE + (i * 7919) % 10**6
    src = ctx.dense_from_numpy((i % k).astype(np.int32), vals)
    p7_check("the wide value takes the pair encoding",
             src.columns == ["k", "v", "v.lo"])
    src.block()
    per_key = vals.reshape(n // k, k)
    want = {"add": per_key.sum(axis=0), "min": per_key.min(axis=0),
            "max": per_key.max(axis=0)}
    table = ctx.dense_from_numpy(np.arange(k, dtype=np.int32),
                                 np.arange(k, dtype=np.float32) * 2.0)
    table.block()

    def reduced(op):
        def run():
            node = src.reduce_by_key(op=op)
            node.block()
            return node
        return run

    def check_reduce(op):
        def check(node):
            got = node.collect_arrays()
            o = np.argsort(got["k"])
            p7_check(f"wide reduce_by_key(op={op!r}) equals numpy int64",
                     got["v"].dtype == np.int64
                     and np.array_equal(got["k"][o], np.arange(k))
                     and np.array_equal(got["v"][o], want[op]))
            return dict(keys=int(len(o)))
        return check

    red = src.reduce_by_key(op="add")
    red.block()

    def joined():
        node = red.join(table)
        node.block()
        return node

    def check_join(node):
        got = node.collect_arrays()
        o = np.argsort(got["k"])
        p7_check("the join of the wide sums equals numpy",
                 np.array_equal(got["k"][o], np.arange(k))
                 and np.array_equal(got["lv"][o], want["add"])
                 and np.array_equal(got["rv"][o],
                                    np.arange(k, dtype=np.float32) * 2.0))
        return dict(rows=int(len(o)))

    values = src.values_dense()

    def keyless():
        return values.sum(), values.min(), values.max()

    def check_keyless(got):
        exact = (int(vals.sum()), int(vals.min()), int(vals.max()))
        p7_check("values_dense sum / min / max equal numpy", got == exact)
        return dict(sum=got[0], min=got[1], max=got[2])

    hdu = ("hash_bucket", "digit_hist", "partition_pos")
    lines = [p7_line(torch, ck, f"7b wide values reduce_by_key(op={op!r})",
                     n, reduced(op), check_reduce(op), hdu[:2])
             for op in ("add", "min", "max")]
    lines.append(p7_line(torch, ck, "7b wide sums .join(K-row table)", k,
                         joined, check_join, hdu))
    lines.append(p7_line(torch, ck, "7b values_dense().sum() / min() / "
                         "max()", n, keyless, check_keyless))
    big = ctx.dense_from_numpy(np.zeros(1000, np.int32),
                               np.full(1000, 1 << 62, np.int64))
    try:
        big.reduce_by_key(op="add").collect()
        fail("phase 7: a wide sum beyond int64 did not raise")
    except vt.VegaError as e:
        p7_check("the overflow names the int64 range",
                 "int64 range" in str(e))
    bignum = big.values_dense().sum()
    p7_check("the keyless sum beyond int64 is the exact bignum",
             bignum == 1000 * (1 << 62))
    log(f"7b overflow: reduce_by_key(op='add') raised VegaError, keyless "
        f"sum {bignum} exact; host folds: none (the port has no host fold: "
        "a wide sum's range is decided exactly on the card)")
    return lines, dict(overflow_raised=True, bignum=str(bignum),
                       host_folds="none: no host fold path")


def p7_wide_keys(torch, np, ck, ctx):
    """(c) BASELINE config 1's int64 keys: reduce_by_key(op='add') joined
    against a table of the same keys, and a mixed-width left outer join
    (the int32 table widens, _WidenKeyRDD)."""
    data = config1_data(np)
    keys, vals = data["keys"], data["vals"]
    src = ctx.dense_from_numpy(keys, vals)
    src.block()
    uk = np.unique(keys)
    rel = keys - (1 << 40)
    sums = np.bincount(rel, weights=vals.astype(np.float32))
    counts = np.bincount(rel)
    table = ctx.dense_from_numpy(uk, np.arange(len(uk), dtype=np.int32))
    table.block()
    red = src.reduce_by_key(op="add")

    def run_red():
        node = src.reduce_by_key(op="add")
        node.block()
        return node

    def check_red(node):
        got = node.collect_arrays()
        o = np.argsort(got["k"])
        p7_check("wide-key reduce keys", np.array_equal(got["k"][o], uk))
        err = np.max(np.abs(got["v"][o] - sums[uk - (1 << 40)])
                     / np.maximum(np.abs(sums[uk - (1 << 40)]), 1))
        p7_check(f"wide-key float sums within rtol 1e-5 ({err})",
                 err <= 1e-5)
        return dict(keys=int(len(o)), max_rel_err=float(err))

    def run_join():
        node = red.join(table)
        node.block()
        return node

    def check_join(node):
        got = node.collect_arrays()
        o = np.argsort(got["k"])
        p7_check("wide-key join keys and table values",
                 np.array_equal(got["k"][o], uk)
                 and np.array_equal(got["rv"][o], np.arange(len(uk))))
        err = np.max(np.abs(got["lv"][o] - sums[uk - (1 << 40)])
                     / np.maximum(np.abs(sums[uk - (1 << 40)]), 1))
        p7_check(f"wide-key join sums within rtol 1e-5 ({err})", err <= 1e-5)
        return dict(rows=int(len(o)), max_rel_err=float(err))

    n = C1_ROWS
    i = np.arange(n, dtype=np.int64)
    base = (i * 2654435761) % (C1_KEYS // 2)
    mkeys = np.where(i % 2 == 0, base, (1 << 40) + base)
    mixed = ctx.dense_from_numpy(mkeys, i.astype(np.int32))
    p7_check("the mixed side is wide", mixed.wide_key)
    t32 = ctx.dense_from_numpy(np.arange(C1_KEYS, dtype=np.int32),
                               np.arange(C1_KEYS, dtype=np.int32) * 3)
    mixed.block()
    t32.block()

    def run_outer():
        node = mixed.left_outer_join(t32, fill_value=-1)
        node.block()
        return node

    def check_outer(node):
        got = node.collect_arrays()
        o = np.lexsort([got["lv"], got["k"]])
        e = np.lexsort([i, mkeys])
        want_rv = np.where(mkeys < C1_KEYS, mkeys * 3, -1)
        p7_check("mixed-width left_outer_join equals numpy",
                 len(got["k"]) == n
                 and np.array_equal(got["k"][o], mkeys[e])
                 and np.array_equal(got["lv"][o], i[e])
                 and np.array_equal(got["rv"][o], want_rv[e]))
        return dict(rows=int(len(o)), unmatched=int((got["rv"] == -1).sum()))

    must = ("digit_hist", "partition_pos")
    out = [p7_line(torch, ck, "7c wide keys reduce_by_key(op='add')", n,
                   run_red, check_red, must[:1])]
    red.block()
    out.append(p7_line(torch, ck, "7c wide keys sums .join(250,000-row "
                       "int64 table)", n, run_join, check_join, must))
    out.append(p7_line(torch, ck, "7c mixed-width left_outer_join(int32 "
                       "table, fill_value=-1)", n, run_outer, check_outer,
                       must))
    return out


def p7_expansions(torch, np, ck, ctx):
    """(d) map_expand (factor 4) and the digit flat_map_ragged (max_out 8)
    over dense_range(N), each into reduce_by_key(op='add')."""
    n, k = N_ROWS, N_KEYS
    src = ctx.dense_range(n)
    src.block()
    pows = [10 ** d for d in range(8)]

    def expand(x):
        keys = torch.stack([(4 * x + j) % N_KEYS for j in range(4)], dim=-1)
        return keys, torch.ones_like(keys)

    def digits(x):
        d = torch.stack([(x // p) % 10 for p in pows], dim=-1)
        nd = 1 + sum((x >= p).to(torch.int32) for p in pows[1:])
        return (d, torch.ones_like(d)), nd

    def run(node_fn):
        def go():
            node = node_fn()
            node.block()
            return node
        return go

    x = np.arange(n, dtype=np.int64)
    digit_want = np.zeros(10, np.int64)
    for p in pows:
        live = (x >= p) | (p == 1)
        digit_want += np.bincount((x[live] // p) % 10, minlength=10)

    def check_expand(node):
        got = node.collect_arrays()
        o = np.argsort(got["k"])
        p7_check("map_expand counts: every key 4N/K times",
                 np.array_equal(got["k"][o], np.arange(k))
                 and (got["v"] == 4 * n // k).all())
        return dict(keys=int(len(o)), rows_out=4 * n)

    def check_digits(node):
        got = node.collect_arrays()
        o = np.argsort(got["k"])
        p7_check("digit counts equal numpy",
                 np.array_equal(got["k"][o], np.arange(10))
                 and np.array_equal(got["v"][o], digit_want))
        return dict(digits=int(digit_want.sum()))

    must = ("hash_bucket", "digit_hist")
    return [
        p7_line(torch, ck, "7d map_expand(factor 4).reduce_by_key('add')",
                n, run(lambda: src.map_expand(expand, 4)
                       .reduce_by_key(op="add")), check_expand, must),
        p7_line(torch, ck, "7d flat_map_ragged(digits, 8).reduce_by_key("
                "'add')", n, run(lambda: src.flat_map_ragged(digits, 8)
                                 .reduce_by_key(op="add")), check_digits,
                must)]


def p7_sample(torch, np, ck, vt, ctx):
    """(e) sample(False, 0.01, seed=7) of dense_range(N): the rows equal
    the port's CPU run of the same lineage, the count lies within 6 sigma
    of N * 0.01, and the threefry words equal jax's at fixed inputs."""
    from vega_tpu_torch import kernels
    dev = ctx.device
    for (k0, k1), (x0, x1), want in THREEFRY_KAT:
        got = kernels.threefry2x32(
            k0, k1, torch.tensor([x0], device=dev, dtype=torch.int64),
            torch.tensor([x1], device=dev, dtype=torch.int64))
        p7_check(f"threefry2x32 {(k0, k1)} {(x0, x1)} on the card",
                 (int(got[0][0]), int(got[1][0])) == want)
    (seed, data), want = FOLD_IN_KAT
    key = kernels.fold_in(*kernels.prng_key(seed), data)
    p7_check("fold_in(PRNGKey(7), 3)", tuple(key) == want)
    u = kernels.uniform_f32(*key, torch.arange(4, device=dev))
    p7_check("uniform's float32 bits on the card",
             u.view(torch.int32).tolist() == UNIFORM_KAT)
    n = N_ROWS
    src = ctx.dense_range(n)
    src.block()
    with vt.Context(device="cpu", n_shards=N_SHARDS) as cpu:
        cpu_node = cpu.dense_range(n).sample(False, SAMPLE_FRACTION,
                                             SAMPLE_SEED)
        cpu_rows = cpu_node.collect_arrays()["v"]
        cpu_counts = cpu_node.block().counts_np.copy()

    def run():
        node = src.sample(False, SAMPLE_FRACTION, SAMPLE_SEED)
        node.block()
        return node

    def check(node):
        rows = node.collect_arrays()["v"]
        sigma = math.sqrt(n * SAMPLE_FRACTION * (1 - SAMPLE_FRACTION))
        p7_check("the card's sample rows equal the CPU run's",
                 np.array_equal(rows, cpu_rows)
                 and np.array_equal(node.block().counts_np, cpu_counts))
        p7_check("the sample count within 6 sigma of N * fraction",
                 abs(len(rows) - n * SAMPLE_FRACTION) <= 6 * sigma)
        return dict(kept=int(len(rows)), sigma=sigma, kat="threefry, "
                    "fold_in and uniform equal jax's")

    return [p7_line(torch, ck, "7e sample(False, 0.01, seed=7)", n, run,
                    check)]


def p7_queue3(torch, np, ck, ctx):
    """(f) queue 3's inputs on the card at their small sizes, each exact
    against numpy / Python semantics."""
    a = np.arange(1, 40, dtype=np.int32)
    d = ctx.dense_from_numpy(a)
    al = a.tolist()
    cases = [
        ("F1 word count", lambda: sorted(d.map(lambda x: (x % 3, 1))
                                        .reduce_by_key(op="add").collect()),
         [(0, 13), (1, 13), (2, 13)]),
        ("F1 map(lambda x: 7)", lambda: d.map(lambda x: 7).collect(),
         [7] * len(al)),
        ("F1 map(lambda x: (x, 0.5))",
         lambda: d.map(lambda x: (x, 0.5)).collect(),
         [(x, 0.5) for x in al]),
        ("F1 key_by(lambda x: 0)", lambda: d.key_by(lambda x: 0).collect(),
         [(0, x) for x in al]),
        ("F1 map_values(lambda v: 1)",
         lambda: d.map(lambda x: (x, x)).map_values(lambda v: 1).collect(),
         [(x, 1) for x in al]),
        ("F1 filter(lambda x: True)",
         lambda: d.filter(lambda x: True).collect(), al),
        ("F2 map(lambda x: (x % 3, 100 // x))",
         lambda: d.map(lambda x: (x % 3, 100 // x)).collect(),
         [(x % 3, 100 // x) for x in al]),
        ("F2 filter(lambda x: 100 // x > 5)",
         lambda: d.filter(lambda x: 100 // x > 5).collect(),
         [x for x in al if 100 // x > 5]),
        ("F4 bool column", lambda: d.map(lambda x: (x % 3, x > 5)).collect(),
         [(x % 3, x > 5) for x in al]),
        ("F4 bool column through group_by_key",
         lambda: sorted((k_, sorted(v_)) for k_, v_ in d.map(
             lambda x: (x % 3, x > 5)).group_by_key().collect()),
         sorted((r, sorted(x > 5 for x in al if x % 3 == r))
                for r in range(3))),
        ("F4 (x % 3 == 0) * 1 is int32",
         lambda: d.map(lambda x: (x, (x % 3 == 0) * 1)).collect(),
         [(x, int(x % 3 == 0)) for x in al]),
    ]
    nk = np.array([np.nan, 1, np.nan, 2, 1, np.nan, 3, np.nan], np.float32)
    nv = np.arange(1, 9, dtype=np.int32)
    nan_src = ctx.dense_from_numpy(nk, nv)
    nan_right = ctx.dense_from_numpy(np.float32([1, np.nan]),
                                     np.int32([10, 20]))

    def canonical(rows):
        return repr(sorted(rows, key=lambda r: (np.isnan(r[0]),
                                                0 if np.isnan(r[0]) else r[0],
                                                repr(r))))

    nan_rows = [(float("nan"), int(x)) for k_, x in zip(nk, nv)
                if np.isnan(k_)]
    cases += [
        ("F5 reduce_by_key", lambda: canonical(
            nan_src.reduce_by_key(op="add").collect()),
         canonical([(1.0, 7), (2.0, 4), (3.0, 7)] + nan_rows)),
        ("F5 group_by_key", lambda: canonical(
            [(k_, sorted(v_)) for k_, v_ in
             nan_src.group_by_key().collect()]),
         canonical([(1.0, [2, 5]), (2.0, [4]), (3.0, [7])]
                   + [(k_, [x]) for k_, x in nan_rows])),
        ("F5 join", lambda: canonical(nan_src.join(nan_right).collect()),
         canonical([(1.0, (2, 10)), (1.0, (5, 10))])),
        ("F5 sort_by_key", lambda: repr(nan_src.sort_by_key().collect()),
         repr([(1.0, 2), (1.0, 5), (2.0, 4), (3.0, 7)] + nan_rows)),
    ]
    out = []
    for label, run, want in cases:
        got = run()
        p7_check(f"{label}: {got!r} != {want!r}", got == want)
        out.append(label)
    log(f"7f queue 3 on the card: {len(out)} inputs equal numpy: {out}")
    return out


def phase_seven(torch, np, ck, vt, c3):
    """Phase 7 in one Context: (a)-(e) each a timed line, (f) the checks;
    the launches of the cold runs summed for the kernel line."""
    ctx = vt.Context(n_shards=N_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    lines = p7_wordcount(torch, np, ck, ctx, c3)
    wide_lines, overflow = p7_wide_values(torch, np, ck, vt, ctx)
    lines += wide_lines
    lines += p7_wide_keys(torch, np, ck, ctx)
    lines += p7_expansions(torch, np, ck, ctx)
    lines += p7_sample(torch, np, ck, vt, ctx)
    queue3 = p7_queue3(torch, np, ck, ctx)
    peak = torch.cuda.max_memory_allocated()
    ctx.stop()
    launches = {name: sum(r["launches"][name] for r in lines)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 7's cold runs")
    torch.cuda.empty_cache()
    return dict(lines=lines, launches=launches, peak_bytes=peak,
                overflow=overflow, queue3=queue3)


# ---------------------------------------------------------------------------
# phase 8: streamed sources, npz checkpoints and the block lifetime
# ---------------------------------------------------------------------------

P8_ROWS = 1_000_000_000        # BASELINE's north star, no cut
P8_KEYS = 1_000_000
P8_CHUNK_ROWS = 178_257_920    # 4 GiB / (4 B x 6), rounded down to 1M rows
P8_CHUNKS = 6
P8_RELOAD_CHUNK_ROWS = 131_072    # (d): 8 chunks of the 1M reduced keys
C1_RELOAD_CHUNK_ROWS = 2_500_000  # (d): 4 chunks of config 1's pairs
LIFETIME_BUDGET = 256 << 20
P8_NPZ_DIR = os.path.join("chiprun_out", "phase8_npz")


def p8_check(what, ok):
    if not ok:
        fail(f"phase 8: {what}")


def p8_table(ctx, np):
    return ctx.dense_from_numpy(np.arange(P8_KEYS, dtype=np.int32),
                                2 * np.arange(P8_KEYS, dtype=np.int32))


class _ChunkTimes:
    """Times of the stream's per-chunk fold records (the reference's own
    log line, stream.py's logger at INFO), for the fold ms of each
    chunk."""

    def __init__(self, logging):
        self.created = []
        self._logging = logging
        self._log = logging.getLogger("vega_tpu_torch.stream")
        self._handler = logging.Handler()
        self._handler.emit = self._emit

    def _emit(self, record):
        if record.getMessage().startswith("streamed reduce_by_key: chunk"):
            self.created.append(record.created)

    def __enter__(self):
        self._level = self._log.level
        self._log.setLevel(self._logging.INFO)
        self._log.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self._handler)
        self._log.setLevel(self._level)
        return False

    def fold_ms(self, t0_wall):
        ts = [t0_wall] + self.created
        return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]


def p8_north_star(torch, np, ck, stream, ctx, src, chunks=P8_CHUNKS,
                  chunk_rows=P8_CHUNK_ROWS, label="8a"):
    """(a) benchmarks/stream_1b.py's group_by+join at N = 1e9, K = 1e6:
    the streamed fold, a join against the K-row table, count(); cold
    once, then three warm runs that each re-stream from the source, in
    `chunks` chunks of `chunk_rows` (phase 9b runs it under the
    planner's chunking)."""
    import logging

    def run():
        reduced = src.map(lambda x: (x % P8_KEYS, x)).reduce_by_key(op="add")
        joined = reduced.join(p8_table(ctx, np))
        return reduced, joined, joined.count()

    runs = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        torch.cuda.synchronize()
        ck.reset_launches()
        with _ChunkTimes(logging) as times:
            t_wall = time.time()
            t0 = time.perf_counter()
            reduced, joined, count = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        p8_check(f"run {i}: count() = {count}, expected {P8_KEYS}",
                 count == P8_KEYS)
        p8_check(f"{label} run {i}: {len(times.created)} chunk folds, "
                 f"expected {chunks}", len(times.created) == chunks)
        check_launched(launches, f"phase {label} run {i}")
        runs.append(dict(wall_s=wall, launches=launches,
                         fold_ms=times.fold_ms(t_wall)))
        if i == 0:
            got = joined.collect_arrays()
            o = np.argsort(got["k"])
            # x = k + K j for j < N / K: per-key sum (N / K) k + K (N / K)
            # (N / K - 1) / 2 = 1000k + 499,500,000,000, wrapped to int32
            k = np.arange(P8_KEYS, dtype=np.int64)
            per = P8_ROWS // P8_KEYS
            want = ((per * k + P8_KEYS * per * (per - 1) // 2) % (1 << 32)
                    ).astype(np.uint32).view(np.int32)
            p8_check("every joined row: key k carries (1000k + "
                     "499,500,000,000) mod 2^32 as int32 and 2k",
                     np.array_equal(got["k"][o], k)
                     and got["lv"].dtype == np.int32
                     and np.array_equal(got["lv"][o], want)
                     and np.array_equal(got["rv"][o], 2 * k))
            kept = reduced
            del got
        del reduced, joined
    peak = torch.cuda.max_memory_allocated()
    warm = [r["wall_s"] for r in runs[1:]]
    med = statistics.median(warm)
    res = dict(rows=P8_ROWS, keys=P8_KEYS, chunks=chunks,
               chunk_rows=chunk_rows, exchange=ctx.dense_exchange,
               cold_s=runs[0]["wall_s"],
               warm_s=warm, median_s=med, rows_per_s=P8_ROWS / med,
               cold_fold_ms=runs[0]["fold_ms"],
               warm_fold_ms=[r["fold_ms"] for r in runs[1:]],
               launches=runs[0]["launches"],
               warm_launches=[r["launches"] for r in runs[1:]],
               peak_bytes=peak, budget=ctx.dense_hbm_budget)
    log(f"{label} 1B group_by+join under dense_exchange="
        f"{ctx.dense_exchange!r}: {P8_ROWS / med:,.0f} rows/s warm median of 3 "
        f"({warm} s), cold {runs[0]['wall_s']:.3f} s, fold ms cold "
        f"{runs[0]['fold_ms']} warm {res['warm_fold_ms']}, launches cold "
        f"{runs[0]['launches']} warm {res['warm_launches']}, peak {peak} B "
        f"beside the budget {ctx.dense_hbm_budget} B")
    return res, kept


def p8_order_stats(torch, src):
    """(b) take_ordered(10) and top(10) of the streamed source."""
    out = {}
    for name, want in (("take_ordered", list(range(10))),
                       ("top", list(range(P8_ROWS - 1, P8_ROWS - 11, -1)))):
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = getattr(src, name)(10)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            p8_check(f"{name}(10) = {got}, expected {want}", got == want)
        med = statistics.median(times[1:])
        out[name] = dict(cold_ms=times[0], warm_ms=times[1:], median_ms=med,
                         rows_per_s=P8_ROWS / (med / 1e3))
        log(f"8b {name}(10): {med:.3f} ms warm median of 3 ({times[1:]}), "
            f"cold {times[0]:.3f} ms, {P8_ROWS / (med / 1e3):,.0f} rows/s")
    return out


def p8_enrichment_join(torch, np, ck, src, ctx):
    """(c) the streamed enrichment join src.map((x % K, x)).join(table):
    count() == N, the table re-placed once per run (its partition_pos
    launches, measured alone, are the whole difference against a join of
    the same stream with a table placed beforehand, whatever the number
    of chunks), and the first chunk's joined rows exact, as columns on
    the card."""
    from vega_tpu_torch import kernels

    table = p8_table(ctx, np)
    times, launches = [], None
    for i in range(4):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        joined = src.map(lambda x: (x % P8_KEYS, x)).join(table)
        count = joined.count()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        p8_check(f"the streamed join's count() = {count}, expected "
                 f"{P8_ROWS}", count == P8_ROWS)
        if i == 0:
            launches = dict(ck.LAUNCHES)
            check_launched(launches, "phase 8(c)'s cold run")
    fresh_pos = dict(ck.LAUNCHES)["partition_pos"]  # the last warm run
    ck.reset_launches()
    placed = table.group_by_key()
    placed.block()
    table_pos = ck.LAUNCHES["partition_pos"]
    ck.reset_launches()
    p8_check("the pre-placed join counts N",
             src.map(lambda x: (x % P8_KEYS, x)).join(placed).count()
             == P8_ROWS)
    placed_pos = ck.LAUNCHES["partition_pos"]
    p8_check(f"the table re-placed once per run: partition_pos {fresh_pos} "
             f"with the table, {placed_pos} with it placed beforehand, "
             f"{table_pos} to place it alone",
             table_pos >= 1 and fresh_pos - placed_pos == table_pos
             and placed_pos >= P8_CHUNKS)
    first = next(iter(joined._make_chunks()))
    blk = first.block()
    mask = kernels.valid_mask(blk.capacity, blk.counts)
    k, lv, rv = (blk.cols[nm][mask] for nm in ("k", "lv", "rv"))
    p8_check("the first chunk's joined rows are (x % K, (x, 2 (x % K))) "
             "for x < 178,257,920, each once",
             k.numel() == P8_CHUNK_ROWS
             and bool(torch.equal(k, lv % P8_KEYS))
             and bool(torch.equal(rv, 2 * k))
             and bool(torch.equal(torch.sort(lv).values, torch.arange(
                 P8_CHUNK_ROWS, device=lv.device, dtype=lv.dtype))))
    del first, blk, mask, k, lv, rv, joined
    med = statistics.median(times[1:])
    res = dict(cold_s=times[0], warm_s=times[1:], median_s=med,
               rows_per_s=P8_ROWS / med, launches=launches,
               partition_pos=dict(with_table=fresh_pos,
                                  table_placed_before=placed_pos,
                                  table_alone=table_pos))
    log(f"8c streamed join: {P8_ROWS / med:,.0f} rows/s warm median of 3 "
        f"({times[1:]} s), cold {times[0]:.3f} s, launches cold {launches}, "
        f"partition_pos {res['partition_pos']}; first chunk exact")
    return res


def p8_checkpoints(torch, np, stream, ctx, reduced):
    """(d) save_npz / dense_load_npz: (a)'s reduced block, reloaded
    resident and streamed in 8 chunks; config 1's 10M int64-keyed pairs,
    reloaded streamed in 4 chunks and reduced as the resident source."""
    os.makedirs(P8_NPZ_DIR, exist_ok=True)
    out = {}
    try:
        path = reduced.save_npz(os.path.join(P8_NPZ_DIR, "reduced.npz"))
        want = reduced.collect_arrays()
        t0 = time.perf_counter()
        back = ctx.dense_load_npz(path)
        p8_check("the reduced block reloads resident",
                 not isinstance(back, stream.StreamedDenseRDD))
        got = back.collect_arrays()
        p8_check("the resident reload equals the saved rows",
                 list(got) == list(want) and all(
                     np.array_equal(got[nm], want[nm]) for nm in want))
        st = ctx.dense_load_npz(path, chunk_rows=P8_RELOAD_CHUNK_ROWS)
        p8_check(f"chunk_rows={P8_RELOAD_CHUNK_ROWS} streams the reload",
                 isinstance(st, stream.StreamedDenseRDD) and st.n_chunks
                 == -(-P8_KEYS // P8_RELOAD_CHUNK_ROWS))
        parts = [c.collect_arrays() for c in st._make_chunks()]
        p8_check("the streamed reload's chunks equal the saved rows",
                 all(np.array_equal(np.concatenate([p[nm] for p in parts]),
                                    want[nm]) for nm in want))
        out["reduced"] = dict(rows=int(len(want["k"])), chunks=st.n_chunks,
                              bytes=os.path.getsize(path),
                              ms=(time.perf_counter() - t0) * 1e3)
        del want, got, back, st, parts

        data = config1_data(np)
        src = ctx.dense_from_numpy(data["keys"], data["vals"])
        t0 = time.perf_counter()
        path = src.save_npz(os.path.join(P8_NPZ_DIR, "config1.npz"))
        st = ctx.dense_load_npz(path, chunk_rows=C1_RELOAD_CHUNK_ROWS)
        p8_check("config 1's pairs reload streamed",
                 isinstance(st, stream.StreamedDenseRDD) and st.n_chunks
                 == -(-C1_ROWS // C1_RELOAD_CHUNK_ROWS))
        got = st.reduce_by_key(op="add").collect_arrays()
        want = src.reduce_by_key(op="add").collect_arrays()
        og, ow = np.argsort(got["k"]), np.argsort(want["k"])
        p8_check("the streamed reduce of the reloaded config-1 pairs "
                 "equals the resident reduce (keys exact, sums rtol 1e-5)",
                 got["k"].dtype == np.int64
                 and np.array_equal(got["k"][og], want["k"][ow])
                 and np.allclose(got["v"][og], want["v"][ow], rtol=1e-5,
                                 atol=0))
        out["config1"] = dict(rows=C1_ROWS, keys=int(len(og)),
                              chunks=st.n_chunks,
                              bytes=os.path.getsize(path),
                              ms=(time.perf_counter() - t0) * 1e3)
    finally:
        for name in ("reduced.npz", "config1.npz"):
            p = os.path.join(P8_NPZ_DIR, name)
            if os.path.exists(p):
                os.remove(p)
    log(f"8d checkpoints: {out}")
    return out


def p8_lifetime(torch, np, vt, dense_rdd, stream):
    """(e) bench-main's pipeline in a Context of a 256 MiB budget: the
    source streams (3 chunks under the planner) and equals numpy; then, on its resident
    build with the mapped block held, a second mapped block evicts the
    first, which rematerializes with equal rows, and the pipeline equals
    numpy again; unpersist() drops its bytes from dense_hbm_in_use().
    After each materialization dense_hbm_in_use() is at most the budget
    plus the newest block and the blocks whose settlement is pending."""
    from vega_tpu_torch import kernels

    ctx = vt.Context(n_shards=N_SHARDS, dense_hbm_budget=LIFETIME_BUDGET)
    orig = dense_rdd._lifetime_register
    stats = dict(registered=0, evicted=0, max_in_use=0, max_over=0)

    def checked(rdd):
        lru = rdd.context._dense_block_lru
        before = [nd for nd in (ref() for ref in lru.values())
                  if nd is not None and nd._block is not None]
        orig(rdd)
        live = [nd for nd in (ref() for ref in lru.values())
                if nd is not None and nd._block is not None]
        stats["registered"] += 1
        stats["evicted"] += sum(1 for nd in before if nd._block is None)
        in_use = dense_rdd.dense_hbm_in_use(rdd.context)
        spared = sum(nd._block.nbytes for nd in live
                     if nd is rdd or nd._block.settle is not None)
        stats["max_in_use"] = max(stats["max_in_use"], in_use)
        stats["max_over"] = max(stats["max_over"],
                                in_use - LIFETIME_BUDGET)
        p8_check(f"dense_hbm_in_use() {in_use} B past the budget "
                 f"{LIFETIME_BUDGET} B plus the newest and pending blocks "
                 f"({spared} B)", in_use <= LIFETIME_BUDGET + spared)

    def pipeline_on(source):
        kv = source.map(lambda x: (x % N_KEYS, x * 0.5))
        reduced = kv.reduce_by_key(op="add")
        table = ctx.dense_from_numpy(np.arange(N_KEYS, dtype=np.int32),
                                     np.arange(N_KEYS, dtype=np.float32) * 2)
        return kv, reduced, reduced.join(table)

    budget = f"{LIFETIME_BUDGET} B"
    dense_rdd._lifetime_register = checked
    try:
        src = ctx.dense_range(N_ROWS)
        rows = stream.planned_chunk_rows(N_ROWS, 4, LIFETIME_BUDGET,
                                         n_shards=N_SHARDS,
                                         exchange=ctx.dense_exchange)
        p8_check(f"bench-main's source streams under a {LIFETIME_BUDGET} B "
                 "budget", isinstance(src, stream.StreamedDenseRDD)
                 and src.n_chunks == -(-N_ROWS // rows) >= 2)
        t0 = time.perf_counter()
        _, _, joined = pipeline_on(src)
        check_numpy(np, joined, f"8e streamed bench-main at {budget}")
        streamed_s = time.perf_counter() - t0
        del joined

        res = src.resident()
        kv, reduced, joined = pipeline_on(res)
        blk = kv.block()
        mask = kernels.valid_mask(blk.capacity, blk.counts)
        held = {nm: c[mask].clone() for nm, c in blk.cols.items()}
        del blk
        check_numpy(np, joined, f"8e resident bench-main at {budget}")
        other = res.map(lambda x: (x % N_KEYS, x * 1.5))
        other.block()
        p8_check("the held mapped block was evicted", kv._block is None)
        blk = kv.block()
        mask = kernels.valid_mask(blk.capacity, blk.counts)
        p8_check("the evicted block rematerialized with equal rows",
                 all(bool(torch.equal(blk.cols[nm][mask], c))
                     for nm, c in held.items()))
        del blk, mask, held
        again = reduced.join(ctx.dense_from_numpy(
            np.arange(N_KEYS, dtype=np.int32),
            np.arange(N_KEYS, dtype=np.float32) * 2))
        check_numpy(np, again, f"8e rejoin after eviction at {budget}")
        before = ctx.dense_hbm_in_use()
        nbytes = again.block().nbytes
        p8_check("the rejoined block is tracked", again._block is not None)
        again.unpersist()
        after = ctx.dense_hbm_in_use()
        p8_check(f"unpersist() dropped {before - after} B of "
                 f"dense_hbm_in_use(), the block holds {nbytes} B",
                 before - after == nbytes and again._block is None)
        p8_check(f"at least one eviction ({stats['evicted']})",
                 stats["evicted"] >= 1)
    finally:
        dense_rdd._lifetime_register = orig
        ctx.stop()
    out = dict(stats, budget=LIFETIME_BUDGET, chunks=src.n_chunks,
               streamed_s=streamed_s, unpersist_bytes=nbytes)
    log(f"8e lifetime at {LIFETIME_BUDGET} B: {out}")
    torch.cuda.empty_cache()
    return out


def p8_range_bucket(torch, np):
    """(f) kernels.range_bucket of float32 subnormal keys and bounds on
    the card against the port's CPU result (and numpy's IEEE order),
    exactly, both directions."""
    from vega_tpu_torch import kernels

    tiny = np.finfo(np.float32).tiny
    sub = np.array([1e-45, 1e-42, 1e-40, 5e-39, 1.1e-38], np.float32)
    keys = np.concatenate([sub, -sub, [0.0, -0.0, tiny, -tiny, 1.0, -1.0]]
                          ).astype(np.float32)
    keys = np.tile(keys, 8 * 64)[:8 * 512].reshape(8, 512)
    out = {}
    for ascending in (True, False):
        bounds = np.array([-1e-40, -1e-45, 0.0, 1e-45, 1e-42, 5e-39, tiny],
                          np.float32)
        if not ascending:
            bounds = bounds[::-1].copy()
        cpu = kernels.range_bucket(torch.from_numpy(bounds),
                                   torch.from_numpy(keys), ascending)
        card = kernels.range_bucket(torch.from_numpy(bounds).cuda(),
                                    torch.from_numpy(keys).cuda(), ascending)
        flip = 1 if ascending else -1
        ieee = np.searchsorted(flip * bounds, flip * keys.reshape(-1))
        p8_check(f"range_bucket of subnormals (ascending={ascending}) on "
                 "the card equals the CPU result and IEEE order",
                 bool(torch.equal(card.cpu(), cpu))
                 and np.array_equal(cpu.reshape(-1).numpy(), ieee))
        out["ascending" if ascending else "descending"] = int(
            (keys != 0).sum())
    log(f"8f range_bucket subnormals: card == CPU == IEEE ({out} "
        "nonzero keys per direction)")
    return out


def phase_eight(torch, np, ck, vt):
    """Phase 8 in a fresh Context(n_shards=8) at the default budget under
    a forced all_to_all (the legacy chunking, 6 chunks; phase 9b
    runs (a) under the planner): (a) the 1B group_by+join, (b)
    take_ordered / top, (c) the streamed join, (d) the checkpoints; then
    (e) the lifetime in a 256 MiB Context and (f) the range_bucket
    subnormals."""
    from vega_tpu_torch import dense_rdd, stream

    ctx = vt.Context(n_shards=N_SHARDS, dense_exchange="all_to_all")
    src = ctx.dense_range(P8_ROWS)
    p8_check(f"dense_range(1e9) is a StreamedDenseRDD of {P8_CHUNKS} chunks "
             f"of {P8_CHUNK_ROWS} rows at the default budget under a forced "
             "all_to_all",
             isinstance(src, stream.StreamedDenseRDD)
             and src.n_chunks == P8_CHUNKS
             and stream.planned_chunk_rows(P8_ROWS, 4, ctx.dense_hbm_budget)
             == P8_CHUNK_ROWS)
    north, reduced = p8_north_star(torch, np, ck, stream, ctx, src)
    order = p8_order_stats(torch, src)
    enrich = p8_enrichment_join(torch, np, ck, src, ctx)
    checkpoints = p8_checkpoints(torch, np, stream, ctx, reduced)
    del reduced
    ctx.stop()
    torch.cuda.empty_cache()
    lifetime = p8_lifetime(torch, np, vt, dense_rdd, stream)
    subnormals = p8_range_bucket(torch, np)
    return dict(north_star=north, order=order, join=enrich,
                checkpoints=checkpoints, lifetime=lifetime,
                range_bucket=subnormals, launches=north["launches"])


# ---------------------------------------------------------------------------
# phase 9: the exchange planner's programs, stream-1b under the planner,
# string columns
# ---------------------------------------------------------------------------

P9_PROGRAMS = ("all_to_all", "staged", "ring")
P9_CHUNKS = 5                  # the reference planner's count for 1e9 rows
P9_CHUNK_ROWS = 221_249_536    # at 4 GiB, 8 shards, 4-byte rows
P9_STR_ROWS = 10_000_000
P9_VOCAB = 100_000             # sku-%06d words
P9_DIMS = 100_000              # dims rows; half of their words shared
P9_RELOAD_CHUNK_ROWS = 25_000  # (d): 4 chunks of the 100,000 sums
P9_NPZ_DIR = os.path.join("chiprun_out", "phase9_npz")


def p9_check(what, ok):
    if not ok:
        fail(f"phase 9: {what}")


class _ExchangeMeter:
    """Wraps exchange_plan.exchange_callable while installed: each planned
    exchange call records its plan, its capacities and the allocator's
    peak during the call above what was allocated when it began (the
    measured exchange peak; the peak statistic is reset at each call's
    start, and the peak before it kept, so the step's peak is the larger
    of those and the peak after the last call)."""

    def __init__(self, torch, exchange_plan):
        self.torch = torch
        self.mod = exchange_plan
        self.calls = []
        self.peak_before = 0

    def __enter__(self):
        torch, orig = self.torch, self.mod.exchange_callable
        self._orig = orig

        def wrapped(plan):
            fn = orig(plan)

            def measured(cols, count, bucket, n, slot, out_cap, **kw):
                self.peak_before = max(self.peak_before,
                                       torch.cuda.max_memory_allocated())
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = fn(cols, count, bucket, n, slot, out_cap, **kw)
                self.calls.append(dict(
                    program=plan.program, group=plan.group,
                    rounds=plan.rounds, est_peak_bytes=plan.est_peak_bytes,
                    fits=plan.fits, budget_bytes=plan.budget_bytes,
                    capacity=int(bucket.shape[1]), slot=int(slot),
                    out=int(out_cap), row_bytes=sum(
                        c.element_size() for c in cols.values()),
                    base_bytes=base,
                    peak_above_bytes=torch.cuda.max_memory_allocated()
                    - base))
                return out
            return measured

        self.mod.exchange_callable = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.exchange_callable = self._orig
        return False

    def largest(self):
        return max(self.calls, key=lambda c: c["est_peak_bytes"])


def p9_gbk(ctx, src):
    return src.map(lambda x: (x % N_KEYS, x)).group_by_key()


def p9_rbk_join(ctx, src, table):
    return (src.map(lambda x: (x % N_KEYS, x)).reduce_by_key(op="add")
            .join(table))


def p9_gbk_result(torch, np, node):
    """group_by_key's block as order-free sums (the programs deliver a
    key's rows in different orders) and exact per-shard keys: counts,
    the key column of each shard (key-sorted), sum(v) and sum((k *
    2654435761 + v) mod 2^32), all on the card."""
    from vega_tpu_torch import kernels

    blk = node.block()
    mask = kernels.valid_mask(blk.capacity, blk.counts)
    k = blk.cols["k"][mask].to(torch.int64)
    vv = blk.cols["v"][mask].to(torch.int64)
    mix = ((k * 2654435761 + vv) & 0xFFFFFFFF).sum().item()
    return dict(groups=node.count(), counts=blk.counts_np.tolist(),
                keys=blk.cols["k"][mask].clone(), sum_v=vv.sum().item(),
                mix=mix)


def p9_gbk_expected(np):
    x = np.arange(N_ROWS, dtype=np.int64)
    k = x % N_KEYS
    return dict(groups=N_KEYS, sum_v=int(x.sum()),
                mix=int(((k * 2654435761 + x) & 0xFFFFFFFF).sum()))


def p9_rbk_result(torch, np, node):
    got = node.collect_arrays()
    o = np.argsort(got["k"])
    return dict(k=got["k"][o], lv=got["lv"][o], rv=got["rv"][o],
                count=node.count())


def p9_rbk_expected(np):
    # x = k + K j, j < N / K: sum = (N / K) k + K (N / K)(N / K - 1) / 2
    k = np.arange(N_KEYS, dtype=np.int64)
    per = N_ROWS // N_KEYS
    return dict(k=k, lv=per * k + N_KEYS * per * (per - 1) // 2, rv=2 * k)


def p9_leg(torch, np, ck, vt, exchange_plan, label, program, budget,
           pipeline):
    """One program of one pipeline in a fresh Context(n_shards=8,
    dense_table_plan="off", dense_exchange=program, dense_hbm_budget=
    budget): the source held (resident); a cold run with every planned
    exchange measured (_ExchangeMeter) and the step's peak above the
    pre-step allocation; its result; then three warm runs, host clock to
    a synchronize."""
    ctx = vt.Context(n_shards=N_SHARDS, dense_table_plan="off",
                     dense_exchange=program, dense_hbm_budget=budget)
    src = ctx.dense_range(N_ROWS, chunk_rows=N_ROWS)  # resident
    table = p8_table(ctx, np)

    def run():
        if pipeline == "gbk":
            node = p9_gbk(ctx, src)
            return node, node.count()
        node = p9_rbk_join(ctx, src, table)
        return node, node.count()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    with _ExchangeMeter(torch, exchange_plan) as meter:
        t0 = time.perf_counter()
        node, count = run()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    step_peak = max(meter.peak_before,
                    torch.cuda.max_memory_allocated()) - base
    launches = dict(ck.LAUNCHES)
    check_launched(launches, f"phase 9a {pipeline} {label}")
    p9_check(f"9a {pipeline} {label}: count() = {count}, expected "
             f"{N_KEYS}", count == N_KEYS)
    p9_check(f"9a {pipeline} {label}: every planned exchange ran "
             f"{program}", meter.calls and all(
                 c["program"] == program for c in meter.calls))
    result = (p9_gbk_result(torch, np, node) if pipeline == "gbk"
              else p9_rbk_result(torch, np, node))
    del node
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node, c = run()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        p9_check(f"9a {pipeline} {label} warm count() = {c}", c == N_KEYS)
        del node
    big = meter.largest()
    res = dict(label=label, pipeline=pipeline, program=program,
               budget=budget, plan={k: big[k] for k in (
                   "program", "group", "rounds", "est_peak_bytes", "fits",
                   "capacity", "slot", "out", "row_bytes")},
               launches_planned=len(meter.calls),
               exchange_peak_bytes=max(c["peak_above_bytes"]
                                       for c in meter.calls),
               model_peak_bytes=N_SHARDS * big["est_peak_bytes"],
               step_peak_bytes=step_peak, cold_s=cold_s, warm_ms=warm,
               median_ms=statistics.median(warm),
               rows_per_s=N_ROWS / (statistics.median(warm) / 1e3),
               launches=launches)
    ctx.stop()
    torch.cuda.empty_cache()
    return res, result


def p9_programs(torch, np, ck, vt):
    """(a) each pipeline under forced all_to_all, forced staged at a
    budget below the all_to_all estimate of its largest launch (half way
    to ring's, so the staged search picks a group of 2 or more), and
    forced ring; every leg equal to the all_to_all leg and to numpy; the
    measured exchange peaks ordered all_to_all > staged >= ring. The
    plan's capacities and row bytes are the largest launch's: the
    recorded row bytes are those the exchange moved (after the map), the
    planner's those of the root block."""
    from vega_tpu_torch import exchange_plan

    gbk_exp, rbk_exp = p9_gbk_expected(np), p9_rbk_expected(np)
    lines = []
    for pipeline in ("gbk", "rbk_join"):
        legs, results = {}, {}
        # staged last: its budget lies half way between the estimates the
        # all_to_all and ring legs planned for their largest launch (the
        # planner's row bytes are the root block's, before the map)
        for program in ("all_to_all", "ring", "staged"):
            budget = 4 << 30
            if program == "staged":
                budget = (legs["ring"]["plan"]["est_peak_bytes"]
                          + legs["all_to_all"]["plan"]["est_peak_bytes"]) // 2
            legs[program], results[program] = p9_leg(
                torch, np, ck, vt, exchange_plan, f"{pipeline}/{program}",
                program, budget, pipeline)
            log(f"9a {pipeline} {program}: {json.dumps(legs[program])}")
        p9_check(f"9a {pipeline}: staged chose a group of 2 or more and "
                 "more than one round under a budget below all_to_all's",
                 legs["staged"]["plan"]["group"] >= 2
                 and legs["staged"]["plan"]["rounds"] > 1
                 and legs["staged"]["budget"]
                 < legs["all_to_all"]["plan"]["est_peak_bytes"])
        ref = results["all_to_all"]
        for program, got in results.items():
            if pipeline == "gbk":
                same = (got["groups"] == ref["groups"] == gbk_exp["groups"]
                        and got["counts"] == ref["counts"]
                        and bool(torch.equal(got["keys"], ref["keys"]))
                        and got["sum_v"] == ref["sum_v"] == gbk_exp["sum_v"]
                        and got["mix"] == ref["mix"] == gbk_exp["mix"])
            else:
                same = (got["count"] == N_KEYS and all(
                    np.array_equal(got[nm], ref[nm])
                    and np.array_equal(got[nm].astype(np.int64),
                                       rbk_exp[nm])
                    for nm in ("k", "lv", "rv")))
            p9_check(f"9a {pipeline} {program} equals the all_to_all leg "
                     "and numpy", same)
        peaks = {p: legs[p]["exchange_peak_bytes"] for p in P9_PROGRAMS}
        p9_check(f"9a {pipeline}: measured exchange peak ordered all_to_all "
                 f"> staged >= ring: {peaks}",
                 peaks["all_to_all"] > peaks["staged"] >= peaks["ring"])
        lines += [legs[p] for p in P9_PROGRAMS]
        del results, ref
    return lines


def p9_strings_data(np):
    rng = np.random.RandomState(9)
    vocab = np.array([f"sku-{i:06d}" for i in range(P9_VOCAB)])
    idx = rng.randint(0, P9_VOCAB, size=P9_STR_ROWS)
    idx[:P9_VOCAB] = np.arange(P9_VOCAB)  # every word occurs
    vals = rng.randint(0, 100, size=P9_STR_ROWS).astype(np.int32)
    # dims: the upper half of the vocabulary and as many new words
    lo = P9_VOCAB // 2
    dims_k = np.array([f"sku-{i:06d}" for i in range(lo, lo + P9_DIMS)])
    dims_v = np.arange(P9_DIMS, dtype=np.int32)
    return dict(vocab=vocab, idx=idx, keys=vocab[idx], vals=vals,
                dims_k=dims_k, dims_v=dims_v)


def p9_strings_expected(np, data):
    sums = np.bincount(data["idx"], weights=data["vals"],
                       minlength=P9_VOCAB).astype(np.int64)
    lo = P9_VOCAB // 2
    shared = np.arange(lo, P9_VOCAB)
    return dict(k=data["vocab"][shared], lv=sums[shared],
                rv=(shared - lo).astype(np.int64), sums=sums)


def p9_strings(torch, np, ck, vt):
    """(c) benchmarks/strings_ab.py's query on the card: reduce_by_key
    (add) on 10M rows of string keys over 100,000 words -> join with a
    100,000-row dims table (half its words shared) -> sort_by_key ->
    collect; the host encode and each device step timed apart (cold, then
    two warm runs); the merged dictionary (150,000 words) past the
    default 65,536-entry remap table takes a doubling retry on each side;
    exact against numpy. (d) the reduced block through save_npz /
    dense_load_npz, streamed in 4 chunks, exact."""
    from vega_tpu_torch import dense_rdd

    data = p9_strings_data(np)
    exp = p9_strings_expected(np, data)
    ctx = vt.Context(n_shards=N_SHARDS)
    runs = []
    for i in range(3):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        fact = ctx.dense_from_numpy(data["keys"], data["vals"])
        dims = ctx.dense_from_numpy(data["dims_k"], data["dims_v"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reduced = fact.reduce_by_key(op="add")
        reduced.block()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        joined = reduced.join(dims)
        joined.block()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        srt = joined.sort_by_key()
        srt.block()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rows = srt.collect()
        t5 = time.perf_counter()
        unify = [nd for nd in (joined.left, joined.right)
                 if isinstance(nd, dense_rdd._DictUnifyRDD)]
        retries = [nd._dict_retries for nd in unify]
        runs.append(dict(encode_ms=(t1 - t0) * 1e3,
                         reduce_ms=(t2 - t1) * 1e3, join_ms=(t3 - t2) * 1e3,
                         sort_ms=(t4 - t3) * 1e3,
                         collect_ms=(t5 - t4) * 1e3,
                         device_ms=(t4 - t1) * 1e3, total_s=t5 - t0,
                         retries=retries, launches=dict(ck.LAUNCHES)))
        p9_check(f"9c run {i}: both join sides remapped onto the merged "
                 f"dictionary, each with a capacity retry ({retries})",
                 len(unify) == 2 and all(r >= 1 for r in retries)
                 and len(joined._dicts()["k"]) == P9_VOCAB + P9_DIMS // 2)
        if i == 0:
            check_launched(runs[0]["launches"], "phase 9c's cold run")
            keys = np.array([r[0] for r in rows])
            p9_check("9c: the sorted joined rows equal numpy (keys, sums, "
                     "dims values)",
                     len(rows) == len(exp["k"])
                     and np.array_equal(keys, exp["k"])
                     and np.array_equal(np.array([r[1] for r in rows]),
                                        exp["lv"])
                     and np.array_equal(np.array([r[2] for r in rows]),
                                        exp["rv"]))
            kept = reduced
        else:
            p9_check(f"9c run {i}: rows equal the cold run's",
                     len(rows) == len(exp["k"]) and rows[0][0] == exp["k"][0]
                     and rows[-1][1] == exp["lv"][-1])
        del fact, dims, joined, srt, rows, unify
    reload = p9_reload(np, ctx, kept, exp, data["vocab"])
    ctx.stop()
    del kept
    torch.cuda.empty_cache()
    warm = runs[1:]
    res = dict(rows=P9_STR_ROWS, vocab=P9_VOCAB, dims=P9_DIMS,
               merged_words=P9_VOCAB + P9_DIMS // 2, runs=runs,
               median_encode_ms=statistics.median(r["encode_ms"]
                                                  for r in warm),
               median_device_ms=statistics.median(r["device_ms"]
                                                  for r in warm),
               median_total_s=statistics.median(r["total_s"] for r in warm),
               reload=reload)
    log(f"9c strings: {json.dumps(res)}")
    return res


def p9_reload(np, ctx, reduced, exp, vocab):
    """(d) the reduced string block saved and reloaded in 4 chunks."""
    from vega_tpu_torch import stream

    os.makedirs(P9_NPZ_DIR, exist_ok=True)
    path = os.path.join(P9_NPZ_DIR, "strings.npz")
    try:
        t0 = time.perf_counter()
        reduced.save_npz(path)
        st = ctx.dense_load_npz(path, chunk_rows=P9_RELOAD_CHUNK_ROWS)
        p9_check("9d: the reload streams in 4 chunks",
                 isinstance(st, stream.StreamedDenseRDD)
                 and st.n_chunks == 4)
        got = st.reduce_by_key(op="add").collect_arrays()
        o = np.argsort(got["k"])
        p9_check("9d: the streamed reload's sums equal numpy per word",
                 got["k"].dtype.kind == "U"
                 and np.array_equal(got["k"][o], vocab)
                 and np.array_equal(got["v"][o].astype(np.int64),
                                    exp["sums"]))
        out = dict(rows=int(len(o)), chunks=st.n_chunks,
                   bytes=os.path.getsize(path),
                   ms=(time.perf_counter() - t0) * 1e3)
    finally:
        if os.path.exists(path):
            os.remove(path)
    log(f"9d string checkpoint: {out}")
    return out


def phase_nine(torch, np, ck, vt):
    """Phase 9: (a) the programs at bench-main scale, (b) stream-1b under
    dense_exchange="auto" (the planner's 5 chunks), (c) the string query
    and (d) its checkpoint. Launches are counted over the whole phase."""
    from vega_tpu_torch import stream

    launches = {name: 0 for name in ck.LAUNCHES}

    def add(d):
        for name, c in d.items():
            launches[name] += c

    programs = p9_programs(torch, np, ck, vt)
    for r in programs:
        add(r["launches"])
    ctx = vt.Context(n_shards=N_SHARDS)
    src = ctx.dense_range(P8_ROWS)
    p9_check(f"9b: under auto, dense_range(1e9) streams in {P9_CHUNKS} "
             f"chunks of {P9_CHUNK_ROWS} rows (the reference planner's)",
             ctx.dense_exchange == "auto"
             and isinstance(src, stream.StreamedDenseRDD)
             and src.n_chunks == P9_CHUNKS
             and stream.planned_chunk_rows(
                 P8_ROWS, 4, ctx.dense_hbm_budget, n_shards=N_SHARDS)
             == P9_CHUNK_ROWS)
    north, reduced = p8_north_star(torch, np, ck, stream, ctx, src,
                                   chunks=P9_CHUNKS,
                                   chunk_rows=P9_CHUNK_ROWS, label="9b")
    north["exchange_plans"] = ctx.exchange_plans()
    for r in [dict(launches=north["launches"])] + [
            dict(launches=w) for w in north["warm_launches"]]:
        add(r["launches"])
    del reduced, src
    ctx.stop()
    torch.cuda.empty_cache()
    strings = p9_strings(torch, np, ck, vt)
    for r in strings["runs"]:
        add(r["launches"])
    return dict(programs=programs, north_star=north, strings=strings,
                launches=launches)


P10_ROWS = 20_000_000          # frame_ab.py's events table at bench-main's size
P10_KEYS = 1_000_000           # k uniform in [0, P10_KEYS); the dims rows
P10_THRESHOLD = 600            # x < 600 keeps ~60% (frame_ab.py FILTER_FRAC)
P10_LEGS = ("rdd_chain", "unfused", "fused")
# 10c is smaller than 10a because the host encode (np.unique over the
# strings) took 7.1-8.1 s per 10M strings on the card's machine (phase 9c,
# PERF.md section 6): 2M rows keep it near 1.5 s a run
P10_STR_ROWS = 2_000_000
P10_VOCAB = 100_000            # sku-%06d words, every one occurring
P10_STR_DIMS = 100_000         # dims rows; half of their words shared


def p10_check(what, ok):
    if not ok:
        fail(f"phase 10: {what}")


class _FrameTimer:
    """While installed, times (host clock, from a synchronize to a
    synchronize, so device work queued before is not counted) each
    frame compile (planner.compile_plan: plan algebra, dtype checks, the
    string encode of a join's unification, the stage probes) and each
    columns source's materialization (the astype / encode and
    block.from_numpy onto the card), and separately each string encode:
    the host build of a frame run, apart from its device steps."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = dict(compile=0.0, source=0.0, encode=0.0)

    def _wrap(self, owner, name, key):
        orig = getattr(owner, name)
        torch, ms = self.torch, self.ms

        def timed(*a, **kw):
            torch.cuda.synchronize()  # device work queued before is not ours
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                ms[key] += (time.perf_counter() - t0) * 1e3
        setattr(owner, name, timed)
        self._saved.append((owner, name, orig))

    def __enter__(self):
        from vega_tpu_torch.frame import api, physical

        self._saved = []
        self._wrap(api.planner_lib, "compile_plan", "compile")
        self._wrap(physical._ColumnsSource, "_materialize", "source")
        self._wrap(physical._ColumnsSource, "_encode", "encode")
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False


def p10_data(np):
    """benchmarks/frame_ab.py's tables at P10_ROWS: events of 6 int64
    columns (k uniform in [0, P10_KEYS), x in [0, 1000), 4 pads in
    [0, 2^20)); dims of P10_KEYS rows, k = arange, y = (k * 2654435761)
    % 997."""
    rng = np.random.default_rng(7)
    ev = {"k": rng.integers(0, P10_KEYS, P10_ROWS),
          "x": rng.integers(0, 1000, P10_ROWS)}
    for i in range(4):
        ev[f"pad{i}"] = rng.integers(0, 1 << 20, P10_ROWS)
    dk = np.arange(P10_KEYS, dtype=np.int64)
    return ev, {"k": dk, "y": (dk * 2654435761) % 997}


def p10_expected(np, ev, dims):
    keep = ev["x"] < P10_THRESHOLD
    k, x = ev["k"][keep], ev["x"][keep]
    counts = np.bincount(k, minlength=P10_KEYS)
    sums = np.bincount(k, weights=x, minlength=P10_KEYS).astype(np.int64)
    keys = np.flatnonzero(counts)
    return {"k": keys, "sx": sums[keys], "sy": dims["y"][keys]}


def p10_query(ctx, ev, dims):
    """The frame_ab query: filter -> group_by(k).agg(sum(x)) -> join
    dims.group_by(k).agg(sum(y)) on k -> sort(k)."""
    from vega_tpu_torch.frame import F, col

    e = ctx.create_frame(ev)
    d = ctx.create_frame(dims)
    return (e.filter(col("x") < P10_THRESHOLD)
            .group_by("k").agg(F.sum("x", "sx"))
            .join(d.group_by("k").agg(F.sum("y", "sy")), on="k")
            .sort("k"))


def p10_rdd_chain(torch, np, ctx, ev, dims):
    """frame_ab.py's hand-written leg over the port: the two needed
    columns narrowed by hand, dense_from_columns + filter + reduce_by_key
    + join + sort_by_key. Returns (columns, host build ms)."""
    t0 = time.perf_counter()
    src = ctx.dense_from_columns({"k": ev["k"].astype(np.int32),
                                  "x": ev["x"].astype(np.int32)}, key="k")
    right_src = ctx.dense_from_columns(
        {"k": dims["k"].astype(np.int32), "y": dims["y"].astype(np.int32)},
        key="k")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    xi = src.columns.index("x")  # key= moves "k" to the schema tail
    left = (src.filter(lambda row: row[xi] < P10_THRESHOLD)
            .reduce_by_key(op="add").rename({"x": "v"}))
    right = right_src.reduce_by_key(op="add").rename({"y": "v"})
    out = left.join(right).sort_by_key().collect_arrays()
    return {"k": out["k"], "sx": out["lv"], "sy": out["rv"]}, build_ms


def p10_run(torch, ck, ctx, leg, run):
    """One run of one leg: launches counted from 0, the allocator's peak
    above what was allocated at its start, the whole wall (host clock,
    ending in a synchronize) and the host build apart."""
    torch.cuda.synchronize()
    ck.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _FrameTimer(torch) as timer:
        t0 = time.perf_counter()
        out, build_ms = run()
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
    if build_ms is None:  # a frame leg: the compile and the sources
        build_ms = timer.ms["compile"] + timer.ms["source"]
    return out, dict(leg=leg, ms=whole, host_build_ms=build_ms,
                     device_ms=whole - build_ms, encode_ms=timer.ms["encode"],
                     peak_bytes=torch.cuda.max_memory_allocated() - base,
                     launches=dict(ck.LAUNCHES))


def p10_frame_ab(torch, np, ck, vt, ev, dims, exp):
    """(a) the three legs, each once cold (checked: bit-identical to one
    another and equal to numpy), then three interleaved warm rounds."""
    from vega_tpu_torch import exchange_plan

    ctx = vt.Context(n_shards=N_SHARDS)
    legs = {
        "rdd_chain": lambda: p10_rdd_chain(torch, np, ctx, ev, dims),
        "unfused": lambda: (p10_query(ctx, ev, dims).hint(
            fuse=False, pushdown=False).collect_columns(), None),
        "fused": lambda: (p10_query(ctx, ev, dims).collect_columns(), None),
    }
    cold, outs = {}, {}
    for leg in P10_LEGS:
        outs[leg], cold[leg] = p10_run(torch, ck, ctx, leg, legs[leg])
    for leg in P10_LEGS:
        got = outs[leg]
        p10_check(f"10a {leg}: columns equal numpy (k, sx, sy)",
                  all(np.array_equal(got[nm], exp[nm])
                      for nm in ("k", "sx", "sy")))
        p10_check(f"10a {leg}: bit-identical to rdd_chain",
                  all(got[nm].dtype == outs["rdd_chain"][nm].dtype
                      and np.array_equal(got[nm], outs["rdd_chain"][nm])
                      for nm in ("k", "sx", "sy")))
    del outs
    for name in ("hash_bucket", "digit_hist"):
        p10_check(f"10a fused leg launched {name} "
                  f"({cold['fused']['launches']})",
                  cold["fused"]["launches"][name] > 0)
    warm = {leg: [] for leg in P10_LEGS}
    for _ in range(3):
        for leg in P10_LEGS:  # interleaved: drift hits every leg alike
            out, r = p10_run(torch, ck, ctx, leg, legs[leg])
            p10_check(f"10a {leg} warm: {len(out['k'])} rows",
                      len(out["k"]) == len(exp["k"]))
            warm[leg].append(r)
            del out
    explain = p10_query(ctx, ev, dims).explain().replace("\n", " | ")
    pred = exchange_plan.predict_for_rows(P10_ROWS, 8, N_SHARDS,
                                          ctx.dense_hbm_budget)
    plans = ctx.exchange_plans()
    ctx.stop()
    torch.cuda.empty_cache()
    res = dict(rows=P10_ROWS, keys=P10_KEYS, out_rows=int(len(exp["k"])),
               explain=explain, planner_prediction=dict(
                   program=pred.program, est_peak_bytes=pred.est_peak_bytes,
                   budget=ctx.dense_hbm_budget),
               exchange_plans=plans, legs={})
    for leg in P10_LEGS:
        med = statistics.median(r["ms"] for r in warm[leg])
        res["legs"][leg] = dict(
            cold=cold[leg], warm=warm[leg], median_ms=med,
            rows_per_s=P10_ROWS / (med / 1e3),
            median_host_build_ms=statistics.median(
                r["host_build_ms"] for r in warm[leg]),
            median_device_ms=statistics.median(
                r["device_ms"] for r in warm[leg]),
            peak_bytes=max(r["peak_bytes"] for r in warm[leg]),
            warm_launches=warm[leg][0]["launches"])
        log(f"10a {leg}: {json.dumps(res['legs'][leg])}")
    log(f"10a explain: {explain}")
    return res


def p10_mixed(torch, np, ck, vt, ev):
    """(b) group_by(k).agg(sum, min, max, count, mean of x): the traced
    tuple combiner; integers exact, the mean within rtol 1e-5."""
    from vega_tpu_torch.frame import F

    order = np.sort(ev["k"] * 1024 + ev["x"])  # one sort: runs by key
    ks, xs = order >> 10, order & 1023
    heads = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    tails = np.r_[heads[1:], len(ks)] - 1
    keys = ks[heads]
    cnt = np.bincount(ev["k"], minlength=P10_KEYS)[keys]
    total = np.bincount(ev["k"], weights=ev["x"],
                        minlength=P10_KEYS).astype(np.int64)[keys]
    exp = dict(k=keys, sum_x=total, min_x=xs[heads], max_x=xs[tails],
               count=cnt, mean_x=total / cnt)
    del order, ks, xs
    ctx = vt.Context(n_shards=N_SHARDS)

    def run():
        q = ctx.create_frame(k=ev["k"], x=ev["x"]).group_by("k").agg(
            F.sum("x"), F.min("x"), F.max("x"), F.count(), F.mean("x"))
        return q.collect_columns(), None

    out, cold = p10_run(torch, ck, ctx, "mixed", run)
    o = np.argsort(out["k"])
    got = {nm: c[o] for nm, c in out.items()}
    p10_check("10b: keys, sum, min, max and count equal numpy exactly",
              all(np.array_equal(got[nm], exp[nm])
                  for nm in ("k", "sum_x", "min_x", "max_x", "count")))
    rel = float(np.max(np.abs(got["mean_x"] - exp["mean_x"])
                       / np.abs(exp["mean_x"]).clip(1e-30)))
    p10_check(f"10b: mean within rtol 1e-5 of numpy (max rel err {rel})",
              np.allclose(got["mean_x"], exp["mean_x"], rtol=1e-5, atol=0))
    del out, got
    explain = ctx.create_frame(k=ev["k"][:8], x=ev["x"][:8]).group_by(
        "k").agg(F.sum("x"), F.min("x"), F.max("x"), F.count(),
                 F.mean("x")).explain()
    p10_check("10b takes the traced tuple combiner",
              "tuple combiner" in explain)
    warm = [p10_run(torch, ck, ctx, "mixed", run)[1] for _ in range(3)]
    ctx.stop()
    torch.cuda.empty_cache()
    med = statistics.median(r["ms"] for r in warm)
    res = dict(rows=P10_ROWS, keys=int(len(keys)), cold=cold, warm=warm,
               median_ms=med, rows_per_s=P10_ROWS / (med / 1e3),
               median_host_build_ms=statistics.median(
                   r["host_build_ms"] for r in warm),
               median_device_ms=statistics.median(
                   r["device_ms"] for r in warm),
               mean_max_rel_err=rel, launches=cold["launches"])
    log(f"10b mixed aggregates: {json.dumps(res)}")
    return res


def p10_strings(torch, np, ck, vt):
    """(c) P10_STR_ROWS rows of sku-%06d keys over P10_VOCAB words,
    group_by(w).agg(sum(x)) joined to a P10_STR_DIMS-row dims frame on
    the string key (the upper half of the vocabulary and as many new
    words), sorted; exact against numpy. The host encode apart."""
    from vega_tpu_torch.frame import F

    rng = np.random.RandomState(10)
    vocab = np.array([f"sku-{i:06d}" for i in range(P10_VOCAB)])
    idx = rng.randint(0, P10_VOCAB, size=P10_STR_ROWS)
    idx[:P10_VOCAB] = np.arange(P10_VOCAB)
    words = vocab[idx]
    vals = rng.randint(0, 100, size=P10_STR_ROWS)
    lo = P10_VOCAB // 2
    dims_w = np.array([f"sku-{i:06d}" for i in range(lo, lo + P10_STR_DIMS)])
    dims_z = np.arange(P10_STR_DIMS)
    sums = np.bincount(idx, weights=vals, minlength=P10_VOCAB).astype(
        np.int64)
    shared = np.arange(lo, P10_VOCAB)
    exp = dict(w=vocab[shared], sx=sums[shared], z=shared - lo)
    ctx = vt.Context(n_shards=N_SHARDS)

    def run():
        q = (ctx.create_frame(w=words, x=vals).group_by("w")
             .agg(F.sum("x", "sx"))
             .join(ctx.create_frame(w=dims_w, z=dims_z), on="w").sort("w"))
        return q.collect_columns(), None

    out, cold = p10_run(torch, ck, ctx, "strings", run)
    p10_check("10c: the sorted joined rows equal numpy (words, sums, dims "
              "values)", out["w"].dtype.kind == "U"
              and all(np.array_equal(out[nm], exp[nm])
                      for nm in ("w", "sx", "z")))
    del out
    warm = [p10_run(torch, ck, ctx, "strings", run)[1] for _ in range(3)]
    ctx.stop()
    torch.cuda.empty_cache()
    res = dict(rows=P10_STR_ROWS, vocab=P10_VOCAB, dims=P10_STR_DIMS,
               out_rows=int(len(shared)), cold=cold, warm=warm,
               median_ms=statistics.median(r["ms"] for r in warm),
               median_encode_ms=statistics.median(
                   r["encode_ms"] for r in warm),
               median_host_build_ms=statistics.median(
                   r["host_build_ms"] for r in warm),
               median_device_ms=statistics.median(
                   r["device_ms"] for r in warm),
               launches=cold["launches"])
    log(f"10c strings: {json.dumps(res)}")
    return res


def p10_untraceable(torch, np, ck, vt, dense_rdd):
    """(d) an untraceable UDF raises VegaError at explain(), before any
    device work: no chain applied, no kernel launched, nothing
    allocated."""
    from vega_tpu_torch.frame import col, udf

    ctx = vt.Context(n_shards=N_SHARDS)
    df = ctx.create_frame(k=np.arange(1000) % 7, x=np.arange(1000))
    q = df.with_column("m", udf(lambda c: np.asarray(c) + 1, col("x")))
    torch.cuda.synchronize()
    ck.reset_launches()
    mints = dense_rdd.program_mints()
    allocated = torch.cuda.memory_allocated()
    try:
        q.explain()
        raised = None
    except vt.VegaError as e:
        raised = str(e)
    torch.cuda.synchronize()
    p10_check(f"10d: explain() of an untraceable UDF raises VegaError "
              f"({raised})", raised is not None
              and "stage does not trace" in raised)
    p10_check("10d: no device work before the error",
              dense_rdd.program_mints() == mints
              and all(c == 0 for c in ck.LAUNCHES.values())
              and torch.cuda.memory_allocated() == allocated)
    ctx.stop()
    log(f"10d untraceable UDF: {raised}")
    return dict(raised=raised)


def phase_ten(torch, np, ck, vt):
    """Phase 10: the frame layer on the card: (a) frame_ab's three legs at
    20M rows, (b) mixed aggregates, (c) string keys, (d) the untraceable
    UDF. Launches are summed over every run of the phase."""
    from vega_tpu_torch import dense_rdd

    ev, dims = p10_data(np)
    exp = p10_expected(np, ev, dims)
    ab = p10_frame_ab(torch, np, ck, vt, ev, dims, exp)
    del exp
    mixed = p10_mixed(torch, np, ck, vt, ev)
    del ev, dims
    strings = p10_strings(torch, np, ck, vt)
    untraceable = p10_untraceable(torch, np, ck, vt, dense_rdd)
    runs = [r for leg in ab["legs"].values()
            for r in [leg["cold"]] + leg["warm"]]
    runs += [mixed["cold"]] + mixed["warm"]
    runs += [strings["cold"]] + strings["warm"]
    launches = {name: sum(r["launches"][name] for r in runs)
                for name in ck.LAUNCHES}
    return dict(frame_ab=ab, mixed=mixed, strings=strings,
                untraceable=untraceable, launches=launches)


P11_KEYS = (1_000_000, 20_000_000)  # bench-main's keys; every row its own key
P11_PROMOTES = 3                    # promote samples per size (median)
P11_RECOMPUTES = 3                  # recompute samples after unpersist
P11_GF_SHAPES = ((4, 67_108_864), (128, 1_048_576))  # a group of 4; k <= 128
P11_GF_SCHEMES = ("xor", "rs", "masked")
# sha256 of coding._accumulate_np's outputs on RandomState(11) inputs of
# (1, 17), (4, 256), (7, 1023), (128, 64) x the three schemes (p11_gf_small),
# computed once with the reference package on the CPU
P11_GF_DIGEST = \
    "7cba0f652f3ce1c4ad1a05a01a3c5385d08c213a8c750e33b63eb9b28b54abc0"
P11_FOLD_PAIRS = 1_000_000
P11_FOLD_KEYS = 100_000


def p11_check(what, ok):
    if not ok:
        fail(f"phase 11: {what}")


def p11_sums(np, k):
    """float64 per-key sums of x * 0.5 over x < N_ROWS keyed x % k."""
    x = np.arange(N_ROWS, dtype=np.int64)
    return np.bincount(x % k, weights=x * 0.5, minlength=k)


def p11_rows(np, what, got, sums, value="v"):
    """Collected (k, value) columns against numpy: every key of
    [0, len(sums)) exactly once, the sums within rtol 1e-5 (scattered by
    key: a sort of 20M keys would cost seconds per check)."""
    n, keys = len(sums), got["k"].astype(np.int64)
    ok = len(keys) == n and keys.min() >= 0 and keys.max() < n
    if ok:
        seen = np.zeros(n, dtype=bool)
        seen[keys] = True
        ok = bool(seen.all())
    p11_check(f"{what}: keys differ from numpy", ok)
    v = np.empty(n, dtype=np.float64)
    v[keys] = got[value]
    p11_check(f"{what}: sums differ from numpy beyond rtol 1e-5",
              np.allclose(v, sums, rtol=1e-5, atol=0))
    return keys


def p11_none_launched(ck, what):
    moved = {n: c for n, c in ck.LAUNCHES.items() if c}
    p11_check(f"{what} launched {moved}", not moved)


def p11_synced_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def p11_persist(torch, np, ck, vt, dense_rdd, k):
    """(a) at one key count: the persisted reduce demoted under a zero
    budget, promoted with _materialize poisoned and no kernel launched,
    a downstream reduce eliding its exchange, the join with phase 3's
    table, a corrupted snapshot recomputed, unpersist and stop removing
    the snapshot and the session directory; spill / promote / recompute
    ms and the snapshot's bytes."""
    def kv(x):
        return x % k, x * 0.5

    def refuse():
        raise AssertionError("a promoted access recomputed its lineage")

    def evict():
        ctx.dense_hbm_budget = 0
        try:
            dense_rdd._lifetime_evict(ctx)
        finally:
            ctx.dense_hbm_budget = budget
        p11_check(f"K={k}: the zero-budget sweep evicted the node",
                  node._block is None)

    ctx = vt.Context(n_shards=N_SHARDS)
    budget = ctx.dense_hbm_budget
    session = os.path.dirname(ctx._spill.root)
    sums = p11_sums(np, k)
    launches = {name: 0 for name in ck.LAUNCHES}
    try:
        ck.reset_launches()
        node = (ctx.dense_range(N_ROWS).map(kv).reduce_by_key(op="add")
                .persist("MEMORY_AND_DISK"))
        p11_rows(np, f"K={k} cold", node.collect_arrays(), sums)
        block_bytes = node.block().nbytes
        shape = list(node.block().cols["k"].shape)
        for name, c in ck.LAUNCHES.items():
            launches[name] += c
        _, spill_ms = p11_synced_ms(torch, evict)
        st = ctx.spill_status()
        p11_check(f"K={k}: spilled_bytes {st['spilled_bytes']}",
                  st["spilled_bytes"] > 0 and st["spill_count"] == 1)
        snapshot_bytes = st["disk_bytes"]
        key = dense_rdd._dense_spill_key(node)
        path = ctx._spill.path_of(key)

        promote_ms = []
        node._materialize = refuse
        for i in range(P11_PROMOTES):
            if i:
                evict()
            ck.reset_launches()
            _, ms = p11_synced_ms(torch, node.block)
            promote_ms.append(ms)
            p11_rows(np, f"K={k} promoted", node.collect_arrays(), sums)
            p11_none_launched(ck, f"K={k}: the promoted access")
        st = ctx.spill_status()
        p11_check(f"K={k}: promote_count {st['promote_count']}",
                  st["promote_count"] == P11_PROMOTES
                  and st["spill_count"] == 1)
        p11_check(f"K={k}: the promoted node is hash-placed",
                  node.hash_placed and node.key_sorted)
        del node.__dict__["_materialize"]

        ck.reset_launches()
        again = node.reduce_by_key(op="add")
        p11_rows(np, f"K={k} downstream reduce", again.collect_arrays(), sums)
        p11_check(f"K={k}: the downstream reduce planned "
                  f"{again._exchange_plan}", again._exchange_plan is None)
        p11_none_launched(ck, f"K={k}: the downstream reduce")
        ck.reset_launches()
        table = ctx.dense_from_numpy(np.arange(N_KEYS, dtype=np.int32),
                                     np.arange(N_KEYS, dtype=np.float32) * 2)
        got = node.join(table).collect_arrays()
        jkeys = p11_rows(np, f"K={k} join", got, sums[:N_KEYS], value="lv")
        p11_check(f"K={k} join: table values differ from numpy",
                  np.array_equal(got["rv"], jkeys * 2.0))
        for name, c in ck.LAUNCHES.items():
            launches[name] += c
        del again, table, got, jkeys

        # one byte flipped: the checksummed read misses, the node
        # recomputes (its exchange launches again)
        evict()
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
        ck.reset_launches()
        p11_rows(np, f"K={k} after a corrupt snapshot", node.collect_arrays(),
                 sums)
        st = ctx.spill_status()
        p11_check(f"K={k}: the corrupt snapshot counted "
                  f"{st['disk_read_errors']} read errors and "
                  f"{st['promote_count']} promotes",
                  st["disk_read_errors"] == 1
                  and st["promote_count"] == P11_PROMOTES
                  and not os.path.exists(path))
        recomputed = dict(ck.LAUNCHES)
        p11_check(f"K={k}: the corrupt snapshot's recompute launched "
                  f"{recomputed}", any(recomputed.values()))
        for name, c in ck.LAUNCHES.items():
            launches[name] += c
        _, respill_ms = p11_synced_ms(torch, evict)
        p11_check(f"K={k}: the recomputed block demoted afresh",
                  ctx.spill_status()["spill_count"] == 2
                  and os.path.exists(ctx._spill.path_of(key)))
        path = ctx._spill.path_of(key)
        node.unpersist()
        p11_check(f"K={k}: unpersist removed the snapshot",
                  not os.path.exists(path)
                  and ctx.spill_status()["disk_entries"] == 0)

        recompute_ms = []
        for _ in range(P11_RECOMPUTES):
            ck.reset_launches()
            _, ms = p11_synced_ms(torch, node.block)
            recompute_ms.append(ms)
            for name, c in ck.LAUNCHES.items():
                launches[name] += c
            node.unpersist()
        # the warm block (capacities from the cold run's hints) through a
        # demotion and a promotion, with the steps each recorded
        p11_rows(np, f"K={k} recomputed", node.collect_arrays(), sums)
        warm_shape = list(node.block().cols["k"].shape)
        for kind in dense_rdd.SPILL_STEPS:
            dense_rdd.SPILL_STEPS[kind] = {}
        _, warm_spill_ms = p11_synced_ms(torch, evict)
        warm_snapshot_bytes = ctx.spill_status()["disk_bytes"]
        node._materialize = refuse
        ck.reset_launches()
        _, warm_promote_ms = p11_synced_ms(torch, node.block)
        p11_none_launched(ck, f"K={k}: the warm block's promotion")
        parts = {**dense_rdd.SPILL_STEPS["demote"],
                 **dense_rdd.SPILL_STEPS["promote"]}
        p11_check(f"K={k}: the warm demotion and promotion recorded "
                  f"{sorted(parts)}", len(parts) == 6)
        del node.__dict__["_materialize"]
        p11_rows(np, f"K={k} warm block promoted", node.collect_arrays(),
                 sums)
        status = ctx.spill_status()
    finally:
        ctx.stop()
    p11_check(f"K={k}: stop() removed the session directory {session}",
              not os.path.exists(session))
    out = dict(keys=k, rows=N_ROWS, shape=shape, block_bytes=block_bytes,
               snapshot_bytes=snapshot_bytes, spill_ms=spill_ms,
               respill_ms=respill_ms, promote_ms=promote_ms,
               median_promote_ms=statistics.median(promote_ms),
               recompute_ms=recompute_ms,
               median_recompute_ms=statistics.median(recompute_ms),
               warm_shape=warm_shape, warm_spill_ms=warm_spill_ms,
               warm_promote_ms=warm_promote_ms,
               warm_snapshot_bytes=warm_snapshot_bytes, parts=parts,
               status=status, launches=launches)
    log(f"11a K={k}: {out}")
    torch.cuda.empty_cache()
    return out


def p11_gf_coeffs(np, kernels, scheme, n):
    """The coefficients of one scheme: XOR all ones, RS Cauchy entries
    inverse((255 - 0) ^ i) (the port's tables), masked every other
    member."""
    if scheme == "xor":
        return np.ones(n, dtype=np.uint8)
    if scheme == "rs":
        return np.array([kernels.GF_EXP[255 - int(kernels.GF_LOG[255 ^ i])]
                         for i in range(n)], dtype=np.uint8)
    return np.array([(0 if i % 2 else 143) for i in range(n)],
                    dtype=np.uint8)


def p11_gf_twin(np, kernels, blocks, coeffs):
    """numpy twin with the port's tables: member i's 256 products
    exp[log b + log c_i] (zero operands masked), then one lookup per byte
    and an XOR over the members."""
    byte = np.arange(256)
    out = np.zeros(blocks.shape[1], dtype=np.uint8)
    for i, c in enumerate(coeffs):
        row = kernels.GF_EXP[kernels.GF_LOG[byte] + kernels.GF_LOG[int(c)]]
        row[(byte == 0) | (c == 0)] = 0
        out ^= row[blocks[i]]
    return out


def p11_gf_small(np, kernels):
    """The seeded small inputs' digest on the card, numpy in (so the
    entry's default device, the card), against the reference's."""
    import hashlib

    h = hashlib.sha256()
    rng = np.random.RandomState(11)
    for n, w in ((1, 17), (4, 256), (7, 1023), (128, 64)):
        b = rng.randint(0, 256, size=(n, w)).astype(np.uint8)
        for scheme in P11_GF_SCHEMES:
            out = kernels.gf256_accumulate(b, p11_gf_coeffs(np, kernels,
                                                             scheme, n))
            p11_check("gf256 of numpy input ran off the card",
                      out.device.type == "cuda")
            h.update(out.cpu().numpy().tobytes())
    p11_check(f"gf256 digest {h.hexdigest()} differs from the "
              f"reference's {P11_GF_DIGEST}", h.hexdigest() == P11_GF_DIGEST)
    return h.hexdigest()


def p11_gf256(torch, np, kernels):
    """(b) gf256_accumulate on the card at each shape and scheme:
    bit-identical to the numpy twin, the median ms (time_ms), the bound
    (n*L + L + n bytes over the HBM rate), the share and the peak."""
    digest = p11_gf_small(np, kernels)
    gen = torch.Generator(device="cuda")
    rows = []
    for n, width in P11_GF_SHAPES:
        gen.manual_seed(1000 + n)
        blocks = torch.randint(0, 256, (n, width), dtype=torch.uint8,
                               device="cuda", generator=gen)
        host = blocks.cpu().numpy()
        for scheme in P11_GF_SCHEMES:
            c_np = p11_gf_coeffs(np, kernels, scheme, n)
            coeffs = torch.from_numpy(c_np).cuda()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = kernels.gf256_accumulate(blocks, coeffs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            p11_check(f"gf256 [{n}, {width}] {scheme}: differs from the "
                      "numpy twin", np.array_equal(
                          out.cpu().numpy(),
                          p11_gf_twin(np, kernels, host, c_np)))
            del out
            t = time_ms(torch, lambda: kernels.gf256_accumulate(blocks,
                                                                coeffs))
            b_ms, b_by = bound(n * width + width + n, 2 * n * width)
            rows.append(dict(shape=[n, width], scheme=scheme, ms=t["ms"],
                             ms_min=t["ms_min"], ms_max=t["ms_max"],
                             bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / t["ms"], peak_bytes=peak))
            log(f"11b gf256 {rows[-1]}")
        del blocks, host
        torch.cuda.empty_cache()
    return dict(digest=digest, rows=rows)


def p11_fold(torch, np, ck, vt):
    """(c) fold_pairs_device on one micro-batch of P11_FOLD_PAIRS Python
    (int, int) pairs over P11_FOLD_KEYS keys, per named op: exact against
    a plain dict fold with Python int types, the host build (list to
    numpy, up to the source's build) apart from the rest, the launches;
    then a total beyond int64 returns None."""
    import operator

    from vega_tpu_torch import state_fold

    rng = np.random.RandomState(13)
    keys = rng.randint(0, P11_FOLD_KEYS, size=P11_FOLD_PAIRS).tolist()
    vals = rng.randint(-1000, 1000, size=P11_FOLD_PAIRS).tolist()
    # prod over values in {1, 2} (2 with p = 0.1): about one 2 per key,
    # the products far inside int32
    twos = (rng.rand(P11_FOLD_PAIRS) < 0.1).astype(np.int64) + 1
    batches = {"add": list(zip(keys, vals)), "min": list(zip(keys, vals)),
               "max": list(zip(keys, vals)),
               "prod": list(zip(keys, twos.tolist()))}
    fns = {"add": operator.add, "min": min, "max": max, "prod": operator.mul}
    ctx = vt.Context(n_shards=N_SHARDS)
    marks = {}
    built = ctx.dense_from_numpy

    def marked(*cols):
        marks["built"] = time.perf_counter()
        return built(*cols)
    ctx.dense_from_numpy = marked
    rows = []
    launches = {name: 0 for name in ck.LAUNCHES}
    try:
        for op, pairs in batches.items():
            want = {}
            fn = fns[op]
            for k, x in pairs:
                want[k] = fn(want[k], x) if k in want else x
            torch.cuda.synchronize()
            ck.reset_launches()
            t0 = time.perf_counter()
            got = state_fold.fold_pairs_device(ctx, pairs, op)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p11_check(f"11c {op}: the fold differs from a dict fold",
                      got == want)
            p11_check(f"11c {op}: not every key and value a Python int",
                      all(type(a) is int and type(b) is int
                          for a, b in got.items()))
            fired = [name for name, c in ck.LAUNCHES.items() if c]
            p11_check(f"11c {op}: no kernel launched", fired)
            for name, c in ck.LAUNCHES.items():
                launches[name] += c
            rows.append(dict(op=op, pairs=len(pairs), keys=len(want),
                             ms=(t1 - t0) * 1e3,
                             host_build_ms=(marks["built"] - t0) * 1e3,
                             device_ms=(t1 - marks["built"]) * 1e3,
                             launched=fired))
            log(f"11c {rows[-1]}")
        over = state_fold.fold_pairs_device(
            ctx, [(1, 2**62), (1, 2**62), (2, 1)], "add")
        p11_check(f"11c: a total beyond int64 gave {over}, not None",
                  over is None)
    finally:
        ctx.stop()
    return dict(rows=rows, overflow_none=True, launches=launches)


def phase_eleven(torch, np, ck, vt):
    """Phase 11: (a) persist(MEMORY_AND_DISK) at bench-main, at K = 1M
    and K = 20M; (b) the GF(256) decode; (c) the streaming state fold.
    Launches are summed over every run of the phase."""
    from vega_tpu_torch import dense_rdd, kernels

    persist = [p11_persist(torch, np, ck, vt, dense_rdd, k)
               for k in P11_KEYS]
    gf = p11_gf256(torch, np, kernels)
    fold = p11_fold(torch, np, ck, vt)
    launches = {name: sum(r["launches"][name] for r in persist)
                + fold["launches"][name] for name in ck.LAUNCHES}
    return dict(persist=persist, gf256=gf, fold=fold, launches=launches)


P12_PORTS = 65_536             # uint16 destination ports: every value a key
P12_FLAGS = 256                # int8 flags: every value a key
P12_WRAP_KEYS = 100_000        # int8 values, 200 per key: sums wrap
P12_F16_KEYS = 1_000_000       # float16 readings over 1M int32 keys
P12_ADDRS = 1_000_000          # uint32 IPv4 addresses, half >= 2^31
P12_LOOKUPS = (0, 499_999, 999_999)
P12_TRACE_DIR = os.path.join("chiprun_out", "phase12_trace")


def p12_check(what, ok):
    if not ok:
        fail(f"phase 12: {what}")


def p12_step(torch, ck, fn):
    """fn() between two synchronizes with the launches counted from 0 and
    the allocator's peak reset: (result, ms, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, dict(ck.LAUNCHES), torch.cuda.max_memory_allocated()


def p12_timed(torch, ck, label, build, run, check, must=()):
    """One line of 12a-c: a cold run (build + run, checked), then three
    warm ones, each its host build (the sources from numpy) and its device
    steps (run, ended by a synchronize) timed apart; the launches of the
    cold run's steps, which must include `must`, and the steps' peak."""
    src, build_ms, _, _ = p12_step(torch, ck, build)
    out, ms, launches, peak = p12_step(torch, ck, lambda: run(src))
    check(out)
    missing = [n for n in must if launches[n] <= 0]
    p12_check(f"{label}: kernels {missing} not launched ({launches})",
              not missing)
    warm, warm_build = [], []
    for _ in range(3):
        src, b_ms, _, _ = p12_step(torch, ck, build)
        out, w_ms, _, _ = p12_step(torch, ck, lambda: run(src))
        warm.append(w_ms)
        warm_build.append(b_ms)
    del src, out
    row = dict(label=label, cold_ms=ms, cold_build_ms=build_ms,
               warm_ms=warm, median_ms=statistics.median(warm),
               warm_build_ms=warm_build,
               median_build_ms=statistics.median(warm_build),
               rows_per_s=N_ROWS / (statistics.median(warm) / 1e3),
               launches=launches, peak_bytes=peak)
    log(f"phase 12 {label}: warm {row['median_ms']:.3f} ms (host build "
        f"{row['median_build_ms']:.3f} ms), cold {ms:.3f} ms, launches "
        f"{launches}, peak {peak} B")
    return row


def p12_sums(np, idx, vals, n):
    """Exact per-index sums (int64) of integer vals."""
    return np.bincount(idx, weights=vals.astype(np.float64),
                       minlength=n).astype(np.int64)


def p12_narrow(torch, np, ck, vt):
    """(a) network-flow rollups over narrow columns at N_ROWS rows: uint16
    ports with int32 byte counts reduced, joined to a 65,536-row uint16
    port table, sorted (take(10)); int8 flags counted by value; int8
    values whose per-key sums wrap; float16 readings summed per key."""
    rng = np.random.RandomState(31)
    ports = rng.randint(0, P12_PORTS, N_ROWS).astype(np.uint16)
    nbytes = rng.randint(40, 1500, N_ROWS).astype(np.int32)
    names = np.arange(P12_PORTS, dtype=np.uint16)
    port_sums = p12_sums(np, ports, nbytes, P12_PORTS)
    present = np.flatnonzero(np.bincount(ports, minlength=P12_PORTS))
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    try:
        def check_ports(out):
            cnt, got = out
            p12_check(f"12a ports: join count {cnt}", cnt == len(present))
            p12_check("12a ports: key dtypes",
                      got["k"].dtype == np.uint16
                      and got["rv"].dtype == np.int32)
            order = np.argsort(got["k"])
            p12_check("12a ports: per-port sums differ from numpy",
                      np.array_equal(got["k"][order], present)
                      and np.array_equal(got["lv"][order],
                                         port_sums[present])
                      and np.array_equal(got["rv"][order], present * 3))

        def run_ports(src):
            joined = src[0].reduce_by_key(op="add").join(src[1])
            return joined.count(), joined.collect_arrays()
        rows.append(p12_timed(
            torch, ck, "12a uint16 ports reduce+join",
            lambda: (ctx.dense_from_numpy(ports, nbytes),
                     ctx.dense_from_numpy(names,
                                          names.astype(np.int32) * 3)),
            run_ports, check_ports,
            ("hash_bucket", "digit_hist", "partition_pos")))

        first10 = np.sort(ports)[:10]

        def check_sorted(out):
            keys = np.array([k for k, _ in out], dtype=np.int64)
            p12_check("12a sort_by_key().take(10) keys",
                      np.array_equal(keys, first10))
            for k, b in out:
                p12_check(f"12a take(10): ({k}, {b}) is no input row",
                          b in set(nbytes[ports == k].tolist()))
        rows.append(p12_timed(
            torch, ck, "12a uint16 sort_by_key().take(10)",
            lambda: ctx.dense_from_numpy(ports, nbytes),
            lambda src: src.sort_by_key().take(10), check_sorted,
            ("digit_hist", "partition_pos")))

        flags = rng.randint(-128, 128, N_ROWS).astype(np.int8)
        flag_counts = np.bincount(flags.astype(np.int64) + 128,
                                  minlength=P12_FLAGS)

        def check_flags(out):
            got = np.zeros(P12_FLAGS, np.int64)
            for k, c in out.items():
                got[k + 128] = c
            p12_check("12a int8 count_by_value differs from np.bincount",
                      len(out) == P12_FLAGS
                      and np.array_equal(got, flag_counts))
        rows.append(p12_timed(
            torch, ck, "12a int8 flags count_by_value",
            lambda: ctx.dense_from_numpy(flags),
            lambda src: src.count_by_value(), check_flags,
            ("hash_bucket", "digit_hist")))

        wkeys = rng.randint(0, P12_WRAP_KEYS, N_ROWS).astype(np.int32)
        wvals = rng.randint(-128, 128, N_ROWS).astype(np.int8)
        wrapped = p12_sums(np, wkeys, wvals, P12_WRAP_KEYS).astype(np.int8)

        def check_wrap(got):
            order = np.argsort(got["k"])
            p12_check("12a int8 sums: dtype", got["v"].dtype == np.int8)
            p12_check("12a int8 sums differ from numpy's int8 wrap",
                      np.array_equal(got["k"][order],
                                     np.arange(P12_WRAP_KEYS))
                      and np.array_equal(got["v"][order], wrapped))
        rows.append(p12_timed(
            torch, ck, "12a int8 values reduce (wrapping)",
            lambda: ctx.dense_from_numpy(wkeys, wvals),
            lambda src: src.reduce_by_key(op="add").collect_arrays(),
            check_wrap, ("hash_bucket", "digit_hist")))
        rows.append(p12_timed(
            torch, ck, "12a int8 values reduce, count() alone",
            lambda: ctx.dense_from_numpy(wkeys, wvals),
            lambda src: src.reduce_by_key(op="add").count(),
            lambda c: p12_check(f"12a int8 reduce count() {c}",
                                c == P12_WRAP_KEYS),
            ("hash_bucket", "digit_hist")))

        fkeys = rng.randint(0, P12_F16_KEYS, N_ROWS).astype(np.int32)
        fvals = (rng.rand(N_ROWS) * 4).astype(np.float16)
        fsums = np.bincount(fkeys, weights=fvals.astype(np.float64),
                            minlength=P12_F16_KEYS).astype(np.float16)

        def check_f16(got):
            p12_check("12a float16 sums: dtype", got["v"].dtype == np.float16)
            v = np.zeros(P12_F16_KEYS, np.float64)
            v[got["k"]] = got["v"]
            seen = np.bincount(got["k"], minlength=P12_F16_KEYS)
            want = fsums.astype(np.float64)
            p12_check("12a float16 sums beyond rtol 2e-3 of numpy's",
                      np.array_equal(seen, (np.bincount(
                          fkeys, minlength=P12_F16_KEYS) > 0).astype(
                              np.int64))
                      and np.allclose(v, want, rtol=2e-3, atol=0))
        rows.append(p12_timed(
            torch, ck, "12a float16 values reduce",
            lambda: ctx.dense_from_numpy(fkeys, fvals),
            lambda src: src.reduce_by_key(op="add").collect_arrays(),
            check_f16, ("hash_bucket", "digit_hist")))
        n_fkeys = int(np.count_nonzero(np.bincount(fkeys)))
        rows.append(p12_timed(
            torch, ck, "12a float16 values reduce, count() alone",
            lambda: ctx.dense_from_numpy(fkeys, fvals),
            lambda src: src.reduce_by_key(op="add").count(),
            lambda c: p12_check(f"12a float16 reduce count() {c}",
                                c == n_fkeys),
            ("hash_bucket", "digit_hist")))
    finally:
        ctx.stop()
    return rows


def p12_uint32(torch, np, ck, vt):
    """(b) IPv4-address keys: N_ROWS rows over P12_ADDRS distinct uint32
    addresses, half of them >= 2^31: reduced and joined to the address
    table, sorted (take(10), unsigned order); a uint32 value column
    reduced by key (add wraps mod 2^32) and its exact sum()."""
    rng = np.random.RandomState(32)
    half = P12_ADDRS // 2
    lo = np.unique(rng.randint(0, 2**31, 2 * half, dtype=np.int64))[:half]
    hi = np.unique(rng.randint(2**31, 2**32, 2 * half,
                               dtype=np.int64))[:half]
    addrs = rng.permutation(np.concatenate([lo, hi])).astype(np.uint32)
    idx = rng.randint(0, P12_ADDRS, N_ROWS)
    keys = addrs[idx]
    nbytes = rng.randint(40, 1500, N_ROWS).astype(np.int32)
    addr_sums = p12_sums(np, idx, nbytes, P12_ADDRS)
    used = np.bincount(idx, minlength=P12_ADDRS) > 0
    table_v = np.arange(P12_ADDRS, dtype=np.int32)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    try:
        def check_join(out):
            cnt, got = out
            p12_check(f"12b join count {cnt}", cnt == int(used.sum()))
            p12_check("12b dtypes", got["k"].dtype == np.uint32)
            p12_check("12b joined rows differ from numpy",
                      np.array_equal(addrs[got["rv"]], got["k"])
                      and np.array_equal(got["lv"], addr_sums[got["rv"]])
                      and np.array_equal(np.sort(got["rv"]),
                                         np.flatnonzero(used)))

        def run_join(src):
            joined = src[0].reduce_by_key(op="add").join(src[1])
            return joined.count(), joined.collect_arrays()
        rows.append(p12_timed(
            torch, ck, "12b uint32 addresses reduce+join",
            lambda: (ctx.dense_from_numpy(keys, nbytes),
                     ctx.dense_from_numpy(addrs, table_v)),
            run_join, check_join,
            ("hash_bucket", "digit_hist", "partition_pos")))

        first10 = np.sort(keys)[:10]
        last10 = np.sort(keys)[::-1][:10]

        def check_sorted(out):
            asc, desc = out
            p12_check("12b sort_by_key().take(10) not unsigned order",
                      np.array_equal(np.array([k for k, _ in asc],
                                              np.uint32), first10)
                      and np.array_equal(np.array([k for k, _ in desc],
                                                  np.uint32), last10))
        rows.append(p12_timed(
            torch, ck, "12b uint32 sort_by_key().take(10) both ways",
            lambda: ctx.dense_from_numpy(keys, nbytes),
            lambda src: (src.sort_by_key().take(10),
                         src.sort_by_key(False).take(10)), check_sorted,
            ("digit_hist", "partition_pos")))

        vkeys = (np.arange(N_ROWS) % P12_ADDRS).astype(np.int32)
        vals = rng.randint(0, 2**32, N_ROWS, dtype=np.int64).astype(
            np.uint32)
        wrapped = (p12_sums(np, vkeys, vals, P12_ADDRS) % 2**32).astype(
            np.uint32)
        exact = int(vals.astype(np.uint64).sum())

        def check_vals(out):
            got, total = out
            p12_check("12b uint32 value sums: dtypes",
                      got["v"].dtype == np.uint32
                      and got["k"].dtype == np.int32)
            v = np.zeros(P12_ADDRS, np.uint32)
            v[got["k"]] = got["v"]
            p12_check("12b uint32 value sums do not wrap mod 2^32",
                      len(got["k"]) == P12_ADDRS
                      and np.array_equal(v, wrapped))
            p12_check(f"12b sum() {total} != {exact}",
                      type(total) is int and total == exact)
        rows.append(p12_timed(
            torch, ck, "12b uint32 values reduce + exact sum()",
            lambda: (ctx.dense_from_numpy(vkeys, vals),
                     ctx.dense_from_numpy(vals)),
            lambda src: (src[0].reduce_by_key(op="add").collect_arrays(),
                         src[1].sum()), check_vals,
            ("hash_bucket", "digit_hist")))
        rows.append(p12_timed(
            torch, ck, "12b uint32 values reduce, count() alone",
            lambda: ctx.dense_from_numpy(vkeys, vals),
            lambda src: src.reduce_by_key(op="add").count(),
            lambda c: p12_check(f"12b uint32 reduce count() {c}",
                                c == P12_ADDRS),
            ("hash_bucket", "digit_hist")))
    finally:
        ctx.stop()
    return rows


def p12_hostapi(torch, np, ck, vt):
    """(c) the host API's device forms on bench-main's reduce (1M keys):
    first, is_empty, keys().count(), values().sum(), count_by_key of the
    20M pairs, collect_as_map, lookup of 3 keys, right_outer_join with a
    1M-row table half of whose keys the reduce lacks; each exact (sums
    within rtol 1e-5 of float64 numpy), each timed warm (the second of
    two calls), launches and peak of the first."""
    x = np.arange(N_ROWS, dtype=np.int64)
    sums = np.bincount(x % N_KEYS, weights=x * 0.5, minlength=N_KEYS)
    tk = np.arange(N_KEYS // 2, N_KEYS // 2 + N_KEYS, dtype=np.int32)
    tv = tk.astype(np.float32) * 2
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []

    def close(a, b):
        return np.allclose(a, b, rtol=1e-5, atol=0)

    def item(label, fn, check):
        out, ms, launches, peak = p12_step(torch, ck, fn)
        check(out)
        _, warm_ms, _, _ = p12_step(torch, ck, fn)
        rows.append(dict(label=label, cold_ms=ms, warm_ms=warm_ms,
                         launches=launches, peak_bytes=peak))
        log(f"phase 12 12c {label}: warm {warm_ms:.3f} ms, cold {ms:.3f} "
            f"ms, launches {launches}, peak {peak} B")
    try:
        kv = ctx.dense_range(N_ROWS).map(lambda v: (v % N_KEYS, v * 0.5))
        red = kv.reduce_by_key(op="add")
        red.count()

        def check_first(r):
            k, s = r
            p12_check(f"12c first() {r}", 0 <= k < N_KEYS
                      and close(s, sums[k]))
        item("first()", red.first, check_first)
        item("is_empty()", red.is_empty,
             lambda r: p12_check("12c is_empty()", r is False))
        item("keys().count()", lambda: red.keys().count(),
             lambda r: p12_check(f"12c keys().count() {r}", r == N_KEYS))
        item("values().sum()", lambda: red.values().sum(),
             lambda r: p12_check(f"12c values().sum() {r}",
                                 close(r, sums.sum())))

        def check_cbk(r):
            p12_check("12c count_by_key(): not 1M keys of 20 rows",
                      len(r) == N_KEYS and set(r.values()) ==
                      {N_ROWS // N_KEYS} and all(type(k) is int
                                                  for k in list(r)[:100]))
        item("count_by_key() of the 20M pairs", kv.count_by_key, check_cbk)

        def check_map(r):
            ks = np.fromiter(r.keys(), np.int64, len(r))
            vs = np.fromiter(r.values(), np.float64, len(r))
            p12_check("12c collect_as_map() differs from numpy",
                      len(r) == N_KEYS and close(vs, sums[ks]))
        item("collect_as_map()", red.collect_as_map, check_map)

        def check_lookups(r):
            for k, got in zip(P12_LOOKUPS, r):
                p12_check(f"12c lookup({k}) {got}", len(got) == 1
                          and close(got[0], sums[k]))
        item("lookup() x3", lambda: [red.lookup(k) for k in P12_LOOKUPS],
             check_lookups)

        def run_roj():
            res = red.right_outer_join(ctx.dense_from_numpy(tk, tv))
            return res.count(), res.collect()

        def check_roj(out):
            cnt, got = out
            p12_check(f"12c right_outer_join count {cnt}", cnt == N_KEYS
                      and len(got) == N_KEYS)
            ks = np.array([k for k, _ in got], np.int64)
            none = np.array([lv is None for _, (lv, _r) in got])
            p12_check("12c right_outer_join: None not exactly at the "
                      "missing keys", np.array_equal(none, ks >= N_KEYS)
                      and np.array_equal(np.sort(ks), tk))
            lv = np.array([lv for _, (lv, _r) in got if lv is not None])
            rv = np.array([r for _, (_lv, r) in got], np.float64)
            p12_check("12c right_outer_join values differ from numpy",
                      close(lv, sums[ks[~none]])
                      and np.array_equal(rv, ks * 2.0))
        item("right_outer_join(1M table, half missing)", run_roj,
             check_roj)
    finally:
        ctx.stop()
    return rows


def p12_trace_ops(json_mod, path, top=5):
    """(kernel names found, the `top` device ops by summed duration as
    (name, ms, calls), device busy ms, the device events' span ms) from a
    Chrome trace's kernel / memcpy / memset events."""
    with open(path, encoding="utf-8") as fh:
        events = json_mod.load(fh).get("traceEvents", [])
    dur, calls = {}, {}
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            nm = e.get("name", "")
            d = float(e.get("dur", 0))
            dur[nm] = dur.get(nm, 0.0) + d / 1e3
            calls[nm] = calls.get(nm, 0) + 1
            lo = min(lo, float(e["ts"]))
            hi = max(hi, float(e["ts"]) + d)
    ranked = sorted(dur, key=dur.get, reverse=True)[:top]
    return (set(dur), [(nm[:120], dur[nm], calls[nm]) for nm in ranked],
            sum(dur.values()), max(hi - lo, 0.0) / 1e3)


def p12_profiler(torch, np, ck, vt):
    """(d) one warm bench-main run (phase 3's pipeline) inside
    ctx.profiler(), twice (the first profiler of a process pays the
    tracer's set-up): each count equal to an unprofiled run's, the first
    trace's CUDA kernel events naming all three kernels, its five longest
    device ops and its device busy share (busy ms over the span of its
    device events), and each profiled run's ms (the run alone,
    synchronized) beside two unprofiled ones', the profiler's start, stop
    and trace write apart."""
    import glob
    import shutil

    ctx = vt.Context(n_shards=N_SHARDS)
    shutil.rmtree(P12_TRACE_DIR, ignore_errors=True)
    sessions = []
    try:
        pipeline(ctx, np).count()  # cold
        plain = []
        for _ in range(2):
            c, ms, _, _ = p12_step(torch, ck, lambda: pipeline(ctx, np)
                                   .count())
            plain.append(ms)
        p12_check(f"12d unprofiled count {c}", c == N_KEYS)
        for i in range(2):
            out_dir = os.path.join(P12_TRACE_DIR, str(i))
            t0 = time.perf_counter()
            with ctx.profiler(out_dir):
                # the run alone, between the profiler's start and its stop
                pc, prof_ms, launches, _ = p12_step(
                    torch, ck, lambda: pipeline(ctx, np).count())
            whole_ms = (time.perf_counter() - t0) * 1e3
            p12_check(f"12d profiled count {pc} != unprofiled {c}",
                      pc == c)
            files = glob.glob(os.path.join(out_dir, "*.pt.trace.json"))
            p12_check(f"12d trace files {files}", len(files) == 1)
            names, top, busy, span = p12_trace_ops(json, files[0])
            sessions.append(dict(
                profiled_ms=prof_ms, start_stop_write_ms=whole_ms - prof_ms,
                trace_bytes=os.path.getsize(files[0]), top_device_ops=top,
                device_busy_ms=busy, device_span_ms=span,
                busy_share=busy / span if span else None,
                launches=launches))
            if i == 0:
                want = {"hash_bucket": "hash_bucket_kernel",
                        "digit_hist": "digit_hist_",
                        "partition_pos": "partition_pos_kernel"}
                found = {k: sorted(nm[:60] for nm in names if w in nm
                                   and "kernel" in nm)
                         for k, w in want.items()}
                missing = [k for k, nms in found.items() if not nms]
                p12_check("12d the trace lacks CUDA kernel events of "
                          f"{missing}", not missing)
        # a narrow-value reduce with its collect (12a's int8 values),
        # warm: how much of its time the card is busy, and on what
        rng = np.random.RandomState(33)
        src = ctx.dense_from_numpy(
            rng.randint(0, P12_WRAP_KEYS, N_ROWS).astype(np.int32),
            rng.randint(-128, 128, N_ROWS).astype(np.int8))
        src.reduce_by_key(op="add").collect_arrays()  # cold
        out_dir = os.path.join(P12_TRACE_DIR, "value_reduce")
        with ctx.profiler(out_dir):
            got, vr_ms, _, _ = p12_step(
                torch, ck, lambda: src.reduce_by_key(op="add")
                .collect_arrays())
        p12_check("12d value reduce rows", len(got["k"]) == P12_WRAP_KEYS)
        files = glob.glob(os.path.join(out_dir, "*.pt.trace.json"))
        p12_check(f"12d value reduce trace files {files}", len(files) == 1)
        _, vtop, vbusy, vspan = p12_trace_ops(json, files[0], top=8)
        value_reduce = dict(profiled_ms=vr_ms, top_device_ops=vtop,
                            device_busy_ms=vbusy, device_span_ms=vspan)
        del src, got
    finally:
        ctx.stop()
        shutil.rmtree(P12_TRACE_DIR, ignore_errors=True)
    first = sessions[0]
    row = dict(first, unprofiled_ms=plain,
               overhead=first["profiled_ms"] / statistics.median(plain) - 1,
               kernel_events=found, second=sessions[1],
               value_reduce=value_reduce)
    log(f"phase 12 12d profiler: profiled {first['profiled_ms']:.3f} ms "
        f"vs unprofiled {plain} ms, start + stop + trace write "
        f"{first['start_stop_write_ms']:.1f} ms (second profiler "
        f"{sessions[1]['start_stop_write_ms']:.1f} ms), device busy "
        f"{first['device_busy_ms']:.3f} of {first['device_span_ms']:.3f} "
        f"ms, trace {first['trace_bytes']} B, kernels {found}, top ops "
        f"{first['top_device_ops']}")
    log(f"phase 12 12d int8 value reduce + collect profiled: "
        f"{vr_ms:.3f} ms, device busy {vbusy:.3f} ms of a {vspan:.3f} ms "
        f"span, top ops {vtop}")
    return row


def p12_refusals(np, vt):
    """(e) the repairs' refusals on the card: a named add over bool
    values raises VegaError, fold_pairs_device leaves tuple keys to the
    host (None), a 2-D key raises VegaError and not KernelError."""
    from vega_tpu_torch import state_fold
    from vega_tpu_torch.errors import KernelError, VegaError

    ctx = vt.Context(n_shards=N_SHARDS)
    out = {}
    try:
        try:
            ctx.dense_range(1000).map(lambda x: (x % 7, x % 3 == 0)) \
                .reduce_by_key(op="add").collect()
            out["bool_add"] = "no error"
        except VegaError as e:
            out["bool_add"] = type(e).__name__
        out["tuple_fold"] = state_fold.fold_pairs_device(
            ctx, [((1, 2), 3)], "add")
        try:
            ctx.dense_from_numpy(np.array([[1, 2], [3, 4]], np.int32),
                                 np.array([1, 2], np.int32)).reduce_by_key(
                                     op="add").collect()
            out["key_2d"] = "no error"
        except KernelError as e:
            out["key_2d"] = f"KernelError: {e}"
        except VegaError as e:
            out["key_2d"] = type(e).__name__
    finally:
        ctx.stop()
    p12_check(f"12e refusals {out}", out == dict(
        bool_add="VegaError", tuple_fold=None, key_2d="VegaError"))
    log(f"phase 12 12e refusals: {out}")
    return out


def phase_twelve(torch, np, ck, vt):
    """Phase 12: (a) narrow columns, (b) uint32 beyond int32, (c) the
    host API's device forms, (d) ctx.profiler, (e) the refusals; the
    launches summed over (a)-(c)'s cold runs and (d)'s profiled run."""
    t0 = time.perf_counter()
    narrow = p12_narrow(torch, np, ck, vt)
    uint32 = p12_uint32(torch, np, ck, vt)
    hostapi = p12_hostapi(torch, np, ck, vt)
    prof = p12_profiler(torch, np, ck, vt)
    refusals = p12_refusals(np, vt)
    launches = {name: sum(r["launches"][name]
                          for r in narrow + uint32 + hostapi)
                + prof["launches"][name] for name in ck.LAUNCHES}
    wall_s = time.perf_counter() - t0
    log(f"phase 12 took {wall_s:.1f} s")
    return dict(narrow=narrow, uint32=uint32, hostapi=hostapi,
                profiler=prof, refusals=refusals, launches=launches,
                wall_s=wall_s)


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    import numpy as np

    import vega_tpu_torch as vt
    from vega_tpu_torch import block as block_lib
    from vega_tpu_torch import cuda_kernels as ck

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    ck.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s ({ck.LIBRARY})")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 2. kernels against their plain versions
    main_cap = block_lib._round_capacity(math.ceil(N_ROWS / N_SHARDS))
    join_cap = block_lib._round_capacity(math.ceil(N_KEYS / N_SHARDS))
    inp = make_inputs(torch, ck, main_cap, join_cap)
    check_kernels(torch, ck, inp)
    table, radix = time_kernels(torch, ck, inp)
    del inp
    torch.cuda.empty_cache()

    # 3. main path, 4. the other plans
    main_path = phase_main_path(torch, np, ck, vt)
    plans = phase_plans(torch, np, ck, vt, main_path)
    # 5. the keyed configs
    keyed = phase_keyed(torch, np, ck, vt)
    # 6. (a) config 3, (b) the new ops
    data = config3_data(np)
    # the fused_sort reduce groups its combined rows by bucket in its
    # sort, so its exchange is pregrouped: digit_hist counts it and
    # partition_pos (the join's ranking of unsorted rows) has no part in
    # this path
    config3 = run_config(
        torch, np, ck, vt, "config 3: word count, count_by_key_dense",
        C3_ROWS, data, config3_run,
        lambda g, d=data: config3_check(np, d, g),
        ("hash_bucket", "digit_hist"))
    new_ops = phase_new_ops(torch, np, ck, vt)
    # 7. the row-function repairs, wide values and keys, the expansions,
    # sample
    seven = phase_seven(torch, np, ck, vt, data)
    del data
    # 8. streamed sources, checkpoints and the block lifetime
    eight = phase_eight(torch, np, ck, vt)
    # 9. the exchange programs, stream-1b under the planner, strings
    nine = phase_nine(torch, np, ck, vt)
    # 10. the frame layer
    ten = phase_ten(torch, np, ck, vt)
    # 11. persist(level) and the spill tier, the GF(256) decode, the fold
    eleven = phase_eleven(torch, np, ck, vt)
    # 12. narrow and uint32 columns, the host API, the profiler
    twelve = phase_twelve(torch, np, ck, vt)

    kernels_line = {"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[r["name"]],
         "launches": main_path["launches"][r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "config3_launches": config3["launches"][r["name"]],
         "new_ops_launches": new_ops["launches"][r["name"]],
         "phase7_launches": seven["launches"][r["name"]],
         "phase8_launches": eight["launches"][r["name"]],
         "phase9_launches": nine["launches"][r["name"]],
         "phase10_launches": ten["launches"][r["name"]],
         "phase11_launches": eleven["launches"][r["name"]],
         "phase12_launches": twelve["launches"][r["name"]]}
        for r in table]}
    kind = torch.cuda.get_device_name(0)
    details = dict(card=card, kind=kind, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   n_rows=N_ROWS, n_keys=N_KEYS, n_shards=N_SHARDS,
                   timing=dict(launches_per_run=LAUNCHES_PER_RUN, runs=RUNS,
                               l2_flush_bytes=L2_FLUSH_BYTES,
                               kernels="CUDA graph replay",
                               plain_and_library="eager calls"),
                   kernels=table, radix_and_cold=radix, main_path=main_path,
                   plans=plans, keyed=keyed, config3=config3,
                   new_ops=new_ops, phase7=seven, phase8=eight,
                   phase9=nine, phase10=ten, phase11=eleven,
                   phase12=twelve)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w",
              encoding="utf-8") as fh:
        json.dump(details, fh, indent=1)
    print(f"main path: {main_path['rows_per_s']:.1f} rows/s warm median of 3 "
          f"({N_ROWS} rows, {N_KEYS} keys, {N_SHARDS} shards) on {card}",
          flush=True)
    for r in plans:
        print(f"plan {r['label']}: {r['rows_per_s']:.1f} rows/s warm median "
              f"of 3, cold {r['cold_s']:.3f} s, launches of one warm run "
              f"{json.dumps(r['warm_launches'])}, radix passes "
              f"{r['radix_passes']}, table taken {r['table_taken']}"
              f"{', poisoned range repaired' if 'poisoned' in r else ''} "
              f"on {card}", flush=True)
    for r in keyed:
        print(f"{r['label']}: {r['rows_per_s']:.1f} rows/s warm median of 3 "
              f"({r['rows']} rows), host build "
              f"{statistics.median(r['warm_build_ms']):.1f} ms, cold "
              f"{r['cold_s']:.3f} s, median step ms "
              f"{json.dumps(r['median_step_ms'])}, launches of one warm run "
              f"{json.dumps(r['warm_launches'])}, peak "
              f"{r['peak_bytes']} bytes on {card}", flush=True)
    r = config3
    print(f"{r['label']}: {r['rows_per_s']:.1f} rows/s warm median of 3 "
          f"({r['rows']} rows, {r['check']['words']} words), host build "
          f"{statistics.median(r['warm_build_ms']):.1f} ms, cold "
          f"{r['cold_s']:.3f} s, median step ms "
          f"{json.dumps(r['median_step_ms'])}, launches cold "
          f"{json.dumps(r['launches'])} warm {json.dumps(r['warm_launches'])}"
          f", peak {r['peak_bytes']} bytes, memory after each cold step "
          f"{json.dumps(r['cold_memory'])} on {card}", flush=True)
    for r in new_ops["ops"]:
        print(f"new op {r['label']}: {r['median_ms']:.3f} ms warm median of "
              f"3, {r['rows_per_s']:.1f} rows/s ({r['rows']} rows), cold "
              f"{r['cold_ms']:.3f} ms, launches {json.dumps(r['launches'])} "
              f"on {card}", flush=True)
    print(f"new ops: peak {new_ops['peak_bytes']} bytes, launches of the "
          f"cold runs {json.dumps(new_ops['launches'])} on {card}",
          flush=True)
    for r in seven["lines"]:
        extra = (f" (6a count_by_key_dense {config3['rows_per_s']:.1f} "
                 "rows/s in this run)" if r["label"].startswith("7a") else "")
        print(f"phase {r['label']}: {r['median_ms']:.3f} ms warm median of "
              f"3, {r['rows_per_s']:.1f} rows/s ({r['rows']} rows){extra}, "
              f"cold {r['cold_ms']:.3f} ms, launches "
              f"{json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 7: peak {seven['peak_bytes']} bytes, launches of the cold "
          f"runs {json.dumps(seven['launches'])}, wide overflow raised and "
          f"keyless bignum {seven['overflow']['bignum']} exact, host folds: "
          f"{seven['overflow']['host_folds']}, queue-3 inputs equal numpy: "
          f"{len(seven['queue3'])} on {card}", flush=True)
    r = eight["north_star"]
    print(f"phase 8a 1B group_by+join: {r['rows_per_s']:.1f} rows/s warm "
          f"median of 3 ({r['rows']} rows, {r['keys']} keys, {r['chunks']} "
          f"chunks of {r['chunk_rows']}), cold {r['cold_s']:.3f} s, fold ms "
          f"per chunk cold {json.dumps(r['cold_fold_ms'])} warm "
          f"{json.dumps(r['warm_fold_ms'])}, launches per warm run "
          f"{json.dumps(r['warm_launches'])}, peak {r['peak_bytes']} bytes "
          f"beside the budget {r['budget']} on {card}", flush=True)
    for name, r in eight["order"].items():
        print(f"phase 8b {name}(10): {r['median_ms']:.3f} ms warm median of "
              f"3, {r['rows_per_s']:.1f} rows/s, cold {r['cold_ms']:.3f} ms "
              f"on {card}", flush=True)
    r = eight["join"]
    print(f"phase 8c streamed join: {r['rows_per_s']:.1f} rows/s warm median "
          f"of 3, cold {r['cold_s']:.3f} s, partition_pos "
          f"{json.dumps(r['partition_pos'])}, first chunk exact on {card}",
          flush=True)
    print(f"phase 8d checkpoints: {json.dumps(eight['checkpoints'])} on "
          f"{card}", flush=True)
    print(f"phase 8e lifetime: {json.dumps(eight['lifetime'])} on {card}",
          flush=True)
    print(f"phase 8f range_bucket subnormals equal on the card and the CPU: "
          f"{json.dumps(eight['range_bucket'])} on {card}", flush=True)
    for r in nine["programs"]:
        print(f"phase 9a {r['label']}: {r['median_ms']:.3f} ms warm median "
              f"of 3 ({r['rows_per_s']:.1f} rows/s), cold {r['cold_s']:.3f} "
              f"s, plan {json.dumps(r['plan'])} at budget {r['budget']}, "
              f"measured exchange peak {r['exchange_peak_bytes']} bytes, "
              f"step peak {r['step_peak_bytes']} bytes, model 8 x est "
              f"{r['model_peak_bytes']} bytes on {card}", flush=True)
    r = nine["north_star"]
    a = eight["north_star"]
    print(f"phase 9b 1B group_by+join under auto: {r['rows_per_s']:.1f} "
          f"rows/s warm median of 3 ({r['chunks']} chunks of "
          f"{r['chunk_rows']}), fold ms per chunk warm "
          f"{json.dumps(r['warm_fold_ms'])}, peak {r['peak_bytes']} bytes, "
          f"plans {json.dumps(r['exchange_plans'])}; beside 8a under "
          f"all_to_all: {a['rows_per_s']:.1f} rows/s ({a['chunks']} chunks), "
          f"peak {a['peak_bytes']} bytes on {card}", flush=True)
    r = nine["strings"]
    print(f"phase 9c strings ({r['rows']} rows, {r['vocab']} words, "
          f"{r['merged_words']} merged): host encode "
          f"{r['median_encode_ms']:.1f} ms, device steps "
          f"{r['median_device_ms']:.1f} ms, whole {r['median_total_s']:.3f} "
          f"s warm median of 2, runs {json.dumps(r['runs'])}; 9d checkpoint "
          f"{json.dumps(r['reload'])} on {card}", flush=True)
    r = ten["frame_ab"]
    for leg in P10_LEGS:
        x = r["legs"][leg]
        print(f"phase 10a {leg}: {x['median_ms']:.3f} ms warm median of 3 "
              f"({x['rows_per_s']:.1f} rows/s over {r['rows']} rows, "
              f"{r['out_rows']} rows out), host build "
              f"{x['median_host_build_ms']:.3f} ms, device steps "
              f"{x['median_device_ms']:.3f} ms, cold {x['cold']['ms']:.3f} "
              f"ms, step peak {x['peak_bytes']} bytes, launches cold "
              f"{json.dumps(x['cold']['launches'])} warm "
              f"{json.dumps(x['warm_launches'])} on {card}", flush=True)
    print(f"phase 10a explain (fused): {r['explain']} || exchange planner "
          f"at {r['rows']} rows: {json.dumps(r['planner_prediction'])}, "
          f"launches planned {json.dumps(r['exchange_plans'])}", flush=True)
    r = ten["mixed"]
    print(f"phase 10b mixed aggregates: {r['median_ms']:.3f} ms warm median "
          f"of 3 ({r['rows_per_s']:.1f} rows/s, {r['keys']} keys), host "
          f"build {r['median_host_build_ms']:.3f} ms, device steps "
          f"{r['median_device_ms']:.3f} ms, cold {r['cold']['ms']:.3f} ms, "
          f"mean max rel err {r['mean_max_rel_err']:.3g}, launches "
          f"{json.dumps(r['launches'])} on {card}", flush=True)
    r = ten["strings"]
    print(f"phase 10c strings ({r['rows']} rows, {r['vocab']} words, "
          f"{r['out_rows']} joined): {r['median_ms']:.3f} ms warm median of "
          f"3, host encode {r['median_encode_ms']:.3f} ms, host build "
          f"{r['median_host_build_ms']:.3f} ms, device steps "
          f"{r['median_device_ms']:.3f} ms, cold {r['cold']['ms']:.3f} ms, "
          f"launches {json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 10d untraceable UDF raised at explain(): "
          f"{ten['untraceable']['raised']}", flush=True)
    for r in eleven["persist"]:
        print(f"phase 11a persist K={r['keys']} (block {r['shape']}, "
              f"{r['block_bytes']} B): spill {r['spill_ms']:.3f} ms "
              f"(re-spill {r['respill_ms']:.3f}), promote "
              f"{r['median_promote_ms']:.3f} ms median of "
              f"{len(r['promote_ms'])} {json.dumps(r['promote_ms'])}, "
              f"snapshot {r['snapshot_bytes']} B, warm recompute after "
              f"unpersist {r['median_recompute_ms']:.3f} ms median of "
              f"{len(r['recompute_ms'])}; warm block {r['warm_shape']}: "
              f"spill {r['warm_spill_ms']:.3f} ms, promote "
              f"{r['warm_promote_ms']:.3f} ms, snapshot "
              f"{r['warm_snapshot_bytes']} B; parts "
              f"{json.dumps(r['parts'])}; promoted access and downstream "
              f"reduce launched nothing, corrupt snapshot recomputed, "
              f"status {json.dumps(r['status'])} on {card}", flush=True)
    for r in eleven["gf256"]["rows"]:
        print(f"phase 11b gf256 {r['shape']} {r['scheme']}: {r['ms']:.4f} "
              f"ms median ({r['ms_min']:.4f}-{r['ms_max']:.4f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['bound_share']:.1%}, peak {r['peak_bytes']} B, "
              f"bit-identical to the numpy twin on {card}", flush=True)
    print(f"phase 11b gf256 reference digest equal: "
          f"{eleven['gf256']['digest']}", flush=True)
    for r in eleven["fold"]["rows"]:
        print(f"phase 11c fold {r['op']} ({r['pairs']} pairs, {r['keys']} "
              f"keys): {r['ms']:.3f} ms, host build {r['host_build_ms']:.3f}"
              f" ms, device and collect {r['device_ms']:.3f} ms, exact with "
              f"Python ints, launched {r['launched']} on {card}",
              flush=True)
    print("phase 11c fold: a total beyond int64 returned None", flush=True)
    for r in twelve["narrow"] + twelve["uint32"]:
        print(f"phase {r['label']}: {r['median_ms']:.3f} ms warm median of "
              f"3 ({r['rows_per_s']:.1f} rows/s), host build "
              f"{r['median_build_ms']:.3f} ms, cold {r['cold_ms']:.3f} ms, "
              f"launches {json.dumps(r['launches'])}, peak "
              f"{r['peak_bytes']} B on {card}", flush=True)
    for r in twelve["hostapi"]:
        print(f"phase 12c {r['label']}: {r['warm_ms']:.3f} ms warm, cold "
              f"{r['cold_ms']:.3f} ms, launches {json.dumps(r['launches'])}"
              f", peak {r['peak_bytes']} B on {card}", flush=True)
    r = twelve["profiler"]
    print(f"phase 12d profiler: profiled run {r['profiled_ms']:.3f} ms, "
          f"unprofiled {json.dumps(r['unprofiled_ms'])} ms (overhead "
          f"{r['overhead']:.1%}), the profiler's start, stop and trace "
          f"write {r['start_stop_write_ms']:.1f} ms (a second profiler: "
          f"{r['second']['start_stop_write_ms']:.1f} ms, its run "
          f"{r['second']['profiled_ms']:.3f} ms), device busy "
          f"{r['device_busy_ms']:.3f} ms of a {r['device_span_ms']:.3f} ms "
          f"span ({r['busy_share']:.1%}), trace {r['trace_bytes']} B naming "
          f"{json.dumps(r['kernel_events'])}; top device ops "
          f"{json.dumps(r['top_device_ops'])} on {card}", flush=True)
    v = r["value_reduce"]
    print(f"phase 12d int8 value reduce + collect, profiled: "
          f"{v['profiled_ms']:.3f} ms, device busy {v['device_busy_ms']:.3f}"
          f" ms of a {v['device_span_ms']:.3f} ms span; top device ops "
          f"{json.dumps(v['top_device_ops'])} on {card}", flush=True)
    print(f"phase 12e refusals: {json.dumps(twelve['refusals'])}; phase 12 "
          f"{twelve['wall_s']:.1f} s", flush=True)
    print("radix and cold rows: " + json.dumps([
        {k: r.get(k) for k in ("name", "shape", "n_bins", "input", "ms",
                               "ms_min", "ms_max", "bound_ms", "bound_share",
                               "scratch_bytes", "plain_ms", "library_ms",
                               "argsort_scatter_ms")}
        for r in radix]), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def main_path_leg(checkout):
    """One leg of --main-path-ab, in a process of its own: `checkout`'s
    own chip_smoke.phase_main_path over its own package (its CUDA kernels
    built in its own tree); prints one JSON line."""
    import importlib.util

    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "leg_chip_smoke", os.path.join(checkout, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    if not vt.__file__.startswith(checkout):
        fail(f"loaded {vt.__file__}, not the package of {checkout}")
    ck.build()
    res = cs.phase_main_path(torch, np, ck, vt)
    keys = ("rows_per_s", "median_s", "warm_s", "warm_build_ms",
            "warm_count_ms", "warm_count_device_ms", "cold_s",
            "warm_launches")
    print(json.dumps(dict({"checkout": checkout},
                          **{k: res[k] for k in keys})), flush=True)


def main_path_ab(checkouts):
    """--main-path-ab DIR...: phase 3 of each checkout in turns on one card
    (e.g. the parent unpacked with git archive into the gitignored _ab/:
    _ab/parent . . _ab/parent), each leg in a process of its own. Prints
    one JSON line per leg and the card line; writes
    chiprun_out/main_path_ab.json."""
    card = card_line()
    legs = []
    for checkout in checkouts:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--main-path-leg",
             checkout], capture_output=True, text=True, timeout=900,
            check=False)
        if res.returncode != 0:
            fail(f"leg {checkout} failed ({res.returncode}):\n"
                 f"{res.stderr[-4000:]}")
        legs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(legs[-1]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "main_path_ab.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"card": card, "legs": legs}, fh, indent=1)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--main-path-ab"] and len(sys.argv) > 2:
        main_path_ab(sys.argv[2:])
    elif sys.argv[1:2] == ["--main-path-leg"] and len(sys.argv) == 3:
        main_path_leg(sys.argv[2])
    else:
        main()
