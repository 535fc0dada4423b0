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
     int64 keys uniform in [-2^45, 2^45). A cold run equals numpy,
     KEYED_WARM warm runs give a median rows/s (the host build of the
     sources and each step timed apart), and the cold and first warm run
     must launch
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
     mixed aggregates sum / min / max / count / mean on (a)'s events (one
     reduce with a named monoid per column; integers exact, the mean
     within rtol 1e-5);
     (c) 2M rows of sku-%06d string keys grouped and joined to a
     100,000-row dims frame on the key, exact, the host encode apart;
     (d) an untraceable UDF: the plan compiles on the host tier at
     explain() with no device work, and its rows equal numpy's. All on
     create_frame: the card's machine has no pyarrow,
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
     12's wall time;
 13. the multi-process tier, each leg in processes of its own
     (--phase13a PORT, --phase13-rank RANK PORT BACKEND CARDS): (a)
     phase 3's pipeline in a one-process Context (its rows saved under
     chiprun_out/, removed after), then through Context(multihost=...)
     at world size 1 over NCCL: rows bit-identical, all three kernels
     launched, warm rows/s beside phase 3's, and a profiled warm run whose
     trace must hold ProcessGroupNCCL's nccl:all_to_all and
     nccl:all_gather records (its NCCL kernels and device copies
     reported; a one-rank communicator serves them with copies); (b) two
     ranks on the one card over gloo, 4 of the 8 global shards each: each
     rank's rows bit-identical, all three kernels launched, warm ms, peak
     memory and bytes sent per rank; (c) the same over NCCL on two cards
     when there are two, else the line "13c: not run, 1 card"; (d) the
     queries of phases 10a (the fused frame, 20M rows over 1M keys, from
     create_frame), 9c (10M sku-%06d string keys reduced, joined, sorted),
     8d (bench-main's 1M reduced pairs through save_npz to ONE path and
     dense_load_npz, resident and in 8 chunks) and 11c (the fold of 1M
     pairs over 100,000 keys, four ops), once in a one-process Context
     here (equal to numpy; rows saved under chiprun_out/, removed after),
     then on two ranks sharing the card over gloo (--phase13d-rank RANK
     PORT), 4 of the 8 global shards each: each rank's rows bit-identical
     to the one-process run's, then warm runs (ms, host build apart, peak,
     mesh.WIRE per warm run, the cold runs' launches; all three kernels
     launched over 13d);
 14. the RDD API against the reference and queue 1 item 7, each line a
     cold run checked against numpy (integers exact) and three warm runs
     (host build apart), the cold run's launches and peak: (a) at
     bench-main's 20M pairs (x % K, x) over K = 1M keys with int32 values,
     the reference's positional calls reduce_by_key(add, 8),
     sort_by_key(True, 8, 4096) and join(table, 8), each giving the
     keyword call's rows, dense_range(N, 8), left_outer_join(half table,
     8) filling 0 at the missing keys (the two joins under a partition
     count the host RDD layer's, 8 partitions, as the reference's; one
     warm run each), and the nine device-tier names:
     fold_by_key(1, add) (per-key sum plus count: the zero once per row),
     aggregate_by_key(5, add, max), group_by(x % K) and sort_by(-x) of
     dense_range(N), mask_keys, cache() (a second action registers no
     block and launches nothing), num_partitions / dense() / id(); (b)
     item 7: the reduced 1M keys against a 1M-row table over [K/2, 3K/2)
     through full_outer_join (1.5M rows, None exactly where numpy says),
     subtract_by_key (K/2 rows) and group_with, partition_by_key(8) of the
     20M pairs (every row on its hash's shard), fold(0, add) / fold(10,
     add) / aggregate of dense_range(N), exact past 2^31; (c) fold_by_key,
     full_outer_join, subtract_by_key, sort_by and fold at 2M rows in one
     process, then on two ranks sharing the card over gloo (--phase14c-rank
     RANK PORT), each rank's rows bit-identical to the one process's;
 15. the frame plans the reference answers on its host tier, from
     create_frame: 20M fact rows (k over 1M keys, x the row id, y, big in
     [2^40, 2^40 + 2^31), a float32 key f of 1M distinct values with
     +-0.0 and 1,000 NaN rows) and a 1M-row dimension frame (k = 2i, so
     half the fact keys are missing, sku-%06d names of a permutation, a
     second name column equal on even rows, a float32 w): (a) an inner and
     a left join carrying x, y, big and name, w (unmatched rows '0' and
     0.0); (b) the join filtered on name == "sku-000123", on name <
     "sku-500000" and on name == name2; (c) the join grouped by k // 8
     (four names a group) with min / max of name, sum(x), mean(y); (d) sum / max / mean of big by k,
     a sort on big, a group-by keyed on big; (e) group_by(f). Each query
     once cold, held to numpy (integers and strings exact, floats within
     rtol 1e-5, NaN groups counted), then P15_WARM warm runs (none: the
     cold run's figures stand): the median ms, the host build apart, the
     step peak and the cold run's
     launches (hash_bucket and digit_hist in every query whose exchange
     hashes an int32 / float32 key, digit_hist in the others), and
     -0.0 / 0.0 hashed to one bucket by the kernel;
 16. the reference's tier rules on phase 15's tables, with a float64 key
     g = 1e6 + k * 1e-3 (1M values float32 would merge) and a float64
     value v = +-1e8 + y on the fact frame and two int columns on the
     dimension frame: sum / mean of y > 950 beside max(x) by k (the
     reference's device tier: a logical or), the same beside min(name)
     over the join by k // 8 (its host tier: a count), a group-by on
     y > 950, a group-by and a join on g, a left join filling 0.5 into
     the two int columns, sum / mean of v beside min(name). Each query's
     reference tier checked, once cold, held to numpy exactly, then
     P15_WARM warm runs, reported as phase 15's;
 17. the reference's literal rule and numpy's integer widths on phase
     15's tables, with m = x - 2^31 (an int64 column holding -2^31, which
     the port holds as int32) and an int32 column i = x * 48271 mod 2^31:
     (a) filter(x < 2^40), which keeps every row, then counts and sum(x)
     by k; (b) the packed key k * 2^32 + y grouped with sum(x) and count;
     (c) -m beside m, left-joined to the dimension frame's w; (d) i * i
     and i * 3 + 7 beside big, which wrap in numpy's int32; (e) the RDD
     filter(lambda x: x < 2^40), which takes the host tier's row form at
     build (launching nothing) and keeps every row. (a)-(d) run
     on the reference's host tier (checked), each once cold, held to
     numpy under that tier's rules (exact int64, int32 wrapping), then
     P15_WARM warm runs, reported as phase 15's; hash_bucket and digit_hist
     in (a) and (c), digit_hist in (b) (its key is a wide pair),
     partition_pos in (c);
 18. the RDD API's host-tier answers on the card at 20M pairs (x % K, x)
     over K = 1M keys and a float32 column (numpy seed 18), 8 shards:
     (a) closures past int32 in the host tier's row form: map(lambda x:
     (x % K, x + 2^40)).reduce_by_key(lambda a, b: a + b) (exact int64
     sums; hash_bucket and digit_hist launch), the same joined to the
     K-row table and counted (partition_pos launches), filter(x < 2^40),
     map_values(v * 2^31), a float32 value * 2^40 as float64; (b)
     sample(True, 0.1, 7), take_sample(False / True, 1000, 7) and
     random_split([0.8, 0.2], 7), each equal to numpy's replay of the
     reference's PCG64 streams (the bands disjoint and covering); (c)
     count_approx_distinct at relative_sd 0.05 and 0.01 over the key and
     the (k, v) rows, equal to a numpy HyperLogLog of splitmix64 hashes;
     (d) count_approx, mean_approx, count_by_value_approx at P18D_ROWS =
     2M (cut from 20M: a DenseRDD's run through the host RDD's
     evaluators, one task a shard), final and exact under a long
     deadline, then count_approx with one shard slowed by
     faults.maybe_slow_task past a 0.3 s deadline: the estimate, not
     final, then the exact count; (e) to_local_iterator (rows in order, the host peak sampled),
     for_each, for_each_partition and save_as_text_file (bytes equal to
     numpy's formatting; the files removed after) at P18E_ROWS = 2M pairs
     (cut from 20M, where 18e alone took 233 s); (f)
     count_async and collect_async submitted back to back, reduce_async,
     on the main path's reduce, equal to the synchronous results. Each
     case once cold (checked, launches counted from 0) and three times
     warm: median ms, the host part apart, the step peak.
 19. the host RDD layer the reference hands off to, at bench-main's
     dense_range(20M).map(lambda x: (x % K, x * 0.5)) over K = 1M keys, 8
     shards, each case against numpy: (a) the reduce on the card,
     .to_rdd().map_partitions(v * 2).dense() and joined to the K-row
     table (launches by step: the card's reduce and the lifted rows'
     join); (b) cogroup with the table .map_values((len, sum)).dense()
     .count(), right_outer_join with a 1.1M-key table filtered to the
     rows with no left side, and a three-side cogroup (the host
     CoGroupedRDD: keys, list sizes and HashPartitioner(8) placement);
     (c) glom sizes against the shard counts, coalesce(2) and
     repartition(16) (sizes and rows against numpy's replay of the
     reference's placement); (d) flat_map, flat_map_values and
     pipe("cat") (lines equal numpy's formatting); (e) splits, compute
     and to_debug_string on the 20M-row node, checkpoint then glom()
     .count() on a 2M-row one (cut from 20M, where it took 21-24 s a
     run; 8 files, lineage cut; removed after) and
     parallelize(2M Python rows, 8).dense().reduce_by_key(op="add")
     .count(). Each case once cold and P19_WARM times warm: median ms,
     the card, host and lift (dense()'s from_numpy) parts apart.
 20. the reference's implicit host fall-throughs, each case against
     numpy or a plain Python replay: (a) bench-main's source at 2M rows
     through map(lambda x: (x % K, math.sqrt(x))) (a host MapperRDD: the
     trace refuses math.sqrt, as jax's), a host reduce_by_key, dense()
     and a join with the K-row table on the card (the join must launch
     all three kernels); (b) a join and a cogroup under
     HashPartitioner(16) (glom sizes, every key in its partition); (c)
     left_outer_join(fill_value=None) and a string right value; (d) a
     chunked dense_range under an untraceable map (no chunk built; the
     resident build's host answer); (e) dense_from_numpy of an object
     column (parallelized), reduced on the host, lifted and joined. Each
     case once cold and P20_WARM times warm: median ms, the card, host
     and lift parts apart, the step peak. (f) F21: numpy, math, float(),
     a branch, a hash and .item() on a row: the same tier (a host
     MapperRDD) and the same rows on the card as on the CPU.
 21. the row view and the frame planner's host tier, each case against
     numpy: (a) bench-main's chain (20M rows, 1M keys) with the value
     round(x.astype(np.float32) * 0.5, 1), reduced, joined with the
     K-row table and counted (a device _MapRDD; all three kernels), and
     the x.ndim / x.size and divmod(x, 7) closures at 2M rows, reduced
     by key, and round(x.astype(np.float32) * 0.37, 1) at 2M rows,
     equal to numpy's float32 replay bit for bit; (b) five frame queries on the host tier over a 400K-row
     fact frame and a 100K-row sku-%06d dimension: a string
     concatenation's group-by, a numpy UDF, a left join filling None, a
     string fill over a number column, the frame query under
     hint(tier="host"); (c) to_rdd() of a 20M-row device group-by to 1M
     keys, lifted back by dense() and counted. Each case once cold and
     P21_WARM times warm: median ms, the card, host and lift parts
     apart, the step peak.
 22. the streaming plane and the file sources: (a) a Spark Streaming
     event counter over 1M user ids at the reference's defaults (0.5 s
     interval, 10,000-record blocks, a 64-block queue, block
     backpressure): 2M generator events through
     update_state_by_key(op="add"), each batch folded on the card
     (state_fold.fold_pairs_device, wrapped to count its calls and None
     returns and to time its host build apart from the card part), the
     state equal to numpy's exact int64 sums with Python ints; (b) a
     second Context on the same checkpoint directory, the source
     extended to 2.5M, resumed at offset 2,000,000, no record folded
     twice; (c) 8 files of 250,000 "k,v" lines: text_file's 8 partitions
     (assign_files_to_partitions' groups), .map(parse).dense()
     .reduce_by_key(op="add").join(1M-row table).count() equal to numpy
     (all three kernels), cold and P22_WARM warm, the host part (read, parse,
     lift) apart; whole_text_files equal to the files; (d) a file tail
     appended with 4 chunks of 250,000 lines while it runs, folded on
     the card, and a localhost socket's 200,000 lines through
     foreach_rdd, each once in order. Records/s, batches, batch walls,
     the rate controller's depth, peaks and launches.
 23-25. the local runtime, the distributed backend and its native
     shuffle, push plan, coded shuffle and elastic fleet (each phase's
     function says what it runs).
 26. a fleet per rank: two ranks sharing the card over gloo
     (--phase26-rank RANK PORT, a process each), each a
     Context(mode="distributed", multihost=...) with 2 executors of its
     own, run 24a's lineage at 20M rows (the reduce on the card, two
     host shuffles on the rank's fleet, dense(), the join on the card):
     cold, checked against numpy, then 3 warm runs; both ranks' lifted
     rows equal (a digest each), every kernel launched; per rank the
     card, host and lift parts, the fleet's spawn, stage-binary bytes,
     host_get calls and the lift's agreement (bytes, ms) a run.
 27. the lock-order witness (vega_tpu_torch.lint.sync_witness): in a
     fresh process under VEGA_TPU_DEBUG_SYNC=1 (--phase27-leg), 23a's
     lineage on 8 task threads (all three kernels), three committed
     batches of 22a's stateful fold against numpy and one job in each of
     two pools, then check_clean(); the same case in the script's own
     process, without the flag. The witness's named locks, edges and
     roles observed, and the two cases' warm parts (23a's warm median,
     27b, 27c) beside each other; their walls hold cold runs in unlike
     processes and are printed apart.
Prints the radix-shape rows, the main path's rows/s, each plan's line,
each keyed config's line, config 3's line, one line per new op, one line
per phase-7 line and phase 7's summary, one line per phase-8 item, one
line per phase-9 leg and item, one line per phase-10 leg and item, one
line per phase-11 size, gf256 row and fold op, one line per phase-12
item, one line per phase-13 leg and rank and per 13d query (one process
and each rank), one line per phase-14 item and 14c rank, one line per
phase-15, phase-16 and phase-17 query, one line per phase-18,
phase-19, phase-20 and phase-21 case, phases 22-27's lines, the kernel
table as one JSON line (with phases 6-26's launches beside the main
path's), the card line, and last
{"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.

Exits non-zero without a result when no CUDA card is visible.

    python3 chip_smoke.py --phase 19 [--without hash|bucket|gc|pickle|threads]

builds the kernels and runs phase 19 alone, as the whole script runs it,
optionally with one of the host layer's fast paths (P19_PATHS) swapped
for its plain form; prints one JSON line of each case's times and writes
chiprun_out/p19_<PATH or all>.json.

    python3 chip_smoke.py --phase 20

builds the kernels and runs phase 20 alone; prints one JSON line of each
case's times, step peak and launches, and writes chiprun_out/p20.json.

    python3 chip_smoke.py --phase 21

the same for phase 21, writing chiprun_out/p21.json.

    python3 chip_smoke.py --phase 22

builds the kernels and runs phase 22 alone; prints its lines and one
JSON line, and writes chiprun_out/p22.json.

    python3 chip_smoke.py --phase 23|24|25|26|27

the same for each of phases 23-27, writing chiprun_out/p<N>.json.

    python3 chip_smoke.py --main-path-ab [--leg LEG] DIR_A DIR_B DIR_B DIR_A

runs one leg of each checkout DIR in turns (its own chip_smoke.py and
package, a process each), to compare two trees in one call: by default
(--leg main) phase 3, the main path; --leg frame 10a's fused frame query
and 10b's mixed aggregates, each cold and three times warm (medians of
the whole, the host build and the rest); --leg frame-profile three warm
10b runs under torch.profiler, their device time by kind (the copies
each way, the other device ops) and the ten costliest ops; --leg
p16-profile one warm run each of phase 16's f13_key and f12_or under
torch.profiler with memory: the costliest ops by time and by allocation,
the peak and each exchange's plan; --leg p1516 phases 15 and 16 as the
whole script runs them (warm medians of each query); --leg f14-profile
phase 16's f14_group and f14_join warm, plainly, under cProfile (the
package's host functions, the per-node checks apart) and under
torch.profiler (device ms and ops).
"""

import json
import math
import operator
import os
import shutil
import statistics
import subprocess
import sys
import threading
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
KEYED_WARM = 1                 # phases 5-6a: warm runs a config (cut from 3
                               # to keep the script inside its time limit)
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
    """A cold run checked against numpy, then KEYED_WARM warm runs (host
    build of the sources and each step timed apart), in one fresh Context; the
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
    for i in range(KEYED_WARM):
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
    log(f"{label}: {rows / med:,.0f} rows/s warm median of {len(warm)} "
        f"({warm} s; "
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
        before = [nd for nd in (ref() for ref, _ in lru.values())
                  if nd is not None and nd._block is not None]
        orig(rdd)
        live = [nd for nd in (ref() for ref, _ in lru.values())
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
    """(b) group_by(k).agg(sum, min, max, count, mean of x): one reduce
    with a named monoid per column; integers exact, the mean within rtol
    1e-5."""
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
    p10_check("10b takes a named monoid per column",
              "a named monoid per column" in explain)
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
    """(d) an untraceable UDF: the plan compiles on the host tier at
    explain(), with the reason, before any device work (no chain
    applied, no kernel launched, nothing allocated), and collects
    numpy's rows there, still launching nothing."""
    from vega_tpu_torch.frame import col, udf

    ctx = vt.Context(n_shards=N_SHARDS)
    x = np.arange(1000)
    df = ctx.create_frame(k=x % 7, x=x)
    q = df.with_column("m", udf(lambda c: np.asarray(c) + 1, col("x")))
    torch.cuda.synchronize()
    ck.reset_launches()
    mints = dense_rdd.program_mints()
    allocated = torch.cuda.memory_allocated()
    text = q.explain()
    p10_check(f"10d: an untraceable UDF compiles on the host tier "
              f"({text.splitlines()[0]})",
              text.startswith("== physical: host tier ==")
              and "stage does not trace" in text)
    got = q.collect_columns()
    torch.cuda.synchronize()
    p10_check("10d: the host tier's rows equal numpy's",
              np.array_equal(got["x"], x) and np.array_equal(got["m"], x + 1))
    p10_check("10d: no device work",
              dense_rdd.program_mints() == mints
              and all(c == 0 for c in ck.LAUNCHES.values())
              and torch.cuda.memory_allocated() == allocated)
    ctx.stop()
    reason = text.splitlines()[-1]
    log(f"10d untraceable UDF: {reason}")
    return dict(tier="host", reason=reason)


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


def p12_timed(torch, ck, label, build, run, check, must=(), phase=12,
              warm_runs=3):
    """One line of 12a-c (and of phase 14): a cold run (build + run,
    checked), then warm_runs warm ones, each its host build (the sources)
    and its device steps (run, ended by a synchronize) timed apart; the
    launches of the cold run's steps, which must include `must`, and the
    steps' peak."""
    src, build_ms, _, _ = p12_step(torch, ck, build)
    out, ms, launches, peak = p12_step(torch, ck, lambda: run(src))
    check(out)
    missing = [n for n in must if launches[n] <= 0]
    p12_check(f"{label}: kernels {missing} not launched ({launches})",
              not missing)
    warm, warm_build = [], []
    for _ in range(warm_runs):
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
    log(f"phase {phase} {label}: warm {row['median_ms']:.3f} ms (host "
        f"build {row['median_build_ms']:.3f} ms), cold {ms:.3f} ms, "
        f"launches {launches}, peak {peak} B")
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


# ---------------------------------------------------------------------------
# phase 13: the multi-process device tier, Context(multihost=...)
# ---------------------------------------------------------------------------

P13_TRACE_DIR = os.path.join("chiprun_out", "phase13_trace")
P13_ROWS_FILE = os.path.join("chiprun_out", "phase13_rows.npz")
P13_LEG_TIMEOUT_S = 400


def p13_check(what, ok):
    if not ok:
        fail(f"phase 13: {what}")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def p13_rows(joined):
    got = joined.collect_arrays()
    return {k: got[k] for k in ("k", "lv", "rv")}


def p13_same(np, got, want):
    """Bit for bit, in collect() order."""
    return all(got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                               want[k])
               for k in want)


def p13_trace(json_mod, path):
    """{device op name: (ms summed, calls)} of a trace's kernel, memcpy
    and memset events, and the CPU-side names of its nccl: collectives."""
    with open(path, encoding="utf-8") as fh:
        events = json_mod.load(fh).get("traceEvents", [])
    dev, cpu = {}, set()
    for e in events:
        nm = e.get("name", "")
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, calls = dev.get(nm, (0.0, 0))
            dev[nm] = (ms + float(e.get("dur", 0)) / 1e3, calls + 1)
        elif nm.startswith("nccl:"):
            cpu.add(nm)
    return dev, sorted(cpu)


def p13_run(torch, np, ck, vt, ctx, want, label):
    """One cold run of phase 3's pipeline in ctx (launches counted from 0,
    rows bit-identical to `want`), then three warm runs (wall s to a
    synchronize) and the wire counts of the last one."""
    from vega_tpu_torch import mesh as mesh_lib

    ck.reset_launches()
    t0 = time.perf_counter()
    joined = pipeline(ctx, np)
    count = joined.count()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    p13_check(f"{label} cold count {count}", count == N_KEYS)
    check_launched(launches, f"the {label} cold run")
    p13_check(f"{label} rows differ from phase 3's pipeline",
              p13_same(np, p13_rows(joined), want))
    del joined
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        before = dict(mesh_lib.WIRE)
        t0 = time.perf_counter()
        c = pipeline(ctx, np).count()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        p13_check(f"{label} warm count {c}", c == N_KEYS)
    wire = {k: mesh_lib.WIRE[k] - before[k] for k in before}
    med = statistics.median(warm)
    return dict(cold_s=cold_s, launches=launches, warm_s=warm,
                median_s=med, rows_per_s=N_ROWS / med,
                wire_per_warm_run=wire)


def phase13a_leg(port):
    """13a, in a process of its own: phase 3's pipeline in a one-process
    Context (the rows 13a and 13b must equal, saved for 13b), then
    through Context(multihost=...) at world size 1 with nccl: its rows
    bit-identical, all three kernels launched, warm rows/s, and one warm
    run under ctx.profiler() whose trace must hold NCCL kernels (the
    collective path ran, not the one-device one). Prints one JSON
    line."""
    import glob

    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck
    from vega_tpu_torch import mesh as mesh_lib

    ck.build()
    plain = vt.Context(n_shards=N_SHARDS)
    want = p13_rows(pipeline(plain, np))
    plain.stop()
    del plain
    os.makedirs(os.path.dirname(P13_ROWS_FILE), exist_ok=True)
    np.savez(P13_ROWS_FILE, **want)
    ctx = vt.Context(n_shards=N_SHARDS, multihost=dict(
        coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0))
    p13_check(f"13a mesh {ctx.mesh} over {mesh_lib.multihost_backend()}",
              ctx.mesh.collective and ctx.mesh.world == 1
              and mesh_lib.multihost_backend() == "nccl"
              and ctx.device.type == "cuda")
    res = p13_run(torch, np, ck, vt, ctx, want, "13a")
    shutil.rmtree(P13_TRACE_DIR, ignore_errors=True)
    plans_before = ctx.exchange_plans()
    wire_before = dict(mesh_lib.WIRE)
    torch.cuda.synchronize()
    with ctx.profiler(P13_TRACE_DIR):
        c = pipeline(ctx, np).count()
    wire = {k: mesh_lib.WIRE[k] - wire_before[k] for k in wire_before}
    plans = ctx.exchange_plans()
    exchanges = sum(plans[p] - plans_before[p]
                    for p in ("all_to_all", "staged", "ring"))
    p13_check(f"13a profiled count {c}", c == N_KEYS)
    files = glob.glob(os.path.join(P13_TRACE_DIR, "*.pt.trace.json"))
    p13_check(f"13a trace files {files}", len(files) == 1)
    dev, cpu_nccl = p13_trace(json, files[0])
    # NCCL's own kernels, and the device copies: a one-rank communicator
    # serves its collectives with copies, not kernels
    nccl = {nm[:100]: v for nm, v in dev.items() if "nccl" in nm.lower()}
    copies = {nm: v for nm, v in dev.items() if "DtoD" in nm}
    p13_check(f"13a trace lacks ProcessGroupNCCL's all_to_all / all_gather "
              f"records (CPU collectives {cpu_nccl}; device ops "
              f"{sorted(nm[:60] for nm in dev)})",
              {"nccl:all_to_all", "nccl:all_gather"} <= set(cpu_nccl))
    nccl_ms = sum(ms for ms, _ in nccl.values())
    busy = sum(ms for ms, _ in dev.values())
    shutil.rmtree(P13_TRACE_DIR, ignore_errors=True)
    ctx.stop()
    torch.distributed.destroy_process_group()
    res.update(nccl_kernels=nccl, nccl_ms=nccl_ms, device_copies=copies,
               device_busy_ms=busy,
               cpu_collectives=cpu_nccl, profiled_exchanges=exchanges,
               nccl_ms_per_exchange=nccl_ms / max(exchanges, 1),
               profiled_wire=wire)
    print(json.dumps(res), flush=True)


def phase13_rank_leg(rank, port, backend, cards):
    """13b / 13c, rank `rank` of two: phase 3's pipeline through
    Context(multihost=...) on cuda:{rank % cards} over `backend`, 4 of
    the 8 global shards here; the cold run's rows equal 13a's plain run
    bit for bit on this rank, then three warm runs and this process's
    peak device memory. Prints one JSON line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    ck.build()
    with np.load(P13_ROWS_FILE) as z:
        want = {k: z[k] for k in z.files}
    dev = f"cuda:{rank % cards}"
    ctx = vt.Context(device=dev, n_shards=N_SHARDS, multihost=dict(
        coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=rank,
        backend=backend))
    p13_check(f"rank {rank} mesh {ctx.mesh}",
              ctx.mesh.world == 2 and ctx.mesh.n_local == N_SHARDS // 2)
    torch.cuda.reset_peak_memory_stats(dev)
    res = p13_run(torch, np, ck, vt, ctx, want, f"rank {rank}")
    res.update(rank=rank, device=dev, backend=backend,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    ctx.stop()
    torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)


def p13_spawn(args_list):
    """Run `chip_smoke.py <args>` for each args at once, each in a process
    of its own; returns each one's JSON line, or fails with its stderr."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in args_list]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=P13_LEG_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for args, (rc, out, err) in zip(args_list, outs):
        if rc != 0 or not out.strip():
            fail(f"phase 13 leg {args} failed ({rc}):\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


P13D_ROWS_FILE = os.path.join("chiprun_out", "phase13d_rows.npz")
P13D_NPZ_PATH = os.path.join("chiprun_out", "phase13d_npz", "reduced.npz")
P13D_RELOAD_CHUNK_ROWS = 131_072  # 8 chunks of bench-main's 1M reduced pairs
P13D_WARM = {"frame": 1, "strings": 1, "npz": 1, "fold": 1}  # cut from
# 3 / 2 / 3 / 3: the script's time limit
P13D_FOLD_OPS = ("add", "min", "max", "prod")


def p13d_data(np):
    """Phase 10's frame tables, phase 9c's string tables and phase 11c's
    fold pairs, from their seeds: every process makes the same host data
    (every process runs the same program, SPMD)."""
    ev, dims = p10_data(np)
    rng = np.random.RandomState(13)
    keys = rng.randint(0, P11_FOLD_KEYS, size=P11_FOLD_PAIRS)
    vals = rng.randint(-1000, 1000, size=P11_FOLD_PAIRS)
    twos = (rng.rand(P11_FOLD_PAIRS) < 0.1).astype(np.int64) + 1
    return dict(ev=ev, dims=dims, strings=p9_strings_data(np),
                fold_keys=keys, fold_vals=vals, fold_twos=twos,
                fold_pairs=list(zip(keys.tolist(), vals.tolist())),
                fold_pairs_prod=list(zip(keys.tolist(), twos.tolist())))


def p13d_expected(np, data):
    """numpy's rows of each query, named as p13d_queries names them."""
    exp = {f"frame_{nm}": col for nm, col in
           p10_expected(np, data["ev"], data["dims"]).items()}
    s = p9_strings_expected(np, data["strings"])
    exp.update(str_k=s["k"], str_lv=s["lv"], str_rv=s["rv"])
    x = np.arange(N_ROWS, dtype=np.int64)
    exp["npz_k"] = np.arange(N_KEYS)
    exp["npz_v"] = np.bincount(x % N_KEYS, weights=x * 0.5,
                               minlength=N_KEYS)
    keys = data["fold_keys"]
    uniq = np.unique(keys)
    for op in P13D_FOLD_OPS:
        vals = data["fold_twos"] if op == "prod" else data["fold_vals"]
        acc = {"add": np.zeros, "min": lambda n, dtype: np.full(n, 1 << 40),
               "max": lambda n, dtype: np.full(n, -(1 << 40)),
               "prod": np.ones}[op](P11_FOLD_KEYS, dtype=np.int64)
        {"add": np.add, "min": np.minimum, "max": np.maximum,
         "prod": np.multiply}[op].at(acc, keys, vals)
        exp[f"fold_{op}_k"], exp[f"fold_{op}_v"] = uniq, acc[uniq]
    return exp


def p13d_step(torch, ck, run):
    """One run of one query: launches counted from 0, the allocator's
    peak above what was allocated at its start, mesh.WIRE's counts over
    the run, the whole wall (host clock, ending in a synchronize) and the
    host build apart (the run's own mark, else _FrameTimer's compile and
    source ms)."""
    from vega_tpu_torch import mesh as mesh_lib

    torch.cuda.synchronize()
    ck.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wire = dict(mesh_lib.WIRE)
    with _FrameTimer(torch) as timer:
        t0 = time.perf_counter()
        rows, build_ms, parts = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if build_ms is None:
        build_ms = timer.ms["compile"] + timer.ms["source"]
    return rows, dict(ms=ms, host_build_ms=build_ms, rest_ms=ms - build_ms,
                      parts=parts,
                      peak_bytes=torch.cuda.max_memory_allocated() - base,
                      launches=dict(ck.LAUNCHES),
                      wire={k: mesh_lib.WIRE[k] - wire[k] for k in wire})


def p13d_frame(ctx, data):
    got = p10_query(ctx, data["ev"], data["dims"]).collect_columns()
    return {f"frame_{nm}": got[nm] for nm in ("k", "sx", "sy")}, None, {}


def p13d_strings(torch, ctx, data):
    """Phase 9c's query: reduce -> join the dims (another dictionary) ->
    sort -> collect; the sources' build (the host encode) apart."""
    s = data["strings"]
    t0 = time.perf_counter()
    fact = ctx.dense_from_numpy(s["keys"], s["vals"])
    dims = ctx.dense_from_numpy(s["dims_k"], s["dims_v"])
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    got = (fact.reduce_by_key(op="add").join(dims).sort_by_key()
           .collect_arrays())
    return ({"str_k": got["k"], "str_lv": got["lv"], "str_rv": got["rv"]},
            build_ms, {})


def p13d_npz(torch, ctx):
    """bench-main's reduced 1M pairs through save_npz (every rank passes
    ONE path) and dense_load_npz, resident and in 8 chunks (the streamed
    fold's sums: one value per key, unchanged); the save is the host
    build."""
    from vega_tpu_torch import stream

    reduced = (ctx.dense_range(N_ROWS).map(lambda x: (x % N_KEYS, x * 0.5))
               .reduce_by_key(op="add"))
    reduced.block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = reduced.save_npz(P13D_NPZ_PATH)
    t1 = time.perf_counter()
    p13_check("13d save_npz returned its path with the file in place and "
              "no .tmp", path == P13D_NPZ_PATH and os.path.exists(path)
              and not os.path.exists(path + ".tmp"))
    res = ctx.dense_load_npz(path).collect_arrays()
    t2 = time.perf_counter()
    st = ctx.dense_load_npz(path, chunk_rows=P13D_RELOAD_CHUNK_ROWS)
    p13_check(f"13d reload streams in 8 chunks, not {st!r}",
              isinstance(st, stream.StreamedDenseRDD) and st.n_chunks == 8)
    sred = st.reduce_by_key(op="add").collect_arrays()
    t3 = time.perf_counter()
    return ({"npz_k": res["k"], "npz_v": res["v"],
             "npz_stream_k": sred["k"], "npz_stream_v": sred["v"]},
            (t1 - t0) * 1e3, dict(save_ms=(t1 - t0) * 1e3,
                                  resident_ms=(t2 - t1) * 1e3,
                                  streamed_ms=(t3 - t2) * 1e3))


def p13d_fold(np, ctx, data):
    """Phase 11c's fold per named op over the same 1M Python pairs; the
    host build (the lists to numpy, up to the source) apart, as 11c."""
    from vega_tpu_torch import state_fold

    marks, built = {}, ctx.dense_from_numpy

    def marked(*cols):
        marks["built"] = time.perf_counter()
        return built(*cols)

    rows, parts, build_ms = {}, {}, 0.0
    ctx.dense_from_numpy = marked
    try:
        for op in P13D_FOLD_OPS:
            t0 = time.perf_counter()
            got = state_fold.fold_pairs_device(ctx, data[
                "fold_pairs_prod" if op == "prod" else "fold_pairs"], op)
            parts[op + "_ms"] = (time.perf_counter() - t0) * 1e3
            build_ms += (marks["built"] - t0) * 1e3
            p13_check(f"13d fold {op} returned {type(got)}",
                      isinstance(got, dict))
            ks = np.array(sorted(got), dtype=np.int64)
            rows[f"fold_{op}_k"] = ks
            rows[f"fold_{op}_v"] = np.array([got[k] for k in ks.tolist()],
                                            dtype=np.int64)
    finally:
        del ctx.dense_from_numpy
    return rows, build_ms, parts


def p13d_queries(torch, np, ck, ctx, data, want, warm):
    """Each query once cold (its rows equal to `want`'s of the same name:
    numpy's values in the one-process run, the one-process run's rows
    bit for bit, dtypes too, on a rank; launches counted from 0), then
    its P13D_WARM runs when warm is True. Returns ({query: {cold, warm,
    medians}}, rows, launches summed over the cold runs)."""
    runs = {"frame": lambda: p13d_frame(ctx, data),
            "strings": lambda: p13d_strings(torch, ctx, data),
            "npz": lambda: p13d_npz(torch, ctx),
            "fold": lambda: p13d_fold(np, ctx, data)}
    out, rows = {}, {}
    launches = {name: 0 for name in ck.LAUNCHES}
    for q, run in runs.items():
        got, cold = p13d_step(torch, ck, run)
        bad = [nm for nm in got if nm in want and not (
            (got[nm].dtype == want[nm].dtype or not warm)
            and np.array_equal(got[nm], want[nm]))]
        p13_check(f"13d {q}: rows differ from "
                  f"{'the one-process run' if warm else 'numpy'} in {bad}",
                  not bad)
        rows.update(got)
        for name, c in cold["launches"].items():
            launches[name] += c
        res = dict(cold=cold, warm=[])
        for _ in range(P13D_WARM[q] if warm else 0):
            got, r = p13d_step(torch, ck, run)
            res["warm"].append(r)
            del got
        if res["warm"]:
            for key in ("ms", "host_build_ms", "rest_ms"):
                res["median_" + key] = statistics.median(
                    r[key] for r in res["warm"])
            res["peak_bytes"] = max(r["peak_bytes"] for r in res["warm"])
            res["wire_per_warm_run"] = res["warm"][-1]["wire"]
        out[q] = res
        log(f"13d {q}: {json.dumps(res)}")
    return out, rows, launches


def p13d_parent(torch, np, ck, vt):
    """13d's one-process run in this process, Context(n_shards=8): each
    query's rows against numpy (floats: the npz sums within rtol 1e-5 of
    float64), saved to P13D_ROWS_FILE for the ranks."""
    data = p13d_data(np)
    exp = p13d_expected(np, data)
    npz_v = exp.pop("npz_v")
    del exp["npz_k"]  # the reload keeps the reduce's placement
    ctx = vt.Context(n_shards=N_SHARDS)
    try:
        res, rows, launches = p13d_queries(torch, np, ck, ctx, data, exp,
                                           warm=False)
    finally:
        ctx.stop()
    order = np.argsort(rows["npz_k"], kind="stable")
    p13_check("13d one process: the npz rows' sums within rtol 1e-5 of "
              "numpy", np.allclose(rows["npz_v"][order].astype(np.float64),
                                   npz_v, rtol=1e-5, atol=0))
    p13_check("13d one process: the streamed reload's sums equal the "
              "resident reload's per key", np.array_equal(
                  rows["npz_stream_v"][np.argsort(rows["npz_stream_k"])],
                  rows["npz_v"][order]))
    os.makedirs(os.path.dirname(P13D_ROWS_FILE), exist_ok=True)
    np.savez(P13D_ROWS_FILE, **rows)
    del data, exp, rows
    return dict(queries=res, launches=launches)


def phase13d_rank_leg(rank, port):
    """13d, rank `rank` of two on the one card over gloo, 4 of the 8
    global shards here: every query cold, its rows bit-identical to the
    one-process run's (P13D_ROWS_FILE), then its warm runs; warm ms, the
    host build apart, peak bytes and mesh.WIRE per warm run, the cold
    runs' launches. Prints one JSON line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    ck.build()
    with np.load(P13D_ROWS_FILE) as z:
        want = {k: z[k] for k in z.files}
    data = p13d_data(np)
    ctx = vt.Context(device="cuda:0", n_shards=N_SHARDS, multihost=dict(
        coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=rank,
        backend="gloo"))
    p13_check(f"13d rank {rank} mesh {ctx.mesh}",
              ctx.mesh.world == 2 and ctx.mesh.n_local == N_SHARDS // 2)
    res, _, launches = p13d_queries(torch, np, ck, ctx, data, want,
                                    warm=True)
    ctx.stop()
    torch.distributed.destroy_process_group()
    print(json.dumps(dict(rank=rank, queries=res, launches=launches)),
          flush=True)


def phase_thirteen(torch, np, ck, vt, main_path):
    """Phase 13: (a) NCCL at world size 1 at bench-main's full size, (b)
    two ranks sharing the one card over gloo, (c) two cards under NCCL
    when there are two, (d) the frame, string, checkpoint and fold
    queries one-process here, then on two ranks sharing the card over
    gloo. Each leg runs in processes of its own."""
    torch.cuda.empty_cache()  # the legs allocate on the same card
    t0 = time.perf_counter()
    a = p13_spawn([["--phase13a", free_port()]])[0]
    log(f"phase 13a NCCL world 1: {a['rows_per_s']:,.0f} rows/s warm "
        f"(phase 3: {main_path['rows_per_s']:,.0f}), launches "
        f"{a['launches']}, NCCL kernels {a['nccl_kernels']}")
    port = free_port()
    b = p13_spawn([["--phase13-rank", r, port, "gloo", 1] for r in (0, 1)])
    log(f"phase 13b two ranks on one card over gloo: {b}")
    cards = torch.cuda.device_count()
    c = None
    if cards >= 2:
        port = free_port()
        c = p13_spawn([["--phase13-rank", r, port, "nccl", cards]
                       for r in (0, 1)])
    if os.path.exists(P13_ROWS_FILE):
        os.remove(P13_ROWS_FILE)
    t_d = time.perf_counter()
    d_one = p13d_parent(torch, np, ck, vt)
    torch.cuda.empty_cache()
    port = free_port()
    try:
        d = p13_spawn([["--phase13d-rank", r, port] for r in (0, 1)])
    finally:
        if os.path.exists(P13D_ROWS_FILE):
            os.remove(P13D_ROWS_FILE)
        shutil.rmtree(os.path.dirname(P13D_NPZ_PATH), ignore_errors=True)
    d_launches = {name: sum(r["launches"][name] for r in d)
                  for name in d[0]["launches"]}
    check_launched(d_launches, "phase 13d's two ranks")
    launches = {name: a["launches"][name] + d_launches[name]
                + sum(r["launches"][name] for r in b) for name in a["launches"]}
    return dict(a=a, b=b, c=c, d_one_process=d_one, d=d,
                d_launches=d_launches, d_wall_s=time.perf_counter() - t_d,
                cards=cards, launches=launches,
                wall_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 14: the RDD API against the reference (positional arguments, the
# nine names its device tier answers) and queue 1 item 7's host-tier names
# ---------------------------------------------------------------------------

P14C_ROWS = 2_000_000
P14C_KEYS = 100_000
P14C_ROWS_FILE = os.path.join("chiprun_out", "phase14c_rows.npz")
P14C_WARM = 1                  # cut from 2: the script's time limit


def p14_check(what, ok):
    if not ok:
        fail(f"phase 14: {what}")


def p14_pairs(ctx, n, k):
    """(x % k, x) over dense_range(n): int32 values, so every sum is an
    exact integer."""
    return ctx.dense_range(n).map(lambda x: (x % k, x))


def p14_half_table(ctx, np, k):
    """k rows over the keys [k/2, 3k/2), value 3 * key (int32): half of
    the pairs' keys, and as many it lacks."""
    tk = np.arange(k // 2, k // 2 + k, dtype=np.int32)
    return ctx.dense_from_numpy(tk, tk * 3)


def p14_expected(np, n, k):
    """numpy's per-key sums and row counts (int64) of p14_pairs."""
    x = np.arange(n, dtype=np.int64)
    return (np.bincount(x % k, weights=x, minlength=k).astype(np.int64),
            np.bincount(x % k, minlength=k).astype(np.int64))


def p14_by_key(np, got, name="v"):
    """A collect_arrays() result's keys and `name` column in key order."""
    order = np.argsort(got["k"], kind="stable")
    return got["k"][order].astype(np.int64), got[name][order]


def p14_outer_arrays(np, rows):
    """full_outer_join's collect() rows as int64 columns k, lv, rv, with
    0 and a None mask on the missing side, in collect() order."""
    out = {}
    k = np.fromiter((r[0] for r in rows), np.int64, len(rows))
    for i, nm in ((0, "lv"), (1, "rv")):
        vals = [r[1][i] for r in rows]
        none = np.fromiter((x is None for x in vals), np.bool_, len(rows))
        out[nm] = np.fromiter((0 if x is None else x for x in vals),
                              np.int64, len(rows))
        out[nm + "_none"] = none
    out["k"] = k
    return out


def p14_repairs(torch, np, ck, vt):
    """14a: the positional calls the reference takes (each against the
    keyword call's rows and numpy) and the nine device-tier names, at
    bench-main's N_ROWS pairs over N_KEYS keys with int32 values."""
    import operator

    from vega_tpu_torch import dense_rdd

    n, k = N_ROWS, N_KEYS
    sums, counts = p14_expected(np, n, k)
    keys = np.arange(k, dtype=np.int64)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []

    def item(label, build, run, check, warm_runs=3):
        rows.append(p12_timed(torch, ck, "14a " + label, build, run, check,
                              phase=14, warm_runs=warm_runs))

    def host_arrays(node):
        """A join under a partition count: the host RDD layer's, as the
        reference's; its (k, (lv, rv)) rows as int64 columns."""
        p14_check(f"14a a join under a partition count is not the host "
                  f"layer's ({type(node).__name__})",
                  not isinstance(node, dense_rdd.DenseRDD)
                  and node.num_partitions == 8)
        k_, lr = zip(*node.collect())
        lv, rv = zip(*lr)
        return {nm: np.asarray(c, np.int64) for nm, c in
                (("k", k_), ("lv", lv), ("rv", rv))}

    def pairs():
        return p14_pairs(ctx, n, k)
    try:
        kw_red = pairs().reduce_by_key(op="add").collect_arrays()
        p14_check("14a reduce_by_key(op='add') differs from numpy",
                  np.array_equal(p14_by_key(np, kw_red)[1], sums))

        def same_as_kw(got):
            p14_check("14a reduce_by_key(add, 8): rows differ from "
                      "reduce_by_key(op='add')'s", all(
                          np.array_equal(got[c], kw_red[c]) for c in "kv"))
        item("reduce_by_key(operator.add, 8)", pairs,
             lambda s: s.reduce_by_key(operator.add, 8).collect_arrays(),
             same_as_kw)

        kw_sort = pairs().sort_by_key().collect_arrays()

        def same_sort(got):
            p14_check("14a sort_by_key(True, 8, 4096): rows differ from "
                      "sort_by_key()'s, or keys not ascending", all(
                          np.array_equal(got[c], kw_sort[c]) for c in "kv")
                      and bool(np.all(np.diff(got["k"]) >= 0)))
        item("sort_by_key(True, 8, 4096)", pairs,
             lambda s: s.sort_by_key(True, 8, 4096).collect_arrays(),
             same_sort)
        del kw_sort

        def table():
            return ctx.dense_from_numpy(keys.astype(np.int32),
                                        (keys * 3).astype(np.int32))
        kw_join = pairs().reduce_by_key(op="add").join(
            table()).collect_arrays()

        def same_join(got):
            kk, lv = p14_by_key(np, got, "lv")
            p14_check("14a join(table, 8): rows differ from join(table)'s "
                      "or numpy", all(np.array_equal(
                          p14_by_key(np, got, c)[1],
                          p14_by_key(np, kw_join, c)[1])
                          for c in ("lv", "rv"))
                      and np.array_equal(kk, keys)
                      and np.array_equal(lv, sums))
        # the host layer's join of 2M rows: one warm run
        item("reduce_by_key(op='add').join(table, 8)",
             lambda: (pairs(), table()),
             lambda s: host_arrays(s[0].reduce_by_key(op="add").join(
                 s[1], 8)), same_join, warm_runs=1)

        total = n * (n - 1) // 2
        item("dense_range(N, 8): count() and fold(0, add)", lambda: None,
             lambda _: (ctx.dense_range(n, 8).count(),
                        ctx.dense_range(n, 8).fold(0, operator.add),
                        ctx.dense_range(n).count()),
             lambda got: p14_check(f"14a dense_range(N, 8) {got}",
                                   got == (n, total, n)))

        def check_loj(got):
            kk, rv = p14_by_key(np, got, "rv")
            _, lv = p14_by_key(np, got, "lv")
            p14_check("14a left_outer_join(half table, 8) does not fill 0 "
                      "exactly at the missing keys", np.array_equal(kk, keys)
                      and np.array_equal(lv, sums) and np.array_equal(
                          rv, np.where(kk < k // 2, 0, kk * 3)))
        item("reduce_by_key(op='add').left_outer_join(half table, 8)",
             lambda: (pairs(), p14_half_table(ctx, np, k)),
             lambda s: host_arrays(s[0].reduce_by_key(op="add")
                                   .left_outer_join(s[1], 8)), check_loj,
             warm_runs=1)

        def check_fbk(got):
            kk, v = p14_by_key(np, got)
            p14_check("14a fold_by_key(1, add) != per-key sum + count",
                      np.array_equal(kk, keys)
                      and np.array_equal(v, sums + counts))
        item("fold_by_key(1, add)", pairs,
             lambda s: s.fold_by_key(1, operator.add).collect_arrays(),
             check_fbk)

        def check_abk(got):
            kk, v = p14_by_key(np, got)
            p14_check("14a aggregate_by_key(5, add, max) != per-key max + 5",
                      np.array_equal(kk, keys) and np.array_equal(
                          v, keys + (n // k - 1) * k + 5))
        item("aggregate_by_key(5, add, max)", pairs,
             lambda s: s.aggregate_by_key(5, operator.add, max)
             .collect_arrays(), check_abk)

        def check_group_by(got):
            gk, off, vals = got
            size = np.diff(off)
            gsum = np.add.reduceat(vals.astype(np.int64), off[:-1])
            order = np.argsort(gk, kind="stable")
            p14_check("14a group_by(x % K): groups differ from numpy",
                      np.array_equal(gk[order], keys)
                      and np.array_equal(size[order], counts)
                      and np.array_equal(gsum[order], sums))
        item("group_by(lambda x: x % K) of dense_range(N)",
             lambda: ctx.dense_range(n),
             lambda s: s.group_by(lambda x: x % k).collect_grouped(),
             check_group_by)

        item("sort_by(lambda x: -x) of dense_range(N)",
             lambda: ctx.dense_range(n),
             lambda s: s.sort_by(lambda x: -x).collect_arrays()["v"],
             lambda got: p14_check(
                 "14a sort_by(-x) is not N - 1 .. 0", np.array_equal(
                     got, np.arange(n - 1, -1, -1, dtype=np.int32))))

        x = np.arange(n, dtype=np.int64)
        even = (x % k) % 2 == 0
        item("mask_keys(even): count() and values().fold(0, add)", pairs,
             lambda s: (s.mask_keys(lambda kk: kk % 2 == 0).count(),
                        s.mask_keys(lambda kk: kk % 2 == 0).values()
                        .fold(0, operator.add)),
             lambda got: p14_check(f"14a mask_keys {got}", got == (
                 int(even.sum()), int(x[even].sum()))))
        del x, even

        rows.append(p14_cache(torch, np, ck, dense_rdd, ctx, pairs, sums))
        node = pairs()
        p14_check("14a num_partitions / dense() / id()",
                  node.num_partitions == N_SHARDS and node.dense() is node
                  and node.id() == node.rdd_id)
    finally:
        ctx.stop()
    return rows


def p14_cache(torch, np, ck, dense_rdd, ctx, pairs, sums):
    """cache() of bench-main's reduce: a first action materializes it, a
    second reads the same block: no registration in the lifetime LRU for
    the node (phase 8e's counter), no kernel launched."""
    registered = []
    orig = dense_rdd._lifetime_register

    def counting(rdd):
        registered.append(rdd.rdd_id)
        return orig(rdd)
    dense_rdd._lifetime_register = counting
    try:
        node = pairs().reduce_by_key(op="add")
        p14_check("14a cache() returns the node at MEMORY_ONLY",
                  node.cache() is node
                  and node._storage_level.name == "MEMORY_ONLY")
        first, ms, launches, peak = p12_step(torch, ck, node.count)
        before = len(registered)
        blk = node._block
        got, warm_ms, warm_launches, _ = p12_step(
            torch, ck, node.collect_arrays)
    finally:
        dense_rdd._lifetime_register = orig
    p14_check(f"14a cache(): the second action re-registered "
              f"{registered[before:]} or launched {warm_launches}",
              first == N_KEYS and node.rdd_id in registered[:before]
              and registered[before:] == [] and node._block is blk
              and not any(warm_launches.values()))
    p14_check("14a cache(): sums differ from numpy",
              np.array_equal(p14_by_key(np, got)[1], sums))
    row = dict(label="14a cache(): count() then collect_arrays()",
               cold_ms=ms, median_ms=warm_ms, warm_ms=[warm_ms],
               median_build_ms=0.0, rows_per_s=N_ROWS / (warm_ms / 1e3),
               launches=launches,
               second_action_launches=warm_launches, peak_bytes=peak)
    log(f"phase 14 {row['label']}: first {ms:.3f} ms, second (cached) "
        f"{warm_ms:.3f} ms, launches {launches} then {warm_launches}")
    return row


def p14_item7(torch, np, ck, vt):
    """14b: item 7's forms, each against numpy: the reduced 1M keys with a
    1M-row table over [K/2, 3K/2) (full_outer_join, subtract_by_key,
    group_with), partition_by_key(8) of the 20M pairs, and fold /
    aggregate of dense_range(N) past 2^31."""
    import operator

    from vega_tpu_torch import dense_rdd, kernels

    n, k = N_ROWS, N_KEYS
    sums, _ = p14_expected(np, n, k)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []

    def item(label, build, run, check):
        rows.append(p12_timed(torch, ck, "14b " + label, build, run, check,
                              phase=14))

    def sides():
        return (p14_pairs(ctx, n, k).reduce_by_key(op="add"),
                p14_half_table(ctx, np, k))
    try:
        def check_foj(got):
            cnt, rws = got
            a = p14_outer_arrays(np, rws)
            kk = a["k"]
            p14_check(f"14b full_outer_join: {cnt} rows, not 3K/2",
                      cnt == len(rws) == k + k // 2
                      and np.array_equal(np.sort(kk),
                                         np.arange(k + k // 2)))
            left = kk < k
            right = kk >= k // 2
            p14_check("14b full_outer_join: None not exactly at the "
                      "missing side, or values differ from numpy",
                      np.array_equal(a["lv_none"], ~left)
                      and np.array_equal(a["rv_none"], ~right)
                      and np.array_equal(a["lv"][left], sums[kk[left]])
                      and np.array_equal(a["rv"][right], kk[right] * 3))
        item("full_outer_join(half table): count() and collect()", sides,
             lambda s: (s[0].full_outer_join(s[1]).count(),
                        s[0].full_outer_join(s[1]).collect()), check_foj)

        def check_sbk(got):
            kk, v = p14_by_key(np, got)
            p14_check("14b subtract_by_key: not the K/2 keys the table "
                      "lacks with their sums", np.array_equal(
                          kk, np.arange(k // 2)) and np.array_equal(
                          v, sums[:k // 2]))
        item("subtract_by_key(half table)", sides,
             lambda s: s[0].subtract_by_key(s[1]).collect_arrays(),
             check_sbk)

        def check_gw(got):
            gk, lo, lv, ro, rv = got
            nl, nr = np.diff(lo), np.diff(ro)
            order = np.argsort(gk, kind="stable")
            gk = gk[order].astype(np.int64)
            in_l, in_r = gk < k, gk >= k // 2
            p14_check("14b group_with: keys or group sizes differ from "
                      "numpy", np.array_equal(gk, np.arange(k + k // 2))
                      and np.array_equal(nl[order], in_l.astype(np.int64))
                      and np.array_equal(nr[order], in_r.astype(np.int64)))
            lsum = np.zeros(len(nl), np.int64)
            rsum = np.zeros(len(nr), np.int64)
            lsum[nl > 0] = lv.astype(np.int64)
            rsum[nr > 0] = rv.astype(np.int64)
            p14_check("14b group_with: values differ from numpy",
                      np.array_equal(lsum[order][in_l], sums[gk[in_l]])
                      and np.array_equal(rsum[order][in_r], gk[in_r] * 3))
        item("group_with(half table).collect_grouped()", sides,
             lambda s: s[0].group_with(s[1]).collect_grouped(), check_gw)

        def part_run(s):
            p = s.partition_by_key(8)
            blk = p.block()
            bucket = dense_rdd._bucket_cols(blk.cols, N_SHARDS,
                                            p._key_dtype())
            valid = kernels.valid_mask(bucket.shape[1], blk.counts)
            own = torch.arange(N_SHARDS, device=bucket.device)[:, None]
            misplaced = int(((bucket != own) & valid).sum())
            return (p.count(), misplaced, p.hash_placed,
                    p.reduce_by_key(op="add").collect_arrays())

        def check_part(got):
            cnt, misplaced, placed, red = got
            p14_check(f"14b partition_by_key: {cnt} rows, {misplaced} "
                      f"misplaced, hash_placed {placed}",
                      cnt == n and misplaced == 0 and placed)
            p14_check("14b partition_by_key's rows reduce to numpy's sums",
                      np.array_equal(p14_by_key(np, red)[1], sums))
        item("partition_by_key(8) of the 20M pairs, placed and reduced",
             lambda: p14_pairs(ctx, n, k), part_run, check_part)

        total = n * (n - 1) // 2
        item("fold(0, add), fold(10, add), aggregate(0, add, add) of "
             "dense_range(N)", lambda: ctx.dense_range(n),
             lambda s: (s.fold(0, operator.add), s.fold(10, operator.add),
                        s.aggregate(0, operator.add, operator.add)),
             lambda got: p14_check(f"14b fold / aggregate {got}", got == (
                 total, total + 10 * (N_SHARDS + 1), total)
                 and total > 2**31))
    finally:
        ctx.stop()
    return rows


def p14c_queries(np, ctx):
    """14c's five queries at P14C_ROWS pairs over P14C_KEYS keys, as
    int64 / bool columns in collect() order."""
    import operator

    n, k = P14C_ROWS, P14C_KEYS
    pairs = p14_pairs(ctx, n, k)
    table = p14_half_table(ctx, np, k)
    red = pairs.reduce_by_key(op="add")
    out = {}
    got = pairs.fold_by_key(1, operator.add).collect_arrays()
    out["fbk_k"], out["fbk_v"] = got["k"], got["v"]
    for nm, col in p14_outer_arrays(
            np, red.full_outer_join(table).collect()).items():
        out["foj_" + nm] = col
    got = red.subtract_by_key(table).collect_arrays()
    out["sbk_k"], out["sbk_v"] = got["k"], got["v"]
    out["sort_by"] = ctx.dense_range(n).sort_by(
        lambda x: -x).collect_arrays()["v"]
    rng = ctx.dense_range(n)
    out["fold"] = np.array([rng.fold(0, operator.add),
                            rng.fold(10, operator.add)], np.int64)
    return out


def p14c_expected(np, got):
    """14c's rows against numpy (order-free by key)."""
    n, k = P14C_ROWS, P14C_KEYS
    sums, counts = p14_expected(np, n, k)
    kk, v = p14_by_key(np, {"k": got["fbk_k"], "v": got["fbk_v"]})
    p14_check("14c fold_by_key != per-key sum + count",
              np.array_equal(v, sums + counts))
    fk = got["foj_k"]
    left, right = fk < k, fk >= k // 2
    p14_check("14c full_outer_join differs from numpy",
              len(fk) == k + k // 2
              and np.array_equal(got["foj_lv_none"], ~left)
              and np.array_equal(got["foj_rv_none"], ~right)
              and np.array_equal(got["foj_lv"][left], sums[fk[left]])
              and np.array_equal(got["foj_rv"][right], fk[right] * 3))
    sk, sv = p14_by_key(np, {"k": got["sbk_k"], "v": got["sbk_v"]})
    p14_check("14c subtract_by_key differs from numpy",
              np.array_equal(sk, np.arange(k // 2))
              and np.array_equal(sv, sums[:k // 2]))
    p14_check("14c sort_by(-x) is not n - 1 .. 0", np.array_equal(
        got["sort_by"], np.arange(n - 1, -1, -1)))
    total = n * (n - 1) // 2
    p14_check(f"14c fold {got['fold']}", got["fold"].tolist() == [
        total, total + 10 * (N_SHARDS + 1)])


def p14c_run(torch, np, ck, ctx, want, warm):
    """The queries once cold (launches from 0; rows equal to `want` bit
    for bit, dtypes too, when given, else to numpy), then `warm` warm
    runs (ms to a synchronize)."""
    got, ms, launches, peak = p12_step(torch, ck, lambda: p14c_queries(
        np, ctx))
    if want is None:
        p14c_expected(np, got)
    else:
        bad = [nm for nm in want if not (got[nm].dtype == want[nm].dtype
                                         and np.array_equal(got[nm],
                                                            want[nm]))]
        p14_check(f"14c rows differ from the one-process run in {bad}",
                  not bad)
    warm_ms = [p12_step(torch, ck, lambda: p14c_queries(np, ctx))[1]
               for _ in range(warm)]
    return got, dict(cold_ms=ms, launches=launches, peak_bytes=peak,
                     warm_ms=warm_ms,
                     median_ms=statistics.median(warm_ms) if warm_ms
                     else None)


def phase14c_rank_leg(rank, port):
    """14c, rank `rank` of two on the one card over gloo, 4 of the 8
    global shards here: the five queries cold, rows bit-identical to the
    one-process run's (P14C_ROWS_FILE), then P14C_WARM warm runs. Prints
    one JSON line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    ck.build()
    with np.load(P14C_ROWS_FILE) as z:
        want = {k: z[k] for k in z.files}
    ctx = vt.Context(device="cuda:0", n_shards=N_SHARDS, multihost=dict(
        coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=rank,
        backend="gloo"))
    p14_check(f"14c rank {rank} mesh {ctx.mesh}",
              ctx.mesh.world == 2 and ctx.mesh.n_local == N_SHARDS // 2)
    _, res = p14c_run(torch, np, ck, ctx, want, P14C_WARM)
    ctx.stop()
    torch.distributed.destroy_process_group()
    res["rank"] = rank
    print(json.dumps(res), flush=True)


def p14_multihost(torch, np, ck, vt):
    """14c: the queries in one process here (against numpy; rows saved),
    then on two ranks sharing the card over gloo, each rank's rows
    bit-identical to the one process's."""
    ctx = vt.Context(n_shards=N_SHARDS)
    try:
        rows, one = p14c_run(torch, np, ck, ctx, None, 0)
    finally:
        ctx.stop()
    os.makedirs(os.path.dirname(P14C_ROWS_FILE), exist_ok=True)
    np.savez(P14C_ROWS_FILE, **rows)
    del rows
    torch.cuda.empty_cache()
    port = free_port()
    try:
        ranks = p13_spawn([["--phase14c-rank", r, port] for r in (0, 1)])
    finally:
        if os.path.exists(P14C_ROWS_FILE):
            os.remove(P14C_ROWS_FILE)
    log(f"phase 14c one process: {json.dumps(one)}; two ranks over gloo: "
        f"{json.dumps(ranks)}")
    return dict(one_process=one, ranks=ranks)


def phase_fourteen(torch, np, ck, vt):
    """Phase 14: (a) the repairs, (b) item 7, (c) across two ranks; the
    launches summed over (a)-(b)'s cold runs, 14c's one-process run and
    both ranks' cold runs."""
    t0 = time.perf_counter()
    repairs = p14_repairs(torch, np, ck, vt)
    item7 = p14_item7(torch, np, ck, vt)
    multi = p14_multihost(torch, np, ck, vt)
    launches = {name: sum(r["launches"][name] for r in repairs + item7)
                + multi["one_process"]["launches"][name]
                + sum(r["launches"][name] for r in multi["ranks"])
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 14")
    wall_s = time.perf_counter() - t0
    log(f"phase 14 took {wall_s:.1f} s")
    return dict(repairs=repairs, item7=item7, multihost=multi,
                launches=launches, wall_s=wall_s)


P15_ROWS = 20_000_000          # frame_ab.py's events rows at bench-main's size
P15_WARM = 0                   # phases 15-17: warm runs a query (cut from 3,
                               # then 1, to keep the script inside its time
                               # limit: their host-bound queries read within
                               # a few % cold and warm); 0: the cold run's
                               # figures stand for them (p15_timed)
P15_KEYS = 1_000_000           # fact k uniform in [0, P15_KEYS)
P15_DIMS = 1_000_000           # dimension rows, keys 2 * i: half the fact keys
#                                match, and half the dimension keys never occur
P15_NANS = 1_000               # NaN rows of the float key
P15_BIG = 1 << 40              # big in [2^40, 2^40 + 2^31)
P15_EQ_ROW = 61                # the dimension row holding "sku-000123"
P15_GROUP = 8                  # c_mixed groups k // 8: four names a group
P15_QUERIES = ("a_inner", "a_left", "b_eq", "b_lt", "b_cols", "c_mixed",
               "d_agg", "d_sort", "d_key", "e_float")
# the queries whose exchanges hash an int32 or float32 key: hash_bucket
# must launch there (d_sort's range exchange and d_key's wide key, hashed
# by hash32_pair in torch ops, do not hash through it)
P15_HASHED = ("a_inner", "a_left", "b_eq", "b_lt", "b_cols", "c_mixed",
              "d_agg", "e_float")


def p15_timed(warm, cold):
    """The runs a query's medians are taken over: the warm runs, else the
    cold one; and how a line names them."""
    if warm:
        return warm, f"warm median of {len(warm)}"
    return [cold], "the cold run"


def p15_check(what, ok):
    if not ok:
        fail(f"phase 15: {what}")


def p15_data(np):
    """A 20M-row fact table (k over 1M keys, x the row id, y in [0, 1000),
    big in [2^40, 2^40 + 2^31), f a float32 key of 1M distinct values
    with 0.0 among them, half its zeros -0.0 and P15_NANS rows NaN) and a
    1M-row dimension table (k = 2 * i, name sku-%06d of a permutation,
    name2 equal to name on even rows, w float32)."""
    rng = np.random.default_rng(15)
    n = P15_ROWS
    k = rng.integers(0, P15_KEYS, n)
    f = ((k - P15_KEYS // 2) * 0.25).astype(np.float32)
    zeros = np.flatnonzero(f == 0)
    f[zeros[::2]] = -0.0
    f[rng.choice(n, P15_NANS, replace=False)] = np.nan
    fact = {"k": k, "x": np.arange(n, dtype=np.int64),
            "y": rng.integers(0, 1000, n),
            "big": P15_BIG + rng.integers(0, 1 << 31, n), "f": f}
    perm = rng.permutation(P15_DIMS)
    at = int(np.flatnonzero(perm == 123)[0])
    perm[[at, P15_EQ_ROW]] = perm[[P15_EQ_ROW, at]]
    alt = np.where(np.arange(P15_DIMS) % 2 == 0, perm,
                   (perm + 1) % P15_DIMS)
    words = np.char.mod("sku-%06d", np.arange(P15_DIMS))
    dims = {"k": 2 * np.arange(P15_DIMS, dtype=np.int64),
            "name": words[perm], "name2": words[alt],
            "w": rng.random(P15_DIMS).astype(np.float32)}
    return fact, dims, words, perm


def p15_query(ctx, fact, dims, q):
    """One of phase 15's queries over frames built from the host columns
    (the build is part of the run, timed apart as its host build)."""
    from vega_tpu_torch.frame import F, col, lit

    def fa(*cols):
        return ctx.create_frame(**{c: fact[c] for c in cols})

    def dm(*cols):
        return ctx.create_frame(**{c: dims[c] for c in ("k",) + cols})

    if q in ("a_inner", "a_left"):
        return fa("k", "x", "y", "big").join(
            dm("name", "w"), on="k", how="inner" if q == "a_inner" else "left")
    if q == "b_eq":
        return fa("k", "x").join(dm("name"), on="k").filter(
            col("name") == lit("sku-000123"))
    if q == "b_lt":
        return fa("k", "x").join(dm("name"), on="k").filter(
            col("name") < lit("sku-500000")).select("k", "x")
    if q == "b_cols":
        return fa("k", "x").join(dm("name", "name2"), on="k").filter(
            col("name") == col("name2")).select("k", "x")
    if q == "c_mixed":
        return fa("k", "x", "y").join(dm("name"), on="k").with_column(
            "g", col("k") // P15_GROUP).group_by("g").agg(
                F.min("name", "lo"), F.max("name", "hi"), F.sum("x", "sx"),
                F.mean("y", "my"))
    if q == "d_agg":
        return fa("k", "big").group_by("k").agg(
            F.sum("big", "s"), F.max("big", "mx"), F.mean("big", "m"))
    if q == "d_sort":
        return fa("x", "big").sort("big")
    if q == "d_key":
        return fa("big").group_by("big").agg(F.count("n")).sort("big")
    return fa("f", "x").group_by("f").agg(F.sum("x", "s"), F.count("n"))


def p15_rows_by_id(np, n, out_x):
    """(mask of fact rows present, exactly once each) from the x column."""
    seen = np.bincount(out_x, minlength=n)
    return seen == 1, bool((seen <= 1).all())


def p15_expect(torch, np, q, got, fact, dims, words, perm):
    """Hold one query's columns to numpy: integers and strings exactly,
    floats within rtol 1e-5, NaN groups counted. Returns a note."""
    n = P15_ROWS
    k, x = fact["k"], fact["x"]
    even = k % 2 == 0
    if q in ("a_inner", "a_left", "b_lt", "b_cols"):
        if q == "a_inner" or q == "b_lt" or q == "b_cols":
            keep = even.copy()
            if q == "b_lt":
                keep &= perm[np.minimum(k // 2, P15_DIMS - 1)] < 500_000
            if q == "b_cols":
                keep &= (k // 2) % 2 == 0
        else:
            keep = np.ones(n, bool)
        present, once = p15_rows_by_id(np, n, got["x"])
        p15_check(f"{q}: each expected row once ({int(present.sum())} rows, "
                  f"{int(keep.sum())} expected)",
                  once and np.array_equal(present, keep))
        ox = got["x"]
        p15_check(f"{q}: k exact", np.array_equal(got["k"], k[ox]))
        if q in ("a_inner", "a_left"):
            j = got["k"] // 2
            matched = got["k"] % 2 == 0
            jm = np.where(matched, j, 0)
            p15_check(f"{q}: y and big exact",
                      np.array_equal(got["y"], fact["y"][ox])
                      and np.array_equal(got["big"], fact["big"][ox])
                      and got["big"].dtype == np.int64)
            want_name = np.where(matched, words[perm[jm]], "0")
            want_w = np.where(matched, dims["w"][jm], np.float32(0))
            p15_check(f"{q}: name exact ('0' where unmatched) and w exact",
                      np.array_equal(got["name"], want_name)
                      and np.array_equal(got["w"], want_w))
        return f"{len(ox)} rows"
    if q == "b_eq":
        want = np.flatnonzero(k == 2 * P15_EQ_ROW)
        o = np.argsort(got["x"])
        p15_check(f"b_eq: rows exact ({len(o)} vs {len(want)})",
                  np.array_equal(got["x"][o], want)
                  and (got["name"] == "sku-000123").all()
                  and np.array_equal(got["k"], k[got["x"]]))
        return f"{len(o)} rows"
    if q == "c_mixed":
        # the joined rows: even k; group g = k // P15_GROUP holds the names
        # of its matched keys (words are in rank order, so codes compare)
        m = even
        g = k[m] // P15_GROUP
        n_g = P15_KEYS // P15_GROUP
        cnt = np.bincount(g, minlength=n_g)
        groups = np.flatnonzero(cnt)
        code = perm[k[m] // 2]
        lo = np.full(n_g, P15_DIMS)
        hi = np.full(n_g, -1)
        np.minimum.at(lo, g, code)
        np.maximum.at(hi, g, code)
        sx = np.bincount(g, weights=x[m], minlength=n_g).astype(np.int64)
        sy = np.bincount(g, weights=fact["y"][m], minlength=n_g)
        o = np.argsort(got["g"])
        p15_check("c_mixed: groups, min / max name and sum(x) exact",
                  np.array_equal(got["g"][o], groups)
                  and np.array_equal(got["lo"][o], words[lo[groups]])
                  and np.array_equal(got["hi"][o], words[hi[groups]])
                  and np.array_equal(got["sx"][o], sx[groups]))
        p15_check("c_mixed: mean(y) within rtol 1e-5",
                  np.allclose(got["my"][o], sy[groups] / cnt[groups],
                              rtol=1e-5, atol=0))
        apart = float((lo[groups] != hi[groups]).mean())
        p15_check(f"c_mixed: min and max name differ in most groups "
                  f"({apart:.4f})", apart > 0.9)
        return f"{len(o)} groups, min != max name in {apart:.4f}"
    if q == "d_agg":
        cnt = np.bincount(k, minlength=P15_KEYS)
        keys = np.flatnonzero(cnt)
        low = np.bincount(k, weights=fact["big"] - P15_BIG,
                          minlength=P15_KEYS).astype(np.int64)
        s = cnt.astype(np.int64) * P15_BIG + low
        mx = np.full(P15_KEYS, np.iinfo(np.int64).min)
        np.maximum.at(mx, k, fact["big"])
        o = np.argsort(got["k"])
        p15_check("d_agg: keys, sum(big) and max(big) exact int64",
                  np.array_equal(got["k"][o], keys)
                  and np.array_equal(got["s"][o], s[keys])
                  and np.array_equal(got["mx"][o], mx[keys])
                  and got["s"].dtype == np.int64)
        p15_check("d_agg: mean(big) float64, within rtol 1e-5",
                  got["m"].dtype == np.float64
                  and np.allclose(got["m"][o], s[keys] / cnt[keys],
                                  rtol=1e-5, atol=0))
        return f"{len(o)} groups, sums to {int(s.max())}"
    if q == "d_sort":
        present, once = p15_rows_by_id(np, n, got["x"])
        p15_check("d_sort: every row once, big ascending and exact",
                  once and bool(present.all())
                  and np.array_equal(got["big"], fact["big"][got["x"]])
                  and bool((got["big"][1:] >= got["big"][:-1]).all()))
        return f"{n} rows"
    if q == "d_key":
        keys, cnt = np.unique(fact["big"], return_counts=True)
        p15_check("d_key: wide keys and counts exact, in order",
                  np.array_equal(got["big"], keys)
                  and np.array_equal(got["n"], cnt))
        return f"{len(keys)} groups"
    f = fact["f"]
    nan = np.isnan(f)
    keys, inv = np.unique(f[~nan] + np.float32(0), return_inverse=True)
    cnt = np.bincount(inv)
    sums = np.bincount(inv, weights=x[~nan]).astype(np.int64)
    gn = np.isnan(got["f"])
    o = np.argsort(got["f"][~gn])
    p15_check(f"e_float: {int(gn.sum())} NaN groups of one row each, their "
              f"x exact (want {P15_NANS})",
              int(gn.sum()) == int(nan.sum()) and (got["n"][gn] == 1).all()
              and np.array_equal(np.sort(got["s"][gn]), np.sort(x[nan])))
    p15_check("e_float: the other groups exact (-0.0 and 0.0 one group)",
              np.array_equal(got["f"][~gn][o], keys)
              and np.array_equal(got["n"][~gn][o], cnt)
              and np.array_equal(got["s"][~gn][o], sums))
    z = int(np.flatnonzero(got["f"] == 0)[0])
    return (f"{len(keys)} groups + {int(gn.sum())} NaN groups; the zero "
            f"group holds {int(got['n'][z])} rows, sign "
            f"{'-' if np.signbit(got['f'][z]) else '+'}")


def phase_fifteen(torch, np, ck, vt):
    """Phase 15: the frame plans the reference answers on its host tier,
    at P15_ROWS fact rows and a P15_DIMS-row dimension table. Each query
    once cold (held to numpy) and three times warm; the warm median ms,
    the host build apart, the step peak and the cold run's launches."""
    from vega_tpu_torch import dense_rdd

    t0 = time.perf_counter()
    card = card_line()
    # -0.0 and 0.0 share a bucket on the card (the hash_bucket kernel)
    zb = dense_rdd._bucket_cols(
        {"k": torch.tensor([[0.0, -0.0, 2.5]], device="cuda")}, N_SHARDS,
        zeros_one_key=True)
    p15_check("15e: -0.0 and 0.0 hash to one bucket on the card",
              int(zb[0, 0]) == int(zb[0, 1]))
    fact, dims, words, perm = p15_data(np)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows, launches = [], {name: 0 for name in ck.LAUNCHES}
    for q in P15_QUERIES:
        def run(q=q):
            return p15_query(ctx, fact, dims, q).collect_columns(), None

        out, cold = p10_run(torch, ck, ctx, q, run)
        note = p15_expect(torch, np, q, out, fact, dims, words, perm)
        del out
        need = (("hash_bucket", "digit_hist") if q in P15_HASHED
                else ("digit_hist",))
        for name in need:
            p15_check(f"{q} launched {name} ({cold['launches']})",
                      cold["launches"][name] > 0)
        for name in launches:
            launches[name] += cold["launches"][name]
        warm = [p10_run(torch, ck, ctx, q, run)[1]
                for _ in range(P15_WARM)]
        timed, timed_as = p15_timed(warm, cold)
        med = statistics.median(r["ms"] for r in timed)
        r = dict(label=q, note=note, cold=cold, warm=warm, median_ms=med,
                 timed_as=timed_as,
                 median_host_build_ms=statistics.median(
                     x["host_build_ms"] for x in timed),
                 median_device_ms=statistics.median(
                     x["device_ms"] for x in timed),
                 peak_bytes=max(x["peak_bytes"] for x in warm + [cold]),
                 launches=cold["launches"])
        rows.append(r)
        log(f"15 {q}: {note}; {med:.3f} ms {timed_as}, "
            f"host build "
            f"{r['median_host_build_ms']:.3f} ms, cold {cold['ms']:.3f} ms, "
            f"peak {r['peak_bytes']} B, launches "
            f"{json.dumps(cold['launches'])} on {card}")
    explain = p15_query(ctx, fact, dims, "c_mixed").explain().replace(
        "\n", " | ")
    ctx.stop()
    del fact, dims
    torch.cuda.empty_cache()
    check_launched(launches, "phase 15")
    wall_s = time.perf_counter() - t0
    log(f"phase 15 took {wall_s:.1f} s")
    return dict(rows=rows, launches=launches, explain=explain, card=card,
                wall_s=wall_s)



P16_QUERIES = ("f12_or", "f12_count", "f13_key", "f14_group", "f14_join",
               "f15_fill", "f16_sum")
# the queries whose exchanges hash an int32 or float32 key (a bool key is
# int32 0 / 1): hash_bucket must launch there; a float64 key is a wide
# pair, hashed by hash32_pair in torch ops
P16_HASHED = ("f12_or", "f12_count", "f13_key", "f15_fill", "f16_sum")
P16_CUT = 950                  # the computed bool is y > P16_CUT
P16_FILL = 0.5                 # f15_fill's fill_value
# each query and the tier the reference picks for it
P16_TIERS = {"f12_or": "device", "f12_count": "host", "f13_key": "host",
             "f14_group": "host", "f14_join": "host", "f15_fill": "host",
             "f16_sum": "host"}


def p16_check(what, ok):
    if not ok:
        fail(f"phase 16: {what}")


def p16_data(np):
    """Phase 15's tables (p15_data) with phase 16's columns: on the fact
    table a float64 key g = 1e6 + k * 1e-3 (1M distinct values, which
    float32 would merge into about 16,000) and a float64 value v = +-1e8
    (alternating by row) + y, integers below 2^53, so every order of
    summation is exact; on the dimension table the same g of its keys and
    two int columns d1 = 3 * i, d2 = i % 1000 - 500."""
    fact, dims, words, perm = p15_data(np)
    fact["g"] = 1e6 + fact["k"] * 1e-3
    sign = np.where(np.arange(P15_ROWS) % 2 == 0, 1.0, -1.0)
    fact["v"] = sign * 1e8 + fact["y"]
    i = np.arange(P15_DIMS, dtype=np.int64)
    dims["g"] = 1e6 + dims["k"] * 1e-3
    dims["d1"], dims["d2"] = 3 * i, i % 1000 - 500
    return fact, dims, words, perm


def p16_query(ctx, fact, dims, q):
    """One of phase 16's queries over frames built from the host columns
    (the build is part of the run, timed apart as its host build)."""
    from vega_tpu_torch.frame import F, col

    def fa(*cols):
        return ctx.create_frame(**{c: fact[c] for c in cols})

    def dm(key, *cols):
        return ctx.create_frame(**{c: dims[c] for c in (key,) + cols})

    if q == "f12_or":
        return fa("k", "x", "y").with_column("b", col("y") > P16_CUT) \
            .group_by("k").agg(F.sum("b", "sb"), F.mean("b", "mb"),
                               F.max("x", "mx"))
    if q == "f12_count":
        return fa("k", "y").join(dm("k", "name"), on="k").with_column(
            "b", col("y") > P16_CUT).with_column(
                "g8", col("k") // P15_GROUP).group_by("g8").agg(
                    F.sum("b", "sb"), F.mean("b", "mb"),
                    F.min("name", "lo"))
    if q == "f13_key":
        return fa("x", "y").with_column("b", col("y") > P16_CUT).group_by(
            "b").agg(F.count("n"), F.min("x", "lo"), F.max("x", "hi"))
    if q == "f14_group":
        return fa("g", "x").group_by("g").agg(F.count("n"),
                                               F.min("x", "lo"))
    if q == "f14_join":
        return fa("g", "x").join(dm("g", "name"), on="g")
    if q == "f15_fill":
        return fa("k", "x").join(dm("k", "d1", "d2"), on="k", how="left",
                                 fill_value=P16_FILL)
    return fa("k", "v").join(dm("k", "name"), on="k").group_by("k").agg(
        F.sum("v", "sv"), F.mean("v", "mv"), F.min("name", "lo"))


def p16_expect(np, q, got, fact, dims, words, perm):
    """Hold one query's columns to numpy, exactly: integers, bools,
    strings, float64 keys and v's sums and means (an exact integer sum
    divided by the count), and the float32 means of f12_or (a bool over
    a count). Returns a note."""
    n = P15_ROWS
    k, x, y = fact["k"], fact["x"], fact["y"]
    b = y > P16_CUT
    even = k % 2 == 0
    if q == "f12_or":
        cnt = np.bincount(k, minlength=P15_KEYS)
        keys = np.flatnonzero(cnt)
        anyb = np.bincount(k, weights=b, minlength=P15_KEYS) > 0
        mx = np.full(P15_KEYS, -1)
        np.maximum.at(mx, k, x)
        o = np.argsort(got["k"])
        p16_check("f12_or: keys, sum(b) the logical or, max(x) exact",
                  np.array_equal(got["k"][o], keys)
                  and got["sb"].dtype == np.bool_
                  and np.array_equal(got["sb"][o], anyb[keys])
                  and np.array_equal(got["mx"][o], mx[keys]))
        want = (anyb[keys].astype(np.float32)
                / cnt[keys].astype(np.float32))
        p16_check("f12_or: mean(b) the or over the count, float32 exact",
                  got["mb"].dtype == np.float32
                  and np.array_equal(got["mb"][o], want))
        return f"{len(keys)} groups, or true in {int(anyb[keys].sum())}"
    if q == "f12_count":
        g8 = k[even] // P15_GROUP
        n_g = P15_KEYS // P15_GROUP
        cnt = np.bincount(g8, minlength=n_g)
        groups = np.flatnonzero(cnt)
        sb = np.bincount(g8, weights=b[even], minlength=n_g).astype(np.int64)
        lo = np.full(n_g, P15_DIMS)
        np.minimum.at(lo, g8, perm[k[even] // 2])
        o = np.argsort(got["g8"])
        p16_check("f12_count: groups, sum(b) the count, min(name) exact",
                  np.array_equal(got["g8"][o], groups)
                  and np.array_equal(got["sb"][o], sb[groups])
                  and np.array_equal(got["lo"][o], words[lo[groups]]))
        p16_check("f12_count: mean(b) float64, the count over the rows "
                  "exact",
                  got["mb"].dtype == np.float64
                  and np.array_equal(got["mb"][o], sb[groups] / cnt[groups]))
        return (f"{len(groups)} groups, {int(sb.sum())} true of "
                f"{int(cnt.sum())} rows")
    if q == "f13_key":
        want = {False: (int((~b).sum()), int(np.flatnonzero(~b)[0]),
                        int(np.flatnonzero(~b)[-1])),
                True: (int(b.sum()), int(np.flatnonzero(b)[0]),
                       int(np.flatnonzero(b)[-1]))}
        rows = {bool(bb): (int(c), int(lo), int(hi)) for bb, c, lo, hi in
                zip(got["b"], got["n"], got["lo"], got["hi"])}
        p16_check(f"f13_key: two bool groups, counts and min / max x "
                  f"exact ({rows} vs {want})",
                  got["b"].dtype == np.bool_ and rows == want)
        return f"{want[True][0]} true rows"
    if q == "f14_group":
        keys, first, cnt = np.unique(fact["g"], return_index=True,
                                     return_counts=True)
        o = np.argsort(got["g"])
        p16_check("f14_group: float64 keys bit-exact, counts and min(x) "
                  "exact",
                  got["g"].dtype == np.float64
                  and np.array_equal(got["g"][o].view(np.int64),
                                     keys.view(np.int64))
                  and np.array_equal(got["n"][o], cnt)
                  and np.array_equal(got["lo"][o], x[first]))
        narrow = len(np.unique(fact["g"].astype(np.float32)))
        return f"{len(keys)} groups (float32 would give {narrow})"
    if q == "f14_join":
        present, once = p15_rows_by_id(np, n, got["x"])
        p16_check(f"f14_join: each even-k row once ({int(present.sum())} "
                  f"rows, {int(even.sum())} expected)",
                  once and np.array_equal(present, even))
        ox = got["x"]
        p16_check("f14_join: g bit-exact and name exact",
                  np.array_equal(got["g"].view(np.int64),
                                 fact["g"][ox].view(np.int64))
                  and np.array_equal(got["name"], words[perm[k[ox] // 2]]))
        return f"{len(ox)} rows"
    if q == "f15_fill":
        present, once = p15_rows_by_id(np, n, got["x"])
        p16_check("f15_fill: every fact row once",
                  once and bool(present.all()))
        ox = got["x"]
        j = k[ox] // 2
        matched = k[ox] % 2 == 0
        d1 = np.where(matched, dims["d1"][np.where(matched, j, 0)], P16_FILL)
        d2 = np.where(matched, dims["d2"][np.where(matched, j, 0)], P16_FILL)
        p16_check("f15_fill: d1 and d2 float64, exact, the fill 0.5 where "
                  "unmatched",
                  got["d1"].dtype == got["d2"].dtype == np.float64
                  and np.array_equal(got["k"], k[ox])
                  and np.array_equal(got["d1"], d1)
                  and np.array_equal(got["d2"], d2))
        return f"{len(ox)} rows, {int((~matched).sum())} filled"
    ke = k[even]
    sign = np.where(np.arange(n) % 2 == 0, 1, -1)[even]
    cnt = np.bincount(ke, minlength=P15_KEYS)
    keys = np.flatnonzero(cnt)
    sv = (np.bincount(ke, weights=sign, minlength=P15_KEYS).astype(np.int64)
          * 100_000_000
          + np.bincount(ke, weights=y[even], minlength=P15_KEYS)
          .astype(np.int64))
    o = np.argsort(got["k"])
    p16_check("f16_sum: keys, sum(v) float64 exact, mean(v) the exact sum "
              "over the count, min(name) exact",
              np.array_equal(got["k"][o], keys)
              and got["sv"].dtype == got["mv"].dtype == np.float64
              and np.array_equal(got["sv"][o], sv[keys].astype(np.float64))
              and np.array_equal(got["mv"][o],
                                 sv[keys].astype(np.float64) / cnt[keys])
              and np.array_equal(got["lo"][o], words[perm[keys // 2]]))
    narrow = float(np.abs(sv[keys].astype(np.float32).astype(np.float64)
                          - sv[keys]).max())
    return f"{len(keys)} groups, sums to {int(np.abs(sv).max())} " \
        f"(float32 inputs would be off by up to {narrow:.0f})"


def phase_sixteen(torch, np, ck, vt):
    """Phase 16: the reference's tier rules at P15_ROWS fact rows and the
    P15_DIMS-row dimension table: a computed bool summed beside other
    monoids (a logical or on the reference's device tier, a count on its
    host tier), a bool group key, a float64 group and join key, a left
    join's float fill and a float64 value summed. Each query once cold
    (held to numpy) and three times warm; the warm median ms, the host
    build apart, the step peak and the cold run's launches."""
    t0 = time.perf_counter()
    card = card_line()
    fact, dims, words, perm = p16_data(np)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows, launches = [], {name: 0 for name in ck.LAUNCHES}
    for q in P16_QUERIES:
        tier = p16_query(ctx, fact, dims, q)._compiled().reference[0]
        p16_check(f"{q}: the reference's tier is {P16_TIERS[q]} (got "
                  f"{tier})", tier == P16_TIERS[q])

        def run(q=q):
            return p16_query(ctx, fact, dims, q).collect_columns(), None

        out, cold = p10_run(torch, ck, ctx, q, run)
        note = p16_expect(np, q, out, fact, dims, words, perm)
        del out
        need = (("hash_bucket", "digit_hist") if q in P16_HASHED
                else ("digit_hist",))
        for name in need:
            p16_check(f"{q} launched {name} ({cold['launches']})",
                      cold["launches"][name] > 0)
        for name in launches:
            launches[name] += cold["launches"][name]
        warm = [p10_run(torch, ck, ctx, q, run)[1]
                for _ in range(P15_WARM)]
        timed, timed_as = p15_timed(warm, cold)
        med = statistics.median(r["ms"] for r in timed)
        r = dict(label=q, tier=tier, note=note, cold=cold, warm=warm,
                 median_ms=med,
                 timed_as=timed_as,
                 median_host_build_ms=statistics.median(
                     x["host_build_ms"] for x in timed),
                 median_device_ms=statistics.median(
                     x["device_ms"] for x in timed),
                 peak_bytes=max(x["peak_bytes"] for x in warm + [cold]),
                 launches=cold["launches"])
        rows.append(r)
        log(f"16 {q} (reference tier {tier}): {note}; {med:.3f} ms "
            f"{timed_as}, host build {r['median_host_build_ms']:.3f} ms, "
            f"cold {cold['ms']:.3f} ms, peak {r['peak_bytes']} B, launches "
            f"{json.dumps(cold['launches'])} on {card}")
    explain = p16_query(ctx, fact, dims, "f12_count").explain().replace(
        "\n", " | ")
    ctx.stop()
    del fact, dims
    torch.cuda.empty_cache()
    check_launched(launches, "phase 16")
    wall_s = time.perf_counter() - t0
    log(f"phase 16 took {wall_s:.1f} s")
    return dict(rows=rows, launches=launches, explain=explain, card=card,
                wall_s=wall_s)


P17_QUERIES = ("a_filter", "b_packed", "c_negate", "d_wrap")
# the kernels each query must launch: a and c exchange on the int32 key
# k, b on its packed key (a wide pair, hashed by hash32_pair in torch
# ops), c joins; d has no exchange
P17_NEED = {"a_filter": ("hash_bucket", "digit_hist"),
            "b_packed": ("digit_hist",),
            "c_negate": ("hash_bucket", "digit_hist", "partition_pos"),
            "d_wrap": ()}
P17_BIG = 1 << 40              # the literal past int32 of (a) and (e)
P17_FILL = 0.5                 # c_negate's fill_value


def p17_check(what, ok):
    if not ok:
        fail(f"phase 17: {what}")


def p17_data(np):
    """Phase 15's tables (p15_data) with m = x - 2^31 (int64, -2^31 on
    row 0: the port holds it as int32 because it fits) and i = x * 48271
    mod 2^31 as int32 (a numpy int32 source)."""
    fact, dims, words, perm = p15_data(np)
    fact["m"] = fact["x"] - 2**31
    fact["i"] = (fact["x"] * 48271 % 2**31).astype(np.int32)
    return fact, dims, words, perm


def p17_query(ctx, fact, dims, q):
    """One of phase 17's frame queries over frames built from the host
    columns (the build is part of the run, timed apart as its host
    build)."""
    from vega_tpu_torch.frame import F, col

    def fa(*cols):
        return ctx.create_frame(**{c: fact[c] for c in cols})

    if q == "a_filter":
        return fa("k", "x").filter(col("x") < P17_BIG).group_by("k").agg(
            F.count("n"), F.sum("x", "sx"))
    if q == "b_packed":
        return fa("k", "y", "x").with_column(
            "p", col("k") * 2**32 + col("y")).group_by("p").agg(
                F.sum("x", "sx"), F.count("n"))
    if q == "c_negate":
        return fa("k", "x", "m").with_column("n", -col("m")).join(
            ctx.create_frame(k=dims["k"], w=dims["w"]), on="k", how="left",
            fill_value=P17_FILL)
    return fa("x", "i", "big").with_column("p", col("i") * col("i")) \
        .with_column("q", col("i") * 3 + 7)


def p17_expect(np, q, got, fact, dims):
    """Hold one query's columns to numpy under the reference's host-tier
    rules, exactly: int64 arithmetic over the int64 columns, int32
    wrapping over the int32 one, int64 counts. Returns a note."""
    n = P15_ROWS
    k, x = fact["k"], fact["x"]
    if q == "a_filter":
        cnt = np.bincount(k, minlength=P15_KEYS)
        sx = np.bincount(k, weights=x, minlength=P15_KEYS).astype(np.int64)
        keys = np.flatnonzero(cnt)
        o = np.argsort(got["k"])
        p17_check("a_filter: every row kept, counts int64 and sum(x) exact",
                  np.array_equal(got["k"][o], keys)
                  and got["n"].dtype == np.int64
                  and np.array_equal(got["n"][o], cnt[keys])
                  and int(got["n"].sum()) == n
                  and np.array_equal(got["sx"][o], sx[keys]))
        return f"{n} rows kept, {len(keys)} groups"
    if q == "b_packed":
        p = k * 2**32 + fact["y"]
        keys, inv, cnt = np.unique(p, return_inverse=True,
                                   return_counts=True)
        sx = np.bincount(inv, weights=x).astype(np.int64)
        o = np.argsort(got["p"])
        p17_check("b_packed: int64 keys past int32 exact, sum(x) and the "
                  "int64 count exact",
                  got["p"].dtype == np.int64
                  and np.array_equal(got["p"][o], keys)
                  and np.array_equal(got["sx"][o], sx)
                  and got["n"].dtype == np.int64
                  and np.array_equal(got["n"][o], cnt))
        return f"{len(keys)} groups, keys up to {int(keys[-1])}"
    if q == "c_negate":
        present, once = p15_rows_by_id(np, n, got["x"])
        p17_check("c_negate: every fact row once", once
                  and bool(present.all()))
        ox = got["x"]
        m = fact["m"][ox]
        matched = k[ox] % 2 == 0
        w = np.where(matched, dims["w"][np.where(matched, k[ox] // 2, 0)]
                     .astype(np.float64), P17_FILL)
        p17_check("c_negate: -m int64 and exact (2^31 at m = -2^31), m "
                  "exact, w float64 with the fill",
                  got["n"].dtype == np.int64
                  and np.array_equal(got["n"], -m)
                  and np.array_equal(got["m"], m)
                  and int(got["n"].max()) == 2**31
                  and got["w"].dtype == np.float64
                  and np.array_equal(got["w"], w))
        return f"{len(ox)} rows, -m up to {int(got['n'].max())}"
    ox = got["x"]
    i = fact["i"][ox]
    with np.errstate(over="ignore"):
        pp, qq = i * i, i * np.int32(3) + np.int32(7)
    wrapped = int((pp.astype(np.int64)
                   != i.astype(np.int64) * i.astype(np.int64)).sum())
    p17_check("d_wrap: i * i and i * 3 + 7 wrap in numpy's int32, big "
              "exact",
              len(ox) == n and np.array_equal(np.sort(ox), x)
              and np.array_equal(got["p"], pp)
              and np.array_equal(got["q"], qq)
              and np.array_equal(got["big"], fact["big"][ox])
              and wrapped > 0)
    return f"{n} rows, {wrapped} products wrapped"


def phase_seventeen(torch, np, ck, vt):
    """Phase 17: the reference's literal rule (a Python int past int32
    sends a plan to its host tier) and its host tier's integer widths at
    P15_ROWS fact rows. Each frame query's reference tier checked, once
    cold (held to numpy) and three times warm; the warm median ms, the
    host build apart, the step peak and the cold run's launches. Then
    the RDD filter with a constant past int32, in the host tier's row
    form."""
    from vega_tpu_torch.frame import col, lit

    t0 = time.perf_counter()
    card = card_line()
    fact, dims, _words, _perm = p17_data(np)
    ctx = vt.Context(n_shards=N_SHARDS)
    # the int32 forms the range proof keeps on the card: % by a column
    # at -2^31 % -1 (guarded: C's remainder may trap there) and // 8
    x4 = np.array([-2**31, 7, -9, 2**31 - 1])
    z4 = np.array([-1, -1, 4, -1])
    got = ctx.create_frame(x=x4, z=z4, s=np.array(list("abcd"), object)) \
        .filter(col("s") != lit("z")).with_column("r", col("x") % col("z")) \
        .with_column("d", col("x") // 8).collect_columns()
    o = np.argsort(got["x"])
    p17_check(f"x % z and x // 8 int32 on the card ({got})",
              got["r"].dtype == got["d"].dtype == np.int32
              and got["r"][o].tolist() == (x4 % z4)[np.argsort(x4)].tolist()
              and got["d"][o].tolist() == np.sort(x4 // 8).tolist())
    log(f"17 int32 forms on the card: x % z {got['r'][o].tolist()}, "
        f"x // 8 {got['d'][o].tolist()}")
    rows, launches = [], {name: 0 for name in ck.LAUNCHES}
    for q in P17_QUERIES:
        tier, why = p17_query(ctx, fact, dims, q)._compiled().reference
        p17_check(f"{q}: the reference's tier is host (got {tier})",
                  tier == "host")

        def run(q=q):
            return p17_query(ctx, fact, dims, q).collect_columns(), None

        out, cold = p10_run(torch, ck, ctx, q, run)
        note = p17_expect(np, q, out, fact, dims)
        del out
        for name in P17_NEED[q]:
            p17_check(f"{q} launched {name} ({cold['launches']})",
                      cold["launches"][name] > 0)
        for name in launches:
            launches[name] += cold["launches"][name]
        warm = [p10_run(torch, ck, ctx, q, run)[1]
                for _ in range(P15_WARM)]
        timed, timed_as = p15_timed(warm, cold)
        med = statistics.median(r["ms"] for r in timed)
        r = dict(label=q, tier=tier, why=why, note=note, cold=cold,
                 warm=warm, median_ms=med,
                 timed_as=timed_as,
                 median_host_build_ms=statistics.median(
                     x["host_build_ms"] for x in timed),
                 median_device_ms=statistics.median(
                     x["device_ms"] for x in timed),
                 peak_bytes=max(x["peak_bytes"] for x in warm + [cold]),
                 launches=cold["launches"])
        rows.append(r)
        log(f"17 {q} (reference tier {tier}: {why}): {note}; {med:.3f} ms "
            f"{timed_as}, host build "
            f"{r['median_host_build_ms']:.3f} ms, cold {cold['ms']:.3f} ms, "
            f"peak {r['peak_bytes']} B, launches "
            f"{json.dumps(cold['launches'])} on {card}")
    # (e) the RDD API: the closure fails the literal rule and takes the
    # host tier's row form when the node is built (phase 18 drives it)
    ck.reset_launches()
    t1 = time.perf_counter()
    node = ctx.dense_range(P15_ROWS).filter(lambda x: x < P17_BIG)
    build_ms = (time.perf_counter() - t1) * 1e3
    p17_check("e_rdd: filter(lambda x: x < 2**40) takes the host-row form "
              "at build, launching nothing",
              node.host_rows and not any(ck.LAUNCHES.values()))
    kept = node.count()
    p17_check(f"e_rdd: every row kept ({kept})", kept == P15_ROWS)
    note = f"host-row form, {kept} rows kept"
    rows.append(dict(label="e_rdd", tier="host", note=note,
                     median_ms=build_ms, launches=dict(ck.LAUNCHES)))
    log(f"17 e_rdd: built in {build_ms:.3f} ms: {note}")
    ctx.stop()
    del fact, dims
    torch.cuda.empty_cache()
    check_launched(launches, "phase 17")
    wall_s = time.perf_counter() - t0
    log(f"phase 17 took {wall_s:.1f} s")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s)


P18_ROWS = N_ROWS              # bench-main's 20M pairs (x % K, x)
P18_KEYS = N_KEYS
# 18e's host-row actions, cut from 20M rows: at 20M they took 233 s of
# phase 18's 291 s (NVIDIA H100 80GB HBM3, 700.00 W), past its 150 s
P18E_ROWS = 2_000_000
P18_WARM = 1                   # cut from 3: the script's time limit
# 18d's approximate actions, cut from 20M rows: a DenseRDD's are the host
# RDD's (one task a shard, every row a Python value), as the reference's
P18D_ROWS = 2_000_000
P18D_WARM = 1
P18D_DEADLINE_S = 120.0
P18D_PARTIAL_DEADLINE_S = 0.3
P18D_STRAGGLE_S = 2.0
P18_BIG = 1 << 40
P18_TEXT_DIR = "p18_text.tmp"  # 18e's files, removed after the phase
P18_MASK = (1 << 64) - 1


def p18_check(what, ok):
    if not ok:
        fail(f"phase 18: {what}")


class _P18Clock:
    """While installed, times each call of the wrapped functions (from a
    synchronize to a synchronize, so device work queued before is not
    counted); ms, set on exit, is the host-clock time during which at
    least one call was in progress (calls on concurrent task threads
    overlap and count once): a case's host part (the samplers' numpy
    draws, row formation, the HLL estimate), or, for the host-row
    actions, their device reads (Block.shard_rows)."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets
        self.ms = 0.0
        self._spans = []
        self._saved = []

    def __enter__(self):
        torch = self.torch
        for owner, name in self.targets:
            orig = getattr(owner, name)

            def timed(*a, _orig=orig, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self._spans.append((t0, time.perf_counter()))
            setattr(owner, name, timed)
            self._saved.append((owner, name, orig))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        covered, end = 0.0, float("-inf")
        for t0, t1 in sorted(self._spans):
            if t1 > end:
                covered += t1 - max(t0, end)
                end = t1
        self.ms = covered * 1e3
        return False


def p18_rss():
    """This process's resident set in bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def p18_data(np):
    x = np.arange(P18_ROWS, dtype=np.int32)
    rng = np.random.default_rng(18)
    return dict(x=x, k=(x % P18_KEYS).astype(np.int32),
                f=rng.standard_normal(P18_ROWS).astype(np.float32))


def p18_shards(n):
    """dense_from_numpy's placement of n rows on N_SHARDS shards: shard
    s holds rows [s * per, s * per + counts[s])."""
    per = -(-n // N_SHARDS)
    return [(s * per, min(n, (s + 1) * per)) for s in range(N_SHARDS)]


def p18_rng(np, seed, split):
    """The reference's host samplers' stream: PCG64([seed, split])."""
    return np.random.Generator(np.random.PCG64(
        [seed if seed is not None else 0xC0FFEE, split]))


def p18_fraction(size, total, with_replacement):
    """The reference's compute_fraction_for_sample_size."""
    if with_replacement and size < 12:
        return float(size) / total * 4.0
    frac = float(size) / total
    gamma = -math.log(1e-4) / total
    return min(1.0, max(1e-10, frac + gamma + math.sqrt(
        gamma * gamma + 2 * gamma * frac)))


def p18_poisson_rows(np, k, v, fraction, seed):
    """numpy's replay of sample(True, fraction, seed) over the pairs:
    each shard's rows repeated by its PCG64 stream's Poisson draws."""
    ks, vs = [], []
    for s, (a, b) in enumerate(p18_shards(len(k))):
        reps = p18_rng(np, seed, s).poisson(fraction, size=b - a)
        ks.append(np.repeat(k[a:b], reps))
        vs.append(np.repeat(v[a:b], reps))
    return np.concatenate(ks), np.concatenate(vs)


def p18_splitmix(np, x):
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def p18_hash_ints(np, a):
    """The reference's hash_key of ints: splitmix64 of the 64-bit word."""
    return p18_splitmix(np, a.astype(np.int64).view(np.uint64))


def p18_hash_pairs(np, hk, hv):
    """hash_key of (k, v) tuples: the fold from 0x345678."""
    h = np.full(len(hk), 0x345678, np.uint64)
    with np.errstate(over="ignore"):
        for item in (hk, hv):
            h = p18_splitmix(np, (h * np.uint64(1000003)) ^ item)
    return h


def p18_hll(np, h, relative_sd):
    """The reference's HyperLogLog over uint64 hashes, in numpy."""
    p = max(4, min(18, math.ceil(2 * math.log2(1.04 / relative_sd))))
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    rest = h << np.uint64(p)
    n = np.zeros(len(h), np.int64)
    r = rest.copy()
    for s in (32, 16, 8, 4, 2, 1):
        t = r >> np.uint64(s)
        big = t != 0
        n += np.where(big, s, 0)
        r = np.where(big, t, r)
    bits = n + (r != 0)
    rank = np.where(rest == 0, 64 - p + 1, 64 - bits + 1)
    reg = np.zeros(1 << p, np.int64)
    np.maximum.at(reg, idx, rank)
    m = float(1 << p)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / float(np.sum(np.exp2(-reg.astype(np.float64))))
    if raw <= 2.5 * m:
        zeros = int(np.count_nonzero(reg == 0))
        return int(round(m * math.log(m / zeros))) if zeros \
            else int(round(raw)), p
    two64 = 2.0 ** 64
    if raw > two64 / 30.0:
        return int(round(-two64 * math.log1p(-raw / two64))), p
    return int(round(raw)), p


def p18_text(np, k, v):
    """numpy's formatting of (k, v) rows, one "(k, v)\\n" a row."""
    parts = np.char.add(np.char.add(np.char.add("(", k.astype(str)), ", "),
                        np.char.add(v.astype(str), ")\n"))
    return "".join(parts.tolist())


def p18_case(torch, ck, ctx, label, run, check, clock=(), kind="host",
             need=(), warm=P18_WARM):
    """One case: a cold run (launches counted from 0, checked), then warm
    runs: their median ms, the host part apart (the time in `clock`'s
    functions, or for kind "device" the time outside them), the step
    peak and the cold run's launches."""
    def timed():
        with _P18Clock(torch, clock) as c:
            out = run()
        return out, c.ms

    def one():
        out, cold = p10_run(torch, ck, ctx, label, lambda: timed())
        if kind == "device":  # the clock timed the device reads
            cold["host_build_ms"], cold["device_ms"] = \
                cold["ms"] - cold["host_build_ms"], cold["host_build_ms"]
        return out, cold

    out, cold = one()
    note = check(out)
    del out
    for name in need:
        p18_check(f"{label} launched {name} ({cold['launches']})",
                  cold["launches"][name] > 0)
    runs = [one()[1] for _ in range(warm)]
    med = statistics.median(r["ms"] for r in runs)
    r = dict(label=label, note=note, cold=cold, warm=runs, median_ms=med,
             median_host_ms=statistics.median(x["host_build_ms"]
                                              for x in runs),
             median_device_ms=statistics.median(x["device_ms"]
                                                for x in runs),
             peak_bytes=max(x["peak_bytes"] for x in runs + [cold]),
             launches=cold["launches"])
    log(f"18 {label}: {note}; {med:.3f} ms warm median of {warm}, host "
        f"part {r['median_host_ms']:.3f} ms, device part "
        f"{r['median_device_ms']:.3f} ms, cold {cold['ms']:.3f} ms, peak "
        f"{r['peak_bytes']} B, launches {json.dumps(cold['launches'])}")
    return r


def p18_part_a(torch, np, ck, vt, ctx, d):
    """18a: closures past int32 in the host tier's row form."""
    from vega_tpu_torch import dense_rdd

    k, x, f = d["k"], d["x"], d["f"]
    rows = []

    def wide_sums():
        node = ctx.dense_range(P18_ROWS).map(
            lambda x: (x % P18_KEYS, x + P18_BIG)).reduce_by_key(
                lambda a, b: a + b)
        p18_check("a_wide_sums is a host-row node", node.host_rows)
        return node.collect_arrays()

    def wide_sums_check(got):
        reps = P18_ROWS // P18_KEYS
        keys = np.arange(P18_KEYS, dtype=np.int64)
        want = reps * keys + P18_KEYS * (reps * (reps - 1) // 2) \
            + reps * P18_BIG
        o = np.argsort(got["k"])
        p18_check("a_wide_sums: every key once, int64 sums exact",
                  np.array_equal(got["k"][o], keys)
                  and got["v"].dtype == np.int64
                  and np.array_equal(got["v"][o], want))
        return f"{P18_KEYS} keys, sums up to {int(want.max())}"

    rows.append(p18_case(torch, ck, ctx, "a_wide_sums", wide_sums,
                         wide_sums_check,
                         clock=[(dense_rdd.DenseRDD, "map")],
                         need=("hash_bucket", "digit_hist")))

    def wide_join():
        table = ctx.dense_from_numpy(
            np.arange(P18_KEYS, dtype=np.int32),
            np.arange(P18_KEYS, dtype=np.float32) * 2.0)
        node = ctx.dense_range(P18_ROWS).map(
            lambda x: (x % P18_KEYS, x + P18_BIG)).reduce_by_key(
                lambda a, b: a + b).join(table)
        return node.count()

    rows.append(p18_case(
        torch, ck, ctx, "a_wide_join", wide_join,
        lambda n: (p18_check(f"a_wide_join: every key joined ({n})",
                             n == P18_KEYS), f"{n} rows")[1],
        clock=[(dense_rdd.DenseRDD, "map")],
        need=("hash_bucket", "digit_hist", "partition_pos")))

    def filt():
        return ctx.dense_range(P18_ROWS).filter(
            lambda x: x < P18_BIG).collect_arrays()

    rows.append(p18_case(
        torch, ck, ctx, "a_filter", filt,
        lambda got: (p18_check("a_filter: every row kept, in order",
                               np.array_equal(got["v"], x)),
                     f"{P18_ROWS} rows kept")[1],
        clock=[(dense_rdd.DenseRDD, "filter")]))

    def times_2_31():
        return ctx.dense_from_numpy(k, x).map_values(
            lambda v: v * 2**31).collect_arrays()

    rows.append(p18_case(
        torch, ck, ctx, "a_map_values", times_2_31,
        lambda got: (p18_check(
            "a_map_values: v * 2^31 int64 exact",
            got["v"].dtype == np.int64 and np.array_equal(got["k"], k)
            and np.array_equal(got["v"], x.astype(np.int64) * 2**31)),
            f"v up to {int(got['v'].max())}")[1],
        clock=[(dense_rdd.DenseRDD, "map_values")]))

    def float_2_40():
        return ctx.dense_from_numpy(k, f).map_values(
            lambda v: v * P18_BIG).collect_arrays()

    rows.append(p18_case(
        torch, ck, ctx, "a_float64", float_2_40,
        lambda got: (p18_check(
            "a_float64: float32 v * 2^40 as float64, exact",
            got["v"].dtype == np.float64
            and np.array_equal(got["v"], f.astype(np.float64) * P18_BIG)),
            "float64 values")[1],
        clock=[(dense_rdd.DenseRDD, "map_values")]))
    return rows


def p18_part_b(torch, np, ck, vt, ctx, d):
    """18b: the samplers, each held to numpy's replay of its streams."""
    from vega_tpu_torch import dense_rdd, host_actions

    k, x = d["k"], d["x"]
    clock = [(host_actions, "_local_rows"), (dense_rdd, "_host_rows")]
    rows = []

    def poisson():
        return ctx.dense_from_numpy(k, x).sample(True, 0.1, 7) \
            .collect_arrays()

    def poisson_check(got):
        wk, wv = p18_poisson_rows(np, k, x, 0.1, 7)
        p18_check("b_poisson: rows and multiplicities equal numpy's replay",
                  np.array_equal(got["k"], wk)
                  and np.array_equal(got["v"], wv))
        return f"{len(wv)} rows"

    rows.append(p18_case(torch, ck, ctx, "b_poisson", poisson,
                         poisson_check, clock=clock))

    def take_plain():
        node = ctx.dense_from_numpy(k, x)
        frac = p18_fraction(1000, P18_ROWS, False)
        pool = node.sample(False, frac, 7).collect()
        return node.take_sample(False, 1000, 7), pool

    def take_plain_check(out):
        got, pool = out
        rng = np.random.Generator(np.random.PCG64(7))
        rng.shuffle(pool)
        p18_check("b_take_sample: the threefry sample shuffled by PCG64(7)",
                  got == pool[:1000] and len(got) == 1000
                  and all(v % P18_KEYS == kk for kk, v in got)
                  and len({v for _, v in got}) == 1000)
        return f"{len(got)} of a {len(pool)}-row sample"

    rows.append(p18_case(torch, ck, ctx, "b_take_sample", take_plain,
                         take_plain_check, clock=clock))

    def take_poisson():
        return ctx.dense_from_numpy(k, x).take_sample(True, 1000, 7)

    def take_poisson_check(got):
        frac = p18_fraction(1000, P18_ROWS, True)
        wk, wv = p18_poisson_rows(np, k, x, frac, 7)
        attempts = 0
        while len(wv) < 1000 and attempts < 20:
            attempts += 1
            wk, wv = p18_poisson_rows(np, k, x, frac, 7 + attempts)
        pool = list(zip(wk.tolist(), wv.tolist()))
        np.random.Generator(np.random.PCG64(7)).shuffle(pool)
        p18_check("b_take_sample_replacement: numpy's Poisson replay, "
                  "shuffled by PCG64(7)", got == pool[:1000])
        return f"{len(got)} of {len(pool)}, {attempts} retries"

    rows.append(p18_case(torch, ck, ctx, "b_take_sample_replacement",
                         take_poisson, take_poisson_check, clock=clock))

    def split():
        return [b.collect_arrays() for b in ctx.dense_from_numpy(
            k, x).random_split([0.8, 0.2], 7)]

    def split_check(bands):
        want = [[], []]
        for s, (a, b) in enumerate(p18_shards(P18_ROWS)):
            u = p18_rng(np, 7, s).random(size=b - a)
            want[0].append(x[a:b][u < 0.8])
            want[1].append(x[a:b][(u >= 0.8) & (u < 1.0)])
        want = [np.concatenate(w) for w in want]
        both = np.concatenate([bands[0]["v"], bands[1]["v"]])
        p18_check("b_random_split: bands equal numpy's replay, disjoint, "
                  "covering every row once",
                  all(np.array_equal(g["v"], w) for g, w in zip(bands, want))
                  and all(np.array_equal(g["k"], g["v"] % P18_KEYS)
                          for g in bands)
                  and len(both) == P18_ROWS
                  and np.array_equal(np.sort(both), x))
        return f"bands of {len(want[0])} and {len(want[1])} rows"

    rows.append(p18_case(torch, ck, ctx, "b_random_split", split,
                         split_check, clock=clock))
    return rows


def p18_part_c(torch, np, ck, vt, ctx, d):
    """18c: count_approx_distinct over the key and the (k, v) rows."""
    from vega_tpu_torch import hll

    k, x = d["k"], d["x"]
    hk, hv = p18_hash_ints(np, k), p18_hash_ints(np, x)
    hashes = {"key": hk, "pairs": p18_hash_pairs(np, hk, hv)}
    rows = []
    for what in ("key", "pairs"):
        for sd in (0.05, 0.01):
            def run(what=what, sd=sd):
                node = ctx.dense_from_numpy(k, x)
                node = node.keys() if what == "key" else node
                return node.count_approx_distinct(sd)

            def check(got, what=what, sd=sd):
                want, p = p18_hll(np, hashes[what], sd)
                p18_check(f"c_{what} at {sd}: the numpy HLL's estimate "
                          f"(got {got}, numpy {want})", got == want)
                return f"p = {p}, estimate {got}"

            rows.append(p18_case(torch, ck, ctx, f"c_{what}_{sd}", run,
                                 check, clock=[(hll, "estimate")]))
    return rows


def p18_part_d(torch, np, ck, vt, ctx, d):
    """18d: the approximate actions at P18D_ROWS, one host task a shard
    through the evaluators: final and exact under a long deadline, then
    count_approx with one straggling shard (faults.maybe_slow_task): the
    estimate first, not final, then the exact count."""
    from vega_tpu_torch import block as block_lib
    from vega_tpu_torch import faults

    n = P18D_ROWS
    # the device reads of the tasks' shards
    clock = [(block_lib.Block, "shard_rows")]
    k, x, f = d["k"][:n], d["x"][:n], d["f"][:n]
    rows = []

    def count():
        return ctx.dense_from_numpy(k, x).count_approx(P18D_DEADLINE_S)

    rows.append(p18_case(
        torch, ck, ctx, "d_count_approx", count,
        lambda r: (p18_check("d_count_approx: final, the exact count",
                             r.is_initial_value_final
                             and r.get_final_value().mean == n
                             and r.get_final_value().low == n),
                   f"{r.get_final_value()}")[1],
        clock=clock, kind="device", warm=P18D_WARM))

    def mean():
        return ctx.dense_from_numpy(f).mean_approx(P18D_DEADLINE_S)

    def mean_check(r):
        want = float(np.mean(f.astype(np.float64)))
        got = r.get_final_value().mean
        p18_check(f"d_mean_approx: final, the mean (got {got}, numpy "
                  f"{want})", r.is_initial_value_final
                  and abs(got - want) <= 1e-12 * float(np.mean(np.abs(f))))
        return f"mean {got!r} (numpy {want!r})"

    rows.append(p18_case(torch, ck, ctx, "d_mean_approx", mean, mean_check,
                         clock=clock, kind="device",
                         warm=P18D_WARM))

    def by_value():
        return ctx.dense_from_numpy(k).count_by_value_approx(
            P18D_DEADLINE_S)

    def by_value_check(r):
        got = r.get_final_value()
        cnt = np.bincount(k, minlength=P18_KEYS)
        want_values = int(np.count_nonzero(cnt))
        p18_check("d_count_by_value_approx: final, every value's count",
                  r.is_initial_value_final and len(got) == want_values
                  and all(got[i].mean == cnt[i] and got[i].confidence == 1.0
                          for i in range(0, want_values, 997)))
        return f"{len(got)} values"

    rows.append(p18_case(torch, ck, ctx, "d_count_by_value_approx",
                         by_value, by_value_check,
                         clock=clock, kind="device",
                         warm=P18D_WARM))

    node = ctx.dense_from_numpy(k, x)
    faults.configure(slow_tasks=1, slow_task_s=P18D_STRAGGLE_S)
    try:
        t0 = time.perf_counter()
        r = node.count_approx(P18D_PARTIAL_DEADLINE_S)
        first_s = time.perf_counter() - t0
        first, first_final = r.initial_value, r.is_initial_value_final
        last = r.get_final_value(P18D_DEADLINE_S)
        last_s = time.perf_counter() - t0
    finally:
        faults.reset()
    p18_check(f"d_count_approx with a straggler: the estimate {first} "
              f"first, not final, then the exact count {last}",
              not first_final and first.low <= n <= first.high
              and last.mean == n and last.confidence == 1.0)
    log(f"18 d_count_approx_partial: estimate {first} after "
        f"{first_s * 1e3:.3f} ms, final {last} after {last_s * 1e3:.3f} "
        f"ms (one shard slowed {P18D_STRAGGLE_S} s)")
    rows.append(dict(label="d_count_approx_partial", note=str(first),
                     final=str(last), first_ms=first_s * 1e3,
                     final_ms=last_s * 1e3,
                     launches={name: 0 for name in ck.LAUNCHES}))
    return rows


def p18_part_e(torch, np, ck, vt, ctx, d):
    """18e: the host-row actions at P18E_ROWS pairs, one shard at a
    time. The clock times their device reads (Block.shard_rows); the rest
    is host."""
    from vega_tpu_torch import block as block_lib

    n = P18E_ROWS
    k, x = d["k"][:n], d["x"][:n]
    clock = [(block_lib.Block, "shard_rows")]
    rows = []
    peaks = []

    def iterate():
        base = p18_rss()
        peak = 0
        vs = np.empty(n, np.int64)
        i = 0
        for kk, v in ctx.dense_from_numpy(k, x).to_local_iterator():
            vs[i] = v
            i += 1
            if i % 1_000_000 == 0:
                peak = max(peak, p18_rss() - base)
        peaks.append(max(peak, p18_rss() - base))
        return i, vs

    def iterate_check(out):
        i, vs = out
        p18_check("e_to_local_iterator: the rows of collect(), in order",
                  i == n and np.array_equal(vs, x))
        return f"{i} rows, host peak {peaks[-1]} B above the start"

    rows.append(p18_case(torch, ck, ctx, "e_to_local_iterator", iterate,
                         iterate_check, clock=clock, kind="device"))
    rows[-1]["host_peak_bytes"] = max(peaks)

    def each():
        acc = [0, 0]

        def f(row):
            acc[0] += 1
            acc[1] += row[1]
        ctx.dense_from_numpy(k, x).for_each(f)
        return acc

    rows.append(p18_case(
        torch, ck, ctx, "e_for_each", each,
        lambda acc: (p18_check("e_for_each: every row once",
                               acc == [n, n * (n - 1) // 2]),
                     f"{acc[0]} rows")[1], clock=clock, kind="device"))

    def each_partition():
        seen = []

        def f(it):
            rows = list(it)
            seen.append((len(rows), rows[0], rows[-1]) if rows else (0,))
        ctx.dense_from_numpy(k, x).for_each_partition(f)
        return seen

    def each_partition_check(seen):
        want = [(b - a, (int(k[a]), int(x[a])), (int(k[b - 1]), int(x[b - 1])))
                for a, b in p18_shards(n)]
        p18_check("e_for_each_partition: one iterator a shard (in the "
                  "order the tasks ran, as the reference's)",
                  sorted(seen) == sorted(want))
        return f"{len(seen)} partitions"

    rows.append(p18_case(torch, ck, ctx, "e_for_each_partition",
                         each_partition, each_partition_check, clock=clock,
                         kind="device"))

    def save():
        shutil.rmtree(P18_TEXT_DIR, ignore_errors=True)
        ctx.dense_from_numpy(k, x).save_as_text_file(P18_TEXT_DIR)
        return sorted(os.listdir(P18_TEXT_DIR))

    def save_check(files):
        ok = files == [f"part-{s:05d}" for s in range(N_SHARDS)]
        total = 0
        for s, (a, b) in enumerate(p18_shards(n)):
            with open(os.path.join(P18_TEXT_DIR, files[s]), "rb") as fh:
                got = fh.read()
            total += len(got)
            ok = ok and got == p18_text(np, k[a:b], x[a:b]).encode()
        p18_check("e_save_as_text_file: the files' bytes equal numpy's "
                  "formatting", ok)
        return f"{len(files)} files, {total} B"

    try:
        rows.append(p18_case(torch, ck, ctx, "e_save_as_text_file", save,
                             save_check, clock=clock, kind="device"))
    finally:
        shutil.rmtree(P18_TEXT_DIR, ignore_errors=True)
    return rows


def p18_part_f(torch, np, ck, vt, ctx):
    """18f: the async actions on the main path's lineage, two submitted
    back to back."""
    from vega_tpu_torch import dense_rdd

    rows = []
    xs = np.arange(P18_ROWS, dtype=np.int64)
    sums = np.bincount(xs % P18_KEYS, weights=xs * 0.5, minlength=P18_KEYS)
    del xs

    def reduced():
        return ctx.dense_range(P18_ROWS).map(
            lambda x: (x % P18_KEYS, x * 0.5)).reduce_by_key(op="add")

    def both():
        red = reduced()
        t0 = time.perf_counter()
        a, b = red.count_async(), red.collect_async()
        submit_ms = (time.perf_counter() - t0) * 1e3
        return a.result(600), b.result(600), red, submit_ms

    def both_check(out):
        n, rows_, red, submit_ms = out
        kk = np.array([r[0] for r in rows_])
        vv = np.array([r[1] for r in rows_])
        o = np.argsort(kk)
        p18_check("f_count_collect: results equal the synchronous ones and "
                  "numpy", n == red.count() == P18_KEYS
                  and rows_ == red.collect()
                  and np.array_equal(kk[o], np.arange(P18_KEYS))
                  and np.allclose(vv[o], sums, rtol=1e-5, atol=0))
        return f"{n} keys, submitted in {submit_ms:.3f} ms"

    rows.append(p18_case(torch, ck, ctx, "f_count_collect_async", both,
                         both_check, clock=[(dense_rdd, "_host_rows")],
                         need=("hash_bucket", "digit_hist")))

    def reduce_():
        red = reduced()
        return red.values().reduce_async(operator.add).result(600), red

    def reduce_check(out):
        got, red = out
        want = red.values().reduce(operator.add)
        p18_check(f"f_reduce_async: reduce()'s value ({got} vs {want}) "
                  f"and numpy's sum", got == want
                  and math.isclose(got, float(sums.sum()), rel_tol=1e-5))
        return f"sum {got!r}"

    rows.append(p18_case(torch, ck, ctx, "f_reduce_async", reduce_,
                         reduce_check))
    return rows


def phase_eighteen(torch, np, ck, vt):
    """Phase 18: the RDD API's host-tier answers on the card, at
    P18_ROWS pairs (x % K, x) over K keys and a float32 column, 8 shards:
    (a) closures past int32 in the host tier's row form, (b) Poisson
    sampling, take_sample and random_split against numpy's replay of the
    reference's PCG64 streams, (c) count_approx_distinct against a numpy
    HyperLogLog, (d) the approximate actions, (e) the host-row actions,
    (f) the async actions. Each case once cold (checked, launches counted)
    and P18_WARM times warm: median ms, host part apart, step peak."""
    t0 = time.perf_counter()
    card = card_line()
    d = p18_data(np)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    parts = {}
    for part, fn in (("a", p18_part_a), ("b", p18_part_b),
                     ("c", p18_part_c), ("d", p18_part_d),
                     ("e", p18_part_e)):
        t1 = time.perf_counter()
        rows += fn(torch, np, ck, vt, ctx, d)
        parts[part] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rows += p18_part_f(torch, np, ck, vt, ctx)
    parts["f"] = time.perf_counter() - t1
    ctx.stop()
    del d
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 18")
    wall_s = time.perf_counter() - t0
    log(f"phase 18 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts, e_rows=P18E_ROWS)


P19_ROWS = N_ROWS              # bench-main's dense_range(20M) (x % K, x * 0.5)
P19_KEYS = N_KEYS
P19_WIDE_KEYS = 1_100_000      # 19b's right_outer_join table: 100K keys more
P19_SRC_ROWS = 2_000_000       # 19e's parallelize source, Python rows
# 19e's checkpoint, cut from the 20M-row node: there it took 21.4 s cold
# and 23.5 s warm (20M Python tuples pickled to 317 MB and read back) of
# phase 19's 177.9 s (NVIDIA H100 80GB HBM3, 700.00 W)
P19E_CKPT_ROWS = 2_000_000
P19_WARM = 1
P19_CKPT_DIR = "p19_ckpt.tmp"  # 19e's checkpoint files, removed after


def p19_check(what, ok):
    if not ok:
        fail(f"phase 19: {what}")


def p19_reduced(np):
    """numpy's replay of the main path's reduce: the key k's sum of
    x * 0.5 over x = k (mod K) in [0, N), in float64."""
    x = np.arange(P19_ROWS, dtype=np.int64)
    return np.bincount(x % P19_KEYS, weights=x * 0.5,
                       minlength=P19_KEYS)


def p19_close(np, got, exp):
    """float32 device sums against float64 numpy: rtol 1e-5."""
    return np.allclose(got, exp, rtol=1e-5, atol=0.0)


def p19_hash_mod(np, keys, n):
    """The reference's HashPartitioner(n) of int keys: splitmix64 % n."""
    return (p18_hash_ints(np, np.asarray(keys)) % np.uint64(n)).astype(
        np.int64)


def p19_case(torch, ck, label, steps, check, warm=P19_WARM, phase=19):
    """One case: steps [(name, part, fn(previous output))], part "card"
    (device work, to a synchronize), "host" (rows formed and moved on the
    host; a dense() step's from_numpy lift timed apart by a clock) or
    "lift". A cold run (launches counted from 0, checked), then `warm`
    runs: the median of the whole and of each part, and the launches and
    the device memory peak of each step of the cold run (the peak above
    the memory allocated when the step starts is in step_peaks)."""
    from vega_tpu_torch import dense_rdd

    def one():
        torch.cuda.synchronize()
        ck.reset_launches()
        parts = {"card": 0.0, "host": 0.0, "lift": 0.0}
        steps_launches = {}
        peaks = {}
        out = None
        t0 = time.perf_counter()
        with _P18Clock(torch, ((dense_rdd, "dense_from_numpy"),)) as lift:
            for name, part, fn in steps:
                before = dict(ck.LAUNCHES)
                lift_before = lift.ms
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                out = fn(out)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                peaks[name] = torch.cuda.max_memory_allocated()
                lifted = lift.ms - lift_before
                parts[part] += ms - lifted
                parts["lift"] += lifted
                steps_launches[name] = {k: ck.LAUNCHES[k] - before[k]
                                        for k in ck.LAUNCHES}
        whole = (time.perf_counter() - t0) * 1e3
        return out, dict(ms=whole, parts=parts, step_launches=steps_launches,
                         launches=dict(ck.LAUNCHES), step_peaks=peaks)

    out, cold = one()
    note = check(out)
    del out
    runs = [one()[1] for _ in range(warm)]
    med = statistics.median(r["ms"] for r in runs)
    r = dict(label=label, note=note, cold=cold, warm=runs, median_ms=med,
             median_parts={p: statistics.median(x["parts"][p] for x in runs)
                           for p in ("card", "host", "lift")},
             launches=cold["launches"], step_launches=cold["step_launches"],
             peak_bytes=max(cold["step_peaks"].values()))
    log(f"{phase} {label}: {note}; {med:.3f} ms warm median of {warm} "
        f"(parts {json.dumps(r['median_parts'])}), cold {cold['ms']:.3f} "
        f"ms, step peak {r['peak_bytes']} B, launches "
        f"{json.dumps(cold['step_launches'])}")
    return r


def p19_part_a(torch, np, ck, vt, ctx, exp):
    """19a: the main path's reduce on the card, handed to the host tier
    (to_rdd().map_partitions), lifted back (dense()) and joined."""
    table = ctx.dense_from_numpy(np.arange(P19_KEYS, dtype=np.int32),
                                 np.arange(P19_KEYS, dtype=np.float32) * 2)
    table.block()
    state = {}

    def reduce(_):
        node = ctx.dense_range(P19_ROWS).map(
            lambda x: (x % P19_KEYS, x * 0.5)).reduce_by_key(op="add")
        node.block()
        state["reduced"] = node
        return node

    def hand_off(node):
        return node.to_rdd().map_partitions(
            lambda it: ((k, v * 2) for k, v in it)).dense()

    def join(lifted):
        state["lifted"] = lifted
        return lifted.join(table).count()

    def check(n):
        lifted, reduced = state["lifted"], state["reduced"]
        p19_check(f"19a lifted is a DenseRDD ({type(lifted).__name__})",
                  isinstance(lifted, vt.dense_rdd.DenseRDD))
        got, base = lifted.collect_arrays(), reduced.collect_arrays()
        p19_check("19a join count == K", n == P19_KEYS)
        p19_check("19a lifted rows are the reduce's, v * 2 exactly",
                  np.array_equal(got["k"], base["k"])
                  and np.array_equal(got["v"], base["v"] * 2))
        p19_check("19a sums equal numpy (rtol 1e-5)",
                  p19_close(np, got["v"][np.argsort(got["k"])] / 2, exp))
        return f"count {n}, {len(got['k'])} rows lifted equal numpy"

    return [p19_case(torch, ck, "a_to_rdd_and_back",
                     [("reduce", "card", reduce),
                      ("to_rdd.map_partitions.dense", "host", hand_off),
                      ("join.count", "card", join)], check)]


def p19_part_b(torch, np, ck, vt, ctx, exp):
    """19b: the result objects as host RDDs: a cogroup's map_values
    lifted and counted, a right_outer_join filtered and counted, and a
    cogroup of three sides (the host CoGroupedRDD)."""
    table = ctx.dense_from_numpy(np.arange(P19_KEYS, dtype=np.int32),
                                 np.arange(P19_KEYS, dtype=np.float32) * 2)
    wide = ctx.dense_from_numpy(np.arange(P19_WIDE_KEYS, dtype=np.int32),
                                np.ones(P19_WIDE_KEYS, np.float32))
    reduced = ctx.dense_range(P19_ROWS).map(
        lambda x: (x % P19_KEYS, x * 0.5)).reduce_by_key(op="add")
    for node in (table, wide, reduced):
        node.block()
    rows = []
    state = {}

    def cogroup(_):
        cg = reduced.cogroup(table)
        # the two device group_by_keys, which compute() would otherwise
        # materialize inside the host step
        cg.left_grouped.block()
        cg.right_grouped.block()
        return cg

    def lift(cg):
        lifted = cg.map_values(
            lambda lr: (len(lr[0]), sum(lr[1]))).dense()
        state["lifted"] = lifted
        return lifted

    def count(lifted):
        return lifted.count()

    def check_cg(n):
        got = state["lifted"].collect_arrays()
        order = np.argsort(got["k"])
        p19_check("19b cogroup count == K", n == P19_KEYS)
        p19_check("19b cogroup rows: (1, 2k) a key",
                  np.array_equal(got["k"][order], np.arange(P19_KEYS))
                  and np.array_equal(got["v"][order],
                                     np.stack([np.ones(P19_KEYS),
                                               np.arange(P19_KEYS) * 2.0],
                                              axis=1)))
        return f"{n} keys, (1, 2k) each"

    rows.append(p19_case(torch, ck, "b_cogroup_map_values_dense",
                         [("cogroup", "card", cogroup),
                          ("map_values.dense", "host", lift),
                          ("count", "card", count)], check_cg))

    def right_outer(_):
        ro = reduced.right_outer_join(wide)
        ro.prev.left_grouped.block()  # the device cogroup's two sides
        ro.prev.right_grouped.block()
        return ro

    def unmatched(ro):
        return ro.filter(lambda kv: kv[1][0] is None).count()

    def check_ro(n):
        p19_check("19b right_outer_join: the 100K keys the left lacks",
                  n == P19_WIDE_KEYS - P19_KEYS)
        return f"{n} unmatched rows"

    rows.append(p19_case(torch, ck, "b_right_outer_filter",
                         [("right_outer_join", "card", right_outer),
                          ("filter.count", "host", unmatched)], check_ro))

    def three(_):
        cg = reduced.cogroup(table, wide)
        state["cg3"] = cg
        return cg.map_values(
            lambda g: (len(g[0]), len(g[1]), len(g[2]))).collect()

    def check_three(got):
        keys = np.array([k for k, _ in got], np.int64)
        sizes = np.array([s for _, s in got], np.int64)
        order = np.argsort(keys)
        exp_sizes = np.ones((P19_WIDE_KEYS, 3), np.int64)
        exp_sizes[P19_KEYS:, :2] = 0
        p19_check("19b three-side cogroup: every key once, sizes",
                  np.array_equal(keys[order], np.arange(P19_WIDE_KEYS))
                  and np.array_equal(sizes[order], exp_sizes))
        part = p19_hash_mod(np, np.arange(P19_WIDE_KEYS), N_SHARDS)
        sizes_by_part = state["cg3"].glom().map(len).collect()
        p19_check("19b three-side cogroup: HashPartitioner(8) placement",
                  sizes_by_part == np.bincount(
                      part, minlength=N_SHARDS).tolist())
        return f"{len(got)} keys over {sizes_by_part}"

    rows.append(p19_case(torch, ck, "b_cogroup_three_sides",
                         [("cogroup3.map_values.collect", "host", three)],
                         check_three))
    return rows


def p19_part_c(torch, np, ck, vt, ctx, exp):
    """19c: partitions: glom against the shard counts, coalesce(2) and
    repartition(16) against numpy's replay of the reference's
    placement."""
    reduced = ctx.dense_range(P19_ROWS).map(
        lambda x: (x % P19_KEYS, x * 0.5)).reduce_by_key(op="add")
    reduced.block()
    counts = reduced.block().counts_np.tolist()
    base = reduced.collect_arrays()
    bk, bv = base["k"], base["v"]
    rows = []

    def glom(_):
        return reduced.glom().map(len).collect()

    rows.append(p19_case(torch, ck, "c_glom_sizes",
                         [("glom.map.collect", "host", glom)],
                         lambda got: (p19_check("19c glom == counts",
                                                got == counts),
                                      f"sizes {got}")[1]))

    def coalesce(_):
        c2 = reduced.coalesce(2)
        return c2.glom().map(len).collect(), c2.collect()

    def check_co(out):
        sizes, got = out
        p19_check("19c coalesce(2) sizes: shards 0-3 and 4-7",
                  sizes == [sum(counts[:4]), sum(counts[4:])])
        p19_check("19c coalesce(2) rows in shard order",
                  np.array_equal(np.array([k for k, _ in got]), bk)
                  and np.array_equal(np.array([v for _, v in got]), bv))
        return f"sizes {sizes}"

    rows.append(p19_case(torch, ck, "c_coalesce_2",
                         [("coalesce.glom+collect", "host", coalesce)],
                         check_co))

    def repartition(_):
        r16 = reduced.repartition(16)
        return r16.glom().collect()

    def check_re(parts):
        # row i of shard p is keyed p + i and goes to splitmix64(key) %
        # 16; a reduce partition's rows come by key ascending (the first
        # seen order of the map outputs), each key's rows in shard order
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        shard = np.repeat(np.arange(N_SHARDS), counts)
        key = shard + (np.arange(len(bk)) - starts[shard])
        dest = p19_hash_mod(np, key, 16)
        order = np.lexsort((shard, key, dest))
        sizes = [len(p) for p in parts]
        p19_check("19c repartition(16) sizes", sizes == np.bincount(
            dest, minlength=16).tolist())
        got = [row for p in parts for row in p]
        p19_check("19c repartition(16) rows in the reference's order",
                  np.array_equal(np.array([k for k, _ in got]), bk[order])
                  and np.array_equal(np.array([v for _, v in got]),
                                     bv[order]))
        return f"sizes {sizes}"

    rows.append(p19_case(torch, ck, "c_repartition_16",
                         [("repartition.glom.collect", "host", repartition)],
                         check_re))
    return rows


def p19_part_d(torch, np, ck, vt, ctx, exp):
    """19d: Python objects per row: flat_map, flat_map_values, pipe."""
    reduced = ctx.dense_range(P19_ROWS).map(
        lambda x: (x % P19_KEYS, x * 0.5)).reduce_by_key(op="add")
    base = reduced.collect_arrays()
    bk, bv = base["k"], base["v"]
    rows = []
    rows.append(p19_case(
        torch, ck, "d_flat_map",
        [("flat_map.count", "host",
          lambda _: reduced.flat_map(lambda kv: [kv, kv]).count())],
        lambda n: (p19_check("19d flat_map count", n == 2 * len(bk)),
                   f"{n} rows")[1]))

    def check_fmv(got):
        p19_check("19d flat_map_values rows", np.array_equal(
            np.array([k for k, _ in got]), np.repeat(bk, 2))
            and np.array_equal(np.array([v for _, v in got]),
                               np.tile([0, 1], len(bk))))
        return f"{len(got)} rows"

    rows.append(p19_case(
        torch, ck, "d_flat_map_values",
        [("flat_map_values.collect", "host",
          lambda _: reduced.flat_map_values(lambda v: range(2)).collect())],
        check_fmv))

    def check_pipe(lines):
        text = "\n".join(lines) + "\n"
        p19_check("19d pipe('cat') lines equal numpy's formatting",
                  text == p18_text(np, bk, bv.astype(np.float64)))
        return f"{len(lines)} lines"

    rows.append(p19_case(
        torch, ck, "d_pipe_cat",
        [("pipe.collect", "host", lambda _: reduced.pipe("cat").collect())],
        check_pipe))
    return rows


def p19_part_e(torch, np, ck, vt, ctx, exp):
    """19e: the scheduler's names on the 20M-row node, a checkpoint, and
    parallelize(...).dense()."""
    from vega_tpu_torch.split import Split

    rows = []
    state = {}

    def node():
        return ctx.dense_range(P19_ROWS).map(
            lambda x: (x % P19_KEYS, x * 0.5))

    def sched(_):
        n = node()
        n.block()
        state["node"] = n
        return n.splits(), list(n.compute(Split(0))), n.to_debug_string()

    def check_sched(out):
        splits, first, text = out
        per = -(-P19_ROWS // N_SHARDS)
        x = np.arange(per)
        p19_check("19e splits", [s.index for s in splits]
                  == list(range(N_SHARDS)))
        p19_check("19e compute(Split(0)) == shard 0's rows",
                  np.array_equal(np.array([k for k, _ in first]),
                                 x % P19_KEYS)
                  and np.array_equal(np.array([v for _, v in first]),
                                     x * 0.5))
        lines = [ln.split("[")[0] for ln in text.splitlines()]
        p19_check(f"19e to_debug_string {lines}",
                  lines == ["(8) _MapRDD", "  | (8) _SourceRDD"])
        return f"{len(first)} rows in shard 0; {lines}"

    rows.append(p19_case(torch, ck, "e_splits_compute_debug",
                         [("splits.compute.to_debug_string", "host", sched)],
                         check_sched))

    def ckpt(_):
        shutil.rmtree(P19_CKPT_DIR, ignore_errors=True)
        n = ctx.dense_range(P19E_CKPT_ROWS).map(
            lambda x: (x % P19_KEYS, x * 0.5)).checkpoint(
                os.path.abspath(P19_CKPT_DIR))
        state["ck"] = n
        return n.glom().count()

    def check_ckpt(n):
        files = sorted(os.listdir(P19_CKPT_DIR))
        node_ = state["ck"]
        p19_check("19e checkpoint: 8 part files, lineage cut",
                  n == N_SHARDS and files == [f"part-{s:05d}.ckpt"
                                               for s in range(N_SHARDS)]
                  and node_.get_dependencies() == []
                  and node_._checkpointed_rdd is not None)
        size = sum(os.path.getsize(os.path.join(P19_CKPT_DIR, f))
                   for f in files)
        return f"{len(files)} files, {size} B"

    try:
        rows.append(p19_case(torch, ck, "e_checkpoint_glom",
                             [("checkpoint.glom.count", "host", ckpt)],
                             check_ckpt))
    finally:
        shutil.rmtree(P19_CKPT_DIR, ignore_errors=True)

    src = [(i % P19_KEYS, i) for i in range(P19_SRC_ROWS)]

    def lift(_):
        return ctx.parallelize(src, N_SHARDS).dense()

    def reduce(d):
        state["src_dense"] = d
        node_ = d.reduce_by_key(op="add")
        state["src_reduced"] = node_
        return node_.count()

    def check_src(n):
        got = state["src_reduced"].collect_arrays()
        i = np.arange(P19_SRC_ROWS, dtype=np.int64)
        want = np.bincount(i % P19_KEYS, weights=i, minlength=P19_KEYS)
        p19_check("19e parallelize.dense is a DenseRDD",
                  isinstance(state["src_dense"], vt.dense_rdd.DenseRDD))
        p19_check("19e parallelize.dense.reduce_by_key equals numpy",
                  n == P19_KEYS and np.array_equal(
                      got["v"][np.argsort(got["k"])], want))
        return f"{n} keys"

    rows.append(p19_case(torch, ck, "e_parallelize_dense",
                         [("parallelize.dense", "host", lift),
                          ("reduce_by_key.count", "card", reduce)],
                         check_src))
    return rows


def phase_nineteen(torch, np, ck, vt):
    """Phase 19: the host RDD layer the reference hands off to, at
    bench-main's dense_range(20M) over K = 1M keys, 8 shards: (a) the
    reduce to_rdd().map_partitions(...).dense() and joined, (b) cogroup
    and right_outer_join results as host RDDs, a cogroup of three sides,
    (c) glom, coalesce(2), repartition(16), (d) flat_map,
    flat_map_values, pipe("cat"), (e) splits / compute / to_debug_string,
    checkpoint, parallelize(2M rows).dense(). Each case once cold
    (checked against numpy, launches counted from 0 per step) and
    P19_WARM times warm: median ms, the card, host and lift parts
    apart."""
    t0 = time.perf_counter()
    card = card_line()
    exp = p19_reduced(np)
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    parts = {}
    for part, fn in (("a", p19_part_a), ("b", p19_part_b),
                     ("c", p19_part_c), ("d", p19_part_d),
                     ("e", p19_part_e)):
        t1 = time.perf_counter()
        rows += fn(torch, np, ck, vt, ctx, exp)
        parts[part] = time.perf_counter() - t1
    ctx.stop()
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 19")
    a = rows[0]["step_launches"]
    p19_check("19a: the card's reduce launched hash_bucket and digit_hist",
              a["reduce"]["hash_bucket"] > 0 and a["reduce"]["digit_hist"] > 0)
    p19_check("19a: the lifted rows' join launched the kernels",
              sum(a["join.count"].values()) > 0)
    wall_s = time.perf_counter() - t0
    log(f"phase 19 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts)


# the host layer's fast paths that --phase 19 --without swaps for their
# plain forms, one per run: hash, HashPartitioner.get_partitions's numpy
# splitmix64 over plain ints (plain: Partitioner's hash_key per key);
# bucket, the map side's inlined list-collecting aggregator (plain:
# create_combiner / merge_value per row); gc, run_job's pause of the
# cyclic garbage collector (plain: the collector left on); and two costs
# of the local runtime, to split a slowdown between them: pickle, the map
# side's pickling of each bucket into the shuffle store and the reduce
# side's unpickling (without: the bucket object itself is stored, as
# zero bytes, so nothing spills), and threads, the local backend's eight
# task threads (without: one)
P19_PATHS = ("hash", "bucket", "gc", "pickle", "threads")


class _P19Held(bytes):
    """A bucket stored as itself (--without pickle): zero bytes long."""


def p19_plain_bucket(dep, rows, buckets):
    """dependency.py's _bucket through the aggregator's own functions
    for every aggregator."""
    parts = dep.partitioner.get_partitions([kv[0] for kv in rows])
    create = dep.aggregator.create_combiner
    merge = dep.aggregator.merge_value
    for (k, v), p in zip(rows, parts):
        bucket = buckets[p]
        if k in bucket:
            bucket[k] = merge(bucket[k], v)
        else:
            bucket[k] = create(v)


def p19_without(path):
    """Swap one fast path of the host layer (P19_PATHS) for its plain
    form, for the rest of the process."""
    import contextlib

    from vega_tpu_torch import dependency, partitioner
    from vega_tpu_torch.scheduler import dag

    if path == "hash":
        partitioner.HashPartitioner.get_partitions = \
            partitioner.Partitioner.get_partitions
    elif path == "bucket":
        dependency._bucket = p19_plain_bucket
    elif path == "gc":
        dag.paused_gc = contextlib.nullcontext
    elif path == "pickle":
        import types

        from vega_tpu_torch import serialization
        from vega_tpu_torch.shuffle import fetcher

        def held(obj):
            blob = _P19Held()
            blob.obj = obj
            return blob

        dependency.serialization = types.SimpleNamespace(dumps=held)
        fetcher.serialization = types.SimpleNamespace(
            loads=lambda b: b.obj if isinstance(b, _P19Held)
            else serialization.loads(b))
    elif path == "threads":
        import vega_tpu_torch as vt

        init = vt.Context.__init__

        def one_thread(self, *a, **kw):
            kw.setdefault("num_workers", 1)
            init(self, *a, **kw)
        vt.Context.__init__ = one_thread
    else:
        fail(f"--without takes one of {', '.join(P19_PATHS)}, not {path!r}")


def phase19_leg(without=None):
    """--phase 19 [--without PATH]: the kernels built, then phase 19
    alone (at the whole script's sizes), with one fast path of the host
    layer swapped for its plain form. Prints one JSON line (each case's
    warm median ms and its parts, cold ms, the phase's wall), writes
    chiprun_out/p19_<PATH or all>.json, and ends with the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    if without is not None:
        p19_without(without)
    res = phase_nineteen(torch, np, ck, vt)
    out = dict(phase=19, without=without, wall_s=res["wall_s"],
               parts_s=res["parts_s"], launches=res["launches"], card=card,
               cases={r["label"]: dict(median_ms=r["median_ms"],
                                       parts=r["median_parts"],
                                       cold_ms=r["cold"]["ms"])
                      for r in res["rows"]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"p19_{without or 'all'}.json"),
              "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


# ---------------------------------------------------------------------------
# 20. the reference's implicit host fall-throughs
# ---------------------------------------------------------------------------
P20_ROWS = 2_000_000           # 20a: bench-main's source cut to 2M rows
P20_KEYS = N_KEYS              # 20a: the main path's K-row table
P20_PAIRS = 200_000            # 20b / 20c: seeded pairs over 20K keys
P20_PAIR_KEYS = 20_000
P20_PARTS = 16                 # 20b: HashPartitioner(16)
P20_STREAM_ROWS = 1_000_000    # 20d: dense_range in chunks of 250K rows
P20_CHUNK = 250_000
P20_STREAM_KEYS = 1_000
P20_OBJ_ROWS = 100_000         # 20e: an object column over 100 keys
P20_OBJ_KEYS = 100
P20_WARM = 1


def p20_check(what, ok):
    if not ok:
        fail(f"phase 20: {what}")


def p20_sqrt_sums(np, n, k):
    """numpy's replay of a host reduce of (x % k, sqrt(x)) over x in
    [0, n): float64 sums per key."""
    x = np.arange(n, dtype=np.int64)
    return np.bincount(x % k, weights=np.sqrt(x), minlength=k)


def p20_part_a(torch, np, ck, vt, ctx):
    """20a: bench-main's source at P20_ROWS rows through a map whose
    closure calls math.sqrt (the trace refuses it, as jax's does: the
    host RDD layer's MapperRDD), the host reduce_by_key, dense() lifting
    the K reduced rows back, and their join with the K-row table on the
    card."""
    table = ctx.dense_from_numpy(np.arange(P20_KEYS, dtype=np.int32),
                                 np.arange(P20_KEYS, dtype=np.float32) * 2)
    table.block()
    exp = p20_sqrt_sums(np, P20_ROWS, P20_KEYS)
    state = {}

    def host(_):
        node = ctx.dense_range(P20_ROWS).map(
            lambda x: (x % P20_KEYS, math.sqrt(x)))
        state["kind"] = type(node).__name__
        p20_check(f"20a: the untraceable map is a host node "
                  f"({state['kind']})",
                  not isinstance(node, vt.dense_rdd.DenseRDD))
        return node.reduce_by_key(operator.add).dense()

    def join(lifted):
        state["lifted"] = lifted
        return lifted.join(table).count()

    def check(n):
        lifted = state["lifted"]
        p20_check("20a: dense() lifted the rows onto the card",
                  isinstance(lifted, vt.dense_rdd.DenseRDD))
        got = lifted.collect_arrays()
        k, v = got["k"], got["v"]
        p20_check("20a: every key once",
                  np.array_equal(np.sort(k), np.arange(P20_KEYS)))
        p20_check("20a: the sums equal numpy's (rtol 1e-6, float32)",
                  np.allclose(v, exp[k], rtol=1e-6, atol=0.0))
        p20_check("20a: join count == K", n == P20_KEYS)
        return (f"map a {state['kind']}, {len(k)} reduced rows lifted, "
                f"join count {n}")

    r = p19_case(torch, ck, "a_untraceable_map_reduce_join",
                 [("map.reduce_by_key.dense", "host", host),
                  ("join.count", "card", join)], check, P20_WARM, 20)
    jl = r["step_launches"]["join.count"]
    p20_check(f"20a: the lifted rows' join launched all three kernels "
              f"({jl})", all(jl[k] > 0 for k in
                             ("hash_bucket", "digit_hist", "partition_pos")))
    return [r]


def p20_pairs(np):
    rng = np.random.default_rng(20)
    k = rng.integers(0, P20_PAIR_KEYS, P20_PAIRS).astype(np.int32)
    v = rng.integers(-1000, 1000, P20_PAIRS).astype(np.int32)
    tk = np.arange(0, P20_PAIR_KEYS, 2, dtype=np.int32)
    return k, v, tk


def p20_part_b(torch, np, ck, vt, ctx):
    """20b: join and cogroup under HashPartitioner(16): the host join and
    CoGroupedRDD, whose 16 partitions hold each key where the reference's
    splitmix64 % 16 puts it; rows and sums against numpy."""
    from vega_tpu_torch.partitioner import HashPartitioner

    k, v, tk = p20_pairs(np)
    matched = np.isin(k, tk)
    part = HashPartitioner(P20_PARTS)
    state = {}

    def sources(_):
        kv = ctx.dense_from_numpy(k, v)
        t = ctx.dense_from_numpy(tk, tk * 3)
        kv.block()
        t.block()
        return kv, t

    def join(sides):
        kv, t = sides
        state["sides"] = sides
        return kv.join(t, part).glom().collect()

    def cogroup(joined):
        state["join"] = joined
        kv, t = state["sides"]
        return kv.cogroup(t, partitioner_or_num=part).glom().collect()

    def placed(parts):
        return all(
            not p or np.all(p19_hash_mod(np, [r[0] for r in p],
                                         P20_PARTS) == i)
            for i, p in enumerate(parts))

    def check(groups):
        joined = state["join"]
        rows = [r for p in joined for r in p]
        p20_check("20b: 16 join partitions, each key in its partition",
                  len(joined) == P20_PARTS and placed(joined))
        p20_check("20b: the join's rows equal numpy's",
                  len(rows) == int(matched.sum())
                  and sum(lv for _k, (lv, _rv) in rows)
                  == int(v[matched].sum())
                  and all(rv == kk * 3 for kk, (_lv, rv) in rows))
        keys = np.union1d(k, tk)
        flat = [g for p in groups for g in p]
        p20_check("20b: 16 cogroup partitions, each key in its partition",
                  len(groups) == P20_PARTS and placed(groups))
        p20_check("20b: the cogroup's groups equal numpy's",
                  len(flat) == len(keys)
                  and sum(len(lv) for _k, (lv, _rv) in flat) == P20_PAIRS
                  and sum(len(rv) for _k, (_lv, rv) in flat) == len(tk))
        return (f"join glom sizes {[len(p) for p in joined]}, cogroup "
                f"glom sizes {[len(p) for p in groups]}")

    return [p19_case(torch, ck, "b_partitioner_join_cogroup",
                     [("sources", "card", sources),
                      ("join(HashPartitioner(16)).glom", "host", join),
                      ("cogroup(HashPartitioner(16)).glom", "host",
                       cogroup)], check, P20_WARM, 20)]


def p20_part_c(torch, np, ck, vt, ctx):
    """20c: left_outer_join(fill_value=None) (the host's, None for a
    missing right side) and a left_outer_join with a string right value
    (the device cogroup, then the host's rows with the fill 0)."""
    k, v, tk = p20_pairs(np)
    words = np.array([f"s{x}" for x in tk])
    matched = np.isin(k, tk)
    state = {}

    def sources(_):
        kv = ctx.dense_from_numpy(k, v)
        t = ctx.dense_from_numpy(tk, tk * 3)
        ts = ctx.dense_from_numpy(tk, words)
        for node in (kv, t, ts):
            node.block()
        return kv, t, ts

    def fill_none(sides):
        kv, t, ts = sides
        state["ts"] = (kv, ts)
        return kv.left_outer_join(t, fill_value=None).collect()

    def strings(rows):
        state["none"] = rows
        kv, ts = state["ts"]
        return kv.left_outer_join(ts).collect()

    def check(rows):
        none = state["none"]
        p20_check("20c: fill_value=None rows equal numpy's",
                  len(none) == P20_PAIRS
                  and sum(rv is None for _k, (_lv, rv) in none)
                  == int((~matched).sum())
                  and all(rv is None or rv == kk * 3
                          for kk, (_lv, rv) in none))
        p20_check("20c: string right values and fill 0 equal numpy's",
                  len(rows) == P20_PAIRS
                  and all(rv == (f"s{kk}" if kk % 2 == 0 else 0)
                          for kk, (_lv, rv) in rows))
        return (f"{len(none)} rows, {int((~matched).sum())} None; "
                f"{len(rows)} string rows")

    return [p19_case(torch, ck, "c_outer_fill_none_and_strings",
                     [("sources", "card", sources),
                      ("left_outer_join(fill_value=None)", "host",
                       fill_none),
                      ("left_outer_join(string right)", "host", strings)],
                     check, P20_WARM, 20)]


def p20_part_d(torch, np, ck, vt, ctx):
    """20d: a stream (dense_range in chunks) under an untraceable map: the
    probe decides before any chunk is built, and the resident build
    answers through the host RDD layer; its host reduce against numpy."""
    exp = p20_sqrt_sums(np, P20_STREAM_ROWS, P20_STREAM_KEYS)
    state = {}

    def host(_):
        s = ctx.dense_range(P20_STREAM_ROWS, chunk_rows=P20_CHUNK)
        built = []
        make = s._make_chunks
        s._make_chunks = lambda: (built.append(1), make())[1]
        node = s.map(lambda x: (x % P20_STREAM_KEYS, math.sqrt(x)))
        state["stream"] = type(s).__name__
        state["built"] = len(built)
        state["kind"] = type(node).__name__
        return node.reduce_by_key(operator.add).collect()

    def check(rows):
        p20_check(f"20d: a stream ({state['stream']}), no chunk built by "
                  f"the map ({state['built']}), a host node "
                  f"({state['kind']})",
                  state["stream"] == "StreamedDenseRDD"
                  and state["built"] == 0
                  and state["kind"] == "MapperRDD")
        got = dict(rows)
        p20_check("20d: the sums equal numpy's (rtol 1e-12)",
                  sorted(got) == list(range(P20_STREAM_KEYS))
                  and np.allclose([got[i] for i in range(P20_STREAM_KEYS)],
                                  exp, rtol=1e-12, atol=0.0))
        return f"{len(rows)} keys from the resident build's host reduce"

    return [p19_case(torch, ck, "d_stream_untraceable",
                     [("stream.map.reduce_by_key.collect", "host", host)],
                     check, P20_WARM, 20)]


def p20_part_e(torch, np, ck, vt, ctx):
    """20e: dense_from_numpy of an object column (ints and strings): the
    host tier's parallelize of its rows, a host map_values and reduce,
    dense() lifting the sums, and their join with a table on the card;
    against a plain Python replay."""
    keys = np.arange(P20_OBJ_ROWS) % P20_OBJ_KEYS
    obj = np.empty(P20_OBJ_ROWS, dtype=object)
    obj[:] = [i if i % 3 else f"w{i}" for i in range(P20_OBJ_ROWS)]
    exp = {}
    for kk, o in zip(keys.tolist(), obj.tolist()):
        exp[kk] = exp.get(kk, 0) + len(str(o))
    state = {}

    def host(_):
        src = ctx.dense_from_numpy(keys, obj)
        state["kind"] = type(src).__name__
        return src.map_values(lambda o: len(str(o))).reduce_by_key(
            operator.add).dense()

    def join(lifted):
        t = ctx.dense_from_numpy(np.arange(P20_OBJ_KEYS, dtype=np.int32),
                                 np.ones(P20_OBJ_KEYS, np.int32))
        return lifted.join(t).collect()

    def check(rows):
        p20_check(f"20e: the object source is parallelized "
                  f"({state['kind']})",
                  state["kind"] == "ParallelCollectionRDD")
        p20_check("20e: the joined sums equal the Python replay",
                  {kk: lv for kk, (lv, _rv) in rows} == exp)
        return f"{len(rows)} keys joined"

    return [p19_case(torch, ck, "e_object_source",
                     [("parallelize.map_values.reduce.dense", "host", host),
                      ("join.collect", "card", join)], check, P20_WARM, 20)]


# F21's closures: the tier the reference's trace picks for each (a
# DenseRDD, or the host RDD layer's node), which must not depend on the
# device the port runs on
def p20_tier_closures(np):
    return {
        "np_sqrt": lambda x: (x % 3, np.sqrt(x)),
        "np_where": lambda x: np.where(x > 1, x, 0),
        "np_int64": lambda x: int(np.int64(x) // 2),
        "math_sqrt": lambda x: math.sqrt(x),
        "float": lambda x: float(x),
        "branch": lambda x: x if x > 3 else 0,
        "dict_key": lambda x: {0: 1}.get(x, 2),
        "control": lambda x: (x % 3, x * 2),
    }


def p20_tiers(np, vt):
    """20f: each of F21's closures over dense_range(40) on the card and
    on the CPU: the same kind of node (a DenseRDD only for the control)
    and the same rows, element types included (repr)."""
    out = {}
    card = vt.Context(n_shards=N_SHARDS)
    cpu = vt.Context(device="cpu", n_shards=N_SHARDS)
    try:
        for name, f in p20_tier_closures(np).items():
            kinds, rows = [], []
            for ctx in (card, cpu):
                node = ctx.dense_range(40).map(f)
                kinds.append(type(node).__name__)
                rows.append(repr(node.collect()))
            p20_check(f"20f {name}: the card's tier and rows are the CPU's "
                      f"({kinds})", kinds[0] == kinds[1]
                      and rows[0] == rows[1])
            p20_check(f"20f {name}: the tier is jax's ({kinds[0]})",
                      (kinds[0] == "MapperRDD") == (name != "control"))
            out[name] = kinds[0]
    finally:
        card.stop()
        cpu.stop()
    log(f"20f tiers on the card and the CPU: {json.dumps(out)}")
    return out


def phase_twenty(torch, np, ck, vt):
    """Phase 20: the reference's implicit host fall-throughs on the card:
    (a) an untraceable map of bench-main's source at 2M rows, a host
    reduce, lifted and joined with the K-row table, (b) join and cogroup
    under HashPartitioner(16), (c) left_outer_join(fill_value=None) and a
    string right value, (d) a stream's untraceable map, (e) an object
    column's source. Each case once cold (checked against numpy or a
    Python replay, launches counted from 0 per step) and P20_WARM times
    warm: median ms, the card, host and lift parts apart, the step
    peak."""
    t0 = time.perf_counter()
    card = card_line()
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    parts = {}
    for part, fn in (("a", p20_part_a), ("b", p20_part_b),
                     ("c", p20_part_c), ("d", p20_part_d),
                     ("e", p20_part_e)):
        t1 = time.perf_counter()
        rows += fn(torch, np, ck, vt, ctx)
        parts[part] = time.perf_counter() - t1
    ctx.stop()
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 20")
    tiers = p20_tiers(np, vt)
    wall_s = time.perf_counter() - t0
    log(f"phase 20 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts, tiers=tiers)


def phase20_leg():
    """--phase 20: the kernels built, then phase 20 alone. Prints one
    JSON line (each case's warm median ms and its parts, cold ms, step
    peak, launches by step; the phase's wall), writes
    chiprun_out/p20.json, and ends with the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twenty(torch, np, ck, vt)
    out = dict(phase=20, wall_s=res["wall_s"], parts_s=res["parts_s"],
               launches=res["launches"], card=card, tiers=res["tiers"],
               cases={r["label"]: dict(note=r["note"],
                                       median_ms=r["median_ms"],
                                       parts=r["median_parts"],
                                       cold_ms=r["cold"]["ms"],
                                       peak_bytes=r["peak_bytes"],
                                       step_launches=r["step_launches"])
                      for r in res["rows"]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p20.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P21_ROWS = N_ROWS              # 21a: bench-main's chain, row-view methods
P21_KEYS = N_KEYS
P21_SMALL = 2_000_000          # 21a: the ndim / divmod closures
P21_SMALL_KEYS = 1_000
P21_FACT = 400_000             # 21b: the fact frame, cut from 20M rows
                               # (at 2M, 21b took 140.5 s of the phase)
P21_DIM = 100_000              # 21b: the sku-%06d dimension
P21_THRESHOLD = 500            # 21b: the frame query's filter
P21_C_ROWS = N_ROWS            # 21c: the device group-by handed to to_rdd
P21_C_KEYS = N_KEYS
P21_WARM = 1


def p21_check(what, ok):
    if not ok:
        fail(f"phase 21: {what}")


def p21_close(np, got, exp, rtol):
    return got.shape == exp.shape and np.allclose(got, exp, rtol=rtol,
                                                  atol=0.0)


def p21_round(np, x, scale):
    """numpy's replay of round(x.astype(float32) * scale, 1) as the row
    view computes it (jnp.round's float32 rescale, a multiply by the
    float32 reciprocal of 10)."""
    h = x.astype(np.float32) * np.float32(scale)
    return np.round(h * np.float32(10)) * (np.float32(1) / np.float32(10))


def p21_part_a(torch, np, ck, vt, ctx):
    """21a: F24-F26 on the card. bench-main's chain at P21_ROWS rows with
    a closure over the row view's astype and round(), reduced, joined
    with the K-row table and counted (all three kernels); then the ndim /
    size and the divmod closures at P21_SMALL rows, reduced by key, and
    round(x * 0.37, 1) at P21_SMALL rows, whose rows (which the rounding
    changes) must equal numpy's float32 replay bit for bit. Each closure
    must build a device _MapRDD, as the reference's vmap traces it."""
    rows = []
    table = ctx.dense_from_numpy(np.arange(P21_KEYS, dtype=np.int32),
                                 np.arange(P21_KEYS, dtype=np.float32) * 2)
    table.block()
    x = np.arange(P21_ROWS, dtype=np.int64)
    exp = np.bincount(x % P21_KEYS, weights=p21_round(np, x, 0.5),
                      minlength=P21_KEYS)
    del x
    state = {}

    def build(_):
        node = ctx.dense_range(P21_ROWS).map(
            lambda x: (x % P21_KEYS, round(x.astype(np.float32) * 0.5, 1)))
        p21_check(f"21a: the round / astype map is a device _MapRDD "
                  f"({type(node).__name__})",
                  type(node).__name__ == "_MapRDD")
        return node

    def reduce_join(node):
        reduced = node.reduce_by_key(op="add")
        state["reduced"] = reduced
        return reduced.join(table).count()

    def check(n):
        got = state.pop("reduced").collect_arrays()
        k, v = got["k"], got["v"]
        p21_check("21a: join count == K", n == P21_KEYS)
        p21_check("21a: every key once",
                  np.array_equal(np.sort(k), np.arange(P21_KEYS)))
        p21_check("21a: float32 sums of round(x * 0.5, 1) equal numpy's "
                  "(rtol 1e-5)", v.dtype == np.float32
                  and p21_close(np, v.astype(np.float64), exp[k], 1e-5))
        return f"join count {n}, {len(k)} sums equal numpy"

    r = p19_case(torch, ck, "a_round_astype_reduce_join",
                 [("map (trace)", "host", build),
                  ("reduce_by_key.join.count", "card", reduce_join)],
                 check, P21_WARM, 21)
    jl = r["step_launches"]["reduce_by_key.join.count"]
    p21_check(f"21a: the chain launched all three kernels ({jl})",
              all(jl[k] > 0 for k in ("hash_bucket", "digit_hist",
                                      "partition_pos")))
    rows.append(r)

    xs = np.arange(P21_SMALL, dtype=np.int64)
    small = {
        "a_ndim_size": (
            lambda x: (x % P21_SMALL_KEYS, x % 97 + x.ndim + x.size),
            xs % P21_SMALL_KEYS, xs % 97 + 1, P21_SMALL_KEYS),
        "a_divmod": (lambda x: divmod(x, 7), xs // 7, xs % 7,
                     -(-P21_SMALL // 7)),
    }
    for label, (f, keys, vals, n_keys) in small.items():
        exp_s = np.bincount(keys, weights=vals, minlength=n_keys)

        def build_s(_, f=f, label=label):
            node = ctx.dense_range(P21_SMALL).map(f)
            p21_check(f"21a {label}: a device _MapRDD "
                      f"({type(node).__name__})",
                      type(node).__name__ == "_MapRDD")
            return node

        def run_s(node):
            return node.reduce_by_key(op="add").collect_arrays()

        def check_s(got, exp_s=exp_s, label=label):
            k, v = got["k"], got["v"]
            p21_check(f"21a {label}: int32 sums by key equal numpy's",
                      v.dtype == np.int32 and len(k) == len(exp_s)
                      and np.array_equal(v, exp_s[k].astype(np.int64)))
            return f"{len(k)} keys, sums equal numpy"

        rows.append(p19_case(torch, ck, label,
                             [("map (trace)", "host", build_s),
                              ("reduce_by_key.collect", "card", run_s)],
                             check_s, P21_WARM, 21))

    exp_r = p21_round(np, xs, 0.37)
    p21_check("21a a_round_digits: round(., 1) changes the rows",
              not np.array_equal(exp_r, xs.astype(np.float32)
                                 * np.float32(0.37)))

    def build_r(_):
        node = ctx.dense_range(P21_SMALL).map(
            lambda x: (x, round(x.astype(np.float32) * 0.37, 1)))
        p21_check(f"21a a_round_digits: a device _MapRDD "
                  f"({type(node).__name__})",
                  type(node).__name__ == "_MapRDD")
        return node

    def check_r(got):
        k, v = got["k"], got["v"]
        p21_check("21a a_round_digits: every row once",
                  np.array_equal(np.sort(k), xs))
        p21_check("21a a_round_digits: float32 rows equal numpy's float32 "
                  "replay bit for bit", v.dtype == np.float32
                  and np.array_equal(v, exp_r[k]))
        return f"{len(k)} rounded rows equal numpy's bit for bit"

    rows.append(p19_case(torch, ck, "a_round_digits",
                         [("map (trace)", "host", build_r),
                          ("collect_arrays", "card",
                           lambda node: node.collect_arrays())],
                         check_r, P21_WARM, 21))
    return rows


def p21_data(np):
    """21b's tables: a P21_FACT-row fact (k uniform over the dimension's
    keys, x in [0, 1000), s the sku of k) and the P21_DIM-row dimension
    (k, sku-%06d, w = k % 97); the strings are Python str objects, which
    any numpy adds."""
    rng = np.random.default_rng(21)
    k = rng.integers(0, P21_DIM, P21_FACT)
    sku = np.array([f"sku-{i:06d}" for i in range(P21_DIM)], dtype=object)
    fact = dict(k=k, x=rng.integers(0, 1000, P21_FACT), s=sku[k])
    dk = np.arange(P21_DIM)
    return fact, dict(k=dk, sku=sku, w=dk % 97)


def p21_frame_cases(np, vt, fact, dim):
    """21b: (label, build(ctx), check(columns) -> note) per query; every
    query compiles on the host tier (a string concatenation, a numpy UDF,
    a None fill, a string fill over a number column, hint(tier="host"))."""
    from vega_tpu_torch.frame import F, col, lit, udf

    k, x = fact["k"], fact["x"]
    counts = np.bincount(k, minlength=P21_DIM)
    sums = np.bincount(k, weights=x, minlength=P21_DIM).astype(np.int64)
    keys = np.flatnonzero(counts)

    def by(cols, name):
        order = np.argsort(cols[name], kind="stable")
        return {nm: np.asarray(c)[order] for nm, c in cols.items()}

    def concat(ctx):
        return ctx.create_frame(fact).with_column(
            "tag", col("s") + lit("/x")).group_by("tag").agg(
                F.sum("x", "sx"), F.count("n"))

    def concat_check(cols):
        got = by(cols, "tag")
        tags = np.array([f"sku-{i:06d}/x" for i in keys])
        p21_check("21b concat: tags, sums and counts equal numpy",
                  np.array_equal(got["tag"], tags)
                  and np.array_equal(got["sx"], sums[keys])
                  and np.array_equal(got["n"], counts[keys]))
        return f"{len(tags)} tags"

    def numpy_udf(ctx):
        return ctx.create_frame(fact).with_column(
            "r", udf(lambda a: np.sqrt(np.asarray(a, dtype=np.float64)),
                     col("x"))).group_by("k").agg(F.sum("r", "sr"))

    def numpy_udf_check(cols):
        got = by(cols, "k")
        exp = np.bincount(k, weights=np.sqrt(x.astype(np.float64)),
                          minlength=P21_DIM)
        p21_check("21b numpy udf: float64 sums of sqrt(x) equal numpy's "
                  "(rtol 1e-9)", np.array_equal(got["k"], keys)
                  and p21_close(np, got["sr"], exp[keys], 1e-9))
        return f"{len(keys)} keys"

    def fill_none(ctx):
        agg = ctx.create_frame(fact).filter(col("k") % 3 != 0).group_by(
            "k").agg(F.sum("x", "sx"))
        return ctx.create_frame(dict(k=dim["k"], w=dim["w"])).join(
            agg, on="k", how="left", fill_value=None)

    def fill_none_check(cols):
        got = by(cols, "k")
        sx = got["sx"]
        third = got["k"] % 3 == 0
        present = ~third & (counts[got["k"]] > 0)
        p21_check("21b fill None: None where no fact row, numpy's sums "
                  "elsewhere", np.array_equal(got["k"], dim["k"])
                  and all(v is None for v in sx[~present])
                  and np.array_equal(sx[present].astype(np.int64),
                                     sums[got["k"][present]]))
        return f"{int((~present).sum())} rows filled None"

    def string_fill(ctx):
        agg = ctx.create_frame(fact).group_by("k").agg(F.count("n"))
        return agg.join(ctx.create_frame(dim).filter(col("k") % 2 == 0),
                        on="k", how="left", fill_value="none")

    def string_fill_check(cols):
        got = by(cols, "k")
        kk = got["k"]
        even = kk % 2 == 0
        w = got["w"]
        p21_check("21b string fill: 'none' in w and sku for odd keys, "
                  "the dimension's values for even ones",
                  np.array_equal(kk, keys)
                  and np.array_equal(got["n"], counts[kk])
                  and all(str(v) == "none" for v in w[~even])
                  and all(str(v) == "none" for v in got["sku"][~even])
                  and np.array_equal(w[even].astype(np.int64),
                                     dim["w"][kk[even]])
                  and np.array_equal(got["sku"][even], dim["sku"][kk[even]]))
        return f"{int((~even).sum())} rows filled 'none'"

    def tier_host(ctx):
        e = ctx.create_frame(dict(k=k, x=x))
        d = ctx.create_frame(dict(k=dim["k"], w=dim["w"]))
        return (e.filter(col("x") < P21_THRESHOLD)
                .group_by("k").agg(F.sum("x", "sx"))
                .join(d.group_by("k").agg(F.sum("w", "sw")), on="k")
                .sort("k").hint(tier="host"))

    def tier_host_check(cols):
        keep = x < P21_THRESHOLD
        c2 = np.bincount(k[keep], minlength=P21_DIM)
        s2 = np.bincount(k[keep], weights=x[keep],
                         minlength=P21_DIM).astype(np.int64)
        kk = np.flatnonzero(c2)
        p21_check("21b tier host: the frame query's columns equal numpy "
                  "(in key order)", np.array_equal(cols["k"], kk)
                  and np.array_equal(cols["sx"], s2[kk])
                  and np.array_equal(cols["sw"], dim["w"][kk]))
        return f"{len(kk)} keys"

    return [("b_string_concat_group_by", concat, concat_check),
            ("b_numpy_udf", numpy_udf, numpy_udf_check),
            ("b_left_join_fill_none", fill_none, fill_none_check),
            ("b_string_fill_over_numbers", string_fill, string_fill_check),
            ("b_frame_query_tier_host", tier_host, tier_host_check)]


def p21_part_b(torch, np, ck, vt, ctx):
    """21b: the frame planner's host tier on the card's machine: five
    queries over the fact and dimension, each compiled on the host tier
    (checked in explain()), its columns against numpy."""
    fact, dim = p21_data(np)
    rows = []
    for label, build, check in p21_frame_cases(np, vt, fact, dim):
        def compile_(_, build=build, label=label):
            q = build(ctx)
            text = q.explain()
            p21_check(f"21b {label}: compiled on the host tier "
                      f"({text.splitlines()[0]})",
                      text.startswith("== physical: host tier =="))
            return q

        rows.append(p19_case(torch, ck, label,
                             [("compile", "host", compile_),
                              ("collect_columns", "host",
                               lambda q: q.collect_columns())],
                             check, P21_WARM, 21))
    return rows


def p21_dense_of(vt, rdd):
    """The DenseRDD under a to_rdd() lineage."""
    while not isinstance(rdd, vt.dense_rdd.DenseRDD):
        rdd = rdd.prev
    return rdd


def p21_part_c(torch, np, ck, vt, ctx):
    """21c: to_rdd() of a P21_C_ROWS-row device group-by to P21_C_KEYS
    keys (the frame's rows in frame order as Python values), then
    .dense() lifting them back onto the card."""
    from vega_tpu_torch.frame import F

    x = np.arange(P21_C_ROWS, dtype=np.int32)
    k = x % P21_C_KEYS
    v = (x % 1000).astype(np.float32) * np.float32(0.5)
    exp = np.bincount(k, weights=v, minlength=P21_C_KEYS)
    state = {}

    def group(_):
        q = ctx.create_frame(dict(k=k, v=v)).group_by("k").agg(
            F.sum("v", "sv"))
        rdd = q.to_rdd()
        node = p21_dense_of(vt, rdd)
        p21_check("21c: the group-by is a device plan",
                  q._compiled().kind == "device")
        node.block()
        return rdd

    def lift(rdd):
        lifted = rdd.dense()
        state["lifted"] = lifted
        return lifted

    def count(lifted):
        return lifted.count()

    def check(n):
        lifted = state.pop("lifted")
        p21_check("21c: dense() lifted the rows onto the card",
                  isinstance(lifted, vt.dense_rdd.DenseRDD))
        got = lifted.collect_arrays()
        kk, sv = got["k"], got["v"]
        p21_check("21c: every key once, count == K",
                  n == P21_C_KEYS
                  and np.array_equal(np.sort(kk), np.arange(P21_C_KEYS)))
        p21_check("21c: the sums equal numpy's (rtol 1e-5)",
                  p21_close(np, sv.astype(np.float64), exp[kk], 1e-5))
        return f"{n} rows through to_rdd() and back"

    r = p19_case(torch, ck, "c_to_rdd_and_dense",
                 [("group_by (device)", "card", group),
                  ("to_rdd.dense", "host", lift),
                  ("count", "card", count)], check, P21_WARM, 21)
    gl = r["step_launches"]["group_by (device)"]
    p21_check(f"21c: the device group-by launched hash_bucket and "
              f"digit_hist ({gl})",
              gl["hash_bucket"] > 0 and gl["digit_hist"] > 0)
    return [r]


def phase_twentyone(torch, np, ck, vt):
    """Phase 21: (a) F24-F26's row view on the card at bench-main's size
    and at 2M rows, (b) the frame planner's host tier over a 400K-row fact
    frame (cut from 20M rows: the host layer's row rate) and a 100K-row
    dimension, (c) to_rdd() of a 20M-row device group-by and back. Each
    case once cold (checked against numpy,
    launches counted from 0 per step) and P21_WARM times warm: median ms,
    the card, host and lift parts apart, the step peak."""
    t0 = time.perf_counter()
    card = card_line()
    ctx = vt.Context(n_shards=N_SHARDS)
    rows = []
    parts = {}
    for part, fn in (("a", p21_part_a), ("b", p21_part_b),
                     ("c", p21_part_c)):
        t1 = time.perf_counter()
        rows += fn(torch, np, ck, vt, ctx)
        parts[part] = time.perf_counter() - t1
    ctx.stop()
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 21")
    wall_s = time.perf_counter() - t0
    log(f"phase 21 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts)


def phase21_leg():
    """--phase 21: the kernels built, then phase 21 alone. Prints one
    JSON line (each case's warm median ms and its parts, cold ms, step
    peak, launches by step; the phase's wall), writes
    chiprun_out/p21.json, and ends with the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentyone(torch, np, ck, vt)
    out = dict(phase=21, wall_s=res["wall_s"], parts_s=res["parts_s"],
               launches=res["launches"], card=card,
               cases={r["label"]: dict(note=r["note"],
                                       median_ms=r["median_ms"],
                                       parts=r["median_parts"],
                                       cold_ms=r["cold"]["ms"],
                                       peak_bytes=r["peak_bytes"],
                                       step_launches=r["step_launches"])
                      for r in res["rows"]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p21.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P22_RECORDS = 2_000_000        # 22a: a stateful generator stream
P22_RECOVER_RECORDS = 2_500_000  # 22b: the same source, extended
P22_KEYS = 1_000_000           # user ids
P22_WAIT_S = 120.0             # every offset committed within this
P22_FILES = 8                  # 22c: 8 files of 250,000 "k,v" lines (2M
P22_FILE_LINES = 250_000       # rows: the host layer's 0.3-0.4M rows/s)
P22_WARM = 1                   # cut from 3: the script's time limit
P22_TAIL_CHUNKS = 4            # 22d: a file tail appended in 4 chunks
P22_TAIL_CHUNK = 250_000
P22_SOCKET_LINES = 200_000     # 22d: lines over a localhost socket
P22_DIR = os.path.join("chiprun_out", "phase22")


def p22_check(what, ok):
    if not ok:
        fail(f"phase 22: {what}")


class P22Events:
    """A bus listener: the stream's batch walls, commits (their times)
    and receiver starts."""

    def __init__(self, vt_events):
        self.ev = vt_events
        self.walls = []
        self.commit_times = []
        self.starts = []

    def on_event(self, e):
        if isinstance(e, self.ev.BatchCompleted) and e.succeeded:
            self.walls.append(e.wall_s)
        elif isinstance(e, self.ev.StateCheckpointed) and not e.duplicate:
            self.commit_times.append(e.time)
        elif isinstance(e, self.ev.ReceiverStarted):
            self.starts.append((e.kind, e.attempt, e.from_offset))


def p22_event(i):
    """Offset i's record of the event counter: (user id, value)."""
    return (i * 2654435761 % 2**32 % P22_KEYS, i % 1000 - 500)


class P22Source:
    """The generator source: offsets below n, then dry (picklable)."""

    def __init__(self, n):
        self.n = n

    def __call__(self, i):
        return p22_event(i) if i < self.n else None


def p22_sums(np, keys, vals):
    """numpy's exact int64 sums by key: {key: sum}."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, vals)
    return dict(zip(uniq.tolist(), sums.tolist()))


def p22_expected(np, n):
    i = np.arange(n, dtype=np.int64)
    return p22_sums(np, i * 2654435761 % 2**32 % P22_KEYS, i % 1000 - 500)


class P22Fold:
    """state_fold.fold_pairs_device wrapped while installed: its calls,
    its None returns, the pairs it was given, and each call's host build
    (to the Context's dense_from_numpy) apart from the card part (the
    rest: reduce, collect, Python scalars), as 11c times them."""

    def __init__(self, torch, state_fold):
        self.torch = torch
        self.mod = state_fold
        self.real = state_fold.fold_pairs_device
        self.calls = []

    def __enter__(self):
        torch = self.torch

        def wrapped(ctx, pairs, op):
            marks = {}
            built = ctx.dense_from_numpy

            def marked(*cols, **kw):
                marks["built"] = time.perf_counter()
                return built(*cols, **kw)
            ctx.dense_from_numpy = marked
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = self.real(ctx, pairs, op)
                torch.cuda.synchronize()
            finally:
                del ctx.dense_from_numpy
            t1 = time.perf_counter()
            b = marks.get("built", t1)
            self.calls.append(dict(pairs=len(pairs), none=out is None,
                                   keys=None if out is None else len(out),
                                   host_build_ms=(b - t0) * 1e3,
                                   card_ms=(t1 - b) * 1e3))
            return out
        self.mod.fold_pairs_device = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.fold_pairs_device = self.real
        return False


def p22_stream_state(torch, np, ck, vt, ctx, n, ckpt, state_fold, label):
    """One stateful generator stream to its end: started, waited for
    until offset n is committed (within P22_WAIT_S), stopped. Launches
    counted from 0 at start(), the device peak from there."""
    from vega_tpu_torch.scheduler import events as vt_events

    seen = P22Events(vt_events)
    ctx.bus.add_listener(seen)
    stream = ctx.stream_from_generator(P22Source(n), checkpoint_dir=ckpt)
    handle = stream.update_state_by_key(op="add")
    sctx = ctx.streaming()
    with P22Fold(torch, state_fold) as fold:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launches()
        t0 = time.time()
        sctx.start()
        deadline = time.monotonic() + P22_WAIT_S
        while True:
            rec = handle.store.log.latest()
            if rec is not None and rec["offsets"].get("0") == n:
                break
            p22_check(f"{label}: the stream failed: {sctx.failed}",
                      sctx.failed is None)
            p22_check(f"{label}: offset {n} not committed within "
                      f"{P22_WAIT_S} s (status {sctx.status()})",
                      time.monotonic() < deadline)
            time.sleep(0.05)
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        status = sctx.status()
        sctx.stop()
    wall_s = seen.commit_times[-1] - t0
    return dict(handle=handle, fold=fold.calls, events=seen, status=status,
                launches=launches, peak_bytes=peak, wall_s=wall_s)


def p22_state_checks(np, label, handle, want, fold_calls, commits):
    got = handle.snapshot()
    p22_check(f"{label}: the state differs from numpy's exact sums",
              got == want)
    p22_check(f"{label}: a key or value is not a Python int",
              all(type(k) is int and type(x) is int
                  for k, x in got.items()))
    p22_check(f"{label}: a fold returned None (a host fold)",
              not any(c["none"] for c in fold_calls))
    p22_check(f"{label}: {len(fold_calls)} folds on the card for "
              f"{commits} commits", len(fold_calls) >= commits >= 1)
    p22_check(f"{label}: duplicate commits",
              handle.store.duplicate_commits == 0)


def p22_stream_row(label, n_records, run, ctx):
    """The printed figures of one stateful stream run."""
    ev = run["events"]
    calls = run["fold"]
    lat = ctx.metrics.pool_latency().get("streaming", {})
    ctl = run["status"]["controller"]
    return dict(
        label=label, records=n_records, wall_s=run["wall_s"],
        records_per_s=n_records / run["wall_s"],
        batches=run["handle"].store.commits,
        batch_wall_median_s=statistics.median(ev.walls),
        batch_wall_max_s=max(ev.walls), pool_latency=lat,
        folds=len(calls),
        fold_pairs=[c["pairs"] for c in calls],
        fold_host_build_ms=[round(c["host_build_ms"], 3) for c in calls],
        fold_card_ms=[round(c["card_ms"], 3) for c in calls],
        max_depth_seen=ctl["max_depth_seen"],
        throttled_offers=ctl["throttled_offers"],
        peak_bytes=run["peak_bytes"], launches=run["launches"],
        receiver_starts=ev.starts)


def p22_part_ab(torch, np, ck, vt):
    """22a: the generator stream of P22_RECORDS events into
    update_state_by_key(op="add") at the reference's defaults; 22b: a
    second Context on the same checkpoint directory with the source
    extended to P22_RECOVER_RECORDS, resumed at the committed offset."""
    from vega_tpu_torch import state_fold

    ckpt = os.path.join(P22_DIR, "ckpt")
    ctx = vt.Context(n_shards=N_SHARDS)
    try:
        run = p22_stream_state(torch, np, ck, vt, ctx, P22_RECORDS, ckpt,
                               state_fold, "22a")
        want = p22_expected(np, P22_RECORDS)
        h = run["handle"]
        p22_state_checks(np, "22a", h, want, run["fold"], h.store.commits)
        fired = [k for k, c in run["launches"].items() if c]
        p22_check("22a: the fold launched no kernel", fired)
        a = p22_stream_row("22a", P22_RECORDS, run, ctx)
        a["kernels_fired"] = fired
        a["keys"] = len(want)
    finally:
        ctx.stop()
    log(f"22 {json.dumps({k: v for k, v in a.items() if 'fold_' not in k})}")
    ctx = vt.Context(n_shards=N_SHARDS)
    try:
        run = p22_stream_state(torch, np, ck, vt, ctx, P22_RECOVER_RECORDS,
                               ckpt, state_fold, "22b")
        h = run["handle"]
        starts = run["events"].starts
        p22_check(f"22b: resumed at {starts}, not {P22_RECORDS}",
                  starts == [("generator", 0, P22_RECORDS)])
        want = p22_expected(np, P22_RECOVER_RECORDS)
        p22_state_checks(np, "22b", h, want, run["fold"], h.store.commits)
        folded = sum(c["pairs"] for c in run["fold"])
        p22_check(f"22b: {folded} pairs folded, not the "
                  f"{P22_RECOVER_RECORDS - P22_RECORDS} new ones",
                  folded == P22_RECOVER_RECORDS - P22_RECORDS)
        b = p22_stream_row("22b", P22_RECOVER_RECORDS - P22_RECORDS, run,
                           ctx)
        b["resumed_at"] = starts[0][2]
        b["duplicate_commits"] = h.store.duplicate_commits
        b["keys"] = len(want)
        c = p22_part_c(torch, np, ck, vt, ctx)
    finally:
        ctx.stop()
    log(f"22 {json.dumps({k: v for k, v in b.items() if 'fold_' not in k})}")
    return a, b, c


def p22_parse(line):
    k, x = line.split(",")
    return (int(k), int(x))


def p22_write_lines(np, path, keys, vals, mode="w"):
    with open(path, mode) as fh:
        fh.write("".join(f"{k},{x}\n" for k, x in zip(keys.tolist(),
                                                     vals.tolist())))


def p22_part_c(torch, np, ck, vt, ctx):
    """22c: P22_FILES files of P22_FILE_LINES "k,v" lines through
    text_file(dir).map(parse).dense().reduce_by_key(op="add") joined with
    the P22_KEYS-row table and counted; whole_text_files(dir)."""
    from vega_tpu_torch.io import readers

    d = os.path.join(P22_DIR, "files")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(22)
    keys = rng.randint(0, P22_KEYS, P22_FILES * P22_FILE_LINES)
    vals = rng.randint(-1000, 1000, P22_FILES * P22_FILE_LINES)
    paths = []
    for f in range(P22_FILES):
        sl = slice(f * P22_FILE_LINES, (f + 1) * P22_FILE_LINES)
        paths.append(os.path.join(d, f"part-{f:05d}.txt"))
        p22_write_lines(np, paths[-1], keys[sl], vals[sl])
    src = ctx.text_file(d)
    groups = [s.payload for s in src.splits()]
    p22_check(f"22c: {src.num_partitions} partitions, not {P22_FILES}",
              src.num_partitions == P22_FILES)
    p22_check("22c: the file groups are not assign_files_to_partitions'",
              groups == readers.assign_files_to_partitions(
                  readers._discover(d), P22_FILES)
              and sorted(g[0] for g in groups) == sorted(paths))
    want = p22_sums(np, keys, vals)
    table = ctx.dense_from_numpy(np.arange(P22_KEYS, dtype=np.int32),
                                 np.arange(P22_KEYS, dtype=np.float32))

    def reduced(lifted):
        return lifted.reduce_by_key(op="add")

    # the sums first, once: the reduce's rows equal numpy's exactly
    red = reduced(ctx.text_file(d).map(p22_parse).dense())
    got = dict(red.collect())
    p22_check("22c: the reduce differs from numpy", got == want)
    del red, got

    def check(count):
        p22_check(f"22c: count {count}, numpy {len(want)}",
                  count == len(want))
        return f"count {count} equal to numpy"

    steps = [("read_parse_lift", "host",
              lambda _: ctx.text_file(d).map(p22_parse).dense()),
             ("reduce_join_count", "card",
              lambda lifted: reduced(lifted).join(table).count())]
    row = p19_case(torch, ck, "22c text_file reduce join", steps, check,
                   warm=P22_WARM, phase=22)
    check_launched(row["launches"], "22c")
    whole = ctx.whole_text_files(d).collect()
    p22_check("22c: whole_text_files differs from the files",
              len(whole) == P22_FILES and all(
                  open(p, "rb").read() == data for p, data in whole)
              and sorted(p for p, _ in whole) == sorted(paths))
    row["whole_text_files"] = len(whole)
    return row


class P22LineServer:
    """A localhost server that sends lines to the first connection, then
    holds it open until closed."""

    def __init__(self, lines):
        import socket
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.data = "".join(f"{x}\n" for x in lines).encode()
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        with conn:
            conn.sendall(self.data)
            self.done.wait(120)

    def close(self):
        self.done.set()
        self.thread.join(10)
        self.sock.close()


def p22_part_d(torch, np, ck, vt):
    """22d: a file tail appended with P22_TAIL_CHUNKS chunks while it runs,
    folded by key on the card; a localhost socket's lines collected in
    foreach_rdd."""
    import threading

    from vega_tpu_torch import state_fold

    tail = os.path.join(P22_DIR, "tail.log")
    open(tail, "w").close()
    rng = np.random.RandomState(23)
    n_tail = P22_TAIL_CHUNKS * P22_TAIL_CHUNK
    keys = rng.randint(0, P22_KEYS, n_tail)
    vals = rng.randint(-1000, 1000, n_tail)
    server = P22LineServer(range(P22_SOCKET_LINES))
    got_lines = []
    ctx = vt.Context(n_shards=N_SHARDS)
    try:
        ck.reset_launches()
        handle = ctx.stream_from_file_tail(
            tail, checkpoint_dir=os.path.join(P22_DIR, "ckpt_tail")).map(
                p22_parse).update_state_by_key(op="add")
        ctx.stream_from_socket("127.0.0.1", server.port).foreach_rdd(
            lambda rdd, bid: got_lines.extend(rdd.collect()))
        sctx = ctx.streaming()

        def append():
            for c in range(P22_TAIL_CHUNKS):
                sl = slice(c * P22_TAIL_CHUNK, (c + 1) * P22_TAIL_CHUNK)
                p22_write_lines(np, tail, keys[sl], vals[sl], mode="a")
                time.sleep(0.2)

        with P22Fold(torch, state_fold) as fold:
            t0 = time.monotonic()
            sctx.start()
            writer = threading.Thread(target=append)
            writer.start()
            size = None
            tail_s = sock_s = None
            deadline = time.monotonic() + P22_WAIT_S
            while tail_s is None or sock_s is None:
                p22_check(f"22d: the stream failed: {sctx.failed}",
                          sctx.failed is None)
                p22_check(f"22d: not done within {P22_WAIT_S} s "
                          f"({len(got_lines)} lines, status "
                          f"{sctx.status()})", time.monotonic() < deadline)
                if size is None and not writer.is_alive():
                    size = os.path.getsize(tail)
                rec = handle.store.log.latest()
                if tail_s is None and size is not None and rec is not None \
                        and rec["offsets"].get("0") == size:
                    tail_s = time.monotonic() - t0
                if sock_s is None and len(got_lines) >= P22_SOCKET_LINES:
                    sock_s = time.monotonic() - t0
                time.sleep(0.05)
            writer.join()
            sctx.stop()
        launches = dict(ck.LAUNCHES)
        want = p22_sums(np, keys, vals)
        p22_check("22d: the file tail's state differs from numpy",
                  handle.snapshot() == want)
        p22_check("22d: a file tail fold returned None",
                  fold.calls and not any(c["none"] for c in fold.calls))
        p22_check("22d: the socket's lines are not each once in order",
                  got_lines == [str(i) for i in range(P22_SOCKET_LINES)])
        return dict(tail_records=n_tail, tail_s=tail_s,
                    tail_records_per_s=n_tail / tail_s,
                    tail_batches=handle.store.commits,
                    tail_folds=len(fold.calls),
                    socket_lines=P22_SOCKET_LINES, socket_s=sock_s,
                    socket_records_per_s=P22_SOCKET_LINES / sock_s,
                    launches=launches)
    finally:
        ctx.stop()
        server.close()


def phase_twentytwo(torch, np, ck, vt):
    """Phase 22: the streaming plane and the file sources on the card. (a)
    a Spark Streaming event counter over P22_KEYS user ids at the
    reference's defaults (0.5 s interval, 10,000-record blocks, a 64-block
    queue, block backpressure): P22_RECORDS generator events folded by key
    on the card through update_state_by_key(op="add"), equal to numpy's
    exact sums; (b) its recovery in a second Context, extended to
    P22_RECOVER_RECORDS, resumed at the committed offset, no record
    folded twice; (c) text_file over P22_FILES files lifted, reduced,
    joined and counted (all three kernels), cold and P22_WARM warm, and
    whole_text_files; (d) a file tail and a localhost socket."""
    t0 = time.perf_counter()
    card = card_line()
    shutil.rmtree(P22_DIR, ignore_errors=True)
    os.makedirs(P22_DIR)
    parts = {}
    try:
        t1 = time.perf_counter()
        a, b, c = p22_part_ab(torch, np, ck, vt)
        parts["abc"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        d = p22_part_d(torch, np, ck, vt)
        parts["d"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(P22_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {name: a["launches"][name] + b["launches"][name]
                + c["launches"][name] + d["launches"][name]
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 22")
    wall_s = time.perf_counter() - t0
    log(f"phase 22 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(a=a, b=b, c=c, d=d, launches=launches, card=card,
                wall_s=wall_s, parts_s=parts)


def p22_lines(r, card):
    """The printed lines of phase 22."""
    out = []
    for x in (r["a"], r["b"]):
        out.append(
            f"phase {x['label']} ({x['records']} records, {x['keys']} keys"
            f"{', resumed at ' + str(x['resumed_at']) if 'resumed_at' in x else ''}"
            f"): {x['records_per_s']:.1f} records/s from start() to the "
            f"last commit ({x['wall_s']:.3f} s), {x['batches']} batches, "
            f"batch wall median {x['batch_wall_median_s']:.3f} s max "
            f"{x['batch_wall_max_s']:.3f} s, pool latency "
            f"{json.dumps(x['pool_latency'])}, folds on the card "
            f"{x['folds']} (pairs {json.dumps(x['fold_pairs'])}, host build "
            f"ms {json.dumps(x['fold_host_build_ms'])}, card ms "
            f"{json.dumps(x['fold_card_ms'])}), max depth "
            f"{x['max_depth_seen']}, throttled offers "
            f"{x['throttled_offers']}, peak {x['peak_bytes']} B, launches "
            f"{json.dumps(x['launches'])}, equal to numpy on {card}")
    x = r["c"]
    out.append(
        f"phase 22c ({x['note']}; {P22_FILES} files of {P22_FILE_LINES} "
        f"lines): {x['median_ms']:.3f} ms warm median of {len(x['warm'])}, "
        f"parts {json.dumps(x['median_parts'])}, cold "
        f"{x['cold']['ms']:.3f} ms (parts {json.dumps(x['cold']['parts'])})"
        f", step peak {x['peak_bytes']} B, launches by step "
        f"{json.dumps(x['step_launches'])}, whole_text_files "
        f"{x['whole_text_files']} files equal on {card}")
    x = r["d"]
    out.append(
        f"phase 22d file tail: {x['tail_records_per_s']:.1f} records/s "
        f"({x['tail_records']} lines in {x['tail_s']:.3f} s, "
        f"{x['tail_batches']} batches, {x['tail_folds']} folds on the "
        f"card, equal to numpy); socket: {x['socket_records_per_s']:.1f} "
        f"records/s ({x['socket_lines']} lines in {x['socket_s']:.3f} s, "
        f"each once in order); launches {json.dumps(x['launches'])} on "
        f"{card}")
    out.append(f"phase 22 launches {json.dumps(r['launches'])}; parts (s) "
               f"{json.dumps(r['parts_s'])}; phase 22 {r['wall_s']:.1f} s "
               f"on {card}")
    return out


def phase22_leg():
    """--phase 22: the kernels built, then phase 22 alone. Prints its
    lines and one JSON line, writes chiprun_out/p22.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentytwo(torch, np, ck, vt)
    out = p22_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p22.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p22_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


def p22_summary(res):
    """Phase 22's figures as JSON (22c without its per-run records)."""
    c = res["c"]
    return dict(phase=22, wall_s=res["wall_s"], parts_s=res["parts_s"],
                launches=res["launches"], card=res["card"], a=res["a"],
                b=res["b"], d=res["d"],
                c=dict(note=c["note"], median_ms=c["median_ms"],
                       parts=c["median_parts"], cold_ms=c["cold"]["ms"],
                       cold_parts=c["cold"]["parts"],
                       warm_ms=[w["ms"] for w in c["warm"]],
                       peak_bytes=c["peak_bytes"],
                       step_launches=c["step_launches"],
                       whole_text_files=c["whole_text_files"]))


P23_ROWS = 2_000_000           # 23a: bench-main's lineage cut to 2M rows
                               # (phase 20a's cut: the host layer's rate)
P23_KEYS = N_KEYS              # the card's reduce: 1M keys
P23_HOST_KEYS = 1_000          # the host shuffles' keys, the table's rows
P23_WORKERS = (1, 8)           # 23a: num_workers, one Context each
P23_SPILL_BUDGET = 16 << 20    # 23d: shuffle_memory_budget
P23_SMALL = 200_000            # 23e-f: the host jobs' rows
P23_WARM = 1


def p23_check(what, ok):
    if not ok:
        fail(f"phase 23: {what}")


class _P23Events:
    """A bus listener keeping the scheduler's events of one Context."""

    def __init__(self):
        self.events = []

    def on_event(self, event):
        self.events.append(event)

    def stage_walls(self, start, end):
        """[(stage_id, kind, tasks, wall s)] of the stages submitted in
        events[start:end]: a map stage's wall to its StageCompleted, the
        result stage's to its job's end."""
        from vega_tpu_torch.scheduler import events as ev

        window = self.events[start:end]
        done = {e.stage_id: e.time for e in window
                if isinstance(e, ev.StageCompleted)}
        job_end = {e.job_id: e.time for e in window
                   if isinstance(e, ev.JobEnd)}
        out = []
        for e in window:
            if isinstance(e, ev.StageSubmitted):
                t_end = done.get(e.stage_id, job_end.get(e.job_id, e.time))
                out.append((e.stage_id,
                            "map" if e.is_shuffle_map else "result",
                            e.num_tasks, round(t_end - e.time, 6)))
        return out


def p23_expected(np):
    """numpy's replay of 23a: the sum of x * 0.5 over x = k (mod 1,000)
    in [0, P23_ROWS), float64 (P23_KEYS is a multiple of 1,000)."""
    x = np.arange(P23_ROWS, dtype=np.int64)
    return np.bincount(x % P23_HOST_KEYS, weights=x * 0.5,
                       minlength=P23_HOST_KEYS)


def p23_host_part(node):
    """The two host shuffles of 23a over a node's rows: 8 partitions by
    key % 1,000, then 4."""
    return (node.map(lambda kv: (kv[0] % P23_HOST_KEYS, kv[1]))
            .reduce_by_key(operator.add, 8)
            .map(lambda kv: (kv[0] % P23_HOST_KEYS, kv[1]))
            .reduce_by_key(operator.add, 4))


def p23_part_a(torch, np, ck, vt, ctx, workers, exp):
    """23a: bench-main's lineage at P23_ROWS rows: reduce_by_key on the
    card, to_rdd(), two host shuffles through the scheduler, dense()
    and a join with the 1,000-row table on the card, counted."""
    table = ctx.dense_from_numpy(
        np.arange(P23_HOST_KEYS, dtype=np.int32),
        np.arange(P23_HOST_KEYS, dtype=np.float32) * 2)
    table.block()
    rec = _P23Events()
    ctx.bus.add_listener(rec)
    state = {}

    def card(_):
        node = ctx.dense_range(P23_ROWS).map(
            lambda x: (x % P23_KEYS, x * 0.5)).reduce_by_key(op="add")
        node.block()
        return node

    def host(node):
        ctx.bus.flush()
        start = len(rec.events)
        lifted = p23_host_part(node.to_rdd()).dense()
        ctx.bus.flush()
        state["stages"] = rec.stage_walls(start, len(rec.events))
        state["lifted"] = lifted
        return lifted

    def join(lifted):
        return lifted.join(table).count()

    def check(n):
        got = state["lifted"].collect_arrays()
        k, v = got["k"], got["v"]
        p23_check("23a: every key once",
                  np.array_equal(np.sort(k), np.arange(P23_HOST_KEYS)))
        p23_check("23a: the sums equal numpy's (rtol 1e-5)",
                  np.allclose(v, exp[k], rtol=1e-5, atol=0.0))
        p23_check("23a: join count == 1,000", n == P23_HOST_KEYS)
        stages = state["stages"]
        p23_check(f"23a: the host job ran at least 3 stages ({stages})",
                  len(stages) >= 3)
        return (f"num_workers={workers}, {len(stages)} host stages, join "
                f"count {n}")

    r = p19_case(torch, ck, f"a_workers{workers}",
                 [("reduce_by_key", "card", card),
                  ("to_rdd.shuffles.dense", "host", host),
                  ("join.count", "card", join)], check, P23_WARM, 23)
    r["stages"] = state["stages"]
    r["tasks"] = sum(s[2] for s in state["stages"])
    launched = {k: sum(r["step_launches"][st][k]
                       for st in ("reduce_by_key", "join.count"))
                for k in ck.LAUNCHES}
    p23_check(f"23a: the card's steps launched all three kernels "
              f"({launched})", all(launched[k] > 0 for k in
                                   ("hash_bucket", "digit_hist",
                                    "partition_pos")))
    return r


def p23_part_b(vt, ctx):
    """23b: a partition that fails twice succeeds on its third attempt;
    a closure that always fails aborts its job with TaskError."""
    from vega_tpu_torch.errors import TaskError

    attempts = {}

    def flaky(idx, it):
        attempts[idx] = attempts.get(idx, 0) + 1
        if idx == 1 and attempts[idx] < 3:
            raise RuntimeError("transient")
        return it

    before = ctx.metrics_summary()["task_failures"]
    total = sum(ctx.parallelize(range(P23_SMALL), 4)
                .map_partitions_with_index(flaky).collect())
    failures = ctx.metrics_summary()["task_failures"] - before
    p23_check("23b: the retried job's rows", total == sum(range(P23_SMALL)))
    p23_check(f"23b: partition 1 ran 3 times ({attempts})",
              attempts[1] == 3 and failures == 2)
    try:
        ctx.parallelize(range(100), 2).map(lambda x: 1 // 0).collect()
    except TaskError as e:
        cause = type(e.__cause__).__name__
    else:
        cause = None
    p23_check(f"23b: TaskError from ZeroDivisionError ({cause})",
              cause == "ZeroDivisionError")
    return dict(attempts=attempts[1], task_failures=failures,
                aborted_by=f"TaskError from {cause}")


def p23_part_c(np, ctx, exp):
    """23c: one bucket of the second host shuffle dropped from the store
    between two collects: the fetch fails, the map output is
    unregistered and its stage resubmitted, and the rows are equal."""
    node = p23_host_part(ctx.dense_range(P23_ROWS).map(
        lambda x: (x % P23_KEYS, x * 0.5)).reduce_by_key(op="add").to_rdd())
    first = sorted(node.collect())
    before = ctx.metrics_summary()["stages_resubmitted"]
    dropped = ctx.env.shuffle_store._mem.pop((node.shuffle_id, 0, 1), None)
    p23_check("23c: the bucket was in the store", dropped is not None)
    t0 = time.perf_counter()
    second = sorted(node.collect())
    ms = (time.perf_counter() - t0) * 1e3
    resubmitted = ctx.metrics_summary()["stages_resubmitted"] - before
    p23_check("23c: equal rows after the resubmission", first == second)
    p23_check(f"23c: StageResubmitted posted ({resubmitted})",
              resubmitted >= 1)
    k = np.array([kv[0] for kv in second])
    v = np.array([kv[1] for kv in second])
    p23_check("23c: the sums equal numpy's",
              np.allclose(v, exp[k], rtol=1e-5, atol=0.0))
    return dict(stages_resubmitted=resubmitted, recovery_ms=ms)


def p23_part_d(np, vt, exp):
    """23d: the card's reduce moved to the host (to_rdd() of the 2M
    mapped rows, a host reduce_by_key over their 1M keys: no map-side
    combine, about 34 MB of buckets), then 23a's two host shuffles, under
    shuffle_memory_budget = 16 MB: the oldest buckets spill to disk and
    read back, rows equal."""
    with vt.Context(n_shards=N_SHARDS, num_workers=8,
                    shuffle_memory_budget=P23_SPILL_BUDGET) as ctx:
        t0 = time.perf_counter()
        rows = p23_host_part(ctx.dense_range(P23_ROWS).map(
            lambda x: (x % P23_KEYS, x * 0.5)).to_rdd().reduce_by_key(
                operator.add, 8)).collect()
        ms = (time.perf_counter() - t0) * 1e3
        st = ctx.storage_status()["shuffle"]
        summary = ctx.metrics_summary()
    k = np.array([kv[0] for kv in rows])
    v = np.array([kv[1] for kv in rows])
    p23_check("23d: every key once",
              np.array_equal(np.sort(k), np.arange(P23_HOST_KEYS)))
    p23_check("23d: the sums equal numpy's",
              np.allclose(v, exp[k], rtol=1e-5, atol=0.0))
    p23_check(f"23d: buckets spilled ({st['spill_count']})",
              st["spill_count"] > 0)
    return dict(ms=ms, spill_count=st["spill_count"],
                spilled_bytes=st["spilled_bytes"],
                disk_entries=st["disk_entries"],
                fetch=summary["fetch"])


def p23_part_e(ctx):
    """23e: a shuffle's map stage reused by a second job; a persisted
    node computed once and served from the cache through the tracker;
    count_approx with one slow partition: a partial value at the
    deadline, then the final count."""
    import threading

    shuffled = ctx.parallelize(range(P23_SMALL), 8).map(
        lambda x: (x % 1000, x)).reduce_by_key(operator.add, 8)
    first = sorted(shuffled.collect())
    s0 = ctx.metrics_summary()
    second = sorted(shuffled.collect())
    s1 = ctx.metrics_summary()
    reuse = dict(stages=s1["stages"] - s0["stages"],
                 tasks=s1["tasks"] - s0["tasks"])
    p23_check(f"23e: the second job ran its result stage alone ({reuse})",
              first == second and reuse == dict(stages=1, tasks=8))
    seen = []
    cached = ctx.parallelize(range(P23_SMALL), 8).map(
        lambda x: (seen.append(1), x * 2)[1]).persist()
    counts = (cached.count(), cached.count())
    locs = ctx.env.cache_tracker.get_location_snapshot().get(
        cached.rdd_id, {})
    p23_check(f"23e: computed once, 8 partitions tracked ({len(seen)}, "
              f"{len(locs)})", counts == (P23_SMALL, P23_SMALL)
              and len(seen) == P23_SMALL and len(locs) == 8)
    gate = threading.Event()

    def slow(idx, it):
        if idx == 7:
            gate.wait(10.0)
        return it

    res = ctx.parallelize(range(P23_SMALL), 8).map_partitions_with_index(
        slow).count_approx(timeout_s=0.5, confidence=0.95)
    partial = res.initial_value
    p23_check("23e: a partial value at the deadline",
              not res.is_initial_value_final
              and partial.low <= partial.mean <= partial.high)
    gate.set()
    final = res.get_final_value(timeout=30.0)
    p23_check("23e: the final count", final.mean == P23_SMALL)
    cache = ctx.storage_status()["cache"]
    return dict(reuse=reuse, persisted_computed=len(seen),
                tracked_partitions=len(locs), cache_mem_bytes=cache[
                    "mem_bytes"],
                approx_partial=[partial.mean, partial.low, partial.high],
                approx_final=final.mean)


def p23_part_f(vt):
    """23f: two pools of weights 4 and 1 under scheduler_mode "fair" on
    two task threads, four jobs each submitted together; each pool's job
    walls (pool_latency)."""
    with vt.Context(n_shards=N_SHARDS, num_workers=2,
                    scheduler_mode="fair") as ctx:
        ctx.set_pool("heavy", weight=4)
        ctx.set_pool("light", weight=1)
        want = None
        futures = []
        for i in range(4):
            for pool in ("light", "heavy"):
                node = ctx.parallelize(range(P23_SMALL), 8).map(
                    lambda x: (x % 100, x)).reduce_by_key(operator.add, 4)
                futures.append(ctx.submit_job(
                    node, lambda _tc, it: sorted(it), pool=pool,
                    transform=lambda parts: sorted(
                        r for p in parts for r in p)))
        for f in futures:
            got = f.result(120)
            want = got if want is None else want
            p23_check("23f: every job's rows equal", got == want)
        latency = ctx.metrics_summary()["pool_latency"]
    p23_check(f"23f: both pools' walls ({latency})",
              set(latency) >= {"heavy", "light"})
    return dict(pool_latency={p: latency[p] for p in ("heavy", "light")})


def phase_twentythree(torch, np, ck, vt):
    """Phase 23: the local runtime (the DAG scheduler, the thread-pool
    backend, the shuffle store and fetcher, the cache and its tracker,
    the job server) on the card: (a) bench-main's lineage at P23_ROWS
    rows, reduced on the card, two host shuffles through the scheduler,
    lifted and joined on the card, at num_workers 1 and 8; (b) retry,
    then TaskError; (c) a fetch failure and its resubmission; (d) the
    shuffle store spilling past a 16 MB budget; (e) map-stage reuse, a
    persisted node through the tracker, count_approx partial then final;
    (f) two pools of weights 4 and 1."""
    t0 = time.perf_counter()
    card = card_line()
    exp = p23_expected(np)
    rows = []
    parts = {}
    out = {}
    for workers in P23_WORKERS:
        t1 = time.perf_counter()
        ctx = vt.Context(n_shards=N_SHARDS, num_workers=workers)
        rows.append(p23_part_a(torch, np, ck, vt, ctx, workers, exp))
        if workers == P23_WORKERS[-1]:
            parts["a"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            out["b"] = p23_part_b(vt, ctx)
            out["c"] = p23_part_c(np, ctx, exp)
            out["e"] = p23_part_e(ctx)
            parts["bce"] = time.perf_counter() - t1
            out["summary"] = {k: v for k, v in ctx.metrics_summary().items()
                              if k in ("jobs", "stages", "tasks",
                                       "task_failures", "stages_resubmitted",
                                       "spills", "fetch")}
        ctx.stop()
    t1 = time.perf_counter()
    out["d"] = p23_part_d(np, vt, exp)
    out["f"] = p23_part_f(vt)
    parts["df"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 23")
    wall_s = time.perf_counter() - t0
    log(f"phase 23 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts, **out)


def p23_lines(r, card):
    """The printed lines of phase 23."""
    out = []
    for x in r["rows"]:
        out.append(
            f"phase 23{x['label']} ({x['note']}; {P23_ROWS} rows): "
            f"{x['median_ms']:.3f} ms warm median of {len(x['warm'])}, "
            f"parts {json.dumps(x['median_parts'])}, cold "
            f"{x['cold']['ms']:.3f} ms, {len(x['stages'])} host stages, "
            f"{x['tasks']} tasks, stage walls (id, kind, tasks, s) "
            f"{json.dumps(x['stages'])}, launches by step "
            f"{json.dumps(x['step_launches'])} on {card}")
    out.append(f"phase 23b: {json.dumps(r['b'])} on {card}")
    out.append(f"phase 23c: {json.dumps(r['c'])} on {card}")
    out.append(f"phase 23d (shuffle_memory_budget {P23_SPILL_BUDGET} B): "
               f"{json.dumps(r['d'])} on {card}")
    out.append(f"phase 23e: {json.dumps(r['e'])} on {card}")
    out.append(f"phase 23f (weights 4 / 1, fair): {json.dumps(r['f'])} on "
               f"{card}")
    out.append(f"phase 23 runtime summary {json.dumps(r['summary'])}; "
               f"launches {json.dumps(r['launches'])}; parts (s) "
               f"{json.dumps(r['parts_s'])}; phase 23 {r['wall_s']:.1f} s "
               f"on {card}")
    return out


def p23_summary(res):
    """Phase 23's figures as JSON (23a without its per-run records)."""
    return dict(phase=23, wall_s=res["wall_s"], parts_s=res["parts_s"],
                launches=res["launches"], card=res["card"],
                a={x["label"]: dict(note=x["note"], median_ms=x["median_ms"],
                                    parts=x["median_parts"],
                                    cold_ms=x["cold"]["ms"],
                                    stages=x["stages"], tasks=x["tasks"],
                                    peak_bytes=x["peak_bytes"],
                                    step_launches=x["step_launches"])
                   for x in res["rows"]},
                **{k: res[k] for k in ("b", "c", "d", "e", "f", "summary")})


def phase23_leg():
    """--phase 23: the kernels built, then phase 23 alone. Prints its
    lines and one JSON line, writes chiprun_out/p23.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentythree(torch, np, ck, vt)
    out = p23_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p23.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p23_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P24_ROWS = N_ROWS              # 24a: bench-main's lineage at full width
P24_KEYS = N_KEYS              # the card's reduce: 1M keys
P24_EXECUTORS = (1, 4)         # 24a: num_executors, one Context each
P24_LOCAL_WORKERS = 8          # 24a beside it: the local runtime (23a's)
P24_SMALL = 200_000            # 24b-e: the host jobs' rows
P24_WARM = 3
# 24's fleets: a lost executor is declared within a second
P24_FLEET = dict(executor_reap_interval_s=0.5, executor_restart_backoff_s=0.5,
                 resubmit_timeout_s=0.5, fetch_retries=2,
                 fetch_retry_interval_s=0.05)


def p24_check(what, ok):
    if not ok:
        fail(f"phase 24: {what}")


def p24_expected(np):
    """numpy's replay of 24a: the sum of x * 0.5 over x = k (mod 1,000)
    in [0, P24_ROWS), float64."""
    x = np.arange(P24_ROWS, dtype=np.int64)
    return np.bincount(x % P23_HOST_KEYS, weights=x * 0.5,
                       minlength=P23_HOST_KEYS)


def p24_fleet_counters(ctx):
    """The driver's dispatch counters and the executors' fetch counters
    (summed over the fleet)."""
    dispatch = ctx.metrics_summary()["dispatch"]
    fetch = {"round_trips": 0, "bytes": 0, "buckets": 0, "streams": 0}
    backend = getattr(ctx, "_backend", None)
    stats = backend.worker_stats() if hasattr(backend, "worker_stats") \
        else {}
    for s in stats.values():
        for k in fetch:
            fetch[k] += s["fetch"][k]
    return dict(dispatch), fetch


def p24_part_a(torch, np, ck, vt, ctx, label, exp, warm=P24_WARM,
               rows_out=None):
    """24a on one Context: the 20M-row reduce on the card, to_rdd(), two
    host shuffles (on the executors under mode="distributed"), dense()
    and the join with the 1,000-row table on the card, counted; cold,
    then P24_WARM warm runs. rows_out, when given, gets the cold run's
    lifted columns k and v as collected."""
    table = ctx.dense_from_numpy(
        np.arange(P23_HOST_KEYS, dtype=np.int32),
        np.arange(P23_HOST_KEYS, dtype=np.float32) * 2)
    table.block()
    rec = _P23Events()
    ctx.bus.add_listener(rec)
    state = {}

    def card(_):
        node = ctx.dense_range(P24_ROWS).map(
            lambda x: (x % P24_KEYS, x * 0.5)).reduce_by_key(op="add")
        node.block()
        return node

    def host(node):
        ctx.bus.flush()
        start = len(rec.events)
        lifted = p23_host_part(node.to_rdd()).dense()
        ctx.bus.flush()
        state["stages"] = rec.stage_walls(start, len(rec.events))
        state.setdefault("all_stages", []).append(state["stages"])
        state["lifted"] = lifted
        return lifted

    def join(lifted):
        return lifted.join(table).count()

    def check(n):
        got = state["lifted"].collect_arrays()
        k, v = got["k"], got["v"]
        if rows_out is not None:
            rows_out.update(k=k, v=v)
        p24_check(f"24a {label}: every key once",
                  np.array_equal(np.sort(k), np.arange(P23_HOST_KEYS)))
        p24_check(f"24a {label}: the sums equal numpy's (rtol 1e-5)",
                  np.allclose(v, exp[k], rtol=1e-5, atol=0.0))
        p24_check(f"24a {label}: join count == 1,000", n == P23_HOST_KEYS)
        p24_check(f"24a {label}: at least 3 host stages "
                  f"({state['stages']})", len(state["stages"]) >= 3)
        return f"{label}, {len(state['stages'])} host stages, count {n}"

    d0, f0 = p24_fleet_counters(ctx)
    r = p19_case(torch, ck, f"a_{label}",
                 [("reduce_by_key", "card", card),
                  ("to_rdd.shuffles.dense", "host", host),
                  ("join.count", "card", join)], check, warm, 24)
    d1, f1 = p24_fleet_counters(ctx)
    runs = 1 + warm
    r["stages"] = state["stages"]
    r["run_stages"] = state["all_stages"]
    r["tasks"] = sum(s[2] for s in state["stages"])
    r["per_run"] = dict(
        tasks_dispatched=(d1["tasks_v2"] + d1["tasks_legacy"]
                          - d0["tasks_v2"] - d0["tasks_legacy"]) / runs,
        need_binary=(d1["need_binary"] - d0["need_binary"]) / runs,
        binaries_shipped=(d1["binaries_shipped"]
                          - d0["binaries_shipped"]) / runs,
        stage_binary_bytes=(d1["binary_bytes"] - d0["binary_bytes"]) / runs,
        result_bytes=(d1["result_bytes"] - d0["result_bytes"]) / runs,
        fetch_round_trips=(f1["round_trips"] - f0["round_trips"]) / runs,
        fetch_bytes=(f1["bytes"] - f0["bytes"]) / runs,
        fetch_buckets=(f1["buckets"] - f0["buckets"]) / runs)
    launched = {k: sum(r["step_launches"][st][k]
                       for st in ("reduce_by_key", "join.count"))
                for k in ck.LAUNCHES}
    p24_check(f"24a {label}: the card's steps launched all three kernels "
              f"({launched})", all(launched[k] > 0 for k in
                                   ("hash_bucket", "digit_hist",
                                    "partition_pos")))
    return r


def p24_part_b(ctx):
    """24b: one executor killed between two collects over one shuffle:
    the second fetch-fails (or meets the reaper's scrub), its map stage
    is resubmitted on the survivors or the respawned executor, the rows
    are equal; ExecutorLost and ExecutorRestarted posted."""
    shuffled = ctx.parallelize(range(P24_SMALL), 8).map(
        lambda x: (x % 1000, x)).reduce_by_key(operator.add, 8)
    first = sorted(shuffled.collect())
    s0 = ctx.metrics_summary()
    uri = ctx.env.map_output_tracker.get_server_uris(shuffled.shuffle_id)[0]
    victim = next(ex for ex in ctx._backend._executors.values()
                  if ex.alive and ctx._backend._match_tier(ex, [uri]) == 0)
    t0 = time.perf_counter()
    victim.process.kill()
    victim.process.wait()
    second = sorted(shuffled.collect())
    recovery_ms = (time.perf_counter() - t0) * 1e3
    deadline = time.time() + 30.0
    while time.time() < deadline:
        s1 = ctx.metrics_summary()
        if s1["executors_lost"] > s0["executors_lost"] and \
                s1["executors_restarted"] > s0["executors_restarted"]:
            break
        time.sleep(0.2)
    out = {k: s1[k] - s0[k] for k in ("executors_lost",
                                      "executors_restarted",
                                      "stages_resubmitted", "task_failures")}
    p24_check("24b: equal rows after the loss", first == second)
    p24_check(f"24b: ExecutorLost and ExecutorRestarted posted ({out})",
              out["executors_lost"] >= 1 and out["executors_restarted"] >= 1)
    p24_check(f"24b: the lost map outputs recomputed ({out})",
              out["stages_resubmitted"] >= 1)
    n = ctx.parallelize(range(1000), 8).map(lambda x: x + 1).count()
    p24_check("24b: new work runs on the fleet", n == 1000)
    return dict(victim=victim.executor_id, recovery_ms=recovery_ms, **out)


def p24_part_c(ctx):
    """24c: a task that raises on an executor: TaskError carrying the
    executor's traceback."""
    from vega_tpu_torch.errors import TaskError

    def boom(x):
        raise ValueError(f"bad item {x}")

    try:
        ctx.parallelize(range(100), 4).map(boom).collect()
    except TaskError as e:
        err = e
    else:
        err = None
    p24_check("24c: TaskError raised", err is not None)
    tb = err.remote_traceback or ""
    p24_check("24c: the remote traceback names the function and its error",
              "boom" in tb and "bad item" in tb
              and isinstance(err.__cause__, ValueError))
    return dict(cause=type(err.__cause__).__name__,
                traceback_lines=len(tb.splitlines()))


def p24_part_d(vt, ctx):
    """24d: one shuffle's buckets read on the driver through batched
    get_many and through per-bucket get (equal, and each one's round
    trips); then shuffle_replication=2 with the primary holder killed
    after the map stage: the reduce reads the replicas, no stage
    resubmitted, rows equal."""
    from vega_tpu_torch.shuffle import fetcher

    shuffled = ctx.parallelize(range(P24_SMALL), 8).map(
        lambda x: (x % 1000, x)).reduce_by_key(operator.add, 4)
    rows = sorted(shuffled.collect())
    env = ctx.env
    legs = {}
    for batched in (True, False):
        env.conf.fetch_batch_enabled = batched
        try:
            fetcher.reset_stats()
            t0 = time.perf_counter()
            blobs = [sorted(fetcher.ShuffleFetcher.fetch_blobs(
                env, shuffled.shuffle_id, r)) for r in range(4)]
            ms = (time.perf_counter() - t0) * 1e3
            st = fetcher.stats_snapshot()
        finally:
            env.conf.fetch_batch_enabled = True
        legs["batched" if batched else "per_bucket"] = dict(
            blobs=blobs, ms=ms, round_trips=st["round_trips"],
            bytes=st["bytes"])
    servers = len(set(env.map_output_tracker.get_server_uris(
        shuffled.shuffle_id)))
    p24_check("24d: batched and per-bucket buckets equal",
              legs["batched"]["blobs"] == legs["per_bucket"]["blobs"])
    p24_check(f"24d: round trips 4 x servers ({servers}) against 4 x 8 "
              f"({legs['batched']['round_trips']}, "
              f"{legs['per_bucket']['round_trips']})",
              legs["batched"]["round_trips"] == 4 * servers
              and legs["per_bucket"]["round_trips"] == 32)
    out = {k: {f: x[f] for f in ("ms", "round_trips", "bytes")}
           for k, x in legs.items()}
    with vt.Context(mode="distributed", n_shards=N_SHARDS, num_executors=2,
                    shuffle_replication=2, **P24_FLEET) as rctx:
        node = rctx.parallelize(range(P24_SMALL), 8).map(
            lambda x: (x % 1000, x)).reduce_by_key(operator.add, 4)
        first = sorted(node.collect())
        lists = rctx.env.map_output_tracker.get_server_uri_lists(
            node.shuffle_id)
        p24_check(f"24d: two locations per map output ({lists})",
                  all(len(lst) == 2 and lst[0] != lst[1] for lst in lists))
        s0 = rctx.metrics_summary()
        before = rctx._backend.worker_stats()
        victim = next(ex for ex in rctx._backend._executors.values()
                      if rctx._backend._match_tier(ex, [lists[0][0]]) == 0)
        victim.process.kill()
        victim.process.wait()
        t0 = time.perf_counter()
        second = sorted(node.collect())
        ms = (time.perf_counter() - t0) * 1e3
        s1 = rctx.metrics_summary()
        after = rctx._backend.worker_stats()
        resubmitted = s1["stages_resubmitted"] - s0["stages_resubmitted"]
        failovers = sum(after[e]["fetch"]["failover_buckets"]
                        - before.get(e, after[e])["fetch"]
                        ["failover_buckets"] for e in after)
        p24_check("24d: equal rows after the primary's loss",
                  first == second == rows)
        p24_check(f"24d: no stage resubmitted ({resubmitted})",
                  resubmitted == 0)
    out["replicated"] = dict(recovery_ms=ms, stages_resubmitted=resubmitted,
                             failover_buckets=failovers)
    return out


def p24_part_e(ctx):
    """24e: the fleet's own report: a job returns each executor's
    sys.modules entries under jax / jaxlib / vega_tpu / cloudpickle and
    torch.cuda.is_initialized(); nvidia-smi lists no executor's pid."""
    def report(_it):
        import os
        import sys

        import torch

        return [(os.getpid(),
                 sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "vega_tpu",
                                               "cloudpickle")),
                 torch.cuda.is_initialized())]

    pids = {ex.process.pid for ex in ctx._backend._executors.values()
            if ex.alive}
    seen = {}
    for _ in range(3):
        for pid, mods, cuda in ctx.parallelize(range(64), 64) \
                .map_partitions(report).collect():
            seen[pid] = (mods, cuda)
        if set(seen) >= pids:
            break
    p24_check(f"24e: every executor reported ({sorted(seen)} of "
              f"{sorted(pids)})", set(seen) >= pids)
    p24_check(f"24e: no executor imported jax, vega_tpu or cloudpickle "
              f"({seen})", all(not mods for mods, _ in seen.values()))
    p24_check("24e: no executor initialized CUDA",
              not any(cuda for _, cuda in seen.values()))
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    apps = {int(x) for x in res.stdout.split() if x.strip().isdigit()}
    p24_check(f"24e: nvidia-smi lists no executor ({apps & pids})",
              res.returncode == 0 and not apps & pids)
    return dict(executors=len(pids), compute_apps=sorted(apps),
                executor_pids=sorted(pids))


def phase_twentyfour(torch, np, ck, vt):
    """Phase 24: the distributed backend, its executors on the CPU and
    the dense tier on the card: (a) bench-main's lineage at 20M rows,
    reduced on the card, two host shuffles on 1 and then 4 executor
    processes, lifted and joined on the card, beside the local runtime
    at 8 task threads; (b) an executor killed between two collects; (c)
    a remote TaskError; (d) batched against per-bucket fetch, and a
    replicated shuffle read after its primary is killed; (e) the fleet
    holds no card and imports no jax."""
    t0 = time.perf_counter()
    card = card_line()
    exp = p24_expected(np)
    rows, parts, out, spawn = [], {}, {}, {}
    for executors in P24_EXECUTORS:
        t1 = time.perf_counter()
        ctx = vt.Context(mode="distributed", n_shards=N_SHARDS,
                         num_executors=executors, **P24_FLEET)
        try:
            spawn[executors] = dict(
                context_s=time.perf_counter() - t1,
                ready_s=max(ctx._backend.spawn_s.values()))
            rows.append(p24_part_a(torch, np, ck, vt, ctx,
                                   f"executors{executors}", exp))
            parts[f"a{executors}"] = time.perf_counter() - t1
            if executors == P24_EXECUTORS[-1]:
                t1 = time.perf_counter()
                out["e"] = p24_part_e(ctx)
                out["c"] = p24_part_c(ctx)
                out["d"] = p24_part_d(vt, ctx)
                out["b"] = p24_part_b(ctx)
                parts["bcde"] = time.perf_counter() - t1
        finally:
            ctx.stop()
    t1 = time.perf_counter()
    with vt.Context(n_shards=N_SHARDS, num_workers=P24_LOCAL_WORKERS) as ctx:
        rows.append(p24_part_a(torch, np, ck, vt, ctx,
                               f"local_workers{P24_LOCAL_WORKERS}", exp))
    parts["a_local"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in rows)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 24")
    wall_s = time.perf_counter() - t0
    log(f"phase 24 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=rows, launches=launches, card=card, wall_s=wall_s,
                parts_s=parts, spawn=spawn, **out)


def p24_lines(r, card):
    """The printed lines of phase 24."""
    out = []
    for x in r["rows"]:
        out.append(
            f"phase 24{x['label']} ({x['note']}; {P24_ROWS} rows, "
            f"{P24_KEYS} keys): {x['median_ms']:.3f} ms warm median of "
            f"{len(x['warm'])}, parts {json.dumps(x['median_parts'])}, "
            f"cold {x['cold']['ms']:.3f} ms, {x['tasks']} tasks, stage "
            f"walls (id, kind, tasks, s) {json.dumps(x['stages'])}, per "
            f"run {json.dumps(x['per_run'])}, launches by step "
            f"{json.dumps(x['step_launches'])} on {card}")
    out.append(f"phase 24 executor spawn to ready (s) "
               f"{json.dumps(r['spawn'])} on {card}")
    for part in ("b", "c", "d", "e"):
        out.append(f"phase 24{part}: {json.dumps(r[part])} on {card}")
    out.append(f"phase 24 launches {json.dumps(r['launches'])}; parts (s) "
               f"{json.dumps(r['parts_s'])}; phase 24 {r['wall_s']:.1f} s "
               f"on {card}")
    return out


def p24_summary(res):
    """Phase 24's figures as JSON (24a without its per-run records)."""
    return dict(phase=24, wall_s=res["wall_s"], parts_s=res["parts_s"],
                launches=res["launches"], card=res["card"],
                spawn=res["spawn"],
                a={x["label"]: dict(note=x["note"], median_ms=x["median_ms"],
                                    parts=x["median_parts"],
                                    cold_ms=x["cold"]["ms"],
                                    warm_ms=[w["ms"] for w in x["warm"]],
                                    stages=x["stages"], tasks=x["tasks"],
                                    run_stages=x["run_stages"],
                                    per_run=x["per_run"],
                                    peak_bytes=x["peak_bytes"],
                                    step_launches=x["step_launches"])
                   for x in res["rows"]},
                **{k: res[k] for k in ("b", "c", "d", "e")})


def phase24_leg():
    """--phase 24: the kernels built, then phase 24 alone. Prints its
    lines and one JSON line, writes chiprun_out/p24.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentyfour(torch, np, ck, vt)
    out = p24_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p24.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p24_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P25_EXECUTORS = 4              # 25a-c: the fleets' executors
P25_WARM = 1                   # 25a: warm runs after the cold one
P25_CODING = "rs(4,2)"         # 25b
P25_ELASTIC = dict(elastic_enabled=True, elastic_min_executors=1,
                   elastic_max_executors=P25_EXECUTORS,
                   elastic_scale_up_threshold=2.0,
                   elastic_scale_down_threshold=0.25,
                   elastic_decision_interval_s=0.5,
                   decommission_timeout_s=10.0)
P25_BACKLOG = 48               # 25c: the backlog's slow tasks, on one
P25_TASK_S = 0.5               # task slot longer than an executor's spawn


def p25_check(what, ok):
    if not ok:
        fail(f"phase 25: {what}")


def p25_worker_counters(ctx):
    """The executors' push and fetch counters, summed over the fleet."""
    out = dict.fromkeys(("pushes", "merged", "duplicates", "failed",
                         "premerged", "local_blob_reads", "merged_rtts",
                         "fetch_buckets", "coded_failovers",
                         "parity_decodes", "parity_pushes"), 0)
    for s in ctx._backend.worker_stats().values():
        for k in ("pushes", "merged", "duplicates", "failed"):
            out[k] += s["push"][k]
        for k in ("premerged", "local_blob_reads", "merged_rtts",
                  "coded_failovers", "parity_decodes"):
            out[k] += s["fetch"][k]
        out["fetch_buckets"] += s["fetch"]["buckets"]
        out["parity_pushes"] += s["redundancy"]["parity_pushes"]
    return out


def p25_part_a(torch, np, ck, vt, exp):
    """25a: 24a's lineage at full width on P25_EXECUTORS executors, one
    fleet under shuffle_plan="pull" and one under "push": the card's
    reduce, to_rdd(), the two host shuffles (the native runtime's VN01
    rows; under push each bucket pre-merged on its reduce partition's
    owner), dense(), the join and count(). Equal rows; per run the host
    and card parts and the stage walls; the executors' push and fetch
    counters over the runs."""
    rows, counters, spawn = {}, {}, {}
    for plan in ("pull", "push"):
        t0 = time.perf_counter()
        ctx = vt.Context(mode="distributed", n_shards=N_SHARDS,
                         num_executors=P25_EXECUTORS, shuffle_plan=plan,
                         **P24_FLEET)
        try:
            spawn[plan] = time.perf_counter() - t0
            c0 = p25_worker_counters(ctx)
            r = p24_part_a(torch, np, ck, vt, ctx,
                           f"{plan}_executors{P25_EXECUTORS}", exp,
                           warm=P25_WARM)
            c1 = p25_worker_counters(ctx)
            rows[plan] = r
            counters[plan] = {k: c1[k] - c0[k] for k in c1}
        finally:
            ctx.stop()
    runs = 1 + P25_WARM
    push = counters["push"]
    p25_check(f"25a push: every bucket of both host shuffles read "
              f"pre-merged ({push})",
              push["premerged"] == push["fetch_buckets"]
              == runs * N_SHARDS * (8 + 4))
    p25_check(f"25a push: every map task pushed, nothing failed ({push})",
              push["pushes"] == runs * 2 * N_SHARDS and push["failed"] == 0
              and push["duplicates"] == 0
              and push["merged"] == push["premerged"])
    p25_check(f"25a pull: nothing pushed ({counters['pull']})",
              counters["pull"]["pushes"] == 0
              and counters["pull"]["premerged"] == 0)
    return dict(rows=[rows["pull"], rows["push"]], counters=counters,
                spawn_s=spawn)


def p25_part_b(torch, np, vt):
    """25b: shuffle_coding="rs(4,2)" on P25_EXECUTORS executors: a host
    shuffle's map outputs each folded into a parity group; one executor
    holding outputs is killed after the map stage; the second read
    decodes its buckets with no map stage resubmitted. Then one decode
    on the driver (its Context's device, the card): its
    gf256_accumulate held bit for bit against _accumulate_np, its ms."""
    from vega_tpu_torch.shuffle import coding, fetcher

    ctx = vt.Context(mode="distributed", n_shards=N_SHARDS,
                     num_executors=P25_EXECUTORS, shuffle_coding=P25_CODING,
                     **P24_FLEET)
    try:
        node = ctx.parallelize(range(P24_SMALL), 8).map(
            lambda x: (x % 1000, x)).reduce_by_key(operator.add, 4)
        first = sorted(node.collect())
        c0 = p25_worker_counters(ctx)
        p25_check(f"25b: every map output's row folded into a group ({c0})",
                  c0["parity_pushes"] == 8)
        tracker = ctx.env.map_output_tracker
        lists = tracker.get_server_uri_lists(node.shuffle_id)
        victim_uri = lists[0][0]
        victim = next(ex for ex in ctx._backend._executors.values()
                      if ctx._backend._match_tier(ex, [victim_uri]) == 0)
        s0 = ctx.metrics_summary()
        victim.process.kill()
        victim.process.wait()
        deadline = time.time() + 30.0
        while ctx.metrics_summary()["executors_lost"] == \
                s0["executors_lost"] and time.time() < deadline:
            time.sleep(0.1)
        coded = tracker.coded_locations(node.shuffle_id)
        p25_check(f"25b: the victim's outputs decodable ({coded})",
                  coded and all(m in coded for m, lst in enumerate(lists)
                                if lst == [victim_uri]))
        t0 = time.perf_counter()
        second = sorted(node.collect())
        recovery_ms = (time.perf_counter() - t0) * 1e3
        s1 = ctx.metrics_summary()
        c1 = p25_worker_counters(ctx)
        resubmitted = s1["stages_resubmitted"] - s0["stages_resubmitted"]
        decoded = c1["parity_decodes"] - c0["parity_decodes"]
        p25_check("25b: equal rows after the loss", first == second)
        p25_check(f"25b: no map stage resubmitted ({resubmitted})",
                  resubmitted == 0)
        p25_check(f"25b: the reducers decoded the lost buckets ({c1})",
                  c1["coded_failovers"] > c0["coded_failovers"]
                  and decoded >= 4 * len(coded))
        # one decode on the driver, its accumulation held against numpy
        held = []
        real = coding.accumulate

        def accumulate(blocks, coeffs, device):
            out = real(blocks, coeffs, device)
            held.append((str(device), out,
                         coding._accumulate_np(blocks, coeffs)))
            return out

        coding.accumulate = accumulate
        try:
            lists = tracker.get_server_uri_lists(node.shuffle_id)
            stats = {"round_trips": 0, "parity_decodes": 0,
                     "decode_bytes": 0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, failed = fetcher._reconstruct(
                ctx.env, tracker, lists, node.shuffle_id, 0, sorted(coded),
                {victim_uri}, stats)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3
        finally:
            coding.accumulate = real
        p25_check(f"25b: the driver's decode of reduce 0 ({failed})",
                  not failed and all(m in got for m in coded))
        p25_check(f"25b: the card's gf256_accumulate equals _accumulate_np "
                  f"bit for bit ({[(d, o.shape) for d, o, _ in held]})",
                  held and all(d.startswith("cuda") and o.dtype == w.dtype
                               and np.array_equal(o, w)
                               for d, o, w in held))
        return dict(victim=victim.executor_id, decodable=len(coded),
                    recovery_ms=recovery_ms, stages_resubmitted=resubmitted,
                    reconstructed_buckets=decoded,
                    coded_failovers=c1["coded_failovers"]
                    - c0["coded_failovers"],
                    driver_decode=dict(ms=decode_ms,
                                       buckets=stats["parity_decodes"],
                                       bytes=stats["decode_bytes"],
                                       round_trips=stats["round_trips"],
                                       accumulations=len(held)))
    finally:
        ctx.stop()


def p25_part_c(vt):
    """25c: the elastic fleet from one executor: P25_BACKLOG slow tasks
    queued scale it up to P25_EXECUTORS, idle time scales it down again
    by decommissions that migrate the shuffle outputs the executors hold;
    a second read of that shuffle gives the same rows with no stage
    resubmitted. fleet_status() before, at the peak and after."""
    ctx = vt.Context(mode="distributed", n_shards=N_SHARDS, num_executors=1,
                     num_workers=1, **P24_FLEET, **P25_ELASTIC)
    try:
        before = ctx.fleet_status()
        task_s = P25_TASK_S
        node = ctx.parallelize(range(P25_BACKLOG), P25_BACKLOG).map(
            lambda x: (time.sleep(task_s), (x % 7, x))[1]) \
            .reduce_by_key(operator.add, 4)
        peak = {"live": 0, "status": None}
        done = threading.Event()

        def sample():
            while not done.is_set():
                st = ctx.fleet_status()
                live = sum(1 for r in st["fleet"]
                           if r["alive"] and not r["draining"])
                if live > peak["live"]:
                    peak.update(live=live, status=st)
                time.sleep(0.05)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        first = sorted(node.collect())
        job_s = time.perf_counter() - t0
        # until the last decommission has reaped its slot
        deadline = time.time() + 90.0
        while (ctx.elastic.counters["scale_downs"] < P25_EXECUTORS - 1
               or len(ctx._backend.fleet_snapshot()) > 1) \
                and time.time() < deadline:
            time.sleep(0.1)
        scale_down_s = time.perf_counter() - t0 - job_s
        ctx.elastic.stop()
        done.set()
        sampler.join(timeout=10)
        after = ctx.fleet_status()
        s0 = ctx.metrics_summary()
        second = sorted(node.collect())
        s1 = ctx.metrics_summary()
        want = sorted({k: sum(range(k, P25_BACKLOG, 7))
                       for k in range(7)}.items())
        el = s1["elastic"]
        p25_check("25c: the rows", first == second == want)
        p25_check(f"25c: scaled up to {P25_EXECUTORS} ({peak['live']})",
                  peak["live"] == P25_EXECUTORS)
        p25_check(f"25c: scaled back down to 1 ({after['fleet']})",
                  len(after["fleet"]) == 1)
        p25_check(f"25c: decommissions migrated outputs ({el})",
                  el["executors_decommissioned"] == P25_EXECUTORS - 1
                  and el["decommissions_forced"] == 0
                  and el["migrated_outputs"] >= 1
                  and el["recomputed_outputs"] == 0)
        p25_check("25c: the second read resubmitted nothing",
                  s1["stages_resubmitted"] == s0["stages_resubmitted"])

        def brief(st):
            return dict(fleet=[(r["executor_id"], r["alive"],
                                r["draining"], r["inflight"])
                               for r in st["fleet"]],
                        scheduler={k: st["scheduler"][k]
                                   for k in ("running", "queued")},
                        elastic={k: st["elastic"][k]
                                 for k in ("live_executors", "scale_ups",
                                           "scale_downs",
                                           "executor_seconds")})

        return dict(job_s=job_s, scale_down_s=scale_down_s,
                    before=brief(before), peak=brief(peak["status"]),
                    after=brief(after), elastic=el)
    finally:
        ctx.stop()


def p25_part_d(vt):
    """25d: one executor spawned with VEGA_TPU_FAULT_KILL_AFTER_TASKS=2
    (aimed at exec-0 by VEGA_TPU_FAULT_EXECUTOR): it SIGKILLs itself
    after its second task, before that result is sent; the job recovers
    to the same rows, the loss is declared and the slot respawned (its
    hooks disarmed)."""
    import tempfile

    from vega_tpu_torch import faults

    stats_dir = tempfile.mkdtemp(prefix="p25d-")
    fault_env = {"VEGA_TPU_FAULT_KILL_AFTER_TASKS": "2",
                 "VEGA_TPU_FAULT_EXECUTOR": "exec-0",
                 "VEGA_TPU_FAULT_STATS_DIR": stats_dir}
    os.environ.update(fault_env)
    faults.reset()
    try:
        ctx = vt.Context(mode="distributed", n_shards=N_SHARDS,
                         num_executors=2, **P24_FLEET)
    finally:
        for k in fault_env:
            os.environ.pop(k, None)
        faults.reset()
    try:
        want = sorted({k: sum(range(k, P24_SMALL, 1000))
                       for k in range(1000)}.items())
        t0 = time.perf_counter()
        got = sorted(ctx.parallelize(range(P24_SMALL), 8).map(
            lambda x: (x % 1000, x)).reduce_by_key(operator.add, 4)
            .collect())
        ms = (time.perf_counter() - t0) * 1e3
        deadline = time.time() + 30.0
        while time.time() < deadline:
            s = ctx.metrics_summary()
            if s["executors_lost"] >= 1 and s["executors_restarted"] >= 1:
                break
            time.sleep(0.2)
        stats = faults.read_stats(stats_dir)
        fired = [x["fault"] for x in stats]
        p25_check("25d: the rows", got == want)
        # two tasks finishing together may both reach the count: one
        # process, one SIGKILL
        p25_check(f"25d: the kill fired in one process ({stats})",
                  fired and set(fired) == {"kill_worker"}
                  and len({x["pid"] for x in stats}) == 1)
        p25_check(f"25d: the loss declared and the slot respawned ({s})",
                  s["executors_lost"] >= 1 and s["executors_restarted"] >= 1)
        n = ctx.parallelize(range(1000), 8).map(lambda x: x + 1).count()
        p25_check("25d: the respawned fleet runs new work", n == 1000)
        return dict(ms=ms, fired=fired,
                    executors_lost=s["executors_lost"],
                    executors_restarted=s["executors_restarted"],
                    stages_resubmitted=s["stages_resubmitted"],
                    task_failures=s["task_failures"])
    finally:
        ctx.stop()
        shutil.rmtree(stats_dir, ignore_errors=True)


def phase_twentyfive(torch, np, ck, vt):
    """Phase 25: the native runtime, the push plan, the coded shuffle,
    the elastic fleet and the executors' fault hooks: (a) 24a's lineage
    at 20M rows on 4 executors under the pull and the push plan; (b)
    rs(4,2) parity and a decode after an executor's loss; (c) a fleet
    scaled up by a backlog and down by idle time; (d) an executor that
    SIGKILLs itself by its fault hook."""
    t0 = time.perf_counter()
    card = card_line()
    exp = p24_expected(np)
    parts = {}
    t1 = time.perf_counter()
    a = p25_part_a(torch, np, ck, vt, exp)
    parts["a"] = time.perf_counter() - t1
    out = {}
    for name, fn in (("b", lambda: p25_part_b(torch, np, vt)),
                     ("c", lambda: p25_part_c(vt)),
                     ("d", lambda: p25_part_d(vt))):
        t1 = time.perf_counter()
        out[name] = fn()
        parts[name] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in a["rows"])
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 25")
    wall_s = time.perf_counter() - t0
    log(f"phase 25 took {wall_s:.1f} s (parts {json.dumps(parts)})")
    return dict(rows=a["rows"], counters=a["counters"], spawn_s=a["spawn_s"],
                launches=launches, card=card, wall_s=wall_s, parts_s=parts,
                **out)


def p25_lines(r, card):
    """The printed lines of phase 25."""
    out = []
    for x in r["rows"]:
        plan = x["label"].split("_")[1]  # a_<plan>_executors<n>
        runs = [dict(ms=round(w["ms"], 3),
                     parts={k: round(v, 3) for k, v in w["parts"].items()})
                for w in [x["cold"]] + x["warm"]]
        out.append(
            f"phase 25a {x['label']} ({x['note']}; {P24_ROWS} rows, "
            f"{P24_KEYS} keys): {x['median_ms']:.3f} ms warm median of "
            f"{len(x['warm'])}, per run (cold first) {json.dumps(runs)}, "
            f"stage walls per run (id, kind, tasks, s) "
            f"{json.dumps(x['run_stages'])}, executors' push and fetch "
            f"counters over the runs {json.dumps(r['counters'][plan])}, "
            f"launches by step {json.dumps(x['step_launches'])} on {card}")
    out.append(f"phase 25a fleet spawn (s) {json.dumps(r['spawn_s'])} on "
               f"{card}")
    for part in ("b", "c", "d"):
        out.append(f"phase 25{part}: {json.dumps(r[part])} on {card}")
    out.append(f"phase 25 launches {json.dumps(r['launches'])}; parts (s) "
               f"{json.dumps(r['parts_s'])}; phase 25 {r['wall_s']:.1f} s "
               f"on {card}")
    return out


def p25_summary(res):
    """Phase 25's figures as JSON."""
    return dict(phase=25, wall_s=res["wall_s"], parts_s=res["parts_s"],
                launches=res["launches"], card=res["card"],
                spawn_s=res["spawn_s"], counters=res["counters"],
                a={x["label"]: dict(note=x["note"], median_ms=x["median_ms"],
                                    parts=x["median_parts"],
                                    cold_ms=x["cold"]["ms"],
                                    cold_parts=x["cold"]["parts"],
                                    warm=[dict(ms=w["ms"], parts=w["parts"])
                                          for w in x["warm"]],
                                    run_stages=x["run_stages"],
                                    per_run=x["per_run"],
                                    step_launches=x["step_launches"])
                   for x in res["rows"]},
                **{k: res[k] for k in ("b", "c", "d")})


def phase25_leg():
    """--phase 25: the kernels built, then phase 25 alone. Prints its
    lines and one JSON line, writes chiprun_out/p25.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentyfive(torch, np, ck, vt)
    out = p25_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p25.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p25_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P26_EXECUTORS = 2              # each rank's fleet
P26_WARM = 3                   # warm runs a rank after its cold run
P26_RANKS = 2                  # two ranks sharing the card over gloo


def p26_check(what, ok):
    if not ok:
        fail(f"phase 26: {what}")


def phase26_rank_leg(rank, port):
    """26, rank `rank` of two sharing the card over gloo, 4 of the 8
    global shards here: Context(mode="distributed", multihost=...) with
    a fleet of P26_EXECUTORS executors of its own; 24a's lineage at
    P24_ROWS rows (the reduce on the card, two host shuffles on this
    rank's fleet, dense(), the join on the card), cold then P26_WARM
    warm runs, checked against numpy; the lifted rows' digest, the
    fleet's spawn, mesh.WIRE and the lift's agreement per run. Prints
    one JSON line."""
    import hashlib

    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck
    from vega_tpu_torch import mesh as mesh_lib

    ck.build()
    t0 = time.perf_counter()
    ctx = vt.Context(device="cuda:0", n_shards=N_SHARDS, mode="distributed",
                     num_executors=P26_EXECUTORS, multihost=dict(
                         coordinator=f"127.0.0.1:{port}",
                         num_processes=P26_RANKS, process_id=rank,
                         backend="gloo"), **P24_FLEET)
    try:
        spawn = dict(context_s=time.perf_counter() - t0,
                     ready_s=max(ctx._backend.spawn_s.values()))
        p26_check(f"rank {rank} mesh {ctx.mesh}",
                  ctx.mesh.world == P26_RANKS
                  and ctx.mesh.n_local == N_SHARDS // P26_RANKS)
        p26_check(f"rank {rank}: {P26_EXECUTORS} executors of its own, "
                  f"num_workers {ctx.conf.num_workers} each",
                  len(ctx._backend._executors) == P26_EXECUTORS
                  and ctx._backend.parallelism
                  == P26_EXECUTORS * ctx.conf.num_workers)
        wire0 = dict(mesh_lib.WIRE)
        with _P18Clock(torch, ((mesh_lib, "agree_objects"),)) as agree:
            rows = {}
            r = p24_part_a(torch, np, ck, vt, ctx, f"p26_rank{rank}",
                           p24_expected(np), warm=P26_WARM, rows_out=rows)
        runs = 1 + P26_WARM
        wire = {k: (mesh_lib.WIRE[k] - wire0[k]) / runs for k in wire0}
        agree_ms = [(t1 - t0) * 1e3 for t0, t1 in agree._spans]
        digest = hashlib.sha256(
            np.ascontiguousarray(rows["k"]).tobytes()
            + np.ascontiguousarray(rows["v"]).tobytes()).hexdigest()
        res = dict(rank=rank, label=r["label"], note=r["note"],
                   cold_ms=r["cold"]["ms"], cold_parts=r["cold"]["parts"],
                   warm=[dict(ms=w["ms"], parts=w["parts"])
                         for w in r["warm"]],
                   median_ms=r["median_ms"], median_parts=r["median_parts"],
                   launches=r["launches"], step_launches=r["step_launches"],
                   stages=r["stages"], per_run=r["per_run"],
                   peak_bytes=r["peak_bytes"], spawn=spawn,
                   wire_per_run=wire, agree_ms=agree_ms, digest=digest,
                   executor_pids=sorted(ex.process.pid for ex in
                                        ctx._backend._executors.values()))
        p26_check(f"rank {rank}: one lift agreement a run ({agree_ms})",
                  len(agree_ms) == runs and wire["agree"] == 1)
    finally:
        ctx.stop()
        torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)


def phase_twentysix(torch, np, ck, vt):
    """Phase 26: Context(mode="distributed", multihost=...) on two ranks
    sharing the card over gloo, each with an executor fleet of its own:
    24a's lineage at 20M rows per rank, each rank's rows against numpy
    and the two ranks' lifted rows equal (their digests)."""
    t0 = time.perf_counter()
    card = card_line()
    torch.cuda.empty_cache()
    port = free_port()
    ranks = p13_spawn([["--phase26-rank", r, port]
                       for r in range(P26_RANKS)])
    p26_check(f"both ranks' lifted rows equal "
              f"({[x['digest'] for x in ranks]})",
              len({x["digest"] for x in ranks}) == 1
              and ranks[0]["digest"] is not None)
    p26_check("no executor shared between the ranks",
              not set(ranks[0]["executor_pids"])
              & set(ranks[1]["executor_pids"]))
    launches = {name: sum(x["launches"][name] for x in ranks)
                for name in ck.LAUNCHES}
    check_launched(launches, "phase 26")
    wall_s = time.perf_counter() - t0
    log(f"phase 26 took {wall_s:.1f} s")
    return dict(ranks=ranks, launches=launches, card=card, wall_s=wall_s)


def p26_lines(r, card):
    """The printed lines of phase 26."""
    out = []
    for x in r["ranks"]:
        wire = x["wire_per_run"]
        out.append(
            f"phase 26 rank {x['rank']} of {P26_RANKS} over gloo, "
            f"{P26_EXECUTORS} executors of its own ({x['note']}; "
            f"{P24_ROWS} rows, {P24_KEYS} keys): {x['median_ms']:.3f} ms "
            f"warm median of {len(x['warm'])}, parts "
            f"{json.dumps(x['median_parts'])}, cold {x['cold_ms']:.3f} ms, "
            f"executor spawn (s) {json.dumps(x['spawn'])}, stage-binary "
            f"bytes a run {x['per_run']['stage_binary_bytes']:.0f}, "
            f"host_get a run {wire['host_get']:.0f}, the lift's agreement "
            f"{wire['agree_bytes']:.0f} B a run in "
            f"{json.dumps([round(m, 3) for m in x['agree_ms']])} ms (cold "
            f"first), wire a run {json.dumps(wire)}, stage walls (id, kind, "
            f"tasks, s) {json.dumps(x['stages'])}, launches by step "
            f"{json.dumps(x['step_launches'])}, lifted rows digest "
            f"{x['digest'][:16]} on {card}")
    out.append(f"phase 26 launches {json.dumps(r['launches'])}; phase 26 "
               f"{r['wall_s']:.1f} s on {card}")
    return out


def p26_summary(res):
    """Phase 26's figures as JSON."""
    return dict(phase=26, wall_s=res["wall_s"], launches=res["launches"],
                card=res["card"], ranks=res["ranks"])


def phase26_leg():
    """--phase 26: the kernels built, then phase 26 alone. Prints its
    lines and one JSON line, writes chiprun_out/p26.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentysix(torch, np, ck, vt)
    out = p26_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p26.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p26_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


P27_WORKERS = 8                # 27a: 23a's lineage on 8 task threads
P27_BATCHES = 3                # 27b: three committed batches of 22a's fold
P27_BATCH_S = 0.2              # 27b: the batch interval (22a: 0.5 s)
P27_POOLS = ("heavy", "light")  # 27c: one job in each of two pools
P27_LEG_TIMEOUT_S = 300.0      # the witness leg's limit
P27_BUDGET_S = 45.0            # the phase's target wall (logged, not held)
P27_DIR = os.path.join("chiprun_out", "phase27")


def p27_check(what, ok):
    if not ok:
        fail(f"phase 27: {what}")


def p27_stream(torch, np, ck, vt):
    """27b: 22a's generator stream into update_state_by_key(op="add"),
    batches every P27_BATCH_S, stopped after P27_BATCHES commits; the
    state equals numpy's exact sums up to the committed offset."""
    ckpt = os.path.join(P27_DIR, f"ckpt-{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)
    ctx = vt.Context(n_shards=N_SHARDS, stream_batch_interval_s=P27_BATCH_S)
    try:
        stream = ctx.stream_from_generator(P22Source(P22_RECORDS),
                                           checkpoint_dir=ckpt)
        handle = stream.update_state_by_key(op="add")
        sctx = ctx.streaming()
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        sctx.start()
        deadline = time.monotonic() + P22_WAIT_S
        while handle.store.commits < P27_BATCHES:
            p27_check(f"27b: the stream failed: {sctx.failed}",
                      sctx.failed is None)
            p27_check(f"27b: {P27_BATCHES} batches not committed within "
                      f"{P22_WAIT_S} s ({sctx.status()})",
                      time.monotonic() < deadline)
            time.sleep(0.02)
        sctx.stop()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        rec = handle.store.log.latest()
        n = rec["offsets"]["0"]
        p27_check(f"27b: the state differs from numpy's sums over the "
                  f"{n} committed records",
                  n > 0 and handle.snapshot() == p22_expected(np, n))
        p27_check("27b: duplicate commits",
                  handle.store.duplicate_commits == 0)
        commits = handle.store.commits
    finally:
        ctx.stop()
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(records=n, commits=commits, wall_s=wall_s,
                launches=launches)


def p27_pools(ck, vt):
    """27c: one job in each of two pools (weights 4 and 1, fair) of the
    job server, submitted together; both equal Python's sums."""
    want = {}
    for x in range(P23_SMALL):
        want[x % 100] = want.get(x % 100, 0) + x
    want = sorted(want.items())
    ck.reset_launches()
    t0 = time.perf_counter()
    with vt.Context(n_shards=N_SHARDS, num_workers=2,
                    scheduler_mode="fair") as ctx:
        ctx.set_pool(P27_POOLS[0], weight=4)
        ctx.set_pool(P27_POOLS[1], weight=1)
        futures = [ctx.submit_job(
            ctx.parallelize(range(P23_SMALL), 8).map(
                lambda x: (x % 100, x)).reduce_by_key(operator.add, 4),
            lambda _tc, it: sorted(it), pool=pool,
            transform=lambda parts: sorted(r for p in parts for r in p))
            for pool in P27_POOLS]
        for pool, f in zip(P27_POOLS, futures):
            p27_check(f"27c: pool {pool}'s job differs from Python's sums",
                      f.result(120) == want)
        latency = ctx.metrics_summary()["pool_latency"]
    p27_check(f"27c: both pools' walls ({latency})",
              set(latency) >= set(P27_POOLS))
    return dict(wall_s=time.perf_counter() - t0,
                launches=dict(ck.LAUNCHES))


def p27_case(torch, np, ck, vt, on):
    """The witness case: (a) 23a's lineage at P23_ROWS rows on
    P27_WORKERS task threads, (b) 27b's batches of 22a's fold, (c) 27c's
    two pools, under the witness (on) or not; its walls, launches and the
    kinds of a Context's locks."""
    exp = p23_expected(np)
    parts = {}
    t0 = time.perf_counter()
    ctx = vt.Context(n_shards=N_SHARDS, num_workers=P27_WORKERS)
    try:
        kinds = [type(ctx._dense_lock).__name__,
                 type(ctx.job_server._lock).__name__,
                 type(ctx.env.shuffle_store._lock).__name__]
        want_kinds = (["WitnessRLock", "WitnessLock", "WitnessLock"] if on
                      else [type(threading.RLock()).__name__,
                            type(threading.Lock()).__name__,
                            type(threading.Lock()).__name__])
        p27_check(f"the Context's locks are {kinds}, not {want_kinds}",
                  kinds == want_kinds)
        a = p23_part_a(torch, np, ck, vt, ctx, P27_WORKERS, exp)
    finally:
        ctx.stop()
    parts["a"] = time.perf_counter() - t0
    b = p27_stream(torch, np, ck, vt)
    parts["b"] = b["wall_s"]
    c = p27_pools(ck, vt)
    parts["c"] = c["wall_s"]
    return dict(
        witness=on, wall_s=time.perf_counter() - t0, parts_s=parts,
        launches={k: a["launches"][k] + b["launches"][k] + c["launches"][k]
                  for k in ck.LAUNCHES},
        lock_kinds=kinds,
        a=dict(cold_ms=a["cold"]["ms"], median_ms=a["median_ms"],
               median_parts=a["median_parts"], stages=a["stages"],
               tasks=a["tasks"]),
        b={k: b[k] for k in ("records", "commits", "wall_s")},
        c={"wall_s": c["wall_s"]})


def phase27_leg():
    """--phase27-leg: the witness case in a fresh process, its parent
    having set VEGA_TPU_DEBUG_SYNC=1 before any lock was built, then the
    witness's record and check_clean() (an inversion or a role breach
    raises, and the leg fails). Prints one JSON line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck
    from vega_tpu_torch.lint import sync_witness

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    p27_check("the witness leg runs without VEGA_TPU_DEBUG_SYNC=1",
              sync_witness.enabled())
    ck.build()
    case = p27_case(torch, np, ck, vt, True)
    st = sync_witness.witness().stats()
    sync_witness.check_clean()
    p27_check(f"the witness observed no order edge ({st})",
              st["names"] and st["edges"] > 0)
    want_roles = {"dag-loop", "listener-bus", "stream-receiver",
                  "batch-driver"}
    p27_check(f"roles observed {sorted(st['roles'])}, not "
              f"{sorted(want_roles)}", want_roles <= set(st["roles"]))
    case["witness"] = dict(
        names=st["names"], locks=st["locks"], edges=st["edges"],
        inversions=len(st["inversions"]),
        role_violations=len(st["role_violations"]),
        roles={r: len(t) for r, t in st["roles"].items()})
    print(json.dumps(case), flush=True)


def p27_spawn():
    """The witness leg in a process of its own, VEGA_TPU_DEBUG_SYNC=1 in
    its environment; its JSON line and its process wall, or the script
    fails with its stderr."""
    env = dict(os.environ, VEGA_TPU_DEBUG_SYNC="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase27-leg"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=P27_LEG_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or not out.strip():
        fail(f"phase 27's witness leg failed ({proc.returncode}):\n"
             f"{err[-4000:]}")
    leg = json.loads(out.strip().splitlines()[-1])
    leg["process_s"] = time.perf_counter() - t0
    return leg


def phase_twentyseven(torch, np, ck, vt):
    """Phase 27: the lock-order witness on the card. 23a's lineage on 8
    task threads, three batches of 22a's stateful fold and two jobs in
    two pools run in a fresh process under VEGA_TPU_DEBUG_SYNC=1 (every
    named lock a witness lock, check_clean() at its end), then the same
    case in this process, whose locks are plain; each case's wall beside
    the other's."""
    from vega_tpu_torch.lint import sync_witness

    t0 = time.perf_counter()
    card = card_line()
    p27_check("run chip_smoke.py without VEGA_TPU_DEBUG_SYNC: phase 27 "
              "sets it for its witness leg alone", not sync_witness.enabled())
    torch.cuda.empty_cache()
    on = p27_spawn()
    off = p27_case(torch, np, ck, vt, False)
    for leg in (on, off):
        check_launched(leg["launches"], "phase 27 (the witness leg)"
                       if leg["witness"] else "phase 27 (without it)")
    p27_check(f"the witness recorded {on['witness']['inversions']} "
              f"inversions and {on['witness']['role_violations']} role "
              "violations", on["witness"]["inversions"] == 0
              and on["witness"]["role_violations"] == 0)
    torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t0
    log(f"phase 27 took {wall_s:.1f} s (target {P27_BUDGET_S:.0f} s)")
    launches = {k: on["launches"][k] + off["launches"][k]
                for k in ck.LAUNCHES}
    return dict(on=on, off=off, launches=launches, card=card,
                wall_s=wall_s)


def p27_warm_s(leg):
    """A case's warm parts: 23a's warm median, 27b and 27c, each run after
    27a's cold run in its process. The two cases' cold runs are not alike
    (the witness leg's process is fresh, the other is the script's), so
    only these parts compare the witness's cost."""
    return leg["a"]["median_ms"] / 1000.0 + leg["parts_s"]["b"] \
        + leg["parts_s"]["c"]


def p27_lines(r, card):
    """The printed lines of phase 27."""
    out = []
    for leg in (r["on"], r["off"]):
        where = ("under VEGA_TPU_DEBUG_SYNC=1, a process of its own "
                 f"({leg['process_s']:.1f} s)" if leg["witness"]
                 else "without the flag, in the script's process")
        a = leg["a"]
        out.append(
            f"phase 27 {where}: case {leg['wall_s']:.3f} s (parts (s) "
            f"{json.dumps({k: round(v, 3) for k, v in leg['parts_s'].items()})}"
            f"; 27a 23a's lineage at {P23_ROWS} rows on {P27_WORKERS} task "
            f"threads cold {a['cold_ms']:.3f} ms, warm {a['median_ms']:.3f} "
            f"ms, {a['tasks']} tasks; 27b {leg['b']['commits']} batches, "
            f"{leg['b']['records']} records; 27c pools "
            f"{'/'.join(P27_POOLS)}), locks "
            f"{json.dumps(leg['lock_kinds'])}, launches "
            f"{json.dumps(leg['launches'])} on {card}")
    w = r["on"]["witness"]
    out.append(
        f"phase 27 witness: {len(w['names'])} named locks "
        f"{json.dumps(w['names'])}, {w['locks']} in order edges, "
        f"{w['edges']} edges, roles observed (threads) "
        f"{json.dumps(w['roles'])}, {w['inversions']} inversions, "
        f"{w['role_violations']} role violations; warm parts (23a's "
        f"warm median + 27b + 27c) {p27_warm_s(r['on']):.3f} s under the "
        f"witness beside {p27_warm_s(r['off']):.3f} s without "
        f"({p27_warm_s(r['on']) / p27_warm_s(r['off']):.3f}x; the cases' "
        f"walls, cold runs in unlike processes, {r['on']['wall_s']:.3f} "
        f"and {r['off']['wall_s']:.3f} s); phase 27 "
        f"{r['wall_s']:.1f} s on {card}")
    return out


def p27_summary(res):
    """Phase 27's figures as JSON."""
    return dict(phase=27, wall_s=res["wall_s"], launches=res["launches"],
                card=res["card"], on=res["on"], off=res["off"],
                warm_s=dict(on=p27_warm_s(res["on"]),
                            off=p27_warm_s(res["off"])))


def phase27_main():
    """--phase 27: the kernels built, then phase 27 alone. Prints its
    lines and one JSON line, writes chiprun_out/p27.json, and ends with
    the card line."""
    import numpy as np
    import torch

    import vega_tpu_torch as vt
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = card_line()
    ck.build()
    res = phase_twentyseven(torch, np, ck, vt)
    out = p27_summary(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "p27.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for line in p27_lines(res, card):
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    print(f"card: {card}", flush=True)


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
    # 13. the multi-process device tier
    thirteen = phase_thirteen(torch, np, ck, vt, main_path)
    # 14. the RDD API's repairs and item 7's forms
    fourteen = phase_fourteen(torch, np, ck, vt)
    # 15. the frame plans the reference answers on its host tier
    fifteen = phase_fifteen(torch, np, ck, vt)
    # 16. the reference's tier rules: bools, float64 keys and values, fills
    sixteen = phase_sixteen(torch, np, ck, vt)
    # 17. the reference's literal rule and numpy's integer widths
    seventeen = phase_seventeen(torch, np, ck, vt)
    # 18. the RDD API's host-tier answers on the card
    eighteen = phase_eighteen(torch, np, ck, vt)
    # 19. the host RDD layer the reference hands off to
    nineteen = phase_nineteen(torch, np, ck, vt)
    # 20. the reference's implicit host fall-throughs
    twenty = phase_twenty(torch, np, ck, vt)
    # 21. the row view (F24-F26), the frame planner's host tier, to_rdd()
    twentyone = phase_twentyone(torch, np, ck, vt)
    # 22. the streaming plane's fold on the card, the file sources
    twentytwo = phase_twentytwo(torch, np, ck, vt)
    # 23. the local runtime: stages, tasks, retries, the shuffle store
    twentythree = phase_twentythree(torch, np, ck, vt)
    # 24. the distributed backend: executor processes, remote fetch
    twentyfour = phase_twentyfour(torch, np, ck, vt)
    # 25. the push plan, the coded shuffle, the elastic fleet, fault hooks
    twentyfive = phase_twentyfive(torch, np, ck, vt)
    # 26. a fleet per rank: mode="distributed" with multihost=
    twentysix = phase_twentysix(torch, np, ck, vt)
    # 27. the lock-order witness: the local runtime under it and without
    twentyseven = phase_twentyseven(torch, np, ck, vt)

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
         "phase12_launches": twelve["launches"][r["name"]],
         "phase13_launches": thirteen["launches"][r["name"]],
         "phase14_launches": fourteen["launches"][r["name"]],
         "phase15_launches": fifteen["launches"][r["name"]],
         "phase16_launches": sixteen["launches"][r["name"]],
         "phase17_launches": seventeen["launches"][r["name"]],
         "phase18_launches": eighteen["launches"][r["name"]],
         "phase19_launches": nineteen["launches"][r["name"]],
         "phase20_launches": twenty["launches"][r["name"]],
         "phase21_launches": twentyone["launches"][r["name"]],
         "phase22_launches": twentytwo["launches"][r["name"]],
         "phase23_launches": twentythree["launches"][r["name"]],
         "phase24_launches": twentyfour["launches"][r["name"]],
         "phase25_launches": twentyfive["launches"][r["name"]],
         "phase26_launches": twentysix["launches"][r["name"]]}
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
                   phase12=twelve, phase13=thirteen, phase14=fourteen,
                   phase15=fifteen, phase16=sixteen, phase17=seventeen,
                   phase18=eighteen, phase19=nineteen, phase20=twenty,
                   phase21=twentyone, phase22=p22_summary(twentytwo),
                   phase23=p23_summary(twentythree),
                   phase24=p24_summary(twentyfour),
                   phase25=p25_summary(twentyfive),
                   phase26=p26_summary(twentysix),
                   phase27=p27_summary(twentyseven))
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
        print(f"{r['label']}: {r['rows_per_s']:.1f} rows/s warm median of "
              f"{len(r['warm_s'])} ({r['rows']} rows), host build "
              f"{statistics.median(r['warm_build_ms']):.1f} ms, cold "
              f"{r['cold_s']:.3f} s, median step ms "
              f"{json.dumps(r['median_step_ms'])}, launches of one warm run "
              f"{json.dumps(r['warm_launches'])}, peak "
              f"{r['peak_bytes']} bytes on {card}", flush=True)
    r = config3
    print(f"{r['label']}: {r['rows_per_s']:.1f} rows/s warm median of "
          f"{len(r['warm_s'])} ({r['rows']} rows, {r['check']['words']} "
          f"words), host build "
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
    print(f"phase 10d untraceable UDF on the host tier: "
          f"{ten['untraceable']['reason']}", flush=True)
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
    r = thirteen["a"]
    print(f"phase 13a NCCL at world size 1 (bench-main, {N_ROWS} rows): "
          f"{r['rows_per_s']:.1f} rows/s warm median of 3 beside phase 3's "
          f"{main_path['rows_per_s']:.1f}, cold {r['cold_s']:.3f} s, rows "
          f"bit-identical to phase 3's pipeline, launches "
          f"{json.dumps(r['launches'])}, profiled run: collectives "
          f"{json.dumps(r['cpu_collectives'])}, NCCL kernels "
          f"{json.dumps(r['nccl_kernels'])} ({r['nccl_ms']:.3f} ms over "
          f"{r['profiled_exchanges']} exchanges), device copies "
          f"{json.dumps(r['device_copies'])}, wire "
          f"per warm run {json.dumps(r['wire_per_warm_run'])} on {card}",
          flush=True)
    for r in thirteen["b"]:
        print(f"phase 13b rank {r['rank']} of 2 on {r['device']} over "
              f"{r['backend']}: {1e3 * r['median_s']:.3f} ms warm median of "
              f"3 ({r['rows_per_s']:.1f} rows/s), cold {r['cold_s']:.3f} s, "
              f"rows bit-identical to phase 3's pipeline, peak "
              f"{r['peak_bytes']} B, launches {json.dumps(r['launches'])}, "
              f"wire per warm run {json.dumps(r['wire_per_warm_run'])} on "
              f"{card}", flush=True)
    if thirteen["c"] is None:
        print(f"13c: not run, {thirteen['cards']} card", flush=True)
    else:
        for r in thirteen["c"]:
            print(f"phase 13c rank {r['rank']} of 2 on {r['device']} over "
                  f"nccl: {1e3 * r['median_s']:.3f} ms warm median of 3, "
                  f"peak {r['peak_bytes']} B on {card}", flush=True)
    for q, r in thirteen["d_one_process"]["queries"].items():
        x = r["cold"]
        print(f"phase 13d one process {q}: cold {x['ms']:.3f} ms, host "
              f"build {x['host_build_ms']:.3f} ms, equal to numpy, launches "
              f"{json.dumps(x['launches'])} on {card}", flush=True)
    for rank in thirteen["d"]:
        for q, r in rank["queries"].items():
            print(f"phase 13d rank {rank['rank']} of 2 over gloo {q}: "
                  f"{r['median_ms']:.3f} ms warm median of "
                  f"{len(r['warm'])}, host build "
                  f"{r['median_host_build_ms']:.3f} ms, the rest "
                  f"{r['median_rest_ms']:.3f} ms, cold "
                  f"{r['cold']['ms']:.3f} ms, parts "
                  f"{json.dumps(r['warm'][-1]['parts'])}, peak "
                  f"{r['peak_bytes']} B, wire per warm run "
                  f"{json.dumps(r['wire_per_warm_run'])}, cold launches "
                  f"{json.dumps(r['cold']['launches'])}, rows bit-identical "
                  f"to the one-process run on {card}", flush=True)
    print(f"phase 13d launches (both ranks' cold runs) "
          f"{json.dumps(thirteen['d_launches'])}, wall "
          f"{thirteen['d_wall_s']:.1f} s; phase 13 {thirteen['wall_s']:.1f} s",
          flush=True)
    for r in fourteen["repairs"] + fourteen["item7"]:
        print(f"phase {r['label']}: {r['median_ms']:.3f} ms warm median of "
              f"{len(r['warm_ms'])} ({r['rows_per_s']:.1f} rows/s over "
              f"{N_ROWS} rows), host build {r['median_build_ms']:.3f} ms"
              f", cold {r['cold_ms']:.3f} ms, launches "
              f"{json.dumps(r['launches'])}, peak {r['peak_bytes']} B on "
              f"{card}", flush=True)
    r = fourteen["multihost"]
    print(f"phase 14c one process ({P14C_ROWS} rows): cold "
          f"{r['one_process']['cold_ms']:.3f} ms, launches "
          f"{json.dumps(r['one_process']['launches'])}, equal to numpy on "
          f"{card}", flush=True)
    for x in r["ranks"]:
        print(f"phase 14c rank {x['rank']} of 2 over gloo: "
              f"{x['median_ms']:.3f} ms warm median of {len(x['warm_ms'])}, "
              f"cold {x['cold_ms']:.3f} ms, peak {x['peak_bytes']} B, "
              f"launches {json.dumps(x['launches'])}, rows bit-identical to "
              f"the one-process run on {card}", flush=True)
    print(f"phase 14 launches {json.dumps(fourteen['launches'])}; phase 14 "
          f"{fourteen['wall_s']:.1f} s", flush=True)
    for r in fifteen["rows"]:
        print(f"phase 15 {r['label']} ({P15_ROWS} fact rows, {P15_DIMS} "
              f"dimension rows; {r['note']}): {r['median_ms']:.3f} ms "
              f"{r['timed_as']}, host build {r['median_host_build_ms']:.3f} ms, "
              f"device steps {r['median_device_ms']:.3f} ms, cold "
              f"{r['cold']['ms']:.3f} ms, step peak {r['peak_bytes']} B, "
              f"launches {json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 15 launches {json.dumps(fifteen['launches'])}; explain "
          f"(c_mixed): {fifteen['explain']}; phase 15 "
          f"{fifteen['wall_s']:.1f} s on {card}", flush=True)
    for r in sixteen["rows"]:
        print(f"phase 16 {r['label']} ({P15_ROWS} fact rows, {P15_DIMS} "
              f"dimension rows; reference tier {r['tier']}; {r['note']}): "
              f"{r['median_ms']:.3f} ms {r['timed_as']}, "
              f"host build "
              f"{r['median_host_build_ms']:.3f} ms, device steps "
              f"{r['median_device_ms']:.3f} ms, cold {r['cold']['ms']:.3f} "
              f"ms, step peak {r['peak_bytes']} B, launches "
              f"{json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 16 launches {json.dumps(sixteen['launches'])}; explain "
          f"(f12_count): {sixteen['explain']}; phase 16 "
          f"{sixteen['wall_s']:.1f} s on {card}", flush=True)
    for r in seventeen["rows"]:
        if r["label"] == "e_rdd":
            print(f"phase 17 e_rdd: {r['note']}, built in "
                  f"{r['median_ms']:.3f} ms, launches "
                  f"{json.dumps(r['launches'])} on {card}", flush=True)
            continue
        print(f"phase 17 {r['label']} ({P15_ROWS} fact rows; reference "
              f"tier {r['tier']}: {r['why']}; {r['note']}): "
              f"{r['median_ms']:.3f} ms {r['timed_as']}, "
              f"host build "
              f"{r['median_host_build_ms']:.3f} ms, device steps "
              f"{r['median_device_ms']:.3f} ms, cold {r['cold']['ms']:.3f} "
              f"ms, step peak {r['peak_bytes']} B, launches "
              f"{json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 17 launches {json.dumps(seventeen['launches'])}; phase 17 "
          f"{seventeen['wall_s']:.1f} s on {card}", flush=True)
    for r in eighteen["rows"]:
        if "first_ms" in r:
            print(f"phase 18 {r['label']}: the estimate {r['note']} after "
                  f"{r['first_ms']:.3f} ms, then {r['final']} after "
                  f"{r['final_ms']:.3f} ms on {card}", flush=True)
            continue
        extra = (f", host peak {r['host_peak_bytes']} B above its start"
                 if "host_peak_bytes" in r else "")
        print(f"phase 18 {r['label']} ({r['note']}): {r['median_ms']:.3f} ms "
              f"warm median of {len(r['warm'])}, host part "
              f"{r['median_host_ms']:.3f} ms, device part "
              f"{r['median_device_ms']:.3f} ms, cold {r['cold']['ms']:.3f} "
              f"ms, step peak {r['peak_bytes']} B{extra}, launches "
              f"{json.dumps(r['launches'])} on {card}", flush=True)
    print(f"phase 18 launches {json.dumps(eighteen['launches'])}; 18e at "
          f"{eighteen['e_rows']} rows; parts (s) "
          f"{json.dumps(eighteen['parts_s'])}; phase 18 "
          f"{eighteen['wall_s']:.1f} s on {card}", flush=True)
    for r in nineteen["rows"]:
        print(f"phase 19 {r['label']} ({r['note']}): {r['median_ms']:.3f} ms "
              f"warm median of {len(r['warm'])}, parts "
              f"{json.dumps(r['median_parts'])}, cold {r['cold']['ms']:.3f} "
              f"ms, launches by step {json.dumps(r['step_launches'])} on "
              f"{card}", flush=True)
    print(f"phase 19 launches {json.dumps(nineteen['launches'])}; parts (s) "
          f"{json.dumps(nineteen['parts_s'])}; phase 19 "
          f"{nineteen['wall_s']:.1f} s on {card}", flush=True)
    for r in twenty["rows"]:
        print(f"phase 20 {r['label']} ({r['note']}): {r['median_ms']:.3f} ms "
              f"warm median of {len(r['warm'])}, parts "
              f"{json.dumps(r['median_parts'])}, cold {r['cold']['ms']:.3f} "
              f"ms, step peak {r['peak_bytes']} B, launches by step "
              f"{json.dumps(r['step_launches'])} on {card}", flush=True)
    print(f"phase 20 launches {json.dumps(twenty['launches'])}; parts (s) "
          f"{json.dumps(twenty['parts_s'])}; 20f tiers, equal on the card "
          f"and the CPU: {json.dumps(twenty['tiers'])}; phase 20 "
          f"{twenty['wall_s']:.1f} s on {card}", flush=True)
    for r in twentyone["rows"]:
        print(f"phase 21 {r['label']} ({r['note']}): {r['median_ms']:.3f} ms "
              f"warm median of {len(r['warm'])}, parts "
              f"{json.dumps(r['median_parts'])}, cold {r['cold']['ms']:.3f} "
              f"ms, step peak {r['peak_bytes']} B, launches by step "
              f"{json.dumps(r['step_launches'])} on {card}", flush=True)
    print(f"phase 21 launches {json.dumps(twentyone['launches'])}; parts (s) "
          f"{json.dumps(twentyone['parts_s'])}; phase 21 "
          f"{twentyone['wall_s']:.1f} s on {card}", flush=True)
    for line in p22_lines(twentytwo, card):
        print(line, flush=True)
    for line in p23_lines(twentythree, card):
        print(line, flush=True)
    for line in p24_lines(twentyfour, card):
        print(line, flush=True)
    for line in p25_lines(twentyfive, card):
        print(line, flush=True)
    for line in p26_lines(twentysix, card):
        print(line, flush=True)
    for line in p27_lines(twentyseven, card):
        print(line, flush=True)
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


AB_LEGS = ("main", "frame", "frame-profile", "p16-profile", "p1516",
           "f14-profile")


def ab_frame_leg(torch, np, ck, vt, cs):
    """The frame leg of --main-path-ab: over `cs`'s (a checkout's
    chip_smoke) phase-10 tables, 10a's fused frame query and 10b's mixed
    aggregates (sum / min / max / count / mean by key), each once cold and
    three times warm; the warm medians of the whole run, the host build
    and the rest (ms)."""
    from vega_tpu_torch.frame import F

    ev, dims = cs.p10_data(np)
    ctx = vt.Context(n_shards=cs.N_SHARDS)
    runs = {
        "fused": lambda: (cs.p10_query(ctx, ev, dims).collect_columns(),
                          None),
        "mixed": lambda: (ctx.create_frame(k=ev["k"], x=ev["x"]).group_by(
            "k").agg(F.sum("x"), F.min("x"), F.max("x"), F.count(),
                     F.mean("x")).collect_columns(), None)}
    out = {}
    for name, run in runs.items():
        cs.p10_run(torch, ck, ctx, name, run)
        warm = [cs.p10_run(torch, ck, ctx, name, run)[1] for _ in range(3)]
        out[name] = {k: statistics.median(w[k] for w in warm)
                     for k in ("ms", "host_build_ms", "device_ms")}
    ctx.stop()
    return out


def ab_frame_profile_leg(torch, np, ck, vt, cs):
    """The frame-profile leg of --main-path-ab: 10b's mixed aggregates
    once cold, then three warm runs under torch.profiler. Returns the
    device time of the three summed by kind (ms): the device-to-host and
    host-to-device copies, the profiler's own records, every other device
    op, and the ten device ops that took the most, with the wall ms of
    each run."""
    from vega_tpu_torch.frame import F

    ev, _dims = cs.p10_data(np)
    ctx = vt.Context(n_shards=cs.N_SHARDS)

    def run():
        return ctx.create_frame(k=ev["k"], x=ev["x"]).group_by("k").agg(
            F.sum("x"), F.min("x"), F.max("x"), F.count(),
            F.mean("x")).collect_columns()

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    ctx.stop()
    kinds = {"dtoh_ms": 0.0, "htod_ms": 0.0, "ops_ms": 0.0,
             "profiler_ms": 0.0}
    ops = []
    for e in prof.key_averages():
        # the device's own records, as the profiler's table sums them
        if e.device_type.name != "CUDA" or e.is_user_annotation:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        kind = ("dtoh_ms" if e.key.startswith("Memcpy DtoH") else
                "htod_ms" if e.key.startswith("Memcpy HtoD") else
                "profiler_ms" if e.key in ("Activity Buffer Request",
                                           "Command Buffer Full")
                else "ops_ms")
        kinds[kind] += ms
        if kind == "ops_ms":
            ops.append((ms, e.key[:70], e.count))
    ops.sort(reverse=True)
    return dict(kinds, wall_ms=walls, top_device_ops=[
        {"name": nm, "ms": ms, "calls": n} for ms, nm, n in ops[:10]])


def ab_p1516_leg(torch, np, ck, vt, cs):
    """The p1516 leg of --main-path-ab: `cs`'s phases 15 and 16 as
    chip_smoke runs them (each query once cold, held to numpy, then
    P15_WARM times warm); per query the medians (p15_timed) of the whole,
    the host build and the rest (ms)."""
    out = {}
    for phase in (cs.phase_fifteen, cs.phase_sixteen):
        for r in phase(torch, np, ck, vt)["rows"]:
            out[r["label"]] = dict(ms=r["median_ms"],
                                   host_build_ms=r["median_host_build_ms"],
                                   device_ms=r["median_device_ms"])
    return out


# the DenseRDD methods every node of a plan calls while it is built and
# materialized; the f14-profile leg reports their calls and time
F14_NODE_CHECKS = ("host_rows", "_host_form", "_host_values",
                   "_check_sortable_key", "_schema", "_fp_extra",
                   "_fingerprint")


def ab_f14_profile_leg(torch, np, ck, vt, cs):
    """The f14-profile leg of --main-path-ab: phase 16's f14_group and
    f14_join each once cold, then three warm runs timed plainly, one
    under cProfile and one under torch.profiler. Per query: the plain
    runs' wall ms; the cProfile run's host seconds in the package's
    functions (the twelve with the most own time, and F14_NODE_CHECKS'
    calls and cumulative seconds); the torch.profiler run's device ms
    (the device's own records summed) and device op count."""
    import cProfile
    import pstats

    fact, dims, _words, _perm = cs.p16_data(np)
    ctx = vt.Context(n_shards=cs.N_SHARDS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for q in ("f14_group", "f14_join"):
        def run(q=q):
            cs.p16_query(ctx, fact, dims, q).collect_columns()
            torch.cuda.synchronize()

        run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = cProfile.Profile()
        prof.runcall(run)
        stats = pstats.Stats(prof).stats
        own, checks = [], {}
        for (path, _line, fn), (_cc, calls, tt, ct, _) in stats.items():
            if "vega_tpu_torch" not in path:
                continue
            own.append((tt, f"{os.path.basename(path)}:{fn}", calls, ct))
            if fn in F14_NODE_CHECKS:
                c = checks.setdefault(fn, dict(calls=0, cum_s=0.0))
                c["calls"] += calls
                c["cum_s"] += ct
        own.sort(reverse=True)
        with torch.profiler.profile(activities=acts) as tprof:
            run()
        dev_ms, dev_ops = 0.0, 0
        for e in tprof.key_averages():
            if e.device_type.name != "CUDA" or e.is_user_annotation:
                continue
            dev_ms += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) / 1e3
            dev_ops += e.count
        out[q] = dict(
            wall_ms=walls, median_ms=statistics.median(walls),
            package_own_s=sum(tt for tt, *_ in own), node_checks=checks,
            top_own=[dict(fn=nm, own_s=tt, calls=n, cum_s=ct)
                     for tt, nm, n, ct in own[:12]],
            device_ms=dev_ms, device_ops=dev_ops)
    ctx.stop()
    return out


def ab_p16_profile_leg(torch, np, ck, vt, cs):
    """The p16-profile leg of --main-path-ab: phase 16's f13_key (two
    groups) and f12_or (1M groups, the same shape of aggregates) each
    once cold, then one warm run under torch.profiler with its memory:
    per query the wall ms, the allocator's peak above the start, the ten
    device ops that took the most (with their input shapes), the eight
    ops that allocated the most device memory, the plan of each exchange
    the warm run launched, and the (slot, out) capacities that the cold
    run sized from its destination histograms (rows per shard pair, rows
    per target shard), which the warm run reuses."""
    from vega_tpu_torch import dense_rdd, exchange_plan

    fact, dims, _words, _perm = cs.p16_data(np)
    ctx = vt.Context(n_shards=cs.N_SHARDS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for q in ("f13_key", "f12_or"):
        caps, size = [], dense_rdd._histogram_capacities
        dense_rdd._histogram_capacities = lambda *a: (caps.append(size(*a))
                                                      or caps[-1])
        try:
            cs.p16_query(ctx, fact, dims, q).collect_columns()
        finally:
            dense_rdd._histogram_capacities = size
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        plans, record = [], exchange_plan.record_plan
        exchange_plan.record_plan = lambda plan: (plans.append(plan),
                                                  record(plan))
        try:
            with torch.profiler.profile(activities=acts, profile_memory=True,
                                        record_shapes=True) as prof:
                t0 = time.perf_counter()
                cs.p16_query(ctx, fact, dims, q).collect_columns()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            exchange_plan.record_plan = record
        peak = torch.cuda.max_memory_allocated() - base
        ops, mem = [], []
        for e in prof.key_averages(group_by_input_shape=True):
            ms = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) / 1e3
            nbytes = getattr(e, "self_device_memory_usage",
                             getattr(e, "self_cuda_memory_usage", 0))
            shapes = str(e.input_shapes)[:120]
            if ms > 0:
                ops.append((ms, e.key[:70], e.count, shapes))
            if nbytes > 0:
                mem.append((nbytes, e.key[:70], e.count, shapes))
        ops.sort(reverse=True)
        mem.sort(reverse=True)
        out[q] = dict(
            wall_ms=wall, peak_bytes=peak,
            device_ms=sum(ms for ms, *_ in ops),
            top_device_ops=[dict(name=nm, ms=ms, calls=n, shapes=sh)
                            for ms, nm, n, sh in ops[:10]],
            top_memory_ops=[dict(name=nm, bytes=b, calls=n, shapes=sh)
                            for b, nm, n, sh in mem[:8]],
            exchanges=[dict(program=p.program, rounds=p.rounds,
                            est_peak_bytes=p.est_peak_bytes,
                            est_bytes_moved=p.est_bytes_moved)
                       for p in plans],
            cold_capacities=[dict(slot=a, out=b) for a, b in caps])
    ctx.stop()
    return out


def main_path_leg(leg, checkout):
    """One leg of --main-path-ab, in a process of its own: `checkout`'s
    own chip_smoke (phase_main_path, or the phase-10 tables of a frame
    leg) over its own package (its CUDA kernels built in its own tree);
    prints one JSON line."""
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
    if leg == "frame":
        res = ab_frame_leg(torch, np, ck, vt, cs)
    elif leg == "frame-profile":
        res = ab_frame_profile_leg(torch, np, ck, vt, cs)
    elif leg == "p16-profile":
        res = ab_p16_profile_leg(torch, np, ck, vt, cs)
    elif leg == "p1516":
        res = ab_p1516_leg(torch, np, ck, vt, cs)
    elif leg == "f14-profile":
        res = ab_f14_profile_leg(torch, np, ck, vt, cs)
    else:
        res = cs.phase_main_path(torch, np, ck, vt)
        res = {k: res[k] for k in (
            "rows_per_s", "median_s", "warm_s", "warm_build_ms",
            "warm_count_ms", "warm_count_device_ms", "cold_s",
            "warm_launches")}
    print(json.dumps(dict({"checkout": checkout, "leg": leg}, **res)),
          flush=True)


def main_path_ab(leg, checkouts):
    """--main-path-ab [--leg LEG] DIR...: one leg (AB_LEGS; phase 3 by
    default) of each checkout in turns on one card (e.g. the parent
    unpacked with git archive into the gitignored _ab/: _ab/parent . .
    _ab/parent), each in a process of its own. Prints one JSON line per
    leg and the card line; writes chiprun_out/ab_<leg>.json."""
    card = card_line()
    legs = []
    for checkout in checkouts:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--main-path-leg",
             leg, checkout], capture_output=True, text=True, timeout=900,
            check=False)
        if res.returncode != 0:
            fail(f"leg {checkout} failed ({res.returncode}):\n"
                 f"{res.stderr[-4000:]}")
        legs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(legs[-1]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"ab_{leg}.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"card": card, "legs": legs}, fh, indent=1)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:3] == ["--main-path-ab", "--leg"] and len(sys.argv) > 4 \
            and sys.argv[3] in AB_LEGS:
        main_path_ab(sys.argv[3], sys.argv[4:])
    elif sys.argv[1:2] == ["--main-path-ab"] and len(sys.argv) > 2:
        main_path_ab("main", sys.argv[2:])
    elif sys.argv[1:2] == ["--phase13a"] and len(sys.argv) == 3:
        phase13a_leg(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--phase13-rank"] and len(sys.argv) == 6:
        phase13_rank_leg(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         int(sys.argv[5]))
    elif sys.argv[1:2] == ["--phase13d-rank"] and len(sys.argv) == 4:
        phase13d_rank_leg(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["--phase14c-rank"] and len(sys.argv) == 4:
        phase14c_rank_leg(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["--phase26-rank"] and len(sys.argv) == 4:
        phase26_rank_leg(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["--main-path-leg"] and len(sys.argv) == 4:
        main_path_leg(sys.argv[2], sys.argv[3])
    elif sys.argv[1:3] == ["--phase", "19"] and len(sys.argv) == 3:
        phase19_leg()
    elif sys.argv[1:3] == ["--phase", "20"] and len(sys.argv) == 3:
        phase20_leg()
    elif sys.argv[1:3] == ["--phase", "21"] and len(sys.argv) == 3:
        phase21_leg()
    elif sys.argv[1:3] == ["--phase", "22"] and len(sys.argv) == 3:
        phase22_leg()
    elif sys.argv[1:3] == ["--phase", "23"] and len(sys.argv) == 3:
        phase23_leg()
    elif sys.argv[1:3] == ["--phase", "24"] and len(sys.argv) == 3:
        phase24_leg()
    elif sys.argv[1:3] == ["--phase", "25"] and len(sys.argv) == 3:
        phase25_leg()
    elif sys.argv[1:3] == ["--phase", "26"] and len(sys.argv) == 3:
        phase26_leg()
    elif sys.argv[1:3] == ["--phase", "27"] and len(sys.argv) == 3:
        phase27_main()
    elif sys.argv[1:] == ["--phase27-leg"]:
        phase27_leg()
    elif sys.argv[1:3] == ["--phase", "19"] and len(sys.argv) == 5 \
            and sys.argv[3] == "--without":
        phase19_leg(sys.argv[4])
    else:
        main()
