"""Smoke run of vega_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card: print the card's name and power limit (nvidia-smi) and build
     the CUDA kernels from vega_tpu_torch/csrc at first use;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes and at edge shapes (ragged lengths,
     9/65/256 bins, a skewed bucket column): exact equality, since all
     three are integer functions; then each one's time, bound, plain
     version's time and library yardstick;
  3. main path: Context(n_shards=8) on the card runs the bench pipeline
     dense_range(N).map(lambda x: (x % K, x * 0.5)).reduce_by_key(op="add")
     .join(K-row table).count() at N = 20,000,000 rows and K = 1,000,000
     keys; the result must equal a plain numpy reference, and every
     kernel's launch count must have grown during that run. Then the warm
     rows/s, median of 3 runs.
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Exits non-zero without a result when no CUDA card is visible.
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


def time_ms(torch, fn, reps=15, warm=3):
    """Median time of fn on the card over reps, from CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(torch, ck, main_cap, join_cap):
    """Every kernel against its plain version on the card; returns the
    kernel table rows without launches."""
    from vega_tpu_torch import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_SHARDS
    i32 = torch.int32

    def rand_keys(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(i32)

    # main path shapes: the map's keys over [8, cap] for the reduce, the
    # K-row table's keys for the join
    per = math.ceil(N_ROWS / n)
    x = (torch.arange(n, device=dev)[:, None] * per
         + torch.arange(main_cap, device=dev)[None, :])
    main_keys = (x % N_KEYS).to(i32).contiguous()
    edge = torch.tensor([0, -1, -2**31, 2**31 - 1], dtype=i32, device=dev)

    # hash_bucket: main keys, random keys with edge values, ragged lengths
    for nb in (n, 9, 65, 1):
        keys = rand_keys((n, 1_000_003))
        keys[0, :4] = edge
        check_equal(
            torch, f"hash_bucket n={nb} cap=1000003",
            ck.hash_bucket(keys, nb), ck.hash_bucket_plain(keys, nb))
    check_equal(
        torch, "hash_bucket main", ck.hash_bucket(main_keys, n),
        ck.hash_bucket_plain(main_keys, n))
    sliced = rand_keys((3, 4097))[:, 1:].contiguous()  # unaligned base
    check_equal(torch, "hash_bucket cap=4096 offset rows",
                ck.hash_bucket(sliced, n), ck.hash_bucket_plain(sliced, n))

    # digit_hist: the main path's ghosted buckets (n + 1 bins), then
    # 9/65/256 bins, ragged and skewed
    counts = torch.full((n,), per, device=dev, dtype=i32)
    counts[-1] = N_ROWS - per * (n - 1)
    mask = kernels.valid_mask(main_cap, counts)
    main_bucket = torch.where(mask, ck.hash_bucket(main_keys, n), n)
    check_equal(
        torch, "digit_hist main", ck.digit_hist(main_bucket, n + 1),
        ck.digit_hist_plain(main_bucket, n + 1))
    for nb in (9, 65, 256):
        for cap in (1_000_003, 4096):
            d = torch.randint(0, nb, (n, cap), generator=gen, device=dev,
                              dtype=i32)
            skew = torch.rand((n, cap), generator=gen, device=dev) < 0.9
            d_skew = torch.where(skew, nb // 3, d).to(i32)
            for label, dd in (("uniform", d), ("skewed", d_skew)):
                check_equal(torch, f"digit_hist {label} bins={nb} cap={cap}",
                            ck.digit_hist(dd, nb), ck.digit_hist_plain(dd, nb))

    # partition_pos: the join side's [8, 131072] ghosted buckets, then
    # 9/65/256 bins with many equal buckets across tiles, ragged lengths
    tper = math.ceil(N_KEYS / n)
    tkeys = (torch.arange(n, device=dev)[:, None] * tper
             + torch.arange(join_cap, device=dev)[None, :]).to(i32)
    tcounts = torch.full((n,), tper, device=dev, dtype=i32)
    tcounts[-1] = N_KEYS - tper * (n - 1)
    tmask = kernels.valid_mask(join_cap, tcounts)
    join_bucket = torch.where(tmask, ck.hash_bucket(tkeys, n), n).to(i32)

    def starts_of(b, nb):
        h = ck.digit_hist_plain(b, nb)
        return (torch.cumsum(h, 1, dtype=i32) - h).contiguous()

    join_starts = starts_of(join_bucket, n + 1)
    check_equal(
        torch, "partition_pos main",
        ck.partition_pos(join_bucket, n + 1, join_starts),
        ck.partition_pos_plain(join_bucket, n + 1, join_starts))
    for nb in (9, 65, 256):
        for cap in (1_000_003, 131072, 1000):
            b = torch.randint(0, nb, (n, cap), generator=gen, device=dev,
                              dtype=i32)
            skew = torch.rand((n, cap), generator=gen, device=dev) < 0.8
            b = torch.where(skew, nb - 1, b).to(i32).contiguous()
            st = starts_of(b, nb)
            check_equal(torch, f"partition_pos skewed bins={nb} cap={cap}",
                        ck.partition_pos(b, nb, st),
                        ck.partition_pos_plain(b, nb, st))

    # times at the main path's shapes (every check above was exact, so
    # each max_abs_err is 0)
    rows_main = n * main_cap
    rows_join = n * join_cap
    flat = (main_bucket.to(torch.int64)
            + torch.arange(n, device=dev)[:, None] * (n + 1)).reshape(-1)
    table = []
    t_hash = bound(8 * rows_main, 10 * rows_main)
    table.append(dict(
        name="hash_bucket", shape=[n, main_cap],
        ms=time_ms(torch, lambda: ck.hash_bucket(main_keys, n)),
        plain_ms=time_ms(torch, lambda: ck.hash_bucket_plain(main_keys, n)),
        bound_ms=t_hash[0], bound_by=t_hash[1], library_ms=None,
        max_abs_err=0.0))
    t_hist = bound(4 * rows_main + 4 * n * (n + 1), 2 * rows_main)
    table.append(dict(
        name="digit_hist", shape=[n, main_cap], n_bins=n + 1,
        ms=time_ms(torch, lambda: ck.digit_hist(main_bucket, n + 1)),
        plain_ms=time_ms(torch,
                         lambda: ck.digit_hist_plain(main_bucket, n + 1)),
        bound_ms=t_hist[0], bound_by=t_hist[1],
        library_ms=time_ms(torch, lambda: torch.bincount(
            flat, minlength=n * (n + 1))),
        max_abs_err=0.0))
    t_pos = bound(8 * rows_join + 4 * n * (n + 1), 4 * rows_join)
    table.append(dict(
        name="partition_pos", shape=[n, join_cap], n_bins=n + 1,
        ms=time_ms(torch, lambda: ck.partition_pos(
            join_bucket, n + 1, join_starts)),
        plain_ms=time_ms(torch, lambda: ck.partition_pos_plain(
            join_bucket, n + 1, join_starts)),
        bound_ms=t_pos[0], bound_by=t_pos[1], library_ms=None,
        max_abs_err=0.0,
        stable_argsort_ms=time_ms(torch, lambda: torch.sort(
            join_bucket, dim=1, stable=True))))
    for row in table:
        log(f"{row['name']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} "
            f"ms by {row['bound_by']}, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']})")
    return table


def pipeline(ctx, np):
    kv = ctx.dense_range(N_ROWS).map(lambda x: (x % N_KEYS, x * 0.5))
    reduced = kv.reduce_by_key(op="add")
    table = ctx.dense_from_numpy(np.arange(N_KEYS, dtype=np.int32),
                                 np.arange(N_KEYS, dtype=np.float32) * 2.0)
    return reduced.join(table)


def phase_main_path(torch, np, ck, vt):
    ctx = vt.Context(n_shards=N_SHARDS)
    if ctx.device.type != "cuda":
        fail(f"Context() chose {ctx.device}, not the card")
    ck.reset_launches()
    t0 = time.perf_counter()
    joined = pipeline(ctx, np)
    count = joined.count()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log(f"main path (cold): count={count} in {cold_s:.3f} s, "
        f"launches {launches}")
    if count != N_KEYS:
        fail(f"count() = {count}, expected {N_KEYS}")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

    got = joined.collect_arrays()
    x = np.arange(N_ROWS, dtype=np.int64)
    sums = np.bincount(x % N_KEYS, weights=x * 0.5, minlength=N_KEYS)
    order = np.argsort(got["k"], kind="stable")
    keys = got["k"][order]
    if not np.array_equal(keys, np.arange(N_KEYS)):
        fail("joined keys differ from the numpy reference")
    lv = got["lv"][order].astype(np.float64)
    rel = np.abs(lv - sums) / np.maximum(np.abs(sums), 1e-30)
    if not np.allclose(lv, sums, rtol=1e-5, atol=0):
        fail(f"reduced sums differ from numpy: max rel err {rel.max():.3g}")
    if not np.array_equal(got["rv"][order], np.arange(N_KEYS) * 2.0):
        fail("table values differ from the numpy reference")
    log(f"main path matches numpy: max rel err of sums {rel.max():.3g}")

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = pipeline(ctx, np).count()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if c != N_KEYS:
            fail(f"warm run count() = {c}")
    ctx.stop()
    med = statistics.median(warm)
    log(f"main path warm: {warm} s, median {med:.4f} s, "
        f"{N_ROWS / med:,.0f} rows/s")
    return dict(count=count, cold_s=cold_s, warm_s=warm, median_s=med,
                rows_per_s=N_ROWS / med, max_rel_err=float(rel.max()),
                launches=launches)


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
    table = phase_kernels(torch, ck, main_cap, join_cap)

    # 3. main path
    main_path = phase_main_path(torch, np, ck, vt)

    kernels_line = {"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[r["name"]],
         "launches": main_path["launches"][r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in table]}
    kind = torch.cuda.get_device_name(0)
    details = dict(card=card, kind=kind, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s,
                   n_rows=N_ROWS, n_keys=N_KEYS, n_shards=N_SHARDS,
                   kernels=table, main_path=main_path)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w",
              encoding="utf-8") as fh:
        json.dump(details, fh, indent=1)
    print(f"main path: {main_path['rows_per_s']:.1f} rows/s warm median of 3 "
          f"({N_ROWS} rows, {N_KEYS} keys, {N_SHARDS} shards) on {card}",
          flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
