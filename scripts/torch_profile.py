"""Where the time of vega_tpu_torch's main path goes on one CUDA card.

    python3 scripts/torch_profile.py [--stream-1b]

Runs chip_smoke.py's bench pipeline (20,000,000 rows, 1,000,000 keys,
8 shards) warm on the card: first the reduce and the join timed apart
(host clock around work that ends in a synchronize, median of 3), then one
whole run under torch.profiler. Prints the top operations by device time,
the device's busy share of the profiled run, and the card's name and power
limit; writes the same to chiprun_out/torch_profile.json. With
--stream-1b the pipeline is chip_smoke.py phase 8a's instead: 1e9 rows
streamed in 6 chunks through the fold, then the join of the 1M sums
(the "reduce" stage is the whole streamed fold), written to
chiprun_out/torch_profile_stream_1b.json.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import vega_tpu_torch as vt  # noqa: E402


def _dev_us(evt, self_only):
    """Device microseconds of a profiler average (named differently across
    torch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the card")
    from torch.profiler import ProfilerActivity, profile

    stream_1b = "--stream-1b" in sys.argv[1:]
    card = chip_smoke.card_line()
    ctx = vt.Context(n_shards=chip_smoke.N_SHARDS)
    if stream_1b:
        src = ctx.dense_range(chip_smoke.P8_ROWS)
        n_rows, n_keys = chip_smoke.P8_ROWS, chip_smoke.P8_KEYS

        def reduce():
            return src.map(lambda x: (x % n_keys, x)).reduce_by_key(
                op="add")

        def pipeline():
            return reduce().join(chip_smoke.p8_table(ctx, np))
    else:
        n_rows, n_keys = chip_smoke.N_ROWS, chip_smoke.N_KEYS

        def pipeline():
            return chip_smoke.pipeline(ctx, np)
    pipeline().count()  # cold: build, capacity hints

    stages = {"reduce_s": [], "join_s": [], "whole_s": []}
    for _ in range(3):
        if stream_1b:  # the fold runs when reduce_by_key is called
            out = []
            stages["reduce_s"].append(_timed(lambda: out.append(reduce())))
            stages["join_s"].append(_timed(lambda: out[0].join(
                chip_smoke.p8_table(ctx, np)).count()))
        else:
            joined = pipeline()
            stages["reduce_s"].append(_timed(lambda: joined.left.block()))
            stages["join_s"].append(_timed(lambda: joined.block()))
        stages["whole_s"].append(_timed(lambda: pipeline().count()))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: pipeline().count())
    from torch.autograd import DeviceType

    averages = prof.key_averages()
    on_device = [e for e in averages
                 if getattr(e, "device_type", None) == DeviceType.CUDA]
    # device work (kernels, copies, memsets) by name
    rows = sorted(({"name": e.key, "calls": e.count,
                    "self_device_ms": _dev_us(e, True) / 1e3}
                   for e in on_device), key=lambda r: -r["self_device_ms"])
    # host operators by the device time of the work they launched
    ops = sorted(({"name": e.key, "calls": e.count,
                   "device_ms": _dev_us(e, False) / 1e3,
                   "cpu_ms": e.cpu_time_total / 1e3}
                  for e in averages if e not in on_device),
                 key=lambda r: -r["device_ms"])
    busy_ms = sum(r["self_device_ms"] for r in rows)
    out = {
        "card": card, "torch": torch.__version__,
        "n_rows": n_rows, "n_keys": n_keys,
        "stages_median_s": {k: statistics.median(v)
                            for k, v in stages.items()},
        "stages_s": stages,
        "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "top_device_work": rows[:30],
        "top_host_ops": ops[:30],
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = ("torch_profile_stream_1b.json" if stream_1b
            else "torch_profile.json")
    with open(os.path.join(ROOT, "chiprun_out", name), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    for r in rows[:20]:
        print(f"device {r['self_device_ms']:10.3f} ms  {r['calls']:5d}x  "
              f"{r['name'][:90]}")
    for r in ops[:25]:
        print(f"op     {r['device_ms']:10.3f} ms dev {r['cpu_ms']:10.3f} ms "
              f"cpu {r['calls']:5d}x  {r['name'][:70]}")
    print(json.dumps({k: out[k] for k in (
        "stages_median_s", "profiled_wall_ms", "device_busy_ms",
        "device_busy_share")}))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
