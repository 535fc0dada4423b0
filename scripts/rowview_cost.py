"""The row view's cost on the main path, on one CUDA card.

    python3 scripts/rowview_cost.py [REPS]

Every row closure sees its columns through coltypes.row_view (an
as_subclass over the stored column, no copy), so each of its ops
dispatches through RowView.__torch_function__. At chip_smoke.py's
N = 20M rows and K = 1M keys, this script times each of the following
with the view ("view") and with coltypes.row_view replaced by the
identity ("plain": the closure computes on the stored tensors), the two
modes in turns (ABBA) in one process and one Context, REPS (default 20)
times each:

- build: dense_range(N).map(lambda x: (x % K, x * 0.5)), the main path's
  map with its closure traced once on the probe row, host ms;
- cols_fn: that map's column function over the 20M-row source block, the
  host us until it returns (its ops queued), and the ms to a synchronize
  and between CUDA events;
- whole: chip_smoke.pipeline(ctx, np).count() warm as phase 3 times it
  (the wall, the host build and count() apart), REPS // 2 times a mode.

Both modes' columns must be equal, and each whole run's count K. Prints
one JSON line of medians per mode, the view's cost (view - plain) and the
card's name and power limit; writes every run to
chiprun_out/rowview_cost.json. Needs a CUDA card.
"""

import contextlib
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
from vega_tpu_torch import coltypes  # noqa: E402
from vega_tpu_torch import cuda_kernels as ck  # noqa: E402
from vega_tpu_torch import dense_rdd  # noqa: E402

REPS = 20
MODES = ("view", "plain")
# the same name as chip_smoke.py's, so the closure below has the same
# fingerprint as chip_smoke.pipeline's
N_KEYS = chip_smoke.N_KEYS


@contextlib.contextmanager
def mode(name):
    """coltypes.row_view as it is ("view") or the identity ("plain")."""
    if name == "view":
        yield
        return
    saved = coltypes.row_view
    coltypes.row_view = lambda x, nb=2: x
    try:
        yield
    finally:
        coltypes.row_view = saved


def build(ctx):
    t0 = time.perf_counter()
    node = ctx.dense_range(chip_smoke.N_ROWS).map(
        lambda x: (x % N_KEYS, x * 0.5))
    return node, (time.perf_counter() - t0) * 1e3


def cols_fn_run(node, inputs):
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    out = node._cols_fn(inputs)
    ev1.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, dict(host_us=(t1 - t0) * 1e6, sync_ms=(t2 - t0) * 1e3,
                     device_ms=ev0.elapsed_time(ev1))


def whole_run(ctx):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    joined = chip_smoke.pipeline(ctx, np)
    t1 = time.perf_counter()
    c = joined.count()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if c != chip_smoke.N_KEYS:
        chip_smoke.fail(f"rowview_cost: count() = {c}")
    return dict(ms=(t2 - t0) * 1e3, build_ms=(t1 - t0) * 1e3,
                count_ms=(t2 - t1) * 1e3)


def order(i):
    return MODES if i % 2 == 0 else MODES[::-1]


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the card")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else REPS
    card = chip_smoke.card_line()
    ck.build()
    ctx = vt.Context(n_shards=chip_smoke.N_SHARDS)
    # the cold run (kernels loaded, capacity hints learnt), checked
    if chip_smoke.pipeline(ctx, np).count() != chip_smoke.N_KEYS:
        chip_smoke.fail("rowview_cost: the cold run's count")
    blk = ctx.dense_range(chip_smoke.N_ROWS).block()
    inputs = dense_rdd._row_inputs(blk.cols, blk.counts)
    runs = {m: dict(build_ms=[], cols_fn=[], whole=[]) for m in MODES}
    outs = {}
    for i in range(reps):
        for m in order(i):
            with mode(m):
                node, ms = build(ctx)
                runs[m]["build_ms"].append(ms)
                outs[m], r = cols_fn_run(node, inputs)
                runs[m]["cols_fn"].append(r)
    for nm in outs["view"]:
        if not torch.equal(coltypes.plain(outs["view"][nm]),
                           coltypes.plain(outs["plain"][nm])):
            chip_smoke.fail(f"rowview_cost: column {nm} differs between "
                            "the modes")
    del outs, inputs, blk
    for i in range(max(reps // 2, 1)):
        for m in order(i):
            with mode(m):
                runs[m]["whole"].append(whole_run(ctx))
    ctx.stop()
    med = {}
    for m in MODES:
        r = runs[m]
        med[m] = dict(
            build_ms=statistics.median(r["build_ms"]),
            **{f"cols_fn_{k}": statistics.median(x[k] for x in r["cols_fn"])
               for k in ("host_us", "sync_ms", "device_ms")},
            **{f"whole_{k}": statistics.median(x[k] for x in r["whole"])
               for k in ("ms", "build_ms", "count_ms")})
        print(json.dumps(dict(mode=m, reps=reps, **med[m])), flush=True)
    cost = {k: med["view"][k] - med["plain"][k] for k in med["view"]}
    print(json.dumps(dict(view_minus_plain=cost)), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rowview_cost.json"), "w",
              encoding="utf-8") as fh:
        json.dump(dict(card=card, torch=torch.__version__, reps=reps,
                       runs=runs, median=med, view_minus_plain=cost), fh,
                  indent=1)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
