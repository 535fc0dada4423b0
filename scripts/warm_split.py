"""Split the main path's warm run on one CUDA card into its host-side source
build and its count(), under what a harness holds between runs.

    python3 scripts/warm_split.py [--kernel-phase] [STATE ...]

chip_smoke.py times a warm run as chip_smoke.pipeline(ctx, np).count():
the host builds the lineage and the 1M-row table (numpy arrays copied to
the card) and count() runs the reduce and the join. Between its cold check
and its warm runs a harness may hold the cold check's host arrays
(chip_smoke.check_numpy's, 160 MB among them) and the cold run's joined
lineage with its blocks on the card. For each STATE in turn (two digits:
the arrays kept 1 or freed 0, the lineage kept 1 or dropped 0; default
11 00 10 01 11 00), in a fresh Context as chip_smoke.py's run_plan makes
one, this script runs the cold run and its check, then three warm runs
timed as chip_smoke.py times them ("whole") and three timed step by step
(host clock; count() also on CUDA events), each with the segments the
caching allocator took from CUDA (cudaMalloc calls) and the cyclic
garbage collections that ran inside it.
--kernel-phase first runs chip_smoke.py's kernel checks and timings, as
chip_smoke.py does before its main path. Prints one JSON line of medians
per state and the card's name and power limit; writes the runs to
chiprun_out/warm_split[_kp]_<states>.json.
"""

import gc
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
from vega_tpu_torch import block as block_lib  # noqa: E402
from vega_tpu_torch import cuda_kernels as ck  # noqa: E402

RUNS = 3
# the same name as chip_smoke.py's, so the row function below has the same
# fingerprint as chip_smoke.pipeline's and shares its capacity hints
N_KEYS = chip_smoke.N_KEYS
# (host arrays kept, cold lineage kept), in order
STATES = ("11", "00", "10", "01", "11", "00")


class _Probe:
    """cudaMalloc calls and cyclic collections (count, ms) from start()
    to read()."""

    def __init__(self):
        self.gcs, self.gc_ms, self._t = 0, 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gcs += 1
            self.gc_ms += (time.perf_counter() - self._t) * 1e3

    @staticmethod
    def _segments() -> int:
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def start(self):
        self.gcs, self.gc_ms = 0, 0.0
        self._seg = self._segments()

    def read(self) -> dict:
        return {"cuda_mallocs": self._segments() - self._seg,
                "gcs": self.gcs, "gc_ms": self.gc_ms}


def split_run(ctx, probe):
    """chip_smoke.pipeline's steps, each timed on the host clock; count()
    ends in a synchronize and is also timed on CUDA events."""
    steps = {}
    torch.cuda.synchronize()
    probe.start()
    mark = [time.perf_counter()]

    def step(name):
        t = time.perf_counter()
        steps[name] = (t - mark[0]) * 1e3
        mark[0] = t

    src = ctx.dense_range(chip_smoke.N_ROWS)
    step("dense_range_ms")
    reduced = src.map(lambda x: (x % N_KEYS, x * 0.5)).reduce_by_key(
        op="add")
    step("map_reduce_ms")
    keys = np.arange(chip_smoke.N_KEYS, dtype=np.int32)
    vals = np.arange(chip_smoke.N_KEYS, dtype=np.float32) * 2.0
    step("table_numpy_ms")
    table = ctx.dense_from_numpy(keys, vals)
    step("table_to_card_ms")
    joined = reduced.join(table)
    step("join_ms")
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    c = joined.count()
    ev1.record()
    torch.cuda.synchronize()
    step("count_ms")
    if c != N_KEYS or joined._last_attempts != 1:
        sys.exit(f"warm run count() = {c} in {joined._last_attempts} "
                 f"rounds, expected {N_KEYS} in one (hinted)")
    steps["count_events_ms"] = ev0.elapsed_time(ev1)
    steps["build_ms"] = sum(v for k, v in steps.items()
                            if k not in ("count_ms", "count_events_ms"))
    steps.update(probe.read())
    return steps


def whole_run(ctx, probe):
    torch.cuda.synchronize()
    probe.start()
    t0 = time.perf_counter()
    c = chip_smoke.pipeline(ctx, np).count()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if c != chip_smoke.N_KEYS:
        sys.exit(f"warm run count() = {c}, expected {chip_smoke.N_KEYS}")
    return {"whole_ms": ms,
            **{f"whole_{k}": v for k, v in probe.read().items()}}


def run_state(probe, arrays, lineage):
    """chip_smoke.py's run_plan order: a fresh Context, the cold run and
    its numpy check, then the warm runs with what the state holds."""
    ctx = vt.Context(n_shards=chip_smoke.N_SHARDS)
    joined = chip_smoke.pipeline(ctx, np)
    joined.count()
    cold_arrays = chip_smoke.check_numpy(np, joined, "cold")[1]
    held = [x for x, keep in ((cold_arrays, arrays), (joined, lineage))
            if keep]
    del joined, cold_arrays
    whole = [whole_run(ctx, probe) for _ in range(RUNS)]
    split = [split_run(ctx, probe) for _ in range(RUNS)]
    ctx.stop()
    del held
    return whole, split


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the card")
    card = chip_smoke.card_line()
    args = sys.argv[1:]
    kernel_phase = "--kernel-phase" in args
    states = [a for a in args if a != "--kernel-phase"] or STATES
    if any(len(a) != 2 or set(a) - set("01") for a in states):
        sys.exit(f"a STATE is two digits 0 or 1, got {states}")
    ck.build()
    if kernel_phase:
        main_cap = block_lib._round_capacity(
            -(-chip_smoke.N_ROWS // chip_smoke.N_SHARDS))
        join_cap = block_lib._round_capacity(
            -(-chip_smoke.N_KEYS // chip_smoke.N_SHARDS))
        inp = chip_smoke.make_inputs(torch, ck, main_cap, join_cap)
        chip_smoke.check_kernels(torch, ck, inp)
        chip_smoke.time_kernels(torch, ck, inp)
        del inp
        torch.cuda.empty_cache()
    probe = _Probe()
    out = []
    for code in states:
        arrays, lineage = code[0] == "1", code[1] == "1"
        whole, split = run_state(probe, arrays, lineage)
        med = {k: statistics.median(r[k] for r in whole) for k in whole[0]}
        med.update({k: statistics.median(s[k] for s in split)
                    for k in split[0]})
        state = dict(kernel_phase=kernel_phase, host_arrays=arrays,
                     cold_lineage=lineage)
        out.append(dict(state=state, whole=whole, split=split, median=med))
        print(json.dumps({**state, **med}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = (f"warm_split{'_kp' if kernel_phase else ''}_"
            f"{'-'.join(states)}.json")
    with open(os.path.join(ROOT, "chiprun_out", name), "w",
              encoding="utf-8") as fh:
        json.dump(dict(card=card, torch=torch.__version__, runs=out), fh,
                  indent=1)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
