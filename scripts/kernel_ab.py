"""The three CUDA kernels of two checkouts, timed in turns on one card.

    python3 scripts/kernel_ab.py DIR_A DIR_B DIR_B DIR_A

Each DIR is the root of a checkout of this repo (for example the parent
commit unpacked with `git archive` into a gitignored directory). Each leg
runs in a process of its own, builds that checkout's CUDA kernels there and
times them on the same seeded inputs as chip_smoke.py (its make_inputs and
time_ms: 20 launches per event pair replayed from a CUDA graph, L2 flushed
before each of 5 runs; median, min, max). Prints one JSON line per leg and
the card line; writes chiprun_out/kernel_ab.json. Needs a CUDA card.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever checkout is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def leg(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    cs = _chip_smoke()
    from vega_tpu_torch import block as block_lib
    from vega_tpu_torch import cuda_kernels as ck

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the card")
    if not ck.SOURCE.startswith(os.path.abspath(checkout)):
        sys.exit(f"loaded {ck.SOURCE}, not the kernels of {checkout}")
    ck.build()
    main_cap = block_lib._round_capacity(math.ceil(cs.N_ROWS / cs.N_SHARDS))
    join_cap = block_lib._round_capacity(math.ceil(cs.N_KEYS / cs.N_SHARDS))
    inp = cs.make_inputs(torch, ck, main_cap, join_cap)
    n = cs.N_SHARDS
    out = {}

    def hist(label, b, nb):
        out[f"digit_hist {label}"] = cs.time_ms(
            torch, lambda: ck.digit_hist(b, nb))

    def pos(label, b, nb, st, copies=1):
        bs = [b] + [b.clone() for _ in range(copies - 1)]
        out[f"partition_pos {label}"] = cs.time_ms(
            torch, [lambda bb=bb: ck.partition_pos(bb, nb, st) for bb in bs])

    out["hash_bucket main [8, 3145728]"] = cs.time_ms(
        torch, lambda: ck.hash_bucket(inp["main_keys"], n))
    hist("main [8, 3145728] bins=9", inp["main_bucket"], n + 1)
    pos("main [8, 131072] bins=9 warm", inp["join_bucket"], n + 1,
        inp["join_starts"])
    pos("main [8, 131072] bins=9 cold", inp["join_bucket"], n + 1,
        inp["join_starts"], copies=16)
    pos("[8, 3145728] bins=9", inp["main_bucket"], n + 1,
        inp["main_starts"])
    for label in ("uniform", "skewed"):
        d = inp[f"radix_{label}"]
        hist(f"radix [8, 3145728] bins=256 {label}", d, 256)
        pos(f"radix [8, 3145728] bins=256 {label}", d, 256,
            inp[f"radix_{label}_starts"])
    print(json.dumps({"checkout": checkout, "ms": out}), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--leg":
        leg(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    card = _chip_smoke().card_line()
    legs = []
    for checkout in sys.argv[1:]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--leg", checkout],
            capture_output=True, text=True, timeout=600, check=False)
        if res.returncode != 0:
            sys.exit(f"leg {checkout} failed ({res.returncode}):\n"
                     f"{res.stderr[-4000:]}")
        legs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(legs[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"card": card, "legs": legs}, fh, indent=1)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
