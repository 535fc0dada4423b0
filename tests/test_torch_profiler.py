"""Context.profiler(log_dir) of vega_tpu_torch, on the CPU.

The reference's Context.profiler wraps jax.profiler; the port's wraps
torch.profiler: CPU activity here (CUDA activity too on a card), written
on exit as a Chrome trace under log_dir. Checked: the trace appears,
parses as JSON and holds events; the profiled lineage's result equals
the unprofiled one and vega_tpu's; an exception in the body propagates
and the trace is still stopped and written.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu_torch as vt

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


def _pipeline(ctx, keys, vals):
    return ctx.dense_from_numpy(keys, vals).reduce_by_key(op="add").join(
        ctx.dense_from_numpy(np.arange(50, dtype=np.int32),
                             np.arange(50, dtype=np.int32) * 2))


def _traces(log_dir):
    return glob.glob(os.path.join(log_dir, "*.pt.trace.json"))


def test_trace_written_and_readable(tmp_path):
    log_dir = str(tmp_path / "trace")
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        with ctx.profiler(log_dir) as prof:
            ctx.dense_range(5000).map(lambda x: (x % 97, x)).reduce_by_key(
                op="add").count()
        assert isinstance(prof, torch.profiler.profile)
    files = _traces(log_dir)
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    assert len(events) >= 1
    names = {e.get("name", "") for e in events}
    assert any("aten::" in nm for nm in names)  # torch ops were recorded


def test_profiled_result_unchanged(tmp_path):
    """The profiled run equals the unprofiled run and the reference's."""
    from vega_tpu.env import Env

    rng = np.random.RandomState(21)
    keys = rng.randint(0, 60, 4000).astype(np.int32)
    vals = rng.randint(-100, 100, 4000).astype(np.int32)
    with vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS) as ctx:
        plain = sorted(_pipeline(ctx, keys, vals).collect())
        with ctx.profiler(str(tmp_path)):
            profiled = sorted(_pipeline(ctx, keys, vals).collect())
    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in ACCEL_PLANS}
    try:
        for k, val in ACCEL_PLANS.items():
            setattr(conf, k, val)
        exp = sorted(_pipeline(ref, keys, vals).collect())
    finally:
        for k, val in old.items():
            setattr(conf, k, val)
        ref.stop()
    assert profiled == plain == exp
    assert len(_traces(str(tmp_path))) == 1


def test_exception_propagates_and_trace_closes(tmp_path):
    """An error in the body propagates; the trace is stopped and written
    all the same, and a second profile can start after it."""
    log_dir = str(tmp_path)
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        with pytest.raises(ZeroDivisionError):
            with ctx.profiler(log_dir):
                ctx.dense_range(100).count()
                raise ZeroDivisionError("boom")
        assert len(_traces(log_dir)) == 1
        with open(_traces(log_dir)[0], encoding="utf-8") as fh:
            assert json.load(fh)["traceEvents"]
        with ctx.profiler(str(tmp_path / "again")):
            assert ctx.dense_range(100).count() == 100
        assert len(_traces(str(tmp_path / "again"))) == 1


def test_cpu_context_records_no_cuda_activity(tmp_path):
    """On a CPU Context only CPU activity is asked for (no CUDA events
    are expected without a card)."""
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        with ctx.profiler(str(tmp_path)) as prof:
            ctx.dense_range(1000).count()
    acts = prof.activities
    assert torch.profiler.ProfilerActivity.CPU in acts
    assert torch.profiler.ProfilerActivity.CUDA not in acts
