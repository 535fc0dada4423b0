"""The streaming state fold of vega_tpu_torch against vega_tpu, on the CPU.

fold_pairs_device reduces a micro-batch's (key, value) pairs by key with a
named op on the dense tier and hands back a dict of Python scalars, or
None where the caller must fold on the host. Both packages get the same
pairs: integer results must be equal with equal Python types, float
results within rtol 1e-5 (both narrow float64 to float32), and the Nones
must fall on the same inputs. One departure is pinned: the port lets a
failure other than VegaError propagate where the reference returns None.
"""

import contextlib
import math
import sys

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import cuda_kernels, state_fold
from vega_tpu_torch.errors import KernelError

N_SHARDS = 8


@pytest.fixture(scope="module")
def ctxs():
    ref = v.Context("local", num_workers=2)
    port = vt.Context(device="cpu", n_shards=N_SHARDS)
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _ints(seed, n, n_keys, lo, hi):
    rng = np.random.RandomState(seed)
    return list(zip(rng.randint(0, n_keys, size=n).tolist(),
                    rng.randint(lo, hi, size=n).tolist()))


def _cases():
    rng = np.random.RandomState(3)
    big_keys = [(int(k) + (1 << 40), int(x)) for k, x in
                zip(rng.randint(-20, 20, size=500), rng.randint(0, 99, 500))]
    neg_keys = [(int(k), int(x)) for k, x in
                zip(rng.randint(-30, 0, size=500), rng.randint(-9, 9, 500))]
    wide_vals = [(int(k), (1 << 45) + int(x)) for k, x in
                 zip(rng.randint(0, 10, size=300), rng.randint(0, 1000, 300))]
    floats = [(int(k), float(x)) for k, x in
              zip(rng.randint(0, 40, size=2_000), rng.rand(2_000))]
    return [
        ("int-add", _ints(1, 3_000, 50, -1000, 1000), "add"),
        ("int-min", _ints(2, 3_000, 50, -1000, 1000), "min"),
        ("int-max", _ints(3, 3_000, 50, -1000, 1000), "max"),
        ("int-prod", _ints(4, 200, 20, 1, 3), "prod"),
        ("keys-above-2^40", big_keys, "add"),
        ("negative-keys", neg_keys, "max"),
        ("int64-values-near-2^45", wide_vals, "add"),
        ("int64-values-near-2^45-min", wide_vals, "min"),
        ("uint64-keys", [(np.uint64(k), x) for k, x in
                         _ints(5, 400, 30, 0, 50)], "add"),
        ("float-add", floats, "add"),
        ("float-max", floats, "max"),
        ("nan-under-min", [(1, float("nan")), (1, 2.0), (2, 3.0),
                           (2, 5.0)], "min"),
        ("int64-overflow", [(1, 2**62), (1, 2**62), (2, 1)], "add"),
        ("unknown-op", _ints(6, 100, 5, 0, 9), "xor"),
        ("bool-values", [(1, True), (2, False), (1, True)], "add"),
        ("str-keys", [("a", 1), ("b", 2), ("a", 3)], "add"),
        ("ragged-pairs", [(1, 2), (1, [2, 3])], "add"),
    ]


CASES = _cases()


def _same_value(got, want):
    if isinstance(want, float):
        if math.isnan(want):
            return isinstance(got, float) and math.isnan(got)
        return isinstance(got, float) and math.isclose(got, want,
                                                       rel_tol=1e-5)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("name,pairs,op", CASES, ids=[c[0] for c in CASES])
def test_fold_matches_reference(ctxs, name, pairs, op):
    from vega_tpu.tpu.state_fold import fold_pairs_device as ref_fold

    ref, port = ctxs
    want = ref_fold(ref, pairs, op)
    got = state_fold.fold_pairs_device(port, pairs, op)
    if want is None:
        assert got is None, name
        return
    assert got is not None
    assert set(got) == set(want)
    assert sorted((k, type(k).__name__) for k in got) == \
        sorted((k, type(k).__name__) for k in want)
    for k, w in want.items():
        assert _same_value(got[k], w), (name, k, got[k], w)
    if name.startswith("int"):
        host = {}
        fn = {"add": lambda a, b: a + b, "min": min, "max": max,
              "prod": lambda a, b: a * b}[op]
        for k, x in pairs:
            host[k] = fn(host[k], x) if k in host else x
        assert got == host


def test_fold_is_exact_on_a_micro_batch(ctxs):
    """A larger batch of Python ints over many keys equals a plain dict
    fold exactly, every key and value a Python int."""
    _, port = ctxs
    pairs = _ints(8, 50_000, 5_000, -10**6, 10**6)
    host = {}
    for k, x in pairs:
        host[k] = host.get(k, 0) + x
    got = state_fold.fold_pairs_device(port, pairs, "add")
    assert got == host
    assert all(type(k) is int and type(x) is int for k, x in got.items())


def test_non_vega_errors_propagate(ctxs, monkeypatch):
    """The departure: a failure other than VegaError inside the fold (a
    CUDA error here) propagates from the port, where the reference turns
    it into None and folds on the host."""
    from vega_tpu.tpu import dense_rdd as ref_dr
    from vega_tpu.tpu.state_fold import fold_pairs_device as ref_fold

    ref, port = ctxs
    pairs = _ints(9, 100, 10, 0, 9)

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(ref_dr, "dense_from_numpy", broken)
    assert ref_fold(ref, pairs, "add") is None
    monkeypatch.setattr(port, "dense_from_numpy", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        state_fold.fold_pairs_device(port, pairs, "add")


class _FailingLaunches:
    """A loaded kernel library whose every launch reports
    cudaErrorIllegalAddress (700)."""

    def __getattr__(self, name):
        return lambda *_a: 1 if name.endswith("_scratch_words") else 700


def _nvcc_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_kernels.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)


def _nvcc_fails(monkeypatch, tmp_path):
    # an interpreter handed nvcc's arguments exits non-zero
    monkeypatch.setattr(cuda_kernels, "_nvcc", lambda: sys.executable)


def _launch_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_kernels, "_load", _FailingLaunches)
    monkeypatch.setattr(cuda_kernels, "_stream", lambda _t: 0)


KERNEL_FAILURES = [("nvcc-missing", _nvcc_missing, "nvcc not found"),
                   ("nvcc-fails", _nvcc_fails, "nvcc failed"),
                   ("launch-fails", _launch_fails, "cudaError_t 700")]


@pytest.mark.parametrize("name,breaks,message", KERNEL_FAILURES,
                         ids=[c[0] for c in KERNEL_FAILURES])
def test_kernel_failures_propagate(ctxs, monkeypatch, tmp_path, name,
                                   breaks, message):
    """The departure for the port's own kernels: a hand kernel that does
    not build or does not launch raises KernelError out of the fold (a
    VegaError, but not the host-fold signal), where the reference would
    return None. The wrappers are sent down their kernel route on the
    fold's CPU tensors, with no library built, so each failure comes from
    its real raise site in cuda_kernels."""
    _, port = ctxs
    monkeypatch.setattr(cuda_kernels, "_on_cpu", lambda _name, _t: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(cuda_kernels, "_lib", None)
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_kernels, "LIBRARY", str(tmp_path / "lib.so"))
    breaks(monkeypatch, tmp_path)
    with pytest.raises(KernelError, match=message):
        state_fold.fold_pairs_device(port, _ints(10, 200, 20, 0, 9), "add")


def test_vega_error_returns_none(ctxs, monkeypatch):
    """A VegaError from the dense tier is the host-fold signal."""
    _, port = ctxs

    def refused(*_a, **_k):
        raise vt.VegaError("no device representation")
    monkeypatch.setattr(port, "dense_from_numpy", refused)
    assert state_fold.fold_pairs_device(port, [(1, 2)], "add") is None
