"""Hand-written Hopper kernels of the exchange, their plain PyTorch versions
and their dispatchers: the counterpart of vega_tpu/tpu/pallas_kernels.py.

Three kernels live in csrc/shuffle_kernels.cu (CUDA C++ for sm_90a):

  hash_bucket    <- pallas_kernels.hash_bucket_pallas
  digit_hist     <- pallas_kernels.digit_hist_pallas
  partition_pos  <- pallas_kernels.partition_pos_pallas

Each takes the batched [n_shards, cap] int32 tensor of a Block column and
handles every shard in one launch. The dispatcher bucket_hist (the
reference's name) routes the exchange's bucket counts to digit_hist; each
radix pass calls digit_hist and partition_pos directly, at 256 bins for
8-bit digits and 16 for 4-bit (the reference's radix_hist / radix_pos). The
source is compiled with nvcc at first use into vega_tpu_torch/_build/ (a
shared library with a plain C interface, loaded with ctypes), so importing
this module needs neither nvcc nor a card.

Every wrapper runs its kernel on a CUDA tensor (or raises) and its plain
PyTorch version on a CPU tensor; nothing falls back. `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
from typing import Optional

import torch

from vega_tpu_torch.errors import KernelError
from vega_tpu_torch.lint.sync_witness import named_lock

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "shuffle_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libshuffle_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

MAX_BINS = 256  # the kernels' shared-memory histograms hold 256 bins
# nvcc's limit, as native.BUILD_TIMEOUT_S is g++'s: a build runs on the
# first job's driver thread, so a hung compiler must not hold it forever
BUILD_TIMEOUT_S = 300.0

# Kernel launches per wrapper: one per call on a CUDA tensor, none on CPU.
LAUNCHES = {"hash_bucket": 0, "digit_hist": 0, "partition_pos": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = named_lock("cuda_kernels._lib_lock")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                    "vega_tpu_torch are built from source at first use")


def build(verbose: bool = False) -> str:
    """Compile csrc/shuffle_kernels.cu into BUILD_DIR unless an up-to-date
    library is already there; returns the library's path. With verbose,
    ptxas reports each kernel's registers and shared memory. A compile
    that outlasts BUILD_TIMEOUT_S is killed with its whole process group and
    raises KernelError naming the command; nothing falls back."""
    if os.path.exists(LIBRARY) and \
            os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    # a session of its own: on expiry the kill reaches nvcc's children
    # (cicc, ptxas), which would otherwise hold the pipes open
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30.0)
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelError(f"nvcc did not finish within {BUILD_TIMEOUT_S:g} s: "
                          f"{' '.join(cmd)}") from None
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{err}")
    if verbose and err:
        print(err)
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader never sees half
    return LIBRARY


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.vt_hash_bucket.argtypes = [ptr, ptr, i64, i64, i32, ptr]
            lib.vt_digit_hist.argtypes = [ptr, ptr, i64, i64, i32, ptr]
            lib.vt_partition_pos.argtypes = [ptr, ptr, ptr, ptr, i64, i64,
                                             i32, ptr]
            lib.vt_partition_pos_scratch_words.argtypes = [i64, i64, i32]
            lib.vt_partition_pos_scratch_words.restype = i64
            for fn in (lib.vt_hash_bucket, lib.vt_digit_hist,
                       lib.vt_partition_pos):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_batched(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise KernelError(
            f"{name}: expected a contiguous int32 [n_shards, cap] tensor, "
            f"got {t.dtype} of shape {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _check_bins(name: str, n_bins: int) -> None:
    if not 1 <= n_bins <= MAX_BINS:
        raise KernelError(f"{name}: n_bins must lie in [1, {MAX_BINS}], "
                        f"got {n_bins}")


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise KernelError(f"{name}: tensors on {t.device} are not supported")
    return t.device.type == "cpu"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# hash_bucket
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in 16-bit halves of c so
    no product passes 2^49: a whole 32x32-bit product would overflow
    signed int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash32(col: torch.Tensor) -> torch.Tensor:
    """lowbias32 over a 32-bit column's bit pattern, as int64 values in
    [0, 2^32): bit-identical to vega_tpu.tpu.kernels.hash32. Computed in
    int64 masked to 32 bits, because torch has no uint32 shift on every
    device."""
    if col.dtype == torch.float32:
        col = col.view(torch.int32)
    x = col.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_bucket_plain(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Plain version of the hash_bucket kernel: hash32(key) % n_buckets,
    taken on the unsigned value (never a signed int32 %)."""
    return (hash32(keys) % n_buckets).to(torch.int32)


def hash_bucket(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """bucket = lowbias32(uint32(key)) % n_buckets for int32 keys
    [n_shards, cap]: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    _check_batched("hash_bucket", keys)
    if not 1 <= n_buckets < 2**31:
        raise KernelError(f"hash_bucket: n_buckets out of range: {n_buckets}")
    if _on_cpu("hash_bucket", keys):
        return hash_bucket_plain(keys, n_buckets)
    out = torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        err = _load().vt_hash_bucket(keys.data_ptr(), out.data_ptr(),
                                     keys.shape[0], keys.shape[1], n_buckets,
                                     _stream(keys))
    _check_launch("hash_bucket", err)
    LAUNCHES["hash_bucket"] += 1
    return out


# ---------------------------------------------------------------------------
# digit_hist
# ---------------------------------------------------------------------------


def digit_hist_plain(digits: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain version of the digit_hist kernel: per-shard bincount of digits
    in [0, n_bins) -> int32 [n_shards, n_bins]; other values are not
    counted."""
    n_shards = digits.shape[0]
    d = digits.to(torch.int64)
    ok = (d >= 0) & (d < n_bins)
    flat = torch.where(
        ok, d + torch.arange(n_shards, device=d.device)[:, None] * n_bins,
        n_shards * n_bins)
    hist = torch.bincount(flat.reshape(-1), minlength=n_shards * n_bins + 1)
    return hist[:-1].view(n_shards, n_bins).to(torch.int32)


def digit_hist(digits: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-shard histogram of small-range int32 digits [n_shards, cap] ->
    int32 [n_shards, n_bins], n_bins <= 256: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check_batched("digit_hist", digits)
    _check_bins("digit_hist", n_bins)
    if _on_cpu("digit_hist", digits):
        return digit_hist_plain(digits, n_bins)
    hist = torch.empty((digits.shape[0], n_bins), dtype=torch.int32,
                       device=digits.device)
    with torch.cuda.device(digits.device):
        err = _load().vt_digit_hist(digits.data_ptr(), hist.data_ptr(),
                                    digits.shape[0], digits.shape[1], n_bins,
                                    _stream(digits))
    _check_launch("digit_hist", err)
    LAUNCHES["digit_hist"] += 1
    return hist


def bucket_hist(bucket: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-bucket counts (the reference dispatcher's name): every row of
    every shard is counted, ghost rows in the top bin. Up to MAX_BINS bins
    the digit_hist kernel; above its range a per-shard bincount over
    s * n_bins + b, the rule of the reference dispatcher, which takes
    jnp.bincount above its kernel's range on every backend (so any number
    of shards works)."""
    if n_bins <= MAX_BINS:
        return digit_hist(bucket, n_bins)
    return digit_hist_plain(bucket, n_bins)


# ---------------------------------------------------------------------------
# partition_pos
# ---------------------------------------------------------------------------

MAX_POS_ROWS = 2**30  # status words keep a prefix in 30 bits


def partition_pos_plain(bucket: torch.Tensor, n_bins: int,
                        starts: torch.Tensor) -> torch.Tensor:
    """Plain version of the partition_pos kernel:
    pos[s, i] = starts[s, b] + #{j < i : bucket[s, j] == b}, b = bucket[s, i],
    for b in [0, n_bins), and -1 for a row whose bin is out of range; from
    one stable sort per shard (O(cap) memory, whatever n_bins)."""
    n_shards, cap = bucket.shape
    b = bucket.to(torch.int64)
    ok = (b >= 0) & (b < n_bins)
    b = torch.where(ok, b, n_bins)  # out-of-range rows sort after every bin
    order = torch.sort(b, dim=1, stable=True).indices
    rank_sorted = torch.empty_like(order)
    rank_sorted.scatter_(
        1, order,
        torch.arange(cap, device=b.device).expand(n_shards, cap).contiguous())
    hist = digit_hist_plain(bucket, n_bins).to(torch.int64)
    first = torch.cumsum(hist, dim=1) - hist  # where bin b begins, sorted
    bc = b.clamp(max=n_bins - 1)
    pos = (starts.to(torch.int64).gather(1, bc) + rank_sorted
           - first.gather(1, bc))
    return torch.where(ok, pos, -1).to(torch.int32)


def partition_pos_scratch_words(n_shards: int, cap: int, n_bins: int) -> int:
    """int32 words of scratch the CUDA kernel takes: its look-back status
    words [n_shards, n_tiles, n_bins], then its ticket counter. The layout
    is the kernel source's alone (needs the built library)."""
    return _load().vt_partition_pos_scratch_words(n_shards, cap, n_bins)


def partition_pos(bucket: torch.Tensor, n_bins: int,
                  starts: torch.Tensor) -> torch.Tensor:
    """Stable counting-partition positions for buckets [n_shards, cap] in
    [0, n_bins) (-1 for a row whose bin is out of range), starts int32
    [n_shards, n_bins], n_bins <= 256, cap < 2^30: the CUDA kernel (one
    launch after one memset of its scratch) on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check_batched("partition_pos", bucket)
    _check_batched("partition_pos", starts)
    _check_bins("partition_pos", n_bins)
    if starts.shape != (bucket.shape[0], n_bins) \
            or starts.device != bucket.device:
        raise KernelError(
            f"partition_pos: starts must be [{bucket.shape[0]}, {n_bins}] "
            f"on {bucket.device}, got {tuple(starts.shape)} on "
            f"{starts.device}")
    if _on_cpu("partition_pos", bucket):
        return partition_pos_plain(bucket, n_bins, starts)
    n_shards, cap = bucket.shape
    if cap >= MAX_POS_ROWS:
        raise KernelError(f"partition_pos: a shard holds {cap} rows; the CUDA "
                        f"kernel takes fewer than {MAX_POS_ROWS}")
    pos = torch.empty_like(bucket)
    # the look-back's status words and ticket counter; the launch zeroes
    # them
    scratch = torch.empty(partition_pos_scratch_words(n_shards, cap, n_bins),
                          dtype=torch.int32, device=bucket.device)
    with torch.cuda.device(bucket.device):
        err = _load().vt_partition_pos(
            bucket.data_ptr(), starts.data_ptr(), pos.data_ptr(),
            scratch.data_ptr(), n_shards, cap, n_bins, _stream(bucket))
    _check_launch("partition_pos", err)
    LAUNCHES["partition_pos"] += 1
    return pos

