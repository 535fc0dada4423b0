"""The native shuffle runtime: the port's copy of vega_tpu/native.py.

csrc/vega_native.cpp is a CPython extension holding the host shuffle's
hot loops: the map side's one-pass hash-bucket and combine of (int,
int | float) pairs (bucket_reduce_pairs, bucket_pairs), the 16-byte row
codec (encode_pairs, decode_pairs), the reduce side's merge
(merge_encoded, and merge_state_new / feed / finish fed one bucket at a
time) and splitmix64 bucketing (hash_i64). dependency.py writes a named
monoid's buckets through it as VN01 frames and a group's as VG01 frames;
rdd/shuffled.py merges them with StreamingMerge.

The library is compiled with g++ at its first use into
vega_tpu_torch/_build/, under a file lock: the compiler writes a file
of its own and os.replace moves it into place, so threads and processes
that start together build it once and never load a half-written file.
The file's name carries a hash of the source and the flags. A driver
builds it before it spawns executors and hands them its path
(VEGA_TPU_NATIVE_LIB, distributed/backend.py); an executor loads that
file and never compiles. A build or load that fails raises VegaError
with the compiler's output: there is no silent pure-Python fallback.
The pure-Python twins below (decode_pairs_py, merge_encoded_py,
StreamingMerge(op, native=False)) stay for the tests, and for the exact
redo after an int64 overflow.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import shutil
import struct
import subprocess
import sysconfig
import threading
from typing import Optional

from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)

OP_ADD, OP_MIN, OP_MAX, OP_PROD = 0, 1, 2, 3
OP_BY_NAME = {"add": OP_ADD, "min": OP_MIN, "max": OP_MAX, "prod": OP_PROD}

_PY_OPS = {
    "add": lambda a, b: a + b,
    "min": min,
    "max": max,
    "prod": lambda a, b: a * b,
}

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "vega_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
# the executors' variable: the driver's built library, loaded as it is
# vegalint: ignore[VG010] — not a Configuration knob: the path of the library the driver built, which a backend hands each executor it spawns
LIB_ENV = "VEGA_TPU_NATIVE_LIB"
BUILD_TIMEOUT_S = 300.0


def decode_pairs_py(blob, is_int: bool):
    """The 16-byte rows (i64 key, i64 | f64 value) as a list of pairs."""
    fmt = "<qq" if is_int else "<qd"
    return [(k, v) for k, v in struct.iter_unpack(fmt, blob)]


def decode(blob, is_int: bool):
    """A native frame's rows through the library."""
    return get().decode_pairs(blob, is_int)


def merge_encoded_py(flagged_blobs, op_name: str):
    """merge_encoded in Python: exact, with Python ints."""
    op = _PY_OPS[op_name]
    combined: dict = {}
    for blob, is_int in flagged_blobs:
        for k, v in decode_pairs_py(blob, bool(is_int)):
            combined[k] = op(combined[k], v) if k in combined else v
    return list(combined.items())


class StreamingMerge:
    """The reduce side's merge of encoded buckets fed as they arrive off
    the fetch stream. finish() gives the merged pairs, or None when the
    library's int64 accumulator overflowed: the caller then redoes the
    merge on the exact Python path. native=False accumulates in a Python
    dict (exact; the tests' twin). One reduce task, one merger."""

    def __init__(self, op_name: str, native: bool = True):
        self._op = OP_BY_NAME[op_name]
        if native:
            self._nat = get()
            self._state = self._nat.merge_state_new()
            self._py_op = None
            self._acc = None
        else:
            self._nat = None
            self._state = None
            self._py_op = _PY_OPS[op_name]
            self._acc = {}

    def feed(self, payload, is_int: bool) -> None:
        if self._nat is not None:
            self._nat.merge_state_feed(self._state, payload,
                                       1 if is_int else 0, self._op)
            return
        op = self._py_op
        acc = self._acc
        for k, v in decode_pairs_py(payload, bool(is_int)):
            acc[k] = op(acc[k], v) if k in acc else v

    def finish(self):
        if self._nat is not None:
            return self._nat.merge_state_finish(self._state)
        return list(self._acc.items())


_lock = named_lock("native._lock")
_native = None


def _python_include() -> str:
    return sysconfig.get_paths()["include"]


def library_path(build_dir: Optional[str] = None) -> str:
    """Where the library of this source and these flags is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_python_include().encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(build_dir or BUILD_DIR,
                        f"_vega_native-{digest.hexdigest()[:16]}{suffix}")


def build(build_dir: Optional[str] = None) -> str:
    """The library's path, compiled first when it is not there. Threads
    and processes serialize on a lock file in the build directory; the
    compiler writes a private file that os.replace moves into place, so
    no reader sees a partial library. VegaError with the compiler's
    output when it fails."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, ".vega_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return path
            cxx = os.environ.get("CXX") or shutil.which("g++") \
                or shutil.which("c++")
            if cxx is None:
                raise VegaError("the native shuffle runtime needs a C++ "
                                "compiler (g++ or $CXX); none was found")
            include = _python_include()
            if not os.path.exists(os.path.join(include, "Python.h")):
                raise VegaError(
                    f"the native shuffle runtime needs Python.h under "
                    f"{include}; it is not there")
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [cxx, *CXX_FLAGS, f"-I{include}", SOURCE, "-o", tmp]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.SubprocessError) as e:
                raise VegaError(f"native build failed to run "
                                f"({' '.join(cmd)}): {e}") from e
            if res.returncode != 0:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise VegaError(
                    f"native build failed ({res.returncode}): "
                    f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, path)
            log.info("native shuffle runtime built: %s", path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load(path: str):
    """The extension module in the file at path; VegaError when it does
    not load."""
    try:
        loader = importlib.machinery.ExtensionFileLoader("_vega_native",
                                                         path)
        spec = importlib.util.spec_from_file_location("_vega_native", path,
                                                      loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
    except Exception as e:  # noqa: BLE001 — raised as the port's error
        raise VegaError(f"the native shuffle runtime at {path} does not "
                        f"load: {e}") from e
    return module


def get():
    """The native module of this process: the executor's library named
    by VEGA_TPU_NATIVE_LIB, else this checkout's, built at first use."""
    global _native
    if _native is not None:
        return _native
    with _lock:
        if _native is None:
            given = os.environ.get(LIB_ENV)
            if given:
                if not os.path.exists(given):
                    raise VegaError(f"{LIB_ENV}={given} does not exist: an "
                                    "executor loads its driver's library "
                                    "and never compiles")
                _native = load(given)
            else:
                _native = load(build())
    return _native
