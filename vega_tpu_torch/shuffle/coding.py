"""The coded shuffle's parity: the port's copy of
vega_tpu/shuffle/coding.py.

shuffle_replication = k costs k full copies of every map output. Under
shuffle_coding each map task instead ships its bucket row once,
zlib-compressed (wire_pack), to a peer's parity server (put_parity),
which folds it into a parity group: XOR ("xor", one parity unit) or
GF(256) Reed-Solomon ("rs(k,m)", m units, any m losses of a group
decodable). A reducer whose bucket lost its server decodes it from the
group's surviving members and the parity frames (decode_group) instead
of recomputing the map task (shuffle/fetcher.py _reconstruct).

A parity frame, one per (group, unit, reduce id), is stored in the
ordinary ShuffleStore under a reserved negative map id (parity_map_id):

    b"VP01" | u32 crc32(rest) | u32 header_len | pickled header | payload

    header = {"scheme": "xor" | "rs", "unit": j, "k": group_k,
              "members": {map_id: (member_index, bucket_length)}}
    payload = XOR_i coeff(scheme, j, index_i) * bucket_i (zero-padded to
              the longest member)

The CRC covers header and payload: a corrupt frame parses as None and
the fetch goes down the ladder (a replica, then FetchFailed and the
stage's resubmission) instead of decoding garbage. XOR's coefficients
are all ones; RS's are a Cauchy matrix over GF(256), coeff(j, i) =
inverse((255 - j) XOR i), every square submatrix of which is invertible.

The decode's scale-and-XOR runs through kernels.gf256_accumulate on the
device it is given: an executor's CPU, a driver's Context device. An
error there raises; _accumulate_np is its numpy twin for the tests.
"""

from __future__ import annotations

import logging
import pickle
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

PARITY_MAGIC = b"VP01"
# Fixed stride for the reserved negative-map_id parity namespace: the
# store key must not depend on the (configurable) m, or a config change
# between write and read would alias frames.
MAX_PARITY_UNITS = 8


def parity_map_id(group_id: int, unit: int) -> int:
    """The reserved negative map id a parity frame is stored under, so
    the store's spill, remove_shuffle and status cover parity too."""
    return -(group_id * MAX_PARITY_UNITS + unit) - 1


# --- GF(256) tables (primitive polynomial 0x11D, generator 2) -----------
def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)  # log[0] stays 0; callers mask
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    exp[255:510] = exp[0:255]  # wraparound: skip the mod-255 per lookup
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def coeff(scheme: str, unit: int, idx: int) -> int:
    """Member idx's coefficient into parity unit `unit`. XOR: all ones.
    RS: Cauchy entry inverse((255 - unit) XOR idx) — x-set {255-j} and
    y-set {i} are disjoint for k ≤ 128, m ≤ 8 (spec_from_conf clamps),
    which is exactly what makes every square submatrix invertible."""
    if scheme == "xor":
        return 1
    return gf_inv((255 - unit) ^ idx)


def gf_scale(arr: np.ndarray, c: int) -> np.ndarray:
    """c * arr over GF(256), vectorized (uint8 in, uint8 out)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if c == 0:
        return np.zeros_like(arr)
    if c == 1:
        return arr.copy()
    out = GF_EXP[GF_LOG[arr.astype(np.int32)] + int(GF_LOG[c])]
    out[arr == 0] = 0
    return out


def _accumulate_np(blocks: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """The numpy twin of kernels.gf256_accumulate: out = XOR_i
    coeff_i * blocks[i] over GF(256)."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
    logs = GF_LOG[blocks.astype(np.int32)] \
        + GF_LOG[coeffs.astype(np.int32)][:, None]
    prod = GF_EXP[logs]
    prod[(blocks == 0) | (coeffs[:, None] == 0)] = 0
    return np.bitwise_xor.reduce(prod, axis=0)


def accumulate(blocks: np.ndarray, coeffs, device) -> np.ndarray:
    """Scale-and-XOR-accumulate byte rows, the decode's hot loop, through
    kernels.gf256_accumulate on the given device ("cpu" on an executor).
    Its errors raise."""
    from vega_tpu_torch import kernels

    out = kernels.gf256_accumulate(
        np.ascontiguousarray(blocks, dtype=np.uint8),
        np.asarray(coeffs, dtype=np.uint8), device=device)
    return out.cpu().numpy()


# --- configuration ------------------------------------------------------
def spec_from_conf(conf) -> Optional[Tuple[str, int, int]]:
    """(scheme, k, m) of the coded-shuffle settings, or None when coding
    is off: "xor" groups up to coding_group_k members behind one XOR
    unit; "rs" / "rs(k,m)" uses m GF(256) units. A malformed value reads
    as off here (Context checks it when it is set)."""
    raw = str(getattr(conf, "shuffle_coding", "none") or "none")
    raw = raw.strip().lower()
    if raw in ("", "none", "off", "0"):
        return None
    k = int(getattr(conf, "coding_group_k", 4) or 4)
    m = int(getattr(conf, "coding_parity_m", 1) or 1)
    if raw == "xor":
        scheme, m = "xor", 1
    elif raw.startswith("rs"):
        scheme = "rs"
        inner = raw[2:].strip()
        if inner.startswith("(") and inner.endswith(")"):
            try:
                parts = [int(p) for p in inner[1:-1].split(",")]
                if len(parts) == 2:
                    k, m = parts
            except ValueError:
                return None
        elif inner:
            return None
    else:
        return None
    k = max(2, min(128, k))
    m = max(1, min(MAX_PARITY_UNITS, m))
    return (scheme, k, m)


# --- wire compression ---------------------------------------------------
# put_parity payloads cross the wire zlib-compressed (level 1: cheap,
# still 3-5x on pickled rows) — the lever that puts coded push bytes
# well under replication's full-copy pushes. Stored parity stays RAW:
# XOR-accumulation needs the uncompressed bytes.
def wire_pack(data: bytes) -> bytes:
    return zlib.compress(data, 1)


def wire_unpack(data: bytes) -> bytes:
    return zlib.decompress(data)


# --- parity frames ------------------------------------------------------
def build_frame(scheme: str, k: int, unit: int,
                members: Dict[int, Tuple[int, int]],
                payload: np.ndarray) -> bytes:
    header = pickle.dumps(
        {"scheme": scheme, "k": k, "unit": unit, "members": dict(members)},
        protocol=4)
    body = header + np.ascontiguousarray(payload, np.uint8).tobytes()
    return b"".join((
        PARITY_MAGIC,
        struct.pack("<II", zlib.crc32(body) & 0xFFFFFFFF, len(header)),
        body,
    ))


def parse_frame(blob: Optional[bytes]):
    """(header, payload_uint8) — or None for anything that fails the
    magic/CRC/shape checks. Corrupt parity must read as MISSING."""
    if not blob or len(blob) < 12 or blob[:4] != PARITY_MAGIC:
        return None
    crc, hlen = struct.unpack("<II", blob[4:12])
    body = blob[12:]
    if len(body) < hlen or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        return None
    try:
        header = pickle.loads(body[:hlen])
    except Exception as e:  # noqa: BLE001 — treat any malformed header as corrupt
        log.debug("parity frame header failed to unpickle (%s); "
                  "reading as missing", e)
        return None
    if not isinstance(header, dict) or "members" not in header:
        return None
    return header, np.frombuffer(body[hlen:], dtype=np.uint8)


def fold_frame(old: Optional[bytes], scheme: str, k: int, unit: int,
               map_id: int, idx: int, raw: bytes) -> bytes:
    """Accumulate one member bucket into a parity frame (read-modify-
    write; the store serializes calls per key). Raises ValueError on a
    frame that fails validation — the server then refuses the push and
    the mapper degrades to no parity coverage, never to silently-wrong
    parity with a valid CRC."""
    contrib = gf_scale(np.frombuffer(raw, dtype=np.uint8),
                       coeff(scheme, unit, idx))
    if old is None:
        return build_frame(scheme, k, unit, {map_id: (idx, len(raw))},
                           contrib)
    parsed = parse_frame(old)
    if parsed is None:
        raise ValueError("existing parity frame failed validation")
    header, payload = parsed
    if (header.get("scheme") != scheme or header.get("k") != k
            or header.get("unit") != unit):
        raise ValueError("parity frame scheme/shape mismatch")
    members = dict(header["members"])
    if map_id in members:
        raise ValueError(f"duplicate parity fold for map {map_id}")
    size = max(len(payload), len(contrib))
    buf = np.zeros(size, dtype=np.uint8)
    buf[:len(payload)] ^= payload
    buf[:len(contrib)] ^= contrib
    members[map_id] = (idx, len(raw))
    return build_frame(scheme, k, unit, members, buf)


def decode_group(scheme: str, k: int, frames: List[tuple],
                 members: Dict[int, Tuple[int, int]],
                 survivors: Dict[int, bytes],
                 missing: List[int], device="cpu") -> Dict[int, bytes]:
    """Reconstruct `missing` member buckets from surviving members plus
    parity frames [(unit, header, payload_uint8), ...]. Solves the
    r×r GF(256) system (r = len(missing)) by Gaussian elimination with
    the byte columns as the right-hand side — the elimination is O(r²)
    scalar ops plus O(r²·L) vectorized byte work, r ≤ m ≤ 8. The
    survivors' contribution runs on device.

    Raises ValueError when the system is unsolvable (more losses than
    parity units, singular matrix, member unknown to the frame) — the
    caller degrades down the ladder."""
    r = len(missing)
    if r == 0:
        return {}
    if r > len(frames):
        raise ValueError(f"{r} missing members but only {len(frames)} "
                         "parity units")
    use = sorted(frames, key=lambda f: f[0])[:r]
    for mid in missing:
        if mid not in members:
            raise ValueError(f"member {mid} not in parity frame")
    width = max(len(p) for _, _, p in use)
    mat: List[List[int]] = []
    rhs: List[np.ndarray] = []
    for unit, _header, payload in use:
        acc = np.zeros(width, dtype=np.uint8)
        acc[:len(payload)] ^= payload
        if survivors:
            blocks = np.zeros((len(survivors), width), dtype=np.uint8)
            coeffs = np.zeros(len(survivors), dtype=np.uint8)
            for i, (mid, data) in enumerate(sorted(survivors.items())):
                arr = np.frombuffer(data, dtype=np.uint8)
                blocks[i, :len(arr)] = arr
                coeffs[i] = coeff(scheme, unit, members[mid][0])
            acc ^= accumulate(blocks, coeffs, device)
        rhs.append(acc)
        mat.append([coeff(scheme, unit, members[mid][0])
                    for mid in missing])
    # Gaussian elimination over GF(256); Cauchy coefficients make the
    # matrix nonsingular whenever r ≤ units, but a defensive check stays.
    for col in range(r):
        piv = next((j for j in range(col, r) if mat[j][col]), None)
        if piv is None:
            raise ValueError("singular parity system")
        if piv != col:
            mat[col], mat[piv] = mat[piv], mat[col]
            rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = gf_inv(mat[col][col])
        mat[col] = [gf_mul(inv, a) for a in mat[col]]
        rhs[col] = gf_scale(rhs[col], inv)
        for j in range(r):
            if j != col and mat[j][col]:
                f = mat[j][col]
                mat[j] = [mat[j][t] ^ gf_mul(f, mat[col][t])
                          for t in range(r)]
                rhs[j] = rhs[j] ^ gf_scale(rhs[col], f)
    out: Dict[int, bytes] = {}
    for row, mid in enumerate(missing):
        length = members[mid][1]
        if length > width:
            raise ValueError("parity frame shorter than member bucket")
        out[mid] = rhs[row][:length].tobytes()
    return out
