"""Dictionary encoding: string columns on the device.

Counterpart of vega_tpu/tpu/dict_encoding.py (numpy only). A device has no
string dtype, so a string column becomes an int32 CODE column plus a
host-side dictionary on the Block (Block.dicts): dicts[name][code] is the
original string. The dictionary is sorted (np.unique), so codes are RANK
codes: comparing codes compares strings, and sort / take_ordered / min /
max run on the codes as they are. Equality ops (group_by, join, distinct,
count_by_key_dense) treat the codes as any int32 column.

Two blocks encoded apart carry different dictionaries, whose codes do not
compare; dense_rdd._DictUnifyRDD remaps both sides onto one merged
dictionary (one host merge here, one device gather per column there)
before a keyed binary op. Codes decode to strings only where rows reach
the host (block._decode_dict_cols).

Everything here is '<U' / 'S' numpy arrays and int32 codes, never object
arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from vega_tpu_torch.errors import VegaError

CODE_DTYPE = np.int32


def is_string_array(src: np.ndarray) -> bool:
    """True for a column that needs dictionary encoding: a unicode or
    bytes array, or an object array whose every element is a str (a full
    pass: sniffing the first element would stringify mixed columns)."""
    if src.dtype.kind in ("U", "S"):
        return True
    if src.dtype.kind == "O":
        return len(src) > 0 and all(isinstance(x, str) for x in src.flat)
    return False


def encode_array(src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One string column -> (int32 codes, sorted dictionary). np.unique
    gives the sorted uniques and each row's index into them, so the codes
    are rank codes. An object column becomes a fixed-width '<U'
    dictionary."""
    src = np.asarray(src)
    if src.dtype.kind == "O":
        src = src.astype(np.str_)
    if len(src) == 0:
        return (np.zeros(0, dtype=CODE_DTYPE),
                np.zeros(0, dtype=src.dtype if src.dtype.kind in ("U", "S")
                         else "<U1"))
    values, codes = np.unique(src, return_inverse=True)
    return codes.astype(CODE_DTYPE, copy=False).reshape(-1), values


def encode_string_columns(
    columns: Dict[str, np.ndarray],
    dicts: Optional[Dict[str, np.ndarray]] = None,
    enabled: bool = True,
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """Replace every string column with its int32 code column; returns
    (columns, dicts), dicts mapping each encoded name to its sorted
    dictionary, merged over the `dicts` of columns a caller encoded
    already (a streamed file's chunks). Code columns pass through. With
    enabled False (Context(dense_dict_enabled=False)) a string column
    raises."""
    out_dicts: Dict[str, np.ndarray] = dict(dicts or {})
    out: Dict[str, np.ndarray] = {}
    for name, col in columns.items():
        src = np.asarray(col)
        if not is_string_array(src):
            out[name] = col
            continue
        if not enabled:
            raise VegaError(
                f"column {name!r} holds strings and dense_dict_enabled is "
                "off — string columns have no device form without "
                "dictionary encoding; use the host tier for this data")
        codes, values = encode_array(src)
        out[name] = codes
        out_dicts[name] = values
    return out, (out_dicts or None)


def merge_dicts(left: np.ndarray, right: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two sorted dictionaries -> (merged sorted dictionary, left_map,
    right_map) with merged[left_map[c]] == left[c] (resp. right). Both
    inputs and the merge are sorted, so the remap keeps rank order and a
    key-sorted block stays key-sorted through it."""
    merged = np.union1d(left, right)
    left_map = np.searchsorted(merged, left).astype(CODE_DTYPE)
    right_map = np.searchsorted(merged, right).astype(CODE_DTYPE)
    return merged, left_map, right_map


def decode_codes(codes: np.ndarray, values: np.ndarray) -> np.ndarray:
    """codes -> strings through the dictionary; an out-of-range code
    raises (indexing), never a made-up string."""
    codes = np.asarray(codes)
    if len(values) == 0 and len(codes) == 0:
        return np.zeros(0, dtype=values.dtype)
    return values[codes]
