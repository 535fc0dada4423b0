// vega_tpu_torch native shuffle runtime: the host-tier shuffle hot loops
// in C++, the port's copy of the reference's native/vega_native.cpp.
//
//   bucket_reduce_pairs : hash-bucket + combine (i64 keys, i64|f64 values)
//                         in one pass over a Python sequence of pairs
//   bucket_pairs        : hash-bucket without combine (the group path)
//   merge_encoded       : reduce-side merge of encoded buckets
//   merge_state_*       : the same merge fed one bucket at a time
//   encode/decode_pairs : the 16-byte row codec of numeric shuffle buckets
//   hash_i64            : splitmix64 % n over a raw int64 buffer, equal to
//                         vega_tpu_torch.partitioner.splitmix64
//
// Integer values accumulate in int64; an int64 overflow REJECTS the whole
// call (returns None) and the caller redoes the work on the exact Python
// path, so both host paths give the same integers bit for bit. Wire rows
// are 16 bytes: an i64 key and 8 value bytes holding an f64 or an i64, by
// the bucket set's is_int flag.
//
// Built as a CPython extension by vega_tpu_torch/native.py at first use
// (g++ into vega_tpu_torch/_build/); a failed build raises there.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kMask = 0xFFFFFFFFFFFFFFFFull;

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

enum Op : int { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_PROD = 3 };

static inline double apply_op_d(int op, double a, double b) {
  switch (op) {
    case OP_ADD: return a + b;
    case OP_MIN: return a < b ? a : b;
    case OP_MAX: return a > b ? a : b;
    case OP_PROD: return a * b;
  }
  return a;
}

// Int combine with overflow detection; returns false on overflow.
static inline bool apply_op_i(int op, int64_t a, int64_t b, int64_t* out) {
  switch (op) {
    case OP_ADD: return !__builtin_add_overflow(a, b, out);
    case OP_MIN: *out = a < b ? a : b; return true;
    case OP_MAX: *out = a > b ? a : b; return true;
    case OP_PROD: return !__builtin_mul_overflow(a, b, out);
  }
  *out = a;
  return true;
}

// Dual accumulator: doubles always, int64 exactly while it stays exact.
struct Acc {
  double d;
  int64_t i;
};

struct Row {
  int64_t key;
  int64_t bits;  // f64 or i64 payload, per the frame's is_int flag
};

static inline int64_t d2bits(double d) {
  int64_t b;
  std::memcpy(&b, &d, 8);
  return b;
}

static inline double bits2d(int64_t b) {
  double d;
  std::memcpy(&d, &b, 8);
  return d;
}

// ---- helpers ---------------------------------------------------------------

// Extract (i64 key, value) from one pair. Returns false when the pair is not
// numeric (caller falls back to Python; a pending Python error means a real
// failure).
static inline bool extract_pair(PyObject* item, int64_t* key, double* d,
                                int64_t* i, bool* value_is_int) {
  if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) return false;
  PyObject* k = PyTuple_GET_ITEM(item, 0);
  PyObject* v = PyTuple_GET_ITEM(item, 1);
  if (!PyLong_CheckExact(k)) return false;
  int overflow = 0;
  *key = PyLong_AsLongLongAndOverflow(k, &overflow);
  if (overflow != 0) return false;
  if (PyFloat_CheckExact(v)) {
    *d = PyFloat_AS_DOUBLE(v);
    *i = 0;
    *value_is_int = false;
    return true;
  }
  if (PyLong_CheckExact(v)) {
    int64_t lv = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow != 0) return false;
    *d = static_cast<double>(lv);
    *i = lv;
    *value_is_int = true;
    return true;
  }
  return false;
}

static PyObject* rows_to_bytes(const std::vector<Row>& rows) {
  PyObject* out = PyBytes_FromStringAndSize(
      nullptr, static_cast<Py_ssize_t>(rows.size() * sizeof(Row)));
  if (out == nullptr) return nullptr;
  std::memcpy(PyBytes_AS_STRING(out), rows.data(), rows.size() * sizeof(Row));
  return out;
}

// Allocate an uninitialized row blob and expose its write cursor: bucket
// serializers fill rows in place — one copy per bucket instead of a
// staging vector plus memcpy.
static inline PyObject* alloc_row_blob(size_t count, Row** dst) {
  PyObject* blob = PyBytes_FromStringAndSize(
      nullptr, static_cast<Py_ssize_t>(count * sizeof(Row)));
  if (blob != nullptr) *dst = reinterpret_cast<Row*>(PyBytes_AS_STRING(blob));
  return blob;
}

static PyObject* pair_list_from_accs(
    const std::unordered_map<int64_t, Acc>& combined, bool as_int) {
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(combined.size()));
  if (out == nullptr) return nullptr;
  Py_ssize_t idx = 0;
  for (const auto& kv : combined) {
    PyObject* key = PyLong_FromLongLong(kv.first);
    PyObject* value = as_int ? PyLong_FromLongLong(kv.second.i)
                             : PyFloat_FromDouble(kv.second.d);
    if (key == nullptr || value == nullptr) {
      Py_XDECREF(key);
      Py_XDECREF(value);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject* pair = PyTuple_Pack(2, key, value);
    Py_DECREF(key);
    Py_DECREF(value);
    if (pair == nullptr) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, idx++, pair);
  }
  return out;
}


// Value-kind homogeneity tracker: the wire format types a whole bucket set
// as int OR float. A partition mixing int and float values must fall back
// to the pickle path to preserve per-value types (group_by returns the
// values themselves). kind: 0=unset, 1=int, 2=float; returns false on mix.
static inline bool track_kind(int* kind, bool value_is_int) {
  int k = value_is_int ? 1 : 2;
  if (*kind == 0) { *kind = k; return true; }
  return *kind == k;
}

// ---- module functions ------------------------------------------------------

// bucket_reduce_pairs(iterable, n_buckets, op) -> (list[bytes], is_int) | None
static PyObject* bucket_reduce_pairs(PyObject*, PyObject* args) {
  PyObject* iterable;
  Py_ssize_t n_buckets;
  int op;
  if (!PyArg_ParseTuple(args, "Oni", &iterable, &n_buckets, &op)) return nullptr;
  if (n_buckets <= 0) {
    PyErr_SetString(PyExc_ValueError, "n_buckets must be positive");
    return nullptr;
  }

  std::vector<std::unordered_map<int64_t, Acc>> buckets(
      static_cast<size_t>(n_buckets));
  PyObject* iter = PyObject_GetIter(iterable);
  if (iter == nullptr) return nullptr;

  int kind = 0;  // value-kind homogeneity (track_kind)
  PyObject* item;
  while ((item = PyIter_Next(iter)) != nullptr) {
    int64_t key;
    double dv;
    int64_t iv;
    bool value_is_int;
    if (!extract_pair(item, &key, &dv, &iv, &value_is_int) ||
        !track_kind(&kind, value_is_int)) {
      Py_DECREF(item);
      Py_DECREF(iter);
      if (PyErr_Occurred()) return nullptr;
      Py_RETURN_NONE;  // non-numeric or mixed int/float -> Python path
    }
    Py_DECREF(item);
    uint64_t h = splitmix64(static_cast<uint64_t>(key) & kMask);
    auto& bucket = buckets[h % static_cast<uint64_t>(n_buckets)];
    auto it = bucket.find(key);
    if (it == bucket.end()) {
      bucket.emplace(key, Acc{dv, iv});
    } else {
      it->second.d = apply_op_d(op, it->second.d, dv);
      if (!apply_op_i(op, it->second.i, iv, &it->second.i)) {
        // Integer accumulation overflowed int64: double semantics would
        // silently round, so reject NOW — every continuation from this
        // state ends in None (all-int -> overflow rejection; a later
        // float -> mixed-type rejection), and the Python redo starts
        // from the source iterator anyway. (item was released above.)
        Py_DECREF(iter);
        Py_RETURN_NONE;
      }
    }
  }
  Py_DECREF(iter);
  if (PyErr_Occurred()) return nullptr;
  const bool all_int = (kind != 2);

  PyObject* result = PyList_New(n_buckets);
  if (result == nullptr) return nullptr;
  for (Py_ssize_t b = 0; b < n_buckets; ++b) {
    Row* dst;
    PyObject* blob = alloc_row_blob(buckets[b].size(), &dst);
    if (blob == nullptr) { Py_DECREF(result); return nullptr; }
    for (const auto& kv : buckets[b]) {
      *dst++ = {kv.first, all_int ? kv.second.i : d2bits(kv.second.d)};
    }
    PyList_SET_ITEM(result, b, blob);
  }
  PyObject* out = Py_BuildValue("(Oi)", result, all_int ? 1 : 0);
  Py_DECREF(result);
  return out;
}

// bucket_pairs(iterable, n_buckets) -> (list[bytes], is_int) | None
static PyObject* bucket_pairs(PyObject*, PyObject* args) {
  PyObject* iterable;
  Py_ssize_t n_buckets;
  if (!PyArg_ParseTuple(args, "On", &iterable, &n_buckets)) return nullptr;
  if (n_buckets <= 0) {
    PyErr_SetString(PyExc_ValueError, "n_buckets must be positive");
    return nullptr;
  }
  std::vector<std::vector<Acc>> vals(static_cast<size_t>(n_buckets));
  std::vector<std::vector<int64_t>> keys(static_cast<size_t>(n_buckets));
  PyObject* iter = PyObject_GetIter(iterable);
  if (iter == nullptr) return nullptr;
  int kind = 0;  // homogeneity: all_int == (kind != 2) after the loop
  PyObject* item;
  while ((item = PyIter_Next(iter)) != nullptr) {
    int64_t key;
    double dv;
    int64_t iv;
    bool value_is_int;
    if (!extract_pair(item, &key, &dv, &iv, &value_is_int) ||
        !track_kind(&kind, value_is_int)) {
      Py_DECREF(item);
      Py_DECREF(iter);
      if (PyErr_Occurred()) return nullptr;
      Py_RETURN_NONE;  // non-numeric or mixed int/float -> Python path
    }
    Py_DECREF(item);
    uint64_t h = splitmix64(static_cast<uint64_t>(key) & kMask);
    size_t b = h % static_cast<uint64_t>(n_buckets);
    keys[b].push_back(key);
    vals[b].push_back({dv, iv});
  }
  Py_DECREF(iter);
  if (PyErr_Occurred()) return nullptr;
  const bool all_int = (kind != 2);

  PyObject* result = PyList_New(n_buckets);
  if (result == nullptr) return nullptr;
  for (Py_ssize_t b = 0; b < n_buckets; ++b) {
    Row* dst;
    PyObject* blob = alloc_row_blob(keys[b].size(), &dst);
    if (blob == nullptr) { Py_DECREF(result); return nullptr; }
    for (size_t r = 0; r < keys[b].size(); ++r) {
      *dst++ = {keys[b][r],
                all_int ? vals[b][r].i : d2bits(vals[b][r].d)};
    }
    PyList_SET_ITEM(result, b, blob);
  }
  PyObject* out = Py_BuildValue("(Oi)", result, all_int ? 1 : 0);
  Py_DECREF(result);
  return out;
}

// Reduce-side merge accumulator. Shared by the one-shot merge_encoded and
// the streaming merge_state_* entry points (shuffle/fetcher.py's pipelined
// fetch feeds buckets here AS THEY ARRIVE, so the merge overlaps network
// time instead of following it). Semantics are identical either way: the
// result is int-typed iff every fed blob was int-typed, and an int64
// combine overflow poisons the state — finish then reports failure and the
// caller redoes the merge with exact Python bignums.
struct MergeState {
  std::unordered_map<int64_t, Acc> combined;
  bool int_inputs = true;   // every blob int-typed so far
  bool overflowed = false;  // an int64 combine overflowed
};

static void merge_state_feed_rows(MergeState* st, const Row* rows,
                                  size_t count, int blob_is_int, int op) {
  st->int_inputs = st->int_inputs && (blob_is_int != 0);
  for (size_t r = 0; r < count; ++r) {
    double dv = blob_is_int ? static_cast<double>(rows[r].bits)
                            : bits2d(rows[r].bits);
    int64_t iv = blob_is_int ? rows[r].bits : 0;
    auto it = st->combined.find(rows[r].key);
    if (it == st->combined.end()) {
      st->combined.emplace(rows[r].key, Acc{dv, iv});
    } else {
      it->second.d = apply_op_d(op, it->second.d, dv);
      if (st->int_inputs && !st->overflowed &&
          !apply_op_i(op, it->second.i, iv, &it->second.i)) {
        st->overflowed = true;
      }
    }
  }
}

static PyObject* merge_state_result(const MergeState& st) {
  if (st.int_inputs && st.overflowed) {
    Py_RETURN_NONE;  // exact Python bignum merge instead of rounding
  }
  return pair_list_from_accs(st.combined, st.int_inputs && !st.overflowed);
}

// merge_encoded(list[(bytes, is_int)], op) -> list[(int, float|int)] | None
static PyObject* merge_encoded(PyObject*, PyObject* args) {
  PyObject* blobs;
  int op;
  if (!PyArg_ParseTuple(args, "Oi", &blobs, &op)) return nullptr;
  PyObject* seq = PySequence_Fast(blobs, "expected a sequence of (bytes, int)");
  if (seq == nullptr) return nullptr;

  MergeState st;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t idx = 0; idx < n; ++idx) {
    PyObject* entry = PySequence_Fast_GET_ITEM(seq, idx);
    PyObject* blob;
    int blob_is_int;
    if (!PyArg_ParseTuple(entry, "Oi", &blob, &blob_is_int)) {
      Py_DECREF(seq);
      return nullptr;
    }
    char* data;
    Py_ssize_t size;
    if (PyBytes_AsStringAndSize(blob, &data, &size) < 0) {
      Py_DECREF(seq);
      return nullptr;
    }
    merge_state_feed_rows(&st, reinterpret_cast<const Row*>(data),
                          static_cast<size_t>(size) / sizeof(Row),
                          blob_is_int, op);
  }
  Py_DECREF(seq);
  return merge_state_result(st);
}

// ---- streaming merge (accumulator reuse across arriving buckets) ----------

static constexpr const char* kMergeStateCapsule = "vega_tpu_torch.MergeState";

static void merge_state_destroy(PyObject* capsule) {
  delete static_cast<MergeState*>(
      PyCapsule_GetPointer(capsule, kMergeStateCapsule));
}

static MergeState* merge_state_from(PyObject* capsule) {
  return static_cast<MergeState*>(
      PyCapsule_GetPointer(capsule, kMergeStateCapsule));
}

// merge_state_new() -> capsule
static PyObject* merge_state_new(PyObject*, PyObject*) {
  MergeState* st = new (std::nothrow) MergeState();
  if (st == nullptr) return PyErr_NoMemory();
  PyObject* cap = PyCapsule_New(st, kMergeStateCapsule, merge_state_destroy);
  if (cap == nullptr) delete st;
  return cap;
}

// merge_state_feed(capsule, bytes, is_int, op) -> None
// Feeds one encoded bucket into the accumulator. Accepts any buffer
// (bytes or a memoryview over the wire payload) without copying.
static PyObject* merge_state_feed(PyObject*, PyObject* args) {
  PyObject* capsule;
  Py_buffer view;
  int is_int;
  int op;
  if (!PyArg_ParseTuple(args, "Oy*ii", &capsule, &view, &is_int, &op))
    return nullptr;
  MergeState* st = merge_state_from(capsule);
  if (st == nullptr) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  merge_state_feed_rows(st, static_cast<const Row*>(view.buf),
                        static_cast<size_t>(view.len) / sizeof(Row),
                        is_int, op);
  PyBuffer_Release(&view);
  Py_RETURN_NONE;
}

// merge_state_finish(capsule) -> list[(int, float|int)] | None
// None = an int64 combine overflowed somewhere in the stream; the caller
// must redo the whole merge on the exact pure-Python path (the state keeps
// no raw buckets, so the redo refetches — rare by construction).
static PyObject* merge_state_finish(PyObject*, PyObject* args) {
  PyObject* capsule;
  if (!PyArg_ParseTuple(args, "O", &capsule)) return nullptr;
  MergeState* st = merge_state_from(capsule);
  if (st == nullptr) return nullptr;
  return merge_state_result(*st);
}

// decode_pairs(bytes, is_int) -> list[(int, float|int)]
static PyObject* decode_pairs(PyObject*, PyObject* args) {
  PyObject* blob;
  int is_int;
  if (!PyArg_ParseTuple(args, "Op", &blob, &is_int)) return nullptr;
  char* data;
  Py_ssize_t size;
  if (PyBytes_AsStringAndSize(blob, &data, &size) < 0) return nullptr;
  size_t count = static_cast<size_t>(size) / sizeof(Row);
  const Row* rows = reinterpret_cast<const Row*>(data);
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(count));
  if (out == nullptr) return nullptr;
  for (size_t r = 0; r < count; ++r) {
    PyObject* key = PyLong_FromLongLong(rows[r].key);
    PyObject* value = is_int ? PyLong_FromLongLong(rows[r].bits)
                             : PyFloat_FromDouble(bits2d(rows[r].bits));
    if (key == nullptr || value == nullptr) {
      Py_XDECREF(key);
      Py_XDECREF(value);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject* pair = PyTuple_Pack(2, key, value);
    Py_DECREF(key);
    Py_DECREF(value);
    if (pair == nullptr) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(r), pair);
  }
  return out;
}

// encode_pairs(iterable) -> (bytes, is_int) | None
static PyObject* encode_pairs(PyObject*, PyObject* args) {
  PyObject* iterable;
  if (!PyArg_ParseTuple(args, "O", &iterable)) return nullptr;
  PyObject* iter = PyObject_GetIter(iterable);
  if (iter == nullptr) return nullptr;
  std::vector<int64_t> ks;
  std::vector<Acc> vs;
  int kind = 0;  // homogeneity: all_int == (kind != 2) after the loop
  PyObject* item;
  while ((item = PyIter_Next(iter)) != nullptr) {
    int64_t key;
    double dv;
    int64_t iv;
    bool value_is_int;
    if (!extract_pair(item, &key, &dv, &iv, &value_is_int) ||
        !track_kind(&kind, value_is_int)) {
      Py_DECREF(item);
      Py_DECREF(iter);
      if (PyErr_Occurred()) return nullptr;
      Py_RETURN_NONE;  // non-numeric or mixed int/float -> Python path
    }
    Py_DECREF(item);
    ks.push_back(key);
    vs.push_back({dv, iv});
  }
  Py_DECREF(iter);
  if (PyErr_Occurred()) return nullptr;
  const bool all_int = (kind != 2);
  std::vector<Row> rows;
  rows.reserve(ks.size());
  for (size_t r = 0; r < ks.size(); ++r) {
    rows.push_back({ks[r], all_int ? vs[r].i : d2bits(vs[r].d)});
  }
  PyObject* blob = rows_to_bytes(rows);
  if (blob == nullptr) return nullptr;
  PyObject* out = Py_BuildValue("(Oi)", blob, all_int ? 1 : 0);
  Py_DECREF(blob);
  return out;
}

// hash_i64(buffer, n_buckets) -> bytes (int64 bucket ids, same length)
static PyObject* hash_i64(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t n_buckets;
  if (!PyArg_ParseTuple(args, "y*n", &view, &n_buckets)) return nullptr;
  if (n_buckets <= 0 || view.len % 8 != 0) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "need int64 buffer and n_buckets > 0");
    return nullptr;
  }
  size_t n = static_cast<size_t>(view.len) / 8;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, view.len);
  if (out == nullptr) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  const int64_t* keys = static_cast<const int64_t*>(view.buf);
  int64_t* dst = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(out));
  for (size_t i = 0; i < n; ++i) {
    dst[i] = static_cast<int64_t>(
        splitmix64(static_cast<uint64_t>(keys[i])) %
        static_cast<uint64_t>(n_buckets));
  }
  PyBuffer_Release(&view);
  return out;
}

static PyMethodDef kMethods[] = {
    {"bucket_reduce_pairs", bucket_reduce_pairs, METH_VARARGS,
     "One-pass hash-bucket + combine over (int, number) pairs."},
    {"bucket_pairs", bucket_pairs, METH_VARARGS,
     "Hash-bucket (int, number) pairs without combining."},
    {"merge_encoded", merge_encoded, METH_VARARGS,
     "Merge encoded (bytes, is_int) buckets with a named op."},
    {"merge_state_new", merge_state_new, METH_NOARGS,
     "New streaming-merge accumulator (capsule)."},
    {"merge_state_feed", merge_state_feed, METH_VARARGS,
     "Feed one encoded bucket into a streaming-merge accumulator."},
    {"merge_state_finish", merge_state_finish, METH_VARARGS,
     "Finish a streaming merge: pair list, or None on int64 overflow."},
    {"decode_pairs", decode_pairs, METH_VARARGS,
     "Decode packed rows to a list of pairs."},
    {"encode_pairs", encode_pairs, METH_VARARGS,
     "Encode (int, number) pairs to packed rows."},
    {"hash_i64", hash_i64, METH_VARARGS,
     "splitmix64 % n_buckets over an int64 buffer."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_vega_native",
    "vega_tpu_torch native shuffle hot loops", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__vega_native(void) { return PyModule_Create(&kModule); }
