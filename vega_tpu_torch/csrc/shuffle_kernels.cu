// Hopper (sm_90a) kernels of the dense tier's exchange: hash bucketing, the
// small-range histogram, and stable counting-partition positions.
//
// Each kernel takes a batched [n_shards, cap] int32 tensor (rows of one
// shard are contiguous, shard s starts at s * cap) and handles every shard in
// ONE launch. The host functions return the cudaError_t of their launches;
// the Python wrappers in cuda_kernels.py allocate every output and scratch
// buffer and raise on a non-zero return. Grids are sized from the device's
// own SM count and each kernel's resident blocks per SM, queried once per
// device (and shared-memory size) and cached, so a launch's host work is a
// table read.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshuffle_kernels.so shuffle_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxBins = 256;
constexpr int kMaxDevices = 64;

// The current device, or an error (also for a device index past the caches).
cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kMaxDevices ? cudaSuccess
                                         : cudaErrorInvalidDevice;
}

// A per-device value that `query` computes once (a positive int); concurrent
// first callers may both query, and store the same value.
template <class Query>
cudaError_t cached_value(std::atomic<int>& slot, int* out, Query query) {
  int v = slot.load(std::memory_order_relaxed);
  if (v == 0) {
    const cudaError_t err = query(&v);
    if (err != cudaSuccess) return err;
    if (v < 1) v = 1;
    slot.store(v, std::memory_order_relaxed);
  }
  *out = v;
  return cudaSuccess;
}

// Streaming multiprocessors of device `dev`.
cudaError_t sm_count(int dev, int* out) {
  static std::atomic<int> cached[kMaxDevices];
  return cached_value(cached[dev], out, [dev](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
}

// Blocks per shard for a grid that walks `units` work units per shard with
// `per_block` units per block per step: about `resident` blocks per SM over
// the card's `sms` SMs, shared between the shards, never more than the work
// needs.
int grid_x_for(int64_t units, int64_t per_block, int64_t n_shards,
               int resident, int sms) {
  const int64_t want = (units + per_block - 1) / per_block;
  int64_t budget = static_cast<int64_t>(sms) * resident /
                   (n_shards > 0 ? n_shards : 1);
  if (budget < 1) budget = 1;
  return static_cast<int>(want < budget ? (want > 0 ? want : 1) : budget);
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// ---------------------------------------------------------------------------
// hash_bucket
//
// Replaces vega_tpu/tpu/pallas_kernels.py hash_bucket_pallas
// (_hash_bucket_kernel): bucket = lowbias32(uint32(key)) % n_buckets.
// Bound: memory. 4 B read and 4 B written per row, a few integer operations
// between them. Design: a grid-stride loop per shard with 16-byte int4 loads
// and stores where the shard's rows are 16-byte aligned (cap % 4 == 0 and an
// aligned base), scalar otherwise; no shared memory, nothing kept between
// rows.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int32_t bucket_of(int32_t key, uint32_t n) {
  return static_cast<int32_t>(lowbias32(static_cast<uint32_t>(key)) % n);
}

__global__ void hash_bucket_kernel(const int32_t* __restrict__ keys,
                                   int32_t* __restrict__ out, int64_t cap,
                                   uint32_t n_buckets) {
  const int64_t shard_base = static_cast<int64_t>(blockIdx.y) * cap;
  const int32_t* k = keys + shard_base;
  int32_t* o = out + shard_base;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool vec = (cap % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  if (vec) {
    const int4* k4 = reinterpret_cast<const int4*>(k);
    int4* o4 = reinterpret_cast<int4*>(o);
    const int64_t n4 = cap / 4;
    for (int64_t i = first; i < n4; i += stride) {
      int4 v = k4[i];
      v.x = bucket_of(v.x, n_buckets);
      v.y = bucket_of(v.y, n_buckets);
      v.z = bucket_of(v.z, n_buckets);
      v.w = bucket_of(v.w, n_buckets);
      o4[i] = v;
    }
  } else {
    for (int64_t i = first; i < cap; i += stride) {
      o[i] = bucket_of(k[i], n_buckets);
    }
  }
}

// ---------------------------------------------------------------------------
// digit_hist
//
// Replaces vega_tpu/tpu/pallas_kernels.py digit_hist_pallas
// (_digit_hist_kernel): per-shard counts of int32 digits in [0, n_bins),
// n_bins <= 256. Out-of-range digits are not counted; rows at or past `cap`
// are never read.
// Bound: memory, 4 B read per row (3.35 TB/s on an H100 SXM is ~3.6 rows per
// SM clock, a budget of ~35 thread instructions per row). The TPU kernel
// carries the histogram across a sequential grid in SMEM; Hopper blocks run
// in no order, so each block keeps private counts and adds them to the
// [n_shards, n_bins] output (zeroed by the launch) with one global atomic per
// non-empty bin.
// Design: a persistent grid (blockIdx.y = shard, about as many blocks as fit
// on the card's SMs) streams each shard's aligned body with 16-byte int4
// loads, kHistUnroll of them in flight per thread (64 B);
// the 0-3 rows before the first 16-byte boundary and after the last one go
// through scalar loads. Counting costs a few integer instructions per row and
// no warp vote, whatever the skew:
//   - n_bins <= 16 (the exchange's n_shards + 1 = 9): per-thread packed 8-bit
//     counters in two 64-bit registers, acc += 1 << 8 * (v & 7) into the low
//     or high word; every kFlushSteps steps (<= 240 rows, before a field can
//     reach 256) each field is summed over the warp with __reduce_add_sync.
//   - 16 < n_bins <= 256 (65, and 256 for a radix pass): per-thread private
//     packed 8-bit counters in shared memory, four bins to a word, laid out
//     [bin / 4][thread] so a thread's read-modify-write never meets another
//     lane's (conflict-free, no atomic, skew costs nothing); flushed at the
//     same period by four threads per word, each summing a quarter of the
//     threads' copies of it in 16-bit lanes (reads rotated by thread, so
//     without bank conflicts).
// ---------------------------------------------------------------------------

constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 4;   // int4 loads in flight per thread
constexpr int kFlushSteps = 15;  // 15 * 4 * 4 = 240 rows per field, < 256
constexpr int kPackedBins = 16;  // the register path's limit

// Register path: 16 8-bit fields in lo (bins 0-7) and hi (bins 8-15).
struct PackedCounter {
  uint64_t lo = 0, hi = 0;
  uint32_t mine = 0;  // lane b < n_bins: this warp's flushed count of bin b
  int n_bins;
  unsigned lane;

  __device__ PackedCounter(int bins) : n_bins(bins), lane(threadIdx.x & 31u) {}

  __device__ __forceinline__ void add(int32_t v) {
    if (static_cast<unsigned>(v) < static_cast<unsigned>(n_bins)) {
      const uint64_t inc = 1ull << ((v & 7) << 3);
      if (v & 8) {
        hi += inc;
      } else {
        lo += inc;
      }
    }
  }

  // Every thread of the warp calls this together.
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int f = 0; f < kPackedBins; ++f) {
      if (f < n_bins) {
        const uint64_t word = f < 8 ? lo : hi;
        const unsigned field =
            static_cast<unsigned>(word >> ((f & 7) << 3)) & 0xffu;
        const unsigned sum = __reduce_add_sync(kFullMask, field);
        if (lane == static_cast<unsigned>(f)) mine += sum;
      }
    }
    lo = hi = 0;
  }

  __device__ void finish(int32_t* __restrict__ hist, uint32_t* sh) {
    flush();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
    if (lane < static_cast<unsigned>(n_bins) && mine != 0) {
      atomicAdd(&sh[lane], mine);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
      if (sh[b] != 0) atomicAdd(&hist[b], static_cast<int32_t>(sh[b]));
    }
  }
};

// Shared-memory path: thread t's counter word w (bins 4w..4w+3) lives at
// words[w * kHistThreads + t].
struct PrivateCounter {
  uint32_t* words;
  uint32_t total = 0;  // thread b < n_bins: the block's flushed count of bin b
  int n_bins;
  int n_words;

  __device__ PrivateCounter(uint32_t* sh, int bins)
      : words(sh), n_bins(bins), n_words((bins + 3) >> 2) {
    for (int w = 0; w < n_words; ++w) words[w * kHistThreads + threadIdx.x] = 0;
  }

  __device__ __forceinline__ void add(int32_t v) {
    if (static_cast<unsigned>(v) < static_cast<unsigned>(n_bins)) {
      words[(v >> 2) * kHistThreads + threadIdx.x] += 1u << ((v & 3) << 3);
    }
  }

  // Every thread of the block calls this together. Thread 4w + q sums word
  // w over a quarter of the threads, its bytes two to a 16-bit lane, the
  // four quarters meet by shuffle (at most 256 * 241 < 2^16 a lane), and
  // the thread keeps byte q: bin 4w + q, its own index.
  __device__ void flush() {
    __syncthreads();
    const int w = threadIdx.x >> 2;
    const int q = threadIdx.x & 3;
    uint32_t even = 0, odd = 0;  // bytes 0 and 2, bytes 1 and 3
    if (w < n_words) {
      const uint32_t* part = words + w * kHistThreads + q * (kHistThreads / 4);
#pragma unroll 8
      for (int k = 0; k < kHistThreads / 4; ++k) {
        // rotated by thread, so the warp's loads hit 32 banks
        const uint32_t x = part[(k + threadIdx.x) & (kHistThreads / 4 - 1)];
        even += x & 0x00ff00ffu;
        odd += (x >> 8) & 0x00ff00ffu;
      }
    }
    even += __shfl_xor_sync(kFullMask, even, 1);
    even += __shfl_xor_sync(kFullMask, even, 2);
    odd += __shfl_xor_sync(kFullMask, odd, 1);
    odd += __shfl_xor_sync(kFullMask, odd, 2);
    const uint32_t pair = (q & 1) ? odd : even;
    total += (q & 2) ? pair >> 16 : pair & 0xffffu;
    __syncthreads();
    for (int v = 0; v < n_words; ++v) words[v * kHistThreads + threadIdx.x] = 0;
  }

  __device__ void finish(int32_t* __restrict__ hist, uint32_t*) {
    flush();
    if (static_cast<int>(threadIdx.x) < n_bins && total != 0) {
      atomicAdd(&hist[threadIdx.x], static_cast<int32_t>(total));
    }
  }
};

template <class Counter>
__device__ void hist_shard(const int32_t* __restrict__ d, int64_t cap,
                           Counter& c, int32_t* __restrict__ hist,
                           uint32_t* sh) {
  // head: rows before the first 16-byte boundary; body: int4s; tail: rest.
  const int64_t mis = static_cast<int64_t>(
      (reinterpret_cast<uintptr_t>(d) >> 2) & 3u);
  const int64_t head = cap < ((4 - mis) & 3) ? cap : ((4 - mis) & 3);
  const int4* body = reinterpret_cast<const int4*>(d + head);
  const int64_t n4 = (cap - head) >> 2;
  const int64_t tail = head + 4 * n4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int steps = 0;
  // The loop bound depends on the block only, so every thread flushes at
  // the same step.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n4; base += kHistUnroll * stride) {
    int4 r[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t i = base + threadIdx.x + u * stride;
      r[u] = i < n4 ? __ldg(body + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      c.add(r[u].x);
      c.add(r[u].y);
      c.add(r[u].z);
      c.add(r[u].w);
    }
    if (++steps == kFlushSteps) {
      c.flush();
      steps = 0;
    }
  }
  // At most 3 + 3 scalar rows, one per thread of block 0 (a field then holds
  // at most 241 rows).
  if (blockIdx.x == 0) {
    const int64_t j = threadIdx.x;
    if (j < head) {
      c.add(d[j]);
    } else if (j < head + (cap - tail)) {
      c.add(d[tail + j - head]);
    }
  }
  c.finish(hist, sh);
}

__global__ void __launch_bounds__(kHistThreads)
    digit_hist_packed_kernel(const int32_t* __restrict__ digits,
                             int32_t* __restrict__ hist, int64_t cap,
                             int n_bins) {
  __shared__ uint32_t sh[kPackedBins];
  PackedCounter c(n_bins);
  hist_shard(digits + static_cast<int64_t>(blockIdx.y) * cap, cap, c,
             hist + static_cast<int64_t>(blockIdx.y) * n_bins, sh);
}

__global__ void __launch_bounds__(kHistThreads)
    digit_hist_private_kernel(const int32_t* __restrict__ digits,
                              int32_t* __restrict__ hist, int64_t cap,
                              int n_bins) {
  extern __shared__ uint32_t words[];  // [ceil(n_bins / 4)][kHistThreads]
  PrivateCounter c(words, n_bins);
  hist_shard(digits + static_cast<int64_t>(blockIdx.y) * cap, cap, c,
             hist + static_cast<int64_t>(blockIdx.y) * n_bins, nullptr);
}

// ---------------------------------------------------------------------------
// partition_pos
//
// Replaces vega_tpu/tpu/pallas_kernels.py partition_pos_pallas
// (_partition_pos_kernel): pos[i] = starts[b[i]] + #{j < i : b[j] == b[i]},
// per shard, for bins in [0, n_bins), n_bins <= 256; rows whose bin is out
// of range get -1.
// Bound: memory, 4 B of buckets read and 4 B of positions written per row,
// plus the [n_shards, n_tiles, n_bins] status words (zeroed by the launch,
// written once and read back by the next tile).
// The TPU kernel carries per-bin running totals across its SEQUENTIAL grid.
// Here it is ONE launch, one pass over the column, with a decoupled look-back
// (the partition pass of Adinets & Merrill's Onesweep radix sort):
//   - Each block takes its tile from a ticket counter (atomicAdd), so tiles
//     start in ticket order and a tile only waits on tiles already running:
//     the look-back cannot deadlock. Ticket t is tile t / n_shards of shard
//     t % n_shards, so the tiles running together spread over every shard's
//     chain. The ticket decides only which block does a tile, never a
//     position: no order-dependent atomic.
//   - A tile is kPosTile rows: warp w holds rows w * 32 * kPosSlots + 32 r +
//     lane in register slot r, so each slot's load and store is 128
//     contiguous bytes per warp, and kPosSlots loads are in flight per
//     thread. A slot keeps the row's bin, then rank << 8 | bin, in one
//     register, so six blocks fit on an SM.
//   - In-tile stable ranks from a warp multisplit: max(4, ceil(log2 n_bins))
//     __ballot_sync votes (a template parameter, so the loop unrolls), each
//     folded into the mask with one XOR-select, give each lane the lanes
//     holding its bin (as fast as __match_any_sync at 9 bins, and faster at
//     65 and 256 on an H100); __popc(peers & lanemask_lt) is the lane's
//     rank in the slot, plus the warp's running count of the bin in shared
//     memory. Slots go in row order, so ranks are stable. One thread per bin
//     then scans the kPosWarps counts.
//   - Publish and look back, one thread per bin: the tile's count goes out as
//     an AGGREGATE status word, then the thread walks back over earlier tiles
//     of its shard, adding aggregates, until an INCLUSIVE word, and publishes
//     its own inclusive prefix. Flag and value share one 32-bit word (the
//     value in the low 30 bits), so a shard holds fewer than 2^30 rows; the
//     wrapper checks that.
// ---------------------------------------------------------------------------

constexpr int kPosThreads = 256;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosSlots = 16;                        // rows per thread
constexpr int kPosTile = kPosThreads * kPosSlots;    // 4096 rows
constexpr uint32_t kStatusAggregate = 1u << 30;
constexpr uint32_t kStatusInclusive = 2u << 30;
constexpr uint32_t kStatusValue = kStatusAggregate - 1u;
constexpr uint32_t kNoBin = 0xffffffffu;

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// kBits >= ceil(log2 n_bins): one ballot per bit of the bin.
template <int kBits>
__global__ void __launch_bounds__(kPosThreads, 6)
    partition_pos_kernel(const int32_t* __restrict__ bucket,
                         const int32_t* __restrict__ starts,
                         int32_t* __restrict__ pos,
                         uint32_t* __restrict__ status,
                         uint32_t* __restrict__ ticket, int64_t cap,
                         int n_shards, int n_bins, int tiles_per_shard) {
  // [warp][bin] counts, then the exclusive prefix over warps.
  __shared__ uint32_t wcount[kPosWarps][kMaxBins];
  __shared__ uint32_t bin_base[kMaxBins];
  __shared__ int ticket_sh;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ticket_sh = static_cast<int>(atomicAdd(ticket, 1u));
  for (int j = threadIdx.x; j < kPosWarps * kMaxBins; j += kPosThreads) {
    wcount[j / kMaxBins][j % kMaxBins] = 0;
  }
  __syncthreads();
  const int shard = ticket_sh % n_shards;
  const int tile = ticket_sh / n_shards;
  const int64_t shard_row = static_cast<int64_t>(shard) * cap;
  const int64_t row0 = static_cast<int64_t>(tile) * kPosTile +
                       warp * (32 * kPosSlots) + lane;

  // Slot r holds the row's bin, then (once ranked) rank << 8 | bin, or
  // kNoBin for a row outside the shard or with a bin out of range.
  uint32_t slot[kPosSlots];
#pragma unroll
  for (int r = 0; r < kPosSlots; ++r) {
    const int64_t i = row0 + 32 * r;
    slot[r] = i < cap ? static_cast<uint32_t>(__ldcs(bucket + shard_row + i))
                      : kNoBin;
  }

  const unsigned lanemask_lt = (1u << lane) - 1u;
  uint32_t* wc = wcount[warp];
#pragma unroll
  for (int r = 0; r < kPosSlots; ++r) {
    const uint32_t v = slot[r];
    const bool ok = v < static_cast<uint32_t>(n_bins);
    unsigned peers = __ballot_sync(kFullMask, ok);
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      const uint32_t bit = (v >> k) & 1u;
      // keep the lanes whose bit k equals this lane's
      peers &= ~(__ballot_sync(kFullMask, bit) ^ (0u - bit));
    }
    const unsigned below = peers & lanemask_lt;
    // the rank among this warp's rows of the same bin (< 32 * kPosSlots)
    slot[r] = ok ? (wc[v] + __popc(below)) << 8 | v : kNoBin;
    __syncwarp();
    if (ok && below == 0u) wc[v] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  const int b = threadIdx.x;  // one thread per bin from here
  if (b < n_bins) {
    uint32_t count = 0;  // this tile's rows of bin b
#pragma unroll
    for (int w = 0; w < kPosWarps; ++w) {
      const uint32_t c = wcount[w][b];
      wcount[w][b] = count;
      count += c;
    }
    uint32_t* mine = status +
        (static_cast<int64_t>(shard) * tiles_per_shard + tile) * n_bins + b;
    uint32_t excl = 0;  // rows of bin b in the shard's earlier tiles
    if (tile == 0) {
      store_status(mine, kStatusInclusive | count);
    } else {
      store_status(mine, kStatusAggregate | count);
      // Tile 0 is always inclusive: the walk stops at the latest there.
      const uint32_t* prev = mine;
      for (;;) {
        prev -= n_bins;
        uint32_t s;
        do {
          s = load_status(prev);
        } while (s == 0u);
        excl += s & kStatusValue;
        if (s & kStatusInclusive) break;
      }
      store_status(mine, kStatusInclusive | (excl + count));
    }
    bin_base[b] = static_cast<uint32_t>(
        starts[static_cast<int64_t>(shard) * n_bins + b]) + excl;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kPosSlots; ++r) {
    const int64_t i = row0 + 32 * r;
    if (i < cap) {
      const uint32_t v = slot[r] & 0xffu;
      pos[shard_row + i] =
          slot[r] != kNoBin
              ? static_cast<int32_t>(bin_base[v] + wcount[warp][v] +
                                     (slot[r] >> 8))
              : -1;
    }
  }
}

// digit_hist's shared-memory words per block at n_bins (0 on the register
// path).
size_t hist_smem(int n_bins) {
  return n_bins <= kPackedBins
             ? 0
             : sizeof(uint32_t) * ((n_bins + 3) / 4) * kHistThreads;
}

// Blocks of digit_hist's kernel for n_bins resident per SM on device `dev`,
// cached per (device, shared-memory size). The private kernel's dynamic
// shared-memory limit is raised once per device to what 256 bins need.
cudaError_t hist_blocks_per_sm(int dev, int n_bins, int* out) {
  static std::atomic<int> cached[kMaxDevices][kMaxBins / 4 + 1];
  const size_t smem = hist_smem(n_bins);
  const size_t words = smem / (sizeof(uint32_t) * kHistThreads);
  return cached_value(cached[dev][words], out, [smem](int* v) {
    if (smem == 0) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          v, digit_hist_packed_kernel, kHistThreads, 0);
    }
    const cudaError_t err = cudaFuncSetAttribute(
        digit_hist_private_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(hist_smem(kMaxBins)));
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        v, digit_hist_private_kernel, kHistThreads, smem);
  });
}

}  // namespace

extern "C" {

int vt_hash_bucket(const int32_t* keys, int32_t* out, int64_t n_shards,
                   int64_t cap, int n_buckets, void* stream) {
  if (n_shards == 0 || cap == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Each thread handles four rows per step on the vector path.
  dim3 grid(grid_x_for((cap + 3) / 4, threads, n_shards, 8, sms),
            static_cast<unsigned>(n_shards));
  hash_bucket_kernel<<<grid, threads, 0, s>>>(
      keys, out, cap, static_cast<uint32_t>(n_buckets));
  return static_cast<int>(cudaGetLastError());
}

int vt_digit_hist(const int32_t* digits, int32_t* hist, int64_t n_shards,
                  int64_t cap, int n_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(int32_t) * static_cast<size_t>(n_shards) * n_bins, s);
  if (err != cudaSuccess || n_shards == 0 || cap == 0) {
    return static_cast<int>(err);
  }
  int dev = 0, sms = 0, resident = 0;
  err = current_device(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err == cudaSuccess) err = hist_blocks_per_sm(dev, n_bins, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows one block covers per step
  const int64_t per_block =
      static_cast<int64_t>(kHistThreads) * kHistUnroll * 4;
  dim3 grid(grid_x_for(cap, per_block, n_shards, resident, sms),
            static_cast<unsigned>(n_shards));
  const size_t smem = hist_smem(n_bins);
  if (smem == 0) {
    digit_hist_packed_kernel<<<grid, kHistThreads, 0, s>>>(digits, hist, cap,
                                                           n_bins);
  } else {
    digit_hist_private_kernel<<<grid, kHistThreads, smem, s>>>(digits, hist,
                                                               cap, n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scratch vt_partition_pos takes, in uint32 words: the look-back's status
// words [n_shards, ceil(cap / kPosTile), n_bins], then the ticket counter.
int64_t vt_partition_pos_scratch_words(int64_t n_shards, int64_t cap,
                                       int n_bins) {
  return n_shards * ((cap + kPosTile - 1) / kPosTile) * n_bins + 1;
}

// scratch: vt_partition_pos_scratch_words(n_shards, cap, n_bins) uint32
// words, zeroed here, on the stream, before the one launch. cap < 2^30
// (status values).
int vt_partition_pos(const int32_t* bucket, const int32_t* starts,
                     int32_t* pos, uint32_t* scratch, int64_t n_shards,
                     int64_t cap, int n_bins, void* stream) {
  if (n_shards == 0 || cap == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (cap + kPosTile - 1) / kPosTile;
  const int64_t n_status = n_shards * n_tiles * n_bins;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(uint32_t) * static_cast<size_t>(n_status + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_bits = 0;
  while ((1 << n_bits) < n_bins) ++n_bits;
  auto kernel = partition_pos_kernel<4>;  // n_bins <= 16
  if (n_bits == 5) kernel = partition_pos_kernel<5>;
  if (n_bits == 6) kernel = partition_pos_kernel<6>;
  if (n_bits == 7) kernel = partition_pos_kernel<7>;
  if (n_bits == 8) kernel = partition_pos_kernel<8>;
  const unsigned blocks = static_cast<unsigned>(n_shards * n_tiles);
  kernel<<<blocks, kPosThreads, 0, s>>>(
      bucket, starts, pos, scratch, scratch + n_status, cap,
      static_cast<int>(n_shards), n_bins, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
