// Hopper (sm_90a) kernels of the dense tier's exchange: hash bucketing, the
// small-range histogram, and stable counting-partition ranks.
//
// Each kernel takes a batched [n_shards, cap] int32 tensor (rows of one
// shard are contiguous, shard s starts at s * cap) and handles every shard in
// ONE launch: blockIdx.y is the shard. The host functions return the
// cudaError_t of their launches; the Python wrappers in cuda_kernels.py
// allocate every output and scratch buffer and raise on a non-zero return.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshuffle_kernels.so shuffle_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

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
// n_bins <= 256. Bound: memory, 4 B read per row. The TPU kernel carries the
// histogram across a sequential grid in SMEM; Hopper blocks run in no order,
// so each block privatises a histogram in shared memory and adds it to the
// [n_shards, n_bins] output with one global atomic per non-empty bin. Within a
// warp, lanes holding the same digit are merged with __match_any_sync first,
// so a skewed column (every row in one bin) costs one shared atomic per warp
// instead of 32 serialised ones. Rows at or past `cap` are never visited, so
// nothing is un-counted afterwards. Out-of-range digits are not counted.
// ---------------------------------------------------------------------------

constexpr int kMaxBins = 256;

__global__ void digit_hist_kernel(const int32_t* __restrict__ digits,
                                  int32_t* __restrict__ hist, int64_t cap,
                                  int n_bins) {
  __shared__ int32_t sh[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int32_t* d = digits + static_cast<int64_t>(blockIdx.y) * cap;
  const unsigned lane = threadIdx.x & 31u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // The loop bound depends on the block only, so every warp stays converged
  // for __match_any_sync; lanes past the end carry the digit -1.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < cap; base += stride) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < cap ? d[i] : -1;
    const unsigned peers = __match_any_sync(kFullMask, v);
    const bool leader = lane == static_cast<unsigned>(__ffs(peers) - 1);
    if (leader && static_cast<unsigned>(v) < static_cast<unsigned>(n_bins)) {
      atomicAdd(&sh[v], __popc(peers));
    }
  }
  __syncthreads();
  int32_t* h = hist + static_cast<int64_t>(blockIdx.y) * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    if (sh[b] != 0) atomicAdd(&h[b], sh[b]);
  }
}

// ---------------------------------------------------------------------------
// partition_pos
//
// Replaces vega_tpu/tpu/pallas_kernels.py partition_pos_pallas
// (_partition_pos_kernel): pos[i] = starts[b[i]] + #{j < i : b[j] == b[i]},
// per shard, for bins in [0, n_bins), n_bins <= 256.
// Bound: memory, 4 B of buckets read and 4 B of positions written per row
// (the bucket column is read twice, once per pass, the second time mostly
// from L2), plus the small [n_shards, n_bins, n_tiles] count array.
// The TPU kernel carries per-bin running totals across its SEQUENTIAL grid.
// Here blocks run in no order, so the rank is built in three phases, none of
// which uses an order-dependent atomic (that would break stability):
//   1. tile_count: per tile of kTile rows, per-bin counts into
//      counts[shard, bin, tile];
//   2. tile_scan: for each (shard, bin), an exclusive scan over tiles plus
//      starts[shard, bin], in place: the tile's base position for that bin;
//   3. tile_rank: in-tile stable ranks. Per warp, __match_any_sync finds the
//      lanes with the same bin and __popc(peers & lanemask_lt) is the rank
//      among them; earlier warps' per-bin counts come from a per-tile
//      [warp, bin] table in shared memory, scanned over warps.
// Rows whose bin is out of range get pos = -1.
// ---------------------------------------------------------------------------

constexpr int kTile = 1024;              // rows per tile = threads per block
constexpr int kTileWarps = kTile / 32;   // 32
constexpr int kScanThreads = 256;

__global__ void tile_count_kernel(const int32_t* __restrict__ bucket,
                                  int32_t* __restrict__ counts, int64_t cap,
                                  int n_bins, int n_tiles) {
  __shared__ int32_t sh[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int shard = blockIdx.y;
  const int tile = blockIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const int64_t i = static_cast<int64_t>(tile) * kTile + threadIdx.x;
  const int32_t v = i < cap ? bucket[static_cast<int64_t>(shard) * cap + i] : -1;
  const unsigned peers = __match_any_sync(kFullMask, v);
  if (lane == static_cast<unsigned>(__ffs(peers) - 1) &&
      static_cast<unsigned>(v) < static_cast<unsigned>(n_bins)) {
    atomicAdd(&sh[v], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    counts[(static_cast<int64_t>(shard) * n_bins + b) * n_tiles + tile] = sh[b];
  }
}

__global__ void tile_scan_kernel(int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ starts,
                                 int n_bins, int n_tiles) {
  __shared__ int32_t warp_sums[32];
  const int shard = blockIdx.y;
  const int bin = blockIdx.x;
  int32_t* row = counts + (static_cast<int64_t>(shard) * n_bins + bin) * n_tiles;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int32_t carry = starts[static_cast<int64_t>(shard) * n_bins + bin];
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int32_t v = t < n_tiles ? row[t] : 0;
    int32_t incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= static_cast<unsigned>(off)) incl += y;
    }
    if (lane == 31u) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < static_cast<unsigned>(n_warps) ? warp_sums[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(kFullMask, w, off);
        if (lane >= static_cast<unsigned>(off)) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
    if (t < n_tiles) row[t] = carry + before + incl - v;
    const int32_t total = warp_sums[n_warps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
    carry += total;
  }
}

__global__ void tile_rank_kernel(const int32_t* __restrict__ bucket,
                                 const int32_t* __restrict__ tile_base,
                                 int32_t* __restrict__ pos, int64_t cap,
                                 int n_bins, int n_tiles) {
  // [warp][bin] counts, then (after the scan) the exclusive prefix over
  // warps: 32 * 256 * 4 B = 32 KiB of static shared memory.
  __shared__ int32_t wh[kTileWarps * kMaxBins];
  const int shard = blockIdx.y;
  const int tile = blockIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kTileWarps * n_bins; j += blockDim.x) wh[j] = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(tile) * kTile + threadIdx.x;
  const int64_t row = static_cast<int64_t>(shard) * cap + i;
  const int32_t v = i < cap ? bucket[row] : -1;
  const bool ok = static_cast<unsigned>(v) < static_cast<unsigned>(n_bins);
  const unsigned peers = __match_any_sync(kFullMask, v);
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int rank = __popc(peers & lanemask_lt);
  if (ok && rank == 0) wh[warp * n_bins + v] = __popc(peers);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    int32_t acc = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      const int32_t c = wh[w * n_bins + b];
      wh[w * n_bins + b] = acc;
      acc += c;
    }
  }
  __syncthreads();
  if (i < cap) {
    pos[row] = ok ? tile_base[(static_cast<int64_t>(shard) * n_bins + v) *
                                  n_tiles + tile] +
                        wh[warp * n_bins + v] + rank
                  : -1;
  }
}

int grid_x_for(int64_t cap, int threads, int64_t n_shards) {
  // About eight resident blocks per SM over the card's 132 SMs, shared
  // between the shards; never more blocks than rows need.
  const int64_t want = (cap + threads - 1) / threads;
  int64_t budget = (132 * 8) / (n_shards > 0 ? n_shards : 1);
  if (budget < 1) budget = 1;
  return static_cast<int>(want < budget ? (want > 0 ? want : 1) : budget);
}

}  // namespace

extern "C" {

int vt_hash_bucket(const int32_t* keys, int32_t* out, int64_t n_shards,
                   int64_t cap, int n_buckets, void* stream) {
  if (n_shards == 0 || cap == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  // Each thread handles four rows per step on the vector path.
  dim3 grid(grid_x_for((cap + 3) / 4, threads, n_shards),
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
  const int threads = 256;
  dim3 grid(grid_x_for(cap, threads, n_shards), static_cast<unsigned>(n_shards));
  digit_hist_kernel<<<grid, threads, 0, s>>>(digits, hist, cap, n_bins);
  return static_cast<int>(cudaGetLastError());
}

// scratch: int32[n_shards * n_bins * n_tiles], n_tiles = ceil(cap / 1024).
int vt_partition_pos(const int32_t* bucket, const int32_t* starts,
                     int32_t* pos, int32_t* scratch, int64_t n_shards,
                     int64_t cap, int n_bins, void* stream) {
  if (n_shards == 0 || cap == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((cap + kTile - 1) / kTile);
  dim3 tiles(n_tiles, static_cast<unsigned>(n_shards));
  tile_count_kernel<<<tiles, kTile, 0, s>>>(bucket, scratch, cap, n_bins,
                                            n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 scan(n_bins, static_cast<unsigned>(n_shards));
  tile_scan_kernel<<<scan, kScanThreads, 0, s>>>(scratch, starts, n_bins,
                                                 n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_rank_kernel<<<tiles, kTile, 0, s>>>(bucket, scratch, pos, cap, n_bins,
                                           n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
