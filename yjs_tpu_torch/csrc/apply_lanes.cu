// apply_lanes: the bulk-apply scatter of the default flush.
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py apply_plan2 (:386) ->
// apply_lanes (:406) -> _doc_lanes (:372), a jitted XLA scatter.
//
// Bound on the card: bytes.  It reads the lanes vector once (2 or 4 bytes
// a lane) and stores one element per real lane (4 bytes into right_link or
// starts, 1 byte into deleted); at 3.35 TB/s a 4096-doc flush of ~6M lanes
// is a few microseconds of traffic.  The stores are scattered, so each one
// moves a whole 32-byte sector, and the latency of the three launches is
// of the same order as the traffic.
//
// Design: one launch sequence serves up to kMaxShards shards of one
// device (the shards of a doc mesh, K14, yjs_tpu/parallel/mesh.py
// sharded_apply_plan :134; K1 alone is its one-shard call).  Each shard's
// {lanes, cum, right, deleted, starts, counter, b} travels by value in a
// __grid_constant__ struct, blockIdx.y picks the shard, and the section
// widths are the same for every shard.  Three launches:
// - (A) the count scan, grid (4, shards): a block scans one of a shard's
//   four [B] per-doc count vectors into its [4, B] int32 cum scratch;
// - (B) the dense, head and delete sections, grid (their blocks, shards):
//   a block belongs to one section; they write three different tables
//   (right_link, starts, deleted), so no order among them is needed;
// - (C) the sparse section after them: dense and sparse both write
//   right_link and the reference's sequential scatters let sparse win
//   where both write a row.
// One thread a lane: coalesced lane loads, a binary search over the
// section's cumsum (16 KB for B = 4096, L1/L2-resident), and a store
// masked on both the doc and the row: lanes past the total and padded
// rows (cap+1, S+1) are dropped, as JAX's mode="drop" drops them.  Lanes
// are read at their stored width (int16 or int32) and sign-extended in
// registers, so an i16 buffer is never widened in a separate pass.  A
// shard with no docs exits at once.  The host entry launches more shards
// in rounds.
//
// The shard of a doc mesh also wants its progress counters: integrated =
// the sum of the dense and sparse counts, deleted = the sum of the delete
// counts.  The count scan already has those totals, so with a counter
// pointer its blocks 0, 1 and 3 add them (int32, wrapping like the
// reference's int32 sum) into the shard's zeroed [2] counter with one
// atomic each; no second pass reads the header again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kLaneThreads = 256;
// the most shards one launch sequence takes (rows of 56 bytes)
constexpr int kMaxShards = 16;

enum Section { kDense = 0, kSparse = 1, kHeads = 2, kDels = 3 };

// One shard: its lanes (int16 or int32), [4, b] cum scratch, tables,
// [2] progress counter (or null) and doc count.
struct ApplyShard {
  const void* lanes;
  int32_t* cum;
  int32_t* right;
  uint8_t* deleted;
  int32_t* starts;
  int32_t* counter;
  int64_t b;
};

struct ApplyShards {
  ApplyShard s[kMaxShards];
};

// (A) Inclusive cumsum of a shard's four count vectors: cum[v*b + i] = sum
// of lanes[v*b .. v*b+i].  One block per vector; each thread sums a
// contiguous run, a Hillis-Steele scan over the run totals gives offsets.
template <typename T>
__global__ void scan_counts(const __grid_constant__ ApplyShards shards) {
  __shared__ int32_t part[kScanThreads];
  const ApplyShard& sh = shards.s[blockIdx.y];
  const int b = (int)sh.b;
  if (b <= 0) return;  // the whole block: before any barrier
  const T* cnt = static_cast<const T*>(sh.lanes) + (size_t)blockIdx.x * b;
  int32_t* out = sh.cum + (size_t)blockIdx.x * b;
  const int per = (b + blockDim.x - 1) / blockDim.x;
  const int lo = min(b, (int)threadIdx.x * per);
  const int hi = min(b, lo + per);
  int32_t s = 0;
  for (int i = lo; i < hi; ++i) s += (int32_t)cnt[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int32_t t = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += t;
    __syncthreads();
  }
  int32_t run = threadIdx.x ? part[threadIdx.x - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    run += (int32_t)cnt[i];
    out[i] = run;
  }
  // the section total: dense + sparse into counter[0], deletes into [1]
  if (sh.counter != nullptr && threadIdx.x == 0 && blockIdx.x != kHeads) {
    atomicAdd(&sh.counter[blockIdx.x == kDels ? 1 : 0], part[blockDim.x - 1]);
  }
}

// First d with cum[d] > lane (searchsorted side="right"), clipped to b-1.
__device__ __forceinline__ int doc_of(const int32_t* __restrict__ cum, int b,
                                      int32_t lane) {
  int lo = 0, hi = b;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (cum[mid] <= lane) lo = mid + 1; else hi = mid;
  }
  return min(lo, b - 1);
}

// JAX scatter index rules: a negative index counts from the end, what is
// still outside [0, n) is dropped.  Returns -1 for a dropped index.
__device__ __forceinline__ int64_t norm_index(int32_t r, int n) {
  int64_t x = r < 0 ? (int64_t)r + n : (int64_t)r;
  return (x >= 0 && x < n) ? x : -1;
}

// Lane i of section kSec (k lanes from lanes[off]) of a shard of b docs.
template <typename T, int kSec>
__device__ __forceinline__ void apply_lane(const ApplyShard& sh, int b,
                                           int n1, int s1, int off, int k,
                                           int i) {
  if (i >= k) return;
  const T* __restrict__ lanes = static_cast<const T*>(sh.lanes);
  const int32_t* cum = sh.cum + (size_t)kSec * b;
  const int d = doc_of(cum, b, i);
  if (kSec == kDense) {
    if (i >= cum[b - 1]) return;  // past the total: dropped
    const int32_t cnt = (int32_t)lanes[(size_t)kDense * b + d];
    const int32_t within = i - (cum[d] - cnt);
    const int64_t r = norm_index(within, n1);
    if (r < 0) return;
    sh.right[(size_t)d * n1 + r] = (int32_t)lanes[off + i];
  } else if (kSec == kSparse) {
    const int64_t r = norm_index((int32_t)lanes[off + i], n1);
    if (r < 0) return;
    sh.right[(size_t)d * n1 + r] = (int32_t)lanes[off + k + i];
  } else if (kSec == kHeads) {
    const int64_t s = norm_index((int32_t)lanes[off + i], s1);
    if (s < 0) return;
    sh.starts[(size_t)d * s1 + s] = (int32_t)lanes[off + k + i];
  } else {
    const int64_t r = norm_index((int32_t)lanes[off + i], n1);
    if (r < 0) return;
    sh.deleted[(size_t)d * n1 + r] = 1;
  }
}

__host__ __device__ __forceinline__ int lane_blocks(int k) {
  return (k + kLaneThreads - 1) / kLaneThreads;
}

// (B) dense, heads and deletes: the first lane_blocks(k_dn) blocks of a
// shard take the dense lanes, the next the heads, the rest the deletes.
template <typename T>
__global__ void __launch_bounds__(kLaneThreads)
    apply_dense_heads_dels(const __grid_constant__ ApplyShards shards, int n1,
                           int s1, int k_dn, int k_sp, int k_h, int k_d) {
  const ApplyShard& sh = shards.s[blockIdx.y];
  const int b = (int)sh.b;
  if (b <= 0) return;
  const int off_dn = 4 * b;
  const int off_h = off_dn + k_dn + 2 * k_sp;
  int blk = blockIdx.x;
  const int nb_dn = lane_blocks(k_dn), nb_h = lane_blocks(k_h);
  if (blk < nb_dn) {
    apply_lane<T, kDense>(sh, b, n1, s1, off_dn, k_dn,
                          blk * kLaneThreads + threadIdx.x);
  } else if ((blk -= nb_dn) < nb_h) {
    apply_lane<T, kHeads>(sh, b, n1, s1, off_h, k_h,
                          blk * kLaneThreads + threadIdx.x);
  } else {
    blk -= nb_h;
    apply_lane<T, kDels>(sh, b, n1, s1, off_h + 2 * k_h, k_d,
                         blk * kLaneThreads + threadIdx.x);
  }
}

// (C) the sparse section, after (B)'s dense writes.
template <typename T>
__global__ void __launch_bounds__(kLaneThreads)
    apply_sparse(const __grid_constant__ ApplyShards shards, int n1, int s1,
                 int k_dn, int k_sp) {
  const ApplyShard& sh = shards.s[blockIdx.y];
  const int b = (int)sh.b;
  if (b <= 0) return;
  apply_lane<T, kSparse>(sh, b, n1, s1, 4 * b + k_dn, k_sp,
                         blockIdx.x * kLaneThreads + threadIdx.x);
}

// desc: n_shards rows of 7 int64 — the data_ptr of lanes, cum, right,
// deleted, starts and counter (0 for none), then the doc count b — every
// shard on the current device; the widths are every shard's.
template <typename T>
int apply_lanes_sharded(const long long* desc, int n_shards, int n1, int s1,
                        int k_dn, int k_sp, int k_h, int k_d,
                        cudaStream_t stream) {
  constexpr int kRow = 7;
  if (n_shards < 0 || k_dn < 0 || k_sp < 0 || k_h < 0 || k_d < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb_mixed = lane_blocks(k_dn) + lane_blocks(k_h) + lane_blocks(k_d);
  for (int base = 0; base < n_shards; base += kMaxShards) {
    const int n = n_shards - base < kMaxShards ? n_shards - base : kMaxShards;
    ApplyShards p;
    long long max_b = 0;
    for (int k = 0; k < kMaxShards; ++k) {
      const long long* r = desc + kRow * (base + (k < n ? k : 0));
      ApplyShard& sh = p.s[k];
      sh.lanes = reinterpret_cast<const void*>(r[0]);
      sh.cum = reinterpret_cast<int32_t*>(r[1]);
      sh.right = reinterpret_cast<int32_t*>(r[2]);
      sh.deleted = reinterpret_cast<uint8_t*>(r[3]);
      sh.starts = reinterpret_cast<int32_t*>(r[4]);
      sh.counter = reinterpret_cast<int32_t*>(r[5]);
      sh.b = k < n ? r[6] : 0;
      if (sh.b > max_b) max_b = sh.b;
    }
    if (max_b <= 0) continue;
    scan_counts<T><<<dim3(4, n), kScanThreads, 0, stream>>>(p);
    if (nb_mixed > 0) {
      apply_dense_heads_dels<T><<<dim3(nb_mixed, n), kLaneThreads, 0,
                                  stream>>>(p, n1, s1, k_dn, k_sp, k_h, k_d);
    }
    if (k_sp > 0) {
      apply_sparse<T><<<dim3(lane_blocks(k_sp), n), kLaneThreads, 0,
                        stream>>>(p, n1, s1, k_dn, k_sp);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

constexpr int kSharedThreads = 256;
constexpr int64_t kSharedMaxBlocks = 1 << 20;

__global__ void apply_shared(const int32_t* __restrict__ lanes,
                             int32_t* __restrict__ right,
                             uint8_t* __restrict__ deleted,
                             int32_t* __restrict__ starts, int b, int n1,
                             int s1, int k_l, int k_h, int k_d) {
  const int64_t k = (int64_t)k_l + k_h + k_d;
  const int64_t total = (int64_t)b * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t d = t / k;
    const int64_t j = t - d * k;
    if (j < k_l) {
      const int64_t r = norm_index(lanes[j], n1);
      if (r >= 0) right[d * n1 + r] = lanes[k_l + j];
    } else if (j < (int64_t)k_l + k_h) {
      const int64_t h = j - k_l;
      const int64_t s = norm_index(lanes[2 * (int64_t)k_l + h], s1);
      if (s >= 0) starts[d * s1 + s] = lanes[2 * (int64_t)k_l + k_h + h];
    } else {
      const int64_t e = j - k_l - k_h;
      const int64_t r =
          norm_index(lanes[2 * (int64_t)k_l + 2 * (int64_t)k_h + e], n1);
      if (r >= 0) deleted[d * n1 + r] = 1;
    }
  }
}

}  // namespace

extern "C" int ytpu_apply_plan_shared(const void* lanes, void* right,
                                      void* deleted, void* starts, int b,
                                      int n1, int s1, int k_l, int k_h,
                                      int k_d, void* stream) {
  const int64_t total = (int64_t)b * ((int64_t)k_l + k_h + k_d);
  if (total <= 0) return (int)cudaSuccess;
  int64_t blocks = (total + kSharedThreads - 1) / kSharedThreads;
  if (blocks > kSharedMaxBlocks) blocks = kSharedMaxBlocks;
  apply_shared<<<(unsigned)blocks, kSharedThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lanes), static_cast<int32_t*>(right),
      static_cast<uint8_t*>(deleted), static_cast<int32_t*>(starts), b, n1,
      s1, k_l, k_h, k_d);
  return (int)cudaGetLastError();
}

// desc: see apply_lanes_sharded; one launch sequence (three launches, or
// fewer for empty sections) per 16 shards with docs.
extern "C" int ytpu_apply_lanes_sharded_i32(const long long* desc,
                                            int n_shards, int n1, int s1,
                                            int k_dn, int k_sp, int k_h,
                                            int k_d, void* stream) {
  return apply_lanes_sharded<int32_t>(desc, n_shards, n1, s1, k_dn, k_sp,
                                      k_h, k_d,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int ytpu_apply_lanes_sharded_i16(const long long* desc,
                                            int n_shards, int n1, int s1,
                                            int k_dn, int k_sp, int k_h,
                                            int k_d, void* stream) {
  return apply_lanes_sharded<int16_t>(desc, n_shards, n1, s1, k_dn, k_sp,
                                      k_h, k_d,
                                      static_cast<cudaStream_t>(stream));
}
