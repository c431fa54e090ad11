// apply_lanes: the bulk-apply scatter of the default flush.
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py apply_plan2 (:386) ->
// apply_lanes (:406) -> _doc_lanes (:372), a jitted XLA scatter.
//
// Bound on the card: bytes.  It reads the lanes vector once (2 or 4 bytes
// a lane) and stores one element per real lane (4 bytes into right_link or
// starts, 1 byte into deleted); at 3.35 TB/s a 4096-doc flush of ~6M lanes
// is a few microseconds of traffic.  The stores are scattered, so each one
// moves a whole 32-byte sector, and the launch latency of the five
// launches is of the same order as the traffic.
//
// Design: one small kernel scans the four [B] per-doc count vectors into a
// [4, B] int32 scratch (one block per vector).  Then one launch per
// non-empty section, in the JAX order dense, sparse, heads, deletes (dense
// and sparse both write right_link, so their order is kept), with one
// thread per lane: coalesced lane loads, a binary search over the section's
// cumsum (16 KB for B = 4096, L1/L2-resident), and a store masked on both
// the doc and the row: lanes past the total and padded rows (cap+1, S+1)
// are dropped, as JAX's mode="drop" drops them.  Lanes are read at their
// stored width (int16 or int32) and sign-extended in registers, so an i16
// buffer is never widened in a separate pass.
//
// The shard of a doc mesh (K14, yjs_tpu/parallel/mesh.py sharded_apply_plan
// :134) runs the same launches on its own lanes and tables and also wants
// its progress counters: integrated = the sum of the dense and sparse
// counts, deleted = the sum of the delete counts.  The count scan already
// has those totals, so with a counter pointer its blocks 0, 1 and 3 add
// them (int32, wrapping like the reference's int32 sum) into a zeroed
// per-shard [2] counter with one atomic each; no second pass reads the
// header again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kLaneThreads = 256;

enum Section { kDense = 0, kSparse = 1, kHeads = 2, kDels = 3 };

// Inclusive cumsum of the four count vectors: cum[v*b + i] = sum of
// lanes[v*b .. v*b+i].  One block per vector; each thread sums a
// contiguous run, a Hillis-Steele scan over the run totals gives offsets.
template <typename T>
__global__ void scan_counts(const T* __restrict__ lanes,
                            int32_t* __restrict__ cum, int b,
                            int32_t* __restrict__ counter) {
  __shared__ int32_t part[kScanThreads];
  const T* cnt = lanes + (size_t)blockIdx.x * b;
  int32_t* out = cum + (size_t)blockIdx.x * b;
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
  if (counter != nullptr && threadIdx.x == 0 && blockIdx.x != kHeads) {
    atomicAdd(&counter[blockIdx.x == kDels ? 1 : 0], part[blockDim.x - 1]);
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

template <typename T, int kSec>
__global__ void apply_section(const T* __restrict__ lanes,
                              const int32_t* __restrict__ cum_all,
                              int32_t* __restrict__ right,
                              uint8_t* __restrict__ deleted,
                              int32_t* __restrict__ starts, int b, int n1,
                              int s1, int off, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int32_t* cum = cum_all + (size_t)kSec * b;
  const int d = doc_of(cum, b, i);
  if (kSec == kDense) {
    if (i >= cum[b - 1]) return;  // past the total: dropped
    const int32_t cnt = (int32_t)lanes[(size_t)kDense * b + d];
    const int32_t within = i - (cum[d] - cnt);
    const int64_t r = norm_index(within, n1);
    if (r < 0) return;
    right[(size_t)d * n1 + r] = (int32_t)lanes[off + i];
  } else if (kSec == kSparse) {
    const int64_t r = norm_index((int32_t)lanes[off + i], n1);
    if (r < 0) return;
    right[(size_t)d * n1 + r] = (int32_t)lanes[off + k + i];
  } else if (kSec == kHeads) {
    const int64_t s = norm_index((int32_t)lanes[off + i], s1);
    if (s < 0) return;
    starts[(size_t)d * s1 + s] = (int32_t)lanes[off + k + i];
  } else {
    const int64_t r = norm_index((int32_t)lanes[off + i], n1);
    if (r < 0) return;
    deleted[(size_t)d * n1 + r] = 1;
  }
}

template <typename T, int kSec>
void launch_section(const T* lanes, const int32_t* cum, int32_t* right,
                    uint8_t* deleted, int32_t* starts, int b, int n1, int s1,
                    int off, int k, cudaStream_t stream) {
  if (k <= 0) return;
  const int blocks = (k + kLaneThreads - 1) / kLaneThreads;
  apply_section<T, kSec><<<blocks, kLaneThreads, 0, stream>>>(
      lanes, cum, right, deleted, starts, b, n1, s1, off, k);
}

template <typename T>
int apply_lanes(const T* lanes, int32_t* cum, int32_t* right,
                uint8_t* deleted, int32_t* starts, int b, int n1, int s1,
                int k_dn, int k_sp, int k_h, int k_d, int32_t* counter,
                cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  scan_counts<T><<<4, kScanThreads, 0, stream>>>(lanes, cum, b, counter);
  int off = 4 * b;
  launch_section<T, kDense>(lanes, cum, right, deleted, starts, b, n1, s1,
                            off, k_dn, stream);
  off += k_dn;
  launch_section<T, kSparse>(lanes, cum, right, deleted, starts, b, n1, s1,
                             off, k_sp, stream);
  off += 2 * k_sp;
  launch_section<T, kHeads>(lanes, cum, right, deleted, starts, b, n1, s1,
                            off, k_h, stream);
  off += 2 * k_h;
  launch_section<T, kDels>(lanes, cum, right, deleted, starts, b, n1, s1,
                           off, k_d, stream);
  return (int)cudaGetLastError();
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

// counter: a zeroed [2] int32 on the lanes' device, or null (unsharded).
extern "C" int ytpu_apply_lanes_i32(const void* lanes, void* cum, void* right,
                                    void* deleted, void* starts, int b,
                                    int n1, int s1, int k_dn, int k_sp,
                                    int k_h, int k_d, void* counter,
                                    void* stream) {
  return apply_lanes<int32_t>(
      static_cast<const int32_t*>(lanes), static_cast<int32_t*>(cum),
      static_cast<int32_t*>(right), static_cast<uint8_t*>(deleted),
      static_cast<int32_t*>(starts), b, n1, s1, k_dn, k_sp, k_h, k_d,
      static_cast<int32_t*>(counter), static_cast<cudaStream_t>(stream));
}

// counter: a zeroed [2] int32 on the lanes' device, or null (unsharded).
extern "C" int ytpu_apply_lanes_i16(const void* lanes, void* cum, void* right,
                                    void* deleted, void* starts, int b,
                                    int n1, int s1, int k_dn, int k_sp,
                                    int k_h, int k_d, void* counter,
                                    void* stream) {
  return apply_lanes<int16_t>(
      static_cast<const int16_t*>(lanes), static_cast<int32_t*>(cum),
      static_cast<int32_t*>(right), static_cast<uint8_t*>(deleted),
      static_cast<int32_t*>(starts), b, n1, s1, k_dn, k_sp, k_h, k_d,
      static_cast<int32_t*>(counter), static_cast<cudaStream_t>(stream));
}
