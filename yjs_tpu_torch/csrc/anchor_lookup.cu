// anchor_lookup: the segment planner's batched anchor search, one launch
// for every shard on a device.
//
// Replaces the TPU kernels yjs_tpu/ops/kernels.py _anchor_lookup_jax (:531,
// behind plan_anchor_lookup :537 and the whole-chunk lookup of
// yjs_tpu/ops/segment_planner.py plan_chunk), a jitted
// searchsorted(side="right") - 1, and its shard_map over the doc mesh
// (yjs_tpu/ops/segment_planner.py _sharded_lookup, :286).
//
// out[i] = (number of haystack keys <= q[i]) - 1: the last fragment that
// starts at or before the queried (slot, clock) key, or -1.  Keys are
// int64 and compared as int64.  The reference runs without x64 and so
// truncates them to int32 (ROADMAP R2); here the planner's int64.max
// padding sorts last, as it must, and a query of -1 (an absent anchor)
// sorts before every real key.
//
// Bound on the card: bytes for the inputs and outputs (each query in and
// out, 8 B each, and the haystack entries the searches visit), but a
// search is log2(n) dependent loads; the haystack of one chunk (2^21
// keys, 16 MB) stays in the 50 MB L2, so each step is an L2 round trip
// and the chain of round trips sets the time.
//
// Design:
// - One launch serves up to kMaxShards shards of one device: their
//   {hay, n_hay, q, out, n_q} travel by value in a __grid_constant__
//   struct, blockIdx.y picks the shard and blocks past a shard's queries
//   exit.  The host entry launches more shards in rounds.  The unsharded
//   lookup (K11) is the one-shard call of the same kernel.
// - One thread per query, an upper-bound binary search.  When the
//   haystack holds at least min_stage keys, each block first stages a
//   sample of it in shared memory, every stride-th key with stride =
//   ceil(n_hay / kSample), one load a thread, all at once (the sample is
//   strided, so each key is its own 32-byte sector).  A thread searches
//   the sample in shared memory, which leaves it one stride of keys, and
//   searches that stride in L2: the top log2(kSample) steps, which every
//   thread of the block takes through the same few keys, cost one round
//   of loads instead of a chain of round trips.  The sample bounds are
//   exact, so runs of equal keys across a sample boundary still give the
//   last key <= q.  kSample is 128: on the H100 a 2048-key sample (16 KB,
//   2048 sectors a block) cost more to gather than its 11 steps saved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;
constexpr int kSample = 128;  // 1 KB of int64 keys a block

struct Shard {
  const int64_t* hay;
  int64_t n_hay;
  const int64_t* q;
  int64_t* out;
  int64_t n_q;
};

struct Shards {
  Shard s[kMaxShards];
};

__global__ void __launch_bounds__(kThreads)
    anchor_lookup_kernel(const __grid_constant__ Shards shards,
                         int64_t min_stage) {
  __shared__ int64_t sample[kSample];
  const Shard& sh = shards.s[blockIdx.y];
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  if (first >= sh.n_q) return;  // the whole block: before any barrier
  const int64_t i = first + threadIdx.x;
  const bool active = i < sh.n_q;
  const int64_t key = active ? sh.q[i] : 0;
  const int64_t n_hay = sh.n_hay;
  const int64_t* __restrict__ hay = sh.hay;
  int64_t lo = 0, hi = n_hay;
  if (n_hay >= min_stage) {  // uniform over the block
    const int64_t stride = (n_hay + kSample - 1) / kSample;
    const int n_s = (int)((n_hay + stride - 1) / stride);  // <= kSample
#pragma unroll
    for (int r = 0; r < (kSample + kThreads - 1) / kThreads; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (j < n_s) sample[j] = __ldg(hay + (int64_t)j * stride);
    }
    __syncthreads();
    int slo = 0, shi = n_s;
    while (slo < shi) {
      const int mid = (slo + shi) >> 1;
      if (sample[mid] <= key) {
        slo = mid + 1;
      } else {
        shi = mid;
      }
    }
    // slo sample keys are <= key: hay[(slo - 1) * stride] <= key and,
    // below n_s, hay[slo * stride] > key
    if (slo == 0) {
      hi = 0;
    } else {
      lo = (int64_t)(slo - 1) * stride + 1;
      hi = (int64_t)slo * stride < n_hay ? (int64_t)slo * stride : n_hay;
    }
  }
  if (!active) return;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(hay + mid) <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  sh.out[i] = lo - 1;
}

}  // namespace

// desc: n_shards rows of {hay, n_hay, q, out, n_q} (device pointers and
// counts as int64), every shard on the current device and n_q >= 1.  One
// launch per kMaxShards shards.  min_stage: the least haystack length
// that is staged in shared memory (at least 1).
extern "C" int ytpu_anchor_lookup_sharded(const long long* desc,
                                          int n_shards, long long min_stage,
                                          void* stream) {
  if (n_shards < 0) return (int)cudaErrorInvalidValue;
  if (min_stage < 1) min_stage = 1;
  auto st = static_cast<cudaStream_t>(stream);
  for (int base = 0; base < n_shards; base += kMaxShards) {
    const int n = n_shards - base < kMaxShards ? n_shards - base : kMaxShards;
    Shards p;
    long long max_q = 0;
    for (int k = 0; k < kMaxShards; ++k) {
      const long long* d = desc + 5 * (base + (k < n ? k : 0));
      p.s[k].hay = reinterpret_cast<const int64_t*>(d[0]);
      p.s[k].n_hay = d[1];
      p.s[k].q = reinterpret_cast<const int64_t*>(d[2]);
      p.s[k].out = reinterpret_cast<int64_t*>(d[3]);
      p.s[k].n_q = k < n ? d[4] : 0;
      if (p.s[k].n_q > max_q) max_q = p.s[k].n_q;
    }
    if (max_q <= 0) return (int)cudaErrorInvalidValue;
    const long long blocks = (max_q + kThreads - 1) / kThreads;
    anchor_lookup_kernel<<<dim3((unsigned)blocks, (unsigned)n), kThreads, 0,
                           st>>>(p, (int64_t)min_stage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
