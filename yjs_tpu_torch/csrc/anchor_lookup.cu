// anchor_lookup: the segment planner's batched anchor search.
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py _anchor_lookup_jax (:531,
// behind plan_anchor_lookup :537 and the whole-chunk lookup of
// yjs_tpu/ops/segment_planner.py plan_chunk), a jitted
// searchsorted(side="right") - 1.
//
// out[i] = (number of haystack keys <= q[i]) - 1: the last fragment that
// starts at or before the queried (slot, clock) key, or -1.  Keys are
// int64 and compared as int64.  The reference runs without x64 and so
// truncates them to int32 (ROADMAP R2); here the planner's int64.max
// padding sorts last, as it must, and a query of -1 (an absent anchor)
// sorts before every real key.
//
// Bound on the card: bytes for the inputs and outputs (the haystack once,
// each query in and out, 8 B each), but a search is log2(n) dependent
// loads; the haystack of one chunk (a few MB) stays in the 50 MB L2, so
// each step is an L2 round trip.
//
// Design: one thread per query, an upper-bound binary search.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void anchor_lookup_kernel(const int64_t* __restrict__ hay,
                                     int64_t n_hay,
                                     const int64_t* __restrict__ q,
                                     int64_t* __restrict__ out, int64_t n_q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int64_t key = q[i];
  int64_t lo = 0, hi = n_hay;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (hay[mid] <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo - 1;
}

}  // namespace

extern "C" int ytpu_anchor_lookup(const void* hay, long long n_hay,
                                  const void* q, void* out, long long n_q,
                                  void* stream) {
  if (n_q <= 0) return (int)cudaSuccess;
  const long long blocks = (n_q + kThreads - 1) / kThreads;
  anchor_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(hay), n_hay,
      static_cast<const int64_t*>(q), static_cast<int64_t*>(out), n_q);
  return (int)cudaGetLastError();
}
