// list_ranks: each row's distance to its list tail by pointer doubling
// over the right links (the device export path, YTPU_EXPORT_DEVICE=1).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py list_ranks (:674), a
// jitted fori_loop of take_along_axis gathers.
//
// Bound on the card: bytes.  The function reads right_link (4 bytes) and
// valid (1 byte) once and writes the ranks (4 bytes): 9 * b * (N+1) bytes
// over 3.35 TB/s.  The ceil(log2(N+1)) rounds re-read a doc's (d, p) pair
// each round; for one doc of a few thousand rows that working set
// (16 bytes a row across both ping-pong halves) stays in L1/L2, so the
// rounds cost latency, not device-memory bandwidth.  The export calls it
// with b = 1, so one block does all the work and the kernel is bound by
// round latency, far above the byte bound.
//
// Design: one block per doc, rows strided over the block's threads,
// __syncthreads() between rounds.  A round is functional (row i reads
// d[p[i]] while another thread rewrites d), so d and p ping-pong between
// two halves of a [2, 2, b, N+1] global scratch the wrapper allocates.
// The scratch is written and read in one launch, so it is not declared
// __restrict__ (a read-only-cache load could return a stale value).
// A link outside [0, N+1) ends the chain like NULL.  Rows that are not
// valid get -1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int32_t kNull = -1;

__global__ void list_ranks_kernel(const int32_t* __restrict__ right,
                                  const uint8_t* __restrict__ valid,
                                  int32_t* scratch,
                                  int32_t* __restrict__ out, int b, int n1,
                                  int rounds) {
  const int64_t doc = blockIdx.x;
  const int64_t plane = (int64_t)b * n1;
  const int64_t row0 = doc * n1;
  // scratch[h][0] holds d and scratch[h][1] holds p for ping-pong half h
  int32_t* const base = scratch + row0;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    int32_t p = right[row0 + i];
    if (p < 0 || p >= n1) p = kNull;
    base[i] = p != kNull ? 1 : 0;
    base[plane + i] = p;
  }
  __syncthreads();
  int h = 0;
  for (int r = 0; r < rounds; ++r) {
    const int32_t* ds = base + (2 * h) * plane;
    const int32_t* ps = base + (2 * h + 1) * plane;
    int32_t* dd = base + (2 * (h ^ 1)) * plane;
    int32_t* pd = base + (2 * (h ^ 1) + 1) * plane;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
      const int32_t p = ps[i];
      if (p != kNull) {
        dd[i] = ds[i] + ds[p];
        pd[i] = ps[p];
      } else {
        dd[i] = ds[i];
        pd[i] = kNull;
      }
    }
    __syncthreads();
    h ^= 1;
  }
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    out[row0 + i] = valid[row0 + i] ? base[(2 * h) * plane + i] : kNull;
  }
}

}  // namespace

extern "C" int ytpu_list_ranks(const void* right, const void* valid,
                               void* scratch, void* out, int b, int n1,
                               int rounds, void* stream) {
  if (b <= 0 || n1 <= 0) return (int)cudaSuccess;
  list_ranks_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(right), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(out), b, n1,
      rounds);
  return (int)cudaGetLastError();
}
