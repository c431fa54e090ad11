// scatter_rows: whole-row replacement of docs idx in the three resident
// tables (compaction rebuilds, warm-tier hydration).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py scatter_rows (:479), a
// jitted XLA scatter with the tables donated.
//
// Bound on the card: bytes.  Per replaced doc it reads one new row of each
// table (4 + 1 bytes per row slot, 4 per segment slot) and writes the same
// bytes into the tables, in place: 2 * k * (5 * (N+1) + 4 * (S+1)) bytes
// over 3.35 TB/s.
//
// Design: a plain row copy.  The y dimension walks the k replaced docs, the x
// dimension strides over the columns, so neighbouring threads read and
// write neighbouring addresses of one row (coalesced).  A doc index outside
// [0, B) after JAX's negative-index rule is dropped, as XLA's scatter drops
// it.  No allocation, no synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 64;
constexpr int kMaxBlocksY = 65535;

__global__ void scatter_rows_kernel(const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ new_right,
                                    const uint8_t* __restrict__ new_deleted,
                                    const int32_t* __restrict__ new_starts,
                                    int32_t* __restrict__ right,
                                    uint8_t* __restrict__ deleted,
                                    int32_t* __restrict__ starts, int k,
                                    int b, int n1, int s1) {
  const int width = max(n1, s1);
  for (int j = blockIdx.y; j < k; j += gridDim.y) {
    int64_t doc = idx[j];
    if (doc < 0) doc += b;
    if (doc < 0 || doc >= b) continue;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < width;
         c += gridDim.x * blockDim.x) {
      if (c < n1) {
        right[doc * n1 + c] = new_right[(int64_t)j * n1 + c];
        deleted[doc * n1 + c] = new_deleted[(int64_t)j * n1 + c];
      }
      if (c < s1) starts[doc * s1 + c] = new_starts[(int64_t)j * s1 + c];
    }
  }
}

}  // namespace

extern "C" int ytpu_scatter_rows(const void* idx, const void* new_right,
                                 const void* new_deleted,
                                 const void* new_starts, void* right,
                                 void* deleted, void* starts, int k, int b,
                                 int n1, int s1, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  const int width = n1 > s1 ? n1 : s1;
  int bx = (width + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  dim3 grid(bx, k < kMaxBlocksY ? k : kMaxBlocksY);
  scatter_rows_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(new_right),
      static_cast<const uint8_t*>(new_deleted),
      static_cast<const int32_t*>(new_starts),
      static_cast<int32_t*>(right), static_cast<uint8_t*>(deleted),
      static_cast<int32_t*>(starts), k, b, n1, s1);
  return (int)cudaGetLastError();
}
