// scatter_statics: one packed block of new rows into the six resident
// static columns the on-device YATA step reads.
//
// Replaces the TPU kernel yjs_tpu/ops/engine.py _scatter_statics (:152), a
// jitted XLA scatter of one packed [8, K] int32 transfer into six donated
// [B, cap+1] columns.
//
// Bound on the card: bytes.  It reads the packed block once (32 bytes a
// lane) and writes 24 bytes a lane, one int32 into each column; a full
// re-upload of 4096 docs of ~1500 rows (K ~ 6M) is ~340 MB, ~0.1 ms at
// 3.35 TB/s.
//
// Design: one thread per lane, grid-stride.  Neighbouring lanes are
// neighbouring rows of one doc (the engine packs doc by doc, row by row), so
// the eight row loads and the six column stores of a warp are each one or
// two coalesced transactions.  A doc or row outside its column after JAX's
// negative-index rule is dropped, as the XLA scatter drops it.  The padding
// lanes all write the fill values to (0, cap), the scratch row of doc 0:
// duplicate stores of equal values, so their order does not matter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;
constexpr int kCols = 6;

struct Columns {
  int32_t* col[kCols];
};

__global__ void scatter_statics_kernel(const int32_t* __restrict__ packed,
                                       int k, int b, int n1, Columns cols) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t d = packed[i];
    int64_t r = packed[(int64_t)k + i];
    if (d < 0) d += b;
    if (r < 0) r += n1;
    if (d < 0 || d >= b || r < 0 || r >= n1) continue;
    const int64_t at = d * n1 + r;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      cols.col[j][at] = packed[(int64_t)(2 + j) * k + i];
    }
  }
}

}  // namespace

extern "C" int ytpu_scatter_statics(const void* packed, void* c0, void* c1,
                                    void* c2, void* c3, void* c4, void* c5,
                                    int k, int b, int n1, void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaSuccess;
  Columns cols = {{static_cast<int32_t*>(c0), static_cast<int32_t*>(c1),
                   static_cast<int32_t*>(c2), static_cast<int32_t*>(c3),
                   static_cast<int32_t*>(c4), static_cast<int32_t*>(c5)}};
  int blocks = (k + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_statics_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), k, b, n1, cols);
  return (int)cudaGetLastError();
}
