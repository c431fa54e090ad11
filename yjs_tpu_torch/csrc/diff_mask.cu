// diff_mask: the rows, or row suffixes, that a remote state vector is
// missing (the device branch of the engine's batched sync step 2).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py diff_mask_kernel
// (:724), a jitted take_along_axis of the remote clock per row followed
// by elementwise compares.
//
// Bound on the card: bytes.  The function reads three [B, N] int32
// columns and the [B, n_slots] state vectors once, and writes needed
// (1 byte) and offset (4 bytes) per row: 17 * B * N + 4 * B * n_slots
// bytes.  The work is a few integer operations a row.
//
// Design: one thread per (doc, row), grid-stride, neighbouring threads on
// neighbouring rows so every column load and store is coalesced; the
// gathered sv entry of a doc is read by all its rows and stays in L1/L2.
// JAX's gather rule is kept: a slot at or past n_slots reads INT32_MIN,
// a negative slot reads slot 0 (and is never needed).  remote - clock
// wraps in int32 as in XLA; signed overflow is undefined in C++, so the
// subtraction is done in uint32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int32_t kInt32Min = -2147483647 - 1;

__global__ void diff_mask_kernel(const int32_t* __restrict__ slot,
                                 const int32_t* __restrict__ clock,
                                 const int32_t* __restrict__ end,
                                 const int32_t* __restrict__ sv,
                                 uint8_t* __restrict__ needed,
                                 int32_t* __restrict__ offset, int64_t total,
                                 int n, int n_slots) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t doc = i / n;
    const int32_t s = slot[i];
    const int32_t safe = s >= 0 ? s : 0;
    const int32_t remote =
        safe < n_slots ? sv[doc * n_slots + safe] : kInt32Min;
    const bool need = s >= 0 && end[i] > remote;
    int32_t off = 0;
    if (need) {
      const int32_t d = (int32_t)((uint32_t)remote - (uint32_t)clock[i]);
      off = d > 0 ? d : 0;
    }
    needed[i] = need ? 1 : 0;
    offset[i] = off;
  }
}

}  // namespace

// row_slot, row_clock, row_end, needed (bool), offset: [b, n];
// sv: [b, n_slots].
extern "C" int ytpu_diff_mask(const void* row_slot, const void* row_clock,
                              const void* row_end, const void* sv,
                              void* needed, void* offset, int b, int n,
                              int n_slots, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t total = (int64_t)b * n;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  diff_mask_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_slot),
      static_cast<const int32_t*>(row_clock),
      static_cast<const int32_t*>(row_end), static_cast<const int32_t*>(sv),
      static_cast<uint8_t*>(needed), static_cast<int32_t*>(offset), total, n,
      n_slots);
  return (int)cudaGetLastError();
}
