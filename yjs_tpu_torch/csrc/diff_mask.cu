// diff_mask: the rows, or row suffixes, that a remote state vector is
// missing (the device branch of the engine's batched sync step 2).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py diff_mask_kernel
// (:724), a jitted take_along_axis of the remote clock per row followed
// by elementwise compares.
//
// Bound on the card: bytes.  The function reads row_slot and row_end
// ([B, N] int32), row_clock where a row is needed, and the [B, n_slots]
// state vectors once, and writes needed (1 byte) and offset (4 bytes)
// per row: up to 17 * B * N + 4 * B * n_slots bytes.  The work is a few
// integer operations a row.
//
// Design: the [B, N] columns are walked flat, kTile = 1024 rows a block,
// kRows = 4 consecutive rows a thread.
// - Where every column is 16-byte aligned (the wrapper's own outputs
//   always are), a thread loads its 4 slots and ends with one 16-byte
//   load each and stores 4 offsets in one 16-byte store and 4 needed
//   bytes in one 4-byte store, whatever the doc boundaries inside the
//   group (N = 1102 at the reconnect storm is not a multiple of 4).
//   Otherwise, and for the last group when B * N is not a multiple of 4,
//   the same rows go through scalar loads and stores.
// - No division a row: thread 0 finds the doc of the block's first row
//   once (the one 64-bit division of the block); a row's doc relative to
//   it is a multiply-high and a shift by the host's reciprocal of N
//   (_cuda.fast_div, exact for dividends below 2**31).
// - The state-vector rows of the docs a block touches are contiguous; the
//   block stages them in shared memory with coalesced loads when they fit
//   (kStageInts entries), after issuing its row loads, and reads the
//   remote clock there; otherwise through __ldg.
// - row_clock is loaded only for groups in which some row is needed (an
//   up-to-date client's rows are never needed).
// JAX's gather rule is kept: a slot at or past n_slots reads INT32_MIN,
// a negative slot reads slot 0 (and is never needed).  remote - clock
// wraps in int32 as in XLA; signed overflow is undefined in C++, so the
// subtraction is done in uint32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread
constexpr int kTile = kThreads * kRows;  // rows a block
constexpr int kStageInts = 2048;  // state-vector entries a block stages
constexpr int32_t kInt32Min = -2147483647 - 1;

// x / n for x < 2**31 (mul, shift from _cuda.fast_div; mul 0 for n = 1)
__device__ __forceinline__ uint32_t div_n(uint32_t x, uint32_t mul,
                                          uint32_t shift) {
  return mul == 0u ? x : __umulhi(x, mul) >> shift;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    diff_mask_kernel(const int32_t* __restrict__ slot,
                     const int32_t* __restrict__ clock,
                     const int32_t* __restrict__ end,
                     const int32_t* __restrict__ sv,
                     uint8_t* __restrict__ needed,
                     int32_t* __restrict__ offset, int64_t total, int n,
                     int n_slots, uint32_t mul, uint32_t shift) {
  __shared__ int32_t stage[kStageInts];
  __shared__ int64_t first_doc;
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  const int64_t i0 = t0 + (int64_t)threadIdx.x * kRows;
  const bool whole = kVec && i0 + kRows <= total;
  // this thread's slots and ends, in flight while the block stages
  int32_t s[kRows], e[kRows];
  if (whole) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(slot + i0));
    const int4 z = __ldg(reinterpret_cast<const int4*>(end + i0));
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    e[0] = z.x; e[1] = z.y; e[2] = z.z; e[3] = z.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      s[k] = -1;
      e[k] = 0;
      if (i0 + k < total) {
        s[k] = __ldg(slot + i0 + k);
        e[k] = __ldg(end + i0 + k);
      }
    }
  }
  if (threadIdx.x == 0) first_doc = t0 / n;
  __syncthreads();
  const int64_t d0 = first_doc;
  const int64_t row0 = d0 * n;  // the flat index of doc d0's first row
  const int64_t last = (t0 + kTile < total ? t0 + kTile : total) - 1;
  const int span = (int)div_n((uint32_t)(last - row0), mul, shift) + 1;
  const bool staged = (int64_t)span * n_slots <= kStageInts;
  if (staged) {  // uniform over the block
    const int32_t* src = sv + d0 * n_slots;
    for (int j = threadIdx.x; j < span * n_slots; j += kThreads) {
      stage[j] = __ldg(src + j);
    }
    __syncthreads();
  }
  const uint32_t rel = (uint32_t)(i0 - row0);
  int32_t remote[kRows];
  bool need[kRows];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const uint32_t dr = div_n(rel + k, mul, shift);  // doc - d0
    const int32_t safe = s[k] >= 0 ? s[k] : 0;
    int32_t r = kInt32Min;
    if (safe < n_slots && (whole || i0 + k < total)) {
      r = staged ? stage[dr * n_slots + safe]
                 : __ldg(sv + (d0 + dr) * n_slots + safe);
    }
    remote[k] = r;
    need[k] = s[k] >= 0 && e[k] > r;  // s = -1 past the end: not needed
    any |= need[k];
  }
  int32_t c[kRows] = {0, 0, 0, 0};
  if (any) {
    if (whole) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(clock + i0));
      c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (need[k]) c[k] = __ldg(clock + i0 + k);
      }
    }
  }
  int32_t off[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int32_t d = (int32_t)((uint32_t)remote[k] - (uint32_t)c[k]);
    off[k] = need[k] && d > 0 ? d : 0;
  }
  if (whole) {
    *reinterpret_cast<int4*>(offset + i0) =
        make_int4(off[0], off[1], off[2], off[3]);
    *reinterpret_cast<uint32_t*>(needed + i0) =
        (uint32_t)need[0] | ((uint32_t)need[1] << 8) |
        ((uint32_t)need[2] << 16) | ((uint32_t)need[3] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (i0 + k < total) {
        offset[i0 + k] = off[k];
        needed[i0 + k] = need[k] ? 1 : 0;
      }
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

// row_slot, row_clock, row_end, needed (bool), offset: [b, n];
// sv: [b, n_slots] (n_slots >= 1); mul, shift: _cuda.fast_div(n).
extern "C" int ytpu_diff_mask(const void* row_slot, const void* row_clock,
                              const void* row_end, const void* sv,
                              void* needed, void* offset, int b, int n,
                              int n_slots, unsigned mul, unsigned shift,
                              void* stream) {
  if (b < 0 || n < 0 || n_slots < 1 || n > 0x7fffffff - kTile) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || n == 0) return (int)cudaSuccess;
  const int64_t total = (int64_t)b * n;
  const int64_t blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = aligned(row_slot, 16) && aligned(row_clock, 16) &&
                   aligned(row_end, 16) && aligned(offset, 16) &&
                   aligned(needed, 4);
  auto* kernel = vec ? diff_mask_kernel<true> : diff_mask_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_slot),
      static_cast<const int32_t*>(row_clock),
      static_cast<const int32_t*>(row_end), static_cast<const int32_t*>(sv),
      static_cast<uint8_t*>(needed), static_cast<int32_t*>(offset), total, n,
      n_slots, mul, shift);
  return (int)cudaGetLastError();
}
