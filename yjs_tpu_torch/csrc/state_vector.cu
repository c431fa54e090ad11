// state_vector: each doc's dense state vector, the per-slot maximum of
// its rows' ends (the batched state_vectors path of the engine).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py state_vector_kernel
// (:705), a jitted vmap of segment_max over [B, N] followed by
// max(sv, 0).
//
// Bound on the card: bytes.  The function reads row_slot and row_end once
// (8 * B * N bytes) and writes the [B, n_slots] result once; the work is
// one compare and one max a row.
//
// Design: a 1-D grid over (doc, tile of kRowsPerTile rows).  Each block
// keeps the tile's slot maxima in shared memory (atomicMax), then adds
// them with one global atomicMax per non-zero slot into the [B, n_slots]
// output, which the wrapper zero-fills: starting from 0 gives JAX's
// max(sv, 0), and integer maxima are the same in any order.  Rows of one
// client tend to sit together, so each thread first folds runs of its
// rows that share a slot in registers, which keeps shared-memory atomics
// off the few hot slots.  When n_slots does not fit in shared memory the
// same loop goes straight to the global atomics.  Rows whose slot lies
// outside [0, n_slots) are dropped, as segment_max drops out-of-range ids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 2048;
constexpr int kSharedSlots = 12288;  // 48 KB of int32, no opt-in needed

template <bool kShared>
__global__ void state_vector_kernel(const int32_t* __restrict__ slot,
                                    const int32_t* __restrict__ end,
                                    int32_t* __restrict__ sv, int n,
                                    int n_slots, int tiles) {
  extern __shared__ int32_t acc_shared[];
  const int64_t doc = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int32_t* const out = sv + doc * n_slots;
  int32_t* const acc = kShared ? acc_shared : out;
  if (kShared) {
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) acc[s] = 0;
    __syncthreads();
  }
  const int64_t base = doc * n;
  const int r0 = tile * kRowsPerTile;
  const int r1 = min(n, r0 + kRowsPerTile);
  int32_t cur_s = -1;
  int32_t cur_v = 0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int32_t s = slot[base + r];
    if (s < 0 || s >= n_slots) continue;
    const int32_t e = end[base + r];
    if (s == cur_s) {
      cur_v = max(cur_v, e);
    } else {
      if (cur_s >= 0 && cur_v > 0) atomicMax(&acc[cur_s], cur_v);
      cur_s = s;
      cur_v = e;
    }
  }
  if (cur_s >= 0 && cur_v > 0) atomicMax(&acc[cur_s], cur_v);
  if (kShared) {
    __syncthreads();
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
      const int32_t v = acc[s];
      if (v > 0) atomicMax(&out[s], v);
    }
  }
}

}  // namespace

// sv must be zero-filled [b, n_slots]; row_slot and row_end are [b, n].
extern "C" int ytpu_state_vector(const void* row_slot, const void* row_end,
                                 void* sv, int b, int n, int n_slots,
                                 void* stream) {
  if (b <= 0 || n <= 0 || n_slots <= 0) return (int)cudaSuccess;
  const int tiles = (n + kRowsPerTile - 1) / kRowsPerTile;
  const int64_t blocks = (int64_t)b * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  auto* s = static_cast<const int32_t*>(row_slot);
  auto* e = static_cast<const int32_t*>(row_end);
  auto* o = static_cast<int32_t*>(sv);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_slots <= kSharedSlots) {
    state_vector_kernel<true>
        <<<(unsigned)blocks, kThreads, n_slots * sizeof(int32_t), st>>>(
            s, e, o, n, n_slots, tiles);
  } else {
    state_vector_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        s, e, o, n, n_slots, tiles);
  }
  return (int)cudaGetLastError();
}
