// state_vector: each doc's dense state vector, the per-slot maximum of
// its rows' ends, for every shard of a device in one launch.
//
// Replaces the TPU kernels yjs_tpu/ops/kernels.py state_vector_kernel
// (:705), a jitted vmap of segment_max over [B, N] followed by
// max(sv, 0), and its shard_map over the doc mesh,
// yjs_tpu/parallel/mesh.py sharded_state_vectors (:168), which runs it on
// each (doc block, row block) shard and folds the row shards by pmax.
//
// Bound on the card: bytes.  The function reads row_slot and row_end once
// (8 * B * N bytes) and writes the [B, n_slots] result once; the work is
// one compare and one max a row.
//
// Design:
// - One launch serves up to kMaxShards shards of one device: each
//   shard's {slot, end, row stride, docs, columns, out, out stride}
//   travels by value in a __grid_constant__ struct, blockIdx.y picks the
//   shard, and blocks past a shard's (doc, row tile) pairs exit.  The row
//   stride lets a 2-D mesh's column blocks be read in place from one
//   [B, N] buffer.  The host entry launches further rounds past the cap.
//   The unsharded kernel (K9) is the one-shard call.  kMaxShards is 64:
//   64 shards' 48 bytes keep the struct under the 4 KB kernel-parameter
//   limit of every CUDA 12 toolkit with room, and an 8 x 8 mesh takes one
//   launch.
// - A 1-D grid over (doc, tile of kRowsPerTile rows) within a shard.
//   Each block keeps the tile's slot maxima in shared memory (atomicMax),
//   then adds them with one global atomicMax per non-zero slot into the
//   output rows of its doc.  The wrapper zero-fills one output a device:
//   starting from 0 gives JAX's max(sv, 0), and integer maxima are the
//   same in any order, so the row shards of one doc block meeting in the
//   same output rows is the reference's pmax.  Rows of one client tend
//   to sit together, so each thread first folds runs of its rows that
//   share a slot in registers, which keeps shared-memory atomics off the
//   few hot slots.  When n_slots does not fit in shared memory the same
//   loop goes straight to the global atomics.  Rows whose slot lies
//   outside [0, n_slots) are dropped, as segment_max drops out-of-range
//   ids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 2048;
constexpr int kSharedSlots = 12288;  // 48 KB of int32, no opt-in needed
constexpr int kMaxShards = 64;
constexpr int kDescInts = 7;  // a shard's row in the host descriptor

struct Shard {
  const int32_t* slot;
  const int32_t* end;
  int32_t* out;
  int64_t stride;      // int32 elements between a doc's rows in slot, end
  int64_t out_stride;  // int32 elements between a doc's rows in out
  int32_t docs;
  int32_t cols;
};

struct Shards {
  Shard s[kMaxShards];
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    state_vector_kernel(const __grid_constant__ Shards shards, int n_slots) {
  extern __shared__ int32_t acc_shared[];
  const Shard& sh = shards.s[blockIdx.y];
  const int tiles = (sh.cols + kRowsPerTile - 1) / kRowsPerTile;
  if ((int64_t)blockIdx.x >= (int64_t)sh.docs * tiles) return;  // before
                                                                 // any barrier
  const int64_t doc = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int32_t* const out = sh.out + doc * sh.out_stride;
  int32_t* const acc = kShared ? acc_shared : out;
  if (kShared) {
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) acc[s] = 0;
    __syncthreads();
  }
  const int32_t* const slot = sh.slot + doc * sh.stride;
  const int32_t* const end = sh.end + doc * sh.stride;
  const int r0 = tile * kRowsPerTile;
  const int r1 = min(sh.cols, r0 + kRowsPerTile);
  int32_t cur_s = -1;
  int32_t cur_v = 0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    // the read-only path: the struct's pointers carry no __restrict__
    const int32_t s = __ldg(slot + r);
    if (s < 0 || s >= n_slots) continue;
    const int32_t e = __ldg(end + r);
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

// desc: n_shards rows of {slot, end, row stride, docs, cols, out, out
// stride} (device pointers and counts as int64), every shard on the
// current device with docs >= 1 and cols >= 1; each shard's out rows
// zero-filled (or holding earlier maxima to fold into).  One launch per
// kMaxShards shards.
extern "C" int ytpu_state_vector_sharded(const long long* desc, int n_shards,
                                         int n_slots, void* stream) {
  if (n_shards < 0) return (int)cudaErrorInvalidValue;
  if (n_slots <= 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const bool shared = n_slots <= kSharedSlots;
  const size_t smem = shared ? (size_t)n_slots * sizeof(int32_t) : 0;
  for (int base = 0; base < n_shards; base += kMaxShards) {
    const int n = n_shards - base < kMaxShards ? n_shards - base : kMaxShards;
    Shards p = {};
    long long max_blocks = 0;
    for (int k = 0; k < n; ++k) {
      const long long* d = desc + kDescInts * (base + k);
      if (d[3] <= 0 || d[4] <= 0 || d[3] > 0x7fffffff || d[4] > 0x7fffffff) {
        return (int)cudaErrorInvalidValue;
      }
      p.s[k].slot = reinterpret_cast<const int32_t*>(d[0]);
      p.s[k].end = reinterpret_cast<const int32_t*>(d[1]);
      p.s[k].stride = d[2];
      p.s[k].docs = (int32_t)d[3];
      p.s[k].cols = (int32_t)d[4];
      p.s[k].out = reinterpret_cast<int32_t*>(d[5]);
      p.s[k].out_stride = d[6];
      const long long blocks =
          d[3] * ((d[4] + kRowsPerTile - 1) / kRowsPerTile);
      if (blocks > max_blocks) max_blocks = blocks;
    }
    if (max_blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)max_blocks, (unsigned)n);
    if (shared) {
      state_vector_kernel<true><<<grid, kThreads, smem, st>>>(p, n_slots);
    } else {
      state_vector_kernel<false><<<grid, kThreads, 0, st>>>(p, n_slots);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
