// shard_fold: the cross-shard reduction of the doc mesh.  P equal int32
// partials, one per shard, fold elementwise into one buffer with SUM or
// MAX.
//
// Replaces the collectives inside the TPU programs of
// yjs_tpu/parallel/mesh.py: the lax.psum of the progress counters of
// sharded_batch_step (:101) and sharded_apply_plan (:134), and the lax.pmax
// over the "rows" axis of sharded_state_vectors (:168).
//
// Bound on the card: bytes.  It reads each partial once (4 * P * n bytes)
// and writes the result once (4 * n); the work is one add or max an
// element read.  The counters are two elements a shard, so their fold is
// one launch's latency; a state-vector fold is a few hundred KB.
//
// Design: the P partial pointers travel by value in the kernel's
// arguments (up to kMaxParts of them; the host entry folds more in
// rounds, the running result passed as the first part of the next round,
// which is safe because each thread reads all its inputs before it
// writes its own element).  One call of the host entry is the whole
// fold: the wrapper's Python work is one pointer array and one call.  One thread per element in a grid-stride loop: coalesced
// loads of the P partials at the same index.  Every partial lies on the
// owner's device: the wrapper copies a partial that lives on another
// device there first, device to device, and copies nothing on a shared
// device.  SUM wraps in int32, as psum's int32 sum does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

struct Parts {
  const int32_t* p[kMaxParts];
};

template <bool kMax>
__global__ void shard_fold_kernel(Parts parts, int n_parts, int64_t n,
                                  int32_t* out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t v = parts.p[0][i];
    for (int k = 1; k < n_parts; ++k) {
      const int32_t x = parts.p[k][i];
      if (kMax) {
        v = max(v, x);
      } else {
        v = (int32_t)((uint32_t)v + (uint32_t)x);
      }
    }
    out[i] = v;
  }
}

}  // namespace

// parts: a host array of n_parts >= 1 device pointers, each to n int32;
// op 0 is SUM, 1 is MAX.  out may be one of the parts.  The first launch
// folds the first kMaxParts parts; each further launch folds the running
// result with the next kMaxParts - 1.
extern "C" int ytpu_shard_fold(const void* const* parts, int n_parts,
                               long long n, int op, void* out,
                               void* stream) {
  if (n_parts < 1 || (op != 0 && op != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  int next = 0;  // the first part not folded yet
  while (next < n_parts) {
    Parts p;
    int k = 0;
    if (next > 0) p.p[k++] = o;
    while (k < kMaxParts && next < n_parts) {
      p.p[k++] = static_cast<const int32_t*>(parts[next++]);
    }
    for (int j = k; j < kMaxParts; ++j) p.p[j] = nullptr;
    if (op == 1) {
      shard_fold_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
          p, k, (int64_t)n, o);
    } else {
      shard_fold_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          p, k, (int64_t)n, o);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
