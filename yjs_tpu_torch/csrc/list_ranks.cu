// list_ranks: each row's distance to its list tail by pointer doubling
// over the right links (the device export path, YTPU_EXPORT_DEVICE=1).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py list_ranks (:674), a
// jitted fori_loop of take_along_axis gathers.  Its gather rule holds
// here too: a link l other than NULL (-1) reads row l, a negative l row
// l + N+1, and a row outside [0, N+1) reads INT32_MIN for both d and p;
// d adds in int32 with wrap-around.
//
// Bound on the card: bytes.  The function reads right_link (4 bytes) and
// valid (1 byte) once and writes the ranks (4 bytes): 9 * b * (N+1) bytes
// over 3.35 TB/s.  The export calls it with b = 1, so one block does all
// the work and the kernel is bound by its ceil(log2(N+1)) dependent
// rounds and the launch, far above the byte bound.
//
// Design: one block per doc, rows strided over the block's threads.  A
// round is functional (row i reads d[p[i]] while another thread rewrites
// d), so d and p ping-pong between two halves of four planes of N+1
// int32: d, p, d', p'.
// - "staged": the planes live in the block's dynamic shared memory
//   (16 bytes a row, up to about 14.5K rows in the H100's 227 KB), so a
//   round is a few shared loads and a barrier.  The wrapper takes it
//   whenever the planes fit.
// - "global": wider docs keep the planes in a [b, 4, N+1] global scratch
//   the wrapper allocates; it is written and read in one launch, so it
//   is not declared __restrict__ (a read-only-cache load could return a
//   stale value), and __syncthreads() makes each round's writes visible.
// Both stage the links with coalesced loads and end the rounds once no
// row's p is live (__syncthreads_or): a round where every p is NULL
// changes nothing, and a cycle stays live to the last round, so the
// result is the plain version's bit for bit.  counter (optional, [1]
// int32) takes the most rounds any doc ran, by atomicMax.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int32_t kNull = -1;
constexpr int32_t kFill = INT32_MIN;  // what JAX's gather reads out of range

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    list_ranks_kernel(const int32_t* __restrict__ right,
                      const uint8_t* __restrict__ valid, int32_t* scratch,
                      int32_t* __restrict__ out, int32_t* counter, int n1,
                      int rounds) {
  extern __shared__ int32_t planes_shared[];
  const int64_t row0 = (int64_t)blockIdx.x * n1;
  int32_t* const planes =
      kStaged ? planes_shared : scratch + (int64_t)blockIdx.x * 4 * n1;
  int live = 0;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const int32_t p = right[row0 + i];
    planes[i] = p != kNull ? 1 : 0;
    planes[n1 + i] = p;
    live |= p != kNull;
  }
  int h = 0;
  int r = 0;
  for (bool any = __syncthreads_or(live); any && r < rounds; ++r) {
    const int32_t* ds = planes + (2 * h) * n1;
    const int32_t* ps = ds + n1;
    int32_t* dd = planes + (2 * (h ^ 1)) * n1;
    int32_t* pd = dd + n1;
    live = 0;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
      const int32_t p = ps[i];
      if (p != kNull) {
        const int32_t q = p < 0 ? p + n1 : p;
        const bool inb = q >= 0 && q < n1;
        const int32_t gd = inb ? ds[q] : kFill;
        const int32_t gp = inb ? ps[q] : kFill;
        dd[i] = (int32_t)((uint32_t)ds[i] + (uint32_t)gd);
        pd[i] = gp;
        live |= gp != kNull;
      } else {
        dd[i] = ds[i];
        pd[i] = kNull;
      }
    }
    h ^= 1;
    any = __syncthreads_or(live);
  }
  const int32_t* d = planes + (2 * h) * n1;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    out[row0 + i] = valid[row0 + i] ? d[i] : kNull;
  }
  if (counter != nullptr && threadIdx.x == 0) atomicMax(counter, r);
}

// the staged kernel's dynamic shared-memory limit, raised once a device
// to the card's opt-in maximum
bool g_staged_ready[kMaxDevices];

cudaError_t ready_staged() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_staged_ready[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute((const void*)list_ranks_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) g_staged_ready[dev] = true;
  return err;
}

__global__ void empty_kernel() {}

}  // namespace

// staged: the planes in 16 * n1 bytes of shared memory (scratch unused,
// may be null); else in scratch, [b, 4, n1] int32.  counter may be null.
extern "C" int ytpu_list_ranks(const void* right, const void* valid,
                               void* scratch, void* out, void* counter, int b,
                               int n1, int rounds, int staged, void* stream) {
  if (b <= 0 || n1 <= 0) return (int)cudaSuccess;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int threads =
      n1 >= kMaxThreads ? kMaxThreads : ((n1 + 31) / 32) * 32;
  auto* r = static_cast<const int32_t*>(right);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* s = static_cast<int32_t*>(scratch);
  auto* o = static_cast<int32_t*>(out);
  auto* c = static_cast<int32_t*>(counter);
  auto st = static_cast<cudaStream_t>(stream);
  if (staged) {
    const cudaError_t err = ready_staged();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)16 * n1;
    list_ranks_kernel<true><<<b, threads, smem, st>>>(r, v, s, o, c, n1,
                                                      rounds);
  } else {
    list_ranks_kernel<false><<<b, threads, 0, st>>>(r, v, s, o, c, n1,
                                                    rounds);
  }
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the floor under any one-launch call,
// for measuring what a small kernel's call costs beyond it.
extern "C" int ytpu_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
