// conflict_scan: the segment planner's chain masks and run ids.
//
// Replaces the TPU kernels of yjs_tpu/ops/kernels.py: _conflict_scan_jax
// (:548, one doc's flush batch) and _chunk_conflict_scan_jax (:604, the
// doc-major concatenation of a whole chunk of cold docs, with a doc-id
// column that breaks chains at doc boundaries), jitted XLA programs.
//
// For lane i > 0, with p = lane i-1 and p_end = p.clock + p.length:
//   left[i]  = same doc & o_client[i] == p.client & o_client[i] >= 0
//              & p.clock <= o_clock[i] < p_end
//   right[i] = the same test on (r_client[i], r_clock[i])
// left[0] = right[0] = false, and run_id = inclusive cumsum of
// ~(left | right).  All columns are int64 (true int64: the reference
// truncates them to int32, ROADMAP R2); the planner pads to a power of two
// with client = -1 and doc = -1, which never chains.
//
// Bound on the card: bytes.  A lane reads its own eight (seven without the
// doc column) int64 values and three or four of its neighbour's, which
// neighbouring threads load anyway (L1/L2 hits), and writes two bytes and
// one int64: 2^20 lanes move ~78 MB, ~0.023 ms at 3.35 TB/s.
//
// Design: a three-pass scan written out, no library scan.
//   1. scan_tiles: one thread per lane, 1024 lanes a block.  It computes
//      both masks, then the tile-local inclusive scan of the chain-break
//      flags (warp shuffles, then one warp over the 32 warp totals), writes
//      the local run ids and the tile's total.
//   2. scan_offsets: one block turns the tile totals into exclusive
//      offsets, 1024 at a time with a running carry, so any lane count fits.
//   3. add_offsets: every lane of tile t > 0 adds offset t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // lanes a block, one a thread (32 warps)

struct Cols {
  const int64_t* doc;  // nullptr: the per-doc variant
  const int64_t* client;
  const int64_t* clock;
  const int64_t* length;
  const int64_t* o_cl;
  const int64_t* o_ck;
  const int64_t* r_cl;
  const int64_t* r_ck;
};

__device__ __forceinline__ bool inside(int64_t a_cl, int64_t a_ck,
                                       int64_t p_cl, int64_t p_ck,
                                       int64_t p_end) {
  return a_cl == p_cl && a_cl >= 0 && a_ck >= p_ck && a_ck < p_end;
}

// Inclusive scan of x over a block of kTile threads; every thread calls it.
// ws holds kTile / 32 partial sums; the closing barrier lets a caller
// reuse ws at once.
__device__ int64_t block_scan(int64_t x, int64_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += t;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = ws[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += ws[warp - 1];
  __syncthreads();
  return x;
}

__global__ void scan_tiles(Cols c, uint8_t* __restrict__ left,
                           uint8_t* __restrict__ right,
                           int64_t* __restrict__ run_id,
                           int64_t* __restrict__ tile_sum, int64_t n) {
  __shared__ int64_t ws[kTile / 32];
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int64_t flag = 0;
  if (i < n) {
    bool l = false, r = false;
    if (i > 0 && (c.doc == nullptr || c.doc[i] == c.doc[i - 1])) {
      const int64_t p_cl = c.client[i - 1], p_ck = c.clock[i - 1];
      const int64_t p_end = p_ck + c.length[i - 1];
      l = inside(c.o_cl[i], c.o_ck[i], p_cl, p_ck, p_end);
      r = inside(c.r_cl[i], c.r_ck[i], p_cl, p_ck, p_end);
    }
    left[i] = l;
    right[i] = r;
    flag = !(l || r);
  }
  const int64_t v = block_scan(flag, ws);
  if (i < n) run_id[i] = v;
  if (threadIdx.x == kTile - 1) tile_sum[blockIdx.x] = v;
}

__global__ void scan_offsets(int64_t* __restrict__ tile_sum, int64_t n_tiles) {
  __shared__ int64_t ws[kTile / 32];
  __shared__ int64_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < n_tiles; base += kTile) {
    const int64_t i = base + threadIdx.x;
    const int64_t x = i < n_tiles ? tile_sum[i] : 0;
    const int64_t v = block_scan(x, ws);  // ends with a barrier: carry read
    const int64_t c = carry;
    if (i < n_tiles) tile_sum[i] = c + v - x;
    __syncthreads();
    if (threadIdx.x == kTile - 1) carry = c + v;
    __syncthreads();
  }
}

__global__ void add_offsets(int64_t* __restrict__ run_id,
                            const int64_t* __restrict__ offset, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  if (blockIdx.x > 0 && i < n) run_id[i] += offset[blockIdx.x];
}

}  // namespace

// doc may be null (the per-doc variant).  tile_sum: ceil(n / 1024) int64
// of scratch.
extern "C" int ytpu_conflict_scan(const void* doc, const void* client,
                                  const void* clock, const void* length,
                                  const void* o_cl, const void* o_ck,
                                  const void* r_cl, const void* r_ck,
                                  void* left, void* right, void* run_id,
                                  void* tile_sum, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Cols c{static_cast<const int64_t*>(doc),
               static_cast<const int64_t*>(client),
               static_cast<const int64_t*>(clock),
               static_cast<const int64_t*>(length),
               static_cast<const int64_t*>(o_cl),
               static_cast<const int64_t*>(o_ck),
               static_cast<const int64_t*>(r_cl),
               static_cast<const int64_t*>(r_ck)};
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* sums = static_cast<int64_t*>(tile_sum);
  int64_t* ids = static_cast<int64_t*>(run_id);
  scan_tiles<<<(unsigned)tiles, kTile, 0, s>>>(
      c, static_cast<uint8_t*>(left), static_cast<uint8_t*>(right), ids,
      sums, n);
  if (tiles > 1) {
    scan_offsets<<<1, kTile, 0, s>>>(sums, tiles);
    add_offsets<<<(unsigned)tiles, kTile, 0, s>>>(ids, sums, n);
  }
  return (int)cudaGetLastError();
}
