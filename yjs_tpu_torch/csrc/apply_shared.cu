// apply_shared: ONE doc's resolved delta written into every doc of the
// batch (the B4 broadcast replay).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py apply_plan_shared
// (:449), a jitted XLA scatter of one delta broadcast over the doc axis.
//
// Bound on the card: bytes.  It reads the lanes vector once and stores
// one element per in-bounds target per doc: 4 bytes into right_link or
// starts, 1 byte into deleted.  At the B4 replay (9372 links and 4216
// delete marks a doc) 16384 docs are ~0.68 GB of stores, ~0.2 ms at
// 3.35 TB/s; the lanes are a few KB.
//
// Design: everything that does not depend on the doc is done once a block,
// out of the loop over docs.  A block takes one tile (link tiles of kTile
// lanes, then head tiles, then delete tiles of kDelRows table rows) of
// one of G doc groups, the tile index running fastest; group g's docs are
// g, g + G, g + 2 G, ..., so the blocks in flight together write whole
// rows of neighbouring docs (G from the docs a block the wrapper picks by
// the card's SM count, kernels.shared_docs_a_block).
// - Link and head tiles.  A block reads its kTile lanes once, applies
//   JAX's index rules (a negative target counts from the end, what is
//   still outside the table is dropped; the packers' padding is such a
//   target) and compacts the kept (target, value) pairs into shared
//   memory in lane order by a block scan of the per-thread counts (a tile
//   of padding keeps nothing and its blocks leave at once).  It then walks
//   its docs.  Where the kept targets are one ascending run (a fresh
//   replay links every row in order) each doc's run goes out as aligned
//   16-byte stores, with scalar heads and tails for the doc's alignment
//   (rows of an odd width start at any 4-byte phase), from values each
//   thread holds in registers for every alignment; otherwise one scalar
//   store an entry, target and value read from shared memory,
//   consecutive threads on consecutive entries, and a tile of fewer
//   entries than half the block's threads spreads its threads over
//   several docs at once.
// - Delete tiles.  The plan's delete targets are not in row order, and a
//   warp's one-byte stores to scattered places of a row are as many L2
//   sector writes.  Every doc gets the same marks, so a delete block
//   reads ALL the section's lanes once into a bitmap of its kDelRows
//   rows (in shared memory), and per doc writes the row's aligned 16-byte
//   groups that hold a mark: all sixteen bytes marked, a plain store;
//   some, the group read (kDelUnroll a thread in flight) and its marks
//   OR-ed in (bool bytes are 0 or 1, so OR-ing 1 is setting True); the
//   first and last group of the block's span in a doc's row, which may
//   hold another doc's or block's bytes, by a word atomicOr each.
//   Duplicate marks merge, as JAX's set of True would.  A row's marks
//   touch most of its 32-byte sectors, so its bytes are read and written
//   whole either way; the bound counts one byte a mark.
// The row pointer is 64-bit (B x (N+1) passes 2**31 at ~230k B4 docs) and
// advances by a multiple of the row width: no division and no 64-bit
// multiply in the loop over docs.  Targets are unique within a section
// (JAX's unique_indices), so no two stores of a section meet; the
// sections write different tables.  Registers are capped at 48 a thread
// (five blocks an SM) without spills; a 32-register cap spilled inside the
// loops and wrote the B4 replay's links ~1.4x slower on an H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // _cuda.SHARED_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;  // lanes a thread
constexpr int kTile = kThreads * kLanes;  // _cuda.SHARED_TILE
// table rows a delete tile covers: one bit a row in kTile int32 words,
// less the word that extraction reads past the last (_cuda.SHARED_DEL_ROWS)
constexpr int kDelRows = (kTile - 1) * 32;
// the most tiles of one doc group
constexpr int kMaxTiles = 65535;
// blocks an SM holds: the register cap (48 a thread) that lets it hold
// them (_cuda.SHARED_BLOCKS_SM)
constexpr int kMinBlocks = 5;
// the 16-byte groups of a delete span a thread reads before it writes
constexpr int kDelUnroll = 2;

// JAX scatter index rules: a negative index counts from the end, what is
// still outside [0, n) is dropped.  Returns -1 for a dropped index.
__device__ __forceinline__ int norm_index(int32_t r, int n) {
  const int64_t x = r < 0 ? (int64_t)r + n : (int64_t)r;
  return (x >= 0 && x < n) ? (int)x : -1;
}

// Exclusive scan of x over the block, the block's sum into total; every
// thread calls it.  ws holds kWarps partial sums; the closing barrier
// lets the caller reuse ws and what it wrote before the call.
__device__ __forceinline__ int block_scan(int x, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? ws[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kWarps) ws[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? ws[warp - 1] : 0) + inc - x;
  total = ws[kWarps - 1];
  __syncthreads();
  return before;
}

// The tile's kept targets of a section of k lanes (idx[0, k), values
// vals[0, k)) into s_tgt / s_val in lane order; returns their count, and
// in `run` whether they are one ascending run of consecutive targets.
// first: the tile's first lane; n: the table's row width.  Two passes
// over the thread's lanes (count, then place; the second reads L1), so
// no lane is held in registers across the scan.
__device__ int compact(const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ vals, int k, int n,
                       int first, int32_t* s_tgt, int32_t* s_val, int* ws,
                       bool& run) {
  const int lo = first + (int)threadIdx.x * kLanes;
  const int hi = lo + kLanes < k ? lo + kLanes : k;
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += norm_index(idx[i], n) >= 0;
  int c;
  const int pos0 = block_scan(cnt, ws, c);
  int pos = pos0;
  for (int i = lo; i < hi; ++i) {
    const int r = norm_index(idx[i], n);
    if (r >= 0) {
      s_tgt[pos] = r;
      s_val[pos] = vals[i];
      ++pos;
    }
  }
  __syncthreads();
  bool ok = true;
  if (c > 0) {
    const int t0 = s_tgt[0];
    for (int j = pos0; j < pos; ++j) ok &= s_tgt[j] == t0 + j;
  }
  run = __syncthreads_and(ok) != 0;
  return c;
}

// The c compacted entries written into rows d0, d0 + g, ... (< b) of
// `table` (row width n) one scalar store an entry: target s_tgt[j], value
// s_val[j].
__device__ __forceinline__ void fan_out(int32_t* __restrict__ table, int n,
                                        int64_t d0, int64_t b, int64_t g,
                                        const int32_t* s_tgt,
                                        const int32_t* s_val, int c) {
  const int t = threadIdx.x;
  // docs a pass, the thread's first entry and doc, its entries' stride
  int per = 1, j0 = t, doc0 = 0, jstep = kThreads;
  if (2 * c <= kThreads) {  // few entries: several docs a pass
    per = kThreads / c;
    doc0 = t / c;
    j0 = t - doc0 * c;
    jstep = c;  // one entry a thread
    if (doc0 >= per) return;
  }
  const int64_t step_d = per * g, step = step_d * n;
  int32_t* row = table + (d0 + doc0 * g) * (int64_t)n;
  for (int64_t d = d0 + doc0 * g; d < b; d += step_d, row += step) {
    for (int j = j0; j < c; j += jstep) row[s_tgt[j]] = s_val[j];
  }
}

// The quads a thread stores a doc in fan_out_run (a whole tile).
constexpr int kQuads = kTile / 4 / kThreads;

// Quad u's four values at phase h: r[h .. h + 3] (h uniform over the
// block, so the switch does not diverge).
__device__ __forceinline__ int4 quad_at(const int32_t (&r)[7], int h) {
  switch (h) {
    case 0: return make_int4(r[0], r[1], r[2], r[3]);
    case 1: return make_int4(r[1], r[2], r[3], r[4]);
    case 2: return make_int4(r[2], r[3], r[4], r[5]);
    default: return make_int4(r[3], r[4], r[5], r[6]);
  }
}

// The same when the c targets are the ascending run t0 .. t0 + c - 1:
// each doc's run as 16-byte stores from its first 16-byte boundary, the
// elements before and after it one by one.  Where the boundary falls (h
// elements in, 0 to 3) depends on the doc; a thread holds the 7 values
// that its quads take at any h in registers, so the loop over docs reads
// shared memory only for the heads and tails.
__device__ __forceinline__ void fan_out_run(int32_t* __restrict__ table,
                                            int n, int64_t d0, int64_t b,
                                            int64_t g, int t0,
                                            const int32_t* s_val, int c) {
  const int t = threadIdx.x;
  int32_t r[kQuads][7];
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int base = 4 * (t + u * kThreads);
#pragma unroll
    for (int k = 0; k < 7; ++k) r[u][k] = base + k < c ? s_val[base + k] : 0;
  }
  const int64_t step = g * n;
  int32_t* a = table + d0 * (int64_t)n + t0;
  for (int64_t d = d0; d < b; d += g, a += step) {
    const int ph = (int)((reinterpret_cast<uintptr_t>(a) >> 2) & 3);
    const int h = min(c, (4 - ph) & 3);  // elements before the boundary
    const int nq = (c - h) >> 2;
    const int tail = h + 4 * nq;
    if (t < h) a[t] = s_val[t];
    if (t < c - tail) a[tail + t] = s_val[tail + t];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int q = t + u * kThreads;
      if (q < nq) *reinterpret_cast<int4*>(a + h + 4 * q) = quad_at(r[u], h);
    }
  }
}

// The four byte-masks (0x01 in each marked byte) of bitmap bits m16.
__device__ __forceinline__ uint32_t byte_mask(uint32_t m16, int k) {
  const uint32_t m4 = (m16 >> (4 * k)) & 0xFu;
  return (m4 & 1u) | ((m4 & 2u) << 7) | ((m4 & 4u) << 14) | ((m4 & 8u) << 21);
}

// The bitmap's 16 bits from span position pos (which may be negative: the
// bits before 0 are clear) on; the bitmap has a zero word past its last.
__device__ __forceinline__ uint32_t marks16(const uint32_t* bits, int pos) {
  if (pos < 0) return (bits[0] << -pos) & 0xFFFFu;
  const uint64_t two = bits[pos >> 5] | ((uint64_t)bits[(pos >> 5) + 1] << 32);
  return (uint32_t)(two >> (pos & 31)) & 0xFFFFu;
}

// Group g's marks m16 OR-ed into v (its bytes, or zeros where every byte
// is marked) and stored; a group that may hold another span's bytes
// (`edge`) by a word atomicOr each.
__device__ __forceinline__ void put_marks(uint4* g, uint32_t m16, bool edge,
                                          uint4 v) {
  if (m16 == 0u) return;
  if (edge) {
    unsigned* w = reinterpret_cast<unsigned*>(g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = byte_mask(m16, k);
      if (m != 0u) atomicOr(w + k, m);
    }
    return;
  }
  v.x |= byte_mask(m16, 0);
  v.y |= byte_mask(m16, 1);
  v.z |= byte_mask(m16, 2);
  v.w |= byte_mask(m16, 3);
  *g = v;
}

// Delete tile y: the marks of rows [lo, lo + kDelRows) of docs d0, d0 +
// g, ... (< b), from all k_d delete lanes, through a bitmap in `bits`
// (kTile words: bit r - lo for row r, then zero words).  Per doc the
// span's aligned 16-byte groups that hold a mark: every byte marked, a
// 16-byte store; some, a 16-byte load, the marks OR-ed in, a 16-byte
// store, a thread's kDelUnroll groups' loads in flight together; the first and
// last group, which may hold another span's bytes, a word atomicOr each.
__device__ void mark_rows(uint8_t* __restrict__ deleted, int n1,
                          int64_t d0, int64_t b, int64_t g,
                          const int32_t* __restrict__ dels, int k_d, int lo,
                          uint32_t* bits) {
  const int t = threadIdx.x;
  const int span = min(kDelRows, n1 - lo);  // rows of this tile
  for (int w = t; w < kTile; w += kThreads) bits[w] = 0u;
  __syncthreads();
  for (int i = t; i < k_d; i += kThreads) {
    const int r = norm_index(dels[i], n1) - lo;
    if (r >= 0 && r < span) atomicOr(&bits[r >> 5], 1u << (r & 31));
  }
  __syncthreads();
  const int64_t step = g * n1;
  uint8_t* at = deleted + d0 * (int64_t)n1 + lo;
  for (int64_t d = d0; d < b; d += g, at += step) {
    // group i's first byte is span position 16 i - ph
    const uintptr_t a = reinterpret_cast<uintptr_t>(at);
    const int ph = (int)(a & 15);
    uint4* g0 = reinterpret_cast<uint4*>(a - ph);
    const int ng = (ph + span + 15) >> 4;
    for (int i0 = t; i0 < ng; i0 += kDelUnroll * kThreads) {
      uint32_t m[kDelUnroll];
      uint4 v[kDelUnroll];
#pragma unroll
      for (int u = 0; u < kDelUnroll; ++u) {  // every load first
        const int i = i0 + u * kThreads;
        m[u] = i < ng ? marks16(bits, 16 * i - ph) : 0u;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (m[u] != 0u && m[u] != 0xFFFFu && i != 0 && i != ng - 1) {
          v[u] = g0[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kDelUnroll; ++u) {
        const int i = i0 + u * kThreads;
        put_marks(g0 + i, m[u], i == 0 || i == ng - 1, v[u]);
      }
    }
  }
}

__host__ __device__ __forceinline__ int tiles_of(int k) {
  return (k + kTile - 1) / kTile;
}

__host__ __device__ __forceinline__ int delete_tiles(int k_d, int n1) {
  return k_d > 0 && n1 > 0 ? (n1 + kDelRows - 1) / kDelRows : 0;
}

// Block g * tiles + y takes tile y (links, heads, deletes) of doc group g
// (docs g, g + G, ...): the blocks in flight together write the whole
// rows of neighbouring docs; see the top.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    apply_shared_kernel(const int32_t* __restrict__ lanes,
                        int32_t* __restrict__ right,
                        uint8_t* __restrict__ deleted,
                        int32_t* __restrict__ starts, int64_t b, int n1,
                        int s1, int k_l, int k_h, int k_d, int tiles) {
  __shared__ int32_t s_tgt[kTile];
  __shared__ int32_t s_val[kTile];
  __shared__ int ws[kWarps];
  const int groups = (int)(gridDim.x / tiles);  // once a block
  const int group = (int)(blockIdx.x / tiles);
  int y = (int)blockIdx.x - group * tiles;
  const int t_l = tiles_of(k_l), t_h = tiles_of(k_h);
  if (y < t_l + t_h) {
    const bool link = y < t_l;
    const int32_t* idx = link ? lanes : lanes + 2 * (int64_t)k_l;
    const int k = link ? k_l : k_h, n = link ? n1 : s1;
    int32_t* table = link ? right : starts;
    if (!link) y -= t_l;
    bool run;
    const int c = compact(idx, idx + k, k, n, y * kTile, s_tgt, s_val, ws,
                          run);
    if (run && 2 * c > kThreads) {
      fan_out_run(table, n, group, b, groups, s_tgt[0], s_val, c);
    } else if (c > 0) {
      fan_out(table, n, group, b, groups, s_tgt, s_val, c);
    }
  } else {
    y -= t_l + t_h;
    mark_rows(deleted, n1, group, b, groups,
              lanes + 2 * (int64_t)k_l + 2 * (int64_t)k_h, k_d,
              y * kDelRows, reinterpret_cast<uint32_t*>(s_val));
  }
}

}  // namespace

// lanes: [rows|vals] * k_l, [segs|hvals] * k_h, [dels] * k_d (int32);
// right, deleted (bool): [b, n1]; starts: [b, s1]; docs: the docs a
// block (>= 1).  One launch.
extern "C" int ytpu_apply_plan_shared(const void* lanes, void* right,
                                      void* deleted, void* starts,
                                      long long b, int n1, int s1, int k_l,
                                      int k_h, int k_d, int docs,
                                      void* stream) {
  if (b < 0 || k_l < 0 || k_h < 0 || k_d < 0 || docs < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (long long)tiles_of(k_l) + tiles_of(k_h) +
                          delete_tiles(k_d, n1);
  if (b == 0 || tiles == 0) return (int)cudaSuccess;
  const long long groups = (b + docs - 1) / docs;
  if (tiles > kMaxTiles || groups * tiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  apply_shared_kernel<<<(unsigned)(groups * tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lanes), static_cast<int32_t*>(right),
      static_cast<uint8_t*>(deleted), static_cast<int32_t*>(starts), b, n1,
      s1, k_l, k_h, k_d, (int)tiles);
  return (int)cudaGetLastError();
}
