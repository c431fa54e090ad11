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
// doc column) int64 values and writes two bytes and one int64: 2^20 lanes
// move ~78 MB, ~0.023 ms at 3.35 TB/s.
//
// Design: one single-pass launch with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), which moves each of those bytes once:
// - A tile is kThreads * kLanes lanes (of 4, 8 and 16 lanes a thread, 8
//   was within 1% of the best at 2^20 lanes and the best at 2^22; PERF.md
//   §6).  Each warp owns a run of 64-lane chunks; in a chunk a thread
//   holds lanes 2t and 2t+1, read as one 16-byte load a column
//   where the column is 16-byte aligned (two 8-byte loads where it is
//   not), the next chunk's loads in flight while this one is scanned.
//   Lane 2t's predecessor comes from lane t-1 by a shuffle, lane 0's from
//   the chunk before by a shuffle, the warp's first lane's by one halo
//   load.
// - A chunk's masks and chain breaks are six warp ballots; left and right
//   go out as 16-byte words (8 threads), a run id's count is two popcounts
//   and run_id goes out 16 bytes a thread, once, already final.
// - The launch has as many blocks as the card holds at once (at most one
//   a tile).  A block takes each tile from a ticket (an atomicAdd), so a
//   tile's predecessors are already running or done: no deadlock at any
//   occupancy.  It publishes the tile's aggregate at once in a 64-bit
//   status word (2-bit state: none / aggregate / inclusive prefix; 62-bit
//   value), scans its next tile, and only then looks back: one warp reads
//   up to 256 predecessors' words a step with relaxed loads (an acquire
//   would invalidate the SM's L1), publishes the inclusive prefix and the
//   block writes that tile's run ids.  Looking back a tile late keeps a
//   block's loads going while a straggling predecessor finishes, where a
//   block that waited at once held its SM slot idle.  The word carries
//   its value, so the look-back needs no fence.
// - The ticket, a done-count and the status words live in one int64
//   scratch a device and stream that the wrapper keeps zeroed: the last
//   block to finish (its release add on the done-count, after every other
//   block's last read of a status word) clears what the launch used, so no
//   memset and no epoch from the host (a CUDA graph replays the same
//   arguments).  A launch of one tile takes no ticket and no scratch.
//
// Output: one buffer, run_id (n int64) first, then left and right (n
// bytes each), each of the two at a multiple of kAlign bytes (the
// wrapper's views, _cuda.scan_layout).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // _cuda.SCAN_THREADS
constexpr int kLanes = 8;      // lanes a thread, _cuda.SCAN_LANES
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = kLanes / 2;  // 64-lane chunks a warp
constexpr int kAlign = 16;  // _cuda.SCAN_ALIGN
// the scratch, in int64 words: the ticket and the done-count on 128-byte
// lines of their own, then one status word a tile
constexpr int kTicket = 0;
constexpr int kDone = 16;
constexpr int kHead = 32;  // _cuda.SCAN_HEAD
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;
constexpr unsigned kPollMaxNs = 256;
// the look-back's step: kWindow status words, kRows rows of one warp
constexpr int kRows = 8;
constexpr int kWindow = 32 * kRows;
constexpr unsigned kFull = 0xffffffffu;

// the columns, doc first (null in the per-doc form)
enum Col { kDoc = 0, kClient, kClock, kLength, kOCl, kOCk, kRCl, kRCk, kCols };

struct Cols {
  const int64_t* c[kCols];
};

struct Pair {
  int64_t x, y;  // lanes i and i+1
};

// A thread's two lanes of a 64-lane chunk, every column (doc: 0 in the
// per-doc form).
struct Lanes {
  Pair d, cl, ck, len, ocl, ock, rcl, rck;
};

// Lanes i and i+1 of column p (i even); lanes past n read as fill.
// kWhole: both lie below n and the column is 16-byte aligned.
template <bool kWhole>
__device__ __forceinline__ Pair load_pair(const int64_t* __restrict__ p,
                                          int64_t i, int64_t n, bool vec,
                                          int64_t fill) {
  if (kWhole || (i + 1 < n && vec)) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p + i));
    return {v.x, v.y};
  }
  if (i + 1 < n) return {__ldg(p + i), __ldg(p + i + 1)};
  return {i < n ? __ldg(p + i) : fill, fill};
}

template <bool kHasDoc, bool kWhole>
__device__ __forceinline__ Lanes load_lanes(const Cols& c, unsigned vec,
                                            int64_t i, int64_t n) {
  Lanes v;
  v.d = kHasDoc ? load_pair<kWhole>(c.c[kDoc], i, n, vec & (1u << kDoc), -1)
                : Pair{0, 0};
  v.cl = load_pair<kWhole>(c.c[kClient], i, n, vec & (1u << kClient), -1);
  v.ck = load_pair<kWhole>(c.c[kClock], i, n, vec & (1u << kClock), 0);
  v.len = load_pair<kWhole>(c.c[kLength], i, n, vec & (1u << kLength), 0);
  v.ocl = load_pair<kWhole>(c.c[kOCl], i, n, vec & (1u << kOCl), -1);
  v.ock = load_pair<kWhole>(c.c[kOCk], i, n, vec & (1u << kOCk), 0);
  v.rcl = load_pair<kWhole>(c.c[kRCl], i, n, vec & (1u << kRCl), -1);
  v.rck = load_pair<kWhole>(c.c[kRCk], i, n, vec & (1u << kRCk), 0);
  return v;
}

// The lane before a chunk's first: doc, client, clock, clock + length.
struct Prev {
  int64_t doc, cl, ck, end;
};

__device__ __forceinline__ bool inside(int64_t a_cl, int64_t a_ck,
                                       int64_t p_cl, int64_t p_ck,
                                       int64_t p_end) {
  return a_cl == p_cl && a_cl >= 0 && a_ck >= p_ck && a_ck < p_end;
}

// The 16 bytes of lanes 16k .. 16k+15 of a 64-lane chunk whose lane
// 2u + b has bit u of m_b: one byte (0 or 1) a lane.
__device__ __forceinline__ uint4 mask_bytes(unsigned m0, unsigned m1, int k) {
  const unsigned x0 = m0 >> (8 * k), x1 = m1 >> (8 * k);
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = ((x0 >> (2 * q)) & 1u) | (((x1 >> (2 * q)) & 1u) << 8) |
           (((x0 >> (2 * q + 1)) & 1u) << 16) |
           (((x1 >> (2 * q + 1)) & 1u) << 24);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One 64-lane chunk at lane `at` whose lanes the warp holds in v: writes
// its left and right bytes, returns its chain breaks of lanes 2t (b0) and
// 2t+1 (b1) as ballots, and moves p on to its last lane.
template <bool kHasDoc>
__device__ __forceinline__ void scan_chunk(const Lanes& v, int64_t at,
                                           int64_t n, int lane, Prev& p,
                                           uint8_t* __restrict__ left,
                                           uint8_t* __restrict__ right,
                                           unsigned& b0, unsigned& b1) {
  const int64_t i = at + 2 * lane;
  const int64_t end1 = v.ck.y + v.len.y;
  // lane i's predecessor: lane i-1, held by the thread before (by p for
  // the warp's lane 0)
  Prev q{kHasDoc ? (int64_t)__shfl_up_sync(kFull, v.d.y, 1) : 0,
         __shfl_up_sync(kFull, v.cl.y, 1), __shfl_up_sync(kFull, v.ck.y, 1),
         __shfl_up_sync(kFull, end1, 1)};
  if (lane == 0) q = p;
  p = Prev{kHasDoc ? (int64_t)__shfl_sync(kFull, v.d.y, 31) : 0,
           __shfl_sync(kFull, v.cl.y, 31), __shfl_sync(kFull, v.ck.y, 31),
           __shfl_sync(kFull, end1, 31)};
  bool l0 = false, r0 = false;
  if (i > 0 && (!kHasDoc || v.d.x == q.doc)) {
    l0 = inside(v.ocl.x, v.ock.x, q.cl, q.ck, q.end);
    r0 = inside(v.rcl.x, v.rck.x, q.cl, q.ck, q.end);
  }
  const int64_t end0 = v.ck.x + v.len.x;
  const bool same1 = !kHasDoc || v.d.y == v.d.x;
  const bool l1 = same1 && inside(v.ocl.y, v.ock.y, v.cl.x, v.ck.x, end0);
  const bool r1 = same1 && inside(v.rcl.y, v.rck.y, v.cl.x, v.ck.x, end0);
  const bool v0 = i < n, v1 = i + 1 < n;
  const unsigned lm0 = __ballot_sync(kFull, v0 && l0);
  const unsigned lm1 = __ballot_sync(kFull, v1 && l1);
  const unsigned rm0 = __ballot_sync(kFull, v0 && r0);
  const unsigned rm1 = __ballot_sync(kFull, v1 && r1);
  b0 = __ballot_sync(kFull, v0 && !(l0 || r0));
  b1 = __ballot_sync(kFull, v1 && !(l1 || r1));
  // left (threads 0-3) and right (4-7), 16 lanes a thread
  const int k = lane & 3;
  if (lane < 8 && at + 16 * k < n) {
    const bool r = lane >= 4;
    *reinterpret_cast<uint4*>((r ? right : left) + at + 16 * k) =
        mask_bytes(r ? rm0 : lm0, r ? rm1 : lm1, k);
  }
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long add_release(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.release.gpu.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Tile t's exclusive prefix, by the whole of warp 0, once the tile has
// published its aggregate agg: sums the predecessors' words back to the
// nearest inclusive prefix and publishes the tile's inclusive prefix.  A
// step reads the kWindow words before `end` as kRows rows of 32
// consecutive words (each row one coalesced load, all in flight at once;
// row kRows-1, lane 31 the nearest tile; a word before tile 0 reads as
// prefix 0).  It stops at the nearest prefix above which every word is
// published, and reads the window again while an unpublished word lies
// above every prefix.
__device__ long long look_back(unsigned long long* status, long long t,
                               long long agg, int lane) {
  long long excl = 0;
  for (long long end = t;; end -= kWindow) {
    unsigned long long w[kRows];
    int stop_row, stop_lane;
    unsigned ns = 32;
    for (;;) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long idx = end - kWindow + 32 * r + lane;
        w[r] = idx >= 0 ? ld_relaxed(status + idx) : kPrefix;
      }
      stop_row = stop_lane = -1;
      bool blocked = false;
#pragma unroll
      for (int r = kRows - 1; r >= 0; --r) {
        const unsigned inv = __ballot_sync(kFull, (w[r] >> 62) == 0);
        const unsigned pre = __ballot_sync(kFull, (w[r] >> 62) == 2);
        if (stop_row < 0 && !blocked) {
          // the prefixes above the row's highest unpublished word
          const int hi = 31 - __clz(inv);  // -1 when none
          const unsigned s = pre & (hi >= 31 ? 0u : (~0u << (hi + 1)));
          if (s) {
            stop_row = r;
            stop_lane = 31 - __clz(s);
          } else if (inv) {
            blocked = true;
          }
        }
      }
      if (!blocked) break;
      __nanosleep(ns);
      if (ns < kPollMaxNs) ns <<= 1;
    }
    long long v = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r > stop_row || (r == stop_row && lane >= stop_lane)) {
        v += (long long)(w[r] & kValue);
      }
    }
    excl += warp_sum(v);
    if (stop_row >= 0) break;
  }
  if (lane == 0) {
    st_relaxed(status + t, kPrefix | (unsigned long long)(excl + agg));
  }
  return excl;
}

// One launch: `tiles` tiles over at most as many blocks as the card holds
// at once; each block takes tiles by ticket until none is left.  A block
// scans its tile and publishes the aggregate, then scans its next tile
// before it looks back for the one before and writes that one's run ids:
// the predecessors have had a tile's time to publish, and the block's
// loads are not held up by their stragglers.  The chain breaks of the
// tile waiting for its prefix stay in shared memory.
template <bool kHasDoc>
__global__ void __launch_bounds__(kThreads, 2)
    conflict_scan_kernel(const Cols c, unsigned vec,
                         int64_t* __restrict__ run_id,
                         uint8_t* __restrict__ left,
                         uint8_t* __restrict__ right,
                         unsigned long long* __restrict__ scratch, int64_t n,
                         long long tiles) {
  constexpr int kWarpLanes = 64 * kPairs;
  constexpr int kTileLanes = kWarps * kWarpLanes;
  __shared__ long long s_tile, s_prefix;
  // the tile being scanned (slot) and the one waiting for its prefix
  // (slot ^ 1): each warp's exclusive offset, each chunk's chain breaks
  // of lanes 2t and 2t+1
  __shared__ long long s_warp[2][kWarps];
  __shared__ unsigned s_brk[2][kWarps][kPairs][2];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool multi = tiles > 1;
  const bool aligned = (vec | (kHasDoc ? 0u : 1u)) == 0xffu;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* status = multi ? scratch + kHead : nullptr;
  long long prev = -1;  // the tile waiting for its prefix
  long long agg = 0, prev_agg = 0;  // tile aggregates, in warp 0
  int slot = 0;
  for (long long k = 0;; ++k) {
    long long t = k;
    if (multi) {
      if (threadIdx.x == 0) {
        s_tile = (long long)atomicAdd(scratch + kTicket, 1ull);
      }
      __syncthreads();
      t = s_tile;
    }
    if (t < tiles) {
      const int64_t base = t * kTileLanes + (int64_t)warp * kWarpLanes;
      // the predecessor of the warp's first lane
      Prev p{-1, -1, 0, 0};
      if (lane == 0 && base > 0 && base < n) {
        if (kHasDoc) p.doc = __ldg(c.c[kDoc] + base - 1);
        p.cl = __ldg(c.c[kClient] + base - 1);
        p.ck = __ldg(c.c[kClock] + base - 1);
        p.end = p.ck + __ldg(c.c[kLength] + base - 1);
      }
      long long total = 0;
      unsigned b0, b1;
      if (aligned && base + kWarpLanes <= n) {
        // every chunk whole and aligned: the next chunk's loads go out
        // before this one's shuffles and ballots
        Lanes v = load_lanes<kHasDoc, true>(c, vec, base + 2 * lane, n);
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          Lanes next;
          if (j + 1 < kPairs) {
            next = load_lanes<kHasDoc, true>(
                c, vec, base + 64 * (j + 1) + 2 * lane, n);
          }
          scan_chunk<kHasDoc>(v, base + 64 * j, n, lane, p, left, right, b0,
                              b1);
          if (lane == 0) {
            s_brk[slot][warp][j][0] = b0;
            s_brk[slot][warp][j][1] = b1;
          }
          total += __popc(b0) + __popc(b1);
          if (j + 1 < kPairs) v = next;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int64_t at = base + 64 * j;
          b0 = b1 = 0;
          if (at < n) {
            const Lanes v =
                load_lanes<kHasDoc, false>(c, vec, at + 2 * lane, n);
            scan_chunk<kHasDoc>(v, at, n, lane, p, left, right, b0, b1);
          }
          if (lane == 0) {
            s_brk[slot][warp][j][0] = b0;
            s_brk[slot][warp][j][1] = b1;
          }
          total += __popc(b0) + __popc(b1);
        }
      }
      // the warps' exclusive offsets and the tile's aggregate, published
      // at once (tile 0's is its inclusive prefix)
      if (lane == 0) s_warp[slot][warp] = total;
      __syncthreads();
      if (warp == 0) {
        const long long x = lane < kWarps ? s_warp[slot][lane] : 0;
        long long inc = x;
#pragma unroll
        for (int off = 1; off < kWarps; off <<= 1) {
          const long long y = __shfl_up_sync(kFull, inc, off);
          if (lane >= off) inc += y;
        }
        agg = __shfl_sync(kFull, inc, kWarps - 1);
        if (lane < kWarps) s_warp[slot][lane] = inc - x;
        if (multi && lane == 0) {
          st_relaxed(status + t, (t == 0 ? kPrefix : kAggregate) |
                                     (unsigned long long)agg);
        }
      }
    }
    if (prev >= 0) {
      const int ps = slot ^ 1;
      if (warp == 0) {
        const long long excl =
            prev == 0 ? 0 : look_back(status, prev, prev_agg, lane);
        if (lane == 0) s_prefix = excl;
      }
      __syncthreads();
      // its run ids, 16 bytes a thread
      const int64_t at = prev * kTileLanes + (int64_t)warp * kWarpLanes;
      long long run = s_prefix + s_warp[ps][warp];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const unsigned b0 = s_brk[ps][warp][j][0], b1 = s_brk[ps][warp][j][1];
        const int64_t i = at + 64 * j + 2 * lane;
        const long long a = run + __popc(b0 & below) + __popc(b1 & below) +
                            ((b0 >> lane) & 1u);
        const long long b = a + ((b1 >> lane) & 1u);
        if (i + 1 < n) {
          *reinterpret_cast<longlong2*>(run_id + i) = make_longlong2(a, b);
        } else if (i < n) {
          run_id[i] = a;
        }
        run += __popc(b0) + __popc(b1);
      }
    }
    if (t >= tiles) break;
    prev = t;
    prev_agg = agg;
    slot ^= 1;
  }

  if (!multi) return;
  // the last block to finish clears the ticket, the done-count and the
  // status words for the next launch on the stream, after every other
  // block's last read of them (their releases)
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = add_release(scratch + kDone, 1ull) == gridDim.x - 1ull;
    if (s_last) fence_acq_rel();
  }
  __syncthreads();
  if (s_last) {
    for (long long w = threadIdx.x; w < tiles; w += kThreads) status[w] = 0;
    if (threadIdx.x == 0) {
      scratch[kTicket] = 0;
      scratch[kDone] = 0;
    }
  }
}

// The blocks of one launch: as many as the current device holds at once
// (read once a device and build), at most one a tile.
template <bool kHasDoc>
cudaError_t grid_of(long long tiles, unsigned* grid) {
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conflict_scan_kernel<kHasDoc>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms > 1 ? per_sm * sms : 1;
  }
  *grid = (unsigned)(tiles < resident[dev] ? tiles : resident[dev]);
  return cudaSuccess;
}

template <bool kHasDoc>
cudaError_t launch(long long tiles, cudaStream_t s, const Cols& c,
                   unsigned vec, int64_t* run_id, uint8_t* left,
                   uint8_t* right, unsigned long long* scratch, int64_t n) {
  unsigned grid = 0;
  const cudaError_t err = grid_of<kHasDoc>(tiles, &grid);
  if (err != cudaSuccess) return err;
  conflict_scan_kernel<kHasDoc><<<grid, kThreads, 0, s>>>(
      c, vec, run_id, left, right, scratch, n, tiles);
  return cudaGetLastError();
}

}  // namespace

// doc may be null (the per-doc form).  out: the output buffer, kAlign-byte
// aligned, of f + 2 * round_up(n, kAlign) bytes, f = round_up(8n, kAlign):
// run_id, then left at f, then right at f + round_up(n, kAlign).
// scratch: kHead + tiles zeroed int64 (tiles = ceil(n / (kThreads *
// kLanes))), null when one tile.
extern "C" int ytpu_conflict_scan(const void* doc, const void* client,
                                  const void* clock, const void* length,
                                  const void* o_cl, const void* o_ck,
                                  const void* r_cl, const void* r_ck,
                                  void* out, void* scratch, long long n,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long tile = (long long)kThreads * kLanes;
  const long long tiles = (n + tile - 1) / tile;
  if (out == nullptr || reinterpret_cast<uintptr_t>(out) % kAlign != 0 ||
      (tiles > 1 && scratch == nullptr) || tiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Cols c{{static_cast<const int64_t*>(doc),
                static_cast<const int64_t*>(client),
                static_cast<const int64_t*>(clock),
                static_cast<const int64_t*>(length),
                static_cast<const int64_t*>(o_cl),
                static_cast<const int64_t*>(o_ck),
                static_cast<const int64_t*>(r_cl),
                static_cast<const int64_t*>(r_ck)}};
  unsigned vec = 0;
  for (int k = 0; k < kCols; ++k) {
    if (reinterpret_cast<uintptr_t>(c.c[k]) % 16 == 0) vec |= 1u << k;
  }
  int64_t* run_id = static_cast<int64_t*>(out);
  uint8_t* left =
      static_cast<uint8_t*>(out) + (8 * n + kAlign - 1) / kAlign * kAlign;
  uint8_t* right = left + (n + kAlign - 1) / kAlign * kAlign;
  unsigned long long* sc =
      tiles > 1 ? static_cast<unsigned long long*>(scratch) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(doc != nullptr
                   ? launch<true>(tiles, s, c, vec, run_id, left, right, sc,
                                  n)
                   : launch<false>(tiles, s, c, vec, run_id, left, right,
                                   sc, n));
}
