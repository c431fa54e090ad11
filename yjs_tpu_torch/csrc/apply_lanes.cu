// apply_lanes: the bulk-apply scatter of the default flush.
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py apply_plan2 (:386) ->
// apply_lanes (:406) -> _doc_lanes (:372), a jitted XLA scatter.
//
// Bound on the card: bytes.  It reads the lanes vector once (2 or 4 bytes
// a lane) and stores one element per real lane (4 bytes into right_link or
// starts, 1 byte into deleted); at 3.35 TB/s a 4096-doc flush of ~360K
// lanes is well under a microsecond of traffic.  What it costs is latency:
// the count scan must end before a lane can find its doc, and the dense
// writes before the sparse ones.
//
// Design: ONE launch serves up to kMaxShards shards of one device (the
// shards of a doc mesh, K14, yjs_tpu/parallel/mesh.py sharded_apply_plan
// :134; K1 alone is its one-shard call).  Each shard's {lanes, cum, right,
// deleted, starts, counter, b} travels by value in a __grid_constant__
// struct; the section widths are every shard's.  The phases that were
// three dependent launches run inside the one grid, in this order:
// - the count scans: a block scans one of a shard's four [B] per-doc
//   count vectors (warp-shuffle block scan, kScanItems counts a thread a
//   tile);
// - the dense, head and delete lanes: a block takes `per` chunks of
//   kLanesPerBlock lanes of one section, a lane's doc by a binary search
//   of the section's cumsum (searchsorted side="right", clipped to B-1);
//   the three write different tables, so no order among them is needed;
// - the sparse lanes, whose stores wait for every dense block of their
//   shard: dense and sparse both write right_link, and the reference's
//   sequential scatters let sparse win where both write a row.
// Where the cumsum lies is the variant, which the wrapper picks from the
// largest shard's doc count (kernels.apply_variant):
// - "staged", while a shard's counts fit in shared memory (4 bytes a
//   doc, up to the card's opt-in limit): each lane block scans its own
//   section's counts there and searches them, so no lane block waits on
//   another for its docs; the scan blocks only total the counts for the
//   progress counters;
// - "global": the scan blocks write the shard's [4, B] int32 cum rows
//   into the scratch and publish a flag each; a lane block waits for its
//   section's flag and searches the cum rows where L1 and L2 keep them.
// `per`, the chunks a block takes, is the fewest that fit the lane blocks
// in one wave of the card (as many blocks an SM as its threads and shared
// memory hold), so a block's scan or wait is paid once for all its chunks.
// Ordering by tickets: on entry a block takes the next ticket from a
// device-scope counter, and the ticket, not blockIdx, names its work.
// Tickets follow the order in which blocks start, so a block waits only
// on blocks holding smaller tickets, which are already running: the
// forward-progress argument of a single-pass scan, at any occupancy.  A
// block of a later phase waits (one thread, relaxed loads with
// __nanosleep backoff, then one acquire fence and a barrier) on a
// done-count of its shard and phase; each block of the earlier phase
// publishes with a release atomicAdd after its last store.  A lane block
// loads its first chunk's lanes before it scans or waits, and a sparse
// block finds its docs before it waits on the dense blocks.
//
// The counters (kSyncInts int32, zero between calls) sit in front of the
// cum rows in one scratch per device and stream that the wrapper keeps;
// the last block to finish zeroes them for the next launch on the stream.
// The host entry launches more shards in rounds, one launch each, in
// order on the one stream.
//
// Lanes past a section's total and targets still outside [0, n) after
// JAX's negative-index wrap are dropped, as JAX's mode="drop" drops them.
// Lanes are read at their stored width (int16 or int32) and sign-extended
// in registers.  A doc mesh's shard also wants its progress counters:
// integrated = the dense and sparse counts' sum, deleted = the delete
// counts' sum; the scan has those totals, so with a counter pointer the
// dense, sparse and delete scan blocks add them (int32, wrapping like the
// reference's int32 sum) into the shard's [2] counter with one atomic
// each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 4;
constexpr int kLanesPerBlock = kThreads * kLanesPerThread;
constexpr int kScanItems = 16;
constexpr unsigned kPollMaxNs = 256;
// shared memory a block has without opting into more
constexpr int kDefaultSmem = 48 * 1024;
// the most shards one launch takes (rows of 56 bytes)
constexpr int kMaxShards = 16;

// The counters, in int32 words of the scratch: the ticket, the finished
// blocks, one scan flag a (shard, count vector), one dense done-count a
// shard; counters that many blocks hit sit on 128-byte lines of their own.
constexpr int kTicket = 0;
constexpr int kFinished = 32;
constexpr int kScanDone = 64;
constexpr int kDenseDone = kScanDone + 4 * kMaxShards;
constexpr int kDenseStride = 32;
constexpr int kSyncInts = 1024;  // _cuda.APPLY_SYNC_INTS
static_assert(kDenseDone + kDenseStride * kMaxShards <= kSyncInts,
              "the counters fit the scratch's sync words");

enum Section { kDense = 0, kSparse = 1, kHeads = 2, kDels = 3 };

// One shard: its lanes (int16 or int32), [4, b] cum scratch, tables,
// [2] progress counter (or null) and doc count.
struct ApplyShard {
  const void* lanes;
  int32_t* cum;
  int32_t* right;
  uint8_t* deleted;
  int32_t* starts;
  int32_t* counter;
  int64_t b;
};

struct ApplyShards {
  ApplyShard s[kMaxShards];
};

// The counters' memory order.  A waiting thread polls with relaxed loads
// and takes one acquire fence when the count is there: an acquire load or
// fence invalidates the SM's L1, which the other blocks' binary searches
// on that SM read from, so it is taken once and not at every poll.
// Blocks publish with release RMWs (no L1 invalidation); the bar.sync
// before them brings every thread's stores of the block along.
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ int add_release(int* p, int v) {
  int old;
  asm volatile("atom.release.gpu.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The whole block waits until *flag >= target (set by blocks holding
// smaller tickets).
__device__ __forceinline__ void wait_for(const int* flag, int target) {
  if (threadIdx.x == 0) {
    unsigned ns = 32;
    while (ld_relaxed(flag) < target) {
      __nanosleep(ns);
      if (ns < kPollMaxNs) ns <<= 1;
    }
    fence_acq_rel();
  }
  __syncthreads();
}

// After the block's last store: one more on *flag, every store before it.
__device__ __forceinline__ void publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) add_release(flag, 1);
}

// Inclusive scan of x over the block; every thread calls it.  ws holds
// kWarps partial sums; total gets the block's sum; the closing barrier
// lets the caller reuse ws at once.
__device__ __forceinline__ int32_t block_scan(int32_t x, int32_t* ws,
                                              int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += t;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? ws[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < kWarps) ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += ws[warp - 1];
  total = ws[kWarps - 1];
  __syncthreads();
  return x;
}

// Inclusive cumsum of count vector v of a shard into out (null: the total
// alone): out[i] = sum of lanes[v*b .. v*b+i], a tile of kThreads *
// kScanItems counts at a time (each thread a contiguous run).  Returns
// the vector's total (wrapping).  Every thread of the block calls it.
template <typename T>
__device__ int32_t scan_counts(const ApplyShard& sh, int v, int32_t* ws,
                               int32_t* out) {
  const int b = (int)sh.b;
  const T* __restrict__ cnt = static_cast<const T*>(sh.lanes) + (size_t)v * b;
  int32_t carry = 0;
  for (int base = 0; base < b; base += kThreads * kScanItems) {
    const int lo = base + (int)threadIdx.x * kScanItems;
    int32_t x[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      x[j] = lo + j < b ? (int32_t)cnt[lo + j] : 0;
      sum += x[j];
    }
    int32_t tile;
    int32_t run = carry + block_scan(sum, ws, tile) - sum;
    if (out != nullptr) {
#pragma unroll
      for (int j = 0; j < kScanItems; ++j) {
        run += x[j];
        if (lo + j < b) out[lo + j] = run;
      }
    }
    carry += tile;
  }
  return carry;
}

// First d with cum[d] > lane (searchsorted side="right"), clipped to b-1.
__device__ __forceinline__ int doc_of(const int32_t* cum, int b, int32_t lane) {
  int lo = 0, hi = b;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= lane) lo = mid + 1; else hi = mid;
  }
  return min(lo, b - 1);
}

// JAX scatter index rules: a negative index counts from the end, what is
// still outside [0, n) is dropped.  Returns -1 for a dropped index.
__device__ __forceinline__ int norm_index(int32_t r, int n) {
  const int64_t x = r < 0 ? (int64_t)r + n : (int64_t)r;
  return (x >= 0 && x < n) ? (int)x : -1;
}

__host__ __device__ __forceinline__ int lane_chunks(int k) {
  return (k + kLanesPerBlock - 1) / kLanesPerBlock;
}

// The blocks of a section of k lanes that take `per` chunks each.
__host__ __device__ __forceinline__ int lane_blocks(int k, int per) {
  return (lane_chunks(k) + per - 1) / per;
}

// Chunk i0 / kLanesPerBlock of section kSec (k lanes from lanes[off]):
// thread lanes i0 + j * kThreads, their first and (sparse, heads) second
// words.
template <typename T, int kSec>
__device__ __forceinline__ void load_chunk(const T* __restrict__ lanes,
                                           int off, int k, int i0,
                                           int32_t* a, int32_t* val) {
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int i = i0 + j * kThreads;
    a[j] = 0;
    val[j] = 0;
    if (i < k) {
      a[j] = (int32_t)lanes[off + i];
      if (kSec == kSparse || kSec == kHeads) val[j] = (int32_t)lanes[off + k + i];
    }
  }
}

// Block blk of section kSec (k lanes from lanes[off]) of shard `s`: chunks
// blk * per .. blk * per + per - 1 of kLanesPerBlock lanes, one scan (or
// wait) for all of them.  nb_dn: the shard's dense blocks, which a sparse
// block's stores wait for.
template <typename T, int kSec, bool kStaged>
__device__ void lane_block(const ApplyShard& sh, int* sync, int s, int n1,
                           int s1, int off, int k, int blk, int per,
                           int nb_dn, int32_t* ws, int32_t* stage) {
  const int b = (int)sh.b;
  const T* __restrict__ lanes = static_cast<const T*>(sh.lanes);
  const int c0 = blk * per, c1 = min(c0 + per, lane_chunks(k));
  int32_t a[kLanesPerThread], val[kLanesPerThread];
  load_chunk<T, kSec>(lanes, off, k, c0 * kLanesPerBlock + (int)threadIdx.x,
                      a, val);  // before the scan or the wait
  const int32_t* cum = stage;
  if (kStaged) {
    scan_counts<T>(sh, kSec, ws, stage);
    __syncthreads();
  } else {
    wait_for(&sync[kScanDone + 4 * s + kSec], 1);
    cum = sh.cum + (size_t)kSec * b;
  }
  const int32_t total = cum[b - 1];
  bool waited = kSec != kSparse || nb_dn == 0;
  for (int c = c0; c < c1; ++c) {
    const int i0 = c * kLanesPerBlock + (int)threadIdx.x;
    int32_t na[kLanesPerThread] = {}, nval[kLanesPerThread] = {};
    if (c + 1 < c1) {
      load_chunk<T, kSec>(lanes, off, k, i0 + kLanesPerBlock, na, nval);
    }
    int64_t at[kLanesPerThread];  // the element written, -1 for none
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int i = i0 + j * kThreads;
      at[j] = -1;
      if (i >= k) continue;
      if (kSec == kDense) {
        if (i >= total) continue;  // past the total: dropped
        const int d = doc_of(cum, b, i);
        // the doc's first dense lane: cum[d] - cnt[d], as the reference
        // computes it, is cum[d - 1] in the same int32 arithmetic
        const int r = norm_index(i - (d > 0 ? cum[d - 1] : 0), n1);
        if (r >= 0) at[j] = (int64_t)d * n1 + r;
      } else {
        const int r = norm_index(a[j], kSec == kHeads ? s1 : n1);
        if (r < 0) continue;  // dropped whatever its doc
        const int d = doc_of(cum, b, i);
        at[j] = (int64_t)d * (kSec == kHeads ? s1 : n1) + r;
      }
    }
    if (!waited) {  // the sparse stores: after every dense block's
      wait_for(&sync[kDenseDone + kDenseStride * s], nb_dn);
      waited = true;
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (at[j] < 0) continue;
      if (kSec == kDense) sh.right[at[j]] = a[j];
      else if (kSec == kSparse) sh.right[at[j]] = val[j];
      else if (kSec == kHeads) sh.starts[at[j]] = val[j];
      else sh.deleted[at[j]] = 1;
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      a[j] = na[j];
      val[j] = nval[j];
    }
  }
  if (kSec == kDense) publish(&sync[kDenseDone + kDenseStride * s]);
}

// The one kernel: n shards, each of 4 scan blocks and the lane blocks of
// its sections, gridDim.x = n * (4 + the sections' blocks); see the top.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    apply_lanes_kernel(const __grid_constant__ ApplyShards shards, int n,
                       int n1, int s1, int k_dn, int k_sp, int k_h, int k_d,
                       int per, int* __restrict__ sync) {
  extern __shared__ int32_t stage[];
  __shared__ int32_t ws[kWarps];
  __shared__ int ticket;
  __shared__ bool last;
  if (threadIdx.x == 0) ticket = atomicAdd(&sync[kTicket], 1);
  __syncthreads();
  int t = ticket;
  const int nb_dn = lane_blocks(k_dn, per), nb_h = lane_blocks(k_h, per);
  const int nb_d = lane_blocks(k_d, per);
  if (t < 4 * n) {
    const int s = t >> 2, v = t & 3;
    const ApplyShard& sh = shards.s[s];
    const int32_t total =
        scan_counts<T>(sh, v, ws, kStaged ? nullptr : sh.cum + (size_t)v * sh.b);
    // the section total: dense + sparse into counter[0], deletes into [1]
    if (sh.counter != nullptr && threadIdx.x == 0 && v != kHeads) {
      atomicAdd(&sh.counter[v == kDels ? 1 : 0], total);
    }
    if (!kStaged) publish(&sync[kScanDone + 4 * s + v]);
  } else if ((t -= 4 * n) < n * nb_dn) {
    const int s = t / nb_dn;
    lane_block<T, kDense, kStaged>(shards.s[s], sync, s, n1, s1,
                                   4 * (int)shards.s[s].b, k_dn,
                                   t - s * nb_dn, per, nb_dn, ws, stage);
  } else if ((t -= n * nb_dn) < n * nb_h) {
    const int s = t / nb_h;
    lane_block<T, kHeads, kStaged>(shards.s[s], sync, s, n1, s1,
                                   4 * (int)shards.s[s].b + k_dn + 2 * k_sp,
                                   k_h, t - s * nb_h, per, nb_dn, ws, stage);
  } else if ((t -= n * nb_h) < n * nb_d) {
    const int s = t / nb_d;
    lane_block<T, kDels, kStaged>(
        shards.s[s], sync, s, n1, s1,
        4 * (int)shards.s[s].b + k_dn + 2 * k_sp + 2 * k_h, k_d,
        t - s * nb_d, per, nb_dn, ws, stage);
  } else {
    t -= n * nb_d;
    const int nb_sp = lane_blocks(k_sp, per);
    const int s = t / nb_sp;
    lane_block<T, kSparse, kStaged>(shards.s[s], sync, s, n1, s1,
                                    4 * (int)shards.s[s].b + k_dn, k_sp,
                                    t - s * nb_sp, per, nb_dn, ws, stage);
  }
  // the last block to finish zeroes the counters for the next launch,
  // after every other block's last use of them (their releases)
  __syncthreads();
  if (threadIdx.x == 0) {
    last = add_release(&sync[kFinished], 1) == (int)gridDim.x - 1;
    if (last) fence_acq_rel();
  }
  __syncthreads();
  if (last) {
    for (int i = threadIdx.x; i < kSyncInts; i += kThreads) sync[i] = 0;
  }
}

// The current device's SMs and shared memory an SM, read once a device.
cudaError_t sm_shape(int* sms, int* smem_sm) {
  static int count[64], smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(
        &smem[dev], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  *smem_sm = smem[dev];
  return cudaSuccess;
}

// desc: n_shards rows of 7 int64 — the data_ptr of lanes, cum, right,
// deleted, starts and counter (0 for none), then the doc count b — every
// shard on the current device (a row with b < 1 is skipped); the widths
// are every shard's; sync: the scratch's kSyncInts zeroed counters.
template <typename T>
int apply_lanes_sharded(const long long* desc, int n_shards, int* sync,
                        int n1, int s1, int staged, int k_dn, int k_sp,
                        int k_h, int k_d, cudaStream_t stream) {
  constexpr int kRow = 7;
  if (n_shards < 0 || k_dn < 0 || k_sp < 0 || k_h < 0 || k_d < 0 ||
      sync == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = (long long)lane_chunks(k_dn) + lane_chunks(k_sp) +
                           lane_chunks(k_h) + lane_chunks(k_d);
  int sms = 0, smem_sm = 0;
  const cudaError_t got = sm_shape(&sms, &smem_sm);
  if (got != cudaSuccess) return (int)got;
  int r = 0;
  while (r < n_shards) {
    ApplyShards p = {};
    int n = 0;
    long long max_b = 0;
    for (; r < n_shards && n < kMaxShards; ++r) {
      const long long* row = desc + kRow * r;
      if (row[6] < 1) continue;
      ApplyShard& sh = p.s[n++];
      sh.lanes = reinterpret_cast<const void*>(row[0]);
      sh.cum = reinterpret_cast<int32_t*>(row[1]);
      sh.right = reinterpret_cast<int32_t*>(row[2]);
      sh.deleted = reinterpret_cast<uint8_t*>(row[3]);
      sh.starts = reinterpret_cast<int32_t*>(row[4]);
      sh.counter = reinterpret_cast<int32_t*>(row[5]);
      sh.b = row[6];
      if (sh.b > max_b) max_b = sh.b;
    }
    if (n == 0) break;
    const size_t smem = staged ? (size_t)max_b * 4 : 0;
    if (smem > kDefaultSmem - 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          apply_lanes_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    // chunks a lane block takes: the lane blocks fit one wave of the card
    // (blocks an SM by threads and by shared memory, 1 KB a block reserved)
    const long long by_smem = smem_sm / (long long)(smem + 2048);
    const long long wave =
        (long long)sms * (by_smem < 2048 / kThreads ? by_smem : 2048 / kThreads);
    const long long want = (n * chunks + wave - 1) / (wave > 0 ? wave : 1);
    const int per = want > 1 ? (int)want : 1;
    const long long blocks =
        (long long)n * (4 + lane_blocks(k_dn, per) + lane_blocks(k_sp, per) +
                        lane_blocks(k_h, per) + lane_blocks(k_d, per));
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (staged) {
      apply_lanes_kernel<T, true><<<(unsigned)blocks, kThreads, smem, stream>>>(
              p, n, n1, s1, k_dn, k_sp, k_h, k_d, per, sync);
    } else {
      apply_lanes_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
          p, n, n1, s1, k_dn, k_sp, k_h, k_d, per, sync);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// desc: see apply_lanes_sharded; one launch per 16 shards with docs.
extern "C" int ytpu_apply_lanes_sharded_i32(const long long* desc,
                                            int n_shards, void* sync, int n1,
                                            int s1, int staged, int k_dn,
                                            int k_sp, int k_h, int k_d,
                                            void* stream) {
  return apply_lanes_sharded<int32_t>(desc, n_shards,
                                      static_cast<int*>(sync), n1, s1, staged,
                                      k_dn, k_sp, k_h, k_d,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int ytpu_apply_lanes_sharded_i16(const long long* desc,
                                            int n_shards, void* sync, int n1,
                                            int s1, int staged, int k_dn,
                                            int k_sp, int k_h, int k_d,
                                            void* stream) {
  return apply_lanes_sharded<int16_t>(desc, n_shards,
                                      static_cast<int*>(sync), n1, s1, staged,
                                      k_dn, k_sp, k_h, k_d,
                                      static_cast<cudaStream_t>(stream));
}
