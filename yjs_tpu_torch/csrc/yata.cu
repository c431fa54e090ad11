// The on-device YATA step: the single-item integrate (K4) as one device
// function, shared by the per-item step (K5, YTPU_KERNEL=seq) and the
// level-parallel step (K6, YTPU_KERNEL=levels).
//
// Replaces the TPU kernels of yjs_tpu/ops/kernels.py: _make_integrate_item
// (:106), batch_step (:327) -> _doc_step (:55) -> _apply_deletes (:200), and
// batch_step_levels (:337) -> _doc_step_levels (:209): jitted XLA programs,
// vmapped over docs, with lax.scan over the schedule and lax.while_loop
// over each conflict scan.
//
// Bound on the card: neither bytes nor operations but the chain of
// dependent loads inside one doc.  Each item reads its gap, walks the list
// one right link at a time (each step's address comes from the previous
// load, then its statics and a visit mark), and splices; the items of one
// doc run in causal order.  The byte count of a 4096-doc flush (the
// schedule, the statics rows the scans touch, the link writes) moves in
// tens of microseconds at 3.35 TB/s; the longest doc's chain of dependent
// loads, each an L2 or HBM round trip, takes longer.  The design spreads
// the docs over the SMs and keeps each doc's chain as short as the
// reference's algorithm allows.
//
// Design (simple and exact first; shared-memory state is later work):
// - K4 integrate_item: the reference's conflict scan with visit marks in a
//   per-doc [N+1] int32 scratch row that the wrapper fills with -1 once
//   per launch (one fill a device for all its shards).
//   Instead of the JAX kernel's fresh visit array per item, a per-doc
//   counter runs across the whole launch: scan_base is its value
//   when an item starts and "visited by this item" is visit[row] >=
//   scan_base, so earlier items' marks read as unmarked.  One scan adds at
//   most N+1 to the counter (a list has no more rows; the bound also ends a
//   scan over a corrupt, cyclic list instead of hanging the card); before
//   an item that could carry it past epoch_max, the row is refilled with -1
//   and the counter restarts at 0, so it never passes 2^31 - 1.
// - K5: one thread per doc (32 a block, so 4096 docs spread over 128 SMs):
//   split pre-pass, the causal schedule through K4, deletes, in order.
// - K6: one block per doc, threads striding over the W lanes of a level.
//   (a) every lane reads its gap and decides fast; barrier; (b) the 2W
//   unique-index link writes (masked lanes write NULL to the doc's scratch
//   rows scratch_base + lane, as the reference does) and the head writes;
//   barrier; (c) thread 0 runs the deferred lanes through K4 in ascending
//   lane order; barrier.  All reads of (a) precede every write of (b): the
//   functional semantics of the reference's scatter.
// - K7b batch_step_levels_shared (yjs_tpu/ops/kernels.py:350, the vmap of
//   _doc_step_levels with in_axes=None for everything but the tables and
//   scratch_base: the B4 replay shape) is K6 instantiated with a doc stride
//   of 0 for the static columns, splits, level schedule and deletes, so all
//   docs read one shared copy (L2-resident); the tables, visit scratch,
//   fast flags and scratch_base keep the doc axis.
// - K6 is one launch for every shard of a device (K15, below); K6 alone
//   is its one-shard call and K7b the same launch instantiated shared.
//   A block has at most 128 threads (a W of 512 lanes takes four strides
//   in (a) and (b)), so that an SM holds ten docs' chains at once.
// - K15 sharded_batch_step (yjs_tpu/parallel/mesh.py:101) is K6 on each
//   shard of a doc mesh plus the shard's progress counters: the schedule
//   lanes with a row (lv[..., 0] >= 0) and the delete rows (>= 0), the
//   reference's int32 sums before its psum.  Up to kMaxShards shards of
//   one device travel by value in a __grid_constant__ struct, a row of 16
//   pointers and the doc count each; the grid is (most docs, shards),
//   blockIdx.y picks the shard and blockIdx.x the doc, and blocks past a
//   shard's docs exit.  One launch then holds every doc of the device, so
//   the scheduler overlaps one shard's long chains with another's short
//   ones instead of paying a tail a shard.  The host entry launches more
//   shards in rounds.  With a progress pointer each thread counts the
//   lanes of its gap checks and the delete rows it marks; a warp reduce,
//   one shared atomic a warp and one global atomic a block add them into
//   the shard's zeroed [2] counter.  K6 alone and K7b pass no pointer and
//   count nothing.
// Indices follow XLA's rules: a gather wraps a negative index and clamps,
// a scatter wraps a negative index and drops what is still out of range.
// Client keys hold u32 bit patterns and compare unsigned (YATA case 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNull = -1;
constexpr int32_t kGatherSucc = -2;  // columns.GATHER_SUCC

struct Statics {
  const int32_t* key;
  const int32_t* oslot;
  const int32_t* oclock;
  const int32_t* rslot;
  const int32_t* rclock;
  const int32_t* orow;
};

// One doc's rows of every table.
struct Doc {
  Statics s;
  int32_t* rl;
  uint8_t* dl;
  int32_t* starts;
  int32_t* visit;
  int n1;
  int s1;
};

// sdoc: the statics row to read (doc, or 0 when one row is shared).
__device__ __forceinline__ Doc doc_view(const Statics& s, int32_t* rl,
                                        uint8_t* dl, int32_t* starts,
                                        int32_t* visit, int64_t doc,
                                        int64_t sdoc, int n1, int s1) {
  const int64_t o = doc * n1;
  const int64_t so = sdoc * n1;
  Doc d;
  d.s.key = s.key + so;
  d.s.oslot = s.oslot + so;
  d.s.oclock = s.oclock + so;
  d.s.rslot = s.rslot + so;
  d.s.rclock = s.rclock + so;
  d.s.orow = s.orow + so;
  d.rl = rl + o;
  d.dl = dl + o;
  d.starts = starts + doc * s1;
  d.visit = visit + o;
  d.n1 = n1;
  d.s1 = s1;
  return d;
}

// XLA gather index: wrap a negative index, clamp into [0, n).
__device__ __forceinline__ int64_t gidx(int64_t i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// XLA scatter: wrap a negative index, drop what is still out of range.
template <typename T>
__device__ __forceinline__ void sput(T* a, int n, int64_t i, T v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) a[i] = v;
}

__device__ __forceinline__ bool ids_eq(int32_t s1, int32_t k1, int32_t s2,
                                       int32_t k2) {
  return s1 == s2 && (s1 == kNull || k1 == k2);
}

// K4: integrate item k between left0 and right0 of segment seg; returns
// the doc's visit counter after it.  k < 0 is a padding entry: no write.
__device__ int32_t integrate_item(const Doc& d, int32_t counter,
                                  int32_t epoch_max, int32_t k, int32_t left0,
                                  int32_t right0, int32_t seg) {
  if (k < 0) return counter;
  const int n1 = d.n1;
  const int32_t dummy = n1 - 1;
  if ((int64_t)counter > (int64_t)epoch_max - n1) {
    for (int i = 0; i < n1; ++i) d.visit[i] = kNull;
    counter = 0;
  }
  const int32_t safe_seg = seg >= 0 ? seg : d.s1 - 1;
  const int32_t st = d.starts[gidx(safe_seg, d.s1)];
  const int32_t rl_l = d.rl[gidx(left0 >= 0 ? left0 : dummy, n1)];
  // fast path: the negation of reference Item.js:432-434
  const bool skip =
      left0 == kNull ? (right0 != kNull && st == right0) : rl_l == right0;
  int32_t o = skip ? kNull : (left0 == kNull ? st : rl_l);
  const int32_t scan_base = counter;
  int32_t cnt = counter, clear = counter, left = left0;
  // k's statics only serve the scan: an item whose gap is intact (most
  // of them) reads none
  int32_t k_os = kNull, k_oc = 0, k_rs = kNull, k_rc = 0;
  uint32_t k_key = 0;
  if (o != kNull && o != right0) {
    const int64_t kk = gidx(k, n1);
    k_os = d.s.oslot[kk];
    k_oc = d.s.oclock[kk];
    k_rs = d.s.rslot[kk];
    k_rc = d.s.rclock[kk];
    k_key = (uint32_t)d.s.key[kk];
  }
  for (int steps = 0; o != kNull && o != right0 && steps < n1; ++steps) {
    sput(d.visit, n1, (int64_t)o, cnt);
    ++cnt;
    const int64_t oo = gidx(o, n1);
    const int32_t o_os = d.s.oslot[oo];
    // case 1: same origin -> the lower client id goes left
    const bool same = ids_eq(k_os, k_oc, o_os, d.s.oclock[oo]);
    const bool c1_left = same && (uint32_t)d.s.key[oo] < k_key;
    const bool c1_break =
        same && !c1_left && ids_eq(k_rs, k_rc, d.s.rslot[oo], d.s.rclock[oo]);
    // case 2: o's origin lies between this.origin and this
    const bool has_origin = o_os != kNull;
    const int32_t safe_orow = has_origin ? d.s.orow[oo] : dummy;
    const int32_t v_orow = d.visit[gidx(safe_orow, n1)];
    const bool in_before = has_origin && v_orow >= scan_base;
    const bool c2_left = !same && in_before && !(v_orow >= clear);
    // case 3: an unrelated item ends the scan
    const bool c3_break = !same && !in_before;
    if (c1_left || c2_left) {
      left = o;
      clear = cnt;
    }
    if (c1_break || c3_break) break;
    o = d.rl[oo];
  }
  // splice (reference Item.js:473-489)
  const int32_t right2 =
      left == kNull ? st : d.rl[gidx(left >= 0 ? left : dummy, n1)];
  if (left != kNull) {
    sput(d.rl, n1, (int64_t)left, k);
  } else {
    sput(d.starts, d.s1, (int64_t)safe_seg, k);
  }
  sput(d.rl, n1, (int64_t)k, right2);
  return cnt;
}

// The split pre-pass (the device half of splitItem, Item.js:84-120).
__device__ void split_prepass(const Doc& d, const int32_t* sp, int n) {
  for (int j = 0; j < n; ++j) {
    const int32_t orig = sp[2 * j], nw = sp[2 * j + 1];
    if (orig < 0) continue;
    const int64_t so = gidx(orig, d.n1);
    const int32_t old_right = d.rl[so];
    const uint8_t old_del = d.dl[so];
    sput(d.rl, d.n1, (int64_t)nw, old_right);
    sput(d.rl, d.n1, (int64_t)orig, nw);
    sput(d.dl, d.n1, (int64_t)nw, old_del);
  }
}

__device__ __forceinline__ void delete_row(const Doc& d, int32_t r) {
  if (r >= 0 && r < d.n1) d.dl[r] = 1;
}

__global__ void batch_step_kernel(Statics s, int32_t* rl, uint8_t* dl,
                                  int32_t* starts, int32_t* visit,
                                  const int32_t* __restrict__ splits,
                                  const int32_t* __restrict__ sched,
                                  const int32_t* __restrict__ dels, int b,
                                  int n1, int s1, int n_splits, int m,
                                  int n_del, int32_t epoch_max) {
  const int64_t doc = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (doc >= b) return;
  const Doc d = doc_view(s, rl, dl, starts, visit, doc, doc, n1, s1);
  split_prepass(d, splits + doc * n_splits * 2, n_splits);
  int32_t counter = 0;
  const int32_t* e = sched + doc * m * 4;
  for (int j = 0; j < m; ++j, e += 4) {
    counter = integrate_item(d, counter, epoch_max, e[0], e[1], e[2], e[3]);
  }
  const int32_t* dr = dels + doc * n_del;
  for (int j = 0; j < n_del; ++j) delete_row(d, dr[j]);
}

// The most shards one K6 launch takes: 16 rows of 136 bytes keep the
// parameters under the classic 4 KB.
constexpr int kMaxShards = 16;
// Threads a K6 block at most, and the blocks an SM must hold at once.
// A shard's pointers, picked by blockIdx.y, are loads from the parameter
// bank, which the compiler would otherwise keep in registers (63 a
// thread, 96 shared); ten blocks of 128 keep it at 48.  With 256 threads
// and five blocks an SM the step ran 20% slower than with the pointers
// as plain parameters; with 128 and ten, a little faster (H100).
constexpr int kLevelThreads = 128;
constexpr int kLevelBlocksPerSM = 10;

// One shard's tensors on the launch's device: its statics, tables, its
// rows of the device's visit and fast scratch, its schedules, its
// progress counter (or null) and its doc count.
struct LevelShard {
  Statics s;
  int32_t* rl;
  uint8_t* dl;
  int32_t* starts;
  int32_t* visit;
  uint8_t* fast;
  const int32_t* splits;
  const int32_t* lv;
  const int32_t* dels;
  const int32_t* scratch_base;
  int32_t* progress;
  int64_t b;
};

struct LevelShards {
  LevelShard s[kMaxShards];
};

// kShared: statics, splits, lv and dels hold one doc's worth, read by all.
template <bool kShared>
__global__ void __launch_bounds__(kLevelThreads, kLevelBlocksPerSM)
    batch_step_levels_kernel(const __grid_constant__ LevelShards shards,
                             int n1, int s1, int n_splits, int n_lv, int w,
                             int n_del, int fast_w, int32_t epoch_max) {
  const LevelShard& sh = shards.s[blockIdx.y];
  const int64_t doc = blockIdx.x;
  if (doc >= sh.b) return;  // the whole block: before any barrier
  const int64_t sdoc = kShared ? 0 : doc;  // the shared inputs' doc index
  const int tid = threadIdx.x, nt = blockDim.x;
  const Doc d = doc_view(sh.s, sh.rl, sh.dl, sh.starts, sh.visit, doc, sdoc,
                         n1, s1);
  const int32_t* __restrict__ lv = sh.lv;
  const int32_t* __restrict__ dels = sh.dels;
  uint8_t* f = sh.fast + doc * fast_w;
  const int64_t base = sh.scratch_base[doc];
  const int32_t dummy = n1 - 1, s_dummy = s1 - 1;
  if (tid == 0) split_prepass(d, sh.splits + sdoc * n_splits * 2, n_splits);
  __syncthreads();
  int32_t counter = 0;  // thread 0's: only thread 0 integrates
  int32_t n_valid = 0, n_dels = 0;  // this thread's share of the counters
  for (int lev = 0; lev < n_lv; ++lev) {
    const int32_t* e = lv + (sdoc * n_lv + lev) * (int64_t)w * 8;
    // (a) gap check of every lane
    int pend = 0;
    for (int j = tid; j < w; j += nt) {
      const int32_t* x = e + 8 * j;
      const int32_t k = x[0], r0 = x[2], chk = x[3], seg = x[5];
      const bool mask = k >= 0;
      const int32_t st = d.starts[gidx(seg >= 0 ? seg : s_dummy, s1)];
      const bool fst =
          mask && (chk == kNull ? st == r0
                                : d.rl[gidx(chk >= 0 ? chk : dummy, n1)] == r0);
      f[j] = fst;
      pend |= mask && !fst;
      n_valid += mask;
    }
    pend = __syncthreads_or(pend);
    // (b) the 2W unique-index link writes and the head writes
    for (int j = tid; j < w; j += nt) {
      const int32_t* x = e + 8 * j;
      const int32_t k = x[0], l0 = x[1], r0 = x[2], succ = x[4], seg = x[5];
      const bool fst = f[j];
      const int32_t succ_v = succ == kGatherSucc ? r0 : succ;
      const bool cond1 = fst && l0 >= 0;
      sput(d.rl, n1, cond1 ? (int64_t)l0 : base + j, cond1 ? k : kNull);
      sput(d.rl, n1, fst ? (int64_t)k : base + w + j, fst ? succ_v : kNull);
      if (fst && l0 == kNull) sput(d.starts, s1, (int64_t)seg, k);
    }
    __syncthreads();
    // (c) true conflicts, one at a time, in ascending lane order
    if (pend) {
      if (tid == 0) {
        for (int j = 0; j < w; ++j) {
          const int32_t* x = e + 8 * j;
          if (x[0] >= 0 && !f[j]) {
            counter =
                integrate_item(d, counter, epoch_max, x[0], x[6], x[7], x[5]);
          }
        }
      }
      __syncthreads();
    }
  }
  const int32_t* dr = dels + sdoc * n_del;
  for (int j = tid; j < n_del; j += nt) {
    delete_row(d, dr[j]);
    n_dels += dr[j] >= 0;
  }
  if (!kShared && sh.progress != nullptr) {  // uniform over the block
    __shared__ int32_t red[2];
    if (tid == 0) red[0] = red[1] = 0;
    __syncthreads();
    const unsigned all = 0xffffffffu;
    const int32_t wv = (int32_t)__reduce_add_sync(all, (unsigned)n_valid);
    const int32_t wd = (int32_t)__reduce_add_sync(all, (unsigned)n_dels);
    if ((tid & 31) == 0) {
      atomicAdd(&red[0], wv);
      atomicAdd(&red[1], wd);
    }
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&sh.progress[0], red[0]);
      atomicAdd(&sh.progress[1], red[1]);
    }
  }
}

Statics make_statics(const void* key, const void* oslot, const void* oclock,
                     const void* rslot, const void* rclock,
                     const void* orow) {
  return Statics{static_cast<const int32_t*>(key),
                 static_cast<const int32_t*>(oslot),
                 static_cast<const int32_t*>(oclock),
                 static_cast<const int32_t*>(rslot),
                 static_cast<const int32_t*>(rclock),
                 static_cast<const int32_t*>(orow)};
}

}  // namespace

extern "C" int ytpu_batch_step(const void* key, const void* oslot,
                               const void* oclock, const void* rslot,
                               const void* rclock, const void* orow, void* rl,
                               void* dl, void* starts, void* visit,
                               const void* splits, const void* sched,
                               const void* dels, int b, int n1, int s1,
                               int n_splits, int m, int n_del, int epoch_max,
                               void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  constexpr int kThreads = 32;
  batch_step_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_statics(key, oslot, oclock, rslot, rclock, orow),
      static_cast<int32_t*>(rl), static_cast<uint8_t*>(dl),
      static_cast<int32_t*>(starts), static_cast<int32_t*>(visit),
      static_cast<const int32_t*>(splits), static_cast<const int32_t*>(sched),
      static_cast<const int32_t*>(dels), b, n1, s1, n_splits, m, n_del,
      epoch_max);
  return (int)cudaGetLastError();
}

// desc: n_shards rows of kLevelRow int64: the data_ptr of the six static
// columns (key, oslot, oclock, rslot, rclock, orow), rl, dl, starts,
// visit, fast, splits, lv, dels, scratch_base and progress (0 for none),
// then the shard's doc count; every shard on the current device.  The
// dims are the same for every shard.  shared: K7b's instantiation (the
// statics, splits, lv and dels of one doc, read by all; no progress).
// One launch per kMaxShards shards with docs.
extern "C" int ytpu_batch_step_levels_sharded(
    const long long* desc, int n_shards, int shared, int n1, int s1,
    int n_splits, int n_lv, int w, int n_del, int fast_w, int epoch_max,
    void* stream) {
  constexpr int kLevelRow = 17;
  if (n_shards < 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int threads = ((w + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kLevelThreads) threads = kLevelThreads;
  for (int base = 0; base < n_shards; base += kMaxShards) {
    const int n = n_shards - base < kMaxShards ? n_shards - base : kMaxShards;
    LevelShards p;
    long long max_b = 0;
    for (int k = 0; k < kMaxShards; ++k) {
      const long long* r = desc + kLevelRow * (base + (k < n ? k : 0));
      LevelShard& sh = p.s[k];
      sh.s = make_statics(reinterpret_cast<const void*>(r[0]),
                          reinterpret_cast<const void*>(r[1]),
                          reinterpret_cast<const void*>(r[2]),
                          reinterpret_cast<const void*>(r[3]),
                          reinterpret_cast<const void*>(r[4]),
                          reinterpret_cast<const void*>(r[5]));
      sh.rl = reinterpret_cast<int32_t*>(r[6]);
      sh.dl = reinterpret_cast<uint8_t*>(r[7]);
      sh.starts = reinterpret_cast<int32_t*>(r[8]);
      sh.visit = reinterpret_cast<int32_t*>(r[9]);
      sh.fast = reinterpret_cast<uint8_t*>(r[10]);
      sh.splits = reinterpret_cast<const int32_t*>(r[11]);
      sh.lv = reinterpret_cast<const int32_t*>(r[12]);
      sh.dels = reinterpret_cast<const int32_t*>(r[13]);
      sh.scratch_base = reinterpret_cast<const int32_t*>(r[14]);
      sh.progress = reinterpret_cast<int32_t*>(r[15]);
      sh.b = k < n ? r[16] : 0;
      if (sh.b > max_b) max_b = sh.b;
    }
    if (max_b <= 0) continue;
    const dim3 grid((unsigned)max_b, (unsigned)n);
    if (shared) {
      batch_step_levels_kernel<true><<<grid, threads, 0, st>>>(
          p, n1, s1, n_splits, n_lv, w, n_del, fast_w, epoch_max);
    } else {
      batch_step_levels_kernel<false><<<grid, threads, 0, st>>>(
          p, n1, s1, n_splits, n_lv, w, n_del, fast_w, epoch_max);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
