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
// doc run in causal order.  The byte count of a 4096-doc flush moves in
// tens of microseconds at 3.35 TB/s; the longest doc's chain of dependent
// loads, one L2 or HBM round trip a load, took longer.  So a short doc's
// chain runs on shared memory, which answers in tens of cycles, not
// hundreds; a longer doc's rows stay in global memory, where L1 caches
// them, so that an SM holds more docs at once.  What is left is the
// chain's own instructions, and how many docs an SM holds.
//
// Design:
// - Staging.  A block owns one doc.  It copies the doc's link row (rl, N+1
//   int32) and segment heads (starts, S+1 int32) into dynamic shared
//   memory, each placed at its global row's address mod 16 (a row of N+1
//   = 2^k + 1 int32 starts at any 4-byte offset), by asynchronous copies
//   (cp.async: a thread issues its whole share without waiting), 16 bytes
//   a copy but at the ragged ends; writes -1 over a shared visit row of
//   N+1 int32; runs the step on them; and writes both rows back, 16 bytes
//   a store.  Nothing global holds the visit marks, so the wrappers fill
//   no scratch.  `deleted` stays in global memory (only the split pre-pass
//   and the deletes touch it, off the chain), and so do the six static
//   columns, read-only through __ldg: only scan steps read them, and K7b's
//   one shared copy stays in L2.
// - Variants, chosen by the wrapper from N+1, S+1 and W alone
//   (kernels.yata_variant): kShared stages rl, starts, the visit row and
//   K6's fast flags; kRows keeps the visit row in global memory (the
//   wrapper fills it); kGlobal stages nothing, as the kernels did before
//   they staged.  A doc's chain runs on one thread, so the docs an SM
//   holds side by side hide each other's latency, and L1 caches an
//   unstaged doc's rows: a variant is taken only while an SM holds
//   sixteen of its staged docs (kernels.YATA_MIN_DOCS_SM), else the next.
//   On an H100 docs of up to about 1400 rows stage whole, up to about
//   2600 without the visit row, longer ones (the smoke's 4097) nothing.  The wrapper lays the staged rows
//   out (kernels.yata_layout, passed in as a Layout with its bytes).
//   Each variant is its own instantiation, so the compiler sees where
//   every row lies and emits ld.shared / st.shared for the staged ones.
// - K4 integrate_item: the reference's conflict scan with visit marks.
//   Instead of the JAX kernel's fresh visit array per item, a per-doc
//   counter runs across the whole launch: scan_base is its value when an
//   item starts and "visited by this item" is visit[row] >= scan_base, so
//   earlier items' marks read as unmarked.  One scan adds at most N+1 to
//   the counter (a list has no more rows; the bound also ends a scan over
//   a corrupt, cyclic list instead of hanging the card); before an item
//   that could carry it past epoch_max, the row is refilled with -1 and
//   the counter restarts at 0, so it never passes 2^31 - 1.  An item
//   whose scan moved no link re-reads none for its splice.
// - K5: a warp a doc, one doc a block.  Lane 0 runs the causal chain: the
//   split pre-pass, then the schedule through K4.  The warp loads the
//   next 32 schedule entries coalesced, one a lane, while lane 0 works;
//   each lane works out the rows its entry reads and writes on K4's fast
//   path (XLA's clamps and wraps: a function of the entry alone), and the
//   entries and rows reach lane 0 through a 32-entry ring in shared
//   memory, read one entry ahead.  So an item whose gap is intact costs
//   lane 0 two loads, a compare and two stores.  The deletes spread over
//   the lanes.
// - K6: one block per doc, threads striding over the W lanes of a level,
//   a fixed count for each instantiation (kLevelThreads, as measured).
//   (a) every lane reads its gap and flags itself masked, fast or
//   deferred; barrier; (b) the 2W unique-index link writes (masked lanes
//   write NULL to the doc's scratch rows scratch_base + lane, as the
//   reference does) and the head writes; barrier; (c) thread 0 runs the
//   deferred lanes through K4 in ascending lane order; barrier.  All reads
//   of (a) precede every write of (b): the functional semantics of the
//   reference's scatter.
// - K7b batch_step_levels_shared (yjs_tpu/ops/kernels.py:350, the vmap of
//   _doc_step_levels with in_axes=None for everything but the tables and
//   scratch_base: the B4 replay shape) is K6 instantiated with a doc stride
//   of 0 for the static columns, splits, level schedule and deletes, so all
//   docs read one shared copy; the tables, visit and fast scratch and
//   scratch_base keep the doc axis.
// - K6 is one launch for every shard of a device (K15, below); K6 alone
//   is its one-shard call and K7b the same launch instantiated shared.
// - K15 sharded_batch_step (yjs_tpu/parallel/mesh.py:101) is K6 on each
//   shard of a doc mesh plus the shard's progress counters: the schedule
//   lanes with a row (lv[..., 0] >= 0) and the delete rows (>= 0), the
//   reference's int32 sums before its psum.  Up to kMaxShards shards of
//   one device travel by value in a __grid_constant__ struct, a row of 16
//   pointers and the doc count each; the grid is (most docs, shards),
//   blockIdx.y picks the shard and blockIdx.x the doc, and blocks past a
//   shard's docs exit.  The host entry launches more shards in rounds.
//   With a progress pointer each thread counts the lanes of its gap checks
//   and the delete rows it marks; a warp reduce, one shared atomic a warp
//   and one global atomic a block add them into the shard's zeroed [2]
//   counter.  K6 alone and K7b pass no pointer and count nothing.
// Indices follow XLA's rules: a gather wraps a negative index and clamps,
// a scatter wraps a negative index and drops what is still out of range.
// Client keys hold u32 bit patterns and compare unsigned (YATA case 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNull = -1;
constexpr int32_t kGatherSucc = -2;  // columns.GATHER_SUCC
constexpr unsigned kFull = 0xffffffffu;

// Where a doc's rows lie (kernels.YATA_VARIANTS, in this order).
constexpr int kShared = 0;  // rl, starts, visit marks, fast flags
constexpr int kRows = 1;    // rl, starts, fast flags; visit marks global
constexpr int kGlobal = 2;  // nothing staged

// K6 flags a lane in (a), for (b) and (c).
constexpr uint8_t kMasked = 0, kFast = 1, kDeferred = 2;

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

// The doc's rows in global memory.  sdoc: the statics row to read (doc,
// or 0 when one row is shared).  visit may be null (staged).
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
  d.visit = visit != nullptr ? visit + o : nullptr;
  d.n1 = n1;
  d.s1 = s1;
  return d;
}

// Where a staged doc's rows lie in dynamic shared memory, in int32 from
// its start, as kernels.yata_layout lays them out (the one place that
// sizes them): rl from 0 and starts from st, each with room to start at
// its global row's address mod 16, the visit row from visit (kShared),
// K6's fast flags from fast.  All 0 for kGlobal.
struct Layout {
  int st;
  int visit;
  int fast;
};

// The int32 offset (0-3) at which a shared row starts so that it lies at
// its global row's address mod 16.
__device__ __forceinline__ int pad16(const int32_t* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Copies from global into shared memory that the thread does not wait on
// (cp.async, 4 or 16 bytes): a thread issues its whole share of a row at
// once; cp.async.wait_all ends them.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The 16-byte-aligned part of n int32 at g: [head, head + 4 * body).
__device__ __forceinline__ int head16(const int32_t* g, int n) {
  const int h = (4 - pad16(g)) & 3;
  return h < n ? h : n;
}

// Copies a row of n int32 from global g into shared s (s = g mod 16):
// 16 bytes a copy where both are aligned, 4 at the ragged ends.
__device__ __forceinline__ void row_in(int32_t* s, const int32_t* g, int n,
                                       int tid, int nt) {
  const int h = head16(g, n), body = (n - h) / 4;
  for (int j = tid; j < body; j += nt) {
    copy_async16(s + h + 4 * j, g + h + 4 * j);
  }
  for (int i = tid; i < h; i += nt) copy_async(s + i, g + i);
  for (int i = h + 4 * body + tid; i < n; i += nt) copy_async(s + i, g + i);
}

// Writes a shared row of n int32 back to global g (s = g mod 16).
__device__ __forceinline__ void row_out(int32_t* g, const int32_t* s, int n,
                                        int tid, int nt) {
  const int h = head16(g, n), body = (n - h) / 4;
  for (int j = tid; j < body; j += nt) {
    reinterpret_cast<int4*>(g + h)[j] = reinterpret_cast<const int4*>(s + h)[j];
  }
  for (int i = tid; i < h; i += nt) g[i] = s[i];
  for (int i = h + 4 * body + tid; i < n; i += nt) g[i] = s[i];
}

// The view the step runs on: the block's threads copy rl and starts into
// shared memory (kShared, kRows) and write -1 over a shared visit row
// (kShared).  The caller syncs before the rows are read.
template <int kVar>
__device__ __forceinline__ Doc stage_in(const Doc& g, int32_t* smem,
                                        Layout lay, int tid, int nt) {
  Doc d = g;
  if constexpr (kVar != kGlobal) {
    d.rl = smem + pad16(g.rl);
    d.starts = smem + lay.st + pad16(g.starts);
    row_in(d.rl, g.rl, g.n1, tid, nt);
    row_in(d.starts, g.starts, g.s1, tid, nt);
  }
  if constexpr (kVar == kShared) {
    d.visit = smem + lay.visit;
    int4* v = reinterpret_cast<int4*>(d.visit);
    const int4 null4 = make_int4(kNull, kNull, kNull, kNull);
    for (int i = tid; i < (g.n1 + 3) / 4; i += nt) v[i] = null4;
  }
  if constexpr (kVar != kGlobal) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  return d;
}

// Writes the staged rows back; the caller syncs before.
template <int kVar>
__device__ __forceinline__ void stage_out(const Doc& g, const Doc& d, int tid,
                                          int nt) {
  if constexpr (kVar != kGlobal) {
    row_out(g.rl, d.rl, g.n1, tid, nt);
    row_out(g.starts, d.starts, g.s1, tid, nt);
  }
}

// XLA gather index: wrap a negative index, clamp into [0, n).  In 32
// bits: i + n cannot overflow for a negative i and n < 2^31.
__device__ __forceinline__ int gidx(int32_t i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// XLA scatter: wrap a negative index, drop what is still out of range.
// I: int32_t for the integrate's indices, int64_t for the level step's
// scratch rows scratch_base + lane, which may pass 2^31 - 1.
template <typename T, typename I>
__device__ __forceinline__ void sput(T* a, int n, I i, T v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) a[i] = v;
}

__device__ __forceinline__ bool ids_eq(int32_t s1, int32_t k1, int32_t s2,
                                       int32_t k2) {
  return s1 == s2 && (s1 == kNull || k1 == k2);
}

// The counter past which an item restarts the visit epoch: the item
// refills the row when counter > epoch_max - (N+1); the counter is never
// negative, so a negative bound is -1 (every item restarts).
__device__ __forceinline__ int32_t roll_bound(int32_t epoch_max, int n1) {
  const int64_t b = (int64_t)epoch_max - n1;
  return b < 0 ? -1 : (int32_t)b;
}

// K4: integrate item k between left0 and right0 of segment seg; returns
// the doc's visit counter after it.  k < 0 is a padding entry: no write.
// roll: roll_bound of the launch's epoch_max.
__device__ __forceinline__ int32_t integrate_item(const Doc& d, int32_t counter,
                                                  int32_t roll, int32_t k,
                                                  int32_t left0, int32_t right0,
                                                  int32_t seg) {
  if (k < 0) return counter;
  const int n1 = d.n1;
  const int32_t dummy = n1 - 1;
  if (counter > roll) {
    for (int i = 0; i < n1; ++i) d.visit[i] = kNull;
    counter = 0;
  }
  const int32_t safe_seg = seg >= 0 ? seg : d.s1 - 1;
  const int32_t st = d.starts[gidx(safe_seg, d.s1)];
  const int32_t rl_l = d.rl[gidx(left0 >= 0 ? left0 : dummy, n1)];
  // fast path: the negation of reference Item.js:432-434.  An intact gap
  // (most items) splices between left0 and right0 and scans nothing.
  const bool skip =
      left0 == kNull ? (right0 != kNull && st == right0) : rl_l == right0;
  if (skip) {
    if (left0 != kNull) {
      sput(d.rl, n1, left0, k);
    } else {
      sput(d.starts, d.s1, safe_seg, k);
    }
    sput(d.rl, n1, k, left0 == kNull ? st : rl_l);
    return counter;
  }
  int32_t o = left0 == kNull ? st : rl_l;
  const int32_t scan_base = counter;
  int32_t cnt = counter, clear = counter, left = left0;
  // k's statics only serve the scan: an item whose gap is intact (most
  // of them) reads none
  int32_t k_os = kNull, k_oc = 0, k_rs = kNull, k_rc = 0;
  uint32_t k_key = 0;
  if (o != kNull && o != right0) {
    const int kk = gidx(k, n1);
    k_os = __ldg(d.s.oslot + kk);
    k_oc = __ldg(d.s.oclock + kk);
    k_rs = __ldg(d.s.rslot + kk);
    k_rc = __ldg(d.s.rclock + kk);
    k_key = (uint32_t)__ldg(d.s.key + kk);
  }
  for (int steps = 0; o != kNull && o != right0 && steps < n1; ++steps) {
    sput(d.visit, n1, o, cnt);
    ++cnt;
    const int oo = gidx(o, n1);
    const int32_t o_os = __ldg(d.s.oslot + oo);
    // case 1: same origin -> the lower client id goes left
    const bool same = ids_eq(k_os, k_oc, o_os, __ldg(d.s.oclock + oo));
    const bool c1_left = same && (uint32_t)__ldg(d.s.key + oo) < k_key;
    const bool c1_break = same && !c1_left &&
                          ids_eq(k_rs, k_rc, __ldg(d.s.rslot + oo),
                                 __ldg(d.s.rclock + oo));
    // case 2: o's origin lies between this.origin and this
    const bool has_origin = o_os != kNull;
    const int32_t safe_orow = has_origin ? __ldg(d.s.orow + oo) : dummy;
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
  // splice (reference Item.js:473-489); the scan writes no link, so a
  // left that did not move still has the successor read above
  const int32_t right2 =
      left == kNull
          ? st
          : (left == left0 ? rl_l : d.rl[gidx(left >= 0 ? left : dummy, n1)]);
  if (left != kNull) {
    sput(d.rl, n1, left, k);
  } else {
    sput(d.starts, d.s1, safe_seg, k);
  }
  sput(d.rl, n1, k, right2);
  return cnt;
}

// The split pre-pass (the device half of splitItem, Item.js:84-120).
__device__ __forceinline__ void split_prepass(const Doc& d, const int32_t* sp,
                                              int n) {
  for (int j = 0; j < n; ++j) {
    const int32_t orig = sp[2 * j], nw = sp[2 * j + 1];
    if (orig < 0) continue;
    const int so = gidx(orig, d.n1);
    const int32_t old_right = d.rl[so];
    const uint8_t old_del = d.dl[so];
    sput(d.rl, d.n1, nw, old_right);
    sput(d.rl, d.n1, orig, nw);
    sput(d.dl, d.n1, nw, old_del);
  }
}

__device__ __forceinline__ void delete_row(const Doc& d, int32_t r) {
  if (r >= 0 && r < d.n1) d.dl[r] = 1;
}

// XLA scatter's target: i wrapped once if negative, -1 if still out of
// range (the write is dropped).
__device__ __forceinline__ int32_t wrap(int32_t i, int n) {
  if (i < 0) i += n;
  return i >= 0 && i < n ? i : -1;
}

// The rows a K5 schedule entry e = (k, left0, right0, seg) reads and
// writes on K4's fast path, a function of the entry alone, so that the
// warp works them out off the chain: x the head it reads (starts, the
// gather's clamp), y left0's successor (rl), z the head write (rl[left0],
// or starts[seg] at a segment's head; -1: dropped), w k's link (-1:
// dropped).
__device__ __forceinline__ int4 entry_rows(int4 e, int n1, int s1) {
  const int32_t left0 = e.y;
  const int32_t safe_seg = e.w >= 0 ? e.w : s1 - 1;
  return make_int4(gidx(safe_seg, s1), gidx(left0 >= 0 ? left0 : n1 - 1, n1),
                   left0 != kNull ? wrap(left0, n1) : wrap(safe_seg, s1),
                   wrap(e.x, n1));
}

// K4 on a K5 entry e with its rows a (entry_rows): the fast path inline on
// the rows read ahead, every other item through integrate_item.
__device__ __forceinline__ int32_t step_item(const Doc& d, int32_t counter,
                                             int32_t roll, int4 e, int4 a) {
  const int32_t k = e.x, left0 = e.y, right0 = e.z;
  if (k < 0) return counter;
  if (counter <= roll) {
    const int32_t st = d.starts[a.x];
    const int32_t rl_l = d.rl[a.y];
    const bool skip =
        left0 == kNull ? (right0 != kNull && st == right0) : rl_l == right0;
    if (skip) {  // integrate_item's fast path
      if (a.z >= 0) (left0 != kNull ? d.rl : d.starts)[a.z] = k;
      if (a.w >= 0) d.rl[a.w] = left0 == kNull ? st : rl_l;
      return counter;
    }
  }
  return integrate_item(d, counter, roll, k, left0, right0, e.w);
}

// K5's blocks: one warp, one doc.  A staged doc's blocks an SM are set by
// its shared memory (16 to 32 where it stages), so the staged variants
// leave the compiler the registers that keep the chain's addresses in
// them, up to 128; the global one keeps a thread at 64 registers, so that
// 32 docs fit an SM.
constexpr int kStepThreads = 32;
template <int kVar>
constexpr int kStepBlocksPerSM = kVar == kGlobal ? 32 : 16;

template <int kVar>
__global__ void __launch_bounds__(kStepThreads, kStepBlocksPerSM<kVar>)
    batch_step_kernel(Statics s, int32_t* rl, uint8_t* dl, int32_t* starts,
                      int32_t* visit, const int32_t* __restrict__ splits,
                      const int32_t* __restrict__ sched,
                      const int32_t* __restrict__ dels, Layout lay, int n1,
                      int s1, int n_splits, int m, int n_del,
                      int32_t epoch_max) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  __shared__ int4 ring[2 * kStepThreads];  // entries and their rows
  const int64_t doc = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t roll = roll_bound(epoch_max, n1);
  const Doc g = doc_view(s, rl, dl, starts, visit, doc, doc, n1, s1);
  const Doc d = stage_in<kVar>(g, smem, lay, lane, kStepThreads);
  __syncwarp();
  if (lane == 0) split_prepass(d, splits + doc * n_splits * 2, n_splits);
  // the schedule [M, 4] of this doc, 32 entries a round, one a lane; the
  // next round's load is in flight while lane 0 integrates this one
  const int32_t* e = sched + doc * (int64_t)m * 4;
  auto entry = [e, m](int j) {
    return j < m ? make_int4(__ldg(e + 4 * j), __ldg(e + 4 * j + 1),
                             __ldg(e + 4 * j + 2), __ldg(e + 4 * j + 3))
                 : make_int4(kNull, kNull, kNull, kNull);
  };
  int4 next = entry(lane);
  int32_t counter = 0;  // lane 0's
  for (int j0 = 0; j0 < m; j0 += kStepThreads) {
    const int4 cur = next;
    next = entry(j0 + kStepThreads + lane);
    if (__ballot_sync(kFull, cur.x >= 0) == 0) continue;  // padding only
    ring[2 * lane] = cur;
    ring[2 * lane + 1] = entry_rows(cur, n1, s1);
    __syncwarp();
    if (lane == 0) {
      int4 x = ring[0], xa = ring[1];
      for (int t = 0; t < kStepThreads; ++t) {
        const int u = 2 * ((t + 1) % kStepThreads);  // one entry ahead
        const int4 y = ring[u], ya = ring[u + 1];
        counter = step_item(d, counter, roll, x, xa);
        x = y;
        xa = ya;
      }
    }
    __syncwarp();  // the ring is read before the next round writes it
  }
  __syncwarp();  // the split pre-pass's deleted bits before the deletes
  const int32_t* dr = dels + doc * n_del;
  for (int j = lane; j < n_del; j += kStepThreads) delete_row(d, dr[j]);
  __syncwarp();
  stage_out<kVar>(g, d, lane, kStepThreads);
}

// The most shards one K6 launch takes: 16 rows of 136 bytes keep the
// parameters under the classic 4 KB.
constexpr int kMaxShards = 16;
// Threads a level block, by instantiation, the fastest of 32, 64 and 128
// at the sizes that take it (PERF.md, section 6): K6 and K15 64 staged
// and 128 unstaged; K7b 64 staged whole and 32 otherwise (its docs read
// one plan, so more blocks an SM beat more threads a block).  And the
// blocks an SM must hold at once, which keeps a thread at 64 registers.
// A shard's pointers, picked by blockIdx.y, are loads from the parameter
// bank that the compiler keeps in registers.
template <bool kSharedIn, int kVar>
constexpr int kLevelThreads =
    kVar == kShared ? 64 : (kSharedIn ? 32 : (kVar == kRows ? 64 : 128));
template <bool kSharedIn, int kVar>
constexpr int kLevelBlocksPerSM = 1024 / kLevelThreads<kSharedIn, kVar>;

// One shard's tensors on the launch's device: its statics, tables, its
// rows of the device's visit and fast scratch (null where staged), its
// schedules, its progress counter (or null) and its doc count.
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
template <bool kSharedIn, int kVar>
__global__ void __launch_bounds__(kLevelThreads<kSharedIn, kVar>,
                                  kLevelBlocksPerSM<kSharedIn, kVar>)
    batch_step_levels_kernel(const __grid_constant__ LevelShards shards,
                             Layout lay, int n1, int s1, int n_splits,
                             int n_lv, int w, int n_del, int fast_w,
                             int32_t epoch_max) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const LevelShard& sh = shards.s[blockIdx.y];
  const int64_t doc = blockIdx.x;
  if (doc >= sh.b) return;  // the whole block: before any barrier
  const int64_t sdoc = kSharedIn ? 0 : doc;  // the shared inputs' doc index
  const int tid = threadIdx.x;
  constexpr int nt = kLevelThreads<kSharedIn, kVar>;
  const Doc g = doc_view(sh.s, sh.rl, sh.dl, sh.starts, sh.visit, doc, sdoc,
                         n1, s1);
  const Doc d = stage_in<kVar>(g, smem, lay, tid, nt);
  uint8_t* f = kVar == kGlobal ? sh.fast + doc * fast_w
                               : reinterpret_cast<uint8_t*>(smem + lay.fast);
  const int32_t* __restrict__ lv = sh.lv;
  const int32_t* __restrict__ dels = sh.dels;
  const int64_t base = sh.scratch_base[doc];
  const int32_t dummy = n1 - 1, s_dummy = s1 - 1;
  const int32_t roll = roll_bound(epoch_max, n1);
  __syncthreads();
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
      f[j] = fst ? kFast : (mask ? kDeferred : kMasked);
      pend |= mask && !fst;
      n_valid += mask;
    }
    pend = __syncthreads_or(pend);
    // (b) the 2W unique-index link writes and the head writes
    for (int j = tid; j < w; j += nt) {
      const int32_t* x = e + 8 * j;
      const int32_t k = x[0], l0 = x[1], r0 = x[2], succ = x[4], seg = x[5];
      const bool fst = f[j] == kFast;
      const int32_t succ_v = succ == kGatherSucc ? r0 : succ;
      const bool cond1 = fst && l0 >= 0;
      sput(d.rl, n1, cond1 ? (int64_t)l0 : base + j, cond1 ? k : kNull);
      sput(d.rl, n1, fst ? (int64_t)k : base + w + j, fst ? succ_v : kNull);
      if (fst && l0 == kNull) sput(d.starts, s1, seg, k);
    }
    __syncthreads();
    // (c) true conflicts, one at a time, in ascending lane order
    if (pend) {
      if (tid == 0) {
        for (int j = 0; j < w; ++j) {
          if (f[j] == kDeferred) {
            const int32_t* x = e + 8 * j;
            counter =
                integrate_item(d, counter, roll, x[0], x[6], x[7], x[5]);
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
  if constexpr (kVar != kGlobal) {
    __syncthreads();
    stage_out<kVar>(g, d, tid, nt);
  }
  if (!kSharedIn && sh.progress != nullptr) {  // uniform over the block
    __shared__ int32_t red[2];
    if (tid == 0) red[0] = red[1] = 0;
    __syncthreads();
    const int32_t wv = (int32_t)__reduce_add_sync(kFull, (unsigned)n_valid);
    const int32_t wd = (int32_t)__reduce_add_sync(kFull, (unsigned)n_dels);
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

// A level instantiation's threads a block.
int level_block(bool shared, int variant) {
  switch (variant) {
    case kShared: return shared ? kLevelThreads<true, kShared>
                                : kLevelThreads<false, kShared>;
    case kRows: return shared ? kLevelThreads<true, kRows>
                              : kLevelThreads<false, kRows>;
    default: return shared ? kLevelThreads<true, kGlobal>
                           : kLevelThreads<false, kGlobal>;
  }
}

// K5's instantiation for a variant; null for an unknown one.
const void* step_fn(int variant) {
  switch (variant) {
    case kShared: return (const void*)batch_step_kernel<kShared>;
    case kRows: return (const void*)batch_step_kernel<kRows>;
    case kGlobal: return (const void*)batch_step_kernel<kGlobal>;
    default: return nullptr;
  }
}

// K6's (shared: K7b's) instantiation for a variant; null for an unknown one.
const void* levels_fn(bool shared, int variant) {
  switch (variant) {
    case kShared:
      return shared ? (const void*)batch_step_levels_kernel<true, kShared>
                    : (const void*)batch_step_levels_kernel<false, kShared>;
    case kRows:
      return shared ? (const void*)batch_step_levels_kernel<true, kRows>
                    : (const void*)batch_step_levels_kernel<false, kRows>;
    case kGlobal:
      return shared ? (const void*)batch_step_levels_kernel<true, kGlobal>
                    : (const void*)batch_step_levels_kernel<false, kGlobal>;
    default: return nullptr;
  }
}

// Lets fn take smem dynamic bytes (past the default 48 KB) on the current
// device, and prefer shared memory to L1 when it stages.
cudaError_t prepare(const void* fn, int smem) {
  if (smem <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The most dynamic shared memory a block of the current device may opt
// into (cudaDevAttrMaxSharedMemoryPerBlockOptin), into *out.
extern "C" int ytpu_smem_optin(int* out, void* /*stream*/) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  }
  return (int)err;
}

// kind 0: K5, 1: K6 / K15, 2: K7b.  out[0]: threads a block, out[1]: the
// blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// with smem dynamic bytes, after the attributes a launch sets.
extern "C" int ytpu_yata_occupancy(int kind, int variant, int smem, int* out,
                                   void* /*stream*/) {
  const void* fn = kind == 0 ? step_fn(variant) : levels_fn(kind == 2, variant);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = kind == 0 ? kStepThreads : level_block(kind == 2, variant);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, fn, out[0],
                                                            smem);
}

// K5 over b docs; variant: where the rows lie (visit null for kShared);
// st_at, visit_at: the staged layout (Layout), smem its bytes.
extern "C" int ytpu_batch_step(const void* key, const void* oslot,
                               const void* oclock, const void* rslot,
                               const void* rclock, const void* orow, void* rl,
                               void* dl, void* starts, void* visit,
                               const void* splits, const void* sched,
                               const void* dels, int b, int n1, int s1,
                               int n_splits, int m, int n_del, int epoch_max,
                               int variant, int st_at, int visit_at, int smem,
                               void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  const void* fn = step_fn(variant);
  if (fn == nullptr || (variant != kShared && visit == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const Statics s = make_statics(key, oslot, oclock, rslot, rclock, orow);
  const Layout lay{st_at, visit_at, 0};
  auto* r = static_cast<int32_t*>(rl);
  auto* dd = static_cast<uint8_t*>(dl);
  auto* st = static_cast<int32_t*>(starts);
  auto* v = static_cast<int32_t*>(visit);
  auto* sp = static_cast<const int32_t*>(splits);
  auto* sc = static_cast<const int32_t*>(sched);
  auto* de = static_cast<const int32_t*>(dels);
  auto strm = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)b);
#define YTPU_STEP(V)                                                     \
  batch_step_kernel<V><<<grid, kStepThreads, smem, strm>>>(              \
      s, r, dd, st, v, sp, sc, de, lay, n1, s1, n_splits, m, n_del, epoch_max)
  if (variant == kShared) YTPU_STEP(kShared);
  else if (variant == kRows) YTPU_STEP(kRows);
  else YTPU_STEP(kGlobal);
#undef YTPU_STEP
  return (int)cudaGetLastError();
}

// desc: n_shards rows of kLevelRow int64: the data_ptr of the six static
// columns (key, oslot, oclock, rslot, rclock, orow), rl, dl, starts,
// visit, fast, splits, lv, dels, scratch_base and progress (0 for none),
// then the shard's doc count; every shard on the current device.  The
// dims are the same for every shard.  shared: K7b's instantiation (the
// statics, splits, lv and dels of one doc, read by all; no progress).
// variant: where the rows lie; visit is 0 for kShared, fast 0 unless
// kGlobal; st_at, visit_at, fast_at: the staged layout (Layout), smem
// its bytes.  One launch per kMaxShards shards with docs.
extern "C" int ytpu_batch_step_levels_sharded(
    const long long* desc, int n_shards, int shared, int n1, int s1,
    int n_splits, int n_lv, int w, int n_del, int fast_w, int variant,
    int st_at, int visit_at, int fast_at, int smem, int epoch_max,
    void* stream) {
  constexpr int kLevelRow = 17;
  const void* fn = levels_fn(shared != 0, variant);
  if (n_shards < 0 || fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const Layout lay{st_at, visit_at, fast_at};
  auto st = static_cast<cudaStream_t>(stream);
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
      if (k < n && ((variant != kShared && sh.visit == nullptr) ||
                    (variant == kGlobal && sh.fast == nullptr))) {
        return (int)cudaErrorInvalidValue;
      }
      if (sh.b > max_b) max_b = sh.b;
    }
    if (max_b <= 0) continue;
    const dim3 grid((unsigned)max_b, (unsigned)n);
#define YTPU_LEVELS(SH, V)                                                   \
  batch_step_levels_kernel<SH, V>                                            \
      <<<grid, kLevelThreads<SH, V>, smem, st>>>(                            \
          p, lay, n1, s1, n_splits, n_lv, w, n_del, fast_w, epoch_max)
    if (shared) {
      if (variant == kShared) YTPU_LEVELS(true, kShared);
      else if (variant == kRows) YTPU_LEVELS(true, kRows);
      else YTPU_LEVELS(true, kGlobal);
    } else {
      if (variant == kShared) YTPU_LEVELS(false, kShared);
      else if (variant == kRows) YTPU_LEVELS(false, kRows);
      else YTPU_LEVELS(false, kGlobal);
    }
#undef YTPU_LEVELS
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
