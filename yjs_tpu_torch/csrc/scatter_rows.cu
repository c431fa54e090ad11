// scatter_rows: whole-row replacement of docs idx in the three resident
// tables (compaction rebuilds, warm-tier hydration).
//
// Replaces the TPU kernel yjs_tpu/ops/kernels.py scatter_rows (:479), a
// jitted XLA scatter with the tables donated.
//
// Bound on the card: bytes.  Per replaced doc it reads one new row of each
// table (4 + 1 bytes per row slot, 4 per segment slot) and writes the same
// bytes into the tables, in place: 2 * k * (5 * (N+1) + 4 * (S+1)) bytes
// over 3.35 TB/s.
//
// Design: whole-row copies at 16 bytes a thread.  A block copies one
// replaced doc's three rows (right, deleted, starts), or a kBlockWords
// share of them where the rows are wider; the grid's y dimension walks
// the docs.  The engine's rows are not 16-byte aligned (N+1 is odd), and a
// new row and its doc's row usually differ in alignment mod 16, so each
// row is cut into the destination's 16-byte words:
// - a full word is one 16-byte store.  Where source and destination agree
//   mod 16 it is one 16-byte load as well.  Otherwise the source row's
//   16-byte words are first staged in shared memory by cp.async (16 bytes
//   a copy, a thread's whole share in flight at once), and each
//   destination word is assembled from two staged words at the row's
//   shift (funnel shifts of four 32-bit words);
// - the head and tail words, which the row only partly covers, take one
//   store an element.
// So `deleted` moves 16 flags a store, not one.  Index math within a row
// is 32-bit.  A doc index outside [0, B) after JAX's negative-index rule
// is dropped, as XLA's scatter drops it.  No allocation, no
// synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWordsPerThread = 8;
// destination words (16 bytes) a block copies at most: 16 KB
constexpr int kBlockWords = kThreads * kWordsPerThread;
constexpr int kMaxBlocksY = 65535;
constexpr int kTables = 3;

// The destination words a row of `nbytes` touches, at most: the slots it
// takes in a block's word range.
__host__ __device__ __forceinline__ int row_slots(int nbytes) {
  return (nbytes + 15) / 16 + 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// One row copy as 16-byte words of its destination.
struct Row {
  char* dst_a;        // the destination rounded down to 16 bytes
  const char* src_a;  // the source byte beside dst_a, rounded down to 16
  const char* src;
  int head;   // the row's first byte, from dst_a
  int end;    // one past its last byte, from dst_a
  int shift;  // the source byte beside dst_a, from src_a
  int words;  // destination words touched
  int elem;   // element bytes: 4 or 1
};

__device__ __forceinline__ Row make_row(void* dst, const void* src,
                                        int nbytes, int elem) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = d & ~uintptr_t(15);
  const uintptr_t x = a + (s - d);  // wraps like the addresses do
  Row r;
  r.dst_a = reinterpret_cast<char*>(a);
  r.src_a = reinterpret_cast<const char*>(x & ~uintptr_t(15));
  r.src = static_cast<const char*>(src);
  r.head = (int)(d - a);
  r.end = r.head + nbytes;
  r.shift = (int)(x & 15);
  r.words = nbytes > 0 ? (r.end + 15) >> 4 : 0;
  r.elem = elem;
  return r;
}

// Destination word w, with only part of it in the row: one element at a
// time, from the source row itself.
__device__ __forceinline__ void copy_partial(const Row& r, int w) {
  const int lo = max(16 * w, r.head), hi = min(16 * w + 16, r.end);
  for (int x = lo; x < hi; x += r.elem) {
    const char* from = r.src + (x - r.head);
    if (r.elem == 4) {
      *reinterpret_cast<int32_t*>(r.dst_a + x) =
          *reinterpret_cast<const int32_t*>(from);
    } else {
      r.dst_a[x] = *from;
    }
  }
}

__device__ __forceinline__ bool full_word(const Row& r, int w) {
  return 16 * w >= r.head && 16 * w + 16 <= r.end;
}

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ new_right,
                        const uint8_t* __restrict__ new_deleted,
                        const int32_t* __restrict__ new_starts,
                        int32_t* __restrict__ right,
                        uint8_t* __restrict__ deleted,
                        int32_t* __restrict__ starts, int k, int b, int n1,
                        int s1) {
  extern __shared__ uint4 staged[];
  const int slots[kTables] = {row_slots(4 * n1), row_slots(n1),
                              row_slots(4 * s1)};
  const int p0 = blockIdx.x * kBlockWords, p1 = p0 + kBlockWords;
  for (int j = blockIdx.y; j < k; j += gridDim.y) {
    int doc = idx[j];
    if (doc < 0) doc += b;
    if (doc < 0 || doc >= b) continue;  // the whole block: no barrier skipped
    const Row rows[kTables] = {
        make_row(right + (size_t)doc * n1, new_right + (size_t)j * n1,
                 4 * n1, 4),
        make_row(deleted + (size_t)doc * n1, new_deleted + (size_t)j * n1,
                 n1, 1),
        make_row(starts + (size_t)doc * s1, new_starts + (size_t)j * s1,
                 4 * s1, 4),
    };
    // this block's words of each row: [lo, hi), staged from stage_at
    int lo[kTables], hi[kTables], stage_at[kTables];
    int base = 0, at = 0;
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      lo[t] = max(0, p0 - base);
      hi[t] = min(rows[t].words, p1 - base);
      stage_at[t] = at;
      if (lo[t] < hi[t] && rows[t].shift != 0) at += hi[t] - lo[t] + 1;
      base += slots[t];
    }
    // 1. shifted rows: source words lo..hi that hold row bytes, staged
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      const Row& r = rows[t];
      if (lo[t] >= hi[t] || r.shift == 0) continue;
      const int first = r.head + r.shift, last = first + (r.end - r.head);
      for (int v = lo[t] + (int)threadIdx.x; v <= hi[t]; v += kThreads) {
        if (16 * v < last && 16 * v + 16 > first) {
          cp_async16(&staged[stage_at[t] + v - lo[t]], r.src_a + 16 * v);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // 2. rows that agree mod 16, while the copies fly
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      const Row& r = rows[t];
      if (lo[t] >= hi[t] || r.shift != 0) continue;
      for (int w = lo[t] + (int)threadIdx.x; w < hi[t]; w += kThreads) {
        if (full_word(r, w)) {
          *reinterpret_cast<uint4*>(r.dst_a + 16 * w) =
              *reinterpret_cast<const uint4*>(r.src_a + 16 * w);
        } else {
          copy_partial(r, w);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // 3. shifted rows: each full word from two staged words
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      const Row& r = rows[t];
      if (lo[t] >= hi[t] || r.shift == 0) continue;
      const int q = r.shift >> 2, bits = 8 * (r.shift & 3);
      for (int w = lo[t] + (int)threadIdx.x; w < hi[t]; w += kThreads) {
        if (!full_word(r, w)) {
          copy_partial(r, w);
          continue;
        }
        const uint32_t* win =
            reinterpret_cast<const uint32_t*>(&staged[stage_at[t] + w - lo[t]]) + q;
        uint4 out;
        out.x = __funnelshift_r(win[0], win[1], bits);
        out.y = __funnelshift_r(win[1], win[2], bits);
        out.z = __funnelshift_r(win[2], win[3], bits);
        out.w = __funnelshift_r(win[3], win[4], bits);
        *reinterpret_cast<uint4*>(r.dst_a + 16 * w) = out;
      }
    }
    __syncthreads();  // the staging is reused by the next doc
  }
}

}  // namespace

extern "C" int ytpu_scatter_rows(const void* idx, const void* new_right,
                                 const void* new_deleted,
                                 const void* new_starts, void* right,
                                 void* deleted, void* starts, int k, int b,
                                 int n1, int s1, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  if (n1 < 0 || s1 < 0 || n1 > (1 << 28) || s1 > (1 << 28)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slots =
      (long long)row_slots(4 * n1) + row_slots(n1) + row_slots(4 * s1);
  const int parts = (int)((slots + kBlockWords - 1) / kBlockWords);
  // staged words a block: its share of the slots plus one a row
  const long long words = (slots < kBlockWords ? slots : kBlockWords) + kTables;
  const dim3 grid(parts, k < kMaxBlocksY ? k : kMaxBlocksY);
  scatter_rows_kernel<<<grid, kThreads, (size_t)words * 16,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(new_right),
      static_cast<const uint8_t*>(new_deleted),
      static_cast<const int32_t*>(new_starts),
      static_cast<int32_t*>(right), static_cast<uint8_t*>(deleted),
      static_cast<int32_t*>(starts), k, b, n1, s1);
  return (int)cudaGetLastError();
}
