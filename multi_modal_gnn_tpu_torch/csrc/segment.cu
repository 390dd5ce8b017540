// Windowed segment sums for neighbor aggregation, hand-written for Hopper
// (sm_90a).  Built by ops/_build.py into a shared library with a plain C
// interface and called through ctypes from ops/segment_kernels.py.
//
// Replaces four Pallas TPU kernels of multi_modal_gnn_tpu/ops/pallas_segment.py:
//   K1  _windowed_segment_sum_fwd / _segment_kernel
//         -> mmgnn_segment_sum_windowed (gather_runs_kernel, gather_tile_kernel)
//   K2f _fused_table_segment_sum_fwd / _fused_table_kernel_take
//         -> mmgnn_fused_table_segment_sum (gather_runs_kernel)
//   K2b _fused_table_segment_sum_bwd / _fused_table_bwd_kernel_take
//         -> mmgnn_fused_table_segment_sum_bwd (incidence_kernel<false>)
//   K3  _span_dma_segment_sum_fwd / _span_dma_kernel
//         -> mmgnn_span_segment_sum (incidence_kernel<true>)
//
// K1 also serves as the backward of the span and paired tiers (the reverse
// relation's windowed sum of the scaled upstream gradient), and of a row
// gather with a GatherPlan (ops/segment.py).
//
// K1, K2f and K3 compute, for a windowed plan (graph/hetero.py),
//   out[tile_map[t] * 128 + local[e]] += row(e)       for every slot e of tile t
// with f32 accumulation; slots with local == 128 are padding and add nothing.
// row(e) is a pre-gathered row G[e] (K1 without idx), a table row x[src[e]]
// (K1 with idx, K2f), or a row of the tile's span block (K3).  K2b is K2f's
// transpose: dT[src[e]] += g[tile_map[t] * 128 + local[e]].
//
// K1 and K2f (gathers).  What bounds them on the H100: bytes.  There is one
// add per gathered element, so the work is reading about E * D * 4 bytes of
// gathered rows against writing num_dst * D * 4 bytes of output.
// K2f (redesigned for Hopper).  Its first version was K1's kernel reading
// the small table (at most 2048 rows) through L1 / L2: 5M slots x 512 B on
// lab -> patient, 2.56 GB through the cache hierarchy, ~90x the bytes of
// its bound, as torch.sparse.mm reads them, and no faster than that call.
// Now the table stays in shared memory and the gathers read it there:
//   * A block keeps a column slice of every table row resident (the widest
//     of 128, 64, 32, ... columns that fits a block's 227 KB: 64 columns of
//     a 500-row table, 128 KB; 16 columns of 2048 rows); column slices are
//     the grid's second dimension.  One block of 16 warps an SM.
//   * Each warp takes units of 64 slots, a few at a time: its first grab
//     by its index, the rest from the slice's counter (the counter's atomics
//     are serial at its L2 slice: a grab a unit held the first version at
//     that slice's pace, so a warp grabs about four times).  A unit of
//     padding only costs its index read.
//   * A warp's lanes split into row groups of slice / 4 lanes, one float4 of
//     the row each; each group walks its own run of consecutive slots (its
//     indices from the warp's staged copy, fetched from device memory under
//     the previous unit's work), eight rows loaded before they are summed,
//     sums runs of equal `local` in registers and adds each run to its
//     output row with global float4 atomics (sm_90): no window partial in
//     shared memory, no shared atomics.  The summation order changes from
//     run to run.
//   * A slot reads its row from shared memory only: about E * D * 4 bytes of
//     shared-memory traffic (~0.09 ms of the SMs' bandwidth on lab ->
//     patient) against the indices' E * 8 bytes from device memory, read
//     once per column slice.
// K1 (redesigned for Hopper).  Its first version kept a [128, D] window
// partial in shared memory per block of a few tiles: each block zeroed 64
// KB, merged runs into it with shared f32 atomics (compare-and-swap loops in
// SASS) and flushed all 16,384 entries with scalar global atomics, for as
// little as one tile's 1,024 slots.  Now no window partial exists: runs
// merge in registers and go out with float4 global atomics.  The wrapper
// picks the route from the shapes (windowed_route):
//   * a table of at most 2048 rows and 4 MB (the span and paired tiers'
//     backward, which gathers the gradient of labs, diagnoses or
//     medications into patient windows) runs K2f's kernel, the table's
//     column slice staged in shared memory;
//   * a larger table (the paired tier's forward from the 100,000-row patient
//     table) or pre-gathered rows run gather_tile_kernel: a block a tile,
//     three 16-warp blocks an SM (40 registers a thread), four rows in
//     flight a row group; a run cut at a chunk boundary is merged through
//     shared memory (no float atomics there) and added once a tile, since
//     on a relation into few rows (diagnoses, medications) every chunk of a
//     tile adds to the same row.  A persistent grid with a unit counter (as
//     K2f's) and eight or sixteen rows in flight, and one warp a unit with
//     an atomic a unit, were no faster (PERF.md).
//   * A slot whose source lies past the table adds nothing, so no row past a
//     table is read.

// K2b and K3 (incidence products).  Both sum a contiguous block of rows
// through a sparse patient x lab incidence: K3's tile reads its sources from
// table[span_base[t] : + span_rows], K2b's window reads g[w * 128 : + 128].
// The function is bound by bytes (E * 8 bytes of indices and each row block
// once: ~0.03 ms at scale_100k), but a gather-and-scatter design stays far
// from that on this card: K2b's slots are dst-sorted, so consecutive slots
// hit different sources and nothing merges in registers (D shared-memory
// float atomics a slot, each a compare-and-swap loop in SASS), and K3's
// source-sorted tiles need a sort by row before their runs merge.  The
// design makes the scatter a dense product on the tensor cores,
// acc[128, N] += C[128, K] * B[K, N], which does ~40x (lab <-> patient) to
// ~500x (diagnosis -> patient) the function's adds, so what bounds it is the
// mma.sync work (26 GFLOP for a 128-column relation of 500 sources into
// 100k patients: 0.05 ms at the H100's 495 TFLOP/s TF32 peak, which
// mma.sync does not reach) and the latency of each unit's chain of loads,
// atomics and barriers (PERF.md has the times):
//   * C holds the unit's edge counts (a unit is one K3 tile, or a run of up
//     to 63 tiles of one K2b window), built in shared memory with 16-bit
//     integer shared atomics (two counts per word; a K3 tile adds at most
//     1024, a K2b unit at most 64512, so no count carries).  K3: C[local,
//     src - span_base]; K2b: C[src - chunk_base, local] for the block's
//     128-source chunk (blockIdx.y).  Duplicate edges add to their count.
//   * B, the unit's row block, is staged in 32-row slices with 16-byte
//     cp.async, double-buffered so the next slice's copy runs under the
//     current slice's products.  Only slices that hold a slot are copied,
//     only rows below the unit's largest used row, and never rows past the
//     table's end; the rest of a slice is zero-filled.
//   * mma.sync m16n8k8 in TF32 with f32 accumulation.  Counts up to 2048 are
//     exact in TF32; B is split into hi (its top 11 significand bits) and
//     lo = b - hi rounded to TF32, two products whose sum is within 2^-21
//     of b (f32 rounds to 2^-24; one TF32 product would keep 2^-11).  A unit
//     with a count above 2048 (a K2b window with that many copies of one
//     edge) also splits C into its high bits and its low five bits.
//   * k8 steps and slices without a slot are skipped (a 64-bit mask of the
//     unit's k8 steps), and a unit without a slot costs its index reads only.
//   * The accumulator stays in registers (8 warps: 4 over rows x 2 over
//     columns, 64 floats a thread) across a block's units and goes out with
//     global f32 atomics once per block (K2b) or per window change (K3); the
//     summation order changes from run to run.
//   * 256 threads and about 109 KB (K3, span 256) or 68 KB (K2b) of shared
//     memory a block, so two blocks share an SM and hide each other's
//     latencies; K3's 8 KB more hold the next tile's slots, copied in under
//     the current tile's products.  One wave of persistent blocks takes
//     tiles from a counter, a few at a time: K3's tiles differ in the rows
//     of their span they use and K2b's tile ranges in the windows they hold,
//     so static ranges leave some blocks far behind the rest.  The blocks of
//     all chunks (K2b) advance together and read the same row blocks from
//     L2.  Columns past 128 take another block (blockIdx.z); a column tail
//     that is not a multiple of 8 is zero in shared memory.
//   * Rows of a staged block that no slot reads take part in the product with
//     a count of 0: a non-finite value there would poison the sum, where a
//     gather would skip it.  Rows past the table are never read.
//   * A real K3 slot whose source falls outside its tile's span (never, for a
//     plan from build_src_span_plan) adds its row with global atomics.

#include <cuda_runtime.h>

// Gives the blocks of `threads` threads and `smem` bytes of dynamic shared
// memory that the current device holds resident at once (the occupancy
// times the SMs), with `fn`'s dynamic shared-memory limit raised to the
// device's.  The runtime is asked once for each (device, kernel, threads,
// size) and the answer cached: a launch of these kernels takes ~0.1 ms and
// the host's time before it counts.
cudaError_t mmgnn_one_wave(const void* fn, int threads, size_t smem, int* wave) {
  struct Entry {
    int device;
    const void* fn;
    int threads;
    size_t smem;
    int wave;
  };
  static Entry cache[64];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  bool raised = false;  // fn's limit is the device's already
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.device != device || e.fn != fn) continue;
    if (e.threads == threads && e.smem == smem) {
      *wave = e.wave;
      return cudaSuccess;
    }
    raised = true;
  }
  int sms = 0, optin = 0, resident = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if (!raised) {  // the device's limit less the kernel's static shared memory
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * resident;
  if (used < 64) cache[used++] = Entry{device, fn, threads, smem, *wave};
  return cudaSuccess;
}

namespace {

constexpr int WINDOW = 128;
constexpr int TILE_E = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void add_into(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// 16- and 4-byte asynchronous copies global -> shared (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// ---------------------------------------------------------------------------
// K2b and K3: incidence products on the tensor cores (notes in the header)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;
constexpr int MMA_ROWS = 128;       // accumulator rows: a window (K3), a source chunk (K2b)
constexpr int MMA_COLS = 128;       // columns of one column block (blockIdx.z)
constexpr int SLICE = 32;           // rows of B staged at a time
constexpr int MAX_K = 512;          // rows of B a unit may use: 64 k8 steps in a mask
constexpr int ROUND_TILES = 63;     // K2b tiles per count matrix: counts stay below 2^16
constexpr unsigned TF32_EXACT = 2048;  // integers up to 2^11 are exact in TF32

struct Incidence {
  const float* __restrict__ rows;  // B's source rows: the table (K3) or g (K2b)
  int num_rows;                    // rows of `rows`; no row past them is read
  const int* __restrict__ src;
  const int* __restrict__ local;
  const int* __restrict__ tile_map;
  const int* __restrict__ span_base;  // K3 only
  int num_tiles;
  int* work;  // a tile counter per (chunk, column block), zeroed by the caller
  int grab;   // tiles a block takes at a time
  int k_rows;       // K3: span_rows; K2b: WINDOW
  int num_src;      // K2b: rows of dT
  int d;
  int count_words;  // 32-bit words per row of C (two 16-bit counts each)
  int b_stride;     // floats per row of a staged slice of B
  float* __restrict__ out;
};

// What the block's threads found while building one unit's C.
struct UnitState {
  unsigned kmask[2];  // k8 steps that hold a slot (two halves: 32-bit atomics are native)
  int need;           // 1 + the largest row of B a slot uses; 0 = no slot
  int big;            // a count exceeds TF32_EXACT
};

// b = hi + lo in TF32: hi keeps b's top 11 significand bits (truncated, so a
// non-finite b gives a non-finite hi), lo = b - hi (exact) rounded to nearest
// on its 11th bit; |b - hi - lo| <= 2^-21 |b|.  The integer rounding needs no
// test for non-finite values: lo is finite whenever b is, and hi alone
// carries a non-finite b into the product.
__device__ __forceinline__ void split_tf32(float b, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(b) & 0xffffe000u;
  lo = (__float_as_uint(b - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a * b for one 16x8x8 TF32 tile (fragments as in the PTX ISA's
// "mma.m16n8k8" .tf32 layout: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1];
// g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread's four consecutive slots of tile `tile` (16-byte loads of
// their local rows and sources).
__device__ __forceinline__ void load_slots(const Incidence& p, long long tile, int* ls, int* ss) {
  static_assert(TILE_E == 4 * MMA_THREADS, "a thread owns four slots of a tile");
  const long long e = tile * TILE_E + 4 * threadIdx.x;
  const int4 l = __ldg(reinterpret_cast<const int4*>(p.local + e));
  const int4 s = __ldg(reinterpret_cast<const int4*>(p.src + e));
  ls[0] = l.x, ls[1] = l.y, ls[2] = l.z, ls[3] = l.w;
  ss[0] = s.x, ss[1] = s.y, ss[2] = s.z, ss[3] = s.w;
}

// C[m][k] += 1 (16-bit counts, two to a word), and what the unit needs.
__device__ __forceinline__ void add_count(unsigned* counts, int cw, int m, int k, int& need,
                                          unsigned long long& kbits, bool& big) {
  const unsigned shift = (k & 1) * 16;
  const unsigned old = atomicAdd(counts + m * cw + (k >> 1), 1u << shift);
  big |= ((old >> shift) & 0xffffu) >= TF32_EXACT;
  need = max(need, k + 1);
  kbits |= 1ull << (k >> 3);
}

// Merge every thread's findings into `st` (all threads call it).
__device__ __forceinline__ void publish(int need, unsigned long long kbits, bool big,
                                        UnitState& st) {
  need = __reduce_max_sync(FULL, need);
  const unsigned lo = __reduce_or_sync(FULL, static_cast<unsigned>(kbits));
  const unsigned hi = __reduce_or_sync(FULL, static_cast<unsigned>(kbits >> 32));
  const bool any_big = __any_sync(FULL, big);
  if (threadIdx.x % 32 == 0) {
    if (need > 0) atomicMax(&st.need, need);
    if (lo) atomicOr(&st.kmask[0], lo);
    if (hi) atomicOr(&st.kmask[1], hi);
    if (any_big) st.big = 1;
  }
}

// Slice `s` of the unit's B (rows row0 + 32 s ...) into `buf`: rows below
// `limit` by cp.async, the others zero.  Columns past ncols stay zero.
__device__ __forceinline__ void stage_slice(const Incidence& p, float* buf, long long row0,
                                            int s, int limit, int c0, int ncols) {
  const int valid = min(max(limit - s * SLICE, 0), SLICE);
  const int cpr = ncols / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < SLICE * cpr; i += MMA_THREADS) {
    const int r = i / cpr;
    const int q = (i - r * cpr) * 4;
    float* dst = buf + r * p.b_stride + q;
    if (r < valid) {
      cp_async16(dst, p.rows + (row0 + s * SLICE + r) * p.d + c0 + q);
    } else {
      *reinterpret_cast<float4*>(dst) = zero4();
    }
  }
  cp_async_commit();
}

// acc += C[:, 32 s : 32 s + 32] * buf over the k8 steps in kmask.  Warp
// (wm, wn) owns rows 32 wm .. + 32 (two m16 tiles) and the n8 tiles wn,
// wn + 2, ... below nt.  kBig: C is split into its 11 high and 5 low bits.
// kFull: all 16 n8 tiles (128 columns), so no test cuts the unrolled loop
// into blocks and the compiler interleaves the tiles' loads and products.
template <bool kBig, bool kFull>
__device__ __forceinline__ void mma_slice(const unsigned* counts, int cw, const float* buf, int sb,
                                          int s, unsigned long long kmask, int nt,
                                          float (&acc)[2][8][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const unsigned shift = (t & 1) * 16;
#pragma unroll 1
  for (int kk = 0; kk < SLICE / 8; ++kk) {
    const int step = s * (SLICE / 8) + kk;
    if (!((kmask >> step) & 1ull)) continue;
    const int word = (step * 8 + t) >> 1;  // column k0 + t; k0 + t + 4 is word + 2
    unsigned a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const unsigned* row = counts + (wm * 32 + mi * 16 + g) * cw + word;
      const unsigned c[4] = {row[0], row[8 * cw], row[2], row[8 * cw + 2]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned n = (c[e] >> shift) & 0xffffu;
        a_hi[mi][e] = __float_as_uint(__uint2float_rn(kBig ? n & 0xffe0u : n));
        if (kBig) a_lo[mi][e] = __float_as_uint(__uint2float_rn(n & 0x1fu));
      }
    }
    const float* b0 = buf + (kk * 8 + t) * sb + g;
    const float* b1 = b0 + 4 * sb;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = wn + 2 * i;
      if (kFull || j < nt) {
        unsigned h0, l0, h1, l1;
        split_tf32(b0[j * 8], h0, l0);
        split_tf32(b1[j * 8], h1, l1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(acc[mi][i], a_hi[mi], l0, l1);
          mma_tf32(acc[mi][i], a_hi[mi], h0, h1);
          if (kBig) {
            mma_tf32(acc[mi][i], a_lo[mi], l0, l1);
            mma_tf32(acc[mi][i], a_lo[mi], h0, h1);
          }
        }
      }
    }
  }
}

// out[row0 + m, c0 + n] += acc (m < row_limit, n < ncols), and zero acc.
__device__ __forceinline__ void flush_acc(float (&acc)[2][8][4], float* __restrict__ out,
                                          long long row0, int row_limit, int d, int c0,
                                          int ncols) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * 32 + mi * 16 + g + (e / 2) * 8;
        const int n = (wn + 2 * i) * 8 + 2 * t + (e % 2);
        const float v = acc[mi][i][e];
        if (v != 0.f && m < row_limit && n < ncols) atomicAdd(out + (row0 + m) * d + c0 + n, v);
        acc[mi][i][e] = 0.f;
      }
    }
  }
}

// K3: the tile a block takes next, its window and span base (copied in
// while the current tile's products run).
struct NextTile {
  int tile, window, base;
};

// Shared memory of one block: C, two slices of B, what the unit found, and
// (K3) the next tile's slots and place.
struct Staging {
  unsigned* counts;  // [MMA_ROWS, cw]
  float* bufs;       // 2 x [SLICE, sb]
  int* slots;        // K3: [2, TILE_E], the next tile's local rows, then sources
  UnitState* st;
  NextTile* next;
  int c0, ncols, nt;
};

// K3: copy tile t's slots and place into shared memory (one commit group).
__device__ __forceinline__ void prefetch_tile(const Incidence& p, const Staging& sm, int t) {
  const long long e = (long long)t * TILE_E + 4 * threadIdx.x;
  cp_async16(sm.slots + 4 * threadIdx.x, p.local + e);
  cp_async16(sm.slots + TILE_E + 4 * threadIdx.x, p.src + e);
  if (threadIdx.x == 0) {
    cp_async4(&sm.next->window, p.tile_map + t);
    cp_async4(&sm.next->base, p.span_base + t);
  }
  cp_async_commit();
}

// One unit: count tiles [t, te) into C, then acc += C * B over the slices of
// B (rows row0 ...) that hold a slot.  K3: C[local, src - row0] from the
// tile's staged slots (window w), and once they are counted the slots and
// place of sm.next->tile, which thread 0 set, are copied in under the
// products; returns that tile.  K2b: C[src - chunk0, local].  All threads
// call it; it ends with C clear and the copies landed.
template <bool kSpan>
__device__ int incidence_unit(const Incidence& p, const Staging& sm, int t, int te, int w,
                              long long row0, int chunk0, float (&acc)[2][8][4]) {
  const int cw = p.count_words, sb = p.b_stride;
  int need = 0;
  unsigned long long kbits = 0ull;
  bool big = false;
  if (kSpan) {
    const int4 l4 = reinterpret_cast<const int4*>(sm.slots)[threadIdx.x];
    const int4 s4 = reinterpret_cast<const int4*>(sm.slots + TILE_E)[threadIdx.x];
    const int ls[4] = {l4.x, l4.y, l4.z, l4.w}, ss[4] = {s4.x, s4.y, s4.z, s4.w};
    const long long out_row = (long long)w * WINDOW;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (ls[u] >= WINDOW) continue;  // padding: its index is never used
      const int rel = ss[u] - static_cast<int>(row0);
      if (static_cast<unsigned>(rel) < static_cast<unsigned>(p.k_rows)) {
        add_count(sm.counts, cw, ls[u], rel, need, kbits, big);
      } else if (static_cast<unsigned>(ss[u]) < static_cast<unsigned>(p.num_rows)) {
        const float* from = p.rows + (long long)ss[u] * p.d + sm.c0;
        float* to = p.out + (out_row + ls[u]) * p.d + sm.c0;
        for (int c = 0; c < sm.ncols; ++c) atomicAdd(to + c, __ldg(from + c));
      }
    }
  } else {
    for (int tt = t; tt < te; tt += 2) {  // two tiles' loads in flight
      int ls[8], ss[8];
      const bool two = tt + 1 < te;
      load_slots(p, tt, ls, ss);
      if (two) load_slots(p, tt + 1, ls + 4, ss + 4);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if ((u >= 4 && !two) || ls[u] >= WINDOW) continue;
        const int m = ss[u] - chunk0;
        if (static_cast<unsigned>(m) < static_cast<unsigned>(MMA_ROWS)) {
          add_count(sm.counts, cw, m, ls[u], need, kbits, big);
        }
      }
    }
  }
  publish(need, kbits, big, *sm.st);
  __syncthreads();
  need = sm.st->need;
  kbits = (static_cast<unsigned long long>(sm.st->kmask[1]) << 32) | sm.st->kmask[0];
  big = sm.st->big != 0;
  const int next = kSpan ? sm.next->tile : 0;
  if (kSpan && next < p.num_tiles) prefetch_tile(p, sm, next);
  if (need > 0) {
    const int limit = static_cast<int>(min((long long)need, p.num_rows - row0));
    unsigned slices = 0;  // slices of 4 k8 steps that hold a slot
    for (int s = 0; s < MAX_K / SLICE; ++s) {
      if ((kbits >> (4 * s)) & 0xfull) slices |= 1u << s;
    }
    int s = __ffs(slices) - 1;
    slices &= slices - 1;
    int b = 0;
    stage_slice(p, sm.bufs, row0, s, limit, sm.c0, sm.ncols);
    while (true) {
      const int next = slices ? __ffs(slices) - 1 : -1;
      if (next >= 0) {
        slices &= slices - 1;
        stage_slice(p, sm.bufs + (b ^ 1) * SLICE * sb, row0, next, limit, sm.c0, sm.ncols);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* buf = sm.bufs + b * SLICE * sb;
      if (big) {
        mma_slice<true, false>(sm.counts, cw, buf, sb, s, kbits, sm.nt, acc);
      } else if (sm.nt == MMA_COLS / 8) {
        mma_slice<false, true>(sm.counts, cw, buf, sb, s, kbits, sm.nt, acc);
      } else {
        mma_slice<false, false>(sm.counts, cw, buf, sb, s, kbits, sm.nt, acc);
      }
      if (next < 0) break;
      __syncthreads();  // the next stage overwrites this buffer
      s = next;
      b ^= 1;
    }
  }
  cp_async_wait<0>();  // the next tile's slots (K3) have landed
  __syncthreads();     // every thread has read st, C and B
  if (need > 0) {  // clear the words the unit used, two at a time
    const int pairs = (need + 3) / 4;
    for (int r = threadIdx.x / 32; r < MMA_ROWS; r += MMA_THREADS / 32) {
      uint2* row = reinterpret_cast<uint2*>(sm.counts + r * cw);
      for (int i = threadIdx.x % 32; i < pairs; i += 32) row[i] = make_uint2(0u, 0u);
    }
  }
  if (threadIdx.x == 0) *sm.st = UnitState{{0u, 0u}, 0, 0};
  __syncthreads();
  return next;
}

// Persistent blocks, grid (blocks, K2b source chunks, column blocks), take
// `grab` tiles at a time from their (chunk, column block)'s counter in
// `work`, so blocks whose tiles hold more rows or more windows do not hold up
// the rest.  K3 (kSpan): each tile is a unit; thread 0 keeps the next grab
// taken ahead, and each tile's slots and place are copied in under the
// previous tile's products; acc goes out when the window changes (a block's
// tiles only increase).  K2b: a unit is a run of up to ROUND_TILES tiles of
// one window; the block that takes a window's first tile takes all of it,
// and acc (one source chunk) goes out at the end.
template <bool kSpan>
__global__ void __launch_bounds__(MMA_THREADS, 2) incidence_kernel(Incidence p) {
  extern __shared__ float4 smem4[];
  __shared__ UnitState st;
  __shared__ NextTile next;
  const int cw = p.count_words, sb = p.b_stride;
  Staging sm;
  sm.counts = reinterpret_cast<unsigned*>(smem4);
  sm.bufs = reinterpret_cast<float*>(sm.counts + MMA_ROWS * cw);
  sm.slots = reinterpret_cast<int*>(sm.bufs + 2 * SLICE * sb);
  sm.st = &st;
  sm.next = &next;
  sm.c0 = blockIdx.z * MMA_COLS;
  sm.ncols = min(MMA_COLS, p.d - sm.c0);
  sm.nt = (sm.ncols + 7) / 8;
  const int chunk0 = blockIdx.y * MMA_ROWS;  // K2b: the chunk's first source row
  int* work = p.work + blockIdx.y + gridDim.y * blockIdx.z;
  for (int i = threadIdx.x; i < MMA_ROWS * cw; i += MMA_THREADS) sm.counts[i] = 0u;
  for (int i = threadIdx.x; i < 2 * SLICE * sb; i += MMA_THREADS) sm.bufs[i] = 0.f;
  float acc[2][8][4] = {};
  int pending = 0;  // thread 0: the grab taken ahead
  if (threadIdx.x == 0) {
    st = UnitState{{0u, 0u}, 0, 0};
    next.tile = atomicAdd(work, p.grab);
    pending = atomicAdd(work, p.grab);
  }
  __syncthreads();
  int t = next.tile;
  int g1 = min(t + p.grab, p.num_tiles);  // the end of the current grab
  if constexpr (kSpan) {
    if (t < p.num_tiles) prefetch_tile(p, sm, t);
    cp_async_wait<0>();
    __syncthreads();
    int window = -1;  // the window acc holds
    while (t < p.num_tiles) {
      const int w = next.window;
      const long long base = next.base;
      if (w != window) {
        if (window >= 0) flush_acc(acc, p.out, (long long)window * WINDOW, WINDOW, p.d, sm.c0, sm.ncols);
        window = w;
      }
      if (threadIdx.x == 0) {  // the tile after t, read by all once its slots are counted
        int n = t + 1;
        if (n >= g1) {
          n = pending;
          g1 = min(n + p.grab, p.num_tiles);
          if (n < p.num_tiles) pending = atomicAdd(work, p.grab);
        }
        next.tile = n;
      }
      t = incidence_unit<true>(p, sm, t, t + 1, w, base, 0, acc);
    }
    if (window >= 0) flush_acc(acc, p.out, (long long)window * WINDOW, WINDOW, p.d, sm.c0, sm.ncols);
  } else {
    __shared__ int grabbed;
    for (int g0 = t;;) {
      for (int tt = g0; tt < g1; ++tt) {
        const int w = p.tile_map[tt];
        if (tt > 0 && p.tile_map[tt - 1] == w) continue;  // its run's first tile's block takes it
        for (int ts = tt; ts < p.num_tiles && p.tile_map[ts] == w;) {
          int te = ts + 1;
          while (te < p.num_tiles && te - ts < ROUND_TILES && p.tile_map[te] == w) ++te;
          incidence_unit<false>(p, sm, ts, te, w, (long long)w * WINDOW, chunk0, acc);
          ts = te;
        }
      }
      if (threadIdx.x == 0) {
        grabbed = pending;
        if (pending < p.num_tiles) pending = atomicAdd(work, p.grab);
      }
      __syncthreads();
      g0 = grabbed;
      __syncthreads();  // read before thread 0 publishes the next grab
      if (g0 >= p.num_tiles) break;
      g1 = min(g0 + p.grab, p.num_tiles);
    }
    flush_acc(acc, p.out, chunk0, p.num_src - chunk0, p.d, sm.c0, sm.ncols);
  }
}

template <bool kSpan>
int launch_incidence(const Incidence& p, int blocks, int chunks, int col_blocks, void* stream) {
  const size_t smem = sizeof(unsigned) * MMA_ROWS * p.count_words +
                      sizeof(float) * 2 * SLICE * p.b_stride + (kSpan ? sizeof(int) * 2 * TILE_E : 0);
  cudaError_t err = cudaFuncSetAttribute(incidence_kernel<kSpan>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  incidence_kernel<kSpan><<<dim3(blocks, chunks, col_blocks), MMA_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1 and K2f: runs of equal `local` merged in registers (notes in the header)
// ---------------------------------------------------------------------------

constexpr int FT_THREADS = 512;
constexpr int FT_WARPS = FT_THREADS / 32;
constexpr int FT_UNIT = 64;  // slots a warp takes at a time (a sixteenth of a tile)
constexpr int FT_COUNTER_STRIDE = 32;  // a slice's counter on its own 128-byte line
constexpr int FT_BATCH = 8;  // rows a row group loads before it sums them

struct FusedTable {
  const float* __restrict__ table;  // [num_src, d]; pre-gathered rows (K1, src null): [units * 64, d]
  int num_src, d;
  const int* __restrict__ src;
  const int* __restrict__ local;
  const int* __restrict__ tile_map;
  int num_units;
  int* work;    // a unit counter per column slice (every 32nd int), zeroed by the caller
  int grab;     // units a warp takes at a time
  int slice;    // columns of a slice (a multiple of 4)
  int stride;   // floats per staged row
  float* __restrict__ out;
};

// Grid (blocks, column slices).  A block first copies columns [c0, c0 +
// slice) of every table row into shared memory.  Then each warp takes
// `grab` units of 64 slots at a time (notes in the header).  The warp's
// lanes split into `groups` row groups of q = slice / 4 lanes (one float4
// of the row each); group i walks the i-th run of consecutive slots of the
// unit, loads FT_BATCH rows before it sums them, sums runs of equal `local`
// (slots are dst-sorted within a tile) in registers and adds each run to
// its output row with float4 global atomics.  A slot whose source lies past
// the table adds nothing.
__global__ void __launch_bounds__(FT_THREADS, 1) gather_runs_kernel(FusedTable p) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  int* idx = reinterpret_cast<int*>(tab + (size_t)p.num_src * p.stride);  // per warp: locals, sources
  const int c0 = blockIdx.y * p.slice;
  const int ncols = min(p.slice, p.d - c0);
  const int q = ncols / 4;
  for (int i = threadIdx.x; i < p.num_src * q; i += FT_THREADS) {
    const int r = i / q, c = (i - r * q) * 4;
    cp_async16(tab + (size_t)r * p.stride + c, p.table + (long long)r * p.d + c0 + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = 32 / q;
  const int gi = lane / q, ci = lane - gi * q;
  const bool active = gi < groups;
  const int seg = (FT_UNIT + FT_BATCH * groups - 1) / (FT_BATCH * groups) * FT_BATCH;  // whole batches
  const int s0 = min(gi * seg, FT_UNIT), s1 = min(s0 + seg, FT_UNIT);
  int* my_idx = idx + warp * 2 * FT_UNIT;
  int* work = p.work + blockIdx.y * FT_COUNTER_STRIDE;
  float* out = p.out + c0 + 4 * ci;
  // The first grab is the warp's own, the counter hands out the rest; the
  // next grab and the next unit's indices are fetched under this unit's work.
  const int dealt = gridDim.x * FT_WARPS * p.grab;
  int u = (blockIdx.x * FT_WARPS + warp) * p.grab;
  int u_end = min(u + p.grab, p.num_units);
  int next_grab = 0;  // lane 0
  if (lane == 0) next_grab = dealt + atomicAdd(work, p.grab);
  int l0 = WINDOW, l1 = WINDOW, r0 = 0, r1 = 0, w = 0;  // the unit's slots (lane, lane + 32)
  auto fetch = [&](int uu) {
    const long long e0 = (long long)uu * FT_UNIT;
    l0 = p.local[e0 + lane];
    l1 = p.local[e0 + lane + 32];
    r0 = p.src[e0 + lane];
    r1 = p.src[e0 + lane + 32];
    w = p.tile_map[uu / (TILE_E / FT_UNIT)];
  };
  if (u < p.num_units) fetch(u);
  while (u < p.num_units) {
    int un = u + 1;
    if (un >= u_end) {  // warp-uniform
      un = __shfl_sync(FULL, next_grab, 0);
      u_end = min(un + p.grab, p.num_units);
      if (lane == 0 && un < p.num_units) next_grab = dealt + atomicAdd(work, p.grab);
    }
    const int cl0 = l0, cl1 = l1, cr0 = r0, cr1 = r1;
    const long long row0 = (long long)w * WINDOW;
    if (un < p.num_units) fetch(un);
    u = un;
    if (!__any_sync(FULL, cl0 < WINDOW || cl1 < WINDOW)) continue;  // padding only
    __syncwarp();  // the last unit's indices are read
    my_idx[lane] = cl0;
    my_idx[lane + 32] = cl1;
    my_idx[FT_UNIT + lane] = cr0;
    my_idx[FT_UNIT + lane + 32] = cr1;
    __syncwarp();
    float4 run = zero4();
    int cur = WINDOW;  // local row of the open run; WINDOW = none
    for (int s = s0; active && s < s1; s += FT_BATCH) {
      int ls[FT_BATCH], ss[FT_BATCH];
#pragma unroll
      for (int k = 0; k < FT_BATCH; k += 4) {  // s and s1 are multiples of FT_BATCH
        const int4 l4 = *reinterpret_cast<const int4*>(my_idx + s + k);
        const int4 s4 = *reinterpret_cast<const int4*>(my_idx + FT_UNIT + s + k);
        ls[k] = l4.x, ls[k + 1] = l4.y, ls[k + 2] = l4.z, ls[k + 3] = l4.w;
        ss[k] = s4.x, ss[k + 1] = s4.y, ss[k + 2] = s4.z, ss[k + 3] = s4.w;
      }
      float4 v[FT_BATCH];
#pragma unroll
      for (int k = 0; k < FT_BATCH; ++k) {
        const bool ok = ls[k] < WINDOW && static_cast<unsigned>(ss[k]) < static_cast<unsigned>(p.num_src);
        v[k] = ok ? *reinterpret_cast<const float4*>(tab + (size_t)ss[k] * p.stride + 4 * ci) : zero4();
      }
#pragma unroll
      for (int k = 0; k < FT_BATCH; ++k) {
        if (ls[k] != cur) {
          if (cur < WINDOW) atomicAdd(reinterpret_cast<float4*>(out + (row0 + cur) * p.d), run);
          run = zero4();
          cur = ls[k];
        }
        add_into(run, v[k]);
      }
    }
    if (active && cur < WINDOW) atomicAdd(reinterpret_cast<float4*>(out + (row0 + cur) * p.d), run);
  }
}

// K1 from device memory (a large table, or pre-gathered rows): the gathers
// are what costs, so many warps an SM keep rows in flight, each with a short
// chain of loads.  One block takes one tile (no counter, no persistent
// loop); its lanes split into row groups of slice / 4 lanes (a power of two,
// else one group a warp), and the groups take equal chunks of the tile's
// slots, GU_BATCH rows loaded before they are summed.  Runs of equal `local`
// are summed in registers: a run inside a chunk is added to its output row
// with float4 global atomics; a run cut at a chunk boundary goes through
// the groups' edge buffers in shared memory and is added once, after a
// barrier, by the group where it starts (on a relation into few rows every
// chunk of a tile holds the same row, and a global atomic per chunk would
// queue at that row's L2 slice).
constexpr int GU_BATCH = 4;       // rows a row group loads before it sums them
constexpr int GU_MIN_BLOCKS = 3;  // resident blocks an SM (40 registers a thread)
constexpr int GU_THREADS = 512;
constexpr int GU_WARPS = GU_THREADS / 32;

template <bool kGathered>
__global__ void __launch_bounds__(GU_THREADS, GU_MIN_BLOCKS) gather_tile_kernel(FusedTable p) {
  __shared__ int sloc[TILE_E];
  __shared__ int ssrc[kGathered ? 1 : TILE_E];
  __shared__ float4 edge[GU_WARPS * 32];  // a run cut at a chunk's start, per group: [groups, q]
  const long long t = blockIdx.x;
  const long long e0 = t * TILE_E;
  for (int i = threadIdx.x; i < TILE_E; i += GU_THREADS) {
    sloc[i] = p.local[e0 + i];
    if constexpr (!kGathered) ssrc[i] = p.src[e0 + i];
  }
  const long long row0 = (long long)p.tile_map[t] * WINDOW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * p.slice;
  const int q = min(p.slice, p.d - c0) / 4;
  const int groups = (q & (q - 1)) == 0 ? 32 / q : 1;
  const int gi = lane / q, ci = lane - gi * q;
  const bool active = gi < groups;
  const int gid = warp * groups + gi, chunk = TILE_E / (GU_WARPS * groups);
  const int i0 = active ? gid * chunk : 0, i1 = active ? i0 + chunk : 0;
  const float* rows = p.table + c0 + 4 * ci;
  float* out = p.out + c0 + 4 * ci;
  __syncthreads();
  const bool head_cut = active && i0 > 0 && sloc[i0] < WINDOW && sloc[i0 - 1] == sloc[i0];
  const bool tail_cut = active && i1 < TILE_E && sloc[i1 - 1] < WINDOW && sloc[i1] == sloc[i1 - 1];
  float4 run = zero4();
  int cur = WINDOW;  // local row of the open run; WINDOW = none
  bool first = true;
  for (int i = i0; i < i1; i += GU_BATCH) {
    int ls[GU_BATCH];
    float4 v[GU_BATCH];
#pragma unroll
    for (int k = 0; k < GU_BATCH; ++k) {
      const bool in = i + k < i1;  // a chunk may be shorter than a batch (narrow rows)
      const int l = in ? sloc[i + k] : WINDOW;
      const long long r = kGathered ? e0 + i + k : (in ? ssrc[i + k] : 0);
      const bool ok = l < WINDOW && (kGathered || static_cast<unsigned long long>(r) < static_cast<unsigned>(p.num_src));
      ls[k] = l;
      v[k] = ok ? __ldg(reinterpret_cast<const float4*>(rows + r * p.d)) : zero4();
    }
#pragma unroll
    for (int k = 0; k < GU_BATCH; ++k) {
      if (ls[k] < WINDOW && ls[k] != cur) {
        if (cur < WINDOW) {  // a run that ends inside the chunk
          if (first && head_cut) {
            edge[gid * q + ci] = run;
          } else {
            atomicAdd(reinterpret_cast<float4*>(out + (row0 + cur) * p.d), run);
          }
          first = false;
        }
        run = zero4();
        cur = ls[k];
      }
      add_into(run, v[k]);
    }
  }
  if (cur < WINDOW) {  // the chunk's last run
    if (first && head_cut) {
      edge[gid * q + ci] = run;
    } else if (!tail_cut) {
      atomicAdd(reinterpret_cast<float4*>(out + (row0 + cur) * p.d), run);
    }
  }
  __syncthreads();  // every group's cut head is written
  if (tail_cut && !(first && head_cut)) {  // this group holds the start of a cut run
    for (int o = gid + 1; o < GU_WARPS * groups && sloc[o * chunk] == cur; ++o) add_into(run, edge[o * q + ci]);
    atomicAdd(reinterpret_cast<float4*>(out + (row0 + cur) * p.d), run);
  }
}

template <bool kGathered>
int launch_gather_tiles(const FusedTable& p, int slices, void* stream) {
  int wave = 0;
  const cudaError_t err = mmgnn_one_wave(reinterpret_cast<const void*>(gather_tile_kernel<kGathered>),
                                         GU_THREADS, 0, &wave);
  if (err != cudaSuccess) return err;
  const int tiles = p.num_units / (TILE_E / FT_UNIT);
  gather_tile_kernel<kGathered><<<dim3(tiles, slices), GU_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// Launch K2f's body on (blocks, slices), blocks at most one wave of the
// blocks that are resident at once.
int launch_gather_runs(const FusedTable& p, int blocks, int slices, void* stream) {
  const size_t smem = sizeof(float) * (size_t)p.num_src * p.stride + sizeof(int) * FT_WARPS * 2 * FT_UNIT;
  int wave = 0;
  const cudaError_t err = mmgnn_one_wave(reinterpret_cast<const void*>(gather_runs_kernel), FT_THREADS, smem, &wave);
  if (err != cudaSuccess) return err;
  blocks = min(blocks, wave / slices > 0 ? wave / slices : 1);  // any grid is right: the counter deals past gridDim.x
  gather_runs_kernel<<<dim3(blocks, slices), FT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  idx == nullptr: x holds pre-gathered rows [num_tiles * 1024, d];
// otherwise row(e) = x[idx[e]] for a table of num_rows rows, staged in
// shared memory (staged != 0, column slices of `slice` columns at `stride`
// floats a row) or read from device memory.  out [num_windows * 128, d] and
// work [32 * slices] are zeroed by the caller.  The route and the launch
// shape come from the wrapper (ops/segment_kernels.py windowed_route,
// windowed_launch, fused_table_launch).
int mmgnn_segment_sum_windowed(const float* x, int num_rows, const int* idx, const int* local,
                               const int* tile_map, int num_tiles, int* work, int grab, int blocks,
                               int slices, int slice, int stride, int staged, int d, float* out,
                               void* stream) {
  const FusedTable p{x, num_rows, d, idx, local, tile_map, num_tiles * (TILE_E / FT_UNIT),
                     work, grab, slice, stride, out};
  if (idx == nullptr) return launch_gather_tiles<true>(p, slices, stream);
  if (!staged) return launch_gather_tiles<false>(p, slices, stream);
  return launch_gather_runs(p, blocks, slices, stream);
}

// K2f.  row(e) = table[win_src[e]] for a small source table of num_src
// rows; out [num_windows * 128, d] is zeroed by the caller, work [32 *
// slices] too.  The launch shape and the shared layout come from the wrapper
// (ops/segment_kernels.py fused_table_launch).
int mmgnn_fused_table_segment_sum(const float* table, int num_src, const int* win_src,
                                  const int* local, const int* tile_map, int num_tiles, int* work,
                                  int grab, int blocks, int slices, int slice, int stride, int d,
                                  float* out, void* stream) {
  const FusedTable p{table, num_src, d, win_src, local, tile_map, num_tiles * (TILE_E / FT_UNIT),
                     work, grab, slice, stride, out};
  return launch_gather_runs(p, blocks, slices, stream);
}

// K2b.  dT[win_src[e]] += g[tile_map[t] * 128 + local[e]]; g holds the
// destination rows [num_g_rows, d], dT [num_src, d] is zeroed by the caller.
// The launch shape and the shared layout come from the wrapper
// (ops/segment_kernels.py incidence_launch).
int mmgnn_fused_table_segment_sum_bwd(const float* g, int num_g_rows, const int* win_src,
                                      const int* local, const int* tile_map, int num_tiles,
                                      int* work, int grab, int blocks, int chunks, int col_blocks,
                                      int count_words, int b_stride, int num_src, int d,
                                      float* out, void* stream) {
  const Incidence p{g, num_g_rows, win_src, local, tile_map, nullptr, num_tiles, work, grab,
                    WINDOW, num_src, d, count_words, b_stride, out};
  return launch_incidence<false>(p, blocks, chunks, col_blocks, stream);
}

// K3.  row(e) = table[span_src[e]], read from the tile's row block
// table[span_base[t] : span_base[t] + span_rows] (bounded by num_rows).
int mmgnn_span_segment_sum(const float* table, int num_rows, const int* span_src,
                           const int* span_local, const int* tile_map, const int* span_base,
                           int num_tiles, int span_rows, int* work, int grab, int blocks,
                           int col_blocks, int count_words, int b_stride, int d, float* out,
                           void* stream) {
  if (span_rows > MAX_K) return cudaErrorInvalidValue;
  const Incidence p{table, num_rows, span_src, span_local, tile_map, span_base, num_tiles, work,
                    grab, span_rows, 0, d, count_words, b_stride, out};
  return launch_incidence<true>(p, blocks, 1, col_blocks, stream);
}

}  // extern "C"
