// Windowed flash attention for HGT, hand-written for Hopper (sm_90a).
// Built by ops/_build.py into the port's shared library with a plain C
// interface and called through ctypes from ops/attention_kernels.py.
//
// Replaces the three Pallas TPU kernels of multi_modal_gnn_tpu/ops/pallas_attention.py:
//   K6  _flash_fwd_call (_fwd_kernel_resident / _fwd_kernel_span)
//         -> mmgnn_flash_attention_fwd
//   K7  _flash_dq_call (_dq_kernel_resident / _dq_kernel_span)
//         -> mmgnn_flash_attention_dq
//   K8  _flash_dkv_call (_dkv_kernel_resident / _dkv_kernel_span)
//         -> mmgnn_flash_attention_dkv
//
// A plan (graph/attn_plan.py) lays one destination type's combined edge list
// out in TILE_E-slot tiles; every tile's output rows lie in one WINDOW-row
// window (tile_map[t], non-decreasing), local[e] is the slot's row in it
// (WINDOW = padding) and src[e] the row it gathers.  The forward layout has
// windows over destinations and gathers from the virtual source table (k,
// v); the reverse layout has windows over virtual sources and gathers from
// the destinations (q, dO, LSE, delta).  Per head (h = nh * dh columns, q
// scaled by 1/sqrt(dh) by the caller):
//   K6  out[d] = sum_e softmax_e(q[d] . k[s_e]) v[s_e],  lse[d] = m + log(sum exp)
//       (an empty destination: out 0, lse 1e30)
//   K7  dq[d]  = sum_e p_e (dO[d] . v[s_e] - delta[d]) k[s_e]
//   K8  dk[s]  = sum_e p_e (dO[d_e] . v[s] - delta[d_e]) q[d_e]
//       dv[s]  = sum_e p_e dO[d_e]
//   with p_e = exp(min(q[d] . k[s] - lse[d], 60)) and delta = sum_dh(dO * out),
// all in f32.  A padding slot's index is never read, so nothing past a table
// is ever touched.
//
// What bounds them on the H100: each real slot reads one or two 4*h-byte
// rows and does ~4*h (K6) to ~8*h (K7, K8) FLOPs, far below the card's f32
// rate; what the first versions lost time to was per-tile fixed work, the
// latency of each slot's chain of head-sum shuffles, float atomics in shared
// memory (compare-and-swap loops in SASS) and scalar global atomics flushing
// whole window partials.
//
// K6 and K7 (redesigned for Hopper; flash_rows_kernel).  Their first version
// was a block of a few consecutive tiles with a [128, h] window accumulator
// merged into by shared float atomics, and K6 ran in two passes (an exact
// row max, then the sums) and a finish.  Now, as K8's sort route:
//   * Persistent blocks over column slices of 2^m whole heads take `grab`
//     tiles at a time from a counter per slice; grids are one wave.  The
//     launch plan (ops/attention_kernels.py rows_launch) takes the widest
//     slice that fits (all 128 columns at the HGT's widths): a tile's slots
//     are staged, ordered and walked once a slice.
//   * A tile's slots are copied in with cp.async under the previous tile's
//     work; a tile not in local-row order is counting-sorted in shared
//     memory (padding left out).  The model's plans hold tiles already in
//     row order (AttnSidePlan.row_ordered), so the sort is skipped.
//   * Each slot reads its k | v row through L1 / L2.  Staging each tile's
//     span block (the TPU kernels' VMEM copy) or a small table whole in
//     shared memory lost to these gathers on every group and width
//     measured on the H100 (PERF.md section 6, PR 8).  A run's row operands
//     (q; K7: dO, LSE, delta) are loaded once a run, beside its first
//     slot's k | v.
//   * Row groups of slice / 4 lanes take equal chunks of the ordered slots;
//     a lane owns 4 columns and the head's lanes sum dot products by xor
//     shuffles.  Runs of one row are summed in registers: K7 as plain sums,
//     K6 with the online softmax (running max m, normaliser l, exp-weighted
//     v sum o, rescaled by exp(m_old - m_new) when m rises).  A run wholly
//     inside a chunk merges into the block's window partial by its group
//     alone; a run cut at a chunk boundary through the groups' edge buffers
//     after a barrier, by the group where it starts.  No float atomics in
//     shared memory.
//   * The partial leaves when the window changes and at the end: K7's with
//     float4 global atomics.  K6's blocks cannot merge a softmax across
//     blocks with atomics: a block's stint in window w (its tiles of w, from
//     the grab g where it met w first; windows only grow along a block's
//     grabs) writes its partial (m, l per head; o for the rows it touched)
//     to entry g + w of a scratch array.  Grabs are consecutive tiles and
//     windows non-decreasing, so entries are distinct; unwritten ones keep
//     l = 0.  K6's blocks take their share of tiles in two grabs, so a
//     window has few entries.  A merge kernel (flash_fwd_merge_kernel)
//     combines a row's entries and writes out / max(l, 1e-20) and LSE.
//   * The backward clamps the exp argument at 60, as the TPU kernels do.
//   What bounds them now: the gathered k | v rows, 1 KB a slot at h = 128,
//   read through L2 at about 4 TB/s on the patient and lab groups, and the
//   instructions of each slot's head sums.
//
// K8 (redesigned for Hopper).  Its first version was a block of consecutive
// tiles with a [128, 2h] window partial (128 KB at h = 128, so
// one 16-warp block an SM), merged runs into it with shared f32 atomics
// (compare-and-swap loops in SASS) and flushed all 32,768 entries with
// scalar global atomics per block and window.  Now two routes, picked in
// Python from the shapes (ops/attention_kernels.py dkv_launch):
//   * Table route, for a gathered side of at most 512 rows (the plans' own
//     limit for the resident, dst-sorted layout: the lab, diagnosis and
//     medication groups): K2f's design.  A block stages a column slice of
//     whole heads of q and dO (and those heads' LSE and delta) for every
//     row; warps take 64-slot units from a counter; the lanes split into row
//     groups of slice / 4 lanes, each walking its own run of slots; runs of
//     one row (k and v loaded once a run) are summed in registers and added
//     with float4 global atomics.  No window partial, no shared atomics.
//   * Sort route (the patient group, gathering from 100,000 rows in the
//     span layout, sorted by source): the persistent blocks, staged tile
//     slots, counting sort and run merging of K6 / K7 above.  A block keeps
//     its slice of the window's k | v rows and of the window's dk | dv
//     partial in shared memory; q and dO are gathered per slot.
//   * 32 warps a block, one block an SM, both routes.  What bounds them now
//     is the per-slot gathers (q and dO through L2 on the sort route) and
//     the latency of each slot's head sums; PERF.md has the measurements.

#include <cuda_runtime.h>

// csrc/segment.cu: a kernel's dynamic shared memory set and its resident
// blocks (occupancy times SMs), asked of the runtime once and cached.
cudaError_t mmgnn_one_wave(const void* fn, int threads, size_t smem, int* wave);

namespace {

constexpr int WINDOW = 128;
constexpr int TILE_E = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;  // the max of a row with nothing summed yet
constexpr float EMPTY_LSE = 1e30f;
constexpr float EXP_CLAMP = 60.f;
constexpr int COUNTER_STRIDE = 32;  // a slice's tile counter on its own 128-byte line

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

__device__ __forceinline__ float4 scale4(const float4& x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// The sum of v over the lanes of this lane's head (lph lanes, aligned).
__device__ __forceinline__ float head_sum(float v, int lph) {
  for (int off = lph >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A slot's local row with anything outside [0, WINDOW) read as padding.
__device__ __forceinline__ int pad_local(int l) {
  return static_cast<unsigned>(l) < static_cast<unsigned>(WINDOW) ? l : WINDOW;
}

// 16-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Tile t's local rows, then its sources, into `buf` ([2, TILE_E]) by
// cp.async; the caller commits.
template <int THREADS>
__device__ __forceinline__ void stage_slots(const int* local, const int* src, int* buf, int t) {
  static_assert(2 * TILE_E <= 4 * THREADS, "a thread copies 16 bytes of a tile's slots");
  const long long e0 = (long long)t * TILE_E;
  const int i = 4 * threadIdx.x;
  if (i < 2 * TILE_E) cp_async16(buf + i, i < TILE_E ? local + e0 + i : src + e0 + i - TILE_E);
}

// A staged tile's real slots in local-row order: `cur` ([2, TILE_E]: locals,
// sources) as it is when already in order (padding last), else
// counting-sorted into `sorted` ([2, TILE_E]) with padding left out.  On
// entry `count` ([WINDOW + 1]) is 0 and the block has passed a barrier
// since; every thread calls it.  Returns the real slots' count (counted by
// the barrier, not by atomics on one word); (sl, ss) are their rows and
// sources.
template <int THREADS>
__device__ int order_tile(const int* cur, int* sorted, int* count, const int*& sl, const int*& ss) {
  static_assert(THREADS == TILE_E, "a thread a slot");
  const int i = threadIdx.x;
  const int l = pad_local(cur[i]);
  const int n = __syncthreads_count(l < WINDOW);
  const bool sort = __syncthreads_or(i + 1 < TILE_E && pad_local(cur[i + 1]) < l) != 0;  // block-uniform
  sl = cur;
  ss = cur + TILE_E;
  if (!sort) return n;
  if (l < WINDOW) atomicAdd(&count[l], 1);
  __syncthreads();
  if (i < 32) {  // exclusive scan of the WINDOW + 1 counts, one warp
    const int lane = i;
    constexpr int PER_LANE = (WINDOW + 1 + 31) / 32;
    int vals[PER_LANE];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int r = lane * PER_LANE + k;
      vals[k] = r <= WINDOW ? count[r] : 0;
      sum += vals[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int r = lane * PER_LANE + k;
      if (r <= WINDOW) count[r] = run;
      run += vals[k];
    }
  }
  __syncthreads();
  if (l < WINDOW) {
    const int pos = atomicAdd(&count[l], 1);
    sorted[pos] = l;
    sorted[TILE_E + pos] = cur[TILE_E + i];
  }
  __syncthreads();
  sl = sorted;
  ss = sorted + TILE_E;
  return n;
}

// Thread 0's tile dealing from a slice's counter, `grab` tiles at a time,
// the next grab taken one ahead.
struct Dealer {
  int pending = 0, end = 0;

  __device__ int first(int* work, int grab, int num_tiles) {
    const int t = atomicAdd(work, grab);
    pending = atomicAdd(work, grab);
    end = min(t + grab, num_tiles);
    return t;
  }

  __device__ int after(int t, int* work, int grab, int num_tiles) {
    int n = t + 1;
    if (n >= end) {
      n = pending;
      end = min(n + grab, num_tiles);
      if (n < num_tiles) pending = atomicAdd(work, grab);
    }
    return n;
  }
};

// ---------------------------------------------------------------------------
// K6 and K7: the forward and dq over the forward layout (notes in the header)
// ---------------------------------------------------------------------------

constexpr int ROW_THREADS = 1024;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_BATCH = 2;  // slots whose rows load before they are used
enum RowKind { FWD = 0, DQ = 1 };

struct RowArgs {
  const float* __restrict__ q;
  const float* __restrict__ k;
  const float* __restrict__ v;
  const float* __restrict__ dout;   // K7
  const float* __restrict__ lse;    // K7
  const float* __restrict__ delta;  // K7
  const int* __restrict__ src;
  const int* __restrict__ local;
  const int* __restrict__ tile_map;
  int num_tiles, h, nh;
  int slice;        // columns of a block's slice: 2^m whole heads
  int* work;        // a tile counter per slice (every COUNTER_STRIDE-th int), zeroed by the caller
  int grab;         // tiles a block takes at a time
  float* __restrict__ dq;  // K7 [rows, h], zeroed by the caller
  float* __restrict__ pm;  // K6 partials: [entries, WINDOW, nh] max,
  float* __restrict__ pl;  //   [entries, WINDOW, nh] normaliser (zeroed by the caller),
  float* __restrict__ po;  //   [entries, WINDOW, h] exp-weighted v sums
};

// Floats of a row group's cut run: o (K6: then m and l a lane), a multiple
// of 4 so that each group's o is 16-byte aligned.
__host__ __device__ inline int rows_edge_floats(int kind, int slice) {
  return kind == FWD ? slice + ((slice / 2 + 3) & ~3) : slice;
}

// Dynamic shared memory of flash_rows_kernel<kind> (mirrored by
// ops/attention_kernels.py _rows_shared_bytes).

__host__ __device__ inline size_t rows_shared_floats(int kind, int slice) {
  const int quads = slice / 4, groups = ROW_WARPS * 32 / quads;
  size_t n = (size_t)WINDOW * slice;                        // the window partial
  n += kind == FWD ? 2 * WINDOW * quads : 0;                // its max, normaliser (a copy a lane)
  n += (size_t)groups * rows_edge_floats(kind, slice);      // a cut run per row group
  return n;
}

size_t rows_shared_bytes(int kind, const RowArgs& a) {
  return sizeof(float) * rows_shared_floats(kind, a.slice) +
         sizeof(int) * 6 * TILE_E;  // two tiles' staged slots, one sorted
}

// Grid (blocks, column slices).  Notes in the header.
template <int KIND>
__global__ void __launch_bounds__(ROW_THREADS, 1) flash_rows_kernel(RowArgs a) {
  constexpr bool kFwd = KIND == FWD;
  extern __shared__ float4 smem4[];
  __shared__ int count[WINDOW + 1];
  __shared__ int next_tile;
  const int h = a.h, dh = h / a.nh, slice = a.slice, quads = slice / 4;
  const int c0 = blockIdx.y * slice, head0 = c0 / dh;
  const int groups = 32 / quads, ngroups = ROW_WARPS * groups, chunk = TILE_E / ngroups;
  const int ew = rows_edge_floats(KIND, slice);
  float* acc = reinterpret_cast<float*>(smem4);      // [WINDOW, slice]: dq or o
  float* am = acc + WINDOW * slice;                   // K6: [WINDOW, quads] max
  float* al = am + (kFwd ? WINDOW * quads : 0);       // K6: [WINDOW, quads] normaliser
  float* edge = al + (kFwd ? WINDOW * quads : 0);     // [ngroups, ew]: a run cut at the chunk's start
  int* raw = reinterpret_cast<int*>(edge + ngroups * ew);  // 2 x [2, TILE_E]
  int* sorted = raw + 4 * TILE_E;                     // [2, TILE_E]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / quads, ci = lane - gi * quads;
  const int gid = warp * groups + gi;  // the group's place in the block
  const int lph = dh / 4, hh = ci / lph;  // lanes a head; the lane's head in the slice
  const int col = c0 + 4 * ci;
  int* work = a.work + blockIdx.y * COUNTER_STRIDE;
  for (int i = threadIdx.x; i < WINDOW * slice; i += ROW_THREADS) acc[i] = 0.f;
  for (int i = threadIdx.x; kFwd && i < WINDOW * quads; i += ROW_THREADS) {
    am[i] = NEG_BIG;
    al[i] = 0.f;
  }
  Dealer deal;
  if (threadIdx.x == 0) next_tile = deal.first(work, a.grab, a.num_tiles);
  __syncthreads();
  int t = next_tile;
  if (t < a.num_tiles) stage_slots<ROW_THREADS>(a.local, a.src, raw, t);
  cp_async_commit();
  int buf = 0, window = -1, part = -1;
  bool dirty = false;  // the partial holds something

  // The window partial out: K7's into dq with float4 global atomics
  // (skipping zero quads), K6's into scratch entry `part`; then reset.
  auto flush = [&]() {
    for (int i = threadIdx.x; i < WINDOW * quads; i += ROW_THREADS) {
      const int r = i / quads, c = i - r * quads;
      const float4 x = lds4(acc + 4 * i);
      if (kFwd) {
        const long long prow = (long long)part * WINDOW + r;
        const float l = al[i];
        if (l > 0.f) *reinterpret_cast<float4*>(a.po + prow * h + c0 + 4 * c) = x;
        if (c % lph == 0) {
          a.pm[prow * a.nh + head0 + c / lph] = am[i];
          a.pl[prow * a.nh + head0 + c / lph] = l;
        }
        am[i] = NEG_BIG;
        al[i] = 0.f;
      } else if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f) {
        const long long row = (long long)window * WINDOW + r;
        atomicAdd(reinterpret_cast<float4*>(a.dq + row * h + c0 + 4 * c), x);
      }
      sts4(acc + 4 * i, zero4());
    }
  };

  // Merge a run (o, m, l) of row r into the window partial (this group's
  // alone).
  auto merge = [&](int r, const float4& o, float m, float l) {
    float* p = acc + r * slice + 4 * ci;
    float4 x = lds4(p);
    if (kFwd) {
      const int i = r * quads + ci;
      const float ma = am[i], mn = fmaxf(ma, m);
      const float sa = expf(ma - mn), sr = expf(m - mn);
      x = scale4(x, sa);
      axpy4(x, sr, o);
      al[i] = al[i] * sa + l * sr;
      am[i] = mn;
    } else {
      add4(x, o);
    }
    sts4(p, x);
  };

  while (t < a.num_tiles) {
    if (threadIdx.x == 0) next_tile = deal.after(t, work, a.grab, a.num_tiles);
    for (int i = threadIdx.x; i <= WINDOW; i += ROW_THREADS) count[i] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t's slots landed; the last tile's runs are in
    const int tn = next_tile;
    const int* cur = raw + buf * 2 * TILE_E;
    if (tn < a.num_tiles) stage_slots<ROW_THREADS>(a.local, a.src, raw + (buf ^ 1) * 2 * TILE_E, tn);
    cp_async_commit();
    const int w = __ldg(a.tile_map + t);
    if (w != window) {  // flush the partial
      if (dirty) flush();
      dirty = false;
      window = w;
      part = t / a.grab + w;  // K6: this stint's scratch entry
    }
    const int* sl;
    const int* ss;
    const int real = order_tile<ROW_THREADS>(cur, sorted, count, sl, ss);
    dirty = true;
    // this group's slots [g0, g1e); the partial's runs cut at g0 (head) and g1e (tail)
    const int g0 = gid * chunk, g1e = min(g0 + chunk, real);
    const bool mine = g0 < g1e;
    const bool head_cut = mine && g0 > 0 && sl[g0 - 1] == sl[g0];
    const bool tail_cut = mine && g1e < real && sl[g1e] == sl[g1e - 1];
    float* my_edge = edge + gid * ew;
    int cur_l = WINDOW, row_l = WINDOW;  // the open run's row; the row whose operands are loaded
    bool first = true;
    float4 run = zero4(), qc = zero4(), dc = zero4();
    float rm = NEG_BIG, rl = 0.f, lse_c = 0.f, delta_c = 0.f;
    // add the open run of row cur_l; `last`: it ends at g1e.  A run cut at
    // the chunk's end stays in registers for the fix-up below.
    auto close = [&](bool last) {
      if (cur_l >= WINDOW) return;
      if (first && head_cut) {
        sts4(my_edge + 4 * ci, run);
        if (kFwd) {
          my_edge[slice + ci] = rm;
          my_edge[slice + quads + ci] = rl;
        }
      } else if (!(last && tail_cut)) {  // the whole run is this group's
        merge(cur_l, run, rm, rl);
      }
    };
    // every lane runs every batch of the chunk (the head sums shuffle)
    for (int j0 = 0; j0 < chunk; j0 += ROW_BATCH) {
      int ls[ROW_BATCH];
      float4 kr[ROW_BATCH], vr[ROW_BATCH], qr[ROW_BATCH], dr[ROW_BATCH];
      float x[ROW_BATCH], y[ROW_BATCH];
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) {
        const int j = g0 + j0 + u;
        const bool on = j < g1e;
        ls[u] = on ? sl[j] : WINDOW;
        if (on) {  // the slot's k | v row through L1 / L2
          const long long s = ss[j];
          kr[u] = ldg4(a.k + s * h + col);
          vr[u] = ldg4(a.v + s * h + col);
        } else {
          kr[u] = vr[u] = zero4();
        }
        if (on && ls[u] != row_l) {  // a new row: its operands, loaded beside the slot's k | v
          row_l = ls[u];
          const long long row = (long long)window * WINDOW + row_l;
          qc = ldg4(a.q + row * h + col);
          if (!kFwd) {
            dc = ldg4(a.dout + row * h + col);
            lse_c = __ldg(a.lse + row * a.nh + head0 + hh);
            delta_c = __ldg(a.delta + row * a.nh + head0 + hh);
          }
        }
        qr[u] = qc;
        dr[u] = dc;
        x[u] = lse_c;
        y[u] = delta_c;
      }
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) {  // independent of the runs
        const float logit = head_sum(dot4(qr[u], kr[u]), lph);
        if (kFwd) {
          x[u] = logit;
        } else {
          const float dattn = head_sum(dot4(dr[u], vr[u]), lph);
          const float pe = ls[u] < WINDOW ? expf(fminf(logit - x[u], EXP_CLAMP)) : 0.f;
          x[u] = pe * (dattn - y[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) {
        if (ls[u] == WINDOW) break;  // past g1e (uniform in the group)
        if (ls[u] != cur_l) {
          close(false);
          if (cur_l < WINDOW) first = false;
          cur_l = ls[u];
          run = zero4();
          rm = NEG_BIG;
          rl = 0.f;
        }
        if (kFwd) {  // the online softmax, rescaled only when the run's max rises
          if (x[u] > rm) {
            const float corr = expf(rm - x[u]);
            rl *= corr;
            run = scale4(run, corr);
            rm = x[u];
          }
          const float pe = expf(x[u] - rm);
          rl += pe;
          axpy4(run, pe, vr[u]);
        } else {
          axpy4(run, x[u], kr[u]);
        }
      }
    }
    close(true);
    __syncthreads();  // every group's cut heads are written
    // the group where a cut run starts adds it and the heads of the groups it reaches
    const int r = mine ? sl[g1e - 1] : WINDOW;
    if (tail_cut && !(head_cut && sl[g0] == r)) {
      float4 so = run;
      float sm = rm, sn = rl;
      for (int o = gid + 1; o < ngroups; ++o) {
        const int oc = o * chunk;
        if (oc >= real || sl[oc] != r) break;
        const float* oe = edge + o * ew;
        if (kFwd) {
          const float m2 = oe[slice + ci], mn = fmaxf(sm, m2);
          const float s1 = expf(sm - mn), s2 = expf(m2 - mn);
          so = scale4(so, s1);
          axpy4(so, s2, lds4(oe + 4 * ci));
          sn = sn * s1 + oe[slice + quads + ci] * s2;
          sm = mn;
        } else {
          add4(so, lds4(oe + 4 * ci));
        }
      }
      merge(r, so, sm, sn);
    }
    t = tn;
    buf ^= 1;
  }
  __syncthreads();
  if (dirty) flush();
}

// K6's merge: blocks (window, part of its rows); each (row, column quad)
// combines, in one online pass, the partials of the grabs that hold the
// window's tiles (entries g + w), then writes out = o / max(l, 1e-20) and
// lse = m + log(l) (1e30 for a row no slot reached: out 0).
constexpr int MERGE_THREADS = 256;

__global__ void __launch_bounds__(MERGE_THREADS) flash_fwd_merge_kernel(
    const int* __restrict__ tile_map, int num_tiles, int grab, int h, int nh,
    const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ po,
    float* __restrict__ out, float* __restrict__ lse) {
  __shared__ int range[2];  // the window's tiles [range[0], range[1])
  const int w = blockIdx.x;
  if (threadIdx.x < 2) {  // lower bounds of w and w + 1 in the non-decreasing tile_map
    const int key = w + threadIdx.x;
    int lo = 0, hi = num_tiles;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(tile_map + mid) < key) lo = mid + 1; else hi = mid;
    }
    range[threadIdx.x] = lo;
  }
  __syncthreads();
  const int g0 = range[0] / grab;
  const int g1 = range[1] > range[0] ? (range[1] - 1) / grab : g0 - 1;
  const int quads = h / 4, lph = h / nh / 4;
  for (int i = blockIdx.y * MERGE_THREADS + threadIdx.x; i < WINDOW * quads; i += gridDim.y * MERGE_THREADS) {
    const int r = i / quads, c = i - r * quads, head = c / lph;
    float m = NEG_BIG, l = 0.f;
    float4 o = zero4();
    for (int g = g0; g <= g1; ++g) {
      const long long e = (long long)(g + w) * WINDOW + r;
      const float le = __ldg(pl + e * nh + head);
      if (le > 0.f) {
        const float me = __ldg(pm + e * nh + head), mn = fmaxf(m, me);
        const float s1 = expf(m - mn), s2 = expf(me - mn);
        l = l * s1 + le * s2;
        o = scale4(o, s1);
        axpy4(o, s2, ldg4(po + e * h + 4 * c));
        m = mn;
      }
    }
    const long long row = (long long)w * WINDOW + r;
    sts4(out + row * h + 4 * c, scale4(o, 1.f / fmaxf(l, 1e-20f)));
    if (c % lph == 0) lse[row * nh + head] = l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : EMPTY_LSE;
  }
}

// ---------------------------------------------------------------------------
// K8: dk and dv over the reverse layout (notes in the header)
// ---------------------------------------------------------------------------

constexpr int DKV_THREADS = 1024;
constexpr int DKV_WARPS = DKV_THREADS / 32;
constexpr int DKV_BATCH = 2;  // slots whose rows load before they are used (4 spilled)

struct DkvArgs {
  const float* __restrict__ q;
  const float* __restrict__ k;
  const float* __restrict__ v;
  const float* __restrict__ dout;
  const float* __restrict__ lse;
  const float* __restrict__ delta;
  const int* __restrict__ src;
  const int* __restrict__ local;
  const int* __restrict__ tile_map;
  int num_tiles, h, nh;
  int num_rows_kv;  // rows of k and v
  int slice;        // columns of a block's slice: 2^m whole heads
  int stage_kv;     // the window's k | v slice is kept in shared memory (else read from device memory)
  int* work;        // a tile counter per slice (every 32nd int), zeroed by the caller
  int grab;         // tiles a block takes at a time
  float* __restrict__ dk;
  float* __restrict__ dv;
};

// The window partial [WINDOW, 2 * slice] (dk | dv of columns [c0, c0 +
// slice)) into dk, dv [rows, h] of window `window` with float4 global
// atomics, skipping zero quads; then zero it.
__device__ void flush_dkv_slice(float* acc, int slice, int c0, int h, float* __restrict__ dk,
                                float* __restrict__ dv, int window) {
  const int quads = slice / 2;  // float4s a row: 2 * slice / 4
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = threadIdx.x; i < WINDOW * quads; i += DKV_THREADS) {
    const float4 x = acc4[i];
    if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f) {
      const long long row = (long long)window * WINDOW + i / quads;
      const int c = (i % quads) * 4;
      float* to = c < slice ? dk + row * h + c0 + c : dv + row * h + c0 + c - slice;
      atomicAdd(reinterpret_cast<float4*>(to), x);
    }
    acc4[i] = zero4();
  }
}

// Grid (blocks, column slices of 2^m whole heads).  Persistent blocks take
// `grab` tiles at a time from their slice's counter; each tile's slots are
// copied in under the previous tile's work.  A block keeps its slice of the
// window's k and v rows ([WINDOW, 2 * slice], loaded when the window
// changes) and of the window's dk / dv partial in shared memory.  A tile
// whose slots are not sorted by local row (the span layout's, sorted by
// source) is counting-sorted in shared memory (padding left out).  The
// warp's lanes split into row groups of slice / 4 lanes; the block's groups
// take equal chunks of the sorted slots.  A group gathers a batch of its
// slots' q and dO slices, computes every slot's p and dl (its k and v from
// shared memory, so the slots' dot products do not wait on each other),
// then merges runs of one row in registers and adds each run to the
// partial: a run wholly inside the chunk by its group alone (a plain
// read-modify-write: no other group touches the row in this tile), a run
// cut by a chunk boundary through the groups' edge buffers, summed after a
// barrier by the group where the run starts.  The partial is flushed when
// the window changes and at the end.
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_dkv_kernel(DkvArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ int count[WINDOW + 1];
  __shared__ int next_tile;
  const int h = a.h, dh = h / a.nh, slice = a.slice, width = 2 * slice;
  const int c0 = blockIdx.y * slice;
  const int quads = slice / 4, groups = 32 / quads;
  const int ngroups = DKV_WARPS * groups, chunk = TILE_E / ngroups;
  float* acc = reinterpret_cast<float*>(smem4);      // [WINDOW, 2 * slice]: dk | dv
  float* kv = acc + WINDOW * width;                   // [WINDOW, 2 * slice]: k | v of the window (stage_kv)
  float* edge = kv + (a.stage_kv ? WINDOW * width : 0);  // [ngroups, 2 * slice]: a run cut at the chunk's start
  int* raw = reinterpret_cast<int*>(edge + ngroups * width);  // 2 x [2, TILE_E]
  int* sorted = raw + 4 * TILE_E;                     // [2, TILE_E]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / quads, ci = lane - gi * quads;
  const bool active = gi < groups;
  const int gid = warp * groups + gi;  // the group's place in the block
  const int lph = dh / 4;
  const int head = (c0 + 4 * ci) / dh;
  int* work = a.work + blockIdx.y * COUNTER_STRIDE;
  for (int i = threadIdx.x; i < WINDOW * width; i += DKV_THREADS) acc[i] = 0.f;
  Dealer deal;
  if (threadIdx.x == 0) next_tile = deal.first(work, a.grab, a.num_tiles);
  __syncthreads();
  int t = next_tile;
  if (t < a.num_tiles) stage_slots<DKV_THREADS>(a.local, a.src, raw, t);
  cp_async_commit();
  int buf = 0, window = -1;
  bool dirty = false;  // the partial holds something
  while (t < a.num_tiles) {
    if (threadIdx.x == 0) next_tile = deal.after(t, work, a.grab, a.num_tiles);
    for (int i = threadIdx.x; i <= WINDOW; i += DKV_THREADS) count[i] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t's slots landed; the last tile's runs are in
    const int tn = next_tile;
    int* cur = raw + buf * 2 * TILE_E;
    if (tn < a.num_tiles) stage_slots<DKV_THREADS>(a.local, a.src, raw + (buf ^ 1) * 2 * TILE_E, tn);
    cp_async_commit();
    const int w = __ldg(a.tile_map + t);
    if (w != window) {  // flush the partial; the new window's k | v slice
      if (dirty) flush_dkv_slice(acc, slice, c0, h, a.dk, a.dv, window);
      dirty = false;
      window = w;
      const long long r0 = (long long)w * WINDOW;
      for (int i = threadIdx.x; a.stage_kv && i < WINDOW * quads; i += DKV_THREADS) {
        const int r = i / quads, c = (i - r * quads) * 4;
        const long long row = r0 + r;
        const bool in = row < a.num_rows_kv;
        *reinterpret_cast<float4*>(kv + r * width + c) = in ? ldg4(a.k + row * h + c0 + c) : zero4();
        *reinterpret_cast<float4*>(kv + r * width + slice + c) = in ? ldg4(a.v + row * h + c0 + c) : zero4();
      }
    }
    const int* sl;  // the tile's real slots in local-row order
    const int* ss;
    const int real = order_tile<DKV_THREADS>(cur, sorted, count, sl, ss);
    dirty = true;
    // this group's slots [g0, g1e); the partial's runs cut at g0 (head) and g1e (tail)
    const int g0 = gid * chunk, g1e = active ? min(g0 + chunk, real) : g0;
    const bool mine = g0 < g1e;
    const bool head_cut = mine && g0 > 0 && sl[g0 - 1] == sl[g0];
    const bool tail_cut = mine && g1e < real && sl[g1e] == sl[g1e - 1];
    float* my_edge = edge + gid * width;
    int cur_l = WINDOW;
    bool first = true;
    float4 run_k = zero4(), run_v = zero4();
    // add the open run of row cur_l; `last`: it ends at g1e.  A run cut at
    // the chunk's end stays in registers for the fix-up below.
    auto close = [&](bool last) {
      if (cur_l >= WINDOW) return;
      if (first && head_cut) {
        *reinterpret_cast<float4*>(my_edge + 4 * ci) = run_k;
        *reinterpret_cast<float4*>(my_edge + slice + 4 * ci) = run_v;
      } else if (!(last && tail_cut)) {  // the whole run is this group's
        float* row = acc + cur_l * width + 4 * ci;
        float4 x = *reinterpret_cast<float4*>(row);
        add4(x, run_k);
        *reinterpret_cast<float4*>(row) = x;
        x = *reinterpret_cast<float4*>(row + slice);
        add4(x, run_v);
        *reinterpret_cast<float4*>(row + slice) = x;
      }
    };
    // every lane runs every batch of the longest chunk (the head sums shuffle)
    for (int j0 = 0; j0 < chunk; j0 += DKV_BATCH) {
      float4 qr[DKV_BATCH], dr[DKV_BATCH];
      float coef[DKV_BATCH], pr[DKV_BATCH];
      int ls[DKV_BATCH];
#pragma unroll
      for (int u = 0; u < DKV_BATCH; ++u) {
        const int j = g0 + j0 + u;
        const bool on = j < g1e;
        ls[u] = on ? sl[j] : WINDOW;
        const long long d = on ? ss[j] : 0;
        qr[u] = on ? ldg4(a.q + d * h + c0 + 4 * ci) : zero4();
        dr[u] = on ? ldg4(a.dout + d * h + c0 + 4 * ci) : zero4();
        pr[u] = on ? __ldg(a.lse + d * a.nh + head) : 0.f;
        coef[u] = on ? __ldg(a.delta + d * a.nh + head) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < DKV_BATCH; ++u) {  // independent of the runs
        const int l = ls[u] < WINDOW ? ls[u] : 0;
        float4 kr, vr;
        if (a.stage_kv) {
          kr = *reinterpret_cast<const float4*>(kv + l * width + 4 * ci);
          vr = *reinterpret_cast<const float4*>(kv + l * width + slice + 4 * ci);
        } else {
          const long long row = (long long)window * WINDOW + l;
          kr = ls[u] < WINDOW ? ldg4(a.k + row * h + c0 + 4 * ci) : zero4();
          vr = ls[u] < WINDOW ? ldg4(a.v + row * h + c0 + 4 * ci) : zero4();
        }
        const float logit = head_sum(dot4(qr[u], kr), lph);
        const float dattn = head_sum(dot4(dr[u], vr), lph);
        const float p = ls[u] < WINDOW ? expf(fminf(logit - pr[u], EXP_CLAMP)) : 0.f;
        coef[u] = p * (dattn - coef[u]);
        pr[u] = p;
      }
#pragma unroll
      for (int u = 0; u < DKV_BATCH; ++u) {
        if (ls[u] == WINDOW) break;  // past g1e (uniform in the group)
        if (ls[u] != cur_l) {
          close(false);
          if (cur_l < WINDOW) first = false;
          cur_l = ls[u];
          run_k = zero4();
          run_v = zero4();
        }
        axpy4(run_k, coef[u], qr[u]);
        axpy4(run_v, pr[u], dr[u]);
      }
    }
    close(true);
    __syncthreads();  // every group's cut heads are written
    // the group where a cut run starts adds it and the heads of the groups it reaches
    const int r = mine ? sl[g1e - 1] : WINDOW;
    if (tail_cut && !(head_cut && sl[g0] == r)) {
      float4 sk = run_k, sv = run_v;
      for (int o = gid + 1; o < ngroups; ++o) {
        const int oc = o * chunk;
        if (oc >= real || sl[oc] != r) break;
        const float* oe = edge + o * width + 4 * ci;
        add4(sk, *reinterpret_cast<const float4*>(oe));
        add4(sv, *reinterpret_cast<const float4*>(oe + slice));
      }
      float* row = acc + r * width + 4 * ci;
      float4 x = *reinterpret_cast<float4*>(row);
      add4(x, sk);
      *reinterpret_cast<float4*>(row) = x;
      x = *reinterpret_cast<float4*>(row + slice);
      add4(x, sv);
      *reinterpret_cast<float4*>(row + slice) = x;
    }
    t = tn;
    buf ^= 1;
  }
  __syncthreads();
  if (dirty) flush_dkv_slice(acc, slice, c0, h, a.dk, a.dv, window);
}

// K8, table route: the gathered side (q, dO, LSE, delta) of at most 512
// rows, a column slice of whole heads staged in shared memory, as K2f stages
// its table (notes in the header).
constexpr int DKT_THREADS = 1024;
constexpr int DKT_WARPS = DKT_THREADS / 32;
constexpr int DKT_UNIT = 64;           // slots a warp takes at a time

struct DkvTable {
  const float* __restrict__ q;
  const float* __restrict__ k;
  const float* __restrict__ v;
  const float* __restrict__ dout;
  const float* __restrict__ lse;
  const float* __restrict__ delta;
  const int* __restrict__ src;
  const int* __restrict__ local;
  const int* __restrict__ tile_map;
  int num_rows;   // rows of q, dO, LSE and delta
  int num_units, h, nh;
  int slice;      // columns of a slice: 2^n whole heads
  int stride;     // floats per staged row of q and of dO
  int* work;      // a unit counter per slice (every 32nd int), zeroed by the caller
  int grab;       // units a warp takes at a time
  float* __restrict__ dk;
  float* __restrict__ dv;
};

// Grid (blocks, column slices).  A block stages columns [c0, c0 + slice) of
// q and dO and the slice's heads of LSE and delta for every gathered row;
// then its warps take units of 64 slots (the first grab by index, the rest
// from the slice's counter, the next unit's indices fetched under this
// one's work).  A warp's lanes split into row groups of slice / 4 lanes;
// each group walks its own run of the unit's slots, reads their rows from
// shared memory, loads k and v of a local row once a run of equal `local`,
// sums the run's dk and dv in registers and adds them with float4 global
// atomics.  Padding and a source past the table add nothing.
__global__ void __launch_bounds__(DKT_THREADS, 1) flash_dkv_table_kernel(DkvTable a) {
  extern __shared__ float4 smem4[];
  const int h = a.h, dh = h / a.nh;
  const int c0 = blockIdx.y * a.slice;
  const int hs = a.slice / dh, head0 = c0 / dh;
  float* sq = reinterpret_cast<float*>(smem4);             // [rows, stride]
  float* sd = sq + (size_t)a.num_rows * a.stride;          // [rows, stride]
  float* slse = sd + (size_t)a.num_rows * a.stride;        // [rows, hs]
  float* sdelta = slse + a.num_rows * hs;                  // [rows, hs]
  int* idx = reinterpret_cast<int*>(sdelta + a.num_rows * hs);  // per warp: locals, sources
  const int quads = a.slice / 4;
  for (int i = threadIdx.x; i < a.num_rows * quads; i += DKT_THREADS) {
    const int r = i / quads, c = (i - r * quads) * 4;
    cp_async16(sq + (size_t)r * a.stride + c, a.q + (long long)r * h + c0 + c);
    cp_async16(sd + (size_t)r * a.stride + c, a.dout + (long long)r * h + c0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < a.num_rows * hs; i += DKT_THREADS) {
    const int r = i / hs, j = i - r * hs;
    slse[i] = a.lse[(long long)r * a.nh + head0 + j];
    sdelta[i] = a.delta[(long long)r * a.nh + head0 + j];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = 32 / quads;
  const int gi = lane / quads, ci = lane - gi * quads;
  const bool active = gi < groups;
  const int lph = dh / 4, hh = ci / lph;  // the lane's head in the slice
  const int seg = (DKT_UNIT + groups - 1) / groups;  // every group runs seg steps (the head sums shuffle)
  const int s0 = min(gi * seg, DKT_UNIT), s1 = min(s0 + seg, DKT_UNIT);
  int* my_idx = idx + warp * 2 * DKT_UNIT;
  int* work = a.work + blockIdx.y * COUNTER_STRIDE;
  const int col = c0 + 4 * ci;
  const int dealt = gridDim.x * DKT_WARPS * a.grab;
  int u = (blockIdx.x * DKT_WARPS + warp) * a.grab;
  int u_end = min(u + a.grab, a.num_units);
  int next_grab = 0;  // lane 0
  if (lane == 0) next_grab = dealt + atomicAdd(work, a.grab);
  int l0 = WINDOW, l1 = WINDOW, r0 = 0, r1 = 0, w = 0;  // the unit's slots (lane, lane + 32)
  auto fetch = [&](int uu) {
    const long long e0 = (long long)uu * DKT_UNIT;
    l0 = a.local[e0 + lane];
    l1 = a.local[e0 + lane + 32];
    r0 = a.src[e0 + lane];
    r1 = a.src[e0 + lane + 32];
    w = a.tile_map[uu / (TILE_E / DKT_UNIT)];
  };
  if (u < a.num_units) fetch(u);
  while (u < a.num_units) {
    int un = u + 1;
    if (un >= u_end) {  // warp-uniform
      un = __shfl_sync(FULL, next_grab, 0);
      u_end = min(un + a.grab, a.num_units);
      if (lane == 0 && un < a.num_units) next_grab = dealt + atomicAdd(work, a.grab);
    }
    const int cl0 = l0, cl1 = l1, cr0 = r0, cr1 = r1;
    const long long row0 = (long long)w * WINDOW;
    if (un < a.num_units) fetch(un);
    u = un;
    if (!__any_sync(FULL, cl0 < WINDOW || cl1 < WINDOW)) continue;  // padding only
    __syncwarp();  // the last unit's indices are read
    my_idx[lane] = cl0;
    my_idx[lane + 32] = cl1;
    my_idx[DKT_UNIT + lane] = cr0;
    my_idx[DKT_UNIT + lane + 32] = cr1;
    __syncwarp();
    float4 run_k = zero4(), run_v = zero4(), krow = zero4(), vrow = zero4();
    int cur = WINDOW;  // local row of the group's open run; WINDOW = none
    // every lane runs every batch (the head sums shuffle across the warp)
#pragma unroll 4
    for (int s = s0; s < s0 + seg; ++s) {
      const int l = s < s1 ? my_idx[s] : WINDOW;
      const int d = s < s1 ? my_idx[DKT_UNIT + s] : 0;
      const bool ok = active && l < WINDOW && static_cast<unsigned>(d) < static_cast<unsigned>(a.num_rows);
      if (ok && l != cur) {  // a new run: close the open one
        if (cur < WINDOW) {
          atomicAdd(reinterpret_cast<float4*>(a.dk + (row0 + cur) * h + col), run_k);
          atomicAdd(reinterpret_cast<float4*>(a.dv + (row0 + cur) * h + col), run_v);
        }
        cur = l;
        run_k = zero4();
        run_v = zero4();
        krow = ldg4(a.k + (row0 + cur) * h + col);
        vrow = ldg4(a.v + (row0 + cur) * h + col);
      }
      const int r = ok ? d : 0;
      const float4 qd = *reinterpret_cast<const float4*>(sq + (size_t)r * a.stride + 4 * ci);
      const float4 dd = *reinterpret_cast<const float4*>(sd + (size_t)r * a.stride + 4 * ci);
      const float logit = head_sum(dot4(qd, krow), lph);
      const float dattn = head_sum(dot4(dd, vrow), lph);
      const float p = ok ? expf(fminf(logit - slse[r * hs + hh], EXP_CLAMP)) : 0.f;
      axpy4(run_k, p * (dattn - sdelta[r * hs + hh]), qd);
      axpy4(run_v, p, dd);
    }
    if (cur < WINDOW) {
      atomicAdd(reinterpret_cast<float4*>(a.dk + (row0 + cur) * h + col), run_k);
      atomicAdd(reinterpret_cast<float4*>(a.dv + (row0 + cur) * h + col), run_v);
    }
  }
}

// K6 and K7 launch flash_rows_kernel<kind> on (blocks, slices), blocks at
// most one wave of the blocks resident at once (any grid is right: tiles
// come from the counters).
int launch_rows(int kind, const RowArgs& a, int blocks, int slices, cudaStream_t st) {
  const void* fn = kind == FWD ? reinterpret_cast<const void*>(flash_rows_kernel<FWD>)
                                : reinterpret_cast<const void*>(flash_rows_kernel<DQ>);
  const size_t smem = rows_shared_bytes(kind, a);
  int wave = 0;
  const cudaError_t err = mmgnn_one_wave(fn, ROW_THREADS, smem, &wave);
  if (err != cudaSuccess) return err;
  blocks = blocks < wave / slices ? blocks : wave / slices;
  if (blocks < 1) blocks = 1;
  const dim3 grid(blocks, slices);
  if (kind == FWD) {
    flash_rows_kernel<FWD><<<grid, ROW_THREADS, smem, st>>>(a);
  } else {
    flash_rows_kernel<DQ><<<grid, ROW_THREADS, smem, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6.  q [rows of the destinations, h], k and v [num_rows_kv, h]; out [num_windows * 128,
// h] and lse [num_windows * 128, nh] are written whole.  work (zeroed by the
// caller) holds a tile counter per column slice, every 32nd int; pm, pl
// ([entries, 128, nh]) and po ([entries, 128, h]) are scratch of
// ceil(num_tiles / grab) + num_windows entries; pl zeroed by the caller
// (an entry no block wrote is skipped), pm and po written before they are
// read.  The plan arrays must be
// 16-byte aligned; the launch shape comes from the wrapper
// (ops/attention_kernels.py fwd_launch).
int mmgnn_flash_attention_fwd(const float* q, const float* k, const float* v, const int* src,
                              const int* local, const int* tile_map, int num_tiles, int* work,
                              int grab, int blocks, int slices, int slice, int num_windows, int h,
                              int nh, float* pm, float* pl, float* po, float* out, float* lse,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowArgs a{q, k, v, nullptr, nullptr, nullptr, src, local, tile_map, num_tiles, h, nh,
                  slice, work, grab, nullptr, pm, pl, po};
  const int err = launch_rows(FWD, a, blocks, slices, st);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_windows, (WINDOW * h / 4 + MERGE_THREADS - 1) / MERGE_THREADS);
  flash_fwd_merge_kernel<<<grid, MERGE_THREADS, 0, st>>>(tile_map, num_tiles, grab, h, nh, pm, pl, po, out, lse);
  return cudaGetLastError();
}

// K7.  dq [num_windows * 128, h] (zeroed by the caller) from q, dO [rows of
// the destinations, h] and LSE, delta [the same rows, nh] over the forward
// layout; the rest as K6.
int mmgnn_flash_attention_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* delta, const int* src,
                             const int* local, const int* tile_map, int num_tiles, int* work,
                             int grab, int blocks, int slices, int slice, int h, int nh, float* dq,
                             void* stream) {
  const RowArgs a{q, k, v, dout, lse, delta, src, local, tile_map, num_tiles, h, nh,
                  slice, work, grab, dq, nullptr, nullptr, nullptr};
  return launch_rows(DQ, a, blocks, slices, static_cast<cudaStream_t>(stream));
}

// K8.  dk, dv [rows, h] (zeroed by the caller, rows = the reverse plan's
// windows * 128) over the reverse layout, whose src are destination rows;
// work (zeroed by the caller) holds the tile counter (the sort route) or a
// unit counter per column slice, every 32nd int (the table route, slices >
// 0: a slice of `slice` columns of q and dO staged at `stride` floats a
// row).  Blocks are capped at one wave of resident blocks.  The plan arrays
// must be 16-byte aligned.  The route and launch shape come from the
// wrapper (ops/attention_kernels.py dkv_launch).
int mmgnn_flash_attention_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, const int* src,
                              const int* local, const int* tile_map, int num_tiles, int num_rows,
                              int num_rows_kv, int* work, int grab, int blocks, int mode,
                              int slices, int slice, int stride, int h, int nh, float* dk, float* dv,
                              void* stream) {
  int wave = 0;
  cudaError_t err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const int hs = slice / (h / nh);
    const size_t smem = sizeof(float) * ((size_t)2 * num_rows * stride + 2 * num_rows * hs) +
                        sizeof(int) * DKT_WARPS * 2 * DKT_UNIT;
    err = mmgnn_one_wave(reinterpret_cast<const void*>(flash_dkv_table_kernel), DKT_THREADS, smem, &wave);
    if (err != cudaSuccess) return err;
    const DkvTable a{q, k, v, dout, lse, delta, src, local, tile_map, num_rows,
                     num_tiles * (TILE_E / DKT_UNIT), h, nh, slice, stride, work, grab, dk, dv};
    blocks = blocks < wave / slices ? blocks : wave / slices;  // any grid is right: the counter deals past gridDim.x
    if (blocks < 1) blocks = 1;
    flash_dkv_table_kernel<<<dim3(blocks, slices), DKT_THREADS, smem, st>>>(a);
    return cudaGetLastError();
  }
  const int ngroups = DKV_WARPS * 32 / (slice / 4);
  const int stage_kv = mode == 1;
  const size_t smem = sizeof(float) * ((1 + stage_kv) * WINDOW * 2 * slice + ngroups * 2 * slice) +
                      sizeof(int) * 6 * TILE_E;
  err = mmgnn_one_wave(reinterpret_cast<const void*>(flash_dkv_kernel), DKV_THREADS, smem, &wave);
  if (err != cudaSuccess) return err;
  blocks = blocks < wave / slices ? blocks : wave / slices;  // any grid is right: tiles come from work
  if (blocks < 1) blocks = 1;
  const DkvArgs a{q, k, v, dout, lse, delta, src, local, tile_map, num_tiles, h, nh, num_rows_kv, slice,
                  stage_kv, work, grab, dk, dv};
  flash_dkv_kernel<<<dim3(blocks, slices), DKV_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
