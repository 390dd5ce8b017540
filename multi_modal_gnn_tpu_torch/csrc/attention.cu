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
// window (tile_map[t]), local[e] is the slot's row in it (WINDOW = padding)
// and src[e] the row it gathers.  The forward layout has windows over
// destinations and gathers from the virtual source table (k, v); the
// reverse layout has windows over virtual sources and gathers from the
// destinations (q, dO, LSE, delta).  Per head (h = nh * dh columns, q scaled
// by 1/sqrt(dh) by the caller):
//   K6  out[d] = sum_e softmax_e(q[d] . k[s_e]) v[s_e],  lse[d] = m + log(sum exp)
//       (an empty destination: out 0, lse 1e30)
//   K7  dq[d]  = sum_e p_e (dO[d] . v[s_e] - delta[d]) k[s_e]
//   K8  dk[s]  = sum_e p_e (dO[d_e] . v[s] - delta[d_e]) q[d_e]
//       dv[s]  = sum_e p_e dO[d_e]
//   with p_e = exp(min(q[d] . k[s] - lse[d], 60)) and delta = sum_dh(dO * out),
// all in f32.  Both layouts run through the same code: the span layout's
// promise (a tile's sources lie in span_rows rows from span_base[t]) was what
// let the TPU copy one block per tile into VMEM; here rows are gathered by
// index through L1 / L2 (at the 2048 / 4096-row rungs a span is 2-4 MB of
// k|v, more than any block's shared memory), and the span layout's locality
// shows as L2 hits.  A padding slot's index is never read, so nothing past a
// table is ever touched.
//
// What bounds them on the H100: gathered bytes and per-slot latency.  Each
// real slot reads one or two 4*h-byte rows (k and v; q and dO in K8) and
// does ~4*h (K6) to ~8*h (K7, K8) FLOPs, so the FLOP count is far below the
// card's f32 rate and the gathered traffic is served mostly by L2.  The
// design of K6 and K7:
//   * One block per group of consecutive tiles (not per window): the lab,
//     diagnosis and medication groups have 3-4 forward windows for up to 5M
//     edges, the patient group 11 reverse windows for 6.4M.  A block sorts
//     each tile's slots by output row in shared memory (a counting sort, as
//     K3 does), so every warp walks runs of one output row: the row's own
//     operands (q / dO / LSE / delta in K6, K7) load once per
//     run, the run's sums stay in registers, and one shared-memory atomic per
//     column merges the run into the block's window accumulator, which is
//     flushed to the zeroed output with global f32 atomics when the window
//     changes and at the end.  Sums change order from run to run.
//   * A lane owns 4 columns (one 16-byte load per row); the dh / 4 lanes of a
//     head reduce the per-head dot products with xor shuffles.  h <= 128.
//   * K6 cannot carry a running max across blocks, so it runs in two passes
//     and a finish: the first computes every slot's logits (stored, [slots,
//     nh]) and the exact row max per head (float atomicMax), the second sums
//     exp(logit - max) and the exp-weighted v rows, and the finish divides by
//     max(sum, 1e-20) and writes LSE.  K7 and K8 need no max: with LSE and
//     delta known their sums are plain, and f32 atomics across blocks do.
//   * The backward clamps the exp argument at 60, as the TPU kernels do.
//
// K8 (redesigned for Hopper).  Its first version was K6 / K7's block of
// consecutive tiles with a [128, 2h] window partial (128 KB at h = 128, so
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
//     span layout, sorted by source): persistent blocks over column slices
//     of whole heads take tiles from a counter; a tile's slots are copied in
//     with cp.async under the previous tile's work and counting-sorted by
//     local row in shared memory (integer atomics; padding left out).  A
//     block keeps its slice of the window's k | v rows and of the window's
//     dk | dv partial in shared memory.  Row groups take equal chunks of the
//     sorted slots; a run wholly inside a chunk is added to the partial by
//     its group alone (no atomics), a run cut at a chunk boundary is summed
//     after a barrier by the group where it starts.  The partial goes out
//     with float4 global atomics when the window changes and at the end.
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
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS_PER_WARP = TILE_E / WARPS;  // 64
constexpr int BATCH = 4;                        // slots whose rows load before they are used
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;  // the masked logit and the max of an empty row
constexpr float EXP_CLAMP = 60.f;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
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

__device__ __forceinline__ void atomic_add4(float* p, const float4& v) {
  atomicAdd(p + 0, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
}

// Float max through the integer atomics: non-negative floats order as
// signed ints, negative ones in reverse as unsigned ints.  -0 becomes +0.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_uint(v) == 0x80000000u) v = 0.f;
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

// The sum of v over the lanes of this lane's head (lph lanes, aligned).
__device__ __forceinline__ float head_sum(float v, int lph) {
  for (int off = lph >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A lane's place: 4 columns from c, in head `head` of lph lanes.
struct Lane {
  int c;
  int head;
  int lph;
  bool active;  // c < h
  bool leader;  // the first lane of its head
};

__device__ __forceinline__ Lane lane_of(int h, int nh) {
  const int lane = threadIdx.x & 31;
  Lane L;
  L.lph = h / nh / 4;
  L.c = lane * 4;
  L.head = lane / L.lph;
  L.active = L.c < h;
  L.leader = L.active && lane % L.lph == 0;
  return L;
}

// One tile's slots sorted by output row (padding last), in shared memory.
struct SortedTile {
  int local[TILE_E];
  int src[TILE_E];
  int slot[TILE_E];  // the slot's position in the tile before sorting
  int count[WINDOW + 1];
  int real;  // real slots: they fill [0, real)
};

// Counting sort of tile t's slots by local row.  Starts and ends with a
// barrier.
__device__ void sort_tile(const int* __restrict__ src, const int* __restrict__ local, long long t,
                          SortedTile& s) {
  const long long e0 = t * TILE_E;
  __syncthreads();
  for (int i = threadIdx.x; i <= WINDOW; i += THREADS) s.count[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_E; i += THREADS) {
    atomicAdd(&s.count[min(max(local[e0 + i], 0), WINDOW)], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan of the WINDOW + 1 counts, one warp
    const int lane = threadIdx.x;
    constexpr int PER_LANE = (WINDOW + 1 + 31) / 32;  // 5
    int v[PER_LANE];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = lane * PER_LANE + k;
      v[k] = i <= WINDOW ? s.count[i] : 0;
      sum += v[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += n;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = lane * PER_LANE + k;
      if (i == WINDOW) s.real = run;
      if (i <= WINDOW) s.count[i] = run;
      run += v[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_E; i += THREADS) {
    const int l = min(max(local[e0 + i], 0), WINDOW);
    const int pos = atomicAdd(&s.count[l], 1);
    s.local[pos] = l;
    s.src[pos] = src[e0 + i];
    s.slot[pos] = i;
  }
  __syncthreads();
}

// The sorted positions a warp walks: [begin, end).
__device__ __forceinline__ void warp_range(const SortedTile& s, int& begin, int& end) {
  begin = (threadIdx.x / 32) * SLOTS_PER_WARP;
  end = min(begin + SLOTS_PER_WARP, s.real);
}

// Add a [WINDOW, width] shared accumulator into rows of `out` (row stride
// `stride`, first column `col0`) for window `window`, and zero it.
__device__ void flush_sum(float* acc, int width, float* __restrict__ out, int window, int stride,
                          int col0) {
  for (int i = threadIdx.x; i < WINDOW * width; i += THREADS) {
    const float v = acc[i];
    if (v != 0.f) {
      const long long row = (long long)window * WINDOW + i / width;
      atomicAdd(out + row * stride + col0 + i % width, v);
    }
    acc[i] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// K6, pass 1: logits of every real slot, and each row's max per head
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_fwd_max_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const int* __restrict__ src, const int* __restrict__ local,
                     const int* __restrict__ tile_map, int num_tiles, int tiles_per_block, int h,
                     int nh, float* __restrict__ logits, float* __restrict__ row_max) {
  __shared__ SortedTile st;
  extern __shared__ float4 smem4[];
  float* smax = reinterpret_cast<float*>(smem4);  // [WINDOW, nh]
  const Lane L = lane_of(h, nh);
  for (int i = threadIdx.x; i < WINDOW * nh; i += THREADS) smax[i] = NEG_BIG;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      __syncthreads();
      float* dst = row_max + (long long)window * WINDOW * nh;
      for (int i = threadIdx.x; i < WINDOW * nh; i += THREADS) {
        if (smax[i] > NEG_BIG) atomic_max_float(dst + i, smax[i]);
        smax[i] = NEG_BIG;
      }
      window = w;
    }
    sort_tile(src, local, t, st);
    const long long row0 = (long long)window * WINDOW;
    int begin, end;
    warp_range(st, begin, end);
    int cur = WINDOW;
    float4 q4 = zero4();
    float run_max = NEG_BIG;
    for (int j0 = begin; j0 < end; j0 += BATCH) {
      float4 kr[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        kr[u] = (L.active && j < end) ? ldg4(k + (long long)st.src[j] * h + L.c) : zero4();
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        if (j >= end) break;  // warp-uniform
        const int l = st.local[j];
        if (l != cur) {  // warp-uniform
          if (L.leader && cur < WINDOW) atomic_max_float(&smax[cur * nh + L.head], run_max);
          cur = l;
          run_max = NEG_BIG;
          q4 = L.active ? ldg4(q + (row0 + l) * h + L.c) : zero4();
        }
        const float logit = head_sum(dot4(q4, kr[u]), L.lph);
        run_max = fmaxf(run_max, logit);
        if (L.leader) logits[((long long)t * TILE_E + st.slot[j]) * nh + L.head] = logit;
      }
    }
    if (L.leader && cur < WINDOW) atomic_max_float(&smax[cur * nh + L.head], run_max);
  }
  __syncthreads();
  float* dst = row_max + (long long)window * WINDOW * nh;
  for (int i = threadIdx.x; i < WINDOW * nh; i += THREADS) {
    if (smax[i] > NEG_BIG) atomic_max_float(dst + i, smax[i]);
  }
}

// ---------------------------------------------------------------------------
// K6, pass 2: sum of exp(logit - max) and of the exp-weighted v rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_fwd_sum_kernel(const float* __restrict__ v, const int* __restrict__ src,
                     const int* __restrict__ local, const int* __restrict__ tile_map,
                     int num_tiles, int tiles_per_block, int h, int nh,
                     const float* __restrict__ logits, const float* __restrict__ row_max,
                     float* __restrict__ out, float* __restrict__ den) {
  __shared__ SortedTile st;
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [WINDOW, h]
  float* sden = acc + WINDOW * h;                 // [WINDOW, nh]
  const Lane L = lane_of(h, nh);
  for (int i = threadIdx.x; i < WINDOW * (h + nh); i += THREADS) acc[i] = 0.f;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      __syncthreads();
      flush_sum(acc, h, out, window, h, 0);
      flush_sum(sden, nh, den, window, nh, 0);
      window = w;
    }
    sort_tile(src, local, t, st);
    const long long row0 = (long long)window * WINDOW;
    int begin, end;
    warp_range(st, begin, end);
    int cur = WINDOW;
    float m = 0.f;
    float4 run = zero4();
    float run_den = 0.f;
    for (int j0 = begin; j0 < end; j0 += BATCH) {
      float4 vr[BATCH];
      float lg[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        const bool on = L.active && j < end;
        vr[u] = on ? ldg4(v + (long long)st.src[j] * h + L.c) : zero4();
        lg[u] = on ? logits[((long long)t * TILE_E + st.slot[j]) * nh + L.head] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        if (j >= end) break;
        const int l = st.local[j];
        if (l != cur) {
          if (L.active && cur < WINDOW) atomic_add4(acc + cur * h + L.c, run);
          if (L.leader && cur < WINDOW) atomicAdd(&sden[cur * nh + L.head], run_den);
          cur = l;
          run = zero4();
          run_den = 0.f;
          m = L.active ? row_max[(row0 + l) * nh + L.head] : 0.f;
        }
        const float p = expf(lg[u] - m);  // <= 0: m is the row's max
        axpy4(run, p, vr[u]);
        run_den += p;
      }
    }
    if (L.active && cur < WINDOW) atomic_add4(acc + cur * h + L.c, run);
    if (L.leader && cur < WINDOW) atomicAdd(&sden[cur * nh + L.head], run_den);
  }
  __syncthreads();
  flush_sum(acc, h, out, window, h, 0);
  flush_sum(sden, nh, den, window, nh, 0);
}

// K6, finish: normalise, and LSE = max + log(sum) (1e30 for an empty row).
__global__ void flash_fwd_finish_kernel(long long rows, int h, int nh,
                                        const float* __restrict__ row_max,
                                        const float* __restrict__ den, float* __restrict__ out,
                                        float* __restrict__ lse) {
  const int dh = h / nh;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < rows * h;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / h;
    const int c = static_cast<int>(i % h);
    const long long rh = r * nh + c / dh;
    const float d = den[rh];
    out[i] = out[i] / fmaxf(d, 1e-20f);
    if (c % dh == 0) lse[rh] = d > 0.f ? row_max[rh] + logf(fmaxf(d, 1e-30f)) : 1e30f;
  }
}

// ---------------------------------------------------------------------------
// K7: dq over the forward layout
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ src, const int* __restrict__ local,
                const int* __restrict__ tile_map, int num_tiles, int tiles_per_block, int h, int nh,
                float* __restrict__ dq) {
  __shared__ SortedTile st;
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [WINDOW, h]
  const Lane L = lane_of(h, nh);
  for (int i = threadIdx.x; i < WINDOW * h; i += THREADS) acc[i] = 0.f;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      __syncthreads();
      flush_sum(acc, h, dq, window, h, 0);
      window = w;
    }
    sort_tile(src, local, t, st);
    const long long row0 = (long long)window * WINDOW;
    int begin, end;
    warp_range(st, begin, end);
    int cur = WINDOW;
    float4 q4 = zero4(), do4 = zero4(), run = zero4();
    float lse_r = 0.f, delta_r = 0.f;
    for (int j0 = begin; j0 < end; j0 += BATCH) {
      float4 kr[BATCH], vr[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        const bool on = L.active && j < end;
        const long long s = on ? (long long)st.src[j] * h + L.c : 0;
        kr[u] = on ? ldg4(k + s) : zero4();
        vr[u] = on ? ldg4(v + s) : zero4();
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        if (j >= end) break;
        const int l = st.local[j];
        if (l != cur) {
          if (L.active && cur < WINDOW) atomic_add4(acc + cur * h + L.c, run);
          cur = l;
          run = zero4();
          const long long r = row0 + l;
          q4 = L.active ? ldg4(q + r * h + L.c) : zero4();
          do4 = L.active ? ldg4(dout + r * h + L.c) : zero4();
          lse_r = L.active ? lse[r * nh + L.head] : 0.f;
          delta_r = L.active ? delta[r * nh + L.head] : 0.f;
        }
        const float logit = head_sum(dot4(q4, kr[u]), L.lph);
        const float dattn = head_sum(dot4(do4, vr[u]), L.lph);
        const float p = expf(fminf(logit - lse_r, EXP_CLAMP));
        axpy4(run, p * (dattn - delta_r), kr[u]);
      }
    }
    if (L.active && cur < WINDOW) atomic_add4(acc + cur * h + L.c, run);
  }
  __syncthreads();
  flush_sum(acc, h, dq, window, h, 0);
}

// ---------------------------------------------------------------------------
// K8: dk and dv over the reverse layout (notes in the header)
// ---------------------------------------------------------------------------

constexpr int DKV_THREADS = 1024;
constexpr int DKV_WARPS = DKV_THREADS / 32;
constexpr int DKV_COUNTER_STRIDE = 32;  // a slice's counter on its own 128-byte line
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

// A slot's local row with anything outside [0, WINDOW) read as padding.
__device__ __forceinline__ int pad_local(int l) {
  return static_cast<unsigned>(l) < static_cast<unsigned>(WINDOW) ? l : WINDOW;
}

// 16-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Tile t's local rows, then its sources, into `buf` ([2, TILE_E]); one
// commit group.
__device__ __forceinline__ void stage_dkv_tile(const DkvArgs& a, int* buf, int t) {
  static_assert(2 * TILE_E <= 4 * DKV_THREADS, "a thread copies 16 bytes of a tile's slots");
  const long long e0 = (long long)t * TILE_E;
  const int i = 4 * threadIdx.x;
  if (i < 2 * TILE_E) cp_async16(buf + i, i < TILE_E ? a.local + e0 + i : a.src + e0 + i - TILE_E);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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
  __shared__ int next_tile, real_slots[2];  // real slots of the tile, by the parity of its turn
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
  int* work = a.work + blockIdx.y * DKV_COUNTER_STRIDE;
  for (int i = threadIdx.x; i < WINDOW * width; i += DKV_THREADS) acc[i] = 0.f;
  int pending = 0, g1 = 0;  // thread 0: the grab taken ahead, the end of the current grab
  if (threadIdx.x == 0) {
    real_slots[0] = real_slots[1] = 0;
    next_tile = atomicAdd(work, a.grab);
    pending = atomicAdd(work, a.grab);
    g1 = min(next_tile + a.grab, a.num_tiles);
  }
  __syncthreads();
  int t = next_tile;
  if (t < a.num_tiles) stage_dkv_tile(a, raw, t);
  int buf = 0, window = -1;
  bool dirty = false;  // the partial holds something
  while (t < a.num_tiles) {
    if (threadIdx.x == 0) {  // the tile after t
      int n = t + 1;
      if (n >= g1) {
        n = pending;
        g1 = min(n + a.grab, a.num_tiles);
        if (n < a.num_tiles) pending = atomicAdd(work, a.grab);
      }
      next_tile = n;
    }
    for (int i = threadIdx.x; i <= WINDOW; i += DKV_THREADS) count[i] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t's slots landed; the last tile's runs are in
    const int tn = next_tile;
    if (threadIdx.x == 0) real_slots[buf ^ 1] = 0;  // the next turn's, read last a turn ago
    int* cur = raw + buf * 2 * TILE_E;
    if (tn < a.num_tiles) stage_dkv_tile(a, raw + (buf ^ 1) * 2 * TILE_E, tn);
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
    int unsorted = 0, nreal = 0;
    for (int i = threadIdx.x; i < TILE_E; i += DKV_THREADS) {
      const int l = pad_local(cur[i]);
      nreal += l < WINDOW;
      if (i + 1 < TILE_E && pad_local(cur[i + 1]) < l) unsorted = 1;
    }
    if (nreal) atomicAdd(&real_slots[buf], nreal);
    const bool sort = __syncthreads_or(unsorted) != 0;  // block-uniform
    const int real = real_slots[buf];
    const int* sl = cur;  // the tile's real slots in local-row order
    const int* ss = cur + TILE_E;
    if (sort) {  // counting sort of the real slots by local row (padding is left out)
      for (int i = threadIdx.x; i < TILE_E; i += DKV_THREADS) {
        const int l = pad_local(cur[i]);
        if (l < WINDOW) atomicAdd(&count[l], 1);
      }
      __syncthreads();
      if (threadIdx.x < 32) {  // exclusive scan of the WINDOW + 1 counts, one warp
        constexpr int PER_LANE = (WINDOW + 1 + 31) / 32;
        int vals[PER_LANE];
        int sum = 0;
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          const int i = lane * PER_LANE + k;
          vals[k] = i <= WINDOW ? count[i] : 0;
          sum += vals[k];
        }
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += n;
        }
        int run = incl - sum;
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          const int i = lane * PER_LANE + k;
          if (i <= WINDOW) count[i] = run;
          run += vals[k];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < TILE_E; i += DKV_THREADS) {
        const int l = pad_local(cur[i]);
        if (l == WINDOW) continue;
        const int pos = atomicAdd(&count[l], 1);
        sorted[pos] = l;
        sorted[TILE_E + pos] = cur[TILE_E + i];
      }
      __syncthreads();
      sl = sorted;
      ss = sorted + TILE_E;
    }
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
constexpr int DKT_COUNTER_STRIDE = 32; // a slice's counter on its own 128-byte line

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
  int* work = a.work + blockIdx.y * DKT_COUNTER_STRIDE;
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

int grid_of(int num_tiles, int tiles_per_block) {
  return (num_tiles + tiles_per_block - 1) / tiles_per_block;
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// K6.  q [num_dst, h], k and v [num_src, h]; the caller fills row_max with
// -1e30 and zeroes den and out (both [rows, nh] / [rows, h], rows = the
// plan's windows * 128); logits [num_tiles * 1024, nh] is scratch.  Writes
// out (normalised) and lse [rows, nh].
int mmgnn_flash_attention_fwd(const float* q, const float* k, const float* v, const int* src,
                              const int* local, const int* tile_map, int num_tiles,
                              int tiles_per_block, int rows, int h, int nh, float* logits,
                              float* row_max, float* den, float* out, float* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = grid_of(num_tiles, tiles_per_block);
  const size_t max_smem = sizeof(float) * WINDOW * nh;
  cudaError_t err = allow_shared(flash_fwd_max_kernel, max_smem);
  if (err != cudaSuccess) return err;
  flash_fwd_max_kernel<<<blocks, THREADS, max_smem, st>>>(q, k, src, local, tile_map, num_tiles,
                                                           tiles_per_block, h, nh, logits, row_max);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t sum_smem = sizeof(float) * WINDOW * (h + nh);
  if ((err = allow_shared(flash_fwd_sum_kernel, sum_smem)) != cudaSuccess) return err;
  flash_fwd_sum_kernel<<<blocks, THREADS, sum_smem, st>>>(v, src, local, tile_map, num_tiles,
                                                           tiles_per_block, h, nh, logits, row_max,
                                                           out, den);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)rows * h;
  const int finish_blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  flash_fwd_finish_kernel<<<finish_blocks, 256, 0, st>>>(rows, h, nh, row_max, den, out, lse);
  return cudaGetLastError();
}

// K7.  dq [rows, h] (zeroed by the caller) from q, dO [num_dst, h] and LSE,
// delta [num_dst, nh] over the forward layout.
int mmgnn_flash_attention_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* delta, const int* src,
                             const int* local, const int* tile_map, int num_tiles,
                             int tiles_per_block, int h, int nh, float* dq, void* stream) {
  const size_t smem = sizeof(float) * WINDOW * h;
  cudaError_t err = allow_shared(flash_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<<<grid_of(num_tiles, tiles_per_block), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, delta, src, local,
                                                         tile_map, num_tiles, tiles_per_block, h,
                                                         nh, dq);
  return cudaGetLastError();
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
