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
// design:
//   * One block per group of consecutive tiles (not per window): the lab,
//     diagnosis and medication groups have 3-4 forward windows for up to 5M
//     edges, the patient group 11 reverse windows for 6.4M.  A block sorts
//     each tile's slots by output row in shared memory (a counting sort, as
//     K3 does), so every warp walks runs of one output row: the row's own
//     operands (q / dO / LSE / delta in K6, K7; k / v in K8) load once per
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

#include <cuda_runtime.h>

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

// The same for K8's [WINDOW, 2h] accumulator: columns [0, h) into dk,
// [h, 2h) into dv.
__device__ void flush_dkv(float* acc, int h, float* __restrict__ dk, float* __restrict__ dv,
                          int window) {
  const int width = 2 * h;
  for (int i = threadIdx.x; i < WINDOW * width; i += THREADS) {
    const float v = acc[i];
    if (v != 0.f) {
      const long long row = (long long)window * WINDOW + i / width;
      const int c = i % width;
      atomicAdd(c < h ? dk + row * h + c : dv + row * h + c - h, v);
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
// K8: dk and dv over the reverse layout
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ src, const int* __restrict__ local,
                 const int* __restrict__ tile_map, int num_tiles, int tiles_per_block, int h,
                 int nh, float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ SortedTile st;
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [WINDOW, 2h]: dk | dv
  const int width = 2 * h;
  const Lane L = lane_of(h, nh);
  for (int i = threadIdx.x; i < WINDOW * width; i += THREADS) acc[i] = 0.f;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      __syncthreads();
      flush_dkv(acc, h, dk, dv, window);
      window = w;
    }
    sort_tile(src, local, t, st);
    const long long row0 = (long long)window * WINDOW;
    int begin, end;
    warp_range(st, begin, end);
    int cur = WINDOW;
    float4 k4 = zero4(), v4 = zero4(), run_k = zero4(), run_v = zero4();
    for (int j0 = begin; j0 < end; j0 += BATCH) {
      float4 qr[BATCH], dr[BATCH];
      float lse_e[BATCH], delta_e[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        const bool on = L.active && j < end;
        const long long d = on ? st.src[j] : 0;
        qr[u] = on ? ldg4(q + d * h + L.c) : zero4();
        dr[u] = on ? ldg4(dout + d * h + L.c) : zero4();
        lse_e[u] = on ? lse[d * nh + L.head] : 0.f;
        delta_e[u] = on ? delta[d * nh + L.head] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u;
        if (j >= end) break;
        const int l = st.local[j];
        if (l != cur) {
          if (L.active && cur < WINDOW) {
            atomic_add4(acc + cur * width + L.c, run_k);
            atomic_add4(acc + cur * width + h + L.c, run_v);
          }
          cur = l;
          run_k = zero4();
          run_v = zero4();
          const long long r = row0 + l;
          k4 = L.active ? ldg4(k + r * h + L.c) : zero4();
          v4 = L.active ? ldg4(v + r * h + L.c) : zero4();
        }
        const float logit = head_sum(dot4(qr[u], k4), L.lph);
        const float dattn = head_sum(dot4(dr[u], v4), L.lph);
        const float p = expf(fminf(logit - lse_e[u], EXP_CLAMP));
        axpy4(run_k, p * (dattn - delta_e[u]), qr[u]);
        axpy4(run_v, p, dr[u]);
      }
    }
    if (L.active && cur < WINDOW) {
      atomic_add4(acc + cur * width + L.c, run_k);
      atomic_add4(acc + cur * width + h + L.c, run_v);
    }
  }
  __syncthreads();
  flush_dkv(acc, h, dk, dv, window);
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
// windows * 128) over the reverse layout, whose src are destination rows.
int mmgnn_flash_attention_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, const int* src,
                              const int* local, const int* tile_map, int num_tiles,
                              int tiles_per_block, int h, int nh, float* dk, float* dv,
                              void* stream) {
  const size_t smem = sizeof(float) * WINDOW * 2 * h;
  cudaError_t err = allow_shared(flash_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<<<grid_of(num_tiles, tiles_per_block), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, delta, src, local,
                                                          tile_map, num_tiles, tiles_per_block, h,
                                                          nh, dk, dv);
  return cudaGetLastError();
}

}  // extern "C"
