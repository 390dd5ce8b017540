// Windowed segment sums for neighbor aggregation, hand-written for Hopper
// (sm_90a).  Built by ops/_build.py into a shared library with a plain C
// interface and called through ctypes from ops/segment_kernels.py.
//
// Replaces four Pallas TPU kernels of multi_modal_gnn_tpu/ops/pallas_segment.py:
//   K1  _windowed_segment_sum_fwd / _segment_kernel
//         -> mmgnn_segment_sum_windowed
//   K2f _fused_table_segment_sum_fwd / _fused_table_kernel_take
//         -> mmgnn_fused_table_segment_sum
//   K2b _fused_table_segment_sum_bwd / _fused_table_bwd_kernel_take
//         -> mmgnn_fused_table_segment_sum_bwd (notes at the kernel)
//   K3  _span_dma_segment_sum_fwd / _span_dma_kernel
//         -> mmgnn_span_segment_sum
//
// K1 also serves as the backward of the span and paired tiers (the reverse
// relation's windowed sum of the scaled upstream gradient), and of a row
// gather with a GatherPlan (ops/segment.py).
//
// All three compute, for a windowed plan (graph/hetero.py),
//   out[tile_map[t] * 128 + local[e]] += row(e)       for every slot e of tile t
// with f32 accumulation; slots with local == 128 are padding and add nothing.
// row(e) is a pre-gathered row G[e] (K1 without idx), a table row x[src[e]]
// (K1 with idx, K2f), or a row of the tile's staged span block (K3).
//
// What bounds them on the H100: bytes.  There is one add per gathered
// element, so the work is reading about E * D * 4 bytes of gathered rows
// (K1, K2f; K3 reads tiles * span_rows * D * 4 of contiguous blocks instead)
// against writing num_dst * D * 4 bytes of output.  The design:
//   * One block per group of consecutive tiles, not one per window: a
//     relation into labs has 4 windows but thousands of tiles, and the 132
//     SMs need hundreds of blocks.  The block accumulates its window's
//     [128, D] partial in shared memory (64 KB at D = 128) and flushes it to
//     the zero-initialised output with global f32 atomicAdd when the window
//     changes and at the end.  The summation order therefore changes from run
//     to run; callers compare within a tolerance.
//   * A warp walks 64 consecutive slots; each lane owns 4 columns (one
//     16-byte load per row).  Runs of equal `local` are summed in registers
//     and merged into shared memory with one atomicAdd per run, which is
//     exact for any slot order: K1/K2f slots are dst-sorted within a tile,
//     K3 slots are sorted by source and are not.
//   * Four rows are loaded before they are summed, so each lane has four
//     loads in flight (eight spilled registers and ran 4-11 % slower).
//   * K2f reads its small table (at most 2048 rows) from global memory with
//     read-only loads: at D = 128 a 500-row table is 256 KB, more than the
//     227 KB of shared memory a block may use, and it stays resident in the
//     50 MB L2.
//   * K3 stages the tile's span block into dynamic shared memory (room for
//     span_rows rows: 128 KB at 256 x 128) with 16-byte cp.async copies, then
//     gathers from it.  Only the rows up to the tile's largest real source
//     are copied (a block max over its slots first), and never rows past the
//     table's end; a real slot whose source falls outside the span (never,
//     for a plan from build_src_span_plan) reads global memory.  Padding
//     slots are tested (local < 128) before any index is used.  Shared
//     memory: 64 KB accumulator + 128 KB block + 8 KB sorted slots.

#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 128;
constexpr int TILE_E = 1024;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS_PER_WARP = TILE_E / WARPS;  // 64
constexpr int BATCH = 4;  // rows loaded before they are summed
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void add_into(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void atomic_add4(float* p, const float4& v) {
  atomicAdd(p + 0, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
}

// Pre-gathered rows: row(e) = g[e].
struct GatheredRows {
  const float* __restrict__ g;
  int d;
  __device__ __forceinline__ float4 load(long long slot, int /*src*/, int c) const {
    return *reinterpret_cast<const float4*>(g + slot * d + c);
  }
};

// Table rows: row(e) = table[src[e]].
struct TableRows {
  const float* __restrict__ table;
  int d;
  __device__ __forceinline__ float4 load(long long /*slot*/, int src, int c) const {
    return __ldg(reinterpret_cast<const float4*>(table + (long long)src * d + c));
  }
};

// Span rows: row(e) = block[src[e] - base], the tile's staged span.
struct SpanRows {
  const float* block;
  const float* __restrict__ table;
  int base;
  int span_rows;
  int d;
  __device__ __forceinline__ float4 load(long long /*slot*/, int src, int c) const {
    const int rel = src - base;
    if (static_cast<unsigned>(rel) < static_cast<unsigned>(span_rows)) {
      return *reinterpret_cast<const float4*>(block + rel * d + c);
    }
    return __ldg(reinterpret_cast<const float4*>(table + (long long)src * d + c));
  }
};

// Add tile `tile`'s real slots into the shared [WINDOW, d] accumulator.
template <class Rows>
__device__ void accumulate_tile(const Rows& rows, const int* __restrict__ src,
                                const int* __restrict__ local, long long tile, int d,
                                float* acc) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long first = tile * TILE_E + (long long)warp * SLOTS_PER_WARP;
  for (int cbase = 0; cbase < d; cbase += 128) {
    const int c = cbase + lane * 4;
    const bool active = c < d;  // every lane still joins the shuffles
    float4 run = zero4();
    int cur = WINDOW;  // local row of the open run; WINDOW = none
    for (int j = 0; j < SLOTS_PER_WARP; j += 32) {
      const int my_local = local[first + j + lane];
      const int my_src = src != nullptr ? src[first + j + lane] : 0;
      for (int s0 = 0; s0 < 32; s0 += BATCH) {
        int ls[BATCH];
        float4 v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          ls[u] = __shfl_sync(FULL, my_local, s0 + u);
          const int sr = __shfl_sync(FULL, my_src, s0 + u);
          v[u] = (active && ls[u] < WINDOW) ? rows.load(first + j + s0 + u, sr, c) : zero4();
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (ls[u] != cur) {  // warp-uniform: ls[u] came from one lane
            if (active && cur < WINDOW) atomic_add4(acc + cur * d + c, run);
            run = zero4();
            cur = ls[u];
          }
          add_into(run, v[u]);
        }
      }
    }
    if (active && cur < WINDOW) atomic_add4(acc + cur * d + c, run);
  }
}

__device__ void zero_acc(float* acc, int d) {
  for (int i = threadIdx.x; i < WINDOW * d; i += THREADS) acc[i] = 0.f;
}

// Add the accumulator into window `window` of `out`, and zero it.
__device__ void flush_window(float* acc, float* __restrict__ out, int window, int d) {
  float* dst = out + (long long)window * WINDOW * d;
  for (int i = threadIdx.x; i < WINDOW * d; i += THREADS) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(dst + i, v);
    acc[i] = 0.f;
  }
}

template <class Rows>
__global__ void __launch_bounds__(THREADS)
windowed_sum_kernel(Rows rows, const int* __restrict__ src, const int* __restrict__ local,
                    const int* __restrict__ tile_map, int num_tiles, int tiles_per_block,
                    int d, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, d);
  __syncthreads();
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      flush_window(acc, out, window, d);
      __syncthreads();
      window = w;
    }
    accumulate_tile(rows, src, local, t, d, acc);
    __syncthreads();
  }
  flush_window(acc, out, window, d);
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its completion.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows of tile t's span block that its real slots read: 1 + the largest
// in-span offset (0 for an all-padding tile).  Ends with a barrier.
__device__ int span_rows_needed(const int* __restrict__ span_src, const int* __restrict__ span_local,
                                long long t, int base, int span_rows, int* shared_max) {
  if (threadIdx.x == 0) *shared_max = 0;
  __syncthreads();
  int need = 0;
  for (int i = threadIdx.x; i < TILE_E; i += THREADS) {
    const long long e = t * TILE_E + i;
    if (span_local[e] < WINDOW) {
      const int rel = span_src[e] - base;
      if (rel >= 0 && rel < span_rows) need = max(need, rel + 1);
    }
  }
  need = __reduce_max_sync(FULL, need);
  if (threadIdx.x % 32 == 0 && need > 0) atomicMax(shared_max, need);
  __syncthreads();
  return *shared_max;
}

// Counting sort of tile t's slots by local row into shared arrays (pad slots,
// local == WINDOW, sort last), so that accumulate_tile sees runs of equal
// rows and merges each run into the accumulator once, as for dst-sorted
// tiles.  `count` holds WINDOW + 1 ints.  Ends with a barrier.
__device__ void sort_tile_by_local(const int* __restrict__ src, const int* __restrict__ local,
                                   long long t, int* count, int* sorted_src, int* sorted_local) {
  for (int i = threadIdx.x; i <= WINDOW; i += THREADS) count[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_E; i += THREADS) atomicAdd(&count[local[t * TILE_E + i]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan of the WINDOW + 1 counts, one warp
    const int lane = threadIdx.x;
    constexpr int PER_LANE = (WINDOW + 1 + 31) / 32;  // 5
    int v[PER_LANE];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = lane * PER_LANE + k;
      v[k] = i <= WINDOW ? count[i] : 0;
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
      if (i <= WINDOW) count[i] = run;
      run += v[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_E; i += THREADS) {
    const int l = local[t * TILE_E + i];
    const int pos = atomicAdd(&count[l], 1);
    sorted_local[pos] = l;
    sorted_src[pos] = src[t * TILE_E + i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
span_sum_kernel(const float* __restrict__ table, int num_rows, const int* __restrict__ span_src,
                const int* __restrict__ span_local, const int* __restrict__ tile_map,
                const int* __restrict__ span_base, int num_tiles, int tiles_per_block,
                int span_rows, int d, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ int rows_needed;
  __shared__ int count[WINDOW + 1];
  __shared__ int sorted_src[TILE_E];
  __shared__ int sorted_local[TILE_E];
  float* acc = reinterpret_cast<float*>(smem4);
  float* block = acc + WINDOW * d;  // [span_rows, d]
  zero_acc(acc, d);
  __syncthreads();
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = tile_map[t0];
  for (int t = t0; t < t1; ++t) {
    const int w = tile_map[t];
    if (w != window) {
      flush_window(acc, out, window, d);
      __syncthreads();
      window = w;
    }
    // stage only the rows the tile reads, never past the table's end
    const int base = span_base[t];
    const int need = span_rows_needed(span_src, span_local, t, base, span_rows, &rows_needed);
    const int rows = max(0, min(need, num_rows - base));
    const float4* from = reinterpret_cast<const float4*>(table + (long long)base * d);
    float4* to = reinterpret_cast<float4*>(block);
    for (int i = threadIdx.x; i < rows * d / 4; i += THREADS) cp_async16(to + i, from + i);
    sort_tile_by_local(span_src, span_local, t, count, sorted_src, sorted_local);
    cp_async_wait_all();
    __syncthreads();
    accumulate_tile(SpanRows{block, table, base, span_rows, d}, sorted_src, sorted_local, 0, d,
                    acc);
    __syncthreads();  // the next tile overwrites the block and the sorted slots
  }
  flush_window(acc, out, window, d);
}

// K2b, the transpose of K2f: dT[src[e], :] += g[tile_map[t] * 128 + local[e], :]
// over the real slots e of every tile t, into a small table dT [num_src, d].
//
// What bounds it on the H100: bytes.  One add per gathered element, against
// reading the E slots' indices and the [num_dst, d] gradient once.  The TPU
// kept the whole dT resident in VMEM; here a 512 x 128 f32 dT is 256 KB, more
// than the 227 KB of shared memory a block may use.  So each block owns one
// slice of `cols` columns (blockIdx.y) of the whole table, sized by the
// wrapper to fit (32 columns of a 500-row table: 66 KB with the +1 row pad
// that spreads rows over banks), and a group of consecutive tiles
// (blockIdx.x).  Slots are dst-sorted within a window, so runs of equal src
// are short and there is nothing to merge in registers: every slot adds
// its row slice into the shared table with shared-memory atomics (cols/4
// lanes per slot, 4 columns each, four rows loaded before they are added).
// The block flushes its non-zero entries to the zeroed dT with global f32
// atomics once, at the end; the summation order changes from run to run.
__global__ void __launch_bounds__(THREADS)
fused_table_bwd_kernel(const float* __restrict__ g, const int* __restrict__ src,
                       const int* __restrict__ local, const int* __restrict__ tile_map,
                       int num_tiles, int tiles_per_block, int num_src, int d, int cols,
                       float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [num_src, cols + 1]
  const int stride = cols + 1;
  for (int i = threadIdx.x; i < num_src * stride; i += THREADS) acc[i] = 0.f;
  __syncthreads();
  const int c0 = blockIdx.y * cols;
  const int lanes_per_slot = cols / 4;
  const int slots_per_pass = THREADS / lanes_per_slot;
  const int sub = threadIdx.x / lanes_per_slot;
  const int c = (threadIdx.x % lanes_per_slot) * 4;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  for (int t = t0; t < t1; ++t) {
    const long long row0 = (long long)tile_map[t] * WINDOW;
    for (int i0 = sub; i0 < TILE_E; i0 += BATCH * slots_per_pass) {
      int ss[BATCH];
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * slots_per_pass;
        ss[u] = -1;
        v[u] = zero4();
        if (i < TILE_E) {
          const long long e = (long long)t * TILE_E + i;
          const int l = local[e];
          if (l < WINDOW) {
            ss[u] = src[e];
            v[u] = __ldg(reinterpret_cast<const float4*>(g + (row0 + l) * d + c0 + c));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (ss[u] < 0) continue;
        float* a = acc + ss[u] * stride + c;
        atomicAdd(a + 0, v[u].x);
        atomicAdd(a + 1, v[u].y);
        atomicAdd(a + 2, v[u].z);
        atomicAdd(a + 3, v[u].w);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_src * cols; i += THREADS) {
    const int r = i / cols, cc = i % cols;
    const float v = acc[r * stride + cc];
    if (v != 0.f) atomicAdd(out + (long long)r * d + c0 + cc, v);
  }
}

template <class Rows>
int launch_windowed(Rows rows, const int* src, const int* local, const int* tile_map,
                    int num_tiles, int tiles_per_block, int d, float* out, void* stream) {
  const size_t smem = sizeof(float) * WINDOW * d;
  cudaError_t err = cudaFuncSetAttribute(windowed_sum_kernel<Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_tiles + tiles_per_block - 1) / tiles_per_block;
  windowed_sum_kernel<Rows><<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, src, local, tile_map, num_tiles, tiles_per_block, d, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  idx == nullptr: x holds pre-gathered rows [num_tiles * 1024, d];
// otherwise row(e) = x[idx[e]].
int mmgnn_segment_sum_windowed(const float* x, const int* idx, const int* local,
                               const int* tile_map, int num_tiles, int tiles_per_block, int d,
                               float* out, void* stream) {
  if (idx == nullptr) {
    return launch_windowed(GatheredRows{x, d}, nullptr, local, tile_map, num_tiles,
                           tiles_per_block, d, out, stream);
  }
  return launch_windowed(TableRows{x, d}, idx, local, tile_map, num_tiles, tiles_per_block, d,
                         out, stream);
}

// K2f.  row(e) = table[win_src[e]] for a small source table.
int mmgnn_fused_table_segment_sum(const float* table, const int* win_src, const int* local,
                                  const int* tile_map, int num_tiles, int tiles_per_block,
                                  int d, float* out, void* stream) {
  return launch_windowed(TableRows{table, d}, win_src, local, tile_map, num_tiles,
                         tiles_per_block, d, out, stream);
}

// K2b.  dT[win_src[e]] += g[tile_map[t] * 128 + local[e]]; g holds the
// destination rows [num_dst, d], dT [num_src, d] is zeroed by the caller.
int mmgnn_fused_table_segment_sum_bwd(const float* g, const int* win_src, const int* local,
                                      const int* tile_map, int num_tiles, int tiles_per_block,
                                      int num_src, int d, int cols, float* out, void* stream) {
  const size_t smem = sizeof(float) * (size_t)num_src * (cols + 1);
  cudaError_t err = cudaFuncSetAttribute(fused_table_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_tiles + tiles_per_block - 1) / tiles_per_block, d / cols);
  fused_table_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      g, win_src, local, tile_map, num_tiles, tiles_per_block, num_src, d, cols, out);
  return cudaGetLastError();
}

// K3.  row(e) = table[span_src[e]], read from the tile's staged block
// table[span_base[t] : span_base[t] + span_rows] (bounded by num_rows).
int mmgnn_span_segment_sum(const float* table, int num_rows, const int* span_src,
                           const int* span_local, const int* tile_map, const int* span_base,
                           int num_tiles, int tiles_per_block, int span_rows, int d, float* out,
                           void* stream) {
  const size_t smem = sizeof(float) * (WINDOW + (size_t)span_rows) * d;
  cudaError_t err = cudaFuncSetAttribute(span_sum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_tiles + tiles_per_block - 1) / tiles_per_block;
  span_sum_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      table, num_rows, span_src, span_local, tile_map, span_base, num_tiles, tiles_per_block,
      span_rows, d, out);
  return cudaGetLastError();
}

}  // extern "C"
