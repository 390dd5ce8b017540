// P1, the in-kernel row-gather probe, hand-written for Hopper (sm_90a).
// Built by ops/_build.py into the port's one shared library with a plain C
// interface and called through ctypes from ops/gather_probe.py.
//
// Replaces the Pallas TPU kernels that scripts/bench_gather_impl.py builds
// (build, its pallas_call): for each slot e of [num_tiles * 1024],
//   out[e] = sum_{c < h} table[idx[e], c]
// with an index outside [0, rows) reading a zero row.  Two ways, as the
// script's variants:
//   A  mmgnn_gather_indicator  (_kernel_indicator): each 1024-slot tile's
//      one-hot [1024, rows] matrix times the [rows, h] table, as a matrix
//      product in float32 FMAs, then each product row summed.
//   B, C  mmgnn_gather_direct  (_kernel_dyngather): each slot reads its row
//      by index.  B takes a 128-wide zero-padded table, C the table at its
//      own width; on Hopper both are one mechanism (there is no 128-lane
//      rule), kept apart for the script's two lines.
//
// What bounds them on the H100:
//   * A: operations, 2 * 1024 * rows * h per tile (the one-hot product does
//     rows times the useful work).  A block per tile, 256 threads, each
//     owning four slots; the table passes through shared memory in 64-row
//     chunks (16 KB at h = 64); per chunk, per 16 columns, a thread keeps a
//     [4 slots, 16 columns] accumulator in registers and reads each table row
//     as four float4 broadcasts (every lane the same address).  No tensor
//     cores: TF32 would keep ~3 digits; mma.sync is later work.
//   * B / C: bytes, 4 of index and 4 of output per slot.  Persistent blocks
//     of 1024 threads (one slot each) walk the tiles.  A table that fits
//     (rows x (width + 4) floats, 139 KB at [512, 64]) is staged in shared
//     memory once per block, rows padded by 4 floats so that a quarter-warp's
//     float4 reads of random rows spread over the banks; a larger one
//     ([512, 128] = 256 KB) is read through L1 / L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_E = 1024;
constexpr int IND_THREADS = 256;
constexpr int IND_SLOTS = TILE_E / IND_THREADS;  // slots per thread
constexpr int IND_CHUNK_ROWS = 64;
constexpr int IND_COLS = 16;  // accumulator columns per pass
constexpr int DIRECT_THREADS = TILE_E;
constexpr int STAGE_PAD = 4;

__global__ void __launch_bounds__(IND_THREADS)
gather_indicator_kernel(const int* __restrict__ idx, const float* __restrict__ table, int rows,
                        int h, float* __restrict__ out) {
  extern __shared__ float4 chunk4[];  // [IND_CHUNK_ROWS, h]
  const float* chunk = reinterpret_cast<const float*>(chunk4);
  const long long base = (long long)blockIdx.x * TILE_E;
  int my[IND_SLOTS];
  float sum[IND_SLOTS];
#pragma unroll
  for (int k = 0; k < IND_SLOTS; ++k) {
    my[k] = idx[base + threadIdx.x + k * IND_THREADS];
    sum[k] = 0.f;
  }
  const int h4 = h / 4;
  for (int r0 = 0; r0 < rows; r0 += IND_CHUNK_ROWS) {
    const int n = min(IND_CHUNK_ROWS, rows - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * h4; i += IND_THREADS) {
      chunk4[i] = __ldg(reinterpret_cast<const float4*>(table + (long long)r0 * h) + i);
    }
    __syncthreads();
    for (int c0 = 0; c0 < h; c0 += IND_COLS) {
      float acc[IND_SLOTS][IND_COLS];
#pragma unroll
      for (int k = 0; k < IND_SLOTS; ++k) {
#pragma unroll
        for (int j = 0; j < IND_COLS; ++j) acc[k][j] = 0.f;
      }
      for (int r = 0; r < n; ++r) {
        float p[IND_SLOTS];  // this row's column of the one-hot matrix
#pragma unroll
        for (int k = 0; k < IND_SLOTS; ++k) p[k] = my[k] == r0 + r ? 1.f : 0.f;
        const float4* row = reinterpret_cast<const float4*>(chunk + r * h + c0);
#pragma unroll
        for (int q = 0; q < IND_COLS / 4; ++q) {
          const float4 t = row[q];
#pragma unroll
          for (int k = 0; k < IND_SLOTS; ++k) {
            acc[k][4 * q + 0] = fmaf(p[k], t.x, acc[k][4 * q + 0]);
            acc[k][4 * q + 1] = fmaf(p[k], t.y, acc[k][4 * q + 1]);
            acc[k][4 * q + 2] = fmaf(p[k], t.z, acc[k][4 * q + 2]);
            acc[k][4 * q + 3] = fmaf(p[k], t.w, acc[k][4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < IND_SLOTS; ++k) {
#pragma unroll
        for (int j = 0; j < IND_COLS; ++j) sum[k] += acc[k][j];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < IND_SLOTS; ++k) out[base + threadIdx.x + k * IND_THREADS] = sum[k];
}

__global__ void __launch_bounds__(DIRECT_THREADS)
gather_direct_kernel(const int* __restrict__ idx, const float* __restrict__ table, int rows,
                     int width, int h, int num_tiles, int staged, float* __restrict__ out) {
  extern __shared__ float4 staged4[];  // [rows, width + STAGE_PAD] when staged
  const int stride = width + STAGE_PAD;
  if (staged) {
    const int w4 = width / 4, s4 = stride / 4;
    for (int i = threadIdx.x; i < rows * w4; i += DIRECT_THREADS) {
      staged4[(i / w4) * s4 + i % w4] = __ldg(reinterpret_cast<const float4*>(table) + i);
    }
    __syncthreads();
  }
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long e = (long long)t * TILE_E + threadIdx.x;
    const int r = idx[e];
    float sum = 0.f;
    if (r >= 0 && r < rows) {
      const float4* row = staged ? staged4 + (long long)r * (stride / 4)
                                 : reinterpret_cast<const float4*>(table + (long long)r * width);
      for (int q = 0; q < h / 4; ++q) {
        const float4 v = staged ? row[q] : __ldg(row + q);
        sum += (v.x + v.y) + (v.z + v.w);
      }
    }
    out[e] = sum;
  }
}

}  // namespace

extern "C" {

// Shared memory gather_direct_kernel needs to stage a [rows, width] table.
int mmgnn_gather_direct_staged_bytes(int rows, int width) {
  return (int)(sizeof(float) * (size_t)rows * (width + STAGE_PAD));
}

// A.  out [num_tiles * 1024]; h a multiple of 16.
int mmgnn_gather_indicator(const int* idx, const float* table, int rows, int h, int num_tiles,
                           float* out, void* stream) {
  const int smem = (int)(sizeof(float) * IND_CHUNK_ROWS * h);
  cudaError_t err = cudaFuncSetAttribute(gather_indicator_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_indicator_kernel<<<num_tiles, IND_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, table, rows, h, out);
  return cudaGetLastError();
}

// B / C.  out [num_tiles * 1024]; width and h multiples of 4, h <= width.
int mmgnn_gather_direct(const int* idx, const float* table, int rows, int width, int h,
                        int num_tiles, int blocks, int staged, float* out, void* stream) {
  const int smem = staged ? mmgnn_gather_direct_staged_bytes(rows, width) : 0;
  cudaError_t err = cudaFuncSetAttribute(gather_direct_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_direct_kernel<<<blocks, DIRECT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, table, rows, width, h, num_tiles, staged, out);
  return cudaGetLastError();
}

}  // extern "C"
