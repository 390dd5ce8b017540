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
//
// bfloat16 tables (the script's --dtype bfloat16), float32 row sums:
//   A  mmgnn_gather_indicator_bf16: the one-hot product on the bf16 tensor
//      cores, mma.sync m16n8k16 with f32 accumulation (the one-hot is exact
//      in bf16, each product row is the slot's row in f32: the MXU product
//      the probe times).  Bound by operations, 2 * 1024 * rows * h per tile
//      at 989 TFLOP/s.  Persistent blocks of 16 warps, one an SM; the whole
//      table is staged once per block in shared memory, transposed so that
//      a B fragment (two rows of one column) is one 32-bit word, columns
//      padded to 4 words mod 32 (a warp's fragment loads hit 32 banks).
//      Each warp takes 64 slots of a 1024-slot tile (four m16 tiles) and
//      builds their one-hot A fragments in registers from the indices; 32
//      columns (four n8 tiles) a pass, each slot's partial row sums kept in
//      registers and reduced over the quad at the end.
//   B, C  mmgnn_gather_direct_bf16: the f32 kernel's body on 2-byte rows
//      (8-byte loads of four values, widened to f32 and summed).

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

// Four table elements as one load, and their float32 sum.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using V = float4;
  static __device__ __forceinline__ float sum(V v) { return (v.x + v.y) + (v.z + v.w); }
};

template <>
struct Quad<uint16_t> {  // bfloat16 bit patterns
  using V = uint2;
  static __device__ __forceinline__ float sum(V v) {
    const float a = __uint_as_float(v.x << 16), b = __uint_as_float(v.x & 0xffff0000u);
    const float c = __uint_as_float(v.y << 16), d = __uint_as_float(v.y & 0xffff0000u);
    return (a + b) + (c + d);
  }
};

template <typename T>
__global__ void __launch_bounds__(DIRECT_THREADS)
gather_direct_kernel(const int* __restrict__ idx, const T* __restrict__ table, int rows,
                     int width, int h, int num_tiles, int staged, float* __restrict__ out) {
  using V = typename Quad<T>::V;
  extern __shared__ float4 smem4[];  // [rows, width + STAGE_PAD] elements when staged
  V* staged4 = reinterpret_cast<V*>(smem4);
  const int stride = width + STAGE_PAD;
  if (staged) {
    const int w4 = width / 4, s4 = stride / 4;
    for (int i = threadIdx.x; i < rows * w4; i += DIRECT_THREADS) {
      staged4[(i / w4) * s4 + i % w4] = __ldg(reinterpret_cast<const V*>(table) + i);
    }
    __syncthreads();
  }
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long e = (long long)t * TILE_E + threadIdx.x;
    const int r = idx[e];
    float sum = 0.f;
    if (r >= 0 && r < rows) {
      const V* row = staged ? staged4 + (long long)r * (stride / 4)
                            : reinterpret_cast<const V*>(table + (long long)r * width);
      for (int q = 0; q < h / 4; ++q) {
        const V v = staged ? row[q] : __ldg(row + q);
        sum += Quad<T>::sum(v);
      }
    }
    out[e] = sum;
  }
}

// -- A in bfloat16 on the tensor cores ------------------------------------------

constexpr int IND16_WARPS = 16;
constexpr int IND16_THREADS = 32 * IND16_WARPS;
constexpr int IND16_WARP_SLOTS = TILE_E / IND16_WARPS;  // 64
constexpr int IND16_MT = IND16_WARP_SLOTS / 16;         // m16 tiles a warp
constexpr int IND16_NT = 4;                             // n8 tiles a pass

// 32-bit words a staged column takes: two rows a word, rows padded to a
// multiple of 16, then to 4 words mod 32
__host__ __device__ inline int ind16_words(int rows) {
  const int w = (rows + 15) / 16 * 8;
  return w + (36 - w % 32) % 32;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two neighbouring one-hot entries of a slot whose row lies d past the
// pair's first column: bf16 1.0 (0x3F80) in the low half for d == 0, in the
// high half for d == 1.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return d == 0 ? 0x3F80u : (d == 1 ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(IND16_THREADS, 1)
gather_indicator_bf16_kernel(const int* __restrict__ idx, const uint16_t* __restrict__ table,
                             int rows, int h, int num_tiles, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem4);  // [h][words]: column c, rows 2k, 2k + 1
  uint16_t* cols16 = reinterpret_cast<uint16_t*>(smem4);
  const int words = ind16_words(rows);
  const int rows16 = (rows + 15) / 16 * 16;
  for (int i = threadIdx.x; i < h * words; i += IND16_THREADS) cols[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * h; i += IND16_THREADS) {
    cols16[(long long)(i % h) * 2 * words + i / h] = table[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // the fragments' row group and pair
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long base = (long long)t * TILE_E + warp * IND16_WARP_SLOTS;
    int lo[IND16_MT], hi[IND16_MT];  // rows g and g + 8 of each m16 tile, less 2q
    float sum_lo[IND16_MT], sum_hi[IND16_MT];
#pragma unroll
    for (int m = 0; m < IND16_MT; ++m) {
      lo[m] = idx[base + 16 * m + g] - 2 * q;
      hi[m] = idx[base + 16 * m + g + 8] - 2 * q;
      sum_lo[m] = sum_hi[m] = 0.f;
    }
    for (int c0 = 0; c0 < h; c0 += 8 * IND16_NT) {
      float acc[IND16_MT][IND16_NT][4];
#pragma unroll
      for (int m = 0; m < IND16_MT; ++m)
#pragma unroll
        for (int j = 0; j < IND16_NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
      for (int r0 = 0; r0 < rows16; r0 += 16) {
        uint32_t b[IND16_NT][2];
#pragma unroll
        for (int j = 0; j < IND16_NT; ++j) {
          if (c0 + 8 * j < h) {
            const uint32_t* col = cols + (long long)(c0 + 8 * j + g) * words + r0 / 2 + q;
            b[j][0] = col[0];
            b[j][1] = col[4];
          }
        }
#pragma unroll
        for (int m = 0; m < IND16_MT; ++m) {
          const uint32_t a0 = onehot_pair(lo[m] - r0), a1 = onehot_pair(hi[m] - r0);
          const uint32_t a2 = onehot_pair(lo[m] - r0 - 8), a3 = onehot_pair(hi[m] - r0 - 8);
#pragma unroll
          for (int j = 0; j < IND16_NT; ++j) {
            if (c0 + 8 * j < h) mma_bf16(acc[m][j], a0, a1, a2, a3, b[j][0], b[j][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < IND16_MT; ++m)
#pragma unroll
        for (int j = 0; j < IND16_NT; ++j) {
          sum_lo[m] += acc[m][j][0] + acc[m][j][1];
          sum_hi[m] += acc[m][j][2] + acc[m][j][3];
        }
    }
#pragma unroll
    for (int m = 0; m < IND16_MT; ++m) {
#pragma unroll
      for (int s = 1; s < 4; s *= 2) {
        sum_lo[m] += __shfl_xor_sync(0xffffffffu, sum_lo[m], s);
        sum_hi[m] += __shfl_xor_sync(0xffffffffu, sum_hi[m], s);
      }
      if (q == 0) {
        out[base + 16 * m + g] = sum_lo[m];
        out[base + 16 * m + g + 8] = sum_hi[m];
      }
    }
  }
}

template <typename T>
int launch_direct(const int* idx, const T* table, int rows, int width, int h, int num_tiles,
                  int blocks, int staged, float* out, void* stream) {
  const int smem = staged ? (int)(sizeof(T) * (size_t)rows * (width + STAGE_PAD)) : 0;
  cudaError_t err = cudaFuncSetAttribute(gather_direct_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_direct_kernel<T><<<blocks, DIRECT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, table, rows, width, h, num_tiles, staged, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory gather_direct_kernel needs to stage a [rows, width] table.
int mmgnn_gather_direct_staged_bytes(int rows, int width) {
  return (int)(sizeof(float) * (size_t)rows * (width + STAGE_PAD));
}

int mmgnn_gather_direct_staged_bytes_bf16(int rows, int width) {
  return (int)(sizeof(uint16_t) * (size_t)rows * (width + STAGE_PAD));
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

// Shared memory gather_indicator_bf16_kernel needs for a [rows, h] table.
int mmgnn_gather_indicator_bf16_shared_bytes(int rows, int h) {
  return (int)(sizeof(uint32_t) * (size_t)h * ind16_words(rows));
}

// A in bfloat16.  table: [rows, h] bf16 bit patterns; out [num_tiles * 1024]
// f32; h a multiple of 8; blocks persistent (at most one an SM).
int mmgnn_gather_indicator_bf16(const int* idx, const uint16_t* table, int rows, int h,
                                int num_tiles, int blocks, float* out, void* stream) {
  const int smem = mmgnn_gather_indicator_bf16_shared_bytes(rows, h);
  cudaError_t err = cudaFuncSetAttribute(gather_indicator_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_indicator_bf16_kernel<<<blocks, IND16_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, table, rows, h, num_tiles, out);
  return cudaGetLastError();
}

// B / C.  out [num_tiles * 1024]; width and h multiples of 4, h <= width.
int mmgnn_gather_direct(const int* idx, const float* table, int rows, int width, int h,
                        int num_tiles, int blocks, int staged, float* out, void* stream) {
  return launch_direct(idx, table, rows, width, h, num_tiles, blocks, staged, out, stream);
}

int mmgnn_gather_direct_bf16(const int* idx, const uint16_t* table, int rows, int width, int h,
                             int num_tiles, int blocks, int staged, float* out, void* stream) {
  return launch_direct(idx, table, rows, width, h, num_tiles, blocks, staged, out, stream);
}

}  // extern "C"
