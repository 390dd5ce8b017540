// The fused pair head, hand-written for Hopper (sm_90a).  Built by
// ops/_build.py into the port's one shared library with a plain C interface
// and called through ctypes from ops/pairhead_kernels.py.
//
// Replaces the two Pallas TPU kernels of multi_modal_gnn_tpu/ops/pallas_pairhead.py:
//   K4f _fused_fwd / _fwd_kernel -> mmgnn_pair_head_fwd
//   K4b _fused_bwd / _bwd_kernel -> mmgnn_pair_head_bwd
//
// For every slot e of tile t of a slot-major batch (training/masker.py):
//   p = tile_map[t] * 128 + local[e]          (local == 128: padding slot)
//   h0 = drop0(relu(Pp[p] + Pl[lab[e]]))       [64]
//   h1 = drop1(relu(h0 @ W1 + b1))             [32]
//   out[e] = h1 . w2 + b2
// Padding slots output 0.  Tiles with tile_mask[t] == 0 output 0 and add no
// gradient (the degree gate discards that head's value for all their slots).
// With lab_rows > 0 (span-bounded lab tiles) a lab outside the tile's slice
// [base, base + lab_rows) reads a zero row, as the TPU kernel's one-hot
// gather over the slice does; lab rows >= num_labs are zero too.  Patient
// rows >= num_p read zero (the TPU pads the table to whole windows), and
// rows past the window block are never read.
//
// Dropout: a counter-based generator, the same function as dropout_bits in
// ops/pairhead_kernels.py, so the plain version draws the same masks:
//   key(e)        = fmix32(seed0 ^ fmix32(e ^ fmix32(seed1)))
//   bits(e, L, c) = fmix32(key(e) ^ (64 L + c + 1) * 0x9E3779B9)
// (murmur3's finalizer; e the global slot, L the layer, c the column), kept
// when bits >= threshold compared UNSIGNED, threshold = rate * 2^32, and
// scaled by 1 / (1 - rate).  The backward recomputes the bits; no mask is
// stored.  The TPU drew pltpu.prng_random_bits, which cannot be reproduced.
//
// What bounds them on the H100: operations.  64 x 32 FMAs per slot forward
// (h0 @ W1), three times that backward (recomputed h0 @ W1, dpre1 @ W1^T and
// the dW1 outer products), in float32 (TF32 would keep ~3 digits) against
// the ~0.5 KB of Pp/Pl rows a slot reads, mostly from L2.
//   * K4f: one thread per slot.  h0 and the 32 accumulators live in
//     registers; W1 sits in shared memory and is read as float4 broadcasts
//     (every lane reads the same address).
//   * K4b: a warp handles 32 slots at a time, first one slot per lane
//     (recompute, dpre1, dpre0), then one column per lane for the
//     reductions over slots, through per-warp shared staging rows (padded to
//     65 / 33 floats so both access patterns are free of bank conflicts):
//     dW1 and db1 / dw2 accumulate in registers of the lane owning the
//     column; dPp accumulates in a shared [128, 64] window block flushed
//     with global atomics when the window changes; dPl accumulates in a
//     shared [num_labs, 64] table (128 KB at 500 labs) flushed once per
//     block.  Four warps per block, one block per SM (~215 KB of shared
//     memory at 500 labs); the shared-memory budget, not the registers,
//     sets that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 128;
constexpr int TILE_E = 1024;
constexpr int H0 = 64;
constexpr int H1 = 32;
constexpr int FWD_THREADS = 256;
constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int STAGE_A = H0 + 1;  // staging row strides: bank-conflict-free
constexpr int STAGE_B = H1 + 1;  // both as rows and as columns
constexpr unsigned FULL = 0xffffffffu;

struct Head {
  const float* __restrict__ pp;  // [num_p, 64]
  const float* __restrict__ pl;  // [num_l, 64]
  const float* __restrict__ w1;  // [64, 32]
  const float* __restrict__ b1;  // [32]
  const float* __restrict__ w2;  // [32]
  const float* __restrict__ b2;  // [1]
  const int* __restrict__ lab;        // [E]
  const int* __restrict__ local;      // [E]
  const int* __restrict__ tile_map;   // [T]
  const int* __restrict__ tile_mask;  // [T] or null
  const int* __restrict__ lab_base;   // [T] or null
  int num_p, num_l, lab_rows, lab_base_max;
  uint32_t seed0, seed1, threshold;
  float scale;
  int dropout;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t slot_key(const Head& a, uint32_t e) {
  return fmix32(a.seed0 ^ fmix32(e ^ fmix32(a.seed1)));
}

__device__ __forceinline__ bool keep(const Head& a, uint32_t key, int layer, int c) {
  return fmix32(key ^ ((uint32_t)(layer * 64 + c + 1) * 0x9E3779B9u)) >= a.threshold;
}

__device__ __forceinline__ bool tile_on(const Head& a, int t) {
  return a.tile_mask == nullptr || a.tile_mask[t] != 0;
}

// Row of Pl that slot e of tile t reads, or -1 for a zero row.
__device__ __forceinline__ int lab_row(const Head& a, int t, int l) {
  if (l < 0 || l >= a.num_l) return -1;
  if (a.lab_rows > 0) {
    const int base = min(max(a.lab_base[t], 0), a.lab_base_max);
    if (l - base < 0 || l - base >= a.lab_rows) return -1;
  }
  return l;
}

// pre0 = Pp[p] + Pl[lr] with zero rows for p >= num_p or lr < 0.
__device__ __forceinline__ void load_pre0(const Head& a, int p, int lr, float* pre0) {
  const float4* prow = reinterpret_cast<const float4*>(a.pp + (long long)p * H0);
  const float4* lrow = reinterpret_cast<const float4*>(a.pl + (long long)max(lr, 0) * H0);
  const bool pok = p < a.num_p, lok = lr >= 0;
#pragma unroll
  for (int q = 0; q < H0 / 4; ++q) {
    float4 x = pok ? __ldg(prow + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 y = lok ? __ldg(lrow + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    pre0[4 * q + 0] = x.x + y.x;
    pre0[4 * q + 1] = x.y + y.y;
    pre0[4 * q + 2] = x.z + y.z;
    pre0[4 * q + 3] = x.w + y.w;
  }
}

// acc[j] = b1[j] + sum_k h0[k] * W1[k][j], W1 from shared memory.
__device__ __forceinline__ void layer1(const float4* w1s, const float* b1s, const float* h0,
                                       float* acc) {
#pragma unroll
  for (int j = 0; j < H1; ++j) acc[j] = b1s[j];
#pragma unroll
  for (int k = 0; k < H0; ++k) {
    const float h = h0[k];
#pragma unroll
    for (int q = 0; q < H1 / 4; ++q) {
      const float4 w = w1s[k * (H1 / 4) + q];
      acc[4 * q + 0] = fmaf(h, w.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
    }
  }
}

__device__ void load_weights(const Head& a, float4* w1s, float* b1s, float* w2s, int nthreads) {
  for (int i = threadIdx.x; i < H0 * H1 / 4; i += nthreads) {
    w1s[i] = __ldg(reinterpret_cast<const float4*>(a.w1) + i);
  }
  if (threadIdx.x < H1) {
    b1s[threadIdx.x] = a.b1[threadIdx.x];
    w2s[threadIdx.x] = a.w2[threadIdx.x];
  }
}

__global__ void __launch_bounds__(FWD_THREADS)
pair_head_fwd_kernel(Head a, int num_tiles, float* __restrict__ out) {
  __shared__ float4 w1s[H0 * H1 / 4];
  __shared__ float b1s[H1], w2s[H1];
  load_weights(a, w1s, b1s, w2s, FWD_THREADS);
  __syncthreads();
  const long long e = (long long)blockIdx.x * FWD_THREADS + threadIdx.x;
  const int t = (int)(e / TILE_E);
  if (t >= num_tiles) return;
  const int loc = a.local[e];
  float result = 0.f;
  if (tile_on(a, t) && loc < WINDOW) {
    const int p = a.tile_map[t] * WINDOW + loc;
    float h0[H0];
    load_pre0(a, p, lab_row(a, t, a.lab[e]), h0);
    const uint32_t key = a.dropout ? slot_key(a, (uint32_t)e) : 0u;
#pragma unroll
    for (int k = 0; k < H0; ++k) {
      float h = fmaxf(h0[k], 0.f);
      if (a.dropout) h = keep(a, key, 0, k) ? h * a.scale : 0.f;
      h0[k] = h;
    }
    float acc[H1];
    layer1(w1s, b1s, h0, acc);
    result = a.b2[0];
#pragma unroll
    for (int j = 0; j < H1; ++j) {
      float h = fmaxf(acc[j], 0.f);
      if (a.dropout) h = keep(a, key, 1, j) ? h * a.scale : 0.f;
      result = fmaf(h, w2s[j], result);
    }
  }
  out[e] = result;
}

// Add the shared window block into rows [window * 128, +128) of dpp, and zero it.
__device__ void flush_dpp(float* dpp_s, float* __restrict__ dpp, int window) {
  float* dst = dpp + (long long)window * WINDOW * H0;
  for (int i = threadIdx.x; i < WINDOW * H0; i += BWD_THREADS) {
    const float v = dpp_s[i];
    if (v != 0.f) atomicAdd(dst + i, v);
    dpp_s[i] = 0.f;
  }
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
pair_head_bwd_kernel(Head a, const float* __restrict__ g_out, int num_tiles,
                     int tiles_per_block, float* __restrict__ dpp, float* __restrict__ dpl,
                     float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2,
                     float* __restrict__ db2) {
  extern __shared__ float4 smem4[];
  float4* w1s = smem4;                                               // [64 * 32]
  float* b1s = reinterpret_cast<float*>(w1s + H0 * H1 / 4);          // [32]
  float* w2s = b1s + H1;                                             // [32]
  float* dpp_s = w2s + H1;                                           // [128, 64]
  float* dpl_s = dpp_s + WINDOW * H0;                                // [num_l, 64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage_a = dpl_s + a.num_l * H0 + warp * (32 * STAGE_A + 32 * STAGE_B);
  float* stage_b = stage_a + 32 * STAGE_A;

  load_weights(a, w1s, b1s, w2s, BWD_THREADS);
  for (int i = threadIdx.x; i < WINDOW * H0; i += BWD_THREADS) dpp_s[i] = 0.f;
  for (int i = threadIdx.x; i < a.num_l * H0; i += BWD_THREADS) dpl_s[i] = 0.f;
  __syncthreads();

  float dw1_acc[H0];  // lane owns column j = lane of dW1
#pragma unroll
  for (int k = 0; k < H0; ++k) dw1_acc[k] = 0.f;
  float db1_acc = 0.f, dw2_acc = 0.f, db2_acc = 0.f;

  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, num_tiles);
  int window = t0 < t1 ? a.tile_map[t0] : 0;
  for (int t = t0; t < t1; ++t) {
    const int w = a.tile_map[t];
    if (w != window) {  // block-uniform
      __syncthreads();
      flush_dpp(dpp_s, dpp, window);
      __syncthreads();
      window = w;
    }
    if (!tile_on(a, t)) continue;  // block-uniform
    for (int chunk = warp; chunk < TILE_E / 32; chunk += BWD_WARPS) {
      // ---- one slot per lane: recompute the forward, then dpre1 ----
      const long long e = (long long)t * TILE_E + chunk * 32 + lane;
      const int loc = a.local[e];
      const bool valid = loc < WINDOW;
      const int lr = valid ? lab_row(a, t, a.lab[e]) : -1;
      const float go = valid ? g_out[e] : 0.f;
      db2_acc += go;
      const uint32_t key = a.dropout ? slot_key(a, (uint32_t)e) : 0u;
      uint32_t relu0[2] = {0u, 0u};
      float h0[H0];
      if (valid) {
        load_pre0(a, w * WINDOW + loc, lr, h0);
      } else {
#pragma unroll
        for (int k = 0; k < H0; ++k) h0[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < H0; ++k) {
        if (h0[k] > 0.f) relu0[k / 32] |= 1u << (k % 32);
        float h = fmaxf(h0[k], 0.f);
        if (a.dropout) h = keep(a, key, 0, k) ? h * a.scale : 0.f;
        h0[k] = h;
        stage_a[lane * STAGE_A + k] = h;  // h0 after dropout, for dW1
      }
      float acc[H1];
      layer1(w1s, b1s, h0, acc);
#pragma unroll
      for (int j = 0; j < H1; ++j) {
        const bool kept = !a.dropout || keep(a, key, 1, j);
        const float h1d = kept ? fmaxf(acc[j], 0.f) * (a.dropout ? a.scale : 1.f) : 0.f;
        stage_b[lane * STAGE_B + j] = go * h1d;  // dw2 terms
        const float dh1 = kept ? go * w2s[j] * (a.dropout ? a.scale : 1.f) : 0.f;
        acc[j] = acc[j] > 0.f ? dh1 : 0.f;  // dpre1
      }
      __syncwarp();
      // ---- one column per lane: dw2 ----
#pragma unroll 8
      for (int s = 0; s < 32; ++s) dw2_acc += stage_b[s * STAGE_B + lane];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < H1; ++j) stage_b[lane * STAGE_B + j] = acc[j];
      __syncwarp();
      // ---- one column per lane: db1, dW1[:, lane] += sum_s h0[s, :] dpre1[s, lane] ----
      for (int s = 0; s < 32; ++s) {
        const float d = stage_b[s * STAGE_B + lane];
        db1_acc += d;
#pragma unroll
        for (int k = 0; k < H0; ++k) dw1_acc[k] = fmaf(stage_a[s * STAGE_A + k], d, dw1_acc[k]);
      }
      __syncwarp();
      // ---- one slot per lane: dpre0 = relu0' * drop0'(dpre1 @ W1^T) ----
#pragma unroll
      for (int k = 0; k < H0; ++k) {
        float dh = 0.f;
#pragma unroll
        for (int q = 0; q < H1 / 4; ++q) {
          const float4 wv = w1s[k * (H1 / 4) + q];
          dh = fmaf(acc[4 * q + 0], wv.x, dh);
          dh = fmaf(acc[4 * q + 1], wv.y, dh);
          dh = fmaf(acc[4 * q + 2], wv.z, dh);
          dh = fmaf(acc[4 * q + 3], wv.w, dh);
        }
        if (a.dropout) dh = keep(a, key, 0, k) ? dh * a.scale : 0.f;
        if (!((relu0[k / 32] >> (k % 32)) & 1u)) dh = 0.f;
        stage_a[lane * STAGE_A + k] = dh;
      }
      __syncwarp();
      // ---- one column pair per lane: scatter dpre0 into dPp and dPl ----
      for (int s = 0; s < 32; ++s) {
        const int sl = __shfl_sync(FULL, loc, s);
        const int slr = __shfl_sync(FULL, lr, s);
        if (sl >= WINDOW) continue;  // warp-uniform
        const float v0 = stage_a[s * STAGE_A + lane], v1 = stage_a[s * STAGE_A + lane + 32];
        atomicAdd(dpp_s + sl * H0 + lane, v0);
        atomicAdd(dpp_s + sl * H0 + lane + 32, v1);
        if (slr >= 0) {
          atomicAdd(dpl_s + slr * H0 + lane, v0);
          atomicAdd(dpl_s + slr * H0 + lane + 32, v1);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (t0 < t1) flush_dpp(dpp_s, dpp, window);
  for (int i = threadIdx.x; i < a.num_l * H0; i += BWD_THREADS) {
    const float v = dpl_s[i];
    if (v != 0.f) atomicAdd(dpl + i, v);
  }
#pragma unroll
  for (int k = 0; k < H0; ++k) {
    if (dw1_acc[k] != 0.f) atomicAdd(dw1 + k * H1 + lane, dw1_acc[k]);
  }
  atomicAdd(db1 + lane, db1_acc);
  atomicAdd(dw2 + lane, dw2_acc);
  for (int off = 16; off > 0; off >>= 1) db2_acc += __shfl_xor_sync(FULL, db2_acc, off);
  if (lane == 0) atomicAdd(db2, db2_acc);
}

Head make_head(const float* pp, int num_p, const float* pl, int num_l, const float* w1,
               const float* b1, const float* w2, const float* b2, const int* lab,
               const int* local, const int* tile_map, const int* tile_mask,
               const int* lab_base, int lab_rows, int lab_base_max, unsigned seed0,
               unsigned seed1, unsigned threshold, float scale, int dropout) {
  Head a;
  a.pp = pp;
  a.pl = pl;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.lab = lab;
  a.local = local;
  a.tile_map = tile_map;
  a.tile_mask = tile_mask;
  a.lab_base = lab_base;
  a.num_p = num_p;
  a.num_l = num_l;
  a.lab_rows = lab_rows;
  a.lab_base_max = lab_base_max;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.threshold = threshold;
  a.scale = scale;
  a.dropout = dropout;
  return a;
}

}  // namespace

extern "C" {

// Shared memory K4b needs for a lab table of num_l rows.
int mmgnn_pair_head_bwd_shared_bytes(int num_l) {
  return (int)(sizeof(float) * ((size_t)H0 * H1 + 2 * H1 + (size_t)WINDOW * H0 +
                                (size_t)num_l * H0 + (size_t)BWD_WARPS * 32 * (STAGE_A + STAGE_B)));
}

// K4f.  out [num_tiles * 1024] is written in full (0 for padding and masked tiles).
int mmgnn_pair_head_fwd(const float* pp, int num_p, const float* pl, int num_l, const float* w1,
                        const float* b1, const float* w2, const float* b2, const int* lab,
                        const int* local, const int* tile_map, const int* tile_mask,
                        const int* lab_base, int lab_rows, int lab_base_max, int num_tiles,
                        unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                        int dropout, float* out, void* stream) {
  const Head a = make_head(pp, num_p, pl, num_l, w1, b1, w2, b2, lab, local, tile_map, tile_mask,
                           lab_base, lab_rows, lab_base_max, seed0, seed1, threshold, scale,
                           dropout);
  const int blocks = num_tiles * (TILE_E / FWD_THREADS);
  pair_head_fwd_kernel<<<blocks, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, num_tiles, out);
  return cudaGetLastError();
}

// K4b.  dpp [num_windows * 128, 64], dpl [num_l, 64], dw1 [64, 32], db1, dw2
// [32] and db2 [1] are zeroed by the caller and accumulated with atomics.
int mmgnn_pair_head_bwd(const float* pp, int num_p, const float* pl, int num_l, const float* w1,
                        const float* b1, const float* w2, const float* b2, const int* lab,
                        const int* local, const int* tile_map, const int* tile_mask,
                        const int* lab_base, int lab_rows, int lab_base_max, int num_tiles,
                        unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                        int dropout, const float* g_out, int tiles_per_block, float* dpp,
                        float* dpl, float* dw1, float* db1, float* dw2, float* db2,
                        void* stream) {
  const Head a = make_head(pp, num_p, pl, num_l, w1, b1, w2, b2, lab, local, tile_map, tile_mask,
                           lab_base, lab_rows, lab_base_max, seed0, seed1, threshold, scale,
                           dropout);
  const int smem = mmgnn_pair_head_bwd_shared_bytes(num_l);
  cudaError_t err = cudaFuncSetAttribute(pair_head_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_tiles + tiles_per_block - 1) / tiles_per_block;
  pair_head_bwd_kernel<<<blocks, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, g_out, num_tiles, tiles_per_block, dpp, dpl, dw1, db1, dw2, db2);
  return cudaGetLastError();
}

}  // extern "C"
