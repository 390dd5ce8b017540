// The fused pair head, hand-written for Hopper (sm_90a).  Built by
// ops/_build.py into the port's one shared library with a plain C interface
// and called through ctypes from ops/pairhead_kernels.py.
//
// Replaces the four Pallas TPU kernels of multi_modal_gnn_tpu/ops/pallas_pairhead.py:
//   K4f _fused_fwd / _fwd_kernel                -> mmgnn_pair_head_fwd
//   K4b _fused_bwd / _bwd_kernel                -> mmgnn_pair_head_bwd
//   K5f _dual_fused_fwd / _dual_fwd_kernel      -> mmgnn_pair_head_dual_fwd
//   K5b _dual_fused_bwd / _dual_bwd_kernel      -> mmgnn_pair_head_dual_bwd
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
// K5 runs both degree-gated heads (tabular and GNN) of one batch in one
// launch: the same slots, windows and lab ids, each head with its own
// tables, weights and tile mask.  The TPU kernel packed the two heads side
// by side (128 lanes) under a block-diagonal W1 to fill its MXU passes; here
// each head's [64] -> [32] product runs on its own, and a head's zero
// blocks cost nothing.  A head's masked tiles cost it their mask read.
//
// Dropout: a counter-based generator, the same function as dropout_bits in
// ops/pairhead_kernels.py, so the plain version draws the same masks:
//   key(e)        = fmix32(seed0 ^ fmix32(e ^ fmix32(seed1)))
//   bits(e, L, c) = fmix32(key(e) ^ (S L + c + 1) * 0x9E3779B9)
// (murmur3's finalizer; e the global slot, L the layer, c the column), kept
// when bits >= threshold compared UNSIGNED, threshold = rate * 2^32, and
// scaled by 1 / (1 - rate).  K4 draws with S = 64.  K5 draws ONE stream
// over both heads' concatenated activations, as the TPU kernel does: seed
// (seed_tab ^ seed_gnn), S = 128, the tabular head on columns 0..63 of
// layer 0 and 0..31 of layer 1, the GNN head on 64..127 and 32..63.  The
// backward recomputes the bits; no mask is stored.  The TPU drew
// pltpu.prng_random_bits, which cannot be reproduced.
//
// What bounds them on the H100: operations.  64 x 32 FMAs per slot and head
// forward (h0 @ W1), three times that backward (recomputed h0 @ W1, dpre1 @
// W1^T and the dW1 outer products), against the ~0.5 KB of Pp/Pl rows a
// slot reads per head, mostly from L2.
//   * K4f / K5f (redesigned for Hopper).  Their first version ran one
//     thread per slot on the CUDA cores: a shared-memory load of W1 for
//     every 4 FMAs (the load pipe, not the FMA pipe, set the pace), each
//     thread gathering its own two 256-byte rows, 96 dropout hashes in
//     series with the FMAs, and a block per 256 slots.  Now K4b's scheme:
//     - Persistent blocks of 8 warps, two an SM (<= 128 registers a thread,
//       96 KB of shared memory a block), one wave a head; each warp takes units of
//       128 slots, the first by its index and the rest from a counter, so a
//       masked tile costs its mask read and a float4 of zeros a lane.  The
//       launch's last block zeroes the counters again, so the wrapper keeps
//       one zeroed buffer a stream and fills nothing per launch.
//     - A warp runs 16 slots at a time: their Pp and Pl rows come in by
//       cp.async (16-byte chunks, a whole row per 16 lanes, each lane's
//       source, destination and bound fixed once) while the group before
//       computes; the next unit's metadata and first rows while the unit's
//       last group computes; a group of 16 padding slots (a tile's tail)
//       stores zeros and skips the rest.  pre1 = h0 W1 ([16 x 64] x [64 x
//       32]) runs on mma.sync m16n8k8 TF32 in three hi / lo terms over
//       K4b's pre-split W1 fragments, with K4b's k order, so a lane's h0
//       elements are its A fragment.  ReLU, layer 1's dropout and the dot
//       with w2 act on the accumulator fragment; a quad sums its 8 columns
//       each with two shuffles and stores 16 outputs in one instruction.
//     - Each lane hashes only the (slot, column) pairs of its own fragment
//       elements: 96 hashes a slot as before, spread over the lanes, each
//       hashed whatever the sign of its unit (a branch on the sign, taken by
//       some lane of every warp, cost more than the hash).  The hashes are
//       the largest share of the instructions; the tensor cores are not the
//       limit (one TF32 term in place of three left the time unchanged).
//     - K5f: K5b's layout, blockIdx.y = 0 the GNN head, 1 the tabular head,
//       each head with its own counter; each decodes the slot itself.  So
//       two waves back to back: the tabular head's blocks become resident
//       as the GNN head's retire.  One wave whose blocks drain the GNN head,
//       meet at a barrier and drain the tabular head was ~11 % slower in
//       turns (PERF.md section 6).
//   * K4b (redesigned for Hopper).  Its first version kept the [num_labs,
//     64] dPl table in shared memory (one 4-warp block an SM, and no lab
//     table above 551 rows), walked static tile ranges while the degree
//     gate's masked tiles cluster, ran its three products per slot on the
//     CUDA cores with a shared-memory load per FMA, and scattered dPp / dPl
//     with f32 shared atomics (compare-and-swap loops).  Now:
//     - Persistent blocks of 8 warps, one an SM; each warp takes units of
//       128 slots (an eighth of a tile) from a counter, so a masked tile
//       costs its mask read and no warp waits for a slow neighbour.
//     - A warp runs 16 slots at a time through the three products on the
//       tensor cores (mma.sync m16n8k8 TF32): pre1 = h0 W1 ([16 x 64] x
//       [64 x 32]), dh0 = dpre1 W1^T and dW1 += h0^T dpre1.  Each product is
//       three TF32 products of operands split into hi + lo (a_lo b_hi +
//       a_hi b_lo + a_hi b_hi, within ~2^-21 where one TF32 product keeps
//       2^-11).  The k order of the first two products is permuted so that
//       a lane's h0 elements are its own A fragment, and pre1's accumulator
//       is dh0's A fragment, with no shuffle; dW1 reads h0 and dpre1
//       transposed from per-warp staging rows (strides 8 mod 32 floats: no
//       bank conflict).  W1's fragments sit in shared memory, split once.
//     - dW1, db1, dw2 and db2 stay in registers across a warp's units, are
//       summed over the block's warps in shared memory at the end and go
//       out with one atomic per element and block.
//     - dPp and dPl need no shared table and no shared atomics: a lane owns
//       two columns of dpre0 and walks the group's slots in order, merging
//       runs of equal rows in registers, and adds each run to its global row
//       with one float2 red.add.f32 a lane (a whole row a warp
//       instruction).  Slots are sorted by patient within a tile (full lab
//       table) or by lab (span tiles, training/masker.py), so one of the two
//       scatters merges runs of ~10 to ~35 slots and the other adds one row
//       per slot.
//     - A warp stages its unit's metadata (dPp row, Pl row, upstream
//       gradient) in shared memory and copies each group's Pp and Pl rows in
//       with cp.async while the group before it computes: the row loads'
//       latency, exposed once a group, held the first tensor-core version
//       back most.
//     - 172 KB of shared memory a block, the same for any lab table; about
//       200 registers a thread, so one block of 8 warps an SM.
//   * K5b: K4b's blocks, one head per block: blockIdx.y = 0 takes the GNN
//     head, which runs on most tiles, so its blocks are dispatched first;
//     blockIdx.y = 1 the tabular head; each head has its own unit counter.
//   Neither direction uses shared-memory float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 128;
constexpr int TILE_E = 1024;
constexpr int H0 = 64;
constexpr int H1 = 32;
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

// Dropout counter layouts, compile-time so that each unrolled column's
// counter (S L + O_L + c + 1) * 0x9E3779B9 folds to a constant.
struct SingleCols {  // K4
  static constexpr int S = H0, O0 = 0, O1 = 0;
};
struct TabCols {  // K5, the tabular head: columns 0..63 and 0..31
  static constexpr int S = 2 * H0, O0 = 0, O1 = 0;
};
struct GnnCols {  // K5, the GNN head: columns 64..127 and 32..63
  static constexpr int S = 2 * H0, O0 = H0, O1 = H1;
};

// The gradients of one head, each zeroed by the caller and accumulated with atomics.
struct Grads {
  float* __restrict__ dpp;  // [num_windows * 128 (or num_p if larger), 64]
  float* __restrict__ dpl;  // [num_l, 64]
  float* __restrict__ dw1;  // [64, 32]
  float* __restrict__ db1;  // [32]
  float* __restrict__ dw2;  // [32]
  float* __restrict__ db2;  // [1]
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

template <class C>
__device__ __forceinline__ bool keep(const Head& a, uint32_t key, int layer, int c) {
  const int col = layer * C::S + (layer ? C::O1 : C::O0) + c;
  return fmix32(key ^ ((uint32_t)(col + 1) * 0x9E3779B9u)) >= a.threshold;
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

// ---------------------------------------------------------------------------
// K4b / K5b: the backward on the tensor cores (notes in the header)
// ---------------------------------------------------------------------------

constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_UNIT = 128;               // slots a warp takes at a time: 8 groups of 16
constexpr int UNITS_PER_TILE = TILE_E / BWD_UNIT;
constexpr int H0_STRIDE = H0 + 8;           // staging row strides, 8 mod 32 floats: the
constexpr int H1_STRIDE = H1 + 8;           // fragment reads and float2 writes miss no bank
constexpr int RED_FLOATS = H0 * H1 + 2 * H1 + 1;  // a block's dW1, db1, dw2, db2

// b = hi + lo in TF32: hi keeps b's top 11 significand bits (truncated),
// lo = b - hi (exact) rounded to nearest on its 11th bit; |b - hi - lo| <=
// 2^-21 |b|, and hi alone carries a non-finite b.
__device__ __forceinline__ void split_tf32(float b, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(b) & 0xffffe000u;
  lo = (__float_as_uint(b - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a * b for one 16x8x8 TF32 tile (the PTX ISA's "mma.m16n8k8" .tf32
// fragments: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g],
// B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]; g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into TF32 hi and lo parts (once for all its products).
struct SplitA {
  unsigned hi[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  split_tf32(a0, s.hi[0], s.lo[0]);
  split_tf32(a1, s.hi[1], s.lo[1]);
  split_tf32(a2, s.hi[2], s.lo[2]);
  split_tf32(a3, s.hi[3], s.lo[3]);
  return s;
}

// c += a * b in three TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi):
// within ~2^-21 of the f32 product's operands, where one product keeps 2^-11.
__device__ __forceinline__ void mma3(float (&c)[4], const SplitA& a, uint2 bh, uint2 bl) {
  mma_tf32(c, a.lo, bh.x, bh.y);
  mma_tf32(c, a.hi, bl.x, bl.y);
  mma_tf32(c, a.hi, bh.x, bh.y);
}

// B fragments of W1 (split hi / lo, laid out so a lane reads its pair with
// one 8-byte load), b1 and w2, and per warp the staging of one 16-slot group.
struct BwdShared {
  uint2 fw_hi[H0 / 8][H1 / 8][32], fw_lo[H0 / 8][H1 / 8][32];  // h0 @ W1: k8 step x n8 tile
  uint2 bw_hi[H1 / 8][H0 / 8][32], bw_lo[H1 / 8][H0 / 8][32];  // dpre1 @ W1^T
  float b1[H1], w2[H1];
  float h0s[BWD_WARPS][16][H0_STRIDE];  // h0 after dropout, then dpre0; at the end dW1 ...
  float d1s[BWD_WARPS][16][H1_STRIDE];  // dpre1
  float rows[BWD_WARPS][2][16][H0_STRIDE];  // the group's Pp and Pl rows, copied in ahead
  int meta_p[BWD_WARPS][BWD_UNIT];    // per slot of the unit: its dPp row (-1: padding)
  int meta_l[BWD_WARPS][BWD_UNIT];    // its Pl / dPl row (-1: a zero row)
  float meta_go[BWD_WARPS][BWD_UNIT];  // its upstream gradient (0: padding)
};
static_assert(sizeof(float) * BWD_WARPS * 16 * H0_STRIDE >= sizeof(float) * RED_FLOATS,
              "the block's reduction reuses h0s");

// W1's B fragments for pre1 = h0 W1, split hi / lo: k8 step kk's column t
// <-> feature 8 kk + 2t, column t + 4 <-> 8 kk + 2t + 1; so a lane's A
// fragment is its own h0 elements, which sit where dh0's accumulator puts
// the same features.
__device__ void load_w1_fragments(const float* __restrict__ w1, uint2 (*hi)[H1 / 8][32],
                                  uint2 (*lo)[H1 / 8][32], int nthreads) {
  for (int i = threadIdx.x; i < (H0 / 8) * (H1 / 8) * 32; i += nthreads) {
    const int kk = i / ((H1 / 8) * 32), nt = (i / 32) % (H1 / 8), ln = i % 32;
    const int g = ln / 4, t = ln % 4;
    unsigned h0, l0, h1, l1;
    split_tf32(w1[(8 * kk + 2 * t) * H1 + 8 * nt + g], h0, l0);
    split_tf32(w1[(8 * kk + 2 * t + 1) * H1 + 8 * nt + g], h1, l1);
    hi[kk][nt][ln] = make_uint2(h0, h1);
    lo[kk][nt][ln] = make_uint2(l0, l1);
  }
}

__device__ void load_bwd_weights(const Head& a, BwdShared& sm) {
  load_w1_fragments(a.w1, sm.fw_hi, sm.fw_lo, BWD_THREADS);
  // dpre1 @ W1^T: k8 step s's columns t, t + 4 <-> j = 8 s + 2t, 8 s + 2t + 1,
  // pre1's own C layout
  for (int i = threadIdx.x; i < (H1 / 8) * (H0 / 8) * 32; i += BWD_THREADS) {
    const int s = i / ((H0 / 8) * 32), nt = (i / 32) % (H0 / 8), ln = i % 32;
    const int g = ln / 4, t = ln % 4;
    unsigned h0, l0, h1, l1;
    split_tf32(a.w1[(8 * nt + g) * H1 + 8 * s + 2 * t], h0, l0);
    split_tf32(a.w1[(8 * nt + g) * H1 + 8 * s + 2 * t + 1], h1, l1);
    sm.bw_hi[s][nt][ln] = make_uint2(h0, h1);
    sm.bw_lo[s][nt][ln] = make_uint2(l0, l1);
  }
  if (threadIdx.x < H1) {
    sm.b1[threadIdx.x] = a.b1[threadIdx.x];
    sm.w2[threadIdx.x] = a.w2[threadIdx.x];
  }
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The unit's slots (units u * 128 ...) of tile t, window w, into a warp's
// metadata: each slot's Pp row mp (-1: padding), Pl row ml (-1: a zero row)
// and, for the backward, its upstream gradient go (0: padding).  All lanes
// call it.
__device__ __forceinline__ void load_unit_meta(const Head& a, const float* __restrict__ g_out,
                                               int* mp, int* ml, float* go, int u, int t, int w) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < BWD_UNIT / 32; ++i) {
    const long long e = (long long)u * BWD_UNIT + 32 * i + lane;
    const int loc = a.local[e];
    const bool valid = loc < WINDOW;
    mp[32 * i + lane] = valid ? w * WINDOW + loc : -1;
    ml[32 * i + lane] = valid ? lab_row(a, t, a.lab[e]) : -1;
    if (go != nullptr) go[32 * i + lane] = valid ? g_out[e] : 0.f;
  }
  __syncwarp();
}

// A lane's part of copying a group's 16 Pp and Pl rows into its warp's row
// buffer: lanes 0-15 copy 16 bytes (their chunk) of each Pp row, lanes 16-31
// of each Pl row.  Source, bound and destination are fixed once; a row id
// not below the bound (-1: padding or a lab outside the tile's slice, or a
// patient >= num_p) reads zeros.
struct RowCopy {
  const float* src;  // the lane's table at its chunk
  const int* meta;   // the unit's row ids of that table (mp or ml)
  unsigned limit;
  float* dst;        // the lane's chunk of slot 0's row

  __device__ __forceinline__ RowCopy(const Head& a, const int* mp, const int* ml,
                                     float (*rows)[16][H0_STRIDE]) {
    const int lane = threadIdx.x % 32, table = lane / 16;
    src = (table == 0 ? a.pp : a.pl) + 4 * (lane % 16);
    meta = table == 0 ? mp : ml;
    limit = table == 0 ? (unsigned)a.num_p : 0x7fffffffu;
    dst = &rows[table][0][4 * (lane % 16)];
  }

  // Group grp's rows (slots 16 grp ... of the unit), one commit group.
  __device__ __forceinline__ void operator()(int grp) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 r4 = *reinterpret_cast<const int4*>(meta + 16 * grp + 4 * q);
      const int rows4[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = (unsigned)rows4[k] < limit;
        cp_async16(dst + (4 * q + k) * H0_STRIDE, src + (long long)(ok ? rows4[k] : 0) * H0, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }
};

// One row of a running merge: its table row (-1 = none) and the lane's two
// columns (2 lane, 2 lane + 1) summed over the run's slots.
struct Run {
  int row;
  float2 acc;
};

__device__ __forceinline__ void flush_run(Run& r, float* __restrict__ table, int lane) {
  if (r.row >= 0) {  // warp-uniform: every lane holds the same row
    atomicAdd(reinterpret_cast<float2*>(table + (long long)r.row * H0) + lane, r.acc);
  }
  r.row = -1;
  r.acc = make_float2(0.f, 0.f);
}

__device__ __forceinline__ void merge_run(Run& r, int row, float2 v, float* __restrict__ table,
                                          int lane) {
  if (row < 0) return;
  if (row != r.row) {
    flush_run(r, table, lane);
    r.row = row;
  }
  r.acc.x += v.x;
  r.acc.y += v.y;
}

// What a warp carries across its units: the weight gradients (dW1 in mma C
// fragments: m16 tile of features x n8 tile of j), the lane's db1 / dw2
// columns j = 8 i + 2t + q over its rows, and db2.
struct WarpGrads {
  float dw1[H0 / 16][H1 / 8][4];
  float dw2[H1 / 8][2], db1[H1 / 8][2];
  float db2;
};

// Group grp (slots e0 .. e0 + 15) of the warp's unit, whose rows have been
// copied in: recompute the forward on the tensor cores, then dpre1, dW1 +=
// h0^T dpre1 and dpre0 = dpre1 W1^T through the masks; dpre0 goes into the
// runs of dPp and dPl.  The next group's rows are copied in meanwhile.
template <class C>
__device__ __forceinline__ void bwd_group(const Head& a, BwdShared& sm, const RowCopy& copy_rows,
                                          int grp, long long e0, WarpGrads& wg, Run& run_p,
                                          Run& run_l, const Grads& d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  float(*h0s)[H0_STRIDE] = sm.h0s[warp];
  float(*d1s)[H1_STRIDE] = sm.d1s[warp];
  const float scale = a.dropout ? a.scale : 1.f;

  // ---- the lane's two slots (rows g and g + 8 of the group) ----
  float go[2];
  uint32_t key[2], pass0[2];  // pass0 bit 2 kk + q: feature 8 kk + 2 tq + q kept and > 0
  float h[2][H0 / 4];         // h0 at those features
  cp_async_wait_all();
  __syncwarp();  // the group's rows have landed
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sl = g + 8 * r;
    go[r] = sm.meta_go[warp][grp * 16 + sl];
    key[r] = a.dropout ? slot_key(a, (uint32_t)(e0 + sl)) : 0u;
    uint32_t bits = 0u;
#pragma unroll
    for (int kk = 0; kk < H0 / 8; ++kk) {
      const float2 x = *reinterpret_cast<const float2*>(&sm.rows[warp][0][sl][8 * kk + 2 * tq]);
      const float2 y = *reinterpret_cast<const float2*>(&sm.rows[warp][1][sl][8 * kk + 2 * tq]);
      const float v[2] = {x.x + y.x, x.y + y.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool on = v[q] > 0.f && (!a.dropout || keep<C>(a, key[r], 0, 8 * kk + 2 * tq + q));
        bits |= (on ? 1u : 0u) << (2 * kk + q);
        h[r][2 * kk + q] = on ? (a.dropout ? v[q] * scale : v[q]) : 0.f;
      }
      *reinterpret_cast<float2*>(&h0s[sl][8 * kk + 2 * tq]) = make_float2(h[r][2 * kk], h[r][2 * kk + 1]);
    }
    pass0[r] = bits;
  }
  __syncwarp();  // the row buffer is read: the next group's rows go in
  if (grp + 1 < BWD_UNIT / 16) copy_rows(grp + 1);

  // ---- pre1 = h0 W1 + b1 (M = slot, N = j, K = feature) ----
  float acc1[H1 / 8][4];
#pragma unroll
  for (int nt = 0; nt < H1 / 8; ++nt) {
    const float b0 = sm.b1[8 * nt + 2 * tq], b1 = sm.b1[8 * nt + 2 * tq + 1];
    acc1[nt][0] = b0, acc1[nt][1] = b1, acc1[nt][2] = b0, acc1[nt][3] = b1;
  }
#pragma unroll
  for (int kk = 0; kk < H0 / 8; ++kk) {
    const SplitA af = split_a(h[0][2 * kk], h[1][2 * kk], h[0][2 * kk + 1], h[1][2 * kk + 1]);
#pragma unroll
    for (int nt = 0; nt < H1 / 8; ++nt) mma3(acc1[nt], af, sm.fw_hi[kk][nt][lane], sm.fw_lo[kk][nt][lane]);
  }

  // ---- layer 1's backward: dw2, db1, db2 and dpre1 (into acc1) ----
#pragma unroll
  for (int nt = 0; nt < H1 / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2, q = e % 2, j = 8 * nt + 2 * tq + q;
      const float pre = acc1[nt][e];
      const bool kept = !a.dropout || keep<C>(a, key[r], 1, j);
      const float h1 = kept ? (a.dropout ? fmaxf(pre, 0.f) * scale : fmaxf(pre, 0.f)) : 0.f;
      wg.dw2[nt][q] = fmaf(go[r], h1, wg.dw2[nt][q]);
      const float dpre1 = (kept && pre > 0.f) ? go[r] * sm.w2[j] * scale : 0.f;
      wg.db1[nt][q] += dpre1;
      acc1[nt][e] = dpre1;
    }
    *reinterpret_cast<float2*>(&d1s[g][8 * nt + 2 * tq]) = make_float2(acc1[nt][0], acc1[nt][1]);
    *reinterpret_cast<float2*>(&d1s[g + 8][8 * nt + 2 * tq]) = make_float2(acc1[nt][2], acc1[nt][3]);
  }
  if (tq == 0) wg.db2 += go[0] + go[1];

  // ---- dh0 = dpre1 W1^T (M = slot, N = feature, K = j) ----
  float acc0[H0 / 8][4];
#pragma unroll
  for (int nt = 0; nt < H0 / 8; ++nt) acc0[nt][0] = acc0[nt][1] = acc0[nt][2] = acc0[nt][3] = 0.f;
#pragma unroll
  for (int s = 0; s < H1 / 8; ++s) {
    const SplitA af = split_a(acc1[s][0], acc1[s][2], acc1[s][1], acc1[s][3]);
#pragma unroll
    for (int nt = 0; nt < H0 / 8; ++nt) mma3(acc0[nt], af, sm.bw_hi[s][nt][lane], sm.bw_lo[s][nt][lane]);
  }
  __syncwarp();  // h0s and d1s are written

  // ---- dW1 += h0^T dpre1 (M = feature, N = j, K = slot), from the staging ----
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint2 bh[H1 / 8], bl[H1 / 8];
#pragma unroll
    for (int nj = 0; nj < H1 / 8; ++nj) {
      split_tf32(d1s[8 * ks + tq][8 * nj + g], bh[nj].x, bl[nj].x);
      split_tf32(d1s[8 * ks + tq + 4][8 * nj + g], bh[nj].y, bl[nj].y);
    }
#pragma unroll
    for (int mt = 0; mt < H0 / 16; ++mt) {
      const SplitA af = split_a(h0s[8 * ks + tq][16 * mt + g], h0s[8 * ks + tq][16 * mt + g + 8],
                                h0s[8 * ks + tq + 4][16 * mt + g], h0s[8 * ks + tq + 4][16 * mt + g + 8]);
#pragma unroll
      for (int nj = 0; nj < H1 / 8; ++nj) mma3(wg.dw1[mt][nj], af, bh[nj], bl[nj]);
    }
  }
  __syncwarp();  // h0s is read: dpre0 takes its place

  // ---- dpre0 = dh0 through layer 0's ReLU and dropout ----
#pragma unroll
  for (int nt = 0; nt < H0 / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float x = acc0[nt][2 * r + q];
        v[q] = ((pass0[r] >> (2 * nt + q)) & 1u) ? (a.dropout ? x * scale : x) : 0.f;
      }
      *reinterpret_cast<float2*>(&h0s[g + 8 * r][8 * nt + 2 * tq]) = make_float2(v[0], v[1]);
    }
  }
  __syncwarp();

  // ---- one column pair per lane: runs of equal rows into dPp and dPl ----
#pragma unroll 4
  for (int s = 0; s < 16; ++s) {
    const int rp = sm.meta_p[warp][grp * 16 + s], rl = sm.meta_l[warp][grp * 16 + s];
    const float2 v = *reinterpret_cast<const float2*>(&h0s[s][2 * lane]);
    merge_run(run_p, rp, v, d.dpp, lane);
    merge_run(run_l, rl, v, d.dpl, lane);
  }
  __syncwarp();  // the staging is read before the next group writes it
}

// The backward of one head: the block's warps take units of 128 slots (an
// eighth of a tile) from the head's counter `work` until none is left; a
// masked tile's units cost a mask read.  At the end the block sums its
// warps' weight gradients in shared memory and adds them to d with one
// atomic per element.
template <class C>
__device__ __forceinline__ void pair_head_bwd_body(const Head& a, const float* __restrict__ g_out,
                                                   int num_tiles, int* work, const Grads& d) {
  extern __shared__ float4 smem4[];
  BwdShared& sm = *reinterpret_cast<BwdShared*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_bwd_weights(a, sm);
  __syncthreads();

  WarpGrads wg;
#pragma unroll
  for (int mt = 0; mt < H0 / 16; ++mt)
#pragma unroll
    for (int nj = 0; nj < H1 / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) wg.dw1[mt][nj][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < H1 / 8; ++nt) wg.dw2[nt][0] = wg.dw2[nt][1] = wg.db1[nt][0] = wg.db1[nt][1] = 0.f;
  wg.db2 = 0.f;

  const RowCopy copy_rows(a, sm.meta_p[warp], sm.meta_l[warp], sm.rows[warp]);
  const int num_units = num_tiles * UNITS_PER_TILE;
  int next = lane == 0 ? atomicAdd(work, 1) : 0;
  for (;;) {
    const int u = __shfl_sync(FULL, next, 0);
    if (u >= num_units) break;
    if (lane == 0) next = atomicAdd(work, 1);  // the next unit, fetched under this one
    const int t = u / UNITS_PER_TILE;
    if (!tile_on(a, t)) continue;  // warp-uniform
    __syncwarp();  // the last unit's metadata is read
    load_unit_meta(a, g_out, sm.meta_p[warp], sm.meta_l[warp], sm.meta_go[warp], u, t, a.tile_map[t]);
    copy_rows(0);
    Run run_p{-1, make_float2(0.f, 0.f)}, run_l{-1, make_float2(0.f, 0.f)};
#pragma unroll 1
    for (int grp = 0; grp < BWD_UNIT / 16; ++grp) {
      bwd_group<C>(a, sm, copy_rows, grp, (long long)u * BWD_UNIT + grp * 16, wg, run_p, run_l, d);
    }
    flush_run(run_p, d.dpp, lane);
    flush_run(run_l, d.dpl, lane);
  }

  // db1 / dw2 over the lanes of one column (same tq), db2 over the warp
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int nt = 0; nt < H1 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wg.dw2[nt][q] += __shfl_xor_sync(FULL, wg.dw2[nt][q], off);
        wg.db1[nt][q] += __shfl_xor_sync(FULL, wg.db1[nt][q], off);
      }
  }
  for (int off = 1; off < 32; off <<= 1) wg.db2 += __shfl_xor_sync(FULL, wg.db2, off);

  // the block's sum, one warp after another, in the staging (free now)
  float* red = &sm.h0s[0][0][0];  // [dW1 64 x 32 | db1 32 | dw2 32 | db2]
  const int g = lane / 4, tq = lane % 4;
  __syncthreads();
  for (int ww = 0; ww < BWD_WARPS; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int mt = 0; mt < H0 / 16; ++mt)
#pragma unroll
        for (int nj = 0; nj < H1 / 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (16 * mt + g + 8 * (e / 2)) * H1 + 8 * nj + 2 * tq + e % 2;
            red[i] = ww ? red[i] + wg.dw1[mt][nj][e] : wg.dw1[mt][nj][e];
          }
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < H1 / 8; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 8 * nt + 2 * tq + q;
            red[H0 * H1 + j] = ww ? red[H0 * H1 + j] + wg.db1[nt][q] : wg.db1[nt][q];
            red[H0 * H1 + H1 + j] = ww ? red[H0 * H1 + H1 + j] + wg.dw2[nt][q] : wg.dw2[nt][q];
          }
      }
      if (lane == 0) red[RED_FLOATS - 1] = ww ? red[RED_FLOATS - 1] + wg.db2 : wg.db2;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < RED_FLOATS; i += BWD_THREADS) {
    const float v = red[i];
    if (v == 0.f) continue;
    if (i < H0 * H1) {
      atomicAdd(d.dw1 + i, v);
    } else if (i < H0 * H1 + H1) {
      atomicAdd(d.db1 + i - H0 * H1, v);
    } else if (i < H0 * H1 + 2 * H1) {
      atomicAdd(d.dw2 + i - H0 * H1 - H1, v);
    } else {
      atomicAdd(d.db2, v);
    }
  }
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
pair_head_bwd_kernel(Head a, const float* __restrict__ g_out, int num_tiles, int* work, Grads d) {
  pair_head_bwd_body<SingleCols>(a, g_out, num_tiles, work, d);
}

// K5b: blockIdx.y = 0 runs the GNN head, 1 the tabular head, each from its
// own counter (work[0], work[1]).
__global__ void __launch_bounds__(BWD_THREADS, 1)
pair_head_dual_bwd_kernel(Head hg, Head ht, const float* __restrict__ g_out_g,
                          const float* __restrict__ g_out_t, int num_tiles, int* work, Grads dg,
                          Grads dt) {
  if (blockIdx.y == 0) {
    pair_head_bwd_body<GnnCols>(hg, g_out_g, num_tiles, work, dg);
  } else {
    pair_head_bwd_body<TabCols>(ht, g_out_t, num_tiles, work + 1, dt);
  }
}

// ---------------------------------------------------------------------------
// K4f / K5f: the forward on the tensor cores (notes in the header)
// ---------------------------------------------------------------------------

constexpr int FWD_WARPS = 8;
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_BLOCKS_PER_SM = 2;  // <= 128 registers a thread; 2 x ~96 KB of shared memory
constexpr int FWD_UNIT = BWD_UNIT;    // 128 slots: 8 groups of 16 (load_unit_meta's unit)

// W1's B fragments (as K4b's forward product), b1 and w2, and per warp the
// group's Pp and Pl rows and the unit's metadata.
struct FwdShared {
  uint2 fw_hi[H0 / 8][H1 / 8][32], fw_lo[H0 / 8][H1 / 8][32];
  float b1[H1], w2[H1];
  float rows[FWD_WARPS][2][16][H0_STRIDE];
  int meta_p[FWD_WARPS][FWD_UNIT];  // per slot of the unit: its Pp row (-1: padding)
  int meta_l[FWD_WARPS][FWD_UNIT];  // its Pl row (-1: a zero row)
};

// The head's next unit from its counter; lane 0 fetches the one after it.
__device__ __forceinline__ int next_unit(int& next, int* work, int first) {
  const int u = __shfl_sync(FULL, next, 0);
  if (threadIdx.x % 32 == 0) next = first + atomicAdd(work, 1);
  return u;
}

// From unit u on, the first unit of a tile the head runs (or num_units);
// each masked unit on the way outputs 0, a float4 a lane.  Warp-uniform.
__device__ __forceinline__ int active_unit(const Head& a, int u, int& next, int* work, int first,
                                           int num_units, float* __restrict__ out) {
  while (u < num_units && !tile_on(a, u / UNITS_PER_TILE)) {
    reinterpret_cast<float4*>(out + (long long)u * FWD_UNIT)[threadIdx.x % 32] =
        make_float4(0.f, 0.f, 0.f, 0.f);
    u = next_unit(next, work, first);
  }
  return u;
}

// The forward of one head: each warp takes units of 128 slots, the first by
// its index, the rest from the head's counter `work` (zero), and runs each
// unit as 8 groups of 16 slots.  A group's rows are copied in (cp.async)
// while the group before it computes; the next unit's metadata and first
// rows while its last group computes.
template <class C>
__device__ __forceinline__ void pair_head_fwd_body(const Head& a, int num_tiles, int* work,
                                                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  FwdShared& sm = *reinterpret_cast<FwdShared*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  load_w1_fragments(a.w1, sm.fw_hi, sm.fw_lo, FWD_THREADS);
  if (threadIdx.x < H1) {
    sm.b1[threadIdx.x] = a.b1[threadIdx.x];
    sm.w2[threadIdx.x] = a.w2[threadIdx.x];
  }
  const float b2 = a.b2[0];
  const float scale = a.dropout ? a.scale : 1.f;
  __syncthreads();

  int* mp = sm.meta_p[warp];
  int* ml = sm.meta_l[warp];
  float(*rows)[16][H0_STRIDE] = sm.rows[warp];
  const RowCopy copy_rows(a, mp, ml, rows);
  const int num_units = num_tiles * UNITS_PER_TILE;
  const int first = gridDim.x * FWD_WARPS;  // units taken by index
  int next = lane == 0 ? first + atomicAdd(work, 1) : 0;
  int u = active_unit(a, blockIdx.x * FWD_WARPS + warp, next, work, first, num_units, out);
  if (u < num_units) {
    load_unit_meta(a, nullptr, mp, ml, nullptr, u, u / UNITS_PER_TILE, a.tile_map[u / UNITS_PER_TILE]);
    copy_rows(0);
  }
  while (u < num_units) {
    int u_next = num_units;
#pragma unroll 1
    for (int grp = 0; grp < FWD_UNIT / 16; ++grp) {
      const long long e0 = (long long)u * FWD_UNIT + grp * 16;
      // ---- the lane's two slots (rows g and g + 8): pre0 at features 8 kk + 2 tq + q ----
      float h[2][H0 / 4];
      bool valid[2];
      cp_async_wait_all();
      __syncwarp();  // the group's rows have landed
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sl = g + 8 * r;
        valid[r] = mp[grp * 16 + sl] >= 0;
#pragma unroll
        for (int kk = 0; kk < H0 / 8; ++kk) {
          const float2 x = *reinterpret_cast<const float2*>(&rows[0][sl][8 * kk + 2 * tq]);
          const float2 y = *reinterpret_cast<const float2*>(&rows[1][sl][8 * kk + 2 * tq]);
          h[r][2 * kk] = x.x + y.x;
          h[r][2 * kk + 1] = x.y + y.y;
        }
      }
      __syncwarp();  // the row buffer and the group's metadata are read
      if (grp + 1 < FWD_UNIT / 16) {
        copy_rows(grp + 1);
      } else {
        u_next = active_unit(a, next_unit(next, work, first), next, work, first, num_units, out);
        if (u_next < num_units) {
          const int t = u_next / UNITS_PER_TILE;
          load_unit_meta(a, nullptr, mp, ml, nullptr, u_next, t, a.tile_map[t]);
          copy_rows(0);
        }
      }
      if (!__any_sync(FULL, valid[0] || valid[1])) {  // 16 padding slots (a tile's tail): zeros
        if (tq < 2) out[e0 + g + 8 * tq] = 0.f;
        continue;
      }

      // ---- h0 = drop0(relu(pre0)): each lane hashes its own 32 (slot, feature) pairs ----
      uint32_t key[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        key[r] = a.dropout ? slot_key(a, (uint32_t)(e0 + g + 8 * r)) : 0u;
#pragma unroll
        for (int i = 0; i < H0 / 4; ++i) {
          const float v = h[r][i];  // hashed whatever its sign: a branch would cost more
          const bool kept = !a.dropout || keep<C>(a, key[r], 0, 8 * (i / 2) + 2 * tq + i % 2);
          h[r][i] = (v > 0.f) & kept ? v * scale : 0.f;
        }
      }

      // ---- pre1 = h0 W1 + b1 (M = slot, N = j, K = feature) ----
      float acc[H1 / 8][4];
#pragma unroll
      for (int nt = 0; nt < H1 / 8; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(&sm.b1[8 * nt + 2 * tq]);
        acc[nt][0] = acc[nt][2] = b.x;
        acc[nt][1] = acc[nt][3] = b.y;
      }
#pragma unroll
      for (int kk = 0; kk < H0 / 8; ++kk) {
        const SplitA af = split_a(h[0][2 * kk], h[1][2 * kk], h[0][2 * kk + 1], h[1][2 * kk + 1]);
#pragma unroll
        for (int nt = 0; nt < H1 / 8; ++nt) mma3(acc[nt], af, sm.fw_hi[kk][nt][lane], sm.fw_lo[kk][nt][lane]);
      }

      // ---- out = drop1(relu(pre1)) . w2 + b2: the lane's 8 columns, then the quad ----
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < H1 / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, q = e % 2;
          const bool kept = !a.dropout || keep<C>(a, key[r], 1, 8 * nt + 2 * tq + q);
          const float h1 = kept ? fmaxf(acc[nt][e], 0.f) * scale : 0.f;
          sum[r] = fmaf(h1, sm.w2[8 * nt + 2 * tq + q], sum[r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
        sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
      }
      // lane tq = r of each quad stores slot g + 8 r: 16 floats in one instruction
      if (tq < 2) {
        const bool v = tq == 0 ? valid[0] : valid[1];
        out[e0 + g + 8 * tq] = v ? (tq == 0 ? sum[0] : sum[1]) + b2 : 0.f;
      }
    }
    u = u_next;
  }
}

// The launch's last block zeroes the counters for the next launch on the
// stream: work[0] and work[1] the heads' unit counters, work[2] the blocks
// that are done.
__device__ __forceinline__ void reset_counters(int* work) {
  __threadfence();  // this thread's counter fetches come before its block is counted
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&work[2], 1) == (int)(gridDim.x * gridDim.y) - 1) {
    work[0] = work[1] = work[2] = 0;
  }
}

__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS_PER_SM)
pair_head_fwd_kernel(Head a, int num_tiles, int* work, float* __restrict__ out) {
  pair_head_fwd_body<SingleCols>(a, num_tiles, work, out);
  reset_counters(work);
}

// K5f: blockIdx.y = 0 runs the GNN head from work[0], 1 the tabular head
// from work[1], as K5b: the tabular head's blocks follow as the GNN head's
// retire.
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS_PER_SM)
pair_head_dual_fwd_kernel(Head hg, Head ht, int num_tiles, int* work, float* __restrict__ out_g,
                          float* __restrict__ out_t) {
  if (blockIdx.y == 0) {
    pair_head_fwd_body<GnnCols>(hg, num_tiles, work, out_g);
  } else {
    pair_head_fwd_body<TabCols>(ht, num_tiles, work + 1, out_t);
  }
  reset_counters(work);
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

// The two heads of K5: shared plan and seed, own tables and masks (their
// dropout columns: TabCols, GnnCols).
void make_dual(const float* const* tab, const float* const* gnn, int num_p, int num_l,
               const int* lab, const int* local, const int* tile_map, const int* tab_mask,
               const int* gnn_mask, unsigned seed0, unsigned seed1, unsigned threshold,
               float scale, int dropout, Head* ht, Head* hg) {
  *ht = make_head(tab[0], num_p, tab[1], num_l, tab[2], tab[3], tab[4], tab[5], lab, local,
                  tile_map, tab_mask, nullptr, 0, 0, seed0, seed1, threshold, scale, dropout);
  *hg = make_head(gnn[0], num_p, gnn[1], num_l, gnn[2], gnn[3], gnn[4], gnn[5], lab, local,
                  tile_map, gnn_mask, nullptr, 0, 0, seed0, seed1, threshold, scale, dropout);
}

Grads make_grads(float* dpp, float* dpl, float* dw1, float* db1, float* dw2, float* db2) {
  Grads d;
  d.dpp = dpp;
  d.dpl = dpl;
  d.dw1 = dw1;
  d.db1 = db1;
  d.dw2 = dw2;
  d.db2 = db2;
  return d;
}

}  // namespace

extern "C" {

// Shared memory of a K4b / K5b block (the same for any lab table).
int mmgnn_pair_head_bwd_shared_bytes() { return (int)sizeof(BwdShared); }

// Shared memory of a K4f / K5f block.
int mmgnn_pair_head_fwd_shared_bytes() { return (int)sizeof(FwdShared); }

// K4f.  out [num_tiles * 1024] is written in full (0 for padding and masked
// tiles); work[3] (reset_counters) is zero and is left zero; `blocks`
// persistent blocks (the wrapper's launch plan, ops/pairhead_kernels.py
// fwd_launch).
int mmgnn_pair_head_fwd(const float* pp, int num_p, const float* pl, int num_l, const float* w1,
                        const float* b1, const float* w2, const float* b2, const int* lab,
                        const int* local, const int* tile_map, const int* tile_mask,
                        const int* lab_base, int lab_rows, int lab_base_max, int num_tiles,
                        unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                        int dropout, int* work, int blocks, float* out, void* stream) {
  const Head a = make_head(pp, num_p, pl, num_l, w1, b1, w2, b2, lab, local, tile_map, tile_mask,
                           lab_base, lab_rows, lab_base_max, seed0, seed1, threshold, scale,
                           dropout);
  const int smem = mmgnn_pair_head_fwd_shared_bytes();
  cudaError_t err = cudaFuncSetAttribute(pair_head_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pair_head_fwd_kernel<<<blocks, FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, num_tiles, work, out);
  return cudaGetLastError();
}

// K4b.  dpp [num_windows * 128, 64], dpl [num_l, 64], dw1 [64, 32], db1, dw2
// [32] and db2 [1] are zeroed by the caller and accumulated with atomics;
// `work` is a zeroed unit counter; `blocks` persistent blocks (the wrapper's
// launch plan, ops/pairhead_kernels.py bwd_launch).
int mmgnn_pair_head_bwd(const float* pp, int num_p, const float* pl, int num_l, const float* w1,
                        const float* b1, const float* w2, const float* b2, const int* lab,
                        const int* local, const int* tile_map, const int* tile_mask,
                        const int* lab_base, int lab_rows, int lab_base_max, int num_tiles,
                        unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                        int dropout, const float* g_out, int* work, int blocks, float* dpp,
                        float* dpl, float* dw1, float* db1, float* dw2, float* db2,
                        void* stream) {
  const Head a = make_head(pp, num_p, pl, num_l, w1, b1, w2, b2, lab, local, tile_map, tile_mask,
                           lab_base, lab_rows, lab_base_max, seed0, seed1, threshold, scale,
                           dropout);
  const int smem = mmgnn_pair_head_bwd_shared_bytes();
  cudaError_t err = cudaFuncSetAttribute(pair_head_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pair_head_bwd_kernel<<<blocks, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, g_out, num_tiles, work, make_grads(dpp, dpl, dw1, db1, dw2, db2));
  return cudaGetLastError();
}

// K5f.  out_t and out_g [num_tiles * 1024] are written in full (0 for
// padding slots and for each head's masked tiles); work[3] (reset_counters)
// is zero and is left zero; `blocks` blocks a head.
int mmgnn_pair_head_dual_fwd(const float* pp_t, const float* pl_t, const float* w1_t,
                             const float* b1_t, const float* w2_t, const float* b2_t,
                             const float* pp_g, const float* pl_g, const float* w1_g,
                             const float* b1_g, const float* w2_g, const float* b2_g, int num_p,
                             int num_l, const int* lab, const int* local, const int* tile_map,
                             const int* tab_mask, const int* gnn_mask, int num_tiles,
                             unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                             int dropout, int* work, int blocks, float* out_t, float* out_g,
                             void* stream) {
  const float* tab[6] = {pp_t, pl_t, w1_t, b1_t, w2_t, b2_t};
  const float* gnn[6] = {pp_g, pl_g, w1_g, b1_g, w2_g, b2_g};
  Head ht, hg;
  make_dual(tab, gnn, num_p, num_l, lab, local, tile_map, tab_mask, gnn_mask, seed0, seed1,
            threshold, scale, dropout, &ht, &hg);
  const int smem = mmgnn_pair_head_fwd_shared_bytes();
  cudaError_t err = cudaFuncSetAttribute(pair_head_dual_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pair_head_dual_fwd_kernel<<<dim3(blocks, 2), FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      hg, ht, num_tiles, work, out_g, out_t);
  return cudaGetLastError();
}

// K5b.  Each head's dpp [num_windows * 128, 64], dpl [num_l, 64], dw1
// [64, 32], db1, dw2 [32] and db2 [1] are zeroed by the caller; work[2]
// (the GNN head's counter, then the tabular head's) too; `blocks` blocks a head.
int mmgnn_pair_head_dual_bwd(const float* pp_t, const float* pl_t, const float* w1_t,
                             const float* b1_t, const float* w2_t, const float* b2_t,
                             const float* pp_g, const float* pl_g, const float* w1_g,
                             const float* b1_g, const float* w2_g, const float* b2_g, int num_p,
                             int num_l, const int* lab, const int* local, const int* tile_map,
                             const int* tab_mask, const int* gnn_mask, int num_tiles,
                             unsigned seed0, unsigned seed1, unsigned threshold, float scale,
                             int dropout, const float* g_out_t, const float* g_out_g,
                             int* work, int blocks, float* dpp_t, float* dpl_t, float* dw1_t,
                             float* db1_t, float* dw2_t, float* db2_t, float* dpp_g,
                             float* dpl_g, float* dw1_g, float* db1_g, float* dw2_g,
                             float* db2_g, void* stream) {
  const float* tab[6] = {pp_t, pl_t, w1_t, b1_t, w2_t, b2_t};
  const float* gnn[6] = {pp_g, pl_g, w1_g, b1_g, w2_g, b2_g};
  Head ht, hg;
  make_dual(tab, gnn, num_p, num_l, lab, local, tile_map, tab_mask, gnn_mask, seed0, seed1,
            threshold, scale, dropout, &ht, &hg);
  const int smem = mmgnn_pair_head_bwd_shared_bytes();
  cudaError_t err = cudaFuncSetAttribute(pair_head_dual_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pair_head_dual_bwd_kernel<<<dim3(blocks, 2), BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      hg, ht, g_out_g, g_out_t, num_tiles, work,
      make_grads(dpp_g, dpl_g, dw1_g, db1_g, dw2_g, db2_g),
      make_grads(dpp_t, dpl_t, dw1_t, db1_t, dw2_t, db2_t));
  return cudaGetLastError();
}

}  // extern "C"
