// Split-KV flash decoding for Hopper, shared by the paged and the dense
// decode kernels: one new query token per slot against the slot's cached
// K/V rows, however those rows are located.
//
// What bounds it on the H100: the K/V bytes it must read, sum over slots of
// len * n_kv * head_dim * 2 * sizeof(TKV) (plus one f32 scale per page and
// kv head of a quantized pool), over 3.35 TB/s. Its arithmetic is
// 4 * q_per_kv flops per K/V element, far below the card's balance point, so
// at the serving shapes (a few hundred keys a slot, a few MB a layer) its
// time is the latency of a block's chain of dependent steps, and the design
// is about keeping that chain short and the copies in flight.
//
// Each (slot, kv head) is cut into `splits` runs of keys, one thread block
// each, and the `splits` blocks of one (slot, kv head) form a thread-block
// cluster along grid x. Each block stores its (max, sum, accumulator)
// partial straight into its slot of rank 0's shared memory (distributed
// shared memory), and rank 0 combines the slots after the cluster's
// barrier and writes the output (cluster_land below). One launch a call,
// no partials in device memory. A block with no keys (a short or empty
// slot) still stores its partial, with m = -inf and l = 0; a slot with no
// keys at all gives zeros. The planner caps `splits` at the portable
// cluster size, kDecodeMaxSplits. A GQA group of more than 16 query heads
// takes one cluster per 16 heads (a row tile), in both kernels.
//
// Two kernels, chosen by type in the callers (no fallback):
//  - decode_kernel_mma: a bfloat16 query over a bfloat16, int8 or float8
//    e4m3 pool, every full-width engine's path.
//     * The block (4 warps) walks its keys in tiles of kDecKeys = 64 keys,
//       staged in shared memory by cp.async (16-byte pieces where the rows
//       allow, 8-byte ones otherwise) in a ring of up to kDecMaxStages
//       stages (the deepest ring with which the card still holds the grid's
//       clusters in as few waves as with one stage): the copies of the first
//       `stages` tiles are all in flight before the first product, and each
//       tile's slot is refilled as soon as every warp is done with it. A
//       key past the slot's length, past the split or on an unmapped page
//       lands as zeros (src-size 0) and is masked, so NaN or extreme values
//       stored there never reach a sum.
//     * The whole GQA group is one 16-row A tile (query heads zero-padded
//       to 16), so one staged copy of each K/V byte serves every head of
//       the group. S = Q.K^T and P.V run on mma.sync m16n8k16 (bf16 in, f32
//       accumulate); warp w takes keys 16 w .. 16 w + 15 of each tile, K's
//       B fragments by ldmatrix, V's by ldmatrix.trans, from rows padded to
//       KT * 8 + 4 words so the 8 rows of an ldmatrix hit distinct banks.
//       The online softmax runs in registers in base 2; the four warps'
//       states merge through shared memory, then the splits' in the
//       cluster. wgmma is not used: its 64-row A tile would be at least
//       75 % padding for a group of 16 heads (94 % at the served 4-6).
//     * Quantized pools: every int8 code and every finite e4m3 code is
//       exactly a bf16 value, so each warp converts its 16 keys' raw bytes
//       into the tile's bf16 buffer with no scale; the K scale goes
//       on the score, the V scale on P before its bf16 rounding, and the
//       running sum adds the unscaled P (the rounding points of
//       paged_prefill_kernel_mma).
//     * Fixed cost: the slot's length and the block-table entries of the
//       first tiles are read together (the table column of a key does not
//       depend on the length), the query's A fragments are loaded beside
//       them, and the first copies follow: two dependent global reads
//       before K/V bytes move. Registers are capped at 3 blocks an SM up to
//       head_dim 128 (no spills).
//  - decode_kernel: a float32 query, or a float32 pool. Scalar f32 FMAs,
//    exact to the plain version's f32 rounding (rtol = atol = 2e-5). One
//    warp per query head of the group; lanes run along head_dim eight bytes
//    at a time; each warp loads kUnroll rows of K and V as raw bits before
//    it converts or uses any. A quantized row is scaled by its (page, kv
//    head) scale: the K scale folded into the row's dot product, the V
//    scale into its softmax weight. Each warp stores its rows' partials
//    into rank 0's landing area, as the tensor-core kernel's block does.
//
// How a row is found is the `Rows` policy of the caller. For
// decode_kernel_mma:
//   __device__ void span(int split, int* t0, int* t_end)
//       the split's key range before the length cuts it;
//   __device__ long long locate(int b, int t, int* page)
//       the element offset of key t's row of slot b (kv head 0), or -1 when
//       the key has no row; *page is the pool page holding it;
//   const float* k_scales, v_scales
//       a quantized pool's (n_pages, Hkv) scales, read at *page;
// and for decode_kernel:
//   __device__ void setup(int b, int h, int split, int len, int* smem,
//                         int* t0, int* t1)
//       the split's token range [t0, t1) of slot b, kv head h (may fill
//       shared memory; every thread calls it, and it ends in
//       __syncthreads when it does);
//   __device__ Cursor cursor(int b, int t)
//       a cursor at token t, whose `next(bool* ok, int* page)` returns the
//       element offset of that token's row (kv head 0), sets *page to the
//       row's page within the split, and steps to the next token, setting
//       *ok false where the token has no row;
//   __device__ float2 scales(int page)
//       the (K, V) scales of that page (quantized pools only).
//
// Layouts: q, out (B, 1, Hq, hd) contiguous; head h of the output is kv head
// h / q_per_kv; head_dim a multiple of 4 and of the values in eight bytes of
// TKV (8 int8 / fp8, 4 bf16, 2 float32).
#pragma once

#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"
#include "mma.cuh"

namespace paged {

constexpr int kDecodeMaxWarps = 8;
constexpr int kDecodeMaxHeadDim = 256;  // MAX_HEAD_DIM of models/config.py
constexpr int kDecodeMaxSplits = 8;     // the portable cluster size
constexpr int kDecKeys = 64;            // keys of a tile (mma kernel)
constexpr int kDecThreads = 128;        // 4 warps of 16 keys a tile
constexpr int kDecRows = 16;            // query heads of an A tile
constexpr int kDecMaxStages = 4;
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// The cluster merge. Each block's partial (per query row: m, l and the
// unnormalised accumulator, with m in base-2 units when kBase2) is stored
// straight into its rank's slot of the landing area in rank 0's shared
// memory (distributed shared memory: stores, no round trips). Every block
// arrives at the cluster barrier once at its start (relaxed) and waits on it
// before its first store into rank 0, so rank 0 has started; it then
// arrives again (release) and every rank but 0 exits. Rank 0 waits
// (acquire) and combines the slots in its own shared memory:
// out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max_s m_s), 0 where
// every l_s is 0. The landing area is nobody's scratch but its own, so a
// rank may store into it while rank 0 still walks its keys.
struct Landing {
  size_t ml, o, wbuf, end;  // (splits, nrows) (m, l) pairs, the other
};                          // ranks' (splits - 1, nrows, hd) accumulators,
                            // rank 0's weights (splits + 1, nrows)
__host__ __device__ inline Landing landing(size_t at, int splits, int nrows,
                                           int hd) {
  Landing m;
  m.ml = (at + 15) / 16 * 16;
  m.o = m.ml + (size_t)splits * nrows * 2 * 4;
  m.wbuf = m.o + (size_t)(splits - 1) * nrows * hd * 4;
  m.end = m.wbuf + (size_t)(splits + 1) * nrows * 4;
  return m;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Where this block's partial goes: its (m, l) pairs in rank 0's landing
// area, and its accumulator rows there too, or, for rank 0 itself, at
// `own` (nrows rows of hd in its own shared memory). Call after the first
// barrier's wait.
__device__ __forceinline__ float2* landing_ml(uint8_t* base, Landing lay,
                                             int nrows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  return cluster.map_shared_rank(reinterpret_cast<float2*>(base + lay.ml),
                                 0) +
         cluster.block_rank() * nrows;
}
__device__ __forceinline__ float* landing_o(uint8_t* base, Landing lay,
                                           float* own, int nrows, int hd) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  if (rank == 0) return own;
  return cluster.map_shared_rank(reinterpret_cast<float*>(base + lay.o), 0) +
         (size_t)(rank - 1) * nrows * hd;
}

// The second barrier and rank 0's combination into nrows output rows of hd
// values at `out` (row stride hd). Every thread of every block calls it.
template <bool kBase2, typename TO>
__device__ __forceinline__ void cluster_land(uint8_t* base, Landing lay,
                                             const float* own, int nrows,
                                             int hd, TO* out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_release();
  if (cluster.block_rank() != 0) return;
  cluster_wait_acquire();
  const int splits = (int)cluster.num_blocks();
  const float2* ml = reinterpret_cast<const float2*>(base + lay.ml);
  const float* o = reinterpret_cast<const float*>(base + lay.o);
  float* wbuf = reinterpret_cast<float*>(base + lay.wbuf);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s * nrows + r].x);
    float den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 p = ml[s * nrows + r];
      const float w = kBase2 ? exp2f(p.x - mx) : expf(p.x - mx);
      wbuf[s * nrows + r] = w;
      den = fmaf(w, p.y, den);
    }
    wbuf[splits * nrows + r] = den;
  }
  __syncthreads();
  const int half = hd / 2;
  for (int e = threadIdx.x; e < nrows * half; e += blockDim.x) {
    const int r = e / half, d = 2 * (e - r * half);
    const float2 v0 = *reinterpret_cast<const float2*>(own + r * hd + d);
    float nx = wbuf[r] * v0.x, ny = wbuf[r] * v0.y;
    for (int s = 1; s < splits; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(
          o + ((size_t)(s - 1) * nrows + r) * hd + d);
      const float w = wbuf[s * nrows + r];
      nx = fmaf(w, v.x, nx);
      ny = fmaf(w, v.y, ny);
    }
    const float den = wbuf[splits * nrows + r];
    store2<TO>(out + (size_t)r * hd + d, den == 0.f ? 0.f : nx / den,
               den == 0.f ? 0.f : ny / den);
  }
}

// ---------------------------------------------------------------------------
// float32 queries or pools: scalar FMAs
// ---------------------------------------------------------------------------

// One block per (split, 16-head row tile of kv head h, slot), as the
// tensor-core kernel; warp w serves rows w, w + n_warps, ... of the tile
// (query head h * rep + 16 rt + r) over the split's rows. Lane l holds
// elements [VEC * (l + 32 i), VEC * (l + 32 i) + VEC) of a row, i < NI.
// Shared memory: the Rows policy's (rows_smem bytes), then the landing
// area.
template <typename TQ, typename TKV, int NI, int kUnroll, typename Rows>
__global__ void __launch_bounds__(kDecodeMaxWarps * 32)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, Rows rows,
              const int* __restrict__ lengths, TQ* __restrict__ out, int Hq,
              int Hkv, int hd, int n_rt, int rows_smem, float scale) {
  using V = Vec<TKV>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  constexpr bool kScaled = V::kScaled;
  cluster_arrive_relaxed();
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / n_rt, rt = blockIdx.y - h * n_rt;
  const int rep = Hq / Hkv;
  const int r0 = rt * kDecRows;
  const int nrows = min(kDecRows, rep - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ __align__(16) int smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  const Landing lay = landing(rows_smem, gridDim.x, min(kDecRows, rep), hd);
  // rank 0's own rows
  float* own = reinterpret_cast<float*>(base + (lay.end + 15) / 16 * 16);
  int t0, t1;
  rows.setup(b, h, split, lengths[b], smem, &t0, &t1);

  const size_t head_off = (size_t)h * hd;
  bool lane_in[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) lane_in[i] = VEC * (lane + 32 * i) < hd;

  cluster_wait_acquire();  // rank 0 has started: its landing area is live
  float2* dst_ml = landing_ml(base, lay, nrows);
  float* dst_o = landing_o(base, lay, own, nrows, hd);
  for (int r = warp; r < nrows; r += n_warps) {
    float qr[NI][VEC], acc[NI][VEC];
    const TQ* q_row = q + ((size_t)b * Hq + (size_t)h * rep + r0 + r) * hd;
    // the query in the lanes' layout of a pool row (read once a block)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        qr[i][j] = lane_in[i] ? to_f32(q_row[VEC * (lane + 32 * i) + j])
                              : 0.f;
        acc[i][j] = 0.f;
      }
    float m = kNegInf, l = 0.f;

    for (int t = t0; t < t1; t += kUnroll) {
      // issue every load of the kUnroll rows before any is used
      Raw kr[kUnroll][NI], vr[kUnroll][NI];
      bool ok[kUnroll];
      int pg[kUnroll];  // each row's page within the split (for its scales)
      auto cur = rows.cursor(b, t);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool mapped;
        const size_t row = cur.next(&mapped, &pg[u]) + head_off;
        ok[u] = t + u < t1 && mapped;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          kr[u][i] = vr[u][i] = Raw{};
          if (ok[u] && lane_in[i]) {
            const size_t off = row + VEC * (lane + 32 * i);
            kr[u][i] = *reinterpret_cast<const Raw*>(k + off);
            vr[u][i] = *reinterpret_cast<const Raw*>(v + off);
          }
        }
      }
      float s[kUnroll];
      float mx = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float kf[VEC];
          V::unpack(kr[u][i], kf);
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qr[i][j], kf[j], dot);
        }
        if constexpr (kScaled) dot *= rows.scales(pg[u]).x;
        s[u] = ok[u] ? warp_sum(dot) * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = ok[u] ? expf(s[u] - mx) : 0.f;
        l += p;
        float pv = p;
        if constexpr (kScaled) pv *= rows.scales(pg[u]).y;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float vf[VEC];
          V::unpack(vr[u][i], vf);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(pv, vf[j], acc[i][j]);
        }
      }
      m = mx;
    }

    // the row's partial, into this block's slot of rank 0's landing area
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (!lane_in[i]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst_o[(size_t)r * hd + VEC * (lane + 32 * i) + j] = acc[i][j];
    }
    if (lane == 0) dst_ml[r] = make_float2(m, l);
  }
  cluster_land<false>(base, lay, own, nrows, hd,
                      out + ((size_t)b * Hq + (size_t)h * rep + r0) * hd);
}

// ---------------------------------------------------------------------------
// bfloat16 queries on the tensor cores
// ---------------------------------------------------------------------------

// Shared memory of decode_kernel_mma, in bytes from its start. The ring
// holds `stages` tiles: bf16 K and V rows of KT * 8 + 4 words each for a
// bf16 pool; for a quantized pool raw K and V rows of hd bytes, converted
// into one bf16 tile pair (`conv`) before the products. After the walk the
// warps' accumulators (4 x nrows x hd f32) reuse the ring's space. Then:
// each stage's per-key table (a valid flag, and for a quantized pool the K
// and V scales), the warps' (m, l), and the cluster merge's landing area.
struct DecodeSmem {
  size_t conv, ring, stage, valid, sk, sv, ml_warps;
  Landing land;
};
__host__ __device__ inline DecodeSmem decode_smem(int kt, int hd,
                                                  int kv_bytes, bool quant,
                                                  int stages, int nrows,
                                                  int splits) {
  DecodeSmem m;
  const size_t tile = 2 * (size_t)kDecKeys * (kt * 8 + 4) * 4;  // K and V
  m.conv = 0;
  m.ring = quant ? tile : 0;
  m.stage = quant ? 2 * (size_t)kDecKeys * hd * kv_bytes : tile;
  size_t end = m.ring + stages * m.stage;
  const size_t acc = 4 * (size_t)nrows * hd * 4;
  end = (end > acc ? end : acc);
  m.valid = (end + 15) / 16 * 16;
  m.sk = m.valid + (size_t)stages * kDecKeys * 4;
  m.sv = m.sk + (quant ? (size_t)stages * kDecKeys * 4 : 0);
  m.ml_warps = m.sv + (quant ? (size_t)stages * kDecKeys * 4 : 0);
  m.land = landing(m.ml_warps + 4 * (size_t)nrows * 2 * 4, splits, nrows, hd);
  return m;
}

// One block per (split, 16-head row tile of kv head h, slot); 4 warps. Block
// row i is query head h * rep + 16 rt + i. Warp w owns keys 16 w .. 16 w +
// 15 of each tile; a thread holds, per 8-wide column tile, columns 2 t and
// 2 t + 1 of rows g and g + 8 (g = lane / 4, t = lane % 4): the m16n8k16
// accumulator layout. KT = 16-wide head_dim steps (zero padded), NT = 8-wide
// output tiles. Registers are capped for 3 blocks an SM up to KT = 8.
template <typename TKV, int KT, typename Rows>
__global__ void __launch_bounds__(kDecThreads, KT <= 8 ? 3 : 1)
decode_kernel_mma(const __nv_bfloat16* __restrict__ q,
                  const TKV* __restrict__ k, const TKV* __restrict__ v,
                  Rows rows, const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int hd,
                  int n_rt, int stages, int copy_bytes, float scale_log2) {
  constexpr bool kQuant = Vec<TKV>::kScaled;
  constexpr int KS = KT * 8 + 4;  // tile row stride in words
  constexpr int NT = 2 * KT;
  const int split = blockIdx.x;
  const int h = blockIdx.y / n_rt, rt = blockIdx.y - h * n_rt;
  const int b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int r0 = rt * kDecRows;
  const int nrows = min(kDecRows, rep - r0);
  const int nrows_max = min(kDecRows, rep);  // the layout's (every rt's)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  cluster_arrive_relaxed();

  // the two first reads: the length, and (in the copies below) the table
  // entries of the first tiles, which do not depend on it
  const int len = lengths[b];
  int t0, t_end;
  rows.span(split, &t0, &t_end);

  // Q as A fragments: qa[kk] = rows (g, g + 8) x dims 16 kk + {2t, 2t + 8},
  // loaded beside the first copies
  const __nv_bfloat16* qb =
      q + ((size_t)b * Hq + (size_t)h * rep + r0) * hd;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (j & 1), d = 16 * kk + 2 * t + 8 * (j >> 1);
      qa[kk][j] = 0u;
      if (row < nrows && d < hd)
        qa[kk][j] =
            *reinterpret_cast<const uint32_t*>(qb + (size_t)row * hd + d);
    }

  const DecodeSmem lay = decode_smem(KT, hd, (int)sizeof(TKV), kQuant,
                                     stages, nrows_max, gridDim.x);
  extern __shared__ __align__(16) uint8_t smem_b[];
  int* valid = reinterpret_cast<int*>(smem_b + lay.valid);  // (stages, 64)
  float* sks = reinterpret_cast<float*>(smem_b + lay.sk);   // (stages, 64)
  float* svs = reinterpret_cast<float*>(smem_b + lay.sv);
  auto tile_words = [&](int st) {  // the bf16 K tile a product reads
    return reinterpret_cast<uint32_t*>(
        smem_b + (kQuant ? lay.conv : lay.ring + st * lay.stage));
  };

  // padding (head_dim past hd) reads as zeros in every bf16 tile; no copy
  // writes there, so this needs no barrier before the copies
  {
    const int pad = KT * 8 - hd / 2;
    const int n_tiles_bf16 = kQuant ? 1 : stages;
    for (int e = tid; e < n_tiles_bf16 * 2 * kDecKeys * pad;
         e += kDecThreads) {
      const int row = e / pad;
      uint32_t* w = tile_words(row / (2 * kDecKeys));
      w[(row % (2 * kDecKeys)) * KS + hd / 2 + e % pad] = 0u;
    }
  }

  const int t1 = min(t_end, len);
  const int n_tiles = t1 > t0 ? (t1 - t0 + kDecKeys - 1) / kDecKeys : 0;

  // a tile's copies: chunk e of K and of V is key e / cpr, bytes
  // (e % cpr) * copy_bytes of its row; a thread walks e = tid + i *
  // kDecThreads
  const int row_bytes = hd * (int)sizeof(TKV);
  const int cpr = row_bytes / copy_bytes;
  const int n_chunks = kDecKeys * cpr;
  const int step_key = kDecThreads / cpr, step_piece = kDecThreads % cpr;
  const char* kg = reinterpret_cast<const char*>(k + (size_t)h * hd);
  const char* vg = reinterpret_cast<const char*>(v + (size_t)h * hd);
  const int dst_row = kQuant ? row_bytes : KS * 4;
  auto issue = [&](int j) {
    const int st = j % stages;
    const int kb = t0 + j * kDecKeys;
    char* kdst = reinterpret_cast<char*>(smem_b + lay.ring + st * lay.stage);
    char* vdst = kdst + kDecKeys * dst_row;
    int key = tid / cpr, piece = tid % cpr;
    for (int e = tid; e < n_chunks; e += kDecThreads) {
      const int kpos = kb + key;
      int pg;
      const long long off = kpos < t1 ? rows.locate(b, kpos, &pg) : -1;
      const bool ok = off >= 0;
      const size_t src = (size_t)(ok ? off : 0) * sizeof(TKV) +
                         (size_t)piece * copy_bytes;
      const int dst = key * dst_row + piece * copy_bytes;
      if (copy_bytes == 16) {
        cp_async_16(kdst + dst, kg + src, ok);
        cp_async_16(vdst + dst, vg + src, ok);
      } else {
        cp_async_8(kdst + dst, kg + src, ok);
        cp_async_8(vdst + dst, vg + src, ok);
      }
      key += step_key;
      piece += step_piece;
      if (piece >= cpr) {
        piece -= cpr;
        ++key;
      }
    }
    // the tile's per-key table: valid flags, and the scales by cp.async in
    // the same group (zero for a key with no row)
    if (tid < kDecKeys) {
      const int kpos = kb + tid;
      int pg = 0;
      const long long off = kpos < t1 ? rows.locate(b, kpos, &pg) : -1;
      valid[st * kDecKeys + tid] = off >= 0;
      if constexpr (kQuant) {
        const size_t at = off >= 0 ? (size_t)pg * Hkv + h : 0;
        cp_async_4(sks + st * kDecKeys + tid, rows.k_scales + at, off >= 0);
        cp_async_4(svs + st * kDecKeys + tid, rows.v_scales + at, off >= 0);
      }
    }
  };
  // quantized: the warp's 16 keys of the landed raw K and V tiles of stage
  // st into its rows of the bf16 tile, exact (int8 and finite e4m3 values
  // are bf16 values), no scale. Lane l takes 8-byte pieces l, l + 32, ...
  // of the warp's rows walked at the padded width (2 KT pieces a row, a
  // compile-time count, so the loop unrolls with no division and its
  // loads are in flight together); pieces past hd are skipped. Only this
  // warp reads these rows, so a __syncwarp orders them.
  auto convert = [&](int st) {
    if constexpr (kQuant) {
      constexpr int kPieces = 2 * KT;  // 8-byte pieces of a padded row
      const uint8_t* src0 = smem_b + lay.ring + st * lay.stage;
      uint32_t* dst0 = tile_words(st);
      const int kw = 16 * warp;
#pragma unroll
      for (int i = 0; i < 2 * 16 * kPieces / 32; ++i) {
        const int u = lane + 32 * i;
        const int kv = u / (16 * kPieces), r = u % (16 * kPieces);
        const int row = kv * kDecKeys + kw + r / kPieces;
        const int d0 = 8 * (r % kPieces);
        if (d0 < row_bytes) {
          uint32_t w[4];
          Vec<TKV>::to_bf16(
              *reinterpret_cast<const uint2*>(src0 + row * row_bytes + d0),
              w);
          *reinterpret_cast<uint4*>(dst0 + row * KS + d0 / 2) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      __syncwarp();
    }
  };

  // prologue: the copies of the first `stages` tiles, one group each
  for (int s = 0; s < stages; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % stages;
    // tile j's group is the j-th; stages + j are committed
    cp_async_wait_upto(stages - 1);
    __syncthreads();  // tile j (and its table) visible to every warp
    convert(st);

    const uint32_t* ks = tile_words(st);
    const uint32_t* vs = ks + kDecKeys * KS;
    const int kw = 16 * warp;  // the warp's first key of the tile
    // scores of the 16 rows x the warp's 16 keys (two 8-key tiles); K's B
    // fragments for head_dim steps (kk, kk + 1) of keys kw + 8 jj .. + 7
    // come from one ldmatrix (lane L reads key kw + 8 jj + L % 8 at dims
    // 16 kk + 8 (L / 8))
    float s[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 2)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (kw + 8 * jj + (lane & 7)) * KS + 8 * kk +
                            4 * (lane >> 3));
        mma_bf16(s[jj], qa[kk], kb[0], kb[1]);
        mma_bf16(s[jj], qa[kk + 1], kb[2], kb[3]);
      }

    // online softmax in base 2: each row's 4 owners are lanes 4 g .. 4 g + 3
    const int* vf = valid + st * kDecKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = kw + 8 * jj + 2 * t;
      const int2 ok = *reinterpret_cast<const int2*>(vf + col);
      float2 sk = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        sk = *reinterpret_cast<const float2*>(sks + st * kDecKeys + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, cc = c & 1;
        const float x = s[jj][c] * (cc ? sk.y : sk.x) * scale_log2;
        s[jj][c] = (cc ? ok.y : ok.x) ? x : -INFINITY;
        mx[i] = fmaxf(mx[i], s[jj][c]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float2 sv = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        sv = *reinterpret_cast<const float2*>(svs + st * kDecKeys + kw +
                                              8 * jj + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = s[jj][c] == -INFINITY ? 0.f : exp2f(s[jj][c] - m[i]);
        sum[i] += p;
        // the V scale folds into P before its bf16 rounding
        s[jj][c] = kQuant ? p * ((c & 1) ? sv.y : sv.x) : p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
    // o = o * alpha + P V: the score accumulators are P's A fragment, in
    // bf16; V's B fragments for output tiles (n, n + 1) come from one
    // ldmatrix.trans of the warp's 16 keys (lane L reads key kw + L % 16
    // at dims 8 (n + L / 16))
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
      o[n + 1][0] *= alpha[0];
      o[n + 1][1] *= alpha[0];
      o[n + 1][2] *= alpha[1];
      o[n + 1][3] *= alpha[1];
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (kw + (lane & 15)) * KS +
                                4 * (n + (lane >> 4)));
      mma_bf16(o[n], pa, vb[0], vb[1]);
      mma_bf16(o[n + 1], pa, vb[2], vb[3]);
    }

    // every warp is done with stage st (and, quantized, with the bf16 tile)
    // before it is refilled
    if (j + 1 < n_tiles) __syncthreads();
    if (j + stages < n_tiles) issue(j + stages);
    cp_async_commit();
  }

  // Every copy has landed (the last tile's wait covered the last group), so
  // once every warp is done the ring's space takes the warps' accumulators:
  // acc (4, nrows, hd) and their (m, l).
  __syncthreads();
  float* acc = reinterpret_cast<float*>(smem_b);
  float* ml_w = reinterpret_cast<float*>(smem_b + lay.ml_warps);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (row >= nrows) continue;
    float* dst = acc + ((size_t)warp * nrows + row) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd)
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
    if (t == 0) {
      ml_w[2 * (warp * nrows + row)] = m[i];
      ml_w[2 * (warp * nrows + row) + 1] = l[i];
    }
  }
  __syncthreads();
  // the block's partial, the warps' states combined, straight into its slot
  // of rank 0's landing area
  cluster_wait_acquire();  // rank 0 has started: its landing area is live
  // (rank 0's own rows stay in place, in warp 0's: each element below is
  // read and written by one thread)
  float* dst_o = landing_o(smem_b, lay.land, acc, nrows, hd);
  float2* dst_ml = landing_ml(smem_b, lay.land, nrows);
  for (int e = tid; e < nrows * hd; e += kDecThreads) {
    const int r = e / hd;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mw = fmaxf(mw, ml_w[2 * (w * nrows + r)]);
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      x = fmaf(exp2f(ml_w[2 * (w * nrows + r)] - mw),
               acc[(size_t)w * nrows * hd + e], x);
    dst_o[e] = x;
  }
  for (int r = tid; r < nrows; r += kDecThreads) {
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mw = fmaxf(mw, ml_w[2 * (w * nrows + r)]);
    float lw = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      lw = fmaf(exp2f(ml_w[2 * (w * nrows + r)] - mw),
                ml_w[2 * (w * nrows + r) + 1], lw);
    dst_ml[r] = make_float2(mw, lw);
  }
  cluster_land<true>(smem_b, lay.land, acc, nrows, hd,
                     out + ((size_t)b * Hq + (size_t)h * rep + r0) * hd);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Raises `kernel`'s dynamic shared-memory limit to the card's, so its
// launches and occupancy queries may use up to kMaxSmem; each launcher
// below calls it once for its kernel (a static).
template <typename... Params>
int allow_smem(void (*kernel)(Params...)) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

inline cudaLaunchAttribute cluster_attr(int splits) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Clusters of `splits` blocks of `kernel` (threads each, smem bytes) that
// the card holds at once (cudaOccupancyMaxActiveClusters), remembered per
// (kernel, threads, smem, splits): a serving run meets a handful. Returns
// the count, or minus the CUDA error.
inline int active_clusters(const void* kernel, int threads, size_t smem,
                           int splits) {
  struct Fit {
    const void* kernel;
    int threads;
    size_t smem;
    int splits, active;
  };
  static std::mutex mu;
  static Fit seen[64];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].threads == threads &&
        seen[i].smem == smem && seen[i].splits == splits)
      return seen[i].active;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr = cluster_attr(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  if (n_seen < 64) seen[n_seen++] = Fit{kernel, threads, smem, splits, active};
  return active;
}

// A launch of `kernel` whose grid.x blocks form one cluster (the splits of
// one (slot, kv head)), with `smem` bytes of dynamic shared memory. Returns
// cudaGetLastError() after the launch.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  if (smem > (size_t)kMaxSmem || grid.x < 1 ||
      grid.x > (unsigned)kDecodeMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr = cluster_attr(grid.x);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int NI, typename Rows>
int decode_launch_ni(const TQ* q, const TKV* k, const TKV* v, Rows rows,
                     const int* lengths, TQ* out, int B, int Hq, int Hkv,
                     int hd, int splits, size_t rows_smem,
                     cudaStream_t stream) {
  constexpr int kUnroll = 16 / NI;
  const int rep = Hq / Hkv;
  const int n_rt = (rep + kDecRows - 1) / kDecRows;
  const int nrows = rep < kDecRows ? rep : kDecRows;
  const int warps = nrows < kDecodeMaxWarps ? nrows : kDecodeMaxWarps;
  // the landing area, then rank 0's own rows
  const size_t smem = (landing(rows_smem, splits, nrows, hd).end + 15) /
                         16 * 16 +
                     (size_t)nrows * hd * 4;
  auto kernel = decode_kernel<TQ, TKV, NI, kUnroll, Rows>;
  static const int smem_error = allow_smem(kernel);
  if (smem_error) return smem_error;
  return launch_cluster(kernel, dim3(splits, Hkv * n_rt, B), warps * 32,
                        smem, stream, q, k, v, rows, lengths, out, Hq, Hkv,
                        hd, n_rt, (int)rows_smem, 1.0f / sqrtf((float)hd));
}

// The scalar kernel: picks the lanes' elements per row (NI) from head_dim;
// only the NI a head_dim up to kDecodeMaxHeadDim can need are instantiated.
// `rows_smem` is the Rows policy's shared-memory need in bytes.
template <typename TQ, typename TKV, typename Rows>
int decode_launch(const void* q, const void* k, const void* v, Rows rows,
                  const int* lengths, void* out, int B, int Hq, int Hkv,
                  int hd, int splits, size_t rows_smem, cudaStream_t stream) {
  constexpr int kPerPass = 32 * Vec<TKV>::kN;  // elements a warp loads at once
  // rows are read eight bytes at a time
  if (hd % Vec<TKV>::kN || hd > kDecodeMaxHeadDim || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  TQ* ot = static_cast<TQ*>(out);
#define FLASH_DECODE_LAUNCH(NI)                                             \
  return decode_launch_ni<TQ, TKV, NI, Rows>(qt, kt, vt, rows, lengths, ot, \
                                             B, Hq, Hkv, hd, splits,        \
                                             rows_smem, stream)
  if (hd <= kPerPass) FLASH_DECODE_LAUNCH(1);
  if constexpr (kPerPass < kDecodeMaxHeadDim) {
    if (hd <= 2 * kPerPass) FLASH_DECODE_LAUNCH(2);
  }
  if constexpr (2 * kPerPass < kDecodeMaxHeadDim) {
    if (hd <= 4 * kPerPass) FLASH_DECODE_LAUNCH(4);
  }
#undef FLASH_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename TKV, int KT, typename Rows>
int decode_mma_launch_kt(const void* q, const void* k, const void* v,
                         Rows rows, const int* lengths, void* out, int B,
                         int Hq, int Hkv, int hd, int splits,
                         int keys_per_split, int copy_bytes,
                         cudaStream_t stream) {
  constexpr bool quant = Vec<TKV>::kScaled;
  auto kernel = decode_kernel_mma<TKV, KT, Rows>;
  static const int smem_error = allow_smem(kernel);
  if (smem_error) return smem_error;
  const int rep = Hq / Hkv;
  const int n_rt = (rep + kDecRows - 1) / kDecRows;
  const int nrows = rep < kDecRows ? rep : kDecRows;
  // Ring depth: every tile of a block in flight at once, up to
  // kDecMaxStages, as far as the card still holds the grid's clusters in as
  // few waves as with one stage (one stage at least).
  const int tiles = (keys_per_split + kDecKeys - 1) / kDecKeys;
  const long long clusters = (long long)Hkv * n_rt * B;
  auto smem_for = [&](int stages) {
    return decode_smem(KT, hd, (int)sizeof(TKV), quant, stages, nrows,
                       splits).land.end;
  };
  auto waves = [&](int stages, long long* w) {
    const int active = active_clusters((const void*)kernel, kDecThreads,
                                       smem_for(stages), splits);
    if (active < 0) return -active;
    *w = (clusters + (active > 0 ? active : 1) - 1) / (active > 0 ? active : 1);
    return 0;
  };
  long long w1;
  if (int e = waves(1, &w1)) return e;
  int stages = 1;
  for (int s = tiles < kDecMaxStages ? tiles : kDecMaxStages; s > 1; --s) {
    long long w;
    if (smem_for(s) > (size_t)kMaxSmem) continue;
    if (int e = waves(s, &w)) return e;
    if (w <= w1) {
      stages = s;
      break;
    }
  }
  return launch_cluster(
      kernel, dim3(splits, Hkv * n_rt, B), kDecThreads, smem_for(stages),
      stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const TKV*>(k), static_cast<const TKV*>(v), rows, lengths,
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, hd, n_rt, stages,
      copy_bytes, 1.4426950408889634f / sqrtf((float)hd));
}

// The tensor-core kernel: head_dim up to 256 in KT 16-wide steps (zero
// padded; KT even, as ldmatrix_x4 loads two steps of K). `keys_per_split` is
// the most keys a split holds; `aligned16` says every K/V row starts on 16
// bytes, so rows whose bytes are a multiple of 16 are copied in 16-byte
// pieces (8-byte ones otherwise).
template <typename TKV, typename Rows>
int decode_mma_launch(const void* q, const void* k, const void* v, Rows rows,
                      const int* lengths, void* out, int B, int Hq, int Hkv,
                      int hd, int splits, int keys_per_split, bool aligned16,
                      cudaStream_t stream) {
  if (hd % 4 || hd % Vec<TKV>::kN || hd < 1 || hd > kDecodeMaxHeadDim ||
      Hkv < 1 || Hq % Hkv || keys_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int row_bytes = hd * (int)sizeof(TKV);
  const int copy_bytes = aligned16 && row_bytes % 16 == 0 ? 16 : 8;
#define DECODE_MMA(KT)                                                      \
  if (hd <= 16 * KT)                                                        \
  return decode_mma_launch_kt<TKV, KT, Rows>(q, k, v, rows, lengths, out, B, \
                                             Hq, Hkv, hd, splits,            \
                                             keys_per_split, copy_bytes,     \
                                             stream)
  DECODE_MMA(2);
  DECODE_MMA(4);
  DECODE_MMA(6);
  DECODE_MMA(8);
  DECODE_MMA(12);
  DECODE_MMA(16);
#undef DECODE_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
