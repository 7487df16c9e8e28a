// Paged chunked-prefill attention for Hopper (sm_90a): R rows, each one
// slot's C-token prompt chunk, against a paged KV pool through the rows'
// block-table rows, in one launch.
//
// Replaces the TPU kernels
//   src/repro/kernels/paged_prefill_attention/kernel.py
//   paged_prefill_attention_ragged_pallas (_paged_pref_ragged_kernel), and
//   paged_prefill_attention_pallas (_paged_pref_kernel), which is this
//   kernel at R = 1, and their twins over an int8 / float8 e4m3 pool with
//   an f32 scale per (page, kv head),
//   paged_prefill_attention_ragged_quant_pallas and
//   paged_prefill_attention_quant_pallas (R = 1).
// and computes what they compute: row r's queries sit at absolute positions
// offsets[r] + (j mod C) and attend causally, kpos <= offsets[r] + (j mod C),
// to every key below offsets[r] + lens[r] that the slot holds (the chunk's
// own K/V is written before the read); pages past the covered range and
// unmapped (-1, or >= n_pages) pages admit no key; query rows past lens[r]
// are written as zeros (the caller discards them). A float pool may store
// another float type than the query's, as the Pallas kernels cast to f32
// inside.
//
// What bounds it on the H100: the larger of its bytes (q and out, each
// mapped K/V row of the row's range once, the scales of a quantized pool)
// over 3.35 TB/s and its flops, 4 * hd per (query, key) pair it attends,
// over the bf16 tensor-core rate (989 TFLOP/s). At the serving shapes
// (C = 128, contexts of a few hundred tokens, hd 128) the bytes bound it:
// about 4.1 us against 2.2 us of flops for qwen3-8b's ragged ingest.
//
// Two kernels, chosen by type in the C entry point (no fallback: each
// raises on what it does not take):
//  - paged_prefill_kernel_mma: a bfloat16 query over a bfloat16, int8 or
//    float8 e4m3 pool, every full-width engine's path. Both products run
//    on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//     * GQA packing: a block's 64 rows (4 warps of 16) are the q_per_kv
//       query heads of one kv head at BP = 64 / q_per_kv chunk positions,
//       so each K/V tile it loads serves the whole group (a group of more
//       than 64 heads is split over blocks of 64 heads, one position each).
//       Q stays in registers as A fragments for the block. Position tiles
//       run heaviest first, and a block loads only the key tiles up to its
//       last live position.
//     * Key tiles of 64 keys gathered through block_rows: key k0 + t lives
//       in page block_rows[r][(k0 + t) / ps] at row (k0 + t) % ps, so any
//       page size from 1 to 64 works and a tile may span pages. A small
//       per-key table (pool row, scales) is written a tile ahead into one
//       of three slots. Keys past the block's range and keys of unmapped
//       pages are zero-filled by the copy (src-size 0) and masked, so
//       whatever a pool holds there (NaN, extreme values) never reaches
//       P.V.
//     * Double-buffered cp.async stages: tile k + 1's copies are in flight
//       while tile k's products run; a tile costs one wait_group and one
//       barrier. 16-byte copies where the rows and pools allow them, 8-byte
//       ones otherwise (bf16 rows of hd 4 mod 8, int8 / fp8 rows of hd 8
//       mod 16, pools not on 16 bytes). Tile rows are padded to KT * 8 + 4
//       words so ldmatrix rows hit distinct banks; K's B fragments come
//       through ldmatrix, V's through ldmatrix.trans.
//     * The online softmax stays in registers (base 2, quad shuffles); P
//       is rounded to bf16 for P.V, where the plain version rounds its
//       probabilities to the bf16 pool's type.
//     * Quantized pools: every int8 value and every finite e4m3 value is
//       exactly a bf16, so each thread converts the raw bytes it copied
//       into the bf16 stage with no scale and no rounding. The K scale
//       goes on the score (s = (q . k_q) * sk[key] * softmax_scale), the V
//       scale on P before its bf16 rounding (p * sv[key]); the running sum
//       adds the unscaled p.
//     * Grid fill: 64-row blocks leave SMs idle where the grid is small
//       (qwen2-1.5b at R = 1: 26 blocks on 132 SMs; qwen3-8b: 64). There a
//       block takes two key groups of 4 warps, each walking every other
//       key tile with its own stages, and merges the two partial softmax
//       states through shared memory at the end: twice the warps on the
//       same SMs, half the tiles in each chain. Narrower row tiles (2 or 1
//       warps) spread the grid wider but load every K/V tile for fewer
//       rows, and lost at every timed shape when they were measured.
//       Splitting the keys across blocks would need a scratch buffer and a
//       merge launch the C interface does not carry.
//  - paged_prefill_kernel: a float32 query, or a float32 pool. Scalar f32
//    FMAs from shared memory, one page per tile, exact to the plain
//    version's f32 rounding (rtol = atol = 2e-5), which TF32 would break;
//    the float32 engines that chip_smoke.py holds against the CPU run it.
//    Each page tile is read in 8-byte pieces of the pool's type, kLoadBatch
//    of K and of V in flight per thread before any is converted, and
//    dequantized into the f32 tile by its (page, kv head) scale as it
//    lands (1 for a float pool). Grid (R, Hkv, ceil(q_per_kv * C /
//    kQTile)); query row j of (row, kv head) is head h * q_per_kv + j / C
//    at chunk position j % C.
//
// Layouts (all contiguous): q, out (R, C, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of the values in 8 bytes of the pool type;
// k/v scales (n_pages, Hkv) float32 (quantized pools only); block_rows (R,
// P) int32; offsets, lens (R,) int32.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kQTile = 32;
constexpr int kLoadBatch = 8;  // 8-byte pieces of K and of V in flight
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

size_t smem_bytes(int hd, int ps) {
  const int ld = hd + 1;  // padded row: conflict-free column reads
  return sizeof(float) * ((size_t)kQTile * ld + (size_t)ps * ld +
                          (size_t)ps * hd + (size_t)kQTile * hd +
                          (size_t)kQTile * ps + 4 * (size_t)kQTile);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const TQ* __restrict__ q,
                     const TKV* __restrict__ k_pages,
                     const TKV* __restrict__ v_pages,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ block_rows,
                     const int* __restrict__ offsets,
                     const int* __restrict__ lens, TQ* __restrict__ out,
                     int C, int Hq, int Hkv, int hd, int ps, int P,
                     int n_pages, float scale) {
  using V = Vec<TKV>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int j0 = blockIdx.z * kQTile;
  const int rep = Hq / Hkv;
  const int nq = min(kQTile, rep * C - j0);
  const int ld = hd + 1;
  const int tid = threadIdx.x;
  const int len = lens[r];
  const int off = offsets[r];

  // query row i of this block -> (head, chunk position)
  auto q_index = [&](int i) {
    const int j = j0 + i;
    return (((size_t)r * C + j % C) * Hq + (size_t)h * rep + j / C) * hd;
  };

  // the tile's last live chunk position (rows at positions >= len are
  // skipped); a tile with none exits after zero-filling its rows
  int last_c = -1;
  for (int i = 0; i < nq; ++i) {
    const int c = (j0 + i) % C;
    if (c < len) last_c = max(last_c, c);
  }
  if (last_c < 0) {
    for (int e = tid; e < nq * hd; e += kThreads)
      out[q_index(e / hd) + e % hd] = from_f32<TQ>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;                 // (kQTile, ld)
  float* ks = qs + kQTile * ld;     // (ps, ld)
  float* vs = ks + ps * ld;         // (ps, hd)
  float* acc = vs + ps * hd;        // (kQTile, hd)
  float* sc = acc + kQTile * hd;    // (kQTile, ps) scores, then probs
  float* m = sc + kQTile * ps;      // (kQTile,) running max
  float* l = m + kQTile;            // (kQTile,) running sum
  float* alpha = l + kQTile;        // (kQTile,) rescale of this page
  int* qpos = reinterpret_cast<int*>(alpha + kQTile);  // (kQTile,)

  for (int e = tid; e < kQTile * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    const bool live = i < nq && (j0 + i) % C < len;
    qs[i * ld + d] = live ? to_f32(q[q_index(i) + d]) : 0.f;
    acc[e] = 0.f;
  }
  for (int i = tid; i < kQTile; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
    // -1 marks a skipped row: it admits no key
    qpos[i] = (i < nq && (j0 + i) % C < len) ? off + (j0 + i) % C : -1;
  }
  __syncthreads();

  const int total = off + len;
  // pages the tile's causal window reaches: keys up to off + last_c
  const int n_live = min(min((total + ps - 1) / ps, (off + last_c) / ps + 1),
                         P);
  const size_t row_stride = (size_t)Hkv * hd;
  const int vec_per_row = hd / VEC;
  const int n_vec = ps * vec_per_row;
  for (int p = 0; p < n_live; ++p) {
    const int page = block_rows[(size_t)r * P + p];
    if (page < 0 || page >= n_pages) continue;  // same for every thread
    const int s0 = p * ps;
    const size_t base = (size_t)page * ps * row_stride + (size_t)h * hd;
    const float sk = k_scales ? k_scales[(size_t)page * Hkv + h] : 1.f;
    const float sv = v_scales ? v_scales[(size_t)page * Hkv + h] : 1.f;
    // the tile in 8-byte pieces: each thread issues kLoadBatch loads of K
    // and of V as raw bits before it converts any
    for (int e0 = 0; e0 < n_vec; e0 += kThreads * kLoadBatch) {
      Raw kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        const int t = e / vec_per_row;
        kr[j] = vr[j] = Raw{};
        if (e < n_vec && s0 + t < total) {
          const size_t o = base + (size_t)t * row_stride +
                           (size_t)(e % vec_per_row) * VEC;
          kr[j] = *reinterpret_cast<const Raw*>(k_pages + o);
          vr[j] = *reinterpret_cast<const Raw*>(v_pages + o);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        if (e >= n_vec) continue;
        const int t = e / vec_per_row, d = (e % vec_per_row) * VEC;
        float kf[VEC], vf[VEC];
        V::unpack(kr[j], kf);
        V::unpack(vr[j], vf);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          ks[t * ld + d + c] = kf[c] * sk;
          vs[t * hd + d + c] = vf[c] * sv;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < kQTile * ps; e += kThreads) {
      const int i = e / ps, t = e % ps;
      const int kpos = s0 + t;
      float s = kNegInf;
      if (kpos < total && kpos <= qpos[i]) {
        const float* qr = qs + i * ld;
        const float* kt = ks + t * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();
    for (int i = tid; i < kQTile; i += kThreads) {
      float* sr = sc + i * ps;
      float mx = m[i];
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const int kpos = s0 + t;
        const float pr =
            (kpos < total && kpos <= qpos[i]) ? expf(sr[t] - mx) : 0.f;
        sr[t] = pr;
        sum += pr;
      }
      const float a = expf(m[i] - mx);
      alpha[i] = a;
      l[i] = l[i] * a + sum;
      m[i] = mx;
    }
    __syncthreads();
    for (int e = tid; e < kQTile * hd; e += kThreads) {
      const int i = e / hd, d = e % hd;
      const float* pr = sc + i * ps;
      float o = acc[e] * alpha[i];
      for (int t = 0; t < ps; ++t) o = fmaf(pr[t], vs[t * hd + d], o);
      acc[e] = o;
    }
    __syncthreads();
  }

  for (int e = tid; e < nq * hd; e += kThreads) {
    const int i = e / hd;
    const float den = l[i];
    out[q_index(i) + e % hd] =
        from_f32<TQ>(acc[e] / (den == 0.f ? 1.f : den));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 queries on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK = 64;        // keys per tile of the mma kernel
constexpr int kRows = 64;      // block rows of a key group: 4 warps of 16
constexpr int kInfoSlots = 3;  // per-key tables: written a tile ahead

// Shared memory of one key group, in 4-byte words: two bf16 stages of K and
// V tiles, rows of KT * 16 bf16 plus 8 of padding (KT * 8 + 4 words: 4 mod
// 8, an odd number of 16-byte units, so the 8 rows of an ldmatrix land on
// distinct bank groups); over a quantized pool
// one raw K and V tile (hd bytes a key) that the copies land in; then
// kInfoSlots slots of the per-key table: each key's pool row (-1: masked)
// and, quantized, its K and V scales.
struct GroupSmem {
  size_t tile, raw, info, words;  // a stage, the raw tiles, a slot; all
};
__host__ __device__ GroupSmem group_smem(int kt, int hd, bool quant) {
  GroupSmem m;
  m.tile = 2 * (size_t)kBK * (kt * 8 + 4);          // K and V
  m.raw = quant ? 2 * (size_t)kBK * hd / 4 : 0;     // K and V, raw bytes
  m.info = (quant ? 3 : 1) * (size_t)kBK;
  m.words = 2 * m.tile + m.raw + kInfoSlots * m.info;
  return m;
}
size_t mma_smem_bytes(int kt, int hd, bool quant, int key_groups) {
  return sizeof(uint32_t) * key_groups * group_smem(kt, hd, quant).words;
}

// Barrier of one key group's kThreads threads: named barrier 1 or 2
// (immediate ids: a barrier id held in a register reserves all 16 of the
// SM's).
__device__ __forceinline__ void group_sync(int group) {
  if (group == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads) : "memory");
}

// Warp w of a key group owns block rows 16 w + g and 16 w + g + 8 (g =
// lane / 4); a thread holds, per 8-wide column tile, columns 2 t and 2 t +
// 1 (t = lane % 4) of both rows: the m16n8k16 accumulator layout. A block
// takes HB heads of kv head h's group (all q_per_kv of them when they fit
// in 64 rows) from head h0 on: block row i is query head h * rep + h0 + i
// / np at chunk position p0 + i % np. KT = 16-wide head_dim steps of Q.K^T
// (head_dim zero padded), NT = 8-wide output tiles. With two key groups
// their partial softmax states are merged through shared memory at the end.
template <typename TKV, int KT>
__global__ void __launch_bounds__(2 * kThreads)
paged_prefill_kernel_mma(const __nv_bfloat16* __restrict__ q,
                         const TKV* __restrict__ k_pages,
                         const TKV* __restrict__ v_pages,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const int* __restrict__ block_rows,
                         const int* __restrict__ offsets,
                         const int* __restrict__ lens,
                         __nv_bfloat16* __restrict__ out, int C, int Hq,
                         int Hkv, int hd, int ps, int P, int n_pages, int HB,
                         int key_groups, int copy_bytes, float scale_log2) {
  constexpr bool kQuant = Vec<TKV>::kScaled;
  constexpr int KS = KT * 8 + 4;  // tile row stride in words
  constexpr int NT = 2 * KT;
  constexpr int NJ = kBK / 8;     // 8-wide key tiles of a tile
  const int rep = Hq / Hkv, BP = kRows / HB;
  const int n_split = (rep + HB - 1) / HB;      // blocks a GQA group takes
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y / n_split, r = blockIdx.z;
  const int h0 = (blockIdx.y % n_split) * HB;   // the block's first head
  const int p0 = tile * BP;
  const int np = min(BP, C - p0);  // chunk positions of this block
  const int nrows = np * min(HB, rep - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / 4, gtid = tid - group * kThreads;
  const int rw = warp % 4;             // row warp within the group
  const int len = lens[r], off = offsets[r];
  const int live_end = min(p0 + np, len);  // live positions: [p0, live_end)

  auto q_off = [&](int i) {
    return (((size_t)r * C + p0 + i % np) * Hq + (size_t)h * rep + h0 +
            i / np) *
           hd;
  };
  if (live_end <= p0) {  // no live row: zeros, as the scalar kernel writes
    for (int e = tid; e < nrows * (hd / 2); e += blockDim.x)
      *reinterpret_cast<uint32_t*>(out + q_off(e / (hd / 2)) +
                                   2 * (e % (hd / 2))) = 0u;
    return;
  }
  // keys the block's live rows reach (all below off + len); the group's
  // tiles are group, group + key_groups, ...
  const int kend = off + live_end;
  const int n_tiles = (kend + kBK - 1) / kBK;
  const int n_mine =
      max(0, (n_tiles - group + key_groups - 1) / key_groups);

  const GroupSmem lay = group_smem(KT, hd, kQuant);
  extern __shared__ __align__(16) uint32_t smem_w[];
  uint32_t* stages = smem_w + group * lay.words;    // (2, 2, kBK, KS)
  uint8_t* raw = reinterpret_cast<uint8_t*>(stages + 2 * lay.tile);
  int* info = reinterpret_cast<int*>(raw) + lay.raw;
  // slot s: pool rows at info[s * lay.info], then (quantized) K, V scales
  auto slot_rows = [&](int s) { return info + s * lay.info; };
  auto slot_sk = [&](int s) {
    return reinterpret_cast<float*>(info + s * lay.info + kBK);
  };
  auto slot_sv = [&](int s) {
    return reinterpret_cast<float*>(info + s * lay.info + 2 * kBK);
  };

  // padding (head_dim past hd) reads as zeros in every stage
  for (int e = gtid; e < 2 * lay.tile; e += kThreads)
    stages[e] = 0u;

  int row[2], pos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = 16 * rw + g + 8 * i;
    const int c = p0 + row[i] % np;
    live[i] = row[i] < nrows && c < len;
    pos[i] = off + c;
  }
  // Q as A fragments: a[kk] = rows (g, g + 8) x dims 16 kk + {2t, 2t + 8}
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1, d = 16 * kk + 2 * t + 8 * (j >> 1);
      qa[kk][j] = 0u;
      if (live[i] && d < hd)
        qa[kk][j] = *reinterpret_cast<const uint32_t*>(q + q_off(row[i]) + d);
    }

  // the per-key table of the group's j-th tile: the pool row of each key
  // (-1: past the block's keys, past the block row, or an unmapped page)
  // and the scales
  auto key_info = [&](int j) {
    const int k0 = (group + j * key_groups) * kBK, s = j % kInfoSlots;
    for (int kt = gtid; kt < kBK; kt += kThreads) {
      const int kpos = k0 + kt;
      int prow = -1;
      float sk = 0.f, sv = 0.f;
      if (kpos < kend) {
        const int pi = kpos / ps;
        const int page = pi < P ? block_rows[(size_t)r * P + pi] : -1;
        if (page >= 0 && page < n_pages) {
          prow = page * ps + kpos % ps;
          if constexpr (kQuant) {
            sk = k_scales[(size_t)page * Hkv + h];
            sv = v_scales[(size_t)page * Hkv + h];
          }
        }
      }
      slot_rows(s)[kt] = prow;
      if constexpr (kQuant) {
        slot_sk(s)[kt] = sk;
        slot_sv(s)[kt] = sv;
      }
    }
  };

  // a tile's copies: chunk e of K and of V is key e / cpr, bytes
  // (e % cpr) * copy_bytes of its row; a thread walks e = gtid + i *
  // kThreads and later converts (quantized) exactly the chunks it copied
  const size_t row_elems = (size_t)Hkv * hd;
  const int row_bytes = hd * (int)sizeof(TKV);
  const int cpr = row_bytes / copy_bytes;
  const int n_chunks = kBK * cpr;
  const int step_key = kThreads / cpr, step_piece = kThreads % cpr;
  const char* kg = reinterpret_cast<const char*>(k_pages + (size_t)h * hd);
  const char* vg = reinterpret_cast<const char*>(v_pages + (size_t)h * hd);
  auto start_copies = [&](int j) {
    const int* prows = slot_rows(j % kInfoSlots);
    char* kdst = kQuant ? reinterpret_cast<char*>(raw)
                        : reinterpret_cast<char*>(stages + (j % 2) * lay.tile);
    char* vdst = kdst + (kQuant ? kBK * row_bytes : kBK * KS * 4);
    const int dst_row = kQuant ? row_bytes : KS * 4;
    int key = gtid / cpr, piece = gtid % cpr;
    for (int e = gtid; e < n_chunks; e += kThreads) {
      const int prow = prows[key];
      const size_t src = (size_t)max(prow, 0) * row_elems * sizeof(TKV) +
                         (size_t)piece * copy_bytes;
      const int dst = key * dst_row + piece * copy_bytes;
      if (copy_bytes == 16) {
        cp_async_16(kdst + dst, kg + src, prow >= 0);
        cp_async_16(vdst + dst, vg + src, prow >= 0);
      } else {
        cp_async_8(kdst + dst, kg + src, prow >= 0);
        cp_async_8(vdst + dst, vg + src, prow >= 0);
      }
      key += step_key;
      piece += step_piece;
      if (piece >= cpr) {
        piece -= cpr;
        ++key;
      }
    }
  };
  // quantized: the thread's landed raw chunks of the j-th tile into its
  // bf16 stage, exact (int8 and finite e4m3 values are bf16 values), no
  // scale applied
  auto convert = [&](int j) {
    using V = Vec<TKV>;
    const uint8_t* src0 = raw;
    uint32_t* dst0 = stages + (j % 2) * lay.tile;
    int key = gtid / cpr, piece = gtid % cpr;
    for (int e = gtid; e < n_chunks; e += kThreads) {
      const int d0 = piece * copy_bytes;  // one byte a value
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint8_t* src = src0 + (kv * kBK + key) * row_bytes + d0;
        uint32_t* dst = dst0 + (kv * kBK + key) * KS + d0 / 2;
        for (int c = 0; c < copy_bytes; c += 8) {
          float f[8];
          V::unpack(*reinterpret_cast<const uint2*>(src + c), f);
          *reinterpret_cast<uint4*>(dst + c / 2) =
              make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
      }
      key += step_key;
      piece += step_piece;
      if (piece >= cpr) {
        piece -= cpr;
        ++key;
      }
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

  // prologue: the table and copies of the group's first tile
  if (n_mine > 0) key_info(0);
  group_sync(group);
  if (n_mine > 0) start_copies(0);
  cp_async_commit();
  for (int j = 0; j < n_mine; ++j) {
    const int k0 = (group + j * key_groups) * kBK;
    const bool next = j + 1 < n_mine;
    // tile j + 1's table slot was last read by tile j - 2, done before the
    // previous barrier
    if (next) key_info(j + 1);
    cp_async_wait_group<0>();
    if constexpr (kQuant) convert(j);
    // tile j has landed for the group; every thread is done with tile
    // j - 1, whose stage takes tile j + 1's copies (quantized: each thread
    // has converted the raw chunks its next copies overwrite)
    group_sync(group);
    if (next) {
      start_copies(j + 1);
      cp_async_commit();
    }
    const uint32_t* ks = stages + (j % 2) * lay.tile;
    const uint32_t* vs = ks + kBK * KS;
    const int sl = j % kInfoSlots;
    const int* prow = slot_rows(sl);

    // scores of the warp's 16 rows x kBK keys
    float s[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
    // K's B fragments for head_dim steps (kk, kk + 1) of keys 8 jj .. 8 jj
    // + 7 come from one ldmatrix (lane L reads key 8 jj + L % 8 at dims
    // 16 kk + 8 (L / 8))
#pragma unroll
    for (int kk = 0; kk < KT; kk += 2)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (8 * jj + (lane & 7)) * KS + 8 * kk +
                            4 * (lane >> 3));
        mma_bf16(s[jj], qa[kk], kb[0], kb[1]);
        mma_bf16(s[jj], qa[kk + 1], kb[2], kb[3]);
      }

    // online softmax in base 2: each row's 4 owners are lanes 4 g .. 4 g + 3
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = 8 * jj + 2 * t;
      const int2 pr = *reinterpret_cast<const int2*>(prow + col);
      float2 sk = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        sk = *reinterpret_cast<const float2*>(slot_sk(sl) + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, cc = c & 1;
        const bool keep = live[i] && (cc ? pr.y : pr.x) >= 0 &&
                          k0 + col + cc <= pos[i];
        const float x = s[jj][c] * (cc ? sk.y : sk.x) * scale_log2;
        s[jj][c] = keep ? x : -INFINITY;
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
    for (int jj = 0; jj < NJ; ++jj) {
      float2 sv = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        sv = *reinterpret_cast<const float2*>(slot_sv(sl) + 8 * jj + 2 * t);
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
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V: the score accumulators are P's A fragments, in bf16; V's
    // B fragments for output tiles (n, n + 1) come from one ldmatrix.trans
    // of keys 16 kk .. 16 kk + 15 (lane L reads row 16 kk + L % 16 at
    // dims 8 (n + L / 16))
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 15)) * KS +
                                  4 * (n + (lane >> 4)));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  if (key_groups == 2) {
    // group 1 hands its rows' (m, l, o) to group 0 through the stages
    float* mo = reinterpret_cast<float*>(smem_w);  // (kRows, 16 KT + 2)
    constexpr int LD = 16 * KT + 2;
    __syncthreads();
    if (group == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* dst = mo + row[i] * LD;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          dst[8 * n + 2 * t] = o[n][2 * i];
          dst[8 * n + 2 * t + 1] = o[n][2 * i + 1];
        }
        if (t == 0) {
          dst[16 * KT] = m[i];
          dst[16 * KT + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (group == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* src = mo + row[i] * LD;
      const float m1 = src[16 * KT], l1 = src[16 * KT + 1];
      const float m_new = fmaxf(m[i], m1);
      const float a0 = exp2f(m[i] - m_new), a1 = exp2f(m1 - m_new);
      l[i] = l[i] * a0 + l1 * a1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * i] = o[n][2 * i] * a0 + src[8 * n + 2 * t] * a1;
        o[n][2 * i + 1] = o[n][2 * i + 1] * a0 + src[8 * n + 2 * t + 1] * a1;
      }
    }
  }

  // every block row below nrows is written: dead rows (past lens[r]) have
  // o = 0 and l = 0, so zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= nrows) continue;
    const size_t at = q_off(row[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd)
        *reinterpret_cast<uint32_t*>(out + at + d) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales,
           const int* block_rows, const int* offsets, const int* lens,
           void* out, int R, int C, int Hq, int Hkv, int hd, int ps, int P,
           int n_pages, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, ps);
  if (smem > (size_t)kMaxSmem || hd % Vec<TKV>::kN)
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel<TQ, TKV>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rep = Hq / Hkv;
  const dim3 grid(R, Hkv, (rep * C + kQTile - 1) / kQTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, block_rows,
      offsets, lens, static_cast<TQ*>(out), C, Hq, Hkv, hd, ps, P, n_pages,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// head_dim's 16-wide steps in the mma kernel's instances (0: too wide)
int kt_for(int hd) {
  constexpr int kKT[] = {2, 4, 6, 8, 12, 16};
  for (int kt : kKT)
    if (hd <= 16 * kt) return kt;
  return 0;
}

template <typename TKV, int KT>
int launch_mma_kt(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scales, const float* v_scales,
                  const int* block_rows, const int* offsets, const int* lens,
                  void* out, int R, int C, int Hq, int Hkv, int hd, int ps,
                  int P, int n_pages, cudaStream_t stream) {
  constexpr bool quant = Vec<TKV>::kScaled;
  const int rep = Hq / Hkv;
  const int HB = min(rep, kRows), BP = kRows / HB;
  const dim3 grid((C + BP - 1) / BP, Hkv * ((rep + HB - 1) / HB), R);
  // two key groups where the grid leaves SMs without a block (R = 1, few
  // kv heads) and their stages fit
  const long blocks = (long)grid.x * grid.y * grid.z;
  const int key_groups =
      blocks < sm_count() &&
              mma_smem_bytes(KT, hd, quant, 2) <= (size_t)kMaxSmem
          ? 2
          : 1;
  const size_t smem = mma_smem_bytes(KT, hd, quant, key_groups);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel_mma<TKV, KT>;
  static size_t smem_set = kDefaultSmem;  // the kernel's dynamic limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  // 16-byte copies where every row starts on 16 bytes, else 8-byte ones
  const int row_bytes = hd * (int)sizeof(TKV);
  const bool c16 = row_bytes % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k_pages) |
                    reinterpret_cast<uintptr_t>(v_pages)) % 16 == 0;
  kernel<<<grid, kThreads * key_groups, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, block_rows,
      offsets, lens, static_cast<__nv_bfloat16*>(out), C, Hq, Hkv, hd, ps, P,
      n_pages, HB, key_groups, c16 ? 16 : 8,
      1.4426950408889634f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// head_dim up to 256 in KT 16-wide steps (zero padded), as flash's mma
// kernel
template <typename TKV>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const float* k_scales, const float* v_scales,
               const int* block_rows, const int* offsets, const int* lens,
               void* out, int R, int C, int Hq, int Hkv, int hd, int ps,
               int P, int n_pages, cudaStream_t s) {
  if (hd % Vec<TKV>::kN || hd % 4) return (int)cudaErrorInvalidValue;
#define PREFILL_MMA(KT)                                                      \
  case KT:                                                                   \
    return launch_mma_kt<TKV, KT>(q, k_pages, v_pages, k_scales, v_scales,   \
                                  block_rows, offsets, lens, out, R, C, Hq,  \
                                  Hkv, hd, ps, P, n_pages, s)
  switch (kt_for(hd)) {
    PREFILL_MMA(2);
    PREFILL_MMA(4);
    PREFILL_MMA(6);
    PREFILL_MMA(8);
    PREFILL_MMA(12);
    PREFILL_MMA(16);
  }
#undef PREFILL_MMA
  return (int)cudaErrorInvalidValue;
}

// Routing by type: a bfloat16 query over a bfloat16, int8 or fp8 pool runs
// on the tensor cores; a float32 query, or a float32 pool, on the scalar
// kernel.
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* block_rows, const void* offsets, const void* lens,
             void* out, int R, int C, int Hq, int Hkv, int hd, int ps, int P,
             int n_pages, int q_dtype, int kv_dtype, void* stream) {
  if (R == 0 || C == 0) return 0;
  const bool quant = kv_dtype >= 2;
  if (quant != (k_scales != nullptr) || quant != (v_scales != nullptr) ||
      Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* rows = static_cast<const int*>(block_rows);
  const int* offs = static_cast<const int*>(offsets);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL_ARGS                                                         \
  q, k_pages, v_pages, ks, vs, rows, offs, ln, out, R, C, Hq, Hkv, hd, ps, P, \
      n_pages
  if (q_dtype == 1 && kv_dtype != 0) {
    switch (kv_dtype) {
      case 1: return launch_mma<__nv_bfloat16>(PREFILL_ARGS, s);
      case 2: return launch_mma<int8_t>(PREFILL_ARGS, s);
      case 3: return launch_mma<__nv_fp8_e4m3>(PREFILL_ARGS, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (q_dtype == 1) return launch<__nv_bfloat16, float>(PREFILL_ARGS, s);
  if (q_dtype != 0) return (int)cudaErrorInvalidValue;
  switch (kv_dtype) {
    case 0: return launch<float, float>(PREFILL_ARGS, s);
    case 1: return launch<float, __nv_bfloat16>(PREFILL_ARGS, s);
    case 2: return launch<float, int8_t>(PREFILL_ARGS, s);
    case 3: return launch<float, __nv_fp8_e4m3>(PREFILL_ARGS, s);
  }
#undef PREFILL_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (pools): 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = float8 e4m3; the scales are given
// for 2 and 3 and null otherwise. Returns cudaGetLastError() after the
// launch, 0 on success.
int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const void* block_rows,
                            const void* offsets, const void* lens, void* out,
                            int R, int C, int Hq, int Hkv, int hd, int ps,
                            int P, int n_pages, int q_dtype, int kv_dtype,
                            void* stream) {
  return dispatch(q, k_pages, v_pages, k_scales, v_scales, block_rows,
                  offsets, lens, out, R, C, Hq, Hkv, hd, ps, P, n_pages,
                  q_dtype, kv_dtype, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
