// Full-sequence flash attention for Hopper (sm_90a): every query position of
// a (B, S) batch against the same sequence's keys, GQA, forward only.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py
//   flash_attention_pallas (_fa_kernel)
// and computes what it computes: s = (q . k) / sqrt(hd); with a softcap,
// s = tanh(s / softcap) * softcap; then the mask keeps key c for query row
// r where c <= r (causal) and c > r - window (window > 0); an online
// softmax in float32 over the kept keys; out = sum p v / sum p in the
// input dtype. KV tiles that lie wholly outside a block's mask (above the
// causal diagonal, left of the window) are never loaded. Any S works: the
// last query block and the last KV tile overhang S and are masked (the
// TPU wrapper instead halves its tiles until they divide S).
//
// What bounds it on the H100: its flops, 4 * hd per (query, key) pair the
// mask keeps, over the card's peak rate (989 TFLOP/s on the bf16 tensor
// cores); its bytes (q, k, v read once, out written once) are smaller at
// every serving shape.
//
// What the design does: one block of 128 threads (4 warps) per (batch, kv
// head, tile of 64 query rows). The block's query rows are every query
// head of the kv head's group at BP = 64 / q_per_kv positions, so each K/V
// tile it loads serves all q_per_kv heads. The TPU's sequential KV grid
// axis with carried VMEM scratch becomes a loop over KV tiles inside the
// block, with the softmax state (max, sum) and the (rows, hd) accumulator
// in registers, all float32. K/V tiles are read in 8-byte pieces,
// kLoadBatch of K and of V in flight per thread before any is stored.
//  - bfloat16 (flash_kernel_mma): both products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style:
//    each warp owns 16 query rows; Q stays in registers as A fragments
//    for the whole block; K and V tiles are staged row-major in shared
//    memory with rows padded so that fragment loads hit distinct banks,
//    and V's B fragments come through ldmatrix.trans; the score
//    accumulators become the P.V product's A fragments in registers,
//    rounded to bf16 as the plain version rounds its probabilities to v's
//    dtype.
//  - float32 (flash_kernel): scalar FMAs from shared memory, register-
//    tiled (a thread computes a 4 x 4 block of scores and a 4 x (hd / 8)
//    block of the output), which keeps the float32 path exact to the plain
//    version's rounding (tolerance 2e-5) at a fraction of the card's rate.
//
// Layouts (all contiguous): q, out (B, S, Hq, hd); k, v (B, S, Hkv, hd);
// head_dim a multiple of 4 up to 256; query head j reads kv head
// j / q_per_kv.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kRows = 64;       // query rows per block
constexpr int kBK = 32;         // keys per KV tile
constexpr int kLoadBatch = 8;   // 8-byte pieces of K and of V in flight
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// thread (ty, tx) = (tid / 8, tid % 8) owns score rows ty + 16 i (i < 4),
// score columns tx + 8 j (j < 4) and output dims tx + 8 j (j < DC)
constexpr int kTY = 16, kTX = 8, kRI = kRows / kTY, kCJ = kBK / kTX;

size_t smem_floats(int hd, int dc) {
  const int ld = hd + 1;  // padded rows: conflict-free column reads
  return (size_t)kRows * ld + (size_t)kBK * ld + (size_t)kBK * kTX * dc +
         (size_t)kRows * (kBK + 1);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
             int Hkv, int hd, int BP, int causal, int window, float softcap,
             float scale) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  constexpr int HDP = kTX * DC;  // V tile row stride (>= hd, zero padded)
  const int rep = Hq / Hkv;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int p0 = tile * BP;
  const int np = min(BP, S - p0);  // positions of this block
  const int nrows = np * rep;      // row r: head h * rep + r / np,
                                   //        position p0 + r % np
  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int ld = hd + 1;
  const int vec_per_row = hd / VEC;

  extern __shared__ float smem[];
  float* qs = smem;                // (kRows, ld)
  float* ks = qs + kRows * ld;     // (kBK, ld)
  float* vs = ks + kBK * ld;       // (kBK, HDP)
  float* ps = vs + kBK * HDP;      // (kRows, kBK + 1)

  auto q_off = [&](int r) {
    const int pos = p0 + r % np, head = h * rep + r / np;
    return (((size_t)b * S + pos) * Hq + head) * hd;
  };

  // the block's query rows, float32; rows past nrows read as zeros
  for (int e = tid; e < kRows * vec_per_row; e += kThreads) {
    const int r = e / vec_per_row, d = (e % vec_per_row) * VEC;
    Raw raw = {};
    if (r < nrows) raw = *reinterpret_cast<const Raw*>(q + q_off(r) + d);
    float f[VEC];
    V::unpack(raw, f);
#pragma unroll
    for (int c = 0; c < VEC; ++c) qs[r * ld + d + c] = f[c];
  }
  // V rows' padding past hd stays zero for every tile
  for (int e = tid; e < kBK * HDP; e += kThreads) vs[e] = 0.f;

  int pos_i[kRI];
  bool row_ok[kRI];
  float m[kRI], l[kRI], acc[kRI][DC];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + kTY * i;
    row_ok[i] = r < nrows;
    pos_i[i] = row_ok[i] ? p0 + r % np : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // the KV tiles the block's mask reaches
  const int k_end = causal ? min(S, p0 + np) : S;
  const int k_begin = window ? max(0, p0 - window + 1) : 0;
  const size_t kv_row = (size_t)Hkv * hd;
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)h * hd;
  const int n_vec = kBK * vec_per_row;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e0 = 0; e0 < n_vec; e0 += kThreads * kLoadBatch) {
      Raw kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        const int t = e / vec_per_row;
        kr[j] = vr[j] = Raw{};
        if (e < n_vec && k0 + t < S) {
          const size_t o = kv_base + (size_t)(k0 + t) * kv_row +
                           (size_t)(e % vec_per_row) * VEC;
          kr[j] = *reinterpret_cast<const Raw*>(k + o);
          vr[j] = *reinterpret_cast<const Raw*>(v + o);
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
          ks[t * ld + d + c] = kf[c];
          vs[t * HDP + d + c] = vf[c];
        }
      }
    }
    __syncthreads();

    // scores of the thread's 4 x 4 block
    float s[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRI], kv[kCJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) qv[i] = qs[(ty + kTY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) kv[j] = ks[(tx + kTX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; a row's 8 owners are lanes of one warp
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      bool keep[kCJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kpos = k0 + tx + kTX * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        keep[j] = row_ok[i] && kpos < S && (!causal || kpos <= pos_i[i]) &&
                  (!window || kpos > pos_i[i] - window);
        s[i][j] = x;
        if (keep[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < kTX; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + kTY * i) * (kBK + 1) + tx + kTX * j] = p;
      }
#pragma unroll
      for (int o = 1; o < kTX; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile
    for (int c = 0; c < kBK; ++c) {
      float pv[kRI], vv[DC];
#pragma unroll
      for (int i = 0; i < kRI; ++i) pv[i] = ps[(ty + kTY * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * HDP + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    if (!row_ok[i]) continue;
    const size_t o = q_off(ty + kTY * i);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + kTX * j;
      if (d < hd) out[o + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBKm = 64;  // keys per KV tile of the mma kernel

// K and V tile rows hold KT * 16 bf16 plus 8 of padding: KT * 8 + 4 words.
// That stride is 4 mod 8 words, so the 8 x 4 lanes of a K fragment load
// land on 32 distinct banks and the 8 rows of an ldmatrix (16 bytes each,
// an odd number of 16-byte units apart) on distinct bank groups.
size_t mma_smem_bytes(int kt) {
  return sizeof(uint32_t) * 2 * (size_t)kBKm * (kt * 8 + 4);
}

// Warp w owns block rows 16 w + g and 16 w + g + 8 (g = lane / 4); a
// thread holds, per 8-wide column tile, columns 2 t and 2 t + 1 (t =
// lane % 4) of both rows: the m16n8k16 accumulator layout. KT = 16-wide
// head_dim steps of Q.K^T (head_dim zero padded), NT = 8-wide output tiles.
template <int KT, int NT>
__global__ void __launch_bounds__(kThreads)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                 int hd, int BP, int causal, int window, float softcap,
                 float scale) {
  using V = Vec<__nv_bfloat16>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  constexpr int KS = KT * 8 + 4;  // row stride in words (mma_smem_bytes)
  constexpr int NJ = kBKm / 8;  // 8-wide key tiles of a KV tile
  const int rep = Hq / Hkv;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int p0 = tile * BP;
  const int np = min(BP, S - p0);
  const int nrows = np * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ uint32_t smem_w[];
  uint32_t* ks = smem_w;                            // (kBKm, KS) words
  uint32_t* vs = ks + kBKm * KS;                    // (kBKm, KS) words

  // padding (head_dim past hd) reads as zeros in every tile
  for (int e = tid; e < 2 * kBKm * KS; e += kThreads) smem_w[e] = 0u;

  int row[2], pos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = 16 * warp + g + 8 * i;
    row_ok[i] = row[i] < nrows;
    pos[i] = row_ok[i] ? p0 + row[i] % np : 0;
  }
  auto q_off = [&](int r) {
    return (((size_t)b * S + p0 + r % np) * Hq + (size_t)h * rep + r / np) *
           hd;
  };
  // Q as A fragments: a[kk] = rows (g, g + 8) x dims 16 kk + {2t, 2t + 8}
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1, d = 16 * kk + 2 * t + 8 * (j >> 1);
      qa[kk][j] = 0u;
      if (row_ok[i] && d < hd)
        qa[kk][j] = *reinterpret_cast<const uint32_t*>(q + q_off(row[i]) + d);
    }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

  const int k_end = causal ? min(S, p0 + np) : S;
  const int k_begin = window ? max(0, p0 - window + 1) : 0;
  const size_t kv_row = (size_t)Hkv * hd;
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)h * hd;
  const int vec_per_row = hd / VEC;
  const int n_vec = kBKm * vec_per_row;

  for (int k0 = (k_begin / kBKm) * kBKm; k0 < k_end; k0 += kBKm) {
    __syncthreads();  // the previous tile's readers are done
    for (int e0 = 0; e0 < n_vec; e0 += kThreads * kLoadBatch) {
      Raw kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        const int key = e / vec_per_row;
        kr[j] = vr[j] = Raw{};  // keys past S stay zero: no NaN in P.V
        if (e < n_vec && k0 + key < S) {
          const size_t off = kv_base + (size_t)(k0 + key) * kv_row +
                             (size_t)(e % vec_per_row) * VEC;
          kr[j] = *reinterpret_cast<const Raw*>(k + off);
          vr[j] = *reinterpret_cast<const Raw*>(v + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = e0 + j * kThreads + tid;
        if (e >= n_vec) continue;
        const int key = e / vec_per_row, d = (e % vec_per_row) * VEC;
        *reinterpret_cast<Raw*>(ks + key * KS + d / 2) = kr[j];
        *reinterpret_cast<Raw*>(vs + key * KS + d / 2) = vr[j];
      }
    }
    __syncthreads();

    // scores of the warp's 16 rows x kBKm keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t* kr = ks + (8 * j + g) * KS + 8 * kk + t;
        mma_bf16(s[j], qa[kk], kr[0], kr[4]);
      }

    // online softmax: each row's 4 owners are lanes 4 g .. 4 g + 3
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, kpos = k0 + 8 * j + 2 * t + (c & 1);
        float x = s[j][c] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = row_ok[i] && kpos < S &&
                          (!causal || kpos <= pos[i]) &&
                          (!window || kpos > pos[i] - window);
        s[j][c] = keep ? x : -INFINITY;
        mx[i] = fmaxf(mx[i], s[j][c]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = s[j][c] == -INFINITY ? 0.f : expf(s[j][c] - m[i]);
        s[j][c] = p;
        sum[i] += p;
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
    for (int kk = 0; kk < kBKm / 16; ++kk) {
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const size_t off = q_off(row[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd)
        *reinterpret_cast<uint32_t*>(out + off + d) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <int KT, int NT>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* out, int B, int S,
               int Hq, int Hkv, int hd, int causal, int window, float softcap,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(KT);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel_mma<KT, NT>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int BP = kRows / (Hq / Hkv);
  const dim3 grid((S + BP - 1) / BP, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, S, Hq, Hkv, hd, BP,
                                           causal, window, softcap,
                                           1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// head_dim in steps of 32 up to 256: KT 16-wide steps, NT = 2 KT tiles
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int Hq, int Hkv, int hd, int causal, int window,
                float softcap, cudaStream_t stream) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(out);
#define FLASH_MMA(KT)                                                       \
  return launch_mma<KT, 2 * KT>(qt, kt, vt, ot, B, S, Hq, Hkv, hd, causal, \
                                window, softcap, stream)
  if (hd <= 32) FLASH_MMA(2);
  if (hd <= 64) FLASH_MMA(4);
  if (hd <= 96) FLASH_MMA(6);
  if (hd <= 128) FLASH_MMA(8);
  if (hd <= 192) FLASH_MMA(12);
  if (hd <= 256) FLASH_MMA(16);
#undef FLASH_MMA
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DC>
int launch_dc(const T* q, const T* k, const T* v, T* out, int B, int S,
              int Hq, int Hkv, int hd, int causal, int window, float softcap,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd, DC);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel<T, DC>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rep = Hq / Hkv;
  const int BP = kRows / rep;
  const dim3 grid((S + BP - 1) / BP, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, S, Hq, Hkv, hd, BP,
                                           causal, window, softcap,
                                           1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int hd, int causal, int window,
           float softcap, cudaStream_t stream) {
  if (hd % Vec<T>::kN || Hkv < 1 || Hq % Hkv || Hq / Hkv > kRows)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define FLASH_LAUNCH(DC)                                                   \
  return launch_dc<T, DC>(qt, kt, vt, ot, B, S, Hq, Hkv, hd, causal,      \
                          window, softcap, stream)
  if (hd <= kTX * 4) FLASH_LAUNCH(4);
  if (hd <= kTX * 8) FLASH_LAUNCH(8);
  if (hd <= kTX * 16) FLASH_LAUNCH(16);
  if (hd <= kTX * 32) FLASH_LAUNCH(32);
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel);
// q, k, v and out share it. causal: 0
// or 1; window: 0 = none; softcap: 0 = none. Returns cudaGetLastError()
// after the launch, 0 on success.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int Hq, int Hkv, int hd, int causal,
                    int window, float softcap, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, Hq, Hkv, hd, causal, window,
                         softcap, s);
  if (dtype == 1) {
    if (hd % 4 || Hkv < 1 || Hq % Hkv || Hq / Hkv > kRows)
      return (int)cudaErrorInvalidValue;
    return launch_bf16(q, k, v, out, B, S, Hq, Hkv, hd, causal, window,
                       softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
