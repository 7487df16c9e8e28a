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
// every serving shape: at S = 1024, causal, qwen3-8b's heads, 8.6 GFLOP
// (8.7 us) against 21.0 MB (6.3 us).
//
// Two kernels, chosen by type in the C entry point:
//  - bfloat16 (flash_kernel_wgmma), the serving path (monolithic prefill and
//    score()): both products as Hopper warpgroup products (wgmma
//    m64n64k16, bf16 in, f32 accumulate), asynchronous on the tensor cores.
//     * S = Q K^T reads Q and K from shared memory: tiles of 128-byte
//       swizzled atoms (64 head_dim columns, 8-row groups 1024 bytes apart,
//       K-major descriptors; head_dim zero padded to 64, 128, 192 or 256).
//       O += P V takes P from registers (the S accumulators, rounded to
//       bf16, are the register A operand as they stand, as the plain
//       version rounds its probabilities to v's dtype) and reads V
//       transposed (MN-major) from the same layout, 64 output columns a
//       product. No fragment passes through ldmatrix or staging registers.
//     * GQA packing: a block's rows are query heads of one kv head's group
//       at rows / heads positions, so each K/V tile it loads serves the
//       whole group; a group of more heads than rows is split over blocks
//       (one position each). 128 rows (two warpgroups of 64) a block where
//       that grid fills the 132 SMs, so that each K/V tile read from L2
//       serves 128 rows (at qwen3-8b, S 1024: 2,176 tiles of 32 KB, where
//       64-row blocks would read 4,352). Where it does not (qwen2-1.5b's 12
//       over 2 heads: 98 blocks), 64 rows with two key groups, each walking
//       every other key tile with its own stages and merged through shared
//       memory at the end: half the chain of dependent tiles per block.
//       Position tiles run heaviest first across every head.
//     * K/V tiles of 64 keys arrive through a ring of three cp.async stages
//       (two where three do not fit), copied two tiles ahead (16-byte
//       copies where rows and pointers allow, else 8; keys past S zero
//       filled by the copy's src-size, so nothing past S reaches P.V), at
//       one wait, one proxy fence and one barrier a tile.
//     * Base-2 online softmax with scale * log2(e) folded into one FMA a
//       score and 2^x as one ex2.approx (p = 2^(s * c - m)), each thread's
//       share of a row sum kept until the end; the mask runs only on tiles
//       that S, the causal diagonal or the window's edge cuts, and the
//       softcap's tanh only with a softcap.
//     * The output leaves through the warpgroup's Q tile (swizzled, so the
//       accumulators' 4-byte writes are conflict free) as whole 16-byte
//       pieces of each output row.
//  - float32 (flash_kernel): scalar FMAs from shared memory, register-
//    tiled (a thread computes a 4 x 4 block of scores and a 4 x (hd / 8)
//    block of the output), which keeps the float32 path exact to the plain
//    version's rounding (tolerance 2e-5) at a fraction of the card's rate.
//    One block of 128 threads per (batch, kv head, tile of 64 query rows),
//    the rows every query head of the group at 64 / q_per_kv positions
//    (q_per_kv up to 64); K/V tiles read in 8-byte pieces, kLoadBatch of K
//    and of V in flight per thread before any is stored.
//
// Layouts (all contiguous): q, out (B, S, Hq, hd); k, v (B, S, Hkv, hd);
// head_dim a multiple of 4 up to 256; query head j reads kv head
// j / q_per_kv.
//
// The backward (no TPU counterpart: the JAX package differentiates its
// plain jnp), from q, k, v, the forward's out and its log-sum-exp lse
// (B, Hq, S) and the output gradient dO:
//   P = exp(s - lse) on the kept scores, D = rowsum(dO * O),
//   dS = P (dO V^T - D), through the softcap dU = dS (1 - (s / c)^2),
//   dV = P^T dO, dK = scale dU^T Q, dQ = scale dU K.
// No floating-point atomics anywhere: every sum runs in a fixed order, so
// the gradients are the same bits on every run. Two routes, by type (see
// the backward sections below): bfloat16 on the tensor cores (wgmma, P
// and dU rounded to bf16 before the products they feed, GQA summed on chip
// through a thread-block cluster), float32 in scalar FMAs (exact to the
// plain version's rounding, tolerance 2e-5).

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

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
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int Hq, int Hkv, int hd, int BP,
             int causal, int window, float softcap, float scale) {
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
    if (lse != nullptr && tx == 0) {
      const int r = ty + kTY * i;
      lse[((size_t)b * Hq + h * rep + r / np) * S + p0 + r % np] =
          m[i] + logf(l[i]);
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + kTX * j;
      if (d < hd) out[o + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: warpgroup products (wgmma)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;               // keys per K/V tile
constexpr int kTileBytes = 64 * 128;  // 64 rows x one 128-byte atom

// 2^x in one instruction (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async-written (generic proxy) shared memory made visible to wgmma's
// reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_D32(d)                                                          \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),              \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),          \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),          \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),          \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),          \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),          \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_DREGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// d (64 x 64, f32; thread layout of the m16n8 accumulators, tile j = d[j])
// = (scale_d ? d : 0) + A . B, A (64 x 16) and B (16 x 64) bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_DREGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += A . B, A (64 x 16) bf16 in registers (the m16n8k16 A-fragment
// layout, warp w rows 16 w ..), B (16 x 64) bf16 in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_DREGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of element column c (bf16) of row r in a tile of `rows`
// rows stored as 128-byte-swizzled atoms of 64 columns: atom c / 64 holds
// rows x 128 bytes, row r's 16-byte chunk i at (i ^ r % 8) * 16.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// A block has RW x KG warpgroups of 4 warps. Row warpgroup wg owns
// block rows 64 wg .. 64 wg + 63, warp u of it rows 16 u .. 16 u + 15 of
// those: a thread holds rows g and g + 8 (g = lane / 4) and, per 8-wide
// column tile, columns 2 t and 2 t + 1 (t = lane % 4), the layout of the
// wgmma accumulators and of its register A operand. The block takes HB
// heads of kv head h's group from head h0 on, at BP = rows / HB positions
// from p0: block row i is query head h * rep + h0 + i / np at position p0
// + i % np. Key group kg walks the block's key tiles kg, kg + KG, ... with
// its own stages; with two groups their partial softmax states are merged
// through shared memory at the end. A = 64-wide head_dim atoms (head_dim
// zero padded); ST = stages a key group's K/V tiles cycle through.
// K/V stages of a key group: three where they fit in shared memory
template <int A, int KG>
__host__ __device__ constexpr int wgmma_stages() {
  return A == 4 || (A == 3 && KG == 2) ? 2 : 3;
}

template <int A, int RW, int KG>
__global__ void __launch_bounds__(128 * RW * KG)
flash_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int S, int Hq, int Hkv, int hd, int HB, int causal,
                   int window, float softcap, float scale_log2,
                   int copy_bytes) {
  constexpr int NJ = 8;  // 8-wide key tiles of a K/V tile, and output
                         // tiles of a 64-column atom
  constexpr int key_groups = KG, rows = 64 * RW, threads = 128 * RW * KG;
  constexpr int n_stages = wgmma_stages<A, KG>();
  const int rep = Hq / Hkv, BP = rows / HB;
  const int n_split = (rep + HB - 1) / HB;
  // position tiles on grid y, heaviest first: the card takes blocks in x
  // order first, so every head's heaviest tiles start in the first wave
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x / n_split, b = blockIdx.z;
  const int h0 = (blockIdx.x % n_split) * HB;
  const int p0 = tile * BP;
  const int np = min(BP, S - p0);
  const int nrows = np * min(HB, rep - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warpgroup: row slot wg, key group kg
  const int wg = (warp >> 2) % RW;
  const int kg = KG == 1 ? 0 : (warp >> 2) / RW;
  const int wu = warp & 3;
  constexpr int gthreads = 128 * RW;
  const int gtid = tid - kg * gthreads;

  // shared memory from a 1024-byte boundary (the swizzle's period): Q
  // (rows x A atoms), then each key group's n_stages stages of K and V
  // (64 keys x A atoms each)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t smem_addr = raw_addr + (uint32_t)(smem - smem_raw);
  const int q_bytes = rows * A * 128;
  const int kv_bytes = A * kTileBytes;  // one K or V tile
  uint8_t* qs = smem;
  // key group kg's stages: (n_stages, K/V, A, kKeys, 128 B)
  const int group_bytes = 2 * n_stages * kv_bytes;
  uint8_t* stages = smem + q_bytes + kg * group_bytes;

  // head_dim past hd reads as zeros: the copies never write it (Q rows
  // past nrows and keys past S are zero filled by the copies)
  if (hd % 64) {
    const int total = q_bytes + key_groups * group_bytes;
    for (int e = tid * 16; e < total; e += threads * 16)
      *reinterpret_cast<uint4*>(smem + e) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  const int cpr = hd * 2 / copy_bytes;  // copies a row takes
  const int per = copy_bytes / 2;       // values a copy moves
  auto copy_to = [&](uint8_t* tile_base, int r, int rows_in, int piece,
                     const __nv_bfloat16* src, bool fill) {
    uint8_t* dst = tile_base + sw128_offset(r, piece * per, rows_in);
    if (copy_bytes == 16)
      cp_async_16(dst, src + piece * per, fill);
    else
      cp_async_8(dst, src + piece * per, fill);
  };
  for (int e = tid; e < rows * cpr; e += threads) {
    const int i = e / cpr, piece = e % cpr;
    const bool fill = i < nrows;
    const int ii = fill ? i : 0;
    const size_t src = (((size_t)b * S + p0 + ii % np) * Hq +
                        (size_t)h * rep + h0 + ii / np) * hd;
    // warpgroup w's rows are its own 64-row tile
    copy_to(qs + (i >> 6) * A * kTileBytes, i & 63, 64, piece, q + src,
            fill);
  }

  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    pos[i] = p0 + (64 * wg + 16 * wu + g + 8 * i) % np;

  const int pos_hi = p0 + np - 1;
  const int k_end = causal ? pos_hi + 1 : S;
  const int k_begin = window ? max(0, p0 - window + 1) : 0;
  const int t_begin = k_begin / kKeys;
  const int n_tiles = (k_end + kKeys - 1) / kKeys - t_begin;
  // the key group's tiles: t_begin + kg + j * key_groups
  const int n_mine = max(0, (n_tiles - kg + key_groups - 1) / key_groups);

  const size_t kv_row = (size_t)Hkv * hd;
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)h * hd;
  auto start_copies = [&](int j) {
    const int k0 = (t_begin + kg + j * key_groups) * kKeys;
    uint8_t* ks = stages + (j % n_stages) * 2 * kv_bytes;
    uint8_t* vs = ks + kv_bytes;
    for (int e = gtid; e < kKeys * cpr; e += gthreads) {
      const int key = e / cpr, piece = e % cpr;
      const bool fill = k0 + key < S;  // keys past S land as zeros
      const size_t src = kv_base + (size_t)min(k0 + key, S - 1) * kv_row;
      copy_to(ks, key, 64, piece, k + src, fill);
      copy_to(vs, key, 64, piece, v + src, fill);
    }
  };

  const float cap_in = softcap > 0.f ? scale_log2 / (kLog2e * softcap) : 0.f;
  const float cap_out = softcap > 0.f ? kLog2e * softcap / scale_log2 : 0.f;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[A][NJ][4];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][n][c] = 0.f;

  // Q and the group's first tile in one copy group, then (three stages)
  // its second in the next: tiles are copied n_stages - 1 ahead. The whole
  // block waits for Q.
  constexpr int ahead = n_stages - 1;
  if (n_mine > 0) start_copies(0);
  cp_async_commit();
  if constexpr (ahead == 2) {
    if (n_mine > 1) start_copies(1);
    cp_async_commit();
    cp_async_wait_group<1>();
  } else {
    cp_async_wait_group<0>();
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t q_addr = smem_addr + (uint32_t)(wg * A * kTileBytes);
  const uint32_t group_addr =
      smem_addr + (uint32_t)(q_bytes + kg * group_bytes);
  for (int j = 0; j < n_mine; ++j) {
    const int k0 = (t_begin + kg + j * key_groups) * kKeys;
    if (j > 0) {
      if constexpr (ahead == 2)
        cp_async_wait_group<1>();
      else
        cp_async_wait_group<0>();
      fence_proxy_async();
      // tile j has landed for the key group, and every warpgroup of it is
      // done with tile j - 1, whose stage takes tile j + ahead
      if constexpr (KG == 1)
        __syncthreads();
      else if (kg == 0)
        asm volatile("bar.sync 1, %0;\n" ::"n"(gthreads) : "memory");
      else
        asm volatile("bar.sync 2, %0;\n" ::"n"(gthreads) : "memory");
    }
    if (j + ahead < n_mine) start_copies(j + ahead);
    cp_async_commit();  // (empty past the last tile: the count stays even)
    const uint32_t k_addr =
        group_addr + (uint32_t)((j % n_stages) * 2 * kv_bytes);
    const uint32_t v_addr = k_addr + (uint32_t)kv_bytes;

    // S = Q K^T over head_dim in 16-wide steps: step kk reads 32 bytes
    // into atom kk / 4 of both (K-major, 8-row groups 1024 bytes apart)
    float s[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * A; ++kk) {
      const uint32_t in_atom = (uint32_t)((kk & 3) * 32);
      wgmma_ss(s,
               sw128_desc(q_addr + (kk >> 2) * kTileBytes + in_atom, 16,
                          1024),
               sw128_desc(k_addr + (kk >> 2) * kTileBytes + in_atom, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    if (softcap > 0.f) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[jj][c] = tanhf(s[jj][c] * cap_in) * cap_out;
    }
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > p0) ||
                      (window && k0 <= pos_hi - window);
    if (edge) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = pos[c >> 1], kpos = k0 + 8 * jj + 2 * t + (c & 1);
          const bool keep = kpos < S && (!causal || kpos <= p) &&
                            (!window || kpos > p - window);
          if (!keep) s[jj][c] = -INFINITY;
        }
    }

    // online softmax in base 2 with the scale folded in
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      mx[0] = fmaxf(mx[0], fmaxf(s[jj][0], s[jj][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[jj][2], s[jj][3]));
    }
    float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      alpha[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      neg_m[i] = -m_new;
    }
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2_approx(fmaf(s[jj][c], scale_log2, neg_m[c >> 1]));
        sum[c >> 1] += p[c];
      }
      // P's A fragment of keys 16 kk ..: (row g, keys 2t), (row g + 8,
      // keys 2t), (row g, keys 2t + 8), (row g + 8, keys 2t + 8)
      pa[jj >> 1][2 * (jj & 1)] = pack_bf16(p[0], p[1]);
      pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        o[a][n][0] *= alpha[0];
        o[a][n][1] *= alpha[0];
        o[a][n][2] *= alpha[1];
        o[a][n][3] *= alpha[1];
      }

    // O += P V, 64 output columns (one V atom) at a time; V is read
    // MN-major: keys 16 kk .. are two 8-row groups 1024 bytes apart
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs(o[a], pa[kk],
                 sw128_desc(v_addr + (uint32_t)(a * kTileBytes + kk * 2048),
                            kTileBytes, 1024));
    wgmma_commit();
    wgmma_wait0();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if constexpr (KG == 2) {
    // key group 1 hands its rows' (m, l, o) to group 0 through group 0's
    // stages
    float* mo = reinterpret_cast<float*>(smem + q_bytes);  // (rows, LD)
    const int LD = 64 * A + 2;
    cp_async_wait_group<0>();
    __syncthreads();
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* dst = mo + (64 * wg + 16 * wu + g + 8 * i) * LD;
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int n = 0; n < NJ; ++n) {
            dst[64 * a + 8 * n + 2 * t] = o[a][n][2 * i];
            dst[64 * a + 8 * n + 2 * t + 1] = o[a][n][2 * i + 1];
          }
        if (t == 0) {
          dst[64 * A] = m[i];
          dst[64 * A + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* src = mo + (64 * wg + 16 * wu + g + 8 * i) * LD;
      const float m1 = src[64 * A], l1 = src[64 * A + 1];
      const float m_new = fmaxf(m[i], m1);
      const float a0 = exp2_approx(m[i] - m_new);
      const float a1 = exp2_approx(m1 - m_new);
      l[i] = l[i] * a0 + l1 * a1;
      m[i] = m_new;
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int c = 64 * a + 8 * n + 2 * t;
          o[a][n][2 * i] = o[a][n][2 * i] * a0 + src[c] * a1;
          o[a][n][2 * i + 1] = o[a][n][2 * i + 1] * a0 + src[c + 1] * a1;
        }
    }
  }

  // the warpgroup's 64 output rows through its Q tile (swizzled, as Q
  // was: conflict-free 4-byte writes), then out in copy_bytes pieces, each
  // row's contiguous in memory
  uint8_t* os = smem + wg * A * kTileBytes;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wu + g + 8 * i;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const int row = 64 * wg + r;
    // the row's natural log-sum-exp: m and log2(l) are in base 2
    if (lse != nullptr && t == 0 && row < nrows)
      lse[((size_t)b * Hq + (size_t)h * rep + h0 + row / np) * S + p0 +
          row % np] = (m[i] + __log2f(l[i])) * 0.6931471805599453f;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int n = 0; n < NJ; ++n)
        *reinterpret_cast<uint32_t*>(os + sw128_offset(r, 64 * a + 8 * n +
                                                              2 * t, 64)) =
            pack_bf16(o[a][n][2 * i] * inv, o[a][n][2 * i + 1] * inv);
  }
  if (wg == 0)
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 128;\n" ::: "memory");
  for (int e = tid & 127; e < 64 * cpr; e += 128) {
    const int r = e / cpr, piece = e % cpr, i = 64 * wg + r;
    if (i >= nrows) continue;
    const size_t off = (((size_t)b * S + p0 + i % np) * Hq +
                        (size_t)h * rep + h0 + i / np) * hd + piece * per;
    const uint8_t* src = os + sw128_offset(r, piece * per, 64);
    if (copy_bytes == 16)
      *reinterpret_cast<uint4*>(out + off) =
          *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(out + off) =
          *reinterpret_cast<const uint2*>(src);
  }
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

// One launch shape of flash_kernel_wgmma: RW row warpgroups, KG key groups.
template <int A, int RW, int KG>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                 int B, int S,
                 int Hq, int Hkv, int hd, int causal, int window,
                 float softcap, cudaStream_t stream) {
  constexpr int rows = 64 * RW;
  constexpr size_t smem =
      (size_t)rows * A * 128 +
      (size_t)KG * wgmma_stages<A, KG>() * 2 * A * kTileBytes + 1024;
  static_assert(smem <= (size_t)kMaxSmem, "stages past shared memory");
  const int rep = Hq / Hkv;
  const int HB = min(rep, rows), BP = rows / HB;
  const dim3 grid(Hkv * ((rep + HB - 1) / HB), (S + BP - 1) / BP, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel_wgmma<A, RW, KG>;
  static bool smem_set = false;  // the kernel's dynamic limit
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const bool c16 =
      hd % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
              16 ==
          0;
  kernel<<<grid, 128 * RW * KG, smem, stream>>>(
      q, k, v, out, lse, S, Hq, Hkv, hd, HB, causal, window, softcap,
      kLog2e / sqrtf((float)hd), c16 ? 16 : 8);
  return (int)cudaGetLastError();
}

// The launch shape: 128 rows a block (two row warpgroups) where that grid
// fills the card; else 64 rows with two key groups where their stages fit
// (head_dim up to 192), else one.
template <int A>
int launch_wgmma_shape(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                       int B,
                       int S, int Hq, int Hkv, int hd, int causal, int window,
                       float softcap, cudaStream_t stream) {
  const int rep = Hq / Hkv, hb = min(rep, 128), bp = 128 / hb;
  const long blocks128 =
      (long)B * Hkv * ((rep + hb - 1) / hb) * ((S + bp - 1) / bp);
#define FLASH_ARGS \
  q, k, v, out, lse, B, S, Hq, Hkv, hd, causal, window, softcap
  if (blocks128 >= sm_count())
    return launch_wgmma<A, 2, 1>(FLASH_ARGS, stream);
  if constexpr (A <= 3)
    return launch_wgmma<A, 1, 2>(FLASH_ARGS, stream);
  else
    return launch_wgmma<A, 1, 1>(FLASH_ARGS, stream);
#undef FLASH_ARGS
}

// head_dim up to 256 in 64-wide atoms (zero padded)
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int Hq, int Hkv, int hd, int causal, int window,
                float softcap, cudaStream_t stream) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(out);
#define FLASH_WG(A)                                                      \
  return launch_wgmma_shape<A>(qt, kt, vt, ot, lse, B, S, Hq, Hkv, hd,    \
                               causal, window, softcap, stream)
  if (hd <= 64) FLASH_WG(1);
  if (hd <= 128) FLASH_WG(2);
  if (hd <= 192) FLASH_WG(3);
  if (hd <= 256) FLASH_WG(4);
#undef FLASH_WG
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DC>
int launch_dc(const T* q, const T* k, const T* v, T* out, float* lse,
              int B, int S,
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
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, S, Hq, Hkv, hd,
                                           BP, causal, window, softcap,
                                           1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int Hq, int Hkv, int hd, int causal,
           int window, float softcap, cudaStream_t stream) {
  if (hd % Vec<T>::kN || Hkv < 1 || Hq % Hkv || Hq / Hkv > kRows)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define FLASH_LAUNCH(DC)                                                   \
  return launch_dc<T, DC>(qt, kt, vt, ot, lse, B, S, Hq, Hkv, hd, causal, \
                          window, softcap, stream)
  if (hd <= kTX * 4) FLASH_LAUNCH(4);
  if (hd <= kTX * 8) FLASH_LAUNCH(8);
  if (hd <= kTX * 16) FLASH_LAUNCH(16);
  if (hd <= kTX * 32) FLASH_LAUNCH(32);
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward, float32: scalar FMAs
// ---------------------------------------------------------------------------
//
// D by bwd_rowdot; a dK / dV block (bwd_dkdv_kernel) owns 32 keys of one
// (batch, query head) and walks every 32-row query tile whose mask reaches
// its keys, summing in registers; with q_per_kv > 1 it writes its head's
// share to a float32 scratch and bwd_reduce_heads adds the group's shares
// in head order. A dQ block (bwd_dq_kernel) owns 32 query rows of one head
// and walks the key tiles its mask reaches. Both recompute P from lse; both
// hold their tiles in float32 in shared memory with rows padded to hd + 1
// (conflict-free column reads).

constexpr int kBT = 32;          // keys, and query rows, of a backward tile
constexpr int kBThreads = 256;

// D[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in float32: one warp a
// row
template <typename T>
__global__ void bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ dsum, int B, int S, int Hq,
                           int hd) {
  const long row = (long)blockIdx.x * (kBThreads / 32) + threadIdx.x / 32;
  if (row >= (long)B * S * Hq) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const long bs = row / Hq;  // b * S + s
    const int b = (int)(bs / S), s = (int)(bs % S);
    dsum[((size_t)b * Hq + h) * S + s] = acc;
  }
}

// One tile pair's shared tensors: a (kBT, hd) tile of rows as float32.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int first,
                                          int S, int hd, int ld) {
  for (int e = threadIdx.x; e < kBT * hd; e += kBThreads) {
    const int r = e / hd, d = e % hd;
    dst[r * ld + d] =
        first + r < S ? to_f32(src[(size_t)(first + r) * row_stride + d])
                      : 0.f;
  }
}

struct BwdMask {
  int S, causal, window;
  __device__ __forceinline__ bool keep(int qpos, int kpos) const {
    return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
           (!window || kpos > qpos - window);
  }
  // whether the mask cuts the tile of query rows q0 .. q0 + n - 1 and keys
  // k0 .. k0 + n - 1 (S, the causal diagonal or the window's edge); a tile
  // it does not cut skips the per-element test
  __device__ __forceinline__ bool cuts(int q0, int k0, int n) const {
    return q0 + n > S || k0 + n > S || (causal && k0 + n - 1 > q0) ||
           (window && k0 <= q0 + n - 1 - window);
  }
};

// The score tile of query rows (qs, dos: kBT x ld) against keys (ks, vs):
// thread (ty, tx) = (tid / 16, tid % 16) takes rows ty + 16 i and keys
// tx + 16 j (i, j < 2). Writes P to ps and scale * dU to dss (kBT x
// kBT + 1, row-major by query row).
__device__ __forceinline__ void bwd_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* dsum_s, float* ps, float* dss, int hd,
    int ld, int q0, int k0, const BwdMask& mk, float scale, float softcap) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float s[2][2] = {}, dp[2][2] = {};
  for (int d = 0; d < hd; ++d) {
    float qv[2], dv[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = qs[(ty + 16 * i) * ld + d];
      dv[i] = dos[(ty + 16 * i) * ld + d];
      kv[i] = ks[(tx + 16 * i) * ld + d];
      vv[i] = vs[(tx + 16 * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float x = s[i][j] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const bool keep = mk.keep(q0 + r, k0 + c);
      const float p = keep ? expf(x - lse_s[r]) : 0.f;
      float ds = p * (dp[i][j] - dsum_s[r]);
      if (softcap > 0.f) {
        const float t = x / softcap;
        ds *= 1.f - t * t;
      }
      ps[r * (kBT + 1) + c] = p;
      dss[r * (kBT + 1) + c] = ds * scale;
    }
}

// dK, dV of kBT keys of one (b, query head qh): its share of kv head
// qh / q_per_kv's gradient. Into dk, dv (B, S, Hkv, hd) when q_per_kv is 1,
// else into the float32 shares pk, pv (B, S, Hq, hd). Thread owns key
// tid / 8 and dims tid % 8 + 8 j (j < DC).
template <typename T, int DC>
__global__ void __launch_bounds__(kBThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ pk,
                    float* __restrict__ pv, int S, int Hq, int Hkv, int hd,
                    int causal, int window, float softcap, float scale) {
  const int k0 = blockIdx.x * kBT, qh = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv, h = qh / rep, ld = hd + 1, tid = threadIdx.x;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBT * ld;
  float* qs = vs + kBT * ld;
  float* dos = qs + kBT * ld;
  float* ps = dos + kBT * ld;
  float* dss = ps + kBT * (kBT + 1);
  float* lse_s = dss + kBT * (kBT + 1);
  float* dsum_s = lse_s + kBT;
  const BwdMask mk{S, causal, window};
  const size_t kv_stride = (size_t)Hkv * hd, q_stride = (size_t)Hq * hd;
  load_rows(ks, k + (size_t)b * S * kv_stride + (size_t)h * hd, kv_stride, k0,
            S, hd, ld);
  load_rows(vs, v + (size_t)b * S * kv_stride + (size_t)h * hd, kv_stride, k0,
            S, hd, ld);
  // query rows whose mask reaches keys k0 .. k0 + kBT - 1
  const int q_first = causal ? k0 : 0;
  const int q_last = window ? min(S, k0 + kBT - 1 + window) : S;
  const int kc = tid / 8, dx0 = tid % 8;
  float acc_k[DC], acc_v[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc_k[j] = acc_v[j] = 0.f;
  const size_t qbase = (size_t)b * S * q_stride + (size_t)qh * hd;
  for (int q0 = (q_first / kBT) * kBT; q0 < q_last; q0 += kBT) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(qs, q + qbase, q_stride, q0, S, hd, ld);
    load_rows(dos, dout + qbase, q_stride, q0, S, hd, ld);
    if (tid < kBT) {
      const size_t o = ((size_t)b * Hq + qh) * S + q0 + tid;
      lse_s[tid] = q0 + tid < S ? lse[o] : 0.f;
      dsum_s[tid] = q0 + tid < S ? dsum[o] : 0.f;
    }
    __syncthreads();
    bwd_scores(qs, dos, ks, vs, lse_s, dsum_s, ps, dss, hd, ld, q0, k0, mk,
               scale, softcap);
    __syncthreads();
    for (int r = 0; r < kBT; ++r) {
      const float p = ps[r * (kBT + 1) + kc];
      const float ds = dss[r * (kBT + 1) + kc];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int d = dx0 + 8 * j;
        if (d < hd) {
          acc_v[j] = fmaf(p, dos[r * ld + d], acc_v[j]);
          acc_k[j] = fmaf(ds, qs[r * ld + d], acc_k[j]);
        }
      }
    }
  }
  if (k0 + kc >= S) return;
  if (rep == 1) {
    const size_t o = ((size_t)b * S + k0 + kc) * kv_stride + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = dx0 + 8 * j;
      if (d < hd) {
        dk[o + d] = from_f32<T>(acc_k[j]);
        dv[o + d] = from_f32<T>(acc_v[j]);
      }
    }
    return;
  }
  const size_t o = ((size_t)b * S + k0 + kc) * q_stride + (size_t)qh * hd;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    const int d = dx0 + 8 * j;
    if (d < hd) {
      pk[o + d] = acc_k[j];
      pv[o + d] = acc_v[j];
    }
  }
}

// dk, dv[b, s, h, d] = the sum over the group's query heads, in head order,
// of their shares pk, pv[b, s, h q_per_kv + j, d]
template <typename T>
__global__ void bwd_reduce_heads(const float* __restrict__ pk,
                                 const float* __restrict__ pv,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 long n, int Hkv, int rep, int hd) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int d = (int)(e % hd);
  const long bsh = e / hd;  // (b * S + s) * Hkv + h
  const size_t src = ((size_t)(bsh / Hkv) * Hkv * rep +
                      (size_t)(bsh % Hkv) * rep) * hd + d;
  float sk = 0.f, sv = 0.f;
  for (int j = 0; j < rep; ++j) {
    sk += pk[src + (size_t)j * hd];
    sv += pv[src + (size_t)j * hd];
  }
  dk[e] = from_f32<T>(sk);
  dv[e] = from_f32<T>(sv);
}

// dQ of kBT query rows of one (b, query head); thread owns row tid / 8 and
// dims tid % 8 + 8 j (j < DC)
template <typename T, int DC>
__global__ void __launch_bounds__(kBThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, T* __restrict__ dq, int S,
                  int Hq, int Hkv, int hd, int causal, int window,
                  float softcap, float scale) {
  const int q0 = blockIdx.x * kBT, qh = blockIdx.y, b = blockIdx.z;
  const int h = qh / (Hq / Hkv), ld = hd + 1, tid = threadIdx.x;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBT * ld;
  float* qs = vs + kBT * ld;
  float* dos = qs + kBT * ld;
  float* ps = dos + kBT * ld;
  float* dss = ps + kBT * (kBT + 1);
  float* lse_s = dss + kBT * (kBT + 1);
  float* dsum_s = lse_s + kBT;
  const BwdMask mk{S, causal, window};
  const size_t kv_stride = (size_t)Hkv * hd, q_stride = (size_t)Hq * hd;
  const size_t qbase = (size_t)b * S * q_stride + (size_t)qh * hd;
  load_rows(qs, q + qbase, q_stride, q0, S, hd, ld);
  load_rows(dos, dout + qbase, q_stride, q0, S, hd, ld);
  if (tid < kBT) {
    const size_t o = ((size_t)b * Hq + qh) * S + q0 + tid;
    lse_s[tid] = q0 + tid < S ? lse[o] : 0.f;
    dsum_s[tid] = q0 + tid < S ? dsum[o] : 0.f;
  }
  // key tiles the mask of rows q0 .. q0 + kBT - 1 reaches
  const int k_end = causal ? min(S, q0 + kBT) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int r = tid / 8, dx0 = tid % 8;
  float acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = 0.f;
  const size_t kvbase = (size_t)b * S * kv_stride + (size_t)h * hd;
  for (int k0 = (k_begin / kBT) * kBT; k0 < k_end; k0 += kBT) {
    __syncthreads();
    load_rows(ks, k + kvbase, kv_stride, k0, S, hd, ld);
    load_rows(vs, v + kvbase, kv_stride, k0, S, hd, ld);
    __syncthreads();
    bwd_scores(qs, dos, ks, vs, lse_s, dsum_s, ps, dss, hd, ld, q0, k0, mk,
               scale, softcap);
    __syncthreads();
    for (int c = 0; c < kBT; ++c) {
      const float ds = dss[r * (kBT + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int d = dx0 + 8 * j;
        if (d < hd) acc[j] = fmaf(ds, ks[c * ld + d], acc[j]);
      }
    }
  }
  if (q0 + r >= S) return;
  const size_t o = qbase + (size_t)(q0 + r) * q_stride;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    const int d = dx0 + 8 * j;
    if (d < hd) dq[o + d] = from_f32<T>(acc[j]);
  }
}

template <typename T, int DC>
int launch_bwd_dc(const T* q, const T* k, const T* v, const T* out,
                  const T* dout, const float* lse, float* dsum, float* pk,
                  float* pv, T* dq, T* dk, T* dv, int B, int S, int Hq,
                  int Hkv, int hd, int causal, int window, float softcap,
                  cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem =
      sizeof(float) * ((size_t)4 * kBT * ld + 2 * kBT * (kBT + 1) + 2 * kBT);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto dkdv = bwd_dkdv_kernel<T, DC>;
  auto dqk = bwd_dq_kernel<T, DC>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  const long rows = (long)B * S * Hq;
  const long row_blocks = (rows + kBThreads / 32 - 1) / (kBThreads / 32);
  if (row_blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  bwd_rowdot<T><<<(unsigned)row_blocks, kBThreads, 0, stream>>>(
      out, dout, dsum, B, S, Hq, hd);
  const int tiles = (S + kBT - 1) / kBT;
  dkdv<<<dim3(tiles, Hq, B), kBThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, pk, pv, S, Hq, Hkv, hd, causal,
      window, softcap, scale);
  if (Hq != Hkv) {
    const long n = (long)B * S * Hkv * hd;
    bwd_reduce_heads<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        pk, pv, dk, dv, n, Hkv, Hq / Hkv, hd);
  }
  dqk<<<dim3(tiles, Hq, B), kBThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, dq, S, Hq, Hkv, hd, causal, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* dsum, void* pk,
               void* pv, void* dq, void* dk, void* dv, int B, int S, int Hq,
               int Hkv, int hd, int causal, int window, float softcap,
               cudaStream_t stream) {
  if (hd < 1 || Hkv < 1 || Hq % Hkv || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD(DC)                                                       \
  return launch_bwd_dc<T, DC>(                                              \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<const T*>(out),                 \
      static_cast<const T*>(dout), static_cast<const float*>(lse),          \
      static_cast<float*>(dsum), static_cast<float*>(pk),                   \
      static_cast<float*>(pv), static_cast<T*>(dq), static_cast<T*>(dk),    \
      static_cast<T*>(dv), B, S, Hq, Hkv, hd, causal, window, softcap,      \
      stream)
  if (hd <= 8 * 4) FLASH_BWD(4);
  if (hd <= 8 * 8) FLASH_BWD(8);
  if (hd <= 8 * 16) FLASH_BWD(16);
  if (hd <= 8 * 32) FLASH_BWD(32);
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward, bfloat16: warpgroup products (wgmma) on the tensor cores
// ---------------------------------------------------------------------------
//
// What bounds it on the H100: a kept (query, key) pair costs 8 hd flops in
// the four products of dK / dV (S, dP, dV, dK) and 6 hd more in dQ's pass
// (S, dP again, dQ); at qwen2-1.5b's training shape (B 8, S 256, 12 query
// heads over 2 kv heads of 128, causal) that is 5.7 GFLOP, 5.7 us at the
// bf16 tensor-core rate, against 23 MB of q, k, v, out, dO and lse read and
// dq, dk, dv written (6.9 us at 3.35 TB/s): both sit near the card's ridge,
// so the design keeps every product on the tensor cores and every
// intermediate (P, dS, the GQA sums) out of device memory: a float32 share
// of dK and dV per query head, written out and read back as the scalar
// route does, would move 2 x 12.6 MB there, twice the whole bound. wgmma,
// not mma.sync: with mma.sync every warp reloads each B fragment from
// shared memory through ldmatrix.
//
// The five products are the forward's two wgmma forms (flash_kernel_wgmma):
// a product of two K-major shared-memory tiles (wgmma_ss: S = Q K^T, dP =
// dO V^T, and their transposes) and a product of a register A operand with
// an MN-major tile (wgmma_rs: dQ += dS K, dV += P^T dO, dK += dS^T Q), on
// the forward's tiles of 64 rows in 128-byte-swizzled atoms of 64 head_dim
// columns (head_dim zero padded to 64 A). The m64n64 accumulators are the
// m16n8 fragments, so P and dS, rounded to bf16, are the next product's A
// operand as they stand. Two kernels, dQ first (it also writes each row's
// lse log2(e) and D for the second); the second is launched as the first's
// programmatic dependent, so its blocks take the SMs the first's last wave
// frees and load their K / V tiles before they wait for D:
//  - bwd_dq_wgmma: a warpgroup per (query head, batch, tile of 64 query
//    rows). D = rowsum(dO O) of its rows from device memory (every lane's
//    loads in flight at once); Q and dO tiles, then K / V tiles of 64 keys
//    through two cp.async stages (tile j + 1 copied while tile j is used);
//    S and dP, P = 2^(s scale log2(e) - lse log2(e)) (ex2.approx), dU = P
//    (dP - D) (1 - (s / c)^2 with a softcap) scale in bf16, dQ += dU K.
//  - bwd_dkdv_wgmma: a block per (query head j of the group, (batch, kv
//    head), tile of 64 keys); K and V tiles stay in shared memory while Q,
//    dO, lse and D tiles of 64 query rows, those the keys' mask reaches,
//    arrive through two stages; S^T = K Q^T and dP^T = V dO^T, then P^T
//    and dU^T as above, dV += P^T dO, dK += dU^T Q. Past head_dim 128 two
//    warpgroups each take half of dK's and dV's atoms (each computes S^T
//    and dP^T: registers, not work, are the limit there). The group's
//    blocks form a thread-block cluster along x (C = the largest divisor of
//    q_per_kv up to 8: qwen2-1.5b's 6, qwen3-8b's 4), each of whose blocks
//    lands its float32 dK and dV in its own shared memory; after the
//    cluster barrier rank r sums its share of the elements over ranks 0 ..
//    C - 1 in rank order through distributed shared memory and writes them
//    in bf16. A group of more than one cluster (q_per_kv 12: two of 6; a
//    prime above 8: C = 1) writes each cluster's float32 sums instead, and
//    bwd_sum_clusters adds them in cluster order.
// Grids run their heaviest tiles first (dQ: the last query tiles, dK / dV:
// the first key tiles). The per-element work of P and dU tests the mask
// only on tiles the mask cuts and runs the softcap's tanh only with one
// (both chosen per tile at compile time). Keys and query rows past S land
// as zeros and are masked; so are the head_dim columns past hd (zeroed
// once a block).

namespace cg = cooperative_groups;

constexpr int kBwdRows = 64;  // keys of a dK / dV block, query rows of a dQ
                              // block, and the rows of every tile they walk
constexpr int kBwdMaxCluster = 8;  // the portable cluster size

// Row stride, in floats, of the landed float32 dK / dV rows: 8 mod 32, so
// a warp's float2 stores hit distinct banks.
__host__ __device__ constexpr int bwd_red_ld(int atoms) {
  return 64 * atoms + 8;
}


// Shared memory of the two kernels (from a 1024-byte boundary, plus 1024
// for the alignment): six 64-row tiles (dQ: Q, dO, two stages of K and V;
// dK / dV: K, V, two stages of Q and dO, or the landing rows where those
// are larger), then 4 x 64 floats (lse and D, two stages).
__host__ __device__ constexpr size_t bwd_stage_bytes(int atoms) {
  return (size_t)4 * atoms * kTileBytes;
}
__host__ __device__ constexpr size_t bwd_land_bytes(int atoms) {
  return (size_t)2 * kBwdRows * bwd_red_ld(atoms) * 4;
}
__host__ __device__ constexpr size_t bwd_smem(int atoms) {
  return (size_t)2 * atoms * kTileBytes +
         (bwd_stage_bytes(atoms) > bwd_land_bytes(atoms)
              ? bwd_stage_bytes(atoms)
              : bwd_land_bytes(atoms)) +
         4 * kBwdRows * 4 + 1024;
}

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float2* stats;  // (B, Hq, S): each row's (lse log2(e), D), from dQ's pass
  __nv_bfloat16 *dq, *dk, *dv;
  float* part;  // (2, n_cl, B, S, Hkv, hd): clusters' dK, dV sums, n_cl > 1
  int B, S, Hq, Hkv, hd, causal, window, copy_bytes;
  float softcap, scale;
};

// The cluster size of a group of `rep` query heads: its largest divisor up
// to kBwdMaxCluster.
__host__ __device__ inline int bwd_cluster(int rep) {
  for (int c = rep < kBwdMaxCluster ? rep : kBwdMaxCluster; c > 1; --c)
    if (rep % c == 0) return c;
  return 1;
}

// The block's shared memory from a 1024-byte boundary (the swizzle's
// period), and its shared-space address.
__device__ __forceinline__ uint8_t* bwd_smem_base(uint8_t* raw,
                                                  uint32_t* addr) {
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t pad = (1024 - (raw_addr & 1023)) & 1023;
  *addr = raw_addr + pad;
  return raw + pad;
}

// cp.async of rows r0 .. r0 + 63 of a row-major tensor (row stride
// `stride` elements, hd columns) into a 64-row tile of swizzled atoms; rows
// at or past `limit` land as zeros.
__device__ __forceinline__ void bwd_copy_tile(uint8_t* tile,
                                              const __nv_bfloat16* src,
                                              size_t stride, int r0,
                                              int limit, int hd,
                                              int copy_bytes, int tid,
                                              int threads) {
  const int per = copy_bytes / 2;  // values a copy moves
  const int cpr = hd / per;        // copies a row takes
  // copy e = tid + i threads is piece p of row r, stepped without a
  // division
  const int dr = threads / cpr, dp = threads - dr * cpr;
  int r = tid / cpr, p = tid - r * cpr;
  while (r < kBwdRows) {
    const bool fill = r0 + r < limit;
    const __nv_bfloat16* s =
        src + (size_t)(fill ? r0 + r : 0) * stride + p * per;
    uint8_t* d = tile + sw128_offset(r, p * per, kBwdRows);
    if (copy_bytes == 16)
      cp_async_16(d, s, fill);
    else
      cp_async_8(d, s, fill);
    r += dr;
    p += dp;
    if (p >= cpr) {
      p -= cpr;
      ++r;
    }
  }
}

// Zero head_dim columns hd .. 64 A - 1 of `n` consecutive 64-row tiles (the
// copies never write them), then fence them for the tensor cores' reads.
template <int A>
__device__ __forceinline__ void bwd_zero_pad(uint8_t* tiles, int n, int hd,
                                             int tid, int threads) {
  const int units = (64 * A - hd) / 4;  // 4-column pieces a row
  for (int e = tid; e < n * kBwdRows * units; e += threads) {
    const int row = e / units, u = e - row * units;
    *reinterpret_cast<uint2*>(tiles + (size_t)(row / kBwdRows) * A *
                                          kTileBytes +
                              sw128_offset(row % kBwdRows, hd + 4 * u,
                                           kBwdRows)) = make_uint2(0u, 0u);
  }
  fence_proxy_async();
}

// Programmatic dependent launch: the next kernel on the stream may start
// (its blocks then wait in griddep_wait until this grid has finished and
// its writes are visible).
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The constants of P and dU: P = 2^(x scale log2(e) - lse2) from the raw
// product x = q.k; with a softcap c, u = tanh(x scale / c), s = c u, P =
// 2^(s log2(e) - lse2) and dU = dS (1 - u^2); dU carries the scale.
struct BwdScore {
  float sl2, cap_in, cap_out, scale;
  // P and scale dU from x, dP, the row's lse2 and D; kCap: with the softcap
  template <bool kCap>
  __device__ __forceinline__ float2 operator()(float x, float dp, float lse2,
                                               float d) const {
    if constexpr (kCap) {
      const float u = tanhf(x * cap_in);
      const float p = exp2_approx(u * cap_out - lse2);
      return make_float2(p, p * (dp - d) * (1.f - u * u) * scale);
    } else {
      const float p = exp2_approx(fmaf(x, sl2, -lse2));
      return make_float2(p, p * (dp - d) * scale);
    }
  }
};

// f(masked, capped) with both as compile-time constants (std::true_type /
// std::false_type): the tile's per-element work carries the mask test only
// where the mask cuts the tile, the softcap's tanh only with one.
template <typename F>
__device__ __forceinline__ void bwd_dispatch(bool masked, bool capped, F f) {
  if (capped) {
    if (masked)
      f(std::true_type{}, std::true_type{});
    else
      f(std::false_type{}, std::true_type{});
  } else {
    if (masked)
      f(std::true_type{}, std::false_type{});
    else
      f(std::false_type{}, std::false_type{});
  }
}

// acc (64 x 64, the m16n8 layout) = A . B over head_dim, A and B 64-row
// K-major tiles at shared addresses a_addr, b_addr (A atoms each)
template <int A>
__device__ __forceinline__ void bwd_product_ss(float (&acc)[8][4],
                                               uint32_t a_addr,
                                               uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4 * A; ++kk) {
    const uint32_t at = (uint32_t)((kk >> 2) * kTileBytes + (kk & 3) * 32);
    wgmma_ss(acc, sw128_desc(a_addr + at, 16, 1024),
             sw128_desc(b_addr + at, 16, 1024), kk > 0);
  }
}

// acc += a . B[:, atom], a (64 x 64 rows' A fragments in bf16, 16-column
// steps kk) in registers, B a 64-row tile read MN-major
__device__ __forceinline__ void bwd_product_rs(float (&acc)[8][4],
                                               const uint32_t (&a)[4][4],
                                               uint32_t b_addr, int atom) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, a[kk],
             sw128_desc(b_addr + (uint32_t)(atom * kTileBytes + kk * 2048),
                        kTileBytes, 1024));
}

template <int A>
__global__ void __launch_bounds__(128) bwd_dq_wgmma(BwdArgs a) {
  constexpr int TB = A * kTileBytes;  // bytes of a 64-row tile
  const int tile = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int qh = blockIdx.x, b = blockIdx.y;
  const int S = a.S, Hq = a.Hq, hd = a.hd;
  const int h = qh / (Hq / a.Hkv);
  const int q0 = tile * kBwdRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  griddep_launch();  // bwd_dkdv_wgmma may start loading its K / V tiles

  extern __shared__ uint8_t bwd_raw[];
  uint32_t smem_addr;
  uint8_t* smem = bwd_smem_base(bwd_raw, &smem_addr);
  uint8_t* kvs = smem + 2 * TB;  // stage st: K at kvs + 2 st TB, V after
  float2* stat_s = reinterpret_cast<float2*>(kvs + 4 * TB);  // (64)
  if (hd % 64) bwd_zero_pad<A>(smem, 6, hd, tid, 128);

  const size_t q_stride = (size_t)Hq * hd, kv_stride = (size_t)a.Hkv * hd;
  const size_t q_base = (size_t)b * S * q_stride + (size_t)qh * hd;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)h * hd;
  bwd_copy_tile(smem, a.q + q_base, q_stride, q0, S, hd, a.copy_bytes, tid,
                128);
  bwd_copy_tile(smem + TB, a.dout + q_base, q_stride, q0, S, hd,
                a.copy_bytes, tid, 128);
  // the key tiles the rows' mask reaches
  const int k_end = a.causal ? min(S, q0 + kBwdRows) : S;
  const int k_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / kBwdRows;
  const int n_kt = (k_end + kBwdRows - 1) / kBwdRows - t_begin;
  auto start_kv = [&](int j) {
    const int k0 = (t_begin + j) * kBwdRows;
    uint8_t* ks = kvs + (j & 1) * 2 * TB;
    bwd_copy_tile(ks, a.k + kv_base, kv_stride, k0, S, hd, a.copy_bytes, tid,
                  128);
    bwd_copy_tile(ks + TB, a.v + kv_base, kv_stride, k0, S, hd, a.copy_bytes,
                  tid, 128);
  };
  start_kv(0);
  cp_async_commit();

  // D = rowsum(dO O) of the block's rows, and lse in base 2: warp w takes
  // rows 16 w .. 16 w + 15, every lane's 4-value pieces of all of them
  // loaded before the first sum, then a shuffle tree a row; thread r < 64
  // loads row r's lse with them
  const size_t row_stat = ((size_t)b * Hq + qh) * S;
  const float lse_r =
      tid < kBwdRows && q0 + tid < S ? a.lse[row_stat + q0 + tid] : 0.f;
  {
    constexpr int PP = (A + 1) / 2;  // pieces a lane and row
    uint2 ov[16][PP], dv[16][PP];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int pos = q0 + 16 * warp + i;
      const size_t row = q_base + (size_t)(pos < S ? pos : 0) * q_stride;
#pragma unroll
      for (int p = 0; p < PP; ++p) {
        const int d = 4 * lane + 128 * p;
        ov[i][p] = dv[i][p] = make_uint2(0u, 0u);
        if (pos < S && d < hd) {
          ov[i][p] = *reinterpret_cast<const uint2*>(a.o + row + d);
          dv[i][p] = *reinterpret_cast<const uint2*>(a.dout + row + d);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < PP; ++p) {
        float fo[4], fd[4];
        Vec<__nv_bfloat16>::unpack(ov[i][p], fo);
        Vec<__nv_bfloat16>::unpack(dv[i][p], fd);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc = fmaf(fo[c], fd[c], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) stat_s[16 * warp + i].y = acc;
    }
  }
  if (tid < kBwdRows) stat_s[tid].x = lse_r * kLog2e;
  __syncthreads();
  // the rows' (lse2, D) for bwd_dkdv_wgmma
  if (tid < kBwdRows && q0 + tid < S)
    a.stats[row_stat + q0 + tid] = stat_s[tid];
  int pos[2];
  float2 st[2];  // the thread's rows' (lse2, D)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    pos[i] = q0 + r;
    st[i] = stat_s[r];
  }
  const BwdMask mk{S, a.causal, a.window};
  const float scale = a.scale;
  const BwdScore sc{scale * kLog2e,
                    a.softcap > 0.f ? scale / a.softcap : 0.f,
                    a.softcap * kLog2e, scale};

  float acc[A][8][4];
#pragma unroll
  for (int x = 0; x < A; ++x)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[x][n][c] = 0.f;
  const uint32_t q_addr = smem_addr, do_addr = smem_addr + TB;
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = (t_begin + j) * kBwdRows;
    cp_async_wait_group<0>();
    fence_proxy_async();
    // tile j (and Q, dO) landed for every thread; every product of tile
    // j - 1 is done, so its stage takes tile j + 1
    __syncthreads();
    if (j + 1 < n_kt) start_kv(j + 1);
    cp_async_commit();
    const uint32_t k_addr = smem_addr + (uint32_t)((2 + (j & 1) * 2) * TB);
    const uint32_t v_addr = k_addr + TB;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = dp[jj][c] = 0.f;
    wgmma_fence();
    bwd_product_ss<A>(s, q_addr, k_addr);
    bwd_product_ss<A>(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait0();

    // dU in bf16: the A fragments of keys 16 kk .. (row g, keys 2t), (row
    // g + 8, keys 2t), (row g, keys 2t + 8), (row g + 8, keys 2t + 8)
    uint32_t ua[4][4];
    bwd_dispatch(mk.cuts(q0, k0, kBwdRows), a.softcap > 0.f, [&](auto masked,
                                                      auto capped) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float du[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1, key = k0 + 8 * jj + 2 * t + (c & 1);
          du[c] = sc.template operator()<decltype(capped)::value>(
                      s[jj][c], dp[jj][c], st[i].x, st[i].y).y;
          if (decltype(masked)::value && !mk.keep(pos[i], key)) du[c] = 0.f;
        }
        ua[jj >> 1][2 * (jj & 1)] = pack_bf16(du[0], du[1]);
        ua[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(du[2], du[3]);
      }
    });

    // dQ += dU K, K read MN-major, 64 columns (one atom) a product
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < A; ++x) bwd_product_rs(acc[x], ua, k_addr, x);
    wgmma_commit();
    wgmma_wait0();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= S) continue;
    __nv_bfloat16* row = a.dq + q_base + (size_t)pos[i] * q_stride;
#pragma unroll
    for (int x = 0; x < A; ++x)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * x + 8 * n + 2 * t;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(acc[x][n][2 * i], acc[x][n][2 * i + 1]);
      }
  }
}

__device__ __forceinline__ void bwd_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int A, int NH>
__global__ void __launch_bounds__(128 * NH) bwd_dkdv_wgmma(BwdArgs a) {
  constexpr int TB = A * kTileBytes;  // bytes of a 64-row tile
  constexpr int AW = (A + NH - 1) / NH;  // dK / dV atoms of a warpgroup
  constexpr int RLD = bwd_red_ld(A);
  constexpr int threads = 128 * NH;
  const int S = a.S, Hq = a.Hq, Hkv = a.Hkv, hd = a.hd;
  const int rep = Hq / Hkv;
  const int b = blockIdx.y / Hkv, h = blockIdx.y - b * Hkv;
  const int qh = h * rep + blockIdx.x;
  const int k0 = blockIdx.z * kBwdRows;  // heaviest (causal: first) first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wu = warp & 3;  // warpgroup, warp in it

  extern __shared__ uint8_t bwd_raw[];
  uint32_t smem_addr;
  uint8_t* smem = bwd_smem_base(bwd_raw, &smem_addr);
  uint8_t* stages = smem + 2 * TB;  // stage st: Q at stages + 2 st TB, dO
  constexpr size_t area = bwd_stage_bytes(A) > bwd_land_bytes(A)
                              ? bwd_stage_bytes(A)
                              : bwd_land_bytes(A);
  float2* stat_s = reinterpret_cast<float2*>(stages + area);  // (2, 64)
  if (hd % 64) bwd_zero_pad<A>(smem, 6, hd, tid, threads);

  const size_t q_stride = (size_t)Hq * hd, kv_stride = (size_t)Hkv * hd;
  const size_t q_base = (size_t)b * S * q_stride + (size_t)qh * hd;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)h * hd;
  const size_t row_stat = ((size_t)b * Hq + qh) * S;
  bwd_copy_tile(smem, a.k + kv_base, kv_stride, k0, S, hd, a.copy_bytes, tid,
                threads);
  bwd_copy_tile(smem + TB, a.v + kv_base, kv_stride, k0, S, hd, a.copy_bytes,
                tid, threads);
  // D comes from bwd_dq_wgmma, launched just before: K and V are in flight
  griddep_wait();
  // the query tiles whose mask reaches keys k0 .. k0 + 63
  const int q_first = a.causal ? k0 : 0;
  const int q_end = a.window ? min(S, k0 + kBwdRows - 1 + a.window) : S;
  const int t_begin = q_first / kBwdRows;
  const int n_qt = (q_end + kBwdRows - 1) / kBwdRows - t_begin;
  auto start_q = [&](int j) {
    const int q0 = (t_begin + j) * kBwdRows, st = j & 1;
    uint8_t* qst = stages + st * 2 * TB;
    bwd_copy_tile(qst, a.q + q_base, q_stride, q0, S, hd, a.copy_bytes, tid,
                  threads);
    bwd_copy_tile(qst + TB, a.dout + q_base, q_stride, q0, S, hd,
                  a.copy_bytes, tid, threads);
    for (int r = tid; r < kBwdRows; r += threads) {
      const bool fill = q0 + r < S;
      cp_async_8(stat_s + st * kBwdRows + r,
                 a.stats + row_stat + (fill ? q0 + r : 0), fill);
    }
  };
  if (n_qt > 0) start_q(0);
  cp_async_commit();

  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = k0 + 16 * wu + g + 8 * i;
  const BwdMask mk{S, a.causal, a.window};
  const float scale = a.scale;
  const BwdScore sc{scale * kLog2e,
                    a.softcap > 0.f ? scale / a.softcap : 0.f,
                    a.softcap * kLog2e, scale};

  float dk[AW][8][4], dv[AW][8][4];
#pragma unroll
  for (int x = 0; x < AW; ++x)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[x][n][c] = dv[x][n][c] = 0.f;
  const uint32_t k_addr = smem_addr, v_addr = smem_addr + TB;
  for (int j = 0; j < n_qt; ++j) {
    const int q0 = (t_begin + j) * kBwdRows, st = j & 1;
    cp_async_wait_group<0>();
    fence_proxy_async();
    // stage j landed for every thread; every product of stage j - 1 is
    // done, so it takes tile j + 1
    __syncthreads();
    if (j + 1 < n_qt) start_q(j + 1);
    cp_async_commit();
    const uint32_t q_addr = smem_addr + (uint32_t)((2 + 2 * st) * TB);
    const uint32_t do_addr = q_addr + TB;
    const float2* sts = stat_s + st * kBwdRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jj][c] = dp[jj][c] = 0.f;
    wgmma_fence();
    bwd_product_ss<A>(s, k_addr, q_addr);
    bwd_product_ss<A>(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait0();

    // P^T and dU^T in bf16, A fragments of query rows 16 kk .. as they
    // stand (rows: keys g, g + 8; columns: queries 2t, 2t + 8)
    uint32_t pa[4][4], ua[4][4];
    bwd_dispatch(mk.cuts(q0, k0, kBwdRows), a.softcap > 0.f, [&](auto masked,
                                                      auto capped) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        // (lse2, D) of query rows col and col + 1
        const float4 rows = *reinterpret_cast<const float4*>(sts + col);
        float p[4], du[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1, qpos = q0 + col + (c & 1);
          const float2 pd = sc.template operator()<decltype(capped)::value>(
              s[jj][c], dp[jj][c], (c & 1) ? rows.z : rows.x,
              (c & 1) ? rows.w : rows.y);
          p[c] = pd.x;
          du[c] = pd.y;
          if (decltype(masked)::value && !mk.keep(qpos, kpos[i]))
            p[c] = du[c] = 0.f;
        }
        pa[jj >> 1][2 * (jj & 1)] = pack_bf16(p[0], p[1]);
        pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(p[2], p[3]);
        ua[jj >> 1][2 * (jj & 1)] = pack_bf16(du[0], du[1]);
        ua[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(du[2], du[3]);
      }
    });

    // dV += P^T dO and dK += dU^T Q over the warpgroup's atoms, dO and Q
    // read MN-major
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < AW; ++x)
      if (wg * AW + x < A) {
        bwd_product_rs(dv[x], pa, do_addr, wg * AW + x);
        bwd_product_rs(dk[x], ua, q_addr, wg * AW + x);
      }
    wgmma_commit();
    wgmma_wait0();
  }

  // land dK (rows 0 .. 63) and dV (rows 64 .. 127) in float32 over the
  // stage tiles, then sum the cluster's blocks rank by rank
  cp_async_wait_group<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wu + g + 8 * i;
#pragma unroll
    for (int x = 0; x < AW; ++x) {
      if (wg * AW + x >= A) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * (wg * AW + x) + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(red + r * RLD + col) =
            make_float2(dk[x][n][2 * i], dk[x][n][2 * i + 1]);
        *reinterpret_cast<float2*>(red + (kBwdRows + r) * RLD + col) =
            make_float2(dv[x][n][2 * i], dv[x][n][2 * i + 1]);
      }
    }
  }
  bwd_cluster_sync();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n_cl = rep / C, cl = blockIdx.x / C;
  const int upr = hd / 4;  // 4-value units a row
  const int units = 2 * kBwdRows * upr;
  const int u1 = (rank + 1) * units / C;
  for (int u = rank * units / C + tid; u < u1; u += threads) {
    const int which = u / (kBwdRows * upr);
    const int rem = u - which * kBwdRows * upr;
    const int r = rem / upr, c4 = rem - r * upr;
    const int key = k0 + r;
    if (key >= S) continue;
    const int at = (which * kBwdRows + r) * RLD + 4 * c4;
    // every rank's value in flight before the first add, then the adds in
    // rank order
    float4 x[kBwdMaxCluster];
#pragma unroll
    for (int src = 0; src < kBwdMaxCluster; ++src)
      if (src < C)
        x[src] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, src) + at);
    float4 sum = x[0];
#pragma unroll
    for (int src = 1; src < kBwdMaxCluster; ++src)
      if (src < C) {
        sum.x += x[src].x;
        sum.y += x[src].y;
        sum.z += x[src].z;
        sum.w += x[src].w;
      }
    const size_t o = (((size_t)b * S + key) * Hkv + h) * hd + 4 * c4;
    if (n_cl == 1) {
      __nv_bfloat16* dst = which ? a.dv : a.dk;
      *reinterpret_cast<uint2*>(dst + o) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    } else {
      const size_t n = (size_t)a.B * S * Hkv * hd;
      *reinterpret_cast<float4*>(a.part + ((size_t)which * n_cl + cl) * n +
                                 o) = sum;
    }
  }
  bwd_cluster_sync();  // no block leaves while another reads its rows
}

// dk, dv = the sums, in cluster order, of the clusters' float32 partials
// part (2, n_cl, n)
__global__ void bwd_sum_clusters(const float* __restrict__ part,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, long n,
                                 int n_cl) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * n) return;
  const int which = e >= n;
  const long i = e - which * n;
  const float* src = part + (size_t)which * n_cl * n + i;
  float s = 0.f;
  for (int c = 0; c < n_cl; ++c) s += src[(size_t)c * n];
  (which ? dv : dk)[i] = __float2bfloat16(s);
}

// head_dim in A atoms of 64; dK / dV in NH warpgroups (two past 128)
template <int A, int NH>
int launch_bwd_wgmma(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem(A);
  static_assert(smem <= (size_t)kMaxSmem, "tiles past shared memory");
  auto dq = bwd_dq_wgmma<A>;
  auto dkdv = bwd_dkdv_wgmma<A, NH>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int rep = a.Hq / a.Hkv, C = bwd_cluster(rep);
  const int tiles = (a.S + kBwdRows - 1) / kBwdRows;
  const long bh = (long)a.B * a.Hkv;
  if (tiles > 65535 || a.B > 65535 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  dq<<<dim3(a.Hq, a.B, tiles), 128, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rep, (unsigned)bh, tiles);
  cfg.blockDim = dim3(128 * NH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // the group's blocks in one cluster; launched as bwd_dq_wgmma's
  // programmatic dependent (it waits for D in griddep_wait)
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, dkdv, a);
  if (e != cudaSuccess) return (int)e;
  if (rep / C > 1) {
    const long n = (long)a.B * a.S * a.Hkv * a.hd;
    bwd_sum_clusters<<<(unsigned)((2 * n + 255) / 256), 256, 0, stream>>>(
        a.part, a.dk, a.dv, n, rep / C);
  }
  return (int)cudaGetLastError();
}

int launch_bwd_bf16(BwdArgs a, cudaStream_t stream) {
  if (a.hd < 1 || a.hd % 4 || a.Hkv < 1 || a.Hq % a.Hkv)
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) |
                        reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) |
                        reinterpret_cast<uintptr_t>(a.o) |
                        reinterpret_cast<uintptr_t>(a.dout) |
                        reinterpret_cast<uintptr_t>(a.dq) |
                        reinterpret_cast<uintptr_t>(a.dk) |
                        reinterpret_cast<uintptr_t>(a.dv);
  if (any % 8) return (int)cudaErrorInvalidValue;
  if (a.Hq / a.Hkv / bwd_cluster(a.Hq / a.Hkv) > 1 && a.part == nullptr)
    return (int)cudaErrorInvalidValue;
  a.copy_bytes = a.hd % 8 == 0 && any % 16 == 0 ? 16 : 8;
  a.scale = 1.0f / sqrtf((float)a.hd);
  if (a.hd <= 64) return launch_bwd_wgmma<1, 1>(a, stream);
  if (a.hd <= 128) return launch_bwd_wgmma<2, 1>(a, stream);
  if (a.hd <= 192) return launch_bwd_wgmma<3, 2>(a, stream);
  if (a.hd <= 256) return launch_bwd_wgmma<4, 2>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel, q_per_kv up to 64), 1 = bfloat16
// (tensor-core kernel, any q_per_kv); q, k, v and out share it. causal: 0
// or 1; window: 0 = none; softcap: 0 = none. lse: null, or (B, Hq, S)
// float32 that takes each query row's log-sum-exp of its kept scores (the
// backward's input). Returns cudaGetLastError() after the launch, 0 on
// success.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int S, int Hq, int Hkv, int hd,
                    int causal, int window, float softcap, int dtype,
                    void* stream) {
  float* ls = static_cast<float*>(lse);
  if (B == 0 || S == 0) return 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, ls, B, S, Hq, Hkv, hd, causal,
                         window, softcap, s);
  if (dtype == 1) {
    if (hd % 4 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
    return launch_bf16(q, k, v, out, ls, B, S, Hq, Hkv, hd, causal, window,
                       softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: q, out, dout, dq (B, S, Hq, hd); k, v, dk, dv (B, S, Hkv,
// hd), all of one type (dtype as above, any q_per_kv), 8-byte aligned; lse
// (B, Hq, S) float32 from the forward; dsum a float32 scratch of (B, Hq, S)
// (float32) or (B, Hq, S, 2) (bfloat16: each row's lse log2(e) and D).
// float32: pk, pv float32 scratch of (B, S, Hq, hd) each (the query
// heads' shares), unused (may be null) when Hq == Hkv. bfloat16: pk the
// float32 scratch (2, n, B, S, Hkv, hd) of the GQA clusters' sums when
// flash_attention_bwd_clusters gives n > 1, else unused (may be null); pv
// unused. Returns cudaGetLastError() after the launches, 0 on success.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* dsum, void* pk, void* pv, void* dq, void* dk,
                        void* dv, int B, int S, int Hq, int Hkv, int hd,
                        int causal, int window, float softcap, int dtype,
                        void* stream) {
  if (B == 0 || S == 0) return 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, out, dout, lse, dsum, pk, pv, dq, dk,
                             dv, B, S, Hq, Hkv, hd, causal, window, softcap,
                             s);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    BwdArgs a = {};
    a.q = static_cast<const bf*>(q);
    a.k = static_cast<const bf*>(k);
    a.v = static_cast<const bf*>(v);
    a.o = static_cast<const bf*>(out);
    a.dout = static_cast<const bf*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.stats = static_cast<float2*>(dsum);
    a.dq = static_cast<bf*>(dq);
    a.dk = static_cast<bf*>(dk);
    a.dv = static_cast<bf*>(dv);
    a.part = static_cast<float*>(pk);
    a.B = B, a.S = S, a.Hq = Hq, a.Hkv = Hkv, a.hd = hd;
    a.causal = causal, a.window = window, a.softcap = softcap;
    return launch_bwd_bf16(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 backward's GQA clusters a kv head (q_per_kv / its cluster
// size): above 1, flash_attention_bwd needs the partials scratch pk.
int flash_attention_bwd_clusters(int Hq, int Hkv) {
  if (Hkv < 1 || Hq % Hkv) return -1;
  return Hq / Hkv / bwd_cluster(Hq / Hkv);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
