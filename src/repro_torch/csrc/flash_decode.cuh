// Split-KV flash decoding for Hopper, shared by the paged and the dense
// decode kernels: one new query token per slot against the slot's cached
// K/V rows, however those rows are located.
//
// What bounds it on the H100: the K/V bytes it must read, sum over slots of
// len * n_kv * head_dim * 2 * sizeof(TKV) (plus one f32 scale per page and
// kv head of a quantized pool), over 3.35 TB/s. Its arithmetic is
// 4 * q_per_kv flops per K/V element, far below the card's balance point, so
// the whole design is about keeping enough loads in flight.
//
// The query type TQ (float32, bfloat16; also the output's) and the pool's
// storage type TKV (float32, bfloat16, int8, float8 e4m3) are separate
// template parameters: a pool narrower or wider than the compute type, or
// quantized, is read at its own width and converted to f32 in registers.
// A quantized row is scaled by its (page, kv head) scale, which the Rows
// policy holds per page of the split: the K scale is folded into the row's
// dot product, s = scale_k * (q . k), and the V scale into its softmax
// weight, so each costs one multiply a row, not one an element. A float
// pool compiles none of it (Vec<TKV>::kScaled is false).
//
// What the design does about that:
//  - The TPU walks a slot's cache in order on one core, carrying the softmax
//    state in VMEM scratch. Here each (slot, kv head) is cut into `splits`
//    runs of rows, one thread block each, so that a batch of 8 slots still
//    puts several blocks on every SM. A second, small kernel merges the
//    splits' (max, sum, accumulator) partials.
//  - One warp per query head of the group: the q_per_kv warps of a block
//    read the same K/V rows, which the first of them brings into L1, so
//    device memory sees each K/V byte once.
//  - Lanes run along head_dim eight bytes at a time (8 int8 / fp8, 4 bf16
//    or 2 float32 values), so a warp's load of a 128-wide bf16 row is one
//    contiguous 256-byte request. Each warp loads kUnroll rows of K and V
//    as raw bits before it converts or uses any, which keeps 2 * kUnroll
//    * NI loads of each lane in flight (converting each value as it
//    arrives would make every load wait for the one before).
//  - A row that holds no key (past the slot's length, past the split, or on
//    an unmapped page) is not loaded at all: it reads as zeros and carries
//    no weight, so whatever bytes lie there (NaN included) never reach the
//    sums.
//  - Softmax state and accumulator live in registers, in float32.
//
// How a row is found is the `Rows` policy of the caller:
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
// h / q_per_kv; head_dim a multiple of the values in eight bytes of TKV (8
// int8 / fp8, 4 bf16, 2 float32). Scratch from the caller: part_o (B, Hkv,
// splits, q_per_kv, hd) float32 and part_ml (B, Hkv, splits, q_per_kv, 2)
// float32.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int kDecodeMaxWarps = 8;
constexpr int kDecodeMaxHeadDim = 256;  // MAX_HEAD_DIM of models/config.py

// One block per (split, kv head, slot); warp w serves query heads w,
// w + n_warps, ... of the group over the split's rows. Lane l holds
// elements [VEC * (l + 32 i), VEC * (l + 32 i) + VEC) of a row, i < NI.
template <typename TQ, typename TKV, int NI, int kUnroll, typename Rows>
__global__ void __launch_bounds__(kDecodeMaxWarps * 32)
decode_partial(const TQ* __restrict__ q, const TKV* __restrict__ k,
               const TKV* __restrict__ v, Rows rows,
               const int* __restrict__ lengths, float* __restrict__ part_o,
               float* __restrict__ part_ml, int Hq, int Hkv, int hd,
               float scale) {
  using V = Vec<TKV>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  constexpr bool kScaled = V::kScaled;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ int smem[];
  int t0, t1;
  rows.setup(b, h, split, lengths[b], smem, &t0, &t1);

  const size_t head_off = (size_t)h * hd;
  bool lane_in[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) lane_in[i] = VEC * (lane + 32 * i) < hd;

  for (int r = warp; r < rep; r += n_warps) {
    float qr[NI][VEC], acc[NI][VEC];
    const TQ* q_row = q + ((size_t)b * Hq + (size_t)h * rep + r) * hd;
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

    const size_t part = (((size_t)b * Hkv + h) * splits + split) * rep + r;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (!lane_in[i]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        part_o[part * hd + VEC * (lane + 32 * i) + j] = acc[i][j];
    }
    if (lane == 0) {
      part_ml[2 * part] = m;
      part_ml[2 * part + 1] = l;
    }
  }
}

// One thread per output element (slot, query head, d):
// out = sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max_s m_s).
// A slot with no keys (every l_s == 0) gets 0. The 32 threads of a warp
// share (slot, head), so their reads of (m_s, l_s) are one broadcast.
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             T* __restrict__ out, int Hq, int Hkv, int hd,
                             int splits, int n_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int d = e % hd, head = (e / hd) % Hq, b = e / hd / Hq;
  const int rep = Hq / Hkv, h = head / rep, r = head % rep;
  const size_t base = ((size_t)b * Hkv + h) * splits;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_ml[2 * ((base + s) * rep + r)]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const size_t p = (base + s) * rep + r;
    const float w = expf(part_ml[2 * p] - mx);
    num = fmaf(w, part_o[p * hd + d], num);
    den = fmaf(w, part_ml[2 * p + 1], den);
  }
  out[e] = from_f32<T>(den == 0.f ? 0.f : num / den);
}

template <typename TQ, typename TKV, int NI, typename Rows>
int decode_launch_ni(const TQ* q, const TKV* k, const TKV* v, Rows rows,
                     const int* lengths, float* part_o, float* part_ml,
                     TQ* out, int B, int Hq, int Hkv, int hd, int splits,
                     size_t smem, cudaStream_t stream) {
  constexpr int kUnroll = 16 / NI;
  const int rep = Hq / Hkv;
  const int warps = rep < kDecodeMaxWarps ? rep : kDecodeMaxWarps;
  const dim3 grid(splits, Hkv, B);
  decode_partial<TQ, TKV, NI, kUnroll, Rows>
      <<<grid, warps * 32, smem, stream>>>(
      q, k, v, rows, lengths, part_o, part_ml, Hq, Hkv, hd,
      1.0f / sqrtf((float)hd));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_out = B * Hq * hd;
  decode_merge<TQ><<<(n_out + 127) / 128, 128, 0, stream>>>(
      part_o, part_ml, out, Hq, Hkv, hd, splits, n_out);
  return (int)cudaGetLastError();
}

// Picks the lanes' elements per row (NI) from head_dim and launches both
// kernels; only the NI a head_dim up to kDecodeMaxHeadDim can need are
// instantiated. `smem` is the Rows policy's shared-memory need in bytes.
template <typename TQ, typename TKV, typename Rows>
int decode_launch(const void* q, const void* k, const void* v, Rows rows,
                  const int* lengths, float* part_o, float* part_ml,
                  void* out, int B, int Hq, int Hkv, int hd, int splits,
                  size_t smem, cudaStream_t stream) {
  constexpr int kPerPass = 32 * Vec<TKV>::kN;  // elements a warp loads at once
  // rows are read eight bytes at a time
  if (hd % Vec<TKV>::kN || hd > kDecodeMaxHeadDim || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  TQ* ot = static_cast<TQ*>(out);
#define FLASH_DECODE_LAUNCH(NI)                                               \
  return decode_launch_ni<TQ, TKV, NI, Rows>(qt, kt, vt, rows, lengths,       \
                                             part_o, part_ml, ot, B, Hq, Hkv, \
                                             hd, splits, smem, stream)
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

}  // namespace paged
