// Paged flash-decode attention for Hopper (sm_90a): one new query token per
// slot against a paged KV pool, read through the block table.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_decode_attention/kernel.py
//   paged_decode_attention_pallas (_paged_dec_kernel)
// and computes what it computes: all q_per_kv query heads of one KV head
// read the same K/V pages, with an online softmax across pages; pages past
// ceil(len / page) and unmapped (-1) pages are skipped; keys at or past len
// carry no weight; a slot of length 0 returns zeros.
//
// What bounds it on the H100: the K/V bytes it must read, sum over slots of
// len * n_kv * head_dim * 2 * sizeof(T), over 3.35 TB/s. Its arithmetic is
// 4 * q_per_kv flops per K/V element, far below the card's balance point, so
// the whole design is about keeping enough loads in flight.
//
// What the design does about that (split-KV flash decoding):
//  - The TPU walks a slot's pages in order on one core, carrying the softmax
//    state in VMEM scratch. Here each (slot, kv head) is cut into `splits`
//    runs of `pages_per_split` pages, one thread block each, so that a batch
//    of 8 slots still puts several blocks on every SM. A second, small
//    kernel merges the splits' (max, sum, accumulator) partials.
//  - One warp per query head of the group: the q_per_kv warps of a block
//    read the same K/V rows, which the first of them brings into L1, so
//    device memory sees each K/V byte once.
//  - Lanes run along head_dim eight bytes at a time (4 bf16 or 2 float32
//    values), so a warp's load of a 128-wide bf16 row is one contiguous
//    256-byte request. Each warp loads kUnroll rows of K and V as raw bits
//    before it converts or uses any, which keeps 2 * kUnroll * NI loads of
//    each lane in flight (converting each value as it arrives would make
//    every load wait for the one before).
//  - The block's page ids are read once into shared memory, so a row's
//    address never waits on a block-table load.
//  - Softmax state and accumulator live in registers, in float32.
//
// Layouts (all contiguous): q, out (B, 1, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of 4; block_table (B, P) int32; lengths
// (B,) int32. Head h of the output is kv head h / q_per_kv. Scratch from
// the caller: part_o (B, Hkv, splits, q_per_kv, hd) float32 and part_ml
// (B, Hkv, splits, q_per_kv, 2) float32.

#include "common.cuh"

namespace {

using namespace paged;

constexpr int kMaxWarps = 8;

// One block per (split, kv head, slot); warp w serves query heads w,
// w + n_warps, ... of the group over the split's pages. Lane l holds
// elements [VEC * (l + 32 i), VEC * (l + 32 i) + VEC) of a row, i < NI.
template <typename T, int NI, int kUnroll>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ block_table,
                     const int* __restrict__ lengths,
                     float* __restrict__ part_o, float* __restrict__ part_ml,
                     int Hq, int Hkv, int hd, int ps, int P, int n_pages,
                     int pages_per_split, float scale) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::kN;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ int pages[];  // (pages_per_split,)

  const int len = lengths[b];
  const int n_live = min((len + ps - 1) / ps, P);
  const int p0 = split * pages_per_split;
  const int p1 = min(p0 + pages_per_split, n_live);
  for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x)
    pages[i] = block_table[(size_t)b * P + p0 + i];
  __syncthreads();

  const int t0 = p0 * ps;
  const int t1 = min(p1 * ps, len);
  const size_t row_stride = (size_t)Hkv * hd;
  bool lane_in[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) lane_in[i] = VEC * (lane + 32 * i) < hd;

  for (int r = warp; r < rep; r += n_warps) {
    float qr[NI][VEC], acc[NI][VEC];
    const T* q_row = q + ((size_t)b * Hq + (size_t)h * rep + r) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      Raw raw = {};
      if (lane_in[i])
        raw = *reinterpret_cast<const Raw*>(q_row + VEC * (lane + 32 * i));
      V::unpack(raw, qr[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
    }
    float m = kNegInf, l = 0.f;

    for (int t = t0; t < t1; t += kUnroll) {
      // issue every load of the kUnroll rows before any is used; a row
      // with no key (past the split's end, or an unmapped page) reads
      // page 0's row instead and is masked out of the softmax below
      Raw kr[kUnroll][NI], vr[kUnroll][NI];
      bool ok[kUnroll];
      // (page column, row in page) of token t + u, stepped without a
      // division per row
      int pc = t / ps - p0, pr = t % ps;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int page = pages[min(pc, p1 - p0 - 1)];
        ok[u] = t + u < t1 && page >= 0 && page < n_pages;
        const size_t row = ((size_t)(ok[u] ? page : 0) * ps + pr) *
                               row_stride + (size_t)h * hd;
        if (++pr == ps) {
          pr = 0;
          ++pc;
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          kr[u][i] = vr[u][i] = Raw{};
          if (lane_in[i]) {
            const size_t off = row + VEC * (lane + 32 * i);
            kr[u][i] = *reinterpret_cast<const Raw*>(k_pages + off);
            vr[u][i] = *reinterpret_cast<const Raw*>(v_pages + off);
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
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float vf[VEC];
          V::unpack(vr[u][i], vf);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(p, vf[j], acc[i][j]);
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
__global__ void paged_decode_merge(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   T* __restrict__ out, int Hq, int Hkv,
                                   int hd, int splits, int n_out) {
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

template <typename T, int NI>
int launch_ni(const T* q, const T* k_pages, const T* v_pages,
              const int* block_table, const int* lengths, float* part_o,
              float* part_ml, T* out, int B, int Hq, int Hkv, int hd, int ps,
              int P, int n_pages, int splits, int pages_per_split,
              cudaStream_t stream) {
  constexpr int kUnroll = 16 / NI;
  const int rep = Hq / Hkv;
  const int warps = rep < kMaxWarps ? rep : kMaxWarps;
  const dim3 grid(splits, Hkv, B);
  const size_t smem = sizeof(int) * (size_t)pages_per_split;
  paged_decode_partial<T, NI, kUnroll><<<grid, warps * 32, smem, stream>>>(
      q, k_pages, v_pages, block_table, lengths, part_o, part_ml, Hq, Hkv, hd,
      ps, P, n_pages, pages_per_split, 1.0f / sqrtf((float)hd));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_out = B * Hq * hd;
  paged_decode_merge<T><<<(n_out + 127) / 128, 128, 0, stream>>>(
      part_o, part_ml, out, Hq, Hkv, hd, splits, n_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* lengths, float* part_o,
           float* part_ml, void* out, int B, int Hq, int Hkv, int hd, int ps,
           int P, int n_pages, int splits, int pages_per_split,
           cudaStream_t stream) {
  // rows are read eight bytes at a time
  if (hd % Vec<T>::kN) return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pages);
  const T* vt = static_cast<const T*>(v_pages);
  T* ot = static_cast<T*>(out);
  const int per_pass = 32 * Vec<T>::kN;  // elements a warp loads at once
#define PAGED_DECODE_LAUNCH(NI)                                              \
  return launch_ni<T, NI>(qt, kt, vt, block_table, lengths, part_o, part_ml, \
                          ot, B, Hq, Hkv, hd, ps, P, n_pages, splits,        \
                          pages_per_split, stream)
  if (hd <= per_pass) PAGED_DECODE_LAUNCH(1);
  if (hd <= 2 * per_pass) PAGED_DECODE_LAUNCH(2);
  if (hd <= 4 * per_pass) PAGED_DECODE_LAUNCH(4);
#undef PAGED_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). splits *
// pages_per_split must cover P. Returns cudaGetLastError() after the
// launches, 0 on success.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_table,
                           const void* lengths, void* part_o, void* part_ml,
                           void* out, int B, int Hq, int Hkv, int hd, int ps,
                           int P, int n_pages, int splits,
                           int pages_per_split, int dtype, void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || pages_per_split < 1 ||
      (long long)splits * pages_per_split < P)
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tbl, lens, po, pml, out, B, Hq,
                         Hkv, hd, ps, P, n_pages, splits, pages_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, po, pml, out,
                                 B, Hq, Hkv, hd, ps, P, n_pages, splits,
                                 pages_per_split, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
