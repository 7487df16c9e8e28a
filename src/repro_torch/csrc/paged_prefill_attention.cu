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
// unmapped (-1) pages are skipped; rows with lens == 0 exit at once. A
// float pool may store another float type than the query's, as the Pallas
// kernels cast to f32 inside.
//
// What bounds it on the H100: the larger of its flops, 4 * hd per (query,
// key) pair it attends, over the card's peak rate, and its bytes (q and out,
// plus each mapped K/V page of the row) over 3.35 TB/s. At the serving
// shapes (C = 128, contexts of a few hundred tokens) the flops dominate.
//
// What the design does about that, for now: query rows past lens[r] are
// skipped, and each block walks only the pages its causal window reaches,
// so no flop is spent on masked-out work beyond one page tile's edge. The
// arithmetic itself is scalar f32 FMAs from shared memory, well below the
// tensor-core peak; moving the two products onto wgmma with TMA-fed tiles is
// the next step. The TPU's sequential page axis with carried VMEM scratch
// becomes a loop over pages inside one block with an f32 running max,
// running sum and accumulator in shared memory.
//
// Grid: (R, Hkv, ceil(q_per_kv * C / kQTile)). Query row j of (row, kv head)
// is head h * q_per_kv + j / C at chunk position j % C. Rows of a block that
// are past lens[r] are written as zeros (the caller discards them).
//
// Each page tile is read in 8-byte pieces of the pool's storage type TKV
// (2 float32, 4 bf16, 8 int8 / fp8 values), kLoadBatch of K and of V in
// flight per thread before any is converted, and is dequantized into the
// f32 tile in shared memory by its (page, kv head) scale as it lands (1 for
// a float pool), as the Pallas kernels dequantize right after the page DMA.
// Queries are read and outputs written in the query type TQ.
//
// Layouts (all contiguous): q, out (R, C, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of the values in 8 bytes of TKV; k/v scales
// (n_pages, Hkv) float32 (quantized pools only); block_rows (R, P) int32;
// offsets, lens (R,) int32.

#include "common.cuh"

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

template <typename TQ>
int launch_q(const void* q, const void* k_pages, const void* v_pages,
             const float* k_scales, const float* v_scales,
             const int* block_rows, const int* offsets, const int* lens,
             void* out, int R, int C, int Hq, int Hkv, int hd, int ps, int P,
             int n_pages, int kv_dtype, cudaStream_t s) {
#define PAGED_PREFILL_LAUNCH(TKV)                                            \
  return launch<TQ, TKV>(q, k_pages, v_pages, k_scales, v_scales,            \
                         block_rows, offsets, lens, out, R, C, Hq, Hkv, hd,  \
                         ps, P, n_pages, s)
  switch (kv_dtype) {
    case 0: PAGED_PREFILL_LAUNCH(float);
    case 1: PAGED_PREFILL_LAUNCH(__nv_bfloat16);
    case 2: PAGED_PREFILL_LAUNCH(int8_t);
    case 3: PAGED_PREFILL_LAUNCH(__nv_fp8_e4m3);
  }
#undef PAGED_PREFILL_LAUNCH
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
  if (R == 0 || C == 0) return 0;
  const bool quant = kv_dtype >= 2;
  if (quant != (k_scales != nullptr) || quant != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* rows = static_cast<const int*>(block_rows);
  const int* offs = static_cast<const int*>(offsets);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(q, k_pages, v_pages, ks, vs, rows, offs, ln, out,
                           R, C, Hq, Hkv, hd, ps, P, n_pages, kv_dtype, s);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, rows, offs,
                                   ln, out, R, C, Hq, Hkv, hd, ps, P, n_pages,
                                   kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
