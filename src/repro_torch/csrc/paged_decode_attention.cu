// Paged flash-decode attention for Hopper (sm_90a): one new query token per
// slot against a paged KV pool, read through the block table.
//
// Replaces the TPU kernels
//   src/repro/kernels/paged_decode_attention/kernel.py
//   paged_decode_attention_pallas (_paged_dec_kernel), and
//   paged_decode_attention_quant_pallas (_paged_dec_kernel_quant), the same
//   over an int8 / float8 e4m3 pool with an f32 scale per (page, kv head),
// and computes what they compute: all q_per_kv query heads of one KV head
// read the same K/V pages, with an online softmax across pages; pages past
// ceil(len / page) and unmapped (-1) pages are skipped; keys at or past len
// carry no weight; a slot of length 0 returns zeros. A float pool may store
// another float type than the query's, as the Pallas kernels cast to f32
// inside.
//
// The split-KV design (flash_decode.cuh) cuts each (slot, kv head) into
// `splits` runs of `pages_per_split` pages, one thread block each, and
// merges the runs inside the thread-block cluster they form. A bfloat16
// query over a bfloat16, int8 or fp8 pool runs decode_kernel_mma (bf16
// tensor cores, 64-key tiles gathered through the block table into a
// cp.async ring, so a tile spans pages of 8, 12 or 16 keys and a 64-key
// page fills one); a float32 query or pool runs the scalar decode_kernel,
// whose block reads its split's page ids (and a quantized pool's scales of
// its kv head) once into shared memory. A quantized pool moves 1 byte per
// element (plus 8 bytes of scales per page and kv head) where bf16 moves 2,
// so its bound is about half the bf16 kernel's.
//
// Layouts (all contiguous): q, out (B, 1, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of 4 and of the values in 8 bytes of the
// pool type; k/v scales (n_pages, Hkv) float32 (quantized pools only);
// block_table (B, P) int32; lengths (B,) int32. Head h of the output is kv
// head h / q_per_kv.

#include "flash_decode.cuh"

namespace {

using namespace paged;

// Rows of a paged pool: token t of slot b lies on page
// block_table[b, t / ps] at row t % ps. The scalar kernel's shared memory
// holds the split's page ids, then, for a quantized pool, its pages' K
// scales and their V scales (0 for an unmapped page, whose rows are never
// read).
struct PagedRows {
  const int* block_table;
  const float* k_scales;  // (n_pages, Hkv); null for a float pool
  const float* v_scales;
  int ps, P, n_pages, Hkv, pages_per_split;
  size_t row_stride;  // Hkv * hd
  const int* pages;   // the split's page ids, in shared memory
  const float* sks;   // their K scales, in shared memory
  const float* svs;   // their V scales
  int p0, last;

  static size_t smem_bytes(int pages_per_split) {
    return (sizeof(int) + 2 * sizeof(float)) * (size_t)pages_per_split;
  }

  // the tensor-core kernel's interface
  __device__ __forceinline__ void span(int split, int* t0,
                                       int* t_end) const {
    const int p = split * pages_per_split;
    *t0 = p * ps;
    *t_end = min(p + pages_per_split, P) * ps;
  }
  __device__ __forceinline__ long long locate(int b, int t, int* page) const {
    const int pi = t / ps;
    const int pg = block_table[(size_t)b * P + pi];
    *page = pg;
    if (pg < 0 || pg >= n_pages) return -1;
    return ((long long)pg * ps + (t - pi * ps)) * (long long)row_stride;
  }

  // the scalar kernel's interface
  struct Cursor {
    const int* pages;
    int pc, pr, ps, last, n_pages;
    size_t row_stride;
    __device__ __forceinline__ size_t next(bool* ok, int* pg) {
      const int i = min(pc, last);
      const int page = pages[i];
      *ok = page >= 0 && page < n_pages;
      *pg = i;
      const size_t row = ((size_t)(*ok ? page : 0) * ps + pr) * row_stride;
      if (++pr == ps) {
        pr = 0;
        ++pc;
      }
      return row;
    }
  };

  __device__ __forceinline__ void setup(int b, int h, int split, int len,
                                        int* smem, int* t0, int* t1) {
    const int n_live = min((len + ps - 1) / ps, P);
    p0 = split * pages_per_split;
    const int p1 = min(p0 + pages_per_split, n_live);
    float* ks = reinterpret_cast<float*>(smem + pages_per_split);
    float* vs = ks + pages_per_split;
    for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x) {
      const int page = block_table[(size_t)b * P + p0 + i];
      smem[i] = page;
      if (k_scales) {
        const bool in = page >= 0 && page < n_pages;
        ks[i] = in ? k_scales[(size_t)page * Hkv + h] : 0.f;
        vs[i] = in ? v_scales[(size_t)page * Hkv + h] : 0.f;
      }
    }
    __syncthreads();
    pages = smem;
    sks = ks;
    svs = vs;
    last = p1 - p0 - 1;
    *t0 = p0 * ps;
    *t1 = min(p1 * ps, len);
  }

  __device__ __forceinline__ Cursor cursor(int, int t) const {
    return Cursor{pages, t / ps - p0, t % ps, ps, last, n_pages, row_stride};
  }

  __device__ __forceinline__ float2 scales(int pg) const {
    return make_float2(sks[pg], svs[pg]);
  }
};

template <typename TQ>
int launch_scalar(const void* q, const void* k, const void* v,
                  PagedRows rows, const int* lens, void* out, int B, int Hq,
                  int Hkv, int hd, int splits, size_t smem, int kv_dtype,
                  cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return decode_launch<TQ, float>(q, k, v, rows, lens, out, B, Hq, Hkv,
                                      hd, splits, smem, s);
    case 1:
      return decode_launch<TQ, __nv_bfloat16>(q, k, v, rows, lens, out, B, Hq,
                                              Hkv, hd, splits, smem, s);
    case 2:
      return decode_launch<TQ, int8_t>(q, k, v, rows, lens, out, B, Hq, Hkv,
                                       hd, splits, smem, s);
    case 3:
      return decode_launch<TQ, __nv_fp8_e4m3>(q, k, v, rows, lens, out, B, Hq,
                                              Hkv, hd, splits, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (pools): 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = float8 e4m3; the scales are given
// for 2 and 3 and null otherwise. splits (at most the cluster size, 8) *
// pages_per_split must cover P. Routing by type: a bfloat16 query over a
// bfloat16, int8 or fp8 pool runs on the tensor cores; a float32 query, or
// a float32 pool, on the scalar kernel. Returns cudaGetLastError() after
// the launch, 0 on success.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scales,
                           const void* v_scales, const void* block_table,
                           const void* lengths, void* out, int B, int Hq,
                           int Hkv, int hd, int ps, int P, int n_pages,
                           int splits, int pages_per_split, int q_dtype,
                           int kv_dtype, void* stream) {
  if (B == 0) return 0;
  const bool quant = kv_dtype >= 2;
  if (splits < 1 || splits > kDecodeMaxSplits || pages_per_split < 1 ||
      (long long)splits * pages_per_split < P || ps < 1 || Hkv < 1 ||
      Hq % Hkv || quant != (k_scales != nullptr) ||
      quant != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  PagedRows rows{};
  rows.block_table = static_cast<const int*>(block_table);
  rows.k_scales = static_cast<const float*>(k_scales);
  rows.v_scales = static_cast<const float*>(v_scales);
  rows.ps = ps;
  rows.P = P;
  rows.n_pages = n_pages;
  rows.Hkv = Hkv;
  rows.pages_per_split = pages_per_split;
  rows.row_stride = (size_t)Hkv * hd;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype != 0) {
    const bool a16 = (reinterpret_cast<uintptr_t>(k_pages) |
                      reinterpret_cast<uintptr_t>(v_pages)) % 16 == 0;
    const int keys = pages_per_split * ps;
    switch (kv_dtype) {
      case 1:
        return decode_mma_launch<__nv_bfloat16>(q, k_pages, v_pages, rows,
                                                lens, out, B, Hq, Hkv, hd,
                                                splits, keys, a16, s);
      case 2:
        return decode_mma_launch<int8_t>(q, k_pages, v_pages, rows, lens, out,
                                         B, Hq, Hkv, hd, splits, keys, a16, s);
      case 3:
        return decode_mma_launch<__nv_fp8_e4m3>(q, k_pages, v_pages, rows,
                                                lens, out, B, Hq, Hkv, hd,
                                                splits, keys, a16, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = PagedRows::smem_bytes(pages_per_split);
  if (q_dtype == 0)
    return launch_scalar<float>(q, k_pages, v_pages, rows, lens, out, B, Hq,
                                Hkv, hd, splits, smem, kv_dtype, s);
  if (q_dtype == 1)
    return launch_scalar<__nv_bfloat16>(q, k_pages, v_pages, rows, lens, out,
                                        B, Hq, Hkv, hd, splits, smem,
                                        kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
