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
// `splits` runs of `pages_per_split` pages, one thread block each; the
// block's page ids, and for a quantized pool the pages' K and V scales of
// its kv head, are read once into shared memory, so a row's address and
// scale never wait on a global load, and a row's page is stepped per row
// without a division. A quantized pool moves 1 byte per element (plus 8
// bytes of scales per page and kv head) where bf16 moves 2, so its bound
// is about half the bf16 kernel's.
//
// Layouts (all contiguous): q, out (B, 1, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of the values in 8 bytes of the pool type;
// k/v scales (n_pages, Hkv) float32 (quantized pools only); block_table
// (B, P) int32; lengths (B,) int32. Head h of the output is kv head
// h / q_per_kv. Scratch from the caller: part_o (B, Hkv, splits, q_per_kv,
// hd) float32 and part_ml (B, Hkv, splits, q_per_kv, 2) float32.

#include "flash_decode.cuh"

namespace {

using namespace paged;

// Rows of a paged pool: token t of slot b lies on page
// block_table[b, t / ps] at row t % ps. Shared memory holds the split's
// page ids, then, for a quantized pool, its pages' K scales and their V
// scales (0 for an unmapped page, whose rows are never read).
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
int launch_q(const void* q, const void* k, const void* v, PagedRows rows,
             const int* lens, float* po, float* pml, void* out, int B,
             int Hq, int Hkv, int hd, int splits, size_t smem, int kv_dtype,
             cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return decode_launch<TQ, float>(q, k, v, rows, lens, po, pml, out, B,
                                      Hq, Hkv, hd, splits, smem, s);
    case 1:
      return decode_launch<TQ, __nv_bfloat16>(q, k, v, rows, lens, po, pml,
                                              out, B, Hq, Hkv, hd, splits,
                                              smem, s);
    case 2:
      return decode_launch<TQ, int8_t>(q, k, v, rows, lens, po, pml, out, B,
                                       Hq, Hkv, hd, splits, smem, s);
    case 3:
      return decode_launch<TQ, __nv_fp8_e4m3>(q, k, v, rows, lens, po, pml,
                                              out, B, Hq, Hkv, hd, splits,
                                              smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (pools): 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = float8 e4m3; the scales are given
// for 2 and 3 and null otherwise. splits * pages_per_split must cover P.
// Returns cudaGetLastError() after the launches, 0 on success.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scales,
                           const void* v_scales, const void* block_table,
                           const void* lengths, void* part_o, void* part_ml,
                           void* out, int B, int Hq, int Hkv, int hd, int ps,
                           int P, int n_pages, int splits,
                           int pages_per_split, int q_dtype, int kv_dtype,
                           void* stream) {
  if (B == 0) return 0;
  const bool quant = kv_dtype >= 2;
  if (splits < 1 || pages_per_split < 1 ||
      (long long)splits * pages_per_split < P ||
      quant != (k_scales != nullptr) || quant != (v_scales != nullptr))
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
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = PagedRows::smem_bytes(pages_per_split);
  if (q_dtype == 0)
    return launch_q<float>(q, k_pages, v_pages, rows, lens, po, pml, out, B,
                           Hq, Hkv, hd, splits, smem, kv_dtype, s);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(q, k_pages, v_pages, rows, lens, po, pml,
                                   out, B, Hq, Hkv, hd, splits, smem,
                                   kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
