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
// The split-KV design (flash_decode.cuh) cuts each (slot, kv head) into
// `splits` runs of `pages_per_split` pages, one thread block each; the
// block's page ids are read once into shared memory, so a row's address
// never waits on a block-table load, and a row's page is stepped per row
// without a division.
//
// Layouts (all contiguous): q, out (B, 1, Hq, hd); k/v pages (n_pages, page,
// Hkv, hd), head_dim a multiple of 4; block_table (B, P) int32; lengths
// (B,) int32. Head h of the output is kv head h / q_per_kv. Scratch from
// the caller: part_o (B, Hkv, splits, q_per_kv, hd) float32 and part_ml
// (B, Hkv, splits, q_per_kv, 2) float32.

#include "flash_decode.cuh"

namespace {

using namespace paged;

// Rows of a paged pool: token t of slot b lies on page
// block_table[b, t / ps] at row t % ps.
struct PagedRows {
  const int* block_table;
  int ps, P, n_pages, pages_per_split;
  size_t row_stride;  // Hkv * hd
  const int* pages;   // the split's page ids, in shared memory
  int p0, last;

  struct Cursor {
    const int* pages;
    int pc, pr, ps, last, n_pages;
    size_t row_stride;
    __device__ __forceinline__ size_t next(bool* ok) {
      const int page = pages[min(pc, last)];
      *ok = page >= 0 && page < n_pages;
      const size_t row = ((size_t)(*ok ? page : 0) * ps + pr) * row_stride;
      if (++pr == ps) {
        pr = 0;
        ++pc;
      }
      return row;
    }
  };

  __device__ __forceinline__ void setup(int b, int split, int len, int* smem,
                                        int* t0, int* t1) {
    const int n_live = min((len + ps - 1) / ps, P);
    p0 = split * pages_per_split;
    const int p1 = min(p0 + pages_per_split, n_live);
    for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x)
      smem[i] = block_table[(size_t)b * P + p0 + i];
    __syncthreads();
    pages = smem;
    last = p1 - p0 - 1;
    *t0 = p0 * ps;
    *t1 = min(p1 * ps, len);
  }

  __device__ __forceinline__ Cursor cursor(int, int t) const {
    return Cursor{pages, t / ps - p0, t % ps, ps, last, n_pages, row_stride};
  }
};

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
  PagedRows rows{};
  rows.block_table = static_cast<const int*>(block_table);
  rows.ps = ps;
  rows.P = P;
  rows.n_pages = n_pages;
  rows.pages_per_split = pages_per_split;
  rows.row_stride = (size_t)Hkv * hd;
  const int* lens = static_cast<const int*>(lengths);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * (size_t)pages_per_split;
  if (dtype == 0)
    return decode_launch<float>(q, k_pages, v_pages, rows, lens, po, pml, out,
                                B, Hq, Hkv, hd, splits, smem, s);
  if (dtype == 1)
    return decode_launch<__nv_bfloat16>(q, k_pages, v_pages, rows, lens, po,
                                        pml, out, B, Hq, Hkv, hd, splits,
                                        smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
