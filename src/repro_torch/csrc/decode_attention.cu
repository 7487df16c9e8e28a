// Flash-decode attention over a dense KV cache for Hopper (sm_90a): one new
// query token per slot against the slot's (S, Hkv, hd) cache rows.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/kernel.py
//   decode_attention_pallas (_dec_kernel)
// and computes what it computes: all q_per_kv query heads of one KV head
// read the same K/V rows, with an online softmax over positions
// < lengths[b] (capped at S); rows past a slot's length are never read,
// whatever S is (no tile has to divide it); a slot of length 0 returns
// zeros. The output is in the input dtype.
//
// The dense cache is the paged layout with an identity block table, so this
// kernel is the paged decode kernel's device code (flash_decode.cuh) with a
// row locator that steps through the slot's own rows: each (slot, kv head)
// is cut into `splits` runs of `tokens_per_split` positions, one thread
// block each, merged inside the thread-block cluster they form. A bfloat16
// cache runs decode_kernel_mma (64-row tiles of the slot's rows in a
// cp.async ring, bf16 tensor cores), a float32 one the scalar
// decode_kernel. The cache is read in place through its slot and row
// strides: the TPU kernel's moveaxis to (B, Hkv, S, hd) would cost a copy
// of the whole cache per layer and step.
//
// Layouts: q, out (B, 1, Hq, hd) contiguous; k/v cache (B, S, Hkv, hd) with
// the last two dimensions contiguous and slot / row strides given in
// elements (a slice of a larger cache works); head_dim a multiple of 4;
// lengths (B,) int32.

#include "flash_decode.cuh"

namespace {

using namespace paged;

// Rows of a dense cache: token t of slot b lies at b * stride_b + t *
// stride_s.
struct DenseRows {
  int S, tokens_per_split;
  size_t stride_b, stride_s;

  // the tensor-core kernel's interface
  __device__ __forceinline__ void span(int split, int* t0,
                                       int* t_end) const {
    *t0 = split * tokens_per_split;
    *t_end = min(*t0 + tokens_per_split, S);
  }
  __device__ __forceinline__ long long locate(int b, int t, int* page) const {
    *page = 0;
    return (long long)((size_t)b * stride_b + (size_t)t * stride_s);
  }

  // the scalar kernel's interface
  struct Cursor {
    size_t off, stride_s;
    __device__ __forceinline__ size_t next(bool* ok, int* pg) {
      *ok = true;
      *pg = 0;
      const size_t row = off;
      off += stride_s;
      return row;
    }
  };

  __device__ __forceinline__ void setup(int, int, int split, int len, int*,
                                        int* t0, int* t1) const {
    *t0 = split * tokens_per_split;
    *t1 = min(min(*t0 + tokens_per_split, len), S);
  }

  __device__ __forceinline__ Cursor cursor(int b, int t) const {
    return Cursor{(size_t)b * stride_b + (size_t)t * stride_s, stride_s};
  }

  // a dense cache is a float cache: no scales
  __device__ __forceinline__ float2 scales(int) const {
    return make_float2(1.f, 1.f);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, cache and out share it). splits (at
// most the cluster size, 8) * tokens_per_split must cover S. Returns
// cudaGetLastError() after the launch, 0 on success.
int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                     const void* lengths, void* out, int B, int Hq, int Hkv,
                     int hd, int S, long long stride_b, long long stride_s,
                     int splits, int tokens_per_split, int dtype,
                     void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || splits > kDecodeMaxSplits || tokens_per_split < 1 ||
      (long long)splits * tokens_per_split < S || stride_b < 0 ||
      stride_s < 0)
    return (int)cudaErrorInvalidValue;
  DenseRows rows{};
  rows.S = S;
  rows.tokens_per_split = tokens_per_split;
  rows.stride_b = (size_t)stride_b;
  rows.stride_s = (size_t)stride_s;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_launch<float, float>(q, k_cache, v_cache, rows, lens, out,
                                       B, Hq, Hkv, hd, splits, 0, s);
  if (dtype == 1) {
    // 16-byte pieces where every row starts on 16 bytes
    const bool a16 = (reinterpret_cast<uintptr_t>(k_cache) |
                      reinterpret_cast<uintptr_t>(v_cache)) % 16 == 0 &&
                     (stride_b * 2) % 16 == 0 && (stride_s * 2) % 16 == 0;
    return decode_mma_launch<__nv_bfloat16>(q, k_cache, v_cache, rows, lens,
                                            out, B, Hq, Hkv, hd, splits,
                                            tokens_per_split, a16, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
