// Row RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale,
// the mean in float32, the output in x's type (float32 or bfloat16).
//
// Replaces the TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py
//   rmsnorm_pallas (_rms_kernel)
// and computes what it computes. The TPU kernel tiles rows by multiples of
// 8 sublanes with the whole row in the lane dimension; here one warp owns a
// row and eight warps a block, so any row count works (a block's warps past
// the last row exit). Each lane reads 16 bytes at a time (4 float32 or 8
// bfloat16 values), neighbouring lanes on neighbouring addresses: one pass
// sums the squares, a warp shuffle reduces them, and a second pass reads
// the row again (from L1 or L2, where the first pass left it), scales it
// and writes it.
//
// What bounds it on the H100: bytes. It reads x once from device memory
// and writes out once (the scale vector stays in cache), 4 x D x R bytes
// for a bfloat16 x at 3.35 TB/s; its D multiply-adds a row are far below
// the card's rate.
//
// Layouts: x, out (R, D) contiguous, 16-byte aligned; scale (D,) float32,
// 16-byte aligned. D a multiple of 4 (float32) or 8 (bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sixteen bytes of a row: kN values of T as float32, and back.
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of the float with the same bits
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int R, int D, float eps) {
  using V = Piece<T>;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= R) return;
  const int pieces = D / V::kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * D);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  float ss = 0.f;
  for (int i = lane; i < pieces; i += 32) {
    float f[V::kN];
    V::unpack(xr[i], f);
#pragma unroll
    for (int k = 0; k < V::kN; ++k) ss += f[k] * f[k];
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)D + eps);
  for (int i = lane; i < pieces; i += 32) {
    float f[V::kN];
    V::unpack(xr[i], f);
#pragma unroll
    for (int k = 0; k < V::kN; k += 4) {
      const float4 s = sc[(i * V::kN + k) / 4];
      f[k] = f[k] * inv * s.x;
      f[k + 1] = f[k + 1] * inv * s.y;
      f[k + 2] = f[k + 2] * inv * s.z;
      f[k + 3] = f[k + 3] * inv * s.w;
    }
    orow[i] = V::pack(f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int R, int D,
           float eps, cudaStream_t stream) {
  if (D % Piece<T>::kN) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), R, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). Returns
// cudaGetLastError() after the launch, 0 on success.
int rmsnorm(const void* x, const void* scale, void* out, int R, int D,
            float eps, int dtype, void* stream) {
  if (R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, R, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
