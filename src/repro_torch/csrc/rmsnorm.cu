// Row RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale,
// the mean in float32, the output in x's type (float32 or bfloat16).
//
// Replaces the TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py
//   rmsnorm_pallas (_rms_kernel)
// and computes what it computes. The TPU kernel tiles rows by multiples of
// 8 sublanes with the whole row in the lane dimension.
//
// What bounds it on the H100: bytes. It reads x once from device memory
// and writes out once (the float32 scale vector, D * 4 bytes, is read by
// every row from cache), 4 x D x R bytes for a bfloat16 x at 3.35 TB/s;
// its few flops an element are far below the card's rate.
//
// What the design does: a team of `team` threads (a power of two, 1 to 256)
// owns a row, each thread up to NP 16-byte pieces of it (4 float32 or 8
// bfloat16 values: lane i of the team takes pieces i, i + team, ...), so
// neighbouring threads read neighbouring addresses. Every piece of x, and
// the scale values that go with it, is loaded before the first sum: each
// thread has all its loads in flight at once, and the row stays in
// registers between the sum of squares and the scaling, so each byte of x
// is read from memory once. The team's sum is a shuffle reduction, through
// shared memory across the warps of a team wider than 32. The launch picks
// the team so that a thread holds about kPieces pieces: a block of 256
// threads then takes 256 / team rows, and every serving shape spreads over
// the card (bf16 prefill, 1024 rows of 4096: 512 blocks; q/k-norm, 8192
// rows of 128: 128 blocks; decode, 8 rows: 4 blocks).
//
// Layouts: x, out (R, D) contiguous, 16-byte aligned; scale (D,) float32,
// 16-byte aligned. D a multiple of 4 (float32) or 8 (bfloat16), at most
// kThreads * 8 pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPieces = 4;  // pieces a thread aims to hold

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

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int R, int D, int team, float eps) {
  using V = Piece<T>;
  constexpr int kS = V::kN / 4;  // float4s of scale a piece
  __shared__ float partial[kThreads / 32];
  const int tid = threadIdx.x, lt = tid & (team - 1);
  const int r = blockIdx.x * (kThreads / team) + tid / team;
  const int pieces = D / V::kN;
  const bool row_ok = r < R;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
  const float4* sc = reinterpret_cast<const float4*>(scale);

  uint4 raw[NP];
  float4 s[NP][kS];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = lt + team * k;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (row_ok && i < pieces) {
      raw[k] = xr[i];
#pragma unroll
      for (int c = 0; c < kS; ++c) s[k][c] = sc[i * kS + c];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (!row_ok || lt + team * k >= pieces) continue;
    float f[V::kN];
    V::unpack(raw[k], f);
#pragma unroll
    for (int c = 0; c < V::kN; ++c) ss += f[c] * f[c];
  }
  // the team's sum: lanes of one warp by shuffles, then (team > 32) the
  // team's warps through shared memory
  for (int o = min(team, 32) / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (team > 32) {
    if ((tid & 31) == 0) partial[tid / 32] = ss;
    __syncthreads();
    const int w0 = (tid / team) * (team / 32);
    ss = 0.f;
    for (int w = 0; w < team / 32; ++w) ss += partial[w0 + w];
  }
  if (!row_ok) return;
  const float inv = rsqrtf(ss / (float)D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * D);
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = lt + team * k;
    if (i >= pieces) continue;
    float f[V::kN];
    V::unpack(raw[k], f);
#pragma unroll
    for (int c = 0; c < kS; ++c) {
      f[4 * c] = f[4 * c] * inv * s[k][c].x;
      f[4 * c + 1] = f[4 * c + 1] * inv * s[k][c].y;
      f[4 * c + 2] = f[4 * c + 2] * inv * s[k][c].z;
      f[4 * c + 3] = f[4 * c + 3] * inv * s[k][c].w;
    }
    orow[i] = V::pack(f);
  }
}

template <typename T, int NP>
int launch_np(const void* x, const void* scale, void* out, int R, int D,
              int team, float eps, cudaStream_t stream) {
  const int rows_per_block = kThreads / team;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<T, NP><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), R, D, team, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int R, int D,
           float eps, cudaStream_t stream) {
  if (D % Piece<T>::kN) return (int)cudaErrorInvalidValue;
  const int pieces = D / Piece<T>::kN;
  int team = 1;
  while (team < kThreads && team * kPieces < pieces) team *= 2;
  const int np = (pieces + team - 1) / team;
#define RMS_NP(N) \
  if (np <= N) return launch_np<T, N>(x, scale, out, R, D, team, eps, stream)
  RMS_NP(1);
  RMS_NP(2);
  RMS_NP(3);
  RMS_NP(4);
  RMS_NP(6);
  RMS_NP(8);
#undef RMS_NP
  return (int)cudaErrorInvalidValue;
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
