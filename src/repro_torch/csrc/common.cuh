// Helpers shared by the paged-attention kernels: conversions between the
// storage types (float32, bfloat16) and float32, eight-byte row pieces,
// and a warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight bytes of a row, the unit a thread loads: kN values of type T, kept
// as raw bits until `unpack` so that a run of loads can all be in flight
// before the first conversion waits for its data.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using Raw = float2;
  static constexpr int kN = 2;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint2;
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
    // a bf16 is the high half of the float with the same bits
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace paged
