// Helpers shared by the paged-attention kernels: conversions between the
// query types (float32, bfloat16) and float32, eight-byte row pieces of
// every pool storage type (float32, bfloat16, int8, float8 e4m3; the
// quantized ones also as bf16 pairs), and a warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// before the first conversion waits for its data. kScaled marks a quantized
// type, whose values are multiplied by their (page, kv head) scale.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using Raw = float2;
  static constexpr int kN = 2;
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint2;
  static constexpr int kN = 4;
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
    // a bf16 is the high half of the float with the same bits
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

// int8: eight values, each byte sign-extended (a quantized pool's value
// before its scale)
template <>
struct Vec<int8_t> {
  using Raw = uint2;
  static constexpr int kN = 8;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = (float)((int)(r.x << (24 - 8 * i)) >> 24);
      f[4 + i] = (float)((int)(r.y << (24 - 8 * i)) >> 24);
    }
  }
  // the eight values as four bf16 pairs, exact (|x| <= 128), without the
  // quarter-rate int-to-float conversion: byte x, flipped to x + 128, is
  // placed as the low byte of the float 2^23 + x + 128 and one add takes
  // the offset away
  __device__ __forceinline__ static void to_bf16(Raw r, uint32_t (&w)[4]) {
    const uint32_t u[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = u[i / 2], lo = 2 * (i % 2);
      const float a =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | lo)) -
          8388736.f;
      const float b =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | (lo + 1))) -
          8388736.f;
      __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
};
// float8 e4m3: eight values, two at a time through the e4m3x2 -> half2
// conversion sm_90 does in hardware (every e4m3 value, NaN included, is
// exact in half); the lower byte is the lower address's element
template <>
struct Vec<__nv_fp8_e4m3> {
  using Raw = uint2;
  static constexpr int kN = 8;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static void unpack(Raw r, float* f) {
    const unsigned w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)((w[i / 2] >> (16 * (i % 2))) & 0xffffu),
          __NV_E4M3));
      const float2 p = __half22float2(h);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  // the eight values as four bf16 pairs (every finite e4m3 value is a bf16
  // value)
  __device__ __forceinline__ static void to_bf16(Raw r, uint32_t (&w)[4]) {
    float f[8];
    unpack(r, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace paged
