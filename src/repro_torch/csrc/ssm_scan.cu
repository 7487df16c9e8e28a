// The Mamba2 SSD chunked scan for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py
//   ssd_pallas (_ssd_kernel)
// and computes what it computes, from its math, per (batch b, head h):
//   ca_t  = cumsum of dt_s * A_h over the chunk, inclusive
//   y_t   = sum_{s <= t} exp(ca_t - ca_s) dt_s (C_t . B_s) x_s
//           + exp(ca_t) C_t . h_prev
//   h_new = exp(ca_end) h_prev + sum_s exp(ca_end - ca_s) dt_s x_s (outer) B_s
// with x (S, P) the head's rows, B and C (S, N) shared by every head
// (n_groups = 1), and the (P, N) state h carried from chunk to chunk. The
// function does not depend on the chunk length: a longer chunk only moves
// work from the state term to the intra-chunk term. This kernel walks
// 64-row chunks (kL) whatever chunk the caller names, and starts from the
// caller's initial state where one is given (the TPU kernel starts from
// zero and its wrapper folds the initial state in afterwards).
//
// Design. The TPU kernel runs the chunks as the sequential minor axis of its
// grid and keeps the state in a VMEM scratch. Blocks of a CUDA grid run in
// no order, so here one thread block owns one (b, h) and loops over the
// chunks itself, with the state in shared memory. 256 threads work as a
// 16 x 16 grid, each on a 4 x 4 tile of whichever 64 x 64 product the step
// computes, reading its operands as float4 from shared memory:
//   1. load the chunk's x rows, B (row-major and transposed) and C
//      (transposed) and dt; rows past S are zeros, so they add nothing (dt
//      = 0) and leave ca flat;
//   2. one warp scans dt * A into ca;
//   3. W[t][s] = (C_t . B_s) exp(ca_t - ca_s) dt_s for the 4 x 4 tiles on or
//      below the diagonal only: exp(ca_t - ca_s) is never formed for s > t,
//      where it could overflow (the TPU kernel computes it and then selects);
//   4. y = W x + exp(ca_t) C h, written to device memory;
//   5. h = exp(ca_end) h + (u x)^T B with u_s = exp(ca_end - ca_s) dt_s.
// B and C are read once per (b, h) block from device memory, not repeated
// H-fold as the TPU wrapper does; at the serving shapes they stay in L2.
//
// What bounds it on the H100: its operations. At zamba2's prefill (1 x 1024
// tokens, 80 heads, P = N = 64) it moves 44 MB (x and y dominate) but does
// about 2 GFLOP of float32 multiply-adds, about 0.030 ms at the 67 TFLOP/s
// the card has outside its tensor cores, against 0.013 ms for the bytes.
// This first version runs scalar float32 FMAs from shared memory; the
// tensor cores (TF32) and a chunk-parallel three-pass form (chunk states in
// parallel, a scan over chunks, then the state term), which would also fill
// the 132 SMs at batch 1 (80 blocks here), are later work.
//
// Shared memory: 102,144 bytes a block (x, B twice, C, W, the state, ca and
// u), two blocks an SM.
//
// Layouts (all contiguous float32): x, y (Bb, S, H, P); dt (Bb, S, H); A
// (H,); B, C (Bb, S, N); h0 (optional), state (Bb, H, P, N). P and N are
// multiples of 4 up to 64.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;          // rows a chunk
constexpr int kMax = 64;        // largest P and N
constexpr int kLP = kL + 4;     // row of a transposed tile (float4-aligned)
constexpr int kThreads = 256;   // 16 x 16, a 4 x 4 tile each

constexpr int kSmemFloats = kL * kMax        // xs: x rows (s, p)
                            + kL * kMax      // bs: B rows (s, n)
                            + kMax * kLP     // bt: B transposed (n, s)
                            + kMax * kLP     // ct: C transposed (n, t)
                            + kL * kLP       // wt: W transposed (s, t)
                            + kMax * kMax    // ht: state transposed (n, p)
                            + 3 * kL;        // ca, u, dt
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(float4 v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ state, int S, int H,
               int P, int N) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* bs = xs + kL * kMax;
  float* bt = bs + kL * kMax;
  float* ct = bt + kMax * kLP;
  float* wt = ct + kMax * kLP;
  float* ht = wt + kL * kLP;
  float* ca = ht + kMax * kMax;
  float* us = ca + kL;
  float* dts = us + kL;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float a = A[h];

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    ht[n * kMax + p] = h0 ? h0[((size_t)bh * P + p) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int rows = min(kL, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    // 1. the chunk's rows; rows past S are zeros
    for (int e = tid; e < kL * P; e += kThreads) {
      const int s = e / P, p = e % P;
      xs[s * kMax + p] =
          s < rows ? x[(((size_t)b * S + t0 + s) * H + h) * P + p] : 0.f;
    }
    for (int e = tid; e < kL * N; e += kThreads) {
      const int s = e / N, n = e % N;
      const size_t g = ((size_t)b * S + t0 + s) * N + n;
      const float bv = s < rows ? Bm[g] : 0.f;
      bs[s * kMax + n] = bv;
      bt[n * kLP + s] = bv;
      ct[n * kLP + s] = s < rows ? Cm[g] : 0.f;
    }
    if (tid < kL)
      dts[tid] = tid < rows ? dt[((size_t)b * S + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    // 2. ca = inclusive cumsum of dt * A; u_s = exp(ca_end - ca_s) dt_s
    if (tid < 32) {
      float v0 = dts[tid] * a, v1 = dts[tid + 32] * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float end = __shfl_sync(0xffffffffu, v1, 31);
      ca[tid] = v0;
      ca[tid + 32] = v1;
      us[tid] = expf(end - v0) * dts[tid];
      us[tid + 32] = expf(end - v1) * dts[tid + 32];
    }
    __syncthreads();

    // 3. W on and below the diagonal, stored transposed: wt[s][t]
    {
      const int tb = ty * 4, sb = tx * 4;
      if (sb <= tb) {
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float c[4], bv[4];
          unpack(ld4(ct + n * kLP + tb), c);
          unpack(ld4(bt + n * kLP + sb), bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += c[i] * bv[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sb + j;
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = tb + i;
            w[i] = s <= t ? acc[i][j] * expf(ca[t] - ca[s]) * dts[s] : 0.f;
          }
          *reinterpret_cast<float4*>(wt + s * kLP + tb) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    __syncthreads();

    // 4. y = W x + exp(ca_t) C h_prev
    {
      const int tb = ty * 4, pb = tx * 4;
      if (pb < P) {
        float acc[4][4] = {};
        for (int s = 0; s <= tb + 3; ++s) {
          float w[4], xv[4];
          unpack(ld4(wt + s * kLP + tb), w);
          unpack(ld4(xs + s * kMax + pb), xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += w[i] * xv[j];
        }
        float st[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float c[4], hv[4];
          unpack(ld4(ct + n * kLP + tb), c);
          unpack(ld4(ht + n * kMax + pb), hv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) st[i][j] += c[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tb + i;
          if (t < rows) {
            const float e = expf(ca[t]);
            float* out = y + (((size_t)b * S + t0 + t) * H + h) * P + pb;
            *reinterpret_cast<float4*>(out) =
                make_float4(acc[i][0] + e * st[i][0], acc[i][1] + e * st[i][1],
                            acc[i][2] + e * st[i][2],
                            acc[i][3] + e * st[i][3]);
          }
        }
      }
    }
    __syncthreads();

    // 5. h = exp(ca_end) h + sum_s u_s x_s (outer) B_s, each thread its own
    //    4 x 4 tile of h
    {
      const int pb = ty * 4, nb = tx * 4;
      if (pb < P && nb < N) {
        const float dec = expf(ca[kL - 1]);
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float hv[4];
          unpack(ld4(ht + (nb + j) * kMax + pb), hv);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = hv[i] * dec;
        }
        for (int s = 0; s < kL; ++s) {
          const float u = us[s];
          float xv[4], bv[4];
          unpack(ld4(xs + s * kMax + pb), xv);
          unpack(ld4(bs + s * kMax + nb), bv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ux = u * xv[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += ux * bv[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(ht + (nb + j) * kMax + pb) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    state[((size_t)bh * P + p) * N + n] = ht[n * kMax + p];
  }
}

}  // namespace

extern "C" {

// h0 may be null (a zero initial state). P and N must be multiples of 4 in
// 4..64. Returns cudaGetLastError() after the launch, 0 on success.
int ssm_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* h0, void* y, void* state, int Bb,
             int S, int H, int P, int N, void* stream) {
  if (Bb < 0 || S < 0 || H < 1 || P < 4 || P > kMax || P % 4 || N < 4 ||
      N > kMax || N % 4)
    return (int)cudaErrorInvalidValue;
  if (Bb == 0) return 0;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ssd_kernel<<<Bb * H, kThreads, kSmemBytes,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(state), S, H, P, N);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
