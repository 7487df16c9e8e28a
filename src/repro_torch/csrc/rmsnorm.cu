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
//
// The backward (no TPU counterpart: the JAX package differentiates its
// plain jnp) is the exact derivative of that function in float32: with
// rstd = rsqrt(mean(x^2) + eps) and xhat = x rstd,
//   dx     = rstd (g scale - xhat mean(g scale xhat)),  in x's type
//   dscale = sum over rows of g xhat,                    float32
// dscale is summed in a fixed order (no floating-point atomics), so it
// comes out the same bits on every run. What bounds it on the H100: bytes,
// x and g read once and dx written once (6 R D bytes in bf16; 18.9 MB, 5.6
// us, at qwen2-1.5b's 2,048 rows of 1,536). Two routes, by type:
//  - bfloat16 (rmsnorm_bwd_rows, one cooperative launch): a team of up to
//    32 lanes a row (one warp at D 1,536 - 2,048; a wider team only past
//    2,048, kept to 8 pieces a lane, with a named barrier of its own instead
//    of the block's), every piece of x and g loaded before the first sum,
//    as the forward does. A team holds two rows in registers: the next
//    row's loads are issued as soon as the current row's pieces have
//    arrived, so its stores overlap them; where one row a team
//    would take more blocks than the card has SMs, a team takes two rows
//    (qwen2-1.5b's 2,048 rows: 128 blocks of 16). The block stages scale in
//    shared memory while its first loads fly. A lane's columns are the
//    same in every row its team takes, so it adds g xhat into its team's
//    slice of shared memory (no two lanes share an address); the block adds
//    its teams in order into one row of partials. After the grid's barrier
//    (cooperative launch: every block resident) the blocks sum the
//    partials' columns, 32 a block: 8 warps each adding a contiguous run of
//    the partial rows (16 loads in flight a lane), then the runs in order.
//    No second launch: the float32 route's second kernel runs in (D + 255)
//    / 256 blocks (6 at D = 1,536), each thread adding the partials one
//    after another.
//  - float32 (rmsnorm_bwd_kernel, then rmsnorm_bwd_reduce): teams as the
//    forward's, a block walking rows blockIdx.x, + gridDim.x, ... one row a
//    team at a time; each lane adds g xhat of its own columns into its
//    team's slice of shared memory; at the end the block sums its teams in
//    order into one row of partials (gridDim.x, D), and a second kernel
//    sums those rows in order.

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// blocks of the backward at most: two a streaming multiprocessor of an H100
// (the partials buffer holds this many rows of D)
constexpr int kBwdBlocks = 264;

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ partial, int R, int D, int team,
                       float eps) {
  using V = Piece<T>;
  constexpr int kS = V::kN / 4;
  extern __shared__ float acc[];  // (teams, D): each team's sum of g xhat
  __shared__ float red[2][kThreads / 32];
  const int tid = threadIdx.x, lt = tid & (team - 1), tm = tid / team;
  const int teams = kThreads / team;
  const int pieces = D / V::kN;
  float* mine = acc + (size_t)tm * D;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = lt + team * k;
    if (i < pieces)
#pragma unroll
      for (int c = 0; c < V::kN; ++c) mine[i * V::kN + c] = 0.f;
  }
  const float4* sc = reinterpret_cast<const float4*>(scale);
  // every thread of the block takes the same number of turns (r0 depends
  // on the block alone), so the barriers below are reached by all
  for (int r0 = blockIdx.x * teams; r0 < R; r0 += gridDim.x * teams) {
    const int r = r0 + tm;
    const bool row_ok = r < R;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)r * D);
    uint4 rx[NP], rg[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lt + team * k;
      rx[k] = rg[k] = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok && i < pieces) {
        rx[k] = xr[i];
        rg[k] = gr[i];
      }
    }
    // sum of x^2 and of g scale x over the row
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lt + team * k;
      if (!row_ok || i >= pieces) continue;
      float fx[V::kN], fg[V::kN];
      V::unpack(rx[k], fx);
      V::unpack(rg[k], fg);
#pragma unroll
      for (int c = 0; c < kS; ++c) {
        const float4 s4 = sc[i * kS + c];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xv = fx[4 * c + e];
          ss += xv * xv;
          dot += fg[4 * c + e] * sv[e] * xv;
        }
      }
    }
    for (int o = min(team, 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (team > 32) {
      if ((tid & 31) == 0) {
        red[0][tid / 32] = ss;
        red[1][tid / 32] = dot;
      }
      __syncthreads();
      const int w0 = (tid / team) * (team / 32);
      ss = dot = 0.f;
      for (int w = 0; w < team / 32; ++w) {
        ss += red[0][w0 + w];
        dot += red[1][w0 + w];
      }
      __syncthreads();  // red is reused by the next row
    }
    if (!row_ok) continue;
    const float rstd = rsqrtf(ss / (float)D + eps);
    // dx = rstd g scale - x rstd^3 dot / D
    const float c3 = rstd * rstd * rstd * dot / (float)D;
    uint4* dr = reinterpret_cast<uint4*>(dx + (size_t)r * D);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lt + team * k;
      if (i >= pieces) continue;
      float fx[V::kN], fg[V::kN], out[V::kN];
      V::unpack(rx[k], fx);
      V::unpack(rg[k], fg);
#pragma unroll
      for (int c = 0; c < kS; ++c) {
        const float4 s4 = sc[i * kS + c];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * c + e;
          out[j] = rstd * fg[j] * sv[e] - fx[j] * c3;
          mine[i * V::kN + j] += fg[j] * fx[j] * rstd;
        }
      }
      dr[i] = V::pack(out);
    }
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float s = 0.f;
    for (int t = 0; t < teams; ++t) s += acc[(size_t)t * D + i];
    partial[(size_t)blockIdx.x * D + i] = s;
  }
}

// dscale[i] = the sum, in block order, of the blocks' partials of column i
__global__ void rmsnorm_bwd_reduce(const float* __restrict__ partial,
                                   float* __restrict__ dscale, int blocks,
                                   int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * D + i];
  dscale[i] = s;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int NP>
int launch_bwd_np(const void* x, const void* scale, const void* g, void* dx,
                  float* partial, float* dscale, int R, int D, int team,
                  float eps, cudaStream_t stream) {
  const int teams = kThreads / team;
  const size_t smem = sizeof(float) * (size_t)teams * D;
  auto kernel = rmsnorm_bwd_kernel<T, NP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks =
      max(1, min((R + teams - 1) / teams, min(kBwdBlocks, 2 * sm_count())));
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, R, D, team,
      eps);
  rmsnorm_bwd_reduce<<<(D + 255) / 256, 256, 0, stream>>>(partial, dscale,
                                                          blocks, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               float* partial, float* dscale, int R, int D, float eps,
               cudaStream_t stream) {
  if (D % Piece<T>::kN) return (int)cudaErrorInvalidValue;
  const int pieces = D / Piece<T>::kN;
  int team = 1;
  while (team < kThreads && team * kPieces < pieces) team *= 2;
  const int np = (pieces + team - 1) / team;
#define RMS_BWD_NP(N)                                                      \
  if (np <= N)                                                             \
  return launch_bwd_np<T, N>(x, scale, g, dx, partial, dscale, R, D, team, \
                             eps, stream)
  RMS_BWD_NP(1);
  RMS_BWD_NP(2);
  RMS_BWD_NP(4);
  RMS_BWD_NP(8);
#undef RMS_BWD_NP
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward, bfloat16
// ---------------------------------------------------------------------------

constexpr int kRun = 16;  // partial rows a lane loads before its first add

// The team width of the bfloat16 backward: up to a warp while a lane holds
// at most 8 pieces, wider past that (D > 2,048).
int bwd_team(int pieces) {
  int team = 1;
  while (team < 32 && team * kPieces < pieces) team *= 2;
  while (team * 8 < pieces) team *= 2;
  return team;
}

// One cooperative launch: the rows, then (after the grid's barrier) dscale.
// Shared memory: scale (D floats), then each team's dscale share (teams,
// D).
template <int NP>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_rows(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ g,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ partial,
                     float* __restrict__ dscale, int R, int D, int team,
                     float eps) {
  namespace cg = cooperative_groups;
  using V = Piece<__nv_bfloat16>;
  extern __shared__ float4 bwd_smem[];
  // a wide team's sums, by the parity of the row; then the column runs
  __shared__ float red[2][2][kThreads / 32];
  __shared__ float runs[kThreads / 32][33];
  const int tid = threadIdx.x, lt = tid & (team - 1), tm = tid / team;
  const int teams = kThreads / team;
  const int pieces = D / V::kN;
  const float4* sc = reinterpret_cast<const float4*>(bwd_smem);
  float* land = reinterpret_cast<float*>(bwd_smem) + D;
  float* mine = land + (size_t)tm * D;
  // two buffers: a turn's row is in (xa, ga) while the next turn's loads
  // fill (xb, gb), issued as soon as this row's pieces have arrived (so the
  // block's stores overlap its next loads)
  uint4 xa[NP], ga[NP], xb[NP], gb[NP];
  // row r's pieces of x and g into (bx, bg), all in flight at once; zeros
  // past R
  auto load = [&](uint4 (&bx)[NP], uint4 (&bg)[NP], int r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)r * D);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lt + team * k;
      bx[k] = bg[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r < R && i < pieces) {
        bx[k] = xr[i];
        bg[k] = gr[i];
      }
    }
  };
  // every thread of the block takes the same number of turns (r0 depends
  // on the block alone), so the shuffles and barriers are reached by all
  const int stride = gridDim.x * teams;
  int r0 = blockIdx.x * teams;
  load(xa, ga, r0 + tm);
  // while the first row's loads fly: scale into shared memory, the team's
  // dscale share to zero
  for (int i = tid; i < D / 4; i += kThreads)
    bwd_smem[i] = reinterpret_cast<const float4*>(scale)[i];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = lt + team * k;
    if (i < pieces) {
      reinterpret_cast<float4*>(mine)[2 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(mine)[2 * i + 1] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  for (int t = 0; r0 < R; r0 += stride, ++t) {
    // row r from (xa, ga); the next turn's row rn loaded into (xb, gb)
    const int r = r0 + tm, rn = r0 + stride + tm;
    // sum of x^2 and of g scale x over the row
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lt + team * k;
      if (i >= pieces) continue;
      float fx[V::kN], fg[V::kN];
      V::unpack(xa[k], fx);
      V::unpack(ga[k], fg);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 s4 = sc[i * 2 + c];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xv = fx[4 * c + e];
          ss += xv * xv;
          dot += fg[4 * c + e] * sv[e] * xv;
        }
      }
    }
    if (rn < R) load(xb, gb, rn);
    for (int o = min(team, 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (team > 32) {
      // the team's warps through shared memory, behind the team's own
      // barrier; a row's slots are next written two rows later, after
      // every lane has passed the next row's barrier
      if ((tid & 31) == 0) {
        red[t & 1][0][tid / 32] = ss;
        red[t & 1][1][tid / 32] = dot;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tm), "r"(team) : "memory");
      const int w0 = tm * (team / 32);
      ss = dot = 0.f;
      for (int w = 0; w < team / 32; ++w) {
        ss += red[t & 1][0][w0 + w];
        dot += red[t & 1][1][w0 + w];
      }
    }
    if (r < R) {
      const float rstd = rsqrtf(ss / (float)D + eps);
      // dx = rstd g scale - x rstd^3 dot / D
      const float c3 = rstd * rstd * rstd * dot / (float)D;
      uint4* dr = reinterpret_cast<uint4*>(dx + (size_t)r * D);
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int i = lt + team * k;
        if (i >= pieces) continue;
        float fx[V::kN], fg[V::kN], out[V::kN];
        V::unpack(xa[k], fx);
        V::unpack(ga[k], fg);
        float4* a4 = reinterpret_cast<float4*>(mine) + 2 * i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 s4 = sc[i * 2 + c];
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          float4 acc = a4[c];
          float* av = reinterpret_cast<float*>(&acc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * c + e;
            out[j] = rstd * fg[j] * sv[e] - fx[j] * c3;
            av[e] += fg[j] * fx[j] * rstd;
          }
          a4[c] = acc;
        }
        dr[i] = V::pack(out);
      }
    }
    // the next row into the current buffer: register moves
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      xa[k] = xb[k];
      ga[k] = gb[k];
    }
  }
  // the block's partial row: its teams' shares added in team order
  __syncthreads();
  for (int c4 = tid; c4 < D / 4; c4 += kThreads) {
    float4 s = reinterpret_cast<const float4*>(land)[c4];
    for (int t = 1; t < teams; ++t) {
      const float4 v =
          reinterpret_cast<const float4*>(land + (size_t)t * D)[c4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * D)[c4] = s;
  }
  // every block's partial row is written and visible
  cg::this_grid().sync();
  // dscale[i] = the partials of column i summed in block order: block b
  // takes the 32-column slices b, b + gridDim.x, ...; warp w adds partial
  // rows w per .. (w + 1) per - 1 (kRun loaded before the first add), then
  // warp 0 the runs in order
  const int lane = tid & 31, w = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int blocks = gridDim.x;
  const int per = (blocks + kWarps - 1) / kWarps;
  const int b1 = min(blocks, (w + 1) * per);
  for (int c0 = blockIdx.x * 32; c0 < D; c0 += gridDim.x * 32) {
    const int col = c0 + lane;
    float s = 0.f;
    if (col < D) {
      for (int b0 = w * per; b0 < b1; b0 += kRun) {
        float v[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          v[i] = b0 + i < b1 ? partial[(size_t)(b0 + i) * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          if (b0 + i < b1) s += v[i];
      }
    }
    runs[w][lane] = s;
    __syncthreads();
    if (w == 0 && col < D) {
      float t = 0.f;
      for (int i = 0; i < kWarps; ++i) t += runs[i][lane];
      dscale[col] = t;
    }
    __syncthreads();  // runs is reused by the next slice
  }
}

struct RowsShape {
  int team, np, blocks;
  size_t smem;
};

template <int NP>
int rows_occupancy(size_t smem) {
  static size_t seen_smem = 0;
  static int seen = 0;
  if (seen > 0 && seen_smem == smem) return seen;
  auto kernel = rmsnorm_bwd_rows<NP>;
  // the dynamic limit always (48 KB of it with the static arrays is past
  // the default)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  seen_smem = smem;
  seen = n;
  return seen;
}

#define RMS_BWD_NP(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8)

// The bfloat16 backward's team, pieces a lane and blocks: at most as many
// as the card holds at once (a cooperative launch needs every block
// resident). blocks < 0: minus a CUDA error.
RowsShape rows_shape(int R, int D) {
  RowsShape sh;
  const int pieces = D / Piece<__nv_bfloat16>::kN;
  sh.team = bwd_team(pieces);
  const int np = (pieces + sh.team - 1) / sh.team;
  sh.np = np <= 6 ? np : 8;
  const int teams = kThreads / sh.team;
  sh.smem = sizeof(float) * (size_t)(teams + 1) * D;
  int per_sm = -(int)cudaErrorInvalidValue;
#define RMS_OCC(N) \
  if (sh.np == N) per_sm = rows_occupancy<N>(sh.smem);
  RMS_BWD_NP(RMS_OCC)
#undef RMS_OCC
  if (per_sm <= 0) {
    sh.blocks = per_sm < 0 ? per_sm : -(int)cudaErrorInvalidConfiguration;
    return sh;
  }
  // two rows a team where one would take more blocks than the card has
  // SMs: the second row's loads overlap the first's stores
  const int rows = (R + teams - 1) / teams > sm_count() ? 2 * teams : teams;
  sh.blocks = max(1, min((R + rows - 1) / rows, per_sm * sm_count()));
  return sh;
}

template <int NP>
int launch_rows(const RowsShape& sh, const __nv_bfloat16* x,
                const float* scale, const __nv_bfloat16* g,
                __nv_bfloat16* dx, float* partial, float* dscale, int R,
                int D, float eps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, rmsnorm_bwd_rows<NP>, x, scale, g, dx, partial,
                         dscale, R, D, sh.team, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_bwd_bf16(const void* x, const void* scale, const void* g,
                    void* dx, float* partial, float* dscale, int R, int D,
                    float eps, cudaStream_t stream) {
  if (D % Piece<__nv_bfloat16>::kN) return (int)cudaErrorInvalidValue;
  const RowsShape sh = rows_shape(R, D);
  if (sh.blocks < 0) return -sh.blocks;
#define RMS_ROWS(N)                                                      \
  if (sh.np == N)                                                        \
    return launch_rows<N>(sh, static_cast<const __nv_bfloat16*>(x),      \
                          static_cast<const float*>(scale),              \
                          static_cast<const __nv_bfloat16*>(g),          \
                          static_cast<__nv_bfloat16*>(dx), partial, dscale, \
                          R, D, eps, stream);
  RMS_BWD_NP(RMS_ROWS)
#undef RMS_ROWS
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

// The backward of rmsnorm: x, g, dx (R, D) of one type (dtype as above),
// scale (D,) float32, all 16-byte aligned; partial a float32 scratch of
// rmsnorm_bwd_partial_rows(R, D, dtype) x D; dscale (D,) float32. Returns
// cudaGetLastError() after the launches, 0 on success.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                void* partial, void* dscale, int R, int D, float eps,
                int dtype, void* stream) {
  if (R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  if (R == 0) return (int)cudaMemsetAsync(ds, 0, sizeof(float) * D, s);
  if (dtype == 0)
    return launch_bwd<float>(x, scale, g, dx, pt, ds, R, D, eps, s);
  if (dtype == 1)
    return launch_bwd_bf16(x, scale, g, dx, pt, ds, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the partials scratch a backward call of R rows of D needs (the
// float32 route's block cap; the bfloat16 route's blocks); -1 on a bad
// argument or a failed occupancy query.
int rmsnorm_bwd_partial_rows(int R, int D, int dtype) {
  if (R < 0 || D < 1) return -1;
  if (dtype == 0) return kBwdBlocks;
  if (dtype != 1 || D % Piece<__nv_bfloat16>::kN) return -1;
  const RowsShape sh = rows_shape(R, D);
  return sh.blocks < 0 ? -1 : sh.blocks;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
