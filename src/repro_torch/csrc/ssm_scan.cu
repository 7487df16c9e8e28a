// The Mamba2 SSD chunked scan for Hopper (sm_90a), float32 in and out, its
// products on the TF32 tensor cores in split (3xTF32) precision.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py
//   ssd_pallas (_ssd_kernel)
// and computes what it computes, per (batch b, head h), with the JAX
// wrapper's initial-state fold (src/repro/kernels/ssm_scan/ops.py) taken as
// a starting state h0:
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t . C_t
// with x (S, P) the head's rows, B and C (S, N) shared by every head
// (n_groups = 1), h a (P, N) state. Over a chunk of rows, with ca_t the
// inclusive cumulative sum of dt_s A_h from the chunk's start:
//   y_t   = sum_{s <= t} exp(ca_t - ca_s) dt_s (C_t . B_s) x_s
//           + exp(ca_t) C_t . h_start
//   h_end = exp(ca_end) h_start + G,  G = sum_s exp(ca_end - ca_s) dt_s x_s B_s
// The function does not depend on the chunk length; the kernel walks 64-row
// chunks whatever chunk the caller names.
//
// What bounds it on the H100: its bytes. At zamba2's prefill (1 x 1,024
// tokens, 80 heads, P = N = 64) it must move 44,106,048 bytes (x and y
// dominate), 0.0132 ms at 3.35 TB/s, and do 4.P.N flops a token and head
// (1.34 GFLOP), 0.0081 ms at the 165 TFLOP/s of 3xTF32 (a third of the
// 495 TFLOP/s TF32 rate); at 1 x 256, 12,009,792 bytes, 0.0036 ms, against
// 0.0020 ms of flops. In scalar float32 (67 TFLOP/s) the flops would bound
// it instead (0.0200 / 0.0050 ms), which is why the products run on the
// tensor cores.
//
// Why 3xTF32 and not TF32: the scan is held at rtol = atol = 1e-4 (the JAX
// package's tolerance for this kernel). Operands rounded once to TF32 miss
// that at zamba2's width (y more than 3e-4 off the per-token scan); split
// into a TF32 high part and the exact residual, with lo.hi + hi.lo +
// hi.hi, they land below 1e-5 (tests/test_torch_ssm_numerics.py emulates
// both on the CPU and asserts both). The split rounds hi to nearest by an integer
// add and a mask and takes lo = v - hi, which the tensor core reads
// truncated to TF32: three instructions a value, where two cvt.rna and a
// subtraction took measurably longer.
//
// Design.
// - The sequence of one (b, h) is cut into R segments of whole 64-row
//   chunks, one segment a thread block, the R blocks one thread-block
//   cluster (R <= 8, the portable size). The host's planner
//   (kernels/ssm_scan/kernel.py split_sequence) takes R = 1 where Bb.H
//   already fills the card (Bb.H at least the blocks it holds at once,
//   cudaOccupancyMaxActiveClusters: 264 on an H100); else the fewest ranks
//   that leave every segment at most two chunks, at most 8. zamba2's
//   batch-1 prefill: R = 8 at S = 1,024 (640 blocks), R = 2 at S = 256;
//   its 4 x 256 batch: R = 1.
// - A block walks its segment in super-chunks of 128 rows, two chunks side
//   by side: warps 0-3 take chunk 0 and warps 4-7 chunk 1, each half with
//   its own named barrier, each staging its own chunk's x, B, C and dt rows
//   with cp.async (zero filled past the segment and past P / N, so padding
//   adds nothing: dt = 0 leaves ca flat, and every product runs on whole
//   64-wide tiles with static loop bounds). From a zero state each half
//   computes C.B^T on and below the diagonal (warp tile i: 16 rows, the
//   16 (i + 1) columns at or left of them; half 1 takes its tiles in
//   mirrored order, so that each scheduler holds a long and a short one),
//   turns it into W in registers (exp(ca_t - ca_s) is never formed for
//   s > t, where it could overflow), y = W.x with W as the A operand
//   straight from the accumulators (the k order of a fragment is free, so
//   column 2t / 2t + 1 of the accumulator pairs with rows 2t / 2t + 1 of
//   x), and its chunk's state G = (u x)^T B, u_s = exp(ca_end - ca_s) dt_s.
// - The halves' states combine in shared memory: G_T = exp(la_1) G_0 + G_1,
//   la the chunks' log decays. At one cluster barrier every rank reads the
//   (G, la) of every earlier rank through distributed shared memory and
//   forms its own starting state, h_in = D_{r-1}(...(D_0 h0 + G_0)...) +
//   G_{r-1}: no serial chain of ranks. Each half then adds exp(ca_t) C_t .
//   h_c to its rows (h_0 = h_in, h_1 = exp(la_0) h_in + G_0), a fourth
//   product, and writes y once. The last rank writes the final state.
// - Where a segment is one super-chunk (every served shape: S <= 1,024 at
//   R <= 8), y waits in registers across the barrier. A longer segment
//   walks twice: once for (G, la) alone (only when R > 1), then, after the
//   exchange, super-chunk by super-chunk with the running state, which then
//   lives in registers (four float4 a thread) while the next one is staged.
// - Every product is mma.sync m16n8k8 TF32, split 3xTF32 (csrc/mma.cuh).
//   Shared rows are padded to 68 floats, so every fragment load is free of
//   bank conflicts. x, B, C and y stay float32 in device memory; exp is
//   expf (decays at zamba2's A reach the underflow range).
//
// Where its time goes (ablation probes on the card, PERF.md section 6):
// the causal C.B^T and W.x, whose longest warp tile does four times the
// shortest's work; the 3xTF32 products and splits; at R = 8 the exchange,
// whose reads grow as R^2 (28 G tiles a cluster); per-launch and staging
// costs. It stays several times its byte bound.
//
// Shared memory: 106,000 bytes a block (x, B and C rows of a super-chunk,
// padded; dt, ca and u; the log decays), two blocks an SM. The chunks' G
// land in B's rows once both halves are done with them, the starting states
// in x's. Registers: 128 a thread, no spills (ptxas; chip_smoke.py phase 1
// logs it), the cap of the launch bounds for two blocks of 256 threads an
// SM.
//
// Layouts (all contiguous float32): x, y (Bb, S, H, P); dt (Bb, S, H); A
// (H,); B, C (Bb, S, N); h0 (optional), state (Bb, H, P, N). P and N are
// multiples of 4 up to 64; x, B, C and h0 start on 16 bytes (the wrapper
// copies one that does not).
//
// The backward (ssd_bwd_kernel; no TPU counterpart: the JAX package
// differentiates its plain jnp) takes the gradients of y and of the final
// state back to x, dt, A, B and C on the per-token recurrence, in scalar
// float32. With a_t = exp(dt_t A) and G_t the gradient that reaches h_t
// (G_t = a_{t+1} G_{t+1} + gy_t C_t, starting from the final state's):
//   dx_t = dt_t G_t B_t,  ddt_t = x_t . G_t B_t + A a_t <G_t, h_{t-1}>,
//   dB_t = dt_t G_t^T x_t,  dC_t = h_t^T gy_t,  dA = sum dt_t a_t <G_t, h_{t-1}>.
// One block of 256 threads a (b, h): warp w holds state rows w, w + 8, ...
// and lane l columns l, l + 32 in registers. A first walk over the
// sequence saves the state before every kBwdK-token stretch to a global
// scratch; the reverse walk reloads each stretch's starting state, recomputes
// the stretch's states into registers and carries G back through them.
// Sums over a state row are warp shuffles; sums over a column go through
// shared memory per warp and are added in warp order. dB and dC are shared
// by the heads and dA by the batch: each block writes its own per-head
// (per-batch) rows, and ssd_bwd_reduce adds them in a fixed order, so the
// gradients are the same bits on every run (no floating-point atomics).
// Global scratch: the checkpoints, Bb H ceil(S / kBwdK) P N floats.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using paged::cp_async_16;
using paged::cp_async_4;
using paged::cp_async_commit;
using paged::cp_async_wait_group;
using paged::mma_tf32x3;
using paged::split_tf32;

constexpr int kL = 64;             // rows a chunk
constexpr int kRows = 2 * kL;      // rows a super-chunk: a chunk a half
constexpr int kMax = 64;           // largest P and N
constexpr int kLd = kMax + 4;      // padded shared row: no bank conflicts
constexpr int kThreads = 256;      // 8 warps, 4 a half
constexpr int kHalf = kThreads / 2;
constexpr int kMaxRanks = 8;       // the portable cluster size
constexpr int kPieces = kMax * kMax / 4 / kThreads;  // state float4s
constexpr int kTile = kRows * kLd;  // floats of x, B or C rows

// x rows, B rows, C rows; dt, ca, u of each row; la[0], la[1] (the
// chunks' log decays), la[2] (the segment's, read by later ranks)
constexpr int kSmemFloats = 3 * kTile + 3 * kRows + 4;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;  // may be null: a zero initial state
  float* y;
  float* state;
  int S, H, P, N;
  int ranks;  // blocks of a cluster: segments of one (b, h)
  int per;    // chunks a segment
};

// Per-thread view of the launch: who it is and where its block works.
struct Ctx {
  int tid, lane, g, t4;
  int c;   // half: the chunk of a super-chunk it walks
  int i;   // warp in the half: the 16-row tile of its chunk
  int b, h, bh, rank;
  int r0, r1;  // the segment's rows of the sequence
  float a;     // A_h
};

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Barrier of one half's 128 threads (named barrier 1 or 2; ids are
// immediates).
__device__ __forceinline__ void half_sync(int c) {
  if (c == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The state piece m of this thread: row p, columns n .. n + 3 of a (64, 64)
// state tile; at p.kLd + n in shared memory.
__device__ __forceinline__ int piece_p(const Ctx& k, int m) {
  return (k.tid >> 4) + 16 * m;
}
__device__ __forceinline__ int piece_n(const Ctx& k) {
  return 4 * (k.tid & 15);
}
__device__ __forceinline__ int piece_at(const Ctx& k, int m) {
  return piece_p(k, m) * kLd + piece_n(k);
}
__device__ __forceinline__ float4& f4(float* p) {
  return *reinterpret_cast<float4*>(p);
}
__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// d x + y, piecewise
__device__ __forceinline__ float4 axpy(float d, float4 x, float4 y) {
  return make_float4(fmaf(d, x.x, y.x), fmaf(d, x.y, y.y), fmaf(d, x.z, y.z),
                     fmaf(d, x.w, y.w));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(v[q], hi[q], lo[q]);
}
__device__ __forceinline__ void split2(float v0, float v1, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split_tf32(v0, hi[0], lo[0]);
  split_tf32(v1, hi[1], lo[1]);
}

// Stage this half's chunk, sequence rows [t0, t0 + rows) (rows <= 64), into
// its shared rows: x, B and C rows of 64 columns, and dt; rows past `rows`
// and columns past P / N are zeros, so every product runs on whole 64-wide
// tiles with no bound known only at run time.
__device__ __forceinline__ void stage(const Args& a, const Ctx& k, float* sm,
                                      int t0, int rows) {
  float* xs = sm + k.c * kL * kLd;
  float* bs = sm + kTile + k.c * kL * kLd;
  float* cs = sm + 2 * kTile + k.c * kL * kLd;
  float* dts = sm + 3 * kTile + k.c * kL;
  const int ht = k.tid & (kHalf - 1);
  constexpr int kGroups = kMax / 4;  // 16-byte groups a row
#pragma unroll 2
  for (int e = ht; e < kL * kGroups; e += kHalf) {
    const int s = e / kGroups, q = e % kGroups;
    const bool okx = s < rows && 4 * q < a.P;
    cp_async_16(xs + s * kLd + 4 * q,
                okx ? a.x + (((size_t)k.b * a.S + t0 + s) * a.H + k.h) * a.P +
                          4 * q
                    : a.x,
                okx);
    const bool okn = s < rows && 4 * q < a.N;
    const size_t off = okn ? ((size_t)k.b * a.S + t0 + s) * a.N + 4 * q : 0;
    cp_async_16(bs + s * kLd + 4 * q, a.B + off, okn);
    cp_async_16(cs + s * kLd + 4 * q, a.C + off, okn);
  }
  if (ht < kL) {
    const bool ok = ht < rows;
    cp_async_4(dts + ht,
               ok ? a.dt + ((size_t)k.b * a.S + t0 + ht) * a.H + k.h : a.dt,
               ok);
  }
  cp_async_commit();
}

// One warp's inclusive scan of dt A over its half's 64 rows: ca, u_s =
// exp(ca_end - ca_s) dt_s, and the chunk's log decay la[c] = ca_end.
__device__ __forceinline__ void scan_chunk(const Ctx& k, float* sm) {
  float* dts = sm + 3 * kTile + k.c * kL;
  float* ca = dts + kRows;
  float* us = ca + kRows;
  float* la = sm + 3 * kTile + 3 * kRows;
  const int l = k.lane;
  float v0 = dts[l] * k.a, v1 = dts[l + 32] * k.a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
    if (l >= o) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float end = __shfl_sync(0xffffffffu, v1, 31);
  ca[l] = v0;
  ca[l + 32] = v1;
  us[l] = expf(end - v0) * dts[l];
  us[l + 32] = expf(end - v1) * dts[l + 32];
  if (l == 0) la[k.c] = end;
}

// C.B^T and y = W.x of warp tile I (rows 16 I .. 16 I + 15 of its half's
// chunk): C.B^T over the 2 I + 2 column tiles at or left of the rows, W =
// (C.B^T) exp(ca_t - ca_s) dt_s on and below the diagonal in registers, and
// W as the A operand of W.x straight from the accumulators (its k slot t is
// column 8j + 2t, slot t + 4 column 8j + 2t + 1, and x's rows follow suit).
// The tile count is a template parameter, so every loop that indexes
// registers is unrolled with no bound known only at run time.
template <int I>
__device__ __forceinline__ void cb_wx(const Ctx& k, const float* xs,
                                      const float* bs, const float* cs,
                                      const float* dts, const float* ca,
                                      float (&yacc)[8][4]) {
  constexpr int kJ = 2 * I + 2;
  constexpr int tb = 16 * I;
  const int g = k.g, t4 = k.t4;
  float cb[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[j][q] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kMax / 8; ++kk) {
    const float* cr = cs + (tb + g) * kLd + 8 * kk + t4;
    const float av[4] = {cr[0], cr[8 * kLd], cr[4], cr[8 * kLd + 4]};
    uint32_t ahi[4], alo[4];
    split4(av, ahi, alo);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float* br = bs + (8 * j + g) * kLd + 8 * kk + t4;
      uint32_t bhi[2], blo[2];
      split2(br[0], br[4], bhi, blo);
      mma_tf32x3(cb[j], ahi, alo, bhi, blo);
    }
  }
  const int ta = tb + g, tc = tb + g + 8;
  const float cat = ca[ta], cac = ca[tc];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int s0 = 8 * j + 2 * t4, s1 = s0 + 1;
    const float cs0 = ca[s0], cs1 = ca[s1];
    const float d0 = dts[s0], d1 = dts[s1];
    const float w[4] = {s0 <= ta ? cb[j][0] * expf(cat - cs0) * d0 : 0.f,
                        s0 <= tc ? cb[j][2] * expf(cac - cs0) * d0 : 0.f,
                        s1 <= ta ? cb[j][1] * expf(cat - cs1) * d1 : 0.f,
                        s1 <= tc ? cb[j][3] * expf(cac - cs1) * d1 : 0.f};
    uint32_t ahi[4], alo[4];
    split4(w, ahi, alo);
#pragma unroll
    for (int pj = 0; pj < kMax / 8; ++pj) {
      const float* xr = xs + s0 * kLd + 8 * pj + g;
      uint32_t bhi[2], blo[2];
      split2(xr[0], xr[kLd], bhi, blo);
      mma_tf32x3(yacc[pj], ahi, alo, bhi, blo);
    }
  }
}

// One super-chunk, sequence rows [t0, t0 + 128) of which the first `rows`
// lie in the segment, from a zero state. With `with_y`, yacc holds this
// warp's y = W.x (its 16 rows, 64 columns: accumulator layout, tile j =
// columns 8j..8j+7). Leaves in shared memory: G_0 in B's rows 0..63 and
// G_T = exp(la_1) G_0 + G_1 in B's rows 64..127 (both (64, 64), row p at
// p.kLd), la[0], la[1], and each half's C rows and ca for the correction.
__device__ __forceinline__ void local_walk(const Args& a, const Ctx& k,
                                           float* sm, int t0, int rows,
                                           bool with_y, float (&yacc)[8][4]) {
  const int c = k.c, i = k.i, g = k.g, t4 = k.t4;
  const int crows = max(0, min(kL, rows - c * kL));  // this half's rows
  float* xs = sm + c * kL * kLd;
  float* bs = sm + kTile + c * kL * kLd;
  const float* cs = sm + 2 * kTile + c * kL * kLd;
  const float* dts = sm + 3 * kTile + c * kL;
  const float* ca = dts + kRows;
  const float* us = ca + kRows;
  const float* la = sm + 3 * kTile + 3 * kRows;

  stage(a, k, sm, t0 + c * kL, crows);
  cp_async_wait_group<0>();
  half_sync(c);
  if (i == 0) scan_chunk(k, sm);
  half_sync(c);  // ca and u are in

  if (with_y) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[j][q] = 0.f;
    if (16 * i < crows) {  // a tile with rows of the segment
      switch (i) {
        case 0: cb_wx<0>(k, xs, bs, cs, dts, ca, yacc); break;
        case 1: cb_wx<1>(k, xs, bs, cs, dts, ca, yacc); break;
        case 2: cb_wx<2>(k, xs, bs, cs, dts, ca, yacc); break;
        default: cb_wx<3>(k, xs, bs, cs, dts, ca, yacc); break;
      }
    }
  }

  // G = (u x)^T B: rows pb..pb+15 of P, every column of N, over the rows
  // of the chunk (k slots t / t + 4 are rows 2t / 2t + 1 of a step)
  const int pb = 16 * i;
  const int ks = (crows + 7) / 8;
  float gacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) gacc[j][q] = 0.f;
  for (int kk = 0; kk < ks; ++kk) {
    const int s0 = 8 * kk + 2 * t4;
    const float u0 = us[s0], u1 = us[s0 + 1];
    const float* xr = xs + s0 * kLd + pb + g;
    const float av[4] = {u0 * xr[0], u0 * xr[8], u1 * xr[kLd],
                         u1 * xr[kLd + 8]};
    uint32_t ahi[4], alo[4];
    split4(av, ahi, alo);
#pragma unroll
    for (int nj = 0; nj < kMax / 8; ++nj) {
      const float* br = bs + s0 * kLd + 8 * nj + g;
      uint32_t bhi[2], blo[2];
      split2(br[0], br[kLd], bhi, blo);
      mma_tf32x3(gacc[nj], ahi, alo, bhi, blo);
    }
  }
  half_sync(c);  // the half is done with its x and B rows
#pragma unroll
  for (int nj = 0; nj < kMax / 8; ++nj) {
    float* gr = bs + (pb + g) * kLd + 8 * nj + 2 * t4;
    *reinterpret_cast<float2*>(gr) = make_float2(gacc[nj][0], gacc[nj][1]);
    *reinterpret_cast<float2*>(gr + 8 * kLd) =
        make_float2(gacc[nj][2], gacc[nj][3]);
  }
  __syncthreads();
  // G_T = exp(la_1) G_0 + G_1, in G_1's place
  const float d1 = expf(la[1]);
  const float* g0 = sm + kTile;
  float* gt = sm + kTile + kL * kLd;
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    const int e = piece_at(k, m);
    f4(gt + e) = axpy(d1, f4(g0 + e), f4(gt + e));
  }
  __syncthreads();
}

// Finish a super-chunk walked by local_walk, from its starting state hs
// (this thread's kPieces pieces): each half adds exp(ca_t) C_t . h_c to its
// rows' y (h_0 = hs, h_1 = exp(la_0) hs + G_0, laid in x's rows), writes
// them, and hs becomes the state at the super-chunk's end, exp(la_0 + la_1)
// hs + G_T. `h_zero`: hs is zero, chunk 0 adds nothing.
__device__ __forceinline__ void finish(const Args& a, const Ctx& k, float* sm,
                                       int t0, int rows, bool h_zero,
                                       float (&yacc)[8][4],
                                       float4 (&hs)[kPieces]) {
  const int c = k.c, i = k.i, g = k.g, t4 = k.t4;
  const float* la = sm + 3 * kTile + 3 * kRows;
  const float* g0 = sm + kTile;
  const float* gt = sm + kTile + kL * kLd;
  float* h0s = sm;             // x's rows 0..63: h_0 as (P, N)
  float* h1s = sm + kL * kLd;  // x's rows 64..127: h_1
  const float d0 = expf(la[0]), dT = expf(la[0] + la[1]);
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    const int e = piece_at(k, m);
    f4(h0s + e) = hs[m];
    f4(h1s + e) = axpy(d0, hs[m], f4(g0 + e));
    hs[m] = axpy(dT, hs[m], f4(gt + e));
  }
  __syncthreads();

  const int crows = max(0, min(kL, rows - c * kL));
  const int tb = 16 * i;
  if (tb < crows) {
    const float* cs = sm + 2 * kTile + c * kL * kLd;
    const float* ca = sm + 3 * kTile + kRows + c * kL;
    if (!(c == 0 && h_zero)) {
      // y += (exp(ca_t) C_t) . h_c^T: the row scale folded into A
      const float* hc = c == 0 ? h0s : h1s;
      const float ea = expf(ca[tb + g]), ec = expf(ca[tb + g + 8]);
#pragma unroll 2
      for (int kk = 0; kk < kMax / 8; ++kk) {
        const float* cr = cs + (tb + g) * kLd + 8 * kk + t4;
        const float av[4] = {ea * cr[0], ec * cr[8 * kLd], ea * cr[4],
                             ec * cr[8 * kLd + 4]};
        uint32_t ahi[4], alo[4];
        split4(av, ahi, alo);
#pragma unroll
        for (int pj = 0; pj < kMax / 8; ++pj) {
          const float* hr = hc + (8 * pj + g) * kLd + 8 * kk + t4;
          uint32_t bhi[2], blo[2];
          split2(hr[0], hr[4], bhi, blo);
          mma_tf32x3(yacc[pj], ahi, alo, bhi, blo);
        }
      }
    }
    // y rows of this warp (columns 2 t4, 2 t4 + 1 of each tile)
    float* y0 = a.y + (((size_t)k.b * a.S + t0 + c * kL + tb + g) * a.H + k.h) *
                          a.P + 2 * t4;
    const size_t down = (size_t)8 * a.H * a.P;  // eight rows on
#pragma unroll
    for (int pj = 0; pj < kMax / 8; ++pj) {
      if (8 * pj + 2 * t4 < a.P) {
        if (tb + g < crows)
          *reinterpret_cast<float2*>(y0 + 8 * pj) =
              make_float2(yacc[pj][0], yacc[pj][1]);
        if (tb + g + 8 < crows)
          *reinterpret_cast<float2*>(y0 + down + 8 * pj) =
              make_float2(yacc[pj][2], yacc[pj][3]);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2) ssd_kernel_mma(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* la = sm + 3 * kTile + 3 * kRows;
  float* gt = sm + kTile + kL * kLd;

  Ctx k;
  k.tid = threadIdx.x;
  k.lane = k.tid & 31;
  k.g = k.lane >> 2;
  k.t4 = k.lane & 3;
  k.c = k.tid >> 7;
  // half 1 takes its tiles in mirrored order: warps w and w + 4 share a
  // scheduler, and tile i's causal products cost i + 1 units
  k.i = k.c == 0 ? (k.tid >> 5) & 3 : 3 - ((k.tid >> 5) & 3);
  k.rank = blockIdx.x % a.ranks;
  k.bh = blockIdx.x / a.ranks;
  k.b = k.bh / a.H;
  k.h = k.bh - k.b * a.H;
  k.r0 = k.rank * a.per * kL;
  k.r1 = min(a.S, k.r0 + a.per * kL);
  k.a = a.A[k.h];
  const int nsup = (k.r1 - k.r0 + kRows - 1) / kRows;
  const bool keep = a.per <= 2;  // one super-chunk a segment

  float yacc[8][4];
  float4 hs[kPieces];
  auto load_h0 = [&]() {
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const int p = piece_p(k, m), n = piece_n(k);
      hs[m] = a.h0 && p < a.P && n < a.N
                  ? f4(a.h0 + ((size_t)k.bh * a.P + p) * a.N + n)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  bool walked0 = false;  // super-chunk 0 walked with y already
  if (a.ranks > 1) {
    // the segment's (G, la) from a zero state
    float la_seg = 0.f;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) hs[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsup; ++s) {
      const int t0 = k.r0 + s * kRows;
      local_walk(a, k, sm, t0, k.r1 - t0, keep, yacc);
      const float lt = la[0] + la[1], dT = expf(lt);
      la_seg += lt;
#pragma unroll
      for (int m = 0; m < kPieces; ++m)
        hs[m] = axpy(dT, hs[m], f4(gt + piece_at(k, m)));
      __syncthreads();  // before the next staging or la
    }
#pragma unroll
    for (int m = 0; m < kPieces; ++m) f4(gt + piece_at(k, m)) = hs[m];
    if (k.tid == 0) la[2] = la_seg;
    cluster_arrive_release();
    cluster_wait_acquire();
    // h_in = D_{r-1}(...(D_0 h0 + G_0)...) + G_{r-1}
    load_h0();
    cg::cluster_group cluster = cg::this_cluster();
    for (int q = 0; q < k.rank; ++q) {
      const float* gq = cluster.map_shared_rank(gt, q);
      const float dq = expf(*cluster.map_shared_rank(la + 2, q));
#pragma unroll
      for (int m = 0; m < kPieces; ++m)
        hs[m] = axpy(dq, hs[m], f4(gq + piece_at(k, m)));
    }
    cluster_arrive_release();  // done with the other ranks' shared memory
    // a longer segment restages over its G: wait until no rank reads it
    if (!keep) cluster_wait_acquire();
    walked0 = keep;
  } else {
    load_h0();
  }

  for (int s = 0; s < nsup; ++s) {
    const int t0 = k.r0 + s * kRows;
    if (!(walked0 && s == 0))
      local_walk(a, k, sm, t0, k.r1 - t0, true, yacc);
    finish(a, k, sm, t0, k.r1 - t0,
           s == 0 && k.rank == 0 && a.h0 == nullptr, yacc, hs);
  }

  if (k.rank == a.ranks - 1) {
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const int p = piece_p(k, m), n = piece_n(k);
      if (p < a.P && n < a.N)
        f4(a.state + ((size_t)k.bh * a.P + p) * a.N + n) = hs[m];
    }
  }
  // no rank leaves while a later one may still read its shared memory
  if (a.ranks > 1 && keep) cluster_wait_acquire();
}

cudaLaunchAttribute cluster_attr(int ranks) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

int configure() {
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  return (int)err;
}


// ---------------------------------------------------------------------------
// Backward (scalar float32)
// ---------------------------------------------------------------------------

namespace ssd_bwd {

constexpr int kK = 4;          // tokens a stretch (states held in registers)
constexpr int kWarps = 8;      // state rows w, w + 8, ... a warp
constexpr int kBThreads = 32 * kWarps;

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;      // may be null
  const float* gy;
  const float* gstate;  // may be null (zero)
  float* dx;
  float* ddt;
  float* dB_part;  // (Bb, H, S, N)
  float* dC_part;  // (Bb, H, S, N)
  float* dA_part;  // (Bb, H, S)
  float* ckpt;     // (Bb * H, ceil(S / kK), P * N)
  int S, H, P, N;
};

// a stretch's rows in shared memory, padded with zeros to kMax
struct Stage {
  float x[kK][kMax], gy[kK][kMax], B[kK][kMax], C[kK][kMax];
  float dt[kK], a[kK];
};

__device__ void stage_rows(Stage& st, const BwdArgs& g, int b, int h, int s0,
                           int L, float A, bool with_grad) {
  for (int e = threadIdx.x; e < kK * kMax; e += kBThreads) {
    const int t = e / kMax, c = e % kMax, s = s0 + t;
    const bool ok = t < L;
    const size_t xo = (((size_t)b * g.S + s) * g.H + h) * g.P + c;
    const size_t bo = ((size_t)b * g.S + s) * g.N + c;
    st.x[t][c] = ok && c < g.P ? g.x[xo] : 0.f;
    st.B[t][c] = ok && c < g.N ? g.B[bo] : 0.f;
    if (with_grad) {
      st.gy[t][c] = ok && c < g.P ? g.gy[xo] : 0.f;
      st.C[t][c] = ok && c < g.N ? g.C[bo] : 0.f;
    }
  }
  if (threadIdx.x < kK) {
    const int t = threadIdx.x;
    const float d = t < L ? g.dt[((size_t)b * g.S + s0 + t) * g.H + h] : 0.f;
    st.dt[t] = d;
    st.a[t] = expf(d * A);
  }
}

template <int PI, int NJ>
__global__ void __launch_bounds__(kBThreads)
    ssd_bwd_kernel(const BwdArgs g) {
  __shared__ Stage st;
  __shared__ float dBw[kK][kWarps][kMax], dCw[kK][kWarps][kMax];
  __shared__ float t1w[kK][kWarps], ghw[kK][kWarps];
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int S = g.S, P = g.P, N = g.N;
  const float A = g.A[h];
  const int n_str = (S + kK - 1) / kK;
  float* ck = g.ckpt + (size_t)bh * n_str * P * N;
  const size_t st_off = (size_t)bh * P * N;

  // the thread's state entries (p, n) = (w + 8 i, lane + 32 j)
  auto valid = [&](int i, int j) {
    return w + 8 * i < P && lane + 32 * j < N;
  };
  auto ent = [&](int i, int j) { return (w + 8 * i) * N + lane + 32 * j; };

  // 1. forward: the state before each stretch
  float hcur[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      hcur[i][j] = g.h0 != nullptr && valid(i, j) ? g.h0[st_off + ent(i, j)]
                                                  : 0.f;
  for (int r = 0; r < n_str; ++r) {
    const int s0 = r * kK, L = min(kK, S - s0);
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (valid(i, j)) ck[(size_t)r * P * N + ent(i, j)] = hcur[i][j];
    __syncthreads();
    stage_rows(st, g, b, h, s0, L, A, false);
    __syncthreads();
    for (int t = 0; t < L; ++t) {
      const float a = st.a[t], d = st.dt[t];
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const float xv = d * st.x[t][w + 8 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          hcur[i][j] = fmaf(a, hcur[i][j], xv * st.B[t][lane + 32 * j]);
      }
    }
  }

  // 2. reverse: G from the final state's gradient back to the first token
  float G[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      G[i][j] = g.gstate != nullptr && valid(i, j)
                    ? g.gstate[st_off + ent(i, j)]
                    : 0.f;
  float a_next = 1.f;
  for (int r = n_str - 1; r >= 0; --r) {
    const int s0 = r * kK, L = min(kK, S - s0);
    __syncthreads();
    stage_rows(st, g, b, h, s0, L, A, true);
    __syncthreads();
    // the stretch's states: hb[t] = h before token s0 + t
    float hb[kK + 1][PI][NJ];
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        hb[0][i][j] = valid(i, j) ? ck[(size_t)r * P * N + ent(i, j)] : 0.f;
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      const float a = st.a[t], d = st.dt[t];
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const float xv = d * st.x[t][w + 8 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          hb[t + 1][i][j] = fmaf(a, hb[t][i][j], xv * st.B[t][lane + 32 * j]);
      }
    }
#pragma unroll
    for (int t = kK - 1; t >= 0; --t) {
      if (t >= L) continue;
      const float d = st.dt[t];
      float u[PI], gh = 0.f;
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const float gyv = st.gy[t][w + 8 * i];
        u[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          G[i][j] = fmaf(a_next, G[i][j], gyv * st.C[t][lane + 32 * j]);
          u[i] = fmaf(G[i][j], st.B[t][lane + 32 * j], u[i]);
          gh = fmaf(G[i][j], hb[t][i][j], gh);
        }
      }
      // row sums over the lanes; every lane ends with all of them
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          u[i] += __shfl_xor_sync(0xffffffffu, u[i], o);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        gh += __shfl_xor_sync(0xffffffffu, gh, o);
      float t1 = 0.f;
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const int p = w + 8 * i;
        t1 = fmaf(st.x[t][p], u[i], t1);
        if (lane == i && p < P)
          g.dx[(((size_t)b * S + s0 + t) * g.H + h) * P + p] = d * u[i];
      }
      // column sums over the warp's rows
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int i = 0; i < PI; ++i) {
          sb = fmaf(G[i][j], st.x[t][w + 8 * i], sb);
          sc = fmaf(hb[t + 1][i][j], st.gy[t][w + 8 * i], sc);
        }
        dBw[t][w][lane + 32 * j] = sb;
        dCw[t][w][lane + 32 * j] = sc;
      }
      if (lane == 0) {
        t1w[t][w] = t1;
        ghw[t][w] = gh;
      }
      a_next = st.a[t];
    }
    __syncthreads();
    // the stretch's rows of dB, dC (this head's share), ddt and dA's terms
    for (int e = threadIdx.x; e < L * N; e += kBThreads) {
      const int t = e / N, n = e % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        sb += dBw[t][ww][n];
        sc += dCw[t][ww][n];
      }
      const size_t o = ((size_t)bh * S + s0 + t) * N + n;
      g.dB_part[o] = st.dt[t] * sb;
      g.dC_part[o] = sc;
    }
    if (threadIdx.x < L) {
      const int t = threadIdx.x;
      float t1 = 0.f, gh = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        t1 += t1w[t][ww];
        gh += ghw[t][ww];
      }
      g.ddt[((size_t)b * S + s0 + t) * g.H + h] = t1 + A * st.a[t] * gh;
      g.dA_part[(size_t)bh * S + s0 + t] = st.dt[t] * st.a[t] * gh;
    }
  }
}

// dB, dC (Bb, S, N): the heads' rows added in head order; dA (H,): the
// batch's and tokens' terms added in order
__global__ void ssd_bwd_reduce(const float* __restrict__ dB_part,
                               const float* __restrict__ dC_part,
                               const float* __restrict__ dA_part,
                               float* __restrict__ dB, float* __restrict__ dC,
                               float* __restrict__ dA, int Bb, int S, int H,
                               int N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n_bc = (long)Bb * S * N;
  if (e < n_bc) {
    const long b = e / ((long)S * N), sn = e % ((long)S * N);
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t o = ((size_t)b * H + h) * S * N + sn;
      sb += dB_part[o];
      sc += dC_part[o];
    }
    dB[e] = sb;
    dC[e] = sc;
  } else if (e < n_bc + H) {
    const int h = (int)(e - n_bc);
    float sa = 0.f;
    for (int b = 0; b < Bb; ++b)
      for (int s = 0; s < S; ++s) sa += dA_part[((size_t)b * H + h) * S + s];
    dA[h] = sa;
  }
}

template <int PI, int NJ>
int launch(const BwdArgs& a, int Bb, cudaStream_t stream) {
  ssd_bwd_kernel<PI, NJ><<<Bb * a.H, kBThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ssd_bwd

}  // namespace

extern "C" {

// h0 may be null (a zero initial state). P and N multiples of 4 in 4..64;
// `ranks` blocks (1..8) a (b, h), each a segment of `per` 64-row chunks,
// the last one holding the end of the sequence (kernel.py split_sequence).
// Returns cudaGetLastError() after the launch, 0 on success.
int ssm_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* h0, void* y, void* state, int Bb,
             int S, int H, int P, int N, int ranks, int per, void* stream) {
  if (Bb < 0 || S < 0 || H < 1 || P < 4 || P > kMax || P % 4 || N < 4 ||
      N > kMax || N % 4 || ranks < 1 || ranks > kMaxRanks || per < 0 ||
      (long long)ranks * per * kL < S ||
      (S > 0 && (long long)(ranks - 1) * per * kL >= S) ||
      (S == 0 && ranks != 1))
    return (int)cudaErrorInvalidValue;
  if (Bb == 0) return 0;
  const int err = configure();
  if (err != 0) return err;
  Args args{static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(A),  static_cast<const float*>(B),
            static_cast<const float*>(C),  static_cast<const float*>(h0),
            static_cast<float*>(y),        static_cast<float*>(state),
            S, H, P, N, ranks, per};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ranks * Bb * H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr = cluster_attr(ranks);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_kernel_mma, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of `ranks` blocks the card holds at once
// (cudaOccupancyMaxActiveClusters); with ranks = 1, the blocks. Minus the
// CUDA error on failure.
int ssm_scan_active_clusters(int ranks) {
  if (ranks < 1 || ranks > kMaxRanks) return -(int)cudaErrorInvalidValue;
  const int err = configure();
  if (err != 0) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr = cluster_attr(ranks);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&active, ssd_kernel_mma, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return active;
}

// The backward of ssm_scan: gy like y, gstate (optional: zero) like state,
// h0 optional as in ssm_scan; dx like x, ddt like dt; dA (H,), dB and dC
// like B and C; dB_part, dC_part (Bb, H, S, N), dA_part (Bb, H, S) and
// ckpt (Bb * H, ceil(S / ssm_scan_bwd_stretch()), P * N) float32 scratch.
// Returns cudaGetLastError() after the launches, 0 on success.
int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* h0, const void* gy,
                 const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* dB_part, void* dC_part, void* dA_part,
                 void* ckpt, int Bb, int S, int H, int P, int N,
                 void* stream) {
  if (Bb < 0 || S < 0 || H < 1 || P < 1 || P > kMax || N < 1 || N > kMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bb == 0 || S == 0)
    return (int)cudaMemsetAsync(dA, 0, sizeof(float) * H, s);
  ssd_bwd::BwdArgs a{static_cast<const float*>(x),
                     static_cast<const float*>(dt),
                     static_cast<const float*>(A),
                     static_cast<const float*>(B),
                     static_cast<const float*>(C),
                     static_cast<const float*>(h0),
                     static_cast<const float*>(gy),
                     static_cast<const float*>(gstate),
                     static_cast<float*>(dx),
                     static_cast<float*>(ddt),
                     static_cast<float*>(dB_part),
                     static_cast<float*>(dC_part),
                     static_cast<float*>(dA_part),
                     static_cast<float*>(ckpt),
                     S, H, P, N};
  int err;
  const int pi = (P + 7) / 8;
  if (N <= 32)
    err = pi <= 1   ? ssd_bwd::launch<1, 1>(a, Bb, s)
          : pi <= 2 ? ssd_bwd::launch<2, 1>(a, Bb, s)
          : pi <= 4 ? ssd_bwd::launch<4, 1>(a, Bb, s)
                    : ssd_bwd::launch<8, 1>(a, Bb, s);
  else
    err = pi <= 1   ? ssd_bwd::launch<1, 2>(a, Bb, s)
          : pi <= 2 ? ssd_bwd::launch<2, 2>(a, Bb, s)
          : pi <= 4 ? ssd_bwd::launch<4, 2>(a, Bb, s)
                    : ssd_bwd::launch<8, 2>(a, Bb, s);
  if (err != 0) return err;
  const long total = (long)Bb * S * N + H;
  ssd_bwd::ssd_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA), Bb, S, H, N);
  return (int)cudaGetLastError();
}

// Tokens between two of the backward's saved states.
int ssm_scan_bwd_stretch() { return ssd_bwd::kK; }

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
