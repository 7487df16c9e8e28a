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
// The backward (ssd_bwd_mma, then ssd_bwd_sum; no TPU counterpart: the JAX
// package differentiates its plain jnp) takes the gradients gy of y and of
// the final state back to x, dt, A, B and C, the same function as
// kernels/ssm_scan/ref.py ssd_bwd_ref, rewritten per 64-row chunk
// (ref.py ssd_bwd_chunked_ref is its plain model). For a chunk of rows t,
// a = dt A, ca its inclusive cumsum, la = ca at the chunk's end, h_c the
// state before it and Gam_c the gradient reaching the state after it
// (Gam_last = gstate, Gam_{c-1} = exp(la_c) Gam_c + D_c, D_c = sum_t
// exp(ca_t) gy_t C_t^T):
//   K_ts  = exp(ca_t - ca_s) (C_t . B_s),  M'_ts = exp(ca_t - ca_s) dt_s
//           (gy_t . x_s),  M = (C_t . B_s) M'   (s <= t)
//   u_s   = sum_t K_ts gy_t + exp(la - ca_s) Gam_c B_s,  dx_s = dt_s u_s
//   dB_s  = sum_h [sum_t M'_ts C_t + exp(la - ca_s) dt_s Gam_c^T x_s]
//   dC_t  = sum_h [sum_s M'_ts B_s + exp(ca_t) h_c^T gy_t]
//   rho_s = sum_{t >= s} sum_{r < s} M_tr + sum_{t >= s} exp(ca_t) gy_t .
//           h_c C_t + sum_{r < s} exp(la - ca_r) dt_r x_r . Gam_c B_r
//           + exp(la) <Gam_c, h_c>          (d loss / d(dt_s A))
//   ddt_s = x_s . u_s + A rho_s,  dA = sum_{b,s} dt_s rho_s.
// Every exponent is <= 0 and is the sum of the a's it spans (8-row block
// sums for exp(ca_t - ca_s), a scan from the end for la - ca_s),
// never the difference of two cumulative sums, which under strong decays
// (A dt down to -80) loses digits: the plain chunked forward's gradient at
// 64-row chunks lies 1e-4 of its scale from the exact one there.
//
// What bounds it on the H100: at zamba2's training shape (2 x 256 tokens,
// 80 heads, P = N = 64) it must move 34.9 MB (x, gy, dx read or written
// once dominate), 0.0104 ms at 3.35 TB/s, and do about 10 P N flops a
// token and head, 0.0102 ms at 3xTF32's 165 TFLOP/s: its bytes, barely.
//
// Design.
// - One thread block of 4 warps a 64-row chunk of one (b, h); the chunks
//   of a (b, h) are cut into R segments of whole chunks (kernel.py
//   split_sequence_bwd: one chunk a rank up to 8 chunks, R = 4 at 256
//   tokens), the R blocks one cluster. Each rank first walks its segment
//   for its (G, la) and (D, la) from zero (two state products a chunk); at
//   one cluster barrier each reads the earlier ranks' (G, la) for the
//   state before its segment and the later ranks' (D, la) for the gradient
//   after it, through distributed shared memory: no serial chain, no
//   scratch for states. A segment of several chunks is walked in reverse,
//   Gam carried back and each chunk's h recomputed from the segment's
//   start (the backward's planner splits wherever it can, so that only
//   sequences past 512 tokens have segments of more than one chunk).
// - Per chunk, x, gy, B, C and dt staged with cp.async (zero filled past
//   the segment and past P / N); warp 0 scans a. Then warp i, over rows
//   16i .. 16i + 15: in s-major order (rows s, the column tiles t >= 16 i)
//   B.C^T and x.gy^T, turned in registers into K^T, M'^T and M^T; rho's
//   rectangle sums from M^T (each row's suffix sum over t, then down the
//   columns s > r); u = K^T gy + (exp(la - ca) B) Gam^T, with x . u and
//   dx; dB's state part, its row dots with B (rho's third term), + M'^T
//   C. M'^T goes to x's rows; in t-major order (rows t) dC's state part,
//   its row dots with C (rho's second term), + M' B, M' read transposed.
//   Warp 0 then forms rho, ddt and the chunk's share of dA. The causal
//   products run only on tiles at or right of the diagonal, K^T and M'^T
//   as A operands straight from the accumulators (a fragment's k order is
//   free: slot t is column 2t of the tile, slot t + 4 column 2t + 1).
// - Every product is mma.sync m16n8k8 TF32, split 3xTF32 (csrc/mma.cuh):
//   one TF32 pass misses the 2e-5 gate at zamba2's width
//   (tests/test_torch_ssm_bwd_numerics.py). About 7.5 (64, 64, 64)
//   products a chunk where R > 1, 5.5 where R = 1.
// - dB and dC are shared by the heads and dA by the batch: each block
//   writes its head's rows (dB_part, dC_part, (Bb, H, S, N)) and its
//   segment's dA, and ssd_bwd_sum adds them in a fixed order, 8 warps over
//   the heads of each 32 float4 of dB and dC, then the warps in order, so
//   the gradients are the same bits on every run (no floating-point
//   atomics).
//
// Shared memory: 108,096 bytes a block (x or M'^T, gy, B, C, h_c and Gam_c
// as padded (64, 64) tiles, which hold the segment's G and D at the
// exchange; the chunk's vectors), two blocks an SM. Registers: 255 a
// thread with a few spilled (ptxas; chip_smoke.py phase 1 logs it).

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
using paged::mma_tf32;
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
// Backward: chunked, 3xTF32 mma.sync, the sequence split over a cluster
// ---------------------------------------------------------------------------

namespace ssd_bwd {

constexpr int kBThreads = 128;       // 4 warps: warp i owns rows 16i.. of a tile
constexpr int kBTile = kL * kLd;     // a (64, 64) tile of padded rows
// shared memory, in floats: six tiles, then the chunk's vectors
constexpr int kXs = 0;               // x rows (s, p); then M'^T (s, t)
constexpr int kGy = kBTile;          // gy rows (t, p)
constexpr int kBs = 2 * kBTile;      // B rows (s, n)
constexpr int kCs = 3 * kBTile;      // C rows (t, n)
constexpr int kHb = 4 * kBTile;      // h_c (p, n); the segment's G at the exchange
constexpr int kGb = 5 * kBTile;      // Gam_c (p, n); the segment's D at the exchange
constexpr int kVec = 6 * kBTile;
constexpr int kDt = kVec;            // dt
constexpr int kAv = kDt + kL;        // a = dt A
constexpr int kEa = kAv + kL;        // exp(ca_t)
constexpr int kEb = kEa + kL;        // exp(la - ca_s)
constexpr int kEbdt = kEb + kL;      // exp(la - ca_s) dt_s
constexpr int kXu = kEbdt + kL;      // x_s . u_s
constexpr int kW2 = kXu + kL;        // exp(ca_t) gy_t . h_c C_t
constexpr int kW3 = kW2 + kL;        // exp(la - ca_s) dt_s x_s . Gam_c B_s
constexpr int kT1 = kW3 + kL;        // each warp's share of rho's rectangle sums
constexpr int kRed = kT1 + 4 * kL;   // each warp's share of <Gam_c, h_c>
constexpr int kLa = kRed + 4;        // [0]: the chunk's la, [1]: the segment's
// a's sums within each 8-row block: up to and with each row, after each
// row, and the whole block's
constexpr int kPre = kLa + 4;
constexpr int kSuf = kPre + kL;
constexpr int kBlk = kSuf + kL;
constexpr int kBSmemFloats = kBlk + kL / 8;
constexpr size_t kBSmemBytes = kBSmemFloats * sizeof(float);

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;      // may be null: a zero initial state
  const float* gy;
  const float* gstate;  // may be null: a zero gradient of the final state
  float* dx;
  float* ddt;
  float* dB_part;  // (Bb, H, S, N): each head's share of dB
  float* dC_part;  // (Bb, H, S, N)
  float* dA_part;  // (Bb, H, ranks): each segment's share of dA
  int S, H, P, N;
  int ranks;  // blocks of a cluster: segments of one (b, h)
  int per;    // chunks a segment
};

struct BCtx {
  int tid, lane, g, t4, i;  // i: the warp, the 16-row tile it owns
  int b, h, bh, rank;
  int r0;   // the segment's first row
  float a;  // A_h
};

// A (16 x 64) fragment-layout state tile: rows 16 i + g and + 8 of P,
// columns 8 nj + 2 t4 and + 1 of N, the accumulator layout of mma_tf32
using Tile = float[8][4];

__device__ __forceinline__ void zero(Tile& t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[j][q] = 0.f;
}
__device__ __forceinline__ void scale(Tile& t, float d) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[j][q] *= d;
}
// rows g by d0, rows g + 8 by d1
__device__ __forceinline__ void scale_rows(Tile& t, float d0, float d1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j][0] *= d0;
    t[j][1] *= d0;
    t[j][2] *= d1;
    t[j][3] *= d1;
  }
}
// t[j] += a . b[j] over the first J n-tiles in split precision, the three
// passes (lo.hi, hi.lo, hi.hi) each over all J tiles, so that back-to-back
// MMAs feed different accumulators (each accumulator's sums in
// mma_tf32x3's order)
template <int J, int M>
__device__ __forceinline__ void mma_row(float (&t)[M][4], const float (&av)[4],
                                        const float (&bv)[J][2]) {
  uint32_t ahi[4], alo[4], bhi[J][2], blo[J][2];
  split4(av, ahi, alo);
#pragma unroll
  for (int j = 0; j < J; ++j) split2(bv[j][0], bv[j][1], bhi[j], blo[j]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(t[j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(t[j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(t[j], ahi, bhi[j][0], bhi[j][1]);
}

// offset of a tile's entries (nj, q = 0 / 2) in a padded (64, 64) buffer
__device__ __forceinline__ int at(const BCtx& k, int nj, int q) {
  return (16 * k.i + k.g + (q >> 1) * 8) * kLd + 8 * nj + 2 * k.t4;
}
__device__ __forceinline__ void store(const BCtx& k, float* m, const Tile& t) {
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    *reinterpret_cast<float2*>(m + at(k, nj, 0)) = make_float2(t[nj][0], t[nj][1]);
    *reinterpret_cast<float2*>(m + at(k, nj, 2)) = make_float2(t[nj][2], t[nj][3]);
  }
}
// A tile in a thread's own order (float4 m of thread tid at m kBThreads +
// tid), for the cluster exchange: a peer's thread tid reads it back with
// eight 16-byte loads, each warp's load one contiguous 512 bytes.
__device__ __forceinline__ void put(const BCtx& k, float* m, const Tile& t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    reinterpret_cast<float4*>(m)[j * kBThreads + k.tid] =
        make_float4(t[j][0], t[j][1], t[j][2], t[j][3]);
}
// The address of `p` in cluster rank q's shared memory, and loads from it.
__device__ __forceinline__ uint32_t peer(const void* p, int q) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(q));
  return r;
}
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
// A peer's put() tile (thread tid's part) and its segment's log decay.
__device__ __forceinline__ void get_peer(const BCtx& k, const float* m,
                                         const float* l, int q, float4 (&t)[8],
                                         float& lq) {
  const uint32_t base = peer(m, q) + 16u * k.tid;
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = ld_peer4(base + 16u * kBThreads * j);
  lq = ld_peer(peer(l, q));
}
// t = exp(l) t + u
__device__ __forceinline__ void fold(Tile& t, float l, const float4 (&u)[8]) {
  const float d = expf(l);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j][0] = fmaf(d, t[j][0], u[j].x);
    t[j][1] = fmaf(d, t[j][1], u[j].y);
    t[j][2] = fmaf(d, t[j][2], u[j].z);
    t[j][3] = fmaf(d, t[j][3], u[j].w);
  }
}

// a (Bb, H, P, N) state of this (b, h) from device memory, or zero
__device__ __forceinline__ void load_state(const BwdArgs& a, const BCtx& k,
                                           const float* src, Tile& t) {
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int q = 0; q < 4; q += 2) {
      const int p = 16 * k.i + k.g + (q >> 1) * 8, n = 8 * nj + 2 * k.t4;
      float2 v = make_float2(0.f, 0.f);
      if (src && p < a.P && n < a.N)
        v = *reinterpret_cast<const float2*>(src + ((size_t)k.bh * a.P + p) *
                                                 a.N + n);
      t[nj][q] = v.x;
      t[nj][q + 1] = v.y;
    }
}

// Stage rows [t0, t0 + rows) (rows <= 64) of x, B and dt, and with `full`
// of gy and C; zeros past `rows` and past P / N.
__device__ __forceinline__ void stage(const BwdArgs& a, const BCtx& k,
                                      float* sm, int t0, int rows, bool full) {
  constexpr int kGroups = kMax / 4;  // 16-byte groups a row
#pragma unroll 2
  for (int e = k.tid; e < kL * kGroups; e += kBThreads) {
    const int s = e / kGroups, q = e % kGroups;
    const bool okx = s < rows && 4 * q < a.P;
    const size_t xo =
        okx ? (((size_t)k.b * a.S + t0 + s) * a.H + k.h) * a.P + 4 * q : 0;
    const bool okn = s < rows && 4 * q < a.N;
    const size_t bo = okn ? ((size_t)k.b * a.S + t0 + s) * a.N + 4 * q : 0;
    const int o = s * kLd + 4 * q;
    cp_async_16(sm + kXs + o, a.x + xo, okx);
    cp_async_16(sm + kBs + o, a.B + bo, okn);
    if (full) {
      cp_async_16(sm + kGy + o, a.gy + xo, okx);
      cp_async_16(sm + kCs + o, a.C + bo, okn);
    }
  }
  if (k.tid < kL) {
    const bool ok = k.tid < rows;
    cp_async_4(sm + kDt + k.tid,
               a.dt + (ok ? ((size_t)k.b * a.S + t0 + k.tid) * a.H + k.h : 0),
               ok);
  }
  cp_async_commit();
}

// Warp 0: the chunk's decay terms. a = dt A; ca its inclusive scan;
// la - ca_s the scan of a from the end, past s (a sum of the a's it spans,
// not a difference of two long sums); exp(ca), exp(la - ca), exp(la - ca)
// dt and la. Lane l takes rows l and l + 32.
__device__ __forceinline__ void scan(const BCtx& k, float* sm) {
  const int l = k.lane;
  const float d0 = sm[kDt + l], d1 = sm[kDt + l + 32];
  const float a0 = d0 * k.a, a1 = d1 * k.a;
  float c0 = a0, c1 = a1, p0 = a0, p1 = a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, c0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, c1, o);
    const float v0 = __shfl_down_sync(0xffffffffu, p0, o);
    const float v1 = __shfl_down_sync(0xffffffffu, p1, o);
    if (l >= o) {
      c0 += u0;
      c1 += u1;
    }
    if (l + o < 32) {
      p0 += v0;
      p1 += v1;
    }
  }
  c1 += __shfl_sync(0xffffffffu, c0, 31);  // rows 32.. after rows 0..31
  p0 += __shfl_sync(0xffffffffu, p1, 0);   // rows ..31 before rows 32..
  // the sums past each row: the next row's inclusive sum from the end
  float q0 = __shfl_down_sync(0xffffffffu, p0, 1);
  float q1 = __shfl_down_sync(0xffffffffu, p1, 1);
  const float first1 = __shfl_sync(0xffffffffu, p1, 0);
  if (l == 31) {
    q0 = first1;
    q1 = 0.f;
  }
  sm[kAv + l] = a0;
  sm[kAv + l + 32] = a1;
  sm[kEa + l] = expf(c0);
  sm[kEa + l + 32] = expf(c1);
  const float e0 = expf(q0), e1 = expf(q1);
  sm[kEb + l] = e0;
  sm[kEb + l + 32] = e1;
  sm[kEbdt + l] = e0 * d0;
  sm[kEbdt + l + 32] = e1 * d1;
  const float la = __shfl_sync(0xffffffffu, c1, 31);
  if (l == 0) sm[kLa] = la;
  // within each 8-row block: the sum up to and with each row (lanes of 8),
  // the sum after it, the block's sum
  float b0 = a0, b1 = a1;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, b0, o, 8);
    const float u1 = __shfl_up_sync(0xffffffffu, b1, o, 8);
    if ((l & 7) >= o) {
      b0 += u0;
      b1 += u1;
    }
  }
  float f0 = a0, f1 = a1;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const float u0 = __shfl_down_sync(0xffffffffu, f0, o, 8);
    const float u1 = __shfl_down_sync(0xffffffffu, f1, o, 8);
    if ((l & 7) + o < 8) {
      f0 += u0;
      f1 += u1;
    }
  }
  float g0 = __shfl_down_sync(0xffffffffu, f0, 1, 8);
  float g1 = __shfl_down_sync(0xffffffffu, f1, 1, 8);
  if ((l & 7) == 7) {
    g0 = 0.f;
    g1 = 0.f;
    sm[kBlk + (l >> 3)] = b0;
    sm[kBlk + 4 + (l >> 3)] = b1;
  }
  sm[kPre + l] = b0;
  sm[kPre + l + 32] = b1;
  sm[kSuf + l] = g0;
  sm[kSuf + l + 32] = g1;
}

// t += sum over the chunk's rows s of (w_s v_s)^T m_s (v rows
// (s, p), m rows (s, n)): this warp's rows p, every column n. A state
// product: G = (exp(la - ca) dt x)^T B, D = (exp(ca) gy)^T C.
__device__ __forceinline__ void state_product(const BCtx& k, const float* vs,
                                              const float* ms, const float* w,
                                              float wscale, Tile& t) {
  const int pb = 16 * k.i, g = k.g, t4 = k.t4;
#pragma unroll 2
  for (int kk = 0; kk < kL / 8; ++kk) {
    const int s0 = 8 * kk + 2 * t4;
    const float u0 = w[s0] * wscale, u1 = w[s0 + 1] * wscale;
    const float* vr = vs + s0 * kLd + pb + g;
    const float av[4] = {u0 * vr[0], u0 * vr[8], u1 * vr[kLd],
                         u1 * vr[kLd + 8]};
    float bv[8][2];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const float* mr = ms + s0 * kLd + 8 * nj + g;
      bv[nj][0] = mr[0];
      bv[nj][1] = mr[kLd];
    }
    mma_row(t, av, bv);
  }
}

// t += (w_r v_r) . m over k < 64 for this warp's 16 rows r: v rows
// (r, k) scaled by w, m a state (k, n) (rows k). The state parts of dB
// ((exp(la - ca) dt x) Gam) and dC ((exp(ca) gy) h).
__device__ __forceinline__ void rows_by_state(const BCtx& k, const float* vs,
                                              const float* w, const float* m,
                                              Tile& t) {
  const int rb = 16 * k.i, g = k.g, t4 = k.t4;
  const float w0 = w[rb + g], w1 = w[rb + g + 8];
#pragma unroll 2
  for (int kk = 0; kk < kMax / 8; ++kk) {
    const float* vr = vs + (rb + g) * kLd + 8 * kk + t4;
    const float av[4] = {w0 * vr[0], w1 * vr[8 * kLd], w0 * vr[4],
                         w1 * vr[8 * kLd + 4]};
    float bv[8][2];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const float* mr = m + (8 * kk + t4) * kLd + 8 * nj + g;
      bv[nj][0] = mr[0];
      bv[nj][1] = mr[4 * kLd];
    }
    mma_row(t, av, bv);
  }
}

// The row dots of this warp's 16 rows of t with rows of m (padded (64, 64)):
// each row's sum over its 64 columns, in lane t4 = 0 of its quad.
__device__ __forceinline__ void row_dots(const BCtx& k, const Tile& t,
                                         const float* m, float& r0,
                                         float& r1) {
  r0 = 0.f;
  r1 = 0.f;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const float2 u = *reinterpret_cast<const float2*>(m + at(k, nj, 0));
    const float2 v = *reinterpret_cast<const float2*>(m + at(k, nj, 2));
    r0 = fmaf(t[nj][0], u.x, fmaf(t[nj][1], u.y, r0));
    r1 = fmaf(t[nj][2], v.x, fmaf(t[nj][3], v.y, r1));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, o);
    r1 += __shfl_xor_sync(0xffffffffu, r1, o);
  }
}

// Within each quad (the 4 lanes of one row g): the sum of v over the lanes
// after this one, and over all four (the same bits in each lane).
__device__ __forceinline__ float quad_after(float v, int t4) {
  const float u1 = __shfl_down_sync(0xffffffffu, v, 1);
  const float u2 = __shfl_down_sync(0xffffffffu, v, 2);
  const float u3 = __shfl_down_sync(0xffffffffu, v, 3);
  float r = 0.f;
  if (t4 <= 2) r += u1;
  if (t4 <= 1) r += u2;
  if (t4 == 0) r += u3;
  return r;
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write 16 rows of a (64, 64) tile's accumulators to device memory: rows
// row0 + 16 i + g (+ 8) of `base`, `stride` floats apart, columns below
// `cols`, rows below `rows`.
__device__ __forceinline__ void write_rows(const BCtx& k, float* base,
                                           size_t stride, const Tile& t,
                                           int rows, int cols) {
  const int r = 16 * k.i + k.g;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int c = 8 * nj + 2 * k.t4;
    if (c >= cols) continue;
    if (r < rows)
      *reinterpret_cast<float2*>(base + r * stride + c) =
          make_float2(t[nj][0], t[nj][1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(base + (r + 8) * stride + c) =
          make_float2(t[nj][2], t[nj][3]);
  }
}

// Steps 1-3 of a chunk for warp tile I, in s-major order (rows s, columns
// t >= s, the 8 - 2 I column tiles at or right of the rows):
// 1. B.C^T and x.gy^T; K^T_st = (B_s.C_t) e_st and M'^T = (x_s.gy_t) e_st
//    dt_s in registers, with e_st = exp(sum of a over (s, t]); M^T = K^T
//    (x_s.gy_t) dt_s gives rho's rectangle sums: each row's suffix sum
//    over t >= s, then over this warp's rows r < s (T1 of rho), to t1w.
// 2. u = K^T gy + (exp(la - ca) B) Gam^T; x . u to xu; dx = dt u.
// 3. dB's state part (exp(la - ca) dt x) Gam, its row dots with B to w3,
//    then dB += M'^T C; this head's rows of dB to dB_part.
// Leaves M'^T in mp (tiles 0 .. 7 - 2 I: column tile 2 I + jj).
template <int I>
__device__ __forceinline__ void s_major(const BwdArgs& a, const BCtx& k,
                                        float* sm, int t0, int rows, bool gz,
                                        Tile& mp) {
  constexpr int kJ = 8 - 2 * I;
  constexpr int j0 = 2 * I;
  const int g = k.g, t4 = k.t4, sb = 16 * I;
  const float* xs = sm + kXs;
  const float* gys = sm + kGy;
  const float* bs = sm + kBs;
  const float* cs = sm + kCs;
  const float* gb = sm + kGb;
  float bc[kJ][4];
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bc[jj][q] = 0.f;
      mp[jj][q] = 0.f;
    }
#pragma unroll 2
  for (int kk = 0; kk < kMax / 8; ++kk) {
    const float* br = bs + (sb + g) * kLd + 8 * kk + t4;
    const float av[4] = {br[0], br[8 * kLd], br[4], br[8 * kLd + 4]};
    float bv[kJ][2];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float* cr = cs + (8 * (j0 + jj) + g) * kLd + 8 * kk + t4;
      bv[jj][0] = cr[0];
      bv[jj][1] = cr[4];
    }
    mma_row(bc, av, bv);
  }
#pragma unroll 2
  for (int kk = 0; kk < kMax / 8; ++kk) {
    const float* xr = xs + (sb + g) * kLd + 8 * kk + t4;
    const float av[4] = {xr[0], xr[8 * kLd], xr[4], xr[8 * kLd + 4]};
    float bv[kJ][2];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float* yr = gys + (8 * (j0 + jj) + g) * kLd + 8 * kk + t4;
      bv[jj][0] = yr[0];
      bv[jj][1] = yr[4];
    }
    mma_row(mp, av, bv);
  }
  // Right to left over the column tiles: the decays e_st = exp(sum of a
  // over (s, t]), each sum of same-signed a's (within s's 8-row block term
  // by term; past it the rest of s's block, the blocks between and the
  // start of t's); K^T, M'^T and M^T; and rho's rectangle sums: S_r(s) =
  // sum_{t >= s} M^T_rt for this warp's rows r, then sum_{r < s} S_r(s)
  // down each column, to t1w.
  const int s0 = sb + g, s1 = s0 + 8;
  const float dt0 = sm[kDt + s0], dt1 = sm[kDt + s1];
  const float suf0 = sm[kSuf + s0], suf1 = sm[kSuf + s1];
  float* t1w = sm + kT1 + I * kL;
  for (int c = k.lane; c < sb; c += 32) t1w[c] = 0.f;
  float carry0 = 0.f, carry1 = 0.f;
#pragma unroll
  for (int jj = kJ - 1; jj >= 0; --jj) {
    const int c0 = 8 * (j0 + jj) + 2 * t4, c1 = c0 + 1;
    float e00 = 0.f, e10 = 0.f;
    if (jj == 0) {  // s0's block: a over (s0, c0]; every column left of s1
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (sb + q > s0 && sb + q <= c0) e00 += sm[kAv + sb + q];
    } else {
      float mid0 = 0.f, mid1 = 0.f;  // the blocks strictly between
#pragma unroll
      for (int j = 1; j < jj; ++j) {
        mid0 += sm[kBlk + j0 + j];
        if (j >= 2) mid1 += sm[kBlk + j0 + j];
      }
      e00 = (suf0 + mid0) + sm[kPre + c0];
      if (jj == 1) {  // s1's block
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (sb + 8 + q > s1 && sb + 8 + q <= c0) e10 += sm[kAv + sb + 8 + q];
      } else {
        e10 = (suf1 + mid1) + sm[kPre + c0];
      }
    }
    const float a1 = sm[kAv + c1];
    const float e01 = e00 + (c1 > s0 ? a1 : 0.f);
    const float e11 = e10 + (c1 > s1 ? a1 : 0.f);
    const float f[4] = {c0 >= s0 ? expf(e00) : 0.f, c1 >= s0 ? expf(e01) : 0.f,
                        c0 >= s1 ? expf(e10) : 0.f, c1 >= s1 ? expf(e11) : 0.f};
    const float d[4] = {dt0, dt0, dt1, dt1};
    float m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float kv = bc[jj][q] * f[q];
      m[q] = kv * mp[jj][q] * d[q];
      bc[jj][q] = kv;
      mp[jj][q] = mp[jj][q] * f[q] * d[q];
    }
    const float p0 = m[0] + m[1], p1 = m[2] + m[3];
    const float r01 = carry0 + quad_after(p0, t4) + m[1];
    const float r00 = r01 + m[0];
    const float r11 = carry1 + quad_after(p1, t4) + m[3];
    const float r10 = r11 + m[2];
    carry0 += quad_sum(p0);
    carry1 += quad_sum(p1);
    float v0 = (s0 < c0 ? r00 : 0.f) + (s1 < c0 ? r10 : 0.f);
    float v1 = (s0 < c1 ? r01 : 0.f) + (s1 < c1 ? r11 : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (g == 0) {
      t1w[c0] = v0;
      t1w[c1] = v1;
    }
  }

  // 2. u = K^T gy (+ (exp(la - ca) B) Gam^T)
  Tile u;
  zero(u);
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    const float av[4] = {bc[jj][0], bc[jj][2], bc[jj][1], bc[jj][3]};
    float bv[8][2];
#pragma unroll
    for (int pj = 0; pj < 8; ++pj) {
      const float* yr = gys + (8 * (j0 + jj) + 2 * t4) * kLd + 8 * pj + g;
      bv[pj][0] = yr[0];
      bv[pj][1] = yr[kLd];
    }
    mma_row(u, av, bv);
  }
  if (!gz) {
    const float w0 = sm[kEb + s0], w1 = sm[kEb + s1];
#pragma unroll 2
    for (int kk = 0; kk < kMax / 8; ++kk) {
      const float* br = bs + s0 * kLd + 8 * kk + t4;
      const float av[4] = {w0 * br[0], w1 * br[8 * kLd], w0 * br[4],
                           w1 * br[8 * kLd + 4]};
      float bv[8][2];
#pragma unroll
      for (int pj = 0; pj < 8; ++pj) {
        const float* gr = gb + (8 * pj + g) * kLd + 8 * kk + t4;
        bv[pj][0] = gr[0];
        bv[pj][1] = gr[4];
      }
      mma_row(u, av, bv);
    }
  }
  float xu0, xu1;
  row_dots(k, u, xs, xu0, xu1);
  if (t4 == 0) {
    sm[kXu + s0] = xu0;
    sm[kXu + s1] = xu1;
  }
  scale_rows(u, dt0, dt1);
  const size_t xstride = (size_t)a.H * a.P;
  write_rows(k, a.dx + (((size_t)k.b * a.S + t0) * a.H + k.h) * a.P, xstride,
             u, rows, a.P);

  // 3. dB = (exp(la - ca) dt x) Gam + M'^T C
  Tile db;
  zero(db);
  float w30 = 0.f, w31 = 0.f;
  if (!gz) {
    rows_by_state(k, xs, sm + kEbdt, gb, db);
    row_dots(k, db, bs, w30, w31);
  }
  if (t4 == 0) {
    sm[kW3 + s0] = w30;
    sm[kW3 + s1] = w31;
  }
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    const float av[4] = {mp[jj][0], mp[jj][2], mp[jj][1], mp[jj][3]};
    float bv[8][2];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const float* cr = cs + (8 * (j0 + jj) + 2 * t4) * kLd + 8 * nj + g;
      bv[nj][0] = cr[0];
      bv[nj][1] = cr[kLd];
    }
    mma_row(db, av, bv);
  }
  write_rows(k, a.dB_part + ((size_t)k.bh * a.S + t0) * a.N, a.N, db, rows,
             a.N);
}

// Step 4: M'^T (tiles 2 I .. 7 of this warp's rows) into x's rows.
template <int I>
__device__ __forceinline__ void store_mp(const BCtx& k, float* sm,
                                         const Tile& mp) {
  constexpr int kJ = 8 - 2 * I;
  float* r0 = sm + kXs + (16 * I + k.g) * kLd + 16 * I + 2 * k.t4;
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    *reinterpret_cast<float2*>(r0 + 8 * jj) = make_float2(mp[jj][0], mp[jj][1]);
    *reinterpret_cast<float2*>(r0 + 8 * kLd + 8 * jj) =
        make_float2(mp[jj][2], mp[jj][3]);
  }
}

// Step 5, warp i in t-major order (rows t): dC's state part (exp(ca) gy) h,
// its row dots with C to w2, then dC += M' B with M' read transposed from
// x's rows (its columns s <= t: 2 i + 2 k-steps); this head's rows of dC to
// dC_part.
__device__ __forceinline__ void t_major(const BwdArgs& a, const BCtx& k,
                                        float* sm, int t0, int rows,
                                        bool hz) {
  const int g = k.g, t4 = k.t4, tb = 16 * k.i;
  const float* ms = sm + kXs;
  const float* bs = sm + kBs;
  Tile dc;
  zero(dc);
  float w20 = 0.f, w21 = 0.f;
  if (!hz) {
    rows_by_state(k, sm + kGy, sm + kEa, sm + kHb, dc);
    row_dots(k, dc, sm + kCs, w20, w21);
  }
  if (t4 == 0) {
    sm[kW2 + tb + g] = w20;
    sm[kW2 + tb + g + 8] = w21;
  }
  const int ks = 2 * k.i + 2;
#pragma unroll 2
  for (int kk = 0; kk < ks; ++kk) {
    const float* mr = ms + (8 * kk + 2 * t4) * kLd + tb + g;
    const float av[4] = {mr[0], mr[8], mr[kLd], mr[kLd + 8]};
    float bv[8][2];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const float* br = bs + (8 * kk + 2 * t4) * kLd + 8 * nj + g;
      bv[nj][0] = br[0];
      bv[nj][1] = br[kLd];
    }
    mma_row(dc, av, bv);
  }
  write_rows(k, a.dC_part + ((size_t)k.bh * a.S + t0) * a.N, a.N, dc, rows,
             a.N);
}

// Step 6, warp 0: rho_s = T1 (the warps' rectangle sums, in warp order) +
// T2 (w2's suffix sum over t >= s) + T3 (w3's sum over r < s) + exp(la)
// <Gam, h>; ddt = x . u + A rho; returns this chunk's sum of dt rho.
__device__ __forceinline__ float rho(const BwdArgs& a, const BCtx& k,
                                     const float* sm, int t0, int rows,
                                     bool with_dot) {
  const int l = k.lane;
  float w2[2] = {sm[kW2 + l], sm[kW2 + l + 32]};
  float w3[2] = {sm[kW3 + l], sm[kW3 + l + 32]};
  // w2 from the end (inclusive), w3 from the start (exclusive)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float d = __shfl_down_sync(0xffffffffu, w2[q], o);
      const float u = __shfl_up_sync(0xffffffffu, w3[q], o);
      if (l + o < 32) w2[q] += d;
      if (l >= o) w3[q] += u;
    }
  }
  w2[0] += __shfl_sync(0xffffffffu, w2[1], 0);
  w3[1] += __shfl_sync(0xffffffffu, w3[0], 31);
  float x3[2] = {__shfl_up_sync(0xffffffffu, w3[0], 1),
                 __shfl_up_sync(0xffffffffu, w3[1], 1)};
  const float last0 = __shfl_sync(0xffffffffu, w3[0], 31);
  if (l == 0) {
    x3[0] = 0.f;
    x3[1] = last0;
  }
  const float dot =
      with_dot ? expf(sm[kLa]) * (((sm[kRed] + sm[kRed + 1]) + sm[kRed + 2]) +
                                  sm[kRed + 3])
               : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int s = l + 32 * q;
    const float t1 = ((sm[kT1 + s] + sm[kT1 + kL + s]) + sm[kT1 + 2 * kL + s]) +
                     sm[kT1 + 3 * kL + s];
    const float r = ((t1 + w2[q]) + x3[q]) + dot;
    if (s < rows)
      a.ddt[((size_t)k.b * a.S + t0 + s) * a.H + k.h] =
          fmaf(k.a, r, sm[kXu + s]);
    sum = fmaf(sm[kDt + s], r, sum);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// One chunk (staged and scanned; h_c in hb, Gam_c in gb): steps 1-6.
// Returns (in thread 0) its sum of dt rho.
__device__ __forceinline__ float chunk_grads(const BwdArgs& a, const BCtx& k,
                                             float* sm, int t0, int rows,
                                             bool hz, bool gz) {
  // <Gam_c, h_c>, each warp its rows
  if (!hz && !gz) {
    float d = 0.f;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int o = at(k, nj, q);
        d = fmaf(sm[kHb + o], sm[kGb + o], d);
        d = fmaf(sm[kHb + o + 1], sm[kGb + o + 1], d);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (k.lane == 0) sm[kRed + k.i] = d;
  }
  Tile mp;
  switch (k.i) {
    case 0: s_major<0>(a, k, sm, t0, rows, gz, mp); break;
    case 1: s_major<1>(a, k, sm, t0, rows, gz, mp); break;
    case 2: s_major<2>(a, k, sm, t0, rows, gz, mp); break;
    default: s_major<3>(a, k, sm, t0, rows, gz, mp); break;
  }
  __syncthreads();  // every warp is done with x's rows
  switch (k.i) {
    case 0: store_mp<0>(k, sm, mp); break;
    case 1: store_mp<1>(k, sm, mp); break;
    case 2: store_mp<2>(k, sm, mp); break;
    default: store_mp<3>(k, sm, mp); break;
  }
  __syncthreads();
  t_major(a, k, sm, t0, rows, hz);
  __syncthreads();
  float sum = 0.f;
  if (k.i == 0) sum = rho(a, k, sm, t0, rows, !hz && !gz);
  return sum;
}

__device__ __forceinline__ int chunk_rows(const BwdArgs& a, const BCtx& k,
                                          int c) {
  return min(kL, a.S - (k.r0 + c * kL));
}

// Stage chunk c of the segment and scan it (x, B and dt only unless `full`).
__device__ __forceinline__ void load_chunk(const BwdArgs& a, const BCtx& k,
                                           float* sm, int c, bool full) {
  __syncthreads();  // no warp still reads the rows or vectors replaced
  stage(a, k, sm, k.r0 + c * kL, chunk_rows(a, k, c), full);
  cp_async_wait_group<0>();
  __syncthreads();
  if (k.i == 0) scan(k, sm);
  __syncthreads();
}

__global__ void __launch_bounds__(kBThreads, 2) ssd_bwd_mma(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  BCtx k;
  k.tid = threadIdx.x;
  k.lane = k.tid & 31;
  k.g = k.lane >> 2;
  k.t4 = k.lane & 3;
  k.i = k.tid >> 5;
  k.rank = blockIdx.x % a.ranks;
  k.bh = blockIdx.x / a.ranks;
  k.b = k.bh / a.H;
  k.h = k.bh - k.b * a.H;
  k.r0 = k.rank * a.per * kL;
  k.a = a.A[k.h];
  // the segment's last chunk with rows
  const int last = (min(a.S, k.r0 + a.per * kL) - k.r0 - 1) / kL;
  const bool first_rank = k.rank == 0, last_rank = k.rank == a.ranks - 1;

  // the state before the segment and the gradient after it, from h0 and
  // gstate (loaded first: phase A hides their latency), then the exchange
  Tile hin, gout;
  load_state(a, k, a.h0, hin);
  load_state(a, k, a.gstate, gout);
  bool staged = false;  // chunk `last` is staged and scanned
  if (a.ranks > 1) {
    // the segment's (G, la) and (D, la) from zero: G = sum_c exp(la after
    // c) G_c, D = sum_c exp(la before c) D_c
    Tile gs, ds;
    zero(gs);
    zero(ds);
    float lseg = 0.f;
    for (int c = 0; c <= last; ++c) {
      load_chunk(a, k, sm, c, true);
      const float la = sm[kLa];
      if (!last_rank) {  // no rank reads the last one's G, nor the first's D
        scale(gs, expf(la));
        state_product(k, sm + kXs, sm + kBs, sm + kEbdt, 1.f, gs);
      }
      if (!first_rank)
        state_product(k, sm + kGy, sm + kCs, sm + kEa, expf(lseg), ds);
      lseg += la;
    }
    staged = last == 0;
    put(k, sm + kHb, gs);
    put(k, sm + kGb, ds);
    if (k.tid == 0) sm[kLa + 1] = lseg;
    cluster_arrive_release();
    cluster_wait_acquire();
    // h from the earlier ranks' G in rank order, Gam from the later ranks'
    // D in reverse rank order: no serial chain of ranks; two peers of each
    // side a round, their loads all in flight together
    const int nh = k.rank, ng = a.ranks - 1 - k.rank;
    for (int step = 0; step < max(nh, ng); step += 2) {
      float4 th[2][8], tg[2][8];
      float lh[2], lg[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (step + u < nh)
          get_peer(k, sm + kHb, sm + kLa + 1, step + u, th[u], lh[u]);
        if (step + u < ng)
          get_peer(k, sm + kGb, sm + kLa + 1, a.ranks - 1 - step - u, tg[u],
                   lg[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (step + u < nh) fold(hin, lh[u], th[u]);
        if (step + u < ng) fold(gout, lg[u], tg[u]);
      }
    }
    cluster_arrive_release();  // done with the other ranks' shared memory
    cluster_wait_acquire();    // and they with ours, which is now rewritten
  }

  // the chunks in reverse: Gam carried back, h recomputed from the start
  store(k, sm + kGb, gout);
  float dA = 0.f;
  for (int c = last; c >= 0; --c) {
    if (c == 0) {
      store(k, sm + kHb, hin);
    } else {
      Tile h;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[nj][q] = hin[nj][q];
      for (int j = 0; j < c; ++j) {
        load_chunk(a, k, sm, j, false);
        scale(h, expf(sm[kLa]));
        state_product(k, sm + kXs, sm + kBs, sm + kEbdt, 1.f, h);
      }
      store(k, sm + kHb, h);
    }
    if (!staged) load_chunk(a, k, sm, c, true);
    staged = false;
    __syncthreads();  // h_c and Gam_c are in
    const int t0 = k.r0 + c * kL, rows = chunk_rows(a, k, c);
    const bool hz = first_rank && c == 0 && a.h0 == nullptr;
    const bool gz = last_rank && c == last && a.gstate == nullptr;
    dA += chunk_grads(a, k, sm, t0, rows, hz, gz);
    if (c > 0) {
      // Gam_{c-1} = exp(la_c) Gam_c + D_c
      Tile gm;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const float2 v =
              *reinterpret_cast<const float2*>(sm + kGb + at(k, nj, q));
          gm[nj][q] = v.x;
          gm[nj][q + 1] = v.y;
        }
      scale(gm, expf(sm[kLa]));
      state_product(k, sm + kGy, sm + kCs, sm + kEa, 1.f, gm);
      store(k, sm + kGb, gm);
    }
  }
  if (k.tid == 0)
    a.dA_part[(size_t)k.bh * a.ranks + k.rank] = dA;
}

// dB, dC (Bb, S, N): each 32 float4 of them a block, the heads' shares
// summed by 8 warps (warp w: heads w, w + 8, ..., in order), then the
// warps' sums in warp order; dA (H,): the last block, each head's segment
// shares summed over the batch and the segments in order.
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads)
    ssd_bwd_sum(const float4* __restrict__ dB_part,
                const float4* __restrict__ dC_part,
                const float* __restrict__ dA_part, float4* __restrict__ dB,
                float4* __restrict__ dC, float* __restrict__ dA, int Bb, int S,
                int H, int N, int ranks) {
  __shared__ float4 sb[8][32], sc[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += kSumThreads) {
      float s = 0.f;
      for (int b = 0; b < Bb; ++b)
        for (int r = 0; r < ranks; ++r)
          s += dA_part[((size_t)b * H + h) * ranks + r];
      dA[h] = s;
    }
    return;
  }
  const long per_b = (long)S * N / 4;
  const long e = (long)blockIdx.x * 32 + lane;
  const bool ok = e < (long)Bb * per_b;
  float4 ab = make_float4(0.f, 0.f, 0.f, 0.f), ac = ab;
  if (ok) {
    const long b = e / per_b, rem = e - b * per_b;
#pragma unroll 2
    for (int h = w; h < H; h += 8) {
      const size_t o = ((size_t)b * H + h) * per_b + rem;
      const float4 u = dB_part[o], v = dC_part[o];
      ab.x += u.x;
      ab.y += u.y;
      ab.z += u.z;
      ab.w += u.w;
      ac.x += v.x;
      ac.y += v.y;
      ac.z += v.z;
      ac.w += v.w;
    }
  }
  sb[w][lane] = ab;
  sc[w][lane] = ac;
  __syncthreads();
  if (w == 0 && ok) {
    for (int q = 1; q < 8; ++q) {
      ab.x += sb[q][lane].x;
      ab.y += sb[q][lane].y;
      ab.z += sb[q][lane].z;
      ab.w += sb[q][lane].w;
      ac.x += sc[q][lane].x;
      ac.y += sc[q][lane].y;
      ac.z += sc[q][lane].z;
      ac.w += sc[q][lane].w;
    }
    dB[e] = ab;
    dC[e] = ac;
  }
}

int configure() {
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBSmemBytes);
  return (int)err;
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
// like B and C; dB_part and dC_part (Bb, H, S, N) and dA_part (Bb, H,
// ranks) float32 scratch. P and N multiples of 4 in 4..64; `ranks` blocks
// (1..8) a (b, h), each a segment of `per` 64-row chunks, the last one
// holding the end of the sequence (kernel.py split_sequence_bwd). Returns
// cudaGetLastError() after the launches, 0 on success.
int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* h0, const void* gy,
                 const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* dB_part, void* dC_part, void* dA_part,
                 int Bb, int S, int H, int P, int N, int ranks, int per,
                 void* stream) {
  if (Bb < 0 || S < 0 || H < 1 || P < 4 || P > kMax || P % 4 || N < 4 ||
      N > kMax || N % 4 || ranks < 1 || ranks > kMaxRanks || per < 0 ||
      (long long)ranks * per * kL < S ||
      (S > 0 && (long long)(ranks - 1) * per * kL >= S) ||
      (S == 0 && ranks != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bb == 0 || S == 0)
    return (int)cudaMemsetAsync(dA, 0, sizeof(float) * H, s);
  const int err = ssd_bwd::configure();
  if (err != 0) return err;
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
                     S, H, P, N, ranks, per};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ranks * Bb * H));
  cfg.blockDim = dim3(ssd_bwd::kBThreads);
  cfg.dynamicSmemBytes = ssd_bwd::kBSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr = cluster_attr(ranks);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_bwd::ssd_bwd_mma, a);
  if (e != cudaSuccess) return (int)e;
  const long quads = (long)Bb * S * N / 4;
  ssd_bwd::ssd_bwd_sum<<<(unsigned)((quads + 31) / 32 + 1),
                         ssd_bwd::kSumThreads, 0, s>>>(
      static_cast<const float4*>(dB_part), static_cast<const float4*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<float4*>(dB),
      static_cast<float4*>(dC), static_cast<float*>(dA), Bb, S, H, N, ranks);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
