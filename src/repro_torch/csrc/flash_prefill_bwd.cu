// Backward of causal flash prefill attention for Hopper (sm_90a): GQA, an
// optional sliding window and an optional tanh softcap.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, its
// training differentiates src/repro/models/attention.py::_attend with
// jax.grad. This is the gradient of flash_prefill.cu's function, the
// kernel counterpart of kernels/flash_prefill/grad.py (flash_prefill_vjp).
// For query row i of head h and key j of its KV head g = h / (Hq/Hkv),
// with s_ij = q_i·k_j / sqrt(D), t_ij = tanh(s_ij / c) under a softcap c,
// the capped score c·t_ij (s_ij without one), the causal/window mask of
// the forward and lse_i the forward's row log-sum-exp (natural log):
//   P_ij   = exp(capped s_ij - lse_i)        (0 where masked)
//   Δ_i    = rowsum(dO_i ∘ O_i)
//   dS_ij  = P_ij · (dO_i·v_j - Δ_i) · (1 - t_ij²  under a softcap)
//   dq_i   = sum_j dS_ij · k_j / sqrt(D)
//   dk_j   = sum over the group's heads and rows of dS_ij · q_i / sqrt(D)
//   dv_j   = sum over the group's heads and rows of P_ij · dO_i
// q, k, v, O and dO arrive in bf16 or fp32; lse is fp32; every product
// accumulates in fp32; dq, dk and dv come out in the inputs' dtype.
//
// Bound on the card: operations, 10·D per visible (query, key) pair and
// query head (the five products QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K), at the
// bf16 tensor-core peak (989 TFLOP/s), against q, k, v, O, dO and lse
// read and dq, dk, dv written once at 3.35 TB/s. At olmo-1b's training
// shape (B 8, S 512, 16/16 heads, D 128) that is 21.5 GFLOP → 0.022 ms
// against 134.5 MB → 0.040 ms: bytes; at gemma3's (B 2, S 2048, 16/8, D
// 256, window 1024) 128.9 GFLOP → 0.130 ms: operations.
//
// One call is two launches on the caller's stream, both deterministic
// (every sum in a fixed order, no atomics), so two calls on the same
// inputs give bitwise equal grads:
//   1. dq: one block per (64-query tile, query head, batch). Its prologue
//      computes Δ for its rows from O and dO and writes it to `delta`
//      (B, Hq, S), scratch the wrapper allocates; the block then walks the
//      key tiles its rows can see, recomputing P and dS.
//   2. dk, dv: one block per (64-key tile, KV head, batch). It walks the
//      group's query heads and, for each, the query tiles that can see its
//      keys (rows k0 .. k1 + window - 1, or to S without a window),
//      recomputing P and dS from the saved lse and the Δ of launch 1, and
//      sums dk and dv for the whole group in registers.
// The recompute of QKᵀ and dO·Vᵀ in both launches costs 14·D a pair
// instead of 10·D; it buys a dq without atomics.
//
// bf16: tensor cores, mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the
// block's own 64 rows in shared memory (16 per warp) and the walked tiles
// in a two-stage cp.async ring, all bf16 rows swizzled by 16-byte chunk so
// ldmatrix reads are conflict-free. Per step a warp builds its 16 rows of
// scores and of dO·Vᵀ (dk/dv launch: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, rows =
// keys) as accumulator fragments, masks only a step that crosses the
// diagonal or the window's lower edge for its rows (as the forward does),
// and turns them into P and dS in registers. Two 16×8 accumulator tiles
// are one 16×16 A fragment (FA2), so P and dS feed the next products from
// registers as two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi)
// (together ~2^-17 relative, as the forward's P): dq += dS·K, dv += Pᵀ·dO,
// dk += dSᵀ·Q, the B operands by ldmatrix.trans. A warp that sees no pair
// of a step skips it. At D 256 a warp's 16 rows of fp32 dk and dv would
// take 256 registers a thread, so there two warps share each 16 rows,
// each summing 128 of the D columns (both recompute the scores). At D
// 128 and 256 a dk/dv step walks 16 queries, which keeps that launch
// within 255 registers a thread without spilling (phase 1 of
// chip_smoke.py fails on a spill); 32 queries a step spill there.
//
//   D    warps  launch  own rows  walked tile  shared memory
//   64     4     dq        64      64 keys       49,664 bytes
//                dk/dv     64      64 queries    50,176
//   128    4     dq        64      64 keys       98,816
//                dk/dv     64      16 queries    49,408
//   256    8     dq        64      64 keys      197,120
//                dk/dv     64      16 queries    98,560
//
// fp32: CUDA cores, kept for its accuracy as the forward's f32 path is.
// 256 threads; a thread computes a 4-row by (tile/16)-column block of the
// scores and of dO·Vᵀ with float4 reads from padded fp32 rows in shared
// memory, writes P and dS to shared memory, and sums its rows of the
// output over the tile. At D 256 the walked tiles are 32 rows (dq) and
// both tiles 32 rows (dk/dv) to stay within 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kPad = 4;   // floats of padding a row (float4-aligned)

// rows a block owns and rows a step walks: dq launch (queries, keys),
// dk/dv launch (keys, queries)
template <int D> struct Tiles {
  static constexpr int kDqOwn = 64, kDqWalk = D == 256 ? 32 : 64;
  static constexpr int kKvOwn = D == 256 ? 32 : 64, kKvWalk = D == 256 ? 32 : 64;
};

// dq: q, dO, K, V (rows of D + kPad), dS, the rows' lse and Δ
template <int D> __host__ __device__ constexpr int smem_dq_floats() {
  using TL = Tiles<D>;
  return 2 * (TL::kDqOwn + TL::kDqWalk) * (D + kPad) + TL::kDqOwn * (TL::kDqWalk + kPad) +
         2 * TL::kDqOwn;
}
// dk/dv: K, V, q, dO (rows of D + kPad), P, dS, the walked rows' lse and Δ
template <int D> __host__ __device__ constexpr int smem_dkdv_floats() {
  using TL = Tiles<D>;
  return 2 * (TL::kKvOwn + TL::kKvWalk) * (D + kPad) + 2 * TL::kKvOwn * (TL::kKvWalk + kPad) +
         2 * TL::kKvWalk;
}

// ROWS rows of one head from r0 (row s at src + s·stride) → dst (row
// stride ld floats); rows at or past S are written as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, size_t stride,
                                          int r0, int S) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow, c = (idx - row * kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S) val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * stride + c);
    *reinterpret_cast<float4*>(dst + row * ld + c) = val;
  }
}

// s[i][j] = A[ty + 16i]·B[tx + 16j] and t[i][j] = A2[ty + 16i]·B2[tx + 16j]
// over D, all four tiles with rows of D + kPad floats
template <int D, int RI, int RJ>
__device__ __forceinline__ void dot2(float (&s)[RI][RJ], float (&t)[RI][RJ], const float* A,
                                     const float* Bm, const float* A2, const float* B2, int ty,
                                     int tx) {
  constexpr int kLD = D + kPad;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kLD + d);
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * kLD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        s[i][j] += a[i].x * bv[j].x + a[i].y * bv[j].y + a[i].z * bv[j].z + a[i].w * bv[j].w;
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A2 + (ty + 16 * i) * kLD + d);
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = *reinterpret_cast<const float4*>(B2 + (tx + 16 * j) * kLD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        t[i][j] += a[i].x * bv[j].x + a[i].y * bv[j].y + a[i].z * bv[j].z + a[i].w * bv[j].w;
  }
}

// P and dS of one (query qp, key kp) pair from its raw dot products: x =
// q·k, dp = dO·v; lse and delta of the query's row
__device__ __forceinline__ void p_ds(float x, float dp, float lse, float delta, bool ok,
                                     float scale, float softcap, float& p, float& ds) {
  x *= scale;
  float t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(x / softcap);
    x = t * softcap;
  }
  p = ok ? expf(x - lse) : 0.f;
  ds = p * (dp - delta);
  if (softcap > 0.f) ds *= 1.f - t * t;
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int window) {
  return kp <= qp && qp < S && (window <= 0 || qp - kp < window);
}

// Δ of rows r0 .. r0+ROWS-1 of one head (a warp a row) into sDelta and,
// for rows < S, into delta; lse (natural log) into sLse, +inf past S
template <int D, int ROWS>
__device__ __forceinline__ void row_stats(float* sLse, float* sDelta, const float* o,
                                          const float* dout, const float* lse, float* delta,
                                          size_t stride, int r0, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    const int s = r0 + r;
    float acc = 0.f;
    if (s < S) {
      for (int c = 4 * lane; c < D; c += 128) {
        const float4 a = *reinterpret_cast<const float4*>(o + (size_t)s * stride + c);
        const float4 d = *reinterpret_cast<const float4*>(dout + (size_t)s * stride + c);
        acc += a.x * d.x + a.y * d.y + a.z * d.z + a.w * d.w;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      sLse[r] = s < S ? lse[s] : INFINITY;
      if (s < S) delta[s] = acc;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int S, int Hq, int Hkv, int window,
    float softcap, float scale) {
  constexpr int BR = Tiles<D>::kDqOwn, BC = Tiles<D>::kDqWalk;
  constexpr int RI = BR / 16, RJ = BC / 16, kLD = D + kPad, kLDP = BC + kPad, kNJ = D / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // BR × kLD
  float* sdO = sQ + BR * kLD;                    // BR × kLD
  float* sK = sdO + BR * kLD;                    // BC × kLD
  float* sV = sK + BC * kLD;                     // BC × kLD
  float* sdS = sV + BC * kLD;                    // BR × kLDP
  float* sLse = sdS + BR * kLDP;                 // BR
  float* sDelta = sLse + BR;                     // BR

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int q0 = qt * BR;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t qoff = ((size_t)b * S * Hq + h) * D;
  const float* kh = k + ((size_t)b * S * Hkv + g) * D;
  const float* vh = v + ((size_t)b * S * Hkv + g) * D;
  const size_t roff = ((size_t)b * Hq + h) * S;

  load_rows<D, BR>(sQ, kLD, q + qoff, q_stride, q0, S);
  load_rows<D, BR>(sdO, kLD, dout + qoff, q_stride, q0, S);
  row_stats<D, BR>(sLse, sDelta, out + qoff, dout + qoff, lse + roff, delta + roff, q_stride,
                   q0, S);

  float acc[RI][kNJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;

  const int kt_hi = (min(q0 + BR, S) - 1) / BC;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BC;
    __syncthreads();   // the previous tile's K and dS reads are done (and q, dO, Δ staged)
    load_rows<D, BC>(sK, kLD, kh, kv_stride, k0, S);
    load_rows<D, BC>(sV, kLD, vh, kv_stride, k0, S);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
    dot2<D, RI, RJ>(s, dp, sQ, sK, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], sLse[r], sDelta[r], visible(qp, kp, S, window), scale, softcap,
             p, ds);
        sdS[r * kLDP + tx + 16 * j] = ds;
      }
    }
    __syncwarp();   // a row of dS is written and read by the same 16 lanes

    // acc[i][jj] += dS[ty + 16i, :] · K[:, 4tx + 64jj .. +3]
    for (int c = 0; c < BC; c += 4) {
      float w[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 t4 = *reinterpret_cast<const float4*>(sdS + (ty + 16 * i) * kLDP + c);
        w[i][0] = t4.x; w[i][1] = t4.y; w[i][2] = t4.z; w[i][3] = t4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (c + cc) * kLD + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc[i][jj][0] = fmaf(w[i][cc], kv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(w[i][cc], kv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(w[i][cc], kv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(w[i][cc], kv.w, acc[i][jj][3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    float* o = dq + qoff + (size_t)qp * q_stride + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
      *reinterpret_cast<float4*>(o + 64 * jj) =
          make_float4(acc[i][jj][0] * scale, acc[i][jj][1] * scale, acc[i][jj][2] * scale,
                      acc[i][jj][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int Hq, int Hkv, int window, float softcap, float scale) {
  constexpr int BR = Tiles<D>::kKvOwn, BC = Tiles<D>::kKvWalk;
  constexpr int RI = BR / 16, RJ = BC / 16, kLD = D + kPad, kLDP = BC + kPad, kNJ = D / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // BR × kLD
  float* sV = sK + BR * kLD;                     // BR × kLD
  float* sQ = sV + BR * kLD;                     // BC × kLD
  float* sdO = sQ + BC * kLD;                    // BC × kLD
  float* sP = sdO + BC * kLD;                    // BR × kLDP
  float* sdS = sP + BR * kLDP;                   // BR × kLDP
  float* sLse = sdS + BR * kLDP;                 // BC
  float* sDelta = sLse + BC;                     // BC

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kt = blockIdx.x;                     // early keys see the most rows: first
  const int g = blockIdx.y, b = blockIdx.z, qpk = Hq / Hkv;
  const int k0 = kt * BR;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t kvoff = ((size_t)b * S * Hkv + g) * D;

  load_rows<D, BR>(sK, kLD, k + kvoff, kv_stride, k0, S);
  load_rows<D, BR>(sV, kLD, v + kvoff, kv_stride, k0, S);

  float ak[RI][kNJ][4], av[RI][kNJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[i][jj][e] = av[i][jj][e] = 0.f;

  // query tiles holding a row that sees one of keys k0 .. k0+BR-1
  const int q_last = window > 0 ? min(S - 1, k0 + BR - 1 + window - 1) : S - 1;
  const int qt_lo = k0 / BC, qt_hi = q_last / BC;
  for (int hh = 0; hh < qpk; ++hh) {
    const int h = g * qpk + hh;
    const size_t qoff = ((size_t)b * S * Hq + h) * D;
    const size_t roff = ((size_t)b * Hq + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BC;
      __syncthreads();   // the previous tile's reads are done (and K, V staged)
      load_rows<D, BC>(sQ, kLD, q + qoff, q_stride, q0, S);
      load_rows<D, BC>(sdO, kLD, dout + qoff, q_stride, q0, S);
      for (int i = tid; i < BC; i += kThreads) {
        const bool in = q0 + i < S;
        sLse[i] = in ? lse[roff + q0 + i] : INFINITY;
        sDelta[i] = in ? delta[roff + q0 + i] : 0.f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ: rows keys, columns queries
      float s[RI][RJ], dp[RI][RJ];
      dot2<D, RI, RJ>(s, dp, sK, sQ, sV, sdO, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i, kp = k0 + r;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int c = tx + 16 * j, qp = q0 + c;
          float p, ds;
          p_ds(s[i][j], dp[i][j], sLse[c], sDelta[c], visible(qp, kp, S, window), scale,
               softcap, p, ds);
          sP[r * kLDP + c] = p;
          sdS[r * kLDP + c] = ds;
        }
      }
      __syncwarp();   // a row of P and dS is written and read by the same 16 lanes

      // dv += P · dO, dk += dS · Q over the tile's queries
      for (int c = 0; c < BC; c += 4) {
        float pw[RI][4], dw[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kLDP + c);
          const float4 d = *reinterpret_cast<const float4*>(sdS + (ty + 16 * i) * kLDP + c);
          pw[i][0] = a.x; pw[i][1] = a.y; pw[i][2] = a.z; pw[i][3] = a.w;
          dw[i][0] = d.x; dw[i][1] = d.y; dw[i][2] = d.z; dw[i][3] = d.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj) {
            const float4 ov = *reinterpret_cast<const float4*>(sdO + (c + cc) * kLD + 4 * tx + 64 * jj);
            const float4 qv = *reinterpret_cast<const float4*>(sQ + (c + cc) * kLD + 4 * tx + 64 * jj);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              av[i][jj][0] = fmaf(pw[i][cc], ov.x, av[i][jj][0]);
              av[i][jj][1] = fmaf(pw[i][cc], ov.y, av[i][jj][1]);
              av[i][jj][2] = fmaf(pw[i][cc], ov.z, av[i][jj][2]);
              av[i][jj][3] = fmaf(pw[i][cc], ov.w, av[i][jj][3]);
              ak[i][jj][0] = fmaf(dw[i][cc], qv.x, ak[i][jj][0]);
              ak[i][jj][1] = fmaf(dw[i][cc], qv.y, ak[i][jj][1]);
              ak[i][jj][2] = fmaf(dw[i][cc], qv.z, ak[i][jj][2]);
              ak[i][jj][3] = fmaf(dw[i][cc], qv.w, ak[i][jj][3]);
            }
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= S) continue;
    float* ok = dk + kvoff + (size_t)kp * kv_stride + 4 * tx;
    float* ov = dv + kvoff + (size_t)kp * kv_stride + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      *reinterpret_cast<float4*>(ok + 64 * jj) =
          make_float4(ak[i][jj][0] * scale, ak[i][jj][1] * scale, ak[i][jj][2] * scale,
                      ak[i][jj][3] * scale);
      *reinterpret_cast<float4*>(ov + 64 * jj) =
          make_float4(av[i][jj][0], av[i][jj][1], av[i][jj][2], av[i][jj][3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int Hq,
           int Hkv, int window, float softcap, cudaStream_t stream) {
  using TL = Tiles<D>;
  const int smem_dq = smem_dq_floats<D>() * (int)sizeof(float);
  const int smem_kv = smem_dkdv_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_dq_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid_dq((S + TL::kDqOwn - 1) / TL::kDqOwn, Hq, B);
  flash_prefill_bwd_dq_f32_kernel<D><<<grid_dq, kThreads, smem_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), S, Hq, Hkv, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((S + TL::kKvOwn - 1) / TL::kKvOwn, Hkv, B);
  flash_prefill_bwd_dkdv_f32_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, Hq, Hkv, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf16 {

using T = __nv_bfloat16;
constexpr int kOwn = 64;    // a block's own rows: a row group of 16 a warp
constexpr int kGroups = kOwn / 16;
constexpr int kKeys = 64;   // keys a dq step walks

// kSplit: warps sharing a row group, each summing D / kSplit columns;
// kQueries: queries a dk/dv step walks
template <int D> struct Shape;
template <> struct Shape<64> { static constexpr int kSplit = 1, kQueries = 64; };
template <> struct Shape<128> { static constexpr int kSplit = 1, kQueries = 16; };
template <> struct Shape<256> { static constexpr int kSplit = 2, kQueries = 16; };

template <int D> __host__ __device__ constexpr int smem_dq() {
  return (2 * kOwn + 4 * kKeys) * D * (int)sizeof(T) + 2 * kOwn * (int)sizeof(float);
}
template <int D> __host__ __device__ constexpr int smem_dkdv() {
  return (2 * kOwn + 4 * Shape<D>::kQueries) * D * (int)sizeof(T) +
         4 * Shape<D>::kQueries * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ch of row r: chunks XOR-swizzled by r mod 8,
// so the 8 rows an ldmatrix phase reads lie in 8 bank groups
__device__ __forceinline__ uint32_t swz(int r, int ch, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((ch ^ (r & 7)) << 4));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b on mma.sync.m16n8k16, bf16 in, fp32 accumulate. Fragments: a0
// (row r, columns 2q, 2q+1), a1 (row r+8, same), a2, a3 (columns +8); b0
// (rows 2q, 2q+1 of column r), b1 (rows +8); d0, d1 (row r, columns 2q,
// 2q+1), d2, d3 (row r+8), where r = lane / 4 and q = lane mod 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) as two bf16 terms: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the 16×16 A fragments (hi, lo) of k-step kk from accumulator tiles 2kk
// and 2kk + 1 (FA2: a 16×8 C fragment pair is a 16×16 A fragment)
template <int N>
__device__ __forceinline__ void a_frags(float (&c)[N][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// ROWS rows of one head from r0 (row s at src + s·stride) → a swizzled
// tile at dst; rows at or past S are zero-filled and read nothing
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, size_t stride, int r0,
                                          int S) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, ch = i - r * kChunks;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz(r, ch, D * 2), src + (size_t)(ok ? r0 + r : 0) * stride + 8 * ch, ok);
  }
}

// the two products of one step that contract over D, for a warp's 16 rows
// (own tiles A, A2 at row a0) against the N walked rows (tiles Bm, B2):
// s = A·Bmᵀ and t = A2·B2ᵀ
template <int D, int N>
__device__ __forceinline__ void dot2(float (&s)[N / 8][4], float (&t)[N / 8][4], uint32_t A,
                                     uint32_t A2, int a0, uint32_t Bm, uint32_t B2, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], a2[4];
    ldsm_x4(a, A + swz(a0 + ((mi & 1) << 3) + r8, 2 * kk + (mi >> 1), D * 2));
    ldsm_x4(a2, A2 + swz(a0 + ((mi & 1) << 3) + r8, 2 * kk + (mi >> 1), D * 2));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bm[4], b2[4];
      ldsm_x4(bm, Bm + swz(16 * np + ((mi >> 1) << 3) + r8, 2 * kk + (mi & 1), D * 2));
      ldsm_x4(b2, B2 + swz(16 * np + ((mi >> 1) << 3) + r8, 2 * kk + (mi & 1), D * 2));
      mma(s[2 * np], a, bm[0], bm[1]);
      mma(s[2 * np + 1], a, bm[2], bm[3]);
      mma(t[2 * np], a2, b2[0], b2[1]);
      mma(t[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc (16 rows × NA·8 columns from column c0) += X · M, X the k-steps of
// the accumulator tiles x (hi + lo), M rows = X's columns (by
// ldmatrix.trans from the walked tile at Mt)
template <int D, int NX, int NA>
__device__ __forceinline__ void acc_xm(float (&acc)[NA][4], float (&x)[NX][4],
                                       uint32_t Mt, int c0, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NX / 2; ++kk) {
    uint32_t hi[4], lo[4];
    a_frags(x, kk, hi, lo);
#pragma unroll
    for (int np = 0; np < NA / 2; ++np) {
      uint32_t m[4];
      ldsm_x4_trans(m, Mt + swz(16 * kk + ((mi & 1) << 3) + r8, c0 / 8 + 2 * np + (mi >> 1), D * 2));
      mma(acc[2 * np], hi, m[0], m[1]);
      mma(acc[2 * np + 1], hi, m[2], m[3]);
      mma(acc[2 * np], lo, m[0], m[1]);
      mma(acc[2 * np + 1], lo, m[2], m[3]);
    }
  }
}

// P and dS of one pair from its raw dot products in place: x = q·k (out:
// P), dp = dO·v (out: dS); scores in log2 units, lse2 = lse·log2(e)
__device__ __forceinline__ void p_ds(float& x, float& dp, float lse2, float delta, bool ok,
                                     float qk_scale, float cap) {
  float s = x * qk_scale, t = 0.f;
  if (cap > 0.f) {
    t = tanhf(s);
    s = t * cap;
  }
  x = ok ? exp2f(s - lse2) : 0.f;
  float ds = x * (dp - delta);
  if (cap > 0.f) ds *= 1.f - t * t;
  dp = ds;
}

template <int D>
__global__ void __launch_bounds__(32 * kGroups * Shape<D>::kSplit, 1) flash_prefill_bwd_dq_bf16_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int S, int Hq, int Hkv, int window,
    float qk_scale, float cap, float scale) {
  constexpr int kSplit = Shape<D>::kSplit, kThreads = 32 * kGroups * kSplit;
  constexpr int kDA = D / kSplit, kNA = kDA / 8, kNS = kKeys / 8;
  constexpr int kTile = kKeys * D * (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem), sdO = sQ + kOwn * D * 2;
  const uint32_t sKV = sdO + kOwn * D * 2;   // stage s: K at sKV + 2s·kTile, V after it
  float* sLse = reinterpret_cast<float*>(smem + (2 * kOwn + 4 * kKeys) * D * 2);
  float* sDelta = sLse + kOwn;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % kGroups, part = warp / kGroups;   // row group, column part
  const int g8 = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int q0 = qt * kOwn;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t qoff = ((size_t)b * S * Hq + h) * D;
  const T* kh = k + ((size_t)b * S * Hkv + g) * D;
  const T* vh = v + ((size_t)b * S * Hkv + g) * D;
  const size_t roff = ((size_t)b * Hq + h) * S;

  const int kt_hi = (min(q0 + kOwn, S) - 1) / kKeys;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kKeys : 0;

  load_tile<D, kOwn, kThreads>(sQ, q + qoff, q_stride, q0, S);
  load_tile<D, kOwn, kThreads>(sdO, dout + qoff, q_stride, q0, S);
  load_tile<D, kKeys, kThreads>(sKV, kh, kv_stride, kt_lo * kKeys, S);
  load_tile<D, kKeys, kThreads>(sKV + kTile, vh, kv_stride, kt_lo * kKeys, S);
  cp_async_commit();

  // Δ = rowsum(dO ∘ O) from device memory, a warp a row, while the tiles land
  for (int r = warp; r < kOwn; r += kThreads / 32) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const T* orow = out + qoff + (size_t)s * q_stride;
      const T* drow = dout + qoff + (size_t)s * q_stride;
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
        acc += a.x * d.x + a.y * d.y;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      sLse[r] = s < S ? lse[roff + s] * kLog2e : INFINITY;
      if (s < S) delta[roff + s] = acc;
    }
  }
  __syncthreads();
  const int wq0 = q0 + 16 * wr;   // this warp's first row
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = sLse[16 * wr + g8 + 8 * i];
    dl[i] = sDelta[16 * wr + g8 + 8 * i];
  }

  float acc[kNA][4];
#pragma unroll
  for (int n = 0; n < kNA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {   // the next tile into the other stage, in flight during this one
      const uint32_t nxt = sKV + (stage ^ 1) * 2 * kTile;
      load_tile<D, kKeys, kThreads>(nxt, kh, kv_stride, (kt + 1) * kKeys, S);
      load_tile<D, kKeys, kThreads>(nxt + kTile, vh, kv_stride, (kt + 1) * kKeys, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = kt * kKeys;
    const bool live = wq0 < S && k0 <= wq0 + 15 && (window <= 0 || wq0 - (k0 + kKeys - 1) < window);
    if (live) {
      const uint32_t sK = sKV + stage * 2 * kTile, sV = sK + kTile;
      float s[kNS][4], dp[kNS][4];
      dot2<D, kKeys>(s, dp, sQ, sdO, 16 * wr, sK, sV, lane);
      const bool edge = k0 + kKeys - 1 > wq0 || (window > 0 && wq0 + 15 - k0 >= window);
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1), qp = wq0 + g8 + 8 * (e >> 1);
          const bool ok = !edge || (kp <= qp && (window <= 0 || qp - kp < window));
          p_ds(s[j][e], dp[j][e], lse2[e >> 1], dl[e >> 1], ok, qk_scale, cap);
        }
      acc_xm<D, kNS, kNA>(acc, dp, sK, part * kDA, lane);   // dq += dS · K
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wq0 + g8 + 8 * i;
    if (qp >= S) continue;
    T* row = dq + qoff + (size_t)qp * q_stride + part * kDA + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNA; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kGroups * Shape<D>::kSplit, 1) flash_prefill_bwd_dkdv_bf16_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv, int window, float qk_scale,
    float cap, float scale) {
  constexpr int kSplit = Shape<D>::kSplit, kThreads = 32 * kGroups * kSplit;
  constexpr int kQT = Shape<D>::kQueries;
  constexpr int kDA = D / kSplit, kNA = kDA / 8, kNS = kQT / 8;
  constexpr int kTile = kQT * D * (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_addr(smem), sV = sK + kOwn * D * 2;
  const uint32_t sQD = sV + kOwn * D * 2;   // stage s: q at sQD + 2s·kTile, dO after it
  float* sLse = reinterpret_cast<float*>(smem + (2 * kOwn + 4 * kQT) * D * 2);   // [2][kQT]
  float* sDelta = sLse + 2 * kQT;                                                // [2][kQT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % kGroups, part = warp / kGroups;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kt = blockIdx.x;                   // early keys see the most rows: first
  const int g = blockIdx.y, b = blockIdx.z, qpk = Hq / Hkv;
  const int k0 = kt * kOwn;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t kvoff = ((size_t)b * S * Hkv + g) * D;

  // query tiles holding a row that sees one of keys k0 .. k0+63, for each
  // of the group's heads: step it is head it / nqt, tile qt_lo + it % nqt
  const int q_last = window > 0 ? min(S - 1, k0 + kOwn - 1 + window - 1) : S - 1;
  const int qt_lo = k0 / kQT, nqt = q_last / kQT - qt_lo + 1, steps = qpk * nqt;
  auto load_step = [&](int it, int stage) {
    const int h = g * qpk + it / nqt, q0 = (qt_lo + it % nqt) * kQT;
    const size_t qoff = ((size_t)b * S * Hq + h) * D, roff = ((size_t)b * Hq + h) * S;
    const uint32_t dst = sQD + stage * 2 * kTile;
    load_tile<D, kQT, kThreads>(dst, q + qoff, q_stride, q0, S);
    load_tile<D, kQT, kThreads>(dst + kTile, dout + qoff, q_stride, q0, S);
    for (int i = threadIdx.x; i < kQT; i += kThreads) {
      const bool in = q0 + i < S;
      sLse[stage * kQT + i] = in ? lse[roff + q0 + i] * kLog2e : INFINITY;
      sDelta[stage * kQT + i] = in ? delta[roff + q0 + i] : 0.f;
    }
  };
  load_tile<D, kOwn, kThreads>(sK, k + kvoff, kv_stride, k0, S);
  load_tile<D, kOwn, kThreads>(sV, v + kvoff, kv_stride, k0, S);
  load_step(0, 0);
  cp_async_commit();

  float ak[kNA][4], av[kNA][4];
#pragma unroll
  for (int n = 0; n < kNA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  const int kw0 = k0 + 16 * wr;   // this warp's first key

  for (int it = 0; it < steps; ++it) {
    const int stage = it & 1;
    if (it + 1 < steps) load_step(it + 1, stage ^ 1);   // in flight during this step
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = (qt_lo + it % nqt) * kQT;
    const bool live = kw0 < S && kw0 <= q0 + kQT - 1 && (window <= 0 || q0 - (kw0 + 15) < window);
    if (live) {
      const uint32_t sQ = sQD + stage * 2 * kTile, sdO = sQ + kTile;
      const float* lse2 = sLse + stage * kQT;
      const float* dl = sDelta + stage * kQT;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows keys, columns queries
      float s[kNS][4], dp[kNS][4];
      dot2<D, kQT>(s, dp, sK, sV, 16 * wr, sQ, sdO, lane);
      const bool edge = kw0 + 15 > q0 || (window > 0 && q0 + kQT - 1 - kw0 >= window);
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1), qp = q0 + c, kp = kw0 + g8 + 8 * (e >> 1);
          const bool ok = !edge || (kp <= qp && (window <= 0 || qp - kp < window));
          p_ds(s[j][e], dp[j][e], lse2[c], dl[c], ok, qk_scale, cap);
        }
      acc_xm<D, kNS, kNA>(av, s, sdO, part * kDA, lane);   // dv += Pᵀ · dO
      acc_xm<D, kNS, kNA>(ak, dp, sQ, part * kDA, lane);   // dk += dSᵀ · Q
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kw0 + g8 + 8 * i;
    if (kp >= S) continue;
    const size_t off = kvoff + (size_t)kp * kv_stride + part * kDA + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNA; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(ak[n][2 * i] * scale, ak[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(av[n][2 * i], av[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int Hq,
           int Hkv, int window, float softcap, cudaStream_t stream) {
  constexpr int kThreads = 32 * kGroups * Shape<D>::kSplit;
  constexpr int smem_q = smem_dq<D>(), smem_kv = smem_dkdv<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_dq_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  // scores into log2 units as the forward's: s·qk_scale, then tanh(·)·cap
  const float scale = 1.f / sqrtf((float)D);
  const float qk_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float cap = softcap > 0.f ? softcap * kLog2e : 0.f;
  const dim3 grid_dq((S + kOwn - 1) / kOwn, Hq, B);
  flash_prefill_bwd_dq_bf16_kernel<D><<<grid_dq, kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S,
      Hq, Hkv, window, qk_scale, cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((S + kOwn - 1) / kOwn, Hkv, B);
  flash_prefill_bwd_dkdv_bf16_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Hq,
      Hkv, window, qk_scale, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                 int B, int S, int Hq, int Hkv, int window, float softcap, cudaStream_t s) {
  if (dtype == 0)
    return f32::launch<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, Hq, Hkv, window,
                          softcap, s);
  if (dtype == 1)
    return bf16::launch<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, Hq, Hkv, window,
                           softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,S,Hq,D), k/v (B,S,Hkv,D), out and dout (B,S,Hq,D) in fp32 (dtype 0)
// or bf16 (dtype 1), lse (B,Hq,S) fp32 → dq, dk, dv in the inputs' shapes
// and dtype; delta (B,Hq,S) fp32 is scratch. All contiguous and 16-byte
// aligned; D ∈ {64, 128, 256}; Hq a multiple of Hkv; window >= 0 (0:
// none); softcap >= 0 (0: none). Checked by the wrapper; an out-of-range
// argument returns cudaErrorInvalidValue here. Two launches; returns
// cudaGetLastError().
extern "C" int flash_prefill_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int S,
                                        int Hq, int Hkv, int D, int window, int dtype,
                                        float softcap, void* stream) {
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || window < 0 || !(softcap >= 0.f) || B < 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 64)
    return launch_dtype<64>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Hq, Hkv, window,
                            softcap, s);
  if (D == 128)
    return launch_dtype<128>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Hq, Hkv,
                             window, softcap, s);
  if (D == 256)
    return launch_dtype<256>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Hq, Hkv,
                             window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
