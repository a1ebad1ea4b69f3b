// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd_intra_chunk_pallas, body _kernel). For each (batch b, chunk c, head
// h) over the chunk's Q tokens, with cum = inclusive cumsum of dt·A:
//   y_diag[i]  = sum_{j<=i} (C_i·B_j) · exp(cum_i - cum_j) · dt_j · x_j
//   states     = sum_j B_j ⊗ exp(cum_last - cum_j) · dt_j · x_j
//   decay      = exp(cum_last)
// B and C are shared across heads (G = 1). All arithmetic in fp32; x, B
// and C arrive in bf16 or fp32, dt and A in fp32.
//
// Masked before the exp. Above the diagonal cum_i - cum_j is positive, and
// once a chunk's summed decay passes ~88 exp() overflows to inf. The TPU
// kernel multiplies exp(li) by the triangular mask (kernel.py:48), so
// inf·0 gives NaN there; this kernel never evaluates exp for j > i and
// writes 0 instead, as the plain formulation (src/repro/models/ssm.py:133)
// does with where().
//
// Bound on the card, at chip_smoke.py's batched shape (B 8, S 512, nc 4,
// H 64, P 64, N 128, Q 128, bf16 x/B/C): bytes, each input read once and
// each output written once, ~171 MB (x 33.6 MB + dt 1.0 MB + B/C 2.1 MB
// read; y 67.1 MB + states 67.1 MB written) → ~0.051 ms at 3.35 TB/s;
// operations B·nc·(2Q²N + H·(2Q²P + 2QNP)) ≈ 8.7 GFLOP → ~0.009 ms at the
// bf16 tensor-core peak (989 TFLOP/s), so bytes bound it. This simple
// kernel does its arithmetic in fp32 on the CUDA cores, whose 67 TFLOP/s
// put its own floor at ~0.13 ms; mma.sync/wgmma and TMA are later work.
// No single PyTorch call computes this function, so chip_smoke.py reports
// library_ms as null.
//
// Design. One block of 256 threads per (chunk, block of 8 heads, batch).
// The block loads the chunk's B and C once into shared memory (fp32, rows
// padded to N+1 floats so column walks hit distinct banks) and computes
// scores = C·Bᵀ (Q×Q) once, each thread an 8×8 register tile, because
// G = 1 shares it across the heads. Then, for each head: x (Q×P) and dt
// into shared memory; one warp scans dt·A (each lane 4 entries, then a
// shuffle scan); the chunk state with lanes along P and warps along N;
// y_diag in row tiles of 64, each tile first building its masked decay
// matrix M[i][j] = scores·exp(cum_i - cum_j)·dt_j (j <= i, else 0) in
// shared memory so every exp is taken once, then y = M·x with lanes along
// P and warps along rows. Shared memory at Q = N = 128, P = 64: 199,168
// bytes, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadBlock = 8;   // heads per block (the TPU kernel's head_block)
constexpr int kRowTile = 64;    // rows of M built at a time
// limits of the thread tiles below: scores 16×8 rows and columns, the scan
// 32 lanes × 4, states 8 warps × 16 rows of N and 2 × 32 columns of P
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// floats of dynamic shared memory for a (Q, N, P) launch
__host__ __device__ __forceinline__ int union_floats(int Q, int N, int P) {
  const int c = Q * (N + 1), xm = Q * P + kRowTile * Q;
  return c > xm ? c : xm;
}
__host__ __device__ __forceinline__ int smem_floats(int Q, int N, int P) {
  return Q * Q + Q * (N + 1) + union_floats(Q, N, P) + 3 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ states, float* __restrict__ decay, int S, int H, int P, int N,
    int Q) {
  extern __shared__ float smem[];
  const int NP1 = N + 1;
  float* sS = smem;                  // Q×Q scores C·Bᵀ
  float* sB = sS + Q * Q;            // Q×(N+1) B rows
  float* sU = sB + Q * NP1;          // C rows, then per head x and M
  float* sC = sU;                    // Q×(N+1), until the scores are built
  float* sX = sU;                    // Q×P x of one head
  float* sM = sU + Q * P;            // ≤ kRowTile×Q masked decay rows
  float* sCum = sU + union_floats(Q, N, P);
  float* sDt = sCum + Q;
  float* sW = sDt + Q;               // exp(cum_last - cum_j)·dt_j

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const size_t row0 = (size_t)b * S + (size_t)c * Q;   // first token of the chunk

  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int j = idx / N, n = idx - j * N;
    sB[j * NP1 + n] = to_f32(Bm[(row0 + j) * N + n]);
    sC[j * NP1 + n] = to_f32(Cm[(row0 + j) * N + n]);
  }
  __syncthreads();

  {  // scores[i][j] = C_i · B_j, rows ti + 16r, columns tj + 16s
    const int ti = tid >> 4, tj = tid & 15;
    int crow[8], brow[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      crow[r] = min(ti + 16 * r, Q - 1) * NP1;
      brow[r] = min(tj + 16 * r, Q - 1) * NP1;
    }
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        cv[r] = sC[crow[r] + n];
        bv[r] = sB[brow[r] + n];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int i = ti + 16 * r, j = tj + 16 * s;
        if (i < Q && j < Q) sS[i * Q + j] = acc[r][s];
      }
  }
  __syncthreads();   // scores built; sC's space is free for x and M

  for (int hh = 0; hh < kHeadBlock; ++hh) {
    const int h = blockIdx.y * kHeadBlock + hh;
    if (h >= H) break;   // uniform across the block

    for (int j = tid; j < Q; j += kThreads) sDt[j] = dt[(row0 + j) * H + h];
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      sX[idx] = to_f32(x[((row0 + j) * H + h) * P + p]);
    }
    __syncthreads();

    if (warp == 0) {   // inclusive scan of dt·A over the chunk
      const float a = A[h];
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane * 4 + k;
        run += (j < Q) ? sDt[j] * a : 0.f;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
      const float excl = tot - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane * 4 + k;
        if (j < Q) sCum[j] = excl + v[k];
      }
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) sW[j] = expf(cum_last - sCum[j]) * sDt[j];
    if (tid == 0) decay[((size_t)b * nc + c) * H + h] = expf(cum_last);
    __syncthreads();

    {  // states[n][p] = sum_j B[j][n] · w_j · x[j][p]; rows warp + 8r, columns lane + 32k
      float acc[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
      const int p0 = min(lane, P - 1), p1 = min(lane + 32, P - 1);
      for (int j = 0; j < Q; ++j) {
        const float w = sW[j];
        const float x0 = sX[j * P + p0] * w, x1 = sX[j * P + p1] * w;
        const float* brow = sB + j * NP1;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float bv = brow[min(warp + kWarps * r, N - 1)];
          acc[r][0] = fmaf(bv, x0, acc[r][0]);
          acc[r][1] = fmaf(bv, x1, acc[r][1]);
        }
      }
      float* out = states + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int n = warp + kWarps * r;
        if (n < N) {
          if (lane < P) out[(size_t)n * P + lane] = acc[r][0];
          if (lane + 32 < P) out[(size_t)n * P + lane + 32] = acc[r][1];
        }
      }
    }

    for (int i0 = 0; i0 < Q; i0 += kRowTile) {
      const int rows = min(kRowTile, Q - i0);
      const int jn = i0 + rows;   // columns j <= i < i0 + rows
      for (int idx = tid; idx < rows * jn; idx += kThreads) {
        const int ii = idx / jn, j = idx - ii * jn, i = i0 + ii;
        // j > i is never exponentiated: its cum_i - cum_j may overflow exp
        sM[idx] = (j <= i) ? sS[i * Q + j] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
      }
      __syncthreads();

      // y[i][p] = sum_j M[i][j] · x[j][p]; rows warp + 8r, columns lane + 32k
      float acc[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.f;
      const int p0 = min(lane, P - 1), p1 = min(lane + 32, P - 1);
      for (int j = 0; j < jn; ++j) {
        const float x0 = sX[j * P + p0], x1 = sX[j * P + p1];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float m = sM[min(warp + kWarps * r, rows - 1) * jn + j];
          acc[r][0] = fmaf(m, x0, acc[r][0]);
          acc[r][1] = fmaf(m, x1, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int ii = warp + kWarps * r;
        if (ii < rows) {
          float* out = y + ((row0 + i0 + ii) * H + h) * (size_t)P;
          if (lane < P) out[lane] = acc[r][0];
          if (lane + 32 < P) out[lane + 32] = acc[r][1];
        }
      }
      __syncthreads();   // M and x are rewritten by the next tile or head
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* states, void* decay, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int smem = smem_floats(Q, N, P) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / Q, (H + kHeadBlock - 1) / kHeadBlock, B);
  ssd_intra_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P), Bm/Cm (B,S,N) in fp32 (dtype 0) or bf16 (dtype 1); dt (B,S,H)
// and A (H,) fp32 → y (B,S,H,P), states (B,S/Q,H,N,P), decay (B,S/Q,H) fp32.
// All contiguous; S % Q == 0, Q <= 128, N <= 128, P <= 64 (checked by the
// wrapper; an out-of-range shape returns cudaErrorInvalidValue here).
// Returns cudaGetLastError().
extern "C" int ssd_intra_chunk_launch(const void* x, const void* dt, const void* A,
                                      const void* Bm, const void* Cm, void* y, void* states,
                                      void* decay, int B, int S, int H, int P, int N, int Q,
                                      int dtype, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, y, states, decay, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, states, decay, B, S, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
