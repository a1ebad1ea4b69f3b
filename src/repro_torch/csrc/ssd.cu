// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py
// (ssd_intra_chunk_pallas, body _kernel). For each (batch b, chunk c, head
// h) over the chunk's Q tokens, with cum = inclusive cumsum of dt·A:
//   y_diag[i]  = sum_{j<=i} (C_i·B_j) · exp(cum_i - cum_j) · dt_j · x_j
//   states     = sum_j B_j ⊗ exp(cum_last - cum_j) · dt_j · x_j
//   decay      = exp(cum_last)
// B and C are shared across heads (G = 1). x, B and C arrive in bf16 or
// fp32, dt and A in fp32; the outputs are fp32.
//
// Masked before the exp. Above the diagonal cum_i - cum_j is positive, and
// once a chunk's summed decay passes ~88 exp() overflows to inf. The TPU
// kernel multiplies exp(li) by the triangular mask (kernel.py:48), so
// inf·0 gives NaN there. Neither kernel here exponentiates j > i: the
// fp32 kernel writes 0 without an exp, the bf16 kernel exponentiates -inf
// there; both follow the plain formulation (src/repro/models/ssm.py:133),
// which masks with where().
//
// Bound on the card, at chip_smoke.py's batched shape (B 8, S 512, nc 4,
// H 64, P 64, N 128, Q 128, bf16 x/B/C): bytes, each input read once and
// each output written once, ~171 MB (x 33.6 MB + dt 1.0 MB + B/C 2.1 MB
// read; y 67.1 MB + states 67.1 MB written) → ~0.051 ms at 3.35 TB/s;
// operations B·nc·(2Q²N + H·(2Q²P + 2QNP)) ≈ 8.7 GFLOP → ~0.009 ms at the
// bf16 tensor-core peak (989 TFLOP/s), so the fp32 writes bound it. No
// single PyTorch call computes this function, so chip_smoke.py reports
// library_ms as null. On an H100 80GB HBM3 at 700 W (PERF.md) the bf16
// kernel takes ~0.088 ms there, 1.7× the bound; the CUDA-core kernel
// below, which ran bf16 before this design, takes 0.72 ms.
//
// bf16 (tc::ssd_intra_chunk_bf16_kernel): the products on the tensor cores,
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One block of 8 warps per
// (chunk, block of kHeads = 8 heads, batch).
//   - Prologue: the chunk's B and C (bf16, rows swizzled by 16-byte chunk
//     so ldmatrix reads are conflict-free) and head 0's x by cp.async; the
//     block's dt. A warp per head scans dt·A (4 entries a lane and a
//     shuffle scan), all heads before the head loop, and writes cum, w_j
//     = exp(cum_last - cum_j)·dt_j and the chunk decay.
//   - scores = C·Bᵀ once per block (G = 1 shares it across heads), only
//     the 36 lower-triangle 16×16 tiles, spread over the warps, kept in
//     shared memory as each tile's accumulator fragments (36 KB, in C's
//     place), so a warp reads them back in the layout it multiplies from.
//   - Per head, while the next head's x lands in the other stage of a
//     two-stage cp.async ring, the warps split in two groups of four:
//     y = M·x (warps 0-3), M[i][j] = scores·exp(cum_i - cum_j)·dt_j for
//       j <= i, built in registers from the score fragments (FA2-style:
//       two 16×8 C tiles are one 16×16 A fragment) and split into two bf16
//       terms, hi = bf16(v) and lo = bf16(v - hi); no Q×Q array. Below the
//       diagonal tile exp(cum_i - cum_j) = exp(cum_i - cum_s)·exp(cum_s -
//       cum_j), cum_s at the strip's first row, so an exp is taken per row
//       and per column, not per element. Causal balance: warp w takes row
//       strips w and 7 - w, 9 column tiles together, over all of P.
//     states = Bᵀ·(diag(w)·x) (warps 4-7), two 16-row tiles of N a warp at
//       once so each x fragment feeds both: A = Bᵀ by ldmatrix.trans from
//       B, scaled by w and split into hi + lo in registers; x by
//       ldmatrix.trans is exact in bf16.
//   - Stores: float2 straight from the accumulator fragments: a quad of
//     lanes writes one full 32-byte sector of a row.
//   Two bf16 terms keep M and Bᵀ·diag(w) to ~2^-17 relative, inside the
//   fp32 tolerance of chip_smoke.py; one term misses it (kMTerms, kWTerms;
//   kernels/ssd/variants.py prices each choice). Every shape the wrapper
//   takes runs here: tiles are zero-filled past Q, N and P in shared
//   memory, and rows whose length is not a multiple of 16 bytes (N or P
//   not a multiple of 8) are loaded element by element instead of by
//   cp.async.
//   Shared memory: 32 KB B + 36 KB scores/C + 2 × 16 KB x + 12 KB cum, dt
//   and w = 114,688 B, so two blocks (16 warps) share an SM; the launch
//   bounds hold registers to 128 a thread for that.
//
// fp32 (cc::ssd_intra_chunk_kernel): the first port's CUDA-core kernel,
// kept for fp32 inputs (fp32 teacher forcing, the fp32 sweeps), which bf16
// tensor-core inputs would round. One block of 256 threads per (chunk,
// block of 8 heads, batch). The block loads the chunk's B and C once into
// shared memory (fp32, rows padded to N+1 floats so column walks hit
// distinct banks) and computes scores = C·Bᵀ (Q×Q) once, each thread an
// 8×8 register tile. Then, for each head: x (Q×P) and dt into shared
// memory; one warp scans dt·A; the chunk state with lanes along P and
// warps along N; y_diag in row tiles of 64, each tile first building its
// masked decay matrix in shared memory so every exp is taken once, then
// y = M·x with lanes along P and warps along rows. Shared memory at
// Q = N = 128, P = 64: 199,168 bytes, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// limits of the tiles below: rows of a chunk, columns of B/C and of x
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadBlock = 8;   // heads per block (the TPU kernel's head_block)
constexpr int kRowTile = 64;    // rows of M built at a time

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


}  // namespace cc

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 8;      // heads per block: C·Bᵀ is built once for them
constexpr int kMTerms = 2;     // bf16 terms of M in M·x: hi, or hi + lo
constexpr int kWTerms = 2;     // bf16 terms of Bᵀ·diag(w) in the states
constexpr int kStrips = kMaxQ / 16;                    // 16-row strips of a chunk
constexpr int kTiles = kStrips * (kStrips + 1) / 2;    // lower-triangle 16×16 tiles
constexpr int kRowBC = kMaxN * 2;                      // bytes of a B or C row
constexpr int kRowX = kMaxP * 2;                       // bytes of an x row
constexpr int kBytesBC = kMaxQ * kRowBC;
constexpr int kBytesS = kTiles * 256 * 4;              // a tile's fragments: 256 floats
constexpr int kBytesU = kBytesS > kBytesBC ? kBytesS : kBytesBC;
constexpr int kBytesX = kMaxQ * kRowX;
// B | C, then the scores | x, two stages | cum, dt and w of the block's heads
constexpr int kOffU = kBytesBC;
constexpr int kOffX = kOffU + kBytesU;
constexpr int kOffCum = kOffX + 2 * kBytesX;
constexpr int kOffDt = kOffCum + kHeads * kMaxQ * 4;
constexpr int kOffW = kOffDt + kHeads * kMaxQ * 4;
constexpr int kSmem = kOffW + kHeads * kMaxQ * 4;
constexpr int kYWarps = kWarps / 2;   // warps on y; the others build the states
constexpr int kStateTiles = 2;        // 16-row tiles of N a states warp builds at once
constexpr int kPerWarp = (kTiles + kWarps - 1) / kWarps;   // score tiles a warp builds

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

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as two bf16 terms: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// rows × cols of bf16 (row stride ld elements) into a swizzled tile of
// row_bytes a row; rows < fill_rows and chunks < fill_ch are written, with
// zeros past rows × cols. vec: cp.async by 16 bytes (cols % 8 == 0 and
// 16-byte aligned rows), else element by element.
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* __restrict__ src,
                                          size_t ld, int rows, int cols, int fill_rows,
                                          int fill_ch, int row_bytes, bool vec) {
  if (vec) {
    const uint32_t base = smem_addr(tile);
    for (int i = threadIdx.x; i < fill_rows * fill_ch; i += kThreads) {
      const int r = i / fill_ch, ch = i - r * fill_ch;
      const bool ok = r < rows && 8 * ch < cols;
      cp_async16(base + swz(r, ch, row_bytes), ok ? src + r * ld + 8 * ch : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < fill_rows * fill_ch * 8; i += kThreads) {
      const int r = i / (fill_ch * 8), c = i - r * fill_ch * 8;
      const bf16 v = (r < rows && c < cols) ? src[r * ld + c] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(tile + swz(r, c >> 3, row_bytes) + 2 * (c & 7)) = v;
    }
  }
}

// a pair of fp32 outputs of one row; 8-byte stores where P is even
__device__ __forceinline__ void store2(float* __restrict__ out, int p, int P, float v0,
                                       float v1) {
  if ((P & 1) == 0 && p + 1 < P) {
    *reinterpret_cast<float2*>(out + p) = make_float2(v0, v1);
  } else {
    if (p < P) out[p] = v0;
    if (p + 1 < P) out[p + 1] = v1;
  }
}

// grid (S/Q, ceil(H/kHeads), B), kThreads threads, kSmem bytes of dynamic
// shared memory. vec_x / vec_bc: the rows of x / of B and C take cp.async.
__global__ void __launch_bounds__(kThreads, 2) ssd_intra_chunk_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ states, float* __restrict__ decay, int S, int H, int P, int N, int Q,
    int vec_x, int vec_bc) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sB = smem;
  unsigned char* sC = smem + kOffU;              // until the scores are built
  float* sS = reinterpret_cast<float*>(smem + kOffU);
  float* sCum = reinterpret_cast<float*>(smem + kOffCum);   // [kHeads][kMaxQ]
  float* sDt = reinterpret_cast<float*>(smem + kOffDt);     // [kHeads][kMaxQ]
  float* sW = reinterpret_cast<float*>(smem + kOffW);       // [kHeads][kMaxQ]
  const uint32_t sB_s = smem_addr(sB), sC_s = smem_addr(sC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, q = lane & 3;            // fragment row, lane in the quad
  const int mi = lane >> 3, r8 = lane & 7;          // ldmatrix: matrix, row
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int h0 = blockIdx.y * kHeads, nh = min(kHeads, H - h0);
  const size_t row0 = (size_t)b * S + (size_t)c * Q;   // first token of the chunk
  const int Qp = (Q + 15) & ~15, Np = (N + 15) & ~15, Pp = (P + 15) & ~15;
  const int nq = Qp / 16, nn = Np / 16, np = Pp / 16;

  auto load_x = [&](int hh) {
    load_tile(smem + kOffX + (hh & 1) * kBytesX, x + (row0 * H + h0 + hh) * P,
              (size_t)H * P, Q, P, Qp, Pp / 8, kRowX, vec_x);
  };
  load_tile(sB, Bm + row0 * N, N, Q, N, Qp, Np / 8, kRowBC, vec_bc);
  load_tile(sC, Cm + row0 * N, N, Q, N, Qp, Np / 8, kRowBC, vec_bc);
  cp_async_commit();
  load_x(0);
  cp_async_commit();
  // dt of every head of the block, the heads of a token side by side as
  // they lie in dt; zeros past Q keep cum flat there
  for (int i = tid; i < kHeads * kMaxQ; i += kThreads) {
    const int j = i / kHeads, hh = i - j * kHeads;
    sDt[hh * kMaxQ + j] = (j < Q && hh < nh) ? dt[(row0 + j) * H + h0 + hh] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // cum = inclusive scan of dt·A and w_j = exp(cum_last - cum_j)·dt_j, a warp
  // per head, all heads before the loop
  for (int hh = warp; hh < nh; hh += kWarps) {
    const float a = A[h0 + hh];
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += sDt[hh * kMaxQ + 4 * lane + k] * a;
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
    for (int k = 0; k < 4; ++k) sCum[hh * kMaxQ + 4 * lane + k] = excl + v[k];
    __syncwarp();
    const float cum_last = sCum[hh * kMaxQ + Q - 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = hh * kMaxQ + 4 * lane + k;
      sW[j] = __expf(cum_last - sCum[j]) * sDt[j];
    }
    if (lane == 0) decay[((size_t)b * nc + c) * H + h0 + hh] = expf(cum_last);
  }

  // scores = C·Bᵀ for the lower-triangle tiles (strip i, column tile j <= i),
  // tile t = i(i+1)/2 + j taken by warp t mod kWarps, into registers
  float sc[kPerWarp][2][4];
  int ti[kPerWarp], tj[kPerWarp];   // the tile's strip and column tile; ti -1: none
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[k][u][e] = 0.f;
    const int t = warp + k * kWarps;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    ti[k] = t < kTiles && i < nq ? i : -1;
    tj[k] = t - i * (i + 1) / 2;
  }
  for (int kk = 0; kk < nn; ++kk) {   // the warp's tiles side by side: independent chains
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) {
      if (ti[k] >= 0) {
        uint32_t cf[4], bf[4];
        ldsm_x4(cf, sC_s + swz(16 * ti[k] + ((mi & 1) << 3) + r8, 2 * kk + (mi >> 1), kRowBC));
        ldsm_x4(bf, sB_s + swz(16 * tj[k] + ((mi >> 1) << 3) + r8, 2 * kk + (mi & 1), kRowBC));
        mma(sc[k][0], cf, bf[0], bf[1]);
        mma(sc[k][1], cf, bf[2], bf[3]);
      }
    }
  }
  __syncthreads();   // every read of C is done: the scores take its place
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
    const int t = warp + k * kWarps;
    if (t < kTiles) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float4*>(sS + t * 256 + u * 128 + 4 * lane) =
            make_float4(sc[k][u][0], sc[k][u][1], sc[k][u][2], sc[k][u][3]);
    }
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (hh + 1 < nh) {   // the next head's x lands while this one computes
      load_x(hh + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sX_s = smem_addr(smem + kOffX + (hh & 1) * kBytesX);
    const float* cum = sCum + hh * kMaxQ;
    const float* dth = sDt + hh * kMaxQ;
    const float* wh = sW + hh * kMaxQ;

    if (warp < kYWarps) {
      // y[i][p] = sum_{j<=i} M[i][j]·x[j][p], M[i][j] = scores·exp(cum_i - cum_j)·dt_j,
      // built in registers from the score tiles. A warp takes row strips pair
      // and kStrips-1-pair (kStrips+1 column tiles together, so every warp
      // does the same work) over all of P.
      for (int pair = warp; pair < kStrips / 2; pair += kYWarps) {
#pragma unroll 1
        for (int which = 0; which < 2; ++which) {
          const int s = which ? kStrips - 1 - pair : pair;
          if (s >= nq) continue;
          float acc[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          const int ir[2] = {16 * s + r, 16 * s + r + 8};
          const float cs = cum[16 * s];   // cum at the strip's first row
          const float ci[2] = {cum[ir[0]], cum[ir[1]]};
          // below the diagonal tile, exp(cum_i - cum_j) = exp(cum_i - cs) ·
          // exp(cs - cum_j): both arguments <= 0 where cum falls
          const float ai[2] = {__expf(ci[0] - cs), __expf(ci[1] - cs)};
          for (int jt = 0; jt <= s; ++jt) {
            const int t = s * (s + 1) / 2 + jt;
            float sv[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float4 f = *reinterpret_cast<const float4*>(sS + t * 256 + u * 128 + 4 * lane);
              sv[u][0] = f.x;
              sv[u][1] = f.y;
              sv[u][2] = f.z;
              sv[u][3] = f.w;
            }
            uint32_t mh[4], ml[4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int j = 16 * jt + 8 * u + 2 * q;
              const float2 cj = *reinterpret_cast<const float2*>(cum + j);
              const float2 dj = *reinterpret_cast<const float2*>(dth + j);
              float m[2][2];
              if (jt < s) {
                const float bj[2] = {__expf(cs - cj.x) * dj.x, __expf(cs - cj.y) * dj.y};
#pragma unroll
                for (int half = 0; half < 2; ++half)
#pragma unroll
                  for (int e = 0; e < 2; ++e) m[half][e] = sv[u][2 * half + e] * ai[half] * bj[e];
              } else {
                // the diagonal tile, masked before the exp: j > i is never
                // exponentiated (nor a row past Q)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const bool in = ir[half] < Q;
                  const float e0 = __expf(in && j <= ir[half] ? ci[half] - cj.x : -INFINITY);
                  const float e1 = __expf(in && j + 1 <= ir[half] ? ci[half] - cj.y : -INFINITY);
                  m[half][0] = sv[u][2 * half] * e0 * dj.x;
                  m[half][1] = sv[u][2 * half + 1] * e1 * dj.y;
                }
              }
#pragma unroll
              for (int half = 0; half < 2; ++half)
                split(m[half][0], m[half][1], mh[2 * u + half], ml[2 * u + half]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (u < np) {
                uint32_t xf[4];
                ldsm_x4_trans(xf, sX_s + swz(16 * jt + ((mi & 1) << 3) + r8, 2 * u + (mi >> 1), kRowX));
                mma(acc[2 * u], mh, xf[0], xf[1]);
                mma(acc[2 * u + 1], mh, xf[2], xf[3]);
                if constexpr (kMTerms == 2) {
                  mma(acc[2 * u], ml, xf[0], xf[1]);
                  mma(acc[2 * u + 1], ml, xf[2], xf[3]);
                }
              }
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (ir[half] < Q) {
              float* out = y + ((row0 + ir[half]) * H + h) * (size_t)P;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                if (8 * nt < P)
                  store2(out, 8 * nt + 2 * q, P, acc[nt][2 * half], acc[nt][2 * half + 1]);
            }
          }
        }
      }
    } else {
      // states[n][p] = sum_j B[j][n]·w_j·x[j][p]: A = Bᵀ·diag(w) by
      // ldmatrix.trans from B, scaled and split in registers; B = x by
      // ldmatrix.trans, each x fragment used for kStateTiles 16-row tiles of N.
      constexpr int kT = kStateTiles;
      for (int mt0 = (warp - kYWarps) * kT; mt0 < nn; mt0 += (kWarps - kYWarps) * kT) {
        float acc[kT][8][4];
#pragma unroll
        for (int m = 0; m < kT; ++m)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
        for (int kt = 0; kt < nq; ++kt) {
          const int j = 16 * kt + 2 * q;
          const float2 w0 = *reinterpret_cast<const float2*>(wh + j);
          const float2 w8 = *reinterpret_cast<const float2*>(wh + j + 8);
          uint32_t ah[kT][4], al[kT][4];
#pragma unroll
          for (int m = 0; m < kT; ++m) {
            uint32_t bt[4];
            ldsm_x4_trans(bt, sB_s + swz(16 * kt + ((mi >> 1) << 3) + r8,
                                         2 * min(mt0 + m, nn - 1) + (mi & 1), kRowBC));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bt[e]));
              const float2 w = e < 2 ? w0 : w8;
              split(f.x * w.x, f.y * w.y, ah[m][e], al[m][e]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u < np) {
              uint32_t xf[4];
              ldsm_x4_trans(xf, sX_s + swz(16 * kt + ((mi & 1) << 3) + r8, 2 * u + (mi >> 1), kRowX));
#pragma unroll
              for (int m = 0; m < kT; ++m) {
                mma(acc[m][2 * u], ah[m], xf[0], xf[1]);
                mma(acc[m][2 * u + 1], ah[m], xf[2], xf[3]);
              }
              if constexpr (kWTerms == 2) {
#pragma unroll
                for (int m = 0; m < kT; ++m) {
                  mma(acc[m][2 * u], al[m], xf[0], xf[1]);
                  mma(acc[m][2 * u + 1], al[m], xf[2], xf[3]);
                }
              }
            }
          }
        }
        float* out = states + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
#pragma unroll
        for (int m = 0; m < kT; ++m) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 16 * (mt0 + m) + r + 8 * half;
            if (n < N) {
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                if (8 * nt < P)
                  store2(out + (size_t)n * P, 8 * nt + 2 * q, P, acc[m][nt][2 * half],
                         acc[m][nt][2 * half + 1]);
            }
          }
        }
      }
    }
    __syncthreads();   // x's stage is refilled two heads on
  }
}

int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* states, void* decay, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  auto kernel = ssd_intra_chunk_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_x = P % 8 == 0 && aligned(x);
  const int vec_bc = N % 8 == 0 && aligned(Bm) && aligned(Cm);
  const dim3 grid(S / Q, (H + kHeads - 1) / kHeads, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, P, N, Q, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

int blocks_per_sm() {
  auto kernel = ssd_intra_chunk_bf16_kernel;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, kSmem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace tc

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
  if (dtype == 0)
    return cc::launch<float>(x, dt, A, Bm, Cm, y, states, decay, B, S, H, P, N, Q, s);
  if (dtype == 1) return tc::launch(x, dt, A, Bm, Cm, y, states, decay, B, S, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

// blocks of the bf16 kernel that fit one SM at once (its shared memory and
// registers), or -(CUDA error)
extern "C" int ssd_intra_chunk_bf16_blocks_per_sm() { return tc::blocks_per_sm(); }
