// Causal flash prefill attention for Hopper (sm_90a): GQA, an optional
// sliding window and an optional tanh softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (flash_prefill_pallas, body _kernel). For query row i of head h at
// positions 0..S-1, with g = h / (Hq/Hkv) its KV head:
//   s_ij = softcap(q_i·k_j / sqrt(D)),  valid iff j <= i and i - j < window
//   out_i = sum_j softmax_j(s_ij) · v_j
// softcap(x) = tanh(x / c)·c when c > 0; window 0 means none. q, k, v
// arrive in bf16 or fp32; scores, softmax state and the accumulator are
// fp32; out has q's dtype.
//
// Bound on the card: operations, 4·D·Hq per unmasked (query, key) pair
// (QKᵀ and P·V, a multiply and an add each) at the bf16 tensor-core peak
// (989 TFLOP/s), against q, k, v and out read or written once at 3.35
// TB/s. At gemma3's global layer (B 1, S 4096, Hq/Hkv 16/8, D 256) that
// is 137.5 GFLOP → 0.139 ms against 100.7 MB → 0.030 ms; a 1024-token
// window cuts the pairs to 0.44 of that.
//
// Given a non-null lse (the training forward, ops.FlashPrefillFn), both
// kernels also write each row's log-sum-exp of its capped, masked, scaled
// scores in natural-log units, fp32 (B, Hq, S): the saved statistic of
// the backward kernel (flash_prefill_bwd.cu). The serving prefill passes
// null and writes nothing more.
//
// bf16: tensor cores (flash_prefill_bf16_kernel). One block per (query
// tile, query head, batch), the tiles with the most keys launched first;
// a warpgroup (4 warps) owns 64 query rows, a warp 16 of them. At D 256 a
// block holds two warpgroups, which share every K/V tile: the same 64
// positions of the two query heads of a KV group where Hq/Hkv is even
// (their rows see the same keys, so neither idles on the diagonal tile),
// else 128 positions of one head.
// q, K and V stay bf16 in shared memory, in the 128-byte-swizzled layout
// that wgmma's descriptors read without bank conflicts. The block walks
// 64-key tiles from the first one that reaches into the window to the one
// holding the diagonal (tiles entirely above the diagonal or below the
// window are never loaded), with a ring of two K/V stages: cp.async brings
// tile t+1 (rows past S zero-filled) while the warpgroups compute on tile
// t. Per tile a warpgroup runs S = q·Kᵀ as wgmma m64n64k16 with both
// operands in shared memory (fp32 accumulate), evaluates the causal/window
// mask only where the tile crosses the diagonal or the window's lower
// edge for a warp's rows, and keeps the online softmax (m, l) of its rows
// on the accumulator fragments: the four lanes that share a row reduce by
// shuffles, l is summed per lane and across the quad once at the end; O is
// rescaled only when a row's max grows by more than 2^8 (p stays below
// 2^8). P stays in registers as two bf16 terms, hi = bf16(p) and lo =
// bf16(p - hi), the A operands of P·V (wgmma m64nDk16, V from shared
// memory). One bf16 term rounds each weight by up to 2^-8 of itself and
// misses the checks' bf16 tolerance (atol 2e-3, rtol 1e-2 against the
// fp32 plain version) in rows with few keys, whether l sums the rounded
// weights or the fp32 ones. kernels/flash_prefill/variants.py times each
// of these three choices against its simpler alternative.
// A warpgroup whose rows see no key of a tile skips it. A row that has
// seen no valid key keeps m = -inf, p = 0 and α = 1; a row with l = 0 at
// the end writes zeros; rows at or past S are never written.
//
//   D    warps  query rows  shared memory (q + 2 stages of K, V)  O accumulator
//   64     4       64        41,984 bytes (3 blocks an SM)          32 fp32/thread
//   128    4       64        82,944 bytes (2 blocks an SM)          64 fp32/thread
//   256    8      128       197,632 bytes (1 block an SM)          128 fp32/thread
//
// plus 32 fp32 of scores and 32 registers of P (hi, lo) a thread. The
// launch bounds let a thread use 170 registers at D 64 and 255 at D 128
// and 256; ptxas's report (phase 1 of chip_smoke.py, which fails on a
// spill) gives the counts. TMA loads from a producer warp, and running one
// warpgroup's softmax while the other's wgmma runs, are later work.
//
// fp32: CUDA cores (flash_prefill_f32_kernel), kept for its accuracy: the
// fp32 teacher-forcing check and the card tests hold it at 5e-5, which
// TF32 tensor cores (about three decimal digits) would miss. One block of
// 256 threads per (64-query tile, query head, batch); q, K, V and P in
// fp32 shared memory (216,064 bytes at D = 256, 117,760 at 128, 68,608 at
// 64); each thread computes a 4×4 block of scores with float4 reads and
// keeps 4 rows × D/16 columns of the accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // query rows per block
constexpr int kBK = 64;    // keys per tile
constexpr int kPad = 4;    // floats of padding per row of q, K and P (float4-aligned)
constexpr int kLDP = kBK + kPad;
static_assert(kBQ == kBK, "load_rows stages 64-row tiles of q, K and V alike");

__host__ __device__ constexpr int smem_floats(int D) {
  return kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D + kBQ * kLDP;
}

// Rows r0 .. r0+63 of one head (row s at src + s·stride) → dst (row
// stride ld floats); rows at or past S are written as zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, size_t stride,
                                          int r0, int S) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow, c = (idx - row * kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S) val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * stride + c);
    *reinterpret_cast<float4*>(dst + row * ld + c) = val;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int S, int Hq, int Hkv, int window,
    float softcap, float scale) {
  constexpr int kLD = D + kPad;   // row stride of the q and K tiles
  constexpr int kNJ = D / 64;     // float4 column groups per thread in P·V
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBQ × kLD
  float* sK = sQ + kBQ * kLD;                    // kBK × kLD
  float* sV = sK + kBK * kLD;                    // kBK × D
  float* sP = sV + kBK * D;                      // kBQ × kLDP

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);                  // GQA: query head → KV head
  const int q0 = qt * kBQ;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const float* qh = q + ((size_t)b * S * Hq + h) * D;
  const float* kh = k + ((size_t)b * S * Hkv + g) * D;
  const float* vh = v + ((size_t)b * S * Hkv + g) * D;

  load_rows<D>(sQ, kLD, qh, q_stride, q0, S);

  float m[4], l[4], acc[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // tiles holding a key j with j <= the tile's last row and j > q0 - window
  const int kt_hi = (min(q0 + kBQ, S) - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // q staged; the previous tile's K, V and P reads done
    load_rows<D>(sK, kLD, kh, kv_stride, k0, S);
    load_rows<D>(sV, D, vh, kv_stride, k0, S);
    __syncthreads();

    // scores s[i][j] = q[ty + 16i] · k[tx + 16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * kLD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * kLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = kp <= qp && kp < S && (window <= 0 || qp - kp < window);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      // no valid key in this row yet: keep m = -inf, add nothing
      const bool none = (m_new == -INFINITY);
      const float alpha = none ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);
        sP[r * kLDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncwarp();   // a row of P is written and read by the same 16 lanes

    // acc[i][jj] += P[ty + 16i, :] · V[:, 4tx + 64jj .. +3]
    for (int c = 0; c < kBK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kLDP + c);
        p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sV + (c + cc) * D + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] = fmaf(p[i][cc], vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p[i][cc], vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p[i][cc], vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p[i][cc], vv.w, acc[i][jj][3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;   // padded rows are never written
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (lse != nullptr && tx == 0) lse[((size_t)b * Hq + h) * S + qp] = m[i] + logf(l[i]);
    float* o = out + (((size_t)b * S + qp) * Hq + h) * D + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
      *reinterpret_cast<float4*>(o + 64 * jj) =
          make_float4(acc[i][jj][0] * inv, acc[i][jj][1] * inv, acc[i][jj][2] * inv,
                      acc[i][jj][3] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int Hq, int Hkv, int window, float softcap, cudaStream_t stream) {
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Hq, Hkv, window, softcap,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf16 {

using T = __nv_bfloat16;
constexpr int kBK = 64;       // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLazy = 8.f;  // log2 units the running max may trail a tile's max

// warpgroups per block (64 query rows each), the blocks an SM is meant to
// hold; two warpgroups take the two query heads of a KV group where they can
template <int D> struct Shape;
template <> struct Shape<64> { static constexpr int kWG = 1, kMinBlocks = 3; };
template <> struct Shape<128> { static constexpr int kWG = 1, kMinBlocks = 2; };
template <> struct Shape<256> { static constexpr int kWG = 2, kMinBlocks = 1; };

// a 64-row q tile per warpgroup and two stages each of K and V, all bf16 in
// 128-byte-swizzled rows, plus 1 KB to align the base to a swizzle atom
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return (64 * Shape<D>::kWG + 4 * kBK) * D * (int)sizeof(T) + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// this thread's writes to shared memory → visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins an accumulator register in place around asynchronous wgmma: no read
// or write of it moves across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Shared-memory matrix descriptor for wgmma, 128-byte swizzle: start
// address, leading and stride byte offsets (each >> 4), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (m64 × nN, fp32) += a · b on the tensor cores, k16 per instruction, bf16
// operands. wgmma_ss: a and b in shared memory, both K-major (scores);
// wgmma_rs: a in registers (the m16n8k16 A fragment of each warp's 16
// rows), b MN-major in shared memory (V). The accumulator fragment of a
// warp is the m16n8 C fragment of its 16 rows, 8 columns at a time.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[32][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]),
        "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]),
        "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]),
        "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]),
        "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]),
        "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]),
        "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]),
        "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]),
        "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]),
        "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]),
        "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (x, y) → bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// ROWS rows of one head from row r0 (row s at src + s·stride) → shared
// memory at dst in wgmma's 128-byte-swizzled layout: the row's 64-column
// block c at dst + c·ROWS·128, row r at + r·128, its 16-byte chunk j at
// + ((j ^ r) & 7)·16. Rows at or past S are zero-filled and read nothing.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, size_t stride, int r0,
                                          int S) {
  constexpr int kChunks = D / 8;             // 16-byte chunks a row
  constexpr int kStep = THREADS / kChunks;   // rows one pass of the block covers
  static_assert(THREADS % kChunks == 0 && ROWS % kStep == 0, "whole rows per pass");
  const int row = threadIdx.x / kChunks, j = threadIdx.x % kChunks;
  const uint32_t d = dst + (j >> 3) * ROWS * 128 + row * 128;
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const int r = row + i * kStep;
    const bool ok = r0 + r < S;
    cp_async16(d + i * kStep * 128 + (((j ^ r) & 7) << 4),
               src + (size_t)(ok ? r0 + r : 0) * stride + j * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(128 * Shape<D>::kWG, Shape<D>::kMinBlocks)
    flash_prefill_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ lse, int S, int Hq, int Hkv, int window,
                              float qk_scale, float cap, int pack_log2) {
  constexpr int kWG = Shape<D>::kWG;
  constexpr int kThreads = 128 * kWG;
  constexpr int kNS = kBK / 8;                   // 8-key tiles of the scores
  constexpr int kND = D / 8;                     // 8-column tiles of the output
  constexpr int kQBytes = 64 * D * (int)sizeof(T);     // one warpgroup's q tile
  constexpr int kStage = kBK * D * (int)sizeof(T);     // one stage of K or V
  extern __shared__ uint4 smem_u4[];
  const uint32_t sQ = (smem_addr(smem_u4) + 1023) & ~1023u;   // swizzle atoms are 1 KB
  const uint32_t sK = sQ + kWG * kQBytes;      // 2 stages
  const uint32_t sV = sK + 2 * kStage;         // 2 stages

  // the block holds 2^pack_log2 query heads of one KV group, each over
  // `rows` positions; warpgroup w takes head h0 + w / wph, 64 positions from wq0
  const int rows = 64 * kWG >> pack_log2, wph = kWG >> pack_log2;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int h0 = blockIdx.y << pack_log2, b = blockIdx.z;
  const int g = h0 / (Hq / Hkv);               // GQA: query head → KV head
  const int h = h0 + wg / wph;
  const int q0 = qt * rows;
  const int wq0 = q0 + 64 * (wg % wph);        // this warpgroup's first position
  const size_t kv_stride = (size_t)Hkv * D;
  const T* kh = k + ((size_t)b * S * Hkv + g) * D;
  const T* vh = v + ((size_t)b * S * Hkv + g) * D;

  // tiles holding a key j with j <= the tile's last row and j > q0 - window
  const int kt_hi = (min(q0 + rows, S) - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

#pragma unroll
  for (int w = 0; w < kWG; ++w)   // warpgroup w's q tile: head h0 + w / wph
    load_tile<D, 64, kThreads>(sQ + w * kQBytes, q + ((size_t)b * S * Hq + h0 + w / wph) * D,
                               (size_t)Hq * D, q0 + 64 * (w % wph), S);
  load_tile<D, kBK, kThreads>(sK, kh, kv_stride, kt_lo * kBK, S);
  load_tile<D, kBK, kThreads>(sV, vh, kv_stride, kt_lo * kBK, S);
  cp_async_commit();

  // an accumulator fragment holds rows r0 (elements 0, 1) and r0 + 8 (2, 3)
  // at columns c0, c0 + 1 of each 8-column tile
  const int r0 = wq0 + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int wr0 = wq0 + 16 * warp;             // this warp's first row
  const uint32_t aQ = sQ + wg * kQBytes;

  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // the max p is taken against, log2 units
  float l[2] = {0.f, 0.f};               // this lane's share of the running sum

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {   // the next tile into the other stage, in flight during this one
      load_tile<D, kBK, kThreads>(sK + (stage ^ 1) * kStage, kh, kv_stride, (kt + 1) * kBK, S);
      load_tile<D, kBK, kThreads>(sV + (stage ^ 1) * kStage, vh, kv_stride, (kt + 1) * kBK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();     // this tile (and q) landed for this thread ...
    fence_async_shared();   // ... is visible to wgmma ...
    __syncthreads();        // ... and for every thread

    const int k0 = kt * kBK;
    // skip a tile that holds no key this warpgroup's rows can see
    const bool live = wq0 < S && k0 <= wq0 + 63 &&
                      (window <= 0 || wq0 - (k0 + kBK - 1) < window);
    if (live) {
      const uint32_t sk = sK + stage * kStage, sv = sV + stage * kStage;

      // S = q · Kᵀ: 64 rows × 64 keys, fp32; k-step kk reads 16 columns of
      // the 64-column block kk / 4 of q and K
      float s[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK>(s, smem_desc(aQ + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
                      smem_desc(sk + (kk >> 2) * kBK * 128 + (kk & 3) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // scale (and softcap) into log2 units; mask only a tile that crosses
      // the diagonal or the window's lower edge for this warp's rows
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= qk_scale;
      if (cap > 0.f) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = tanhf(s[j][e]) * cap;
      }
      const bool edge = k0 + kBK - 1 > wr0 || (window > 0 && wr0 + 15 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + c0 + (e & 1), qp = r0 + 8 * (e >> 1);
            if (kp > qp || (window > 0 && qp - kp >= window)) s[j][e] = -INFINITY;
          }
      }

      // online softmax on the fragments; the 4 lanes of a quad share a row.
      // m moves only when the tile's max passes it by more than kLazy, so
      // p < 2^kLazy (exact in fp32) and O is rescaled only on those tiles
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // with m = -inf a finite mx always moves it; no valid key yet keeps
        // m = -inf, α = 1 and p = 0
        const bool move = mx > m[i] + kLazy;
        alpha[i] = move ? exp2f(m[i] - mx) : 1.f;
        if (move) m[i] = mx;
        const bool none = (m[i] == -INFINITY);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[j][e] = none ? 0.f : exp2f(s[j][e] - m[i]);
            sum += s[j][e];
          }
        l[i] = l[i] * alpha[i] + sum;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // O += P · V, P as two bf16 terms in registers (hi + lo, together
      // exact to ~2^-17): the A operands of the 16-key k-step kk (score
      // tiles 2kk and 2kk + 1); V's keys 16kk .. 16kk + 15 are 2 swizzle
      // atoms, its 64-column blocks kBK·128 bytes apart
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        split(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
        split(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(sv + kk * 2 * 1024, kBK * 128, 1024);
        wgmma_rs<D>(o, hi[kk], dv);
        wgmma_rs<D>(o, lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    __syncthreads();   // every warpgroup is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = r0 + 8 * i;
    if (qp >= S) continue;   // padded rows are never written
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    // the row's log-sum-exp in natural units: m and the scores are in log2 units
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * Hq + h) * S + qp] = (m[i] + log2f(sum)) * kLn2;
    T* orow = out + (((size_t)b * S + qp) * Hq + h) * D + c0;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int Hq, int Hkv, int window, float softcap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bf16_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // two query heads of a KV group share a block's K/V tiles where they can
  const int pack_log2 = Shape<D>::kWG == 2 && (Hq / Hkv) % 2 == 0 ? 1 : 0;
  const int rows = 64 * Shape<D>::kWG >> pack_log2;
  const dim3 grid((S + rows - 1) / rows, Hq >> pack_log2, B);
  // scores into log2 units: s·qk_scale, then tanh(·)·cap with a softcap
  const float scale = 1.f / sqrtf((float)D);
  const float qk_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float cap = softcap > 0.f ? softcap * kLog2e : 0.f;
  flash_prefill_bf16_kernel<D><<<grid, 128 * Shape<D>::kWG, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, Hq, Hkv, window, qk_scale, cap, pack_log2);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
                 int B, int S, int Hq, int Hkv, int window, float softcap, cudaStream_t s) {
  if (dtype == 0) return f32::launch<D>(q, k, v, out, lse, B, S, Hq, Hkv, window, softcap, s);
  if (dtype == 1) return bf16::launch<D>(q, k, v, out, lse, B, S, Hq, Hkv, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,S,Hq,D), k/v (B,S,Hkv,D) → out (B,S,Hq,D), all contiguous and
// 16-byte aligned, in fp32 (dtype 0) or bf16 (dtype 1); D ∈ {64, 128, 256};
// Hq a multiple of Hkv; window >= 0 (0: none); softcap >= 0 (0: none).
// lse: null, or (B,Hq,S) fp32 that receives each row's log-sum-exp of the
// capped, masked, scaled scores in natural-log units (the backward's
// input, flash_prefill_bwd.cu). Checked by the wrapper; an out-of-range
// argument returns cudaErrorInvalidValue here. Returns cudaGetLastError().
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int S, int Hq, int Hkv, int D,
                                    int window, int dtype, float softcap, void* stream) {
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || window < 0 || !(softcap >= 0.f) || B < 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64) return launch_dtype<64>(dtype, q, k, v, out, l, B, S, Hq, Hkv, window, softcap, s);
  if (D == 128)
    return launch_dtype<128>(dtype, q, k, v, out, l, B, S, Hq, Hkv, window, softcap, s);
  if (D == 256)
    return launch_dtype<256>(dtype, q, k, v, out, l, B, S, Hq, Hkv, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
