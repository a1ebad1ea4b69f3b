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
// (QKᵀ and P·V, a multiply and an add each). At gemma3's global layer
// (B 1, S 4096, Hq/Hkv 16/8, D 256) that is 137.5 GFLOP → 0.139 ms at the
// bf16 tensor-core peak (989 TFLOP/s), against 100.7 MB of q, k, v and out
// → 0.030 ms at 3.35 TB/s; a 1024-token window cuts the pairs to 0.44 of
// that. This simple kernel does its products in fp32 on the CUDA cores,
// whose 67 TFLOP/s put its own floor at ~2 ms for that layer; mma.sync,
// wgmma and TMA are later work.
//
// Design. One block of 256 threads per (64-query tile, query head, batch),
// the tiles with the most keys launched first. The block stages its q tile
// once in shared memory (fp32), then walks 64-key tiles from the first one
// that reaches into the window to the one holding the diagonal: tiles
// entirely above the diagonal or entirely below the window are never
// loaded. Per tile: K and V in shared memory (fp32); each thread computes
// a 4×4 block of scores (rows ty + 16i, keys tx + 16j) with float4 reads,
// masks it, and keeps the online-softmax state (m, l) of its 4 rows; the
// 16 lanes of a row reduce by shuffles. P goes to shared memory, where
// only the same half-warp reads it back, and the thread's 4 rows × D/16
// columns of the fp32 accumulator take P·V in registers. A row that has
// seen no valid key yet keeps m = -inf and p = 0 (no exp(-inf - -inf));
// a row with l = 0 at the end writes zeros. Rows at or past S are zero in
// shared memory, masked, and never written. Shared memory: 216,064 bytes
// at D = 256, 117,760 at 128, 68,608 at 64, above the 48 KB default, so
// the launch opts in with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // query rows per block
constexpr int kBK = 64;    // keys per tile
constexpr int kPad = 4;    // floats of padding per row of q, K and P (float4-aligned)
constexpr int kLDP = kBK + kPad;
static_assert(kBQ == kBK, "load_rows stages 64-row tiles of q, K and V alike");

__host__ __device__ constexpr int smem_floats(int D) {
  return kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D + kBQ * kLDP;
}

// 16 bytes of T from global memory → fp32
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p);
  o[0] = __floats2bfloat162_rn(v[0], v[1]);
  o[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// Rows r0 .. r0+63 of one head (row s at src + s·stride) → dst (fp32, row
// stride ld floats); rows at or past S are written as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, size_t stride,
                                          int r0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow, c = (idx - row * kPerRow) * kVec;
    float vals[kVec];
    if (r0 + row < S) {
      load16(src + (size_t)(r0 + row) * stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + row * ld + c + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int Hq, int Hkv, int window, float softcap, float scale) {
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
  const T* qh = q + ((size_t)b * S * Hq + h) * D;
  const T* kh = k + ((size_t)b * S * Hkv + g) * D;
  const T* vh = v + ((size_t)b * S * Hkv + g) * D;

  load_rows<T, D>(sQ, kLD, qh, q_stride, q0, S);

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
    load_rows<T, D>(sK, kLD, kh, kv_stride, k0, S);
    load_rows<T, D>(sV, D, vh, kv_stride, k0, S);
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
    T* o = out + (((size_t)b * S + qp) * Hq + h) * D + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = acc[i][jj][e] * inv;
      store4(o + 64 * jj, r);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
           int Hkv, int window, float softcap, cudaStream_t stream) {
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Hq, Hkv, window, softcap, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
             int Hkv, int D, int window, float softcap, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, window, softcap, s);
  if (D == 128) return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, window, softcap, s);
  if (D == 256) return launch<T, 256>(q, k, v, out, B, S, Hq, Hkv, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,S,Hq,D), k/v (B,S,Hkv,D) → out (B,S,Hq,D), all contiguous, in fp32
// (dtype 0) or bf16 (dtype 1); D ∈ {64, 128, 256}; Hq a multiple of Hkv;
// window >= 0 (0: none); softcap >= 0 (0: none). Checked by the wrapper;
// an out-of-range argument returns cudaErrorInvalidValue here. Returns
// cudaGetLastError().
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int Hq, int Hkv, int D, int window,
                                    int dtype, float softcap, void* stream) {
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || window < 0 || !(softcap >= 0.f) || B < 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, out, B, S, Hq, Hkv, D, window, softcap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
