// Sandboxed paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas, body _kernel): decode attention for one query
// token per sequence over a paged KV pool, where every dereference of an
// in-use page is checked against the sandbox (bounds [lo, hi), bitmap,
// seal bit; enforce=0 leaves the bounds check only). A violating page is
// masked and counted once per sequence in oob.
//
// Bound on the card: HBM bytes. Each block reads the K and V rows of its
// (sequence, KV head) valid tokens once, so the least time is those
// bytes (2·Σseq_len·Hkv·D·itemsize) over 3.35 TB/s; the FLOPs (4·Hq·D per
// token) are far below the tensor-core roofline.
//
// Design. The TPU walks the page axis as a sequential grid dimension and
// carries (m, l, acc) in VMEM scratch. Here one block owns one
// (sequence, KV head) pair and its warps split that sequence's in-use
// pages (ceil(seq_len / T), capped at MAXP; pages past that are neither
// read nor counted, as the TPU kernel's in_use mask gives). Each warp
// keeps its own fp32 online softmax in registers: lane i owns columns
// [i·D/32, (i+1)·D/32) of every query row of the GQA group, so q and the
// accumulators never leave registers and a dot product is a per-lane
// partial sum plus a warp shuffle reduction. Per page, the warp resolves
// the page id (clamped to [0, P-1] before any address is formed — a raw
// pointer has no BlockSpec clamp) and applies the checks; a rejected page
// is skipped whole, which leaves the softmax exactly as the TPU kernel's
// -inf mask does. An accepted page's K and V rows for this head are
// loaded into registers with vector loads, up to 16 tokens at a time, so
// many loads are in flight before the first is used. There is no barrier
// inside the page loop: the warps' softmax states are merged once at the
// end through shared memory. A row with no valid token ends as zeros,
// never NaN. Only the blockIdx.y == 0 block of a sequence writes oob, so
// a violation is counted once, not once per KV head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQpk = 8;       // query rows per KV head a block holds
constexpr int kPermSealed = 1;   // heap perm bit0

// Lane-row storage: EPL consecutive elements of T_in as 32-bit words.
template <typename T_in, int EPL>
struct LaneRow {
  static constexpr int kBytes = EPL * (int)sizeof(T_in);
  static constexpr int kWords = kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T_in* __restrict__ src) {
    if constexpr (kWords == 1) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
    } else if constexpr (kWords == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = t.x;
      w[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(src) + i);
        w[4 * i] = t.x;
        w[4 * i + 1] = t.y;
        w[4 * i + 2] = t.z;
        w[4 * i + 3] = t.w;
      }
    }
  }

  // element e as fp32 (bf16 → fp32 is exact: the bits shift up)
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T_in) == 2) {
      const uint32_t word = w[e >> 1];
      return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
    } else {
      return __uint_as_float(w[e]);
    }
  }
};

__device__ __forceinline__ void store_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (B, Hkv), kThreads threads; D = 32·EPL. Dynamic shared memory for
// the final merge: m, l [kWarps·kMaxQpk] | acc [kWarps·qpk·D] (fp32).
template <typename T_in, int EPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T_in* __restrict__ q, const T_in* __restrict__ k_pool, const T_in* __restrict__ v_pool,
    const int* __restrict__ block_tab, const int* __restrict__ seq_lens,
    const int* __restrict__ perm, const int* __restrict__ sandbox,
    const int* __restrict__ bitmap, T_in* __restrict__ out, int* __restrict__ oob,
    int Hq, int Hkv, int P, int T, int MAXP, float scale) {
  using Row = LaneRow<T_in, EPL>;
  // tokens whose K and V rows a lane holds at once (128 bytes of each)
  constexpr int kChunk = 128 / Row::kBytes < 16 ? 128 / Row::kBytes : 16;
  constexpr int D = 32 * EPL;

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int qpk = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) float smem[];
  float* m_s = smem;                        // [kWarps][kMaxQpk]
  float* l_s = m_s + kWarps * kMaxQpk;      // [kWarps][kMaxQpk]
  float* acc_s = l_s + kWarps * kMaxQpk;    // [kWarps][qpk][D]
  __shared__ int oob_s[kWarps];

  // this lane's columns of the group's query rows, pre-scaled by 1/sqrt(D)
  float qr[kMaxQpk][EPL];
  float acc[kMaxQpk][EPL];
  float m[kMaxQpk], l[kMaxQpk];
  const T_in* q_rows = q + ((size_t)b * Hq + (size_t)g * qpk) * D + lane * EPL;
#pragma unroll
  for (int p = 0; p < kMaxQpk; ++p) {
    Row r;
    if (p < qpk) r.load(q_rows + (size_t)p * D);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[p][e] = p < qpk ? r.get(e) * scale : 0.f;
      acc[p][e] = 0.f;
    }
    m[p] = -INFINITY;
    l[p] = 0.f;
  }

  const int seq_len = seq_lens[b];
  const int n_pages = seq_len > 0 ? min((seq_len + T - 1) / T, MAXP) : 0;
  const int sb_lo = sandbox[0], sb_hi = sandbox[1], sb_on = sandbox[2];
  const size_t tok_stride = (size_t)Hkv * D;
  int n_oob = 0;

  for (int pi = warp; pi < n_pages; pi += kWarps) {
    // the sandboxed dereference (§4.4), warp-uniform
    const int pid = block_tab[(size_t)b * MAXP + pi];
    const int c = min(max(pid, 0), P - 1);
    const bool in_bounds = pid >= sb_lo && pid < sb_hi;
    const bool ok = in_bounds && bitmap[c] > 0 && (perm[c] & kPermSealed) != 0;
    if (!(sb_on > 0 ? ok : in_bounds)) {
      ++n_oob;
      continue;
    }
    const int nt = min(T, seq_len - pi * T);  // valid tokens in this page
    const T_in* k_page = k_pool + ((size_t)c * T * Hkv + g) * D + lane * EPL;
    const T_in* v_page = v_pool + ((size_t)c * T * Hkv + g) * D + lane * EPL;

    for (int t0 = 0; t0 < nt; t0 += kChunk) {
      Row kr[kChunk], vr[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (t0 + u < nt) {
          kr[u].load(k_page + (t0 + u) * tok_stride);
          vr[u].load(v_page + (t0 + u) * tok_stride);
        }
      }
      // online softmax over groups of 4 tokens: one rescale per group
#pragma unroll
      for (int u0 = 0; u0 < kChunk; u0 += 4) {
        if (t0 + u0 < nt) {
          float s[4][kMaxQpk];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int p = 0; p < kMaxQpk; ++p) {
              float dot = 0.f;
              if (p < qpk && t0 + u0 + j < nt) {
#pragma unroll
                for (int e = 0; e < EPL; ++e) dot = fmaf(qr[p][e], kr[u0 + j].get(e), dot);
                dot = warp_sum(dot);
              }
              s[j][p] = dot;
            }
          }
#pragma unroll
          for (int p = 0; p < kMaxQpk; ++p) {
            if (p < qpk) {
              float mx = m[p];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (t0 + u0 + j < nt) mx = fmaxf(mx, s[j][p]);
              const float alpha = __expf(m[p] - mx);  // m = -inf → 0
              l[p] *= alpha;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[p][e] *= alpha;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (t0 + u0 + j < nt) {
                  const float pe = __expf(s[j][p] - mx);
                  l[p] += pe;
#pragma unroll
                  for (int e = 0; e < EPL; ++e)
                    acc[p][e] = fmaf(pe, vr[u0 + j].get(e), acc[p][e]);
                }
              }
              m[p] = mx;
            }
          }
        }
      }
    }
  }

  // merge the warps' softmax states
#pragma unroll
  for (int p = 0; p < kMaxQpk; ++p) {
    if (p < qpk) {
      if (lane == 0) {
        m_s[warp * kMaxQpk + p] = m[p];
        l_s[warp * kMaxQpk + p] = l[p];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc_s[((size_t)warp * qpk + p) * D + lane * EPL + e] = acc[p][e];
    }
  }
  if (lane == 0) oob_s[warp] = n_oob;
  __syncthreads();

  T_in* out_rows = out + ((size_t)b * Hq + (size_t)g * qpk) * D;
  for (int i = threadIdx.x; i < qpk * D; i += kThreads) {
    const int p = i / D;
    const int d = i - p * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kMaxQpk + p]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w * kMaxQpk + p] - mx);  // idle warp: 0
        den = fmaf(l_s[w * kMaxQpk + p], f, den);
        num = fmaf(acc_s[((size_t)w * qpk + p) * D + d], f, num);
      }
    }
    store_f32(num / (den > 0.f ? den : 1.f), out_rows + i);
  }
  if (g == 0 && threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += oob_s[w];
    oob[b] = total;
  }
}

template <typename T_in, int EPL>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* block_tab,
           const void* seq_lens, const void* perm, const void* sandbox, const void* bitmap,
           void* out, void* oob, int B, int Hq, int Hkv, int P, int T, int MAXP,
           cudaStream_t stream) {
  constexpr int D = 32 * EPL;
  const int qpk = Hq / Hkv;
  const size_t smem = (2 * (size_t)kWarps * kMaxQpk + (size_t)kWarps * qpk * D) * sizeof(float);
  auto kernel = paged_attention_kernel<T_in, EPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T_in*>(q), static_cast<const T_in*>(k_pool),
      static_cast<const T_in*>(v_pool), static_cast<const int*>(block_tab),
      static_cast<const int*>(seq_lens), static_cast<const int*>(perm),
      static_cast<const int*>(sandbox), static_cast<const int*>(bitmap),
      static_cast<T_in*>(out), static_cast<int*>(oob), Hq, Hkv, P, T, MAXP,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T_in>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const void* block_tab,
             const void* seq_lens, const void* perm, const void* sandbox, const void* bitmap,
             void* out, void* oob, int B, int Hq, int Hkv, int D, int P, int T, int MAXP,
             cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T_in, 2>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox, bitmap, out,
                             oob, B, Hq, Hkv, P, T, MAXP, s);
    case 128:
      return launch<T_in, 4>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox, bitmap, out,
                             oob, B, Hq, Hkv, P, T, MAXP, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// D ∈ {64, 128}; Hq / Hkv ≤ 8. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tab, const void* seq_lens,
                                      const void* perm, const void* sandbox, const void* bitmap,
                                      void* out, void* oob, int B, int Hq, int Hkv, int D, int P,
                                      int T, int MAXP, int dtype, void* stream) {
  if (B == 0) return 0;
  if (Hq % Hkv != 0 || Hq / Hkv > kMaxQpk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox, bitmap, out,
                           oob, B, Hq, Hkv, D, P, T, MAXP, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox, bitmap,
                                   out, oob, B, Hq, Hkv, D, P, T, MAXP, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
