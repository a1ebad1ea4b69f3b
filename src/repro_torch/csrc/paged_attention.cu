// Sandboxed paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas, body _kernel): decode attention for one query
// token per sequence over a paged KV pool, where every dereference of an
// in-use page is checked against the sandbox (bounds [lo, hi), bitmap,
// seal bit; enforce=0 leaves the bounds check only). A sequence's in-use
// pages are ceil(seq_len / T), capped at MAXP; pages past MAXP are neither
// read nor counted. A page id is clamped to [0, P-1] before it forms an
// address (a raw pointer has no BlockSpec clamp). A rejected page is
// skipped whole, which leaves the softmax exactly as the TPU kernel's -inf
// mask does, and counted once per sequence in oob. Scores, softmax state
// and the accumulator are fp32; out has q's dtype; a row with no valid
// token writes zeros, never NaN.
//
// Bound on the card: HBM bytes. The valid tokens' K and V rows of each
// (sequence, KV head) are read once, 2·Σseq_len·Hkv·D·itemsize bytes at
// 3.35 TB/s (yi-9b at B 8 and the served lengths: 5.9 MB, 1.8 µs). The
// FLOPs, 4·Hq·D per token, are three orders below the tensor-core peak.
//
// bf16 (paged_attention_bf16_kernel): split pages (flash decoding) over a
// thread-block cluster. The grid is (C, Hkv, B) with cluster dimensions
// (C, 1, 1): the C blocks of a cluster share one (sequence, KV head) pair.
// C (cluster_size) is the largest power of two, at most the portable 8,
// that keeps the grid to one block an SM: yi-9b's B·Hkv = 32 pairs take
// C 4, 128 blocks on 132 SMs, where the old grid had 32. A block has 4
// warps; the pair's 4C warps take its pages in turn (page i to warp slot
// i mod 4C, slot = warp·C + rank, so a short sequence spreads over the
// ranks first). A warp resolves up to 32 of its pages at once, lane j the
// j-th: block-table entry, clamp, bounds, bitmap and seal, one ballot.
// Only accepted pages are copied: a rejected page is never read. The warp
// walks its accepted pages' 16-token tiles (a page of T 16 is one tile;
// rows past seq_len or past T are zero-filled and masked to -inf) through
// a ring of two stages in its own shared memory, filled by 16-byte
// cp.async, so tile i+1 is in flight while tile i is computed. Per tile,
// on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the group's <= 8 query
// rows padded to 16 (rows 8-15 of A and C are zero registers, their
// results dropped):
//   S = q·Kᵀ   q as A fragments loaded once from global memory, K as B by
//              ldmatrix from the tile (rows = tokens, D contiguous)
//   P·V        P's C fragments, rounded to bf16, are the A fragments of P·V
//              in registers; V as B by ldmatrix.trans
// The four lanes of a row hold its 16 scores, so the row max is two quad
// shuffles, and l is summed per lane and across the quad once at the end.
// P enters P·V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi): one
// term misses the bf16 check past MAXP·T (kPTerms; see
// kernels/paged_attention/variants.py). Tiles keep their 16-byte chunks
// XOR-swizzled by row mod 8, so an ldmatrix phase reads 8 rows from 8
// distinct bank groups.
// Merge, in the same launch and without a workspace: each warp writes its
// (m, l, O) into its own ring; a thread per row weighs the block's warps
// and the block sums their O rows into the block's (m, l, O);
// cluster.sync() releases it to the cluster; rank r combines the C
// blocks' states for its quarter (C 4) of the output through distributed
// shared memory (cluster.map_shared_rank, every peer read at once) and
// writes out; a last, relaxed cluster barrier keeps each block's shared
// memory alive until its peers have read it. A block or warp with no valid
// token holds m = -inf, l = 0 and weighs 0. Only rank 0 of the g == 0
// cluster writes oob[b]. At the main path's shape a launch is a chain of
// dependent waits, not a stream of bytes: the block table and sandbox
// words, then the pages, then the products, then the merges.
//
//   D    shared memory a block (ring: 4 warps × 2 stages × K, V tile)
//   64   32,768 B ring + 2.5 KB of merge state
//   128  65,536 B ring + 4.6 KB of merge state
// Registers are in ptxas's report (phase 1 of chip_smoke.py fails on a
// spill); the launch bounds ask for one block an SM.
//
// fp32 (paged_attention_f32_kernel): CUDA cores, one block per (sequence,
// KV head). Its warps split the sequence's pages; lane i owns columns
// [i·D/32, (i+1)·D/32) of every query row of the group, so a dot product is
// a per-lane partial sum plus a warp shuffle reduction; K and V rows go
// straight into registers, up to 16 tokens at a time. It serves no model
// path (the pool is bf16) and keeps fp32 exact to 5e-5, which TF32 would
// miss.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQpk = 8;       // query rows per KV head a block holds
constexpr int kPermSealed = 1;   // heap perm bit0

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// EPL consecutive floats of a row, as 32-bit words
template <int EPL>
struct LaneRow {
  uint32_t w[EPL];

  __device__ __forceinline__ void load(const float* __restrict__ src) {
    if constexpr (EPL == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = t.x;
      w[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < EPL / 4; ++i) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(src) + i);
        w[4 * i] = t.x;
        w[4 * i + 1] = t.y;
        w[4 * i + 2] = t.z;
        w[4 * i + 3] = t.w;
      }
    }
  }

  __device__ __forceinline__ float get(int e) const { return __uint_as_float(w[e]); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (B, Hkv), kThreads threads; D = 32·EPL. Dynamic shared memory for
// the final merge: m, l [kWarps·kMaxQpk] | acc [kWarps·qpk·D] (fp32).
template <int EPL>
__global__ void __launch_bounds__(kThreads) paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ block_tab,
    const int* __restrict__ seq_lens, const int* __restrict__ perm,
    const int* __restrict__ sandbox, const int* __restrict__ bitmap, float* __restrict__ out,
    int* __restrict__ oob, int Hq, int Hkv, int P, int T, int MAXP, float scale) {
  using Row = LaneRow<EPL>;
  // tokens whose K and V rows a lane holds at once (128 bytes of each)
  constexpr int kChunk = 32 / EPL < 16 ? 32 / EPL : 16;
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
  const float* q_rows = q + ((size_t)b * Hq + (size_t)g * qpk) * D + lane * EPL;
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
    const float* k_page = k_pool + ((size_t)c * T * Hkv + g) * D + lane * EPL;
    const float* v_page = v_pool + ((size_t)c * T * Hkv + g) * D + lane * EPL;

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

  float* out_rows = out + ((size_t)b * Hq + (size_t)g * qpk) * D;
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
    out_rows[i] = num / (den > 0.f ? den : 1.f);
  }
  if (g == 0 && threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += oob_s[w];
    oob[b] = total;
  }
}

template <int EPL>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* block_tab,
           const void* seq_lens, const void* perm, const void* sandbox, const void* bitmap,
           void* out, void* oob, int B, int Hq, int Hkv, int P, int T, int MAXP,
           cudaStream_t stream) {
  constexpr int D = 32 * EPL;
  const int qpk = Hq / Hkv;
  const size_t smem = (2 * (size_t)kWarps * kMaxQpk + (size_t)kWarps * qpk * D) * sizeof(float);
  auto kernel = paged_attention_f32_kernel<EPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(block_tab),
      static_cast<const int*>(seq_lens), static_cast<const int*>(perm),
      static_cast<const int*>(sandbox), static_cast<const int*>(bitmap),
      static_cast<float*>(out), static_cast<int*>(oob), Hq, Hkv, P, T, MAXP,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: split pages over a cluster, mma.sync, cp.async
// ---------------------------------------------------------------------------
namespace bf16 {

using T = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;        // tokens a tile: one k-step of P·V
constexpr int kStages = 2;       // tiles a warp holds in its ring
constexpr int kPTerms = 2;       // bf16 terms of P in P·V: hi, or hi + lo
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kOPad = 8;         // floats of padding per row of a warp's O
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int tile_bytes() {
  return kTile * D * (int)sizeof(T);
}
template <int D> __host__ __device__ constexpr int warp_bytes() {
  return kStages * 2 * tile_bytes<D>();
}
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return kWarps * warp_bytes<D>();
}
static_assert((64 + kOPad) * kMaxQpk * 4 <= warp_bytes<64>(), "a warp's O fits its ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ch of row t in a tile: chunks XOR-swizzled by
// t mod 8, so the 8 rows an ldmatrix phase reads lie in 8 bank groups
template <int D>
__device__ __forceinline__ uint32_t tile_off(int t, int ch) {
  return (uint32_t)(t * D * (int)sizeof(T) + ((ch ^ (t & 7)) << 4));
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

// d += a · b on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) for rows 0-7:
// a0, a2 are the A fragment's registers of rows 0-7 (columns 2·quad and
// 8 + 2·quad); rows 8-15 of A and C are zero and their results dropped.
__device__ __forceinline__ void mma_rows8(float (&d)[2], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  float z0, z1;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %5}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(z0), "=f"(z1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
  (void)z0;
  (void)z1;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (C, Hkv, B), cluster (C, 1, 1), kThreads threads; dynamic shared
// memory: each warp's ring of kStages × (K tile, V tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_bf16_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ block_tab, const int* __restrict__ seq_lens,
    const int* __restrict__ perm, const int* __restrict__ sandbox,
    const int* __restrict__ bitmap, T* __restrict__ out, int* __restrict__ oob, int Hq,
    int Hkv, int P, int PT, int MAXP, float scale_log2) {
  constexpr int kSteps = D / 16;   // k-steps of q·Kᵀ; pairs of 8-column n-tiles of P·V
  constexpr int kChunks = D / 8;   // 16-byte chunks in a row
  constexpr int kLdO = D + kOPad;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;         // the cluster spans the grid's x
  const int rank = blockIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int qpk = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = lane >> 2, quad = lane & 3;   // a fragment row and its lane in the quad

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float warp_m[kWarps][kMaxQpk], warp_l[kWarps][kMaxQpk], warp_f[kWarps][kMaxQpk];
  __shared__ int warp_oob[kWarps];
  __shared__ __align__(16) float cta_o[kMaxQpk * D];
  __shared__ float cta_m[kMaxQpk], cta_l[kMaxQpk];
  __shared__ int cta_oob;
  unsigned char* ring = smem_raw + warp * warp_bytes<D>();
  const uint32_t ring_s = smem_addr(ring);

  // independent loads first: seq_len, the sandbox, q (the A fragments of
  // the group's rows; rows past qpk are zero) and, below, the block table
  const int seq_len = seq_lens[b];
  const int sb_lo = sandbox[0], sb_hi = sandbox[1], sb_on = sandbox[2];
  uint32_t qa[kSteps][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) qa[ks][0] = qa[ks][1] = 0u;
  if (row < qpk) {
    const unsigned int* qr = reinterpret_cast<const unsigned int*>(
        q + ((size_t)b * Hq + (size_t)g * qpk + row) * D + 2 * quad);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      qa[ks][0] = __ldg(qr + 8 * ks);       // columns 16·ks + 2·quad, +1
      qa[ks][1] = __ldg(qr + 8 * ks + 4);   // columns 16·ks + 8 + 2·quad, +1
    }
  }
  const int n_pages = seq_len > 0 ? min((seq_len + PT - 1) / PT, MAXP) : 0;
  const int NW = C * kWarps;              // warps sharing the pair's pages
  const int slot = warp * C + rank;       // this warp takes pages slot, slot + NW, ...
  const size_t tok_stride = (size_t)Hkv * D;

  float o[2 * kSteps][2];   // O row `row`, columns 8·nd + 2·quad, +1
#pragma unroll
  for (int nd = 0; nd < 2 * kSteps; ++nd) o[nd][0] = o[nd][1] = 0.f;
  float m = -INFINITY;      // running max of the row, log2 units
  float l = 0.f;            // this lane's share of the row's sum
  int n_oob = 0;

  // ldmatrix row addresses within a tile: K as B of two 8-token n-tiles
  // (matrices: tokens 0-7 | 8-15 × columns lo | hi of a k-step), V
  // transposed as B of two 8-column n-tiles (tokens 0-7 | 8-15 × columns
  // of n-tile 2j | 2j+1)
  const int mi = lane >> 3, r8 = lane & 7;
  const int k_tok = ((mi >> 1) << 3) + r8, k_ch = mi & 1;
  const int v_tok = ((mi & 1) << 3) + r8, v_ch = mi >> 1;

  // one tile: tokens row0 .. row0+15 of pool page c (nv of them valid)
  auto issue = [&](int st, int c, int row0, int nv) {
    const size_t src0 = ((size_t)c * PT + row0) * tok_stride + (size_t)g * D;
    const uint32_t kd = ring_s + st * 2 * tile_bytes<D>();
    const uint32_t vd = kd + tile_bytes<D>();
#pragma unroll
    for (int u = 0; u < kTile * kChunks / 32; ++u) {
      const int i = lane + 32 * u;
      const int t = i / kChunks, ch = i - t * kChunks;
      const bool ok = t < nv;
      const size_t src = src0 + (ok ? (size_t)t * tok_stride : 0) + 8 * ch;
      cp_async16(kd + tile_off<D>(t, ch), k_pool + src, ok);
      cp_async16(vd + tile_off<D>(t, ch), v_pool + src, ok);
    }
  };

  auto compute = [&](int st, int nv) {
    const uint32_t kb = ring_s + st * 2 * tile_bytes<D>();
    const uint32_t vb = kb + tile_bytes<D>();
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // n-tile (tokens 0-7 | 8-15), column pair
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, kb + tile_off<D>(k_tok, 2 * ks + k_ch));
      mma_rows8(s[0], qa[ks][0], qa[ks][1], kf[0], kf[1]);
      mma_rows8(s[1], qa[ks][0], qa[ks][1], kf[2], kf[3]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = 8 * nt + 2 * quad + e < nv ? s[nt][e] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);        // finite: a tile holds a valid token
    const float alpha = exp2f(m - m_new);    // m = -inf → 0
    m = m_new;
    uint32_t ph[2], pl[2];
    float psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = exp2f(s[nt][0] - m), p1 = exp2f(s[nt][1] - m);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[nt] = pack_bf16(hi);
      pl[nt] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      psum += kPTerms == 2 ? p0 + p1 : hf.x + hf.y;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int nd = 0; nd < 2 * kSteps; ++nd) {
      o[nd][0] *= alpha;
      o[nd][1] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vb + tile_off<D>(v_tok, 2 * j + v_ch));
      mma_rows8(o[2 * j], ph[0], ph[1], vf[0], vf[1]);
      mma_rows8(o[2 * j + 1], ph[0], ph[1], vf[2], vf[3]);
      if constexpr (kPTerms == 2) {
        mma_rows8(o[2 * j], pl[0], pl[1], vf[0], vf[1]);
        mma_rows8(o[2 * j + 1], pl[0], pl[1], vf[2], vf[3]);
      }
    }
  };

  for (int base = 0;; base += 32) {
    // the sandboxed dereference (§4.4) of this warp's next 32 pages, a lane each
    const int pi = slot + (base + lane) * NW;
    const int pid = pi < MAXP ? __ldg(block_tab + (size_t)b * MAXP + pi) : 0;
    const bool in_use = pi < n_pages;
    const int c = min(max(pid, 0), P - 1);
    bool accept = false;
    if (in_use) {
      const bool in_bounds = pid >= sb_lo && pid < sb_hi;
      const bool ok = in_bounds && __ldg(bitmap + c) > 0 && (__ldg(perm + c) & kPermSealed) != 0;
      accept = sb_on > 0 ? ok : in_bounds;
    }
    const int nt_page = in_use ? min(PT, seq_len - pi * PT) : 0;   // valid tokens
    unsigned todo = __ballot_sync(0xffffffffu, accept);
    n_oob += __popc(__ballot_sync(0xffffffffu, in_use) & ~todo);

    // the accepted pages' tiles, in order, through the ring (warp-uniform)
    int cur = -1, cur_j = 0, cur_nt = 0, cur_c = 0;
    auto next_tile = [&](int& c_, int& row0, int& nv) -> bool {
      if (cur >= 0 && (cur_j + 1) * kTile < cur_nt) {
        ++cur_j;
      } else {
        if (!todo) return false;
        cur = __ffs(todo) - 1;
        todo &= todo - 1;
        cur_j = 0;
        cur_nt = __shfl_sync(0xffffffffu, nt_page, cur);
        cur_c = __shfl_sync(0xffffffffu, c, cur);
      }
      c_ = cur_c;
      row0 = cur_j * kTile;
      nv = min(kTile, cur_nt - row0);
      return true;
    };
    int tc, trow, tnv;
    bool have = next_tile(tc, trow, tnv);
    if (have) issue(0, tc, trow, tnv);
    cp_async_commit();
    for (int st = 0; have; st ^= 1) {
      int nc, nrow, nnv;
      const bool more = next_tile(nc, nrow, nnv);
      if (more) issue(st ^ 1, nc, nrow, nnv);
      cp_async_commit();
      cp_async_wait<1>();   // this lane's copies of tile st landed ...
      __syncwarp();         // ... and every lane's
      compute(st, tnv);
      __syncwarp();         // stage st read by every lane before it is refilled
      tnv = nnv;
      have = more;
    }
    if (slot + (base + 32) * NW >= n_pages) break;
  }
  cp_async_wait<0>();

  // this warp's state → its ring: O rows (kLdO floats apart), m, l, oob
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* wo = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nd = 0; nd < 2 * kSteps; ++nd)
    *reinterpret_cast<float2*>(wo + row * kLdO + 8 * nd + 2 * quad) =
        make_float2(o[nd][0], o[nd][1]);
  if (quad == 0) {
    warp_m[warp][row] = m;
    warp_l[warp][row] = l;
  }
  if (lane == 0) warp_oob[warp] = n_oob;
  __syncthreads();

  // the block's state: its warps combined. A thread per row weighs each
  // warp by 2^(m_w - m) (0 for a warp with no token), then the block sums
  // the weighted O rows four columns a thread
  if (threadIdx.x < qpk) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w][r]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = mx == -INFINITY ? 0.f : exp2f(warp_m[w][r] - mx);
      warp_f[w][r] = f;
      den = fmaf(f, warp_l[w][r], den);
    }
    cta_m[r] = mx;
    cta_l[r] = den;
  }
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_oob[w];
    cta_oob = total;
  }
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < qpk * D; i += 4 * kThreads) {
    const int r = i / D, d = i - r * D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = warp_f[w][r];
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(smem_raw + w * warp_bytes<D>()) + r * kLdO + d);
      acc = make_float4(fmaf(f, v.x, acc.x), fmaf(f, v.y, acc.y), fmaf(f, v.z, acc.z),
                        fmaf(f, v.w, acc.w));
    }
    *reinterpret_cast<float4*>(&cta_o[i]) = acc;
  }
  cluster.sync();   // release the blocks' states to the cluster

  // the cluster's state: rank r combines the C blocks for its share of out,
  // four columns a thread, every peer's (m, l, O) read at once
  T* out_rows = out + ((size_t)b * Hq + (size_t)g * qpk) * D;
  for (int i = 4 * (rank * kThreads + threadIdx.x); i < qpk * D; i += 4 * C * kThreads) {
    const int r = i / D;
    float peer_m[kMaxCluster], peer_l[kMaxCluster];
    float4 peer_o[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < C) {
        peer_m[j] = *cluster.map_shared_rank(&cta_m[r], j);
        peer_l[j] = *cluster.map_shared_rank(&cta_l[r], j);
        peer_o[j] = *cluster.map_shared_rank(reinterpret_cast<float4*>(&cta_o[i]), j);
      } else {
        peer_m[j] = -INFINITY;
        peer_l[j] = 0.f;
        peer_o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mx = fmaxf(mx, peer_m[j]);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        const float f = exp2f(peer_m[j] - mx);   // a rank with no token: 0
        acc = make_float4(fmaf(f, peer_o[j].x, acc.x), fmaf(f, peer_o[j].y, acc.y),
                          fmaf(f, peer_o[j].z, acc.z), fmaf(f, peer_o[j].w, acc.w));
        den = fmaf(f, peer_l[j], den);
      }
    }
    const float inv = den > 0.f ? __fdividef(1.f, den) : 0.f;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out_rows + i) = make_uint2(pack_bf16(lo), pack_bf16(hi));
  }
  if (g == 0 && rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int j = 0; j < C; ++j) total += *cluster.map_shared_rank(&cta_oob, j);
    oob[b] = total;
  }
  // peers' shared memory stays alive until it has been read: every read
  // above has been consumed, so the arrive needs no release
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// blocks a (sequence, KV head) pair's pages are split over: the largest
// power of two, at most the portable cluster size, that keeps the grid to
// one block an SM (C 4 for yi-9b's 32 pairs on 132 SMs)
int cluster_size(int pairs, int sms) {
  int c = 1;
  while (c < kMaxCluster && pairs * c * 2 <= sms) c *= 2;
  return c;
}

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* block_tab,
           const void* seq_lens, const void* perm, const void* sandbox, const void* bitmap,
           void* out, void* oob, int B, int Hq, int Hkv, int P, int PT, int MAXP,
           cudaStream_t stream) {
  auto kernel = paged_attention_bf16_kernel<D>;
  constexpr int smem = smem_bytes<D>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int C = cluster_size(B * Hkv, sms);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // once per device and cluster size: can a cluster of C blocks be placed?
  static unsigned placed[kMaxDevices] = {};
  if (dev >= kMaxDevices || !((placed[dev] >> C) & 1u)) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    if (dev < kMaxDevices) placed[dev] |= 1u << C;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
                           static_cast<const int*>(block_tab), static_cast<const int*>(seq_lens),
                           static_cast<const int*>(perm), static_cast<const int*>(sandbox),
                           static_cast<const int*>(bitmap), static_cast<T*>(out),
                           static_cast<int*>(oob), Hq, Hkv, P, PT, MAXP,
                           kLog2e / sqrtf((float)D));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// D ∈ {64, 128}; Hq / Hkv ≤ 8. Returns the launch's error code (0 =
// launched): cudaErrorLaunchOutOfResources if the bf16 kernel's cluster
// cannot be placed on the card.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tab, const void* seq_lens,
                                      const void* perm, const void* sandbox, const void* bitmap,
                                      void* out, void* oob, int B, int Hq, int Hkv, int D, int P,
                                      int T, int MAXP, int dtype, void* stream) {
  if (B == 0) return 0;
  if (Hq % Hkv != 0 || Hq / Hkv > kMaxQpk) return (int)cudaErrorInvalidValue;
  if ((D != 64 && D != 128) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return D == 64 ? f32::launch<2>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox,
                                    bitmap, out, oob, B, Hq, Hkv, P, T, MAXP, s)
                   : f32::launch<4>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox,
                                    bitmap, out, oob, B, Hq, Hkv, P, T, MAXP, s);
  }
  return D == 64 ? bf16::launch<64>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox,
                                    bitmap, out, oob, B, Hq, Hkv, P, T, MAXP, s)
                 : bf16::launch<128>(q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox,
                                     bitmap, out, oob, B, Hq, Hkv, P, T, MAXP, s);
}

// The cluster size the bf16 launch picks for B x Hkv (sequence, KV head)
// pairs on the current device (1 leaves each pair's pages to one block), or
// -(CUDA error code).
extern "C" int paged_attention_cluster_size(int B, int Hkv) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return bf16::cluster_size(B * Hkv, sms);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
