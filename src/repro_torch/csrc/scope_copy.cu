// Scope page gather / scatter for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/scope_copy/kernel.py
// (gather_pages_pallas, scatter_pages_pallas): move whole pool rows
// between a (P, W) pool and a contiguous (n, W) wire buffer — the
// cross-pod fallback handoff's data plane.
//
// Bound on the card: HBM bytes, 2·n·W·itemsize (each row read once and
// written once) over 3.35 TB/s.
//
// Design. One block per row; the block copies the row with 16-byte
// vector loads and stores when both addresses and the row length are
// 16-byte aligned (a byte loop otherwise), so the copy is bitwise for
// any dtype. The TPU kernel's BlockSpec clamps each page id; a raw
// pointer does not, so every id is clamped to [0, P-1] before an address
// is formed. Scatter writes into the pool it is given (the TPU kernel
// aliases the pool input to its output). Duplicate ids in a scatter race:
// which writer lands is unspecified, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_row(const unsigned char* __restrict__ src,
                                         unsigned char* __restrict__ dst, int nbytes) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
        static_cast<uintptr_t>(nbytes)) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int j = threadIdx.x; j < nbytes / 16; j += kThreads) d4[j] = __ldg(s4 + j);
  } else {
    for (int j = threadIdx.x; j < nbytes; j += kThreads) dst[j] = src[j];
  }
}

__global__ void __launch_bounds__(kThreads) gather_pages_kernel(
    const unsigned char* __restrict__ pool, unsigned char* __restrict__ out,
    const int* __restrict__ pages, int row_bytes, int P) {
  const int i = blockIdx.x;
  const int page = min(max(pages[i], 0), P - 1);
  copy_row(pool + (size_t)page * row_bytes, out + (size_t)i * row_bytes, row_bytes);
}

__global__ void __launch_bounds__(kThreads) scatter_pages_kernel(
    unsigned char* __restrict__ pool, const unsigned char* __restrict__ buf,
    const int* __restrict__ pages, int row_bytes, int P) {
  const int i = blockIdx.x;
  const int page = min(max(pages[i], 0), P - 1);
  copy_row(buf + (size_t)i * row_bytes, pool + (size_t)page * row_bytes, row_bytes);
}

}  // namespace

// pool (P rows of row_bytes) → out (n rows); returns cudaGetLastError().
extern "C" int gather_pages_launch(const void* pool, void* out, const void* pages, int n,
                                   int row_bytes, int P, void* stream) {
  if (n == 0) return 0;
  gather_pages_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(pool), static_cast<unsigned char*>(out),
      static_cast<const int*>(pages), row_bytes, P);
  return (int)cudaGetLastError();
}

// buf (n rows of row_bytes) → pool rows pages[i], in place; returns cudaGetLastError().
extern "C" int scatter_pages_launch(void* pool, const void* buf, const void* pages, int n,
                                    int row_bytes, int P, void* stream) {
  if (n == 0) return 0;
  scatter_pages_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(pool), static_cast<const unsigned char*>(buf),
      static_cast<const int*>(pages), row_bytes, P);
  return (int)cudaGetLastError();
}
