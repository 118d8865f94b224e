// fed_agg: out = bw * base + sum_c gamma[c] * W[c]   (paper eq. 14)
//
// Replaces: src/repro/kernels/fed_agg/kernel.py, fed_agg_flat (_agg_kernel).
//
// What bounds it on an H100: bytes.  Every element of the (C, N) stack is
// read once and used for one multiply-add (0.5 flop per byte), so the least
// time is (C + 2) * N * 4 bytes over 3.35 TB/s: 16.3 us at the main path's
// bank pass, C = 64, N = 206,922.
//
// Design: a 1-D grid over N.  Each thread owns 4 contiguous columns and
// loops over the C rows, accumulating in f32 registers; the C weights are
// staged in shared memory, a tile at a time.  A row segment whose address
// is 16-byte aligned is loaded as one float4.  N = 206,922 is not a
// multiple of 4, so rows 1.. of a (C, N) stack are not all 16-byte
// aligned: those rows take two float2 loads where they are 8-byte aligned
// and scalar loads otherwise, as does the ragged tail of N, inside the
// same kernel (the branch depends on the row only, so a warp never
// diverges on it).  The loads of kRows rows are issued before any of
// their multiply-adds, so each thread keeps kRows loads in flight: a row
// at a time left the kernel waiting on memory latency at twice the byte
// bound.  `out` may alias `base` (the carry pass accumulates onto the bank
// pass's output in place): every element is read, then written, by the
// one thread that owns it.  C = 0 gives bw * base.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kGammaTile = 1024;
constexpr int kRows = 8;          // rows whose loads are in flight at once

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ bool aligned8(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

// Loads the up-to-4 values at p[0..n) (n = 4 on a full segment; missing
// values are 0).  kReadOnly takes the non-coherent read-only path, which is
// only for data no thread writes during the kernel: the stack, never `base`
// (it may be `out`).
template <bool kReadOnly>
__device__ __forceinline__ float ld(const float* p) {
  return kReadOnly ? __ldg(p) : *p;
}

template <bool kReadOnly>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if (n == kVec && aligned16(p)) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kReadOnly ? __ldg(q) : *q;
  }
  if (n == kVec && aligned8(p)) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 a = kReadOnly ? __ldg(q) : q[0];
    const float2 b = kReadOnly ? __ldg(q + 1) : q[1];
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = ld<kReadOnly>(p);
  if (n > 1) v.y = ld<kReadOnly>(p + 1);
  if (n > 2) v.z = ld<kReadOnly>(p + 2);
  if (n > 3) v.w = ld<kReadOnly>(p + 3);
  return v;
}

// Stores the first n values of v at p[0..n).
__device__ __forceinline__ void store4(float* p, int n, float4 v) {
  if (n == kVec && aligned16(p)) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
fed_agg_kernel(const float* __restrict__ W, const float* __restrict__ gamma,
               const float* base, float bw, float* out, int C, long long N) {
  __shared__ float g[kGammaTile];
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const int n = i0 < N ? static_cast<int>(min(static_cast<long long>(kVec), N - i0)) : 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += kGammaTile) {
    const int cn = min(kGammaTile, C - c0);
    __syncthreads();  // the previous tile's weights are no longer read
    for (int k = threadIdx.x; k < cn; k += kThreads) g[k] = gamma[c0 + k];
    __syncthreads();
    if (n == 0) continue;
    const float* row = W + static_cast<long long>(c0) * N + i0;
    int k = 0;
    for (; k + kRows <= cn; k += kRows) {
      float4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) v[u] = load4<true>(row + u * N, n);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float gk = g[k + u];
        acc.x = fmaf(gk, v[u].x, acc.x);
        acc.y = fmaf(gk, v[u].y, acc.y);
        acc.z = fmaf(gk, v[u].z, acc.z);
        acc.w = fmaf(gk, v[u].w, acc.w);
      }
      row += kRows * N;
    }
    for (; k < cn; ++k, row += N) {
      const float4 v = load4<true>(row, n);
      const float gk = g[k];
      acc.x = fmaf(gk, v.x, acc.x);
      acc.y = fmaf(gk, v.y, acc.y);
      acc.z = fmaf(gk, v.z, acc.z);
      acc.w = fmaf(gk, v.w, acc.w);
    }
  }
  if (n == 0) return;
  if (base != nullptr) {
    // the whole segment is read before any of it is written: out may be
    // base
    const float4 b = load4<false>(base + i0, n);
    acc.x = fmaf(bw, b.x, acc.x);
    acc.y = fmaf(bw, b.y, acc.y);
    acc.z = fmaf(bw, b.z, acc.z);
    acc.w = fmaf(bw, b.w, acc.w);
  }
  store4(out + i0, n, acc);
}

}  // namespace

extern "C" {

// W (C, N) row-major, gamma (C,), base (N,) or null, out (N,); all f32 on
// the current device.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
int fed_agg_launch(const float* W, const float* gamma, const float* base,
                   float bw, float* out, int C, long long N, void* stream) {
  if (C < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long blocks = (N + per_block - 1) / per_block;
  fed_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(W, gamma, base, bw,
                                                        out, C, N);
  return static_cast<int>(cudaGetLastError());
}

const char* fed_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
