// fed_agg: out = bw * base + gamma^T W + gamma2^T W2   (paper eq. 14)
//
// Replaces: src/repro/kernels/fed_agg/kernel.py, fed_agg_flat (_agg_kernel).
//
// The function: fed_agg_flat over the row concatenation [W; W2] with the
// weights [gamma; gamma2], without forming the concatenation.  The epoch
// step passes the bank (C rows) and the carried stragglers (C2 rows); the
// JAX package runs the same sum as two passes, the carry pass onto the bank
// pass's output (src/repro/core/epoch_step.py:169-170), and this one launch
// differs from those only in the order of rounding.  C2 = 0 is the
// one-segment call; C = C2 = 0 gives bw * base.
//
// What bounds it on an H100: bytes.  Every element of both stacks is read
// once and used for one multiply-add (0.5 flop per byte), so the least time
// is (C + C2 + 2) * N * 4 bytes over 3.35 TB/s: 17.3 us at the main path's
// bank of 64 rows plus carry of 4, N = 206,922.
//
// Design: a 1-D grid over N, one thread per 4 contiguous columns, f32
// accumulators in registers.  The rows of both segments form one sequence
// (bank rows, then carry rows), walked in batches of kRows: the loads of
// the next batch are issued before the multiply-adds of the current one,
// so a thread keeps up to 2 * kRows rows in flight, and rows past the end
// are predicated off (weight 0, no load) instead of a row-at-a-time tail.
// `base` is loaded with the first batch.  A separate launch for the carry
// cannot get near its own 1.5 us bound (a launch and its ramp cost about
// that much), so the carry rides in the bank's launch.  Vector width: the
// host picks V = 4, 2 or 1 floats a load as the widest width every row
// start (N, the stacks, base and out) is aligned to, so the loads carry no
// alignment branch: N = 206,922 is 2 mod 4, so the main path loads float2
// pairs.  `out` may alias `base` (the in-place epoch update): every
// element is read, then written, by the one thread that owns it.  No
// atomics: the result is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;          // columns a thread owns
constexpr int kRows = 8;          // rows a batch; two batches in flight

// Loads this thread's kCols floats at p as vectors of V floats, or zeros
// where `live` is false or the vector starts at or past n (n, the columns
// left in the row, is a multiple of V).  kReadOnly takes the non-coherent
// read-only path, for data no thread writes during the kernel: the
// stacks, never `base` (it may be `out`).
template <int V, bool kReadOnly>
__device__ __forceinline__ void load_cols(const float* p, int n, bool live,
                                          float (&v)[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; j += V) {
    if (live && j < n) {
      if constexpr (V == 4) {
        const float4* q = reinterpret_cast<const float4*>(p + j);
        const float4 t = kReadOnly ? __ldg(q) : *q;
        v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
      } else if constexpr (V == 2) {
        const float2* q = reinterpret_cast<const float2*>(p + j);
        const float2 t = kReadOnly ? __ldg(q) : *q;
        v[j] = t.x; v[j + 1] = t.y;
      } else {
        v[j] = kReadOnly ? __ldg(p + j) : p[j];
      }
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[j + u] = 0.f;
    }
  }
}

struct Segments {
  const float* W;       // (C, N)
  const float* gamma;   // (C,)
  int C;
  const float* W2;      // (C2, N)
  const float* gamma2;  // (C2,)
  int R;                // C + C2
  long long N;
};

// Rows r0 .. r0 + kRows - 1 of the sequence [W; W2] at this thread's
// columns, and their weights; rows at or past R load nothing and weigh 0.
template <int V>
__device__ __forceinline__ void load_batch(const Segments& s, long long i0,
                                           int n, int r0,
                                           float (&v)[kRows][kCols],
                                           float (&g)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + u;
    const bool live = r < s.R;
    const bool first = r < s.C;
    const float* row = first ? s.W + static_cast<long long>(r) * s.N
                             : s.W2 + static_cast<long long>(r - s.C) * s.N;
    g[u] = live ? __ldg(first ? s.gamma + r : s.gamma2 + (r - s.C)) : 0.f;
    load_cols<V, true>(row + i0, n, live, v[u]);
  }
}

__device__ __forceinline__ void fma_batch(const float (&v)[kRows][kCols],
                                          const float (&g)[kRows],
                                          float (&acc)[kCols]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = fmaf(g[u], v[u][j], acc[j]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
fed_agg_kernel(Segments s, const float* base, float bw, float* out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (i0 >= s.N) return;
  const int n = static_cast<int>(min(static_cast<long long>(kCols), s.N - i0));
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float b[kCols];
  load_cols<V, false>(base + i0, n, base != nullptr, b);
  float va[kRows][kCols], vb[kRows][kCols], ga[kRows], gb[kRows];
  load_batch<V>(s, i0, n, 0, va, ga);
  for (int r0 = 0; r0 < s.R; r0 += 2 * kRows) {
    load_batch<V>(s, i0, n, r0 + kRows, vb, gb);
    fma_batch(va, ga, acc);
    if (r0 + kRows >= s.R) break;
    load_batch<V>(s, i0, n, r0 + 2 * kRows, va, ga);
    fma_batch(vb, gb, acc);
  }
  if (base != nullptr) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = fmaf(bw, b[j], acc[j]);
  }
  float* o = out + i0;
#pragma unroll
  for (int j = 0; j < kCols; j += V) {
    if (j < n) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(o + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(o + j) = make_float2(acc[j], acc[j + 1]);
      } else {
        o[j] = acc[j];
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// The widest vector (in floats) that every row start is aligned to.
int vector_width(const float* W, const float* W2, const float* base,
                 const float* out, long long N) {
  for (int v = 4; v > 1; v /= 2) {
    const int bytes = v * static_cast<int>(sizeof(float));
    if (N % v == 0 && aligned(W, bytes) && aligned(W2, bytes) &&
        aligned(base, bytes) && aligned(out, bytes))
      return v;
  }
  return 1;
}

}  // namespace

extern "C" {

// W (C, N) and W2 (C2, N) row-major, gamma (C,), gamma2 (C2,), base (N,) or
// null, out (N,); all f32 on the current device.  C2 = 0 (W2 and gamma2
// may then be null) is the one-segment call.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success); it does not
// synchronise.
int fed_agg_launch(const float* W, const float* gamma, int C,
                   const float* W2, const float* gamma2, int C2,
                   const float* base, float bw, float* out, long long N,
                   void* stream) {
  if (C < 0 || C2 < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (C == 0) W = gamma = nullptr;
  if (C2 == 0) W2 = gamma2 = nullptr;
  const Segments s{W, gamma, C, W2, gamma2, C + C2, N};
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const unsigned n = static_cast<unsigned>((N + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vector_width(W, W2, base, out, N)) {
    case 4: fed_agg_kernel<4><<<n, kThreads, 0, st>>>(s, base, bw, out); break;
    case 2: fed_agg_kernel<2><<<n, kThreads, 0, st>>>(s, base, bw, out); break;
    default: fed_agg_kernel<1><<<n, kThreads, 0, st>>>(s, base, bw, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fed_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
