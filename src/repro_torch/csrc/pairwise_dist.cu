// pairwise_dist_sq: D[i][j] = max(n_i + n_j - 2 G[i][j], 0) over the rows of
// X (M, N), with G = X X^T and n_i = G[i][i].
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py, pairwise_dist_sq
// (_pdist_kernel).
//
// What bounds it on an H100: at the grouping shapes (M = 2 .. 65 rows of
// N = 206,922) bytes: X is read once, M * N * 4 bytes over 3.35 TB/s.  The
// M (M + 1) / 2 dot products cost M (M + 1) N flops at the f32 rate of
// 67 TFLOP/s, which stays below the byte time up to M of about 40 and is
// of the same order at M = 65.
//
// Design: the TPU kernel walks N in order into one VMEM accumulator; copied
// as is, that would occupy one SM.  Pass 1 splits N over up to two CTAs per
// SM.  A CTA stages column tiles of X in shared memory (as wide as 48 KB
// allows, so at small M one tile covers the CTA's whole share of N and
// the CTA waits on memory once) and accumulates its partial Gram upper
// triangle in registers: the pairs are spread over the threads and, when
// there are fewer pairs than threads (small M), several lanes share a pair
// and split the tile's columns, then add up in a fixed order.  Each CTA
// writes its partials to its own workspace slot: no atomics, so the result
// is the same from run to run.  Pass 2 gives each pair one CTA, which sums
// the slots in double in a fixed order and forms n_i + n_j - 2 G in double
// before rounding to f32, so rows that are close (the grouping case: a
// partial model beside w0) lose no digits to that cancellation beyond the
// f32 partial sums of pass 1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 65;         // dist_to_ref's largest stack: 64 rows + ref
constexpr int kMaxPairsPerThread = (kMaxM * (kMaxM + 1) / 2 + kThreads - 1) / kThreads;
constexpr int kMaxTile = 1024;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kFinishThreads = 128;

struct Plan {
  int npairs;      // M (M + 1) / 2, upper triangle with the diagonal
  int lanes;       // threads sharing one pair (power of two)
  int ppt;         // pairs per thread
  int tile;        // columns staged per shared-memory tile
  int ctas;        // pass-1 CTAs = workspace slots
  long long chunk; // columns per CTA (a multiple of tile)
};

Plan make_plan(int M, long long N) {
  Plan p;
  p.npairs = M * (M + 1) / 2;
  p.lanes = 1;
  while (p.lanes * 2 * p.npairs <= kThreads) p.lanes *= 2;
  const int groups = kThreads / p.lanes;
  p.ppt = (p.npairs + groups - 1) / groups;
  p.tile = kMaxTile;
  while (p.tile > 32 && M * (p.tile + 1) * 4 > kSmemBytes) p.tile /= 2;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = N > 0 ? (N + p.tile - 1) / p.tile : 1;
  const long long want = tiles < 2LL * sms ? tiles : 2LL * sms;
  const long long tiles_per_cta = (tiles + want - 1) / want;
  p.chunk = tiles_per_cta * p.tile;
  p.ctas = static_cast<int>((tiles + tiles_per_cta - 1) / tiles_per_cta);
  return p;
}

// Row-major index of the upper-triangle pair (i, j), i <= j.
__device__ __forceinline__ int pair_index(int i, int j, int M) {
  return i * M - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ void pair_of(int p, int M, int* i, int* j) {
  int r = 0;
  while (p >= M - r) {
    p -= M - r;
    ++r;
  }
  *i = r;
  *j = r + p;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ X, int M, long long N,
                    int npairs, int lanes, int tile, long long chunk,
                    float* __restrict__ ws) {
  extern __shared__ float xs[];  // M rows of (tile + 1): the pad staggers banks
  const int t = threadIdx.x;
  const int lane = t % lanes;
  const int grp = t / lanes;
  const int groups = kThreads / lanes;
  const int ld = tile + 1;
  int pi[PPT], pj[PPT];
  float acc[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = grp + k * groups;
    if (p < npairs) {
      pair_of(p, M, &pi[k], &pj[k]);
    } else {
      pi[k] = pj[k] = 0;
    }
    acc[k] = 0.f;
  }
  const long long c_begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long c_end = c_begin + chunk < N ? c_begin + chunk : N;
  for (long long c0 = c_begin; c0 < c_end; c0 += tile) {
    const int width = static_cast<int>(c_end - c0 < tile ? c_end - c0 : tile);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = t; idx < M * tile; idx += kThreads) {
      const int r = idx / tile;
      const int c = idx - r * tile;
      xs[r * ld + c] = c < width ? __ldg(X + static_cast<long long>(r) * N + c0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (grp + k * groups < npairs) {
        const float* a = xs + pi[k] * ld;
        const float* b = xs + pj[k] * ld;
        float s = acc[k];
        for (int c = lane; c < width; c += lanes) s = fmaf(a[c], b[c], s);
        acc[k] = s;
      }
    }
  }
  float* slot = ws + static_cast<long long>(blockIdx.x) * npairs;
  if (lanes == 1) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = grp + k * groups;
      if (p < npairs) slot[p] = acc[k];
    }
    return;
  }
  // lanes > 1 means one pair per thread (PPT == 1): add the lanes up in
  // lane order through shared memory (M * ld >= kThreads floats)
  __syncthreads();
  xs[t] = acc[0];
  __syncthreads();
  if (lane == 0 && grp < npairs) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += xs[grp * lanes + l];
    slot[grp] = s;
  }
}

// One CTA per pair: its threads sum the slots in double, strided, then
// add the per-thread sums up in a fixed tree order (deterministic).
__global__ void __launch_bounds__(kFinishThreads)
dist_finish_kernel(const float* __restrict__ ws, int slots, int M, int npairs,
                   float* __restrict__ D) {
  __shared__ double red[3][kFinishThreads];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  int i, j;
  pair_of(p, M, &i, &j);
  const int pii = pair_index(i, i, M);
  const int pjj = pair_index(j, j, M);
  double g = 0.0, ni = 0.0, nj = 0.0;
  for (int s = t; s < slots; s += kFinishThreads) {
    const float* w = ws + static_cast<long long>(s) * npairs;
    g += w[p];
    ni += w[pii];
    nj += w[pjj];
  }
  red[0][t] = g;
  red[1][t] = ni;
  red[2][t] = nj;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half /= 2) {
    if (t < half) {
      red[0][t] += red[0][t + half];
      red[1][t] += red[1][t + half];
      red[2][t] += red[2][t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double d = red[1][0] + red[2][0] - 2.0 * red[0][0];
    const float out = d > 0.0 ? static_cast<float>(d) : 0.f;
    D[i * M + j] = out;
    D[j * M + i] = out;
  }
}

template <int PPT>
void launch_partial(const float* X, int M, long long N, const Plan& p,
                    float* ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * (p.tile + 1) * sizeof(float);
  gram_partial_kernel<PPT><<<p.ctas, kThreads, smem, stream>>>(
      X, M, N, p.npairs, p.lanes, p.tile, p.chunk, ws);
}

}  // namespace

extern "C" {

// Floats of workspace pairwise_dist_launch needs for an (M, N) input on the
// current device.
long long pairwise_dist_workspace_floats(int M, long long N) {
  const Plan p = make_plan(M, N);
  return static_cast<long long>(p.ctas) * p.npairs;
}

// X (M, N) row-major f32, ws of pairwise_dist_workspace_floats(M, N) floats,
// D (M, M) f32; all on the current device, 1 <= M <= 65.  Launches both
// passes on `stream` and returns the first launch error (0 on success); it
// does not synchronise.
int pairwise_dist_launch(const float* X, int M, long long N, float* ws,
                         float* D, void* stream) {
  if (M < 1 || M > kMaxM || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.ppt) {
    case 1: launch_partial<1>(X, M, N, p, ws, s); break;
    case 2: launch_partial<2>(X, M, N, p, ws, s); break;
    case 3: launch_partial<3>(X, M, N, p, ws, s); break;
    case 4: launch_partial<4>(X, M, N, p, ws, s); break;
    case 5: launch_partial<5>(X, M, N, p, ws, s); break;
    case 6: launch_partial<6>(X, M, N, p, ws, s); break;
    case 7: launch_partial<7>(X, M, N, p, ws, s); break;
    case 8: launch_partial<8>(X, M, N, p, ws, s); break;
    case 9: launch_partial<9>(X, M, N, p, ws, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxPairsPerThread <= 9, "add launch_partial cases");
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dist_finish_kernel<<<p.npairs, kFinishThreads, 0, s>>>(ws, p.ctas, M,
                                                          p.npairs, D);
  return static_cast<int>(cudaGetLastError());
}

const char* pairwise_dist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
