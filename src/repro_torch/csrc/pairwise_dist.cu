// pairwise_dist_sq: D[i][j] = max(n_i + n_j - 2 G[i][j], 0) over M rows of
// length N, with G = X X^T and n_i = G[i][i].  Row 0 may come from its own
// pointer (`ref`: the grouping step's w0) beside the (M - 1, N) stack of
// rows 1..M-1, so the distance to a reference needs no concatenation.
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py, pairwise_dist_sq
// (_pdist_kernel).
//
// What bounds it on an H100: bytes up to M of about 79.  The rows are read
// once, M N 4 bytes over 3.35 TB/s (0.5 us at the grouping shape M = 2,
// N = 206,922); the M (M + 1) / 2 dot products cost M (M + 1) N flops at
// the f32 rate of 67 TFLOP/s (13.3 us at M = 65, beside 16.1 us of bytes).
//
// Precision, both designs: each CTA sums its columns in f32 (FMAs, or
// the tensor cores' f32 accumulators) and writes its partial Gram to its
// own workspace slot; the slots are then summed in double in a fixed
// order, and n_i + n_j - 2 G is formed in double before rounding to f32,
// so close rows (a partial model beside w0) lose no digits to that
// cancellation beyond the partial sums.  No atomic touches a sum, so the
// result is bit-equal from call to call.
//
// Few rows (M <= kFewMax: the grouping shape), one launch.  Each thread
// takes 2 columns of every row into registers (one float2 a row where the
// rows are 8-byte aligned) and accumulates all M (M + 1) / 2 pair sums in
// registers; the CTA adds its threads' sums up (warp butterflies, then the
// warps in order) into its slot.  The TPU kernel finalises D on its last
// grid step; here each CTA then takes a ticket from a counter after a
// __threadfence(), and the CTA that draws the last ticket sums every slot,
// writes D and resets the counter to 0 for the next call.  The counter is
// a word the caller allocates and zeroes once, not per call.
//
// Many rows, a register-tiled Gram, three launches.  Rows are cut into
// blocks (one block of M rounded up to 16 rows for M <= kOneBlockMax, else
// blocks of 64); the grid is (block pairs bi <= bj) x (column splits).  A
// CTA streams its split's columns through shared memory in stages of kTC
// columns by cp.async, with the padded rows of each block zeroed.  Each
// warp owns up to kMaxWarpTiles 16 x 16 tiles of the pair's Gram
// (upper-triangle tiles only on a diagonal pair) and accumulates them in
// registers on the tensor cores: mma.sync.m16n8k8 in 3xTF32 (each f32
// operand split x = hi + lo, hi.hi + hi.lo + lo.hi summed), the fragments
// read from shared memory without bank conflicts, each 4-byte read
// feeding 8 of the Gram's multiply-adds.  (f32 FMAs from a thread's 4 x 4
// tile are bound by shared-memory reads instead: a 16-byte read feeds 16
// multiply-adds.)  The tensor core's accumulator truncates, so each
// stage's products start from a fresh accumulator that is then added to
// the split's f32 sum.  The CTA writes its tiles' partials to its split's
// slot; a second launch sums the slots of each pair in double (32 pairs a
// CTA, 8 lanes a pair, then the lanes in order), a third forms D, one
// thread an element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFewMax = 8;        // the register design's largest M
constexpr int kFewCols = 2;       // columns a thread takes a step
constexpr int kOneBlockMax = 128; // one block: 36 warp tiles, 5 a warp
constexpr int kBlockRows = 64;    // above that, blocks of 64 rows
constexpr int kMaxWarpTiles = 5;
constexpr int kTC = 64;           // columns a shared-memory stage
constexpr int kStages = 2;        // stages in the cp.async ring (3 and 4
                                  // were no faster: the products bound it)
constexpr int kLd = kTC + 4;      // row stride in floats: fragment reads
                                  // (row g, column t) hit bank 4g + t
constexpr int kFinishPairs = 32;  // pairs a finishing CTA
constexpr int kFinishLanes = kThreads / kFinishPairs;
constexpr long long kMaxSlotFloats = 1LL << 22;   // 16 MB of partials

struct Rows {         // row i of the input: ref for i = 0 where given
  const float* X;
  const float* ref;
  long long N;
  __device__ __forceinline__ const float* row(int i) const {
    if (ref != nullptr)
      return i == 0 ? ref : X + static_cast<long long>(i - 1) * N;
    return X + static_cast<long long>(i) * N;
  }
};

__host__ __device__ __forceinline__ long long pairs(int M) {
  return static_cast<long long>(M) * (M + 1) / 2;
}

// Row-major index of the upper-triangle pair (i, j), i <= j.
__device__ __forceinline__ long long pair_index(int i, int j, int M) {
  return static_cast<long long>(i) * M - static_cast<long long>(i) * (i - 1) / 2
         + (j - i);
}

// D from the pair sums g (upper triangle, double, in shared memory), by
// the whole CTA.
__device__ void write_dist(const double* g, int M, float* D) {
  for (int e = threadIdx.x; e < M * M; e += blockDim.x) {
    const int i = e / M;
    const int j = e - i * M;
    const double d = g[pair_index(i, i, M)] + g[pair_index(j, j, M)] -
                     2.0 * g[pair_index(min(i, j), max(i, j), M)];
    D[e] = d > 0.0 ? static_cast<float>(d) : 0.f;
  }
}

// ---- few rows ------------------------------------------------------------

// The last CTA's sum of `slots` slots of P pairs into gsum, in double: a
// power-of-two team of lanes a pair strides over the slots, then the team
// adds up in a fixed tree.  P <= kThreads.
__device__ void sum_slots(const float* ws, int slots, int P, double* tmp,
                          double* gsum) {
  int lanes = 1;
  while (lanes * 2 * P <= kThreads) lanes *= 2;
  const int grp = threadIdx.x / lanes;
  const int lane = threadIdx.x - grp * lanes;
  double s = 0.0;
  if (grp < P)
    for (int k = lane; k < slots; k += lanes)
      s += static_cast<double>(
          __ldcg(ws + static_cast<long long>(k) * P + grp));
  tmp[threadIdx.x] = s;
  __syncthreads();
  for (int half = lanes / 2; half > 0; half /= 2) {
    if (lane < half) tmp[threadIdx.x] += tmp[threadIdx.x + half];
    __syncthreads();
  }
  if (lane == 0 && grp < P) gsum[grp] = tmp[threadIdx.x];
  __syncthreads();
}

template <int M, int V>
__global__ void __launch_bounds__(kThreads)
gram_few_kernel(Rows rows, float* __restrict__ ws, unsigned* counter,
                float* __restrict__ D) {
  constexpr int P = M * (M + 1) / 2;
  __shared__ float warp_sum[kWarps][P];
  __shared__ double tmp[kThreads];
  __shared__ double gsum[P];
  __shared__ bool last;
  const long long N = rows.N;
  const float* rp[M];
#pragma unroll
  for (int i = 0; i < M; ++i) rp[i] = rows.row(i);
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  const long long step =
      static_cast<long long>(gridDim.x) * kThreads * kFewCols;
  for (long long c = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * kFewCols; c < N; c += step) {
    float x[M][kFewCols];
    const bool second = c + 1 < N;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if constexpr (V == 2) {      // N is even: both columns are there
        const float2 t = __ldg(reinterpret_cast<const float2*>(rp[i] + c));
        x[i][0] = t.x;
        x[i][1] = t.y;
      } else {
        x[i][0] = __ldg(rp[i] + c);
        x[i][1] = second ? __ldg(rp[i] + c + 1) : 0.f;
      }
    }
    int p = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j, ++p) {
        acc[p] = fmaf(x[i][0], x[j][0], acc[p]);
        acc[p] = fmaf(x[i][1], x[j][1], acc[p]);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sum[warp][p] = v;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += warp_sum[w][threadIdx.x];
    ws[static_cast<long long>(blockIdx.x) * P + threadIdx.x] = v;
    __threadfence();      // the slot is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_slots(ws, gridDim.x, P, tmp, gsum);
  write_dist(gsum, M, D);
  if (threadIdx.x == 0) *counter = 0u;
}

// ---- many rows -----------------------------------------------------------

struct TilePlan {
  int M;
  int Bk;           // rows a block, a multiple of 16
  int nb;           // blocks
  long long chunk;  // columns a split, a multiple of kTC
  long long N;
};

// Rows of shared memory a stage: one block, or blocks bi and bj.
__host__ __device__ __forceinline__ int stage_rows(const TilePlan& tp) {
  return (tp.nb == 1 ? 1 : 2) * tp.Bk;
}

// Asynchronous copy of V floats global -> shared (zero-filled when !valid).
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(4 * V), "r"(valid ? 4 * V : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (an integer
// add-and-mask), lo = x - hi exactly in f32; the tensor core reads lo's
// top 19 bits.  Volatile, so that the compiler keeps the split next to
// its use.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile(
      "{\n\t.reg .b32 t;\n\tadd.u32 t, %2, 4096;\n\t"
      "and.b32 %0, t, -8192;\n\tsub.f32 %1, %3, %0;\n\t}"
      : "=r"(hi), "=r"(lo) : "r"(__float_as_uint(x)), "f"(x));
}

// d += a (16x8, row) b (8x8, col), TF32 in, f32 accumulate.  Fragments as
// in the PTX ISA's m16n8k8 .tf32 layout, with g = lane / 4, t = lane % 4:
// a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g); d[0..1] (g, 2t..2t + 1), d[2..3] (g + 8, ..).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T warp tiles a warp (16 rows of block bi against 16 rows of block bj);
// warps with fewer real tiles repeat tile 0 and write nothing for it.
template <int V, int T>
__global__ void __launch_bounds__(kThreads, T <= 3 ? 2 : 1)
gram_tiled_kernel(Rows rows, TilePlan tp, float* __restrict__ ws) {
  extern __shared__ __align__(16) float smem[];
  const int M = tp.M;
  const int Bk = tp.Bk;
  // this CTA's block pair, bi <= bj
  int bi = 0;
  int q = blockIdx.x;
  while (q >= tp.nb - bi) {
    q -= tp.nb - bi;
    ++bi;
  }
  const int bj = bi + q;
  const bool diag = bi == bj;
  const int vi = min(Bk, M - bi * Bk);     // valid rows of each block
  const int vj = min(Bk, M - bj * Bk);
  const int nu = (vi + 15) / 16;           // 16-row sub-blocks with a row
  const int nv = (vj + 15) / 16;
  const int tiles = diag ? nu * (nu + 1) / 2 : nu * nv;
  const int srows = stage_rows(tp);
  const int stage_floats = srows * kLd;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int g = (t & 31) >> 2;
  const int tq = t & 3;

  // this warp's tiles (u, v): sub-block u of bi against v of bj
  int tu[T], tv[T], offa[T], offb[T];
  bool real[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int tau = warp + kWarps * k;
    real[k] = tau < tiles;
    int u = 0, v = 0;
    if (real[k]) {
      if (diag) {               // column v of the triangle holds u = 0..v
        int w = tau;
        while (w > v) {
          w -= v + 1;
          ++v;
        }
        u = w;
      } else {
        u = tau % nu;
        v = tau / nu;
      }
    }
    tu[k] = u;
    tv[k] = v;
    offa[k] = (16 * u + g) * kLd + tq;
    offb[k] = ((diag ? 0 : Bk) + 16 * v + g) * kLd + tq;
  }

  // zero the padded rows of every stage (cp.async never writes them)
  for (int idx = t; idx < kStages * srows * kTC; idx += kThreads) {
    const int st = idx / (srows * kTC);
    const int rem = idx - st * srows * kTC;
    const int r = rem / kTC;
    const bool pad = r < Bk ? r >= vi : r - Bk >= vj;
    if (pad) smem[st * stage_floats + r * kLd + (rem - r * kTC)] = 0.f;
  }

  const long long c_begin = static_cast<long long>(blockIdx.y) * tp.chunk;
  const long long c_end = min(c_begin + tp.chunk, tp.N);
  const int nstages = c_end > c_begin
      ? static_cast<int>((c_end - c_begin + kTC - 1) / kTC) : 0;
  const int nload = diag ? vi : vi + vj;   // rows copied a stage
  constexpr int kVecs = kTC / V;           // copies a row a stage
  auto load_stage = [&](float* st, long long c0) {
    for (int idx = t; idx < nload * kVecs; idx += kThreads) {
      const int r = idx / kVecs;
      const int k = idx - r * kVecs;
      const bool in_a = r < vi;
      const float* src = rows.row(in_a ? bi * Bk + r : bj * Bk + (r - vi));
      const long long col = c0 + k * V;
      const bool ok = col < c_end;
      cp_async<V>(st + (in_a ? r : Bk + (r - vi)) * kLd + k * V,
                  ok ? src + col : src, ok);
    }
    cp_async_commit();
  };

  // acc: the split's sums (f32, rounded to nearest); the tensor core's
  // accumulator truncates, so each stage's products go to a fresh one
  float acc[T][2][4];
#pragma unroll
  for (int k = 0; k < T; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][h][e] = 0.f;
  // a ring of kStages buffers: kStages - 1 stages in flight while one is
  // multiplied (an empty group keeps the count where none is left)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nstages)
      load_stage(smem + st * stage_floats,
                 c_begin + static_cast<long long>(st) * kTC);
    else
      cp_async_commit();
  }
  for (int it = 0; it < nstages; ++it) {
    cp_async_wait<kStages - 2>();   // stage it has landed (this thread's)
    __syncthreads();                // every thread's, and stage it - 1 is done
    const int next = it + kStages - 1;
    if (next < nstages)
      load_stage(smem + (next % kStages) * stage_floats,
                 c_begin + static_cast<long long>(next) * kTC);
    else
      cp_async_commit();
    const float* cur = smem + (it % kStages) * stage_floats;
    float part[T][2][4];
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[k][h][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kTC; k0 += 8) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const float* A = cur + offa[k] + k0;
        const float* B = cur + offb[k] + k0;
        uint32_t ah[4], al[4];
        split(A[0], ah[0], al[0]);
        split(A[8 * kLd], ah[1], al[1]);
        split(A[4], ah[2], al[2]);
        split(A[8 * kLd + 4], ah[3], al[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bh0, bl0, bh1, bl1;
          split(B[8 * h * kLd], bh0, bl0);
          split(B[8 * h * kLd + 4], bh1, bl1);
          mma_tf32(part[k][h], al, bh0, bh1);
          mma_tf32(part[k][h], ah, bl0, bl1);
          mma_tf32(part[k][h], ah, bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][h][e] += part[k][h][e];
  }

  float* slot = ws + static_cast<long long>(blockIdx.y) * pairs(M);
#pragma unroll
  for (int k = 0; k < T; ++k) {
    if (!real[k]) continue;
    const int u = tu[k];
    const int v = tv[k];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = 16 * u + g + (e >> 1) * 8;
        const int rj = 16 * v + 8 * h + 2 * tq + (e & 1);
        if (ri >= vi || rj >= vj) continue;
        if (diag && u == v && ri > rj) continue;   // (u, u) holds both orders
        slot[pair_index(bi * Bk + ri, bj * Bk + rj, M)] = acc[k][h][e];
      }
    }
  }
}

// Pair sums: one CTA a run of kFinishPairs consecutive pairs, kFinishLanes
// lanes a pair; lane l sums slots l, l + kFinishLanes, ... in double (the
// CTA reads each slot's run of pairs as one coalesced line), then the lanes
// add up in order.
__global__ void __launch_bounds__(kThreads)
gram_sum_kernel(const float* __restrict__ ws, int slots, long long P,
                double* __restrict__ g) {
  __shared__ double tmp[kFinishLanes][kFinishPairs];
  const int pl = threadIdx.x % kFinishPairs;
  const int lane = threadIdx.x / kFinishPairs;
  const long long p = static_cast<long long>(blockIdx.x) * kFinishPairs + pl;
  double s = 0.0;
  if (p < P) {
#pragma unroll 8
    for (int k = lane; k < slots; k += kFinishLanes)
      s += static_cast<double>(ws[static_cast<long long>(k) * P + p]);
  }
  tmp[lane][pl] = s;
  __syncthreads();
  if (lane == 0 && p < P) {
    double v = 0.0;
    for (int l = 0; l < kFinishLanes; ++l) v += tmp[l][pl];
    g[p] = v;
  }
}

// D[i][j] from the pair sums, one thread an element.
__global__ void __launch_bounds__(kThreads)
dist_kernel(const double* __restrict__ g, int M, float* __restrict__ D) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(M) * M) return;
  const int i = static_cast<int>(e / M);
  const int j = static_cast<int>(e - static_cast<long long>(i) * M);
  const double d = g[pair_index(i, i, M)] + g[pair_index(j, j, M)] -
                   2.0 * g[pair_index(min(i, j), max(i, j), M)];
  D[e] = d > 0.0 ? static_cast<float>(d) : 0.f;
}

// ---- host ----------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

struct Plan {
  bool few;
  int slots;        // CTAs writing partials (few: the grid; tiled: splits)
  int block_pairs;
  int warp_tiles;   // tiled: warp tiles a warp, at most kMaxWarpTiles
  TilePlan tp;
  long long g_offset;   // bytes: the tiled design's pair sums (double)
  long long ws_bytes;
};

Plan make_plan(int M, long long N) {
  Plan p{};
  const long long P = pairs(M);
  p.few = M <= kFewMax;
  if (p.few) {
    const long long per = static_cast<long long>(kThreads) * kFewCols;
    long long ctas = (N + per - 1) / per;
    ctas = ctas < 4LL * sm_count() ? ctas : 4LL * sm_count();
    p.slots = static_cast<int>(ctas > 0 ? ctas : 1);
    p.ws_bytes = p.slots * P * static_cast<long long>(sizeof(float));
    return p;
  }
  TilePlan& tp = p.tp;
  tp.M = M;
  tp.N = N;
  if (M <= kOneBlockMax) {
    tp.Bk = (M + 15) / 16 * 16;
    tp.nb = 1;
  } else {
    tp.Bk = kBlockRows;
    tp.nb = (M + kBlockRows - 1) / kBlockRows;
  }
  const int sub = tp.Bk / 16;
  const int most = tp.nb == 1 ? sub * (sub + 1) / 2 : sub * sub;
  p.warp_tiles = (most + kWarps - 1) / kWarps;
  p.block_pairs = tp.nb * (tp.nb + 1) / 2;
  const long long tiles = N > 0 ? (N + kTC - 1) / kTC : 1;
  // two CTAs an SM (one wave) for one block; with several block pairs,
  // whose work differs (a diagonal pair has fewer tiles, the last block
  // fewer rows), eight (four waves), so that SMs that finish early take
  // more
  const long long per_sm = p.block_pairs == 1 ? 2 : 8;
  long long want = (per_sm * sm_count() + p.block_pairs - 1) / p.block_pairs;
  const long long cap = kMaxSlotFloats / P;
  if (want > cap) want = cap;
  if (want > tiles) want = tiles;
  if (want < 1) want = 1;
  const long long per = (tiles + want - 1) / want;
  tp.chunk = per * kTC;
  p.slots = static_cast<int>((tiles + per - 1) / per);
  p.g_offset = (p.slots * P * static_cast<long long>(sizeof(float)) + 255) /
               256 * 256;
  p.ws_bytes = p.g_offset + P * static_cast<long long>(sizeof(double));
  return p;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <int M>
void launch_few(const Rows& rows, int ctas, bool pairs_of_floats, float* ws,
                unsigned* counter, float* D, cudaStream_t s) {
  if (pairs_of_floats)
    gram_few_kernel<M, 2><<<ctas, kThreads, 0, s>>>(rows, ws, counter, D);
  else
    gram_few_kernel<M, 1><<<ctas, kThreads, 0, s>>>(rows, ws, counter, D);
}

template <int V, int T>
cudaError_t launch_tiled(const Rows& rows, const Plan& p, float* ws,
                         cudaStream_t s) {
  const int bytes =
      kStages * stage_rows(p.tp) * kLd * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      gram_tiled_kernel<V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.block_pairs, p.slots);
  gram_tiled_kernel<V, T><<<grid, kThreads, bytes, s>>>(rows, p.tp, ws);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_tiled(const Rows& rows, const Plan& p, float* ws,
                         cudaStream_t s) {
  switch (p.warp_tiles) {
    case 1: return launch_tiled<V, 1>(rows, p, ws, s);
    case 2: return launch_tiled<V, 2>(rows, p, ws, s);
    case 3: return launch_tiled<V, 3>(rows, p, ws, s);
    case 4: return launch_tiled<V, 4>(rows, p, ws, s);
    case 5: return launch_tiled<V, 5>(rows, p, ws, s);
    default: return cudaErrorInvalidValue;
  }
  static_assert(kMaxWarpTiles == 5, "add launch_tiled cases");
}

}  // namespace

extern "C" {

// Bytes of workspace pairwise_dist_launch needs for M rows of N on the
// current device.
long long pairwise_dist_workspace_bytes(int M, long long N) {
  if (M < 1 || N < 0) return 0;
  return make_plan(M, N).ws_bytes;
}

// Rows: ref (N,) as row 0 and X (M - 1, N) as rows 1..M-1 when ref is not
// null, else X (M, N); row-major f32.  ws of
// pairwise_dist_workspace_bytes(M, N) bytes; counter one unsigned word
// that is 0 (the few-rows kernel leaves it 0); D (M, M) f32; all on the
// current device.  M <= kFewMax takes the few-rows design (one launch),
// more rows the tiled one (three launches).  Launches on `stream` and
// returns the first launch error (0 on success); it does not synchronise.
int pairwise_dist_launch(const float* X, const float* ref, int M, long long N,
                         void* ws, unsigned* counter, float* D, void* stream) {
  if (M < 1 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N);
  const Rows rows{X, ref, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool even = N % 2 == 0 && aligned(X, 8) && aligned(ref, 8);
  float* wsf = static_cast<float*>(ws);
  if (p.few) {
    switch (M) {
      case 1: launch_few<1>(rows, p.slots, even, wsf, counter, D, s); break;
      case 2: launch_few<2>(rows, p.slots, even, wsf, counter, D, s); break;
      case 3: launch_few<3>(rows, p.slots, even, wsf, counter, D, s); break;
      case 4: launch_few<4>(rows, p.slots, even, wsf, counter, D, s); break;
      case 5: launch_few<5>(rows, p.slots, even, wsf, counter, D, s); break;
      case 6: launch_few<6>(rows, p.slots, even, wsf, counter, D, s); break;
      case 7: launch_few<7>(rows, p.slots, even, wsf, counter, D, s); break;
      case 8: launch_few<8>(rows, p.slots, even, wsf, counter, D, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    static_assert(kFewMax == 8, "add launch_few cases");
    return static_cast<int>(cudaGetLastError());
  }
  const bool quad = N % 4 == 0 && aligned(X, 16) && aligned(ref, 16);
  cudaError_t e = quad ? launch_tiled<4>(rows, p, wsf, s)
                : even ? launch_tiled<2>(rows, p, wsf, s)
                       : launch_tiled<1>(rows, p, wsf, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long P = pairs(M);
  double* g = reinterpret_cast<double*>(static_cast<char*>(ws) + p.g_offset);
  const unsigned sum_ctas =
      static_cast<unsigned>((P + kFinishPairs - 1) / kFinishPairs);
  gram_sum_kernel<<<sum_ctas, kThreads, 0, s>>>(wsf, p.slots, P, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long MM = static_cast<long long>(M) * M;
  dist_kernel<<<static_cast<unsigned>((MM + kThreads - 1) / kThreads), kThreads,
                0, s>>>(g, M, D);
  return static_cast<int>(cudaGetLastError());
}

const char* pairwise_dist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
