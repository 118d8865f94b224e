// chunk_scan: the chunked linear recurrence under RWKV6 and Mamba2-SSD
//
//   S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T        (S is K x V, f32)
//   y_t = r_t . S_t                                   Mamba2 (include_current)
//   y_t = r_t . S_{t-1} + (r_t * u . k_t) v_t         RWKV6 (bonus u)
//
// Replaces: src/repro/kernels/chunk_scan/kernel.py, chunk_scan_flat
// (_chunk_kernel), in both modes.  The clamp of the log-decay to [-1, 0]
// (and the broadcast of a scalar per-head decay) stays in the wrapper, as
// in the JAX package.
//
// Layout: r, k and ld (B, T, H, K), v (B, T, H, V), read through their
// four strides each (the model's projections go in without a copy); s0
// and s_fin (B, H, K, V) f32 contiguous; u (H, K) f32 contiguous (RWKV6
// mode only); y (B, T, H, V) contiguous in r/k/v's dtype (f32 or bf16,
// widened to f32 on load).  All arithmetic is f32 on the FMA units.
//
// Per chunk of Lc steps, with L the inclusive cumulative log-decay and M_t
// = L_t (Mamba2) or L_{t-1} (RWKV6):
//   y_cross = (r exp(M)) S;   y_intra[t] = sum_{s<t | s<=t} A[t,s] v_s;
//   A[t,s]  = sum_k r_tk k_sk exp(M_tk - L_sk);
//   S       = exp(L_end) S + sum_s (k_s exp(L_end - L_s)) v_s^T.
// The TPU kernel factors A as (r exp(M)) . (k exp(-L)); at Lc = 128 and
// decays at the clamp, exp(-L) passes f32's range while exp(M) underflows,
// and A holds 0 * inf = NaN.  Here the query rows go in sub-blocks of 16,
// and sub-block i factors A with exponents relative to the exclusive
// cumulative sum Lref_i at its first row:
//   A[t,s] = (r_t exp(M_t - Lref_i)) . (k_s exp(Lref_i - L_s)),
// so no factor exceeds exp(16); a key factor that underflows to 0 stands
// for a term below f32's range.  The cross term is (r exp(M - Lref_i))
// times exp(Lref_i), both at most 1.
//
// What bounds it on an H100: operations.  At the serving shape (B 4, T
// 2048, H 64, K = V = 64, chunk 128, bf16) the work the masks keep is
// 2 (Lc K V + Lc (Lc - 1) / 2 (K + V) + K Lc V) flops a chunk and head,
// 1.71e10 in all: 0.255 ms at the f32 FMA peak of 67 TFLOP/s, against
// 0.123 ms to move r, k, v, y (bf16) and ld (f32) once.
//
// Design: no sequential grid.  Where Pallas carries the state across an
// innermost sequential grid axis in VMEM, each CTA here owns one
// (batch, head) and 64 of its V columns, walks the chunks in order and
// keeps its (K, 64) slice of the state in shared memory.  The columns of
// S and y are independent, so V > 64 splits across CTAs, each recomputing
// A.  One chunk's r, k, L, the key factors (Lc x K each) and v (Lc x 64)
// sit in shared memory in f32 (199 KB at the maxima K 64, Lc 128: one CTA
// an SM).  256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns
// columns 4 tx .. 4 tx + 3 of row 16 p + ty of every sub-block p, so its
// 32 accumulators of y stay in registers from the intra term through the
// cross term and the bonus.  Rows of r, k, L and the key factors are
// padded to 68 floats so that the 16-row float4 reads of A's key factors
// hit distinct banks.  A chunk arrives by 16-byte loads widened to f32
// when every operand has a unit channel stride and 16-byte aligned rows
// (the model's projections: a quarter less time than element loads at the
// serving shape), by element loads otherwise.  The inclusive cumsum runs
// as 4 segments a channel with a second pass adding the segment totals.
// Not done yet: tensor
// cores (the products are TF32-free f32 by contract), a deeper overlap of
// the next chunk's loads with this chunk's math, and smaller tiles for
// more than one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kMaxL = 128;
constexpr int kVT = 64;                 // V columns per CTA
constexpr int kSB = 16;                 // query rows per sub-block
constexpr int kNSB = kMaxL / kSB;       // sub-blocks per chunk, at most
constexpr int kLDK = kMaxK + 4;         // row stride of the (Lc, K) tiles
constexpr int kLDA = kMaxL + 16;        // row stride of A (16, Lc)
constexpr int kSegs = 4;                // cumsum segments per channel

constexpr int kOffR = 0;
constexpr int kOffK = kOffR + kMaxL * kLDK;
constexpr int kOffL = kOffK + kMaxL * kLDK;
constexpr int kOffKp = kOffL + kMaxL * kLDK;
constexpr int kOffV = kOffKp + kMaxL * kLDK;
constexpr int kOffA = kOffV + kMaxL * kVT;
constexpr int kOffS = kOffA + kSB * kLDA;
constexpr int kOffD = kOffS + kMaxK * kVT;
constexpr int kOffTot = kOffD + kMaxL;
constexpr int kSmemFloats = kOffTot + kSegs * kMaxK;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* ld;
  const float* s0;
  const float* u;
  void* y;
  float* sfin;
  int T, H, K, V, Lc, include_current;
  int vec;                                // 16-byte loads (see the launch)
  long long rs[4], ks[4], vs[4], ls[4];   // element strides b, t, h, channel
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&x)[4]) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] =
      __floats2bfloat162_rn(x[0], x[1]);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] =
      __floats2bfloat162_rn(x[2], x[3]);
}

// 16 bytes of T as floats: 4 of f32, 8 of bf16
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[e] += a * b[e]
__device__ __forceinline__ void axpy4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_scan_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Rs = sm + kOffR;     // r, then r exp(M - Lref), then r exp(M)
  float* Ks = sm + kOffK;     // k
  float* Ls = sm + kOffL;     // ld, then its inclusive cumsum L
  float* Kp = sm + kOffKp;    // key factors k exp(Lref - L), k exp(Lend - L)
  float* Vs = sm + kOffV;     // v, this CTA's 64 columns
  float* As = sm + kOffA;     // A of one sub-block (16, Lc)
  float* Ss = sm + kOffS;     // the state (K, 64)
  float* Ds = sm + kOffD;     // the bonus term r_t * u . k_t
  float* Tot = sm + kOffTot;  // cumsum segment totals

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int v0 = blockIdx.y * kVT;
  const int Vw = min(kVT, p.V - v0);
  const int K = p.K, Lc = p.Lc;
  const int nsb = (Lc + kSB - 1) / kSB;
  const bool rwkv = !p.include_current;
  const int j0 = 4 * tx;            // this thread's 4 columns
  const bool jok = j0 < Vw;         // V % 4 == 0: all four or none

  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2] +
                v0 * p.vs[3];
  const float* lg = p.ld + b * p.ls[0] + h * p.ls[2];
  const float* ug = rwkv ? p.u + static_cast<long long>(h) * K : nullptr;
  T* yg = static_cast<T*>(p.y) +
          (static_cast<long long>(b) * p.T * p.H + h) * p.V + v0 + j0;
  const long long y_row = static_cast<long long>(p.H) * p.V;

  for (int i = tid; i < K * kVT; i += kThreads) {
    const int c = i / kVT, j = i - c * kVT;
    Ss[c * kVT + j] =
        j < Vw ? p.s0[(static_cast<long long>(bh) * K + c) * p.V + v0 + j]
               : 0.f;
  }

  for (int t0 = 0; t0 < p.T; t0 += Lc) {
    __syncthreads();   // the last chunk is done with every buffer
    if (p.vec) {
      constexpr int E = 16 / sizeof(T);
      const int kq = K / E, vq = kVT / E;
      for (int i = tid; i < Lc * kq; i += kThreads) {
        const int t = i / kq, c = (i - t * kq) * E;
        const long long tt = t0 + t;
        widen16(rg + tt * p.rs[1] + c, Rs + t * kLDK + c);
        widen16(kg + tt * p.ks[1] + c, Ks + t * kLDK + c);
      }
      for (int i = tid; i < Lc * (K / 4); i += kThreads) {
        const int t = i / (K / 4), c = (i - t * (K / 4)) * 4;
        widen16(lg + (t0 + t) * p.ls[1] + c, Ls + t * kLDK + c);
      }
      for (int i = tid; i < nsb * kSB * vq; i += kThreads) {
        const int t = i / vq, j = (i - t * vq) * E;
        if (t < Lc && j < Vw) {
          widen16(vg + (t0 + t) * p.vs[1] + j, Vs + t * kVT + j);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) Vs[t * kVT + j + e] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < Lc * K; i += kThreads) {
        const int t = i / K, c = i - t * K;
        const long long tt = t0 + t;
        Rs[t * kLDK + c] = to_f32(rg[tt * p.rs[1] + c * p.rs[3]]);
        Ks[t * kLDK + c] = to_f32(kg[tt * p.ks[1] + c * p.ks[3]]);
        Ls[t * kLDK + c] = lg[tt * p.ls[1] + c * p.ls[3]];
      }
      // v, zero past Vw and on the rows up to the last sub-block's end (the
      // intra term reads them, against zeros in A)
      for (int i = tid; i < nsb * kSB * kVT; i += kThreads) {
        const int t = i / kVT, j = i - t * kVT;
        Vs[t * kVT + j] = (j < Vw && t < Lc)
            ? to_f32(vg[(t0 + t) * p.vs[1] + j * p.vs[3]]) : 0.f;
      }
    }
    __syncthreads();

    // inclusive cumsum of ld over the chunk: 4 segments a channel, then
    // the totals of the earlier segments
    const int seglen = (Lc + kSegs - 1) / kSegs;
    const int sc = tid % K, sg = tid / K;
    const int slo = sg * seglen, shi = min(slo + seglen, Lc);
    if (tid < kSegs * K) {
      float run = 0.f;
      for (int t = slo; t < shi; ++t) {
        run += Ls[t * kLDK + sc];
        Ls[t * kLDK + sc] = run;
      }
      Tot[sg * kMaxK + sc] = run;
    }
    if (rwkv && tid < Lc) {   // the bonus, from r and k as loaded
      float d = 0.f;
      for (int c = 0; c < K; ++c)
        d = fmaf(Rs[tid * kLDK + c] * __ldg(ug + c), Ks[tid * kLDK + c], d);
      Ds[tid] = d;
    }
    __syncthreads();
    if (tid < kSegs * K && sg > 0) {
      float off = 0.f;
      for (int e = 0; e < sg; ++e) off += Tot[e * kMaxK + sc];
      for (int t = slo; t < shi; ++t) Ls[t * kLDK + sc] += off;
    }
    __syncthreads();

    // query factors r exp(M - Lref) of each row's sub-block
    for (int i = tid; i < Lc * K; i += kThreads) {
      const int t = i / K, c = i - t * K;
      const float M = !rwkv ? Ls[t * kLDK + c]
                            : (t ? Ls[(t - 1) * kLDK + c] : 0.f);
      const int a = (t / kSB) * kSB;
      const float ref = a ? Ls[(a - 1) * kLDK + c] : 0.f;
      Rs[t * kLDK + c] *= expf(M - ref);
    }

    float acc[kNSB][4];
#pragma unroll
    for (int q = 0; q < kNSB; ++q) acc[q][0] = acc[q][1] = acc[q][2] =
        acc[q][3] = 0.f;

    // the intra-chunk term, one sub-block of query rows at a time
#pragma unroll
    for (int sb = 0; sb < kNSB; ++sb) {
      if (sb < nsb) {
        const int a = sb * kSB, bend = min(a + kSB, Lc);
        for (int i = tid; i < bend * K; i += kThreads) {
          const int s = i / K, c = i - s * K;
          const float ref = a ? Ls[(a - 1) * kLDK + c] : 0.f;
          Kp[s * kLDK + c] = Ks[s * kLDK + c] * expf(ref - Ls[s * kLDK + c]);
        }
        __syncthreads();   // key factors (and the query factors) are in

        // A[ty][s] for s = tx + 16 m, m <= sb; masked entries are 0
        const int t = a + ty;
        float av[kNSB];
#pragma unroll
        for (int m = 0; m < kNSB; ++m) av[m] = 0.f;
        if (t < Lc) {
          const float* rrow = Rs + t * kLDK;
          for (int c = 0; c < K; c += 4) {
            const float4 rv = *reinterpret_cast<const float4*>(rrow + c);
#pragma unroll
            for (int m = 0; m <= sb; ++m)
              av[m] = dot4(rv, *reinterpret_cast<const float4*>(
                                   Kp + (tx + 16 * m) * kLDK + c), av[m]);
          }
        }
#pragma unroll
        for (int m = 0; m <= sb; ++m) {
          const int s = tx + 16 * m;
          const bool keep = t < Lc && s < bend && (rwkv ? s < t : s <= t);
          As[ty * kLDA + s] = keep ? av[m] : 0.f;
        }
        __syncthreads();   // A is in

        if (jok) {
          const float* arow = As + ty * kLDA;
          for (int s = 0; s < (sb + 1) * kSB; s += 4) {
            const float4 a4 = *reinterpret_cast<const float4*>(arow + s);
            axpy4(acc[sb], a4.x,
                  *reinterpret_cast<const float4*>(Vs + s * kVT + j0));
            axpy4(acc[sb], a4.y,
                  *reinterpret_cast<const float4*>(Vs + (s + 1) * kVT + j0));
            axpy4(acc[sb], a4.z,
                  *reinterpret_cast<const float4*>(Vs + (s + 2) * kVT + j0));
            axpy4(acc[sb], a4.w,
                  *reinterpret_cast<const float4*>(Vs + (s + 3) * kVT + j0));
          }
        }
        // the next sub-block writes Kp (read before the sync above) and,
        // after its own sync, A (read here): no barrier needed
      }
    }

    // query factors back to r exp(M) = (r exp(M - Lref)) exp(Lref)
    for (int i = tid; i < Lc * K; i += kThreads) {
      const int t = i / K, c = i - t * K;
      const int a = (t / kSB) * kSB;
      if (a) Rs[t * kLDK + c] *= expf(Ls[(a - 1) * kLDK + c]);
    }
    __syncthreads();

    // the cross-chunk term (r exp(M)) S, the bonus, and y
    if (jok) {
      for (int c = 0; c < K; c += 4) {
        const float4 s0 = *reinterpret_cast<const float4*>(Ss + c * kVT + j0);
        const float4 s1 =
            *reinterpret_cast<const float4*>(Ss + (c + 1) * kVT + j0);
        const float4 s2 =
            *reinterpret_cast<const float4*>(Ss + (c + 2) * kVT + j0);
        const float4 s3 =
            *reinterpret_cast<const float4*>(Ss + (c + 3) * kVT + j0);
#pragma unroll
        for (int q = 0; q < kNSB; ++q) {
          const int t = q * kSB + ty;
          if (t < Lc) {
            const float4 rv =
                *reinterpret_cast<const float4*>(Rs + t * kLDK + c);
            axpy4(acc[q], rv.x, s0);
            axpy4(acc[q], rv.y, s1);
            axpy4(acc[q], rv.z, s2);
            axpy4(acc[q], rv.w, s3);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kNSB; ++q) {
        const int t = q * kSB + ty;
        if (t < Lc) {
          if (rwkv)
            axpy4(acc[q], Ds[t],
                  *reinterpret_cast<const float4*>(Vs + t * kVT + j0));
          store4(yg + (t0 + t) * y_row, acc[q]);
        }
      }
    }

    // state: S = exp(Lend) S + (k exp(Lend - L))^T v
    for (int i = tid; i < Lc * K; i += kThreads) {
      const int s = i / K, c = i - s * K;
      Kp[s * kLDK + c] =
          Ks[s * kLDK + c] * expf(Ls[(Lc - 1) * kLDK + c] - Ls[s * kLDK + c]);
    }
    __syncthreads();   // key factors are in; every read of the old S is done
    if (jok) {
      float sacc[kMaxK / 16][4];
#pragma unroll
      for (int q = 0; q < kMaxK / 16; ++q) sacc[q][0] = sacc[q][1] =
          sacc[q][2] = sacc[q][3] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + s * kVT + j0);
#pragma unroll
        for (int q = 0; q < kMaxK / 16; ++q) {
          const int c = ty + 16 * q;
          if (c < K) axpy4(sacc[q], Kp[s * kLDK + c], vv);
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxK / 16; ++q) {
        const int c = ty + 16 * q;
        if (c < K) {
          const float dec = expf(Ls[(Lc - 1) * kLDK + c]);
          float* srow = Ss + c * kVT + j0;
#pragma unroll
          for (int e = 0; e < 4; ++e) srow[e] = fmaf(dec, srow[e], sacc[q][e]);
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < K * Vw; i += kThreads) {
    const int c = i / Vw, j = i - c * Vw;
    p.sfin[(static_cast<long long>(bh) * K + c) * p.V + v0 + j] =
        Ss[c * kVT + j];
  }
}

template <typename T>
int launch(const Params& p, int BH, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (p.V + kVT - 1) / kVT);
  chunk_scan_kernel<T><<<grid, kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, ld (B, T, H, K) and v (B, T, H, V) with 16 element strides in
// `strides` (batch, time, head, channel of r, k, v, ld); r, k, v of one
// dtype (0: f32, 1: bf16), ld f32 (already clamped).  s0 (B, H, K, V) f32,
// u (H, K) f32 (read only when !include_current), y (B, T, H, V) in the
// dtype and s_fin (B, H, K, V) f32, all contiguous on the current device.
// Needs 0 < K <= 64, K and V multiples of 4, 0 < Lc <= 128, T % Lc == 0.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it does not synchronise.
int chunk_scan_launch(const void* r, const void* k, const void* v,
                      const void* ld, const void* s0, const void* u,
                      void* y, void* sfin, int dtype, int B, int T, int H,
                      int K, int V, int Lc, int include_current,
                      const long long* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || K <= 0 || K > kMaxK || K % 4 != 0 ||
      V <= 0 || V % 4 != 0 || Lc <= 0 || Lc > kMaxL || T % Lc != 0 ||
      (!include_current && u == nullptr) ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (V + kVT - 1) / kVT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.ld = static_cast<const float*>(ld);
  p.s0 = static_cast<const float*>(s0);
  p.u = static_cast<const float*>(u);
  p.y = y;
  p.sfin = static_cast<float*>(sfin);
  p.T = T;
  p.H = H;
  p.K = K;
  p.V = V;
  p.Lc = Lc;
  p.include_current = include_current;
  for (int i = 0; i < 4; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[4 + i];
    p.vs[i] = strides[8 + i];
    p.ls[i] = strides[12 + i];
  }
  {   // 16-byte loads: unit channel strides, 16-byte aligned rows
    const int E = dtype == 1 ? 8 : 4;
    const auto al = [](const void* q) {
      return reinterpret_cast<uintptr_t>(q) % 16 == 0;
    };
    bool vec = K % E == 0 && V % E == 0 && al(r) && al(k) && al(v) && al(ld);
    for (int i = 0; i < 4; ++i) {
      const long long* st4 = strides + 4 * i;
      const int e = i == 3 ? 4 : E;
      vec = vec && st4[3] == 1 && st4[0] % e == 0 && st4[1] % e == 0 &&
            st4[2] % e == 0;
    }
    p.vec = vec;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B * H, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B * H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* chunk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
