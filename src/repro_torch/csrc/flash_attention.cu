// flash_attention: out = softmax(q k^T / sqrt(hd) + mask) v, online softmax
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_flat (_flash_kernel), together with the KV-head repeat
// of its wrapper (ops.py): query head h reads KV head h / (H / KV) here.
//
// Layout: q and out (B, Sq, H, hd), k and v (B, Sk, KV, hd), read through
// their batch, sequence and head strides (the head dim is contiguous), so
// the model's projections go in without a transposed copy.  Masks, by row
// and column index: kpos < Sk; causal kpos <= qpos; window
// qpos - kpos < window.  Key blocks wholly outside the causal/window band
// are never visited: each CTA loops over its reachable key range only.
// The mask value is the TPU kernel's finite -1e30, not -inf: a reachable
// block can hold a row that is wholly masked (under a window), where
// exp(-1e30 - -1e30) = 1 fills the row's running sums with garbage that
// the next real block's correction factor exp(-1e30 - m) = 0 wipes; with
// -inf that step would be NaN.  The denominator is max(l, 1e-30), the
// output is written in q's dtype.
//
// What bounds it on an H100: operations.  At the serving path's prefill
// shape (B 4, S 2048, H 32, KV 8, hd 128, bf16, causal) one call does
// 4 * hd flops for each of the B * H * S (S + 1) / 2 unmasked (query, key)
// pairs, 1.37e11 flops: 0.14 ms at the bf16 tensor-core peak of 989
// TFLOP/s, against 0.05 ms to move q, k, v and out once (168 MB at
// 3.35 TB/s).  So the design puts both products on the tensor cores,
// keeps S, P and O out of device memory (q, k and v are read once a
// CTA, out written once), and visits only the key blocks the mask can
// reach, which halves a causal prefill's work.  What still keeps it from
// the bound: mma.sync issues at a fraction of wgmma's rate, P V costs
// twice its flops (P in two bf16 halves, below), and every warp re-reads
// the whole K and V tile from shared memory.
//
// Design, bf16 (the serving path): a CTA of 4 warps owns 64 query rows of
// one (batch, head), 16 rows a warp, and walks its key range 64 keys at a
// time.  Both products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate): S = Q K^T with Q held in
// registers as A fragments for the whole walk, then O += P V with P taken
// straight from S's accumulator registers.  The TPU kernel keeps P in f32
// for P V; here each probability is split into two bf16 halves, p = hi +
// lo to 16 significant bits, and O += hi V + lo V (two mma's on one V
// fragment), so P carries no bf16 rounding into the output (the row sums
// l are kept from the same f32 probabilities).  The running max, sum and the
// 64 x hd accumulator stay in registers.  K and V tiles are staged in
// shared memory by cp.async, rows padded by 16 bytes so that each 8-row
// ldmatrix phase hits 32 distinct banks; the B fragments come from
// ldmatrix.x4 (K) and ldmatrix.x4.trans (V, stored key-major as it is in
// memory), one instruction for two mma's operands.  The copies overlap
// the math: V of this block lands while S = Q K^T runs, K of the next
// block while O += P V runs.  Scores are scaled into log2 units by one
// multiply and exponentiated with ex2.approx; a block that no mask
// touches (all but the diagonal blocks of a causal prefill) skips the
// per-element mask test.  Registers are capped for three CTAs an SM.  Query blocks run heaviest
// first (causal rows with the most keys are scheduled first).  Not done
// yet: wgmma and TMA, more rows per warp to reuse each K/V fragment, a
// deeper pipeline.
//
// Design, f32 (tests and model-level parity): full f32 on the FMA units,
// never TF32.  A CTA of 128 threads owns 32 query rows; four threads
// share a row, each computing 4 of every 16 keys' scores and a quarter
// of the row's output dims.  It is there to be exact, not fast.
//
// Instantiated for hd in {32, 64, 128}; anything else is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's finite mask value
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, rep;                 // rep = H / KV
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;   // strides
  int causal, window;
  float scale;
};

// [*lo, *hi): the keys a query block [q0, q0 + bq) can reach, with *lo
// rounded down to a multiple of bk.
__device__ __forceinline__ void key_range(const Params& p, int q0, int bq,
                                          int bk, int* lo, int* hi) {
  int end = p.Sk;
  if (p.causal) end = min(end, q0 + bq);
  int beg = p.window ? max(0, q0 - p.window + 1) : 0;
  *lo = (beg / bk) * bk;
  *hi = end;
}

__device__ __forceinline__ bool allowed(const Params& p, int qpos,
                                        int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// Copies rows [row0, row0 + ROWS) of a (nrows, HD) f32 matrix with row
// stride `stride` (elements) into shared memory with row stride LD; rows
// at or past `nrows` are zero (masked keys must not carry NaN from past
// the end).  16-byte loads: the wrapper checks the alignment.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int nrows) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows)
      val = __ldg(reinterpret_cast<const float4*>(src + row * stride +
                                                  c * 4));
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a bf16 pair: hi is (x0, x1) rounded to bf16, lo
// the rounded remainder, so hi + lo is within 2^-17 of (x0, x1)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// c += a (16x16, row) * b (16x8, col); fragments as in the PTX ISA's
// m16n8k16 layout: g = lane / 4 and t = lane % 4 own rows g and g + 8,
// columns 2t, 2t + 1 (+ 8 for a[2], a[3] and b[1]).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane L gives the address of
// row L % 8 of matrix L / 8 and receives, of matrix i, in r[i] the pair
// (row L / 4, columns 2 (L % 4), +1), or with kTrans that pair of the
// transposed matrix.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
}

// Asynchronous 16-byte copy global -> shared (zero-filled when !valid).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of rows [row0, row0 + ROWS) of a (nrows, HD) bf16
// matrix with row stride `stride` into shared memory with row stride LD;
// rows at or past `nrows` are zero-filled (masked keys must not carry NaN
// from past the end).
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int nrows) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int row = row0 + r;
    const bool valid = row < nrows;
    cp_async16(dst + r * LD + c * 8,
               src + (valid ? row : 0) * stride + c * 8, valid);
  }
}

// 2^x (the scores are kept in log2 units: scale * log2(e) is folded into
// the one multiply that scales them)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Three CTAs an SM: the register cap this sets (168 at hd = 128) costs 32
// bytes of spill and was faster than two CTAs without spills.
constexpr int kMinBlocksBf16 = 3;

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf16)
    flash_bf16_kernel(Params p) {
  constexpr int BQ = 64, BK = 64, LD = HD + 8;
  constexpr int KSTEPS = HD / 16;     // k-steps of S = Q K^T
  constexpr int NT_S = BK / 8;        // n-tiles of S
  constexpr int NT_O = HD / 8;        // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.rep;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.qb + h * p.qh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.kb + kvh * p.kh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vb + kvh * p.vh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.ob + h * p.oh;

  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);
  const float scl = p.scale * 1.4426950408889634f;   // scores in log2 units

  // Q through the V buffer, K's first tile into the K buffer
  load_tile_async<HD, LD, BQ>(Vs, qg, p.qs, q0, p.Sq);
  cp_async_commit();
  if (lo < hi) load_tile_async<HD, LD, BK>(Ks, kg, p.ks, lo, p.Sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kt = 0; kt < KSTEPS; ++kt)
    ldsm_x4<false>(qf[kt], Vs + (warp * 16 + (lm & 1) * 8 + lr) * LD +
                               kt * 16 + (lm >> 1) * 8);

  const int r0 = warp * 16 + g;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  float o[NT_O][4];
#pragma unroll
  for (int d = 0; d < NT_O; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = lo; k0 < hi; k0 += BK) {
    cp_async_wait<0>();   // this block's K tile has landed
    __syncthreads();      // ... for every thread; V (and Q) reads are done
    load_tile_async<HD, LD, BK>(Vs, vg, p.vs, k0, p.Sk);
    cp_async_commit();

    // S = Q K^T while V lands
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int kt = 0; kt < KSTEPS; kt += 2) {
        uint32_t kf[4];   // b0, b1 of k-step kt, then of kt + 1
        ldsm_x4<false>(kf, Ks + (j * 8 + lr) * LD + kt * 16 + lm * 8);
        mma_bf16(s[j], qf[kt], kf[0], kf[1]);
        mma_bf16(s[j], qf[kt + 1], kf[2], kf[3]);
      }
    }

    // scale, mask, running max
    float mx[2] = {m[0], m[1]};
    // a block that no mask touches (most of a causal prefill) skips the
    // per-element mask test
    const bool whole = k0 + BK <= p.Sk && (!p.causal || k0 + BK <= q0 + 1) &&
                       (!p.window || q0 + BQ - 1 - k0 < p.window);
    if (whole) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] *= scl;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + j * 8 + 2 * t + (c & 1);
          const float x = allowed(p, qpos[c >> 1], kpos) ? s[j][c] * scl
                                                         : kNegInf;
          s[j][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2_approx(s[j][c] - m[c >> 1]);
        s[j][c] = e;
        rs[c >> 1] += e;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    cp_async_wait<0>();   // V has landed
    __syncthreads();      // ... for every thread; K reads are done
    if (k0 + BK < hi) {
      load_tile_async<HD, LD, BK>(Ks, kg, p.ks, k0 + BK, p.Sk);
      cp_async_commit();
    }

    // O += P V while the next K lands: S's accumulator tiles 2kt and
    // 2kt + 1 are P's A fragment, as hi and lo bf16 halves
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      uint32_t a[4], a_lo[4];
      split_bf16(s[2 * kt][0], s[2 * kt][1], &a[0], &a_lo[0]);
      split_bf16(s[2 * kt][2], s[2 * kt][3], &a[1], &a_lo[1]);
      split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], &a[2], &a_lo[2]);
      split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], &a[3], &a_lo[3]);
#pragma unroll
      for (int d = 0; d < NT_O; d += 2) {
        uint32_t vf[4];   // b0, b1 of n-tile d, then of d + 1
        ldsm_x4<true>(vf, Vs + (kt * 16 + (lm & 1) * 8 + lr) * LD +
                              (d + (lm >> 1)) * 8);
        mma_bf16(o[d], a, vf[0], vf[1]);
        mma_bf16(o[d], a_lo, vf[0], vf[1]);
        mma_bf16(o[d + 1], a, vf[2], vf[3]);
        mma_bf16(o[d + 1], a_lo, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    if (qpos[i] >= p.Sq) continue;
    __nv_bfloat16* orow = og + qpos[i] * p.os + 2 * t;
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][2 * i] / denom, o[d][2 * i + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units, full precision
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Params p) {
  constexpr int BQ = 32, BK = 16, LD = HD + 4, LDP = BK + 1;
  constexpr int NS = BK / 4;          // scores per thread per key block
  constexpr int ND = HD / 4;          // output dims per thread
  __shared__ __align__(16) float Qs[BQ * LD];
  __shared__ __align__(16) float Ks[BK * LD];
  __shared__ __align__(16) float Vs[BK * LD];
  __shared__ float Ps[BQ * LDP];

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.rep;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh;

  load_tile_f32<HD, LD, BQ>(Qs, qg, p.qs, q0, p.Sq);
  const int qpos = q0 + r;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();   // every thread is done with the last K/V tiles
    load_tile_f32<HD, LD, BK>(Ks, kg, p.ks, k0, p.Sk);
    load_tile_f32<HD, LD, BK>(Vs, vg, p.vs, k0, p.Sk);
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(u + 4 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = allowed(p, qpos, k0 + u + 4 * j) ? s[j] * p.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = quad_max(mx);
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float e = expf(s[j] - m);
      Ps[r * LDP + u + 4 * j] = e;
      rs += e;
    }
    l = l * corr + rs;
    __syncwarp();      // the row's four threads share its probabilities
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float pk = Ps[r * LDP + kk];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        acc[i] = fmaf(pk, Vs[kk * LD + u + 4 * i], acc[i]);
    }
    __syncwarp();      // read before the next block overwrites them
  }

  const float denom = fmaxf(quad_sum(l), 1e-30f);
  if (qpos >= p.Sq) return;
  float* orow = og + qpos * p.os;
#pragma unroll
  for (int i = 0; i < ND; ++i) orow[u + 4 * i] = acc[i] / denom;
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// dtype (0: f32, 1: bf16) on the current device, head dim contiguous and
// rows 16-byte aligned.  `strides` holds 12 element strides: batch,
// sequence and head of q, k, v and out.  Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Sq, int Sk,
                           int H, int KV, int hd, const long long* strides,
                           int causal, int window, float scale,
                           void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.rep = H / KV;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.ob = strides[9]; p.os = strides[10]; p.oh = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((Sq + 63) / 64, B * H);
    switch (hd) {
      case 32: flash_bf16_kernel<32><<<grid, kThreads, 0, st>>>(p); break;
      case 64: flash_bf16_kernel<64><<<grid, kThreads, 0, st>>>(p); break;
      case 128: flash_bf16_kernel<128><<<grid, kThreads, 0, st>>>(p); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    const dim3 grid((Sq + 31) / 32, B * H);
    switch (hd) {
      case 32: flash_f32_kernel<32><<<grid, kThreads, 0, st>>>(p); break;
      case 64: flash_f32_kernel<64><<<grid, kThreads, 0, st>>>(p); break;
      case 128: flash_f32_kernel<128><<<grid, kThreads, 0, st>>>(p); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
