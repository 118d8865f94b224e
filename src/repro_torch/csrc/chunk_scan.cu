// chunk_scan: the chunked linear recurrence under RWKV6 and Mamba2-SSD
//
//   S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T        (S is K x V, f32)
//   y_t = r_t . S_t                                   Mamba2 (include_current)
//   y_t = r_t . S_{t-1} + (r_t * u . k_t) v_t         RWKV6 (bonus u)
//
// Replaces: src/repro/kernels/chunk_scan/kernel.py, chunk_scan_flat
// (_chunk_kernel), in both modes.  The log-decay is clamped to [-1, 0] as
// it is read (the JAX package clamps it in its wrapper), and a scalar
// per-head decay comes in with a channel stride of 0.
//
// Layout: r, k and ld (B, T, H, K), v (B, T, H, V), read through their
// four strides each (the model's projections go in without a copy); s0
// and s_fin (B, H, K, V) f32 contiguous; u (H, K) f32 contiguous (RWKV6
// mode only); y (B, T, H, V) contiguous in r/k/v's dtype (f32, bf16 or
// f16; 16-bit loads are widened to f32 as they are read).
//
// Per chunk c of Lc steps, with L the inclusive cumulative log-decay and
// M_t = L_t (Mamba2) or L_{t-1} (RWKV6):
//   y_cross = (r exp(M)) S_c;   y_intra[t] = sum_{s<t | s<=t} A[t,s] v_s;
//   A[t,s]  = sum_k r_tk k_sk exp(M_tk - L_sk);
//   S_{c+1} = exp(L_end) S_c + dS_c,   dS_c = (k exp(L_end - L))^T v.
// The TPU kernel factors A as (r exp(M)) . (k exp(-L)); at Lc = 128 and
// decays at the clamp, exp(-L) passes f32's range while exp(M) underflows,
// and A holds 0 * inf = NaN.  Here the query rows go in sub-blocks of 16,
// and sub-block i factors A with exponents relative to the exclusive
// cumulative sum Lref_i at its first row:
//   A[t,s] = (r_t exp(M_t - Lref_i)) . (k_s exp(Lref_i - L_s)),
// so no factor exceeds exp(16); a key factor that underflows to 0 stands
// for a term below f32's range.
//
// What bounds it on an H100: bytes.  At the serving shape (B 4, T 2048,
// H 64, K = V = 64, chunk 128, bf16) moving r, k, v, y (bf16) and ld (f32)
// once takes 0.123 ms; the 1.71e10 flops the masks keep take 0.255 ms at
// the f32 FMA peak, 0.035 ms at the TF32 tensor-core peak.
//
// Design: one launch, one CTA per (chunk, batch-head, 64 V columns), no
// sequential grid.  A CTA loads its chunk (16-byte cp.async, the decay
// first: r, k and v land while it forms L), and computes dS_c on the
// tensor cores (warp w: channels 16 (w / 2) .., columns 32 (w % 2) ..).
// The chunks of one head then hand the state on as CUB's single-pass scan
// does: chunk c waits for chunk c - 1's flag, reads S_c from the
// workspace (s0 for the first chunk), writes S_{c+1} = exp(L_end) S_c +
// dS_c (s_fin after the last) and sets its own flag.  CTAs take their
// work item from an atomic counter in the order they start, chunk-major,
// so a CTA only ever waits on one that started before it (no deadlock
// whatever the hardware's block order), one wave ahead.  Then 8 warps, one
// 16-row sub-block each (paired 0/7, 1/6, ... on a scheduler so that
// every scheduler gets 9 key blocks of work), add the cross term (r
// exp(M)) S_c, the masked intra term key block by key block, and the
// RWKV6 bonus; y leaves from registers.  The state round trip goes
// through L2: each chunk's S_{c+1} is read by the next chunk's CTA a wave
// later.
// The products run on the tensor cores as mma.sync.m16n8k8 with TF32
// operands and f32 accumulation, each f32 operand split a = hi + lo and
// hi.hi + hi.lo + lo.hi accumulated (3 passes, where one TF32 pass misses
// the state tolerance 5e-5 by 5x); f32 inputs take the precise variant of
// the split and the sums (see precise()).  v widened from bf16 or f16 is
// exact in TF32, so A.v and dS take 2 passes in bf16 and f16.  The depth
// of each product is permuted so that a thread reads channel (or key)
// pairs 2t, 2t + 1: the accumulator of A lands in the A-fragment layout of
// A.v without a trip through shared memory.  Tiles are zero-filled past the
// chunk, past K and past V, so the products need no per-tile branch.
// Element loads replace cp.async for an operand without a unit channel
// stride and 16-byte aligned rows (K or V not a multiple of 16 bytes
// among them), and an odd V takes its state and y one element at a time.
// Row pitches of 72 (bf16: 36 words) and 68 or 72 f32 words keep the
// fragment reads free of bank conflicts.  Shared memory at K <= 64: 109
// KB in bf16 (two CTAs an SM), 161 KB in f32.
//
// K up to 128: instantiations at 64 and 128 channels, the launcher
// taking the smaller that holds K.  At 128 the state pass loops over
// blocks of 64 channels, and r exp(M - Lref) is formed again at each use
// rather than kept in registers (64 more a thread).  Past 128 channels
// chunk_scan_wide_kernel streams the channels through 256-channel tiles in
// blocks of 256 (see its note), at any K.  The tiles at 128 and 256
// channels leave room for fewer steps (see max_steps: 194,080 bytes at 128
// channels and 128 steps in bf16, 216,096 at 256 and 64; f32 halves the
// steps), and a chunk longer than those steps (or than 128 at 64 channels)
// runs as sub-blocks of them, in order, the last one shorter: each
// sub-block is a work item of its own and hands the state on to the next
// through the flags, as chunks do.  The recurrence's result does not
// depend on where the time axis is cut, so this is the same function; the
// 16-row re-referencing inside each sub-block stays.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kVT = 64;                 // V columns per CTA
constexpr int kSB = 16;                 // query rows per sub-block
constexpr int kLDS = 68;                // pitch of the state tile (f32)
constexpr float kLog2e = 1.4426950408889634f;

// The tiles' channel capacity kMaxK (64 or 128: the smaller that holds K;
// 256, the channel-block kernel's, past 128) sets the tiles' pitch and
// the steps a CTA holds at once (kMaxL): 128 at 64 channels; at 128, 128
// in bf16 and 64 in f32; at 256, 64 in bf16 and 32 in f32, so that the
// tiles fit in the 227 KB of shared memory a CTA can hold.
template <int kMaxK> __host__ __device__ constexpr int pitch() {
  return kMaxK + 8;                     // 72 at 64: 8 words past a bank row
}
template <typename T, int kMaxK>
__host__ __device__ constexpr int max_steps() {
  return kMaxK == 64 ? 128 : (kMaxK == 128 ? 128 : 64) / (sizeof(T) / 2);
}

// the v pitch: the A.v fragments read rows 2t, 2t + 1
template <typename T> __host__ __device__ constexpr int ldv_out() {
  return sizeof(T) == 2 ? 72 : 68;
}

template <typename T, int kMaxK> constexpr size_t smem_bytes() {
  constexpr int L = max_steps<T, kMaxK>(), LD = pitch<kMaxK>();
  return 2 * L * LD * sizeof(T) + L * ldv_out<T>() * sizeof(T) +
         ((L + 1) * LD + kMaxK * kLDS + kThreads) * sizeof(float);
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* ld;
  const float* u;
  const float* s0;
  void* y;
  float* sfin;
  float* work;                            // (B H, nc, K, V): S_{c+1}
  int* sync;                              // the item counter, then flags
  int T, H, K, V, include_current;
  int Lc, sub, nsub;                      // chunk, sub-block, sub-blocks
  int nc;                                 // sub-blocks over T
  int vec, ld_vec;                        // 16-byte loads (see the launch)
  int vpair;                              // V even: f32 / bf16 pair access
  long long rs[4], ks[4], vs[4], ls[4];   // element strides b, t, h, channel
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ __half zero<__half>() {
  return __float2half(0.f);
}

// elements e, e + 1 of a shared-memory row, widened
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* dst, float a, float b) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store1(float* dst, float a) { *dst = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float a) {
  *dst = __float2bfloat16(a);
}
__device__ __forceinline__ void store1(__half* dst, float a) {
  *dst = __float2half(a);
}

// f32 inputs take the precise variant of three steps below: expf for the
// factors, lo rounded to nearest, and each product's hi.hi summed into the
// running total on the FMA units rather than in the tensor core's
// accumulator (which rounds toward zero).  At rwkv6-7b's width in f32 the
// plain route holds the kernel route's logits to 2e-4 (chip_smoke.py
// phase 12), and the group norm of its first positions turns the fast
// variant's rounding into more than that; bf16 outputs round far above
// either.
template <typename T> __host__ __device__ constexpr bool precise() {
  return sizeof(T) == 4;
}

// exp(x) of a difference of two cumulative sums, formed in natural units
// (scaling the sums themselves by log2(e) would round each one apart and
// lose the cancellation of their common prefix); ex2.approx when fast
template <bool kPrecise>
__device__ __forceinline__ float fexp(float x) {
  if (kPrecise) return expf(x);
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// x = hi + lo for a product on the tensor cores: hi is x rounded to TF32
// to nearest (ties away from zero, as cvt.rna rounds, without its guard
// for inf and NaN, which these finite operands never need) and lo = x -
// hi, rounded the same way when precise; the fast variant leaves lo's low
// bits to the tensor core, which reads its top 19 (lo truncated).  Three
// or five integer and float instructions where two cvt.rna take fourteen.
// Volatile, so that the compiler does not hoist the split of a loop's
// invariant operand and keep both halves live across the loop.
template <bool kPrecise>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kPrecise)
    asm volatile(
        "{\n\t.reg .b32 t;\n\tadd.u32 t, %2, 4096;\n\t"
        "and.b32 %0, t, -8192;\n\tsub.f32 t, %3, %0;\n\t"
        "add.u32 t, t, 4096;\n\tand.b32 %1, t, -8192;\n\t}"
        : "=r"(hi), "=r"(lo) : "r"(__float_as_uint(x)), "f"(x));
  else
    asm volatile(
        "{\n\t.reg .b32 t;\n\tadd.u32 t, %2, 4096;\n\t"
        "and.b32 %0, t, -8192;\n\tsub.f32 %1, %3, %0;\n\t}"
        : "=r"(hi), "=r"(lo) : "r"(__float_as_uint(x)), "f"(x));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.  Fragments
// as in the PTX ISA's m16n8k8 .tf32 layout, with g = lane / 4, t = lane % 4:
// a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g); d[0..1] (g, 2t..2t + 1), d[2..3] (g + 8, ..).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a given as its hi and lo halves; b is split here (3
// passes) unless it is exact in TF32 (kExact: v widened from bf16 or
// f16, 2)
template <bool kPrecise, bool kExact>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  float m[4] = {}, e[4] = {};
  float (&hh)[4] = kPrecise ? m : d;
  float (&hl)[4] = kPrecise ? e : d;
  if (kExact) {
    mma_tf32(hl, al, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(hh, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split<kPrecise>(b0, h0, l0);
    split<kPrecise>(b1, h1, l1);
    mma_tf32(hl, al, h0, h1);
    mma_tf32(hl, ah, l0, l1);
    mma_tf32(hh, ah, h0, h1);
  }
  if (kPrecise) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += m[i] + e[i];
  }
}

// The same product with hi.hi into d and the two corrections into e: two
// dependency chains where one would be three deep.
template <bool kPrecise>
__device__ __forceinline__ void mma3x2(float (&d)[4], float (&e)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  uint32_t h0, l0, h1, l1;
  split<kPrecise>(b0, h0, l0);
  split<kPrecise>(b1, h1, l1);
  mma_tf32(e, al, h0, h1);
  if (kPrecise) {
    float m[4] = {};
    mma_tf32(m, ah, h0, h1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += m[i];
  } else {
    mma_tf32(d, ah, h0, h1);
  }
  mma_tf32(e, ah, l0, l1);
}

template <bool kPrecise>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split<kPrecise>(x[e], hi[e], lo[e]);
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
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, n) and columns [0, w) of an operand at g (row stride rs,
// column stride cs) into a shared tile of pitch LD, zero on rows [n,
// rows) and columns [w, cols).  vec: cs == 1, 16-byte aligned rows, w and
// cols multiples of 16 bytes; the copies are asynchronous (commit and wait
// follow).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int LD, const T* g,
                                          long long rs, long long cs, int n,
                                          int w, int rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int q = cols / E;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int t = i / q, c = (i - t * q) * E;
      const bool ok = t < n && c < w;
      cp_async16(dst + t * LD + c, ok ? g + t * rs + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int t = i / cols, c = i - t * cols;
      dst[t * LD + c] = (t < n && c < w) ? g[t * rs + c * cs] : zero<T>();
    }
  }
}

// Rows 1..Lc of the (Lc + 1, LD) tile Ls hold the raw log-decay of one
// chunk (row 0 zeros): each becomes the inclusive cumulative sum of the
// decay clamped to [-1, 0].  Row t + 1 is then L_t and row t the exclusive
// sum.  kThreads / K segments a channel, then the totals of the earlier
// segments.
template <int LD>
__device__ __forceinline__ void cumsum(float* Ls, float* Tot, int Lc,
                                       int K) {
  const int tid = threadIdx.x;
  const int nseg = kThreads / K;
  const int seglen = (Lc + nseg - 1) / nseg;
  const int c = tid % K, sg = tid / K;
  const int lo = min(sg * seglen, Lc), hi = min(lo + seglen, Lc);
  const bool act = sg < nseg;
  if (act) {
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      float* q = Ls + (t + 1) * LD + c;
      run += fminf(fmaxf(*q, -1.f), 0.f);
      *q = run;
    }
    Tot[sg * K + c] = run;
  }
  __syncthreads();
  if (act) {
    float off = 0.f;
    for (int e = 0; e < sg; ++e) off += Tot[e * K + c];
    for (int t = lo; t < hi; ++t) {
      float* q = Ls + (t + 1) * LD + c;
      *q += off;
    }
  }
  __syncthreads();
}

// dS_c = (k exp(L_end - L))^T v over this warp's tile, channels m0 .. m0 +
// 15 and columns n0 .. n0 + 31 (M = channel, N = column, depth = step):
// acc[nt] holds (channel m0 + g | + 8, column n0 + 8 nt + 2t | + 1).  Ks,
// Ls (pitch LD), Vs (pitch LDV) as the loads leave them, zero past the
// chunk and past K.
template <typename T, int LD, int LDV>
__device__ __forceinline__ void chunk_state(float (&acc)[4][4], const T* Ks,
                                            const T* Vs, const float* Ls,
                                            int Lc, int m0, int n0, int g,
                                            int t) {
  constexpr bool P = precise<T>();
  const int L8 = (Lc + 7) & ~7;
  const int ca = m0 + g, cb = ca + 8;
  const float ea = Ls[Lc * LD + ca], eb = Ls[Lc * LD + cb];
  for (int s0 = 0; s0 < L8; s0 += 8) {
    const int sa = s0 + t, sb = sa + 4;
    float a[4];
    a[0] = to_f32(Ks[sa * LD + ca]) * fexp<P>(ea - Ls[(sa + 1) * LD + ca]);
    a[1] = to_f32(Ks[sa * LD + cb]) * fexp<P>(eb - Ls[(sa + 1) * LD + cb]);
    a[2] = to_f32(Ks[sb * LD + ca]) * fexp<P>(ea - Ls[(sb + 1) * LD + ca]);
    a[3] = to_f32(Ks[sb * LD + cb]) * fexp<P>(eb - Ls[(sb + 1) * LD + cb]);
    uint32_t ah[4], al[4];
    split4<P>(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = n0 + nt * 8 + g;
      mma3<P, !P>(acc[nt], ah, al, to_f32(Vs[sa * LDV + j]),
                  to_f32(Vs[sb * LDV + j]));
    }
  }
}

__device__ __forceinline__ int ld_acquire(const int* q) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(q)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* q, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(q), "r"(v)
               : "memory");
}
__device__ __forceinline__ float ld_relaxed(const float* q) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(q)
               : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_relaxed2(const float* q) {
  float2 v;
  asm volatile("ld.relaxed.gpu.global.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "l"(q) : "memory");
  return v;
}

// y of this thread's rows ta and tb (those below Lc) and, of each 8-column
// tile, columns 2t and 2t + 1 (those below Vw), with the RWKV6 bonus da or
// db times v added, into y (B, T, H, V) contiguous in T
template <typename T, int LDV>
__device__ __forceinline__ void store_y(const Params& p,
                                        const float (&y)[kVT / 8][4],
                                        float da, float db, const T* Vs,
                                        int b, int h, long long t0, int v0,
                                        int Vw, int Lc, int ta, int tb,
                                        int t) {
  T* yg = static_cast<T*>(p.y) +
          ((static_cast<long long>(b) * p.T + t0) * p.H + h) * p.V + v0;
  const long long y_row = static_cast<long long>(p.H) * p.V;
  if (p.vpair) {
#pragma unroll
    for (int nt = 0; nt < kVT / 8; ++nt) {
      const int j = nt * 8 + 2 * t;
      if (j < Vw) {
        if (ta < Lc) {
          const float2 va = pair(Vs + ta * LDV + j);
          store2(yg + ta * y_row + j, fmaf(da, va.x, y[nt][0]),
                 fmaf(da, va.y, y[nt][1]));
        }
        if (tb < Lc) {
          const float2 vb = pair(Vs + tb * LDV + j);
          store2(yg + tb * y_row + j, fmaf(db, vb.x, y[nt][2]),
                 fmaf(db, vb.y, y[nt][3]));
        }
      }
    }
  } else {                // odd V: one element at a time
#pragma unroll
    for (int nt = 0; nt < kVT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ta : tb;
        const int j = nt * 8 + 2 * t + (e & 1);
        if (row < Lc && j < Vw)
          store1(yg + row * y_row + j,
                 fmaf(e < 2 ? da : db, to_f32(Vs[row * LDV + j]), y[nt][e]));
      }
    }
  }
}

// One sub-block of a chunk (at most kMaxL steps; the whole chunk where it
// fits) and 64 V columns: its state and its outputs.  In the outputs, warp
// w owns the 16 query rows of sub-block 0, 1, 2, 3, 7, 6, 5, 4 (so warps w
// and w + 4, on one scheduler, have 9 key blocks between them); this
// thread owns rows ta = a + g and tb = ta + 8 and, of each 8-column tile,
// columns 2t, 2t + 1.
template <typename T, int kMaxK>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 2 && kMaxK == 64 ? 2 : 1)
    chunk_scan_kernel(Params p) {
  constexpr int kMaxL = max_steps<T, kMaxK>();
  constexpr int kLD = pitch<kMaxK>();     // of the r, k, ld tiles
  constexpr int LDV = ldv_out<T>();
  constexpr int kMB = kMaxK / 64;         // channel blocks of the state pass
  // r exp(M - Lref) stays in registers up to 64 channels; above, each use
  // forms it again from the tiles (kMaxK / 2 registers more would spill)
  constexpr bool kQReg = kMaxK == 64;
  constexpr bool P = precise<T>();     // f32: v is not exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  T* Rs = reinterpret_cast<T*>(smem);
  T* Ks = Rs + kMaxL * kLD;
  T* Vs = Ks + kMaxL * kLD;
  float* Ls = reinterpret_cast<float*>(Vs + kMaxL * LDV);
  float* Ss = Ls + (kMaxL + 1) * kLD;
  float* Tot = Ss + kMaxK * kLDS;

  const int tid = threadIdx.x;
  const int nvt = (p.V + kVT - 1) / kVT;
  __shared__ int item;     // chunk-major, in the order the CTAs start
  if (tid == 0) item = atomicAdd(p.sync, 1);
  __syncthreads();
  const int rows = gridDim.x / p.nc;                  // B H nvt
  const int c = item / rows;                          // the sub-block
  const int bh = (item - c * rows) / nvt;
  const int vt = item - c * rows - bh * nvt;
  const int b = bh / p.H, h = bh - b * p.H;
  const int v0 = vt * kVT, Vw = min(kVT, p.V - v0);
  const int K = p.K;
  // sub-block js of chunk cu: steps [t0, t0 + Lc)
  const int cu = c / p.nsub, js = c - cu * p.nsub;
  const int Lc = min(p.sub, p.Lc - js * p.sub);
  const int L16 = (Lc + 15) & ~15;
  const int nsb = L16 / kSB;
  const bool rwkv = !p.include_current;
  const long long t0 = static_cast<long long>(cu) * p.Lc +
                       static_cast<long long>(js) * p.sub;

  const float* lg = p.ld + b * p.ls[0] + h * p.ls[2] + t0 * p.ls[1];
  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[2] +
                t0 * p.rs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2] +
                t0 * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2] +
                t0 * p.vs[1] + v0 * p.vs[3];
  load_tile(Ls + kLD, kLD, lg, p.ls[1], p.ls[3], Lc, K, L16, kMaxK,
            p.ld_vec);
  for (int i = tid; i < kMaxK; i += kThreads) Ls[i] = 0.f;
  cp_async_commit();
  load_tile(Rs, kLD, rg, p.rs[1], p.rs[3], Lc, K, L16, kMaxK, p.vec);
  load_tile(Ks, kLD, kg, p.ks[1], p.ks[3], Lc, K, L16, kMaxK, p.vec);
  load_tile(Vs, LDV, vg, p.vs[1], p.vs[3], Lc, Vw, L16, kVT, p.vec);
  cp_async_commit();
  cp_async_wait<1>();      // the decay; r, k and v land during the cumsum
  __syncthreads();
  cumsum<kLD>(Ls, Tot, Lc, K);
  cp_async_wait<0>();
  __syncthreads();

  // dS_c of this warp's tiles, then S_{c+1} = exp(L_end) S_c + dS_c once
  // sub-block c - 1 has published S_c (S_0 = s0): S_c goes to shared
  // memory for the cross term, S_{c+1} to the workspace (s_fin after the
  // last sub-block), and sub-block c + 1 may go on
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  {
    const int n0 = 32 * (warp & 1);
    float acc[kMB][4][4] = {};
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      const int m0 = 64 * mb + 16 * (warp >> 1);
      if (m0 < K)
        chunk_state<T, kLD, LDV>(acc[mb], Ks, Vs, Ls, Lc, m0, n0, g, t);
    }
    int* flag = p.sync + 1 + (static_cast<long long>(bh) * nvt + vt) * p.nc;
    if (c > 0) {
      if (tid == 0)
        while (!ld_acquire(flag + c - 1)) __nanosleep(64);
      __syncthreads();
    }
    const long long KV = static_cast<long long>(K) * p.V;
    const float* sp = c ? p.work + (static_cast<long long>(bh) * p.nc + c -
                                    1) * KV + v0
                        : p.s0 + bh * KV + v0;
    float* sn = c + 1 < p.nc ? p.work + (static_cast<long long>(bh) * p.nc +
                                         c) * KV + v0
                             : p.sfin + bh * KV + v0;
    if (p.vpair) {        // columns j, j + 1 both in or both out
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 64 * mb + 16 * (warp >> 1) + g + 8 * half;
          const float dec = row < K ? expf(Ls[Lc * kLD + row]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = n0 + nt * 8 + 2 * t;
            const bool in = row < K && j < Vw;
            const float2 sv = in ? ld_relaxed2(sp + row * p.V + j)
                                 : make_float2(0.f, 0.f);
            Ss[row * kLDS + j] = sv.x;
            Ss[row * kLDS + j + 1] = sv.y;
            if (in)
              __stcg(reinterpret_cast<float2*>(sn + row * p.V + j),
                     make_float2(fmaf(dec, sv.x, acc[mb][nt][2 * half]),
                                 fmaf(dec, sv.y, acc[mb][nt][2 * half + 1])));
          }
        }
      }
    } else {              // odd V: one element at a time
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 64 * mb + 16 * (warp >> 1) + g + 8 * half;
          const float dec = row < K ? expf(Ls[Lc * kLD + row]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = n0 + nt * 8 + 2 * t + e;
              const bool in = row < K && j < Vw;
              const float sv = in ? ld_relaxed(sp + row * p.V + j) : 0.f;
              Ss[row * kLDS + j] = sv;
              if (in)
                __stcg(sn + row * p.V + j,
                       fmaf(dec, sv, acc[mb][nt][2 * half + e]));
            }
          }
        }
      }
    }
    __syncthreads();       // S_c is in; every store of S_{c+1} is issued
    if (tid == 0 && c + 1 < p.nc) {
      __threadfence();
      st_release(flag + c, 1);
    }
  }

  const int sb = warp < 4 ? warp : 11 - warp;
  if (sb >= nsb) return;
  const int a = sb * kSB, ta = a + g, tb = ta + 8;
  const float* Lref = Ls + a * kLD;                 // exclusive sum at a
  const float* Ma = Ls + (rwkv ? ta : ta + 1) * kLD;
  const float* Mb = Ls + (rwkv ? tb : tb + 1) * kLD;
  const int nks = (K + 7) / 8;                      // k-steps that hold K

  float y[kVT / 8][4] = {};
  // r exp(M - Lref), (ta|tb, 2t|2t+1) per k-step, kept when kQReg
  float qreg[kQReg ? kMaxK / 8 : 1][4];
  const auto q_of = [&](int ks, float (&q)[4]) {
    const int cc = ks * 8 + 2 * t;
    const float2 lr = pair(Lref + cc), ma = pair(Ma + cc), mb = pair(Mb + cc);
    const float2 ra = pair(Rs + ta * kLD + cc), rb = pair(Rs + tb * kLD + cc);
    q[0] = ra.x * fexp<P>(ma.x - lr.x);
    q[1] = rb.x * fexp<P>(mb.x - lr.x);
    q[2] = ra.y * fexp<P>(ma.y - lr.y);
    q[3] = rb.y * fexp<P>(mb.y - lr.y);
  };

  // the cross term (r exp(M)) S_c, = (r exp(M - Lref)) exp(Lref) S_c
#pragma unroll
  for (int ks = 0; ks < kMaxK / 8; ++ks) {
    if (!kQReg && ks >= nks) break;
    const int cc = ks * 8 + 2 * t;
    float q[4];
    q_of(ks, q);
    if constexpr (kQReg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qreg[ks][e] = q[e];
    }
    const float2 lr = pair(Lref + cc);
    const float e0 = expf(lr.x), e1 = expf(lr.y);
    const float x[4] = {q[0] * e0, q[1] * e0, q[2] * e1, q[3] * e1};
    uint32_t xh[4], xl[4];
    split4<P>(x, xh, xl);
#pragma unroll
    for (int nt = 0; nt < kVT / 8; ++nt) {
      const int j = nt * 8 + g;
      mma3<P, false>(y[nt], xh, xl, Ss[cc * kLDS + j],
                     Ss[(cc + 1) * kLDS + j]);
    }
  }

  // the bonus r_t * u . k_t of this thread's rows, a warp a row (lane l:
  // channels 2l, 2l + 1, + 64, ...; r and k are zero past K)
  float da = 0.f, db = 0.f;
  if (rwkv) {
    constexpr int kCC = kMaxK / 64;
    float2 uu[kCC];
#pragma unroll
    for (int q = 0; q < kCC; ++q) {
      const int cc = 2 * lane + 64 * q;
      uu[q] = make_float2(cc < K ? __ldg(p.u + h * K + cc) : 0.f,
                          cc + 1 < K ? __ldg(p.u + h * K + cc + 1) : 0.f);
    }
    for (int i = 0; i < kSB; ++i) {
      const int row = a + i;
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < kCC; ++q) {
        const int cc = 2 * lane + 64 * q;
        const float2 rr = pair(Rs + row * kLD + cc);
        const float2 kk = pair(Ks + row * kLD + cc);
        d += fmaf(rr.x * uu[q].x, kk.x, rr.y * uu[q].y * kk.y);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (i == g) da = d;
      if (i == g + 8) db = d;
    }
  }

  // the intra term, key block by key block
  for (int jb = 0; jb <= sb; ++jb) {
    const int s0 = jb * kSB;
    float A[2][4] = {}, Ac[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxK / 8; ++ks) {
      if (!kQReg && ks >= nks) break;
      const int cc = ks * 8 + 2 * t;
      const float2 lr = pair(Lref + cc);
      float qv[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[e] = qreg[ks][e];
      } else {
        q_of(ks, qv);
      }
      uint32_t qh[4], ql[4];
      split4<P>(qv, qh, ql);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int s = s0 + n2 * 8 + g;
        const float2 kk = pair(Ks + s * kLD + cc);
        const float2 ls = pair(Ls + (s + 1) * kLD + cc);
        mma3x2<P>(A[n2], Ac[n2], qh, ql, kk.x * fexp<P>(lr.x - ls.x),
                  kk.y * fexp<P>(lr.y - ls.y));
      }
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int e = 0; e < 4; ++e) A[n2][e] += Ac[n2][e];
    if (jb == sb) {     // the diagonal block: s < t (RWKV6), s <= t (Mamba2)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ta : tb;
          const int s = s0 + n2 * 8 + 2 * t + (e & 1);
          if (rwkv ? s >= row : s > row) A[n2][e] = 0.f;
        }
    }
    // y += A v: the accumulator (row, key 2t|2t+1) is the A fragment of
    // depth (t, t + 4) once the keys of v are read in the same order
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      const float af[4] = {A[n2][0], A[n2][2], A[n2][1], A[n2][3]};
      uint32_t ah[4], al[4];
      split4<P>(af, ah, al);
      const int sk = s0 + n2 * 8 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kVT / 8; ++nt) {
        const int j = nt * 8 + g;
        mma3<P, !P>(y[nt], ah, al, to_f32(Vs[sk * LDV + j]),
                    to_f32(Vs[(sk + 1) * LDV + j]));
      }
    }
  }

  store_y<T, LDV>(p, y, da, db, Vs, b, h, t0, v0, Vw, Lc, ta, tb, t);
}

// K past 128 channels: tiles of kWideK channels, the channels streamed
// through them in blocks of kWideK (one block up to 256).  Everything but
// the outputs is separate per channel: a block's decay cumsum, its rows of
// dS_c and of the state hand-over (S_c into shared memory, S_{c+1} to the
// workspace) run as chunk_scan_kernel runs them for K <= 128, the
// predecessor's flag
// awaited before the first block's rows and this item's flag set after
// the last block's.  The outputs contract over K: the cross term (r
// exp(M)) S_c, the intra scores A = (r exp(M - Lref)) (k exp(Lref - L))^T
// (every key block of the warp's sub-block, f32 in registers) and the
// RWKV6 bonus are summed block by block, and y += A v with the masks and
// the bonus follow the last block; v's tile stays loaded throughout.  The
// 16-row re-referencing of the exponents is per channel, so it holds in
// every block.
constexpr int kWideK = 256;
constexpr int kTileK = 128;    // the widest K chunk_scan_kernel holds

// The channel blocks the launcher streams K through: 0 where
// chunk_scan_kernel holds K in one tile
__host__ __device__ constexpr int channel_blocks(int K) {
  return K <= kTileK ? 0 : (K + kWideK - 1) / kWideK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_scan_wide_kernel(Params p) {
  constexpr int kMaxL = max_steps<T, kWideK>();
  constexpr int kLD = pitch<kWideK>();
  constexpr int LDV = ldv_out<T>();
  constexpr int kMB = kWideK / 64;
  constexpr int kKB = kMaxL / kSB;        // key blocks a sub-block holds
  constexpr bool P = precise<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Rs = reinterpret_cast<T*>(smem);
  T* Ks = Rs + kMaxL * kLD;
  T* Vs = Ks + kMaxL * kLD;
  float* Ls = reinterpret_cast<float*>(Vs + kMaxL * LDV);
  float* Ss = Ls + (kMaxL + 1) * kLD;
  float* Tot = Ss + kWideK * kLDS;

  const int tid = threadIdx.x;
  const int nvt = (p.V + kVT - 1) / kVT;
  __shared__ int item;     // chunk-major, in the order the CTAs start
  if (tid == 0) item = atomicAdd(p.sync, 1);
  __syncthreads();
  const int rows = gridDim.x / p.nc;                  // B H nvt
  const int c = item / rows;                          // the sub-block
  const int bh = (item - c * rows) / nvt;
  const int vt = item - c * rows - bh * nvt;
  const int b = bh / p.H, h = bh - b * p.H;
  const int v0 = vt * kVT, Vw = min(kVT, p.V - v0);
  const int K = p.K;
  const int cu = c / p.nsub, js = c - cu * p.nsub;
  const int Lc = min(p.sub, p.Lc - js * p.sub);
  const int L16 = (Lc + 15) & ~15;
  const int nsb = L16 / kSB;
  const bool rwkv = !p.include_current;
  const long long t0 = static_cast<long long>(cu) * p.Lc +
                       static_cast<long long>(js) * p.sub;
  const float* lg = p.ld + b * p.ls[0] + h * p.ls[2] + t0 * p.ls[1];
  const T* rg = static_cast<const T*>(p.r) + b * p.rs[0] + h * p.rs[2] +
                t0 * p.rs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2] +
                t0 * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2] +
                t0 * p.vs[1] + v0 * p.vs[3];
  int* flag = p.sync + 1 + (static_cast<long long>(bh) * nvt + vt) * p.nc;
  const long long KV = static_cast<long long>(K) * p.V;
  const float* sp0 = c ? p.work + (static_cast<long long>(bh) * p.nc + c -
                                   1) * KV + v0
                       : p.s0 + bh * KV + v0;
  float* sn0 = c + 1 < p.nc ? p.work + (static_cast<long long>(bh) * p.nc +
                                        c) * KV + v0
                            : p.sfin + bh * KV + v0;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = 32 * (warp & 1);
  const int sb = warp < 4 ? warp : 11 - warp;
  const bool active = sb < nsb;            // this warp's rows hold steps
  const int a = sb * kSB, ta = a + g, tb = ta + 8;
  float y[kVT / 8][4] = {};
  float A[kKB][2][4] = {};                 // (ta|tb, key 2t|2t+1) a tile
  float da = 0.f, db = 0.f;                // the bonus r_t * u . k_t

  for (int kc0 = 0; kc0 < K; kc0 += kWideK) {
    const int Kb = min(kWideK, K - kc0);   // this block's channels
    if (kc0) __syncthreads();              // the last block's tiles are read
    load_tile(Ls + kLD, kLD, lg + kc0 * p.ls[3], p.ls[1], p.ls[3], Lc, Kb,
              L16, kWideK, p.ld_vec);
    for (int i = tid; i < kWideK; i += kThreads) Ls[i] = 0.f;
    cp_async_commit();
    load_tile(Rs, kLD, rg + kc0 * p.rs[3], p.rs[1], p.rs[3], Lc, Kb, L16,
              kWideK, p.vec);
    load_tile(Ks, kLD, kg + kc0 * p.ks[3], p.ks[1], p.ks[3], Lc, Kb, L16,
              kWideK, p.vec);
    if (!kc0) load_tile(Vs, LDV, vg, p.vs[1], p.vs[3], Lc, Vw, L16, kVT,
                        p.vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    cumsum<kLD>(Ls, Tot, Lc, Kb);
    cp_async_wait<0>();
    __syncthreads();

    // this block's rows of dS_c, then of S_c and S_{c+1}
    {
      float acc[kMB][4][4] = {};
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int m0 = 64 * mb + 16 * (warp >> 1);
        if (m0 < Kb)
          chunk_state<T, kLD, LDV>(acc[mb], Ks, Vs, Ls, Lc, m0, n0, g, t);
      }
      if (!kc0 && c > 0) {
        if (tid == 0)
          while (!ld_acquire(flag + c - 1)) __nanosleep(64);
        __syncthreads();
      }
      const float* sp = sp0 + kc0 * p.V;
      float* sn = sn0 + kc0 * p.V;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 64 * mb + 16 * (warp >> 1) + g + 8 * half;
          const float dec = row < Kb ? expf(Ls[Lc * kLD + row]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = n0 + nt * 8 + 2 * t + e;
              const bool in = row < Kb && j < Vw;
              const float sv = in ? ld_relaxed(sp + row * p.V + j) : 0.f;
              Ss[row * kLDS + j] = sv;
              if (in)
                __stcg(sn + row * p.V + j,
                       fmaf(dec, sv, acc[mb][nt][2 * half + e]));
            }
          }
        }
      }
      __syncthreads();     // S_c's rows are in; their S_{c+1} is issued
      if (tid == 0 && c + 1 < p.nc && kc0 + kWideK >= K) {
        __threadfence();
        st_release(flag + c, 1);
      }
    }
    if (!active) continue;

    // this block's share of the outputs' contractions over K
    const float* Lref = Ls + a * kLD;                 // exclusive sum at a
    const float* Ma = Ls + (rwkv ? ta : ta + 1) * kLD;
    const float* Mb = Ls + (rwkv ? tb : tb + 1) * kLD;
    const int nks = (Kb + 7) / 8;                     // k-steps that hold Kb
    const auto q_of = [&](int ks, float (&q)[4]) {
      const int cc = ks * 8 + 2 * t;
      const float2 lr = pair(Lref + cc), ma = pair(Ma + cc),
                   mb = pair(Mb + cc);
      const float2 ra = pair(Rs + ta * kLD + cc), rb = pair(Rs + tb * kLD + cc);
      q[0] = ra.x * fexp<P>(ma.x - lr.x);
      q[1] = rb.x * fexp<P>(mb.x - lr.x);
      q[2] = ra.y * fexp<P>(ma.y - lr.y);
      q[3] = rb.y * fexp<P>(mb.y - lr.y);
    };
    // the cross term (r exp(M - Lref)) exp(Lref) S_c
    for (int ks = 0; ks < nks; ++ks) {
      const int cc = ks * 8 + 2 * t;
      float q[4];
      q_of(ks, q);
      const float2 lr = pair(Lref + cc);
      const float e0 = expf(lr.x), e1 = expf(lr.y);
      const float x[4] = {q[0] * e0, q[1] * e0, q[2] * e1, q[3] * e1};
      uint32_t xh[4], xl[4];
      split4<P>(x, xh, xl);
#pragma unroll
      for (int nt = 0; nt < kVT / 8; ++nt) {
        const int j = nt * 8 + g;
        mma3<P, false>(y[nt], xh, xl, Ss[cc * kLDS + j],
                       Ss[(cc + 1) * kLDS + j]);
      }
    }
    if (rwkv) {            // a warp a row, lane l: channels 2l, 2l + 1, ...
      for (int i = 0; i < kSB; ++i) {
        const int row = a + i;
        float d = 0.f;
#pragma unroll
        for (int q = 0; q < kWideK / 64; ++q) {
          const int cc = 2 * lane + 64 * q;
          const float2 uu =
              make_float2(cc < Kb ? __ldg(p.u + h * K + kc0 + cc) : 0.f,
                          cc + 1 < Kb ? __ldg(p.u + h * K + kc0 + cc + 1)
                                      : 0.f);
          const float2 rr = pair(Rs + row * kLD + cc);
          const float2 kk = pair(Ks + row * kLD + cc);
          d += fmaf(rr.x * uu.x, kk.x, rr.y * uu.y * kk.y);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (i == g) da += d;
        if (i == g + 8) db += d;
      }
    }
    // the intra scores of every key block up to the diagonal
#pragma unroll
    for (int jb = 0; jb < kKB; ++jb) {
      if (jb > sb) break;
      const int s0 = jb * kSB;
      float Ah[2][4] = {}, Ac[2][4] = {};
      for (int ks = 0; ks < nks; ++ks) {
        const int cc = ks * 8 + 2 * t;
        const float2 lr = pair(Lref + cc);
        float qv[4];
        q_of(ks, qv);
        uint32_t qh[4], ql[4];
        split4<P>(qv, qh, ql);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          const int s = s0 + n2 * 8 + g;
          const float2 kk = pair(Ks + s * kLD + cc);
          const float2 ls = pair(Ls + (s + 1) * kLD + cc);
          mma3x2<P>(Ah[n2], Ac[n2], qh, ql, kk.x * fexp<P>(lr.x - ls.x),
                    kk.y * fexp<P>(lr.y - ls.y));
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) A[jb][n2][e] += Ah[n2][e] + Ac[n2][e];
    }
  }
  if (!active) return;

  // y += A v over the key blocks, the diagonal one masked: s < t (RWKV6),
  // s <= t (Mamba2)
#pragma unroll
  for (int jb = 0; jb < kKB; ++jb) {
    if (jb > sb) break;
    const int s0 = jb * kSB;
    if (jb == sb) {
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ta : tb;
          const int s = s0 + n2 * 8 + 2 * t + (e & 1);
          if (rwkv ? s >= row : s > row) A[jb][n2][e] = 0.f;
        }
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      const float af[4] = {A[jb][n2][0], A[jb][n2][2], A[jb][n2][1],
                           A[jb][n2][3]};
      uint32_t ah[4], al[4];
      split4<P>(af, ah, al);
      const int sk = s0 + n2 * 8 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kVT / 8; ++nt) {
        const int j = nt * 8 + g;
        mma3<P, !P>(y[nt], ah, al, to_f32(Vs[sk * LDV + j]),
                    to_f32(Vs[(sk + 1) * LDV + j]));
      }
    }
  }
  store_y<T, LDV>(p, y, da, db, Vs, b, h, t0, v0, Vw, Lc, ta, tb, t);
}

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, const Params& p, int BH,
           cudaStream_t st) {
  // the most shared memory an SM can give, so that two CTAs fit
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = BH * p.nc * ((p.V + kVT - 1) / kVT);
  kernel<<<n, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The steps a sub-block holds at K channels (the kernel the launcher
// picks for K; past 128 the channel-block kernel's 256-channel tiles); 0
// where K is out of range or the dtype unknown
int sub_steps(int dtype, int K) {
  const bool half = dtype == 1 || dtype == 2;
  if (K <= 0 || dtype < 0 || dtype > 2) return 0;
  if (K <= 64) return max_steps<float, 64>();
  if (channel_blocks(K) == 0)
    return half ? max_steps<__nv_bfloat16, 128>() : max_steps<float, 128>();
  return half ? max_steps<__nv_bfloat16, kWideK>()
              : max_steps<float, kWideK>();
}

template <typename T>
int launch_k(const Params& p, int BH, cudaStream_t st) {
  if (channel_blocks(p.K))
    return launch(chunk_scan_wide_kernel<T>, smem_bytes<T, kWideK>(), p, BH,
                  st);
  if (p.K <= 64)
    return launch(chunk_scan_kernel<T, 64>, smem_bytes<T, 64>(), p, BH, st);
  return launch(chunk_scan_kernel<T, 128>, smem_bytes<T, 128>(), p, BH, st);
}

}  // namespace

extern "C" {

// The steps of one sub-block at K channels in `dtype` (0: f32, 1: bf16,
// 2: f16): a chunk longer than this runs as sub-blocks of it, in order
// (the last one shorter); 0 for K < 1 or an unknown dtype.
int chunk_scan_sub_steps(int dtype, int K) { return sub_steps(dtype, K); }

// The blocks of 256 channels the launch at K channels streams (the
// channel-block kernel, past 128 channels), or 0 (chunk_scan_kernel).
int chunk_scan_channel_blocks(int K) { return channel_blocks(K); }

// r, k, ld (B, T, H, K) and v (B, T, H, V) with 16 element strides in
// `strides` (batch, time, head, channel of r, k, v, ld; ld's channel
// stride 0 for a scalar per-head decay); r, k, v of one dtype (0: f32, 1:
// bf16, 2: f16), ld f32 as the model gives it (clamped here).  s0 (B, H, K, V)
// f32, u (H, K) f32 (read only when !include_current), y (B, T, H, V) in
// the dtype and s_fin (B, H, K, V) f32, all contiguous on the current
// device.  Chunks of Lc steps (T % Lc == 0) run as sub-blocks of `sub`
// steps (0 < sub <= chunk_scan_sub_steps(dtype, K), the last one of a
// chunk shorter): nc = T / Lc * ceil(Lc / sub) of them.  work (B H, nc, K,
// V) f32 scratch and sync (1 + B H nc ceil(V / 64) int32) zeroed.  Needs
// K > 0, V > 0.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
int chunk_scan_launch(const void* r, const void* k, const void* v,
                      const void* ld, const void* s0, const void* u,
                      void* y, void* sfin, void* work, void* sync, int dtype,
                      int B, int T, int H, int K, int V, int Lc, int sub,
                      int include_current, const long long* strides,
                      void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || K <= 0 || V <= 0 || Lc <= 0 ||
      T % Lc != 0 || sub <= 0 || sub > sub_steps(dtype, K) ||
      (!include_current && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsub = (Lc + sub - 1) / sub;
  if (static_cast<long long>(B) * H * (T / Lc) * nsub *
          ((V + kVT - 1) / kVT) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.ld = static_cast<const float*>(ld);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.sfin = static_cast<float*>(sfin);
  p.work = static_cast<float*>(work);
  p.sync = static_cast<int*>(sync);
  p.T = T;
  p.H = H;
  p.K = K;
  p.V = V;
  p.Lc = Lc;
  p.sub = sub;
  p.nsub = nsub;
  p.nc = T / Lc * nsub;
  p.include_current = include_current;
  p.vpair = V % 2 == 0;
  for (int i = 0; i < 4; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[4 + i];
    p.vs[i] = strides[8 + i];
    p.ls[i] = strides[12 + i];
  }
  {   // 16-byte loads: unit channel strides, 16-byte aligned rows
    const auto al = [](const void* q) {
      return reinterpret_cast<uintptr_t>(q) % 16 == 0;
    };
    const auto rows16 = [](const long long* st4, int e) {
      return st4[3] == 1 && st4[0] % e == 0 && st4[1] % e == 0 &&
             st4[2] % e == 0;
    };
    const int E = dtype == 0 ? 4 : 8;
    p.vec = K % E == 0 && V % E == 0 && al(r) && al(k) && al(v) &&
            rows16(strides, E) && rows16(strides + 4, E) &&
            rows16(strides + 8, E);
    p.ld_vec = K % 4 == 0 && al(ld) && rows16(strides + 12, 4);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k<float>(p, B * H, st);
  if (dtype == 1) return launch_k<__nv_bfloat16>(p, B * H, st);
  return launch_k<__half>(p, B * H, st);
}

const char* chunk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
