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
// 3.35 TB/s).  So both products run on the tensor cores, S, P and O stay
// out of device memory (q, k and v are read once a CTA, out written
// once), and only the key blocks the mask can reach are visited, which
// halves a causal prefill's work.  The TPU kernel keeps P in f32 for P V;
// here each probability is split into two bf16 halves, p = hi + lo to 16
// significant bits, and O += hi V + lo V, so P carries no bf16 rounding
// into the output (the row sums l come from the same f32 probabilities).
// That costs P V twice its flops: the work is 1.5 times the algorithm's.
//
// Five kernels, picked by the launcher by dtype and head dim:
//
// bf16, hd 64, 80 and 128 (the serving paths): flash_wgmma_kernel, built
// from Hopper's warpgroup instructions.  A CTA of three warpgroups owns 128
// query rows of one (batch, head).  Warpgroup 0 is the producer: one of
// its threads issues every copy.  Warpgroups 1 and 2 are consumers of 64
// rows each.  setmaxnreg moves registers from the producer (24 a thread)
// to the consumers (240).
// - Loads: TMA copies through 4-D tensor maps over (hd, S, heads, B),
//   built by the launcher from the views' strides, in boxes of one
//   swizzle row's columns (64, 128-byte swizzle; at hd 80, 16 with 32-byte
//   swizzle, five boxes a row): Q once, then K and V tiles of 128 keys,
//   each through its own ring of two stages with mbarriers for full (the
//   copy's bytes have landed) and empty (both consumers are done with the
//   tile).  TMA zero-fills rows past Sq and Sk, so masked keys carry no
//   NaN.
// - S = Q K^T: wgmma m64n128k16, both operands in shared memory
//   (K-major, as swizzled).  Its accumulator has mma.sync's (g, t) fragment
//   layout, so the masks, the online max and sum in log2 units
//   (ex2.approx) and the mask-free path of blocks no mask touches work on
//   it as they did there.
// - O += P V: wgmma m64n{hd}k16 with P's hi and lo halves from registers
//   as A and V read MN-major (transposed) from its key-major tile.
// - Schedule: turn i of a consumer issues S of key block i and P V of
//   block i - 1 together, then runs block i's softmax while P V and the
//   other consumer's products keep the tensor cores busy.  Named barriers
//   make the two consumers take turns at issuing (ping-pong), so that one
//   softmax overlaps the other's products.  A consumer waits for, and
//   releases, every tile, but skips the products of a block none of its
//   64 rows can reach.
// - ptxas serialises every wgmma of the kernel when a register that an
//   issued wgmma reads is written before the wait that retires it; the
//   turn is ordered so that it does not (-Xptxas -v reports C7513 if it
//   does).  P is split into its A fragments only after the wait for the
//   P V that read the last ones.
//
// f16 at every head dim up to 256, bf16 at the others, and bf16 at hd 64,
// 80 and 128 where TMA cannot map q, k or v (byte strides or a base that
// are not multiples of 16) or B * H passes grid.y's 65,535:
// flash_mma_kernel, mma.sync.m16n8k16 with 4 warps of 16
// rows each, K and V staged by cp.async (see its note), instantiated at
// tile widths 32, 64, 96, 128, 160, 192 and 256 for each of the two types.
//
// f32 (tests and model-level parity), every hd up to 256: flash_f32_kernel,
// full f32 on the FMA units, never TF32: a CTA of 128 threads owns 32
// query rows, four threads to a row, each computing 4 of every 16 keys'
// scores and a quarter of the row's output dims.  It is there to be
// exact, not fast.  Tile widths 32, 64, 80, 96, 128, 160, 192 and 256.
//
// Any head dim from 1 to 256 runs on the smallest tile that holds it: the
// columns past hd are zero in shared memory, so they add nothing to q.k or
// to P.V, only hd columns are stored, and the scale is the wrapper's
// 1/sqrt(hd).  Rows that are not 16-byte aligned (a head dim or a stride
// that is not a multiple of 16 bytes, or a base that is not aligned) take
// element loads.  B * H above 65,535 strides through grid.y inside the
// mma.sync and f32 kernels (the wgmma kernel's grid keeps one (batch,
// head) a row of CTAs; the wrapper sends such a B * H to flash_mma_kernel).
//
// Above 256, whole tiles of the head dim would pass shared memory and O's
// accumulator the registers: flash_mma_wide_kernel (bf16, f16) and
// flash_f32_wide_kernel split O's columns into groups of 256 over grid.z
// and build each key block's scores from 64-column pieces of Q and K (see
// their note), at any head dim.  Every group recomputes Q K^T.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's finite mask value
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 256;    // the widest tile (shared memory)
constexpr int kMaxGridY = 65535;    // grid.y's extent

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, rep;                 // rep = H / KV
  int BH;                             // B * H: grid.y strides over it
  int hd;                             // the true head dim (<= the tile's)
  int vec;                            // 16-byte loads of q, k and v
  int opair;                          // out's rows take bf16 pair stores
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

// Copies rows [row0, row0 + ROWS) and columns [0, hd) of an (nrows, hd)
// f32 matrix with row stride `stride` (elements) into shared memory with
// row stride LD; rows at or past `nrows` and columns hd..HD are zero (masked
// keys must not carry NaN from past the end, and the padded columns add
// nothing to q.k or to P.V).  vec: 16-byte loads (hd a multiple of 4,
// 16-byte aligned rows); else one element a thread at a time.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int nrows, int hd, bool vec) {
  if (vec) {
    constexpr int kChunks = HD / 4;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int row = row0 + r;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < nrows && c * 4 < hd)
        val = __ldg(reinterpret_cast<const float4*>(src + row * stride +
                                                    c * 4));
      *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      const int row = row0 + r;
      dst[r * LD + c] = row < nrows && c < hd ? __ldg(src + row * stride + c)
                                              : 0.f;
    }
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
// bf16 and f16 off the wgmma kernel: tensor cores through mma.sync.m16n8k16
//
// A CTA of 4 warps owns 64 query rows of one (batch, head), 16 rows a
// warp, and walks its key range 64 keys at a time: S = Q K^T with Q held
// in registers as A fragments for the whole walk, then O += P V with P
// taken straight from S's accumulator registers.  K and V tiles are staged
// in shared memory by cp.async, rows padded by 16 bytes so that each 8-row
// ldmatrix phase hits 32 distinct banks; V of this block lands while
// S = Q K^T runs, K of the next block while O += P V runs.
//
// HD is the tile's width, a multiple of 32 (two k-steps an ldmatrix.x4);
// a head dim hd below it is zero-filled to HD in shared memory and only
// its hd columns are stored.  Above 160 columns Q's fragments would not
// fit beside O's accumulator (HD / 2 floats a thread): Q stays in shared
// memory and each k-step reads its fragment there (kQSmem).  The tiles
// are dynamic shared memory: 64 (HD + 8) 16-bit elements each for K and
// V, and for Q when kQSmem (101 KB at HD 256).  T is __nv_bfloat16 or
// __half: the same kernel, its operands and P's halves in that type.
// ---------------------------------------------------------------------------

// The 16-bit operand types: their pairs, conversions and m16n8k16 product
// (c += a (16x16, row) * b (16x8, col); fragments as in the PTX ISA's
// m16n8k16 layout: g = lane / 4 and t = lane % 4 own rows g and g + 8,
// columns 2t, 2t + 1 (+ 8 for a[2], a[3] and b[1])).
template <typename T> struct Half16;

template <> struct Half16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ T2 pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 wide(T2 x) {
    return __bfloat1622float2(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float a) {
    return __float2bfloat16(a);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Half16<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ T2 pair(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float2 wide(T2 x) {
    return __half22float2(x);
  }
  static __device__ __forceinline__ __half one(float a) {
    return __float2half(a);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  const typename Half16<T>::T2 v = Half16<T>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a pair of T: hi is (x0, x1) rounded to T, lo
// the rounded remainder, so hi + lo is within 2^-17 (bf16; f16 2^-23) of
// (x0, x1)
template <typename T>
__device__ __forceinline__ void split16(float x0, float x1, uint32_t* hi,
                                        uint32_t* lo) {
  const typename Half16<T>::T2 h = Half16<T>::pair(x0, x1);
  const float2 hf = Half16<T>::wide(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack16<T>(x0 - hf.x, x1 - hf.y);
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

// Starts the copy of rows [row0, row0 + ROWS) and columns [0, hd) of an
// (nrows, hd) matrix of T with row stride `stride` into shared memory with
// row stride LD; rows at or past `nrows` and columns hd..HD are zero-filled
// (masked keys must not carry NaN from past the end; the padded columns
// add nothing to q.k or P.V).  vec: cp.async in 16-byte pieces (hd a
// multiple of 8, 16-byte aligned rows); else element loads and stores,
// synchronous, which the barriers that follow every copy order as they
// order cp.async's.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long stride, int row0,
                                                int nrows, int hd, bool vec) {
  if (vec) {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int row = row0 + r;
      const bool valid = row < nrows && c * 8 < hd;
      cp_async16(dst + r * LD + c * 8,
                 src + (valid ? row : 0) * stride + (valid ? c * 8 : 0),
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      const int row = row0 + r;
      dst[r * LD + c] = row < nrows && c < hd ? src[row * stride + c]
                                              : Half16<T>::one(0.f);
    }
  }
}

// 2^x (the scores are kept in log2 units: scale * log2(e) is folded into
// the one multiply that scales them)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key block's online softmax in a warp's (16 x BK) score tile s (S's
// accumulator: rows g, g + 8, of each 8-key tile keys 2t, 2t + 1): scale
// into log2 units, mask, take the running max m, exponentiate in place and
// fold the block into the running sum l, and rescale O's accumulator o by
// the change of the max.
template <int BQ, int BK, int NT_O>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4],
                                               float (&o)[NT_O][4],
                                               float (&m)[2], float (&l)[2],
                                               const Params& p, int q0,
                                               int k0, const int (&qpos)[2],
                                               int t, float scl) {
  constexpr int NT_S = BK / 8;
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
}

// O += P V over one key block: S's accumulator tiles 2kt and 2kt + 1 are
// P's A fragment, as hi and lo halves of T; V's tile (BK keys, pitch LD)
// read transposed by ldmatrix.
template <typename T, int BK, int NT_O, int LD>
__device__ __forceinline__ void pv_product(float (&o)[NT_O][4],
                                           const float (&s)[BK / 8][4],
                                           const T* Vs, int lm, int lr) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    uint32_t a[4], a_lo[4];
    split16<T>(s[2 * kt][0], s[2 * kt][1], &a[0], &a_lo[0]);
    split16<T>(s[2 * kt][2], s[2 * kt][3], &a[1], &a_lo[1]);
    split16<T>(s[2 * kt + 1][0], s[2 * kt + 1][1], &a[2], &a_lo[2]);
    split16<T>(s[2 * kt + 1][2], s[2 * kt + 1][3], &a[3], &a_lo[3]);
#pragma unroll
    for (int d = 0; d < NT_O; d += 2) {
      uint32_t vf[4];   // b0, b1 of n-tile d, then of d + 1
      ldsm_x4<true>(vf, Vs + (kt * 16 + (lm & 1) * 8 + lr) * LD +
                            (d + (lm >> 1)) * 8);
      Half16<T>::mma(o[d], a, vf[0], vf[1]);
      Half16<T>::mma(o[d], a_lo, vf[0], vf[1]);
      Half16<T>::mma(o[d + 1], a, vf[2], vf[3]);
      Half16<T>::mma(o[d + 1], a_lo, vf[2], vf[3]);
    }
  }
}

// O / l of this thread's two rows into og (row stride p.os), the columns
// below `ncols` of the NT_O tiles
template <typename T, int NT_O>
__device__ __forceinline__ void store_rows(const float (&o)[NT_O][4],
                                           const float (&l)[2], T* og,
                                           const Params& p,
                                           const int (&qpos)[2], int t,
                                           int ncols) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(quad_sum(l[i]), 1e-30f);
    if (qpos[i] >= p.Sq) continue;
    T* orow = og + qpos[i] * p.os;
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      const int col = d * 8 + 2 * t;
      const float x0 = o[d][2 * i] / denom, x1 = o[d][2 * i + 1] / denom;
      if (p.opair && col + 1 < ncols) {
        *reinterpret_cast<typename Half16<T>::T2*>(orow + col) =
            Half16<T>::pair(x0, x1);
      } else {
        if (col < ncols) orow[col] = Half16<T>::one(x0);
        if (col + 1 < ncols) orow[col + 1] = Half16<T>::one(x1);
      }
    }
  }
}

// Three CTAs an SM up to HD 64: a cap of 168 registers a thread; two at 96
// and 128, where Q's fragments and O's accumulator need more; above, one
// (O's accumulator alone is HD / 2 registers).
template <int HD>
struct MmaTile {
  static constexpr int BQ = 64, BK = 64, LD = HD + 8;
  static constexpr bool kQSmem = HD > 160;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;
  static constexpr int kBytes = ((kQSmem ? BQ : 0) + 2 * BK) * LD * 2;
};

// The query tiles of (batch, head) blockIdx.y, then of blockIdx.y +
// gridDim.y, ...: B * H above grid.y's 65,535 strides through the grid,
// and every head keeps the heaviest-first order of its tiles on grid.x.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, MmaTile<HD>::kMinBlocks)
    flash_mma_kernel(Params p) {
  using Tl = MmaTile<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LD = Tl::LD;
  constexpr bool kQSmem = Tl::kQSmem;
  constexpr int KSTEPS = HD / 16;     // k-steps of S = Q K^T
  constexpr int NT_S = BK / 8;        // n-tiles of S
  constexpr int NT_O = HD / 8;        // n-tiles of O
  static_assert(HD % 32 == 0, "two k-steps an ldmatrix.x4");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  T* Ks = reinterpret_cast<T*>(flash_smem);
  T* Vs = Ks + BK * LD;
  T* Qs = kQSmem ? Vs + BK * LD : Vs;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int hd = p.hd;
  const bool vec = p.vec;
  const float scl = p.scale * 1.4426950408889634f;   // scores in log2 units
  const int r0 = warp * 16 + g;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);

  for (int bh = blockIdx.y; bh < p.BH; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H, kvh = h / p.rep;
    const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
    const T* kg = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
    const T* vg = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;
    T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;

    // Q through the V buffer (its own when kQSmem), K's first tile into the
    // K buffer
    load_tile_async<T, HD, LD, BQ>(Qs, qg, p.qs, q0, p.Sq, hd, vec);
    cp_async_commit();
    if (lo < hi)
      load_tile_async<T, HD, LD, BK>(Ks, kg, p.ks, lo, p.Sk, hd, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // Q's A fragment of k-step kt: from registers, or read from Qs
    uint32_t qf[kQSmem ? 1 : KSTEPS][4];
    const auto q_frag = [&](uint32_t (&f)[4], int kt) {
      ldsm_x4<false>(f, Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + kt * 16 +
                            (lm >> 1) * 8);
    };
    if constexpr (!kQSmem) {
#pragma unroll
      for (int kt = 0; kt < KSTEPS; ++kt) q_frag(qf[kt], kt);
    }

    float o[NT_O][4];
#pragma unroll
    for (int d = 0; d < NT_O; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int k0 = lo; k0 < hi; k0 += BK) {
      cp_async_wait<0>();   // this block's K tile has landed
      __syncthreads();      // ... for every thread; V (and Q) reads are done
      load_tile_async<T, HD, LD, BK>(Vs, vg, p.vs, k0, p.Sk, hd, vec);
      cp_async_commit();

      // S = Q K^T while V lands
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kQSmem) {
#pragma unroll
        for (int kt = 0; kt < KSTEPS; kt += 2) {
          uint32_t qa[4], qb[4];
          q_frag(qa, kt);
          q_frag(qb, kt + 1);
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
            uint32_t kf[4];   // b0, b1 of k-step kt, then of kt + 1
            ldsm_x4<false>(kf, Ks + (j * 8 + lr) * LD + kt * 16 + lm * 8);
            Half16<T>::mma(s[j], qa, kf[0], kf[1]);
            Half16<T>::mma(s[j], qb, kf[2], kf[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
#pragma unroll
          for (int kt = 0; kt < KSTEPS; kt += 2) {
            uint32_t kf[4];   // b0, b1 of k-step kt, then of kt + 1
            ldsm_x4<false>(kf, Ks + (j * 8 + lr) * LD + kt * 16 + lm * 8);
            Half16<T>::mma(s[j], qf[kt], kf[0], kf[1]);
            Half16<T>::mma(s[j], qf[kt + 1], kf[2], kf[3]);
          }
        }
      }

      online_softmax<BQ, BK, NT_O>(s, o, m, l, p, q0, k0, qpos, t, scl);

      cp_async_wait<0>();   // V has landed
      __syncthreads();      // ... for every thread; K reads are done
      if (k0 + BK < hi) {
        load_tile_async<T, HD, LD, BK>(Ks, kg, p.ks, k0 + BK, p.Sk, hd, vec);
        cp_async_commit();
      }

      // O += P V while the next K lands
      pv_product<T, BK, NT_O, LD>(o, s, Vs, lm, lr);
    }

    store_rows<T, NT_O>(o, l, og, p, qpos, t, hd);
    __syncthreads();        // every read of Q, K and V before the next head
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 past 256 columns: column groups, S from pieces of hd
//
// Above kMaxHeadDim, Q, K and V tiles of the whole head dim would pass
// shared memory and O's accumulator the registers.  So grid.z splits O's
// columns into groups of kWideDV = 256: the CTA of group z owns columns
// [256 z, 256 z + 256) of 64 query rows, as flash_mma_kernel<T, 256> owns
// all of them, and holds only V's columns of its group.  Its S = Q K^T
// still spans the whole head dim: it streams Q's and K's columns through
// shared memory in pieces of kWideDK = 64, two stages of cp.async (the
// copy of piece i + 1 lands while piece i's products run; V's tile lands
// beside the first piece), and adds each piece's product into S's
// accumulator.  Every CTA of a (batch, head, query tile) computes the same
// S in the same order, so their running max and sum are bit-equal and the
// output does not depend on how the columns are grouped.  The cost: Q K^T
// once a group (twice at hd 512), and Q read again for every key block
// (from L2).  Shared memory: 2 x (Q + K pieces) + V = 70,656 bytes.
// ---------------------------------------------------------------------------

constexpr int kWideDV = 256;        // O's columns a CTA
constexpr int kWideDK = 64;         // columns of a Q or K piece

struct WideTile {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LDK = kWideDK + 8, LDV = kWideDV + 8;
  static constexpr int kBytes = (2 * (BQ + BK) * LDK + BK * LDV) * 2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_mma_wide_kernel(Params p) {
  constexpr int BQ = WideTile::BQ, BK = WideTile::BK;
  constexpr int LDK = WideTile::LDK, LDV = WideTile::LDV;
  constexpr int NT_S = BK / 8, NT_O = kWideDV / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  T* Qp = reinterpret_cast<T*>(flash_smem);   // 2 stages of BQ x LDK
  T* Kp = Qp + 2 * BQ * LDK;                  // 2 stages of BK x LDK
  T* Vs = Kp + 2 * BK * LDK;                  // BK x LDV

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int c0 = blockIdx.z * kWideDV;                // this CTA's columns
  const int hd = p.hd, np = (hd + kWideDK - 1) / kWideDK;
  const bool vec = p.vec;
  const float scl = p.scale * 1.4426950408889634f;
  const int r0 = warp * 16 + g;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);

  for (int bh = blockIdx.y; bh < p.BH; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H, kvh = h / p.rep;
    const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
    const T* kg = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
    const T* vg = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh + c0;
    T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh + c0;
    // piece pc of key block k0 (Q's and K's columns 64 pc ..) into stage st
    const auto load_piece = [&](int k0, int pc, int st) {
      const int col = pc * kWideDK;
      load_tile_async<T, kWideDK, LDK, BQ>(Qp + st * BQ * LDK, qg + col,
                                           p.qs, q0, p.Sq, hd - col, vec);
      load_tile_async<T, kWideDK, LDK, BK>(Kp + st * BK * LDK, kg + col,
                                           p.ks, k0, p.Sk, hd - col, vec);
      cp_async_commit();
    };

    float o[NT_O][4];
#pragma unroll
    for (int d = 0; d < NT_O; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    int n = 0;                // pieces consumed: piece n sits in stage n & 1
    if (lo < hi) load_piece(lo, 0, 0);

    for (int k0 = lo; k0 < hi; k0 += BK) {
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int pc = 0; pc < np; ++pc, ++n) {
        cp_async_wait<0>();   // piece n has landed
        __syncthreads();      // ... for every thread; stage (n + 1) & 1 and
                              // (at pc 0) V are no longer read
        if (pc == 0) {
          load_tile_async<T, kWideDV, LDV, BK>(Vs, vg, p.vs, k0, p.Sk,
                                               hd - c0, vec);
          cp_async_commit();
        }
        if (pc + 1 < np) load_piece(k0, pc + 1, (n + 1) & 1);
        const T* Qs = Qp + (n & 1) * BQ * LDK;
        const T* Ks = Kp + (n & 1) * BK * LDK;
#pragma unroll
        for (int kt = 0; kt < kWideDK / 16; kt += 2) {
          uint32_t qa[4], qb[4];
          ldsm_x4<false>(qa, Qs + (warp * 16 + (lm & 1) * 8 + lr) * LDK +
                                 kt * 16 + (lm >> 1) * 8);
          ldsm_x4<false>(qb, Qs + (warp * 16 + (lm & 1) * 8 + lr) * LDK +
                                 (kt + 1) * 16 + (lm >> 1) * 8);
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
            uint32_t kf[4];   // b0, b1 of k-step kt, then of kt + 1
            ldsm_x4<false>(kf, Ks + (j * 8 + lr) * LDK + kt * 16 + lm * 8);
            Half16<T>::mma(s[j], qa, kf[0], kf[1]);
            Half16<T>::mma(s[j], qb, kf[2], kf[3]);
          }
        }
      }

      online_softmax<BQ, BK, NT_O>(s, o, m, l, p, q0, k0, qpos, t, scl);

      cp_async_wait<0>();     // V has landed
      __syncthreads();        // ... for every thread; the pieces are read
      if (k0 + BK < hi) load_piece(k0 + BK, 0, n & 1);

      pv_product<T, BK, NT_O, LDV>(o, s, Vs, lm, lr);
    }

    store_rows<T, NT_O>(o, l, og, p, qpos, t, hd - c0);
    __syncthreads();          // every read of Vs before the next head
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64, 80, 128: warp-specialised wgmma, K and V through TMA rings
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;     // producer + two consumer warpgroups
constexpr int kWgRows = 64;         // query rows of one consumer

// The columns of one TMA box and of one swizzle atom's row: 64 bf16 (128
// bytes, 128-byte swizzle) where the head dim is a multiple of 64, else
// 16 (32 bytes, 32-byte swizzle: hd 80 is five such boxes).
constexpr int box_cols(int hd) { return hd % 64 == 0 ? 64 : 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrives on `bar` and adds `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One box of a 4-D tensor map, at coordinates (c0, c1, c2, c3) innermost
// first, into shared memory at `dst`; completes bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a tile whose rows are BW
// bf16 columns swizzled as TMA wrote them (128-byte swizzle for 64
// columns, layout 1; 32-byte for 16, layout 3): start address, leading
// and stride byte offsets (16-byte units).  Tiles start on 1024-byte
// boundaries (base offset 0).
template <int BW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(BW == 64 || BW == 16, "128- or 32-byte swizzle");
  constexpr uint64_t layout = BW == 64 ? 1 : 3;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Named barriers 1 and 2 over the two consumer warpgroups (256 threads):
// sync waits for the other's arrive, arrive does not wait.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the point where this stands.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define WG_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_O8(i)                                                          \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),             \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

// d (64 x N, f32) = a (64 x 16) b (16 x N), a and b bf16 in shared memory,
// both K-major.  d's fragments: warp w of the warpgroup, lane (g, t):
// d[4j + c] is row 16w + g + 8 (c / 2), column 8j + 2t + c % 2.  d is
// output only, so that no register that an earlier product left behind is
// an input of this one.
template <int N>
__device__ __forceinline__ void wgmma_ss_init(float (&d)[N / 2], uint64_t a,
                                              uint64_t b);
// d += a b, as wgmma_ss_init.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b);
// d += a b with a from registers (mma.sync's m16n8k16 A fragment for the
// warp's 16 rows) and b MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss_init<128>(float (&d)[64],
                                                   uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_O8(0), WG_O8(8), WG_O8(16), WG_O8(24),
        WG_O8(32), WG_O8(40), WG_O8(48), WG_O8(56)
      : "l"(a), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F8
#undef WG_O8

constexpr int kWgBK = 128;          // keys a stage

// Dynamic shared memory of flash_wgmma_kernel, in bytes from a
// 1024-byte-aligned base: Q (the two consumers' rows, each as HD / kBW
// boxes of 64 rows x kBW columns), a ring of kStages K tiles and one of
// kStages V tiles (HD / kBW boxes of BK rows each), then the mbarriers.
template <int HD, int BK>
struct WgLayout {
  static constexpr int kBW = box_cols(HD);
  static constexpr int kBoxes = HD / kBW;
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBoxBytes = kWgRows * kBW * 2;
  static constexpr uint32_t kBoxBytes = BK * kBW * 2;     // of K or V
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kK = 2 * kBoxes * kQBoxBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // Q full; K full, V full, K empty and V empty for each stage; 1024
  // bytes of slack to align the base
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
};

template <int HD, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Params p) {
  using L = WgLayout<HD, BK>;
  constexpr int BQ = 2 * kWgRows;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  const auto full_k = [=](int s) { return bar_q + 8u * (1 + s); };
  const auto full_v = [=](int s) { return bar_q + 8u * (1 + S + s); };
  const auto empty_k = [=](int s) { return bar_q + 8u * (1 + 2 * S + s); };
  const auto empty_v = [=](int s) { return bar_q + 8u * (1 + 3 * S + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.rep;
  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);
  const int nblk = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  const int nq = q0 + kWgRows < p.Sq ? 2 : 1;   // consumers with rows

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2);     // one arrival from each consumer
      mbar_init(empty_v(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler (through the shuffle), so that the
  // descriptors it derives stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, nq * L::kBoxes * L::kQBoxBytes);
      for (int c = 0; c < nq; ++c)
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load(base + (c * L::kBoxes + j) * L::kQBoxBytes, &tq, bar_q,
                   j * L::kBW, q0 + c * kWgRows, h, b);
      for (int n = 0; n < nblk; ++n) {
        const int s = n % S, k0 = lo + n * BK;
        const uint32_t par = ((n / S) & 1) ^ 1;   // round 0 passes
        const uint32_t kd = base + L::kK + s * L::kTileBytes;
        const uint32_t vd = base + L::kV + s * L::kTileBytes;
        mbar_wait(empty_k(s), par);
        mbar_expect_tx(full_k(s), L::kTileBytes);
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load(kd + j * L::kBoxBytes, &tk, full_k(s), j * L::kBW, k0,
                   kvh, b);
        mbar_wait(empty_v(s), par);
        mbar_expect_tx(full_v(s), L::kTileBytes);
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load(vd + j * L::kBoxBytes, &tv, full_v(s), j * L::kBW, k0,
                   kvh, b);
      }
    }
  } else {
    // consumer c: query rows [qc, qc + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int qc = q0 + c * kWgRows;
    const int qpos[2] = {qc + warp * 16 + g, qc + warp * 16 + g + 8};
    // the keys these rows reach (none for rows wholly past Sq)
    const int c_hi = c >= nq ? 0 : p.causal ? min(p.Sk, qc + kWgRows) : p.Sk;
    const int c_lo = p.window ? max(0, qc - p.window + 1) : 0;
    const float scl = p.scale * 1.4426950408889634f;   // log2 units
    const uint32_t qs = base + c * L::kBoxes * L::kQBoxBytes;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // P of the previous block as hi and lo bf16 halves: A fragments of
    // keys 16kt.. (ph[kt][a] holds sc[8kt + 2a], sc[8kt + 2a + 1])
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
    if (c < nq) mbar_wait(bar_q, 0);
    if (c == 1) named_arrive(1);    // consumer 0 takes the first turn

    // Turn i (0 <= i <= nblk) issues S = Q K^T of block i and O += P V of
    // block i - 1 together, passes the turn to the other consumer, and runs
    // block i's softmax while the tensor cores work through the other's
    // products.  Blocks [n0, n1) have products for these rows; both
    // consumers take every turn and wait for and release every stage.  The
    // turns with and without products are separate loops, so that no
    // wgmma stays in flight across a branch.
    const int n0 = (c_lo - lo) / BK;
    const int n1 = max(n0, c_hi > lo ? min(nblk, (c_hi - lo + BK - 1) / BK)
                                     : 0);
    const auto wait_stage = [&](int i) {
      if (i < nblk) mbar_wait(full_k(i % S), (i / S) & 1);
      if (i > 0) mbar_wait(full_v((i - 1) % S), ((i - 1) / S) & 1);
    };
    // turn i is done with block i's K and block i - 1's V
    const auto release_k = [&](int i) {
      if (i < nblk && tid == 0) mbar_arrive(empty_k(i % S));
    };
    const auto release_v = [&](int i) {
      if (i > 0 && tid == 0) mbar_arrive(empty_v((i - 1) % S));
    };
    // Operand layouts as TMA left them: a row of a box is BW columns (one
    // swizzle row), 8 rows a swizzle atom.  K-major (Q, K): k-step kk is
    // columns 16kk.., in box 16kk / BW at byte 2 (16kk % BW) of its row;
    // 8-row groups kRow8 bytes apart.  MN-major (V): 16 keys a k-step,
    // 8-key groups kRow8 bytes apart, boxes (the next BW columns)
    // kBoxBytes apart.
    constexpr int BW = L::kBW;
    constexpr uint32_t kRow8 = 8 * BW * 2;
    const auto issue_s = [&](float (&sc)[BK / 2], int i) {
      const uint32_t ks = base + L::kK + (i % S) * L::kTileBytes;
      const auto dq = [&](int kk) {
        return smem_desc<BW>(qs + (16 * kk / BW) * L::kQBoxBytes +
                                 (16 * kk % BW) * 2, 16, kRow8);
      };
      const auto dk = [&](int kk) {
        return smem_desc<BW>(ks + (16 * kk / BW) * L::kBoxBytes +
                                 (16 * kk % BW) * 2, 16, kRow8);
      };
      wgmma_ss_init<BK>(sc, dq(0), dk(0));
#pragma unroll
      for (int kk = 1; kk < HD / 16; ++kk) wgmma_ss<BK>(sc, dq(kk), dk(kk));
      wgmma_commit();
    };
    const auto issue_pv = [&](int i) {   // block i - 1
      const uint32_t vs = base + L::kV + ((i - 1) % S) * L::kTileBytes;
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        const uint64_t dv =
            smem_desc<BW>(vs + kt * 16 * BW * 2, L::kBoxBytes, kRow8);
        wgmma_rs<HD>(o, ph[kt], dv);
        wgmma_rs<HD>(o, pl[kt], dv);
      }
      wgmma_commit();
    };
    // block i's scores to probabilities, in place: the running max and
    // sum, and O's factor for the new max
    const auto softmax = [&](float (&sc)[BK / 2], int i, float (&corr)[2]) {
      const int k0 = lo + i * BK;
      // sc[j] is row (j >> 1) & 1, key k0 + 8 (j >> 2) + 2t + (j & 1)
      float mx[2] = {m[0], m[1]};
      const bool whole = k0 + BK <= p.Sk &&
                         (!p.causal || k0 + BK <= qc + 1) &&
                         (!p.window || qc + kWgRows - 1 - k0 < p.window);
      if (whole) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          sc[j] *= scl;
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int r = (j >> 1) & 1;
          const int kpos = k0 + (j >> 2) * 8 + 2 * t + (j & 1);
          sc[j] = allowed(p, qpos[r], kpos) ? sc[j] * scl : kNegInf;
          mx[r] = fmaxf(mx[r], sc[j]);
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = exp2_approx(sc[j] - m[(j >> 1) & 1]);
        rs[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
    };
    // P into the registers the next P V reads, once the last P V is done
    const auto split = [&](const float (&sc)[BK / 2]) {
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split16<__nv_bfloat16>(sc[8 * kt + 2 * a], sc[8 * kt + 2 * a + 1],
                                 &ph[kt][a], &pl[kt][a]);
    };
    // O to the running max of the last softmax, before the P V after it
    const auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= corr[(j >> 1) & 1];
      reg_fence(o);
    };

    float corr[2];                  // O's factor from the last softmax
    int i = 0;
    for (; i < n0; ++i) {           // turns without products
      wait_stage(i);
      named_sync(1 + c);
      named_arrive(2 - c);
      release_k(i);
      release_v(i);
    }
    if (n0 < n1) {
      {                             // turn n0: S only
        float sc[BK / 2];
        wait_stage(i);
        named_sync(1 + c);
        wgmma_fence();
        issue_s(sc, i);
        named_arrive(2 - c);
        wgmma_wait<0>();
        reg_fence(sc);
        release_k(i);
        release_v(i);
        softmax(sc, i, corr);
        split(sc);
        ++i;
      }
      for (; i < n1; ++i) {         // S of block i, P V of block i - 1
        float sc[BK / 2];
        wait_stage(i);
        named_sync(1 + c);
        rescale(corr);
        wgmma_fence();
        issue_s(sc, i);
        issue_pv(i);
        named_arrive(2 - c);
        wgmma_wait<1>();            // S has landed; P V may still run
        reg_fence(sc);
        release_k(i);
        softmax(sc, i, corr);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(ph);
        reg_fence(pl);
        release_v(i);
        split(sc);
      }
      {                             // turn n1: P V only
        wait_stage(i);
        named_sync(1 + c);
        rescale(corr);
        wgmma_fence();
        issue_pv(i);
        named_arrive(2 - c);
        wgmma_wait<0>();
        reg_fence(o);
        release_k(i);
        release_v(i);
        ++i;
      }
    }
    for (; i <= nblk; ++i) {        // turns without products
      wait_stage(i);
      named_sync(1 + c);
      named_arrive(2 - c);
      release_k(i);
      release_v(i);
    }

    __nv_bfloat16* og =
        static_cast<__nv_bfloat16*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
      if (qpos[r] >= p.Sq) continue;
      __nv_bfloat16* orow = og + qpos[r] * p.os + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                  o[4 * j + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units, full precision
// ---------------------------------------------------------------------------

template <int HD>
struct F32Tile {
  static constexpr int BQ = 32, BK = 16, LD = HD + 4, LDP = BK + 1;
  static constexpr int kBytes = ((BQ + 2 * BK) * LD + BQ * LDP) * 4;
};

// HD is the tile's width; a head dim hd below it is zero-filled in shared
// memory and only its hd columns are stored.  The tiles are dynamic
// shared memory (67 KB at HD 256).  B * H strides through grid.y as in
// flash_mma_kernel.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Params p) {
  using Tl = F32Tile<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LD = Tl::LD, LDP = Tl::LDP;
  constexpr int NS = BK / 4;          // scores per thread per key block
  constexpr int ND = HD / 4;          // output dims per thread
  extern __shared__ __align__(16) unsigned char flash_smem[];
  float* Qs = reinterpret_cast<float*>(flash_smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hd = p.hd;
  const bool vec = p.vec;
  const int qpos = q0 + r;
  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);

  for (int bh = blockIdx.y; bh < p.BH; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H, kvh = h / p.rep;
    const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
    const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
    const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
    float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh;

    load_tile_f32<HD, LD, BQ>(Qs, qg, p.qs, q0, p.Sq, hd, vec);
    float acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    float m = kNegInf, l = 0.f;

    for (int k0 = lo; k0 < hi; k0 += BK) {
      __syncthreads();   // every thread is done with the last K/V tiles
      load_tile_f32<HD, LD, BK>(Ks, kg, p.ks, k0, p.Sk, hd, vec);
      load_tile_f32<HD, LD, BK>(Vs, vg, p.vs, k0, p.Sk, hd, vec);
      __syncthreads();

      float s[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float qv = Qs[r * LD + d];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          s[j] = fmaf(qv, Ks[(u + 4 * j) * LD + d], s[j]);
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
    if (qpos < p.Sq) {
      float* orow = og + qpos * p.os;
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (u + 4 * i < hd) orow[u + 4 * i] = acc[i] / denom;
    }
    __syncthreads();     // every read of Q, K and V before the next head
  }
}

// f32 past 256 columns: the column groups of flash_mma_wide_kernel on the
// FMA units.  The CTA of group blockIdx.z owns kWideDV of O's columns of
// 32 query rows (a quarter of them a thread, ND = 64 accumulators) and
// holds V's columns of its group; each key block's scores sum over the
// whole head dim in pieces of kWideDK columns of Q and K, loaded in turn.
// Every group computes the same scores in the same order.  Shared memory:
// Q and K pieces, V's 16 x 256 tile and P: 31,872 bytes.
struct F32WideTile {
  static constexpr int BQ = 32, BK = 16;
  static constexpr int LDK = kWideDK + 4, LDV = kWideDV + 4, LDP = BK + 1;
  static constexpr int kBytes =
      ((BQ + BK) * LDK + BK * LDV + BQ * LDP) * 4;
};

__global__ void __launch_bounds__(kThreads) flash_f32_wide_kernel(Params p) {
  using Tl = F32WideTile;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LDK = Tl::LDK, LDV = Tl::LDV,
                LDP = Tl::LDP;
  constexpr int NS = BK / 4;          // scores per thread per key block
  constexpr int ND = kWideDV / 4;     // output columns per thread
  extern __shared__ __align__(16) unsigned char flash_smem[];
  float* Qs = reinterpret_cast<float*>(flash_smem);
  float* Ks = Qs + BQ * LDK;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int c0 = blockIdx.z * kWideDV;
  const int hd = p.hd;
  const bool vec = p.vec;
  const int qpos = q0 + r;
  int lo, hi;
  key_range(p, q0, BQ, BK, &lo, &hi);

  for (int bh = blockIdx.y; bh < p.BH; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H, kvh = h / p.rep;
    const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
    const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
    const float* vg =
        static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh + c0;
    float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh + c0;

    float acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    float m = kNegInf, l = 0.f;

    for (int k0 = lo; k0 < hi; k0 += BK) {
      __syncthreads();   // every thread is done with the last V tile and P
      load_tile_f32<kWideDV, LDV, BK>(Vs, vg, p.vs, k0, p.Sk, hd - c0, vec);
      float s[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = 0.f;
      for (int col = 0; col < hd; col += kWideDK) {
        __syncthreads();   // every thread is done with the last pieces
        load_tile_f32<kWideDK, LDK, BQ>(Qs, qg + col, p.qs, q0, p.Sq,
                                        hd - col, vec);
        load_tile_f32<kWideDK, LDK, BK>(Ks, kg + col, p.ks, k0, p.Sk,
                                        hd - col, vec);
        __syncthreads();
        for (int d = 0; d < kWideDK; ++d) {
          const float qv = Qs[r * LDK + d];
#pragma unroll
          for (int j = 0; j < NS; ++j)
            s[j] = fmaf(qv, Ks[(u + 4 * j) * LDK + d], s[j]);
        }
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
          acc[i] = fmaf(pk, Vs[kk * LDV + u + 4 * i], acc[i]);
      }
    }

    const float denom = fmaxf(quad_sum(l), 1e-30f);
    if (qpos < p.Sq) {
      float* orow = og + qpos * p.os;
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (c0 + u + 4 * i < hd) orow[u + 4 * i] = acc[i] / denom;
    }
    __syncthreads();     // every read of V and P before the next head
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library needs no link against libcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// Error codes of the launcher beside cudaError_t's
constexpr int kErrNoEncoder = 1 << 20;      // no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = 1 << 21;      // + the driver's CUresult

// A bf16 4-D tensor map with zero fill past the bounds, its swizzle the
// box row's width (128 bytes for 64 columns, 32 for 16).  spec: dims (hd,
// S, heads, B), byte strides of S, heads and B, box (box_cols(hd), rows, 1,
// 1) — computed by the wrapper (ops.py).
int encode_map(CUtensorMap* map, const void* ptr, const long long* spec,
               int hd, int rows) {
  if (spec[0] != hd || spec[7] != box_cols(hd) || spec[8] != rows ||
      spec[9] != 1 || spec[10] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(spec[i]);
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(spec[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(spec[7 + i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_cols(hd) == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

template <int HD>
int launch_wgmma(const Params& p, const long long* tma, int B,
                 cudaStream_t st) {
  using L = WgLayout<HD, kWgBK>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {p.q, p.k, p.v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_map(&maps[i], ptrs[i], tma + 11 * i, HD,
                              i == 0 ? kWgRows : kWgBK);
    if (rc != 0) return rc;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, kWgBK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Sq + 2 * kWgRows - 1) / (2 * kWgRows), B * p.H);
  flash_wgmma_kernel<HD, kWgBK><<<grid, kWgThreads, L::kBytes, st>>>(
      maps[0], maps[1], maps[2], p);
  return 0;
}

// One launch of a kernel whose tiles are dynamic shared memory: the
// attribute is set when they pass the 48 KB a launch gets without it.
template <typename Kernel>
int launch_smem(Kernel kernel, dim3 grid, int bytes, const Params& p,
                cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return 0;
}

template <typename T, int HD>
int launch_mma(const Params& p, int gy, cudaStream_t st) {
  using Tl = MmaTile<HD>;
  return launch_smem(flash_mma_kernel<T, HD>,
                     dim3((p.Sq + Tl::BQ - 1) / Tl::BQ, gy), Tl::kBytes, p,
                     st);
}

// the smallest tile that holds hd
template <typename T>
int launch_mma_hd(const Params& p, int gy, cudaStream_t st) {
  const int hd = p.hd;
  return hd <= 32    ? launch_mma<T, 32>(p, gy, st)
         : hd <= 64  ? launch_mma<T, 64>(p, gy, st)
         : hd <= 96  ? launch_mma<T, 96>(p, gy, st)
         : hd <= 128 ? launch_mma<T, 128>(p, gy, st)
         : hd <= 160 ? launch_mma<T, 160>(p, gy, st)
         : hd <= 192 ? launch_mma<T, 192>(p, gy, st)
                     : launch_mma<T, 256>(p, gy, st);
}

template <int HD>
int launch_f32(const Params& p, int gy, cudaStream_t st) {
  using Tl = F32Tile<HD>;
  return launch_smem(flash_f32_kernel<HD>,
                     dim3((p.Sq + Tl::BQ - 1) / Tl::BQ, gy), Tl::kBytes, p,
                     st);
}

// The groups of kWideDV output columns the launch at head dim hd splits
// O into: 0 where one CTA holds the head dim (hd <= kMaxHeadDim)
int column_groups(int hd) {
  return hd <= kMaxHeadDim ? 0 : (hd + kWideDV - 1) / kWideDV;
}

// Past kMaxHeadDim: one CTA a (query tile, (batch, head), group of
// kWideDV columns)
int launch_wide(const Params& p, int dtype, int gy, cudaStream_t st) {
  const int groups = column_groups(p.hd);
  if (dtype == 0)
    return launch_smem(flash_f32_wide_kernel,
                       dim3((p.Sq + F32WideTile::BQ - 1) / F32WideTile::BQ,
                            gy, groups),
                       F32WideTile::kBytes, p, st);
  const dim3 grid((p.Sq + WideTile::BQ - 1) / WideTile::BQ, gy, groups);
  return dtype == 1 ? launch_smem(flash_mma_wide_kernel<__nv_bfloat16>, grid,
                                  WideTile::kBytes, p, st)
                    : launch_smem(flash_mma_wide_kernel<__half>, grid,
                                  WideTile::kBytes, p, st);
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// dtype (0: f32, 1: bf16, 2: f16) on the current device, head dim
// contiguous, hd >= 1.  `strides` holds 12 element strides: batch, sequence
// and head of q, k, v and out.  `tma` (bf16 at hd 64, 80, 128 with B * H <=
// 65,535 and views TMA can map, else null) holds the tensor maps of q, k
// and v, 11 numbers each: dims (hd, S, heads, B), byte strides of S, heads
// and B, box (box_cols(hd), rows, 1, 1) with 64 rows for q and 128 keys
// for k and v.  Launches on `stream` and returns the launch's cudaError_t
// (0 on success), or a tensor-map error (see flash_attention_error_string);
// it does not synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Sq, int Sk,
                           int H, int KV, int hd, const long long* strides,
                           const long long* tma, int causal, int window,
                           float scale, void* stream) {
  const long long BH = static_cast<long long>(B) * H;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0 || hd < 1 || dtype < 0 || dtype > 2 ||
      (hd + kWideDV - 1) / kWideDV > kMaxGridY || BH > 2147483647LL ||
      (tma != nullptr && (BH > kMaxGridY || dtype != 1)))
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
  p.BH = static_cast<int>(BH);
  p.hd = hd;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.ob = strides[9]; p.os = strides[10]; p.oh = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  {   // 16-byte loads: hd and the strides in 16-byte pieces, aligned bases
    const int e = dtype == 0 ? 4 : 8;
    const auto al = [](const void* x, int n) {
      return reinterpret_cast<uintptr_t>(x) % n == 0;
    };
    bool vec = hd % e == 0 && al(q, 16) && al(k, 16) && al(v, 16);
    for (int i = 0; i < 9; ++i) vec = vec && strides[i] % e == 0;
    p.vec = vec;
    bool pair = al(out, 4);
    for (int i = 9; i < 12; ++i) pair = pair && strides[i] % 2 == 0;
    p.opair = pair;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gy = static_cast<int>(BH < kMaxGridY ? BH : kMaxGridY);
  // the only dispatch: by dtype, head dim and whether TMA can map q, k, v
  int rc;
  if (column_groups(hd)) {
    rc = launch_wide(p, dtype, gy, st);
  } else if (tma != nullptr) {
    switch (hd) {
      case 64: rc = launch_wgmma<64>(p, tma, B, st); break;
      case 80: rc = launch_wgmma<80>(p, tma, B, st); break;
      case 128: rc = launch_wgmma<128>(p, tma, B, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 1) {
    rc = launch_mma_hd<__nv_bfloat16>(p, gy, st);
  } else if (dtype == 2) {
    rc = launch_mma_hd<__half>(p, gy, st);
  } else {
    rc = hd <= 32    ? launch_f32<32>(p, gy, st)
         : hd <= 64  ? launch_f32<64>(p, gy, st)
         : hd <= 80  ? launch_f32<80>(p, gy, st)
         : hd <= 96  ? launch_f32<96>(p, gy, st)
         : hd <= 128 ? launch_f32<128>(p, gy, st)
         : hd <= 160 ? launch_f32<160>(p, gy, st)
         : hd <= 192 ? launch_f32<192>(p, gy, st)
                     : launch_f32<256>(p, gy, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The groups of 256 output columns the launch at head dim hd runs (the
// column-group kernels, past 256), or 0 (one CTA holds the head dim).
int flash_attention_column_groups(int hd) { return column_groups(hd); }

const char* flash_attention_error_string(int code) {
  if (code == kErrNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled";
  if (code >= kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less "
           "2^21 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
