// Tile layer shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) on Hopper (sm_90a): float32 products on the tensor
// cores as 3xTF32 `mma.sync` m16n8k8 tiles, `cp.async` staging, and the
// reference's sweep rules.
//
// Operands.  q, k, v and dO arrive as float32, bfloat16 or float16 (one type
// E for all of them); every product and every softmax step is float32, as
// the reference computes on the upcast operands.  A tile is staged raw (E
// rows, so a 16-bit row is half the bytes) and converted to float32 where it
// is read or pre-split.  A 16-bit value is exact in TF32 (bfloat16 has 7
// mantissa bits, float16 10, TF32 10), so its small part is zero: `mma3`
// drops the products of a zero small part (`AX`/`BX`), which adds exactly
// zero to the accumulator, so the result is the one of all three products.
//
// 3xTF32.  A float32 x is split into big = tf32(x) (`cvt.rna`) and
// small = tf32(x - big); a product adds small*big + big*small + big*big with
// float32 accumulation, dropping only small*small (about 2^-22 of the
// product), so the result keeps float32-level accuracy where a single TF32
// product (about 2^-11) would not.
//
// Fragments of m16n8k8 (row.col, tf32 operands, f32 accumulator), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8):   b0 (k=t, n=g)   b1 (k=t+4, n=g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// An accumulator tile serves as the A operand of the next product without a
// shuffle: a0=c0, a1=c2, a2=c1, a3=c3, so k-slot t stands for column 2t and
// k-slot t+4 for column 2t+1.  The B operand of that product is then read
// from shared memory in the same permuted row order (b0 row 2t, b1 row 2t+1;
// `frag_b_kn_perm`).
//
// Shared-memory tiles are rows of D elements padded by 16 bytes (D+4 floats,
// D+8 16-bit values): both fragment read patterns, [g][t] and [2t][g], then
// fall on distinct banks (a 16-bit pair shares a word, a broadcast), and
// every row stays 16-byte aligned for `cp.async`.
//
// Sweep rules of the reference kernels (singa_tpu/ops/pallas_kernels.py
// `_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`): masked scores are -1e9, never
// -inf; with `causal` a query row sweeps key columns up to the end of its
// diagonal 128-block; columns past the sweep carry no weight; the key axis is
// zero-padded to 128 columns, whose -1e9 scores the forward adds in closed
// form (n_pad * exp(-1e9 - m)); the denominator is clamped at 1e-30.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// ---- operand types ---------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// Two float32 results rounded to E (nearest even) and stored at p (p is
// 8-byte aligned for float32, 4-byte for the 16-bit types).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void store1(__half* p, float a) {
  *p = __float2half_rn(a);
}

// Whether every value of E is exact in TF32 (its 3xTF32 small part is 0).
template <typename E>
constexpr bool kExact = !std::is_same<E, float>::value;

// Row pitch in elements of a staged tile of D-element rows: 16 bytes of pad.
template <int D, typename E>
constexpr int kLd = D + 16 / (int)sizeof(E);

// e^x as 2^(x log2 e): a multiply and the MUFU ex2, shorter than expf.
__device__ __forceinline__ float fexp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

constexpr int REF_BLOCK = 128;  // the reference kernels' block size
constexpr int BM = 64;          // query rows (keys in dk/dv) a block owns
constexpr int PLAN_BN = 64;     // keys a unit of the forward's key split
constexpr int NWARP = 4;        // 16 rows a warp
constexpr int NT = 32 * NWARP;
constexpr float NEG = -1e9f;

enum { MODE_NONE = 0, MODE_VEC = 1, MODE_DENSE = 2 };

// ---- the reference's sweep ------------------------------------------------

// End of the key columns swept by the query tile starting at row r0,
// padding included (BM divides REF_BLOCK, so the tile lies in one
// reference query block).
__device__ __forceinline__ int sweep_hi(int r0, int S, int causal) {
  const int Sp = ((S + REF_BLOCK - 1) / REF_BLOCK) * REF_BLOCK;
  return causal ? min(Sp, (r0 / REF_BLOCK + 1) * REF_BLOCK) : Sp;
}

// First query row that sweeps the key tile starting at column c0.
__device__ __forceinline__ int sweep_lo(int c0, int causal) {
  return causal ? (c0 / REF_BLOCK) * REF_BLOCK : 0;
}

// The mask row of batch*head bh (the operand is (MB, 1|T, S), MB in {1, BH}).
__device__ __forceinline__ const float* mask_base(const float* mask, int mode,
                                                  int mask_bh, int bh, int T,
                                                  int S) {
  if (mode == MODE_DENSE && mask_bh) return mask + (size_t)bh * T * S;
  if (mode == MODE_VEC && mask_bh) return mask + (size_t)bh * S;
  return mask;
}

// ---- 3xTF32 ---------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: small*big, big*small, then big*big.  AX (BX): a's
// (b's) values are exact in TF32, so its small part is zero and the product
// with it is dropped.
template <bool AX = false, bool BX = false>
__device__ __forceinline__ void mma3(float c[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!AX) mma_tf32(c, a.small, b.big);
  if constexpr (!BX) mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

// An accumulator tile as the A operand of the next product (see above).
__device__ __forceinline__ FragA acc_as_a(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// A from a row-major tile s[m][k] (leading dimension ld): rows m0..m0+15,
// columns k0..k0+7.
template <typename E>
__device__ __forceinline__ FragA frag_a(const E* s, int ld, int m0, int k0,
                                        int g, int t) {
  const E* p = s + (m0 + g) * ld + k0 + t;
  return split_a(to_f(p[0]), to_f(p[8 * ld]), to_f(p[4]),
                 to_f(p[8 * ld + 4]));
}

// B(k, n) = s[n][k] from a row-major tile s[n][k]: rows n0..n0+7, columns
// k0..k0+7 (the K or V tile of a product with its transpose).
template <typename E>
__device__ __forceinline__ FragB frag_b_nk(const E* s, int ld, int n0, int k0,
                                           int g, int t) {
  const E* p = s + (n0 + g) * ld + k0 + t;
  FragB f;
  split(to_f(p[0]), f.big[0], f.small[0]);
  split(to_f(p[4]), f.big[1], f.small[1]);
  return f;
}

// B(k, n) = s[k][n] from a row-major tile s[k][n] in the permuted row order
// of an accumulator-fed A: b0 row k0+2t, b1 row k0+2t+1, column n0+g.
template <typename E>
__device__ __forceinline__ FragB frag_b_kn_perm(const E* s, int ld, int k0,
                                                int n0, int g, int t) {
  const E* p = s + (k0 + 2 * t) * ld + n0 + g;
  FragB f;
  split(to_f(p[0]), f.big[0], f.small[0]);
  split(to_f(p[ld]), f.big[1], f.small[1]);
  return f;
}

// ---- pre-split tiles ------------------------------------------------------
//
// A streamed tile is split once per block, not once per warp: after its raw
// rows land, every thread converts a share of it into float4s of
// {big, big, small, small} laid out so that one 16-byte read gives a lane
// both halves of its B fragment, free of bank conflicts (each 8-lane phase
// of the read falls on 8 distinct 16-byte bank groups).
//   nk:   for B(k, n) = s[n][k] (`frag_b_nk`): row n, float4 kk*4 + t holds
//         s[n][8kk+t], s[n][8kk+t+4]; rows of D/2 + 4 float4s.
//   perm: for B(k, n) = s[k][n] in the permuted row order
//         (`frag_b_kn_perm`): row pair p, float4 c holds s[2p][c],
//         s[2p+1][c]; pairs of D + 2 float4s.

template <int D>
struct PreSplit {
  static constexpr int NK4 = D / 2 + 4;  // float4s a nk row
  static constexpr int PERM4 = D + 2;    // float4s a perm row pair
};

__device__ __forceinline__ float4 split4(float x0, float x1) {
  uint32_t b0, s0, b1, s1;
  split(x0, b0, s0);
  split(x1, b1, s1);
  return make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(s0), __uint_as_float(s1));
}

// raw: ROWS rows of D values of E with leading dimension kLd<D, E>; the
// values become float32 here.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void presplit_nk(float4* dst, const E* raw,
                                            int tid) {
  constexpr int PER = ROWS * D / 2;
  constexpr int LD = kLd<D, E>;
#pragma unroll
  for (int it = 0; it < (PER + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (PER % NT != 0 && i >= PER) break;
    const int n = i / (D / 2);
    const int r = i % (D / 2);  // kk * 4 + t
    const E* p = raw + n * LD + (r / 4) * 8 + r % 4;
    dst[n * PreSplit<D>::NK4 + r] = split4(to_f(p[0]), to_f(p[4]));
  }
}

template <int ROWS, int D, typename E>
__device__ __forceinline__ void presplit_perm(float4* dst, const E* raw,
                                              int tid) {
  constexpr int PER = ROWS / 2 * D;
  constexpr int LD = kLd<D, E>;
#pragma unroll
  for (int it = 0; it < (PER + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (PER % NT != 0 && i >= PER) break;
    const int pr = i / D;
    const int c = i % D;
    const E* p = raw + 2 * pr * LD + c;
    dst[pr * PreSplit<D>::PERM4 + c] = split4(to_f(p[0]), to_f(p[LD]));
  }
}

__device__ __forceinline__ FragB unpack_b(float4 f) {
  FragB b;
  b.big[0] = __float_as_uint(f.x);
  b.big[1] = __float_as_uint(f.y);
  b.small[0] = __float_as_uint(f.z);
  b.small[1] = __float_as_uint(f.w);
  return b;
}

// frag_b_nk from a pre-split nk tile: rows n0..n0+7, k-step kk.
template <int D>
__device__ __forceinline__ FragB frag_b_nk_pre(const float4* s, int n0,
                                               int kk, int g, int t) {
  return unpack_b(s[(n0 + g) * PreSplit<D>::NK4 + kk * 4 + t]);
}

// frag_b_kn_perm from a pre-split perm tile: rows k0..k0+7 (k0 even),
// columns n0..n0+7.
template <int D>
__device__ __forceinline__ FragB frag_b_perm_pre(const float4* s, int k0,
                                                 int n0, int g, int t) {
  return unpack_b(s[(k0 / 2 + t) * PreSplit<D>::PERM4 + n0 + g]);
}

// ---- cp.async staging -----------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows row0..row0+ROWS-1 of a (n, D) matrix of E into
// s[ROWS][kLd<D, E>]; rows at or past `nvalid` are zero-filled.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void load_rows(E* s, const E* g, int row0,
                                          int nvalid, int tid) {
  constexpr int W = 16 / (int)sizeof(E);  // values a 16-byte chunk
  constexpr int CH = D / W;               // chunks a row
  static_assert(D % W == 0, "a row must be whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < (ROWS * CH + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if ((ROWS * CH) % NT != 0 && i >= ROWS * CH) break;
    const int r = i / CH;
    const int c = (i % CH) * W;
    const int gr = row0 + r;
    const bool ok = gr < nvalid;
    cp_async16(s + r * kLd<D, E> + c, g + (size_t)(ok ? gr : 0) * D + c, ok);
  }
}

// ---- quad reductions (the four lanes that share an accumulator row) ------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash
