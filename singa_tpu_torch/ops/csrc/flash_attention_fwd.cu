// Flash-attention forward for Hopper (sm_90a), on 3xTF32 tensor-core tiles
// (flash_mma.cuh): float32, bfloat16 or float16 operands, float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (singa_tpu/ops/pallas_kernels.py,
// launched by `_flash_fwd_call`).  Same contract: q (BH, T, D), k/v (BH, S, D),
// D in {16, 32, 64, 128}, any T and S; an optional additive mask carried at
// its natural rank ("vec": (MB, 1, S), "dense": (MB, T, S), MB in {1, BH});
// causal masking computed from indices; masked scores set to -1e9 (never
// -inf); the online-softmax recurrence started at m = -1e9; l clamped to
// 1e-30; a per-row logsumexp written beside the output for the backward pass.
// q, k and v share one type E (float32, bfloat16 or float16); the kernel
// computes the float32 function of the upcast values, as the reference's
// `_fwd_kernel` does, and writes o in E (rounded once, to nearest even) and
// lse, the split partials and the mask in float32.  With 16-bit operands
// QK^T takes one TF32 product instead of three (both operands exact in
// TF32) and PV two (V exact, P not): P is never rounded to 16 bits.
// The reference pads the key axis to its 128-column block with zero K/V and
// a -1e9 score.  Those columns weigh nothing unless a whole row is masked,
// where they join the uniform average; this kernel does not read them and
// adds their count in closed form at the end (n_pad * exp(-1e9 - m)).
//
// What bounds it.  At the training shape (BH 96, T = S = 1024, D 64, causal)
// the work, 12.9 GFLOP over the 50.4 M pairs the function needs, bounds it:
// 0.078 ms at the 3xTF32 rate (495 / 3 TFLOP/s), against 0.1 ms of bytes.
// At the serving shape (64 queries against 1,024 keys, 12 heads) the 7 MB of
// inputs and outputs bound it (2.1 us), and the problem is filling the card.
//
// Design.  A block of 4 warps owns 64 query rows, 16 a warp.  Each warp
// holds its rows' Q as split 3xTF32 A fragments in registers (D <= 64; at
// D 128 Q stays in shared memory and is split as it is read).  K/V tiles of
// 32 keys go through a two-stage cp.async ring into rows padded to D+4 (32
// rather than 64 keys: 188 registers at D 64 against 223, and 5 % faster on
// an H100 at 700 W).
// Each warp splits the K/V values it reads itself: pre-splitting the tile
// once per block (as the backward does) measured no faster on the H100.  Per
// tile: S = Q K^T (m16n8k8, three products a float32 product), then scale,
// mask and the causal rule on the accumulator fragments, the online softmax
// (row max over the quad by two shuffles; each lane keeps its partial row
// sum, summed over the quad once at the end), then O += P V with P fed from
// the accumulator as the A operand (flash_mma.cuh).  With `causal`, key
// tiles past the diagonal 128-block are never loaded, tiles wholly below
// the diagonal skip the per-element causal test, and the longest query
// tiles are dispatched first, which shortens the tail of the grid (0.44 to
// 0.37 ms at the training shape on the H100).
//
// Key split.  Where BH x query tiles under-fills the card (the serving
// shape: 12 blocks on 132 SMs), the wrapper cuts each tile's swept keys
// into contiguous ranges of `per` 64-key units (grid z = range).  Each range
// writes its unnormalised O, its running max m and its denominator l to
// scratch; `flash_fwd_combine` merges a row's ranges (M = max m,
// l = sum l_i e^(m_i - M), o = sum o_i e^(m_i - M) / l), adds the padding
// term, clamps l and writes o and lse.  No atomics: the result is
// deterministic.

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <int D, typename E>
struct FwdCfg {
  static constexpr bool QREG = D <= 64;  // Q fragments in registers
  static constexpr int BNF = 32;         // keys a streamed tile
  static constexpr int LD = kLd<D, E>;
  static constexpr int TILE = BNF * LD;  // values of one K or V tile
  static constexpr int SMEM =
      (4 * TILE + (QREG ? 0 : BM * LD)) * (int)sizeof(E);
};

template <int D, typename E>
__global__ void __launch_bounds__(NT, 1) flash_fwd_mma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ mask,
    E* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int BH, int T, int S, int mode, int mask_bh,
    int causal, float scale, int per) {
  using C = FwdCfg<D, E>;
  constexpr int LD = C::LD;
  constexpr bool EX = kExact<E>;
  constexpr int KT = D / 8;   // k-steps of Q K^T
  constexpr int BNF = C::BNF;
  constexpr int NS = BNF / 8;  // n-tiles of a score tile
  constexpr int NO = D / 8;   // n-tiles of the output
  extern __shared__ float4 smem4[];
  E* smem = reinterpret_cast<E*>(smem4);  // [stage][K, V], then Q
  E* qs = smem + 4 * C::TILE;

  // heavy causal tiles first: blocks are dispatched in x-fastest order
  const int bh = blockIdx.x;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int range = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = tile * BM;
  const int rA = r0 + warp * 16 + g;  // this lane's two accumulator rows
  const int rB = rA + 8;

  const int hi = sweep_hi(r0, S, causal);
  const int kend = min(S, hi);
  // range r covers the key columns [r, r + 1) * per * PLAN_BN of the sweep
  const int k_begin = range * per * PLAN_BN;
  const int k_stop = min(kend, k_begin + per * PLAN_BN);
  if (k_begin >= k_stop) return;  // an empty range: the combine skips it

  const E* qb = q + (size_t)bh * T * D;
  const E* kb = k + (size_t)bh * S * D;
  const E* vb = v + (size_t)bh * S * D;
  const float* mb = mask_base(mask, mode, mask_bh, bh, T, S);

  load_rows<BNF, D>(smem, kb, k_begin, kend, tid);
  load_rows<BNF, D>(smem + C::TILE, vb, k_begin, kend, tid);
  if constexpr (!C::QREG) load_rows<BM, D>(qs, qb, r0, T, tid);
  cp_async_commit();

  FragA qf[C::QREG ? KT : 1];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 8 + t;
      const float a0 = rA < T ? to_f(qb[(size_t)rA * D + c]) : 0.f;
      const float a1 = rB < T ? to_f(qb[(size_t)rB * D + c]) : 0.f;
      const float a2 = rA < T ? to_f(qb[(size_t)rA * D + c + 4]) : 0.f;
      const float a3 = rB < T ? to_f(qb[(size_t)rB * D + c + 4]) : 0.f;
      qf[kk] = split_a(a0, a1, a2, a3);
    }
  }

  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float mA = NEG, mB = NEG;  // running max of rows rA, rB
  float lA = 0.f, lB = 0.f;  // this lane's share of their denominators

  for (int j0 = k_begin, st = 0; j0 < k_stop; j0 += BNF, st ^= 1) {
    if (j0 + BNF < k_stop) {
      E* nxt = smem + (st ^ 1) * 2 * C::TILE;
      load_rows<BNF, D>(nxt, kb, j0 + BNF, kend, tid);
      load_rows<BNF, D>(nxt + C::TILE, vb, j0 + BNF, kend, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Ks = smem + st * 2 * C::TILE;
    const E* Vs = Ks + C::TILE;

    float sacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      FragA a;
      if constexpr (C::QREG)
        a = qf[kk];
      else
        a = frag_a(qs, LD, warp * 16, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma3<EX, EX>(sacc[n], a, frag_b_nk(Ks, LD, n * 8, kk * 8, g, t));
    }

    // scale, mask, the causal rule and the sweep's edge
    const bool diag = causal && j0 + BNF - 1 > r0;
    const bool edge = j0 + BNF > kend;
    float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? rA : rB;
        const int col = j0 + n * 8 + 2 * t + (e & 1);
        float x = sacc[n][e] * scale;
        if (mode == MODE_DENSE) {
          if (row < T && col < kend) x += mb[(size_t)row * S + col];
        } else if (mode == MODE_VEC) {
          if (col < kend) x += mb[col];
        }
        if (diag && col > row) x = NEG;
        if (edge && col >= kend) x = -INFINITY;  // past the sweep: no weight
        sacc[n][e] = x;
        if (e < 2)
          mxA = fmaxf(mxA, x);
        else
          mxB = fmaxf(mxB, x);
      }
    }
    const float mnA = fmaxf(mA, quad_max(mxA));
    const float mnB = fmaxf(mB, quad_max(mxB));
    const float alA = fexp(mA - mnA);
    const float alB = fexp(mB - mnB);
    mA = mnA;
    mB = mnB;
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sacc[n][0] = fexp(sacc[n][0] - mA);
      sacc[n][1] = fexp(sacc[n][1] - mA);
      sacc[n][2] = fexp(sacc[n][2] - mB);
      sacc[n][3] = fexp(sacc[n][3] - mB);
      sA += sacc[n][0] + sacc[n][1];
      sB += sacc[n][2] + sacc[n][3];
    }
    lA = lA * alA + sA;
    lB = lB * alB + sB;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      oacc[j][0] *= alA;
      oacc[j][1] *= alA;
      oacc[j][2] *= alB;
      oacc[j][3] *= alB;
    }

    // O += P V, P fed from the accumulator as the A operand
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA a = acc_as_a(sacc[n]);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        mma3<false, EX>(oacc[j], a, frag_b_kn_perm(Vs, LD, n * 8, j * 8, g, t));
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  lA = quad_sum(lA);
  lB = quad_sum(lB);
  const int c0 = 2 * t;
  if (o_part == nullptr) {
    // the reference's swept zero-padded columns, each scored -1e9
    const int n_pad = hi - kend;
    if (n_pad > 0) {
      lA += (float)n_pad * fexp(NEG - mA);
      lB += (float)n_pad * fexp(NEG - mB);
    }
    lA = fmaxf(lA, 1e-30f);
    lB = fmaxf(lB, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (rA < T)
        store2(o + ((size_t)bh * T + rA) * D + j * 8 + c0, oacc[j][0] / lA,
               oacc[j][1] / lA);
      if (rB < T)
        store2(o + ((size_t)bh * T + rB) * D + j * 8 + c0, oacc[j][2] / lB,
               oacc[j][3] / lB);
    }
    if (t == 0) {
      if (rA < T) lse[(size_t)bh * T + rA] = mA + logf(lA);
      if (rB < T) lse[(size_t)bh * T + rB] = mB + logf(lB);
    }
  } else {
    const size_t base = ((size_t)range * BH + bh) * T;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (rA < T)
        *reinterpret_cast<float2*>(o_part + (base + rA) * D + j * 8 + c0) =
            make_float2(oacc[j][0], oacc[j][1]);
      if (rB < T)
        *reinterpret_cast<float2*>(o_part + (base + rB) * D + j * 8 + c0) =
            make_float2(oacc[j][2], oacc[j][3]);
    }
    if (t == 0) {
      if (rA < T) {
        m_part[base + rA] = mA;
        l_part[base + rA] = lA;
      }
      if (rB < T) {
        m_part[base + rB] = mB;
        l_part[base + rB] = lB;
      }
    }
  }
}

// One thread per output element: merges the row's non-empty ranges and
// writes o in E.
template <typename E>
__global__ void __launch_bounds__(256) flash_fwd_combine(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, E* __restrict__ o,
    float* __restrict__ lse, int BH, int T, int S, int D, int causal,
    int per) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * T * D) return;
  const int c = (int)(idx % D);
  const size_t rowg = idx / D;  // bh * T + row
  const int row = (int)(rowg % T);
  const int hi = sweep_hi((row / BM) * BM, S, causal);
  const int kend = min(S, hi);
  const int nr = ((kend + PLAN_BN - 1) / PLAN_BN + per - 1) / per;
  const size_t stride = (size_t)BH * T;
  float M = NEG;
  for (int r = 0; r < nr; ++r) M = fmaxf(M, m_part[r * stride + rowg]);
  float l = 0.f, acc = 0.f;
  for (int r = 0; r < nr; ++r) {
    const size_t i = r * stride + rowg;
    const float w = fexp(m_part[i] - M);
    l += l_part[i] * w;
    acc += o_part[i * D + c] * w;
  }
  const int n_pad = hi - kend;
  if (n_pad > 0) l += (float)n_pad * fexp(NEG - M);
  l = fmaxf(l, 1e-30f);
  store1(o + idx, acc / l);
  if (c == 0) lse[rowg] = M + logf(l);
}

template <int D, typename E>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* o, float* lse, float* o_part, float* m_part, float* l_part,
           int BH, int T, int S, int mode, int mask_bh, int causal,
           float scale, int n_split, int per, cudaStream_t stream) {
  using C = FwdCfg<D, E>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (T + BM - 1) / BM, n_split);
  flash_fwd_mma<D, E><<<grid, NT, C::SMEM, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), mask, static_cast<E*>(o), lse, o_part, m_part,
      l_part, BH, T, S, mode, mask_bh, causal, scale, per);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* mask,
             void* o, float* lse, float* o_part, float* m_part,
             float* l_part, int BH, int T, int S, int D, int mode,
             int mask_bh, int causal, float scale, int n_split, int per,
             cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, E>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, mode, mask_bh, causal, scale, n_split, per, st);
    case 32: return launch<32, E>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, mode, mask_bh, causal, scale, n_split, per, st);
    case 64: return launch<64, E>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, mode, mask_bh, causal, scale, n_split, per, st);
    case 128: return launch<128, E>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, mode, mask_bh, causal, scale, n_split, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  `dtype` is the
// type of q, k, v and o: 0 float32, 1 bfloat16, 2 float16; lse, the mask and
// the partials are float32.
//
// n_split == 1: o and lse are written; o_part, m_part and l_part are unused
// (pass per >= the number of swept key tiles).  n_split > 1: range r of a
// query tile covers its swept key tiles [r * per, (r + 1) * per) and writes
// o_part (n_split, BH, T, D), m_part and l_part (n_split, BH, T); o and lse
// are unused until singa_flash_attention_fwd_combine.
extern "C" int singa_flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* mask, void* o,
    float* lse, float* o_part, float* m_part, float* l_part, int BH, int T,
    int S, int D, int mode, int mask_bh, int causal, int n_split, int per,
    int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || per < 1 || (n_split > 1 && o_part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_split == 1) o_part = m_part = l_part = nullptr;
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, D, mode, mask_bh, causal, scale, n_split, per, st);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, D, mode, mask_bh, causal, scale, n_split, per, st);
    case 2: return launch_d<__half>(q, k, v, mask, o, lse, o_part, m_part, l_part, BH, T, S, D, mode, mask_bh, causal, scale, n_split, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// `dtype` is o's type, coded as above.
extern "C" int singa_flash_attention_fwd_combine(
    const float* o_part, const float* m_part, const float* l_part, void* o,
    float* lse, int BH, int T, int S, int D, int causal, int per, int dtype,
    void* stream) {
  if (per < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)BH * T * D;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      flash_fwd_combine<<<blocks, 256, 0, st>>>(
          o_part, m_part, l_part, static_cast<float*>(o), lse, BH, T, S, D,
          causal, per);
      break;
    case 1:
      flash_fwd_combine<<<blocks, 256, 0, st>>>(
          o_part, m_part, l_part, static_cast<__nv_bfloat16*>(o), lse, BH, T,
          S, D, causal, per);
      break;
    case 2:
      flash_fwd_combine<<<blocks, 256, 0, st>>>(
          o_part, m_part, l_part, static_cast<__half*>(o), lse, BH, T, S, D,
          causal, per);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
