// Flash-attention backward for Hopper (sm_90a), on 3xTF32 tensor-core tiles
// (flash_mma.cuh): the dq pass and the dk/dv pass, on float32, bfloat16 or
// float16 operands with float32 arithmetic.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (singa_tpu/ops/pallas_kernels.py, launched by `_flash_bwd_call`).  Same
// contract as the forward (csrc/flash_attention_fwd.cu): q/dO/dq (BH, T, D),
// k/v/dk/dv (BH, S, D), D in {16, 32, 64, 128}, the additive mask at its
// natural rank ("vec": (MB, 1, S), "dense": (MB, T, S), MB in {1, BH}),
// causal masking from indices with masked scores set to -1e9, `lse` (BH, T)
// from the forward and `delta = rowsum(dO * O)` (BH, T) computed before the
// launch.  q, k, v and dO share one type E (float32, bfloat16 or float16);
// dq is written in E as are dk and dv, each rounded once from its float32
// sum; lse, delta and the mask are float32.  As the reference's kernels do,
// every step computes on the upcast values: a raw E tile becomes float32 in
// the block's pre-split pass (or where a resident tile is read), and with
// 16-bit operands the products of two E tiles (Q K^T, dO V^T and their
// transposes) take one TF32 product instead of three and those of an E tile
// with P or dS two; P and dS stay float32.
//
// Both passes recompute p = exp(s - lse) over exactly the (row, column) pairs
// the reference sweeps and form ds = p * (dp - delta) for every swept pair,
// masked ones included.  On an ordinary row a masked pair has p == 0; on a
// fully masked row lse is -1e9 and every swept pair has p == 1, so masked
// pairs inside the diagonal 128-block carry gradient there, as in the
// reference.  The causal sweep is the reference's 128-block one: row r sees
// columns < (r / 128 + 1) * 128, and column c is seen by rows >= (c / 128) * 128.
// The reference's zero-padded key columns have zero K and V, so they add
// nothing to dq and their dk/dv are cut off; these kernels do not read them.
// Padded query rows carry a zero cotangent and add nothing to dk/dv.
//
// What bounds them.  At the training shape (BH 96, T = S = 1024, D 64,
// causal) the 50.4 M pairs the function needs cost dq 6 D flops a pair
// (19.4 GFLOP, 0.117 ms at the 3xTF32 rate of 495 / 3 TFLOP/s) and dk/dv
// 8 D (25.8 GFLOP, 0.156 ms), against ~0.06 ms of bytes: the work bounds
// both.
//
// Design.  Every block owns its output rows: no atomics, a deterministic
// result.  Four warps, 16 rows a warp.  All four products of a tile are
// m16n8k8 3xTF32 `mma.sync`, and the second product of each pair takes the
// first's accumulator as its A operand (flash_mma.cuh), so nothing is
// shuffled or written back to shared memory.  Each streamed tile lands raw
// by cp.async and is then split once for the whole block into the
// pre-split layouts its products read (flash_mma.cuh), so a B fragment is
// one 16-byte read and no warp repeats another's split: against splitting
// in every warp this took dq from 0.66 to 0.49 ms and dk/dv from 0.97 to
// 0.75 ms at the training shape on an H100 (700 W).  The next raw tile loads while the block
// computes on the split one.
//   dq:    a block owns 64 query rows (Q, dO resident in shared memory,
//          split as read; lse, delta in registers); K/V tiles of 32 keys
//          stream over the swept columns.  Per tile S = Q K^T and
//          dP = dO V^T, p = exp(s - lse), dS = p (dP - delta), dQ += dS K,
//          K split in both orientations from the one raw tile; dq is scaled
//          at the end.
//   dk/dv: a block owns 64 keys (K as split fragments in registers, V in
//          shared memory; both in shared memory at D 128); Q/dO tiles of 16
//          queries stream from the first query 128-block that sees the
//          keys.  It computes the transposed scores S^T = K Q^T and
//          dP^T = V dO^T, so that P^T and dS^T land in the accumulator as
//          the A operands of dV += P^T dO and dK += dS^T Q; lse and delta
//          are indexed by the accumulator's column (the query).  16-query
//          tiles, and the two last products one after the other, keep it
//          within 255 registers without spills at D 64.  dk is scaled at
//          the end.

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <int D, typename E>
struct DqCfg {
  static constexpr int BNB = 32;  // keys a streamed tile
  static constexpr int LD = kLd<D, E>;
  static constexpr int RAW = BNB * LD;
  static constexpr int NKP = BNB * PreSplit<D>::NK4;         // float4s
  static constexpr int PERMP = BNB / 2 * PreSplit<D>::PERM4;  // float4s
  // pre-split K (nk, perm) and V (nk); resident Q, dO; raw K, V
  static constexpr int SMEM =
      (2 * NKP + PERMP) * 16 + (2 * BM * LD + 2 * RAW) * (int)sizeof(E);
};

template <int D, typename E>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_mma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ mask,
    const E* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dq, int T, int S,
    int mode, int mask_bh, int causal, float scale) {
  using C = DqCfg<D, E>;
  constexpr int LD = C::LD;
  constexpr bool EX = kExact<E>;
  constexpr int KT = D / 8;
  constexpr int NS = C::BNB / 8;
  constexpr int NO = D / 8;
  extern __shared__ float4 smem4[];
  float4* knk = smem4;
  float4* vnk = knk + C::NKP;
  float4* kperm = vnk + C::NKP;
  E* qs = reinterpret_cast<E*>(kperm + C::PERMP);
  E* dos = qs + BM * LD;
  E* kraw = dos + BM * LD;
  E* vraw = kraw + C::RAW;

  // heavy causal tiles first: blocks are dispatched in x-fastest order
  const int bh = blockIdx.x;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = tile * BM;
  const int rA = r0 + warp * 16 + g;
  const int rB = rA + 8;

  const int kend = min(S, sweep_hi(r0, S, causal));

  const size_t qoff = (size_t)bh * T * D;
  const E* kb = k + (size_t)bh * S * D;
  const E* vb = v + (size_t)bh * S * D;
  const float* mb = mask_base(mask, mode, mask_bh, bh, T, S);

  load_rows<BM, D>(qs, q + qoff, r0, T, tid);
  load_rows<BM, D>(dos, dout + qoff, r0, T, tid);
  load_rows<C::BNB, D>(kraw, kb, 0, kend, tid);
  load_rows<C::BNB, D>(vraw, vb, 0, kend, tid);
  cp_async_commit();

  const float LA = rA < T ? lse[(size_t)bh * T + rA] : 0.f;
  const float LB = rB < T ? lse[(size_t)bh * T + rB] : 0.f;
  const float dlA = rA < T ? delta[(size_t)bh * T + rA] : 0.f;
  const float dlB = rB < T ? delta[(size_t)bh * T + rB] : 0.f;

  float dqacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    dqacc[j][0] = dqacc[j][1] = dqacc[j][2] = dqacc[j][3] = 0.f;

  for (int j0 = 0; j0 < kend; j0 += C::BNB) {
    cp_async_wait<0>();
    __syncthreads();
    presplit_nk<C::BNB, D>(knk, kraw, tid);
    presplit_nk<C::BNB, D>(vnk, vraw, tid);
    presplit_perm<C::BNB, D>(kperm, kraw, tid);
    __syncthreads();
    if (j0 + C::BNB < kend) {
      load_rows<C::BNB, D>(kraw, kb, j0 + C::BNB, kend, tid);
      load_rows<C::BNB, D>(vraw, vb, j0 + C::BNB, kend, tid);
      cp_async_commit();
    }

    float sacc[NS][4], pacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const FragA aq = frag_a(qs, LD, warp * 16, kk * 8, g, t);
      const FragA ad = frag_a(dos, LD, warp * 16, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mma3<EX, EX>(sacc[n], aq, frag_b_nk_pre<D>(knk, n * 8, kk, g, t));
        mma3<EX, EX>(pacc[n], ad, frag_b_nk_pre<D>(vnk, n * 8, kk, g, t));
      }
    }

    const bool diag = causal && j0 + C::BNB - 1 > r0;
    const bool edge = j0 + C::BNB > kend;
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
        float p = fexp(x - (e < 2 ? LA : LB));
        if (edge && col >= kend) p = 0.f;  // past the sweep
        sacc[n][e] = p * (pacc[n][e] - (e < 2 ? dlA : dlB));  // dS
      }
    }

    // dQ += dS K: K in the permuted row order of the accumulator-fed A
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA a = acc_as_a(sacc[n]);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        mma3<false, EX>(dqacc[j], a,
                        frag_b_perm_pre<D>(kperm, n * 8, j * 8, g, t));
    }
  }

  const int c0 = 2 * t;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (rA < T)
      store2(dq + qoff + (size_t)rA * D + j * 8 + c0, dqacc[j][0] * scale,
             dqacc[j][1] * scale);
    if (rB < T)
      store2(dq + qoff + (size_t)rB * D + j * 8 + c0, dqacc[j][2] * scale,
             dqacc[j][3] * scale);
  }
}

template <int D, typename E>
struct DkvCfg {
  static constexpr bool KREG = D <= 64;  // K fragments in registers
  static constexpr int BNB = 16;  // queries a streamed tile
  static constexpr int LD = kLd<D, E>;
  static constexpr int RAW = BNB * LD;
  static constexpr int NKP = BNB * PreSplit<D>::NK4;         // float4s
  static constexpr int PERMP = BNB / 2 * PreSplit<D>::PERM4;  // float4s
  // pre-split Q and dO (nk, perm); raw Q, dO; resident V (and K at D 128)
  static constexpr int SMEM =
      (2 * NKP + 2 * PERMP) * 16 +
      (2 * RAW + (KREG ? 1 : 2) * BM * LD) * (int)sizeof(E);
};

template <int D, typename E>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_mma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ mask,
    const E* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dk,
    E* __restrict__ dv, int T, int S, int mode, int mask_bh, int causal,
    float scale) {
  using C = DkvCfg<D, E>;
  constexpr int LD = C::LD;
  constexpr bool EX = kExact<E>;
  constexpr int KT = D / 8;
  constexpr int NS = C::BNB / 8;
  constexpr int NO = D / 8;
  extern __shared__ float4 smem4[];
  float4* qnk = smem4;
  float4* dnk = qnk + C::NKP;
  float4* qperm = dnk + C::NKP;
  float4* dperm = qperm + C::PERMP;
  E* qraw = reinterpret_cast<E*>(dperm + C::PERMP);
  E* draw = qraw + C::RAW;
  E* vss = draw + C::RAW;
  E* kss = vss + BM * LD;  // D 128 only

  const int bh = blockIdx.x;
  const int tile = blockIdx.y;  // tile 0 sweeps the most queries: first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int c0 = tile * BM;
  const int kA = c0 + warp * 16 + g;  // this lane's two accumulator rows
  const int kB = kA + 8;

  const int lo = sweep_lo(c0, causal);

  const size_t koff = (size_t)bh * S * D;
  const E* qb = q + (size_t)bh * T * D;
  const E* dob = dout + (size_t)bh * T * D;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;
  const float* mb = mask_base(mask, mode, mask_bh, bh, T, S);

  load_rows<BM, D>(vss, v + koff, c0, S, tid);
  if constexpr (!C::KREG) load_rows<BM, D>(kss, k + koff, c0, S, tid);
  if (lo < T) {
    load_rows<C::BNB, D>(qraw, qb, lo, T, tid);
    load_rows<C::BNB, D>(draw, dob, lo, T, tid);
  }
  cp_async_commit();

  FragA kf[C::KREG ? KT : 1];
  if constexpr (C::KREG) {
    const E* kr = k + koff;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 8 + t;
      kf[kk] = split_a(kA < S ? to_f(kr[(size_t)kA * D + c]) : 0.f,
                       kB < S ? to_f(kr[(size_t)kB * D + c]) : 0.f,
                       kA < S ? to_f(kr[(size_t)kA * D + c + 4]) : 0.f,
                       kB < S ? to_f(kr[(size_t)kB * D + c + 4]) : 0.f);
    }
  }

  float mvA = 0.f, mvB = 0.f;
  if (mode == MODE_VEC) {
    if (kA < S) mvA = mb[kA];
    if (kB < S) mvB = mb[kB];
  }

  float dkacc[NO][4], dvacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  for (int i0 = lo; i0 < T; i0 += C::BNB) {
    cp_async_wait<0>();
    __syncthreads();
    presplit_nk<C::BNB, D>(qnk, qraw, tid);
    presplit_nk<C::BNB, D>(dnk, draw, tid);
    presplit_perm<C::BNB, D>(qperm, qraw, tid);
    presplit_perm<C::BNB, D>(dperm, draw, tid);
    __syncthreads();
    if (i0 + C::BNB < T) {
      load_rows<C::BNB, D>(qraw, qb, i0 + C::BNB, T, tid);
      load_rows<C::BNB, D>(draw, dob, i0 + C::BNB, T, tid);
      cp_async_commit();
    }

    // lse and delta of this lane's accumulator columns (queries)
    float Lq[NS][2], Dq[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qi = i0 + n * 8 + 2 * t + b;
        Lq[n][b] = qi < T ? lb[qi] : 0.f;
        Dq[n][b] = qi < T ? db[qi] : 0.f;
      }
    }

    float sacc[NS][4], pacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      FragA ak;
      if constexpr (C::KREG)
        ak = kf[kk];
      else
        ak = frag_a(kss, LD, warp * 16, kk * 8, g, t);
      const FragA av = frag_a(vss, LD, warp * 16, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mma3<EX, EX>(sacc[n], ak, frag_b_nk_pre<D>(qnk, n * 8, kk, g, t));
        mma3<EX, EX>(pacc[n], av, frag_b_nk_pre<D>(dnk, n * 8, kk, g, t));
      }
    }

    const bool diag = causal && c0 + BM - 1 > i0;
    const bool edge = i0 + C::BNB > T || c0 + BM > S;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? kA : kB;
        const int qi = i0 + n * 8 + 2 * t + (e & 1);
        float x = sacc[n][e] * scale;
        if (mode == MODE_DENSE) {
          if (qi < T && key < S) x += mb[(size_t)qi * S + key];
        } else if (mode == MODE_VEC) {
          x += e < 2 ? mvA : mvB;
        }
        if (diag && key > qi) x = NEG;
        float p = fexp(x - Lq[n][e & 1]);
        if (edge && (qi >= T || key >= S)) p = 0.f;
        sacc[n][e] = p;                                // P^T
        pacc[n][e] = p * (pacc[n][e] - Dq[n][e & 1]);  // dS^T
      }
    }

    // dV += P^T dO, then dK += dS^T Q (dO and Q in the permuted row
    // order); one product at a time keeps the registers under 255
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA ap = acc_as_a(sacc[n]);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        mma3<false, EX>(dvacc[j], ap,
                        frag_b_perm_pre<D>(dperm, n * 8, j * 8, g, t));
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA as = acc_as_a(pacc[n]);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        mma3<false, EX>(dkacc[j], as,
                        frag_b_perm_pre<D>(qperm, n * 8, j * 8, g, t));
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  const int cc = 2 * t;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (kA < S) {
      const size_t i = koff + (size_t)kA * D + j * 8 + cc;
      store2(dk + i, dkacc[j][0] * scale, dkacc[j][1] * scale);
      store2(dv + i, dvacc[j][0], dvacc[j][1]);
    }
    if (kB < S) {
      const size_t i = koff + (size_t)kB * D + j * 8 + cc;
      store2(dk + i, dkacc[j][2] * scale, dkacc[j][3] * scale);
      store2(dv + i, dvacc[j][2], dvacc[j][3]);
    }
  }
}

template <int D, typename E>
int launch_dq(const void* q, const void* k, const void* v, const float* mask,
              const void* dout, const float* lse, const float* delta,
              void* dq, int BH, int T, int S, int mode, int mask_bh,
              int causal, float scale, cudaStream_t stream) {
  using C = DqCfg<D, E>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (T + BM - 1) / BM);
  flash_bwd_dq_mma<D, E><<<grid, NT, C::SMEM, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), mask, static_cast<const E*>(dout), lse, delta,
      static_cast<E*>(dq), T, S, mode, mask_bh, causal, scale);
  return (int)cudaGetLastError();
}

template <int D, typename E>
int launch_dkv(const void* q, const void* k, const void* v,
               const float* mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int BH, int T, int S,
               int mode, int mask_bh, int causal, float scale,
               cudaStream_t stream) {
  using C = DkvCfg<D, E>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + BM - 1) / BM);
  flash_bwd_dkv_mma<D, E><<<grid, NT, C::SMEM, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), mask, static_cast<const E*>(dout), lse, delta,
      static_cast<E*>(dk), static_cast<E*>(dv), T, S, mode, mask_bh, causal,
      scale);
  return (int)cudaGetLastError();
}

// The launches by head dim and operand type (0 float32, 1 bfloat16,
// 2 float16).
#define SINGA_FLASH_BWD_DISPATCH(CALL)                                     \
  switch (dtype * 1000 + D) {                                              \
    case 16: return CALL(16, float);                                       \
    case 32: return CALL(32, float);                                       \
    case 64: return CALL(64, float);                                       \
    case 128: return CALL(128, float);                                     \
    case 1016: return CALL(16, __nv_bfloat16);                             \
    case 1032: return CALL(32, __nv_bfloat16);                             \
    case 1064: return CALL(64, __nv_bfloat16);                             \
    case 1128: return CALL(128, __nv_bfloat16);                            \
    case 2016: return CALL(16, __half);                                    \
    case 2032: return CALL(32, __half);                                    \
    case 2064: return CALL(64, __half);                                    \
    case 2128: return CALL(128, __half);                                   \
    default: return (int)cudaErrorInvalidValue;                            \
  }

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  `dtype` is the
// type of q, k, v, dO and the gradients: 0 float32, 1 bfloat16, 2 float16.
extern "C" int singa_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const float* mask,
    const void* dout, const float* lse, const float* delta, void* dq, int BH,
    int T, int S, int D, int mode, int mask_bh, int causal, int dtype,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SINGA_DQ(DD, EE)                                                    \
  launch_dq<DD, EE>(q, k, v, mask, dout, lse, delta, dq, BH, T, S, mode,  \
                    mask_bh, causal, scale, st)
  SINGA_FLASH_BWD_DISPATCH(SINGA_DQ)
#undef SINGA_DQ
}

extern "C" int singa_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const float* mask,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int BH, int T, int S, int D, int mode, int mask_bh, int causal,
    int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SINGA_DKV(DD, EE)                                                    \
  launch_dkv<DD, EE>(q, k, v, mask, dout, lse, delta, dk, dv, BH, T, S,    \
                     mode, mask_bh, causal, scale, st)
  SINGA_FLASH_BWD_DISPATCH(SINGA_DKV)
#undef SINGA_DKV
}
