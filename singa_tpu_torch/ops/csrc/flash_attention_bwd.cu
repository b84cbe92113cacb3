// Flash-attention backward for Hopper (sm_90a), float32: the dq pass and the
// dk/dv pass.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (singa_tpu/ops/pallas_kernels.py, launched by `_flash_bwd_call`).  Same
// contract as the forward (csrc/flash_attention_fwd.cu): q/dO/dq (BH, T, D),
// k/v/dk/dv (BH, S, D), the additive mask at its natural rank ("vec":
// (MB, 1, S), "dense": (MB, T, S), MB in {1, BH}), causal masking from
// indices with masked scores set to -1e9, `lse` (BH, T) from the forward and
// `delta = rowsum(dO * O)` (BH, T) computed before the launch.
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
// Design: every block owns its output rows, so there are no atomics and the
// result is deterministic.  Four threads share a row; each holds a quarter of
// the row's channels (channel sub + 4 i) in registers, and the two dot
// products of a (row, column) pair are summed over the four with shuffles.
// The streamed operand goes through shared memory in tiles of 32 rows.
//   dq:    one block per (batch*head, 64-row query tile); q, dO, dq, lse and
//          delta of its rows in registers; K/V tiles streamed over the swept
//          columns; dq += ds * k, times scale at the end.
//   dk/dv: one block per (batch*head, 64-key tile); k, v, dk, dv of its keys
//          in registers; Q/dO/lse/delta tiles streamed from the first query
//          128-block that sees the tile; dv += p * dO, dk += ds * q, dk times
//          scale at the end.
// Plain float32 FMAs, no tensor cores.  At the training shape (BH = 96,
// T = S = 1024, D = 64, causal) the reference's sweep is 56.6 M pairs; dq
// does 6 D flops a pair (21.7 GFLOP, 0.32 ms at 67 TFLOP/s), dk/dv 8 D
// (29.0 GFLOP, 0.43 ms), against ~0.06 ms of bytes at 3.35 TB/s: the work
// bounds both.  Every FMA reads one shared-memory word, so the shared-memory
// pipe, at a quarter of the FMA rate, holds these simple kernels well above
// that bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;          // query rows (dq) or keys (dk/dv) per block
constexpr int BT = 32;          // rows of the streamed operand per tile
constexpr int TPR = 4;          // threads per row
constexpr int NT = BM * TPR;    // threads per block
constexpr int REF_BLOCK = 128;  // the reference kernels' block size
constexpr float NEG = -1e9f;

enum { MODE_NONE = 0, MODE_VEC = 1, MODE_DENSE = 2 };

__device__ __forceinline__ float quad_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int T, int S,
    int mode, int mask_bh, int causal, float scale) {
  constexpr int DP = D / TPR;
  __shared__ float ks[BT][D];
  __shared__ float vs[BT][D];

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int row = tile * BM + r;
  const bool row_ok = row < T;

  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const float* mb = mask;
  if (mode == MODE_DENSE && mask_bh) mb += (size_t)bh * T * S;
  if (mode == MODE_VEC && mask_bh) mb += (size_t)bh * S;

  const size_t roff = ((size_t)bh * T + row) * D;
  float qr[DP], dor[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const int c = sub + TPR * i;
    qr[i] = row_ok ? q[roff + c] : 0.f;
    dor[i] = row_ok ? dout[roff + c] : 0.f;
    acc[i] = 0.f;
  }
  const float L = row_ok ? lse[(size_t)bh * T + row] : 0.f;
  const float dl = row_ok ? delta[(size_t)bh * T + row] : 0.f;

  // the reference's swept columns for this tile (BM divides REF_BLOCK, so
  // the tile lies in one reference query block); padded ones are skipped
  const int Sp = ((S + REF_BLOCK - 1) / REF_BLOCK) * REF_BLOCK;
  const int hi = causal ? min(Sp, ((tile * BM) / REF_BLOCK + 1) * REF_BLOCK)
                        : Sp;
  const int kend = min(S, hi);

  for (int j0 = 0; j0 < kend; j0 += BT) {
    for (int idx = tid; idx < BT * D; idx += NT) {
      const int jj = idx / D;
      const int c = idx % D;
      const int col = j0 + jj;
      const bool ok = col < kend;
      ks[jj][c] = ok ? kb[(size_t)col * D + c] : 0.f;
      vs[jj][c] = ok ? vb[(size_t)col * D + c] : 0.f;
    }
    __syncthreads();
    const int n = min(BT, kend - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int col = j0 + jj;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(qr[i], ks[jj][sub + TPR * i], s);
        dp = fmaf(dor[i], vs[jj][sub + TPR * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float x = s * scale;
      if (mode == MODE_DENSE) {
        if (row_ok) x += mb[(size_t)row * S + col];
      } else if (mode == MODE_VEC) {
        x += mb[col];
      }
      if (causal && col > row) x = NEG;
      const float ds = expf(x - L) * (dp - dl);
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(ds, ks[jj][sub + TPR * i], acc[i]);
    }
    __syncthreads();
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < DP; ++i) dq[roff + sub + TPR * i] = acc[i] * scale;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int T, int S, int mode, int mask_bh, int causal,
    float scale) {
  constexpr int DP = D / TPR;
  __shared__ float qs[BT][D];
  __shared__ float dos[BT][D];
  __shared__ float ls[BT];
  __shared__ float dls[BT];

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int col = tile * BM + r;
  const bool col_ok = col < S;

  const float* qb = q + (size_t)bh * T * D;
  const float* dob = dout + (size_t)bh * T * D;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;
  const float* mb = mask;
  if (mode == MODE_DENSE && mask_bh) mb += (size_t)bh * T * S;
  if (mode == MODE_VEC && mask_bh) mb += (size_t)bh * S;

  const size_t coff = ((size_t)bh * S + col) * D;
  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const int c = sub + TPR * i;
    kr[i] = col_ok ? k[coff + c] : 0.f;
    vr[i] = col_ok ? v[coff + c] : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  float mvec = 0.f;
  if (mode == MODE_VEC && col_ok) mvec = mb[col];

  // causal: query blocks above the tile's diagonal 128-block see none of it
  const int lo = causal ? ((tile * BM) / REF_BLOCK) * REF_BLOCK : 0;

  for (int i0 = lo; i0 < T; i0 += BT) {
    for (int idx = tid; idx < BT * D; idx += NT) {
      const int ii = idx / D;
      const int c = idx % D;
      const int row = i0 + ii;
      const bool ok = row < T;
      qs[ii][c] = ok ? qb[(size_t)row * D + c] : 0.f;
      dos[ii][c] = ok ? dob[(size_t)row * D + c] : 0.f;
    }
    if (tid < BT) {
      const int row = i0 + tid;
      ls[tid] = row < T ? lb[row] : 0.f;
      dls[tid] = row < T ? db[row] : 0.f;
    }
    __syncthreads();
    const int n = min(BT, T - i0);
    for (int ii = 0; ii < n; ++ii) {
      const int row = i0 + ii;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(kr[i], qs[ii][sub + TPR * i], s);
        dp = fmaf(vr[i], dos[ii][sub + TPR * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float x = s * scale;
      if (mode == MODE_DENSE) {
        if (col_ok) x += mb[(size_t)row * S + col];
      } else if (mode == MODE_VEC) {
        x += mvec;
      }
      if (causal && col > row) x = NEG;
      const float p = col_ok ? expf(x - ls[ii]) : 0.f;
      const float ds = p * (dp - dls[ii]);
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        const int c = sub + TPR * i;
        dva[i] = fmaf(p, dos[ii][c], dva[i]);
        dka[i] = fmaf(ds, qs[ii][c], dka[i]);
      }
    }
    __syncthreads();
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const int c = sub + TPR * i;
    dk[coff + c] = dka[i] * scale;
    dv[coff + c] = dva[i];
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* mask, const float* dout, const float* lse,
              const float* delta, float* dq, int BH, int T, int S, int mode,
              int mask_bh, int causal, float scale, cudaStream_t stream) {
  dim3 grid((T + BM - 1) / BM, BH);
  flash_bwd_dq<D><<<grid, NT, 0, stream>>>(q, k, v, mask, dout, lse, delta,
                                           dq, T, S, mode, mask_bh, causal,
                                           scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* mask, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, int BH, int T, int S,
               int mode, int mask_bh, int causal, float scale,
               cudaStream_t stream) {
  dim3 grid((S + BM - 1) / BM, BH);
  flash_bwd_dkv<D><<<grid, NT, 0, stream>>>(q, k, v, mask, dout, lse, delta,
                                            dk, dv, T, S, mode, mask_bh,
                                            causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).
extern "C" int singa_flash_attention_bwd_dq(
    const float* q, const float* k, const float* v, const float* mask,
    const float* dout, const float* lse, const float* delta, float* dq,
    int BH, int T, int S, int D, int mode, int mask_bh, int causal,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, mask, dout, lse, delta, dq, BH, T, S, mode, mask_bh, causal, scale, st);
    case 32: return launch_dq<32>(q, k, v, mask, dout, lse, delta, dq, BH, T, S, mode, mask_bh, causal, scale, st);
    case 64: return launch_dq<64>(q, k, v, mask, dout, lse, delta, dq, BH, T, S, mode, mask_bh, causal, scale, st);
    case 128: return launch_dq<128>(q, k, v, mask, dout, lse, delta, dq, BH, T, S, mode, mask_bh, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int singa_flash_attention_bwd_dkv(
    const float* q, const float* k, const float* v, const float* mask,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, int BH, int T, int S, int D, int mode, int mask_bh,
    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, mask, dout, lse, delta, dk, dv, BH, T, S, mode, mask_bh, causal, scale, st);
    case 32: return launch_dkv<32>(q, k, v, mask, dout, lse, delta, dk, dv, BH, T, S, mode, mask_bh, causal, scale, st);
    case 64: return launch_dkv<64>(q, k, v, mask, dout, lse, delta, dk, dv, BH, T, S, mode, mask_bh, causal, scale, st);
    case 128: return launch_dkv<128>(q, k, v, mask, dout, lse, delta, dk, dv, BH, T, S, mode, mask_bh, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
