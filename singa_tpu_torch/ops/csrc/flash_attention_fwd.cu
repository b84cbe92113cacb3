// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (singa_tpu/ops/pallas_kernels.py,
// launched by `_flash_fwd_call`).  Same contract: q (BH, T, D), k/v (BH, S, D),
// an optional additive mask carried at its natural rank ("vec": (MB, 1, S),
// "dense": (MB, T, S), MB in {1, BH}), causal masking computed from indices,
// masked scores set to -1e9 (never -inf), the online-softmax recurrence
// started at m = -1e9, l clamped to 1e-30, and a per-row logsumexp written
// beside the output for the backward pass.
//
// The reference pads the key axis to its 128-column block with zero K/V and
// a -1e9 score.  Those columns weigh nothing unless a whole row is masked,
// where they join the uniform average; this kernel does not read them and
// adds their count in closed form at the end (n_pad * exp(-1e9 - m)), so a
// fully masked row gives the reference's output too.
//
// Design: one thread block per (batch*head, 64-row query tile); four threads
// per query row, each holding the q row in registers, a quarter of every 32
// keys and a quarter of the output channels.  K/V tiles of 32 keys are staged
// through shared memory; the running max, denominator and accumulator stay
// in registers.  With `causal`, key tiles past the reference's diagonal
// 128-block are never read.  Plain float32 FMAs (no tensor cores): at the
// serving shape (C=64 queries against L=1024 keys, H=12, D=64) that work,
// 0.2 GFLOP at 67 TFLOP/s, is the card's floor (3.0 us), a little above the
// 7 MB of inputs and outputs at 3.35 TB/s (2.1 us).  This simple kernel is
// far from the floor: there it runs 12 blocks on 132 SMs, and every FMA
// reads shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 32;          // keys per shared-memory tile
constexpr int TPR = 4;          // threads per query row
constexpr int NT = BM * TPR;    // threads per block
constexpr int REF_BLOCK = 128;  // the reference kernel's block size
constexpr float NEG = -1e9f;

enum { MODE_NONE = 0, MODE_VEC = 1, MODE_DENSE = 2 };

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    float* __restrict__ o, float* __restrict__ lse, int T, int S, int mode,
    int mask_bh, int causal, float scale) {
  __shared__ float ks[BN][D + 1];
  __shared__ float vs[BN][D];
  __shared__ float ps[BM][BN + 1];

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int row = tile * BM + r;
  const bool row_ok = row < T;

  const float* qb = q + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const float* mb = mask;
  if (mode == MODE_DENSE && mask_bh) mb += (size_t)bh * T * S;
  if (mode == MODE_VEC && mask_bh) mb += (size_t)bh * S;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = row_ok ? qb[(size_t)row * D + c] : 0.f;

  float acc[D / TPR];
#pragma unroll
  for (int i = 0; i < D / TPR; ++i) acc[i] = 0.f;
  float m = NEG;
  float l = 0.f;

  // The key columns the reference sweeps for this tile: every 128-block,
  // or with `causal` those up to the tile's diagonal block (BM divides
  // REF_BLOCK, so the tile lies in one reference query block).
  const int Sp = ((S + REF_BLOCK - 1) / REF_BLOCK) * REF_BLOCK;
  const int hi = causal ? min(Sp, ((tile * BM) / REF_BLOCK + 1) * REF_BLOCK)
                        : Sp;
  const int kend = min(S, hi);

  for (int j0 = 0; j0 < kend; j0 += BN) {
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int jj = idx / D;
      const int c = idx % D;
      const int col = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (col < kend) {
        kx = kb[(size_t)col * D + c];
        vx = vb[(size_t)col * D + c];
      }
      ks[jj][c] = kx;
      vs[jj][c] = vx;
    }
    __syncthreads();

    float s[BN / TPR];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < BN / TPR; ++t) {
      const int jj = sub + TPR * t;
      const int col = j0 + jj;
      float x = -INFINITY;  // columns past the sweep carry no weight
      if (col < kend) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[jj][c], dot);
        x = dot * scale;
        if (mode == MODE_DENSE) {
          if (row_ok) x += mb[(size_t)row * S + col];
        } else if (mode == MODE_VEC) {
          x += mb[col];
        }
        if (causal && col > row) x = NEG;
      }
      s[t] = x;
      tmax = fmaxf(tmax, x);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < BN / TPR; ++t) {
      const float p = expf(s[t] - m_new);
      ps[r][sub + TPR * t] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < D / TPR; ++i) {
      const int c = sub + TPR * i;
      float a = acc[i] * alpha;
#pragma unroll
      for (int jj = 0; jj < BN; ++jj) a = fmaf(ps[r][jj], vs[jj][c], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  if (!row_ok) return;
  // the reference's swept zero-padded columns, each scored -1e9
  const int n_pad = hi - kend;
  if (n_pad > 0) l += (float)n_pad * expf(NEG - m);
  l = fmaxf(l, 1e-30f);
  float* ob = o + ((size_t)bh * T + row) * D;
#pragma unroll
  for (int i = 0; i < D / TPR; ++i) ob[sub + TPR * i] = acc[i] / l;
  if (sub == 0) lse[(size_t)bh * T + row] = m + logf(l);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* o, float* lse, int BH, int T, int S, int mode, int mask_bh,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((T + BM - 1) / BM, BH);
  flash_fwd<D><<<grid, NT, 0, stream>>>(q, k, v, mask, o, lse, T, S, mode,
                                        mask_bh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int singa_flash_attention_fwd(
    const float* q, const float* k, const float* v, const float* mask,
    float* o, float* lse, int BH, int T, int S, int D, int mode, int mask_bh,
    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, mask, o, lse, BH, T, S, mode, mask_bh, causal, scale, st);
    case 32: return launch<32>(q, k, v, mask, o, lse, BH, T, S, mode, mask_bh, causal, scale, st);
    case 64: return launch<64>(q, k, v, mask, o, lse, BH, T, S, mode, mask_bh, causal, scale, st);
    case 128: return launch<128>(q, k, v, mask, o, lse, BH, T, S, mode, mask_bh, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
