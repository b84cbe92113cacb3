// One LSTM step for Hopper (sm_90a), float32: the recurrent product, the
// gates and the state update in one kernel.
//
// Replaces the Pallas TPU kernel `_lstm_kernel` (singa_tpu/ops/
// pallas_kernels.py, launched by `_lstm_fwd_impl` under the entry
// `lstm_cell_fused`).  Same function: gates = xw + h @ W_hh + b with the gate
// blocks in the order i, f, g, o; i, f, o = sigmoid, g = tanh;
// c' = f * c + i * g; h' = o * tanh(c'); all in float32.
//
// Operands are UNPACKED: xw (B, 4H), h and c (B, H), W_hh (H, 4H), b (4H,),
// gate k of unit j at column k * H + j.  The TPU kernel wanted each gate
// block at a 128-lane boundary (W_hh packed to (Hp, 4Hp)) and the batch
// padded to 8 sublanes; neither means anything here, so any B >= 1 and
// H >= 1 run as they are and the packing is not reproduced.
//
// What bounds it: at the char-LSTM's training shape (B 64, H 256) the cell
// moves 1.58 MB (W_hh is 1 MB of it) and does 33.6 MFLOP, under a
// microsecond either way on an H100; a launch costs several.  So the kernel
// is latency-bound and the design is the simple one: one thread owns one
// (b, j) and accumulates its four gate dot products over H in float32
// (columns j, H + j, 2H + j, 3H + j of W_hh, coalesced across the threads
// of a warp, which take consecutive j).  A block of 64 units by 4 batch rows
// stages its rows of h in shared memory, 256 columns at a time, so any H
// fits.  h' and c' go to fresh buffers: autograd saves h and c.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TJ = 64;      // hidden units of a block (threadIdx.x)
constexpr int TB = 4;       // batch rows of a block (threadIdx.y)
constexpr int KC = 256;     // columns of h staged in shared memory at a time
constexpr int NT = TJ * TB;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(NT) lstm_cell_kernel(
    const float* __restrict__ xw, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ whh,
    const float* __restrict__ bias, float* __restrict__ h_out,
    float* __restrict__ c_out, int B, int H) {
  __shared__ float hs[TB][KC];
  const int j = blockIdx.x * TJ + threadIdx.x;
  const int b0 = blockIdx.y * TB;
  const int b = b0 + threadIdx.y;
  const int tid = threadIdx.y * TJ + threadIdx.x;
  const size_t G = 4 * (size_t)H;
  const bool live = j < H && b < B;

  float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
  for (int k0 = 0; k0 < H; k0 += KC) {
    const int kn = min(KC, H - k0);
    __syncthreads();                    // the previous chunk is consumed
    for (int e = tid; e < TB * KC; e += NT) {
      const int r = e / KC, k = e % KC;
      hs[r][k] = (b0 + r < B && k < kn)
                     ? h[(size_t)(b0 + r) * H + k0 + k] : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* w = whh + (size_t)k0 * G + j;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float hk = hs[threadIdx.y][k];
        const float* wk = w + (size_t)k * G;
        ai = fmaf(hk, wk[0], ai);
        af = fmaf(hk, wk[H], af);
        ag = fmaf(hk, wk[2 * H], ag);
        ao = fmaf(hk, wk[3 * H], ao);
      }
    }
  }
  if (!live) return;

  const float* x = xw + (size_t)b * G;
  const float gi = sigmoid(x[j] + ai + bias[j]);
  const float gf = sigmoid(x[H + j] + af + bias[H + j]);
  const float gg = tanhf(x[2 * H + j] + ag + bias[2 * H + j]);
  const float go = sigmoid(x[3 * H + j] + ao + bias[3 * H + j]);
  const size_t o = (size_t)b * H + j;
  const float cn = gf * c[o] + gi * gg;
  c_out[o] = cn;
  h_out[o] = go * tanhf(cn);
}

}  // namespace

// The grid of a launch: (ceil(H / 64), ceil(B / 4)) blocks of 256 threads.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int singa_lstm_cell(const float* xw, const float* h,
                               const float* c, const float* whh,
                               const float* bias, float* h_out, float* c_out,
                               int B, int H, void* stream) {
  if (B < 1 || H < 1 || (B + TB - 1) / TB > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB);
  dim3 block(TJ, TB);
  lstm_cell_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xw, h, c, whh, bias, h_out, c_out, B, H);
  return (int)cudaGetLastError();
}
