// Paged decode attention for Hopper (sm_90a): float32, bfloat16 and int8
// page pools; the int8 pools carry bfloat16 or float32 dequant scales.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (singa_tpu/ops/paged_attention.py, launched by `paged_decode_attention`),
// its float path and its quantized branch.  Same contract: one float32 query
// per slot, q (S, H, D); page pools (N, H, P, D); block table (S, Ps) int32
// of physical page ids; pos (S,) int32, the last logical position each slot
// attends (columns > pos[s] carry zero weight); online softmax started at
// m = -1e9 with l clamped to 1e-30.  Quantized pools add per-(page, head,
// offset) scales ks/vs (N, H, P), folded as the reference folds them: the
// score is dot(q, k) * scale * ks[t]; the running denominator sums the
// UNSCALED p; the value accumulator adds p * vs[t] * v.  No dequantised page
// is ever written anywhere: each int8 channel becomes a float in a register.
//
// On the TPU the table was scalar-prefetched and the page loop was the
// sequential minor grid axis, carrying (m, l, acc) in VMEM scratch from
// one grid step to the next.  Hopper blocks run in no order and carry
// nothing, so one thread block per (slot, head) reads its own table row
// and does the whole reduction itself.  The loop stops at page
// pos[s] / P: pages past the frontier (NULL fills, stale entries) are
// never read, and the tail columns of the frontier page are skipped; in
// the reference those columns are scored at -1e9 and weigh exactly zero.
//
// The work is ~0.5 FLOP per byte (~2 with int8 pages), so the card's floor
// is the K/V bytes (and scales) of the slots' live pages; what this kernel
// has to hide is the latency of a long page chain.  The block's eight warps
// take every eighth page each, each warp running its own online softmax
// (lanes split the head dim and a shuffle reduction sums each column's
// score); the eight partial states are merged through shared memory at the
// end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int NW = 8;           // warps per block, one page stream each
constexpr int NT = 32 * NW;
constexpr int MAX_D = 128;
constexpr int CPL = MAX_D / 32;  // head channels per lane
constexpr int MAX_P = 256;
constexpr float NEG = -1e9f;

struct NoScale {};              // the float pools: no dequant scales

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const int8_t* p) {
  return static_cast<float>(*p);
}

template <typename E, typename SC>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const float* __restrict__ q, const E* __restrict__ kp,
    const E* __restrict__ vp, const SC* __restrict__ ks,
    const SC* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ pos, float* __restrict__ o, int H, int P, int Ps,
    int D, float scale) {
  constexpr bool QUANT = !std::is_same<SC, NoScale>::value;
  __shared__ float sc[NW][MAX_P];
  __shared__ float wm[NW];
  __shared__ float wl[NW];
  __shared__ float wacc[NW][MAX_D];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qs = q + ((size_t)s * H + h) * D;
  float qr[CPL];
  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < D ? qs[c] : 0.f;
    acc[i] = 0.f;
  }

  const int ps = pos[s];
  const int n_pages = ps < 0 ? 0 : min(ps / P, Ps - 1) + 1;
  float m = NEG;
  float l = 0.f;

  for (int j = warp; j < n_pages; j += NW) {
    const int phys = table[(size_t)s * Ps + j];
    const size_t row = ((size_t)phys * H + h) * P;   // (page, head) row
    const E* kpage = kp + row * D;
    const E* vpage = vp + row * D;
    // the frontier page's columns past pos are never read
    const int ncol = min(P, ps - j * P + 1);

    float tmax = -INFINITY;
#pragma unroll 4
    for (int t = 0; t < ncol; ++t) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < D) dot = fmaf(qr[i], ld(kpage + (size_t)t * D + c), dot);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float x = dot * scale;
      if constexpr (QUANT) x *= ld(ks + row + t);
      if (lane == 0) sc[warp][t] = x;
      tmax = fmaxf(tmax, x);
    }
    __syncwarp();
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int t = 0; t < ncol; ++t) {
      float p = expf(sc[warp][t] - m_new);
      psum += p;                                   // the unscaled p
      if constexpr (QUANT) p *= ld(vs + row + t);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < D) acc[i] = fmaf(p, ld(vpage + (size_t)t * D + c), acc[i]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) wacc[warp][c] = acc[i];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < D) {
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w] - mm);
      ll = fmaf(wl[w], f, ll);
      aa = fmaf(wacc[w][c], f, aa);
    }
    o[((size_t)s * H + h) * D + c] = aa / fmaxf(ll, 1e-30f);
  }
}

template <typename E, typename SC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* table,
                   const int* pos, float* o, int S, int H, int P, int Ps,
                   int D, float scale, cudaStream_t st) {
  dim3 grid(S, H);
  paged_decode_kernel<E, SC><<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), static_cast<const SC*>(ks),
      static_cast<const SC*>(vs), table, pos, o, H, P, Ps, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Page element codes: 0 float32, 1 bfloat16, 2 int8.  Scale codes: 0 none,
// 1 bfloat16, 2 float32.  The variants built: float32 and bfloat16 pages
// without scales, int8 pages with either scale type.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int singa_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, const int* table,
                                  const int* pos, float* o, int S, int H,
                                  int P, int Ps, int D, float scale, int elem,
                                  int scale_kind, void* stream) {
  if (D < 1 || D > MAX_D || P < 1 || P > MAX_P) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (elem == 0 && scale_kind == 0)
    err = launch<float, NoScale>(q, k_pages, v_pages, k_scales, v_scales,
                                 table, pos, o, S, H, P, Ps, D, scale, st);
  else if (elem == 1 && scale_kind == 0)
    err = launch<__nv_bfloat16, NoScale>(q, k_pages, v_pages, k_scales,
                                         v_scales, table, pos, o, S, H, P,
                                         Ps, D, scale, st);
  else if (elem == 2 && scale_kind == 1)
    err = launch<int8_t, __nv_bfloat16>(q, k_pages, v_pages, k_scales,
                                        v_scales, table, pos, o, S, H, P, Ps,
                                        D, scale, st);
  else if (elem == 2 && scale_kind == 2)
    err = launch<int8_t, float>(q, k_pages, v_pages, k_scales, v_scales,
                                table, pos, o, S, H, P, Ps, D, scale, st);
  return (int)err;
}
