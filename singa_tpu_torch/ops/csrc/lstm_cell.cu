// One LSTM step for Hopper (sm_90a): the recurrent product, the gates and
// the state update in one kernel, and the backward's gate recompute with
// its closed-form pointwise part in a second kernel built from the same
// template.  Operands float32, bfloat16 or float16; the math in float32.
//
// Replaces the Pallas TPU kernel `_lstm_kernel` (singa_tpu/ops/
// pallas_kernels.py:581, launched at :625/629 by `_lstm_fwd_impl` under the
// entry `lstm_cell_fused`), and, for the backward, the XLA recompute
// `_lstm_cell_bwd` (:655).  Same functions:
//   forward:  gates = xw + h @ W_hh + b (gate blocks i, f, g, o);
//             i, f, o = sigmoid, g = tanh; c' = f c + i g; h' = o tanh(c');
//             every operand upcast to float32, h' and c' rounded once to
//             their type (the reference kernel's contract).
//   backward: the same gates from the saved operands, then
//             dc_tot = dc + dh o (1 - tanh^2 c'),
//             dgates = [dc_tot g i(1-i), dc_tot c f(1-f), dc_tot i (1-g^2),
//                       dh tanh(c') o(1-o)]  (B, 4H) float32,
//             dc_prev = dc_tot f  (B, H) float32,
//             h1 = [h, 1]  (B, H + 1) float32, so that one product
//             h1^T @ dgates gives dW_hh (its first H rows) and db (its
//             last).  dh = dgates @ W_hh^T and that product are plain
//             products left to the caller, as the reference leaves them
//             to XLA.
//
// Operands are UNPACKED: xw (B, 4H), h and c (B, H), W_hh (H, 4H), b (4H,),
// gate k of unit j at column k * H + j.  The TPU kernel wanted each gate
// block at a 128-lane boundary and the batch padded to 8 sublanes; neither
// means anything here, so any B >= 1 and H >= 1 run as they are.
//
// What bounds it.  At the char-LSTM's training shape (B 64, H 256, float32)
// a step moves 1.58 MB (W_hh is 1 MB of it) and does 33.75 MFLOP: 0.47 us
// at 3.35 TB/s and 0.50 us at the card's 67 TFLOP/s of float32 SIMT FMA.
// The fp32 contract keeps TF32 (and so the tensor cores) off, and the work
// is too small for them to matter.  So a step is bound by latency: the
// launch, the load -> FMA chain and the number of SMs that take part.
//
// The design answers each of those:
// - A block owns BT 16 batch rows x JT 8 units, all four gates of them
//   (32 gate columns).  B 64, H 256 launch 32 x 4 = 128 blocks on the 132
//   SMs; at B 1 the grid is over units alone.  The epilogue (gates -> c',
//   h', or -> dgates, dc_prev) runs in the block that summed the gates, so
//   no gate tensor goes to device memory.
// - The block stages its four JT-wide strips of W_hh and its BT rows of h in
//   shared memory with 16-byte cp.async copies (zero-filled past the edges),
//   KC 128 rows of K at a time in a ring of two buffers, so the next chunk
//   lands while this one is summed and any H fits.  Each W_hh value is read
//   from L2 once per batch tile (4 times at the training shape).  Where H
//   is not a multiple of 16 bytes of operands the staging falls back to
//   element copies (the ragged shapes); the math is the same.
// - K is split across the block's 8 warps: 4 slices of 2 warps, each
//   summing KC / 4 = 32 values of K a chunk (64 in all at H 256), so no
//   dependent FMA chain is longer than H / 4.  A thread keeps 2 rows x 4
//   columns of one gate (8 sums); per 4 values of K it makes 2 + 4 vector
//   reads of shared memory (16 bytes each in float32) for 32 FMAs.  The
//   slices' partial sums meet in shared memory, and 128 threads (one per
//   row and unit) finish the step.
// - The epilogue's own operands (xw, b, c, and dh, dc backward) are loaded
//   into registers before the product starts, so their latency hides under
//   it.  The backward also writes h1 = [h, 1] in float32 from there, so
//   the caller's dW_hh and db are one product (a float32 backward is the
//   kernel and two products: 4 device launches with cuBLAS's split-K
//   reduce, where a separate sum over the batch would be a fifth).
// - Operands stay in their type in shared memory (half the bytes for bf16
//   and fp16) and are converted to float32 as they are read; sums, gates
//   and state are float32, and only h', c' are rounded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 16;               // batch rows of a block
constexpr int JT = 8;                // hidden units of a block
constexpr int GC = 4 * JT;           // gate columns of a block
constexpr int NT = 256;              // threads of a block
constexpr int SLICE_T = (BT / 2) * (GC / 4);  // threads of one K slice: 64
constexpr int KS = NT / SLICE_T;     // K slices: 4
constexpr int KC = 128;              // rows of K staged at a time
constexpr int KSL = KC / KS;         // rows of K a slice sums a chunk: 32
constexpr int RS = GC + 8;           // row stride of the partial sums (floats)
static_assert(SLICE_T * KS == NT && KSL % 4 == 0 && BT * JT <= NT, "tiling");

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Four consecutive values from shared memory, as float32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[r][u] += h_r * w_u for the tile's two rows and four columns
__device__ __forceinline__ void fma8(float (&acc)[2][4], float a, float b,
                                     float4 w) {
  acc[0][0] = fmaf(a, w.x, acc[0][0]);
  acc[0][1] = fmaf(a, w.y, acc[0][1]);
  acc[0][2] = fmaf(a, w.z, acc[0][2]);
  acc[0][3] = fmaf(a, w.w, acc[0][3]);
  acc[1][0] = fmaf(b, w.x, acc[1][0]);
  acc[1][1] = fmaf(b, w.y, acc[1][1]);
  acc[1][2] = fmaf(b, w.z, acc[1][2]);
  acc[1][3] = fmaf(b, w.w, acc[1][3]);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Elements of one padded row of h in shared memory (16 bytes of padding
// keep the rows' 16-byte alignment and move them off each other's banks).
template <typename T>
__host__ __device__ constexpr int h_row() {
  return KC + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return KC * GC + BT * h_row<T>();
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * (size_t)stage_elems<T>() * sizeof(T);
}
static_assert(KS * BT * RS * sizeof(float) <= smem_bytes<__half>(),
              "the partial sums reuse the staging buffers");

// Stage rows [k0, k0 + KC) of the block's W_hh strips (ws: KC x GC, gate g
// of unit j0 + jj at column g * JT + jj) and of its rows of h (hs: BT x
// h_row), zero past the edges.  vec: 16-byte cp.async copies (H a multiple
// of 16 bytes of T, both bases 16-byte aligned), else element copies.
template <typename T>
__device__ __forceinline__ void stage(T* ws, T* hs, const T* __restrict__ whh,
                                      const T* __restrict__ h, int k0,
                                      int j0, int b0, int B, int H, bool vec,
                                      int tid) {
  const size_t G = 4 * (size_t)H;
  if (vec) {
    constexpr int VW = 16 / (int)sizeof(T);   // elements of one copy
    constexpr int WSEG = GC / VW;
    for (int e = tid; e < KC * WSEG; e += NT) {
      const int k = e / WSEG, col = (e % WSEG) * VW;
      const int kk = k0 + k, j = j0 + col % JT;
      // H % VW == 0 and j % VW == 0: a copy is wholly inside or outside
      const bool ok = kk < H && j < H;
      const T* src = ok ? whh + kk * G + (size_t)(col / JT) * H + j : whh;
      cp_async16(ws + k * GC + col, src, ok ? 16 : 0);
    }
    constexpr int HSEG = KC / VW;
    for (int e = tid; e < BT * HSEG; e += NT) {
      const int r = e / HSEG, k = (e % HSEG) * VW;
      const bool ok = b0 + r < B && k0 + k < H;
      const T* src = ok ? h + (size_t)(b0 + r) * H + k0 + k : h;
      cp_async16(hs + r * h_row<T>() + k, src, ok ? 16 : 0);
    }
  } else {
    const T zero = from_f<T>(0.f);
    for (int e = tid; e < KC * GC; e += NT) {
      const int k = e / GC, col = e % GC;
      const int kk = k0 + k, j = j0 + col % JT;
      ws[k * GC + col] = (kk < H && j < H)
                             ? whh[kk * G + (size_t)(col / JT) * H + j]
                             : zero;
    }
    for (int e = tid; e < BT * KC; e += NT) {
      const int r = e / KC, k = e % KC;
      hs[r * h_row<T>() + k] = (b0 + r < B && k0 + k < H)
                                   ? h[(size_t)(b0 + r) * H + k0 + k]
                                   : zero;
    }
  }
}

// BWD false: h_out, c_out (type T).  BWD true: dgates, dc_prev and h1
// (float32) from the cotangents dh, dc (type T).
template <typename T, bool BWD>
__global__ void __launch_bounds__(NT, 1) lstm_cell_kernel(
    const T* __restrict__ xw, const T* __restrict__ h,
    const T* __restrict__ c, const T* __restrict__ whh,
    const T* __restrict__ bias, const T* __restrict__ dh,
    const T* __restrict__ dc, T* __restrict__ h_out, T* __restrict__ c_out,
    float* __restrict__ dgates, float* __restrict__ dc_prev,
    float* __restrict__ h1, int B, int H, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const buf = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BT;
  const size_t G = 4 * (size_t)H;
  const int nchunk = (H + KC - 1) / KC;

  // the ring's first two chunks, then the epilogue's operands
  stage(buf, buf + KC * GC, whh, h, 0, j0, b0, B, H, vec, tid);
  cp_async_commit();
  if (nchunk > 1)
    stage(buf + stage_elems<T>(), buf + stage_elems<T>() + KC * GC, whh, h,
          KC, j0, b0, B, H, vec, tid);
  cp_async_commit();

  const int er = tid / JT, ej = tid % JT;     // epilogue: row, unit
  const int eb = b0 + er, eu = j0 + ej;
  const bool live = tid < BT * JT && eb < B && eu < H;
  float x4[4] = {0.f, 0.f, 0.f, 0.f}, b4[4] = {0.f, 0.f, 0.f, 0.f};
  float cv = 0.f, dhv = 0.f, dcv = 0.f, hv = 0.f;
  if (live) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x4[g] = to_f(xw[eb * G + (size_t)g * H + eu]);
      b4[g] = to_f(bias[(size_t)g * H + eu]);
    }
    const size_t o = (size_t)eb * H + eu;
    cv = to_f(c[o]);
    if (BWD) {
      dhv = to_f(dh[o]);
      dcv = to_f(dc[o]);
      hv = to_f(h[o]);
    }
  }

  // the product: slice s sums rows [s KSL, (s+1) KSL) of each chunk for
  // rows 2 rp, 2 rp + 1 of the tile and gate columns [4 gq, 4 gq + 4)
  const int s = tid / SLICE_T, t = tid % SLICE_T;
  const int rp = t / (GC / 4), gq = t % (GC / 4);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int ch = 0; ch < nchunk; ++ch) {
    cp_async_wait<1>();                 // chunk ch has landed
    __syncthreads();
    const T* ws = buf + (ch & 1) * stage_elems<T>();
    const T* h0 = ws + KC * GC + (2 * rp) * h_row<T>();
    const T* h1 = h0 + h_row<T>();
    const T* wc = ws + 4 * gq;
#pragma unroll 2
    for (int k = s * KSL; k < (s + 1) * KSL; k += 4) {
      const float4 ha = ld4(h0 + k), hb = ld4(h1 + k);
      fma8(acc, ha.x, hb.x, ld4(wc + k * GC));
      fma8(acc, ha.y, hb.y, ld4(wc + (k + 1) * GC));
      fma8(acc, ha.z, hb.z, ld4(wc + (k + 2) * GC));
      fma8(acc, ha.w, hb.w, ld4(wc + (k + 3) * GC));
    }
    __syncthreads();                    // buffer ch & 1 is consumed
    if (ch + 2 < nchunk) {
      T* nb = buf + (ch & 1) * stage_elems<T>();
      stage(nb, nb + KC * GC, whh, h, (ch + 2) * KC, j0, b0, B, H, vec, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the slices' partial sums meet in shared memory (the staging buffers
  // are free: the last __syncthreads above follows the last read)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    *reinterpret_cast<float4*>(red + (s * BT + 2 * rp + r) * RS + 4 * gq) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  if (!live) return;

  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < KS; ++q) sum += red[(q * BT + er) * RS + g * JT + ej];
    gate[g] = x4[g] + sum + b4[g];
  }
  const float gi = sigmoid(gate[0]), gf = sigmoid(gate[1]);
  const float gg = tanhf(gate[2]), go = sigmoid(gate[3]);
  const float cn = gf * cv + gi * gg;
  const size_t o = (size_t)eb * H + eu;
  if (!BWD) {
    c_out[o] = from_f<T>(cn);
    h_out[o] = from_f<T>(go * tanhf(cn));
  } else {
    const float tc = tanhf(cn);
    const float dct = dcv + dhv * go * (1.f - tc * tc);
    float* d = dgates + eb * G + eu;
    d[0] = dct * gg * gi * (1.f - gi);
    d[H] = dct * cv * gf * (1.f - gf);
    d[2 * (size_t)H] = dct * gi * (1.f - gg * gg);
    d[3 * (size_t)H] = dhv * tc * go * (1.f - go);
    dc_prev[o] = dct * gf;
    float* hr = h1 + (size_t)eb * (H + 1);
    hr[eu] = hv;
    if (eu == 0) hr[H] = 1.f;
  }
}

template <typename T, bool BWD>
int launch(const void* xw, const void* h, const void* c, const void* whh,
           const void* bias, const void* dh, const void* dc, void* h_out,
           void* c_out, float* dgates, float* dc_prev, float* h1, int B,
           int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  // above 48 KB of dynamic shared memory a kernel must ask, once a device
  static bool asked[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && dev < 64 && !asked[dev]) {
    err = cudaFuncSetAttribute(lstm_cell_kernel<T, BWD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  const bool vec = H % (16 / (int)sizeof(T)) == 0 &&
                   ((uintptr_t)whh | (uintptr_t)h) % 16 == 0;
  dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT);
  lstm_cell_kernel<T, BWD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(whh),
      static_cast<const T*>(bias), static_cast<const T*>(dh),
      static_cast<const T*>(dc), static_cast<T*>(h_out),
      static_cast<T*>(c_out), dgates, dc_prev, h1, B, H, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int dtype, const void* xw, const void* h, const void* c,
             const void* whh, const void* bias, const void* dh,
             const void* dc, void* h_out, void* c_out, float* dgates,
             float* dc_prev, float* h1, int B, int H, void* stream) {
  if (B < 1 || H < 1 || (B + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, BWD>(xw, h, c, whh, bias, dh, dc, h_out, c_out,
                                dgates, dc_prev, h1, B, H, st);
    case 1:
      return launch<__nv_bfloat16, BWD>(xw, h, c, whh, bias, dh, dc, h_out,
                                        c_out, dgates, dc_prev, h1, B, H,
                                        st);
    case 2:
      return launch<__half, BWD>(xw, h, c, whh, bias, dh, dc, h_out, c_out,
                                 dgates, dc_prev, h1, B, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, for all five operands and both
// outputs.  The grid of a launch: (ceil(H / 8), ceil(B / 16)) blocks of 256
// threads.  Each returns the cudaError_t of the launch (0 on success).
extern "C" int singa_lstm_cell(const void* xw, const void* h, const void* c,
                               const void* whh, const void* bias, void* h_out,
                               void* c_out, int B, int H, int dtype,
                               void* stream) {
  return dispatch<false>(dtype, xw, h, c, whh, bias, nullptr, nullptr, h_out,
                         c_out, nullptr, nullptr, nullptr, B, H, stream);
}

// The backward: dgates (B, 4H), dc_prev (B, H) and h1 (B, H + 1) in
// float32 from the forward's operands and the cotangents dh, dc of h' and
// c' (all of type dtype).
extern "C" int singa_lstm_cell_bwd(const void* xw, const void* h,
                                   const void* c, const void* whh,
                                   const void* bias, const void* dh,
                                   const void* dc, float* dgates,
                                   float* dc_prev, float* h1, int B, int H,
                                   int dtype, void* stream) {
  return dispatch<true>(dtype, xw, h, c, whh, bias, dh, dc, nullptr, nullptr,
                        dgates, dc_prev, h1, B, H, stream);
}

// Bytes of dynamic shared memory a launch takes for dtype (0 float32,
// 1 bfloat16, 2 float16), forward and backward alike; -1 for another code.
extern "C" int singa_lstm_cell_smem_bytes(int dtype) {
  switch (dtype) {
    case 0: return (int)smem_bytes<float>();
    case 1: return (int)smem_bytes<__nv_bfloat16>();
    case 2: return (int)smem_bytes<__half>();
    default: return -1;
  }
}
