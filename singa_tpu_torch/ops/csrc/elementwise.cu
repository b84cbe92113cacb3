// The elementwise catalogue for Hopper (sm_90a): one kernel for unary maps
// and one for binary maps, each templated on the op functor and on the
// input and output types (float32, bfloat16, float16).
//
// Replaces the Pallas TPU kernels built by `_ew_call` (singa_tpu/ops/
// pallas_kernels.py: `_unary_kernel`, `_binary_kernel`; entries `ew_unary`,
// `ew_binary`, `clamp`).  The TPU version flattened every operand into
// (rows, 128) tiles padded to (8, 128) and cut the result back; here the
// flat array is cut into a head, a body of 16-byte vectors and a tail, so
// any length runs as it is and nothing is padded.
//
// Values are computed in float32 whatever the storage type and rounded once
// on store (round half to even), which is what the reference's
// `fn(x).astype(out)` does for float32 inputs.  The functors keep the
// reference's (jnp) semantics where CUDA's own functions differ: maximum
// and minimum propagate NaN (fmaxf/fminf drop it), so relu(NaN) and
// clamp(NaN) are NaN; sign(+-0) is the zero itself and sign(NaN) NaN;
// threshold is (x < t) as 1 or 0; gelu is the tanh form (jax.nn.gelu's
// default); pow is powf and div a true IEEE divide.  Built without
// --use_fast_math, so expf, logf, tanhf, powf and the divide are the
// accurate versions.
//
// What bounds it: about one operation per 6-12 bytes moved, so the bytes
// (each input read once, the output written once) over the memory rate.
// The unit of work is W = 16 / (the smaller element size) values: 16 bytes
// of the smaller type, so float32 to bfloat16 is two 16-byte loads to one
// 16-byte store.  Each thread issues the loads of UNR units (of every
// input) before it computes or stores any (UNR 2 unary, 4 binary), and the
// grid has one thread per UNR units, uncapped.  The wrapper
// (ops/elementwise.py, `_vector_split`) computes from the operands'
// addresses the head of values before every operand reaches a 16-byte
// boundary together, the number of whole units after it, and the tail;
// operands whose misalignments differ have no common boundary and run
// element by element, in the same kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
// units a thread, their loads all in flight before any value is computed:
// fewer for one operand, which leaves more warps to overlap the math
constexpr int UNR1 = 2;
constexpr int UNR2 = 4;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ uint32_t word(const uint4* r, int i) {
  const uint4& v = r[i >> 2];
  const int k = i & 3;
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// value k of W values of T held as raw 16-byte vectors
__device__ __forceinline__ float unpack(const uint4* r, int k, float*) {
  return __uint_as_float(word(r, k));
}
__device__ __forceinline__ float unpack(const uint4* r, int k,
                                        __nv_bfloat16*) {
  const uint32_t w = word(r, k >> 1);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float unpack(const uint4* r, int k, __half*) {
  const uint32_t w = word(r, k >> 1);
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>((k & 1) ? (w >> 16) : (w & 0xffffu))));
}

__device__ __forceinline__ uint32_t bits(float v, float*) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bits(float v, __half*) {
  return __half_as_ushort(__float2half_rn(v));
}

// W values of T at p (16-byte aligned) into NV = W * sizeof(T) / 16
// vectors; streaming loads and stores (evict first): every byte is used
// once
template <typename T, int W>
__device__ __forceinline__ void load_unit(const T* p,
                                          uint4 (&r)[W * sizeof(T) / 16]) {
#pragma unroll
  for (int k = 0; k < W * (int)sizeof(T) / 16; ++k)
    r[k] = __ldcs(reinterpret_cast<const uint4*>(p) + k);
}

// W float values rounded to T and stored at p (16-byte aligned)
template <typename T, int W>
__device__ __forceinline__ void store_unit(T* p, const float (&v)[W]) {
  constexpr int NV = W * sizeof(T) / 16;
  constexpr int PER = 4 / sizeof(T);          // values a 32-bit word
  uint4 r[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0u;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        w[i] |= bits(v[(k * 4 + i) * PER + j], static_cast<T*>(nullptr))
                << (32 / PER * j);
    }
    r[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) __stcs(reinterpret_cast<uint4*>(p) + k, r[k]);
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// ---- unary ops ------------------------------------------------------------
struct Relu {
  __device__ float operator()(float x) const {
    return (x > 0.f || isnan_(x)) ? x : 0.f;
  }
};
struct Abs {
  __device__ float operator()(float x) const { return fabsf(x); }
};
struct Exp {
  __device__ float operator()(float x) const { return expf(x); }
};
struct Log {
  __device__ float operator()(float x) const { return logf(x); }
};
struct Sqrt {
  __device__ float operator()(float x) const { return sqrtf(x); }
};
struct Square {
  __device__ float operator()(float x) const { return x * x; }
};
struct Sign {
  __device__ float operator()(float x) const {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
  }
};
struct Sigmoid {
  __device__ float operator()(float x) const { return 1.f / (1.f + expf(-x)); }
};
struct Tanh {
  __device__ float operator()(float x) const { return tanhf(x); }
};
struct Gelu {       // jax.nn.gelu(approximate=True), in its order
  __device__ float operator()(float x) const {
    const float k = 0.7978845608028654f;   // sqrt(2 / pi) in float32
    const float cdf = 0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
};
struct Copy {
  __device__ float operator()(float x) const { return x; }
};
struct Clamp {
  float lo, hi;
  __device__ float operator()(float x) const {
    return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
  }
};

// ---- binary ops -----------------------------------------------------------
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Sub {
  __device__ float operator()(float a, float b) const { return a - b; }
};
struct Mult {
  __device__ float operator()(float a, float b) const { return a * b; }
};
struct Div {
  __device__ float operator()(float a, float b) const { return a / b; }
};
struct Pow {
  __device__ float operator()(float a, float b) const { return powf(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const {
    return (isnan_(a) || isnan_(b)) ? a + b : fmaxf(a, b);
  }
};
struct Min {
  __device__ float operator()(float a, float b) const {
    return (isnan_(a) || isnan_(b)) ? a + b : fminf(a, b);
  }
};
struct Threshold {
  __device__ float operator()(float a, float b) const {
    return a < b ? 1.f : 0.f;
  }
};

// ---- kernels --------------------------------------------------------------
// Values [0, head) and [head + nv * W, n) one by one (grid-stride), the nv
// units between them as 16-byte vectors, UNR1 (unary) or UNR2 (binary) a
// thread.
template <typename Ti, typename To>
struct Unit {
  static constexpr int W = 16 / (sizeof(Ti) < sizeof(To) ? sizeof(Ti)
                                                         : sizeof(To));
  static constexpr int NI = W * sizeof(Ti) / 16;
};

template <typename Op, typename Ti, typename To>
__global__ void __launch_bounds__(NT) unary_kernel(
    const Ti* __restrict__ x, To* __restrict__ y, long long n,
    long long head, long long nv, Op op) {
  constexpr int W = Unit<Ti, To>::W, NI = Unit<Ti, To>::NI;
  const long long v0 = (long long)blockIdx.x * NT * UNR1 + threadIdx.x;
  uint4 r[UNR1][NI];
#pragma unroll
  for (int u = 0; u < UNR1; ++u)
    if (v0 + u * NT < nv) load_unit<Ti, W>(x + head + (v0 + u * NT) * W, r[u]);
#pragma unroll
  for (int u = 0; u < UNR1; ++u) {
    if (v0 + u * NT >= nv) continue;
    float out[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      out[k] = op(unpack(r[u], k, static_cast<Ti*>(nullptr)));
    store_unit<To, W>(y + head + (v0 + u * NT) * W, out);
  }
  const long long ns = n - nv * W;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < ns;
       i += (long long)gridDim.x * NT) {
    const long long j = i < head ? i : i + nv * W;
    store(y + j, op(load(x + j)));
  }
}

template <typename Op, typename Ti, typename To>
__global__ void __launch_bounds__(NT) binary_kernel(
    const Ti* __restrict__ a, const Ti* __restrict__ b, To* __restrict__ y,
    long long n, long long head, long long nv, Op op) {
  constexpr int W = Unit<Ti, To>::W, NI = Unit<Ti, To>::NI;
  const long long v0 = (long long)blockIdx.x * NT * UNR2 + threadIdx.x;
  uint4 ra[UNR2][NI], rb[UNR2][NI];
#pragma unroll
  for (int u = 0; u < UNR2; ++u) {
    if (v0 + u * NT >= nv) continue;
    load_unit<Ti, W>(a + head + (v0 + u * NT) * W, ra[u]);
    load_unit<Ti, W>(b + head + (v0 + u * NT) * W, rb[u]);
  }
#pragma unroll
  for (int u = 0; u < UNR2; ++u) {
    if (v0 + u * NT >= nv) continue;
    float out[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      out[k] = op(unpack(ra[u], k, static_cast<Ti*>(nullptr)),
                  unpack(rb[u], k, static_cast<Ti*>(nullptr)));
    store_unit<To, W>(y + head + (v0 + u * NT) * W, out);
  }
  const long long ns = n - nv * W;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < ns;
       i += (long long)gridDim.x * NT) {
    const long long j = i < head ? i : i + nv * W;
    store(y + j, op(load(a + j), load(b + j)));
  }
}

// Blocks for nv units and n - nv * W single values, unr of either a
// thread; -1 when the split does not fit n or leaves an operand off its
// 16-byte boundary at the body.
template <typename Ti, typename To>
long long grid_for(long long n, long long head, long long nv, int unr,
                   const void* const* ptrs, const int* sizes, int n_ops) {
  constexpr int W = Unit<Ti, To>::W;
  if (head < 0 || nv < 0 || head + nv * W > n) return -1;
  if (nv > 0)
    for (int i = 0; i < n_ops; ++i)
      if ((reinterpret_cast<uintptr_t>(ptrs[i]) + head * sizes[i]) % 16)
        return -1;
  const long long per = (long long)NT * unr;
  const long long units = nv > n - nv * W ? nv : n - nv * W;
  const long long blocks = (units + per - 1) / per;
  return blocks < 1 ? 1 : blocks;
}

// type codes: 0 float32, 1 bfloat16, 2 float16
template <typename Op, typename Ti, typename To>
int unary_launch(const void* x, void* y, long long n, long long head,
                 long long nv, Op op, cudaStream_t st) {
  const void* ptrs[2] = {x, y};
  const int sizes[2] = {(int)sizeof(Ti), (int)sizeof(To)};
  const long long blocks = grid_for<Ti, To>(n, head, nv, UNR1, ptrs, sizes,
                                             2);
  if (blocks < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unary_kernel<<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const Ti*>(x), static_cast<To*>(y), n, head, nv, op);
  return (int)cudaGetLastError();
}

template <typename Op, typename Ti>
int unary_out(const void* x, void* y, long long n, long long head,
              long long nv, int out_t, Op op, cudaStream_t st) {
  switch (out_t) {
    case 0: return unary_launch<Op, Ti, float>(x, y, n, head, nv, op, st);
    case 1: return unary_launch<Op, Ti, __nv_bfloat16>(x, y, n, head, nv, op,
                                                       st);
    case 2: return unary_launch<Op, Ti, __half>(x, y, n, head, nv, op, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Op>
int unary(const void* x, void* y, long long n, long long head, long long nv,
          int in_t, int out_t, Op op, cudaStream_t st) {
  switch (in_t) {
    case 0: return unary_out<Op, float>(x, y, n, head, nv, out_t, op, st);
    case 1: return unary_out<Op, __nv_bfloat16>(x, y, n, head, nv, out_t, op,
                                                st);
    case 2: return unary_out<Op, __half>(x, y, n, head, nv, out_t, op, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Op, typename Ti, typename To>
int binary_launch(const void* a, const void* b, void* y, long long n,
                  long long head, long long nv, Op op, cudaStream_t st) {
  const void* ptrs[3] = {a, b, y};
  const int sizes[3] = {(int)sizeof(Ti), (int)sizeof(Ti), (int)sizeof(To)};
  const long long blocks = grid_for<Ti, To>(n, head, nv, UNR2, ptrs, sizes,
                                             3);
  if (blocks < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  binary_kernel<<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const Ti*>(a), static_cast<const Ti*>(b),
      static_cast<To*>(y), n, head, nv, op);
  return (int)cudaGetLastError();
}

template <typename Op, typename Ti>
int binary_out(const void* a, const void* b, void* y, long long n,
               long long head, long long nv, int out_t, Op op,
               cudaStream_t st) {
  switch (out_t) {
    case 0: return binary_launch<Op, Ti, float>(a, b, y, n, head, nv, op, st);
    case 1: return binary_launch<Op, Ti, __nv_bfloat16>(a, b, y, n, head, nv,
                                                        op, st);
    case 2: return binary_launch<Op, Ti, __half>(a, b, y, n, head, nv, op,
                                                 st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Op>
int binary(const void* a, const void* b, void* y, long long n,
           long long head, long long nv, int in_t, int out_t, Op op,
           cudaStream_t st) {
  switch (in_t) {
    case 0: return binary_out<Op, float>(a, b, y, n, head, nv, out_t, op, st);
    case 1: return binary_out<Op, __nv_bfloat16>(a, b, y, n, head, nv, out_t,
                                                 op, st);
    case 2: return binary_out<Op, __half>(a, b, y, n, head, nv, out_t, op,
                                          st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Unary op codes: 0 relu, 1 abs, 2 exp, 3 log, 4 sqrt, 5 square, 6 sign,
// 7 sigmoid, 8 tanh, 9 gelu, 10 copy, 11 clamp to [lo, hi].  The split:
// `head` single values, `nv` units of W = 16 / (smaller element size)
// values on every operand's 16-byte boundary, then single values to n.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int singa_ew_unary(int op, const void* x, void* y, long long n,
                              long long head, long long nv, int in_t,
                              int out_t, float lo, float hi, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return unary(x, y, n, head, nv, in_t, out_t, Relu{}, st);
    case 1: return unary(x, y, n, head, nv, in_t, out_t, Abs{}, st);
    case 2: return unary(x, y, n, head, nv, in_t, out_t, Exp{}, st);
    case 3: return unary(x, y, n, head, nv, in_t, out_t, Log{}, st);
    case 4: return unary(x, y, n, head, nv, in_t, out_t, Sqrt{}, st);
    case 5: return unary(x, y, n, head, nv, in_t, out_t, Square{}, st);
    case 6: return unary(x, y, n, head, nv, in_t, out_t, Sign{}, st);
    case 7: return unary(x, y, n, head, nv, in_t, out_t, Sigmoid{}, st);
    case 8: return unary(x, y, n, head, nv, in_t, out_t, Tanh{}, st);
    case 9: return unary(x, y, n, head, nv, in_t, out_t, Gelu{}, st);
    case 10: return unary(x, y, n, head, nv, in_t, out_t, Copy{}, st);
    case 11: return unary(x, y, n, head, nv, in_t, out_t, Clamp{lo, hi}, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Binary op codes: 0 add, 1 sub, 2 mult, 3 div, 4 pow, 5 max, 6 min,
// 7 threshold; a and b share the input type.  The split as above.
extern "C" int singa_ew_binary(int op, const void* a, const void* b, void* y,
                               long long n, long long head, long long nv,
                               int in_t, int out_t, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return binary(a, b, y, n, head, nv, in_t, out_t, Add{}, st);
    case 1: return binary(a, b, y, n, head, nv, in_t, out_t, Sub{}, st);
    case 2: return binary(a, b, y, n, head, nv, in_t, out_t, Mult{}, st);
    case 3: return binary(a, b, y, n, head, nv, in_t, out_t, Div{}, st);
    case 4: return binary(a, b, y, n, head, nv, in_t, out_t, Pow{}, st);
    case 5: return binary(a, b, y, n, head, nv, in_t, out_t, Max{}, st);
    case 6: return binary(a, b, y, n, head, nv, in_t, out_t, Min{}, st);
    case 7: return binary(a, b, y, n, head, nv, in_t, out_t, Threshold{}, st);
  }
  return (int)cudaErrorInvalidValue;
}
