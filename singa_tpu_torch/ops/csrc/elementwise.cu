// The elementwise catalogue for Hopper (sm_90a): one grid-stride kernel
// for unary maps and one for binary maps, each templated on the op functor
// and on the input and output types (float32, bfloat16, float16).
//
// Replaces the Pallas TPU kernels built by `_ew_call` (singa_tpu/ops/
// pallas_kernels.py: `_unary_kernel`, `_binary_kernel`; entries `ew_unary`,
// `ew_binary`, `clamp`).  The TPU version flattened every operand into
// (rows, 128) tiles padded to (8, 128) and cut the result back; here a
// thread walks the flat array with a grid stride, so any length runs as it
// is and nothing is padded.
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
// What bounds it: about one operation per 8-12 bytes moved, so the bytes
// (each input read once, the output written once) over the memory rate;
// the kernel's job is to keep enough loads in flight, which a full grid of
// 256-thread blocks does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 resident blocks on each of 132 SMs

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
template <typename Op, typename Ti, typename To>
__global__ void __launch_bounds__(NT) unary_kernel(
    const Ti* __restrict__ x, To* __restrict__ y, long long n, Op op) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    store(y + i, op(load(x + i)));
}

template <typename Op, typename Ti, typename To>
__global__ void __launch_bounds__(NT) binary_kernel(
    const Ti* __restrict__ a, const Ti* __restrict__ b, To* __restrict__ y,
    long long n, Op op) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    store(y + i, op(load(a + i), load(b + i)));
}

int grid_for(long long n) {
  const long long blocks = (n + NT - 1) / NT;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// type codes: 0 float32, 1 bfloat16, 2 float16
template <typename Op, typename Ti>
int unary_out(const void* x, void* y, long long n, int out_t, Op op,
              cudaStream_t st) {
  const Ti* xi = static_cast<const Ti*>(x);
  switch (out_t) {
    case 0: unary_kernel<<<grid_for(n), NT, 0, st>>>(
                xi, static_cast<float*>(y), n, op); break;
    case 1: unary_kernel<<<grid_for(n), NT, 0, st>>>(
                xi, static_cast<__nv_bfloat16*>(y), n, op); break;
    case 2: unary_kernel<<<grid_for(n), NT, 0, st>>>(
                xi, static_cast<__half*>(y), n, op); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Op>
int unary(const void* x, void* y, long long n, int in_t, int out_t, Op op,
          cudaStream_t st) {
  switch (in_t) {
    case 0: return unary_out<Op, float>(x, y, n, out_t, op, st);
    case 1: return unary_out<Op, __nv_bfloat16>(x, y, n, out_t, op, st);
    case 2: return unary_out<Op, __half>(x, y, n, out_t, op, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Op, typename Ti>
int binary_out(const void* a, const void* b, void* y, long long n, int out_t,
               Op op, cudaStream_t st) {
  const Ti* ai = static_cast<const Ti*>(a);
  const Ti* bi = static_cast<const Ti*>(b);
  switch (out_t) {
    case 0: binary_kernel<<<grid_for(n), NT, 0, st>>>(
                ai, bi, static_cast<float*>(y), n, op); break;
    case 1: binary_kernel<<<grid_for(n), NT, 0, st>>>(
                ai, bi, static_cast<__nv_bfloat16*>(y), n, op); break;
    case 2: binary_kernel<<<grid_for(n), NT, 0, st>>>(
                ai, bi, static_cast<__half*>(y), n, op); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Op>
int binary(const void* a, const void* b, void* y, long long n, int in_t,
           int out_t, Op op, cudaStream_t st) {
  switch (in_t) {
    case 0: return binary_out<Op, float>(a, b, y, n, out_t, op, st);
    case 1: return binary_out<Op, __nv_bfloat16>(a, b, y, n, out_t, op, st);
    case 2: return binary_out<Op, __half>(a, b, y, n, out_t, op, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Unary op codes: 0 relu, 1 abs, 2 exp, 3 log, 4 sqrt, 5 square, 6 sign,
// 7 sigmoid, 8 tanh, 9 gelu, 10 copy, 11 clamp to [lo, hi].  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int singa_ew_unary(int op, const void* x, void* y, long long n,
                              int in_t, int out_t, float lo, float hi,
                              void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return unary(x, y, n, in_t, out_t, Relu{}, st);
    case 1: return unary(x, y, n, in_t, out_t, Abs{}, st);
    case 2: return unary(x, y, n, in_t, out_t, Exp{}, st);
    case 3: return unary(x, y, n, in_t, out_t, Log{}, st);
    case 4: return unary(x, y, n, in_t, out_t, Sqrt{}, st);
    case 5: return unary(x, y, n, in_t, out_t, Square{}, st);
    case 6: return unary(x, y, n, in_t, out_t, Sign{}, st);
    case 7: return unary(x, y, n, in_t, out_t, Sigmoid{}, st);
    case 8: return unary(x, y, n, in_t, out_t, Tanh{}, st);
    case 9: return unary(x, y, n, in_t, out_t, Gelu{}, st);
    case 10: return unary(x, y, n, in_t, out_t, Copy{}, st);
    case 11: return unary(x, y, n, in_t, out_t, Clamp{lo, hi}, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Binary op codes: 0 add, 1 sub, 2 mult, 3 div, 4 pow, 5 max, 6 min,
// 7 threshold; a and b share the input type.
extern "C" int singa_ew_binary(int op, const void* a, const void* b, void* y,
                               long long n, int in_t, int out_t,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return binary(a, b, y, n, in_t, out_t, Add{}, st);
    case 1: return binary(a, b, y, n, in_t, out_t, Sub{}, st);
    case 2: return binary(a, b, y, n, in_t, out_t, Mult{}, st);
    case 3: return binary(a, b, y, n, in_t, out_t, Div{}, st);
    case 4: return binary(a, b, y, n, in_t, out_t, Pow{}, st);
    case 5: return binary(a, b, y, n, in_t, out_t, Max{}, st);
    case 6: return binary(a, b, y, n, in_t, out_t, Min{}, st);
    case 7: return binary(a, b, y, n, in_t, out_t, Threshold{}, st);
  }
  return (int)cudaErrorInvalidValue;
}
