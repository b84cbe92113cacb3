// Paged decode attention for Hopper (sm_90a): a float32, bfloat16 or float16
// query over float32, bfloat16, float16 or int8 page pools (the int8 pools
// carry bfloat16 or float32 dequant scales), the page type independent of
// the query's.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (singa_tpu/ops/paged_attention.py, launched by `paged_decode_attention`),
// its float path and its quantized branch.  What the reference computes:
// one query per slot, q (S, H, D), upcast to float32 as the pages are; page
// pools (N, H, P, D); block
// table (S, Ps) int32 of physical page ids (NULL and stale entries are
// valid ids); pos (S,) int32.  Every column t of a slot's Ps * P table row
// is scored dot(q, k_t) * scale (times ks[t] for int8 pools), a column
// t > pos[s] is replaced by the finite -1e9, and the softmax, an online
// recurrence started at m = -1e9 with l clamped to 1e-30 at the end, sums
// the UNSCALED weights in its denominator while the value sum adds
// p * vs[t] * v_t.  So a column past pos weighs exactly zero whenever one
// column is live, and a slot with pos < 0 has every column at -1e9: its
// softmax is uniform and its output is sum_t vs_t * v_t / (Ps * P) over
// the whole table row (vs_t = 1 for float pools).  pos >= Ps * P - 1 makes
// every column live.  No dequantised page is written anywhere: each int8
// or 16-bit channel becomes a float in a register.  The output is written
// in the query's type, rounded once from the float32 result; the partials
// of the split stay float32.
//
// On the TPU the table was scalar-prefetched and the page loop was the
// sequential minor grid axis, carrying (m, l, acc) in VMEM from one grid
// step to the next.  Hopper blocks run in no order and carry nothing, so
// the page walk is split.
//
// The plan.  The wrapper cuts each slot's Ps table entries into R ranges
// of ppr pages (the last may be shorter), from the shapes alone, never
// from pos (ops/paged_attention.py, `_split_plan`), and passes (R, ppr) as
// launch arguments.  One block per (range, head, slot).  A range whose
// first column lies past pos[s] reads nothing but pos and exits; a live
// range reads its live table entries into shared memory, then only the K
// and V rows at columns <= pos.  For pos < 0 every range is live over all
// of its columns, and only V (and the V scales) is read: every score is
// -1e9, so every weight is exp(0) = 1.
//
// Inside a block.  A row of D channels is read by a group of LPR lanes
// (the next power of two >= D / VEC), each lane one 16-byte vector of VEC
// channels (4 float32, 8 bfloat16 or float16, 16 int8).  Each group takes U rows at a
// time and issues all 2U K and V loads (and the U rows' scales, one load a
// row by one lane, shuffled to the others) before it reduces anything: V
// does not depend on the scores.  A row's dot is summed over its group in
// log2(LPR) shuffle steps.  Each group keeps its own online softmax state
// (m, l, acc) over the rows it took; at the end the block merges its
// groups through shared memory in group order.  A head dim that is not a
// multiple of VEC, or a pool that is not 16-byte aligned, takes the same
// code with element loads.
//
// The merge.  A slot with one live range (always so with R = 1) has its
// block write o = acc / max(l, 1e-30) itself.  Otherwise each live block
// writes its (m, l, acc) to the partials buffer, and a second launch on
// the same stream, one block per (head, slot), merges the slot's live
// ranges in range order (its blocks for the other slots exit at once).
// The same sums in the same order on every run, no atomics, and nothing
// that outlives a call: the merge reads only what the launch before it
// wrote.  Both launches come from one C entry, so the host makes one call.
//
// What bounds it: about 0.5 operation per byte read (2 with int8 pages),
// so the K/V bytes of the live rows over the memory rate; what the design
// has to hide is latency, hence blocks enough to fill the card at the
// serving shape (8 slots x 12 heads x 8 ranges = 768) and 2U 16-byte loads
// in flight per lane.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 128;          // threads a block
constexpr int MAX_D = 128;
constexpr int MAX_P = 256;
// table entries a block stages in shared memory: the card's plan takes at
// most 8 a range (`_MAX_PPR` in ops/paged_attention.py), but the entry
// takes up to this many, so a caller may force the unsplit plan
constexpr int MAX_STAGED_PAGES = 256;
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct NoScale {};              // the float pools: no dequant scales

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_f(__half* p, float x) {
  *p = __float2half_rn(x);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

// element k of a 16-byte vector of E, as a float
template <typename E>
__device__ __forceinline__ float elem(const uint4& r, int k) {
  if constexpr (std::is_same<E, float>::value) {
    return __uint_as_float(word(r, k));
  } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const uint32_t w = word(r, k >> 1);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else if constexpr (std::is_same<E, __half>::value) {
    const uint32_t w = word(r, k >> 1);
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((k & 1) ? (w >> 16) : (w & 0xffffu))));
  } else {                                              // int8
    const uint32_t w = word(r, k >> 2);
    return static_cast<float>(
        static_cast<int32_t>(w << (24 - 8 * (k & 3))) >> 24);
  }
}

// A lane's VEC channels of one row, starting at p; `valid` of them exist.
// One 16-byte load when the row is aligned and whole, else element loads
// packed into the same layout (missing channels are zero).
template <typename E>
__device__ __forceinline__ uint4 load_slice(const E* p, int valid, bool vec) {
  constexpr int VEC = 16 / sizeof(E);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  using Raw = typename std::conditional<
      sizeof(E) == 4, uint32_t,
      typename std::conditional<sizeof(E) == 2, uint16_t,
                                uint8_t>::type>::type;
  const Raw* rp = reinterpret_cast<const Raw*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < valid)
      w[(k * sizeof(E)) / 4] |= static_cast<uint32_t>(__ldg(rp + k))
                                << (8 * ((k * sizeof(E)) % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Live rows of range r of slot s (0: the block reads nothing).
__device__ __forceinline__ int live_rows(int ps, int r, int ppr, int P,
                                         int Ps) {
  const int range_rows = min(ppr, Ps - r * ppr) * P;
  if (ps < 0) return range_rows;                        // all at -1e9
  const int last = min(ps, Ps * P - 1);
  return max(0, min(range_rows, last + 1 - r * ppr * P));
}

template <typename QE, typename E, typename SC>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const QE* __restrict__ q, const E* __restrict__ kp,
    const E* __restrict__ vp, const SC* __restrict__ ks,
    const SC* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ pos, QE* __restrict__ o,
    float* __restrict__ parts, int H, int P, int Ps, int D, int ppr, int lpr,
    float scale) {
  constexpr bool QUANT = !std::is_same<SC, NoScale>::value;
  constexpr int VEC = 16 / sizeof(E);
  constexpr int U = sizeof(E) == 1 ? 4 : 8;   // rows a group loads at once
  __shared__ int tbl[MAX_STAGED_PAGES];
  __shared__ float gm[NT], gl[NT], gf[NT];
  __shared__ float gacc[NT * VEC];
  __shared__ float bmax;

  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int R = gridDim.x;
  const int ps = pos[s];
  const int n_rows = live_rows(ps, r, ppr, P, Ps);
  if (n_rows == 0) return;              // wholly past pos: reads nothing
  const bool scored = ps >= 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int li = lane & (lpr - 1);      // lane in its row group
  const int g = tid / lpr;              // row group in the block
  const int G = NT / lpr;
  const int c0 = li * VEC;              // the lane's first channel
  const int valid = max(0, min(VEC, D - c0));
  const bool vec = D % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp))
       & 15) == 0;

  const int live_pages = (n_rows + P - 1) / P;
  for (int i = tid; i < live_pages; i += NT)
    tbl[i] = table[(size_t)s * Ps + r * ppr + i];
  float qf[VEC];
  const QE* qs = q + ((size_t)s * H + h) * D + c0;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    qf[k] = (scored && k < valid) ? to_f(qs[k]) : 0.f;
  __syncthreads();

  float m = NEG, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  for (int base = 0; base < n_rows; base += U * G) {
    uint4 kr[U], vr[U];
    size_t row[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * G + g;
      const bool ok = t < n_rows;
      const int j = ok ? t / P : 0;
      row[u] = ok ? ((size_t)tbl[j] * H + h) * P + (t - j * P) : 0;
      const int nv = ok ? valid : 0;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (scored && nv > 0) kr[u] = load_slice(kp + row[u] * D + c0, nv, vec);
      vr[u] = nv > 0 ? load_slice(vp + row[u] * D + c0, nv, vec)
                     : make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 1.f;
      if constexpr (QUANT) {
        if (ok && li == u % lpr) {      // one load a row, by one lane
          if (scored) ksc[u] = to_f(ks[row[u]]);
          vsc[u] = to_f(vs[row[u]]);
        }
      }
    }
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) dot = fmaf(qf[k], elem<E>(kr[u], k), dot);
      x[u] = dot;
    }
    if (scored) {
      for (int off = lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] += __shfl_xor_sync(FULL, x[u], off);
      }
    }
    const int src = lane & ~(lpr - 1);
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (QUANT) {
        ksc[u] = __shfl_sync(FULL, ksc[u], src + u % lpr);
        vsc[u] = __shfl_sync(FULL, vsc[u], src + u % lpr);
      }
      const bool ok = base + u * G + g < n_rows;
      x[u] = scored ? x[u] * scale * ksc[u] : NEG;
      if (ok) mx = fmaxf(mx, x[u]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * G + g >= n_rows) continue;
      float p = expf(x[u] - mx);
      psum += p;                                   // the unscaled p
      p *= vsc[u];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = fmaf(p, elem<E>(vr[u], k), acc[k]);
    }
    l = l * alpha + psum;
    m = mx;
  }

  // merge the block's row groups, in group order
  if (li == 0) {
    gm[g] = m;
    gl[g] = l;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < valid) gacc[g * D + c0 + k] = acc[k];
  __syncthreads();
  if (tid < G) {
    float mx = NEG;
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, gm[i]);
    gf[tid] = expf(gm[tid] - mx);
    if (tid == 0) bmax = mx;
  }
  __syncthreads();
  const float mm = bmax;
  float ll = 0.f, aa = 0.f;
  for (int i = 0; i < G; ++i) {
    ll = fmaf(gl[i], gf[i], ll);
    if (tid < D) aa = fmaf(gacc[i * D + tid], gf[i], aa);
  }
  const size_t sh = (size_t)s * gridDim.y + h;
  const int n_live = ps < 0 ? R : min(ps, Ps * P - 1) / (P * ppr) + 1;
  if (n_live == 1) {                    // the slot's only live range
    if (tid < D) from_f(o + sh * D + tid, aa / fmaxf(ll, 1e-30f));
    return;
  }

  // a split slot: leave (m, l, acc) for the merge launch
  float* part = parts + (sh * R + r) * (D + 2);
  if (tid < D) part[2 + tid] = aa;
  if (tid == 0) {
    part[0] = mm;
    part[1] = ll;
  }
}

// One block per (head, slot): the slot's live ranges merged in range
// order, o = sum_r acc_r e^(m_r - M) / max(sum_r l_r e^(m_r - M), 1e-30).
// A slot with one live range was written by the launch before.  o is in
// the query's type.
template <typename QE>
__global__ void __launch_bounds__(NT) paged_merge_kernel(
    const float* __restrict__ parts, const int* __restrict__ pos,
    QE* __restrict__ o, int P, int Ps, int D, int R, int ppr) {
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int ps = pos[s];
  const int n_live = ps < 0 ? R : min(ps, Ps * P - 1) / (P * ppr) + 1;
  if (n_live == 1 || tid >= D) return;
  const size_t sh = (size_t)s * gridDim.x + h;
  const float* mine = parts + sh * R * (D + 2);
  float mt = NEG;
  for (int i = 0; i < n_live; ++i) mt = fmaxf(mt, mine[(size_t)i * (D + 2)]);
  float lt = 0.f, at = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const float* pi = mine + (size_t)i * (D + 2);
    const float f = expf(pi[0] - mt);
    lt = fmaf(pi[1], f, lt);
    at = fmaf(pi[2 + tid], f, at);
  }
  from_f(o + sh * D + tid, at / fmaxf(lt, 1e-30f));
}

template <typename QE>
cudaError_t launch_merge(const float* parts, const int* pos, void* o, int S,
                         int H, int P, int Ps, int D, int R, int ppr,
                         cudaStream_t st) {
  paged_merge_kernel<QE><<<dim3(H, S), NT, 0, st>>>(
      parts, pos, static_cast<QE*>(o), P, Ps, D, R, ppr);
  return cudaGetLastError();
}

template <typename QE, typename E, typename SC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* table,
                   const int* pos, void* o, float* parts, int S, int H,
                   int P, int Ps, int D, int R, int ppr, float scale,
                   cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(E);
  int lpr = 1;
  while (lpr * VEC < D) lpr <<= 1;
  paged_decode_kernel<QE, E, SC><<<dim3(R, H, S), NT, 0, st>>>(
      static_cast<const QE*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), static_cast<const SC*>(ks),
      static_cast<const SC*>(vs), table, pos, static_cast<QE*>(o), parts, H,
      P, Ps, D, ppr, lpr, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R == 1) return err;
  return launch_merge<QE>(parts, pos, o, S, H, P, Ps, D, R, ppr, st);
}

// The page variants for one query type: float32, bfloat16 and float16 pages
// without scales, int8 pages with either scale type.
template <typename QE>
cudaError_t launch_pages(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const int* table,
                         const int* pos, void* o, float* parts, int S, int H,
                         int P, int Ps, int D, int R, int ppr, float scale,
                         int elem, int scale_kind, cudaStream_t st) {
  if (elem == 0 && scale_kind == 0)
    return launch<QE, float, NoScale>(q, kp, vp, ks, vs, table, pos, o,
                                      parts, S, H, P, Ps, D, R, ppr, scale,
                                      st);
  if (elem == 1 && scale_kind == 0)
    return launch<QE, __nv_bfloat16, NoScale>(q, kp, vp, ks, vs, table, pos,
                                              o, parts, S, H, P, Ps, D, R,
                                              ppr, scale, st);
  if (elem == 3 && scale_kind == 0)
    return launch<QE, __half, NoScale>(q, kp, vp, ks, vs, table, pos, o,
                                       parts, S, H, P, Ps, D, R, ppr, scale,
                                       st);
  if (elem == 2 && scale_kind == 1)
    return launch<QE, int8_t, __nv_bfloat16>(q, kp, vp, ks, vs, table, pos,
                                             o, parts, S, H, P, Ps, D, R, ppr,
                                             scale, st);
  if (elem == 2 && scale_kind == 2)
    return launch<QE, int8_t, float>(q, kp, vp, ks, vs, table, pos, o, parts,
                                     S, H, P, Ps, D, R, ppr, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Query (and output) codes: 0 float32, 1 bfloat16, 2 float16.  Page element
// codes: 0 float32, 1 bfloat16, 2 int8, 3 float16.  Scale codes: 0 none,
// 1 bfloat16, 2 float32.  The variants built, for each query type: float32,
// bfloat16 and float16 pages without scales, int8 pages with either scale
// type.  The plan: R ranges
// of ppr table entries (R = ceil(Ps / ppr)).  R > 1 launches the merge
// after the ranges and needs `parts`, S * H * R * (D + 2) floats of
// scratch, which both launches use in stream order.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int singa_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, const int* table,
                                  const int* pos, void* o, float* parts,
                                  int S, int H, int P, int Ps, int D, int R,
                                  int ppr, float scale, int q_elem, int elem,
                                  int scale_kind, void* stream) {
  if (D < 1 || D > MAX_D || P < 1 || P > MAX_P || ppr < 1 ||
      ppr > MAX_STAGED_PAGES || R != (Ps + ppr - 1) / ppr ||
      (R > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_elem == 0)
    err = launch_pages<float>(q, k_pages, v_pages, k_scales, v_scales, table,
                              pos, o, parts, S, H, P, Ps, D, R, ppr, scale,
                              elem, scale_kind, st);
  else if (q_elem == 1)
    err = launch_pages<__nv_bfloat16>(q, k_pages, v_pages, k_scales,
                                      v_scales, table, pos, o, parts, S, H, P,
                                      Ps, D, R, ppr, scale, elem, scale_kind,
                                      st);
  else if (q_elem == 2)
    err = launch_pages<__half>(q, k_pages, v_pages, k_scales, v_scales,
                               table, pos, o, parts, S, H, P, Ps, D, R, ppr,
                               scale, elem, scale_kind, st);
  return (int)err;
}

// The merge launch alone, on partials a split launch left in `parts`
// under the same plan (R > 1): for checking and timing it by itself.  o is
// of the query's type (`q_elem`, coded as above).
extern "C" int singa_paged_decode_merge(const float* parts, const int* pos,
                                        void* o, int S, int H, int P, int Ps,
                                        int D, int R, int ppr, int q_elem,
                                        void* stream) {
  if (D < 1 || D > MAX_D || P < 1 || ppr < 1 || R < 2 ||
      R != (Ps + ppr - 1) / ppr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_elem == 0)
    return (int)launch_merge<float>(parts, pos, o, S, H, P, Ps, D, R, ppr,
                                    st);
  if (q_elem == 1)
    return (int)launch_merge<__nv_bfloat16>(parts, pos, o, S, H, P, Ps, D,
                                            R, ppr, st);
  if (q_elem == 2)
    return (int)launch_merge<__half>(parts, pos, o, S, H, P, Ps, D, R, ppr,
                                     st);
  return (int)cudaErrorInvalidValue;
}
