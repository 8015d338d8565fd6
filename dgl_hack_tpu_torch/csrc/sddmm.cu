// K6: gSDDMM, a per-edge binary op of an src-side or edge operand with a
// dst-side operand (float32, or bf16 operands and result computed in
// float32).
//
//   out[e, f] = op(lhs[row(e), f], rhs[dst[e], f])        op in copy_rhs,
//                                                         add, sub, mul, div
//   out[e, h] = sum_{d < D} lhs[row(e), h*D + d] * rhs[dst[e], h*D + d]
//                                                         op = dot, F = H*D
//
// for every edge e in internal (CSC, dst-sorted) order, with row(e) =
// src[e] for a node operand ('u') or e itself when src == NULL (an edge
// operand, 'e').  copy_rhs reads no lhs.  lhs is (rows, F), rhs (num_dst,
// F), out (E, F) or (E, H) for dot; rows are contiguous.  A dst row with no
// in-edges has no edge, so nothing is read or written for it.
//
// Replaces the TPU kernel dgl_hack_tpu/ops/pallas/sddmm_kernel.py
// _sddmm_kernel (line 160), launched by _sddmm_call.  Like it, the bf16
// instance (sddmm_bf16) widens its operands to float, computes in float32
// and rounds the result once, to nearest even (gsddmm_pallas casts its
// float32 result to the operands' dtype); the wrapper casts mixed
// float32/bf16 operands up and runs the float32 instance.  The TPU gathered the
// dst rows through dense windows and an exact one-hot MXU row expansion,
// with a host-side window plan and an overflow patch, because per-edge
// gathers are slow there; on the H100 a warp reads rhs[dst[e]] directly,
// and the graph's own dst array is the plan.
//
// Bound on the H100: bytes.  Compulsory traffic is the indices, lhs and
// rhs once each and the output; the kernel also gathers one lhs row per
// edge for a node operand (4F bytes per edge: L2 hits only on graphs whose
// rows fit in its 50 MB).  A dot does 2F operations per edge, far below
// the fp32 rate.
//
// Design:
// * Elementwise ops, F >= 32: each warp walks a tile of kTileE consecutive
//   edges; lanes cover features, 4 per lane per 128-wide pass.  Edges are
//   dst-sorted, so the rhs row stays in registers while dst[e] is
//   unchanged and is read from memory once per run of equal dst.  A hub
//   row with 10^5 in-edges spreads over many tiles and warps; no warp owns
//   a whole dst segment.
// * Elementwise ops, F < 32: the warp splits into 32/Fp lane groups (Fp =
//   F rounded up to a power of two), one edge per group, as K1 does.
// * dot, D <= 32 with 4 | D and 16-byte aligned lhs and rhs (the
//   transformer's heads, D = 16): one thread per (edge, head) item, i =
//   e * H + h, consecutive threads on consecutive items.  A thread reads
//   its two D-wide head slices with D / 4 float4 loads each and sums them
//   in a fixed fmaf chain; the H threads of an edge read src[e] and dst[e]
//   in the same warp load (one transaction), and a warp's 32 outputs are
//   one coalesced store.  At the transformer's shape the operands sit in
//   L2 and the cost is issue and latency, not bytes: a 16-lane group per
//   item, loading 4 B a lane and summing by shuffles, puts only 2 items
//   in flight per warp round.  D / 4 is a template parameter (1..8), so
//   the chain has no runtime loop.
// * dot, otherwise: one kernel body, instantiated twice.  D <= 32: each
//   (edge, head) item takes a group of Dp lanes (Dp = D rounded up to a
//   power of two; lanes past D add 0).  D > 32: each item takes the warp,
//   whose lanes stride over d.  A fixed shuffle-xor tree then sums the
//   group.  The d loop exists only in the D > 32 instance: on the H100 a
//   runtime loop in the narrow instance, even one that ran once, made it
//   slower.
// * bf16 operands (T = bf16) halve the bytes read; the dot's vector path
//   then loads four values in 8 bytes.
// Every sum has a fixed order, so every result repeats bitwise; the
// elementwise ops are one IEEE op per element (no fast math), so they
// equal the plain PyTorch version bitwise (in bf16: the float32 op,
// rounded once).  Left for later: vector (16 B) loads in the elementwise
// ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kWarps = 8;     // warps per block
constexpr int kTileE = 32;    // edges per warp, elementwise ops
constexpr int kTileI = 64;    // (edge, head) items per warp, dot, D <= 32
constexpr int kTileW = 8;     // items per warp, dot, D > 32
constexpr unsigned kFull = 0xffffffffu;

enum Op { kCopyRhs = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4, kDot = 5 };

template <int OP>
__device__ __forceinline__ float combine(float l, float r) {
  if (OP == kCopyRhs) return r;
  if (OP == kAdd) return l + r;
  if (OP == kSub) return l - r;
  if (OP == kMul) return l * r;
  return l / r;   // kDiv
}

// one value of T widened to float, and a float stored as T (a bf16 store
// rounds to nearest even)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive values of T: one 16-byte load of float, one 8-byte load
// of bf16 (the bits of a bf16 b are those of the float b << 16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <class T, int OP>
__global__ void sddmm_elem_kernel(const int* __restrict__ src,
                                  const int* __restrict__ dst,
                                  const T* __restrict__ lhs,
                                  const T* __restrict__ rhs,
                                  T* __restrict__ out, int E, int F) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t e0 = warp * kTileE;
  if (e0 >= E) return;
  const int64_t e1 = e0 + kTileE < E ? e0 + kTileE : E;
  const int64_t Fl = F;

  if (F < 32) {
    const int fp = next_pow2(F);
    const int groups = 32 / fp;
    const int sub = lane % fp;
    if (sub >= F) return;
    for (int64_t e = e0 + lane / fp; e < e1; e += groups) {
      const float r = ld(rhs + (int64_t)dst[e] * Fl + sub);
      float l = 0.0f;
      if (OP != kCopyRhs) {
        const int64_t row = src ? (int64_t)src[e] : e;
        l = ld(lhs + row * Fl + sub);
      }
      st(out + e * Fl + sub, combine<OP>(l, r));
    }
    return;
  }

  for (int f0 = 0; f0 < F; f0 += 128) {
    float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int v = -1;
    for (int64_t e = e0; e < e1; ++e) {
      const int ve = dst[e];
      if (ve != v) {       // warp-uniform: a new dst row starts
        v = ve;
        const T* rr = rhs + (int64_t)v * Fl;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int f = f0 + lane + 32 * k;
          if (f < F) r[k] = ld(rr + f);
        }
      }
      const T* lr = nullptr;
      if (OP != kCopyRhs) lr = lhs + (src ? (int64_t)src[e] : e) * Fl;
      T* o = out + e * Fl;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + lane + 32 * k;
        if (f < F)
          st(o + f, combine<OP>(OP != kCopyRhs ? ld(lr + f) : 0.0f, r[k]));
      }
    }
  }
}

// out[i] for items i = e * H + h.  WIDE = false (D <= 32): each item takes
// a group of Dp lanes (Dp = D rounded up to a power of two; lanes past D
// add 0).  WIDE = true (D > 32): each item takes the warp, whose lanes
// stride over d.  A fixed shuffle-xor tree then sums the group.
template <class T, bool WIDE>
__global__ void sddmm_dot_kernel(const int* __restrict__ src,
                                 const int* __restrict__ dst,
                                 const T* __restrict__ lhs,
                                 const T* __restrict__ rhs,
                                 T* __restrict__ out, int64_t items,
                                 int H, int D) {
  constexpr int kTile = WIDE ? kTileW : kTileI;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t i0 = warp * kTile;
  if (i0 >= items) return;       // warp-uniform
  const int64_t i1 = i0 + kTile < items ? i0 + kTile : items;
  const int dp = WIDE ? 32 : next_pow2(D);
  const int groups = 32 / dp;
  const int sub = lane % dp;
  const int grp = lane / dp;
  const int64_t F = (int64_t)H * D;
  for (int64_t base = i0; base < i1; base += groups) {   // warp-uniform
    const int64_t i = base + grp;
    const bool valid = i < i1;
    float p = 0.0f;
    if (valid && sub < D) {
      const int64_t e = i / H;
      const int h = (int)(i - e * H);
      const int64_t row = src ? (int64_t)src[e] : e;
      const T* lr = lhs + row * F + (int64_t)h * D;
      const T* rr = rhs + (int64_t)dst[e] * F + (int64_t)h * D;
      if (WIDE)
        for (int d = sub; d < D; d += 32) p = fmaf(ld(lr + d), ld(rr + d), p);
      else
        p = ld(lr + sub) * ld(rr + sub);
    }
    for (int off = dp >> 1; off > 0; off >>= 1)
      p += __shfl_xor_sync(kFull, p, off);
    if (valid && sub == 0) st(out + i, p);
  }
}

// out[i] for items i = e * H + h, D = 4 * D4: one thread per item, see
// the design note.
template <class T, int D4>
__global__ void sddmm_dot_vec_kernel(const int* __restrict__ src,
                                     const int* __restrict__ dst,
                                     const T* __restrict__ lhs,
                                     const T* __restrict__ rhs,
                                     T* __restrict__ out, uint32_t items,
                                     uint32_t H) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  const uint32_t e = i / H;
  const uint32_t h = i - e * H;
  const int64_t F = (int64_t)H * (4 * D4);
  const int64_t row = src ? (int64_t)__ldg(src + e) : (int64_t)e;
  const int64_t col = (int64_t)h * (4 * D4);
  const T* lr = lhs + row * F + col;
  const T* rr = rhs + (int64_t)__ldg(dst + e) * F + col;
  float4 l[D4], r[D4];
#pragma unroll
  for (int k = 0; k < D4; ++k) {
    l[k] = ld4(lr + 4 * k);
    r[k] = ld4(rr + 4 * k);
  }
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < D4; ++k) {
    p = fmaf(l[k].x, r[k].x, p);
    p = fmaf(l[k].y, r[k].y, p);
    p = fmaf(l[k].z, r[k].z, p);
    p = fmaf(l[k].w, r[k].w, p);
  }
  st(out + i, p);
}

template <class T, int D4>
void launch_dot_vec(const int* src, const int* dst, const T* lhs,
                    const T* rhs, T* out, uint32_t items, uint32_t H,
                    cudaStream_t stream) {
  constexpr int kThreads = kWarps * 32;
  sddmm_dot_vec_kernel<T, D4><<<(items + kThreads - 1) / kThreads, kThreads,
                                0, stream>>>(src, dst, lhs, rhs, out, items,
                                             H);
}

template <class T, int OP>
void launch_elem(const int* src, const int* dst, const T* lhs, const T* rhs,
                 T* out, int E, int F, cudaStream_t stream) {
  const int64_t warps = ((int64_t)E + kTileE - 1) / kTileE;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  sddmm_elem_kernel<T, OP><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      src, dst, lhs, rhs, out, E, F);
}

template <class T>
int sddmm(const int* src, const int* dst, const T* lhs, const T* rhs, T* out,
          int op, int E, int F, int D, cudaStream_t stream) {
  if (E <= 0 || F <= 0) return (int)cudaGetLastError();
  switch (op) {
    case kCopyRhs:
      launch_elem<T, kCopyRhs>(src, dst, lhs, rhs, out, E, F, stream);
      break;
    case kAdd:
      launch_elem<T, kAdd>(src, dst, lhs, rhs, out, E, F, stream);
      break;
    case kSub:
      launch_elem<T, kSub>(src, dst, lhs, rhs, out, E, F, stream);
      break;
    case kMul:
      launch_elem<T, kMul>(src, dst, lhs, rhs, out, E, F, stream);
      break;
    case kDiv:
      launch_elem<T, kDiv>(src, dst, lhs, rhs, out, E, F, stream);
      break;
    case kDot: {
      if (D <= 0 || F % D != 0) return (int)cudaErrorInvalidValue;
      const int H = F / D;
      const int64_t items = (int64_t)E * H;
      const uintptr_t a4 = 4 * sizeof(T);      // bytes of four values
      const bool vec = D <= 32 && D % 4 == 0 && items <= UINT32_MAX &&
                       (uintptr_t)lhs % a4 == 0 && (uintptr_t)rhs % a4 == 0;
      if (vec) {
        using Launch = void (*)(const int*, const int*, const T*, const T*,
                                T*, uint32_t, uint32_t, cudaStream_t);
        static const Launch by_d4[8] = {
            launch_dot_vec<T, 1>, launch_dot_vec<T, 2>, launch_dot_vec<T, 3>,
            launch_dot_vec<T, 4>, launch_dot_vec<T, 5>, launch_dot_vec<T, 6>,
            launch_dot_vec<T, 7>, launch_dot_vec<T, 8>};
        by_d4[D / 4 - 1](src, dst, lhs, rhs, out, (uint32_t)items,
                         (uint32_t)H, stream);
        break;
      }
      const int64_t tile = D <= 32 ? kTileI : kTileW;   // kTile of the instance
      const int64_t warps = (items + tile - 1) / tile;
      const int64_t blocks = (warps + kWarps - 1) / kWarps;
      if (D <= 32)
        sddmm_dot_kernel<T, false><<<(unsigned)blocks, kWarps * 32, 0,
                                     stream>>>(src, dst, lhs, rhs, out, items,
                                               H, D);
      else
        sddmm_dot_kernel<T, true><<<(unsigned)blocks, kWarps * 32, 0,
                                    stream>>>(src, dst, lhs, rhs, out, items,
                                              H, D);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 copy_rhs, 1 add, 2 sub, 3 mul, 4 div, 5 dot.  src == NULL reads
// lhs row e (an edge operand).  D is the head width of dot (H = F / D).
extern "C" int sddmm_f32(const int* src, const int* dst, const float* lhs,
                         const float* rhs, float* out, int op, int E, int F,
                         int D, cudaStream_t stream) {
  return sddmm<float>(src, dst, lhs, rhs, out, op, E, F, D, stream);
}

// as sddmm_f32 over bf16 lhs and rhs, computing in float32 and writing a
// bf16 out
extern "C" int sddmm_bf16(const int* src, const int* dst, const bf16* lhs,
                          const bf16* rhs, bf16* out, int op, int E, int F,
                          int D, cudaStream_t stream) {
  return sddmm<bf16>(src, dst, lhs, rhs, out, op, E, F, D, stream);
}
