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
// What bounds it on the H100.  Compulsory traffic is the indices, lhs and
// rhs once each and the output; rhs is read in dst order, so it streams.
// * Where a node operand ('u') fits the 50 MB L2 (DGCNN's point clouds,
//   the transformer's graph), its per-edge gathers hit the L2 and the
//   kernels are bound by the loads each lane keeps in flight, and the
//   elementwise ops by writing out (E x F values).
// * Where it does not (bench.py's 1M rows of 512 B, 512 MB), each edge's
//   lhs row is a DRAM read at a random address: 8.2 GB at F = 128 in
//   float32, more than the dot's whole compulsory traffic and as much as
//   sub's output.  Column slices of lhs sized to stay in the L2 (K1's
//   remedy, spmm_kernel.py:slice_width) lost here in every form measured
//   on an H100 80GB HBM3 at 700 W (PERF.md): a slice of a row of 32 or 64
//   bytes costs an L2 line per edge and writes out in pieces of a sector,
//   and each slice walks the indices again (and a dot its partial sums),
//   so the routes walk every column at once.
// A dot does 2F operations an edge, far below the fp32 rate.
//
// Design:
// * Vector routes (every elementwise op, and every dot off dot4): a lane
//   loads V values at once, 16 bytes where F (D for a dot) and the rows'
//   alignment allow (4 float32, 8 bf16; the wrapper picks V,
//   spmm_kernel.py:vector_width), and a row
//   (a head for a dot) takes a group of L lanes (sddmm_kernel.py:k6_lanes),
//   so a warp works on 32 / L edges or (edge, head) items at a time.  A
//   warp walks tiles of 32 edges, grid-stride, the blocks as many as fit
//   on the card at once: the tile's src and dst come in one coalesced
//   load, a lane each, and are shuffled to the groups, in place of one
//   dependent index load an edge.  Elementwise: a row wider than L V
//   columns goes in passes of L V columns over the tile, the indices kept
//   in registers, and a group keeps its piece of the rhs row in registers,
//   reloading it only where dst changes (the edges are dst-sorted).  Dot:
//   a lane sums its columns of the head (two or more vectors where D
//   allows: more loads in flight a lane, fewer shuffles an item), then a
//   shuffle-xor tree sums the group.  What is read or written once (the
//   indices, rhs, out) is loaded and stored evict-first, so the gathered
//   lhs rows keep the L2.  Below 32 columns at one value a load the first
//   port's lane groups (an edge a group, its indices loaded by each lane)
//   were measured beside this route on an H100 80GB HBM3 at 700 W: at
//   DGCNN's F = 3 in float32 (the point clouds' first EdgeConv) they took
//   1.4-6.6% more time; at the other widths and in bf16, from 15% less to
//   16% more; one route serves them all (PERF.md).
// * dot4: D <= 32 with 4 | D and lhs and rhs aligned for 4 values (the
//   transformer's heads, D = 16): one thread per (edge, head) item, i =
//   e * H + h, consecutive threads on consecutive items.  A thread reads
//   its two D-wide head slices with D / 4 float4 loads each and sums them
//   in a fixed fmaf chain; the H threads of an edge read src[e] and dst[e]
//   in the same warp load (one transaction), and a warp's 32 outputs are
//   one coalesced store.  At the transformer's shape the operands sit in
//   L2 and the cost is issue and latency, not bytes.  D / 4 is a template
//   parameter (1..8), so the chain has no runtime loop.  Every other dot
//   takes the vector route (the first port's lane groups of one value a
//   lane took 1.2-2.7x its time at D = 3 to 32, PERF.md).
// Every sum has a fixed order (a lane's fmaf chain over its columns, then
// a shuffle-xor tree over the group), so every result repeats bitwise; the
// elementwise ops are one IEEE op per element (no fast math), so they equal
// the plain PyTorch version bitwise (in bf16: the float32 op, rounded
// once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kWarps = 8;     // warps per block
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

// a float stored as T (a bf16 store rounds to nearest even)
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

// the two bf16 of a 32-bit word as floats, and two floats rounded into one
__device__ __forceinline__ void unpack2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack2(const float* x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[0])) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[1])) << 16);
}

// a load of an R; CS: read once, so the L2 evicts it first
template <class R, bool CS>
__device__ __forceinline__ R ldr(const void* p) {
  return CS ? __ldcs(reinterpret_cast<const R*>(p))
            : __ldg(reinterpret_cast<const R*>(p));
}
// V consecutive values of T in one load (V * sizeof(T) bytes, aligned to
// that), widened to float
template <int V, bool CS = false>
__device__ __forceinline__ void ldv(const float* p, float* x) {
  if constexpr (V == 4) {
    const float4 t = ldr<float4, CS>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = ldr<float2, CS>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = ldr<float, CS>(p);
  }
}
template <int V, bool CS = false>
__device__ __forceinline__ void ldv(const bf16* p, float* x) {
  if constexpr (V == 8) {
    const uint4 t = ldr<uint4, CS>(p);
    unpack2(t.x, x); unpack2(t.y, x + 2); unpack2(t.z, x + 4);
    unpack2(t.w, x + 6);
  } else if constexpr (V == 4) {
    const uint2 t = ldr<uint2, CS>(p);
    unpack2(t.x, x); unpack2(t.y, x + 2);
  } else if constexpr (V == 2) {
    unpack2(ldr<unsigned, CS>(p), x);
  } else {
    x[0] = __uint_as_float((unsigned)ldr<unsigned short, CS>(p) << 16);
  }
}

// V floats stored as V consecutive values of T in one store, evict-first
// (written once)
template <class R>
__device__ __forceinline__ void str(void* p, R v) {
  __stcs(reinterpret_cast<R*>(p), v);
}
template <int V>
__device__ __forceinline__ void stv(float* p, const float* x) {
  if constexpr (V == 4)
    str(p, make_float4(x[0], x[1], x[2], x[3]));
  else if constexpr (V == 2)
    str(p, make_float2(x[0], x[1]));
  else
    str(p, x[0]);
}
template <int V>
__device__ __forceinline__ void stv(bf16* p, const float* x) {
  if constexpr (V == 8)
    str(p, make_uint4(pack2(x), pack2(x + 2), pack2(x + 4), pack2(x + 6)));
  else if constexpr (V == 4)
    str(p, make_uint2(pack2(x), pack2(x + 2)));
  else if constexpr (V == 2)
    str(p, pack2(x));
  else
    str(p, __bfloat16_as_ushort(__float2bfloat16_rn(x[0])));
}

// The tile's indices, a lane each, read once: dst[e0 + lane] and the lhs
// row of that edge (src[e0 + lane], or the edge itself without src); 0
// past the end.
__device__ __forceinline__ void tile_indices(const int* __restrict__ src,
                                             const int* __restrict__ dst,
                                             int64_t e0, int n, int lane,
                                             int& tu, int& tv) {
  const bool mine = lane < n;
  tv = mine ? __ldcs(dst + e0 + lane) : 0;
  tu = src == nullptr ? (int)(e0 + lane)
                      : (mine ? __ldcs(src + e0 + lane) : 0);
}

// Elementwise ops on the vector route: groups of L lanes, V values a lane,
// in passes of L V columns; see the design note.  The tile's edge j (k-th
// of its group) is j = k * G + grp: the G groups take neighbouring edges.
template <class T, int OP, int V>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_elem_vec_kernel(const int* __restrict__ src,
                      const int* __restrict__ dst,
                      const T* __restrict__ lhs, const T* __restrict__ rhs,
                      T* __restrict__ out, int E, int F, int L) {
  const int lane = threadIdx.x & 31;
  const int G = 32 / L, grp = lane / L, sub = lane - grp * L;
  const int64_t Fl = F;
  const int64_t tiles = ((int64_t)E + 31) / 32;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += step) {                          // warp-uniform
    const int64_t e0 = t * 32;
    const int n = (int)(E - e0 < 32 ? E - e0 : 32);
    int tu, tv;
    tile_indices(OP == kCopyRhs ? nullptr : src, dst, e0, n, lane, tu, tv);
    for (int pc = 0; pc < F; pc += L * V) {             // warp-uniform
      const int c = pc + sub * V;
      const bool on = c < F;
      int cur = -1;                 // the dst row whose piece r holds
      float r[V];
      for (int k = 0; k < L; ++k) {                     // warp-uniform
        const int j = k * G + grp;
        const int v = __shfl_sync(kFull, tv, j);
        const int row = __shfl_sync(kFull, tu, j);
        if (j >= n || !on) continue;
        float l[V], o[V];
        if (OP != kCopyRhs) ldv<V>(lhs + (int64_t)row * Fl + c, l);
        if (v != cur) {             // a new dst row: its piece, read once
          cur = v;
          ldv<V, true>(rhs + (int64_t)v * Fl + c, r);
        }
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] = combine<OP>(OP != kCopyRhs ? l[i] : 0.0f, r[i]);
        stv<V>(out + (e0 + j) * Fl + c, o);
      }
    }
  }
}

// dot off the dot4 route: groups of L lanes, V values a lane, an (edge,
// head) item a group; see the design note.  The tile's item j = el * H + h
// is the k-th of its group for j = k * G + grp.
template <class T, int V>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_dot_lanes_kernel(const int* __restrict__ src,
                       const int* __restrict__ dst,
                       const T* __restrict__ lhs, const T* __restrict__ rhs,
                       T* __restrict__ out, int E, int H, int D, int L) {
  const int lane = threadIdx.x & 31;
  const int G = 32 / L, grp = lane / L, sub = lane - grp * L;
  const int64_t F = (int64_t)H * D;
  const int64_t tiles = ((int64_t)E + 31) / 32;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  const int per = L * H;            // items a group, a tile
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += step) {                          // warp-uniform
    const int64_t e0 = t * 32;
    const int n = (int)(E - e0 < 32 ? E - e0 : 32);
    int tu, tv;
    tile_indices(src, dst, e0, n, lane, tu, tv);
    for (int k = 0; k < per; ++k) {                     // warp-uniform
      const int j = k * G + grp;
      const int el = j / H;
      const int h = j - el * H;
      const int row = __shfl_sync(kFull, tu, el);
      const int v = __shfl_sync(kFull, tv, el);
      const bool ok = el < n;
      float p = 0.0f;
      if (ok) {
        const int64_t col = (int64_t)h * D;
        const T* lr = lhs + (int64_t)row * F + col;
        const T* rr = rhs + (int64_t)v * F + col;
        for (int c = sub * V; c < D; c += L * V) {
          float a[V], b[V];
          ldv<V>(lr + c, a);
          ldv<V, true>(rr + c, b);
#pragma unroll
          for (int i = 0; i < V; ++i) p = fmaf(a[i], b[i], p);
        }
      }
      for (int o = L >> 1; o > 0; o >>= 1)
        p += __shfl_xor_sync(kFull, p, o);
      if (ok && sub == 0) st(out + (e0 + el) * H + h, p);
    }
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

// Blocks of a grid-stride launch of ``kernel`` over ``tiles`` warp tiles:
// as many as fit on the card at once, and no more than the tiles need.
// ``fit`` caches the first by device (an array of 64, one per kernel).
template <class K>
unsigned grid_blocks(K kernel, int* fit, int64_t tiles) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& f = fit[dev & 63];
  if (f == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWarps * 32, 0);
    f = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t want = (tiles + kWarps - 1) / kWarps;
  return (unsigned)(want < f ? want : f);
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

// the elementwise op OP over every edge, V values and L lanes a row
template <class T, int OP, int V>
int launch_elem(const int* src, const int* dst, const T* lhs, const T* rhs,
                T* out, int E, int F, int L, cudaStream_t stream) {
  static int fit[64] = {};
  sddmm_elem_vec_kernel<T, OP, V><<<
      grid_blocks(sddmm_elem_vec_kernel<T, OP, V>, fit,
                  ((int64_t)E + 31) / 32),
      kWarps * 32, 0, stream>>>(src, dst, lhs, rhs, out, E, F, L);
  return (int)cudaGetLastError();
}

// dot on the vector route, V values and L lanes a head
template <class T, int V>
int launch_dot_lanes(const int* src, const int* dst, const T* lhs,
                     const T* rhs, T* out, int E, int H, int D, int L,
                     cudaStream_t stream) {
  static int fit[64] = {};
  sddmm_dot_lanes_kernel<T, V><<<
      grid_blocks(sddmm_dot_lanes_kernel<T, V>, fit, ((int64_t)E + 31) / 32),
      kWarps * 32, 0, stream>>>(src, dst, lhs, rhs, out, E, H, D, L);
  return (int)cudaGetLastError();
}

// the largest V a 16-byte load of T holds
template <class T>
constexpr int max_vec() { return 16 / (int)sizeof(T); }

template <class T, int OP>
int elem_by_vec(const int* src, const int* dst, const T* lhs, const T* rhs,
                T* out, int E, int F, int vec, int L, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch_elem<T, OP, 1>(src, dst, lhs, rhs, out, E, F, L, stream);
    case 2:
      return launch_elem<T, OP, 2>(src, dst, lhs, rhs, out, E, F, L, stream);
    case 4:
      return launch_elem<T, OP, 4>(src, dst, lhs, rhs, out, E, F, L, stream);
    case 8:
      if constexpr (max_vec<T>() >= 8)
        return launch_elem<T, OP, 8>(src, dst, lhs, rhs, out, E, F, L,
                                     stream);
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int dot_lanes_by_vec(const int* src, const int* dst, const T* lhs,
                     const T* rhs, T* out, int E, int H, int D, int vec,
                     int L, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch_dot_lanes<T, 1>(src, dst, lhs, rhs, out, E, H, D, L,
                                    stream);
    case 2:
      return launch_dot_lanes<T, 2>(src, dst, lhs, rhs, out, E, H, D, L,
                                    stream);
    case 4:
      return launch_dot_lanes<T, 4>(src, dst, lhs, rhs, out, E, H, D, L,
                                    stream);
    case 8:
      if constexpr (max_vec<T>() >= 8)
        return launch_dot_lanes<T, 8>(src, dst, lhs, rhs, out, E, H, D, L,
                                      stream);
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// whether p is aligned for loads of ``vec`` values of T
template <class T>
bool aligned(const void* p, int vec) {
  return (uintptr_t)p % ((uintptr_t)vec * sizeof(T)) == 0;
}

template <class T>
int sddmm(const int* src, const int* dst, const T* lhs, const T* rhs, T* out,
          int op, int E, int F, int D, int vec, int lanes,
          cudaStream_t stream) {
  if (E <= 0 || F <= 0) return (int)cudaGetLastError();
  // lanes: a power of two up to 32 (0: dot4)
  if (lanes < 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (lanes == 0 && op != kDot))
    return (int)cudaErrorInvalidValue;
  if (lanes > 0) {   // the vector routes, V values a load
    const int W = op == kDot ? D : F;
    if (vec < 1 || vec > max_vec<T>() || W <= 0 || W % vec != 0 ||
        !aligned<T>(rhs, vec) ||
        (op != kCopyRhs && !aligned<T>(lhs, vec)) ||
        (op != kDot && !aligned<T>(out, vec)))
      return (int)cudaErrorInvalidValue;
  }
  switch (op) {
    case kCopyRhs:
      return elem_by_vec<T, kCopyRhs>(src, dst, lhs, rhs, out, E, F, vec,
                                      lanes, stream);
    case kAdd:
      return elem_by_vec<T, kAdd>(src, dst, lhs, rhs, out, E, F, vec, lanes,
                                  stream);
    case kSub:
      return elem_by_vec<T, kSub>(src, dst, lhs, rhs, out, E, F, vec, lanes,
                                  stream);
    case kMul:
      return elem_by_vec<T, kMul>(src, dst, lhs, rhs, out, E, F, vec, lanes,
                                  stream);
    case kDiv:
      return elem_by_vec<T, kDiv>(src, dst, lhs, rhs, out, E, F, vec, lanes,
                                  stream);
    case kDot: {
      if (D <= 0 || F % D != 0) return (int)cudaErrorInvalidValue;
      const int H = F / D;
      if (lanes > 0)
        return dot_lanes_by_vec<T>(src, dst, lhs, rhs, out, E, H, D, vec,
                                   lanes, stream);
      // dot4: D a multiple of 4 up to 32, rows aligned for 4 values
      const int64_t items = (int64_t)E * H;
      if (D % 4 != 0 || D > 32 || items > UINT32_MAX ||
          !aligned<T>(lhs, 4) || !aligned<T>(rhs, 4))
        return (int)cudaErrorInvalidValue;
      using Launch = void (*)(const int*, const int*, const T*, const T*, T*,
                              uint32_t, uint32_t, cudaStream_t);
      static const Launch by_d4[8] = {
          launch_dot_vec<T, 1>, launch_dot_vec<T, 2>, launch_dot_vec<T, 3>,
          launch_dot_vec<T, 4>, launch_dot_vec<T, 5>, launch_dot_vec<T, 6>,
          launch_dot_vec<T, 7>, launch_dot_vec<T, 8>};
      by_d4[D / 4 - 1](src, dst, lhs, rhs, out, (uint32_t)items,
                       (uint32_t)H, stream);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// op: 0 copy_rhs, 1 add, 2 sub, 3 mul, 4 div, 5 dot.  src == NULL reads
// lhs row e (an edge operand).  D is the head width of dot (H = F / D).
// vec: values a lane loads (1, 2 or 4 here); lanes: lanes a row (a head for
// dot) on the vector routes, or 0 for dot4.  The wrapper picks both
// (sddmm_kernel.py:k6_widths); what the kernels cannot run returns
// cudaErrorInvalidValue.
extern "C" int sddmm_f32(const int* src, const int* dst, const float* lhs,
                         const float* rhs, float* out, int op, int E, int F,
                         int D, int vec, int lanes, cudaStream_t stream) {
  return sddmm<float>(src, dst, lhs, rhs, out, op, E, F, D, vec, lanes,
                      stream);
}

// as sddmm_f32 over bf16 lhs and rhs, computing in float32 and writing a
// bf16 out (vec up to 8)
extern "C" int sddmm_bf16(const int* src, const int* dst, const bf16* lhs,
                          const bf16* rhs, bf16* out, int op, int E, int F,
                          int D, int vec, int lanes, cudaStream_t stream) {
  return sddmm<bf16>(src, dst, lhs, rhs, out, op, E, F, D, vec, lanes,
                     stream);
}
