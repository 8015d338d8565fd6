// K4 and K5 over bf16 rows without a weight, on rowwalk.cuh's walk with
// packed bf16 arithmetic: the same functions as segment_max.cu's bf16 entry
// points at w_kind 0 (SAGE-pool's aggregation, NodeFlow max, and min as
// -max(-x)),
//
//   K4  raw[r, f] = max(max_{j in [indptr[r], indptr[r+1])} x[gidx[j], f],
//                       NEG)
//   K5  dx[u, f]  = sum_{j in [csr_indptr[u], csr_indptr[u+1])}
//                       [m == raw[v, f]] * g[v, f],
//       v = dst_csr[j], m = max(x[u, f], NEG) rounded to bf16,
//
// with NEG = -1e30, NaN kept by the max and never hit by the compare, and
// K5's x and dx at Fx <= F columns (the columns x lacks count as zeros).
// Replaces, as segment_max.cu does, the TPU kernels
// dgl_hack_tpu/ops/pallas/spmm_kernel.py _minmax_kernel /
// _minmax_kernel_acc via _block_minmax over packed bf16 tiles (lines
// 616-717, unpacked at 632-634) and the VJP _gspmm_fused_max_bwd (lines
// 1109-1143).
//
// What bounds them on the H100: the gathered rows (x[u] in K4, raw[v] and
// the hit g[v] in K5), from the L2 where a feature slice of the gathered
// array fits there (synthetic Reddit) and from device memory where it does
// not (bench.py's graph), far above the compulsory bytes, and how many of
// them a warp keeps in flight.  segment_max.cu widens each bf16 value to a
// float register on its load, so an edge's 16-byte row piece costs 8
// registers and K5 held 93-128 registers a thread at 16-byte loads (its
// wrapper keeps it at 8 bytes), and every value is compared as a float.
// Here the row pieces stay as loaded, bf16x2 pairs in 32-bit registers:
//
// * Work items, the row plan's pieces, the edge walk (kUnroll edges a lane
//   group in flight), the feature slices, the partial rows and the fix-ups
//   are rowwalk.cuh's, as segment_max.cu uses them: long rows need no
//   atomics, K4 equals its plain version bit for bit and K5 repeats
//   bitwise.  A 16-byte load (8 columns a lane) costs 4 registers.
// * K4 takes the running max of bf16x2 pairs with the max that keeps NaN
//   (__hmax2_nan) and applies the NEG floor once, at the end: an
//   unweighted message is x itself, and max(., NEG) commutes with the max
//   and with the rounding.  Nothing is widened in the loop.
// * K5 holds x[u]'s messages as bf16x2 pairs over the item and compares
//   them with raw[v]'s pairs (__heq2_mask, one instruction a pair: float
//   equality, so +0 ties -0 and a NaN never hits); g[v] is loaded only
//   where some column of the lane hits (about 1% of the (edge, column)
//   pairs at Reddit), and the sums are float32, in a fixed order, rounded
//   once.
//
// On the H100 (80GB HBM3, 700 W; chip_smoke.py, PERF.md) at synthetic
// Reddit (F = 640 in 64-column slices) K4 took 4.13 ms against
// segment_max.cu's 6.89 and K5 10.28 against 17.50 (float32 at the same
// width 8.66 and 18.62); at bench.py's graph K4 1.51 against 1.60 and K5
// 1.17 against 1.77 (float32 1.58).  A ring in shared memory filled with
// cp.async (stage.cuh's, as K2/K3's staged route uses it) was built for
// both and lost to this walk at every shape and ring measured (K4 5.93,
// K5 13.18 ms at Reddit).
#include <cstring>

#include "rowwalk.cuh"

namespace {

struct PackedArgs {
  const int* indptr;   // K4: CSC; K5: CSR
  const int* gidx;     // K4: src per edge; K5: dst in CSR order
  const bf16* x;       // K4: the gathered rows; K5: (N_src, Fx)
  const bf16* g;       // K5: the cotangent (N_dst, F)
  bf16* out;           // K4: raw; K5: dx (num_rows, Fx)
  int num_rows;
  int F;               // columns of the gathered rows (and of K4's raw)
  int Fx;              // K5: columns of x and dx
  int S;               // columns a slice (blockIdx.y)
  int lanes;           // lanes an edge
  RowPlan plan;
};

// max(m, NEG) that keeps a NaN
__device__ __forceinline__ float clamp_neg(float m) {
  return m < kNeg ? kNeg : m;
}

__device__ __forceinline__ __nv_bfloat162 as_b2(unsigned u) {
  __nv_bfloat162 b;
  memcpy(&b, &u, 4);
  return b;
}

__device__ __forceinline__ unsigned as_u(__nv_bfloat162 b) {
  unsigned u;
  memcpy(&u, &b, 4);
  return u;
}

// the NaN-keeping max of two bf16x2 pairs
__device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
  return as_u(__hmax2_nan(as_b2(a), as_b2(b)));
}

// 0xffff in each half where the bf16 values of a and b compare equal as
// floats (+0 == -0; a NaN equals nothing), else 0: one packed compare
__device__ __forceinline__ unsigned eq_mask(unsigned a, unsigned b) {
  return __heq2_mask(as_b2(a), as_b2(b));
}

// K4.  grid of launch_shape.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
max_packed_kernel(PackedArgs a) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  const int64_t Fl = a.F;
  float* prow = it.piece >= 0 ? a.plan.partial + it.piece * Fl : nullptr;
  bf16* orow = a.out + it.row * Fl;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (a.lanes - 1);
  const int grp = lane / a.lanes;
  const int c_lo = blockIdx.y * a.S;
  const int c_hi = min(c_lo + a.S, a.F);
  for (int c0 = c_lo; c0 < c_hi; c0 += a.lanes * V) {   // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    unsigned acc[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) acc[k] = 0xff80ff80u;   // -inf, -inf
    walk_edges<false>(
        it.beg, it.end, a.gidx, nullptr, a.lanes,
        [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
            const bool (&ok)[kUnroll]) {
      unsigned w[kUnroll][V / 2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) w[u][k] = 0xff80ff80u;
        if (ok[u] && active) ldg_words<V, false>(a.x + row[u] * Fl + c, w[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V / 2; ++k) acc[k] = max2(acc[k], w[u][k]);
    });
    for (int off = 16; off >= a.lanes; off >>= 1)     // over the groups
#pragma unroll
      for (int k = 0; k < V / 2; ++k)
        acc[k] = max2(acc[k], __shfl_down_sync(kFull, acc[k], off));
    if (grp == 0 && active) {
      float v[V];
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        unpack2(acc[k], v[2 * k], v[2 * k + 1]);
        v[2 * k] = clamp_neg(v[2 * k]);
        v[2 * k + 1] = clamp_neg(v[2 * k + 1]);
      }
      if (prow != nullptr)                            // warp-uniform
        store<V>(prow + c, v);
      else
        store<V>(orow + c, v);
    }
  }
}

// K5.  VX: values per load of x and per store of dx; raw: the max (N_dst,
// F).  Three blocks an SM is the occupancy its registers allow at 8 values
// a lane (76-80 a thread); saying so lets ptxas keep the kUnroll edges'
// raw and g loads in flight together.  Without the bound it reused their
// registers to save a few, issued half of the loads after the compares of
// the others, and K5 took 14.2 ms at synthetic Reddit against 10.4 with it
// (H100 80GB HBM3, 700 W, a probe kept out of the repository; the same
// registers, no spills either way).  At 2 values a lane the same bound
// cost time (the masked block's K5: 1.68 ms against 1.62 at 5 blocks), and
// 5 blocks spill at 4 values: each width states the occupancy its
// registers allow.
template <int V, int VX>
__global__ void __launch_bounds__(kWarps * 32, V == 8 ? 3 : V == 4 ? 4 : 5)
max_bwd_packed_kernel(PackedArgs a, const bf16* raw) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  const int64_t Fl = a.F;
  const int64_t Fxl = a.Fx;
  float* prow = it.piece >= 0 ? a.plan.partial + it.piece * Fxl : nullptr;
  bf16* orow = a.out + it.row * Fxl;
  const bf16* xrow = a.x + it.row * Fxl;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (a.lanes - 1);
  const int grp = lane / a.lanes;
  const int c_lo = blockIdx.y * a.S;
  const int c_hi = min(c_lo + a.S, a.F);
  for (int c0 = c_lo; c0 < c_hi; c0 += a.lanes * V) {   // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    float xu[V], acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) xu[k] = 0.0f, acc[k] = 0.0f;
    if (active) load_clipped<V, VX, true>(xrow, c, a.Fx, xu);
    unsigned msg[V / 2];                              // the messages
#pragma unroll
    for (int k = 0; k < V / 2; ++k)
      msg[k] = pack2(clamp_neg(xu[2 * k]), clamp_neg(xu[2 * k + 1]));
    walk_edges<false>(
        it.beg, it.end, a.gidx, nullptr, a.lanes,
        [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
            const bool (&ok)[kUnroll]) {
      // raw[v] of every edge in flight, then the hit masks in its place
      unsigned hit[kUnroll][V / 2], gw[kUnroll][V / 2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) hit[u][k] = 0, gw[u][k] = 0;
        if (ok[u] && active)
          ldg_words<V, false>(raw + row[u] * Fl + c, hit[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned any = 0;
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          hit[u][k] = ok[u] && active ? eq_mask(msg[k], hit[u][k]) : 0u;
          any |= hit[u][k];
        }
        if (any) ldg_words<V, true>(a.g + row[u] * Fl + c, gw[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          float lo, hi;
          unpack2(gw[u][k] & hit[u][k], lo, hi);
          acc[2 * k] += lo;
          acc[2 * k + 1] += hi;
        }
    });
    for (int off = 16; off >= a.lanes; off >>= 1)     // fixed-order tree
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += __shfl_down_sync(kFull, acc[k], off);
    if (grp == 0 && active) {
      if (prow != nullptr)                            // warp-uniform
        store_clipped<V, VX>(prow, c, a.Fx, acc);
      else
        store_clipped<V, VX>(orow, c, a.Fx, acc);
    }
  }
}

template <int V, int VX>
void launch_bwd(const LaunchShape& s, const PackedArgs& a, const bf16* raw,
                cudaStream_t stream) {
  max_bwd_packed_kernel<V, VX><<<s.grid, kWarps * 32, 0, stream>>>(a, raw);
}

}  // namespace

// K4 over bf16 x without a weight.  vec: values a lane loads (2, 4 or 8;
// divides F and slice; x and out aligned for it); slice: columns per
// feature slice (F for none); T .. partial: the CSC row plan as
// segment_max_bf16 takes it.
extern "C" int segment_max_bf16_packed(const int* indptr, const int* gidx,
                                       const bf16* x, bf16* out,
                                       int num_rows, int F, int vec,
                                       int slice, int T,
                                       const int* long_rows,
                                       const int* piece_ptr,
                                       const int* pieces,
                                       const int* piece_row, int num_long,
                                       int num_pieces, float* partial,
                                       cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  LaunchShape s;
  if (!launch_shape(num_rows, F, vec, slice, plan, s) || vec < 2 ||
      !aligned(x, vec_bytes<bf16>(vec)) || !aligned(out, vec_bytes<bf16>(vec)))
    return (int)cudaErrorInvalidValue;
  const PackedArgs a{indptr, gidx, x, nullptr, out, num_rows, F, F, s.S,
                     s.lanes, plan};
  if (vec == 8)
    max_packed_kernel<8><<<s.grid, kWarps * 32, 0, stream>>>(a);
  else if (vec == 4)
    max_packed_kernel<4><<<s.grid, kWarps * 32, 0, stream>>>(a);
  else
    max_packed_kernel<2><<<s.grid, kWarps * 32, 0, stream>>>(a);
  launch_fixup<true>(plan, out, F, stream);
  return (int)cudaGetLastError();
}

// K5 over bf16 x, raw, g and dx without a weight.  x and dx have Fx <= F
// columns and move vec_x values at a time (vec_x divides vec and Fx); vec
// as above, for raw and g; partial is (num_pieces, Fx); the CSR row plan.
extern "C" int segment_max_bwd_bf16_packed(
    const int* csr_indptr, const int* dst_csr, const bf16* x,
    const bf16* raw, const bf16* g, bf16* dx, int num_src, int F, int Fx,
    int vec, int vec_x, int slice, int T, const int* long_rows,
    const int* piece_ptr, const int* pieces, const int* piece_row,
    int num_long, int num_pieces, float* partial, cudaStream_t stream) {
  if (num_src <= 0 || F <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  LaunchShape s;
  if (!launch_shape(num_src, F, vec, slice, plan, s) || vec < 2 ||
      !(vec_x == 1 || vec_x == 2 || vec_x == 4 || vec_x == 8) ||
      vec % vec_x != 0 || Fx <= 0 || Fx > F || Fx % vec_x != 0 ||
      !aligned(x, vec_bytes<bf16>(vec_x)) ||
      !aligned(dx, vec_bytes<bf16>(vec_x)) ||
      !aligned(raw, vec_bytes<bf16>(vec)) || !aligned(g, vec_bytes<bf16>(vec)))
    return (int)cudaErrorInvalidValue;
  const PackedArgs a{csr_indptr, dst_csr, x, g, dx, num_src, F, Fx, s.S,
                     s.lanes, plan};
  switch (vec * 16 + vec_x) {
    case 8 * 16 + 8: launch_bwd<8, 8>(s, a, raw, stream); break;
    case 8 * 16 + 4: launch_bwd<8, 4>(s, a, raw, stream); break;
    case 8 * 16 + 2: launch_bwd<8, 2>(s, a, raw, stream); break;
    case 8 * 16 + 1: launch_bwd<8, 1>(s, a, raw, stream); break;
    case 4 * 16 + 4: launch_bwd<4, 4>(s, a, raw, stream); break;
    case 4 * 16 + 2: launch_bwd<4, 2>(s, a, raw, stream); break;
    case 4 * 16 + 1: launch_bwd<4, 1>(s, a, raw, stream); break;
    case 2 * 16 + 2: launch_bwd<2, 2>(s, a, raw, stream); break;
    default:         launch_bwd<2, 1>(s, a, raw, stream); break;
  }
  launch_fixup<false>(plan, dx, Fx, stream);
  return (int)cudaGetLastError();
}
