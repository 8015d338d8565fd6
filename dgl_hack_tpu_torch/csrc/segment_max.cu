// K4: segment max over the CSC direction, and K5: its argmax backward,
// fused, over the CSR direction (float32 or bf16 rows).
//
//   K4  raw[r, f] = max_{j in [indptr[r], indptr[r+1])}
//                       max(x[gidx[j], f] * w(j, f), NEG)
//   K5  dx[u, f]  = sum_{j in [csr_indptr[u], csr_indptr[u+1])}
//                       [m == raw[v, f]] * g[v, f] * w(e, f)
//       dw[e]     = sum_f [m == raw[v, f]] * x[u, f] * g[v, f]   (w_kind 1)
//       dw[e, f]  =       [m == raw[v, f]] * x[u, f] * g[v, f]   (w_kind 2)
//   with v = dst_csr[j], e = csr_eids[j], m = max(x[u, f] * w(e, f), NEG).
//   K5's x and dx may have fewer columns than raw and g (Fx <= F): the
//   columns they lack count as zeros of x and are not written to dx.
//
// NEG = -1e30 (MINMAX_NEG of the JAX package); an empty row's raw is NEG and
// the caller zero-fills raw <= NEG / 2.  w_kind: 0 none, 1 scalar per edge
// (E,), 2 full (E, F); K4's edge id is j itself (CSC order is the internal
// edge order).  dw == NULL skips the weight gradient.  min is the caller's
// -max(-x).  A NaN message makes its row's raw NaN and passes no gradient.
//
// Replaces the TPU kernels dgl_hack_tpu/ops/pallas/spmm_kernel.py
// _minmax_kernel / _minmax_kernel_acc via _block_minmax (lines 616-717),
// launched by _reduce_call / _reduce_call_acc with combine="max", and the
// backward _gspmm_fused_max_bwd (lines 1109-1143).  The TPU needed a
// segmented shift-scan and an exact one-hot MXU select to take a max; on
// the H100 a warp that owns a row compares directly.
//
// Why K5 is fused: the JAX backward builds the messages x[src] and the
// argmax mask as two (E, F) float32 arrays and reduces mask * g with the
// sum kernel.  At GraphSAGE-pool layer 0 on Reddit (E = 23.5 M, F = 602)
// each is 56.6 GB, so the two do not fit in the H100's 80 GB.  K5 recomputes
// the message and compares it with the saved raw max inside the reverse
// walk, so no (E, F) array exists.  The compare is float equality, as in
// the JAX VJP: every tied edge receives the full cotangent.  The message is
// one rounded multiply in K4 and in K5 (__fmul_rn, never contracted into an
// fma), so K5 sees the bits K4 wrote.
//
// Bound on the H100: bytes, and the gathered rows rather than the
// compulsory ones.  Compulsory traffic at Reddit F = 602 is x, raw and the
// indices, about 1.2 GB (0.36 ms at 3.35 TB/s), but K4 reads one x row per
// edge and K5 one raw row per edge, 56.6 GB each when no row hits L2
// (~17 ms), and K5 the g rows of the edges that hit the max on top; x[u]
// and dx[u] stream.  The operations (one compare per edge and feature in
// K4, a compare and an add in K5) sit far below the fp32 rate.
//
// Design: rowwalk.cuh's, shared with K1.
// * Work items from the row plan: K4 takes the CSC direction's, K5 the
//   CSR direction's.  A warp owns a row of at most T edges or one piece of
//   a longer row; a piece writes its partial max (K4) or partial dx (K5)
//   row to scratch, and the fix-up takes the max over a long row's
//   partials, or adds them in piece order.  No atomics: K4 equals its
//   plain version bit for bit (a max is exact in any order) and K5 repeats
//   bitwise.
// * Loads in flight: the edge walk hands each lane group kUnroll edges at
//   a time, with 16-, 8- or 4-byte loads.  K5 starts the raw[v] loads of
//   all the edges in flight first, compares, and then starts the g[v]
//   loads of the lanes that hit together, so a batch of edges costs two
//   dependent round trips.  x[u] stays in registers across the item; the
//   edge ids are loaded only when there is a weight.  x[u] and g[v] are
//   read with streaming loads, which L2 evicts first, so that they do not
//   push out the raw slice (K5 at Reddit F = 608: 17.5 -> 16.1 ms; the
//   g loads alone cost 6.4 ms, about one 16-byte load per (v, f) pair).
// * Feature slices: the gathered array (x in K4, raw in K5) is read one
//   slice of columns per pass of the grid, so that the slice stays in L2
//   (rule: spmm_kernel.py:slice_width).
//   A slice costs one 128-byte L2 line per edge where the rows are
//   line-aligned and two where they are not, so GspmmMax runs these
//   kernels over copies of a sliced x and of the cotangent padded to a
//   multiple of 32 columns (spmm_kernel.py:run_width), at F = 608 for
//   Reddit's 602 (K4 16.6 -> 7.9 ms, K5 25.7 -> 17.7, on an H100 80GB HBM3
//   at 700 W).  Only what is gathered needs it: K5 takes x[u] and writes
//   dx[u], which stream, at their own width and load width (Fx, VX), so
//   the backward makes no padded copy of x and none of dx.
// * dw for an (E,) weight sums over all columns of an edge.  Under slices
//   several blocks would add to one dw[e], so the wrapper runs that case
//   (w_kind 1 with dw) unsliced, and the entry refuses it otherwise: the
//   warp that owns edge e then adds its column passes into dw[e] in order.
//   (E, F) weights write disjoint columns per slice.  Neither weighted
//   form is on a main path; they are right and repeatable, not tuned.
// * bf16 (the JAX package's packed path, spmm_kernel.py:632-634): x, raw,
//   g and dx are of one type T, float32 or bf16; the weight and dw are
//   float32.  Both take 16-byte loads of 8 bf16 columns; K5's hold 93-128
//   registers a thread and ran slower on the H100, so its wrapper loads at
//   most 4 (spmm_kernel.py:SUM_MAX_VALUES).  A message is rounded to T
//   (the float product of a bf16 x and an f32 weight is not bf16-exact),
//   so K4's raw holds bf16-exact values and K5 compares the same rounded
//   message with them in float: it sees the bits K4 wrote.  Unweighted,
//   the message is x itself and the max of bf16 values is exact.  Weighted, the JAX VJP compares the unrounded
//   f32 message with an f32 raw, so a tie that only the rounding makes
//   (two products that round to one bf16 value) passes the cotangent here
//   and not there; the forward is the same (rounding is monotone).
// Left for later: K5's g loads (a third of its time); a slice-major copy
// in place of the padded one.
#include "rowwalk.cuh"

namespace {

template <class T>
struct Args {
  const int* indptr;   // K4: CSC; K5: CSR
  const int* gidx;     // K4: src per edge; K5: dst in CSR order
  const int* eid;      // K5: csr_eids (K4's edge id is j)
  const T* x;
  const float* w;
  const T* raw;        // K5
  const T* g;          // K5
  T* out;              // K4: raw; K5: dx
  float* dw;           // K5, or NULL
  int num_rows;
  int F;               // columns of every array but K5's x and dx
  int Fx;              // K5: columns of x and dx, <= F
  RowPlan plan;
};

// max(m, NEG) that keeps a NaN message
__device__ __forceinline__ float clamp_neg(float m) {
  return m < kNeg ? kNeg : m;
}

// the message of one edge and feature, rounded to T; W: the weight kind
template <int W, class T>
__device__ __forceinline__ float message(float x, float w) {
  return round_to<T>(clamp_neg(W ? __fmul_rn(x, w) : x));
}

// grid of launch_shape.  S: the slice's width in columns, a multiple of
// V; lanes: lanes per edge, a power of two <= 32.
template <int V, int W, class T>
__global__ void __launch_bounds__(kWarps * 32)
segment_max_kernel(Args<T> a, int S, int lanes) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  const int64_t Fl = a.F;
  float* prow = it.piece >= 0 ? a.plan.partial + it.piece * Fl : nullptr;
  T* orow = a.out + it.row * Fl;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int grp = lane / lanes;
  const int c_lo = blockIdx.y * S;
  const int c_hi = min(c_lo + S, a.F);
  for (int c0 = c_lo; c0 < c_hi; c0 += lanes * V) {   // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = kNeg;
    walk_edges<W != 0>(
        it.beg, it.end, a.gidx, nullptr, lanes,
        [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
            const bool (&ok)[kUnroll]) {
      float xv[kUnroll][V], wv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // an edge past the end counts as a message of NEG
#pragma unroll
        for (int k = 0; k < V; ++k) xv[u][k] = kNeg, wv[u][k] = 1.0f;
        if (ok[u] && active) {
          load<V>(a.x + row[u] * Fl + c, xv[u]);
          load_weight<V, W>(a.w, e[u], Fl, c, wv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = max_nan(acc[k], message<W, T>(xv[u][k], wv[u][k]));
    });
    // tree over the groups (lanes of equal sub)
    for (int off = 16; off >= lanes; off >>= 1)
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = max_nan(acc[k], __shfl_down_sync(kFull, acc[k], off));
    if (grp == 0 && active) {
      if (prow != nullptr)                            // warp-uniform
        store<V>(prow + c, acc);
      else
        store<V>(orow + c, acc);
    }
  }
}

// VX: values per load of x and per store of dx (and of the partial dx
// rows, which have dx's width).
template <int V, int VX, int W, class T>
__global__ void __launch_bounds__(kWarps * 32)
segment_max_bwd_kernel(Args<T> a, int S, int lanes) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  const int64_t Fl = a.F;
  const int64_t Fxl = a.Fx;
  float* prow = it.piece >= 0 ? a.plan.partial + it.piece * Fxl : nullptr;
  T* orow = a.out + it.row * Fxl;
  const T* xrow = a.x + it.row * Fxl;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int grp = lane / lanes;
  const int c_lo = blockIdx.y * S;
  const int c_hi = min(c_lo + S, a.F);
  for (int c0 = c_lo; c0 < c_hi; c0 += lanes * V) {   // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    float xu[V], acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) xu[k] = 0.0f, acc[k] = 0.0f;
    if (active) load_clipped<V, VX, true>(xrow, c, a.Fx, xu);
    walk_edges<W != 0>(
        it.beg, it.end, a.gidx, a.eid, lanes,
        [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
            const bool (&ok)[kUnroll]) {
      float rv[kUnroll][V], wv[kUnroll][V], gv[kUnroll][V];
      // first round trip: raw[v] (and the weight) of every edge in flight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) rv[u][k] = 0.0f, wv[u][k] = 1.0f;
        if (ok[u] && active) {
          load<V>(a.raw + row[u] * Fl + c, rv[u]);
          load_weight<V, W>(a.w, e[u], Fl, c, wv[u]);
        }
      }
      // second: g[v] where some feature of the lane hit the max
      unsigned hit[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        hit[u] = 0;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          gv[u][k] = 0.0f;
          if (ok[u] && active && message<W, T>(xu[k], wv[u][k]) == rv[u][k])
            hit[u] |= 1u << k;
        }
        if (hit[u]) load<V, true>(a.g + row[u] * Fl + c, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gk = (hit[u] >> k & 1u) ? gv[u][k] : 0.0f;
          acc[k] = W ? fmaf(gk, wv[u][k], acc[k]) : acc[k] + gk;
          gv[u][k] = xu[k] * gk;          // the edge's dw term
        }
      if (W != 0 && a.dw != nullptr) {    // warp-uniform
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if constexpr (W == 2) {
            if (ok[u] && active) store<V>(a.dw + e[u] * Fl + c, gv[u]);
          } else {
            float d = 0.0f;
#pragma unroll
            for (int k = 0; k < V; ++k) d += gv[u][k];
            for (int off = lanes >> 1; off >= 1; off >>= 1)
              d += __shfl_xor_sync(kFull, d, off);
            // this lane owns edge e in every column pass of the item (one
            // slice: see the header), so it adds to its own earlier write
            if (sub == 0 && ok[u])
              a.dw[e[u]] = (c0 == 0 ? 0.0f : a.dw[e[u]]) + d;
          }
        }
      }
    });
    // fixed-order tree over the groups (lanes of equal sub)
    for (int off = 16; off >= lanes; off >>= 1)
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

struct MaxLaunch {
  template <int V, int W, class T>
  static void go(const Args<T>& a, const LaunchShape& s,
                 cudaStream_t stream) {
    segment_max_kernel<V, W><<<s.grid, kWarps * 32, 0, stream>>>(
        a, s.S, s.lanes);
  }
};

template <int V, int VX, class T>
void launch_bwd(const Args<T>& a, int w_kind, const LaunchShape& s,
                cudaStream_t stream) {
  const int threads = kWarps * 32;
  if (w_kind == 0)
    segment_max_bwd_kernel<V, VX, 0><<<s.grid, threads, 0, stream>>>(
        a, s.S, s.lanes);
  else if (w_kind == 1)
    segment_max_bwd_kernel<V, VX, 1><<<s.grid, threads, 0, stream>>>(
        a, s.S, s.lanes);
  else
    segment_max_bwd_kernel<V, VX, 2><<<s.grid, threads, 0, stream>>>(
        a, s.S, s.lanes);
}

template <class T>
int run_fwd(const int* indptr, const int* gidx, const T* x, const float* w,
            int w_kind, T* out, int num_rows, int F, int vec, int slice,
            const RowPlan& plan, cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  LaunchShape s;
  if (!launch_shape(num_rows, F, vec, slice, plan, s) ||
      vec_bytes<T>(vec) < (int)sizeof(T) * vec ||       // 8 floats: no
      !aligned(x, vec_bytes<T>(vec)) || !aligned(out, vec_bytes<T>(vec)) ||
      bad_weight(w, w_kind, vec))
    return (int)cudaErrorInvalidValue;
  const Args<T> a{indptr, gidx, nullptr, x, w, nullptr, nullptr, out,
                  nullptr, num_rows, F, F, plan};
  rowwalk_launch<MaxLaunch, sizeof(T) == 2>(vec, w_kind, a, s, stream);
  launch_fixup<true>(plan, out, F, stream);
  return (int)cudaGetLastError();
}

template <class T>
int run_bwd(const int* csr_indptr, const int* dst_csr, const int* csr_eids,
            const T* x, const float* w, int w_kind, const T* raw, const T* g,
            T* dx, float* dw, int num_src, int F, int Fx, int vec, int vec_x,
            int slice, const RowPlan& plan, cudaStream_t stream) {
  if (num_src <= 0 || F <= 0) return (int)cudaGetLastError();
  const int vb = vec_bytes<T>(vec);
  LaunchShape s;
  if (!launch_shape(num_src, F, vec, slice, plan, s) ||
      vb < (int)sizeof(T) * vec ||
      !(vec_x == 1 || vec_x == 2 || vec_x == 4 || vec_x == 8) ||
      vec % vec_x != 0 || Fx <= 0 || Fx > F || Fx % vec_x != 0 ||
      (w_kind == 2 && Fx != F) ||
      !aligned(x, vec_bytes<T>(vec_x)) || !aligned(dx, vec_bytes<T>(vec_x)) ||
      !aligned(raw, vb) || !aligned(g, vb) ||
      bad_weight(w, w_kind, vec) ||
      (w_kind == 2 && !aligned(dw, vec_bytes<float>(vec))) ||
      (w_kind == 1 && dw != nullptr && s.S < F) ||
      (w_kind != 0 && csr_eids == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<T> a{csr_indptr, dst_csr, csr_eids, x, w, raw, g, dx, dw,
                  num_src, F, Fx, plan};
  switch (vec * 16 + vec_x) {
    case 8 * 16 + 8:
      if constexpr (sizeof(T) == 2) launch_bwd<8, 8>(a, w_kind, s, stream);
      break;
    case 8 * 16 + 4:
      if constexpr (sizeof(T) == 2) launch_bwd<8, 4>(a, w_kind, s, stream);
      break;
    case 8 * 16 + 2:
      if constexpr (sizeof(T) == 2) launch_bwd<8, 2>(a, w_kind, s, stream);
      break;
    case 8 * 16 + 1:
      if constexpr (sizeof(T) == 2) launch_bwd<8, 1>(a, w_kind, s, stream);
      break;
    case 4 * 16 + 4: launch_bwd<4, 4>(a, w_kind, s, stream); break;
    case 4 * 16 + 2: launch_bwd<4, 2>(a, w_kind, s, stream); break;
    case 4 * 16 + 1: launch_bwd<4, 1>(a, w_kind, s, stream); break;
    case 2 * 16 + 2: launch_bwd<2, 2>(a, w_kind, s, stream); break;
    case 2 * 16 + 1: launch_bwd<2, 1>(a, w_kind, s, stream); break;
    default:         launch_bwd<1, 1>(a, w_kind, s, stream); break;
  }
  launch_fixup<false>(plan, dx, Fx, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: values per load (1, 2, 4, and 8 for bf16; the wrapper's choice,
// checked here; the wrapper gives K5 at most 4:
// spmm_kernel.py:SUM_MAX_VALUES); slice:
// columns per feature slice (a multiple of vec; F for none); T,
// long_rows, piece_ptr, pieces, piece_row, num_long, num_pieces: the plan
// of spmm_kernel.py:row_plan for indptr; partial: (num_pieces, F) float32
// scratch.
extern "C" int segment_max_f32(const int* indptr, const int* gidx,
                               const float* x, const float* w, int w_kind,
                               float* out, int num_rows, int F, int vec,
                               int slice, int T, const int* long_rows,
                               const int* piece_ptr, const int* pieces,
                               const int* piece_row, int num_long,
                               int num_pieces, float* partial,
                               cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  return run_fwd(indptr, gidx, x, w, w_kind, out, num_rows, F, vec, slice,
                 plan, stream);
}

// As above over bf16 x; raw is bf16.
extern "C" int segment_max_bf16(const int* indptr, const int* gidx,
                                const bf16* x, const float* w, int w_kind,
                                bf16* out, int num_rows, int F, int vec,
                                int slice, int T, const int* long_rows,
                                const int* piece_ptr, const int* pieces,
                                const int* piece_row, int num_long,
                                int num_pieces, float* partial,
                                cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  return run_fwd(indptr, gidx, x, w, w_kind, out, num_rows, F, vec, slice,
                 plan, stream);
}

// As above, over the CSR direction; the plan is csr_indptr's.  x and dx
// have Fx <= F columns (Fx == F under an (E, F) weight) and move vec_x
// values at a time (vec_x divides vec and Fx); partial is (num_pieces, Fx).
// With an (E,) weight and dw, slice must be F or more.  dw is float32.
extern "C" int segment_max_bwd_f32(const int* csr_indptr, const int* dst_csr,
                                   const int* csr_eids, const float* x,
                                   const float* w, int w_kind,
                                   const float* raw, const float* g,
                                   float* dx, float* dw, int num_src, int F,
                                   int Fx, int vec, int vec_x, int slice,
                                   int T, const int* long_rows,
                                   const int* piece_ptr, const int* pieces,
                                   const int* piece_row, int num_long,
                                   int num_pieces, float* partial,
                                   cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  return run_bwd(csr_indptr, dst_csr, csr_eids, x, w, w_kind, raw, g, dx, dw,
                 num_src, F, Fx, vec, vec_x, slice, plan, stream);
}

// As above over bf16 x, raw, g and dx.
extern "C" int segment_max_bwd_bf16(const int* csr_indptr,
                                    const int* dst_csr, const int* csr_eids,
                                    const bf16* x, const float* w,
                                    int w_kind, const bf16* raw,
                                    const bf16* g, bf16* dx, float* dw,
                                    int num_src, int F, int Fx, int vec,
                                    int vec_x, int slice, int T,
                                    const int* long_rows,
                                    const int* piece_ptr, const int* pieces,
                                    const int* piece_row, int num_long,
                                    int num_pieces, float* partial,
                                    cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  return run_bwd(csr_indptr, dst_csr, csr_eids, x, w, w_kind, raw, g, dx, dw,
                 num_src, F, Fx, vec, vec_x, slice, plan, stream);
}
