// K1: sorted-segment sum over a CSR-style index (float32 or bf16 rows).
//
//   out[r, f] = sum_{j in [indptr[r], indptr[r+1])} x[gidx[j], f] * w(eid[j], f)
//
// gidx == NULL reads x row j itself (edge-row mode: x holds one row per
// edge, e.g. the GAT backward's per-edge logit gradient); eid == NULL means
// eid[j] = j.  w_kind: 0 none, 1 scalar per edge (E,), 2 full (E, F).
// Empty rows give 0.  One kernel serves three call sites: the gspmm
// forward (CSC indptr, gidx = src), its dx (CSR indptr, gidx = dst in CSR
// order, eid = csr_eids) and the GAT der (CSC indptr, edge-row mode).
//
// Replaces the TPU kernel dgl_hack_tpu/ops/pallas/spmm_kernel.py
// _reduce_kernel / _reduce_kernel_acc (via _block_contrib), launched by
// _reduce_call / _reduce_call_acc.  The TPU needed a host-side block plan
// and one-hot MXU matmuls because its scatter and gather are slow; on the
// H100 the graph's own CSC/CSR arrays are the plan, plus a small list of
// the rows too long for one warp.
//
// Bound on the H100: bytes.  Per edge it reads one index (4 B, plus 4 B of
// eid and 4 or 4F B of weight when weighted) and one x row (4F B, a random
// row: L2 hits only where x, or the part of it being read, fits in the
// 50 MB L2); per row it writes 4F B.  No FLOP limit is anywhere near.
// Short of that bound, what costs time is how the work is spread and how
// many loads a warp keeps in flight: a warp that walks a whole row, edge
// after dependent edge, leaves a hub row of 10^5 edges running alone for
// most of the call, and 4 B loads need many more instructions per byte.
//
// Design: rowwalk.cuh's, which K4 and K5 share: work items from the row
// plan (long rows cut into pieces, their partial sums added in piece order
// by the fix-up), 16-, 8- or 4-byte loads, the edge walk with indices
// loaded 32 at a time a chunk ahead, and feature slices that stay in L2
// (rule in spmm_kernel.py:slice_width).  A fixed shuffle tree sums the
// lane groups.
//
// bf16 (the JAX package's packed path, spmm_kernel.py:720-735, 916-925):
// x may be bf16, widened to float on the load and summed in float; the
// result is stored once, rounded to nearest even, as x's dtype, or as
// float32 where the caller asks (the hybrid's dx adds its dense part in
// float before it rounds).  The weight is float32.  bf16 halves the
// gathered rows' bytes, which bound K1.  The kernel takes 16-byte loads of
// 8 bf16 columns, but they hold 70 registers a thread against 48 at 4 and
// ran slower on the H100, so the wrapper loads at most 4
// (spmm_kernel.py:SUM_MAX_VALUES).
//
// The dense-hub hybrid (spmm_kernel.py:gspmm_hybrid) runs K1 over the
// graph's sparse remainder.  On the H100 (PERF.md) it beat K1 alone at
// bench.py's shape with its one hub window dense (9.5M of 16M edges) and
// lost with the 18 windows of bench.py's own threshold; prepare_spmm's
// default, from the card's measured rates, picks the one.
// Left for later: staging a piece's indices in shared memory.
#include "rowwalk.cuh"

namespace {

template <class T, class TO>
struct Args {
  const int* indptr;
  const int* gidx;
  const int* eid;
  const T* x;
  const float* w;
  TO* out;
  int num_rows;
  int F;
  RowPlan plan;
};

// grid of launch_shape.  S: the slice's width in columns, a multiple of
// V; lanes: lanes per edge, a power of two <= 32; W: the weight kind.
template <int V, int W, class T, class TO>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(Args<T, TO> a, int S, int lanes) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  const int64_t Fl = a.F;
  float* prow = it.piece >= 0 ? a.plan.partial + it.piece * Fl : nullptr;
  TO* orow = a.out + it.row * Fl;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int grp = lane / lanes;
  const int c_lo = blockIdx.y * S;
  const int c_hi = min(c_lo + S, a.F);
  // one pass when S <= lanes * V, the rule for every sliced width
  for (int c0 = c_lo; c0 < c_hi; c0 += lanes * V) {   // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    walk_edges<W != 0>(
        it.beg, it.end, a.gidx, a.eid, lanes,
        [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
            const bool (&ok)[kUnroll]) {
      float xv[kUnroll][V], wv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) xv[u][k] = 0.0f, wv[u][k] = 1.0f;
        if (ok[u] && active) {
          load<V>(a.x + row[u] * Fl + c, xv[u]);
          load_weight<V, W>(a.w, e[u], Fl, c, wv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = W ? fmaf(xv[u][k], wv[u][k], acc[k]) : acc[k] + xv[u][k];
    });
    // fixed-order tree over the groups (lanes of equal sub)
    for (int off = 16; off >= lanes; off >>= 1)
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += __shfl_down_sync(kFull, acc[k], off);
    if (grp == 0 && active) {
      if (prow != nullptr)                            // warp-uniform
        store<V>(prow + c, acc);
      else
        store<V>(orow + c, acc);
    }
  }
}

struct SumLaunch {
  template <int V, int W, class T, class TO>
  static void go(const Args<T, TO>& a, const LaunchShape& s,
                 cudaStream_t stream) {
    segment_sum_kernel<V, W><<<s.grid, kWarps * 32, 0, stream>>>(
        a, s.S, s.lanes);
  }
};

template <class T, class TO>
int run(const int* indptr, const int* gidx, const int* eid, const T* x,
        const float* w, int w_kind, TO* out, int num_rows, int F, int vec,
        int slice, const RowPlan& plan, cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  LaunchShape s;
  if (!launch_shape(num_rows, F, vec, slice, plan, s) ||
      vec_bytes<T>(vec) < (int)sizeof(T) * vec ||       // 8 floats: no
      !aligned(x, vec_bytes<T>(vec)) || !aligned(out, vec_bytes<TO>(vec)) ||
      bad_weight(w, w_kind, vec))
    return (int)cudaErrorInvalidValue;
  const Args<T, TO> a{indptr, gidx, eid, x, w, out, num_rows, F, plan};
  rowwalk_launch<SumLaunch, sizeof(T) == 2>(vec, w_kind, a, s, stream);
  launch_fixup<false>(plan, out, F, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: values per load (1, 2, 4, and 8 for bf16; the wrapper's choice,
// checked here); slice: columns per feature slice (a multiple of vec; F
// for none); T, long_rows, piece_ptr, pieces, piece_row, num_long,
// num_pieces: the plan of spmm_kernel.py:row_plan; partial: (num_pieces,
// F) float32 scratch.
extern "C" int segment_sum_f32(const int* indptr, const int* gidx,
                               const int* eid, const float* x, const float* w,
                               int w_kind, float* out, int num_rows, int F,
                               int vec, int slice, int T,
                               const int* long_rows, const int* piece_ptr,
                               const int* pieces, const int* piece_row,
                               int num_long, int num_pieces, float* partial,
                               cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  return run(indptr, gidx, eid, x, w, w_kind, out, num_rows, F, vec, slice,
             plan, stream);
}

// As above over bf16 x; out is bf16, or float32 where out_f32 is 1.
extern "C" int segment_sum_bf16(const int* indptr, const int* gidx,
                                const int* eid, const bf16* x,
                                const float* w, int w_kind, void* out,
                                int out_f32, int num_rows, int F, int vec,
                                int slice, int T, const int* long_rows,
                                const int* piece_ptr, const int* pieces,
                                const int* piece_row, int num_long,
                                int num_pieces, float* partial,
                                cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  if (out_f32)
    return run(indptr, gidx, eid, x, w, w_kind, static_cast<float*>(out),
               num_rows, F, vec, slice, plan, stream);
  return run(indptr, gidx, eid, x, w, w_kind, static_cast<bf16*>(out),
             num_rows, F, vec, slice, plan, stream);
}
