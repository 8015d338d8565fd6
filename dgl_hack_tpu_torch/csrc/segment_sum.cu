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
// The packed route (short rows: the R-GCN pair graph, its per-dst sums,
// Cluster-GCN's one-edge parts).  Bound, as above, by bytes: per edge an
// index (and eid, weight) and a gathered row, per row its indptr entry
// and its output row.  A row of about one edge walked by a warp of its
// own pays the whole chain of dependent loads (indptr -> index -> x row
// -> store) for F floats of output, with 32 / lanes edge groups and most
// lanes idle: over 11 M rows that is latency, not bandwidth.  So a warp
// owns a pack: the rows of at most K1_SHORT (16) edges of an aligned
// window of kPackRows (32) rows [32 k, 32 k + 32).  Lane i loads
// indptr[r0 + i] and indptr[r0 + i + 1], one coalesced load each; a row of
// more edges is left to its own item.  Each of the warp's G = 32 / lanes
// lane groups (lanes from F and V as launch_shape computes them) owns the
// rows r0 + g, r0 + g + G, ..., takes kPackBatch (4) of them at once, and
// walks their edges in edge order, kPackEdges (2) at a time: the index
// loads of all those edges go out together (each group reads its own,
// broadcast to its lanes; the window's edges are one contiguous span, so
// the warp's reads share a few lines, and no shuffle hands them round),
// then all their row loads, then the sums, so a warp keeps up to
// G x kPackBatch x kPackEdges row loads in flight and pays the chain once
// per 4 G rows.  The G rows stored at once are consecutive: one
// contiguous span of G F values.  Each row sums its edges in edge order,
// so results repeat bitwise.  The windows need no list, so the plan adds
// only the rows of more than K1_SHORT and at most T edges (singles), one
// warp each (spmm_kernel.py:single_rows); long rows keep their pieces.
// The wrapper takes the route where a warp holds at least two lane groups
// and at least three quarters of the rows are short
// (spmm_kernel.py:k1_route, K1_PACK_SHARE).
// The grid is then [pieces | windows | singles].
//
// bf16 rows, the pairs walk (the JAX package's packed path,
// spmm_kernel.py:720-735, 916-925): x may be bf16 and is summed in float;
// the result is stored once, rounded to nearest even, as x's dtype, or as
// float32 where the caller asks (the hybrid's dx adds its dense part in
// float before it rounds).  The weight is float32.  bf16 halves the
// gathered rows' bytes, which bound K1, but a row piece widened to float
// on its load holds 8 registers an edge at 16-byte loads, 32 for the
// kUnroll edges a lane group keeps in flight and 64 for the pack's
// kPackBatch x kPackEdges; so both walks (sum_row, sum_pack) hold each
// piece as loaded, bf16x2 words (rowwalk.cuh:ldg_words: 4 registers for
// 16 bytes), and widen a value (an exact shift, widen) only at its add.
// The sums run in float32 in the same order as over widened values, so
// the results are the same bits.  The wrapper loads bf16 rows 8 values a
// lane where F and the alignment allow (spmm_kernel.py:k1_vector_width),
// 4 beside an (E, F) float32 weight (whose two 16-byte loads a lane at 8
// values held 92 registers) and on the pack (K1_PACK_VALUES: its rows in
// flight held 101 at 8 values).  On an H100 80GB HBM3 at 700 W (tools/k1_builds_torch.py,
// PERF.md) the pairs walk took K1 at synthetic Reddit (640 columns in
// 64-column slices) from the widening walk's 4.95 ms to 4.33, dx 5.00 to
// 4.67, and bench.py's dx from 0.758 to 0.661 (float32 0.734).
//
// The dense-hub hybrid (spmm_kernel.py:gspmm_hybrid) runs K1 over the
// graph's sparse remainder.  On the H100 (PERF.md) it beat K1 alone at
// bench.py's shape with its one hub window dense (9.5M of 16M edges) and
// lost with the 18 windows of bench.py's own threshold; prepare_spmm's
// default, from the card's measured rates, picks the one.
// Left for later: staging a piece's indices in shared memory.
#include "rowwalk.cuh"

namespace {

constexpr int kPackRows = 32;   // rows of a window: one a lane
constexpr int kPackBatch = 4;   // rows of a lane group summed at once
constexpr int kPackEdges = 2;   // edges of each taken at once

// The packed route's items: the windows of kPackRows rows, whose rows of
// at most `short_limit` edges a warp sums (sum_pack), and the rows of
// more than that and at most T edges (spmm_kernel.py:single_rows); none
// where short_limit is 0, and then every row not cut into pieces is an
// item, as for K4 and K5.
struct PackPlan {
  int short_limit;     // a row of at most this many edges is packed
  const int* singles;  // (S,) the rows neither packed nor long
  int num_singles;
};

// Value k of V bf16 values held as loaded (rowwalk.cuh:ldg_words), as a
// float: the low half of word k / 2 for even k, the high half for odd.
template <int V>
__device__ __forceinline__ float widen(const unsigned (&w)[(V + 1) / 2],
                                       int k) {
  const unsigned u = w[k >> 1];
  return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
}

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

// Window k: rows [kPackRows k, + kPackRows) of a.num_rows; the warp's
// lane group grp owns its rows grp, grp + G, ... (G = 32 / lanes groups)
// of at most pk.short_limit edges, kPackBatch at a time; each row's edges
// are summed in edge order, kPackEdges a step.  Columns [c_lo, c_hi) of
// the slice, lanes * V a pass.
template <int V, int W, class T, class TO>
__device__ __forceinline__ void sum_pack(const Args<T, TO>& a,
                                         const PackPlan& pk, int64_t k,
                                         int c_lo, int c_hi, int lanes) {
  const int64_t r0 = k * kPackRows;
  const int n = (int)min((int64_t)kPackRows, a.num_rows - r0);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int grp = lane / lanes;
  const int G = 32 / lanes;
  int lbeg = 0, ldeg = -1;                            // -1: not packed
  if (lane < n) {
    lbeg = __ldg(a.indptr + r0 + lane);
    const int d = __ldg(a.indptr + r0 + lane + 1) - lbeg;
    if (d <= pk.short_limit) ldeg = d;
  }
  const int64_t Fl = a.F;
  const int U = (n + G - 1) / G;                     // rows of a group
  for (int c0 = c_lo; c0 < c_hi; c0 += lanes * V) {  // warp-uniform
    const int c = c0 + sub * V;
    const bool active = c < c_hi;
    for (int m0 = 0; m0 < U; m0 += kPackBatch) {     // warp-uniform
      int beg[kPackBatch], deg[kPackBatch];
      int most = 0;
#pragma unroll
      for (int i = 0; i < kPackBatch; ++i) {
        const int q = (m0 + i) * G + grp;            // the row, from r0
        beg[i] = __shfl_sync(kFull, lbeg, q & 31);
        deg[i] = __shfl_sync(kFull, ldeg, q & 31);
        if (q >= n) deg[i] = -1;
        most = max(most, deg[i]);
      }
      most = __reduce_max_sync(kFull, most);
      float acc[kPackBatch][V];
#pragma unroll
      for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;
      for (int j = 0; j < most; j += kPackEdges) {   // warp-uniform
        int64_t row[kPackBatch][kPackEdges], e[kPackBatch][kPackEdges];
#pragma unroll
        for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
          for (int u = 0; u < kPackEdges; ++u) {
            const int p = beg[i] + j + u;
            const bool ok = j + u < deg[i];
            row[i][u] = !ok ? 0 : a.gidx ? __ldg(a.gidx + p) : p;
            e[i][u] = !ok || W == 0 ? 0 : a.eid ? __ldg(a.eid + p) : p;
          }
        if constexpr (sizeof(T) == 4) {
          float xv[kPackBatch][kPackEdges][V], wv[kPackBatch][kPackEdges][V];
#pragma unroll
          for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
            for (int u = 0; u < kPackEdges; ++u) {
#pragma unroll
              for (int v = 0; v < V; ++v)
                xv[i][u][v] = 0.0f, wv[i][u][v] = 1.0f;
              if (j + u < deg[i] && active) {
                load<V>(a.x + row[i][u] * Fl + c, xv[i][u]);
                load_weight<V, W>(a.w, e[i][u], Fl, c, wv[i][u]);
              }
            }
#pragma unroll
          for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
            for (int u = 0; u < kPackEdges; ++u)
              if (j + u < deg[i])
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[i][v] = W ? fmaf(xv[i][u][v], wv[i][u][v], acc[i][v])
                                : acc[i][v] + xv[i][u][v];
        } else {                                     // bf16: the pairs walk
          unsigned xw[kPackBatch][kPackEdges][(V + 1) / 2];
          float wv[kPackBatch][kPackEdges][V];
#pragma unroll
          for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
            for (int u = 0; u < kPackEdges; ++u) {
#pragma unroll
              for (int k = 0; k < (V + 1) / 2; ++k) xw[i][u][k] = 0u;
#pragma unroll
              for (int v = 0; v < V; ++v) wv[i][u][v] = 1.0f;
              if (j + u < deg[i] && active) {
                ldg_words<V>(a.x + row[i][u] * Fl + c, xw[i][u]);
                load_weight<V, W>(a.w, e[i][u], Fl, c, wv[i][u]);
              }
            }
#pragma unroll
          for (int i = 0; i < kPackBatch; ++i)
#pragma unroll
            for (int u = 0; u < kPackEdges; ++u)
              if (j + u < deg[i])
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  const float x = widen<V>(xw[i][u], v);
                  acc[i][v] = W ? fmaf(x, wv[i][u][v], acc[i][v])
                                : acc[i][v] + x;
                }
        }
      }
#pragma unroll
      for (int i = 0; i < kPackBatch; ++i) {
        if (deg[i] >= 0 && active)
          store<V>(a.out + (r0 + (m0 + i) * G + grp) * Fl + c, acc[i]);
      }
    }
  }
}

// The walk of one row item (rowwalk.cuh: a row, or a piece of a long row)
// over columns [blockIdx.y S, + S) of the slice; S: the slice's width in
// columns, a multiple of V; lanes: lanes per edge, a power of two <= 32;
// W: the weight kind.
template <int V, int W, class T, class TO>
__device__ __forceinline__ void sum_row(const Args<T, TO>& a,
                                        const WorkItem& it, int S,
                                        int lanes) {
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
      if constexpr (sizeof(T) == 4) {
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
      } else {                                       // bf16: the pairs walk
        unsigned xw[kUnroll][(V + 1) / 2];
        float wv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < (V + 1) / 2; ++k) xw[u][k] = 0u;
#pragma unroll
          for (int k = 0; k < V; ++k) wv[u][k] = 1.0f;
          if (ok[u] && active) {
            ldg_words<V>(a.x + row[u] * Fl + c, xw[u]);
            load_weight<V, W>(a.w, e[u], Fl, c, wv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float x = widen<V>(xw[u], k);
            acc[k] = W ? fmaf(x, wv[u][k], acc[k]) : acc[k] + x;
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
        store<V>(prow + c, acc);
      else
        store<V>(orow + c, acc);
    }
  }
}

// The rows route: grid of launch_shape over [pieces | rows].
template <int V, int W, class T, class TO>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(Args<T, TO> a, int S, int lanes) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  sum_row<V, W>(a, it, S, lanes);
}

// The rows route of the pairs walk at 8 values a lane without a weight
// (bench.py's dx, synthetic Reddit's 64-column slices), bounded to the 5
// blocks of 256 threads an SM that its 48 registers allow: saying so lets
// ptxas keep the kUnroll edges' row loads in flight together, as for
// segment_max_packed.cu's K5.  On an H100 80GB HBM3 at 700 W
// (tools/k1_builds_torch.py, PERF.md) it took K1 at Reddit from 5.48 to
// 4.32 ms (dx 5.64 to 4.63) with the same registers; at 4 values a lane
// the same bound cost time (4.85 to 5.66 ms), and an (E, F) weight's 92
// registers would spill under it, so the other instantiations keep
// segment_sum_kernel's.
template <int V, int W, class T, class TO>
__global__ void __launch_bounds__(kWarps * 32, 5)
segment_sum_pairs8_kernel(Args<T, TO> a, int S, int lanes) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_rows, it)) return;  // warp-uniform
  sum_row<V, W>(a, it, S, lanes);
}

// The windows of the packed route.
__host__ __device__ __forceinline__ int64_t num_windows(int num_rows) {
  return ((int64_t)num_rows + kPackRows - 1) / kPackRows;
}

// The packed route: grid of launch_shape over [pieces | windows |
// singles].
template <int V, int W, class T, class TO>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_packed_kernel(Args<T, TO> a, PackPlan pk, int S, int lanes) {
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t num_packs = num_windows(a.num_rows);
  WorkItem it;
  if (item < a.plan.num_pieces) {                     // warp-uniform
    work_item(a.plan, a.indptr, a.num_rows, it);
  } else if (item < a.plan.num_pieces + num_packs) {
    const int c_lo = blockIdx.y * S;
    sum_pack<V, W>(a, pk, item - a.plan.num_pieces, c_lo,
                   min(c_lo + S, a.F), lanes);
    return;
  } else {
    const int64_t s = item - a.plan.num_pieces - num_packs;
    if (s >= pk.num_singles) return;
    it.piece = -1;
    it.row = pk.singles[s];
    it.beg = a.indptr[it.row];
    it.end = a.indptr[it.row + 1];
  }
  sum_row<V, W>(a, it, S, lanes);
}

struct SumLaunch {
  template <int V, int W, class T, class TO>
  static void go(const Args<T, TO>& a, const PackPlan& pk,
                 const LaunchShape& s, cudaStream_t stream) {
    if (pk.short_limit > 0)
      segment_sum_packed_kernel<V, W><<<s.grid, kWarps * 32, 0, stream>>>(
          a, pk, s.S, s.lanes);
    else if constexpr (sizeof(T) == 2 && V == 8 && W == 0)
      segment_sum_pairs8_kernel<V, W><<<s.grid, kWarps * 32, 0, stream>>>(
          a, s.S, s.lanes);
    else
      segment_sum_kernel<V, W><<<s.grid, kWarps * 32, 0, stream>>>(
          a, s.S, s.lanes);
  }
};

template <class T, class TO>
int run(const int* indptr, const int* gidx, const int* eid, const T* x,
        const float* w, int w_kind, TO* out, int num_rows, int F, int vec,
        int slice, const RowPlan& plan, const PackPlan& pk,
        cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  const bool packed = pk.short_limit > 0;
  LaunchShape s;
  // the packed grid walks windows and singles where the other walks rows
  if (!launch_shape(packed ? (int)(num_windows(num_rows) + pk.num_singles)
                           : num_rows, F, vec, slice, plan, s) ||
      vec_bytes<T>(vec) < (int)sizeof(T) * vec ||       // 8 floats: no
      !aligned(x, vec_bytes<T>(vec)) || !aligned(out, vec_bytes<TO>(vec)) ||
      bad_weight(w, w_kind, vec) || pk.short_limit < 0 ||
      pk.short_limit > plan.T || pk.num_singles < 0 ||
      (pk.num_singles > 0 && pk.singles == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<T, TO> a{indptr, gidx, eid, x, w, out, num_rows, F, plan};
  rowwalk_launch<SumLaunch, sizeof(T) == 2>(vec, w_kind, a, pk, s, stream);
  launch_fixup<false>(plan, out, F, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: values per load (1, 2, 4, and 8 for bf16; the wrapper's choice,
// checked here); slice: columns per feature slice (a multiple of vec; F
// for none); T, long_rows, piece_ptr, pieces, piece_row, num_long,
// num_pieces: the plan of spmm_kernel.py:row_plan; partial: (num_pieces,
// F) float32 scratch; short_limit, singles, num_singles: the packed
// route's (spmm_kernel.py:pack_args), short_limit 0 for the other route.
extern "C" int segment_sum_f32(const int* indptr, const int* gidx,
                               const int* eid, const float* x, const float* w,
                               int w_kind, float* out, int num_rows, int F,
                               int vec, int slice, int T,
                               const int* long_rows, const int* piece_ptr,
                               const int* pieces, const int* piece_row,
                               int num_long, int num_pieces, float* partial,
                               int short_limit, const int* singles,
                               int num_singles,
                               cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  const PackPlan pk{short_limit, singles, num_singles};
  return run(indptr, gidx, eid, x, w, w_kind, out, num_rows, F, vec, slice,
             plan, pk, stream);
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
                                int short_limit, const int* singles,
                                int num_singles,
                                cudaStream_t stream) {
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  const PackPlan pk{short_limit, singles, num_singles};
  if (out_f32)
    return run(indptr, gidx, eid, x, w, w_kind, static_cast<float*>(out),
               num_rows, F, vec, slice, plan, pk, stream);
  return run(indptr, gidx, eid, x, w, w_kind, static_cast<bf16*>(out),
             num_rows, F, vec, slice, plan, pk, stream);
}
