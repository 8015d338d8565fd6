// K1: sorted-segment sum over a CSR-style index (float32).
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
// Design:
// * Work items.  One warp owns one item: a row of at most T edges, or one
//   piece of at most T edges of a longer row.  The plan (built from indptr
//   by spmm_kernel.py:row_plan with torch ops on the device) lists the long
//   rows, their pieces and where each row's pieces start.  A piece writes
//   its partial row to scratch (pieces x F floats); the fix-up kernel then
//   sums each long row's partials in piece order.  No float atomics, so
//   every result repeats bitwise.  Pieces come first in the grid so the
//   heavy work starts early and the short rows fill the tail.
// * Loads.  A lane reads V consecutive floats of a row (V = 4, 2 or 1,
//   chosen by the wrapper from F's divisibility and the pointers'
//   alignment: float4 needs 4 | F and 16-byte aligned x and w; F = 602 is
//   8-byte aligned per row and takes float2).  Lanes per edge = the slice's
//   width / V rounded up to a power of two, at most 32; the warp's 32 /
//   lanes groups take every (32 / lanes)-th edge of the item, kUnroll
//   edges at a time, so a warp has up to 32 / lanes * kUnroll row loads in
//   flight.  The warp loads the indices of 32 edges at once, one per lane,
//   a chunk ahead, and hands them to the groups by shuffles, so a row load
//   never waits on its own index load.  A fixed shuffle tree then sums the
//   groups.
// * Feature slices.  For wide F over an x larger than L2 the wrapper cuts
//   the columns into slices of S columns (rule in spmm_kernel.py:
//   slice_width).  The slice is the slowest grid dimension, so the blocks
//   in flight at one time all read the same slice of x, and that slice
//   (rows x S x 4 bytes) stays in L2 while every row gathers from it; only
//   the indices are read again per slice.
// Left for later: bf16 storage; staging a piece's indices in shared
// memory; a dense-hub hybrid (ROADMAP Queue 1 item 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps per block
constexpr int kUnroll = 4;    // edges in flight per lane group
constexpr int kFixCols = 128; // columns per fix-up block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* indptr;
  const int* gidx;
  const int* eid;
  const float* x;
  const float* w;
  int w_kind;
  float* out;
  int num_rows;
  int F;
  int T;               // rows of more than T edges are cut into pieces
  const int* long_rows;  // (L,) the long rows
  const int* piece_ptr;  // (L + 1,) long row l's pieces: [ptr[l], ptr[l+1])
  const int* pieces;     // (P, 2) each piece's edges [beg, end)
  int num_long;
  int num_pieces;
  float* partial;        // (P, F) the pieces' partial rows
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// grid (ceil((P + num_rows) / kWarps), slices); items [0, P) are pieces,
// [P, P + num_rows) rows.  S: the slice's width in columns, a multiple of
// V; lanes: lanes per edge, a power of two <= 32.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(Args a, int S, int lanes) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (int64_t)a.num_pieces + a.num_rows) return;   // warp-uniform
  const int64_t Fl = a.F;
  int beg, end;
  float* orow;
  if (item < a.num_pieces) {
    beg = a.pieces[2 * item];
    end = a.pieces[2 * item + 1];
    orow = a.partial + item * Fl;
  } else {
    const int64_t r = item - a.num_pieces;
    beg = a.indptr[r];
    end = a.indptr[r + 1];
    if (end - beg > a.T) return;   // its pieces and the fix-up write it
    orow = a.out + r * Fl;
  }
  const int groups = 32 / lanes;
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
    // The warp walks the item in chunks of 32 edges: lane i loads edge
    // jc + i's row and weight index (the next chunk's while this one is
    // summed), and group grp takes the chunk's edges grp, grp + groups,
    // ... from the lanes that hold them, kUnroll at a time.
    int row_next = 0, e_next = 0;
    if (beg + lane < end) {
      row_next = a.gidx ? __ldg(a.gidx + beg + lane) : beg + lane;
      if (a.w_kind) e_next = a.eid ? __ldg(a.eid + beg + lane) : beg + lane;
    }
    for (int jc = beg; jc < end; jc += 32) {           // warp-uniform
      const int row_mine = row_next, e_mine = e_next;
      const int jn = jc + 32 + lane;
      if (jn < end) {
        row_next = a.gidx ? __ldg(a.gidx + jn) : jn;
        if (a.w_kind) e_next = a.eid ? __ldg(a.eid + jn) : jn;
      }
      const int n = min(32, end - jc);
      for (int b = 0; b * groups < n; b += kUnroll) {  // warp-uniform
        float xv[kUnroll][V], wv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = (b + u) * groups + grp;      // edge jc + t
          const int64_t row = __shfl_sync(kFull, row_mine, t & 31);
          const int64_t e = __shfl_sync(kFull, e_mine, t & 31);
#pragma unroll
          for (int k = 0; k < V; ++k) xv[u][k] = 0.0f, wv[u][k] = 1.0f;
          if (t < n && active) {
            load<V>(a.x + row * Fl + c, xv[u]);
            if (a.w_kind == 1) {
              const float s = __ldg(a.w + e);
#pragma unroll
              for (int k = 0; k < V; ++k) wv[u][k] = s;
            } else if (a.w_kind == 2) {
              load<V>(a.w + e * Fl + c, wv[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[k] = fmaf(xv[u][k], wv[u][k], acc[k]);
      }
    }
    // fixed-order tree over the groups (lanes of equal sub)
    for (int off = 16; off >= lanes; off >>= 1)
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += __shfl_down_sync(kFull, acc[k], off);
    if (grp == 0 && active) store<V>(orow + c, acc);
  }
}

// out[long_rows[l], f] = sum over l's pieces p, in order, of partial[p, f].
// grid (L, ceil(F / kFixCols)), one thread per column.
__global__ void __launch_bounds__(kFixCols)
segment_sum_fixup(Args a) {
  const int l = blockIdx.x;
  const int f = blockIdx.y * kFixCols + threadIdx.x;
  if (f >= a.F) return;
  const int64_t Fl = a.F;
  const int p0 = a.piece_ptr[l];
  const int p1 = a.piece_ptr[l + 1];
  float acc = 0.0f;
#pragma unroll 8
  for (int p = p0; p < p1; ++p) acc += a.partial[(int64_t)p * Fl + f];
  a.out[(int64_t)a.long_rows[l] * Fl + f] = acc;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

}  // namespace

// vec: floats per load (1, 2, 4; the wrapper's choice, checked here);
// slice: columns per feature slice (a multiple of vec; F for none);
// T, long_rows, piece_ptr, pieces, num_long, num_pieces: the plan of
// spmm_kernel.py:row_plan; partial: (num_pieces, F) scratch.
extern "C" int segment_sum_f32(const int* indptr, const int* gidx,
                               const int* eid, const float* x, const float* w,
                               int w_kind, float* out, int num_rows, int F,
                               int vec, int slice, int T,
                               const int* long_rows, const int* piece_ptr,
                               const int* pieces, int num_long,
                               int num_pieces, float* partial,
                               cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  const int vbytes = 4 * vec;
  if (!(vec == 1 || vec == 2 || vec == 4) || F % vec != 0 ||
      slice <= 0 || slice % vec != 0 || T <= 0 || !aligned(x, vbytes) ||
      !aligned(out, vbytes) || !aligned(partial, vbytes) ||
      (w_kind == 2 && !aligned(w, vbytes)) ||
      (num_pieces > 0 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{indptr, gidx, eid, x, w, w_kind, out, num_rows, F, T,
         long_rows, piece_ptr, pieces, num_long, num_pieces, partial};
  const int S = slice < F ? slice : F;
  int lanes = 1;
  while (lanes < 32 && lanes * vec < S) lanes <<= 1;
  const int64_t items = (int64_t)num_pieces + num_rows;
  const dim3 grid((unsigned)((items + kWarps - 1) / kWarps),
                  (unsigned)((F + S - 1) / S));
  if (vec == 4)
    segment_sum_kernel<4><<<grid, kWarps * 32, 0, stream>>>(a, S, lanes);
  else if (vec == 2)
    segment_sum_kernel<2><<<grid, kWarps * 32, 0, stream>>>(a, S, lanes);
  else
    segment_sum_kernel<1><<<grid, kWarps * 32, 0, stream>>>(a, S, lanes);
  if (num_long > 0)
    segment_sum_fixup<<<dim3((unsigned)num_long,
                             (unsigned)((F + kFixCols - 1) / kFixCols)),
                        kFixCols, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
