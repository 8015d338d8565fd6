// What the row-walking kernels share: K1 (segment_sum.cu), K4 and K5
// (segment_max.cu), and K2 and K3 (gat_fwd.cu, gat_bwd.cu), which lay
// their lanes out by head (the head-major walks at the end).  Each
// reduces, per row of a CSR-style indptr, over the row's edges, gathering
// one node row per edge; each is bound by those
// gathered bytes, and short of that by how the work is spread over warps
// and how many loads a warp keeps in flight.
//
// * Work items (RowPlan, work_item).  One warp owns one item: a row of at
//   most T edges, or one piece of at most T edges of a longer row.  The
//   plan (built from indptr by spmm_kernel.py:row_plan with torch ops on
//   the device) lists the long rows, their pieces, each piece's row and
//   where each row's pieces start.  A piece writes its partial row to
//   scratch (pieces x F floats); row_fixup then combines each long row's
//   partials in piece order.  No float atomics, so every result repeats
//   bitwise.  Pieces come first in the grid so the heavy work starts early
//   and the short rows fill the tail.  K1 alone has a third kind of item
//   (segment_sum.cu, sum_pack): the rows of at most 16 edges of an aligned
//   window of 32 rows, one lane group a row, for graphs whose rows are
//   mostly that short; work_item and WorkItem are as K4, K5, K2 and K3 use
//   them.
// * Loads (load, store, ldg_words).  A lane reads V consecutive values of
//   a row, at most 16 bytes: V = 4, 2 or 1 of float32, 8, 4, 2 or 1 of
//   bf16, chosen by the wrapper from F's divisibility and the pointers'
//   alignment (spmm_kernel.py:vector_width): a 16-byte load needs 16 / size
//   | F and 16-byte aligned tensors; F = 602 is 8-byte aligned per row in
//   float32 and takes float2, 4-byte aligned in bf16 and takes bfloat162.
//   The walks that hold bf16 rows as loaded (K1's pairs walk,
//   segment_sum.cu; K4/K5's packed walk, segment_max_packed.cu) keep a
//   16-byte piece in 4 registers (ldg_words) and widen a value, if at all,
//   only where they use it, since a piece widened on its load holds 8 float
//   registers an edge in flight; the others (segment_max.cu, K2/K3) widen
//   bf16 on the load (load).  Sums, maxima and compares of widened values
//   run in float registers, and a bf16 store rounds to nearest even once.
// * The edge walk (walk_edges).  Lanes per edge = the slice's width / V
//   rounded up to a power of two, at most 32; the warp's 32 / lanes groups
//   take every (32 / lanes)-th edge of the item, kUnroll edges at a time,
//   so a warp has up to 32 / lanes * kUnroll row loads in flight.  The warp
//   loads the indices of 32 edges at once, one per lane, a chunk ahead, and
//   hands them to the groups by shuffles, so a row load never waits on its
//   own index load.
// * Feature slices (launch_shape).  For wide F over a gathered array
//   larger than L2 the wrapper cuts the columns into slices of S columns.
//   The slice is the slowest grid dimension, so the blocks in flight at one
//   time all read the same slice, and that slice (rows x S x 4 bytes) stays
//   in L2 while every row gathers from it; only the indices are read again
//   per slice.  A slice of a row costs one 128-byte L2 line where it starts
//   on a line boundary and two where it straddles one, so gspmm runs the
//   kernels over copies whose columns are padded to whole lines
//   (spmm_kernel.py:padded_width, run_width; 32 columns of float32, 64 of
//   bf16).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kUnroll = 4;       // edges in flight per lane group
constexpr int kFixCols = 128;    // columns per fix-up block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;   // MINMAX_NEG: the max kernels' floor

struct RowPlan {
  int T;                 // rows of more than T edges are cut into pieces
  const int* long_rows;  // (L,) the long rows
  const int* piece_ptr;  // (L + 1,) long row l's pieces: [ptr[l], ptr[l+1])
  const int* pieces;     // (P, 2) each piece's edges [beg, end)
  const int* piece_row;  // (P,) the row each piece is cut from
  int num_long;
  int num_pieces;
  float* partial;        // (P, F) the pieces' partial rows
};

// kStream: a read-once load (ld.global.cs), which L2 evicts first, for
// what streams beside a gathered slice that should stay in L2.  V = 8 is
// two 16-byte loads: an f32 weight read beside bf16 rows of 8 per load.
template <int V, bool kStream = false>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = kStream ? __ldcs(q) : __ldg(q);
    const float4 b = kStream ? __ldcs(q + 1) : __ldg(q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t = kStream ? __ldcs(q) : __ldg(q);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 t = kStream ? __ldcs(q) : __ldg(q);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = kStream ? __ldcs(p) : __ldg(p);
  }
}

// bf16 storage (the JAX package's packed-u32 rows, spmm_kernel.py:720):
// a 32-bit word holds two bf16 values, the lower column in its low half,
// and the bits of a bf16 value b are those of the float b << 16, so a load
// widens exactly and the sums run in float registers.
__device__ __forceinline__ void unpack2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// V bf16 values: 16 bytes (8, a uint4), 8 (4), 4 (2, a bfloat162) or 2.
template <int V, bool kStream = false>
__device__ __forceinline__ void load(const bf16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 t = kStream ? __ldcs(q) : __ldg(q);
    unpack2(t.x, v[0], v[1]); unpack2(t.y, v[2], v[3]);
    unpack2(t.z, v[4], v[5]); unpack2(t.w, v[6], v[7]);
  } else if constexpr (V == 4) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 t = kStream ? __ldcs(q) : __ldg(q);
    unpack2(t.x, v[0], v[1]); unpack2(t.y, v[2], v[3]);
  } else if constexpr (V == 2) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    const unsigned t = kStream ? __ldcs(q) : __ldg(q);
    unpack2(t, v[0], v[1]);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    const unsigned short t = kStream ? __ldcs(q) : __ldg(q);
    v[0] = __uint_as_float((unsigned)t << 16);
  }
}

// V bf16 values as loaded: V / 2 bf16x2 words (16, 8 or 4 bytes), or for
// V = 1 the value in the low half of one word (the layout of unpack2's low
// half); kStream: read once (ld.global.cs), which L2 evicts first.
template <int V, bool kStream = false>
__device__ __forceinline__ void ldg_words(const bf16* p,
                                          unsigned (&w)[(V + 1) / 2]) {
  if constexpr (V == 8) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 t = kStream ? __ldcs(q) : __ldg(q);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (V == 4) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 t = kStream ? __ldcs(q) : __ldg(q);
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (V == 2) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    w[0] = kStream ? __ldcs(q) : __ldg(q);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    w[0] = kStream ? __ldcs(q) : __ldg(q);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// float -> bf16 rounds to nearest even, as astype(jnp.bfloat16) does
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned*>(p) = pack2(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// v rounded to T and widened back: what a store of v to T and a load of
// it give (the identity for float)
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// Columns [c, c + V) of a row of n columns, moved VX values at a time (VX
// divides V, n and c): a piece at or past column n is left as it is on a
// load and not written on a store.  For a row narrower, or less aligned,
// than the rows the kernel walks beside it.
template <int V, int VX, bool kStream = false, class T>
__device__ __forceinline__ void load_clipped(const T* row, int c, int n,
                                             float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += VX)
    if (c + i < n) {
      float t[VX];
      load<VX, kStream>(row + c + i, t);
#pragma unroll
      for (int k = 0; k < VX; ++k) v[i + k] = t[k];
    }
}

template <int V, int VX, class T>
__device__ __forceinline__ void store_clipped(T* row, int c, int n,
                                              const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += VX)
    if (c + i < n) {
      float t[VX];
#pragma unroll
      for (int k = 0; k < VX; ++k) t[k] = v[i + k];
      store<VX>(row + c + i, t);
    }
}

// Edge e's weights for columns [c, c + V) into wv; W: the weight kind, 0
// none (wv is left as it is), 1 scalar per edge (E,), 2 full (E, F).
template <int V, int W>
__device__ __forceinline__ void load_weight(const float* w, int64_t e,
                                            int64_t F, int c, float (&wv)[V]) {
  if constexpr (W == 1) {
    const float s = __ldg(w + e);
#pragma unroll
    for (int k = 0; k < V; ++k) wv[k] = s;
  } else if constexpr (W == 2) {
    load<V>(w + e * F + c, wv);
  }
}

// running max that propagates NaN, as torch.maximum does
__device__ __forceinline__ float max_nan(float acc, float m) {
  return (m > acc || m != m) ? m : acc;
}

// The calling warp's item of a grid of ceil((P + num_rows) / kWarps)
// blocks: items [0, P) are pieces, [P, P + num_rows) rows.  False where
// there is nothing to do: past the last item, or a long row, which its
// pieces and the fix-up write.  Warp-uniform.
struct WorkItem {
  int beg, end;    // the item's edges
  int64_t row;     // its row
  int64_t piece;   // its piece, or -1 for a whole row
};

__device__ __forceinline__ bool work_item(const RowPlan& p, const int* indptr,
                                          int num_rows, WorkItem& it) {
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (int64_t)p.num_pieces + num_rows) return false;
  if (item < p.num_pieces) {
    it.piece = item;
    it.row = p.piece_row[item];
    it.beg = p.pieces[2 * item];
    it.end = p.pieces[2 * item + 1];
    return true;
  }
  it.piece = -1;
  it.row = item - p.num_pieces;
  it.beg = indptr[it.row];
  it.end = indptr[it.row + 1];
  return it.end - it.beg <= p.T;
}

// The warp walks edges [beg, end) in chunks of 32: lane i loads edge
// jc + i's gather row (gidx[j], or j itself when gidx is NULL) and, with
// kWantE, its edge id (eid[j], or j), the next chunk's while this one is
// worked on; group grp = lane / lanes takes the chunk's edges grp,
// grp + groups, ... from the lanes that hold them, kUnroll at a time, and
// hands them to body(row, e, ok); ok[u] is false past the item's end.
// Every lane calls body the same number of times, so it may shuffle.
template <bool kWantE, class Body>
__device__ __forceinline__ void walk_edges(int beg, int end, const int* gidx,
                                           const int* eid, int lanes,
                                           Body body) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lanes;
  const int grp = lane / lanes;
  int row_next = 0, e_next = 0;
  if (beg + lane < end) {
    row_next = gidx ? __ldg(gidx + beg + lane) : beg + lane;
    if (kWantE) e_next = eid ? __ldg(eid + beg + lane) : beg + lane;
  }
  for (int jc = beg; jc < end; jc += 32) {           // warp-uniform
    const int row_mine = row_next, e_mine = e_next;
    const int jn = jc + 32 + lane;
    if (jn < end) {
      row_next = gidx ? __ldg(gidx + jn) : jn;
      if (kWantE) e_next = eid ? __ldg(eid + jn) : jn;
    }
    const int n = min(32, end - jc);
    for (int b = 0; b * groups < n; b += kUnroll) {  // warp-uniform
      int64_t row[kUnroll], e[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = (b + u) * groups + grp;        // edge jc + t
        row[u] = __shfl_sync(kFull, row_mine, t & 31);
        e[u] = kWantE ? __shfl_sync(kFull, e_mine, t & 31) : 0;
        ok[u] = t < n;
      }
      body(row, e, ok);
    }
  }
}

// out[long_rows[l], f] = the long row l's partial rows combined in piece
// order: their sum, or with kMax their NaN-keeping max, stored as TO.
// grid (L, ceil(F / kFixCols)), one thread per column.
template <bool kMax, class TO>
__global__ void __launch_bounds__(kFixCols)
row_fixup(RowPlan p, TO* out, int F) {
  const int l = blockIdx.x;
  const int f = blockIdx.y * kFixCols + threadIdx.x;
  if (f >= F) return;
  const int p0 = p.piece_ptr[l];
  const int p1 = p.piece_ptr[l + 1];
  float acc = kMax ? kNeg : 0.0f;
#pragma unroll 8
  for (int q = p0; q < p1; ++q) {
    const float v = p.partial[(int64_t)q * F + f];
    acc = kMax ? max_nan(acc, v) : acc + v;
  }
  const float r[1] = {acc};
  store<1>(out + (int64_t)p.long_rows[l] * F + f, r);
}

template <bool kMax, class TO>
void launch_fixup(const RowPlan& p, TO* out, int F, cudaStream_t stream) {
  if (p.num_long > 0)
    row_fixup<kMax><<<dim3((unsigned)p.num_long,
                           (unsigned)((F + kFixCols - 1) / kFixCols)),
                      kFixCols, 0, stream>>>(p, out, F);
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

// The alignment a load or store of vec values of T needs: its bytes, at
// most 16 (vec = 8 of float is two 16-byte loads).
template <class T>
inline int vec_bytes(int vec) {
  const int b = (int)sizeof(T) * vec;
  return b < 16 ? b : 16;
}

// The grid of a row-walking kernel and its slice width S and lanes per
// edge.  False where the wrapper's choices do not fit: vec (values per
// load) must be 1, 2, 4 or 8 and divide F and slice (columns per feature
// slice; F or more for none), and the plan's scratch must be there and
// aligned for vec.
struct LaunchShape {
  dim3 grid;
  int S, lanes;
};

inline bool launch_shape(int num_rows, int F, int vec, int slice, const RowPlan& p,
                  LaunchShape& s) {
  if (!(vec == 1 || vec == 2 || vec == 4 || vec == 8) || F % vec != 0 ||
      slice <= 0 || slice % vec != 0 || p.T <= 0 ||
      !aligned(p.partial, vec_bytes<float>(vec)) ||
      (p.num_pieces > 0 && p.partial == nullptr))
    return false;
  s.S = slice < F ? slice : F;
  s.lanes = 1;
  while (s.lanes < 32 && s.lanes * vec < s.S) s.lanes <<= 1;
  const int64_t items = (int64_t)p.num_pieces + num_rows;
  s.grid = dim3((unsigned)((items + kWarps - 1) / kWarps),
                (unsigned)((F + s.S - 1) / s.S));
  return true;
}

// Runs L::go<V, W>(args...) for the run-time vec (1, 2, 4, and 8 where
// kWide: bf16 rows) and w_kind (0, 1, 2): the kernels are compiled per
// load width and weight kind, so that each keeps only its own registers.
template <class L, int V, class... A>
void rowwalk_launch_w(int w_kind, const A&... args) {
  if (w_kind == 0)
    L::template go<V, 0>(args...);
  else if (w_kind == 1)
    L::template go<V, 1>(args...);
  else
    L::template go<V, 2>(args...);
}

template <class L, bool kWide, class... A>
void rowwalk_launch(int vec, int w_kind, const A&... args) {
  if (vec == 8) {
    if constexpr (kWide) rowwalk_launch_w<L, 8>(w_kind, args...);
  } else if (vec == 4) {
    rowwalk_launch_w<L, 4>(w_kind, args...);
  } else if (vec == 2) {
    rowwalk_launch_w<L, 2>(w_kind, args...);
  } else {
    rowwalk_launch_w<L, 1>(w_kind, args...);
  }
}

// w_kind must be 0, 1 or 2, with a weight where it is not 0, aligned for
// a load of vec floats where it is 2.  Weights are float32 under rows of
// either type: the wrapper casts a bf16 weight up, as the JAX package's
// edge_weights does (spmm_kernel.py:_run_direction).
inline bool bad_weight(const float* w, int w_kind, int vec) {
  return w_kind < 0 || w_kind > 2 || (w_kind != 0 && w == nullptr) ||
         (w_kind == 2 && !aligned(w, vec_bytes<float>(vec)));
}

// ---------------------------------------------------------------------------
// Head-major walks: K2 and K3 (gat_fwd.cu, gat_bwd.cu).  Their rows are H
// heads of D columns, and part of the work per edge is per head (a logit,
// an exp, a dot over D), so lanes are laid out by head:
// * lane q of a head's Lh lanes holds columns (q + k Lh) V .. + V of it for
//   k < NC: NC V-column chunks, at most lane_floats floats per edge.  Lh is
//   the fewest lanes (a power of two, at most 32) that hold the head so, so
//   that a warp takes as many edges at once as it can; NC (1, 2, 4 or 8) is
//   a template parameter, so each case keeps only its own registers.  V
//   divides D, so a lane's V columns lie in one head;
// * a lane group (walk_edges' lanes) holds Hp heads, Lh * Hp <= 32 lanes;
//   a head's lanes are Lh aligned lanes of it, so head_sum reduces over
//   them with xor shuffles and every lane of the head gets the same bits;
// * a head wider than 32 lanes of lane_floats goes in nchunk passes of
//   that many columns (one head a pass);
// * Wh may be bf16 (the packed GAT, a bf16 gat_attention): its loads widen
//   to float, up to V = 8 values (16 bytes) a load, and everything else
//   (el, er, w, dout, the sums, the outputs) stays float32.
// No feature slices: slices of whole heads lost on the card at every width
// (PERF.md); K3 pays per edge, not per byte, so each slice costs it about a
// whole unsliced pass.
constexpr int kLaneFloatsMax = 8;   // NC * V, the most a lane holds an edge

struct HeadWalk {
  int Lh, NC, nchunk, Hp, lanes;
};

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The grid and head layout of a head-major kernel over num_rows rows and
// the plan's pieces.  False where the wrapper's choices do not fit: vec
// must be 1, 2, 4 or 8, at most max_vec (4 for float32 Wh, 8 for bf16),
// and divide D, lane_floats be a power of two from vec to kLaneFloatsMax,
// and the plan's scratch be there and aligned for vec floats.
inline bool head_shape(int num_rows, int H, int D, int vec, int max_vec,
                       int lane_floats, const RowPlan& p, dim3& grid,
                       HeadWalk& s) {
  if (!(vec == 1 || vec == 2 || vec == 4 || vec == 8) || vec > max_vec ||
      H <= 0 || D <= 0 || D % vec != 0 || lane_floats < vec ||
      lane_floats > kLaneFloatsMax ||
      (lane_floats & (lane_floats - 1)) != 0 || p.T <= 0 ||
      !aligned(p.partial, vec_bytes<float>(vec)) ||
      (p.num_pieces > 0 && p.partial == nullptr))
    return false;
  const int per_head = D / vec;                 // V-column chunks of a head
  const int max_nc = lane_floats / vec;
  const int lh = pow2_at_least((per_head + max_nc - 1) / max_nc);
  s.Lh = lh < 32 ? lh : 32;
  const int nc = pow2_at_least((per_head + s.Lh - 1) / s.Lh);
  s.NC = nc < max_nc ? nc : max_nc;
  const int cols = s.Lh * vec * s.NC;
  s.nchunk = (D + cols - 1) / cols;
  const int lanes = s.Lh * pow2_at_least(H);
  s.lanes = lanes < 32 ? lanes : 32;
  s.Hp = s.lanes / s.Lh;
  const int64_t items = (int64_t)p.num_pieces + num_rows;
  grid = dim3((unsigned)((items + kWarps - 1) / kWarps));
  return true;
}

// The calling lane's place in a head-major pass over heads [h0, h0 + Hp)
// of H and columns from c0 of each head.
template <int NC>
struct HeadLane {
  int h;                    // the lane's head
  int q;                    // its place among the head's Lh lanes
  bool on;                  // the head is in the pass
  int col[NC];              // first column of each of its V-column chunks
  bool cok[NC];             // that chunk is in the head
};

template <int V, int NC>
__device__ __forceinline__ HeadLane<NC> head_lane(const HeadWalk& s, int h0,
                                                  int H, int c0, int D) {
  const int sub = (threadIdx.x & 31) & (s.lanes - 1);
  HeadLane<NC> L;
  L.h = h0 + sub / s.Lh;
  L.q = sub & (s.Lh - 1);
  L.on = L.h < H;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    L.col[k] = c0 + (L.q + k * s.Lh) * V;
    L.cok[k] = L.on && L.col[k] < D;
  }
  return L;
}

// The sum of x over the Lh aligned lanes of a head, by xor shuffles: every
// lane of the head adds the same two values at each step (a + b in one, b +
// a in the other), so all get the same bits.  Called by all 32 lanes.
__device__ __forceinline__ float head_sum(float x, int Lh) {
  for (int off = Lh >> 1; off >= 1; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The fixed-order tree over the lane groups (lanes of equal place in
// their group): group 0 ends with the sum.  Called by all 32 lanes.
__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int off = 16; off >= lanes; off >>= 1)
    x += __shfl_down_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.0f ? x : slope * x;
}

// Runs L::go<V, W, NC>(args...) for the run-time vec (1, 2, 4, and 8
// where kWide: bf16 Wh), a weight that is there (W = 1) or not (W = 0) and
// s.NC, over the cases with NC * V <= kLaneFloatsMax: the kernels are
// compiled per case.
template <class L, int V, int W, class... A>
void head_launch_nc(const HeadWalk& s, const A&... args) {
  if (s.NC == 1) {
    L::template go<V, W, 1>(args...);
  } else if (s.NC == 2) {
    if constexpr (2 * V <= kLaneFloatsMax) L::template go<V, W, 2>(args...);
  } else if (s.NC == 4) {
    if constexpr (4 * V <= kLaneFloatsMax) L::template go<V, W, 4>(args...);
  } else {
    if constexpr (8 * V <= kLaneFloatsMax) L::template go<V, W, 8>(args...);
  }
}

template <class L, int V, class... A>
void head_launch_w(bool w_on, const HeadWalk& s, const A&... args) {
  if (w_on)
    head_launch_nc<L, V, 1>(s, args...);
  else
    head_launch_nc<L, V, 0>(s, args...);
}

template <class L, bool kWide, class... A>
void head_launch(int vec, bool w_on, const HeadWalk& s, const A&... args) {
  if (vec == 8) {
    if constexpr (kWide) head_launch_w<L, 8>(w_on, s, args...);
  } else if (vec == 4)
    head_launch_w<L, 4>(w_on, s, args...);
  else if (vec == 2)
    head_launch_w<L, 2>(w_on, s, args...);
  else
    head_launch_w<L, 1>(w_on, s, args...);
}

}  // namespace
