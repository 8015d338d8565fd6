// K2: fused GAT forward edge phase (float32 sums over float32 or bf16 Wh).
//
// For every dst v, over its CSC in-edges e = (u -> v), per head h:
//   logit = leaky(el[u,h] + er[v,h])
//   p     = exp(logit - shift[v,h])
//   num[v,h,:] += p * w[e,h] * Wh[u,h,:]      (w = 1 when absent)
//   den[v,h]   += p
//   rst = num / den, and 0 where den == 0.
// shift is an input: in "shift" mode (the default) the upper bound
// leaky(max_u el[u,h] + er[v,h]) over all u; in "exact" mode the per-dst
// max, which the wrapper takes first: by monotony of leaky and of the
// rounded add, max_u leaky(el[u,h] + er[v,h]) = leaky(max_u el[u,h] +
// er[v,h]) bit for bit, so the exact max is K4 (segment max) over el on the
// same CSC rows and two elementwise ops, with -1e30 for an empty row
// (gat_kernel.py:exact_shift).  That first pass fixes each row's max before
// any sum, so a long row's pieces all subtract the same max and the fix-up
// only adds; no piece rescales its partials.  Outputs rst (N, H*D) and den
// (N, H); the backward reuses den and shift.  Edges are in internal (CSC)
// order, so w is indexed by the CSC position itself.
//
// Replaces the TPU kernels dgl_hack_tpu/ops/pallas/gat_kernel.py
// _gat_kernel_shift (shift mode) and _gat_kernel (online-max "exact"),
// launched by _gat_chunk_call, with their packed z (_unpack_z: bf16
// features, float32 logits): Wh is float32 or bf16 (gat_fwd_bf16: the
// packed GAT's rounded copy, or a bf16 gat_attention's own rows), read
// widened to float; el, er, w, shift, num and den stay float32, and rst is
// written in float32 (the wrapper rounds a bf16 caller's result once).
//
// Bound on the H100: bytes.  Per edge it gathers one Wh row (4*H*D B: 256
// at H = 8, D = 8) and one el row (4*H B), and streams the index (4 B) and
// 4*H B of w when given; per row it writes 4*(H*D + H) B.  Wh at synthetic
// Reddit is 60 MB, just over the 50 MB L2.  The exp and the D multiply-adds
// per (edge, head) sit far below the fp32 rate.  What held the first design
// back was latency: one edge at a time behind its index load, 4-byte loads,
// the exp redone by each of a head's D lanes, and one warp for a whole hub
// row.
//
// Design: rowwalk.cuh's head-major walk.
// * Work items from the CSC row plan (graph_row_plan(g, "csc")): a warp owns
//   a row of at most T = 256 edges or one piece of a longer row; a piece
//   writes its partial num (H*D) and den (H) to scratch, and gat_fwd_fixup
//   adds a long row's partials in piece order and divides.
// * walk_edges with the src indices loaded a chunk ahead; each lane group
//   takes kUnroll edges at a time, so a warp has up to 32 / lanes * kUnroll
//   Wh rows in flight; Wh is read V = 4, 2 or 1 floats at a time, w with
//   streaming loads (read once, evicted first, so Wh keeps the L2).
// * A head gets as few lanes as hold its D columns at 8 floats a lane
//   (gat_kernel.py:K2_LANE_FLOATS; one lane of two float4 at D = 8, eight
//   lanes at D = 41): each computes the head's logit and exp once per edge,
//   not each of D lanes, and a warp takes more edges at once (four groups
//   of 8 lanes at H = 8).
// * num and den stay in registers; the lane groups combine in a fixed tree
//   at the end of the item.  No shared memory, no atomics: results repeat
//   bitwise.
// * No feature slices: slices of whole heads lost on the card at every
//   width (PERF.md), since Wh at Reddit (60 MB) nearly fits the L2 whole.
// * bf16 Wh halves the gathered row (128 B at H = 8, D = 8).  On this
//   walk (gat_fwd_bf16, a lane loading V = 4 or 8 bf16 values:
//   gat_kernel.py:K2_BF16_VALUES) it bought no time: on an H100 (80GB
//   HBM3, 700 W) 2.06 ms against float32's 1.83 at synthetic Reddit's
//   hidden layer, 2.35 against 2.11 at H = 1, D = 41 (PERF.md).  The rows
//   a warp has in flight sit in registers (kUnroll edges a lane group),
//   so memory-level parallelism is paid in registers, and the bf16 build
//   took more of them (112 against 98) just where the bytes got cheaper.
//
// The staged route (gat_fwd_bf16_staged, below; the wrapper's rule,
// gat_kernel.py:gat_route, takes it for every bf16 Wh whose heads fit one
// lane group): stage.cuh's walk copies each edge's Wh row, el row and w
// row into a per-warp ring in shared memory with cp.async and works on
// one stage while the next arrives; the lane layout, the fixed-order sums
// and the fix-up are the walk's above, so results repeat bitwise (and
// equal the head-major walk's at 32 edges a stage).  A head width whose
// bf16 row is no whole number of 16-byte pieces (H*D not a multiple of
// 8: the output layer's 41) reads the wrapper's copy padded with zero
// columns to Dp (48), and rst is written at D.  What bounds it: the
// gathered rows come from the L2 (Wh in bf16 is 30 MB at Reddit), at
// 192 B an edge at H = 8, D = 8, and each warp's ring costs shared memory,
// so fewer and smaller stages hold more warps: 2 stages of 16 edges won
// (chip_smoke.py's sweep).  On the H100 at synthetic Reddit's hidden
// layer it takes 1.44 ms against float32's 1.88 and the head-major
// walk's 2.05 over the same bf16 Wh, and 1.48 against 2.10 and 2.33 at
// H = 1, D = 41 (PERF.md).
#include "stage.cuh"

namespace {

template <class TW>
struct Args {
  const int* indptr;    // CSC
  const int* src;       // src of each CSC edge
  const TW* wh;         // (N_src, H*D), float or bf16
  const float* el;      // (N_src, H)
  const float* er;      // (N_dst, H)
  const float* w;       // (E, H) in CSC order, or NULL
  const float* shift;   // (N_dst, H)
  float* rst;           // (N_dst, H*D)
  float* den;           // (N_dst, H)
  int num_dst, H, D;
  float slope;
  RowPlan plan;         // partial: (P, H*D) num, then (P, H) den
};

// grid of head_shape; TW: Wh's type; W: attn_w given; NC: s.NC
template <class TW, int V, int W, int NC>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_kernel(Args<TW> a, HeadWalk s) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_dst, it)) return;  // warp-uniform
  const int H = a.H, D = a.D;
  const int64_t HD = (int64_t)H * D;
  const bool piece = it.piece >= 0;
  float* num_row =
      piece ? a.plan.partial + it.piece * HD : a.rst + it.row * HD;
  float* den_row = piece ? a.plan.partial + a.plan.num_pieces * HD +
                               it.piece * H
                         : a.den + it.row * H;
  const int grp = (threadIdx.x & 31) / s.lanes;
  for (int h0 = 0; h0 < H; h0 += s.Hp) {        // warp-uniform
    for (int ch = 0; ch < s.nchunk; ++ch) {          // warp-uniform
      const HeadLane<NC> L =
          head_lane<V, NC>(s, h0, H, ch * s.Lh * V * NC, D);
      const float erv = L.on ? __ldg(a.er + it.row * H + L.h) : 0.0f;
      const float sh = L.on ? __ldg(a.shift + it.row * H + L.h) : 0.0f;
      float num[NC][V], dsum = 0.0f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) num[k][i] = 0.0f;
      walk_edges<W != 0>(
          it.beg, it.end, a.src, nullptr, s.lanes,
          [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
              const bool (&ok)[kUnroll]) {
        float elv[kUnroll], wv[kUnroll], xv[kUnroll][NC][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          elv[u] = 0.0f;
          wv[u] = 1.0f;
#pragma unroll
          for (int k = 0; k < NC; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) xv[u][k][i] = 0.0f;
          if (ok[u] && L.on) {
            elv[u] = __ldg(a.el + row[u] * H + L.h);
            if (W) wv[u] = __ldcs(a.w + e[u] * H + L.h);   // read once
#pragma unroll
            for (int k = 0; k < NC; ++k)
              if (L.cok[k])
                load<V>(a.wh + row[u] * HD + (int64_t)L.h * D + L.col[k],
                        xv[u][k]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u] && L.on) {
            const float p = expf(leaky(elv[u] + erv, a.slope) - sh);
            const float pw = W ? p * wv[u] : p;
            dsum += p;
#pragma unroll
            for (int k = 0; k < NC; ++k)
#pragma unroll
              for (int i = 0; i < V; ++i)
                num[k][i] = fmaf(pw, xv[u][k][i], num[k][i]);
          }
        }
      });
      dsum = group_sum(dsum, s.lanes);
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) num[k][i] = group_sum(num[k][i], s.lanes);
      if (grp == 0 && L.on) {
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (!L.cok[k]) continue;
          if (!piece)
#pragma unroll
            for (int i = 0; i < V; ++i)
              num[k][i] = dsum > 0.0f ? num[k][i] / dsum : 0.0f;
          store<V>(num_row + (int64_t)L.h * D + L.col[k], num[k]);
        }
        if (ch == 0 && L.q == 0) den_row[L.h] = dsum;
      }
    }
  }
}

// rst and den of each long row: its pieces' partial num and den added in
// piece order, then divided.  grid (L, ceil(H*D / kFixCols)).
__global__ void __launch_bounds__(kFixCols)
gat_fwd_fixup(RowPlan p, float* rst, float* den, int H, int D) {
  const int64_t HD = (int64_t)H * D;
  const int64_t f = (int64_t)blockIdx.y * kFixCols + threadIdx.x;
  if (f >= HD) return;
  const int l = blockIdx.x;
  const int h = (int)(f / D);
  const float* pnum = p.partial;
  const float* pden = p.partial + (int64_t)p.num_pieces * HD;
  float n = 0.0f, d = 0.0f;
  for (int q = p.piece_ptr[l]; q < p.piece_ptr[l + 1]; ++q) {
    n += pnum[(int64_t)q * HD + f];
    d += pden[(int64_t)q * H + h];
  }
  const int64_t r = p.long_rows[l];
  rst[r * HD + f] = d > 0.0f ? n / d : 0.0f;
  if (f % D == 0) den[r * H + h] = d;
}

template <class TW>
struct Launch {
  template <int V, int W, int NC>
  static void go(const dim3& grid, const cudaStream_t& stream,
                 const Args<TW>& a, const HeadWalk& s) {
    gat_fwd_kernel<TW, V, W, NC><<<grid, kWarps * 32, 0, stream>>>(a, s);
  }
};

template <class TW>
int gat_fwd(const int* indptr, const int* src, const TW* wh, const float* el,
            const float* er, const float* w, const float* shift, float* rst,
            float* den, int num_dst, int H, int D, float slope, int vec,
            int lane_floats, int T, const int* long_rows,
            const int* piece_ptr, const int* pieces, const int* piece_row,
            int num_long, int num_pieces, float* partial,
            cudaStream_t stream) {
  if (num_dst <= 0 || H <= 0 || D <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  dim3 grid;
  HeadWalk s;
  constexpr bool kWide = sizeof(TW) == 2;
  if (!head_shape(num_dst, H, D, vec, kWide ? 8 : 4, lane_floats, plan, grid,
                  s) ||
      !aligned(wh, vec_bytes<TW>(vec)) ||
      !aligned(rst, vec_bytes<float>(vec)) || shift == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args<TW> a{indptr, src, wh, el, er, w, shift, rst, den, num_dst, H,
                   D, slope, plan};
  head_launch<Launch<TW>, kWide>(vec, w != nullptr, s, grid, stream, a, s);
  const int64_t HD = (int64_t)H * D;
  if (num_long > 0)
    gat_fwd_fixup<<<dim3((unsigned)num_long,
                         (unsigned)((HD + kFixCols - 1) / kFixCols)),
                    kFixCols, 0, stream>>>(plan, rst, den, H, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The staged route (gat_fwd_bf16_staged): the same function over a bf16 Wh
// whose rows the warp gathers through its shared-memory ring (stage.cuh).
// An edge's record: its Wh row (2*H*Dp bytes, Dp >= D: the wrapper's copy
// with each head padded by zero columns where 2*H*D is no multiple of 16),
// its el row (4*H) and its w row (4*H, by CSC position).
struct StagedArgs {
  const int* indptr;    // CSC
  const int* src;       // src of each CSC edge
  const float* er;      // (N_dst, H)
  const float* shift;   // (N_dst, H)
  float* rst;           // (N_dst, H*D)
  float* den;           // (N_dst, H)
  int num_dst, H, D, Dp;
  float slope;
  RowPlan plan;         // partial: (P, H*D) num, then (P, H) den
  Staging st;
};

// grid of staged_shape, kStageWarps warps a block; W: attn_w given; NC: s.NC
template <int V, int W, int NC>
__global__ void __launch_bounds__(kStageWarps * 32)
gat_fwd_staged_kernel(StagedArgs a, HeadWalk s) {
  extern __shared__ __align__(16) char smem[];
  WorkItem it;
  if (!staged_item(a.plan, a.indptr, a.num_dst, it)) return;  // warp-uniform
  const int H = a.H, D = a.D;
  const int64_t HD = (int64_t)H * D;
  const bool piece = it.piece >= 0;
  float* num_row =
      piece ? a.plan.partial + it.piece * HD : a.rst + it.row * HD;
  float* den_row = piece ? a.plan.partial + a.plan.num_pieces * HD +
                               it.piece * H
                         : a.den + it.row * H;
  const int grp = (threadIdx.x & 31) / s.lanes;
  const int groups = 32 / s.lanes;
  char* ring = smem + (threadIdx.x >> 5) * a.st.S * a.st.stage;
  const HeadLane<NC> L = head_lane<V, NC>(s, 0, H, 0, a.Dp);
  const float erv = L.on ? __ldg(a.er + it.row * H + L.h) : 0.0f;
  const float sh = L.on ? __ldg(a.shift + it.row * H + L.h) : 0.0f;
  const int rec = a.st.rec, off_el = a.st.seg[1].off,
            off_w = a.st.seg[2].off, xoff = L.h * a.Dp;
  float num[NC][V], dsum = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) num[k][i] = 0.0f;
  staged_walk(it.beg, it.end, a.src, nullptr, a.st, ring,
              [&](const char* stg, int n) {
    if (!L.on) return;
#pragma unroll 2
    for (int t = grp; t < n; t += groups) {
      const char* r = stg + t * rec;
      const float elv = reinterpret_cast<const float*>(r + off_el)[L.h];
      const float p = expf(leaky(elv + erv, a.slope) - sh);
      const float pw =
          W ? p * reinterpret_cast<const float*>(r + off_w)[L.h] : p;
      dsum += p;
      const bf16* x = reinterpret_cast<const bf16*>(r) + xoff;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (!L.cok[k]) continue;
        float xv[V];
        lds<V>(x + L.col[k], xv);
#pragma unroll
        for (int i = 0; i < V; ++i) num[k][i] = fmaf(pw, xv[i], num[k][i]);
      }
    }
  });
  dsum = group_sum(dsum, s.lanes);
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) num[k][i] = group_sum(num[k][i], s.lanes);
  if (grp == 0 && L.on) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (!L.cok[k]) continue;
      if (!piece)
#pragma unroll
        for (int i = 0; i < V; ++i)
          num[k][i] = dsum > 0.0f ? num[k][i] / dsum : 0.0f;
      store_cols<V>(num_row + (int64_t)L.h * D, L.col[k], D, num[k]);
    }
    if (L.q == 0) den_row[L.h] = dsum;
  }
}

struct StagedLaunch {
  template <int V, int W, int NC>
  static void go(const dim3& grid, const int& smem,
                 const cudaStream_t& stream, const StagedArgs& a,
                 const HeadWalk& s) {
    auto kernel = gat_fwd_staged_kernel<V, W, NC>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kernel<<<grid, kStageWarps * 32, smem, stream>>>(a, s);
  }
};

}  // namespace

// vec: values per load of Wh and floats per store of rst (1, 2, 4, and 8
// for bf16 Wh; divides D); lane_floats: the most values of an edge's row a
// lane holds (head_shape); T, long_rows, piece_ptr, pieces, piece_row,
// num_long, num_pieces: the CSC row plan of spmm_kernel.py:row_plan;
// partial: num_pieces * (H*D + H) floats.
extern "C" int gat_fwd_f32(const int* indptr, const int* src, const float* wh,
                           const float* el, const float* er, const float* w,
                           const float* shift, float* rst, float* den,
                           int num_dst, int H, int D, float slope, int vec,
                           int lane_floats, int T,
                           const int* long_rows, const int* piece_ptr,
                           const int* pieces, const int* piece_row,
                           int num_long, int num_pieces, float* partial,
                           cudaStream_t stream) {
  return gat_fwd<float>(indptr, src, wh, el, er, w, shift, rst, den, num_dst,
                        H, D, slope, vec, lane_floats, T, long_rows,
                        piece_ptr, pieces, piece_row, num_long, num_pieces,
                        partial, stream);
}

extern "C" int gat_fwd_bf16(const int* indptr, const int* src, const bf16* wh,
                            const float* el, const float* er, const float* w,
                            const float* shift, float* rst, float* den,
                            int num_dst, int H, int D, float slope, int vec,
                            int lane_floats, int T,
                            const int* long_rows, const int* piece_ptr,
                            const int* pieces, const int* piece_row,
                            int num_long, int num_pieces, float* partial,
                            cudaStream_t stream) {
  return gat_fwd<bf16>(indptr, src, wh, el, er, w, shift, rst, den, num_dst,
                       H, D, slope, vec, lane_floats, T, long_rows,
                       piece_ptr, pieces, piece_row, num_long, num_pieces,
                       partial, stream);
}

// The staged route over a bf16 Wh (stage.cuh).  wh: (N_src, H*Dp), Dp >=
// D, zero in each head's columns [D, Dp), 2*H*Dp a multiple of 16 and wh
// 16-byte aligned; rst and den at the caller's width D.  vec: values per
// shared-memory load of Wh and floats per store of rst (1, 2, 4 or 8;
// divides Dp); lane_floats as gat_fwd_bf16; stages (2-4), chunk (8, 16 or
// 32 edges a stage); el_gran, w_gran: bytes a copy of an el row and of a
// w row (16, 8 or 4, dividing 4*H and the pointer's alignment); the rest
// as gat_fwd_bf16.
extern "C" int gat_fwd_bf16_staged(const int* indptr, const int* src,
                                   const bf16* wh, const float* el,
                                   const float* er, const float* w,
                                   const float* shift, float* rst,
                                   float* den, int num_dst, int H, int D,
                                   int Dp, float slope, int vec,
                                   int lane_floats, int stages, int chunk,
                                   int el_gran, int w_gran, int T,
                                   const int* long_rows,
                                   const int* piece_ptr, const int* pieces,
                                   const int* piece_row, int num_long,
                                   int num_pieces, float* partial,
                                   cudaStream_t stream) {
  if (num_dst <= 0 || H <= 0 || D <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  dim3 grid;
  HeadWalk s;
  if (Dp < D || (2 * H * Dp) % 16 != 0 || shift == nullptr ||
      !staged_shape(num_dst, H, Dp, vec, lane_floats, plan, grid, s) ||
      !aligned(rst, vec_bytes<float>(vec)))
    return (int)cudaErrorInvalidValue;
  Staging st{};
  st.S = stages;
  st.C = chunk;
  add_segment(st, 0, wh, 2 * H * Dp, 16, 0);
  add_segment(st, 1, el, 4 * H, el_gran, 0);
  add_segment(st, 2, w, w != nullptr ? 4 * H : 0, w_gran, 1);
  const int smem = staging_bytes(st);
  if (smem < 0 || smem > kSharedMax) return (int)cudaErrorInvalidValue;
  const StagedArgs a{indptr, src, er, shift, rst, den, num_dst, H, D, Dp,
                     slope, plan, st};
  head_launch<StagedLaunch, true>(vec, w != nullptr, s, grid, smem, stream,
                                  a, s);
  const int64_t HD = (int64_t)H * D;
  if (num_long > 0)
    gat_fwd_fixup<<<dim3((unsigned)num_long,
                         (unsigned)((HD + kFixCols - 1) / kFixCols)),
                    kFixCols, 0, stream>>>(plan, rst, den, H, D);
  return (int)cudaGetLastError();
}
