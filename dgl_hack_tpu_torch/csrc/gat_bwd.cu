// K3: fused GAT backward edge phase (float32 sums over float32 or bf16 Wh).
//
// For every src u, over its CSR out-edges e = (u -> v) (internal edge id
// e = csr_eids[k], v = dst_csr[k]), per head h:
//   raw    = el[u,h] + er[v,h]
//   a      = exp(min(leaky(raw) - shift[v,h], 60)) / (den[v,h] or 1)
//   daw    = <Wh[u,h,:], dout[v,h,:]>
//   aw     = a * w[e,h],  da = daw * w[e,h]          (w = 1 when absent)
//   dlogit = a * (da - sds[v,h])
//   draw   = dlogit * leaky'(raw)
//   dWh[u,h,:] += aw * dout[v,h,:]
//   del[u,h]   += draw
//   draw_out[e,h] = draw;  dw[e,h] = a * daw  (when w is given and dw
//   is asked for: GAT's attention dropout needs no dw)
// sds[v,h] = <rst[v,h,:], dout[v,h,:]> comes from the caller; der is the
// CSC-direction segment sum of draw_out (K1 in edge-row mode).
//
// Replaces the TPU kernel dgl_hack_tpu/ops/pallas/gat_kernel.py
// _gat_bwd_kernel, launched by _gat_bwd_call / _run_gat_bwd_fused; the
// math is that kernel's and the legacy path's (_gat_fused_bwd).  Wh is
// float32 or bf16 (gat_bwd_bf16: the packed GAT differentiates the
// bf16-feature function its forward ran, _gat_fused_bwd's zt, with the
// same rounded copy of Wh; a bf16 gat_attention its own rows); dout and
// the dst pack are float32 (the JAX backward casts g up), and dWh, del,
// draw and dw are written in float32.  The TPU
// version expanded src windows to slots with one-hot matmuls and sent
// per-slot outputs back to edge order with an inverse-slot gather; here a
// warp walks a src row's out-edges and writes per-edge outputs at their
// internal edge id directly.
//
// Bound on the H100: bytes.  Per edge it gathers one dout row (4*H*D B: 256
// at H = 8, D = 8) and er/shift/den/sds of the dst (16*H B), streams the
// indices (8 B) and 4*H B of w when given, and writes 4*H B of draw (and
// of dw); per src row it reads Wh and el once and writes 4*(H*D + H) B.
// draw and dw are written as 4*H-byte pieces of (E, H) arrays in CSR order,
// i.e. scattered 32-byte sectors at H = 8.  The dot and the exp per (edge,
// head) sit far below the fp32 rate.  The first design was held back by
// latency: one edge at a time behind three dependent memory round trips
// and two __syncwarp, a per-head dot summed by one lane per head from
// shared memory (31 of 32 lanes idle at H = 1), Wh[u] reloaded per edge,
// 4-byte loads, and one warp for a whole hub row.
//
// Design: rowwalk.cuh's head-major walk.
// * Work items from the CSR row plan (graph_row_plan(g, "csr")): a warp owns
//   a src row of at most T = 256 edges or one piece of a longer row.  A
//   piece writes its partial dWh (H*D) and del (H) rows to scratch and
//   row_fixup adds a long row's partials in piece order; draw and dw of an
//   edge are written by the piece that owns it.
// * walk_edges over dst_csr with csr_eids, indices loaded a chunk ahead,
//   kUnroll edges per lane group in flight, dout read V floats at a time.
// * The dst's er, shift, den and sds come packed in one (N, H, 4) array
//   that the wrapper makes per backward (30 MB at Reddit): one 16-byte
//   load per (edge, head) where four 4-byte loads were four scattered
//   requests.  w is read and draw and dw written with streaming accesses
//   (touched once, evicted first), and dw only where attn_w wants a
//   gradient (GAT's dropout mask does not).
// * A head gets as few lanes as hold its D columns at 4 floats a lane
//   (gat_kernel.py:K3_LANE_FLOATS; K3 holds more per column than K2, and 8
//   cost it occupancy).  Wh[u, h] and el[u, h] sit in registers across the
//   item; the dWh and del accumulators too.  The per-head dot is each
//   lane's fixed fma chain over its columns, then head_sum's xor shuffles
//   over the head's lanes (all get the same bits); the epilogue runs in
//   every lane of a head, so no lane waits for another.  No shared memory
//   and no __syncwarp in the edge loop; the lane groups combine in a fixed
//   tree at the end of the item.
// * A head wider than one pass (D > 128) goes in passes of 128 columns;
//   each pass adds its part of daw to draw_out[e, h], which the lane that
//   owns (e, h) reads back in the next pass, and the last pass finishes
//   draw, dw and del.  So every H*D that K2 takes, K3 takes, with no
//   shared-memory limit.
// * No atomics: every result repeats bitwise.  No feature slices: on the
//   card a slice of whole heads cost about a whole unsliced pass (PERF.md:
//   the time goes per edge, not per byte).
// What is left on this walk: at H = 1 the per-edge requests (dout, the
// packed dst row, w, draw) are 4-byte-wide scattered sectors, and the
// registers of four edges in flight allow 16 warps an SM, so the output
// layer runs at latency, not bandwidth.  bf16 Wh is read once per item,
// so it saved nothing here (gat_bwd_bf16: 4.38 against float32's 4.40 ms
// at Reddit's hidden layer, on an H100 80GB HBM3 at 700 W; PERF.md).
//
// The staged route (gat_bwd_bf16_staged, below; gat_kernel.py:gat_route
// takes it for a bf16 Wh whose heads fit one lane group): stage.cuh's
// walk copies each edge's dout row, packed dst row and w row into a
// per-warp ring in shared memory with cp.async while the warp works on
// the stage before.  Two more things cut what it gathers:
// * dout is gathered in bf16 where its values are bf16 ones (a bf16
//   gat_attention: GatFused rounds the result to bf16, so the cotangent
//   that reaches it is too; gat_kernel.py:bf16_dout), which halves the
//   row and gives the same bits; beside a float32 fsrc, packed or not, it
//   stays float32;
// * the dst rows that K3 gathers (dout and the pack: 90 MB at Reddit's
//   hidden layer in float32) do not fit the 50 MB L2, so where they exceed
//   gat_kernel.py:K3_PASS_BYTES the wrapper launches the kernel in passes
//   over ranges of dst nodes (a CSR row's edges are sorted by dst, so a
//   pass takes a run of each row, from gat_kernel.py:dst_cuts); a pass
//   after the first adds to the dWh and del rows before it, in pass order,
//   so results still repeat bitwise.
// What bounds it: the gathered rows from the L2 (384 B an edge at H = 8,
// D = 8 with a float32 dout) and w's and draw's scattered 32-byte sectors
// in device memory.  On the H100 at synthetic Reddit's hidden
// layer, no dw: 3.69 ms (float32 dout, 3 passes) and 3.16 (bf16 dout, 2
// passes) against the head-major walk's 4.35 over the same bf16 Wh and
// float32's 4.47; 3.58 and 3.37 against 4.82 and 4.83 at H = 1, D = 41
// (chip_smoke.py; PERF.md).
#include "stage.cuh"

namespace {

template <class TW>
struct Args {
  const int* indptr;    // CSR
  const int* eids;      // csr_eids: internal edge id of each CSR edge
  const int* dst;       // dst of each CSR edge
  const TW* wh;         // (N_src, H*D), float or bf16
  const float* el;      // (N_src, H)
  const float4* dstp;   // (N_dst, H) of (er[v,h], shift, den, sds)
  const float* dout;    // (N_dst, H*D)
  const float* w;       // (E, H) or NULL
  float* dwh;           // (N_src, H*D)
  float* del;           // (N_src, H)
  float* draw;          // (E, H)
  float* dw;            // (E, H), or NULL; only with w
  int num_src, H, D;
  float slope;
  RowPlan plan;         // partial: (P, H*D) dWh, then (P, H) del
};

// grid of head_shape; TW: Wh's type; W: attn_w given; NC: s.NC
template <class TW, int V, int W, int NC>
__global__ void __launch_bounds__(kWarps * 32)
gat_bwd_kernel(Args<TW> a, HeadWalk s) {
  WorkItem it;
  if (!work_item(a.plan, a.indptr, a.num_src, it)) return;  // warp-uniform
  const int H = a.H, D = a.D;
  const int64_t HD = (int64_t)H * D;
  const bool piece = it.piece >= 0;
  float* dwh_row =
      piece ? a.plan.partial + it.piece * HD : a.dwh + it.row * HD;
  float* del_row = piece ? a.plan.partial + a.plan.num_pieces * HD +
                               it.piece * H
                         : a.del + it.row * H;
  const int grp = (threadIdx.x & 31) / s.lanes;
  const float slope = a.slope;
  for (int h0 = 0; h0 < H; h0 += s.Hp) {        // warp-uniform
    float dl = 0.0f;                                 // del of the head
    for (int ch = 0; ch < s.nchunk; ++ch) {          // warp-uniform
      const HeadLane<NC> L =
          head_lane<V, NC>(s, h0, H, ch * s.Lh * V * NC, D);
      const bool last = ch == s.nchunk - 1;
      const float elu = L.on ? __ldg(a.el + it.row * H + L.h) : 0.0f;
      float whu[NC][V], acc[NC][V];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
#pragma unroll
        for (int i = 0; i < V; ++i) whu[k][i] = 0.0f, acc[k][i] = 0.0f;
        if (L.cok[k])
          load<V>(a.wh + it.row * HD + (int64_t)L.h * D + L.col[k], whu[k]);
      }
      walk_edges<true>(
          it.beg, it.end, a.dst, a.eids, s.lanes,
          [&](const int64_t (&row)[kUnroll], const int64_t (&e)[kUnroll],
              const bool (&ok)[kUnroll]) {
        float dv[kUnroll][NC][V];
        float erv[kUnroll], shv[kUnroll], dnv[kUnroll], sdv[kUnroll],
            wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          erv[u] = shv[u] = dnv[u] = sdv[u] = 0.0f;
          wv[u] = 1.0f;
#pragma unroll
          for (int k = 0; k < NC; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) dv[u][k][i] = 0.0f;
          if (ok[u] && L.on) {
            const int64_t vh = row[u] * H + L.h;
            const float4 q = __ldg(a.dstp + vh);    // one 16-byte load
            erv[u] = q.x, shv[u] = q.y, dnv[u] = q.z, sdv[u] = q.w;
            if (W) wv[u] = __ldcs(a.w + e[u] * H + L.h);   // read once
#pragma unroll
            for (int k = 0; k < NC; ++k)
              if (L.cok[k])
                load<V>(a.dout + row[u] * HD + (int64_t)L.h * D + L.col[k],
                        dv[u][k]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float pd = 0.0f;
#pragma unroll
          for (int k = 0; k < NC; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) pd = fmaf(whu[k][i], dv[u][k][i], pd);
          pd = head_sum(pd, s.Lh);                   // all 32 lanes
          if (!(ok[u] && L.on)) continue;
          const float raw = elu + erv[u];
          const float dd = dnv[u];
          const float at =
              expf(fminf(leaky(raw, slope) - shv[u], 60.0f)) /
              (dd > 0.0f ? dd : 1.0f);
          const float aw = W ? at * wv[u] : at;
#pragma unroll
          for (int k = 0; k < NC; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[k][i] = fmaf(aw, dv[u][k][i], acc[k][i]);
          const int64_t eh = e[u] * H + L.h;
          float daw = pd;
          if (s.nchunk > 1) {                        // warp-uniform
            // the head's lane 0 owns (e, h) in every pass of the item
            if (ch > 0) daw = (L.q == 0 ? a.draw[eh] : 0.0f) + pd;
            if (!last && L.q == 0) a.draw[eh] = daw;
          }
          if (last) {
            const float da = W ? daw * wv[u] : daw;
            const float dlogit = at * (da - sdv[u]);
            const float dr = dlogit * (raw >= 0.0f ? 1.0f : slope);
            dl += dr;
            if (L.q == 0) {                // written once: evict first
              __stcs(a.draw + eh, dr);
              if (W && a.dw != nullptr) __stcs(a.dw + eh, at * daw);
            }
          }
        }
      });
#pragma unroll
      for (int k = 0; k < NC; ++k) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = group_sum(acc[k][i], s.lanes);
        if (grp == 0 && L.cok[k])
          store<V>(dwh_row + (int64_t)L.h * D + L.col[k], acc[k]);
      }
      if (last) {
        dl = group_sum(dl, s.lanes);
        if (grp == 0 && L.on && L.q == 0) del_row[L.h] = dl;
      }
    }
  }
}

template <class TW>
struct Launch {
  template <int V, int W, int NC>
  static void go(const dim3& grid, const cudaStream_t& stream,
                 const Args<TW>& a, const HeadWalk& s) {
    gat_bwd_kernel<TW, V, W, NC><<<grid, kWarps * 32, 0, stream>>>(a, s);
  }
};

template <class TW>
int gat_bwd(const int* csr_indptr, const int* csr_eids, const int* dst_csr,
            const TW* wh, const float* el, const float* dst_packed,
            const float* dout, const float* w, float* dwh, float* del,
            float* draw_out, float* dw, int num_src, int H, int D,
            float slope, int vec, int lane_floats, int T,
            const int* long_rows, const int* piece_ptr, const int* pieces,
            const int* piece_row, int num_long, int num_pieces,
            float* partial, cudaStream_t stream) {
  if (num_src <= 0 || H <= 0 || D <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  dim3 grid;
  HeadWalk s;
  constexpr bool kWide = sizeof(TW) == 2;
  const int fbytes = vec_bytes<float>(vec);
  if (!head_shape(num_src, H, D, vec, kWide ? 8 : 4, lane_floats, plan, grid,
                  s) ||
      !aligned(wh, vec_bytes<TW>(vec)) || !aligned(dout, fbytes) ||
      !aligned(dwh, fbytes) || dst_packed == nullptr ||
      !aligned(dst_packed, 16) ||
      (w == nullptr && dw != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<TW> a{csr_indptr, csr_eids, dst_csr, wh, el,
                   reinterpret_cast<const float4*>(dst_packed), dout, w, dwh,
                   del, draw_out, dw, num_src, H, D, slope, plan};
  head_launch<Launch<TW>, kWide>(vec, w != nullptr, s, grid, stream, a, s);
  if (num_long > 0) {
    const int64_t HD = (int64_t)H * D;
    launch_fixup<false>(plan, dwh, (int)HD, stream);
    RowPlan del_plan = plan;
    del_plan.partial = partial + (int64_t)num_pieces * HD;
    launch_fixup<false>(del_plan, del, H, stream);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The staged route (gat_bwd_bf16_staged): the same function over a bf16 Wh
// (read once per item, in registers) whose per-edge rows the warp gathers
// through its shared-memory ring (stage.cuh).  An edge's record: the dst's
// dout row (TD: float32, or bf16 where the caller's dout holds bf16 values
// only, so that the copy is exact; sizeof(TD)*H*Dp bytes, Dp >= D: heads
// padded by zero columns as Wh's), its packed (er, shift, den, sds) (16*H)
// and its w row (4*H, by edge id).
template <class TD>
struct StagedArgs {
  const int* indptr;    // CSR
  const int* eids;      // csr_eids: internal edge id of each CSR edge
  const int* dst;       // dst of each CSR edge
  const bf16* wh;       // (N_src, H*Dp)
  const float* el;      // (N_src, H)
  float* dwh;           // (N_src, H*D)
  float* del;           // (N_src, H)
  float* draw;          // (E, H)
  float* dw;            // (E, H), or NULL; only with w
  int num_src, H, D, Dp;
  float slope;
  RowPlan plan;         // partial: (P, H*D) dWh, then (P, H) del
  Staging st;
  // this launch's range of dst nodes, pass of passes: the edges of CSR row
  // u to dst in the range are [cuts[(pass-1)*N_src + u], cuts[pass*N_src
  // + u]) (the row's start before the first cut, its end after the last)
  const int* cuts;      // (passes - 1, N_src), or NULL for one pass
  int pass, passes;
};

// grid of staged_shape, kStageWarps warps a block; TD: dout's type in the
// records; W: attn_w given; NC: s.NC.  A pass after the first adds to the
// dWh and del rows that the earlier passes wrote.
template <class TD, int V, int W, int NC>
__global__ void __launch_bounds__(kStageWarps * 32)
gat_bwd_staged_kernel(StagedArgs<TD> a, HeadWalk s) {
  extern __shared__ __align__(16) char smem[];
  WorkItem it;
  if (!staged_item(a.plan, a.indptr, a.num_src, it)) return;  // warp-uniform
  const bool add = a.pass > 0;
  if (add) it.beg = max(it.beg, a.cuts[(a.pass - 1) * a.num_src + it.row]);
  if (a.pass < a.passes - 1)
    it.end = min(it.end, a.cuts[a.pass * a.num_src + it.row]);
  if (add && it.end <= it.beg) return;               // warp-uniform
  const int H = a.H, D = a.D, Dp = a.Dp;
  const int64_t HD = (int64_t)H * D;
  const bool piece = it.piece >= 0;
  float* dwh_row =
      piece ? a.plan.partial + it.piece * HD : a.dwh + it.row * HD;
  float* del_row = piece ? a.plan.partial + a.plan.num_pieces * HD +
                               it.piece * H
                         : a.del + it.row * H;
  const int grp = (threadIdx.x & 31) / s.lanes;
  const int groups = 32 / s.lanes;
  char* ring = smem + (threadIdx.x >> 5) * a.st.S * a.st.stage;
  const float slope = a.slope;
  const HeadLane<NC> L = head_lane<V, NC>(s, 0, H, 0, Dp);
  const float elu = L.on ? __ldg(a.el + it.row * H + L.h) : 0.0f;
  float whu[NC][V], acc[NC][V], dl = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) whu[k][i] = 0.0f, acc[k][i] = 0.0f;
    if (L.cok[k])
      load<V>(a.wh + it.row * H * Dp + (int64_t)L.h * Dp + L.col[k], whu[k]);
  }
  const int rec = a.st.rec, off_p = a.st.seg[1].off,
            off_w = a.st.seg[2].off, ids = a.st.C * rec, xoff = L.h * Dp;
  staged_walk(it.beg, it.end, a.dst, a.eids, a.st, ring,
              [&](const char* stg, int n) {
    for (int t0 = 0; t0 < n; t0 += groups) {         // warp-uniform
      const int t = t0 + grp;
      const bool ok = t < n && L.on;
      const char* r = stg + t * rec;
      float dv[NC][V];
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float wv = 1.0f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) dv[k][i] = 0.0f;
      if (ok) {
        q = reinterpret_cast<const float4*>(r + off_p)[L.h];
        if (W) wv = reinterpret_cast<const float*>(r + off_w)[L.h];
        const TD* x = reinterpret_cast<const TD*>(r) + xoff;
#pragma unroll
        for (int k = 0; k < NC; ++k)
          if (L.cok[k]) lds<V>(x + L.col[k], dv[k]);
      }
      float pd = 0.0f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) pd = fmaf(whu[k][i], dv[k][i], pd);
      pd = head_sum(pd, s.Lh);                       // all 32 lanes
      if (!ok) continue;
      const float raw = elu + q.x;
      const float dd = q.z;
      const float at = expf(fminf(leaky(raw, slope) - q.y, 60.0f)) /
                       (dd > 0.0f ? dd : 1.0f);
      const float aw = W ? at * wv : at;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = fmaf(aw, dv[k][i], acc[k][i]);
      const float da = W ? pd * wv : pd;
      const float dlogit = at * (da - q.w);
      const float dr = dlogit * (raw >= 0.0f ? 1.0f : slope);
      dl += dr;
      if (L.q == 0) {                      // written once: evict first
        const int64_t eh =
            (int64_t)reinterpret_cast<const int*>(stg + ids)[t] * H + L.h;
        __stcs(a.draw + eh, dr);
        if (W && a.dw != nullptr) __stcs(a.dw + eh, at * pd);
      }
    }
  });
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = group_sum(acc[k][i], s.lanes);
    if (grp == 0 && L.cok[k])
      store_cols<V>(dwh_row + (int64_t)L.h * D, L.col[k], D, acc[k], add);
  }
  dl = group_sum(dl, s.lanes);
  if (grp == 0 && L.on && L.q == 0)
    del_row[L.h] = add ? del_row[L.h] + dl : dl;
}

template <class TD>
struct StagedLaunch {
  template <int V, int W, int NC>
  static void go(const dim3& grid, const int& smem,
                 const cudaStream_t& stream, const StagedArgs<TD>& a,
                 const HeadWalk& s) {
    auto kernel = gat_bwd_staged_kernel<TD, V, W, NC>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kernel<<<grid, kStageWarps * 32, smem, stream>>>(a, s);
  }
};

template <class TD>
int gat_bwd_staged(const int* csr_indptr, const int* csr_eids,
                   const int* dst_csr, const bf16* wh, const float* el,
                   const float* dst_packed, const TD* dout, const float* w,
                   float* dwh, float* del, float* draw_out, float* dw,
                   int num_src, int H, int D, int Dp, float slope, int vec,
                   int lane_floats, int stages, int chunk, int w_gran,
                   const int* cuts, int pass, int passes,
                   const RowPlan& plan, cudaStream_t stream) {
  dim3 grid;
  HeadWalk s;
  if (Dp < D || (2 * H * Dp) % 16 != 0 || dst_packed == nullptr ||
      !staged_shape(num_src, H, Dp, vec, lane_floats, plan, grid, s) ||
      !aligned(wh, vec_bytes<bf16>(vec)) ||
      !aligned(dwh, vec_bytes<float>(vec)) ||
      (w == nullptr && dw != nullptr) || passes < 1 || pass < 0 ||
      pass >= passes || (passes > 1 && cuts == nullptr))
    return (int)cudaErrorInvalidValue;
  Staging st{};
  st.S = stages;
  st.C = chunk;
  add_segment(st, 0, dout, (int)sizeof(TD) * H * Dp, 16, 0);
  add_segment(st, 1, dst_packed, 16 * H, 16, 0);
  add_segment(st, 2, w, w != nullptr ? 4 * H : 0, w_gran, 1);
  const int smem = staging_bytes(st);
  if (smem < 0 || smem > kSharedMax) return (int)cudaErrorInvalidValue;
  const StagedArgs<TD> a{csr_indptr, csr_eids, dst_csr, wh, el, dwh, del,
                         draw_out, dw, num_src, H, D, Dp, slope, plan, st,
                         cuts, pass, passes};
  head_launch<StagedLaunch<TD>, true>(vec, w != nullptr, s, grid, smem,
                                      stream, a, s);
  if (plan.num_long > 0 && pass == passes - 1) {
    const int64_t HD = (int64_t)H * D;
    launch_fixup<false>(plan, dwh, (int)HD, stream);
    RowPlan del_plan = plan;
    del_plan.partial = plan.partial + (int64_t)plan.num_pieces * HD;
    launch_fixup<false>(del_plan, del, H, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vec: values per load of Wh and dout and floats per store of dWh (1, 2,
// 4, and 8 for bf16 Wh; divides D); lane_floats: the most values of an
// edge's row a lane holds (head_shape); T, long_rows, piece_ptr, pieces,
// piece_row, num_long, num_pieces: the CSR row plan of
// spmm_kernel.py:row_plan; partial: num_pieces * (H*D + H) floats.  dw:
// NULL, or given with w.  dst_packed: (N_dst, H, 4) of er, shift, den and
// sds.
extern "C" int gat_bwd_f32(const int* csr_indptr, const int* csr_eids,
                           const int* dst_csr, const float* wh,
                           const float* el, const float* dst_packed,
                           const float* dout, const float* w,
                           float* dwh, float* del,
                           float* draw_out, float* dw, int num_src, int H,
                           int D, float slope, int vec, int lane_floats,
                           int T, const int* long_rows, const int* piece_ptr,
                           const int* pieces, const int* piece_row,
                           int num_long, int num_pieces, float* partial,
                           cudaStream_t stream) {
  return gat_bwd<float>(csr_indptr, csr_eids, dst_csr, wh, el, dst_packed,
                        dout, w, dwh, del, draw_out, dw, num_src, H, D, slope,
                        vec, lane_floats, T, long_rows, piece_ptr, pieces,
                        piece_row, num_long, num_pieces, partial, stream);
}

extern "C" int gat_bwd_bf16(const int* csr_indptr, const int* csr_eids,
                            const int* dst_csr, const bf16* wh,
                            const float* el, const float* dst_packed,
                            const float* dout, const float* w,
                            float* dwh, float* del,
                            float* draw_out, float* dw, int num_src, int H,
                            int D, float slope, int vec, int lane_floats,
                            int T, const int* long_rows, const int* piece_ptr,
                            const int* pieces, const int* piece_row,
                            int num_long, int num_pieces, float* partial,
                            cudaStream_t stream) {
  return gat_bwd<bf16>(csr_indptr, csr_eids, dst_csr, wh, el, dst_packed,
                       dout, w, dwh, del, draw_out, dw, num_src, H, D, slope,
                       vec, lane_floats, T, long_rows, piece_ptr, pieces,
                       piece_row, num_long, num_pieces, partial, stream);
}

// The staged route over a bf16 Wh (stage.cuh).  wh: (N_src, H*Dp), Dp >=
// D, zero in each head's columns [D, Dp), 2*H*Dp a multiple of 16; dout:
// (N_dst, H*Dp), padded as wh, float32 or, with dout_bf16, bf16, 16-byte
// aligned; dWh, del, draw and dw as gat_bwd_bf16, at the caller's width
// D.  vec: values per load of Wh and of a dout row in shared memory and
// floats per store of dWh (1, 2, 4 or 8; divides Dp); stages (2-4), chunk
// (8, 16 or 32 edges a stage), w_gran (bytes a copy of a w row: 16, 8 or
// 4, dividing 4*H and w's alignment); cuts, pass, passes: this launch's
// range of dst nodes (StagedArgs; the wrapper launches passes 0 .. passes
// - 1 in order, and the fix-up runs after the last); the rest as
// gat_bwd_bf16.
extern "C" int gat_bwd_bf16_staged(const int* csr_indptr,
                                   const int* csr_eids, const int* dst_csr,
                                   const bf16* wh, const float* el,
                                   const float* dst_packed, const void* dout,
                                   const float* w, float* dwh, float* del,
                                   float* draw_out, float* dw, int num_src,
                                   int H, int D, int Dp, float slope,
                                   int vec, int lane_floats, int stages,
                                   int chunk, int dout_bf16, int w_gran,
                                   const int* cuts, int pass, int passes,
                                   int T, const int* long_rows,
                                   const int* piece_ptr, const int* pieces,
                                   const int* piece_row, int num_long,
                                   int num_pieces, float* partial,
                                   cudaStream_t stream) {
  if (num_src <= 0 || H <= 0 || D <= 0) return (int)cudaGetLastError();
  const RowPlan plan{T, long_rows, piece_ptr, pieces, piece_row, num_long,
                     num_pieces, partial};
  if (dout_bf16)
    return gat_bwd_staged<bf16>(
        csr_indptr, csr_eids, dst_csr, wh, el, dst_packed,
        static_cast<const bf16*>(dout), w, dwh, del, draw_out, dw, num_src,
        H, D, Dp, slope, vec, lane_floats, stages, chunk, w_gran, cuts, pass,
        passes, plan, stream);
  return gat_bwd_staged<float>(
      csr_indptr, csr_eids, dst_csr, wh, el, dst_packed,
      static_cast<const float*>(dout), w, dwh, del, draw_out, dw, num_src, H,
      D, Dp, slope, vec, lane_floats, stages, chunk, w_gran, cuts, pass,
      passes, plan, stream);
}
