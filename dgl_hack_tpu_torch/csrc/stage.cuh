// The staged gather walk of K2 and K3 over a bf16 Wh (gat_fwd.cu,
// gat_bwd.cu: gat_fwd_bf16_staged, gat_bwd_bf16_staged).  rowwalk.cuh's
// head-major walk keeps an edge's gathered row in registers from its load
// to its use, so the rows a warp has in flight cost registers: kUnroll
// edges a lane group, and fewer warps an SM where a kernel needs more
// registers.  Here the rows go to shared memory with cp.async (LDGSTS,
// Hopper's asynchronous copy from device memory to shared memory, which
// holds no register while it is in flight):
//
// * Each warp owns a ring of S stages in dynamic shared memory; a stage
//   holds the records of C edges (C = 8, 16 or 32).  An edge's record is
//   up to three segments, each copied whole: the rows gathered by the
//   edge's gather index (K2: its Wh row and its el row; K3: the dst's dout
//   row and its packed (er, shift, den, sds)), and what is indexed by the
//   edge itself (attn_w's row: by its position in K2, by its edge id in
//   K3), copied in 16-, 8- or 4-byte pieces.  attn_w is read once, so its
//   copies carry an L2 evict-first hint and the gathered rows keep the L2.
// * The warp walks its work item (rowwalk.cuh's work_item: a row of at most
//   T edges or one piece of a longer row) in chunks of C edges.  Lane i
//   loads the gather index (and edge id) of each chunk's edge i one chunk
//   before that chunk's copies are issued, so a copy never waits on its own
//   index load; the item's first S chunks' indices come in one round trip.
//   (Loading them four chunks ahead, streaming the outputs past the L2 and
//   capping the registers at 8 blocks an SM were timed and lost: PERF.md.)
// * The copies of chunks c + 1 .. c + S - 1 are in flight while the warp
//   works on chunk c from shared memory (cp.async.wait_group S - 1, then
//   __syncwarp so that every lane sees every lane's copies).  The work on
//   a chunk is that of the head-major walk, with its loads from shared
//   memory: the lane layout, the fixed-order sums and the fix-ups are
//   rowwalk.cuh's, so results repeat bitwise.
// * S, C and the lanes per head are run-time choices of the wrapper
//   (gat_kernel.py: STAGES, STAGE_BYTES, from chip_smoke.py's sweep); the
//   shared memory a block takes is kStageWarps * S * C * record bytes, so
//   fewer and smaller stages hold more warps an SM.
#pragma once
#include "rowwalk.cuh"

namespace {

constexpr int kStageWarps = 4;   // warps per block of a staged kernel
constexpr int kStagesMax = 4;    // most stages in a warp's ring
constexpr int kSharedMax = 232448;  // shared memory a block may take

// One segment of an edge's record: `bytes` bytes at base + idx * bytes,
// where idx is the edge's gather index (by_edge 0) or its edge id (1),
// copied `gran` bytes at a time (16, 8 or 4; divides bytes and the base's
// alignment) by `lanes` lanes an edge (a power of two, at most 32).
struct Segment {
  const char* base;    // NULL: no such segment
  int bytes, gran, lanes, by_edge;
  int off;             // its offset in the record, a multiple of 16
};

struct Staging {
  int S;               // stages in a warp's ring (2 .. kStagesMax)
  int C;               // edges a stage (8, 16 or 32)
  int rec;             // bytes an edge's record (a multiple of 16)
  int stage;           // bytes a stage: C records, then C edge ids
  Segment seg[3];
};

inline int round16(int b) { return (b + 15) / 16 * 16; }

// Appends a segment of `bytes` an edge (0: none) at the record's end.
inline void add_segment(Staging& st, int k, const void* base, int bytes,
                        int gran, int by_edge) {
  Segment& g = st.seg[k];
  g.base = bytes > 0 ? static_cast<const char*>(base) : nullptr;
  g.bytes = bytes;
  g.gran = gran;
  g.by_edge = by_edge;
  g.off = st.rec;
  const int copies = bytes > 0 ? bytes / gran : 1;
  g.lanes = 1;
  while (g.lanes < 32 && g.lanes < copies) g.lanes <<= 1;
  st.rec += round16(bytes);
}

// The block's shared memory, or -1 where S, C, a segment's granule or a
// base's alignment does not fit.
inline int staging_bytes(Staging& st) {
  if (st.S < 2 || st.S > kStagesMax ||
      !(st.C == 8 || st.C == 16 || st.C == 32))
    return -1;
  for (const Segment& g : st.seg) {
    if (g.base == nullptr) continue;
    if (!(g.gran == 4 || g.gran == 8 || g.gran == 16) ||
        g.bytes % g.gran != 0 || !aligned(g.base, g.gran))
      return -1;
  }
  st.stage = st.C * st.rec + round16(4 * st.C);
  return kStageWarps * st.S * st.stage;
}

// 64-bit L2 policy: evict first (for what is read once)
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async(unsigned dst, const char* src,
                                         int gran, bool first,
                                         uint64_t pol) {
  if (first) {
    if (gran == 16)
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
          ::"r"(dst), "l"(src), "l"(pol) : "memory");
    else if (gran == 8)
      asm volatile(
          "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n"
          ::"r"(dst), "l"(src), "l"(pol) : "memory");
    else
      asm volatile(
          "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
          ::"r"(dst), "l"(src), "l"(pol) : "memory");
  } else {
    if (gran == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(dst), "l"(src) : "memory");
    else if (gran == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   ::"r"(dst), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   ::"r"(dst), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most S - 1 groups of the calling thread are in flight.
__device__ __forceinline__ void cp_wait_ring(int S) {
  if (S == 2)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (S == 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Issues the copies of the n edges of a chunk into stage `dst`: edge t's
// gather index is lane t's `row`, its edge id lane t's `e` (also stored at
// the stage's end for the body).  Called by all 32 lanes.
__device__ __forceinline__ void issue_chunk(const Staging& st, char* dst,
                                            int n, int row, int e,
                                            uint64_t pol) {
  const int lane = threadIdx.x & 31;
  if (lane < n) reinterpret_cast<int*>(dst + st.C * st.rec)[lane] = e;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Segment& g = st.seg[k];
    if (g.base == nullptr) continue;                  // warp-uniform
    const int per = 32 / g.lanes;                     // edges a pass
    const int sub = lane & (g.lanes - 1);
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst + g.off);
    for (int t0 = 0; t0 < n; t0 += per) {             // warp-uniform
      const int t = t0 + lane / g.lanes;
      const int idx = __shfl_sync(kFull, g.by_edge ? e : row, t & 31);
      if (t < n) {
        const char* src = g.base + (int64_t)idx * g.bytes;
        const unsigned d = base + t * st.rec;
        for (int q = sub * g.gran; q < g.bytes; q += g.lanes * g.gran)
          cp_async(d + q, src + q, g.gran, g.by_edge != 0, pol);
      }
    }
  }
}

// The warp walks edges [beg, end) in chunks of st.C through its ring
// (`ring`: st.S stages of st.stage bytes), gathering each edge's record as
// above (gather index gidx[j], or j where gidx is NULL; edge id eid[j], or
// j), and calls body(stage, n) on each chunk once its records are in
// shared memory: n edges, edge t's record at stage + t * st.rec and its
// edge id at ((const int*)(stage + st.C * st.rec))[t].  Every lane calls
// body the same number of times, so it may shuffle.
template <class Body>
__device__ __forceinline__ void staged_walk(int beg, int end, const int* gidx,
                                            const int* eid,
                                            const Staging& st, char* ring,
                                            Body body) {
  const int lane = threadIdx.x & 31;
  const int S = st.S, C = st.C;
  const int nc = (end - beg + C - 1) / C;             // chunks
  const uint64_t pol = evict_first_policy();
  int row[kStagesMax], e[kStagesMax];
#pragma unroll
  for (int k = 0; k < kStagesMax; ++k) {              // chunks 0 .. S - 1
    const int j = beg + k * C + lane;
    row[k] = e[k] = 0;
    if (k < S && lane < C && j < end) {
      row[k] = gidx ? __ldg(gidx + j) : j;
      e[k] = eid ? __ldg(eid + j) : j;
    }
  }
#pragma unroll
  for (int k = 0; k < kStagesMax - 1; ++k) {          // issue 0 .. S - 2
    if (k < S - 1) {
      if (k < nc)
        issue_chunk(st, ring + k * st.stage, min(C, end - beg - k * C),
                    row[k], e[k], pol);
      cp_commit();
    }
  }
  int row_n = S == 2 ? row[1] : S == 3 ? row[2] : row[3];
  int e_n = S == 2 ? e[1] : S == 3 ? e[2] : e[3];
  int s_use = 0, s_fill = S - 1;                      // stages of c, c+S-1
  for (int c = 0; c < nc; ++c) {                      // warp-uniform
    const int k = c + S - 1;
    if (k < nc)
      issue_chunk(st, ring + s_fill * st.stage, min(C, end - beg - k * C),
                  row_n, e_n, pol);
    cp_commit();
    const int j = beg + (k + 1) * C + lane;           // chunk k + 1's
    if (lane < C && j < end) {
      row_n = gidx ? __ldg(gidx + j) : j;
      e_n = eid ? __ldg(eid + j) : j;
    }
    cp_wait_ring(S);
    __syncwarp();
    body(static_cast<const char*>(ring + s_use * st.stage),
         min(C, end - beg - c * C));
    __syncwarp();                      // before the stage is filled again
    s_use = s_use + 1 == S ? 0 : s_use + 1;
    s_fill = s_fill + 1 == S ? 0 : s_fill + 1;
  }
}

// V values of a bf16 or float row in shared memory, widened to float
template <int V>
__device__ __forceinline__ void lds(const bf16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    unpack2(t.x, v[0], v[1]); unpack2(t.y, v[2], v[3]);
    unpack2(t.z, v[4], v[5]); unpack2(t.w, v[6], v[7]);
  } else if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    unpack2(t.x, v[0], v[1]); unpack2(t.y, v[2], v[3]);
  } else if constexpr (V == 2) {
    unpack2(*reinterpret_cast<const unsigned*>(p), v[0], v[1]);
  } else {
    v[0] = __uint_as_float(
        (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
  }
}

template <int V>
__device__ __forceinline__ void lds(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

// Stores a lane's V columns [c, c + V) of a row of n columns (none at or
// past column n), or with `add` their sum with what the row holds: whole
// where V divides n (rows then stay aligned for V), else value by value.
template <int V>
__device__ __forceinline__ void store_cols(float* row, int c, int n,
                                           const float (&v)[V],
                                           bool add = false) {
  if (n % V == 0) {
    if (c >= n) return;
    float t[V];
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = v[i];
    if (add) {
      float o[V];
      load<V>(row + c, o);
#pragma unroll
      for (int i = 0; i < V; ++i) t[i] = o[i] + t[i];
    }
    store<V>(row + c, t);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (c + i < n) row[c + i] = add ? row[c + i] + v[i] : v[i];
  }
}

// The grid and head layout of a staged kernel over a head width Dp (the
// staged rows' head width): one pass (nchunk 1, every head in one lane
// group's Hp), else false and the wrapper takes the head-major walk.
inline bool staged_shape(int num_rows, int H, int Dp, int vec,
                         int lane_floats, const RowPlan& p, dim3& grid,
                         HeadWalk& s) {
  if (!head_shape(num_rows, H, Dp, vec, 8, lane_floats, p, grid, s) ||
      s.nchunk != 1 || s.Hp < H)
    return false;
  const int64_t items = (int64_t)p.num_pieces + num_rows;
  grid = dim3((unsigned)((items + kStageWarps - 1) / kStageWarps));
  return true;
}

// The calling warp's item of a staged grid, as work_item (rowwalk.cuh) for
// blocks of kStageWarps warps.
__device__ __forceinline__ bool staged_item(const RowPlan& p,
                                            const int* indptr, int num_rows,
                                            WorkItem& it) {
  const int64_t item =
      (int64_t)blockIdx.x * kStageWarps + (threadIdx.x >> 5);
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

}  // namespace
