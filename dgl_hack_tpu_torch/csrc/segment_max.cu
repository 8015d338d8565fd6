// K4: segment max over the CSC direction, and K5: its argmax backward,
// fused, over the CSR direction (float32).
//
//   K4  raw[r, f] = max_{j in [indptr[r], indptr[r+1])}
//                       max(x[gidx[j], f] * w(j, f), NEG)
//   K5  dx[u, f]  = sum_{j in [csr_indptr[u], csr_indptr[u+1])}
//                       [m == raw[v, f]] * g[v, f] * w(e, f)
//       dw[e]     = sum_f [m == raw[v, f]] * x[u, f] * g[v, f]   (w_kind 1)
//       dw[e, f]  =       [m == raw[v, f]] * x[u, f] * g[v, f]   (w_kind 2)
//   with v = dst_csr[j], e = csr_eids[j], m = max(x[u, f] * w(e, f), NEG).
//
// NEG = -1e30 (MINMAX_NEG of the JAX package); an empty row's raw is NEG and
// the caller zero-fills raw <= NEG / 2.  w_kind: 0 none, 1 scalar per edge
// (E,), 2 full (E, F); K4's edge id is j itself (CSC order is the internal
// edge order).  dw == NULL skips the weight gradient.  min is the caller's
// -max(-x).
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
// the JAX VJP: every tied edge receives the full cotangent.
//
// Bound on the H100: bytes, and the gathered rows rather than the
// compulsory ones.  Compulsory traffic at Reddit F = 602 is x, raw and the
// indices, about 1.2 GB (0.36 ms at 3.35 TB/s), but K4 reads one x row per
// edge (23.5 M x 2.4 KB = 56.6 GB when no row hits L2, ~17 ms) and K5 two
// (x[u] once per src row, raw[v] and g[v] per edge: ~34 ms).  The
// operations (one compare per edge and feature in K4, a compare and an add
// in K5) sit far below the fp32 rate.
//
// Design (simple and right first), as K1: one warp owns one output row,
// so there are no atomics and results repeat bitwise (the max is exact in
// any order; K5 sums in a fixed order).  For F >= 32 the lanes cover
// features, 4 per lane per 128-wide pass.  For F < 32 the warp splits into
// 32/Fp lane groups (Fp = F rounded up to a power of two) that take every
// (32/Fp)-th edge, combined by a fixed shuffle tree.  K5 holds x[u] in
// registers across the row's out-edges.  Left for later: vector loads,
// splitting hub rows across warps, staging raw/g rows in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr float kNeg = -1e30f;   // MINMAX_NEG

__device__ __forceinline__ float weight_of(const float* w, int w_kind,
                                           int64_t e, int64_t F, int64_t f) {
  if (w_kind == 1) return w[e];
  if (w_kind == 2) return w[e * F + f];
  return 1.0f;
}

// max(m, NEG) that keeps a NaN message
__device__ __forceinline__ float clamp_neg(float m) {
  return m < kNeg ? kNeg : m;
}

// running max that propagates NaN, as torch.maximum does
__device__ __forceinline__ float max_nan(float acc, float m) {
  return (m > acc || m != m) ? m : acc;
}

__global__ void segment_max_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ gidx,
                                   const float* __restrict__ x,
                                   const float* __restrict__ w, int w_kind,
                                   float* __restrict__ out, int num_rows,
                                   int F) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= num_rows) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  const int64_t Fl = F;

  if (F < 32) {
    int fp = 1;
    while (fp < F) fp <<= 1;
    const int groups = 32 / fp;
    const int sub = lane % fp;
    const int grp = lane / fp;
    float acc = kNeg;
    if (sub < F) {
      for (int j = beg + grp; j < end; j += groups) {
        const int64_t src = gidx[j];
        const float m = x[src * Fl + sub] * weight_of(w, w_kind, j, Fl, sub);
        acc = max_nan(acc, clamp_neg(m));
      }
    }
    for (int off = 16; off >= fp; off >>= 1)
      acc = max_nan(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (grp == 0 && sub < F) out[row * Fl + sub] = acc;
    return;
  }

  for (int f0 = 0; f0 < F; f0 += 128) {
    float acc[4] = {kNeg, kNeg, kNeg, kNeg};
    for (int j = beg; j < end; ++j) {
      const float* xr = x + (int64_t)gidx[j] * Fl;
      const float ws = (w_kind == 1) ? w[j] : 1.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + lane + 32 * k;
        if (f < F) {
          const float wv = (w_kind == 2) ? w[(int64_t)j * Fl + f] : ws;
          acc[k] = max_nan(acc[k], clamp_neg(xr[f] * wv));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + lane + 32 * k;
      if (f < F) out[row * Fl + f] = acc[k];
    }
  }
}

__global__ void segment_max_bwd_kernel(const int* __restrict__ csr_indptr,
                                       const int* __restrict__ dst_csr,
                                       const int* __restrict__ csr_eids,
                                       const float* __restrict__ x,
                                       const float* __restrict__ w, int w_kind,
                                       const float* __restrict__ raw,
                                       const float* __restrict__ g,
                                       float* __restrict__ dx,
                                       float* __restrict__ dw, int num_src,
                                       int F) {
  const int lane = threadIdx.x & 31;
  const int64_t u = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= num_src) return;
  const int beg = csr_indptr[u];
  const int end = csr_indptr[u + 1];
  const int64_t Fl = F;

  if (F < 32) {
    int fp = 1;
    while (fp < F) fp <<= 1;
    const int groups = 32 / fp;
    const int sub = lane % fp;
    const int grp = lane / fp;
    const float xu = (sub < F) ? x[u * Fl + sub] : 0.0f;
    float acc = 0.0f;
    // every lane runs the same trip count, so the shuffles stay converged
    for (int j0 = beg; j0 < end; j0 += groups) {
      const int j = j0 + grp;
      float dwp = 0.0f;
      int64_t e = 0;
      if (j < end && sub < F) {
        const int64_t v = dst_csr[j];
        e = csr_eids[j];
        const float wt = weight_of(w, w_kind, e, Fl, sub);
        if (clamp_neg(xu * wt) == raw[v * Fl + sub]) {
          const float gv = g[v * Fl + sub];
          acc += gv * wt;
          dwp = xu * gv;
        }
        if (dw != nullptr && w_kind == 2) dw[e * Fl + sub] = dwp;
      }
      if (dw != nullptr && w_kind == 1) {
        for (int off = fp >> 1; off >= 1; off >>= 1)
          dwp += __shfl_xor_sync(0xffffffffu, dwp, off);
        if (sub == 0 && j < end) dw[e] = dwp;
      }
    }
    for (int off = 16; off >= fp; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (grp == 0 && sub < F) dx[u * Fl + sub] = acc;
    return;
  }

  for (int f0 = 0; f0 < F; f0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float xu[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + lane + 32 * k;
      xu[k] = (f < F) ? x[u * Fl + f] : 0.0f;
    }
    for (int j = beg; j < end; ++j) {
      const int64_t v = dst_csr[j];
      const int64_t e = csr_eids[j];
      const float ws = (w_kind == 1) ? w[e] : 1.0f;
      float dwp = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + lane + 32 * k;
        if (f < F) {
          const float wt = (w_kind == 2) ? w[e * Fl + f] : ws;
          float d = 0.0f;
          if (clamp_neg(xu[k] * wt) == raw[v * Fl + f]) {
            const float gv = g[v * Fl + f];
            acc[k] += gv * wt;
            d = xu[k] * gv;
          }
          if (dw != nullptr && w_kind == 2) dw[e * Fl + f] = d;
          dwp += d;
        }
      }
      if (dw != nullptr && w_kind == 1) {
        for (int off = 16; off >= 1; off >>= 1)
          dwp += __shfl_xor_sync(0xffffffffu, dwp, off);
        // this warp owns edge e: later passes add to its own earlier write
        if (lane == 0) dw[e] = (f0 == 0 ? 0.0f : dw[e]) + dwp;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + lane + 32 * k;
      if (f < F) dx[u * Fl + f] = acc[k];
    }
  }
}

}  // namespace

extern "C" int segment_max_f32(const int* indptr, const int* gidx,
                               const float* x, const float* w, int w_kind,
                               float* out, int num_rows, int F,
                               cudaStream_t stream) {
  if (num_rows > 0 && F > 0) {
    const int blocks = (num_rows + kWarps - 1) / kWarps;
    segment_max_kernel<<<blocks, kWarps * 32, 0, stream>>>(
        indptr, gidx, x, w, w_kind, out, num_rows, F);
  }
  return (int)cudaGetLastError();
}

extern "C" int segment_max_bwd_f32(const int* csr_indptr, const int* dst_csr,
                                   const int* csr_eids, const float* x,
                                   const float* w, int w_kind,
                                   const float* raw, const float* g,
                                   float* dx, float* dw, int num_src, int F,
                                   cudaStream_t stream) {
  if (num_src > 0 && F > 0) {
    const int blocks = (num_src + kWarps - 1) / kWarps;
    segment_max_bwd_kernel<<<blocks, kWarps * 32, 0, stream>>>(
        csr_indptr, dst_csr, csr_eids, x, w, w_kind, raw, g, dx, dw, num_src,
        F);
  }
  return (int)cudaGetLastError();
}
