// K2: fused GAT forward edge phase (float32).
//
// For every dst v, over its CSC in-edges e = (u -> v), per head h:
//   logit = leaky(el[u,h] + er[v,h])
//   p     = exp(logit - shift[v,h])
//   num[v,h,:] += p * w[e,h] * Wh[u,h,:]      (w = 1 when absent)
//   den[v,h]   += p
//   rst = num / den, and 0 where den == 0.
// exact == 0 ("shift", the default): shift is the upper bound
//   leaky(max_u el[u,h] + er[v,h]) that the wrapper computes and passes in.
// exact == 1: the kernel takes the exact per-dst max in a first pass over
//   the same edges and writes it to shift (-1e30 for an empty row).
// Outputs rst (N, H*D), den (N, H), shift (N, H); the backward reuses
// den and shift.  Edges are in internal (CSC) order, so w is indexed by
// the CSC position itself.
//
// Replaces the TPU kernels dgl_hack_tpu/ops/pallas/gat_kernel.py
// _gat_kernel_shift (shift mode) and _gat_kernel (online-max "exact"),
// launched by _gat_chunk_call.  On the TPU the exact mode needed a running
// max with rescaling because a window's edges arrive in blocks; a warp
// that owns a whole dst row can afford a second pass instead.
//
// Bound on the H100: bytes.  Per edge it reads one Wh row (4*H*D B), one
// el row (4*H B) and the index (4 B), plus 4*H B of w when given; per row
// it writes 4*(H*D + 2H) B.  The exp is recomputed by each of the D lanes
// of a head (SFU work, far from the limit at these widths).
//
// Design: one warp owns one dst row; lanes cover the H*D features (4 per
// lane per pass, passes over wider rows); each lane computes the logit
// of its own feature's head, so no shared memory and no synchronisation
// inside the edge loop.  No atomics: results repeat bitwise.  Left for
// later: using idle lanes when H*D < 32 (the 1-head output layer at small
// D), vector loads, splitting hub rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.0f ? x : slope * x;
}

__global__ void gat_fwd_kernel(const int* __restrict__ indptr,
                               const int* __restrict__ src,
                               const float* __restrict__ wh,
                               const float* __restrict__ el,
                               const float* __restrict__ er,
                               const float* __restrict__ w,
                               float* __restrict__ shift,
                               float* __restrict__ rst,
                               float* __restrict__ den, int num_dst, int H,
                               int D, float slope, int exact) {
  const int lane = threadIdx.x & 31;
  const int64_t v = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= num_dst) return;
  const int beg = indptr[v];
  const int end = indptr[v + 1];
  const int HD = H * D;

  for (int f0 = 0; f0 < HD; f0 += 128) {
    int head[4];
    float erv[4], m[4], num[4], dsum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + lane + 32 * k;
      head[k] = f < HD ? f / D : 0;
      erv[k] = er[v * H + head[k]];
      m[k] = exact ? kNeg : shift[v * H + head[k]];
      num[k] = 0.0f;
      dsum[k] = 0.0f;
    }
    if (exact) {
      for (int j = beg; j < end; ++j) {
        const int64_t u = src[j];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          m[k] = fmaxf(m[k], leaky(el[u * H + head[k]] + erv[k], slope));
      }
    }
    for (int j = beg; j < end; ++j) {
      const int64_t u = src[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + lane + 32 * k;
        if (f < HD) {
          const float p =
              expf(leaky(el[u * H + head[k]] + erv[k], slope) - m[k]);
          const float pw = w ? p * w[(int64_t)j * H + head[k]] : p;
          num[k] += pw * wh[u * HD + f];
          dsum[k] += p;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + lane + 32 * k;
      if (f < HD) {
        rst[v * HD + f] = dsum[k] > 0.0f ? num[k] / dsum[k] : 0.0f;
        if (f % D == 0) {
          den[v * H + head[k]] = dsum[k];
          if (exact) shift[v * H + head[k]] = m[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" int gat_fwd_f32(const int* indptr, const int* src, const float* wh,
                           const float* el, const float* er, const float* w,
                           float* shift, float* rst, float* den, int num_dst,
                           int H, int D, float slope, int exact,
                           cudaStream_t stream) {
  if (num_dst > 0 && H > 0 && D > 0) {
    const int blocks = (num_dst + kWarps - 1) / kWarps;
    gat_fwd_kernel<<<blocks, kWarps * 32, 0, stream>>>(
        indptr, src, wh, el, er, w, shift, rst, den, num_dst, H, D, slope,
        exact);
  }
  return (int)cudaGetLastError();
}
