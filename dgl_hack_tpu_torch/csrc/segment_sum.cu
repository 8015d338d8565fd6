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
// H100 the graph's own CSC/CSR arrays are the plan.
//
// Bound on the H100: bytes.  Per edge it reads one index (4 B, plus 4 B of
// eid and 4 or 4F B of weight when weighted) and one x row (4F B, a random
// row: L2 hits on hub-heavy graphs); per row it writes 4F B.  No FLOP
// limit is anywhere near.
//
// Design (simple and right first): one warp owns one output row, so no
// atomics and the summation order is fixed - results repeat bitwise.
// For F >= 32 the lanes cover features (4 per lane per pass, passes over
// wider F).  For F < 32 the warp splits into 32/Fp lane groups (Fp = F
// rounded up to a power of two) that take every (32/Fp)-th edge, then a
// fixed shuffle tree sums the groups, so narrow widths such as GCN's 16 or
// 7 keep most lanes busy.  Left for later: vector (16 B) loads, several
// rows per warp for low-degree rows, splitting hub rows across warps, and
// bf16 storage.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block

__device__ __forceinline__ float weight_of(const float* w, int w_kind,
                                           int64_t e, int64_t F, int64_t f) {
  if (w_kind == 1) return w[e];
  if (w_kind == 2) return w[e * F + f];
  return 1.0f;
}

__global__ void segment_sum_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ gidx,
                                   const int* __restrict__ eid,
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
    float acc = 0.0f;
    if (sub < F) {
      for (int j = beg + grp; j < end; j += groups) {
        const int64_t src = gidx ? (int64_t)gidx[j] : (int64_t)j;
        const int64_t e = eid ? (int64_t)eid[j] : (int64_t)j;
        acc += x[src * Fl + sub] * weight_of(w, w_kind, e, Fl, sub);
      }
    }
    for (int off = 16; off >= fp; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (grp == 0 && sub < F) out[row * Fl + sub] = acc;
    return;
  }

  for (int f0 = 0; f0 < F; f0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = beg; j < end; ++j) {
      const int64_t src = gidx ? (int64_t)gidx[j] : (int64_t)j;
      const int64_t e = eid ? (int64_t)eid[j] : (int64_t)j;
      const float* xr = x + src * Fl;
      const float ws = (w_kind == 1) ? w[e] : 1.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + lane + 32 * k;
        if (f < F) {
          const float wv = (w_kind == 2) ? w[e * Fl + f] : ws;
          acc[k] += xr[f] * wv;
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

}  // namespace

extern "C" int segment_sum_f32(const int* indptr, const int* gidx,
                               const int* eid, const float* x, const float* w,
                               int w_kind, float* out, int num_rows, int F,
                               cudaStream_t stream) {
  if (num_rows > 0 && F > 0) {
    const int blocks = (num_rows + kWarps - 1) / kWarps;
    segment_sum_kernel<<<blocks, kWarps * 32, 0, stream>>>(
        indptr, gidx, eid, x, w, w_kind, out, num_rows, F);
  }
  return (int)cudaGetLastError();
}
