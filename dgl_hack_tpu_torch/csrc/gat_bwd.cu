// K3: fused GAT backward edge phase (float32).
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
//   draw_out[e,h] = draw;  dw[e,h] = a * daw  (when w is given)
// sds[v,h] = <rst[v,h,:], dout[v,h,:]> comes from the caller; der is the
// CSC-direction segment sum of draw_out (K1 in edge-row mode).
//
// Replaces the TPU kernel dgl_hack_tpu/ops/pallas/gat_kernel.py
// _gat_bwd_kernel, launched by _gat_bwd_call / _run_gat_bwd_fused; the
// math is that kernel's and the legacy path's (_gat_fused_bwd).  The TPU
// version expanded src windows to slots with one-hot matmuls and sent
// per-slot outputs back to edge order with an inverse-slot gather; here a
// warp walks one src row's out-edges and writes per-edge outputs at their
// internal edge id directly.
//
// Bound on the H100: bytes.  Per edge it reads one dout row (4*H*D B) and
// er/shift/den/sds (16*H B) of the dst, the indices (8 B) and 4*H B of w
// when given; it writes 4*H B of draw (and of dw).  Per src row it reads
// Wh and el once from L1 and writes 4*(H*D + H) B.
//
// Design: one warp owns one src row.  Per edge, lanes form the products
// Wh*dout across features into shared memory, one lane per head sums
// its D products in a fixed order (any D, no cross-lane shuffle tree),
// and lanes accumulate dWh in shared memory over features they own.  Two
// __syncwarp per edge; no atomics, so results repeat bitwise.  Shared
// memory per warp: 4*(2*H*D + 2*H) B; the wrapper picks warps per block
// to stay under 48 KB.  Left for later: register accumulators for narrow
// rows, fewer syncs, splitting hub rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.0f ? x : slope * x;
}

__global__ void gat_bwd_kernel(
    const int* __restrict__ csr_indptr, const int* __restrict__ csr_eids,
    const int* __restrict__ dst_csr, const float* __restrict__ wh,
    const float* __restrict__ el, const float* __restrict__ er,
    const float* __restrict__ shift, const float* __restrict__ den,
    const float* __restrict__ sds, const float* __restrict__ dout,
    const float* __restrict__ w, float* __restrict__ dwh,
    float* __restrict__ del, float* __restrict__ draw_out,
    float* __restrict__ dw, int num_src, int H, int D, float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HD = H * D;
  float* prod = smem + (size_t)warp * (2 * HD + 2 * H);
  float* acc = prod + HD;        // dWh accumulator (HD)
  float* aw_s = acc + HD;        // per-edge aw (H)
  float* del_acc = aw_s + H;     // del accumulator (H)
  const int64_t u = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (u >= num_src) return;
  const int beg = csr_indptr[u];
  const int end = csr_indptr[u + 1];

  for (int f = lane; f < HD; f += 32) acc[f] = 0.0f;
  for (int h = lane; h < H; h += 32) del_acc[h] = 0.0f;
  __syncwarp();

  for (int k = beg; k < end; ++k) {
    const int64_t e = csr_eids[k];
    const int64_t v = dst_csr[k];
    for (int f = lane; f < HD; f += 32)
      prod[f] = wh[u * HD + f] * dout[v * HD + f];
    __syncwarp();
    for (int h = lane; h < H; h += 32) {
      float daw = 0.0f;
      for (int d = 0; d < D; ++d) daw += prod[h * D + d];
      const float raw = el[u * H + h] + er[v * H + h];
      const float dd = den[v * H + h];
      const float a =
          expf(fminf(leaky(raw, slope) - shift[v * H + h], 60.0f)) /
          (dd > 0.0f ? dd : 1.0f);
      const float wv = w ? w[e * H + h] : 1.0f;
      const float dlogit = a * (daw * wv - sds[v * H + h]);
      const float draw = dlogit * (raw >= 0.0f ? 1.0f : slope);
      draw_out[e * H + h] = draw;
      if (dw) dw[e * H + h] = a * daw;
      aw_s[h] = a * wv;
      del_acc[h] += draw;
    }
    __syncwarp();
    for (int f = lane; f < HD; f += 32)
      acc[f] += aw_s[f / D] * dout[v * HD + f];
  }
  __syncwarp();
  for (int f = lane; f < HD; f += 32) dwh[u * HD + f] = acc[f];
  for (int h = lane; h < H; h += 32) del[u * H + h] = del_acc[h];
}

}  // namespace

extern "C" int gat_bwd_f32(const int* csr_indptr, const int* csr_eids,
                           const int* dst_csr, const float* wh,
                           const float* el, const float* er,
                           const float* shift, const float* den,
                           const float* sds, const float* dout,
                           const float* w, float* dwh, float* del,
                           float* draw_out, float* dw, int num_src, int H,
                           int D, float slope, int warps_per_block,
                           cudaStream_t stream) {
  if (num_src > 0 && H > 0 && D > 0) {
    const int blocks = (num_src + warps_per_block - 1) / warps_per_block;
    const size_t smem =
        (size_t)warps_per_block * (2 * H * D + 2 * H) * sizeof(float);
    gat_bwd_kernel<<<blocks, warps_per_block * 32, smem, stream>>>(
        csr_indptr, csr_eids, dst_csr, wh, el, er, shift, den, sds, dout, w,
        dwh, del, draw_out, dw, num_src, H, D, slope);
  }
  return (int)cudaGetLastError();
}
