// Device helpers shared by the port's kernels (binmax.cu, tile_topk.cu): query
// staging and the score product.
//
// Products are fmaf on operands widened to float32 (__bfloat162float for bf16):
// exact for bf16 products and IEEE float32 for float32 storage, with no TF32, so
// every kernel agrees with a float32 matmul up to summation order. Moving the
// products onto wgmma changes this file.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ahrag {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Widens queries c0 .. c0 + QC - 1 of q [B, D] into q_s [QC][D] in shared memory,
// where every thread of a warp later reads the same address (a broadcast). Queries
// past B stage as zeros: every thread then runs the same unrolled product loop,
// and their results are never written. The caller synchronises afterwards.
template <int QC, typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, float* q_s,
                                              int c0, int B, int D) {
  for (int x = threadIdx.x; x < QC * D; x += blockDim.x) {
    const int b = x / D;
    q_s[x] = (c0 + b < B) ? to_float(q[(size_t)(c0 + b) * D + (x - b * D)]) : 0.f;
  }
}

// dot[b] = q_s[b] . e for the QC staged queries, D % 8 == 0, e 16-byte aligned.
template <int QC, typename T>
__device__ __forceinline__ void score_row(const T* __restrict__ e, const float* q_s,
                                          int D, float (&dot)[QC]) {
#pragma unroll
  for (int b = 0; b < QC; ++b) dot[b] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 8) {
    float ev[8];
    load8(e + d0, ev);
#pragma unroll
    for (int b = 0; b < QC; ++b) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + b * D + d0);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + b * D + d0 + 4);
      float acc = dot[b];
      acc = fmaf(ev[0], qa.x, acc);
      acc = fmaf(ev[1], qa.y, acc);
      acc = fmaf(ev[2], qa.z, acc);
      acc = fmaf(ev[3], qa.w, acc);
      acc = fmaf(ev[4], qb.x, acc);
      acc = fmaf(ev[5], qb.y, acc);
      acc = fmaf(ev[6], qb.z, acc);
      acc = fmaf(ev[7], qb.w, acc);
      dot[b] = acc;
    }
  }
}

}  // namespace ahrag
