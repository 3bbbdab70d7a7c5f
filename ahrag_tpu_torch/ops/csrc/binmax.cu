// Streaming bin-max kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ahrag_tpu/ops/topk.py:
//   ahrag_binmax2 <- dense_binmax2_pallas / _binmax2_kernel (bins [T, B, 128] + supermax [B, T])
//   ahrag_binmax  <- dense_binmax_pallas  / _binmax_kernel  (bins transposed to [B, T * 128])
//
// For each corpus tile t of tile_n rows and each query b the kernel computes the
// scores s[b, r] = q[b] . emb[r] (float32 accumulation), sets rows with
// r >= n_valid or mask[r] == 0 to -1e30 unless the mask is trivial, and reduces the
// tile to 128 STRIDED bins: bin j of tile t holds rows t * tile_n + j + 128 * i.
// The supermax variant also emits max_j bins[t, b, j] as smax[b, t].
//
// Bound on an H100 SXM at the main-path shape (1,067,008 x 384 bf16 corpus, B = 512,
// tile_n = 1024): 2 * B * N * D = 4.196e11 FLOP, 0.42 ms at 989 TFLOP/s bf16 dense;
// 819 MB of corpus + 273 MB of bins + 2 MB of supermax, 0.33 ms at 3.35 TB/s. So the
// bound is ~0.42 ms, set by compute. This first version runs on the CUDA cores in
// float32 FMA and is far from that bound; moving the products onto wgmma with TMA
// loads is later work.
//
// Design, right and simple first:
//   - a block owns one tile and a chunk of QC queries; its 128 threads are the
//     128 lanes, so thread j owns bin j and walks the tile_n / 128 rows of that bin;
//   - the query chunk is widened to float32 once and staged in shared memory, where
//     every thread reads the same address (a broadcast, free of bank conflicts);
//   - each thread keeps a running max per query over its rows, so no [B, tile_n]
//     score tile ever exists;
//   - staging and products as in common.cuh: float32 FMA on widened operands, so the
//     kernel agrees with a float32 matmul up to summation order;
//   - blockIdx.x walks the query chunks of one tile, so the blocks that re-read a
//     tile run together and find it in L2.

#include <stdint.h>

#include "common.cuh"

namespace {

using ahrag::kNegInf;

constexpr int kLanes = 128;      // bins per tile = threads per block
constexpr int kQC = 32;          // queries per block

template <typename T, bool kSupermax, bool kTrivial>
__global__ void __launch_bounds__(kLanes)
binmax_kernel(const T* __restrict__ q, const T* __restrict__ emb,
              const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
              int tile_n, float* __restrict__ bins, float* __restrict__ smax) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);          // [kQC][D]
  __shared__ float red[kLanes / 32][kQC];

  const int j = threadIdx.x;
  const int c0 = blockIdx.x * kQC;
  const int t = blockIdx.y;
  const int num_tiles = gridDim.y;

  ahrag::stage_queries<kQC>(q, q_s, c0, B, D);
  __syncthreads();

  float best[kQC];
#pragma unroll
  for (int b = 0; b < kQC; ++b) best[b] = -INFINITY;

  const int rows_per_lane = tile_n / kLanes;
  for (int i = 0; i < rows_per_lane; ++i) {
    const long long row = (long long)t * tile_n + j + (long long)kLanes * i;
    float dot[kQC];
    ahrag::score_row<kQC>(emb + row * D, q_s, D, dot);
    const bool ok = kTrivial || (row < n_valid && mask[row] != 0);
#pragma unroll
    for (int b = 0; b < kQC; ++b) best[b] = fmaxf(best[b], ok ? dot[b] : kNegInf);
  }

#pragma unroll
  for (int b = 0; b < kQC; ++b) {
    if (c0 + b < B) {
      const size_t out = kSupermax
          ? ((size_t)t * B + c0 + b) * kLanes + j                      // [T, B, 128]
          : (size_t)(c0 + b) * num_tiles * kLanes + (size_t)t * kLanes + j;  // [B, T*128]
      bins[out] = best[b];
    }
  }

  if (kSupermax) {
    const int warp = j >> 5, lane = j & 31;
#pragma unroll
    for (int b = 0; b < kQC; ++b) {
      float v = best[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) red[warp][b] = v;
    }
    __syncthreads();
    if (j < kQC && c0 + j < B) {
      float v = red[0][j];
#pragma unroll
      for (int w = 1; w < kLanes / 32; ++w) v = fmaxf(v, red[w][j]);
      smax[(size_t)(c0 + j) * num_tiles + t] = v;
    }
  }
}

template <typename T, bool kSupermax, bool kTrivial>
int launch(const void* q, const void* emb, const void* mask, long long n_valid, int B,
           long long N, int D, int tile_n, void* bins, void* smax, void* stream) {
  const long long num_tiles = N / tile_n;
  const dim3 grid((B + kQC - 1) / kQC, (unsigned)num_tiles);
  const size_t smem = (size_t)kQC * D * sizeof(float);
  auto kern = binmax_kernel<T, kSupermax, kTrivial>;
  // the static reduction buffer counts against the same 48 KB default, so
  // opt in to the dynamic size on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kLanes, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)emb, (const uint8_t*)mask, n_valid, B, D, tile_n,
      (float*)bins, (float*)smax);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes (checked by the Python wrapper): q [B, D] and emb [N, D] of one type
// (is_bf16 ? bf16 : float32), contiguous and 16-byte aligned, D % 8 == 0,
// N % tile_n == 0, tile_n % 128 == 0; mask [N] bool. Returns cudaGetLastError().
extern "C" int ahrag_binmax2(const void* q, const void* emb, const void* mask,
                             long long n_valid, int B, long long N, int D, int tile_n,
                             int is_bf16, int trivial, void* bins, void* smax,
                             void* stream) {
  if (is_bf16) {
    return trivial
        ? launch<__nv_bfloat16, true, true>(q, emb, mask, n_valid, B, N, D, tile_n, bins, smax, stream)
        : launch<__nv_bfloat16, true, false>(q, emb, mask, n_valid, B, N, D, tile_n, bins, smax, stream);
  }
  return trivial
      ? launch<float, true, true>(q, emb, mask, n_valid, B, N, D, tile_n, bins, smax, stream)
      : launch<float, true, false>(q, emb, mask, n_valid, B, N, D, tile_n, bins, smax, stream);
}

extern "C" int ahrag_binmax(const void* q, const void* emb, const void* mask,
                            long long n_valid, int B, long long N, int D, int tile_n,
                            int is_bf16, void* out, void* stream) {
  return is_bf16
      ? launch<__nv_bfloat16, false, false>(q, emb, mask, n_valid, B, N, D, tile_n, out, nullptr, stream)
      : launch<float, false, false>(q, emb, mask, n_valid, B, N, D, tile_n, out, nullptr, stream);
}
