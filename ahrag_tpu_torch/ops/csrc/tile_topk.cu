// Fused score + per-tile top-k for Hopper (sm_90a): flat exact retrieval.
//
// Replaces the Pallas TPU kernel of ahrag_tpu/ops/topk.py:
//   ahrag_tile_topk <- dense_topk_pallas / _tile_topk_kernel
//
// For each corpus tile t of tile_n rows and each query b the kernel computes the
// scores s[b, c] = q[b] . emb[t * tile_n + c] (float32 accumulation), sets rows with
// row >= n_valid or mask[row] == 0 to -1e30, and then takes kk passes over the tile:
// each pass writes the largest score and its row to slot j, preferring the LOWEST
// column among equal maxima (jnp.argmax's first occurrence), and sets that column
// to -1e30. Once a tile's eligible rows are used up every column is -1e30, so every
// later pass picks column 0 again: those slots hold (-1e30, t * tile_n), repeated,
// exactly as the TPU kernel leaves them. The wrapper merges the tiles in order.
//
// Outputs: vals [T, B, kk] float32 and idx [T, B, kk] int32 global rows. The TPU
// kernel padded kk to a multiple of 128 lanes (a Mosaic layout rule); the padding is
// dropped here, since the merge discarded it.
//
// Bound on an H100 SXM (dense peaks, 3.35 TB/s):
//   - 1M bf16 rung (1,067,008 x 384, B = 512): 2 * 512 * 1,067,008 * 384 = 4.196e11
//     products, 0.424 ms at 989 TFLOP/s; 819 MB of corpus + 21 MB of output, 0.251 ms.
//     So 0.424 ms, set by operations;
//   - 131k f32 rung (135,168 x 384, B = 2048): 2.126e11 products, 3.17 ms at
//     67 TFLOP/s float32, set by operations.
// This first version runs the products on the CUDA cores in float32 FMA and is far
// from that bound; moving them onto wgmma is later work.
//
// Design, right and simple first:
//   - a block owns one tile and a chunk of kQC queries, staged in shared memory as
//     float32 (common.cuh);
//   - phase 1: thread i scores rows i, i + 256, ... of the tile against the kQC queries
//     and writes the masked scores to a [kQC, tile_n] float32 tile in shared memory
//     (64 KB at tile_n = 1024), so no [B, N] score matrix exists in device memory;
//   - phase 2: warp w selects for queries w and w + 8 of the chunk: kk rounds of a
//     warp-wide arg-max over the (value, column) pairs, each lane scanning its columns
//     in ascending order, then a shuffle butterfly; the lane owning the winner sets
//     it to -1e30. The comparison prefers the larger value, then the smaller column,
//     which is the TPU kernel's tie rule and needs no other synchronisation than
//     __syncwarp;
//   - products as in common.cuh: float32 FMA on widened operands, so the kernel agrees
//     with a float32 matmul up to summation order;
//   - blockIdx.x walks the query chunks of one tile, so the blocks that re-read a
//     tile run together and find it in L2.

#include <stdint.h>

#include "common.cuh"

namespace {

using ahrag::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQC = 16;          // queries per block: 2 per warp in the selection

// (v, c) beats (bv, bc): larger value, then smaller column
__device__ __forceinline__ bool beats(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                 const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                 int tile_n, int kk, float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);          // [kQC][D]
  float* s_s = q_s + (size_t)kQC * D;                    // [kQC][tile_n]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kQC;
  const int t = blockIdx.y;
  const long long base = (long long)t * tile_n;

  ahrag::stage_queries<kQC>(q, q_s, c0, B, D);
  __syncthreads();

  // phase 1: masked scores of the tile into shared memory
  for (int c = tid; c < tile_n; c += kThreads) {
    const long long row = base + c;
    float dot[kQC];
    ahrag::score_row<kQC>(emb + row * D, q_s, D, dot);
    const bool ok = row < n_valid && (mask == nullptr || mask[row] != 0);
#pragma unroll
    for (int b = 0; b < kQC; ++b) s_s[b * tile_n + c] = ok ? dot[b] : kNegInf;
  }
  __syncthreads();

  // phase 2: kk arg-max passes per query, one warp per query
  const int warp = tid >> 5, lane = tid & 31;
  for (int b = warp; b < kQC; b += kWarps) {
    if (c0 + b >= B) break;
    float* s = s_s + b * tile_n;
    const size_t out = ((size_t)t * B + c0 + b) * kk;
    for (int j = 0; j < kk; ++j) {
      float bv = -INFINITY;
      int bc = tile_n;
      for (int c = lane; c < tile_n; c += 32) {   // ascending: strict > keeps the lowest
        const float v = s[c];
        if (v > bv) { bv = v; bc = c; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (beats(ov, oc, bv, bc)) { bv = ov; bc = oc; }
      }
      if (lane == 0) {
        vals[out + j] = bv;
        idx[out + j] = (int)(base + bc);
      }
      if (bc < tile_n && (bc & 31) == lane) s[bc] = kNegInf;   // bc == tile_n only for NaN rows
      __syncwarp();
    }
  }
}

template <typename T>
int launch(const void* q, const void* emb, const void* mask, long long n_valid, int B,
           long long N, int D, int tile_n, int kk, void* vals, void* idx, void* stream) {
  const long long num_tiles = N / tile_n;
  const dim3 grid((B + kQC - 1) / kQC, (unsigned)num_tiles);
  const size_t smem = (size_t)kQC * (D + tile_n) * sizeof(float);
  auto kern = tile_topk_kernel<T>;
  // above the 48 KB default only after opting in, so opt in on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)emb, (const uint8_t*)mask, n_valid, B, D, tile_n, kk,
      (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes (checked by the Python wrapper): q [B, D] and emb [N, D] of one type
// (is_bf16 ? bf16 : float32), contiguous and 16-byte aligned, D % 8 == 0,
// N % tile_n == 0, tile_n % 128 == 0, 1 <= kk <= tile_n; mask [N] bool or null for
// every row. vals [N / tile_n, B, kk] float32, idx the same shape int32.
// Returns cudaGetLastError().
extern "C" int ahrag_tile_topk(const void* q, const void* emb, const void* mask,
                               long long n_valid, int B, long long N, int D, int tile_n,
                               int kk, int is_bf16, void* vals, void* idx, void* stream) {
  return is_bf16
      ? launch<__nv_bfloat16>(q, emb, mask, n_valid, B, N, D, tile_n, kk, vals, idx, stream)
      : launch<float>(q, emb, mask, n_valid, B, N, D, tile_n, kk, vals, idx, stream);
}
