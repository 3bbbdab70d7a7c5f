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
//
// Design: a block takes a chunk of QC = 32 queries (16 where the shared memory
// of 32 does not suffice: bf16 with D > 512, or tile_n > 1152) and scores a
// whole tile into a [QC, tile_n + 4] float32 tile in shared memory (128 KB at
// QC = 32, tile_n = 1024; the 4-float pad spreads the queries of one
// accumulator quad over the banks), so no [B, N] score matrix exists in device
// memory. Then the selection passes.
//   - products on the TMA ring of common.cuh: a persistent grid, one block per
//     SM, works through the (query chunk, tile) items with the chunks of one
//     tile taken up together; one producer warp streams 16 KB corpus stages
//     (128 rows x one 128-byte box of D) through a 4-stage mbarrier ring, and
//     loads the next item's stages while the consumers select;
//   - bf16: the block's query chunk stays resident (24 KB at QC = 32, D = 384);
//     two consumer warpgroups of 64 rows each run wgmma m64nQCk16, QC / 2
//     accumulators a thread;
//   - float32: the chunk streams through the ring beside the corpus; each of
//     the 256 consumer threads runs IEEE fmaf on a register tile of 2 rows x
//     QC / 4 queries;
//   - selection, unchanged from the first version: warp w selects for queries
//     w, w + 8, ... of the chunk: kk rounds of a warp-wide arg-max over the
//     (value, column) pairs, each lane scanning its columns in ascending order, then
//     a shuffle butterfly; the lane owning the winner sets it to -1e30. The
//     comparison prefers the larger value, then the smaller column, which is the
//     TPU kernel's tie rule. Passes over the whole tile, rather than a register
//     top-k, keep the slot rule above for every kk up to tile_n.

#include <stdint.h>

#include "common.cuh"

namespace {

using ahrag::kNegInf;
using ahrag::kSmemLimit;

constexpr int kSelWarps = 8;     // warps that select (the consumers)
constexpr int kPad = 4;          // floats of padding per score row

__host__ __device__ constexpr size_t score_tile_bytes(int QC, int tile_n) {
  return (size_t)QC * (tile_n + kPad) * sizeof(float);
}

template <typename T, int QC>
size_t smem_bytes(int D, int tile_n) {
  return ahrag::RingSmem<T, QC>::bytes(D, score_tile_bytes(QC, tile_n));
}

// (v, c) beats (bv, bc): larger value, then smaller column
__device__ __forceinline__ bool beats(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

// kk arg-max passes per query of the chunk over the score tile s_s [QC][ld],
// one warp per query; warps 0 .. kSelWarps - 1 take part.
template <int QC>
__device__ __forceinline__ void select_tile(float* s_s, int ld, int c0, int B, int t,
                                            int tile_n, int kk, float* __restrict__ vals,
                                            int* __restrict__ idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)t * tile_n;
  for (int b = warp; b < QC; b += kSelWarps) {
    if (c0 + b >= B) break;
    float* s = s_s + b * ld;
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

__device__ __forceinline__ bool eligible(const uint8_t* __restrict__ mask, long long n_valid,
                                         long long row) {
  return row < n_valid && (mask == nullptr || mask[row] != 0);
}

// ---- the kernel --------------------------------------------------------------

template <typename T, int QC>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
tile_topk_kernel(const __grid_constant__ CUtensorMap emb_map,
                 const __grid_constant__ CUtensorMap q_map,
                 const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                 int tile_n, int num_tiles, int kk, float* __restrict__ vals,
                 int* __restrict__ idx, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  const int ld = tile_n + kPad;
  ahrag::Ring<T, QC> ring(smem_raw, D, score_tile_bytes(QC, tile_n));
  float* s_s = reinterpret_cast<float*>(ring.extra);
  ring.init();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == ahrag::kConsumers / 32) {           // producer warp
    if (lane == 0)
      ring.produce(&emb_map, &q_map, D, chunks, ahrag::block_share(chunks, num_tiles, tile_n));
    return;
  }
  if constexpr (sizeof(T) == 2) ahrag::mbar_wait(ring.qbar, 0);   // resident queries
  for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
    const int c0 = (int)(it % chunks) * QC, t = (int)(it / chunks);
    const long long base = (long long)t * tile_n;
    for (int i = 0; i < tile_n / ahrag::kSliceRows; ++i) {
      if constexpr (sizeof(T) == 2) {
        // register 4j + h: query 8j + 2 (lane % 4) + (h & 1), column col + 8 (h >> 1)
        float acc[QC / 2];
        ahrag::bf16_slice(acc, ring, D);
        const int col = ahrag::kSliceRows * i + 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
        const bool ok0 = eligible(mask, n_valid, base + col);
        const bool ok1 = eligible(mask, n_valid, base + col + 8);
#pragma unroll
        for (int x = 0; x < QC / 2; ++x) {
          const int b = 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
          s_s[b * ld + col + 8 * ((x >> 1) & 1)] = ((x & 2) ? ok1 : ok0) ? acc[x] : kNegInf;
        }
      } else {
        using Tile = ahrag::F32Tile<QC, 2>;
        float acc[2][Tile::kQN];
        ahrag::f32_slice<QC, 2>(acc, ring, D);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = ahrag::kSliceRows * i + Tile::row(r);
          const bool ok = eligible(mask, n_valid, base + col);
#pragma unroll
          for (int j = 0; j < Tile::kQN; ++j)
            s_s[Tile::query(j) * ld + col] = ok ? acc[r][j] : kNegInf;
        }
      }
    }
    ahrag::consumers_sync();                   // the tile's scores are complete
    select_tile<QC>(s_s, ld, c0, B, t, tile_n, kk, vals, idx);
    ahrag::consumers_sync();                   // s_s is free for the next item
  }
}

// The wrapper's chunk qc (tile_topk_chunk): 32 queries where their shared
// memory fits, else 16; any other returns cudaErrorInvalidValue.
template <typename T>
int launch(int qc, const void* q, const void* emb, const void* mask, long long n_valid, int B,
           long long N, int D, int tile_n, int kk, long long grid, void* vals, void* idx,
           cudaStream_t stream) {
  const long long num_tiles = N / tile_n;
  const bool fits = smem_bytes<T, 32>(D, tile_n) <= kSmemLimit;
  if (qc == 32 && fits)
    return (int)ahrag::launch_ring<T, 32>(
        tile_topk_kernel<T, 32>, q, emb, B, N, D, num_tiles, 1, grid,
        smem_bytes<T, 32>(D, tile_n), stream, (const uint8_t*)mask, n_valid, B, D, tile_n,
        (int)num_tiles, kk, (float*)vals, (int*)idx);
  if (qc == 16 && !fits)
    return (int)ahrag::launch_ring<T, 16>(
        tile_topk_kernel<T, 16>, q, emb, B, N, D, num_tiles, 1, grid,
        smem_bytes<T, 16>(D, tile_n), stream, (const uint8_t*)mask, n_valid, B, D, tile_n,
        (int)num_tiles, kk, (float*)vals, (int*)idx);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shapes (checked by the Python wrapper): q [B, D] and emb [N, D] of one type
// (is_bf16 ? bf16 : float32), contiguous and 16-byte aligned, D % 8 == 0,
// N % tile_n == 0, tile_n % 128 == 0, the block's shared memory at 16 queries
// within what a block may opt in to, 1 <= kk <= tile_n; mask [N] bool or null
// for every row. vals [N / tile_n, B, kk] float32, idx the same shape int32.
// qc and grid are the wrapper's (tile_topk_chunk, ring_grid in ops/binmax.py).
// Returns a cudaError_t code (cudaErrorInvalidValue when a TMA descriptor cannot be
// made, or the chunk or grid is not one launch_ring takes).
extern "C" int ahrag_tile_topk(const void* q, const void* emb, const void* mask,
                               long long n_valid, int B, long long N, int D, int tile_n,
                               int kk, int qc, long long grid, int is_bf16, void* vals,
                               void* idx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(qc, q, emb, mask, n_valid, B, N, D, tile_n, kk, grid,
                                         vals, idx, s)
                 : launch<float>(qc, q, emb, mask, n_valid, B, N, D, tile_n, kk, grid, vals,
                                 idx, s);
}
