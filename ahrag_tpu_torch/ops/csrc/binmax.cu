// Streaming bin-max kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ahrag_tpu/ops/topk.py:
//   ahrag_binmax2 <- dense_binmax2_pallas / _binmax2_kernel (bins [T, B, 128] + supermax [B, T])
//   ahrag_binmax  <- dense_binmax_pallas  / _binmax_kernel  (bins transposed to [B, T * 128])
//
// For each corpus tile t of tile_n rows and each query b the kernels compute the
// scores s[b, r] = q[b] . emb[r] (float32 accumulation), set rows with
// r >= n_valid or mask[r] == 0 to -1e30 unless the mask is trivial, and reduce the
// tile to 128 STRIDED bins: bin j of tile t holds rows t * tile_n + j + 128 * i.
// ahrag_binmax2 also emits max_j bins[t, b, j] as smax[b, t].
//
// Bound on an H100 SXM at the main-path shape (1,067,008 x 384 bf16 corpus, B = 512,
// tile_n = 1024): 2 * B * N * D = 4.196e11 FLOP, 0.42 ms at 989 TFLOP/s bf16 dense;
// 819 MB of corpus + 273 MB of bins + 2 MB of supermax, 0.33 ms at 3.35 TB/s. So the
// bound is ~0.42 ms, set by compute on the tensor cores. In float32 (131k rows,
// B = 1024 per chunk) it is 1.59 ms at 67 TFLOP/s on the CUDA cores.
//
// On the graphs that answers and the learned service search (5,120-6,144 rows,
// 5-6 tiles of 1024) the bound is a few microseconds: 15.7 MB of a 5,120 x 768
// float32 corpus, 4.7 us at B = 1; 2.01 GFLOP at B = 256, 30 us.
//
// Both run on the TMA ring of common.cuh:
//   - one producer warp streams 16 KB corpus stages (128 rows x one 128-byte box
//     of D) through an mbarrier ring;
//   - bf16: the block's query chunk stays resident as the wgmma N side; two
//     consumer warpgroups each take 64 rows of a slice as the M side, QC / 2
//     accumulators a thread;
//   - float32: the chunk streams through the ring beside the corpus; the 256
//     consumer threads run IEEE fmaf on register tiles;
//   - slice i's row r is bin r's i-th row, so the strided bin max is an
//     elementwise fmaxf of the accumulators into a running-max fragment of the
//     same layout, after masking by row: no score tile, no shuffles.
// The grid follows the wrapper's launch plan (binmax_plan, binmax2_plan in
// ops/binmax.py), which passes `split`, the blocks that share one (query chunk,
// tile) item:
//   - split 1 where the items fill the SMs (the 1M and 131k rungs, the shard's
//     tiles of 2048): a persistent grid, one block per SM, works through the
//     items with the chunks of one tile taken up together, so that their
//     requests for it can be served from L2 (not measured: no DRAM counter is
//     read);
//   - split 2, 4 or 8 where they do not: with one block per item a graph of 5
//     tiles kept 5-10 of 132 SMs busy (dense_binmax at B = 1: 5 blocks, each
//     streaming 3.1 MB at about 38 GB/s, what one SM's ring moves). Each item
//     gets a cluster of `split` blocks, and each block takes 1 / split of the
//     tile's slices into partial bin maxima of the usual layout. It writes them
//     over its ring's memory, which its last slice has freed; after a cluster
//     barrier each block reads QC / split of the chunk's queries from every
//     block of the cluster through distributed shared memory, maxes them and
//     stores those queries' bins (ahrag_binmax2 also their supermax, over the
//     merged bins). A max is exact in any order, so the bins are split 1's, bit
//     for bit. D is never split: that would change each score's summation order.
// ahrag_binmax2 (the main path; B % 128 == 0): a 4-stage ring; bf16 chunks of
// QC = 128 queries (32 where 128 of them do not fit, D > 576); float32 chunks
// of 128 on a register tile of 8 rows x 8 queries (96 or 64, on 8 rows x 6 or
// 4, where a split plan spreads the work over more blocks), its running max in
// shared memory. Bins are stored from registers; the supermax is reduced by shuffles
// within a warp (and in bf16 through shared memory across the 8 consumer warps).
// ahrag_binmax (any B: the serving buckets 1-64, the eps calibration): bins
// stored query-major, [B, T * 128], no supermax, on the same 4-stage ring. At
// small B it is bound by bytes (1M bf16, B = 4: 819.5 MB of corpus + 1.1 MB of
// mask + 2.1 MB of bins, 0.246 ms at 3.35 TB/s), so the corpus must stream from
// HBM once: the query chunk is fitted to B (the wrapper's binmax_chunk: 8, 16,
// 32, 64 or 128 queries in bf16, the wgmma N; up to 64 in float32), one chunk
// covers B <= 64 and the blocks walk the tiles. float32 runs a register tile of
// QC / 8 rows x 8 queries with each box of D split between a lane pair (QC <=
// 32), so that each corpus float4 a thread reads serves 8 queries and the
// shared-memory reads stay under the HBM time of a stage (at QC = 8 every
// corpus float4 is read once), or 8 rows x 4 queries (QC = 64, bound by
// operations: 6.64 GFLOP at 131k rows, B = 64, 0.099 ms at 67 TFLOP/s).
// A ring of 8 stages measured no faster than these 4 (PERF.md).

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using ahrag::kNegInf;
using ahrag::kSmemLimit;

constexpr int kLanes = 128;      // bins per tile
// supermax exchange of a bf16 QC-query chunk: [8 consumer warps][QC]
__host__ __device__ constexpr size_t red_bytes(int QC) { return (size_t)8 * QC * sizeof(float); }

// ---- the merge of a split item ---------------------------------------------

// A split item's partial bins, query q's bin j at P[q * kPitch + j] (4 floats of
// padding a query, so that the bf16 warps' stores fall on distinct banks), lie
// over the ring's stages and, in bf16, the resident query panels behind them,
// which hold at least 4 x 16 KB + QC x 128 bytes.
constexpr int kPitch = kLanes + 4;
__host__ __device__ constexpr size_t part_bytes(int QC) { return (size_t)QC * kPitch * sizeof(float); }
static_assert(part_bytes(128) <= (size_t)ahrag::kStages * ahrag::kCorpusBytes + 128 * 128,
              "a split item's partial bins fit in the ring's memory");

// In a split kernel, after every consumer thread has written its partial bins
// to P: a cluster barrier, then block r of the cluster takes the chunk's queries
// r * QC / split .. (r + 1) * QC / split - 1, a warp a query, reads each one's
// 32 float4 of partial bins from every block of the cluster, maxes them and
// hands them to store(q, lane, v); a second barrier keeps every block's P alive
// until its peers have read it. The producer warp takes part in both barriers.
template <int QC, typename Store>
__device__ __forceinline__ void merge_split(const float* P, int split, Store store) {
  ahrag::cluster_sync();
  const int nq = QC / split, q0 = (int)(blockIdx.x % split) * nq;
  for (int x = threadIdx.x; x < nq * 32; x += ahrag::kConsumers) {
    const int q = q0 + x / 32, c4 = x % 32;
    const float* p = P + q * kPitch + 4 * c4;
    float4 w[8];                                 // every remote load in flight at once
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < split) w[r] = ahrag::ld_cluster_f4(p, r);
    float4 v = w[0];
#pragma unroll
    for (int r = 1; r < 8; ++r) {
      if (r < split) {
        v.x = fmaxf(v.x, w[r].x);
        v.y = fmaxf(v.y, w[r].y);
        v.z = fmaxf(v.z, w[r].z);
        v.w = fmaxf(v.w, w[r].w);
      }
    }
    store(q, c4, v);
  }
  ahrag::cluster_sync();
}

// The producer warp: lane 0 streams the block's share; in a split kernel the
// warp then joins merge_split's two cluster barriers.
template <bool kSplit, typename Ring>
__device__ __forceinline__ void producer_warp(Ring& ring, const CUtensorMap* emb_map,
                                              const CUtensorMap* q_map, int D, int chunks,
                                              const ahrag::Share& sh) {
  if ((threadIdx.x & 31) == 0) ring.produce(emb_map, q_map, D, chunks, sh);
  if constexpr (kSplit) {
    __syncwarp();
    ahrag::cluster_sync();
    ahrag::cluster_sync();
  }
}

// A bf16 thread's bin maxima (bf16_tile_bins' registers) into P.
template <int QC>
__device__ __forceinline__ void bf16_part(float* P, const float (&mx)[QC / 2], int bin0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < QC / 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      P[(8 * j + 2 * (lane & 3) + (h & 1)) * kPitch + bin0 + 8 * (h >> 1)] = mx[4 * j + h];
}

// ahrag_binmax2's store of query b's 32 float4 of merged bins, one a lane, and
// of their max as the tile's supermax.
__device__ __forceinline__ void store_bins2(float* __restrict__ bins, float* __restrict__ smax,
                                            int B, int num_tiles, int t, int b, int c4,
                                            float4 v) {
  if (b < B) reinterpret_cast<float4*>(bins + ((size_t)t * B + b) * kLanes)[c4] = v;
  float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (c4 == 0 && b < B) smax[(size_t)b * num_tiles + t] = m;
}

// ---- ahrag_binmax2, bf16 ---------------------------------------------------

// Each kernel comes in two kinds: kSplit false, the persistent grid (split 1),
// and kSplit, the clusters of a split (split 2, 4 or 8).
template <bool kTrivial, int QC, bool kSplit>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax2_bf16_kernel(const __grid_constant__ CUtensorMap emb_map,
                    const __grid_constant__ CUtensorMap q_map,
                    const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                    int tile_n, int num_tiles, float* __restrict__ bins,
                    float* __restrict__ smax, int split, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<__nv_bfloat16, QC> ring(smem_raw, D, red_bytes(QC));
  float* red = reinterpret_cast<float*>(ring.extra);   // [8 warps][QC queries]
  const ahrag::Share sh = ahrag::block_share<kSplit>(chunks, num_tiles, tile_n, split);
  const int c0 = (int)(sh.first % chunks) * QC;       // fixed: see Share and launch_ring
  ring.init();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == ahrag::kConsumers / 32) {
    producer_warp<kSplit>(ring, &emb_map, &q_map, D, chunks, sh);
    return;
  }
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // rows r0 and r0 + 8 of the warpgroup's 64
  const int bin0 = 64 * (warp >> 2) + r0;
  float mx[QC / 2];
  ahrag::mbar_wait(ring.qbar, 0);

  for (long long it = sh.first; it < sh.end; it += sh.step) {
    const int t = (int)(it / chunks);
    ahrag::bf16_tile_bins<kTrivial>(mx, ring, D, (long long)t * tile_n, sh.s0, sh.s1, bin0,
                                    mask, n_valid);
    if constexpr (kSplit) {                      // the block's one item
      ahrag::consumers_sync();                   // every wgmma has read its last stage
      float* P = reinterpret_cast<float*>(ring.stages);
      bf16_part<QC>(P, mx, bin0, lane);
      merge_split<QC>(P, split, [&](int q, int c4, float4 v) {
        store_bins2(bins, smax, B, num_tiles, t, c0 + q, c4, v);
      });
      return;
    }

    // bins [T, B, 128]: register 4j + h is query 8j + 2 (lane % 4) + (h & 1),
    // bin bin0 + 8 (h >> 1)
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) {
      const int b = c0 + 8 * j + 2 * (lane & 3);
      if (b < B) {
        float* o = bins + ((size_t)t * B + b) * kLanes + bin0;
        o[0] = mx[4 * j];
        o[8] = mx[4 * j + 2];
      }
      if (b + 1 < B) {
        float* o = bins + ((size_t)t * B + b + 1) * kLanes + bin0;
        o[0] = mx[4 * j + 1];
        o[8] = mx[4 * j + 3];
      }
    }
    // supermax: over the warp's 16 rows by shuffles (lane bits 2-4), then over
    // the 8 consumer warps through shared memory
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) {
      float v0 = fmaxf(mx[4 * j], mx[4 * j + 2]);
      float v1 = fmaxf(mx[4 * j + 1], mx[4 * j + 3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, off));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, off));
      }
      if (lane < 4) {
        red[warp * QC + 8 * j + 2 * lane] = v0;
        red[warp * QC + 8 * j + 2 * lane + 1] = v1;
      }
    }
    ahrag::consumers_sync();
    if (threadIdx.x < QC && c0 + threadIdx.x < B) {
      float v = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < ahrag::kConsumers / 32; ++w) v = fmaxf(v, red[w * QC + threadIdx.x]);
      smax[(size_t)(c0 + threadIdx.x) * num_tiles + t] = v;
    }
    ahrag::consumers_sync();                     // red is free for the next tile
  }
}

// ---- ahrag_binmax2, float32 ------------------------------------------------

// Queries per float32 item: 128, on a register tile of 8 rows x 8 queries a
// thread; in the split kind also 96 (8 x 6) or 64 (8 x 4), where the plan
// (binmax2_plan) finds that a narrower chunk spreads the same work over more
// blocks in one wave. Each consumer thread's running max (8 rows x QC / 16
// queries) lives in shared memory, as 8 x kQV vectors of kW floats at
// mx_s[k * 256 + tid] (consecutive lanes, consecutive 16 or 8 bytes): in
// registers beside the accumulators it spilled, since a block of 9 warps puts 3
// on one SM sub-partition and so gets at most 168 registers a thread.
// Component c of vector k holds row i = k / kQV, query j = kW (k % kQV) + c.
template <int QC>
struct Bins2F32 {
  using Tile = ahrag::F32Tile<QC, 8>;
  static constexpr int kW = Tile::kQN % 4 == 0 ? 4 : 2;
  using Vec = std::conditional_t<kW == 4, float4, float2>;
  static constexpr int kQV = Tile::kQN / kW;
  static constexpr size_t kMxBytes = (size_t)8 * kQV * ahrag::kConsumers * sizeof(Vec);
};

template <bool kTrivial, int QC, bool kSplit>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax2_f32_kernel(const __grid_constant__ CUtensorMap emb_map,
                   const __grid_constant__ CUtensorMap q_map,
                   const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                   int tile_n, int num_tiles, float* __restrict__ bins,
                   float* __restrict__ smax, int split, int chunks) {
  using F32 = typename Bins2F32<QC>::Tile;
  using Vec = typename Bins2F32<QC>::Vec;
  constexpr int kW = Bins2F32<QC>::kW, kQV = Bins2F32<QC>::kQV;
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<float, QC> ring(smem_raw, D, Bins2F32<QC>::kMxBytes);
  Vec* mx_s = reinterpret_cast<Vec*>(ring.extra) + threadIdx.x;
  const float* mx = reinterpret_cast<const float*>(mx_s);     // mx[kW * 256 * k + c]
  const ahrag::Share sh = ahrag::block_share<kSplit>(chunks, num_tiles, tile_n, split);
  ring.init();
  if (threadIdx.x >= ahrag::kConsumers) {
    producer_warp<kSplit>(ring, &emb_map, &q_map, D, chunks, sh);
    return;
  }
  constexpr int kS = ahrag::kConsumers;
  for (long long it = sh.first; it < sh.end; it += sh.step) {
    const int c0 = (int)(it % chunks) * QC, t = (int)(it / chunks);
    const long long base = (long long)t * tile_n;
    Vec ninf;
#pragma unroll
    for (int c = 0; c < kW; ++c) reinterpret_cast<float*>(&ninf)[c] = -INFINITY;
#pragma unroll
    for (int k = 0; k < 8 * kQV; ++k) mx_s[k * kS] = ninf;
    for (int sl = sh.s0; sl < sh.s1; ++sl) {
      float acc[8][F32::kQN];
      ahrag::f32_slice<QC, 8>(acc, ring, D);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = base + (long long)kLanes * sl + F32::row(i);
        const bool ok = kTrivial || (row < n_valid && mask[row] != 0);
#pragma unroll
        for (int h = 0; h < kQV; ++h) {
          Vec v = mx_s[(kQV * i + h) * kS];
          float* m = reinterpret_cast<float*>(&v);
#pragma unroll
          for (int c = 0; c < kW; ++c) m[c] = fmaxf(m[c], ok ? acc[i][kW * h + c] : kNegInf);
          mx_s[(kQV * i + h) * kS] = v;
        }
      }
    }
    if constexpr (kSplit) {                      // the block's one item
      ahrag::consumers_sync();                   // every warp has read its last stage
      float* P = reinterpret_cast<float*>(ring.stages);
#pragma unroll
      for (int j = 0; j < F32::kQN; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          P[F32::query(j) * kPitch + F32::row(i)] = mx[kW * kS * (kQV * i + j / kW) + j % kW];
      merge_split<QC>(P, split, [&](int q, int c4, float4 v) {
        store_bins2(bins, smax, B, num_tiles, t, c0 + q, c4, v);
      });
      return;
    }
    // bins (16 lanes of one query: 64 bytes); the supermax by shuffles over
    // those 16 lanes
#pragma unroll
    for (int j = 0; j < F32::kQN; ++j) {
      const int b = c0 + F32::query(j);
      float v = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = mx[kW * kS * (kQV * i + j / kW) + j % kW];
        if (b < B) bins[((size_t)t * B + b) * kLanes + F32::row(i)] = x;
        v = fmaxf(v, x);
      }
#pragma unroll
      for (int off = 1; off < F32::kTX; off <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (threadIdx.x % F32::kTX == 0 && b < B) smax[(size_t)b * num_tiles + t] = v;
    }
  }
}

// ---- ahrag_binmax ------------------------------------------------------------

// float32 register tile of ahrag_binmax at chunk QC: QC / 8 rows x 8 queries with
// each box of D split between a lane pair (QC <= 32), else 8 rows x 4 queries.
template <int QC>
struct BinmaxF32 {
  static constexpr int kRM = QC <= 32 ? QC / 8 : 8;
  static constexpr int kKS = QC <= 32 ? 2 : 1;
  using Tile = ahrag::F32Tile<QC, kRM, kKS>;
};

// bf16: the chunk resident, wgmma m64nQCk16, bf16_tile_bins' registers stored
// query-major. float32: the chunk streamed, on BinmaxF32's register tile.
template <typename T, int QC, bool kSplit>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax_qmajor_kernel(const __grid_constant__ CUtensorMap emb_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                     int tile_n, int num_tiles, float* __restrict__ out, int split,
                     int chunks) {
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<T, QC> ring(smem_raw, D, 0);
  const ahrag::Share sh = ahrag::block_share<kSplit>(chunks, num_tiles, tile_n, split);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == ahrag::kConsumers / 32) {
    producer_warp<kSplit>(ring, &emb_map, &q_map, D, chunks, sh);
    return;
  }
  const size_t ld = (size_t)num_tiles * kLanes;   // out [B, T * 128]
  // a split item's merged bins of query c0 + q, one float4 a lane
  auto store = [&](int c0, int t) {
    return [=](int q, int c4, float4 v) {
      if (c0 + q < B) reinterpret_cast<float4*>(out + (c0 + q) * ld + (size_t)t * kLanes)[c4] = v;
    };
  };

  if constexpr (sizeof(T) == 2) {
    const int c0 = (int)(sh.first % chunks) * QC;   // fixed: see Share and launch_ring
    const int bin0 = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
    float mx[QC / 2];
    ahrag::mbar_wait(ring.qbar, 0);
    for (long long it = sh.first; it < sh.end; it += sh.step) {
      const int t = (int)(it / chunks);
      ahrag::bf16_tile_bins<false>(mx, ring, D, (long long)t * tile_n, sh.s0, sh.s1, bin0,
                                   mask, n_valid);
      if constexpr (kSplit) {                    // the block's one item
        ahrag::consumers_sync();                 // every wgmma has read its last stage
        float* P = reinterpret_cast<float*>(ring.stages);
        bf16_part<QC>(P, mx, bin0, lane);
        merge_split<QC>(P, split, store(c0, t));
        return;
      }
      // register 4j + h is query 8j + 2 (lane % 4) + (h & 1), bin bin0 + 8 (h >> 1);
      // queries past B (TMA's zero rows) are never stored
      float* o = out + (size_t)t * kLanes + bin0;
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const int b = c0 + 8 * j + 2 * (lane & 3);
        if (b < B) {
          o[b * ld] = mx[4 * j];
          o[b * ld + 8] = mx[4 * j + 2];
        }
        if (b + 1 < B) {
          o[(b + 1) * ld] = mx[4 * j + 1];
          o[(b + 1) * ld + 8] = mx[4 * j + 3];
        }
      }
    }
  } else {
    using Tile = typename BinmaxF32<QC>::Tile;
    constexpr int kRM = BinmaxF32<QC>::kRM, kQN = Tile::kQN, kKS = BinmaxF32<QC>::kKS;
    for (long long it = sh.first; it < sh.end; it += sh.step) {
      const int c0 = (int)(it % chunks) * QC, t = (int)(it / chunks);
      const long long base = (long long)t * tile_n;
      float mx[kRM][kQN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kQN; ++j) mx[i][j] = -INFINITY;
      for (int sl = sh.s0; sl < sh.s1; ++sl) {
        float acc[kRM][kQN];
        ahrag::f32_slice<QC, kRM, kKS>(acc, ring, D);
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const long long row = base + (long long)kLanes * sl + Tile::row(i);
          const bool ok = row < n_valid && mask[row] != 0;
#pragma unroll
          for (int j = 0; j < kQN; ++j) mx[i][j] = fmaxf(mx[i][j], ok ? acc[i][j] : kNegInf);
        }
      }
      // with a split box both lanes of a pair hold the same maxima: lane kz
      // stores the queries j with j % 2 == kz
      if constexpr (kSplit) {                    // the block's one item
        ahrag::consumers_sync();                 // every warp has read its last stage
        float* P = reinterpret_cast<float*>(ring.stages);
#pragma unroll
        for (int j = 0; j < kQN; ++j)
          if (j % kKS == Tile::split())
#pragma unroll
            for (int i = 0; i < kRM; ++i) P[Tile::query(j) * kPitch + Tile::row(i)] = mx[i][j];
        merge_split<QC>(P, split, store(c0, t));
        return;
      }
#pragma unroll
      for (int j = 0; j < kQN; ++j) {
        const int b = c0 + Tile::query(j);
        if (j % kKS == Tile::split() && b < B) {
#pragma unroll
          for (int i = 0; i < kRM; ++i) out[b * ld + (size_t)t * kLanes + Tile::row(i)] = mx[i][j];
        }
      }
    }
  }
}

template <typename T, int QC, typename Kernel>
int launch2(Kernel kern, const void* q, const void* emb, const void* mask, long long n_valid,
            int B, long long N, int D, int tile_n, int split, long long grid, size_t extra,
            void* bins, void* smax, cudaStream_t stream) {
  const long long num_tiles = N / tile_n;
  return (int)ahrag::launch_ring<T, QC>(
      kern, q, emb, B, N, D, num_tiles, split, grid, ahrag::RingSmem<T, QC>::bytes(D, extra),
      stream,
      (const uint8_t*)mask, n_valid, B, D, tile_n, (int)num_tiles, (float*)bins, (float*)smax,
      split);
}

// The chunk qc of the wrapper's plan (binmax2_plan): bf16 128 where 128
// queries fit in shared memory (D <= 576), else 32; float32 128, or 96 or 64
// in the split kind. Any other returns cudaErrorInvalidValue.
template <bool kTrivial>
int launch2_typed(int is_bf16, int qc, const void* q, const void* emb, const void* mask,
                  long long n_valid, int B, long long N, int D, int tile_n, int split,
                  long long grid, void* bins, void* smax, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const bool sp = split > 1;
  if (!is_bf16 && qc == 128)
    return launch2<float, 128>(sp ? &binmax2_f32_kernel<kTrivial, 128, true>
                                  : &binmax2_f32_kernel<kTrivial, 128, false>,
                               q, emb, mask, n_valid, B, N, D, tile_n, split, grid,
                               Bins2F32<128>::kMxBytes, bins, smax, s);
  if (!is_bf16 && qc == 96 && sp)
    return launch2<float, 96>(&binmax2_f32_kernel<kTrivial, 96, true>, q, emb, mask, n_valid,
                              B, N, D, tile_n, split, grid, Bins2F32<96>::kMxBytes, bins, smax, s);
  if (!is_bf16 && qc == 64 && sp)
    return launch2<float, 64>(&binmax2_f32_kernel<kTrivial, 64, true>, q, emb, mask, n_valid,
                              B, N, D, tile_n, split, grid, Bins2F32<64>::kMxBytes, bins, smax, s);
  const bool fits = ahrag::RingSmem<bf16, 128>::bytes(D, red_bytes(128)) <= kSmemLimit;
  if (is_bf16 && qc == 128 && fits)
    return launch2<bf16, 128>(sp ? &binmax2_bf16_kernel<kTrivial, 128, true>
                                 : &binmax2_bf16_kernel<kTrivial, 128, false>,
                              q, emb, mask, n_valid, B, N, D, tile_n, split, grid, red_bytes(128),
                              bins, smax, s);
  if (is_bf16 && qc == 32 && !fits)
    return launch2<bf16, 32>(sp ? &binmax2_bf16_kernel<kTrivial, 32, true>
                                : &binmax2_bf16_kernel<kTrivial, 32, false>,
                             q, emb, mask, n_valid, B, N, D, tile_n, split, grid, red_bytes(32), bins,
                             smax, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int QC>
int launch1(const void* q, const void* emb, const void* mask, long long n_valid, int B,
            long long N, int D, int tile_n, int split, long long grid, void* out,
            cudaStream_t stream) {
  const long long num_tiles = N / tile_n;
  const size_t smem = ahrag::RingSmem<T, QC>::bytes(D, 0);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)ahrag::launch_ring<T, QC>(
      split > 1 ? &binmax_qmajor_kernel<T, QC, true> : &binmax_qmajor_kernel<T, QC, false>, q, emb,
      B, N, D, num_tiles, split, grid, smem, stream, (const uint8_t*)mask, n_valid, B, D, tile_n,
      (int)num_tiles, (float*)out, split);
}

// The chunk qc: 8, 16, 32 or 64 queries, and in bf16 also 128.
template <typename T>
int launch1_chunk(int qc, const void* q, const void* emb, const void* mask, long long n_valid,
                  int B, long long N, int D, int tile_n, int split, long long grid, void* out,
                  cudaStream_t s) {
  switch (qc) {
    case 8: return launch1<T, 8>(q, emb, mask, n_valid, B, N, D, tile_n, split, grid, out, s);
    case 16: return launch1<T, 16>(q, emb, mask, n_valid, B, N, D, tile_n, split, grid, out, s);
    case 32: return launch1<T, 32>(q, emb, mask, n_valid, B, N, D, tile_n, split, grid, out, s);
    case 64: return launch1<T, 64>(q, emb, mask, n_valid, B, N, D, tile_n, split, grid, out, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (qc == 128)
      return launch1<T, 128>(q, emb, mask, n_valid, B, N, D, tile_n, split, grid, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A split of 1, 2, 4 or 8 blocks (the cluster sizes every Hopper part
// schedules) that divides the tile's slices.
bool valid_split(int split, int tile_n) {
  return (split == 1 || split == 2 || split == 4 || split == 8) && (tile_n / 128) % split == 0;
}

}  // namespace

// Shapes (checked by the Python wrapper): q [B, D] and emb [N, D] of one type
// (is_bf16 ? bf16 : float32), contiguous and 16-byte aligned, N % tile_n == 0,
// tile_n % 128 == 0, D % 8 == 0; mask [N] bool; the query chunk qc, split
// and grid of the wrapper's launch plan, split 1, 2, 4 or 8 and a divisor of
// tile_n / 128, the grid one launch_ring takes (common.cuh). ahrag_binmax2:
// B % 128 == 0 and (bf16) the resident query chunk within the shared memory a
// block may opt in to (D <= 2560). Returns a
// cudaError_t code (cudaErrorInvalidValue when a TMA descriptor cannot be made
// or the chunk, split or grid is not one of these; the launch's own error when
// it is refused).
extern "C" int ahrag_binmax2(const void* q, const void* emb, const void* mask,
                             long long n_valid, int B, long long N, int D, int tile_n,
                             int qc, int split, long long grid, int is_bf16, int trivial,
                             void* bins, void* smax, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!valid_split(split, tile_n)) return (int)cudaErrorInvalidValue;
  return trivial ? launch2_typed<true>(is_bf16, qc, q, emb, mask, n_valid, B, N, D, tile_n,
                                       split, grid, bins, smax, s)
                 : launch2_typed<false>(is_bf16, qc, q, emb, mask, n_valid, B, N, D, tile_n,
                                        split, grid, bins, smax, s);
}

// ahrag_binmax: any B >= 1 in chunks of qc queries (the wrapper's binmax_chunk:
// 8, 16, 32, 64 or 128 in bf16, 8 to 64 in float32), the block's shared
// memory within what it may opt in to; any other qc or split, or a block that
// does not fit, returns cudaErrorInvalidValue before anything launches.
extern "C" int ahrag_binmax(const void* q, const void* emb, const void* mask,
                            long long n_valid, int B, long long N, int D, int tile_n, int qc,
                            int split, long long grid, int is_bf16, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!valid_split(split, tile_n)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch1_chunk<__nv_bfloat16>(qc, q, emb, mask, n_valid, B, N, D, tile_n,
                                                split, grid, out, s)
                 : launch1_chunk<float>(qc, q, emb, mask, n_valid, B, N, D, tile_n, split,
                                        grid, out, s);
}

// Clusters of `split` blocks (1, 2, 4 or 8) that the current device runs at
// once with one block per SM, written to *clusters: cudaOccupancyMaxActiveClusters
// for a ring kernel of the split kind at the most shared memory a block may
// opt in to, which leaves room for one block per SM. A cluster stays within one
// GPC, so on a part whose GPCs hold unequal SM counts this can fall short of
// SMs / split. The wrapper's launch plan takes it as the size of a wave.
extern "C" int ahrag_cluster_slots(int split, int* clusters) {
  if (!valid_split(split, 1024)) return (int)cudaErrorInvalidValue;
  const auto kern = &binmax_qmajor_kernel<float, 8, true>;
  cudaError_t err = ahrag::opt_in(kern, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)split);
  cfg.blockDim = dim3(ahrag::kRingThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kern, &cfg);
}
