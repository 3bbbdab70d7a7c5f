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
// Both run on the TMA ring of common.cuh:
//   - a persistent grid, one block per SM, works through the (query chunk,
//     tile) items with the chunks of one tile taken up together, so that their
//     requests for it can be served from L2 (not measured: no DRAM counter is
//     read);
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
// ahrag_binmax2 (the main path; B % 128 == 0): a 4-stage ring; bf16 chunks of
// QC = 128 queries (32 where 128 of them do not fit, D > 576); float32 chunks
// of 128 on a register tile of 8 rows x 8 queries, its running max in shared
// memory. Bins are stored from registers; the supermax is reduced by shuffles
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

#include "common.cuh"

namespace {

using ahrag::kNegInf;
using ahrag::kSmemLimit;

constexpr int kLanes = 128;      // bins per tile
// supermax exchange of a bf16 QC-query chunk: [8 consumer warps][QC]
__host__ __device__ constexpr size_t red_bytes(int QC) { return (size_t)8 * QC * sizeof(float); }

// ---- ahrag_binmax2, bf16 ---------------------------------------------------

template <bool kTrivial, int QC>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax2_bf16_kernel(const __grid_constant__ CUtensorMap emb_map,
                    const __grid_constant__ CUtensorMap q_map,
                    const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                    int tile_n, int num_tiles, float* __restrict__ bins,
                    float* __restrict__ smax, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<__nv_bfloat16, QC> ring(smem_raw, D, red_bytes(QC));
  float* red = reinterpret_cast<float*>(ring.extra);   // [8 warps][QC queries]
  const int c0 = (int)(blockIdx.x % chunks) * QC;     // fixed: gridDim.x % chunks == 0
  ring.init();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == ahrag::kConsumers / 32) {           // producer warp
    if (lane == 0) ring.produce(&emb_map, &q_map, D, tile_n, chunks, num_tiles);
    return;
  }
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // rows r0 and r0 + 8 of the warpgroup's 64
  const int bin0 = 64 * (warp >> 2) + r0;
  float mx[QC / 2];
  ahrag::mbar_wait(ring.qbar, 0);

  for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
    const int t = (int)(it / chunks);
    ahrag::bf16_tile_bins<kTrivial>(mx, ring, D, (long long)t * tile_n, tile_n, bin0, mask,
                                    n_valid);

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

constexpr int kQCf = 128;                        // queries per float32 item
using F32 = ahrag::F32Tile<kQCf, 8>;             // 8 rows x 8 queries a thread
// Each consumer thread's running max (8 x 8) lives in shared memory, as 16
// float4 at mx_s[k * 256 + tid] (consecutive lanes, consecutive 16 bytes): in
// registers beside the 64 accumulators it spilled, since a block of 9 warps
// puts 3 on one SM sub-partition and so gets at most 168 registers a thread.
// Component c of float4 k holds row i = k / 2, query j = 4 (k % 2) + c.
constexpr size_t kMxBytes = (size_t)16 * ahrag::kConsumers * sizeof(float4);

template <bool kTrivial>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax2_f32_kernel(const __grid_constant__ CUtensorMap emb_map,
                   const __grid_constant__ CUtensorMap q_map,
                   const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                   int tile_n, int num_tiles, float* __restrict__ bins,
                   float* __restrict__ smax, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<float, kQCf> ring(smem_raw, D, kMxBytes);
  float4* mx_s = reinterpret_cast<float4*>(ring.extra) + threadIdx.x;
  const float* mx = reinterpret_cast<const float*>(mx_s);     // mx[4 * 256 * k + c]
  ring.init();
  if (threadIdx.x >= ahrag::kConsumers) {         // producer warp
    if (threadIdx.x == ahrag::kConsumers)
      ring.produce(&emb_map, &q_map, D, tile_n, chunks, num_tiles);
    return;
  }
  constexpr int kS = ahrag::kConsumers;
  for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
    const int c0 = (int)(it % chunks) * kQCf, t = (int)(it / chunks);
    const long long base = (long long)t * tile_n;
#pragma unroll
    for (int k = 0; k < 16; ++k) mx_s[k * kS] = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    for (int sl = 0; sl < tile_n / kLanes; ++sl) {
      float acc[8][F32::kQN];
      ahrag::f32_slice<kQCf, 8>(acc, ring, D);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = base + (long long)kLanes * sl + F32::row(i);
        const bool ok = kTrivial || (row < n_valid && mask[row] != 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 m = mx_s[(2 * i + h) * kS];
          m.x = fmaxf(m.x, ok ? acc[i][4 * h] : kNegInf);
          m.y = fmaxf(m.y, ok ? acc[i][4 * h + 1] : kNegInf);
          m.z = fmaxf(m.z, ok ? acc[i][4 * h + 2] : kNegInf);
          m.w = fmaxf(m.w, ok ? acc[i][4 * h + 3] : kNegInf);
          mx_s[(2 * i + h) * kS] = m;
        }
      }
    }
    // bins (16 lanes of one query: 64 bytes); the supermax by shuffles over
    // those 16 lanes
#pragma unroll
    for (int j = 0; j < F32::kQN; ++j) {
      const int b = c0 + F32::query(j);
      float v = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = mx[4 * kS * (2 * i + j / 4) + j % 4];
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
template <typename T, int QC>
__global__ void __launch_bounds__(ahrag::kRingThreads, 1)
binmax_qmajor_kernel(const __grid_constant__ CUtensorMap emb_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const uint8_t* __restrict__ mask, long long n_valid, int B, int D,
                     int tile_n, int num_tiles, float* __restrict__ out, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  ahrag::Ring<T, QC> ring(smem_raw, D, 0);
  ring.init();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == ahrag::kConsumers / 32) {           // producer warp
    if (lane == 0) ring.produce(&emb_map, &q_map, D, tile_n, chunks, num_tiles);
    return;
  }
  const size_t ld = (size_t)num_tiles * kLanes;   // out [B, T * 128]

  if constexpr (sizeof(T) == 2) {
    const int c0 = (int)(blockIdx.x % chunks) * QC;   // fixed: gridDim.x % chunks == 0
    const int bin0 = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
    float mx[QC / 2];
    ahrag::mbar_wait(ring.qbar, 0);
    for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
      const int t = (int)(it / chunks);
      ahrag::bf16_tile_bins<false>(mx, ring, D, (long long)t * tile_n, tile_n, bin0, mask,
                                   n_valid);
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
    for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
      const int c0 = (int)(it % chunks) * QC, t = (int)(it / chunks);
      const long long base = (long long)t * tile_n;
      float mx[kRM][kQN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kQN; ++j) mx[i][j] = -INFINITY;
      for (int sl = 0; sl < tile_n / kLanes; ++sl) {
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

template <typename T, bool kTrivial, int QC, typename Kernel>
int launch2(Kernel kern, const void* q, const void* emb, const void* mask, long long n_valid,
            int B, long long N, int D, int tile_n, size_t extra, void* bins, void* smax,
            cudaStream_t stream) {
  const long long num_tiles = N / tile_n;
  return (int)ahrag::launch_ring<T, QC>(
      kern, q, emb, B, N, D, num_tiles, ahrag::RingSmem<T, QC>::bytes(D, extra), stream,
      (const uint8_t*)mask, n_valid, B, D, tile_n, (int)num_tiles, (float*)bins, (float*)smax);
}

// bf16 in chunks of 128 queries where they fit in shared memory (D <= 576),
// else of 32; float32 in chunks of 128.
template <bool kTrivial>
int launch2_typed(int is_bf16, const void* q, const void* emb, const void* mask,
                  long long n_valid, int B, long long N, int D, int tile_n, void* bins,
                  void* smax, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (!is_bf16)
    return launch2<float, kTrivial, kQCf>(binmax2_f32_kernel<kTrivial>, q, emb, mask, n_valid,
                                          B, N, D, tile_n, kMxBytes, bins, smax, s);
  if (ahrag::RingSmem<bf16, 128>::bytes(D, red_bytes(128)) <= kSmemLimit)
    return launch2<bf16, kTrivial, 128>(binmax2_bf16_kernel<kTrivial, 128>, q, emb, mask,
                                        n_valid, B, N, D, tile_n, red_bytes(128), bins, smax, s);
  return launch2<bf16, kTrivial, 32>(binmax2_bf16_kernel<kTrivial, 32>, q, emb, mask, n_valid,
                                     B, N, D, tile_n, red_bytes(32), bins, smax, s);
}

template <typename T, int QC>
int launch1(const void* q, const void* emb, const void* mask, long long n_valid, int B,
            long long N, int D, int tile_n, void* out, cudaStream_t stream) {
  const long long num_tiles = N / tile_n;
  const size_t smem = ahrag::RingSmem<T, QC>::bytes(D, 0);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return (int)ahrag::launch_ring<T, QC>(binmax_qmajor_kernel<T, QC>, q, emb, B, N, D, num_tiles,
                                        smem, stream, (const uint8_t*)mask, n_valid, B, D,
                                        tile_n, (int)num_tiles, (float*)out);
}

// The chunk qc: 8, 16, 32 or 64 queries, and in bf16 also 128.
template <typename T>
int launch1_chunk(int qc, const void* q, const void* emb, const void* mask, long long n_valid,
                  int B, long long N, int D, int tile_n, void* out, cudaStream_t s) {
  switch (qc) {
    case 8: return launch1<T, 8>(q, emb, mask, n_valid, B, N, D, tile_n, out, s);
    case 16: return launch1<T, 16>(q, emb, mask, n_valid, B, N, D, tile_n, out, s);
    case 32: return launch1<T, 32>(q, emb, mask, n_valid, B, N, D, tile_n, out, s);
    case 64: return launch1<T, 64>(q, emb, mask, n_valid, B, N, D, tile_n, out, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (qc == 128) return launch1<T, 128>(q, emb, mask, n_valid, B, N, D, tile_n, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shapes (checked by the Python wrapper): q [B, D] and emb [N, D] of one type
// (is_bf16 ? bf16 : float32), contiguous and 16-byte aligned, N % tile_n == 0,
// tile_n % 128 == 0, D % 8 == 0; mask [N] bool. ahrag_binmax2: B % 128 == 0 and
// (bf16) the resident query chunk within the shared memory a block may opt in to
// (D <= 2560). Returns a cudaError_t code (cudaErrorInvalidValue when a TMA
// descriptor cannot be made).
extern "C" int ahrag_binmax2(const void* q, const void* emb, const void* mask,
                             long long n_valid, int B, long long N, int D, int tile_n,
                             int is_bf16, int trivial, void* bins, void* smax,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return trivial ? launch2_typed<true>(is_bf16, q, emb, mask, n_valid, B, N, D, tile_n, bins,
                                       smax, s)
                 : launch2_typed<false>(is_bf16, q, emb, mask, n_valid, B, N, D, tile_n, bins,
                                        smax, s);
}

// ahrag_binmax: any B >= 1 in chunks of qc queries (the wrapper's binmax_chunk:
// 8, 16, 32, 64 or 128 in bf16, 8 to 64 in float32), the block's shared
// memory within what it may opt in to; any other qc, or a block that does not
// fit, returns cudaErrorInvalidValue before anything launches.
extern "C" int ahrag_binmax(const void* q, const void* emb, const void* mask,
                            long long n_valid, int B, long long N, int D, int tile_n, int qc,
                            int is_bf16, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch1_chunk<__nv_bfloat16>(qc, q, emb, mask, n_valid, B, N, D, tile_n,
                                                out, s)
                 : launch1_chunk<float>(qc, q, emb, mask, n_valid, B, N, D, tile_n, out, s);
}
