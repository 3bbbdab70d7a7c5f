// Device helpers shared by the port's kernels (binmax.cu, tile_topk.cu).
//
// Every kernel runs on the TMA ring (TMA loads into 128-byte-swizzled shared
// memory through mbarrier stages, one producer warp, a persistent grid), and
// every product loop is exact for its storage type up to summation order. The
// ring has two consumers: bf16_slice, bf16 x bf16 products on the tensor cores
// (wgmma) with float32 accumulation, whose products are exact and whose sums
// the tensor core orders, with no score rounded to bf16 anywhere; and
// f32_slice, IEEE float32 fmaf on register tiles, no TF32, in ascending d
// (or in ascending d within each half of every box, the halves then added).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ahrag {

constexpr float kNegInf = -1e30f;
// dynamic shared memory a block may opt in to on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;

// ---------------------------------------------------------------------------
// The TMA ring: TMA loads into 128-byte-swizzled shared memory through an
// mbarrier ring, consumed by wgmma m64nNk16 (bf16, both operands K-major in
// shared memory) or by register-tiled FMA (float32).
//
// A TMA box is one 128-byte swizzle row along D (64 bf16 or 32 float32) by R
// rows; in shared memory row r of a box sits at byte 128 * r with its 16-byte
// chunks XOR-ed by r % 8, in atoms of 8 rows (1024 bytes). A wgmma descriptor
// over such a box has the SWIZZLE_128B layout, a stride of 1024 bytes between
// 8-row atoms, and advances by 32 bytes for each k16 step inside the box. D
// takes ceil(D / box) boxes; TMA fills the columns past D of the last one with
// zeros, which add nothing to the products, so any D % 8 == 0 (a row pitch of
// a multiple of 16 bytes) works.

template <typename T>
struct Box {
  static constexpr int kElems = 128 / (int)sizeof(T);   // elements of D per box row
  __host__ __device__ static constexpr int count(int D) { return (D + kElems - 1) / kElems; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait that lasts
// seconds (a producer and its consumers out of step) traps, so it fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 1; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if ((n & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// One 2-D TMA load of the box at (element c0 along D, row c1) into dst; rows past
// the tensor's end arrive as zeros. Completion counts the whole box's bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled, K-major operand.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
       | (1ull << 16)                        // leading offset (unused when swizzled)
       | ((uint64_t)(1024 >> 4) << 32)       // 8-row atoms 1024 bytes apart
       | (1ull << 62);                       // SWIZZLE_128B
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64] += A(64 x 16, smem desc) . B(16 x 128, smem desc)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[16] += A(64 x 16, smem desc) . B(16 x 32, smem desc)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[8] += A(64 x 16, smem desc) . B(16 x 16, smem desc)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[4] += A(64 x 16, smem desc) . B(16 x 8, smem desc)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A(64 x 16, smem desc) . B(16 x 64, smem desc)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                          int scale_d) {
  static_assert(N == 128 || N == 64 || N == 32 || N == 16 || N == 8,
                "wgmma N of 128, 64, 32, 16 or 8");
  if constexpr (N == 128) wgmma_m64n128k16(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16(d, da, db, scale_d);
  else if constexpr (N == 16) wgmma_m64n16k16(d, da, db, scale_d);
  else wgmma_m64n8k16(d, da, db, scale_d);
}

// The ring's shape. A block has 8 consumer warps (threads 0-255: two wgmma
// warpgroups in bf16) and one producer warp (256-287), and works through the
// items it = blockIdx.x, blockIdx.x + gridDim.x, ... of the chunks x tiles
// (query chunk it % chunks of QC queries, corpus tile it / chunks), so that the
// chunks of one tile are taken up together. A stage is one 128-row corpus slice
// by one box of D (16 KB).
//   - bf16 (resident queries): the block's query chunk, all of D, stays in
//     shared memory, one panel of QC rows per box of D; gridDim.x is a
//     multiple of the chunks, so a block's chunk never changes.
//   - float32 (streamed queries): each stage also holds the chunk's box of D
//     (QC rows of 128 bytes) after the corpus box, so QC is not bounded by a
//     resident chunk and any block may take any item.
// A stage's buffer is refilled once its releasing warps (2 in bf16, one per
// warpgroup; all 8 in float32) have arrived.
constexpr int kSliceRows = 128;
constexpr int kCorpusBytes = kSliceRows * 128;
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kRingThreads = kConsumers + 32;

template <typename T, int QC>
struct RingSmem {
  static constexpr bool kStreamQ = sizeof(T) == 4;
  static constexpr int kStageBytes = kCorpusBytes + (kStreamQ ? QC * 128 : 0);
  // ring | resident query panels | caller's area | full[kStages] empty[kStages] qbar
  __host__ __device__ static size_t query_bytes(int D) {
    return kStreamQ ? 0 : (size_t)Box<T>::count(D) * QC * 128;
  }
  __host__ __device__ static size_t bytes(int D, size_t extra) {
    return 1024 /* alignment slack */ + (size_t)kStages * kStageBytes + query_bytes(D)
         + extra + (2 * kStages + 1) * sizeof(uint64_t);
  }
};

// The ring's pointers in a kernel's dynamic shared memory; `extra` is the
// caller's area between the query panels and the barriers.
template <typename T, int QC>
struct Ring {
  using Smem = RingSmem<T, QC>;
  uint8_t* stages;
  uint8_t* q_s;
  uint8_t* extra;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  int stage = 0;
  uint32_t phase = 0;

  // Offsets from smem_raw (never a round trip through an integer address), so
  // that the compiler keeps every access in the shared space (LDS/STS rather
  // than generic loads, which measured about twice as slow in the float32 loop).
  __device__ Ring(uint8_t* smem_raw, int D, size_t extra_bytes) {
    stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    q_s = stages + (size_t)kStages * Smem::kStageBytes;
    extra = q_s + Smem::query_bytes(D);
    full = reinterpret_cast<uint64_t*>(extra + extra_bytes);
    empty = full + kStages;
    qbar = empty + kStages;
  }

  // Every thread of the block calls it.
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], Smem::kStreamQ ? kConsumers / 32 : 2);
      }
      mbar_init(qbar, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  __device__ uint8_t* current() const { return stages + (size_t)stage * Smem::kStageBytes; }
  // The stage's query panel of box kb: streamed after the corpus box, or resident.
  __device__ const uint8_t* queries(int kb) const {
    return Smem::kStreamQ ? current() + kCorpusBytes : q_s + (size_t)kb * QC * 128;
  }
  __device__ void wait_full() { mbar_wait(&full[stage], phase); }
  // One releasing warp (all its lanes call it after reading the stage).
  __device__ void release_and_advance() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
    advance();
  }
  __device__ void advance() {
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }

  // The producer (one thread): the resident query panels once, then for every
  // item of this block every slice and box of D.
  __device__ void produce(const CUtensorMap* emb_map, const CUtensorMap* q_map, int D,
                          int tile_n, int chunks, int num_tiles) {
    constexpr int kE = Box<T>::kElems;
    const int kb_n = Box<T>::count(D);
    if constexpr (!Smem::kStreamQ) {
      mbar_expect_tx(qbar, (uint32_t)(kb_n * QC * 128));
      for (int kb = 0; kb < kb_n; ++kb)
        tma_load_2d(q_s + (size_t)kb * QC * 128, q_map, qbar, kb * kE,
                    (int)(blockIdx.x % chunks) * QC);
    }
    for (long long it = blockIdx.x; it < (long long)chunks * num_tiles; it += gridDim.x) {
      const int c0 = (int)(it % chunks) * QC, t = (int)(it / chunks);
      for (int i = 0; i < tile_n / kSliceRows; ++i) {
        for (int kb = 0; kb < kb_n; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Smem::kStageBytes);
          tma_load_2d(current(), emb_map, &full[stage], kb * kE, t * tile_n + i * kSliceRows);
          if constexpr (Smem::kStreamQ)
            tma_load_2d(current() + kCorpusBytes, q_map, &full[stage], kb * kE, c0);
          advance();
        }
      }
    }
  }
};

// bf16 consumer: the products of one 128-row slice into acc, warpgroup c taking
// the slice's rows 64c .. 64c + 63 as the wgmma M side and the QC queries as N.
// Accumulator register 4j + h of thread (warp w, lane l) of a warpgroup holds
// row 16 (w % 4) + l / 4 + 8 (h >> 1) and query 8j + 2 (l % 4) + (h & 1).
// The first warp of each warpgroup releases each stage.
template <int QC>
__device__ __forceinline__ void bf16_slice(float (&acc)[QC / 2], Ring<__nv_bfloat16, QC>& ring,
                                           int D) {
  const int wg = threadIdx.x / 128;
  const int kb_n = Box<__nv_bfloat16>::count(D);
  for (int kb = 0; kb < kb_n; ++kb) {
    ring.wait_full();
    const uint64_t da = sw128_desc(ring.current() + wg * 64 * 128);
    const uint64_t db = sw128_desc(ring.queries(kb));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < Box<__nv_bfloat16>::kElems / 16; ++k) {
      // +32 bytes per k16 step: +2 in the descriptor's 16-byte address units
      wgmma_k16<QC>(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (threadIdx.x % 128 < 32) ring.release_and_advance();
    else ring.advance();
  }
}

// bf16 bin maxima of one tile t: the tile's slices through bf16_slice, each
// folded into mx (bf16_slice's register layout) after masking by row, since
// slice i's row r is bin r's i-th row. Rows at or past n_valid or with mask 0
// count as -1e30 unless kTrivial. The thread's bins are bin0 and bin0 + 8.
template <bool kTrivial, int QC>
__device__ __forceinline__ void bf16_tile_bins(float (&mx)[QC / 2],
                                               Ring<__nv_bfloat16, QC>& ring, int D,
                                               long long base, int tile_n, int bin0,
                                               const uint8_t* __restrict__ mask,
                                               long long n_valid) {
  float acc[QC / 2];
#pragma unroll
  for (int x = 0; x < QC / 2; ++x) mx[x] = -INFINITY;
  for (int i = 0; i < tile_n / kSliceRows; ++i) {
    bf16_slice(acc, ring, D);
    const long long row = base + kSliceRows * i + bin0;
    const bool ok0 = kTrivial || (row < n_valid && mask[row] != 0);
    const bool ok1 = kTrivial || (row + 8 < n_valid && mask[row + 8] != 0);
#pragma unroll
    for (int x = 0; x < QC / 2; ++x) mx[x] = fmaxf(mx[x], ((x & 2) ? ok1 : ok0) ? acc[x] : kNegInf);
  }
}

// float32 consumer: IEEE fmaf of one 128-row slice against the QC queries, on
// register tiles of RM rows x QN queries, each box of D split in KS parts (1 or
// 2). Thread (kz = tid % KS, tx = tid / KS % TX, ty = tid / (KS TX)) of the 256
// consumers, TX = 128 / RM, owns rows tx + TX i (i < RM), queries ty + TY j
// (j < QN), TY = 256 / (KS TX), and the 16-byte chunks kz * 8 / KS ..
// (kz + 1) * 8 / KS - 1 of every 128-byte box row, which it sums in ascending
// d; with KS = 2 the lane pair's two partial sums are then added (one shuffle
// per accumulator), so both lanes hold the score. Per chunk a thread loads RM
// float4 of its rows (the swizzle puts the 8 lanes of a load phase, rows of
// distinct r % 8 or distinct chunks, on distinct banks) and QN float4 of its
// queries (shared by the lanes of one ty: a broadcast) for 4 RM QN FMAs. Every
// consumer warp releases each stage.
template <int QC, int RM, int KS = 1>
struct F32Tile {
  static_assert(KS == 1 || KS == 2, "a box split in 1 or 2 parts");
  static constexpr int kTX = kSliceRows / RM;
  static constexpr int kTY = kConsumers / (KS * kTX);
  static constexpr int kQN = QC / kTY;
  static_assert(kQN >= 1 && kQN * kTY == QC, "QC a multiple of 256 / (KS TX)");
  static __device__ int split() { return (int)(threadIdx.x % KS); }
  static __device__ int row(int i) { return (int)(threadIdx.x / KS % kTX) + kTX * i; }
  static __device__ int query(int j) { return (int)(threadIdx.x / (KS * kTX)) + kTY * j; }
};

template <int QC, int RM, int KS = 1>
__device__ __forceinline__ void f32_slice(float (&acc)[RM][F32Tile<QC, RM, KS>::kQN],
                                          Ring<float, QC>& ring, int D) {
  using Tile = F32Tile<QC, RM, KS>;
  const int kz = Tile::split(), tx = Tile::row(0), ty = Tile::query(0);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kQN; ++j) acc[i][j] = 0.f;
  const int kb_n = Box<float>::count(D);
  for (int kb = 0; kb < kb_n; ++kb) {
    ring.wait_full();
    const float* A = reinterpret_cast<const float*>(ring.current());
    const float* Bq = reinterpret_cast<const float*>(ring.queries(kb));
#pragma unroll
    for (int cs = 0; cs < 8 / KS; ++cs) {
      const int c = kz * (8 / KS) + cs;
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = tx + Tile::kTX * i;
        a[i] = *reinterpret_cast<const float4*>(A + r * 32 + ((c ^ (r & 7)) << 2));
      }
#pragma unroll
      for (int j = 0; j < Tile::kQN; ++j) {
        const int b = ty + Tile::kTY * j;
        const float4 bv = *reinterpret_cast<const float4*>(Bq + b * 32 + ((c ^ (b & 7)) << 2));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float v = acc[i][j];
          v = fmaf(a[i].x, bv.x, v);
          v = fmaf(a[i].y, bv.y, v);
          v = fmaf(a[i].z, bv.z, v);
          v = fmaf(a[i].w, bv.w, v);
          acc[i][j] = v;
        }
      }
    }
    ring.release_and_advance();
  }
  if constexpr (KS == 2) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < Tile::kQN; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
  }
}

// Opts a kernel in to `smem` bytes of dynamic shared memory (above the 48 KB
// default only after opting in).
template <typename K>
cudaError_t opt_in(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Named barrier over the consumer warps only (the producer warp may still be
// issuing loads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors. cuTensorMapEncodeTiled is a driver API function; it is
// fetched through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// library links against nothing beyond the CUDA runtime.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a row-major matrix [rows, D] of T in boxes of one 128-byte row along D
// by box_rows rows, 128-byte swizzle, zero fill past the last row and column.
// Returns false on failure.
template <typename T>
bool rows_map(CUtensorMap* map, const void* ptr, long long rows, int D, int box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Box<T>::kElems, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// Makes the corpus and query maps of a ring kernel (corpus boxes of 128 rows,
// query boxes of QC rows) and launches it on a persistent grid: one block per
// SM, and with resident queries a multiple of the B / QC chunks (at least one
// block per chunk, at most one per item). The kernel's first two arguments are
// the maps. Returns cudaErrorInvalidValue when a map cannot be made.
template <typename T, int QC, typename Kernel, typename... Args>
cudaError_t launch_ring(Kernel kern, const void* q, const void* emb, int B, long long N, int D,
                        long long num_tiles, size_t smem, cudaStream_t stream, Args... args) {
  CUtensorMap emb_map, q_map;
  if (!rows_map<T>(&emb_map, emb, N, D, kSliceRows) || !rows_map<T>(&q_map, q, B, D, QC))
    return cudaErrorInvalidValue;
  cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long chunks = (B + QC - 1) / QC, items = chunks * num_tiles;
  long long grid;
  if (RingSmem<T, QC>::kStreamQ) {
    grid = sms < items ? sms : items;
  } else {
    long long walks = sms / chunks;
    if (walks < 1) walks = 1;
    if (walks > num_tiles) walks = num_tiles;
    grid = chunks * walks;
  }
  kern<<<(unsigned)grid, kRingThreads, smem, stream>>>(emb_map, q_map, args..., (int)chunks);
  return cudaGetLastError();
}

}  // namespace ahrag
