// The small-batch mainloop of csrc/score_topk.cu and csrc/fused_topk.cu, for
// Hopper (sm_90a): a query tile of NQ = 8, 16, 24 or 32 rows (Nq rounded up
// to 8, as the TPU kernel's tile, ops/pallas/fused_topk.py:203) against
// 1,024-row gallery tiles streamed by TMA.
//
//   acc[g, q] = sum_d Q[q, d] * G[g, d]
//
// Invariant, the one csrc/sgemm_tile.cuh keeps, so the two forms give the
// same bits: every accumulator starts at 0.f and takes fmaf(q[d], g[d], acc)
// for d = 0, 1, ..., D - 1 in order (then fmaf(0, 0, acc) over the zero
// fill up to a whole stage, which changes no value). No split-K, no tensor
// cores, no reassociation. A query scores the same in either form and in any
// batch, and duplicate rows tie.
//
// Bound. At config 5's shape (20 queries, 1M x 2048 bf16 gallery) the
// gallery's 4.10 GB take 1.22 ms at 3.35 TB/s and the 8.2e10 flop 1.22 ms at
// 67 TFLOP/s f32; with the tile at 24 rows the FMA units do 1.47 ms of work,
// so the form is bound by its FMAs there and by bytes at NQ <= 16 (Nq = 1,
// 100k x 2048 f32: 0.82 GB, 0.245 ms). The 128-row form ran all 128 rows
// at any Nq (5.2e11 flop at Nq = 20).
//
// Shape and why:
// - 384 threads: warps 0-7 (warpgroups 0-1) compute, warpgroup 2 produces.
//   setmaxnreg gives the consumers 232 registers and the producers 40 (a
//   launch of 9 warps would cap every thread at 168: an SM sub-partition
//   holding three warps shares its 16K registers three ways, and the
//   accumulators spilled). Consumer warp w, lane l keeps rows w*128 +
//   j*32 + l (j = 0..3) of the tile against all NQ queries: 4 x NQ
//   accumulators (up to 128 registers). A gallery value is
//   read from shared memory once a thread, widened once (bf16 -> f32 is
//   exact: the bf16 is the high half of its f32) and used for NQ FMAs; the
//   queries are read as float4 broadcasts (every lane the same address), one
//   for 16 FMAs. Per dim a thread issues 4 x NQ FMAs against NQ / 4 + 4 + 1/2
//   other instructions (~11 % at NQ = 24).
// - Stages of 32 bytes of every tile row (16 bf16 or 8 f32 dims), 32 KB of
//   gallery and the queries' same dims (NQ x 64 bytes at most), in a ring
//   of 4 behind full/empty mbarriers: the producer has 3-4 stages (~100 KB)
//   in flight per SM, which HBM's rate needs at one block an SM. The
//   gallery lands by four TMA boxes of [256 rows, 32 bytes], swizzled 32B
//   (16-byte chunk c of row r at c ^ ((r >> 2) & 1), so the 8 rows a
//   quarter-warp reads fall in 8 distinct bank groups), with L2 promotion of
//   128 bytes: a row's next 3 stages come from L2 (256 bytes keeps twice
//   as much of L2 busy a tile, and was no faster). The queries land by one
//   box of [NQ rows, stage dims], unswizzled. Rows and dims past the tensor
//   land as zeros; a box wholly past the gallery is not issued (its rows are
//   never results).
// - Where TMA cannot take the operands (a gallery or query pointer not
//   16-byte aligned, or D * element size not a multiple of 16: a row slice,
//   an odd D), the 128 producers fill the same layout with element loads
//   (tma == false, a launch argument): the same tiles, stages and FMA
//   order, slower.
// - A block walks a contiguous split of the gallery made of whole 256-row
//   runs (split_rows, the formula of ops/kernels/fused_topk.py::_split_rows)
//   in 1,024-row tiles from its first row, the last one cut at the split's
//   end (its boxes past the end are not issued, its rows never results);
//   the producer streams the split's (tile, stage) sequence without a
//   pause, so the next tile's stages land while the consumers run a tile's
//   epilogue. With one query tile the splits are all the card has to
//   spread over: the wrapper's plan makes as many as there are SMs, and
//   256-row runs keep them within a run of each other (1,024-row ones left
//   34 of 132 SMs idle at 100k rows).
// Shared memory: the ring, 140,352 bytes with its alignment slack and
// barriers (fused_topk adds each query's list). nvcc -Xptxas -v (logged
// beside each library) reports the launch bound's 168 registers at entry;
// the consumers run on setmaxnreg's 232.

#pragma once

#include <cuda.h>  // CUtensorMap: the type only, nothing links the driver library
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "bf16_gemm.cuh"

namespace narrow {

constexpr int WARPS = 8;                    // consumer warps (warpgroups 0-1)
constexpr int PRODUCERS = 128;              // producer threads (warpgroup 2)
constexpr int THREADS = WARPS * 32 + PRODUCERS;
constexpr int CONSUMER_REGS = 232;          // setmaxnreg: 2 x 232 + 40 a sub-partition
constexpr int PRODUCER_REGS = 40;
constexpr int ROWS = 4;                     // gallery rows a consumer thread keeps
constexpr int TILE_ROWS = WARPS * 32 * ROWS;  // 1,024 gallery rows a tile
constexpr int ROW_BYTES = 32;               // bytes of a gallery row a stage
constexpr int BOX_ROWS = 256;               // rows of one TMA box (its limit), a split's unit
constexpr int STAGES = 4;
constexpr int MAX_NQ = 32;                  // widths 8, 16, 24, 32
constexpr int GALLERY_BYTES = TILE_ROWS * ROW_BYTES;        // 32,768
constexpr int QUERY_BYTES = MAX_NQ * (ROW_BYTES / 2) * 4;   // 16 dims x f32 a query
constexpr int STAGE_BYTES = GALLERY_BYTES + QUERY_BYTES;    // 34,816 (1,024-aligned)
constexpr int RING_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

// dims of a row a stage, and dims of a 16-byte chunk
template <typename T>
struct Geo {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int KC = ROW_BYTES / ES;  // 16 bf16, 8 f32
  static constexpr int DPC = 16 / ES;        // 8 bf16, 4 f32
};

// mbarriers, TMA and setmaxnreg as the bf16 bottleneck's mainloop has them
using bf16mm::mbar_arrive;
using bf16mm::mbar_expect_tx;
using bf16mm::mbar_init;
using bf16mm::mbar_init_fence;
using bf16mm::mbar_wait;
using bf16mm::regs_alloc;
using bf16mm::regs_dealloc;
using bf16mm::smem_u32;
using bf16mm::tma_load_2d;

// the consumer warps' own barrier (id 1; __syncthreads is 0)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}

// Gallery rows [r0, r1) of split s of n: a balanced partition of the
// ceil(Ng / 256) runs of BOX_ROWS rows (ops/kernels/fused_topk.py::_split_rows
// is the same formula); r1 may pass Ng.
__device__ __forceinline__ void split_rows(int s, int n, int Ng, int& r0, int& r1) {
  const int units = (Ng + BOX_ROWS - 1) / BOX_ROWS;
  r0 = (int)((long long)s * units / n) * BOX_ROWS;
  r1 = (int)((long long)(s + 1) * units / n) * BOX_ROWS;
}

// The swizzle of TMA's 32B mode (address bit 7 into bit 4): 16-byte chunk
// c of stage row r sits at chunk c ^ swz(r), so the 8 consecutive rows a
// quarter-warp reads fall in 8 distinct bank groups.
__host__ __device__ constexpr int swz(int r) { return (r >> 2) & 1; }

// The ring in dynamic shared memory: stages from the first 1,024-aligned
// byte, then the full and empty barriers; `after` is the first free byte.
struct Ring {
  char* base;
  // the offset is added to `raw` itself, so the compiler keeps the shared
  // address space and reads stages with LDS, not generic loads
  __device__ __forceinline__ explicit Ring(unsigned char* raw)
      : base(reinterpret_cast<char*>(raw) + ((1024u - (smem_u32(raw) & 1023u)) & 1023u)) {}
  __device__ __forceinline__ char* gallery(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ float* queries(int s) const {
    return reinterpret_cast<float*>(gallery(s) + GALLERY_BYTES);
  }
  __device__ __forceinline__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  }
  __device__ __forceinline__ uint64_t* empty() const { return full() + STAGES; }
  __device__ __forceinline__ char* after() const {
    return reinterpret_cast<char*>(empty() + STAGES);
  }
  // by one thread, before the block's first barrier: a full barrier takes
  // the producers' arrivals (one with TMA, one a thread without), an empty
  // one an arrival from each consumer warp
  __device__ __forceinline__ void init(int producer_arrivals) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full() + s, producer_arrivals);
      mbar_init(empty() + s, WARPS);
    }
    mbar_init_fence();
  }
};

__device__ __forceinline__ uint16_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits32(float v) { return __float_as_uint(v); }

// The producers: stage after stage of the tiles [t0, t1), each its gallery
// rows' 32 bytes and the queries' same dims. With TMA producer 0 issues the
// boxes; without, the 128 producers fill the same layout element by
// element. `p` is the thread's index among the producers.
template <typename T, int NQ>
__device__ __forceinline__ void produce(bool tma, const Ring& ring, const CUtensorMap* mg,
                                        const CUtensorMap* mq, const float* __restrict__ Q,
                                        const T* __restrict__ G, int q0, int r0, int r1,
                                        int Nq, int Ng, int D, int p) {
  using Gm = Geo<T>;
  if (tma && p != 0) return;
  const int nk = (D + Gm::KC - 1) / Gm::KC;
  const int end = min(r1, Ng);
  int it = 0;
  for (int g0 = r0; g0 < r1; g0 += TILE_ROWS) {
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (uint32_t)(it / STAGES) & 1u;
      mbar_wait(ring.empty() + s, ph ^ 1u);  // the first round passes at once
      const int k0 = kc * Gm::KC;
      char* gs = ring.gallery(s);
      float* qs = ring.queries(s);
      if (tma) {
        int boxes = 0;
        while (boxes < TILE_ROWS / BOX_ROWS && g0 + boxes * BOX_ROWS < end) ++boxes;
        mbar_expect_tx(ring.full() + s,
                       (uint32_t)(boxes * BOX_ROWS * ROW_BYTES + NQ * Gm::KC * 4));
        for (int b = 0; b < boxes; ++b)
          tma_load_2d(gs + b * BOX_ROWS * ROW_BYTES, mg, k0, g0 + b * BOX_ROWS, ring.full() + s);
        tma_load_2d(qs, mq, k0, q0, ring.full() + s);
      } else {
        for (int e = p; e < TILE_ROWS * Gm::KC; e += PRODUCERS) {
          const int r = e / Gm::KC, d = e % Gm::KC;
          const int g = g0 + r, dim = k0 + d;
          const bool in = g < end && dim < D;
          const int byte = d * Gm::ES;
          char* dst = gs + r * ROW_BYTES + (((byte >> 4) ^ swz(r)) << 4) + (byte & 15);
          if constexpr (Gm::ES == 2) {
            *reinterpret_cast<uint16_t*>(dst) = in ? bits16(G[(size_t)g * D + dim]) : (uint16_t)0;
          } else {
            *reinterpret_cast<uint32_t*>(dst) = in ? bits32(G[(size_t)g * D + dim]) : 0u;
          }
        }
        for (int e = p; e < NQ * Gm::KC; e += PRODUCERS) {
          const int q = e / Gm::KC, d = e % Gm::KC;
          qs[e] = q0 + q < Nq && k0 + d < D ? Q[(size_t)(q0 + q) * D + k0 + d] : 0.f;
        }
        mbar_arrive(ring.full() + s);  // each producer: its own writes released
      }
    }
  }
}

// value i (0..DPC-1) of a 16-byte chunk, as f32 (bf16 widened exactly: the
// lower dim sits in the low half of its word)
template <typename T>
__device__ __forceinline__ float elem(const uint4& w, int i) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
  if (sizeof(T) == 4) return __uint_as_float(v[i]);
  const uint32_t u = v[i >> 1];
  return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
}

// The FMAs of one stage: acc[j][q] over the stage's dims in order.
template <typename T, int NQ>
__device__ __forceinline__ void fma_stage(float (&acc)[ROWS][NQ], const char* gs,
                                          const float* qs, int warp, int lane) {
  using Gm = Geo<T>;
  const int sw = swz(lane);  // the swizzle of this thread's rows (row % 128 == lane % 128)
  const char* rowp = gs + (warp * 32 * ROWS + lane) * ROW_BYTES;
#pragma unroll 1
  for (int c = 0; c < ROW_BYTES / 16; ++c) {
    uint4 raw[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      raw[j] = *reinterpret_cast<const uint4*>(rowp + j * 32 * ROW_BYTES + ((c ^ sw) << 4));
#pragma unroll
    for (int d4 = 0; d4 < Gm::DPC; d4 += 4) {
      float g[ROWS][4];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[j][e] = elem<T>(raw[j], d4 + e);
      const float* qp = qs + c * Gm::DPC + d4;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 qv = *reinterpret_cast<const float4*>(qp + q * Gm::KC);
        const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < ROWS; ++j) acc[j][q] = fmaf(qe[e], g[j][e], acc[j][q]);
      }
    }
  }
}

// The consumer warps: for each tile of rows [r0, r1), the scores of its
// rows against the query tile in registers, then epi(g0, acc) (g0: the
// tile's first row) while the producer fills the next tile's stages.
template <typename T, int NQ, typename Epi>
__device__ __forceinline__ void consume(const Ring& ring, int r0, int r1, int D, int warp,
                                        int lane, Epi&& epi) {
  const int nk = (D + Geo<T>::KC - 1) / Geo<T>::KC;
  int it = 0;
  for (int g0 = r0; g0 < r1; g0 += TILE_ROWS) {
    float acc[ROWS][NQ];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[j][q] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % STAGES;
      mbar_wait(ring.full() + s, (uint32_t)(it / STAGES) & 1u);
      fma_stage<T, NQ>(acc, ring.gallery(s), ring.queries(s), warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty() + s);
    }
    epi(g0, acc);
  }
}

// Tile-local gallery row of register row j.
__device__ __forceinline__ int tile_row(int j, int warp, int lane) {
  return warp * 32 * ROWS + j * 32 + lane;
}

}  // namespace narrow

// ---- host: tensor maps ------------------------------------------------------
namespace narrow_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a driver entry point, found through the runtime (no driver library linked)
static void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

// Let `kernel` take `bytes` of dynamic shared memory, once per device
// (devices 0-63; the attribute belongs to the device's context): `done`
// is the caller's own flag word for this kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Whether TMA takes the operands: both 16-byte aligned and rows a multiple
// of 16 bytes (then the f32 queries' rows are too).
template <typename T>
inline bool tma_ok(const void* q, const void* g, int D) {
  return ((uintptr_t)q & 15) == 0 && ((uintptr_t)g & 15) == 0 && (D * sizeof(T)) % 16 == 0 &&
         (D * sizeof(float)) % 16 == 0;
}

// [rows, D] row-major in boxes of [box_rows, box_cols]; out-of-range
// elements land as zeros
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* p,
                     long long rows, int D, int box_cols, int box_rows, CUtensorMapSwizzle sw,
                     CUtensorMapL2promotion l2) {
  static const EncodeTiled enc = (EncodeTiled)driver_fn("cuTensorMapEncodeTiled");
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, l2,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The gallery's and the queries' maps for a query tile of nq rows; with
// `tma` false both stay zeroed (the kernel's element loads take over).
template <typename T>
static bool make_maps(CUtensorMap* mg, CUtensorMap* mq, bool tma, const void* q, const void* g,
                      int Nq, int Ng, int D, int nq) {
  memset(mg, 0, sizeof(*mg));
  memset(mq, 0, sizeof(*mq));
  if (!tma) return true;
  const bool bf16 = sizeof(T) == 2;
  return make_map(mg, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  (int)sizeof(T), g, Ng, D, narrow::Geo<T>::KC, narrow::BOX_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B) &&
         make_map(mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, Nq, D, narrow::Geo<T>::KC, nq,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

}  // namespace narrow_host
