// bf16 tensor-core GEMM mainloop for Hopper (sm_90a), device code only:
// warp-specialised and fed by TMA. One producer thread keeps a ring of
// shared-memory stages full behind full/empty mbarriers; two consumer
// warpgroups run wgmma with both operands in shared memory and write each
// output tile through shared memory with TMA stores.
// csrc/bottleneck_bf16.cu runs its three convolutions on it.
//
//   C[m, n] = sum_k A[m, k] * B[k, n]   for BM x BN output tiles
//
// A is bf16 [M, K] (a plain matrix or, through TMA's im2col mode, a 3x3
// convolution's taps), B comes transposed by the caller, [N, K] bf16: both
// are K-major operands of wgmma, read from shared memory through
// descriptors (no fragment loads into registers).
//
// Tiles (Tile<BN, BK>): BN = 128 where N > 64, a BM = 128-row tile, each
// consumer warpgroup 64 rows as m64n128k16 products; BN = 64 where N <= 64
// (only N = Cm = 64 in a ResNet), a BM = 256-row tile, each consumer
// warpgroup 128 rows as two m64n64k16 products. Either way a consumer
// thread holds 64 f32 sums. A stage is BK = 64 deep (one 128-byte row, the
// 128-byte swizzle) where K's blocks allow it, else BK = 32 (64-byte rows,
// the 64-byte swizzle); the caller picks BK so that a stage never crosses a
// 3x3 tap. The ring holds as many stages as fit in PIPE_BYTES (at most
// MAX_STAGES): 5 of 32 KB at (128, 128, 64), 4 of 40 KB at (256, 64, 64),
// 8 at BK = 32. Beside it, two epilogue buffers of a whole output tile
// (32 KB each) in 64-column panels with the 128-byte swizzle: a tile's
// results are rounded into one while the last tile's TMA store drains the
// other, and the skip input of a tile lands there by TMA ahead of its
// epilogue. One block an SM.
//
// Arithmetic: a product of two bf16 values is exact in f32, and the tensor
// core sums the products of one k16 step into an f32 accumulator. Its adds
// into the accumulator round toward zero (csrc/tf32x3_gemm.cuh), so each
// stage (BK deep: four or two k16 steps) sums into a fresh accumulator,
// which is then added to the running f32 sum in registers with an ordinary
// round-to-nearest add, stage after stage in K's order: the bits do not
// depend on the grid. Two such partial accumulators ping-pong: stage c + 1's
// products are issued before stage c's partial is waited for (wgmma
// wait_group 1) and added, so the tensor cores are never drained while the
// consumers add, release a stage or wait for the next one. 64 sums and two
// partials of 64 need ~200 registers: setmaxnreg gives the consumers 232
// and the producer 40.
//
// Pipeline: full[s] completes when stage s has landed (TMA's transaction
// bytes); empty[s] when each consumer warp has seen its products of stage
// s complete. The grid is persistent (one block an SM, walking tiles
// blockIdx.x + i gridDim.x), so the producer streams the next tile's stages
// while the consumers run the epilogue of this one.

#pragma once

#include <cuda.h>  // CUtensorMap: the type only, nothing links the driver library
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace bf16mm {

constexpr int NCW = 2;                  // consumer warpgroups
constexpr int NT = 128 * (NCW + 1);     // threads a block: + one producer warpgroup
constexpr int WIDE_BN = 128;            // tile columns where N > 64
constexpr int WIDE_BM = 128;            // its rows: one m64 product a consumer warpgroup
constexpr int NARROW_BN = 64;           // tile columns where N <= 64
constexpr int NARROW_BM = 256;          // its rows: two m64 products a consumer warpgroup
constexpr int DEEP_BK = 64;             // stage depth where the K blocks allow it
constexpr int SHALLOW_BK = 32;          // otherwise
constexpr int PIPE_BYTES = 163840;      // the ring of stages, at most
constexpr int MAX_STAGES = 8;
constexpr int EPI_BUFFERS = 2;          // output tiles in shared memory
constexpr int PANEL = 64;               // columns of an epilogue panel (128-byte rows)
constexpr int SMEM_SLACK = 1024;        // alignment of the ring to the swizzle
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

template <int BN_, int BK_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int BK = BK_;
  static constexpr int BM = BN == WIDE_BN ? WIDE_BM : NARROW_BM;
  static constexpr int MI = BM / (64 * NCW);          // m64 products a consumer warpgroup
  static constexpr int ROW = 2 * BK;                  // bytes of a tile row: the swizzle span
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      PIPE_BYTES / STAGE_BYTES < MAX_STAGES ? PIPE_BYTES / STAGE_BYTES : MAX_STAGES;
  static constexpr int E_BYTES = BM * BN * 2;         // one epilogue buffer: a bf16 tile
  static constexpr int BARRIERS = 2 * STAGES + 2 * EPI_BUFFERS;
  static constexpr int SMEM_BYTES =
      SMEM_SLACK + STAGES * STAGE_BYTES + EPI_BUFFERS * E_BYTES + 8 * BARRIERS;
  static_assert((BN == WIDE_BN || BN == NARROW_BN) && (BK == DEEP_BK || BK == SHALLOW_BK),
                "a tile the wrapper plans");
  static_assert(MI * 64 * NCW == BM && STAGES >= 3 && BN % PANEL == 0, "tile shape");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle alignment");
  static_assert(SMEM_BYTES <= 232448, "227 KB a block");
};

// The block's shared memory: the ring, the epilogue buffers, the barriers
template <class T>
struct Smem {
  char* base;  // 1,024-aligned
  __device__ __forceinline__ explicit Smem(char* raw)
      : base(reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023))) {}
  __device__ __forceinline__ char* stage(int s) const { return base + s * T::STAGE_BYTES; }
  __device__ __forceinline__ char* epi(int b) const {
    return base + T::STAGES * T::STAGE_BYTES + b * T::E_BYTES;
  }
  __device__ __forceinline__ uint64_t* bar() const {
    return reinterpret_cast<uint64_t*>(epi(EPI_BUFFERS));
  }
  __device__ __forceinline__ uint64_t* full() const { return bar(); }
  __device__ __forceinline__ uint64_t* empty() const { return bar() + T::STAGES; }
  // an epilogue buffer's skip input has landed / its last store has read it
  __device__ __forceinline__ uint64_t* efull() const { return bar() + 2 * T::STAGES; }
  __device__ __forceinline__ uint64_t* eempty() const {
    return bar() + 2 * T::STAGES + EPI_BUFFERS;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and named barriers -----------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// returns once the phase of parity `parity` has completed; a wait of more
// than ~2^34 clocks (seconds) traps, so that a pipeline fault ends the
// launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` of TMA transactions still to land
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// a barrier of consumer warpgroup wg alone (ids 1, 2; __syncthreads is 0)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ---- TMA -----------------------------------------------------------------
// a 2-D box: inner coordinate c0, outer c1, into dst, counted on bar;
// out-of-range elements land as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// im2col mode over an NHWC map: the map's pixels-per-column pixels from (w,
// h, n) on in the map's traversal order (W, then H, then N, within its
// bounding box), each read at (w + dw, h + dh), channels c.. of each;
// outside the tensor, zeros
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map, int c, int w,
                                                int h, int n, uint16_t dw, uint16_t dh,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(smem_u32(bar)),
      "h"(dw), "h"(dh)
      : "memory");
}
// a 2-D box from src to the map at (c0, c1); out-of-range elements are not
// written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes become visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warpgroup MMA ---------------------------------------------------------
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving an accumulator while a product writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// descriptor of a K-major tile in the ROW-byte swizzle: rows of ROW bytes,
// 8-row groups 8 ROW bytes apart, the tile aligned to 8 ROW bytes; + 2 per
// k16 step (32 bytes on in the row)
template <int ROW>
__device__ __forceinline__ uint64_t desc(const void* tile) {
  constexpr uint64_t layout = ROW == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * ROW >> 4) << 32) | (layout << 62);
}

// d (+)= A . B for one m64n64k16 bf16 product of the warpgroup, A and B
// K-major in shared memory (descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B for one m64n128k16 bf16 product of the warpgroup, A and B
// K-major in shared memory (descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
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

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db, scale_d);
  } else {
    wgmma_n64(d, da, db, scale_d);
  }
}

// ---- the roles -------------------------------------------------------------
// Both roles walk the same sequence: the tiles blockIdx.x + i gridDim.x, of
// KT stages each, stage s of the ring and its phase parity advancing by one
// a stage.
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

// tile -> (m0, n0): the column tile varies fastest, so blocks that share A's
// rows run together
template <class T>
__device__ __forceinline__ void tile_origin(int tile, int n_tiles, int& m0, int& n0) {
  m0 = tile / n_tiles * T::BM;
  n0 = tile % n_tiles * T::BN;
}

// Producer (one thread): each tile's KT stages, A by aload (aload.begin(m0)
// at each tile, then aload.load(dst, kc, bar) for stage kc) and B by TMA
// (rows n0.. of mb, BK deep); then, with a skip map mx, the tile's [BM, BN]
// box of it into epilogue buffer j % 2 (j: the block's tile count), once
// the stores of tile j - 2 have read that buffer.
template <class T, class ALoad>
__device__ __forceinline__ void produce(ALoad aload, const CUtensorMap* mb, const CUtensorMap* mx,
                                        const Smem<T>& sm, int tiles, int n_tiles, int KT) {
  Ring r;
  int j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    int m0, n0;
    tile_origin<T>(tile, n_tiles, m0, n0);
    aload.begin(m0);
    for (int kc = 0; kc < KT; ++kc) {
      mbar_wait(&sm.empty()[r.s], r.phase ^ 1);
      char* st = sm.stage(r.s);
      mbar_expect_tx(&sm.full()[r.s], T::STAGE_BYTES);
      aload.load(st, kc, &sm.full()[r.s]);
      tma_load_2d(st + T::A_BYTES, mb, kc * T::BK, n0, &sm.full()[r.s]);
      r.next<T::STAGES>();
    }
    if (mx != nullptr) {
      const int b = j % EPI_BUFFERS;
      mbar_wait(&sm.eempty()[b], ((j / EPI_BUFFERS) & 1) ^ 1);
      mbar_expect_tx(&sm.efull()[b], T::E_BYTES);
#pragma unroll
      for (int p = 0; p < T::BN / PANEL; ++p)
        tma_load_2d(sm.epi(b) + p * T::BM * 128, mx, n0 + p * PANEL, m0, &sm.efull()[b]);
    }
  }
}

// A consumer's products of the stage at r into p (a fresh sum), issued and
// committed as one group; waits for the stage to be full first
template <class T>
__device__ __forceinline__ void issue_stage(float (&p)[T::MI][T::BN / 2], const Smem<T>& sm,
                                            const Ring& r, int wg) {
  mbar_wait(&sm.full()[r.s], r.phase);
  const char* st = sm.stage(r.s);
  const uint64_t db = desc<T::ROW>(st + T::A_BYTES);
#pragma unroll
  for (int i = 0; i < T::MI; ++i) fence_regs(p[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
      wgmma<T::BN>(p[i], desc<T::ROW>(st + (wg * T::MI + i) * 64 * T::ROW) + 2 * kk, db + 2 * kk,
                   kk > 0);
  wgmma_commit();
#pragma unroll
  for (int i = 0; i < T::MI; ++i) fence_regs(p[i]);
}

// once p's group has completed: this warp frees the stage p was read from,
// and acc += p, rounding to nearest
template <class T>
__device__ __forceinline__ void add_stage(float (&acc)[T::MI][T::BN / 2],
                                          float (&p)[T::MI][T::BN / 2], const Smem<T>& sm,
                                          int s) {
  if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty()[s]);
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
    fence_regs(p[i]);
#pragma unroll
    for (int e = 0; e < T::BN / 2; ++e) acc[i][e] += p[i][e];
  }
}

// Consumer: this warpgroup's rows of one tile, all KT stages, into acc (its
// 64 f32 sums in wgmma's accumulator layout; see for_each_pair). Stages
// alternate between the partials p0 and p1; each is added as soon as the
// next stage's products are in flight.
template <class T>
__device__ __forceinline__ void consume_tile(float (&acc)[T::MI][T::BN / 2], const Smem<T>& sm,
                                             Ring& r, int KT) {
  const int wg = threadIdx.x / 128;
  float p0[T::MI][T::BN / 2], p1[T::MI][T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int e = 0; e < T::BN / 2; ++e) acc[i][e] = 0.f;
  issue_stage<T>(p0, sm, r, wg);
  int held = r.s;  // the stage whose partial is pending
  r.next<T::STAGES>();
  for (int kc = 1;; ++kc) {
    if (kc == KT) {
      wgmma_wait<0>();
      add_stage<T>(acc, p0, sm, held);
      return;
    }
    issue_stage<T>(p1, sm, r, wg);
    wgmma_wait<1>();
    add_stage<T>(acc, p0, sm, held);
    held = r.s;
    r.next<T::STAGES>();
    if (++kc == KT) {
      wgmma_wait<0>();
      add_stage<T>(acc, p1, sm, held);
      return;
    }
    issue_stage<T>(p0, sm, r, wg);
    wgmma_wait<1>();
    add_stage<T>(acc, p1, sm, held);
    held = r.s;
    r.next<T::STAGES>();
  }
}

// f(i, e, r, n, off) for each pair of this consumer thread's sums
// acc[i][e], acc[i][e + 1] (e even), which are C[m0 + r, n0 + n] and
// C[m0 + r, n0 + n + 1]; off is the pair's byte offset in an epilogue
// buffer (64-column panels of BM rows, 128-byte rows in the 128-byte
// swizzle: a warp's 4-byte writes of 8 rows land in 8 distinct 16-byte
// chunks, free of bank conflicts)
template <class T, class F>
__device__ __forceinline__ void for_each_pair(F&& f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4, wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * T::MI + i) * 64 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        const int n = 8 * j + 2 * (lane % 4);
        const int off = (n / PANEL) * T::BM * 128 + r * 128 +
                        ((((n % PANEL) / 8) ^ (r & 7)) << 4) + (n % 8) * 2;
        f(i, 4 * j + 2 * h, r, n, off);
      }
    }
}

// The epilogue's hand-off of warpgroup wg's rows of a tile in epilogue
// buffer e to the output map mo at (m0, n0): every thread's writes to e are
// fenced to the async proxy, the warpgroup meets, and its first thread
// stores each panel's [BM / NCW, 64] box
template <class T>
__device__ __forceinline__ void store_tile(const CUtensorMap* mo, const char* e, int m0, int n0) {
  const int wg = threadIdx.x / 128;
  fence_async_shared();
  warpgroup_sync(wg);
  if (threadIdx.x % 128 == 0) {
    constexpr int ROWS = T::BM / NCW;
#pragma unroll
    for (int p = 0; p < T::BN / PANEL; ++p)
      tma_store_2d(mo, n0 + p * PANEL, m0 + wg * ROWS, e + p * T::BM * 128 + wg * ROWS * 128);
    bulk_commit();
  }
}

}  // namespace bf16mm
