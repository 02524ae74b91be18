// The f32 GEMM mainloop shared by csrc/score_topk.cu and csrc/fused_topk.cu
// (device code only), for Hopper (sm_90a).
//
//   acc[q, g] = sum_d Q[q, d] * G[g, d]   for one 128 x 128 output tile
//
// Q is [Nq, D] f32 and G is [Ng, D] f32 or bf16, both K-contiguous.
//
// Invariant, kept bit for bit: every accumulator starts at 0.f and takes
// fmaf(q[d], g[d], acc) for d = 0, 1, ..., D - 1 in order (then fmaf(0, 0,
// acc) for the zero pad up to a whole K step, which changes no value). No
// split-K, no tensor cores, no reassociation. So a gallery row scores the
// same wherever it sits (duplicate rows tie bit for bit), and the two
// kernels that include this file give the same bits for the same inputs.
//
// Bound: operations. At the search shape (256 x 100,000 x 2048) the product
// is 1.05e11 flop, 1.57 ms at 67 TFLOP/s f32 on the CUDA cores; the gallery
// is 0.82 GB (0.24 ms at 3.35 TB/s), read about once because the blocks that
// share a gallery tile run together.
//
// Shape and why:
// - 256 threads as 16 x 16; each keeps an 8 x 8 register tile of the
//   128 x 128 output, as four 4 x 4 quadrants: rows ty*4 + {0..3} and
//   64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}. A K
//   step reads four float4 (64 bytes) from shared memory for 64 FMAs, so
//   the FMA units and not shared memory set the pace (the kernels this
//   replaces read 8 scalars for 16 FMAs, or staged element by element). The
//   16 tx lanes of a half-warp read 256 contiguous bytes of the gallery tile
//   (conflict-free); the two ty rows of a warp broadcast. Columns 0-63 and
//   64-127 of the tile are the two 64-column blocks of scores_blockmax: each
//   thread holds 4 columns of each, and the 16 lanes that share ty cover a
//   whole block. Row r of the tile lives in one half-warp, which
//   fused_topk's selection uses.
// - K steps of BK = 8 dims. Each thread moves one 16-byte query vector a
//   step and, for an f32 gallery, one 16-byte gallery vector; a bf16 step is
//   128 vectors of 8 values, moved by threads 0-127 and widened exactly on
//   the way into shared memory (Stager). Shared memory holds both operands transposed
//   (k-major, rows padded to 132 floats, stores conflict-free), so the FMA
//   loop reads float4 along the tile. (BK = 16 needs 8 more staging
//   registers and spilled at 128 registers a thread.)
// - Double-buffered: the global loads of step s + 1 go to registers before
//   step s's FMAs and to the other shared stage after them, with one barrier
//   a step. Across tiles the same holds: the loads of the next tile's first
//   step are in flight while the caller runs its epilogue. The load is one
//   branch-free call whatever the step: a branch between the next step's
//   and the next tile's loads made the tile-walking kernel slower. Each
//   vector load has L2 fetch its whole 256-byte block (ldg_16), so a row's
//   next steps wait on L2, not on device memory.
// - The threads that run the loop may be a part of the block: its barrier
//   is __syncthreads() or a named barrier of NT threads (sync_mainloop).
// - Ragged Nq, Ng and D are zero-filled at load. When D is not a multiple of
//   the vector width, or Q or G is not 16-byte aligned (a row slice of a
//   gallery, an odd D), the caller instantiates the scalar-load variant
//   (VEC = false): the same tiles and FMA order, filled element by element,
//   its loads issued after each step's FMAs to stay within the registers.
// Registers and shared memory are stated in each kernel's header (nvcc
// -Xptxas -v, which the build runs and logs next to each library).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int BM = 128;       // queries per tile
constexpr int BN = 128;       // gallery rows per tile
constexpr int NT = 256;       // threads per block
constexpr int BK = 8;         // dims a K step
constexpr int LD = BM + 4;    // shared row pitch in floats (16-byte aligned)

struct Smem {
  float a[2][BK][LD];  // queries, [stage][k][row]
  float b[2][BK][LD];  // gallery, [stage][k][row]
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// A 16-byte read-only load that has L2 fetch the whole 256-byte block
// around it: a thread reads 16 bytes of a row a step and the row's next
// steps follow, so they find it in L2 instead of waiting on device memory.
// Callers issue it only under their bounds test.
__device__ __forceinline__ uint4 ldg_16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// One K step's global loads, held in registers between load() and store():
// one 16-byte vector of queries a thread (row t / 2, dims (t % 2) * 4 .. + 4)
// and 4 gallery values of the same row and dims, which for an f32 gallery
// are one 16-byte vector. A bf16 gallery moves 16-byte vectors of 8 values:
// a step's 128 rows x 8 dims are 128 vectors, moved by threads t < 128 (row
// t, dims 0 .. 7) and widened exactly on the way into shared memory. The
// scalar-load variant moves 4 gallery values a thread in either dtype.
template <typename T, bool VEC>
struct Stager {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr bool WIDE = BF16 && VEC;  // 8 gallery values a thread, threads < 128
  float4 ra;
  uint4 rb;  // 4 f32, or 8 (WIDE) or 4 bf16 two to a word

  __device__ __forceinline__ void load(const float* __restrict__ Q, const T* __restrict__ G,
                                       int q0, int g0, int k0, int Nq, int Ng, int D, int tid) {
    const int q = q0 + (tid >> 1), qk = k0 + (tid & 1) * 4;
    const int g = g0 + (WIDE ? (tid & (BN - 1)) : (tid >> 1));
    const int gk = WIDE ? k0 : qk;
    const bool gin = (!WIDE || tid < BN) && g < Ng;
    const float* qp = Q + (size_t)q * D + qk;
    const T* gp = G + (size_t)g * D + gk;
    if (VEC) {
      if (q < Nq && qk < D) {
        const uint4 a = ldg_16(qp);
        ra = make_float4(__uint_as_float(a.x), __uint_as_float(a.y), __uint_as_float(a.z),
                         __uint_as_float(a.w));
      } else {
        ra = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      rb = (gin && gk < D) ? ldg_16(gp) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const int nq = q < Nq ? D - qk : 0;  // dims left in this query row from qk
      const int ng = gin ? D - gk : 0;     // and in this gallery row from gk
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < nq ? __ldg(qp + j) : 0.f;
      ra = make_float4(v[0], v[1], v[2], v[3]);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!BF16) {
          w[j] = j < ng ? bits(gp[j]) : 0u;
        } else if (j < 2) {  // two bf16 a word, the lower dim in the low half
          const uint32_t lo = 2 * j < ng ? bits(gp[2 * j]) : 0u;
          const uint32_t hi = 2 * j + 1 < ng ? bits(gp[2 * j + 1]) : 0u;
          w[j] = lo | (hi << 16);
        }
      }
      rb = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  __device__ __forceinline__ void store(Smem& sm, int stage, int tid) const {
    const int row = tid >> 1, kc = (tid & 1) * 4;
    sm.a[stage][kc + 0][row] = ra.x;
    sm.a[stage][kc + 1][row] = ra.y;
    sm.a[stage][kc + 2][row] = ra.z;
    sm.a[stage][kc + 3][row] = ra.w;
    const uint32_t w[4] = {rb.x, rb.y, rb.z, rb.w};
    if (!BF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.b[stage][kc + j][row] = __uint_as_float(w[j]);
    } else if (!WIDE) {  // widened exactly: a bf16 is the high half of its f32
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sm.b[stage][kc + 2 * j][row] = bf16_lo(w[j]);
        sm.b[stage][kc + 2 * j + 1][row] = bf16_hi(w[j]);
      }
    } else if (tid < BN) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sm.b[stage][2 * j][tid] = bf16_lo(w[j]);
        sm.b[stage][2 * j + 1][tid] = bf16_hi(w[j]);
      }
    }
  }
};

// The barrier of the NT threads that run the mainloop: __syncthreads() when
// they are the whole block (bar == 0), else named barrier `bar` of NT
// threads, which leaves the block's other warps free to run on.
__device__ __forceinline__ void sync_mainloop(int bar) {
  if (bar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(NT) : "memory");
  }
}

// The FMAs of one K step on shared stage `stage`.
__device__ __forceinline__ void fma_step(float (&acc)[8][8], const Smem& sm, int stage,
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[stage][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[stage][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[stage][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[stage][kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Tile-local row (query) of register row i and column (gallery row) of
// register column j.
__device__ __forceinline__ int tile_row(int i, int ty) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }
__device__ __forceinline__ int tile_col(int j, int tx) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

// The K loop of the tile (q0, g0). On entry step 0 of this tile is in shared
// stage `stage` (the caller staged it and synchronised). On return `acc`
// holds the tile's scores; if next_g0 >= 0 the stager holds step 0 of the
// tile (q0, next_g0), loaded but not yet stored: the caller runs its
// epilogue under those loads, then calls stage_next().
template <typename T, bool VEC>
__device__ __forceinline__ void gemm_tile(int bar, float (&acc)[8][8], Stager<T, VEC>& st, Smem& sm,
                                          int& stage, const float* __restrict__ Q,
                                          const T* __restrict__ G, int q0, int g0, int next_g0,
                                          int Nq, int Ng, int D, int tid, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (D + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (VEC) {
      // the next step's loads, in flight under this step's FMAs; one load
      // with no branch: the last step loads the next tile's first step, or
      // with no next tile this tile's first step again, unused
      st.load(Q, G, q0, more || next_g0 < 0 ? g0 : next_g0, more ? (kt + 1) * BK : 0, Nq, Ng,
              D, tid);
      fma_step(acc, sm, stage, ty, tx);
    } else {
      // after the FMAs: the element-wise masks would not fit in registers
      // beside the accumulators
      fma_step(acc, sm, stage, ty, tx);
      if (more) {
        st.load(Q, G, q0, g0, (kt + 1) * BK, Nq, Ng, D, tid);
      } else if (next_g0 >= 0) {
        st.load(Q, G, q0, next_g0, 0, Nq, Ng, D, tid);
      }
    }
    if (more) st.store(sm, stage ^ 1, tid);
    sync_mainloop(bar);
    if (more) stage ^= 1;
  }
}

// Store the next tile's first step (loaded by gemm_tile) and make it current.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_next(int bar, Stager<T, VEC>& st, Smem& sm,
                                           int& stage, int tid) {
  stage ^= 1;
  st.store(sm, stage, tid);
  sync_mainloop(bar);
}

// Whether the 16-byte load variant applies: D a multiple of the gallery's
// vector width and both operands 16-byte aligned.
template <typename T>
inline bool vec_ok(const void* q, const void* g, int D) {
  const int width = 16 / (int)sizeof(T);
  return D % width == 0 && ((uintptr_t)q & 15) == 0 && ((uintptr_t)g & 15) == 0;
}

}  // namespace sgemm
