// Score matrix with fused per-64-column block maxima, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// ops/pallas/score_topk.py::scores_blockmax (_kernel, plus the block-max
// epilogue that Mosaic could not lower there, so XLA ran it on the kernel's
// output).
//
//   scores[q, g] = sum_d Q[q, d] * G[g, d]   (f32 FMA, no TF32), g < Ng
//   scores[q, g] = NEG_INF                    Ng <= g < Ng_pad (Ng_pad = 64 * nb)
//   bmax[q, j]   = max_{64 j <= g < 64 (j + 1)} scores[q, g]
//
// Bound on this card: operations. At the search shape (256 queries, 100k x
// 2048 gallery) the product is 1.05e11 flop (1.57 ms at 67 TFLOP/s f32)
// against 0.82 GB of gallery and 0.10 GB of scores (0.28 ms). The scores are
// f32 FMA chains, which run on the CUDA cores.
//
// Design: one block of 256 threads computes a 128 x 128 tile of scores on
// the mainloop of csrc/sgemm_tile.cuh (8 x 8 registers a thread, 16-byte
// global loads, double-buffered shared stages, one barrier a K step; each
// score one sequential fmaf chain over d, so scores equal
// csrc/fused_topk.cu's bit for bit). What held the previous kernel back,
// and what this one does about it: its global loads were scalar and staged
// into one buffer between two barriers, so no load overlapped an FMA; here
// the next step's loads are in flight during the FMAs. Its 64 x 128 tile
// read each gallery tile twice per 256 queries from L2; the 128 x 128 tile
// halves that. The epilogue runs on the registers: columns past Ng become
// NEG_INF first; a thread's 8 columns are 4 in each of the tile's two
// 64-column blocks, so the 16 lanes that share a query row reduce one block
// to its maximum with shuffles and no block spans two lane groups; float4
// stores. Query tiles vary fastest across the grid, so the blocks that read
// one gallery tile run together and share it through L2.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, kept in the build
// log): 122-127 registers, no spills, under __launch_bounds__(256, 2);
// 16,896 bytes of static shared memory; two blocks an SM.
//
// The small-batch form (scores_blockmax_narrow), for query tiles of 8, 16,
// 24 or 32 rows (the wrapper's plan, ops/kernels/fused_topk.py::_plan): the
// 128-row tile left 108 of its 128 rows zero fill at config 5's 20 queries
// and still ran their FMAs. Its mainloop is csrc/narrow_tile.cuh (1,024
// gallery rows a tile, streamed by TMA through a ring of four stages, every
// score the same fmaf chain as above, so both forms give the same bits);
// each block walks a split of whole tiles. The epilogue keeps the contract:
// a warp holds 128 consecutive rows as four runs of 32 lanes, so each
// 64-column block is two runs of one warp, reduced to its maximum with
// shuffles; pad columns become NEG_INF first; stores are 128 contiguous
// bytes a warp.
//
// Each entry returns cudaGetLastError() after its launch.

#include <float.h>

#include "narrow_tile.cuh"
#include "sgemm_tile.cuh"

#define BLOCK 64    // columns per block maximum
#define FULL 0xffffffffu

using sgemm::BM;
using sgemm::BN;
using sgemm::NT;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
scores_blockmax_kernel(const float* __restrict__ Q, const T* __restrict__ G,
                       float* __restrict__ scores, float* __restrict__ bmax, int Nq, int Ng,
                       int D, int ng_pad) {
  __shared__ __align__(16) sgemm::Smem sm;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BM;
  const int g0 = blockIdx.y * BN;

  sgemm::Stager<T, VEC> st;
  int stage = 0;
  st.load(Q, G, q0, g0, 0, Nq, Ng, D, tid);
  st.store(sm, stage, tid);
  __syncthreads();
  float acc[8][8];
  sgemm::gemm_tile<T, VEC>(0, acc, st, sm, stage, Q, G, q0, g0, -1, Nq, Ng, D, tid, ty, tx);

  const int nb = ng_pad / BLOCK;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + sgemm::tile_row(i, ty);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gb = g0 + BLOCK * h + tx * 4;  // first column of this run
      float v[4];
      float m = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = gb + j < Ng ? acc[i][4 * h + j] : -FLT_MAX;  // pad columns never win
        m = fmaxf(m, v[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      if (q < Nq && gb < ng_pad) {
        *reinterpret_cast<float4*>(scores + (size_t)q * ng_pad + gb) =
            make_float4(v[0], v[1], v[2], v[3]);
        if (tx == 0) bmax[(size_t)q * nb + (g0 / BLOCK) + h] = m;
      }
    }
  }
}

template <typename T, int NQ>
__global__ void __launch_bounds__(narrow::THREADS, 1)
scores_blockmax_narrow(const __grid_constant__ CUtensorMap mg,
                       const __grid_constant__ CUtensorMap mq, const float* __restrict__ Q,
                       const T* __restrict__ G, float* __restrict__ scores,
                       float* __restrict__ bmax, int Nq, int Ng, int D, int ng_pad, int tma) {
  extern __shared__ unsigned char dyn[];
  const narrow::Ring ring(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * NQ;
  int r0, r1;
  narrow::split_rows(blockIdx.y, gridDim.y, Ng, r0, r1);
  const int cols = min(ng_pad, r1);  // the columns this split writes
  if (threadIdx.x == 0) ring.init(tma ? 1 : narrow::PRODUCERS);
  __syncthreads();
  if (warp >= narrow::WARPS) {
    narrow::regs_dealloc<narrow::PRODUCER_REGS>();
    narrow::produce<T, NQ>(tma, ring, &mg, &mq, Q, G, q0, r0, r1, Nq, Ng, D,
                           threadIdx.x - narrow::WARPS * 32);
    return;
  }
  narrow::regs_alloc<narrow::CONSUMER_REGS>();
  const int nb = ng_pad / BLOCK;
  narrow::consume<T, NQ>(ring, r0, r1, D, warp, lane, [&](int g0, float(&acc)[narrow::ROWS][NQ]) {
    const int gw = g0 + narrow::tile_row(0, warp, 0);  // the warp's first row
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q0 + q >= Nq) break;
      float* srow = scores + (size_t)(q0 + q) * ng_pad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // 64-column block h of the warp's 128 rows
        float m = -FLT_MAX;
#pragma unroll
        for (int j = 2 * h; j < 2 * h + 2; ++j) {
          const int g = gw + j * 32 + lane;
          const float v = g < Ng ? acc[j][q] : -FLT_MAX;  // pad columns never win
          m = fmaxf(m, v);
          if (g < cols) srow[g] = v;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        const int b0 = gw + h * BLOCK;
        if (lane == 0 && b0 < cols) bmax[(size_t)(q0 + q) * nb + b0 / BLOCK] = m;
      }
    }
  });
}

template <typename T, int NQ>
static int launch_narrow(const void* q, const void* g, void* scores, void* bmax, int Nq, int Ng,
                         int D, int ng_pad, int n_splits, cudaStream_t s) {
  const bool tma = narrow_host::tma_ok<T>(q, g, D);
  CUtensorMap mg, mq;
  if (!narrow_host::make_maps<T>(&mg, &mq, tma, q, g, Nq, Ng, D, NQ))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      narrow_host::allow_smem(scores_blockmax_narrow<T, NQ>, narrow::RING_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + NQ - 1) / NQ, n_splits);
  scores_blockmax_narrow<T, NQ><<<grid, narrow::THREADS, narrow::RING_BYTES, s>>>(
      mg, mq, (const float*)q, (const T*)g, (float*)scores, (float*)bmax, Nq, Ng, D, ng_pad,
      (int)tma);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* g, void* scores, void* bmax, int Nq, int Ng,
                  int D, int ng_pad, int width, int n_splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 8: return launch_narrow<T, 8>(q, g, scores, bmax, Nq, Ng, D, ng_pad, n_splits, st);
    case 16: return launch_narrow<T, 16>(q, g, scores, bmax, Nq, Ng, D, ng_pad, n_splits, st);
    case 24: return launch_narrow<T, 24>(q, g, scores, bmax, Nq, Ng, D, ng_pad, n_splits, st);
    case 32: return launch_narrow<T, 32>(q, g, scores, bmax, Nq, Ng, D, ng_pad, n_splits, st);
    default: break;
  }
  dim3 grid((Nq + BM - 1) / BM, (ng_pad + BN - 1) / BN);
  if (sgemm::vec_ok<T>(q, g, D)) {
    scores_blockmax_kernel<T, true><<<grid, NT, 0, st>>>(
        (const float*)q, (const T*)g, (float*)scores, (float*)bmax, Nq, Ng, D, ng_pad);
  } else {
    scores_blockmax_kernel<T, false><<<grid, NT, 0, st>>>(
        (const float*)q, (const T*)g, (float*)scores, (float*)bmax, Nq, Ng, D, ng_pad);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// queries: [Nq, D] f32; gallery: [Ng, D] f32 (is_bf16 == 0) or bf16;
// scores: [Nq, ng_pad] f32 and bmax: [Nq, ng_pad / 64] f32, with
// ng_pad = 64 * ceil(Ng / 64). width: the query tile, 128 (the 128 x 128
// form; n_splits unused) or 8, 16, 24, 32 (the small-batch form over
// n_splits splits of the gallery's 256-row runs, 1 <= n_splits <= their
// count).
int scores_blockmax_forward(const void* queries, const void* gallery, void* scores,
                            void* bmax, int Nq, int Ng, int D, int ng_pad, int is_bf16,
                            int width, int n_splits, void* stream) {
  const int units = (Ng + narrow::BOX_ROWS - 1) / narrow::BOX_ROWS;
  const bool narrow_ok = width % 8 == 0 && width >= 8 && width <= narrow::MAX_NQ &&
                         n_splits >= 1 && n_splits <= units;
  if (Nq < 1 || Ng < 1 || D < 1 || ng_pad != BLOCK * ((Ng + BLOCK - 1) / BLOCK) ||
      !(width == BM || narrow_ok)) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(queries, gallery, scores, bmax, Nq, Ng, D, ng_pad, width,
                                 n_splits, stream);
  }
  return launch<float>(queries, gallery, scores, bmax, Nq, Ng, D, ng_pad, width, n_splits,
                       stream);
}

}  // extern "C"
