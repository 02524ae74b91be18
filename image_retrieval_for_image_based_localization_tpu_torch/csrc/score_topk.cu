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
// Design (simple and exact first): a block of 256 threads computes a tile
// of 64 queries x 128 gallery rows. Query and gallery slices of 32 dims are
// staged through shared memory, transposed; each thread keeps a register
// tile of 4 queries x 8 gallery rows (two runs of 4 columns, one in each
// 64-column block of the tile). Every score is one sequential fmaf chain
// over d = 0..D-1 started from 0, so the score of a gallery row does not
// depend on where the row sits (duplicate rows tie bit for bit, and the
// scores equal csrc/fused_topk.cu's). The epilogue runs on the registers:
// columns past Ng become NEG_INF first, then the 16 lanes that share a
// query row reduce their 64-column block to its maximum with shuffles, and
// the tile and its maxima are written. Query tiles vary fastest across the
// grid, so the blocks that read one gallery tile run together and share it
// through L2.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#define BM 64       // queries per block
#define BN 128      // gallery rows per block
#define KD 32       // dims staged per step
#define NT 256      // threads per block
#define BLOCK 64    // columns per block maximum
#define FULL 0xffffffffu

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
scores_blockmax_kernel(const float* __restrict__ Q, const T* __restrict__ G,
                       float* __restrict__ scores, float* __restrict__ bmax, int Nq, int Ng,
                       int D, int ng_pad) {
  __shared__ __align__(16) float qs[KD][BM + 4];
  __shared__ __align__(16) float gs[KD][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3 of the tile
  const int ty = tid / 16;  // query rows ty*4 .. +3 of the tile
  const int q0 = blockIdx.x * BM;
  const int g0 = blockIdx.y * BN;

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int d0 = 0; d0 < D; d0 += KD) {
    for (int e = tid; e < BM * KD; e += NT) {
      const int r = e / KD, dd = e % KD;
      const int q = q0 + r, d = d0 + dd;
      qs[dd][r] = (q < Nq && d < D) ? Q[(size_t)q * D + d] : 0.f;
    }
    for (int e = tid; e < BN * KD; e += NT) {
      const int r = e / KD, dd = e % KD;
      const int g = g0 + r, d = d0 + dd;
      gs[dd][r] = (g < Ng && d < D) ? to_f32(G[(size_t)g * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < KD; ++dd) {
      const float4 q4 = *reinterpret_cast<const float4*>(&qs[dd][ty * 4]);
      const float4 lo = *reinterpret_cast<const float4*>(&gs[dd][tx * 4]);
      const float4 hi = *reinterpret_cast<const float4*>(&gs[dd][BLOCK + tx * 4]);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      const float gv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(qv[a], gv[b], acc[a][b]);
    }
    __syncthreads();
  }

  const int nb = ng_pad / BLOCK;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = q0 + ty * 4 + a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gb = g0 + BLOCK * h + tx * 4;  // first column of this run
      float v[4];
      float m = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = gb + j < Ng ? acc[a][4 * h + j] : -FLT_MAX;  // pad columns never win
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

template <typename T>
static int launch(const void* q, const void* g, void* scores, void* bmax, int Nq, int Ng,
                  int D, int ng_pad, void* stream) {
  dim3 grid((Nq + BM - 1) / BM, (ng_pad + BN - 1) / BN);
  scores_blockmax_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)g, (float*)scores, (float*)bmax, Nq, Ng, D, ng_pad);
  return (int)cudaGetLastError();
}

extern "C" {

// queries: [Nq, D] f32; gallery: [Ng, D] f32 (is_bf16 == 0) or bf16;
// scores: [Nq, ng_pad] f32 and bmax: [Nq, ng_pad / 64] f32, with
// ng_pad = 64 * ceil(Ng / 64).
int scores_blockmax_forward(const void* queries, const void* gallery, void* scores,
                            void* bmax, int Nq, int Ng, int D, int ng_pad, int is_bf16,
                            void* stream) {
  if (Nq < 1 || Ng < 1 || ng_pad != BLOCK * ((Ng + BLOCK - 1) / BLOCK)) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(queries, gallery, scores, bmax, Nq, Ng, D, ng_pad, stream);
  }
  return launch<float>(queries, gallery, scores, bmax, Nq, Ng, D, ng_pad, stream);
}

}  // extern "C"
