// PQ asymmetric-distance (ADC) scores with fused per-64-column block maxima,
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pallas/adc_mxu.py::adc_scores_mxu
// (with prepare_lut_tables). The TPU kernel recast the lookup as a one-hot
// bf16x2 matmul because the TPU has no fast per-lane gather; Hopper's shared
// memory gathers natively, so this kernel computes the exact f32 gather of the
// JAX package's retrieval/pq.py::_adc_block:
//
//   scores[q, r] = sum_{m = 0..M-1} lut[q, m, codes[r, m]]   r < n_valid
//   scores[q, r] = NEG_INF                                    n_valid <= r < n_pad
//   bmax[q, j]   = max_{64 j <= r < 64 (j + 1)} scores[q, r]
//
// with n_pad = 64 * ceil(n / 64), the output contract of score_topk.cu, so the
// same exact block-max selection runs on it. Scores are queries-major: the
// TPU's [n, nq_pad] layout was a Mosaic constraint and is not kept.
//
// Bound on this card: shared-memory lookups. At the search shape (256
// queries, 100,000 rows, M = 64) there are 1.64e9 lookups, 0.20 ms at 132 SMs
// x 32 lookups a clock x 1.98 GHz, against ~0.13 GB of codes, LUT and scores
// through HBM (0.04 ms).
//
// Design (simple and exact first): a block owns one query and a run of row
// tiles. It stages that query's LUT in shared memory, 64 subquantizers
// (64 KB) at a time; with M <= 64 the LUT is staged once and stays, with
// M > 64 (M = 256 for 32,768-d NetVLAD descriptors, a 256 KB LUT) each tile
// walks the slices in order and every row keeps its partial sum in a register
// between slices. A tile is 1,024 rows: each warp owns 128 consecutive rows,
// four per lane, so a 64-column block maximum is one warp reduction of two
// values a lane. A lane reads its row's codes 16 bytes at a time (rows of
// other queries' blocks are read again from L2, 6.4 MB at N = 100k, M = 64).
// Every score is one sequential f32 sum over m = 0..M-1 started from 0, so
// rows with equal codes tie bit for bit and the plain PyTorch version, which
// adds the subquantizers in the same order, gives the same bits. The lookups'
// bank conflicts (random codes) are accepted. Blocks of one row run vary by
// query fastest, so they read the same codes together through L2.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define NT 256             // threads per block
#define V 256              // codebook entries (uint8 codes)
#define MS 64              // subquantizers staged per LUT slice: 64 KB
#define ROWS_PER_WARP 128  // two 64-column blocks
#define TILE (NT / 32 * ROWS_PER_WARP)  // rows per tile (1,024)
#define BLOCK 64           // columns per block maximum
#define FULL 0xffffffffu

__device__ __forceinline__ void stage_slice(float* lut_s, const float* lq, int m0, int ms) {
  const float4* src = reinterpret_cast<const float4*>(lq + (size_t)m0 * V);
  float4* dst = reinterpret_cast<float4*>(lut_s);
  for (int e = threadIdx.x; e < ms * V / 4; e += NT) dst[e] = src[e];
}

// Adds the lookups of subquantizers m0 .. m0 + ms - 1 of one row to ``a``, in order.
__device__ __forceinline__ float lookup_slice(const float* lut_s, const uint8_t* c, int ms,
                                              bool vec16, float a) {
  if (vec16) {
    for (int j = 0; j < ms; j += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(c + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        a = a + lut_s[(j + b) * V + ((w[b >> 2] >> (8 * (b & 3))) & 0xff)];
      }
    }
  } else {
    for (int j = 0; j < ms; ++j) a = a + lut_s[j * V + c[j]];
  }
  return a;
}

__global__ void __launch_bounds__(NT)
adc_scores_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                  float* __restrict__ scores, float* __restrict__ bmax, int n_valid, int M,
                  int n_pad, int tiles_per_block) {
  extern __shared__ __align__(16) float lut_s[];  // [min(M, MS)][V]
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* lq = lut + (size_t)q * M * V;
  const int nb = n_pad / BLOCK;
  const int n_slices = (M + MS - 1) / MS;
  const int n_tiles = (n_pad + TILE - 1) / TILE;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  const bool vec16 = (M & 15) == 0;

  if (n_slices == 1) {
    stage_slice(lut_s, lq, 0, M);
    __syncthreads();
  }
  for (int t = t0; t < t1; ++t) {
    const int base = t * TILE + warp * ROWS_PER_WARP;  // first row of this warp
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < n_slices; ++s) {
      const int m0 = s * MS;
      const int ms = min(MS, M - m0);
      if (n_slices > 1) {
        __syncthreads();  // every lane is done with the previous slice
        stage_slice(lut_s, lq, m0, ms);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = base + 32 * r + lane;
        if (row < n_valid) {
          acc[r] = lookup_slice(lut_s, codes + (size_t)row * M + m0, ms, vec16, acc[r]);
        }
      }
    }
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = base + 32 * r + lane < n_valid ? acc[r] : -FLT_MAX;
    float ma = fmaxf(v[0], v[1]);  // rows base .. base + 63
    float mb = fmaxf(v[2], v[3]);  // rows base + 64 .. base + 127
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
    }
    float* srow = scores + (size_t)q * n_pad;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = base + 32 * r + lane;
      if (row < n_pad) srow[row] = v[r];
    }
    if (lane == 0) {
      const int j = base / BLOCK;
      if (j < nb) bmax[(size_t)q * nb + j] = ma;
      if (j + 1 < nb) bmax[(size_t)q * nb + j + 1] = mb;
    }
  }
}

extern "C" {

// lut: [nq, M, 256] f32; codes: [n, M] uint8 (row-major, 16-byte aligned);
// scores: [nq, n_pad] f32 and bmax: [nq, n_pad / 64] f32 with
// n_pad = 64 * ceil(n / 64). Rows >= n_valid (n_valid <= n) score NEG_INF.
int adc_scores_forward(const void* lut, const void* codes, void* scores, void* bmax, int nq,
                       int n, int n_valid, int M, int n_pad, void* stream) {
  if (nq < 1 || n < 1 || M < 1 || n_valid < 0 || n_valid > n ||
      n_pad != BLOCK * ((n + BLOCK - 1) / BLOCK)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (M < MS ? M : MS) * V * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(adc_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // about four waves of three 64 KB blocks an SM; one LUT staging serves a
  // whole run of tiles
  const int n_tiles = (n_pad + TILE - 1) / TILE;
  const int target = 4 * 3 * 132;
  int splits = (target + nq - 1) / nq;
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int tiles_per_block = (n_tiles + splits - 1) / splits;
  dim3 grid(nq, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  adc_scores_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)lut, (const uint8_t*)codes, (float*)scores, (float*)bmax, n_valid, M, n_pad,
      tiles_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
