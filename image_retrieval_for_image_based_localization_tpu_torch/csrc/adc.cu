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
// x 32 four-byte lookups a clock x 1.98 GHz, against ~0.13 GB of codes, LUT
// and scores through HBM (0.04 ms). Random codes land on random banks, so a
// gather of one f32 per lane costs ~3.5 shared-memory wavefronts for its 32
// lookups where the bound counts one.
//
// Design: a block owns QB = 4 queries and one tile of 2,048 rows. It stages
// the four queries' LUTs into shared memory interleaved, so entry (m, code)
// is one float4, in slices of 64 KB (16 subquantizers; three blocks an SM).
// A lane reads its row's codes 16 bytes at a time and makes four lookups
// with each float4 load: a quarter-warp's eight loads fall on eight random
// 16-byte bank groups, ~2.6 wavefronts for 32 lookups, with about a third of
// the instructions a lookup and the codes read from L2 once per four queries.
// (Two queries a block, float2 entries and 32-subquantizer slices, measured
// 0.76 ms against 0.65 at the search shape; eight rows a lane with two
// blocks an SM, or four rows a lane, were slower too.)
// Each lane owns eight rows (eight independent sums per query in flight);
// each warp owns 256 consecutive rows, so a 64-column block maximum is one
// warp reduction of two values a lane. Every query's sum of a row stays in
// its own register across slices and adds the subquantizers in order
// m = 0..M-1 from 0, so rows with equal codes tie bit for bit and the plain
// PyTorch version, which adds them in the same order, gives the same bits.
// Queries past nq (nq not a multiple of QB) are staged as zeros and never
// written. Blocks vary by query group fastest, so blocks that read the same
// codes run together. Past grid.y's 65,535 row tiles (134M rows) the entry
// launches once more for each further 65,535 (a loop over tiles inside the
// kernel measured 2 % slower on an H100 at M = 64: it spilled 100 bytes
// more).
//
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define QB 4                         // queries a block: one float4 LUT entry
#define NT 256                       // threads per block
#define MIN_BLOCKS 3                 // blocks an SM: 3 x 64 KB of shared memory
#define V 256                        // codebook entries (uint8 codes)
#define SLICE_BYTES 65536            // LUT slice staged in shared memory
#define MS (SLICE_BYTES / (V * QB * 4))  // subquantizers a slice (16)
#define RPL 8                        // rows per lane
#define ROWS_PER_WARP (32 * RPL)     // 256: four 64-column blocks
#define TILE (NT / 32 * ROWS_PER_WARP)  // rows per block (2,048)
#define BLOCK 64                     // columns per block maximum
#define MAX_GRID_Y 65535             // row tiles a launch (grid.y's limit)
#define FULL 0xffffffffu

static_assert(MS % 16 == 0 && MS * V * QB * 4 == SLICE_BYTES,
              "a slice holds whole 16-code groups of QB-wide entries");
static_assert(MIN_BLOCKS * (SLICE_BYTES + 1024) <= 228 * 1024,
              "MIN_BLOCKS slices fit an SM (1 KB of it reserved a block)");
static_assert(ROWS_PER_WARP % BLOCK == 0, "a warp's rows are whole 64-column blocks");

// a[i] += lut_s[slot][i] for the four queries, one 16-byte load
__device__ __forceinline__ void add_entry(float (&a)[QB], const float* lut_s, int slot) {
  const float4 t = reinterpret_cast<const float4*>(lut_s)[slot];
  a[0] = a[0] + t.x;
  a[1] = a[1] + t.y;
  a[2] = a[2] + t.z;
  a[3] = a[3] + t.w;
}

// byte b (0..15) of a row's 16 codes
__device__ __forceinline__ int code_byte(const uint4& c, int b) {
  const uint32_t w = (b >> 2) == 0 ? c.x : (b >> 2) == 1 ? c.y : (b >> 2) == 2 ? c.z : c.w;
  return (w >> (8 * (b & 3))) & 0xff;
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
adc_scores_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                  float* __restrict__ scores, float* __restrict__ bmax, int nq, int n_valid,
                  int M, int n_pad, int tile0) {
  extern __shared__ __align__(16) float lut_s[];  // [min(M, MS)][V][QB]
  const int q0 = blockIdx.x * QB;
  const int lane = threadIdx.x & 31;
  const int base = (tile0 + blockIdx.y) * TILE + (threadIdx.x >> 5) * ROWS_PER_WARP;
  const bool vec16 = (M & 15) == 0;

  float acc[RPL][QB];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[r][i] = 0.f;
  }
  for (int m0 = 0; m0 < M; m0 += MS) {
    const int ms = min(MS, M - m0);
    if (m0 > 0) __syncthreads();  // every lane is done with the previous slice
    // interleave: slot e = m * V + code holds the QB queries' entries
    for (int e = threadIdx.x; e < ms * V; e += NT) {
      float v[QB];
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        v[i] = q0 + i < nq ? lut[((size_t)(q0 + i) * M + m0) * V + e] : 0.f;
      }
      reinterpret_cast<float4*>(lut_s)[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (vec16) {
      for (int j = 0; j < ms; j += 16) {
        uint4 c[RPL];  // 16 codes of each row, all loads in flight together
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const int row = base + 32 * r + lane;
          c[r] = row < n_valid
                     ? *reinterpret_cast<const uint4*>(codes + (size_t)row * M + m0 + j)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int b = 0; b < 16; ++b) {
#pragma unroll
          for (int r = 0; r < RPL; ++r) {
            add_entry(acc[r], lut_s, (j + b) * V + code_byte(c[r], b));
          }
        }
      }
    } else {
      for (int j = 0; j < ms; ++j) {
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const int row = base + 32 * r + lane;
          const int code = row < n_valid ? codes[(size_t)row * M + m0 + j] : 0;
          add_entry(acc[r], lut_s, j * V + code);
        }
      }
    }
  }

  const int nb = n_pad / BLOCK;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    const int q = q0 + i;
    if (q >= nq) break;  // uniform across the block
    float* srow = scores + (size_t)q * n_pad;
    float v[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int row = base + 32 * r + lane;
      v[r] = row < n_valid ? acc[r][i] : -FLT_MAX;
      if (row < n_pad) srow[row] = v[r];
    }
#pragma unroll
    for (int k = 0; k < RPL / 2; ++k) {  // rows base + 64 k .. base + 64 k + 63
      float mx = fmaxf(v[2 * k], v[2 * k + 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const int j = base / BLOCK + k;
      if (lane == 0 && j < nb) bmax[(size_t)q * nb + j] = mx;
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
  const int smem = (M < MS ? M : MS) * V * QB * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(adc_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_pad + TILE - 1) / TILE;
  for (int t0 = 0; t0 < tiles; t0 += MAX_GRID_Y) {  // one launch below 134M rows
    dim3 grid((nq + QB - 1) / QB, tiles - t0 < MAX_GRID_Y ? tiles - t0 : MAX_GRID_Y);
    adc_scores_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const float*)lut, (const uint8_t*)codes, (float*)scores, (float*)bmax, nq, n_valid, M,
        n_pad, t0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The launch plan, for the record: out[0..2] = queries a block, rows a block
// (one row tile), subquantizers a staged LUT slice.
int adc_plan(int* out) {
  out[0] = QB;
  out[1] = TILE;
  out[2] = MS;
  return 0;
}

}  // extern "C"
