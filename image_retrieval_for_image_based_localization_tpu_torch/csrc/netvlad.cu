// Fused NetVLAD soft-assignment + residual aggregation for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
// ops/pallas/netvlad_kernel.py::netvlad_fused (unmasked, _kernel) and
// ops/pallas/netvlad_kernel.py::netvlad_fused_rect (top-left (h, w)
// rectangle validity, _kernel_rect).
//
//   a[n, k]    = softmax_k(x[n, :] . W[:, k] + b[k])      (zero on invalid n)
//   vlad[k, c] = sum_n a[n, k] x[n, c] - (sum_n a[n, k]) centroids[k, c]
//   vlad[k, :] /= sqrt(sum_c vlad[k, c]^2) + 1e-6          (intra-normalization)
//   out        = flat(vlad) / (sqrt(sum flat^2) + 1e-6)      (global L2N)
//
// Position n of an [H, W] map is valid iff n / W < h_b and n % W < w_b.
//
// Bound on this card: operations. The logits and the aggregation are two
// products of 2 N C K flops each against one read of x; at [16, 64 x 64,
// 512], K = 64 that is 8.6 GFLOP (0.13 ms at 67 TFLOP/s f32) against
// 134 MB (0.04 ms). The TPU kernel carried agg [K, C] and cnt [K] in VMEM
// across a sequential grid; agg and W are 128 KB each at that shape, more
// than a block can hold, and Hopper blocks run in parallel. So:
//   (a) grid (B, splits): a block takes up to S_ROWS valid rows of one
//       image. Rows are enumerated in the valid rectangle, so an invalid row
//       is never read and a block past the image's valid rows exits at once.
//       Phase 1: logits of RT rows at a time against W staged through
//       shared memory in CC-channel slices (register tile of 2 rows x KP/16
//       clusters a thread), then the row softmax (max-subtract, expf, f32);
//       the assignment of all the block's rows stays in shared memory, it
//       never reaches device memory. Phase 2: a^T x over C in tiles of CT
//       channels (register tile of KP/16 clusters x 4 channels a thread),
//       written with the rows' cluster mass to scratch [B, splits, K, C] and
//       [B, splits, K] that the caller allocates.
//   (b) grid (B, K): sums the splits in order, subtracts cnt * centroids,
//       intra-normalizes the row and records its sum of squares; then
//   (c) grid (B, K): every block sums an image's K row totals in the same
//       order and divides its row by the global norm.
// Sums run in a fixed order with no atomics, so a run is deterministic. An
// image with no valid row (a batch-pad row, sizes (0, 0)) and a cluster with
// exactly zero soft mass both come out as zeros, as on the TPU (0 / (0 + eps)).
// Inputs are f32 (the JAX head casts its features to f32); K <= 128.
//
// Each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define NT 256        // threads per block
#define RT 32         // rows per sub-tile
#define CC 32         // channels per slice of the logits product
#define CT 64         // channels per tile of the aggregation product
#define S_ROWS 128    // valid rows per block of pass (a)
#define EPS 1e-6f
#define FULL 0xffffffffu

template <int KP>
struct Layout {
  static constexpr int KJ = KP / 16;                  // clusters per thread
  static constexpr int XS = RT + 1;                   // padded stride of the x slice
  static constexpr int STAGE1 = CC * XS + CC * KP;    // x slice [CC][XS] + W slice [CC][KP]
  static constexpr int STAGE2 = RT * CT;              // x tile [RT][CT]
  static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
  static constexpr int SMEM_BYTES = (S_ROWS * KP + STAGE) * (int)sizeof(float);
};

// Valid rows of image b: count and extent. sizes == null: all N rows.
__device__ __forceinline__ void valid_extent(const int32_t* sizes, int b, int N, int W,
                                             int* nvalid, int* wv) {
  if (sizes == nullptr) {
    *nvalid = N;
    *wv = N;
    return;
  }
  const int h = max(0, min(sizes[2 * b], N / W));
  const int w = max(0, min(sizes[2 * b + 1], W));
  *nvalid = h * w;
  *wv = w;
}

// Position in the [H * W] map of the v-th valid row (row-major in the rectangle).
__device__ __forceinline__ int position(int v, int wv, int W, bool masked) {
  return masked ? (v / wv) * W + (v % wv) : v;
}

template <int KP>
__global__ void __launch_bounds__(NT)
netvlad_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, const int32_t* __restrict__ sizes,
                       float* __restrict__ part_agg, float* __restrict__ part_cnt,
                       int N, int W, int C, int K) {
  using L = Layout<KP>;
  constexpr int KJ = L::KJ;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                   // [S_ROWS][KP] soft assignment of the block's rows
  float* stage = smem + S_ROWS * KP;

  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int tid = threadIdx.x;
  const bool masked = sizes != nullptr;
  int nvalid, wv;
  valid_extent(sizes, b, N, W, &nvalid, &wv);
  const int v0 = split * S_ROWS;
  const int rows = min(nvalid - v0, S_ROWS);
  if (rows <= 0) return;  // pass (b) reads only the splits that hold valid rows
  const float* xb = x + (size_t)b * N * C;

  // ---- phase 1: logits and softmax, RT rows at a time --------------------
  float* xs = stage;               // [CC][RT + 1], transposed
  float* ws = stage + CC * L::XS;  // [CC][KP]
  const int tx = tid % 16;         // clusters tx * KJ .. tx * KJ + KJ - 1
  const int ty = tid / 16;         // rows ty and ty + 16 of the sub-tile
  for (int r0 = 0; r0 < rows; r0 += RT) {
    const int rn = min(RT, rows - r0);
    float acc[2][KJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int e = tid; e < RT * CC; e += NT) {
        const int r = e / CC, cc = e % CC;
        float v = 0.f;
        if (r < rn && c0 + cc < C) {
          v = xb[(size_t)position(v0 + r0 + r, wv, W, masked) * C + c0 + cc];
        }
        xs[cc * L::XS + r] = v;
      }
      for (int e = tid; e < CC * KP; e += NT) {
        const int cc = e / KP, k = e % KP;
        ws[e] = (k < K && c0 + cc < C) ? w[(size_t)(c0 + cc) * K + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < CC; ++cc) {
        const float x0 = xs[cc * L::XS + ty];
        const float x1 = xs[cc * L::XS + ty + 16];
        const float4* wr = reinterpret_cast<const float4*>(ws + cc * KP + tx * KJ);
#pragma unroll
        for (int q = 0; q < KJ / 4; ++q) {
          const float4 w4 = wr[q];
          const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[0][4 * q + u] = fmaf(x0, wj[u], acc[0][4 * q + u]);
            acc[1][4 * q + u] = fmaf(x1, wj[u], acc[1][4 * q + u]);
          }
        }
      }
      __syncthreads();
    }
    // row softmax: a row's KP logits sit in 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = tx * KJ + j;
        acc[i][j] = k < K ? acc[i][j] + bias[k] : -FLT_MAX;
        m = fmaxf(m, acc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = tx * KJ + j;
        acc[i][j] = k < K ? expf(acc[i][j] - m) : 0.f;
        s += acc[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      const int r = ty + 16 * i;
      if (r < rn) {
        float* ar = a_s + (r0 + r) * KP + tx * KJ;
#pragma unroll
        for (int j = 0; j < KJ; ++j) ar[j] = acc[i][j] / s;
      }
    }
  }
  __syncthreads();

  // cluster mass of the block's rows, summed in row order
  for (int k = tid; k < K; k += NT) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += a_s[r * KP + k];
    part_cnt[((size_t)b * n_splits + split) * K + k] = s;
  }

  // ---- phase 2: agg = a^T x over C in tiles of CT channels ---------------
  float* xt = stage;      // [RT][CT]
  const int kq = tid / 16;  // clusters kq * KJ .. kq * KJ + KJ - 1
  const int cq = tid % 16;  // channels cq * 4 .. cq * 4 + 3 of the tile
  float* pa = part_agg + ((size_t)b * n_splits + split) * K * C;
  for (int c0 = 0; c0 < C; c0 += CT) {
    float acc[KJ][4];
#pragma unroll
    for (int i = 0; i < KJ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += RT) {
      const int rn = min(RT, rows - r0);
      for (int e = tid; e < RT * CT; e += NT) {
        const int r = e / CT, cc = e % CT;
        float v = 0.f;
        if (r < rn && c0 + cc < C) {
          v = xb[(size_t)position(v0 + r0 + r, wv, W, masked) * C + c0 + cc];
        }
        xt[e] = v;
      }
      __syncthreads();
      for (int r = 0; r < rn; ++r) {
        const float4 x4 = reinterpret_cast<const float4*>(xt + r * CT)[cq];
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float4* ar = reinterpret_cast<const float4*>(a_s + (r0 + r) * KP + kq * KJ);
#pragma unroll
        for (int q = 0; q < KJ / 4; ++q) {
          const float4 a4 = ar[q];
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[4 * q + u][j] = fmaf(av[u], xv[j], acc[4 * q + u][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < KJ; ++i) {
      const int k = kq * KJ + i;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + cq * 4 + j;
        if (c < C) pa[(size_t)k * C + c] = acc[i][j];
      }
    }
  }
}

// Sum over the block's threads, the same tree every call; all threads get it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

__global__ void __launch_bounds__(NT)
netvlad_residual_kernel(const float* __restrict__ part_agg, const float* __restrict__ part_cnt,
                        const float* __restrict__ centroids, const int32_t* __restrict__ sizes,
                        float* __restrict__ out, float* __restrict__ row_sq, int N, int W,
                        int C, int K, int n_splits) {
  __shared__ float red[NT / 32];
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  int nvalid, wv;
  valid_extent(sizes, b, N, W, &nvalid, &wv);
  const int used = (nvalid + S_ROWS - 1) / S_ROWS;  // splits that hold valid rows
  float cnt = 0.f;
  for (int s = 0; s < used; ++s) cnt += part_cnt[((size_t)b * n_splits + s) * K + k];
  const float* cen = centroids + (size_t)k * C;
  float* o = out + ((size_t)b * K + k) * C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) {
    float v = 0.f;
    for (int s = 0; s < used; ++s) v += part_agg[(((size_t)b * n_splits + s) * K + k) * C + c];
    v = v - cnt * cen[c];
    o[c] = v;
    sq += v * v;
  }
  const float intra = sqrtf(block_sum(sq, red)) + EPS;
  float sq2 = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float y = o[c] / intra;
    o[c] = y;
    sq2 += y * y;
  }
  sq2 = block_sum(sq2, red);
  if (threadIdx.x == 0) row_sq[(size_t)b * K + k] = sq2;
}

__global__ void __launch_bounds__(NT)
netvlad_scale_kernel(const float* __restrict__ row_sq, float* __restrict__ out, int C, int K) {
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  float g = 0.f;
  for (int i = 0; i < K; ++i) g += row_sq[(size_t)b * K + i];  // same order in every block
  const float denom = sqrtf(g) + EPS;
  float* o = out + ((size_t)b * K + k) * C;
  for (int c = threadIdx.x; c < C; c += NT) o[c] = o[c] / denom;
}

template <int KP>
static int launch(const void* x, const void* w, const void* bias, const void* centroids,
                  const void* sizes, void* part_agg, void* part_cnt, void* row_sq, void* out,
                  int B, int N, int W, int C, int K, int n_splits, cudaStream_t s) {
  const int smem = Layout<KP>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(netvlad_partial_kernel<KP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  netvlad_partial_kernel<KP><<<dim3(B, n_splits), NT, smem, s>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const int32_t*)sizes,
      (float*)part_agg, (float*)part_cnt, N, W, C, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  netvlad_residual_kernel<<<dim3(B, K), NT, 0, s>>>(
      (const float*)part_agg, (const float*)part_cnt, (const float*)centroids,
      (const int32_t*)sizes, (float*)out, (float*)row_sq, N, W, C, K, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  netvlad_scale_kernel<<<dim3(B, K), NT, 0, s>>>((const float*)row_sq, (float*)out, C, K);
  return (int)cudaGetLastError();
}

extern "C" {

// x: [B, N, C] f32 (N = H * W); w: [C, K] f32; bias: [K] f32; centroids:
// [K, C] f32; sizes: [B, 2] int32 (h, w) of the valid top-left rectangle of
// the [H, W] map, or null for all N rows; part_agg: [B, n_splits, K, C] and
// part_cnt: [B, n_splits, K] f32 scratch with n_splits = ceil(N / 128);
// row_sq: [B, K] f32 scratch; out: [B, K * C] f32. 1 <= K <= 128.
int netvlad_forward(const void* x, const void* w, const void* bias, const void* centroids,
                    const void* sizes, void* part_agg, void* part_cnt, void* row_sq,
                    void* out, int B, int N, int W, int C, int K, int n_splits,
                    void* stream) {
  if (K < 1 || K > 128 || W < 1 || n_splits != (N + S_ROWS - 1) / S_ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 64) {
    return launch<64>(x, w, bias, centroids, sizes, part_agg, part_cnt, row_sq, out, B, N,
                      W, C, K, n_splits, s);
  }
  return launch<128>(x, w, bias, centroids, sizes, part_agg, part_cnt, row_sq, out, B, N, W,
                     C, K, n_splits, s);
}

}  // extern "C"
