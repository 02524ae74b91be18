// Fused NetVLAD soft-assignment + residual aggregation for Hopper (sm_90a):
// both products as 3xTF32 tensor-core GEMMs on csrc/tf32x3_gemm.cuh.
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
// With pre_l2 (NetVLAD's preL2 models) netvlad_forward first L2-normalizes
// each row, x_n / max(||x_n||, 1e-12) as F.normalize does, as a per-row
// scale r_n and not a normalized copy of x: L1 writes x_n . W without the bias; L2
// reads x_n's row once for r_n and takes softmax_k(r_n (x_n . W) + b) as its
// logits, the cluster mass sum_n a[n, k] unscaled and a[n, k] r_n as L3's
// weights, so vlad[k, c] = sum_n a[n, k] r_n x[n, c] - mass_k centroids[k, c].
//
// Position n of an [H, W] map is valid iff n / W < h_b and n % W < w_b; the
// valid rows are enumerated row-major in the rectangle (v = 0 .. h w - 1),
// so an invalid row is never read.
//
// Bound on this card: the two products, 2 N C K flop each, taken as three
// TF32 tensor-core products (the split rule of csrc/tf32x3_gemm.cuh), against
// one read of x. At [16, 64 x 64, 512], K = 64: 8.59 GFLOP, 0.052 ms at 495
// TFLOP/s / 3, against 134 MB, 0.040 ms (0.128 ms as f32 FMA). preL2 reads the
// valid rows of x once more (L2's norms), which stays under the operations. The TPU
// kernel carried agg [K, C] in VMEM across a sequential grid; here blocks run
// in parallel, so the work is six kernels on the caller's stream, with W's
// planes, the assignment and the partial sums in scratch the caller allocates:
//   L0 netvlad_split_w: W^T's hi/lo planes [KP, C], zero past row K.
//   L1 netvlad_logits: logits = x_valid . W + b on tf32x3::gemm_tile, M = an
//      image's valid rows (tiles of 128), N = K (tiles of 64), depth C; A is
//      x through the rectangle (rows past the valid count land as zeros), B
//      the planes. A block past the image's valid rows exits at once.
//      Writes [B, NP, KP] f32.
//   L2 netvlad_softmax: 32 rows a block, any K: row max and sum (a warp a
//      row; with preL2 the row's norm first, from x, and the bias), then
//      a = e / s in 32-cluster slices transposed through shared
//      memory and written as a^T's hi/lo planes [B, K, NP], zero on invalid
//      and pad rows: the B operand of L3 as its loader reads it. Each 32-row
//      tile's cluster mass, summed in row order, goes to [B, NP / 32, K].
//   L3 netvlad_aggregate: agg^T[c, k] = sum_v x[pos(v), c] a[v, k] on
//      tf32x3::gemm_tile_at (M = C in tiles of 128, N = K in tiles of 64,
//      depth = rows). x is the register operand: its reduction axis, the
//      rows, is strided in device memory, and TF32 wgmma takes a shared
//      operand only K-major. Each image's valid rows go in fixed chunks of
//      CHUNK, so a batch of 16 fills the card; each chunk writes its partial
//      [K, C] to [B, S, K, C]. The longest chunk sets this kernel's time: at
//      512 rows a ragged batch's blocks fit in one wave (on an H100, config
//      3's ragged batch 0.041 ms against 0.068 at 1,024 rows; unmasked 0.078
//      against 0.073).
//   L4 netvlad_residual, netvlad_scale: grid (K, B); sum the chunks and the
//      masses in order, subtract cnt * centroids, intra-normalize and record
//      each row's sum of squares; then every block sums an image's K row
//      totals by the same tree and divides its row by the global norm.
// No atomics and sums in a fixed order, so two calls give the same bits. An
// image with no valid row (a batch-pad row, sizes (0, 0)) and a cluster with
// exactly zero soft mass both come out as zeros, as on the TPU (0 / (0 + eps)).
// K is a tiled GEMM dimension and the softmax loops over it, so any K >= 1
// runs; C must be a multiple of 32 (the caller pads channels with zeros,
// which change no logit, sum or norm). Inputs are f32.
//
// Each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3_gemm.cuh"

using tf32x3::a_col;
using tf32x3::a_row;
using tf32x3::ACC;
using tf32x3::at_col;
using tf32x3::at_row;
using tf32x3::BK;
using tf32x3::BM;
using tf32x3::BN;
using tf32x3::NT;

#define CHUNK 512     // valid rows of an image per block of the aggregation
#define RT 32         // rows per block of the softmax
#define EPS 1e-6f
#define FULL 0xffffffffu
static_assert(CHUNK % BK == 0 && RT == BK, "chunks and softmax tiles end on a stage");

struct Args {
  const float *x, *w, *bias, *centroids;  // bias null: zeros
  const int32_t* sizes;                   // null: every row valid
  float *wt_hi, *wt_lo, *logits, *a_hi, *a_lo, *mass, *part, *row_sq, *out;
  int N, W, C, K, KP, NP, S;
  int pre_l2;  // 1: each row scaled by 1 / max(||x_n||, 1e-12), the bias added in L2
};

// Valid rows of image b: count and rectangle width. sizes == null: all N rows.
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

// L1's A: the valid rows m0 + a_row(i) of one image, channels contiguous
struct ValidRowsA {
  const float* p[4];
  bool ok[4];
  __device__ ValidRowsA(const float* xb, int C, int m0, int nvalid, int wv, int W, bool masked) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = m0 + a_row(i);
      ok[i] = v < nvalid;
      p[i] = xb + (size_t)(ok[i] ? position(v, wv, W, masked) : 0) * C + a_col();
    }
  }
  __device__ __forceinline__ const float* src(int i, int k0, bool& v) const {
    v = ok[i];
    return p[i] + k0;
  }
};

// L3's A, depth-major: depth row k0 + at_row(i) is valid row v0 + k0 +
// at_row(i) of the image (zeros at and past v_end), columns m0 + at_col()
struct ValidRowsT {
  const float* xb;  // x of the image
  int col, v0, v_end, wv, W, C;
  bool masked;
  __device__ __forceinline__ const float* src(int i, int k0, bool& valid) const {
    const int v = v0 + k0 + at_row(i);
    valid = col < C && v < v_end;
    return valid ? xb + (size_t)position(v, wv, W, masked) * C + col : xb;
  }
};

// W^T's hi and lo planes [KP, C] from w [C, K], split by the rule of
// csrc/tf32x3_gemm.cuh, zero past row K; 32 x 32 tiles transposed through
// shared memory
__global__ void __launch_bounds__(256) netvlad_split_w(Args a) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32, tx = threadIdx.x % 32;
  const int C = a.C, K = a.K;
  for (int r = threadIdx.x / 32; r < 32; r += 8) {
    tile[r][tx] = k0 + tx < K ? a.w[(size_t)(c0 + r) * K + k0 + tx] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x / 32; r < 32; r += 8) {
    uint32_t h, l;
    tf32x3::split(tile[tx][r], h, l);
    const size_t o = (size_t)(k0 + r) * C + c0 + tx;
    a.wt_hi[o] = __uint_as_float(h);
    a.wt_lo[o] = __uint_as_float(l);
  }
}

__global__ void __launch_bounds__(NT, 2) netvlad_logits(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int nvalid, wv;
  valid_extent(a.sizes, b, a.N, a.W, &nvalid, &wv);
  if (m0 >= nvalid) return;
  const float* xb = a.x + (size_t)b * a.N * a.C;
  float acc[ACC];
  tf32x3::gemm_tile(ValidRowsA(xb, a.C, m0, nvalid, wv, a.W, a.sizes != nullptr), a.wt_hi,
                    a.wt_lo, a.KP, a.C, n0, smem, acc);
  const float* __restrict__ bias = a.pre_l2 ? nullptr : a.bias;  // preL2: added in L2
  float* __restrict__ lg = a.logits + (size_t)b * a.NP * a.KP;
  const int K = a.K, KP = a.KP;
  tf32x3::for_each_pair(nvalid, KP, m0, n0, [&](int e, int m, int n) {
    const bool has = bias != nullptr;
    const float b0 = has && n < K ? bias[n] : 0.f, b1 = has && n + 1 < K ? bias[n + 1] : 0.f;
    *reinterpret_cast<float2*>(lg + (size_t)m * KP + n) = make_float2(acc[e] + b0,
                                                                      acc[e + 1] + b1);
  });
}

__global__ void __launch_bounds__(256) netvlad_softmax(Args a) {
  __shared__ float tile[32][33];  // [cluster][row] of one 32-cluster slice
  __shared__ float rmax[RT], rsum[RT], rscale[RT];
  const int b = blockIdx.y, t = blockIdx.x, v0 = t * RT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int nvalid, wv;
  valid_extent(a.sizes, b, a.N, a.W, &nvalid, &wv);
  if (v0 >= nvalid) return;
  const int K = a.K, KP = a.KP, NP = a.NP;
  const float* lg = a.logits + ((size_t)b * NP + v0) * KP;
  const float* __restrict__ bias = a.bias;
  const bool pre = a.pre_l2 != 0;
  // row r's logit k: L1's, or with preL2 rs (x . W) + b
  auto logit = [&](int r, float rs, int k) {
    const float z = lg[(size_t)r * KP + k];
    return pre ? fmaf(z, rs, bias != nullptr ? bias[k] : 0.f) : z;
  };
  // row max and sum of exp, a warp a row; lanes take k = lane + 32 j, then
  // the same butterfly every call. With preL2 the row's scale comes first:
  // its sum of squares over c = lane + 32 j, by the same butterfly.
  for (int r = warp; r < RT; r += 8) {
    float m = -FLT_MAX, s = 0.f, rs = 0.f;
    if (v0 + r < nvalid) {
      if (pre) {
        const float* xr = a.x + ((size_t)b * a.N + position(v0 + r, wv, a.W,
                                                            a.sizes != nullptr)) * a.C;
        float q = 0.f;
        for (int c = lane; c < a.C; c += 32) q = fmaf(xr[c], xr[c], q);
        for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(FULL, q, o);
        rs = 1.f / fmaxf(sqrtf(q), 1e-12f);
      }
      for (int k = lane; k < K; k += 32) m = fmaxf(m, logit(r, rs, k));
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      for (int k = lane; k < K; k += 32) s += expf(logit(r, rs, k) - m);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    }
    if (lane == 0) {
      rmax[r] = m;
      rsum[r] = s;
      rscale[r] = rs;  // 0 on an invalid row, whose weights are 0
    }
  }
  __syncthreads();
  float* ahi = a.a_hi + (size_t)b * K * NP + v0;
  float* alo = a.a_lo + (size_t)b * K * NP + v0;
  float* mass = a.mass + ((size_t)b * (NP / RT) + t) * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    for (int r = warp; r < RT; r += 8) {
      const int k = k0 + lane;
      float p = 0.f;
      if (v0 + r < nvalid && k < K) p = expf(logit(r, rscale[r], k) - rmax[r]) / rsum[r];
      tile[lane][r] = p;
    }
    __syncthreads();
    for (int kk = warp; kk < 32 && k0 + kk < K; kk += 8) {
      uint32_t hi, lo;
      float p = tile[kk][lane];
      if (pre) p *= rscale[lane];  // the aggregation's weight; the mass below stays a's
      tf32x3::split(p, hi, lo);
      const size_t o = (size_t)(k0 + kk) * NP + lane;
      ahi[o] = __uint_as_float(hi);
      alo[o] = __uint_as_float(lo);
    }
    if (warp == 0 && k0 + lane < K) {
      float s = 0.f;
      for (int r = 0; r < RT; ++r) s += tile[lane][r];
      mass[k0 + lane] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 2) netvlad_aggregate(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.z, s = blockIdx.y;
  const int n_tiles = (a.K + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM, n0 = (int)(blockIdx.x % n_tiles) * BN;
  int nvalid, wv;
  valid_extent(a.sizes, b, a.N, a.W, &nvalid, &wv);
  const int v0 = s * CHUNK;
  if (v0 >= nvalid) return;
  const int v_end = min(v0 + CHUNK, nvalid);
  const int depth = (v_end - v0 + BK - 1) / BK * BK;  // a^T is zero past v_end
  const int C = a.C, K = a.K;
  const ValidRowsT src{a.x + (size_t)b * a.N * C, m0 + at_col(), v0, v_end, wv, a.W, C,
                       a.sizes != nullptr};
  const size_t plane = (size_t)b * K * a.NP + v0;
  float acc[ACC];
  tf32x3::gemm_tile_at(src, a.a_hi + plane, a.a_lo + plane, a.NP, K, depth, n0, smem, acc);
  // acc pairs are agg^T[c, k], agg^T[c, k + 1]: stored to part[b, s, k, c]
  float* __restrict__ pt = a.part + ((size_t)b * a.S + s) * K * C;
  const int K8 = (K + 7) / 8 * 8;
  tf32x3::for_each_pair(C, K8, m0, n0, [&](int e, int c, int k) {
    if (k < K) pt[(size_t)k * C + c] = acc[e];
    if (k + 1 < K) pt[(size_t)(k + 1) * C + c] = acc[e + 1];
  });
}

// Sum over the block's 256 threads, the same tree every call; all threads get it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < 8; ++i) t += red[i];
  return t;
}

__global__ void __launch_bounds__(256) netvlad_residual(Args a) {
  __shared__ float red[8];
  const int k = blockIdx.x, b = blockIdx.y;
  const int C = a.C, K = a.K;
  int nvalid, wv;
  valid_extent(a.sizes, b, a.N, a.W, &nvalid, &wv);
  const int tiles = (nvalid + RT - 1) / RT;        // softmax tiles that hold valid rows
  const int used = (nvalid + CHUNK - 1) / CHUNK;  // chunks that hold valid rows
  float m = 0.f;
  for (int i = threadIdx.x; i < tiles; i += 256) m += a.mass[((size_t)b * (a.NP / RT) + i) * K + k];
  const float cnt = block_sum(m, red);
  const float* cen = a.centroids + (size_t)k * C;
  const float* pt = a.part + ((size_t)b * a.S * K + k) * C;
  float* o = a.out + ((size_t)b * K + k) * C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += 256) {
    float v = 0.f;
    for (int s = 0; s < used; ++s) v += pt[(size_t)s * K * C + c];
    v = v - cnt * cen[c];
    o[c] = v;
    sq += v * v;
  }
  const float intra = sqrtf(block_sum(sq, red)) + EPS;
  float sq2 = 0.f;
  for (int c = threadIdx.x; c < C; c += 256) {
    const float y = o[c] / intra;
    o[c] = y;
    sq2 += y * y;
  }
  sq2 = block_sum(sq2, red);
  if (threadIdx.x == 0) a.row_sq[(size_t)b * K + k] = sq2;
}

__global__ void __launch_bounds__(256) netvlad_scale(Args a) {
  __shared__ float red[8];
  const int k = blockIdx.x, b = blockIdx.y;
  float g = 0.f;
  for (int i = threadIdx.x; i < a.K; i += 256) g += a.row_sq[(size_t)b * a.K + i];
  const float denom = sqrtf(block_sum(g, red)) + EPS;  // the same tree in every block
  float* o = a.out + ((size_t)b * a.K + k) * a.C;
  for (int c = threadIdx.x; c < a.C; c += 256) o[c] = o[c] / denom;
}

static cudaError_t gemm_launch(void (*kernel)(Args), dim3 grid, int smem, const Args& a,
                               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

extern "C" {

// x: [B, N, C] f32 (N = H * W), C % 32 == 0; w: [C, K] f32; bias: [K] f32
// or null (zeros); centroids: [K, C] f32; sizes: [B, 2] int32 (h, w) of the
// valid top-left rectangle of the [H, W] map, or null for all N rows.
// Scratch, KP = ceil(K / 64) * 64, NP = ceil(N / 32) * 32 and n_chunks =
// ceil(N / 512): wt_hi and wt_lo [KP, C] (W^T's split planes), logits
// [B, NP, KP], a_hi and a_lo [B, K, NP], mass [B, NP / 32, K], part
// [B, n_chunks, K, C], row_sq [B, K], all f32; the planes and a_hi, a_lo
// 16-byte aligned. out: [B, K * C] f32. Any K >= 1. pre_l2: 1 to
// L2-normalize each row of x first (preL2), 0 not to.
int netvlad_forward(const void* x, const void* w, const void* bias, const void* centroids,
                    const void* sizes, void* wt_hi, void* wt_lo, void* logits, void* a_hi,
                    void* a_lo, void* mass, void* part, void* row_sq, void* out, int B, int N,
                    int W, int C, int K, int n_chunks, void* stream, int pre_l2) {
  if (B < 1 || B > 65535 || N < 1 || W < 1 || C < 32 || C % 32 || K < 1 ||
      N > INT_MAX - CHUNK || n_chunks != (N + CHUNK - 1) / CHUNK) {
    return (int)cudaErrorInvalidValue;
  }
  const int KP = (K + BN - 1) / BN * BN, NP = (N + RT - 1) / RT * RT;
  const int m_tiles = (NP + BM - 1) / BM;
  if (m_tiles > 65535 || KP > INT_MAX / 2 || C / 32 > 65535) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)x, (const float*)w, (const float*)bias, (const float*)centroids,
               (const int32_t*)sizes, (float*)wt_hi, (float*)wt_lo, (float*)logits,
               (float*)a_hi, (float*)a_lo, (float*)mass, (float*)part, (float*)row_sq,
               (float*)out, N, W, C, K, KP, NP, n_chunks, pre_l2};
  cudaStream_t s = (cudaStream_t)stream;
  const int k_tiles = KP / BN, c_tiles = (C + BM - 1) / BM;
  netvlad_split_w<<<dim3(KP / 32, C / 32), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = gemm_launch(netvlad_logits, dim3(k_tiles, m_tiles, B), tf32x3::SMEM_BYTES, a, s);
  }
  if (err == cudaSuccess) {
    netvlad_softmax<<<dim3(NP / RT, B), 256, 0, s>>>(a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    err = gemm_launch(netvlad_aggregate, dim3(c_tiles * k_tiles, n_chunks, B),
                      tf32x3::AT_SMEM_BYTES, a, s);
  }
  if (err == cudaSuccess) {
    netvlad_residual<<<dim3(K, B), 256, 0, s>>>(a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    netvlad_scale<<<dim3(K, B), 256, 0, s>>>(a);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
