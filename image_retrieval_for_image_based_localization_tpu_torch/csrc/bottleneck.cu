// Fused stride-1 identity ResNet bottleneck (inference, BatchNorm folded),
// for Hopper (sm_90a): three 3xTF32 tensor-core implicit GEMMs over the
// whole batch.
//
// Replaces the JAX package's Pallas kernel
// ops/pallas/bottleneck_block.py::bottleneck_fused. On NHWC f32 x [B, H, W, Cin]
// with folded weights w1 [Cin, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, Cin]:
//
//   y1  = relu(x . w1 + b1)                 (zero outside the image: SAME pad of y1)
//   y2  = relu(conv3x3(y1, w2) + b2)
//   out = relu(y2 . w3 + b3 + x)
//
// Bound on this card: operations. The block is 2 B H W (2 Cin Cm + 9 Cm^2)
// flop, each taken as three tensor-core products (csrc/tf32x3_gemm.cuh), so
// max(3 flop / 495e12, bytes / 3.35e12) with bytes = x read + out written +
// the weights, the least any design moves. Each of resnet50's stride-1
// block shapes on a 16-image 1024 px bucket ([16, 256, 256, 256] Cm 64 down
// to [16, 32, 32, 2048] Cm 512) is 1.46e11 flop: 0.885 ms on the tensor
// cores, against 2.18 ms as f32 FMA on the CUDA cores at 67 TFLOP/s; the
// bytes take 0.64 ms at layer1 and less below.
//
// Accuracy: every product is split as in csrc/tf32x3_gemm.cuh (hi = tf32(v),
// lo = tf32(v - hi), lo_a hi_b + hi_a lo_b + hi_a hi_b, f32 sums, a fresh
// tensor-core accumulator each 32-deep stage), so each product is right to
// about 2^-21 and the sums are f32 sums in another order: the output stays
// within 1e-5 of max|out| of three f32 convolutions (cuDNN, TF32 off), the
// tolerance the package holds every block to.
//
// Design. Keeping y1 and y2 on chip, as the TPU kernel does, costs halo
// recompute and small tiles on this card, while writing them to device
// memory and reading them back costs less than the tensor-core time at every
// layer but layer1 (4.3 GB there in all, 1.3 ms). So the block runs as
// implicit GEMMs over M = B H W pixels on 128 x 64 output tiles, the weights
// reused across 128 pixels:
//   0. bottleneck_split_weights: w1, w2, w3 split into hi and lo planes,
//      transposed to [N, K] (wgmma's K-major B);
//   1. y1 = relu(x . w1 + b1): N = Cm, K = Cin;
//   2. y2 = relu(conv3x3(y1) + b2): N = Cm, K = 9 Cm tap-major as w2's HWIO
//      layout. A stage is 32 channels of one tap (Cm % 32 == 0), gathered at
//      the pixel's shifted neighbour; a neighbour outside the pixel's own
//      image is zero-filled, which is the SAME pad of y1 (y1 is 0 there, not
//      relu(b1)). A 128-pixel tile spans image rows and, at small H W,
//      images: the mask tests h and w within each pixel's own image;
//   3. out = relu(y2 . w3 + b3 + x): N = Cin, K = Cm; the skip x is read in
//      the epilogue.
// The weights' planes and y1, y2 are scratch that the caller allocates. The
// kernels run in order on the caller's stream.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a): each phase 126-128
// registers (the 3x3 phase spills 16 bytes), 105,472 bytes of dynamic shared
// memory, two blocks an SM. The build log beside the library holds the
// counts.
//
// Each entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3_gemm.cuh"

using tf32x3::a_col;
using tf32x3::a_row;
using tf32x3::ACC;
using tf32x3::BM;
using tf32x3::BN;
using tf32x3::NT;

struct Args {
  const float *x, *b1, *b2, *b3;
  const float *w1h, *w1l, *w2h, *w2l, *w3h, *w3l;  // split planes, [N, K]
  float *y1, *y2, *out;
  int M, H, W, Cin, Cm;
};

// A = a row-major [M, K] matrix
struct RowsA {
  const float* p[4];
  bool ok[4];
  __device__ RowsA(const float* a, int K, int m0, int M) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_row(i);
      ok[i] = m < M;
      p[i] = a + (size_t)(ok[i] ? m : 0) * K + a_col();
    }
  }
  __device__ __forceinline__ const float* src(int i, int k0, bool& v) const {
    v = ok[i];
    return p[i] + k0;
  }
};

// A of the 3x3 conv: row m, depth k = tap Cm + c is y1 at the neighbour
// (h + tap / 3 - 1, w + tap % 3 - 1) of pixel m in m's own image, channel
// c; zero outside that image
struct TapsA {
  const float* p[4];  // y1 at the pixel itself, this thread's channels
  int h[4], w[4];     // rows past M get h = -2: no tap is inside
  int H, W, Cm;
  __device__ TapsA(const float* y1, int m0, int M, int H_, int W_, int Cm_)
      : H(H_), W(W_), Cm(Cm_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_row(i);
      const int r = (m < M ? m : 0) % (H * W);
      h[i] = m < M ? r / W : -2;
      w[i] = r % W;
      p[i] = y1 + (size_t)(m < M ? m : 0) * Cm + a_col();
    }
  }
  __device__ __forceinline__ const float* src(int i, int k0, bool& v) const {
    const int tap = k0 / Cm, dh = tap / 3 - 1, dw = tap % 3 - 1;
    v = (unsigned)(h[i] + dh) < (unsigned)H && (unsigned)(w[i] + dw) < (unsigned)W;
    return v ? p[i] + ((ptrdiff_t)(dh * W + dw) * Cm + (k0 - tap * Cm)) : p[i];
  }
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// hi and lo planes [N, K] of a weight matrix w [K, N] (row-major), split by
// the rule of csrc/tf32x3_gemm.cuh; 32 x 32 tiles transposed through shared
// memory
__global__ void __launch_bounds__(256) bottleneck_split_weights(const float* __restrict__ w,
                                                                float* __restrict__ hi,
                                                                float* __restrict__ lo, int K,
                                                                int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32, tx = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < 32; r += 8) tile[r][tx] = w[(size_t)(k0 + r) * N + n0 + tx];
  __syncthreads();
  for (int r = threadIdx.x / 32; r < 32; r += 8) {
    uint32_t h, l;
    tf32x3::split(tile[tx][r], h, l);
    const size_t o = (size_t)(n0 + r) * K + k0 + tx;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

// the tile of this block in a phase with N output channels: the column
// tile varies fastest, so blocks that share A's rows run together
__device__ __forceinline__ void tile_origin(int N, int& m0, int& n0) {
  const int n_tiles = (N + BN - 1) / BN;
  m0 = (int)(blockIdx.x / n_tiles) * BM;
  n0 = (int)(blockIdx.x % n_tiles) * BN;
}

// y = relu(acc + bias), stored [M, N] row-major
__device__ __forceinline__ void store_relu(const float (&acc)[ACC],
                                           const float* __restrict__ bias,
                                           float* __restrict__ y, int M, int N, int m0, int n0) {
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    const float2 b = ld2(bias + n);
    st2(y + (size_t)m * N + n, fmaxf(acc[e] + b.x, 0.f), fmaxf(acc[e + 1] + b.y, 0.f));
  });
}

__global__ void __launch_bounds__(NT, 2) bottleneck_conv1(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cm, m0, n0);
  float acc[ACC];
  tf32x3::gemm_tile(RowsA(a.x, a.Cin, m0, a.M), a.w1h, a.w1l, a.Cm, a.Cin, n0, smem, acc);
  store_relu(acc, a.b1, a.y1, a.M, a.Cm, m0, n0);
}

__global__ void __launch_bounds__(NT, 2) bottleneck_conv3x3(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cm, m0, n0);
  float acc[ACC];
  tf32x3::gemm_tile(TapsA(a.y1, m0, a.M, a.H, a.W, a.Cm), a.w2h, a.w2l, a.Cm, 9 * a.Cm, n0,
                    smem, acc);
  store_relu(acc, a.b2, a.y2, a.M, a.Cm, m0, n0);
}

__global__ void __launch_bounds__(NT, 2) bottleneck_conv1_skip(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cin, m0, n0);
  float acc[ACC];
  tf32x3::gemm_tile(RowsA(a.y2, a.Cm, m0, a.M), a.w3h, a.w3l, a.Cin, a.Cm, n0, smem, acc);
  // the skip's loads all go out before the first store
  const float* __restrict__ x = a.x;
  const float* __restrict__ b3 = a.b3;
  float* __restrict__ out = a.out;
  const int M = a.M, N = a.Cin;
  float2 skip[ACC / 2];
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    skip[e / 2] = ld2(x + (size_t)m * N + n);
  });
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    const float2 b = ld2(b3 + n), s = skip[e / 2];
    st2(out + (size_t)m * N + n, fmaxf(acc[e] + b.x + s.x, 0.f),
        fmaxf(acc[e + 1] + b.y + s.y, 0.f));
  });
}

static cudaError_t split_weights(const void* w, const float* hi, const float* lo, int K, int N,
                                 cudaStream_t stream) {
  bottleneck_split_weights<<<dim3(N / 32, K / 32), 256, 0, stream>>>(
      (const float*)w, (float*)hi, (float*)lo, K, N);
  return cudaGetLastError();
}

static cudaError_t phase(void (*kernel)(Args), int N, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tf32x3::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, NT, tf32x3::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

extern "C" {

// x, out: [B, H, W, Cin] f32 NHWC (out must not alias x); w1 [Cin, Cm],
// w2 [3, 3, Cm, Cm], w3 [Cm, Cin], b1/b2 [Cm], b3 [Cin], all f32
// contiguous. Scratch: wt holds 2 (2 Cin Cm + 9 Cm^2) floats (the weights'
// split planes), y1 and y2 [B, H, W, Cm] each. Needs Cin % 32 == 0 and
// Cm % 32 == 0.
int bottleneck_forward(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, void* wt, void* y1,
                       void* y2, void* out, int B, int H, int W, int Cin, int Cm, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 32 || Cm < 32 || Cin % 32 || Cm % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * H * W;
  if (M > INT_MAX - BM) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)wt;
  const size_t n1 = (size_t)Cin * Cm, n2 = (size_t)9 * Cm * Cm;
  const Args a{(const float*)x, (const float*)b1, (const float*)b2, (const float*)b3,
               p, p + n1, p + 2 * n1, p + 2 * n1 + n2, p + 2 * n1 + 2 * n2, p + 3 * n1 + 2 * n2,
               (float*)y1, (float*)y2, (float*)out, (int)M, H, W, Cin, Cm};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = split_weights(w1, a.w1h, a.w1l, Cin, Cm, st);
  if (err == cudaSuccess) err = split_weights(w2, a.w2h, a.w2l, 9 * Cm, Cm, st);
  if (err == cudaSuccess) err = split_weights(w3, a.w3h, a.w3l, Cm, Cin, st);
  if (err == cudaSuccess) err = phase(bottleneck_conv1, Cm, a, st);
  if (err == cudaSuccess) err = phase(bottleneck_conv3x3, Cm, a, st);
  if (err == cudaSuccess) err = phase(bottleneck_conv1_skip, Cin, a, st);
  return (int)err;
}

}  // extern "C"
