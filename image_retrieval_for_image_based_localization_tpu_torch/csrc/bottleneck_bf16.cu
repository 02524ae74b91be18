// Fused stride-1 identity ResNet bottleneck (inference, BatchNorm folded),
// bf16 form, for Hopper (sm_90a): three bf16 tensor-core implicit GEMMs over
// the whole batch with f32 sums.
//
// Replaces the JAX package's Pallas kernel
// ops/pallas/bottleneck_block.py::bottleneck_fused on a bf16 x, with its
// rounding points (bottleneck_oracle there): on NHWC bf16 x [B, H, W, Cin]
// with folded weights cast to bf16, f32 biases:
//
//   y1  = bf16(relu(x . w1 + b1))           (zero outside the image: SAME pad of y1)
//   y2  = bf16(relu(conv3x3(y1, w2) + b2))
//   out = bf16(relu(y2 . w3 + b3 + f32(x)))
//
// each dot an f32 sum of exact bf16 products, each bf16() round to nearest
// even; the skip is widened to f32 and added before the one rounding.
//
// Bound on this card: max(flop / 989e12, bytes / 3.35e12), the block's
// 2 B H W (2 Cin Cm + 9 Cm^2) flop at the dense bf16 tensor-core rate and
// bytes = x read + out written + the weights, the least any design moves.
// Each of resnet101's stride-1 block shapes on a 16-image 1024 px bucket is
// 1.46e11 flop (0.148 ms); the bytes take 0.320 ms at layer1 ([16, 256, 256,
// 256], 1.07 GB) and 0.160 ms at layer2, so the two early layers are bound by
// bytes and layers 3-4 by operations.
//
// Design: csrc/bottleneck.cu's, with bf16 operands. Keeping y1 and y2 on chip
// costs halo recompute and small tiles on this card, so the block runs as
// implicit GEMMs over M = B H W pixels on 128 x 64 output tiles
// (csrc/bf16_gemm.cuh), the weights reused across 128 pixels, y1 and y2 in
// bf16 scratch that the caller allocates (half the f32 form's bytes):
//   1. y1 = bf16(relu(x . w1 + b1)): N = Cm, K = Cin;
//   2. y2 = bf16(relu(conv3x3(y1) + b2)): N = Cm, K = 9 Cm tap-major as w2's
//      HWIO layout. A stage is 32 channels of one tap (Cm % 32 == 0),
//      gathered at the pixel's shifted neighbour; a neighbour outside the
//      pixel's own image is zero-filled, which is the SAME pad of y1 (y1 is 0
//      there, not relu(b1)). A 128-pixel tile spans image rows and, at small
//      H W, images: the mask tests h and w within each pixel's own image;
//   3. out = bf16(relu(y2 . w3 + b3 + f32(x))): N = Cin, K = Cm; the skip x
//      is read in the epilogue.
// The weights come cast to bf16 and transposed to [N, K] (wgmma's K-major
// B) by the caller, once per folded trunk (ops/kernels/bottleneck.py::
// pack_bf16), so a call launches the three phases and nothing else. They run
// in order on the caller's stream.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 94
// registers in conv1 and conv1_skip, 96 in conv3x3, no spills; 74,752 bytes
// of dynamic shared memory a block, two blocks an SM. The build log beside
// the library holds the counts.
//
// The entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_gemm.cuh"

using bf16mm::a_col;
using bf16mm::a_row;
using bf16mm::ACC;
using bf16mm::BM;
using bf16mm::BN;
using bf16mm::NT;
typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* x;
  const float *b1, *b2, *b3;
  const bf16 *w1t, *w2t, *w3t;  // [N, K]
  bf16 *y1, *y2, *out;
  int M, H, W, Cin, Cm;
};

// A = a row-major [M, K] matrix
struct RowsA {
  const bf16* p[2];
  bool ok[2];
  __device__ RowsA(const bf16* a, int K, int m0, int M) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + a_row(i);
      ok[i] = m < M;
      p[i] = a + (size_t)(ok[i] ? m : 0) * K + a_col();
    }
  }
  __device__ __forceinline__ const bf16* src(int i, int k0, bool& v) const {
    v = ok[i];
    return p[i] + k0;
  }
};

// A of the 3x3 conv: row m, depth k = tap Cm + c is y1 at the neighbour
// (h + tap / 3 - 1, w + tap % 3 - 1) of pixel m in m's own image, channel
// c; zero outside that image
struct TapsA {
  const bf16* p[2];  // y1 at the pixel itself, this thread's channels
  int h[2], w[2];    // rows past M get h = -2: no tap is inside
  int H, W, Cm;
  __device__ TapsA(const bf16* y1, int m0, int M, int H_, int W_, int Cm_)
      : H(H_), W(W_), Cm(Cm_) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + a_row(i);
      const int r = (m < M ? m : 0) % (H * W);
      h[i] = m < M ? r / W : -2;
      w[i] = r % W;
      p[i] = y1 + (size_t)(m < M ? m : 0) * Cm + a_col();
    }
  }
  __device__ __forceinline__ const bf16* src(int i, int k0, bool& v) const {
    const int tap = k0 / Cm, dh = tap / 3 - 1, dw = tap % 3 - 1;
    v = (unsigned)(h[i] + dh) < (unsigned)H && (unsigned)(w[i] + dw) < (unsigned)W;
    return v ? p[i] + ((ptrdiff_t)(dh * W + dw) * Cm + (k0 - tap * Cm)) : p[i];
  }
};

// the tile of this block in a phase with N output channels: the column
// tile varies fastest, so blocks that share A's rows run together
__device__ __forceinline__ void tile_origin(int N, int& m0, int& n0) {
  const int n_tiles = (N + BN - 1) / BN;
  m0 = (int)(blockIdx.x / n_tiles) * BM;
  n0 = (int)(blockIdx.x % n_tiles) * BN;
}

// y = bf16(relu(acc + bias)), stored [M, N] row-major
__device__ __forceinline__ void store_relu(const float (&acc)[ACC],
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ y, int M, int N, int m0, int n0) {
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
    *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
        __floats2bfloat162_rn(fmaxf(acc[e] + b.x, 0.f), fmaxf(acc[e + 1] + b.y, 0.f));
  });
}

__global__ void __launch_bounds__(NT, 2) bottleneck_bf16_conv1(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cm, m0, n0);
  float acc[ACC];
  bf16mm::gemm_tile(RowsA(a.x, a.Cin, m0, a.M), a.w1t, a.Cm, a.Cin, n0, smem, acc);
  store_relu(acc, a.b1, a.y1, a.M, a.Cm, m0, n0);
}

__global__ void __launch_bounds__(NT, 2) bottleneck_bf16_conv3x3(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cm, m0, n0);
  float acc[ACC];
  bf16mm::gemm_tile(TapsA(a.y1, m0, a.M, a.H, a.W, a.Cm), a.w2t, a.Cm, 9 * a.Cm, n0, smem,
                    acc);
  store_relu(acc, a.b2, a.y2, a.M, a.Cm, m0, n0);
}

__global__ void __launch_bounds__(NT, 2) bottleneck_bf16_conv1_skip(Args a) {
  extern __shared__ __align__(16) char smem[];
  int m0, n0;
  tile_origin(a.Cin, m0, n0);
  float acc[ACC];
  bf16mm::gemm_tile(RowsA(a.y2, a.Cm, m0, a.M), a.w3t, a.Cin, a.Cm, n0, smem, acc);
  // the skip's loads all go out before the first store
  const bf16* __restrict__ x = a.x;
  const float* __restrict__ b3 = a.b3;
  bf16* __restrict__ out = a.out;
  const int M = a.M, N = a.Cin;
  __nv_bfloat162 skip[ACC / 2];
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    skip[e / 2] = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * N + n);
  });
  tf32x3::for_each_pair(M, N, m0, n0, [&](int e, int m, int n) {
    const float2 b = *reinterpret_cast<const float2*>(b3 + n);
    const float2 s = __bfloat1622float2(skip[e / 2]);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = __floats2bfloat162_rn(
        fmaxf(acc[e] + b.x + s.x, 0.f), fmaxf(acc[e + 1] + b.y + s.y, 0.f));
  });
}

static cudaError_t phase(void (*kernel)(Args), int N, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bf16mm::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, NT, bf16mm::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

extern "C" {

// x, out: [B, H, W, Cin] bf16 NHWC (out must not alias x); w1t [Cm, Cin],
// w2t [Cm, 9 Cm] (w2 [3, 3, Cm, Cm] HWIO read as [9 Cm, Cm], transposed:
// K tap-major), w3t [Cin, Cm], all bf16; b1/b2 [Cm], b3 [Cin] f32; all
// contiguous and 16-byte aligned. Scratch: y1 and y2 [B, H, W, Cm] bf16
// each. Needs Cin % 32 == 0 and Cm % 32 == 0.
int bottleneck_forward_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                            const void* b2, const void* w3t, const void* b3, void* y1, void* y2,
                            void* out, int B, int H, int W, int Cin, int Cm, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 32 || Cm < 32 || Cin % 32 || Cm % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * H * W;
  if (M > INT_MAX - BM) return (int)cudaErrorInvalidValue;
  const Args a{(const bf16*)x,   (const float*)b1,  (const float*)b2,  (const float*)b3,
               (const bf16*)w1t, (const bf16*)w2t,  (const bf16*)w3t,  (bf16*)y1,
               (bf16*)y2,        (bf16*)out,        (int)M,            H,
               W,                Cin,               Cm};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = phase(bottleneck_bf16_conv1, Cm, a, st);
  if (err == cudaSuccess) err = phase(bottleneck_bf16_conv3x3, Cm, a, st);
  if (err == cudaSuccess) err = phase(bottleneck_bf16_conv1_skip, Cin, a, st);
  return (int)err;
}

}  // extern "C"
