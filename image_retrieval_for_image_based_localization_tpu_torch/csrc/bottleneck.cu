// Fused stride-1 identity ResNet bottleneck (inference, BatchNorm folded),
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// ops/pallas/bottleneck_block.py::bottleneck_fused. On NHWC f32 x [B, H, W, Cin]
// with folded weights w1 [Cin, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, Cin]:
//
//   y1  = relu(x . w1 + b1)                 (zero outside the image: SAME pad of y1)
//   y2  = relu(conv3x3(y1, w2) + b2)
//   out = relu(y2 . w3 + b3 + x)
//
// Bound on this card: operations, 2 B H W (2 Cin Cm + 9 Cm^2) flop of f32 FMA
// on the CUDA cores (layer1 of a 16-image 1024 px bucket, [16, 256, 256, 256]
// with Cm = 64: 1.46e11 flop, 2.2 ms at 67 TFLOP/s, against 2.1 GB of x and
// out through HBM, 0.64 ms).
//
// Design (simple and exact first): a block owns a TH x TW tile of output
// pixels of one image. Phase 1 computes y1 over the tile and its one-pixel
// halo, (TH + 2) x (TW + 2) pixels, straight from x in HBM; halo pixels that
// lie outside the image get y1 = 0, because the 3x3 conv zero-pads the
// activation y1, not x (on a zero x, y1 would be relu(b1) != 0). Interior
// halos keep their real values (recomputed by the neighbouring tiles). Phase
// 2 runs the 3x3 conv as an implicit GEMM over the nine taps of y1 in shared
// memory into y2, also in shared memory; phase 3 multiplies y2 by w3 and adds
// b3 and the skip x before the ReLU, and writes only the output. So y1 and y2
// never reach HBM: x is read about once (plus the halo) and out written once.
// Each phase is the same block GEMM: 64 x 64 output tiles, 256 threads with a
// 4 x 4 register tile each, A and B staged through shared memory 32 deep, B
// (the weights) streamed from L2. Every sum is a sequential f32 FMA chain
// (no TF32). The tile shape comes from the shared-memory budget: the largest
// of 8x16, 8x8, 4x8 whose y1 + y2 + staging fits two blocks on an SM, else
// the largest that fits one (layer4, Cm = 512: 4x8, 206 KB). Tiles cut at the
// image edge mask the outside pixels, so every H and W is taken.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256  // threads per block
#define BM 64   // GEMM tile rows (pixels)
#define BN 64   // GEMM tile columns (channels)
#define KD 32   // depth staged per step
#define STAGE_FLOATS (KD * (BM + 4) + KD * (BN + 4))

struct Shape {
  int B, H, W, Cin, Cm, TH, TW;
};

// C[Mrows, N] = A[Mrows, K] . Bw[K, N] (Bw row-major in global memory); A's
// element (m, k) comes from loadA(m, k) (called only for m < Mrows), and
// epi(m, n, c) receives each finished element. K % KD == 0.
template <class LoadA, class Epi>
__device__ __forceinline__ void block_gemm(int Mrows, int N, int K, const float* __restrict__ Bw,
                                           float* stage, LoadA loadA, Epi epi) {
  float(*as)[BM + 4] = reinterpret_cast<float(*)[BM + 4]>(stage);
  float(*bs)[BN + 4] = reinterpret_cast<float(*)[BN + 4]>(stage + KD * (BM + 4));
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 of the tile
  const int ty = tid / 16;  // rows ty*4 .. +3 of the tile
  for (int m0 = 0; m0 < Mrows; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KD) {
        for (int e = tid; e < BM * KD; e += NT) {
          const int r = e / KD, kk = e % KD;
          as[kk][r] = m0 + r < Mrows ? loadA(m0 + r, k0 + kk) : 0.f;
        }
        for (int e = tid; e < KD * BN; e += NT) {
          const int kk = e / BN, c = e % BN;
          bs[kk][c] = n0 + c < N ? Bw[(size_t)(k0 + kk) * N + n0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KD; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = m0 + ty * 4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = n0 + tx * 4 + b;
          if (m < Mrows && n < N) epi(m, n, acc[a][b]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
bottleneck_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ w3,
                  const float* __restrict__ b3, float* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int TH = s.TH, TW = s.TW, Cin = s.Cin, Cm = s.Cm, H = s.H, W = s.W;
  const int HW2 = TW + 2;           // halo tile width
  const int Ph = (TH + 2) * HW2;    // halo pixels
  const int P = TH * TW;            // output pixels
  float* y1 = smem;                 // [Ph][Cm]
  float* y2 = y1 + (size_t)Ph * Cm;  // [P][Cm]
  float* stage = y2 + (size_t)P * Cm;

  const int tiles_w = (W + TW - 1) / TW;
  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const float* xb = x + (size_t)b * H * W * Cin;
  float* ob = out + (size_t)b * H * W * Cin;

  // phase 1: y1 over the halo tile; outside the image y1 is 0
  block_gemm(
      Ph, Cm, Cin, w1, stage,
      [&](int p, int k) -> float {
        const int hh = h0 - 1 + p / HW2, ww = w0 - 1 + p % HW2;
        return (hh >= 0 && hh < H && ww >= 0 && ww < W) ? xb[((size_t)hh * W + ww) * Cin + k]
                                                       : 0.f;
      },
      [&](int p, int n, float c) {
        const int hh = h0 - 1 + p / HW2, ww = w0 - 1 + p % HW2;
        const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W;
        y1[(size_t)p * Cm + n] = inside ? fmaxf(c + b1[n], 0.f) : 0.f;
      });
  __syncthreads();

  // phase 2: 3x3 conv of y1 as a GEMM over K = 9 Cm (tap-major, as w2's HWIO
  // layout); a 32-deep step never crosses a tap since Cm % 32 == 0
  block_gemm(
      P, Cm, 9 * Cm, w2, stage,
      [&](int p, int k) -> float {
        const int tap = k / Cm, c = k % Cm;
        const int ph = p / TW + tap / 3, pw = p % TW + tap % 3;
        return y1[((size_t)ph * HW2 + pw) * Cm + c];
      },
      [&](int p, int n, float c) { y2[(size_t)p * Cm + n] = fmaxf(c + b2[n], 0.f); });
  __syncthreads();

  // phase 3: y2 . w3 + b3 + x, ReLU, written for pixels inside the image
  block_gemm(
      P, Cin, Cm, w3, stage, [&](int p, int k) -> float { return y2[(size_t)p * Cm + k]; },
      [&](int p, int n, float c) {
        const int hh = h0 + p / TW, ww = w0 + p % TW;
        if (hh < H && ww < W) {
          const size_t o = ((size_t)hh * W + ww) * Cin + n;
          ob[o] = fmaxf(c + b3[n] + xb[o], 0.f);
        }
      });
}

static size_t smem_bytes(int Cm, int TH, int TW) {
  return ((size_t)(TH + 2) * (TW + 2) * Cm + (size_t)TH * TW * Cm + STAGE_FLOATS) *
         sizeof(float);
}

extern "C" {

// x, out: [B, H, W, Cin] f32 NHWC (out must not alias x); w1 [Cin, Cm],
// w2 [3, 3, Cm, Cm], w3 [Cm, Cin], b1/b2 [Cm], b3 [Cin], all f32 contiguous.
// Needs Cin % 32 == 0 and Cm % 32 == 0.
int bottleneck_forward(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, void* out, int B, int H,
                       int W, int Cin, int Cm, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 32 || Cm < 32 || Cin % 32 || Cm % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t two_per_sm = 113 * 1024, one_per_sm = 227 * 1024;
  const int tiles[3][2] = {{8, 16}, {8, 8}, {4, 8}};
  int pick = -1;
  for (int i = 0; i < 3 && pick < 0; ++i)
    if (smem_bytes(Cm, tiles[i][0], tiles[i][1]) <= two_per_sm) pick = i;
  for (int i = 0; i < 3 && pick < 0; ++i)
    if (smem_bytes(Cm, tiles[i][0], tiles[i][1]) <= one_per_sm) pick = i;
  if (pick < 0) return (int)cudaErrorInvalidValue;
  Shape s{B, H, W, Cin, Cm, tiles[pick][0], tiles[pick][1]};
  const size_t smem = smem_bytes(Cm, s.TH, s.TW);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((H + s.TH - 1) / s.TH) * ((W + s.TW - 1) / s.TW);
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n_tiles, B);
  bottleneck_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (const float*)w3, (const float*)b3, (float*)out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
