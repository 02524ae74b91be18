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
// bytes and layers 3-4 (22 and 2 of the 29 blocks) by operations: the
// mainloop's rate is what this design is about.
//
// Design: the block runs as three implicit GEMMs over M = B H W pixels on
// the warp-specialised mainloop of csrc/bf16_gemm.cuh (one TMA producer
// thread, two wgmma consumer warpgroups, a ring of 4-8 stages behind
// mbarriers, two partial accumulators in flight, output tiles stored by TMA
// from shared memory, a persistent grid of one block an SM), y1 and y2 in
// bf16 scratch that the caller allocates:
//   1. y1 = bf16(relu(x . w1 + b1)): N = Cm, K = Cin; A = x and B = w1t by
//      2-D TMA boxes;
//   2. y2 = bf16(relu(conv3x3(y1) + b2)): N = Cm, K = 9 Cm tap-major as w2's
//      HWIO layout; B = w2t by 2-D boxes, A by TMA's im2col mode over y1
//      [B, H, W, Cm]: a stage is BK channels of one tap (BK | Cm) at each
//      of the tile's pixels, the hardware walking the pixels across rows and
//      images and reading zeros outside each pixel's own image, which is the
//      SAME pad of y1 (y1 is 0 there, not relu(b1));
//   3. out = bf16(relu(y2 . w3 + b3 + f32(x))): N = Cin, K = Cm; A = y2 and B
//      = w3t by 2-D boxes; the skip's tile of x lands by TMA in the tile's
//      epilogue buffer while its products run.
// Tiles: 128 x 128 (m64n128k16) where N > 64, 256 x 64 (two m64n64k16 a
// consumer warpgroup) where N = 64; stages 64 deep where Cin and Cm are
// multiples of 64, 32 deep otherwise (ops/kernels/bottleneck.py::_plan
// gives the same choice). The weights come cast to bf16 and transposed to
// [N, K] (wgmma's K-major B) by the caller, once per folded trunk
// (ops/kernels/bottleneck.py::pack_bf16). The tensor maps are encoded on
// the host at each call through the driver's cuTensorMapEncodeTiled and
// cuTensorMapEncodeIm2col, reached by cudaGetDriverEntryPoint (the library
// links no driver library), and passed as __grid_constant__ parameters. A
// call launches the three phases and nothing else; they run in order on the
// caller's stream.
//
// Registers and shared memory (nvcc 12.9 -Xptxas -v, sm_90a): each of the
// twelve instantiations (three phases x BN 64, 128 x BK 32, 64) compiles to
// 168 registers at entry (the bound of 384 threads, one block an SM), no
// spills and no warning; setmaxnreg then gives the consumer warpgroups 232
// and the producer 40. Dynamic shared memory a block (_plan gives it
// too): 230,512 bytes at (BM, BN, BK) = (128, 128, 64), 5 stages; 230,496
// at (256, 64, 64), 4 stages; 197,792 at (128, 128, 32) and 230,560 at
// (256, 64, 32), 8 stages. The build log beside the library holds the
// counts.
//
// The entry returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "bf16_gemm.cuh"

typedef __nv_bfloat16 bf16;

struct Args {
  const float *b1, *b2, *b3;
  int M, H, W, Cin, Cm;
};

enum Phase { CONV1, CONV3X3, CONV1_SKIP };

// A of a 1x1 conv: a row-major [M, K] matrix, rows m0.. of the map at depth
// kc BK
template <int BK>
struct RowsA {
  const CUtensorMap* map;
  int m0 = 0;
  __device__ __forceinline__ void begin(int m) { m0 = m; }
  __device__ __forceinline__ void load(void* dst, int kc, uint64_t* bar) const {
    bf16mm::tma_load_2d(dst, map, kc * BK, m0, bar);
  }
};

// A of the 3x3 conv: row m, depth k = tap Cm + c is y1 at the neighbour
// (h + tap / 3 - 1, w + tap % 3 - 1) of pixel m in m's own image, channel
// c; zero outside that image. The map's im2col traversal walks the output
// pixels (its bounding box is the image, shifted by the pad) and reads each
// at the tap's offset, zero outside the tensor; a stage is BK channels of
// one tap (BK | Cm)
template <int BK>
struct TapsA {
  const CUtensorMap* map;
  int H, W, Cm;
  int n = 0, h = 0, w = 0;  // the tile's first pixel
  __device__ __forceinline__ void begin(int m0) {
    const int hw = H * W;
    n = m0 / hw;
    const int q = m0 - n * hw;
    h = q / W;
    w = q - h * W;
  }
  __device__ __forceinline__ void load(void* dst, int kc, uint64_t* bar) const {
    const int k0 = kc * BK, tap = k0 / Cm;
    bf16mm::tma_load_im2col(dst, map, k0 - tap * Cm, w - 1, h - 1, n, (uint16_t)(tap % 3),
                            (uint16_t)(tap / 3), bar);
  }
};

// The tile's results, rounded to bf16 in epilogue buffer j % 2, stored by
// TMA: y = bf16(relu(acc + bias)), and in the last phase out = bf16(relu(acc
// + b3 + f32(x))), the skip x read from the same buffer, where the producer
// put it. Columns past N take no bias (the store drops them).
template <int PHASE, class T>
__device__ __forceinline__ void epilogue(const float (&acc)[T::MI][T::BN / 2], const Args& a,
                                         const bf16mm::Smem<T>& sm, const CUtensorMap* mo,
                                         int m0, int n0, int N, int j) {
  using namespace bf16mm;
  const int b = j % EPI_BUFFERS;
  char* e = sm.epi(b);
  if (threadIdx.x % 128 == 0) {
    bulk_wait_read();  // tile j - 1's stores have read the other buffer
    if (PHASE == CONV1_SKIP && j > 0) mbar_arrive(&sm.eempty()[(j - 1) % EPI_BUFFERS]);
  }
  if (PHASE == CONV1_SKIP) mbar_wait(&sm.efull()[b], (j / EPI_BUFFERS) & 1);
  const float* __restrict__ bias = PHASE == CONV1 ? a.b1 : PHASE == CONV3X3 ? a.b2 : a.b3;
  for_each_pair<T>([&](int i, int q, int r, int n, int off) {
    const float2 bb = n0 + n < N ? *reinterpret_cast<const float2*>(bias + n0 + n)
                                 : make_float2(0.f, 0.f);
    float vx = acc[i][q] + bb.x, vy = acc[i][q + 1] + bb.y;
    __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(e + off);
    if (PHASE == CONV1_SKIP) {
      const float2 skip = __bfloat1622float2(*y);
      vx += skip.x;
      vy += skip.y;
    }
    *y = __floats2bfloat162_rn(fmaxf(vx, 0.f), fmaxf(vy, 0.f));
  });
  store_tile<T>(mo, e, m0, n0);
}

// One phase. ma, mb: A's and B's maps (A's in im2col mode in the 3x3
// phase); mo: the output's; mx: the skip's (the last phase only). Warpgroups
// 0 and 1 consume, one thread of warpgroup 2 produces; the roles part once
// and never meet again (setmaxnreg needs that).
template <int PHASE, int BN, int BK>
__global__ void __launch_bounds__(bf16mm::NT, 1)
    bottleneck_bf16_phase(const __grid_constant__ CUtensorMap ma,
                          const __grid_constant__ CUtensorMap mb,
                          const __grid_constant__ CUtensorMap mo,
                          const __grid_constant__ CUtensorMap mx, const Args a) {
  using T = bf16mm::Tile<BN, BK>;
  using namespace bf16mm;
  extern __shared__ __align__(16) char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int N = PHASE == CONV1_SKIP ? a.Cin : a.Cm;
  const int K = PHASE == CONV1 ? a.Cin : PHASE == CONV3X3 ? 9 * a.Cm : a.Cm;
  const int KT = K / BK, n_tiles = (N + BN - 1) / BN;
  const int tiles = (a.M + T::BM - 1) / T::BM * n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&sm.full()[s], 1);          // the producer's, with the TMA bytes
      mbar_init(&sm.empty()[s], NCW * 4);   // each consumer warp's
    }
    for (int b = 0; b < EPI_BUFFERS; ++b) {
      mbar_init(&sm.efull()[b], 1);
      mbar_init(&sm.eempty()[b], NCW);      // each consumer warpgroup's storing thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= NCW * 128) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NCW * 128) {
      const CUtensorMap* skip = PHASE == CONV1_SKIP ? &mx : nullptr;
      if constexpr (PHASE == CONV3X3) {
        produce<T>(TapsA<BK>{&ma, a.H, a.W, a.Cm}, &mb, skip, sm, tiles, n_tiles, KT);
      } else {
        produce<T>(RowsA<BK>{&ma}, &mb, skip, sm, tiles, n_tiles, KT);
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    Ring r;
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      int m0, n0;
      tile_origin<T>(tile, n_tiles, m0, n0);
      float acc[T::MI][BN / 2];
      consume_tile<T>(acc, sm, r, KT);
      epilogue<PHASE, T>(acc, a, sm, &mo, m0, n0, N, j);
    }
    if (threadIdx.x % 128 == 0) bulk_wait();  // the last stores are out
  }
}

// ---- host side -------------------------------------------------------------

// a phase's launch: tile rows and columns, ring stages, dynamic shared
// memory, output tiles and blocks
struct PhasePlan {
  int bm, bn, stages, smem, tiles, grid;
};

template <int BN, int BK>
static PhasePlan tile_plan(long long M, int N, int sms) {
  using T = bf16mm::Tile<BN, BK>;
  const long long tiles = (M + T::BM - 1) / T::BM * ((N + BN - 1) / BN);
  const int t = tiles > INT_MAX ? -1 : (int)tiles;
  return {T::BM, BN, T::STAGES, T::SMEM_BYTES, t, tiles < sms ? t : sms};
}

// 128-wide tiles where N > 64; stages 64 deep where every K block allows it
static int stage_depth(int Cin, int Cm) {
  return Cin % bf16mm::DEEP_BK == 0 && Cm % bf16mm::DEEP_BK == 0 ? bf16mm::DEEP_BK
                                                                  : bf16mm::SHALLOW_BK;
}
static PhasePlan plan_phase(long long M, int N, int bk, int sms) {
  using namespace bf16mm;
  if (bk == DEEP_BK)
    return N > NARROW_BN ? tile_plan<WIDE_BN, DEEP_BK>(M, N, sms)
                         : tile_plan<NARROW_BN, DEEP_BK>(M, N, sms);
  return N > NARROW_BN ? tile_plan<WIDE_BN, SHALLOW_BK>(M, N, sms)
                       : tile_plan<NARROW_BN, SHALLOW_BK>(M, N, sms);
}

static int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a driver entry point, found through the runtime (no driver library linked)
static void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

static CUtensorMapSwizzle swizzle(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// a [rows, cols] row-major bf16 matrix in boxes of box_cols x box_rows, in
// the swizzle of box_cols-wide rows (128 or 64 bytes); out-of-range elements
// read as zeros and are not written
static bool make_map(CUtensorMap* map, const void* p, long long rows, int cols, int box_cols,
                     int box_rows) {
  static const EncodeTiled enc = (EncodeTiled)driver_fn("cuTensorMapEncodeTiled");
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(box_cols * (int)sizeof(bf16)),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// y [B, H, W, C] bf16 NHWC in im2col mode for a 3x3 stride-1 SAME conv:
// the traversal's bounding box is each image shifted by the pad (corners
// -1, -1: W x H positions, one an output pixel), `pixels` positions a box,
// bk channels of each
static bool make_im2col(CUtensorMap* map, const void* y, int B, int H, int W, int C, int bk,
                        int pixels) {
  static const EncodeIm2col enc = (EncodeIm2col)driver_fn("cuTensorMapEncodeIm2col");
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(bf16), (cuuint64_t)W * C * sizeof(bf16),
                                 (cuuint64_t)H * W * C * sizeof(bf16)};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(y), dims, strides, lower,
             upper, (cuuint32_t)bk, (cuuint32_t)pixels, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle(bk * (int)sizeof(bf16)), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A phase's operands: A (x, y1 or y2), its depth, B (the packed weight), the
// output and the skip (the last phase's x), with N output channels and depth K
struct Operands {
  const void *a, *b;
  void* out;
  const void* skip;
  int N, K;
};

template <int PHASE, int BN, int BK>
static cudaError_t launch(const PhasePlan& pl, const Operands& o, const Args& a, int B,
                          cudaStream_t stream) {
  using T = bf16mm::Tile<BN, BK>;
  auto kernel = bottleneck_bf16_phase<PHASE, BN, BK>;
  // the attribute belongs to the device's context: set once per
  // instantiation and device (a bit each for devices 0-63, every launch past)
  static std::atomic<unsigned long long> attributes_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit == 0 || !(attributes_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attributes_set.fetch_or(bit, std::memory_order_release);
  }
  CUtensorMap ma, mb, mo, mx;
  const bool ok =
      (PHASE == CONV3X3 ? make_im2col(&ma, o.a, B, a.H, a.W, a.Cm, BK, T::BM)
                        : make_map(&ma, o.a, a.M, o.K, BK, T::BM)) &&
      make_map(&mb, o.b, o.N, o.K, BK, BN) &&
      make_map(&mo, o.out, a.M, o.N, bf16mm::PANEL, T::BM / bf16mm::NCW) &&
      (PHASE == CONV1_SKIP ? make_map(&mx, o.skip, a.M, o.N, bf16mm::PANEL, T::BM)
                           : (mx = mo, true));
  if (!ok) return cudaErrorInvalidValue;
  kernel<<<pl.grid, bf16mm::NT, T::SMEM_BYTES, stream>>>(ma, mb, mo, mx, a);
  return cudaGetLastError();
}

template <int PHASE>
static cudaError_t phase(const Operands& o, const Args& a, int B, int bk, int sms,
                         cudaStream_t stream) {
  using namespace bf16mm;
  const PhasePlan pl = plan_phase(a.M, o.N, bk, sms);
  if (pl.tiles < 0) return cudaErrorInvalidValue;
  if (bk == DEEP_BK)
    return pl.bn == WIDE_BN ? launch<PHASE, WIDE_BN, DEEP_BK>(pl, o, a, B, stream)
                            : launch<PHASE, NARROW_BN, DEEP_BK>(pl, o, a, B, stream);
  return pl.bn == WIDE_BN ? launch<PHASE, WIDE_BN, SHALLOW_BK>(pl, o, a, B, stream)
                          : launch<PHASE, NARROW_BN, SHALLOW_BK>(pl, o, a, B, stream);
}

static bool valid_shape(int B, int H, int W, int Cin, int Cm) {
  return B >= 1 && H >= 1 && W >= 1 && Cin >= 32 && Cm >= 32 && Cin % 32 == 0 && Cm % 32 == 0 &&
         (long long)B * H * W <= INT_MAX - bf16mm::NARROW_BM;
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
  if (!valid_shape(B, H, W, Cin, Cm)) return (int)cudaErrorInvalidValue;
  const int sms = num_sms();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Args a{(const float*)b1, (const float*)b2, (const float*)b3, B * H * W, H, W, Cin, Cm};
  const int bk = stage_depth(Cin, Cm);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = phase<CONV1>({x, w1t, y1, nullptr, Cm, Cin}, a, B, bk, sms, st);
  if (err == cudaSuccess) err = phase<CONV3X3>({y1, w2t, y2, nullptr, Cm, 9 * Cm}, a, B, bk, sms, st);
  if (err == cudaSuccess) err = phase<CONV1_SKIP>({y2, w3t, out, x, Cin, Cm}, a, B, bk, sms, st);
  return (int)err;
}

}  // extern "C"
