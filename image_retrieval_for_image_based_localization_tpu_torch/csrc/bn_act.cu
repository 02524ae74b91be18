// Inference BatchNorm + residual add + ReLU over a bf16 map, one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. On the TPU, XLA fuses flax's
// nn.BatchNorm(dtype=bf16), the ReLU and the residual add of the JAX
// package's models/resnet.py into the convolution's neighbours. On the card
// the bf16 trunk (models/resnet.py, models/densenet.py) ran them as ATen
// passes: y.float(), sub_, mul_, add_ (three broadcasts of a (1, C, 1, 1)
// operand over a channels_last map, on ATen's generic unvectorised kernel),
// .to(bf16), then ReLU, and `out + identity` and ReLU again: ~40 bytes of
// device memory an element. This kernel computes the same bits from one read
// of the conv output (and of the identity) and one write:
//
//   o = bf16_rn(((f32(y[r, c]) - mean[c]) * mul[c]) + bias[c])
//   o = bf16_rn(f32(o) + f32(identity[r, c]))          where there is one
//   o = isnan(o) ? o : max(o, 0)                         where relu
//
// each f32 operation rounded alone (no FMA contraction), in bn_lowp's order;
// the add and the ReLU are what `out + identity` and `torch.relu_` compute on
// bf16 tensors (both in f32 and rounded once; clamp_min keeps a NaN and
// takes fmaxf otherwise). mul = rsqrt(var + eps) * weight is made by the
// wrapper with the same torch ops bn_lowp uses.
//
// Bound on this card: bytes (a few flops an element). The map is seen as
// [rows = N * H * W, C] (channels_last), C a multiple of 8, 16-byte aligned.
// Each thread owns one 8-channel slice (16 bytes) for its whole grid-stride
// loop over rows, with its 24 per-channel floats in registers; it keeps U
// independent 16-byte loads of y (and U of the identity) in flight a step.
// The grid is as many threads as the card holds at once (the occupancy
// query, cached per device), cut to whole rows of slices; offsets are
// 64-bit. No shared memory. `out` may be `y` (in place: each element is read
// and then written by the same thread).
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256       // threads per block
#define U 4          // rows in flight per thread and step
#define MAX_DEV 64   // devices whose launch plan is cached

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool ID, bool RELU>
__device__ __forceinline__ uint32_t one(float v, float id, float m, float k, float b) {
  __nv_bfloat16 o = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fsub_rn(v, m), k), b));
  if (ID) o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), id));
  if (RELU) {
    const float f = __bfloat162float(o);
    if (!(f != f)) o = __float2bfloat16_rn(fmaxf(f, 0.0f));
  }
  return (uint32_t)__bfloat16_as_ushort(o);
}

// Two channels (c, c + 1) packed in one 32-bit word: c in the low half.
template <bool ID, bool RELU>
__device__ __forceinline__ uint32_t two(uint32_t y, uint32_t id, const float* m, const float* k,
                                        const float* b, int c) {
  return one<ID, RELU>(lo_f32(y), lo_f32(id), m[c], k[c], b[c]) |
         (one<ID, RELU>(hi_f32(y), hi_f32(id), m[c + 1], k[c + 1], b[c + 1]) << 16);
}

template <bool ID, bool RELU>
__device__ __forceinline__ uint4 eight(uint4 y, uint4 id, const float* m, const float* k,
                                       const float* b) {
  uint4 o;
  o.x = two<ID, RELU>(y.x, id.x, m, k, b, 0);
  o.y = two<ID, RELU>(y.y, id.y, m, k, b, 2);
  o.z = two<ID, RELU>(y.z, id.z, m, k, b, 4);
  o.w = two<ID, RELU>(y.w, id.w, m, k, b, 6);
  return o;
}

// y, id, out: [rows, G] slices of 8 bf16; thread t owns slice t % G of rows
// t / G, t / G + R, ... (R * G threads in all).
template <bool ID, bool RELU>
__global__ void __launch_bounds__(NT)
bn_act_kernel(const uint4* y, const uint4* __restrict__ id, const float* __restrict__ mean,
              const float* __restrict__ mul, const float* __restrict__ bias, uint4* out,
              int rows, int G, int R) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)R * G) return;
  const int g = (int)(t % G);
  int r = (int)(t / G);
  float m[8], k[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = __ldg(mean + 8 * g + j);
    k[j] = __ldg(mul + 8 * g + j);
    b[j] = __ldg(bias + 8 * g + j);
  }
  const long long step = (long long)R * G;  // slices between a thread's rows
  long long i = (long long)r * G + g;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (; r + (U - 1) * R < rows; r += U * R, i += U * step) {
    uint4 v[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = y[i + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = ID ? __ldg(id + i + u * step) : zero;
#pragma unroll
    for (int u = 0; u < U; ++u) out[i + u * step] = eight<ID, RELU>(v[u], w[u], m, k, b);
  }
  for (; r < rows; r += R, i += step) {
    out[i] = eight<ID, RELU>(y[i], ID ? __ldg(id + i) : zero, m, k, b);
  }
}

// Blocks of NT one SM holds at once, per device and form; 0 until asked.
static int g_sms[MAX_DEV];
static int g_blocks_per_sm[MAX_DEV][4];

template <bool ID, bool RELU>
static int launch(const void* y, const void* id, const void* mean, const void* mul,
                  const void* bias, void* out, int rows, int C, cudaStream_t stream) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const int form = 2 * ID + RELU;
  if (dev < MAX_DEV && g_blocks_per_sm[dev][form] == 0) {
    err = (int)cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (!err) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_blocks_per_sm[dev][form],
                                                               bn_act_kernel<ID, RELU>, NT, 0);
    }
    if (err) return err;
  }
  const long long resident =
      dev < MAX_DEV ? (long long)g_sms[dev] * g_blocks_per_sm[dev][form] * NT : 132LL * 8 * NT;
  const int G = C / 8;
  long long R = resident / G;
  const long long need = ((long long)rows + U - 1) / U;  // each thread at least U rows
  if (R > need) R = need;
  if (R < 1) R = 1;
  const long long blocks = (R * G + NT - 1) / NT;
  bn_act_kernel<ID, RELU><<<(unsigned)blocks, NT, 0, stream>>>(
      (const uint4*)y, (const uint4*)id, (const float*)mean, (const float*)mul,
      (const float*)bias, (uint4*)out, rows, G, (int)R);
  return (int)cudaGetLastError();
}

extern "C" {

// y, out: [rows, C] bf16 (channels_last maps), 16-byte aligned, out may be y;
// identity: the same shape or null; mean, mul, bias: [C] f32. C % 8 == 0.
int bn_act_forward(const void* y, const void* identity, const void* mean, const void* mul,
                   const void* bias, void* out, int rows, int C, int relu, void* stream) {
  if (rows < 0 || C < 8 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (identity) {
    return relu ? launch<true, true>(y, identity, mean, mul, bias, out, rows, C, s)
                : launch<true, false>(y, identity, mean, mul, bias, out, rows, C, s);
  }
  return relu ? launch<false, true>(y, identity, mean, mul, bias, out, rows, C, s)
              : launch<false, false>(y, identity, mean, mul, bias, out, rows, C, s);
}

}  // extern "C"
