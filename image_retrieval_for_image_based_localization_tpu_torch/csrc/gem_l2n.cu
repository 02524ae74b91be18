// Fused GeM pooling + L2 normalization for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
// ops/pallas/gem_l2n.py::gem_l2n_fused (unmasked, _kernel) and
// ops/pallas/gem_l2n.py::gem_l2n_fused_rect (top-left (h, w) rectangle
// validity, _kernel_rect).
//
//   pooled[b, c] = (sum_{n valid} max(x[b, n, c], 1e-6)^p / denom_b)^(1/p)
//   out[b, c]    = pooled[b, c] / (sqrt(sum_c pooled[b, c]^2) + 1e-6)
//
// denom_b is N (unmasked) or max(h_b * w_b, 1) (rect). Position n of a
// [H, W] map is valid iff n / W < h_b and n % W < w_b.
//
// Bound on this card: bytes. The function reads the valid rows of the
// feature map once and writes [B, C]; a few flops per element sit far below
// the HBM roofline. The TPU kernel carried a running sum across a sequential
// grid. Here one launch does the whole function, deterministically, with no
// scratch in device memory and no atomics: a thread-block cluster of CS = 8
// CTAs (the portable limit) owns one image.
//   1. The image's valid positions, walked as r < h, col < w (no divide per
//      element), are cut into equal contiguous runs, one per (CTA, row lane).
//      A thread owns 8 channels of one row lane: two float4 loads (f32) or
//      one 16-byte load of 8 bf16 a position, four positions in flight, so a
//      CTA of 1,024 threads keeps ~128 KB of loads in flight. Where C is not a
//      multiple of the vector width (or the map is not 16-byte aligned) the
//      same plan runs on scalar loads. clamp(x, 1e-6)^p is exp2(p log2 x)
//      on the special function unit (lg2/ex2.approx: the accurate exp2f
//      and __log2f were 8 % slower with no gain inside the 1e-5 bound).
//   2. Each CTA sums its row lanes in shared memory, in lane order.
//   3. After a cluster barrier, CTA k reduces channel slice k of the image
//      over the eight CTAs' sums, in rank order, through distributed shared
//      memory; then the mean, the 1/p power and its share of sum pooled^2.
//   4. After a second barrier each CTA adds the eight shares in rank order,
//      so every CTA has the same norm, and writes its slice normalized.
// Wider maps (C > MAX_C = 8,192, the channels one cluster holds) are cut into
// equal chunks of at most MAX_C channels, a multiple of 8 wide (so every
// chunk's first channel keeps the vector loads 16-byte aligned): one cluster
// per (image, chunk), blockIdx.z the chunk, each writing its chunk's pooled
// values unnormalized; then gem_l2n_finish, one CTA an image, sums pooled^2
// over all C in a fixed order and scales the row. C <= MAX_C keeps the one
// launch above unchanged. More than 65,535 images (the grid's y limit) run
// as consecutive launches of at most 65,535.
// Every sum runs in a fixed order, so two calls give the same bits. p is read
// from device memory (it is a learnable parameter; reading it on the host
// would force a sync per batch). Inputs are f32 or bf16, accumulated in f32.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define GEM_EPS 1e-6f
#define L2N_EPS 1e-6f
#define NT 1024  // threads per CTA (512 measured 11 % slower in f32)
#define CS 8     // CTAs per image: one cluster
#define CPT 8    // channels per thread
#define U 4      // positions in flight per thread
#define MAX_C (CPT * NT)

// shared memory at its largest (RL * C <= NT * CPT for every C <= MAX_C) stays
// within the 48 KB a launch gets without opting in
static_assert((NT * CPT + (MAX_C + CS - 1) / CS + NT / 32 + 2) * 4 <= 48 * 1024,
              "gem_l2n shared memory");
static_assert(CS <= 8, "the portable cluster size");

// A thread's 8 channels of one position: raw loads, then f32.
template <typename T, int VEC> struct Chan;
template <> struct Chan<float, 4> {  // two float4
  typedef uint4 R;
  static constexpr int L = 2;
  static __device__ __forceinline__ R load(const float* p, int i) {
    return __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  static __device__ __forceinline__ void unpack(const R& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Chan<__nv_bfloat16, 8> {  // one 16-byte load of 8 bf16
  typedef uint4 R;
  static constexpr int L = 1;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p, int i) {
    return __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  static __device__ __forceinline__ void unpack(const R& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};
template <> struct Chan<float, 1> {  // eight scalars
  typedef float R;
  static constexpr int L = 8;
  static __device__ __forceinline__ R load(const float* p, int i) { return __ldg(p + i); }
  static __device__ __forceinline__ void unpack(const R& r, float* f) { f[0] = r; }
};
template <> struct Chan<__nv_bfloat16, 1> {
  typedef unsigned short R;
  static constexpr int L = 8;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p, int i) {
    return __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  }
  static __device__ __forceinline__ void unpack(const R& r, float* f) {
    f[0] = __uint_as_float((uint32_t)r << 16);
  }
};

// max(v, 1e-6)^p as 2^(p log2 v) on the special function unit; v >= 1e-6 and
// the result is never subnormal for p <= 6, so flushing subnormals changes
// nothing. A NaN stays NaN (fmaxf alone would return 1e-6 for it), as
// torch.clamp and jnp.clip pass it through; lg2 and ex2 carry it into the sum
__device__ __forceinline__ float gem_term(float v, float p) {
  float l, e;
  const float c = v != v ? v : fmaxf(v, GEM_EPS);
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(c));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(p * l));
  return e;
}

// In-CTA sum of one value a thread, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NT / 32; ++k) s += red[k];
  return s;
}

// x and out rows are `ld` channels apart; chunk blockIdx.z covers channels
// [z CW, min(ld, (z + 1) CW)). With one chunk (CW = ld = C) the row is
// normalized here; with several each chunk writes its pooled values.
template <typename T, int VEC>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
gem_l2n_kernel(const T* __restrict__ x, const float* __restrict__ p_ptr,
               const int32_t* __restrict__ sizes,  // null: unmasked
               float* __restrict__ out, int N, int W, int CW, int ld) {
  typedef Chan<T, VEC> Ch;
  constexpr int E = CPT / Ch::L;  // channels a raw load
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int cz = (int)blockIdx.z * CW;
  const int C = min(CW, ld - cz);  // this chunk's channels
  x += cz;
  out += cz;
  const int GT = (C + CPT - 1) / CPT;  // threads across the channels
  const int RL = NT / GT;              // row lanes
  const int lr = threadIdx.x / GT;
  const int c0 = (threadIdx.x - lr * GT) * CPT;  // this thread's first channel
  const int slice = (C + CS - 1) / CS;           // channels this CTA finishes
  extern __shared__ float smem[];
  float* part = smem;                 // [RL][C]: row-lane sums, then the CTA's in row 0
  float* pool = part + RL * C;        // [slice]
  float* red = pool + slice;          // [NT / 32]
  float* share = red + NT / 32;       // [2]: this CTA's share of sum pooled^2, the scale

  const float p = p_ptr[0];
  int h = N, w = 1;
  if (sizes != nullptr) {
    h = sizes[2 * b];
    w = sizes[2 * b + 1];
  }
  const float denom = (float)max(h * w, 1);
  const int hc = max(0, min(h, N / W));
  const int wc = max(0, min(w, W));
  const int P = hc * wc;

  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;
  if (lr < RL) {
    const int workers = CS * RL;
    const int run = (P + workers - 1) / workers;
    int pos = (rank * RL + lr) * run;
    const int end = min(P, pos + run);
    if (pos < end) {
      int r = pos / wc;
      int col = pos - r * wc;
      const int nch = min(CPT, C - c0);  // < CPT only in the scalar tail
      const T* xb = x + (size_t)b * N * ld + c0;
      for (; pos < end; pos += U) {
        typename Ch::R raw[U][Ch::L];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (pos + u < end) {
            const T* xr = xb + (size_t)(r * W + col) * ld;
#pragma unroll
            for (int i = 0; i < Ch::L; ++i) {
              if (i * E < nch) raw[u][i] = Ch::load(xr, i);
            }
          }
          if (++col == wc) {
            col = 0;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (pos + u < end) {
#pragma unroll
            for (int i = 0; i < Ch::L; ++i) {
              if (i * E < nch) {
                float f[E];
                Ch::unpack(raw[u][i], f);
#pragma unroll
                for (int e = 0; e < E; ++e) acc[i * E + e] += gem_term(f[e], p);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      if (c0 + e < C) part[lr * C + c0 + e] = acc[e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {  // this CTA's sums, row lanes in order
    float s = part[c];
    for (int l = 1; l < RL; ++l) s += part[l * C + c];
    part[c] = s;
  }
  cluster.sync();

  // channel slice `rank`: the eight CTAs' sums in rank order, then 1/p
  const int s0 = rank * slice;
  const int s1 = min(C, s0 + slice);
  const float inv_p = 1.0f / p;
  float sq = 0.f;
  for (int c = s0 + threadIdx.x; c < s1; c += NT) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CS; ++k) s += cluster.map_shared_rank(part, k)[c];
    const float pooled = powf(s / denom, inv_p);
    pool[c - s0] = pooled;
    sq += pooled * pooled;
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) share[0] = sq;
  cluster.sync();

  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < CS; ++k) total += cluster.map_shared_rank(share, k)[0];
    share[1] = gridDim.z == 1 ? 1.0f / (sqrtf(total) + L2N_EPS) : 1.0f;
  }
  __syncthreads();
  const float scale = share[1];
  for (int c = s0 + threadIdx.x; c < s1; c += NT) out[(size_t)b * ld + c] = pool[c - s0] * scale;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// The L2N of chunked rows: one CTA an image, sum pooled^2 in a fixed order.
__global__ void __launch_bounds__(NT) gem_l2n_finish(float* __restrict__ out, int C) {
  __shared__ float red[NT / 32];
  float* o = out + (size_t)blockIdx.x * C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) sq += o[c] * o[c];
  const float scale = 1.0f / (sqrtf(block_sum(sq, red)) + L2N_EPS);
  for (int c = threadIdx.x; c < C; c += NT) o[c] *= scale;
}

// dynamic shared memory: part [RL][C], pool [slice], red [NT / 32], share [2]
static int smem_bytes(int C) {
  const int RL = NT / ((C + CPT - 1) / CPT);
  return (RL * C + (C + CS - 1) / CS + NT / 32 + 2) * (int)sizeof(float);
}

// channels a chunk: C itself up to MAX_C, else equal chunks, a multiple of 8
static int chunk_width(int C) {
  if (C <= MAX_C) return C;
  const int n = (C + MAX_C - 1) / MAX_C;
  return ((C + n - 1) / n + 7) / 8 * 8;
}

// shared memory for chunks of CW channels, the last one narrower
static int chunked_smem_bytes(int C, int CW) {
  const int last = C - (C - 1) / CW * CW;
  return max(smem_bytes(CW), smem_bytes(last));
}

template <typename T, int VEC>
static int max_clusters(int C, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = chunked_smem_bytes(C, chunk_width(C));
  return (int)cudaOccupancyMaxActiveClusters(out, gem_l2n_kernel<T, VEC>, &cfg);
}

#define MAX_GRID_Y 65535

template <typename T, int VEC>
static int launch(const void* x, const void* p, const void* sizes, void* out, int B, int N,
                  int W, int C, cudaStream_t stream) {
  const int CW = chunk_width(C);
  const int chunks = (C + CW - 1) / CW;
  const int smem = chunked_smem_bytes(C, CW);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = min(MAX_GRID_Y, B - b0);
    float* o = (float*)out + (size_t)b0 * C;
    gem_l2n_kernel<T, VEC><<<dim3(CS, nb, chunks), NT, smem, stream>>>(
        (const T*)x + (size_t)b0 * N * C, (const float*)p,
        sizes ? (const int32_t*)sizes + 2 * (size_t)b0 : nullptr, o, N, W, CW, C);
    if (chunks > 1) gem_l2n_finish<<<nb, NT, 0, stream>>>(o, C);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

extern "C" {

// x: [B, N, C] (f32 if is_bf16 == 0, else bf16), p: [1] f32 on device,
// sizes: [B, 2] int32 (h, w) of an [N / W, W] map, or null for the unmasked
// mean over N (W = 1), out: [B, C] f32. Any B and C.
int gem_l2n_forward(const void* x, const void* p, const void* sizes, void* out, int B, int N,
                    int W, int C, int is_bf16, void* stream) {
  if (B < 1 || N < 1 || W < 1 || N % W != 0 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x & 15) == 0;
  if (is_bf16) {
    if (aligned && C % 8 == 0) return launch<__nv_bfloat16, 8>(x, p, sizes, out, B, N, W, C, s);
    return launch<__nv_bfloat16, 1>(x, p, sizes, out, B, N, W, C, s);
  }
  if (aligned && C % 4 == 0) return launch<float, 4>(x, p, sizes, out, B, N, W, C, s);
  return launch<float, 1>(x, p, sizes, out, B, N, W, C, s);
}

// The launch plan for an aligned map of C channels, for the record:
// out[0..7] = CTAs a cluster (one image and chunk), threads a CTA, threads
// across a chunk's channels, row lanes, channels each CTA finishes, how many
// clusters the card holds at once (CUDA's occupancy query; clusters past
// that wait), the chunks of channels (1 up to MAX_C; more add the
// gem_l2n_finish launch) and the channels a chunk.
int gem_l2n_plan(int C, int is_bf16, int* out) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const int CW = chunk_width(C);
  out[0] = CS;
  out[1] = NT;
  out[2] = (CW + CPT - 1) / CPT;
  out[3] = NT / out[2];
  out[4] = (CW + CS - 1) / CS;
  out[6] = (C + CW - 1) / CW;
  out[7] = CW;
  if (is_bf16) {
    return C % 8 == 0 ? max_clusters<__nv_bfloat16, 8>(C, out + 5)
                      : max_clusters<__nv_bfloat16, 1>(C, out + 5);
  }
  return C % 4 == 0 ? max_clusters<float, 4>(C, out + 5) : max_clusters<float, 1>(C, out + 5);
}

}  // extern "C"
