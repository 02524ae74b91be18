// 3xTF32 tensor-core GEMM mainloop for Hopper (sm_90a), device code only:
// warpgroup MMA (wgmma) with A in registers and B in shared memory.
// csrc/bottleneck.cu runs its three convolutions on it, csrc/netvlad.cu its
// two products (the aggregation on gemm_tile_at, below: A depth-major).
//
//   C[m, n] = sum_k A[m, k] * B[k, n]   for one 128 x 64 output tile
//
// A is f32, K-contiguous, fetched row by row through a caller's source (a
// plain row-major matrix, or the 3x3 conv's shifted taps). B comes split
// and transposed by the caller: hi and lo planes [N, K], K-contiguous,
// since wgmma takes TF32 operands only K-major. K % BK == 0; ragged M and N
// are masked.
//
// Arithmetic (the split rule): each f32 operand v is split as hi = tf32(v),
// lo = tf32(v - hi), tf32 rounding to nearest with ties away from zero at
// 10 mantissa bits (cvt.rna.tf32.f32's rule). v - hi is exact in f32 and
// |v - hi - lo| <= 2^-22 |v|. A product a * b is taken as three tensor-core
// products, the small terms first: lo_a hi_b + hi_a lo_b + hi_a hi_b; the
// dropped lo_a lo_b is below 2^-22 |a b|. Each tf32 x tf32 product is exact
// inside the tensor core, so every product is right to about 2^-21
// relative, f32-class. The tensor core adds into its f32 accumulator
// rounding toward zero, a bias that grows with the number of additions; so
// each BK-deep stage sums into a fresh accumulator (12 wgmma), which is then
// added to the running f32 sum in registers with an ordinary
// round-to-nearest add. That keeps resnet50's blocks within about 1e-6 of
// max|out| of f32 convolutions; one tensor-core accumulator over all of K
// (up to 9 x 512) misses 1e-5 at layers 3 and 4.
//
// Shape: 256 threads, two warpgroups, own a 128 x 64 tile; warpgroup w
// takes rows 64 w .. 64 w + 63 as m64n64k8 products, A from registers, B
// from shared memory. A ring of STAGES shared-memory slots is filled by
// 16-byte cp.async with zero-fill (out-of-range rows, columns and conv taps
// read nothing and land as 0), one barrier a stage: A in rows padded to 36
// floats (each thread reads its fragments, conflict-free, and splits them in
// registers), B's hi and lo tiles in the 128-byte-swizzled K-major layout
// wgmma reads. A stage's 12 products are issued together and waited for
// before the stage's sum is added, while the next stages' copies are in
// flight; two blocks share an SM, so one's wait is the other's compute.
// (128 x 128 tiles, one block an SM, measured slower: each block's pipeline
// fill and epilogue then stand alone.)

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BM = 128;        // output rows (pixels) per tile
constexpr int BN = 64;         // output columns (channels) per tile
constexpr int BK = 32;         // depth of a stage: one 128-byte swizzled row
constexpr int NT = 256;        // threads per block: two warpgroups
constexpr int STAGES = 3;
constexpr int ACC = BN / 2;    // sums a thread
constexpr int LDA = BK + 4;    // A's shared row pitch in floats
constexpr int A_BYTES = BM * LDA * 4;                   // 18,432: a multiple of 1,024
constexpr int B_BYTES = BN * BK * 4;                    // one plane
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack: 105,472

// A's cp.async chunks: thread t moves 16 bytes of tile rows t / 8 + 32 i
// (i = 0..3) at depth (t % 8) * 4 of each stage
__device__ __forceinline__ int a_row(int i) { return threadIdx.x / 8 + 32 * i; }
__device__ __forceinline__ int a_col() { return (threadIdx.x % 8) * 4; }

// tf32(v): cvt.rna.tf32.f32's rounding as bit arithmetic on a finite v, two
// instructions (the instruction itself compiles to four on sm_90a: it also
// guards NaN)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// 16 bytes global -> shared; nothing is read and zeros land where !valid
__device__ __forceinline__ void cp16(void* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's landed copies become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// descriptor of a K-major B tile in the 128-byte swizzle: rows of 128 bytes
// (32 floats of K), 8-row groups 1,024 bytes apart, 1,024-aligned
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (+)= a . B for one m64n64k8 TF32 product of the warpgroup: a from
// registers, B from shared memory (descriptor); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// One 128 x 64 tile at (m0, n0) into acc (this thread's 32 sums, in
// wgmma's accumulator layout; see for_each_pair). asrc.src(i, k0, valid)
// returns the global address of this thread's A chunk of row slot i (tile
// row a_row(i)) at depth k0 + a_col(), and sets valid (false: zeros). bhi,
// blo: B's split planes [N, K]. smem holds SMEM_BYTES. A rows and B rows
// must be 16-byte aligned (K % 4 == 0).
template <class ASrc>
__device__ __forceinline__ void gemm_tile(const ASrc& asrc, const float* __restrict__ bhi,
                                          const float* __restrict__ blo, int N, int K, int n0,
                                          char* smem_raw, float (&acc)[ACC]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int KT = K / BK;
  // B tiles need 1,024-byte alignment for the swizzle
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  auto load = [&](int s, int kt) {
    const int k0 = kt * BK;
    char* st = smem + s * STAGE_BYTES;
    float* as = reinterpret_cast<float*>(st);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool v;
      const float* p = asrc.src(i, k0, v);
      cp16(as + a_row(i) * LDA + a_col(), p, v);
    }
    // B: row r (output column n0 + r), 16-byte chunk c of its 128 bytes,
    // stored at chunk c ^ (r % 8)
    char* bs = st + A_BYTES;
#pragma unroll
    for (int j = 0; j < BN * 8 / NT; ++j) {
      const int e = tid + j * NT, r = e / 8, c = e % 8;
      const bool v = n0 + r < N;
      const size_t off = (size_t)(v ? n0 + r : 0) * K + k0 + c * 4;
      const int dst = r * 128 + ((c ^ (r & 7)) << 4);
      cp16(bs + dst, bhi + off, v);
      cp16(bs + B_BYTES + dst, blo + off, v);
    }
  };

#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  // this thread's A fragment rows: warpgroup warp / 4 takes tile rows
  // 64 (warp / 4) .. + 63, its warp warp % 4 rows 16 (warp % 4) + g, + 8
  const int arow = (warp / 4) * 64 + (warp % 4) * 16 + g;
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for refill
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(nk % STAGES, nk);
      cp_commit();
    }
    const char* st = smem + (kt % STAGES) * STAGE_BYTES;
    const float* ar = reinterpret_cast<const float*>(st) + arow * LDA + t;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split(ar[kk * 8], ah[kk][0], al[kk][0]);
      split(ar[8 * LDA + kk * 8], ah[kk][1], al[kk][1]);
      split(ar[kk * 8 + 4], ah[kk][2], al[kk][2]);
      split(ar[8 * LDA + kk * 8 + 4], ah[kk][3], al[kk][3]);
    }
    const uint64_t dhi = b_desc(st + A_BYTES), dlo = b_desc(st + A_BYTES + B_BYTES);
    float part[ACC];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 8 deep a product: 32 bytes on in the swizzled row
      wgmma_n64(part, al[kk], dhi + 2 * kk, kk > 0);
      wgmma_n64(part, ah[kk], dlo + 2 * kk, 1);
      wgmma_n64(part, ah[kk], dhi + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] += part[e];
  }
  cp_wait<0>();
}

// f(e, m, n) for each pair of sums acc[e], acc[e + 1] (e even), which are
// C[m, n] and C[m, n + 1], with m < M and even n < N (N % 8 == 0)
template <class F>
__device__ __forceinline__ void for_each_pair(int M, int N, int m0, int n0, F&& f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h, n = n0 + 8 * j + 2 * (lane % 4);
      if (m < M && n < N) f(4 * j + 2 * h, m, n);
    }
}


// ---- A transposed: gemm_tile_at ------------------------------------------
// The same product with A stored depth-major: A[m, k] at a[k, m], rows of
// the depth axis contiguous along m (csrc/netvlad.cu's aggregation: M =
// channels, depth = feature rows, so A is the feature map itself). TF32
// wgmma takes no shared-memory operand in that layout, so A stays the
// register operand: each stage is copied as BK depth rows x BM columns,
// 512 contiguous bytes a warp, into rows padded to AT_LD floats, and each
// thread reads its fragments down the columns. The pad of 8 floats puts
// the four t lanes of a fragment read 8 banks apart, beside the eight g
// lanes of one row: 32 distinct banks, no conflict. B is as in gemm_tile,
// with its own row pitch ldb (a plane's rows may be longer than K). The
// pipeline, the split and the per-stage accumulator are gemm_tile's.
constexpr int AT_LD = BM + 8;                            // A's shared row pitch in floats
constexpr int AT_BYTES = BK * AT_LD * 4;                 // 17,408: a multiple of 1,024
constexpr int AT_STAGE_BYTES = AT_BYTES + 2 * B_BYTES;
constexpr int AT_SMEM_BYTES = STAGES * AT_STAGE_BYTES + 1024;  // 102,400
static_assert(AT_BYTES % 1024 == 0, "B tiles must stay 1,024-aligned");
static_assert((AT_LD * 4) % 16 == 0 && AT_LD % 32 == 8, "cp.async rows, conflict-free reads");

// A's cp.async chunks: thread t moves 16 bytes of depth rows t / 32 + 8 i
// (i = 0..3) at columns (t % 32) * 4 .. + 3 of each stage
__device__ __forceinline__ int at_row(int i) { return threadIdx.x / 32 + 8 * i; }
__device__ __forceinline__ int at_col() { return (threadIdx.x % 32) * 4; }

// One 128 x 64 tile at (m0, n0) into acc, A depth-major. asrc.src(i, k0,
// valid) returns the global address of this thread's A chunk: depth k0 +
// at_row(i), columns m0 + at_col() .. + 3 (false: zeros land). bhi, blo:
// B's split planes, row n at bhi + n ldb, K-contiguous. K % BK == 0;
// ldb % 4 == 0 and 16-byte aligned planes.
template <class ASrc>
__device__ __forceinline__ void gemm_tile_at(const ASrc& asrc, const float* __restrict__ bhi,
                                             const float* __restrict__ blo, size_t ldb, int N,
                                             int K, int n0, char* smem_raw, float (&acc)[ACC]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int KT = K / BK;
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  auto load = [&](int s, int kt) {
    const int k0 = kt * BK;
    char* st = smem + s * AT_STAGE_BYTES;
    float* as = reinterpret_cast<float*>(st);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool v;
      const float* p = asrc.src(i, k0, v);
      cp16(as + at_row(i) * AT_LD + at_col(), p, v);
    }
    char* bs = st + AT_BYTES;
#pragma unroll
    for (int j = 0; j < BN * 8 / NT; ++j) {
      const int e = tid + j * NT, r = e / 8, c = e % 8;
      const bool v = n0 + r < N;
      const size_t off = (size_t)(v ? n0 + r : 0) * ldb + k0 + c * 4;
      const int dst = r * 128 + ((c ^ (r & 7)) << 4);
      cp16(bs + dst, bhi + off, v);
      cp16(bs + B_BYTES + dst, blo + off, v);
    }
  };

#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  // this thread's A fragment rows (columns of the stored stage), as in gemm_tile
  const int am = (warp / 4) * 64 + (warp % 4) * 16 + g;
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(nk % STAGES, nk);
      cp_commit();
    }
    const char* st = smem + (kt % STAGES) * AT_STAGE_BYTES;
    const float* ar = reinterpret_cast<const float*>(st) + t * AT_LD + am;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split(ar[kk * 8 * AT_LD], ah[kk][0], al[kk][0]);
      split(ar[kk * 8 * AT_LD + 8], ah[kk][1], al[kk][1]);
      split(ar[(kk * 8 + 4) * AT_LD], ah[kk][2], al[kk][2]);
      split(ar[(kk * 8 + 4) * AT_LD + 8], ah[kk][3], al[kk][3]);
    }
    const uint64_t dhi = b_desc(st + AT_BYTES), dlo = b_desc(st + AT_BYTES + B_BYTES);
    float part[ACC];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_n64(part, al[kk], dhi + 2 * kk, kk > 0);
      wgmma_n64(part, ah[kk], dlo + 2 * kk, 1);
      wgmma_n64(part, ah[kk], dhi + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] += part[e];
  }
  cp_wait<0>();
}

}  // namespace tf32x3
