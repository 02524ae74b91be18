// bf16 tensor-core GEMM mainloop for Hopper (sm_90a), device code only:
// warpgroup MMA (wgmma) with A in registers and B in shared memory, f32
// sums. csrc/bottleneck_bf16.cu runs its three convolutions on it.
//
//   C[m, n] = sum_k A[m, k] * B[k, n]   for one 128 x 64 output tile
//
// A is bf16, K-contiguous, fetched row by row through a caller's source (a
// plain row-major matrix, or the 3x3 conv's shifted taps), as in
// csrc/tf32x3_gemm.cuh. B comes transposed by the caller: [N, K] bf16,
// K-contiguous (wgmma's K-major B). K % BK == 0; ragged M and N are masked.
//
// Arithmetic: a product of two bf16 values is exact in f32, and the tensor
// core sums the products of one m64n64k16 step into an f32 accumulator.
// Its adds into the accumulator round toward zero (csrc/tf32x3_gemm.cuh),
// so each BK-deep stage sums into a fresh accumulator (two wgmma), which
// is then added to the running f32 sum in registers with an ordinary
// round-to-nearest add. The caller rounds the f32 result to bf16 in its
// epilogue; the result differs from an f32 convolution of the same bf16
// values by the order of the f32 sums only.
//
// Shape: csrc/tf32x3_gemm.cuh's, so the bottleneck's two forms share their
// grid (ops/kernels/bottleneck.py::_plan): 256 threads, two warpgroups,
// own a 128 x 64 tile; warpgroup w takes rows 64 w .. 64 w + 63 as
// m64n64k16 products, A from registers, B from shared memory. A stage is
// 32 deep (64 bytes a row), so it never crosses a 3x3 tap at Cm % 32 == 0.
// A ring of STAGES shared-memory slots is filled by 16-byte cp.async with
// zero-fill (out-of-range rows, columns and conv taps read nothing and land
// as 0), one barrier a stage: A in rows padded to 40 bf16 (each thread reads
// its fragments as 32-bit pairs, conflict-free), B in the 128-byte-swizzled
// K-major layout wgmma reads, of which a stage fills the first 64 bytes of
// each row (the two 32-byte k-steps sit where they sit in a tf32 tile, so
// the descriptor is csrc/tf32x3_gemm.cuh's b_desc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3_gemm.cuh"

namespace bf16mm {

constexpr int BM = 128;        // output rows (pixels) per tile
constexpr int BN = 64;         // output columns (channels) per tile
constexpr int BK = 32;         // depth of a stage in bf16: two k16 steps
constexpr int NT = 256;        // threads per block: two warpgroups
constexpr int STAGES = 4;
constexpr int ACC = BN / 2;    // sums a thread
constexpr int LDA = BK + 8;    // A's shared row pitch in bf16 (80 bytes, 20 words)
constexpr int A_BYTES = BM * LDA * 2;                  // 10,240: a multiple of 1,024
constexpr int B_BYTES = BN * 128;                      // 128-byte rows, half filled
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack: 74,752
static_assert(A_BYTES % 1024 == 0, "B tiles must stay 1,024-aligned");
static_assert(BM == tf32x3::BM && BN == tf32x3::BN && NT == tf32x3::NT,
              "the epilogue walks tiles with tf32x3::for_each_pair");

// A's cp.async chunks: thread t moves 16 bytes (8 bf16) of tile rows
// t / 4 + 64 i (i = 0, 1) at depth (t % 4) * 8 of each stage
__device__ __forceinline__ int a_row(int i) { return threadIdx.x / 4 + 64 * i; }
__device__ __forceinline__ int a_col() { return (threadIdx.x % 4) * 8; }

__device__ __forceinline__ void cp16(void* dst, const __nv_bfloat16* src, bool valid) {
  tf32x3::cp16(dst, reinterpret_cast<const float*>(src), valid);
}

// d (+)= a . B for one m64n64k16 bf16 product of the warpgroup: a from
// registers (four 32-bit pairs, mma.m16n8k16's A layout within each warp),
// B K-major from shared memory (descriptor); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// One 128 x 64 tile at (m0, n0) into acc (this thread's 32 sums, in wgmma's
// accumulator layout; see tf32x3::for_each_pair). asrc.src(i, k0, valid)
// returns the global address of this thread's A chunk of row slot i (tile
// row a_row(i)) at depth k0 + a_col(), and sets valid (false: zeros). b: B
// as [N, K] bf16. smem holds SMEM_BYTES. A rows and B rows must be 16-byte
// aligned (K % 8 == 0).
template <class ASrc>
__device__ __forceinline__ void gemm_tile(const ASrc& asrc, const __nv_bfloat16* __restrict__ b,
                                          int N, int K, int n0, char* smem_raw,
                                          float (&acc)[ACC]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int KT = K / BK;
  // B tiles need 1,024-byte alignment for the swizzle
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  auto load = [&](int s, int kt) {
    const int k0 = kt * BK;
    char* st = smem + s * STAGE_BYTES;
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(st);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool v;
      const __nv_bfloat16* p = asrc.src(i, k0, v);
      cp16(as + a_row(i) * LDA + a_col(), p, v);
    }
    // B: row r (output column n0 + r), 16-byte chunk c of the stage's 64
    // bytes, stored at chunk c ^ (r % 8) of the row's 128
    const int r = tid / 4, c = tid % 4;
    const bool v = n0 + r < N;
    const size_t off = (size_t)(v ? n0 + r : 0) * K + k0 + c * 8;
    cp16(st + A_BYTES + r * 128 + ((c ^ (r & 7)) << 4), b + off, v);
  };

#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    tf32x3::cp_commit();
  }
  // this thread's A fragment rows: warpgroup warp / 4 takes tile rows
  // 64 (warp / 4) .. + 63, its warp warp % 4 rows 16 (warp % 4) + g, + 8
  const int arow = (warp / 4) * 64 + (warp % 4) * 16 + g;
  for (int kt = 0; kt < KT; ++kt) {
    tf32x3::cp_wait<STAGES - 2>();
    tf32x3::fence_async_shared();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for refill
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(nk % STAGES, nk);
      tf32x3::cp_commit();
    }
    const char* st = smem + (kt % STAGES) * STAGE_BYTES;
    // 32-bit pairs: word 8 kk + t is depth 16 kk + 2 t, + 1
    const uint32_t* ar = reinterpret_cast<const uint32_t*>(st) + arow * (LDA / 2) + t;
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      a[kk][0] = ar[kk * 8];                     // row g,     depth 16 kk + 2 t
      a[kk][1] = ar[8 * (LDA / 2) + kk * 8];     // row g + 8
      a[kk][2] = ar[kk * 8 + 4];                 // row g,     depth 16 kk + 8 + 2 t
      a[kk][3] = ar[8 * (LDA / 2) + kk * 8 + 4];  // row g + 8
    }
    const uint64_t desc = tf32x3::b_desc(st + A_BYTES);
    float part[ACC];
    tf32x3::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // 16 deep a product: 32 bytes on in the swizzled row
      wgmma_n64(part, a[kk], desc + 2 * kk, kk > 0);
    }
    tf32x3::wgmma_commit();
    tf32x3::wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] += part[e];
  }
  tf32x3::cp_wait<0>();
}

}  // namespace bf16mm
