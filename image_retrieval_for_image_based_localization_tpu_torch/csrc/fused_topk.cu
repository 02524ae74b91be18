// Exact top-k search with the score matrix never written, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// ops/pallas/fused_topk.py::fused_topk_search (_kernel, with its bitonic
// selection network _sort_block_asc/_merge_desc).
//
//   scores[q, g] = sum_d Q[q, d] * G[g, d]   (f32 FMA, no TF32)
//   out = the k best (score, index) pairs per query under the strict order
//         (higher score, then lower index), sorted best first.
//
// Bound on this card: operations. At the benchmark shape (256 queries,
// 100k x 2048 gallery) the product is 1.05e11 flop (1.57 ms at 67 TFLOP/s
// f32) against 0.82 GB of gallery bytes. The scores are f32 FMA chains,
// which run on the CUDA cores (no tensor-core path computes an exact f32
// product).
//
// Design:
//   pass 1, grid (query tiles of 128, gallery splits), one block an SM: a
//     block owns a query tile and a contiguous split of whole 128-row
//     gallery tiles, and keeps each query's running top-k sorted in shared
//     memory. Its 512 threads are two groups of 256 that run the mainloop
//     of csrc/sgemm_tile.cuh (8 x 8 registers a thread, 16-byte loads,
//     double-buffered, every score one sequential fmaf chain over d, so
//     duplicate rows tie bit for bit and the scores equal
//     csrc/score_topk.cu's) on alternate tiles, each with its own stages and
//     named barrier, and take turns merging a finished tile into the lists:
//     while one group selects, the other computes, so the FMA units stay
//     fed by 16 warps most of the time and by 8 while a group selects.
//     Selection stays within each warp and off the block's barriers: row r
//     of a tile lives in the registers of one half-warp, so each warp keeps
//     the lists of its 16 rows. A score leaves the registers only if it
//     beats its row's k-th entry (read once a round from shared memory); a
//     prefix sum over the half-warp packs those into the row's 32-slot
//     buffer with no atomics, and the warp merges each buffer into its list
//     as one batch (warp_merge: a bitonic sort over the lanes and two binary
//     searches). A score that finds no slot stays pending and is offered
//     again against the new k-th entry: the first tile of a split takes four
//     such rounds, later tiles about one. Each block writes its split's
//     lists to scratch.
//   pass 2, one block of 8 warps per query: warp w merges the lists of
//     splits w, w + 8, ..., then warp 0 merges the other seven. A list is
//     sorted, so once a run of 32 of its entries has none that beats the
//     running k-th entry, the rest of it is skipped.
// The top-k of a set under a strict total order is unique, so neither the
// split of the gallery nor the order in which candidates arrive changes a
// result. Lists start as (NEG_INF, INT32_MAX - 128 + slot) sentinels as in
// the TPU kernel, and gallery rows past the split are never candidates.
//
// What held the previous kernel back, and what this design does about it:
// scalar shared reads (8 loads for 16 FMAs) -> float4 reads, 64 FMAs for 4;
// scalar transposed staging, no prefetch, two barriers a step -> 16-byte
// loads double-buffered, one barrier; the 32 x 2048 query tile restaged
// for every 64 rows (256 KB of Q a 512 KB of G) -> 128 x 128 tiles (equal Q
// and G traffic, from L2); all GEMM work stopped while the warps scanned
// every score -> a register compare, and the other group computes while
// one selects. Left: the lists of 128 queries (k x 8 bytes each) hold the
// block to one an SM, so the FMA units see 16 warps only while neither
// group selects; the first tiles of every split send all their scores
// through the merge.
//
// Shared memory (dynamic): two groups' stages (2 x 16,896 bytes), the lists
// (128 x k x 8 bytes), the candidate buffers (32,768 bytes) and 128 counts:
// 198,144 bytes at k = 128. Registers (nvcc -Xptxas -v, kept in the build
// log): 127-128 a thread under the cap of __launch_bounds__(512, 1), no
// spills; pass 2 48.
//
// Each entry returns cudaGetLastError() after its launches.

#include <float.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

#define KMAX 128       // largest k
#define CAP 32         // candidate slots per query row
#define FULL 0xffffffffu

using sgemm::BM;
using sgemm::BN;
using sgemm::NT;

__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Merge up to 32 candidates, one per lane (want == false: none), into the
// sorted list (lv, li) of length k held in shared memory. The whole warp
// calls it. Candidates are real gallery rows, none already in the list.
// Those that beat the list's k-th entry are sorted best first by a bitonic
// network over the lanes (over the smallest power of two of lanes that
// holds them all); each candidate's new place is its lane plus the
// number of list entries that beat it (binary search in shared memory), and
// each list entry's is its slot plus the number of candidates that beat it
// (binary search over the lanes). One pass over the list for a whole batch,
// where inserting one at a time would shift the list once per candidate.
__device__ __forceinline__ void warp_merge(float* lv, int* li, int k, float v, int i,
                                           bool want, int lane) {
  want = want && beats(v, i, lv[k - 1], li[k - 1]);
  const unsigned m = __ballot_sync(FULL, want);
  if (!m) return;
  if (!want) {  // loses to every list entry, sentinels included
    v = -FLT_MAX;
    i = INT32_MAX;
  }
  // every candidate sits in lanes 0 .. top-1 (callers pack them low), so
  // runs of the smallest power of two >= top sort them all
  const int top = 32 - __clz(m);
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    if (size / 2 >= top) break;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, stride);
      const int oi = __shfl_xor_sync(FULL, i, stride);
      const bool best_low = (lane & size) == 0;  // this run sorts best first
      const bool low = (lane & stride) == 0;
      const bool ob = beats(ov, oi, v, i);
      if (low == best_low ? ob : !ob) {
        v = ov;
        i = oi;
      }
    }
  }
  // list entries that beat this lane's candidate
  int rc = 0;
#pragma unroll
  for (int b = 64; b > 0; b >>= 1) {
    const int p = rc + b - 1;
    if (p < k && beats(lv[p], li[p], v, i)) rc += b;
  }
  float tv[KMAX / 32];
  int ti[KMAX / 32], np[KMAX / 32];
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int s = lane + 32 * r;
    tv[r] = s < k ? lv[s] : -FLT_MAX;
    ti[r] = s < k ? li[s] : INT32_MAX;
    // candidates (sorted over the lanes) that beat list entry s
    int c = beats(__shfl_sync(FULL, v, 31), __shfl_sync(FULL, i, 31), tv[r], ti[r]) ? 32 : 0;
#pragma unroll
    for (int b = 16; b > 0; b >>= 1) {
      const int p = (c + b - 1) & 31;
      const float pv = __shfl_sync(FULL, v, p);
      const int pi = __shfl_sync(FULL, i, p);
      if (c < 32 && beats(pv, pi, tv[r], ti[r])) c += b;
    }
    np[r] = s + c;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int s = lane + 32 * r;
    if (s < k && np[r] < k) {
      lv[np[r]] = tv[r];
      li[np[r]] = ti[r];
    }
  }
  if (i != INT32_MAX && lane + rc < k) {
    lv[lane + rc] = v;
    li[lane + rc] = i;
  }
  __syncwarp();
}

__device__ __forceinline__ void init_list(float* lv, int* li, int k, int lane) {
  for (int s = lane; s < k; s += 32) {
    lv[s] = -FLT_MAX;
    li[s] = INT32_MAX - KMAX + s;
  }
  __syncwarp();
}

#define GROUPS 2                     // mainloop groups of pass 1
#define SPLIT_THREADS (GROUPS * NT)
#define BAR_DONE0 3                  // named barriers (0 is __syncthreads, 1-2 the
#define BAR_DONE1 4                  // groups' mainloops): group g finished a selection

// Dynamic shared memory of pass 1 for k, in bytes: each group's mainloop
// stages, the lists, the candidate buffers and their counts.
static size_t split_smem_bytes(int k) {
  return GROUPS * sizeof(sgemm::Smem) + (size_t)BM * k * 8 + (size_t)BM * CAP * 8 +
         (size_t)BM * 4;
}

// Gallery tiles [t0, t1) of split s of n: a balanced partition of whole tiles
// (ops/kernels/fused_topk.py::_split_rows is the same formula).
__device__ __forceinline__ void split_tiles(int s, int n, int g_tiles, int& t0, int& t1) {
  t0 = (int)((long long)s * g_tiles / n);
  t1 = (int)((long long)(s + 1) * g_tiles / n);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(SPLIT_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();  // this thread's list writes before the hand-over
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(SPLIT_THREADS) : "memory");
}

// Merge one tile's register scores into the lists, within each warp. Row r
// of the tile lives in one half-warp (ty = (r % 64) / 4, register row
// i = 4 (r / 64) + r % 4), so warp w of a group holds rows 8w .. 8w+7 and
// 64+8w .. 64+8w+7. The scores that beat a row's k-th entry are packed into
// the row's buffer (a prefix sum over the half-warp gives each its slot),
// then the warp merges its 16 rows' buffers one row at a time; scores that
// found no slot are offered again against the new k-th entries.
__device__ __forceinline__ void select_tile(const float (&acc)[8][8], float* lv, int* li,
                                            float* cv, int* ci, int* cnt, int k, int q0, int g0,
                                            int g_end, int Nq, int warp, int lane, int ty,
                                            int tx) {
  uint64_t pend = 0;  // bit 8 i + j: score (i, j) still to be offered
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = sgemm::tile_row(i, ty);
    if (q0 + r >= Nq) continue;
    const float thv = lv[r * k + k - 1];
    const int thi = li[r * k + k - 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = g0 + sgemm::tile_col(j, tx);
      if (g < g_end && beats(acc[i][j], g, thv, thi)) pend |= 1ull << (8 * i + j);
    }
  }
  while (__any_sync(FULL, pend != 0)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = sgemm::tile_row(i, ty);
      const unsigned m = (unsigned)(pend >> (8 * i)) & 0xffu;
      const int c = __popc(m);
      int s = c;  // inclusive prefix sum over the half-warp
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const int u = __shfl_up_sync(FULL, s, o, 16);
        if ((lane & 15) >= o) s += u;
      }
      int slot = s - c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if ((m >> j) & 1u) {
          if (slot < CAP) {  // else it stays pending for the next round
            cv[r * CAP + slot] = acc[i][j];
            ci[r * CAP + slot] = g0 + sgemm::tile_col(j, tx);
            pend &= ~(1ull << (8 * i + j));
          }
          ++slot;
        }
      }
      if ((lane & 15) == 15) cnt[r] = min(s, CAP);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = sgemm::tile_row(rr >> 1, 2 * warp + (rr & 1));
      const int n = cnt[r];
      const bool ok = lane < n;
      warp_merge(lv + r * k, li + r * k, k, ok ? cv[r * CAP + lane] : -FLT_MAX,
                 ok ? ci[r * CAP + lane] : INT32_MAX, ok, lane);
    }
    if (pend == 0) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!((pend >> (8 * i)) & 0xffull)) continue;
      const int r = sgemm::tile_row(i, ty);
      const float thv = lv[r * k + k - 1];
      const int thi = li[r * k + k - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!beats(acc[i][j], g0 + sgemm::tile_col(j, tx), thv, thi))
          pend &= ~(1ull << (8 * i + j));
    }
  }
}

// Pass 1. Two groups of 256 threads run the mainloop (csrc/sgemm_tile.cuh)
// on alternate gallery tiles of the split, each with its own stages and
// barrier, and take turns merging their tiles into the shared lists: while
// one group selects, the other computes.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
topk_split_kernel(const float* __restrict__ Q, const T* __restrict__ G,
                  float* __restrict__ part_v, int* __restrict__ part_i, int Nq,
                  int Ng, int D, int k) {
  extern __shared__ __align__(16) unsigned char dyn[];
  sgemm::Smem* stages = reinterpret_cast<sgemm::Smem*>(dyn);                   // [GROUPS]
  float* lv = reinterpret_cast<float*>(dyn + GROUPS * sizeof(sgemm::Smem));  // [BM][k]
  int* li = reinterpret_cast<int*>(lv + BM * k);                              // [BM][k]
  float* cv = reinterpret_cast<float*>(li + BM * k);                          // [BM][CAP]
  int* ci = reinterpret_cast<int*>(cv + BM * CAP);                            // [BM][CAP]
  int* cnt = ci + BM * CAP;                                                   // [BM]

  const int grp = threadIdx.x / NT;
  const int tid = threadIdx.x % NT;  // thread of the group
  const int lane = tid & 31;
  const int warp = tid >> 5;         // warp of the group
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  int t0, t1;
  split_tiles(split, gridDim.y, (Ng + BN - 1) / BN, t0, t1);
  const int g_end = min(Ng, t1 * BN);

  if (grp == 0) {
#pragma unroll 1
    for (int rr = 0; rr < 16; ++rr) {
      const int r = sgemm::tile_row(rr >> 1, 2 * warp + (rr & 1));
      init_list(lv + r * k, li + r * k, k, lane);
    }
  }
  __syncthreads();

  // group g takes tiles t0 + g, t0 + g + 2, ...; group 0 selects first, and
  // each group's j-th selection waits for the other's previous one
  const int n0 = (t1 - t0 + 1) / 2, n1 = (t1 - t0) / 2;
  const int mine = grp ? n1 : n0, other = grp ? n0 : n1;
  const int bar = 1 + grp;
  if (mine > 0) {
    sgemm::Smem& sm = stages[grp];
    sgemm::Stager<T, VEC> st;
    int stage = 0;
    st.load(Q, G, q0, (t0 + grp) * BN, 0, Nq, Ng, D, tid);
    st.store(sm, stage, tid);
    sgemm::sync_mainloop(bar);
    float acc[8][8];
    for (int j = 0; j < mine; ++j) {
      const int g0 = (t0 + grp + 2 * j) * BN;
      const int next = j + 1 < mine ? g0 + 2 * BN : -1;
      sgemm::gemm_tile<T, VEC>(bar, acc, st, sm, stage, Q, G, q0, g0, next, Nq, Ng, D, tid,
                               ty, tx);
      if (grp == 1 || j > 0) bar_sync(grp ? BAR_DONE0 : BAR_DONE1);
      select_tile(acc, lv, li, cv, ci, cnt, k, q0, g0, g_end, Nq, warp, lane, ty, tx);
      if (grp == 0 ? j < other : j + 1 < other) bar_arrive(grp ? BAR_DONE1 : BAR_DONE0);
      if (next >= 0) sgemm::stage_next<T, VEC>(bar, st, sm, stage, tid);
    }
  }
  __syncthreads();

  // every warp of the block writes 8 rows' lists
  const int n_splits = gridDim.y;
  const int wb = threadIdx.x >> 5;
  for (int r = wb * (BM / (SPLIT_THREADS / 32)); r < (wb + 1) * (BM / (SPLIT_THREADS / 32)); ++r) {
    if (q0 + r >= Nq) break;
    const size_t base = ((size_t)(q0 + r) * n_splits + split) * k;
    for (int e = lane; e < k; e += 32) {
      part_v[base + e] = lv[r * k + e];
      part_i[base + e] = li[r * k + e];
    }
  }
}

// Merge the sorted list (sv, si) of length k, best first, into the running
// list (lv, li). A split with fewer than k rows left sentinels, which are
// never results. Once no entry of a run of 32 beats the running k-th entry,
// no later entry does, and the rest of the list is skipped.
__device__ __forceinline__ void merge_sorted(float* lv, int* li, int k, const float* sv,
                                             const int* si, int lane) {
  for (int e0 = 0; e0 < k; e0 += 32) {
    const int e = e0 + lane;
    const float v = e < k ? sv[e] : -FLT_MAX;
    const int i = e < k ? si[e] : INT32_MAX;
    if (!__any_sync(FULL, e < k && beats(v, i, lv[k - 1], li[k - 1]))) break;
    warp_merge(lv, li, k, v, i, e < k && i < INT32_MAX - KMAX, lane);
  }
}

#define MERGE_WARPS 8

// Pass 2, one block per query: warp w merges splits w, w + 8, ... into its
// own list, then warp 0 merges the other seven lists into its own.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int n_splits, int k) {
  __shared__ float lv[MERGE_WARPS][KMAX];
  __shared__ int li[MERGE_WARPS][KMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t q = blockIdx.x;
  init_list(lv[warp], li[warp], k, lane);
  for (int sp = warp; sp < n_splits; sp += MERGE_WARPS) {
    const size_t base = (q * n_splits + sp) * k;
    merge_sorted(lv[warp], li[warp], k, part_v + base, part_i + base, lane);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < MERGE_WARPS; ++w) merge_sorted(lv[0], li[0], k, lv[w], li[w], lane);
  for (int s = lane; s < k; s += 32) {
    out_v[q * k + s] = lv[0][s];
    out_i[q * k + s] = li[0][s];
  }
}

template <typename T, bool VEC>
static int split_launch(dim3 grid, size_t smem, cudaStream_t s, const void* q, const void* g,
                        void* part_v, void* part_i, int Nq, int Ng, int D, int k) {
  cudaError_t err = cudaFuncSetAttribute(topk_split_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_split_kernel<T, VEC><<<grid, SPLIT_THREADS, smem, s>>>((const float*)q, (const T*)g,
                                                   (float*)part_v, (int*)part_i, Nq, Ng, D, k);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* g, void* part_v, void* part_i,
                  void* out_v, void* out_i, int Nq, int Ng, int D, int k,
                  int n_splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((Nq + BM - 1) / BM, n_splits);
  const size_t smem = split_smem_bytes(k);
  const int err = sgemm::vec_ok<T>(q, g, D)
      ? split_launch<T, true>(grid, smem, s, q, g, part_v, part_i, Nq, Ng, D, k)
      : split_launch<T, false>(grid, smem, s, q, g, part_v, part_i, Nq, Ng, D, k);
  if (err != 0) return err;
  topk_merge_kernel<<<Nq, MERGE_WARPS * 32, 0, s>>>((const float*)part_v, (const int*)part_i,
                                                    (float*)out_v, (int*)out_i, n_splits, k);
  return (int)cudaGetLastError();
}

extern "C" {

// queries: [Nq, D] f32 (already rounded to the gallery dtype),
// gallery: [Ng, D] f32 (is_bf16 == 0) or bf16, 1 <= k <= min(128, Ng),
// 1 <= n_splits <= ceil(Ng / 128), part_v/part_i: [Nq, n_splits, k] scratch,
// out_v/out_i: [Nq, k].
int fused_topk_forward(const void* queries, const void* gallery, void* part_v,
                       void* part_i, void* out_v, void* out_i, int Nq, int Ng,
                       int D, int k, int n_splits, int is_bf16, void* stream) {
  if (Nq < 1 || Ng < 1 || D < 1 || k < 1 || k > KMAX || k > Ng || n_splits < 1 ||
      n_splits > (Ng + BN - 1) / BN) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(queries, gallery, part_v, part_i, out_v, out_i,
                                 Nq, Ng, D, k, n_splits, stream);
  }
  return launch<float>(queries, gallery, part_v, part_i, out_v, out_i, Nq, Ng, D,
                       k, n_splits, stream);
}

}  // extern "C"
