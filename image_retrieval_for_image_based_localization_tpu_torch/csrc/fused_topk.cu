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
// The small-batch form (topk_split_narrow), pass 1 for query tiles of 8,
// 16, 24 or 32 rows (the wrapper's plan, ops/kernels/fused_topk.py::_plan):
// at serving's one query 127 of the 128-row tile's rows were zero fill, at
// config 5's 20 queries 108, and their FMAs still ran. Its mainloop is
// csrc/narrow_tile.cuh (1,024-row gallery tiles streamed by TMA, every score
// the same fmaf chain as above, so the forms give the same bits). There a
// warp holds 128 rows of a tile against every query of the tile, so a
// query's scores lie in all eight consumer warps and the half-warp rule
// above does not hold. Selection stays within each warp and off the block's
// barriers all the same: the block keeps one sorted list a query in shared
// memory, and a warp merges its own candidates for query q (those that beat
// q's k-th entry) into q's list under a lock of that list, packed into its
// low lanes 32 at a time through warp_merge, or, when there are a few, one
// insertion each (after a split's first tile nearly every merge is so);
// warps that meet at a list wait for it alone, and a
// warp whose rows hold no candidate for q never takes q's lock. A warp
// reads q's k-th entry for its filter as one 64-bit word that the list's
// last writer stores, so the filter never sees half of an update; entries
// only improve, so a stale one filters less, never wrongly. Pass 2 is the
// same merge of the splits' lists.
//
// Each entry returns cudaGetLastError() after its launches.

#include <float.h>
#include <stdint.h>

#include "narrow_tile.cuh"
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

// (score, index) as one 64-bit word: the filter of the small-batch form
// reads a list's k-th entry in one load
__device__ __forceinline__ unsigned long long pack_entry(float v, int i) {
  return (unsigned long long)__float_as_uint(v) | ((unsigned long long)(unsigned)i << 32);
}

// Insert one candidate (v, i), which beats the list's k-th entry, into the
// sorted list (lv, li) of length k: the entries that beat it are a prefix,
// the rest move down one place. The whole warp calls it.
__device__ __forceinline__ void insert_one(float* lv, int* li, int k, float v, int i,
                                           int lane) {
  float tv[KMAX / 32];
  int ti[KMAX / 32];
  int pos = 0;
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int s = lane + 32 * r;
    tv[r] = s < k ? lv[s] : -FLT_MAX;
    ti[r] = s < k ? li[s] : INT32_MAX;
    pos += __popc(__ballot_sync(FULL, s < k && beats(tv[r], ti[r], v, i)));
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KMAX / 32; ++r) {
    const int s = lane + 32 * r;
    if (s >= pos && s + 1 < k) {
      lv[s + 1] = tv[r];
      li[s + 1] = ti[r];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = i;
  }
  __syncwarp();
}

#define FEW 8  // up to this many candidates are inserted one by one

// Merge a warp's candidates for one query into its list (lv, li) under the
// list's lock: lane l offers row g + 32 j with score v_j where bit j of
// `want` is set (want is 0 where the lane has none). Of the candidates that
// still beat the list's k-th entry, of all four rows, a few (at most FEW:
// the usual case once a split's first tile is in) are inserted one by one
// without a sort; more are packed into the low lanes 32 at a time (row by
// row, lane by lane), so warp_merge sorts only as many lanes as there are
// candidates. Then the list's k-th entry goes to *thr in one store. Not inlined:
// the caller unrolls its loop over the queries, and a copy of warp_merge a
// query and a row would make the kernel many times larger.
__device__ __noinline__ void merge_query(float* lv, int* li, int k, unsigned long long* thr,
                                         int* lock, float v0, float v1, float v2, float v3,
                                         int g, unsigned want, int lane) {
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
  }
  __syncwarp();
  __threadfence_block();
  const float kv = lv[k - 1];
  const int ki = li[k - 1];
  const float v[4] = {v0, v1, v2, v3};
  unsigned m[4];
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = __ballot_sync(FULL, ((want >> j) & 1u) && beats(v[j], g + 32 * j, kv, ki));
    n += __popc(m[j]);
  }
  // candidate c (0 <= c < n): its row j, the lane holding it, its score
  auto fetch = [&](int c, float& pv, int& pi) {
    int j = 0;
    while (c >= __popc(m[j])) c -= __popc(m[j++]);
    const int src = (int)__fns(m[j], 0, c + 1);
    const float s0 = __shfl_sync(FULL, v[0], src), s1 = __shfl_sync(FULL, v[1], src);
    const float s2 = __shfl_sync(FULL, v[2], src), s3 = __shfl_sync(FULL, v[3], src);
    pv = j == 0 ? s0 : j == 1 ? s1 : j == 2 ? s2 : s3;
    pi = g - lane + src + 32 * j;  // g is this lane's row of j = 0
  };
  if (n <= FEW) {  // one insertion each, while it still beats the k-th entry
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      float pv;
      int pi;
      fetch(c, pv, pi);
      if (beats(pv, pi, lv[k - 1], li[k - 1])) insert_one(lv, li, k, pv, pi, lane);
    }
  } else {  // lane l takes candidate b + l
#pragma unroll 1
    for (int b = 0; b < n; b += 32) {
      float pv;
      int pi;
      fetch(min(b + lane, n - 1), pv, pi);
      warp_merge(lv, li, k, pv, pi, b + lane < n, lane);
    }
  }
  if (lane == 0) {
    *reinterpret_cast<volatile unsigned long long*>(thr) = pack_entry(lv[k - 1], li[k - 1]);
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// Pass 1 of the small-batch form: the tiles of one split against a query
// tile of NQ rows, each query's running top-k in shared memory (see the
// header). Warps 0-7 compute and select, warpgroup 2 streams the gallery.
template <typename T, int NQ>
__global__ void __launch_bounds__(narrow::THREADS, 1)
topk_split_narrow(const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap mq,
                  const float* __restrict__ Q, const T* __restrict__ G,
                  float* __restrict__ part_v, int* __restrict__ part_i, int Nq, int Ng, int D,
                  int k, int tma) {
  extern __shared__ unsigned char dyn[];
  const narrow::Ring ring(dyn);
  float* lv = reinterpret_cast<float*>(ring.after());                    // [NQ][k]
  int* li = reinterpret_cast<int*>(lv + NQ * k);                          // [NQ][k]
  unsigned long long* thr = reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<uintptr_t>(li + NQ * k) + 7) & ~(uintptr_t)7);    // [NQ]: k-th entry
  int* lock = reinterpret_cast<int*>(thr + NQ);                           // [NQ]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * NQ;
  const int split = blockIdx.y;
  int r0, r1;
  narrow::split_rows(split, gridDim.y, Ng, r0, r1);
  const int g_end = min(Ng, r1);
  if (threadIdx.x == 0) ring.init(tma ? 1 : narrow::PRODUCERS);
  if (warp < narrow::WARPS) {
    for (int q = warp; q < NQ; q += narrow::WARPS) {
      init_list(lv + q * k, li + q * k, k, lane);
      if (lane == 0) {
        thr[q] = pack_entry(lv[q * k + k - 1], li[q * k + k - 1]);
        lock[q] = 0;
      }
    }
  }
  __syncthreads();
  if (warp >= narrow::WARPS) {
    narrow::regs_dealloc<narrow::PRODUCER_REGS>();
    narrow::produce<T, NQ>(tma, ring, &mg, &mq, Q, G, q0, r0, r1, Nq, Ng, D,
                           threadIdx.x - narrow::WARPS * 32);
    return;
  }
  narrow::regs_alloc<narrow::CONSUMER_REGS>();
  narrow::consume<T, NQ>(ring, r0, r1, D, warp, lane, [&](int g0, float(&acc)[narrow::ROWS][NQ]) {
    const int gw = g0 + narrow::tile_row(0, warp, lane);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q0 + q >= Nq) break;
      const unsigned long long th = *reinterpret_cast<volatile unsigned long long*>(thr + q);
      const float thv = __uint_as_float((unsigned)th);
      const int thi = (int)(th >> 32);
      unsigned want = 0;
#pragma unroll
      for (int j = 0; j < narrow::ROWS; ++j) {
        const int g = gw + j * 32;
        if (g < g_end && beats(acc[j][q], g, thv, thi)) want |= 1u << j;
      }
      if (!__any_sync(FULL, want != 0)) continue;
      merge_query(lv + q * k, li + q * k, k, thr + q, lock + q, acc[0][q], acc[1][q],
                  acc[2][q], acc[3][q], gw, want, lane);
    }
  });
  narrow::consumers_sync();
  for (int q = warp; q < NQ && q0 + q < Nq; q += narrow::WARPS) {
    const size_t base = ((size_t)(q0 + q) * gridDim.y + split) * k;
    for (int e = lane; e < k; e += 32) {
      part_v[base + e] = lv[q * k + e];
      part_i[base + e] = li[q * k + e];
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

// Dynamic shared memory of the small-batch pass 1: the ring, the lists,
// the k-th entries (8-byte aligned) and the locks.
static size_t narrow_smem_bytes(int nq, int k) {
  return narrow::RING_BYTES + (size_t)nq * k * 8 + 8 + (size_t)nq * 12;
}

template <typename T, int NQ>
static int narrow_launch(int n_splits, cudaStream_t s, const void* q, const void* g,
                         void* part_v, void* part_i, int Nq, int Ng, int D, int k) {
  const bool tma = narrow_host::tma_ok<T>(q, g, D);
  CUtensorMap mg, mq;
  if (!narrow_host::make_maps<T>(&mg, &mq, tma, q, g, Nq, Ng, D, NQ))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // set for the largest k
  const cudaError_t err = narrow_host::allow_smem(
      topk_split_narrow<T, NQ>, (int)narrow_smem_bytes(NQ, KMAX), smem_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = narrow_smem_bytes(NQ, k);
  const dim3 grid((Nq + NQ - 1) / NQ, n_splits);
  topk_split_narrow<T, NQ><<<grid, narrow::THREADS, smem, s>>>(
      mg, mq, (const float*)q, (const T*)g, (float*)part_v, (int*)part_i, Nq, Ng, D, k,
      (int)tma);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* g, void* part_v, void* part_i,
                  void* out_v, void* out_i, int Nq, int Ng, int D, int k,
                  int width, int n_splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (width) {
    case 8: err = narrow_launch<T, 8>(n_splits, s, q, g, part_v, part_i, Nq, Ng, D, k); break;
    case 16: err = narrow_launch<T, 16>(n_splits, s, q, g, part_v, part_i, Nq, Ng, D, k); break;
    case 24: err = narrow_launch<T, 24>(n_splits, s, q, g, part_v, part_i, Nq, Ng, D, k); break;
    case 32: err = narrow_launch<T, 32>(n_splits, s, q, g, part_v, part_i, Nq, Ng, D, k); break;
    default: {
      const dim3 grid((Nq + BM - 1) / BM, n_splits);
      const size_t smem = split_smem_bytes(k);
      err = sgemm::vec_ok<T>(q, g, D)
          ? split_launch<T, true>(grid, smem, s, q, g, part_v, part_i, Nq, Ng, D, k)
          : split_launch<T, false>(grid, smem, s, q, g, part_v, part_i, Nq, Ng, D, k);
    }
  }
  if (err != 0) return err;
  topk_merge_kernel<<<Nq, MERGE_WARPS * 32, 0, s>>>((const float*)part_v, (const int*)part_i,
                                                    (float*)out_v, (int*)out_i, n_splits, k);
  return (int)cudaGetLastError();
}

extern "C" {

// queries: [Nq, D] f32 (already rounded to the gallery dtype),
// gallery: [Ng, D] f32 (is_bf16 == 0) or bf16, 1 <= k <= min(128, Ng);
// width: the query tile, 128 (the 128 x 128 form, 1 <= n_splits <=
// ceil(Ng / 128)) or 8, 16, 24, 32 (the small-batch form, 1 <= n_splits <=
// ceil(Ng / 256)); part_v/part_i: [Nq, n_splits, k] scratch, out_v/out_i:
// [Nq, k].
int fused_topk_forward(const void* queries, const void* gallery, void* part_v,
                       void* part_i, void* out_v, void* out_i, int Nq, int Ng,
                       int D, int k, int width, int n_splits, int is_bf16, void* stream) {
  const bool narrow_w = width % 8 == 0 && width >= 8 && width <= narrow::MAX_NQ;
  const int rows = narrow_w ? narrow::BOX_ROWS : BN;  // a split's unit
  if (Nq < 1 || Ng < 1 || D < 1 || k < 1 || k > KMAX || k > Ng || n_splits < 1 ||
      n_splits > (Ng + rows - 1) / rows || !(width == BM || narrow_w)) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(queries, gallery, part_v, part_i, out_v, out_i,
                                 Nq, Ng, D, k, width, n_splits, stream);
  }
  return launch<float>(queries, gallery, part_v, part_i, out_v, out_i, Nq, Ng, D,
                       k, width, n_splits, stream);
}

}  // extern "C"
