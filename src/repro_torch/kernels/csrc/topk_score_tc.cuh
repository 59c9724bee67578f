// The bf16 core of topk_score for Hopper's tensor cores (wgmma fed by TMA,
// the top-k fused into the epilogue). Included by topk_score.cu, so both
// cores build into one library.
//
// Replaces topk_score_kernel (src/repro/kernels/topk_score/kernel.py:26)
// for bf16 queries and docs with D % 8 == 0, 16-byte aligned rows and
// k <= 32; the wrapper (kernels/topk_score/ops.py, _core) sends everything
// else to the CUDA-core kernel of topk_score.cu. The function is the same:
// scores = queries x docs^T accumulated in fp32 (bf16 products are exact),
// optionally rounded to bf16 (nearest even) before the masks, exclude[q]
// and mask[doc] drop a score, and each query keeps its k best by (score
// descending, doc id ascending), -inf / -1 past the eligible docs.
//
// What bounds it on the H100: bytes, barely. At the paper's per-chip shape
// (256 queries, 390,624 docs, D = 4096) the docs are 3.20 GB, read once:
// 0.956 ms at 3.35 TB/s; the 8.19e11 flops take 0.828 ms at the bf16
// peak. So the tensor cores and HBM must both run near their rates at
// once, and nothing may stall either: every CUDA-core design stops at the
// fp32 FMA rate (12.2 ms for those flops at 67 TFLOP/s).
//
// Design.
//  * Docs are wgmma's A (M = doc rows, 64 per consumer warpgroup, two
//    warpgroups: 128 rows a tile) and a tile of 256 queries is its B (N =
//    256), both K-major in shared memory with the 128-byte swizzle, so
//    one m64n256k16 instruction per 16 columns and warpgroup, the sum in
//    128 fp32 registers a thread. Docs as A put the whole query batch of
//    a serving step in one CTA, so each doc row is read from HBM once.
//    The price is the query block (256 x 4096 bf16, 2 MB), read again
//    for every 128-row tile: 6.1 GB from L2 beside the 3.2 GB from HBM at
//    the shape above. (Queries as A re-reads the doc tile once per 128
//    queries instead: the same ratio.) So CTAs run in clusters of two
//    along the docs: each CTA loads its own doc tile and half of the
//    query stage, multicast by TMA into both, which halves the L2 reads
//    of the query block (3.05 GB; scripts/topk_score_variants.py times it
//    against clusters of one).
//  * Stages of 64 columns (one 128-byte swizzle row: 16 KB of docs, 32 KB
//    of queries) in a ring of kStages with full / empty mbarriers. One
//    producer thread a CTA issues the loads of a stage (the tensor maps
//    are encoded on the host; TMA zero-fills the ragged n, nq and D
//    edges); two consumer warpgroups each issue four wgmmas a stage and
//    release the stage one behind, keeping one wgmma group in flight. A
//    stage is refilled once the consumers of both CTAs of the cluster
//    have released it (their half of it came from the other CTA).
//    setmaxnreg gives the producer warpgroup 40 registers and the
//    consumers 232.
//  * Persistent clusters, at most the CTAs the card holds at once:
//    cluster c takes work items c, c + clusters, ..., an item being
//    (query tile, contiguous range of units), a unit being two
//    consecutive doc tiles, one a CTA. Each CTA's per-query partial lists
//    stay in shared memory across its tiles and are written out at the
//    item's end; launch 2 of topk_score.cu (topk_score_merge_kernel)
//    merges the lists of all ranges and CTAs.
//  * Epilogue of a tile, fused: each accumulator element is rounded
//    (round_bf16) and compared with its query's threshold (its list's
//    last-ranked entry, kept apart from the list) in one branch-free
//    pass. Only the elements at or above it go further: a thread stages
//    a few of its own in shared memory and takes them in a plain loop
//    (their doc eligible, not the query's excluded doc, the query not
//    padding, ahead of the threshold), appending them to their query's
//    candidate buffer (an atomic slot); then one thread a query merges
//    its buffer into its list, replacing the last-ranked entry each time.
//    The accumulator's fragment does not hand a thread its docs in id
//    order, so every comparison is on the (score, id) pair: a candidate
//    equal to the threshold's score enters only with a lower id. What
//    finds a buffer full waits for the next round, against the risen
//    thresholds. A range's first tile finds its lists empty, so before
//    it is filtered each query's threshold is seeded with a lower bound
//    on its k-th score from the warps' best two (seed_lists). Lists are
//    sorted once, when a range is written out. Once a range's first tiles
//    have filled the lists few elements pass (about k ln(rows / k) a
//    query over a range), but the epilogue does not overlap the
//    mainloop: the consumers hold the only accumulator.
//  * The tensor cores' fp32 sums run low (each wgmma's add truncates): up
//    to 7e-6 of the score at D = 4096, 4e-6 low on average, where a plain
//    fp32 product is off either way and 0 on average
//    (scripts/topk_score_variants.py measures both). Without round_bf16
//    the scores keep that error (sum_tol bounds it). With round_bf16 it
//    would move a score across a bf16 rounding midpoint now and then, and
//    so swap the ids of tied scores against the plain version; a
//    candidate whose rounding the bound leaves open is summed again from
//    global memory by its warp in fp32 fused multiply-adds (warp_dot), so
//    its rounding is the plain version's but where two fp32 sums in other
//    orders would differ.
//
// Every wait on an mbarrier traps after kHangNs, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk_tc {

constexpr int kBM = 128;  // doc rows a tile: two consumer warpgroups x 64
constexpr int kBN = 256;  // queries a tile: the wgmma's N
constexpr int kBK = 64;   // bf16 columns a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kCluster = 2;    // CTAs a cluster, sharing each query stage
constexpr int kDocBytes = kBM * kBK * 2;
constexpr int kQueryBytes = kBN * kBK * 2;
constexpr int kStageBytes = kDocBytes + kQueryBytes;
constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100
constexpr int kMaxK = 32;
constexpr int kCapMax = 32;     // candidate slots a query, at most
constexpr int kStagedMax = 8;  // elements a consumer thread stages, at most
// Largest k such that the first tile of a range is seeded (seed_lists):
// each of the 8 consumer warps offers its 2 best scores of a query, and
// the (k+1)-th of those 16 bounds the query's k-th (k+1: the 16 may hold
// its excluded doc, which the registers do not know). The 16 a query lie
// in the candidate buffer, so it needs 16 slots a query.
constexpr int kSeedMaxK = 15;
constexpr int kSeedSlots = 16;
constexpr unsigned long long kHangNs = 4000000000ull;

// Candidate counters, excluded ids and the lists' last entries (score, id,
// position: one word each a query), then the ring's full and empty
// barriers.
constexpr int kMiscBytes = 5 * kBN * 4 + 2 * kStages * 8;

// 8-byte slots a query (or a consumer thread: there are kBN of each) that
// shared memory holds beside the stages, the lists and the rest.
__host__ __device__ inline int spare_slots(int k_list) {
  return (kSmemLimit - kStages * kStageBytes - kMiscBytes -
          kBN * 8 * k_list) /
         (kBN * 8);
}

// Elements a consumer thread stages before it appends them: kStagedMax,
// or half the spare slots (8 for k_list = 10, 3 for k_list = 32).
__host__ __device__ inline int staged_max(int k_list) {
  const int half = spare_slots(k_list) / 2;
  return half < kStagedMax ? half : kStagedMax;
}

// Candidate slots a query: the other spare slots (20 for k_list = 10, 3
// for k_list = 32).
__host__ __device__ inline int cand_cap(int k_list) {
  const int cap = spare_slots(k_list) - staged_max(k_list);
  return cap < kCapMax ? cap : kCapMax;
}

static_assert(kSeedMaxK < kSeedSlots, "seed_lists ranks 16 scores a query");

__host__ __device__ inline size_t smem_bytes(int k_list) {
  return (size_t)kStages * kStageBytes +
         (size_t)kBN * 8 *
             (k_list + cand_cap(k_list) + staged_max(k_list)) +
         kMiscBytes;
}

// First unit of range r of `ranges` over n_units units (balanced); a unit
// is kCluster consecutive doc tiles, one a CTA of the cluster.
__host__ __device__ inline int range_begin(int r, int ranges, int n_units) {
  return (int)((long long)r * n_units / ranges);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed; trap past kHangNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// L2 policies of the loads (the encoded createpolicy values CUTLASS names
// CacheHintSm90): docs stream through once, the query block is read again
// for every tile.
constexpr uint64_t kDocsHint = 0x12F0000000000000ull;     // evict first
constexpr uint64_t kQueriesHint = 0x14F0000000000000ull;  // evict last

// A (box columns x box rows) tile at (c0, c1) of a 2-D tensor map into
// shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar,
                                            uint64_t hint) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(hint)
      : "memory");
}

// The same, delivered to the same offset of every CTA of the cluster in
// `cta_mask`, completing on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(
    uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar,
    uint16_t cta_mask, uint64_t hint) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster.L2::cache_hint [%0], [%1, {%2, %3}], [%4], "
      "%5, %6;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(cta_mask), "l"(hint)
      : "memory");
}

// Arrive on the barrier at `bar`'s offset in CTA `cta` of the cluster. The
// release is the CTA's (the default), as for a local arrival: it only says
// that this warp's wgmmas have finished reading a stage, and a release at
// cluster scope on every stage costs a fence the pipeline feels.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n\t}" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// This warp's release of a stage, to its own CTA and to the others of the
// cluster (each of which wrote a query half into it).
__device__ __forceinline__ void release_stage(uint32_t bar, uint32_t rank) {
  mbar_arrive(bar);
  for (uint32_t c = 0; c < (uint32_t)kCluster; ++c)
    if (c != rank) mbar_arrive_cluster(bar, c);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The consumer warpgroups' own barrier (id 1, 256 threads); the _or form
// also returns whether any of them passed true.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

__device__ __forceinline__ bool consumers_or(bool v) {
  uint32_t r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, 256, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"((uint32_t)v)
      : "memory");
  return r != 0;
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO
// unused (1). Advancing K by 16 bf16 values adds 32 bytes (2 in the
// address field) to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32, the wgmma fragment) (+)= A (64 x 16) B^T (16 x 256),
// A and B bf16 in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a ranks ahead of b: higher score, then lower id (an empty entry is
// -inf / -1, behind every finite score)
__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// The list of one query lies in column q of ls / li ([k_list][kBN], entry
// major, so the threads that own consecutive queries hit consecutive
// banks), in no order; th_s / th_i / th_p[q] hold the entry that ranks
// last (score, id, position): the one a candidate must rank ahead of, and
// the one it replaces. Empty entries are -inf / -1.

// The entry of column q that ranks last.
__device__ __forceinline__ void list_last(const float* ls, const int* li,
                                          int q, int k_list, float& ts,
                                          int& ti, int& tp) {
  ts = ls[q];
  ti = li[q];
  tp = 0;
  for (int i = 1; i < k_list; ++i) {
    const float s = ls[i * kBN + q];
    const int id = li[i * kBN + q];
    if (ahead(ts, ti, s, id)) {
      ts = s;
      ti = id;
      tp = i;
    }
  }
}

// Column q in ranking order (once a range, before it is written out).
__device__ __forceinline__ void list_sort(float* ls, int* li, int q,
                                          int k_list) {
  for (int i = 1; i < k_list; ++i) {
    const float s = ls[i * kBN + q];
    const int id = li[i * kBN + q];
    int p = i;
    for (; p > 0 && ahead(s, id, ls[(p - 1) * kBN + q], li[(p - 1) * kBN + q]);
         --p) {
      ls[p * kBN + q] = ls[(p - 1) * kBN + q];
      li[p * kBN + q] = li[(p - 1) * kBN + q];
    }
    ls[p * kBN + q] = s;
    li[p * kBN + q] = id;
  }
}

// Thread (warpgroup g, warp w, lane l) of a consumer holds, in acc[4 j + e],
// doc row 64 g + 16 w + l / 4 (+ 8 when e & 2) of the tile and query
// 8 j + 2 (l % 4) (+ 1 when e & 1) of the query tile: the wgmma fragment.
// id0 / id1 are its two doc ids, ok0 / ok1 whether they are eligible.

template <bool kRound>
__device__ __forceinline__ float tile_score(float v) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// How far the tensor cores' fp32 sum of a score may lie from the exact
// one: each of the D / 16 wgmmas adds its 16 products to the accumulator
// with an error under one fp32 ulp of it (the adds truncate, so the sums
// run low), the accumulator taken as at most the final |score| (at least
// 2^-6). With round_bf16 a score whose rounding this leaves open is
// summed again exactly (rescore_ambiguous), so the roundings are the
// plain version's but where an fp32 sum in another order would differ.
__device__ __forceinline__ float sum_tol(float v, int D) {
  return (float)D * 0x1p-27f * fmaxf(fabsf(v), 0x1p-6f);
}

// The fp32 score of query row qr and doc row dr summed by the warp from
// global memory: each lane a chain of fused multiply-adds over every 32nd
// group of 8 columns (loads issued kDotBatch groups ahead), then a
// butterfly over the lanes.
constexpr int kDotBatch = 4;

__device__ __forceinline__ float warp_dot(const __nv_bfloat16* queries,
                                          const __nv_bfloat16* docs, int qr,
                                          int dr, int D, int lane) {
  const uint4* qp = reinterpret_cast<const uint4*>(queries + (size_t)qr * D);
  const uint4* dp = reinterpret_cast<const uint4*>(docs + (size_t)dr * D);
  const int groups = D / 8;
  float sum = 0.f;
  for (int c0 = lane; c0 < groups; c0 += 32 * kDotBatch) {
    uint4 a[kDotBatch], b[kDotBatch];
#pragma unroll
    for (int u = 0; u < kDotBatch; ++u) {
      const int c = c0 + 32 * u;
      a[u] = c < groups ? qp[c] : make_uint4(0u, 0u, 0u, 0u);
      b[u] = c < groups ? dp[c] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kDotBatch; ++u) {
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a[u]);
      const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b[u]);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 x = __bfloat1622float2(ah[h]);
        const float2 y = __bfloat1622float2(bh[h]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  return sum;
}

// Sets bit b of a 128-bit mask held in four registers.
__device__ __forceinline__ void set_bit(uint32_t (&w)[4], int b) {
  const uint32_t m = 1u << (b & 31);
  switch (b >> 5) {
    case 0: w[0] |= m; break;
    case 1: w[1] |= m; break;
    case 2: w[2] |= m; break;
    default: w[3] |= m;
  }
}

// Before the first tile of a range is filtered, its lists are empty, so
// every element would pass and the rounds would take them all in. Each
// warp's best two scores of each query (with round_bf16 the lowest
// rounding sum_tol allows; eligible rows, real queries;
// ranks 8 lanes apart hold a query's 16 rows of the warp) go to sb
// ([warp][2][kBN], in the candidate buffer, free then); the thread of
// query ct takes the (k+1)-th best of its 16 and, when finite, makes it
// the list's threshold with id INT_MAX (so an equal score still passes the
// filter and ranks ahead of it). At least k eligible scores of the tile
// are at or above it, so the k best are; the first one merged replaces an
// empty entry and the threshold is the list's own again. The caller syncs
// the consumers before sb is a candidate buffer again.
template <bool kRound>
__device__ __forceinline__ float seed_score(float v, int D) {
  return kRound ? tile_score<true>(v - sum_tol(v, D)) : v;
}

template <bool kRound>
__device__ __forceinline__ void seed_lists(const float (&acc)[128],
                                           float* th_s, int* th_i, float* sb,
                                           int ct, int c2, bool ok0, bool ok1,
                                           int qt, int k_list, int D) {
  const int lane = ct & 31;
  const int warp = ct >> 5;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool real = 8 * j + c2 + e < qt;
      const float x0 =
          ok0 && real ? seed_score<kRound>(acc[4 * j + e], D) : -CUDART_INF_F;
      const float x1 = ok1 && real
                           ? seed_score<kRound>(acc[4 * j + 2 + e], D)
                           : -CUDART_INF_F;
      float a = fmaxf(x0, x1), b = fminf(x0, x1);  // the best two, sorted
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        const float pa = __shfl_xor_sync(0xffffffffu, a, m);
        const float pb = __shfl_xor_sync(0xffffffffu, b, m);
        b = fmaxf(fminf(a, pa), fmaxf(b, pb));
        a = fmaxf(a, pa);
      }
      if (lane < 4) {
        sb[(2 * warp) * kBN + 8 * j + c2 + e] = a;
        sb[(2 * warp + 1) * kBN + 8 * j + c2 + e] = b;
      }
    }
  }
  consumers_sync();
  float top[kSeedMaxK + 1];  // the k_list + 1 best of the 16, descending
#pragma unroll
  for (int i = 0; i <= kSeedMaxK; ++i) top[i] = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    float x = sb[w * kBN + ct];
#pragma unroll
    for (int i = 0; i <= kSeedMaxK; ++i) {  // insert, keeping the order
      const float hi = fmaxf(top[i], x);
      x = fminf(top[i], x);
      top[i] = hi;
    }
  }
  float t = top[0];
#pragma unroll
  for (int i = 1; i <= kSeedMaxK; ++i)
    if (i == k_list) t = top[i];
  if (t > -CUDART_INF_F) {
    th_s[ct] = t;
    th_i[ct] = 0x7fffffff;
  }
}

// One branch-free pass compares each element with its query's threshold
// (with round_bf16 the highest rounding sum_tol allows): the bits of the
// elements at or above it are pending. Each round, a thread stages up to
// `ps` of its pending elements in its slots of sg (fp32 score, index
// b = 4 j + e) and takes them in a plain loop (no register of the
// fragment is named at run time): one whose doc is eligible (masked, past
// n), not its query's excluded doc, its query not padding, and ahead of
// the query's threshold is appended (an atomic slot) to its query's
// candidate buffer; one whose rounding sum_tol leaves open is first summed
// again exactly by its warp (warp_dot). Then one thread a query merges
// its buffer into its list. An element that finds its query's buffer full
// is pending again, and rounds go on against the risen thresholds until
// none is pending. Once a range's first tiles have filled the lists few
// elements pass, so a warp spends a few appends a tile, not one divergent
// pass for every element that passes in any of its lanes.
template <bool kRound>
__device__ __forceinline__ void tc_epilogue(
    const float (&acc)[128], float* ls, int* li, float* th_s, int* th_i,
    int* th_p, float* cs, int* ci, int2* sg, int* cnt, const int* exq,
    const __nv_bfloat16* queries, const __nv_bfloat16* docs, int q0, int D,
    int ct, int c2, int id0, int id1, bool ok0, bool ok1, int qt, int k_list,
    int cap, int ps) {
  const int lane = ct & 31;
  uint32_t pend[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 ts = *reinterpret_cast<const float2*>(th_s + 8 * j + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = acc[4 * j + e];
      const float hi = kRound ? tile_score<true>(v + sum_tol(v, D)) : v;
      pend[j >> 3] |= (hi >= ((e & 1) ? ts.y : ts.x) ? 1u : 0u)
                      << (4 * (j & 7) + e);
    }
  }
  for (;;) {
    int n = 0;
    if (pend[0] | pend[1] | pend[2] | pend[3]) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (((pend[j >> 3] >> (4 * (j & 7))) & 0xFu) == 0u) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bit = 1u << (4 * (j & 7) + e);
          if ((pend[j >> 3] & bit) == 0u || n >= ps) continue;
          sg[kBN * n++ + ct] =
              make_int2(__float_as_int(acc[4 * j + e]), 4 * j + e);
          pend[j >> 3] &= ~bit;
        }
      }
    }
    bool appended = false;
    uint32_t open = 0u;  // staged elements whose rounding is left open
    for (int i = 0; i < n; ++i) {
      const int2 en = sg[kBN * i + ct];
      const int b = en.y;
      const int qq = 8 * (b >> 2) + c2 + (b & 1);
      const int id = (b & 2) ? id1 : id0;
      if (!((b & 2) ? ok1 : ok0) || qq >= qt || id == exq[qq]) continue;
      const float v = __int_as_float(en.x);
      float sc = tile_score<kRound>(v);
      if (kRound) {  // sc: the lowest rounding sum_tol allows
        const float tol = sum_tol(v, D);
        const float hi = tile_score<true>(v + tol);
        if (!ahead(hi, id, th_s[qq], th_i[qq])) continue;
        sc = tile_score<true>(v - tol);
        if (sc != hi) {
          open |= 1u << i;
          continue;
        }
      } else if (!ahead(sc, id, th_s[qq], th_i[qq])) {
        continue;
      }
      const int slot = atomicAdd(cnt + qq, 1);
      appended = true;
      if (slot < cap) {
        cs[slot * kBN + qq] = sc;
        ci[slot * kBN + qq] = id;
      } else {
        set_bit(pend, b);
      }
    }
    if (kRound) {  // the open ones, one at a time a warp
      for (;;) {
        const uint32_t m = __ballot_sync(0xffffffffu, open != 0u);
        if (m == 0u) break;
        const int leader = __ffs(m) - 1;
        int b = 0, qr = 0, dr = 0;
        if (lane == leader) {
          b = sg[kBN * (__ffs(open) - 1) + ct].y;
          open &= open - 1u;
          qr = q0 + 8 * (b >> 2) + c2 + (b & 1);
          dr = (b & 2) ? id1 : id0;
        }
        qr = __shfl_sync(0xffffffffu, qr, leader);
        dr = __shfl_sync(0xffffffffu, dr, leader);
        const float sc =
            tile_score<true>(warp_dot(queries, docs, qr, dr, D, lane));
        if (lane == leader) {
          const int qq = qr - q0;
          if (ahead(sc, dr, th_s[qq], th_i[qq])) {
            const int slot = atomicAdd(cnt + qq, 1);
            appended = true;
            if (slot < cap) {
              cs[slot * kBN + qq] = sc;
              ci[slot * kBN + qq] = dr;
            } else {
              set_bit(pend, b);
            }
          }
        }
      }
    }
    const bool waiting = (pend[0] | pend[1] | pend[2] | pend[3]) != 0u;
    if (!consumers_or(appended || waiting)) break;
    const int c = cnt[ct];
    if (c > 0) {
      float ts = th_s[ct];
      int ti = th_i[ct], tp = th_p[ct];
      for (int x = 0; x < (c < cap ? c : cap); ++x) {
        const float s = cs[x * kBN + ct];
        const int id = ci[x * kBN + ct];
        if (!ahead(s, id, ts, ti)) continue;
        ls[tp * kBN + ct] = s;
        li[tp * kBN + ct] = id;
        list_last(ls, li, ct, k_list, ts, ti, tp);
      }
      th_s[ct] = ts;
      th_i[ct] = ti;
      th_p[ct] = tp;
      cnt[ct] = 0;
    }
    if (!consumers_or(waiting)) break;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
topk_score_tc_kernel(__grid_constant__ const CUtensorMap tm_docs,
                     __grid_constant__ const CUtensorMap tm_q,
                     const __nv_bfloat16* __restrict__ queries,
                     const __nv_bfloat16* __restrict__ docs,
                     const int* __restrict__ exclude,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ part_s, int* __restrict__ part_i,
                     int nq, int nq_pad, int n, int D, int ranges,
                     int n_items, int k_list, int cap, bool round_bf16) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  int* li = reinterpret_cast<int*>(ls + k_list * kBN);
  float* cs = reinterpret_cast<float*>(li + k_list * kBN);
  int* ci = reinterpret_cast<int*>(cs + cap * kBN);
  const int ps = staged_max(k_list);
  int2* sg = reinterpret_cast<int2*>(ci + cap * kBN);
  int* cnt = reinterpret_cast<int*>(sg + ps * kBN);
  int* exq = cnt + kBN;
  float* th_s = reinterpret_cast<float*>(exq + kBN);
  int* th_i = reinterpret_cast<int*>(th_s + kBN);
  int* th_p = th_i + kBN;
  uint64_t* full = reinterpret_cast<uint64_t*>(th_p + kBN);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int n_units = ((n + kBM - 1) / kBM + kCluster - 1) / kCluster;
  const int nks = (D + kBK - 1) / kBK;
  uint32_t rank = 0;  // this CTA's place in its cluster
  if (kCluster > 1)
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int cid = blockIdx.x / kCluster;
  const int n_clusters = gridDim.x / kCluster;
  if (tid == 0) {
    if ((smem_u32(smem) & 1023u) != 0u) __trap();  // the swizzle's alignment
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      // one arrival a consumer warp of every CTA of the cluster: each
      // stage's query half is written into all of them
      mbar_init(smem_u32(empty + s), 8 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kCluster > 1)
    cluster_sync();  // no load or arrival reaches a barrier before its init
  else
    __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_docs))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_q))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int w = cid; w < n_items; w += n_clusters) {
        const int q0 = (w / ranges) * kBN;
        const int r = w % ranges;
        const int u1 = range_begin(r + 1, ranges, n_units);
        for (int u = range_begin(r, ranges, n_units); u < u1; ++u) {
          const int t = u * kCluster + rank;  // past n: zero-filled, masked
          for (int ks = 0; ks < nks; ++ks) {
            mbar_wait(smem_u32(empty + stage), phase ^ 1u);
            const uint32_t fb = smem_u32(full + stage);
            const uint32_t st = smem_u32(smem + stage * kStageBytes);
            mbar_expect_tx(fb, kStageBytes);
            tma_load_2d(st, &tm_docs, ks * kBK, t * kBM, fb, kDocsHint);
            if (kCluster > 1)
              tma_load_2d_multicast(
                  st + kDocBytes + rank * (kQueryBytes / kCluster), &tm_q,
                  ks * kBK, q0 + rank * (kBN / kCluster), fb,
                  (uint16_t)((1u << kCluster) - 1u), kQueriesHint);
            else
              tma_load_2d(st + kDocBytes, &tm_q, ks * kBK, q0, fb,
                          kQueriesHint);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
      // stay until every consumer of the cluster has released the last
      // stages: their arrivals on this CTA's barriers are then done
      for (int s = 0; s < kStages; ++s) {
        mbar_wait(smem_u32(empty + stage), phase ^ 1u);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = tid - 128;  // the query whose list this thread merges
    const int g = ct >> 7;
    const int lane = tid & 31;
    const int rloc = 64 * g + 16 * ((ct >> 5) & 3) + (lane >> 2);
    const int c2 = 2 * (lane & 3);
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int w = cid; w < n_items; w += n_clusters) {
      const int q0 = (w / ranges) * kBN;
      const int r = w % ranges;
      const int qt = min(kBN, nq - q0);
      const int u1 = range_begin(r + 1, ranges, n_units);
      for (int i = 0; i < k_list; ++i) {
        ls[i * kBN + ct] = -CUDART_INF_F;
        li[i * kBN + ct] = -1;
      }
      th_s[ct] = -CUDART_INF_F;
      th_i[ct] = -1;
      th_p[ct] = 0;
      cnt[ct] = 0;
      exq[ct] = ct < qt ? exclude[q0 + ct] : -1;
      consumers_sync();
      const int u0 = range_begin(r, ranges, n_units);
      for (int u = u0; u < u1; ++u) {
        const int id0 = (u * kCluster + rank) * kBM + rloc;
        const int id1 = id0 + 8;
        const bool ok0 = id0 < n && (mask == nullptr || mask[id0] != 0);
        const bool ok1 = id1 < n && (mask == nullptr || mask[id1] != 0);
        int prev = 0;
        for (int ks = 0; ks < nks; ++ks) {
          mbar_wait(smem_u32(full + stage), phase);
          const uint32_t st = smem_u32(smem + stage * kStageBytes);
          const uint64_t da = sw128_desc(st + g * (64 * kBK * 2));
          const uint64_t db = sw128_desc(st + kDocBytes);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_256(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();  // the stage before this one is read
          fence_acc(acc);
          if (ks > 0 && lane == 0) release_stage(smem_u32(empty + prev), rank);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) release_stage(smem_u32(empty + prev), rank);
        if (u == u0 && k_list <= kSeedMaxK && cap >= kSeedSlots) {
          if (round_bf16)
            seed_lists<true>(acc, th_s, th_i, cs, ct, c2, ok0, ok1, qt,
                             k_list, D);
          else
            seed_lists<false>(acc, th_s, th_i, cs, ct, c2, ok0, ok1, qt,
                              k_list, D);
          consumers_sync();
        }
        if (round_bf16)
          tc_epilogue<true>(acc, ls, li, th_s, th_i, th_p, cs, ci, sg, cnt,
                            exq, queries, docs, q0, D, ct, c2, id0, id1, ok0,
                            ok1, qt, k_list, cap, ps);
        else
          tc_epilogue<false>(acc, ls, li, th_s, th_i, th_p, cs, ci, sg, cnt,
                             exq, queries, docs, q0, D, ct, c2, id0, id1, ok0,
                             ok1, qt, k_list, cap, ps);
      }
      const size_t out0 =
          (((size_t)r * kCluster + rank) * nq_pad + q0 + ct) * k_list;
      list_sort(ls, li, ct, k_list);
      for (int i = 0; i < k_list; ++i) {
        part_s[out0 + i] = ls[i * kBN + ct];
        part_i[out0 + i] = li[i * kBN + ct];
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  static const cudaError_t status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p))
      e = cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
    return e;
  }();
  *fn = cached;
  return status;
}

// Offset added to a failed encode's CUresult in the launch's return value.
constexpr int kEncodeError = 10000;

// A (rows, D) row-major bf16 matrix as a tensor map of (kBK x box_rows)
// boxes, 128-byte swizzle, out-of-bounds elements read as zero.
inline int encode_rows(EncodeTiled fn, CUtensorMap* map, const void* base,
                       int rows, int D, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

inline cudaLaunchConfig_t launch_config(int grid, size_t smem,
                                        cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// CTAs of this kernel that the card holds at once, in whole clusters, for
// lists of k_list entries (negative: a cudaError_t).
inline int max_ctas(int k_list) {
  const size_t smem = smem_bytes(k_list);
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kCluster, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(topk_score_tc_kernel), &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters * kCluster;
}

// Launch 1: the partial lists of every (query tile, doc range) item into
// part_s / part_i ((kCluster x ranges, nq_pad, k_list), nq_pad = query
// tiles x kBN; CTA `rank` of a cluster writes split kCluster x range +
// rank). `grid` CTAs in clusters of kCluster, ranges over units of kCluster
// tiles. Returns 0, a cudaError_t, or kEncodeError + a CUresult.
inline int launch_partial(const void* queries, const void* docs,
                          const int* exclude, const uint8_t* mask,
                          float* part_s, int* part_i, int nq, int n, int D,
                          int k_list, int ranges, int grid, bool round_bf16,
                          cudaStream_t st) {
  const int n_units = ((n + kBM - 1) / kBM + kCluster - 1) / kCluster;
  const int q_tiles = (nq + kBN - 1) / kBN;
  if (nq < 1 || n < 1 || D < 8 || D % 8 != 0 || k_list < 1 ||
      k_list > kMaxK || ranges < 1 || ranges > n_units || grid < 1 ||
      grid % kCluster != 0 || grid / kCluster > q_tiles * ranges ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(docs) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_docs, tm_q;
  int status = encode_rows(fn, &tm_docs, docs, n, D, kBM);
  if (status) return status;
  status = encode_rows(fn, &tm_q, queries, nq, D, kBN / kCluster);
  if (status) return status;
  const size_t smem = smem_bytes(k_list);
  err = cudaFuncSetAttribute(topk_score_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, topk_score_tc_kernel, tm_docs, tm_q,
                           static_cast<const __nv_bfloat16*>(queries),
                           static_cast<const __nv_bfloat16*>(docs), exclude,
                           mask, part_s, part_i, nq, q_tiles * kBN,
                           n, D, ranges, q_tiles * ranges, k_list,
                           cand_cap(k_list), round_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace topk_tc
