// Brute-force scoring fused with a top-k, for Hopper: the exact k nearest
// documents of every query (ground truth, brute_force_topk / _bottomk).
//
// Replaces topk_score_kernel (src/repro/kernels/topk_score/kernel.py:26,
// launched by pallas_call at src/repro/kernels/topk_score/ops.py:52).
//
// What it computes. scores = queries (nq, D) x docs (n, D)^T accumulated in
// fp32, for fp32 or bf16 inputs (both the same type: the Pallas kernel's
// preferred_element_type=float32); with round_bf16 each score is rounded to
// bf16 (nearest even) before it is masked and merged, as the reference's
// sharded brute force rounds `qw @ docs.T` of bf16 shards
// (src/repro/core/distributed.py:115). A score is dropped when its doc is
// excluded for the query (exclude[q]) or masked out (mask[doc] == 0, e.g. a
// tombstone); each query keeps its k best ordered by (score descending, doc
// id ascending) — the order the TPU kernel and the reference's chunked
// lax.top_k give, since chunks stream in id order and ties go to the
// accumulator. Slots past the eligible documents hold -inf with id -1.
// Products and sums are exact fp32 fused multiply-adds, no TF32.
//
// What bounds it on the H100: operations. Each doc value read feeds 2 * nq
// flops; at nq = 64 that is 32 flops per byte, above the ~20 flop/byte
// ridge of the fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s), so the floor is
// 2 * nq * n * D flops over 67 TFLOP/s, with each document read once (bf16
// docs: 64 flops per byte, further above it).
//
// Design. The TPU kernel walked the doc axis in order inside one grid row
// per query tile. Here the doc axis is split over CTAs, and a CTA holds a
// tile of 64 queries (a whole 64-request batch), so each document row is
// read from device memory once per 64 queries:
//  * Launch 1, grid (query tiles of 64, doc splits sized to give about 2
//    CTAs per SM): a CTA of 256 threads walks its split's doc range in
//    blocks of 128 rows. Each (64 x 128) score block is a register-tiled
//    SGEMM on the CUDA cores (fp32_tile.cuh, the core bucket_score_tiled
//    uses): warp w owns queries 8w..8w+7, lane L rows L + 32 j, so each
//    thread keeps 32 sums and one 16-byte shared load of a row feeds 32
//    FMAs while the query values are warp-wide broadcasts. Rows and
//    queries stream through shared memory in 256-byte (64-column) fp32
//    stages, double-buffered with cp.async (masked rows and the D tail
//    zero-filled, not read); rows that are not 16-byte aligned load value
//    by value. bf16 inputs are read 16 bytes (8 values) a thread with plain
//    loads and widened to fp32 as they are stored to the stage (the simple
//    first version: the loads do not overlap the FMAs of the stage before). The masked scores (mask, exclude) go to shared memory (over the
//    stage buffers, which are idle then), and each warp merges the 128
//    scores of its own 8 queries into their partial lists of min(k, split
//    rows) entries: a ballot against the list's last score lets only the
//    candidates that can enter through (strictly greater than the last
//    enters, after equal scores; rows arrive in id order, so ties keep the
//    lower id). Lists of up to 32 entries are merged in registers, one
//    entry a lane (warp_merge_lanes); longer ones with the shared
//    warp_merge. The lists live in shared memory when they fit, else
//    directly in the global scratch the wrapper allocates, so any k up to
//    n is taken.
//  * Launch 2, one warp per query: a k-way merge of the partial lists by
//    (score descending, id ascending) — the splits hold disjoint id ranges,
//    so this is the same total order — writing the k best and -inf / -1
//    past the eligible documents.
//
// bf16 inputs with D % 8 == 0, 16-byte aligned rows and k <= 32 take the
// tensor-core core of topk_score_tc.cuh instead (wgmma fed by TMA, the
// top-k fused into its epilogue; the wrapper's _core picks it by shape),
// whose per-range lists go through the same launch 2; every other bf16
// call takes launch 1 above.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "fp32_tile.cuh"
#include "score_topk.cuh"
#include "topk_score_tc.cuh"

namespace {

using score_topk::warp_merge;
using namespace fp32_tile;

constexpr int kQT = 64;   // queries per CTA of launch 1
constexpr int kRB = 128;  // doc rows per block
constexpr int kTT = 256;  // threads of a CTA of launch 1
constexpr int kQW = kQT / (kTT / 32);  // queries per warp
constexpr int kSB = 256;                // bytes of a row per stage
constexpr int kKE = kSB / 4;            // fp32 columns per stage
constexpr int kRS = kSB + 16;  // row stride: 4 words past 32k, conflict-free
constexpr int kQS = kKE;  // query stride in floats (broadcast reads)
constexpr int kStage = kRB * kRS + kQT * kQS * (int)sizeof(float);
static_assert(kQT * kRB * sizeof(float) <= 2 * kStage,
              "the score block fits over the two stages");
static_assert(kRB <= kTT, "one id per thread");

__host__ __device__ inline size_t partial_smem_bytes(int k_list,
                                                     bool lists_in_smem) {
  return 2 * (size_t)kStage + sizeof(int) * (kRB + kQT) +
         (lists_in_smem ? (sizeof(float) + sizeof(int)) * (size_t)kQT * k_list
                        : 0);
}

// Eight bf16 values (one 16-byte load) widened into eight floats.
__device__ __forceinline__ void widen8(float* dst, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// Stage `st` (columns [st * kKE, (st + 1) * kKE)) of the block's rows (from
// global row r0; rid[r] < 0 = masked) and of the tile's qt queries, as fp32.
// bf16 inputs: 16-byte loads of 8 values when aligned (D % 8 == 0 and
// 16-byte aligned pointers), else value by value.
__device__ __forceinline__ void load_stage(unsigned char* xs, float* qs,
                                           const __nv_bfloat16* docs, int r0,
                                           const int* rid, int nrows,
                                           const __nv_bfloat16* qtile, int qt,
                                           int D, int st, bool aligned) {
  const int tid = threadIdx.x;
  const int d0 = st * kKE;
  if (aligned) {
    constexpr int P = kKE / 8;  // 8-value pieces of a row stage
    for (int i = tid; i < kRB * P; i += kTT) {
      const int r = i / P, c = i % P;
      const int d = d0 + c * 8;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(
                               docs + (size_t)(r0 + r) * D + d)
                         : make_uint4(0u, 0u, 0u, 0u);
      widen8(reinterpret_cast<float*>(xs + r * kRS) + c * 8, v);
    }
    for (int i = tid; i < kQT * P; i += kTT) {
      const int q = i / P, c = i % P;
      const int d = d0 + c * 8;
      const bool ok = q < qt && d < D;
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(
                               qtile + (size_t)q * D + d)
                         : make_uint4(0u, 0u, 0u, 0u);
      widen8(qs + q * kQS + c * 8, v);
    }
  } else {
    for (int i = tid; i < kRB * kKE; i += kTT) {
      const int r = i / kKE, e = i % kKE;
      const int d = d0 + e;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      reinterpret_cast<float*>(xs + r * kRS)[e] =
          ok ? __bfloat162float(docs[(size_t)(r0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < kQT * kKE; i += kTT) {
      const int q = i / kKE, e = i % kKE;
      const int d = d0 + e;
      qs[q * kQS + e] =
          q < qt && d < D ? __bfloat162float(qtile[(size_t)q * D + d]) : 0.f;
    }
  }
}

__device__ __forceinline__ void load_stage(unsigned char* xs, float* qs,
                                           const float* docs, int r0,
                                           const int* rid, int nrows,
                                           const float* qtile, int qt, int D,
                                           int st, bool aligned) {
  const int tid = threadIdx.x;
  const int d0 = st * kKE;
  if (aligned) {
    constexpr int P = kSB / 16;  // 16-byte pieces of a row stage
    for (int i = tid; i < kRB * P; i += kTT) {
      const int r = i / P, c = i % P;
      const int d = d0 + c * 4;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      const float* src = ok ? docs + (size_t)(r0 + r) * D + d : docs;
      cp_async16(xs + r * kRS + c * 16, src, ok ? 16 : 0);
    }
    for (int i = tid; i < kQT * P; i += kTT) {
      const int q = i / P, c = i % P;
      const int d = d0 + c * 4;
      const bool ok = q < qt && d < D;
      const float* src = ok ? qtile + (size_t)q * D + d : qtile;
      cp_async16(qs + q * kQS + c * 4, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kRB * kKE; i += kTT) {
      const int r = i / kKE, e = i % kKE;
      const int d = d0 + e;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      reinterpret_cast<float*>(xs + r * kRS)[e] =
          ok ? docs[(size_t)(r0 + r) * D + d] : 0.f;
    }
    for (int i = tid; i < kQT * kKE; i += kTT) {
      const int q = i / kKE, e = i % kKE;
      const int d = d0 + e;
      qs[q * kQS + e] = q < qt && d < D ? qtile[(size_t)q * D + d] : 0.f;
    }
  }
}

// One warp merges the masked scores cs[0..n) (ids cid) into a sorted list of
// k_list <= 32 entries held one per lane while it merges: a ballot against
// the list's last score filters 32 candidates at a time, and each survivor
// enters after every entry >= its score (a ballot count), the entries
// behind it moving up one lane with a shuffle. The same tie rule and the
// same list as warp_merge (score_topk.cuh), without its shared-memory
// shifts, which dominated the merge when a split's first blocks fill its
// lists.
__device__ __forceinline__ void warp_merge_lanes(const float* cs,
                                                 const int* cid, int n,
                                                 float* as, int* ai,
                                                 int k_list) {
  const int lane = threadIdx.x & 31;
  float ls = lane < k_list ? as[lane] : -CUDART_INF_F;
  int li = lane < k_list ? ai[lane] : -1;
  float thr = __shfl_sync(0xffffffffu, ls, k_list - 1);
  for (int c0 = 0; c0 < n; c0 += 32) {
    const float sc = c0 + lane < n ? cs[c0 + lane] : -CUDART_INF_F;
    unsigned pass = __ballot_sync(0xffffffffu, sc > thr);
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float s = __shfl_sync(0xffffffffu, sc, src);
      if (!(s > thr)) continue;  // the list rose past it
      const int id = cid[c0 + src];
      const int pos =
          __popc(__ballot_sync(0xffffffffu, lane < k_list && ls >= s));
      const float up_s = __shfl_up_sync(0xffffffffu, ls, 1);
      const int up_i = __shfl_up_sync(0xffffffffu, li, 1);
      if (lane > pos) {
        ls = up_s;
        li = up_i;
      } else if (lane == pos) {
        ls = s;
        li = id;
      }
      thr = __shfl_sync(0xffffffffu, ls, k_list - 1);
    }
  }
  if (lane < k_list) {
    as[lane] = ls;
    ai[lane] = li;
  }
}

// T: float or __nv_bfloat16; kRound: round each score to bf16 (a template
// parameter, so the build without it is the fp32 kernel as it was).
template <typename T, bool kRound>
__global__ void __launch_bounds__(kTT, 2)
topk_score_partial_kernel(const T* __restrict__ queries,
                          const T* __restrict__ docs,
                          const int* __restrict__ exclude,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ part_s, int* __restrict__ part_i,
                          int nq, int nq_pad, int n, int D, int split_rows,
                          int k_list, bool lists_in_smem, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);  // [kQT][kRB], over the stages
  int* rid = reinterpret_cast<int*>(smem + 2 * kStage);  // [kRB]
  int* exq = rid + kRB;                                  // [kQT]

  const int t = blockIdx.x;
  const int sp = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = t * kQT;
  const int qt = min(kQT, nq - q0);
  const size_t list0 = ((size_t)sp * nq_pad + q0) * k_list;
  float* ls = lists_in_smem ? reinterpret_cast<float*>(exq + kQT)
                            : part_s + list0;            // [kQT][k_list]
  int* li = lists_in_smem ? reinterpret_cast<int*>(ls + kQT * k_list)
                          : part_i + list0;
  const T* qtile = queries + (size_t)q0 * D;

  for (int i = tid; i < kQT * k_list; i += kTT) {
    ls[i] = -CUDART_INF_F;
    li[i] = -1;
  }
  if (tid < kQT) exq[tid] = tid < qt ? exclude[q0 + tid] : -1;

  const int nst = (D + kKE - 1) / kKE;
  const int start = sp * split_rows;
  const int end = min(n, start + split_rows);
  for (int r0 = start; r0 < end; r0 += kRB) {
    const int nrows = min(kRB, end - r0);
    __syncthreads();  // the last block's merges are done with ss and rid
    const int my_id = tid < nrows && (mask == nullptr || mask[r0 + tid] != 0)
                          ? r0 + tid : -1;
    if (tid < kRB) rid[tid] = my_id;
    if (!__syncthreads_or(my_id >= 0)) continue;  // all masked

    float acc[kQW][4];
#pragma unroll
    for (int i = 0; i < kQW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load_stage(smem, reinterpret_cast<float*>(smem + kRB * kRS), docs,
               r0, rid, nrows, qtile, qt, D, 0, aligned);
    cp_async_commit();
    for (int st = 0; st < nst; ++st) {
      const int buf = st & 1;
      unsigned char* xb = smem + buf * kStage;
      if (st + 1 < nst) {
        unsigned char* nb = smem + (buf ^ 1) * kStage;
        load_stage(nb, reinterpret_cast<float*>(nb + kRB * kRS), docs,
                   r0, rid, nrows, qtile, qt, D, st + 1, aligned);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      stage_fma<kQW, kRS, kQS, kKE>(
          xb, reinterpret_cast<const float*>(xb + kRB * kRS),
          warp * kQW, lane, acc);
      __syncthreads();  // this buffer is refilled by the next stage's load
    }

    // each warp writes, then merges, the scores of its own queries
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const int q = warp * kQW + i;
      if (q >= qt) break;  // warp-uniform
      const int ex = exq[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        const int id = rid[r];
        const float v = kRound
                            ? __bfloat162float(__float2bfloat16(acc[i][j]))
                            : acc[i][j];
        ss[q * kRB + r] = r < nrows && id >= 0 && id != ex ? v : -CUDART_INF_F;
      }
    }
    __syncwarp();
    for (int i = 0; i < kQW; ++i) {
      const int q = warp * kQW + i;
      if (q >= qt) break;
      if (k_list <= 32)
        warp_merge_lanes(ss + q * kRB, rid, nrows, ls + (size_t)q * k_list,
                         li + (size_t)q * k_list, k_list);
      else
        warp_merge(ss + q * kRB, rid, nrows, exq[q], ls + (size_t)q * k_list,
                   li + (size_t)q * k_list, nullptr, k_list);
    }
  }
  __syncthreads();
  if (lists_in_smem) {
    for (int i = tid; i < qt * k_list; i += kTT) {
      part_s[list0 + i] = ls[i];
      part_i[list0 + i] = li[i];
    }
  }
}

// a ahead of b: higher score, then lower id; ids < 0 are spent lists
__device__ __forceinline__ bool ahead(float as, int ai, float bs, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  return as > bs || (as == bs && ai < bi);
}

__global__ void topk_score_merge_kernel(const float* __restrict__ part_s,
                                        const int* __restrict__ part_i,
                                        float* __restrict__ out_s,
                                        int* __restrict__ out_i, int nq_pad,
                                        int n_splits, int k_list, int k) {
  extern __shared__ __align__(16) float msmem[];
  float* hs = msmem;                                     // [n_splits] heads
  int* hi = reinterpret_cast<int*>(hs + n_splits);
  int* pos = hi + n_splits;
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  for (int j = lane; j < n_splits; j += 32) {
    const size_t base = ((size_t)j * nq_pad + q) * k_list;
    hs[j] = part_s[base];
    hi[j] = part_i[base];
    pos[j] = 0;
  }
  __syncwarp();
  int r = 0;
  for (; r < k; ++r) {
    float bs = -CUDART_INF_F;
    int bi = -1, bj = -1;
    for (int j = lane; j < n_splits; j += 32)
      if (ahead(hs[j], hi[j], bs, bi)) {
        bs = hs[j];
        bi = hi[j];
        bj = j;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ahead(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
        bj = oj;
      }
    }
    if (bi < 0) break;  // every list is spent: the rest stay -inf / -1
    if (lane == 0) {
      out_s[(size_t)q * k + r] = bs;
      out_i[(size_t)q * k + r] = bi;
      const int p = ++pos[bj];
      const size_t base = ((size_t)bj * nq_pad + q) * k_list;
      hs[bj] = p < k_list ? part_s[base + p] : -CUDART_INF_F;
      hi[bj] = p < k_list ? part_i[base + p] : -1;
    }
    __syncwarp();
  }
  for (int i = r + lane; i < k; i += 32) {
    out_s[(size_t)q * k + i] = -CUDART_INF_F;
    out_i[(size_t)q * k + i] = -1;
  }
}

// Launch 2 over the (n_splits, nq_pad, k_list) partial lists.
int launch_merge(const float* part_s, const int* part_i, float* out_s,
                 int* out_i, int nq, int nq_pad, int n_splits, int k_list,
                 int k, cudaStream_t st) {
  const size_t msmem = (size_t)n_splits * (sizeof(float) + 2 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)msmem);
  if (err != cudaSuccess) return (int)err;
  topk_score_merge_kernel<<<nq, 32, msmem, st>>>(part_s, part_i, out_s, out_i,
                                                 nq_pad, n_splits, k_list, k);
  return (int)cudaGetLastError();
}

template <typename T, bool kRound>
cudaError_t launch_partial(const void* queries, const void* docs,
                           const int* exclude, const uint8_t* mask,
                           float* part_s, int* part_i, int nq, int nq_pad,
                           int n, int D, int split_rows, int k_list,
                           bool lists_in_smem, bool aligned, dim3 grid,
                           size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_partial_kernel<T, kRound>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_score_partial_kernel<T, kRound><<<grid, kTT, smem, st>>>(
      static_cast<const T*>(queries), static_cast<const T*>(docs), exclude,
      mask, part_s, part_i, nq, nq_pad, n, D, split_rows, k_list,
      lists_in_smem, aligned);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory of a CTA of launch 1 (the wrapper keeps the partial lists
// in global scratch when this exceeds a block's limit with them inside).
size_t topk_score_smem_bytes(int k_list, int lists_in_smem) {
  return partial_smem_bytes(k_list, lists_in_smem != 0);
}

// queries / docs: fp32, or bf16 when is_bf16 (both the same type);
// part_s / part_i: (n_splits, nq_pad, k_list) scratch, nq_pad = a multiple of
// 64 >= nq; mask may be null. Returns a cudaError_t.
int topk_score_launch(const void* queries, const void* docs,
                      const int* exclude, const uint8_t* mask, float* part_s,
                      int* part_i, float* out_s, int* out_i, int nq, int n,
                      int D, int k, int split_rows, int k_list,
                      int lists_in_smem, int is_bf16, int round_bf16,
                      void* stream) {
  if (nq < 1 || n < 1 || D < 1 || k < 1 || k_list < 1 || k_list > split_rows ||
      split_rows < 1 || split_rows % kRB != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (nq + kQT - 1) / kQT;
  const int nq_pad = n_tiles * kQT;
  const int n_splits = (n + split_rows - 1) / split_rows;
  const size_t smem = partial_smem_bytes(k_list, lists_in_smem != 0);
  const bool aligned = D % (is_bf16 ? 8 : 4) == 0 &&
                       reinterpret_cast<uintptr_t>(docs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid(n_tiles, n_splits);
  cudaError_t err =
      is_bf16 ? (round_bf16 ? launch_partial<__nv_bfloat16, true>
                            : launch_partial<__nv_bfloat16, false>)(
                    queries, docs, exclude, mask, part_s, part_i, nq, nq_pad,
                    n, D, split_rows, k_list, lists_in_smem != 0, aligned,
                    grid, smem, st)
              : (round_bf16 ? launch_partial<float, true>
                            : launch_partial<float, false>)(
                    queries, docs, exclude, mask, part_s, part_i, nq, nq_pad,
                    n, D, split_rows, k_list, lists_in_smem != 0, aligned,
                    grid, smem, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(part_s, part_i, out_s, out_i, nq, nq_pad, n_splits,
                      k_list, k, st);
}

// Shared memory of a CTA of the tensor-core core (lists of k_list entries).
size_t topk_score_tc_smem_bytes(int k_list) {
  return topk_tc::smem_bytes(k_list);
}

// CTAs of the tensor-core core the card holds at once, in whole clusters
// (negative: a cudaError_t).
int topk_score_tc_max_ctas(int k_list) { return topk_tc::max_ctas(k_list); }

// The tensor-core core: bf16 queries / docs, D % 8 == 0, 16-byte aligned,
// 1 <= k <= 32. ranges: contiguous doc ranges of whole units of
// topk_tc::kCluster 128-row tiles (<= the unit count); grid: persistent
// CTAs in clusters of kCluster (<= kCluster x query tiles x ranges);
// part_s / part_i: (kCluster x ranges, nq_pad, k) scratch, nq_pad = a
// multiple of 256 >= nq; mask may be null. Returns 0, a cudaError_t, or
// topk_tc::kEncodeError + the CUresult of a failed tensor-map encode.
int topk_score_tc_launch(const void* queries, const void* docs,
                         const int* exclude, const uint8_t* mask,
                         float* part_s, int* part_i, float* out_s, int* out_i,
                         int nq, int n, int D, int k, int ranges, int grid,
                         int round_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = topk_tc::launch_partial(
      queries, docs, exclude, mask, part_s, part_i, nq, n, D, k, ranges, grid,
      round_bf16 != 0, st);
  if (status != 0) return status;
  const int nq_pad = (nq + topk_tc::kBN - 1) / topk_tc::kBN * topk_tc::kBN;
  return launch_merge(part_s, part_i, out_s, out_i, nq, nq_pad,
                      topk_tc::kCluster * ranges, k, k, st);
}

}  // extern "C"
