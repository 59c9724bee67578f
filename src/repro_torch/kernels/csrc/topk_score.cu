// Brute-force scoring fused with a top-k, for Hopper: the exact k nearest
// documents of every query (ground truth, brute_force_topk / _bottomk).
//
// Replaces topk_score_kernel (src/repro/kernels/topk_score/kernel.py:26,
// launched by pallas_call at src/repro/kernels/topk_score/ops.py:52).
//
// What it computes. scores = queries (nq, D) x docs (n, D)^T in fp32; a
// score is dropped when its doc is excluded for the query (exclude[q]) or
// masked out (mask[doc] == 0, e.g. a tombstone); each query keeps its k best
// ordered by (score descending, doc id ascending) — the order the TPU kernel
// and the reference's chunked lax.top_k give, since chunks stream in id
// order and ties go to the accumulator. Slots past the eligible documents
// hold -inf with id -1. Scores are exact fp32 (fused multiply-adds, no TF32).
//
// What bounds it on the H100: operations. Each doc value read feeds 2 * nq
// flops; at nq = 64 that is 32 flops per byte, above the ~20 flop/byte
// ridge of the fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s), so the floor is
// 2 * nq * n * D flops over 67 TFLOP/s.
//
// Design (simple and right first). The TPU kernel walked the doc axis in
// order inside one grid row per query tile; here that would leave most of
// the 132 SMs idle. So the doc axis is split over CTAs:
//  * Launch 1, grid (query tiles of 8, doc splits): a CTA holds its 8
//    queries in shared memory (whole rows when they fit, else restaged in
//    1024-column chunks for each round of rows, the partial sums carried in
//    registers, so any D is taken), streams its doc range in chunks of 256
//    rows (each warp scoring 4 rows at a time, the loads and dot products of
//    score_topk.cuh), and merges each chunk into a per-query partial list of
//    min(k, split rows) entries with the shared warp merge (strictly greater
//    than the last enters, after equal scores; rows arrive in id order, so
//    ties keep the lower id). The lists live in shared memory when they fit,
//    else directly in the global scratch the wrapper allocates, so any k up
//    to n is taken.
//  * Launch 2, one warp per query: a k-way merge of the partial lists by
//    (score descending, id ascending) — the splits hold disjoint id ranges,
//    so this is the same total order — writing the k best and -inf / -1
//    past the eligible documents. This mirrors fpf_iter's two-launch design.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "score_topk.cuh"

namespace {

using namespace score_topk;

constexpr int kQT = 8;  // queries per CTA of launch 1

__host__ __device__ inline size_t partial_smem_bytes(int dc, int k_list,
                                                     bool lists_in_smem) {
  return sizeof(float) * ((size_t)kQT * dc + (size_t)kQT * kChunk) +
         sizeof(int) * (size_t)kChunk +
         (lists_in_smem ? (sizeof(float) + sizeof(int)) * (size_t)kQT * k_list
                        : 0);
}

// Query columns staged at once: whole rows when they fit with the rest.
__host__ __device__ inline int query_width(int D, int k_list,
                                           bool lists_in_smem) {
  return staged_width<float>(D, kQT,
                             partial_smem_bytes(0, k_list, lists_in_smem));
}

__global__ void __launch_bounds__(kThreads)
topk_score_partial_kernel(const float* __restrict__ queries,
                          const float* __restrict__ docs,
                          const int* __restrict__ exclude,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ part_s, int* __restrict__ part_i,
                          int nq, int nq_pad, int n, int D, int Dc,
                          int split_rows, int k_list, bool lists_in_smem,
                          bool aligned) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [kQT][Dc]
  float* ss = qs + (size_t)kQT * Dc;                  // [kQT][kChunk]
  int* rid = reinterpret_cast<int*>(ss + kQT * kChunk);  // [kChunk]

  const int t = blockIdx.x;
  const int sp = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = t * kQT;
  const int qt = min(kQT, nq - q0);
  const size_t list0 = ((size_t)sp * nq_pad + q0) * k_list;
  float* ls = lists_in_smem ? reinterpret_cast<float*>(rid + kChunk)
                            : part_s + list0;            // [kQT][k_list]
  int* li = lists_in_smem ? reinterpret_cast<int*>(ls + kQT * k_list)
                          : part_i + list0;

  if (D <= Dc)  // else score_rows restages it chunk by chunk
    store_queries<float>(qs, queries, (size_t)q0, qt, kQT, D, 0, Dc, false);
  for (int i = tid; i < kQT * k_list; i += kThreads) {
    ls[i] = -CUDART_INF_F;
    li[i] = -1;
  }

  const int start = sp * split_rows;
  const int end = min(n, start + split_rows);
  for (int r0 = start; r0 < end; r0 += kChunk) {
    const int nrows = min(kChunk, end - r0);
    __syncthreads();  // queries and lists are set; the last merge is done
    const int row = r0 + tid;
    const int my_id =
        tid < nrows && (mask == nullptr || mask[row] != 0) ? row : -1;
    rid[tid] = my_id;
    if (!__syncthreads_or(my_id >= 0)) continue;  // all masked

    score_rows<float, kQT>(docs + (size_t)r0 * D, nrows, rid, D, Dc, aligned,
                           1.f, qs, queries, (size_t)q0, qt, false, ss);
    __syncthreads();
    for (int q = warp; q < qt; q += kWarps)
      warp_merge(ss + q * kChunk, rid, nrows, exclude[q0 + q],
                 ls + (size_t)q * k_list, li + (size_t)q * k_list, nullptr,
                 k_list);
  }
  __syncthreads();
  if (lists_in_smem) {
    for (int i = tid; i < qt * k_list; i += kThreads) {
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

}  // namespace

extern "C" {

// Shared memory of launch 1 with the partial lists in shared memory (the
// wrapper keeps them in global scratch when this exceeds a block's limit).
size_t topk_score_smem_bytes(int D, int k_list, int lists_in_smem) {
  return partial_smem_bytes(query_width(D, k_list, lists_in_smem != 0), k_list,
                            lists_in_smem != 0);
}

// part_s / part_i: (n_splits, nq_pad, k_list) scratch, nq_pad = a multiple of
// 8 >= nq; mask may be null. Returns a cudaError_t.
int topk_score_launch(const float* queries, const float* docs,
                      const int* exclude, const uint8_t* mask, float* part_s,
                      int* part_i, float* out_s, int* out_i, int nq, int n,
                      int D, int k, int split_rows, int k_list,
                      int lists_in_smem, void* stream) {
  if (nq < 1 || n < 1 || D < 1 || k < 1 || k_list < 1 || k_list > split_rows ||
      split_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dc = query_width(D, k_list, lists_in_smem != 0);
  const int n_tiles = (nq + kQT - 1) / kQT;
  const int nq_pad = n_tiles * kQT;
  const int n_splits = (n + split_rows - 1) / split_rows;
  const size_t smem = partial_smem_bytes(Dc, k_list, lists_in_smem != 0);
  const bool aligned = ((size_t)D * sizeof(float)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_score_partial_kernel<<<dim3(n_tiles, n_splits), kThreads, smem, st>>>(
      queries, docs, exclude, mask, part_s, part_i, nq, nq_pad, n, D, Dc,
      split_rows, k_list, lists_in_smem != 0, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = (size_t)n_splits * (sizeof(float) + 2 * sizeof(int));
  err = cudaFuncSetAttribute(topk_score_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  topk_score_merge_kernel<<<nq, 32, msmem, st>>>(part_s, part_i, out_s, out_i,
                                                 nq_pad, n_splits, k_list, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
