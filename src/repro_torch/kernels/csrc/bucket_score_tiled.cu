// Query-tiled cluster-prune scoring with a fused running top-k, for Hopper.
//
// Replaces bucket_score_tiled_kernel (src/repro/kernels/bucket_score/kernel.py:100,
// launched by pallas_call at src/repro/kernels/bucket_score/ops.py:179).
//
// What it computes. For query tile t (QT queries) and each slot s of the
// tile's deduplicated probe schedule, in order: score bucket schedule[t, s]
// (B rows of D values, fp32 / bf16 / int8) against the tile's queries with
// fp32 accumulation; mask a score to -inf when the query does not probe the
// bucket (member[t, s, q] == 0), when the row id is -1 (padding), when the id
// equals exclude[q], or when the id is already in query q's running top-k
// (duplicates across the T clusterings); merge into a per-query (k_pad)
// running top-k. Precision follows the TPU kernel exactly:
//   fp32 pack: fp32 query x fp32 row, fp32 accumulate;
//   bf16 pack: the query is rounded to bf16 (RNE) and both operands widened
//              to fp32 — a bf16 x bf16 product is exact in fp32;
//   int8 pack: int8 values widen exactly, times the bf16-rounded query,
//              fp32 accumulate, THEN times scales[bucket] (kernel.py:121-129).
//
// What bounds it on the H100: bytes. Each scheduled bucket costs B*D*itemsize
// bytes read and 2*QT*D flops per row, i.e. QT/2 flops per fp32 byte (8 at
// QT=16): under the ~20 flop/byte ridge of the fp32 CUDA cores, so the floor
// is the live block bytes over 3.35 TB/s.
//
// Design (a simple kernel that is right first; see PERF.md for its time):
//  * Grid: one CTA (256 threads, 8 warps) per query tile. On the TPU the S
//    grid axis ran in order and carried the accumulator between steps; a
//    Hopper block carries nothing, so a loop over S inside the CTA replaces
//    that axis. Slots whose membership row is all zero (schedule padding
//    pointing at bucket 0) are skipped without reading the block.
//  * The tile's queries live in shared memory for the whole CTA, stored in a
//    lane-interleaved order so that each lane's 16-byte global load of a row
//    meets conflict-free shared loads of the matching query values. Any D is
//    taken: when a row does not fill whole 16-byte words (or D * itemsize is
//    not a multiple of 16, so rows are not 16-byte aligned) the loads go
//    value by value, and columns past D read as zero.
//  * Tiles of up to 16 queries; the wrapper splits a larger tile into
//    sub-tiles that share the schedule row (membership is per query).
//  * A bucket is streamed in chunks of BC = 256 rows; a warp scores R = 4
//    rows at a time against all queries (each lane covers a 16-byte column
//    slice, partial sums reduced with warp shuffles). Row groups whose ids are
//    all -1 (the padded tail of a bucket) are skipped, so padding costs no
//    bytes and no flops.
//  * Merge: one warp per query filters the chunk's 32-candidate slices with a
//    ballot against the list's last score, then lane 0 inserts survivors in
//    row order into the sorted (k_pad) list in shared memory. A candidate
//    enters only if its score is STRICTLY greater than the list's last score
//    and is placed after any equal scores — the order lax.top_k gives over
//    [acc, candidates] (ties to the accumulator, then to the lower position;
//    kernel.py:41-48). Entries at -inf keep id -1.
//  * Duplicate check: against a snapshot of the list taken before the bucket,
//    exactly as the TPU kernel masks ids against the accumulator before the
//    bucket's merge. Merging a bucket chunk by chunk then gives the same
//    result as merging it whole: ids within one bucket are unique, so no
//    chunk can insert an id another chunk of the same bucket holds; the only
//    difference chunking could make is an id evicted by an earlier chunk of
//    the same bucket, and the snapshot still masks it, as the reference does.
//
// The loads, the warp dot products and the merge live in score_topk.cuh,
// shared with bucket_score.cu (v1) and topk_score.cu.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "score_topk.cuh"

namespace {

using namespace score_topk;

// Shared memory footprint in bytes; the Python side mirrors this formula
// (ops.smem_bytes) to size the query tile.
__host__ __device__ inline size_t smem_bytes(int qtm, int dp, int k_pad) {
  return sizeof(float) * ((size_t)qtm * dp + (size_t)qtm * kChunk) +
         sizeof(int) * ((size_t)kChunk + qtm) +
         (sizeof(float) + 2 * sizeof(int)) * (size_t)qtm * k_pad;
}

template <typename T, int QTM>
__global__ void __launch_bounds__(kThreads)
bucket_score_tiled_kernel(const float* __restrict__ queries,
                          const T* __restrict__ data,
                          const int* __restrict__ ids,
                          const float* __restrict__ scales,
                          const int* __restrict__ schedule,
                          const int* __restrict__ member,
                          const int* __restrict__ exclude,
                          float* __restrict__ out_scores,
                          int* __restrict__ out_ids,
                          int S, int qt, int B, int D, int Dp, int k_pad,
                          bool aligned) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [QTM][Dp] interleaved
  float* ss = qs + (size_t)QTM * Dp;                  // [QTM][kChunk]
  int* rid = reinterpret_cast<int*>(ss + QTM * kChunk);  // [kChunk]
  int* mem = rid + kChunk;                            // [QTM]
  float* acc_s = reinterpret_cast<float*>(mem + QTM); // [QTM][k_pad]
  int* acc_i = reinterpret_cast<int*>(acc_s + QTM * k_pad);
  int* snap = acc_i + QTM * k_pad;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;

  store_queries<T>(qs, queries, (size_t)t * qt, qt, QTM, D, Dp,
                   Pack<T>::kElemsPerWord > 1);
  for (int i = tid; i < QTM * k_pad; i += kThreads) {
    acc_s[i] = -CUDART_INF_F;
    acc_i[i] = -1;
  }

  for (int s = 0; s < S; ++s) {
    const int bucket = schedule[(size_t)t * S + s];
    __syncthreads();  // every warp is done with the previous slot's mem
    if (tid < QTM) mem[tid] = tid < qt ? member[((size_t)t * S + s) * qt + tid] : 0;
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int q = 0; q < QTM; ++q) any |= mem[q];
    if (!any) continue;  // schedule padding: no query probes this slot
    const float scale = Pack<T>::kElemsPerWord == 4 ? scales[bucket] : 1.f;
    scan_bucket<T, QTM>(data + (size_t)bucket * B * D, ids + (size_t)bucket * B,
                        B, D, Dp, aligned, scale, qs, mem, qt,
                        exclude + (size_t)t * qt, acc_s, acc_i, snap, k_pad,
                        ss, rid);
  }
  __syncthreads();
  for (int i = tid; i < qt * k_pad; i += kThreads) {
    out_scores[(size_t)(t * qt) * k_pad + i] = acc_s[i];
    out_ids[(size_t)(t * qt) * k_pad + i] = acc_i[i];
  }
}

template <typename T, int QTM>
cudaError_t launch(const float* queries, const void* data, const int* ids,
                   const float* scales, const int* schedule, const int* member,
                   const int* exclude, float* out_scores, int* out_ids,
                   int n_tiles, int S, int qt, int B, int D, int k_pad,
                   cudaStream_t stream) {
  const int Dp = padded_width<T>(D);
  const size_t smem = smem_bytes(QTM, Dp, k_pad);
  const bool aligned = ((size_t)D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0;
  auto kern = bucket_score_tiled_kernel<T, QTM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n_tiles, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(data), ids, scales, schedule, member,
      exclude, out_scores, out_ids, S, qt, B, D, Dp, k_pad, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_qt(const float* queries, const void* data, const int* ids,
                        const float* scales, const int* schedule,
                        const int* member, const int* exclude,
                        float* out_scores, int* out_ids, int n_tiles, int S,
                        int qt, int B, int D, int k_pad, cudaStream_t stream) {
  if (qt <= 8)
    return launch<T, 8>(queries, data, ids, scales, schedule, member, exclude,
                        out_scores, out_ids, n_tiles, S, qt, B, D, k_pad, stream);
  return launch<T, 16>(queries, data, ids, scales, schedule, member, exclude,
                       out_scores, out_ids, n_tiles, S, qt, B, D, k_pad, stream);
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16, 2 = int8. Returns a cudaError_t.
int bucket_score_tiled_launch(const float* queries, const void* data,
                              const int* ids, const float* scales,
                              const int* schedule, const int* member,
                              const int* exclude, float* out_scores,
                              int* out_ids, int n_tiles, int S, int qt, int B,
                              int D, int k_pad, int dtype_code, void* stream) {
  if (qt < 1 || qt > 16 || k_pad < 1 || D < 1 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)dispatch_qt<float>(queries, data, ids, scales, schedule,
                                     member, exclude, out_scores, out_ids,
                                     n_tiles, S, qt, B, D, k_pad, st);
    case 1:
      return (int)dispatch_qt<__nv_bfloat16>(queries, data, ids, scales,
                                             schedule, member, exclude,
                                             out_scores, out_ids, n_tiles, S,
                                             qt, B, D, k_pad, st);
    case 2:
      return (int)dispatch_qt<int8_t>(queries, data, ids, scales, schedule,
                                      member, exclude, out_scores, out_ids,
                                      n_tiles, S, qt, B, D, k_pad, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
