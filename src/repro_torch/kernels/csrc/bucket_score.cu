// Per-query cluster-prune scoring with a fused running top-k (the v1
// kernel), for Hopper.
//
// Replaces bucket_score_kernel (src/repro/kernels/bucket_score/kernel.py:65,
// launched by pallas_call at src/repro/kernels/bucket_score/ops.py:89).
//
// What it computes. For query q and each of its P probes p, in order: score
// bucket probes[q, p] (B rows of D values, fp32, bf16 or int8) against the
// query with fp32 accumulation; mask a score to -inf when the row id is -1
// (padding), when it equals exclude[q], or when the id is already in the
// query's running top-k as it stood before the bucket (duplicates across the
// T clusterings, kernel.py:89); merge into a (k_pad) running top-k, ties to
// the accumulator and then to the lower row. Precision as the TPU kernel's
// jnp.dot(f32 query, block) with preferred_element_type=f32: a bf16 or int8
// pack is widened to fp32 and scored against the fp32 query, which is NOT
// rounded to bf16 (the tiled kernel rounds it), and an int8 pack takes no
// scale (the v1 kernel has no scales operand): q . float(int8 row).
//
// What bounds it on the H100: bytes. Every (query, probe) reads its bucket
// again — 2 flops per value read, far under the fp32 ridge — so the time
// is the P * nq block reads over 3.35 TB/s (what L2 does not absorb). The
// tiled kernel exists to read a bucket shared by a tile's queries once.
//
// Design (simple and right first): one CTA (256 threads) per query, looping
// over its P probes. The query sits in shared memory — whole when it fits,
// else restaged in 1024-column chunks for each round of rows, the partial
// sums carried in registers, so any D is taken; each bucket streams in
// chunks of 256 rows, each warp scoring 4 rows at a time; one warp merges.
// The loads, the warp dot products and the merge (with the pre-bucket
// snapshot for the duplicate mask) live in score_topk.cuh, shared with
// topk_score.cu and the merge of bucket_score_tiled.cu.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "score_topk.cuh"

namespace {

using namespace score_topk;

__host__ __device__ inline size_t smem_bytes(int dc, int k_pad) {
  return sizeof(float) * ((size_t)dc + kChunk) + sizeof(int) * (kChunk + 1) +
         (sizeof(float) + 2 * sizeof(int)) * (size_t)k_pad;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_score_kernel(const float* __restrict__ queries,
                    const T* __restrict__ data, const int* __restrict__ ids,
                    const int* __restrict__ probes,
                    const int* __restrict__ exclude,
                    float* __restrict__ out_scores, int* __restrict__ out_ids,
                    int P, int B, int D, int Dc, int k_pad, bool aligned) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                    // [Dc] interleaved
  float* ss = qs + Dc;                                 // [kChunk]
  int* rid = reinterpret_cast<int*>(ss + kChunk);      // [kChunk]
  int* mem = rid + kChunk;                             // [1]
  float* acc_s = reinterpret_cast<float*>(mem + 1);    // [k_pad]
  int* acc_i = reinterpret_cast<int*>(acc_s + k_pad);
  int* snap = acc_i + k_pad;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  if (D <= Dc)  // else scan_bucket restages it chunk by chunk
    store_queries<T>(qs, queries, (size_t)q, 1, 1, D, 0, Dc, false);
  for (int i = tid; i < k_pad; i += kThreads) {
    acc_s[i] = -CUDART_INF_F;
    acc_i[i] = -1;
  }
  if (tid == 0) mem[0] = 1;
  for (int p = 0; p < P; ++p) {
    const int bucket = probes[(size_t)q * P + p];
    scan_bucket<T, 1>(data + (size_t)bucket * B * D, ids + (size_t)bucket * B,
                      B, D, Dc, aligned, 1.f, qs, queries, (size_t)q, false,
                      mem, 1, exclude + q, acc_s, acc_i, snap, k_pad, ss, rid);
  }
  __syncthreads();
  for (int i = tid; i < k_pad; i += kThreads) {
    out_scores[(size_t)q * k_pad + i] = acc_s[i];
    out_ids[(size_t)q * k_pad + i] = acc_i[i];
  }
}

template <typename T>
cudaError_t launch(const float* queries, const void* data, const int* ids,
                   const int* probes, const int* exclude, float* out_scores,
                   int* out_ids, int nq, int P, int B, int D, int k_pad,
                   cudaStream_t stream) {
  // the query is fp32 whatever the pack: lay it out for the pack's loads
  const int Dc = staged_width<T>(D, 1, smem_bytes(0, k_pad));
  const size_t smem = smem_bytes(Dc, k_pad);
  const bool aligned = ((size_t)D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0;
  auto kern = bucket_score_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<nq, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(data), ids, probes, exclude, out_scores,
      out_ids, P, B, D, Dc, k_pad, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16, 2 = int8. Returns a cudaError_t.
int bucket_score_launch(const float* queries, const void* data, const int* ids,
                        const int* probes, const int* exclude,
                        float* out_scores, int* out_ids, int nq, int P, int B,
                        int D, int k_pad, int dtype_code, void* stream) {
  if (nq < 1 || P < 1 || k_pad < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)launch<float>(queries, data, ids, probes, exclude,
                                out_scores, out_ids, nq, P, B, D, k_pad, st);
    case 1:
      return (int)launch<__nv_bfloat16>(queries, data, ids, probes, exclude,
                                        out_scores, out_ids, nq, P, B, D,
                                        k_pad, st);
    case 2:
      return (int)launch<int8_t>(queries, data, ids, probes, exclude,
                                 out_scores, out_ids, nq, P, B, D, k_pad, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
