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
//    meets conflict-free shared loads of the matching query values.
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
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;         // rows a warp scores at once
constexpr int kChunk = 256;      // rows per streamed bucket chunk
static_assert(kChunk == kThreads, "each thread loads one id per chunk");

template <typename T> struct Pack;
template <> struct Pack<float> { static constexpr int kElemsPerWord = 1; };
template <> struct Pack<__nv_bfloat16> { static constexpr int kElemsPerWord = 2; };
template <> struct Pack<int8_t> { static constexpr int kElemsPerWord = 4; };

// Widen the E values packed in one 32-bit word (little-endian order).
template <typename T>
__device__ __forceinline__ void widen(uint32_t w, float* out);
template <>
__device__ __forceinline__ void widen<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void widen<int8_t>(uint32_t w, float* out) {
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = (float)(int8_t)((w >> (8 * e)) & 0xffu);
}

template <int E>
__device__ __forceinline__ void load_q(const float* p, float* q);
template <>
__device__ __forceinline__ void load_q<1>(const float* p, float* q) { q[0] = *p; }
template <>
__device__ __forceinline__ void load_q<2>(const float* p, float* q) {
  float2 v = *reinterpret_cast<const float2*>(p);
  q[0] = v.x; q[1] = v.y;
}
template <>
__device__ __forceinline__ void load_q<4>(const float* p, float* q) {
  float4 v = *reinterpret_cast<const float4*>(p);
  q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
}

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
                          int S, int qt, int B, int D, int Dp, int k_pad) {
  constexpr int E = Pack<T>::kElemsPerWord;  // values per 32-bit word
  constexpr int VE = 4 * E;                  // values per 16-byte lane load
  constexpr int BLK = 32 * VE;               // values per warp-wide load

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
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool round_bf16 = E > 1;

  // Query tile -> shared memory. Within each BLK block the order is
  // (word u, lane, element e) instead of (lane, u, e), so that lane L's
  // values for word u sit at u*32*E + L*E: consecutive lanes, consecutive
  // addresses.
  for (int i = tid; i < QTM * Dp; i += kThreads) {
    const int q = i / Dp, d = i - q * Dp;
    float v = 0.f;
    if (q < qt && d < D) {
      v = queries[(size_t)(t * qt + q) * D + d];
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    const int blk = d / BLK, r = d - blk * BLK;
    const int l = r / VE, u = (r - l * VE) / E, e = r - l * VE - u * E;
    qs[(size_t)q * Dp + blk * BLK + u * 32 * E + l * E + e] = v;
  }
  for (int i = tid; i < QTM * k_pad; i += kThreads) {
    acc_s[i] = -CUDART_INF_F;
    acc_i[i] = -1;
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int bucket = schedule[(size_t)t * S + s];
    __syncthreads();  // every warp is done with the previous slot's mem/snap
    if (tid < QTM) mem[tid] = tid < qt ? member[((size_t)t * S + s) * qt + tid] : 0;
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int q = 0; q < QTM; ++q) any |= mem[q];
    if (!any) continue;  // schedule padding: no query probes this slot
    for (int i = tid; i < QTM * k_pad; i += kThreads) snap[i] = acc_i[i];
    const float scale = (E == 4) ? scales[bucket] : 1.f;
    const T* block = data + (size_t)bucket * B * D;

    for (int r0 = 0; r0 < B; r0 += kChunk) {
      const int nrows = min(kChunk, B - r0);
      __syncthreads();  // the previous chunk's merge is done with rid / ss
      const int my_id = tid < nrows ? ids[(size_t)bucket * B + r0 + tid] : -1;
      rid[tid] = my_id;
      if (!__syncthreads_or(my_id >= 0)) continue;  // all padding

      for (int g = warp * kRows; g < nrows; g += kWarps * kRows) {
        bool live[kRows];
        bool any_live = false;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          live[j] = (g + j < nrows) && rid[g + j] >= 0;
          any_live |= live[j];
        }
        float acc[QTM][kRows];
#pragma unroll
        for (int q = 0; q < QTM; ++q)
#pragma unroll
          for (int j = 0; j < kRows; ++j) acc[q][j] = 0.f;
        if (any_live) {
          for (int b0 = 0; b0 < Dp; b0 += BLK) {
            const int d0 = b0 + lane * VE;
            uint4 raw[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              raw[j] = make_uint4(0u, 0u, 0u, 0u);
              if (live[j] && d0 < D)
                raw[j] = __ldg(reinterpret_cast<const uint4*>(
                    block + (size_t)(r0 + g + j) * D + d0));
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float xv[kRows][E];
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                const uint32_t w = u == 0 ? raw[j].x : u == 1 ? raw[j].y
                                   : u == 2 ? raw[j].z : raw[j].w;
                widen<T>(w, xv[j]);
              }
              const float* qp = qs + b0 + u * 32 * E + lane * E;
#pragma unroll
              for (int q = 0; q < QTM; ++q) {
                float qv[E];
                load_q<E>(qp + (size_t)q * Dp, qv);
#pragma unroll
                for (int j = 0; j < kRows; ++j)
#pragma unroll
                  for (int e = 0; e < E; ++e)
                    acc[q][j] = fmaf(qv[e], xv[j][e], acc[q][j]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < QTM; ++q)
#pragma unroll
            for (int j = 0; j < kRows; ++j)
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
        }
        // Every lane now holds every sum; lane (q*kRows + j) % 32 writes it.
#pragma unroll
        for (int q = 0; q < QTM; ++q)
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (((q * kRows + j) & 31) == lane && g + j < nrows)
              ss[q * kChunk + g + j] = live[j] ? acc[q][j] * scale : -CUDART_INF_F;
      }
      __syncthreads();

      // Merge the chunk into each probing query's running top-k.
      for (int q = warp; q < qt; q += kWarps) {
        if (!mem[q]) continue;
        const int ex = exclude[t * qt + q];
        float* as = acc_s + q * k_pad;
        int* ai = acc_i + q * k_pad;
        const int* sn = snap + q * k_pad;
        for (int c0 = 0; c0 < nrows; c0 += 32) {
          const float thr = as[k_pad - 1];  // only rises while merging
          const int c = c0 + lane;
          float sc = -CUDART_INF_F;
          int id = -1;
          if (c < nrows) {
            id = rid[c];
            sc = ss[q * kChunk + c];
          }
          unsigned pass = __ballot_sync(0xffffffffu,
                                        id >= 0 && id != ex && sc > thr);
          while (pass) {
            const int src = __ffs(pass) - 1;
            pass &= pass - 1;
            const float cs = __shfl_sync(0xffffffffu, sc, src);
            const int cid = __shfl_sync(0xffffffffu, id, src);
            if (lane == 0) {
              bool dup = false;
              for (int j = 0; j < k_pad; ++j) dup |= sn[j] == cid;
              if (!dup && cs > as[k_pad - 1]) {
                int pos = k_pad - 1;
                while (pos > 0 && as[pos - 1] < cs) {
                  as[pos] = as[pos - 1];
                  ai[pos] = ai[pos - 1];
                  --pos;
                }
                as[pos] = cs;
                ai[pos] = cid;
              }
            }
            __syncwarp();
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < qt * k_pad; i += kThreads) {
    const int q = i / k_pad;
    out_scores[(size_t)(t * qt) * k_pad + i] = acc_s[q * k_pad + (i - q * k_pad)];
    out_ids[(size_t)(t * qt) * k_pad + i] = acc_i[q * k_pad + (i - q * k_pad)];
  }
}

template <typename T, int QTM>
cudaError_t launch(const float* queries, const void* data, const int* ids,
                   const float* scales, const int* schedule, const int* member,
                   const int* exclude, float* out_scores, int* out_ids,
                   int n_tiles, int S, int qt, int B, int D, int k_pad,
                   cudaStream_t stream) {
  constexpr int BLK = 32 * 4 * Pack<T>::kElemsPerWord;
  const int Dp = (D + BLK - 1) / BLK * BLK;
  const size_t smem = smem_bytes(QTM, Dp, k_pad);
  auto kern = bucket_score_tiled_kernel<T, QTM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n_tiles, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(data), ids, scales, schedule, member,
      exclude, out_scores, out_ids, S, qt, B, D, Dp, k_pad);
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
  if (qt < 1 || qt > 16 || k_pad < 1 || D % 16 != 0 || n_tiles < 1)
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

// Shared memory the kernel asks for, so the wrapper can size the tile.
size_t bucket_score_tiled_smem_bytes(int qtm, int D, int k_pad, int itemsize) {
  const int blk = 32 * 16 / itemsize;
  const int Dp = (D + blk - 1) / blk * blk;
  return smem_bytes(qtm, Dp, k_pad);
}

}  // extern "C"
