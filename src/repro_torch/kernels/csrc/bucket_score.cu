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
// scale (the v1 kernel has no scales operand): q . float(int8 row). IEEE
// FMAs on the CUDA cores, never TF32.
//
// What bounds it on the H100: bytes. A probed bucket's live rows have to be
// read once; a bucket several queries probe serves them all from that read,
// for 2 flops per value and query — 0.5 to 8 flops per fp32 byte for 1 to
// 16 queries, under the fp32 ridge (~20).
//
// Design: the probe lists are inverted on the device, then two launches on
// the caller's stream, no host sync anywhere.
//  0. Inversion: the nq * P entries (q, p) are stable-sorted by (segment,
//     bucket) with torch.sort, so the entries that probe one bucket sit
//     together in (q, p) order; bucket_score_v1_groups cuts each run into
//     groups of at most kG = 16 entries: gsize[e] is the group's size at
//     its first sorted entry and 0 elsewhere.
//  1. Scoring (bucket_score_v1_score). One CTA of 128 threads per (sorted
//     entry, block of 128 bucket rows); a CTA whose entry does not start a
//     group exits at once, as does a block whose ids are all -1. The CTA
//     reads its block once and scores it against the group's <= 16 fp32
//     query rows: warp w owns rows 32w..32w+31, one row a lane, and every
//     query of the group, so each value is widened once (bf16 by a shift,
//     int8 by a byte permute and an exact float subtraction) and feeds one
//     FMA per query; the body is instantiated for groups of 1, 2, 4, 8 and
//     16 so a small group does no padded work. Rows and queries stream
//     through shared memory in 128-byte column stages, double-buffered with
//     cp.async (fp32_tile.cuh); dead rows and the D tail are zero-filled,
//     not read; rows that are not 16-byte aligned load value by value. The
//     masked scores (id -1, exclude) go to a global scratch laid out
//     [q][p][row], with each (q, p, row block)'s maximum: exactly the
//     tiled kernel's [tile][slot][query][row] scratch for one-query tiles.
//  2. Merge (bucket_score_v1_merge): the tiled kernel's slot-ordered merge
//     (slot_merge.cuh) with each query's probe list as its schedule, so the
//     probes merge in order with the same tie rule and duplicate mask, and
//     blocks that cannot enter are skipped. v1's instantiation keeps a list
//     of up to 32 entries (and its snapshot) in registers, one entry a
//     lane: in shared memory, its insertions took 0.18 ms of the smoke's
//     batch (H100 80GB HBM3, 700 W; PERF.md), in registers 0.05.
// The wrapper bounds the scratch to segments of probe slots (and groups of
// queries) as it does for the tiled kernel; the lists carry over between
// segments in the output buffers.
//
// Each entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch; nothing is allocated here.

#include "fp32_tile.cuh"
#include "slot_merge.cuh"

namespace {

using fp32_tile::cp_async16;
using fp32_tile::cp_async_commit;
using fp32_tile::cp_async_wait;

constexpr int kG = 16;            // entries (queries) of a group at most
constexpr int kRB = slot_merge::kRB;  // bucket rows per scoring CTA
constexpr int kST = 128;          // threads of a scoring CTA
constexpr int kWarps = kST / 32;
constexpr int kStageBytes = 128;  // bytes of each row per pipeline stage
// A staged row in bytes: 36 words, so the 16-byte loads of rows L (lane L)
// meet no bank conflict.
constexpr int kRowStride = kStageBytes + 16;
static_assert(kRB == kST, "one row a thread");

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return kStageBytes / (int)sizeof(T);
}

// Dynamic shared memory of a scoring CTA: two row stages, two query stages
// (fp32, kG rows of a stage's columns), the block's ids, the group's query
// rows, scratch rows and excluded ids, and each warp's per-query maxima.
template <typename T>
__host__ __device__ constexpr size_t score_smem_bytes() {
  return 2 * (size_t)kRB * kRowStride +
         2 * (size_t)kG * stage_elems<T>() * sizeof(float) +
         (size_t)(kRB + 3 * kG) * sizeof(int) +
         (size_t)kWarps * kG * sizeof(float);
}

template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<int8_t> { using type = uint8_t; };

// The 16 / sizeof(T) values of a 16-byte piece, widened to fp32 exactly.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& raw, float* out) {
  fp32_tile::widen4(raw, out);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw,
                                                       float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    out[2 * u] = __uint_as_float(w[u] << 16);
    out[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}
// int8: byte b as the float 2^23 + (b + 128) (offset binary in the low
// mantissa bits), minus 2^23 + 128: exact, one permute and one add.
template <>
__device__ __forceinline__ void widen16<int8_t>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t v = w[u] ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[4 * u + e] =
          __uint_as_float(__byte_perm(v, 0x4b000000u, 0x7440u | e)) -
          8388736.f;
  }
}

// Stage `st` (columns [st*KE, (st+1)*KE)) of the block's rows and of the
// group's first QN query rows (rows qrow[i], zero past the group's g)
// into shared memory. Aligned: 16-byte cp.async pieces, a dead row and a
// piece past D zero-filled. Otherwise value by value.
template <typename T, int QN>
__device__ __forceinline__ void load_stage(unsigned char* xs, float* qs,
                                           const T* block, const int* rid,
                                           int nrows, const float* queries,
                                           const int* qrow, int g, int D,
                                           int st, bool aligned) {
  constexpr int KE = stage_elems<T>();
  constexpr int KV = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int d0 = st * KE;
  if (aligned) {
    for (int i = tid; i < kRB * (kStageBytes / 16); i += kST) {
      const int r = i / (kStageBytes / 16), c = i % (kStageBytes / 16);
      const int d = d0 + c * KV;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      const T* src = ok ? block + (size_t)r * D + d : block;
      cp_async16(xs + r * kRowStride + c * 16, src, ok ? 16 : 0);
    }
    for (int i = tid; i < QN * (KE / 4); i += kST) {
      const int q = i / (KE / 4), c = i % (KE / 4);
      const int d = d0 + c * 4;
      const bool ok = q < g && d < D;
      const float* src = ok ? queries + (size_t)qrow[q] * D + d : queries;
      cp_async16(qs + q * KE + c * 4, src, ok ? 16 : 0);
    }
  } else {
    using U = typename Raw<T>::type;
    const U* rows = reinterpret_cast<const U*>(block);
    for (int i = tid; i < kRB * KE; i += kST) {
      const int r = i / KE, e = i % KE;
      const int d = d0 + e;
      const bool ok = r < nrows && rid[r] >= 0 && d < D;
      reinterpret_cast<U*>(xs + r * kRowStride)[e] =
          ok ? rows[(size_t)r * D + d] : (U)0;
    }
    for (int i = tid; i < QN * KE; i += kST) {
      const int q = i / KE, e = i % KE;
      const int d = d0 + e;
      qs[q * KE + e] = q < g && d < D ? queries[(size_t)qrow[q] * D + d] : 0.f;
    }
  }
}

// The CTA's (QN queries x 128 rows) block, g <= QN of the queries live:
// acc[i] = query i . row (32 warp + lane), one FMA chain per (query, row) in
// column order; then the masked scores and block maxima to the scratch.
template <typename T, int QN>
__device__ __forceinline__ void score_block(
    unsigned char* xs, float* qs, const int* rid, const int* qrow,
    const int* orow, const int* exq, float* wmax, const T* block, int nrows,
    const float* queries, int g, int B, int D, int nrb, int rb,
    bool aligned, float* __restrict__ scores, float* __restrict__ bmax) {
  constexpr int KE = stage_elems<T>();
  constexpr int KV = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nst =
      (int)(((size_t)D * sizeof(T) + kStageBytes - 1) / kStageBytes);
  float acc[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) acc[i] = 0.f;

  load_stage<T, QN>(xs, qs, block, rid, nrows, queries, qrow, g, D, 0,
                    aligned);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int buf = st & 1;
    if (st + 1 < nst) {
      load_stage<T, QN>(xs + (buf ^ 1) * kRB * kRowStride,
                        qs + (buf ^ 1) * kG * KE, block, rid, nrows, queries,
                        qrow, g, D, st + 1, aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* xr = xs + buf * kRB * kRowStride + tid * kRowStride;
    const float* qb = qs + buf * kG * KE;
#pragma unroll 2
    for (int c = 0; c < kStageBytes / 16; ++c) {
      float xv[KV];
      widen16<T>(*reinterpret_cast<const uint4*>(xr + c * 16), xv);
#pragma unroll
      for (int i = 0; i < QN; ++i) {
#pragma unroll
        for (int u = 0; u < KV / 4; ++u) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qb + i * KE + c * KV + 4 * u);
          acc[i] = fmaf(qv.x, xv[4 * u], acc[i]);
          acc[i] = fmaf(qv.y, xv[4 * u + 1], acc[i]);
          acc[i] = fmaf(qv.z, xv[4 * u + 2], acc[i]);
          acc[i] = fmaf(qv.w, xv[4 * u + 3], acc[i]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next stage's load
  }

  const int id = tid < nrows ? rid[tid] : -1;
  const int r0 = rb * kRB;
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    if (i >= g) break;  // CTA-uniform
    const float s = id >= 0 && id != exq[i] ? acc[i] : -CUDART_INF_F;
    if (tid < nrows) scores[(size_t)orow[i] * B + r0 + tid] = s;
    float best = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) wmax[warp * kG + i] = best;
  }
  __syncthreads();
  if (tid < g) {
    float best = wmax[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) best = fmaxf(best, wmax[w * kG + tid]);
    bmax[(size_t)orow[tid] * nrb + rb] = best;
  }
}

// Scoring launch: one CTA per (sorted entry e0 + e, row block rb). order[e]
// is the flat index q * P + p of the e-th sorted entry, gsize[e] its
// group's size at the group's first entry and 0 elsewhere. Scratch for the
// segment (queries [t0, t0 + ...), slots [s0, s0 + S_seg)): scores
// [q - t0][p - s0][B] and bmax [q - t0][p - s0][nrb].
template <typename T>
__global__ void __launch_bounds__(kST)
bucket_score_v1_score_kernel(const float* __restrict__ queries,
                             const T* __restrict__ data,
                             const int* __restrict__ ids,
                             const int* __restrict__ probes,
                             const int* __restrict__ exclude,
                             const int* __restrict__ order,
                             const int* __restrict__ gsize,
                             float* __restrict__ scores,
                             float* __restrict__ bmax, int e0, int P, int t0,
                             int s0, int S_seg, int B, int D, int nrb,
                             bool aligned) {
  constexpr int KE = stage_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;  // [2][kRB][kRowStride]
  float* qs = reinterpret_cast<float*>(smem + 2 * kRB * kRowStride);
  int* rid = reinterpret_cast<int*>(qs + 2 * kG * KE);  // qs: [2][kG][KE]
  int* qrow = rid + kRB;                                 // [kG] query rows
  int* orow = qrow + kG;                                 // [kG] scratch rows
  int* exq = orow + kG;                                  // [kG] excluded ids
  float* wmax = reinterpret_cast<float*>(exq + kG);      // [kWarps][kG]

  const int tid = threadIdx.x;
  const int e = e0 + blockIdx.x / nrb;
  const int rb = blockIdx.x % nrb;
  const int g = gsize[e];
  if (g == 0) return;  // not the first entry of a group
  const int bucket = probes[order[e]];
  const int r0 = rb * kRB;
  const int nrows = min(kRB, B - r0);
  if (tid < g) {
    const int f = order[e + tid];
    const int q = f / P, p = f % P;
    qrow[tid] = q;
    orow[tid] = (q - t0) * S_seg + (p - s0);
    exq[tid] = exclude[q];
  }
  const int my_id = tid < nrows ? ids[(size_t)bucket * B + r0 + tid] : -1;
  rid[tid] = my_id;
  if (!__syncthreads_or(my_id >= 0)) {  // all padding: nothing enters
    if (tid < g) bmax[(size_t)orow[tid] * nrb + rb] = -CUDART_INF_F;
    return;
  }
  const T* block = data + ((size_t)bucket * B + r0) * D;
#define V1_SCORE(QN)                                                        \
  score_block<T, QN>(xs, qs, rid, qrow, orow, exq, wmax, block, nrows,      \
                     queries, g, B, D, nrb, rb, aligned, scores, bmax)
  if (g <= 1) V1_SCORE(1);
  else if (g <= 2) V1_SCORE(2);
  else if (g <= 4) V1_SCORE(4);
  else if (g <= 8) V1_SCORE(8);
  else V1_SCORE(16);
#undef V1_SCORE
}

// Inversion's last step: for the n sorted keys (segment * K + bucket),
// gsize[e] = the size of the group that starts at e, 0 where none does. A
// run of one key is cut into groups of kG from its first entry, found by
// a binary search (the lower bound of keys[e] in [0, e]). One thread an
// entry.
__global__ void bucket_score_v1_groups_kernel(
    const long long* __restrict__ keys, int* __restrict__ gsize, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long k = keys[e];
  int lo = 0, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  int g = 0;
  if ((e - lo) % kG == 0) {
    g = 1;
    while (g < kG && e + g < n && keys[e + g] == k) ++g;
  }
  gsize[e] = g;
}

template <typename T>
cudaError_t launch_score(const float* queries, const void* data,
                         const int* ids, const int* probes,
                         const int* exclude, const int* order,
                         const int* gsize, float* scores, float* bmax, int e0,
                         int n_e, int P, int t0, int s0, int S_seg, int B,
                         int D, cudaStream_t stream) {
  const int nrb = (B + kRB - 1) / kRB;
  const size_t smem = score_smem_bytes<T>();
  const bool aligned = ((size_t)D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  auto kern = bucket_score_v1_score_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)n_e * nrb;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, kST, smem, stream>>>(
      queries, static_cast<const T*>(data), ids, probes, exclude, order,
      gsize, scores, bmax, e0, P, t0, s0, S_seg, B, D, nrb, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The group sizes of the n sorted inversion keys. Returns a cudaError_t.
int bucket_score_v1_groups(const long long* keys, int* gsize, int n,
                           void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  bucket_score_v1_groups_kernel<<<(n + 255) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      keys, gsize, n);
  return (int)cudaGetLastError();
}

// Scoring launch over the sorted entries [e0, e0 + n_e) of one segment
// (queries from t0, slots [s0, s0 + S_seg)). dtype_code: 0 = float32,
// 1 = bfloat16, 2 = int8. Returns a cudaError_t.
int bucket_score_v1_score(const float* queries, const void* data,
                          const int* ids, const int* probes,
                          const int* exclude, const int* order,
                          const int* gsize, float* scores, float* bmax,
                          int e0, int n_e, int P, int t0, int s0, int S_seg,
                          int B, int D, int dtype_code, void* stream) {
  if (n_e < 1 || P < 1 || S_seg < 1 || B < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)launch_score<float>(queries, data, ids, probes, exclude,
                                      order, gsize, scores, bmax, e0, n_e, P,
                                      t0, s0, S_seg, B, D, st);
    case 1:
      return (int)launch_score<__nv_bfloat16>(
          queries, data, ids, probes, exclude, order, gsize, scores, bmax, e0,
          n_e, P, t0, s0, S_seg, B, D, st);
    case 2:
      return (int)launch_score<int8_t>(queries, data, ids, probes, exclude,
                                       order, gsize, scores, bmax, e0, n_e, P,
                                       t0, s0, S_seg, B, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Merge launch for queries [t0, t0 + n_q) and slots [s0, s0 + S_seg): the
// shared slot merge with one-query tiles, schedule = probes (nq, P) and no
// membership flags. snap: null to keep the lists in shared memory, else an
// (nq, k_pad) int scratch.
int bucket_score_v1_merge(const float* scores, const float* bmax,
                          const int* ids, const int* probes,
                          const int* exclude, float* out_s, int* out_i,
                          int* snap, int t0, int n_q, int P, int s0,
                          int S_seg, int B, int k_pad, int first,
                          void* stream) {
  if (n_q < 1 || P < 1 || S_seg < 1 || B < 1 || k_pad < 1)
    return (int)cudaErrorInvalidValue;
  return (int)slot_merge::launch<true>(
      scores, bmax, ids, probes, nullptr, exclude, out_s, out_i, snap, t0,
      n_q, P, s0, S_seg, 1, B, k_pad, first != 0,
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one scoring CTA (ops.v1_smem_bytes mirrors it).
// Returns 0 for an unknown dtype_code.
size_t bucket_score_v1_score_smem(int dtype_code) {
  switch (dtype_code) {
    case 0: return score_smem_bytes<float>();
    case 1: return score_smem_bytes<__nv_bfloat16>();
    case 2: return score_smem_bytes<int8_t>();
    default: return 0;
  }
}

}  // extern "C"
