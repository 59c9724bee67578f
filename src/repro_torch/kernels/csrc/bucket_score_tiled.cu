// Query-tiled cluster-prune scoring with a fused running top-k, for Hopper.
//
// Replaces bucket_score_tiled_kernel (src/repro/kernels/bucket_score/kernel.py:100,
// launched by pallas_call at src/repro/kernels/bucket_score/ops.py:179).
//
// What it computes. For query tile t (qt <= 16 queries) and each slot s of
// the tile's deduplicated probe schedule, in order: score bucket
// schedule[t, s] (B rows of D values, fp32 / bf16 / int8) against the tile's
// queries with fp32 accumulation; mask a score to -inf when the query does
// not probe the bucket (member[t, s, q] == 0), when the row id is -1
// (padding), when the id equals exclude[q], or when the id is already in
// query q's running top-k (duplicates across the T clusterings); merge into
// a per-query (k_pad) running top-k. Precision follows the TPU kernel:
//   fp32 pack: fp32 query x fp32 row, fp32 accumulate, on the CUDA cores
//              (IEEE FMAs, never TF32), one FMA chain over the columns;
//   bf16 pack: the query is rounded to bf16 (RNE), bf16 x bf16 products on
//              the tensor cores (mma.sync m16n8k16), exact in fp32, fp32
//              accumulation;
//   int8 pack: int8 values widen to bf16 exactly, times the bf16-rounded
//              query, the same tensor-core product, THEN times
//              scales[bucket] (kernel.py:121-129).
// So only the summation order differs from the TPU kernel's and from the
// plain version.
//
// What bounds it on the H100: bytes. Each live (tile, slot) reads its
// bucket's live rows once — B*D*itemsize bytes — for 2*QT*D flops a row:
// 8 flops per fp32 byte at QT = 16, under the ~20 flop/byte ridge of the
// fp32 CUDA cores (and far under the tensor cores' for bf16 / int8), so the
// floor is the block bytes over 3.35 TB/s.
//
// Design: two launches on the caller's stream, no host sync between them.
//  1. Scoring (bucket_score_tiled_score). One CTA of 128 threads per work
//     item (tile, slot, block of 128 bucket rows): on the TPU the slot axis
//     ran in order carrying the top-k; here the scoring of every slot runs
//     at once over the whole card (the smoke batch: ~2,000 live CTAs where
//     one CTA per query tile ran 4). A slot no query of the tile probes, and a row
//     block whose ids are all -1, exit at once (padding may sit anywhere in
//     a bucket). A CTA computes its (16 queries x 128 rows) score block as a
//     small GEMM. fp32, on the CUDA cores with register tiling: warp w owns
//     queries 4w..4w+3, lane L rows L, L+32, L+64, L+96, so each thread
//     keeps 16 sums and every 16-byte shared load of a row feeds 16 FMAs
//     while the query values are warp-wide broadcasts. bf16 and int8, on the
//     tensor cores: warp w owns rows 32w..32w+31 as four m16n8k16 tiles
//     against all 16 queries (QT = 16 is exactly m16). Rows and queries
//     stream through shared memory in 128-byte column stages,
//     double-buffered with cp.async (rows and queries padded so that every
//     path's loads are conflict-free; dead rows and the D tail are
//     zero-filled, not read). Rows that are not 16-byte aligned
//     (D * itemsize % 16 != 0) load value by value instead. The
//     masked scores (member, id -1, exclude, x scale) go to a global scratch
//     laid out [tile][slot][query][row], so one query's rows of one slot are
//     contiguous, and each (query, row block) also writes its block maximum.
//  2. Merge (bucket_score_tiled_merge; the kernel lives in slot_merge.cuh,
//     shared with v1's bucket_score.cu). One warp per query walks its tile's
//     schedule in slot order and merges every row block into its running
//     top-k with the shared warp_merge (score_topk.cuh): the same tie rule,
//     and the same duplicate mask against a snapshot of the list taken
//     before each slot. A row block whose maximum does not beat the list's
//     current last score is skipped without reading it: none of its
//     candidates could enter (the threshold only rises), so skipping changes
//     nothing, and the snapshot taken at a slot's first visited block is
//     the list as it stood before the slot. The answers therefore equal the
//     sequential merge's — the reference's — for all three packs, including
//     int8, where one doc scores differently in different clusterings.
//     Lists live in shared memory, or in the output buffers (with a global
//     snapshot) when k_pad does not fit.
// The wrapper bounds the scratch: it runs the schedule in segments of
// slots (and groups of tiles), scoring then merging each, the lists
// carried in the output buffers between segments (`first` initialises
// them).
//
// Each entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch; nothing is allocated here.

#include "fp32_tile.cuh"
#include "slot_merge.cuh"

namespace {

using fp32_tile::cp_async16;
using fp32_tile::cp_async_commit;
using fp32_tile::cp_async_wait;

constexpr int kQT = 16;          // queries of a tile (rows of a score block)
constexpr int kRB = slot_merge::kRB;  // bucket rows per scoring CTA
constexpr int kST = 128;         // threads of a scoring CTA
constexpr int kStageBytes = 128;  // bytes of each row per pipeline stage
static_assert(kQT == 4 * (kST / 32), "each warp owns 4 queries");
static_assert(kRB == 4 * 32, "each lane owns 4 rows");

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return kStageBytes / (int)sizeof(T);
}
// A staged row in bytes, padded so that the loads of each path meet no bank
// conflict: 144 (36 words) for the fp32 path's 16-byte loads of rows L (lane
// L) and the int8 fragments' 4-byte loads of rows g (lane 4 g + tig); 160
// (40 words) for the bf16 fragments' 8-byte loads.
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 2 ? kStageBytes + 32 : kStageBytes + 16;
}
// A staged query row in floats, padded by 16 so that the tensor-core path's
// 16-byte loads of rows g and g + 1 fall in disjoint banks.
template <typename T>
__host__ __device__ constexpr int query_stride() {
  return stage_elems<T>() + 16;
}

// Dynamic shared memory of a scoring CTA: two row stages, two query stages
// (fp32), the block's ids, the tile's membership flags and each warp's
// per-query block maxima.
template <typename T>
__host__ __device__ constexpr size_t score_smem_bytes() {
  return 2 * (size_t)kRB * row_stride<T>() +
         2 * (size_t)kQT * query_stride<T>() * sizeof(float) +
         (size_t)(kRB + kQT) * sizeof(int) +
         (size_t)(kST / 32) * kQT * sizeof(float);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<int8_t> { using type = uint8_t; };

// Stage `st` (columns [st*KE, (st+1)*KE)) of the block's rows and of the
// tile's queries into shared memory. Aligned: 16-byte cp.async pieces (a
// dead row, a query past qt and a piece past D are zero-filled; the
// queries are rounded later, by the thread that copied them). Otherwise
// value by value, rounded here.
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* xs, float* qs,
                                           const T* block, const int* rid,
                                           int nrows, const float* queries,
                                           int qt, int D, int st, bool aligned,
                                           bool round) {
  constexpr int KE = stage_elems<T>();
  constexpr int KQ = query_stride<T>();
  constexpr int KV = 16 / (int)sizeof(T);
  constexpr int kRowStride = row_stride<T>();
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
    for (int i = tid; i < kQT * (KE / 4); i += kST) {
      const int q = i / (KE / 4), c = i % (KE / 4);
      const int d = d0 + c * 4;
      const bool ok = q < qt && d < D;
      const float* src = ok ? queries + (size_t)q * D + d : queries;
      cp_async16(qs + q * KQ + c * 4, src, ok ? 16 : 0);
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
    for (int i = tid; i < kQT * KE; i += kST) {
      const int q = i / KE, e = i % KE;
      const int d = d0 + e;
      float v = q < qt && d < D ? queries[(size_t)q * D + d] : 0.f;
      qs[q * KQ + e] = round ? round_bf16(v) : v;
    }
  }
}

// Two floats that bf16 holds exactly, packed lo | hi << 16.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16 bf16, row-major) x b (16 x 8 bf16, column-major), fp32
// accumulation on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Kernel 1: one (tile, slot, row block) per CTA. Grid: n_tiles_g * S_seg *
// nrb CTAs, tile-major. Scratch for this call: scores [n_tiles_g][S_seg][qt]
// [B] and bmax [n_tiles_g][S_seg][qt][nrb]; entries of a query that does
// not probe the slot are left unwritten (the merge never reads them).
template <typename T>
__global__ void __launch_bounds__(kST)
bucket_score_tiled_score_kernel(const float* __restrict__ queries,
                                const T* __restrict__ data,
                                const int* __restrict__ ids,
                                const float* __restrict__ scales,
                                const int* __restrict__ schedule,
                                const int* __restrict__ member,
                                const int* __restrict__ exclude,
                                float* __restrict__ scores,
                                float* __restrict__ bmax, int t0, int S,
                                int s0, int S_seg, int qt, int B, int D,
                                int nrb, bool aligned, bool round) {
  constexpr int KE = stage_elems<T>();
  constexpr int KQ = query_stride<T>();
  constexpr int kRowStride = row_stride<T>();
  constexpr bool kTensorCores = sizeof(T) < 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                          // [2][kRB][kRowStride]
  float* qs = reinterpret_cast<float*>(smem + 2 * kRB * kRowStride);
  int* rid = reinterpret_cast<int*>(qs + 2 * kQT * KQ);  // [kRB]
  int* mem = rid + kRB;                                   // [kQT]
  float* wmax = reinterpret_cast<float*>(mem + kQT);      // [kST / 32][kQT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = blockIdx.x % nrb;
  const int sl = blockIdx.x / nrb % S_seg;
  const int tl = blockIdx.x / nrb / S_seg;
  const int t = t0 + tl;
  const size_t slot = (size_t)t * S + s0 + sl;
  const int bucket = schedule[slot];
  const int r0 = rb * kRB;
  const int nrows = min(kRB, B - r0);

  int my_mem = 0;
  if (tid < kQT) {
    my_mem = tid < qt ? member[slot * qt + tid] != 0 : 0;
    mem[tid] = my_mem;
  }
  const int my_id = tid < nrows ? ids[(size_t)bucket * B + r0 + tid] : -1;
  rid[tid] = my_id;
  if (!__syncthreads_or(my_mem)) return;          // schedule padding
  const size_t base = ((size_t)tl * S_seg + sl) * qt;  // (tile, slot) scratch row
  if (!__syncthreads_or(my_id >= 0)) {            // all padding: nothing enters
    if (tid < qt && my_mem) bmax[(base + tid) * nrb + rb] = -CUDART_INF_F;
    return;
  }

  const T* block = data + ((size_t)bucket * B + r0) * D;
  const float* qtile = queries + (size_t)t * qt * D;
  const int nst = (int)(((size_t)D * sizeof(T) + kStageBytes - 1) / kStageBytes);
  // CUDA cores (fp32): acc[i][j] = (query 4 * warp + i, row lane + 32 j).
  // Tensor cores (bf16, int8): acc[n] is the m16n8 fragment of n-tile n,
  // rows 32 * warp + 8 n .. + 7: (query g, row 2 tig), (g, 2 tig + 1),
  // (g + 8, 2 tig), (g + 8, 2 tig + 1) with g = lane / 4, tig = lane % 4.
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int g = lane >> 2, tig = lane & 3;

  load_stage<T>(xs, qs, block, rid, nrows, qtile, qt, D, 0, aligned, round);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int buf = st & 1;
    if (st + 1 < nst) {
      load_stage<T>(xs + (buf ^ 1) * kRB * kRowStride, qs + (buf ^ 1) * kQT * KQ,
                    block, rid, nrows, qtile, qt, D, st + 1, aligned, round);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float* qb = qs + buf * kQT * KQ;
    if (aligned && round) {  // round the query pieces this thread copied
      for (int i = tid; i < kQT * (KE / 4); i += kST) {
        float4* p = reinterpret_cast<float4*>(qb + (i / (KE / 4)) * KQ) +
                    i % (KE / 4);
        float4 v = *p;
        v.x = round_bf16(v.x);
        v.y = round_bf16(v.y);
        v.z = round_bf16(v.z);
        v.w = round_bf16(v.w);
        *p = v;
      }
    }
    __syncthreads();
    const unsigned char* xb = xs + buf * kRB * kRowStride;
    if constexpr (kTensorCores) {
      // k16 steps over the stage. Within a step the 16 columns are taken in
      // the order 4 tig + {0, 1} for fragment columns 2 tig + {0, 1} and
      // 4 tig + {2, 3} for 2 tig + 8 + {0, 1}, in A and B alike (a
      // bijection of the step's columns, so the products are the same), so
      // each thread loads 4 consecutive values of a row with one load.
#pragma unroll 2
      for (int kk = 0; kk < KE / 16; ++kk) {
        const float4 qa = *reinterpret_cast<const float4*>(qb + g * KQ +
                                                           kk * 16 + tig * 4);
        const float4 qc = *reinterpret_cast<const float4*>(
            qb + (g + 8) * KQ + kk * 16 + tig * 4);
        const uint32_t a[4] = {bf16x2(qa.x, qa.y), bf16x2(qc.x, qc.y),
                               bf16x2(qa.z, qa.w), bf16x2(qc.z, qc.w)};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const unsigned char* xr = xb + (warp * 32 + n * 8 + g) * kRowStride;
          uint32_t b0, b1;
          if constexpr (sizeof(T) == 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(
                xr + (kk * 16 + tig * 4) * 2);
            b0 = v.x;
            b1 = v.y;
          } else {  // int8 values widen to bf16 exactly
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(xr + kk * 16 + tig * 4);
            b0 = bf16x2((float)(int8_t)(w & 0xffu),
                        (float)(int8_t)((w >> 8) & 0xffu));
            b1 = bf16x2((float)(int8_t)((w >> 16) & 0xffu),
                        (float)(int8_t)(w >> 24));
          }
          mma_bf16(acc[n], a, b0, b1);
        }
      }
    } else {  // fp32: one 16-byte piece of a row is 4 columns
      static_assert(kRowStride == fp32_tile::kRowStride, "shared layout");
      fp32_tile::stage_fma<4, kRowStride, KQ, KE>(xb, qb, warp * 4, lane,
                                                  acc);
    }
    __syncthreads();  // this buffer is refilled by the next stage's load
  }

  const float scale = scales != nullptr ? scales[bucket] : 1.f;
  if constexpr (kTensorCores) {
    // this thread holds queries g and g + 8 for rows 32 warp + 8 n + 2 tig
    // + {0, 1}; block maxima go through shared memory across the warps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = g + 8 * h;
      const int ex = q < qt ? exclude[(size_t)t * qt + q] : -1;
      float* out = scores + (base + q) * B + r0;
      float best = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = warp * 32 + n * 8 + tig * 2 + c;
          if (r < nrows) {
            const int id = rid[r];
            const float s = id >= 0 && id != ex ? acc[n][2 * h + c] * scale
                                                : -CUDART_INF_F;
            if (mem[q]) out[r] = s;
            best = fmaxf(best, s);
          }
        }
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 2));
      if (tig == 0) wmax[warp * kQT + q] = best;
    }
    __syncthreads();
    if (tid < qt && mem[tid]) {
      float best = wmax[tid];
#pragma unroll
      for (int w = 1; w < kST / 32; ++w) best = fmaxf(best, wmax[w * kQT + tid]);
      bmax[(base + tid) * nrb + rb] = best;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = warp * 4 + i;
      if (!mem[q]) continue;  // warp-uniform
      const int ex = exclude[(size_t)t * qt + q];
      float* out = scores + (base + q) * B + r0;
      float best = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        if (r < nrows) {
          const int id = rid[r];
          const float s = id >= 0 && id != ex ? acc[i][j] * scale : -CUDART_INF_F;
          out[r] = s;
          best = fmaxf(best, s);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
      if (lane == 0) bmax[(base + q) * nrb + rb] = best;
    }
  }
}

template <typename T>
cudaError_t launch_score(const float* queries, const void* data,
                         const int* ids, const float* scales,
                         const int* schedule, const int* member,
                         const int* exclude, float* scores, float* bmax,
                         int t0, int n_tiles_g, int S, int s0, int S_seg,
                         int qt, int B, int D, cudaStream_t stream) {
  const int nrb = (B + kRB - 1) / kRB;
  const size_t smem = score_smem_bytes<T>();
  const bool aligned = ((size_t)D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  auto kern = bucket_score_tiled_score_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)n_tiles_g * S_seg * nrb;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, kST, smem, stream>>>(
      queries, static_cast<const T*>(data), ids, scales, schedule, member,
      exclude, scores, bmax, t0, S, s0, S_seg, qt, B, D, nrb, aligned,
      sizeof(T) < 4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scoring launch over tiles [t0, t0 + n_tiles_g) and slots [s0, s0 + S_seg)
// of an (n_tiles, S) schedule. dtype_code: 0 = float32, 1 = bfloat16,
// 2 = int8; scales may be null (scale 1). Returns a cudaError_t.
int bucket_score_tiled_score(const float* queries, const void* data,
                             const int* ids, const float* scales,
                             const int* schedule, const int* member,
                             const int* exclude, float* scores, float* bmax,
                             int t0, int n_tiles_g, int S, int s0, int S_seg,
                             int qt, int B, int D, int dtype_code,
                             void* stream) {
  if (qt < 1 || qt > kQT || D < 1 || B < 1 || n_tiles_g < 1 || S_seg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)launch_score<float>(queries, data, ids, scales, schedule,
                                      member, exclude, scores, bmax, t0,
                                      n_tiles_g, S, s0, S_seg, qt, B, D, st);
    case 1:
      return (int)launch_score<__nv_bfloat16>(
          queries, data, ids, scales, schedule, member, exclude, scores, bmax,
          t0, n_tiles_g, S, s0, S_seg, qt, B, D, st);
    case 2:
      return (int)launch_score<int8_t>(queries, data, ids, scales, schedule,
                                       member, exclude, scores, bmax, t0,
                                       n_tiles_g, S, s0, S_seg, qt, B, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Merge launch for the same tiles and slots: the running lists are the
// (n_tiles * qt, k_pad) out_s / out_i, initialised when `first`. snap: null
// to keep the lists in shared memory (12 * k_pad bytes), else an
// (n_tiles * qt, k_pad) int scratch and the lists stay in out_s / out_i.
int bucket_score_tiled_merge(const float* scores, const float* bmax,
                             const int* ids, const int* schedule,
                             const int* member, const int* exclude,
                             float* out_s, int* out_i, int* snap, int t0,
                             int n_tiles_g, int S, int s0, int S_seg, int qt,
                             int B, int k_pad, int first, void* stream) {
  if (qt < 1 || qt > kQT || k_pad < 1 || B < 1 || n_tiles_g < 1 || S_seg < 1)
    return (int)cudaErrorInvalidValue;
  return (int)slot_merge::launch<false>(
      scores, bmax, ids, schedule, member, exclude, out_s, out_i, snap, t0,
      n_tiles_g, S, s0, S_seg, qt, B, k_pad, first != 0,
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one scoring CTA (the wrapper's pick_query_tile
// mirrors it). Returns 0 for an unknown dtype_code.
size_t bucket_score_tiled_score_smem(int dtype_code) {
  switch (dtype_code) {
    case 0: return score_smem_bytes<float>();
    case 1: return score_smem_bytes<__nv_bfloat16>();
    case 2: return score_smem_bytes<int8_t>();
    default: return 0;
  }
}

}  // extern "C"
