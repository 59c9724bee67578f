// Device building blocks shared by the scoring kernels of the port
// (bucket_score_tiled.cu, bucket_score.cu, topk_score.cu): loading 16-byte
// slices of fp32 / bf16 / int8 rows with a zero tail, a warp's dot products
// of a few rows against a tile of queries held in shared memory, and the
// warp merge of scored candidates into a sorted running top-k.
//
// Tie rule of every merge here: a candidate enters a list only if its score
// is STRICTLY greater than the list's last score, and it is placed after
// every equal score. Candidates arrive in id / slot order, so the list ends
// up ordered as lax.top_k orders [accumulator, candidates]: descending, ties
// to the earlier arrival. Entries at -inf keep id -1.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace score_topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;     // rows a warp scores at once
constexpr int kChunk = 256;  // rows per streamed chunk (one id per thread)
static_assert(kChunk == kThreads, "each thread loads one id per chunk");

template <typename T> struct Pack;
template <> struct Pack<float> { static constexpr int kElemsPerWord = 1; };
template <> struct Pack<__nv_bfloat16> { static constexpr int kElemsPerWord = 2; };
template <> struct Pack<int8_t> { static constexpr int kElemsPerWord = 4; };

// Values per 16-byte lane load, and per warp-wide load.
template <typename T>
__host__ __device__ constexpr int lane_vals() { return 4 * Pack<T>::kElemsPerWord; }
template <typename T>
__host__ __device__ constexpr int warp_vals() { return 32 * lane_vals<T>(); }

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

__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t raw_bits(int8_t v) { return (uint32_t)(uint8_t)v; }

// The 16 bytes of values of `row` from column d0 on; columns at or past D
// read as zero. `aligned`: the row starts on a 16-byte boundary and D fills
// whole 16-byte words, so one vector load does; otherwise value by value.
template <typename T>
__device__ __forceinline__ uint4 load_vals(const T* row, int d0, int D,
                                           bool aligned) {
  constexpr int E = Pack<T>::kElemsPerWord;
  constexpr int VE = lane_vals<T>();
  if (d0 >= D) return make_uint4(0u, 0u, 0u, 0u);
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(row + d0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VE; ++e)
    if (d0 + e < D) w[e / E] |= raw_bits(row[d0 + e]) << ((32 / E) * (e % E));
  return make_uint4(w[0], w[1], w[2], w[3]);
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

// Width of one query row in shared memory: D padded to a warp-wide load.
template <typename T>
__host__ __device__ inline int padded_width(int D) {
  return (D + warp_vals<T>() - 1) / warp_vals<T>() * warp_vals<T>();
}

// Query rows [row0, row0 + nvalid) of the (., D) fp32 `queries` -> shared
// memory `qs` ([QTM][Dp], zero past D and past nvalid). Within each
// warp-wide block of values the order is (word u, lane, element e) instead
// of (lane, u, e), so lane L's values for word u sit at u*32*E + L*E:
// consecutive lanes read consecutive addresses. `round_bf16` rounds each
// value to bf16 (RNE) first. Called by the whole block; no barrier inside.
template <typename T>
__device__ void store_queries(float* qs, const float* queries, size_t row0,
                              int nvalid, int QTM, int D, int Dp,
                              bool round_bf16) {
  constexpr int E = Pack<T>::kElemsPerWord;
  constexpr int VE = lane_vals<T>();
  constexpr int BLK = warp_vals<T>();
  for (int i = threadIdx.x; i < QTM * Dp; i += blockDim.x) {
    const int q = i / Dp, d = i - q * Dp;
    float v = 0.f;
    if (q < nvalid && d < D) {
      v = queries[(row0 + q) * (size_t)D + d];
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    const int blk = d / BLK, r = d - blk * BLK;
    const int l = r / VE, u = (r - l * VE) / E, e = r - l * VE - u * E;
    qs[(size_t)q * Dp + blk * BLK + u * 32 * E + l * E + e] = v;
  }
}

// One warp: dot products of rows base + j*D (j < R, live[j]) with the QTM
// queries in `qs` (layout of store_queries), fp32 fused multiply-adds, each
// lane over its 16-byte column slices, then reduced across the warp. On
// return every lane holds every sum; rows that are not live sum to 0.
template <typename T, int QTM, int R>
__device__ __forceinline__ void warp_dots(const T* base, int D, int Dp,
                                          bool aligned, const bool (&live)[R],
                                          const float* qs,
                                          float (&acc)[QTM][R]) {
  constexpr int E = Pack<T>::kElemsPerWord;
  constexpr int VE = lane_vals<T>();
  constexpr int BLK = warp_vals<T>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < QTM; ++q)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[q][j] = 0.f;
  for (int b0 = 0; b0 < Dp; b0 += BLK) {
    const int d0 = b0 + lane * VE;
    uint4 raw[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      raw[j] = live[j] ? load_vals<T>(base + (size_t)j * D, d0, D, aligned)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[R][E];
#pragma unroll
      for (int j = 0; j < R; ++j) {
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
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[q][j] = fmaf(qv[e], xv[j][e], acc[q][j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QTM; ++q)
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
}

// One warp merges candidates c < n (scores cs[c], ids cid[c]) into the sorted
// list (as, ai) of length k_pad: a ballot against the list's last score
// filters 32 candidates at a time, then lane 0 inserts the survivors in
// candidate order. Skipped: id < 0, id == ex, and (when snap is not null)
// ids present in snap[0..k_pad) — the list as it stood before the bucket.
// The list may live in shared or in global memory.
__device__ __forceinline__ void warp_merge(const float* cs, const int* cid,
                                           int n, int ex, float* as, int* ai,
                                           const int* snap, int k_pad) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const float thr = as[k_pad - 1];  // only rises while merging
    const int c = c0 + lane;
    float sc = -CUDART_INF_F;
    int id = -1;
    if (c < n) {
      id = cid[c];
      sc = cs[c];
    }
    unsigned pass = __ballot_sync(0xffffffffu, id >= 0 && id != ex && sc > thr);
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float s = __shfl_sync(0xffffffffu, sc, src);
      const int i = __shfl_sync(0xffffffffu, id, src);
      if (lane == 0) {
        bool dup = false;
        if (snap != nullptr)
          for (int j = 0; j < k_pad; ++j) dup |= snap[j] == i;
        if (!dup && s > as[k_pad - 1]) {
          int pos = k_pad - 1;
          while (pos > 0 && as[pos - 1] < s) {
            as[pos] = as[pos - 1];
            ai[pos] = ai[pos - 1];
            --pos;
          }
          as[pos] = s;
          ai[pos] = i;
        }
      }
      __syncwarp();
    }
  }
}

// The whole block scores one bucket (B rows of D values at `block`, ids
// `bids`, -1 padding) against the query tile in `qs` and merges it into the
// running top-k of every query q < qt with mem[q] != 0. Row ids are masked
// against snap, a copy of the lists taken here before the bucket, exactly as
// the TPU kernels mask against the accumulator before a bucket's merge; so
// streaming the bucket in chunks changes nothing (ids within a bucket are
// unique). Scores are multiplied by `scale` (int8 packs). Shared scratch:
// ss [QTM][kChunk] scores, rid [kChunk] ids. Starts and ends with a barrier.
template <typename T, int QTM>
__device__ void scan_bucket(const T* block, const int* bids, int B, int D,
                            int Dp, bool aligned, float scale,
                            const float* qs, const int* mem, int qt,
                            const int* exclude, float* acc_s, int* acc_i,
                            int* snap, int k_pad, float* ss, int* rid) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // previous bucket's merges are done with the lists
  for (int i = tid; i < QTM * k_pad; i += kThreads) snap[i] = acc_i[i];

  for (int r0 = 0; r0 < B; r0 += kChunk) {
    const int nrows = min(kChunk, B - r0);
    __syncthreads();  // the previous chunk's merge is done with rid / ss
    const int my_id = tid < nrows ? bids[r0 + tid] : -1;
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
      if (any_live) {
        warp_dots<T, QTM, kRows>(block + (size_t)(r0 + g) * D, D, Dp, aligned,
                                 live, qs, acc);
      }
      // Every lane holds every sum; lane (q*kRows + j) % 32 writes it.
#pragma unroll
      for (int q = 0; q < QTM; ++q)
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (((q * kRows + j) & 31) == lane && g + j < nrows)
            ss[q * kChunk + g + j] = live[j] ? acc[q][j] * scale : -CUDART_INF_F;
    }
    __syncthreads();

    for (int q = warp; q < qt; q += kWarps) {
      if (!mem[q]) continue;
      warp_merge(ss + q * kChunk, rid, nrows, exclude[q], acc_s + q * k_pad,
                 acc_i + q * k_pad, snap + q * k_pad, k_pad);
    }
  }
  __syncthreads();
}

}  // namespace score_topk
