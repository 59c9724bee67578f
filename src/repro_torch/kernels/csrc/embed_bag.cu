// EmbeddingBag gather + reduce, for Hopper.
//
// Replaces embed_bag_kernel (src/repro/kernels/embed_bag/kernel.py:25,
// launched by pallas_call at src/repro/kernels/embed_bag/ops.py:41).
//
// What it computes. out[b] = sum over l of w[b, l] * table[idx[b, l]] for the
// slots with 0 <= idx[b, l] < V (-1 pads a bag; other ids are skipped, not
// read); combiner "mean" divides by max(number of valid slots, 1) — the
// weights do not count toward it. The (B, L, E) gathered rows never exist:
// each bag reads its rows once and writes one (E,) result. The sum is
// carried in fp32, slot by slot, and rounded to the table's dtype (fp32 or
// bf16) once, at the end, as the JAX package's XLA formulation does
// (embed_bag_jax); the TPU kernel accumulates in the table's dtype. A
// weight counts as it would after a cast to the table's dtype (a fp32
// weight for a bf16 table is rounded to bf16 first); no weights means 1.
//
// What bounds it on the H100: bytes — B * L rows of E values read and B * E
// written, no reuse. At the bench shape (B = 256, L = 16, E = 128, fp32)
// that is ~2.2 MB, well under a microsecond at 3.35 TB/s, so a call is
// bound by launch latency and by the host work around it.
//
// Design: one warp per bag, 8 bags per CTA. The lanes load the bag's
// indices (int32 or int64, no cast on the host) and weights 32 slots at a
// time in one coalesced load each, and count the valid slots with a ballot;
// then each slot's index and weight are broadcast with shuffles and its row
// is read 16 bytes a lane (4 fp32 or 8 bf16 values; value by value when a
// row is not 16-byte aligned), 8 slots unrolled so that 8 row loads are in
// flight before the first FMA. Bags with L > 32 loop over 32-slot groups,
// rows wider than one warp-wide load loop over column passes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBags = 8;     // bags (warps) per CTA
constexpr int kUnroll = 8;   // row loads in flight per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// The weight as the table's dtype holds it.
template <typename T, typename W>
__device__ __forceinline__ float weight_of(W w) {
  float v = to_f32(w);
  if (sizeof(T) == 2 && sizeof(W) == 4)
    v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Values of a 16-byte piece, widened; and the reverse, rounded once.
__device__ __forceinline__ void widen16(uint4 r, float (&x)[4], float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen16(uint4 r, float (&x)[8], __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 narrow16(const float (&x)[4], float) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
__device__ __forceinline__ uint4 narrow16(const float (&x)[8], __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1]))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// VEC: each lane covers VE = 16 / sizeof(T) consecutive columns with one
// 16-byte load (rows 16-byte aligned); otherwise one column a lane.
template <typename T, typename W, typename I, bool VEC>
__global__ void __launch_bounds__(32 * kBags)
embed_bag_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                 const W* __restrict__ w, T* __restrict__ out, int B, int L,
                 int V, int E, bool mean) {
  constexpr int VE = VEC ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kBags + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const I* bag = idx + (size_t)b * L;
  const W* bw = w != nullptr ? w + (size_t)b * L : nullptr;

  int valid = 0;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int l = l0 + lane;
    const long long r = l < L ? (long long)bag[l] : -1;
    valid += __popc(__ballot_sync(0xffffffffu, r >= 0 && r < V));
  }
  const float denom = mean ? fmaxf((float)valid, 1.f) : 1.f;

  for (int c0 = 0; c0 < E; c0 += 32 * VE) {
    const int col = c0 + lane * VE;
    const bool has_col = col < E;
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      int my_row = -1;
      float my_w = 1.f;
      if (lane < n) {
        const long long r = (long long)bag[l0 + lane];
        if (r >= 0 && r < V) my_row = (int)r;
        if (bw != nullptr) my_w = weight_of<T>(bw[l0 + lane]);
      }
      for (int u0 = 0; u0 < n; u0 += kUnroll) {
        int row[kUnroll];
        float wt[kUnroll];
        uint4 raw[kUnroll];  // VEC
        float one[kUnroll];  // !VEC
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = u0 + u;
          row[u] = __shfl_sync(0xffffffffu, my_row, src & 31);
          wt[u] = __shfl_sync(0xffffffffu, my_w, src & 31);
          if (src >= n) row[u] = -1;
          const T* p = table + (size_t)(row[u] < 0 ? 0 : row[u]) * E + col;
          if constexpr (VEC) {
            raw[u] = row[u] >= 0 && has_col
                         ? __ldg(reinterpret_cast<const uint4*>(p))
                         : make_uint4(0u, 0u, 0u, 0u);
          } else {
            one[u] = row[u] >= 0 && has_col ? to_f32(p[0]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (row[u] < 0) continue;  // warp-uniform
          if constexpr (VEC) {
            float x[VE];
            widen16(raw[u], x, T());
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[e] = fmaf(wt[u], x[e], acc[e]);
          } else {
            acc[0] = fmaf(wt[u], one[u], acc[0]);
          }
        }
      }
    }
    if (!has_col) continue;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = mean ? acc[e] / denom : acc[e];
    T* o = out + (size_t)b * E + col;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(o) = narrow16(acc, T());
    } else {
      from_f32(acc[0], o);
    }
  }
}

template <typename T, typename W, typename I>
cudaError_t launch(const void* table, const void* idx, const void* w,
                   void* out, int B, int L, int V, int E, bool mean,
                   cudaStream_t stream) {
  const bool vec = ((size_t)E * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((B + kBags - 1) / kBags), block(32 * kBags);
  const T* t = static_cast<const T*>(table);
  const I* i = static_cast<const I*>(idx);
  const W* ww = static_cast<const W*>(w);
  T* o = static_cast<T*>(out);
  if (vec)
    embed_bag_kernel<T, W, I, true><<<grid, block, 0, stream>>>(t, i, ww, o, B,
                                                               L, V, E, mean);
  else
    embed_bag_kernel<T, W, I, false><<<grid, block, 0, stream>>>(t, i, ww, o,
                                                                B, L, V, E, mean);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t by_index(int index_code, const void* table, const void* idx,
                     const void* w, void* out, int B, int L, int V, int E,
                     bool mean, cudaStream_t st) {
  switch (index_code) {
    case 0: return launch<T, W, int32_t>(table, idx, w, out, B, L, V, E, mean, st);
    case 1: return launch<T, W, int64_t>(table, idx, w, out, B, L, V, E, mean, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_weight(int weight_code, int index_code, const void* table,
                      const void* idx, const void* w, void* out, int B, int L,
                      int V, int E, bool mean, cudaStream_t st) {
  // no weights: the kernel reads none (W only types the null pointer)
  if (w == nullptr || weight_code == 0)
    return by_index<T, float>(index_code, table, idx, w, out, B, L, V, E,
                              mean, st);
  if (weight_code == 1)
    return by_index<T, __nv_bfloat16>(index_code, table, idx, w, out, B, L, V,
                                      E, mean, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype_code (table, out) and weight_code: 0 = float32, 1 = bfloat16;
// index_code: 0 = int32, 1 = int64; w may be null (weight 1); mean: 0 = sum,
// 1 = mean. Returns a cudaError_t.
int embed_bag_launch(const void* table, const void* idx, const void* w,
                     void* out, int B, int L, int V, int E, int dtype_code,
                     int index_code, int weight_code, int mean, void* stream) {
  if (B < 1 || L < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)by_weight<float>(weight_code, index_code, table, idx, w, out,
                                   B, L, V, E, mean != 0, st);
    case 1:
      return (int)by_weight<__nv_bfloat16>(weight_code, index_code, table, idx,
                                           w, out, B, L, V, E, mean != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
