// EmbeddingBag gather + reduce, for Hopper.
//
// Replaces embed_bag_kernel (src/repro/kernels/embed_bag/kernel.py:25,
// launched by pallas_call at src/repro/kernels/embed_bag/ops.py:41).
//
// What it computes. out[b] = sum over l of w[b, l] * table[idx[b, l]] for the
// slots with idx[b, l] >= 0 (-1 pads a bag); combiner "mean" divides by
// max(number of valid slots, 1) — the weights do not count toward it. The
// (B, L, E) gathered rows never exist: each bag reads its rows once and
// writes one (E,) result. The sum is carried in fp32 and rounded to the
// table's dtype (fp32 or bf16) once, at the end; the TPU kernel accumulates
// in the table's dtype, so a bf16 table differs from it by bf16 rounding.
// Weights arrive in the table's dtype, as the reference casts them.
//
// What bounds it on the H100: bytes — B * L rows of E values read and B * E
// written, no reuse. At the bench shape (B = 256, L = 16, E = 128, fp32)
// that is ~2.2 MB, well under a microsecond at 3.35 TB/s, so one launch is
// bound by its launch latency, not by the card.
//
// Design: one CTA per bag, its threads over E, a loop over the L slots
// (indices and weights of the bag are read by every thread, from L1).
// Ids outside [0, V) are skipped rather than read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void embed_bag_kernel(const T* __restrict__ table,
                                 const int* __restrict__ idx,
                                 const T* __restrict__ w, T* __restrict__ out,
                                 int V, int E, int L, bool mean) {
  const int b = blockIdx.x;
  const int* bag = idx + (size_t)b * L;
  const T* bw = w + (size_t)b * L;
  int valid = 0;
  for (int l = 0; l < L; ++l) valid += bag[l] >= 0 && bag[l] < V;
  const float denom = mean ? fmaxf((float)valid, 1.f) : 1.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int row = bag[l];
      if (row >= 0 && row < V)
        acc = fmaf(to_f32(bw[l]), to_f32(table[(size_t)row * E + e]), acc);
    }
    from_f32(mean ? acc / denom : acc, out + (size_t)b * E + e);
  }
}

template <typename T>
cudaError_t launch(const void* table, const int* idx, const void* w, void* out,
                   int B, int L, int V, int E, bool mean, cudaStream_t stream) {
  const int threads = E >= 256 ? 256 : ((E + 31) / 32) * 32;
  embed_bag_kernel<T><<<B, threads, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<const T*>(w),
      static_cast<T*>(out), V, E, L, mean);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16; mean: 0 = sum, 1 = mean.
// Returns a cudaError_t.
int embed_bag_launch(const void* table, const int* idx, const void* w,
                     void* out, int B, int L, int V, int E, int dtype_code,
                     int mean, void* stream) {
  if (B < 1 || L < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return (int)launch<float>(table, idx, w, out, B, L, V, E, mean != 0, st);
    case 1:
      return (int)launch<__nv_bfloat16>(table, idx, w, out, B, L, V, E,
                                        mean != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
