// The fp32 scoring core shared by bucket_score_tiled.cu and topk_score.cu:
// cp.async copies of 16-byte pieces into shared memory (bucket_score.cu
// uses those too), and the register-tiled product of one staged column
// stage of 128 rows against a few queries per warp on the CUDA cores (IEEE
// FMAs, never TF32).
//
// Layout both kernels stage: 128 rows of KE fp32 columns each, at a row
// stride of RS bytes, and the queries at a stride of QS floats. Lane L of a
// warp owns rows L, L + 32, L + 64, L + 96, so its 16-byte row loads are
// conflict-free when RS / 4 % 32 == 4 (RS = 144 for 128-byte stages, 272
// for 256-byte ones); the warp's QW queries are warp-wide broadcasts. Every
// 16-byte row load feeds 4 * QW FMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fp32_tile {

constexpr int kStageBytes = 128;  // bytes of each row per pipeline stage
constexpr int kStageCols = kStageBytes / 4;  // fp32 columns per stage
constexpr int kRowStride = kStageBytes + 16;  // 36 words: conflict-free

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The four fp32 values of a 16-byte piece.
__device__ __forceinline__ void widen4(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// acc[i][j] += query (q0 + i) . row (lane + 32 j) over the stage's KE
// columns: xb holds the stage's rows (stride RS bytes), qb its queries
// (stride QS floats). One FMA chain per (query, row) in column order.
template <int QW, int RS, int QS, int KE>
__device__ __forceinline__ void stage_fma(const unsigned char* xb,
                                          const float* qb, int q0, int lane,
                                          float (&acc)[QW][4]) {
#pragma unroll 2
  for (int c = 0; c < KE / 4; ++c) {
    float xv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      widen4(*reinterpret_cast<const uint4*>(xb + (lane + 32 * j) * RS +
                                             c * 16),
             xv[j]);
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qb + (q0 + i) * QS + c * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(qv.x, xv[j][0], acc[i][j]);
        acc[i][j] = fmaf(qv.y, xv[j][1], acc[i][j]);
        acc[i][j] = fmaf(qv.z, xv[j][2], acc[i][j]);
        acc[i][j] = fmaf(qv.w, xv[j][3], acc[i][j]);
      }
    }
  }
}

}  // namespace fp32_tile
