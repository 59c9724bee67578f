// The warp merge shared by the port's top-k kernels (topk_score.cu, and
// slot_merge.cuh, the merge launch of bucket_score_tiled.cu and
// bucket_score.cu): scored candidates into a sorted running top-k.
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

// One warp merges candidates c < n (scores cs[c], ids cid[c]) into the sorted
// list (as, ai) of length k_pad: a ballot against the list's last score
// filters 32 candidates at a time (an id is read only for a candidate that
// passes), then the survivors enter in candidate order. Skipped: id < 0,
// id == ex, and (when snap is not null) ids present in snap[0..k_pad) — the
// list as it stood before the bucket. The duplicate check, the insertion
// point (the count of entries >= the score: after equal scores) and the
// shift run across the warp's lanes. The list may live in shared or in
// global memory.
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
      sc = cs[c];
      if (sc > thr) id = cid[c];
    }
    unsigned pass = __ballot_sync(0xffffffffu, id >= 0 && id != ex && sc > thr);
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float s = __shfl_sync(0xffffffffu, sc, src);
      const int i = __shfl_sync(0xffffffffu, id, src);
      bool dup = false;
      if (snap != nullptr)
        for (int j = lane; j < k_pad; j += 32) dup |= snap[j] == i;
      if (__any_sync(0xffffffffu, dup) || !(s > as[k_pad - 1])) continue;
      unsigned ahead = 0;  // entries that stay in front: score >= s
      for (int j = lane; j < k_pad; j += 32) ahead += as[j] >= s;
      const int pos = (int)__reduce_add_sync(0xffffffffu, ahead);
      // shift [pos, k_pad - 1) one place back, 32 entries at a time from
      // the end: each round reads before any lane writes
      for (int top = k_pad - 1; top > pos; top -= 32) {
        const int j = top - lane;
        float vs = 0.f;
        int vi = 0;
        if (j > pos) {
          vs = as[j - 1];
          vi = ai[j - 1];
        }
        __syncwarp();
        if (j > pos) {
          as[j] = vs;
          ai[j] = vi;
        }
        __syncwarp();
      }
      if (lane == 0) {
        as[pos] = s;
        ai[pos] = i;
      }
      __syncwarp();
    }
  }
}

}  // namespace score_topk
