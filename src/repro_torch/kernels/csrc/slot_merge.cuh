// The slot-ordered merge shared by bucket_score_tiled.cu and bucket_score.cu
// (each library compiles its own copy).
//
// The scoring launch of both kernels writes, for every (tile, slot, query)
// of a segment, the masked scores of the slot's bucket rows to a global
// scratch laid out [tile][slot][query][row] (B rows) and each 128-row
// block's maximum to [tile][slot][query][block]. This launch replays the
// merge the TPU kernels ran in their sequential grid: one warp per query
// walks the segment's slots in order and merges every row block into the
// query's running top-k with score_topk.cuh's warp_merge (ties to the list,
// then to the lower row; ids already in the list before the slot are
// masked against a snapshot taken at the slot's first visited block). A
// block whose maximum does not beat the list's current last score is
// skipped without reading it: none of its candidates could enter (the
// threshold only rises), so the answers equal the sequential merge's.
// Lists live in shared memory (12 bytes an entry), or in the output buffers
// with a global snapshot when they do not fit; the lists carry over between
// segments in the output buffers (`first` initialises them).
//
// The tiled kernel passes its schedule and membership flags; v1 passes
// each query's probe list as a one-query tile's schedule and no flags
// (member == nullptr: the query probes every slot), and its instantiation
// keeps lists of up to 32 entries in registers (merge_lanes).

#pragma once

#include "score_topk.cuh"

namespace slot_merge {

constexpr int kRB = 128;  // rows of a scratch block (the scoring CTA's rows)

// v1's merge of one query (kLanes) when its list fits a warp (k_pad <= 32):
// the list and the snapshot are held one entry per lane for the whole walk,
// so a candidate's duplicate check is one vote, its insertion point a
// ballot count and the shift one shuffle (the same tie rule as warp_merge:
// it enters only above the list's last score, after every equal score),
// and a visited block's 128 scores and ids are loaded at once, 4 a lane.
// Each lane also loads its pairs' buckets beside their maxima.
__device__ __forceinline__ void merge_lanes(
    const float* __restrict__ scores, const float* __restrict__ bmax,
    const int* __restrict__ ids, const int* __restrict__ schedule,
    float* __restrict__ out_s, int* __restrict__ out_i, size_t row, int t,
    int tl, int q, int ex, int S, int s0, int S_seg, int qt, int B, int nrb,
    int k_pad, bool first) {
  const int lane = threadIdx.x;
  float ls = -CUDART_INF_F;
  int li = -1;
  if (!first && lane < k_pad) {
    ls = out_s[row * k_pad + lane];
    li = out_i[row * k_pad + lane];
  }
  float thr = __shfl_sync(0xffffffffu, ls, k_pad - 1);
  int snap = -1;  // this lane's entry of the list before the slot
  const int npairs = S_seg * nrb;
  int cur = -1;
  constexpr int kDepth = 4;
  for (int p0 = 0; p0 < npairs; p0 += 32 * kDepth) {
    float m[kDepth];
    int bk[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int p = p0 + u * 32 + lane;
      m[u] = -CUDART_INF_F;
      bk[u] = 0;
      if (p < npairs) {
        const int sl = p / nrb;
        m[u] = bmax[(((size_t)tl * S_seg + sl) * qt + q) * nrb + p % nrb];
        bk[u] = schedule[(size_t)t * S + s0 + sl];
      }
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      unsigned go = __ballot_sync(0xffffffffu, m[u] > thr);
      while (go) {
        const int src = __ffs(go) - 1;
        const int p = p0 + u * 32 + src;
        go &= go - 1;
        const int sl = p / nrb, rb = p % nrb;
        if (sl != cur) {  // first block of a slot: the list before the slot
          snap = li;
          cur = sl;
        }
        const int r0 = rb * kRB;
        const int n = min(kRB, B - r0);
        const float* cs =
            scores + (((size_t)tl * S_seg + sl) * qt + q) * B + r0;
        const int* cid =
            ids + (size_t)__shfl_sync(0xffffffffu, bk[u], src) * B + r0;
        float v[kRB / 32];
        int w[kRB / 32];
#pragma unroll
        for (int j = 0; j < kRB / 32; ++j) {
          const int c = lane + 32 * j;
          v[j] = c < n ? cs[c] : -CUDART_INF_F;
          w[j] = c < n ? cid[c] : -1;
        }
#pragma unroll
        for (int j = 0; j < kRB / 32; ++j) {
          unsigned pass = __ballot_sync(
              0xffffffffu, w[j] >= 0 && w[j] != ex && v[j] > thr);
          while (pass) {
            const int from = __ffs(pass) - 1;
            pass &= pass - 1;
            const float s = __shfl_sync(0xffffffffu, v[j], from);
            const int id = __shfl_sync(0xffffffffu, w[j], from);
            if (!(s > thr) || __any_sync(0xffffffffu, snap == id)) continue;
            const int pos =
                __popc(__ballot_sync(0xffffffffu, lane < k_pad && ls >= s));
            const float up_s = __shfl_up_sync(0xffffffffu, ls, 1);
            const int up_i = __shfl_up_sync(0xffffffffu, li, 1);
            if (lane > pos && lane < k_pad) {  // lanes past the list
              ls = up_s;                          // stay -inf / -1
              li = up_i;
            } else if (lane == pos) {
              ls = s;
              li = id;
            }
            thr = __shfl_sync(0xffffffffu, ls, k_pad - 1);
          }
        }
      }
    }
  }
  if (lane < k_pad) {
    out_s[row * k_pad + lane] = ls;
    out_i[row * k_pad + lane] = li;
  }
}

// One warp (CTA) per query of the tile group. Walks the segment's (slot,
// row block) pairs in order, 32 pairs per lane-wide load and four loads in
// flight, and merges each block that can change the list. kLanes (v1's
// instantiation) takes merge_lanes when the list fits a warp.
template <bool kLanes>
__global__ void __launch_bounds__(32)
slot_merge_kernel(const float* __restrict__ scores,
                  const float* __restrict__ bmax, const int* __restrict__ ids,
                  const int* __restrict__ schedule,
                  const int* __restrict__ member,
                  const int* __restrict__ exclude, float* __restrict__ out_s,
                  int* __restrict__ out_i, int* snap_g, int t0, int S, int s0,
                  int S_seg, int qt, int B, int nrb, int k_pad, bool first) {
  extern __shared__ __align__(16) float msmem[];
  const int lane = threadIdx.x;
  const int tl = blockIdx.x / qt;
  const int q = blockIdx.x % qt;
  const int t = t0 + tl;
  const size_t row = (size_t)t * qt + q;
  const int ex = exclude[row];
  if constexpr (kLanes) {
    if (k_pad <= 32) {  // v1: every query probes every slot (no member)
      merge_lanes(scores, bmax, ids, schedule, out_s, out_i, row, t, tl, q,
                  ex, S, s0, S_seg, qt, B, nrb, k_pad, first);
      return;
    }
  }
  const bool in_smem = snap_g == nullptr;
  float* as = in_smem ? msmem : out_s + row * k_pad;
  int* ai = in_smem ? reinterpret_cast<int*>(msmem + k_pad) : out_i + row * k_pad;
  int* snap = in_smem ? ai + k_pad : snap_g + row * k_pad;
  for (int j = lane; j < k_pad; j += 32) {
    const float s = first ? -CUDART_INF_F : out_s[row * k_pad + j];
    const int i = first ? -1 : out_i[row * k_pad + j];
    as[j] = s;
    ai[j] = i;
  }
  __syncwarp();
  const int npairs = S_seg * nrb;
  int cur = -1;  // the slot whose snapshot is taken
  constexpr int kDepth = 4;
  for (int p0 = 0; p0 < npairs; p0 += 32 * kDepth) {
    float m[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int p = p0 + u * 32 + lane;
      m[u] = -CUDART_INF_F;
      if (p < npairs) {
        const int sl = p / nrb;
        if (member == nullptr || member[((size_t)t * S + s0 + sl) * qt + q])
          m[u] = bmax[(((size_t)tl * S_seg + sl) * qt + q) * nrb + p % nrb];
      }
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      unsigned go = __ballot_sync(0xffffffffu, m[u] > as[k_pad - 1]);
      while (go) {
        const int p = p0 + u * 32 + __ffs(go) - 1;
        go &= go - 1;
        const int sl = p / nrb, rb = p % nrb;
        if (sl != cur) {  // first block of a slot: the list before the slot
          for (int j = lane; j < k_pad; j += 32) snap[j] = ai[j];
          __syncwarp();
          cur = sl;
        }
        const int bucket = schedule[(size_t)t * S + s0 + sl];
        const int r0 = rb * kRB;
        score_topk::warp_merge(
            scores + (((size_t)tl * S_seg + sl) * qt + q) * B + r0,
            ids + (size_t)bucket * B + r0, min(kRB, B - r0), ex, as, ai, snap,
            k_pad);
      }
    }
  }
  if (in_smem) {
    __syncwarp();
    for (int j = lane; j < k_pad; j += 32) {
      out_s[row * k_pad + j] = as[j];
      out_i[row * k_pad + j] = ai[j];
    }
  }
}

// Merge launch for tiles [t0, t0 + n_tiles_g) and slots [s0, s0 + S_seg) of
// an (n_tiles, S) schedule: the running lists are the (n_tiles * qt, k_pad)
// out_s / out_i, initialised when `first`. snap: null to keep the lists in
// shared memory, else an (n_tiles * qt, k_pad) int scratch and the lists
// stay in out_s / out_i. member: null when every query probes every slot.
template <bool kLanes>
inline cudaError_t launch(const float* scores, const float* bmax,
                          const int* ids, const int* schedule,
                          const int* member, const int* exclude, float* out_s,
                          int* out_i, int* snap, int t0, int n_tiles_g, int S,
                          int s0, int S_seg, int qt, int B, int k_pad,
                          bool first, cudaStream_t stream) {
  const int nrb = (B + kRB - 1) / kRB;
  const size_t msmem =
      snap == nullptr ? (sizeof(float) + 2 * sizeof(int)) * (size_t)k_pad : 0;
  cudaError_t err = cudaFuncSetAttribute(
      slot_merge_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)msmem);
  if (err != cudaSuccess) return err;
  slot_merge_kernel<kLanes><<<n_tiles_g * qt, 32, msmem, stream>>>(
      scores, bmax, ids, schedule, member, exclude, out_s, out_i, snap, t0, S,
      s0, S_seg, qt, B, nrb, k_pad, first);
  return cudaGetLastError();
}

}  // namespace slot_merge
