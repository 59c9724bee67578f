// Furthest-point-first (Gonzalez) rounds for Hopper: every round of one FPF
// run in one persistent cooperative launch.
//
// Replaces fpf_iter_kernel (src/repro/kernels/fpf_iter/kernel.py:25,
// launched by pallas_call at src/repro/kernels/fpf_iter/ops.py:36).
//
// What it computes. Round i over the m unit rows of x (m, D), given the
// newest center cur = centers[i - 1]: sim = x . x[cur] in fp32,
// maxsim = max(maxsim, sim), and the next center centers[i] is the FIRST
// argmin of maxsim over the rows, with its value in vals[i]. One launch runs
// rounds round0 .. k - 1; the single-round API is the same kernel with one
// round (round0 = 1, k = 2).
//
// What bounds it on the H100: bytes, then the grid barrier. A round reads
// the (m, D) rows for 2 m D flops, a quarter flop per byte. The TS2 build's
// sample is m = 10,000 rows of D = 4096 fp32, 164 MB: far more than the
// 132 CTAs' shared memory (30 MB) or the 50 MB L2, so in dense form nearly
// all of it streams from device memory every round (~41 us at 3.35 TB/s;
// ~52 us measured). Those rows are hashed tf-idf vectors, 91 % zeros: held
// as (value, column) pairs, a CTA's ~76 rows take ~170 KB and fit in its
// shared memory, so a round reads only shared memory and one center row.
//
// Design.
//  * One cooperative launch (cudaLaunchCooperativeKernel) of G CTAs of 512
//    threads, all co-resident, so they can wait on each other. CTA b owns
//    rows [b R, (b + 1) R) in every round. It keeps their maxsim values in
//    shared memory (in the output buffer when they do not fit), and holds as
//    many of its rows in shared memory as it can, read from device memory
//    once per launch; the rest stream from L2 / device memory each round.
//  * The CTA holds its rows in one of two forms, chosen in its prologue from
//    what it reads: dense ([cached][padded D], `cached` from the host's
//    plan) or compacted. To choose, its warps count the nonzeros (!= 0, so
//    both zeros are dropped) of its rows kWarps at a time, and take rows in
//    order while their compacted sizes fit `compact_bytes`; it compacts when
//    that holds more rows than the dense form does. Dense rows (the paper
//    shard's) stop after the first kWarps rows and run the dense form.
//  * A compacted row: the 32 lanes' nonzero counts (uint16), then the
//    columns (uint16, padded to 4 bytes), then the values (fp32). Lane l
//    owns the columns 4 l + 128 j + e (e < 4), as in the dense loop; its
//    s-th nonzero in column order sits at step s, after every lane's
//    entries of steps < s and after the entries of step s of the lanes
//    below it. Each round a lane walks its entries in column order, so the
//    warp reads consecutive words each step: acc = fmaf(v, center[col],
//    acc). An FMA whose product is an exact zero leaves an accumulator that
//    is not -0 as it is, and acc starts at +0, so skipping the zeros gives
//    the dense loop's sums bit for bit (at most the sign of a zero total
//    can differ, after a product underflows to -0; every comparison here
//    reads -0 as +0). Columns fit uint16: the host compacts only with the
//    center's row in shared memory, so D < 65,536.
//  * Per round, the CTA first copies the center's row into shared memory
//    (when it fits; else it is read from L2). Each warp then takes rows one
//    at a time, the streamed rows first (so their latency overlaps), then
//    the held ones: each lane sums its column slices with fp32 FMAs in
//    column order, the warp sums the lanes in a fixed butterfly, and lane
//    0's total is the row's similarity. A row's sum does not depend on its
//    form, where it is read from or which warp reads it, and there are no
//    float atomics anywhere, so the same inputs give the same bits on every
//    run and in every form.
//  * The CTA's minimum goes into the round's own 64-bit slot best[i] with
//    one atomicMin. The key's high word is the float mapped to an order-
//    preserving uint32 (-0.0 first made +0.0, as a comparison sees it),
//    its low word the row index, so the least value wins and then the
//    lowest row: torch.argmin's first-occurrence rule and the reference's
//    strict `<` fold (kernel.py:57). Then a grid barrier: an arrival
//    counter per round (arrive[i]; the wrapper zeroes both slot arrays, so
//    no slot is ever reset while in use). Every CTA then reads the winner
//    from best[i] as the next round's center; CTA 0 writes centers[i] and
//    vals[i].
//
// Launches on the caller's stream, allocates nothing, and returns a
// cudaError_t; a grid that cannot be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge), never run round by round.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountBytes = 64;  // a compacted row's 32 lane counts
// the least a held compacted row takes: its table entry, counts and entry
constexpr int kMinHeldBytes = 4 + kCountBytes + 8;

__host__ __device__ inline int padded_cols(int D) { return (D + 3) / 4 * 4; }

// The center's row in shared memory: D padded to whole 128-column blocks,
// so that the prologue can keep each warp's step tables there.
__host__ __device__ inline int center_cols(int D) {
  return (D + 127) / 128 * 128;
}

// A compacted row with nnz nonzeros: where its values start, and its bytes.
__host__ __device__ inline unsigned compact_vals_at(int nnz) {
  return kCountBytes + (2u * nnz + 3u) / 4u * 4u;
}

__host__ __device__ inline unsigned compact_row_bytes(int nnz) {
  return compact_vals_at(nnz) + 4u * nnz;
}

// Entries of the row-offset table at the head of the compacted region.
__host__ __device__ inline int table_rows(int rows, int compact_bytes) {
  return compact_bytes / kMinHeldBytes < rows ? compact_bytes / kMinHeldBytes
                                              : rows;
}

// The rows' region: the larger of the cached dense rows [cached][padded D]
// and the compacted region.
__host__ __device__ inline size_t rows_region(int cached, int D,
                                              int compact_bytes) {
  const size_t dense = sizeof(float) * (size_t)cached * padded_cols(D);
  return dense > (size_t)compact_bytes ? dense : (size_t)compact_bytes;
}

// Dynamic shared memory: the rows' region, the center's row when kept, each
// warp's key, 16 bytes of CTA state, then the maxsim values when kept.
__host__ __device__ inline size_t run_smem_bytes(int rows, int cached, int D,
                                                 bool center_in_smem,
                                                 bool ms_in_smem,
                                                 int compact_bytes) {
  return rows_region(cached, D, compact_bytes) +
         sizeof(float) * (center_in_smem ? center_cols(D) : 0) +
         sizeof(unsigned long long) * kWarps + 16 +
         (ms_in_smem ? sizeof(float) * (size_t)rows : 0);
}

__device__ __forceinline__ unsigned long long pack_key(float v, int row) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;  // -0.0 is +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)row;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// Four values of a row from column d on (d < D); zero past D.
__device__ __forceinline__ float4 load4(const float* p, int d, int D,
                                        bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(p + d));
  float4 v;
  v.x = __ldg(p + d);
  v.y = d + 1 < D ? __ldg(p + d + 1) : 0.f;
  v.z = d + 2 < D ? __ldg(p + d + 2) : 0.f;
  v.w = d + 3 < D ? __ldg(p + d + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The nonzeros among this lane's columns of a row.
__device__ __forceinline__ int lane_nonzeros(const float* row, int D,
                                             bool aligned, int lane) {
  int n = 0;
#pragma unroll 8
  for (int d = lane * 4; d < D; d += 128) {
    const float4 v = load4(row, d, D, aligned);
    n += (v.x != 0.f) + (v.y != 0.f) + (v.z != 0.f) + (v.w != 0.f);
  }
  return n;
}

// One warp writes `row` (D values) in compacted form at `out`; cnt is
// lane_nonzeros() of the row, and `steps` (2 words a step, as many as the
// lane with the most nonzeros has) the warp's scratch.
__device__ void compact_row(unsigned char* out, const float* row, int D,
                            bool aligned, int lane, int cnt,
                            unsigned* steps) {
  reinterpret_cast<uint16_t*>(out)[lane] = (uint16_t)cnt;
  const int nnz = __reduce_add_sync(kFull, cnt);
  const int n_steps = __reduce_max_sync(kFull, cnt);
  uint16_t* cols = reinterpret_cast<uint16_t*>(out + kCountBytes);
  float* vals = reinterpret_cast<float*>(out + compact_vals_at(nnz));
  // each step's lanes and where its entries start
  for (int s = 0, base = 0; s < n_steps; ++s) {
    const unsigned live = __ballot_sync(kFull, s < cnt);
    if (lane == 0) steps[2 * s] = live, steps[2 * s + 1] = base;
    base += __popc(live);
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  int s = 0;  // this lane's entries so far
#pragma unroll 4
  for (int d = lane * 4; d < D; d += 128) {
    const float4 v = load4(row, d, D, aligned);
    const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ve[e] != 0.f) {
        const int p = steps[2 * s + 1] + __popc(steps[2 * s] & below);
        cols[p] = (uint16_t)(d + e);
        vals[p] = ve[e];
        ++s;
      }
    }
  }
  __syncwarp();
}

// This lane's sum over a compacted row against the center cs, in the dense
// loop's column order.
__device__ __forceinline__ float compact_dot(const unsigned char* row,
                                             const float* cs, int lane) {
  const int cnt = reinterpret_cast<const uint16_t*>(row)[lane];
  const int nnz = __reduce_add_sync(kFull, cnt);
  const int all = __reduce_min_sync(kFull, cnt);  // steps every lane has
  const int steps = __reduce_max_sync(kFull, cnt);
  const uint16_t* cols = reinterpret_cast<const uint16_t*>(row + kCountBytes);
  const float* vals =
      reinterpret_cast<const float*>(row + compact_vals_at(nnz));
  float acc = 0.f;
  int s = 0;
#pragma unroll 4
  for (; s < all; ++s) {
    const int p = s * 32 + lane;
    acc = fmaf(vals[p], cs[cols[p]], acc);
  }
  // the steps some lanes lack, four at a time: their loads first, so that
  // they are in flight together, then the FMAs in column order
  const unsigned below = (1u << lane) - 1u;
  for (int base = all * 32; s < steps; s += 4) {
    int p[4];
    float v[4], c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned live = __ballot_sync(kFull, s + u < cnt);
      p[u] = base + __popc(live & below);
      base += __popc(live);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (s + u < cnt) v[u] = vals[p[u]], c[u] = cs[cols[p[u]]];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (s + u < cnt) acc = fmaf(v[u], c[u], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
fpf_run_kernel(const float* __restrict__ x, const float* __restrict__ ms_in,
               float* __restrict__ ms_out, int* __restrict__ centers,
               float* __restrict__ vals, unsigned long long* best,
               unsigned int* arrive, unsigned int* held_rows, int m, int D,
               int rows_per_cta, int cached, bool center_in_smem,
               bool ms_in_smem, int compact_bytes, int round0, int k,
               bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_cols(D);
  float* xs = reinterpret_cast<float*>(smem);  // dense: [cached][Dp]
  // compacted: the table of row offsets, then the rows
  unsigned* tab = reinterpret_cast<unsigned*>(smem);
  const int tr_all = table_rows(rows_per_cta, compact_bytes);
  unsigned char* held = smem + sizeof(unsigned) * tr_all;
  float* cs = reinterpret_cast<float*>(  // the center's row when kept
      smem + rows_region(cached, D, compact_bytes));
  unsigned long long* wkey = reinterpret_cast<unsigned long long*>(
      cs + (center_in_smem ? center_cols(D) : 0));
  // CTA state: the current center, rows held compacted, bytes they take,
  // and whether the next row did not fit
  int* state = reinterpret_cast<int*>(wkey + kWarps);
  float* ms_s = reinterpret_cast<float*>(state + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned int G = gridDim.x;
  const int row0 = blockIdx.x * rows_per_cta;
  const int R = min(rows_per_cta, m - row0);
  float* ms = ms_in_smem ? ms_s : ms_out + row0;
  const float* xb = x + (size_t)row0 * D;

  for (int i = tid; i < R; i += kThreads)
    ms[i] = ms_in != nullptr ? ms_in[row0 + i] : -CUDART_INF_F;
  if (tid == 0) {
    state[0] = centers[round0 - 1];
    state[1] = state[2] = state[3] = 0;
  }
  __syncthreads();

  // Count, place and compact rows kWarps at a time while they fit; each
  // warp's step tables lie in the center's row, not yet in use.
  unsigned* scratch =
      reinterpret_cast<unsigned*>(cs) + warp * (center_cols(D) / kWarps);
  const int tr = min(tr_all, R);
  const unsigned budget =
      (unsigned)compact_bytes - sizeof(unsigned) * (unsigned)tr_all;
  for (int t0 = 0; t0 < tr; t0 += kWarps) {
    const int t = t0 + warp;
    int cnt = 0;
    if (t < tr) {
      cnt = lane_nonzeros(xb + (size_t)t * D, D, aligned, lane);
      const int n = __reduce_add_sync(kFull, cnt);
      if (lane == 0) tab[t] = compact_row_bytes(n);
    }
    __syncthreads();
    if (tid == 0) {
      unsigned used = (unsigned)state[2];
      for (int u = t0; u < min(t0 + kWarps, tr); ++u) {
        const unsigned bytes = tab[u];
        if (used + bytes > budget) {
          state[3] = 1;
          break;
        }
        tab[u] = used;
        used += bytes;
        state[1] = u + 1;
      }
      state[2] = (int)used;
    }
    __syncthreads();
    if (t < state[1])
      compact_row(held + tab[t], xb + (size_t)t * D, D, aligned, lane, cnt,
                  scratch);
    if (state[3]) break;
  }
  __syncthreads();
  const bool compact = state[1] > min(cached, R);
  const int nc = compact ? state[1] : min(cached, R);
  const int ns = R - nc;  // streamed rows: local rows nc .. R - 1
  if (compact) {
    if (tid == 0 && held_rows != nullptr) atomicAdd(held_rows, (unsigned)nc);
  } else if (aligned) {
    const int q = Dp / 4;
    for (int i = tid; i < nc * q; i += kThreads) {
      const int r = i / q, c = i - r * q;
      reinterpret_cast<float4*>(xs)[i] =
          __ldg(reinterpret_cast<const float4*>(xb + (size_t)r * D) + c);
    }
  } else {
    for (int i = tid; i < nc * Dp; i += kThreads) {
      const int r = i / Dp, d = i - r * Dp;
      xs[i] = d < D ? xb[(size_t)r * D + d] : 0.f;
    }
  }
  __syncthreads();

  for (int i = round0; i < k; ++i) {
    const float* c = x + (size_t)state[0] * D;
    if (center_in_smem) {
      for (int d = tid * 4; d < Dp; d += 4 * kThreads)
        *reinterpret_cast<float4*>(cs + d) = load4(c, d, D, aligned);
      __syncthreads();
    }
    unsigned long long mykey = ~0ull;
    // streamed rows first, then the held ones, round robin over the warps
    for (int t = warp; t < R; t += kWarps) {
      const int r = t < ns ? nc + t : t - ns;
      float acc = 0.f;
      if (r < nc && compact) {
        acc = compact_dot(held + tab[r], cs, lane);
      } else if (r < nc) {
        const float* row = xs + (size_t)r * Dp;
        if (center_in_smem) {
#pragma unroll 4
          for (int d = lane * 4; d < D; d += 128)
            acc = dot4(*reinterpret_cast<const float4*>(row + d),
                       *reinterpret_cast<const float4*>(cs + d), acc);
        } else {
#pragma unroll 4
          for (int d = lane * 4; d < D; d += 128)
            acc = dot4(*reinterpret_cast<const float4*>(row + d),
                       load4(c, d, D, aligned), acc);
        }
      } else {
        const float* row = xb + (size_t)r * D;
        if (center_in_smem) {
#pragma unroll 4
          for (int d = lane * 4; d < D; d += 128)
            acc = dot4(load4(row, d, D, aligned),
                       *reinterpret_cast<const float4*>(cs + d), acc);
        } else {
#pragma unroll 4
          for (int d = lane * 4; d < D; d += 128)
            acc = dot4(load4(row, d, D, aligned), load4(c, d, D, aligned),
                       acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) {  // lane 0's sum, the same every run
        const float v = fmaxf(ms[r], acc);
        ms[r] = v;
        const unsigned long long key = pack_key(v, row0 + r);
        mykey = key < mykey ? key : mykey;
      }
    }
    if (lane == 0) wkey[warp] = mykey;
    __syncthreads();
    if (tid == 0) {
      unsigned long long b = wkey[0];
      for (int w = 1; w < kWarps; ++w) b = wkey[w] < b ? wkey[w] : b;
      atomicMin(best + i, b);
      __threadfence();
      atomicAdd(arrive + i, 1u);
      while (*reinterpret_cast<volatile unsigned int*>(arrive + i) < G)
        __nanosleep(32);
      __threadfence();
      const unsigned long long win = atomicOr(best + i, 0ull);
      state[0] = (int)(uint32_t)win;
      if (blockIdx.x == 0) {
        centers[i] = (int)(uint32_t)win;
        vals[i] = key_value(win);
      }
    }
    __syncthreads();
  }
  if (ms_in_smem)
    for (int i = tid; i < R; i += kThreads) ms_out[row0 + i] = ms[i];
}

}  // namespace

extern "C" {

size_t fpf_iter_smem_bytes(int rows_per_cta, int cached, int D,
                           int center_in_smem, int ms_in_smem,
                           int compact_bytes) {
  return run_smem_bytes(rows_per_cta, cached, D, center_in_smem != 0,
                        ms_in_smem != 0, compact_bytes);
}

unsigned fpf_iter_compact_row_bytes(int nnz) { return compact_row_bytes(nnz); }

int fpf_iter_table_rows(int rows_per_cta, int compact_bytes) {
  return table_rows(rows_per_cta, compact_bytes);
}

// Rounds round0 .. k - 1 in one cooperative launch of `grid` CTAs of
// rows_per_cta rows each (the last may hold fewer). A CTA holds `cached` of
// its rows dense in shared memory, or, when compacting holds more, as many
// as fit compact_bytes in compacted form (0: never; a multiple of 16, only
// with center_in_smem); the center's row is copied to shared memory when
// center_in_smem. ms_in may be null (every maxsim starts at -inf); ms_out
// (m,) receives the final maxsim. best (k,) must hold ~0 and arrive (k,) 0;
// held_rows, when not null, gains the rows held compacted.
int fpf_iter_launch(const float* x, const float* ms_in, float* ms_out,
                    int* centers, float* vals, unsigned long long* best,
                    unsigned int* arrive, unsigned int* held_rows, int m,
                    int D, int grid, int rows_per_cta, int cached,
                    int center_in_smem, int ms_in_smem, int compact_bytes,
                    int round0, int k, void* stream) {
  if (m < 1 || D < 1 || grid < 1 || rows_per_cta < 1 || cached < 0 ||
      cached > rows_per_cta || (long long)grid * rows_per_cta < m ||
      (long long)(grid - 1) * rows_per_cta >= m || round0 < 1 ||
      k <= round0 || compact_bytes < 0 || compact_bytes % 16 != 0 ||
      (compact_bytes > 0 && (center_in_smem == 0 || D > 65536)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      run_smem_bytes(rows_per_cta, cached, D, center_in_smem != 0,
                     ms_in_smem != 0, compact_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      fpf_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fpf_run_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if ((long long)per_sm * sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const bool aligned = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bool c_smem = center_in_smem != 0, in_smem = ms_in_smem != 0;
  void* args[] = {&x,      &ms_in,   &ms_out,   &centers,       &vals,
                  &best,   &arrive,  &held_rows, &m,            &D,
                  &rows_per_cta, &cached, &c_smem, &in_smem, &compact_bytes,
                  &round0, &k,       (void*)&aligned};
  err = cudaLaunchCooperativeKernel((const void*)fpf_run_kernel, dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
