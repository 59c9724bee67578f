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
// What bounds it on the H100: bytes. A round reads the (m, D) rows once for
// 2 m D flops, a quarter flop per byte. At the build's m = 5,622, D = 2048
// the rows are 46 MB: a round from device memory would take 14 us, less
// than the cost of launching it twice from Python, which was what the
// earlier design (two launches a round) paid.
//
// Design.
//  * One cooperative launch (cudaLaunchCooperativeKernel) of G CTAs of 512
//    threads, all co-resident, so they can wait on each other. CTA b owns
//    rows [b R, (b + 1) R) in every round. It keeps their maxsim values in
//    shared memory (in the output buffer when they do not fit), and as many
//    of their rows as its shared memory holds: those are read from device
//    memory once per launch, the rest stream from L2 each round (the
//    build's sample is under the 50 MB L2).
//  * Per round, the CTA first copies the center's row into shared memory
//    (when it fits; else it is read from L2). Each warp then takes rows one
//    at a time, the streamed rows first (at most about one a warp, so their
//    L2 latency overlaps), then the cached ones: each lane sums its 16-byte
//    column slices with fp32 FMAs in a fixed order, the warp sums the lanes
//    in a fixed butterfly, and lane 0's total is the row's similarity. A
//    row's sum does not depend on where it is read from or which warp reads
//    it, and there are no float atomics anywhere, so the same inputs give
//    the same bits on every run.
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

__host__ __device__ inline int padded_cols(int D) { return (D + 3) / 4 * 4; }

// Dynamic shared memory: the cached rows [cached][padded D], the center's
// row [padded D] when kept, each warp's key, the current center's index
// (16 bytes), then the maxsim values when kept.
__host__ __device__ inline size_t run_smem_bytes(int rows, int cached, int D,
                                                 bool center_in_smem,
                                                 bool ms_in_smem) {
  return sizeof(float) * ((size_t)cached + center_in_smem) * padded_cols(D) +
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

__global__ void __launch_bounds__(kThreads, 1)
fpf_run_kernel(const float* __restrict__ x, const float* __restrict__ ms_in,
               float* __restrict__ ms_out, int* __restrict__ centers,
               float* __restrict__ vals, unsigned long long* best,
               unsigned int* arrive, int m, int D, int rows_per_cta,
               int cached, bool center_in_smem, bool ms_in_smem, int round0,
               int k, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_cols(D);
  float* xs = reinterpret_cast<float*>(smem);  // [cached][Dp]
  float* cs = xs + (size_t)cached * Dp;        // [Dp] when center_in_smem
  unsigned long long* wkey = reinterpret_cast<unsigned long long*>(
      cs + (center_in_smem ? Dp : 0));
  int* cur_s = reinterpret_cast<int*>(wkey + kWarps);
  float* ms_s = reinterpret_cast<float*>(cur_s + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned int G = gridDim.x;
  const int row0 = blockIdx.x * rows_per_cta;
  const int R = min(rows_per_cta, m - row0);
  const int nc = min(cached, R);
  const int ns = R - nc;  // streamed rows: local rows nc .. R - 1
  float* ms = ms_in_smem ? ms_s : ms_out + row0;
  const float* xb = x + (size_t)row0 * D;

  for (int i = tid; i < R; i += kThreads)
    ms[i] = ms_in != nullptr ? ms_in[row0 + i] : -CUDART_INF_F;
  if (aligned) {
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
  if (tid == 0) *cur_s = centers[round0 - 1];
  __syncthreads();

  for (int i = round0; i < k; ++i) {
    const float* c = x + (size_t)(*cur_s) * D;
    if (center_in_smem) {
      for (int d = tid * 4; d < Dp; d += 4 * kThreads)
        *reinterpret_cast<float4*>(cs + d) = load4(c, d, D, aligned);
      __syncthreads();
    }
    unsigned long long mykey = ~0ull;
    // streamed rows first, then the cached ones, round robin over the warps
    for (int t = warp; t < R; t += kWarps) {
      const int r = t < ns ? nc + t : t - ns;
      float acc = 0.f;
      if (r < nc) {
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
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
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
      *cur_s = (int)(uint32_t)win;
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
                           int center_in_smem, int ms_in_smem) {
  return run_smem_bytes(rows_per_cta, cached, D, center_in_smem != 0,
                        ms_in_smem != 0);
}

// Rounds round0 .. k - 1 in one cooperative launch of `grid` CTAs of
// rows_per_cta rows each (the last may hold fewer), `cached` of them kept in
// shared memory, and the center's row too when center_in_smem. ms_in may be null (every maxsim starts at -inf); ms_out
// (m,) receives the final maxsim. best (k,) must hold ~0 and arrive (k,) 0.
int fpf_iter_launch(const float* x, const float* ms_in, float* ms_out,
                    int* centers, float* vals, unsigned long long* best,
                    unsigned int* arrive, int m, int D, int grid,
                    int rows_per_cta, int cached, int center_in_smem,
                    int ms_in_smem, int round0, int k, void* stream) {
  if (m < 1 || D < 1 || grid < 1 || rows_per_cta < 1 || cached < 0 ||
      cached > rows_per_cta || (long long)grid * rows_per_cta < m ||
      (long long)(grid - 1) * rows_per_cta >= m || round0 < 1 || k <= round0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = run_smem_bytes(rows_per_cta, cached, D,
                                     center_in_smem != 0, ms_in_smem != 0);
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
  void* args[] = {&x,      &ms_in,  &ms_out,  &centers, &vals,
                  &best,   &arrive, &m,       &D,       &rows_per_cta,
                  &cached, &c_smem, &in_smem, &round0,  &k,
                  (void*)&aligned};
  err = cudaLaunchCooperativeKernel((const void*)fpf_run_kernel, dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
