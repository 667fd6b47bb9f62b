// Fused approximate earth mover's distance (approxmatch + match cost):
// (B, n, 3), (B, m, 3) f32 clouds -> (B,) f32 costs, not divided by n.
//
// Nine annealing levels, level = -4^(7 - li). With K_ij = exp(level * d_ij) and
// d_ij = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0), each level does
//   pass A  ratioL_i = remainL_i / (1e-9 + sum_j K_ij remainR_j)
//   pass B  sumr_j   = (sum_i K_ij ratioL_i) * remainR_j
//           rr_j     = min(remainR_j / (sumr_j + 1e-9), 1) * remainR_j
//           remainR_j = max(0, remainR_j - sumr_j)
//   pass C  cost    += sum_ij ratioL_i K_ij rr_j sqrt(d_ij)
//           remainL_i = max(0, remainL_i - ratioL_i * sum_j K_ij rr_j)
// which is metrics/distance.py::earth_mover_distance of this package, term by term.
//
// Replaces the Pallas TPU kernel dusty_gan_v2_tpu/metrics/pallas_emd.py::_build_kernel
// (called through emd_pallas), which keeps sqrt(D) and K for the whole pair resident in
// VMEM (2 x 16 MB at 2048 x 2048) and computes exp once per level. An SM has 227 KB, so
// nothing of that layout carries over: here D and K are never stored at all.
//
// Bound on the H100: operations. A pair moves 48 KB in and 4 B out but needs
// 9 * n * m exponentials (38 M at 2048 x 2048) on the special-function units plus
// about ten f32 operations per element and level. This kernel recomputes d and exp in
// each of the three passes, so it does about three times the exponentials the bound
// counts; keeping K across passes is the first thing a faster version would do.
// Design: one block per pair. Both clouds (as float4 x, y, z, |p|^2) and the four state
// vectors remainL, ratioL, remainR, rr live in dynamic shared memory, 24 (n + m) bytes
// (96 KB at 2048 + 2048, two blocks to an SM). In passes A and C a thread owns kRows
// rows i and walks all columns j; in pass B it owns kRows columns and walks all rows.
// So every sum of a pass is private to a thread, all threads of a warp read the same
// walked point (a shared-memory broadcast), and the only cross-thread traffic is two
// barriers a level and the final reduction of the cost.
//
// Numerics. At level 0 the exponent is -16384 d, so an absolute error of 1e-7 in d (the
// cancellation error of the |x|^2 + |y|^2 - 2xy form on O(1) coordinates) moves K by
// 1e-3. The plain version therefore fixes the order of every operation in d, and this
// kernel repeats it with rounded intrinsics that the compiler may not contract:
// xy = (x0 y0 + x1 y1) + x2 y2, d = max((|x|^2 + |y|^2) - 2 xy, 0), the same bits in
// all three passes and in the plain version. exp is expf (no fast-math flag, so it is
// the function torch.exp calls on the card). The products that feed the clamped
// subtractions (sumr, ratioL * acc) are rounded before the subtraction, as in the plain
// version. Row and column sums are taken serially in a thread, in runs of kRun terms
// folded into a total, so their rounding error grows with kRun + n / kRun rather than n;
// their order still differs from the plain version's, which is why the two are compared
// with a relative bar and not bit by bit. Elsewhere the compiler is free to use FMA.
//
// C interface (ctypes): launches on the given stream, does not synchronise, returns
// the CUDA error code. Inputs are contiguous (B, n, 3) and (B, m, 3) f32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;   // points a thread owns in one sweep
constexpr int kRun = 128;  // terms summed serially before folding into the total
constexpr int kLevels = 9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqdist(const float4 a, const float4 b) {
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                             __fmul_rn(a.z, b.z));
  return fmaxf(__fsub_rn(__fadd_rn(a.w, b.w), __fmul_rn(2.f, ab)), 0.f);
}

// For the kRows points own[base + r * kThreads + tid] of this thread:
//   acc[r] = sum_j K(own_r, other_j) * w[j]
//   cst[r] = sum_j K(own_r, other_j) * w[j] * sqrt(d(own_r, other_j))   (kCost only)
// Points past n_own are clamped to the last one; the caller drops their sums.
template <bool kCost>
__device__ __forceinline__ void sweep(const float4* __restrict__ own, int n_own,
                                      const float4* __restrict__ other,
                                      const float* __restrict__ w, int n_other, float level,
                                      int base, float (&acc)[kRows], float (&cst)[kRows]) {
  float4 p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p[r] = own[min(base + r * kThreads + static_cast<int>(threadIdx.x), n_own - 1)];
    acc[r] = 0.f;
    cst[r] = 0.f;
  }
  for (int j0 = 0; j0 < n_other; j0 += kRun) {
    const int j1 = min(j0 + kRun, n_other);
    float run_acc[kRows], run_cst[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      run_acc[r] = 0.f;
      run_cst[r] = 0.f;
    }
#pragma unroll 2
    for (int j = j0; j < j1; ++j) {
      const float4 q = other[j];
      const float wj = w[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d = sqdist(p[r], q);
        const float kw = expf(level * d) * wj;
        run_acc[r] += kw;
        if (kCost) run_cst[r] += kw * sqrtf(d);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] += run_acc[r];
      if (kCost) cst[r] += run_cst[r];
    }
  }
}

__device__ __forceinline__ float4 load_point(const float* __restrict__ p) {
  const float x = p[0], y = p[1], z = p[2];
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(x, y, z, sq);
}

__global__ void __launch_bounds__(kThreads, 2)
emd_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
           float* __restrict__ cost, int n, int m) {
  extern __shared__ float4 smem[];
  float4* xs = smem;                                    // n
  float4* ys = xs + n;                                  // m
  float* remainL = reinterpret_cast<float*>(ys + m);    // n
  float* ratioL = remainL + n;                          // n
  float* remainR = ratioL + n;                          // m
  float* rr = remainR + m;                              // m
  __shared__ float s_part[kThreads / 32];

  const int tid = threadIdx.x;
  const float* x_in = xyz1 + static_cast<int64_t>(blockIdx.x) * n * 3;
  const float* y_in = xyz2 + static_cast<int64_t>(blockIdx.x) * m * 3;
  // integer division, as in the approxmatch kernel this metric comes from
  const float multiL = n >= m ? 1.f : static_cast<float>(m / n);
  const float multiR = n >= m ? static_cast<float>(n / m) : 1.f;
  for (int i = tid; i < n; i += kThreads) {
    xs[i] = load_point(x_in + 3 * i);
    remainL[i] = multiL;
  }
  for (int j = tid; j < m; j += kThreads) {
    ys[j] = load_point(y_in + 3 * j);
    remainR[j] = multiR;
  }
  __syncthreads();

  float my_cost = 0.f;
  float level = -16384.f;  // -4^7, then a quarter of it each level: exact in f32
  float acc[kRows], cst[kRows];
  for (int li = 0; li < kLevels; ++li, level *= 0.25f) {
    // pass A: rows against the right side's remaining supply
    for (int base = 0; base < n; base += kThreads * kRows) {
      sweep<false>(xs, n, ys, remainR, m, level, base, acc, cst);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + tid;
        if (i < n) ratioL[i] = remainL[i] / (1e-9f + acc[r]);
      }
    }
    __syncthreads();
    // pass B: columns consume
    for (int base = 0; base < m; base += kThreads * kRows) {
      sweep<false>(ys, m, xs, ratioL, n, level, base, acc, cst);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = base + r * kThreads + tid;
        if (j < m) {
          const float r0 = remainR[j];
          const float sumr = __fmul_rn(acc[r], r0);
          const float consumption = fminf(r0 / (sumr + 1e-9f), 1.f);
          rr[j] = __fmul_rn(consumption, r0);
          remainR[j] = fmaxf(0.f, __fsub_rn(r0, sumr));
        }
      }
    }
    __syncthreads();
    // pass C: transported mass and its cost; remainL and ratioL stay with their rows'
    // owner, so the next level's pass A needs no barrier before it
    for (int base = 0; base < n; base += kThreads * kRows) {
      sweep<true>(xs, n, ys, rr, m, level, base, acc, cst);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + tid;
        if (i < n) {
          const float rl = ratioL[i];
          my_cost += rl * cst[r];
          remainL[i] = fmaxf(0.f, __fsub_rn(remainL[i], __fmul_rn(rl, acc[r])));
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) my_cost += __shfl_xor_sync(kFull, my_cost, off);
  if ((tid & 31) == 0) s_part[tid >> 5] = my_cost;
  __syncthreads();
  if (tid < 32) {
    float v = tid < kThreads / 32 ? s_part[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (tid == 0) cost[blockIdx.x] = v;
  }
}

}  // namespace

extern "C" int emd_f32(const void* xyz1, const void* xyz2, void* cost, int B, int n, int m,
                       void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  // two float4 point arrays and four float state vectors
  const long long bytes = 24LL * (static_cast<long long>(n) + m);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(emd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  emd_kernel<<<B, kThreads, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<float*>(cost), n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* emd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
