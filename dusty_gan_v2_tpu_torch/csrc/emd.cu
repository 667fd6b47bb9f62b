// Fused approximate earth mover's distance (approxmatch + match cost):
// (B, n, 3), (B, m, 3) f32 clouds -> (B,) f32 costs, not divided by n.
//
// Nine annealing levels L_l = -4^(7 - l). With K_l = exp(L_l d_ij) and
// d_ij = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0), level l does
//   A(l)  ratioL_i = remainL_i / (1e-9 + sum_j K_l remainR_j)
//   B(l)  sumr_j   = (sum_i K_l ratioL_i) * remainR_j
//         rr_j     = min(remainR_j / (sumr_j + 1e-9), 1) * remainR_j
//         remainR_j = max(0, remainR_j - sumr_j)
//   C(l)  cost    += sum_ij ratioL_i K_l rr_j sqrt(d_ij)
//         remainL_i = max(0, remainL_i - ratioL_i * sum_j K_l rr_j)
// which is metrics/distance.py::earth_mover_distance of this package, term by term.
//
// Replaces the Pallas TPU kernel dusty_gan_v2_tpu/metrics/pallas_emd.py::_build_kernel
// (called through emd_pallas), which keeps sqrt(D) and K for the whole pair resident in
// VMEM (2 x 16 MB at 2048 x 2048) and computes exp once per level. An SM has 227 KB, so
// nothing of that layout carries over: here D and K are never stored at all.
//
// Bound on the H100: operations. A pair moves 48 KB in and 4 B out, but every element of
// the n x m plane needs its distance, an exponential and a few multiply-adds per level. The
// limit is instruction issue: the FP32 lanes (128 an SM and clock) and the special-function
// units (16 an SM and clock) both run near their rates. So the design counts instructions
// per element and level:
// - Two sweeps a level, not three. C(l) and A(l+1) both walk rows against all columns;
//   A(l+1) needs remainR after B(l), final by then, and remainL only in its last division,
//   after C(l) updated it in the same thread. So one sweep computes d once and sums
//   K_l rr, K_l rr sqrt(d) and K_{l+1} remainR. Order: A(0), then B(l) and C(l) + A(l+1)
//   for l = 0..7, then B(8) and C(8): 19 sweeps instead of 27.
// - Every K is the plain version's to the bit: expf of the exact product L_l d (L_l is a
//   power of two), as torch.exp computes it on the card. approxmatch's clamped residues
//   make a few pairs' costs sensitive to the last bits of K, so no cheaper exponential
//   holds the 1e-5 bar on every set. On an H100, over ten sets of 256 pairs of 2048 x 2048
//   (scripts/torch_emd_kernel_variants.py): this kernel 18.8 ms a launch, every pair
//   within 7.9e-6; ex2.approx of the rounded L_l log2(e) d 12.7 ms, but up to 2.3e-5 in
//   three of the ten sets; K_l as (K_{l+1}^2)^2 16.7 ms and up to 8.9e-5. The cost's sqrt
//   is sqrt.approx (within 1e-7 relative), whose error enters the cost linearly.
//   tests/test_torch_emd_kernel_design.py emulates the recurrence in float32 against the
//   plain version.
// - d is 8 FP32 instructions: the other side's points are stored as (-2 y, |y|^2), which
//   scales each product by an exact power of two (see sqdist).
// That is 19 sweeps with d, an expf (its range reduction included) and a few
// multiply-adds per element, against 27 sweeps with expf and an IEEE sqrtf before:
// 18.8 ms for 256 pairs of 2048 x 2048 on an H100 (25.6 before), 22% of the bound.
// Layout: one block of 1024 threads per pair. Both clouds (float4 each) and the state
// vectors remainL, ratioL, (remainR, rr) live in dynamic shared memory, 24 (n + m) bytes
// (96 KB at 2048 + 2048, two blocks to an SM: 64 warps, the most an SM holds, to hide the
// latency of the special-function units; 2 rows a thread in 32 registers, with a few
// bytes of spills, ran as fast on the card as 4 rows in 64 with half the warps and 3%
// faster than 2 rows in 64, and unrolling the walk by 4 4% faster than by 2). In the row
// sweeps a thread owns kRows rows i and walks all columns j; in B it owns kRows columns
// and walks all rows. So every sum of a sweep is private to a
// thread, all threads of a warp read the same walked point (a shared-memory broadcast),
// and the only cross-thread traffic is two barriers a level and the final reduction of
// the cost.
//
// Numerics. At level 0 the exponent is -16384 d, so an absolute error of 1e-7 in d (the
// cancellation error of the |x|^2 + |y|^2 - 2xy form on O(1) coordinates) moves K by
// 1e-3. The plain version therefore fixes the order of every operation in d, and this
// kernel repeats it with rounded intrinsics that the compiler may not contract:
// xy = (x0 y0 + x1 y1) + x2 y2, d = max((|x|^2 + |y|^2) - 2 xy, 0), the same bits in
// every sweep and in the plain version. The products that feed the clamped subtractions
// (sumr, ratioL * acc) are rounded before the subtraction, as in the plain version. Row
// and column sums are taken serially in a thread, in runs of kRun terms folded into a
// total, so their rounding error grows with kRun + n / kRun rather than n; their order
// and the approximate square root differ from the plain version, which is why the two are
// compared with a relative bar (1e-5 per pair) and not bit by bit.
//
// C interface (ctypes): launches on the given stream, does not synchronise, returns
// the CUDA error code. Inputs are contiguous (B, n, 3) and (B, m, 3) f32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 2;   // points a thread owns in one sweep
constexpr int kRun = 128;  // terms summed serially before folding into the total
constexpr int kLevels = 9;
constexpr unsigned kFull = 0xffffffffu;

// K = exp(L d): expf of the exact product, the one definition of K that every sweep uses,
// so that passes A, B and C of a level see the plain version's bits
__device__ __forceinline__ float kexp(float d, float level) { return expf(__fmul_rn(d, level)); }

__device__ __forceinline__ float sqrt_approx(float d) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// x = (x0, x1, x2, |x|^2) of the first cloud, q = (-2 y0, -2 y1, -2 y2, |y|^2) of the
// second. (x0 q0 + x1 q1) + x2 q2 is -2 xy to the bit (scaling by a power of two commutes
// with rounding), so one rounded add gives the plain version's (|x|^2 + |y|^2) - 2 xy.
__device__ __forceinline__ float sqdist(const float4 x, const float4 q) {
  const float m2xy = __fadd_rn(__fadd_rn(__fmul_rn(x.x, q.x), __fmul_rn(x.y, q.y)),
                               __fmul_rn(x.z, q.z));
  return fmaxf(__fadd_rn(__fadd_rn(x.w, q.w), m2xy), 0.f);
}

// For the kRows points own[base + r * kThreads + tid] of this thread:
//   acc[r] = sum_j kexp(d(own_r, other_j), level) * w[j * kStride]
// kOwnX: the own points are the first cloud's (rows), else the second's (columns).
// Points past n_own are clamped to the last one; the caller drops their sums.
template <bool kOwnX, int kStride>
__device__ __forceinline__ void sweep_exp(const float4* __restrict__ own, int n_own,
                                          const float4* __restrict__ other,
                                          const float* __restrict__ w, int n_other, float level,
                                          int base, float (&acc)[kRows]) {
  float4 p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p[r] = own[min(base + r * kThreads + static_cast<int>(threadIdx.x), n_own - 1)];
    acc[r] = 0.f;
  }
  for (int j0 = 0; j0 < n_other; j0 += kRun) {
    const int j1 = min(j0 + kRun, n_other);
    float run[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) run[r] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float4 o = other[j];
      const float wj = w[j * kStride];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d = kOwnX ? sqdist(p[r], o) : sqdist(o, p[r]);
        run[r] = fmaf(kexp(d, level), wj, run[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += run[r];
  }
}

// The row sweep C(l) (+ A(l+1) when kNext). For this thread's kRows rows, with col[j] =
// (remainR_j, rr_j), K_l = kexp(d, level), K_{l+1} = kexp(d, level / 4):
//   kc[r] = sum_j K_l rr_j,  cs[r] = sum_j K_l rr_j sqrt(d),  ka[r] = sum_j K_{l+1} remainR_j.
template <bool kNext>
__device__ __forceinline__ void sweep_ca(const float4* __restrict__ xs, int n,
                                         const float4* __restrict__ qs,
                                         const float2* __restrict__ col, int m, float level,
                                         int base, float (&kc)[kRows], float (&cs)[kRows],
                                         float (&ka)[kRows]) {
  const float next_level = 0.25f * level;  // exact
  float4 p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p[r] = xs[min(base + r * kThreads + static_cast<int>(threadIdx.x), n - 1)];
    kc[r] = cs[r] = ka[r] = 0.f;
  }
  for (int j0 = 0; j0 < m; j0 += kRun) {
    const int j1 = min(j0 + kRun, m);
    float run_kc[kRows], run_cs[kRows], run_ka[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) run_kc[r] = run_cs[r] = run_ka[r] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float4 q = qs[j];
      const float2 rw = col[j];  // (remainR, rr)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d = sqdist(p[r], q);
        if (kNext) run_ka[r] = fmaf(kexp(d, next_level), rw.x, run_ka[r]);
        const float kr = kexp(d, level) * rw.y;
        run_kc[r] += kr;
        run_cs[r] = fmaf(kr, sqrt_approx(d), run_cs[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      kc[r] += run_kc[r];
      cs[r] += run_cs[r];
      ka[r] += run_ka[r];
    }
  }
}

__device__ __forceinline__ float4 load_point(const float* __restrict__ p, float scale) {
  const float x = p[0], y = p[1], z = p[2];
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(scale * x, scale * y, scale * z, sq);
}

__global__ void __launch_bounds__(kThreads, 2)
emd_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
           float* __restrict__ cost, int n, int m) {
  extern __shared__ float4 smem[];
  float4* xs = smem;                                         // n: (x, |x|^2)
  float4* qs = xs + n;                                       // m: (-2 y, |y|^2)
  float2* col = reinterpret_cast<float2*>(qs + m);           // m: (remainR, rr)
  float* remainL = reinterpret_cast<float*>(col + m);        // n
  float* ratioL = remainL + n;                               // n
  __shared__ float s_part[kThreads / 32];

  const int tid = threadIdx.x;
  const float* x_in = xyz1 + static_cast<int64_t>(blockIdx.x) * n * 3;
  const float* y_in = xyz2 + static_cast<int64_t>(blockIdx.x) * m * 3;
  // integer division, as in the approxmatch kernel this metric comes from
  const float multiL = n >= m ? 1.f : static_cast<float>(m / n);
  const float multiR = n >= m ? static_cast<float>(n / m) : 1.f;
  for (int i = tid; i < n; i += kThreads) {
    xs[i] = load_point(x_in + 3 * i, 1.f);
    remainL[i] = multiL;
  }
  for (int j = tid; j < m; j += kThreads) {
    qs[j] = load_point(y_in + 3 * j, -2.f);
    col[j] = make_float2(multiR, 0.f);
  }
  __syncthreads();

  float my_cost = 0.f;
  float level = -16384.f;  // L_0, then a quarter of it each level
  float acc[kRows], kc[kRows], cs[kRows];
  // A(0): rows against the right side's supply
  for (int base = 0; base < n; base += kThreads * kRows) {
    sweep_exp<true, 2>(xs, n, qs, reinterpret_cast<const float*>(col), m, level, base, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + r * kThreads + tid;
      if (i < n) ratioL[i] = remainL[i] / (1e-9f + acc[r]);
    }
  }
  for (int li = 0; li < kLevels; ++li, level *= 0.25f) {
    __syncthreads();
    // B(li): columns consume
    for (int base = 0; base < m; base += kThreads * kRows) {
      sweep_exp<false, 1>(qs, m, xs, ratioL, n, level, base, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = base + r * kThreads + tid;
        if (j < m) {
          const float r0 = col[j].x;
          const float sumr = __fmul_rn(acc[r], r0);
          const float consumption = fminf(r0 / (sumr + 1e-9f), 1.f);
          col[j] = make_float2(fmaxf(0.f, __fsub_rn(r0, sumr)), __fmul_rn(consumption, r0));
        }
      }
    }
    __syncthreads();
    // C(li), fused with A(li + 1) below the last level: transported mass and its cost, then
    // the next level's ratio. remainL and ratioL stay with their rows' owner.
    const bool next = li + 1 < kLevels;
    for (int base = 0; base < n; base += kThreads * kRows) {
      if (next) {
        sweep_ca<true>(xs, n, qs, col, m, level, base, kc, cs, acc);
      } else {
        sweep_ca<false>(xs, n, qs, col, m, level, base, kc, cs, acc);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + tid;
        if (i < n) {
          const float rl = ratioL[i];
          my_cost += rl * cs[r];
          const float left = fmaxf(0.f, __fsub_rn(remainL[i], __fmul_rn(rl, kc[r])));
          remainL[i] = left;
          if (next) ratioL[i] = left / (1e-9f + acc[r]);
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
