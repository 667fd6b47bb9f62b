// Batched greedy furthest-point sampling: (B, N, 3) f32 points -> (B, K) int32 indices.
// Start at index 0; each step updates the running minimum squared distance of every
// point to the last pick and picks the first (lowest-index) maximum.
//
// Replaces the Pallas TPU kernel dusty_gan_v2_tpu/metrics/pallas_fps.py::_build_kernel
// (called through fps_pallas), which kept the whole (B, N) distance state in VMEM and
// walked the K-1 steps for all clouds at once.
//
// Bound on the H100: latency, not bytes or flops. The K-1 steps are a chain of
// dependent block-wide arg-max reductions; the data (3 MB of points for B=8, N=32768)
// is read once in principle and the 9 flops per point and step come to ~72 us at the
// card's f32 rate, but each step must finish its reduction before the next can start.
// Design: one thread block per cloud (blocks never share state, so no cross-block
// sync), 1024 threads, each owning PPT = N/1024 points at indices tid + t*1024. The
// running minimum lives in registers (PPT <= 32 floats a thread), the coordinates are
// re-read from L1/L2 each step (3 x 128 KB per cloud does not fit beside them on an
// SM), and each step does one warp-shuffle reduction, one __syncthreads over a
// double-buffered 32-entry table, and a redundant per-warp final reduction so that
// every thread learns the pick without a second barrier. With B=8 only 8 of the 132
// SMs work: spreading a cloud over a cluster of blocks is left for later.
//
// Index parity with the plain version depends on bit-identical distances:
// (x-px)^2 + (y-py)^2 + (z-pz)^2 is summed left to right with rounded intrinsics,
// never contracted to FMA, and ties resolve to the lowest index as torch.argmax does.
//
// C interface (ctypes): launches on the given stream, does not synchronise, returns
// cudaGetLastError(). Points are addressed through element strides (sb, sn, sc), so
// both the (B, N, 3) layout and the (B, 3, N)-backed view that CoordBridge returns are
// read without a copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the final reduction reads one table entry per lane");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void arg_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_arg_max(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    arg_max(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ idx, int N, int K,
           int64_t sb, int64_t sn, int64_t sc) {
  __shared__ float s_val[2][kWarps];
  __shared__ int s_idx[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + blockIdx.x * sb;
  int* out = idx + static_cast<int64_t>(blockIdx.x) * K;

  float dist[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) dist[t] = 1e10f;

  int last = 0;
  if (tid == 0) out[0] = 0;
  for (int step = 1; step < K; ++step) {
    const float* p = pts + last * sn;
    const float px = __ldg(p), py = __ldg(p + sc), pz = __ldg(p + 2 * sc);
    float best = -1.f;  // below every real distance
    int best_i = 0;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const int j = tid + t * kThreads;
      if (j < N) {
        const float* q = pts + j * sn;
        const float dx = __fsub_rn(__ldg(q), px);
        const float dy = __fsub_rn(__ldg(q + sc), py);
        const float dz = __fsub_rn(__ldg(q + 2 * sc), pz);
        const float d =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        dist[t] = fminf(dist[t], d);
        if (dist[t] > best) {  // strict: the lowest index wins within a thread
          best = dist[t];
          best_i = j;
        }
      }
    }
    warp_arg_max(best, best_i);
    const int buf = step & 1;
    if (lane == 0) {
      s_val[buf][warp] = best;
      s_idx[buf][warp] = best_i;
    }
    __syncthreads();
    // every warp reduces the table itself; the table is double-buffered so that a
    // warp writing the next step's entry cannot race a warp still reading this one
    best = s_val[buf][lane];
    best_i = s_idx[buf][lane];
    warp_arg_max(best, best_i);
    last = best_i;
    if (tid == 0) out[step] = last;
  }
}

template <int PPT>
void launch(const float* xyz, int* idx, int B, int N, int K, int64_t sb, int64_t sn,
            int64_t sc, cudaStream_t s) {
  fps_kernel<PPT><<<B, kThreads, 0, s>>>(xyz, idx, N, K, sb, sn, sc);
}

}  // namespace

extern "C" int fps_f32(const void* xyz, void* idx, int B, int N, int K, long long sb,
                       long long sn, long long sc, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 1 * kThreads) launch<1>(x, o, B, N, K, sb, sn, sc, s);
  else if (N <= 2 * kThreads) launch<2>(x, o, B, N, K, sb, sn, sc, s);
  else if (N <= 4 * kThreads) launch<4>(x, o, B, N, K, sb, sn, sc, s);
  else if (N <= 8 * kThreads) launch<8>(x, o, B, N, K, sb, sn, sc, s);
  else if (N <= 16 * kThreads) launch<16>(x, o, B, N, K, sb, sn, sc, s);
  else if (N <= 32 * kThreads) launch<32>(x, o, B, N, K, sb, sn, sc, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
