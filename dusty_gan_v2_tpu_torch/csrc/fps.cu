// Batched greedy furthest-point sampling: (B, N, 3) f32 points -> (B, K) int32 indices.
// Start at index 0; each step updates the running minimum squared distance of every
// point to the last pick and picks the first (lowest-index) maximum.
//
// Replaces the Pallas TPU kernel dusty_gan_v2_tpu/metrics/pallas_fps.py::_build_kernel
// (called through fps_pallas), which kept the whole (B, N) distance state in VMEM and
// walked the K-1 steps for all clouds at once.
//
// Bound on the H100: latency, not bytes or flops. The K-1 steps are a chain of dependent
// arg-max reductions over a cloud; the data (3 MB of points for B=8, N=32768) is read once
// in principle and the 9 flops per point and step come to ~72 us at the card's f32 rate,
// but each step must finish its reduction before the next can start. So a step's time is
// what counts: the sweep over the cloud's points, the reduction and the hand-over of the
// pick. Two kernels:
//
// fps_cluster_kernel: a thread-block cluster of CS blocks (a power of two up to 16) per
// cloud, for batches small enough that B * CS blocks fill the card at once. Each block
// stages its contiguous share of ceil(N / CS) points into shared memory once, as x[], y[],
// z[] arrays (so the 393 KB of a 32768-point cloud fit from CS = 2 on), and keeps the
// running minima of its points in registers. Per step a block reduces to one candidate
// (value, lowest index, coordinates) in a slot of its shared memory, double-buffered by
// step parity. Warp 0 pushes the block's candidate into a slot of every other block of
// the cluster through distributed shared memory (st.async, which signals the receiving
// block's mbarrier with the bytes written), so no cluster-wide barrier and no remote load
// sits on the chain of steps: each block waits on its own mbarrier for the CS candidates,
// and every warp reads them from its own shared memory, one lane a slot, takes the max
// value with the lowest index, and the pick's coordinates from the winning lane. The
// launcher (fps_fit_cluster) halves the CS the caller allows until all B clusters are
// resident at once (cudaOccupancyMaxActiveClusters). On an H100 at 8 x 32768 -> 2048 a
// step takes 1.9 us with CS = 8 (2.6 us with CS = 2, 2.9 us with CS = 16), against
// 8.2 us with CS = 1.
//
// fps_kernel (CS = 1): one block of 1024 threads per cloud, for large batches (B * 2 >
// the SM count). The running minimum lives in registers (PPT <= 32 floats a thread), the
// coordinates are re-read from L1/L2 each step (3 x 128 KB per cloud does not fit beside
// them on an SM), and each step does one warp-shuffle reduction, one __syncthreads over a
// double-buffered 32-entry table, and a redundant per-warp final reduction so that every
// thread learns the pick without a second barrier.
//
// Index parity with the plain version depends on bit-identical distances:
// (x-px)^2 + (y-py)^2 + (z-pz)^2 is summed left to right with rounded intrinsics,
// never contracted to FMA, and ties resolve to the lowest index as torch.argmax does: a
// thread walks its points in ascending order with a strict >, and every merge of two
// candidates takes the larger value or, on equal values, the lower index.
//
// C interface (ctypes): launches on the given stream, does not synchronise, returns
// cudaGetLastError(). Points are addressed through element strides (sb, sn, sc), so
// both the (B, N, 3) layout and the (B, 3, N)-backed view that CoordBridge returns are
// read without a copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the final reduction reads one table entry per lane");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;

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

__device__ __forceinline__ float sqdist(float x, float y, float z, float px, float py,
                                        float pz) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py), dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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
        dist[t] = fminf(dist[t], sqdist(__ldg(q), __ldg(q + sc), __ldg(q + 2 * sc), px, py, pz));
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One step's candidate of a block: (value, index bits, x, y) and z, 20 bytes.
struct __align__(16) Slot {
  float4 vixy;
  float z;
};
constexpr unsigned kSlotBytes = 20;

// Block `rank` of a cluster of `cs` owns points [rank * chunk, rank * chunk + count) of its
// cloud, chunk = ceil(N / cs); thread tid the points tid + t * kThreads of that share.
// Hand-over of a step's candidates: warp 0 of every block writes its candidate into slot
// [buf][rank] of every other block of the cluster with st.async, which signals that
// block's mbarrier[buf] with the bytes written, and into its own slot with a plain store
// followed by its arrival (expecting (cs - 1) slots of bytes) on its own mbarrier[buf].
// A block's threads wait on their mbarrier[buf] and read the cs slots locally. buf = step
// parity: a block writes a peer's slot[buf] of step s + 2 only after it has received the
// peer's candidate of step s + 1, which the peer sends after the __syncthreads that all
// its warps reach after reading their slots of step s.
template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz, int* __restrict__ idx, int N, int K,
                   int chunk, int64_t sb, int64_t sn, int64_t sc) {
  extern __shared__ float s_pts[];  // x[chunk], y[chunk], z[chunk]
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ Slot s_slot[2][kMaxCluster];
  __shared__ uint64_t s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + cloud * sb;
  const int base = rank * chunk;
  const int count = max(0, min(chunk, N - base));
  float* sx = s_pts;
  float* sy = sx + chunk;
  float* sz = sy + chunk;
  for (int j = tid; j < count; j += kThreads) {
    const float* q = pts + static_cast<int64_t>(base + j) * sn;
    sx[j] = q[0];
    sy[j] = q[sc];
    sz[j] = q[2 * sc];
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s_bar[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane r of warp 0 sends to rank r: its slot [.][rank] and mbarrier there
  uint32_t peer_slot[2] = {0, 0}, peer_bar[2] = {0, 0};
  if (warp == 0 && lane < cs && lane != rank) {
    for (int b = 0; b < 2; ++b) {
      asm("mapa.shared::cluster.u32 %0, %1, %2;"
          : "=r"(peer_slot[b]) : "r"(smem_addr(&s_slot[b][rank])), "r"(lane));
      asm("mapa.shared::cluster.u32 %0, %1, %2;"
          : "=r"(peer_bar[b]) : "r"(smem_addr(&s_bar[b])), "r"(lane));
    }
  }

  float dist[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) dist[t] = 1e10f;
  float px = pts[0], py = pts[sc], pz = pts[2 * sc];
  if (rank == 0 && tid == 0) idx[static_cast<int64_t>(cloud) * K] = 0;
  // every block's points are staged and its mbarriers set before anyone sends
  cluster.sync();

  for (int step = 1; step < K; ++step) {
    float best = -1.f;  // below every real distance
    int best_i = INT_MAX;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const int j = tid + t * kThreads;
      if (j < count) {
        dist[t] = fminf(dist[t], sqdist(sx[j], sy[j], sz[j], px, py, pz));
        if (dist[t] > best) {  // strict: the lowest index wins within a thread
          best = dist[t];
          best_i = j;
        }
      }
    }
    warp_arg_max(best, best_i);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_i;
    }
    __syncthreads();
    const int buf = step & 1;
    if (warp == 0) {
      best = s_val[lane];
      best_i = s_idx[lane];
      warp_arg_max(best, best_i);
      const bool some = best_i < count;  // an empty share offers value -1
      const int j = some ? best_i : 0;
      const uint32_t gi = static_cast<uint32_t>(some ? base + best_i : INT_MAX);
      const uint32_t v = __float_as_uint(best), x = __float_as_uint(sx[j]),
                     y = __float_as_uint(sy[j]), z = __float_as_uint(sz[j]);
      if (lane == rank) {
        s_slot[buf][rank].vixy = make_float4(best, __uint_as_float(gi), sx[j], sy[j]);
        s_slot[buf][rank].z = sz[j];
        uint64_t state;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
                     : "=l"(state) : "r"(smem_addr(&s_bar[buf])), "r"((cs - 1) * kSlotBytes)
                     : "memory");
      } else if (lane < cs) {
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
            ::"r"(peer_slot[buf]), "r"(v), "r"(gi), "r"(x), "r"(y), "r"(peer_bar[buf])
            : "memory");
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                     ::"r"(peer_slot[buf] + 16), "r"(z), "r"(peer_bar[buf]) : "memory");
      }
    }
    // buffer buf's mbarrier completes once a step in two: its phase of this step
    const uint32_t parity = static_cast<uint32_t>((step - 1) >> 1) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(smem_addr(&s_bar[buf])), "r"(parity) : "memory");
    }
    float v = -2.f, x = 0.f, y = 0.f, z = 0.f;
    int i = INT_MAX;
    if (lane < cs) {
      const float4 a = s_slot[buf][lane].vixy;
      z = s_slot[buf][lane].z;
      v = a.x;
      i = __float_as_int(a.y);
      x = a.z;
      y = a.w;
    }
    for (int off = cs >> 1; off > 0; off >>= 1) {  // lanes < cs agree on the winner
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      arg_max(v, i, ov, oi);
    }
    i = __shfl_sync(kFull, i, 0);
    const int owner = i / chunk;  // the rank, i.e. the lane, that offered the winner
    px = __shfl_sync(kFull, x, owner);
    py = __shfl_sync(kFull, y, owner);
    pz = __shfl_sync(kFull, z, owner);
    if (rank == 0 && tid == 0) idx[static_cast<int64_t>(cloud) * K + step] = i;
  }
  // no block leaves while a peer may still write into it
  cluster.sync();
}

template <int PPT>
int launch(const float* xyz, int* idx, int B, int N, int K, int64_t sb, int64_t sn,
           int64_t sc, cudaStream_t s) {
  fps_kernel<PPT><<<B, kThreads, 0, s>>>(xyz, idx, N, K, sb, sn, sc);
  return static_cast<int>(cudaGetLastError());
}

template <int PPT>
cudaError_t cluster_config(int B, int N, int cs, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr, cudaStream_t s) {
  const int chunk = (N + cs - 1) / cs;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(chunk);
  cudaError_t err = cudaFuncSetAttribute(fps_cluster_kernel<PPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fps_cluster_kernel<PPT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cs);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Clusters of `cs` blocks that can be resident at once, or -err on an error.
template <int PPT>
int active_clusters(int B, int N, int cs) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<PPT>(B, N, cs, cfg, attr, nullptr);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, fps_cluster_kernel<PPT>, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

template <int PPT>
int launch_cluster(const float* xyz, int* idx, int B, int N, int K, int cs, int64_t sb,
                   int64_t sn, int64_t sc, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<PPT>(B, N, cs, cfg, attr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = (N + cs - 1) / cs;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT>, xyz, idx, N, K, chunk, sb, sn, sc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// PPT of the cluster kernel for a share of `chunk` points, or 0 if it is too large.
int cluster_ppt(int chunk) {
  for (int ppt = 1; ppt <= 16; ppt *= 2)
    if (chunk <= ppt * kThreads) return ppt;
  return 0;
}

bool valid_cluster(int N, int cs) {
  return cs >= 2 && cs <= kMaxCluster && (cs & (cs - 1)) == 0 &&
         cluster_ppt((N + cs - 1) / cs) > 0;
}

int active(int B, int N, int cs) {
  switch (cluster_ppt((N + cs - 1) / cs)) {
    case 1: return active_clusters<1>(B, N, cs);
    case 2: return active_clusters<2>(B, N, cs);
    case 4: return active_clusters<4>(B, N, cs);
    case 8: return active_clusters<8>(B, N, cs);
    case 16: return active_clusters<16>(B, N, cs);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The cluster size to launch with: the largest power of two cs' <= cs for which all B
// clusters of cs' blocks are resident at once, or 1 (the one-block kernel). Negative: a
// CUDA error (its code negated).
extern "C" int fps_fit_cluster(int B, int N, int cs) {
  for (; valid_cluster(N, cs); cs /= 2) {
    const int fit = active(B, N, cs);
    if (fit < 0) return fit;
    if (fit >= B) return cs;
  }
  return 1;
}

// cs = 1: the one-block kernel; cs = 2..16 (a power of two): clusters of cs blocks.
extern "C" int fps_f32(const void* xyz, void* idx, int B, int N, int K, long long sb,
                       long long sn, long long sc, int cs, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (cs != 1) {
    if (!valid_cluster(N, cs)) return static_cast<int>(cudaErrorInvalidValue);
    switch (cluster_ppt((N + cs - 1) / cs)) {
      case 1: return launch_cluster<1>(x, o, B, N, K, cs, sb, sn, sc, s);
      case 2: return launch_cluster<2>(x, o, B, N, K, cs, sb, sn, sc, s);
      case 4: return launch_cluster<4>(x, o, B, N, K, cs, sb, sn, sc, s);
      case 8: return launch_cluster<8>(x, o, B, N, K, cs, sb, sn, sc, s);
      default: return launch_cluster<16>(x, o, B, N, K, cs, sb, sn, sc, s);
    }
  }
  if (N <= 1 * kThreads) return launch<1>(x, o, B, N, K, sb, sn, sc, s);
  if (N <= 2 * kThreads) return launch<2>(x, o, B, N, K, sb, sn, sc, s);
  if (N <= 4 * kThreads) return launch<4>(x, o, B, N, K, sb, sn, sc, s);
  if (N <= 8 * kThreads) return launch<8>(x, o, B, N, K, sb, sn, sc, s);
  if (N <= 16 * kThreads) return launch<16>(x, o, B, N, K, sb, sn, sc, s);
  if (N <= 32 * kThreads) return launch<32>(x, o, B, N, K, sb, sn, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
