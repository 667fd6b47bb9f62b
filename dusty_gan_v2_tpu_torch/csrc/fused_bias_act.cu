// Fused bias + leaky-ReLU + scale over an NCHW (or NC) tensor:
//     y = leaky_relu(x + bias[c], slope) * scale,   c = (i / HW) % C
//
// Replaces the Pallas TPU kernel dusty_gan_v2_tpu/ops/act.py::_build_pallas_fn
// (called through fused_leaky_relu_pallas). On the TPU XLA fuses this chain into the
// producing matmul; in eager PyTorch nothing does, so without this kernel the
// bias-add, the activation and the scale would be three passes over every activation.
//
// Bound on the H100: device-memory bytes. Each element is read once and written once
// (8 bytes in f32, 4 in bf16) for 4 flops, far below the card's ~20 flop/byte ridge
// in f32. The design therefore only tries to stream at full rate: 16-byte vector loads
// and stores (4 f32 or 8 bf16 lanes) when H*W is a multiple of the vector width and
// both pointers are 16-byte aligned (a vector then never straddles two channels, so
// one bias value serves it), a grid-stride loop, and the math in f32 with a single
// rounding to the output type. Rounded operations (__fadd_rn / __fmul_rn) keep the
// result identical to the plain PyTorch version in f32.
//
// C interface (ctypes): each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bias_act(float v, float b, float slope, float scale) {
  float y = __fadd_rn(v, b);
  y = y >= 0.f ? y : __fmul_rn(y, slope);
  return __fmul_rn(y, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bias_act_vec(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ y,
                   int64_t n_vec, int C, int64_t HW, float slope, float scale) {
  constexpr int V = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const float b = to_float(bias[(i * V / HW) % C]);
    alignas(16) T e[V];
    *reinterpret_cast<uint4*>(e) = __ldg(xv + i);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_float<T>(bias_act(to_float(e[k]), b, slope, scale));
    yv[i] = *reinterpret_cast<const uint4*>(e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bias_act_scalar(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ y,
                      int64_t n, int C, int64_t HW, float slope, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float b = to_float(bias[(i / HW) % C]);
    y[i] = from_float<T>(bias_act(to_float(x[i]), b, slope, scale));
  }
}

template <typename T>
int launch(const void* x, const void* bias, void* y, long long n, int C, long long HW,
           float slope, float scale, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  if (aligned && HW % V == 0) {
    const int64_t n_vec = n / V;
    const int blocks = static_cast<int>(
        n_vec / kThreads + 1 < kMaxBlocks ? n_vec / kThreads + 1 : kMaxBlocks);
    fused_bias_act_vec<T><<<blocks, kThreads, 0, s>>>(xt, bt, yt, n_vec, C, HW, slope, scale);
  } else {
    const int blocks =
        static_cast<int>(n / kThreads + 1 < kMaxBlocks ? n / kThreads + 1 : kMaxBlocks);
    fused_bias_act_scalar<T><<<blocks, kThreads, 0, s>>>(xt, bt, yt, n, C, HW, slope, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_bias_act_f32(const void* x, const void* bias, void* y, long long n, int C,
                                  long long HW, float slope, float scale, void* stream) {
  return launch<float>(x, bias, y, n, C, HW, slope, scale, stream);
}

extern "C" int fused_bias_act_bf16(const void* x, const void* bias, void* y, long long n, int C,
                                   long long HW, float slope, float scale, void* stream) {
  return launch<__nv_bfloat16>(x, bias, y, n, C, HW, slope, scale, stream);
}

extern "C" const char* fused_bias_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
