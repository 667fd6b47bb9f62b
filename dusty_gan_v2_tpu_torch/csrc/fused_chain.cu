// Fused elementwise -> resample chain over (N, H, W) planes, forward and backward.
//
//   forward   out[p] = Hm (Ho,H) @ rnd( act(x[p] + bias[p % C]) @ WmT (W,Wo) )
//   backward  dx[p]  = rnd( (rnd(HmT (H,Ho) @ g[p]) @ Wm (Wo,W)) * mask(x[p] + bias[p % C]) )
//
// act = leaky_relu(., slope) * scale computed in f32 and rounded to the storage type
// (skipped when with_act = 0: then the forward is a bare two-sided resample, and with
// the transposed operators it is that resample's adjoint); mask = scale where the
// pre-activation is >= 0, else scale * slope; rnd rounds to the storage type (f32 or
// bf16); every product accumulates in f32. The operators are general dense matrices.
//
// Replaces the Pallas TPU kernels dusty_gan_v2_tpu/ops/fused_chain.py::_fwd_call (via
// fused_act_resample, pallas_resample and _pr_bwd) and ::_bwd_call (via _far_bwd). On the
// TPU a grid step holds a few whole planes and both operators in VMEM and runs two MXU
// matmuls per plane. Here the intermediate of a plane is cut so that a tile of it stays
// in shared memory and no work is repeated:
//   - forward: the W-pass is independent per output column and the H-pass contracts over
//     rows, so a block owns (plane, 64 output columns): it forms the (H, 64) tile of the
//     intermediate from the whole activated plane, rounds it into shared memory, and
//     multiplies by Hm from the left;
//   - backward: the adjoint H-pass comes first and the adjoint W-pass is independent per
//     row, so a block owns (plane, 16 rows): it forms the (16, Wo) tile of the
//     intermediate from the whole gradient plane, rounds it into shared memory, and
//     multiplies by Wm from the right, a thread owning one or two output columns so that
//     g and Wm stream from global memory straight into registers.
//
// Bound on the H100: as dense products the work is 2*H*W*Wo + 2*Ho*H*Wo operations per
// plane against (H*W + Ho*Wo) elements moved: ~72 flop/byte in f32 at the widest site
// (64 x 512), above the card's ~20 flop/byte f32 ridge, so CUDA-core f32 FMA rate bounds
// these dense kernels, about 5x over the bytes bound. (The blur operators have 4
// non-zeros per row; a kernel that used the band structure would be bound by bytes.)
// The design is the plain one: register tiles of 4*RT x 4 (forward) or 16 x 2
// (backward) accumulators per thread, operands staged through shared memory in chunks
// of 16, no tensor cores, no asynchronous copies.
//
// Shape contract (checked by the launchers): 1 <= H, Ho <= 128 and 1 <= W, Wo <= 512.
//
// C interface (ctypes): each entry launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue outside the
// shape contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;  // H, Ho
constexpr int kMaxCols = 512;  // W, Wo
constexpr int kTN = 64;        // forward: output columns per block
constexpr int kKC = 16;        // forward: contraction chunk staged in shared memory
constexpr int kTM = 16;        // backward: rows per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float bias_act(float v, float b, float slope, float scale) {
  float y = __fadd_rn(v, b);
  y = y >= 0.f ? y : __fmul_rn(y, slope);
  return __fmul_rn(y, scale);
}

// ---------------------------------------------------------------------------- forward

// One block: plane = blockIdx.x / n_tiles, output columns [j0, j0 + kTN).
// Threads form a 16 x 16 grid: tx owns 4 adjacent columns, ty the rows ty + 16*i, i < RT.
template <typename T, bool ACT, int RT>
__global__ void __launch_bounds__(kThreads)
chain_fwd(const T* __restrict__ x, const T* __restrict__ bias, const T* __restrict__ wmT,
          const T* __restrict__ hm, T* __restrict__ out, int n_tiles, int C, int H, int W, int Ho,
          int Wo, float slope, float scale) {
  constexpr int kRows = RT * 16;
  __shared__ float As[kKC][kRows + 1];             // left operand chunk, As[k][row]
  __shared__ __align__(16) float Bs[kKC][kTN];     // right operand chunk, Bs[k][col]
  __shared__ __align__(16) float Zs[kRows][kTN];   // rounded intermediate, Zs[h][col]

  const int plane = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * kTN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* xp = x + static_cast<int64_t>(plane) * H * W;
  const float b = ACT ? ld(bias + plane % C) : 0.f;

  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // W-pass: Z[:, tile] = act(x) (H, W) @ WmT[:, tile] (W, kTN)
  for (int k0 = 0; k0 < W; k0 += kKC) {
    for (int e = tid; e < kRows * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      float v = 0.f;
      if (r < H && k0 + kk < W) {
        v = ld(xp + static_cast<int64_t>(r) * W + k0 + kk);
        if (ACT) v = rnd<T>(bias_act(v, b, slope, scale));
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < kKC * kTN; e += kThreads) {
      const int kk = e / kTN, c = e % kTN;
      Bs[kk][c] = (k0 + kk < W && j0 + c < Wo) ? ld(wmT + static_cast<int64_t>(k0 + kk) * Wo + j0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float a = As[kk][ty + 16 * i];
        acc[i][0] = fmaf(a, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // round the tile of the intermediate into shared memory (rows >= H are zero)
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < H) z = make_float4(rnd<T>(acc[i][0]), rnd<T>(acc[i][1]), rnd<T>(acc[i][2]), rnd<T>(acc[i][3]));
    *reinterpret_cast<float4*>(&Zs[r][tx * 4]) = z;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  // H-pass: out[:, tile] = Hm (Ho, H) @ Z (H, kTN)
  for (int k0 = 0; k0 < H; k0 += kKC) {
    for (int e = tid; e < kRows * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      As[kk][r] = (r < Ho && k0 + kk < H) ? ld(hm + static_cast<int64_t>(r) * H + k0 + kk) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      // k0 + kk < kRows always: k0 < H <= kRows, and k0 and kRows are multiples of 16
      const float4 bv = *reinterpret_cast<const float4*>(&Zs[k0 + kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float a = As[kk][ty + 16 * i];
        acc[i][0] = fmaf(a, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  T* op = out + static_cast<int64_t>(plane) * Ho * Wo;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    if (r >= Ho) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx * 4 + j;
      if (c < Wo) st(op + static_cast<int64_t>(r) * Wo + c, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------- backward

// acc[j][r] += sum_k A[k][r] * Bg[k * ldb + tid + 256 * j]: a (kTM, K) tile held in
// shared memory (A[k][row]) times a (K, n_cols) matrix in global memory; a thread owns
// columns tid and tid + 256 and all kTM rows.
template <typename T>
__device__ __forceinline__ void rows_times_global(float (*A)[kTM], const T* __restrict__ Bg, int K, int ldb,
                                                  int n_cols, float (&acc)[2][kTM]) {
  const int c0 = threadIdx.x, c1 = threadIdx.x + kThreads;
  const bool has0 = c0 < n_cols, has1 = c1 < n_cols;
  if (!has0) return;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float b0 = ld(Bg + static_cast<int64_t>(k) * ldb + c0);
    const float b1 = has1 ? ld(Bg + static_cast<int64_t>(k) * ldb + c1) : 0.f;
    const float4* a4 = reinterpret_cast<const float4*>(A[k]);
#pragma unroll
    for (int q = 0; q < kTM / 4; ++q) {
      const float4 a = a4[q];
      acc[0][4 * q + 0] = fmaf(a.x, b0, acc[0][4 * q + 0]);
      acc[0][4 * q + 1] = fmaf(a.y, b0, acc[0][4 * q + 1]);
      acc[0][4 * q + 2] = fmaf(a.z, b0, acc[0][4 * q + 2]);
      acc[0][4 * q + 3] = fmaf(a.w, b0, acc[0][4 * q + 3]);
      if (has1) {
        acc[1][4 * q + 0] = fmaf(a.x, b1, acc[1][4 * q + 0]);
        acc[1][4 * q + 1] = fmaf(a.y, b1, acc[1][4 * q + 1]);
        acc[1][4 * q + 2] = fmaf(a.z, b1, acc[1][4 * q + 2]);
        acc[1][4 * q + 3] = fmaf(a.w, b1, acc[1][4 * q + 3]);
      }
    }
  }
}

// One block: plane = blockIdx.x / n_tiles, rows [i0, i0 + kTM) of the (H, W) plane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_bwd(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ bias,
          const T* __restrict__ wm, const T* __restrict__ hmT, T* __restrict__ dx, int n_tiles, int C,
          int H, int W, int Ho, int Wo, float scale_pos, float scale_neg) {
  __shared__ __align__(16) float As[kMaxRows][kTM];  // HmT rows of the tile, As[ho][row]
  __shared__ __align__(16) float Ts[kMaxCols][kTM];  // rounded adjoint H-pass, Ts[wo][row]

  const int plane = blockIdx.x / n_tiles;
  const int i0 = (blockIdx.x % n_tiles) * kTM;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTM * Ho; e += kThreads) {
    const int r = e / Ho, k = e % Ho;
    As[k][r] = (i0 + r < H) ? ld(hmT + static_cast<int64_t>(i0 + r) * Ho + k) : 0.f;
  }
  __syncthreads();

  float acc[2][kTM];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < kTM; ++r) acc[j][r] = 0.f;

  // adjoint H-pass: T (kTM, Wo) = HmT[tile] (kTM, Ho) @ g (Ho, Wo)
  rows_times_global<T>(As, g + static_cast<int64_t>(plane) * Ho * Wo, Ho, Wo, Wo, acc);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + kThreads * j;
    if (c < Wo) {
#pragma unroll
      for (int q = 0; q < kTM / 4; ++q) {
        *reinterpret_cast<float4*>(&Ts[c][4 * q]) =
            make_float4(rnd<T>(acc[j][4 * q]), rnd<T>(acc[j][4 * q + 1]), rnd<T>(acc[j][4 * q + 2]),
                        rnd<T>(acc[j][4 * q + 3]));
      }
    }
#pragma unroll
    for (int r = 0; r < kTM; ++r) acc[j][r] = 0.f;
  }
  __syncthreads();

  // adjoint W-pass: gy (kTM, W) = T (kTM, Wo) @ Wm (Wo, W), then the activation mask
  rows_times_global<T>(Ts, wm, Wo, W, W, acc);
  const float b = ld(bias + plane % C);
  const int64_t base = static_cast<int64_t>(plane) * H * W;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + kThreads * j;
    if (c >= W) continue;
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      if (i0 + r >= H) continue;
      const int64_t idx = base + static_cast<int64_t>(i0 + r) * W + c;
      const float pre = __fadd_rn(ld(x + idx), b);
      st(dx + idx, __fmul_rn(acc[j][r], pre >= 0.f ? scale_pos : scale_neg));
    }
  }
}

// ---------------------------------------------------------------------------- launchers

bool in_contract(int N, int C, int H, int W, int Ho, int Wo) {
  return N > 0 && C > 0 && H >= 1 && Ho >= 1 && W >= 1 && Wo >= 1 && H <= kMaxRows && Ho <= kMaxRows &&
         W <= kMaxCols && Wo <= kMaxCols;
}

template <typename T, bool ACT, int RT>
void launch_fwd_rt(const T* x, const T* bias, const T* wmT, const T* hm, T* out, int N, int C, int H,
                   int W, int Ho, int Wo, float slope, float scale, cudaStream_t s) {
  const int n_tiles = (Wo + kTN - 1) / kTN;
  chain_fwd<T, ACT, RT><<<static_cast<unsigned>(N) * n_tiles, kThreads, 0, s>>>(
      x, bias, wmT, hm, out, n_tiles, C, H, W, Ho, Wo, slope, scale);
}

template <typename T, bool ACT>
void launch_fwd_act(const T* x, const T* bias, const T* wmT, const T* hm, T* out, int N, int C, int H,
                    int W, int Ho, int Wo, float slope, float scale, cudaStream_t s) {
  const int rows = H > Ho ? H : Ho;
  if (rows <= 16) launch_fwd_rt<T, ACT, 1>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, slope, scale, s);
  else if (rows <= 32) launch_fwd_rt<T, ACT, 2>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, slope, scale, s);
  else if (rows <= 64) launch_fwd_rt<T, ACT, 4>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, slope, scale, s);
  else launch_fwd_rt<T, ACT, 8>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, slope, scale, s);
}

template <typename T>
int launch_fwd(const void* x, const void* bias, const void* wmT, const void* hm, void* out, int N, int C,
               int H, int W, int Ho, int Wo, int with_act, float slope, float scale, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (!in_contract(N, C, H, W, Ho, Wo) || (with_act && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* wt = static_cast<const T*>(wmT);
  const T* ht = static_cast<const T*>(hm);
  T* ot = static_cast<T*>(out);
  if (with_act) launch_fwd_act<T, true>(xt, bt, wt, ht, ot, N, C, H, W, Ho, Wo, slope, scale, s);
  else launch_fwd_act<T, false>(xt, bt, wt, ht, ot, N, C, H, W, Ho, Wo, slope, scale, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* bias, const void* wm, const void* hmT, void* dx,
               int N, int C, int H, int W, int Ho, int Wo, float scale_pos, float scale_neg, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (!in_contract(N, C, H, W, Ho, Wo) || bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (H + kTM - 1) / kTM;
  chain_bwd<T><<<static_cast<unsigned>(N) * n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(wm), static_cast<const T*>(hmT), static_cast<T*>(dx), n_tiles, C, H, W, Ho, Wo,
      scale_pos, scale_neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_chain_fwd_f32(const void* x, const void* bias, const void* wmT, const void* hm,
                                   void* out, int N, int C, int H, int W, int Ho, int Wo, int with_act,
                                   float slope, float scale, void* stream) {
  return launch_fwd<float>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, with_act, slope, scale, stream);
}

extern "C" int fused_chain_fwd_bf16(const void* x, const void* bias, const void* wmT, const void* hm,
                                    void* out, int N, int C, int H, int W, int Ho, int Wo, int with_act,
                                    float slope, float scale, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, bias, wmT, hm, out, N, C, H, W, Ho, Wo, with_act, slope, scale, stream);
}

extern "C" int fused_chain_bwd_f32(const void* g, const void* x, const void* bias, const void* wm,
                                   const void* hmT, void* dx, int N, int C, int H, int W, int Ho, int Wo,
                                   float scale_pos, float scale_neg, void* stream) {
  return launch_bwd<float>(g, x, bias, wm, hmT, dx, N, C, H, W, Ho, Wo, scale_pos, scale_neg, stream);
}

extern "C" int fused_chain_bwd_bf16(const void* g, const void* x, const void* bias, const void* wm,
                                    const void* hmT, void* dx, int N, int C, int H, int W, int Ho, int Wo,
                                    float scale_pos, float scale_neg, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, x, bias, wm, hmT, dx, N, C, H, W, Ho, Wo, scale_pos, scale_neg, stream);
}

extern "C" const char* fused_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
