// Fused elementwise -> resample chain over (N, H, W) planes, forward (K4) and backward (K5),
// computed on the resample operators' non-zeros.
//
//   forward   out[p] = Hm (Ho,H) @ rnd( act(x[p] + bias[p % C]) @ WmT (W,Wo) )
//   backward  dx[p]  = rnd( (rnd(HmT (H,Ho) @ g[p]) @ Wm (Wo,W)) * mask(x[p] + bias[p % C]) )
//
// act = leaky_relu(., slope) * scale computed in f32 and rounded to the storage type
// (skipped when with_act = 0: then the forward is a bare two-sided resample, and with
// the adjoint operators it is that resample's adjoint); mask = scale where the
// pre-activation is >= 0, else scale * slope; rnd rounds to the storage type (f32 or
// bf16); every sum accumulates in f32 with fmaf, term by term in ascending input index.
//
// Replaces the Pallas TPU kernels dusty_gan_v2_tpu/ops/fused_chain.py::_fwd_call (:51; via
// fused_act_resample, pallas_resample and _pr_bwd) and ::_bwd_call (:104; via _far_bwd),
// which hold a few whole planes and both dense operators in VMEM and run two MXU
// matmuls per plane.
//
// Operator form. Each pass takes its operator in padded-row ("ELL") form, oriented as the
// pass contracts: for each output index o of the pass, idx[o * nnz + k] and
// val[o * nnz + k], k < nnz, are the input indices of that output's non-zeros in
// ascending order and their values in the storage type. A row with fewer than nnz
// non-zeros is padded with value 0 at the row's last index (0 for an empty row), so a
// padding term adds +0 and reads nothing the row does not already read. The forms are
// built once on the host (ops/fused_chain.py::ell_rows); a dense operator is an ELL whose
// nnz is its full width, so any operator is taken.
//
// Bound on the H100. The ring blur, 2x up and 2x down operators of the discriminator and
// the generator have at most 4 non-zeros per row: at most 16 f32 operations per output
// element against 4 (bf16) or 8 (f32) bytes of the plane read and written, far below the
// card's f32 ridge (~20 flop/byte) and its tensor-core ridge. So moving each plane
// through device memory once bounds these kernels, and the design aims at that; what
// it spends instead is instructions, so it keeps them few:
//   - operator entries: when both operators have rows of width 4 (the discriminator's
//     blur, the one operator the chain runs) a thread holds its output's entries in
//     registers, read in two vector loads; rows of any other width (2x up or down,
//     dense operators) are read from global memory term by term;
//   - forward: a block owns (plane, kTN output columns) and every row. In the W-pass a
//     warp owns 32 adjacent output columns of one row and reads x straight through the
//     entries' indices (neighbouring threads read neighbouring addresses; L1 serves the
//     <= 3-column halo and the ring wrap). Each term is activated (bias + leaky-ReLU +
//     scale in f32, rounded) before its product, so an element is activated once per
//     output that reads it (4 times for the blur): instructions, but no bytes. (Staging
//     the tile's input window in shared memory with the activation applied once was
//     measured slower.) The rounded (H, kTN) intermediate stays in shared memory; in the
//     H-pass a thread owns four adjacent columns, so that one vector read of the
//     intermediate per entry and one vector store serve four outputs;
//   - backward: a block owns (plane, kTM rows) and every column. The adjoint H-pass forms
//     the (kTM, Wo) tile from the rows of g that HmT's entries name (<= 4 per row for
//     the blur), four adjacent columns per vector load, and rounds it into shared
//     memory; the adjoint W-pass reads the tile through Wm's entries, multiplies by the
//     mask from the saved x and the bias, rounds and writes dx.
// No tensor cores: at <= 16 flop per element they would have nothing to speed up.
//
// Non-finite inputs: an output depends only on the inputs its operator rows reach, as in
// a direct convolution, so a NaN or Inf in x or g reaches only the outputs whose band
// covers it. (The dense plain version, the CPU route, spreads it over the whole plane:
// 0 * NaN = NaN.)
//
// Shape contract (checked by the launchers): 1 <= H, Ho <= 128, 1 <= W, Wo <= 512 and
// nnz >= 1 for both operators. The planes and the ELL forms start 16-byte aligned (the
// wrappers check it): g and the ELL rows are read in vector loads.
//
// C interface (ctypes): each entry launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue outside the
// shape contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;            // H, Ho
constexpr int kMaxCols = 512;            // W, Wo
constexpr int kTN = 64;                  // forward: output columns per block
constexpr int kRowGroups = kThreads / kTN;
constexpr int kQuads = kTN / 4;          // forward H-pass: groups of four columns per tile
constexpr int kTM = 16;                  // backward: rows per block

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

// Threads per row of a block's pass over n columns: the power of two at or above n, at
// most kThreads, so that kThreads / it row groups cover the block.
__device__ __forceinline__ int cols_per_pass(int n) {
  int per = 1;
  while (per < n && per < kThreads) per *= 2;
  return per;
}

// K values of type T from 16-byte-aligned global memory in vector loads (K * sizeof(T)
// is 8 or 16 bytes; the ELL rows of width 4 are that aligned).
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&out)[K]) {
  constexpr int kBytes = K * sizeof(T);
  static_assert(kBytes == 8 || kBytes == 16, "row of 8 or 16 bytes");
  using V = typename std::conditional<kBytes == 16, int4, int2>::type;
  const V v = *reinterpret_cast<const V*>(p);
  memcpy(out, &v, kBytes);
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ float4 fma_acc(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

// Four adjacent values from 4-element-aligned memory, in one vector load.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

// Four adjacent outputs to 4-element-aligned memory, in one vector store.
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One output's ELL entries: in registers, read in vector loads, when the width K is
// known at compile time (4: the blur); else read from global memory term by term (K = 0:
// any width, e.g. a 2x resample or a dense operator). sum(term) is
// sum_k val[k] * term(idx[k]) in ascending k, for a float or float4 term.
template <typename T, int K>
struct Taps {
  int idx[K];
  float val[K];
  __device__ __forceinline__ Taps(const int* __restrict__ gi, const T* __restrict__ gv, int o, int) {
    T v[K];
    load_row<int, K>(gi + o * K, idx);
    load_row<T, K>(gv + o * K, v);
#pragma unroll
    for (int k = 0; k < K; ++k) val[k] = ld(v + k);
  }
  template <typename F>
  __device__ __forceinline__ auto sum(F term) const -> decltype(term(0)) {
    decltype(term(0)) acc{};
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fma_acc(val[k], term(idx[k]), acc);
    return acc;
  }
};

template <typename T>
struct Taps<T, 0> {
  const int* idx;
  const T* val;
  int n;
  __device__ __forceinline__ Taps(const int* __restrict__ gi, const T* __restrict__ gv, int o, int nnz)
      : idx(gi + static_cast<int64_t>(o) * nnz), val(gv + static_cast<int64_t>(o) * nnz), n(nnz) {}
  template <typename F>
  __device__ __forceinline__ auto sum(F term) const -> decltype(term(0)) {
    decltype(term(0)) acc{};
#pragma unroll 4
    for (int k = 0; k < n; ++k) acc = fma_acc(ld(val + k), term(idx[k]), acc);
    return acc;
  }
};

// ---------------------------------------------------------------------------- forward

// One block: plane = blockIdx.x / n_tiles, output columns [j0, j0 + kTN), every row.
// w_* is the W-pass's form (Wo rows of width nw, indices into W), h_* the H-pass's (Ho
// rows of width nh, indices into H); K = nw = nh = 4, or 0.
// W-pass: thread (threadIdx.x % kTN, threadIdx.x / kTN) owns one column and the rows of
// its row group, and reads x straight through its column's indices; H-pass: thread
// (threadIdx.x % kQuads, threadIdx.x / kQuads) owns four adjacent columns and the rows of
// its group, and reads the intermediate and writes the output as vectors.
template <typename T, bool ACT, int K>
__global__ void __launch_bounds__(kThreads)
chain_fwd(const T* __restrict__ x, const T* __restrict__ bias, const int* __restrict__ w_idx,
          const T* __restrict__ w_val, int nw, const int* __restrict__ h_idx, const T* __restrict__ h_val, int nh,
          T* __restrict__ out, int n_tiles, int C, int H, int W, int Ho, int Wo, float slope, float scale) {
  extern __shared__ __align__(16) float Zs[];  // rounded intermediate, Zs[h * kTN + column in tile]
  const int plane = blockIdx.x / n_tiles, j0 = (blockIdx.x % n_tiles) * kTN;

  // W-pass: Z[h, j] = rnd(sum_k w_val[j, k] * act(x[h, w_idx[j, k]]))
  {
    const int tx = threadIdx.x % kTN, j = j0 + tx;
    if (j < Wo) {
      const T* xp = x + static_cast<int64_t>(plane) * H * W;
      const float b = ACT ? ld(bias + plane % C) : 0.f;
      const Taps<T, K> taps(w_idx, w_val, j, nw);
#pragma unroll 8
      for (int h = threadIdx.x / kTN; h < H; h += kRowGroups) {
        const T* row = xp + static_cast<int64_t>(h) * W;
        Zs[h * kTN + tx] = rnd<T>(taps.sum([&](int c) {
          const float v = ld(row + c);
          return ACT ? rnd<T>(bias_act(v, b, slope, scale)) : v;
        }));
      }
    }
  }
  __syncthreads();

  // H-pass: out[i, j:j+4] = rnd(sum_k h_val[i, k] * Z[h_idx[i, k], j:j+4])
  const int q = threadIdx.x % kQuads, j = j0 + 4 * q;
  if (j >= Wo) return;
  T* op = out + static_cast<int64_t>(plane) * Ho * Wo + j;
  const bool whole = Wo % 4 == 0;  // then j + 3 < Wo and the row is 4-element aligned
#pragma unroll 2
  for (int i = threadIdx.x / kQuads; i < Ho; i += kThreads / kQuads) {
    const Taps<T, K> taps(h_idx, h_val, i, nh);
    const float4 v = taps.sum([&](int h) { return *reinterpret_cast<const float4*>(Zs + h * kTN + 4 * q); });
    T* o = op + static_cast<int64_t>(i) * Wo;
    if (whole) {
      st4(o, v);
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && j + e < Wo; ++e) st(o + e, vs[e]);
    }
  }
}

// ---------------------------------------------------------------------------- backward

// One block: plane = blockIdx.x / n_tiles, rows [i0, i0 + kTM) of the (H, W) plane, every
// column. h_* is the adjoint H-pass's form (H rows of width nh, indices into Ho), w_* the
// adjoint W-pass's (W rows of width nw, indices into Wo); K = nw = nh = 4, or 0.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
chain_bwd(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ bias,
          const int* __restrict__ w_idx, const T* __restrict__ w_val, int nw, const int* __restrict__ h_idx,
          const T* __restrict__ h_val, int nh, T* __restrict__ dx, int n_tiles, int C, int H, int W, int Ho,
          int Wo, float scale_pos, float scale_neg) {
  extern __shared__ __align__(16) float Ts[];  // rounded adjoint H-pass of the block's rows, Ts[r * Wo + wo]
  const int plane = blockIdx.x / n_tiles;
  const int i0 = (blockIdx.x % n_tiles) * kTM;
  const int rows = min(kTM, H - i0);

  // adjoint H-pass: T[r, wo] = rnd(sum_k h_val[i0 + r, k] * g[h_idx[i0 + r, k], wo]); a
  // thread reads four adjacent wo as a vector where the rows allow it
  const T* gp = g + static_cast<int64_t>(plane) * Ho * Wo;
  if (Wo % 4 == 0) {
    const int quads = Wo / 4, per = cols_per_pass(quads), groups = kThreads / per;
    for (int r = threadIdx.x / per; r < rows; r += groups) {
      const Taps<T, K> taps(h_idx, h_val, i0 + r, nh);
      for (int wq = threadIdx.x % per; wq < quads; wq += per) {
        const float4 v = taps.sum([&](int ho) { return ld4(gp + static_cast<int64_t>(ho) * Wo + 4 * wq); });
        *reinterpret_cast<float4*>(Ts + r * Wo + 4 * wq) = rnd4<T>(v);
      }
    }
  } else {
    const int per = cols_per_pass(Wo), groups = kThreads / per;
    for (int r = threadIdx.x / per; r < rows; r += groups) {
      const Taps<T, K> taps(h_idx, h_val, i0 + r, nh);
      for (int wo = threadIdx.x % per; wo < Wo; wo += per)
        Ts[r * Wo + wo] = rnd<T>(taps.sum([&](int ho) { return ld(gp + static_cast<int64_t>(ho) * Wo + wo); }));
    }
  }
  __syncthreads();

  // adjoint W-pass: gy[r, c] = sum_k w_val[c, k] * T[r, w_idx[c, k]], then the mask
  const int per = cols_per_pass(W), groups = kThreads / per;
  const float b = ld(bias + plane % C);
  const int64_t base = (static_cast<int64_t>(plane) * H + i0) * W;
  for (int c = threadIdx.x % per; c < W; c += per) {
    const Taps<T, K> taps(w_idx, w_val, c, nw);
#pragma unroll 16
    for (int r = threadIdx.x / per; r < rows; r += groups) {
      const float* trow = Ts + r * Wo;
      const float gy = taps.sum([&](int wo) { return trow[wo]; });
      const int64_t o = base + static_cast<int64_t>(r) * W + c;
      const float pre = __fadd_rn(ld(x + o), b);
      st(dx + o, __fmul_rn(gy, pre >= 0.f ? scale_pos : scale_neg));
    }
  }
}

// ---------------------------------------------------------------------------- launchers

bool in_contract(int N, int C, int H, int W, int Ho, int Wo, int nw, int nh) {
  return N > 0 && C > 0 && H >= 1 && Ho >= 1 && W >= 1 && Wo >= 1 && H <= kMaxRows && Ho <= kMaxRows &&
         W <= kMaxCols && Wo <= kMaxCols && nw >= 1 && nh >= 1;
}

template <typename T, bool ACT, int K>
void launch_fwd_k(const T* x, const T* bias, const int* w_idx, const T* w_val, int nw, const int* h_idx,
                  const T* h_val, int nh, T* out, int N, int C, int H, int W, int Ho, int Wo, float slope,
                  float scale, cudaStream_t s) {
  const int n_tiles = (Wo + kTN - 1) / kTN;
  const size_t smem = sizeof(float) * H * kTN;
  chain_fwd<T, ACT, K><<<static_cast<unsigned>(N) * n_tiles, kThreads, smem, s>>>(
      x, bias, w_idx, w_val, nw, h_idx, h_val, nh, out, n_tiles, C, H, W, Ho, Wo, slope, scale);
}

template <typename T, bool ACT>
void launch_fwd_act(const T* x, const T* bias, const int* w_idx, const T* w_val, int nw, const int* h_idx,
                    const T* h_val, int nh, T* out, int N, int C, int H, int W, int Ho, int Wo, float slope,
                    float scale, cudaStream_t s) {
  if (nw == 4 && nh == 4)
    launch_fwd_k<T, ACT, 4>(x, bias, w_idx, w_val, nw, h_idx, h_val, nh, out, N, C, H, W, Ho, Wo, slope, scale, s);
  else
    launch_fwd_k<T, ACT, 0>(x, bias, w_idx, w_val, nw, h_idx, h_val, nh, out, N, C, H, W, Ho, Wo, slope, scale, s);
}

template <typename T>
int launch_fwd(const void* x, const void* bias, const int* w_idx, const void* w_val, int nw, const int* h_idx,
               const void* h_val, int nh, void* out, int N, int C, int H, int W, int Ho, int Wo, int with_act,
               float slope, float scale, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (!in_contract(N, C, H, W, Ho, Wo, nw, nh) || (with_act && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* wv = static_cast<const T*>(w_val);
  const T* hv = static_cast<const T*>(h_val);
  T* ot = static_cast<T*>(out);
  if (with_act) launch_fwd_act<T, true>(xt, bt, w_idx, wv, nw, h_idx, hv, nh, ot, N, C, H, W, Ho, Wo, slope, scale, s);
  else launch_fwd_act<T, false>(xt, bt, w_idx, wv, nw, h_idx, hv, nh, ot, N, C, H, W, Ho, Wo, slope, scale, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
void launch_bwd_k(const T* g, const T* x, const T* bias, const int* w_idx, const T* w_val, int nw,
                   const int* h_idx, const T* h_val, int nh, T* dx, int N, int C, int H, int W, int Ho, int Wo,
                   float scale_pos, float scale_neg, cudaStream_t s) {
  const int n_tiles = (H + kTM - 1) / kTM;
  const size_t smem = sizeof(float) * (H < kTM ? H : kTM) * Wo;
  chain_bwd<T, K><<<static_cast<unsigned>(N) * n_tiles, kThreads, smem, s>>>(
      g, x, bias, w_idx, w_val, nw, h_idx, h_val, nh, dx, n_tiles, C, H, W, Ho, Wo, scale_pos, scale_neg);
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* bias, const int* w_idx, const void* w_val, int nw,
               const int* h_idx, const void* h_val, int nh, void* dx, int N, int C, int H, int W, int Ho, int Wo,
               float scale_pos, float scale_neg, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (!in_contract(N, C, H, W, Ho, Wo, nw, nh) || bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* wv = static_cast<const T*>(w_val);
  const T* hv = static_cast<const T*>(h_val);
  T* dt = static_cast<T*>(dx);
  if (nw == 4 && nh == 4)
    launch_bwd_k<T, 4>(gt, xt, bt, w_idx, wv, nw, h_idx, hv, nh, dt, N, C, H, W, Ho, Wo, scale_pos, scale_neg, s);
  else
    launch_bwd_k<T, 0>(gt, xt, bt, w_idx, wv, nw, h_idx, hv, nh, dt, N, C, H, W, Ho, Wo, scale_pos, scale_neg, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_chain_fwd_f32(const void* x, const void* bias, const int* w_idx, const void* w_val, int nw,
                                   const int* h_idx, const void* h_val, int nh, void* out, int N, int C, int H,
                                   int W, int Ho, int Wo, int with_act, float slope, float scale, void* stream) {
  return launch_fwd<float>(x, bias, w_idx, w_val, nw, h_idx, h_val, nh, out, N, C, H, W, Ho, Wo, with_act, slope,
                           scale, stream);
}

extern "C" int fused_chain_fwd_bf16(const void* x, const void* bias, const int* w_idx, const void* w_val, int nw,
                                    const int* h_idx, const void* h_val, int nh, void* out, int N, int C, int H,
                                    int W, int Ho, int Wo, int with_act, float slope, float scale, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, bias, w_idx, w_val, nw, h_idx, h_val, nh, out, N, C, H, W, Ho, Wo, with_act,
                                   slope, scale, stream);
}

extern "C" int fused_chain_bwd_f32(const void* g, const void* x, const void* bias, const int* w_idx,
                                   const void* w_val, int nw, const int* h_idx, const void* h_val, int nh, void* dx,
                                   int N, int C, int H, int W, int Ho, int Wo, float scale_pos, float scale_neg,
                                   void* stream) {
  return launch_bwd<float>(g, x, bias, w_idx, w_val, nw, h_idx, h_val, nh, dx, N, C, H, W, Ho, Wo, scale_pos,
                           scale_neg, stream);
}

extern "C" int fused_chain_bwd_bf16(const void* g, const void* x, const void* bias, const int* w_idx,
                                    const void* w_val, int nw, const int* h_idx, const void* h_val, int nh, void* dx,
                                    int N, int C, int H, int W, int Ho, int Wo, float scale_pos, float scale_neg,
                                    void* stream) {
  return launch_bwd<__nv_bfloat16>(g, x, bias, w_idx, w_val, nw, h_idx, h_val, nh, dx, N, C, H, W, Ho, Wo,
                                   scale_pos, scale_neg, stream);
}

extern "C" const char* fused_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
