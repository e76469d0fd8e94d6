// CLIP's QuickGELU, out = x·σ(1.702·x), and its input gradient, each as one
// elementwise pass on Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves QuickGELU
// (clipcap_tpu/ops/layers.py::quick_gelu) to XLA, which fuses it.  Eager
// PyTorch runs the formula as three passes (the scale, the sigmoid, the
// product): seven tensor-sized reads and writes, where the function needs
// one read and one write.
//
//   clipcap_quick_gelu:           out = x·s
//   clipcap_quick_gelu_backward:  dx  = dy·(s + a·s·(1 − s))
//
// with a = 1.702·x and s = σ(a) = 1 / (1 + exp(−a)), recomputed from x in
// the backward (nothing else is saved).  float32 inside, in the order of
// the plain twins (ops/quick_gelu.py), and one rounding to the tensors'
// dtype, bf16 or fp32.  In fp32 the forward is the eager chain's own
// arithmetic: a rounded, expf, an IEEE reciprocal, the product rounded.
//
// What bounds it on the H100: bytes.  A bf16 element costs 4 bytes (6 in
// the backward) for ~20 instructions, well under the card's issue rate at
// 3.35 TB/s.  So the design is one read and one write: each thread moves
// kUnroll 16-byte words (8 bf16 or 4 fp32 elements each), issuing all its
// loads before any arithmetic, in a grid that covers the tensor once; a
// thread's words lie a grid's width apart, so each warp's loads and stores
// stay whole 512-byte runs.  At [256, 257, 4096] bf16 the forward takes what
// a copy of the same bytes takes (0.358 ms against 0.357 for `copy_`, 90%
// of the bytes' bound); a persistent grid of 4 blocks an SM striding over
// the tensor took 0.401-0.408 ms.  Where a pointer is not 16-byte aligned
// (a view with a storage offset; the outputs are fresh allocations) the
// whole tensor takes the scalar path, as does the tail of fewer than 16
// bytes after the last whole word.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;        // resident blocks an SM: at most 64 registers a thread
constexpr int kUnroll = 4;           // 16-byte words in flight a thread
constexpr float kAlpha = 1.702f;

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

struct Forward {
  static constexpr bool kGrad = false;
  __device__ __forceinline__ float operator()(float x, float) const {
    return x * sigmoid(kAlpha * x);
  }
};

struct Backward {
  static constexpr bool kGrad = true;
  __device__ __forceinline__ float operator()(float x, float dy) const {
    const float a = kAlpha * x, s = sigmoid(a);
    return dy * (s + a * (s * (1.f - s)));
  }
};

// One 16-byte word as kN floats, and back (bf16 rounded to nearest even).
template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void widen(const uint4& w, float (&f)[kN]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  // Each 32-bit lane holds two elements, the first in its low half.
  static __device__ __forceinline__ void widen(const uint4& w, float (&f)[kN]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[kN]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  }
};

// Elements [0, words·kN) as 16-byte words, thread t's the words t + k·width
// (width = the grid's threads, k < kUnroll); [words·kN, n) one by one, one
// a thread.  dy is read only by the backward.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quick_gelu_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ out,
                  int64_t n, int64_t words, Op op) {
  using W = Word<T>;
  const int64_t width = int64_t(gridDim.x) * kThreads;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const uint4* xw = reinterpret_cast<const uint4*>(x);
  const uint4* dw = reinterpret_cast<const uint4*>(dy);
  uint4* ow = reinterpret_cast<uint4*>(out);
  uint4 a[kUnroll], b[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t w = tid + k * width;
    if (w < words) {
      a[k] = xw[w];
      if constexpr (Op::kGrad) b[k] = dw[w];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t w = tid + k * width;
    if (w < words) {
      float f[W::kN], g[W::kN];
      W::widen(a[k], f);
      if constexpr (Op::kGrad) W::widen(b[k], g);
#pragma unroll
      for (int e = 0; e < W::kN; ++e) f[e] = op(f[e], Op::kGrad ? g[e] : 0.f);
      ow[w] = W::narrow(f);
    }
  }
  const int64_t i = words * W::kN + tid;
  if (i < n) out[i] = from_float<T>(op(to_float(x[i]), Op::kGrad ? to_float(dy[i]) : 0.f));
}

template <typename T, typename Op>
int launch(const void* x, const void* dy, void* out, int64_t n, cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         (Op::kGrad ? reinterpret_cast<uintptr_t>(dy) : 0);
  const int64_t words = (bits & 15) == 0 ? n / Word<T>::kN : 0;
  const int64_t scalars = n - words * Word<T>::kN;
  const int64_t threads = std::max((words + kUnroll - 1) / kUnroll, scalars);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  quick_gelu_kernel<T, Op><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(out), n, words,
      Op{});
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int dispatch(const void* x, const void* dy, void* out, long long n, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kFloat32: return launch<float, Op>(x, dy, out, n, s);
    case kBFloat16: return launch<__nv_bfloat16, Op>(x, dy, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_quick_gelu(const void* x, void* out, long long n, int dtype,
                                  void* stream) {
  return clipcap::dispatch<clipcap::Forward>(x, nullptr, out, n, dtype, stream);
}

extern "C" int clipcap_quick_gelu_backward(const void* x, const void* dy, void* dx, long long n,
                                           int dtype, void* stream) {
  return clipcap::dispatch<clipcap::Backward>(x, dy, dx, n, dtype, stream);
}
