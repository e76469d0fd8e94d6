// One decode step of a Mamba-2 mixer (Granite-4.0-H's state-space layers)
// for beam rows, each continuing its parent row's state (ops/mamba.py).
//
// Replaces no TPU kernel: the JAX package runs no state-space model.  It
// was added for the Granite-4.0-H captioner, whose 36 Mamba layers keep a
// 128 × 64 × 128 state a row (2 MiB in bf16): read and written whole at
// every step of a beam search.
//
// Per row b and head h, with p = parent[b] (−1: zero state and window):
//   x | B | C = SiLU(conv4(xBC) + bias) over the parent's last three
//     inputs and the new one (depthwise, causal); the row's window moves
//     on by one;
//   dt = softplus(dt_raw + dt_bias);  A = −exp(A_log);
//   S = exp(dt·A)·S_src[p] + dt·x ⊗ B  (float32), S_dst[b] = S (rounded);
//   y = S·C + D·x.
//
// Bound: bytes.  A step reads each distinct parent's state and writes
// every row's (16 KiB a head each way in bf16) for ~5·P·N operations a
// head: about one operation for six bytes, far below the card's ~20
// float32 operations a byte.  Design: one block of 128 threads a (row,
// head), grid ordered (sample, head, beam) so the beams that continue one
// parent run side by side and its state comes from L2 after the first
// read.  A state row (N = 128 values) is 16-byte chunks across 16 lanes
// (bf16; 32 in fp32), so a warp moves two whole rows (one in fp32) per
// access, coalesced; each thread holds 8 (16) rows of 8 (4) columns, all
// its loads issued before any use (32 registers of raw state), and the
// state never passes through shared memory.  y's reduction over the
// state's columns is a shuffle within the lanes of one row.  B and C are
// shared by all heads, so every block computes their convolution (256
// channels, ~4.5 KB of L2 reads against 32 KiB of state), and only head
// 0's block writes their window.  Stores are streaming (evict-first):
// the new state is read at the next step, after every other layer's.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kP = 64;               // head size (mamba_d_head)
constexpr int kN = 128;              // state size (mamba_d_state)
constexpr int kThreads = 128;        // thread t owns B's and C's channel t
constexpr int kTaps = 4;

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

// A 16-byte chunk of T as floats, and back.
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
}
template <typename T, int V>
__device__ __forceinline__ uint4 pack(const float (&f)[V]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_float<T>(f[i]);
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
mamba_decode_kernel(const T* __restrict__ xbc, long long x_ld, const T* __restrict__ dt,
                    long long dt_ld, const T* __restrict__ conv_w, const T* __restrict__ conv_b,
                    const T* __restrict__ A_log, const T* __restrict__ Dskip,
                    const T* __restrict__ dt_bias, const int* __restrict__ parent,
                    const T* __restrict__ conv_src, T* __restrict__ conv_dst,
                    const T* __restrict__ s_src, T* __restrict__ s_dst, T* __restrict__ y,
                    int H, int K) {
  constexpr int kVec = 16 / sizeof(T);             // state columns a chunk
  constexpr int kChunks = kN / kVec;               // lanes a state row
  constexpr int kRowsPerPass = kThreads / kChunks;
  constexpr int kPasses = kP / kRowsPerPass;       // state rows a thread
  __shared__ float sx[kP], sB[kN], sC[kN];

  const int kb = blockIdx.x % K;
  const int h = (blockIdx.x / K) % H;
  const int b = (blockIdx.x / (K * H)) * K + kb;
  const int t = threadIdx.x;
  const int HP = H * kP;
  const int C = HP + 2 * kN;
  const int p = parent[b];

  // The parent's state first: its loads are in flight during the rest.
  const int cc = t % kChunks, r0 = t / kChunks;
  const size_t head = (size_t)h * kP * kN;
  uint4 raw[kPasses];
  if (p >= 0) {
    const uint4* src = reinterpret_cast<const uint4*>(s_src + (size_t)p * H * kP * kN + head);
#pragma unroll
    for (int i = 0; i < kPasses; ++i)
      raw[i] = __ldg(src + (size_t)(r0 + i * kRowsPerPass) * kChunks + cc);
  } else {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // The convolution of one channel; the row's window moves on by one.
  auto conv = [&](int c, bool write) {
    const T xn = xbc[(size_t)b * x_ld + c];
    T win[kTaps - 1];
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j)
      win[j] = p >= 0 ? conv_src[((size_t)p * (kTaps - 1) + j) * C + c] : from_float<T>(0.f);
    const T* w = conv_w + (size_t)c * kTaps;
    const float acc = to_float(w[0]) * to_float(win[0]) + to_float(w[1]) * to_float(win[1]) +
                      to_float(w[2]) * to_float(win[2]) + to_float(w[3]) * to_float(xn) +
                      to_float(conv_b[c]);
    if (write) {
      T* dst = conv_dst + (size_t)b * (kTaps - 1) * C + c;
      dst[0] = win[1];
      dst[C] = win[2];
      dst[2 * C] = xn;
    }
    return silu(acc);
  };
  if (t < kP) sx[t] = conv(h * kP + t, true);
  sB[t] = conv(HP + t, h == 0);
  sC[t] = conv(HP + kN + t, h == 0);

  float step = to_float(dt[(size_t)b * dt_ld + h]) + to_float(dt_bias[h]);
  step = step > 20.f ? step : log1pf(expf(step));   // softplus, torch's threshold
  const float decay = expf(-step * expf(to_float(A_log[h])));
  const float d = to_float(Dskip[h]);
  __syncthreads();

  float bcol[kVec], ccol[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    bcol[j] = sB[cc * kVec + j];
    ccol[j] = sC[cc * kVec + j];
  }
  uint4* dst = reinterpret_cast<uint4*>(s_dst + (size_t)b * H * kP * kN + head);
  T* out = y + (size_t)b * HP + h * kP;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r0 + i * kRowsPerPass;
    float s[kVec];
    unpack<T, kVec>(raw[i], s);
    const float xr = sx[r];
    const float u = step * xr;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] = decay * s[j] + u * bcol[j];
      acc += s[j] * ccol[j];
    }
    __stcs(dst + (size_t)r * kChunks + cc, pack<T, kVec>(s));
#pragma unroll
    for (int o = kChunks / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (cc == 0) out[r] = from_float<T>(acc + d * xr);
  }
}

template <typename T>
int launch(const void* xbc, long long x_ld, const void* dt, long long dt_ld, const void* w,
           const void* conv_b, const void* A_log, const void* D, const void* dt_bias,
           const int* parent, const void* conv_src, void* conv_dst, const void* s_src,
           void* s_dst, void* y, int B, int H, int K, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || K <= 0 || B % K) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mamba_decode_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(xbc), x_ld, static_cast<const T*>(dt), dt_ld,
      static_cast<const T*>(w), static_cast<const T*>(conv_b), static_cast<const T*>(A_log),
      static_cast<const T*>(D), static_cast<const T*>(dt_bias), parent,
      static_cast<const T*>(conv_src), static_cast<T*>(conv_dst), static_cast<const T*>(s_src),
      static_cast<T*>(s_dst), static_cast<T*>(y), H, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clipcap

// xbc [B, H·64 + 256] (row stride x_ld); dt [B, H] (row stride dt_ld); w
// [H·64 + 256, 4]; conv_b [H·64 + 256]; A_log, D, dt_bias [H]; parent [B]
// int32 (device); conv_src/conv_dst [rows, 3, H·64 + 256]; s_src/s_dst
// [rows, H, 64, 128] → y [B, H·64].  One dtype for all but the parents.
// Rows are K beams a sample.
extern "C" int clipcap_mamba_decode(const void* xbc, long long x_ld, const void* dt,
                                    long long dt_ld, const void* w, const void* conv_b,
                                    const void* A_log, const void* D, const void* dt_bias,
                                    const int* parent, const void* conv_src, void* conv_dst,
                                    const void* s_src, void* s_dst, void* y, int B, int H, int K,
                                    int dtype, cudaStream_t stream) {
  if (dtype == clipcap::kBFloat16)
    return clipcap::launch<__nv_bfloat16>(xbc, x_ld, dt, dt_ld, w, conv_b, A_log, D, dt_bias,
                                          parent, conv_src, conv_dst, s_src, s_dst, y, B, H, K,
                                          stream);
  if (dtype == clipcap::kFloat32)
    return clipcap::launch<float>(xbc, x_ld, dt, dt_ld, w, conv_b, A_log, D, dt_bias, parent,
                                  conv_src, conv_dst, s_src, s_dst, y, B, H, K, stream);
  return cudaErrorInvalidValue;
}
