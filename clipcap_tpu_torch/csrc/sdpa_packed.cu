// Encoder attention straight off the packed qkv projection, on Hopper
// (sm_90a).
//
// Replaces the TPU kernels of clipcap_tpu/ops/attention.py::sdpa_packed —
// both its Pallas forms, _packed_stripe_kernel and _packed_kernel, which
// compute the same function and differ only in how they fit TPU VMEM.
//
//   qkv [B, N, 3D]  the in_proj output: q | k | v on the last axis, each
//                   head-major (head h at columns h*64 .. h*64 + 63)
//   out [B, N, D] = softmax(q.k^T * scale (+ causal mask)) . v per head,
//                   heads back on the last axis, ready for out_proj
//
// What bounds it on the H100: at the encoder's row lengths (N <= 577) the
// work is ~N*64*4 flops per byte of q/k/v, and the [B, H, N, N] logits a
// plain implementation writes and reads back dominate its memory traffic;
// with at most a few thousand small blocks per call the launch and the
// tail also count.  So one launch covers every (sample, head, query tile)
// of a layer, reads q/k/v in place from the packed tensor (no head-split
// copies), and keeps logits and softmax in registers: device memory sees
// qkv read once per query tile and the context written once.  Keys stream
// through shared memory in tiles of 32 with an fp32 online softmax, so any
// N runs with no fallback.  Two threads own one query row (each holds half
// of q and of the accumulator and they combine dot products with one
// shuffle).  Tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kDh = 64;            // head_dim of every CLIP preset
constexpr int kQTile = 64;         // query rows per block (two threads each)
constexpr int kKTile = 32;         // keys per shared-memory tile
constexpr int kThreads = 2 * kQTile;
constexpr int kHalf = kDh / 2;     // dims per thread: 2*i + half

template <typename T>
__global__ void __launch_bounds__(kThreads)
sdpa_packed_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                   int N, int H, int causal, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kDh / kVec;          // 16-byte loads per head row
  __shared__ float ks[kKTile][kDh];
  __shared__ float vs[kKTile][kDh];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const int D = H * kDh;
  const size_t row_stride = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * N * row_stride;
  const int tid = threadIdx.x;
  const int row = q0 + (tid >> 1);
  const int half = tid & 1;
  const bool active = row < N;

  float q[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    q[i] = active ? to_float(base[row * row_stride + h * kDh + 2 * i + half]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int k_end = causal ? min(N, q0 + kQTile) : N;
  for (int k0 = 0; k0 < k_end; k0 += kKTile) {
    const int n = min(kKTile, k_end - k0);
    __syncthreads();                             // previous tile consumed
    for (int c = tid; c < 2 * n * kChunks; c += kThreads) {
      const int which = c / (n * kChunks);       // 0: K, 1: V
      const int rem = c % (n * kChunks);
      const int j = rem / kChunks, off = (rem % kChunks) * kVec;
      const uint4 v = *reinterpret_cast<const uint4*>(
          base + (size_t)(k0 + j) * row_stride + (which + 1) * D + h * kDh + off);
      const T* e = reinterpret_cast<const T*>(&v);
      float* dst = which ? &vs[j][off] : &ks[j][off];
#pragma unroll
      for (int t = 0; t < kVec; ++t) dst[t] = to_float(e[t]);
    }
    __syncthreads();

    float s[kKTile];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) part += q[i] * ks[j][2 * i + half];
      const float dot = part + __shfl_xor_sync(0xffffffffu, part, 1);
      const int key = k0 + j;
      s[j] = (j < n && (!causal || key <= row)) ? dot * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // row fully hidden so far
    const float alpha = expf(m - m_use);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float pj = expf(s[j] - m_use);
      lsum += pj;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] += pj * vs[j][2 * i + half];
    }
    l = l * alpha + lsum;
    m = m_new;
  }

  if (active) {
    T* o = out + ((size_t)b * N + row) * D + h * kDh;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) o[2 * i + half] = from_float<T>(acc[i] * inv);
  }
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_sdpa_packed(const void* qkv, void* out, int B, int N, int H,
                                   int causal, int dtype, float scale, void* stream) {
  using namespace clipcap;
  const dim3 grid((N + kQTile - 1) / kQTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    sdpa_packed_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
        N, H, causal, scale);
  } else {
    sdpa_packed_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), N, H, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
