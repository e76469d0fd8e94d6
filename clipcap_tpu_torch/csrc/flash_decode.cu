// Flash-decode attention: one KV-cached decode step over the interleaved
// K|V cache, on Hopper (sm_90a).
//
// Replaces the TPU kernel clipcap_tpu/ops/flash_decode.py::flash_decode
// (_flash_call -> _kernel, online-softmax core _flash_update) in its
// bf16/fp32 form with a scalar u_valid.
//
//   q    [R, H, K, 64]   this step's queries (K beams, or K = 1)
//   kv   [R, H, U, 128]  cache; slot u holds K in [0, 64), V in [64, 128)
//   mask [Rm, K, U]      fp32 additive (beam ancestry or causal), Rm in {1, R}
//   out  [R, H, K, 64] = softmax(q.k^T / 8 + mask) . v over slots [0, u_valid)
//
// What bounds it on the H100: bytes.  Every decode step reads each written
// cache slot once (256 bytes per slot and head in bf16) to do 4*K flops per
// byte, far under the card's ~295 flops/byte ridge; the K*64 query values
// are read once per block.  The design therefore reads each valid slot
// exactly once, with 16-byte coalesced loads into a shared-memory tile, and
// never touches slots at or beyond u_valid (the padded tail of the buffer
// and the steps not yet written).  One thread block per (row, head) walks
// the slots in tiles of 64 and keeps the fp32 online-softmax state
// (running max, sum, accumulator) on chip.  Tensor cores, TMA and a split
// over the slot axis are later work.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kDh = 64;              // head_dim of every GPT-2 preset
constexpr int kRow = 2 * kDh;        // one interleaved K|V slot
constexpr int kTile = 64;            // cache slots per shared-memory tile
constexpr int kThreads = 128;
constexpr int kMaxK = 8;             // queries per (row, head)

// Row padding of the staged tile: an odd number of 32-bit words per slot
// keeps the thread-per-slot reads of the logits phase free of bank conflicts.
template <typename T> struct TilePad;
template <> struct TilePad<__nv_bfloat16> { static constexpr int value = 2; };  // 65 words
template <> struct TilePad<float> { static constexpr int value = 1; };          // 129 words

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                    const float* __restrict__ mask, T* __restrict__ out,
                    int H, int K, int U, int Rm, int u_valid, float scale) {
  constexpr int kStride = kRow + TilePad<T>::value;
  constexpr int kVec = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int kChunks = kRow / kVec;           // 16-byte loads per slot
  __shared__ __align__(16) T tile[kTile * kStride];
  __shared__ float qs[kMaxK][kDh];
  __shared__ float p[kMaxK][kTile];              // logits, then weights
  __shared__ float alpha_s[kMaxK], m_s[kMaxK], l_s[kMaxK];

  const int rh = blockIdx.x;                     // r * H + h
  const int r = rh / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* kv_rh = kv + (size_t)rh * U * kRow;
  const float* mask_r = mask + (size_t)(Rm > 1 ? r : 0) * K * U;

  for (int i = tid; i < K * kDh; i += kThreads)
    qs[i / kDh][i % kDh] = to_float(q[(size_t)rh * K * kDh + i]);
  if (tid < K) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // Value phase ownership: output dim d, queries k0, k0 + 2, k0 + 4, k0 + 6.
  const int d = tid % kDh;
  const int k0 = tid / kDh;
  float acc[kMaxK / 2];
#pragma unroll
  for (int j = 0; j < kMaxK / 2; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int u0 = 0; u0 < u_valid; u0 += kTile) {
    const int n = min(kTile, u_valid - u0);

    // Stage slots [u0, u0 + n): coalesced 16-byte loads, 4-byte stores.
    for (int c = tid; c < n * kChunks; c += kThreads) {
      const int s = c / kChunks, off = (c % kChunks) * kVec;
      const uint4 v = *reinterpret_cast<const uint4*>(kv_rh + (size_t)(u0 + s) * kRow + off);
      uint32_t* dst = reinterpret_cast<uint32_t*>(tile + s * kStride + off);
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    __syncthreads();

    // Logits: thread per slot; the two halves of the block take alternate
    // queries.  Slots past u_valid get -inf and weigh exactly 0.
    {
      const int s = tid % kTile;
      const T* krow = tile + s * kStride;
      for (int k = tid / kTile; k < K; k += kThreads / kTile) {
        float logit = -INFINITY;
        if (s < n) {
          float dot = 0.f;
#pragma unroll 8
          for (int j = 0; j < kDh; j += 2) {
            const float2 kk = load2(krow + j);
            dot += qs[k][j] * kk.x + qs[k][j + 1] * kk.y;
          }
          logit = dot * scale + mask_r[(size_t)k * U + u0 + s];
        }
        p[k][s] = logit;
      }
    }
    __syncthreads();

    // Online softmax: one warp per query.
    for (int k = warp; k < K; k += kThreads / 32) {
      const float a = p[k][lane], b = p[k][lane + 32];
      const float m_old = m_s[k];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // all hidden so far
      const float ea = expf(a - m_use), eb = expf(b - m_use);
      p[k][lane] = ea;
      p[k][lane + 32] = eb;
      const float sum = warp_sum(ea + eb);
      if (lane == 0) {
        const float al = expf(m_old - m_use);
        alpha_s[k] = al;
        l_s[k] = l_s[k] * al + sum;
        m_s[k] = m_new;
      }
    }
    __syncthreads();

    // Values: acc[k][d] = acc * alpha + sum_s w[k][s] * V[s][d].
#pragma unroll
    for (int j = 0; j < kMaxK / 2; ++j)
      if (k0 + 2 * j < K) acc[j] *= alpha_s[k0 + 2 * j];
    for (int s = 0; s < n; ++s) {
      const float v = to_float(tile[s * kStride + kDh + d]);
#pragma unroll
      for (int j = 0; j < kMaxK / 2; ++j)
        if (k0 + 2 * j < K) acc[j] += p[k0 + 2 * j][s] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxK / 2; ++j) {
    const int k = k0 + 2 * j;
    if (k < K)
      out[((size_t)rh * K + k) * kDh + d] = from_float<T>(acc[j] / fmaxf(l_s[k], 1e-30f));
  }
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_flash_decode(const void* q, const void* kv, const void* mask, void* out,
                                    int R, int H, int K, int U, int Rm, int u_valid,
                                    int dtype, float scale, void* stream) {
  using namespace clipcap;
  const dim3 grid(R * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    flash_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
        static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out),
        H, K, U, Rm, u_valid, scale);
  } else {
    flash_decode_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kv),
        static_cast<const float*>(mask), static_cast<float*>(out),
        H, K, U, Rm, u_valid, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
