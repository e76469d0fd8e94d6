// One decode step of Kimi Delta Attention (KDA, the gated delta rule of
// Kimi-Linear's linear-attention layers) for beam rows, each continuing
// its parent row's state (ops/kda.py).
//
// Replaces no TPU kernel: the JAX package runs no linear-attention model.
// It was added for the Kimi-Linear captioner, whose 20 KDA layers keep a
// 32 × 128 × 128 float32 state a row: 2 MiB a layer and row, read and
// written whole at every step of a beam search.
//
// Per row b and head h, with p = parent[b] (−1: zero state and window):
//   q, k, v = SiLU(conv4(x)) over the parent's last three inputs and the
//     new one (depthwise, causal); the row's window moves on by one;
//   q ← q / ‖q‖ · d^-1/2, k ← k / ‖k‖ (eps inside the root);
//   S = Diag(exp g) S_src[p];  S += β k (v − Sᵀk)ᵀ;  S_dst[b] = S;
//   o = Sᵀ q.
//
// Bound: bytes.  A step reads each distinct parent's state and writes
// every row's (64 KiB a head each way) for ~7·d² operations a head: under
// one operation a byte, far below the card's ~295.  Design: one block of
// 128 threads a (row, head), grid ordered (sample, head, beam) so the
// beams that continue one parent run side by side and its state comes
// from L2 after the first read.  Warp w holds state rows [32w, 32w + 32)
// and lane l the four columns [4l, 4l + 4) of each: every row of S is one
// coalesced 512-byte float4 access per warp, the 32 loads of a thread are
// all issued before any use (128 registers of state, three blocks an SM),
// and the state never passes through shared memory.  The two
// reductions over the rows (Sᵀk and Sᵀq) are per-thread partial sums and
// one pass through shared memory.  The beam reorder is the read by
// parent: there is no gather or copy of state apart from the step.  The
// short convolutions' windows move the same way, inside the same block
// (thread t owns channel t of the head's q, k and v), so the step needs no
// launch between its projections and this kernel.  Stores are streaming
// (evict-first): the new state is read at the next step, after every
// other layer's.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kD = 128;              // head size (keys and values)
constexpr int kThreads = 128;        // four warps; thread t owns channel t
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kD / kWarps;   // state rows a warp

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
kda_decode_kernel(const T* __restrict__ xq, const T* __restrict__ xk, const T* __restrict__ xv,
                  long long x_ld, const T* __restrict__ wq, const T* __restrict__ wk,
                  const T* __restrict__ wv, const float* __restrict__ g, long long g_ld,
                  const float* __restrict__ beta, long long b_ld,
                  const int* __restrict__ parent, const T* __restrict__ conv_src,
                  T* __restrict__ conv_dst, const float* __restrict__ s_src,
                  float* __restrict__ s_dst, T* __restrict__ o, int H, int K, float eps,
                  float scale) {
  __shared__ float sq[kD], sk[kD], sv[kD], sdecay[kD];
  __shared__ __align__(16) float red[kWarps][kD];
  __shared__ float nrm[2][kWarps];

  const int kb = blockIdx.x % K;
  const int h = (blockIdx.x / K) % H;
  const int b = (blockIdx.x / (K * H)) * K + kb;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int HD = H * kD;
  const int c = h * kD + t;
  const int p = parent[b];

  // The short convolutions of this thread's channel of q, k and v.
  const T* xs[3] = {xq, xk, xv};
  const T* ws[3] = {wq, wk, wv};
  float y[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const T xn = xs[m][(size_t)b * x_ld + c];
    T win[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      win[j] = p >= 0 ? conv_src[(((size_t)p * 3 + m) * 3 + j) * HD + c] : from_float<T>(0.f);
    const T* w = ws[m] + (size_t)c * 4;
    const float acc = to_float(w[0]) * to_float(win[0]) + to_float(w[1]) * to_float(win[1]) +
                      to_float(w[2]) * to_float(win[2]) + to_float(w[3]) * to_float(xn);
    T* dst = conv_dst + ((size_t)b * 3 + m) * 3 * HD + c;
    dst[0] = win[1];
    dst[HD] = win[2];
    dst[2 * HD] = xn;
    y[m] = acc / (1.f + __expf(-acc));
  }

  // L2 norms of q and k over the head.
  const float qq = warp_sum(y[0] * y[0]), kk = warp_sum(y[1] * y[1]);
  if (lane == 0) {
    nrm[0][warp] = qq;
    nrm[1][warp] = kk;
  }
  sdecay[t] = __expf(g[(size_t)b * g_ld + h * kD + t]);
  __syncthreads();
  float qs = 0.f, ks = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qs += nrm[0][w];
    ks += nrm[1][w];
  }
  sq[t] = y[0] * rsqrtf(qs + eps) * scale;
  sk[t] = y[1] * rsqrtf(ks + eps);
  sv[t] = y[2];
  __syncthreads();

  // The parent's state, decayed, and this warp's part of Sᵀk.
  const size_t head = (size_t)h * kD * kD;
  const int row0 = warp * kRows;
  float4 S[kRows];
  if (p >= 0) {
    const float4* src = reinterpret_cast<const float4*>(s_src + (size_t)p * H * kD * kD + head) +
                        (size_t)row0 * (kD / 4) + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) S[i] = __ldg(src + (size_t)i * (kD / 4));
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) S[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float e = sdecay[row0 + i], kr = sk[row0 + i];
    S[i].x *= e;
    S[i].y *= e;
    S[i].z *= e;
    S[i].w *= e;
    a.x += S[i].x * kr;
    a.y += S[i].y * kr;
    a.z += S[i].z * kr;
    a.w += S[i].w * kr;
  }
  reinterpret_cast<float4*>(red[warp])[lane] = a;
  __syncthreads();

  // u = β (v − Sᵀk) on this lane's four columns.
  const float bt = beta[(size_t)b * b_ld + h];
  float u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = 4 * lane + q;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][col];
    u[q] = bt * (sv[col] - sum);
  }
  __syncthreads();                                   // red is reused for o

  // The delta update, the new state out, and this warp's part of Sᵀq.
  float4* dst = reinterpret_cast<float4*>(s_dst + (size_t)b * H * kD * kD + head) +
                (size_t)row0 * (kD / 4) + lane;
  float4 oa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float kr = sk[row0 + i], qr = sq[row0 + i];
    S[i].x += kr * u[0];
    S[i].y += kr * u[1];
    S[i].z += kr * u[2];
    S[i].w += kr * u[3];
    __stcs(dst + (size_t)i * (kD / 4), S[i]);
    oa.x += S[i].x * qr;
    oa.y += S[i].y * qr;
    oa.z += S[i].z * qr;
    oa.w += S[i].w * qr;
  }
  reinterpret_cast<float4*>(red[warp])[lane] = oa;
  __syncthreads();
  float out = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) out += red[w][t];
  o[((size_t)b * H + h) * kD + t] = from_float<T>(out);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long x_ld, const void* wq,
           const void* wk, const void* wv, const float* g, long long g_ld, const float* beta,
           long long b_ld, const int* parent, const void* conv_src, void* conv_dst,
           const float* s_src, float* s_dst, void* o, int B, int H, int K, float eps,
           float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || K <= 0 || B % K) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kda_decode_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), x_ld,
      static_cast<const T*>(wq), static_cast<const T*>(wk), static_cast<const T*>(wv), g, g_ld,
      beta, b_ld, parent, static_cast<const T*>(conv_src), static_cast<T*>(conv_dst), s_src,
      s_dst, static_cast<T*>(o), H, K, eps, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clipcap

// q, k, v [B, H·128] (row stride x_ld); wq, wk, wv [H·128, 4]; g [B, H, 128]
// fp32 (row stride g_ld); beta [B, H] fp32 (row stride b_ld); parent [B]
// int32 (device); conv_src/conv_dst [rows, 3, 3, H·128]; s_src/s_dst [rows,
// H, 128, 128] fp32 → o [B, H, 128].  Rows are K beams a sample.
extern "C" int clipcap_kda_decode(const void* q, const void* k, const void* v, long long x_ld,
                                  const void* wq, const void* wk, const void* wv,
                                  const float* g, long long g_ld, const float* beta,
                                  long long b_ld, const int* parent, const void* conv_src,
                                  void* conv_dst, const float* s_src, float* s_dst, void* o,
                                  int B, int H, int K, int dtype, float eps, float scale,
                                  cudaStream_t stream) {
  if (dtype == clipcap::kBFloat16)
    return clipcap::launch<__nv_bfloat16>(q, k, v, x_ld, wq, wk, wv, g, g_ld, beta, b_ld,
                                          parent, conv_src, conv_dst, s_src, s_dst, o, B, H, K,
                                          eps, scale, stream);
  if (dtype == clipcap::kFloat32)
    return clipcap::launch<float>(q, k, v, x_ld, wq, wk, wv, g, g_ld, beta, b_ld, parent,
                                  conv_src, conv_dst, s_src, s_dst, o, B, H, K, eps, scale,
                                  stream);
  return cudaErrorInvalidValue;
}
