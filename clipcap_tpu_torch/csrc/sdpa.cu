// Encoder attention on Hopper (sm_90a): one attention core, two entry
// points that differ only in how q, k, v and the output are addressed.
//
// Replaces the TPU kernels of clipcap_tpu/ops/attention.py:
//   - sdpa_packed (_packed_stripe_kernel, _packed_kernel): q | k | v read
//     straight from the packed [B, N, 3D] in_proj output (head h at columns
//     h*64, D + h*64 and 2D + h*64 of rows of stride 3D), the context
//     written as [B, N, D] ready for out_proj;
//   - fused_sdpa (_sdpa_kernel): separate head-major [B, H, N, 64] q, k, v
//     and output (row stride 64, head stride N*64).
// Both compute out = softmax(q.k^T * scale (+ causal mask)) . v per
// (sample, head), with fp32 logits and softmax.  Each addressing is a base
// pointer per operand plus sample, head and row strides (Operands below).
//
// What bounds it on the H100: at ViT-L/14 batch 256 (N = 257, D = 1024) the
// work is 4*B*N^2*D = 69 GFLOP (0.070 ms at 989 TFLOP/s bf16) against 539 MB
// of q/k/v read once and context written once (0.161 ms at 3.35 TB/s), so
// the bytes bound it; a plain implementation adds the [B, H, N, N] logits
// and weights to that traffic.  The design keeps logits and softmax in
// registers and reads q/k/v in place (no head-split copies).
//
// bf16: tensor cores.  One block per (sample, head, 64 query rows), four
// warps of 16 query rows each.  The block's q tile is copied to shared
// memory once and each warp keeps its q fragments in registers (ldmatrix).
// Keys and values stream through shared memory in tiles of 64 rows,
// double-buffered by cp.async in 16-byte runs (a head row is 128 bytes;
// rows past N are zero-filled); rows are padded to 72 elements so that the
// eight row addresses of an ldmatrix fall in distinct banks.  S = q.k^T is
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); the scores are scaled (in
// log2 units), masked with -inf (keys >= N, and keys after the query under
// causal; a causal block stops at its diagonal tile) and go through an fp32
// online softmax in the accumulator fragments, the row max combined across
// the four threads of a quad by shuffles.  P is rounded to bf16 and becomes
// the A operand of P.V straight from the S accumulators; V comes in by
// ldmatrix.trans; the output accumulates in fp32 and is divided by the row
// sum once, then staged through shared memory for 16-byte stores.  wgmma and
// TMA are later work.
//
// fp32: CUDA cores, picked by dtype.  fp32 carries the parity gates (fp32
// beam-5 tokens equal through kernels and twins, 1e-4 against the twin),
// which bf16 tensor-core products cannot meet.  Two threads own one query
// row (each holds half of q and of the accumulator; they combine dot
// products with one shuffle); keys stream through shared memory in tiles of
// 32, converted to fp32, with the same online softmax.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kDh = 64;            // head_dim of every CLIP preset

// Where the operands of one call live, in elements: q, k and v share their
// sample / head / row strides, the output has its own.
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long in_sample, in_head, in_row;
  long long out_sample, out_head, out_row;
};

template <typename T>
__device__ __forceinline__ const T* head_of(const void* base, const Operands& op, int b, int h) {
  return static_cast<const T*>(base) + b * op.in_sample + h * op.in_head;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;        // query rows per block (16 per warp)
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kLd = kDh + 8;       // padded shared-memory row (144 bytes)

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kMmaThreads)
sdpa_mma_kernel(Operands op, int N, int causal, float scale_log2) {
  __shared__ __align__(128) bf16 qs[kBlockQ][kLd];       // q tile, then the output
  __shared__ __align__(128) bf16 ks[2][kBlockK][kLd];
  __shared__ __align__(128) bf16 vs[2][kBlockK][kLd];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qg = head_of<bf16>(op.q, op, b, h);
  const bf16* kg = head_of<bf16>(op.k, op, b, h);
  const bf16* vg = head_of<bf16>(op.v, op, b, h);
  const long long rs = op.in_row;

  // Rows [r0, r0 + 64) of one operand into a shared tile by cp.async, 16
  // bytes a thread and copy; rows at or past N are zero-filled.
  auto copy_tile = [&](bf16 (*dst)[kLd], const bf16* src, int r0) {
#pragma unroll
    for (int i = 0; i < kBlockK * kDh / 8 / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads, r = c >> 3, col = (c & 7) * 8;
      const bool ok = r0 + r < N;
      cp_async16(&dst[r][col], ok ? src + (r0 + r) * rs + col : src, ok);
    }
  };

  const int k_end = causal ? min(N, q0 + kBlockQ) : N;
  const int tiles = (k_end + kBlockK - 1) / kBlockK;
  copy_tile(qs, qg, q0);
  copy_tile(ks[0], kg, 0);
  copy_tile(vs[0], vg, 0);
  cp_async_commit();

  const int qw = q0 + warp * 16;                  // the warp's first query row
  const bool active = qw < N;                     // a warp past N only copies
  const int g = lane >> 2, t2 = (lane & 3) * 2;   // fragment row and column pair
  uint32_t qf[kDh / 16][4];
  float o[kDh / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};            // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};                        // this thread's part of the row sums

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kBlockK, st = it & 1;
    if (it + 1 < tiles) {                         // into the stage tile it - 1 left
      copy_tile(ks[st ^ 1], kg, k0 + kBlockK);
      copy_tile(vs[st ^ 1], vg, k0 + kBlockK);
    }
    cp_async_commit();
    cp_async_wait<1>();                           // tile it (and q) have landed
    __syncthreads();
    if (active) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < kDh / 16; ++kc)
          ldmatrix_x4(qf[kc], smem_addr(&qs[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]));
      }
      // Keys of this tile the warp needs: below N and, under causal, not
      // after its last row.  Whole 16-key chunks past that are skipped.
      int len = min(kBlockK, k_end - k0);
      if (causal) len = min(len, qw + 16 - k0);
      const bool edge = len < kBlockK || (causal && k0 + kBlockK - 1 > qw);

      // S = q . k^T: s[j] holds keys k0 + 8j + {t2, t2 + 1} of rows g, g + 8.
      float s[kBlockK / 8][4] = {};
#pragma unroll
      for (int kp = 0; kp < kBlockK / 16; ++kp) {
        if (kp * 16 >= len) continue;
#pragma unroll
        for (int kc = 0; kc < kDh / 16; ++kc) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(&ks[st][kp * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                           [kc * 16 + ((lane >> 3) & 1) * 8]));
          mma_bf16(s[2 * kp], qf[kc], kf[0], kf[1]);
          mma_bf16(s[2 * kp + 1], qf[kc], kf[2], kf[3]);
        }
      }

      // Scale, mask, and the online softmax of rows g and g + 8.
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + t2 + (e & 1), row = qw + g + (e >> 1) * 8;
            if (key >= N || (causal && key > row)) x = -INFINITY;
          }
          s[j][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row hidden so far
        const float alpha = exp2f(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kDh / 8; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }
      // P in bf16: the accumulators of keys 16c .. 16c + 15 are the A
      // fragment of chunk c of P . V.
      uint32_t pf[kBlockK / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const float p0 = exp2f(s[j][0] - mu[0]), p1 = exp2f(s[j][1] - mu[0]);
        const float p2 = exp2f(s[j][2] - mu[1]), p3 = exp2f(s[j][3] - mu[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      // o += P . V, V fragments by ldmatrix.trans of the [key][dim] tile.
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        if (kc * 16 >= len) continue;
#pragma unroll
        for (int dp = 0; dp < kDh / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(&vs[st][kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                                 [dp * 16 + (lane >> 4) * 8]));
          mma_bf16(o[2 * dp], pf[kc], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[kc], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                              // stage st is free again
  }

  if (!active) return;
  // Divide by the row sums once; stage the warp's 16 rows in its own rows of
  // the q tile (only this warp read them), then 16-byte stores.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    *reinterpret_cast<uint32_t*>(&qs[warp * 16 + g][j * 8 + t2]) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&qs[warp * 16 + g + 8][j * 8 + t2]) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(op.o) + b * op.out_sample + h * op.out_head;
#pragma unroll
  for (int i = 0; i < 16 * kDh / 8 / 32; ++i) {
    const int c = lane + 32 * i, r = c >> 3, col = (c & 7) * 8;
    if (qw + r < N)
      *reinterpret_cast<uint4*>(og + (qw + r) * op.out_row + col) =
          *reinterpret_cast<const uint4*>(&qs[warp * 16 + r][col]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kQTile = 64;         // query rows per block (two threads each)
constexpr int kKTile = 32;         // keys per shared-memory tile
constexpr int kThreads = 2 * kQTile;
constexpr int kHalf = kDh / 2;     // dims per thread: 2*i + half

__global__ void __launch_bounds__(kThreads)
sdpa_fp32_kernel(Operands op, int N, int causal, float scale) {
  constexpr int kVec = 4;                      // floats per 16-byte load
  constexpr int kChunks = kDh / kVec;          // 16-byte loads per head row
  __shared__ float ks[kKTile][kDh];
  __shared__ float vs[kKTile][kDh];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const float* qg = head_of<float>(op.q, op, b, h);
  const float* kg = head_of<float>(op.k, op, b, h);
  const float* vg = head_of<float>(op.v, op, b, h);
  const long long rs = op.in_row;
  const int tid = threadIdx.x;
  const int row = q0 + (tid >> 1);
  const int half = tid & 1;
  const bool active = row < N;

  float q[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    q[i] = active ? qg[row * rs + 2 * i + half] : 0.f;
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
      const float4 v = *reinterpret_cast<const float4*>((which ? vg : kg) + (k0 + j) * rs + off);
      float* dst = which ? &vs[j][off] : &ks[j][off];
      dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
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
    float* o = static_cast<float*>(op.o) + b * op.out_sample + h * op.out_head + row * op.out_row;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) o[2 * i + half] = acc[i] * inv;
  }
}

int launch(const Operands& op, int B, int N, int H, int causal, int dtype, float scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
    sdpa_mma_kernel<<<grid, kMmaThreads, 0, st>>>(op, N, causal, scale * 1.4426950408889634f);
  } else {
    const dim3 grid((N + kQTile - 1) / kQTile, H, B);
    sdpa_fp32_kernel<<<grid, kThreads, 0, st>>>(op, N, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clipcap

// qkv [B, N, 3D] packed (q | k | v, head-major within each), out [B, N, D].
extern "C" int clipcap_sdpa_packed(const void* qkv, void* out, int B, int N, int H,
                                   int causal, int dtype, float scale, void* stream) {
  using namespace clipcap;
  const long long D = (long long)H * kDh;
  const size_t bytes = D * (dtype == kBFloat16 ? sizeof(__nv_bfloat16) : sizeof(float));
  const char* base = static_cast<const char*>(qkv);
  const Operands op{base, base + bytes, base + 2 * bytes, out,
                    N * 3 * D, kDh, 3 * D, N * D, kDh, D};
  return launch(op, B, N, H, causal, dtype, scale, stream);
}

// q, k, v, out: contiguous head-major [B, H, N, 64].
extern "C" int clipcap_fused_sdpa(const void* q, const void* k, const void* v, void* out, int B,
                                  int H, int N, int causal, int dtype, float scale,
                                  void* stream) {
  using namespace clipcap;
  const long long head = (long long)N * kDh;
  const Operands op{q, k, v, out, H * head, head, kDh, H * head, head, kDh};
  return launch(op, B, N, H, causal, dtype, scale, stream);
}
