// Grouped expert products of a mixture-of-experts layer (DeepSeek-V2's
// routed experts), bf16 in, fp32 accumulation, bf16 out.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// It was added for the DeepSeek-V2-Lite captioner, whose 64 routed experts
// a layer take most of a beam decode step (ops/moe.py).
//
// The token-expert pairs arrive sorted by expert: rows [off[e], off[e+1])
// of the activations belong to expert e, and `off` is a device int32
// vector [E + 1], read by the kernel itself, so a launch needs no count on
// the host and a step can be dispatched without a device-to-host read.
//
//   clipcap_moe_gate_up: h[r] = silu(x[r]·W1ᵀ) ⊙ (x[r]·W3ᵀ) with the
//     expert's stacked [2F, D] weight (W1 rows [0, F), W3 rows [F, 2F));
//   clipcap_moe_down:    y[r] = h[r]·W2ᵀ with the expert's [D, F] weight.
//
// Bound: bytes.  At a beam decode step (640 rows × 6 experts over 64
// experts, ~60 rows an expert) each expert's weights (17.3 MB) are read
// once for ~60 rows: ~60 operations a byte, far under the card's ~295.
// Design: one block per (output tile of 128 columns, expert); it walks its
// expert's rows in tiles of 64 (one tile at the decode step) and streams
// the weight tile through a 4-stage cp.async ring of 64-deep k-slices
// (24 KB a stage: 8 KB of rows, 16 KB of weights), so each weight byte
// crosses HBM once per 64 rows and ~3 slices are in flight per block.
// Products on tensor cores (ldmatrix + mma.sync m16n8k16, XOR-swizzled
// shared tiles); eight warps, 2 (rows) × 4 (columns) of 32 × 32.  In the
// gate|up kernel a block's 128 weight rows are 64 gate rows and the 64
// matching up rows, and each warp holds both halves of its 16 columns,
// so SiLU·mul runs on the accumulators and h is written once, in bf16.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kBM = 64;       // rows a tile
constexpr int kBN = 128;      // weight rows a tile
constexpr int kBK = 64;       // k a slice
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
constexpr int kSmemBytes = kStages * kStageBytes;

// Byte offset of 16-byte chunk `c` of row `r` in a [rows][64] bf16 tile:
// chunk c sits at c ^ (r & 7), so ldmatrix's eight rows hit eight banks.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// One k-slice of the row tile (rows past `rows` zero-filled) and of the
// weight tile into stage buffers `a` and `b`.
__device__ __forceinline__ void load_slice(unsigned char* a, unsigned char* b,
                                           const __nv_bfloat16* x, int rows, int K,
                                           const __nv_bfloat16* w, const int* wrow, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (kBM * 8) / kThreads; ++i) {
    const int id = t + i * kThreads, r = id >> 3, c = id & 7;
    const bool ok = r < rows;
    cp_async16(a + swz(r, c), x + (size_t)(ok ? r : 0) * K + k0 + c * 8, ok);
  }
#pragma unroll
  for (int i = 0; i < (kBN * 8) / kThreads; ++i) {
    const int id = t + i * kThreads, r = id >> 3, c = id & 7;
    cp_async16(b + swz(r, c), w + (size_t)wrow[i] * K + k0 + c * 8, true);
  }
}

// GATED: the gate|up product with SiLU·mul (out [M, N/2... F]); else the
// plain product (out [M, N]).  `w` is the experts' [E, N, K] weights,
// `out_cols` the output row length, `n_tile_rows` how many weight rows
// the tile's 128 span (gated: the tile's 64 gate rows sit at n0 and its up
// rows at n0 + half).
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 2)
grouped_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const int* __restrict__ off, __nv_bfloat16* __restrict__ out, int K, int N,
               int out_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.y;
  const int lo = off[e], hi = off[e + 1];
  if (lo >= hi) return;                               // an expert no pair chose
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;            // 2 × 4 warps of 32 × 32
  const __nv_bfloat16* we = w + (size_t)e * N * K;
  // The tile's weight rows: gated, 64 gate rows from n0 and their up rows
  // from n0 + N/2; else 128 rows from n0.
  const int half = N / 2;
  const int n0 = GATED ? blockIdx.x * (kBN / 2) : blockIdx.x * kBN;
  int wrow[(kBN * 8) / kThreads];
#pragma unroll
  for (int i = 0; i < (kBN * 8) / kThreads; ++i) {
    const int r = (threadIdx.x + i * kThreads) >> 3;
    wrow[i] = GATED ? (r < kBN / 2 ? n0 + r : half + n0 + r - kBN / 2) : n0 + r;
  }
  // A warp's n8 blocks: gated, columns wn*16 + {0, 8} of the gate half and
  // the same of the up half (tile rows 64 + ...); else wn*32 + {0, 8, 16, 24}.
  int bcol[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bcol[j] = GATED ? (j < 2 ? wn * 16 + j * 8 : kBN / 2 + wn * 16 + (j - 2) * 8) : wn * 32 + j * 8;
  const int KT = K / kBK;

  for (int m0 = lo; m0 < hi; m0 += kBM) {
    const int rows = min(kBM, hi - m0);
    const __nv_bfloat16* xm = x + (size_t)m0 * K;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) {
        unsigned char* st = smem + s * kStageBytes;
        load_slice(st, st + kBM * 128, xm, rows, K, we, wrow, s * kBK);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int pre = kt + kStages - 1;
      if (pre < KT) {
        unsigned char* st = smem + (pre % kStages) * kStageBytes;
        load_slice(st, st + kBM * 128, xm, rows, K, we, wrow, pre * kBK);
      }
      cp_async_commit();
      const unsigned char* a = smem + (kt % kStages) * kStageBytes;
      const unsigned char* b = a + kBM * 128;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(af[i], smem_addr(a + swz(r, kk * 2 + (lane >> 4))));
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // Two n8 blocks (bcol[2p], bcol[2p + 1]: 8 apart in both layouts).
          const int r = bcol[2 * p] + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(bf[p], smem_addr(b + swz(r, kk * 2 + ((lane >> 3) & 1))));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

    // Epilogue: thread (g, t) holds rows g and g + 8, columns 2t and 2t + 1
    // of each 16 × 8 block.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int r = wm * 32 + i * 16 + g + hrow * 8;
        if (r >= rows) continue;
        __nv_bfloat16* orow = out + (size_t)(m0 + r) * out_cols;
        if (GATED) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float g0 = acc[i][j][hrow * 2], g1 = acc[i][j][hrow * 2 + 1];
            const float u0 = acc[i][j + 2][hrow * 2], u1 = acc[i][j + 2][hrow * 2 + 1];
            const float v0 = g0 / (1.f + __expf(-g0)) * u0;
            const float v1 = g1 / (1.f + __expf(-g1)) * u1;
            *reinterpret_cast<uint32_t*>(orow + n0 + wn * 16 + j * 8 + 2 * t) = pack_bf16(v0, v1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(orow + n0 + bcol[j] + 2 * t) =
                pack_bf16(acc[i][j][hrow * 2], acc[i][j][hrow * 2 + 1]);
        }
      }
    }
    __syncthreads();                                  // the ring is refilled next tile
  }
}

template <bool GATED>
int launch(const void* x, const void* w, const int* off, void* out, int E, int K, int N,
           int out_cols, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (K % kBK || (GATED ? (N / 2) % (kBN / 2) || N % 2 : N % kBN) || E <= 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(GATED ? (N / 2) / (kBN / 2) : N / kBN, E);
  grouped_kernel<GATED><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), off,
      static_cast<__nv_bfloat16*>(out), K, N, out_cols);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clipcap

// x [M, D], w13 [E, 2F, D], off [E + 1] (device) → h [M, F].
extern "C" int clipcap_moe_gate_up(const void* x, const void* w13, const int* off, void* h,
                                   int E, int D, int F, cudaStream_t stream) {
  return clipcap::launch<true>(x, w13, off, h, E, D, 2 * F, F, stream);
}

// h [M, F], w2 [E, D, F], off [E + 1] (device) → y [M, D].
extern "C" int clipcap_moe_down(const void* h, const void* w2, const int* off, void* y, int E,
                                int F, int D, cudaStream_t stream) {
  return clipcap::launch<false>(h, w2, off, y, E, F, D, D, stream);
}
