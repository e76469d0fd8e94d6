// Patch embedding straight off uint8 images, on Hopper (sm_90a).
//
// Replaces the TPU kernel of clipcap_tpu/ops/patch_embed.py::patch_embed_fused
// (_patch_kernel): the ViT front end's im2col and patch product in one pass.
//
//   img  [B, H, W, 3] uint8, NHWC
//   w    [3P^2, D]    bf16, the folded patch weight in the shipping (c, ph, pw)
//                     row order (pixel normalisation and the /255 are in it)
//   bias [D]          bf16 or null
//   out  [B, (H/P)(W/P), D] bf16:
//     out[b, gy*gw+gx, d] = bf16( sum_{c,ph,pw} bf16(img[b, gy*P+ph, gx*P+pw, c])
//                                  * w[c*P*P + ph*P + pw, d]   (fp32 sum)
//                                + float(bias[d]) )
//
// What bounds it on the H100: at ViT-L/14 batch 256 the product is
// 2 * 65,536 * 588 * 1,024 = 78.9 GFLOP (0.080 ms at 989 TFLOP/s) against
// 174 MB of pixels, weight and output (0.052 ms at 3.35 TB/s), so the tensor
// cores bound it; at ViT-B/32 batch 512 the same holds (118 GFLOP, 0.120 ms).
// A plain implementation adds a bf16 copy of the pixels and a permuted
// copy of that before the product (both HBM round trips).
//
// Design: one block computes a 128-patch x 128-column output tile (two
// blocks per SM) with bf16 mma.sync (m16n8k16, fp32 accumulation;
// fragments by ldmatrix from shared memory; each of 8 warps a 32 x 64
// piece) over the 3P^2 depth in chunks, zero-padded past the depth, two
// chunks staged in shared memory.  The im2col is index arithmetic.  The
// block walks the depth in (ph, pw, c) order, so that one patch row ph of
// one patch is 3P contiguous bytes of the image; the weight rows are read
// in that order by index from the shipping (c, ph, pw) layout, so no
// permuted copy exists.  Both indices of every depth position
// (its byte offset in the patch, its weight row) are computed once per
// block into shared-memory tables, so the chunk loop does no division.
// Weight chunks go to shared memory by cp.async.  Pixels are widened
// exactly to bf16 (0..255 through float), never scaled; the epilogue adds
// the fp32 bias to the accumulators and rounds once.  Ragged M and D are
// masked (D must be a multiple of 8).  The pixel gather takes one of two
// paths, chosen per launch:
//
//  - 16-byte runs, when P % 16 == 0 (B/16, B/32) and the batch is 16-byte
//    aligned: a patch row of 3P bytes then starts 16-byte aligned (gx*3P,
//    the image row 3W and the image 3HW are multiples of 3P) and a run
//    never crosses a patch row.  Raw pixel runs and weight rows of chunk
//    i+1 go by cp.async into shared memory while the tensor cores work on
//    chunk i; each thread then widens the runs it copied itself into the
//    bf16 tile of chunk i+1, so one barrier per chunk suffices.  Chunks
//    are 64 deep (48 at B/32).
//  - single bytes otherwise: a patch row is 42 bytes at P = 14 and starts
//    at byte gx*42, so no load wider than a byte is aligned, and cp.async
//    cannot copy it.  The bytes of chunk i+1 go to registers while the
//    tensor cores work on chunk i (two buffers, one barrier per chunk); a
//    warp's 32 depth indices of one patch read one or two byte runs.
//    Chunks are 32 deep (19 at L/14).
//
// The pixel batch (38.5 MB at L/14 b256) stays in the 50 MB L2 across the
// column blocks, which run next to each other.  Not WMMA: its fragment
// loads compile to generic loads and movmatrix, not ldmatrix, and a WMMA
// form ran 1.5-2x slower on an H100 at chip_smoke.py's shapes.  TMA and
// wgmma are later work.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kBM = 128, kBN = 128;      // patches x columns per block
constexpr int kThreads = 256;             // 8 warps: 4 along M x 2 along N
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = 32, kWarpN = 64;   // one warp's piece
constexpr int kStages = 2;                // chunks staged in shared memory
constexpr int kLdB = kBN + 8;             // padding: ldmatrix rows fall in distinct banks
constexpr uint16_t kNoRow = 0xFFFF;       // a weight-row entry past the depth

// The geometry of one pixel path: kVec bytes per pixel load (1 or 16).
template <int kVec> struct Tile {
  static constexpr int BK = kVec == 16 ? 64 : 32;                // depth of a chunk
  static constexpr int LdA = BK + 8;
  static constexpr int PixLoads = kVec == 16 ? kBM * BK / 16 / kThreads  // 16-byte runs
                                             : kBM / kWarps;             // bytes
  static constexpr int WVecs = BK * kBN / 8 / kThreads;          // 16-byte weight pieces
  static constexpr size_t ABytes = sizeof(__nv_bfloat16) * 2 * kBM * LdA;
  static constexpr size_t BBytes = sizeof(__nv_bfloat16) * kStages * BK * kLdB;
  static constexpr size_t RawBytes = kVec == 16 ? kStages * kBM * BK : 0;
  // As[2][kBM][LdA], Bs[kStages][BK][kLdB], raw[kStages][kBM][BK] (16-byte
  // path), row_base[kBM], koff[kpad] (int), wrow[kpad] (uint16).
  static size_t smem_bytes(int K) {
    const int kpad = (K + BK - 1) / BK * BK;
    return ABytes + BBytes + RawBytes + sizeof(int) * (kBM + kpad) + sizeof(uint16_t) * kpad;
  }
};

// uint8 -> float, exact for 0..255: byte i of x under the exponent of 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) - 8388608.f;
}
// Bytes i and i+1 of x as bf16x2.  A float of 0..255 has at most 8
// significant bits, so its upper half is its exact bf16.
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t x, int i) {
  return __byte_perm(__float_as_uint(byte_to_float(x, i)),
                     __float_as_uint(byte_to_float(x, i + 1)), 0x7632u);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
patch_embed_kernel(const uint8_t* __restrict__ img, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   int M, int D, int H, int W, int P, int gw, int N) {
  using G = Tile<kVec>;
  constexpr int BK = G::BK, S = kStages, LdA = G::LdA;
  extern __shared__ __align__(128) unsigned char smem[];
  auto As = reinterpret_cast<__nv_bfloat16(*)[kBM][LdA]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BK][kLdB]>(smem + G::ABytes);
  auto raw = reinterpret_cast<uint8_t(*)[kBM][BK]>(smem + G::ABytes + G::BBytes);
  int* row_base = reinterpret_cast<int*>(smem + G::ABytes + G::BBytes + G::RawBytes);
  const int P3 = 3 * P, K = P3 * P, chunks = (K + BK - 1) / BK;
  int* koff = row_base + kBM;                                  // -1 past the depth
  uint16_t* wrow = reinterpret_cast<uint16_t*>(koff + chunks * BK);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;

  // Byte offset of each row's patch origin (pixel (gy*P, gx*P), channel 0);
  // -1 past the last patch.  The wrapper keeps the batch under 2^31 bytes.
  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    int base = -1;
    if (m < M) {
      const int b = m / N, n = m - b * N, gy = n / gw, gx = n - gy * gw;
      base = ((b * H + gy * P) * W + gx * P) * 3;
    }
    row_base[r] = base;
  }
  // Depth k in (ph, pw, c) order is byte ph*3W + (k - ph*3P) of the patch
  // and row c*P^2 + ph*P + pw of w.
  for (int k = tid; k < chunks * BK; k += kThreads) {
    const int ph = k / P3, rem = k - ph * P3, pw = rem / 3, c = rem - pw * 3;
    koff[k] = k < K ? ph * 3 * W + rem : -1;
    wrow[k] = k < K ? static_cast<uint16_t>(c * P * P + ph * P + pw) : kNoRow;
  }
  __syncthreads();

  // The weight rows of chunk c into stage c % S, by cp.async (the caller
  // commits): thread t takes 16 bytes of depth k0 + t / (kBN / 8).
  auto copy_weights = [&](int c) {
    const int st = c % S, k0 = c * BK;
#pragma unroll
    for (int v = 0; v < G::WVecs; ++v) {
      const int t = tid + v * kThreads, kk = t / (kBN / 8), col = (t % (kBN / 8)) * 8;
      const uint16_t r = wrow[k0 + kk];
      const bool ok = r != kNoRow && n0 + col < D;
      cp_async16(&Bs[st][kk][col], ok ? w + (size_t)r * D + n0 + col : w, ok);
    }
  };
  // One staged chunk through the tensor cores: per 16 of depth, the warp's
  // two 16-row A fragments (ldmatrix) against its eight 8-column B
  // fragments (ldmatrix.trans of the [k][n] tile), 16 mma.m16n8k16.
  // acc[i][j] holds rows wm*32 + i*16 + {g, g+8}, columns wn*64 + j*8 +
  // {2t, 2t+1} (g = lane / 4, t = lane % 4).
  float acc[2][8][4] = {};
  const int a_row = wm * kWarpM + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = wn * kWarpN + (lane >> 4) * 8;
  auto product = [&](int a, int b) {
    const unsigned a0 = smem_addr(&As[a][a_row][a_col]), b0 = smem_addr(&Bs[b][b_row][b_col]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(fa[i], a0 + 2 * (i * 16 * LdA + kk));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, b0 + 2 * (kk * kLdB + j * 16));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][2 * j + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  };

  if constexpr (kVec == 16) {
    // Thread t owns 16-byte runs t + i*kThreads of every chunk: run idx is
    // row idx / (BK/16), depth (idx % (BK/16)) * 16 of the chunk.
    auto issue = [&](int c) {              // always commits, so groups count chunks
      if (c < chunks) {
        const int st = c % S, k0 = c * BK;
#pragma unroll
        for (int i = 0; i < G::PixLoads; ++i) {
          const int idx = tid + i * kThreads, row = idx / (BK / 16), d = (idx % (BK / 16)) * 16;
          const int base = row_base[row], off = koff[k0 + d];
          const bool ok = base >= 0 && off >= 0;
          cp_async16(&raw[st][row][d], ok ? img + base + off : img, ok);
        }
        copy_weights(c);
      }
      cp_async_commit();
    };
    auto widen = [&](int c) {              // own runs of chunk c -> As[c & 1]
#pragma unroll
      for (int i = 0; i < G::PixLoads; ++i) {
        const int idx = tid + i * kThreads, row = idx / (BK / 16), d = (idx % (BK / 16)) * 16;
        const uint4 p = *reinterpret_cast<const uint4*>(&raw[c % S][row][d]);
        uint4* dst = reinterpret_cast<uint4*>(&As[c & 1][row][d]);
        dst[0] = make_uint4(bytes_to_bf16x2(p.x, 0), bytes_to_bf16x2(p.x, 2),
                            bytes_to_bf16x2(p.y, 0), bytes_to_bf16x2(p.y, 2));
        dst[1] = make_uint4(bytes_to_bf16x2(p.z, 0), bytes_to_bf16x2(p.z, 2),
                            bytes_to_bf16x2(p.w, 0), bytes_to_bf16x2(p.w, 2));
      }
    };
#pragma unroll
    for (int c = 0; c < S - 1; ++c) issue(c);
    cp_async_wait<S - 2>();                // chunk 0 has landed
    widen(0);
    __syncthreads();
    for (int ci = 0; ci < chunks; ++ci) {
      issue(ci + S - 1);                   // into the stage chunk ci - 1 left
      product(ci & 1, ci % S);
      cp_async_wait<S - 2>();              // chunk ci + 1 has landed
      if (ci + 1 < chunks) widen(ci + 1);  // As[(ci+1) & 1] was last read before the
      __syncthreads();                     // previous barrier
    }
  } else {
    // Byte path: depth k0 + lane of rows warp + kWarps*j, through registers.
    uint32_t pix[G::PixLoads];
    auto load = [&](int k0) {
      const int off = koff[k0 + lane];
#pragma unroll
      for (int j = 0; j < G::PixLoads; ++j) {
        const int base = row_base[warp + kWarps * j];
        pix[j] = base >= 0 && off >= 0 ? img[base + off] : 0u;
      }
    };
    auto store = [&](int a) {
#pragma unroll
      for (int j = 0; j < G::PixLoads; ++j)
        As[a][warp + kWarps * j][lane] =
            __ushort_as_bfloat16(__float_as_uint(byte_to_float(pix[j], 0)) >> 16);
    };
    load(0);
    copy_weights(0);
    cp_async_commit();
    store(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int ci = 0; ci < chunks; ++ci) {
      const int s = ci & 1;
      const bool more = ci + 1 < chunks;
      if (more) {                          // in flight during the product below
        load((ci + 1) * BK);
        copy_weights(ci + 1);
        cp_async_commit();
      }
      product(s, s);
      if (more) {
        store(s ^ 1);                      // buffer s ^ 1 was last read before the
        cp_async_wait<0>();                // previous barrier
      }
      __syncthreads();
    }
  }

  // Epilogue from the registers: add the fp32 bias, round once, write pairs.
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn * kWarpN + j * 8 + t2;
    if (n >= D) continue;                  // D is even: n + 1 < D too
    const float2 bv = bias != nullptr ? load2(bias + n) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * kWarpM + i * 16 + g + h * 8;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * D + n) = __floats2bfloat162_rn(
              acc[i][j][2 * h] + bv.x, acc[i][j][2 * h + 1] + bv.y);
      }
    }
  }
}

template <int kVec>
cudaError_t launch(const void* img, const void* w, const void* bias, void* out,
                   int B, int H, int W, int P, int D, cudaStream_t stream) {
  const int gw = W / P, N = (H / P) * gw, M = B * N;
  const dim3 grid((D + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535u || 3 * P * P >= kNoRow) return cudaErrorInvalidConfiguration;
  const size_t smem = Tile<kVec>::smem_bytes(3 * P * P);
  const cudaError_t set = cudaFuncSetAttribute(
      patch_embed_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;                          // a patch too large
  patch_embed_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, D, H, W, P, gw, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_patch_embed(const void* img, const void* w, const void* bias, void* out,
                                   int B, int H, int W, int P, int D, void* stream) {
  using namespace clipcap;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = P % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  return static_cast<int>(vec ? launch<16>(img, w, bias, out, B, H, W, P, D, s)
                              : launch<1>(img, w, bias, out, B, H, W, P, D, s));
}
