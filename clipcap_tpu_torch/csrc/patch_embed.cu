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
// Design: a persistent grid (one block an SM) walks 128-patch x 256-column
// output tiles, the column tiles of one row tile next to each other, so
// neighbouring blocks read the same pixels from L2.  A block is three
// warpgroups: two consumers (64 patches each) and a producer, which gives
// its registers to the consumers (setmaxnreg 40 / 232).
//
//  - Depth order: the product walks the depth in stages of 32 rows, one
//    row block j (pixels 32j.. of the patch's (ph, pw) grid) of one channel
//    c, the three channels of a block in turn.  Pixels r, r + 1 of a block
//    are then one 6-byte run of the image (P even), which each consumer
//    thread reads once a block and widens three times, one channel a stage.
//  - Weight: the producer's first thread keeps a ring of 4 stages full by
//    TMA, under mbarriers: a 3-D tensor map views the shipping [3P^2, D]
//    weight as (n, ph * P + pw, c), so stage (j, c) is four 64-column boxes
//    of 32 rows (128-byte swizzle, 16 KiB) with no permuted copy; rows past
//    P^2 and columns past D arrive as zeros.
//  - Pixels: staged raw in shared memory, each patch row's bytes of a stage
//    one contiguous segment of the batch, copied whole.  "span" (any P):
//    a stage is the tile's whole patch rows (75,264 bytes at L/14),
//    double-buffered.  "runs" (P = 16, 32): a stage is one row block's
//    32 / P image rows of the tile's patch rows; a ring of 4.  A stage is
//    filled by the copy engine (1-D bulk copies, one a patch row; the batch
//    16-byte aligned and, for span, each patch row, for runs, each image
//    row a multiple of 16 bytes) or, where it cannot address the batch, by
//    three producer warps' 16-byte loads (byte loads in a block the batch's
//    ends cut, so nothing outside the batch is read): the "bytes" path,
//    which feeds the same core.  ops/patch_embed.py picks the path and
//    passes it in; the entry refuses a copy-engine path for a batch the
//    copy engine cannot address.
//  - Product: each consumer builds its A fragments of a stage from the runs
//    it holds (a byte permute picks channel c; exact uint8 -> bf16 by byte
//    permutes) straight into registers and issues two wgmma.m64n256k16 a
//    stage (A in registers, B MN-major from the stage, fp32 accumulators:
//    128 registers a thread), one stage ahead: the fragments of stage i are
//    built while stage i - 1's product runs.  The stage count is made even
//    (the extra stage's weights are TMA zeros), so one loop body names both
//    fragment buffers: with an odd tail ptxas serialises every wgmma
//    (C7513).  The epilogue adds the fp32 bias (staged in shared memory),
//    rounds once, swaps values within each quad of lanes and writes 16-byte
//    stores; ragged M and D are masked (D a multiple of 8).
//
// Budget: the span layout at L/14 takes 4 x 16 KiB of weight stages, 2 x
// 75,264 bytes of pixels, the 7-block offset table, the bias, the barriers
// and 1 KiB of alignment: 220,160 bytes of the 232,448 a block may use;
// runs at B/32 takes 122,112.  A geometry whose pixel stages do not fit
// twice runs with one: ViT-L/14@336px (6 patch rows of 84,672 bytes a
// tile; 154,304 bytes), where the next tile's copy waits for the last
// row block's reads.  At b256 that shape takes 2.15 times L/14 b256's time
// for 2.25 times its patches; a 3-stage weight ring that made room for two
// pixel stages ran 11% slower.  One that does not fit once is refused
// (cudaErrorInvalidConfiguration).  -Xptxas -v (CUDA 12.8): 168 registers
// at launch in each of the four instantiations (setmaxnreg then moves
// them), no spills on the bytes paths, 4 bytes on the copy-engine paths.
#include <algorithm>

#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kBM = 128, kBN = 256, kBK = 32;    // patches x columns per tile; depth per stage
constexpr int kConsumers = 2;                     // warpgroups of 64 patches
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kWStages = 4;                       // weight ring
constexpr int kSlab = kBK * 128;                  // one 64-column box: 32 rows x 128 bytes
constexpr int kWStageBytes = 4 * kSlab;           // 16 KiB
constexpr int kPStages = 4;                       // pixel ring of the runs layout
constexpr int kByteFillers = 96;                  // producer threads of the bytes path
constexpr size_t kSmemMax = 232448;               // 227 KiB a block
// The pixel path (ops/patch_embed.py ``pixel_path``): bit flags.
constexpr int kPathBytes = 1, kPathRuns = 2;

struct Params {
  const uint8_t* img;
  size_t bytes;      // the batch's bytes: the bytes path reads none outside them
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int M, D, W, P, gw;
  int n_tiles;       // column tiles
  int units;         // row tiles x column tiles
  int blocks;        // 32-row blocks of the (ph, pw) grid: ceil(P^2 / 32)
  int chunks;        // weight stages per tile: 3 blocks (one a channel), made even
  int nph;           // image rows of every patch a pixel stage holds
  int groups;        // pixel stages per tile: P / nph
  int pstages;       // pixel stages in the ring
  int pstage_bytes;  // bytes of one (a multiple of 16)
};

// Bytes 0 and 1 of x (0..255) as bf16x2, byte 0 in the low half: exact
// through the float 2^23 + b, whose upper half is the bf16 of b.
__device__ __forceinline__ uint32_t bf16x2_of_bytes(uint32_t x) {
  const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u)) - 8388608.f;
  const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441u)) - 8388608.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

template <bool kRuns, bool kBytes>
__global__ void __launch_bounds__(kThreads, 1)
patch_embed_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const wst = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  unsigned char* const pst = wst + kWStages * kWStageBytes;
  // Byte offsets in a pixel stage (channel 0) of the pixels r, r + 1, r + 8,
  // r + 9 of the (ph, pw) grid that lane t of a quad reads in k16 step s of
  // row block j, r = 32j + 16s + 2t: tab[(4j + t) * 2 + s] (runs: of the
  // stage's own rows, the same for every block).
  int4* const tab = reinterpret_cast<int4*>(pst + p.pstages * p.pstage_bytes);
  const int tab_blocks = kRuns ? 1 : p.blocks;
  // The bias, zero past D and without one, for every column tile.
  __nv_bfloat162* const bias2 = reinterpret_cast<__nv_bfloat162*>(tab + 8 * tab_blocks);
  const unsigned w_full = smem_addr(bias2 + p.n_tiles * kBN / 2), w_empty = w_full + 8 * kWStages;
  const unsigned p_full = w_empty + 8 * kWStages, p_empty = p_full + 8 * p.pstages;
  const int P = p.P, P3 = 3 * P, PP = P * P, row3 = 3 * p.W, seg = p.nph * row3;

  for (int e = threadIdx.x; e < 8 * tab_blocks; e += kThreads) {
    const int j = e >> 3, t = e >> 1 & 3, s = e & 1;
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 32 * j + 16 * s + 2 * t + (i & 1) + 8 * (i >> 1);
      v[i] = r < PP ? r / P * row3 + r % P * 3 : 0;      // past P^2: a TMA zero weight
    }
    tab[e] = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int e = threadIdx.x; e < p.n_tiles * kBN / 2; e += kThreads)
    bias2[e] = p.bias != nullptr && 2 * e < p.D
                   ? reinterpret_cast<const __nv_bfloat162*>(p.bias)[e]
                   : __floats2bfloat162_rn(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kConsumers);            // one arrival a consumer warpgroup
    }
    for (int s = 0; s < p.pstages; ++s) {
      mbar_init(p_full + 8 * s, kBytes ? kByteFillers : 1);
      mbar_init(p_empty + 8 * s, 4 * kConsumers);        // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // The producer warpgroup: warp 0 feeds the weight ring, warp 1 (the
    // bytes path: warps 1-3) the pixel ring, each as far ahead as its ring
    // allows, over the same sequence of tiles as the consumers.
    setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        int n = 0;
        for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
          const int n0 = u % p.n_tiles * kBN;
          for (int i = 0; i < p.chunks; ++i, ++n) {
            const int s = n % kWStages;
            mbar_wait(w_empty + 8 * s, (n / kWStages & 1) ^ 1);
            // Stage i: channel i % 3 of row block i / 3 (past P^2: zeros).
            const int j = i / 3, c = i - 3 * j;
            const unsigned dst = smem_addr(wst + s * kWStageBytes), bar = w_full + 8 * s;
            mbar_arrive_expect_tx(bar, kWStageBytes);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tma_load_3d(dst + q * kSlab, &wmap, bar, n0 + 64 * q, kBK * j, c);
          }
        }
      }
    } else if (kBytes || warp == 1) {
      // Pixel stage j of a tile: image rows j * nph.. (nph of them) of its
      // patch rows R0..R1, each patch row's seg bytes contiguous in the
      // batch and in the stage.
      const int filler = threadIdx.x % 128 - 32;         // bytes path: 0..95
      int n = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int m0 = u / p.n_tiles * kBM, R0 = m0 / p.gw;
        const int rows = (min(m0 + kBM, p.M) - 1) / p.gw - R0 + 1;
        for (int j = 0; j < p.groups; ++j, ++n) {
          const int s = n % p.pstages;
          const unsigned bar = p_full + 8 * s;
          unsigned char* const dst = pst + s * p.pstage_bytes;
          const uint8_t* const src = p.img + ((size_t)R0 * P + j * p.nph) * row3;
          mbar_wait(p_empty + 8 * s, (n / p.pstages & 1) ^ 1);
          if (kBytes) {
            // The aligned 16-byte blocks that cover each segment: one load
            // a block inside the batch, byte loads of the segment's bytes
            // in a block that the batch's first or last byte cuts; stored
            // byte by byte.
            const int vecs = (seg + 30) / 16;                    // a segment's blocks, at most
#pragma unroll 4
            for (int e = filler; e < rows * vecs; e += kByteFillers) {
              const int r = e / vecs, v = e - r * vecs;
              const uint8_t* const from = src + (size_t)r * P * row3;
              const int x0 = 16 * v - static_cast<int>(reinterpret_cast<uintptr_t>(from) % 16);
              if (x0 >= seg) continue;
              const uint8_t* const at = from + x0;
              if (at >= p.img && at + 16 <= p.img + p.bytes) {
                const uint4 q = *reinterpret_cast<const uint4*>(at);
                const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
                for (int b = 0; b < 16; ++b)
                  if (x0 + b >= 0 && x0 + b < seg) dst[r * seg + x0 + b] = w4[b / 4] >> 8 * (b % 4);
              } else {
                for (int b = max(0, -x0); b < 16 && x0 + b < seg; ++b) dst[r * seg + x0 + b] = at[b];
              }
            }
            mbar_arrive(bar);
          } else {
            fence_proxy_async();                         // the consumers read it last
            if (lane == 0) mbar_arrive_expect_tx(bar, rows * seg);
            __syncwarp();
            for (int r = lane; r < rows; r += 32)
              bulk_copy_g2s(smem_addr(dst + r * seg), src + (size_t)r * P * row3, seg, bar);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;              // this thread's tile rows r0, r0 + 8
    const bool signal = threadIdx.x % 128 == 0;          // the warpgroup's w_empty arrival
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t fa[8], fb[8];                               // A fragments of two stages in flight
    int wn = 0, pn = 0;                                  // weight / pixel stages consumed
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int mt = u / p.n_tiles, m0 = mt * kBM, n0 = (u - mt * p.n_tiles) * kBN;
      int off[2];                                        // rows' patch origins in a stage
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        if (m < p.M) {
          const int R = m / p.gw;
          off[h] = (R - m0 / p.gw) * seg + (m - R * p.gw) * P3;
        } else {
          off[h] = 0;                                    // past M: read, never stored
        }
      }
      const unsigned char* px = pst;
      // The 6 bytes (2 pixels x 3 channels) of each pixel pair this thread
      // reads in a row block, [row h][k16 step s][pair]: lo bytes 0-3, hi 4-5.
      uint32_t raw[2][2][2][2];
      // Stage i = 3j + c: at c = 0 wait for block j's pixels (first of a
      // pixel stage), read its pixel pairs into raw and release the pixel
      // stage after its last block; build the A fragments of channel c in
      // `a`; wait for the weights, issue the two k16 products and retire
      // stage i - 1 (its fragments `prev`, its weight stage).
      auto step = [&](int i, uint32_t (&a)[8], uint32_t (&prev)[8]) {
        const int j = i / 3, c = i - 3 * j;
        if (c == 0 && j < p.blocks) {
          if (kRuns || j == 0) {
            mbar_wait(p_full + 8 * (pn % p.pstages), pn / p.pstages & 1);
            px = pst + pn % p.pstages * p.pstage_bytes;
          }
          const int4* kj = tab + (4 * (kRuns ? 0 : j) + t) * 2;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int4 k = kj[s];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned char* x = px + off[h];
              if (P % 2 == 0) {                          // pixels r, r + 1: one 6-byte run
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const uint16_t* y = reinterpret_cast<const uint16_t*>(x + (q ? k.z : k.x));
                  raw[h][s][q][0] = y[0] | static_cast<uint32_t>(y[1]) << 16;
                  raw[h][s][q][1] = y[2];
                }
              } else {                                   // a pair may end a patch row
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const unsigned char* y0 = x + (q ? k.z : k.x);
                  const unsigned char* y1 = x + (q ? k.w : k.y);
                  raw[h][s][q][0] = y0[0] | y0[1] << 8 | y0[2] << 16 | uint32_t{y1[0]} << 24;
                  raw[h][s][q][1] = y1[1] | y1[2] << 8;
                }
              }
            }
          }
          if (kRuns || j == p.blocks - 1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(p_empty + 8 * (pn % p.pstages));
            ++pn;
          }
        }
        // Channel c of the pixels r, r + 1: bytes c and c + 3 of a run.
        const uint32_t sel = c | (c + 3) << 4;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              a[4 * s + 2 * q + h] = bf16x2_of_bytes(
                  __byte_perm(raw[h][s][q][0], raw[h][s][q][1], sel));
        const int s = wn % kWStages;
        mbar_wait(w_full + 8 * s, wn / kWStages & 1);
        // B: four 64-column boxes 4 KiB apart (leading byte offset), 8-row
        // groups 1 KiB apart (stride byte offset); k16 step 1 starts 16 rows on.
        uint64_t d0 = gmma_desc_sw128(smem_addr(wst + s * kWStageBytes), kSlab, 1024);
        uint64_t d1 = d0 + (16 * 128 >> 4);
        // Every operand ready before the products start.
#pragma unroll
        for (int r = 0; r < 8; ++r) reg_fence(a[r]);
        reg_fence(d0);
        reg_fence(d1);
        wgmma_fence();
        wgmma_m64n256k16_rs(acc, a[0], a[1], a[2], a[3], d0, i > 0);
        wgmma_m64n256k16_rs(acc, a[4], a[5], a[6], a[7], d1, 1);
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < 8; ++r) reg_fence(prev[r]);
        if (i > 0 && signal) mbar_arrive(w_empty + 8 * ((wn - 1) % kWStages));
        ++wn;
      };
      // Both fragment buffers named in one body: with an odd tail ptxas
      // serialises every wgmma (C7513).  Stages past the depth are zeros.
      for (int i = 0; i < p.chunks; i += 2) {
        step(i, fa, fb);
        step(i + 1, fb, fa);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        reg_fence(fa[r]);
        reg_fence(fb[r]);
      }
      if (signal) mbar_arrive(w_empty + 8 * ((wn - 1) % kWStages));

      // Epilogue: fp32 bias, one rounding, 16-byte stores of 8 columns.
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t v[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          const float2 b = __bfloat1622float2(bias2[(n0 + 8 * j + 2 * t) / 2]);
          v[0][jj] = pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
          v[1][jj] = pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        }
        const int n = n0 + 32 * q + 8 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          transpose_quad(v[h], t);
          const int m = m0 + r0 + 8 * h;
          if (m < p.M && n < p.D)
            *reinterpret_cast<uint4*>(p.out + (size_t)m * p.D + n) =
                make_uint4(v[h][0], v[h][1], v[h][2], v[h][3]);
        }
      }
    }
  }
}

template <bool kRuns, bool kBytes>
cudaError_t launch(const CUtensorMap& map, const Params& p, size_t smem, cudaStream_t stream) {
  const auto kernel = patch_embed_wgmma_kernel<kRuns, kBytes>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  kernel<<<std::min(p.units, sms), kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_patch_embed(const void* img, const void* w, const void* bias, void* out,
                                   int B, int H, int W, int P, int D, int path, void* stream) {
  using namespace clipcap;
  const bool runs = path & kPathRuns, bytes = path & kPathBytes;
  const int gw = W / P, M = B * (H / P) * gw;
  if (runs && P != 16 && P != 32) return static_cast<int>(cudaErrorInvalidValue);
  // The copy engine's starts and lengths are 16-byte aligned: the batch, and
  // an image row (runs) or a patch row (span).  Anything else is the bytes
  // path's, and a copy-engine path given it is refused.
  if (!bytes && (reinterpret_cast<uintptr_t>(img) % 16 || 3 * W * (runs ? 1 : P) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint8_t*>(img), static_cast<size_t>(B) * H * W * 3,
           static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
           M, D, W, P, gw};
  p.n_tiles = (D + kBN - 1) / kBN;
  p.units = (M + kBM - 1) / kBM * p.n_tiles;
  p.blocks = (P * P + kBK - 1) / kBK;
  p.chunks = (3 * p.blocks + 1) / 2 * 2;                // even: see the product loop
  p.nph = runs ? kBK / P : P;
  p.groups = P / p.nph;
  int rows = 0;                                        // the widest tile's patch rows
  for (int m0 = 0; m0 < M; m0 += kBM)
    rows = std::max(rows, (std::min(m0 + kBM, M) - 1) / gw - m0 / gw + 1);
  p.pstage_bytes = (rows * p.nph * 3 * W + 15) / 16 * 16;
  const size_t fixed = 1024 + kWStages * kWStageBytes +
                       128 * (runs ? 1 : p.blocks) + 2 * p.n_tiles * kBN +
                       8 * 2 * (kWStages + kPStages);
  p.pstages = runs ? kPStages : 2;                     // as many as fit, at least one
  while (p.pstages > 1 && fixed + p.pstages * (size_t)p.pstage_bytes > kSmemMax) --p.pstages;
  const size_t smem = fixed + p.pstages * (size_t)p.pstage_bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidConfiguration);

  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  // The weight as (n, ph * P + pw, c): 2-byte, 2D-byte and 2DP^2-byte strides.
  const cuuint64_t d = static_cast<cuuint64_t>(D), pp = static_cast<cuuint64_t>(P) * P;
  const cuuint64_t dims[3] = {d, pp, 3}, strides[2] = {2 * d, 2 * d * pp};
  const cuuint32_t box[3] = {64, kBK, 1}, unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(runs ? (bytes ? launch<true, true>(map, p, smem, s)
                                        : launch<true, false>(map, p, smem, s))
                               : (bytes ? launch<false, true>(map, p, smem, s)
                                        : launch<false, false>(map, p, smem, s)));
}
