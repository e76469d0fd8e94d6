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
// (sample, head), with fp32 logits and softmax.
//
// What bounds it on the H100: at ViT-L/14 batch 256 (N = 257, D = 1024) the
// work is 4*B*N^2*D = 69 GFLOP (0.070 ms at 989 TFLOP/s bf16) against 539 MB
// of q/k/v read once and context written once (0.161 ms at 3.35 TB/s), so
// the bytes bound it; a plain implementation adds the [B, H, N, N] logits
// and weights to that traffic.  At head_dim 64 the card takes about as long
// for a score's exponential (16 a clock an SM) as for its 256 flops of
// products, so the softmax has to run beside the products, not after them.
//
// bf16: a persistent, warp-specialised wgmma kernel.  A block is three
// consumer warpgroups and a producer warp (one block an SM); it walks heads
// blockIdx.x, + gridDim.x, ...
//  - Loads: the producer's first thread issues TMA copies under mbarriers:
//    a 4-D tensor map (64, 3H head slots, N, B) over the packed rows, or a
//    3-D one (64, N, B * H) per head-major operand, encoded on the host per
//    call; 64-row boxes with the 128-byte swizzle, so a tile lands as a wgmma
//    operand.  Rows past N arrive as zeros: nothing outside the operands is
//    read.  Where a head's keys fit (N <= 704), its K and V tiles are
//    loaded once and stay for every query tile of the head, and as many
//    heads as fit are in flight (N = 257: two, so one head's loads run under
//    the other's work); a stage takes the next head's tile as soon as every
//    query tile has retired its products on it.  Longer rows stream K|V
//    through a ring of 4 stages to the first warpgroup alone.  Query tiles
//    come through a ring of 6.
//  - Work: the block's 64-row query tiles, in order over its heads, go to
//    the three warpgroups in turn; the N mod 64 tail rows are the last tile
//    of their head, in the block that holds its K and V.
//  - Products: S = q.k^T by wgmma m64nNk16 with both operands in shared
//    memory (K-major); P.V by wgmma m64n64k16 with P in registers (bf16,
//    rounded from the fp32 softmax) and V MN-major (the transpose-B
//    immediate).  A key tile's scores are issued before P.V of the tile
//    before it, which then runs under this tile's softmax: fp32, online, in
//    the accumulator registers, one FFMA and one ex2 a score.  Every
//    product retires in the loop body that issued it: with one in flight
//    across a branch, or two widths sharing accumulators, ptxas serialises
//    every wgmma (C7520, C7511).
//  - Tails: the last key tile narrows to the next multiple of 16 keys past
//    its end (its query tile's loop is a template on that width), so no
//    exponential is taken for 16-key blocks past N; hidden keys (past N,
//    or after the row under causal) are selected out of the row maximum and
//    weigh 0.  A causal query tile stops at its diagonal tile.
//  - Epilogue: one division by the row sums, a quad transpose, 16-byte
//    stores of the rows below N.
// -Xptxas -v (CUDA 12.8): 151 registers in both addressings, no spills,
// under the 152 that three warpgroups and the producer warp leave a thread.
//
// fp32: CUDA cores, picked by dtype.  fp32 carries the parity gates (fp32
// beam-5 tokens equal through kernels and twins, 1e-4 against the twin),
// which bf16 tensor-core products cannot meet.  Two threads own one query
// row (each holds half of q and of the accumulator; they combine dot
// products with one shuffle); keys stream through shared memory in tiles of
// 32, converted to fp32, with the same online softmax.  Its operands are a
// base pointer each plus sample, head and row strides (Operands below).
#include <algorithm>

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
// bf16: a warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                     // query rows of a consumer tile; keys of a K|V stage
constexpr int kTileBytes = kTile * kDh * 2;   // 8 KiB: 64 head rows of 128 bytes
constexpr int kStageBytes = 2 * kTileBytes;   // a K tile and its V tile
constexpr int kConsumers = 3;                 // consumer warpgroups a block
constexpr int kQStages = 2 * kConsumers;      // the q ring
constexpr int kWThreads = 128 * kConsumers + 32;   // and the producer warp
constexpr int kRing = 4;                      // K|V stages where a head's keys do not fit (2^k)
constexpr size_t kSmemMax = 232448;           // 227 KiB a block

struct Params {
  bf16* o;
  long long out_sample, out_head, out_row;
  int H, N, heads;     // heads: B * H, the units of the persistent grid
  int nq;              // 64-row query tiles of a head (as many key tiles)
  int stages;          // K|V stages in shared memory
  int resident;        // heads in flight when every key tile of a head has its own
                       // stage (loaded once a head); 0: the K|V ring
  int causal;
  float scale_log2;    // scale * log2(e): the softmax runs in exp2
};

// One 64-row box of operand `slot` (0 q, 1 k, 2 v) of head (b, h) at row
// `row`: the packed map is (64, 3H head slots, N, B), the head-major maps
// (64, N, B * H).  Rows past N arrive as zeros.
template <bool kPacked>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, int slot, const Params& p,
                                          int row, int b, int h, unsigned dst, unsigned bar) {
  if (kPacked)
    tma_load_4d(dst, map, bar, 0, slot * p.H + h, row, b);
  else
    tma_load_3d(dst, map, bar, 0, row, b * p.H + h);
}

// The key tiles of one query tile, as a consumer sees them: where tile j
// lives (resident: stage base + j of the head's loads, parity `par`; the
// ring: the (u + j)-th use, stage (u + j) % kRing), and what the softmax
// masks (keys at or past kend; under causal, keys after the row).
struct Tile {
  uint64_t qdesc;      // the q tile as the A operand
  unsigned kvst, kv_full, kv_empty;
  int resident, base, u;
  unsigned par;
  int nt, kend, causal, row, t, lane;   // row: this thread's first row (g of its warp's 16)
  float scale_log2, hide;

  __device__ __forceinline__ int stage(int j) const {
    return resident ? base + j : (u + j) & (kRing - 1);
  }
  __device__ __forceinline__ unsigned kv(int j) const { return kvst + stage(j) * kStageBytes; }
  __device__ __forceinline__ unsigned ready(int j) const {   // wait for tile j; its K tile
    mbar_wait(kv_full + 8 * stage(j), resident ? par : (u + j) / kRing & 1);
    return kv(j);
  }
  __device__ __forceinline__ void release(int j) const {    // its products retired
    if (lane == 0) mbar_arrive(kv_empty + 8 * stage(j));
  }
};

// The descriptor of a 64-row tile of 128-byte swizzled rows (8-row groups
// 1 KiB apart).  Its address field counts 16 bytes: a k16 step of a K-major
// operand (32 bytes on in the rows) adds 2, 16 rows of V (2 KiB) add 128.
__device__ __forceinline__ uint64_t tile_desc(unsigned addr) {
  return gmma_desc_sw128(addr, kTileBytes, 1024);
}

// s (its first W / 2 accumulators: keys 0..W-1 of the tile) = q . k^T:
// four k16 steps over head_dim.
template <int W>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t qdesc, unsigned ka) {
  const uint64_t kdesc = tile_desc(ka);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_m64k16_ss<W>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
  wgmma_commit();
}
// o += P . V over the tile's first W keys: a k16 step per 16 keys, P from
// registers, V MN-major (16 key rows are 2 KiB).
template <int W>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pf)[16], unsigned va) {
  const uint64_t vdesc = tile_desc(va);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_m64n64k16_rs(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                       vdesc + 128 * kk, 1);
  wgmma_commit();
}
template <int N, typename T> __device__ __forceinline__ void fence_all(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// The online softmax of the first W keys of a tile whose scores are in s:
// fold the tile's row maxima (log2 units) into m, leave
// exp2(s * scale - m) in s (one FFMA and one ex2 a score), and the factor
// the running output and sums take, alpha, in `alpha` (l is rescaled here).
// kMask (the tile that holds kend or the causal diagonal): hidden keys, by
// selects, take no part in the maximum and weigh 0.  Rows g and g + 8 of
// the warp: elements 4j + e are row g + 8 * (e / 2), key 8j + 2t + e % 2.
template <int W, bool kMask>
__device__ __forceinline__ void softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const Tile& c, int k0) {
  auto hidden = [&](int jb, int e) {
    const int key = k0 + 8 * jb + 2 * c.t + (e & 1), row = c.row + 8 * (e >> 1);
    return (key >= c.kend) | (c.causal & (key > row));
  };
  // The largest scaled score is the largest raw one times the scale (the
  // smallest, under a negative scale); c.hide is the identity of that.
  float mt[2] = {c.hide, c.hide};
  if (c.scale_log2 >= 0.f) {
    float mq[4] = {c.hide, c.hide, c.hide, c.hide};   // two chains a row
#pragma unroll
    for (int jb = 0; jb < W / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& q = mq[(e >> 1) * 2 + (jb & 1)];
        q = fmaxf(q, kMask && hidden(jb, e) ? c.hide : s[4 * jb + e]);
      }
    mt[0] = fmaxf(mq[0], mq[1]);
    mt[1] = fmaxf(mq[2], mq[3]);
  } else {
#pragma unroll
    for (int jb = 0; jb < W / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mt[e >> 1] = fminf(mt[e >> 1], kMask && hidden(jb, e) ? c.hide : s[4 * jb + e]);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] *= c.scale_log2;                        // NaN (ignored below) for 0 * inf
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row hidden so far
    alpha[r] = ex2_approx(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  float lq[4] = {0.f, 0.f, 0.f, 0.f};                 // two chains a row
#pragma unroll
  for (int jb = 0; jb < W / 8; ++jb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = ex2_approx(fmaf(s[4 * jb + e], c.scale_log2, -mu[e >> 1]));
      if (kMask) pe = hidden(jb, e) ? 0.f : pe;
      lq[(e >> 1) * 2 + (jb & 1)] += pe;
      s[4 * jb + e] = pe;
    }
  }
  l[0] += lq[0] + lq[1];
  l[1] += lq[2] + lq[3];
}
// P in bf16, the A fragments of P . V: k16 step kk takes keys 16kk..16kk+15.
template <int W>
__device__ __forceinline__ void to_bf16(uint32_t (&pf)[16], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[4 * kk + r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}
__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] *= alpha[e >> 1 & 1];
}

// One query tile against its key tiles: o (unnormalised) and this thread's
// part of the row sums l.  Tiles 0..nt-2 are whole and unmasked; the last
// one holds kend (or the causal diagonal), is masked and narrowed to its
// first W keys (W the next multiple of 16 past kend).  The scores of tile
// j are issued before P . V of tile j - 1, and the softmax of tile j runs
// while that product does.  Every product retires inside the body that
// issued it, so no product is in flight across a branch or a loop edge.
template <int W>
__device__ __forceinline__ void attend(const Tile& c, float (&o)[32], float (&l)[2]) {
  // The last tile's scores have registers of their own (st): sharing the
  // whole tiles' (s) at another width makes ptxas serialise the products
  // (C7511).
  float s[32], st[32], m[2] = {-INFINITY, -INFINITY}, alpha[2];
  uint32_t pf[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = s[e] = st[e] = 0.f;
  l[0] = l[1] = 0.f;
  if (c.nt == 1) {
    issue_qk<W>(st, c.qdesc, c.ready(0));
    wgmma_wait<0>();
    fence_all(st);
    softmax<W, true>(st, m, l, alpha, c, 0);
    to_bf16<W>(pf, st);
    issue_pv<W>(o, pf, c.kv(0) + kTileBytes);
    wgmma_wait<0>();
    fence_all(o);
    fence_all(pf);
    c.release(0);
    return;
  }
  issue_qk<kTile>(s, c.qdesc, c.ready(0));
  wgmma_wait<0>();
  fence_all(s);
  softmax<kTile, false>(s, m, l, alpha, c, 0);
  to_bf16<kTile>(pf, s);
  for (int j = 1; j < c.nt - 1; ++j) {
    const unsigned ka = c.ready(j), va = c.kv(j - 1) + kTileBytes;
    issue_qk<kTile>(s, c.qdesc, ka);
    rescale(o, alpha);
    issue_pv<kTile>(o, pf, va);
    wgmma_wait<1>();                               // the scores of tile j
    fence_all(s);
    softmax<kTile, false>(s, m, l, alpha, c, j * kTile);
    wgmma_wait<0>();                               // P . V of tile j - 1
    fence_all(o);
    fence_all(pf);
    c.release(j - 1);
    to_bf16<kTile>(pf, s);
  }
  const int j = c.nt - 1;
  const unsigned ka = c.ready(j), va = c.kv(j - 1) + kTileBytes, vl = c.kv(j) + kTileBytes;
  issue_qk<W>(st, c.qdesc, ka);
  rescale(o, alpha);
  issue_pv<kTile>(o, pf, va);
  wgmma_wait<1>();
  fence_all(st);
  softmax<W, true>(st, m, l, alpha, c, j * kTile);
  wgmma_wait<0>();
  fence_all(o);
  fence_all(pf);
  c.release(j - 1);
  to_bf16<W>(pf, st);
  rescale(o, alpha);
  issue_pv<W>(o, pf, vl);
  wgmma_wait<0>();
  fence_all(o);
  fence_all(pf);
  c.release(j);
}

template <bool kPacked>
__global__ void __launch_bounds__(kWThreads, 1)
sdpa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = smem_addr(smem_raw) + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const unsigned qst = base, kvst = base + kQStages * kTileBytes;   // the q ring, then K|V
  const unsigned q_full = kvst + p.stages * kStageBytes, q_empty = q_full + 8 * kQStages;
  const unsigned kv_full = q_empty + 8 * kQStages, kv_empty = kv_full + 8 * p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 4);              // one arrival a consumer warp
    }
    // A resident head's stage is free once each of its query tiles is done
    // with it (every one arrives on every stage: on those it reads as soon as
    // their last product retires, so the next head's loads start while this
    // head's last tiles run); a ring stage once its use is.
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, p.resident ? 4 * p.nq : 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The block's query tiles in order: tile i of its n-th head (head
  // blockIdx.x + n * gridDim.x) is z = n * nq + i; q stage z % kQStages.
  // Tile j of the n-th head's keys: resident heads take stages
  // (n % resident) * nq + j, loaded once a head; the ring's u-th tile use
  // takes stage u % stages.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * kConsumers) {
    // The producer: one thread keeps the q ring and the K|V stages full, over
    // the same sequence of heads and tiles as the consumers.
    if (lane != 0) return;
    int z = 0, u = 0, n = 0;
    for (int hd = blockIdx.x; hd < p.heads; hd += gridDim.x, ++n) {
      const int b = hd / p.H, h = hd - b * p.H;
      for (int i = 0; i < p.nq; ++i, ++z) {
        const int qs = z % kQStages;
        const unsigned qb = q_full + 8 * qs;
        mbar_wait(q_empty + 8 * qs, (z / kQStages & 1) ^ 1);
        mbar_arrive_expect_tx(qb, kTileBytes);
        load_tile<kPacked>(&qmap, 0, p, i * kTile, b, h, qst + qs * kTileBytes, qb);
        // K|V: every tile of a resident head with its first query tile; the
        // tiles each query tile reads through the ring otherwise.
        if (p.resident && i > 0) continue;
        const int kend = p.causal ? min(p.N, (i + 1) * kTile) : p.N;
        const int nt = p.resident ? p.nq : (kend + kTile - 1) / kTile;
        for (int j = 0; j < nt; ++j, ++u) {
          const int s = p.resident ? n % p.resident * p.nq + j : u & (kRing - 1);
          const unsigned par = (p.resident ? n / p.resident : u / kRing) & 1;
          const unsigned fb = kv_full + 8 * s, dst = kvst + s * kStageBytes;
          mbar_wait(kv_empty + 8 * s, par ^ 1);
          mbar_arrive_expect_tx(fb, kStageBytes);
          load_tile<kPacked>(&kmap, 1, p, j * kTile, b, h, dst, fb);
          load_tile<kPacked>(&vmap, 2, p, j * kTile, b, h, dst + kTileBytes, fb);
        }
      }
    }
    return;
  }

  // The consumer warpgroups: 64 query rows a tile, 16 a warp; this thread
  // holds rows g and g + 8 of its warp's.  Warpgroup w takes the block's
  // query tiles z = w, w + kConsumers, ... (the ring feeds warpgroup 0
  // alone, every tile).
  const int wg = warp / 4, g = lane >> 2;
  if (!p.resident && wg > 0) return;
  const int stride = p.resident ? kConsumers : 1;
  Tile c;
  c.kvst = kvst;
  c.kv_full = kv_full;
  c.kv_empty = kv_empty;
  c.resident = p.resident;
  c.causal = p.causal;
  c.t = lane & 3;
  c.lane = lane;
  c.scale_log2 = p.scale_log2;
  c.hide = p.scale_log2 >= 0.f ? -INFINITY : INFINITY;
  c.u = 0;
  for (int z = wg;; z += stride) {
    const int n = z / p.nq, i = z - n * p.nq, hd = blockIdx.x + n * gridDim.x;
    if (hd >= p.heads) break;
    const int b = hd / p.H, h = hd - b * p.H;
    bf16* const og = p.o + b * p.out_sample + h * p.out_head;
    c.base = p.resident ? n % p.resident * p.nq : 0;
    c.par = p.resident ? n / p.resident & 1 : 0;
    {
      const int rw = i * kTile + 16 * (warp % 4);   // the warp's first query row
      c.row = rw + g;
      c.kend = p.causal ? min(p.N, (i + 1) * kTile) : p.N;   // causal: to the diagonal
      c.nt = (c.kend + kTile - 1) / kTile;
      const int qs = z % kQStages;
      c.qdesc = tile_desc(qst + qs * kTileBytes);
      mbar_wait(q_full + 8 * qs, z / kQStages & 1);
      float o[32], l[2];
      switch ((c.kend - (c.nt - 1) * kTile + 15) / 16) {
        case 1: attend<16>(c, o, l); break;
        case 2: attend<32>(c, o, l); break;
        case 3: attend<48>(c, o, l); break;
        default: attend<64>(c, o, l); break;
      }
      if (lane == 0) {
        mbar_arrive(q_empty + 8 * qs);
        if (p.resident)                             // the stages a causal tile never read
          for (int j = c.nt; j < p.nq; ++j) mbar_arrive(kv_empty + 8 * (c.base + j));
      }
      if (!p.resident) c.u += c.nt;

      // Divide by the row sums once; 16-byte stores of 8 columns a thread.
      if (rw < p.N) {
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          inv[r] = 1.f / l[r];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = c.row + 8 * r;
#pragma unroll
          for (int cb = 0; cb < 2; ++cb) {
            uint32_t v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * cb + jj;
              v[jj] = pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
            }
            transpose_quad(v, c.t);
            if (row < p.N)
              *reinterpret_cast<uint4*>(og + row * p.out_row + 32 * cb + 8 * c.t) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    }
  }
}

// A map of 64-element (128-byte) head rows in boxes of 64 rows (and one of
// every other dimension), 128-byte swizzle: the tiles land as wgmma
// operands.  Rows past N read as zeros.
bool encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides) {
  const EncodeTiled encode = tensor_map_encoder();
  const cuuint32_t box4[4] = {kDh, 1, kTile, 1}, box3[3] = {kDh, kTile, 1}, unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
                rank == 4 ? box4 : box3, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 parameters of a call: resident K|V where a head's key tiles fit
// in shared memory beside the q ring (N <= 704), as many heads as fit (up
// to one a consumer warpgroup), else the ring.
Params bf16_params(void* out, long long out_sample, long long out_head, long long out_row, int B,
                   int H, int N, int causal, float scale) {
  Params p{static_cast<bf16*>(out), out_sample, out_head, out_row, H, N, B * H};
  p.nq = (N + kTile - 1) / kTile;
  p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  const size_t fixed = 1024 + kQStages * (kTileBytes + 16), head = p.nq * (kStageBytes + 16);
  p.resident = 0;
  while (p.resident < kConsumers && fixed + (p.resident + 1) * head <= kSmemMax) ++p.resident;
  // A warpgroup waits on a stage's load by its parity, so it must not skip
  // one of the heads that share the stage.  It skips heads only where a
  // head has fewer query tiles than there are warpgroups; with a stage set
  // a warpgroup (resident == kConsumers) each one then keeps to its own.
  if (p.nq < kConsumers && p.resident < kConsumers) p.resident = 0;
  p.stages = p.resident ? p.resident * p.nq : kRing;
  return p;
}

// A persistent grid: as many blocks as fit on the card at once, each
// walking heads blockIdx.x, + gridDim.x, ...
template <bool kPacked>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                 const Params& p, cudaStream_t stream) {
  const auto kernel = sdpa_wgmma_kernel<kPacked>;
  const size_t smem =
      1024 + kQStages * (kTileBytes + 16) + static_cast<size_t>(p.stages) * (kStageBytes + 16);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::min(p.heads, std::max(per_sm, 1) * sms);
  kernel<<<grid, kWThreads, smem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; }

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

int launch_fp32(const Operands& op, int B, int N, int H, int causal, float scale, void* stream) {
  const dim3 grid((N + kQTile - 1) / kQTile, H, B);
  sdpa_fp32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(op, N, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clipcap

// qkv [B, N, 3D] packed (q | k | v, head-major within each), out [B, N, D].
// bf16 refuses (cudaErrorInvalidValue) a base the copy engine cannot
// address: qkv or out off 16 bytes (the strides, 6D and 6DN bytes, are
// multiples of 16).
extern "C" int clipcap_sdpa_packed(const void* qkv, void* out, int B, int N, int H,
                                   int causal, int dtype, float scale, void* stream) {
  using namespace clipcap;
  const long long D = (long long)H * kDh;
  if (dtype == kBFloat16) {
    if (misaligned(qkv) || misaligned(out)) return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t row = 6 * static_cast<cuuint64_t>(D);           // bytes
    const cuuint64_t dims[4] = {kDh, 3 * static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {kDh * 2, row, row * N};
    CUtensorMap map;
    if (!encode_map(&map, qkv, 4, dims, strides)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<true>(map, map, map, bf16_params(out, N * D, kDh, D, B, H, N, causal, scale),
                              static_cast<cudaStream_t>(stream));
  }
  const char* base = static_cast<const char*>(qkv);
  const size_t bytes = D * sizeof(float);
  const Operands op{base, base + bytes, base + 2 * bytes, out,
                    N * 3 * D, kDh, 3 * D, N * D, kDh, D};
  return launch_fp32(op, B, N, H, causal, scale, stream);
}

// q, k, v, out: contiguous head-major [B, H, N, 64]; bf16 refuses a base
// off 16 bytes, as above.
extern "C" int clipcap_fused_sdpa(const void* q, const void* k, const void* v, void* out, int B,
                                  int H, int N, int causal, int dtype, float scale,
                                  void* stream) {
  using namespace clipcap;
  const long long head = (long long)N * kDh;
  if (dtype == kBFloat16) {
    if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[3] = {kDh, static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(B) * static_cast<cuuint64_t>(H)};
    const cuuint64_t strides[2] = {kDh * 2, kDh * 2 * static_cast<cuuint64_t>(N)};
    CUtensorMap maps[3];
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i)
      if (!encode_map(&maps[i], bases[i], 3, dims, strides))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<false>(maps[0], maps[1], maps[2],
                               bf16_params(out, H * head, head, kDh, B, H, N, causal, scale),
                               static_cast<cudaStream_t>(stream));
  }
  const Operands op{q, k, v, out, H * head, head, kDh, H * head, head, kDh};
  return launch_fp32(op, B, N, H, causal, scale, stream);
}
