// Flash-decode attention: one KV-cached decode step over the interleaved
// K|V cache, on Hopper (sm_90a).
//
// Replaces the TPU kernels of clipcap_tpu/ops/flash_decode.py:
//   * flash_decode (_flash_call -> _kernel, online-softmax core
//     _flash_update): bf16/fp32 or int8 cache with per-slot scales,
//     per-row slot bounds [lo, hi), optional online-softmax carry in/out;
//     the bf16/fp32 cache strided or tile-major;
//   * flash_decode(manual=True) (_manual_call -> _manual_kernel): the same
//     function over a bf16/fp32 cache, strided or tile-major, with the walk
//     over the slots inside the kernel and S copies in flight ahead of it
//     (the TPU kernel's make_async_copy ring under DMA semaphores);
//   * flash_decode_two_phase (_fused_call -> _fused_kernel): one softmax
//     over a consolidated shared-prefix cache, then the live beam cache,
//     each region bf16/fp32 or int8.
//
//   q    [R, H, K, 64]   this step's queries (K beams, or K = 1)
//   kv   [R, H, U, 128]  cache; slot u holds K in [0, 64), V in [64, 128);
//                        int8 rows with sk, sv [R, H, U] fp32 scales
//        [R, T, H, ut, 128]  the tile-major form (bf16/fp32): logical slot
//                        u of (r, h) at [r, u / ut, h, u % ut]; the strided
//                        form is the tile-major one with T = 1, ut = U
//   mask [Rm, K, U]      fp32 additive (beam ancestry or causal), Rm in {1, R}
//   out  [R, H, K, 64] = softmax(q.k^T / 8 [* sk] + mask) . ([sv *] v)
//                        over the slots [lo[r], hi[r]) of each row r
//   carry (m, l [R, H, K], acc [R, H, K, 64] fp32): the running max, sum
//                        and unnormalised V accumulator of the softmax
//
// What bounds it on the H100: bytes.  A decode step reads each written
// cache slot once (256 bytes per slot and head in bf16, 128 + 8 in int8)
// to do 4*K flops per byte, far under the card's ~295 flops/byte ridge.
// Every kernel reads each valid slot exactly once, with 16-byte coalesced
// copies into shared memory, and never touches a slot outside its row's
// [lo, hi): the bounds are exact per row, where the TPU kernel rounds them
// out to whole tiles per row block and masks the slack (a masked slot
// weighs exp(-1e9 - m) = 0 in fp32, so the two agree).  One thread block
// per (row, head) keeps the fp32 online-softmax state (running max, sum,
// accumulator) on chip; the two-phase kernel walks two segments under one
// launch, so its partials never leave the chip.  The k-scale of an int8
// slot multiplies its logit after the dot, the v-scale its weight before
// the value product, as the TPU kernel folds them.
//
// bf16 q (flash_decode_mma_kernel: the auto kernel over a bf16 or int8
// cache, strided or tile-major, host or per-row bounds, carry in and out;
// and the two-phase kernel, each region bf16 or int8): tensor cores and a
// walk without block-wide barriers.  The block's 4 warps split the slots
// into chunks of 32, warp w taking chunks w, w + 4, ...; each warp feeds
// its chunks through its own ring of 2 cp.async stages (the slots, the
// chunk's mask rows and int8 scales; zero-filled past the row's bound) and
// keeps its own online softmax in registers, synchronising with __syncwarp
// only.  Both products are mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// q.k^T takes the K <= 8 queries as the A operand, padded to 16 rows with
// zeros that never enter the softmax; slots past the bound get a -inf
// logit and weigh exactly 0.  P.V runs transposed, O^T = V^T . P^T: the S
// accumulators are P^T's B fragment as they stand, and the queries fill
// the 8 columns of the accumulator, so none of it is padding.  The
// weights are rounded to bf16 for P.V, as in the twin and the TPU kernel.
// Fragments are read straight from shared memory (LDS.128 / LDS.64; no
// ldmatrix: it moves 16-bit elements and int8 rows need widening) under
// one permutation of the contraction and output indices that both cache
// types share (see Frag), so the two-phase kernel folds bf16 and int8
// regions into one accumulator.  int8 values widen to bf16 exactly in
// registers with byte permutes and one fp32 add each (no conversion
// instruction).  Each slot's 16-byte pieces are XOR-swizzled so that every
// fragment read is free of bank conflicts.  The warps' states and the
// carry in merge once, at the end, through shared memory.  At GPT-2 XL
// b96 the int8 form holds 5 blocks an SM (45 KB of ring, <= 96 registers),
// the bf16 form 3 (75 KB).
//
// bf16 q, manual form (flash_decode_manual_mma_kernel): Hopper's form of
// the TPU kernel's copy ring, with the auto kernel's fold.  Bytes bound it
// too, but at these shapes each (row, head) reads only ~55 KB, so what a
// block per item pays besides the bytes (bounds, q, the first copy's round
// trip, the merge) costs as much as the copies.  So: (1) the copy engine
// moves the slots, not the threads: a warp asks for a 32-slot chunk with
// one 256-byte bulk copy a lane (cp.async.bulk into a row padded to 272
// bytes, so that the fragment reads stay free of bank conflicts), counted
// on the stage's mbarrier, and cp.asyncs the chunk's mask values (4 bytes
// each: a mask row starts at any slot).  Each warp is its own producer,
// with a ring of S stages (S = 2 to 4) and S - 1 chunks in flight while it
// folds one: a producer warp that served the block's warps in turn made
// the ring wait on it (PERF.md §6).  (2) The fold is the auto kernel's
// (fold_chunk: mma.sync, the weights rounded to bf16 for P.V, one online
// softmax per warp, no block-wide barrier in the walk), reading the padded
// rows through a template of the read position.  (3) The grid is
// persistent: as many two-warp blocks as the card holds at once walk the
// (row, head) items in a fixed stride, and each warp's copies run on into
// the next item while the block merges and writes the current one.
// (4) Bounds stay exact: lanes past a row's bound copy nothing, and their
// stale rows weigh 0 and are left out of the value product; a warp fences
// its reads of a stage from the copy engine's next writes to it.
//
// fp32 q keeps the CUDA-core kernels (the fp32 parity gates rest on them):
// the auto kernel stages a tile of 64 slots with loads through registers
// and computes on it thread-per-slot before it asks for the next.  The
// fp32 manual kernel keeps S - 1 tiles of 16-byte cp.async copies in
// flight while it computes (tile t + S - 1 is started before tile t is
// computed), in a ring of S shared-memory stages, each slot's 16-byte
// chunks XOR-swizzled so that both compute phases read them without bank
// conflicts.  A kernel tile or chunk may straddle two layout tiles of the
// tile-major cache: every copy computes its slot's own address.  wgmma and
// a split over the slot axis are later work.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kDh = 64;              // head_dim of every GPT-2 preset
constexpr int kRow = 2 * kDh;        // one interleaved K|V slot
constexpr int kTile = 64;            // cache slots per shared-memory tile
constexpr int kThreads = 128;
constexpr int kMaxK = 8;             // queries per (row, head)

// Bytes of one staged slot: an odd number of 32-bit words per slot keeps
// the thread-per-slot reads of the logits phase free of bank conflicts.
template <typename T> struct Staged;
template <> struct Staged<float> { static constexpr int bytes = 129 * 4; };
template <> struct Staged<int8_t> { static constexpr int bytes = 33 * 4; };

template <typename A, typename B> struct StagedMax {
  static constexpr int bytes = Staged<A>::bytes > Staged<B>::bytes ? Staged<A>::bytes
                                                                   : Staged<B>::bytes;
};

// q . k over the 64 K-values of one staged slot.
__device__ __forceinline__ float dot64(const float* q, const float* k) {
  float dot = 0.f;
#pragma unroll 8
  for (int j = 0; j < kDh; j += 2) {
    const float2 kk = load2(k + j);
    dot += q[j] * kk.x + q[j + 1] * kk.y;
  }
  return dot;
}
__device__ __forceinline__ float dot64(const float* q, const int8_t* k) {
  float dot = 0.f;
#pragma unroll 4
  for (int j = 0; j < kDh; j += 4) {
    const char4 c = *reinterpret_cast<const char4*>(k + j);
    dot += q[j] * c.x + q[j + 1] * c.y + q[j + 2] * c.z + q[j + 3] * c.w;
  }
  return dot;
}

// One region of the cache for one launch.  Bounds come per row from a
// device vector, or as one host value when the vector is null.
struct Segment {
  const void* kv;        // [R, U / ut, H, ut, 128] (strided: ut = U)
  const float* sk;       // [R, H, U] k-scales (int8 only, else null)
  const float* sv;       // [R, H, U] v-scales
  const float* mask;     // [Rm, K, U]
  const int* lo_vec;     // [R] int32 or null
  const int* hi_vec;
  int lo, hi, U, Rm;
  int ut;                // slots per layout tile: U for the strided form
};

// Flat slot index of logical slot u of (row r, head h).
__device__ __forceinline__ size_t slot_index(const Segment& seg, int r, int h, int H, int u) {
  const int t = u / seg.ut;
  return ((size_t)(r * (seg.U / seg.ut) + t) * H + h) * seg.ut + (u - t * seg.ut);
}

__device__ __forceinline__ int seg_lo(const Segment& seg, int r) {
  return max(seg.lo_vec ? seg.lo_vec[r] : seg.lo, 0);
}
__device__ __forceinline__ int seg_hi(const Segment& seg, int r) {
  return min(seg.hi_vec ? seg.hi_vec[r] : seg.hi, seg.U);
}

// The online-softmax state of one (row, head) block: m and l per query in
// shared memory, the accumulator in registers (thread: output dim d,
// queries k0, k0 + 2, k0 + 4, k0 + 6).
struct SoftmaxSmem {
  float qs[kMaxK][kDh];
  float p[kMaxK][kTile];     // logits, then weights
  float sk[kTile], sv[kTile];
  float alpha[kMaxK], m[kMaxK], l[kMaxK];
};

// A staged tile of the auto kernel: slot s at s * Staged<TC>::bytes.
template <typename TC> struct Padded {
  static constexpr int kStride = Staged<TC>::bytes;
  __device__ static float dot_k(const unsigned char* tile, int s, const float* q) {
    return dot64(q, reinterpret_cast<const TC*>(tile + s * kStride));
  }
  __device__ static float v_at(const unsigned char* tile, int s, int d) {
    return to_float(reinterpret_cast<const TC*>(tile + s * kStride)[kDh + d]);
  }
};

// A ring stage of the fp32 manual kernel: slot s at s * kSlot bytes, its
// 16-byte chunk c at position c ^ (s & 7).  The logits read one slot per
// thread in 16-byte vectors: the 8 threads of a quarter warp hold 8 slots
// with 8 different low bits, so they hit 8 different chunk columns.  The
// values read one slot per warp: the swizzle only permutes chunks inside an
// aligned group of 8, so 32 neighbouring elements stay on 32 banks.
template <typename T> struct Swizzled {
  static_assert(sizeof(T) == 4, "bf16 q takes the tensor-core manual kernel");
  static constexpr int kSlot = kRow * (int)sizeof(T);       // 512 bytes
  static constexpr int kChunks = kSlot / 16;                 // 32
  static constexpr int kPer = 16 / (int)sizeof(T);           // elements per chunk
  __device__ static int chunk(int s, int c) { return s * kSlot + ((c ^ (s & 7)) << 4); }
  __device__ static float dot_k(const unsigned char* tile, int s, const float* q) {
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks / 2; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + chunk(s, c));
      const float* qc = q + c * kPer;
      dot += qc[0] * __uint_as_float(v.x) + qc[1] * __uint_as_float(v.y) +
             qc[2] * __uint_as_float(v.z) + qc[3] * __uint_as_float(v.w);
    }
    return dot;
  }
  __device__ static float v_at(const unsigned char* tile, int s, int d) {
    const int c = kChunks / 2 + d / kPer;
    return to_float(*reinterpret_cast<const T*>(tile + chunk(s, c) + (d % kPer) * sizeof(T)));
  }
};

// Fold the n staged slots of one tile into the running softmax.  `mask_u0`
// points at the tile's first slot in this row's mask (query k at k * U).
template <typename TC, typename Layout>
__device__ void fold_tile(const unsigned char* tile, int n, const float* mask_u0, int U, int K,
                          float scale, SoftmaxSmem& sm, float (&acc)[kMaxK / 2]) {
  constexpr bool kInt8 = sizeof(TC) == 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = tid % kDh, k0 = tid / kDh;

  // Logits: thread per slot; the two halves of the block take alternate
  // queries.  Slots past the tile's end get -inf and weigh exactly 0.
  {
    const int s = tid % kTile;
    for (int k = tid / kTile; k < K; k += kThreads / kTile) {
      float logit = -INFINITY;
      if (s < n) {
        logit = Layout::dot_k(tile, s, sm.qs[k]) * scale;
        if constexpr (kInt8) logit *= sm.sk[s];
        logit += mask_u0[(size_t)k * U + s];
      }
      sm.p[k][s] = logit;
    }
  }
  __syncthreads();

  // Online softmax: one warp per query.  The sum takes the unscaled
  // weights; int8 folds the v-scale into the weights afterwards.
  for (int k = warp; k < K; k += kThreads / 32) {
    const float a = sm.p[k][lane], b = sm.p[k][lane + 32];
    const float m_old = sm.m[k];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // all hidden so far
    const float ea = expf(a - m_use), eb = expf(b - m_use);
    const float sum = warp_sum(ea + eb);
    if constexpr (kInt8) {
      sm.p[k][lane] = lane < n ? ea * sm.sv[lane] : 0.f;
      sm.p[k][lane + 32] = lane + 32 < n ? eb * sm.sv[lane + 32] : 0.f;
    } else {
      sm.p[k][lane] = ea;
      sm.p[k][lane + 32] = eb;
    }
    if (lane == 0) {
      const float al = expf(m_old - m_use);
      sm.alpha[k] = al;
      sm.l[k] = sm.l[k] * al + sum;
      sm.m[k] = m_new;
    }
  }
  __syncthreads();

  // Values: acc[k][d] = acc * alpha + sum_s w[k][s] * V[s][d].
#pragma unroll
  for (int j = 0; j < kMaxK / 2; ++j)
    if (k0 + 2 * j < K) acc[j] *= sm.alpha[k0 + 2 * j];
  for (int s = 0; s < n; ++s) {
    const float v = Layout::v_at(tile, s, d);
#pragma unroll
    for (int j = 0; j < kMaxK / 2; ++j)
      if (k0 + 2 * j < K) acc[j] += sm.p[k0 + 2 * j][s] * v;
  }
}

// Walk slots [lo, hi) of one segment for block (r, h), folding them into
// the running softmax.  `tile` holds at least kTile staged slots of TC.
template <typename TC>
__device__ void walk_segment(const Segment& seg, int r, int h, int H, int K, float scale,
                             unsigned char* tile_raw, SoftmaxSmem& sm, float (&acc)[kMaxK / 2]) {
  constexpr int kStride = Staged<TC>::bytes;
  constexpr int kSlot = kRow * (int)sizeof(TC);
  constexpr int kChunks = kSlot / 16;                 // 16-byte loads per slot
  constexpr bool kInt8 = sizeof(TC) == 1;
  const int tid = threadIdx.x;
  const int U = seg.U;
  const size_t rh = (size_t)r * H + h;
  const int lo = seg_lo(seg, r), hi = seg_hi(seg, r);
  const unsigned char* kv = static_cast<const unsigned char*>(seg.kv);
  const float* mask_r = seg.mask + (size_t)(seg.Rm > 1 ? r : 0) * K * U;

  for (int u0 = lo; u0 < hi; u0 += kTile) {
    const int n = min(kTile, hi - u0);

    // Stage slots [u0, u0 + n): coalesced 16-byte loads, 4-byte stores.
    for (int c = tid; c < n * kChunks; c += kThreads) {
      const int s = c / kChunks, off = (c % kChunks) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(
          kv + slot_index(seg, r, h, H, u0 + s) * kSlot + off);
      uint32_t* dst = reinterpret_cast<uint32_t*>(tile_raw + s * kStride + off);
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    if constexpr (kInt8) {
      for (int s = tid; s < n; s += kThreads) {
        sm.sk[s] = seg.sk[rh * U + u0 + s];
        sm.sv[s] = seg.sv[rh * U + u0 + s];
      }
    }
    __syncthreads();
    fold_tile<TC, Padded<TC>>(tile_raw, n, mask_r + u0, U, K, scale, sm, acc);
    __syncthreads();
  }
}

// Load q and set the softmax state: fresh (-inf, 0, 0) or from a carry.
template <typename TQ>
__device__ void begin(const TQ* q, int rh, int K, SoftmaxSmem& sm, float (&acc)[kMaxK / 2],
                      const float* m_in, const float* l_in, const float* acc_in) {
  const int tid = threadIdx.x, d = tid % kDh, k0 = tid / kDh;
  for (int i = tid; i < K * kDh; i += kThreads)
    sm.qs[i / kDh][i % kDh] = to_float(q[(size_t)rh * K * kDh + i]);
  if (tid < K) {
    sm.m[tid] = m_in ? m_in[(size_t)rh * K + tid] : -INFINITY;
    sm.l[tid] = l_in ? l_in[(size_t)rh * K + tid] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kMaxK / 2; ++j) {
    const int k = k0 + 2 * j;
    acc[j] = (acc_in && k < K) ? acc_in[((size_t)rh * K + k) * kDh + d] : 0.f;
  }
  __syncthreads();
}

// Write the normalised output, or the partials for a later phase.
template <typename TQ>
__device__ void finish(TQ* out, int rh, int K, const SoftmaxSmem& sm,
                       const float (&acc)[kMaxK / 2], float* m_out, float* l_out,
                       float* acc_out) {
  const int tid = threadIdx.x, d = tid % kDh, k0 = tid / kDh;
  if (m_out && tid < K) {
    m_out[(size_t)rh * K + tid] = sm.m[tid];
    l_out[(size_t)rh * K + tid] = sm.l[tid];
  }
#pragma unroll
  for (int j = 0; j < kMaxK / 2; ++j) {
    const int k = k0 + 2 * j;
    if (k >= K) continue;
    const size_t o = ((size_t)rh * K + k) * kDh + d;
    if (acc_out)
      acc_out[o] = acc[j];
    else
      out[o] = from_float<TQ>(acc[j] / fmaxf(sm.l[k], 1e-30f));
  }
}

// fp32 q on CUDA cores (bf16 q takes flash_decode_mma_kernel below).
template <typename TC>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, Segment seg, float* __restrict__ out,
                    const float* m_in, const float* l_in, const float* acc_in,
                    float* m_out, float* l_out, float* acc_out, int H, int K, float scale) {
  __shared__ __align__(16) unsigned char tile[kTile * Staged<TC>::bytes];
  __shared__ SoftmaxSmem sm;
  const int rh = blockIdx.x, r = rh / H;
  float acc[kMaxK / 2];
  begin(q, rh, K, sm, acc, m_in, l_in, acc_in);
  walk_segment<TC>(seg, r, rh - r * H, H, K, scale, tile, sm, acc);
  finish(out, rh, K, sm, acc, m_out, l_out, acc_out);
}

template <typename TS, typename TL>
__global__ void __launch_bounds__(kThreads)
flash_decode_two_phase_kernel(const float* __restrict__ q, Segment shared, Segment live,
                              float* __restrict__ out, int H, int K, float scale) {
  __shared__ __align__(16) unsigned char tile[kTile * StagedMax<TS, TL>::bytes];
  __shared__ SoftmaxSmem sm;
  const int rh = blockIdx.x, r = rh / H;
  float acc[kMaxK / 2];
  begin(q, rh, K, sm, acc, nullptr, nullptr, nullptr);
  walk_segment<TS>(shared, r, rh - r * H, H, K, scale, tile, sm, acc);
  walk_segment<TL>(live, r, rh - r * H, H, K, scale, tile, sm, acc);
  finish(out, rh, K, sm, acc, nullptr, nullptr, nullptr);
}

// Start the cp.async copies of slots [u0, u0 + n) of (r, h) into a ring stage.
template <typename T>
__device__ __forceinline__ void start_tile(const Segment& seg, int r, int h, int H, int u0,
                                           int n, unsigned char* stage) {
  using L = Swizzled<T>;
  const unsigned char* kv = static_cast<const unsigned char*>(seg.kv);
  for (int c = threadIdx.x; c < n * L::kChunks; c += kThreads) {
    const int s = c / L::kChunks, j = c % L::kChunks;
    cp_async16(stage + L::chunk(s, j),
               kv + slot_index(seg, r, h, H, u0 + s) * L::kSlot + j * 16, true);
  }
}

// The manual-pipeline kernel for fp32 q: one block per (row, head), a ring
// of S stages of kTile slots in dynamic shared memory.  Before tile t is
// computed, tile t + S - 1 is started into the stage tile t - 1 left; every
// iteration commits one cp.async group (empty past the last tile), so
// waiting for all but the newest S - 2 groups means tile t has landed.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
flash_decode_manual_kernel(const T* __restrict__ q, Segment seg, T* __restrict__ out, int H,
                           int K, float scale) {
  using L = Swizzled<T>;
  constexpr int kStage = kTile * L::kSlot;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ SoftmaxSmem sm;
  const int rh = blockIdx.x, r = rh / H, h = rh - r * H;
  float acc[kMaxK / 2];
  begin(q, rh, K, sm, acc, nullptr, nullptr, nullptr);
  const int lo = seg_lo(seg, r), hi = seg_hi(seg, r);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const float* mask_r = seg.mask + (size_t)(seg.Rm > 1 ? r : 0) * K * seg.U;

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_tiles) start_tile<T>(seg, r, h, H, lo + t * kTile, min(kTile, hi - lo - t * kTile),
                                   ring + t * kStage);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S - 2>();      // this thread's copies of tile t have landed
    __syncthreads();             // everyone's; and tile t - 1's stage is free
    const int nxt = t + S - 1;
    if (nxt < n_tiles)
      start_tile<T>(seg, r, h, H, lo + nxt * kTile, min(kTile, hi - lo - nxt * kTile),
                    ring + (nxt % S) * kStage);
    cp_async_commit();
    const int u0 = lo + t * kTile;
    fold_tile<T, L>(ring + (t % S) * kStage, min(kTile, hi - u0), mask_r + u0, seg.U, K, scale,
                    sm, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  finish(out, rh, K, sm, acc, nullptr, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores, a warp-private cp.async ring per warp
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBlocksPerSm = 5;    // caps registers at 96 a thread (int8: 5 blocks an SM)
constexpr int kChunk = 32;            // slots a warp folds per step
constexpr int kStages = 2;            // ring stages per warp
constexpr int kMaskLd = kChunk + 8;   // a staged mask row, padded by 8 floats

using bf16 = __nv_bfloat16;

// Signed bytes i and j of w as a bf16 pair, exactly and without a
// conversion instruction: ``biased`` is w ^ 0x80808080, so each byte holds
// x + 128; that byte under the exponent of 2^23 is the float 2^23 + x + 128,
// less 2^23 + 128 it is x, and x (at most 8 significant bits) is the upper
// half of its float bits.
__device__ __forceinline__ uint32_t widen2(uint32_t biased, int i, int j) {
  const float a = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | j)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// How a staged chunk is laid out and read into mma fragments.  The
// contraction index of q.k^T and the output index of P.V are permuted the
// same way for both cache types, so the two-phase walk folds bf16 and int8
// chunks into one accumulator:
//   q.k^T  k-step kc, fragment column 2t + e (+ 8) <-> dh 16t + 4kc + e (+ 2):
//          thread t reads its K values of a slot as one run of 16 dh;
//   P.V    computed as O^T = V^T . P^T, m-tile mt, fragment row g (g + 8)
//          <-> dh 8g + 2mt (+ 1): thread g reads the V values dh
//          8g .. 8g + 7 of each of its four slots as one run.
// Slot s of a chunk sits at s * kSlot, its 16-byte pieces XOR-swizzled so
// that every fragment read of a warp is free of bank conflicts (pos()); the
// manual kernel's bf16 rows are padded instead (PaddedRows).
template <typename TC> struct Frag;

// Where piece c (0-7 K, 8-15 V) of bf16 slot s sits in a staged chunk.
// cp.async places each piece, so the auto kernel swizzles them: c ^ (s & 7)
// in a 256-byte row.  A bulk copy places a whole slot, so the manual kernel
// pads each row to 272 bytes (17 bank groups of 16 bytes).  Either way a
// quarter warp's K reads (slots 8j + g, pieces 2t and 2t + 1) and V reads
// (slots 2t + e, piece 8 + g) fall on 8 different 16-byte bank groups.
struct SwizzledRows {
  static constexpr int kStride = 256;
  __device__ static int pos(int s, int c) { return s * kStride + ((c ^ (s & 7)) << 4); }
};
struct PaddedRows {
  static constexpr int kStride = 272;
  __device__ static int pos(int s, int c) { return s * kStride + (c << 4); }
};

template <typename Rows> struct FragBf16 {
  static constexpr int kSlot = 256, kPieces = 16;
  static constexpr bool kInt8 = false;
  __device__ static int pos(int s, int c) { return Rows::pos(s, c); }
  // B fragments of q.k^T against slot s: kb[2kc], kb[2kc + 1] of k-step kc.
  __device__ static void k_frag(const unsigned char* st, int s, int t, uint32_t (&kb)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(st + pos(s, 2 * t));
    const uint4 b = *reinterpret_cast<const uint4*>(st + pos(s, 2 * t + 1));
    kb[0] = a.x; kb[1] = a.y; kb[2] = a.z; kb[3] = a.w;
    kb[4] = b.x; kb[5] = b.y; kb[6] = b.z; kb[7] = b.w;
  }
  // V values of the 16 slots from s0 as bf16 pairs: vb[e][0] holds dh
  // 8g + e of slots s0 + 2t + {0, 1}, vb[e][1] of slots s0 + 8 + 2t + {0, 1};
  // m-tile mt of V^T takes {vb[2mt][0], vb[2mt + 1][0], vb[2mt][1],
  // vb[2mt + 1][1]} as its A fragment.  kGuard: slots from n on read as
  // zeros (their rows were never written in this round, and a weight of 0
  // times a stale NaN is NaN).
  template <bool kGuard = false>
  __device__ static void v_frag(const unsigned char* st, int s0, int g, int t,
                                uint32_t (&vb)[8][2], int n = 0) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + 2 * t + (i & 1) + (i >> 1) * 8;
      v[i] = *reinterpret_cast<const uint4*>(st + pos(s, 8 + g));
      if constexpr (kGuard)
        if (s >= n) v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a[4] = {v[2 * i].x, v[2 * i].y, v[2 * i].z, v[2 * i].w};
      const uint32_t b[4] = {v[2 * i + 1].x, v[2 * i + 1].y, v[2 * i + 1].z, v[2 * i + 1].w};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        vb[nt][i] = __byte_perm(a[nt >> 1], b[nt >> 1], (nt & 1) ? 0x7632 : 0x5410);
    }
  }
};
template <> struct Frag<bf16> : FragBf16<SwizzledRows> {};

// int8 slot: 128 bytes, piece c (0-3 K, 4-7 V) at c ^ 2((s >> 1) & 3) ^ 4(s & 1).
// A quarter warp's K reads (16 bytes: slots 8j + g, piece t) and a half
// warp's V reads (8 bytes: slots 2t + e, half g & 1 of piece 4 + g / 2)
// fall on distinct banks.  Values widen to bf16 in registers, exactly.
template <> struct Frag<int8_t> {
  static constexpr int kSlot = 128, kPieces = 8;
  static constexpr bool kInt8 = true;
  __device__ static int pos(int s, int c) {
    return s * kSlot + ((c ^ (((s >> 1) & 3) << 1) ^ ((s & 1) << 2)) << 4);
  }
  __device__ static void k_frag(const unsigned char* st, int s, int t, uint32_t (&kb)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(st + pos(s, t));
    const uint32_t w[4] = {a.x ^ 0x80808080u, a.y ^ 0x80808080u, a.z ^ 0x80808080u,
                           a.w ^ 0x80808080u};
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      kb[2 * kc] = widen2(w[kc], 0, 1);
      kb[2 * kc + 1] = widen2(w[kc], 2, 3);
    }
  }
  __device__ static void v_frag(const unsigned char* st, int s0, int g, int t,
                                uint32_t (&vb)[8][2]) {
    uint2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const uint2*>(
          st + pos(s0 + 2 * t + (i & 1) + (i >> 1) * 8, 4 + (g >> 1)) + (g & 1) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // Bytes nt of slots a and b side by side, then widened as a pair.
      const uint32_t a[2] = {v[2 * i].x ^ 0x80808080u, v[2 * i].y ^ 0x80808080u};
      const uint32_t b[2] = {v[2 * i + 1].x ^ 0x80808080u, v[2 * i + 1].y ^ 0x80808080u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = __byte_perm(a[h], b[h], 0x5140), hi = __byte_perm(a[h], b[h], 0x7362);
        vb[4 * h][i] = widen2(lo, 0, 1);
        vb[4 * h + 1][i] = widen2(lo, 2, 3);
        vb[4 * h + 2][i] = widen2(hi, 0, 1);
        vb[4 * h + 3][i] = widen2(hi, 2, 3);
      }
    }
  }
};

// One ring stage: kChunk slots of the wider cache type, then the chunk's
// mask rows [kMaxK][kMaskLd] fp32 and, where a region is int8, sk and sv.
template <typename TS, typename TL> struct Stage {
  static constexpr int kSlotMax = Frag<TS>::kSlot > Frag<TL>::kSlot ? Frag<TS>::kSlot
                                                                     : Frag<TL>::kSlot;
  static constexpr bool kScales = sizeof(TS) == 1 || sizeof(TL) == 1;
  static constexpr int kMask = kChunk * kSlotMax;
  static constexpr int kSk = kMask + kMaxK * kMaskLd * 4;
  static constexpr int kSv = kSk + kChunk * 4;
  static constexpr int kBytes = kScales ? kSv + kChunk * 4 : kSk;
  static constexpr int kSmem = kMmaWarps * kStages * kBytes;   // per block
};

// Slots [u0, u0 + n) of one segment, n <= kChunk.
struct Chunk {
  int u0, n;
};

// Start one warp's cp.async copies of a chunk into stage st: its slots
// (zero-filled past n), the K mask rows and, for int8, the scales.
template <typename TC, typename S>
__device__ __forceinline__ void start_chunk(const Segment& seg, int r, int h, int H, int K,
                                            Chunk c, unsigned char* st, int lane) {
  using F = Frag<TC>;
  const unsigned char* kv = static_cast<const unsigned char*>(seg.kv);
  // Slot u0 + s is at offset o0 + s of layout tile t0, carried into the next
  // tiles (H heads on) past ut; the strided form is one tile of ut = U.
  const int t0 = c.u0 / seg.ut, o0 = c.u0 - t0 * seg.ut;
  const size_t tile0 = ((size_t)r * (seg.U / seg.ut) + t0) * H + h;
  const int piece = lane % F::kPieces;
#pragma unroll 4
  for (int s = lane / F::kPieces; s < kChunk; s += 32 / F::kPieces) {
    const bool ok = s < c.n;
    int o = o0 + (ok ? s : 0);
    size_t tile = tile0;
    while (o >= seg.ut) {
      o -= seg.ut;
      tile += H;
    }
    cp_async16(st + F::pos(s, piece), kv + (tile * seg.ut + o) * F::kSlot + piece * 16, ok);
  }
  const float* mask = seg.mask + (size_t)(seg.Rm > 1 ? r : 0) * K * seg.U + c.u0;
  float* ms = reinterpret_cast<float*>(st + S::kMask);
  for (int i = lane; i < K * kChunk; i += 32) {
    const int k = i / kChunk, s = i % kChunk;
    const bool ok = s < c.n;
    cp_async4(ms + k * kMaskLd + s, mask + (ok ? (size_t)k * seg.U + s : 0), ok);
  }
  if constexpr (sizeof(TC) == 1) {
    const size_t at = ((size_t)r * H + h) * seg.U + c.u0;
    for (int s = lane; s < kChunk; s += 32) {
      const bool ok = s < c.n;
      cp_async4(st + S::kSk + s * 4, seg.sk + at + (ok ? s : 0), ok);
      cp_async4(st + S::kSv + s * 4, seg.sv + at + (ok ? s : 0), ok);
    }
  }
}

// One warp's online-softmax state: the running max m of query g (its row
// of the 16-row q.k^T tile; rows g >= K and g + 8 are zero padding and
// weigh nothing), this thread's share of query g's running sum l (a quad's
// shares add up at the end), and the unnormalised accumulator O^T, the
// queries as its n: o[mt][e] is query 2t + (e & 1), dh 8g + 2mt + (e >> 1).
struct WarpState {
  float m, l;
  float o[4][4];
  __device__ void reset() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  }
};

// Fold one staged chunk of n slots into the warp's softmax.  qa holds q's
// A fragments (qa[2kc], qa[2kc + 1] of k-step kc; row g).  F reads the
// stage (Frag<TC>, or FragBf16<PaddedRows> for the manual kernel), S
// places its mask rows and scales; kGuard zeroes the V values of slots
// from n on, where the stage holds what an earlier round left there
// (cp.async zero-fills them, a bulk copy does not).
template <typename F, typename S, bool kGuard = false>
__device__ __forceinline__ void fold_chunk(const unsigned char* st, int n, int K, float scale,
                                           const uint32_t (&qa)[8], int g, int t,
                                           WarpState& ws) {
  constexpr bool kInt8 = F::kInt8;
  constexpr int kTiles = kChunk / 8;
  const float* ms = reinterpret_cast<const float*>(st + S::kMask) + g * kMaskLd;
  const float* sk = reinterpret_cast<const float*>(st + S::kSk);
  const float* sv = reinterpret_cast<const float*>(st + S::kSv);

  // S = q.k^T: s[j][e] is query g against slot 8j + 2t + e.
  float s[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    uint32_t kb[8];
    F::k_frag(st, 8 * j + g, t, kb);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {qa[2 * kc], 0u, qa[2 * kc + 1], 0u};
      mma_bf16(s[j], a, kb[2 * kc], kb[2 * kc + 1]);
    }
  }

  // Logits: scale, k-scale, mask; -inf past the chunk's n slots and on the
  // padded rows, so that those weigh exactly 0.
  const bool row = g < K;
  float mt = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sl = 8 * j + 2 * t + e;
      float x = -INFINITY;
      if (row && sl < n) {
        x = s[j][e] * scale;
        if constexpr (kInt8) x *= sk[sl];
        x += ms[sl];
      }
      s[j][e] = x;
      mt = fmaxf(mt, x);
    }
  }
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
  const float m_new = fmaxf(ws.m, mt);
  const float m_use = m_new == -INFINITY ? 0.f : m_new;       // all hidden so far
  const float alpha = expf(ws.m - m_use);
  ws.m = m_new;
  ws.l *= alpha;
  // The accumulator's queries 2t and 2t + 1 take their alphas from quads 2t, 2t + 1.
  const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
  const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    ws.o[mt][0] *= a0;
    ws.o[mt][1] *= a1;
    ws.o[mt][2] *= a0;
    ws.o[mt][3] *= a1;
  }

  // Weights: the sum takes them unscaled; the v-scale multiplies them and
  // they round to bf16 for P.V, as in the twin and the TPU kernel.  The S
  // accumulators of slots 16kk .. 16kk + 15 (query g, slots 2t + e and
  // 8 + 2t + e) are the B fragment of P^T for k-step kk as they stand.
  uint32_t pa[kTiles / 2][2];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    float p0 = expf(s[j][0] - m_use), p1 = expf(s[j][1] - m_use);
    ws.l += p0 + p1;
    if constexpr (kInt8) {
      p0 *= sv[8 * j + 2 * t];
      p1 *= sv[8 * j + 2 * t + 1];
    }
    pa[j >> 1][j & 1] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int kk = 0; kk < kTiles / 2; ++kk) {
    uint32_t vb[8][2];
    if constexpr (kGuard)
      F::template v_frag<true>(st, 16 * kk, g, t, vb, n);
    else
      F::v_frag(st, 16 * kk, g, t, vb);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t a[4] = {vb[2 * mt][0], vb[2 * mt + 1][0], vb[2 * mt][1],
                             vb[2 * mt + 1][1]};
      mma_bf16(ws.o[mt], a, pa[kk][0], pa[kk][1]);
    }
  }
}

// q's A fragments for row g of (row, head) rh (zero for g >= K): dh
// 16t .. 16t + 15.
__device__ __forceinline__ void load_q(const bf16* q, size_t rh, int K, int g, int t,
                                       uint32_t (&qa)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) qa[i] = 0u;
  if (g < K) {
    const uint4* qp = reinterpret_cast<const uint4*>(q + (rh * K + g) * kDh + 16 * t);
    const uint4 a = qp[0], b = qp[1];
    qa[0] = a.x; qa[1] = a.y; qa[2] = a.z; qa[3] = a.w;
    qa[4] = b.x; qa[5] = b.y; qa[6] = b.z; qa[7] = b.w;
  }
}

// A warp's (acc, m, l) per query into part[warp][kMaxK][kPart] (a quad's
// shares of l summed first).
constexpr int kPart = kDh + 2;
__device__ __forceinline__ void store_partial(float* part, int warp, WarpState& ws, int K, int g,
                                              int t) {
  ws.l += __shfl_xor_sync(0xffffffffu, ws.l, 1);
  ws.l += __shfl_xor_sync(0xffffffffu, ws.l, 2);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (2 * t + e < K) {
      float* p = part + (warp * kMaxK + 2 * t + e) * kPart + 8 * g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        p[2 * mt] = ws.o[mt][e];
        p[2 * mt + 1] = ws.o[mt][2 + e];
      }
    }
  }
  if (g < K && t == 0) {
    part[(warp * kMaxK + g) * kPart + kDh] = ws.m;
    part[(warp * kMaxK + g) * kPart + kDh + 1] = ws.l;
  }
}

// One thread (tid of n) per output element of (row, head) rh brings the
// warps' partials and the carry in to the common max: m = max, l and acc
// summed with weights exp(m_w - m).  Writes the output, or with acc_out
// non-null the carry out.
template <int kWarps>
__device__ __forceinline__ void merge_partials(const float* part, size_t rh, int K, int tid, int n,
                                               bf16* out, const float* m_in, const float* l_in,
                                               const float* acc_in, float* m_out, float* l_out,
                                               float* acc_out) {
  for (int i = tid; i < K * kDh; i += n) {
    const int k = i / kDh, d = i - k * kDh;
    const size_t ml = rh * K + k, at = ml * kDh + d;
    float m = m_in ? m_in[ml] : -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[(w * kMaxK + k) * kPart + kDh]);
    const float m_use = m == -INFINITY ? 0.f : m;
    float l = 0.f, acc = 0.f;
    if (m_in) {
      const float a = expf(m_in[ml] - m_use);
      l = l_in[ml] * a;
      acc = acc_in[at] * a;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* p = part + (w * kMaxK + k) * kPart;
      const float a = expf(p[kDh] - m_use);
      l += p[kDh + 1] * a;
      acc += p[d] * a;
    }
    if (acc_out) {
      acc_out[at] = acc;
      if (d == 0) {
        m_out[ml] = m;
        l_out[ml] = l;
      }
    } else {
      out[at] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
    }
  }
}

// Decode attention for bf16 q over one segment (kTwo false; s1 and TL
// unused) or over a shared then a live segment in one softmax (kTwo).  One
// block per (row, head) of kMmaWarps warps.  The slots of the segments are cut
// into chunks of kChunk, numbered across both; warp w folds chunks w,
// w + kMmaWarps, ... into its own softmax state, fed by its own ring of
// kStages cp.async stages (chunk j + kStages - 1 starts before chunk j is
// folded), with __syncwarp only.  The warps' states and the carry in merge
// once at the end through shared memory.
template <typename TS, typename TL, bool kTwo>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
flash_decode_mma_kernel(const bf16* __restrict__ q, Segment s0, Segment s1,
                        bf16* __restrict__ out, const float* m_in, const float* l_in,
                        const float* acc_in, float* m_out, float* l_out, float* acc_out, int H,
                        int K, float scale) {
  using S = Stage<TS, TL>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rh = blockIdx.x, r = rh / H, h = rh - r * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + warp * kStages * S::kBytes;

  const int lo0 = seg_lo(s0, r), hi0 = seg_hi(s0, r);
  const int n0 = hi0 > lo0 ? (hi0 - lo0 + kChunk - 1) / kChunk : 0;
  int lo1 = 0, hi1 = 0, n1 = 0;
  if constexpr (kTwo) {
    lo1 = seg_lo(s1, r);
    hi1 = seg_hi(s1, r);
    n1 = hi1 > lo1 ? (hi1 - lo1 + kChunk - 1) / kChunk : 0;
  }
  const int total = n0 + n1;
  const int mine = total > warp ? (total - warp + kMmaWarps - 1) / kMmaWarps : 0;
  // The warp's j-th chunk is chunk warp + j kMmaWarps of the walk.
  auto chunk = [&](int i) {
    return i < n0 ? Chunk{lo0 + i * kChunk, min(kChunk, hi0 - lo0 - i * kChunk)}
                  : Chunk{lo1 + (i - n0) * kChunk, min(kChunk, hi1 - lo1 - (i - n0) * kChunk)};
  };
  auto start = [&](int j) {                // one commit group per call, empty past the end
    if (j < mine) {
      const int i = warp + j * kMmaWarps;
      unsigned char* st = ring + (j % kStages) * S::kBytes;
      if (i < n0)
        start_chunk<TS, S>(s0, r, h, H, K, chunk(i), st, lane);
      else
        start_chunk<TL, S>(s1, r, h, H, K, chunk(i), st, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) start(j);

  uint32_t qa[8];
  load_q(q, rh, K, g, t, qa);
  WarpState ws;
  ws.reset();
  for (int j = 0; j < mine; ++j) {
    __syncwarp();                          // every lane is done with chunk j - 1's stage
    start(j + kStages - 1);
    cp_async_wait<kStages - 1>();          // this lane's copies of chunk j have landed
    __syncwarp();                          // and every lane's
    const int i = warp + j * kMmaWarps;
    const unsigned char* st = ring + (j % kStages) * S::kBytes;
    if (i < n0)
      fold_chunk<Frag<TS>, S>(st, chunk(i).n, K, scale, qa, g, t, ws);
    else
      fold_chunk<Frag<TL>, S>(st, chunk(i).n, K, scale, qa, g, t, ws);
  }
  cp_async_wait<0>();

  // Merge, through the idle rings.
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);     // [kMmaWarps][kMaxK][kPart]
  store_partial(part, warp, ws, K, g, t);
  __syncthreads();
  merge_partials<kMmaWarps>(part, rh, K, threadIdx.x, kMmaThreads, out, m_in, l_in, acc_in,
                            m_out, l_out, acc_out);
}

template <typename TS, typename TL, bool kTwo>
cudaError_t launch_mma(const void* q, const Segment& s0, const Segment& s1, void* out,
                       const float* m_in, const float* l_in, const float* acc_in, float* m_out,
                       float* l_out, float* acc_out, int R, int H, int K, float scale,
                       cudaStream_t st) {
  constexpr int smem = Stage<TS, TL>::kSmem;
  const auto kernel = flash_decode_mma_kernel<TS, TL, kTwo>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  kernel<<<R * H, kMmaThreads, smem, st>>>(static_cast<const bf16*>(q), s0, s1,
                                        static_cast<bf16*>(out), m_in, l_in, acc_in, m_out,
                                        l_out, acc_out, H, K, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 q, manual-pipeline form: a persistent bulk-copy ring under mbarriers
// ---------------------------------------------------------------------------

constexpr int kManualWarps = 2;                 // warps a block
constexpr int kManualThreads = 32 * kManualWarps;
static_assert(kChunk == 32, "a warp copies one slot per lane");

// One ring stage: kChunk padded bf16 rows, then the chunk's mask rows
// [kMaxK][kMaskLd] fp32 (no scales: the manual form has no int8 cache).
struct ManualStage {
  static constexpr int kMask = kChunk * PaddedRows::kStride;
  static constexpr int kSk = kMask, kSv = kMask;          // unused
  static constexpr int kBytes = kMask + kMaxK * kMaskLd * 4;
};
static_assert(ManualStage::kBytes % 16 == 0, "bulk copies land on 16-byte boundaries");

// Dynamic shared memory of a block with S stages a warp: the rings
// [warp][stage], two sets of the warps' partials (items alternate between
// them, so a warp can store item i + 1's while the other still reads item
// i's), then one full mbarrier a stage.
template <int S> struct ManualSmem {
  static constexpr int kParts = kManualWarps * S * ManualStage::kBytes;
  static constexpr int kPartFloats = kManualWarps * kMaxK * kPart;
  static constexpr int kBars = kParts + 2 * kPartFloats * 4;
  static constexpr int kBytes = kBars + kManualWarps * S * 8;
};

// Where a warp's walk stands: chunk j of item `it` (slots [lo, hi), nc
// chunks), carried into the block's next items past nc.
struct ManualCursor {
  int it, j, lo, hi, nc;
  __device__ void load(const Segment& seg, int H) {
    const int r = it / H;
    lo = seg_lo(seg, r);
    hi = seg_hi(seg, r);
    nc = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  }
  __device__ void carry(const Segment& seg, int H, int items) {
    while (it < items && j >= nc) {
      j -= nc;
      it += gridDim.x;
      if (it < items) load(seg, H);
    }
  }
};

// The manual-pipeline kernel for bf16 q.  A persistent grid: block b takes
// the (row, head) items b, b + gridDim.x, ... (item r H + h, so that the
// blocks in flight hold the heads of one row and its mask rows stay in L2).
// The items' slots are cut into chunks of kChunk, numbered across all of
// the block's items; chunk c is warp c % 2's, and goes into stage (c / 2)
// % S of that warp's ring.  Each warp is its own producer: S - 1 chunks
// ahead of the one it folds, and across items, it asks the copy engine for
// each slot of a chunk (lane l: one 256-byte bulk copy into padded row l,
// counted on the stage's full mbarrier, whose byte count lane 0 sets) and
// cp.asyncs the slot's K mask values (one commit group a chunk).  Lanes
// past a row's bound copy nothing; their rows keep an earlier round's
// bytes, which the fold neither weighs nor multiplies (kGuard).  Before a
// stage is asked for again the warp has read it (__syncwarp) and fenced
// its generic reads from the copy engine's writes.  Each warp folds its
// chunks with the auto kernel's fold_chunk into its own softmax state; at
// the end of an item both warps store their partials, meet at one barrier
// and merge, while the next item's copies are already landing.
template <int S>
__global__ void __launch_bounds__(kManualThreads)
flash_decode_manual_mma_kernel(const bf16* __restrict__ q, Segment seg, bf16* __restrict__ out,
                               int R, int H, int K, float scale) {
  using M = ManualSmem<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = R * H;
  const unsigned char* kv = static_cast<const unsigned char*>(seg.kv);
  unsigned char* ring = smem + warp * S * ManualStage::kBytes;
  const unsigned bars = smem_addr(smem + M::kBars) + 8u * warp * S;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8u * s, 1);   // lane 0's expect_tx
    mbar_init_fence();
  }
  __syncwarp();

  // The copies of the warp's next chunk into its next stage, one cp.async
  // commit group a call (empty past the block's last chunk).
  ManualCursor next{(int)blockIdx.x, warp, 0, 0, 0};
  if (next.it < items) next.load(seg, H);
  next.carry(seg, H, items);
  int issued = 0;
  auto issue = [&]() {
    if (next.it < items) {
      const int r = next.it / H, h = next.it - r * H;
      const int u0 = next.lo + next.j * kChunk, n = min(kChunk, next.hi - u0);
      unsigned char* st = ring + (issued % S) * ManualStage::kBytes;
      const unsigned full = bars + 8u * (issued % S);
      if (lane == 0) mbar_arrive_expect_tx(full, n * Frag<bf16>::kSlot);
      __syncwarp();
      if (lane < n) {
        bulk_copy_g2s(smem_addr(st + lane * PaddedRows::kStride),
                      kv + slot_index(seg, r, h, H, u0 + lane) * Frag<bf16>::kSlot,
                      Frag<bf16>::kSlot, full);
        const float* mask = seg.mask + (size_t)(seg.Rm > 1 ? r : 0) * K * seg.U + u0 + lane;
        float* ms = reinterpret_cast<float*>(st + ManualStage::kMask) + lane;
        for (int qk = 0; qk < K; ++qk)
          cp_async4(ms + qk * kMaskLd, mask + (size_t)qk * seg.U, true);
      }
      ++issued;
      next.j += kManualWarps;
      next.carry(seg, H, items);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue();

  const int g = lane >> 2, t = lane & 3;
  float* parts = reinterpret_cast<float*>(smem + M::kParts);
  int c0 = 0, b = 0, k = 0;                   // k: the warp's chunks folded so far
  for (int it = blockIdx.x; it < items; it += gridDim.x, b ^= 1) {
    ManualCursor cur{it, 0, 0, 0, 0};
    cur.load(seg, H);
    uint32_t qa[8];
    load_q(q, it, K, g, t, qa);
    WarpState ws;
    ws.reset();
    for (int j = ((warp - c0) % kManualWarps + kManualWarps) % kManualWarps; j < cur.nc;
         j += kManualWarps, ++k) {
      __syncwarp();                           // every lane is done with chunk k - 1's stage
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue();                                // chunk k + S - 1 into that stage
      cp_async_wait<S - 1>();                 // this lane's mask values of chunk k
      __syncwarp();                           // and every lane's
      mbar_wait(bars + 8u * (k % S), (k / S) & 1);    // the slots of chunk k
      fold_chunk<FragBf16<PaddedRows>, ManualStage, true>(
          ring + (k % S) * ManualStage::kBytes, min(kChunk, cur.hi - cur.lo - j * kChunk), K,
          scale, qa, g, t, ws);
    }
    c0 += cur.nc;
    float* part = parts + b * M::kPartFloats;
    store_partial(part, warp, ws, K, g, t);
    __syncthreads();
    merge_partials<kManualWarps>(part, it, K, threadIdx.x, kManualThreads, out, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr);
  }
  cp_async_wait<0>();
}

// Blocks of the manual kernel with S stages that the card holds at once
// (the occupancy query runs once per S).
template <int S>
int manual_resident_blocks() {
  static int resident = -1;
  if (resident < 0) {
    int per_sm = 0, dev = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, flash_decode_manual_mma_kernel<S>, kManualThreads,
            ManualSmem<S>::kBytes) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    resident = per_sm * sms;
  }
  return resident;
}

template <int S>
cudaError_t launch_manual_mma(const void* q, const Segment& seg, void* out, int R, int H, int K,
                              float scale, cudaStream_t st) {
  constexpr int smem = ManualSmem<S>::kBytes;
  const auto kernel = flash_decode_manual_mma_kernel<S>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const int resident = manual_resident_blocks<S>();
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = R * H < resident ? R * H : resident;
  kernel<<<blocks, kManualThreads, smem, st>>>(
      static_cast<const bf16*>(q), seg, static_cast<bf16*>(out), R, H, K, scale);
  return cudaGetLastError();
}

// fp32 q: the CUDA-core kernels above.
void launch_fp32(const void* q, const Segment& seg, bool int8, void* out, const float* m_in,
                 const float* l_in, const float* acc_in, float* m_out, float* l_out,
                 float* acc_out, int R, int H, int K, float scale, cudaStream_t st) {
  const float* qq = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  if (int8)
    flash_decode_kernel<int8_t><<<R * H, kThreads, 0, st>>>(
        qq, seg, o, m_in, l_in, acc_in, m_out, l_out, acc_out, H, K, scale);
  else
    flash_decode_kernel<float><<<R * H, kThreads, 0, st>>>(
        qq, seg, o, m_in, l_in, acc_in, m_out, l_out, acc_out, H, K, scale);
}

void launch_two_phase_fp32(const void* q, const Segment& sh, const Segment& lv, void* out, int R,
                           int H, int K, float scale, cudaStream_t st) {
  const float* qq = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  const dim3 grid(R * H);
  const bool s8 = sh.sk != nullptr, l8 = lv.sk != nullptr;
  if (s8 && l8)
    flash_decode_two_phase_kernel<int8_t, int8_t><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else if (s8)
    flash_decode_two_phase_kernel<int8_t, float><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else if (l8)
    flash_decode_two_phase_kernel<float, int8_t><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else
    flash_decode_two_phase_kernel<float, float><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
}

cudaError_t launch_two_phase_bf16(const void* q, const Segment& sh, const Segment& lv, void* out,
                                  int R, int H, int K, float scale, cudaStream_t st) {
  const bool s8 = sh.sk != nullptr, l8 = lv.sk != nullptr;
  auto launch = s8 ? (l8 ? launch_mma<int8_t, int8_t, true> : launch_mma<int8_t, bf16, true>)
                   : (l8 ? launch_mma<bf16, int8_t, true> : launch_mma<bf16, bf16, true>);
  return launch(q, sh, lv, out, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, R, H, K,
                scale, st);
}

// fp32 q: the CUDA-core kernel; bf16 q: the bulk-copy ring.
template <typename T, int S>
cudaError_t launch_manual(const void* q, const Segment& seg, void* out, int R, int H, int K,
                          float scale, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    return launch_manual_mma<S>(q, seg, out, R, H, K, scale, st);
  } else {
    constexpr int smem = S * kTile * Swizzled<T>::kSlot;
    const cudaError_t set = cudaFuncSetAttribute(
        flash_decode_manual_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
    flash_decode_manual_kernel<T, S><<<R * H, kThreads, smem, st>>>(
        static_cast<const T*>(q), seg, static_cast<T*>(out), H, K, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_manual_slots(int slots, const void* q, const Segment& seg, void* out, int R,
                                int H, int K, float scale, cudaStream_t st) {
  switch (slots) {
    case 2: return launch_manual<T, 2>(q, seg, out, R, H, K, scale, st);
    case 3: return launch_manual<T, 3>(q, seg, out, R, H, K, scale, st);
    case 4: return launch_manual<T, 4>(q, seg, out, R, H, K, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace clipcap

// One segment.  sk/sv non-null = int8 cache (strided: ut = U).  Bounds:
// lo_vec/hi_vec ([R] int32 on the device) where non-null, else the host
// values lo/hi.  Carry: m_in/l_in/acc_in resume a softmax (all null =
// fresh); with acc_out non-null the kernel writes m_out/l_out/acc_out and
// not out.  ut: slots per layout tile (U: strided [R, H, U, 128]; else
// tile-major [R, U / ut, H, ut, 128]).
extern "C" int clipcap_flash_decode(const void* q, const void* kv, const void* sk, const void* sv,
                                    const void* mask, void* out, const void* m_in,
                                    const void* l_in, const void* acc_in, void* m_out,
                                    void* l_out, void* acc_out, const void* lo_vec,
                                    const void* hi_vec, int R, int H, int K, int U, int ut, int Rm,
                                    int lo, int hi, int dtype, float scale, void* stream) {
  using namespace clipcap;
  const Segment seg{kv, static_cast<const float*>(sk), static_cast<const float*>(sv),
                    static_cast<const float*>(mask), static_cast<const int*>(lo_vec),
                    static_cast<const int*>(hi_vec), lo, hi, U, Rm, ut};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto mi = static_cast<const float*>(m_in), li = static_cast<const float*>(l_in),
             ai = static_cast<const float*>(acc_in);
  const auto mo = static_cast<float*>(m_out), lout = static_cast<float*>(l_out),
             ao = static_cast<float*>(acc_out);
  if (dtype == kBFloat16) {
    auto launch = sk ? launch_mma<int8_t, int8_t, false> : launch_mma<bf16, bf16, false>;
    return static_cast<int>(launch(q, seg, seg, out, mi, li, ai, mo, lout, ao, R, H, K, scale, st));
  }
  launch_fp32(q, seg, sk != nullptr, out, mi, li, ai, mo, lout, ao, R, H, K, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// The manual-pipeline form over a bf16/fp32 cache (strided or tile-major,
// as above) with `slots` ring stages in 2..4; bounds as above.
extern "C" int clipcap_flash_decode_manual(const void* q, const void* kv, const void* mask,
                                           void* out, const void* lo_vec, const void* hi_vec,
                                           int R, int H, int K, int U, int ut, int Rm, int lo,
                                           int hi, int slots, int dtype, float scale,
                                           void* stream) {
  using namespace clipcap;
  const Segment seg{kv, nullptr, nullptr, static_cast<const float*>(mask),
                    static_cast<const int*>(lo_vec), static_cast<const int*>(hi_vec),
                    lo, hi, U, Rm, ut};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == kBFloat16
          ? launch_manual_slots<__nv_bfloat16>(slots, q, seg, out, R, H, K, scale, st)
          : launch_manual_slots<float>(slots, q, seg, out, R, H, K, scale, st);
  return static_cast<int>(e);
}

// Shared region slots [0, sh_hi[r]), then live region slots
// [lv_lo[r], lv_hi[r]), in one softmax.  Each region is int8 where its
// scales are non-null; each bound is a device vector where non-null.
extern "C" int clipcap_flash_decode_two_phase(
    const void* q, const void* skv, const void* ssk, const void* ssv, const void* smask, int Us,
    int sRm, const void* sh_hi_vec, int sh_hi, const void* lkv, const void* lsk,
    const void* lsv, const void* lmask, int Ul, int lRm, const void* lv_lo_vec, int lv_lo,
    const void* lv_hi_vec, int lv_hi, void* out, int R, int H, int K, int dtype, float scale,
    void* stream) {
  using namespace clipcap;
  const Segment sh{skv, static_cast<const float*>(ssk), static_cast<const float*>(ssv),
                   static_cast<const float*>(smask), nullptr,
                   static_cast<const int*>(sh_hi_vec), 0, sh_hi, Us, sRm, Us};
  const Segment lv{lkv, static_cast<const float*>(lsk), static_cast<const float*>(lsv),
                   static_cast<const float*>(lmask), static_cast<const int*>(lv_lo_vec),
                   static_cast<const int*>(lv_hi_vec), lv_lo, lv_hi, Ul, lRm, Ul};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return static_cast<int>(launch_two_phase_bf16(q, sh, lv, out, R, H, K, scale, st));
  launch_two_phase_fp32(q, sh, lv, out, R, H, K, scale, st);
  return static_cast<int>(cudaGetLastError());
}
