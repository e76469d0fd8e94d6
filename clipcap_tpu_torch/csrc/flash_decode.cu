// Flash-decode attention: one KV-cached decode step over the interleaved
// K|V cache, on Hopper (sm_90a).
//
// Replaces the TPU kernels of clipcap_tpu/ops/flash_decode.py:
//   * flash_decode (_flash_call -> _kernel, online-softmax core
//     _flash_update): bf16/fp32 or int8 cache with per-slot scales,
//     per-row slot bounds [lo, hi), optional online-softmax carry in/out;
//   * flash_decode_two_phase (_fused_call -> _fused_kernel): one softmax
//     over a consolidated shared-prefix cache, then the live beam cache,
//     each region bf16/fp32 or int8.
//
//   q    [R, H, K, 64]   this step's queries (K beams, or K = 1)
//   kv   [R, H, U, 128]  cache; slot u holds K in [0, 64), V in [64, 128);
//                        int8 rows with sk, sv [R, H, U] fp32 scales
//   mask [Rm, K, U]      fp32 additive (beam ancestry or causal), Rm in {1, R}
//   out  [R, H, K, 64] = softmax(q.k^T / 8 [* sk] + mask) . ([sv *] v)
//                        over the slots [lo[r], hi[r]) of each row r
//   carry (m, l [R, H, K], acc [R, H, K, 64] fp32): the running max, sum
//                        and unnormalised V accumulator of the softmax
//
// What bounds it on the H100: bytes.  A decode step reads each written
// cache slot once (256 bytes per slot and head in bf16, 128 + 8 in int8)
// to do 4*K flops per byte, far under the card's ~295 flops/byte ridge.
// The design therefore reads each valid slot exactly once, with 16-byte
// coalesced loads into a shared-memory tile, and never touches a slot
// outside its row's [lo, hi): the bounds are exact per row, where the TPU
// kernel rounds them out to whole tiles per row block and masks the slack
// (a masked slot weighs exp(-1e9 - m) = 0 in fp32, so the two agree).
// One thread block per (row, head) walks the slots in tiles of 64 and
// keeps the fp32 online-softmax state (running max, sum, accumulator) on
// chip; a segment is one walk, and the two-phase kernel walks two under
// one launch, so its partials never leave the chip.  int8 rows stay int8
// in shared memory and widen in registers; the k-scale multiplies the
// logit after the dot and the v-scale the weight before the value product,
// as the TPU kernel folds them.  Softmax weights stay fp32 (the TPU kernel
// rounds them to q's dtype before the value product).  Tensor cores, TMA
// and a split over the slot axis are later work.
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
template <> struct Staged<__nv_bfloat16> { static constexpr int bytes = 65 * 4; };
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
__device__ __forceinline__ float dot64(const float* q, const __nv_bfloat16* k) {
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
  const void* kv;        // [R, H, U, 128]
  const float* sk;       // [R, H, U] k-scales (int8 only, else null)
  const float* sv;       // [R, H, U] v-scales
  const float* mask;     // [Rm, K, U]
  const int* lo_vec;     // [R] int32 or null
  const int* hi_vec;
  int lo, hi, U, Rm;
};

// The online-softmax state of one (row, head) block: m and l per query in
// shared memory, the accumulator in registers (thread: output dim d,
// queries k0, k0 + 2, k0 + 4, k0 + 6).
struct SoftmaxSmem {
  float qs[kMaxK][kDh];
  float p[kMaxK][kTile];     // logits, then weights
  float sk[kTile], sv[kTile];
  float alpha[kMaxK], m[kMaxK], l[kMaxK];
};

// Walk slots [lo, hi) of one segment for block (r, h), folding them into
// the running softmax.  `tile` holds at least kTile staged slots of TC.
template <typename TC>
__device__ void walk_segment(const Segment& seg, int r, int rh, int K, float scale,
                             unsigned char* tile_raw, SoftmaxSmem& sm, float (&acc)[kMaxK / 2]) {
  constexpr int kStride = Staged<TC>::bytes;
  constexpr int kChunks = kRow * (int)sizeof(TC) / 16;   // 16-byte loads per slot
  constexpr bool kInt8 = sizeof(TC) == 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = tid % kDh, k0 = tid / kDh;
  const int U = seg.U;
  const int lo = max(seg.lo_vec ? seg.lo_vec[r] : seg.lo, 0);
  const int hi = min(seg.hi_vec ? seg.hi_vec[r] : seg.hi, U);
  const unsigned char* kv_rh =
      static_cast<const unsigned char*>(seg.kv) + (size_t)rh * U * kRow * sizeof(TC);
  const float* mask_r = seg.mask + (size_t)(seg.Rm > 1 ? r : 0) * K * U;

  for (int u0 = lo; u0 < hi; u0 += kTile) {
    const int n = min(kTile, hi - u0);

    // Stage slots [u0, u0 + n): coalesced 16-byte loads, 4-byte stores.
    for (int c = tid; c < n * kChunks; c += kThreads) {
      const int s = c / kChunks, off = (c % kChunks) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(
          kv_rh + (size_t)(u0 + s) * kRow * sizeof(TC) + off);
      uint32_t* dst = reinterpret_cast<uint32_t*>(tile_raw + s * kStride + off);
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    if constexpr (kInt8) {
      for (int s = tid; s < n; s += kThreads) {
        sm.sk[s] = seg.sk[(size_t)rh * U + u0 + s];
        sm.sv[s] = seg.sv[(size_t)rh * U + u0 + s];
      }
    }
    __syncthreads();

    // Logits: thread per slot; the two halves of the block take alternate
    // queries.  Slots past the tile's end get -inf and weigh exactly 0.
    {
      const int s = tid % kTile;
      const TC* krow = reinterpret_cast<const TC*>(tile_raw + s * kStride);
      for (int k = tid / kTile; k < K; k += kThreads / kTile) {
        float logit = -INFINITY;
        if (s < n) {
          logit = dot64(sm.qs[k], krow) * scale;
          if constexpr (kInt8) logit *= sm.sk[s];
          logit += mask_r[(size_t)k * U + u0 + s];
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
      const float v = to_float(reinterpret_cast<const TC*>(tile_raw + s * kStride)[kDh + d]);
#pragma unroll
      for (int j = 0; j < kMaxK / 2; ++j)
        if (k0 + 2 * j < K) acc[j] += sm.p[k0 + 2 * j][s] * v;
    }
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

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, Segment seg, TQ* __restrict__ out,
                    const float* m_in, const float* l_in, const float* acc_in,
                    float* m_out, float* l_out, float* acc_out, int H, int K, float scale) {
  __shared__ __align__(16) unsigned char tile[kTile * Staged<TC>::bytes];
  __shared__ SoftmaxSmem sm;
  const int rh = blockIdx.x, r = rh / H;
  float acc[kMaxK / 2];
  begin(q, rh, K, sm, acc, m_in, l_in, acc_in);
  walk_segment<TC>(seg, r, rh, K, scale, tile, sm, acc);
  finish(out, rh, K, sm, acc, m_out, l_out, acc_out);
}

template <typename TQ, typename TS, typename TL>
__global__ void __launch_bounds__(kThreads)
flash_decode_two_phase_kernel(const TQ* __restrict__ q, Segment shared, Segment live,
                              TQ* __restrict__ out, int H, int K, float scale) {
  __shared__ __align__(16) unsigned char tile[kTile * StagedMax<TS, TL>::bytes];
  __shared__ SoftmaxSmem sm;
  const int rh = blockIdx.x, r = rh / H;
  float acc[kMaxK / 2];
  begin(q, rh, K, sm, acc, nullptr, nullptr, nullptr);
  walk_segment<TS>(shared, r, rh, K, scale, tile, sm, acc);
  walk_segment<TL>(live, r, rh, K, scale, tile, sm, acc);
  finish(out, rh, K, sm, acc, nullptr, nullptr, nullptr);
}

template <typename TQ>
void launch_single(const void* q, const Segment& seg, bool int8, void* out, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out, float* l_out,
                   float* acc_out, int R, int H, int K, float scale, cudaStream_t st) {
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  if (int8)
    flash_decode_kernel<TQ, int8_t><<<R * H, kThreads, 0, st>>>(
        qq, seg, o, m_in, l_in, acc_in, m_out, l_out, acc_out, H, K, scale);
  else
    flash_decode_kernel<TQ, TQ><<<R * H, kThreads, 0, st>>>(
        qq, seg, o, m_in, l_in, acc_in, m_out, l_out, acc_out, H, K, scale);
}

template <typename TQ>
void launch_two_phase(const void* q, const Segment& sh, const Segment& lv, void* out, int R,
                      int H, int K, float scale, cudaStream_t st) {
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  const dim3 grid(R * H);
  const bool s8 = sh.sk != nullptr, l8 = lv.sk != nullptr;
  if (s8 && l8)
    flash_decode_two_phase_kernel<TQ, int8_t, int8_t><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else if (s8)
    flash_decode_two_phase_kernel<TQ, int8_t, TQ><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else if (l8)
    flash_decode_two_phase_kernel<TQ, TQ, int8_t><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
  else
    flash_decode_two_phase_kernel<TQ, TQ, TQ><<<grid, kThreads, 0, st>>>(qq, sh, lv, o, H, K, scale);
}

}  // namespace
}  // namespace clipcap

// One segment.  sk/sv non-null = int8 cache.  Bounds: lo_vec/hi_vec
// ([R] int32 on the device) where non-null, else the host values lo/hi.
// Carry: m_in/l_in/acc_in resume a softmax (all null = fresh); with
// acc_out non-null the kernel writes m_out/l_out/acc_out and not out.
extern "C" int clipcap_flash_decode(const void* q, const void* kv, const void* sk, const void* sv,
                                    const void* mask, void* out, const void* m_in,
                                    const void* l_in, const void* acc_in, void* m_out,
                                    void* l_out, void* acc_out, const void* lo_vec,
                                    const void* hi_vec, int R, int H, int K, int U, int Rm,
                                    int lo, int hi, int dtype, float scale, void* stream) {
  using namespace clipcap;
  const Segment seg{kv, static_cast<const float*>(sk), static_cast<const float*>(sv),
                    static_cast<const float*>(mask), static_cast<const int*>(lo_vec),
                    static_cast<const int*>(hi_vec), lo, hi, U, Rm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == kBFloat16 ? launch_single<__nv_bfloat16> : launch_single<float>;
  launch(q, seg, sk != nullptr, out, static_cast<const float*>(m_in),
         static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
         static_cast<float*>(m_out), static_cast<float*>(l_out), static_cast<float*>(acc_out),
         R, H, K, scale, st);
  return static_cast<int>(cudaGetLastError());
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
                   static_cast<const int*>(sh_hi_vec), 0, sh_hi, Us, sRm};
  const Segment lv{lkv, static_cast<const float*>(lsk), static_cast<const float*>(lsv),
                   static_cast<const float*>(lmask), static_cast<const int*>(lv_lo_vec),
                   static_cast<const int*>(lv_hi_vec), lv_lo, lv_hi, Ul, lRm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    launch_two_phase<__nv_bfloat16>(q, sh, lv, out, R, H, K, scale, st);
  else
    launch_two_phase<float>(q, sh, lv, out, R, H, K, scale, st);
  return static_cast<int>(cudaGetLastError());
}
