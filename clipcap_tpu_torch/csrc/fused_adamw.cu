// Fused AdamW: one launch updates every parameter tensor in place, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel clipcap_tpu/ops/fused_adamw.py::fused_adamw
// (_apply_leaf -> _adamw_kernel), which runs one pallas_call per leaf and
// returns the delta for optax.apply_updates.  Here the delta is added to
// the parameter inside the kernel, so one pass reads p, g, m, v and writes
// p, m, v, all fp32.
//
//   table [5n + 1] int64, on the device: the pointers p[0..n), g[0..n),
//         m[0..n), v[0..n) of the n tensors, then the prefix sums
//         off[0..n] of their element counts (off[0] = 0).
//
// Each block takes kSpan elements of the concatenated range [0, off[n]);
// a span may cross tensor boundaries, and a block finds its first tensor
// by binary search over off.  Per element, in the order of the plain twin
// (ops/fused_adamw.py::fused_adamw_ref):
//
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*(g*g)
//   u = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p;  p = p + (-lr)*u
//
// every operation rounded on its own (__f*_rn intrinsics, no contraction
// into FMAs), so the kernel equals the twin bit for bit.
//
// What bounds it on the H100: bytes.  An element costs 16 bytes read and
// 12 written for ~15 flops, far under the ridge.  The design therefore
// makes one launch per optimizer step whatever the tensor count (the TPU
// kernel's launch per leaf lost to XLA's fused optax chain), reads and
// writes each byte once, and uses 16-byte loads wherever all four pointers
// are 16-byte aligned, with scalar head and tail elements around them.
#include "common.cuh"

namespace clipcap {
namespace {

constexpr int kThreads = 256;
constexpr int64_t kSpan = int64_t(kThreads) * 4 * 4;   // four float4 per thread

struct AdamW {
  float neg_lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;

  __device__ __forceinline__ void apply(float& p, float g, float& m, float& v) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)));
    const float mhat = __fdiv_rn(m, bc1);
    const float vhat = __fdiv_rn(v, bc2);
    const float u = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                              __fmul_rn(wd, p));
    p = __fadd_rn(p, __fmul_rn(neg_lr, u));
  }
};

__device__ __forceinline__ void scalar_range(float* p, const float* g, float* m, float* v,
                                             int64_t a, int64_t b, const AdamW& op) {
  for (int64_t i = a + threadIdx.x; i < b; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    op.apply(pi, g[i], mi, vi);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

// Elements [a, b) of one tensor, shared by the block's threads.
__device__ __forceinline__ void update_range(float* p, const float* g, float* m, float* v,
                                             int64_t a, int64_t b, const AdamW& op) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  int64_t vs = b, ve = b;                        // vector body [vs, ve)
  if ((bits & 15) == 0) {
    vs = min(b, (a + 3) & ~int64_t(3));
    ve = vs + (b - vs) / 4 * 4;
  }
  scalar_range(p, g, m, v, a, vs, op);
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (int64_t j = vs / 4 + threadIdx.x; j < ve / 4; j += kThreads) {
    float4 pp = p4[j], mm = m4[j], vv = v4[j];
    const float4 gg = g4[j];
    op.apply(pp.x, gg.x, mm.x, vv.x);
    op.apply(pp.y, gg.y, mm.y, vv.y);
    op.apply(pp.z, gg.z, mm.z, vv.z);
    op.apply(pp.w, gg.w, mm.w, vv.w);
    p4[j] = pp;
    m4[j] = mm;
    v4[j] = vv;
  }
  scalar_range(p, g, m, v, ve, b, op);
}

__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const int64_t* __restrict__ table, int n, AdamW op) {
  const int64_t* off = table + 4 * n;
  int64_t lo = int64_t(blockIdx.x) * kSpan;
  const int64_t hi = min(lo + kSpan, off[n]);
  // The tensor holding element lo: the first j with off[j] > lo, minus one
  // (empty tensors are skipped, as off[j] == off[j + 1] for them).
  int j0 = 1, j1 = n;
  while (j0 < j1) {
    const int mid = (j0 + j1) / 2;
    if (off[mid] > lo) j1 = mid; else j0 = mid + 1;
  }
  for (int i = j0 - 1; lo < hi; ++i) {
    const int64_t end = min(hi, off[i + 1]);
    update_range(reinterpret_cast<float*>(table[i]),
                 reinterpret_cast<const float*>(table[n + i]),
                 reinterpret_cast<float*>(table[2 * n + i]),
                 reinterpret_cast<float*>(table[3 * n + i]),
                 lo - off[i], end - off[i], op);
    lo = end;
  }
}

}  // namespace
}  // namespace clipcap

extern "C" int clipcap_fused_adamw(const void* table, int n, long long total, float lr,
                                   float b1, float b2, float eps, float wd, float bc1,
                                   float bc2, void* stream) {
  using namespace clipcap;
  if (total <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const AdamW op{-lr, b1, 1.f - b1, b2, 1.f - b2, eps, wd, bc1, bc2};
  const unsigned blocks = static_cast<unsigned>((total + kSpan - 1) / kSpan);
  fused_adamw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), n, op);
  return static_cast<int>(cudaGetLastError());
}
