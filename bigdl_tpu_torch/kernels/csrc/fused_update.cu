// Fused optimizer update (Adam, AdamW, SGD with or without momentum) over
// a list of fp32 leaves, in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel bigdl_tpu/kernels/fused_update.py::_fused_kernel
// (its pallas_call in _pallas_flat). Same function, per element of every
// leaf, in the reference's `_math` order:
//   adam:  g' = g (+ wd*p);  m' = b1*m + (1-b1)*g';  v' = b2*v + (1-b2)*(g'*g')
//          p' = p - (lr*(m'/bc1)) / (sqrt(v'/bc2) + eps)
//   adamw: the same without the g' decay, then p' = p' - (lr*wd)*p
//   sgd:   g' = g (+ wd*p);  plain p' = p - lr*g'
//          momentum v' = mu*v + (1-damp)*g'; p' = p - lr*(nesterov ? g'+mu*v' : v')
// Every product, sum, quotient and square root is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which
// nvcc never contracts into an FMA: each operation rounds once, as torch's
// op-by-op plain version does, so the two agree bit for bit. The scalar
// constants arrive already rounded to fp32 (and lr*wd as torch's fp32
// product), computed on the host as the plain version rounds them.
//
// What bounds it on an H100: nothing but bytes. Adam reads p, g, m, v and
// writes p, m, v: 28 bytes per parameter, 3.6 GB for the 125M LLaMA's
// 128,404,224 parameters, 1.07 ms at 3.35 TB/s; ~15 fp32 operations per
// element are 0.03 ms at 67 TFLOP/s.
//
// Design, and what it does about the TPU form:
//  * The TPU kernel walked one concatenated, lane-padded stream, built by
//    a concat before the call and split after it. Here the leaves stay
//    where they are: the wrapper passes a device table of
//    (p, g, slot0, slot1, n, first block) rows, and block b takes the leaf
//    whose first block is the last one <= b (a binary search of the
//    table) and the CHUNK-element chunk b - first of it. No copy of the
//    state is made; params and slots are updated in place, as the
//    reference's input_output_aliases did.
//  * Each thread moves 16-byte vectors (float4) when all of a leaf's
//    pointers are 16-byte aligned, with a scalar loop for the ragged end
//    of a leaf and for unaligned leaves.
//  * The state is read once and written once; nothing is staged in shared
//    memory, as nothing is reused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CHUNK = 4096;          // elements per block (= 4 float4 a thread)
constexpr int KIND_ADAM = 0, KIND_ADAMW = 1, KIND_SGD = 2;

struct Consts {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd, lrwd, mu, omdamp;
};

struct Leaf {            // one row of the table, as the wrapper writes it
  long long p, g, s0, s1, n, first;
};

template <int KIND>
__device__ __forceinline__ void update_one(float& p, float g, float& s0,
                                           float& s1, const Consts& c,
                                           int n_slots, bool has_wd,
                                           bool nesterov) {
  if (KIND == KIND_SGD) {
    if (has_wd) g = __fadd_rn(g, __fmul_rn(c.wd, p));
    if (n_slots == 0) {
      p = __fsub_rn(p, __fmul_rn(c.lr, g));
      return;
    }
    s0 = __fadd_rn(__fmul_rn(c.mu, s0), __fmul_rn(c.omdamp, g));
    const float upd = nesterov ? __fadd_rn(g, __fmul_rn(c.mu, s0)) : s0;
    p = __fsub_rn(p, __fmul_rn(c.lr, upd));
    return;
  }
  if (KIND == KIND_ADAM && has_wd) g = __fadd_rn(g, __fmul_rn(c.wd, p));
  s0 = __fadd_rn(__fmul_rn(c.b1, s0), __fmul_rn(c.omb1, g));
  s1 = __fadd_rn(__fmul_rn(c.b2, s1), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(c.lr, __fdiv_rn(s0, c.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(s1, c.bc2)), c.eps);
  float pn = __fsub_rn(p, __fdiv_rn(num, den));
  if (KIND == KIND_ADAMW && has_wd) pn = __fsub_rn(pn, __fmul_rn(c.lrwd, p));
  p = pn;
}

template <int KIND>
__global__ void __launch_bounds__(NTHREADS)
fused_update_kernel(const Leaf* __restrict__ table, int n_leaves, Consts c,
                    int n_slots, int nesterov) {
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;          // last leaf with first <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf leaf = table[lo];
  float* __restrict__ p = reinterpret_cast<float*>(leaf.p);
  const float* __restrict__ g = reinterpret_cast<const float*>(leaf.g);
  float* __restrict__ s0 = reinterpret_cast<float*>(leaf.s0);
  float* __restrict__ s1 = reinterpret_cast<float*>(leaf.s1);
  const long long start = (b - leaf.first) * CHUNK;
  const long long end = min(start + (long long)CHUNK, leaf.n);
  const bool has_wd = c.wd != 0.0f;
  const bool nest = nesterov != 0;
  float dummy0 = 0.0f, dummy1 = 0.0f;

  const bool aligned =
      ((leaf.p | leaf.g | (n_slots > 0 ? leaf.s0 : 0) |
        (n_slots > 1 ? leaf.s1 : 0)) & 15) == 0;
  long long i = start + 4LL * threadIdx.x;
  if (aligned) {
    for (; i + 3 < end; i += 4LL * NTHREADS) {
      float4 pv = *reinterpret_cast<float4*>(p + i);
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      float4 av = n_slots > 0 ? *reinterpret_cast<float4*>(s0 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 bv = n_slots > 1 ? *reinterpret_cast<float4*>(s1 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      update_one<KIND>(pv.x, gv.x, av.x, bv.x, c, n_slots, has_wd, nest);
      update_one<KIND>(pv.y, gv.y, av.y, bv.y, c, n_slots, has_wd, nest);
      update_one<KIND>(pv.z, gv.z, av.z, bv.z, c, n_slots, has_wd, nest);
      update_one<KIND>(pv.w, gv.w, av.w, bv.w, c, n_slots, has_wd, nest);
      *reinterpret_cast<float4*>(p + i) = pv;
      if (n_slots > 0) *reinterpret_cast<float4*>(s0 + i) = av;
      if (n_slots > 1) *reinterpret_cast<float4*>(s1 + i) = bv;
    }
    // the ragged end: fewer than 4 elements left for this thread's vector
    if (i < end) {
      for (long long j = i; j < end && j < i + 4; ++j) {
        float& a = n_slots > 0 ? s0[j] : dummy0;
        float& bb = n_slots > 1 ? s1[j] : dummy1;
        update_one<KIND>(p[j], g[j], a, bb, c, n_slots, has_wd, nest);
      }
    }
    return;
  }
  for (long long j = start + threadIdx.x; j < end; j += NTHREADS) {
    float& a = n_slots > 0 ? s0[j] : dummy0;
    float& bb = n_slots > 1 ? s1[j] : dummy1;
    update_one<KIND>(p[j], g[j], a, bb, c, n_slots, has_wd, nest);
  }
}

}  // namespace

// table: n_leaves rows of 6 int64 (p, g, slot0, slot1, n, first block),
// rows ordered by first block, every leaf with n >= 0 fp32 elements on CUDA
// device `device`; n_blocks = sum of ceil(n / 4096). kind: 0 adam, 1 adamw,
// 2 sgd; n_slots: 2 for adam/adamw, 1 for sgd with momentum, 0 without.
// The 12 scalars are the fp32 constants of Consts in order. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int bigdl_fused_update_f32(
    const void* table, int n_leaves, long long n_blocks, int kind, int n_slots,
    int nesterov, float lr, float bc1, float bc2, float b1, float omb1,
    float b2, float omb2, float eps, float wd, float lrwd, float mu,
    float omdamp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks <= 0) return 0;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const Consts c{lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd, lrwd, mu, omdamp};
  auto t = static_cast<const Leaf*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_blocks);
  switch (kind) {
    case KIND_ADAM:
      fused_update_kernel<KIND_ADAM><<<grid, NTHREADS, 0, s>>>(
          t, n_leaves, c, n_slots, nesterov);
      break;
    case KIND_ADAMW:
      fused_update_kernel<KIND_ADAMW><<<grid, NTHREADS, 0, s>>>(
          t, n_leaves, c, n_slots, nesterov);
      break;
    case KIND_SGD:
      fused_update_kernel<KIND_SGD><<<grid, NTHREADS, 0, s>>>(
          t, n_leaves, c, n_slots, nesterov);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
