// Flash-attention forward in fp32 for Hopper (sm_90a), on the tensor
// cores in 3xTF32.
//
// Replaces the TPU kernel bigdl_tpu/kernels/flash_attention.py::_fa_kernel
// (its pallas_call in _flash_fwd). Same function: softmax(q k^T * scale) v
// with an online softmax whose running max, running sum and accumulator
// stay in fp32; causal masking is bottom-right aligned
// (q_offset = Tk - Tq); masked logits take the finite NEG_INF = -1e30 and
// the output is acc / max(l, 1e-30), so a row that sees no key yields 0.
// Any head dim d >= 1.
//
// What bounds it on an H100: the bytes are q, k, v read once and o
// written once (at B=8, H=12, T=512, d=64: 50 MB, 15 us at 3.35 TB/s);
// the work is 4*Tq*Tk*d flops halved by causality (3.2 GFLOP). At fp32
// accuracy on the tensor cores (3xTF32, three TF32 products per fp32
// product, 494.7 TFLOP/s) that is 20 us, so it is bound by its
// operations.
//
// Design, and what it does about the TPU form:
//  * The TPU walked K blocks as a sequential grid axis with the softmax
//    state in VMEM scratch across grid steps. Blocks on a GPU run in no
//    order, so one block owns a (batch*head, 64-row query tile) and walks
//    every K/V tile itself; its 4 warps own 16 query rows each, with the
//    running max and sum and the O fragments in registers for the whole
//    walk. The query tiles with the most causal work launch first.
//  * Both products are mma.sync m16n8k8 TF32 MMAs in CUTLASS's FastF32
//    split (tf32x3.cuh, shared with cut_cross_entropy.cu's K3b and
//    K3c): a = hi + lo with hi = a rounded toward zero to TF32 and lo =
//    the rest rounded to nearest, a b ~ hi hi' + hi lo' + lo hi'. A
//    single TF32 product misses the fp32 tolerance (chip_smoke.py and
//    tests/test_torch_kernels.py check both). K row-major is the ".col"
//    B operand of S = Q K^T as it lies; the Q tile is stored pre-split
//    once a block (hi + lo is exact in fp32), so its fragments split in
//    two operations.
//  * P stays in registers: the S accumulator gives a lane the keys
//    (2t, 2t + 1) of its rows, where the A operand of O += P V wants
//    (t, t + 4). The keys of each 8-key step are relabelled instead of
//    moved: the lane loads V's B fragment from key rows 2t and 2t + 1.
//  * The tensor cores' fp32 accumulation truncates. So each key tile's
//    P V product is summed from zero in fresh fragments and then added
//    as acc = acc * alpha + tile in fp32, and S is summed from zero over
//    each 64 columns of d and added in fp32.
//  * K and V tiles are copied by cp.async, zero-filled past Tk and past
//    d (no padded copy in device memory, which the Pallas wrapper made):
//    V while S is computed, the next K while P V is. Rows are padded to
//    a stride of 4 mod 32 words, so the ldmatrix loads of Q and K along
//    d and the single loads of V across its rows are free of bank
//    conflicts.
//  * The walk stops at the causal diagonal: tiles wholly above it are
//    never loaded. Only tiles that the diagonal or the Tk edge crosses
//    are masked.
//  * Bodies by shape: d <= 64 and d <= 128 keep the Q tile resident and
//    O whole in registers. Past 128, S is summed over 128-column slices
//    of Q and K staged in turn (double-buffered), and O's columns are
//    cut into 128-wide chunks over a grid axis, each block recomputing S
//    for its chunk.
//  * Sums are fp32 and in a fixed order; exp is the accurate expf (no
//    fast math). Nothing reads PyTorch's TF32 switches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int NW = 4;           // warps a block, 16 query rows each
constexpr int NTH = 32 * NW;    // threads a block
constexpr int BQ = 16 * NW;     // query rows a block
constexpr int BK = 64;          // keys a tile
constexpr float NEG_INF = -1e30f;

// DP: columns of d a slice holds (the whole d when WHOLE); STR: the row
// stride of a tile in shared memory, 4 mod 32 words; RING: Q/K slices in
// flight.
template <int DP, bool WHOLE>
struct Body {
  static constexpr int STR = DP + 4;
  static constexpr int RING = WHOLE ? 1 : 2;
  static constexpr int SMEM_BYTES = (RING * (BQ + BK) + BK) * STR * 4;
};

// The block's copy of ROWS x DP: rows [r0, r0 + ROWS) of src (`rows` x d
// row-major), columns [c0, c0 + DP), into dst at stride DP + 4; zeros
// past `rows` and d. `vec`: d % 4 == 0 and src 16-byte aligned.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int c0, int d,
                                          bool vec, int tid) {
  constexpr int STR = DP + 4;
  if (vec) {
    constexpr int CPR = DP / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * CPR; i += NTH) {
      const int r = i / CPR, c = 4 * (i % CPR);
      const bool ok = r0 + r < rows && c0 + c < d;
      cp16(dst + r * STR + c,
           ok ? src + (size_t)(r0 + r) * d + c0 + c : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NTH) {
      const int r = i / DP, c = i % DP;
      const bool ok = r0 + r < rows && c0 + c < d;
      cp4(dst + r * STR + c,
          ok ? src + (size_t)(r0 + r) * d + c0 + c : src, ok);
    }
  }
}

// Block (batch*head x, query tile y, column chunk z): rows [q0, q0 + BQ)
// and columns [z DP, z DP + DP) of o.
template <int DP, bool WHOLE>
__global__ void __launch_bounds__(NTH)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int tq, int tk, int d, float scale, int causal) {
  using B = Body<DP, WHOLE>;
  constexpr int STR = B::STR, RING = B::RING;
  constexpr int NO = DP / 8;     // O fragments a warp: 8 columns each
  constexpr int NS = BK / 8;     // S fragments a warp: 8 keys each
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [RING][BQ][STR]
  float* ks = qs + RING * BQ * STR;       // [RING][BK][STR]
  float* vs = ks + RING * BK * STR;       // [BK][STR], columns of the chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane >> 2, lc = lane & 3;   // fragment row, column
  // the row and column offsets this lane addresses for ldsm4: in an A
  // fragment (16 x 8), and in two B fragments (8 + 8 rows x 8)
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 4 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 4 * ((lane >> 3) & 1);
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int c0 = blockIdx.z * DP;
  const float* qb = q + bh * tq * d;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const int q_offset = tk - tq;
  const int nsl = WHOLE ? 1 : (d + DP - 1) / DP;
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    // the last key any valid row of this tile may see
    const int last_key = q_offset + min(q0 + BQ, tq) - 1;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }

  // Q/K slice (tile t, slice sl) into ring slot `issued % RING`
  int issued = 0, used = 0;
  if (WHOLE) load_tile<BQ, DP>(qs, qb, q0, tq, 0, d, vec, tid);
  if (n_tiles > 0) {
    if (!WHOLE) load_tile<BQ, DP>(qs, qb, q0, tq, 0, d, vec, tid);
    load_tile<BK, DP>(ks, kb, 0, tk, 0, d, vec, tid);
    ++issued;
  }
  cp_commit();
  if (WHOLE) {
    // the Q tile serves every key tile: store it pre-split once
    cp_wait<0>();
    __syncthreads();
    for (int i = tid; i < BQ * DP; i += NTH) {
      float& x = qs[(i / DP) * STR + i % DP];
      x = presplit(x);
    }
    __syncthreads();
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int wq0 = q0 + 16 * warp;          // this warp's first query row
  const int dc = min(DP, d - c0);          // real columns of the chunk

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // S = Q K^T, slice by slice; the V tile is copied during the last
    for (int sl = 0; sl < nsl; ++sl) {
      if (sl + 1 < nsl) {
        const int slot = issued++ % RING;
        load_tile<BQ, DP>(qs + slot * BQ * STR, qb, q0, tq, (sl + 1) * DP, d,
                          vec, tid);
        load_tile<BK, DP>(ks + slot * BK * STR, kb, k0, tk, (sl + 1) * DP, d,
                          vec, tid);
      } else {
        load_tile<BK, DP>(vs, vb, k0, tk, c0, d, vec, tid);
      }
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const int slot = used++ % RING;
      const float* qt = qs + slot * BQ * STR + (16 * warp + ar) * STR + ac;
      const float* kt = ks + slot * BK * STR + br * STR + bc;
      const int dl = min(DP, d - sl * DP);   // real columns of the slice
#pragma unroll
      for (int kc = 0; kc < DP; kc += 64) {
        if (kc < dl) {
          float sp[NS][4];
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
#pragma unroll 2
          for (int kk = kc; kk < kc + 64; kk += 8) {
            if (kk < dl) {
              uint32_t x[4], ah[4], al[4];
              ldsm4(qt + kk, x);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (WHOLE)
                  split_exact(__uint_as_float(x[e]), ah[e], al[e]);
                else
                  split(__uint_as_float(x[e]), ah[e], al[e]);
              }
#pragma unroll
              for (int np = 0; np < NS / 2; ++np) {
                uint32_t y[4];   // b0, b1 of key tile 2 np, then 2 np + 1
                ldsm4(kt + 16 * np * STR + kk, y);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  uint32_t bh0, bl0, bh1, bl1;
                  split(__uint_as_float(y[2 * e]), bh0, bl0);
                  split(__uint_as_float(y[2 * e + 1]), bh1, bl1);
                  mma3(sp[2 * np + e], ah, al, bh0, bh1, bl0, bl1);
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += sp[j][e];
        }
      }
      __syncthreads();
    }

    // the online softmax of this lane's rows lr (h = 0) and lr + 8 (h =
    // 1); the four lanes of a quad share a row
    const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > q_offset + wq0);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q_offset + wq0 + lr + 8 * h;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * h + e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * lc + e;
            if (kpos >= tk || (causal && kpos > qpos)) x = NEG_INF;
          }
          s[j][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a row that has seen only masked keys keeps p = 0
          const float p = mn == NEG_INF ? 0.f : expf(s[j][2 * h + e] - mn);
          s[j][2 * h + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha[h] + sum;
      m[h] = mn;
    }

    // the next tile's first Q/K slice, copied during P V
    if (t + 1 < n_tiles) {
      const int slot = issued++ % RING;
      if (!WHOLE)
        load_tile<BQ, DP>(qs + slot * BQ * STR, qb, q0, tq, 0, d, vec, tid);
      load_tile<BK, DP>(ks + slot * BK * STR, kb, k0 + BK, tk, 0, d, vec,
                        tid);
    }
    cp_commit();

    // P as the A operand of P V, keys relabelled: A column t is key 2t
    // and column t + 4 is key 2t + 1 of each 8-key step
    uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);   // (row lr, key 2t)
      split(s[j][2], ph[j][1], pl[j][1]);   // (row lr + 8, key 2t)
      split(s[j][1], ph[j][2], pl[j][2]);   // (row lr, key 2t + 1)
      split(s[j][3], ph[j][3], pl[j][3]);   // (row lr + 8, key 2t + 1)
    }
    cp_wait<1>();
    __syncthreads();
    // acc = acc * alpha + P V, 4 fragments (32 columns) at a time, each
    // summed from zero over the tile's keys
    const float* vt = vs + 2 * lc * STR + lr;
#pragma unroll
    for (int ng = 0; ng < NO; ng += 4) {
      if (8 * ng < dc) {
        float tmp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* v0 = vt + 8 * j * STR + 8 * ng;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh0, bl0, bh1, bl1;
            split(v0[8 * i], bh0, bl0);          // key 8j + 2t
            split(v0[STR + 8 * i], bh1, bl1);    // key 8j + 2t + 1
            mma3(tmp[i], ph[j], pl[j], bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[ng + i][e] = acc[ng + i][e] * alpha[e >> 1] + tmp[i][e];
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  float* ob = o + bh * tq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wq0 + lr + 8 * h;
    if (row < tq) {
      const float den = fmaxf(l[h], 1e-30f);
      float* orow = ob + (size_t)row * d;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = c0 + 8 * j + 2 * lc;
        if (col < d) orow[col] = acc[j][2 * h] / den;
        if (col + 1 < d) orow[col + 1] = acc[j][2 * h + 1] / den;
      }
    }
  }
}

template <int DP, bool WHOLE, typename F>
cudaError_t call(F&& f) {
  return f(flash_fwd_kernel<DP, WHOLE>, Body<DP, WHOLE>::SMEM_BYTES, DP);
}

// f(kernel, dynamic shared bytes, columns a chunk) of the body for d:
// d <= 64 and d <= 128 whole, past 128 in 128-column slices and chunks.
template <typename F>
cudaError_t with_body(int d, F&& f) {
  if (d <= 64) return call<64, true>(f);
  if (d <= 128) return call<128, true>(f);
  return call<128, false>(f);
}

}  // namespace

// q: (bh, tq, d), k/v: (bh, tk, d), o: (bh, tq, d), all contiguous fp32
// on CUDA device `device`; d >= 1, tq <= 65535 * 64. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int bigdl_flash_attention_fwd_f32(const void* q, const void* k,
                                             const void* v, void* o, int bh,
                                             int tq, int tk, int d,
                                             float scale, int causal,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || bh < 1 || tq < 1 || tk < 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)with_body(d, [&](auto kernel, int smem, int dp) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid(bh, (tq + BQ - 1) / BQ, (d + dp - 1) / dp);
    kernel<<<grid, NTH, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), tq, tk, d,
        scale, causal);
    return cudaGetLastError();
  });
}

// What the body for d uses: registers and local (spilled) bytes a
// thread, dynamic shared memory bytes a block, and the columns of d a
// slice holds.
extern "C" int bigdl_flash_attention_usage(int d, int* regs,
                                           int* local_bytes, int* smem_bytes,
                                           int* cols) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  return (int)with_body(d, [&](auto kernel, int smem, int dp) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = smem;
    *cols = dp;
    return cudaSuccess;
  });
}
