// Cut cross-entropy in fp32 for Hopper (sm_90a): the LM loss of a tied
// head without the (N, V) logits in device memory.
//
// Replaces the three TPU kernels of bigdl_tpu/kernels/cut_cross_entropy.py:
//   K3a _lse_kernel  lse[n]  = log sum_v exp(h[n] . w[v])
//   K3b _dh_kernel   dh[n]   = sum_v exp(h[n] . w[v] - lse[n]) g[n] w[v]
//   K3c _dw_kernel   dw[v]   = sum_n exp(h[n] . w[v] - lse[n]) g[n] h[n]
// with h (N, D), w (V, D), lse and g (N,), all fp32 and row-major. The
// label terms (the gather-dot, -g w[labels] and the scatter-add into dw)
// stay outside, in PyTorch, as in the reference.
//
// What bounds them on an H100: at N = 2048, D = 768, V = 50257 a K3a
// launch does 2 N V D = 158 GFLOP and K3b and K3c twice that each, while
// the bytes are h and w read once (160 MB) and the outputs written once:
// they are bound by their operations. At fp32 accuracy on the tensor
// cores (3xTF32, three TF32 products per fp32 product, 494.7 TFLOP/s)
// that is 0.96, 1.92 and 1.92 ms; with fp32 FMAs outside them (67
// TFLOP/s), 2.36, 4.72 and 4.72 ms.
//
// All three run on the tensor cores (K3b and K3c one body with the roles
// of h and w swapped): every product is mma.sync m16n8k8 TF32 MMAs in
// the error-compensated split CUTLASS calls OpMultiplyAddFastF32: a =
// hi + lo with hi = a rounded toward zero to TF32 and lo = the rest
// rounded to nearest, a b ~ hi hi' + hi lo' + lo hi'. That keeps dh and
// dw within a few 1e-6 of their fp32 values where a single TF32 product
// moves them by ~4e-4, and lse within ~1e-7 where one moves it by ~5e-6
// (chip_smoke.py and tests/test_torch_kernels.py check both). The three
// MMAs for one are what holds them back: with one TF32 MMA in their
// place dh and dw take 3.49 and 3.63 ms at the shape above where they
// take 6.14 and 6.02 (tools/dh_breakdown.py, H100 80GB HBM3 at 700 W);
// wgmma is the step past mma.sync's rate. Any D >= 1 runs: K3a streams
// D, and K3b and K3c past 1024 columns take a body that cuts D.
//
// Design, and what it does about the TPU form:
//  * The Pallas kernels jnp.pad w to a multiple of the vocab block on
//    every call (a 154 MB copy at V = 50257). Here every copy into shared
//    memory is a cp.async whose source size is 0 past the last row or
//    column, which fills zeros; a vocab column past V gets no logit in
//    K3a and a zero probability in K3b and K3c, and a row past N gets a
//    zero probability.
//  * The Pallas grid walks the vocab sequentially inside one row tile,
//    with the running max and sum (or the dh accumulator) in VMEM. GPU
//    blocks run in no order, so K3a and K3b split the vocab walk into
//    `splits` chunks, one block per (row tile, chunk); each writes its
//    partial (max, sum) or partial dh, and a second small kernel merges
//    the chunks in index order, so the result does not depend on how the
//    blocks were scheduled. K3c has one block per 32-row vocab tile
//    (1571 at V = 50257, 12 waves of one block per SM), each walking all
//    N rows in order; it needs no merge.
//  * K3b (cce_grad_kernel, as owner h and walker w): a block owns 32 h
//    rows (16 when D > 768) and
//    their dh in registers, 2 x 12 MMA tiles a thread at D = 768 (96
//    floats); the register file, not shared memory, fixes that height.
//    The h rows stay in shared memory, and a 32-row vocab tile of w sits
//    there whole (96 KB at D = 768), so w is read once per tile for both
//    products. Each of the 8 warps owns D / 8 columns: it computes its
//    share of S = h w^T over those columns, and later dh += P w for those
//    columns, so it copies (cp.async) and waits for its own columns
//    only. The eight partial S tiles are summed in warp order, P =
//    exp(S - lse) g is written split into hi and lo, and as the P w
//    product finishes each 8 rows of the w tile, the warp starts copying
//    the next tile's 8 rows into them. The 16-byte chunks of a row are
//    XOR-swizzled by row so the fragment loads of both products (w read
//    along D, then across its rows) are free of bank conflicts. ldmatrix
//    loads the fragments of h, of P and of w along D (four 16-byte rows
//    of fp32 are the TF32 fragment layout); w across its rows takes
//    single loads. The h rows are stored pre-split once (hi + lo, exact
//    in fp32), so their fragments split in two operations; w's split in
//    four as they load.
//    The tensor cores' fp32 accumulation truncates, so each tile's
//    P w product is summed from zero (12 MMAs) and added to the
//    long-lived dh in fp32: accumulated over a whole vocab chunk in the
//    MMAs, dh drifted by ~1.6e-4 of its largest value. Each warp's share
//    of S is likewise summed 32 columns of D at a time and added in fp32.
//  * K3c (the same body, as owner w and walker h): a block owns 32 w
//    rows and their dw, walks 32-row tiles of h, and takes lse and g of
//    each probability from its walker (h) row instead of its owner row.
//    Everything else, per-tile promotion included, is K3b's.
//  * K3a (lse::cce_lse_kernel) is a GEMM tile with an online-logsumexp
//    epilogue: a block computes S for 128 h rows x 128 vocab rows, 8
//    warps of 64 x 32, and walks the vocab tiles of its chunk. Both
//    operands stream over D in 64-deep slices through a ring of three
//    cp.async stages (zero fill past N, V and D; 192 KB), so no buffer
//    holds a whole row and nothing caps D; a resident pre-split h tile
//    would not fit (128 rows x 768 x 2 parts is 786 KB), and h (6.3 MB
//    at the path's shape) is re-read from L2. The 16-byte chunks of a
//    slice's rows are XOR-swizzled by row, so the ldmatrix loads of both
//    operands are free of bank conflicts; both split as they load. The
//    product of each 32 columns is summed from zero in the MMAs and
//    added to S in fp32 (summed over all of D in the MMAs, S moved lse
//    by 5.7e-07 of its largest value from float64; promoted, 1.0e-07).
//    Once per vocab tile, columns past V go to -inf, each thread takes
//    the max of its 8 columns for each of its 8 rows, the quad shares it
//    through __shfl_xor_sync, and the running (max, sum) of each row is
//    updated in registers; at the end the quad adds its sums and the
//    four warps that share rows merge through shared memory in warp
//    order. Row tiles are the grid's fastest axis, so the row tiles
//    that share a chunk of w run in one wave and w (154 MB, beyond the 50
//    MB L2) comes from device memory about once.
//  * K3b and K3c past D = 1024 (tc::cce_grad_wide_kernel): the register
//    file holds at most 1024 columns of a 16-row gradient, and a 32-row
//    walker tile of 2048 columns (256 KB) is more than a block's shared
//    memory. A grid axis cuts the gradient into 1024-column chunks; each
//    block computes S over all of D, copying D's chunks in turn, and
//    accumulates only its own chunk of dh or dw.
//  * Sums are fp32 and in a fixed order; exp and log are the accurate
//    expf/logf (no fast math). Nothing reads PyTorch's TF32 switches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// K3a on the tensor cores (see the head note): a GEMM tile of BM h rows
// x BN vocab rows, 8 warps of WM x WN, both operands streamed over D in
// BK-deep slices through a ring of STAGES cp.async stages, S promoted
// every PK columns.
namespace lse {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int PK = 32;                       // S promoted every PK columns
constexpr int WM = 64, WN = 32;              // a warp's tile of S
constexpr int MT = WM / 16, NT = WN / 8;     // its MMA tiles
constexpr int WARPS_N = BN / WN;
constexpr int NTH = 32 * (BM / WM) * WARPS_N;
constexpr int STAGE = (BM + BN) * BK;        // floats a stage
constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(float);

// Index of (r, c) in a [rows][BK] slice: the 16-byte chunks of a row are
// XOR-swizzled by r % 8, so that ldmatrix's eight 16-byte rows (eight
// consecutive r, one chunk) touch 32 distinct banks.
__device__ __forceinline__ int sw(int r, int c) {
  return r * BK + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Copy columns [k0, k0 + BK) of rows [g0, g0 + ROWS) of src (n x d,
// row-major) into dst; zeros past n and d. `vec`: d % 4 == 0 and src
// 16-byte aligned.
template <int ROWS>
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int g0, int n, int k0, int d,
                                           bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * BK / 4 / NTH; ++i) {
      const int q = tid + NTH * i, r = q / (BK / 4), c = 4 * (q % (BK / 4));
      const bool ok = g0 + r < n && k0 + c < d;
      cp16(dst + sw(r, c), ok ? src + (size_t)(g0 + r) * d + k0 + c : src,
           ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * BK / NTH; ++i) {
      const int q = tid + NTH * i, r = q / BK, c = q % BK;
      const bool ok = g0 + r < n && k0 + c < d;
      cp4(dst + sw(r, c), ok ? src + (size_t)(g0 + r) * d + k0 + c : src,
          ok);
    }
  }
}

// Block (row tile x, vocab chunk y): the running (max, sum) of exp(h . w)
// over the chunk's vocab tiles for each of its rows -> pm, ps [y][n].
__global__ void __launch_bounds__(NTH, 1)
cce_lse_kernel(const float* __restrict__ h, const float* __restrict__ w,
               float* __restrict__ pm, float* __restrict__ ps, int n, int v,
               int d) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gq = lane >> 2, tq = lane & 3;
  // the row and column offsets this lane addresses for ldsm4: in an A
  // fragment (16 x 8), and in two B fragments (8 + 8 rows x 8)
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 4 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 4 * ((lane >> 3) & 1);
  const int o0 = blockIdx.x * BM;
  const int tiles = (v + BN - 1) / BN;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int nks = (d + BK - 1) / BK;
  const int total = (t1 - t0) * nks;   // slices: nks for each vocab tile
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;

  // slice `it` (vocab tile t0 + it / nks, columns (it % nks) BK on) goes
  // to stage it % STAGES
  auto issue = [&](int it) {
    float* st = smem + (it % STAGES) * STAGE;
    const int j0 = (t0 + it / nks) * BN, k0 = (it % nks) * BK;
    load_slice<BM>(st, h, o0, n, k0, d, vec, tid);
    load_slice<BN>(st + BM * BK, w, j0, v, k0, d, vec, tid);
  };

  // running max and sum of rows 16 mt + gq + 8 hf of the warp's tile,
  // over this thread's columns (the max is shared by the quad)
  float m[MT][2], sum[MT][2];
  float s[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) { m[mt][hf] = NEG_INF; sum[mt][hf] = 0.f; }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[mt][nt][q] = 0.f;
  }

#pragma unroll 1
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < total) issue(it);
    cp_commit();
  }
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // slice it landed; every warp is past slice it - 1
    if (it + STAGES - 1 < total) issue(it + STAGES - 1);
    cp_commit();
    const float* as = smem + (it % STAGES) * STAGE + wm * WM * BK;
    const float* bs = smem + (it % STAGES) * STAGE + BM * BK + wn * WN * BK;
    // each PK columns' product, summed from zero in the MMAs (the tensor
    // cores' fp32 accumulation truncates) and added to S in fp32
#pragma unroll 1
    for (int k0 = 0; k0 < BK; k0 += PK) {
      float sk[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) sk[mt][nt][q] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + PK; kk += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t x[4];
          ldsm4(as + sw(16 * mt + ar, kk + ac), x);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split(__uint_as_float(x[q]), ah[mt][q], al[mt][q]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t y[4];   // b0, b1 of MMA column tile 2 np, then 2 np + 1
          ldsm4(bs + sw(16 * np + br, kk + bc), y);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t bh0, bl0, bh1, bl1;
            split(__uint_as_float(y[2 * e]), bh0, bl0);
            split(__uint_as_float(y[2 * e + 1]), bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3(sk[mt][2 * np + e], ah[mt], al[mt], bh0, bh1, bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[mt][nt][q] += sk[mt][nt][q];
    }
    if ((it + 1) % nks) continue;
    // the vocab tile's last slice: fold its S into the running (max, sum)
    // of each row, columns past v at -inf
    const int jw = (t0 + it / nks) * BN + wn * WN + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float tm = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            if (jw + 8 * nt + e >= v) x = NEG_INF;
            tm = fmaxf(tm, x);
          }
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        if (tm > NEG_INF) {   // the same for the whole warp: a real column
          const float mn = fmaxf(m[mt][hf], tm);
          float add = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) add += expf(s[mt][nt][2 * hf + e] - mn);
          sum[mt][hf] = sum[mt][hf] * expf(m[mt][hf] - mn) + add;
          m[mt][hf] = mn;
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[mt][nt][q] = 0.f;
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' (max, sum)
  // the quad shares its max: add its sums, then merge the WARPS_N warps
  // that hold the same rows in warp order
  float* red = smem;   // [WARPS_N][BM][2]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = sum[mt][hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (tq == 0) {
        const int r = wm * WM + 16 * mt + gq + 8 * hf;
        red[2 * (wn * BM + r)] = m[mt][hf];
        red[2 * (wn * BM + r) + 1] = x;
      }
    }
  __syncthreads();
  if (tid < BM && o0 + tid < n) {
    float mm = NEG_INF, ss = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS_N; ++q)
      merge(mm, ss, red[2 * (q * BM + tid)], red[2 * (q * BM + tid) + 1]);
    pm[(size_t)blockIdx.y * n + o0 + tid] = mm;
    ps[(size_t)blockIdx.y * n + o0 + tid] = ss;
  }
}

}  // namespace lse

// K3a, second pass: merge the chunks of each row in chunk order.
__global__ void cce_lse_merge(const float* __restrict__ pm,
                              const float* __restrict__ ps,
                              float* __restrict__ lse, int n, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float m = NEG_INF, s = 0.f;
  for (int c = 0; c < splits; ++c)
    merge(m, s, pm[(size_t)c * n + r], ps[(size_t)c * n + r]);
  lse[r] = m + logf(fmaxf(s, 1e-30f));
}

// K3b and K3c on the tensor cores (see the head note): one body, an
// "owner" tile of rows with its gradient in registers walking tiles of
// the "walker" rows. K3b: owner h, walker w; K3c: owner w, walker h. The
// tile geometry: a block owns BO = 16 MT owner rows; each of its NW warps
// owns DW = 8 NTW columns of D, padded to DP = NW DW; a walker tile is BV
// rows.
namespace tc {

constexpr int NW = 8;           // warps a block
constexpr int NTH = 32 * NW;    // threads a block
constexpr int BV = 32;          // walker rows a tile
constexpr int PS = 32;          // row stride of an S or P tile (BV)
constexpr int SK = 4;           // 8-deep steps of S summed in the MMAs

// Index of (r, c) in a [rows][DP] tile of owner or walker rows: the
// 16-byte chunks of a row are XOR-swizzled by f(r), a permutation of
// r % 8, so that both
// the reads along a row (fragment rows g, columns t) and across rows
// (fragment rows t, columns g) touch 32 distinct banks.
template <int DP>
__device__ __forceinline__ int at(int r, int c) {
  const int f = ((r & 3) << 1) | ((r >> 2) & 1);
  return r * DP + (((c >> 2) ^ f) << 2) + (c & 3);
}

// Index of (r, c) in a [rows][PS] tile of S or P.
__device__ __forceinline__ int sat(int r, int c) {
  return r * PS + (c ^ ((r & 7) << 2));
}

// One warp's copy: tile rows [r0, r0 + cnt) (global row g0 + r of src,
// `rows` x d row-major), tile columns [c0, c0 + DW) from source columns
// base + c0 on, into dst; zeros past `rows` and d. `vec`: d % 4 == 0 and
// src 16-byte aligned.
template <int DP, int DW>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int g0, int rows, int r0, int cnt,
                                          int c0, int base, int d, bool vec,
                                          int lane) {
  if (vec) {
    constexpr int CPR = DW / 4;
    for (int i = lane; i < cnt * CPR; i += 32) {
      const int r = r0 + i / CPR, c = c0 + 4 * (i % CPR);
      const bool ok = g0 + r < rows && base + c < d;
      cp16(dst + at<DP>(r, c),
           ok ? src + (size_t)(g0 + r) * d + base + c : src, ok);
    }
  } else {
    for (int i = lane; i < cnt * DW; i += 32) {
      const int r = r0 + i / DW, c = c0 + i % DW;
      const bool ok = g0 + r < rows && base + c < d;
      cp4(dst + at<DP>(r, c),
          ok ? src + (size_t)(g0 + r) * d + base + c : src, ok);
    }
  }
}

template <int MT, int NTW>
struct Geometry {
  static constexpr int BO = 16 * MT, DW = 8 * NTW, DP = NW * DW;
  static constexpr int SMEM_BYTES = (BO * DP + BV * DP + NW * BO * PS) * 4;
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[mt][nt][q] = 0.f;
}

// Once this warp's copies of its columns [c0, c0 + DW) of the BO owner
// rows in os have landed, store them pre-split (hi + lo, exact in fp32),
// so that their fragments split in two operations.
template <int BO, int DP, int DW>
__device__ __forceinline__ void presplit_owner(float* os, int c0, int lane) {
  cp_wait<0>();
  __syncwarp();
  for (int i = lane; i < BO * DW; i += 32) {
    float& x = os[at<DP>(i / DW, c0 + i % DW)];
    x = presplit(x);
  }
  __syncwarp();
}

// s += this warp's share of S = own . walk^T (rows 16 mt + gq (+ 8),
// columns 8 nt + 2 tq (+ 1)): the sum over its columns [c0, c0 + 8 NTW)
// of the owner rows os (pre-split) and the walker tile ws, SK 8-deep
// steps at a time summed from zero in the MMAs and added in fp32. Summed
// over all NTW steps in the MMAs, S's truncation moved dw by ~4e-6 of
// its largest value (dw sums h rows of mixed sign) and dh by ~2.5e-6;
// four steps at a time ~1.9e-6 and ~1.3e-6 for 0.1-0.3 ms; every step
// ~0.9e-6 and ~1.1e-6 for ~0.5 ms (tools/dh_breakdown.py).
template <int MT, int NTW, int DP>
__device__ __forceinline__ void s_share(float (&s)[MT][BV / 8][4],
                                        const float* os, const float* ws,
                                        int c0) {
  const int lane = threadIdx.x & 31;
  // the row and column offsets this lane addresses for ldsm4: in an A
  // fragment (16 x 8), and in two B fragments (8 + 8 rows x 8)
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 4 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 4 * ((lane >> 3) & 1);
#pragma unroll (4 / SK)
  for (int kg = 0; kg < NTW; kg += SK) {
    float sx[MT][BV / 8][4];
    zero(sx);
#pragma unroll
    for (int ks = kg; ks < kg + SK; ++ks) {
      const int k0 = c0 + 8 * ks;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t x[4];
        ldsm4(os + at<DP>(16 * mt + ar, k0 + ac), x);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_exact(__uint_as_float(x[q]), ah[mt][q], al[mt][q]);
      }
#pragma unroll
      for (int np = 0; np < BV / 16; ++np) {
        uint32_t y[4];   // b0, b1 of MMA column tile 2 np, then 2 np + 1
        ldsm4(ws + at<DP>(16 * np + br, k0 + bc), y);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(y[2 * e]), bh0, bl0);
          split(__uint_as_float(y[2 * e + 1]), bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3(sx[mt][2 * np + e], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BV / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[mt][nt][q] += sx[mt][nt][q];
  }
}

// The walker tile's probabilities from the warps' shares of S (this
// warp's: rows 16 mt + gq (+ 8), columns 8 nt + 2 tq (+ 1)): the shares
// go to sp and are summed in warp order, and P = exp(S - lse) g is stored
// split (hi over warp 0's share, lo over warp 1's: each element is read
// and written by one thread); zero past n_own and n_walk. i = r, or with
// BY_WALKER i = c, picks the lse and g of each probability.
template <int MT, bool BY_WALKER>
__device__ __forceinline__ void probabilities(
    float* sp, const float (&s)[MT][BV / 8][4], const float* lse,
    const float* g, int o0, int j0, int n_own, int n_walk) {
  constexpr int BO = 16 * MT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  __syncthreads();   // every warp is past its reads of the last P
  float* part = sp + warp * BO * PS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BV / 8; ++nt) {
      const int r = 16 * mt + gq, c = 8 * nt + 2 * tq;
      part[sat(r, c)] = s[mt][nt][0];
      part[sat(r, c + 1)] = s[mt][nt][1];
      part[sat(r + 8, c)] = s[mt][nt][2];
      part[sat(r + 8, c + 1)] = s[mt][nt][3];
    }
  __syncthreads();
#pragma unroll
  for (int e = threadIdx.x; e < BO * BV; e += NTH) {
    const int r = e / BV, c = e % BV, i = sat(r, c);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NW; ++q) sum += sp[q * BO * PS + i];
    const int row = o0 + r, col = j0 + c, at_lg = BY_WALKER ? col : row;
    const float p = row < n_own && col < n_walk
                        ? expf(sum - lse[at_lg]) * g[at_lg] : 0.f;
    uint32_t hi, lo;
    split(p, hi, lo);
    sp[i] = __uint_as_float(hi);
    sp[BO * PS + i] = __uint_as_float(lo);
  }
  __syncthreads();
}

// acc += P . walk over the walker tile's BV rows and this warp's columns
// [c0, c0 + 8 NTW) of ws, with P's hi and lo in sp, 4 MMA columns at a
// time: their product is summed from zero over the tile (12 MMAs) and
// then added to acc in fp32, because the tensor cores' accumulation
// truncates (over K3b's whole vocab chunk, ~9000 MMAs, that costs ~1e-4
// of dh). As the last group finishes each 8 rows kb of the tile,
// refill(kb) may copy the next tile's rows into them.
template <int MT, int NTW, int DP, typename R>
__device__ __forceinline__ void p_walk(float (&acc)[MT][NTW][4],
                                       const float* sp, const float* ws,
                                       int c0, R&& refill) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 4 * (lane >> 4);
  const float* ph = sp;
  const float* pl = sp + 16 * MT * PS;
#pragma unroll
  for (int ng = 0; ng < NTW; ng += 4) {
    float tmp[MT][4][4];
    zero(tmp);
#pragma unroll 2
    for (int kb = 0; kb < BV / 8; ++kb) {
      const int k = 8 * kb + tq;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm4(ph + sat(16 * mt + ar, 8 * kb + ac), ah[mt]);
        ldsm4(pl + sat(16 * mt + ar, 8 * kb + ac), al[mt]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + 8 * (ng + i) + gq;
        uint32_t bh0, bl0, bh1, bl1;
        split(ws[at<DP>(k, col)], bh0, bl0);
        split(ws[at<DP>(k + 4, col)], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(tmp[mt][i], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
      if (ng + 4 == NTW) refill(kb);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][ng + i][q] += tmp[mt][i][q];
  }
}

// This warp's gradient acc (rows o0 + 16 mt + gq (+ 8), columns c0 + 8 nt
// + 2 tq (+ 1)) into o, (n_own, d) row-major; nothing past n_own or d.
template <int MT, int NTW>
__device__ __forceinline__ void store_acc(float* o,
                                          const float (&acc)[MT][NTW][4],
                                          int o0, int c0, int n_own, int d) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = o0 + 16 * mt + gq + 8 * half;
        const int col = c0 + 8 * nt + 2 * tq;
        if (row < n_own) {
          if (col < d) o[(size_t)row * d + col] = acc[mt][nt][2 * half];
          if (col + 1 < d)
            o[(size_t)row * d + col + 1] = acc[mt][nt][2 * half + 1];
        }
      }
}

// Block (owner tile x, walker chunk y): the partial gradient of its
// owner rows over the chunk's walker tiles -> out + y * n_own * d, with
// own (n_own, d) and walk (n_walk, d) row-major:
//   out[r] = sum_c exp(own[r] . walk[c] - lse[i]) g[i] walk[c],
// i = r (K3b: own = h, walk = w; lse and g belong to the owner's rows)
// or, with BY_WALKER, i = c (K3c: own = w, walk = h; they belong to the
// walker's rows).
template <int MT, int NTW, bool BY_WALKER>
__global__ void __launch_bounds__(NTH, 1)
cce_grad_kernel(const float* __restrict__ own,
                const float* __restrict__ walk,
                const float* __restrict__ lse, const float* __restrict__ g,
                float* __restrict__ out, int n_own, int n_walk, int d) {
  using G = Geometry<MT, NTW>;
  constexpr int BO = G::BO, DW = G::DW, DP = G::DP;
  extern __shared__ __align__(16) float smem[];
  float* os = smem;                // [BO][DP], the block's owner rows
  float* ws = os + BO * DP;        // [BV][DP], one walker tile
  float* sp = ws + BV * DP;        // [NW][BO][PS] partial S; then P's hi, lo
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * BO, c0 = warp * DW;
  const int tiles = (n_walk + BV - 1) / BV;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(own) |
        reinterpret_cast<uintptr_t>(walk)) & 15) == 0;

  // every warp copies, and later reads, only its own columns; the owner
  // rows serve every tile, so they are stored pre-split once
  load_rows<DP, DW>(os, own, o0, n_own, 0, BO, c0, 0, d, vec, lane);
  if (t0 < t1)
    load_rows<DP, DW>(ws, walk, t0 * BV, n_walk, 0, BV, c0, 0, d, vec, lane);
  cp_commit();
  presplit_owner<BO, DP, DW>(os, c0, lane);
  // this lane's 16-byte copies of an 8-row group of the walker tile: shared
  // offset from the group's first row (the swizzle repeats every 8
  // rows) and global offset from that row, -1 past d
  constexpr int GPL = DW / 16;
  int soff[GPL], goff[GPL];
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    const int q = lane + 32 * i, rr = q / (DW / 4);
    const int cc = c0 + 4 * (q % (DW / 4));
    soff[i] = at<DP>(rr, cc);
    goff[i] = cc < d ? rr * d + cc : -1;
  }

  float acc[MT][NTW][4];
  zero(acc);
  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BV;
    cp_wait<0>();
    __syncwarp();
    float s[MT][BV / 8][4];
    zero(s);
    s_share<MT, NTW, DP>(s, os, ws, c0);
    probabilities<MT, BY_WALKER>(sp, s, lse, g, o0, j0, n_own, n_walk);
    // as the product finishes each 8 rows of the tile, the warp starts
    // copying the next tile's into them
    p_walk<MT, NTW, DP>(acc, sp, ws, c0, [&](int kb) {
      if (t + 1 < t1) {
        __syncwarp();
        const int r0 = 8 * kb, g0 = j0 + BV + r0;
        if (vec) {
          const int lim = (n_walk - g0) * DP;   // rows left, as an offset
          const float* src = walk + (size_t)g0 * d;
#pragma unroll
          for (int i = 0; i < GPL; ++i) {
            const bool ok = goff[i] >= 0 && soff[i] < lim;
            cp16(ws + r0 * DP + soff[i], ok ? src + goff[i] : walk, ok);
          }
        } else {
          load_rows<DP, DW>(ws, walk, j0 + BV, n_walk, r0, 8, c0, 0, d,
                            false, lane);
        }
      }
      cp_commit();
    });
  }
  cp_wait<0>();
  store_acc<MT, NTW>(out + (size_t)blockIdx.y * n_own * d, acc, o0, c0,
                     n_own, d);
}

// K3b and K3c past D = WIDE columns: cce_grad_kernel<1, 16, BY_WALKER>'s
// routines (16 owner rows, 128 columns a warp, DP = WIDE), but block z
// owns only the WIDE-column chunk z of its rows' gradient. S needs all
// of D, so for every walker tile the block walks D's chunks, copying the
// owner rows' and the walker tile's columns of each into shared memory
// (the owner's pre-split), chunk z last, so that the walker columns of
// its own chunk are there for the P walk product. Nothing is prefetched:
// this body is right, not fast.
constexpr int WIDE = 1024;

// The K3b/K3c grid's blocks along D for width d: one up to WIDE columns.
__host__ __device__ constexpr int grad_chunks(int d) {
  return d <= WIDE ? 1 : (d + WIDE - 1) / WIDE;
}

template <bool BY_WALKER>
__global__ void __launch_bounds__(NTH, 1)
cce_grad_wide_kernel(const float* __restrict__ own,
                     const float* __restrict__ walk,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, float* __restrict__ out,
                     int n_own, int n_walk, int d) {
  constexpr int MT = 1, NTW = 16;
  using G = Geometry<MT, NTW>;
  constexpr int BO = G::BO, DW = G::DW, DP = G::DP;
  static_assert(DP == WIDE, "a chunk is one tile of columns");
  extern __shared__ __align__(16) float smem[];
  float* os = smem;                // [BO][DP], a chunk of the owner rows
  float* ws = os + BO * DP;        // [BV][DP], a chunk of one walker tile
  float* sp = ws + BV * DP;        // [NW][BO][PS] partial S; then P's hi, lo
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * BO, c0 = warp * DW;
  const int tiles = (n_walk + BV - 1) / BV;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int nq = grad_chunks(d), z = blockIdx.z;
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(own) |
        reinterpret_cast<uintptr_t>(walk)) & 15) == 0;

  float acc[MT][NTW][4];
  zero(acc);
  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BV;
    float s[MT][BV / 8][4];
    zero(s);
    for (int i = 1; i <= nq; ++i) {
      const int base = (z + i) % nq * DP;
      __syncwarp();   // the warp is past its reads of these columns
      load_rows<DP, DW>(os, own, o0, n_own, 0, BO, c0, base, d, vec, lane);
      load_rows<DP, DW>(ws, walk, j0, n_walk, 0, BV, c0, base, d, vec, lane);
      cp_commit();
      presplit_owner<BO, DP, DW>(os, c0, lane);
      s_share<MT, NTW, DP>(s, os, ws, c0);
    }
    probabilities<MT, BY_WALKER>(sp, s, lse, g, o0, j0, n_own, n_walk);
    p_walk<MT, NTW, DP>(acc, sp, ws, c0, [](int) {});
  }
  store_acc<MT, NTW>(out + (size_t)blockIdx.y * n_own * d, acc, o0,
                     z * DP + c0, n_own, d);
}

}  // namespace tc

// K3b, second pass: dh = sum over chunks of the partial dh, chunk order.
__global__ void cce_sum_chunks(const float* __restrict__ part,
                               float* __restrict__ out, size_t count,
                               int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < splits; ++c) a += part[(size_t)c * count + i];
    out[i] = a;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool BY_WALKER, int MT, int NTW, typename F>
cudaError_t call_grad(F&& f) {
  using G = tc::Geometry<MT, NTW>;
  return f(tc::cce_grad_kernel<MT, NTW, BY_WALKER>, G::BO, G::SMEM_BYTES);
}

// f(kernel, owner rows a block, dynamic shared bytes) of the K3b
// (BY_WALKER false) or K3c (true) body for d: D <= 256, 512, 768 take 32
// rows a block and D / 8 columns a warp (the accumulator is <= 96
// registers); D <= 1024 takes 16 rows; past that the wide body, 16 rows
// and one 1024-column chunk of their gradient a block.
template <bool BY_WALKER, typename F>
cudaError_t with_grad_body(int d, F&& f) {
  if (d <= 256) return call_grad<BY_WALKER, 2, 4>(f);
  if (d <= 512) return call_grad<BY_WALKER, 2, 8>(f);
  if (d <= 768) return call_grad<BY_WALKER, 2, 12>(f);
  if (d <= tc::WIDE) return call_grad<BY_WALKER, 1, 16>(f);
  return f(tc::cce_grad_wide_kernel<BY_WALKER>, tc::Geometry<1, 16>::BO,
           tc::Geometry<1, 16>::SMEM_BYTES);
}

// What a body uses, as the runtime reports it once its dynamic shared
// memory is set as a launch sets it: registers and local (spilled) bytes
// a thread and shared bytes a block; beside them the owner rows a block
// and the blocks along D that a launch gives it.
template <typename K>
cudaError_t usage(K kernel, int smem, int r, int chunks, int* regs,
                  int* local_bytes, int* smem_bytes, int* rows,
                  int* d_chunks) {
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + attr.maxDynamicSharedSizeBytes;
  *rows = r;
  *d_chunks = chunks;
  return cudaSuccess;
}

template <bool BY_WALKER>
cudaError_t grad_usage(int d, int* regs, int* local_bytes, int* smem_bytes,
                       int* rows, int* d_chunks) {
  return with_grad_body<BY_WALKER>(d, [&](auto kernel, int r, int smem) {
    return usage(kernel, smem, r, tc::grad_chunks(d), regs, local_bytes,
                 smem_bytes, rows, d_chunks);
  });
}

// One launch of the body: grid (owner tiles, splits, chunks of D: one
// up to WIDE columns), owner (n_owner, d) and walker (n_walker, d)
// row-major.
template <bool BY_WALKER>
cudaError_t launch_grad(const float* owner, const float* walker,
                        const float* lse, const float* g, float* out,
                        int n_owner, int n_walker, int d, int splits,
                        cudaStream_t s) {
  return with_grad_body<BY_WALKER>(d, [&](auto kernel, int rows, int smem) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((n_owner + rows - 1) / rows, splits, tc::grad_chunks(d));
    kernel<<<grid, tc::NTH, smem, s>>>(owner, walker, lse, g, out, n_owner,
                                       n_walker, d);
    return cudaGetLastError();
  });
}

}  // namespace

// All pointers are contiguous fp32 on CUDA device `device`; h (n, d),
// w (v, d), lse and g (n,), d >= 1. Each returns the cudaError_t of its
// launches (0 = launched).

// K3a: lse (n,). scratch: 2 * splits * n floats.
extern "C" int bigdl_cce_lse_f32(const void* h, const void* w, void* lse,
                                 void* scratch, int n, int v, int d,
                                 int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<float*>(scratch);
  auto ps = pm + (size_t)splits * n;
  err = set_smem(lse::cce_lse_kernel, lse::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + lse::BM - 1) / lse::BM, splits);
  lse::cce_lse_kernel<<<grid, lse::NTH, lse::SMEM_BYTES, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), pm, ps, n,
      v, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cce_lse_merge<<<(n + 255) / 256, 256, 0, s>>>(pm, ps,
                                                static_cast<float*>(lse), n,
                                                splits);
  return (int)cudaGetLastError();
}

// What the K3a body uses: registers and local (spilled) bytes a thread,
// shared bytes and h rows a block (the same at every d), and its blocks
// along D (1).
extern "C" int bigdl_cce_lse_usage(int d, int* regs, int* local_bytes,
                                   int* smem_bytes, int* rows,
                                   int* d_chunks) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  return (int)usage(lse::cce_lse_kernel, lse::SMEM_BYTES, lse::BM, 1, regs,
                    local_bytes, smem_bytes, rows, d_chunks);
}

// K3b: dh (n, d). scratch: splits * n * d floats.
extern "C" int bigdl_cce_dh_f32(const void* h, const void* w,
                                const void* lse, const void* g, void* dh,
                                void* scratch, int n, int v, int d,
                                int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(scratch);
  err = launch_grad<false>(static_cast<const float*>(h),
                           static_cast<const float*>(w),
                           static_cast<const float*>(lse),
                           static_cast<const float*>(g), part, n, v, d,
                           splits, s);
  if (err != cudaSuccess) return (int)err;
  const size_t count = (size_t)n * d;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256
                                                      : 4096);
  cce_sum_chunks<<<blocks, 256, 0, s>>>(part, static_cast<float*>(dh), count,
                                        splits);
  return (int)cudaGetLastError();
}

// What the K3b (dh) or K3c (dw) body for d uses: registers and local
// (spilled) bytes a thread, shared bytes and owner rows a block, and its
// blocks along D (one for each WIDE-column chunk of the gradient).
extern "C" int bigdl_cce_dh_usage(int d, int* regs, int* local_bytes,
                                  int* smem_bytes, int* rows, int* d_chunks) {
  return (int)grad_usage<false>(d, regs, local_bytes, smem_bytes, rows,
                                d_chunks);
}

extern "C" int bigdl_cce_dw_usage(int d, int* regs, int* local_bytes,
                                  int* smem_bytes, int* rows, int* d_chunks) {
  return (int)grad_usage<true>(d, regs, local_bytes, smem_bytes, rows,
                               d_chunks);
}

// K3c: dw (v, d), the K3b body with the roles swapped: a block owns 32
// vocab rows (16 when D > 768) and walks every h row, one block per
// vocab tile (1571 at V = 50257) and chunk of D, so nothing needs
// merging.
extern "C" int bigdl_cce_dw_f32(const void* h, const void* w,
                                const void* lse, const void* g, void* dw,
                                int n, int v, int d, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad<true>(
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<float*>(dw), v, n, d, 1, static_cast<cudaStream_t>(stream));
}
