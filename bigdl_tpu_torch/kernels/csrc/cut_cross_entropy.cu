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
// K3a uses fp32 FMAs. K3b and K3c run on the tensor cores, one body
// with the roles of h and w swapped: both products of each are
// mma.sync m16n8k8 TF32 MMAs in the error-compensated split CUTLASS
// calls OpMultiplyAddFastF32: a = hi + lo with hi = a rounded toward
// zero to TF32 and lo = the rest rounded to nearest, a b ~ hi hi' +
// hi lo' + lo hi'. That keeps dh and dw within a few 1e-6 of their
// fp32 values where a single TF32 product moves them by ~4e-4
// (chip_smoke.py and tests/test_torch_kernels.py check both). The three
// MMAs for one are what holds them back: with one TF32 MMA in their
// place dh and dw take 3.49 and 3.63 ms at the shape above where they
// take 6.14 and 6.02 (tools/dh_breakdown.py, H100 80GB HBM3 at 700 W);
// wgmma is the step past mma.sync's rate.
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
//  * K3a: an owner tile of 64 h rows walks 128-row tiles of w: S over D
//    in 32-deep slices (shared memory, double-buffered by cp.async),
//    256 threads = 8 warps x 32 lanes; a warp owns 8 owner rows, a lane
//    4 walker columns strided by 32.
//  * Sums are fp32 and in a fixed order; exp and log are the accurate
//    expf/logf (no fast math). Nothing reads PyTorch's TF32 switches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int NT = 256;       // threads per block
constexpr int RG = 8;         // warps = owner row groups
constexpr int BW = 128;       // walker rows per tile (4 per lane)
constexpr int BK = 32;        // depth of one staged slice of D
constexpr int BSTR = BW + 1;  // walker slice stride: conflict-free copies
constexpr float NEG_INF = -1e30f;

template <int RPT>
struct Tile {
  static constexpr int BO = RG * RPT;           // owner rows per block
  static constexpr int OSTR = BO + 4;           // owner slice stride
  static constexpr int OS = BK * OSTR;          // owner slice, [k][row]
  static constexpr int BS = BK * BSTR;          // walker slice, [k][row]
  static constexpr int LSE_FLOATS = 2 * OS + 2 * BS;
};

template <int RPT>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[RPT]) {
  static_assert(RPT % 4 == 0, "whole float4 loads");
#pragma unroll
  for (int i = 0; i < RPT; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    a[i] = x.x; a[i + 1] = x.y; a[i + 2] = x.z; a[i + 3] = x.w;
  }
}

// Copy the [k0, k0 + BK) slice of owner rows [o0, o0 + BO) and of walker
// rows [j0, j0 + BW) into shared memory, transposed to [k][row]; zeros
// past n_owner, n_walker or d.
template <int RPT>
__device__ __forceinline__ void load_slice(float* os, float* bs,
                                           const float* owner,
                                           const float* walker, int o0,
                                           int n_owner, int j0, int n_walker,
                                           int k0, int d, int tid) {
  using T = Tile<RPT>;
#pragma unroll
  for (int idx = tid; idx < T::BO * BK; idx += NT) {
    const int r = idx / BK, kk = idx % BK;
    const int gr = o0 + r, gk = k0 + kk;
    const bool ok = gr < n_owner && gk < d;
    cp4(os + kk * T::OSTR + r, ok ? owner + (size_t)gr * d + gk : owner, ok);
  }
#pragma unroll
  for (int idx = tid; idx < BW * BK; idx += NT) {
    const int j = idx / BK, kk = idx % BK;
    const int gj = j0 + j, gk = k0 + kk;
    const bool ok = gj < n_walker && gk < d;
    cp4(bs + kk * BSTR + j, ok ? walker + (size_t)gj * d + gk : walker, ok);
  }
}

// S[i][q] += sum_k owner[row i] [k] * walker[col q] [k] over one slice.
template <int RPT>
__device__ __forceinline__ void mma_slice(const float* os, const float* bs,
                                          float (&s)[RPT][4], int ry,
                                          int cx) {
  using T = Tile<RPT>;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[RPT];
    load_rows<RPT>(os + kk * T::OSTR + ry * RPT, a);
    float b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = bs[kk * BSTR + cx + 32 * q];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[i][q] = fmaf(a[i], b[q], s[i][q]);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// K3a. Block (row tile x, vocab chunk y): the running (max, sum) of
// exp(h . w) over the chunk for each of its rows -> pm, ps [y][n].
template <int RPT>
__global__ void __launch_bounds__(NT)
cce_lse_kernel(const float* __restrict__ h, const float* __restrict__ w,
               float* __restrict__ pm, float* __restrict__ ps, int n, int v,
               int d) {
  using T = Tile<RPT>;
  extern __shared__ __align__(16) float smem[];
  float* os = smem;
  float* bs = smem + 2 * T::OS;
  const int tid = threadIdx.x, ry = tid / 32, cx = tid % 32;
  const int o0 = blockIdx.x * T::BO;
  const int tiles = (v + BW - 1) / BW;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int nks = (d + BK - 1) / BK;

  float m[RPT], sum[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) { m[i] = NEG_INF; sum[i] = 0.f; }

  int it = 0;   // slices issued so far: slice `it` lives in buffer it & 1
  if (t0 < t1) load_slice<RPT>(os, bs, h, w, o0, n, t0 * BW, v, 0, d, tid);
  cp_commit();
  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BW;
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[i][q] = 0.f;
    for (int k = 0; k < nks; ++k, ++it) {
      const int nb = (it + 1) & 1;
      if (k + 1 < nks)
        load_slice<RPT>(os + nb * T::OS, bs + nb * T::BS, h, w, o0, n, j0, v,
                        (k + 1) * BK, d, tid);
      else if (t + 1 < t1)
        load_slice<RPT>(os + nb * T::OS, bs + nb * T::BS, h, w, o0, n,
                        j0 + BW, v, 0, d, tid);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      mma_slice<RPT>(os + (it & 1) * T::OS, bs + (it & 1) * T::BS, s, ry, cx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tm = NEG_INF;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + cx + 32 * q < v) tm = fmaxf(tm, s[i][q]);
      if (tm > NEG_INF) {     // at least one column of this tile is real
        const float mn = fmaxf(m[i], tm);
        float add = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + cx + 32 * q < v) add += expf(s[i][q] - mn);
        sum[i] = sum[i] * expf(m[i] - mn) + add;
        m[i] = mn;
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum[i], off);
      merge(m[i], sum[i], m2, s2);
    }
    const int r = o0 + ry * RPT + i;
    if (cx == 0 && r < n) {
      pm[(size_t)blockIdx.y * n + r] = m[i];
      ps[(size_t)blockIdx.y * n + r] = sum[i];
    }
  }
}

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
// `rows` x d row-major), columns [c0, c0 + DW), into dst; zeros past
// `rows` and d. `vec`: d % 4 == 0 and src 16-byte aligned.
template <int DP, int DW>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int g0, int rows, int r0, int cnt,
                                          int c0, int d, bool vec, int lane) {
  if (vec) {
    constexpr int CPR = DW / 4;
    for (int i = lane; i < cnt * CPR; i += 32) {
      const int r = r0 + i / CPR, c = c0 + 4 * (i % CPR);
      const bool ok = g0 + r < rows && c < d;
      cp16(dst + at<DP>(r, c), ok ? src + (size_t)(g0 + r) * d + c : src, ok);
    }
  } else {
    for (int i = lane; i < cnt * DW; i += 32) {
      const int r = r0 + i / DW, c = c0 + i % DW;
      const bool ok = g0 + r < rows && c < d;
      cp4(dst + at<DP>(r, c), ok ? src + (size_t)(g0 + r) * d + c : src, ok);
    }
  }
}

template <int MT, int NTW>
struct Geometry {
  static constexpr int BO = 16 * MT, DW = 8 * NTW, DP = NW * DW;
  static constexpr int SMEM_BYTES = (BO * DP + BV * DP + NW * BO * PS) * 4;
};

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
  const int gq = lane >> 2, tq = lane & 3;
  const int o0 = blockIdx.x * BO, c0 = warp * DW;
  // the row and column offsets this lane addresses for ldsm4: in an A
  // fragment (16 x 8), and in two B fragments (8 + 8 rows x 8)
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 4 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 4 * ((lane >> 3) & 1);
  const int tiles = (n_walk + BV - 1) / BV;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(own) |
        reinterpret_cast<uintptr_t>(walk)) & 15) == 0;

  // every warp copies, and later reads, only its own columns
  load_rows<DP, DW>(os, own, o0, n_own, 0, BO, c0, d, vec, lane);
  if (t0 < t1)
    load_rows<DP, DW>(ws, walk, t0 * BV, n_walk, 0, BV, c0, d, vec, lane);
  cp_commit();
  // the owner rows serve every tile: store them pre-split once
  cp_wait<0>();
  __syncwarp();
  for (int i = lane; i < BO * DW; i += 32) {
    float& x = os[at<DP>(i / DW, c0 + i % DW)];
    x = presplit(x);
  }
  __syncwarp();
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
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BV;
    cp_wait<0>();
    __syncwarp();
    // this warp's share of S = own . walk^T: the sum over its columns,
    // SK 8-deep steps at a time summed from zero in the MMAs and added
    // in fp32. Summed over all NTW steps in the MMAs, S's truncation
    // moved dw by ~4e-6 of its largest value (dw sums h rows of mixed
    // sign) and dh by ~2.5e-6; four steps at a time ~1.9e-6 and ~1.3e-6
    // for 0.1-0.3 ms; every step ~0.9e-6 and ~1.1e-6 for ~0.5 ms
    // (tools/dh_breakdown.py)
    float s[MT][BV / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BV / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[mt][nt][q] = 0.f;
#pragma unroll (4 / SK)
    for (int kg = 0; kg < NTW; kg += SK) {
      float sx[MT][BV / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < BV / 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) sx[mt][nt][q] = 0.f;
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
    // P = exp(S - lse) g, the partial S summed in warp order, stored split
    // (hi over warp 0's partial, lo over warp 1's: each element is read
    // and written by one thread); zero past n_own and n_walk
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
    // out += P . walk over the tile's rows, this warp's columns, 4 MMA
    // columns at a time: their product is summed from zero over the
    // tile (12 MMAs) and then added to acc in fp32, because the tensor
    // cores' accumulation truncates (over K3b's whole vocab chunk, ~9000
    // MMAs, that costs ~1e-4 of dh). As the last group finishes each 8
    // rows of the tile, the warp starts copying the next tile's into them.
    const float* ph = sp;
    const float* pl = sp + BO * PS;
#pragma unroll
    for (int ng = 0; ng < NTW; ng += 4) {
      float tmp[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) tmp[mt][i][q] = 0.f;
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
        if (ng + 4 == NTW && t + 1 < t1) {
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
            load_rows<DP, DW>(ws, walk, j0 + BV, n_walk, r0, 8, c0, d, false,
                              lane);
          }
        }
        cp_commit();
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][ng + i][q] += tmp[mt][i][q];
    }
  }
  cp_wait<0>();
  float* o = out + (size_t)blockIdx.y * n_own * d;
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
// registers); D <= 1024 takes 16 rows. Returns cudaErrorInvalidValue
// past 1024.
template <bool BY_WALKER, typename F>
cudaError_t with_grad_body(int d, F&& f) {
  if (d <= 256) return call_grad<BY_WALKER, 2, 4>(f);
  if (d <= 512) return call_grad<BY_WALKER, 2, 8>(f);
  if (d <= 768) return call_grad<BY_WALKER, 2, 12>(f);
  if (d <= 1024) return call_grad<BY_WALKER, 1, 16>(f);
  return cudaErrorInvalidValue;
}

// What the body for d uses: registers and local (spilled) bytes a
// thread, dynamic shared memory bytes and owner rows a block.
template <bool BY_WALKER>
cudaError_t grad_usage(int d, int* regs, int* local_bytes, int* smem_bytes,
                       int* rows) {
  return with_grad_body<BY_WALKER>(d, [&](auto kernel, int r, int smem) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = smem;
    *rows = r;
    return cudaSuccess;
  });
}

// One launch of the body: grid (owner tiles, splits), owner (n_owner, d)
// and walker (n_walker, d) row-major.
template <bool BY_WALKER>
cudaError_t launch_grad(const float* owner, const float* walker,
                        const float* lse, const float* g, float* out,
                        int n_owner, int n_walker, int d, int splits,
                        cudaStream_t s) {
  return with_grad_body<BY_WALKER>(d, [&](auto kernel, int rows, int smem) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((n_owner + rows - 1) / rows, splits);
    kernel<<<grid, tc::NTH, smem, s>>>(owner, walker, lse, g, out, n_owner,
                                       n_walker, d);
    return cudaGetLastError();
  });
}

}  // namespace

// All pointers are contiguous fp32 on CUDA device `device`; h (n, d),
// w (v, d), lse and g (n,), 1 <= d <= 1024. Each returns the cudaError_t
// of its launches (0 = launched).

// K3a: lse (n,). scratch: 2 * splits * n floats.
extern "C" int bigdl_cce_lse_f32(const void* h, const void* w, void* lse,
                                 void* scratch, int n, int v, int d,
                                 int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 1024 || splits < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<float*>(scratch);
  auto ps = pm + (size_t)splits * n;
  constexpr int RPT = 8;
  const int smem = Tile<RPT>::LSE_FLOATS * (int)sizeof(float);
  err = set_smem(cce_lse_kernel<RPT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + Tile<RPT>::BO - 1) / Tile<RPT>::BO, splits);
  cce_lse_kernel<RPT><<<grid, NT, smem, s>>>(static_cast<const float*>(h),
                                             static_cast<const float*>(w), pm,
                                             ps, n, v, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cce_lse_merge<<<(n + 255) / 256, 256, 0, s>>>(pm, ps,
                                                static_cast<float*>(lse), n,
                                                splits);
  return (int)cudaGetLastError();
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
// (spilled) bytes a thread, dynamic shared memory bytes and owner rows a
// block.
extern "C" int bigdl_cce_dh_usage(int d, int* regs, int* local_bytes,
                                  int* smem_bytes, int* rows) {
  return (int)grad_usage<false>(d, regs, local_bytes, smem_bytes, rows);
}

extern "C" int bigdl_cce_dw_usage(int d, int* regs, int* local_bytes,
                                  int* smem_bytes, int* rows) {
  return (int)grad_usage<true>(d, regs, local_bytes, smem_bytes, rows);
}

// K3c: dw (v, d), the K3b body with the roles swapped: a block owns 32
// vocab rows (16 when D > 768) and walks every h row, one block per
// vocab tile (1571 at V = 50257), so nothing needs merging.
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
