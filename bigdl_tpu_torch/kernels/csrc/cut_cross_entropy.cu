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
// the bytes are h and w read once (160 MB) and the outputs written once.
// At the 67 TFLOP/s of fp32 outside the tensor cores they are bound by
// their operations: 2.36, 4.72 and 4.72 ms. This first form uses fp32
// FMAs only (no TF32, wgmma or TMA), so the products keep fp32 accuracy.
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
//    (1571 at V = 50257), each walking all N rows; it needs no merge.
//  * One block body serves K3b and K3c: an "owner" tile of 32 rows (h
//    rows for K3b, w rows for K3c) and a walk over 128-row tiles of the
//    other matrix. Per walker tile: S = owner . walker^T over D in 32-deep
//    slices (shared memory, double-buffered by cp.async), P = exp(S - lse)
//    g into shared memory, then acc += P . walker, the walker's columns
//    staged 128 at a time (double-buffered). The accumulator (32 x D)
//    stays in registers for the whole walk: 96 floats a thread at D = 768.
//  * 256 threads = 8 warps x 32 lanes. A warp owns 4 (K3a: 8) owner rows,
//    a lane 4 walker columns strided by 32, so the walker reads from
//    shared memory are conflict-free and the owner reads are broadcasts.
//  * Sums are fp32 and in a fixed order; exp and log are the accurate
//    expf/logf (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int RG = 8;         // warps = owner row groups
constexpr int BW = 128;       // walker rows per tile (4 per lane)
constexpr int BK = 32;        // depth of one staged slice of D
constexpr int CW = 128;       // accumulator columns staged at a time
constexpr int BSTR = BW + 1;  // walker slice stride: conflict-free copies
constexpr float NEG_INF = -1e30f;

template <int RPT>
struct Tile {
  static constexpr int BO = RG * RPT;           // owner rows per block
  static constexpr int OSTR = BO + 4;           // owner slice stride
  static constexpr int OS = BK * OSTR;          // owner slice, [k][row]
  static constexpr int BS = BK * BSTR;          // walker slice, [k][row]
  static constexpr int PSTR = BO + 4;
  static constexpr int PS = BW * PSTR;          // probabilities, [j][row]
  static constexpr int CS = BW * CW;            // walker columns, [j][col]
  static constexpr int LSE_FLOATS = 2 * OS + 2 * BS;
  static constexpr int GRAD_FLOATS = 2 * OS + 2 * BS + PS + 2 * CS;
};

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int RPT>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[RPT]) {
  if constexpr (RPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RPT; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      a[i] = x.x; a[i + 1] = x.y; a[i + 2] = x.z; a[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      a[i] = x.x; a[i + 1] = x.y;
    }
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

// Copy columns [c0, c0 + CW) of walker rows [j0, j0 + BW) to cs[j][col];
// zeros past n_walker or d. `vec`: d % 4 == 0 and walker 16-byte aligned,
// so a float4 is wholly inside or wholly past the row.
__device__ __forceinline__ void load_chunk(float* cs, const float* walker,
                                           int j0, int n_walker, int c0,
                                           int d, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int idx = tid; idx < BW * CW / 4; idx += NT) {
      const int j = idx / (CW / 4), c = (idx % (CW / 4)) * 4;
      const int gj = j0 + j, gc = c0 + c;
      const bool ok = gj < n_walker && gc < d;
      cp16(cs + j * CW + c, ok ? walker + (size_t)gj * d + gc : walker, ok);
    }
  } else {
    for (int idx = tid; idx < BW * CW; idx += NT) {
      const int j = idx / CW, c = idx % CW;
      const int gj = j0 + j, gc = c0 + c;
      const bool ok = gj < n_walker && gc < d;
      cp4(cs + j * CW + c, ok ? walker + (size_t)gj * d + gc : walker, ok);
    }
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

// acc[i][q] += sum_j P[j][row i] * walker[j][column q] over one chunk.
template <int RPT>
__device__ __forceinline__ void pw_chunk(const float* ps, const float* cs,
                                         float (&acc)[RPT][4], int ry,
                                         int cx) {
  using T = Tile<RPT>;
#pragma unroll 4
  for (int j = 0; j < BW; ++j) {
    float p[RPT];
    load_rows<RPT>(ps + j * T::PSTR + ry * RPT, p);
    float b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = cs[j * CW + cx + 32 * q];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(p[i], b[q], acc[i][q]);
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

// K3b (DW = false) and K3c (DW = true). Owner rows [o0, o0 + BO) against
// walker tiles of chunk blockIdx.y; the lse and g of a probability belong
// to its h row: the owner's for K3b, the walker's for K3c. Writes the
// (BO x d) accumulator to out + blockIdx.y * n_owner * d.
template <bool DW, int RPT, int DCH>
__global__ void __launch_bounds__(NT, 1)
cce_grad_kernel(const float* __restrict__ owner,
                const float* __restrict__ walker,
                const float* __restrict__ lse, const float* __restrict__ g,
                float* __restrict__ out, int n_owner, int n_walker, int d) {
  using T = Tile<RPT>;
  extern __shared__ __align__(16) float smem[];
  float* os = smem;
  float* bs = os + 2 * T::OS;
  float* pbuf = bs + 2 * T::BS;
  float* cs = pbuf + T::PS;
  const int tid = threadIdx.x, ry = tid / 32, cx = tid % 32;
  const int o0 = blockIdx.x * T::BO;
  const int tiles = (n_walker + BW - 1) / BW;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int nks = (d + BK - 1) / BK;
  const int nch = (d + CW - 1) / CW;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(walker) & 15) == 0;

  float lo[RPT], go[RPT];   // K3b: lse and g of the owner rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = o0 + ry * RPT + i;
    lo[i] = (!DW && r < n_owner) ? lse[r] : 0.f;
    go[i] = (!DW && r < n_owner) ? g[r] : 0.f;
  }
  float acc[DCH][RPT][4];
#pragma unroll
  for (int c = 0; c < DCH; ++c)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[c][i][q] = 0.f;

  if (t0 < t1)
    load_slice<RPT>(os, bs, owner, walker, o0, n_owner, t0 * BW, n_walker, 0,
                    d, tid);
  cp_commit();
  for (int t = t0; t < t1; ++t) {
    const int j0 = t * BW;
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[i][q] = 0.f;
    // S = owner . walker^T; slice k in buffer k & 1
    for (int k = 0; k < nks; ++k) {
      const int nb = (k + 1) & 1;
      if (k + 1 < nks)
        load_slice<RPT>(os + nb * T::OS, bs + nb * T::BS, owner, walker, o0,
                        n_owner, j0, n_walker, (k + 1) * BK, d, tid);
      else
        load_chunk(cs, walker, j0, n_walker, 0, d, vec, tid);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      mma_slice<RPT>(os + (k & 1) * T::OS, bs + (k & 1) * T::BS, s, ry, cx);
      __syncthreads();
    }
    // P = exp(S - lse) * g, zero past the walker's rows
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + cx + 32 * q;
      const bool ok = j < n_walker;
      const float lw = (DW && ok) ? lse[j] : 0.f;
      const float gw = (DW && ok) ? g[j] : 0.f;
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float l = DW ? lw : lo[i];
        const float gg = DW ? gw : go[i];
        p[i] = ok ? expf(s[i][q] - l) * gg : 0.f;
      }
      float* dst = pbuf + (cx + 32 * q) * T::PSTR + ry * RPT;
#pragma unroll
      for (int i = 0; i < RPT; ++i) dst[i] = p[i];
    }
    // acc += P . walker, CW columns at a time; chunk c in buffer c & 1
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      if (c < nch) {
        if (c + 1 < nch)
          load_chunk(cs + ((c + 1) & 1) * T::CS, walker, j0, n_walker,
                     (c + 1) * CW, d, vec, tid);
        else if (t + 1 < t1)
          load_slice<RPT>(os, bs, owner, walker, o0, n_owner, j0 + BW,
                          n_walker, 0, d, tid);
        cp_commit();
        cp_wait<1>();
        __syncthreads();
        pw_chunk<RPT>(pbuf, cs + (c & 1) * T::CS, acc[c], ry, cx);
        __syncthreads();
      }
    }
  }
  cp_wait<0>();
  float* o = out + (size_t)blockIdx.y * n_owner * d;
#pragma unroll
  for (int c = 0; c < DCH; ++c)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = o0 + ry * RPT + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c * CW + cx + 32 * q;
        if (c < nch && r < n_owner && col < d)
          o[(size_t)r * d + col] = acc[c][i][q];
      }
    }
}

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

template <bool DW, int RPT, int DCH>
cudaError_t launch_grad(const float* owner, const float* walker,
                        const float* lse, const float* g, float* out,
                        int n_owner, int n_walker, int d, int splits,
                        cudaStream_t stream) {
  using T = Tile<RPT>;
  const int smem = T::GRAD_FLOATS * (int)sizeof(float);
  auto kernel = cce_grad_kernel<DW, RPT, DCH>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_owner + T::BO - 1) / T::BO, splits);
  kernel<<<grid, NT, smem, stream>>>(owner, walker, lse, g, out, n_owner,
                                     n_walker, d);
  return cudaGetLastError();
}

// D <= 256: 4 rows a warp, 2 column chunks; D <= 768: 4 rows, 6 chunks;
// D <= 1024: 2 rows, 8 chunks (the accumulator stays at <= 96 registers).
template <bool DW>
cudaError_t dispatch_grad(const float* owner, const float* walker,
                          const float* lse, const float* g, float* out,
                          int n_owner, int n_walker, int d, int splits,
                          cudaStream_t stream) {
  if (d <= 256)
    return launch_grad<DW, 4, 2>(owner, walker, lse, g, out, n_owner,
                                 n_walker, d, splits, stream);
  if (d <= 768)
    return launch_grad<DW, 4, 6>(owner, walker, lse, g, out, n_owner,
                                 n_walker, d, splits, stream);
  if (d <= 1024)
    return launch_grad<DW, 2, 8>(owner, walker, lse, g, out, n_owner,
                                 n_walker, d, splits, stream);
  return cudaErrorInvalidValue;
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
  if (splits < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(scratch);
  err = dispatch_grad<false>(static_cast<const float*>(h),
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

// K3c: dw (v, d).
extern "C" int bigdl_cce_dw_f32(const void* h, const void* w,
                                const void* lse, const void* g, void* dw,
                                int n, int v, int d, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_grad<true>(
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<float*>(dw), v, n, d, 1, static_cast<cudaStream_t>(stream));
}
