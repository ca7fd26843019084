// int8 x int8 GEMM with int32 accumulation and a fused fp32 dequantizing
// epilogue, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel bigdl_tpu/kernels/quantized_matmul.py::_qmm_kernel
// (its pallas_call in int8_matmul). Same function:
//   out[m, n] = (float(sum_k xq[m, k] * wq[k, n]) * sx[m]) * sw[n]
// with the sum exact in int32 and the epilogue in the reference's order,
// so the result equals the plain version bit for bit.
//
// What bounds it on an H100: at the serving shapes (M = 4096 token rows,
// K x N = 768 x 3072 or 3072 x 768) the work is 2*M*N*K = 19.3 G int8
// operations (10 us at 1,979 TOP/s) and the bytes are the int8 operands
// read once plus the fp32 output written once (56 MB for gate/up, 17 us
// at 3.35 TB/s): the output write bounds it. The first form of this
// kernel, 64 x 64 tiles of __dp4a, was bound by the dp4a instruction rate
// and the shared-memory loads that fed it, 19x over the bound.
//
// Design, and what it does about that:
//  * Integer products go to the tensor cores: mma.sync m16n8k32
//    s32.s8.s8.s32, exact, so no tolerance moves. One block owns a
//    128 x 128 output tile; its 8 warps (2 x 4) own 64 x 32 each, 4 x 4
//    MMA tiles whose int32 accumulators stay in registers for the whole
//    K walk.
//  * Both operands are read K-contiguous: A is xq (M, K) and B is the
//    (N, K) transposed copy of the weight that QuantizedLinear makes once
//    when it quantizes, which is the "col" operand mma.sync wants, so
//    ldmatrix loads both fragments. 64-deep K slices of both sit in a
//    4-stage cp.async ring (16 KB a stage); the 16-byte chunks of a
//    64-byte row are XOR-swizzled by row so that ldmatrix's eight rows
//    hit eight distinct bank groups.
//  * The epilogue dequantizes straight from the accumulators into an
//    fp32 tile staged in the (then idle) ring, and writes it out as
//    16-byte stores, one 512-byte row per warp, coalesced.
//  * Edges are masked, not padded: rows past M or N and K past its end
//    load as zero (exact for an integer sum) and stores are predicated.
//    Two bodies, chosen by shape in the launcher: when K % 16 == 0 and
//    both operands are 16-byte aligned (the serving shapes), the ring is
//    filled by cp.async; otherwise each 16-byte chunk is assembled from
//    single bytes and stored to shared memory. The MMA core is the same.
//  * wgmma with TMA is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BK = 64;                 // K slice in bytes (int8 values)
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;
constexpr int TILE_BYTES = BM * BK;    // one operand's slice (A or B)
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int OSTR = BN + 8;           // epilogue tile stride, floats
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int OUT_BYTES = BM * OSTR * 4;
constexpr int SMEM_BYTES = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;

// Byte offset of 16-byte chunk c (0..3) of row r in an operand slice.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 128) x bytes [k0, k0 + 64) of the (rows, K) int8
// matrix g into one swizzled operand slice at shared address `dst`
// (generic pointer `dptr`); zeros past `rows` and K.
template <bool ALIGNED>
__device__ __forceinline__ void load_slice(uint32_t dst, unsigned char* dptr,
                                           const int8_t* __restrict__ g,
                                           int row0, int rows, int k0, int K,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < BM * (BK / 16) / NTHREADS; ++i) {
    const int idx = tid + i * NTHREADS;
    const int r = idx >> 2, c = idx & 3;
    const int gr = row0 + r, gk = k0 + 16 * c;
    if (ALIGNED) {
      const bool ok = gr < rows && gk < K;
      cp16(dst + swz(r, c), ok ? g + (size_t)gr * K + gk : g, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const int8_t* src = g + (size_t)gr * K;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (gk + b < K)
            w[b >> 2] |= (uint32_t)(uint8_t)src[gk + b] << (8 * (b & 3));
      }
      *reinterpret_cast<uint4*>(dptr + swz(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(NTHREADS, 2)
int8_gemm_tc_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ wt,
                    const float* __restrict__ sx,
                    const float* __restrict__ sw, float* __restrict__ out,
                    int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;       // warp tile 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int ktiles = (K + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto load_stage = [&](int kt) {
    const int off = (kt % STAGES) * STAGE_BYTES;
    load_slice<ALIGNED>(sbase + off, smem + off, xq, m0, M, kt * BK, K, tid);
    load_slice<ALIGNED>(sbase + off + TILE_BYTES, smem + off + TILE_BYTES, wt,
                        n0, N, kt * BK, K, tid);
  };

  // the ring: slice kt lives in slot kt % STAGES; group i holds slice i
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // slice kt has landed; slot (kt - 1) % STAGES is free
    if (kt + STAGES - 1 < ktiles) load_stage(kt + STAGES - 1);
    cp_commit();
    const uint32_t sa = sbase + (kt % STAGES) * STAGE_BYTES;
    const uint32_t sb = sa + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // matrices: rows 0-7 | 8-15 of the m16 tile x k bytes 0-15 | 16-31
        const int r = wm * 64 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(sa + swz(r, 2 * kk + (lane >> 4)), af[mt][0], af[mt][1],
                af[mt][2], af[mt][3]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // matrices: n8 tile 2p | 2p + 1 x k bytes 0-15 | 16-31
        const int mat = lane >> 3;
        const int r = wn * 32 + (2 * p + (mat >> 1)) * 8 + (lane & 7);
        ldsm_x4(sb + swz(r, 2 * kk + (mat & 1)), bf[2 * p][0], bf[2 * p][1],
                bf[2 * p + 1][0], bf[2 * p + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is idle: it becomes the fp32 output tile

  float* tile = reinterpret_cast<float*>(smem);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mt * 16 + gq + 8 * half;
      const float scale_x = m0 + r < M ? sx[m0 + r] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + 2 * tq;
        const int n = n0 + c;
        const float s0 = n < N ? sw[n] : 0.f;
        const float s1 = n + 1 < N ? sw[n + 1] : 0.f;
        float2 v;
        v.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]),
                                  scale_x), s0);
        v.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                                  scale_x), s1);
        *reinterpret_cast<float2*>(tile + r * OSTR + c) = v;
      }
    }
  __syncthreads();

  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int c = lane * 4, n = n0 + c;
#pragma unroll 4
  for (int i = 0; i < BM / 8; ++i) {
    const int r = i * 8 + warp, m = m0 + r;
    if (m >= M) break;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * OSTR + c);
    float* dst = out + (size_t)m * N + n;
    if (vec && n + 3 < N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (n < N) dst[0] = v.x;
      if (n + 1 < N) dst[1] = v.y;
      if (n + 2 < N) dst[2] = v.z;
      if (n + 3 < N) dst[3] = v.w;
    }
  }
}

template <bool ALIGNED>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* fx,
                   const float* fw, float* o, int M, int N, int K,
                   cudaStream_t s) {
  auto kernel = int8_gemm_tc_kernel<ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(a, b, fx, fw, o, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8, wt: (N, K) int8 (the weight transposed), sx: (M,)
// fp32, sw: (N,) fp32, out: (M, N) fp32; all contiguous on CUDA device
// `device`, M, N >= 1. `aligned` != 0 promises K % 16 == 0 and 16-byte
// aligned xq and wt (the cp.async body). Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int bigdl_int8_matmul(const void* xq, const void* wt,
                                 const void* sx, const void* sw, void* out,
                                 int M, int N, int K, int aligned,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const int8_t*>(wt);
  auto fx = static_cast<const float*>(sx);
  auto fw = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  return (int)(aligned ? launch<true>(a, b, fx, fw, o, M, N, K, s)
                       : launch<false>(a, b, fx, fw, o, M, N, K, s));
}

// What the body chosen by `aligned` uses: registers a thread, local
// (spilled) bytes a thread, dynamic shared memory bytes a block.
extern "C" int bigdl_int8_matmul_usage(int aligned, int* regs,
                                       int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = aligned
      ? cudaFuncGetAttributes(&attr, int8_gemm_tc_kernel<true>)
      : cudaFuncGetAttributes(&attr, int8_gemm_tc_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = SMEM_BYTES;
  return 0;
}
