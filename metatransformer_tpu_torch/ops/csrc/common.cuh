// Device code shared by the kernels of this package: bf16 helpers, the row
// LayerNorm, the cp.async helpers, the epilogue kinds and the wmma GEMM of
// the sublayer forwards (fused_block.cu; the backward's GEMM is the wgmma
// one of gemm_sm90.cuh, the wgmma building blocks are wgmma.cuh). Each .cu
// file that includes this header is compiled on its own into its own
// shared library, so everything here lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float b2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2b(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Row LayerNorm: bf16 [rows, d] -> bf16 [rows, d], fp32 statistics.
// Bound by bytes (reads 2d, writes 2d bytes a row). One warp per row,
// 16-byte loads; the row is re-read from L1/L2 for each of the three
// passes (mean, variance, normalise), which keeps any d % 8 == 0 legal.
// ---------------------------------------------------------------------------
constexpr int LN_ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(32 * LN_ROWS_PER_BLOCK)
layer_norm_rows(const bf16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, bf16* __restrict__ y, int rows,
                int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  bf16* yr = y + (size_t)row * d;

  float sum = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += b2f(e[j]);
  }
  const float mean = warp_sum(sum) / d;

  float sq = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = b2f(e[j]) - mean;
      sq += t * t;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);

  for (int c = lane * 8; c < d; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      oe[j] = f2b((b2f(e[j]) - mean) * rstd * gamma[c + j] + beta[c + j]);
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = epilogue(A[M, K] @ B + bias[N]), bf16 inputs, fp32
// accumulation on the tensor cores (wmma m16n16k16). B is row-major
// [K, N], or with TRANS_B row-major [N, K] (the product against a
// transposed weight, A @ W^T, read straight from the untransposed W: the
// B fragment is loaded col_major from the [N, K] tile).
//
// Bound: at the main path's shapes (M = B*197, K, N in 768..3072) these
// products do 2*M*N*K FLOPs over ~2*(M*K + K*N + M*N) bytes, far above the
// H100's ~295 FLOP/byte balance point, so they are bound by tensor-core
// throughput. The design keeps the tensor cores fed from shared memory:
// 128x128 output tiles, 32-deep K slabs, a 3-stage cp.async ring so loads
// of slab k+2 overlap the products of slab k, and 8 warps each owning a
// 64x32 sub-tile (8 accumulator fragments). Rows past M are zero-filled on
// load and skipped on store (B*197 is not a multiple of 128). wgmma, TMA
// and warp specialisation are later work.
// ---------------------------------------------------------------------------
enum {
  EPI_BIAS = 0,           // bf16 out = acc + bias
  EPI_BIAS_GELU = 1,      // bf16 out = gelu(acc + bias)
  EPI_BIAS_RESIDUAL = 2,  // bf16 out = res + bf16(acc + bias)
  EPI_NONE = 3,           // bf16 out = acc
  EPI_NONE_F32 = 4,       // fp32 out = acc
};

constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 32, GEMM_STAGES = 3;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_A_LD = GEMM_BK + 8;  // padded rows: fewer bank conflicts
constexpr int GEMM_B_LD = GEMM_BN + 8;
constexpr int GEMM_A_STAGE = GEMM_BM * GEMM_A_LD;  // elements

template <bool TRANS_B>
struct GemmSmem {
  // B stage: [BK][B_LD] row-major slab, or with TRANS_B [BN][A_LD].
  static constexpr int B_STAGE = TRANS_B ? GEMM_BN * GEMM_A_LD : GEMM_BK * GEMM_B_LD;
  static constexpr int BYTES =
      GEMM_STAGES * (GEMM_A_STAGE + B_STAGE) * 2 + (GEMM_THREADS / 32) * 256 * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI, bool TRANS_B>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
          const bf16* __restrict__ bias, const bf16* __restrict__ res,
          void* __restrict__ Cv, int M, int N, int K) {
  constexpr int B_STAGE = GemmSmem<TRANS_B>::B_STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GEMM_STAGES * GEMM_A_STAGE;
  float* scratch = reinterpret_cast<float*>(Bs + GEMM_STAGES * B_STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 2 warps down: 64 rows each
  const int wn = warp & 3;   // 4 warps across: 32 columns each
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int ktiles = K / GEMM_BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * GEMM_BK;
    bf16* as = As + stage * GEMM_A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, cc = (c & 3) * 8;
      const bool ok = m0 + r < M;
      const bf16* src = A + (size_t)(ok ? m0 + r : 0) * K + k0 + cc;
      cp_async16(as + r * GEMM_A_LD + cc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      if (TRANS_B) {  // B^T: 128 rows (n) x 4 chunks of 8 (k)
        const int r = c >> 2, cc = (c & 3) * 8;
        const bool ok = n0 + r < N;
        const bf16* src = B + (size_t)(ok ? n0 + r : 0) * K + k0 + cc;
        cp_async16(bs + r * GEMM_A_LD + cc, src, ok);
      } else {  // B: 32 rows (k) x 16 chunks of 8 (n)
        const int r = c >> 4, cc = (c & 15) * 8;
        const bool ok = n0 + cc < N;
        const bf16* src = B + (size_t)(k0 + r) * N + (ok ? n0 + cc : 0);
        cp_async16(bs + r * GEMM_B_LD + cc, src, ok);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();  // slab kt has landed
    __syncthreads();                   // ...for every thread; slab kt-1 is consumed
    const int nk = kt + GEMM_STAGES - 1;
    if (nk < ktiles) load_stage(nk % GEMM_STAGES, nk);
    cp_async_commit();

    const bf16* as = As + (kt % GEMM_STAGES) * GEMM_A_STAGE;
    const bf16* bs = Bs + (kt % GEMM_STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      using BLayout = std::conditional_t<TRANS_B, wmma::col_major, wmma::row_major>;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * GEMM_A_LD + kk, GEMM_A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (TRANS_B)  // element (k, n) of the fragment sits at bs[n][k]
          wmma::load_matrix_sync(b[j], bs + (wn * 32 + j * 16) * GEMM_A_LD + kk, GEMM_A_LD);
        else
          wmma::load_matrix_sync(b[j], bs + kk * GEMM_B_LD + wn * 32 + j * 16, GEMM_B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: each 16x16 fragment goes through a per-warp fp32 scratch
  // tile; lane pairs own one row of 16 and write 8 values each.
  float* ws = scratch + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(ws, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < N) {
        if (EPI == EPI_NONE_F32) {
          float* dst = static_cast<float*>(Cv) + (size_t)gr * N + gc;
          const float* src = ws + r * 16 + c0;
          *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(src[4], src[5], src[6], src[7]);
        } else {
          bf16* C = static_cast<bf16*>(Cv);
          uint4 o;
          bf16* oe = reinterpret_cast<bf16*>(&o);
          uint4 rv;
          if (EPI == EPI_BIAS_RESIDUAL)
            rv = *reinterpret_cast<const uint4*>(res + (size_t)gr * N + gc);
          const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = ws[r * 16 + c0 + e];
            if (EPI != EPI_NONE) v += b2f(bias[gc + e]);
            if (EPI == EPI_BIAS_GELU) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
            bf16 ov = f2b(v);
            if (EPI == EPI_BIAS_RESIDUAL) ov = f2b(b2f(re[e]) + b2f(ov));
            oe[e] = ov;
          }
          *reinterpret_cast<uint4*>(C + (size_t)gr * N + gc) = o;
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launch helpers
// ---------------------------------------------------------------------------
int launch_layer_norm(const bf16* x, const float* g, const float* b, bf16* y, int rows,
                      int d, float eps, cudaStream_t st) {
  const int blocks = (rows + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK;
  layer_norm_rows<<<blocks, 32 * LN_ROWS_PER_BLOCK, 0, st>>>(x, g, b, y, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, bool TRANS_B = false>
int launch_gemm(const bf16* A, const bf16* B, const bf16* bias, const bf16* res, void* C,
                int M, int N, int K, cudaStream_t st) {
  constexpr int bytes = GemmSmem<TRANS_B>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16<EPI, TRANS_B>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16<EPI, TRANS_B><<<grid, GEMM_THREADS, bytes, st>>>(A, B, bias, res, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
