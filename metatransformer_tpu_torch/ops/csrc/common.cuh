// Device code shared by the kernels of this package: bf16 helpers, the row
// LayerNorm, the cp.async helpers and the epilogue kinds of the wgmma GEMM
// (gemm_sm90.cuh; the wgmma building blocks are wgmma.cuh). Each .cu file
// that includes this header is compiled on its own into its own shared
// library, so everything here lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Epilogues of the wgmma GEMM (gemm_sm90.cuh), applied in its accumulator
// registers; the bias is bf16 and added in fp32.
enum {
  EPI_BIAS = 0,           // bf16 out = acc + bias
  EPI_BIAS_GELU = 1,      // bf16 out = gelu_erf(acc + bias)
  EPI_BIAS_RESIDUAL = 2,  // bf16 out = res + bf16(acc + bias)
  EPI_NONE = 3,           // bf16 out = acc
  EPI_NONE_F32 = 4,       // fp32 out = acc
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

// ---------------------------------------------------------------------------
// Host-side launch helpers
// ---------------------------------------------------------------------------
int launch_layer_norm(const bf16* x, const float* g, const float* b, bf16* y, int rows,
                      int d, float eps, cudaStream_t st) {
  const int blocks = (rows + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK;
  layer_norm_rows<<<blocks, 32 * LN_ROWS_PER_BLOCK, 0, st>>>(x, g, b, y, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
