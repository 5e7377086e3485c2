// GEMM on Hopper (sm_90a) wgmma: C[M, N] = epilogue(A[M, K] @ B), bf16
// inputs, fp32 accumulation. It runs every product of the fused sublayers:
// the forwards' four (fused_block.cu: QKV, proj + residual, fc1 + GELU,
// fc2 + residual) and the attention backward's three (fused_block_bwd.cu:
// the QKV recompute, g Wproj^T and dqkv Wqkv^T).
//
// A is row-major [M, K]: K-major. B is either the untransposed weight
// [K, N] (N contiguous), read MN-major through the transpose bit, or, with
// TRANS_B, a row-major [N, K] weight, which is the natural K-major B of
// A @ W^T. No operand is copied or transposed.
//
// What bounds it: at the sublayers' shapes (M = B*T = 25216, N and K in
// 768..3072) 2 M N K operations over 2 (M K + K N + M N) bytes, far above
// the H100's ~295 operations a byte: tensor-core operations.
//
// Design.
//  * A block owns a 128 x 128 output tile with two consumer warpgroups, 64
//    rows each, every one a chain of m64n128k16 wgmma products with both
//    operands in shared memory.
//  * K advances in 64-deep slabs (one 128-byte swizzle row of bf16) through
//    a four-stage cp.async ring: the copy of slab k+2 is issued before the
//    products of slab k, and one group of products stays in flight across
//    the next barrier (wgmma.wait_group 1), so the tensor cores are fed
//    while the copies of two slabs are on their way.
//  * Tiles are stored with the 128-byte swizzle (wgmma.cuh); A and a
//    TRANS_B weight as [128 rows, 64] K-major tiles, an untransposed weight
//    as [64 rows of K, 128] in two 64-column blocks.
//  * Ragged M: rows past M are zero-filled on load and not stored. N must
//    be a multiple of 128 and K of 64 (the wrappers check).
//  * The epilogue runs in the accumulator registers: a thread holds pairs
//    of neighbouring columns of two rows and stores them as bf16 pairs (or
//    fp32 pairs), with the cast points of the reference's sublayers: the
//    bias added in fp32, then bf16(gelu_erf(acc + bias)) for EPI_BIAS_GELU
//    and bf16(res + bf16(acc + bias)) for EPI_BIAS_RESIDUAL, the residual
//    read as bf16 pairs beside the stores. No scratch tile.

#pragma once

#include "wgmma.cuh"

namespace {

constexpr int G9_BM = 128, G9_BN = 128, G9_BK = 64, G9_STAGES = 4;
constexpr int G9_AHEAD = G9_STAGES - 2;  // slabs in flight ahead of the one in use
constexpr int G9_THREADS = 256;
constexpr int G9_A_STAGE = G9_BM * G9_BK * 2;  // bytes
constexpr int G9_B_STAGE = G9_BN * G9_BK * 2;
constexpr int G9_BYTES = G9_STAGES * (G9_A_STAGE + G9_B_STAGE) + 1024;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int EPI, bool TRANS_B>
__global__ void __launch_bounds__(G9_THREADS, 1)
gemm_sm90(const bf16* __restrict__ A, const bf16* __restrict__ B,
          const bf16* __restrict__ bias, const bf16* __restrict__ res, void* __restrict__ Cv,
          int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t As = smem_u32(smem), Bs = As + G9_STAGES * G9_A_STAGE;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * G9_BM, n0 = blockIdx.x * G9_BN;
  const int ktiles = K / G9_BK;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * G9_BK;
    const uint32_t as = As + s * G9_A_STAGE, bs = Bs + s * G9_B_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A: 128 rows x 8 chunks of 16 bytes
      const int c = tid + i * G9_THREADS, r = c >> 3, ch = c & 7;
      const bool ok = m0 + r < M;
      cp_async16_s(as + swz(G9_BM, r, ch), A + (size_t)(ok ? m0 + r : 0) * K + k0 + ch * 8, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * G9_THREADS;
      if (TRANS_B) {  // [N, K]: 128 rows (n) x 8 chunks (k)
        const int r = c >> 3, ch = c & 7;
        cp_async16_s(bs + swz(G9_BN, r, ch), B + (size_t)(n0 + r) * K + k0 + ch * 8, true);
      } else {  // [K, N]: 64 rows (k) x 16 chunks (n)
        const int r = c >> 4, ch = c & 15;
        cp_async16_s(bs + swz(G9_BK, r, ch), B + (size_t)(k0 + r) * N + n0 + ch * 8, true);
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < G9_AHEAD; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<G9_AHEAD - 1>();  // slab kt has landed
    fence_proxy_async();
    __syncthreads();  // ...for every thread; the products of slab kt-2 are done
    const int nk = kt + G9_AHEAD;
    if (nk < ktiles) load_stage(nk % G9_STAGES, nk);
    cp_async_commit();

    const int s = kt % G9_STAGES;
    const uint32_t as = As + s * G9_A_STAGE + wg * 64 * 128, bs = Bs + s * G9_B_STAGE;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < G9_BK / 16; ++kk) {
      if (TRANS_B)
        wgmma_ss_n128<0>(acc, desc_k(as + kk * 32), desc_k(bs + kk * 32), 1);
      else
        wgmma_ss_n128<1>(acc, desc_k(as + kk * 32), desc_mn(bs + kk * 16 * 128, G9_BK), 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the products of slab kt-1 are done: its stage is free
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  const int r_lo = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int n8 = 0; n8 < G9_BN / 8; ++n8) {
      const int c = col + n8 * 8, i = 4 * n8 + 2 * half;
      float v0 = acc[i], v1 = acc[i + 1];
      if constexpr (EPI == EPI_NONE_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(Cv) + (size_t)row * N + c) =
            make_float2(v0, v1);
      } else {
        if constexpr (EPI != EPI_NONE) {
          v0 += b2f(bias[c]);
          v1 += b2f(bias[c + 1]);
        }
        if constexpr (EPI == EPI_BIAS_GELU) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        if constexpr (EPI == EPI_BIAS_RESIDUAL) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + c);
          y = __floats2bfloat162_rn(b2f(r.x) + b2f(y.x), b2f(r.y) + b2f(y.y));
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Cv) + (size_t)row * N + c) = y;
      }
    }
  }
}

template <int EPI, bool TRANS_B = false>
int launch_gemm_sm90(const bf16* A, const bf16* B, const bf16* bias, const bf16* res, void* C,
                     int M, int N, int K, cudaStream_t st) {
  if (M <= 0 || N % G9_BN || K % G9_BK || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gemm_sm90<EPI, TRANS_B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G9_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / G9_BN, (M + G9_BM - 1) / G9_BM);
  gemm_sm90<EPI, TRANS_B><<<grid, G9_THREADS, G9_BYTES, st>>>(A, B, bias, res, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
