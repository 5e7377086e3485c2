// Fused transformer sublayers for Hopper (sm_90a), forward only.
//
// Two public entry points with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/fused_block.py:
//
//   mt_attn_sublayer: out = x + proj(MHSA(LN(x)))
//     replaces the Pallas kernel metatransformer_tpu/ops/fused_block.py
//     `_kernel` (:82). A chain of four launches on the caller's stream:
//     layer_norm_rows -> gemm_bf16<EPI_BIAS> (QKV) -> attention_core ->
//     gemm_bf16<EPI_BIAS_RESIDUAL> (proj + residual).
//
//   mt_mlp_sublayer: out = x + fc2(GELU(fc1(LN(x))))
//     replaces `_mlp_kernel` (:562). Three launches: layer_norm_rows ->
//     gemm_bf16<EPI_BIAS_GELU> (fc1) -> gemm_bf16<EPI_BIAS_RESIDUAL> (fc2).
//     GELU is exact erf, as core/encoder.py's mlp and timm use. The Pallas
//     kernel took the tanh form only because erf has no Pallas TPU
//     lowering; this is a deliberate difference from that kernel.
//
// Numerics follow the Pallas kernels' cast points: LayerNorm statistics in
// fp32; every product accumulates in fp32 over bf16 inputs and adds its
// bias in fp32 before rounding to bf16; q is scaled in fp32 and then
// rounded; logits, row max and row sum are fp32; P is rounded to bf16 for
// P.V and the output is normalised after P.V.
//
// Design notes. The TPU kernel ran one program per 1-4 samples with the
// whole sublayer in VMEM. On 132 SMs that leaves the card idle at small
// batch, so here the row-parallel parts (LN, the four GEMMs) tile over all
// B*T rows and the attention core runs one block per (query tile, head,
// sample). Each entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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
// GEMM: C[M, N] = epilogue(A[M, K] @ B[K, N] + bias[N]), all row-major bf16,
// fp32 accumulation on the tensor cores (wmma m16n16k16).
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
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 32, GEMM_STAGES = 3;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_A_LD = GEMM_BK + 8;  // padded rows: fewer bank conflicts
constexpr int GEMM_B_LD = GEMM_BN + 8;
constexpr int GEMM_A_STAGE = GEMM_BM * GEMM_A_LD;  // elements
constexpr int GEMM_B_STAGE = GEMM_BK * GEMM_B_LD;
constexpr int GEMM_SMEM_BYTES =
    GEMM_STAGES * (GEMM_A_STAGE + GEMM_B_STAGE) * 2 + (GEMM_THREADS / 32) * 256 * 4;

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

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
          const bf16* __restrict__ bias, const bf16* __restrict__ res,
          bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GEMM_STAGES * GEMM_A_STAGE;
  float* scratch = reinterpret_cast<float*>(Bs + GEMM_STAGES * GEMM_B_STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 2 warps down: 64 rows each
  const int wn = warp & 3;   // 4 warps across: 32 columns each
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int ktiles = K / GEMM_BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * GEMM_BK;
    bf16* as = As + stage * GEMM_A_STAGE;
    bf16* bs = Bs + stage * GEMM_B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, cc = (c & 3) * 8;
      const bool ok = m0 + r < M;
      const bf16* src = A + (size_t)(ok ? m0 + r : 0) * K + k0 + cc;
      cp_async16(as + r * GEMM_A_LD + cc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 32 rows x 16 chunks of 8
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 4, cc = (c & 15) * 8;
      const bool ok = n0 + cc < N;
      const bf16* src = B + (size_t)(k0 + r) * N + (ok ? n0 + cc : 0);
      cp_async16(bs + r * GEMM_B_LD + cc, src, ok);
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
    const bf16* bs = Bs + (kt % GEMM_STAGES) * GEMM_B_STAGE;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * GEMM_A_LD + kk, GEMM_A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * GEMM_B_LD + wn * 32 + j * 16, GEMM_B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: each 16x16 fragment goes through a per-warp fp32 scratch
  // tile; lane pairs own one row of 16 and write 8 bf16 (16 bytes) each.
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
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
        uint4 rv;
        if (EPI == EPI_BIAS_RESIDUAL)
          rv = *reinterpret_cast<const uint4*>(res + (size_t)gr * N + gc);
        const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = ws[r * 16 + c0 + e] + b2f(bias[gc + e]);
          if (EPI == EPI_BIAS_GELU) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          bf16 ov = f2b(v);
          if (EPI == EPI_BIAS_RESIDUAL) ov = f2b(b2f(re[e]) + b2f(ov));
          oe[e] = ov;
        }
        *reinterpret_cast<uint4*>(C + (size_t)gr * N + gc) = o;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core: o[b, t, h*HD:(h+1)*HD] = softmax(q k^T + bias) v for one
// (query tile of 64, head, sample) per block, reading q/k/v straight out of
// the fused [B, T, 3D] QKV slab (columns (q|k|v) x heads).
//
// Bound: at T=197, HD=64 the block does ~4*64*197*64 FLOPs for ~2*197*64*2
// bytes of K/V: small products, bound by latency and shared-memory traffic
// rather than by HBM or the tensor-core peak; attention is ~4% of the
// block's FLOPs at this length. The design keeps every [T, T] quantity on
// chip: K/V stream through shared memory in 64-key tiles, and the logits
// of a 16x64 tile live in a per-warp fp32 scratch. Two passes over the
// keys keep the Pallas kernel's numerics exactly (global row max first,
// then p = exp(s - m), l = sum p in fp32, P.V with P rounded to bf16,
// normalise after P.V) at the cost of computing q k^T twice. The key tail
// past T gets a bias of -inf before the max; query rows past T are
// computed on zeros and not stored.
// ---------------------------------------------------------------------------
constexpr int ATT_BQ = 64, ATT_BKV = 64, ATT_THREADS = 128;

template <int HD>
struct AttnSmem {
  static constexpr int LD = HD + 8;         // q/k/v rows (bf16)
  static constexpr int S_LD = ATT_BKV + 4;  // logits rows (fp32)
  static constexpr int P_LD = ATT_BKV + 8;  // probabilities rows (bf16)
  static constexpr int O_LD = HD + 4;       // output rows (fp32)
  static constexpr int Q = 0;
  static constexpr int K = Q + ATT_BQ * LD * 2;
  static constexpr int V = K + ATT_BKV * LD * 2;
  static constexpr int S = V + ATT_BKV * LD * 2;
  static constexpr int P = S + 4 * 16 * S_LD * 4;
  static constexpr int O = P + 4 * 16 * P_LD * 2;
  static constexpr int KB = O + 4 * 16 * O_LD * 4;
  static constexpr int BYTES = KB + ATT_BKV * 4;
};

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core(const bf16* __restrict__ qkv, const float* __restrict__ bias,
               bf16* __restrict__ out, int T, int D, float scale) {
  using L = AttnSmem<HD>;
  constexpr int LD = L::LD, S_LD = L::S_LD, P_LD = L::P_LD, O_LD = L::O_LD;
  constexpr int CH = HD / 8;  // 16-byte chunks in a head row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* kb = reinterpret_cast<float*>(smem + L::KB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const int qcol = h * HD, kcol = D + h * HD, vcol = 2 * D + h * HD;

  // Q tile, scaled in fp32 then rounded to bf16 (the Pallas kernel's :127).
  for (int c = tid; c < ATT_BQ * CH; c += ATT_THREADS) {
    const int r = c / CH, cc = (c % CH) * 8, t = q0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < T) {
      u = *reinterpret_cast<const uint4*>(base + t * row_stride + qcol + cc);
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = f2b(b2f(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + cc) = u;
  }

  auto load_keys = [&](int k0, bool with_v) {
    for (int c = tid; c < ATT_BKV * CH; c += ATT_THREADS) {
      const int r = c / CH, cc = (c % CH) * 8, t = k0 + r;
      uint4 ku = make_uint4(0, 0, 0, 0), vu = make_uint4(0, 0, 0, 0);
      if (t < T) {
        ku = *reinterpret_cast<const uint4*>(base + t * row_stride + kcol + cc);
        if (with_v) vu = *reinterpret_cast<const uint4*>(base + t * row_stride + vcol + cc);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + cc) = ku;
      if (with_v) *reinterpret_cast<uint4*>(Vs + r * LD + cc) = vu;
    }
    for (int c = tid; c < ATT_BKV; c += ATT_THREADS) {
      const int t = k0 + c;
      kb[c] = t < T ? (bias ? bias[(size_t)b * T + t] : 0.f) : -INFINITY;
    }
  };

  // This warp's 16 query rows; a lane pair owns one row, 32 keys each.
  const bf16* wq = Qs + warp * 16 * LD;
  float* ws = Ss + warp * 16 * S_LD;
  bf16* wp = Ps + warp * 16 * P_LD;
  const int r = lane >> 1, half = (lane & 1) * 32;

  auto scores = [&]() {  // ws[16, 64] = wq[16, HD] . Ks[64, HD]^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, wq + kk, LD);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * LD + kk, LD);
        wmma::mma_sync(s[n], a, kf, s[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(ws + n * 16, s[n], S_LD, wmma::mem_row_major);
    __syncwarp();
  };

  const int nkt = (T + ATT_BKV - 1) / ATT_BKV;

  // Pass 1: the row max over all keys.
  float m = -INFINITY;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // previous tile fully consumed
    load_keys(kt * ATT_BKV, false);
    __syncthreads();
    scores();
    for (int c = half; c < half + 32; ++c) m = fmaxf(m, ws[r * S_LD + c] + kb[c]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // Pass 2: p = exp(s - m), l = sum p (fp32), o += bf16(p) . v.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  float l = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_keys(kt * ATT_BKV, true);
    __syncthreads();
    scores();
    for (int c = half; c < half + 32; ++c) {
      const float p = expf(ws[r * S_LD + c] + kb[c] - m);
      l += p;
      wp[r * P_LD + c] = f2b(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < ATT_BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, wp + kk, P_LD);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * LD + n * 16, LD);
        wmma::mma_sync(o[n], a, vf, o[n]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  float* wo = Os + warp * 16 * O_LD;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(wo + n * 16, o[n], O_LD, wmma::mem_row_major);
  __syncwarp();
  const int t = q0 + warp * 16 + r;
  if (t < T) {
    bf16* dst = out + ((size_t)b * T + t) * D + h * HD;
    const int c_lo = (lane & 1) * (HD / 2);
#pragma unroll
    for (int c = c_lo; c < c_lo + HD / 2; c += 8) {
      uint4 ov;
      bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int j = 0; j < 8; ++j) oe[j] = f2b(wo[r * O_LD + c + j] / l);
      *reinterpret_cast<uint4*>(dst + c) = ov;
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

template <int EPI>
int launch_gemm(const bf16* A, const bf16* B, const bf16* bias, const bf16* res, bf16* C,
                int M, int N, int K, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16<EPI><<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, st>>>(A, B, bias, res, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_attention_hd(const bf16* qkv, const float* bias, bf16* o, int B, int T, int D,
                        int H, cudaStream_t st) {
  constexpr int bytes = AttnSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attention_core<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + ATT_BQ - 1) / ATT_BQ, H, B);
  // The scale as the reference passes it: float(hd) ** -0.5 rounded to fp32.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  attention_core<HD><<<grid, ATT_THREADS, bytes, st>>>(qkv, bias, o, T, D, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_attention(const bf16* qkv, const float* bias, bf16* o, int B, int T, int D, int H,
                     cudaStream_t st) {
  switch (D / H) {
    case 32: return launch_attention_hd<32>(qkv, bias, o, B, T, D, H, st);
    case 64: return launch_attention_hd<64>(qkv, bias, o, B, T, D, H, st);
    case 128: return launch_attention_hd<128>(qkv, bias, o, B, T, D, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mt_attn_sublayer(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                     const void* bqkv, const void* wproj, const void* bproj,
                     const void* bias, void* xn, void* qkv, void* o, void* out, int B,
                     int T, int D, int H, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  int rc = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                             static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D,
                             eps, st);
  if (rc) return rc;
  rc = launch_gemm<EPI_BIAS>(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv),
                             static_cast<const bf16*>(bqkv), nullptr,
                             static_cast<bf16*>(qkv), M, 3 * D, D, st);
  if (rc) return rc;
  rc = launch_attention(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                        static_cast<bf16*>(o), B, T, D, H, st);
  if (rc) return rc;
  return launch_gemm<EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(bproj), static_cast<const bf16*>(x), static_cast<bf16*>(out),
      M, D, D, st);
}

int mt_mlp_sublayer(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* xn, void* h,
                    void* out, int rows, int D, int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                             static_cast<const float*>(ln_b), static_cast<bf16*>(xn), rows,
                             D, eps, st);
  if (rc) return rc;
  rc = launch_gemm<EPI_BIAS_GELU>(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                                  static_cast<const bf16*>(b1), nullptr,
                                  static_cast<bf16*>(h), rows, F, D, st);
  if (rc) return rc;
  return launch_gemm<EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, D, F, st);
}

}  // extern "C"
