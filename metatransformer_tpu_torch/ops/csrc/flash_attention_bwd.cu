// Flash-attention backward for bf16 inputs on Hopper (sm_90a): the dq
// kernel and the dk/dv kernel, on wgmma.
//
// Two public entry points with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/flash_attention.py. Each is one launch and
// replaces one Pallas kernel of metatransformer_tpu/ops/flash_attention.py:
//
//   mt_flash_bwd_dq   `_bwd_dq_kernel` (:137)  dq = scale * sum_k ds k
//   mt_flash_bwd_dkv  `_bwd_dkv_kernel` (:176) dk = scale * sum_q ds^T q,
//                                             dv = sum_q p^T dO
//   with p = exp(s * scale + bias - lse), s = q k^T in fp32,
//   dp = dO v^T, ds = p (dp - delta).
//
// The fp32 route (plain FMAs, the video-MAE decoder) stays in
// flash_attention.cu as mt_flash_bwd_dq_f32 / mt_flash_bwd_dkv_f32; every
// call takes exactly one of the two by its element type.
//
// Numerics as the Pallas kernels and the plain versions: ds is rounded to
// bf16 before ds k and ds^T q, p to bf16 before p^T dO, dq and dk are
// scaled after the sum, dv is not. The exponent is taken base 2:
// p = 2^(fma(s, scale log2e, bias log2e) - lse log2e), which moves bf16
// rounding only (inside the bf16 bound of the tests).
//
// What bounds it: at the video path's shapes (T = 1568, head_dim 64,
// B*H = 96) dq does 91 and dk/dv 121 GFLOP over 100-120 MB, so tensor-core
// operations, not bytes. On an H100 SXM (700 W) both run at about a quarter
// of the bf16 peak; with exp or the streamed copies taken out a kernel
// gains under 10%, so what holds them is the chain of wgmma issue and
// waits inside each tile (see PERF.md).
//
// Design.
//  * A block is two consumer warpgroups (256 threads) and owns 128 rows of
//    one (sample, head): 128 keys whose K and V stay in shared memory
//    (dk/dv), or 128 queries whose Q and dO stay (dq). Each warpgroup owns
//    64 of them. dq at head_dim <= 64 is capped at 128 registers so that two
//    blocks share an SM and overlap each other's waits. The other side streams through a two-stage ring of 64-row
//    tiles filled with cp.async: the copy of tile i+1 is issued before the
//    products of tile i and waited for only at the top of the next
//    iteration, behind one barrier.
//  * Every product is a wgmma. S^T = K Q^T and dP^T = V dO^T (dk/dv), or
//    S = Q K^T and dP = dO V^T (dq), read both operands from shared memory
//    (K-major). P and dS are formed in the accumulator registers, rounded
//    to bf16 and repacked in registers as the A operand of the second
//    product: the m64nNk16 accumulator layout of a 64 x 16 slice is the A
//    fragment layout, so the repack is a pairwise cvt, no shuffle. The
//    second product (dV += P^T dO, dK += dS^T Q, dQ += dS K) reads its B
//    operand MN-major (the transpose bit) from the same shared tile the
//    first product read K-major. Nothing of size [keys, queries] touches
//    shared memory.
//  * The building blocks (swizzled tiles, descriptors, the wgmma products,
//    the register repack) are wgmma.cuh, shared with the forward and the
//    attention-sublayer backward.
//  * Shared tiles use the 128-byte swizzle that the wgmma descriptors name:
//    a [rows, d] tile is stored as 64-column blocks of 128-byte rows, the
//    16-byte chunk c of row r at chunk c ^ (r % 8). cp.async writes each
//    chunk to its swizzled place, so no pass reorders them. head_dim 32
//    fills half of each row and leaves the other half zero (the second
//    product runs at width 64 and its zero columns are not stored).
//  * Infinities. Keys past T get bias -inf in the dq kernel and -inf in the
//    dk/dv kernel's per-row bias, so p = 0 for them. Query rows past T in
//    the dk/dv kernel load lse = delta = 0 and zero Q and dO rows: p <= 1
//    stays finite and their ds (= p (0 - 0)) and dO rows are exactly zero,
//    so they add nothing. The bias is added before lse is subtracted, so a
//    fully masked sample (every key at -1e30, lse = -1e30 + log T, which
//    rounds to -1e30) gives p = 2^0 = 1 over its keys: finite, as the
//    plain version.
//  * Determinism: each block sums over the streamed tiles in a fixed order,
//    in registers; no atomics. A second launch is bit-equal.
//  * TMA and warp specialisation (a producer warp, the two warpgroups out
//    of lockstep) are later work.

#include "wgmma.cuh"

namespace {

constexpr int BW_TILE = 64;  // rows of a streamed tile
constexpr int BW_STAGES = 2;

constexpr int BW_THREADS = 256;  // two consumer warpgroups
constexpr int BW_ROWS = 128;     // resident rows of a block, 64 a warpgroup

template <int HD>
struct BwCfg {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head_dim 32, 64 or 128");
  // The least number of blocks an SM holds (the register cap of
  // __launch_bounds__): dq at head_dim <= 64 fits in 128 registers a
  // thread, so two of its blocks share an SM; dk/dv needs about 180.
  static constexpr int DQ_BLOCKS = HD <= 64 ? 2 : 1;
  static constexpr int HDP = HD < 64 ? 64 : HD;  // stored width: whole 64-column blocks
  static constexpr int RES_BYTES = BW_ROWS * HDP * 2;
  static constexpr int TILE_BYTES = BW_TILE * HDP * 2;
  static constexpr int VEC_BYTES = 2 * BW_TILE * 4;  // two fp32 values a streamed row
  // Two resident tiles, two streamed tiles a stage, then the stages' rows of
  // fp32 values; 1024 bytes of slack to align the swizzle atoms.
  static constexpr int BYTES =
      2 * RES_BYTES + BW_STAGES * 2 * TILE_BYTES + BW_STAGES * VEC_BYTES + 1024;
  static constexpr int ACC = HDP / 2;  // fp32 accumulator registers of a 64 x HDP product
};

// ---------------------------------------------------------------------------
// dk, dv: one block per (128 keys, head, sample), streaming query tiles.
// q, k, v are [B, T, H, HD] by strides (sb, st, sh, 1); d_o is contiguous
// [B, T, H, HD]; lse, delta [B, H, T] fp32; dk, dv share the strides
// (gb, gt, gh, 1).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ d_o, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Tlen, long long sb, long long st, long long sh,
                    long long gb, long long gt, long long gh, float scale) {
  using C = BwCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t Ks = base, Vs = Ks + C::RES_BYTES;
  const uint32_t tiles = Vs + C::RES_BYTES;  // stage s: Q at tiles + 2s TILE, dO after it
  float* vecs = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES + BW_STAGES * 2 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = blockIdx.x * BW_ROWS, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long do_row = (long long)H * HD;
  const bf16* do_head = d_o + (long long)b * Tlen * do_row + (long long)h * HD;
  const long long stat = ((long long)b * H + h) * Tlen;
  const int nqt = (Tlen + BW_TILE - 1) / BW_TILE;

  zero_pad<HD>(smem, BW_ROWS);
  zero_pad<HD>(smem + C::RES_BYTES, BW_ROWS);
  for (int s = 0; s < 2 * BW_STAGES; ++s)
    zero_pad<HD>(smem + 2 * C::RES_BYTES + s * C::TILE_BYTES, BW_TILE);

  load_rows<HD>(Ks, BW_ROWS, k + head, st, k0, BW_ROWS, Tlen);
  load_rows<HD>(Vs, BW_ROWS, v + head, st, k0, BW_ROWS, Tlen);
  auto load_stage = [&](int s, int q0) {
    const uint32_t qs = tiles + 2 * s * C::TILE_BYTES;
    load_rows<HD>(qs, BW_TILE, q + head, st, q0, BW_TILE, Tlen);
    load_rows<HD>(qs + C::TILE_BYTES, BW_TILE, do_head, do_row, q0, BW_TILE, Tlen);
    if (tid < 2 * BW_TILE) {  // lse, then delta; 0 past T
      const int r = tid & (BW_TILE - 1), t = q0 + r;
      const bool ok = t < Tlen;
      const float* src = (tid < BW_TILE ? lse : delta) + stat + (ok ? t : 0);
      cp_async4_s(smem_u32(vecs + s * 2 * BW_TILE + tid), src, ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  // This thread's two key rows: bias in log2 units, -inf past T.
  const int r_lo = k0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const float L = LOG2E, scale_l = scale * LOG2E;
  auto key_bias = [&](int t) {
    return t < Tlen ? (bias ? bias[(long long)b * Tlen + t] * L : 0.f) : -INFINITY;
  };
  const float kb_lo = key_bias(r_lo), kb_hi = key_bias(r_hi);
  const bool active = k0 + wg * 64 < Tlen;  // a warpgroup past T only keeps the ring going
  const int col = (lane & 3) * 2;

  float acc_v[C::ACC], acc_k[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc_v[i] = acc_k[i] = 0.f;

  for (int it = 0; it < nqt; ++it) {
    cp_async_wait<0>();  // tile it (and, first, K and V) has landed
    fence_proxy_async();
    __syncthreads();  // ...for every thread; tile it-1 is consumed, its stage free
    if (it + 1 < nqt) load_stage((it + 1) & 1, (it + 1) * BW_TILE);
    cp_async_commit();
    if (!active) continue;

    const int s = it & 1;
    const uint32_t qs = tiles + 2 * s * C::TILE_BYTES, dos = qs + C::TILE_BYTES;
    const float* lse_s = vecs + s * 2 * BW_TILE;
    const float* delta_s = lse_s + BW_TILE;
    float sv[32], dp[32];
    wgmma_fence();
    product_ss<HD>(sv, Ks, BW_ROWS, wg * 64, qs, BW_TILE);  // s^T = k q^T
    wgmma_commit();
    product_ss<HD>(dp, Vs, BW_ROWS, wg * 64, dos, BW_TILE);  // dp^T = v dO^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<1>();
    fence_regs(sv);
    uint32_t pf[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n8 * 8 + col);
      const float la = l2.x * L, lb = l2.y * L;
      sv[4 * n8 + 0] = ex2(fmaf(sv[4 * n8 + 0], scale_l, kb_lo) - la);
      sv[4 * n8 + 1] = ex2(fmaf(sv[4 * n8 + 1], scale_l, kb_lo) - lb);
      sv[4 * n8 + 2] = ex2(fmaf(sv[4 * n8 + 2], scale_l, kb_hi) - la);
      sv[4 * n8 + 3] = ex2(fmaf(sv[4 * n8 + 3], scale_l, kb_hi) - lb);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) pf[j] = pack_bf16(sv[2 * j], sv[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc_v);
    product_rs<C::HDP, BW_TILE>(acc_v, pf, dos);  // dv += p^T dO
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();  // dp^T has landed (groups retire in order)
    fence_regs(dp);
    uint32_t df[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + n8 * 8 + col);
      dp[4 * n8 + 0] = sv[4 * n8 + 0] * (dp[4 * n8 + 0] - d2.x);
      dp[4 * n8 + 1] = sv[4 * n8 + 1] * (dp[4 * n8 + 1] - d2.y);
      dp[4 * n8 + 2] = sv[4 * n8 + 2] * (dp[4 * n8 + 2] - d2.x);
      dp[4 * n8 + 3] = sv[4 * n8 + 3] * (dp[4 * n8 + 3] - d2.y);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) df[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc_k);
    product_rs<C::HDP, BW_TILE>(acc_k, df, qs);  // dk += ds^T q
    wgmma_commit();
    wgmma_wait<0>();  // before the barrier that frees this stage
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? r_hi : r_lo;
    if (t >= Tlen) continue;
    const long long off = (long long)b * gb + (long long)t * gt + (long long)h * gh + col;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int i = 4 * n8 + 2 * half;
      *reinterpret_cast<uint32_t*>(dv + off + n8 * 8) = pack_bf16(acc_v[i], acc_v[i + 1]);
      *reinterpret_cast<uint32_t*>(dk + off + n8 * 8) =
          pack_bf16(acc_k[i] * scale, acc_k[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (128 queries, head, sample), streaming key tiles.
// Arguments as the dk/dv kernel; dq is [B, T, H, HD] by strides
// (gb, gt, gh, 1).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, BwCfg<HD>::DQ_BLOCKS)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   const bf16* __restrict__ d_o, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int Tlen,
                   long long sb, long long st, long long sh, long long gb, long long gt,
                   long long gh, float scale) {
  using C = BwCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t Qs = base, dOs = Qs + C::RES_BYTES;
  const uint32_t tiles = dOs + C::RES_BYTES;  // stage s: K at tiles + 2s TILE, V after it
  float* vecs = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES + BW_STAGES * 2 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * BW_ROWS, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long do_row = (long long)H * HD;
  const bf16* do_head = d_o + (long long)b * Tlen * do_row + (long long)h * HD;
  const long long stat = ((long long)b * H + h) * Tlen;
  const int nkt = (Tlen + BW_TILE - 1) / BW_TILE;

  zero_pad<HD>(smem, BW_ROWS);
  zero_pad<HD>(smem + C::RES_BYTES, BW_ROWS);
  for (int s = 0; s < 2 * BW_STAGES; ++s)
    zero_pad<HD>(smem + 2 * C::RES_BYTES + s * C::TILE_BYTES, BW_TILE);

  load_rows<HD>(Qs, BW_ROWS, q + head, st, q0, BW_ROWS, Tlen);
  load_rows<HD>(dOs, BW_ROWS, do_head, do_row, q0, BW_ROWS, Tlen);
  auto load_stage = [&](int s, int k0) {
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES;
    load_rows<HD>(ks, BW_TILE, k + head, st, k0, BW_TILE, Tlen);
    load_rows<HD>(ks + C::TILE_BYTES, BW_TILE, v + head, st, k0, BW_TILE, Tlen);
    if (bias && tid < BW_TILE) {
      const int t = k0 + tid;
      const bool ok = t < Tlen;
      cp_async4_s(smem_u32(vecs + s * BW_TILE + tid), bias + (long long)b * Tlen + (ok ? t : 0),
                  ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  // This thread's two query rows: lse in log2 units and delta (0 past T:
  // those rows are computed, finite, and not stored).
  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const float L = LOG2E, scale_l = scale * LOG2E;
  const float lse_lo = r_lo < Tlen ? lse[stat + r_lo] * L : 0.f;
  const float lse_hi = r_hi < Tlen ? lse[stat + r_hi] * L : 0.f;
  const float dl_lo = r_lo < Tlen ? delta[stat + r_lo] : 0.f;
  const float dl_hi = r_hi < Tlen ? delta[stat + r_hi] : 0.f;
  const bool active = q0 + wg * 64 < Tlen;
  const int col = (lane & 3) * 2;

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < nkt) load_stage((it + 1) & 1, (it + 1) * BW_TILE);
    cp_async_commit();
    if (!active) continue;

    const int s = it & 1, k0 = it * BW_TILE;
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES, vs = ks + C::TILE_BYTES;
    const float* kb_s = vecs + s * BW_TILE;
    float sv[32], dp[32];
    wgmma_fence();
    product_ss<HD>(sv, Qs, BW_ROWS, wg * 64, ks, BW_TILE);  // s = q k^T
    wgmma_commit();
    product_ss<HD>(dp, dOs, BW_ROWS, wg * 64, vs, BW_TILE);  // dp = dO v^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<1>();
    fence_regs(sv);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int c = n8 * 8 + col;  // this thread's key columns c, c + 1
      float ka = bias ? kb_s[c] * L : 0.f, kb = bias ? kb_s[c + 1] * L : 0.f;
      if (k0 + c >= Tlen) ka = -INFINITY;
      if (k0 + c + 1 >= Tlen) kb = -INFINITY;
      sv[4 * n8 + 0] = ex2(fmaf(sv[4 * n8 + 0], scale_l, ka) - lse_lo);
      sv[4 * n8 + 1] = ex2(fmaf(sv[4 * n8 + 1], scale_l, kb) - lse_lo);
      sv[4 * n8 + 2] = ex2(fmaf(sv[4 * n8 + 2], scale_l, ka) - lse_hi);
      sv[4 * n8 + 3] = ex2(fmaf(sv[4 * n8 + 3], scale_l, kb) - lse_hi);
    }
    fence_regs(dp);
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t df[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      dp[4 * n8 + 0] = sv[4 * n8 + 0] * (dp[4 * n8 + 0] - dl_lo);
      dp[4 * n8 + 1] = sv[4 * n8 + 1] * (dp[4 * n8 + 1] - dl_lo);
      dp[4 * n8 + 2] = sv[4 * n8 + 2] * (dp[4 * n8 + 2] - dl_hi);
      dp[4 * n8 + 3] = sv[4 * n8 + 3] * (dp[4 * n8 + 3] - dl_hi);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) df[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc);
    product_rs<C::HDP, BW_TILE>(acc, df, ks);  // dq += ds k
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? r_hi : r_lo;
    if (t >= Tlen) continue;
    const long long off = (long long)b * gb + (long long)t * gt + (long long)h * gh + col;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int i = 4 * n8 + 2 * half;
      *reinterpret_cast<uint32_t*>(dq + off + n8 * 8) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launch
// ---------------------------------------------------------------------------
struct BwArgs {
  const bf16 *q, *k, *v, *d_o;
  const float *bias, *lse, *delta;
  bf16 *dq, *dk, *dv;
  int B, T, H;
  long long sb, st, sh, gb, gt, gh;
  float scale;
  cudaStream_t stream;
};

template <int HD>
int launch_bwd(bool dkv, const BwArgs& a) {
  constexpr int bytes = BwCfg<HD>::BYTES;
  const dim3 grid((a.T + BW_ROWS - 1) / BW_ROWS, a.H, a.B);
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_wgmma<HD><<<grid, BW_THREADS, bytes, a.stream>>>(
        a.q, a.k, a.v, a.bias, a.d_o, a.lse, a.delta, a.dk, a.dv, a.T, a.sb, a.st, a.sh, a.gb,
        a.gt, a.gh, a.scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_wgmma<HD><<<grid, BW_THREADS, bytes, a.stream>>>(
        a.q, a.k, a.v, a.bias, a.d_o, a.lse, a.delta, a.dq, a.T, a.sb, a.st, a.sh, a.gb, a.gt,
        a.gh, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_any(bool dkv, int hd, int is_fp32, BwArgs& a) {
  if (is_fp32 || a.B <= 0 || a.T <= 0 || a.H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return launch_bwd<32>(dkv, a);
    case 64: return launch_bwd<64>(dkv, a);
    case 128: return launch_bwd<128>(dkv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

BwArgs make_args(const void* q, const void* k, const void* v, const void* bias, const void* d_o,
                 const void* lse, const void* delta, int B, int T, int H, long long sb,
                 long long st, long long sh, long long gb, long long gt, long long gh,
                 float scale, void* stream) {
  BwArgs a{};
  a.q = static_cast<const bf16*>(q), a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v), a.d_o = static_cast<const bf16*>(d_o);
  a.bias = static_cast<const float*>(bias), a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B, a.T = T, a.H = H, a.sb = sb, a.st = st, a.sh = sh;
  a.gb = gb, a.gt = gt, a.gh = gh, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: [B, T, H, hd] bf16 with element strides (sb, st, sh, 1); bias:
// [B, T] fp32 or null; d_o: contiguous [B, T, H, hd] bf16; lse, delta:
// [B, H, T] fp32. Output dq: [B, T, H, hd] with element strides
// (gb, gt, gh, 1). is_fp32 must be 0 (fp32: mt_flash_bwd_dq_f32).
int mt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                    const void* d_o, const void* lse, const void* delta, void* dq, int B,
                    int T, int H, int hd, long long sb, long long st, long long sh,
                    long long gb, long long gt, long long gh, float scale, int is_fp32,
                    void* stream) {
  BwArgs a = make_args(q, k, v, bias, d_o, lse, delta, B, T, H, sb, st, sh, gb, gt, gh, scale,
                       stream);
  a.dq = static_cast<bf16*>(dq);
  return launch_bwd_any(false, hd, is_fp32, a);
}

// As mt_flash_bwd_dq; outputs dk and dv share the strides (gb, gt, gh, 1).
int mt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                     const void* d_o, const void* lse, const void* delta, void* dk, void* dv,
                     int B, int T, int H, int hd, long long sb, long long st, long long sh,
                     long long gb, long long gt, long long gh, float scale, int is_fp32,
                     void* stream) {
  BwArgs a = make_args(q, k, v, bias, d_o, lse, delta, B, T, H, sb, st, sh, gb, gt, gh, scale,
                       stream);
  a.dk = static_cast<bf16*>(dk), a.dv = static_cast<bf16*>(dv);
  return launch_bwd_any(true, hd, is_fp32, a);
}

}  // extern "C"
