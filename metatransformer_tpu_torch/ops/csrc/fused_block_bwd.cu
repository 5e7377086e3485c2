// Backward of the fused attention sublayer for Hopper (sm_90a).
//
// One public entry point with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/fused_block.py:
//
//   mt_attn_sublayer_bwd: from x, the output cotangent g and the weights,
//     recompute LayerNorm, QKV and softmax and emit dx, dqkv, xn, o (bf16)
//     and dgamma, dbeta (fp32). Replaces the Pallas kernel
//     metatransformer_tpu/ops/fused_block.py `_bwd_kernel` (:310) at the
//     call boundary of `_bwd_via_kernel` (:450): the weight gradients
//     (xn^T dqkv, o^T g and the two bias sums) stay outside, with the caller.
//
// A chain of nine launches on the caller's stream:
//   layer_norm_rows                   xn = LN(x)
//   gemm_sm90<EPI_BIAS>               qkv = xn Wqkv + bqkv      (Wqkv read MN-major)
//   gemm_sm90<EPI_NONE, T>            do = g Wproj^T            (Wproj read K-major)
//   attn_bwd_q                        o, dq, the row statistics (m, 1/l, delta)
//                                     and q * scale (into the dxn scratch)
//   attn_bwd_kv                       dk, dv
//   gemm_sm90<EPI_NONE_F32, T>        dxn = dqkv Wqkv^T (fp32)  (Wqkv read K-major)
//   ln_bwd_rows                       dx = g + LN backward, row mean / rstd
//   ln_param_grad_partial / _reduce   dgamma, dbeta
//
// Numerics follow the Pallas kernel's cast points: LN in fp32; qkv, do
// rounded to bf16; s = bf16(q * scale) k^T + bias in fp32; p = softmax(s)
// in fp32 and pb = bf16(p); o = pb v; dv = pb^T do; dp = do v^T;
// ds = bf16(p * (dp - rowsum(dp * p))); dq = ds k * scale; dk = ds^T q *
// scale with the unscaled q; dxn and the LN backward in fp32. rowsum(dp * p)
// is formed from the fp32 p, as the reference does (not from do . o, whose o
// went through bf16(p)); it is accumulated as sum(dp * e) / l beside
// l = sum(e), which differs from the reference only in fp32 rounding. The
// exponent is taken base 2 (e = 2^(s log2e + bias log2e - m), m in log2
// units), which moves fp32 rounding only.
//
// What bounds it: at the main path's shapes (B = 128, T = 197, D = 768,
// H = 12) it does 254 GFLOP over 0.31 GB, so tensor-core operations, not
// bytes: 208 GFLOP in the three GEMMs (gemm_sm90.cuh), the rest in the
// attention products. Design notes:
//  * No sequential grid. The TPU kernel ran one program per 1-2 samples, in
//    order, and carried dgamma / dbeta from program to program. Here the
//    row-parallel parts tile over all B*T rows, and dgamma / dbeta are a
//    two-stage reduction (per-256-row partials, then one pass over the
//    partials in a fixed order): deterministic, no atomics.
//  * Every product is a wgmma (wgmma.cuh). The GEMMs read the weights as
//    they are stored: K-major for the two products against W^T, MN-major
//    (the transpose bit) for xn Wqkv.
//  * Two accumulation directions. dq sums over keys, dk / dv over queries:
//    two launches in the FlashAttention-2 manner, each block two consumer
//    warpgroups that own 128 resident rows of one (sample, head) and stream
//    the other side through a two-stage cp.async ring of 64-row tiles.
//    attn_bwd_q (128 queries a block) streams the key tiles twice: pass A
//    takes the row max online and accumulates l and sum(dp * e); pass B
//    forms p, pb, ds and accumulates o and dq. It stores the three row
//    statistics, and the rounded q * scale of its rows into the dxn scratch
//    (free until the last GEMM writes it), which attn_bwd_kv (128 keys a
//    block) reads while it streams query tiles and accumulates dv and dk.
//  * S = Qs K^T and dP = dO V^T (S^T = K Qs^T and dP^T = V dO^T) read both
//    operands K-major from shared memory. P and dS are formed in the
//    accumulator registers, rounded to bf16 and repacked in registers as the
//    A operand of the next product, whose B (V, K; dO, Q) is read MN-major
//    from the same swizzled tile. Nothing of size [T, T] touches shared
//    memory.
//  * Ragged T and masks. Keys past T get a bias of -inf (probability 0 in
//    p, ds, dv); masked keys get the caller's additive -1e30, so a fully
//    masked sample gives a uniform p and no NaN. Query rows past T are
//    computed on zero rows and never stored; in attn_bwd_kv they read
//    m = 1/l = delta = 0, so their p and ds are exactly 0.

#include "gemm_sm90.cuh"

namespace {

constexpr int AB_THREADS = 256;  // two consumer warpgroups
constexpr int AB_ROWS = 128;     // resident rows of a block, 64 a warpgroup
constexpr int AB_TILE = 64;      // rows of a streamed tile
constexpr int AB_STAGES = 2;

template <int HD>
struct AbCfg {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // stored width: whole 64-column blocks
  static constexpr int RES_BYTES = AB_ROWS * HDP * 2;
  static constexpr int TILE_BYTES = AB_TILE * HDP * 2;
  // Two resident tiles, then per stage two (q kernel: K, V) or three (kv
  // kernel: q * scale, q, dO) streamed tiles and one (key bias) or three
  // (m, 1/l, delta) rows of fp32; 1024 bytes of slack to align the swizzle
  // atoms.
  static constexpr int Q_BYTES =
      2 * RES_BYTES + AB_STAGES * (2 * TILE_BYTES + AB_TILE * 4) + 1024;
  static constexpr int KV_BYTES =
      2 * RES_BYTES + AB_STAGES * (3 * TILE_BYTES + 3 * AB_TILE * 4) + 1024;
  static constexpr int ACC = HDP / 2;  // fp32 accumulator registers of a 64 x HDP product
};

// Store two rows of a 64 x HD accumulator (times mul, rounded to bf16) from
// registers: row t_lo takes elements i % 4 < 2, row t_hi the others.
template <int HD, int ACC>
__device__ __forceinline__ void store_acc_rows(const float (&acc)[ACC], bf16* row_lo,
                                               bf16* row_hi, bool lo_ok, bool hi_ok,
                                               float mul) {
  const int col = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8) {
    const int i = 4 * n8;
    if (lo_ok)
      *reinterpret_cast<uint32_t*>(row_lo + n8 * 8 + col) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
    if (hi_ok)
      *reinterpret_cast<uint32_t*>(row_hi + n8 * 8 + col) =
          pack_bf16(acc[i + 2] * mul, acc[i + 3] * mul);
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_q: one block per (128 queries, head, sample). Emits o, dq (into
// dqkv's q columns), the row statistics m (log2 units), 1/l, delta into
// stats [3][B*H*T] fp32, and q * scale into qs [B*T, D] bf16.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_bwd_q(const bf16* __restrict__ qkv, const bf16* __restrict__ d_o,
           const float* __restrict__ bias, bf16* __restrict__ o_out,
           bf16* __restrict__ dqkv, float* __restrict__ stats, bf16* __restrict__ qs,
           int T, int D, float scale) {
  using C = AbCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t Qs = smem_u32(smem), dOs = Qs + C::RES_BYTES;
  const uint32_t tiles = dOs + C::RES_BYTES;  // stage s: K at tiles + 2s TILE, V after it
  float* kbias = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES +
                                          AB_STAGES * 2 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * AB_ROWS, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const bf16* do_head = d_o + (size_t)b * T * D + h * HD;
  const int nkt = (T + AB_TILE - 1) / AB_TILE;

  zero_pad<HD>(smem, AB_ROWS);
  zero_pad<HD>(smem + C::RES_BYTES, AB_ROWS);
  for (int s = 0; s < 2 * AB_STAGES; ++s)
    zero_pad<HD>(smem + 2 * C::RES_BYTES + s * C::TILE_BYTES, AB_TILE);

  load_scaled_q<HD, AB_ROWS, AB_THREADS>(smem, base + h * HD, row_stride,
                                         qs + (size_t)b * T * D + h * HD, D, q0, T, scale);
  load_rows<HD>(dOs, AB_ROWS, do_head, D, q0, AB_ROWS, T);
  auto load_stage = [&](int s, int k0) {
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES;
    load_rows<HD>(ks, AB_TILE, base + D + h * HD, row_stride, k0, AB_TILE, T);
    load_rows<HD>(ks + C::TILE_BYTES, AB_TILE, base + 2 * D + h * HD, row_stride, k0, AB_TILE,
                  T);
    if (bias && tid < AB_TILE) {
      const int t = k0 + tid;
      const bool ok = t < T;
      cp_async4_s(smem_u32(kbias + s * AB_TILE + tid), bias + (size_t)b * T + (ok ? t : 0), ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int col = (lane & 3) * 2;
  const float L = LOG2E;
  const bool active = q0 + wg * 64 < T;  // a warpgroup past T only keeps the ring going

  float m_lo = -INFINITY, m_hi = -INFINITY;  // row max, log2 units
  float l_lo = 0.f, l_hi = 0.f, ds_lo = 0.f, ds_hi = 0.f;  // this thread's shares
  float il_lo = 0.f, il_hi = 0.f, dl_lo = 0.f, dl_hi = 0.f;  // 1/l, delta (pass B)
  float acc_o[C::ACC], acc_q[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc_o[i] = acc_q[i] = 0.f;

  for (int it = 0; it < 2 * nkt; ++it) {
    cp_async_wait<0>();  // tile it (and, first, Q and dO) has landed
    fence_proxy_async();
    __syncthreads();  // ...for every thread; tile it-1 is consumed, its stage free
    if (it + 1 < 2 * nkt) load_stage((it + 1) & 1, ((it + 1) % nkt) * AB_TILE);
    cp_async_commit();
    if (!active) continue;

    const bool pass_b = it >= nkt;
    if (it == nkt) {  // pass A is complete: the row statistics
      const float l0 = quad_sum(l_lo), l1 = quad_sum(l_hi);
      il_lo = 1.f / l0, il_hi = 1.f / l1;
      dl_lo = quad_sum(ds_lo) * il_lo, dl_hi = quad_sum(ds_hi) * il_hi;
      if ((lane & 3) == 0) {
        const size_t plane = (size_t)gridDim.z * H * T, idx = ((size_t)b * H + h) * T;
        if (r_lo < T) {
          stats[idx + r_lo] = m_lo;
          stats[plane + idx + r_lo] = il_lo;
          stats[2 * plane + idx + r_lo] = dl_lo;
        }
        if (r_hi < T) {
          stats[idx + r_hi] = m_hi;
          stats[plane + idx + r_hi] = il_hi;
          stats[2 * plane + idx + r_hi] = dl_hi;
        }
      }
    }
    const int s = it & 1, k0 = (it % nkt) * AB_TILE;
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES, vs = ks + C::TILE_BYTES;
    const float* kb_s = kbias + s * AB_TILE;
    float sv[32], dp[32];
    wgmma_fence();
    product_ss<HD>(sv, Qs, AB_ROWS, wg * 64, ks, AB_TILE);  // s = bf16(q scale) k^T
    wgmma_commit();
    product_ss<HD>(dp, dOs, AB_ROWS, wg * 64, vs, AB_TILE);  // dp = do v^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<1>();
    fence_regs(sv);
    // logits in log2 units: s log2e + bias log2e, -inf past T
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int c = n8 * 8 + col;
      float ka = bias ? kb_s[c] * L : 0.f, kb = bias ? kb_s[c + 1] * L : 0.f;
      if (k0 + c >= T) ka = -INFINITY;
      if (k0 + c + 1 >= T) kb = -INFINITY;
      sv[4 * n8 + 0] = fmaf(sv[4 * n8 + 0], L, ka);
      sv[4 * n8 + 1] = fmaf(sv[4 * n8 + 1], L, kb);
      sv[4 * n8 + 2] = fmaf(sv[4 * n8 + 2], L, ka);
      sv[4 * n8 + 3] = fmaf(sv[4 * n8 + 3], L, kb);
    }
    if (!pass_b) {
      float tm_lo = -INFINITY, tm_hi = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        tm_lo = fmaxf(tm_lo, fmaxf(sv[4 * n8 + 0], sv[4 * n8 + 1]));
        tm_hi = fmaxf(tm_hi, fmaxf(sv[4 * n8 + 2], sv[4 * n8 + 3]));
      }
      // finite: every tile holds a key < T
      const float mn_lo = fmaxf(m_lo, quad_max(tm_lo)), mn_hi = fmaxf(m_hi, quad_max(tm_hi));
      const float c_lo = ex2(m_lo - mn_lo), c_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo, m_hi = mn_hi;
      l_lo *= c_lo, ds_lo *= c_lo, l_hi *= c_hi, ds_hi *= c_hi;
      fence_regs(dp);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float e0 = ex2(sv[4 * n8 + 0] - mn_lo), e1 = ex2(sv[4 * n8 + 1] - mn_lo);
        const float e2 = ex2(sv[4 * n8 + 2] - mn_hi), e3 = ex2(sv[4 * n8 + 3] - mn_hi);
        l_lo += e0 + e1;
        l_hi += e2 + e3;
        ds_lo += e0 * dp[4 * n8 + 0] + e1 * dp[4 * n8 + 1];
        ds_hi += e2 * dp[4 * n8 + 2] + e3 * dp[4 * n8 + 3];
      }
      continue;
    }
    uint32_t pf[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      sv[4 * n8 + 0] = ex2(sv[4 * n8 + 0] - m_lo) * il_lo;
      sv[4 * n8 + 1] = ex2(sv[4 * n8 + 1] - m_lo) * il_lo;
      sv[4 * n8 + 2] = ex2(sv[4 * n8 + 2] - m_hi) * il_hi;
      sv[4 * n8 + 3] = ex2(sv[4 * n8 + 3] - m_hi) * il_hi;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) pf[j] = pack_bf16(sv[2 * j], sv[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc_o);
    product_rs<C::HDP, AB_TILE>(acc_o, pf, vs);  // o += pb v
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();  // dp has landed (groups retire in order)
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
    fence_regs(acc_q);
    product_rs<C::HDP, AB_TILE>(acc_q, df, ks);  // dq += ds k
    wgmma_commit();
    wgmma_wait<0>();  // before the barrier that frees this stage
    fence_regs(acc_o);
    fence_regs(acc_q);
  }

  if (!active) return;
  const size_t row_lo = (size_t)b * T + (r_lo < T ? r_lo : 0);
  const size_t row_hi = (size_t)b * T + (r_hi < T ? r_hi : 0);
  store_acc_rows<HD>(acc_o, o_out + row_lo * D + h * HD, o_out + row_hi * D + h * HD,
                     r_lo < T, r_hi < T, 1.f);
  store_acc_rows<HD>(acc_q, dqkv + row_lo * row_stride + h * HD,
                     dqkv + row_hi * row_stride + h * HD, r_lo < T, r_hi < T, scale);
}

// ---------------------------------------------------------------------------
// attn_bwd_kv: one block per (128 keys, head, sample), streaming query tiles
// (q * scale from qs, q from qkv, do, and their statistics). Works on the
// transposed products S^T, dP^T [keys, queries], so dv = pb^T do and
// dk = ds^T q take the streamed tiles MN-major. Emits dk and dv into dqkv's
// k and v columns.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_bwd_kv(const bf16* __restrict__ qkv, const bf16* __restrict__ d_o,
            const float* __restrict__ bias, const float* __restrict__ stats,
            const bf16* __restrict__ qs, bf16* __restrict__ dqkv, int T, int D, float scale) {
  using C = AbCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t Ks = smem_u32(smem), Vs = Ks + C::RES_BYTES;
  // stage s: q * scale at tiles + 3s TILE, then q, then do
  const uint32_t tiles = Vs + C::RES_BYTES;
  float* vecs = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES +
                                         AB_STAGES * 3 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = blockIdx.x * AB_ROWS, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const size_t plane = (size_t)gridDim.z * H * T;
  const float* st_head = stats + ((size_t)b * H + h) * T;
  const int nqt = (T + AB_TILE - 1) / AB_TILE;

  zero_pad<HD>(smem, AB_ROWS);
  zero_pad<HD>(smem + C::RES_BYTES, AB_ROWS);
  for (int s = 0; s < 3 * AB_STAGES; ++s)
    zero_pad<HD>(smem + 2 * C::RES_BYTES + s * C::TILE_BYTES, AB_TILE);

  load_rows<HD>(Ks, AB_ROWS, base + D + h * HD, row_stride, k0, AB_ROWS, T);
  load_rows<HD>(Vs, AB_ROWS, base + 2 * D + h * HD, row_stride, k0, AB_ROWS, T);
  auto load_stage = [&](int s, int q0) {
    const uint32_t qst = tiles + 3 * s * C::TILE_BYTES;
    load_rows<HD>(qst, AB_TILE, qs + (size_t)b * T * D + h * HD, D, q0, AB_TILE, T);
    load_rows<HD>(qst + C::TILE_BYTES, AB_TILE, base + h * HD, row_stride, q0, AB_TILE, T);
    load_rows<HD>(qst + 2 * C::TILE_BYTES, AB_TILE, d_o + (size_t)b * T * D + h * HD, D, q0,
                  AB_TILE, T);
    if (tid < 3 * AB_TILE) {  // m, 1/l, delta; 0 past T
      const int which = tid / AB_TILE, t = q0 + tid % AB_TILE;
      const bool ok = t < T;
      cp_async4_s(smem_u32(vecs + s * 3 * AB_TILE + tid),
                  st_head + which * plane + (ok ? t : 0), ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  // This thread's two key rows: bias in log2 units, -inf past T.
  const int r_lo = k0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const float L = LOG2E;
  auto key_bias = [&](int t) {
    return t < T ? (bias ? bias[(size_t)b * T + t] * L : 0.f) : -INFINITY;
  };
  const float kb_lo = key_bias(r_lo), kb_hi = key_bias(r_hi);
  const bool active = k0 + wg * 64 < T;
  const int col = (lane & 3) * 2;

  float acc_v[C::ACC], acc_k[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc_v[i] = acc_k[i] = 0.f;

  for (int it = 0; it < nqt; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < nqt) load_stage((it + 1) & 1, (it + 1) * AB_TILE);
    cp_async_commit();
    if (!active) continue;

    const int s = it & 1;
    const uint32_t qst = tiles + 3 * s * C::TILE_BYTES, qrt = qst + C::TILE_BYTES,
                   dot = qrt + C::TILE_BYTES;
    const float* m_s = vecs + s * 3 * AB_TILE;
    const float* il_s = m_s + AB_TILE;
    const float* dl_s = il_s + AB_TILE;
    float sv[32], dp[32];
    wgmma_fence();
    product_ss<HD>(sv, Ks, AB_ROWS, wg * 64, qst, AB_TILE);  // s^T = k bf16(q scale)^T
    wgmma_commit();
    product_ss<HD>(dp, Vs, AB_ROWS, wg * 64, dot, AB_TILE);  // dp^T = v do^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<1>();
    fence_regs(sv);
    uint32_t pf[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int c = n8 * 8 + col;  // this thread's query columns c, c + 1
      const float2 m2 = *reinterpret_cast<const float2*>(m_s + c);
      const float2 i2 = *reinterpret_cast<const float2*>(il_s + c);
      sv[4 * n8 + 0] = ex2(fmaf(sv[4 * n8 + 0], L, kb_lo) - m2.x) * i2.x;
      sv[4 * n8 + 1] = ex2(fmaf(sv[4 * n8 + 1], L, kb_lo) - m2.y) * i2.y;
      sv[4 * n8 + 2] = ex2(fmaf(sv[4 * n8 + 2], L, kb_hi) - m2.x) * i2.x;
      sv[4 * n8 + 3] = ex2(fmaf(sv[4 * n8 + 3], L, kb_hi) - m2.y) * i2.y;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) pf[j] = pack_bf16(sv[2 * j], sv[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc_v);
    product_rs<C::HDP, AB_TILE>(acc_v, pf, dot);  // dv += pb^T do
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();  // dp^T has landed (groups retire in order)
    fence_regs(dp);
    uint32_t df[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + n8 * 8 + col);
      dp[4 * n8 + 0] = sv[4 * n8 + 0] * (dp[4 * n8 + 0] - d2.x);
      dp[4 * n8 + 1] = sv[4 * n8 + 1] * (dp[4 * n8 + 1] - d2.y);
      dp[4 * n8 + 2] = sv[4 * n8 + 2] * (dp[4 * n8 + 2] - d2.x);
      dp[4 * n8 + 3] = sv[4 * n8 + 3] * (dp[4 * n8 + 3] - d2.y);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) df[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
    wgmma_fence();
    fence_regs(acc_k);
    product_rs<C::HDP, AB_TILE>(acc_k, df, qrt);  // dk += ds^T q
    wgmma_commit();
    wgmma_wait<0>();  // before the barrier that frees this stage
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  if (!active) return;
  bf16* dst_lo = dqkv + ((size_t)b * T + (r_lo < T ? r_lo : 0)) * row_stride;
  bf16* dst_hi = dqkv + ((size_t)b * T + (r_hi < T ? r_hi : 0)) * row_stride;
  store_acc_rows<HD>(acc_v, dst_lo + 2 * D + h * HD, dst_hi + 2 * D + h * HD, r_lo < T,
                     r_hi < T, 1.f);
  store_acc_rows<HD>(acc_k, dst_lo + D + h * HD, dst_hi + D + h * HD, r_lo < T, r_hi < T,
                     scale);
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows: dx = g + rstd * (dxhat - mean(dxhat) -
// xhat * mean(dxhat * xhat)) with dxhat = dxn * gamma, all in fp32. One
// warp per row; also stores the row's mean and rstd for the parameter
// gradients. Bound by bytes (reads x, g bf16 and dxn fp32, writes dx).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32 * LN_ROWS_PER_BLOCK)
ln_bwd_rows(const bf16* __restrict__ x, const bf16* __restrict__ g,
            const float* __restrict__ dxn, const float* __restrict__ gamma,
            bf16* __restrict__ dx, float* __restrict__ row_mean,
            float* __restrict__ row_rstd, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  const bf16* gr = g + (size_t)row * d;
  const float* dr = dxn + (size_t)row * d;
  bf16* yr = dx + (size_t)row * d;

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

  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dh = dr[c + j] * gamma[c + j];
      s1 += dh;
      s2 += dh * ((b2f(e[j]) - mean) * rstd);
    }
  }
  s1 = warp_sum(s1) / d;
  s2 = warp_sum(s2) / d;

  for (int c = lane * 8; c < d; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    uint4 gu = *reinterpret_cast<const uint4*>(gr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    const bf16* ge = reinterpret_cast<const bf16*>(&gu);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xh = (b2f(e[j]) - mean) * rstd;
      const float dh = dr[c + j] * gamma[c + j];
      oe[j] = f2b(b2f(ge[j]) + rstd * (dh - s1 - xh * s2));
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
  if (lane == 0) {
    row_mean[row] = mean;
    row_rstd[row] = rstd;
  }
}

// dgamma = sum_rows dxn * xhat, dbeta = sum_rows dxn, in two deterministic
// stages. Stage 1: a block of (32 columns, 8 row lanes) reduces 256 rows
// and writes partial[chunk][0 | 1][d]. Stage 2 sums the chunks in order.
constexpr int LNG_ROWS = 256, LNG_COLS = 32, LNG_LANES = 8;

__global__ void __launch_bounds__(LNG_COLS * LNG_LANES)
ln_param_grad_partial(const bf16* __restrict__ x, const float* __restrict__ dxn,
                      const float* __restrict__ row_mean,
                      const float* __restrict__ row_rstd, float* __restrict__ partial,
                      int rows, int d) {
  __shared__ float sg[LNG_LANES][LNG_COLS], sb[LNG_LANES][LNG_COLS];
  const int col = blockIdx.x * LNG_COLS + threadIdx.x;
  const int r0 = blockIdx.y * LNG_ROWS;
  const int r1 = min(r0 + LNG_ROWS, rows);
  float ag = 0.f, ab = 0.f;
  for (int row = r0 + threadIdx.y; row < r1; row += LNG_LANES) {
    const float v = dxn[(size_t)row * d + col];
    const float xh = (b2f(x[(size_t)row * d + col]) - row_mean[row]) * row_rstd[row];
    ag += v * xh;
    ab += v;
  }
  sg[threadIdx.y][threadIdx.x] = ag;
  sb[threadIdx.y][threadIdx.x] = ab;
  __syncthreads();
  if (threadIdx.y == 0) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < LNG_LANES; ++i) {
      tg += sg[i][threadIdx.x];
      tb += sb[i][threadIdx.x];
    }
    partial[((size_t)blockIdx.y * 2 + 0) * d + col] = tg;
    partial[((size_t)blockIdx.y * 2 + 1) * d + col] = tb;
  }
}

__global__ void ln_param_grad_reduce(const float* __restrict__ partial,
                                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                                     int chunks, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float tg = 0.f, tb = 0.f;
  for (int c = 0; c < chunks; ++c) {
    tg += partial[((size_t)c * 2 + 0) * d + col];
    tb += partial[((size_t)c * 2 + 1) * d + col];
  }
  dgamma[col] = tg;
  dbeta[col] = tb;
}

// ---------------------------------------------------------------------------
// Host-side launch helpers
// ---------------------------------------------------------------------------
template <int HD>
int launch_attn_bwd_hd(const bf16* qkv, const bf16* d_o, const float* bias, bf16* o,
                       bf16* dqkv, float* stats, bf16* qs, int B, int T, int D, int H,
                       cudaStream_t st) {
  using C = AbCfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_q<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_kv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::KV_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + AB_ROWS - 1) / AB_ROWS, H, B);
  // The scale as the reference passes it: float(hd) ** -0.5 rounded to fp32.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  attn_bwd_q<HD><<<grid, AB_THREADS, C::Q_BYTES, st>>>(qkv, d_o, bias, o, dqkv, stats, qs, T,
                                                        D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv<HD><<<grid, AB_THREADS, C::KV_BYTES, st>>>(qkv, d_o, bias, stats, qs, dqkv, T,
                                                         D, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_attn_bwd(const bf16* qkv, const bf16* d_o, const float* bias, bf16* o, bf16* dqkv,
                    float* stats, bf16* qs, int B, int T, int D, int H, cudaStream_t st) {
  switch (D / H) {
    case 32: return launch_attn_bwd_hd<32>(qkv, d_o, bias, o, dqkv, stats, qs, B, T, D, H, st);
    case 64: return launch_attn_bwd_hd<64>(qkv, d_o, bias, o, dqkv, stats, qs, B, T, D, H, st);
    case 128:
      return launch_attn_bwd_hd<128>(qkv, d_o, bias, o, dqkv, stats, qs, B, T, D, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of 256 that ln_param_grad_partial reduces: the wrapper sizes the
// `partial` scratch as [mt_ln_grad_chunks(B*T), 2, D] fp32.
int mt_ln_grad_chunks(int rows) { return (rows + LNG_ROWS - 1) / LNG_ROWS; }

// The GEMM of gemm_sm90.cuh on its own, for the card tests, in the five
// forms the sublayers run: C = epi(A @ B) with A [M, K] bf16 and bias [N]
// bf16; B [K, N] bf16 under EPI_BIAS, EPI_BIAS_GELU or EPI_BIAS_RESIDUAL
// (res [M, N] bf16; C bf16), or B [N, K] (trans_b) under EPI_NONE (C bf16)
// or EPI_NONE_F32 (C fp32).
int mt_gemm_sm90(const void* A, const void* B, const void* bias, const void* res, void* C,
                 int M, int N, int K, int trans_b, int epi, void* stream) {
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const bf16* bs = static_cast<const bf16*>(bias);
  const bf16* r = static_cast<const bf16*>(res);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi * 2 + (trans_b ? 1 : 0)) {
    case EPI_BIAS * 2: return launch_gemm_sm90<EPI_BIAS>(a, b, bs, r, C, M, N, K, st);
    case EPI_BIAS_GELU * 2: return launch_gemm_sm90<EPI_BIAS_GELU>(a, b, bs, r, C, M, N, K, st);
    case EPI_BIAS_RESIDUAL * 2:
      return launch_gemm_sm90<EPI_BIAS_RESIDUAL>(a, b, bs, r, C, M, N, K, st);
    case EPI_NONE * 2 + 1: return launch_gemm_sm90<EPI_NONE, true>(a, b, bs, r, C, M, N, K, st);
    case EPI_NONE_F32 * 2 + 1:
      return launch_gemm_sm90<EPI_NONE_F32, true>(a, b, bs, r, C, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Outputs: dx, xn, o [B,T,D] and dqkv [B,T,3D] bf16; dgamma, dbeta [D] fp32.
// Scratch (allocated by the caller): qkv [B,T,3D] and d_o [B,T,D] bf16;
// dxn [B,T,D], stats [3,B,H,T], row_stats [2,B*T] and partial
// [chunks,2,D] fp32. D must be a multiple of 128 and D / H one of 32, 64,
// 128.
int mt_attn_sublayer_bwd(const void* x, const void* g, const void* ln_s, const void* ln_b,
                         const void* wqkv, const void* bqkv, const void* wproj,
                         const void* bias, void* dx, void* dqkv, void* xn, void* o,
                         void* dgamma, void* dbeta, void* qkv, void* d_o, void* dxn,
                         void* stats, void* row_stats, void* partial, int B, int T, int D,
                         int H, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  float* dxn_f = static_cast<float*>(dxn);
  float* row_mean = static_cast<float*>(row_stats);
  float* row_rstd = row_mean + M;

  int rc = launch_layer_norm(xb, static_cast<const float*>(ln_s),
                             static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, D,
                             eps, st);
  if (rc) return rc;
  rc = launch_gemm_sm90<EPI_BIAS>(static_cast<const bf16*>(xn), wq,
                                  static_cast<const bf16*>(bqkv), nullptr, qkv, M, 3 * D, D, st);
  if (rc) return rc;
  rc = launch_gemm_sm90<EPI_NONE, true>(gb, static_cast<const bf16*>(wproj), nullptr, nullptr,
                                        d_o, M, D, D, st);
  if (rc) return rc;
  // q * scale passes from attn_bwd_q to attn_bwd_kv through the dxn scratch
  // (as bf16 [B*T, D]); the dxn GEMM below overwrites it.
  rc = launch_attn_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(d_o),
                       static_cast<const float*>(bias), static_cast<bf16*>(o),
                       static_cast<bf16*>(dqkv), static_cast<float*>(stats),
                       static_cast<bf16*>(dxn), B, T, D, H, st);
  if (rc) return rc;
  rc = launch_gemm_sm90<EPI_NONE_F32, true>(static_cast<const bf16*>(dqkv), wq, nullptr,
                                            nullptr, dxn, M, D, 3 * D, st);
  if (rc) return rc;
  const int ln_blocks = (M + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK;
  ln_bwd_rows<<<ln_blocks, 32 * LN_ROWS_PER_BLOCK, 0, st>>>(
      xb, gb, dxn_f, static_cast<const float*>(ln_s), static_cast<bf16*>(dx), row_mean,
      row_rstd, M, D, eps);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const int chunks = mt_ln_grad_chunks(M);
  ln_param_grad_partial<<<dim3(D / LNG_COLS, chunks), dim3(LNG_COLS, LNG_LANES), 0, st>>>(
      xb, dxn_f, row_mean, row_rstd, static_cast<float*>(partial), M, D);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  ln_param_grad_reduce<<<(D + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), chunks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
