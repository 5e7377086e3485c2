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
//   layer_norm_rows                xn = LN(x)
//   gemm_bf16<EPI_BIAS>            qkv = xn Wqkv + bqkv
//   gemm_bf16<EPI_NONE, T>         do = g Wproj^T
//   attn_bwd_q                     o, dq and the row statistics (m, 1/l, delta)
//   attn_bwd_kv                    dk, dv
//   gemm_bf16<EPI_NONE_F32, T>     dxn = dqkv Wqkv^T (fp32)
//   ln_bwd_rows                    dx = g + LN backward, row mean / rstd
//   ln_param_grad_partial / _reduce   dgamma, dbeta
//
// Numerics follow the Pallas kernel's cast points: LN in fp32; qkv, do
// rounded to bf16; s = bf16(q * scale) k^T + bias in fp32; p = softmax(s)
// in fp32 and pb = bf16(p); o = pb v; dv = pb^T do; dp = do v^T;
// ds = bf16(p * (dp - rowsum(dp * p))); dq = ds k * scale; dk = ds^T q *
// scale with the unscaled q; dxn and the LN backward in fp32. rowsum(dp * p)
// is formed from the fp32 p, as the reference does (not from do . o, whose o
// went through bf16(p)); it is accumulated as sum(dp * e) / l beside
// l = sum(e), which differs from the reference only in fp32 rounding.
//
// What bounds it: at the main path's shapes (B = 128, T = 197, D = 768,
// H = 12) it does 254 GFLOP over 0.31 GB, so tensor-core operations, not
// bytes. Design notes:
//  * No sequential grid. The TPU kernel ran one program per 1-2 samples, in
//    order, and carried dgamma / dbeta from program to program. Here the
//    row-parallel parts tile over all B*T rows, and dgamma / dbeta are a
//    two-stage reduction (per-256-row partials, then one pass over the
//    partials in a fixed order): deterministic, no atomics.
//  * Transposed operands. The two products against W^T read the
//    untransposed weight through a col_major B fragment (common.cuh).
//  * Two accumulation directions. dq sums over keys, dk / dv over queries:
//    two launches in the FlashAttention-2 manner. attn_bwd_q (one block per
//    query tile, head, sample) streams key tiles twice: pass A takes the row
//    max online and accumulates l and sum(dp * e); pass B forms p, pb, ds
//    and accumulates o and dq. It stores the three row statistics, which
//    attn_bwd_kv (one block per key tile) reads while it streams query
//    tiles and accumulates dv and dk. Every [T, T] quantity stays in shared
//    memory; tiles are 64 x head_dim, so T = 512, head_dim = 128 fits.
//  * Ragged T and masks. Keys past T get a bias of -inf (probability 0 in
//    p, ds, dv); masked keys get the caller's additive -1e30, so a fully
//    masked sample gives a uniform p and no NaN. Query rows past T are
//    computed on zeros and never stored.

#include "common.cuh"

namespace {

constexpr int AB_TILE = 64;  // queries and keys per tile
constexpr int AB_THREADS = 128;

template <int HD>
struct AttnBwdSmem {
  static constexpr int LD = HD + 8;    // q/k/v/do rows (bf16)
  static constexpr int S_LD = 68;      // logits rows (fp32)
  static constexpr int P_LD = 72;      // probabilities rows (bf16)
  static constexpr int O_LD = HD + 4;  // staged output rows (fp32)
  static constexpr int TILE_BYTES = AB_TILE * LD * 2;
  // Per warp: s | dp (fp32, contiguous: together they also stage one
  // [16, HD] fp32 output) and p | ds (bf16).
  static constexpr int WARP_F32_BYTES = 2 * 16 * S_LD * 4;
  static constexpr int WARP_BF16_BYTES = 2 * 16 * P_LD * 2;
  static_assert(16 * O_LD * 4 <= WARP_F32_BYTES, "output staging must fit in s | dp");
  static constexpr int WARPS = AB_THREADS / 32;
  static constexpr int bytes(int tiles, int row_vectors) {
    return tiles * TILE_BYTES + WARPS * (WARP_F32_BYTES + WARP_BF16_BYTES) +
           row_vectors * AB_TILE * 4;
  }
};

// Load a [64, HD] tile of head `col` columns from rows t0.. of a [T, stride]
// slab into shared memory, zero-filling rows past T; optionally scale each
// element in fp32 and round back to bf16 (the reference's q * scale).
template <int HD, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int col,
                                          int t0, int T, float scale) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = threadIdx.x; c < AB_TILE * CH; c += AB_THREADS) {
    const int r = c / CH, cc = (c % CH) * 8, t = t0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < T) {
      u = *reinterpret_cast<const uint4*>(src + (size_t)t * stride + col + cc);
      if (SCALE) {
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = f2b(b2f(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = u;
  }
}

// dst[16, 64] (fp32, ld 68) = a_rows[16, HD] . b_tile[64, HD]^T, one warp.
template <int HD>
__device__ __forceinline__ void tile_product(float* dst, const bf16* a_rows,
                                             const bf16* b_tile) {
  constexpr int LD = HD + 8, S_LD = AttnBwdSmem<HD>::S_LD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, a_rows + kk, LD);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, b_tile + n * 16 * LD + kk, LD);
      wmma::mma_sync(acc[n], a, bfr, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(dst + n * 16, acc[n], S_LD, wmma::mem_row_major);
}

// acc[HD/16] += a[16, 64] (bf16, ld 72) . b_tile[64, HD], one warp.
template <int HD>
__device__ __forceinline__ void accumulate_product(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* a,
    const bf16* b_tile) {
  constexpr int LD = HD + 8, P_LD = AttnBwdSmem<HD>::P_LD;
#pragma unroll
  for (int kk = 0; kk < AB_TILE; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk, P_LD);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b_tile + kk * LD + n * 16, LD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
}

// Stage a warp's [16, HD] accumulators through `stage` and store row r of
// them (times mul, rounded to bf16) at dst, if `valid`. A lane pair owns a
// row; each lane writes HD/2 values in 16-byte chunks.
template <int HD>
__device__ __forceinline__ void store_rows(
    float* stage, const wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, bf16* dst,
    bool valid, float mul) {
  constexpr int O_LD = AttnBwdSmem<HD>::O_LD;
  const int lane = threadIdx.x & 31, r = lane >> 1, c_lo = (lane & 1) * (HD / 2);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], O_LD, wmma::mem_row_major);
  __syncwarp();
  if (valid) {
#pragma unroll
    for (int c = c_lo; c < c_lo + HD / 2; c += 8) {
      uint4 ov;
      bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int j = 0; j < 8; ++j) oe[j] = f2b(stage[r * O_LD + c + j] * mul);
      *reinterpret_cast<uint4*>(dst + c) = ov;
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// attn_bwd_q: one block per (query tile of 64, head, sample); a warp owns 16
// query rows, a lane pair one row (32 keys of each tile per lane). Emits o,
// dq (into dqkv's q columns) and the row statistics m, 1/l, delta.
// stats is [3][B*H*T] fp32.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(AB_THREADS)
attn_bwd_q(const bf16* __restrict__ qkv, const bf16* __restrict__ d_o,
           const float* __restrict__ bias, bf16* __restrict__ o_out,
           bf16* __restrict__ dqkv, float* __restrict__ stats, int T, int D, float scale) {
  using L = AttnBwdSmem<HD>;
  constexpr int LD = L::LD, S_LD = L::S_LD, P_LD = L::P_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + AB_TILE * LD;
  bf16* Ks = dOs + AB_TILE * LD;
  bf16* Vs = Ks + AB_TILE * LD;
  unsigned char* warp_base = smem + 4 * L::TILE_BYTES;
  float* kb = reinterpret_cast<float*>(warp_base +
                                       L::WARPS * (L::WARP_F32_BYTES + L::WARP_BF16_BYTES));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const bf16* do_base = d_o + (size_t)b * T * D;
  const int qcol = h * HD, kcol = D + h * HD, vcol = 2 * D + h * HD;

  float* ws = reinterpret_cast<float*>(warp_base + warp * L::WARP_F32_BYTES);
  float* wdp = ws + 16 * S_LD;
  bf16* wp = reinterpret_cast<bf16*>(warp_base + L::WARPS * L::WARP_F32_BYTES +
                                     warp * L::WARP_BF16_BYTES);
  bf16* wds = wp + 16 * P_LD;
  const bf16* wq = Qs + warp * 16 * LD;
  const bf16* wdo = dOs + warp * 16 * LD;
  const int r = lane >> 1, half = (lane & 1) * 32;

  load_tile<HD, true>(Qs, base, row_stride, qcol, q0, T, scale);
  load_tile<HD, false>(dOs, do_base, (size_t)D, h * HD, q0, T, 1.f);

  auto load_keys = [&](int k0) {
    load_tile<HD, false>(Ks, base, row_stride, kcol, k0, T, 1.f);
    load_tile<HD, false>(Vs, base, row_stride, vcol, k0, T, 1.f);
    for (int c = tid; c < AB_TILE; c += AB_THREADS) {
      const int t = k0 + c;
      kb[c] = t < T ? (bias ? bias[(size_t)b * T + t] : 0.f) : -INFINITY;
    }
  };
  const int nkt = (T + AB_TILE - 1) / AB_TILE;

  // Pass A: row max (online), l = sum e, dsum = sum dp * e.
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // previous tile fully consumed
    load_keys(kt * AB_TILE);
    __syncthreads();
    tile_product<HD>(ws, wq, Ks);    // s = q k^T
    tile_product<HD>(wdp, wdo, Vs);  // dp = do v^T
    __syncwarp();
    float tm = -INFINITY;
    for (int c = half; c < half + 32; ++c) tm = fmaxf(tm, ws[r * S_LD + c] + kb[c]);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float m_new = fmaxf(m, tm);  // finite: every tile holds a key < T
    const float corr = expf(m - m_new);
    l *= corr;
    dsum *= corr;
    for (int c = half; c < half + 32; ++c) {
      const float e = expf(ws[r * S_LD + c] + kb[c] - m_new);
      l += e;
      dsum += e * wdp[r * S_LD + c];
    }
    m = m_new;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  const float inv_l = 1.f / l;
  const float delta = dsum * inv_l;  // rowsum(dp * p)

  const int t = q0 + warp * 16 + r;
  if (t < T && (lane & 1) == 0) {
    const size_t plane = (size_t)gridDim.z * H * T;
    const size_t idx = ((size_t)b * H + h) * T + t;
    stats[idx] = m;
    stats[plane + idx] = inv_l;
    stats[2 * plane + idx] = delta;
  }

  // Pass B: p, pb, ds; o += pb v, dq += ds k.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16], dq[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(o[n], 0.f);
    wmma::fill_fragment(dq[n], 0.f);
  }
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_keys(kt * AB_TILE);
    __syncthreads();
    tile_product<HD>(ws, wq, Ks);
    tile_product<HD>(wdp, wdo, Vs);
    __syncwarp();
    for (int c = half; c < half + 32; ++c) {
      const float p = expf(ws[r * S_LD + c] + kb[c] - m) * inv_l;
      wp[r * P_LD + c] = f2b(p);
      wds[r * P_LD + c] = f2b(p * (wdp[r * S_LD + c] - delta));
    }
    __syncwarp();
    accumulate_product<HD>(o, wp, Vs);
    accumulate_product<HD>(dq, wds, Ks);
  }

  const bool valid = t < T;
  const size_t row = (size_t)b * T + (valid ? t : 0);
  store_rows<HD>(ws, o, o_out + row * D + h * HD, valid, 1.f);
  store_rows<HD>(ws, dq, dqkv + row * row_stride + qcol, valid, scale);
}

// ---------------------------------------------------------------------------
// attn_bwd_kv: one block per (key tile of 64, head, sample); a warp owns 16
// keys and works on the transposed tiles s^T, dp^T [16 keys, 64 queries], so
// dv = pb^T do and dk = ds^T q are plain row-major products. Emits dk and dv
// into dqkv's k and v columns.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(AB_THREADS)
attn_bwd_kv(const bf16* __restrict__ qkv, const bf16* __restrict__ d_o,
            const float* __restrict__ bias, const float* __restrict__ stats,
            bf16* __restrict__ dqkv, int T, int D, float scale) {
  using L = AttnBwdSmem<HD>;
  constexpr int LD = L::LD, S_LD = L::S_LD, P_LD = L::P_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + AB_TILE * LD;
  bf16* Qs = Vs + AB_TILE * LD;  // q * scale, rounded: the logits' operand
  bf16* Qr = Qs + AB_TILE * LD;  // q as stored: dk's operand
  bf16* dOs = Qr + AB_TILE * LD;
  unsigned char* warp_base = smem + 5 * L::TILE_BYTES;
  float* kb = reinterpret_cast<float*>(warp_base +
                                       L::WARPS * (L::WARP_F32_BYTES + L::WARP_BF16_BYTES));
  float* st_m = kb + AB_TILE;
  float* st_il = st_m + AB_TILE;
  float* st_dl = st_il + AB_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * AB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const bf16* do_base = d_o + (size_t)b * T * D;
  const int qcol = h * HD, kcol = D + h * HD, vcol = 2 * D + h * HD;
  const size_t plane = (size_t)gridDim.z * H * T;
  const float* st_base = stats + ((size_t)b * H + h) * T;

  float* ws = reinterpret_cast<float*>(warp_base + warp * L::WARP_F32_BYTES);
  float* wdp = ws + 16 * S_LD;
  bf16* wp = reinterpret_cast<bf16*>(warp_base + L::WARPS * L::WARP_F32_BYTES +
                                     warp * L::WARP_BF16_BYTES);
  bf16* wds = wp + 16 * P_LD;
  const bf16* wk = Ks + warp * 16 * LD;
  const bf16* wv = Vs + warp * 16 * LD;
  const int r = lane >> 1, half = (lane & 1) * 32;

  load_tile<HD, false>(Ks, base, row_stride, kcol, k0, T, 1.f);
  load_tile<HD, false>(Vs, base, row_stride, vcol, k0, T, 1.f);
  for (int c = tid; c < AB_TILE; c += AB_THREADS) {
    const int t = k0 + c;
    kb[c] = t < T ? (bias ? bias[(size_t)b * T + t] : 0.f) : -INFINITY;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv[HD / 16], dk[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dv[n], 0.f);
    wmma::fill_fragment(dk[n], 0.f);
  }

  const int nqt = (T + AB_TILE - 1) / AB_TILE;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * AB_TILE;
    __syncthreads();  // previous query tile fully consumed
    load_tile<HD, true>(Qs, base, row_stride, qcol, q0, T, scale);
    load_tile<HD, false>(Qr, base, row_stride, qcol, q0, T, 1.f);
    load_tile<HD, false>(dOs, do_base, (size_t)D, h * HD, q0, T, 1.f);
    for (int c = tid; c < AB_TILE; c += AB_THREADS) {
      const int t = q0 + c;
      const bool ok = t < T;  // rows past T: probability 0
      st_m[c] = ok ? st_base[t] : 0.f;
      st_il[c] = ok ? st_base[plane + t] : 0.f;
      st_dl[c] = ok ? st_base[2 * plane + t] : 0.f;
    }
    __syncthreads();
    tile_product<HD>(ws, wk, Qs);    // s^T = k (q * scale)^T
    tile_product<HD>(wdp, wv, dOs);  // dp^T = v do^T
    __syncwarp();
    const float kbr = kb[warp * 16 + r];
    for (int c = half; c < half + 32; ++c) {
      const float p = expf(ws[r * S_LD + c] + kbr - st_m[c]) * st_il[c];
      wp[r * P_LD + c] = f2b(p);
      wds[r * P_LD + c] = f2b(p * (wdp[r * S_LD + c] - st_dl[c]));
    }
    __syncwarp();
    accumulate_product<HD>(dv, wp, dOs);  // dv += pb^T do
    accumulate_product<HD>(dk, wds, Qr);  // dk += ds^T q
  }

  const int t = k0 + warp * 16 + r;
  const bool valid = t < T;
  bf16* dst = dqkv + ((size_t)b * T + (valid ? t : 0)) * row_stride;
  store_rows<HD>(ws, dv, dst + vcol, valid, 1.f);
  store_rows<HD>(ws, dk, dst + kcol, valid, scale);
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
                       bf16* dqkv, float* stats, int B, int T, int D, int H,
                       cudaStream_t st) {
  using L = AttnBwdSmem<HD>;
  constexpr int q_bytes = L::bytes(4, 1), kv_bytes = L::bytes(5, 4);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_q<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_kv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + AB_TILE - 1) / AB_TILE, H, B);
  // The scale as the reference passes it: float(hd) ** -0.5 rounded to fp32.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  attn_bwd_q<HD><<<grid, AB_THREADS, q_bytes, st>>>(qkv, d_o, bias, o, dqkv, stats, T, D,
                                                    scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv<HD><<<grid, AB_THREADS, kv_bytes, st>>>(qkv, d_o, bias, stats, dqkv, T, D,
                                                      scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_attn_bwd(const bf16* qkv, const bf16* d_o, const float* bias, bf16* o, bf16* dqkv,
                    float* stats, int B, int T, int D, int H, cudaStream_t st) {
  switch (D / H) {
    case 32: return launch_attn_bwd_hd<32>(qkv, d_o, bias, o, dqkv, stats, B, T, D, H, st);
    case 64: return launch_attn_bwd_hd<64>(qkv, d_o, bias, o, dqkv, stats, B, T, D, H, st);
    case 128: return launch_attn_bwd_hd<128>(qkv, d_o, bias, o, dqkv, stats, B, T, D, H, st);
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

// Outputs: dx, xn, o [B,T,D] and dqkv [B,T,3D] bf16; dgamma, dbeta [D] fp32.
// Scratch (allocated by the caller): qkv [B,T,3D] and d_o [B,T,D] bf16;
// dxn [B,T,D], stats [3,B,H,T], row_stats [2,B*T] and partial
// [chunks,2,D] fp32.
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
  rc = launch_gemm<EPI_BIAS>(static_cast<const bf16*>(xn), wq,
                             static_cast<const bf16*>(bqkv), nullptr, qkv, M, 3 * D, D, st);
  if (rc) return rc;
  rc = launch_gemm<EPI_NONE, true>(gb, static_cast<const bf16*>(wproj), nullptr, nullptr, d_o,
                                   M, D, D, st);
  if (rc) return rc;
  rc = launch_attn_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(d_o),
                       static_cast<const float*>(bias), static_cast<bf16*>(o),
                       static_cast<bf16*>(dqkv), static_cast<float*>(stats), B, T, D, H, st);
  if (rc) return rc;
  rc = launch_gemm<EPI_NONE_F32, true>(static_cast<const bf16*>(dqkv), wq, nullptr, nullptr,
                                       dxn, M, D, 3 * D, st);
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
