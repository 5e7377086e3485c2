// Flash-attention forward for bf16 inputs on Hopper (sm_90a), on wgmma.
//
// One public entry point with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/flash_attention.py. It is one launch and
// replaces the Pallas kernel `_fwd_kernel` of
// metatransformer_tpu/ops/flash_attention.py (:70, launched by
// `_flash_fwd_raw` at :110):
//
//   mt_flash_fwd   o = softmax(q k^T scale + bias) v over [B, T, H, d],
//                  and lse = m + log l per row, [B, H, T] fp32.
//
// The fp32 forward (plain FMAs, the video-MAE decoder) stays in
// flash_attention.cu as mt_flash_fwd_f32; every call takes exactly one of
// the two by its element type.
//
// Numerics as the Pallas kernel and the plain version: logits q . k
// accumulated in fp32, times scale, plus the additive key bias; the row max
// m, the row sum l and the output accumulator are fp32 and updated online,
// tile by tile; p is rounded to bf16 unnormalised before p v; the output is
// divided by max(l, 1e-30) after the last tile and rounded once. The
// exponent is taken base 2: p = 2^(fma(s, scale log2e, bias log2e) - m),
// with m kept in log2 units, which moves bf16 rounding only.
//
// What bounds it: at the video path's shapes (T = 1568, head_dim 64,
// B*H = 96) it does 60 GFLOP over 77 MB, so tensor-core operations, not
// bytes.
//
// Design (the simplest user of wgmma.cuh; the backward's scheme):
//  * A block is two consumer warpgroups (256 threads) and owns 128 query
//    rows of one (sample, head), 64 a warpgroup. Q is loaded once into a
//    128-byte-swizzled tile. K and V stream through a two-stage cp.async ring
//    of FW_KEYS-row tiles: the copy of tile j+1 is issued before the products
//    of tile j and waited for at the top of the next iteration, behind one
//    barrier.
//  * S = Q K^T is a wgmma with both operands K-major in shared memory. The
//    softmax runs in the accumulator registers: a row's max and sum are
//    taken across the four threads that hold it (two shuffles).
//  * O += P V: P is rounded to bf16 and repacked in registers as the A
//    operand (the accumulator layout of a 64 x 16 slice is the A fragment
//    layout); V is read MN-major (the transpose bit) from the same swizzled
//    tile the copy filled. O is an fp32 accumulator in registers, rescaled
//    by alpha = 2^(m_old - m_new) for each row. Nothing of size [queries,
//    keys] touches shared memory.
//  * Infinities. Keys past T get bias -inf (p = 0). Masked keys carry the
//    caller's -1e30, finite, so every tile holds a finite logit and the
//    running max is finite after the first tile: a fully masked sample
//    gives p = 1 over its T real keys, as the plain version does. Query rows
//    past T are computed on zero rows and not stored.
//  * Writing out: o = acc / max(l, 1e-30), rounded once and written from
//    registers as bf16 pairs; the first thread of each row writes lse.
//  * Determinism: fixed order, no atomics; a second launch is bit-equal.

#include "wgmma.cuh"

namespace {

constexpr int FW_THREADS = 256;  // two consumer warpgroups
constexpr int FW_ROWS = 128;     // query rows of a block, 64 a warpgroup
constexpr int FW_KEYS = 64;      // keys of a streamed tile
constexpr int FW_STAGES = 2;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct FwCfg {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head_dim 32, 64 or 128");
  static constexpr int HDP = HD < 64 ? 64 : HD;  // stored width: whole 64-column blocks
  static constexpr int Q_BYTES = FW_ROWS * HDP * 2;
  static constexpr int TILE_BYTES = FW_KEYS * HDP * 2;
  // Q, then K and V of every stage, then each stage's key biases; 1024 bytes
  // of slack to align the swizzle atoms.
  static constexpr int BYTES =
      Q_BYTES + FW_STAGES * 2 * TILE_BYTES + FW_STAGES * FW_KEYS * 4 + 1024;
  static constexpr int ACC = HDP / 2;  // fp32 accumulator registers of a 64 x HDP product
};

// ---------------------------------------------------------------------------
// One block per (128 queries, head, sample). q, k, v are [B, T, H, HD] by
// strides (sb, st, sh, 1); o is contiguous [B, T, H, HD]; lse [B, H, T].
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                bf16* __restrict__ o, float* __restrict__ lse, int Tlen, long long sb,
                long long st, long long sh, float scale) {
  using C = FwCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t Qs = smem_u32(smem);
  const uint32_t tiles = Qs + C::Q_BYTES;  // stage s: K at tiles + 2s TILE, V after it
  float* kbias = reinterpret_cast<float*>(smem + C::Q_BYTES + FW_STAGES * 2 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * FW_ROWS, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const int nkt = (Tlen + FW_KEYS - 1) / FW_KEYS;

  zero_pad<HD>(smem, FW_ROWS);
  for (int s = 0; s < 2 * FW_STAGES; ++s)
    zero_pad<HD>(smem + C::Q_BYTES + s * C::TILE_BYTES, FW_KEYS);

  load_rows<HD>(Qs, FW_ROWS, q + head, st, q0, FW_ROWS, Tlen);
  auto load_stage = [&](int s, int k0) {
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES;
    load_rows<HD>(ks, FW_KEYS, k + head, st, k0, FW_KEYS, Tlen);
    load_rows<HD>(ks + C::TILE_BYTES, FW_KEYS, v + head, st, k0, FW_KEYS, Tlen);
    if (bias && tid < FW_KEYS) {
      const int t = k0 + tid;
      const bool ok = t < Tlen;
      cp_async4_s(smem_u32(kbias + s * FW_KEYS + tid),
                  bias + (long long)b * Tlen + (ok ? t : 0), ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  // This thread's two query rows and its key columns c, c + 1 of each
  // 8-column group.
  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int col = (lane & 3) * 2;
  const float L = LOG2E, scale_l = scale * LOG2E;
  const bool active = q0 + wg * 64 < Tlen;  // a warpgroup past T only keeps the ring going

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<0>();  // tile it (and, first, Q) has landed
    fence_proxy_async();
    __syncthreads();  // ...for every thread; tile it-1 is consumed, its stage free
    if (it + 1 < nkt) load_stage((it + 1) & 1, (it + 1) * FW_KEYS);
    cp_async_commit();
    if (!active) continue;

    const int s = it & 1, k0 = it * FW_KEYS;
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES, vs = ks + C::TILE_BYTES;
    const float* kb_s = kbias + s * FW_KEYS;
    float sv[FW_KEYS / 2];
    wgmma_fence();
    product_ss<HD>(sv, Qs, FW_ROWS, wg * 64, ks, FW_KEYS);  // s = q k^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<0>();
    fence_regs(sv);

    float tm_lo = -INFINITY, tm_hi = -INFINITY;
#pragma unroll
    for (int n8 = 0; n8 < FW_KEYS / 8; ++n8) {
      const int c = n8 * 8 + col;
      float ka = bias ? kb_s[c] * L : 0.f, kb = bias ? kb_s[c + 1] * L : 0.f;
      if (k0 + c >= Tlen) ka = -INFINITY;
      if (k0 + c + 1 >= Tlen) kb = -INFINITY;
      sv[4 * n8 + 0] = fmaf(sv[4 * n8 + 0], scale_l, ka);
      sv[4 * n8 + 1] = fmaf(sv[4 * n8 + 1], scale_l, kb);
      sv[4 * n8 + 2] = fmaf(sv[4 * n8 + 2], scale_l, ka);
      sv[4 * n8 + 3] = fmaf(sv[4 * n8 + 3], scale_l, kb);
      tm_lo = fmaxf(tm_lo, fmaxf(sv[4 * n8 + 0], sv[4 * n8 + 1]));
      tm_hi = fmaxf(tm_hi, fmaxf(sv[4 * n8 + 2], sv[4 * n8 + 3]));
    }
    // finite: every tile holds a key < T
    const float mn_lo = fmaxf(m_lo, quad_max(tm_lo)), mn_hi = fmaxf(m_hi, quad_max(tm_hi));
    const float alpha_lo = ex2(m_lo - mn_lo), alpha_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo, m_hi = mn_hi;
    float ls_lo = 0.f, ls_hi = 0.f;
    uint32_t pf[FW_KEYS / 4];
#pragma unroll
    for (int n8 = 0; n8 < FW_KEYS / 8; ++n8) {
      const float p0 = ex2(sv[4 * n8 + 0] - mn_lo), p1 = ex2(sv[4 * n8 + 1] - mn_lo);
      const float p2 = ex2(sv[4 * n8 + 2] - mn_hi), p3 = ex2(sv[4 * n8 + 3] - mn_hi);
      ls_lo += p0 + p1;
      ls_hi += p2 + p3;
      pf[2 * n8] = pack_bf16(p0, p1);
      pf[2 * n8 + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * alpha_lo + ls_lo;
    l_hi = l_hi * alpha_hi + ls_hi;
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] *= (i & 2) ? alpha_hi : alpha_lo;
    wgmma_fence();
    fence_regs(acc);
    product_rs<C::HDP, FW_KEYS>(acc, pf, vs);  // o += p v
    wgmma_commit();
    wgmma_wait<0>();  // before the barrier that frees this stage
    fence_regs(acc);
  }

  if (!active) return;
  const float ll[2] = {fmaxf(quad_sum(l_lo), 1e-30f), fmaxf(quad_sum(l_hi), 1e-30f)};
  const float mm[2] = {m_lo, m_hi};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? r_hi : r_lo;
    if (t >= Tlen) continue;
    const float inv = 1.f / ll[half];
    bf16* dst = o + (((long long)b * Tlen + t) * H + h) * HD + col;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int i = 4 * n8 + 2 * half;
      *reinterpret_cast<uint32_t*>(dst + n8 * 8) = pack_bf16(acc[i] * inv, acc[i + 1] * inv);
    }
    if ((lane & 3) == 0) lse[((long long)b * H + h) * Tlen + t] = mm[half] * LN2 + logf(ll[half]);
  }
}

template <int HD>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* o,
               float* lse, int B, int T, int H, long long sb, long long st, long long sh,
               float scale, cudaStream_t stream) {
  constexpr int bytes = FwCfg<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + FW_ROWS - 1) / FW_ROWS, H, B);
  flash_fwd_wgmma<HD><<<grid, FW_THREADS, bytes, stream>>>(q, k, v, bias, o, lse, T, sb, st,
                                                           sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: [B, T, H, hd] bf16 with element strides (sb, st, sh, 1); bias:
// [B, T] fp32 or null. Outputs: o contiguous [B, T, H, hd] bf16, lse
// [B, H, T] fp32. is_fp32 must be 0 (fp32: mt_flash_fwd_f32 of
// flash_attention.cu).
int mt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                 void* lse, int B, int T, int H, int hd, long long sb, long long st,
                 long long sh, float scale, int is_fp32, void* stream) {
  if (is_fp32 || B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto launch) {
    return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(bias),
                  static_cast<bf16*>(o), static_cast<float*>(lse), B, T, H, sb, st, sh, scale,
                  static_cast<cudaStream_t>(stream));
  };
  switch (hd) {
    case 32: return run(launch_fwd<32>);
    case 64: return run(launch_fwd<64>);
    case 128: return run(launch_fwd<128>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
