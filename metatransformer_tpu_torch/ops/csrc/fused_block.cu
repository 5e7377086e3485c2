// Fused transformer sublayers for Hopper (sm_90a), forward only, on wgmma.
//
// Two public entry points with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/fused_block.py:
//
//   mt_attn_sublayer: out = x + proj(MHSA(LN(x)))
//     replaces the Pallas kernel metatransformer_tpu/ops/fused_block.py
//     `_kernel` (:82). A chain of four launches on the caller's stream:
//     layer_norm_rows -> gemm_sm90<EPI_BIAS> (QKV) -> attn_core ->
//     gemm_sm90<EPI_BIAS_RESIDUAL> (proj + residual).
//
//   mt_mlp_sublayer: out = x + fc2(GELU(fc1(LN(x))))
//     replaces `_mlp_kernel` (:562). Three launches: layer_norm_rows ->
//     gemm_sm90<EPI_BIAS_GELU> (fc1) -> gemm_sm90<EPI_BIAS_RESIDUAL> (fc2).
//     GELU is exact erf, as core/encoder.py's mlp and timm use. The Pallas
//     kernel took the tanh form only because erf has no Pallas TPU
//     lowering; this is a deliberate difference from that kernel.
//
// and, for the card tests, the attention core alone (mt_attn_core).
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
// B*T rows and the attention core runs one block per (128 queries, head,
// sample). The row LayerNorm is in common.cuh; the GEMM is gemm_sm90.cuh,
// shared with the backward (fused_block_bwd.cu), which reads the [K, N]
// weights as they are stored (MN-major, the transpose bit) and applies the
// bias, GELU and residual in its accumulator registers. Each entry point
// returns cudaGetLastError() after its launches.

#include "gemm_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// Attention core: o[b, t, h*HD:(h+1)*HD] = softmax(bf16(q scale) k^T + bias) v
// for one (128 queries, head, sample) per block, reading q/k/v straight out
// of the fused [B, T, 3D] QKV slab (columns (q|k|v) x heads).
//
// What bounds it: at T = 197, head_dim 64, B*H = 1536 the function is 15.3
// GFLOP (S and P.V; 22.9 with S run twice) over 0.16 GB of QKV and output:
// tensor-core operations by the count, but small products whose chain of
// wgmma issue and waits, not the tensor-core peak, sets the time.
//
// Design (the layout of flash_attention_fwd.cu; wgmma.cuh's blocks):
//  * Two consumer warpgroups of 64 query rows. Q is read from the slab,
//    scaled in fp32, rounded to bf16 and stored into a 128-byte-swizzled
//    tile once. K (and in the second pass V) stream through a two-stage
//    cp.async ring of 64-key tiles with their key biases.
//  * The Pallas kernel's numerics, no online softmax. Pass 1 runs
//    S = Q K^T by wgmma (both operands K-major) over every key tile and
//    takes the global row max in registers (a row lives in the four threads
//    of a quad: two shuffles). Pass 2 runs S again, forms p = 2^(s - m) in
//    fp32 (logits in log2 units, which moves fp32 rounding only), sums the
//    unrounded p into l, rounds p to bf16 and repacks it in registers as the
//    A operand of O += P V, with V read MN-major from its swizzled tile.
//    Nothing of size [queries, keys] touches shared memory.
//  * Keys past T get -inf (p = 0); masked keys carry the caller's finite
//    -1e30, so a fully masked sample gets p = 1 over its T real keys, as
//    the plain version does. Query rows past T are computed on zero rows and
//    not stored.
//  * o / l is rounded once and written from registers as bf16 pairs into
//    [B, T, D] at column h * HD. head_dim 32 is padded to one 64-column
//    block (zeros that no copy writes). Fixed order, no atomics: a second
//    launch is bit-equal.
// ---------------------------------------------------------------------------
constexpr int AC_THREADS = 256;  // two consumer warpgroups
constexpr int AC_ROWS = 128;     // query rows of a block, 64 a warpgroup
constexpr int AC_KEYS = 64;      // keys of a streamed tile
constexpr int AC_STAGES = 2;

template <int HD>
struct AcCfg {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head_dim 32, 64 or 128");
  static constexpr int HDP = HD < 64 ? 64 : HD;  // stored width: whole 64-column blocks
  static constexpr int Q_BYTES = AC_ROWS * HDP * 2;
  static constexpr int TILE_BYTES = AC_KEYS * HDP * 2;
  // Q, then K and V of every stage, then each stage's key biases; 1024 bytes
  // of slack to align the swizzle atoms.
  static constexpr int BYTES =
      Q_BYTES + AC_STAGES * 2 * TILE_BYTES + AC_STAGES * AC_KEYS * 4 + 1024;
  static constexpr int ACC = HDP / 2;  // fp32 accumulator registers of a 64 x HDP product
};

template <int HD>
__global__ void __launch_bounds__(AC_THREADS, 1)
attn_core(const bf16* __restrict__ qkv, const float* __restrict__ bias,
          bf16* __restrict__ out, int T, int D, float scale) {
  using C = AcCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t Qs = smem_u32(smem);
  const uint32_t tiles = Qs + C::Q_BYTES;  // stage s: K at tiles + 2s TILE, V after it
  float* kbias = reinterpret_cast<float*>(smem + C::Q_BYTES + AC_STAGES * 2 * C::TILE_BYTES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * AC_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const int nkt = (T + AC_KEYS - 1) / AC_KEYS;

  zero_pad<HD>(smem, AC_ROWS);
  for (int s = 0; s < 2 * AC_STAGES; ++s)
    zero_pad<HD>(smem + C::Q_BYTES + s * C::TILE_BYTES, AC_KEYS);

  load_scaled_q<HD, AC_ROWS, AC_THREADS>(smem, base + h * HD, row_stride, nullptr, D, q0, T,
                                         scale);
  // Step `it` of the two passes: key tile it % nkt; V only in pass 2.
  auto load_stage = [&](int s, int it) {
    const int k0 = (it % nkt) * AC_KEYS;
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES;
    load_rows<HD>(ks, AC_KEYS, base + D + h * HD, row_stride, k0, AC_KEYS, T);
    if (it >= nkt)
      load_rows<HD>(ks + C::TILE_BYTES, AC_KEYS, base + 2 * D + h * HD, row_stride, k0,
                    AC_KEYS, T);
    if (bias && tid < AC_KEYS) {
      const int t = k0 + tid;
      const bool ok = t < T;
      cp_async4_s(smem_u32(kbias + s * AC_KEYS + tid), bias + (size_t)b * T + (ok ? t : 0),
                  ok);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  // This thread's key columns c, c + 1 of each 8-column group, of two rows.
  const int col = (lane & 3) * 2;
  const float L = LOG2E;
  const bool active = q0 + wg * 64 < T;  // a warpgroup past T only keeps the ring going

  float m_lo = -INFINITY, m_hi = -INFINITY;  // row max, log2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums
  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  for (int it = 0; it < 2 * nkt; ++it) {
    cp_async_wait<0>();  // tile it (and, first, Q) has landed
    fence_proxy_async();
    __syncthreads();  // ...for every thread; tile it-1 is consumed, its stage free
    if (it + 1 < 2 * nkt) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();
    if (!active) continue;
    if (it == nkt) {  // pass 1 is complete: the global row max
      m_lo = quad_max(m_lo);
      m_hi = quad_max(m_hi);
    }

    const int s = it & 1, k0 = (it % nkt) * AC_KEYS;
    const uint32_t ks = tiles + 2 * s * C::TILE_BYTES, vs = ks + C::TILE_BYTES;
    const float* kb_s = kbias + s * AC_KEYS;
    float sv[AC_KEYS / 2];
    wgmma_fence();
    product_ss<HD>(sv, Qs, AC_ROWS, wg * 64, ks, AC_KEYS);  // s = bf16(q scale) k^T
    wgmma_commit();
    fence_regs(sv);
    wgmma_wait<0>();
    fence_regs(sv);
    // logits in log2 units: s log2e + bias log2e, -inf past T
#pragma unroll
    for (int n8 = 0; n8 < AC_KEYS / 8; ++n8) {
      const int c = n8 * 8 + col;
      float ka = bias ? kb_s[c] * L : 0.f, kb = bias ? kb_s[c + 1] * L : 0.f;
      if (k0 + c >= T) ka = -INFINITY;
      if (k0 + c + 1 >= T) kb = -INFINITY;
      sv[4 * n8 + 0] = fmaf(sv[4 * n8 + 0], L, ka);
      sv[4 * n8 + 1] = fmaf(sv[4 * n8 + 1], L, kb);
      sv[4 * n8 + 2] = fmaf(sv[4 * n8 + 2], L, ka);
      sv[4 * n8 + 3] = fmaf(sv[4 * n8 + 3], L, kb);
    }
    if (it < nkt) {  // pass 1: this thread's share of the row max
#pragma unroll
      for (int n8 = 0; n8 < AC_KEYS / 8; ++n8) {
        m_lo = fmaxf(m_lo, fmaxf(sv[4 * n8 + 0], sv[4 * n8 + 1]));
        m_hi = fmaxf(m_hi, fmaxf(sv[4 * n8 + 2], sv[4 * n8 + 3]));
      }
      continue;
    }
    // pass 2: p = 2^(s - m) in fp32, l sums the unrounded p, o += bf16(p) v
    uint32_t pf[AC_KEYS / 4];
#pragma unroll
    for (int n8 = 0; n8 < AC_KEYS / 8; ++n8) {
      const float p0 = ex2(sv[4 * n8 + 0] - m_lo), p1 = ex2(sv[4 * n8 + 1] - m_lo);
      const float p2 = ex2(sv[4 * n8 + 2] - m_hi), p3 = ex2(sv[4 * n8 + 3] - m_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pf[2 * n8] = pack_bf16(p0, p1);
      pf[2 * n8 + 1] = pack_bf16(p2, p3);
    }
    wgmma_fence();
    fence_regs(acc);
    product_rs<C::HDP, AC_KEYS>(acc, pf, vs);  // o += p v
    wgmma_commit();
    wgmma_wait<0>();  // before the barrier that frees this stage
    fence_regs(acc);
  }

  if (!active) return;
  // l >= 1: the row's largest logit gives p = 1 in both passes alike.
  const float ll[2] = {quad_sum(l_lo), quad_sum(l_hi)};
  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    if (t >= T) continue;
    bf16* dst = out + ((size_t)b * T + t) * D + h * HD + col;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int i = 4 * n8 + 2 * half;
      *reinterpret_cast<uint32_t*>(dst + n8 * 8) =
          pack_bf16(acc[i] / ll[half], acc[i + 1] / ll[half]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launch helpers
// ---------------------------------------------------------------------------
template <int HD>
int launch_attn_core_hd(const bf16* qkv, const float* bias, bf16* o, int B, int T, int D,
                        int H, cudaStream_t st) {
  constexpr int bytes = AcCfg<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_core<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + AC_ROWS - 1) / AC_ROWS, H, B);
  // The scale as the reference passes it: float(hd) ** -0.5 rounded to fp32.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  attn_core<HD><<<grid, AC_THREADS, bytes, st>>>(qkv, bias, o, T, D, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_attn_core(const bf16* qkv, const float* bias, bf16* o, int B, int T, int D, int H,
                     cudaStream_t st) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H) return static_cast<int>(cudaErrorInvalidValue);
  switch (D / H) {
    case 32: return launch_attn_core_hd<32>(qkv, bias, o, B, T, D, H, st);
    case 64: return launch_attn_core_hd<64>(qkv, bias, o, B, T, D, H, st);
    case 128: return launch_attn_core_hd<128>(qkv, bias, o, B, T, D, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The attention core on its own, for the card tests: qkv [B, T, 3D] bf16,
// bias [B, T] fp32 or null, o [B, T, D] bf16.
int mt_attn_core(const void* qkv, const void* bias, void* o, int B, int T, int D, int H,
                 void* stream) {
  return launch_attn_core(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                          static_cast<bf16*>(o), B, T, D, H, static_cast<cudaStream_t>(stream));
}

// Scratch (allocated by the caller): xn, o [B, T, D] and qkv [B, T, 3D]
// bf16. D must be a multiple of 128 and D / H one of 32, 64, 128.
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
  rc = launch_gemm_sm90<EPI_BIAS>(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv),
                                  static_cast<const bf16*>(bqkv), nullptr, qkv, M, 3 * D, D,
                                  st);
  if (rc) return rc;
  rc = launch_attn_core(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                        static_cast<bf16*>(o), B, T, D, H, st);
  if (rc) return rc;
  return launch_gemm_sm90<EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(bproj), static_cast<const bf16*>(x), out, M, D, D, st);
}

// Scratch: xn [rows, D] and h [rows, F] bf16. D and F must be multiples of
// 128.
int mt_mlp_sublayer(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* xn, void* h,
                    void* out, int rows, int D, int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_layer_norm(static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
                             static_cast<const float*>(ln_b), static_cast<bf16*>(xn), rows,
                             D, eps, st);
  if (rc) return rc;
  rc = launch_gemm_sm90<EPI_BIAS_GELU>(static_cast<const bf16*>(xn),
                                       static_cast<const bf16*>(w1),
                                       static_cast<const bf16*>(b1), nullptr, h, rows, F, D,
                                       st);
  if (rc) return rc;
  return launch_gemm_sm90<EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), out, rows, D, F, st);
}

}  // extern "C"
