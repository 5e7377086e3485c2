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
// The row LayerNorm and the GEMM are in common.cuh, shared with the
// backward (fused_block_bwd.cu).

#include "common.cuh"

namespace {

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
