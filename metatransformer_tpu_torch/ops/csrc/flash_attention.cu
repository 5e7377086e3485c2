// Flash attention for long sequences on Hopper (sm_90a), fp32 inputs: the
// forward and the two backward kernels on plain fp32 FMAs (no TF32), the
// route of the video-MAE decoder under the FP32 policy. The bf16 kernels
// are flash_attention_fwd.cu and flash_attention_bwd.cu, on wgmma; every
// call takes exactly one route by its element type.
//
// Three public entry points with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/flash_attention.py. Each is one launch and
// replaces one Pallas kernel of metatransformer_tpu/ops/flash_attention.py
// at fp32:
//
//   mt_flash_fwd_f32      `_fwd_kernel` (:70)      o = softmax(q k^T scale + bias) v
//                                                 and lse = m + log l per row
//   mt_flash_bwd_dq_f32   `_bwd_dq_kernel` (:137)  dq = scale * sum_k ds k
//   mt_flash_bwd_dkv_f32  `_bwd_dkv_kernel` (:176) dk = scale * sum_q ds^T q,
//                                                 dv = sum_q p^T dO
//   with p = exp(s - lse), dp = dO v^T, ds = p (dp - delta).
//
// Numerics follow the Pallas kernels' cast points. Logits are (q . k)
// accumulated in fp32, times scale, plus the additive key bias (the scale is
// not folded into q). Row max m, row sum l and the output accumulator are
// fp32 and updated online, tile by tile; the output is divided by
// max(l, 1e-30) after the last tile. The backward forms p from the
// forward's fp32 lse, scales dq and dk after the sum and leaves dv
// unscaled. Only the order of summation and expf differ from the plain
// versions.
//
// What bounds it: fp32 FMAs outside the tensor cores (67 TFLOP/s on an H100
// SXM): at the MAE decoder's shapes (T = 1568, head_dim 64, B*H = 24) the
// forward does 15 GFLOP.
//
// Design notes.
//  * K and V of a head do not fit in a block's shared memory at T = 1568
//    (the TPU kernels held them whole in VMEM). One block owns a tile of 64
//    queries (forward, dq) or 64 keys (dk/dv) of one (sample, head) and
//    streams the other side through shared memory in 64-row tiles with
//    cp.async; the forward keeps two K/V stages in flight.
//  * No padding and no transposed copies. The kernels index [B, T, H, d]
//    by strides (head_dim contiguous), so q, k, v may be views of one
//    [B, T, 3, H, d] projection, and dq, dk, dv land in one such buffer.
//    The bias is one [B, T] fp32 row per sample, shared by its heads. The
//    ragged last tile is zero-filled on load; keys past T get a bias of
//    -inf (probability 0), query rows past T are computed and not stored.
//  * Masked keys carry the caller's additive -1e30, so a fully masked
//    sample gives a uniform p over its T keys and no NaN.
//  * A warp owns 16 rows of the tile and a lane pair one row. Logits of a
//    16 x 64 tile are staged in a per-warp fp32 scratch; the output row
//    lives in the lane pair's registers, so the online rescale is a register
//    multiply. Every [T, T] quantity stays on chip.
//  * Determinism: dq sums over key tiles inside one block, dk/dv over query
//    tiles inside one block, in a fixed order. No atomics.

#include "common.cuh"

namespace {

constexpr int FA_TILE = 64;          // rows of a query tile and of a key tile
constexpr int FA_THREADS = 128;      // 4 warps x 16 rows
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_S_LD = FA_TILE + 4; // fp32 logits rows

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T, int HD>
struct FaCfg {
  static constexpr int CHUNK = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int LD = HD + CHUNK;         // q/k/v/dO tile rows (T)
  static constexpr int P_LD = FA_TILE + CHUNK;  // p / ds rows (T)
  static constexpr int TILE = FA_TILE * LD;     // elements
  static constexpr int TILE_BYTES = TILE * sizeof(T);
  static constexpr int S_BYTES = 16 * FA_S_LD * 4;
  static constexpr int P_BYTES = 16 * P_LD * sizeof(T);
  static constexpr int FWD_WARP_BYTES = S_BYTES + P_BYTES;
  static constexpr int FWD_BYTES = 5 * TILE_BYTES + FA_WARPS * FWD_WARP_BYTES + 2 * FA_TILE * 4;
  static constexpr int DQ_WARP_BYTES = 2 * S_BYTES + P_BYTES;
  static constexpr int DQ_BYTES = 4 * TILE_BYTES + FA_WARPS * DQ_WARP_BYTES + FA_TILE * 4;
  static constexpr int DKV_WARP_BYTES = 2 * S_BYTES + 2 * P_BYTES;
  static constexpr int DKV_BYTES = 4 * TILE_BYTES + FA_WARPS * DKV_WARP_BYTES + 3 * FA_TILE * 4;
};

// Rows t0 .. t0+63 of one head ([T, HD] with `row_stride` elements between
// rows) into a shared tile with cp.async; rows past T are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int t0, int Tlen) {
  using C = FaCfg<T, HD>;
  constexpr int CH = HD / C::CHUNK;
  for (int c = threadIdx.x; c < FA_TILE * CH; c += FA_THREADS) {
    const int r = c / CH, cc = (c % CH) * C::CHUNK, t = t0 + r;
    const bool ok = t < Tlen;
    cp_async16(dst + r * C::LD + cc, src + (long long)(ok ? t : 0) * row_stride + cc, ok);
  }
}

// dst[16, 64] (fp32, ld FA_S_LD) = a_rows[16, HD] . b_tile[64, HD]^T for
// one warp. After a __syncwarp each lane may read its own row.
template <typename T, int HD>
__device__ __forceinline__ void tile_product(float* dst, const T* a_rows, const T* b_tile) {
  using C = FaCfg<T, HD>;
  constexpr int LD = C::LD;
    // A lane pair owns row r; each lane takes 32 of the 64 columns.
    const int lane = threadIdx.x & 31, r = lane >> 1, half = (lane & 1) * 32;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < HD; kk += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_rows + r * LD + kk);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_tile + (half + j) * LD + kk);
        acc[j] = fmaf(a4.x, b4.x, acc[j]);
        acc[j] = fmaf(a4.y, b4.y, acc[j]);
        acc[j] = fmaf(a4.z, b4.z, acc[j]);
        acc[j] = fmaf(a4.w, b4.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[r * FA_S_LD + half + j] = acc[j];
}

// Store N fp32 values, times mul, as T in 16-byte chunks.
template <typename T, int N>
__device__ __forceinline__ void store_chunks(T* dst, const float* vals, float mul) {
  constexpr int CHUNK = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N; c += CHUNK) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) e[j] = from_f<T>(vals[c + j] * mul);
    *reinterpret_cast<uint4*>(dst + c) = u;
  }
}

// A warp's [16, HD] fp32 accumulator of sum over tiles of a[16, 64] .
// b_tile[64, HD]: a lane's half row in registers.
template <typename T, int HD>
struct RowAcc;

template <int HD>
struct RowAcc<float, HD> {
  using C = FaCfg<float, HD>;
  float v[HD / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void add_product(const float* a, const float* b_tile) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c_lo = (lane & 1) * (HD / 2);
#pragma unroll 4
    for (int c = 0; c < FA_TILE; ++c) {
      const float ar = a[r * C::P_LD + c];
#pragma unroll
      for (int n = 0; n < HD / 2; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_tile + c * C::LD + c_lo + n);
        v[n] = fmaf(ar, b4.x, v[n]);
        v[n + 1] = fmaf(ar, b4.y, v[n + 1]);
        v[n + 2] = fmaf(ar, b4.z, v[n + 2]);
        v[n + 3] = fmaf(ar, b4.w, v[n + 3]);
      }
    }
  }
  __device__ __forceinline__ void store(float*, float* dst, bool valid, float mul) {
    if (valid) store_chunks<float, HD / 2>(dst, v, mul);
  }
};

// One sample's bias for keys k0 .. k0+63: the caller's additive value, 0
// without a mask, -inf past T.
__device__ __forceinline__ void load_key_bias(float* kb, const float* bias, int b, int k0,
                                              int Tlen) {
  for (int c = threadIdx.x; c < FA_TILE; c += FA_THREADS) {
    const int t = k0 + c;
    kb[c] = t < Tlen ? (bias ? bias[(long long)b * Tlen + t] : 0.f) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (query tile of 64, head, sample). q, k, v are
// [B, T, H, HD] by strides (sb, st, sh, 1); o is contiguous [B, T, H, HD];
// lse is [B, H, T] fp32.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
          int Tlen, long long sb, long long st, long long sh, float scale) {
  using C = FaCfg<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + C::TILE;      // two stages
  T* Vs = Ks + 2 * C::TILE;  // two stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wb = smem + 5 * C::TILE_BYTES + warp * C::FWD_WARP_BYTES;
  float* ws = reinterpret_cast<float*>(wb);
  T* wp = reinterpret_cast<T*>(wb + C::S_BYTES);
  float* kb = reinterpret_cast<float*>(smem + 5 * C::TILE_BYTES + FA_WARPS * C::FWD_WARP_BYTES);

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const T* wq = Qs + warp * 16 * C::LD;
  // A lane pair owns row r: this lane takes 32 of a tile's 64 logits
  // (half..) and the half row c_lo.. of the output.
  const int r = lane >> 1, half = (lane & 1) * 32;

  load_tile_async<T, HD>(Qs, q + head, st, q0, Tlen);
  auto load_kv = [&](int stage, int k0) {
    load_tile_async<T, HD>(Ks + stage * C::TILE, k + head, st, k0, Tlen);
    load_tile_async<T, HD>(Vs + stage * C::TILE, v + head, st, k0, Tlen);
    load_key_bias(kb + stage * FA_TILE, bias, b, k0, Tlen);
  };
  load_kv(0, 0);
  cp_async_commit();

  float m = -INFINITY, l = 0.f;  // l: this lane's share of the row sum
  RowAcc<T, HD> pv;
  pv.zero();

  const int nkt = (Tlen + FA_TILE - 1) / FA_TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_kv((kt + 1) & 1, (kt + 1) * FA_TILE);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group: tile kt is here
    __syncthreads();
    const T* ks = Ks + (kt & 1) * C::TILE;
    const T* vs = Vs + (kt & 1) * C::TILE;
    const float* kbs = kb + (kt & 1) * FA_TILE;

    tile_product<T, HD>(ws, wq, ks);  // q k^T
    __syncwarp();
    float sv[32];
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sv[j] = ws[r * FA_S_LD + half + j] * scale + kbs[half + j];
      tm = fmaxf(tm, sv[j]);
    }
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float m_new = fmaxf(m, tm);  // finite: every tile holds a key < T
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      ls += p;
      wp[r * C::P_LD + half + j] = from_f<T>(p);
    }
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < HD / 2; ++i) pv.v[i] *= alpha;
    pv.add_product(wp, vs);
    __syncthreads();  // tile kt consumed before its stage is refilled
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float l_safe = fmaxf(l, 1e-30f);
  const int t = q0 + warp * 16 + r;
  if (t < Tlen) {
    float oreg[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oreg[i] = pv.v[i] / l_safe;
    T* dst = o + (((long long)b * Tlen + t) * H + h) * HD + (lane & 1) * (HD / 2);
    store_chunks<T, HD / 2>(dst, oreg, 1.f);
    if ((lane & 1) == 0) lse[((long long)b * H + h) * Tlen + t] = m + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query tile of 64, head, sample), streaming key tiles.
// d_o is contiguous [B, T, H, HD]; lse and delta are [B, H, T] fp32; dq is
// [B, T, H, HD] by strides (gb, gt, gh, 1).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ bias, const T* __restrict__ d_o,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Tlen, long long sb, long long st, long long sh,
             long long gb, long long gt, long long gh, float scale) {
  using C = FaCfg<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + C::TILE;
  T* Ks = dOs + C::TILE;
  T* Vs = Ks + C::TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wb = smem + 4 * C::TILE_BYTES + warp * C::DQ_WARP_BYTES;
  float* ws = reinterpret_cast<float*>(wb);
  float* wdp = ws + 16 * FA_S_LD;  // contiguous with ws: together they stage the output
  T* wds = reinterpret_cast<T*>(wb + 2 * C::S_BYTES);
  float* kb = reinterpret_cast<float*>(smem + 4 * C::TILE_BYTES + FA_WARPS * C::DQ_WARP_BYTES);

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long do_head = (long long)b * Tlen * H * HD + (long long)h * HD;
  const T* wq = Qs + warp * 16 * C::LD;
  const T* wdo = dOs + warp * 16 * C::LD;
  const int r = lane >> 1, half = (lane & 1) * 32, c_lo = (lane & 1) * (HD / 2);

  load_tile_async<T, HD>(Qs, q + head, st, q0, Tlen);
  load_tile_async<T, HD>(dOs, d_o + do_head, (long long)H * HD, q0, Tlen);

  const int t = q0 + warp * 16 + r;
  const bool valid = t < Tlen;
  const long long stat = ((long long)b * H + h) * Tlen + (valid ? t : 0);
  const float lse_r = valid ? lse[stat] : 0.f;
  const float delta_r = valid ? delta[stat] : 0.f;

  RowAcc<T, HD> acc;
  acc.zero();
  const int nkt = (Tlen + FA_TILE - 1) / FA_TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // previous key tile fully consumed
    load_tile_async<T, HD>(Ks, k + head, st, kt * FA_TILE, Tlen);
    load_tile_async<T, HD>(Vs, v + head, st, kt * FA_TILE, Tlen);
    load_key_bias(kb, bias, b, kt * FA_TILE, Tlen);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_product<T, HD>(ws, wq, Ks);    // q k^T
    tile_product<T, HD>(wdp, wdo, Vs);  // dO v^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half + j;
      const float p = expf(ws[r * FA_S_LD + c] * scale + kb[c] - lse_r);
      wds[r * C::P_LD + c] = from_f<T>(p * (wdp[r * FA_S_LD + c] - delta_r));
    }
    __syncwarp();
    acc.add_product(wds, Ks);  // dq += ds k
  }
  T* dst = dq + (long long)b * gb + (long long)(valid ? t : 0) * gt + (long long)h * gh + c_lo;
  acc.store(ws, dst, valid, scale);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (key tile of 64, head, sample), streaming query
// tiles. A warp owns 16 keys and works on the transposed tiles s^T, dp^T
// [16 keys, 64 queries], so dv = p^T dO and dk = ds^T q are row-major
// products. dk and dv share the strides (gb, gt, gh, 1).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ bias, const T* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int Tlen, long long sb, long long st,
              long long sh, long long gb, long long gt, long long gh, float scale) {
  using C = FaCfg<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + C::TILE;
  T* Qs = Vs + C::TILE;
  T* dOs = Qs + C::TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wb = smem + 4 * C::TILE_BYTES + warp * C::DKV_WARP_BYTES;
  float* ws = reinterpret_cast<float*>(wb);
  float* wdp = ws + 16 * FA_S_LD;
  T* wp = reinterpret_cast<T*>(wb + 2 * C::S_BYTES);
  T* wds = reinterpret_cast<T*>(wb + 2 * C::S_BYTES + C::P_BYTES);
  float* kb = reinterpret_cast<float*>(smem + 4 * C::TILE_BYTES + FA_WARPS * C::DKV_WARP_BYTES);
  float* lse_s = kb + FA_TILE;
  float* delta_s = lse_s + FA_TILE;

  const int k0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long do_head = (long long)b * Tlen * H * HD + (long long)h * HD;
  const float* lse_h = lse + ((long long)b * H + h) * Tlen;
  const float* delta_h = delta + ((long long)b * H + h) * Tlen;
  const T* wk = Ks + warp * 16 * C::LD;
  const T* wv = Vs + warp * 16 * C::LD;
  const int r = lane >> 1, half = (lane & 1) * 32, c_lo = (lane & 1) * (HD / 2);

  load_tile_async<T, HD>(Ks, k + head, st, k0, Tlen);
  load_tile_async<T, HD>(Vs, v + head, st, k0, Tlen);
  load_key_bias(kb, bias, b, k0, Tlen);

  RowAcc<T, HD> acc_k, acc_v;
  acc_k.zero();
  acc_v.zero();
  const int nqt = (Tlen + FA_TILE - 1) / FA_TILE;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * FA_TILE;
    __syncthreads();  // previous query tile fully consumed
    load_tile_async<T, HD>(Qs, q + head, st, q0, Tlen);
    load_tile_async<T, HD>(dOs, d_o + do_head, (long long)H * HD, q0, Tlen);
    for (int c = tid; c < FA_TILE; c += FA_THREADS) {
      const bool ok = q0 + c < Tlen;  // rows past T: probability 0
      lse_s[c] = ok ? lse_h[q0 + c] : INFINITY;
      delta_s[c] = ok ? delta_h[q0 + c] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_product<T, HD>(ws, wk, Qs);    // s^T = k q^T
    tile_product<T, HD>(wdp, wv, dOs);  // dp^T = v dO^T
    __syncwarp();
    const float kbr = kb[warp * 16 + r];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half + j;
      const float p = expf(ws[r * FA_S_LD + c] * scale + kbr - lse_s[c]);
      wp[r * C::P_LD + c] = from_f<T>(p);
      wds[r * C::P_LD + c] = from_f<T>(p * (wdp[r * FA_S_LD + c] - delta_s[c]));
    }
    __syncwarp();
    acc_v.add_product(wp, dOs);  // dv += p^T dO
    acc_k.add_product(wds, Qs);  // dk += ds^T q
  }
  const int t = k0 + warp * 16 + r;
  const bool valid = t < Tlen;
  const long long off =
      (long long)b * gb + (long long)(valid ? t : 0) * gt + (long long)h * gh + c_lo;
  acc_v.store(ws, dv + off, valid, 1.f);
  acc_k.store(ws, dk + off, valid, scale);
}

// ---------------------------------------------------------------------------
// Host-side launch helpers
// ---------------------------------------------------------------------------
struct FaArgs {
  const void *q, *k, *v, *d_o;
  const float *bias, *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, T, H;
  long long sb, st, sh, gb, gt, gh;
  float scale;
  cudaStream_t stream;
};

enum { FA_FWD = 0, FA_DQ = 1, FA_DKV = 2 };

template <typename T, int HD>
int launch_flash(int which, const FaArgs& a) {
  using C = FaCfg<T, HD>;
  const dim3 grid((a.T + FA_TILE - 1) / FA_TILE, a.H, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d_o = static_cast<const T*>(a.d_o);
  cudaError_t err;
  if (which == FA_FWD) {
    err = cudaFuncSetAttribute(flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::FWD_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd<T, HD><<<grid, FA_THREADS, C::FWD_BYTES, a.stream>>>(
        q, k, v, a.bias, static_cast<T*>(a.o), a.lse_out, a.T, a.sb, a.st, a.sh, a.scale);
  } else if (which == FA_DQ) {
    err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq<T, HD><<<grid, FA_THREADS, C::DQ_BYTES, a.stream>>>(
        q, k, v, a.bias, d_o, a.lse_in, a.delta, static_cast<T*>(a.dq), a.T, a.sb, a.st, a.sh,
        a.gb, a.gt, a.gh, a.scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKV_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv<T, HD><<<grid, FA_THREADS, C::DKV_BYTES, a.stream>>>(
        q, k, v, a.bias, d_o, a.lse_in, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.T, a.sb, a.st, a.sh, a.gb, a.gt, a.gh, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash_hd(int which, int hd, const FaArgs& a) {
  switch (hd) {
    case 32: return launch_flash<T, 32>(which, a);
    case 64: return launch_flash<T, 64>(which, a);
    case 128: return launch_flash<T, 128>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32 only: bf16 inputs go to flash_attention_fwd.cu / flash_attention_bwd.cu.
int launch_flash_any(int which, int hd, int is_fp32, const FaArgs& a) {
  if (!is_fp32 || a.B <= 0 || a.T <= 0 || a.H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_flash_hd<float>(which, hd, a);
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: [B, T, H, hd] fp32 with element strides (sb, st, sh, 1); bias:
// [B, T] fp32 or null. Outputs: o contiguous [B, T, H, hd] fp32, lse
// [B, H, T] fp32. is_fp32 must be 1 (bf16: mt_flash_fwd of
// flash_attention_fwd.cu).
int mt_flash_fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                 void* lse, int B, int T, int H, int hd, long long sb, long long st,
                 long long sh, float scale, int is_fp32, void* stream) {
  FaArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = static_cast<const float*>(bias);
  a.o = o, a.lse_out = static_cast<float*>(lse);
  a.B = B, a.T = T, a.H = H, a.sb = sb, a.st = st, a.sh = sh, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_flash_any(FA_FWD, hd, is_fp32, a);
}

// fp32 only (is_fp32 = 1; bf16: mt_flash_bwd_dq of flash_attention_bwd.cu).
// d_o: contiguous [B, T, H, hd]; lse, delta: [B, H, T] fp32. Output dq:
// [B, T, H, hd] with element strides (gb, gt, gh, 1).
int mt_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* bias,
                    const void* d_o, const void* lse, const void* delta, void* dq, int B,
                    int T, int H, int hd, long long sb, long long st, long long sh,
                    long long gb, long long gt, long long gh, float scale, int is_fp32,
                    void* stream) {
  FaArgs a{};
  a.q = q, a.k = k, a.v = v, a.d_o = d_o, a.bias = static_cast<const float*>(bias);
  a.lse_in = static_cast<const float*>(lse), a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.B = B, a.T = T, a.H = H, a.sb = sb, a.st = st, a.sh = sh;
  a.gb = gb, a.gt = gt, a.gh = gh, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_flash_any(FA_DQ, hd, is_fp32, a);
}

// As mt_flash_bwd_dq_f32; outputs dk and dv share the strides (gb, gt, gh, 1).
int mt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* bias,
                     const void* d_o, const void* lse, const void* delta, void* dk, void* dv,
                     int B, int T, int H, int hd, long long sb, long long st, long long sh,
                     long long gb, long long gt, long long gh, float scale, int is_fp32,
                     void* stream) {
  FaArgs a{};
  a.q = q, a.k = k, a.v = v, a.d_o = d_o, a.bias = static_cast<const float*>(bias);
  a.lse_in = static_cast<const float*>(lse), a.delta = static_cast<const float*>(delta);
  a.dk = dk, a.dv = dv;
  a.B = B, a.T = T, a.H = H, a.sb = sb, a.st = st, a.sh = sh;
  a.gb = gb, a.gt = gt, a.gh = gh, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_flash_any(FA_DKV, hd, is_fp32, a);
}

}  // extern "C"
