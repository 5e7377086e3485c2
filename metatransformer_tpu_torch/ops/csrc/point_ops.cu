// Furthest-point sampling for Hopper (sm_90a).
//
// One public entry point with a plain C interface, bound with ctypes by
// metatransformer_tpu_torch/ops/point_ops.py:
//
//   mt_fps: idx[b, 0] = 0; idx[b, r] = argmax_i min_{s < r} |p_i - p_idx[b, s]|^2
//     replaces the Pallas kernel metatransformer_tpu/ops/point_ops.py
//     `_fps_kernel` (:67): points [B, N, 3] fp32 -> indices [B, G] int32.
//
// The result is integers, so the arithmetic is fixed to the last bit and is
// the plain version's (furthest_point_sample_plain): per point and round
//   d = (dx*dx + dy*dy) + dz*dz, each operation rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: the compiler must not contract a
// multiply and an add into an FMA, or a near-tie picks another index and
// every later index with it), min_d = min(min_d, d) from +inf, and the
// argmax takes the smallest index among equal maxima.
//
// Bound: ~10 fp32 operations a point a round against 12 bytes a point read
// once, so operations, not bytes; but the G-1 rounds are sequential and each
// ends in a block-wide argmax that feeds the next round's centre, so what
// the kernel really pays is the latency of one round. The design keeps a
// round short:
//   * one block per cloud, the whole loop inside it (the TPU kernel held all
//     B clouds in VMEM as one program; here B blocks run side by side);
//   * the cloud's x, y, z planes and the running minimum stay in shared
//     memory for all rounds (16 N bytes: N <= 14,336 inside the 224 KB asked
//     for here); larger clouds run the same kernel on the strided points in
//     device memory and a [B, N] scratch for the minimum (SHARED = false);
//   * the last centre's coordinates are read straight from the planes at the
//     winning index (the TPU kernel needed a one-hot reduction for want of a
//     dynamic gather);
//   * the argmax is a butterfly of warp shuffles over (value, index) pairs,
//     then one __syncthreads() and a second butterfly over the per-warp
//     winners that every warp runs for itself, so all threads know the
//     centre without a second barrier. The per-warp slots alternate between
//     two buffers, so round r+1's writes cannot overtake round r's reads.
//
// Points are indexed by their strides (in elements), so a non-contiguous
// [B, N, 3] view needs no copy. The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int FPS_MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory the SHARED route may ask for (of the 227 KB a block
// can use; the static per-warp slots take 512 bytes more).
constexpr size_t FPS_MAX_SMEM = 224 * 1024;

// (value, index) order of the argmax: the larger value wins, the smaller
// index among equal values.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    take_better(v, i, ov, oi);
  }
}

template <bool SHARED>
__global__ void fps_kernel(const float* __restrict__ points, long long stride_b,
                           long long stride_n, long long stride_c,
                           float* __restrict__ min_scratch, int* __restrict__ out, int N,
                           int G) {
  extern __shared__ float planes[];  // SHARED: x | y | z | min_d, N floats each
  __shared__ float warp_v[2][FPS_MAX_WARPS];
  __shared__ int warp_i[2][FPS_MAX_WARPS];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthreads + 31) >> 5;
  const float* p = points + static_cast<long long>(blockIdx.x) * stride_b;
  float* min_d = SHARED ? planes + 3 * static_cast<size_t>(N)
                        : min_scratch + static_cast<size_t>(blockIdx.x) * N;
  int* idx = out + static_cast<size_t>(blockIdx.x) * G;

  for (int i = tid; i < N; i += nthreads) {
    if (SHARED) {
      planes[i] = p[i * stride_n];
      planes[N + i] = p[i * stride_n + stride_c];
      planes[2 * N + i] = p[i * stride_n + 2 * stride_c];
    }
    min_d[i] = INFINITY;
  }
  if (tid == 0) idx[0] = 0;
  if (SHARED) __syncthreads();  // else a thread reads only what it wrote

  int last = 0;
  for (int r = 1; r < G; ++r) {
    float lx, ly, lz;
    if (SHARED) {
      lx = planes[last], ly = planes[N + last], lz = planes[2 * N + last];
    } else {
      const float* c = p + last * stride_n;
      lx = c[0], ly = c[stride_c], lz = c[2 * stride_c];
    }
    float best_v = -1.0f;  // below every squared distance
    int best_i = INT_MAX;
    for (int i = tid; i < N; i += nthreads) {
      float x, y, z;
      if (SHARED) {
        x = planes[i], y = planes[N + i], z = planes[2 * N + i];
      } else {
        const float* q = p + i * stride_n;
        x = q[0], y = q[stride_c], z = q[2 * stride_c];
      }
      const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(min_d[i], d);
      min_d[i] = m;
      if (m > best_v) {  // ascending i: the first maximum stays
        best_v = m;
        best_i = i;
      }
    }
    warp_argmax(best_v, best_i);
    const int buf = r & 1;
    if (lane == 0) {
      warp_v[buf][warp] = best_v;
      warp_i[buf][warp] = best_i;
    }
    __syncthreads();
    best_v = lane < nwarps ? warp_v[buf][lane] : -1.0f;
    best_i = lane < nwarps ? warp_i[buf][lane] : INT_MAX;
    warp_argmax(best_v, best_i);
    last = best_i;
    if (tid == 0) idx[r] = last;
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Whether a cloud of N points runs with its planes in shared memory.
int mt_fps_fits_shared(int N) { return 16 * static_cast<size_t>(N) <= FPS_MAX_SMEM; }

// points: fp32, element strides (b, n, c); min_scratch: [B, N] fp32, used only
// where the cloud does not fit shared memory (may be null otherwise); out:
// [B, G] int32; threads: a multiple of 32 up to 1024.
int mt_fps(const void* points, long long stride_b, long long stride_n, long long stride_c,
           void* min_scratch, void* out, int B, int N, int G, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || G < 1 || threads < 32 || threads > 32 * FPS_MAX_WARPS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(points);
  float* scratch = static_cast<float*>(min_scratch);
  int* idx = static_cast<int*>(out);
  if (mt_fps_fits_shared(N)) {
    const size_t smem = 16 * static_cast<size_t>(N);
    cudaError_t rc = cudaFuncSetAttribute(fps_kernel<true>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(FPS_MAX_SMEM));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    fps_kernel<true><<<B, threads, smem, st>>>(p, stride_b, stride_n, stride_c, nullptr, idx,
                                               N, G);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_kernel<false><<<B, threads, 0, st>>>(p, stride_b, stride_n, stride_c, scratch, idx, N,
                                             G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
