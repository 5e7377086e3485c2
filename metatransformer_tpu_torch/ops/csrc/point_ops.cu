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
// once, so operations (B N (G-1) * 10 over 67 TFLOP/s). But the G-1 rounds
// are sequential: each ends in an argmax over the whole cloud whose winner
// is the next round's centre, so what the kernel really pays is the latency
// of one round, a chain of dependent steps, times G-1. The design shortens
// that chain and keeps every cloud on-chip:
//   * registers: each thread owns PPT points (a template parameter, so the
//     loops unroll), points first + k * threads for k < PPT. Their x, y, z
//     and running minimum stay in registers for all rounds: a round reads
//     and writes no memory until its reduction. Slots past the cloud start
//     at -inf and keep it, so they lose every comparison.
//   * one reduction step a level: after round 1 the running minimum is >= +0
//     and finite (the coordinates are finite), so its bit pattern as a
//     signed int orders like the float, and padding (-inf) is negative. A
//     warp takes __reduce_max_sync over the bits, then __reduce_min_sync over
//     the indices of the lanes that hold that maximum: two redux.sync in
//     place of a butterfly of ten shuffles.
//   * the winner carries its coordinates: the winning lane writes (bits,
//     index) and (x, y, z) into its warp's slot; after one __syncthreads()
//     every warp reduces the slots itself and reads the centre from the
//     winning slot, with no dependent read at the index. Slots alternate
//     between two buffers, so round r+1's writes cannot overtake round r's
//     reads, and one barrier a round suffices.
//   * thread block clusters for large clouds: a block holds at most 8,192
//     points in registers (1024 threads x 8 or 512 x 16), and a cloud of
//     more points than the plan gives one block (2,048) runs on a cluster of
//     C <= 8 blocks on neighbouring SMs, each holding its share, ascending by
//     block rank. Each round every block pushes its winner (20 bytes) into
//     the inbox of every block of the cluster with st.async, which counts
//     the bytes on the receiving block's mbarrier; a block waits on its own
//     mbarrier for the C messages of the round and reduces its inbox as a
//     warp reduces its lanes, so every block computes the same centre and
//     block rank 0 writes the index. No cluster-wide barrier runs inside the
//     loop, and the reads after the wait are local. Inboxes and mbarriers
//     alternate between two buffers (see fps_regs for why two suffice).
//   * the device-memory route only past the largest cluster (N > 65,536 =
//     8 x 8,192): one block a cloud, the points read from device memory and
//     the running minimum in a [B, N] scratch every round, with the same
//     reductions.
//
// The launch plan (route, C, threads a block, points a thread) is computed
// from N in Python (point_ops._fps_plan) and passed in; mt_fps refuses a plan
// that does not cover the cloud. Points are indexed by their strides (in
// elements), so a non-contiguous [B, N, 3] view needs no copy. The entry
// point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FPS_MAX_WARPS = 32;
// Points one block holds in registers, and blocks in a cluster (the portable
// cluster size): past FPS_MAX_CLUSTER * FPS_BLOCK_MAX points the cloud takes
// the device-memory route.
constexpr int FPS_BLOCK_MAX = 8192;
constexpr int FPS_MAX_CLUSTER = 8;

struct Winner {
  int key, idx;  // the running minimum's bits, the point's index
  float4 xyz;
};

__device__ __forceinline__ int dist_key(float& min_d, float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  const float d =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  min_d = fminf(min_d, d);
  return __float_as_int(min_d);
}

// The winner among the lanes' candidates (key, idx, xyz): the largest key,
// the smallest index among equal keys. Lanes without a candidate pass
// (INT_MIN, INT_MAX). Indices of candidates are distinct.
__device__ __forceinline__ Winner warp_winner(int key, int idx, float4 xyz) {
  const int wk = __reduce_max_sync(FULL, key);
  const int wi = __reduce_min_sync(FULL, key == wk ? idx : INT_MAX);
  const int src = __ffs(__ballot_sync(FULL, idx == wi)) - 1;
  Winner w;
  w.key = wk;
  w.idx = wi;
  w.xyz.x = __shfl_sync(FULL, xyz.x, src);
  w.xyz.y = __shfl_sync(FULL, xyz.y, src);
  w.xyz.z = __shfl_sync(FULL, xyz.z, src);
  w.xyz.w = 0.f;
  return w;
}

// Block-wide winner of the threads' candidates: each warp's winning lane
// writes its slot, one barrier, then every warp reduces the slots itself.
__device__ __forceinline__ Winner block_winner(int key, int idx, float4 xyz, int2 (*slot_ki)[32],
                                               float4 (*slot_xyz)[32], int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wk = __reduce_max_sync(FULL, key);
  const int wi = __reduce_min_sync(FULL, key == wk ? idx : INT_MAX);
  if (idx == wi) {  // the one lane holding the warp's winner
    slot_ki[buf][warp] = make_int2(wk, wi);
    slot_xyz[buf][warp] = xyz;
  }
  __syncthreads();
  const int2 c = lane < nwarps ? slot_ki[buf][lane] : make_int2(INT_MIN, INT_MAX);
  const int vk = __reduce_max_sync(FULL, c.x);
  const int vi = __reduce_min_sync(FULL, c.x == vk ? c.y : INT_MAX);
  const int src = __ffs(__ballot_sync(FULL, c.y == vi)) - 1;
  Winner w;
  w.key = vk;
  w.idx = vi;
  w.xyz = slot_xyz[buf][src];
  return w;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Waits until the phase of the mbarrier with this parity has completed; the
// acquire at cluster scope makes the other blocks' st.async data visible.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The register-resident kernel: one block a cloud (CLUSTER = false) or a
// cluster of gridDim / B blocks a cloud, each holding threads * PPT points.
// On a cluster, each block pushes its winner (20 bytes) into every block's
// inbox with st.async, which counts the bytes on the receiver's mbarrier; a
// block waits on its own mbarrier for C messages, then reduces its inbox.
// Inboxes and mbarriers alternate between two buffers: a block sends round
// r+2 only after it has received every block's round r+1, which each block
// sends after it has read its round r inbox.
template <int PPT, bool CLUSTER>
__global__ void __launch_bounds__(PPT >= 16 ? 512 : 1024)
    fps_regs(const float* __restrict__ points, long long stride_b, long long stride_n,
             long long stride_c, int* __restrict__ out, int N, int G) {
  __shared__ int2 slot_ki[2][FPS_MAX_WARPS];
  __shared__ float4 slot_xyz[2][FPS_MAX_WARPS];
  // CLUSTER: the blocks' winners of a round by sender rank, (key, index, x,
  // y) and z, and the mbarrier that counts their bytes
  __shared__ int4 inbox[2][FPS_MAX_CLUSTER];
  __shared__ float inbox_z[2][FPS_MAX_CLUSTER];
  __shared__ unsigned long long inbox_bar[2];

  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  int nblocks = 1, rank = 0, cloud = blockIdx.x;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    nblocks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    cloud = blockIdx.x / nblocks;
    if (tid == 0) {
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&inbox_bar[b])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_barrier();  // every mbarrier is set up before the first message
  }
  const float* p = points + static_cast<long long>(cloud) * stride_b;
  const int first = rank * nthreads * PPT + tid;  // point k of this thread: first + k * nthreads

  float x[PPT], y[PPT], z[PPT], min_d[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = first + k * nthreads;
    if (i < N) {
      const float* q = p + i * stride_n;
      x[k] = q[0], y[k] = q[stride_c], z[k] = q[2 * stride_c];
      min_d[k] = INFINITY;
    } else {
      x[k] = y[k] = z[k] = 0.f;
      min_d[k] = -INFINITY;  // stays -inf: loses every comparison
    }
  }
  float lx = p[0], ly = p[stride_c], lz = p[2 * stride_c];
  int* idx = out + static_cast<size_t>(cloud) * G;
  const bool writer = tid == 0 && rank == 0;
  if (writer) idx[0] = 0;

  for (int r = 1; r < G; ++r) {
    const int buf = r & 1;
    if constexpr (CLUSTER) {
      if (tid == 0) {  // this round's phase expects one message from every block
        unsigned long long state;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
                     : "=l"(state)
                     : "r"(smem_addr(&inbox_bar[buf])), "r"(20 * nblocks)
                     : "memory");
      }
    }
    int key = INT_MIN, kk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int kb = dist_key(min_d[k], x[k], y[k], z[k], lx, ly, lz);
      if (kb > key) {  // ascending index: the first maximum stays
        key = kb;
        kk = k;
      }
    }
    float4 xyz = make_float4(x[0], y[0], z[0], 0.f);
#pragma unroll
    for (int k = 1; k < PPT; ++k) {
      if (kk == k) xyz = make_float4(x[k], y[k], z[k], 0.f);
    }
    Winner w = block_winner(key, first + kk * nthreads, xyz, slot_ki, slot_xyz, buf);
    if constexpr (CLUSTER) {
      if (tid < nblocks) {  // lane d of warp 0 sends the block's winner to block d
        const unsigned to = static_cast<unsigned>(tid);
        const unsigned bar = cluster_addr(smem_addr(&inbox_bar[buf]), to);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
            "[%5];\n" ::"r"(cluster_addr(smem_addr(&inbox[buf][rank]), to)),
            "r"(w.key), "r"(w.idx), "r"(__float_as_int(w.xyz.x)), "r"(__float_as_int(w.xyz.y)),
            "r"(bar)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                cluster_addr(smem_addr(&inbox_z[buf][rank]), to)),
            "r"(__float_as_int(w.xyz.z)), "r"(bar)
            : "memory");
      }
      mbar_wait(smem_addr(&inbox_bar[buf]), ((r - 1) >> 1) & 1);
      int4 c = make_int4(INT_MIN, INT_MAX, 0, 0);
      float cz = 0.f;
      if (lane < nblocks) {
        c = inbox[buf][lane];
        cz = inbox_z[buf][lane];
      }
      w = warp_winner(c.x, c.y, make_float4(__int_as_float(c.z), __int_as_float(c.w), cz, 0.f));
    }
    lx = w.xyz.x, ly = w.xyz.y, lz = w.xyz.z;
    if (writer) idx[r] = w.idx;
  }
  if constexpr (CLUSTER) cluster_barrier();  // no block leaves while a message may be in flight
}

// The device-memory route: one block a cloud; points read from device
// memory and the running minimum kept in a [B, N] scratch every round.
__global__ void __launch_bounds__(1024)
    fps_device(const float* __restrict__ points, long long stride_b, long long stride_n,
               long long stride_c, float* __restrict__ min_scratch, int* __restrict__ out,
               int N, int G) {
  __shared__ int2 slot_ki[2][FPS_MAX_WARPS];
  __shared__ float4 slot_xyz[2][FPS_MAX_WARPS];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float* p = points + static_cast<long long>(blockIdx.x) * stride_b;
  float* min_d = min_scratch + static_cast<size_t>(blockIdx.x) * N;
  int* idx = out + static_cast<size_t>(blockIdx.x) * G;
  for (int i = tid; i < N; i += nthreads) min_d[i] = INFINITY;  // a thread reads only what it wrote
  if (tid == 0) idx[0] = 0;
  float lx = p[0], ly = p[stride_c], lz = p[2 * stride_c];
  for (int r = 1; r < G; ++r) {
    int key = INT_MIN, best = INT_MAX;
    float4 xyz = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < N; i += nthreads) {
      const float* q = p + i * stride_n;
      const float x = q[0], y = q[stride_c], z = q[2 * stride_c];
      float m = min_d[i];
      const int kb = dist_key(m, x, y, z, lx, ly, lz);
      min_d[i] = m;
      if (kb > key) {
        key = kb;
        best = i;
        xyz = make_float4(x, y, z, 0.f);
      }
    }
    const Winner w = block_winner(key, best, xyz, slot_ki, slot_xyz, r & 1);
    lx = w.xyz.x, ly = w.xyz.y, lz = w.xyz.z;
    if (tid == 0) idx[r] = w.idx;
  }
}

template <int PPT>
cudaError_t launch_regs(const float* p, long long sb, long long sn, long long sc, int* idx,
                        int B, int N, int G, int cluster, int threads, cudaStream_t st) {
  if (cluster == 1) {
    fps_regs<PPT, false><<<B, threads, 0, st>>>(p, sb, sn, sc, idx, N, G);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fps_regs<PPT, true>, p, sb, sn, sc, idx, N, G);
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// points: fp32, element strides (b, n, c); out: [B, G] int32. The plan:
//   cluster = 0: the device-memory route (N > FPS_MAX_CLUSTER * FPS_BLOCK_MAX),
//     `threads` a block, min_scratch [B, N] fp32; ppt is not read;
//   cluster = C >= 1: the register route on C blocks a cloud (C = 1: one
//     block), `threads` a block (whole warps, at most 512 for ppt 16, else
//     1024), `ppt` points a thread in {4, 8, 16}; C must be
//     ceil(N / (threads * ppt)) and at most FPS_MAX_CLUSTER; min_scratch may
//     be null.
int mt_fps(const void* points, long long stride_b, long long stride_n, long long stride_c,
           void* min_scratch, void* out, int B, int N, int G, int cluster, int threads, int ppt,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || G < 1 || threads < 32 || threads > 32 * FPS_MAX_WARPS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(points);
  int* idx = static_cast<int*>(out);
  if (cluster == 0) {
    if (min_scratch == nullptr || N <= FPS_MAX_CLUSTER * FPS_BLOCK_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    fps_device<<<B, threads, 0, st>>>(p, stride_b, stride_n, stride_c,
                                      static_cast<float*>(min_scratch), idx, N, G);
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_block = static_cast<long long>(threads) * ppt;
  if (cluster < 1 || cluster > FPS_MAX_CLUSTER || per_block > FPS_BLOCK_MAX ||
      (N + per_block - 1) / per_block != cluster || (ppt == 16 && threads > 512))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc;
  switch (ppt) {
    case 4: rc = launch_regs<4>(p, stride_b, stride_n, stride_c, idx, B, N, G, cluster, threads, st); break;
    case 8: rc = launch_regs<8>(p, stride_b, stride_n, stride_c, idx, B, N, G, cluster, threads, st); break;
    case 16: rc = launch_regs<16>(p, stride_b, stride_n, stride_c, idx, B, N, G, cluster, threads, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
