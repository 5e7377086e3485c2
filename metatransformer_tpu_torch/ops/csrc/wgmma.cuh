// Hopper (sm_90a) building blocks shared by the wgmma kernels of this
// package: flash_attention_fwd.cu, flash_attention_bwd.cu, fused_block.cu,
// fused_block_bwd.cu and gemm_sm90.cuh. Each .cu file that includes this
// header is compiled on its own into its own shared library, so everything
// here lives in an anonymous namespace.
//
// Shared tiles use the 128-byte swizzle that the wgmma descriptors name: a
// [rows, d] bf16 tile is stored as 64-column blocks of 128-byte rows, the
// 16-byte chunk c of row r at chunk c ^ (r % 8). cp.async writes each chunk
// to its swizzled place, so no pass reorders them. A tile is read K-major
// (rows are the M or N side, d the depth) or MN-major (rows are the depth:
// the transpose bit) through the same layout.
//
// A thread's accumulator element i of a 64 x N wgmma product sits at row
// warp * 16 + lane / 4 (+ 8 for i % 4 >= 2), column (i / 4) * 8 +
// (lane % 4) * 2 + i % 2. Elements 2j and 2j + 1 are neighbours in a row,
// and packed as bf16 pairs in order they are the A fragment of the next
// product: 16-column slice ks is registers 4ks .. 4ks+3.

#pragma once

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` (along the row) of row r in a tile of
// `rows` rows: 64-column blocks of 128-byte rows, 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int rows, int r, int ch) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_s(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}
// cp.async and plain stores write through the generic proxy; wgmma reads
// through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows t0 .. t0+n-1 of one head ([T, HD], `row_stride` elements apart) into
// a swizzled tile of `rows` rows, by THREADS threads; rows past T are
// zero-filled.
template <int HD, int THREADS = 256>
__device__ __forceinline__ void load_rows(uint32_t tile, int rows, const bf16* src,
                                          long long row_stride, int t0, int n, int Tlen) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < n * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH, t = t0 + r;
    const bool ok = t < Tlen;
    const bf16* row = src + (long long)(ok ? t : 0) * row_stride;
    cp_async16_s(tile + swz(rows, r, ch), row + ch * 8, ok);
  }
}

// Rows t0 .. t0+ROWS-1 of one head of q ([T, HD], `stride` apart), times
// scale and rounded to bf16 (the reference's bf16(q * scale)), into a
// swizzled tile by plain stores, by THREADS threads; where qs_out is given,
// the same values into it ([T, D] rows of the head). Rows past T are zero.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_scaled_q(unsigned char* tile, const bf16* src,
                                              size_t stride, bf16* qs_out, int D, int t0,
                                              int T, float scale) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH, t = t0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < T) {
      u = *reinterpret_cast<const uint4*>(src + (size_t)t * stride + ch * 8);
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = f2b(b2f(e[j]) * scale);
      if (qs_out) *reinterpret_cast<uint4*>(qs_out + (size_t)t * D + ch * 8) = u;
    }
    *reinterpret_cast<uint4*>(tile + swz(ROWS, r, ch)) = u;
  }
}

// head_dim 32: zero the upper half of every row of a tile once; no copy
// writes there.
template <int HD, int THREADS = 256>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int rows) {
  if constexpr (HD < 64) {
    for (int c = threadIdx.x; c < rows * 4; c += THREADS) {
      const int r = c >> 2, ch = 4 + (c & 3);
      *reinterpret_cast<uint4*>(tile + swz(rows, r, ch)) = make_uint4(0, 0, 0, 0);
    }
  }
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1), 8-row
// groups 1024 bytes apart (stride offset 64 x 16 bytes). K-major: the leading
// offset is unused. MN-major: 64-column blocks `rows` x 128 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int rows) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(rows * 8) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum of a row across the four threads of a quad that hold it in a
// wgmma accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

#define MT_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define MT_ACC64(d)                                                                         \
  MT_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define MT_REGS32                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MT_REGS64                                                                           \
  MT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
            "%62, %63"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MT_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A K-major in shared memory, B
// K-major (TRANS_B = 0) or MN-major (TRANS_B = 1, the transpose bit).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MT_REGS64
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : MT_ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MT_REGS32
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : MT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MT_REGS64
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : MT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[64 x 64] = A[rows a_m0 .. a_m0+63 of tile a] . B[64 rows of tile b]^T
// over head_dim, both K-major.
template <int HD>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, int a_rows, int a_m0,
                                           uint32_t b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * a_rows * 128 + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * b_rows * 128 + (kk & 3) * 32;
    wgmma_ss_n64(d, desc_k(a + a_m0 * 128 + ka), desc_k(b + kb), kk > 0);
  }
}

// d[64 x HDP] += A[64 x K] (registers: K/16 slices of 16 columns) . tile b
// [K rows, HDP], read MN-major; HDP = 64 or 128.
template <int HDP, int K>
__device__ __forceinline__ void product_rs(float (&d)[HDP / 2], const uint32_t (&a)[K / 4],
                                           uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const uint64_t db = desc_mn(b + ks * 16 * 128, K);
    if constexpr (HDP == 64)
      wgmma_rs_n64(d, a + 4 * ks, db);
    else
      wgmma_rs_n128(d, a + 4 * ks, db);
  }
}

}  // namespace
