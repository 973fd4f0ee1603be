// Tensor-core building blocks of the bf16 flash kernels: the forward
// (csrc/flash.cu) on warpgroup wgmma, dK/dV and dQ (csrc/flash_bwd.cu) on
// mma.sync.m16n8k16 — asynchronous 16-byte copies into swizzled shared
// tiles, ldmatrix fragment loads, the two products with fp32
// accumulators, wgmma descriptors, and the quad reductions of an online
// softmax over accumulator rows.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels rely on:
//   A [16 x 16] (4 regs of bf16x2): a0 (row g,   cols 2t, 2t+1)
//                                   a1 (row g+8, cols 2t, 2t+1)
//                                   a2 (row g,   cols 2t+8, 2t+9)
//                                   a3 (row g+8, cols 2t+8, 2t+9)
//   B [16 x 8]  (2 regs):           b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9)
//   C [16 x 8]  (4 floats):         c0, c1 (row g, cols 2t, 2t+1)
//                                   c2, c3 (row g+8, cols 2t, 2t+1)
// So the C fragments of two neighbouring 8-column tiles hold, lane for
// lane, the A fragment of the 16 x 16 block they cover: a score tile turns
// into the A operand of the next product in registers (to_a_frag), with no
// shared-memory round trip. wgmma's accumulator and register-A fragments
// are the same per warp (warp w of the warpgroup holds rows 16w ..).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- copies
// 16 bytes global -> shared; with pred false the source is not read and
// the 16 bytes are zero-filled (rows past S).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes (one float), zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared tiles use the 128-byte swizzle atom: a [R][D] bf16 tile is D/64
// column blocks of [R][64] (rows of 128 bytes), chunk c of row r of a
// block stored at chunk c ^ (r % 8) — TMA's SWIZZLE_128B pattern, which the
// wgmma descriptors name (layout type 1), and for ldmatrix the eight rows
// it reads at one logical chunk land in eight different bank groups.
// Column blocks are R * 128 bytes apart. wgmma needs a tile to start
// 1024-byte aligned (the pattern's period); ldmatrix does not.
// Element offset of 16-byte chunk c (of D / 8) of row r:
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Rows [0, R) of a tile whose row 0 is at src (row stride `stride`
// elements) into the swizzled tile dst; rows at or past `valid` become
// zeros (src must point at a readable row: row 0 of the tile always is).
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int CH = D / 8;
  static_assert(R * CH % NT == 0, "every thread copies the same count");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    const bool ok = r < valid;
    cp_async16(dst + swz<R>(r, c), ok ? src + r * stride + c * 8 : src, ok);
  }
}

// The same for a tile of keys read through a block table: rows [0, R)
// hold keys p0 .. p0+R-1 of one sequence, key p at row p % bs of pool
// block tbl[p / bs] (entries clamped into the nb blocks: sentinels), this
// KV head's D elements of a [nb, bs, Hkv, D] pool (kv_row = Hkv * D). Each
// 16-byte copy computes its own row's address, since a tile spans several
// pool blocks. Keys at or past `valid` become zeros and are not read.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile_paged(
    __nv_bfloat16* dst, const __nv_bfloat16* pool, const int* tbl, int p0,
    int valid, int nb, int bs, long long kv_row, int kvh) {
  constexpr int CH = D / 8;
  static_assert(R * CH % NT == 0, "every thread copies the same count");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    const int p = p0 + r;
    const bool ok = p < valid;
    long long off = 0;
    if (ok) {
      const int phys = min(max(tbl[p / bs], 0), nb - 1);
      off = (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * D +
            c * 8;
    }
    cp_async16(dst + swz<R>(r, c), pool + off, ok);
  }
}

// ------------------------------------------------------ fragment loads
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment: rows [r0, r0+16) x k-step ks (columns 16ks .. 16ks+15) of
// a swizzled [R][D] tile.
template <int R>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int ks) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + swz<R>(r0 + (l & 15), 2 * ks + (l >> 4)));
}

// B fragments of two 8-column tiles (n rows n0 .. n0+15 of a tile stored
// [n][k], k-step ks): b[0], b[1] for columns n0..n0+7, b[2], b[3] for
// n0+8..n0+15. For products against a transposed operand (S = Q K^T:
// K is stored [key][d]).
template <int R>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int n0,
                                       int ks) {
  const int l = threadIdx.x & 31;
  const int m = l >> 3;
  ldsm_x4(b, tile + swz<R>(n0 + (l & 7) + ((m >> 1) << 3), 2 * ks + (m & 1)));
}

// B fragments from a tile stored [k][n] (P V: V is stored [key][d]):
// k rows 16ks .. 16ks+15, columns (chunks) nc and nc+1 -> b[0], b[1] for
// columns 8nc.., b[2], b[3] for 8(nc+1)..
template <int R>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4],
                                         const __nv_bfloat16* tile, int ks,
                                         int nc) {
  const int l = threadIdx.x & 31;
  const int m = l >> 3;
  ldsm_x4_t(b, tile + swz<R>(16 * ks + (l & 7) + ((m & 1) << 3), nc + (m >> 1)));
}

// ------------------------------------------------------------ products
// c += a . b  (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even, lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of 8-column tiles 2kk and 2kk+1 (rows of this warp's
// 16, columns 16kk .. 16kk+15), rounded to bf16, as the A fragment of the
// next product's k-step kk.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ------------------------------------------------------ row reductions
// A row of a C fragment lives in the four lanes of a quad.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit (x <= 0 here; very negative -> +0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------------- wgmma
// Warpgroup products (sm_90a): four warps issue one asynchronous 64-row
// product; the accumulator layout is mma.sync's C layout, warp w holding
// rows 16w .. 16w+15, so the same softmax code reads it. Operands in
// shared memory are swz tiles, named by descriptors.

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets, 128-byte swizzle (the tile must start 1024-byte aligned)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows = M or N, K along the row): k-step ks of a [R][D]
// atom tile. 8-row groups are 1024 bytes apart; a k-step moves 32 bytes
// inside a 128-byte row, every fourth into the next column block.
template <int R>
__device__ __forceinline__ uint64_t desc_k_major(const __nv_bfloat16* tile,
                                                 int ks) {
  return make_desc(tile + (ks >> 2) * R * 64 + (ks & 3) * 16, 16, 1024);
}
// MN-major operand (rows = K, N along the row): k-step ks (rows 16ks ..)
// of a [R][D] atom tile; column blocks (64 N columns) are R * 128 bytes
// apart, 8-row K groups 1024.
template <int R>
__device__ __forceinline__ uint64_t desc_mn_major(const __nv_bfloat16* tile,
                                                  int ks) {
  return make_desc(tile + ks * 16 * 64, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an in-flight wgmma reads or writes: after wg_wait, pin them so
// that the compiler neither reads an accumulator nor reuses an A register
// before the product is done.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}
// shared data written by cp.async (the generic proxy) made visible to
// wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory
// (descriptors), both K-major (trans-b 0)
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[8][4],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (each warp its
// 16 rows, mma.sync's A fragment), B from shared memory MN-major (trans-b 1)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (each warp its
// 16 rows, mma.sync's A fragment), B from shared memory MN-major (trans-b 1)
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Opt a kernel into `bytes` of dynamic shared memory and ask for the
// largest shared carveout, so that more than one block fits an SM.
template <typename K>
inline cudaError_t use_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace tc
}  // namespace pt
