// Shared device code of the attention kernels (the float32 chunk spans of
// ragged paged attention and the flash forward's float32 path; paged
// decode, dense decode, ragged's span-1 rows and the fused decode tick take
// the split-KV walk of csrc/split_kv.cuh, and the bf16 tiles the tensor
// cores): one routine that attends a tile of up to
// TQ query rows of ONE head over a walk of key positions, 32 keys at a time,
// with an online softmax.
//
// Thread layout (128 threads = 4 warps):
//   scores  — warp w owns query rows w, w+4, w+8, ...; lane j owns key j of
//             the 32-key tile. Each score is one thread's sequential dot
//             product over D, so a row's arithmetic does not depend on TQ.
//   softmax — the owning warp reduces max and sum over its 32 lanes with
//             shuffles; row state (m, l) lives in that warp's registers.
//   P @ V   — thread t owns output elements e = t + 128*k of the [TQ, D]
//             accumulator, kept in registers.
// K and V tiles are staged in shared memory as float32 (K rows padded to
// D+1 floats so the 32 lanes of a score read hit 32 banks), loaded with
// 16-byte vector loads (8 bytes of a quantized pool) from per-key row
// offsets the caller computes (a block table for the paged pools, plain
// strides for flash).
//
// Numerics follow the Pallas kernels: fp32 scores and accumulators, masked
// scores at -1e30, probabilities zeroed off the mask, V rows past the valid
// length zeroed (stale pool rows may hold NaN), P rounded to the input type
// before the PV product, and out = acc / max(l, 1e-30) rounded to the input
// type.
//
// A quantized pool (K/V of type KT = int8_t or __nv_fp8_e4m3, scale planes
// per row and KV head or per block and KV head: Scales below) converts each
// K/V tile to float32 as it lands in shared memory, with the tile's keys'
// scales beside it: the K scale multiplies the score after the dot, l sums
// the unscaled P, and the V scale is folded into P (kept float32) before
// the PV product, as the split-KV walk (split_kv.cuh) and the reference
// kernel order it.
//
// The neox RoPE pair (rope_pair, and its transpose) is shared by the
// rotation pre-pass (csrc/rope_qk.cu) and the flash backward kernels'
// adjoint epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt {

// Head dims: every kernel takes D % 8 == 0, 8 <= D <= 256, and runs at
// the padded width Dp (64, 128 or 256, the next one up): its shared tiles,
// accumulators and products are Dp wide, the columns past D zero (copies
// zero-fill them, never reading past a row), 1/sqrt(D) scales the scores
// and only D columns are written. Zero columns add exact zeros to every
// dot product, so a padded row's sums are those of its D columns.
inline bool head_dim_ok(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }
inline int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }
// f(std::integral_constant<int, Dp>) for head dim d, or
// cudaErrorInvalidValue for a dim no kernel takes
template <typename F>
cudaError_t with_head_dim(int d, F f) {
  if (!head_dim_ok(d)) return cudaErrorInvalidValue;
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// The scale planes of a pool: QM 0 none, 1 per row and KV head (int8),
// 2 per block and KV head (fp8); off(p) is key p's index in ks and vs.
struct NoOff {
  __device__ long long operator()(int) const { return 0; }
};
template <int QM, typename ScaleOff>
struct Scales {
  const float* ks;
  const float* vs;
  ScaleOff off;
};
using NoScales = Scales<0, NoOff>;

// Element strides of a [B, S, H, D] tensor (D contiguous): [B, S, H, D]
// memory and head-major [B, H, S, D] memory read through the same code.
struct RowStrides {
  long long b, s, h;
  __device__ __forceinline__ long long at(int bi, int si, int hi) const {
    return bi * b + si * s + hi * h;
  }
};

// rope(x) = x * cos + R(x) * sin with R([x1, x2]) = [-x2, x1], on one pair
// (x1 at column d < D/2, x2 at d + D/2; c1, s1 the tables at d, c2, s2 at
// d + D/2). Each product and sum rounds on its own (no FMA contraction),
// as the plain version computes them.
__device__ __forceinline__ void rope_pair(float x1, float x2, float c1,
                                          float s1, float c2, float s2,
                                          float& o1, float& o2) {
  o1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1));
  o2 = __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2));
}
// Its transpose on a float32 gradient pair: y * cos + R^T(y * sin) with
// R^T([z1, z2]) = [z2, -z1].
__device__ __forceinline__ void rope_adjoint_pair(float y1, float y2,
                                                  float c1, float s1,
                                                  float c2, float s2,
                                                  float& o1, float& o2) {
  o1 = __fadd_rn(__fmul_rn(y1, c1), __fmul_rn(y2, s2));
  o2 = __fadd_rn(__fmul_rn(y2, c2), -__fmul_rn(y1, s1));
}

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;          // keys per tile: one lane per key
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the narrow types of a quantized KV pool: exact in float32
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// 16 bytes of T -> floats
__device__ __forceinline__ void load16(const float* p, float* o) {
  float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// A score chunk of the split-KV walk -> floats: 16 bytes of float32 or
// bfloat16, 8 bytes (8 values) of a quantized pool's int8 or e4m3
__device__ __forceinline__ void load_chunk(const float* p, float* o) { load16(p, o); }
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* o) {
  load16(p, o);
}
template <typename Q>
__device__ __forceinline__ void load8_narrow(const Q* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const Q* b = reinterpret_cast<const Q*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = to_f(b[i]);
}
__device__ __forceinline__ void load_chunk(const int8_t* p, float* o) {
  load8_narrow(p, o);
}
__device__ __forceinline__ void load_chunk(const __nv_fp8_e4m3* p, float* o) {
  load8_narrow(p, o);
}

// 16 bytes of a quantized pool's int8 or e4m3 -> 16 floats
template <typename Q>
__device__ __forceinline__ void load16_narrow(const Q* p, float* o) {
  load8_narrow(p, o);
  load8_narrow(p + 8, o + 8);
}

// the same through L2 only (__ldcg): for data another block of the same
// launch may have written (the fused decode tick's query buffer), which the
// SM's L1 may hold from an earlier read
__device__ __forceinline__ void load16_cg(const float* p, float* o) {
  float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16_cg(const __nv_bfloat16* p, float* o) {
  uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D, int TQ>
struct TileShape {
  static constexpr int VEC = 16 / sizeof(T);           // elements per load
  static constexpr int KP = D + 1;                      // padded K row
  static constexpr int RPW = (TQ + kWarps - 1) / kWarps;  // rows per warp
  static constexpr int NACC = (TQ * D + kThreads - 1) / kThreads;
  // shared floats: Q, K, V, P, per-row alpha / l / m, then a tile's K and
  // V scales; rounded up to 16 bytes so the int64 offsets after them are
  // aligned
  static constexpr int SMEM_FLOATS =
      (TQ * D + kKeys * KP + kKeys * D + TQ * kKeys + 3 * TQ + 2 * kKeys +
       3) & ~3;
  // plus the per-key and per-row offsets (int64 each)
  static constexpr size_t SMEM_BYTES =
      SMEM_FLOATS * sizeof(float) + (kKeys + TQ) * sizeof(long long);
};

// Shared memory: S::SMEM_FLOATS floats, then kKeys int64 key offsets, then
// TQ int64 query offsets (s_qoff). The caller fills s_qoff[i] — the element
// offset of query row i's D-vector in q (and of its output row in out), or
// -1 for a row outside the tile — and synchronises before the call.
// row_pos(i) is the last key position row i may attend. key_off(p) returns the element offset of key position p's D-vector in
// k (and v). Keys p >= kv_valid are never read: their K/V tile rows are
// zero and their scores masked. The walk visits keys [0, kv_stop). A
// quantized pool (KT narrow) passes its planes in sc, key p's scales at
// sc.off(p). D is the padded width: the rows hold hd columns (zeros past
// them in shared memory), and only those are written.
// On return s_m[i] / s_l[i] hold each row's running max and sum (for LSE).
template <typename T, int D, int TQ, typename KeyOff, typename RowPos,
          typename KT = T, int QM = 0, typename ScaleOff = NoOff>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, T* __restrict__ out, float* smem,
    long long* s_qoff, RowPos row_pos, int kv_stop, int kv_valid,
    KeyOff key_off, int hd, float scale,
    Scales<QM, ScaleOff> sc = Scales<QM, ScaleOff>{}) {
  using S = TileShape<T, D, TQ>;
  // pool elements a load: 16 bytes of float32 or bf16, 8 of a narrow pool
  // (a row of hd bytes is 8-byte aligned)
  constexpr int KVV = sizeof(KT) == 1 ? 8 : 16 / sizeof(KT);
  float* sQ = smem;
  float* sK = sQ + TQ * D;
  float* sV = sK + kKeys * S::KP;
  float* sP = sV + kKeys * D;
  float* s_alpha = sP + TQ * kKeys;
  float* s_l = s_alpha + TQ;
  float* s_m = s_l + TQ;
  float* s_ks = s_m + TQ;                 // the tile's K scales
  float* s_vs = s_ks + kKeys;             // ... and V scales
  long long* s_koff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // ---- stage the query tile (rows outside the tile read as zeros)
  for (int e = tid; e < TQ * D / S::VEC; e += kThreads) {
    const int i = e / (D / S::VEC);
    const int d = (e % (D / S::VEC)) * S::VEC;
    float buf[S::VEC];
    const long long off = s_qoff[i];
    if (off >= 0 && d < hd) {
      load16_cg(q + off + d, buf);
    } else {
#pragma unroll
      for (int x = 0; x < S::VEC; ++x) buf[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < S::VEC; ++x) sQ[i * D + d + x] = buf[x];
  }

  float m_row[S::RPW], l_row[S::RPW];
  int pos_row[S::RPW];
#pragma unroll
  for (int r = 0; r < S::RPW; ++r) {
    m_row[r] = kNegInf;
    l_row[r] = 0.f;
    const int i = warp + kWarps * r;
    pos_row[r] = (i < TQ && s_qoff[i] >= 0) ? row_pos(i) : -1;
  }
  float acc[S::NACC];
#pragma unroll
  for (int a = 0; a < S::NACC; ++a) acc[a] = 0.f;

  for (int k0 = 0; k0 < kv_stop; k0 += kKeys) {
    __syncthreads();   // previous tile's P/V reads are done
    if (tid < kKeys) {
      const int p = k0 + tid;
      s_koff[tid] = (p < kv_valid) ? key_off(p) : -1;
      if constexpr (QM != 0) {
        s_ks[tid] = p < kv_valid ? sc.ks[sc.off(p)] : 0.f;
        s_vs[tid] = p < kv_valid ? sc.vs[sc.off(p)] : 0.f;
      }
    }
    __syncthreads();
    // ---- stage K (padded rows) and V in float32; invalid keys become
    // zero rows
    for (int e = tid; e < kKeys * D / KVV; e += kThreads) {
      const int j = e / (D / KVV);
      const int d = (e % (D / KVV)) * KVV;
      float bk[KVV], bv[KVV];
      const long long off = s_koff[j];
      if (off >= 0 && d < hd) {
        load_chunk(k + off + d, bk);
        load_chunk(v + off + d, bv);
      } else {
#pragma unroll
        for (int x = 0; x < KVV; ++x) { bk[x] = 0.f; bv[x] = 0.f; }
      }
#pragma unroll
      for (int x = 0; x < KVV; ++x) {
        sK[j * S::KP + d + x] = bk[x];
        sV[j * D + d + x] = bv[x];
      }
    }
    __syncthreads();
    // ---- scores + online softmax: warp owns rows, lane owns key
    const int p = k0 + lane;
#pragma unroll
    for (int r = 0; r < S::RPW; ++r) {
      const int i = warp + kWarps * r;
      if (i >= TQ) break;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[i * D + d], sK[lane * S::KP + d], s);
      s *= scale;
      if constexpr (QM != 0) s *= s_ks[lane];   // post-dot, after scale
      const bool valid = (p < kv_valid) && (p <= pos_row[r]);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m_row[r], warp_max(s));
      float pr = expf(s - m_new);
      pr = valid ? pr : 0.f;
      const float alpha = expf(m_row[r] - m_new);
      l_row[r] = alpha * l_row[r] + warp_sum(pr);
      m_row[r] = m_new;
      // l took the unscaled P; a quantized pool's V scale is folded in
      // after, in float32
      if constexpr (QM != 0)
        sP[i * kKeys + lane] = pr * s_vs[lane];
      else
        sP[i * kKeys + lane] = to_f(from_f<T>(pr));
      if (lane == 0) s_alpha[i] = alpha;
    }
    __syncthreads();
    // ---- acc = acc * alpha + P @ V
#pragma unroll
    for (int a = 0; a < S::NACC; ++a) {
      const int e = tid + kThreads * a;
      if (e < TQ * D) {
        const int i = e / D;
        const int d = e % D;
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) dot = fmaf(sP[i * kKeys + j], sV[j * D + d], dot);
        acc[a] = acc[a] * s_alpha[i] + dot;
      }
    }
  }
  // ---- publish row state, then write the normalized rows
#pragma unroll
  for (int r = 0; r < S::RPW; ++r) {
    const int i = warp + kWarps * r;
    if (i < TQ && lane == 0) {
      s_l[i] = l_row[r];
      s_m[i] = m_row[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < S::NACC; ++a) {
    const int e = tid + kThreads * a;
    if (e < TQ * D) {
      const int i = e / D;
      const int d = e % D;
      const long long off = s_qoff[i];
      if (off >= 0 && d < hd)
        out[off + d] = from_f<T>(acc[a] / fmaxf(s_l[i], 1e-30f));
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pt
