// RoPE pre-pass of the flash kernels' rope= mode: one launch rotates
// un-rotated Q [B, S, H, D] and K [B, S, Hk, D] into new tensors of the
// same strides, neox rotation from the [S, D] float32 tables, each result
// rounded to the input type.
//
//   rope_qk  replaces the _rope_block prologues of _fwd_kernel,
//            _dkv_kernel and _dq_kernel (paddle_tpu/kernels/pallas_flash.py
//            :92-94, :211-213 and :276-278; pallas_call at :159, :335 and
//            :365): the forward kernel and the two backward kernels
//            (csrc/flash.cu, csrc/flash_bwd.cu) read the rotated pair, so
//            each Q and K row is rotated once a forward and once a
//            backward, not once per block that walks its tile.
//
// Bits: rope_pair (attention_common.cuh) rounds each product and the sum
// on its own (__fmul_rn / __fadd_rn, never contracted into an FMA), then
// the result rounds to the input type: the bits of the plain rope_rotate
// (kernels/flash.py).
//
// Bound on this card: bytes. Q and K are read once and written once (at
// B=4, S=2048, 32 heads of 128 in bf16: 4 x 64 MiB, ~0.08 ms at 3.35
// TB/s); the tables add 2 MiB.
//
// Design: one block per run of kRun positions. Each thread owns one
// position of the run and one pair of chunks (columns d and d + D/2) for
// the whole block, so it reads its table entries once, into registers,
// and then walks every (batch, head) row of Q and then of K at that
// position. The tables are read from memory about once a launch, not
// once a head. A chunk is 16 bytes, or 8 bytes of bf16 where D/2 is not a
// multiple of 8 (D % 16 == 8: the upper half starts 8-byte aligned), and
// the head dim is a run-time value (any D % 8 == 0 up to 256): the block's
// HC * kRun chunk pairs a sweep (HC = D/2 / VEC a row) are its first
// threads, the rest idle. No shared memory, no barrier.
//
// Layouts: Q and its output through one set of element strides (batch,
// sequence, head; D contiguous), K and its output through another, as the
// flash kernels read them.
#include <cuda_fp16.h>

#include "attention_common.cuh"

namespace pt {
namespace rope {

constexpr int kNT = 256;   // threads a block
constexpr int kRun = 4;    // positions a block

// VEC values of T <-> floats: 16 bytes of float32, bf16 or fp16, or 8 of
// a 16-bit type; stores round to nearest even (as from_f rounds)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  static_assert(VEC == 4, "16 bytes of float32");
  load16(p, o);
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  if constexpr (VEC == 8) {
    load16(p, o);
  } else {
    static_assert(VEC == 4, "8 or 16 bytes of bf16");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __half* p, float* o) {
  static_assert(VEC == 4 || VEC == 8, "8 or 16 bytes of fp16");
  __half2 h[VEC / 2];
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
  else
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __half22float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  alignas(16) __nv_bfloat162 h[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}
template <int VEC>
__device__ __forceinline__ void store_vec(__half* p, const float* v) {
  alignas(16) __half2 h[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kNT)
rope_qk_kernel(const T* __restrict__ q, const T* __restrict__ k,
               T* __restrict__ qr, T* __restrict__ kr,
               const float* __restrict__ sin, const float* __restrict__ cos,
               RowStrides qs, RowStrides ks, int B, int S, int H, int Hk,
               int D) {
  const int HC = D / 2 / VEC;              // chunk pairs a row
  const int RS = kNT / (HC * kRun);        // rows a sweep of the block
  if (threadIdx.x >= RS * HC * kRun) return;
  const int c = threadIdx.x % HC;
  const int pos = blockIdx.x * kRun + (threadIdx.x / HC) % kRun;
  if (pos >= S) return;
  const int d = c * VEC;

  // this thread's table entries (columns d.. and d + D/2.. at pos)
  float c1[VEC], s1[VEC], c2[VEC], s2[VEC];
  const long long t = static_cast<long long>(pos) * D + d;
#pragma unroll
  for (int x = 0; x < VEC; x += 4) {
    load16(cos + t + x, c1 + x);
    load16(sin + t + x, s1 + x);
    load16(cos + t + D / 2 + x, c2 + x);
    load16(sin + t + D / 2 + x, s2 + x);
  }

  const int nq = B * H;
  const int rows = nq + B * Hk;
#pragma unroll 4
  for (int r = threadIdx.x / (HC * kRun); r < rows; r += RS) {
    const bool is_q = r < nq;
    const int i = is_q ? r : r - nq;
    const long long off =
        (is_q ? qs.at(i / H, pos, i % H) : ks.at(i / Hk, pos, i % Hk)) + d;
    const T* src = (is_q ? q : k) + off;
    T* dst = (is_q ? qr : kr) + off;
    float a[VEC], b[VEC];
    load_vec<VEC>(src, a);
    load_vec<VEC>(src + D / 2, b);
#pragma unroll
    for (int x = 0; x < VEC; ++x)
      rope_pair(a[x], b[x], c1[x], s1[x], c2[x], s2[x], a[x], b[x]);
    store_vec<VEC>(dst, a);
    store_vec<VEC>(dst + D / 2, b);
  }
}

// chunks of VEC values of T: 16 bytes, or 8 of a 16-bit type where
// D / 2 % 8 != 0
template <typename T, int VEC>
cudaError_t launch(const void* q, const void* k, void* qr, void* kr,
                   const float* sin, const float* cos, RowStrides qs,
                   RowStrides ks, int B, int S, int H, int Hk, int D,
                   cudaStream_t stream) {
  rope_qk_kernel<T, VEC><<<(S + kRun - 1) / kRun, kNT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<T*>(qr), static_cast<T*>(kr), sin, cos, qs, ks, B, S, H,
      Hk, D);
  return cudaGetLastError();
}

}  // namespace rope
}  // namespace pt

// q/qr [B,S,H,D] through strides (q_sb, q_ss, q_sh), k/kr [B,S,Hk,D]
// through (k_sb, k_ss, k_sh), D contiguous, D % 8 == 0 and 8 <= D <= 256;
// sin/cos [S,D] float32.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int pt_rope_qk(const void* q, const void* k, void* qr, void* kr,
                          const void* sin, const void* cos, int B, int S,
                          int H, int Hk, int D, long long q_sb,
                          long long q_ss, long long q_sh, long long k_sb,
                          long long k_ss, long long k_sh, int dtype,
                          void* stream) {
  if (B == 0 || S == 0) return 0;
  if (H <= 0 || Hk <= 0 || sin == nullptr || cos == nullptr ||
      !pt::head_dim_ok(D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sn = static_cast<const float*>(sin);
  const float* cs = static_cast<const float*>(cos);
  const pt::RowStrides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  // a 16-bit type in 8-byte chunks where a half row is not whole 16
  auto narrow = [&](auto e) {
    using E = decltype(e);
    return D / 2 % 8 ? pt::rope::launch<E, 4>(q, k, qr, kr, sn, cs, qs, ks,
                                              B, S, H, Hk, D, s)
                     : pt::rope::launch<E, 8>(q, k, qr, kr, sn, cs, qs, ks,
                                              B, S, H, Hk, D, s);
  };
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = pt::rope::launch<float, 4>(q, k, qr, kr, sn, cs, qs, ks, B, S, H,
                                       Hk, D, s);
      break;
    case 1:
      err = narrow(__nv_bfloat16{});
      break;
    case 2:
      err = narrow(__half{});
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
