// Dense-cache decode attention for Hopper: one query token per row attends
// that row's own slot of a dense per-slot cache [B, S_max, Hkv, D], over its
// first lengths[b] positions.
//
// Replaces paddle_tpu/kernels/pallas_decode.py:_decode_kernel (the
// pallas_call at :116 in _decode_call, entry decode_attention_pallas).
// Bound on this card: bytes — each valid cached K/V row is read once for
// 4*D flops a query head, far below the ~295 flops/byte at which the H100
// stops being memory bound (8 rows, lengths 1 to 4096: 214 MB, 0.064 ms at
// 3.35 TB/s).
//
// Design — the split-KV walk of csrc/split_kv.cuh, paged decode's: one
// block of 128 threads per (row, KV head, split of the row's keys), so a
// long row is read by many SMs at once; the G query heads of a KV head
// share one read of K/V (the Pallas kernel's block-diagonal wide query is
// a TPU matrix-unit device and has no place here); fp32 partials combined
// in split order by the last block of a (row, KV head) to finish, in the
// same launch, so two launches give the same bits. The dense cache is the
// paged walk over B blocks of S_max rows with the table arange(B): key p of
// row b sits at ((b * S_max + p) * Hkv + kvh) * D, with no table to read.
// Nothing past lengths[b] is fetched (stale rows may hold NaN). One launch
// per call.
#include "split_kv.cuh"

namespace pt {
namespace dd {

template <typename T, int D>
__global__ void __launch_bounds__(skv::kNT)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int H, int Hkv, int s_max, int split_len, int n_split,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const long long qo = (static_cast<long long>(b) * H + kvh * G) * D;
  const int len = min(max(lengths[b], 0), s_max);
  const long long row0 = static_cast<long long>(b) * s_max;
  auto key_off = [&](int p) -> long long {
    return ((row0 + p) * Hkv + kvh) * D;
  };
  skv::split_kv_walk<T, D>(q, k_cache, v_cache, out, part_m, part_l,
                           part_acc, tickets, smem_raw, qo, len, key_off, G,
                           b, kvh, Hkv, blockIdx.x, split_len, n_split,
                           scale);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kc, const void* vc,
                       const int* lengths, void* out, float* pm, float* pl,
                       float* pa, int* tickets, int B, int H, int Hkv,
                       int s_max, int split_len, int n_split,
                       cudaStream_t s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kc);
  const T* vt = static_cast<const T*>(vc);
  T* ot = static_cast<T*>(out);
#define PT_DENSE(DD)                                                         \
  case DD:                                                                   \
    return skv::launch_walk<T, DD>(dense_decode_kernel<T, DD>, H / Hkv,      \
                                   n_split, Hkv, B, s, qt, kt, vt, lengths,  \
                                   ot, pm, pl, pa, tickets, H, Hkv, s_max,   \
                                   split_len, n_split, scale);
  switch (D) {
    PT_DENSE(64)
    PT_DENSE(128)
    PT_DENSE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_DENSE
}

}  // namespace dd
}  // namespace pt

// q [B,H,D]; k_cache/v_cache [B,S_max,Hkv,D]; lengths [B] int32;
// out [B,H,D]. Scratch: part_m/part_l [B,Hkv,n_split,G] and part_acc
// [B,Hkv,n_split,G,D] float32; tickets [>= B*Hkv] int32, zero before the
// launch and left zero by it. split_len: keys a split (a multiple of 32);
// n_split * split_len >= S_max. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_decode(const void* q, const void* k_cache,
                         const void* v_cache, const void* lengths, void* out,
                         void* part_m, void* part_l, void* part_acc,
                         void* tickets, int B, int H, int Hkv, int D,
                         int s_max, int split_len, int n_split, int is_bf16,
                         void* stream) {
  if (B == 0) return 0;
  if (pt::skv::bad_split_args(H, Hkv, D, s_max, split_len, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  cudaError_t err =
      is_bf16 ? pt::dd::dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, len,
                                                  out, pm, pl, pa, tk, B, H,
                                                  Hkv, s_max, split_len,
                                                  n_split, s)
              : pt::dd::dispatch_d<float>(D, q, k_cache, v_cache, len, out,
                                          pm, pl, pa, tk, B, H, Hkv, s_max,
                                          split_len, n_split, s);
  return static_cast<int>(err);
}
