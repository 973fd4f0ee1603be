// Paged decode attention for Hopper: one query token per row attends that
// row's cache, read through its block table from the shared KV pool.
//
// Replaces paddle_tpu/kernels/pallas_paged_decode.py:_paged_kernel (the
// pallas_call at :215 in _paged_call; entry paged_decode_attention_pallas).
//
// Bound on this card: bytes. Every cached K/V row is read once for 4*D
// flops a query head, far below the ~295 flops/byte at which the H100
// stops being memory bound (8 rows of the 7B pool, lengths 1 to 4093:
// 147 MB, 0.044 ms at 3.35 TB/s).
//
// Design — the split-KV walk of csrc/split_kv.cuh (flash-decoding): one
// block of 128 threads per (row, KV head, split of the row's keys), G query
// heads a block from one read of K/V, 32-key pages through a cp.async
// ring, fp32 partials combined in split order by the last block of a (row,
// KV head) to finish, in the same launch. This file says where a row's keys
// live: key p of row b is row p % bs of pool block tables[b][p / bs], and
// sentinel table entries are clamped into the pool. One launch per call.
#include "split_kv.cuh"

namespace pt {
namespace pd {

template <typename T, int D>
__global__ void __launch_bounds__(skv::kNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int H, int Hkv, int nb, int bs, int mb, int split_len,
                    int n_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  // the G query heads of this KV head are consecutive: one [G, D] slab
  const long long qo = (static_cast<long long>(b) * H + kvh * G) * D;
  const int len = min(max(lengths[b], 0), mb * bs);
  const int* row_tbl = tables + static_cast<long long>(b) * mb;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * D;
  };
  skv::split_kv_walk<T, D>(q, pool_k, pool_v, out, part_m, part_l, part_acc,
                           tickets, smem_raw, qo, len, key_off, G, b, kvh,
                           Hkv, blockIdx.x, split_len, n_split, scale);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const int* tables, const int* lengths, void* out,
                       float* pm, float* pl, float* pa, int* tickets, int B,
                       int H, int Hkv, int nb, int bs, int mb, int split_len,
                       int n_split, cudaStream_t s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(pk);
  const T* vt = static_cast<const T*>(pv);
  T* ot = static_cast<T*>(out);
#define PT_PAGED(DD)                                                        \
  case DD:                                                                  \
    return skv::launch_walk<T, DD>(paged_decode_kernel<T, DD>, H / Hkv,     \
                                   n_split, Hkv, B, s, qt, kt, vt, tables,  \
                                   lengths, ot, pm, pl, pa, tickets, H, Hkv, \
                                   nb, bs, mb, split_len, n_split, scale);
  switch (D) {
    PT_PAGED(64)
    PT_PAGED(128)
    PT_PAGED(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_PAGED
}

}  // namespace pd
}  // namespace pt

// q [B,H,D]; pool_k/pool_v [nb,bs,Hkv,D]; tables [B,mb] int32;
// lengths [B] int32; out [B,H,D]. Scratch: part_m/part_l
// [B,Hkv,n_split,G] and part_acc [B,Hkv,n_split,G,D] float32; tickets
// [>= B*Hkv] int32, zero before the launch and left zero by it.
// split_len: keys a split (a multiple of 32); n_split * split_len >=
// mb * bs. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* tables,
                               const void* lengths, void* out, void* part_m,
                               void* part_l, void* part_acc, void* tickets,
                               int B, int H, int Hkv, int D, int nb, int bs,
                               int mb, int split_len, int n_split,
                               int is_bf16, void* stream) {
  if (B == 0) return 0;
  if (pt::skv::bad_split_args(H, Hkv, D, mb * bs, split_len, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  cudaError_t err =
      is_bf16 ? pt::pd::dispatch_d<__nv_bfloat16>(
                    D, q, pool_k, pool_v, tbl, len, out, pm, pl, pa, tk, B, H,
                    Hkv, nb, bs, mb, split_len, n_split, s)
              : pt::pd::dispatch_d<float>(D, q, pool_k, pool_v, tbl, len, out,
                                          pm, pl, pa, tk, B, H, Hkv, nb, bs,
                                          mb, split_len, n_split, s);
  return static_cast<int>(err);
}
