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
// Any head dim D % 8 == 0 up to 256 runs at its padded width (64, 128 or
// 256; attention_common.cuh), the pool's rows read D elements each.
//
// Quantized pools (the reference's int8 and fp8 modes, _paged_kernel's
// quantized branches): int8 K/V with per-row-per-head float32 scale planes
// [nb, bs, Hkv] (key p's scale at the same (block, row, head) as its data),
// or e4m3 with per-block planes [nb, Hkv]; the walk's quantized design
// (split_kv.cuh narrow_walk: 8 KB pages, keys owned by warps, scores by
// whole warps) reads half (int8 at D = 128: D + 4 bytes a row and head
// instead of 2D) or a quarter of the bytes.
#include "split_kv.cuh"

namespace pt {
namespace pd {

// kPad: hd < D; without it hd is D and the walk's column checks fold away
template <typename T, int D, typename KT, int QM, int NACC, bool kPad>
__global__ void __launch_bounds__(skv::kNT)
paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pool_k,
                    const KT* __restrict__ pool_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int H, int Hkv, int hd, int nb, int bs, int mb,
                    int split_len, int n_split, float scale) {
  if constexpr (!kPad) hd = D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  // the G query heads of this KV head are consecutive: one [G, hd] slab
  const long long qo = (static_cast<long long>(b) * H + kvh * G) * hd;
  const int len = min(max(lengths[b], 0), mb * bs);
  const int* row_tbl = tables + static_cast<long long>(b) * mb;
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * hd;
  };
  // a key's scale: per row and head (int8), per block and head (fp8)
  auto scale_off = [&](int p) -> long long {
    const long long phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return QM == 2 ? phys * Hkv + kvh : (phys * bs + p % bs) * Hkv + kvh;
  };
  skv::split_kv_walk<T, D, NACC>(q, pool_k, pool_v, out, part_m, part_l,
                                 part_acc, tickets, smem_raw, qo, len,
                                 key_off,
                                 Scales<QM, decltype(scale_off)>{
                                     k_scale, v_scale, scale_off},
                                 G, hd, b, kvh, Hkv, blockIdx.x, split_len,
                                 n_split, scale);
}

// One launch at padded width D: a pool of the query's type keeps the widest
// accumulator (the page walk as it was); a quantized pool's walk takes as
// few accumulator registers as G * D needs (skv::with_nacc; the same
// bits).
template <typename T, int D, typename KT, int QM>
cudaError_t launch_d(const T* q, const KT* pk, const KT* pv, const float* ks,
                     const float* vs, const int* tables, const int* lengths,
                     T* out, float* pm, float* pl, float* pa, int* tickets,
                     int B, int H, int Hkv, int hd, int nb, int bs, int mb,
                     int split_len, int n_split, float scale,
                     cudaStream_t s) {
  auto go = [&](auto nacc) {
    constexpr int NACC = decltype(nacc)::value;
    // the unpadded instantiation for a bf16 query at hd == D (float32
    // keeps the padded one: a shorter build, off the bf16 serving path)
    auto kernel = paged_decode_kernel<T, D, KT, QM, NACC, true>;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      if (hd == D) kernel = paged_decode_kernel<T, D, KT, QM, NACC, false>;
    return skv::launch_walk<T, D, KT>(
        kernel, H / Hkv, n_split, Hkv, B, s, q, pk, pv, ks, vs, tables,
        lengths, out, pm, pl, pa, tickets, H, Hkv, hd, nb, bs, mb,
        split_len, n_split, scale);
  };
  if constexpr (QM == 0)
    return go(std::integral_constant<int, skv::kMaxAcc>{});
  else
    return skv::with_nacc<D>(H / Hkv, go);
}

template <typename T, typename KT, int QM>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const float* ks, const float* vs, const int* tables,
                       const int* lengths, void* out, float* pm, float* pl,
                       float* pa, int* tickets, int B, int H, int Hkv, int nb,
                       int bs, int mb, int split_len, int n_split,
                       cudaStream_t s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const T* qt = static_cast<const T*>(q);
  const KT* kt = static_cast<const KT*>(pk);
  const KT* vt = static_cast<const KT*>(pv);
  T* ot = static_cast<T*>(out);
  return with_head_dim(D, [&](auto dp) {
    return launch_d<T, decltype(dp)::value, KT, QM>(
        qt, kt, vt, ks, vs, tables, lengths, ot, pm, pl, pa, tickets, B, H,
        Hkv, D, nb, bs, mb, split_len, n_split, scale, s);
  });
}

// Every (query type, pool mode) of one head dim: mode 0 the pool in the
// query's type, 1 int8 with per-row planes, 2 e4m3 with per-block planes.
template <typename T>
cudaError_t dispatch_mode(int mode, int D, const void* q, const void* pk,
                          const void* pv, const float* ks, const float* vs,
                          const int* tables, const int* lengths, void* out,
                          float* pm, float* pl, float* pa, int* tickets, int B,
                          int H, int Hkv, int nb, int bs, int mb,
                          int split_len, int n_split, cudaStream_t s) {
  switch (mode) {
    case 0:
      return dispatch_d<T, T, 0>(D, q, pk, pv, ks, vs, tables, lengths, out,
                                 pm, pl, pa, tickets, B, H, Hkv, nb, bs, mb,
                                 split_len, n_split, s);
    case 1:
      return dispatch_d<T, int8_t, 1>(D, q, pk, pv, ks, vs, tables, lengths,
                                      out, pm, pl, pa, tickets, B, H, Hkv,
                                      nb, bs, mb, split_len, n_split, s);
    case 2:
      return dispatch_d<T, __nv_fp8_e4m3, 2>(D, q, pk, pv, ks, vs, tables,
                                             lengths, out, pm, pl, pa,
                                             tickets, B, H, Hkv, nb, bs, mb,
                                             split_len, n_split, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pd
}  // namespace pt

// q [B,H,D]; pool_k/pool_v [nb,bs,Hkv,D]: the query's type (mode 0), int8
// (mode 1, k_scale/v_scale float32 [nb,bs,Hkv]) or e4m3 (mode 2,
// k_scale/v_scale float32 [nb,Hkv]); the planes are null in mode 0.
// tables [B,mb] int32; lengths [B] int32; out [B,H,D]; D % 8 == 0, 8 <=
// D <= 256. Scratch: part_m/part_l [B,Hkv,n_split,G] and part_acc
// [B,Hkv,n_split,G,Dp] float32 (Dp: D's padded width, 64, 128 or 256);
// tickets [>= B*Hkv] int32, zero before the launch and left zero by it.
// split_len: keys a split (a multiple of 32); n_split * split_len
// >= mb * bs. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* lengths, void* out, void* part_m,
                               void* part_l, void* part_acc, void* tickets,
                               int B, int H, int Hkv, int D, int nb, int bs,
                               int mb, int split_len, int n_split,
                               int is_bf16, int mode, void* stream) {
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
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((mode != 0) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      is_bf16 ? pt::pd::dispatch_mode<__nv_bfloat16>(
                    mode, D, q, pool_k, pool_v, ks, vs, tbl, len, out, pm, pl,
                    pa, tk, B, H, Hkv, nb, bs, mb, split_len, n_split, s)
              : pt::pd::dispatch_mode<float>(
                    mode, D, q, pool_k, pool_v, ks, vs, tbl, len, out, pm, pl,
                    pa, tk, B, H, Hkv, nb, bs, mb, split_len, n_split, s);
  return static_cast<int>(err);
}
