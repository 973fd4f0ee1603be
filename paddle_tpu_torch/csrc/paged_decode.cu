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
// Design — split-KV (flash-decoding), so a long row is read by many SMs at
// once and the grid fills the card:
//   - one block of 128 threads per (row, KV head, split of the row's
//     keys); the wrapper picks the split length (a multiple of the 32-key
//     page) from the longest row the tables can hold. Blocks whose split
//     starts past the row's length exit at once, so nothing past a row's
//     length is fetched.
//   - the block serves all G = H / Hkv query heads of its KV head from one
//     read of K/V (GQA without repeated K/V).
//   - 32-key pages of the split stream through a 2-3 stage cp.async ring,
//     kept in the input type in shared memory (not widened). Keys at or
//     past the length are zero-filled by the copy (stale pool rows may hold
//     NaN), and sentinel table entries are clamped into the pool.
//   - per page: scores by groups of 8 lanes (a 16-byte chunk each, shuffle
//     sums), an online softmax per head by one warp, P rounded to the input
//     type against the split's running max, then acc = acc * alpha + P V
//     with the [G, D] accumulator in registers.
//   - a split writes fp32 partials (m, l, unnormalised acc) to scratch the
//     wrapper allocates; the last block of a (row, KV head) to finish —
//     counted by a ticket in a persistent zeroed buffer, which it resets to
//     0 — rescales them by exp(m_s - m_max) and sums them in split order,
//     so the bits do not depend on which block finished last, then writes
//     out = acc / max(l, 1e-30) rounded once. A row whose keys fit one
//     split skips the partials; a row of length 0 writes zeros. One launch
//     per call.
// Numbers: P is rounded per 32-key page against the split's running max
// and the splits are summed in another order than the plain version's one
// softmax, so a row differs from it (and from a span-1 row of the ragged
// kernel) at the rounding level; the tolerance is chip_smoke.py's TOL.
#include <math.h>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace pt {
namespace pd {

constexpr int kPage = 32;     // keys a page: one step of the walk
constexpr int kNT = 128;      // threads a block
constexpr int kLanes = 8;     // lanes that share one score
constexpr int kMaxAcc = 16;   // accumulator elements a thread: G * D <= 2048

template <typename T, int D>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);      // elements a 16-byte chunk
  static constexpr int CH = D / VEC;              // chunks a row
  static constexpr int TILE = kPage * D;          // elements of a K or V page
  static constexpr size_t STAGE_BYTES = 2 * TILE * sizeof(T);
  static constexpr int NST = STAGE_BYTES <= 16384 ? 3 : 2;   // ring stages
  static_assert(CH % kLanes == 0, "a score's chunks split over 8 lanes");
  static_assert(kPage * CH % kNT == 0, "every thread copies the same count");
  // the ring, then floats: Q [G][D], scores and P [G][kPage] each, and
  // alpha, m, l [G] each
  static size_t smem_bytes(int G) {
    return NST * STAGE_BYTES + (G * D + 2 * G * kPage + 3 * G) * sizeof(float);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int H, int Hkv, int nb, int bs, int mb, int split_len,
                    int n_split, float scale) {
  using Sh = Shape<T, D>;
  constexpr int NST = Sh::NST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ticket;
  const int G = H / Hkv;
  T* sKV = reinterpret_cast<T*>(smem_raw);        // NST x [K page | V page]
  float* sQ = reinterpret_cast<float*>(smem_raw + NST * Sh::STAGE_BYTES);
  float* sS = sQ + G * D;
  float* sP = sS + G * kPage;
  float* s_alpha = sP + G * kPage;
  float* s_m = s_alpha + G;
  float* s_l = s_m + G;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int GD = G * D;
  // the G query heads of this KV head are consecutive: one [G, D] slab
  const long long qo = (static_cast<long long>(b) * H + kvh * G) * D;
  const int len = min(max(lengths[b], 0), mb * bs);
  if (len == 0) {
    if (split == 0)
      for (int e = tid; e < GD; e += kNT) out[qo + e] = from_f<T>(0.f);
    return;
  }
  const int s0 = split * split_len;
  if (s0 >= len) return;
  const int s1 = min(len, s0 + split_len);
  const int n_act = (len + split_len - 1) / split_len;
  const int n_pages = (s1 - s0 + kPage - 1) / kPage;
  const int* row_tbl = tables + static_cast<long long>(b) * mb;
  const long long kv_row = static_cast<long long>(Hkv) * D;

  // page pg of the split into stage st; keys at or past s1 zero-filled
  auto issue = [&](int pg, int st) {
    T* dK = sKV + st * 2 * Sh::TILE;
    T* dV = dK + Sh::TILE;
    const int p0 = s0 + pg * kPage;
#pragma unroll
    for (int i = 0; i < kPage * Sh::CH / kNT; ++i) {
      const int e = tid + i * kNT;
      const int j = e / Sh::CH;
      const int c = e % Sh::CH;
      const int p = p0 + j;
      const bool ok = p < s1;
      long long off = 0;
      if (ok) {
        const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
        off = (static_cast<long long>(phys) * bs + p % bs) * kv_row +
              kvh * D + c * Sh::VEC;
      }
      tc::cp_async16(dK + j * D + c * Sh::VEC, pool_k + off, ok);
      tc::cp_async16(dV + j * D + c * Sh::VEC, pool_v + off, ok);
    }
  };
  // NST - 1 pages in flight before the walk (empty groups past the end
  // keep the wait count uniform)
#pragma unroll
  for (int pg = 0; pg < NST - 1; ++pg) {
    if (pg < n_pages) issue(pg, pg);
    tc::cp_async_commit();
  }
  for (int e = tid; e < GD / Sh::VEC; e += kNT) {
    float buf[Sh::VEC];
    load16(q + qo + e * Sh::VEC, buf);
#pragma unroll
    for (int x = 0; x < Sh::VEC; ++x) sQ[e * Sh::VEC + x] = buf[x];
  }
  for (int g = tid; g < G; g += kNT) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int part = tid % kLanes;
  for (int pg = 0; pg < n_pages; ++pg) {
    const int st = pg % NST;
    tc::cp_async_wait<NST - 2>();   // page pg has landed
    __syncthreads();                // ... for every thread; stage pg-1 read
    if (pg + NST - 1 < n_pages) issue(pg + NST - 1, (pg + NST - 1) % NST);
    tc::cp_async_commit();
    const T* cK = sKV + st * 2 * Sh::TILE;
    const T* cV = cK + Sh::TILE;
    const int p0 = s0 + pg * kPage;

    // ---- scores: item (g, j) by 8 lanes, each a 16-byte chunk in turn
    for (int it = tid / kLanes; it < G * kPage; it += kNT / kLanes) {
      const int g = it / kPage;
      const int j = it % kPage;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < Sh::CH / kLanes; ++i) {
        const int c = part + i * kLanes;
        float kf[Sh::VEC];
        load16(cK + j * D + c * Sh::VEC, kf);
        const float* qq = sQ + g * D + c * Sh::VEC;
#pragma unroll
        for (int x = 0; x < Sh::VEC; ++x) s = fmaf(qq[x], kf[x], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (part == 0) sS[it] = p0 + j < s1 ? s * scale : kNegInf;
    }
    __syncthreads();
    // ---- online softmax: warp w owns heads w, w+4, ...; lane = key
    for (int g = warp; g < G; g += kNT / 32) {
      const bool valid = p0 + lane < s1;
      const float s = sS[g * kPage + lane];
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float sum = warp_sum(pr);
      sP[g * kPage + lane] = to_f(from_f<T>(pr));
      if (lane == 0) {
        s_alpha[g] = alpha;
        s_l[g] = alpha * s_l[g] + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // ---- acc = acc * alpha + P V: thread owns elements tid + 128a of
    // the [G, D] accumulator
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kNT;
      if (e < GD) {
        const int g = e / D;
        const int d = e % D;
        const float* pp = sP + g * kPage;
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < kPage; ++j) dot = fmaf(pp[j], to_f(cV[j * D + d]), dot);
        acc[a] = acc[a] * s_alpha[g] + dot;
      }
    }
  }
  tc::cp_async_wait<0>();

  if (n_act == 1) {   // the row's only split: normalise and write
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kNT;
      if (e < GD) out[qo + e] = from_f<T>(acc[a] / fmaxf(s_l[e / D], 1e-30f));
    }
    return;
  }
  // ---- partials of this split, then the ticket
  const long long ps = (static_cast<long long>(b) * Hkv + kvh) * n_split;
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kNT;
    if (e < GD) part_acc[(ps + split) * GD + e] = acc[a];
  }
  for (int g = tid; g < G; g += kNT) {
    part_m[(ps + split) * G + g] = s_m[g];
    part_l[(ps + split) * G + g] = s_l[g];
  }
  __threadfence();    // partials visible device-wide before the ticket
  __syncthreads();
  int* ticket = tickets + static_cast<long long>(b) * Hkv + kvh;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  if (s_ticket != n_act - 1) return;
  __threadfence();
  // ---- the last block combines the splits in split order (through L2:
  // the other blocks' partials may be stale in this SM's L1)
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kNT;
    if (e < GD) {
      const int g = e / D;
      float m_max = kNegInf;
      for (int s = 0; s < n_act; ++s)
        m_max = fmaxf(m_max, __ldcg(part_m + (ps + s) * G + g));
      float sum = 0.f, l = 0.f;
      for (int s = 0; s < n_act; ++s) {
        const float w = expf(__ldcg(part_m + (ps + s) * G + g) - m_max);
        sum = fmaf(w, __ldcg(part_acc + (ps + s) * GD + e), sum);
        l = fmaf(w, __ldcg(part_l + (ps + s) * G + g), l);
      }
      out[qo + e] = from_f<T>(sum / fmaxf(l, 1e-30f));
    }
  }
  if (tid == 0) *ticket = 0;   // ready for the next launch
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* tables, const int* lengths, void* out,
                   float* part_m, float* part_l, float* part_acc,
                   int* tickets, int B, int H, int Hkv, int nb, int bs,
                   int mb, int split_len, int n_split, cudaStream_t stream) {
  using Sh = Shape<T, D>;
  auto kernel = paged_decode_kernel<T, D>;
  const size_t smem = Sh::smem_bytes(H / Hkv);
  cudaError_t err = tc::use_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, Hkv, B);
  kernel<<<grid, kNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), tables, lengths, static_cast<T*>(out),
      part_m, part_l, part_acc, tickets, H, Hkv, nb, bs, mb, split_len,
      n_split, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const int* tables, const int* lengths, void* out,
                       float* pm, float* pl, float* pa, int* tickets, int B,
                       int H, int Hkv, int nb, int bs, int mb, int split_len,
                       int n_split, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, pk, pv, tables, lengths, out, pm, pl, pa,
                           tickets, B, H, Hkv, nb, bs, mb, split_len, n_split,
                           s);
    case 128:
      return launch<T, 128>(q, pk, pv, tables, lengths, out, pm, pl, pa,
                            tickets, B, H, Hkv, nb, bs, mb, split_len,
                            n_split, s);
    case 256:
      return launch<T, 256>(q, pk, pv, tables, lengths, out, pm, pl, pa,
                            tickets, B, H, Hkv, nb, bs, mb, split_len,
                            n_split, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (Hkv <= 0 || H % Hkv || split_len <= 0 || split_len % pt::pd::kPage ||
      H / Hkv * D > pt::pd::kMaxAcc * pt::pd::kNT ||
      static_cast<long long>(n_split) * split_len <
          static_cast<long long>(mb) * bs)
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
