// The split-KV walk (flash-decoding) shared by the decode-side kernels: one
// query token per row attends the row's keys, G query heads of one KV head
// at a time, with the keys cut into splits that separate blocks walk.
//
// Callers: paged decode (csrc/paged_decode.cu, keys through a block table),
// dense decode (csrc/decode.cu, keys at fixed strides of a per-slot cache),
// the span-1 rows of ragged paged attention (csrc/ragged_attention.cu,
// the query slab at the row's packed position, keys through its table) and
// the attention phase of the fused decode tick (csrc/fused_decode_tick.cu,
// paged decode's key_off, the persistent launch's blocks taking (split,
// KV head, row) items from a counter). Each runs one block of kNT threads
// per (split, KV head, row) and calls split_kv_walk with three things that
// say where its row lives: the element offset of the row's [G, D] query
// slab (its output slab has the same offset), the row's key count, and
// key_off(p), the element offset of key p's D-vector for this KV head in K
// (and V).
//
// Bound on this card: bytes. Every valid cached K/V row is read once for
// 4*D flops a query head, far below the ~295 flops/byte at which the H100
// stops being memory bound. So the walk spreads a long row over many SMs:
//   - the wrapper picks the split length (a multiple of the 32-key page)
//     from the longest row the cache can hold, since the lengths live on
//     the device; blocks whose split starts past the row's length exit at
//     once, so nothing past a row's length is fetched.
//   - the block serves all G = H / Hkv query heads of its KV head from one
//     read of K/V (GQA without repeated K/V).
//   - 32-key pages of the split stream through a 2-3 stage cp.async ring,
//     kept in the input type in shared memory (not widened). Keys at or
//     past the length are zero-filled by the copy (stale rows may hold
//     NaN).
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
//     split skips the partials; a row of length 0 writes zeros.
// Numbers: P is rounded per 32-key page against the split's running max
// and the splits are summed in another order than the plain versions' one
// softmax, so a row differs from them at the rounding level; the tolerance
// is chip_smoke.py's TOL.
#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace pt {
namespace skv {

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

// The work of block (split, kvh, row): q/out slab at element offset qo,
// `len` keys (already clamped to the cache's capacity), key p at
// key_off(p). Partials and the ticket are indexed by (row, kvh). NACC
// accumulator registers a thread (G * D <= NACC * kNT; the bits do not
// depend on it).
template <typename T, int D, int NACC = kMaxAcc, typename KeyOff>
__device__ __forceinline__ void split_kv_walk(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, unsigned char* smem_raw, long long qo,
    int len, KeyOff key_off, int G, int row, int kvh, int Hkv, int split,
    int split_len, int n_split, float scale) {
  using Sh = Shape<T, D>;
  constexpr int NST = Sh::NST;
  __shared__ int s_ticket;
  T* sKV = reinterpret_cast<T*>(smem_raw);        // NST x [K page | V page]
  float* sQ = reinterpret_cast<float*>(smem_raw + NST * Sh::STAGE_BYTES);
  float* sS = sQ + G * D;
  float* sP = sS + G * kPage;
  float* s_alpha = sP + G * kPage;
  float* s_m = s_alpha + G;
  float* s_l = s_m + G;

  const int tid = threadIdx.x;
  const int GD = G * D;
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
      const long long off = ok ? key_off(p) + c * Sh::VEC : 0;
      tc::cp_async16(dK + j * D + c * Sh::VEC, k + off, ok);
      tc::cp_async16(dV + j * D + c * Sh::VEC, v + off, ok);
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
    // through L2: the fused decode tick writes q earlier in the same
    // launch, and this SM's L1 may hold the previous layer's q
    load16_cg(q + qo + e * Sh::VEC, buf);
#pragma unroll
    for (int x = 0; x < Sh::VEC; ++x) sQ[e * Sh::VEC + x] = buf[x];
  }
  for (int g = tid; g < G; g += kNT) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

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
    for (int a = 0; a < NACC; ++a) {
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
    for (int a = 0; a < NACC; ++a) {
      const int e = tid + a * kNT;
      if (e < GD) out[qo + e] = from_f<T>(acc[a] / fmaxf(s_l[e / D], 1e-30f));
    }
    return;
  }
  // ---- partials of this split, then the ticket
  const long long ps = (static_cast<long long>(row) * Hkv + kvh) * n_split;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int e = tid + a * kNT;
    if (e < GD) part_acc[(ps + split) * GD + e] = acc[a];
  }
  for (int g = tid; g < G; g += kNT) {
    part_m[(ps + split) * G + g] = s_m[g];
    part_l[(ps + split) * G + g] = s_l[g];
  }
  __threadfence();    // partials visible device-wide before the ticket
  __syncthreads();
  int* ticket = tickets + static_cast<long long>(row) * Hkv + kvh;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  if (s_ticket != n_act - 1) return;
  __threadfence();
  // ---- the last block combines the splits in split order (through L2:
  // the other blocks' partials may be stale in this SM's L1)
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
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

// Opt `kernel` into the walk's shared memory for G heads a block and
// launch it on the (n_split, Hkv, rows) grid with `args`.
template <typename T, int D, typename K, typename... Args>
cudaError_t launch_walk(K kernel, int G, int n_split, int Hkv, int rows,
                        cudaStream_t stream, Args... args) {
  const size_t smem = Shape<T, D>::smem_bytes(G);
  cudaError_t err = tc::use_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, Hkv, rows), kNT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Arguments every split-KV entry checks: G query heads a KV head of D fit
// the accumulator, and the splits (whole pages) cover `capacity` keys.
inline bool bad_split_args(int H, int Hkv, int D, int capacity,
                           int split_len, int n_split) {
  return Hkv <= 0 || H % Hkv || split_len <= 0 || split_len % kPage ||
         H / Hkv * D > kMaxAcc * kNT ||
         static_cast<long long>(n_split) * split_len < capacity;
}

}  // namespace skv
}  // namespace pt
