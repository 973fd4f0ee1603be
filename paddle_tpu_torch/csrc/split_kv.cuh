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
// say where its row lives: the element offset of the row's [G, hd] query
// slab (its output slab has the same offset), the row's key count, and
// key_off(p), the element offset of key p's hd-vector for this KV head in K
// (and V). The walk runs at the padded width D of head dim hd
// (attention_common.cuh): pages, the staged query and the accumulator are
// D wide, the columns past hd zero-filled by the copies, and the partials
// are [G, D] (kernels/split_kv.py scratch sizes them).
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
//
// Quantized pools (serving/block_manager.py): K/V of type KT = int8_t with
// per-row-per-head float32 scale planes (QM 1), or __nv_fp8_e4m3 with
// per-block planes (QM 2), walk on their own design (narrow_walk below)
// where a KV head has G * D <= 512 (LLaMA-7B's G = 1 at D = 128, a GQA
// model's G = 4 at D = 128), since the page walk above spends
// its time on per-key instructions and barriers, not on bytes (a 4 KB int8
// page ran at the 8 KB bf16 page's device time). More query heads a KV
// head keep the page walk, with the narrow page in its ring and the
// scales a page ahead (page_walk):
//   - pages of 8 KB of K and 8 KB of V whatever D (64 keys at D = 128),
//     a bf16 page's bytes; each warp owns a quarter of every page's keys
//     and streams them through a ring of its own (4 stages of 4 KB: three
//     pages in flight, 64 KB a block), so a page costs a warp barrier,
//     never a block barrier;
//   - scores: the whole warp on a key, a lane's D / 32 columns read as
//     one 16-, 32- or 64-bit word and widened exactly (int8 by a byte
//     permute under 2^23, e4m3 two at a time by the f16x2 convert), the
//     query staged once in shared memory as float32; the warp's partial
//     sums of its keys reduced by a transposing butterfly (one shuffle a
//     key and head at D = 128), after which lane l holds key
//     l / (32 / keys a warp);
//   - an online softmax a warp: each warp keeps its own running m and l
//     (slots of its own in shared memory) and its slice of the [G, D]
//     accumulator (D / 32 columns a head) in registers; P V reads each
//     key's P from the warp's slots and a 32-bit word of its V row;
//   - the four warps combine once, at the end of the split, through
//     shared memory (weights exp(m_w - m), in warp order), and the
//     split's partials, tickets and split-order combine are the ones
//     above.
// The scales keep the reference kernel's order
// (pallas_paged_decode.py:_paged_kernel): the K scale multiplies the score
// after the dot and 1/sqrt(D) (s = (q . k) * scale * k_scale), the softmax
// sum l is taken over the unscaled P, and only then is the V scale folded
// into P, which stays float32; each key's scales are read a page ahead
// into registers. The result's bits depend on (G, D) and the split plan
// alone, so paged decode, ragged's span-1 rows and the fused tick, which
// pick the walk and its accumulator width by one rule (with_nacc), give
// the same bits. The split rule and the tolerances are the same.
#pragma once

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace pt {
namespace skv {

constexpr int kPage = 32;     // keys a page: one step of the walk
constexpr int kNT = 128;      // threads a block
constexpr int kLanes = 8;     // lanes that share one score
constexpr int kMaxAcc = 16;   // accumulator elements a thread: G * D <= 2048

// T the query's type, KT the pool's (T, int8_t or __nv_fp8_e4m3)
template <typename T, int D, typename KT = T>
struct Shape {
  static constexpr int CVEC = 16 / sizeof(KT);    // elements a 16-byte copy
  static constexpr int CCH = D / CVEC;            // copies a padded row
  // elements a score chunk: a 16-byte load of T, 8 narrow values
  static constexpr int SVEC = sizeof(KT) == 1 ? 8 : 16 / sizeof(KT);
  static constexpr int SCH = D / SVEC;            // score chunks a row
  static constexpr int TILE = kPage * D;          // elements of a K or V page
  static constexpr size_t STAGE_BYTES = 2 * TILE * sizeof(KT);
  static constexpr int NST = STAGE_BYTES <= 16384 ? 3 : 2;   // ring stages
  static_assert(SCH % kLanes == 0, "a score's chunks split over 8 lanes");
  static_assert(kPage * CCH % kNT == 0, "every thread copies the same count");
  // the ring, then floats: Q [G][D], scores and P [G][kPage] each, alpha,
  // m, l [G] each, and a page's K and V scales [kPage] each
  static size_t smem_bytes(int G) {
    return NST * STAGE_BYTES +
           (G * D + 2 * G * kPage + 3 * G + 2 * kPage) * sizeof(float);
  }
};

// The narrow walk's geometry at head dim D (one byte an element)
template <int D>
struct Narrow {
  static constexpr int kWarpsNT = kNT / 32;
  static constexpr int PAGE = 8192 / D;          // keys a page: 8 KB of K
  static constexpr int KW = PAGE / kWarpsNT;     // keys a warp a page
  static constexpr int DL = D / 32;              // a lane's columns of a key
  static constexpr int R = 32 / KW;              // lanes sharing a reduced key
  static constexpr int WSTAGE = 2 * KW * D;      // bytes of a warp's stage
  static constexpr int NST = 4;                  // a warp's ring stages
  static constexpr int RING_BYTES = kWarpsNT * NST * WSTAGE;
  static constexpr int CPL = KW * D / 16 / 32;   // 16-byte copies a lane
  static_assert(KW <= 32 && 32 % KW == 0 && CPL >= 1, "a warp's page slice");
  // the rings (after the walk: each warp's [G][D] accumulator slice, 8
  // KB at most for G * D <= 4 * kNT), then floats: q [G][D], each warp's
  // m, l, alpha [G] and P [G][KW], the split's m and l [G]
  static_assert(kWarpsNT * 4 * kNT * 4 <= RING_BYTES,
                "the warps' accumulators fit the rings");
  static size_t smem_bytes(int G) {
    return RING_BYTES +
           (static_cast<size_t>(G) * D + kWarpsNT * G * (3 + KW) + 2 * G) *
               sizeof(float);
  }
};

// Dynamic shared memory of the walk for G heads a KV head (narrow_walk:
// a quantized pool with G * D <= 4 * kNT)
template <typename T, int D, typename KT = T>
size_t walk_smem_bytes(int G) {
  if constexpr (sizeof(KT) == 1)
    if (G * D <= 4 * kNT) return Narrow<D>::smem_bytes(G);
  return Shape<T, D, KT>::smem_bytes(G);
}

// The end of a split: a row's only split writes out = acc / max(l, 1e-30)
// rounded once; otherwise the split's fp32 partials (m, l, unnormalised
// acc) go to scratch and the last block of the (row, KV head) to finish —
// counted by a ticket in a persistent zeroed buffer, which it resets to 0
// — rescales them by exp(m_s - m_max) and sums them in split order, so the
// bits do not depend on which block finished last. acc[a] is element
// tid + kNT * a of the [G, D] accumulator (D padded; its columns past hd
// are not written out); s_m / s_l the split's m and l, in shared memory
// that every thread sees.
template <typename T, int NACC>
__device__ __forceinline__ void finish_split(
    const float (&acc)[NACC], const float* s_m, const float* s_l,
    T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, long long qo, int G, int D, int hd, int row,
    int kvh, int Hkv, int split, int n_split, int n_act) {
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int GD = G * D;
  // element e of the [G, D] accumulator in the [G, hd] output slab, and
  // whether it is one of the row's columns (hd >= D: all are, and the
  // checks fold away at the unpadded width)
  auto out_at = [&](int e) {
    return hd >= D ? qo + e : qo + e / D * hd + e % D;
  };
  auto own = [&](int e) { return hd >= D || e % D < hd; };
  if (n_act == 1) {   // the row's only split: normalise and write
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int e = tid + a * kNT;
      if (e < GD && own(e))
        out[out_at(e)] = from_f<T>(acc[a] / fmaxf(s_l[e / D], 1e-30f));
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
    if (e < GD && own(e)) {
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
      out[out_at(e)] = from_f<T>(sum / fmaxf(l, 1e-30f));
    }
  }
  if (tid == 0) *ticket = 0;   // ready for the next launch
}

// The row's [G, hd] query slab at q + qo into sQ [G][D] as float32, zeros
// past hd (through L2: the fused decode tick writes q earlier in the same
// launch, and this SM's L1 may hold the previous layer's q)
template <typename T, int D>
__device__ __forceinline__ void stage_query(const T* __restrict__ q,
                                            float* sQ, long long qo, int G,
                                            int hd) {
  constexpr int QV = 16 / sizeof(T);    // q elements a 16-byte load
  for (int e = threadIdx.x; e < G * D / QV; e += kNT) {
    const int g = e / (D / QV);
    const int c = e % (D / QV) * QV;
    float buf[QV];
    if (hd >= D || c < hd) {
      load16_cg(q + qo + g * hd + c, buf);
    } else {
#pragma unroll
      for (int x = 0; x < QV; ++x) buf[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < QV; ++x) sQ[g * D + c + x] = buf[x];
  }
}

// ---------------------------------------------- the narrow walk's pieces
// N narrow bytes of a key row (a lane's columns) -> N floats, exactly.
// int8: each byte XORed with 0x80 holds q + 128; put under the exponent of
// 2^23 it is the float 2^23 + q + 128, less 2^23 + 128 (no int-to-float
// convert). e4m3: two at a time by the f16x2 convert, then to float.
template <int N>
__device__ __forceinline__ void narrow_words(const uint8_t* p,
                                             uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N == 2)
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  else if constexpr (N == 4)
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}
template <int N>
__device__ __forceinline__ void widen(const int8_t* p, float (&o)[N]) {
  uint32_t w[(N + 3) / 4];
  narrow_words<N>(reinterpret_cast<const uint8_t*>(p), w);
#pragma unroll
  for (int i = 0; i < N; ++i)
    o[i] = __fadd_rn(__uint_as_float(__byte_perm(w[i / 4] ^ 0x80808080u,
                                                 0x4B000000u,
                                                 0x7440u + i % 4)),
                     -8388736.0f);
}
template <int N>
__device__ __forceinline__ void widen(const __nv_fp8_e4m3* p,
                                      float (&o)[N]) {
  uint32_t w[(N + 3) / 4];
  narrow_words<N>(reinterpret_cast<const uint8_t*>(p), w);
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w[i / 4] >> (8 * (i % 4))),
        __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    o[i] = f.x;
    o[i + 1] = f.y;
  }
}

// Each lane holds N partial sums (keys 0 .. N-1 of a warp's slice, over
// its own columns); afterwards v[0] of lane l holds key l / (32 / N)
// summed over all 32 lanes. Each butterfly step halves the keys a lane
// keeps (lanes with the offset's bit set keep the upper half) and adds
// its partner's half, so N keys cost N - 1 shuffles, not 5N; once one key
// is left the remaining offsets add plainly. Lanes that share a key end
// with the same bits (a + b == b + a).
template <int N, int O, int M>
__device__ __forceinline__ void transpose_sum(float (&v)[M], int lane) {
  if constexpr (N > 1) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    transpose_sum<N / 2, O / 2>(v, lane);
  } else if constexpr (O > 0) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    transpose_sum<1, O / 2>(v, lane);
  }
}

// The quantized walk of a split [s0, s1) (see the header): per-warp rings,
// whole-warp scores, an online softmax a warp, the warps combined at the
// end, then finish_split. A warp's running m, l, alpha and P of each head
// live in its own shared slots (the head loop of the scores is not
// unrolled), its [G, D] accumulator slice in registers: NACC sizes them
// (GM = NACC * kNT / D heads at most); the bits do not depend on it.
template <typename T, int D, int NACC, typename KT, typename KeyOff, int QM,
          typename ScaleOff>
__device__ __forceinline__ void narrow_walk(
    const T* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, unsigned char* smem_raw, long long qo,
    int s0, int s1, int n_act, KeyOff key_off, Scales<QM, ScaleOff> sc,
    int G, int hd, int row, int kvh, int Hkv, int split, int n_split,
    float scale) {
  using N = Narrow<D>;
  constexpr int KW = N::KW, DL = N::DL, R = N::R, NST = N::NST;
  constexpr int GM = NACC * kNT / D > 0 ? NACC * kNT / D : 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kk = lane / R;              // this lane's key after the sums
  const int GD = G * D;
  const int n_pages = (s1 - s0 + N::PAGE - 1) / N::PAGE;
  unsigned char* ring = smem_raw + warp * NST * N::WSTAGE;
  float* sQ = reinterpret_cast<float*>(smem_raw + N::RING_BYTES);  // [G][D]
  float* wM = sQ + GD + warp * G * (3 + KW);    // this warp's m [G],
  float* wL = wM + G;                           // l [G],
  float* wA = wL + G;                           // alpha [G],
  float* wP = wA + G;                           // P [G][KW]

  // this warp's keys of page pg into stage st; keys at or past s1 and
  // columns past hd zero-filled
  auto issue = [&](int pg, int st) {
    unsigned char* dK = ring + st * N::WSTAGE;
    unsigned char* dV = dK + KW * D;
    const int pw = s0 + pg * N::PAGE + warp * KW;
#pragma unroll
    for (int i = 0; i < N::CPL; ++i) {
      const int e = lane + i * 32;
      const int j = e / (D / 16);
      const int c = e % (D / 16);
      const int p = pw + j;
      const bool ok = p < s1;
      const long long off = ok ? key_off(p) + c * 16 : 0;
      const int left = !ok ? 0 : hd >= D ? 16 : hd - c * 16;
      tc::cp_async_row16(dK + j * D + c * 16,
                         reinterpret_cast<const uint8_t*>(k + off), k, left,
                         hd % 16 == 0);
      tc::cp_async_row16(dV + j * D + c * 16,
                         reinterpret_cast<const uint8_t*>(v + off), v, left,
                         hd % 16 == 0);
    }
  };
#pragma unroll
  for (int pg = 0; pg < NST - 1; ++pg) {
    if (pg < n_pages) issue(pg, pg);
    tc::cp_async_commit();
  }
  stage_query<T, D>(q, sQ, qo, G, hd);
  for (int g = lane; g < G; g += 32) {
    wM[g] = kNegInf;
    wL[g] = 0.f;
  }
  float acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int x = 0; x < DL; ++x) acc[g][x] = 0.f;
  // key kk's K and V scales of page pg, a page ahead (through L2: the
  // fused tick writes them in the same launch)
  float nks = 0.f, nvs = 0.f;
  auto load_scales = [&](int pg) {
    const int p = s0 + pg * N::PAGE + warp * KW + kk;
    const bool ok = pg < n_pages && p < s1;
    nks = ok ? __ldcg(sc.ks + sc.off(p)) : 0.f;
    nvs = ok ? __ldcg(sc.vs + sc.off(p)) : 0.f;
  };
  load_scales(0);
  __syncthreads();                  // sQ and the slots are written
  for (int pg = 0; pg < n_pages; ++pg) {
    const int st = pg % NST;
    const int pw = s0 + pg * N::PAGE + warp * KW;
    tc::cp_async_wait<NST - 2>();   // this lane's copies of page pg
    __syncwarp();                   // ... every lane's; stage pg-1 read
    const float ks = nks, vs = nvs;
    load_scales(pg + 1);
    if (pg + NST - 1 < n_pages) issue(pg + NST - 1, (pg + NST - 1) % NST);
    tc::cp_async_commit();
    if (pw >= s1) continue;         // no key of this warp's slice is live
    const KT* cK = reinterpret_cast<const KT*>(ring + st * N::WSTAGE);
    const KT* cV = cK + KW * D;
    const bool valid = pw + kk < s1;
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      // ---- scores: the warp on each key, then the transposing sums
      float qf[DL];
#pragma unroll
      for (int x = 0; x < DL; ++x) qf[x] = sQ[g * D + lane * DL + x];
      float s_[KW];
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float kf[DL];
        widen<DL>(cK + j * D + lane * DL, kf);
        float s = qf[0] * kf[0];
#pragma unroll
        for (int x = 1; x < DL; ++x) s = fmaf(qf[x], kf[x], s);
        s_[j] = s;
      }
      transpose_sum<KW, 16>(s_, lane);
      // ---- online softmax over the slice: K scale after the dot and
      // 1/sqrt(D); l over the unscaled P; the V scale folded in after
      float x = s_[0] * scale;
      x = x * ks;
      x = valid ? x : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 16; o >= R; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = wM[g];
      const float m_new = fmaxf(m_old, mx);
      const float pr = valid ? expf(x - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o >= R; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float l_new = alpha * wL[g] + sum;
      __syncwarp();                 // every lane has read m and l
      if (lane == 0) {
        wM[g] = m_new;
        wL[g] = l_new;
        wA[g] = alpha;
      }
      if (lane % R == 0) wP[g * KW + kk] = pr * vs;
    }
    __syncwarp();
    // ---- acc = acc * alpha + P V: a word of key j's V row a lane, its
    // P of each head from the warp's slots
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float a = wA[g];
#pragma unroll
      for (int x = 0; x < DL; ++x) acc[g][x] *= a;
    }
    auto pv_key = [&](int j) {
      float vf[DL];
      widen<DL>(cV + j * D + lane * DL, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float p = wP[g * KW + j];
#pragma unroll
        for (int x = 0; x < DL; ++x) acc[g][x] = fmaf(p, vf[x], acc[g][x]);
      }
    };
    // keys unrolled while the heads a lane may hold are few; with many,
    // a key loop keeps the code (and its build) small
    if constexpr (GM * KW <= 64) {
#pragma unroll
      for (int j = 0; j < KW; ++j) pv_key(j);
    } else {
#pragma unroll 1
      for (int j = 0; j < KW; ++j) pv_key(j);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                  // every warp is done with its ring

  // ---- the warps combine: each publishes its accumulator slice (into
  // the rings), then thread tid takes elements tid + kNT * a of [G, D]
  // and the heads tid, tid + kNT, ...
  float* sA = reinterpret_cast<float*>(smem_raw);   // [warp][G * D]
  float* s_m = reinterpret_cast<float*>(smem_raw + N::RING_BYTES) + GD +
               N::kWarpsNT * G * (3 + KW);          // the split's m, l
  float* s_l = s_m + G;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int x = 0; x < DL; ++x)
      sA[warp * GD + g * D + lane * DL + x] = acc[g][x];
  }
  __syncthreads();
  // warp w's m and l of head g
  auto slot = [&](int w, int g) {
    return reinterpret_cast<float*>(smem_raw + N::RING_BYTES) + GD +
           w * G * (3 + KW) + g;
  };
  auto head_max = [&](int g) {
    float mm = *slot(0, g);
#pragma unroll
    for (int w = 1; w < N::kWarpsNT; ++w) mm = fmaxf(mm, *slot(w, g));
    return mm;
  };
  for (int g = tid; g < G; g += kNT) {
    const float mm = head_max(g);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < N::kWarpsNT; ++w)
      ll = fmaf(expf(*slot(w, g) - mm), slot(w, g)[G], ll);
    s_m[g] = mm;
    s_l[g] = ll;
  }
  float out_acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int e = tid + a * kNT;
    out_acc[a] = 0.f;
    if (e < GD) {
      const int g = e / D;
      const float mm = head_max(g);
#pragma unroll
      for (int w = 0; w < N::kWarpsNT; ++w)
        out_acc[a] = fmaf(expf(*slot(w, g) - mm), sA[w * GD + e],
                          out_acc[a]);
    }
  }
  __syncthreads();                  // s_m, s_l seen by every thread
  finish_split<T, NACC>(out_acc, s_m, s_l, out, part_m, part_l, part_acc,
                        tickets, qo, G, D, hd, row, kvh, Hkv, split, n_split,
                        n_act);
}

// The walk of a split [s0, s1) in 32-key pages (see the header): a
// block-wide cp.async ring, scores by 8-lane groups, the online softmax a
// warp a head, P V with the [G, D] accumulator spread over the block,
// then finish_split. It serves pools of the query's type, and quantized
// pools whose KV head has more than 512 / D query heads (G * D > 4 * kNT,
// kMaxAcc accumulator registers: narrow_walk's registers for them raised
// the fused tick's register pressure and slowed all of it), with the
// scales in the reference's order as narrow_walk applies them.
template <typename T, int D, int NACC, typename KT, typename KeyOff, int QM,
          typename ScaleOff>
__device__ __forceinline__ void page_walk(
    const T* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, unsigned char* smem_raw, long long qo,
    int s0, int s1, int n_act, KeyOff key_off, Scales<QM, ScaleOff> sc,
    int G, int hd, int row, int kvh, int Hkv, int split, int n_split,
    float scale) {
  using Sh = Shape<T, D, KT>;
  constexpr int NST = Sh::NST;
  static_assert(QM == 0 || sizeof(KT) == 1, "scales go with a narrow pool");
  KT* sKV = reinterpret_cast<KT*>(smem_raw);      // NST x [K page | V page]
  float* sQ = reinterpret_cast<float*>(smem_raw + NST * Sh::STAGE_BYTES);
  float* sS = sQ + G * D;
  float* sP = sS + G * kPage;
  float* s_alpha = sP + G * kPage;
  float* s_m = s_alpha + G;
  float* s_l = s_m + G;
  float* sKS = s_l + G;                           // the page's K scales
  float* sVS = sKS + kPage;                       // ... and V scales

  const int tid = threadIdx.x;
  const int GD = G * D;
  const int n_pages = (s1 - s0 + kPage - 1) / kPage;

  // page pg of the split into stage st; keys at or past s1 and columns
  // past hd zero-filled (a narrow row of hd % 16 == 8 bytes by 8-byte
  // copies: such rows are 8-byte aligned)
  auto issue = [&](int pg, int st) {
    KT* dK = sKV + st * 2 * Sh::TILE;
    KT* dV = dK + Sh::TILE;
    const int p0 = s0 + pg * kPage;
#pragma unroll
    for (int i = 0; i < kPage * Sh::CCH / kNT; ++i) {
      const int e = tid + i * kNT;
      const int j = e / Sh::CCH;
      const int c = e % Sh::CCH;
      const int p = p0 + j;
      const bool ok = p < s1;
      const long long off = ok ? key_off(p) + c * Sh::CVEC : 0;
      const int left = !ok ? 0 : hd >= D ? 16
                                          : (hd - c * Sh::CVEC) * int(sizeof(KT));
      const bool whole = sizeof(KT) > 1 || hd % 16 == 0;
      tc::cp_async_row16(dK + j * D + c * Sh::CVEC,
                         reinterpret_cast<const uint8_t*>(k + off), k, left,
                         whole);
      tc::cp_async_row16(dV + j * D + c * Sh::CVEC,
                         reinterpret_cast<const uint8_t*>(v + off), v, left,
                         whole);
    }
  };
  // NST - 1 pages in flight before the walk (empty groups past the end
  // keep the wait count uniform)
#pragma unroll
  for (int pg = 0; pg < NST - 1; ++pg) {
    if (pg < n_pages) issue(pg, pg);
    tc::cp_async_commit();
  }
  stage_query<T, D>(q, sQ, qo, G, hd);
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
  // a quantized pool's scales, one page ahead: thread j < kPage loads key
  // j's K and V scale of the next page into registers while this page is
  // worked on (through L2: the fused tick writes them in the same launch)
  float nks = 0.f, nvs = 0.f;
  auto load_scales = [&](int pg) {
    const int p = s0 + pg * kPage + tid;
    const bool ok = tid < kPage && pg < n_pages && p < s1;
    nks = ok ? __ldcg(sc.ks + sc.off(p)) : 0.f;
    nvs = ok ? __ldcg(sc.vs + sc.off(p)) : 0.f;
  };
  if constexpr (QM != 0) load_scales(0);
  for (int pg = 0; pg < n_pages; ++pg) {
    const int st = pg % NST;
    const int p0 = s0 + pg * kPage;
    tc::cp_async_wait<NST - 2>();   // page pg has landed
    if constexpr (QM != 0) {
      // page pg's scales to shared memory (the previous page's were last
      // read before the PV phase's barrier), then the next page's loads
      if (tid < kPage) {
        sKS[tid] = nks;
        sVS[tid] = nvs;
      }
      load_scales(pg + 1);
    }
    __syncthreads();                // ... for every thread; stage pg-1 read
    if (pg + NST - 1 < n_pages) issue(pg + NST - 1, (pg + NST - 1) % NST);
    tc::cp_async_commit();
    const KT* cK = sKV + st * 2 * Sh::TILE;
    const KT* cV = cK + Sh::TILE;

    // ---- scores: item (g, j) by 8 lanes, each a chunk in turn
    for (int it = tid / kLanes; it < G * kPage; it += kNT / kLanes) {
      const int g = it / kPage;
      const int j = it % kPage;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < Sh::SCH / kLanes; ++i) {
        const int c = part + i * kLanes;
        float kf[Sh::SVEC];
        load_chunk(cK + j * D + c * Sh::SVEC, kf);
        const float* qq = sQ + g * D + c * Sh::SVEC;
#pragma unroll
        for (int x = 0; x < Sh::SVEC; ++x) s = fmaf(qq[x], kf[x], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (part == 0) {
        float x = s * scale;
        if constexpr (QM != 0) x = x * sKS[j];   // post-dot, after scale
        sS[it] = p0 + j < s1 ? x : kNegInf;
      }
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
      // l takes the unscaled P; a quantized pool's V scale is folded into
      // P after it, in float32
      if constexpr (QM != 0)
        sP[g * kPage + lane] = pr * sVS[lane];
      else
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
  finish_split<T, NACC>(acc, s_m, s_l, out, part_m, part_l, part_acc,
                        tickets, qo, G, D, hd, row, kvh, Hkv, split, n_split,
                        n_act);
}

// The work of block (split, kvh, row): the [G, hd] q/out slab at element
// offset qo, `len` keys (already clamped to the cache's capacity), key p
// at key_off(p), its scales (a quantized pool) at sc.off(p); D is hd's
// padded width. Partials and the
// ticket are indexed by (row, kvh). NACC accumulator registers a thread
// (G * D <= NACC * kNT): a quantized pool's caller picks it from G * D by
// with_nacc's rule (1, 4 or kMaxAcc), which also picks the walk — narrow_walk
// for 1 and 4, page_walk for kMaxAcc — so a row's bits depend on (G, D)
// and the split plan alone. A pool of the query's type takes page_walk.
template <typename T, int D, int NACC = kMaxAcc, typename KT, typename KeyOff,
          int QM, typename ScaleOff>
__device__ __forceinline__ void split_kv_walk(
    const T* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, unsigned char* smem_raw, long long qo,
    int len, KeyOff key_off, Scales<QM, ScaleOff> sc, int G, int hd,
    int row, int kvh, int Hkv, int split, int split_len, int n_split,
    float scale) {
  static_assert((QM == 0) == (sizeof(KT) == sizeof(T)) &&
                (QM == 0 || sizeof(KT) == 1),
                "scales go with a narrow pool, a wide pool is the query's type");
  const int tid = threadIdx.x;
  if (len == 0) {
    if (split == 0)
      for (int e = tid; e < G * hd; e += kNT) out[qo + e] = from_f<T>(0.f);
    return;
  }
  const int s0 = split * split_len;
  if (s0 >= len) return;
  const int s1 = min(len, s0 + split_len);
  const int n_act = (len + split_len - 1) / split_len;
  if constexpr (QM != 0 && NACC <= 4)
    narrow_walk<T, D, NACC>(q, k, v, out, part_m, part_l, part_acc, tickets,
                            smem_raw, qo, s0, s1, n_act, key_off, sc, G, hd,
                            row, kvh, Hkv, split, n_split, scale);
  else
    page_walk<T, D, NACC>(q, k, v, out, part_m, part_l, part_acc, tickets,
                          smem_raw, qo, s0, s1, n_act, key_off, sc, G, hd,
                          row, kvh, Hkv, split, n_split, scale);
}

// Opt `kernel` into the walk's shared memory for G heads a block and
// launch it on the (n_split, Hkv, rows) grid with `args`.
template <typename T, int D, typename KT = T, typename K, typename... Args>
cudaError_t launch_walk(K kernel, int G, int n_split, int Hkv, int rows,
                        cudaStream_t stream, Args... args) {
  const size_t smem = walk_smem_bytes<T, D, KT>(G);
  cudaError_t err = tc::use_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, Hkv, rows), kNT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The accumulator registers a thread for G heads of padded width D (1, 4
// or kMaxAcc: G * D <= NACC * kNT), as std::integral_constant to f — the
// instantiation
// a quantized walk's caller launches; the fused tick's attention item
// picks by the same rule.
template <int D, typename F>
cudaError_t with_nacc(int G, F f) {
  if constexpr (D <= kNT)
    if (G * D <= kNT) return f(std::integral_constant<int, 1>{});
  if (G * D <= 4 * kNT) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, kMaxAcc>{});
}

// Arguments every split-KV entry checks: a head dim the walk takes, G
// query heads a KV head of its padded width fitting the accumulator, and
// the splits (whole pages) covering `capacity` keys.
inline bool bad_split_args(int H, int Hkv, int hd, int capacity,
                           int split_len, int n_split) {
  return Hkv <= 0 || H % Hkv || !head_dim_ok(hd) || split_len <= 0 ||
         split_len % kPage || H / Hkv * padded_dim(hd) > kMaxAcc * kNT ||
         static_cast<long long>(n_split) * split_len < capacity;
}

}  // namespace skv
}  // namespace pt
