// Ragged paged attention for Hopper: a packed buffer of variable-length
// query spans (decode rows are spans of 1, prefill chunks spans of n)
// attends causally within each span through the spans' block tables.
//
// Replaces paddle_tpu/kernels/pallas_ragged_attention.py:_ragged_kernel
// (the pallas_call at :238 in _ragged_call; entry
// ragged_paged_attention_pallas). Semantics per sequence r: span token i
// (packed row qstart[r] + i) sits at position kvlen[r] - qlen[r] + i and
// attends positions 0 .. that position; packed rows outside every span are
// left as the caller's zeros.
//
// Bound on this card: bytes for decode rows (each cached K/V row is read
// once per KV head for 4*D flops a query head) and operations for a long
// prefill chunk (the causal span-by-cache product). So one call launches
// two grids back to back on the caller's stream, each shaped for one kind
// of span, from shapes alone (the spans live on the device):
//
//   ragged_split_kernel — span-1 rows (qlen == 1), both types: the split-KV
//     walk of csrc/split_kv.cuh, paged decode's (a quantized pool's too,
//     launched as paged_decode.cu launches it). One block per (split, KV
//     head, sequence); the query slab is packed row qstart[r], the length
//     kvlen[r], keys through the row's table. Blocks of rows whose
//     qlen != 1 exit at once.
//   ragged_wgmma_kernel — chunk spans (qlen >= 2) in bfloat16, on the
//     tensor cores, over any pool (quantized ones below): the flash
//     forward's wgmma tile (csrc/flash.cu). One
//     warpgroup per (64-row tile of the span, sequence, head), tiles past
//     the span exiting at once (the last tiles, the longest causal walks,
//     are scheduled first); Q [64, D] copied once; 64-key K/V tiles stream
//     through a two-stage ring of swizzled bf16 shared tiles, each 16-byte
//     cp.async computing its own key's address through the table
//     (tc::load_tile_paged: a tile spans 64 / bs pool blocks); S = Q K^T as
//     wgmma.m64n64k16, P from registers into wgmma.m64nDk16, the O
//     accumulator in registers. The span's causal offset kvlen - qlen is
//     arbitrary (a chunk may start mid-block), so every key tile that
//     crosses any of a warp's rows' limits is masked, not only a diagonal
//     tile. Keys at or past kvlen are zero-filled and masked (stale pool
//     rows may hold NaN); Q rows past the span load as zeros and are not
//     written.
//   ragged_kernel — chunk spans in float32, on the CUDA cores: one block
//     per (16-row tile, sequence, head) running attention_common.cuh's tile
//     routine, 32-key tiles. The fp32 parity runs depend on it.
//
// Quantized pools (the reference's int8 and fp8 modes, _ragged_kernel's
// quantized branches): int8 K/V with per-row-per-head float32 planes, or
// e4m3 with per-block planes. Span-1 rows take the walk's quantized mode.
// bf16 chunk spans take the wgmma tile: each 64-key K/V tile streams as
// narrow bytes (8 KB at D = 128) by cp.async through the table, with its
// keys' 64 K and 64 V scales, into a two-stage ring; once it lands, each
// thread converts the bytes its own copies brought into ONE swizzled bf16
// K and V tile (exact: every int8 and e4m3 value is a bf16 value), then
// fence.proxy.async and a barrier before the first wgmma reads it. The
// scales come after the dot, the reference's separability: S times
// 1/sqrt(D), then the key's K scale; l sums the unscaled P; the V scale
// is folded into P before P is rounded to bf16 for the PV product.
// float32 chunk spans take ragged_kernel, each K/V tile converted to
// float32 as it lands, with the same order (attention_common.cuh).
//
// Any head dim D % 8 == 0 up to 256 runs at its padded width Dp (64, 128
// or 256; attention_common.cuh): tiles of Dp columns, those past D
// zero-filled by the copies (a narrow row of D % 16 == 8 bytes by 8-byte
// copies), D columns written. GQA indexes the KV head as h / (H / Hkv)
// (K/V never repeated). Numbers:
// P is rounded to the input type per key tile (or page) against a running
// max where the plain version rounds the normalised P, so the kernels
// agree with it within chip_smoke.py's TOL; a span-1 row and a paged
// decode row run the same walk but split at other lengths (the split rule
// counts rows), so they too agree within TOL.
#include "split_kv.cuh"

namespace pt {

// ------------------------------------------------ span-1 rows, split-KV
// a key's scale index in a quantized pool's planes: per row and head
// (QM 1), per block and head (QM 2)
template <int QM>
__device__ __forceinline__ long long scale_index(int phys, int p, int bs,
                                                 int Hkv, int kvh) {
  return QM == 2 ? static_cast<long long>(phys) * Hkv + kvh
                 : (static_cast<long long>(phys) * bs + p % bs) * Hkv + kvh;
}

// kPad: hd < D; without it hd is D and the walk's column checks fold away
template <typename T, int D, typename KT, int QM, int NACC, bool kPad>
__global__ void __launch_bounds__(skv::kNT)
ragged_split_kernel(const T* __restrict__ q, const KT* __restrict__ pool_k,
                    const KT* __restrict__ pool_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qlen,
                    const int* __restrict__ kvlen, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ tickets,
                    int H, int Hkv, int hd, int nb, int bs, int mb,
                    int split_len, int n_split, float scale) {
  if constexpr (!kPad) hd = D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int r = blockIdx.z;
  if (qlen[r] != 1) return;                   // not a decode row
  const int G = H / Hkv;
  const long long qo = (static_cast<long long>(qstart[r]) * H + kvh * G) * hd;
  const int len = min(max(kvlen[r], 0), mb * bs);
  const int* row_tbl = tables + static_cast<long long>(r) * mb;
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * hd;
  };
  auto scale_off = [&](int p) -> long long {
    return scale_index<QM>(min(max(row_tbl[p / bs], 0), nb - 1), p, bs, Hkv,
                           kvh);
  };
  skv::split_kv_walk<T, D, NACC>(q, pool_k, pool_v, out, part_m, part_l,
                                 part_acc, tickets, smem_raw, qo, len,
                                 key_off,
                                 Scales<QM, decltype(scale_off)>{
                                     k_scale, v_scale, scale_off},
                                 G, hd, r, kvh, Hkv, blockIdx.x, split_len,
                                 n_split, scale);
}

// ---------------------------------- chunk spans, float32, CUDA cores
constexpr int kRaggedTQ = 16;

template <typename T, int D, typename KT, int QM>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const KT* __restrict__ pool_k,
              const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ tables,
              const int* __restrict__ qstart, const int* __restrict__ qlen,
              const int* __restrict__ kvlen, T* __restrict__ out, int H,
              int Hkv, int hd, int nb, int bs, int mb, float scale) {
  extern __shared__ __align__(16) float smem[];
  using S = TileShape<T, D, kRaggedTQ>;
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int h = blockIdx.z;
  const int ql = qlen[r];
  const int i0 = tile * kRaggedTQ;
  if (ql < 2 || i0 >= ql) return;             // a decode row, or past the span
  const int kvh = h / (H / Hkv);
  const int kl = kvlen[r];
  const int first_pos = kl - ql + i0;         // position of tile row 0
  const int rows = min(kRaggedTQ, ql - i0);
  const int qs = qstart[r];
  long long* s_qoff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS) + kKeys;
  if (threadIdx.x < kRaggedTQ) {
    const int i = threadIdx.x;
    s_qoff[i] = i < rows
        ? (static_cast<long long>(qs + i0 + i) * H + h) * hd : -1LL;
  }
  const int kv_valid = min(max(kl, 0), mb * bs);
  const int kv_stop = min(kv_valid, max(first_pos + rows, 0));
  const int* row_tbl = tables + static_cast<long long>(r) * mb;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return ((static_cast<long long>(phys) * bs + p % bs) * Hkv + kvh) * hd;
  };
  auto row_pos = [&](int i) { return first_pos + i; };
  auto scale_off = [&](int p) -> long long {
    return scale_index<QM>(min(max(row_tbl[p / bs], 0), nb - 1), p, bs, Hkv,
                           kvh);
  };
  __syncthreads();
  attend_tile<T, D, kRaggedTQ>(
      q, pool_k, pool_v, out, smem, s_qoff, row_pos, kv_stop, kv_valid,
      key_off, hd, scale,
      Scales<QM, decltype(scale_off)>{k_scale, v_scale, scale_off});
}

// ---------------------------------- chunk spans, bf16, tensor cores
namespace rtc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 64;    // span rows a block: one warpgroup
constexpr int kBN = 64;    // keys a tile
constexpr int kNT = 128;

// A bf16 pool: the Q tile, two stages of K and of V, and 1 KB to align
// the atoms. A quantized pool (QM 1, 2): the Q tile and ONE bf16 K and V
// tile that the conversion fills, then the ring that hides the latency:
// two stages of the narrow K and V tiles (a byte a value) and their 64 K
// and 64 V scales. 82,944 and 83,968 bytes at D = 128: two blocks an SM
// either way; 164,864 and 165,888 at D = 256: one.
template <int D, int QM>
constexpr size_t smem_bytes() {
  return QM == 0 ? static_cast<size_t>(kBM + 4 * kBN) * D * sizeof(bf16) +
                       1024
                 : static_cast<size_t>(kBM + 2 * kBN) * D * sizeof(bf16) +
                       2 * (2 * kBN * D + 2 * kBN * sizeof(float)) + 1024;
}
template <int D>
constexpr int blocks_per_sm() {
  return D == 256 ? 1 : 2;
}

// KT, QM: the pool (bf16, 0; int8, 1; e4m3, 2) and its scale planes
// (null for a bf16 pool); kPad: hd < D (without it hd is D and the tiles'
// column checks fold away)
template <int D, typename KT, int QM, bool kPad>
__global__ void __launch_bounds__(kNT, blocks_per_sm<D>())
ragged_wgmma_kernel(const bf16* __restrict__ q,
                    const KT* __restrict__ pool_k,
                    const KT* __restrict__ pool_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qlen,
                    const int* __restrict__ kvlen, bf16* __restrict__ out,
                    int H, int Hkv, int hd, int nb, int bs, int mb,
                    float scale) {
  if constexpr (!kPad) hd = D;
  const int r = blockIdx.y;
  const int h = blockIdx.z;
  const int ql = qlen[r];
  const int i0 = (gridDim.x - 1 - static_cast<int>(blockIdx.x)) * kBM;
  if (ql < 2 || i0 >= ql) return;             // a decode row, or past the span
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int KV_STAGES = QM == 0 ? 2 : 1;  // bf16 K/V tiles
  bf16* sQ = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* sK = sQ + kBM * D;
  bf16* sV = sK + KV_STAGES * kBN * D;
  // a quantized pool's ring: stage st holds the narrow K tile, the narrow
  // V tile ([kBN][D] bytes each), then 64 K scales and 64 V scales
  uint8_t* sN = reinterpret_cast<uint8_t*>(sV + KV_STAGES * kBN * D);
  float* sS = reinterpret_cast<float*>(sN + 2 * 2 * kBN * D);
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NS = kBN / 8;

  const int kvh = h / (H / Hkv);
  const int kl = kvlen[r];
  const int kv_valid = min(max(kl, 0), mb * bs);
  const int first_pos = kl - ql + i0;         // position of tile row 0
  const int rows = min(kBM, ql - i0);
  // keys past the tile's last row are seen by no row of it
  const int kv_stop = min(kv_valid, max(first_pos + rows, 0));
  const int n_kt = (kv_stop + kBN - 1) / kBN;
  const long long q_row = static_cast<long long>(H) * hd;
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  const long long q0 = static_cast<long long>(qstart[r]) + i0;
  const bf16* qb = q + q0 * q_row + h * hd;
  const int* row_tbl = tables + static_cast<long long>(r) * mb;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int w0 = first_pos + warp * 16;       // this warp's first position
  const int pos[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};

  // key tile j into ring stage j & 1: bf16 straight into the swizzled
  // tiles; narrow bytes and each key's K and V scale (thread i < 64: key i's
  // K scale, else key i - 64's V scale), zeros past kv_stop (stale pool
  // rows and planes may hold anything, and 0 * NaN is NaN)
  auto stage = [&](int j) {
    const int st = j & 1, k0 = j * kBN;
    if constexpr (QM == 0) {
      tc::load_tile_paged<kBN, D, kNT>(sK + st * kBN * D, pool_k, row_tbl, k0,
                                       kv_stop, nb, bs, kv_row, kvh, hd);
      tc::load_tile_paged<kBN, D, kNT>(sV + st * kBN * D, pool_v, row_tbl, k0,
                                       kv_stop, nb, bs, kv_row, kvh, hd);
    } else {
      uint8_t* nk = sN + st * 2 * kBN * D;
      tc::load_tile_paged_narrow<kBN, D, kNT>(
          nk, reinterpret_cast<const uint8_t*>(pool_k), row_tbl, k0, kv_stop,
          nb, bs, kv_row, kvh, hd);
      tc::load_tile_paged_narrow<kBN, D, kNT>(
          nk + kBN * D, reinterpret_cast<const uint8_t*>(pool_v), row_tbl, k0,
          kv_stop, nb, bs, kv_row, kvh, hd);
      static_assert(kNT == 2 * kBN, "a scale a thread");
      const int p = k0 + (threadIdx.x & (kBN - 1));
      const bool ok = p < kv_stop;
      const float* plane = threadIdx.x < kBN ? k_scale : v_scale;
      long long at = 0;
      if (ok)
        at = scale_index<QM>(min(max(row_tbl[p / bs], 0), nb - 1), p, bs, Hkv,
                             kvh);
      tc::cp_async4(sS + st * 2 * kBN + threadIdx.x, plane + at, ok);
    }
  };

  tc::load_tile<kBM, D, kNT>(sQ, qb, q_row, rows, hd);
  stage(0);
  tc::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    const int k0 = j * kBN;
    if (j + 1 < n_kt) {
      stage(j + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    // a quantized tile: each thread converts the bytes its own copies
    // brought into the one bf16 K and V tile (the last tile's products are
    // done: the barrier that ended its iteration)
    if constexpr (QM != 0) {
      const uint8_t* nk = sN + st * 2 * kBN * D;
      tc::narrow_to_bf16<KT, kBN, D, kNT>(sK, nk);
      tc::narrow_to_bf16<KT, kBN, D, kNT>(sV, nk + kBN * D);
    }
    // the copies (and the conversion's generic-proxy writes) made visible
    // to wgmma's async-proxy reads
    tc::fence_proxy_async();
    __syncthreads();
    const bf16* cK = sK + (QM == 0 ? st : 0) * kBN * D;
    const bf16* cV = sV + (QM == 0 ? st : 0) * kBN * D;
    const float* ksc = sS + st * 2 * kBN;   // the tile's K scales (quantized)
    const float* vsc = ksc + kBN;           // ... and V scales

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    tc::pin(s);
    tc::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::wgmma_m64n64_ss(s, tc::desc_k_major<kBM>(sQ, ks),
                          tc::desc_k_major<kBN>(cK, ks));
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::pin(s);

    // a tile reaching past this warp's first row's limit, or past the
    // valid keys, is masked key by key. A quantized pool's K scale
    // multiplies the score after 1/sqrt(D), the reference's order.
    const bool edge = k0 + kBN - 1 > w0 || k0 + kBN > kv_valid;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 kf = make_float2(1.f, 1.f);
      if constexpr (QM != 0)
        kf = *reinterpret_cast<const float2*>(ksc + n * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if constexpr (QM != 0) x *= i & 1 ? kf.y : kf.x;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (i & 1);
          x = key < kv_valid && key <= pos[i >> 1] ? x : kNegInf;
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mn = fmaxf(m[rr], tc::quad_max(mx[rr]));
      alpha[rr] = tc::exp2_fast((m[rr] - mn) * tc::kLog2e);
      m[rr] = mn;
      ml[rr] = mn * tc::kLog2e;
    }
    // l sums the unscaled P; a quantized pool's V scale is folded into P
    // after, before P is rounded to bf16 for the PV product
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 vf = make_float2(1.f, 1.f);
      if constexpr (QM != 0)
        vf = *reinterpret_cast<const float2*>(vsc + n * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[n][i];
        float p = tc::exp2_fast(fmaf(x, tc::kLog2e, -ml[i >> 1]));
        p = x == kNegInf ? 0.f : p;
        rs[i >> 1] += p;
        if constexpr (QM != 0) p *= i & 1 ? vf.y : vf.x;
        s[n][i] = p;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = alpha[rr] * l[rr] + rs[rr];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      tc::to_a_frag(pa[kk], s[2 * kk], s[2 * kk + 1]);
    tc::pin(o);
    tc::pin(pa);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      tc::wgmma_pv<D>(o, pa[kk], tc::desc_mn_major<kBN>(cV, kk));
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::pin(o);
    tc::pin(pa);
    __syncthreads();
  }
  tc::cp_async_wait<0>();   // a span whose tile sees no key issued Q only

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lr = fmaxf(tc::quad_sum(l[rr]), 1e-30f);
    const int i = warp * 16 + (lane >> 2) + 8 * rr;
    if (i >= rows) continue;
    bf16* orow = out + (q0 + i) * q_row + h * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 >= hd) break;
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          tc::pack_bf16(o[n][2 * rr] / lr, o[n][2 * rr + 1] / lr);
    }
  }
}

}  // namespace rtc

// Both grids of one call at padded width D of head dim hd, split-KV
// first, on one stream. bf16 chunks take the wgmma tile on any pool;
// float32 chunks the CUDA-core tile.
template <typename T, int D, typename KT, int QM>
cudaError_t launch(const T* q, const KT* pk, const KT* pv, const float* ks,
                   const float* vs, const int* tables, const int* qs,
                   const int* ql, const int* kl, T* out, float* pm, float* pl,
                   float* pa, int* tickets, int T_, int R, int H, int Hkv,
                   int hd, int nb, int bs, int mb, int split_len, int n_split,
                   cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  // the split-KV grid: a quantized pool's walk with as few accumulator
  // registers as G * D needs, as paged_decode.cu launches it
  auto split_grid = [&](auto nacc) {
    constexpr int NACC = decltype(nacc)::value;
    // the unpadded instantiation for a bf16 query at hd == D (float32
    // keeps the padded one: a shorter build, off the bf16 serving path)
    auto kernel = ragged_split_kernel<T, D, KT, QM, NACC, true>;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      if (hd == D) kernel = ragged_split_kernel<T, D, KT, QM, NACC, false>;
    return skv::launch_walk<T, D, KT>(
        kernel, H / Hkv,
        n_split, Hkv, R, stream, q, pk, pv, ks, vs, tables, qs, ql, kl, out,
        pm, pl, pa, tickets, H, Hkv, hd, nb, bs, mb, split_len, n_split,
        scale);
  };
  cudaError_t err;
  if constexpr (QM == 0)
    err = split_grid(std::integral_constant<int, skv::kMaxAcc>{});
  else
    err = skv::with_nacc<D>(H / Hkv, split_grid);
  if (err != cudaSuccess) return err;
  // no span is longer than the packed buffer, so ceil(T / rows a tile)
  // tiles cover every span
  if constexpr (sizeof(T) == 2) {
    auto kernel = hd == D ? rtc::ragged_wgmma_kernel<D, KT, QM, false>
                          : rtc::ragged_wgmma_kernel<D, KT, QM, true>;
    constexpr size_t smem = rtc::smem_bytes<D, QM>();
    err = tc::use_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + rtc::kBM - 1) / rtc::kBM, R, H);
    kernel<<<grid, rtc::kNT, smem, stream>>>(q, pk, pv, ks, vs, tables, qs,
                                             ql, kl, out, H, Hkv, hd, nb, bs,
                                             mb, scale);
  } else {
    using S = TileShape<T, D, kRaggedTQ>;
    auto kernel = ragged_kernel<T, D, KT, QM>;
    err = allow_smem(kernel, S::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + kRaggedTQ - 1) / kRaggedTQ, R, H);
    kernel<<<grid, kThreads, S::SMEM_BYTES, stream>>>(
        q, pk, pv, ks, vs, tables, qs, ql, kl, out, H, Hkv, hd, nb, bs, mb,
        scale);
  }
  return cudaGetLastError();
}

template <typename T, typename KT, int QM>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const float* ks, const float* vs, const int* tables,
                       const int* qs, const int* ql, const int* kl, void* out,
                       float* pm, float* pl, float* pa, int* tickets, int T_,
                       int R, int H, int Hkv, int nb, int bs, int mb,
                       int split_len, int n_split, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const KT* kt = static_cast<const KT*>(pk);
  const KT* vt = static_cast<const KT*>(pv);
  T* ot = static_cast<T*>(out);
  return with_head_dim(D, [&](auto dp) {
    return launch<T, decltype(dp)::value, KT, QM>(
        qt, kt, vt, ks, vs, tables, qs, ql, kl, ot, pm, pl, pa, tickets, T_,
        R, H, Hkv, D, nb, bs, mb, split_len, n_split, s);
  });
}

// every pool mode of one query type (mode 0: the query's type, 1: int8
// with per-row planes, 2: e4m3 with per-block planes)
template <typename T>
cudaError_t dispatch_mode(int mode, int D, const void* q, const void* pk,
                          const void* pv, const float* ks, const float* vs,
                          const int* tables, const int* qs, const int* ql,
                          const int* kl, void* out, float* pm, float* pl,
                          float* pa, int* tickets, int T_, int R, int H,
                          int Hkv, int nb, int bs, int mb, int split_len,
                          int n_split, cudaStream_t s) {
#define PT_RAGGED_MODE(KT, QM)                                              \
  dispatch_d<T, KT, QM>(D, q, pk, pv, ks, vs, tables, qs, ql, kl, out, pm, \
                        pl, pa, tickets, T_, R, H, Hkv, nb, bs, mb,         \
                        split_len, n_split, s)
  switch (mode) {
    case 0:
      return PT_RAGGED_MODE(T, 0);
    case 1:
      return PT_RAGGED_MODE(int8_t, 1);
    case 2:
      return PT_RAGGED_MODE(__nv_fp8_e4m3, 2);
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_RAGGED_MODE
}

}  // namespace pt

// q [T,H,D]; pool_k/pool_v [nb,bs,Hkv,D] of the query's type (mode 0),
// int8 (mode 1; k_scale/v_scale float32 [nb,bs,Hkv]) or e4m3 (mode 2;
// k_scale/v_scale float32 [nb,Hkv]), the planes null in mode 0; tables
// [R,mb] int32; qstart,
// qlen, kvlen [R] int32; out [T,H,D], zeroed by the caller (rows outside
// every span are not written). Scratch of the span-1 rows' split-KV walk:
// part_m/part_l [R,Hkv,n_split,G] and part_acc [R,Hkv,n_split,G,Dp]
// float32 (Dp: D's padded width, 64, 128 or 256); tickets [>= R*Hkv]
// int32, zero before the launch and left zero by it. split_len: keys a
// split (a multiple of 32); n_split * split_len >= mb * bs. D % 8 == 0,
// 8 <= D <= 256. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_ragged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* qstart, const void* qlen,
                                   const void* kvlen, void* out, void* part_m,
                                   void* part_l, void* part_acc,
                                   void* tickets, int T_, int R, int H,
                                   int Hkv, int D, int nb, int bs, int mb,
                                   int split_len, int n_split, int is_bf16,
                                   int mode, void* stream) {
  if (T_ == 0 || R == 0) return 0;
  if (pt::skv::bad_split_args(H, Hkv, D, mb * bs, split_len, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* qs = static_cast<const int*>(qstart);
  const int* ql = static_cast<const int*>(qlen);
  const int* kl = static_cast<const int*>(kvlen);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((mode != 0) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      is_bf16 ? pt::dispatch_mode<__nv_bfloat16>(
                    mode, D, q, pool_k, pool_v, ks, vs, tbl, qs, ql, kl, out,
                    pm, pl, pa, tk, T_, R, H, Hkv, nb, bs, mb, split_len,
                    n_split, s)
              : pt::dispatch_mode<float>(
                    mode, D, q, pool_k, pool_v, ks, vs, tbl, qs, ql, kl, out,
                    pm, pl, pa, tk, T_, R, H, Hkv, nb, bs, mb, split_len,
                    n_split, s);
  return static_cast<int>(err);
}
