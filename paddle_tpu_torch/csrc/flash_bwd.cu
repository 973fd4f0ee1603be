// Flash attention backward for Hopper: two kernels, one per output group,
// over the [B, S, H, D] layout of the forward (csrc/flash.cu), from the
// forward's inputs, the output gradient dO, the forward's log-sum-exp
// lse [B, H, S] and delta = sum(dO * O) [B, H, S] (one torch op in the
// wrapper, as in the reference).
//
//   flash_bwd_dkv  replaces paddle_tpu/kernels/pallas_flash.py:_dkv_kernel
//                  (pallas_call at :335 in _flash_bwd): dK and dV.
//   flash_bwd_dq   replaces pallas_flash.py:_dq_kernel (pallas_call at
//                  :365): dQ.
//
// Per (query row i, key j) of a head, both recompute
//   P  = exp(S * scale - lse_i)          S = Q_i . K_j, causal j <= i
//   dP = dO_i . V_j
//   dS = P * (dP - delta_i) * scale
// and accumulate dV_j += P dO_i, dK_j += dS Q_i (dkv) or dQ_i += dS K_j
// (dq). Cast points follow the reference: P is rounded to the input type
// before P^T dO, dS before both dS^T Q and dS K; all sums run in fp32.
//
// Bound on this card: operations. Per causal pair and head the dkv kernel
// does four D-long products (8*D flops) and the dq kernel three, against
// a few bytes per row, far above the ~295 flops/byte where the H100's
// bf16 tensor cores stop waiting on memory (B=4, S=2048, 32 heads of 128:
// 0.278 ms for dK/dV, 0.209 ms for dQ at the 989 TFLOP/s bf16 peak).
//
// Common to all: blocks run in no order, so each block owns its outputs
// and walks the other dimension in a loop, where the Pallas grid walked a
// sequential axis. No atomics anywhere, so every run gives the same bits.
// Rows past S (the tail) load as zeros and carry P = dS = 0, so they add
// nothing (as _row_valid, :38, and :214-235); output rows past S are not
// written.
//
// bfloat16 — on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), from swizzled bf16 shared tiles filled by a two-stage
// cp.async ring (csrc/tensor_core.cuh). Four warps a block.
//   dkv (flash_bwd_dkv_bf16_kernel): one block per (batch, KV head, 64-key
//   tile); each warp owns 16 of the keys. K and V stay in shared memory
//   while 64-row Q/dO tiles (and their lse, delta) stream past, from the
//   diagonal tile to S (causal pruning, as :201). Per tile each warp
//   computes the transposed scores S^T = K Q^T and dP^T = V dO^T; P^T and
//   dS^T then sit in the accumulator layout and, rounded to bf16, are the
//   A operands of dV += P^T dO and dK += dS^T Q straight from registers
//   (dO and Q as B operands through ldmatrix.trans). The dK and dV
//   accumulators stay in registers (128 floats a thread at D=128), so a
//   tile is taken in two passes of 32 query columns to keep P^T and dP^T
//   to 32 more. GQA: the block loops over the KV head's group of query
//   heads, so dK/dV are summed over the group in registers. ~97 KB of
//   shared memory at D=128, two blocks an SM; key tiles first to last, so
//   the causally longest walks start first.
//   dq (flash_bwd_dq_bf16_kernel): the same design transposed. One block
//   per (batch*head, 64-row query tile); each warp owns 16 query rows. Q
//   and dO stay resident, each row's lse and delta in registers, and
//   64-key K/V tiles stream past from key tile 0 up to the diagonal. Per
//   tile S = Q K^T and dP = dO V^T (Q, dO as A operands, K, V as B), then
//   P and dS in registers; dS, rounded to bf16, is the A operand of
//   dQ += dS K with K through ldmatrix.trans, so dS never goes to shared
//   memory. The dQ accumulator is 64 floats a thread at D=128, S and dP
//   64 more. GQA indexes the KV head as h / (H / Hk). ~97 KB of shared
//   memory at D=128, two blocks an SM; the last query tiles (the longest
//   causal walks) are scheduled first.
//
// float32 — on the CUDA cores in fp32 (flash_bwd_dkv_kernel,
// flash_bwd_dq_kernel): 256 threads, each a 4x4 patch of the 64x64 S and
// dP tiles (16 shared loads feed 32 FMAs) and a 4 x D/16 patch of its
// [64, D] accumulators; shared rows padded by one float so the strided
// reads of a warp fall in distinct banks. Same block layout as above. At
// D = 256 the tiles are 32 rows (2 x 2 patches): four [64, 257] float
// tiles would not fit a block's shared memory.
//
// Head dims: any D % 8 == 0 up to 256 runs at its padded width Dp (64,
// 128 or 256), each row's two halves of D/2 columns at columns 0 and Dp/2
// of the tiles and zeros after each (tc::half_col), so the RoPE partner of
// a column is Dp/2 further whatever D, as the adjoints below read it;
// zero columns add nothing to the products, 1/sqrt(D) scales the scores,
// and only the D real columns are written. The halves of a D % 16 == 8
// row end mid-chunk, so the bf16 tiles take them by 8-byte copies.
// At Dp = 256 in bf16 a thread's dK and dV accumulators (128 floats each)
// would not fit its registers beside the products', so dK and dV are
// computed by separate blocks (grid z = 2: the dV blocks need no dP^T),
// and dQ takes each 64-key tile in two passes of 32 keys (S and dP at 32
// floats a thread each, beside its 128 dQ accumulators).
//
// Layouts: Q, dO and dQ are addressed through one set of element strides
// (batch, sequence, head; D contiguous), K, V, dK and dV through another,
// so [B, S, H, D] and head-major [B, H, S, D] memory share the bodies.
//
// Fused RoPE (the rope= mode, pallas_flash.py:211-213, :276-278, and the
// adjoints at :243-244, :305-306): the rotation of Q and K (_rope_block's
// prologues) is the pre-pass csrc/rope_qk.cu, run once a backward for both
// kernels, so the bodies read Q and K already rotated (rounded to the
// input type, as _rope_block rounds) and the same bodies serve both modes.
// With [S, D] float32 tables (kRope) the adjoint rotation is applied to
// the float32 dK and dQ accumulators before their one rounding: columns d
// and d + D/2 of a row sit in the same thread (fp32: columns tx + 16c and
// tx + 16(c + D/32); bf16: 8-column tiles n and n + D/16 of the m16n8
// accumulator), so the adjoint needs no shared memory. Under GQA it is applied once, to the
// group's float32 sum (the rotation is linear: the reference's
// repeat-then-sum up to rounding). The tables get no gradient.
#include <math.h>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace pt {
namespace bwd {

constexpr int kT = 256;    // threads per block
constexpr int kSub = 16;   // thread grid is 16 x 16; patches are strided by 16

template <int D>
struct Shape {
  // query rows and keys per tile: 64 (4 x 4 patches), 32 at D = 256
  static constexpr int TILE = D > 128 ? 32 : 64;
  static constexpr int R = TILE / kSub;  // rows (and key columns) of a patch
  static constexpr int DP = D + 1;       // padded D row
  static constexpr int TP = TILE + 1;    // padded P / dS row
  static constexpr int NC = D / kSub;    // accumulator columns per thread
  // floats: A, B (the resident pair) and C, E (the streamed pair), each
  // [TILE][DP]; P and dS [TILE][TP]; lse and delta [TILE]
  static constexpr int FLOATS = 4 * TILE * DP + 2 * TILE * TP + 2 * TILE;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// Rows r0 .. r0+TILE of head h of batch b (element strides st), hd
// columns each, into dst [TILE][DP] as floats in the halves layout
// (tc::half_col); rows at or past S and the zero columns become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, RowStrides st, int b,
                                          int r0, int S, int h, int hd) {
  using Sh = Shape<D>;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(VEC == 4, "a half of hd / 2 (a multiple of 4) columns is "
                          "whole 16-byte chunks of float32");
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < Sh::TILE * D / VEC; e += kT) {
    const int i = e / (D / VEC);
    const int d = (e % (D / VEC)) * VEC;
    const int col = tc::half_col(d, D, hd);
    const int r = r0 + i;
    float buf[VEC];
    if (r < S && col >= 0) {
      load16(src + st.at(b, r, h) + col, buf);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) buf[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < VEC; ++x) dst[i * DP + d + x] = buf[x];
  }
}

// The adjoint rotation of a thread's [R][D/16] patch of a float32
// accumulator (rows pos0 + ty + 16a, padded columns tx + 16c, the halves
// layout of head dim hd; tables [S, hd]): padded columns j and j + D/2 —
// the row's d and d + hd/2 — are patch columns c and c + D/32. Rows at or
// past S, and the zero columns, are left alone.
template <int D>
__device__ __forceinline__ void rope_adjoint_patch(
    float (&acc)[Shape<D>::R][D / kSub], const float* sin, const float* cos,
    int pos0, int S, int hd) {
  constexpr int NC = D / kSub;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;
#pragma unroll
  for (int a = 0; a < Shape<D>::R; ++a) {
    const int pos = pos0 + ty + kSub * a;
    if (pos >= S) continue;
    const long long row = static_cast<long long>(pos) * hd;
#pragma unroll
    for (int c = 0; c < NC / 2; ++c) {
      const int d = tx + kSub * c;
      if (d >= hd / 2) continue;
      rope_adjoint_pair(acc[a][c], acc[a][c + NC / 2], cos[row + d],
                        sin[row + d], cos[row + d + hd / 2],
                        sin[row + d + hd / 2], acc[a][c], acc[a][c + NC / 2]);
    }
  }
}

// lse / delta of rows q0 .. q0+TILE of (b, h) into shared memory; zero
// past S.
template <int TILE>
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* s_lse, float* s_delta,
                                               long long bh, int q0, int S) {
  if (threadIdx.x < TILE) {
    const int r = q0 + threadIdx.x;
    const bool in = r < S;
    s_lse[threadIdx.x] = in ? lse[bh * S + r] : 0.f;
    s_delta[threadIdx.x] = in ? delta[bh * S + r] : 0.f;
  }
}

// P and dS of the tile pair (query rows q0.., keys k0..), each rounded to
// T, into sP / sdS [TILE][TP] (row = query, column = key). Thread
// (ty, tx) computes rows ty + 16a and keys tx + 16c. sP is skipped when
// kWantP is false.
template <typename T, int D, bool kWantP>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* s_lse,
                                       const float* s_delta, float* sP,
                                       float* sdS, int q0, int k0, int S,
                                       int causal, float scale) {
  constexpr int kR = Shape<D>::R;
  constexpr int DP = D + 1;
  constexpr int TP = Shape<D>::TP;
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;
  float s[kR][kR], dp[kR][kR];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[kR], oa[kR], kc[kR], vc[kR];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      qa[a] = sQ[(ty + kSub * a) * DP + d];
      oa[a] = sdO[(ty + kSub * a) * DP + d];
      kc[a] = sK[(tx + kSub * a) * DP + d];
      vc[a] = sV[(tx + kSub * a) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = ty + kSub * a;
    const int row = q0 + i;
    const float lse_i = s_lse[i];
    const float delta_i = s_delta[i];
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const int j = tx + kSub * c;
      const int col = k0 + j;
      const bool valid = row < S && col < S && (!causal || col <= row);
      const float p = valid ? expf(s[a][c] * scale - lse_i) : 0.f;
      const float ds = p * (dp[a][c] - delta_i) * scale;
      if (kWantP) sP[i * TP + j] = to_f(from_f<T>(p));
      sdS[i * TP + j] = to_f(from_f<T>(ds));
    }
  }
}

template <typename T, int D, bool kRope>
__global__ void __launch_bounds__(kT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const float* __restrict__ sin,
                     const float* __restrict__ cos, RowStrides qs,
                     RowStrides ks, int S, int H, int Hk, int hd, int causal,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  using Sh = Shape<D>;
  constexpr int DP = Sh::DP, TP = Sh::TP, NC = Sh::NC;
  constexpr int kTile = Sh::TILE, kR = Sh::R;
  float* sK = smem;
  float* sV = sK + kTile * DP;
  float* sQ = sV + kTile * DP;
  float* sdO = sQ + kTile * DP;
  float* sP = sdO + kTile * DP;
  float* sdS = sP + kTile * TP;
  float* s_lse = sdS + kTile * TP;
  float* s_delta = s_lse + kTile;

  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int G = H / Hk;
  load_rows<T, D>(k, sK, ks, b, k0, S, kvh, hd);
  load_rows<T, D>(v, sV, ks, b, k0, S, kvh, hd);

  // this thread's patch of dK/dV: keys ty + 16a, columns tx + 16c
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;
  float acc_k[kR][NC], acc_v[kR][NC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[a][c] = 0.f;
      acc_v[a][c] = 0.f;
    }

  // causal: query tiles before the key tile see none of its keys
  const int q_first = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int q0 = q_first; q0 < S; q0 += kTile) {
      __syncthreads();  // the previous tile's reads are done
      load_rows<T, D>(q, sQ, qs, b, q0, S, h, hd);
      load_rows<T, D>(dout, sdO, qs, b, q0, S, h, hd);
      load_row_stats<kTile>(lse, delta, s_lse, s_delta, bh, q0, S);
      __syncthreads();
      scores<T, D, true>(sQ, sdO, sK, sV, s_lse, s_delta, sP, sdS, q0, k0,
                         S, causal, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pa[kR], dsa[kR];
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          pa[a] = sP[i * TP + ty + kSub * a];
          dsa[a] = sdS[i * TP + ty + kSub * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = sdO[i * DP + tx + kSub * c];
          const float qq = sQ[i * DP + tx + kSub * c];
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            acc_v[a][c] = fmaf(pa[a], o, acc_v[a][c]);
            acc_k[a][c] = fmaf(dsa[a], qq, acc_k[a][c]);
          }
        }
      }
    }
  }
  // gradient w.r.t. the un-rotated K: the adjoint of the group's sum
  if constexpr (kRope) rope_adjoint_patch<D>(acc_k, sin, cos, k0, S, hd);
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = k0 + ty + kSub * a;
    if (r >= S) continue;
    const long long off = ks.at(b, r, kvh);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc::half_col(tx + kSub * c, D, hd);
      if (col < 0) continue;
      dk[off + col] = from_f<T>(acc_k[a][c]);
      dv[off + col] = from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int D, bool kRope>
__global__ void __launch_bounds__(kT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const float* __restrict__ sin,
                    const float* __restrict__ cos, RowStrides qs,
                    RowStrides ks, int S, int H, int Hk, int hd, int causal,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  using Sh = Shape<D>;
  constexpr int DP = Sh::DP, TP = Sh::TP, NC = Sh::NC;
  constexpr int kTile = Sh::TILE, kR = Sh::R;
  float* sQ = smem;
  float* sdO = sQ + kTile * DP;
  float* sK = sdO + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;  // unused by this kernel
  float* sdS = sP + kTile * TP;
  float* s_lse = sdS + kTile * TP;
  float* s_delta = s_lse + kTile;

  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / Hk);
  load_rows<T, D>(q, sQ, qs, b, q0, S, h, hd);
  load_rows<T, D>(dout, sdO, qs, b, q0, S, h, hd);
  load_row_stats<kTile>(lse, delta, s_lse, s_delta, blockIdx.y, q0, S);

  // this thread's patch of dQ: rows ty + 16a, columns tx + 16c
  const int ty = threadIdx.x / kSub;
  const int tx = threadIdx.x % kSub;
  float acc[kR][NC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  // causal: key tiles past the query tile's last row are never visited
  const int kv_stop = causal ? min(q0 + kTile, S) : S;
  for (int k0 = 0; k0 < kv_stop; k0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, D>(k, sK, ks, b, k0, S, kvh, hd);
    load_rows<T, D>(v, sV, ks, b, k0, S, kvh, hd);
    __syncthreads();
    scores<T, D, false>(sQ, sdO, sK, sV, s_lse, s_delta, sP, sdS, q0, k0, S,
                        causal, scale);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float dsa[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) dsa[a] = sdS[(ty + kSub * a) * TP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = sK[j * DP + tx + kSub * c];
#pragma unroll
        for (int a = 0; a < kR; ++a) acc[a][c] = fmaf(dsa[a], kk, acc[a][c]);
      }
    }
  }
  // gradient w.r.t. the un-rotated Q
  if constexpr (kRope) rope_adjoint_patch<D>(acc, sin, cos, q0, S, hd);
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = q0 + ty + kSub * a;
    if (r >= S) continue;
    const long long off = qs.at(b, r, h);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc::half_col(tx + kSub * c, D, hd);
      if (col >= 0) dq[off + col] = from_f<T>(acc[a][c]);
    }
  }
}

inline float scale_of(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

template <typename T, int D, bool kRope>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       const float* sin, const float* cos, RowStrides qs,
                       RowStrides ks, int B, int S, int H, int Hk, int hd,
                       int causal, cudaStream_t stream) {
  using Sh = Shape<D>;
  auto kernel = flash_bwd_dkv_kernel<T, D, kRope>;
  cudaError_t err = allow_smem(kernel, Sh::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + Sh::TILE - 1) / Sh::TILE, B * Hk);
  kernel<<<grid, kT, Sh::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sin, cos, qs, ks, S, H, Hk,
      hd, causal, scale_of(hd));
  return cudaGetLastError();
}

template <typename T, int D, bool kRope>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const float* sin, const float* cos,
                      RowStrides qs, RowStrides ks, int B, int S, int H,
                      int Hk, int hd, int causal, cudaStream_t stream) {
  using Sh = Shape<D>;
  auto kernel = flash_bwd_dq_kernel<T, D, kRope>;
  cudaError_t err = allow_smem(kernel, Sh::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + Sh::TILE - 1) / Sh::TILE, B * H);
  kernel<<<grid, kT, Sh::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sin, cos, qs, ks, S, H, Hk, hd, causal,
      scale_of(hd));
  return cudaGetLastError();
}

}  // namespace bwd

// ------------------------------------- dK/dV and dQ in bf16, tensor cores
namespace tcb {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;    // keys a tile (dkv: resident, 4 warps x 16)
constexpr int kBQ = 64;    // query rows a tile (dq: resident, 4 warps x 16)
constexpr int kNT = 128;   // threads a block

// shared bytes: K and V, two stages of Q and of dO, two of lse and delta
template <int D>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(2 * kBK + 4 * kBQ) * D * sizeof(bf16) +
         4 * kBQ * sizeof(float);
}
// dK and dV in blocks of their own (grid z: 0 dV, 1 dK) at D = 256
template <int D>
__host__ __device__ constexpr bool split_dkv() {
  return D > 128;
}

// kPad: hd < D (the halves layout); without it hd is D and the tile code
// is the unpadded one, with no run-time column arithmetic in its loops
template <int D, bool kRope, bool kPad>
__global__ void __launch_bounds__(kNT, 2)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const float* __restrict__ sin,
                          const float* __restrict__ cos, RowStrides qs,
                          RowStrides ks, int S, int H, int Hk, int hd,
                          int causal, float scale) {
  if constexpr (!kPad) hd = D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBK * D;
  bf16* sQ = sV + kBK * D;           // two stages
  bf16* sdO = sQ + 2 * kBQ * D;      // two stages
  float* s_lse = reinterpret_cast<float*>(sdO + 2 * kBQ * D);
  float* s_delta = s_lse + 2 * kBQ;
  constexpr int KS = D / 16;    // k-steps of K Q^T and V dO^T
  constexpr int ND = D / 8;     // 8-column tiles of dK, dV
  constexpr int kQC = 32;       // query columns a pass
  constexpr int NS = kQC / 8;   // 8-column tiles of S^T, dP^T in a pass
  constexpr bool kSplit = split_dkv<D>();
  // a split block computes dK (want_k) or dV; a joint block both
  const bool want_k = !kSplit || blockIdx.z == 1;
  const bool want_v = !kSplit || blockIdx.z == 0;

  const int k0 = blockIdx.y * kBK;
  const int b = blockIdx.x / Hk;
  const int kvh = blockIdx.x % Hk;
  const int G = H / Hk;
  const long long q_row = qs.s;     // element strides of a sequence step
  const long long kv_row = ks.s;
  const long long kv_off = ks.at(b, k0, kvh);
  // causal: query tiles before the key tile see none of its keys
  const int qt0 = causal ? k0 / kBQ : 0;
  const int per = (S + kBQ - 1) / kBQ - qt0;   // query tiles a head
  const int n_it = G * per;

  // the it-th (query head, query tile) of the walk into stage st
  auto issue = [&](int it, int st) {
    const int h = kvh * G + it / per;
    const int q0 = (qt0 + it % per) * kBQ;
    const long long off = qs.at(b, q0, h);
    tc::load_tile_halves<kBQ, D, kNT>(sQ + st * kBQ * D, q + off, q_row,
                                      S - q0, hd);
    tc::load_tile_halves<kBQ, D, kNT>(sdO + st * kBQ * D, dout + off, q_row,
                                      S - q0, hd);
    const int i = threadIdx.x % kBQ;
    const bool ok = q0 + i < S;
    const long long row = (static_cast<long long>(b) * H + h) * S + q0 +
                          (ok ? i : 0);
    const bool is_lse = threadIdx.x < kBQ;
    tc::cp_async4((is_lse ? s_lse : s_delta) + st * kBQ + i,
                  (is_lse ? lse : delta) + row, ok);
  };

  tc::load_tile_halves<kBK, D, kNT>(sK, k + kv_off, kv_row, S - k0, hd);
  tc::load_tile_halves<kBK, D, kNT>(sV, v + kv_off, kv_row, S - k0, hd);
  issue(0, 0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int kr0 = warp * 16;               // this warp's keys in the tile
  const int key[2] = {k0 + kr0 + (lane >> 2), k0 + kr0 + (lane >> 2) + 8};
  // acc_k: dK, or a split block's one output; acc_v: a joint block's dV
  float acc_k[ND][4], acc_v[kSplit ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < (kSplit ? 1 : ND); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_v[n][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {   // the next tile's copy overlaps this tile's math
      issue(it + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % per) * kBQ;
    const bf16* cQ = sQ + st * kBQ * D;
    const bf16* cdO = sdO + st * kBQ * D;
    const float* c_lse = s_lse + st * kBQ;
    const float* c_delta = s_delta + st * kBQ;

    // Two passes over 32 query columns each, so that P^T and dP^T (fp32)
    // take 32 registers a thread, not 64, beside the accumulators.
    const bool edge = (causal && q0 < k0 + kr0 + 15) || q0 + kBQ > S;
#pragma unroll
    for (int c0 = 0; c0 < kBQ; c0 += kQC) {
      // ---- S^T = K Q^T and dP^T = V dO^T (a dV block: S^T alone): rows
      // = this warp's 16 keys, columns = queries c0 .. c0+31 of the tile
      float p[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[n][i] = 0.f;
          dp[n][i] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        tc::load_a<kBK>(a, sK, kr0, ks);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          tc::load_b<kBQ>(bb, cQ, c0 + np * 16, ks);
          tc::mma(p[2 * np], a, bb[0], bb[1]);
          tc::mma(p[2 * np + 1], a, bb[2], bb[3]);
        }
        if (want_k) {
          tc::load_a<kBK>(a, sV, kr0, ks);
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bb[4];
            tc::load_b<kBQ>(bb, cdO, c0 + np * 16, ks);
            tc::mma(dp[2 * np], a, bb[0], bb[1]);
            tc::mma(dp[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }
      // ---- P^T = exp(S^T * scale - lse), masked and tail entries exactly
      // 0; dS^T = P^T (dP^T - delta) * scale
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = c0 + n * 8 + 2 * t + (i & 1);
          float x = tc::exp2_fast((p[n][i] * scale - c_lse[qc]) * tc::kLog2e);
          if (edge) {
            const int qr = q0 + qc;
            const bool ok = qr < S && (!causal || key[i >> 1] <= qr);
            x = ok ? x : 0.f;
          }
          p[n][i] = x;
          dp[n][i] = x * (dp[n][i] - c_delta[qc]) * scale;
        }
      // ---- dV += P^T dO, dK += dS^T Q over these 32 queries; P^T and dS^T
      // rounded to bf16 in registers as the A operands
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4], da[4];
        tc::to_a_frag(pa, p[2 * kk], p[2 * kk + 1]);
        tc::to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
        const int ks = c0 / 16 + kk;
        if constexpr (kSplit) {
          // one product: dK += dS^T Q, or dV += P^T dO
          const bf16* cB = want_k ? cQ : cdO;
          uint32_t aa[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) aa[x] = want_k ? da[x] : pa[x];
#pragma unroll
          for (int dc = 0; dc < D / 16; ++dc) {
            uint32_t bb[4];
            tc::load_b_t<kBQ>(bb, cB, ks, 2 * dc);
            tc::mma(acc_k[2 * dc], aa, bb[0], bb[1]);
            tc::mma(acc_k[2 * dc + 1], aa, bb[2], bb[3]);
          }
        } else {
#pragma unroll
          for (int dc = 0; dc < D / 16; ++dc) {
            uint32_t bb[4];
            tc::load_b_t<kBQ>(bb, cdO, ks, 2 * dc);
            tc::mma(acc_v[2 * dc], pa, bb[0], bb[1]);
            tc::mma(acc_v[2 * dc + 1], pa, bb[2], bb[3]);
            tc::load_b_t<kBQ>(bb, cQ, ks, 2 * dc);
            tc::mma(acc_k[2 * dc], da, bb[0], bb[1]);
            tc::mma(acc_k[2 * dc + 1], da, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();   // this stage is read; the next copy may overwrite it
  }

  // gradient w.r.t. the un-rotated K: the adjoint of the group's sum
  if constexpr (kRope)
    if (want_k) tc::rope_adjoint_acc<D>(acc_k, sin, cos, key, S, hd);
  bf16* out_a = want_k ? dk : dv;          // acc_k's output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const long long off = ks.at(b, key[r], kvh);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = tc::half_col(n * 8 + 2 * t, D, hd);
      if (col < 0) continue;
      *reinterpret_cast<uint32_t*>(out_a + off + col) =
          tc::pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      if constexpr (!kSplit)
        *reinterpret_cast<uint32_t*>(dv + off + col) =
            tc::pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int D, bool kRope>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       const float* sin, const float* cos, RowStrides qs,
                       RowStrides ks, int B, int S, int H, int Hk, int hd,
                       int causal, cudaStream_t stream) {
  auto kernel = hd == D ? flash_bwd_dkv_bf16_kernel<D, kRope, false>
                        : flash_bwd_dkv_bf16_kernel<D, kRope, true>;
  cudaError_t err = tc::use_smem(kernel, dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hk, (S + kBK - 1) / kBK, split_dkv<D>() ? 2 : 1);
  kernel<<<grid, kNT, dkv_smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sin, cos, qs,
      ks, S, H, Hk, hd, causal, bwd::scale_of(hd));
  return cudaGetLastError();
}

// shared bytes: Q and dO (resident), two stages of K and of V
template <int D>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(2 * kBQ + 4 * kBK) * D * sizeof(bf16);
}

template <int D, bool kRope, bool kPad>
__global__ void __launch_bounds__(kNT, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, const float* __restrict__ sin,
                         const float* __restrict__ cos, RowStrides qs,
                         RowStrides ks, int S, int H, int Hk, int hd,
                         int causal, float scale) {
  if constexpr (!kPad) hd = D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kBQ * D;
  bf16* sK = sdO + kBQ * D;          // two stages
  bf16* sV = sK + 2 * kBK * D;       // two stages
  constexpr int KS = D / 16;    // k-steps of Q K^T and dO V^T
  constexpr int ND = D / 8;     // 8-column tiles of dQ
  // keys a pass over a tile: all 64, or 32 at D = 256 (S and dP fp32 at
  // 32 registers a thread beside the 128 dQ accumulators)
  constexpr int kKP = D > 128 ? 32 : kBK;
  constexpr int NS = kKP / 8;   // 8-column tiles of S, dP in a pass

  // last query tiles first: their causal walks are the longest
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const long long q_row = qs.s;     // element strides of a sequence step
  const long long kv_row = ks.s;
  const long long q_off = qs.at(b, q0, h);
  // causal: key tiles past the query tile's last row are never visited
  const int kv_stop = causal ? min(q0 + kBQ, S) : S;
  const int n_it = (kv_stop + kBK - 1) / kBK;

  auto issue = [&](int it, int st) {
    const int k0 = it * kBK;
    const long long off = ks.at(b, k0, kvh);
    tc::load_tile_halves<kBK, D, kNT>(sK + st * kBK * D, k + off, kv_row,
                                      S - k0, hd);
    tc::load_tile_halves<kBK, D, kNT>(sV + st * kBK * D, v + off, kv_row,
                                      S - k0, hd);
  };

  tc::load_tile_halves<kBQ, D, kNT>(sQ, q + q_off, q_row, S - q0, hd);
  tc::load_tile_halves<kBQ, D, kNT>(sdO, dout + q_off, q_row, S - q0, hd);
  issue(0, 0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int qr0 = warp * 16;               // this warp's rows in the tile
  const int row[2] = {q0 + qr0 + (lane >> 2), q0 + qr0 + (lane >> 2) + 8};
  float r_lse[2], r_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < S;
    const long long i = static_cast<long long>(bh) * S + row[r];
    r_lse[r] = ok ? lse[i] : 0.f;
    r_delta[r] = ok ? delta[i] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {   // the next tile's copy overlaps this tile's math
      issue(it + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * kBK;
    const bf16* cK = sK + st * kBK * D;
    const bf16* cV = sV + st * kBK * D;
    const bool edge = (causal && k0 + kBK - 1 > q0 + qr0) || k0 + kBK > S;

#pragma unroll
    for (int c0 = 0; c0 < kBK; c0 += kKP) {
      // ---- S = Q K^T and dP = dO V^T: rows = this warp's 16 queries,
      // columns = keys c0 .. c0 + kKP - 1 of the tile
      float p[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[n][i] = 0.f;
          dp[n][i] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        tc::load_a<kBQ>(a, sQ, qr0, ks);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          tc::load_b<kBK>(bb, cK, c0 + np * 16, ks);
          tc::mma(p[2 * np], a, bb[0], bb[1]);
          tc::mma(p[2 * np + 1], a, bb[2], bb[3]);
        }
        tc::load_a<kBQ>(a, sdO, qr0, ks);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          tc::load_b<kBK>(bb, cV, c0 + np * 16, ks);
          tc::mma(dp[2 * np], a, bb[0], bb[1]);
          tc::mma(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // ---- P = exp(S * scale - lse), masked and tail entries exactly 0;
      // dS = P (dP - delta) * scale
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          float x = tc::exp2_fast((p[n][i] * scale - r_lse[r]) * tc::kLog2e);
          if (edge) {
            const int key = k0 + c0 + n * 8 + 2 * t + (i & 1);
            const bool ok = key < S && (!causal || key <= row[r]);
            x = ok ? x : 0.f;
          }
          dp[n][i] = x * (dp[n][i] - r_delta[r]) * scale;
        }
      // ---- dQ += dS K over these keys; dS rounded to bf16 in registers
      // as the A operand, K through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t da[4];
        tc::to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dc = 0; dc < D / 16; ++dc) {
          uint32_t bb[4];
          tc::load_b_t<kBK>(bb, cK, c0 / 16 + kk, 2 * dc);
          tc::mma(acc[2 * dc], da, bb[0], bb[1]);
          tc::mma(acc[2 * dc + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // this stage is read; the next copy may overwrite it
  }

  // gradient w.r.t. the un-rotated Q
  if constexpr (kRope) tc::rope_adjoint_acc<D>(acc, sin, cos, row, S, hd);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const long long off = qs.at(b, row[r], h);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = tc::half_col(n * 8 + 2 * t, D, hd);
      if (col >= 0)
        *reinterpret_cast<uint32_t*>(dq + off + col) =
            tc::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <int D, bool kRope>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const float* sin, const float* cos,
                      RowStrides qs, RowStrides ks, int B, int S, int H,
                      int Hk, int hd, int causal, cudaStream_t stream) {
  auto kernel = hd == D ? flash_bwd_dq_bf16_kernel<D, kRope, false>
                        : flash_bwd_dq_bf16_kernel<D, kRope, true>;
  cudaError_t err = tc::use_smem(kernel, dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kNT, dq_smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), sin, cos, qs, ks, S, H, Hk, hd, causal,
      bwd::scale_of(hd));
  return cudaGetLastError();
}

}  // namespace tcb

// The two kernels at padded width D of head dim hd and the rope mode: bf16
// on mma.sync, float32 on the CUDA cores.
template <int D, bool kRope>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       const float* sin, const float* cos, RowStrides qs,
                       RowStrides ks, int B, int S, int H, int Hk, int hd,
                       int causal, int is_bf16, cudaStream_t stream) {
  return is_bf16
      ? tcb::launch_dkv<D, kRope>(q, k, v, dout, lse, delta, dk, dv, sin,
                                  cos, qs, ks, B, S, H, Hk, hd, causal,
                                  stream)
      : bwd::launch_dkv<float, D, kRope>(q, k, v, dout, lse, delta, dk, dv,
                                         sin, cos, qs, ks, B, S, H, Hk, hd,
                                         causal, stream);
}

template <int D, bool kRope>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const float* sin, const float* cos,
                      RowStrides qs, RowStrides ks, int B, int S, int H,
                      int Hk, int hd, int causal, int is_bf16,
                      cudaStream_t stream) {
  return is_bf16
      ? tcb::launch_dq<D, kRope>(q, k, v, dout, lse, delta, dq, sin, cos, qs,
                                 ks, B, S, H, Hk, hd, causal, stream)
      : bwd::launch_dq<float, D, kRope>(q, k, v, dout, lse, delta, dq, sin,
                                        cos, qs, ks, B, S, H, Hk, hd, causal,
                                        stream);
}

}  // namespace pt

// The source builds as two libraries (kernels/_build.py): with
// -DFLASH_BWD_ENTRY=1 the dK/dV entry, with 2 the dQ entry, so each
// compiles only its own kernels' instantiations and the two build in
// parallel. Without the macro both entries are compiled.
#ifndef FLASH_BWD_ENTRY
#define FLASH_BWD_ENTRY 0
#endif

#if FLASH_BWD_ENTRY != 2
// q/dout [B,S,H,D] through strides (q_sb, q_ss, q_sh), k/v/dk/dv
// [B,S,Hk,D] through (k_sb, k_ss, k_sh), D contiguous, D % 8 == 0 and
// 8 <= D <= 256; lse/delta [B,H,S] float32; sin/cos [S,D] float32 (fused
// RoPE: q and k already rotated by pt_rope_qk, dK gets the adjoint) or
// both null. is_bf16: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores).
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* sin, const void* cos, int B,
                                int S, int H, int Hk, int D, long long q_sb,
                                long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss,
                                long long k_sh, int causal, int is_bf16,
                                void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hk <= 0 || H % Hk || (sin == nullptr) != (cos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* sn = static_cast<const float*>(sin);
  const float* cs = static_cast<const float*>(cos);
  const pt::RowStrides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  return static_cast<int>(pt::with_head_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sn != nullptr
        ? pt::launch_dkv<DP, true>(q, k, v, dout, l, dl, dk, dv, sn, cs, qs,
                                   ks, B, S, H, Hk, D, causal, is_bf16, s)
        : pt::launch_dkv<DP, false>(q, k, v, dout, l, dl, dk, dv, sn, cs, qs,
                                    ks, B, S, H, Hk, D, causal, is_bf16, s);
  }));
}

#endif

#if FLASH_BWD_ENTRY != 1
// q/dout/dq [B,S,H,D] through strides (q_sb, q_ss, q_sh), k/v [B,S,Hk,D]
// through (k_sb, k_ss, k_sh), D contiguous, D % 8 == 0 and 8 <= D <= 256;
// lse/delta [B,H,S] float32; sin/cos [S,D] float32 (fused RoPE: q and k
// already rotated by pt_rope_qk, dQ gets the adjoint) or both null.
// is_bf16: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, const void* sin,
                               const void* cos, int B, int S, int H, int Hk,
                               int D, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, int causal, int is_bf16,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hk <= 0 || H % Hk || (sin == nullptr) != (cos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* sn = static_cast<const float*>(sin);
  const float* cs = static_cast<const float*>(cos);
  const pt::RowStrides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  return static_cast<int>(pt::with_head_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sn != nullptr
        ? pt::launch_dq<DP, true>(q, k, v, dout, l, dl, dq, sn, cs, qs, ks, B,
                                  S, H, Hk, D, causal, is_bf16, s)
        : pt::launch_dq<DP, false>(q, k, v, dout, l, dl, dq, sn, cs, qs, ks,
                                   B, S, H, Hk, D, causal, is_bf16, s);
  }));
}
#endif
