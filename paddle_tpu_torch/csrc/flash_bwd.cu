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
// bf16 tensor cores stop waiting on memory. Design, on the CUDA cores in
// fp32 (tensor cores and TMA are later work):
//
// - Blocks run in no order, so each block owns its outputs and walks the
//   other dimension in a loop, where the Pallas grid walked a sequential
//   axis. dkv: one block per (batch, KV head, 64-key tile); K and V stay
//   in shared memory while 64-row Q/dO tiles stream past, from the
//   diagonal tile to S (causal pruning, as :201). GQA: the block loops
//   over the KV head's group of query heads itself, so dK/dV are summed
//   over the group in registers, without atomics, and every run gives the
//   same bits. dq: one block per (batch*head, 64-row query tile); Q and dO
//   stay resident while K/V tiles stream past up to the diagonal.
// - Register tiling: 256 threads; each computes a 4x4 patch of the 64x64
//   S and dP tiles (16 shared loads feed 32 FMAs) and a 4 x D/16 patch of
//   its [64, D] accumulators. Shared rows are padded by one float so the
//   strided reads of a warp fall in distinct banks.
// - Rows past S (the tail) load as zeros and carry lse = delta = 0 and
//   P = dS = 0, so they add nothing (as _row_valid, :38, and :214-235);
//   output rows past S are not written.
#include <math.h>

#include "attention_common.cuh"

namespace pt {
namespace bwd {

constexpr int kT = 256;    // threads per block
constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kSub = 16;   // thread grid is 16 x 16; patches are strided by 16
constexpr int kR = kTile / kSub;  // rows (and key columns) of a 4x4 patch

template <int D>
struct Shape {
  static constexpr int DP = D + 1;       // padded D row
  static constexpr int TP = kTile + 1;   // padded P / dS row
  static constexpr int NC = D / kSub;    // accumulator columns per thread
  // floats: A, B (the resident pair) and C, E (the streamed pair), each
  // [kTile][DP]; P and dS [kTile][TP]; lse and delta [kTile]
  static constexpr int FLOATS = 4 * kTile * DP + 2 * kTile * TP + 2 * kTile;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// Rows r0 .. r0+kTile of head h of a [B, S, Hx, D] tensor into dst
// [kTile][DP] as floats; rows at or past S become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int b, int r0, int S,
                                          int Hx, int h) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D / VEC; e += kT) {
    const int i = e / (D / VEC);
    const int d = (e % (D / VEC)) * VEC;
    const int r = r0 + i;
    float buf[VEC];
    if (r < S) {
      load16(src + ((static_cast<long long>(b) * S + r) * Hx + h) * D + d,
             buf);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) buf[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < VEC; ++x) dst[i * DP + d + x] = buf[x];
  }
}

// lse / delta of rows q0 .. q0+kTile of (b, h) into shared memory; zero
// past S.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* s_lse, float* s_delta,
                                               long long bh, int q0, int S) {
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    const bool in = r < S;
    s_lse[threadIdx.x] = in ? lse[bh * S + r] : 0.f;
    s_delta[threadIdx.x] = in ? delta[bh * S + r] : 0.f;
  }
}

// P and dS of the tile pair (query rows q0.., keys k0..), each rounded to
// T, into sP / sdS [kTile][TP] (row = query, column = key). Thread
// (ty, tx) computes rows ty + 16a and keys tx + 16c. sP is skipped when
// kWantP is false.
template <typename T, int D, bool kWantP>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* s_lse,
                                       const float* s_delta, float* sP,
                                       float* sdS, int q0, int k0, int S,
                                       int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int TP = kTile + 1;
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

template <typename T, int D>
__global__ void __launch_bounds__(kT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int Hk, int causal,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  using Sh = Shape<D>;
  constexpr int DP = Sh::DP, TP = Sh::TP, NC = Sh::NC;
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
  load_rows<T, D>(k, sK, b, k0, S, Hk, kvh);
  load_rows<T, D>(v, sV, b, k0, S, Hk, kvh);

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
      load_rows<T, D>(q, sQ, b, q0, S, H, h);
      load_rows<T, D>(dout, sdO, b, q0, S, H, h);
      load_row_stats(lse, delta, s_lse, s_delta, bh, q0, S);
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
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = k0 + ty + kSub * a;
    if (r >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + r) * Hk + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + kSub * c] = from_f<T>(acc_k[a][c]);
      dv[off + tx + kSub * c] = from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int Hk, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  using Sh = Shape<D>;
  constexpr int DP = Sh::DP, TP = Sh::TP, NC = Sh::NC;
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
  load_rows<T, D>(q, sQ, b, q0, S, H, h);
  load_rows<T, D>(dout, sdO, b, q0, S, H, h);
  load_row_stats(lse, delta, s_lse, s_delta, blockIdx.y, q0, S);

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
    load_rows<T, D>(k, sK, b, k0, S, Hk, kvh);
    load_rows<T, D>(v, sV, b, k0, S, Hk, kvh);
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
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = q0 + ty + kSub * a;
    if (r >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[off + tx + kSub * c] = from_f<T>(acc[a][c]);
  }
}

inline float scale_of(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int H, int Hk, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, Shape<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, B * Hk);
  kernel<<<grid, kT, Shape<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hk, causal,
      scale_of(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, int Hk, int causal,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, Shape<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kT, Shape<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hk, causal, scale_of(D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_d(int D, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int S, int H, int Hk, int causal,
                  cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                               Hk, causal, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                Hk, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dq_d(int D, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int S, int H, int Hk, int causal,
                 cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, S, H, Hk,
                              causal, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, S, H, Hk,
                               causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace pt

// q/dout [B,S,H,D]; k/v/dk/dv [B,S,Hk,D]; lse/delta [B,H,S] float32.
// is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int S, int H, int Hk, int D, int causal,
                                int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err =
      is_bf16 ? pt::bwd::dkv_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dk, dv,
                                              B, S, H, Hk, causal, s)
              : pt::bwd::dkv_d<float>(D, q, k, v, dout, l, dl, dk, dv, B, S,
                                      H, Hk, causal, s);
  return static_cast<int>(err);
}

// q/dout/dq [B,S,H,D]; k/v [B,S,Hk,D]; lse/delta [B,H,S] float32.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int S,
                               int H, int Hk, int D, int causal, int is_bf16,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err =
      is_bf16 ? pt::bwd::dq_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, B,
                                             S, H, Hk, causal, s)
              : pt::bwd::dq_d<float>(D, q, k, v, dout, l, dl, dq, B, S, H,
                                     Hk, causal, s);
  return static_cast<int>(err);
}
