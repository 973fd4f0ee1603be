// Flash attention forward for Hopper: causal (or full) attention over
// [B, S, H, D] tensors with a tiled online softmax, never materialising the
// S x S scores, emitting the log-sum-exp per query row.
//
// Replaces paddle_tpu/kernels/pallas_flash.py:_fwd_kernel (pallas_call at
// :159 in _flash_fwd, entry flash_attention_pallas). Bound on this card:
// operations — the causal product does ~2*S*D flops per query row against
// 4*D bytes read, well above the H100's ~295 flops/byte at serving prompt
// lengths (B=4, S=2048, 32 heads of 128: 137.5 GFLOP, 0.139 ms at the
// 989 TFLOP/s bf16 peak). Two kernels, chosen by the input type alone:
//
// bfloat16 — on the tensor cores (flash_fwd_wgmma_kernel). One block is
//   one warpgroup (four warps, 128 threads) per (batch*head, 64-row query
//   tile). Q [64, D] is copied once; 64-key K/V tiles stream through a
//   two-stage ring of bf16 shared tiles in the 128-byte swizzle layout,
//   filled by cp.async, so the next tile's copy overlaps this tile's
//   products. S = Q K^T is wgmma.m64n64k16 with Q and K read from shared
//   memory through descriptors; P V is wgmma.m64nDk16 with P taken from
//   registers: the S accumulators, after the online softmax (a row lives
//   in the four lanes of a quad) and rounded to bf16 as the reference
//   rounds P (pallas_flash.py:118-120), are the A fragments, with no
//   shared-memory round trip. The O accumulator stays in registers (64
//   floats a thread at D=128). Causal tiles past the diagonal are never
//   visited; only the diagonal tile and the tail tile past S are masked.
//   Query tiles are scheduled last row first, so the long causal rows
//   start in the first wave. 81 KB of shared memory at D=128 and 167
//   registers, two blocks an SM. The products of one tile are issued and
//   waited for before the softmax (no overlap across tiles yet, and no
//   TMA or warp specialisation: the next steps).
// float32 — on the CUDA cores (flash_fwd_kernel): the shared tile routine
//   of the attention kernels (attention_common.cuh), one block per (batch*head, 64-row query tile),
//   32-key K/V tiles, fp32 FMAs. The fp32 parity runs depend on it.
//
// Both: GQA indexes the KV head as h / (H / Hk) (K and V never repeated);
// scores are scaled in fp32 after the product (pallas_flash.py:95-96);
// LSE = m + log(max(l, 1e-30)).
#include <math.h>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace pt {

constexpr int kFlashTQ = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hk, int causal,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  using Sh = TileShape<T, D, kFlashTQ>;
  const int s0 = blockIdx.x * kFlashTQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const int rows = min(kFlashTQ, S - s0);
  long long* s_qoff = reinterpret_cast<long long*>(smem + Sh::SMEM_FLOATS) + kKeys;
  if (threadIdx.x < kFlashTQ) {
    const int i = threadIdx.x;
    s_qoff[i] = i < rows
        ? ((static_cast<long long>(b) * S + s0 + i) * H + h) * D : -1LL;
  }
  const int kv_stop = causal ? s0 + rows : S;
  auto key_off = [&](int p) -> long long {
    return ((static_cast<long long>(b) * S + p) * Hk + kvh) * D;
  };
  auto row_pos = [&](int i) { return causal ? s0 + i : S - 1; };
  __syncthreads();
  attend_tile<T, D, kFlashTQ>(q, k, v, out, smem, s_qoff, row_pos, kv_stop, S,
                              key_off, scale);
  if (lse != nullptr && threadIdx.x < rows) {
    // attend_tile leaves each row's running max and sum in shared memory
    const float* s_l = smem + kFlashTQ * D + kKeys * Sh::KP + kKeys * D +
                       kFlashTQ * kKeys + kFlashTQ;
    const float* s_m = s_l + kFlashTQ;
    const int i = threadIdx.x;
    lse[static_cast<long long>(bh) * S + s0 + i] =
        s_m[i] + logf(fmaxf(s_l[i], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int H, int Hk, int causal,
                   cudaStream_t stream) {
  using Sh = TileShape<T, D, kFlashTQ>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, Sh::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kFlashTQ - 1) / kFlashTQ, B * H);
  kernel<<<grid, kThreads, Sh::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hk, causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// ------------------------------------ bf16, on the tensor cores (wgmma)
namespace tcf {

using bf16 = __nv_bfloat16;
constexpr int kBM = 64;    // query rows a block: one warpgroup
constexpr int kBN = 64;    // keys a tile
constexpr int kNT = 128;

// the Q tile, two stages of K and of V, and 1 KB to align the atoms
template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBM + 4 * kBN) * D * sizeof(bf16) + 1024;
}

template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[8][4],
                                       const uint32_t (&a)[4], uint64_t db) {
  tc::wgmma_m64n64_rs(o, a, db);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[16][4],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  tc::wgmma_m64n128_rs(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kNT, 2)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int Hk,
                       int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* sK = sQ + kBM * D;
  bf16* sV = sK + 2 * kBN * D;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int NS = kBN / 8;

  const int nq = (S + kBM - 1) / kBM;
  const int s0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hk);
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(Hk) * D;
  const bf16* qb = q + (static_cast<long long>(b) * S + s0) * q_row + h * D;
  const bf16* kb = k + static_cast<long long>(b) * S * kv_row + kvh * D;
  const bf16* vb = v + static_cast<long long>(b) * S * kv_row + kvh * D;
  const int kv_end = causal ? min(s0 + kBM, S) : S;
  const int n_kt = (kv_end + kBN - 1) / kBN;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int w0 = s0 + warp * 16;
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};

  tc::load_tile<kBM, D, kNT>(sQ, qb, q_row, S - s0);
  tc::load_tile<kBN, D, kNT>(sK, kb, kv_row, S);
  tc::load_tile<kBN, D, kNT>(sV, vb, kv_row, S);
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
      const int k1 = k0 + kBN;
      tc::load_tile<kBN, D, kNT>(sK + (st ^ 1) * kBN * D,
                                       kb + k1 * kv_row, kv_row, S - k1);
      tc::load_tile<kBN, D, kNT>(sV + (st ^ 1) * kBN * D,
                                       vb + k1 * kv_row, kv_row, S - k1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    const bf16* cK = sK + st * kBN * D;
    const bf16* cV = sV + st * kBN * D;

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

    const bool edge = (causal && k0 + kBN - 1 > w0) || k0 + kBN > S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (i & 1);
          const bool ok = key < S && (!causal || key <= row[i >> 1]);
          x = ok ? x : kNegInf;
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tc::quad_max(mx[r]));
      alpha[r] = tc::exp2_fast((m[r] - mn) * tc::kLog2e);
      m[r] = mn;
      ml[r] = mn * tc::kLog2e;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[n][i];
        float p = tc::exp2_fast(fmaf(x, tc::kLog2e, -ml[i >> 1]));
        p = x == kNegInf ? 0.f : p;
        s[n][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
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
      pv<D>(o, pa[kk], tc::desc_mn_major<kBN>(cV, kk));
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::pin(o);
    tc::pin(pa);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(tc::quad_sum(l[r]), 1e-30f);
    if (row[r] >= S) continue;
    bf16* orow = out + static_cast<long long>(b * S + row[r]) * q_row + h * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          tc::pack_bf16(o[n][2 * r] / lr, o[n][2 * r + 1] / lr);
    }
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * S + row[r]] = m[r] + logf(lr);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int H, int Hk, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = tc::use_smem(kernel, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBM - 1) / kBM);
  kernel<<<grid, kNT, smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hk,
      causal, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace tcf
}  // namespace pt

// q/out [B,S,H,D]; k/v [B,S,Hk,D]; lse [B,H,S] float32 or null.
// is_bf16: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int S, int H, int Hk,
                            int D, int causal, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hk <= 0 || H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (D) {
    case 64:
      err = is_bf16
          ? pt::tcf::launch<64>(q, k, v, out, l, B, S, H, Hk, causal, s)
          : pt::launch<float, 64>(q, k, v, out, l, B, S, H, Hk, causal, s);
      break;
    case 128:
      err = is_bf16
          ? pt::tcf::launch<128>(q, k, v, out, l, B, S, H, Hk, causal, s)
          : pt::launch<float, 128>(q, k, v, out, l, B, S, H, Hk, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
