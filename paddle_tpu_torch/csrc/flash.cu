// Flash attention forward for Hopper: causal (or full) attention over
// [B, S, H, D] tensors with a tiled online softmax, never materialising the
// S x S scores, emitting the log-sum-exp per query row.
//
// Replaces paddle_tpu/kernels/pallas_flash.py:_fwd_kernel (via _flash_fwd,
// entry flash_attention_pallas). Bound on this card: operations — the
// causal product does ~2*S*D flops per query row against 4*D bytes read,
// well above the H100's ~295 flops/byte at serving prompt lengths. Design:
// one block per (batch*head, 64-row query tile); the 64 query rows stay in
// shared memory while 32-key K/V tiles stream past them, so each K/V byte
// is read once per 64 queries. Causal tiles past the diagonal are never
// visited (the walk stops at the tile's last row), the tail past S is
// masked. GQA indexes the KV head as h / (H / Hk): K and V are not
// repeated in memory. The arithmetic runs on the CUDA cores in fp32;
// moving it onto the tensor cores (wgmma) is later work.
#include <math.h>

#include "attention_common.cuh"

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

}  // namespace pt

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* k,
                              const void* v, void* out, float* lse, int B,
                              int S, int H, int Hk, int causal,
                              cudaStream_t s) {
  switch (D) {
    case 64:
      return pt::launch<T, 64>(q, k, v, out, lse, B, S, H, Hk, causal, s);
    case 128:
      return pt::launch<T, 128>(q, k, v, out, lse, B, S, H, Hk, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q/out [B,S,H,D]; k/v [B,S,Hk,D]; lse [B,H,S] float32 or null.
// is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int S, int H, int Hk,
                            int D, int causal, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, out, l, B, S, H, Hk, causal, s)
              : dispatch_d<float>(D, q, k, v, out, l, B, S, H, Hk, causal, s);
  return static_cast<int>(err);
}
