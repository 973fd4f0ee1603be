// Dense-cache decode attention for Hopper: one query token per row attends
// that row's own slot of a dense per-slot cache [B, S_max, Hkv, D], over its
// first lengths[b] positions.
//
// Replaces paddle_tpu/kernels/pallas_decode.py:_decode_kernel (via
// _decode_call, entry decode_attention_pallas). Bound on this card: bytes —
// each valid cached K/V row is read once for D*4 flops per head, far below
// the ~295 flops/byte at which the H100 stops being memory bound. Design:
// one block per (row, head) walking only the row's valid keys (nothing past
// lengths[b] is read), 32 keys per tile with 16-byte vector loads. GQA
// indexes the KV head as h / (H / Hkv); the Pallas kernel's block-diagonal
// wide query is a TPU matrix-unit device and has no place here. The dense
// cache is the paged walk with key offsets (b*S_max + p) rows, so this
// kernel shares attention_common.cuh's tile routine (and its numerics: masked
// scores at -1e30, P and V zeroed past the length, out = acc / max(l, 1e-30)
// rounded to the input type) with the ragged kernel.
#include <math.h>

#include "attention_common.cuh"

namespace pt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int Hkv, int s_max, float scale) {
  extern __shared__ __align__(16) float smem[];
  using S = TileShape<T, D, 1>;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  long long* s_qoff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS) + kKeys;
  if (threadIdx.x == 0) s_qoff[0] = (static_cast<long long>(b) * H + h) * D;
  const int len = min(max(lengths[b], 0), s_max);
  const long long row0 = static_cast<long long>(b) * s_max;
  auto key_off = [&](int p) -> long long {
    return ((row0 + p) * Hkv + kvh) * D;
  };
  auto row_pos = [&](int) { return len - 1; };
  __syncthreads();
  attend_tile<T, D, 1>(q, k_cache, v_cache, out, smem, s_qoff, row_pos, len,
                       len, key_off, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, int B, int H, int Hkv,
                   int s_max, cudaStream_t stream) {
  using S = TileShape<T, D, 1>;
  auto kernel = dense_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kernel<<<grid, kThreads, S::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), H, Hkv, s_max,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace pt

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* kc,
                              const void* vc, const int* lengths, void* out,
                              int B, int H, int Hkv, int s_max,
                              cudaStream_t stream) {
  switch (D) {
    case 64:
      return pt::launch<T, 64>(q, kc, vc, lengths, out, B, H, Hkv, s_max, stream);
    case 128:
      return pt::launch<T, 128>(q, kc, vc, lengths, out, B, H, Hkv, s_max, stream);
    case 256:
      return pt::launch<T, 256>(q, kc, vc, lengths, out, B, H, Hkv, s_max, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// q [B,H,D]; k_cache/v_cache [B,S_max,Hkv,D]; lengths [B] int32;
// out [B,H,D]. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_decode(const void* q, const void* k_cache,
                         const void* v_cache, const void* lengths, void* out,
                         int B, int H, int Hkv, int D, int s_max, int is_bf16,
                         void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, len, out, B, H, Hkv, s_max, s)
              : dispatch_d<float>(D, q, k_cache, v_cache, len, out, B, H, Hkv, s_max, s);
  return static_cast<int>(err);
}
