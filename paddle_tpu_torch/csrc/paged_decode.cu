// Paged decode attention for Hopper: one query token per row attends that
// row's cache, read through its block table from the shared KV pool.
//
// Replaces paddle_tpu/kernels/pallas_paged_decode.py:_paged_kernel (entry
// paged_decode_attention_pallas). Bound on this card: bytes — every cached
// K/V row is read once for D*4 flops, far below the ~295 flops/byte at
// which the H100 stops being memory bound. Design: one block per
// (row, head); the block walks only the row's valid length (blocks past it
// are never read, sentinel table entries are clamped into the pool, never
// dereferenced out of range), 32 keys per tile with 16-byte vector loads.
// GQA indexes the KV head as h / (H / Hkv), so no K/V is repeated.
// Shares its tile routine with the ragged kernel, so a span-1 ragged row
// computes the same bits as a decode row.
#include <math.h>

#include "attention_common.cuh"

namespace pt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int Hkv, int nb, int bs, int mb, float scale) {
  extern __shared__ __align__(16) float smem[];
  using S = TileShape<T, D, 1>;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  long long* s_qoff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS) + kKeys;
  if (threadIdx.x == 0) s_qoff[0] = (static_cast<long long>(b) * H + h) * D;
  const int len = min(max(lengths[b], 0), mb * bs);
  const int* row_tbl = tables + static_cast<long long>(b) * mb;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return ((static_cast<long long>(phys) * bs + p % bs) * Hkv + kvh) * D;
  };
  auto row_pos = [&](int) { return len - 1; };
  __syncthreads();
  attend_tile<T, D, 1>(q, pool_k, pool_v, out, smem, s_qoff, row_pos, len, len,
                       key_off, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int Hkv, int nb, int bs, int mb, cudaStream_t stream) {
  using S = TileShape<T, D, 1>;
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kernel<<<grid, kThreads, S::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), tables, lengths, static_cast<T*>(out), H, Hkv,
      nb, bs, mb, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace pt

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* pk,
                              const void* pv, const int* tables,
                              const int* lengths, void* out, int B, int H,
                              int Hkv, int nb, int bs, int mb,
                              cudaStream_t stream) {
  switch (D) {
    case 64:
      return pt::launch<T, 64>(q, pk, pv, tables, lengths, out, B, H, Hkv, nb, bs, mb, stream);
    case 128:
      return pt::launch<T, 128>(q, pk, pv, tables, lengths, out, B, H, Hkv, nb, bs, mb, stream);
    case 256:
      return pt::launch<T, 256>(q, pk, pv, tables, lengths, out, B, H, Hkv, nb, bs, mb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// q [B,H,D]; pool_k/pool_v [nb,bs,Hkv,D]; tables [B,mb] int32;
// lengths [B] int32; out [B,H,D]. is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* tables,
                               const void* lengths, void* out, int B, int H,
                               int Hkv, int D, int nb, int bs, int mb,
                               int is_bf16, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, pool_k, pool_v, tbl, len, out, B, H, Hkv, nb, bs, mb, s)
              : dispatch_d<float>(D, q, pool_k, pool_v, tbl, len, out, B, H, Hkv, nb, bs, mb, s);
  return static_cast<int>(err);
}
