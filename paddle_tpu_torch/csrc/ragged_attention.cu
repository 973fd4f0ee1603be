// Ragged paged attention for Hopper: a packed buffer of variable-length
// query spans (decode rows are spans of 1, prefill chunks spans of n)
// attends causally within each span through the spans' block tables.
//
// Replaces paddle_tpu/kernels/pallas_ragged_attention.py:_ragged_kernel
// (entry ragged_paged_attention_pallas). Semantics per sequence r: span
// token i (packed row qstart[r] + i) sits at position kvlen[r] - qlen[r] + i
// and attends positions 0 .. that position; packed rows outside every span
// are left as the caller's zeros.
//
// Bound on this card: bytes for decode rows (each cached K/V row is read
// once per head for 4*D flops) and, for a long prefill chunk, operations
// (the causal span-by-cache product). Design: one block per (row r, tile of
// 16 span tokens, head); blocks whose tile starts past the span exit at
// once, so the grid's padding costs a launch slot and no reads. Each block
// walks keys only up to its tile's last causal position (blocks past kvlen
// are never read, sentinel table entries clamp into the pool). GQA indexes
// the KV head as h / (H / Hkv). The 16-row tile amortises every K/V load
// over 16 queries; the per-row arithmetic is attention_common.cuh's tile
// routine, the dense decode kernel's. The split-KV paged decode kernel
// rounds P per page against a split's running max instead, so a span-1
// row agrees with it within chip_smoke.py's TOL, not bit for bit.
#include <math.h>

#include "attention_common.cuh"

namespace pt {

constexpr int kRaggedTQ = 16;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
              const T* __restrict__ pool_v, const int* __restrict__ tables,
              const int* __restrict__ qstart, const int* __restrict__ qlen,
              const int* __restrict__ kvlen, T* __restrict__ out, int H,
              int Hkv, int nb, int bs, int mb, float scale) {
  extern __shared__ __align__(16) float smem[];
  using S = TileShape<T, D, kRaggedTQ>;
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int h = blockIdx.z;
  const int ql = qlen[r];
  const int i0 = tile * kRaggedTQ;
  if (i0 >= ql) return;                       // tile past the span
  const int kvh = h / (H / Hkv);
  const int kl = kvlen[r];
  const int first_pos = kl - ql + i0;         // position of tile row 0
  const int rows = min(kRaggedTQ, ql - i0);
  const int qs = qstart[r];
  long long* s_qoff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS) + kKeys;
  if (threadIdx.x < kRaggedTQ) {
    const int i = threadIdx.x;
    s_qoff[i] = i < rows
        ? (static_cast<long long>(qs + i0 + i) * H + h) * D : -1LL;
  }
  const int kv_valid = min(max(kl, 0), mb * bs);
  const int kv_stop = min(kv_valid, max(first_pos + rows, 0));
  const int* row_tbl = tables + static_cast<long long>(r) * mb;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return ((static_cast<long long>(phys) * bs + p % bs) * Hkv + kvh) * D;
  };
  auto row_pos = [&](int i) { return first_pos + i; };
  __syncthreads();
  attend_tile<T, D, kRaggedTQ>(q, pool_k, pool_v, out, smem, s_qoff, row_pos,
                               kv_stop, kv_valid, key_off, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* tables, const int* qstart, const int* qlen,
                   const int* kvlen, void* out, int T_, int R, int H, int Hkv,
                   int nb, int bs, int mb, cudaStream_t stream) {
  using S = TileShape<T, D, kRaggedTQ>;
  auto kernel = ragged_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // no span is longer than the packed buffer, so ceil(T / 16) tiles cover
  // every span
  dim3 grid((T_ + kRaggedTQ - 1) / kRaggedTQ, R, H);
  kernel<<<grid, kThreads, S::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), tables, qstart, qlen, kvlen,
      static_cast<T*>(out), H, Hkv, nb, bs, mb,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace pt

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* pk,
                              const void* pv, const int* tables,
                              const int* qs, const int* ql, const int* kl,
                              void* out, int T_, int R, int H, int Hkv, int nb,
                              int bs, int mb, cudaStream_t s) {
  switch (D) {
    case 64:
      return pt::launch<T, 64>(q, pk, pv, tables, qs, ql, kl, out, T_, R, H, Hkv, nb, bs, mb, s);
    case 128:
      return pt::launch<T, 128>(q, pk, pv, tables, qs, ql, kl, out, T_, R, H, Hkv, nb, bs, mb, s);
    case 256:
      return pt::launch<T, 256>(q, pk, pv, tables, qs, ql, kl, out, T_, R, H, Hkv, nb, bs, mb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q [T,H,D]; pool_k/pool_v [nb,bs,Hkv,D]; tables [R,mb] int32; qstart,
// qlen, kvlen [R] int32; out [T,H,D], zeroed by the caller (rows outside
// every span are not written). is_bf16: 0 = float32, 1 = bfloat16.
extern "C" int pt_ragged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* tables,
                                   const void* qstart, const void* qlen,
                                   const void* kvlen, void* out, int T_, int R,
                                   int H, int Hkv, int D, int nb, int bs,
                                   int mb, int is_bf16, void* stream) {
  if (T_ == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* qs = static_cast<const int*>(qstart);
  const int* ql = static_cast<const int*>(qlen);
  const int* kl = static_cast<const int*>(kvlen);
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, pool_k, pool_v, tbl, qs, ql, kl, out, T_, R, H, Hkv, nb, bs, mb, s)
              : dispatch_d<float>(D, q, pool_k, pool_v, tbl, qs, ql, kl, out, T_, R, H, Hkv, nb, bs, mb, s);
  return static_cast<int>(err);
}
