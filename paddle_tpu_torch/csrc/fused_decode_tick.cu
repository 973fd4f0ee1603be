// One whole decode tick of the LLaMA serving stack in ONE kernel launch:
// embed gather; per layer RMSNorm, QKV, RoPE, paged K/V append, paged
// attention, O-proj + residual, RMSNorm, SwiGLU, down + residual; then the
// final norm, the lm head, the per-row threefry key split and a greedy or
// top-k temperature sample.
//
// Replaces paddle_tpu/kernels/pallas_fused_decode_tick.py:_fused_tick_pallas
// (entry fused_decode_tick). The TPU kernel makes the layer loop a
// sequential grid axis and carries the residual in VMEM scratch. Hopper
// blocks run in no order, so this is a cooperative persistent launch: the
// grid is as many 128-thread blocks as fit on the card at once, and a
// grid-wide barrier (a counter and a generation word in a buffer the wrapper
// owns) separates dependent phases. Every block walks the work items of a
// phase by a grid stride:
//
//   row      one block per row: residual add of the split-K partial sums,
//            RMSNorm into hn (and the embed gather for layer 0)
//   qkv      32 output columns per item, RoPE'd in the item (a lane and the
//            lane 16 away hold a rotation pair), K/V appended to the pool
//   attn     one item per (row, head): attention_common.cuh's tile routine
//            over the UPDATED pool (after the barrier)
//   o, down  32 columns x one of kSplit K ranges per item (fp32 partials)
//   gateup   32 gate and 32 up columns per item, SiLU(gate) * up
//   head     32 vocabulary columns per item into float32 logits
//   sample   one block per row: key split, first-max greedy, top-k by radix
//            select, Gumbel-max draw
//
// Bound on this card: bytes — a tick reads every weight once (13.2 GB for
// LLaMA-7B in bf16) plus the valid cached K/V, for ~2 flops per weight per
// row. A GEMV item's lanes own neighbouring columns of a row-major [K, N]
// weight, so each k row is one coalesced read per warp; the four warps of a
// block split the item's K range and sum in a fixed order (no atomics: the
// same bits every run).
//
// Rounding follows the scanned tick (serving/decode.py:_fused_decode_tick):
// RMSNorm casts to the model type before the weight multiply, every
// projection output is rounded to the model type, RoPE is computed in
// float32 and rounded, residual adds happen in the model type; so in fp32
// the two differ only in summation order. Products and sums that PyTorch
// runs as separate ops use __fmul_rn/__fadd_rn so no FMA contracts them.
// Data written by other blocks in this launch is read with __ldcg (L2, not
// the SM's L1).
#include <math.h>

#include "attention_common.cuh"

namespace pt {
namespace ft {

constexpr int kMaxR = 16;     // rows a launch takes
constexpr int kCols = 32;     // output columns per GEMV item (one per lane)
constexpr int kKC = 128;      // k rows staged per chunk (32 per warp)
constexpr int kSplit = 4;     // K ranges of the O and down projections
constexpr float kTiny = 1.17549435e-38f;   // float32 tiny (smallest normal)

template <typename T>
struct Args {
  const long long* tok;             // [R] last tokens
  const T* embed;                   // [V, H]
  const T* wq; const T* wk; const T* wv; const T* wo;   // [L, K, N]
  const T* wg; const T* wu; const T* wd;
  const T* in_ln; const T* post_ln; // [L, H]
  const T* final_norm;              // [H]
  const T* head;                    // [H, V], or the embedding when tied
  T* pool_k; T* pool_v;             // [L, nb, bs, Hkv, D]
  const float* sin; const float* cos;   // [s_rows, D]
  const int* tables;                // [R, mb]
  const int* meta;                  // lens[R], app_mask[R], top_k[R], temps[R] (bits)
  const unsigned* keys_in;          // [R, 2]
  T* h; T* hn;                      // [R, H]
  T* q; T* attn;                    // [R, nh, D]
  T* act;                           // [R, I]
  float* part;                      // [kSplit, R, H]
  float* logits;                    // [R, V]
  long long* nxt;                   // [R]
  unsigned* keys_out;               // [R, 2]
  unsigned* bar;                    // [2]: arrivals, generation
  int R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied;
  float eps;
};

__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// ---------------------------------------------------------- grid barrier
// All blocks are co-resident (cooperative launch). Thread 0 of each block
// arrives on bar[0]; the last arrival resets it and bumps the generation
// bar[1], which the others wait for. The kernel leaves bar[0] at 0, so the
// buffer serves the next launch without a reset.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned arrived = atomicAdd(&bar[0], 1u);
    if (arrived == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicExch(&bar[1], gen + 1u);
    } else {
      while (*reinterpret_cast<volatile unsigned*>(&bar[1]) == gen) {
        __nanosleep(32);
      }
    }
    __threadfence();
    gen += 1u;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// (value, index) argmax, first index on ties, over the block
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}
__device__ __forceinline__ int block_argmax(float v, int i, float* redv, int* redi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_merge(v, i, v2, i2);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) { redv[threadIdx.x >> 5] = v; redi[threadIdx.x >> 5] = i; }
  __syncthreads();
  float bv = redv[0];
  int bi = redi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) argmax_merge(bv, bi, redv[w], redi[w]);
  return bi;
}

// ---------------------------------------------------------------- rows
// Block-per-row phase. embed: h = embed[tok]; else h = h + round(sum of the
// kSplit partials). Then hn = round(round(h * rsqrt(mean(h^2) + eps)) * w).
template <typename T>
__device__ void row_phase(const Args<T>& a, int r, bool embed, const T* w,
                          float* smem) {
  const int H = a.H;
  T* hrow = a.h + static_cast<long long>(r) * H;
  const T* erow = a.embed + a.tok[r] * static_cast<long long>(H);
  float ss = 0.f;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float hv;
    if (embed) {
      hv = ldg_f(erow + c);
    } else {
      float s = 0.f;
#pragma unroll
      for (int sp = 0; sp < kSplit; ++sp)
        s += __ldcg(a.part + (static_cast<long long>(sp) * a.R + r) * H + c);
      hv = rnd<T>(__fadd_rn(ldcg_f(hrow + c), rnd<T>(s)));
    }
    hrow[c] = from_f<T>(hv);
    ss = fmaf(hv, hv, ss);
  }
  const float total = block_sum(ss, smem);
  const float rs = rsqrtf(__fadd_rn(total / static_cast<float>(H), a.eps));
  T* hnrow = a.hn + static_cast<long long>(r) * H;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    const float hv = ldcg_f(hrow + c);   // this thread's own write above
    hnrow[c] = from_f<T>(__fmul_rn(rnd<T>(__fmul_rn(hv, rs)), ldg_f(w + c)));
  }
}

// ---------------------------------------------------------------- GEMV
// out[m][r] (valid in warp 0, lane = column) = sum_{k in [kb, ke)}
// X[r, k] * W_m[k, col_m]. X [R, ldx] of T, written in this launch (read
// via L2); W_m row-major [K, ldw], or with TIED the [ldw, K] embedding read
// transposed. Staged X chunks are kKC wide; warp w takes chunk rows
// [32w, 32w+32); the four warps' sums add in warp order.
template <typename T, int NW, bool TIED>
__device__ void gemv(const Args<T>& a, const T* X, int ldx, const T* const* W,
                     int ldw, const int* col, int kb, int ke,
                     float (&out)[NW][kMaxR], float* smem) {
  float* xs = smem;                                  // [kMaxR][kKC]
  float* red = smem + kMaxR * kKC;                   // [kWarps][NW][kMaxR][32]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = a.R;
  float acc[NW][kMaxR];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) acc[m][r] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kKC) {
    const int n = min(kKC, ke - k0);
    __syncthreads();
    for (int e = tid; e < R * kKC; e += kThreads) {
      const int r = e / kKC, j = e % kKC;
      xs[e] = j < n ? ldcg_f(X + static_cast<long long>(r) * ldx + k0 + j) : 0.f;
    }
    __syncthreads();
    const int jb = warp * 32, je = min(jb + 32, n);
#pragma unroll 4
    for (int j = jb; j < je; ++j) {
      const long long k = k0 + j;
      float wv[NW];
#pragma unroll
      for (int m = 0; m < NW; ++m)
        wv[m] = TIED ? ldg_f(W[m] + static_cast<long long>(col[m]) * ldw + k)
                     : ldg_f(W[m] + k * ldw + col[m]);
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          const float x = xs[r * kKC + j];
#pragma unroll
          for (int m = 0; m < NW; ++m) acc[m][r] = fmaf(x, wv[m], acc[m][r]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R) red[((warp * NW + m) * kMaxR + r) * 32 + lane] = acc[m][r];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += red[((w * NW + m) * kMaxR + r) * 32 + lane];
          out[m][r] = s;
        }
      }
  }
}

// the K range [kb, ke) of split sp: 32-aligned cuts
__device__ __forceinline__ void split_range(int K, int sp, int& kb, int& ke) {
  const int chunk = ((K + kSplit - 1) / kSplit + 31) / 32 * 32;
  kb = min(K, sp * chunk);
  ke = min(K, kb + chunk);
}

// ---------------------------------------------------------------- phases
// QKV item: head `head` of q, then k, then v heads; tile t covers the
// rotation pairs [16t, 16t+16) and [D/2 + 16t, D/2 + 16t + 16).
template <typename T, int D>
__device__ void qkv_item(const Args<T>& a, int l, int it, float* smem) {
  constexpr int TPH = D / 32;
  constexpr int HALF = D / 2;
  const int head = it / TPH, t = it % TPH;
  const int lane = threadIdx.x & 31;
  const int d = lane < 16 ? 16 * t + lane : HALF + 16 * t + (lane - 16);
  const int H = a.H, nh = a.nh, nkv = a.nkv;
  const T* w;
  int ldw, col, kind, hh;
  if (head < nh) {
    kind = 0; hh = head; ldw = nh * D;
    w = a.wq + static_cast<long long>(l) * H * ldw;
  } else if (head < nh + nkv) {
    kind = 1; hh = head - nh; ldw = nkv * D;
    w = a.wk + static_cast<long long>(l) * H * ldw;
  } else {
    kind = 2; hh = head - nh - nkv; ldw = nkv * D;
    w = a.wv + static_cast<long long>(l) * H * ldw;
  }
  col = hh * D + d;
  float out[1][kMaxR];
  const T* W[1] = {w};
  gemv<T, 1, false>(a, a.hn, H, W, ldw, &col, 0, H, out, smem);
  if ((threadIdx.x >> 5) != 0) return;
  const int R = a.R;
  const int* lens = a.meta;
  const int* app = a.meta + R;
  const int s_tot = a.mb * a.bs;
  const long long layer_off = static_cast<long long>(l) * a.nb * a.bs * nkv * D;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r >= R) break;
    float y = rnd<T>(out[0][r]);
    const int len = lens[r];
    if (kind < 2) {
      const int pos = min(max(len, 0), a.s_rows - 1);
      const float partner = __shfl_xor_sync(0xffffffffu, y, 16);
      const float rot = lane < 16 ? -partner : partner;
      y = rnd<T>(__fadd_rn(__fmul_rn(y, a.cos[pos * D + d]),
                           __fmul_rn(rot, a.sin[pos * D + d])));
    }
    if (kind == 0) {
      a.q[(static_cast<long long>(r) * nh + hh) * D + d] = from_f<T>(y);
      continue;
    }
    // append at (phys, prow); masked rows, rows past capacity and sentinel
    // table entries do not write
    const int bi = min(max(len, 0) / a.bs, a.mb - 1);
    const int phys = a.tables[r * a.mb + bi];
    if (app[r] > 0 && len >= 0 && len < s_tot && phys >= 0 && phys < a.nb) {
      T* pool = kind == 1 ? a.pool_k : a.pool_v;
      pool[layer_off + ((static_cast<long long>(phys) * a.bs + len % a.bs) * nkv + hh) * D + d] =
          from_f<T>(y);
    }
  }
}

template <typename T, int D>
__device__ void attn_item(const Args<T>& a, int l, int it, float* smem) {
  using S = TileShape<T, D, 1>;
  const int r = it / a.nh, h = it % a.nh;
  const int kvh = h / (a.nh / a.nkv);
  long long* s_qoff = reinterpret_cast<long long*>(smem + S::SMEM_FLOATS) + kKeys;
  __syncthreads();   // the previous item's epilogue has read s_qoff
  if (threadIdx.x == 0) s_qoff[0] = (static_cast<long long>(r) * a.nh + h) * D;
  const int alen = a.meta[r] + a.meta[a.R + r];
  const int len = min(max(alen, 0), a.mb * a.bs);
  const int* row_tbl = a.tables + static_cast<long long>(r) * a.mb;
  const int nb = a.nb, bs = a.bs, nkv = a.nkv;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return ((static_cast<long long>(phys) * bs + p % bs) * nkv + kvh) * D;
  };
  auto row_pos = [&](int) { return len - 1; };
  __syncthreads();
  const long long layer_off = static_cast<long long>(l) * a.nb * a.bs * nkv * D;
  attend_tile<T, D, 1>(a.q, a.pool_k + layer_off, a.pool_v + layer_off, a.attn,
                       smem, s_qoff, row_pos, len, len, key_off,
                       1.0f / sqrtf(static_cast<float>(D)));
}

// split-K projection into the fp32 partials: O (X = attn) or down (X = act)
template <typename T>
__device__ void proj_split_item(const Args<T>& a, const T* X, int K,
                                const T* w, int it, float* smem) {
  const int H = a.H;
  const int tiles = H / kCols;
  const int tile = it % tiles, sp = it / tiles;
  int kb, ke;
  split_range(K, sp, kb, ke);
  const int col = tile * kCols + (threadIdx.x & 31);
  float out[1][kMaxR];
  const T* W[1] = {w};
  gemv<T, 1, false>(a, X, K, W, H, &col, kb, ke, out, smem);
  if ((threadIdx.x >> 5) != 0) return;
  for (int r = 0; r < a.R; ++r)
    a.part[(static_cast<long long>(sp) * a.R + r) * H + col] = out[0][r];
}

template <typename T>
__device__ void gateup_item(const Args<T>& a, int l, int it, float* smem) {
  const int H = a.H, I = a.I;
  const int c = it * kCols + (threadIdx.x & 31);
  const int cols[2] = {c, c};
  const long long off = static_cast<long long>(l) * H * I;
  const T* W[2] = {a.wg + off, a.wu + off};
  float out[2][kMaxR];
  gemv<T, 2, false>(a, a.hn, H, W, I, cols, 0, H, out, smem);
  if ((threadIdx.x >> 5) != 0) return;
  for (int r = 0; r < a.R; ++r) {
    const float g = rnd<T>(out[0][r]);
    const float u = rnd<T>(out[1][r]);
    const float s = rnd<T>(g / (1.0f + expf(-g)));
    a.act[static_cast<long long>(r) * I + c] = from_f<T>(__fmul_rn(s, u));
  }
}

template <typename T>
__device__ void head_item(const Args<T>& a, int it, float* smem) {
  const int c = it * kCols + (threadIdx.x & 31);
  float out[1][kMaxR];
  const T* W[1] = {a.head};
  if (a.tied)
    gemv<T, 1, true>(a, a.hn, a.H, W, a.H, &c, 0, a.H, out, smem);
  else
    gemv<T, 1, false>(a, a.hn, a.H, W, a.V, &c, 0, a.H, out, smem);
  if ((threadIdx.x >> 5) != 0) return;
  for (int r = 0; r < a.R; ++r)
    a.logits[static_cast<long long>(r) * a.V + c] = rnd<T>(out[0][r]);
}

// ---------------------------------------------------------------- sampling
__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (core/random.py:threefry2x32)
__device__ __forceinline__ void threefry(unsigned k1, unsigned k2, unsigned x1,
                                         unsigned x2, unsigned& o1, unsigned& o2) {
  const unsigned ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned a = x1 + ks[0], b = x2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  o1 = a;
  o2 = b;
}

// order-preserving key of a float (larger float, larger key)
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float fkey_inv(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <typename T>
__device__ void sample_row(const Args<T>& a, int r, float* smem) {
  const int V = a.V, R = a.R;
  const int tid = threadIdx.x;
  float* redv = smem;
  int* redi = reinterpret_cast<int*>(smem + kWarps);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + 2 * kWarps);   // [256]
  unsigned* sel = hist + 256;                                         // [3]
  const float* lg = a.logits + static_cast<long long>(r) * V;
  // one split of the row's key: carry = split[0], draw = split[1]
  const unsigned k1 = a.keys_in[2 * r], k2 = a.keys_in[2 * r + 1];
  unsigned c1, c2, d1, d2;
  threefry(k1, k2, 0u, 0u, c1, c2);
  threefry(k1, k2, 0u, 1u, d1, d2);
  if (tid == 0) {
    a.keys_out[2 * r] = c1;
    a.keys_out[2 * r + 1] = c2;
  }
  // greedy: the first maximal logit
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = tid; j < V; j += kThreads) {
    const float v = __ldcg(lg + j);
    if (v > bv) { bv = v; bi = j; }
  }
  const int greedy = block_argmax(bv, bi, redv, redi);
  const float temp = __int_as_float(a.meta[3 * R + r]);
  if (!(temp > 0.0f)) {
    if (tid == 0) a.nxt[r] = greedy;
    return;
  }
  const float t = fmaxf(temp, 1e-6f);
  const int tk = a.meta[2 * R + r];
  const int k_eff = min(max(tk <= 0 ? V : tk, 1), V);
  // the k-th largest of lg / t: radix select over the order-preserving
  // keys, 8 bits a pass, counting in a shared histogram
  float thr = -INFINITY;
  if (k_eff < V) {
    unsigned prefix = 0u, mask = 0u;
    int kk = k_eff;
    for (int shift = 24; shift >= 0; shift -= 8) {
      __syncthreads();
      for (int b = tid; b < 256; b += kThreads) hist[b] = 0u;
      __syncthreads();
      for (int j = tid; j < V; j += kThreads) {
        const unsigned key = fkey(__fdiv_rn(__ldcg(lg + j), t));
        if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, digit = 0;
        for (int b = 255; b >= 0; --b) {
          const int c = static_cast<int>(hist[b]);
          if (cum + c >= kk) { digit = b; break; }
          cum += c;
        }
        sel[0] = prefix | (static_cast<unsigned>(digit) << shift);
        sel[1] = mask | (255u << shift);
        sel[2] = static_cast<unsigned>(kk - cum);
      }
      __syncthreads();
      prefix = sel[0];
      mask = sel[1];
      kk = static_cast<int>(sel[2]);
    }
    thr = fkey_inv(prefix);
  }
  // Gumbel-max under the draw key: u from the 23 high bits, lifted to tiny
  float sv = -INFINITY;
  int si = 0x7fffffff;
  for (int j = tid; j < V; j += kThreads) {
    float x = __fdiv_rn(__ldcg(lg + j), t);
    x = x < thr ? kNegInf : x;
    unsigned b1, b2;
    threefry(d1, d2, 0u, static_cast<unsigned>(j), b1, b2);
    const float f = __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, kTiny)), kTiny));
    const float g = -logf(-logf(u));
    const float v = __fadd_rn(g, x);
    if (v > sv) { sv = v; si = j; }
  }
  const int sampled = block_argmax(sv, si, redv, redi);
  if (tid == 0) a.nxt[r] = sampled;
}

// ---------------------------------------------------------------- kernel
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 4)
fused_tick_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  unsigned gen = 0u;
  if (threadIdx.x == 0) gen = *reinterpret_cast<volatile unsigned*>(&a.bar[1]);
  const int nblk = gridDim.x, b0 = blockIdx.x;
  const int H = a.H, R = a.R;
  for (int r = b0; r < R; r += nblk) row_phase(a, r, true, a.in_ln, smem);
  grid_sync(a.bar, gen);
  const int n_qkv = (a.nh + 2 * a.nkv) * (D / 32);
  const int n_attn = R * a.nh;
  const int n_proj = (H / kCols) * kSplit;
  const int n_gu = a.I / kCols;
  for (int l = 0; l < a.L; ++l) {
    for (int it = b0; it < n_qkv; it += nblk) qkv_item<T, D>(a, l, it, smem);
    grid_sync(a.bar, gen);
    for (int it = b0; it < n_attn; it += nblk) attn_item<T, D>(a, l, it, smem);
    grid_sync(a.bar, gen);
    const T* wo = a.wo + static_cast<long long>(l) * a.nh * D * H;
    for (int it = b0; it < n_proj; it += nblk)
      proj_split_item(a, a.attn, a.nh * D, wo, it, smem);
    grid_sync(a.bar, gen);
    for (int r = b0; r < R; r += nblk)
      row_phase(a, r, false, a.post_ln + static_cast<long long>(l) * H, smem);
    grid_sync(a.bar, gen);
    for (int it = b0; it < n_gu; it += nblk) gateup_item(a, l, it, smem);
    grid_sync(a.bar, gen);
    const T* wd = a.wd + static_cast<long long>(l) * a.I * H;
    for (int it = b0; it < n_proj; it += nblk)
      proj_split_item(a, a.act, a.I, wd, it, smem);
    grid_sync(a.bar, gen);
    const T* next_w = l + 1 < a.L ? a.in_ln + static_cast<long long>(l + 1) * H
                                  : a.final_norm;
    for (int r = b0; r < R; r += nblk) row_phase(a, r, false, next_w, smem);
    grid_sync(a.bar, gen);
  }
  for (int it = b0; it < a.V / kCols; it += nblk) head_item(a, it, smem);
  grid_sync(a.bar, gen);
  for (int r = b0; r < R; r += nblk) sample_row(a, r, smem);
}

template <int D>
constexpr size_t smem_bytes() {
  // the attention tile (bf16 and float32 stage as float: same size) or the
  // GEMV staging + cross-warp sums, whichever is larger
  constexpr size_t attn = TileShape<float, D, 1>::SMEM_BYTES;
  constexpr size_t gemv = (kMaxR * kKC + kWarps * 2 * kMaxR * 32) * sizeof(float);
  return attn > gemv ? attn : gemv;
}

template <typename T, int D>
cudaError_t launch(Args<T> a, int max_blocks_per_sm, cudaStream_t stream,
                   int* grid_out) {
  auto kernel = fused_tick_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (max_blocks_per_sm > 0) per_sm = min(per_sm, max_blocks_per_sm);
  const int grid = per_sm * sms;
  if (grid_out) *grid_out = grid;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ft
}  // namespace pt

template <typename T>
static cudaError_t dispatch(int D, void** p, const int* n, float eps,
                            int max_blocks_per_sm, cudaStream_t stream,
                            int* grid_out) {
  pt::ft::Args<T> a;
  a.tok = static_cast<const long long*>(p[0]);
  a.embed = static_cast<const T*>(p[1]);
  a.wq = static_cast<const T*>(p[2]);
  a.wk = static_cast<const T*>(p[3]);
  a.wv = static_cast<const T*>(p[4]);
  a.wo = static_cast<const T*>(p[5]);
  a.wg = static_cast<const T*>(p[6]);
  a.wu = static_cast<const T*>(p[7]);
  a.wd = static_cast<const T*>(p[8]);
  a.in_ln = static_cast<const T*>(p[9]);
  a.post_ln = static_cast<const T*>(p[10]);
  a.final_norm = static_cast<const T*>(p[11]);
  a.head = static_cast<const T*>(p[12]);
  a.pool_k = static_cast<T*>(p[13]);
  a.pool_v = static_cast<T*>(p[14]);
  a.sin = static_cast<const float*>(p[15]);
  a.cos = static_cast<const float*>(p[16]);
  a.tables = static_cast<const int*>(p[17]);
  a.meta = static_cast<const int*>(p[18]);
  a.keys_in = static_cast<const unsigned*>(p[19]);
  a.h = static_cast<T*>(p[20]);
  a.hn = static_cast<T*>(p[21]);
  a.q = static_cast<T*>(p[22]);
  a.attn = static_cast<T*>(p[23]);
  a.act = static_cast<T*>(p[24]);
  a.part = static_cast<float*>(p[25]);
  a.logits = static_cast<float*>(p[26]);
  a.nxt = static_cast<long long*>(p[27]);
  a.keys_out = static_cast<unsigned*>(p[28]);
  a.bar = static_cast<unsigned*>(p[29]);
  a.R = n[0]; a.L = n[1]; a.H = n[2]; a.nh = n[3]; a.nkv = n[4];
  a.I = n[5]; a.V = n[6]; a.nb = n[7]; a.bs = n[8]; a.mb = n[9];
  a.s_rows = n[10]; a.tied = n[11];
  a.eps = eps;
  switch (D) {
    case 64:
      return pt::ft::launch<T, 64>(a, max_blocks_per_sm, stream, grid_out);
    case 128:
      return pt::ft::launch<T, 128>(a, max_blocks_per_sm, stream, grid_out);
    default:
      return cudaErrorInvalidValue;
  }
}

// The 30 pointers in Args order (tok ... bar); ints R, L, H, nh, nkv, I, V,
// nb, bs, mb, s_rows, tied, then D and is_bf16; eps; a cap on blocks per SM
// (0 = as many as fit); grid_out receives the launched grid size.
extern "C" int pt_fused_decode_tick(
    void* tok, void* embed, void* wq, void* wk, void* wv, void* wo, void* wg,
    void* wu, void* wd, void* in_ln, void* post_ln, void* final_norm,
    void* head, void* pool_k, void* pool_v, void* sin, void* cos,
    void* tables, void* meta, void* keys_in, void* h, void* hn, void* q,
    void* attn, void* act, void* part, void* logits, void* nxt,
    void* keys_out, void* bar, int R, int L, int H, int nh, int nkv, int I,
    int V, int nb, int bs, int mb, int s_rows, int tied, int D, int is_bf16,
    float eps, int max_blocks_per_sm, void* grid_out, void* stream) {
  void* p[30] = {tok, embed, wq, wk, wv, wo, wg, wu, wd, in_ln, post_ln,
                 final_norm, head, pool_k, pool_v, sin, cos, tables, meta,
                 keys_in, h, hn, q, attn, act, part, logits, nxt, keys_out,
                 bar};
  const int n[12] = {R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied};
  if (R < 1 || R > pt::ft::kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* g = static_cast<int*>(grid_out);
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, p, n, eps, max_blocks_per_sm, s, g)
      : dispatch<float>(D, p, n, eps, max_blocks_per_sm, s, g);
  return static_cast<int>(err);
}
