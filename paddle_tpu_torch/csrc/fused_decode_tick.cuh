// One whole decode tick of the LLaMA serving stack in ONE kernel launch:
// embed gather; per layer RMSNorm, QKV, RoPE, paged K/V append, paged
// attention, O-proj + residual, RMSNorm, SwiGLU, down + residual; then the
// final norm, the lm head, the per-row threefry key split and a greedy or
// top-k temperature sample.
//
// Replaces paddle_tpu/kernels/pallas_fused_decode_tick.py:_fused_tick_pallas
// (its pallas_call at :335; entry fused_decode_tick). The TPU kernel makes
// the layer loop a sequential grid axis and carries the residual in VMEM
// scratch. Hopper blocks run in no order, so this is a cooperative
// persistent launch: as many 128-thread blocks as fit on the card at once
// (the wrapper caps it at 4 an SM; __launch_bounds__ asks for 3, 168
// registers a thread, which the 7B bf16 tick's ~49 KB of shared memory
// allows: 396 blocks on an H100, one for each of the attention's ~350
// long walks; 2 an SM, 255 registers and no spills, measured slower), and
// a grid-wide barrier (a counter and a generation word in a buffer the
// wrapper owns) between dependent phases.
//
// Bound on this card: bytes. A tick reads every weight once (13.2 GB for
// LLaMA-7B in bf16) plus the valid cached K/V (32 layers x the rows' keys
// x 2 x 8 KB), for ~2 flops per weight per row: far below the ~295
// flops/byte at which the H100 stops being memory bound. So the design
// keeps weight bytes in flight and every block busy. Phases, 7 barriers a
// layer and 2 more a tick:
//
//   GEMV (QKV, O, gate/up, down, lm head). A projection is tiles of NT
//     output columns (64 bf16, 32 fp32) x chunks of kKC = 64 k rows (8 KB
//     of weight; int8 weights in bf16: 64 rows x 2 tiles, 8 KB too: Chunk),
//     numbered tile-major. Block b streams the chunks
//     [b*C/G, (b+1)*C/G): every block gets the same share of bytes whatever
//     the projection's shape (split-K where a phase has fewer tiles than
//     blocks, several tiles a block where it has more). Chunks arrive by
//     16-byte cp.async into a kStages-deep ring, the chunk's X rows beside
//     its weights: 3 chunks (24 KB of weight) in flight a block, ~72 KB an
//     SM (int8 weights in bf16: 2, Chunk::STAGES).
//       bf16: mma.sync.m16n8k16 with swapped operands. A is the weight:
//       16 output columns x 16 k by ldmatrix.trans from the [k][n] chunk
//       (ldmatrix from the [n][k] embedding when the head is tied); B is 8
//       rows of X by ldmatrix; fp32 accumulators. Warp w owns columns
//       16w .. 16w+15 of the tile and walks every 8-row tile of X, so the
//       rows cost tensor-core time, not weight reads.
//       fp32: CUDA cores; lane = column, warp w = k rows 16w .. 16w+15 of
//       each chunk, fmaf in k order, the four warps added in warp order.
//     Accumulators live in shared memory ([row tile][warp][lane]), so a
//     tile holds up to kRowPass = 64 rows whatever their count: every
//     weight is read from device memory once a tick for up to 64 rows, and
//     once more for each further 64.
//     A block's share of one tile is a piece: it writes its fp32 partial
//     sums to slot (b - first block of the tile) of a scratch buffer and
//     takes a ticket of the tile's group (QKV: the fewest whole heads that
//     fill whole tiles, NT / gcd(D, NT) heads of D columns: one head of 64,
//     128 or 256, four of 16 or 80; a gate tile and its up tile; else one
//     tile). The block that completes
//     a group adds the group's pieces in slot order (no atomics on data:
//     the same bits every run, whichever block finishes last) and runs the
//     phase's epilogue there: RoPE in float32 for q and k, q to the query
//     buffer, k and v appended to the pool (masked rows, rows past
//     capacity and sentinel table entries do not write); h += round(O or
//     down); SiLU(gate) * up; the float32 logits.
//   attention  the split-KV walk of csrc/split_kv.cuh, one item per
//     (split, KV head, row), blocks taking items from a counter (the walks
//     differ in length), with as few accumulator registers as the KV
//     head's G * D needs, the split plan and its scratch from
//     kernels/split_kv.py, key p through the row's table as paged_decode.cu
//     reads it, over the pool after this tick's append (after the barrier).
//   norm       one block per row: RMSNorm of h into hn (at layer 0 the
//     embed gather first).
//   sample     one block per row: key split, first-max greedy, top-k by
//     radix select, Gumbel-max draw.
//
// The attention output is paged decode's, bit for bit: the same walk with
// the same split plan (kernels/split_kv.py plan() over the tables'
// capacity, for R rows), the same key_off, the same 1/sqrt(D), and the
// splits combined in split order by the last block of a (row, KV head) —
// whichever block that is. The query is read through L2 (written earlier
// in this launch).
//
// Head dims: any D % 8 == 0 up to 256. The projections, RoPE and the
// appends work on the model's D columns a head (a tile may hold several
// heads, or parts of two: a group is whole heads, and a 16-byte weight
// copy takes its own segment of wq, wk, wv); the attention walk runs at
// D's padded width (64, 128 or 256), as paged_decode.cu runs it. The
// QKV width (nh + 2 nkv) * D is a multiple of 64, as the other widths.
//
// Rounding follows the scanned tick (serving/decode.py:_fused_decode_tick):
// RMSNorm casts to the model type before the weight multiply, every
// projection output is rounded to the model type, RoPE is computed in
// float32 and rounded, residual adds happen in the model type; so in fp32
// the two differ only in summation order. Products and sums that PyTorch
// runs as separate ops use __fmul_rn/__fadd_rn so no FMA contracts them.
// Data written by other blocks in this launch is read through L2
// (__ldcg, cp.async.cg), never the SM's L1.
//
// Quantized serving (the reference kernel's int8 weight pairs, fp8 and
// int8 pools, quantize-on-write appends and in-kernel dequant):
//   - int8 weights (w8, a template flag: the dense kernel keeps its own
//     code and registers): each weight is a [K, N] int8
//     array and a float32 scale an output column (the lm head: [V, H] when
//     tied, its scales along V). Every weight that reaches an MMA is
//     round(float(q) * scale[col]) — serving/decode.py _dq's bits, rounded
//     once. bf16 (Chunk::R8): a chunk is two tiles wide, 64 k rows x 128
//     columns of int8, 8 KB in 128-byte rows: the bytes and the row width
//     a dense chunk streams, so a tick runs half the dense tick's chunk
//     iterations and reads half its rows (a one-tile-wide int8 chunk of
//     64 or 128 rows reads 64-byte rows, and measured no faster than the
//     dense tick: the tick's time follows the rows it reads). A width of
//     an odd number of tiles ends in a one-tile chunk; kernels/
//     fused_decode_tick.py sizes the pieces' buffer for this plan, and a
//     piece takes the ticket of each of its tiles' groups. The chunk
//     lands as it is, XOR-swizzled by the row, with its 128 column
//     scales, and each warp builds its two MMA tiles' A fragments from it
//     in registers (one 32-bit read a k row: a thread's four columns are
//     neighbouring bytes), with no bf16 copy and no pass through shared
//     memory. fp32 keeps the dense chunk's kKC x NT shape: 2 KB of int8
//     into a raw area of its stage, dequantized after it lands into the
//     stage's weight tile in the dense copy's layout.
//   - an int8 pool (KT int8_t, QM 1): the QKV epilogue of a K or V head
//     takes one warp a row: the RoPE'd, rounded row's absmax over D by a
//     warp reduction, scale = amax / 127, q = clip(rint(x / max(scale,
//     1e-30)), -127, 127) with IEEE division and round half to even
//     (kv_cache.quantize_kv_rows's bits; no fast-math), data and scale
//     written at the append coordinate. An fp8 pool (KT __nv_fp8_e4m3,
//     QM 2): a saturating round-to-nearest-even cast, planes never
//     written. The attention is the walk's quantized mode over the
//     updated pool, paged_decode.cu's row for row, so still its bits.
//
// This header holds the kernel; fused_decode_tick.cu is its one C entry
// over fused_tick_entry<MODE, W8> below, compiled once a (pool mode,
// weights) pair into a library of its own, so the six build in parallel.
#pragma once

#include <math.h>

#include <type_traits>

#include "split_kv.cuh"

namespace pt {
namespace ft {

static_assert(kThreads == skv::kNT, "every phase runs on one block shape");

constexpr int kKC = 64;         // k rows a weight chunk
constexpr int kStages = 4;      // chunks in the cp.async ring (3 in flight)
constexpr int kRowPass = 64;    // rows a pass over the weights
constexpr float kTiny = 1.17549435e-38f;   // float32 tiny (smallest normal)

// GEMV geometry by type: a dense chunk is 8 KB of weight either way
template <typename T>
struct Geo {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VEC = 16 / sizeof(T);            // elements a 16-byte copy
  static constexpr int NT = BF ? 64 : 32;               // output columns a tile
  static constexpr int W_BYTES = kKC * NT * sizeof(T);  // a chunk's weights
  static_assert(W_BYTES == 8192 && W_BYTES / 16 % kThreads == 0,
                "every thread copies the same count");
};

// A GEMV chunk by type and weights: kKC k rows by CW columns (a plan
// tile), the bytes its weights take in the ring, its X bytes a row. A
// dense chunk is one NT-column tile (8 KB of weight). bf16 with int8
// weights (R8) is two tiles wide: 64 k rows x 128 columns of int8, 8 KB
// in 128-byte rows, the bytes and the row width of a dense chunk (a
// one-tile-wide int8 chunk reads 64-byte rows, and the tick's time follows
// the rows it reads, not their bytes), with no bf16 copy: the MMAs' A
// fragments are built in registers from it. fp32 with int8 weights keeps
// the dense chunk's shape (2 KB of int8, dequantized into the stage's
// weight tile).
template <typename T, bool W8>
struct Chunk {
  static constexpr bool R8 = W8 && Geo<T>::BF;
  static constexpr int CW = R8 ? 2 * Geo<T>::NT : Geo<T>::NT;
  static constexpr int W_BYTES = R8 ? kKC * CW : Geo<T>::W_BYTES;
  static constexpr int X_ROW = kKC * sizeof(T);
  // the third part of a stage: fp32's raw int8, or R8's column scales (CW
  // floats, copied with the chunk so that no global read waits in the
  // MMA loop)
  static constexpr int Q8_BYTES = W8 ? (R8 ? CW * 4 : kKC * Geo<T>::NT) : 0;
  // accumulator bytes a row: CW fp32 (bf16), or 32 columns x 4 warps (fp32)
  static constexpr int ACC_ROW = Geo<T>::BF ? CW * 4 : 512;
  // chunks in the cp.async ring: R8 keeps 2 in flight ahead of the one in
  // use, the others kStages - 1. At 7B widths, 32 layers, 8 rows on an
  // H100 the int8 tick ran fastest with 3 stages of 2 to 6, slower with
  // each stage added (more int8 bytes in flight only queue longer;
  // scripts/quant_timing.py --patch stages-N measures it).
  static constexpr int STAGES = R8 ? 3 : kStages;
  static_assert(W_BYTES == 8192, "8 KB of weight a chunk");
};

template <typename T, typename KT>
struct Args {
  const long long* tok;             // [R] last tokens
  const T* embed;                   // [V, H]
  const T* wq; const T* wk; const T* wv; const T* wo;   // [L, K, N]
  const T* wg; const T* wu; const T* wd;
  const T* in_ln; const T* post_ln; // [L, H]
  const T* final_norm;              // [H]
  const T* head;                    // [H, V], or the embedding when tied
  KT* pool_k; KT* pool_v;           // [L, nb, bs, Hkv, hd]
  float* k_scale; float* v_scale;   // a quantized pool's planes, or null
  // int8 weights (W8): wq .. wd and the head as int8, their scales
  // [L, N] (the head's [V]) in s8, in the order wq, wk, wv, wo, wg, wu,
  // wd, head
  const int8_t* q8[8];
  const float* s8[8];
  const float* sin; const float* cos;   // [s_rows, hd]
  const int* tables;                // [R, mb]
  const int* meta;                  // lens[R], app_mask[R], top_k[R], temps[R] (bits)
  const unsigned* keys_in;          // [R, 2]
  T* h; T* hn;                      // [R, H]
  T* q; T* attn;                    // [R, nh, hd]
  T* act;                           // [R, I]
  float* part;                      // GEMV pieces [slots, R, N]
  float* logits;                    // [R, V]
  long long* nxt;                   // [R]
  unsigned* keys_out;               // [R, 2]
  unsigned* bar;                    // [2]: arrivals, generation
  unsigned* queue;                  // the attention items' counter (bar[2])
  int* gtickets;                    // the GEMV groups' tickets (bar[3 ..])
  float* part_m; float* part_l;     // the walk's partials [R, Hkv, n_split, G]
  float* part_acc;                  // ... and [R, Hkv, n_split, G, Dp]
  int* tickets;                     // [>= R * Hkv], zero, left zero
  int R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied, split_len, n_split;
  int hd;                           // the head dim (the template's D is
                                    // its padded width)
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


// ------------------------------------------------------- split-K plan
// A projection of N columns over K is ceil(N / nt) plan tiles (nt = a
// chunk's columns, Chunk::CW; an int8 bf16 plan tile of 128 columns may
// end in one of 64) x (K / kKC) chunks, numbered tile-major. The first
// geff = min(grid, C) blocks stream the chunks [begin(b), begin(b + 1))
// each; the rest sit the phase out. Block b's share of a plan tile is a
// piece, written to partial slot b - first(the tile); a tile's pieces are
// added in slot order.
struct Plan {
  int C, nc, geff, nt;   // C * geff < 2^31 at every geometry the wrapper takes
  __device__ Plan(int N, int K, int nt_)
      : C((N + nt_ - 1) / nt_ * (K / kKC)), nc(K / kKC), nt(nt_) {
    geff = min(C, static_cast<int>(gridDim.x));
  }
  __device__ int begin(int b) const { return b * C / geff; }
  __device__ int block_of(int c) const { return ((c + 1) * geff - 1) / C; }
  __device__ int first(int t) const { return block_of(t * nc); }
  __device__ int pieces(int t) const {
    return block_of(t * nc + nc - 1) - first(t) + 1;
  }
};

// What the block that completes a group of tiles does with their summed
// pieces (the phase's epilogue, in the same phase):
//   kQKV     a group of heads (qkv_group_heads), D columns each: RoPE for
//            q and k, q to the query buffer, k and v appended to the pool
//   kResid   one tile of O or down: h = round(h + round(sum))
//   kGateUp  gate tile g and up tile g + I / NT: act = round(round(SiLU(g))
//            * u)
//   kHead    one tile of the lm head: the logits, rounded to the model type
enum Kind { kQKV, kResid, kGateUp, kHead };

// The heads of a QKV group at head dim hd and NT-column tiles: the fewest
// whole heads whose columns are whole tiles, NT / gcd(hd, NT) (NT is a
// power of two, so the gcd is hd's largest power-of-two factor, at most
// NT). The last group of a projection may hold fewer.
__device__ __forceinline__ int qkv_group_heads(int hd, int NT) {
  return NT / min(hd & -hd, NT);
}

// One projection: X [R, K] (written in this launch) times N columns made
// of up to three weight segments, columns [end[s-1], end[s]) from the
// row-major [K, ld[s]] w[s] (QKV: wq, wk, wv; gate/up: wg, wu); with tied,
// w[0] is the [N, K] embedding, read transposed. l is the layer (for the
// append).
template <typename T>
struct Gemv {
  const T* X;
  int ldx, K, N;
  const T* w[3];
  int ld[3], end[3];
  bool tied;
  Kind kind;
  int l;
  const int8_t* q[3];   // int8 weights (w8) in place of w, and their
  const float* s[3];    // scales, one an output column of the segment
};

// element offset of 16-byte chunk c of row r in a tile of 128-byte bf16
// rows, chunks XOR-swizzled by the row (tc::swz's pattern): the eight rows
// ldmatrix reads at one logical chunk land in eight bank groups
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// s[j] = the pieces of output (r[j], n[j]) of a [R, N] projection, added
// in slot order; four slots of every output in flight at once
template <int U>
__device__ __forceinline__ void piece_sums(const Plan& p, const float* part,
                                           int R, int N, const int (&r)[U],
                                           const int (&n)[U],
                                           const bool (&ok)[U],
                                           float (&s)[U]) {
  const long long stride = static_cast<long long>(R) * N;
  const float* base[U];
  int np[U], most = 0;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    s[j] = 0.f;
    np[j] = ok[j] ? p.pieces(n[j] / p.nt) : 0;
    most = max(most, np[j]);
    base[j] = part + static_cast<long long>(ok[j] ? r[j] : 0) * N + (ok[j] ? n[j] : 0);
  }
  for (int s0 = 0; s0 < most; s0 += 4) {
    float v[4][U];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < U; ++j)
        v[q][j] = s0 + q < np[j] ? __ldcg(base[j] + (s0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (s0 + q < np[j]) s[j] += v[q][j];
  }
}

// The append coordinate of row rr (masked rows, rows past capacity and
// sentinel table entries: -1), as the row's flat (block, row) of layer l
template <typename T, typename KT>
__device__ __forceinline__ long long append_row(const Args<T, KT>& a, int l,
                                                int rr) {
  const int len = a.meta[rr];
  const int phys = a.tables[rr * a.mb + min(max(len, 0) / a.bs, a.mb - 1)];
  if (a.meta[a.R + rr] > 0 && len >= 0 && len < a.mb * a.bs && phys >= 0 &&
      phys < a.nb)
    return (static_cast<long long>(l) * a.nb + phys) * a.bs + len % a.bs;
  return -1;
}

// RoPE at the row's length (rotate_half) of the pair (o0, o1) at (d,
// d + hd/2), rounded to the model type
template <typename T, typename KT>
__device__ __forceinline__ void rope_pair(const Args<T, KT>& a, int rr, int d,
                                          float& o0, float& o1) {
  const int len = a.meta[rr], hd = a.hd;
  const float* cs = a.cos + min(max(len, 0), a.s_rows - 1) * hd;
  const float* sn = a.sin + min(max(len, 0), a.s_rows - 1) * hd;
  const float x0 = o0, x1 = o1;
  o0 = rnd<T>(__fadd_rn(__fmul_rn(x0, cs[d]), __fmul_rn(-x1, sn[d])));
  o1 = rnd<T>(__fadd_rn(__fmul_rn(x1, cs[d + hd / 2]),
                        __fmul_rn(x0, sn[d + hd / 2])));
}

// An int8 pool's K or V head grp of the QKV projection, one warp a row:
// the row's hd values (RoPE'd for K, rounded to the model type), their
// absmax by a warp reduction, then kv_cache.quantize_kv_rows's rule, data
// and scale at the append coordinate. D is hd's padded width.
template <typename T, int D, typename KT>
__device__ void finish_kv_int8(const Args<T, KT>& a, const Gemv<T>& g,
                               const Plan& p, int grp) {
  constexpr int U = D / 64 > 2 ? D / 64 : 2;   // pairs a lane: D/2 = 32 (D 64),
                                               // 64 (D 128) or 128 (D 256)
  const int R = a.R, N = g.N, nh = a.nh, nkv = a.nkv, hd = a.hd;
  const int lane = threadIdx.x & 31;
  const bool is_v = grp >= nh + nkv;
  const int hh = grp - nh - (is_v ? nkv : 0);
  for (int rr = threadIdx.x >> 5; rr < R; rr += kWarps) {
    int r[U], n0[U], n1[U];
    bool ok[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int d = lane + 32 * j;
      ok[j] = d < hd / 2;
      r[j] = rr;
      n0[j] = grp * hd + d;
      n1[j] = n0[j] + hd / 2;
    }
    float y0[U], y1[U];
    piece_sums(p, a.part, R, N, r, n0, ok, y0);
    piece_sums(p, a.part, R, N, r, n1, ok, y1);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      y0[j] = rnd<T>(y0[j]);
      y1[j] = rnd<T>(y1[j]);
      if (!is_v && ok[j]) rope_pair<T>(a, rr, lane + 32 * j, y0[j], y1[j]);
      if (ok[j]) amax = fmaxf(amax, fmaxf(fabsf(y0[j]), fabsf(y1[j])));
    }
    amax = warp_max(amax);
    const float sc = __fdiv_rn(amax, 127.0f);
    const float div = fmaxf(sc, 1e-30f);
    const long long at = append_row(a, g.l, rr);
    if (at < 0) continue;
    int8_t* pool = (is_v ? a.pool_v : a.pool_k) + (at * nkv + hh) * hd;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!ok[j]) continue;
      const int d = lane + 32 * j;
      pool[d] = static_cast<int8_t>(__float2int_rn(
          fminf(fmaxf(rintf(__fdiv_rn(y0[j], div)), -127.f), 127.f)));
      pool[d + hd / 2] = static_cast<int8_t>(__float2int_rn(
          fminf(fmaxf(rintf(__fdiv_rn(y1[j], div)), -127.f), 127.f)));
    }
    if (lane == 0) (is_v ? a.v_scale : a.k_scale)[at * nkv + hh] = sc;
  }
}

// a value of the model type into the pool: as it is, or an fp8 pool's
// saturating round-to-nearest-even cast (kv_cache.quantize_kv_rows_fp8)
template <typename KT>
__device__ __forceinline__ KT to_pool(float x) {
  if constexpr (std::is_same<KT, __nv_fp8_e4m3>::value) {
    KT r;
    r.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
    return r;
  } else {
    return from_f<KT>(x);
  }
}

// The epilogue of group grp of projection g (see Kind), all R rows, by the
// block that completed it; two units a thread at a time (more spill the
// GEMV loop's registers at three blocks an SM). A QKV group is heads
// [h0, h1), a unit a RoPE pair (d, d + hd/2) of a head's row.
template <typename T, int D, typename KT>
__device__ void finish_group(const Args<T, KT>& a, const Gemv<T>& g,
                             const Plan& p, int grp) {
  constexpr int NT = Geo<T>::NT, U = 2;
  const int hd = a.hd, half = hd / 2;
  const int hg = qkv_group_heads(hd, NT);
  const int h0 = grp * hg;
  int h1 = min(h0 + hg, a.nh + 2 * a.nkv);
  if constexpr (std::is_same<KT, int8_t>::value) {
    if (g.kind == kQKV) {   // the group's K and V heads, then its q heads
      for (int hh = max(h0, a.nh); hh < h1; ++hh)
        finish_kv_int8<T, D>(a, g, p, hh);
      h1 = min(h1, a.nh);
      if (h1 <= h0) return;
    }
  }
  const int R = a.R, N = g.N, tid = threadIdx.x;
  const int per_row = g.kind == kQKV ? (h1 - h0) * half : NT;   // units a row
  const int units = R * per_row;
  const int I = N / 2;
  for (int u0 = 0; u0 < units; u0 += kThreads * U) {
    int r[U], n0[U], n1[U];
    bool ok[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = u0 + j * kThreads + tid;
      ok[j] = u < units;
      r[j] = u / per_row;
      const int c = u % per_row;
      n0[j] = g.kind == kQKV ? (h0 + c / half) * hd + c % half : grp * NT + c;
      n1[j] = g.kind == kQKV ? n0[j] + half : n0[j] + I;   // the pair's other
    }
    float y0[U], y1[U];
    piece_sums(p, a.part, R, N, r, n0, ok, y0);
    if (g.kind == kQKV || g.kind == kGateUp) piece_sums(p, a.part, R, N, r, n1, ok, y1);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!ok[j]) continue;
      const int rr = r[j];
      if (g.kind == kResid) {
        T* hp = a.h + static_cast<long long>(rr) * a.H + n0[j];
        *hp = from_f<T>(rnd<T>(__fadd_rn(ldcg_f(hp), rnd<T>(y0[j]))));
      } else if (g.kind == kHead) {
        a.logits[static_cast<long long>(rr) * N + n0[j]] = rnd<T>(y0[j]);
      } else if (g.kind == kGateUp) {
        const float gv = rnd<T>(y0[j]), uv = rnd<T>(y1[j]);
        const float sv = rnd<T>(gv / (1.0f + expf(-gv)));
        a.act[static_cast<long long>(rr) * I + n0[j]] = from_f<T>(__fmul_rn(sv, uv));
      } else {
        // head `head` of q, k, v; the pair (d, d + hd/2) of row rr
        const int head = n0[j] / hd, d = n0[j] % hd, nh = a.nh, nkv = a.nkv;
        float o0 = rnd<T>(y0[j]), o1 = rnd<T>(y1[j]);
        if (head < nh + nkv) rope_pair<T>(a, rr, d, o0, o1);
        if (head < nh) {
          T* qp = a.q + (static_cast<long long>(rr) * nh + head) * hd + d;
          qp[0] = from_f<T>(o0);
          qp[half] = from_f<T>(o1);
          continue;
        }
        // append at (tables[rr][len / bs], len % bs); masked rows, rows
        // past capacity and sentinel table entries do not write
        const bool is_v = head >= nh + nkv;
        const int hh = head - nh - (is_v ? nkv : 0);
        // (an int8 pool's K and V heads took finish_kv_int8)
        if constexpr (!std::is_same<KT, int8_t>::value) {
          const long long at = append_row(a, g.l, rr);
          if (at >= 0) {
            KT* pool = (is_v ? a.pool_v : a.pool_k) + (at * nkv + hh) * hd + d;
            pool[0] = to_pool<KT>(o0);
            pool[half] = to_pool<KT>(o1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- GEMV
// This block's chunks of projection g into the partial slots, for every
// row in passes of up to kRowPass rows. Shared memory: S (Chunk) stages of
// [weights | X rows | a third part], then the accumulators. After writing
// a piece, the block takes a ticket of the group of each tile the piece
// covers (a counter in a zeroed buffer the wrapper owns); the block whose
// ticket completes a group runs its epilogue (finish_group), reading every
// block's pieces through L2, and leaves the counter 0 for the next phase.
// With int8 weights in bf16 (R8) a chunk is two tiles wide (Chunk: 64 k
// rows x 128 columns, 8 KB of int8 in 128-byte rows), its third part the
// 128 columns' scales; the int8 tile is read straight into the MMAs' A
// fragments. In fp32 the third part is the chunk's raw int8 (kKC x NT
// bytes), dequantized into the weight tile once it lands (dequant_w).
template <typename T, int D, typename KT, bool W8>
struct GemvRun {
  using Q = Geo<T>;
  using C = Chunk<T, W8>;
  static constexpr int NT = Q::NT, VEC = Q::VEC;
  static constexpr bool R8 = C::R8;
  static constexpr int CW = C::CW;    // columns a chunk: a plan tile
  static constexpr int S = C::STAGES;  // the ring's stages
  const Args<T, KT>& a;
  const Gemv<T>& g;
  unsigned char* smem;
  Plan p;
  int b, cb, ce, n, R, sp8, passes, stage;
  float* acc;

  __device__ GemvRun(const Args<T, KT>& a_, const Gemv<T>& g_,
                     unsigned char* s)
      : a(a_), g(g_), smem(s), p(g_.N, g_.K, CW) {
    b = blockIdx.x;
    cb = p.begin(b);
    ce = b < p.geff ? p.begin(b + 1) : cb;
    n = ce - cb;
    R = a.R;
    sp8 = (min(R, kRowPass) + 7) & ~7;
    passes = (R + kRowPass - 1) / kRowPass;
    stage = C::W_BYTES + sp8 * C::X_ROW + C::Q8_BYTES;
    acc = reinterpret_cast<float*>(smem + S * stage);
  }

  // the segment of the projection's columns column n0 lies in, and the
  // column's offset in it
  __device__ int segment(int n0) const {
    return n0 < g.end[0] ? 0 : n0 < g.end[1] ? 1 : 2;
  }
  __device__ int seg_col(int n0, int sg) const {
    return n0 - (sg ? g.end[sg - 1] : 0);
  }
  // NT-column tiles plan tile t holds (R8: 2, or 1 at an odd end)
  __device__ int tiles_in(int t) const {
    return min(CW, g.N - t * CW) / NT;
  }

  // int8 weights. bf16 (R8): plan tile t's 64 k rows x 128 columns of int8
  // into stage st's weight area, 16-byte copies, each 16-column chunk cc of
  // k row k at chunk cc ^ (2 (k / 2 % 4)) so that the fragment reads of
  // process() hit distinct banks; the tied head's 128 rows n x 64 k, chunk
  // cc of row n at cc ^ (n / 4 % 4); then the columns' scales. fp32: the
  // chunk's raw bytes into the stage's int8 area as [kKC][NT] (or
  // [NT][kKC]) for dequant_w.
  __device__ void issue_w8(int c, int st) const {
    const int t = c / p.nc, k0 = c % p.nc * kKC, n0 = t * CW;
    const int cols = tiles_in(t) * NT;
    int8_t* raw = reinterpret_cast<int8_t*>(
        smem + st * stage + (R8 ? 0 : Q::W_BYTES + sp8 * C::X_ROW));
    if (g.tied) {                      // `cols` rows n of kKC bytes
      constexpr int CPR = kKC / 16;
      for (int e = threadIdx.x; e < cols * CPR; e += kThreads) {
        const int row = e / CPR, cc = e % CPR;
        const int dc = R8 ? cc ^ (row >> 2 & 3) : cc;
        tc::cp_async16(raw + row * kKC + dc * 16,
                       g.q[0] + static_cast<long long>(n0 + row) * g.K + k0 + cc * 16,
                       true);
      }
    } else {                           // kKC rows k of `cols` bytes
      // a 16-column copy whose columns lie in two segments (they end at
      // multiples of the head dim: 8) or start 8 bytes past an aligned
      // address (a segment of a width 8 mod 16) goes as two 8-byte halves
      const int cpr = cols / 16;
      for (int e = threadIdx.x; e < kKC * cpr; e += kThreads) {
        const int row = e / cpr, cc = e % cpr;
        const int nc = n0 + cc * 16, sg = segment(nc), sg8 = segment(nc + 8);
        const int dc = R8 ? cc ^ ((row >> 1 & 3) << 1) : cc;
        const long long off =
            (k0 + row) * static_cast<long long>(g.ld[sg]) + seg_col(nc, sg);
        if (sg == sg8 && off % 16 == 0) {
          tc::cp_async16(raw + row * CW + dc * 16, g.q[sg] + off, true);
        } else {
          tc::cp_async8(raw + row * CW + dc * 16, g.q[sg] + off, true);
          tc::cp_async8(raw + row * CW + dc * 16 + 8,
                        g.q[sg8] + (k0 + row) * static_cast<long long>(g.ld[sg8]) +
                            seg_col(nc + 8, sg8),
                        true);
        }
      }
    }
    if constexpr (R8) {                // the columns' scales, 4 a copy
      if (threadIdx.x < cols / 4) {
        const int nc = n0 + 4 * threadIdx.x, sg = g.tied ? 0 : segment(nc);
        tc::cp_async16(r8_scales(st) + 4 * threadIdx.x,
                       g.s[sg] + (g.tied ? nc : seg_col(nc, sg)), true);
      }
    }
  }
  __device__ float* r8_scales(int st) const {
    return reinterpret_cast<float*>(smem + st * stage + C::W_BYTES +
                                    sp8 * C::X_ROW);
  }

  // int8 weights in fp32: stage st's landed chunk c into its weight tile,
  // each value round(float(q) * scale[col]) (decode.py _dq: one rounding),
  // at the place issue_w's dense copy would have put it. Group e of a
  // thread is the 16 bytes its copy e of issue_w8 brought (the same loop
  // and the same row / column split), which run() relies on.
  __device__ void dequant_w(int c, int st) const {
    static_assert(!Q::BF, "bf16 builds its fragments in registers");
    const int t = c / p.nc, n0 = t * NT;
    const int8_t* raw = reinterpret_cast<const int8_t*>(
        smem + st * stage + Q::W_BYTES + sp8 * C::X_ROW);
    T* sw = reinterpret_cast<T*>(smem + st * stage);
    // 16 values a thread at a time, written as whole 16-byte chunks of T
    if (g.tied) {                      // [NT rows n][kKC k]
      const float* sc = g.s[0] + n0;
      for (int e = threadIdx.x; e < NT * kKC / 16; e += kThreads) {
        const int row = e / (kKC / 16), k16 = e % (kKC / 16) * 16;
        float v[16];
        load16_narrow(raw + row * kKC + k16, v);
        const float f = __ldg(sc + row);
#pragma unroll
        for (int c = 0; c < 16 / VEC; ++c) {
          alignas(16) T o[VEC];
#pragma unroll
          for (int x = 0; x < VEC; ++x) o[x] = from_f<T>(__fmul_rn(v[c * VEC + x], f));
          const int cc = k16 / VEC + c;
          *reinterpret_cast<uint4*>(sw + row * kKC + ((cc ^ (row & 7)) * VEC)) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
    } else {                           // [kKC rows k][NT n]
      for (int e = threadIdx.x; e < kKC * NT / 16; e += kThreads) {
        const int row = e / (NT / 16), n16 = e % (NT / 16) * 16;
        float v[16], f[16];
        load16_narrow(raw + row * NT + n16, v);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // four columns' scales, all of one segment (segments end at
          // multiples of 8 columns)
          const int col = n0 + n16 + 4 * x, sg = segment(col);
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(
              g.s[sg] + seg_col(col, sg)));
          f[4 * x] = s4.x; f[4 * x + 1] = s4.y; f[4 * x + 2] = s4.z; f[4 * x + 3] = s4.w;
        }
#pragma unroll
        for (int c = 0; c < 16 / VEC; ++c) {
          alignas(16) T o[VEC];
#pragma unroll
          for (int x = 0; x < VEC; ++x)
            o[x] = from_f<T>(__fmul_rn(v[c * VEC + x], f[c * VEC + x]));
          *reinterpret_cast<uint4*>(sw + row * NT + (n16 / VEC + c) * VEC) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
    }
  }

  __device__ void issue(int c, int st, int r0, int rows, int rp8) const {
    if constexpr (W8)
      issue_w8(c, st);
    else
      issue_w(c, st);
    issue_x(c, st, r0, rows, rp8);
  }

  // chunk c's weights into stage st: swizzled 128-byte rows for ldmatrix
  // in bf16; the tied fp32 rows swizzled for float4 reads
  __device__ void issue_w(int c, int st) const {
    const int tid = threadIdx.x;
    const int t = c / p.nc, k0 = c % p.nc * kKC, n0 = t * NT;
    T* sw = reinterpret_cast<T*>(smem + st * stage);
    if (g.tied) {                      // NT rows n of kKC elements
      constexpr int CPR = kKC / VEC;
#pragma unroll
      for (int i = 0; i < Q::W_BYTES / 16 / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e / CPR, cc = e % CPR;
        tc::cp_async16(sw + row * kKC + (cc ^ (row & 7)) * VEC,
                       g.w[0] + static_cast<long long>(n0 + row) * g.K + k0 + cc * VEC,
                       true);
      }
    } else {                           // kKC rows k of NT elements
      // each 16-byte copy from its own segment: a tile may hold columns of
      // two (they end at multiples of the head dim, so a copy never does)
      constexpr int CPR = NT / VEC;
#pragma unroll
      for (int i = 0; i < Q::W_BYTES / 16 / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e / CPR, cc = e % CPR;
        const int nc = n0 + cc * VEC, s = segment(nc);
        const int dc = Q::BF ? (cc ^ (row & 7)) : cc;
        tc::cp_async16(sw + row * NT + dc * VEC,
                       g.w[s] + (k0 + row) * static_cast<long long>(g.ld[s]) +
                           seg_col(nc, s),
                       true);
      }
    }
  }

  // chunk c's X rows r0 .. r0 + rp8 into stage st (rows past R zero-filled)
  __device__ void issue_x(int c, int st, int r0, int rows, int rp8) const {
    const int k0 = c % p.nc * kKC;
    T* sx = reinterpret_cast<T*>(smem + st * stage + C::W_BYTES);
    constexpr int XC = kKC / VEC;
    for (int e = threadIdx.x; e < rp8 * XC; e += kThreads) {
      const int row = e / XC, cc = e % XC;
      const bool ok = row < rows;
      const int dc = Q::BF ? (cc ^ (row & 7)) : cc;
      tc::cp_async16(sx + row * kKC + dc * VEC,
                     ok ? g.X + static_cast<long long>(r0 + row) * g.ldx + k0 + cc * VEC
                        : g.X,
                     ok);
    }
  }

  // an NT-column tile's group and the pieces the group holds (see Kind);
  // a tile's pieces are those of the plan tile holding it
  __device__ int group_tiles() const {
    return g.kind == kQKV ? qkv_group_heads(a.hd, NT) * a.hd / NT : 1;
  }
  __device__ int group_of(int t) const {
    return g.kind == kQKV ? t / group_tiles()
         : g.kind == kGateUp ? t % (g.N / NT / 2) : t;
  }
  __device__ int tile_pieces(int t) const { return p.pieces(t * NT / CW); }
  __device__ int group_pieces(int grp) const {
    if (g.kind == kGateUp)
      return tile_pieces(grp) + tile_pieces(grp + g.N / NT / 2);
    const int gt = group_tiles();
    int s = 0;
    for (int t = grp * gt; t < min((grp + 1) * gt, g.N / NT); ++t)
      s += tile_pieces(t);
    return s;
  }

  // R8: the int8 value in byte `sel & 3` of w (a read XORed with
  // 0x80808080, so each byte holds q + 128) as a float, exactly: the byte
  // under the exponent of 2^23, less 2^23 + 128 (no int-to-float convert)
  __device__ static float i8f(unsigned w, unsigned sel) {
    return __fadd_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, sel)),
                     -8388736.0f);
  }
  __device__ static uint32_t dq2(unsigned wlo, unsigned slo, unsigned whi,
                                 unsigned shi, float s) {
    return tc::pack_bf16(__fmul_rn(i8f(wlo, slo), s), __fmul_rn(i8f(whi, shi), s));
  }

  // R8: this warp's A fragments of k-step ks for its two 16-column MMA
  // tiles m (af[m]). Warp w owns columns 32w .. 32w+31 of the plan tile; a
  // thread's four are cb4 .. cb4+3 (cb4 = 32w + 4 (lane / 4)): fragment
  // row i (< 8) of tile m is column cb4 + 2m, row i + 8 is cb4 + 2m + 1.
  // So one 32-bit read of a k row gives a thread all its columns, the four
  // reads of a k-step at fixed offsets from its base (a row's swizzle
  // 2 (k / 2 % 4) is 2 (lane % 4) for each). The tied head's rows cb4 ..
  // cb4+3 give a k pair a 16-bit read. Each value is round(float(q) *
  // scale[col]), _dq's bits.
  __device__ void r8_frag(uint32_t (&af)[2][4], const unsigned char* base,
                          int ks, const float4& s) const {
    const float sc[4] = {s.x, s.y, s.z, s.w};
    if (g.tied) {                      // [n][kKC k]: rows cb4 .. cb4+3
      auto rd = [](const unsigned char* q) -> unsigned {
        return *reinterpret_cast<const uint16_t*>(q) ^ 0x8080u;
      };
      const unsigned char* q = base + (((ks ^ (threadIdx.x >> 2)) & 3) << 4);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned x0 = rd(q + 2 * m * kKC), x1 = rd(q + (2 * m + 1) * kKC);
        const unsigned x2 = rd(q + 2 * m * kKC + 8);
        const unsigned x3 = rd(q + (2 * m + 1) * kKC + 8);
        af[m][0] = dq2(x0, 0x7440u, x0, 0x7441u, sc[2 * m]);
        af[m][1] = dq2(x1, 0x7440u, x1, 0x7441u, sc[2 * m + 1]);
        af[m][2] = dq2(x2, 0x7440u, x2, 0x7441u, sc[2 * m]);
        af[m][3] = dq2(x3, 0x7440u, x3, 0x7441u, sc[2 * m + 1]);
      }
    } else {                           // [kKC k][CW n]: k rows 2 (lane % 4) ..
      auto rd = [](const unsigned char* q) -> unsigned {
        return *reinterpret_cast<const uint32_t*>(q) ^ 0x80808080u;
      };
      const unsigned char* q = base + 16 * CW * ks;
      const unsigned x0 = rd(q), x1 = rd(q + CW);
      const unsigned x2 = rd(q + 8 * CW), x3 = rd(q + 9 * CW);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned b0 = 0x7440u + 2 * m, b1 = b0 + 1;   // bytes 2m, 2m + 1
        af[m][0] = dq2(x0, b0, x1, b0, sc[2 * m]);
        af[m][1] = dq2(x0, b1, x1, b1, sc[2 * m + 1]);
        af[m][2] = dq2(x2, b0, x3, b0, sc[2 * m]);
        af[m][3] = dq2(x2, b1, x3, b1, sc[2 * m + 1]);
      }
    }
  }

  // chunk c from stage st into the accumulators; a piece's last chunk
  // writes the piece to its slot and takes its tiles' group tickets
  __device__ void process(int c, int st, int r0, int rows, int rp8) const {
    __shared__ int s_done[CW / NT];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t = c / p.nc, kc = c % p.nc;
    const bool first = c == cb || kc == 0;
    const bool last = c == ce - 1 || kc == p.nc - 1;
    const T* sw = reinterpret_cast<const T*>(smem + st * stage);
    const T* sx = reinterpret_cast<const T*>(smem + st * stage + C::W_BYTES);
    float* dst = a.part + static_cast<long long>(b - p.first(t)) * R * g.N;
    if constexpr (R8) {
      // two k-steps at a time: their A fragments for this warp's two MMA
      // tiles, converted once, then every 8-row tile of X (its running
      // sums in the accumulator slots); a warp past an odd end's one tile
      // has no columns
      const int tq = lane & 3, cb4 = 32 * warp + 4 * (lane >> 2);
      if (cb4 < tiles_in(t) * NT) {
        const float4 s4 = *reinterpret_cast<const float4*>(r8_scales(st) + cb4);
        const unsigned char* raw = smem + st * stage;
        // the thread's first byte: k row 2 tq at column cb4 (16-byte chunk
        // cb4 / 16 at cb4 / 16 ^ 2 tq), or the tied head's row cb4 at k 2 tq
        const unsigned char* base =
            g.tied ? raw + cb4 * kKC + 2 * tq
                   : raw + 2 * tq * CW + (((cb4 >> 4) ^ (2 * tq)) << 4) + (cb4 & 15);
        float4* acc4 = reinterpret_cast<float4*>(acc);
        const int col = t * CW + cb4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t af0[2][4], af1[2][4];
          r8_frag(af0, base, 2 * j, s4);
          r8_frag(af1, base, 2 * j + 1, s4);
          for (int rt = 0; rt < rp8 / 8; ++rt) {
            float cf[2][4];
            float4* slot = acc4 + ((rt * kWarps + warp) * 2) * 32 + lane;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float4 v = first && j == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                               : slot[32 * m];
              cf[m][0] = v.x; cf[m][1] = v.y; cf[m][2] = v.z; cf[m][3] = v.w;
            }
            // B fragments: rows 8rt .. 8rt+7, k-steps 2j and 2j + 1
            uint32_t bf[4];
            tc::ldsm_x4(bf, sx + sw128(8 * rt + (lane & 7), 4 * j + (lane >> 3)));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              tc::mma(cf[m], af0[m], bf[0], bf[1]);
              tc::mma(cf[m], af1[m], bf[2], bf[3]);
            }
            if (last && j == 1) {   // C: columns col .. col + 3; rows r, r + 1
              const int r = r0 + 8 * rt + 2 * tq;
              if (r < R)
                *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * g.N + col) =
                    make_float4(cf[0][0], cf[0][2], cf[1][0], cf[1][2]);
              if (r + 1 < R)
                *reinterpret_cast<float4*>(dst + static_cast<long long>(r + 1) * g.N + col) =
                    make_float4(cf[0][1], cf[0][3], cf[1][1], cf[1][3]);
            } else {
#pragma unroll
              for (int m = 0; m < 2; ++m)
                slot[32 * m] = make_float4(cf[m][0], cf[m][1], cf[m][2], cf[m][3]);
            }
          }
        }
      }
    } else if constexpr (Q::BF) {
      // A fragments of this warp's 16 columns, the chunk's 4 k-steps
      uint32_t af[4][4];
      const int m = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (g.tied)
          tc::ldsm_x4(af[ks], sw + sw128(16 * warp + (lane & 15), 2 * ks + (lane >> 4)));
        else
          tc::ldsm_x4_t(af[ks], sw + sw128(16 * ks + (lane & 7) + ((m >> 1) << 3),
                                           2 * warp + (m & 1)));
      }
      float4* acc4 = reinterpret_cast<float4*>(acc);
      const int col = t * NT + 16 * warp + (lane >> 2);
      for (int rt = 0; rt < rp8 / 8; ++rt) {
        float cf[4] = {0.f, 0.f, 0.f, 0.f};
        float4& slot = acc4[(rt * kWarps + warp) * 32 + lane];
        if (!first) {
          const float4 v = slot;
          cf[0] = v.x; cf[1] = v.y; cf[2] = v.z; cf[3] = v.w;
        }
        // B fragments: rows 8rt .. 8rt+7, k-steps 0-1 and 2-3
        uint32_t b0[4], b1[4];
        tc::ldsm_x4(b0, sx + sw128(8 * rt + (lane & 7), lane >> 3));
        tc::ldsm_x4(b1, sx + sw128(8 * rt + (lane & 7), 4 + (lane >> 3)));
        tc::mma(cf, af[0], b0[0], b0[1]);
        tc::mma(cf, af[1], b0[2], b0[3]);
        tc::mma(cf, af[2], b1[0], b1[1]);
        tc::mma(cf, af[3], b1[2], b1[3]);
        if (last) {   // C: columns col, col + 8; rows r, r + 1
          const int r = r0 + 8 * rt + 2 * (lane & 3);
          if (r < R) {
            dst[static_cast<long long>(r) * g.N + col] = cf[0];
            dst[static_cast<long long>(r) * g.N + col + 8] = cf[2];
          }
          if (r + 1 < R) {
            dst[static_cast<long long>(r + 1) * g.N + col] = cf[1];
            dst[static_cast<long long>(r + 1) * g.N + col + 8] = cf[3];
          }
        } else {
          slot = make_float4(cf[0], cf[1], cf[2], cf[3]);
        }
      }
    } else {
      // the lane's column at this warp's 16 k rows
      const int kq = warp * 16;
      float wk[16];
      if (g.tied) {
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float4 v = *reinterpret_cast<const float4*>(
              sw + lane * kKC + ((((kq >> 2) + q4) ^ (lane & 7)) << 2));
          wk[4 * q4] = v.x; wk[4 * q4 + 1] = v.y;
          wk[4 * q4 + 2] = v.z; wk[4 * q4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) wk[j] = sw[(kq + j) * NT + lane];
      }
      for (int r = 0; r < rows; ++r) {
        float& sacc = acc[(warp * sp8 + r) * 32 + lane];
        float s = first ? 0.f : sacc;
        const float* xr = sx + r * kKC + kq;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * q4);
          s = fmaf(xv.x, wk[4 * q4], s);
          s = fmaf(xv.y, wk[4 * q4 + 1], s);
          s = fmaf(xv.z, wk[4 * q4 + 2], s);
          s = fmaf(xv.w, wk[4 * q4 + 3], s);
        }
        sacc = s;
      }
      if (last) {   // the four warps' k ranges, added in warp order
        __syncthreads();
        for (int e = tid; e < rows * 32; e += kThreads) {
          const int r = e >> 5, cl = e & 31;
          float s = acc[r * 32 + cl];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) s += acc[(w * sp8 + r) * 32 + cl];
          dst[static_cast<long long>(r0 + r) * g.N + t * NT + cl] = s;
        }
      }
    }
    if (!last) return;
    // the piece is out: take the ticket of each of its tiles' groups in one
    // round (the block's writes are ordered before thread 0's fence by the
    // barrier; a group both tiles belong to takes two, the second of which
    // may complete it)
    const int nt = tiles_in(t);
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      for (int u = 0; u < nt; ++u) {
        const int grp = group_of(t * (CW / NT) + u);
        s_done[u] = atomicAdd(a.gtickets + grp, 1) == passes * group_pieces(grp) - 1;
      }
    }
    __syncthreads();
    for (int u = 0; u < nt; ++u) {
      if (!s_done[u]) continue;
      const int grp = group_of(t * (CW / NT) + u);
      __threadfence();
      finish_group<T, D>(a, g, p, grp);
      if (tid == 0) a.gtickets[grp] = 0;   // ready for the next phase
    }
  }

  // the ring: S - 1 chunks in flight ahead of the one in use (empty groups
  // past the end keep the wait count uniform)
  __device__ void run() const {
    for (int r0 = 0; r0 < R && n > 0; r0 += kRowPass) {
      const int rows = min(kRowPass, R - r0), rp8 = (rows + 7) & ~7;
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        if (s < n) issue(cb + s, s, r0, rows, rp8);
        tc::cp_async_commit();
      }
      for (int i = 0; i < n; ++i) {
        tc::cp_async_wait<S - 2>();   // chunk i has landed
        // int8 weights in fp32: each thread dequantizes the very bytes it
        // copied (dequant_w walks issue_w8's copies in the same order), so
        // its own wait suffices and the one barrier below publishes the tile
        if constexpr (W8 && !R8) dequant_w(cb + i, i % S);
        __syncthreads();                     // ... for every thread; i-1 read
        if (i + S - 1 < n) {
          const int c = cb + i + S - 1, st = (i + S - 1) % S;
          issue(c, st, r0, rows, rp8);
        }
        tc::cp_async_commit();
        process(cb + i, i % S, r0, rows, rp8);
      }
      tc::cp_async_wait<0>();
      __syncthreads();
    }
  }
};

// ---------------------------------------------------------------- rows
// Block-per-row phase: hn = round(round(h * rsqrt(mean(h^2) + eps)) * w),
// h gathered from the embedding first at layer 0 (embed); 16-byte loads.
template <typename T, typename KT>
__device__ void row_phase(const Args<T, KT>& a, int r, bool embed, const T* w,
                          float* smem) {
  constexpr int VEC = Geo<T>::VEC;
  const int H = a.H;
  T* hrow = a.h + static_cast<long long>(r) * H;
  const T* erow = a.embed + a.tok[r] * static_cast<long long>(H);
  float ss = 0.f;
#pragma unroll 4
  for (int c = threadIdx.x * VEC; c < H; c += kThreads * VEC) {
    float v[VEC];
    if (embed) {
      load16(erow + c, v);
      *reinterpret_cast<uint4*>(hrow + c) = *reinterpret_cast<const uint4*>(erow + c);
    } else {
      load16_cg(hrow + c, v);
    }
#pragma unroll
    for (int x = 0; x < VEC; ++x) ss = fmaf(v[x], v[x], ss);
  }
  const float total = block_sum(ss, smem);
  const float rs = rsqrtf(__fadd_rn(total / static_cast<float>(H), a.eps));
  T* hnrow = a.hn + static_cast<long long>(r) * H;
#pragma unroll 4
  for (int c = threadIdx.x * VEC; c < H; c += kThreads * VEC) {
    float v[VEC], wv[VEC];
    if (embed)
      load16(erow + c, v);
    else
      load16_cg(hrow + c, v);
    load16(w + c, wv);
    alignas(16) T o[VEC];
#pragma unroll
    for (int x = 0; x < VEC; ++x) o[x] = from_f<T>(__fmul_rn(rnd<T>(__fmul_rn(v[x], rs)), wv[x]));
    *reinterpret_cast<uint4*>(hnrow + c) = *reinterpret_cast<const uint4*>(o);
  }
}

// ----------------------------------------------------------- attention
// Item (split, KV head, row) of the split-KV walk over layer l's pool:
// paged_decode.cu's row, length and key_off, so the same bits. Items are
// numbered split-major from the last split down, so the splits only long
// rows have come first and the short rows' splits fill the tail.
template <typename T, int D, typename KT, int QM>
__device__ void attn_item(const Args<T, KT>& a, int l, int it,
                          unsigned char* smem, float scale) {
  const int ns = a.n_split, nkv = a.nkv, G = a.nh / nkv, R = a.R, hd = a.hd;
  const int split = ns - 1 - it / (nkv * R), kvh = it / R % nkv, r = it % R;
  const long long qo = (static_cast<long long>(r) * a.nh + kvh * G) * hd;
  const int len = min(max(a.meta[r] + a.meta[R + r], 0), a.mb * a.bs);
  const int* row_tbl = a.tables + static_cast<long long>(r) * a.mb;
  const long long kv_row = static_cast<long long>(nkv) * hd;
  const int nb = a.nb, bs = a.bs;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * hd;
  };
  const long long layer_off = static_cast<long long>(l) * nb * bs * kv_row;
  // a quantized pool's planes of layer l: [nb, bs, nkv] (int8) or [nb,
  // nkv] (fp8), key p's scale as paged_decode.cu reads it
  const long long s_layer = static_cast<long long>(l) * nb * (QM == 2 ? 1 : bs) * nkv;
  auto scale_off = [&](int p) -> long long {
    const long long phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return QM == 2 ? phys * nkv + kvh : (phys * bs + p % bs) * nkv + kvh;
  };
  const Scales<QM, decltype(scale_off)> sc{
      QM ? a.k_scale + s_layer : nullptr, QM ? a.v_scale + s_layer : nullptr,
      scale_off};
  // as few accumulator registers as the KV head's G * D needs
#define PT_WALK(NACC)                                                        \
  skv::split_kv_walk<T, D, NACC>(a.q, a.pool_k + layer_off,                 \
                                 a.pool_v + layer_off, a.attn, a.part_m,    \
                                 a.part_l, a.part_acc, a.tickets, smem, qo, \
                                 len, key_off, sc, G, hd, r, kvh, nkv,      \
                                 split, a.split_len, ns, scale)
  // (with_nacc's rule: one register only where D itself fits kThreads)
  if constexpr (D <= kThreads) {
    if (G * D <= kThreads) {
      PT_WALK(1);
      return;
    }
  }
  if (G * D <= 4 * kThreads)
    PT_WALK(4);
  else
    PT_WALK(skv::kMaxAcc);
#undef PT_WALK
}

// The attention phase: blocks take items from a shared counter (the
// walks differ in length by the row's keys), which block 0 resets after
// the phase's barrier.
template <typename T, int D, typename KT, int QM>
__device__ void attn_phase(const Args<T, KT>& a, int l, unsigned char* smem,
                           float scale) {
  __shared__ int s_item;
  const int n_items = a.n_split * a.nkv * a.R;
  for (;;) {
    __syncthreads();   // the previous item is done with the shared ring
    if (threadIdx.x == 0) s_item = static_cast<int>(atomicAdd(a.queue, 1u));
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) return;
    attn_item<T, D, KT, QM>(a, l, it, smem, scale);
  }
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


template <typename T, typename KT>
__device__ void sample_row(const Args<T, KT>& a, int r, float* smem) {
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
template <typename T, int D, typename KT, int QM, bool W8>
__global__ void __launch_bounds__(kThreads, 3)
fused_tick_kernel(Args<T, KT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  unsigned gen = 0u;
  if (threadIdx.x == 0) gen = *reinterpret_cast<volatile unsigned*>(&a.bar[1]);
  const int nblk = gridDim.x, b0 = blockIdx.x;
  const int H = a.H, R = a.R, I = a.I, nh = a.nh, nkv = a.nkv, V = a.V;
  const int hd = a.hd;
  const int nq = (nh + 2 * nkv) * hd;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  constexpr bool w8 = W8;
  // weight w (0 wq .. 6 wd, 7 the head) of layer l at element offset off:
  // the dense array, or the int8 one and its scales (offset soff)
  auto dense = [&](const T* base, long long off) -> const T* {
    return w8 ? nullptr : base + off;
  };
  auto q8 = [&](int w, long long off) -> const int8_t* {
    return w8 ? a.q8[w] + off : nullptr;
  };
  auto s8 = [&](int w, long long soff) -> const float* {
    return w8 ? a.s8[w] + soff : nullptr;
  };
  const Gemv<T> head{a.hn, H, H, V, {dense(a.head, 0), nullptr, nullptr},
                     {V, V, V}, {V, V, V}, a.tied != 0, kHead, 0,
                     {q8(7, 0), nullptr, nullptr}, {s8(7, 0), nullptr, nullptr}};
  for (int r = b0; r < R; r += nblk) row_phase(a, r, true, a.in_ln, smem);
  grid_sync(a.bar, gen);
  for (int l = 0; l < a.L; ++l) {
    const long long lh = static_cast<long long>(l) * H;
    const long long lo = static_cast<long long>(l) * nh * hd * H;
    const long long ld = static_cast<long long>(l) * I * H;
    const Gemv<T> qkv{a.hn, H, H, nq,
                      {dense(a.wq, lh * nh * hd), dense(a.wk, lh * nkv * hd),
                       dense(a.wv, lh * nkv * hd)},
                      {nh * hd, nkv * hd, nkv * hd},
                      {nh * hd, (nh + nkv) * hd, nq}, false, kQKV, l,
                      {q8(0, lh * nh * hd), q8(1, lh * nkv * hd),
                       q8(2, lh * nkv * hd)},
                      {s8(0, l * nh * hd), s8(1, l * nkv * hd),
                       s8(2, l * nkv * hd)}};
    const Gemv<T> o{a.attn, nh * hd, nh * hd, H, {dense(a.wo, lo), nullptr, nullptr},
                    {H, H, H}, {H, H, H}, false, kResid, l,
                    {q8(3, lo), nullptr, nullptr}, {s8(3, lh), nullptr, nullptr}};
    const Gemv<T> gu{a.hn, H, H, 2 * I,
                     {dense(a.wg, lh * I), dense(a.wu, lh * I), nullptr},
                     {I, I, I}, {I, 2 * I, 2 * I}, false, kGateUp, l,
                     {q8(4, lh * I), q8(5, lh * I), nullptr},
                     {s8(4, static_cast<long long>(l) * I),
                      s8(5, static_cast<long long>(l) * I), nullptr}};
    const Gemv<T> down{a.act, I, I, H, {dense(a.wd, ld), nullptr, nullptr},
                       {H, H, H}, {H, H, H}, false, kResid, l,
                       {q8(6, ld), nullptr, nullptr}, {s8(6, lh), nullptr, nullptr}};
    GemvRun<T, D, KT, W8>(a, qkv, smem_raw).run();
    grid_sync(a.bar, gen);
    attn_phase<T, D, KT, QM>(a, l, smem_raw, scale);
    grid_sync(a.bar, gen);
    if (b0 == 0 && threadIdx.x == 0) *a.queue = 0u;   // every block is past it
    GemvRun<T, D, KT, W8>(a, o, smem_raw).run();
    grid_sync(a.bar, gen);
    for (int r = b0; r < R; r += nblk)
      row_phase(a, r, false, a.post_ln + lh, smem);
    grid_sync(a.bar, gen);
    GemvRun<T, D, KT, W8>(a, gu, smem_raw).run();
    grid_sync(a.bar, gen);
    GemvRun<T, D, KT, W8>(a, down, smem_raw).run();
    grid_sync(a.bar, gen);
    const T* next_w = l + 1 < a.L ? a.in_ln + lh + H : a.final_norm;
    for (int r = b0; r < R; r += nblk) row_phase(a, r, false, next_w, smem);
    grid_sync(a.bar, gen);
  }
  GemvRun<T, D, KT, W8>(a, head, smem_raw).run();
  grid_sync(a.bar, gen);
  for (int r = b0; r < R; r += nblk) sample_row(a, r, smem);
}

// Dynamic shared memory of a launch: the GEMV ring (GemvRun's stages:
// Chunk's weights, X rows and fp32's raw int8 area) and accumulators for
// min(R, kRowPass) rows, the split-KV walk's ring for G heads a KV head,
// or the sampler's histogram, whichever is largest.
template <typename T, int D, typename KT, bool W8>
size_t smem_bytes(int R, int G) {
  using C = Chunk<T, W8>;
  const size_t sp8 = (std::min(R, kRowPass) + 7) & ~7;
  const size_t gemv = C::STAGES * (C::W_BYTES + sp8 * C::X_ROW + C::Q8_BYTES) +
                      sp8 * C::ACC_ROW;
  const size_t walk = skv::walk_smem_bytes<T, D, KT>(G);
  const size_t sample = (2 * kWarps + 256 + 3) * sizeof(float);
  return std::max(std::max(gemv, walk), sample);
}

template <typename T, int D, typename KT, int QM, bool W8>
cudaError_t launch(Args<T, KT> a, int max_blocks_per_sm, cudaStream_t stream,
                   int* grid_out) {
  auto kernel = fused_tick_kernel<T, D, KT, QM, W8>;
  const size_t smem = smem_bytes<T, D, KT, W8>(a.R, a.nh / a.nkv);
  cudaError_t err = tc::use_smem(kernel, smem);
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
  if (max_blocks_per_sm > 0) per_sm = std::min(per_sm, max_blocks_per_sm);
  const int grid = per_sm * sms;
  if (grid_out) *grid_out = grid;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


template <typename T, typename KT, int QM, bool W8>
cudaError_t dispatch(int D, void** p, const int* n, float eps,
                            int max_blocks_per_sm, cudaStream_t stream,
                            int* grid_out) {
  pt::ft::Args<T, KT> a;
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
  a.pool_k = static_cast<KT*>(p[13]);
  a.pool_v = static_cast<KT*>(p[14]);
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
  a.queue = a.bar + 2;
  a.gtickets = reinterpret_cast<int*>(a.bar + 3);
  a.part_m = static_cast<float*>(p[30]);
  a.part_l = static_cast<float*>(p[31]);
  a.part_acc = static_cast<float*>(p[32]);
  a.tickets = static_cast<int*>(p[33]);
  a.k_scale = static_cast<float*>(p[34]);
  a.v_scale = static_cast<float*>(p[35]);
  // with int8 weights the weight slots (p[2] .. p[8], p[12]) hold the
  // int8 arrays, and p[36] .. p[43] their scales
  const int wslot[8] = {2, 3, 4, 5, 6, 7, 8, 12};
  for (int i = 0; i < 8; ++i) {
    a.q8[i] = static_cast<const int8_t*>(p[wslot[i]]);
    a.s8[i] = static_cast<const float*>(p[36 + i]);
  }
  a.R = n[0]; a.L = n[1]; a.H = n[2]; a.nh = n[3]; a.nkv = n[4];
  a.I = n[5]; a.V = n[6]; a.nb = n[7]; a.bs = n[8]; a.mb = n[9];
  a.s_rows = n[10]; a.tied = n[11]; a.split_len = n[12]; a.n_split = n[13];
  a.hd = D;
  a.eps = eps;
  return with_head_dim(D, [&](auto dp) {
    return pt::ft::launch<T, decltype(dp)::value, KT, QM, W8>(
        a, max_blocks_per_sm, stream, grid_out);
  });
}

// the pool type of MODE: the model's type T (0), int8 (1) or e4m3 (2)
template <typename T, int MODE>
using PoolT = typename std::conditional<
    MODE == 0, T,
    typename std::conditional<MODE == 1, int8_t, __nv_fp8_e4m3>::type>::type;

// The 34 pointers in Args order (tok ... bar, then the split-KV walk's
// part_m, part_l, part_acc and tickets), then k_scale and v_scale (null
// unless the pool is quantized) and the 8 weight scales (null unless w8);
// ints R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied, split_len,
// n_split, then D and is_bf16; eps; MODE is the pool (0 the model type, 1
// int8 with per-row planes, 2 e4m3 with per-block planes) and W8 says the
// weight slots hold int8 arrays [L, K, N] and the head's, with float32
// scales [L, N] and [V]; a cap on blocks per SM (0 = as many as fit);
// grid_out receives the launched grid size. D % 8 == 0, 8 <= D <= 256;
// H, I, V and the QKV width (nh + 2 nkv) * D must be multiples of 64 (the
// wrapper checks); part holds the GEMV pieces
// (kernels/fused_decode_tick.py sizes it for the largest grid the cap
// allows).
template <int MODE, bool W8>
int fused_tick_entry(
    void* tok, void* embed, void* wq, void* wk, void* wv, void* wo, void* wg,
    void* wu, void* wd, void* in_ln, void* post_ln, void* final_norm,
    void* head, void* pool_k, void* pool_v, void* sin, void* cos,
    void* tables, void* meta, void* keys_in, void* h, void* hn, void* q,
    void* attn, void* act, void* part, void* logits, void* nxt,
    void* keys_out, void* bar, void* part_m, void* part_l, void* part_acc,
    void* tickets, void* k_scale, void* v_scale, void* sq, void* sk,
    void* sv, void* so, void* sg, void* su, void* sd, void* shead, int R,
    int L, int H, int nh, int nkv, int I, int V, int nb, int bs, int mb,
    int s_rows, int tied, int split_len, int n_split, int D, int is_bf16,
    float eps, int max_blocks_per_sm, void* grid_out, void* stream) {
  void* p[44] = {tok, embed, wq, wk, wv, wo, wg, wu, wd, in_ln, post_ln,
                 final_norm, head, pool_k, pool_v, sin, cos, tables, meta,
                 keys_in, h, hn, q, attn, act, part, logits, nxt, keys_out,
                 bar, part_m, part_l, part_acc, tickets, k_scale, v_scale,
                 sq, sk, sv, so, sg, su, sd, shead};
  const int n[14] = {R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied,
                     split_len, n_split};
  if (R < 1 || H % 64 || I % 64 || V % 64 || (nh + 2 * nkv) * D % 64 ||
      pt::skv::bad_split_args(nh, nkv, D, mb * bs, split_len, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((MODE != 0) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 36; i < 44; ++i)
    if (W8 != (p[i] != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* g = static_cast<int*>(grid_out);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16, PoolT<__nv_bfloat16, MODE>, MODE, W8>(
                    D, p, n, eps, max_blocks_per_sm, s, g)
              : dispatch<float, PoolT<float, MODE>, MODE, W8>(
                    D, p, n, eps, max_blocks_per_sm, s, g);
  return static_cast<int>(err);
}

}  // namespace ft
}  // namespace pt
