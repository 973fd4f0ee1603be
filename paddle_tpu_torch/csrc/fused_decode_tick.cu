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
//     of weight), numbered tile-major. Block b streams the chunks
//     [b*C/G, (b+1)*C/G): every block gets the same share of bytes whatever
//     the projection's shape (split-K where a phase has fewer tiles than
//     blocks, several tiles a block where it has more). Chunks arrive by
//     16-byte cp.async into a kStages-deep ring, the chunk's X rows beside
//     its weights: 3 chunks (24 KB of weight) in flight a block, ~72 KB an
//     SM.
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
//     takes a ticket of the tile's group (a QKV head: its D / NT tiles; a
//     gate tile and its up tile; else one tile). The block that completes
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
// Rounding follows the scanned tick (serving/decode.py:_fused_decode_tick):
// RMSNorm casts to the model type before the weight multiply, every
// projection output is rounded to the model type, RoPE is computed in
// float32 and rounded, residual adds happen in the model type; so in fp32
// the two differ only in summation order. Products and sums that PyTorch
// runs as separate ops use __fmul_rn/__fadd_rn so no FMA contracts them.
// Data written by other blocks in this launch is read through L2
// (__ldcg, cp.async.cg), never the SM's L1.
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

// GEMV geometry by type: a chunk is 8 KB of weight either way
template <typename T>
struct Geo {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VEC = 16 / sizeof(T);            // elements a 16-byte copy
  static constexpr int NT = BF ? 64 : 32;               // output columns a tile
  static constexpr int W_BYTES = kKC * NT * sizeof(T);  // a chunk's weights
  static constexpr int X_ROW = kKC * sizeof(T);         // a chunk's X, a row
  // accumulator bytes a row: NT fp32 (bf16), or 32 columns x 4 warps (fp32)
  static constexpr int ACC_ROW = BF ? 256 : 512;
  static_assert(W_BYTES == 8192 && W_BYTES / 16 % kThreads == 0,
                "every thread copies the same count");
};

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
  float* part;                      // GEMV pieces [slots, R, N]
  float* logits;                    // [R, V]
  long long* nxt;                   // [R]
  unsigned* keys_out;               // [R, 2]
  unsigned* bar;                    // [2]: arrivals, generation
  unsigned* queue;                  // the attention items' counter (bar[2])
  int* gtickets;                    // the GEMV groups' tickets (bar[3 ..])
  float* part_m; float* part_l;     // the walk's partials [R, Hkv, n_split, G]
  float* part_acc;                  // ... and [R, Hkv, n_split, G, D]
  int* tickets;                     // [>= R * Hkv], zero, left zero
  int R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied, split_len, n_split;
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
// A projection of N columns over K is (N / nt) tiles x (K / kKC) chunks,
// numbered tile-major. The first geff = min(grid, C) blocks stream the
// chunks [begin(b), begin(b + 1)) each; the rest sit the phase out. Block
// b's share of a tile is a piece, written to partial slot b - first(the
// tile); a tile's pieces are added in slot order.
struct Plan {
  int C, nc, geff, nt;   // C * geff < 2^31 at every geometry the wrapper takes
  __device__ Plan(int N, int K, int nt_)
      : C(N / nt_ * (K / kKC)), nc(K / kKC), nt(nt_) {
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
//   kQKV     a head's D columns (D / NT tiles): RoPE for q and k, q to the
//            query buffer, k and v appended to the pool
//   kResid   one tile of O or down: h = round(h + round(sum))
//   kGateUp  gate tile g and up tile g + I / NT: act = round(round(SiLU(g))
//            * u)
//   kHead    one tile of the lm head: the logits, rounded to the model type
enum Kind { kQKV, kResid, kGateUp, kHead };

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

// The epilogue of group grp of projection g (see Kind), all R rows, by the
// block that completed it; two units a thread at a time (more spill the
// GEMV loop's registers at three blocks an SM).
template <typename T, int D>
__device__ void finish_group(const Args<T>& a, const Gemv<T>& g,
                             const Plan& p, int grp) {
  constexpr int NT = Geo<T>::NT, U = 2;
  const int R = a.R, N = g.N, tid = threadIdx.x;
  const int per_row = g.kind == kQKV ? D / 2 : NT;   // units a row
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
      n0[j] = g.kind == kQKV ? grp * D + c : grp * NT + c;
      n1[j] = g.kind == kQKV ? n0[j] + D / 2 : n0[j] + I;   // the pair's other
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
        // head grp of q, k, v; the pair (d, d + D/2) of row rr
        const int d = n0[j] - grp * D, nh = a.nh, nkv = a.nkv;
        float o0 = rnd<T>(y0[j]), o1 = rnd<T>(y1[j]);
        const int len = a.meta[rr];
        if (grp < nh + nkv) {   // RoPE at the row's length (rotate_half)
          const float* cs = a.cos + min(max(len, 0), a.s_rows - 1) * D;
          const float* sn = a.sin + min(max(len, 0), a.s_rows - 1) * D;
          const float x0 = o0, x1 = o1;
          o0 = rnd<T>(__fadd_rn(__fmul_rn(x0, cs[d]), __fmul_rn(-x1, sn[d])));
          o1 = rnd<T>(__fadd_rn(__fmul_rn(x1, cs[d + D / 2]),
                                __fmul_rn(x0, sn[d + D / 2])));
        }
        if (grp < nh) {
          T* qp = a.q + (static_cast<long long>(rr) * nh + grp) * D + d;
          qp[0] = from_f<T>(o0);
          qp[D / 2] = from_f<T>(o1);
          continue;
        }
        // append at (tables[rr][len / bs], len % bs); masked rows, rows
        // past capacity and sentinel table entries do not write
        const bool is_v = grp >= nh + nkv;
        const int hh = grp - nh - (is_v ? nkv : 0);
        const int phys = a.tables[rr * a.mb + min(max(len, 0) / a.bs, a.mb - 1)];
        if (a.meta[R + rr] > 0 && len >= 0 && len < a.mb * a.bs && phys >= 0 &&
            phys < a.nb) {
          T* pool = (is_v ? a.pool_v : a.pool_k) +
                    ((static_cast<long long>(g.l) * a.nb + phys) * a.bs + len % a.bs) *
                        nkv * D +
                    hh * D + d;
          pool[0] = from_f<T>(o0);
          pool[D / 2] = from_f<T>(o1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- GEMV
// This block's chunks of projection g into the partial slots, for every
// row in passes of up to kRowPass rows. Shared memory: kStages stages of
// [weights | X rows], then the accumulators. After writing a piece, the
// block takes a ticket of the piece's group (a counter in a zeroed buffer
// the wrapper owns); the block whose ticket completes the group runs its
// epilogue (finish_group), reading every block's pieces through L2, and
// leaves the counter 0 for the next phase.
template <typename T, int D>
struct GemvRun {
  using Q = Geo<T>;
  static constexpr int NT = Q::NT, VEC = Q::VEC;
  const Args<T>& a;
  const Gemv<T>& g;
  unsigned char* smem;
  Plan p;
  int b, cb, ce, n, R, sp8, passes, stage;
  float* acc;

  __device__ GemvRun(const Args<T>& a_, const Gemv<T>& g_, unsigned char* s)
      : a(a_), g(g_), smem(s), p(g_.N, g_.K, NT) {
    b = blockIdx.x;
    cb = p.begin(b);
    ce = b < p.geff ? p.begin(b + 1) : cb;
    n = ce - cb;
    R = a.R;
    sp8 = (min(R, kRowPass) + 7) & ~7;
    passes = (R + kRowPass - 1) / kRowPass;
    stage = Q::W_BYTES + sp8 * Q::X_ROW;
    acc = reinterpret_cast<float*>(smem + kStages * stage);
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
      const int s = n0 < g.end[0] ? 0 : n0 < g.end[1] ? 1 : 2;
      const T* W = g.w[s] + (n0 - (s ? g.end[s - 1] : 0));
      const long long ld = g.ld[s];
      constexpr int CPR = NT / VEC;
#pragma unroll
      for (int i = 0; i < Q::W_BYTES / 16 / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e / CPR, cc = e % CPR;
        const int dc = Q::BF ? (cc ^ (row & 7)) : cc;
        tc::cp_async16(sw + row * NT + dc * VEC, W + (k0 + row) * ld + cc * VEC, true);
      }
    }
  }

  // chunk c's X rows r0 .. r0 + rp8 into stage st (rows past R zero-filled)
  __device__ void issue_x(int c, int st, int r0, int rows, int rp8) const {
    const int k0 = c % p.nc * kKC;
    T* sx = reinterpret_cast<T*>(smem + st * stage + Q::W_BYTES);
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

  // a tile's group and the pieces the group holds (see Kind)
  __device__ int tiles_a_head() const { return g.kind == kQKV ? D / NT : 1; }
  __device__ int group_of(int t) const {
    return g.kind == kQKV ? t / tiles_a_head()
         : g.kind == kGateUp ? t % (g.N / NT / 2) : t;
  }
  __device__ int group_pieces(int grp) const {
    if (g.kind == kGateUp) return p.pieces(grp) + p.pieces(grp + g.N / NT / 2);
    int s = 0;
    for (int t = grp * tiles_a_head(); t < (grp + 1) * tiles_a_head(); ++t)
      s += p.pieces(t);
    return s;
  }

  // chunk c from stage st into the accumulators; a piece's last chunk
  // writes the piece to its slot and takes the group's ticket
  __device__ void process(int c, int st, int r0, int rows, int rp8) const {
    __shared__ int s_done;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t = c / p.nc, kc = c % p.nc;
    const bool first = c == cb || kc == 0;
    const bool last = c == ce - 1 || kc == p.nc - 1;
    const T* sw = reinterpret_cast<const T*>(smem + st * stage);
    const T* sx = reinterpret_cast<const T*>(smem + st * stage + Q::W_BYTES);
    float* dst = a.part + static_cast<long long>(b - p.first(t)) * R * g.N;
    if constexpr (Q::BF) {
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
    // the piece is out: take the group's ticket (the block's writes are
    // ordered before thread 0's fence by the barrier)
    __syncthreads();
    const int grp = group_of(t);
    if (tid == 0) {
      __threadfence();
      s_done = atomicAdd(a.gtickets + grp, 1) == passes * group_pieces(grp) - 1;
    }
    __syncthreads();
    if (s_done) {
      __threadfence();
      finish_group<T, D>(a, g, p, grp);
      if (tid == 0) a.gtickets[grp] = 0;   // ready for the next phase
    }
  }

  // the ring: kStages - 1 chunks in flight ahead of the one in use (empty
  // groups past the end keep the wait count uniform)
  __device__ void run() const {
    for (int r0 = 0; r0 < R && n > 0; r0 += kRowPass) {
      const int rows = min(kRowPass, R - r0), rp8 = (rows + 7) & ~7;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n) {
          issue_w(cb + s, s);
          issue_x(cb + s, s, r0, rows, rp8);
        }
        tc::cp_async_commit();
      }
      for (int i = 0; i < n; ++i) {
        tc::cp_async_wait<kStages - 2>();   // chunk i has landed
        __syncthreads();                     // ... for every thread; i-1 read
        if (i + kStages - 1 < n) {
          const int c = cb + i + kStages - 1, st = (i + kStages - 1) % kStages;
          issue_w(c, st);
          issue_x(c, st, r0, rows, rp8);
        }
        tc::cp_async_commit();
        process(cb + i, i % kStages, r0, rows, rp8);
      }
      tc::cp_async_wait<0>();
      __syncthreads();
    }
  }
};

// ---------------------------------------------------------------- rows
// Block-per-row phase: hn = round(round(h * rsqrt(mean(h^2) + eps)) * w),
// h gathered from the embedding first at layer 0 (embed); 16-byte loads.
template <typename T>
__device__ void row_phase(const Args<T>& a, int r, bool embed, const T* w,
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
template <typename T, int D>
__device__ void attn_item(const Args<T>& a, int l, int it,
                                       unsigned char* smem, float scale) {
  const int ns = a.n_split, nkv = a.nkv, G = a.nh / nkv, R = a.R;
  const int split = ns - 1 - it / (nkv * R), kvh = it / R % nkv, r = it % R;
  const long long qo = (static_cast<long long>(r) * a.nh + kvh * G) * D;
  const int len = min(max(a.meta[r] + a.meta[R + r], 0), a.mb * a.bs);
  const int* row_tbl = a.tables + static_cast<long long>(r) * a.mb;
  const long long kv_row = static_cast<long long>(nkv) * D;
  const int nb = a.nb, bs = a.bs;
  auto key_off = [&](int p) -> long long {
    const int phys = min(max(row_tbl[p / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + p % bs) * kv_row + kvh * D;
  };
  const long long layer_off = static_cast<long long>(l) * nb * bs * kv_row;
  // as few accumulator registers as the KV head's G * D needs
#define PT_WALK(NACC)                                                        \
  skv::split_kv_walk<T, D, NACC>(a.q, a.pool_k + layer_off,                 \
                                 a.pool_v + layer_off, a.attn, a.part_m,    \
                                 a.part_l, a.part_acc, a.tickets, smem, qo, \
                                 len, key_off, G, r, kvh, nkv, split,       \
                                 a.split_len, ns, scale)
  if (G * D <= kThreads)
    PT_WALK(1);
  else if (G * D <= 4 * kThreads)
    PT_WALK(4);
  else
    PT_WALK(skv::kMaxAcc);
#undef PT_WALK
}

// The attention phase: blocks take items from a shared counter (the
// walks differ in length by the row's keys), which block 0 resets after
// the phase's barrier.
template <typename T, int D>
__device__ void attn_phase(const Args<T>& a, int l, unsigned char* smem,
                           float scale) {
  __shared__ int s_item;
  const int n_items = a.n_split * a.nkv * a.R;
  for (;;) {
    __syncthreads();   // the previous item is done with the shared ring
    if (threadIdx.x == 0) s_item = static_cast<int>(atomicAdd(a.queue, 1u));
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) return;
    attn_item<T, D>(a, l, it, smem, scale);
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
__global__ void __launch_bounds__(kThreads, 3)
fused_tick_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  unsigned gen = 0u;
  if (threadIdx.x == 0) gen = *reinterpret_cast<volatile unsigned*>(&a.bar[1]);
  const int nblk = gridDim.x, b0 = blockIdx.x;
  const int H = a.H, R = a.R, I = a.I, nh = a.nh, nkv = a.nkv, V = a.V;
  const int nq = (nh + 2 * nkv) * D;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const Gemv<T> head{a.hn, H, H, V, {a.head, a.head, a.head}, {V, V, V},
                     {V, V, V}, a.tied != 0, kHead, 0};
  for (int r = b0; r < R; r += nblk) row_phase(a, r, true, a.in_ln, smem);
  grid_sync(a.bar, gen);
  for (int l = 0; l < a.L; ++l) {
    const long long lh = static_cast<long long>(l) * H;
    const T* wo = a.wo + static_cast<long long>(l) * nh * D * H;
    const T* wd = a.wd + static_cast<long long>(l) * I * H;
    const Gemv<T> qkv{a.hn, H, H, nq,
                      {a.wq + lh * nh * D, a.wk + lh * nkv * D, a.wv + lh * nkv * D},
                      {nh * D, nkv * D, nkv * D}, {nh * D, (nh + nkv) * D, nq},
                      false, kQKV, l};
    const Gemv<T> o{a.attn, nh * D, nh * D, H, {wo, wo, wo}, {H, H, H},
                    {H, H, H}, false, kResid, l};
    const Gemv<T> gu{a.hn, H, H, 2 * I, {a.wg + lh * I, a.wu + lh * I, a.wu + lh * I},
                     {I, I, I}, {I, 2 * I, 2 * I}, false, kGateUp, l};
    const Gemv<T> down{a.act, I, I, H, {wd, wd, wd}, {H, H, H}, {H, H, H},
                       false, kResid, l};
    GemvRun<T, D>(a, qkv, smem_raw).run();
    grid_sync(a.bar, gen);
    attn_phase<T, D>(a, l, smem_raw, scale);
    grid_sync(a.bar, gen);
    if (b0 == 0 && threadIdx.x == 0) *a.queue = 0u;   // every block is past it
    GemvRun<T, D>(a, o, smem_raw).run();
    grid_sync(a.bar, gen);
    for (int r = b0; r < R; r += nblk)
      row_phase(a, r, false, a.post_ln + lh, smem);
    grid_sync(a.bar, gen);
    GemvRun<T, D>(a, gu, smem_raw).run();
    grid_sync(a.bar, gen);
    GemvRun<T, D>(a, down, smem_raw).run();
    grid_sync(a.bar, gen);
    const T* next_w = l + 1 < a.L ? a.in_ln + lh + H : a.final_norm;
    for (int r = b0; r < R; r += nblk) row_phase(a, r, false, next_w, smem);
    grid_sync(a.bar, gen);
  }
  GemvRun<T, D>(a, head, smem_raw).run();
  grid_sync(a.bar, gen);
  for (int r = b0; r < R; r += nblk) sample_row(a, r, smem);
}

// Dynamic shared memory of a launch: the GEMV ring and accumulators for
// min(R, kRowPass) rows, the split-KV walk's ring for G heads a KV head,
// or the sampler's histogram, whichever is largest.
template <typename T, int D>
size_t smem_bytes(int R, int G) {
  using Q = Geo<T>;
  const size_t sp8 = (std::min(R, kRowPass) + 7) & ~7;
  const size_t gemv = kStages * (Q::W_BYTES + sp8 * Q::X_ROW) + sp8 * Q::ACC_ROW;
  const size_t walk = skv::Shape<T, D>::smem_bytes(G);
  const size_t sample = (2 * kWarps + 256 + 3) * sizeof(float);
  return std::max(std::max(gemv, walk), sample);
}

template <typename T, int D>
cudaError_t launch(Args<T> a, int max_blocks_per_sm, cudaStream_t stream,
                   int* grid_out) {
  auto kernel = fused_tick_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>(a.R, a.nh / a.nkv);
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
  a.queue = a.bar + 2;
  a.gtickets = reinterpret_cast<int*>(a.bar + 3);
  a.part_m = static_cast<float*>(p[30]);
  a.part_l = static_cast<float*>(p[31]);
  a.part_acc = static_cast<float*>(p[32]);
  a.tickets = static_cast<int*>(p[33]);
  a.R = n[0]; a.L = n[1]; a.H = n[2]; a.nh = n[3]; a.nkv = n[4];
  a.I = n[5]; a.V = n[6]; a.nb = n[7]; a.bs = n[8]; a.mb = n[9];
  a.s_rows = n[10]; a.tied = n[11]; a.split_len = n[12]; a.n_split = n[13];
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

// The 34 pointers in Args order (tok ... bar, then the split-KV walk's
// part_m, part_l, part_acc and tickets); ints R, L, H, nh, nkv, I, V, nb,
// bs, mb, s_rows, tied, split_len, n_split, then D and is_bf16; eps; a cap
// on blocks per SM (0 = as many as fit); grid_out receives the launched
// grid size. H, I, V and the QKV width must be multiples of 64 (the
// wrapper checks); part holds the GEMV pieces (kernels/fused_decode_tick.py
// sizes it for the largest grid the cap allows).
extern "C" int pt_fused_decode_tick(
    void* tok, void* embed, void* wq, void* wk, void* wv, void* wo, void* wg,
    void* wu, void* wd, void* in_ln, void* post_ln, void* final_norm,
    void* head, void* pool_k, void* pool_v, void* sin, void* cos,
    void* tables, void* meta, void* keys_in, void* h, void* hn, void* q,
    void* attn, void* act, void* part, void* logits, void* nxt,
    void* keys_out, void* bar, void* part_m, void* part_l, void* part_acc,
    void* tickets, int R, int L, int H, int nh, int nkv, int I, int V,
    int nb, int bs, int mb, int s_rows, int tied, int split_len, int n_split,
    int D, int is_bf16, float eps, int max_blocks_per_sm, void* grid_out,
    void* stream) {
  void* p[34] = {tok, embed, wq, wk, wv, wo, wg, wu, wd, in_ln, post_ln,
                 final_norm, head, pool_k, pool_v, sin, cos, tables, meta,
                 keys_in, h, hn, q, attn, act, part, logits, nxt, keys_out,
                 bar, part_m, part_l, part_acc, tickets};
  const int n[14] = {R, L, H, nh, nkv, I, V, nb, bs, mb, s_rows, tied,
                     split_len, n_split};
  if (R < 1 || H % 64 || I % 64 || V % 64 ||
      pt::skv::bad_split_args(nh, nkv, D, mb * bs, split_len, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* g = static_cast<int*>(grid_out);
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, p, n, eps, max_blocks_per_sm, s, g)
      : dispatch<float>(D, p, n, eps, max_blocks_per_sm, s, g);
  return static_cast<int>(err);
}
