// The fused decode tick's C entry over fused_decode_tick.cuh, where the
// kernel and its design notes live. Replaces
// paddle_tpu/kernels/pallas_fused_decode_tick.py:_fused_tick_pallas (its
// pallas_call at :335). kernels/_build.py compiles this file once a (pool
// mode, weights) variant, each into its own library:
//   FT_MODE   the pool: 0 the model's type, 1 int8 with per-row-per-head
//             float32 planes, 2 e4m3 with per-block planes
//   FT_W8     1: the weights are int8 (q, scale) pairs
//   FT_ENTRY  the C entry's name, pt_fused_decode_tick{,_int8,_fp8}{,_w8}
// Arguments: fused_tick_entry's.
#include "fused_decode_tick.cuh"

#ifndef FT_MODE
#define FT_MODE 0
#endif
#ifndef FT_W8
#define FT_W8 0
#endif
#ifndef FT_ENTRY
#define FT_ENTRY pt_fused_decode_tick
#endif

extern "C" int FT_ENTRY(
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
  return pt::ft::fused_tick_entry<FT_MODE, FT_W8 != 0>(
      tok, embed, wq, wk, wv, wo, wg, wu, wd, in_ln, post_ln, final_norm, head,
      pool_k, pool_v, sin, cos, tables, meta, keys_in, h, hn, q, attn, act,
      part, logits, nxt, keys_out, bar, part_m, part_l, part_acc, tickets,
      k_scale, v_scale, sq, sk, sv, so, sg, su, sd, shead, R, L, H, nh, nkv,
      I, V, nb, bs, mb, s_rows, tied, split_len, n_split, D, is_bf16, eps,
      max_blocks_per_sm, grid_out, stream);
}
