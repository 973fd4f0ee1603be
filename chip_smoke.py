#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line; any failure exits nonzero:

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   — compile the CUDA sources of ``paddle_tpu_torch/csrc`` (eight
             kernels in thirteen libraries, one ``nvcc`` each, in
             parallel), in a thread, while the card runs the
             substrate's GPT-3 345M legs and then ``hapi``'s checks (no
             kernel of the port).
3. kernels — each kernel against its plain PyTorch version, bf16 and fp32:
             the three serving kernels of the default engine and the
             dense-cache decode kernel (B=8, S_max=4096, lengths 1 to
             4096, plus a GQA check with 8 KV heads and a row of length
             0) at the LLaMA-7B serving shapes; paged and dense decode
             the same bits on two launches (with their split length and
             grid); ragged attention with both of its grids (split-KV
             blocks for span-1 rows, tile blocks for chunks: launched and
             working) plus spans of 2, 63, 64 and 65, a chunk starting
             mid-block, a chunk whose last key tile is partial, GQA
             with 8 KV heads and speculative verify spans of 3 and 5
             rows that cross a block edge (the same bits on a second
             launch); the fused decode tick at
             llama_7b widths, 2 layers, 8 rows (mixed lengths, one masked
             row, one sampled row) and 37 rows (past the 16 it once took,
             not a multiple of its 8-row tiles): keys bit for bit, logits
             and appended K/V rows within TOL (bf16: scaled), nothing
             written outside the appended rows, next tokens equal in fp32,
             and its layer-0 attention output bit for bit equal to the
             paged decode kernel's at the tick's own q and pool; the two
             flash-backward kernels at the training shapes (B=4, S=2048,
             32 heads of 128) plus a tail (S=300) and a GQA (8 KV heads)
             check, each bitwise equal across two launches, and the
             flash forward's O and LSE at each of those shapes; max-abs
             error against the stated tolerance, kernel / plain / library
             milliseconds (a PyTorch call on the same work, a yardstick
             the port never calls), the least time the card could take
             (``bound_ms``),
             achieved TFLOP/s and the route (the bf16 flash forward, dK/dV
             and dQ on the tensor cores, the rest on the CUDA cores).
             Then the quantized modes, bf16 and fp32: paged decode (the
             quantized walk: 8 KB pages, keys owned by warps; also over
             the edge lengths 0, 1, 31, 32, 33, a page +- 1, a split +- 1
             and 4093, and with 8 KV heads) and ragged attention (its
             edge spans too; bf16 chunks on the wgmma tile, narrow tiles
             converted in shared memory) on int8 and fp8 pools at the
             same shapes, the same bits on two launches, each timed
             beside the same kernel on a pool of the query type in this
             run (``base_ms``), the library yardstick
             dequantizing the
             gathered cache before SDPA; the fused tick (2 layers, 8 and
             37 rows) on an int8 pool with int8 weights and on an fp8
             pool: keys bit for bit, tokens equal in fp32, logits within
             the bf16 scaled bound, appended values within a grid step
             (bf16: the scaled bound plus a step), nothing else written,
             the layer-0 attention bit for bit quantized paged decode's;
             each timed beside the dense tick in this run (bf16 int8
             weights: 8 KB chunks of 64 k rows x 128 columns, A
             fragments built in registers).
             First, the flash kernels' fused-RoPE mode (``flash[rope]``,
             ``flash_bwd_dkv[rope]``, ``flash_bwd_dq[rope]``: un-rotated
             Q and K; the forward and the backward each rotate Q and K
             once by the ``rope_qk`` pre-pass, equal to the plain
             rotation bit for bit; the adjoint on
             dQ/dK) in bf16 and fp32 at B=4, S=2048, 32 heads of 128 in
             the head-major layout, plus S=300 with 8 KV heads, and the
             head-major layout without RoPE, each against its plain
             version (bf16 the same bits twice; the one-pre-pass
             backward the same bits as the two standalone entries);
             times of the kernel (the forward's row: its pre-pass and
             kernel together; a backward row: its body on the
             rotated pair), the same kernel on inputs rotated
             beforehand, the unfused pair (torch rotation, then the
             kernel; a backward kernel then the torch adjoint), the
             library pair (torch rotation, then SDPA), the pre-pass
             apart and the backward pair's total (pre-pass + dK/dV +
             dQ) beside the library pair. Last, float16 (Queue C 8):
             the RoPE rows, the forward and the backward pair again in
             fp16 on the tensor cores (the kernels line's ``:f16``
             rows), within fp16's ``TOL``/``BWD_TOL`` (half of bf16's),
             the same bits twice.
4. engine  — llama_7b widths at 2 layers in fp32, for each of the
             engine's three decode programs (default, ``fused_tick=True``,
             ``paged_attn=False``), through the kernels against the plain
             versions (``FLAGS_use_cuda_kernels`` on, then off): the greedy
             token streams must be equal, the program's own kernel must
             launch only with the kernels on, and the fused engine's
             streams must equal the default engine's; then 20 requests
             at 32 slots (more than 16 in flight) through the default and
             the fused engine, streams equal. The prefix cache on the
             default and the dense engine (a wave of 4 on a shared
             96-token prefix, then a wave of 4 that hits it; kernels and
             plain, with and without the cache: streams equal, tokens
             saved); ``ragged_step=False`` (streams equal the unified
             engine's, paged decode launched, ragged not);
             ``decode_ticks=8``, scanned and fused, with an EOS the first
             run emits mid-stream: the graph tail, the eager tail
             (``FLAGS_cuda_graph_tail`` off) and the plain versions give
             the streams, finish reasons and ticks run of
             ``decode_ticks=1``, the device retires a row mid-block,
             launches equal the code's count with the graph's replays
             counted, and the pools after the first tail equal the eager
             tail's. Then every quantized knob set (int8 and fp8 pools,
             int8 weights on the three engines, int8 x int8 projections,
             the fused tick on an int8 pool with int8 weights and on an
             fp8 pool, ``decode_ticks=4`` and a prefix hit on an int8
             pool), kernels against plain versions: streams equal (int8 x
             int8: the reference's measured bound, a matched prefix of at
             least half, and the kernels' repeat bit for bit). Before
             those, Queue A step 9's rest: speculative decode at
             ``spec_k=4`` with the n-gram drafter (two requests repeat a
             stretch of their prompt), with the target drafting for
             itself (acceptance at least 0.9), on an int8 pool and with
             the prefix cache — each kernels and plain, with and without
             speculation, all streams equal, the verify launching only
             ragged attention (2 a step), the pool whole after; the host
             tier on fp32, int8 and bf16 pools (two 96-token system
             prompts in turn under a 3-block trie budget: streams equal
             the run without a tier, blocks spilled and readmitted); two
             priority classes on a virtual clock, an urgent latency
             request preempting a batch one (``policy_preemptions`` >= 1),
             kernels and plain, streams equal the policy-off run's. Last,
             in a child process, whether the fused tick's cooperative
             launch captures into a CUDA graph.
5. serve   — llama_7b at full width and depth (32 layers) in bf16 with
             seeded random weights: 8 requests (7 short prompts, one long
             prompt that rides the ragged kernel in chunks, one seeded
             top-k request), 64 new tokens each, through the default
             engine, then the fused-tick engine (one fused kernel launch
             per tail tick, no paged decode; plus one tick timed at this
             depth against the scanned tick, and again with every row at
             length 1: the difference is the attention's share), then the
             dense engine (32
             decode launches per tick, no paged kernel), then the default
             engine with ``decode_ticks=8`` (ragged 32 a step, paged
             decode 32 a tail tick the device ran, graph replays counted),
             then ``kv_dtype="int8", quantize_weights=True`` on the
             default engine and with ``fused_tick`` (each profiled once:
             device time; ``bytes_per_token``), each freed before the
             next; each launch count must equal
             what the code implies. Then the prefix run: 8 requests on a
             shared 1024-token prefix (tails 64-256, 64 new tokens) after
             a priming request, ``prefix_cache=True, prefix_blocks=512``
             and then without the cache: wall, TTFT, tokens saved (8192
             required), hit rate, peak memory. Speculative decode on the
             8 requests (``spec_decode=True, spec_k=4``, the n-gram
             drafter: tok/s, acceptance, tokens per verify launch, ragged
             32 a verify step, streams against the default engine's); the
             target drafting for itself, 2 requests x 32 tokens
             (acceptance and tokens per verify span at full width); the
             host tier: two 1024-token prefixes in turn, one request at a
             time, TTFT cold, resident (``prefix_blocks=512``) and
             readmitted (a 24-block trie budget under the prefix's 32,
             ``host_tier_bytes``: each admission readmits its prefix), the
             tier's d2h/h2d bytes from the cost observatory and the
             transfers' GB/s over 16 blocks of 16 MiB (pinned staging).
6. generate — ``model.generate`` on the same model (llama_7b, 32
             layers, bf16, seed 0): B=4 prompts of 128 tokens, 64 new
             tokens, greedy and then seeded top-k twice (equal ids); both
             equal a direct ``ContinuousBatchingEngine(num_slots=4,
             prefill_bucketing="exact", decode_chunk=16)`` run with the
             same ``fold_in`` keys; flash, ragged and paged decode
             launches equal the code's count (one prefill, the unified
             steps and the tail ticks, each times 32 layers); wall time
             and tok/s. Then fp32 at 7B widths, 2 layers: the same ids
             with the kernels and with ``FLAGS_use_cuda_kernels`` off.
7. server  — ``serve(model, port=0)`` at its defaults (decode_chunk 1, 8
             slots, cost on, trace off): 8 concurrent HTTP clients (4
             blocking, 4 SSE) on the serve phase's requests, each started
             once the one before holds its slot; every stream equals a
             direct engine run admitting the requests the same way;
             ``/metrics`` parses strictly with
             ``serving_decode_compilations`` 1; ``/healthz`` ok; a
             ``/debug/trace?steps=8`` window taken during traffic holds
             ``plan``, ``launch`` and ``host-accept``; ``/debug/profile``'s
             ragged calls equal the engine's unified steps; ragged
             launches = 32 x steps with work, flash = 32 x cold-prefill
             calls, paged decode 0; TTFT and TPOT p50/p90 and the
             gateway's wall against the direct run's. The fault leg (fp32,
             7B widths, 2 layers): ``scripts/bench_chaos.py``'s plan
             ``transient@3, pool@6, fatal@10, nan@15`` through
             ``serve(..., fault_hook=plan)``: no request lost, streams
             equal the fault-free run, 2 engine restarts, peak memory
             across the rebuilds. The CLI leg: ``python -m
             paddle_tpu_torch.serving.server --preset 350m
             --decode-attention pallas --port 0 --quiet`` as a subprocess
             serves one completion and drains on SIGTERM with exit 0.
8. train_parity — llama_7b widths at 2 layers, B=1, S=500, in fp32 (the
             CUDA-core kernels) and in bf16 (the tensor-core forward,
             dK/dV and dQ), in the bshd layout, the head-major ``bhsd``
             layout and ``bhsd`` with ``fuse_rope`` (the RoPE kernels),
             and in fp32 under ``recompute_policy="dots"``: one
             forward+backward through the kernels and one through the
             plain versions (``FLAGS_use_cuda_kernels`` off); the losses
             and every parameter's gradient must agree, and each leg
             launches the kernels of its own mode.
9. train   — run right after the build, on an emptied allocator
             (after the serving phases the accumulated step's update can
             fail for fragmentation alone): llama_7b widths
             at 15 layers in bf16 (the deepest whose
             steps fit one 80 GB card: 16 run out of memory in the
             accumulated step's update), B=4, S=2048, full
             recompute, AdamW(1e-4) with ClipGradByGlobalNorm(1.0) through
             ``TrainStep``: a warm-up step, three timed steps and one
             ``accum_step(accum=2)`` on a repeated seeded batch, in
             ``bshd``, ``bhsd`` and ``bhsd`` with ``fuse_rope``, one model
             freed before the next. Losses finite and falling; flash
             forward, dK/dV and dQ launch counts (in each run's own mode)
             equal to what the code implies. Then ``dots`` at the deepest
             depth that fits, and ``bench.py``'s first and third configs
             at its 350M shape (B=8, S=2048, ``accum_step(..., 4)``):
             step ms, tokens/s, 6 * params * tokens/s over 989 TFLOP/s.

10. tp     — tensor-parallel serving with every shard on the card.
             fp32, 7B widths, 2 layers, the engine phase's requests:
             ``tp=2`` and ``tp=4`` through the kernels against the plain
             versions, streams equal; ``tp=2`` against ``tp=1``, streams
             equal and the first logits within ``TOL``;
             ``collective_overlap`` at ``tp=2``, streams and pools bit for
             bit the plain schedule's; ``collective_dtype="int8"`` kernels
             against plain, its partings from fp reported; an int8 pool,
             an fp8 pool, int8 weights, ``spec_k=4``, a prefix hit and
             ``fused_tick`` at ``tp=2`` against the same knobs at
             ``tp=1``; ``decode_ticks=8`` (graph tail, eager tail, plain)
             against ``tp=1``. Every leg's launches equal the code's count
             (flash, ragged attention and paged decode once a shard a
             layer a cold prefill, step and tail tick; the fused tick
             never), its collective ledger equals the wire model summed
             over the reductions the device ran, and the split-KV
             tickets are zero after it. Then bf16 at the same widths:
             ``tp=2``'s first logits against its plain versions and
             against ``tp=1`` (``BWD_TOL`` scaled by the largest entry,
             the script's bf16 form), partings reported. Then bf16,
             llama_7b at 32 layers, the serve phase's 8 requests: ``tp=1``
             and ``tp=2`` — tok/s, step ms, peak memory, launches a shard,
             collective bytes a step, the first partings from ``tp=1``
             and at each parting, through both degrees' cold prefill of
             the stream so far, the top-2 gaps beside the largest
             difference of the two degrees' logits.

11. substrate — its GPT legs' checks during the build, their timed
             steps and the rest right after ``train`` on an emptied
             allocator: the
             Paddle-shaped substrate (``import paddle_tpu_torch as
             paddle``). GPT-3 345M (``gpt3_345m``: vocabulary 50304,
             hidden 1024, 16 heads, FFN 4096, dropout 0.1, 24 layers)
             built from ``paddle.seed`` on ``gpu:0``, micro batch 8 x
             1024 seeded tokens, AdamW (weight decay 0.01, global-norm
             clip 1.0, ``apply_decay_param_fun``) on ``LinearWarmup(
             CosineAnnealingDecay)``, eager ``loss.backward()``,
             ``opt.step()``, ``opt.clear_grad()``: 10 steps in fp32,
             under ``auto_cast(level="O1", dtype="bfloat16")`` and under
             ``decorate``/``auto_cast`` O2 float16 with
             ``GradScaler(init_loss_scaling=32768)``; losses finite and
             falling, the scale and skipped steps reported, and after
             step 5 the model, optimizer (scheduler inside), scaler and
             RNG key saved with ``paddle.save``, loaded with
             ``paddle.load`` into a fresh model and optimizer, whose
             steps 6-10 give the same losses bit for bit; then, with
             the build done (an uncontended host), each leg's step ms
             (a fresh model, mean of steps 2-4), tokens/s, peak memory,
             and the dropout masks' time a step.
             ``F.flash_attention`` at B=8, S=1024 and 1000, 16 heads of
             64, bf16 and fp32, causal and not: O and dQ, dK, dV through
             autograd against the plain versions (``TOL``, ``BWD_TOL``),
             the same bits twice, one forward, one dK/dV and one dQ
             launch a call; then float16 (Queue C 8) the same way at
             B=8, S=1024, 16 x 64 and B=4, S=2048, 32 x 128, causal and
             not, and at both the RoPE mode (``rope=``, two ``rope_qk``
             launches; the pre-pass alone bit for bit the plain
             rotation). A two-block user ``Layer`` at 345M widths whose
             attention is ``F.flash_attention``, causal and then not: 3
             AdamW steps in fp32, kernels against plain (losses 1e-5
             relative, gradients 1e-4 of their max); then the same Layer
             under O1 float16 with the ``GradScaler`` and its rotary form
             (the head-major entry with ``rope=``), losses within 1e-5
             relative, every unscaled gradient within fp16's
             ``BWD_TOL``, no step skipped: the ``:f16`` rows' main path.
             Then the
             non-causal kernels' rows (``flash:full``,
             ``flash_bwd_dkv:full``, ``flash_bwd_dq:full``) at GPT-345M's
             attention shape.

12. vision — run after ``substrate``: ResNet-50 (``paddle.vision.models
             .resnet50()``, 25.56 M parameters, 1000 classes, 224 x 224,
             NCHW) trained on the card from a ``paddle.io.DataLoader``
             over ``vision.datasets.FakeData`` (HWC images) through the
             ImageNet training transforms (RandomResizedCrop, a flip,
             HWC -> CHW, the ImageNet mean/std), batch 64, PaddleClas's
             ResNet50 optimizer (Momentum 0.9, L2Decay 1e-4, Piecewise
             from 0.1), cross entropy: fp32 eager, O1 bf16 and
             ``jit.TrainStep``, 12 steps each on 8 thread workers; then
             4 steps on 2 process workers, every batch through the
             native shared-memory ring; the resume after ``paddle.save``/
             ``paddle.load`` (BN buffers, Momentum velocity, the
             scheduler) bit for bit under deterministic cuDNN; one step
             at batch 4 (each residual branch's last BN scale 0.1, as the
             CPU tests set it) on the card in float64 and in fp32 against
             the float64 step on the CPU: loss 1e-5 relative, BN buffers
             1e-5, every float64 gradient 1e-4 of its max, and each fp32
             gradient 1e-4 of its max where the CPU's own fp32 step is
             within a tenth of that (the rest reported). Each leg: step
             ms, images/s,
             the ms a step waited on the loader, peak memory, beside the
             card's ``nvidia-smi`` name and power limit. Convolutions and
             pools are cuDNN's: the path launches none of the port's
             kernels.

13. seq    — run after ``vision``: Transformer base (PaddleNLP's WMT14
             en-de recipe: ``nn.Transformer`` d_model 512, 8 heads, 6 + 6
             post-norm layers, FFN 2048, dropout 0.1; one shared
             embedding of 33,712 rows scaled by sqrt(512) plus sinusoid
             positions; 64 random pairs padded to 64 tokens, lengths
             33-64, the source pad mask additive, the target causal;
             label-smoothed soft-label cross entropy; Adam(0.9, 0.997,
             1e-9) on NoamDecay(512, 4000, 2.0) from the warm-up's end)
             and the PTB "medium" LSTM LM (vocabulary 10,000, ``nn.LSTM``
             650 x 2, dropout 0.5, uniform +-0.05, 20 x 35 tokens, the
             state carried detached, SGD 1.0 with a global-norm clip of
             5): fp32 eager and O1 bf16, 10 steps each on a repeated
             seeded batch, losses finite and falling; step ms (mean of
             steps 3-10), tokens/s, peak memory, the dropout masks' ms a
             step, the port's kernel launches a step (none) and one
             profiled step's device kernels and busy share. Then the card
             against the CPU in float64: both models at 2 layers and
             narrow widths with dropout on (loss 1e-5 relative, every
             gradient 1e-4 of its max), GRU, SimpleRNN (tanh, relu) and a
             time-major bidirectional LSTM the same; every new op of
             ``extra``, ``tail`` and ``inplace`` (1e-6 of its max,
             integers equal, outputs on the card; the refills' uniform
             bits equal); every new functional, loss layer and
             ``flash_attn_unpadded`` in float64 and the losses in
             float32 (1e-5, gradients 1e-4); Adagrad, RMSProp, Adadelta,
             Adamax, Lamb and LBFGS (3 steps, 1e-6); ``jacobian``,
             ``hessian``, ``jvp``, ``vjp`` (1e-10). The path launches
             none of the port's kernels.

14. incubate — run after ``seq``: ``incubate.nn.FusedMultiTransformer``
             at GPT-3 345M's widths (E 1024, 16 heads of 64, FF 4096, 24
             pre-LN layers, gelu) under a seeded 50,304-row embedding,
             1,024 positions, a final LayerNorm and the tied head: 8
             distinct 128-token prompts prefilled into a 1,024-row cache
             at ``time_step`` 0, then 64 greedy tokens one ``time_step``
             at a time, through the dense decode kernel
             (``decode_attention="pallas"``) and through the stack's
             plain path (``"jnp"``), in fp32 (streams equal) and bf16
             (the first decode step's logits within ``BWD_TOL``'s scaled
             form, partings reported), and a GQA leg (4 KV heads, 2
             layers, fp32, streams equal); ``decode`` launches exactly
             layers x 63 a kernel leg, none plain; decode ms a step and
             tok/s. The kernel alone at the path's shapes (B=8, S_max
             1024, 16 x 64, lengths 129-192, bf16): ``TOL``, the same
             bits twice, events and device ms, plain and SDPA ms, its
             byte bound (the ``decode:fmt`` row). ``flash_attn_qkvpacked``
             at B=4, S=2048, 16 x 64, bf16, causal and not (``TOL``, one
             launch). ``masked_multihead_attention``, the varlen attention
             and the fused bias-dropout-residual LayerNorm in float64,
             card against CPU (1e-5 of their max), the dropout's uniform
             bits equal.

15. ernie  — run after ``incubate``: ERNIE-ViL base (ViT-B/16 at 224², a
             12 x 768 text tower of 64 tokens, embedding 512; 64 FakeData
             pairs through the vision training transforms; AdamW 0.9 /
             0.98 / 1e-6, weight decay 0.2) and ERNIE 1.0 base
             (``ErnieForSequenceClassification``, 32 x 128 tokens, dropout
             0.1, AdamW 5e-5), fp32 and O1 bf16, 2 warm-up and 3 timed
             steps on a fresh model: step ms, pairs/s or tokens/s, peak
             memory, the masks' ms, one profiled step's busy share. Then
             the card against the CPU in float64: ERNIE-ViL at 2 + 2
             layers and ERNIE at 2 layers (both heads) at the float32
             floor their LayerNorms, scores and cross entropy set (the
             larger of 7.2e-7 and twice the CPU step's own distance from
             its all-float64 twin), the CLIP loss and the patch embedding
             at 1e-10 (gradients 1e-8). No kernel of the port.

16. llama13b — run after the 7B model is freed (the two never live
             together): LLaMA-13B (``llama_13b``: 40 query heads over 40
             KV heads of 128, hidden 5120, FFN 13824, 40 layers). Each
             serving kernel against its plain version at that geometry
             in bf16, at the ``kernels`` phase's shapes: ragged attention
             (the packed tick-0 buffer, both grids, the edge spans),
             paged and dense decode (B=8, S_max 4096, lengths 1-4096),
             the flash forward (B=4, S=512 and 2048) and the fused tick
             at 13B widths, 2 layers, 8 and 37 rows; the same bits on two
             launches (the ``@13b`` rows). Then 13B widths at 2 layers in
             fp32 through the default, fused-tick and dense engines,
             kernels against plain (streams equal, each engine's own
             kernel only with the kernels on, the fused streams the
             default's). Then the whole model in bf16 (26.0 GB of seeded
             weights) on the serve phase's 8 requests through the three
             engines, one freed before the next (launches the code's
             count at 40 layers, the fused run's tick timed against the
             scanned tick), and ``model.generate`` (B=4 x 128, 64 greedy
             tokens) against a direct engine run.

17. hapi   — its checks beside the kernel build, after the GPT legs
             (the card idles there; the 15-layer train step still fits
             after them), its timed legs after ``ernie``: the Paddle
             quick start through
             ``paddle.Model``: LeNet on MNIST-shaped FakeData, Adam on a
             StepDecay rate, ``Accuracy``, ``fit`` one epoch of 20
             batches of 64 with ``eval_data`` under ``EarlyStopping``,
             ``ModelCheckpoint``, ``LRScheduler``, ``ReduceLROnPlateau``
             and ``VisualDL`` (losses finite and falling, the rate stepped
             twice a batch as the reference steps it, the checkpoint
             files and ``scalars.jsonl`` written), ``evaluate``,
             ``predict``, ``save``/``load`` resuming bit for bit. Then
             ``mobilenet_v2`` at 224², batch 64, from FakeData through
             the vision training transforms through ``Model.fit`` (the
             vision phase's optimizer; 2 warm-up and 5 timed steps in
             fp32: step ms, images/s, peak memory, ``paddle.flops``
             beside the published 300 M multiply-adds); one fp32 step of
             each other new family at batch 16 (AlexNet, VGG-16,
             SqueezeNet 1.1, MobileNet V1 and V3 large, ShuffleNetV2 1.0,
             DenseNet-121, GoogLeNet, InceptionV3 at 299²); the card
             against the CPU in float64 (LeNet, MobileNetV3 small,
             ShuffleNetV2 0.25, DenseNet-121 at batch 2, float64 end to
             end, the cross entropy's float32 cast made a no-op: loss
             1e-10, gradients 1e-8 of their max; the step with the cast
             reported beside each device's distance from float64) and
             every ``vision.ops`` function (values
             1e-10, gradients 1e-8 of their max, indices equal). No
             kernel of the port.

``--profile`` repeats the four serve runs, the ``tp=2`` serve run and
one train step under ``torch.profiler`` and reports device time by
kernel and the device's busy share (for the fused run: one device kernel
per tail tick, its device time per launch beside its bound and beside
the scanned tail tick's device time; for ``tp=2``: the reductions' share
of the device time). Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# the math rates of the kernels' input types (fp32 off the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# kernel vs plain version: bf16 rounds the output (and P) to 8 mantissa
# bits, fp32 differs only in summation order. fp16 (the flash kernels
# only) rounds to 11 bits, 8x finer than bf16: half of bf16's bound
TOL = {"bfloat16": (2e-2, 2e-2), "float16": (1e-2, 1e-2),
       "float32": (1e-4, 1e-4)}   # (atol, rtol)
# flash backward vs its plain version, per output tensor:
# |err| <= atol * max|ref| + rtol * |ref|. Gradients are far smaller than
# 1, so atol scales with the tensor's own size. bf16: P and dS are
# rounded to 8 mantissa bits (2^-9 relative) from fp32 values whose last
# bits differ with the summation order, so an element may round to the
# neighbouring bf16 value; sums over up to 2048 rows keep that well under
# 1% of the tensor's max, and the output rounds once more (2^-9 relative).
# fp32: summation order only.
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float16": (1e-2, 1e-2),
           "float32": (1e-4, 1e-4)}

#: a head geometry: ``h`` query heads over ``hkv`` KV heads of ``d``
Heads = collections.namedtuple("Heads", "h hkv d")
# LLaMA-7B serving geometry of the default engine
HEADS = Heads(32, 32, 128)
SLOTS, BS, MAX_SEQ = 8, 32, 4096
MB = MAX_SEQ // BS
NB = SLOTS * MB
CHUNK = 512
T_PACKED = SLOTS + CHUNK

# LLaMA-7B training attention (the train phase's shapes)
TRAIN_B, TRAIN_S = 4, 2048

#: Queue C 6's head dim: the 7B hidden width as 16 heads of 256 over 8 KV
#: heads (the Gemma family's head width), for the three serving kernels
#: that took D in {64, 128} before it and their engines
D256 = Heads(16, 8, 256)
D256_KERNELS = ("flash", "ragged_attention", "fused_decode_tick")
#: Queue C 7's head dims: every D % 8 == 0 up to 256 runs at its padded
#: width (64, 128 or 256). Each at a geometry of its own, hidden h * d:
#: 16 at llama_tiny's 4 over 2 heads and at 64 over 16, 40 (D % 16 == 8:
#: 8-byte narrow rows and RoPE halves) and the two that pad to 128 (80:
#: hidden 2560; 96: 3072) at 32 over 8
DIMS = {"d16_tiny": Heads(4, 2, 16), "d16": Heads(64, 16, 16),
        "d40": Heads(32, 8, 40), "d80": Heads(32, 8, 80),
        "d96": Heads(32, 8, 96)}
#: the serving kernels held at each of DIMS
DIMS_KERNELS = ("paged_decode", "decode", "ragged_attention", "flash",
                "fused_decode_tick")
#: the backward kernels and the RoPE pre-pass at each new dim and at 256
#: (which they refused before Queue C 7)
BWD_DIMS = {"d16": DIMS["d16"], "d40": DIMS["d40"], "d80": DIMS["d80"],
            "d96": DIMS["d96"], "d256": D256}
#: LLaMA-13B (``llama_13b``, Queue A step 12c): 40 query heads over 40 KV
#: heads of 128 (the first head count neither 32 nor a power of two),
#: hidden 5120, FFN 13824, 40 layers
H13 = Heads(40, 40, 128)
#: the serving kernels held at 13B's geometry (the ``@13b`` rows)
L13_KERNELS = ("ragged_attention", "paged_decode", "flash", "decode",
               "fused_decode_tick")


def _heads_kw(heads):
    """The llama_7b overrides of head geometry ``heads`` (hidden h * d)."""
    return {"num_attention_heads": heads.h, "num_key_value_heads": heads.hkv,
            "hidden_size": heads.h * heads.d}


def _gqa_kv(heads):
    """KV heads of the GQA edge cases at ``heads``: 8, or 1 under fewer
    than 16 query heads (llama_tiny's 4)."""
    return 8 if heads.h % 8 == 0 and heads.h > 8 else 1


REPLACES = {
    "ragged_attention": "paddle_tpu/kernels/pallas_ragged_attention.py:238",
    "paged_decode": "paddle_tpu/kernels/pallas_paged_decode.py:215",
    "flash": "paddle_tpu/kernels/pallas_flash.py:159",
    "flash_bwd_dkv": "paddle_tpu/kernels/pallas_flash.py:335",
    "flash_bwd_dq": "paddle_tpu/kernels/pallas_flash.py:365",
    "decode": "paddle_tpu/kernels/pallas_decode.py:116",
    "fused_decode_tick":
        "paddle_tpu/kernels/pallas_fused_decode_tick.py:335",
}
#: how a kernel does its arithmetic, by input type: the bf16 flash forward
#: and the bf16 chunk spans of ragged attention on the tensor cores by
#: warpgroup wgmma (ragged's span-1 rows on the split-KV walk), bf16 dK/dV,
#: dQ and the fused tick's projections by mma.sync.m16n8k16, everything
#: else in fp32 FMAs on the CUDA cores
TENSOR_CORE = {"flash": "wgmma", "flash_bwd_dkv": "mma.sync",
               "flash_bwd_dq": "mma.sync",
               "ragged_attention": "wgmma chunks, split-KV span-1 rows",
               "fused_decode_tick": "mma.sync GEMVs, split-KV attention"}


def route(name, dtype_name):
    return (TENSOR_CORE.get(name, "cuda-core")
            if dtype_name in ("bfloat16", "float16") else "cuda-core")


#: the backward's RoPE pre-pass: it takes the place of the _rope_block
#: prologues of the two backward kernels (rows flash_bwd_*[rope])
PRE_PASS = "rope_qk"
REPLACES[PRE_PASS] = "paddle_tpu/kernels/pallas_flash.py:211"
SOURCES = {name: f"paddle_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["flash_bwd_dkv"] = SOURCES["flash_bwd_dq"] = \
    "paddle_tpu_torch/csrc/flash_bwd.cu"
BWD = ("flash_bwd_dkv", "flash_bwd_dq")
#: the flash kernels' fused-RoPE mode (rope=(sin, cos) in the reference:
#: _rope_block in the three prologues, _rope_t_block on dK and dQ), each
#: counted apart as ``name[rope]``
ROPE = {f"{n}[rope]": n for n in ("flash",) + BWD}
for _rope, _base in ROPE.items():
    REPLACES[_rope] = REPLACES[_base]
    SOURCES[_rope] = SOURCES[_base]
    TENSOR_CORE[_rope] = TENSOR_CORE[_base] + \
        ", Q and K rotated by the rope_qk pre-pass"


def emit(obj):
    # one write a line: the kernel build's thread emits beside the phases
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


_SPIN_CYCLES_PER_MS = []


def _spin_cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` a millisecond on this card,
    measured once."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10 ** 6)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(10 ** 7 / a.elapsed_time(b))
    return _SPIN_CYCLES_PER_MS[0]


def device_ms(fn, iters=20):
    """The device time of one call of ``fn`` by CUDA events, with a spin
    kernel (``torch.cuda._sleep``) holding the stream while the host
    enqueues, so that a wrapper's host work, which ``time_ms``'s events
    time when it is longer than the kernel, does not show: ``iters``
    calls back to back behind one spin (the fused tick's rows pass their
    row metadata on the card, ``_meta_on_card``, as its wrapper's copy
    from the host waits on the card). A call that waits on the device
    cannot be run ahead of: then each call is timed behind a spin of its
    own, which counts the host work after its wait, and a line says so.
    Raises on a time that is not positive. Not ``torch.profiler``: late
    in a long process it drops kernel records (a full smoke run read 0.0
    for kernels that launched)."""
    import torch

    def spin(ms):
        torch.cuda._sleep(int(ms * _spin_cycles_per_ms()))

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    held, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    spin(2 * host_ms + 2)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    b.record()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if enqueue_ms < held.elapsed_time(a):
        ms = a.elapsed_time(b) / iters
    else:
        emit({"check": "device_ms", "a_call_at_a_time": repr(fn),
              "enqueue_ms": enqueue_ms, "spin_ms": held.elapsed_time(a)})
        total = 0.0
        for _ in range(iters):
            spin(2 * host_ms / iters + 0.5)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        ms = total / iters
    if not ms > 0:
        raise RuntimeError(f"device_ms: {ms} ms a call")
    return ms


def bound_ms(nbytes, flops, dtype):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------- inputs
def paged_inputs(dtype, dev, gen, *, heads):
    """8 decode rows over the 7B pool: lengths from 0 (a dead row) to a
    near-full cache, scrambled block placement, sentinel table tails, and
    NaN in the unwritten rows of one partial block."""
    H, HKV, D = heads
    import torch
    lengths = torch.tensor([1, 31, 33, 700, 1601, 2500, 4093, 0],
                           dtype=torch.int32)
    pool_k = torch.randn(NB, BS, HKV, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(NB, BS, HKV, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(1))
    tables = torch.full((SLOTS, MB), NB, dtype=torch.int32)
    for b in range(SLOTS):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[b * MB:b * MB + n].to(torch.int32)
    # stale NaN past row 3's length inside its last block
    last = int(tables[3, (700 - 1) // BS])
    pool_k[last, 700 % BS:] = float("nan")
    pool_v[last, 700 % BS:] = float("nan")
    q = torch.randn(SLOTS, H, D, generator=gen, device=dev).to(dtype)
    return q, pool_k, pool_v, tables.to(dev), lengths.to(dev)


def ragged_inputs(dtype, dev, gen, *, heads):
    """The packed tick-0 buffer of the default engine (T = 8 + 512): six
    span-1 decode rows, one 500-token chunk starting mid-block, one dead
    row, and 14 packed rows outside every span."""
    H, HKV, D = heads
    import torch
    _, pool_k, pool_v, tables, _ = paged_inputs(dtype, dev, gen, heads=heads)
    # the decode rows keep their tables; row 5's 500-token chunk ends at
    # 1517 (mid-block) inside the 2500-row table it already has
    qlen = torch.tensor([1, 1, 1, 1, 1, 500, 1, 0], dtype=torch.int32)
    kvlen = torch.tensor([1, 31, 33, 700, 1601, 1517, 4093, 0],
                         dtype=torch.int32)
    qstart = torch.zeros(SLOTS, dtype=torch.int32)
    qstart[1:] = torch.cumsum(qlen, 0)[:-1]
    qp = torch.randn(T_PACKED, H, D, generator=gen, device=dev).to(dtype)
    return (qp, pool_k, pool_v, tables, qstart.to(dev), qlen.to(dev),
            kvlen.to(dev))


def dense_inputs(dtype, dev, gen, hkv=None, *, heads):
    """8 decode rows over the dense-slot engine's [8, 4096] cache: lengths
    from 1 to the full 4096, NaN in every cache row past its length."""
    H, HKV, D = heads
    hkv = HKV if hkv is None else hkv
    import torch
    lengths = [1, 31, 33, 700, 1601, 2500, 4096, 4093]
    k = torch.randn(SLOTS, MAX_SEQ, hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(SLOTS, MAX_SEQ, hkv, D, generator=gen, device=dev).to(dtype)
    for b, n in enumerate(lengths):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    q = torch.randn(SLOTS, H, D, generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


# (qlen, kvlen) per sequence: the spans the ragged redesign makes risky.
# Chunks take 64-row tiles (bf16) whose causal offset kvlen - qlen is
# arbitrary; span-1 rows take the split-KV walk; (0, 0) is a dead row.
RAGGED_EDGE = {
    "spans_2_63_64_65": [(2, 130), (63, 63), (64, 1000), (65, 1601),
                         (1, 33), (0, 0)],
    "chunk_mid_block": [(200, 1217), (1, 700)],      # starts at 1017
    "partial_last_key_tile": [(100, 1000), (3, 70), (1, 4093)],
    # speculative verify spans [last token, drafts]: 3 and 5 rows whose
    # positions cross a block edge, beside a decode row
    "verify_3_5_block_edge": [(3, 33), (5, 66), (5, 1027), (3, 97),
                              (1, 500)],
}
#: the edge cases also held to the same bits on a second launch on the
#: pool of the query type (every case is, on int8 and fp8 pools)
RAGGED_BITS_TWICE = ("verify_3_5_block_edge",)


def ragged_span_inputs(spans, dtype, dev, gen, hkv=None, *, heads):
    """A packed buffer of ``spans`` (7 more rows outside every span) over
    a pool that holds just their blocks: scrambled placement, sentinel
    table tails, NaN in the stale rows of each row's last block."""
    H, HKV, D = heads
    hkv = HKV if hkv is None else hkv
    import torch
    qlen = torch.tensor([q for q, _ in spans], dtype=torch.int32)
    kvlen = torch.tensor([k for _, k in spans], dtype=torch.int32)
    qstart = torch.zeros(len(spans), dtype=torch.int32)
    qstart[1:] = torch.cumsum(qlen, 0)[:-1]
    need = [-(-k // BS) for _, k in spans]
    nb = sum(need) + 1
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(3))
    tables = torch.full((len(spans), max(need) + 2), nb, dtype=torch.int32)
    at = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[at:at + n].to(torch.int32)
        at += n
    pool_k = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    for r, (_, k) in enumerate(spans):
        if k % BS:
            pool_k[int(tables[r, k // BS]), k % BS:] = float("nan")
            pool_v[int(tables[r, k // BS]), k % BS:] = float("nan")
    q = torch.randn(int(qlen.sum()) + 7, H, D, generator=gen,
                    device=dev).to(dtype)
    return (q, pool_k, pool_v, tables.to(dev), qstart.to(dev),
            qlen.to(dev), kvlen.to(dev))


def ragged_working_blocks(qlen, kvlen, g, hkv=None, *, heads=HEADS):
    """Blocks of each grid that do work at head geometry ``heads`` (7B by
    default): every split of a span-1 row that starts inside it (one for
    a row of length 0), and every tile of a chunk span."""
    H, HKV, D = heads
    hkv = HKV if hkv is None else hkv
    split = sum(max(1, -(-k // g["split_len"]))
                for q, k in zip(qlen, kvlen) if q == 1)
    tile = sum(-(-q // g["tile_rows"]) for q in qlen if q >= 2)
    return {"split_blocks": hkv * split, "tile_blocks": H * tile}


def ragged_edge_cases(dtype_name, dev, gen, *, heads):
    """Each of RAGGED_EDGE, and its first case with 8 KV heads, against
    the plain version within TOL; rows outside every span exact zeros."""
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.kernels import ragged_attention
    dtype = getattr(torch, dtype_name)
    errs = {}
    cases = [(name, spans, HKV) for name, spans in RAGGED_EDGE.items()]
    g = _gqa_kv(heads)
    cases.append((f"gqa_{g}_kv_heads", RAGGED_EDGE["spans_2_63_64_65"], g))
    for name, spans, hkv in cases:
        a = ragged_span_inputs(spans, dtype, dev, gen, hkv, heads=heads)
        got = ragged_attention.ragged_paged_attention(*a)
        want = ragged_attention.ragged_attention_reference(*a)
        torch.cuda.synchronize()
        errs[name] = _compare(f"ragged {name}", dtype_name, got, want)
        if name in RAGGED_BITS_TWICE and not torch.equal(
                got, ragged_attention.ragged_paged_attention(*a)):
            raise RuntimeError(f"ragged {name} {dtype_name}: two launches "
                               f"differ")
        used = sum(q for q, _ in spans)
        if not bool((got[used:] == 0).all()):
            raise RuntimeError(f"ragged {name} {dtype_name}: rows outside "
                               f"every span not zero")
    return errs


def flash_inputs(dtype, dev, gen, B=4, S=512, *, heads):
    H, HKV, D = heads
    import torch
    mk = lambda h: torch.randn(B, S, h, D, generator=gen,  # noqa: E731
                               device=dev).to(dtype)
    return mk(H), mk(HKV), mk(HKV)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.LIBRARIES}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def _compare(name, dtype_name, got, want):
    import torch
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name} {dtype_name}: kernel output not finite")
    err = (g - w).abs().max().item()
    ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    if not ok:
        raise RuntimeError(f"{name} {dtype_name}: max abs err {err} "
                           f"exceeds atol {atol} + rtol {rtol}")
    return err


def _compare_scaled(name, dtype_name, got, want):
    """Backward tolerance (``BWD_TOL``): returns (max abs err, max abs err
    over the reference's max abs)."""
    import torch
    atol, rtol = BWD_TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name} {dtype_name}: kernel output not finite")
    scale = w.abs().max().item()
    err = (g - w).abs()
    if not bool((err <= atol * scale + rtol * w.abs()).all()):
        raise RuntimeError(f"{name} {dtype_name}: max abs err "
                           f"{err.max().item()} exceeds {atol} * max|ref| "
                           f"({scale}) + {rtol} * |ref|")
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def bwd_inputs(dtype, dev, gen, B, S, Hk, *, heads):
    """q, k, v, dO from the seed; O and LSE from the flash forward kernel,
    each held against the plain forward at these shapes first (a wrong O
    or LSE would pass unseen into both the kernels and the plain
    backward); delta as the wrapper computes it. Returns the inputs and
    the forward's (O, LSE) max-abs errors."""
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.kernels.flash_attention import (_ref_attention,
                                                          _ref_lse)
    mk = lambda h: torch.randn(B, S, h, D, generator=gen,  # noqa: E731
                               device=dev).to(dtype)
    q, k, v, do = mk(H), mk(Hk), mk(Hk), mk(H)
    o, lse = flash.flash_attention_fwd(q, k, v, True)
    tag = f"flash fwd B={B} S={S} Hk={Hk}"
    dtype_name = str(dtype).split(".")[-1]
    fwd_err = (_compare(tag + " O", dtype_name, o,
                        _ref_attention(q, k, v, True)),
               _compare(tag + " LSE", "float32", lse, _ref_lse(q, k, True)))
    torch.cuda.empty_cache()
    return (q, k, v, do, o, lse, flash.attention_delta(o, do)), fwd_err


def bwd_check(dtype_name, dev, gen, B, S, Hk, *, heads):
    """All three gradients of both backward kernels against the plain
    backward; returns the largest (abs, relative-to-max) error."""
    import torch
    from paddle_tpu_torch.kernels import flash
    (q, k, v, do, o, lse, delta), fwd_err = bwd_inputs(
        getattr(torch, dtype_name), dev, gen, B, S, Hk, heads=heads)
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = flash.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    errs = [_compare_scaled(f"flash bwd {n} B={B} S={S} Hk={Hk}",
                            dtype_name, g, w)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)]
    return {"fwd_o_lse": fwd_err, "bwd": (max(e[0] for e in errs),
                                          max(e[1] for e in errs))}


def bwd_case(name, dtype_name, dev, gen, *, heads):
    """One backward kernel at the training shapes against its plain
    version: error, bitwise repeatability, times, bound. The
    library time is SDPA forward+backward less SDPA forward at the same
    shapes — the pair's yardstick, the same on both rows."""
    H, HKV, D = heads
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    B, S = TRAIN_B, TRAIN_S
    (q, k, v, do, o, lse, delta), fwd_err = bwd_inputs(dtype, dev, gen, B,
                                                       S, HKV, heads=heads)
    args = (q, k, v, do, lse, delta)
    if name == "flash_bwd_dkv":
        run = lambda: flash.flash_bwd_dkv(*args)  # noqa: E731
        plain = lambda: flash.flash_bwd_dkv_reference(*args)  # noqa: E731
        products, out_elems = 4, k.numel() + v.numel()
    else:
        run = lambda: (flash.flash_bwd_dq(*args),)  # noqa: E731
        plain = lambda: (flash.flash_bwd_dq_reference(*args),)  # noqa
        products, out_elems = 3, q.numel()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    errs = [_compare_scaled(name, dtype_name, g, w)
            for g, w in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if not bitwise:
        raise RuntimeError(f"{name} {dtype_name}: two launches differ")
    del got, again, want
    torch.cuda.empty_cache()
    pairs = B * H * S * (S + 1) // 2
    flops = products * 2 * pairs * D
    nbytes = ((2 * q.numel() + 2 * k.numel()) * isz + 2 * 4 * B * H * S
              + out_elems * isz)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib_fb = lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)  # noqa
    with torch.no_grad():
        lib_f = time_ms(sdpa)
    row = {"name": name, "dtype": dtype_name,
           "shape": {"B": B, "S": S, "H": H, "Hk": HKV, "D": D},
           "max_abs_err": max(e[0] for e in errs),
           "max_err_over_max_ref": max(e[1] for e in errs),
           "fwd_o_lse_err": fwd_err,
           "tol": {"atol_x_max_ref": BWD_TOL[dtype_name][0],
                   "rtol": BWD_TOL[dtype_name][1]},
           "bitwise_repeatable": bitwise,
           "ms": time_ms(run, iters=5), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib_fb, iters=5) - lib_f,
           "library": "SDPA fwd+bwd minus SDPA fwd (the pair)",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations"),
           "route": route(name, dtype_name)}
    row["tflops"] = flops / row["ms"] / 1e9
    row["x_library"] = row["ms"] / row["library_ms"]
    # the tail past a non-multiple-of-64 S, and GQA (8 KV heads)
    for tag, (b, s_, hk) in (("tail", (2, 300, HKV)), ("gqa", (2, 512, 8))):
        if name == BWD[0]:
            row[f"{tag}_err"] = bwd_check(dtype_name, dev, gen, b, s_, hk,
                                          heads=heads)
    del qt, kt, vt, q, k, v, do, o, lse, delta
    return row


def _bhsd(B, S, h, dtype, dev, gen, *, heads):
    """A head-major ``[B, h, S, D]`` tensor seen as ``[B, S, h, D]`` (the
    layout the model's bhsd branch hands the kernels)."""
    H, HKV, D = heads
    import torch
    return torch.randn(B, h, S, D, generator=gen, device=dev) \
        .to(dtype).transpose(1, 2)


def _rope_inputs(dtype_name, dev, gen, B, S, Hk, *, heads):
    """Un-rotated head-major q, k, v, dO, the model's [S, D] tables, and
    O and LSE from the rope forward kernel, held against the plain
    forward first (a wrong O or LSE would pass unseen into both
    backwards). Returns the inputs, the rope, and the forward's (O, LSE)
    errors."""
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.models.llama import _rope_tables
    dtype = getattr(torch, dtype_name)
    q, k, v, do = (_bhsd(B, S, h, dtype, dev, gen, heads=heads)
                   for h in (H, Hk, Hk, H))
    rope = _rope_tables(S, D, 10000.0, device=dev)
    o, lse = flash.flash_attention_fwd(q, k, v, True, rope)
    ro, rl = flash.flash_attention_reference(q, k, v, True, rope)
    tag = f"flash[rope] B={B} S={S} Hk={Hk}"
    err = (_compare(tag + " O", dtype_name, o, ro),
           _compare(tag + " LSE", "float32", lse, rl))
    if dtype_name != "float32" and not torch.equal(
            o, flash.flash_attention_fwd(q, k, v, True, rope)[0]):
        raise RuntimeError(f"{tag} {dtype_name}: two launches differ")
    del ro, rl
    torch.cuda.empty_cache()
    return (q, k, v, do, o, lse), rope, err


def _rope_bwd_errs(dtype_name, q, k, v, do, o, lse, rope, tag):
    """Both backward kernels (rope or not) against their plain versions;
    bf16 and fp16 the same bits twice. Returns the largest (abs, over max|ref|)."""
    import torch
    from paddle_tpu_torch.kernels import flash
    delta = flash.attention_delta(o, do)
    got = flash.flash_bwd_dkv(q, k, v, do, lse, delta, True, rope) + (
        flash.flash_bwd_dq(q, k, v, do, lse, delta, True, rope),)
    want = flash.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True,
                                         rope) + (
        flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, rope),)
    torch.cuda.synchronize()
    errs = [_compare_scaled(f"{tag} {n}", dtype_name, g, w)
            for n, g, w in zip(("dk", "dv", "dq"), got, want)]
    # flash_attention_bwd runs one pre-pass for both kernels: the same
    # kernels on the same rotated bits as the two standalone entries
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, lse, do, True, rope)
    if not all(torch.equal(a, b) for a, b in zip(got, (dk, dv, dq))):
        raise RuntimeError(f"{tag} {dtype_name}: flash_attention_bwd differs "
                           f"from the standalone entries")
    if dtype_name != "float32":
        again = flash.flash_bwd_dkv(q, k, v, do, lse, delta, True, rope) + (
            flash.flash_bwd_dq(q, k, v, do, lse, delta, True, rope),)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{tag} {dtype_name}: two launches differ")
    del got, want
    torch.cuda.empty_cache()
    return max(e[0] for e in errs), max(e[1] for e in errs)


def rope_cases(dtype_name, dev, gen, *, heads):
    """The fused-RoPE mode of the three flash kernels at the training
    shape (B=4, S=2048, 32 heads of 128) in the head-major layout, each
    against its plain version (``TOL`` for the forward, ``BWD_TOL`` for
    dK/dV and dQ; bf16 the same bits twice); then a tail with GQA (S=300,
    8 KV heads) in the same mode, and the head-major layout without RoPE
    at the training shape. Times: the rope kernel (a backward row: its
    body on the pair the pre-pass rotated, ``entry_ms`` the standalone
    entry with its own pre-pass); the same kernel without RoPE on inputs
    rotated beforehand; the unfused pair (a torch rotation, then that
    kernel); and the library pair (a torch rotation, then SDPA causal:
    forward for the forward's row, forward+backward less forward for the
    backward rows, the rotation's own backward included). The pre-pass
    ``rope_qk`` gets a row of its own: bit for bit the plain rotation,
    in the inputs' strides, its time and byte bound, and the backward
    pair's total (pre-pass + dK/dV + dQ) beside the library pair.
    Returns ``{name: row}``."""
    H, HKV, D = heads
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.models.llama import _apply_rope_bhsd
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    B, S = TRAIN_B, TRAIN_S
    (q, k, v, do, o, lse), rope, fwd_err = _rope_inputs(
        dtype_name, dev, gen, B, S, HKV, heads=heads)
    bwd_err = _rope_bwd_errs(dtype_name, q, k, v, do, o, lse, rope,
                             f"flash bwd[rope] B={B} S={S}")
    sin, cos = rope
    delta = flash.attention_delta(o, do)
    qr, kr = flash._rotated(q, k, rope)          # rotated beforehand
    # the library pair on [B, H, S, D] contiguous copies (SDPA's layout)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        _apply_rope_bhsd(qt, sin, cos), _apply_rope_bhsd(kt, sin, cos), vt,
        is_causal=True)
    lib_fb = lambda: torch.autograd.grad(  # noqa: E731
        lib_fwd(), (qt, kt, vt), dot)
    with torch.no_grad():
        lib_f = time_ms(lib_fwd, iters=5)
    lib_b = time_ms(lib_fb, iters=5) - lib_f
    pairs = B * H * S * (S + 1) // 2
    tables = 2 * S * D * 4
    adj = lambda g: flash.rope_adjoint(g.float(), sin, cos).to(g.dtype)  # noqa

    def fwd(r, a, b):
        return flash.flash_attention_fwd(a, b, v, True, r)

    def dkv(r, a, b):
        return flash.flash_bwd_dkv(a, b, v, do, lse, delta, True, r)

    def dq(r, a, b):
        return flash.flash_bwd_dq(a, b, v, do, lse, delta, True, r)

    # the backward bodies on the pair one pre-pass rotated (the tables
    # select the adjoint on dK and dQ)
    ops = flash._bwd_operands("rope bwd", q, k, v, do, lse, delta, rope)
    dkv_body = lambda: flash._launch_dkv(*ops, lse, delta, True)  # noqa
    dq_body = lambda: flash._launch_dq(*ops, lse, delta, True)  # noqa

    def pair():       # pre-pass + dK/dV + dQ, delta given
        both = flash._bwd_operands("rope bwd", q, k, v, do, lse, delta,
                                   rope)
        return (flash._launch_dkv(*both, lse, delta, True),
                flash._launch_dq(*both, lse, delta, True))

    # name: (kernel, the standalone entry or None, its unfused
    # counterpart — the forward rotates first, a backward reads the
    # rotated inputs the forward saved and applies the adjoint to its dK
    # or dQ after —, plain version, products a causal pair, bytes without
    # the tables, library pair)
    plan = {
        "flash[rope]": (
            lambda: fwd(rope, q, k), None,
            lambda: fwd(None, *flash._rotated(q, k, rope)),
            lambda: flash.flash_attention_reference(q, k, v, True, rope),
            2, (2 * q.numel() + 2 * k.numel()) * isz + 4 * B * H * S,
            lib_f, "torch rotation + SDPA causal forward"),
        "flash_bwd_dkv[rope]": (
            dkv_body, lambda: dkv(rope, q, k),
            lambda: adj(dkv(None, qr, kr)[0]),
            lambda: flash.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  True, rope),
            4, (2 * q.numel() + 4 * k.numel()) * isz + 8 * B * H * S,
            lib_b, "torch rotation + SDPA fwd+bwd minus the same forward"),
        "flash_bwd_dq[rope]": (
            dq_body, lambda: dq(rope, q, k),
            lambda: adj(dq(None, qr, kr)),
            lambda: flash.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                 True, rope),
            3, (3 * q.numel() + 2 * k.numel()) * isz + 8 * B * H * S,
            lib_b, "torch rotation + SDPA fwd+bwd minus the same forward"),
    }
    prerotated = {"flash[rope]": fwd, "flash_bwd_dkv[rope]": dkv,
                  "flash_bwd_dq[rope]": dq}
    rows = {}
    for name, (run, entry, unfused, plain, products, nbytes, lib,
               lib_what) in plan.items():
        nbytes += tables
        flops = products * 2 * pairs * D
        row = {"name": name, "dtype": dtype_name, "layout": "bhsd",
               "shape": {"B": B, "S": S, "H": H, "Hk": HKV, "D": D},
               "max_abs_err": fwd_err[0] if name == "flash[rope]"
               else bwd_err[0],
               "max_err_over_max_ref": None if name == "flash[rope]"
               else bwd_err[1],
               "fwd_o_lse_err": fwd_err,
               "tol": ({"atol": TOL[dtype_name][0],
                        "rtol": TOL[dtype_name][1]}
                       if name == "flash[rope]" else
                       {"atol_x_max_ref": BWD_TOL[dtype_name][0],
                        "rtol": BWD_TOL[dtype_name][1]}),
               "bitwise_repeatable": dtype_name != "float32",
               "ms": time_ms(run, iters=5),
               "entry_ms": entry and time_ms(entry, iters=5),
               "ms_prerotated": time_ms(
                   lambda: prerotated[name](None, qr, kr), iters=5),
               "unfused_ms": time_ms(unfused, iters=5),
               "plain_ms": time_ms(plain, iters=2),
               "library_ms": lib, "library": lib_what,
               "bytes": nbytes, "flops": flops,
               "bound_ms": bound_ms(nbytes, flops, dtype_name),
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / PEAK_FLOPS[dtype_name]
                            else "operations"),
               "route": route(name, dtype_name)}
        row["x_library"] = row["ms"] / row["library_ms"]
        row["x_prerotated"] = row["ms"] / row["ms_prerotated"]
        rows[name] = row
        torch.cuda.empty_cache()
    del ops
    rows[PRE_PASS] = _pre_pass_row(dtype_name, q, k, rope, qr, kr, pair,
                                   rows, lib_b)
    del qt, kt, vt, dot, qr, kr
    # the head-major layout without RoPE, at the training shape
    row = rows["flash[rope]"]
    from paddle_tpu_torch.kernels.flash_attention import _ref_lse
    o0, lse0 = flash.flash_attention_fwd(q, k, v, True)
    row["bhsd_no_rope_err"] = {
        "fwd": (_compare("flash bhsd O", dtype_name, o0,
                         flash._ref_attention(q, k, v, True)),
                _compare("flash bhsd LSE", "float32", lse0,
                         _ref_lse(q, k, True))),
        "bwd": _rope_bwd_errs(dtype_name, q, k, v, do, o0, lse0, None,
                              "flash bwd bhsd")}
    del q, k, v, do, o, lse, o0, lse0, delta
    torch.cuda.empty_cache()
    # a tail past the 64-row tiles with GQA (8 KV heads), rope on
    (q, k, v, do, o, lse), rope, ferr = _rope_inputs(dtype_name, dev, gen,
                                                      2, 300, 8, heads=heads)
    row["tail_gqa_err"] = {"fwd": ferr, "bwd": _rope_bwd_errs(
        dtype_name, q, k, v, do, o, lse, rope, "flash bwd[rope] S=300")}
    return rows


def _pre_pass_row(dtype_name, q, k, rope, qr, kr, pair, rows, lib_pair):
    """The ``rope_qk`` row: one launch against the plain rotation
    (``qr``, ``kr``), bit for bit and in the inputs' strides; its time,
    the plain version's, its bound (Q and K read and written once, the
    tables read once; three float32 operations an element); then the
    backward pair's total, pre-pass + dK/dV + dQ, timed as one sequence
    and as the sum of its rows, beside the library pair."""
    import torch
    from paddle_tpu_torch.kernels import flash
    sin, cos = rope
    gq, gk = flash.rope_qk(q, k, sin, cos)
    torch.cuda.synchronize()
    err = max((gq.float() - qr.float()).abs().max().item(),
              (gk.float() - kr.float()).abs().max().item())
    if not (torch.equal(gq, qr) and torch.equal(gk, kr)
            and gq.stride() == q.stride() and gk.stride() == k.stride()):
        raise RuntimeError(f"rope_qk {dtype_name}: not rope_rotate's bits "
                           f"in the inputs' strides (max abs err {err})")
    del gq, gk
    isz = q.element_size()
    elems = q.numel() + k.numel()
    nbytes = 2 * elems * isz + 2 * sin.numel() * 4
    flops = 3 * elems
    row = {"name": PRE_PASS, "dtype": dtype_name, "layout": "bhsd",
           "shape": {"B": q.shape[0], "S": q.shape[1], "H": q.shape[2],
                     "Hk": k.shape[2], "D": q.shape[3]},
           "max_abs_err": err, "tol": "bit for bit rope_rotate",
           "bitwise_equal_plain": True,
           "ms": time_ms(lambda: flash.rope_qk(q, k, sin, cos), iters=10),
           "plain_ms": time_ms(lambda: flash._rotated(q, k, rope), iters=5),
           "library_ms": None,
           "library": "none: no one PyTorch call rotates Q and K",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, "float32"),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS["float32"] else "operations"),
           "route": "cuda-core"}
    row["pair_ms"] = time_ms(pair, iters=5)
    row["pair_sum_ms"] = (row["ms"] + rows["flash_bwd_dkv[rope]"]["ms"]
                          + rows["flash_bwd_dq[rope]"]["ms"])
    row["library_pair_ms"] = lib_pair
    row["pair_x_library"] = row["pair_ms"] / lib_pair
    torch.cuda.empty_cache()
    return row


def kernel_case(name, dtype_name, dev, gen, *, heads):
    """One kernel against its plain version: error, times, bound."""
    H, HKV, D = heads
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import decode, flash, paged_decode, \
        ragged_attention
    from paddle_tpu_torch.kernels.flash_attention import _ref_attention
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    if name == "paged_decode":
        q, pk, pv, tbl, lens = paged_inputs(dtype, dev, gen, heads=heads)
        run = lambda: paged_decode.paged_decode_attention(  # noqa: E731
            q, pk, pv, tbl, lens)
        plain = lambda: paged_decode.paged_decode_attention_reference(  # noqa
            q, pk, pv, tbl, lens)
        L = lens.long().cpu()
        kv_rows = int(L.sum())
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * (tbl.numel() + lens.numel()))
        flops = 4 * kv_rows * H * D
        # library: SDPA over the same caches gathered dense (gather and
        # mask built outside the timing), masked by length
        smax = int(L.max())
        nblk = -(-smax // BS)
        idx = tbl[:, :nblk].long().clamp(0, NB - 1)
        kd = pk[idx].reshape(SLOTS, nblk * BS, HKV, D)[:, :smax]
        vd = pv[idx].reshape(SLOTS, nblk * BS, HKV, D)[:, :smax]
        kd = torch.nan_to_num(kd).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(vd).transpose(1, 2).contiguous()
        mask = (torch.arange(smax, device=dev)[None, :]
                < L.clamp(min=1).to(dev)[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=H != HKV)
    elif name == "ragged_attention":
        q, pk, pv, tbl, qs, ql, kl = ragged_inputs(dtype, dev, gen,
                                                   heads=heads)
        run = lambda: ragged_attention.ragged_paged_attention(  # noqa: E731
            q, pk, pv, tbl, qs, ql, kl)
        plain = lambda: ragged_attention.ragged_attention_reference(  # noqa
            q, pk, pv, tbl, qs, ql, kl)
        qlc, klc = ql.long().cpu(), kl.long().cpu()
        live = qlc > 0
        kv_rows = int(klc[live].sum())
        pairs = 0
        for n, k in zip(qlc.tolist(), klc.tolist()):
            pairs += sum(k - n + i + 1 for i in range(n))
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * (tbl.numel() + 3 * SLOTS))
        flops = 4 * pairs * H * D
        # library: SDPA on the spans padded to the longest, causal mask
        # within each span (the same work, padded)
        qmax, kmax = int(qlc.max()), int(klc.max())
        qpad = torch.zeros(SLOTS, H, qmax, D, dtype=dtype, device=dev)
        kpad = torch.zeros(SLOTS, HKV, kmax, D, dtype=dtype, device=dev)
        vpad = torch.zeros_like(kpad)
        mask = torch.zeros(SLOTS, 1, qmax, kmax, dtype=torch.bool,
                           device=dev)
        for r in range(SLOTS):
            n, k = int(qlc[r]), int(klc[r])
            if n == 0:
                mask[r, :, :, 0] = True
                continue
            a = int(qs[r])
            qpad[r, :, :n] = q[a:a + n].transpose(0, 1)
            nblk = -(-k // BS)
            rows = pk[tbl[r, :nblk].long()].reshape(nblk * BS, HKV, D)[:k]
            kpad[r, :, :k] = rows.transpose(0, 1)
            rows = pv[tbl[r, :nblk].long()].reshape(nblk * BS, HKV, D)[:k]
            vpad[r, :, :k] = torch.nan_to_num(rows).transpose(0, 1)
            pos = k - n + torch.arange(qmax, device=dev)
            mask[r, 0] = torch.arange(kmax, device=dev)[None, :] \
                <= pos[:, None]
        kpad = torch.nan_to_num(kpad)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qpad, kpad, vpad, attn_mask=mask, enable_gqa=H != HKV)
    elif name == "decode":
        q, kc, vc, lens = dense_inputs(dtype, dev, gen, heads=heads)
        run = lambda: decode.decode_attention(q, kc, vc, lens)  # noqa
        plain = lambda: decode.decode_attention_reference(  # noqa: E731
            q, kc, vc, lens)
        L = lens.long().cpu()
        kv_rows = int(L.sum())
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * lens.numel())
        flops = 4 * kv_rows * H * D
        # library: SDPA on the cache itself (stale NaN zeroed outside the
        # timing), masked by length
        kd = torch.nan_to_num(kc).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(vc).transpose(1, 2).contiguous()
        mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
                < L.to(dev)[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=H != HKV)
        # GQA: 8 KV heads for the 32 query heads (1 under fewer than 16)
        qg, kg, vg, lg = dense_inputs(dtype, dev, gen, hkv=_gqa_kv(heads),
                                      heads=heads)
        gqa_err = _compare("decode GQA", dtype_name,
                           decode.decode_attention(qg, kg, vg, lg),
                           decode.decode_attention_reference(qg, kg, vg,
                                                             lg))
        del qg, kg, vg
    else:
        q, k, v = flash_inputs(dtype, dev, gen, heads=heads)
        run = lambda: flash.flash_attention(q, k, v, causal=True)  # noqa
        plain = lambda: _ref_attention(q, k, v, True)  # noqa: E731
        B, S = q.shape[0], q.shape[1]
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * isz \
            + 4 * B * H * S
        flops = 4 * B * H * D * S * (S + 1) // 2
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=H != HKV)
        # the tail past a non-multiple-of-64 S must be masked too
        q3, k3, v3 = flash_inputs(dtype, dev, gen, B=2, S=300, heads=heads)
        _compare("flash S=300", dtype_name,
                 flash.flash_attention(q3, k3, v3, causal=True),
                 _ref_attention(q3, k3, v3, True))
        got_lse = flash.flash_attention_fwd(q3, k3, v3, True)[1]
        from paddle_tpu_torch.kernels.flash_attention import _ref_lse
        _compare("flash lse", "float32", got_lse, _ref_lse(q3, k3, True))
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = _compare(name, dtype_name, got, want)
    if name in ("flash", "ragged_attention") and not torch.equal(got, run()):
        raise RuntimeError(f"{name} {dtype_name}: two launches differ")
    extra = {}
    if name == "paged_decode":
        # split-KV: the same bits on a second launch (the splits are
        # combined in split order, whichever block finishes last)
        if not torch.equal(got, run()):
            raise RuntimeError(f"paged_decode {dtype_name}: two launches "
                               f"differ")
        g = paged_decode.LAST_GRID
        extra = {"bitwise_repeatable": True, "split_len": g["split_len"],
                 "n_split": g["n_split"], "grid_blocks": g["blocks"],
                 "active_blocks": HKV * sum(max(1, -(-n // g["split_len"]))
                                            for n in L.tolist())}
    if name == "decode":
        # split-KV over the dense cache: the same bits on a second launch,
        # and a row of length 0 writes zeros (the row of length S_max is
        # in the main inputs)
        if not torch.equal(got, run()):
            raise RuntimeError(f"decode {dtype_name}: two launches differ")
        g = dict(decode.LAST_GRID)
        l0 = lens.clone()
        l0[0] = 0
        got0 = decode.decode_attention(q, kc, vc, l0)
        _compare("decode length 0", dtype_name, got0,
                 decode.decode_attention_reference(q, kc, vc, l0))
        if not bool((got0[0] == 0).all()):
            raise RuntimeError(f"decode {dtype_name}: a row of length 0 "
                               f"is not zero")
        extra = {"bitwise_repeatable": True, "split_len": g["split_len"],
                 "n_split": g["n_split"], "grid_blocks": g["blocks"],
                 "active_blocks": HKV * sum(max(1, -(-n // g["split_len"]))
                                            for n in L.tolist()),
                 "gqa_err": gqa_err}
    if name == "ragged_attention":
        g = dict(ragged_attention.LAST_GRID)
        extra = {"grid": g,
                 "working": ragged_working_blocks(qlc.tolist(), klc.tolist(),
                                                  g, heads=heads),
                 "edge_err": ragged_edge_cases(dtype_name, dev, gen,
                                               heads=heads)}
    row = {"name": name, "dtype": dtype_name, "max_abs_err": err, **extra,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name])),
           "ms": time_ms(run), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib), "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations"),
           "route": route(name, dtype_name)}
    row["tflops"] = flops / row["ms"] / 1e9
    row["x_library"] = row["ms"] / row["library_ms"]
    row["device_ms"] = device_ms(run)
    if name == "flash":
        # the forward and its SDPA yardstick at the training shape too
        del q, k, v, qt, kt, vt, got, want
        q, k, v = flash_inputs(dtype, dev, gen, B=TRAIN_B, S=TRAIN_S,
                               heads=heads)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * TRAIN_B * H * D * TRAIN_S * (TRAIN_S + 1) // 2
        row["train_shape"] = {"B": TRAIN_B, "S": TRAIN_S, "flops": flops,
                              "bound_ms": bound_ms(0, flops, dtype_name)}
        row["ms_train_shape"] = time_ms(
            lambda: flash.flash_attention(q, k, v, causal=True), iters=5)
        row["plain_ms_train_shape"] = time_ms(
            lambda: _ref_attention(q, k, v, True), iters=2)
        row["library_ms_train_shape"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=H != HKV))
        row["tflops_train_shape"] = flops / row["ms_train_shape"] / 1e9
        row["x_library_train_shape"] = (row["ms_train_shape"]
                                        / row["library_ms_train_shape"])
    return row


def tick_inputs(dtype, dev, gen, layers, pools=None, rows=SLOTS,
                lens=None, *, heads):
    """One tail tick on the default pool (block 32, 4096-row tables):
    at 8 rows, lengths from 0 to a near-full cache, row 7 masked (idle),
    row 3 sampled (T 0.8, top-k 40); at more rows, seeded lengths 0..800
    with every 9th row masked and every 5th sampled; scrambled block
    placement with sentinel tails; pools ``[layers, 1024, 32, 32, 128]``
    from the seed unless given. ``lens`` overrides the lengths."""
    H, HKV, D = heads
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import _rope_tables
    r = np.random.RandomState(3 if rows == SLOTS else rows)
    if rows == SLOTS:
        base = np.array([1, 31, 33, 700, 1601, 2500, 4093, 0], np.int32)
        app = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.int32)
        temps = np.array([0, 0, 0, 0.8, 0, 0, 0, 0], np.float32)
        topks = np.array([0, 0, 0, 40, 0, 0, 0, 0], np.int32)
    else:
        base = r.randint(0, 801, rows).astype(np.int32)
        app = (np.arange(rows) % 9 != 8).astype(np.int32)
        temps = np.where(np.arange(rows) % 5 == 3, 0.8, 0).astype(np.float32)
        topks = np.where(temps > 0, 40, 0).astype(np.int32)
    lens = base if lens is None else np.asarray(lens, np.int32)
    perm = np.random.RandomState(2).permutation(NB)
    tables = np.full((rows, MB), NB, np.int32)
    at = 0
    for b in range(rows):
        n = -(-int(lens[b] + app[b]) // BS)
        at = b * MB if rows == SLOTS else at
        tables[b, :n] = perm[at:at + n]
        at += n
    if at > NB:
        raise ValueError(f"{rows} rows need {at} blocks of the pool's {NB}")
    if pools is None:
        pools = tuple(torch.randn(layers, NB, BS, HKV, D, generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
    keys = r.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64).astype(
        np.int64)
    tok = torch.from_numpy(r.randint(0, 32000, rows)).to(dev)
    sin, cos = _rope_tables(MB * BS, D, 10000.0, device=dev)
    return dict(tables=tables, tables_dev=torch.from_numpy(tables).to(dev),
                sin=sin, cos=cos, tok=tok, pool_k=pools[0],
                pool_v=pools[1], lens=lens, kys=keys, app_mask=app,
                temps=temps, top_ks=topks)


def _meta_on_card(t):
    """Tick inputs ``t`` with the rows' lengths, append mask, top-k,
    temperatures and keys on the card, as the multi-tick tail keeps them:
    the fused tick's wrapper then copies nothing from the host and waits
    on nothing, so ``device_ms`` can keep the host ahead of the card."""
    import numpy as np
    import torch
    dev = t["tok"].device

    def card(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(dtype))).to(dev)
    keys = np.asarray(t["kys"], np.int64).astype(np.uint32).view(np.int32)
    return dict(t, lens=card(t["lens"], np.int32),
                app_mask=card(t["app_mask"], np.int32),
                top_ks=card(t["top_ks"], np.int32),
                temps=card(t["temps"], np.float32), kys=card(keys, np.int32))


def _weight_bytes(w, isz):
    """Bytes of a weight: dense at the model type, or an int8 pair (int8
    data and float32 scales)."""
    if isinstance(w, tuple):
        return w[0].numel() + 4 * w[1].numel()
    return w.numel() * isz


def kv_row_bytes(pool, isz, *, heads):
    """Bytes one cached (row, KV head) of K or of V costs in ``pool``: D
    at the model type, D + a float32 scale (int8), or D (e4m3; its
    per-block scales are counted by block)."""
    H, HKV, D = heads
    if not isinstance(pool, tuple):
        return D * isz
    return D + (4 if pool[0].dtype.itemsize == 1 and pool[1].dim() == 4
                else 0)


def tick_cost(params, t, layers, isz, *, heads):
    """(bytes, flops) one tick must move and do: every weight once (int8
    pairs at 1 byte and their scales), each valid cached K/V row once (at
    the pool's storage type, with its scales), the appended rows and the
    float32 logits written once; two flops per weight and row, 4*D per
    head and key."""
    H, HKV, D = heads
    import numpy as np
    att = t["lens"] + t["app_mask"]
    keys = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "input_ln",
            "post_ln", "final_norm", "lm_head")
    R = len(att)
    V = params["embed"].shape[0]
    rb = kv_row_bytes(t["pool_k"], isz, heads=heads)
    fp8 = isinstance(t["pool_k"], tuple) and t["pool_k"][1].dim() == 3
    blocks = sum(-(-int(n) // BS) for n in att)
    nbytes = (sum(_weight_bytes(params[k], isz) for k in keys)
              + R * params["embed"].shape[1] * isz
              + int(att.sum()) * HKV * rb * 2 * layers
              + (blocks * HKV * 4 * 2 * layers if fp8 else 0)
              + int(np.sum(t["app_mask"])) * HKV * rb * 2 * layers
              + R * V * 4)
    proj = sum((params[k][0] if isinstance(params[k], tuple)
                else params[k]).numel()
               for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                         "lm_head"))
    flops = 2 * R * proj + 4 * int(att.sum()) * H * D * layers
    return nbytes, flops


def _tick(fn, params, tied, t, *, heads, **kw):
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.serving.decode import _dq_head
    with torch.inference_mode():
        return fn(params, _dq_head(params, tied, params["embed"].dtype), **t,
                  nh=H, nkv=HKV, hd=D, eps=1e-5, **kw)


def _scanned_tick(params, head, *, pool_k, pool_v, **kw):
    """``serving/decode.py``'s scanned tick on one shard (the serving
    programs take per-shard lists), its pools handed back as given."""
    from paddle_tpu_torch.serving.decode import _fused_decode_tick
    out = _fused_decode_tick([params], head, pool_k=[pool_k],
                             pool_v=[pool_v], **kw)
    return (out[0], out[1][0], out[2][0]) + tuple(out[3:])


def _clone_pool(pool):
    return tuple(x.clone() for x in pool) if isinstance(pool, tuple) \
        else pool.clone()


# LLaMA-7B widths at 2 layers for the fused tick's kernel check, at the
# default 8 rows and at 37 (past the 16 rows the kernel once took, and not
# a multiple of its 8-row tiles)
FUSED_LAYERS = 2
FUSED_WIDE_ROWS = 37


# The fused tick against its plain version: float32 holds TOL (summation
# order only). A bf16 tick rounds every projection to bf16, and layer 1's
# attention output already differs by an ulp where the kernel rounds P per
# 32-key tile and the plain version rounds the normalised P; the later
# layers and the logits carry that several ulps further. The unfused tick
# through the paged decode kernel misses TOL against the same plain version
# too (0.0625 on these inputs, H100), so bf16 is held to TOL's numbers
# scaled by each tensor's largest entry, the form of BWD_TOL.
def _compare_tick(name, dtype_name, got, want):
    if dtype_name == "float32":
        return _compare(name, dtype_name, got, want)
    return _compare_scaled(name, dtype_name, got, want)[0]


# The fused tick's float32 logits on a quantized pool, kernel against
# plain: |err| <= QUANT_F32_LOGITS * max|ref|. The write rule re-rounds a
# last-place difference of a float32 projection to a full step of the
# appended row (1/127 of its absmax, or an e4m3 step), which the next
# layers carry to the logits, so TOL's float32 numbers do not hold. The
# limit is about twice the largest of 56 readings (4.5e-3, an fp8 pool at 37
# rows; the rest at most 1.5e-3), the four quantized pool variants over
# QUANT_SWEEP_SEEDS + 1 pools each at 8 and 37 rows (PERF.md section 2,
# H100); the planted faults of ``_planted_faults`` (a dropped V scale, a
# neighbouring head's K scale) read 0.49 to 1.53, so each misses it. bf16
# takes the scaled bound of the unquantized tick.
QUANT_F32_LOGITS = 1e-2
QUANT_SWEEP_SEEDS = 6


def _quant_logits(label, dtype_name, got, want):
    """A quantized pool's logits, kernel against plain: float32 within
    ``QUANT_F32_LOGITS`` of the reference's max, bf16 within the scaled
    bf16 bound. Returns (max abs err, over max|ref|)."""
    import torch
    if dtype_name != "float32":
        return _compare_scaled(label, dtype_name, got, want)
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{label} float32: kernel output not finite")
    err = (g - w).abs().max().item()
    rel = err / max(w.abs().max().item(), 1e-30)
    if rel > QUANT_F32_LOGITS:
        raise RuntimeError(f"{label} float32: max abs err {err} is {rel} "
                           f"of max|ref|, past {QUANT_F32_LOGITS}")
    return err, rel


def _quant_step(data, scale):
    """Each value of a quantized pool and the size of one step of its grid
    there: int8 ``(q * scale, scale)`` per row and KV head, e4m3 the value
    and 2^-3 of its binade (its planes are left out: both sides share
    them)."""
    import torch
    v = data.float()
    if data.dtype == torch.int8:
        return v * scale[..., None], scale[..., None].expand_as(v)
    return v, torch.exp2(torch.floor(torch.log2(v.abs().clamp(
        min=2.0 ** -6))) - 3)


def _appended_quant(label, dtype_name, got, want, near_tie=False):
    """A quantized pool's appended rows ``[L, rows, ...]``, kernel against
    plain. The write rule re-rounds the projections' differences to the
    grid: float32 values (last-place apart) at most one step apart and
    int8 scales within TOL; bf16 values (bf16 GEMVs, several ulps apart
    as the unquantized appended rows are) within the scaled bound of the
    unquantized tick plus one step. With ``near_tie`` float32 holds layer
    0 (whose inputs differ in the last place only) to one step, and the
    later layers (whose inputs carry a re-rounded step: a short row
    attends mostly to its own appended row) to ``QUANT_F32_LOGITS`` of
    their largest value plus a step. Returns the largest difference in
    steps."""
    import torch
    (g, _), (w, step) = _quant_step(*got), _quant_step(*want)
    # on the grid: int8 units of the stored values, e4m3 steps of the value
    steps = ((got[0].float() - want[0].float()).abs()
             if got[0].dtype == torch.int8 else (g - w).abs() / step)
    if not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{label} {dtype_name}: appended values not "
                           f"finite")
    if dtype_name == "float32" and near_tie:
        if got[0].dtype == torch.int8:
            _compare(f"{label} layer-0 scales", dtype_name, got[1][0],
                     want[1][0])
        bound = QUANT_F32_LOGITS * w[1:].abs().max() + step[1:]
        if steps[0].max().item() > 1 or not bool(
                ((g[1:] - w[1:]).abs() <= bound).all()):
            raise RuntimeError(f"{label} float32: appended values "
                               f"{steps.max().item()} steps apart, past "
                               f"one step at layer 0 or the limit later")
    elif dtype_name == "float32":
        if got[0].dtype == torch.int8:
            _compare(f"{label} scales", dtype_name, got[1], want[1])
        if steps.max().item() > 1:
            raise RuntimeError(f"{label} float32: appended values "
                               f"{steps.max().item()} steps apart")
    else:
        atol, rtol = TOL[dtype_name]
        bound = atol * w.abs().max() + rtol * w.abs() + step
        if not bool(((g - w).abs() <= bound).all()):
            raise RuntimeError(f"{label} {dtype_name}: appended values "
                               f"{steps.max().item()} steps apart, past "
                               f"the scaled bound plus a step")
    return steps.max().item()


def _fused_vs_plain(p, tied, t, dtype_name, label, near_tie=False, *, heads):
    """One fused tick against its plain version on copies of ``t``'s
    pools: keys bit for bit, tokens equal in float32, logits and the
    appended K/V rows within the tolerance, nothing written outside the
    appended rows (data or scales). A quantized pool's logits are held by
    ``_quant_logits`` (its write rule re-rounds the projections'
    last-place differences to a full step of a row's K/V) and its
    appended rows by ``_appended_quant``. With ``near_tie`` (greedy rows
    only) a float32 token may differ where its logits are within the
    limit: each row's token must then be the argmax of the kernel's own
    logits, so the plain run's two picks lie within twice the logits
    error. Returns (logits err, appended rows err, tokens equal, logits
    of the plain version)."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.serving.decode import _keys_host
    base_k, base_v = t["pool_k"], t["pool_v"]
    quant = isinstance(base_k, tuple)
    got = _tick(fdt.fused_decode_tick, p, tied,
                dict(t, pool_k=_clone_pool(base_k),
                     pool_v=_clone_pool(base_v)), return_logits=True,
                heads=heads)
    want = _tick(fdt.fused_decode_tick_reference, p, tied,
                 dict(t, pool_k=_clone_pool(base_k),
                      pool_v=_clone_pool(base_v)), return_logits=True,
                 heads=heads)
    torch.cuda.synchronize()
    tokens_equal = got[0].tolist() == want[0].tolist()
    if not bool((_keys_host(got[3]) == _keys_host(want[3])).all()):
        raise RuntimeError(f"fused tick {label} {dtype_name}: keys differ")
    if dtype_name == "float32" and not tokens_equal and not (
            near_tie and not bool(t["temps"].any()) and torch.equal(
                got[0], got[4].argmax(-1))):
        raise RuntimeError(f"fused tick {label} float32: tokens "
                           f"{got[0].tolist()} vs plain {want[0].tolist()}")
    if quant:
        logits_err = _quant_logits(f"fused tick {label} logits",
                                   dtype_name, got[4], want[4])[0]
    else:
        logits_err = _compare_tick(f"fused tick {label} logits", dtype_name,
                                   got[4], want[4])
    # the appended rows: live rows at (table[len // bs], len % bs)
    live = [b for b in range(len(t["lens"])) if t["app_mask"][b]]
    dev = (base_k[0] if quant else base_k).device
    phys = torch.tensor([int(t["tables"][b, t["lens"][b] // BS])
                         for b in live], device=dev)
    prow = torch.tensor([int(t["lens"][b] % BS) for b in live], device=dev)
    sides = (("K", got[1], want[1], base_k), ("V", got[2], want[2], base_v))
    def sel(x):     # data and int8 per-row planes: the appended rows
        return x[:, phys, prow] if x.dim() >= 4 else x

    if quant:
        rows_err = max(_appended_quant(
            f"fused tick {label} appended {n}", dtype_name,
            [sel(x) for x in g], [sel(x) for x in w], near_tie)
            for n, g, w, _ in sides)
    else:
        rows_err = max(_compare_tick(f"fused tick {label} appended {n}",
                                     dtype_name, g[:, phys, prow],
                                     w[:, phys, prow])
                       for n, g, w, _ in sides)
    for _, g, _, b in sides:
        for gx, bx in (zip(g, b) if quant else ((g, b),)):
            untouched = gx.clone()
            if gx.dim() >= 4:     # data, or an int8 pool's per-row planes
                untouched[:, phys, prow] = bx[:, phys, prow]
            if not torch.equal(untouched.view(torch.uint8)
                               if untouched.dtype == torch.float8_e4m3fn
                               else untouched,
                               bx.view(torch.uint8)
                               if bx.dtype == torch.float8_e4m3fn else bx):
                raise RuntimeError(f"fused tick {label} {dtype_name} wrote "
                                   f"outside the appended rows")
    return logits_err, rows_err, tokens_equal, want[4]


def _layer0_attention_bits(p, tied, t, *, heads):
    """The fused tick's attention output at layer 0 (a one-layer tick:
    the stacked weights and pools cut to their first layer) against the
    paged decode kernel at the tick's own q and updated pool: True when
    bit for bit equal."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.kernels import paged_decode
    from paddle_tpu_torch.models.llama import STACK_KEYS
    def first(x):
        return tuple(y[:1] for y in x) if isinstance(x, tuple) else x[:1]
    p1 = {k: first(v) if k in STACK_KEYS else v for k, v in p.items()}
    t1 = dict(t, pool_k=_clone_pool(first(t["pool_k"])),
              pool_v=_clone_pool(first(t["pool_v"])))
    _tick(fdt.fused_decode_tick, p1, tied, t1, heads=heads)
    q, attn = fdt.LAST_SCRATCH["q"], fdt.LAST_SCRATCH["attn"]
    quant = isinstance(t1["pool_k"], tuple)
    k0, v0 = (t1["pool_k"][0][0], t1["pool_v"][0][0]) if quant else \
        (t1["pool_k"][0], t1["pool_v"][0])
    scales = (t1["pool_k"][1][0], t1["pool_v"][1][0]) if quant else ()
    with torch.inference_mode():
        want = paged_decode.paged_decode_attention(
            q, k0, v0, t["tables_dev"], t["lens"] + t["app_mask"], *scales)
    torch.cuda.synchronize()
    same = bool(torch.equal(attn, want))
    del t1, p1
    return same


def fused_case(name, dtype_name, dev, gen, *, heads, config=None):
    """The fused tick kernel against its plain version (the scanned tick
    with the plain paged attention) at the widths of ``config`` (else
    llama_7b's at ``heads``), 2 layers, at 8 and at 37 rows (``_fused_vs_plain``); the layer-0 attention bit for bit
    against paged decode at both; kernel, plain and scanned-tick (the
    kernels' tick without fusion) milliseconds, the grid and the byte
    bound."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_7b,
                                               llama_decode_params)
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    cfg = dataclasses.replace(
        config or llama_7b(**_heads_kw(heads)),
        num_hidden_layers=FUSED_LAYERS, dtype=dtype_name)
    model = LlamaForCausalLM(cfg, device=dev, seed=6)
    p, tied = llama_decode_params(model)
    t = tick_inputs(dtype, dev, gen, FUSED_LAYERS, heads=heads)
    logits_err, rows_err, tokens_equal, want_logits = _fused_vs_plain(
        p, tied, t, dtype_name, "8 rows", heads=heads)
    # the yardstick of that spread: the unfused tick through the kernels
    scan = _tick(_scanned_tick, p, tied,
                 dict(t, pool_k=t["pool_k"].clone(),
                      pool_v=t["pool_v"].clone()), return_logits=True,
                 heads=heads)
    scan_err = (scan[4] - want_logits).abs().max().item()
    del scan, want_logits
    bits = _layer0_attention_bits(p, tied, t, heads=heads)
    twice = [_tick(fdt.fused_decode_tick, p, tied,
                   dict(t, pool_k=t["pool_k"].clone(),
                        pool_v=t["pool_v"].clone()), return_logits=True,
                   heads=heads)
             for _ in range(2)]
    # tokens, pools and logits (the keys are checked against plain above)
    if not all(torch.equal(twice[0][i], twice[1][i]) for i in (0, 1, 2, 4)):
        raise RuntimeError(f"fused tick {dtype_name}: two launches differ")
    del twice
    torch.cuda.empty_cache()
    run_t = dict(t, pool_k=t["pool_k"].clone(), pool_v=t["pool_v"].clone())
    card_t = _meta_on_card(run_t)
    nbytes, flops = tick_cost(p, t, FUSED_LAYERS, isz, heads=heads)
    row = {"name": name, "dtype": dtype_name,
           "layers": FUSED_LAYERS, "rows": SLOTS,
           "max_abs_err": max(logits_err, rows_err),
           "logits_err": logits_err, "appended_rows_err": rows_err,
           "unfused_kernels_vs_plain_logits_err": scan_err,
           "tokens_equal": tokens_equal, "keys_equal": True,
           "layer0_attention_equals_paged_decode": bits,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name])),
           "ms": time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied,
                                       run_t, heads=heads)),
           "device_ms": device_ms(lambda: _tick(fdt.fused_decode_tick, p,
                                                tied, card_t, heads=heads)),
           **{k: fdt.LAST_GRID[k] for k in ("blocks_per_sm", "split_len",
                                             "n_split")},
           "grid_blocks": fdt.LAST_GRID["blocks"],
           "plain_ms": time_ms(lambda: _tick(
               fdt.fused_decode_tick_reference, p, tied, run_t,
               heads=heads), iters=3),
           "scanned_tick_ms": time_ms(lambda: _tick(
               _scanned_tick, p, tied, run_t, heads=heads)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes a tick",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations")}
    del run_t, card_t, t
    torch.cuda.empty_cache()
    # past the old row cap: 37 rows, lengths 0..800
    t = tick_inputs(dtype, dev, gen, FUSED_LAYERS, rows=FUSED_WIDE_ROWS,
                    heads=heads)
    w_logits, w_rows, w_tokens, _ = _fused_vs_plain(
        p, tied, t, dtype_name, f"{FUSED_WIDE_ROWS} rows", heads=heads)
    w_bits = _layer0_attention_bits(p, tied, t, heads=heads)
    run_t = dict(t, pool_k=t["pool_k"].clone(), pool_v=t["pool_v"].clone())
    nbytes, flops = tick_cost(p, t, FUSED_LAYERS, isz, heads=heads)
    row["wide"] = {
        "rows": FUSED_WIDE_ROWS, "logits_err": w_logits,
        "appended_rows_err": w_rows, "tokens_equal": w_tokens,
        "keys_equal": True, "layer0_attention_equals_paged_decode": w_bits,
        "ms": time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, run_t,
                                    heads=heads)),
        "grid_blocks": fdt.LAST_GRID["blocks"],
        "blocks_per_sm": fdt.LAST_GRID["blocks_per_sm"],
        "scanned_tick_ms": time_ms(lambda: _tick(
            _scanned_tick, p, tied, run_t, heads=heads)),
        "bytes": nbytes, "bound_ms": bound_ms(nbytes, flops, dtype_name)}
    row["max_abs_err"] = max(row["max_abs_err"], w_logits, w_rows)
    if not (bits and w_bits):
        raise RuntimeError(f"fused tick {dtype_name}: layer-0 attention "
                           f"differs from paged decode (8 rows: {bits}, "
                           f"{FUSED_WIDE_ROWS} rows: {w_bits})")
    del model, p, t, run_t
    return row


# ------------------------------------------------------- quantized modes
#: the quantized pools' modes, and the kernels that have them
QUANT_MODES = ("int8", "fp8")
QUANT_KERNELS = ("paged_decode", "ragged_attention", "fused_decode_tick")


def quantize_pool(pk, pv, mode, gen):
    """Float pools (stale NaN allowed) → ``(kd, vd, k_scale, v_scale)`` by
    the pool's write rule: int8 per row and KV head, or the saturating
    e4m3 cast with per-block planes drawn from [0.5, 2) (the engine keeps
    them 1.0; other values make the kernels' plane reads count)."""
    import torch
    from paddle_tpu_torch.serving.kv_cache import (quantize_kv_rows,
                                                   quantize_kv_rows_fp8)
    k, v = torch.nan_to_num(pk.float()), torch.nan_to_num(pv.float())
    if mode == "int8":
        (kd, ks), (vd, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        return kd, vd, ks, vs
    shape = k.shape[:-3] + k.shape[-2:-1]
    ks, vs = (0.5 + 1.5 * torch.rand(shape, generator=gen, device=k.device)
              for _ in range(2))
    return quantize_kv_rows_fp8(k), quantize_kv_rows_fp8(v), ks, vs


def _gather_dequant(kd, ks, tbl_row, n, *, heads):
    """The first ``n`` cached rows of a sequence, gathered narrow through
    its table with their scales ``([n, Hkv, D], [n, Hkv])``."""
    H, HKV, D = heads
    import torch
    nblk = -(-n // BS)
    idx = tbl_row[:nblk].long().clamp(0, kd.shape[0] - 1)
    rows = kd.view(torch.uint8)[idx].view(kd.dtype).reshape(
        nblk * BS, HKV, D)[:n]
    sc = ks[idx]
    sc = (sc.repeat_interleave(BS, dim=0) if ks.dim() == 2
          else sc.reshape(nblk * BS, HKV))[:n]
    return rows, sc


def quant_kernel_case(name, mode, dtype_name, dev, gen, *, heads):
    """Paged decode or ragged attention on a quantized pool (the serving
    shapes of ``kernel_case``) against its plain version within TOL:
    error, kernel / plain / library milliseconds (the library yardstick
    dequantizes the gathered cache, then SDPA), the byte bound at the
    pool's storage type with its scales."""
    H, HKV, D = heads
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import paged_decode, ragged_attention
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    rb = D + (4 if mode == "int8" else 0)    # a (row, KV head) of K or V
    if name == "paged_decode":
        q, pk, pv, tbl, lens = paged_inputs(dtype, dev, gen, heads=heads)
        kd, vd, ks, vs = quantize_pool(pk, pv, mode, gen)
        del pk, pv
        run = lambda: paged_decode.paged_decode_attention(  # noqa: E731
            q, kd, vd, tbl, lens, ks, vs)
        plain = lambda: paged_decode.paged_decode_attention_reference(  # noqa
            q, kd, vd, tbl, lens, ks, vs)
        L = lens.long().cpu()
        spans = [(1, int(n)) for n in L.tolist()]
        qrows = [(b, b) for b in range(SLOTS)]
        flops = 4 * int(L.sum()) * H * D
    else:
        q, pk, pv, tbl, qs, ql, kl = ragged_inputs(dtype, dev, gen,
                                                   heads=heads)
        kd, vd, ks, vs = quantize_pool(pk, pv, mode, gen)
        del pk, pv
        run = lambda: ragged_attention.ragged_paged_attention(  # noqa
            q, kd, vd, tbl, qs, ql, kl, ks, vs)
        plain = lambda: ragged_attention.ragged_attention_reference(  # noqa
            q, kd, vd, tbl, qs, ql, kl, ks, vs)
        spans = list(zip(ql.tolist(), kl.tolist()))
        qrows = [(int(a), int(a) + n - 1) for a, (n, _) in
                 zip(qs.tolist(), spans)]
        flops = 4 * sum(sum(k - n + i + 1 for i in range(n))
                        for n, k in spans) * H * D
    kv_rows = sum(k for n, k in spans if n > 0)
    blocks = sum(-(-k // BS) for n, k in spans if n > 0)
    nbytes = (2 * kv_rows * HKV * rb
              + (2 * blocks * HKV * 4 if mode == "fp8" else 0)
              + 2 * sum(b - a + 1 for (a, b), (n, _) in zip(qrows, spans)
                        if n > 0) * H * D * isz
              + 4 * (tbl.numel() + 3 * SLOTS))
    # library: the spans padded to the longest, the narrow rows and their
    # scales gathered outside the timing; the call dequantizes them, then
    # SDPA (causal within each span)
    live = [r for r, (n, _) in enumerate(spans) if n > 0]
    qmax = max(n for n, _ in spans)
    kmax = max(k for _, k in spans)
    qpad = torch.zeros(SLOTS, H, qmax, D, dtype=dtype, device=dev)
    kpad = torch.zeros(SLOTS, kmax, HKV, D, dtype=torch.uint8, device=dev)
    vpad = torch.zeros_like(kpad)
    kspad = torch.zeros(SLOTS, kmax, HKV, device=dev)
    vspad = torch.zeros_like(kspad)
    mask = torch.zeros(SLOTS, 1, qmax, kmax, dtype=torch.bool, device=dev)
    for r in range(SLOTS):
        n, k = spans[r]
        if n == 0:
            mask[r, :, :, 0] = True
            continue
        a = qrows[r][0]
        qpad[r, :, :n] = q[a:a + n].transpose(0, 1)
        for pad, spad, pool, pl_ in ((kpad, kspad, kd, ks),
                                     (vpad, vspad, vd, vs)):
            rows, sc = _gather_dequant(pool, pl_, tbl[r], k, heads=heads)
            pad[r, :k] = rows.view(torch.uint8)
            spad[r, :k] = sc
        pos = k - n + torch.arange(qmax, device=dev)
        mask[r, 0] = torch.arange(kmax, device=dev)[None, :] <= pos[:, None]

    def lib():
        kf = (kpad.view(kd.dtype).float() * kspad[..., None]).to(dtype)
        vf = (vpad.view(kd.dtype).float() * vspad[..., None]).to(dtype)
        return F.scaled_dot_product_attention(
            qpad, kf.transpose(1, 2), vf.transpose(1, 2), attn_mask=mask,
            enable_gqa=H != HKV)

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = _compare(f"{name} {mode}", dtype_name, got, want)
    row = {"name": name, "mode": mode, "dtype": dtype_name,
           "max_abs_err": err,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name]))}
    # both kernels' quantized modes give the same bits on a second launch
    if not torch.equal(got, run()):
        raise RuntimeError(f"{name} {mode} {dtype_name}: two launches "
                           f"differ")
    row["bitwise_repeatable"] = True
    if name == "paged_decode":
        if not bool((got[SLOTS - 1] == 0).all()):
            raise RuntimeError(f"paged_decode {mode}: a row of length 0 "
                               f"is not zero")
        row["split_len"] = paged_decode.LAST_GRID["split_len"]
        row["edge_err"] = quant_paged_edge_cases(mode, dtype_name, dev, gen,
                                                 heads=heads)
    else:
        row["grid"] = dict(ragged_attention.LAST_GRID)
        _chunk_tile(row["grid"], dtype, f"ragged {mode} {dtype_name}")
        row["edge_err"] = quant_edge_cases(mode, dtype_name, dev, gen,
                                           heads=heads)
    row["device_ms"] = device_ms(run)
    row.update({"ms": time_ms(run), "plain_ms": time_ms(plain, iters=3),
                "library_ms": time_ms(lib), "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms(nbytes, flops, dtype_name),
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / PEAK_FLOPS[dtype_name]
                             else "operations"),
                "route": "cuda-core: quantized split-KV walk"
                         + (", " + QUANT_CHUNK_ROUTE[dtype_name] if name ==
                            "ragged_attention" else "")})
    row["x_library"] = row["ms"] / row["library_ms"]
    return row


#: how ragged attention's chunk spans run on a quantized pool, by query type
QUANT_CHUNK_ROUTE = {
    "bfloat16": "wgmma chunk tile, narrow tiles converted in shared memory",
    "float32": "CUDA-core chunk tile"}


def _chunk_tile(grid, dtype, label):
    """A ragged call's chunks ran on the tile of the query type (the wgmma
    tile's 64 rows in bf16, the CUDA-core tile's 16 in float32), whatever
    the pool."""
    from paddle_tpu_torch.kernels import ragged_attention
    if grid["tile_rows"] != ragged_attention.TILE_ROWS[dtype]:
        raise RuntimeError(f"{label}: chunks ran {grid['tile_rows']}-row "
                           f"tiles, not the {dtype} tile's "
                           f"{ragged_attention.TILE_ROWS[dtype]}")


def quant_edge_cases(mode, dtype_name, dev, gen, *, heads):
    """``RAGGED_EDGE``'s spans (and the first with 8 KV heads) on a
    quantized pool against the plain version within TOL, chunks on the
    query type's tile (bf16: the wgmma tile) and the same bits on a
    second launch; rows outside every span exact zeros."""
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.kernels import ragged_attention
    dtype = getattr(torch, dtype_name)
    errs = {}
    cases = [(name, spans, HKV) for name, spans in RAGGED_EDGE.items()]
    g = _gqa_kv(heads)
    cases.append((f"gqa_{g}_kv_heads", RAGGED_EDGE["spans_2_63_64_65"], g))
    for name, spans, hkv in cases:
        q, pk, pv, tbl, qs, ql, kl = ragged_span_inputs(spans, dtype, dev,
                                                        gen, hkv, heads=heads)
        kd, vd, ks, vs = quantize_pool(pk, pv, mode, gen)
        a = (q, kd, vd, tbl, qs, ql, kl, ks, vs)
        got = ragged_attention.ragged_paged_attention(*a)
        _chunk_tile(ragged_attention.LAST_GRID, dtype,
                    f"ragged {mode} {name} {dtype_name}")
        want = ragged_attention.ragged_attention_reference(*a)
        torch.cuda.synchronize()
        errs[name] = _compare(f"ragged {mode} {name}", dtype_name, got, want)
        if not torch.equal(got, ragged_attention.ragged_paged_attention(*a)):
            raise RuntimeError(f"ragged {mode} {name} {dtype_name}: two "
                               f"launches differ")
        if not bool((got[sum(n for n, _ in spans):] == 0).all()):
            raise RuntimeError(f"ragged {mode} {name} {dtype_name}: rows "
                               f"outside every span not zero")
    return errs


def paged_edge_inputs(lengths, dtype, dev, gen, hkv=None, *, heads):
    """Decode rows of ``lengths`` over a pool that holds just their
    blocks (7B heads): scrambled placement, sentinel table tails, NaN in
    the stale rows of each row's last block."""
    H, HKV, D = heads
    hkv = HKV if hkv is None else hkv
    import torch
    need = [-(-n // BS) for n in lengths]
    nb = sum(need) + 1
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(4))
    tables = torch.full((len(lengths), MB), nb, dtype=torch.int32)
    at = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[at:at + n].to(torch.int32)
        at += n
    pool_k = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    for r, n in enumerate(lengths):
        if n % BS:
            pool_k[int(tables[r, n // BS]), n % BS:] = float("nan")
            pool_v[int(tables[r, n // BS]), n % BS:] = float("nan")
    q = torch.randn(len(lengths), H, D, generator=gen, device=dev).to(dtype)
    return (q, pool_k, pool_v, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def quant_paged_edge_cases(mode, dtype_name, dev, gen, *, heads):
    """Paged decode on a quantized pool over the edge lengths of its walk
    — 0, 1, 31, 32, 33, a page +- 1, a split +- 1 and 4093 (the split at
    this row count) — with 32 KV heads and with 8 (4 query heads a KV
    head): within TOL of the plain version, the same bits on a second
    launch, the row of length 0 zeros."""
    H, HKV, D = heads
    import torch
    from paddle_tpu_torch.kernels import paged_decode, split_kv
    dtype = getattr(torch, dtype_name)
    errs = {}
    page = split_kv.narrow_page(D)
    for hkv in (HKV, _gqa_kv(heads)):
        sl = paged_decode.split_len(10, hkv, MB * BS,
                                    split_kv.sm_count(dev.index or 0))
        lengths = [0, 1, 31, 32, 33, page - 1, page + 1, sl - 1, sl + 1,
                   4093]
        q, pk, pv, tbl, lens = paged_edge_inputs(lengths, dtype, dev, gen,
                                                 hkv, heads=heads)
        kd, vd, ks, vs = quantize_pool(pk, pv, mode, gen)
        del pk, pv
        a = (q, kd, vd, tbl, lens, ks, vs)
        got = paged_decode.paged_decode_attention(*a)
        want = paged_decode.paged_decode_attention_reference(*a)
        torch.cuda.synchronize()
        name = f"kv_heads_{hkv}"
        errs[name] = _compare(f"paged_decode {mode} {name}", dtype_name, got,
                              want)
        if not torch.equal(got, paged_decode.paged_decode_attention(*a)):
            raise RuntimeError(f"paged_decode {mode} {name} {dtype_name}: "
                               f"two launches differ")
        if not bool((got[0] == 0).all()):
            raise RuntimeError(f"paged_decode {mode} {name}: a row of "
                               f"length 0 is not zero")
    return errs


#: the fused tick's quantized variants: (pool, int8 weights) by name
FUSED_QUANT_MODES = {"w8": (None, True), "int8": ("int8", False),
                     "int8_w8": ("int8", True), "fp8": ("fp8", False),
                     "fp8_w8": ("fp8", True)}


def _planted_faults(p, tied, t, got_logits, *, heads):
    """The plain tick on a faulty copy of ``t``'s quantized pools against
    the kernel's logits ``got_logits``, over max|ref|: layer 0's V scales
    of each live row's first block dropped (1.0), and layer 0's K scales
    taken from the neighbouring KV head. Each must miss
    ``QUANT_F32_LOGITS``."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    first = sorted({int(t["tables"][b, 0]) for b in range(len(t["lens"]))
                    if t["lens"][b] + t["app_mask"][b] > 0})
    idx = torch.tensor(first, device=got_logits.device)
    out = {}
    for fault in ("v_scale_dropped", "k_scale_neighbour_head"):
        pk, pv = _clone_pool(t["pool_k"]), _clone_pool(t["pool_v"])
        if fault == "v_scale_dropped":
            pv[1][0, idx] = 1.0
        else:
            pk[1][0] = pk[1][0].roll(1, dims=-1)
        want = _tick(fdt.fused_decode_tick_reference, p, tied,
                     dict(t, pool_k=pk, pool_v=pv), return_logits=True,
                     heads=heads)[4]
        rel = ((got_logits - want).abs().max()
               / want.abs().max().clamp(min=1e-30)).item()
        if not rel > QUANT_F32_LOGITS:
            raise RuntimeError(f"planted fault {fault}: {rel} of max|ref| "
                               f"is within QUANT_F32_LOGITS "
                               f"{QUANT_F32_LOGITS}")
        out[fault] = rel
        del pk, pv, want
    return out


def fused_quant_cases(dtype_name, dev, gen, base_ms, *, heads,
                      row_counts=(SLOTS, FUSED_WIDE_ROWS), sweep=True,
                      info=None):
    """The fused tick's five quantized variants (``FUSED_QUANT_MODES``:
    int8 weights on a pool at the model's type; int8 and fp8 pools with
    dense or int8 weights) against the plain version at llama_7b widths,
    2 layers, 8 and 37 rows; the layer-0 attention bit for bit the
    (quantized) paged decode kernel's; kernel, plain and scanned-tick
    milliseconds, the grid and the byte bound at the storage types. In
    float32 each quantized pool's logits are read over
    ``QUANT_SWEEP_SEEDS`` more pools and tokens at both row counts, and
    the int8 and fp8 pools' planted faults must miss the limit. Each row
    carries ``base_ms``, the tick on dense weights and a pool of the model
    type at 8 rows in this run, and its own time over it. ``row_counts``
    and ``sweep`` (the float32 pools' seed sweep and planted faults) cut
    it down where the Queue C 7 dims run it; ``info`` joins each row.
    Returns ``{mode: row}``."""
    H, HKV, D = heads
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_7b,
                                               llama_decode_params)
    from paddle_tpu_torch.serving.decode import quantize_decode_params
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=FUSED_LAYERS,
                                      dtype=dtype_name, **_heads_kw(heads)),
                             device=dev, seed=6)
    dense, tied = llama_decode_params(model)
    qparams = quantize_decode_params(dense, tied)
    out = {}
    for mode, (kv, w8) in FUSED_QUANT_MODES.items():
        p = qparams if w8 else dense
        row = {"name": "fused_decode_tick", "mode": mode,
               "dtype": dtype_name, "layers": FUSED_LAYERS, "head_dim": D,
               "tol": (dict(zip(("atol", "rtol"), TOL[dtype_name]))
                       if kv is None or dtype_name != "float32" else
                       {"of_max_ref": QUANT_F32_LOGITS}), **(info or {})}
        for rows in row_counts:
            t = tick_inputs(dtype, dev, gen, FUSED_LAYERS, rows=rows,
                            heads=heads)
            if kv is not None:
                kd, vd, ks, vs = quantize_pool(t["pool_k"], t["pool_v"], kv,
                                               gen)
                t.update(pool_k=(kd, ks), pool_v=(vd, vs))
                del kd, vd, ks, vs
            logits_err, rows_err, tokens_equal, want = _fused_vs_plain(
                p, tied, t, dtype_name, f"{mode} {rows} rows", heads=heads)
            rel = logits_err / max(want.abs().max().item(), 1e-30)
            bits = _layer0_attention_bits(p, tied, t, heads=heads)
            if not bits:
                raise RuntimeError(f"fused tick {mode} {dtype_name} {rows} "
                                   f"rows: layer-0 attention differs from "
                                   f"the paged decode kernel")
            run_t = dict(t, pool_k=_clone_pool(t["pool_k"]),
                         pool_v=_clone_pool(t["pool_v"]))
            card_t = _meta_on_card(run_t)
            nbytes, flops = tick_cost(p, t, FUSED_LAYERS, isz, heads=heads)
            part = {"rows": rows, "logits_err": logits_err,
                    "logits_err_of_max_ref": rel,
                    ("appended_steps_err" if kv else "appended_rows_err"):
                        rows_err,
                    "tokens_equal": tokens_equal, "keys_equal": True,
                    "layer0_attention_equals_paged_decode": bits,
                    "ms": time_ms(lambda: _tick(fdt.fused_decode_tick, p,
                                                tied, run_t, heads=heads)),
                    "device_ms": device_ms(lambda: _tick(
                        fdt.fused_decode_tick, p, tied, card_t, heads=heads)),
                    "grid_blocks": fdt.LAST_GRID["blocks"],
                    "blocks_per_sm": fdt.LAST_GRID["blocks_per_sm"],
                    "scanned_tick_ms": time_ms(lambda: _tick(
                        _scanned_tick, p, tied, run_t, heads=heads)),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": bound_ms(nbytes, flops, dtype_name)}
            if kv is not None and dtype_name == "float32" and sweep:
                # more pools and tokens, greedy rows: the readings behind
                # the limit, and the near ties they flip
                sweep, flips = [], 0
                for s in range(QUANT_SWEEP_SEEDS):
                    ts = tick_inputs(dtype, dev, gen, FUSED_LAYERS,
                                     rows=rows, heads=heads)
                    kd, vd, ks, vs = quantize_pool(ts["pool_k"],
                                                   ts["pool_v"], kv, gen)
                    ts.update(pool_k=(kd, ks), pool_v=(vd, vs), tok=(
                        torch.from_numpy(np.random.RandomState(100 + s)
                                         .randint(0, 32000, rows))
                        .to(dev)), temps=ts["temps"] * 0,
                        top_ks=ts["top_ks"] * 0)
                    del kd, vd, ks, vs
                    e, _, same, w = _fused_vs_plain(
                        p, tied, ts, dtype_name, f"{mode} {rows} rows "
                        f"sweep {s}", near_tie=True, heads=heads)
                    sweep.append(e / max(w.abs().max().item(), 1e-30))
                    flips += not same
                    del ts, w
                    torch.cuda.empty_cache()
                part["sweep_logits_err_of_max_ref"] = sweep
                part["sweep_near_tie_flips"] = flips
                if rows == SLOTS:
                    got = _tick(fdt.fused_decode_tick, p, tied,
                                dict(t, pool_k=_clone_pool(t["pool_k"]),
                                     pool_v=_clone_pool(t["pool_v"])),
                                return_logits=True, heads=heads)[4]
                    part["planted_faults_of_max_ref"] = _planted_faults(
                        p, tied, t, got, heads=heads)
                    del got
            if rows == SLOTS:
                part["plain_ms"] = time_ms(lambda: _tick(
                    fdt.fused_decode_tick_reference, p, tied, run_t,
                    heads=heads),
                    iters=3)
                row.update(part, max_abs_err=logits_err,
                           base_ms=base_ms, x_base=part["ms"] / base_ms,
                           bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                     >= flops / PEAK_FLOPS[dtype_name]
                                     else "operations"),
                           library_ms=None,
                           library="none: no single PyTorch call computes "
                                   "a tick")
            else:
                row["wide"] = part
                row["max_abs_err"] = max(row["max_abs_err"], logits_err)
            del t, run_t, card_t, want
            torch.cuda.empty_cache()
        emit({"phase": "kernels", **row})
        out[mode] = row
    del model, dense, qparams
    return out


def phase_kernels():
    import torch
    from paddle_tpu_torch.kernels import reset_launches
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for name, row in rope_cases(dtype_name, dev, gen, heads=HEADS).items():
            emit({"phase": "kernels", **row})
            rows[(name, dtype_name)] = row
        torch.cuda.empty_cache()
        for name in REPLACES:
            if name in ROPE or name == PRE_PASS:
                continue
            case = (bwd_case if name in BWD else
                    fused_case if name == "fused_decode_tick" else
                    kernel_case)
            row = case(name, dtype_name, dev, gen, heads=HEADS)
            emit({"phase": "kernels", **row})
            rows[(name, dtype_name)] = row
            torch.cuda.empty_cache()
        # the quantized modes of the three kernels that have them, each
        # timed beside the same kernel on a pool and weights of the model
        # type in this run (its row above)
        for name in QUANT_KERNELS:
            base_ms = rows[(name, dtype_name)]["ms"]
            got = (fused_quant_cases(dtype_name, dev, gen, base_ms,
                                     heads=HEADS)
                   if name == "fused_decode_tick" else
                   {mode: quant_kernel_case(name, mode, dtype_name, dev, gen,
                                            heads=HEADS)
                    for mode in QUANT_MODES})
            for mode, row in got.items():
                if name != "fused_decode_tick":
                    row.update(base_ms=base_ms,
                               x_base=row["ms"] / base_ms)
                    emit({"phase": "kernels", **row})
                rows[(name, dtype_name, mode)] = row
            torch.cuda.empty_cache()
        d256_cases(dtype_name, dev, gen, rows)
        dims_cases(dtype_name, dev, gen, rows)
        bwd_dims_cases(dtype_name, dev, gen, rows)
    # float16 in the flash kernels (Queue C 8): the RoPE mode with its
    # pre-pass, the forward and the backward pair at the training shapes,
    # on the tensor cores as bf16 runs
    for name, row in rope_cases(F16, dev, gen, heads=HEADS).items():
        emit({"phase": "kernels", **row})
        rows[(name, F16)] = row
    for name in ("flash",) + BWD:
        case = bwd_case if name in BWD else kernel_case
        row = case(name, F16, dev, gen, heads=HEADS)
        emit({"phase": "kernels", **row})
        rows[(name, F16)] = row
        torch.cuda.empty_cache()
    reset_launches()
    # span-1 ragged rows against the paged decode kernel: decode row b with
    # length L and a span-1 row with kvlen L attend the same keys through
    # the same split-KV walk. The split rule counts rows, so their splits
    # (and bits) agree only where the two calls have as many rows, as
    # here; they are held to TOL and ``bitwise`` reports whether they also
    # share the bits
    from paddle_tpu_torch.kernels import paged_decode, ragged_attention
    q, pk, pv, tbl, lens = paged_inputs(torch.bfloat16, dev, gen, heads=HEADS)
    one = torch.ones(SLOTS, dtype=torch.int32, device=dev)
    a = paged_decode.paged_decode_attention(q, pk, pv, tbl, lens)
    b = ragged_attention.ragged_paged_attention(
        q, pk, pv, tbl, torch.arange(SLOTS, dtype=torch.int32, device=dev),
        one * (lens > 0), lens)
    diff = _compare("span-1 ragged vs paged decode", "bfloat16", b, a)
    emit({"phase": "kernels", "check": "span1_ragged_vs_paged_decode",
          "max_abs_diff": diff, "bitwise": diff == 0.0})
    reset_launches()
    return rows


def d256_cases(dtype_name, dev, gen, rows):
    """The three serving kernels that take head dim 256 since Queue C 6,
    at ``D256`` (16 heads of 256 over 8 KV heads): each case of the
    kernel's row above at this geometry (flash at S=512, 300 and the
    training shape B=4, S=2048; ragged's packed tick-0 buffer and its
    edge spans; the fused tick at 2 layers, 8 and 37 rows), the same
    bits on two launches, the flash forward also with 16 KV heads (MHA)
    at S=300; then ragged on int8 and fp8 pools and the fused tick's five
    quantized variants. Rows land in ``rows`` under ``(name, dtype,
    "d256")`` and ``(name, dtype, mode, "d256")``."""
    import torch
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.kernels.flash_attention import _ref_attention
    h, hkv, d = D256
    for name in D256_KERNELS:
        case = fused_case if name == "fused_decode_tick" else kernel_case
        row = dict(case(name, dtype_name, dev, gen, heads=D256), head_dim=d,
                   heads=h, kv_heads=hkv)
        emit({"phase": "kernels", **row})
        rows[(name, dtype_name, "d256")] = row
        torch.cuda.empty_cache()
    base = rows[("ragged_attention", dtype_name, "d256")]["ms"]
    for mode in QUANT_MODES:
        row = quant_kernel_case("ragged_attention", mode, dtype_name, dev,
                                gen, heads=D256)
        row.update(head_dim=d, base_ms=base, x_base=row["ms"] / base)
        emit({"phase": "kernels", **row})
        rows[("ragged_attention", dtype_name, mode, "d256")] = row
    torch.cuda.empty_cache()
    base = rows[("fused_decode_tick", dtype_name, "d256")]["ms"]
    for mode, row in fused_quant_cases(dtype_name, dev, gen, base,
                                       heads=D256).items():
        row["head_dim"] = d
        rows[("fused_decode_tick", dtype_name, mode, "d256")] = row
    torch.cuda.empty_cache()
    q, k, v = flash_inputs(getattr(torch, dtype_name), dev, gen, B=2, S=300,
                           heads=Heads(h, h, d))
    got = flash.flash_attention(q, k, v, causal=True)
    err = _compare("flash MHA d256 S=300", dtype_name, got,
                   _ref_attention(q, k, v, True))
    if not torch.equal(got, flash.flash_attention(q, k, v, causal=True)):
        raise RuntimeError(f"flash MHA d256 {dtype_name}: two launches "
                           f"differ")
    emit({"phase": "kernels", "check": "flash_d256_mha_s300",
          "dtype": dtype_name, "max_abs_err": err,
          "bitwise_repeatable": True})


def dims_cases(dtype_name, dev, gen, rows):
    """Queue C 7 at each of ``DIMS``: each serving kernel's row of the
    D = 128 cases (``DIMS_KERNELS``: paged and dense decode at their edge
    lengths, GQA and a length-0 row; ragged over the packed tick-0 buffer
    and its edge spans; flash at S=512, 300 and the training shape; the
    fused tick at 2 layers, 8 and 37 rows; the same bits on two
    launches), paged decode and ragged on int8 and fp8 pools (their edge
    lengths and spans too), and the fused tick's five quantized variants
    at 8 rows. Rows land in ``rows`` under ``(name, dtype, tag)`` and
    ``(name, dtype, mode, tag)``."""
    import torch
    for tag, heads in DIMS.items():
        info = {"dims": tag, "head_dim": heads.d, "heads": heads.h,
                "kv_heads": heads.hkv}
        for name in DIMS_KERNELS:
            case = fused_case if name == "fused_decode_tick" else kernel_case
            row = dict(case(name, dtype_name, dev, gen, heads=heads), **info)
            emit({"phase": "kernels", **row})
            rows[(name, dtype_name, tag)] = row
            torch.cuda.empty_cache()
        for name in ("paged_decode", "ragged_attention"):
            base = rows[(name, dtype_name, tag)]["ms"]
            for mode in QUANT_MODES:
                row = quant_kernel_case(name, mode, dtype_name, dev, gen,
                                        heads=heads)
                row.update(info, base_ms=base, x_base=row["ms"] / base)
                emit({"phase": "kernels", **row})
                rows[(name, dtype_name, mode, tag)] = row
            torch.cuda.empty_cache()
        base = rows[("fused_decode_tick", dtype_name, tag)]["ms"]
        for mode, row in fused_quant_cases(
                dtype_name, dev, gen, base, heads=heads, row_counts=(SLOTS,),
                sweep=False, info=info).items():
            rows[("fused_decode_tick", dtype_name, mode, tag)] = row
        torch.cuda.empty_cache()


def bwd_dims_cases(dtype_name, dev, gen, rows):
    """Queue C 7 in training: the backward kernels and the RoPE pre-pass
    at each of ``BWD_DIMS`` (B=2, S=2048, head-major, the geometry's KV
    heads), without and with ``rope=``: dK/dV and dQ against their plain
    versions (``BWD_TOL``; bf16 the same bits twice;
    ``flash_attention_bwd``'s one pre-pass the standalone entries' bits),
    and ``rope_qk`` bit for bit the plain rotation in the inputs' strides.
    Times: each body on the operands (the pre-pass rotated with rope), the
    plain version, the library pair (SDPA causal fwd+bwd less its fwd, K
    and V repeated to the query heads, a torch rotation first with rope)
    and the bound. Rows land in ``rows`` under ``(name, dtype, tag)``
    (``name[rope]`` with rope, and ``rope_qk``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.models.llama import _apply_rope_bhsd
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    B, S = 2, TRAIN_S
    for tag, heads in BWD_DIMS.items():
        H, HKV, D = heads
        info = {"dims": tag, "head_dim": D, "heads": H, "kv_heads": HKV}
        (q, k, v, do, o, lse), rope, fwd_err = _rope_inputs(
            dtype_name, dev, gen, B, S, HKV, heads=heads)
        o0, lse0 = flash.flash_attention_fwd(q, k, v, True)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        pairs = B * H * S * (S + 1) // 2
        sin, cos = rope
        local = {}
        for r in (None, rope):
            sfx = "" if r is None else "[rope]"
            oo, ll = (o0, lse0) if r is None else (o, lse)
            errs = _rope_bwd_errs(dtype_name, q, k, v, do, oo, ll, r,
                                  f"flash bwd{sfx} {tag}")
            delta = flash.attention_delta(oo, do)
            ops = flash._bwd_operands("dims bwd", q, k, v, do, ll, delta, r)
            rot = (lambda x: x) if r is None else (
                lambda x: _apply_rope_bhsd(x, sin, cos))
            lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
                rot(qt), rot(kt).repeat_interleave(H // HKV, dim=1),
                vt.repeat_interleave(H // HKV, dim=1), is_causal=True)
            with torch.no_grad():
                lib_f = time_ms(lib_fwd, iters=5)
            lib_b = time_ms(lambda: torch.autograd.grad(
                lib_fwd(), (qt, kt, vt), dot), iters=5) - lib_f
            tables = 0 if r is None else 2 * S * D * 4
            plan = (("flash_bwd_dkv",
                     lambda: flash._launch_dkv(*ops, ll, delta, True),
                     lambda: flash.flash_bwd_dkv_reference(
                         q, k, v, do, ll, delta, True, r), 4,
                     (2 * q.numel() + 4 * k.numel()) * isz + 8 * B * H * S),
                    ("flash_bwd_dq",
                     lambda: flash._launch_dq(*ops, ll, delta, True),
                     lambda: flash.flash_bwd_dq_reference(
                         q, k, v, do, ll, delta, True, r), 3,
                     (3 * q.numel() + 2 * k.numel()) * isz + 8 * B * H * S))
            for name, body, plain, products, nbytes in plan:
                nbytes += tables
                flops = products * 2 * pairs * D
                row = {"name": name + sfx, "dtype": dtype_name,
                       "layout": "bhsd", **info,
                       "shape": {"B": B, "S": S, "H": H, "Hk": HKV, "D": D},
                       "max_abs_err": errs[0],
                       "max_err_over_max_ref": errs[1],
                       "fwd_o_lse_err": fwd_err if r is not None else None,
                       "tol": {"atol_x_max_ref": BWD_TOL[dtype_name][0],
                               "rtol": BWD_TOL[dtype_name][1]},
                       "bitwise_repeatable": dtype_name == "bfloat16",
                       "ms": time_ms(body, iters=5),
                       "plain_ms": time_ms(plain, iters=2),
                       "library_ms": lib_b,
                       "library": "SDPA fwd+bwd minus its fwd, K and V "
                                  "repeated" + (", a torch rotation first"
                                                if r is not None else ""),
                       "bytes": nbytes, "flops": flops,
                       "bound_ms": bound_ms(nbytes, flops, dtype_name),
                       "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                    >= flops / PEAK_FLOPS[dtype_name]
                                    else "operations"),
                       "route": route(name, dtype_name)}
                row["x_library"] = row["ms"] / row["library_ms"]
                emit({"phase": "kernels", **row})
                rows[(name + sfx, dtype_name, tag)] = local[name + sfx] = row
            del ops
            torch.cuda.empty_cache()

        def pair():       # pre-pass + dK/dV + dQ, delta given
            delta = flash.attention_delta(o, do)
            both = flash._bwd_operands("dims bwd", q, k, v, do, lse, delta,
                                       rope)
            return (flash._launch_dkv(*both, lse, delta, True),
                    flash._launch_dq(*both, lse, delta, True))

        qr, kr = flash._rotated(q, k, rope)
        row = dict(_pre_pass_row(dtype_name, q, k, rope, qr, kr, pair, local,
                                 local["flash_bwd_dkv[rope]"]["library_ms"]),
                   **info)
        emit({"phase": "kernels", **row})
        rows[(PRE_PASS, dtype_name, tag)] = row
        del q, k, v, do, o, lse, o0, lse0, qt, kt, vt, dot, qr, kr
        torch.cuda.empty_cache()


def _requests(GenerationRequest, short, long_len, new, vocab, seed):
    import numpy as np
    r = np.random.RandomState(seed)
    reqs = [GenerationRequest(prompt=r.randint(0, vocab, n).astype(np.int32),
                              max_new_tokens=new) for n in short]
    reqs.append(GenerationRequest(
        prompt=r.randint(0, vocab, long_len).astype(np.int32),
        max_new_tokens=new))
    return reqs


#: the engine's three decode programs: (label, knobs, the kernel only it
#: launches)
ENGINES = (("default", {}, None),
           ("fused_tick", {"fused_tick": True}, "fused_decode_tick"),
           ("dense", {"paged_attn": False}, "decode"))


def _three_engines(model, cfg, phase):
    """``model`` (2 layers, fp32) through the default, the fused-tick and
    the dense engine: kernels vs plain versions, greedy streams equal; the
    engine's own kernel launches with the kernels on and never with them
    off; the fused engine's streams equal the default engine's. Returns
    each engine's streams with the kernels on."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    on_streams = {}
    for label, knob, own in ENGINES:
        streams, launches, own_launches = {}, {}, {}
        try:
            for use in (True, False):
                set_flags({"FLAGS_use_cuda_kernels": use})
                reset_launches()
                eng = ContinuousBatchingEngine(model, headroom_mult=None,
                                               **knob)
                outs = eng.generate(_requests(
                    GenerationRequest, (37, 130, 300), 700, 16,
                    cfg.vocab_size, seed=3))
                streams[use] = [o.tolist() for o in outs]
                launches[use] = sum(LAUNCHES.values())
                own_launches[use] = LAUNCHES[own] if own else None
                del eng
                torch.cuda.empty_cache()
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        same = streams[True] == streams[False]
        on_streams[label] = streams[True]
        emit({"phase": phase, "engine": label,
              "layers": cfg.num_hidden_layers, "dtype": cfg.dtype,
              "greedy_streams_equal": same,
              "tokens": sum(len(s) for s in streams[True]),
              "launches_kernels": launches[True],
              "launches_plain": launches[False],
              "own_kernel": own, "own_launches_kernels": own_launches[True],
              "own_launches_plain": own_launches[False]})
        if not launches[True] or launches[False] or (
                own and not own_launches[True]):
            raise RuntimeError(f"engine {label} launches: kernels "
                               f"{launches[True]} ({own}: "
                               f"{own_launches[True]}), plain "
                               f"{launches[False]}")
        if not same:
            raise RuntimeError(f"engine {label}: greedy streams differ: "
                               f"{streams}")
    fused_same = on_streams["fused_tick"] == on_streams["default"]
    emit({"phase": phase, "check": "fused_tick_vs_default",
          "greedy_streams_equal": fused_same})
    if not fused_same:
        raise RuntimeError(f"fused-tick streams differ from the default "
                           f"engine's: {on_streams}")
    return on_streams


def phase_engine():
    """fp32, 2 layers, the three engines kernels vs plain
    (``_three_engines``), then the knobs and geometries below."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    on_streams = _three_engines(model, cfg, "engine")
    _engine_wide(model, cfg)
    # the kernels line's D = 256 rows are the bf16 routes: their launches
    # come from the bf16 leg
    _engine_legs("float32", {"d256": D256})
    d256 = _engine_legs("bfloat16", {"d256": D256})
    _engine_legs("float32", {t: DIMS[t] for t in DIMS_F32_LEGS},
                 DIMS_F32_ENGINES)
    dims = _engine_legs("bfloat16", DIMS, light=DIMS_LIGHT)
    _engine_prefix(model, cfg)
    _engine_two_program(model, cfg, on_streams["default"])
    _engine_multitick(model, cfg)
    _engine_step9(model, cfg)
    quant = _engine_quant(model, cfg)
    del model
    torch.cuda.empty_cache()
    probe = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--capture-probe"], capture_output=True,
                           text=True, timeout=600, cwd=str(ROOT))
    lines = [ln for ln in probe.stdout.splitlines() if ln.startswith("{")]
    if probe.returncode or not lines:
        raise RuntimeError(f"capture probe exited {probe.returncode}: "
                           f"{probe.stderr[-2000:]}")
    print(lines[-1], flush=True)
    return {**quant, **d256, **dims}


#: the quantized knob sets the engine phase holds, kernels against plain
QUANT_ENGINES = (
    ("kv_int8", {"kv_dtype": "int8"}),
    ("kv_fp8", {"kv_dtype": "fp8"}),
    ("w8", {"quantize_weights": True}),
    ("w8_dense", {"quantize_weights": True, "paged_attn": False}),
    ("w8_two_program", {"quantize_weights": True, "ragged_step": False}),
    ("fused_w8", {"fused_tick": True, "quantize_weights": True}),
    ("fused_int8", {"fused_tick": True, "kv_dtype": "int8"}),
    ("fused_int8_w8", {"fused_tick": True, "kv_dtype": "int8",
                       "quantize_weights": True}),
    ("fused_fp8", {"fused_tick": True, "kv_dtype": "fp8"}),
    ("fused_fp8_w8", {"fused_tick": True, "kv_dtype": "fp8",
                      "quantize_weights": True}),
    ("ticks4_int8", {"decode_ticks": 4, "kv_dtype": "int8"}),
    ("prefix_int8", {"prefix_cache": True, "kv_dtype": "int8"}),
    ("w8_a8", {"quantize_weights": True, "quantize_activations": True}),
)


#: the engines of the head-dim-256 leg: the three decode programs, and the
#: quantized pools and weights whose kernels have a D = 256 row
D256_ENGINES = (("default", {}), ("fused_tick", {"fused_tick": True}),
                ("dense", {"paged_attn": False}),
                ("kv_int8", {"kv_dtype": "int8"}),
                ("kv_fp8", {"kv_dtype": "fp8"}),
                *(("fused_" + mode, {"fused_tick": True,
                                     **({"kv_dtype": kv} if kv else {}),
                                     **({"quantize_weights": True}
                                        if w8 else {})})
                  for mode, (kv, w8) in FUSED_QUANT_MODES.items()))


#: the Queue C 7 legs held equal in float32, kernels against plain
#: (llama_tiny's full configuration, and 80 and 96 at 2 layers), and their
#: engines; the bf16 legs run every engine of ``D256_ENGINES`` at every
#: tag of ``DIMS``, the quantized ones of ``DIMS_LIGHT`` on two short
#: requests of 8 tokens (their launches for the kernels line)
DIMS_F32_LEGS = ("d16_tiny", "d80", "d96")
DIMS_F32_ENGINES = ("default", "fused_tick", "dense", "kv_int8")
DIMS_LIGHT = ("kv_fp8",) + tuple("fused_" + m for m in FUSED_QUANT_MODES)


def _engine_legs(dtype_name, legs, f32_engines=None, light=()):
    """Head geometries on the engine at ``dtype_name``, one leg a tag of
    ``legs`` (tag -> heads): llama_tiny at its full configuration for
    ``d16_tiny`` (4 layers, 4 query heads of 16 over 2 KV heads,
    vocabulary 256, 128 positions: 4 slots, short prompts), else 2 layers
    at llama_7b's other widths, hidden h * d. Each engine of
    ``D256_ENGINES`` (in float32 those of ``f32_engines``, every one where
    it is None) builds with the kernels on and launches its own kernel
    (and the flash forward and ragged attention where its path has them)
    with the kernels on and none with them off; in float32 its greedy
    streams and finish reasons equal its plain versions'; in bf16 (the
    tensor-core routes of the kernel rows) each stream's first parting
    from the plain run is reported; the engines of ``light`` run two
    short requests of 8 tokens. Returns the launches of each kernel row
    at these geometries, keyed ``(name, tag)`` and ``(name, mode,
    tag)``."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_7b,
                                               llama_tiny)
    from paddle_tpu_torch.serving import GenerationRequest
    out = {}
    for tag, heads in legs.items():
        if tag == "d16_tiny":
            cfg = llama_tiny(dtype=dtype_name)
            shape = (5, 23, 40), 90
            geo = {"num_slots": 4, "max_seq_len": 128}
        else:
            cfg = llama_7b(num_hidden_layers=2, dtype=dtype_name,
                           **_heads_kw(heads))
            shape = (37, 130, 300), 700
            geo = {}
        full = _requests(GenerationRequest, *shape, 16, cfg.vocab_size,
                         seed=3)
        short = _requests(GenerationRequest, shape[0][:1], shape[0][1], 8,
                          cfg.vocab_size, seed=3)
        model = LlamaForCausalLM(cfg, device="cuda", seed=1)
        launches = {}
        for label, knob in D256_ENGINES:
            if dtype_name == "float32" and f32_engines is not None \
                    and label not in f32_engines:
                continue
            reqs, new = (short, 8) if label in light else (full, 16)
            (s_on, f_on, eng, l_on, _), (s_off, f_off, _, l_off, _) = (
                _eng_run(model, reqs, dict(geo, **knob), kernels=use)
                for use in (True, False))
            own = _own_kernel(knob)
            same = s_on == s_off and f_on == f_off
            emit({"phase": "engine", "engine": f"{tag}_{label}",
                  "knobs": knob, "head_dim": heads.d,
                  "heads": cfg.num_attention_heads,
                  "kv_heads": cfg.num_key_value_heads,
                  "layers": cfg.num_hidden_layers, "dtype": dtype_name,
                  "greedy_streams_equal": same,
                  "first_parting": _first_parting(s_on, s_off),
                  "tokens": sum(len(x) for x in s_on), "own_kernel": own,
                  "launches_kernels": {k: v for k, v in l_on.items() if v},
                  "launches_plain": sum(l_off.values())})
            eng.release()
            if dtype_name == "float32" and not same:
                raise RuntimeError(f"engine {tag} {label}: kernels vs plain "
                                   f"streams differ: {s_on} vs {s_off}")
            if any(len(x) != new and r != "stop"
                   for x, r in zip(s_on, f_on)):
                raise RuntimeError(f"engine {tag} {dtype_name} {label}: "
                                   f"streams {s_on}, finish reasons {f_on}")
            if not l_on[own] or sum(l_off.values()) or (
                    label == "default" and not l_on["flash"]) or (
                    knob.get("paged_attn", True)
                    and not l_on["ragged_attention"]):
                raise RuntimeError(f"engine {tag} {dtype_name} {label} "
                                   f"launches: kernels {l_on}, plain "
                                   f"{l_off}")
            launches[label] = l_on
        del model
        torch.cuda.empty_cache()
        if set(launches) != {label for label, _ in D256_ENGINES}:
            continue
        out.update({(n, tag): launches[
            "fused_tick" if n == "fused_decode_tick" else
            "dense" if n == "decode" else "default"][n]
            for n in DIMS_KERNELS})
        out.update({(n, m, tag): launches["kv_" + m][n]
                    for n in ("paged_decode", "ragged_attention")
                    for m in QUANT_MODES})
        out.update({("fused_decode_tick", m, tag): launches["fused_" + m][
            "fused_decode_tick"] for m in FUSED_QUANT_MODES})
    return out


def _matched_prefix(a, b):
    """Mean over streams of the share of tokens before the first
    difference (``tests/test_lowprec_decode.py``'s measure)."""
    fracs = []
    for x, y in zip(a, b):
        m = 0
        for t, u in zip(x, y):
            if t != u:
                break
            m += 1
        fracs.append(m / max(len(x), 1))
    return sum(fracs) / max(len(fracs), 1)


#: the request sets (seeds of ``_requests``) a8 streams are compared on
A8_SEEDS = (3, 13, 23)


def _a8_run(model, reqs, knob, kernels):
    """``_eng_run`` with every lm-head product recorded: for each call,
    whether its rows are the slots (the unified step's span samples and
    tail ticks) or a cold prefill's requests, each row's live flag (a
    span this step, or a decode row of a tail tick), its top two tokens, their logit margin, the logits, and the
    largest change one re-rounded activation step makes to that margin
    (the row's activation scale times max over the hidden axis of
    |head[:, t1] - head[:, t2]| in its int8 form). Returns (``_eng_run``'s
    tuple, the calls)."""
    from paddle_tpu_torch.serving import decode as sd
    calls, live = [], {}
    sample, tick, head_logits = (sd._span_last_sample, sd._fused_decode_tick,
                                 sd._head_logits)

    def rec_sample(params, head, x, qstart, qlen, *a, **kw):
        live["rows"] = sd._host(qlen) > 0
        return sample(params, head, x, qstart, qlen, *a, **kw)

    def rec_tick(*a, **kw):
        live["rows"] = sd._host(a[11]) > 0
        return tick(*a, **kw)

    def rec_head(last_h, head):
        logits = head_logits(last_h, head)
        top = logits.float().topk(2, dim=-1)
        t1, t2 = top.indices[:, 0], top.indices[:, 1]
        qw, sw = head
        sw = sw.reshape(-1)
        step = sd.quantize_act_rows(last_h)[1].reshape(-1) * (
            qw[:, t1].float() * sw[t1] - qw[:, t2].float() * sw[t2]
        ).abs().amax(0)
        rows = live.pop("rows", None)
        calls.append({"slots": rows is not None,
                      "live": [True] * len(t1) if rows is None else rows,
                      "logits": logits.float(),
                      "t1": t1.tolist(), "t2": t2.tolist(),
                      "margin": (top.values[:, 0] - top.values[:, 1])
                      .tolist(), "step": step.tolist()})
        return logits

    sd._span_last_sample, sd._fused_decode_tick, sd._head_logits = (
        rec_sample, rec_tick, rec_head)
    try:
        return _eng_run(model, reqs, knob, kernels=kernels), calls
    finally:
        sd._span_last_sample, sd._fused_decode_tick, sd._head_logits = (
            sample, tick, head_logits)


def _a8_partings(on, off):
    """Each slot's first lm-head call, live in both runs, whose greedy pick
    differs (kernels ``on`` against plain ``off``), and each cold-prefill
    row whose pick differs: the plain run's top-2 margin there and one
    activation step's change to it, whether the kernels took the plain
    run's runner-up, the largest logit difference there and over the
    slot's earlier live calls."""
    out, before, parted = [], {}, set()
    for k, (a, b) in enumerate(zip(on, off)):
        for r in range(len(b["t1"])):
            if not (a["live"][r] and b["live"][r]) or r in parted:
                continue
            d = (a["logits"][r] - b["logits"][r]).abs().max().item()
            if a["t1"][r] != b["t1"][r]:
                out.append({"call": k, "row": r, "slots": b["slots"],
                            "margin": b["margin"][r],
                            "one_step": b["step"][r],
                            "runner_up": a["t1"][r] == b["t2"][r],
                            "logits_diff": d,
                            "logits_diff_before": before.get(r, 0.0)
                            if b["slots"] else 0.0})
                if b["slots"]:
                    parted.add(r)
            elif b["slots"]:
                before[r] = max(before.get(r, 0.0), d)
    return out


def _first_parting(a, b):
    """Each stream's first token index where the two runs differ (None
    where they agree)."""
    out = []
    for x, y in zip(a, b):
        i = next((i for i, (t, u) in enumerate(zip(x, y)) if t != u), None)
        out.append(i if i is not None or len(x) == len(y)
                   else min(len(x), len(y)))
    return out


def _own_kernel(knob):
    """The decode-side kernel a knob set's tail ticks launch."""
    if not knob.get("paged_attn", True):
        return "decode"
    if knob.get("fused_tick") and not knob.get("quantize_activations"):
        return "fused_decode_tick"
    return "paged_decode"


def _engine_quant(model, cfg):
    """fp32, 2 layers: every quantized knob set of ``QUANT_ENGINES``
    through the kernels and through the plain versions: greedy streams
    and finish reasons equal, the path's kernels launched with the
    kernels on and none with them off. a8 streams may part (``_a8``); the
    rest must be equal. The prefix run is two waves of the same shared-prefix
    prompts, the second hitting the first's blocks (their int8 data and
    scale planes)."""
    import numpy as np
    from paddle_tpu_torch.serving import GenerationRequest
    reqs = _requests(GenerationRequest, (37, 130, 300), 700, 16,
                     cfg.vocab_size, seed=3)
    r = np.random.RandomState(4)
    pre = r.randint(0, cfg.vocab_size, 96).astype(np.int32)
    prompts = [np.concatenate([pre, r.randint(0, cfg.vocab_size, n).astype(
        np.int32)]) for n in (20, 45, 70)]
    waves = [[GenerationRequest(prompt=p, max_new_tokens=16)
              for p in prompts] for _ in range(2)]
    launches = {}
    for label, knob in QUANT_ENGINES:
        a8 = bool(knob.get("quantize_activations"))
        if a8:
            witness = _a8(model, cfg, knob)
            runs = witness.pop("runs")
        else:
            runs = {use: _eng_run(model, waves if knob.get("prefix_cache")
                                  else reqs, knob, kernels=use)
                    for use in (True, False)}
        (s_on, f_on, eng, l_on, _), (s_off, f_off, _, l_off, _) = \
            runs[True], runs[False]
        own = _own_kernel(knob)
        same = (s_on == s_off and f_on == f_off) or (
            a8 and witness["ok"])
        line = {"phase": "engine", "engine": label, "knobs": knob,
                "layers": 2, "dtype": "float32",
                "greedy_streams_equal": s_on == s_off and f_on == f_off,
                "tokens": sum(len(x) for x in s_on),
                "kv_dtype": eng.kv_dtype,
                "bytes_per_token": (eng.cache.bytes_per_token()
                                    if knob.get("paged_attn", True)
                                    else None),
                "own_kernel": own, "launches_kernels": l_on,
                "launches_plain": sum(l_off.values())}
        if knob.get("prefix_cache"):
            line["prefill_tokens_saved"] = eng.stats["prefill_tokens_saved"]
        if a8:
            line.update(witness)
        emit(line)
        eng.release()
        if not same:
            raise RuntimeError(f"engine {label}: kernels vs plain streams "
                               f"differ: {s_on} vs {s_off}")
        if not l_on[own] or sum(l_off.values()) or (
                knob.get("paged_attn", True) and not l_on["ragged_attention"]
                and knob.get("ragged_step", True)):
            raise RuntimeError(f"engine {label} launches: kernels {l_on}, "
                               f"plain {l_off}")
        if knob.get("prefix_cache") and not line["prefill_tokens_saved"]:
            raise RuntimeError(f"engine {label}: the second wave hit "
                               f"nothing")
        launches[label] = l_on
    # the main path of the modes the quantized serve runs do not launch:
    # the fp8 engines and the fused tick's other variants of this phase
    return {("ragged_attention", "fp8"): launches["kv_fp8"][
                "ragged_attention"],
            ("paged_decode", "fp8"): launches["kv_fp8"]["paged_decode"],
            **{("fused_decode_tick", mode): launches["fused_" + mode][
                "fused_decode_tick"]
               for mode in FUSED_QUANT_MODES if mode != "int8_w8"}}


#: a8, kernels against plain: the largest logit difference before a
#: parting may be at most this many times that of two plain runs whose
#: attention differs by one ulp (the noise a8 makes of last-place
#: differences; PERF.md section 2)
A8_NOISE_FACTOR = 4.0


def _ulp_attention(seed):
    """``serving.decode._attn_fns`` with each attention output moved one
    ulp up or down at random (seeded): the plain versions, unless the
    kernels are on, differing from themselves in the last place as the
    kernels differ from them."""
    import torch
    from paddle_tpu_torch.serving import decode as sd
    fns, gens = sd._attn_fns, {}

    def nudge(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            x = out[0] if isinstance(out, tuple) else out
            gen = gens.setdefault(x.device, torch.Generator(
                device=x.device).manual_seed(seed))
            up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
            inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
            y = torch.nextafter(x, torch.where(up, inf, -inf))
            return (y,) + tuple(out[1:]) if isinstance(out, tuple) else y
        return call

    def attn_fns(decode_attn="pallas"):
        got = fns(decode_attn)
        return tuple(nudge(f) for f in got[:4]) + tuple(got[4:])
    return attn_fns


def _pre_parting_diff(on, off, partings):
    """The largest logit difference of two recorded runs over each slot's
    live calls before its parting (and cold-prefill rows that agree)."""
    first = {p["row"]: p["call"] for p in partings if p["slots"]}
    worst = 0.0
    for k, (a, b) in enumerate(zip(on, off)):
        for r in range(len(b["t1"])):
            if not (a["live"][r] and b["live"][r]) or a["t1"][r] != b["t1"][r]:
                continue
            if b["slots"] and k >= first.get(r, len(on)):
                continue
            worst = max(worst, (a["logits"][r] - b["logits"][r]).abs().max()
                        .item())
    return worst


def _a8(model, cfg, knob):
    """int8 x int8 projections quantize each activation row at run time,
    which re-rounds the attention kernels' last-place differences from
    the plain versions to a full step: a8's kernels-vs-plain streams may
    part where two tokens nearly tie (the reference measures a8's
    divergence rather than assume it zero: tests/test_lowprec_decode.py,
    matched prefix >= 0.5). Over ``A8_SEEDS`` request sets, with the
    lm-head products recorded (``_a8_run``), the kernels and a plain run
    whose attention is one ulp off (``_ulp_attention``) are each held to
    the plain run: the kernels' largest logit difference before a parting
    within ``A8_NOISE_FACTOR`` of the one-ulp run's, every parting at a
    margin below the logit difference there, the first set's matched
    prefix at least half, and the kernels' repeat of it the same bits.
    Returns the readings, ``ok``, and the first set's runs."""
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving import decode as sd
    out = {"seeds": [], "ok": True}
    worst = {"kernels": 0.0, "ulp": 0.0}
    for seed in A8_SEEDS:
        reqs = _requests(GenerationRequest, (37, 130, 300), 700, 16,
                         cfg.vocab_size, seed=seed)
        off, c_off = _a8_run(model, reqs, knob, False)
        fns = sd._attn_fns
        sd._attn_fns = _ulp_attention(seed)
        try:
            ulp, c_ulp = _a8_run(model, reqs, knob, False)
        finally:
            sd._attn_fns = fns
        on, c_on = _a8_run(model, reqs, knob, True)
        reading = {"seed": seed}
        for name, run, calls in (("kernels", on, c_on), ("ulp", ulp, c_ulp)):
            partings = _a8_partings(calls, c_off)
            diff = _pre_parting_diff(calls, c_off, partings)
            worst[name] = max(worst[name], diff)
            reading[name] = {
                "first_parting_token": _first_parting(run[0], off[0]),
                "matched_prefix_fraction": _matched_prefix(run[0], off[0]),
                "logits_diff_before_parting": diff, "partings": partings}
            out["ok"] = out["ok"] and all(
                p["margin"] < p["logits_diff"] for p in partings) and (
                len(partings) >= sum(
                    i is not None
                    for i in reading[name]["first_parting_token"]))
            if run is not on:
                run[2].release()
        del c_on, c_off, c_ulp
        if seed == A8_SEEDS[0]:
            out["runs"] = {True: on, False: off}
            reading["kernels_repeat_equal"] = \
                _eng_run(model, reqs, knob)[0] == on[0]
            out["ok"] = out["ok"] and reading["kernels_repeat_equal"] and \
                reading["kernels"]["matched_prefix_fraction"] >= 0.5
        else:
            on[2].release()
        out["seeds"].append(reading)
    out["kernels_over_ulp_logits_diff"] = (
        worst["kernels"] / max(worst["ulp"], 1e-30))
    out["ok"] = out["ok"] and worst["ulp"] > 0 and \
        out["kernels_over_ulp_logits_diff"] <= A8_NOISE_FACTOR
    return out


#: the fused engine past the 16 rows its kernel once took: slots, requests
WIDE_SLOTS, WIDE_REQUESTS = 32, 20


def _engine_wide(model, cfg):
    """fp32, kernels on: WIDE_REQUESTS requests through the default and
    the fused-tick engine at WIDE_SLOTS slots, more than 16 in flight at
    once; the fused engine's greedy streams must equal the default's, one
    fused launch per tail tick of WIDE_SLOTS rows."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    reqs = _requests(GenerationRequest, tuple(range(25, 500, 25)), 700, 12,
                     cfg.vocab_size, seed=11)
    runs = {}
    for label, knob in (("default", {}), ("fused_tick", {"fused_tick": True})):
        reset_launches()
        eng = ContinuousBatchingEngine(model, num_slots=WIDE_SLOTS,
                                       max_seq_len=1024, headroom_mult=None,
                                       **knob)
        seqs = [eng.submit(q) for q in reqs]
        most = 0
        while eng.has_work():
            eng.step()
            most = max(most, sum(x is not None for x in eng._slots))
        torch.cuda.synchronize()
        runs[label] = ([list(x.tokens) for x in seqs], most,
                       LAUNCHES["fused_decode_tick"],
                       eng.stats["decode_steps"] - eng.stats["decode_calls"])
        del eng
        torch.cuda.empty_cache()
    same = runs["fused_tick"][0] == runs["default"][0]
    _, most, fused, tail = runs["fused_tick"]
    emit({"phase": "engine", "check": "fused_tick_wide_vs_default",
          "num_slots": WIDE_SLOTS, "requests": len(reqs),
          "most_in_flight": most, "greedy_streams_equal": same,
          "tokens": sum(len(x) for x in runs["fused_tick"][0]),
          "fused_launches": fused, "tail_ticks": tail})
    if not same or most <= 16 or fused != tail or not fused:
        raise RuntimeError(f"wide fused engine: streams equal {same}, "
                           f"{most} in flight, {fused} fused launches for "
                           f"{tail} tail ticks")


def _eng_run(model, reqs, knob, kernels=True, graph=True):
    """One engine run to completion with the kernels (or their plain
    versions) and the graph tail (or the eager one); counts set to 0 just
    before it and read just after. Returns (streams, finish reasons,
    engine, launches, the multi-tick program's calls)."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    calls = []
    try:
        set_flags({"FLAGS_use_cuda_kernels": kernels,
                   "FLAGS_cuda_graph_tail": graph})
        eng = ContinuousBatchingEngine(model, headroom_mult=None, **knob)
        if eng.decode_ticks > 1:
            program = eng._mtick_fn

            def recorded():
                fn = program()

                def call(*args, **kw):
                    out = fn(*args, **kw)
                    calls.append((int(args[16]), out[4], args[10].copy(),
                                  args[14].copy(), out[2].numpy().copy()))
                    return out
                return call
            eng._mtick_fn = recorded
        reset_launches()
        waves = reqs if isinstance(reqs[0], list) else [reqs]
        outs = []
        for wave in waves:
            outs += eng.generate(wave)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True,
                   "FLAGS_cuda_graph_tail": True})
    return ([o.tolist() for o in outs], [o.finish_reason for o in outs],
            eng, launches, calls)


def _device_retirements(calls):
    """Rows the alive mask retired on the device while the tail went on:
    a decode row whose EOS came at a tick before the step's last."""
    n_ret = 0
    for n, ticks_run, dec, eos, toks in calls:
        for r in range(len(dec)):
            if not dec[r] or eos[r] < 0:
                continue
            hit = [t for t in range(ticks_run) if toks[t, r] == eos[r]]
            n_ret += bool(hit) and hit[0] < n - 1
    return n_ret


def _engine_prefix(model, cfg):
    """fp32, 2 layers: the prefix cache on the default (paged) and the
    dense engine. A first wave of 4 requests on a shared 96-token prefix
    publishes it, a second wave of 4 hits it; kernels and plain versions,
    with and without the cache: greedy streams all equal, tokens saved."""
    import numpy as np
    from paddle_tpu_torch.serving import GenerationRequest
    r = np.random.RandomState(21)
    prefix = r.randint(0, cfg.vocab_size, 96).astype(np.int32)
    waves = [[GenerationRequest(prompt=np.concatenate(
        [prefix, r.randint(0, cfg.vocab_size, n).astype(np.int32)]),
        max_new_tokens=16) for n in tails]
        for tails in ((20, 33, 47, 60), (25, 38, 52, 7))]
    for label, knob in (("default", {}), ("dense", {"paged_attn": False})):
        runs = {}
        for cache in (True, False):
            for use in (True, False):
                geo = dict(knob, max_seq_len=1024, prefix_cache=cache)
                streams, _, eng, launches, _ = _eng_run(model, waves, geo,
                                                        kernels=use)
                runs[(cache, use)] = (streams, launches,
                                      eng.stats["prefill_tokens_saved"],
                                      eng.stats["prefill_copy_dispatches"])
                eng.release()
                del eng
        same = len({str(v[0]) for v in runs.values()}) == 1
        saved = runs[(True, True)][2]
        on = runs[(True, True)][1]
        emit({"phase": "engine", "check": "prefix_cache", "engine": label,
              "dtype": "float32", "layers": 2, "prefix_tokens": 96,
              "greedy_streams_equal": same, "prefill_tokens_saved": saved,
              "prefill_tokens_saved_plain": runs[(True, False)][2],
              "prefill_copy_dispatches": runs[(True, True)][3],
              "launches_kernels": on,
              "launches_plain": sum(runs[(True, False)][1].values())})
        if not same or saved <= 0 or runs[(True, False)][2] != saved \
                or not sum(on.values()) or sum(runs[(True, False)][1]
                                               .values()):
            raise RuntimeError(f"prefix cache on the {label} engine: "
                               f"streams equal {same}, saved {saved}, "
                               f"launches {on}")


def _engine_two_program(model, cfg, unified):
    """fp32, 2 layers: ``ragged_step=False`` on the engine phase's
    requests, kernels and plain versions: greedy streams equal the unified
    engine's, paged decode launched, ragged attention not."""
    from paddle_tpu_torch.serving import GenerationRequest
    reqs = _requests(GenerationRequest, (37, 130, 300), 700, 16,
                     cfg.vocab_size, seed=3)
    got = {}
    for use in (True, False):
        got[use] = _eng_run(model, reqs, {"ragged_step": False},
                            kernels=use)
        got[use][2].release()
    on = got[True][3]
    same = got[True][0] == got[False][0] == unified
    emit({"phase": "engine", "check": "two_program_vs_unified",
          "dtype": "float32", "layers": 2, "greedy_streams_equal": same,
          "decode_calls": got[True][2].stats["decode_calls"],
          "prefill_chunks": got[True][2].stats["prefill_chunks"],
          "launches_kernels": on,
          "launches_plain": sum(got[False][3].values())})
    if not same or not on["paged_decode"] or on["ragged_attention"] \
            or sum(got[False][3].values()):
        raise RuntimeError(f"two-program step: streams equal {same}, "
                           f"launches {on}")


def _engine_multitick(model, cfg):
    """fp32, 2 layers: ``decode_ticks=8``, scanned and fused, with an EOS
    the first run emits mid-stream, so the device retires rows. Per
    program: the graph tail, the eager tail and the plain versions give
    the same streams, finish reasons and ticks run as each other and as
    ``decode_ticks=1``; launches equal the code's count with replays
    counted; the pools after the first tail equal the eager tail's."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    base = _requests(GenerationRequest, (37, 130, 300), 700, 24,
                     cfg.vocab_size, seed=3)
    first = _eng_run(model, base, {"max_seq_len": 1024})
    first[2].release()
    stream0 = first[0][0]
    eos = next(t for i, t in enumerate(stream0)
               if i >= 6 and t not in stream0[:i])
    reqs = [GenerationRequest(prompt=q.prompt, max_new_tokens=24,
                              eos_token_id=eos) for q in base]
    single = _eng_run(model, reqs, {"max_seq_len": 1024})
    single[2].release()
    L = cfg.num_hidden_layers
    for label, knob in (("scanned", {}), ("fused", {"fused_tick": True})):
        geo = dict(knob, max_seq_len=1024, decode_ticks=8)
        runs = {name: _eng_run(model, reqs, geo, kernels=k, graph=g)
                for name, k, g in (("graph", True, True),
                                   ("eager", True, False),
                                   ("plain", False, True))}
        eng = runs["graph"][2]
        st, tail = eng.stats, eng._tail
        on = runs["graph"][3]
        if label == "scanned":
            want = {"paged_decode": L * tail.ticks,
                    "ragged_attention": L * st["unified_steps"],
                    "fused_decode_tick": 0}
        else:
            want = {"paged_decode": 0,
                    "ragged_attention": L * (st["unified_steps"]
                                             - st["mtick_pure_syncs"]),
                    "fused_decode_tick": st["mtick_pure_syncs"]
                    + tail.ticks}
        ticks = {n: [c[1] for c in v[4]] for n, v in runs.items()}
        streams = {n: (v[0], v[1]) for n, v in runs.items()}
        same = len({str(v) for v in streams.values()}) == 1 \
            and streams["graph"] == (single[0], single[1])
        retired = _device_retirements(runs["graph"][4])
        line = {"phase": "engine", "check": "multitick", "tail": label,
                "dtype": "float32", "layers": L, "decode_ticks": 8,
                "eos": int(eos), "streams_equal": same,
                "stops": runs["graph"][1].count("stop"),
                "ticks_run_equal": len({str(v) for v in ticks.values()})
                == 1, "ticks_run": ticks["graph"],
                "mtick_ticks": st["mtick_ticks"],
                "mtick_syncs": st["mtick_syncs"],
                "tail_ticks_run": tail.ticks,
                "graph_captures": tail.captures,
                "device_retirements": retired,
                "launches": {n: on[n] for n in want},
                "launches_expected": want,
                "launches_plain": sum(runs["plain"][3].values())}
        for v in runs.values():
            v[2].release()
        del eng, runs
        torch.cuda.empty_cache()
        bad = {n: (on[n], w) for n, w in want.items() if on[n] != w}
        if label == "scanned":
            line.update(_multitick_pools(model, reqs, geo))
        emit(line)
        if not same or not line["ticks_run_equal"] or bad or not retired \
                or line["launches_plain"] or (
                    label == "scanned" and (not tail.captures
                                            or not line["pools_match"])):
            raise RuntimeError(f"multi-tick {label}: {line}")


def _multitick_pools(model, reqs, geo):
    """Two engines, the graph tail and the eager tail, stepped in lockstep
    until the first step that ran a tail: their pools must agree (fp32
    TOL; ``bitwise`` says whether every bit does)."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    engines = {}
    for graph in (True, False):
        engines[graph] = ContinuousBatchingEngine(model, headroom_mult=None,
                                                  **geo)
        for q in reqs:
            engines[graph].submit(q)
    try:
        for _ in range(64):
            for graph, eng in engines.items():
                set_flags({"FLAGS_cuda_graph_tail": graph})
                eng.step()
            if engines[True]._tail.ticks:
                break
    finally:
        set_flags({"FLAGS_cuda_graph_tail": True})
    torch.cuda.synchronize()
    a, b = engines[True].cache.pool, engines[False].cache.pool
    (ak,), (av,), (bk,), (bv,) = a.k, a.v, b.k, b.v          # one shard
    diff = max((ak - bk).abs().max().item(), (av - bv).abs().max().item())
    out = {"pools_max_abs_diff": diff,
           "pools_bitwise": bool(torch.equal(ak, bk)
                                 and torch.equal(av, bv)),
           "pools_match": diff <= TOL["float32"][0],
           "pools_after_tail_ticks": engines[True]._tail.ticks}
    for eng in engines.values():
        eng.release()
    return out


#: the speculative engine's draft depth in the engine and serve phases
SPEC_K = 4


def _repeating_requests(GenerationRequest, vocab, new, seed):
    """The engine phase's requests, and two whose prompts repeat a
    64-token stretch: the n-gram drafter finds drafts in both."""
    import numpy as np
    reqs = _requests(GenerationRequest, (37, 130, 300), 700, new, vocab,
                     seed=seed)
    r = np.random.RandomState(seed + 1)
    for n in (64, 150):
        part = r.randint(0, vocab, n).astype(np.int32)
        reqs.append(GenerationRequest(
            prompt=np.concatenate([part, part[:64], part[:64]]),
            max_new_tokens=new))
    return reqs


def _spec_pair(model, reqs, knob, label):
    """One speculative knob set against the same engine with speculation
    off: kernels and plain versions, streams and finish reasons equal
    across all four, the verify launches only ragged attention (and the
    cold prefill's flash forward), the pool whole once every request
    retired. Returns the emitted line."""
    spec = dict(knob, spec_decode=True, spec_k=SPEC_K)
    runs = {(s, use): _eng_run(model, reqs, spec if s else knob, kernels=use)
            for s in (True, False) for use in (True, False)}
    streams = {k: (v[0], v[1]) for k, v in runs.items()}
    eng, on = runs[(True, True)][2], runs[(True, True)][3]
    pool = eng.cache.pool
    whole = (eng.cache.num_free == eng.num_slots and (
        pool.num_free == pool.num_blocks if eng.prefix_cache is None
        else pool.num_used == eng.prefix_cache.num_cached_blocks)
        and not pool._ref.any())
    st = eng.stats
    line = {"phase": "engine", "check": "spec_decode", "case": label,
            "knobs": {k: (type(v).__name__ if k == "drafter" else v)
                      for k, v in knob.items()},
            "spec_k": SPEC_K, "dtype": "float32", "layers": 2,
            "streams_equal": len({str(v) for v in streams.values()}) == 1,
            "tokens": sum(len(x) for x in runs[(True, True)][0]),
            "spec_steps": st["spec_steps"],
            "spec_proposed": st["spec_proposed"],
            "spec_accepted": st["spec_accepted"],
            "acceptance": st["spec_accepted"] / max(st["spec_proposed"], 1),
            "tokens_per_verify": st["spec_tokens"] / max(st["decode_calls"],
                                                         1),
            "decode_compilations": eng.decode_compilations(),
            "pool_whole_after": whole, "launches_kernels": on,
            "launches_plain": sum(runs[(True, False)][3].values())}
    if eng.prefix_cache is not None:
        line["prefill_tokens_saved"] = st["prefill_tokens_saved"]
    for v in runs.values():
        v[2].release()
    emit(line)
    if not line["streams_equal"] or not whole or not st["spec_proposed"] \
            or on["paged_decode"] or on["fused_decode_tick"] \
            or on["ragged_attention"] != model.config.num_hidden_layers \
            * st["spec_steps"] \
            or line["launches_plain"] or line["decode_compilations"] != 1:
        raise RuntimeError(f"spec decode {label}: {line}")
    return line


def _tier_families(GenerationRequest, vocab, new):
    """Two 96-token system prompts (3 blocks each) taken in turn, one
    request at a time: under a 3-block trie budget each switch spills the
    other family's chain and each return readmits it."""
    import numpy as np
    r = np.random.RandomState(31)
    fams = [r.randint(0, vocab, 96).astype(np.int32) for _ in range(2)]
    return [[GenerationRequest(prompt=np.concatenate(
        [fams[i % 2], r.randint(0, vocab, 20 + 7 * i).astype(np.int32)]),
        max_new_tokens=new)] for i in range(6)]


def _engine_tier(model, bf16_model, cfg):
    """The host tier on fp32 (kernels and plain), int8 (kernels and plain)
    and bf16 (kernels) pools: under a 3-block trie budget one family's
    chain spills at every switch and readmits at every return. Its streams
    and finish reasons must equal the same engine without a tier whose
    budget keeps both families resident: readmitted blocks carry the bits
    they left with. (Without a tier an evicted prefix is recomputed, and a
    recompute at another prompt length may round a cached K/V value
    differently: a full step on an int8 pool.)"""
    from paddle_tpu_torch.serving import GenerationRequest
    waves = _tier_families(GenerationRequest, cfg.vocab_size, 12)
    legs = {"tier": dict(prefix_blocks=3, host_tier_bytes=1 << 30),
            "resident": dict(prefix_blocks=64)}
    for label, m, knob, uses in (("float32", model, {}, (True, False)),
                                 ("int8", model, {"kv_dtype": "int8"},
                                  (True, False)),
                                 ("bfloat16", bf16_model, {}, (True,))):
        runs = {(leg, use): _eng_run(m, waves, dict(
            knob, max_seq_len=1024, prefix_cache=True, **legs[leg]),
            kernels=use) for leg in legs for use in uses}
        eng = runs[("tier", True)][2]
        pc = eng.prefix_cache
        streams = {k: (v[0], v[1]) for k, v in runs.items()}
        line = {"phase": "engine", "check": "host_tier", "pool": label,
                "model_dtype": str(m.config.dtype), "layers": 2,
                "streams_equal": len({str(v) for v in streams.values()})
                == 1,
                "tier_vs_resident": {
                    ("kernels" if use else "plain"):
                    streams[("tier", use)] == streams[("resident", use)]
                    for use in uses},
                "kernels_vs_plain": {
                    leg: streams[(leg, True)] == streams[(leg, False)]
                    for leg in legs} if len(uses) == 2 else None,
                "tier_stats": {k: pc.stats[k] for k in (
                    "hits", "evictions", "spilled_blocks", "tier_hits",
                    "readmitted_blocks", "tier_evictions")},
                "resident_hits": runs[("resident", True)][2]
                .prefix_cache.stats["hits"],
                "tier_bytes": pc.tier.bytes_used,
                "staging_allocations": sum(
                    pc.pool.staging.allocations.values()),
                "launches_kernels": runs[("tier", True)][3]}
        for v in runs.values():
            v[2].release()
        emit(line)
        if not line["streams_equal"] \
                or not pc.stats["readmitted_blocks"] \
                or not pc.stats["spilled_blocks"]:
            raise RuntimeError(f"host tier {label}: {line}")


#: the engine phase's two-class table: latency outranks batch, its TTFT
#: target 80 ms, urgent at half of it
POLICY_CLASSES = dict(classes="latency,batch*", slo_ttft_ms="80,0")


def _policy_run(model, reqs, classes, kernels):
    """Two batch requests fill both slots; three steps later a latency
    request arrives and waits past half its TTFT target on the engine's
    virtual clock, so it preempts one. Returns (streams, finish reasons,
    stats, launches)."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          VirtualClock)
    from paddle_tpu_torch.serving.policy import ClassTable
    clk = VirtualClock()
    try:
        set_flags({"FLAGS_use_cuda_kernels": kernels})
        eng = ContinuousBatchingEngine(
            model, num_slots=2, max_seq_len=1024, headroom_mult=None,
            step_clock=clk, priority_classes=(
                ClassTable.parse(**classes) if classes else None))
        reset_launches()
        seqs = [eng.submit(q) for q in reqs[:2]]
        for _ in range(3):
            eng.step()
            clk.advance(0.001)
        seqs.append(eng.submit(reqs[2]))
        clk.advance(0.05)
        while eng.has_work():
            eng.step()
            clk.advance(0.001)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    out = ([list(s.tokens) for s in seqs], [s.finish_reason for s in seqs],
           {k: eng.stats[k] for k in ("policy_preemptions", "preemptions",
                                      "restores")}, launches)
    eng.release()
    return out


def _engine_policy(model, cfg):
    """Two classes: the urgent latency request displaces a running batch
    one (``policy_preemptions >= 1``); kernels and plain versions, every
    stream and finish reason equal the policy-off run's."""
    import numpy as np
    from paddle_tpu_torch.serving import GenerationRequest
    r = np.random.RandomState(41)
    V = cfg.vocab_size
    reqs = [GenerationRequest(prompt=r.randint(0, V, 120).astype(np.int32),
                              max_new_tokens=24, priority_class="batch"),
            GenerationRequest(prompt=r.randint(0, V, 90).astype(np.int32),
                              max_new_tokens=24, temperature=0.9, top_k=5,
                              seed=3, priority_class="batch"),
            GenerationRequest(prompt=r.randint(0, V, 40).astype(np.int32),
                              max_new_tokens=8, priority_class="latency")]
    plain_reqs = [GenerationRequest(prompt=q.prompt,
                                    max_new_tokens=q.max_new_tokens,
                                    temperature=q.temperature,
                                    top_k=q.top_k, seed=q.seed)
                  for q in reqs]
    runs = {(on, use): _policy_run(model, reqs if on else plain_reqs,
                                   POLICY_CLASSES if on else None, use)
            for on in (True, False) for use in (True, False)}
    streams = {k: (v[0], v[1]) for k, v in runs.items()}
    st = runs[(True, True)][2]
    line = {"phase": "engine", "check": "priority_classes",
            "classes": POLICY_CLASSES, "dtype": "float32", "layers": 2,
            "streams_equal": len({str(v) for v in streams.values()}) == 1,
            "policy_preemptions": st["policy_preemptions"],
            "policy_preemptions_plain": runs[(True, False)][2][
                "policy_preemptions"],
            "restores": st["restores"],
            "policy_off_preemptions": runs[(False, True)][2][
                "policy_preemptions"],
            "launches_kernels": runs[(True, True)][3]}
    emit(line)
    if not line["streams_equal"] or st["policy_preemptions"] < 1 \
            or line["policy_preemptions_plain"] != st["policy_preemptions"]:
        raise RuntimeError(f"priority classes: {line}")


def _engine_step9(model, cfg):
    """Speculative decode (n-gram drafter; the target drafting for itself;
    an int8 pool; with the prefix cache), the host tier (fp32, int8 and
    bf16 pools) and the priority-class policy at 7B widths, 2 layers."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving.drafter import ModelDrafter
    reqs = _repeating_requests(GenerationRequest, cfg.vocab_size, 16,
                               seed=3)
    _spec_pair(model, reqs, {"max_seq_len": 1024}, "ngram")
    oracle = _spec_pair(model, reqs[:3], {"max_seq_len": 1024,
                                          "drafter": ModelDrafter(model)},
                        "oracle_target_drafts")
    if oracle["acceptance"] < 0.9:
        raise RuntimeError(f"the target drafting for itself accepted "
                           f"{oracle['acceptance']}")
    _spec_pair(model, reqs, {"max_seq_len": 1024, "kv_dtype": "int8"},
               "kv_int8")
    # two waves of the same requests: the second hits the blocks the
    # first donated, and its repeating prompts still draw drafts
    _spec_pair(model, [reqs, reqs], {"max_seq_len": 1024,
                                     "prefix_cache": True}, "prefix_cache")
    bf16 = LlamaForCausalLM(llama_7b(num_hidden_layers=2, dtype="bfloat16"),
                            device="cuda", seed=1)
    _engine_tier(model, bf16, cfg)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    _engine_policy(model, cfg)


def _capture_probe():
    """Whether the fused tick's cooperative launch captures into a CUDA
    graph on this card: one fused tick (7B widths, 2 layers, fp32, 8 rows)
    with its lengths, mask and knobs on the device, warmed eagerly, then
    captured; the replay held bit for bit against an eager launch on the
    same pool. Run in a child process (``--capture-probe``): a failed
    capture cannot reach this process's CUDA state. Prints one line."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_7b,
                                               llama_decode_params)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=FUSED_LAYERS,
                                      dtype="float32"), device=dev, seed=6)
    p, tied = llama_decode_params(model)
    t = tick_inputs(torch.float32, dev, gen, FUSED_LAYERS, heads=HEADS)
    t.update(lens=torch.from_numpy(t["lens"]).to(dev),
             app_mask=torch.from_numpy(t["app_mask"]).to(dev),
             temps=torch.from_numpy(t["temps"]).to(dev),
             top_ks=torch.from_numpy(t["top_ks"]).to(dev))
    base = (t["pool_k"].clone(), t["pool_v"].clone())
    warm = _tick(fdt.fused_decode_tick, p, tied, dict(t), heads=HEADS)
    t["kys"] = warm[3].clone()                  # device keys from now on
    eager = _tick(fdt.fused_decode_tick, p, tied,
                  dict(t, pool_k=base[0].clone(), pool_v=base[1].clone()),
                  heads=HEADS)
    line = {"phase": "engine", "check": "cooperative_capture"}
    try:
        cap = dict(t, pool_k=base[0].clone(), pool_v=base[1].clone())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _tick(fdt.fused_decode_tick, p, tied, cap, heads=HEADS)
        graph.replay()
        torch.cuda.synchronize()
        line.update(captured=True, replay_equals_eager=bool(
            torch.equal(out[0], eager[0]) and torch.equal(out[3], eager[3])
            and torch.equal(cap["pool_k"], eager[1])))
    except RuntimeError as err:
        # the capture's end reports the invalidated capture; the launch
        # that broke it is the exception before it
        line.update(captured=False, error=str(err).splitlines()[0][:300],
                    cause=str(err.__context__ or "").splitlines()[0][:300]
                    if err.__context__ else None)
    emit(line)


def _serve_requests(GenerationRequest, vocab):
    """7 short prompts (100-500 tokens, one seeded top-k) and one
    1600-token prompt that chunks, 64 new tokens each."""
    import numpy as np
    reqs = _requests(GenerationRequest, (100, 180, 250, 333, 410, 470),
                     1600, 64, vocab, seed=7)
    r = np.random.RandomState(8)
    reqs.insert(3, GenerationRequest(
        prompt=r.randint(0, vocab, 500).astype(np.int32),
        max_new_tokens=64, temperature=0.8, top_k=40, seed=1234))
    return reqs


def _serve(model, reqs, **knob):
    """One engine run to completion on the default geometry (plus
    ``knob``); returns (seqs, engine, each step's host ms, wall)."""
    import torch
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **knob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_ms = []
    seqs = [eng.submit(q) for q in reqs]
    while eng.has_work():
        ts = time.perf_counter()
        eng.step()
        step_ms.append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    return seqs, eng, step_ms, time.perf_counter() - t0


def _expected_serve_launches(label, eng, layers):
    """Launch counts the code implies for one serve run: an int is exact,
    ``"+"`` means at least one."""
    st = eng.stats
    label = QUANT_SERVE_BASE.get(label, label)
    if label == "default":
        # tick 0 of every unified step through ragged attention, every
        # tail tick (decode ticks past tick 0 of a step) through paged
        # decode, each once a layer
        return {"flash": "+", "ragged_attention": layers
                * st["unified_steps"], "paged_decode": layers
                * (st["decode_steps"] - st["decode_calls"]),
                "fused_decode_tick": 0, "decode": 0}
    if label == "fused_tick":
        # one launch per tail tick (decode ticks past tick 0 of a step),
        # and no paged decode: the fused kernel replaces it there
        return {"flash": "+", "ragged_attention": "+", "paged_decode": 0,
                "fused_decode_tick": st["decode_steps"] - st["decode_calls"],
                "decode": 0}
    if label == "mtick":
        # tick 0 of every step through ragged, and every tail tick the
        # device ran (graph replays counted) through paged decode
        return {"flash": "+", "ragged_attention": layers
                * st["unified_steps"], "paged_decode": layers
                * eng._tail.ticks, "fused_decode_tick": 0, "decode": 0}
    if label == "spec":
        # one verify launch a step: ragged attention for every layer, no
        # decode kernel
        return {"flash": "+", "ragged_attention": layers
                * st["spec_steps"], "paged_decode": 0,
                "fused_decode_tick": 0, "decode": 0}
    return {"flash": "+", "ragged_attention": 0, "paged_decode": 0,
            "fused_decode_tick": 0, "decode": layers * st["decode_steps"]}


def fused_tick_timing(eng, layers, heads=HEADS):
    """One tail tick at the serve geometry and depth on the engine's pool:
    the fused kernel and the scanned tick through the kernels (CUDA
    events), beside the tick's byte bound; and the fused tick again with
    every row at length 1, whose attention reads almost nothing: the
    difference between the two is the attention's share of the tick."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    pools = [side[0] for side in eng.cache.kv_args()]     # the one shard
    dt = eng._params["embed"].dtype
    dev = eng.cache.pool.k[0].device
    t = tick_inputs(dt, dev, None, layers, pools=pools, heads=heads)
    t1 = tick_inputs(dt, dev, None, layers, pools=pools, lens=[1] * SLOTS,
                     heads=heads)
    p, tied = eng._params, eng._tied
    nbytes, flops = tick_cost(p, t, layers,
                              torch.tensor([], dtype=dt).element_size(),
                              heads=heads)
    tick = time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, t,
                                 heads=heads))
    grid = dict(fdt.LAST_GRID)
    tick1 = time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, t1,
                                  heads=heads))
    return {"tick_ms": tick, "grid_blocks": grid["blocks"],
            "blocks_per_sm": grid["blocks_per_sm"],
            "tick_len1_ms": tick1, "attention_ms": tick - tick1,
            "scanned_tick_ms": time_ms(lambda: _tick(_scanned_tick, p,
                                                     tied, t, heads=heads)),
            "tick_bytes": nbytes,
            "tick_bound_ms": bound_ms(nbytes, flops, "bfloat16")}, t


def _serve_run(model, cfg, reqs, label, knob, profile, heads=HEADS,
               phase="serve"):
    """One measured serve run of one engine: a warm-up run first, counts
    set to 0 just before the measured run and read just after it."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import GenerationRequest
    # warm-up: first use of cuBLAS, the kernels and the allocator is not
    # serving time (a short and a long prompt touch every program)
    warm = _serve(model, _requests(GenerationRequest, (100,), 600, 9,
                                   cfg.vocab_size, seed=5), **knob)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, eng, step_ms, wall = _serve(model, reqs, **knob)
    steps = len(step_ms)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches[n] for n in BWD):
        raise RuntimeError(f"serving launched a backward kernel: {launches}")
    toks = [s.tokens for s in seqs]
    for s in seqs:
        if s.finish_reason != "length" or len(s.tokens) != 64:
            raise RuntimeError(f"{label} request {s.request_id}: "
                               f"{s.finish_reason}, {len(s.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in s.tokens):
            raise RuntimeError("token id out of the vocabulary")
    decoded = sum(len(t) for t in toks)
    want = _expected_serve_launches(label, eng, cfg.num_hidden_layers)
    line = {"phase": phase, "engine": label, "knobs": knob,
            "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
            "requests": len(reqs), "decoded_tokens": decoded,
            "wall_s": wall, "decoded_tok_per_s": decoded / wall,
            "steps": steps, "mean_step_ms": 1e3 * wall / steps,
            "step_ms": [round(t, 3) for t in step_ms],
            "decode_ticks": eng.stats["decode_steps"],
            "tail_ticks": (eng.stats["decode_steps"]
                           - eng.stats["decode_calls"]),
            "prefill_chunks": eng.stats["prefill_chunks"],
            "peak_mem_gb": peak,
            "launches": {n: launches[n] for n in want},
            "launches_expected": want,
            "first_tokens": [t[:4] for t in toks]}
    tick = None
    if knob.get("fused_tick"):
        timing, tick = fused_tick_timing(eng, cfg.num_hidden_layers, heads)
        line.update(timing)
    if label in QUANT_SERVE_BASE:
        line.update(kv_dtype=eng.kv_dtype,
                    quantize_weights=eng.quantize_weights,
                    bytes_per_token=eng.cache.bytes_per_token(),
                    pool_bytes=eng.cache.occupancy_bytes())
    if label == "spec":
        line.update(_spec_stats(eng))
    if label == "mtick":
        line.update(mtick_syncs=eng.stats["mtick_syncs"],
                    mtick_ticks=eng.stats["mtick_ticks"],
                    tail_ticks_run=eng._tail.ticks,
                    graph_captures=eng._tail.captures)
    emit(line)
    bad = {n: (launches[n], w) for n, w in want.items()
           if (launches[n] <= 0 if w == "+" else launches[n] != w)}
    if bad:
        raise RuntimeError(f"{label} serve launches (got, expected): {bad}")
    eng.release()
    del eng, tick
    gc.collect()
    torch.cuda.empty_cache()
    if (profile and label in ("default", "dense", "mtick")) \
            or label in QUANT_SERVE_BASE:
        phase_profile(model, reqs, toks, label, knob)
    if profile and label == "fused_tick":
        phase_profile_fused(model, cfg, reqs, toks)
    return launches, toks


def phase_serve(model, profile=False):
    """The main runs: 7B widths, bf16, 8 requests through each of the
    engine's three decode programs (the default engine, ``fused_tick``,
    ``paged_attn=False``), one engine freed before the next. With
    ``profile``, a repeat of each run under ``torch.profiler`` reports
    device time by kernel and the device's busy share. Returns each
    kernel's launches on the run of its path."""
    import torch
    from paddle_tpu_torch.serving import GenerationRequest
    cfg = model.config
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    runs = {label: _serve_run(model, cfg, reqs, label, knob, profile)
            for label, knob, _ in ENGINES + MTICK + SPEC_SERVE
            + QUANT_SERVE}
    streams = {label: toks for label, (_, toks) in runs.items()}
    emit({"phase": "serve", "check": "streams_vs_default",
          "equal": {label: streams[label] == streams["default"]
                    for label in streams}})
    launches = {n: runs["default"][0][n]
                for n in ("flash", "ragged_attention", "paged_decode")}
    for label, _, own in ENGINES[1:]:
        launches[own] = runs[label][0][own]
    # the int8 modes' launches on their main path: the quantized runs
    for n in ("ragged_attention", "paged_decode"):
        launches[(n, "int8")] = runs["int8_w8"][0][n]
    launches[("fused_decode_tick", "int8_w8")] = \
        runs["int8_w8_fused"][0]["fused_decode_tick"]
    # the int8 parameters are cached on the model for its engines; the
    # later runs and phases serve bf16 weights, so they go
    model.__dict__.pop("_decode_qparams", None)
    gc.collect()
    torch.cuda.empty_cache()
    serve_prefix(model, cfg)
    serve_oracle(model, cfg)
    serve_tier(model, cfg)
    return launches


#: the multi-tick serve run: the default engine with decode_ticks=8
MTICK = (("mtick", {"decode_ticks": 8}, None),)
#: the speculative serve run: the n-gram drafter, SPEC_K drafts a row
SPEC_SERVE = (("spec", {"spec_decode": True, "spec_k": SPEC_K}, None),)
#: the quantized serve runs: an int8 pool and int8 weights on the default
#: engine, then with the fused tick; the engine whose launch counts each
#: follows
QUANT_SERVE = (("int8_w8", {"kv_dtype": "int8", "quantize_weights": True},
                None),
               ("int8_w8_fused", {"kv_dtype": "int8", "quantize_weights": True,
                                  "fused_tick": True}, "fused_decode_tick"))
QUANT_SERVE_BASE = {"int8_w8": "default", "int8_w8_fused": "fused_tick"}
#: the prefix serve run: a shared prefix, distinct tails, the trie's budget
PREFIX_LEN, PREFIX_TAILS, PREFIX_BLOCKS = 1024, (64, 96, 128, 160, 192,
                                                 224, 256, 80), 512


def serve_prefix(model, cfg):
    """8 requests on a shared 1024-token prefix with distinct tails of
    64-256 tokens, 64 new tokens each, after one priming request that
    publishes the prefix: ``prefix_cache=True, prefix_blocks=512`` (+8 GiB
    of pool at 7B bf16) and then ``prefix_cache=False``. Wall, TTFT (from
    the submit to the host's receipt of the first token, read in the
    engine's ``on_token`` hook after the step's device sync; the engine's
    own ``t_first_token`` is its step-start stamp), tokens saved, hit
    rate, peak memory (the suffix programs' float32 logits are their
    peak)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    r = np.random.RandomState(9)
    V = cfg.vocab_size
    prefix = r.randint(0, V, PREFIX_LEN).astype(np.int32)
    prime = GenerationRequest(prompt=np.concatenate(
        [prefix, r.randint(0, V, 16).astype(np.int32)]), max_new_tokens=1)
    reqs = [GenerationRequest(prompt=np.concatenate(
        [prefix, r.randint(0, V, n).astype(np.int32)]), max_new_tokens=64)
        for n in PREFIX_TAILS]
    lines = {}
    for cache in (True, False):
        knob = (dict(prefix_cache=True, prefix_blocks=PREFIX_BLOCKS)
                if cache else {})
        eng = ContinuousBatchingEngine(model, **knob)
        eng.generate([prime])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        first = {}
        eng.on_token = lambda seq, tok: first.setdefault(
            seq.request_id, time.perf_counter())
        t0 = time.perf_counter()
        seqs = [eng.submit(q) for q in reqs]
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        decoded = sum(len(x.tokens) for x in seqs)
        pc = eng.prefix_cache
        lines[cache] = {
            "phase": "serve", "check": "prefix", "prefix_cache": cache,
            "prefix_blocks": PREFIX_BLOCKS if cache else None,
            "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
            "requests": len(reqs), "prefix_tokens": PREFIX_LEN,
            "tails": list(PREFIX_TAILS), "wall_s": wall, "steps": steps,
            "decoded_tok_per_s": decoded / wall,
            "mean_ttft_s": float(np.mean([first[x.request_id] - t0
                                          for x in seqs])),
            "max_ttft_s": max(first[x.request_id] - t0 for x in seqs),
            "prefill_tokens_saved": eng.stats["prefill_tokens_saved"],
            "hit_rate": pc.hit_rate() if pc is not None else None,
            "pool_blocks": eng.cache.pool.num_blocks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": dict(LAUNCHES),
            "first_tokens": [x.tokens[:4] for x in seqs]}
        for x in seqs:
            if x.finish_reason != "length" or len(x.tokens) != 64:
                raise RuntimeError(f"prefix run request {x.request_id}: "
                                   f"{x.finish_reason}")
        eng.release()
        del eng, seqs
        gc.collect()
        torch.cuda.empty_cache()
    hit, cold = lines[True], lines[False]
    hit["ttft_vs_cold"] = cold["mean_ttft_s"] / hit["mean_ttft_s"]
    hit["streams_equal_cold"] = hit["first_tokens"] == cold["first_tokens"]
    for line in (hit, cold):
        emit(line)
    if hit["prefill_tokens_saved"] != PREFIX_LEN * len(reqs) \
            or not hit["launches"]["paged_decode"]:
        raise RuntimeError(f"prefix serve run: {hit}")


def _spec_stats(eng):
    """A speculative engine's acceptance: drafts proposed and accepted,
    their ratio, and tokens emitted per verify launch (all rows) and per
    verify span (one row)."""
    st = eng.stats
    return {"spec_steps": st["spec_steps"],
            "spec_proposed": st["spec_proposed"],
            "spec_accepted": st["spec_accepted"],
            "spec_tokens": st["spec_tokens"],
            "acceptance": st["spec_accepted"] / max(st["spec_proposed"], 1),
            "tokens_per_verify_launch": st["spec_tokens"]
            / max(st["decode_calls"], 1),
            # each span emits its accepted drafts plus one token
            "tokens_per_verify_span": st["spec_tokens"]
            / max(st["spec_tokens"] - st["spec_accepted"], 1)}


def serve_oracle(model, cfg):
    """The target drafting for itself (``ModelDrafter(model)``, the
    always-accept oracle) at full width: 2 requests x 32 tokens, spec_k
    SPEC_K; acceptance and tokens per verify launch measured, streams
    against the same requests with speculation off."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving.drafter import ModelDrafter
    r = np.random.RandomState(13)
    reqs = [GenerationRequest(prompt=r.randint(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=32) for n in (100, 200)]
    base, eng, _, _ = _serve(model, reqs)
    want = [s.tokens for s in base]
    eng.release()
    del eng
    reset_launches()
    seqs, eng, step_ms, wall = _serve(model, reqs, spec_decode=True,
                                      spec_k=SPEC_K,
                                      drafter=ModelDrafter(model))
    launches = dict(LAUNCHES)
    L = cfg.num_hidden_layers
    line = {"phase": "serve", "check": "spec_oracle", "layers": L,
            "dtype": "bfloat16", "requests": len(reqs), "new_tokens": 32,
            "spec_k": SPEC_K, **_spec_stats(eng), "wall_s": wall,
            "decoded_tok_per_s": sum(len(s.tokens) for s in seqs) / wall,
            "equal_spec_off": [s.tokens for s in seqs] == want,
            "launches": {n: launches[n] for n in ("flash",
                                                  "ragged_attention",
                                                  "paged_decode")}}
    eng.release()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    if launches["ragged_attention"] != L * line["spec_steps"] \
            or launches["paged_decode"] or not line["spec_proposed"] \
            or any(s.finish_reason != "length" for s in seqs):
        raise RuntimeError(f"spec oracle serve run: {line}")


#: the tier run's trie budget: below the 32 blocks of one 1024-token
#: prefix, so two prefixes taken in turn evict (spill) each other whole
#: and each admission readmits its own
TIER_PREFIX_BLOCKS = 24
TIER_TAILS = (64, 96, 128, 160)
#: blocks read and written back by the d2h/h2d rate probe
TIER_PROBE_BLOCKS = 16


def _tier_rate(pool, n):
    """d2h and h2d GB/s of the tier's transfers on ``pool``: ``n`` blocks
    read into staging buffers (each read waits for its copy) and written
    back to the same blocks (unchanged bytes), after one warm-up round
    that allocates the pinned buffers."""
    import torch
    blocks = list(range(n))
    for timed in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bufs = [pool.read_block(b) for b in blocks]
        t_d2h = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b, x in zip(blocks, bufs):
            pool.write_block(b, x)
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t0
        nbytes = sum(int(t.nbytes) for x in bufs for t in x.values())
        for x in bufs:
            pool.recycle_staging(x)
    return {"probe_blocks": n, "probe_bytes": nbytes,
            "d2h_GBps": nbytes / t_d2h / 1e9, "h2d_GBps": nbytes / t_h2d / 1e9,
            "pinned": bool(bufs[0]["k"].is_pinned())}


def serve_tier(model, cfg):
    """TTFT of one request at a time on two 1024-token prefixes (32
    blocks of 16 MiB each at 7B bf16) taken in turn, after a priming
    request on each, in three states: cold (no cache), resident
    (``prefix_blocks=512``: both prefixes stay) and readmitted (a trie
    budget of TIER_PREFIX_BLOCKS with ``host_tier_bytes``: each admission
    readmits its prefix from the host tier, the other prefix spilling to
    make room). Tier bytes from the cost observatory's ledger, transfer
    rates from ``_tier_rate``; the readmitted leg's streams must equal the
    resident leg's."""
    import numpy as np
    import torch
    from paddle_tpu_torch.profiler.cost import CostObservatory
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    r = np.random.RandomState(19)
    V = cfg.vocab_size
    prefixes = [r.randint(0, V, PREFIX_LEN).astype(np.int32)
                for _ in range(2)]
    primes = [GenerationRequest(prompt=np.concatenate(
        [p, r.randint(0, V, 16).astype(np.int32)]), max_new_tokens=1)
        for p in prefixes]
    reqs = [GenerationRequest(prompt=np.concatenate(
        [prefixes[i % 2], r.randint(0, V, n).astype(np.int32)]),
        max_new_tokens=8) for i, n in enumerate(TIER_TAILS)]
    legs = (("cold", {}),
            ("resident", {"prefix_cache": True,
                          "prefix_blocks": PREFIX_BLOCKS}),
            ("readmitted", {"prefix_cache": True,
                            "prefix_blocks": TIER_PREFIX_BLOCKS,
                            "host_tier_bytes": 8 << 30}))
    lines = {}
    for label, knob in legs:
        eng = ContinuousBatchingEngine(model, **knob)
        co = eng.cost = CostObservatory()
        for q in primes:
            eng.generate([q])
        torch.cuda.synchronize()
        pc = eng.prefix_cache
        ttft, readmitted, spilled, toks = [], [], [], []
        for q in reqs:
            first = {}
            eng.on_token = lambda seq, tok: first.setdefault(
                seq.request_id, time.perf_counter())
            n0 = dict(pc.stats) if pc is not None else None
            t0 = time.perf_counter()
            seq = eng.submit(q)
            while eng.has_work():
                eng.step()
            torch.cuda.synchronize()
            ttft.append(first[seq.request_id] - t0)
            if pc is not None:
                readmitted.append(pc.stats["readmitted_blocks"]
                                  - n0["readmitted_blocks"])
                spilled.append(pc.stats["spilled_blocks"]
                               - n0["spilled_blocks"])
            toks.append(seq.tokens)
        line = {"phase": "serve", "check": "tier", "leg": label,
                "knobs": knob, "layers": cfg.num_hidden_layers,
                "dtype": "bfloat16", "prefix_tokens": PREFIX_LEN,
                "tails": list(TIER_TAILS), "ttft_s": ttft,
                "mean_ttft_s": float(np.mean(ttft)),
                "readmitted_blocks": readmitted, "spilled_blocks": spilled,
                "tokens": toks, "block_bytes": eng.cache.pool.block_nbytes}
        if pc is not None:
            line["trie"] = {k: pc.stats[k] for k in (
                "hits", "hit_blocks", "evictions", "spilled_blocks",
                "tier_hits", "readmitted_blocks", "tier_evictions")}
        if pc is not None and pc.tier is not None:
            line.update(tier_d2h_bytes=co.tier_bytes("d2h"),
                        tier_h2d_bytes=co.tier_bytes("h2d"),
                        tier_bytes_held=pc.tier.bytes_used,
                        **_tier_rate(eng.cache.pool, TIER_PROBE_BLOCKS))
        lines[label] = line
        eng.release()
        del eng, pc
        gc.collect()
        torch.cuda.empty_cache()
    tier, res = lines["readmitted"], lines["resident"]
    tier["streams_equal_resident"] = tier["tokens"] == res["tokens"]
    tier["streams_equal_cold"] = tier["tokens"] == lines["cold"]["tokens"]
    tier["ttft_vs_resident"] = tier["mean_ttft_s"] / res["mean_ttft_s"]
    tier["ttft_vs_cold"] = tier["mean_ttft_s"] / lines["cold"]["mean_ttft_s"]
    for line in lines.values():
        emit(line)
    if not tier["streams_equal_resident"] \
            or not all(tier["readmitted_blocks"]) \
            or any(res["readmitted_blocks"]) \
            or not tier["tier_h2d_bytes"] or not tier["tier_d2h_bytes"]:
        raise RuntimeError(f"tier serve run: {tier}")


# ------------------------------------------------------------- front door
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_CHUNK = 4, 128, 64, 16


def _generate_ticks(new, chunk):
    """The unified steps and tail ticks ``generate`` runs for ``new``
    tokens when no row stops early: token 0 comes from the prefill, then
    each step fuses the largest power of two fitting the chunk and the
    rows' remaining budget (``FIFOScheduler.choose_num_steps``)."""
    steps, tail, left = 0, 0, new - 1
    while left:
        n = 1
        while n * 2 <= min(left, chunk):
            n *= 2
        steps, tail, left = steps + 1, tail + n - 1, left - n
    return steps, tail


def _launch_check(label, got, want):
    bad = {n: (got[n], w) for n, w in want.items() if got[n] != w}
    if bad:
        raise RuntimeError(f"{label} launches (got, expected): {bad}")


def _generate_vs_direct(model, phase, legs):
    """``model.generate`` at the model's width and depth: B=4 prompts of
    128 tokens, 64 new tokens, one run a leg (``legs``: label -> its
    sampling keywords), each equal to a direct
    ``ContinuousBatchingEngine(num_slots=4, prefill_bucketing="exact",
    decode_chunk=16)`` run with generate's fold_in keys; flash, ragged and
    paged decode launches equal what the code implies. Emits the
    ``phase`` line; returns the prompts, the launches the code implies
    and each leg's (ids, seconds, launches)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import random as prng
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    cfg = model.config
    L = cfg.num_hidden_layers
    ids = np.random.RandomState(17).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    model.generate(ids[:, :32], max_new_tokens=4)          # warm-up
    runs = {}
    for label, kw in legs.items():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        runs[label] = (out.cpu().numpy(), time.perf_counter() - t0,
                       dict(LAUNCHES))
    steps, tail = _generate_ticks(GEN_NEW, GEN_CHUNK)
    want = {"flash": L, "ragged_attention": L * steps,
            "paged_decode": L * tail, "fused_decode_tick": 0, "decode": 0}
    same = {}
    for label, kw in legs.items():
        base = prng.PRNGKey(kw.get("seed", 0))
        eng = ContinuousBatchingEngine(
            model, num_slots=GEN_BATCH, max_seq_len=GEN_PROMPT + GEN_NEW,
            prefill_bucketing="exact", decode_chunk=GEN_CHUNK)
        outs = eng.generate([GenerationRequest(
            prompt=ids[i], max_new_tokens=GEN_NEW,
            temperature=kw.get("temperature", 0.0),
            top_k=kw.get("top_k", 0),
            prng_key=prng.fold_in(base, i).numpy())
            for i in range(GEN_BATCH)])
        same[label] = bool(np.array_equal(
            runs[label][0], np.stack([np.asarray(o) for o in outs])))
        del eng
    tokens = GEN_BATCH * GEN_NEW
    emit({"phase": phase, "layers": L, "dtype": cfg.dtype,
          "batch": GEN_BATCH, "prompt": GEN_PROMPT,
          "new_tokens": GEN_NEW, "decode_chunk": GEN_CHUNK,
          "wall_s": {k: v[1] for k, v in runs.items()},
          "tok_per_s": {k: tokens / v[1] for k, v in runs.items()},
          "launches": {n: runs["greedy"][2][n] for n in want},
          "launches_expected": want,
          "unified_steps": steps, "tail_ticks": tail,
          **{f"{label}_equals_direct": v for label, v in same.items()},
          "first_tokens": runs["greedy"][0][:, :4].tolist()})
    for label, (out, _, launches) in runs.items():
        _launch_check(f"{phase} {label}", launches, want)
        if out.shape != (GEN_BATCH, GEN_NEW) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise RuntimeError(f"{phase} {label}: ids {out.shape} out of "
                               f"range")
    for label, equal in same.items():
        if not equal:
            raise RuntimeError(f"{phase} {label} differs from the direct "
                               f"engine run")
    return ids, want, runs


def phase_generate(model):
    """``model.generate`` at llama_7b's width and depth (32 layers, bf16):
    greedy and seeded top-k, each against a direct engine run
    (``_generate_vs_direct``), and the seeded call again (the two equal).
    Then the fp32 check at 7B widths, 2 layers: kernels vs plain
    versions."""
    import numpy as np
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    sampled = dict(temperature=0.8, top_k=40, seed=5)
    ids, want, runs = _generate_vs_direct(
        model, "generate", {"greedy": {}, "top_k": sampled})
    reset_launches()
    again = model.generate(ids, max_new_tokens=GEN_NEW, **sampled)
    _launch_check("generate top_k_again", dict(LAUNCHES), want)
    repeat = bool(np.array_equal(runs["top_k"][0], again.cpu().numpy()))
    emit({"phase": "generate", "check": "seeded_repeat", "equal": repeat})
    if not repeat:
        raise RuntimeError("two seeded generate calls gave other ids")
    # fp32, 7B widths, 2 layers: kernels vs plain versions
    small = LlamaForCausalLM(llama_7b(num_hidden_layers=2,
                                      dtype="float32"), device="cuda",
                             seed=2)
    fp32 = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            fp32[use] = (small.generate(ids, max_new_tokens=32).cpu().numpy(),
                         dict(LAUNCHES))
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    same = bool(np.array_equal(fp32[True][0], fp32[False][0]))
    emit({"phase": "generate", "check": "fp32_kernels_vs_plain",
          "layers": 2, "ids_equal": same,
          "launches_kernels": {n: fp32[True][1][n] for n in want},
          "launches_plain": sum(fp32[False][1].values())})
    del small
    torch.cuda.empty_cache()
    if not same or sum(fp32[False][1].values()) \
            or not fp32[True][1]["paged_decode"]:
        raise RuntimeError("fp32 generate: kernels and plain versions "
                           "differ, or the launches are wrong")
    return runs["greedy"][2]


def phase_llama13b():
    """LLaMA-13B served (Queue A step 12c's ``llama_13b``: 40 heads of
    128 over 40 KV heads, hidden 5120, FFN 13824, 40 layers). First each
    serving kernel against its plain version at ``H13`` in bf16, at the
    ``kernels`` phase's shapes (``L13_KERNELS``: ragged's packed tick-0
    buffer, both grids, and its edge spans; paged and dense decode at
    B=8, ``S_max`` 4096; flash at B=4, S=512 and 2048; the fused tick at
    13B widths, 2 layers, 8 and 37 rows), the same bits twice. Then 13B
    widths at 2 layers in fp32 through the three engines, kernels against
    plain (``_three_engines``). Then the whole model, 40 layers in bf16
    (26.0 GB of seeded weights), on the serve phase's 8 requests through
    the default, the fused-tick and the dense engine, one freed before
    the next, each run's launches the code's count at 40 layers; and
    ``model.generate`` against a direct engine run. Returns the ``@13b``
    rows and their launches on this path."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_13b
    from paddle_tpu_torch.serving import GenerationRequest
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    info = {"geometry": "llama_13b", "heads": H13.h, "kv_heads": H13.hkv,
            "head_dim": H13.d}
    rows = {}
    for name in L13_KERNELS:
        row = (fused_case(name, "bfloat16", dev, gen, heads=H13,
                          config=llama_13b())
               if name == "fused_decode_tick"
               else kernel_case(name, "bfloat16", dev, gen, heads=H13))
        rows[name] = dict(row, **info)
        emit({"phase": "llama13b", **rows[name]})
        torch.cuda.empty_cache()
    # llama_13b fixes the depth (its overrides pass no layer count on)
    small = dataclasses.replace(llama_13b(dtype="float32"),
                                num_hidden_layers=2)
    model = LlamaForCausalLM(small, device="cuda", seed=1)
    _three_engines(model, small, "llama13b")
    del model
    _free()
    cfg = llama_13b(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    emit({"phase": "llama13b", "check": "model",
          "parameters": sum(p.numel() for p in model.parameters()),
          "weights_gb": sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9,
          "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30})
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    runs = {label: _serve_run(model, cfg, reqs, label, knob, False,
                              heads=H13, phase="llama13b")
            for label, knob, _ in ENGINES}
    streams = {label: toks for label, (_, toks) in runs.items()}
    emit({"phase": "llama13b", "check": "streams_vs_default",
          "equal": {label: streams[label] == streams["default"]
                    for label in streams}})
    launches = {n: runs["default"][0][n]
                for n in ("flash", "ragged_attention", "paged_decode")}
    for label, _, own in ENGINES[1:]:
        launches[own] = runs[label][0][own]
    _free()
    _generate_vs_direct(model, "llama13b_generate", {"greedy": {}})
    del model, runs
    _free()
    return rows, launches


def parse_prometheus(text):
    """Strict Prometheus v0.0.4 text parse: ``{family: {"type",
    "samples": {(name, labels): value}}}``; raises on a malformed line, a
    sample outside its family's block or a missing final newline."""
    import re
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? '
                        r'([^ ]+)$')
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    fams, cur = {}, None
    for line in text.splitlines():
        if not line.strip() or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(f"bad TYPE line {line!r}")
            fams[name] = {"type": kind, "samples": {}}
            cur = name
            continue
        m = sample.match(line)
        if not m or cur is None or not m.group(1).startswith(cur):
            raise ValueError(f"malformed sample line {line!r}")
        labels = tuple(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"',
                                  m.group(2) or ""))
        fams[cur]["samples"][(m.group(1), labels)] = float(m.group(3))
    return fams


def _http(url, payload=None, timeout=600):
    """GET (or POST ``payload`` as JSON); returns the decoded body."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=timeout) as r:
        return r.read().decode()


def _sse(url, payload, timeout=600):
    """POST with stream=true; returns (token ids, finish_reason)."""
    import urllib.request
    body = json.dumps(dict(payload, stream=True)).encode()
    toks, reason = [], None
    with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                timeout=timeout) as r:
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ch = json.loads(line[6:])["choices"][0]
            if ch["finish_reason"] is not None:
                reason = ch["finish_reason"]
            else:
                toks.append(ch["token_id"])
    return toks, reason


def _payload(q):
    p = {"prompt": [int(t) for t in q.prompt],
         "max_tokens": int(q.max_new_tokens)}
    if q.temperature:
        p.update(temperature=q.temperature, top_k=q.top_k, seed=q.seed)
    return p


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


# ------------------------------------------------------------------ fleet
def _fleet_make(model, **kw):
    """An engine fleet of two replicas at the engines' serving knobs
    (``serve_fleet``'s: decode_chunk 1, the prefix cache), the chunk
    grant pinned (``headroom_mult=None``) so its streams can be held to
    a direct engine's, drivers stopped until ``start()``."""
    from paddle_tpu_torch.serving.fleet import EngineFleet
    kw.setdefault("replicas", 2)
    kw.setdefault("router", "round-robin")
    kw.setdefault("retry_backoff_s", 0.0)
    return EngineFleet(model, headroom_mult=None, start=False, **kw)


def _fleet_done(fleet):
    """Shut a fleet down and free its replicas' pools and graphs."""
    import torch
    fleet.shutdown(drain=True, timeout=120)
    for rep in fleet.replicas:
        rep.gateway.engine.release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _fleet_await(pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    if not pred():
        raise RuntimeError("fleet: condition not reached in time")


def _fleet_results(streams):
    outs = [st.result() for st in streams]
    return [ids.tolist() for ids, _ in outs], [r for _, r in outs]


def _replica_launches(fleet):
    """Each replica's launches per kernel since the last reset: the
    counts of its driver thread (kernels.thread_launches)."""
    from paddle_tpu_torch.kernels import thread_launches
    return [{k: v for k, v in thread_launches(
        rep.gateway._thread.ident).items() if v}
        for rep in fleet.replicas]


def _shared_at_rest(label):
    """Raise unless the device's buffers that every launch shares are as
    each launch leaves them: every split-KV ticket zero, and the fused
    tick's barrier words (all but the generation word, bar[1]) zero. A
    launch that overlapped another on them leaves a count behind."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt, split_kv
    torch.cuda.synchronize()
    left = {"tickets": sum(int(t.count_nonzero())
                           for t in split_kv._TICKETS.values()),
            "barrier": sum(int(b[0] != 0) + int(b[2:].count_nonzero())
                           for b in fdt._BARRIERS.values())}
    if any(left.values()):
        raise RuntimeError(f"{label}: shared launch buffers not at rest: "
                           f"{left} non-zero words")
    return left


def _meet_at_first_tail(fleet, timeout=120.0):
    """Hold each replica's first step with tail ticks (the multi-tick
    program's call with ``n > 1``: on the default engine the tail's
    eager warm-up tick and its capture, on the fused engine its first
    fused-tick launches) until every replica has reached its own, so
    both start at once beside each other's launches. Returns the list
    each meeting appends to."""
    import threading
    meet = threading.Barrier(len(fleet.replicas), timeout=timeout)
    met = []
    for rep in fleet.replicas:
        eng = rep.gateway.engine
        first = [True]

        def program(_program=eng._mtick_fn, _first=first):
            fn = _program()

            def call(*args, **kw):
                if _first[0] and int(args[-1]) > 1:     # n, the ticks
                    _first[0] = False
                    met.append(meet.wait())
                return fn(*args, **kw)
            return call
        eng._mtick_fn = program
    return met


def _fleet_fp32(model, cfg, ticks):
    """One knob set (``decode_ticks``) of the fp32 fleet legs: routed
    streams, a replica killed mid-decode, a migration and a drain, each
    against a direct engine with the replicas' knobs — equal streams and
    finish reasons, zero requests lost."""
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import FaultPlan, GenerationRequest
    knob = {"decode_chunk": 1, "prefix_cache": True, "decode_ticks": ticks}
    reqs = _requests(GenerationRequest, (37, 130, 300), 700, 16,
                     cfg.vocab_size, seed=3)
    want = _eng_run(model, reqs, knob)
    want[2].release()
    # 32 new tokens: a decode_ticks=8 replica still decodes at step 3
    long_reqs = _requests(GenerationRequest, (37, 130, 300), 500, 32,
                          cfg.vocab_size, seed=12)
    want_d = _eng_run(model, long_reqs, knob)
    want_d[2].release()
    lines = {}
    # routed: round-robin over two replicas
    fleet = _fleet_make(model, decode_ticks=ticks)
    reset_launches()
    streams = [fleet.submit(q) for q in reqs]
    fleet.start()
    got = _fleet_results(streams)
    launches = dict(LAUNCHES)
    per = _replica_launches(fleet)
    captures = [rep.gateway.engine._tail.captures
                if rep.gateway.engine._tail is not None else 0
                for rep in fleet.replicas]
    _fleet_done(fleet)
    _shared_at_rest(f"fleet fp32 ticks={ticks} routed")
    lines["routed"] = {"streams_equal": got[0] == want[0]
                       and got[1] == want[1],
        "launches": {k: v for k, v in launches.items() if v},
        "replica_launches": per, "graph_captures": captures}
    # decode_chunk 1: decode rows ride ragged's span-1 rows; the
    # multi-tick tail launches paged decode
    if not all(per) or not launches["ragged_attention"] or \
            not launches["flash"] or (ticks > 1
                                      and not launches["paged_decode"]):
        raise RuntimeError(f"fleet fp32 ticks={ticks}: launches {launches}"
                           f", per replica {per}")
    # a replica killed mid-decode, no restart budget: failover
    fleet = _fleet_make(model, decode_ticks=ticks, max_restarts=0,
                        fault_hooks=[FaultPlan().at_step(3, "fatal"), None])
    streams = [fleet.submit(q) for q in long_reqs]
    fleet.start()
    got_k = _fleet_results(streams)
    dead = fleet.replicas[0].state
    failovers = fleet._m_migrated.value(cause="failover")
    _fleet_done(fleet)
    _shared_at_rest(f"fleet fp32 ticks={ticks} kill")
    lines["kill"] = {"streams_equal": got_k[0] == want_d[0]
                     and got_k[1] == want_d[1],
                     "lost": sum(r not in ("length", "stop")
                                 for r in got_k[1]),
                     "replica0": dead, "failed_over": failovers}
    # migrate one long request mid-decode to the other replica
    long_req = _requests(GenerationRequest, (), 400, 48, cfg.vocab_size,
                         seed=11)
    want_m = _eng_run(model, long_req, knob)
    want_m[2].release()
    fleet = _fleet_make(model, decode_ticks=ticks)
    fleet.start()
    st = fleet.submit(long_req[0])
    _fleet_await(lambda: st.seq is not None and len(st.seq.tokens) >= 8)
    fleet.migrate(st, target=1)
    got_m = _fleet_results([st])
    moved_to = fleet.replicas.index(
        next(r for r in fleet.replicas if r.gateway is st.gateway))
    _fleet_done(fleet)
    _shared_at_rest(f"fleet fp32 ticks={ticks} migrate")
    lines["migrate"] = {"streams_equal": got_m[0] == want_m[0]
                        and got_m[1] == want_m[1], "to_replica": moved_to}
    # drain replica 0 while four requests decode
    fleet = _fleet_make(model, decode_ticks=ticks)
    fleet.start()
    streams = [fleet.submit(q) for q in long_reqs]
    _fleet_await(lambda: any(x.seq is not None and x.seq.tokens
                             for x in streams))
    moved = fleet.drain_replica(0)
    got_d = _fleet_results(streams)
    _fleet_done(fleet)
    _shared_at_rest(f"fleet fp32 ticks={ticks} drain")
    lines["drain"] = {"streams_equal": got_d[0] == want_d[0]
                      and got_d[1] == want_d[1], "migrations": moved}
    if ticks > 1:
        # both replicas' first steps with tail ticks at once: on the
        # default engine two eager warm-ups on the shared tickets, each
        # capture beside the other replica's launches; on the fused
        # engine two replicas' cooperative ticks on one grid barrier
        for fused in (False, True):
            knob_f = dict(knob, fused_tick=fused)
            want_f = want if not fused else _eng_run(model, reqs, knob_f)
            if fused:
                want_f[2].release()
            fleet = _fleet_make(model, decode_ticks=ticks, fused_tick=fused)
            met = _meet_at_first_tail(fleet)
            streams = [fleet.submit(q) for q in reqs]
            reset_launches()
            fleet.start()
            got_f = _fleet_results(streams)
            caps = [rep.gateway.engine._tail.captures
                    for rep in fleet.replicas]
            per = _replica_launches(fleet)
            _fleet_done(fleet)
            rest = _shared_at_rest(f"fleet fp32 ticks={ticks} race "
                                   f"fused={fused}")
            lines["race_fused" if fused else "race"] = {
                "streams_equal": got_f[0] == want_f[0]
                and got_f[1] == want_f[1], "met": len(met),
                "graph_captures": caps, "replica_launches": per,
                "left": rest}
            # the fused tail launches the tick itself and captures nothing
            if len(met) != len(fleet.replicas) or (
                    not fused and not all(caps)) or (
                    fused and not all(p.get("fused_decode_tick")
                                      for p in per)):
                raise RuntimeError(f"fleet fp32 race fused={fused}: met "
                                   f"{len(met)}, captures {caps}, "
                                   f"launches {per}")
    line = {"phase": "fleet", "dtype": "float32", "layers": 2,
            "replicas": 2, "decode_ticks": ticks, **lines}
    emit(line)
    bad = [k for k, v in lines.items() if not v["streams_equal"]]
    if bad or lines["kill"]["lost"] or lines["kill"]["replica0"] != "dead" \
            or ticks > 1 and not all(captures):
        raise RuntimeError(f"fleet fp32 ticks={ticks}: {bad} {line}")
    return launches


#: the bf16 fleet's rows a sequence: two replicas' pools with the prefix
#: cache's budget (as many blocks again) at 4096 would take 64 GiB beside
#: the 13.5 GB of weights; the serve requests need at most 1664
FLEET_MAX_SEQ = 2048


def _fleet_serve(model):
    """bf16 ``llama_7b`` (the serve model): 2 replicas x 8 slots of
    ``FLEET_MAX_SEQ`` rows behind the affinity router, the serve phase's
    8 requests at once: tok/s,
    TTFT, launches a replica, and each stream held to a direct engine
    with the replicas' knobs — equal, or where it first parts (bf16
    rows batch otherwise in a fleet, and a GEMM of another row count
    may round otherwise)."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving.fleet import PrefixAffinityRouter
    cfg = model.config
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    knob = {"decode_chunk": 1, "prefix_cache": True, "headroom_mult": None,
            "max_seq_len": FLEET_MAX_SEQ}
    seqs, eng, _, direct_wall = _serve(model, reqs, **knob)
    want = [s.tokens for s in seqs]
    eng.release()
    del eng, seqs
    torch.cuda.empty_cache()
    # warm-up: cuBLAS, the kernels and both replicas' first programs
    fleet = _fleet_make(model, router=PrefixAffinityRouter(band=16),
                        max_seq_len=FLEET_MAX_SEQ)
    fleet.start()
    _fleet_results([fleet.submit(q) for q in _requests(
        GenerationRequest, (100, 120), 600, 9, cfg.vocab_size, seed=5)])
    _fleet_done(fleet)
    fleet = _fleet_make(model, router=PrefixAffinityRouter(band=16),
                        max_seq_len=FLEET_MAX_SEQ)
    fleet.start()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    streams = [fleet.submit(q) for q in reqs]
    got, reasons = _fleet_results(streams)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    per = _replica_launches(fleet)
    ttft = [st.first_token_time - st.submit_time for st in streams]
    routed = [i for _, i in fleet.decisions]
    _fleet_done(fleet)
    _shared_at_rest("fleet bf16")
    partings = _first_parting(got, want)
    decoded = sum(len(t) for t in got)
    line = {"phase": "fleet", "dtype": cfg.dtype,
            "layers": cfg.num_hidden_layers, "replicas": 2,
            "num_slots": 8, "max_seq_len": FLEET_MAX_SEQ,
            "router": "affinity",
            "requests": len(reqs), "decoded_tokens": decoded,
            "wall_s": wall, "decoded_tok_per_s": decoded / wall,
            "direct_wall_s": direct_wall,
            "direct_decoded_tok_per_s": decoded / direct_wall,
            "ttft_s_mean": sum(ttft) / len(ttft), "ttft_s_max": max(ttft),
            "routed_to": routed, "launches": {
                k: v for k, v in launches.items() if v},
            "replica_launches": per,
            "streams_equal_direct": got == want,
            "first_parting": partings}
    emit(line)
    if any(r != "length" for r in reasons) or any(
            len(t) != 64 for t in got) or not all(per):
        raise RuntimeError(f"fleet bf16: {line}")
    return launches


def phase_fleet_fp32():
    """The engine fleet at 7B widths, 2 layers, fp32 (the kernels' fp32
    routes): ``_fleet_fp32`` at ``decode_ticks`` 1 and 8 (each replica
    captures its own multi-tick graph while the other launches)."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    for ticks in (1, 8):
        _fleet_fp32(model, cfg, ticks)
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------- tensor parallel
#: the tp phase's knob sets held at tp=2 against the same knobs at tp=1
#: (fp32, 7B widths, 2 layers); ``waves`` runs the requests twice (the
#: second pass hits the prefix trie)
TP_KNOBS = (("int8_pool", {"kv_dtype": "int8"}),
            ("fp8_pool", {"kv_dtype": "fp8"}),
            ("w8", {"quantize_weights": True}),
            ("spec", {"spec_decode": True, "spec_k": SPEC_K}),
            ("prefix", {"prefix_cache": True}),
            ("fused_tick", {"fused_tick": True}))


@contextlib.contextmanager
def _first_logits(out):
    """Inside: the first lm-head product of the serving programs appended
    to ``out`` (float32, on the host; later ones, which a CUDA graph may
    be capturing, are left alone)."""
    from paddle_tpu_torch.serving import decode as sdec
    head_logits = sdec._head_logits

    def record(last_h, head):
        logits = head_logits(last_h, head)
        if not out:
            out.append(logits.float().cpu())
        return logits

    sdec._head_logits = record
    try:
        yield out
    finally:
        sdec._head_logits = head_logits


def _tp_run(model, reqs, label, knob, kernels=True, graph=True):
    """One engine run (tp=1 or sharded) to completion, the counts (the
    device's reductions among them, ``kernels.WIRE``) and a fresh cost
    observatory set to 0 just before it and read just after; the first
    logits the run computes (its first cold prefill's) recorded; the
    split-KV tickets and the fused tick's barrier checked at rest after
    it."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, WIRE, reset_launches
    from paddle_tpu_torch.profiler.cost import CostObservatory
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    try:
        set_flags({"FLAGS_use_cuda_kernels": kernels,
                   "FLAGS_cuda_graph_tail": graph})
        with _first_logits([]) as seen:
            eng = ContinuousBatchingEngine(model, headroom_mult=None, **knob)
            co = eng.cost = CostObservatory()
            reset_launches()
            outs = []
            for wave in (reqs if isinstance(reqs[0], list) else [reqs]):
                outs += eng.generate(wave)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            wire = {k: LAUNCHES[k] for k in WIRE}
        first = seen
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True,
                   "FLAGS_cuda_graph_tail": True})
    _shared_at_rest(f"tp {label}")
    return {"streams": [o.tolist() for o in outs],
            "reasons": [o.finish_reason for o in outs], "eng": eng,
            "co": co, "launches": launches, "wire": wire,
            "logits": first[0]}


def _tp_expected(run, layers):
    """The kernel launches a run's code implies: every kernel of the path
    once a shard a layer — flash a cold prefill, ragged attention a
    unified (or verify) step, paged decode a tail tick the device ran
    (graph replays counted; under tensor parallelism the fused tick is
    the scanned tick, so the fused kernel never launches)."""
    eng, co = run["eng"], run["co"]
    st, per = eng.stats, layers * eng.tp
    want = {"flash": per * co.kind_calls("prefill"),
            "fused_decode_tick": 0, "decode": 0}
    if eng.spec_decode:
        return dict(want, ragged_attention=per * st["spec_steps"],
                    paged_decode=0)
    tail = (eng._tail.ticks if eng.decode_ticks > 1
            else st["decode_steps"] - st["decode_calls"])
    return dict(want, ragged_attention=per * st["unified_steps"],
                paged_decode=per * tail)


def _tp_check(label, run, layers, kernels=True):
    """Raise unless the run launched what its code implies (nothing with
    the kernels off) and its collective ledger — what
    ``serving_collective_bytes_total`` scrapes — equals the wire model
    summed over the reductions the device ran."""
    want = _tp_expected(run, layers)
    if not kernels:
        want = dict.fromkeys(want, 0)
    got = {n: run["launches"][n] for n in want}
    led = run["co"].collectives
    dtype = run["eng"].collective_dtype
    ledger = led.get(dtype, {"ops": 0, "bytes": 0})
    wire = run["wire"]
    line = {"phase": "tp", "leg": label, "tp": run["eng"].tp,
            "kernels": kernels, "launches": got, "launches_expected": want,
            "ledger": ledger, "device_wire": wire,
            "scraped_bytes": run["co"].collective_bytes(dtype)}
    emit(line)
    if got != want:
        raise RuntimeError(f"tp {label} launches (got, expected): {got}, "
                           f"{want}")
    if run["eng"].tp > 1 and (ledger["bytes"] != wire["tp_wire_bytes"]
                              or ledger["ops"] != wire["tp_reduce"]
                              or not wire["tp_wire_bytes"]):
        raise RuntimeError(f"tp {label}: ledger {ledger} != the device's "
                           f"reductions {wire}")
    return line


def _tp_same(label, a, b, what):
    if (a["streams"], a["reasons"]) != (b["streams"], b["reasons"]):
        raise RuntimeError(f"tp {label}: streams differ from {what}: "
                           f"{_first_parting(a['streams'], b['streams'])}")


def phase_tp():
    """Tensor-parallel serving with every shard on the card, fp32, 7B
    widths (32 heads of 128), 2 layers, the engine phase's request matrix;
    then tp=2 in bf16 at the same widths (the kernels' tensor-core
    routes at a shard's 16 heads)."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import GenerationRequest
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    reqs = _requests(GenerationRequest, (37, 130, 300), 700, 16,
                     cfg.vocab_size, seed=3)
    base = _tp_run(model, reqs, "tp1", {})
    for tp in (2, 4):
        on = _tp_run(model, reqs, f"tp{tp}", {"tp": tp})
        off = _tp_run(model, reqs, f"tp{tp}_plain", {"tp": tp},
                      kernels=False)
        _tp_check(f"tp{tp}", on, L)
        _tp_check(f"tp{tp}_plain", off, L, kernels=False)
        _tp_same(f"tp{tp}", on, off, "the plain versions")
        if tp == 2:
            tp2 = on
    _tp_same("tp2", tp2, base, "tp=1")
    err = float((tp2["logits"] - base["logits"]).abs().max())
    atol, rtol = TOL["float32"]
    ok = bool(torch.allclose(tp2["logits"], base["logits"], atol=atol,
                             rtol=rtol))
    emit({"phase": "tp", "check": "tp2_vs_tp1", "streams_equal": True,
          "first_logits_max_abs_err": err, "tol": TOL["float32"],
          "within_tol": ok})
    if not ok:
        raise RuntimeError(f"tp2 first logits off tp1's by {err}")
    # the overlap schedule: the fp ring at tp=2 adds each element once, as
    # the plain sum does, and row chunks change no row
    over = _tp_run(model, reqs, "overlap", {"tp": 2,
                                            "collective_overlap": True})
    _tp_check("overlap", over, L)
    _tp_same("overlap", over, tp2, "no overlap")
    pools = all(bool(torch.equal(a, b)) for a, b in zip(
        over["eng"].cache.pool.k + over["eng"].cache.pool.v,
        tp2["eng"].cache.pool.k + tp2["eng"].cache.pool.v))
    emit({"phase": "tp", "check": "overlap_vs_plain_schedule",
          "streams_equal": True, "pools_bit_equal": pools})
    if not pools:
        raise RuntimeError("tp overlap: pools differ from the plain "
                           "schedule's")
    for r in (over, tp2):
        r["eng"].release()
    # the EQuARX int8 all-reduce: kernels against plain; its partings
    # from the fp reductions are measured, not assumed zero
    q_on = _tp_run(model, reqs, "int8", {"tp": 2,
                                         "collective_dtype": "int8"})
    q_off = _tp_run(model, reqs, "int8_plain",
                    {"tp": 2, "collective_dtype": "int8"}, kernels=False)
    _tp_check("int8", q_on, L)
    _tp_same("int8", q_on, q_off, "the plain versions")
    fp_b = tp2["co"].collective_bytes("fp")
    emit({"phase": "tp", "check": "int8_collectives",
          "partings_from_fp": _first_parting(q_on["streams"],
                                             tp2["streams"]),
          "wire_bytes_fp": fp_b,
          "wire_bytes_int8": q_on["co"].collective_bytes("int8"),
          "fp_over_int8": fp_b / max(q_on["co"].collective_bytes("int8"),
                                     1)})
    # each knob set at tp=2 against the same knobs at tp=1
    waves = [reqs, reqs]
    for label, knob in TP_KNOBS:
        r = waves if label == "prefix" else reqs
        one = _tp_run(model, r, f"{label}_tp1", knob)
        two = _tp_run(model, r, label, dict(knob, tp=2))
        _tp_check(label, two, L)
        _tp_same(label, two, one, "tp=1")
        for x in (one, two):
            x["eng"].release()
    # decode_ticks=8: the graph tail, the eager tail and the plain
    # versions at tp=2, against tp=1's graph tail
    knob = {"decode_ticks": 8}
    one = _tp_run(model, reqs, "ticks8_tp1", knob)
    for label, kw in (("ticks8", {}), ("ticks8_eager", {"graph": False}),
                      ("ticks8_plain", {"kernels": False})):
        two = _tp_run(model, reqs, label, dict(knob, tp=2), **kw)
        _tp_check(label, two, L, kernels=kw.get("kernels", True))
        _tp_same(label, two, one, "tp=1")
        if label == "ticks8":
            emit({"phase": "tp", "leg": label,
                  "graph_captures": two["eng"]._tail.captures,
                  "tail_ticks": two["eng"]._tail.ticks})
        two["eng"].release()
    one["eng"].release()
    del model, one, two
    gc.collect()
    torch.cuda.empty_cache()
    # bf16: tp=2's first logits held against its plain versions and
    # against tp=1 in the form the script holds bf16 logits to (TOL
    # scaled by the largest entry, _compare_scaled), the streams' first
    # partings reported
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=2,
                                      dtype="bfloat16"), device="cuda",
                             seed=1)
    b1 = _tp_run(model, reqs, "bf16_tp1", {})
    b2 = _tp_run(model, reqs, "bf16", {"tp": 2})
    b2p = _tp_run(model, reqs, "bf16_plain", {"tp": 2}, kernels=False)
    _tp_check("bf16", b2, L)
    _tp_check("bf16_plain", b2p, L, kernels=False)
    line = {"phase": "tp", "check": "bf16_tp2", "tol": BWD_TOL["bfloat16"]}
    for what, ref in (("plain", b2p), ("tp1", b1)):
        err, rel = _compare_scaled(f"tp bf16 first logits vs {what}",
                                   "bfloat16", b2["logits"], ref["logits"])
        line[f"first_logits_err_vs_{what}"] = err
        line[f"first_logits_err_of_max_vs_{what}"] = rel
        line[f"partings_from_{what}"] = _first_parting(b2["streams"],
                                                       ref["streams"])
    emit(line)
    for r in (b1, b2, b2p):
        r["eng"].release()
    del model, b1, b2, b2p
    gc.collect()
    torch.cuda.empty_cache()


def _tp_serve_run(model, reqs, tp):
    """One measured serve run at ``tp`` after a warm-up run: counts, the
    device's reductions, a fresh cost observatory and the peak memory set
    to 0 just before it and read just after."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, WIRE, reset_launches
    from paddle_tpu_torch.profiler.cost import CostObservatory
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    warm = _serve(model, _requests(GenerationRequest, (100,), 600, 9,
                                   model.config.vocab_size, seed=5), tp=tp)
    warm[1].release()
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, tp=tp)
    co = eng.cost = CostObservatory()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_ms = []
    seqs = [eng.submit(q) for q in reqs]
    while eng.has_work():
        ts = time.perf_counter()
        eng.step()
        step_ms.append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"eng": eng, "co": co, "launches": dict(LAUNCHES),
            "wire": {k: LAUNCHES[k] for k in WIRE},
            "toks": [s.tokens for s in seqs], "step_ms": step_ms,
            "wall": wall,
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30}


def _parting_gaps(model, reqs, toks):
    """At each stream's first parting of tp=2 from tp=1 (``toks``, each
    degree's streams): the prompt and tp=1's tokens before it through
    each degree's cold prefill program (the kernels; one-slot engines, so
    the serve runs' memory readings stay their own), and the logits
    there: each degree's top-2 gap and the largest difference between
    the two degrees' logits. On a greedy stream a tp=1 gap no larger than
    that difference is a near tie the partial sums' rounding can flip; a
    sampled stream draws from the whole top-k."""
    import numpy as np
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    engines = {tp: ContinuousBatchingEngine(model, tp=tp, num_slots=1)
               for tp in (1, 2)}
    out = []
    for i, (a, b) in enumerate(zip(toks[1], toks[2])):
        at = _first_parting([a], [b])[0]
        if at is None:
            continue
        ids = np.concatenate([np.asarray(reqs[i].prompt, np.int32),
                              np.asarray(a[:at], np.int32)])
        n = int(ids.shape[0])
        pad = np.zeros((1, 1 << (n - 1).bit_length()), np.int32)
        pad[0, :n] = ids
        logits = {}
        for tp, eng in engines.items():
            with _first_logits([]) as seen:
                eng._prefill_fn()(eng._shards, pad, np.array([n], np.int32),
                                  np.zeros((1, 2), np.int64),
                                  np.zeros(1, np.float32),
                                  np.zeros(1, np.int32))
            logits[tp] = seen[0][0]
        top = {tp: x.topk(2) for tp, x in logits.items()}
        diff = float((logits[1] - logits[2]).abs().max())
        gap1 = float(top[1].values[0] - top[1].values[1])
        sampled = float(reqs[i].temperature) > 0
        out.append({"stream": i, "parting": at, "sampled": sampled,
                    "served": [a[at], b[at]],
                    "picks": [int(top[1].indices[0]),
                              int(top[2].indices[0])],
                    "tp1_top2_gap": gap1,
                    "tp2_top2_gap": float(top[2].values[0]
                                          - top[2].values[1]),
                    "logits_max_abs_diff": diff,
                    "near_tie": None if sampled else gap1 <= diff})
    for eng in engines.values():
        eng.release()
    return out


def _tp_profile(model, reqs, want):
    """The tp=2 serve run again under ``torch.profiler``, each reduction
    inside a ``tp_reduce`` range: the device's busy share and the
    reductions' share of the device time (the device time of the kernels
    launched inside the ranges)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from paddle_tpu_torch.serving import engine as seng
    make = seng.tp_allreduce

    def annotated(*a, **kw):
        fn = make(*a, **kw)

        def reduce(parts):
            with torch.profiler.record_function("tp_reduce"):
                return fn(parts)
        return reduce

    seng.tp_allreduce = annotated
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            seqs, eng, step_ms, wall = _serve(model, reqs, tp=2)
    finally:
        seng.tp_allreduce = make
    eng.release()
    if [s.tokens for s in seqs] != want:
        raise RuntimeError("the profiled tp=2 repeat sampled other tokens")
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    red = next((e for e in prof.key_averages() if e.key == "tp_reduce"),
               None)
    red_us = (getattr(red, "device_time_total",
                      getattr(red, "cuda_time_total", 0)) if red else 0)
    _profile_line("profile_tp2", rows, wall, steps=len(step_ms),
                  reductions=red.count if red else 0,
                  reductions_device_ms=red_us / 1e3,
                  reductions_share_of_device=(red_us / busy_us
                                              if busy_us else None))


def phase_tp_serve(model, profile=False):
    """``tp=2`` on the card at full width and depth: llama_7b, 32 layers,
    bf16, the serve phase's 8 requests x 64 tokens, after a ``tp=1`` run
    of the same requests in this call: tok/s, step ms, peak memory,
    launches a shard (as the code implies), collective bytes a step, and
    the first partings from tp=1 (a sum of two partial products rounds as
    one full product does not). With ``profile``, a repeat under
    ``torch.profiler``: the device's busy share and the reductions' share
    of the device time."""
    import torch
    from paddle_tpu_torch.serving import GenerationRequest
    cfg = model.config
    L = cfg.num_hidden_layers
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    runs = {}
    for tp in (1, 2):
        run = runs[tp] = _tp_serve_run(model, reqs, tp)
        want = _tp_expected(run, L)
        got = {n: run["launches"][n] for n in want}
        decoded = sum(len(t) for t in run["toks"])
        steps = len(run["step_ms"])
        ledger = run["co"].collectives.get("fp", {"ops": 0, "bytes": 0})
        emit({"phase": "tp_serve", "tp": tp, "layers": L,
              "dtype": "bfloat16", "requests": len(reqs),
              "decoded_tokens": decoded, "wall_s": run["wall"],
              "decoded_tok_per_s": decoded / run["wall"], "steps": steps,
              "mean_step_ms": 1e3 * run["wall"] / steps,
              "peak_mem_gb": run["peak"], "launches": got,
              "launches_expected": want,
              "launches_per_shard": {n: got[n] / tp for n in got},
              "ledger": ledger, "device_wire": run["wire"],
              "collective_bytes_per_step": ledger["bytes"] / steps,
              **({"partings_from_tp1": _first_parting(
                  run["toks"], runs[1]["toks"])} if tp == 2 else {})})
        if got != want:
            raise RuntimeError(f"tp_serve tp={tp} launches (got, "
                               f"expected): {got}, {want}")
        if tp == 2 and (ledger["bytes"] != run["wire"]["tp_wire_bytes"]
                        or not ledger["bytes"]):
            raise RuntimeError(f"tp_serve ledger {ledger} != the device's "
                               f"reductions {run['wire']}")
        for s in run["toks"]:
            if len(s) != 64 or not all(0 <= t < cfg.vocab_size for t in s):
                raise RuntimeError(f"tp_serve tp={tp}: a stream of "
                                   f"{len(s)} tokens or out of the "
                                   f"vocabulary")
        run["eng"].release()
        _shared_at_rest(f"tp_serve tp={tp}")
    gaps = _parting_gaps(model, reqs, {tp: r["toks"] for tp, r in
                                       runs.items()})
    emit({"phase": "tp_serve", "check": "partings", "partings": gaps,
          "greedy_partings": sum(not g["sampled"] for g in gaps),
          "greedy_near_ties": sum(bool(g["near_tie"]) for g in gaps)})
    want = runs[2]["toks"]
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        _tp_profile(model, reqs, want)


def phase_server(model):
    """``serve(model, port=0)`` at its defaults on the card (decode_chunk
    1, 8 slots, cost on, trace off) under 8 concurrent HTTP clients (4
    blocking, 4 SSE) on the serve phase's requests, against a direct
    engine run; then the fault leg and the CLI leg."""
    import threading
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    from paddle_tpu_torch.serving.server import serve
    cfg = model.config
    L = cfg.num_hidden_layers
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    # the direct run: the same requests, the server's engine geometry,
    # each admitted alone in its own step as the clients below are (a
    # cold prefill's GEMMs take the group's rows; bf16 results of another
    # grouping may differ in the last bits and flip a greedy token)
    eng = ContinuousBatchingEngine(model, num_slots=8, decode_chunk=1)
    eng.generate(_requests(GenerationRequest, (100,), 600, 4,
                           cfg.vocab_size, seed=5))            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = []
    for q in reqs:
        seqs.append(eng.submit(q))
        eng.step()
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    want = [list(x.tokens) for x in seqs]
    del eng, seqs
    gc.collect()
    torch.cuda.empty_cache()
    srv = serve(model, port=0)
    try:
        gw = srv.gateway
        url = srv.url + "/v1/completions"
        _http(url, {"prompt": [1, 2, 3, 4, 5], "max_tokens": 4})  # warm-up
        eng = gw.engine
        steps0, prefill0 = eng.stats["unified_steps"], \
            gw.cost.kind_calls("prefill")
        reset_launches()
        got, errors, trace = [None] * len(reqs), [], {}

        def client(i):
            try:
                if i % 2:
                    got[i] = _sse(url, _payload(reqs[i]))
                else:
                    doc = json.loads(_http(url, _payload(reqs[i])))
                    ch = doc["choices"][0]
                    got[i] = (ch["token_ids"], ch["finish_reason"])
            except Exception as e:                  # noqa: BLE001
                errors.append(f"client {i}: {e!r}")

        def tracer():
            try:
                trace["doc"] = json.loads(_http(
                    srv.url + "/debug/trace?steps=8&timeout_s=300"))
            except Exception as e:                  # noqa: BLE001
                errors.append(f"trace: {e!r}")

        # the clients run concurrently; each starts once the one before
        # holds its slot, so each prompt is admitted alone, as above
        threads = []
        t0 = time.perf_counter()
        for i in range(len(reqs)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
            if i == 0:
                threads.append(threading.Thread(target=tracer))
                threads[-1].start()
            deadline = time.monotonic() + 300
            while eng.num_active < i + 1 and time.monotonic() < deadline \
                    and not errors:
                time.sleep(0.002)
        for t in threads:
            t.join(timeout=900)
        gw_wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        steps = eng.stats["unified_steps"] - steps0
        prefills = gw.cost.kind_calls("prefill") - prefill0
        fams = parse_prometheus(_http(srv.url + "/metrics"))
        health = json.loads(_http(srv.url + "/healthz"))
        profile = json.loads(_http(srv.url + "/debug/profile"))
        ttft = [gw._m_ttft.quantile(q) for q in (0.5, 0.9)]
        tpot = [gw._m_tpot.quantile(q) for q in (0.5, 0.9)]
    finally:
        srv.shutdown(drain=False, timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"server clients failed: {errors}")
    streams = [list(g[0]) for g in got]
    names = {e["name"] for e in trace["doc"]["traceEvents"]}
    calls = {}
    for p in profile["programs"]:
        calls[p["kind"]] = calls.get(p["kind"], 0) + p["calls"]
    comp = fams["serving_decode_compilations"]["samples"][
        ("serving_decode_compilations", ())]
    expect = {"flash": L * prefills, "ragged_attention": L * steps,
              "paged_decode": 0, "fused_decode_tick": 0, "decode": 0}
    line = {"phase": "server", "layers": L, "dtype": cfg.dtype,
            "clients": len(reqs), "blocking": len(reqs) // 2,
            "sse": len(reqs) - len(reqs) // 2,
            "decoded_tokens": sum(len(s) for s in streams),
            "gateway_wall_s": gw_wall, "direct_wall_s": direct_wall,
            "gateway_over_direct": gw_wall / direct_wall,
            "ttft_p50_s": ttft[0], "ttft_p90_s": ttft[1],
            "tpot_p50_s": tpot[0], "tpot_p90_s": tpot[1],
            "steps_with_work": steps, "prefill_calls": prefills,
            "launches": {n: launches[n] for n in expect},
            "launches_expected": expect,
            "decode_compilations": comp, "healthz": health["status"],
            "trace_spans": sorted(names & {"plan", "launch",
                                           "host-accept", "step"}),
            "profile_ragged_calls": calls.get("ragged"),
            "engine_unified_steps": eng.stats["unified_steps"],
            "streams_equal_direct": streams == want,
            "first_diff": [_first_diff(s, w) for s, w in zip(streams, want)]}
    emit(line)
    if streams != want or any(g[1] != "length" for g in got):
        raise RuntimeError("server streams differ from the direct run")
    _launch_check("server", launches, expect)
    if comp != 1 or health["status"] != "ok" \
            or not {"plan", "launch", "host-accept"} <= names \
            or calls.get("ragged") != eng.stats["unified_steps"]:
        raise RuntimeError(f"server checks failed: {line}")
    del srv, gw, eng
    gc.collect()
    torch.cuda.empty_cache()
    _rebuild_memory(model)
    _server_faults()
    _server_cli()
    _server_tiny()
    _server_cli("tiny")
    return launches


def _rebuild_memory(model):
    """The rebuild at the serving geometry: ``serve(model, port=0)`` (8
    slots x 4096 tokens: a 16 GiB pool at 7B bf16) with a fatal fault at
    plan step 2 under two requests; the peak memory above what was held
    before the server shows whether the rebuild held one pool or two
    (the dead engine's pool is released before the factory runs)."""
    import torch
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving.faults import FaultPlan
    from paddle_tpu_torch.serving.server import serve
    reqs = _requests(GenerationRequest, (100,), 300, 16,
                     model.config.vocab_size, seed=29)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = serve(model, port=0, fault_hook=FaultPlan().at_step(2, "fatal"))
    try:
        gw = srv.gateway
        pool_gb = (gw.engine.cache.pool.block_nbytes
                   * gw.engine.cache.pool.num_blocks / 2 ** 30)
        outs = [st.result() for st in [gw.submit(q) for q in reqs]]
        restarts = gw.restarts
    finally:
        srv.shutdown(drain=False, timeout=120)
    over = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    line = {"phase": "server", "check": "rebuild_memory", "layers":
            model.config.num_hidden_layers, "dtype": model.config.dtype,
            "engine_restarts": restarts,
            "finish_reasons": [r for _, r in outs],
            "pool_gb": pool_gb, "peak_over_base_gb": over,
            "pools_at_peak": over / pool_gb}
    emit(line)
    del srv, gw
    gc.collect()
    torch.cuda.empty_cache()
    if restarts != 1 or any(r != "length" for _, r in outs) \
            or over >= 2 * pool_gb:
        raise RuntimeError(f"rebuild at the serving geometry: {line}")


#: scripts/bench_chaos.py's plan, geometry and workload shape
CHAOS_SLOTS, CHAOS_BLOCK, CHAOS_CHUNK = 4, 16, 32


def _chaos_requests(GenerationRequest, vocab):
    import numpy as np
    rng = np.random.RandomState(23)
    reqs = []
    for i in range(10):
        kw = dict(temperature=0.8, top_k=5, seed=200 + i) if i % 4 == 3 \
            else {}
        reqs.append(GenerationRequest(
            prompt=rng.randint(0, vocab, (12,)).astype(np.int32),
            max_new_tokens=12, **kw))
    for _ in range(2):
        reqs.append(GenerationRequest(
            prompt=rng.randint(0, vocab, (160,)).astype(np.int32),
            max_new_tokens=6))
    return reqs


def _server_faults():
    """fp32, 7B widths, 2 layers: the chaos plan ``transient@3, pool@6,
    fatal@10, nan@15`` through ``serve(..., fault_hook=plan)``; no request
    lost, streams equal the fault-free run, two rebuilds (fatal, nan),
    and the peak memory across them."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    from paddle_tpu_torch.serving.faults import FaultPlan
    from paddle_tpu_torch.serving.server import serve
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=2, dtype="float32"),
                             device="cuda", seed=3)
    # max_seq_len at the model's default (4096): a pool the size serving
    # holds, so the peak shows whether a rebuild held two of them
    geo = dict(num_slots=CHAOS_SLOTS, prefix_block_size=CHAOS_BLOCK,
               prefill_chunk=CHAOS_CHUNK)
    model_gb = sum(p.numel() * p.element_size()
                   for p in model.parameters()) / 2 ** 30
    reqs = _chaos_requests(GenerationRequest, model.config.vocab_size)
    want = [o.tolist() for o in ContinuousBatchingEngine(
        model, decode_chunk=1, **geo).generate(reqs)]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = (FaultPlan().at_step(3, "transient").at_step(6, "pool")
            .at_step(10, "fatal").at_step(15, "nan"))
    srv = serve(model, port=0, fault_hook=plan, max_restarts=32,
                max_queue=len(reqs) + 4, **geo)
    try:
        gw = srv.gateway
        pool_gb = (gw.engine.cache.pool.block_nbytes
                   * gw.engine.cache.pool.num_blocks / 2 ** 30)
        streams = [gw.submit(q) for q in reqs]
        outs = []
        for st in streams:
            try:
                ids, reason = st.result()
                outs.append((ids.tolist(), reason))
            except RuntimeError:
                outs.append((st.tokens(), st.finish_reason))
        restarts = gw.restarts
        health = json.loads(_http(srv.url + "/healthz"))
    finally:
        srv.shutdown(drain=False, timeout=120)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    over = peak - base / 2 ** 30
    lost = sum(r not in ("stop", "length") for _, r in outs)
    line = {"phase": "server", "check": "faults", "layers": 2,
            "dtype": "float32", "plan": plan.log, "requests": len(reqs),
            "requests_lost": lost, "engine_restarts": restarts,
            "healthz_engine_restarts": health["engine_restarts"],
            "streams_equal_fault_free": [o[0] for o in outs] == want,
            "first_diff": [_first_diff(o[0], w)
                           for o, w in zip(outs, want)],
            "peak_mem_gb": peak, "peak_over_base_gb": over,
            "model_gb": model_gb, "pool_gb": pool_gb}
    emit(line)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if lost or restarts != 2 or [o[0] for o in outs] != want:
        raise RuntimeError(f"fault leg failed: {line}")


def _server_tiny():
    """Queue C 7 at the front door: ``serve(model, port=0)`` on llama_tiny
    (head dim 16) with ``decode_attention="pallas"`` answers a completion
    through the kernels (the flash forward and ragged attention launched),
    its tokens a direct engine run's."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    from paddle_tpu_torch.serving.server import serve
    model = LlamaForCausalLM(llama_tiny(decode_attention="pallas"),
                             device="cuda", seed=0)
    prompt = list(range(1, 40))
    want = ContinuousBatchingEngine(model, num_slots=8, decode_chunk=1) \
        .generate([GenerationRequest(prompt=np.asarray(prompt, np.int32),
                                     max_new_tokens=16)])[0].tolist()
    srv = serve(model, port=0)
    try:
        reset_launches()
        doc = json.loads(_http(srv.url + "/v1/completions",
                               {"prompt": prompt, "max_tokens": 16}))
        torch.cuda.synchronize()
        launches = {n: c for n, c in LAUNCHES.items() if c}
    finally:
        srv.shutdown(drain=False, timeout=120)
    toks = doc["choices"][0]["token_ids"]
    line = {"phase": "server", "check": "tiny_pallas", "head_dim": 16,
            "tokens": len(toks), "equal_direct": toks == want,
            "launches": launches}
    emit(line)
    if toks != want or not launches.get("flash") \
            or not launches.get("ragged_attention"):
        raise RuntimeError(f"tiny gateway leg failed: {line}, direct "
                           f"{want}")
    del model, srv
    gc.collect()
    torch.cuda.empty_cache()


def _server_cli(preset="350m"):
    """``python -m paddle_tpu_torch.serving.server --preset <preset>
    --decode-attention pallas --port 0 --quiet`` as a subprocess: read the
    banner, POST one completion, SIGTERM, expect a drain and exit 0."""
    import os
    import select
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server",
         "--preset", preset, "--decode-attention", "pallas", "--port", "0",
         "--quiet"], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ))
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 600)
        if not ready:
            raise RuntimeError("server CLI printed no banner")
        banner = json.loads(proc.stdout.readline())
        t0 = time.perf_counter()
        doc = json.loads(_http(banner["listening"] + "/v1/completions",
                               {"prompt": list(range(1, 40)),
                                "max_tokens": 16}))
        first_request_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    toks = doc["choices"][0]["token_ids"]
    line = {"phase": "server", "check": "cli", "preset": banner["preset"],
            "kv_dtype": banner["kv_dtype"], "tokens": len(toks),
            "first_request_s": first_request_s, "exit_code": rc,
            "drained": "# draining" in err and "# stopped" in err}
    emit(line)
    if rc != 0 or len(toks) != 16 or not line["drained"]:
        raise RuntimeError(f"server CLI leg failed: {line} {err[-2000:]}")


def _device_rows(prof):
    """(device us, calls, name) per kernel from a torch.profiler run,
    largest first: device-side events only (a CPU op's row repeats the
    device time of the kernels it launched)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


def _profile_line(phase, rows, wall, **extra):
    """Busy share, the 14 largest device kernels, and every kernel of the
    port (``pt::``) with its share of the device time."""
    busy_us = sum(r[0] for r in rows)
    emit({"phase": phase, "wall_s": wall, **extra,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall if rows else None,
          "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                  for us, c, k in rows[:14]],
          "port_kernels": [{"name": k.split("(")[0][:70], "calls": c,
                            "device_ms": us / 1e3,
                            "share": us / busy_us}
                           for us, c, k in rows if "pt::" in k]})


def phase_profile(model, reqs, want, label, knob):
    """Device time by kernel over a repeat of one engine's serve run (the
    default engine's line is ``profile``, another's ``profile_<label>``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        seqs, _, step_ms, wall = _serve(model, reqs, **knob)
    if [s.tokens for s in seqs] != want:
        raise RuntimeError(f"the profiled {label} repeat sampled other "
                           f"tokens")
    _profile_line("profile" if label == "default" else f"profile_{label}",
                  _device_rows(prof), wall, steps=len(step_ms))


def phase_profile_fused(model, cfg, reqs, want, scanned_ticks=5):
    """The fused serve run under ``torch.profiler``: one device kernel per
    tail tick (the fused kernel's device launches equal the tail ticks,
    and no paged decode kernel runs), its device time per launch beside
    its bound, and the device time of the scanned tail tick (the kernels'
    tick without fusion: paged decode and cuBLAS launches) at the same
    geometry."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        seqs, eng, step_ms, wall = _serve(model, reqs, fused_tick=True)
    steps = len(step_ms)
    rows = _device_rows(prof)
    tail = eng.stats["decode_steps"] - eng.stats["decode_calls"]
    fused = [(us, c) for us, c, k in rows if "fused_tick_kernel" in k]
    paged = sum(c for _, c, k in rows if "paged_decode_kernel" in k)
    n_fused = sum(c for _, c in fused)
    fused_us = sum(us for us, _ in fused)
    (pk,), (pv,) = eng.cache.pool.k, eng.cache.pool.v      # one shard
    t = tick_inputs(pk.dtype, pk.device, None, cfg.num_hidden_layers,
                    pools=(pk, pv), heads=HEADS)
    p, tied = eng._params, eng._tied
    nbytes, flops = tick_cost(p, t, cfg.num_hidden_layers, 2, heads=HEADS)
    _tick(_scanned_tick, p, tied, t, heads=HEADS)          # warm
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof2:
        for _ in range(scanned_ticks):
            _tick(_scanned_tick, p, tied, t, heads=HEADS)
        torch.cuda.synchronize()
    srows = _device_rows(prof2)
    _profile_line("profile_fused", rows, wall, steps=steps,
                  tail_ticks=tail, fused_device_launches=n_fused,
                  paged_decode_device_launches=paged,
                  fused_device_ms_per_launch=(fused_us / n_fused / 1e3
                                              if n_fused else None),
                  tick_bound_ms=bound_ms(nbytes, flops, "bfloat16"),
                  scanned_tick_device_ms=(sum(r[0] for r in srows)
                                          / scanned_ticks / 1e3),
                  scanned_tick_device_kernels=(sum(r[1] for r in srows)
                                               / scanned_ticks))
    del eng, t
    if n_fused != tail or paged:
        raise RuntimeError(f"profiled fused run: {n_fused} fused kernels "
                           f"for {tail} tail ticks, {paged} paged decode")
    if [s.tokens for s in seqs] != want:
        raise RuntimeError("the profiled fused repeat sampled other tokens")


# ---------------------------------------------------------------- substrate
#: GPT-3 345M's attention: B, S, heads, head dim (the repo's gpt3_345m,
#: micro batch 8 x 1024); the tail length past the 64-row tiles
SUB_B, SUB_S, SUB_H, SUB_D = 8, 1024, 16, 64
SUB_TAIL_S = 1000
SUB_VOCAB = 50304
SUB_STEPS, SUB_SAVE_AT = 10, 5
#: the GPT legs' timed run, after the build: a fresh model, the mean of
#: steps 2-SUB_TIME_STEPS
SUB_TIME_STEPS = 4
#: the GPT-3 345M legs: (label, auto_cast level or None, AMP dtype,
#: GradScaler's init_loss_scaling or None); O2 also decorates the model
SUB_LEGS = (("fp32", None, None, None),
            ("o1_bf16", "O1", "bfloat16", None),
            ("o2_fp16", "O2", "float16", 32768.0))
#: the user Layer against plain versions, as train_parity holds LLaMA
SUB_LAYER_LOSS_RTOL, SUB_LAYER_GRAD_TOL = 1e-5, 1e-4
#: the float16 Layer (O1 float16 under the GradScaler), kernels against
#: plain: the losses within this relative bound (about 9x the largest of
#: the first H100 readings, 1.1e-6), every unscaled gradient of every
#: step within BWD_TOL["float16"]'s scaled form (read: at most 3.3e-3 of
#: a tensor's max)
SUB_LAYER_F16_LOSS_RTOL = 1e-5
#: the flash kernels' non-causal mode, counted apart (``name:full``) and
#: reported in the kernels line beside the causal rows
FULL = tuple(f"{n}:full" for n in ("flash",) + BWD)
#: float16 in the flash kernels (Queue C 8): the kernels line's ``:f16``
#: rows, launched on the substrate's float16 user Layer legs
F16 = "float16"
F16_ROWS = ("flash",) + BWD + tuple(ROPE) + (PRE_PASS,)


def _gpt_trainer(level, dtype, init, seed):
    """GPT-3 345M through the Paddle surface only: ``paddle.seed``, the
    model on ``gpu:0``, AdamW(weight decay 0.01, global-norm clip 1.0,
    biases and LayerNorms undecayed) on ``LinearWarmup(
    CosineAnnealingDecay)`` (warm-up over 100 steps: the run stays in it,
    so the scheduler's saved state is whole), ``decorate`` at O2 and the
    GradScaler for fp16."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_345m
    paddle.set_device("gpu:0")
    paddle.seed(seed)
    model = GPTForCausalLM(gpt3_345m())
    if level == "O2":
        paddle.amp.decorate(model, level="O2", dtype=dtype)
    lr = paddle.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=1000),
                            warmup_steps=100, start_lr=1e-4, end_lr=1e-3)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.named_parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: not (n.endswith(".bias")
                                             or ".ln_" in n))
    scaler = paddle.amp.GradScaler(init_loss_scaling=init) if init else None
    return model, opt, sched, scaler


def _gpt_step(model, opt, sched, scaler, ids, level, dtype):
    import paddle_tpu_torch as paddle
    with paddle.amp.auto_cast(enable=level is not None, level=level or "O1",
                              dtype=dtype or "bfloat16"):
        loss = model(ids, ids)
    if scaler is not None:
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
    else:
        loss.backward()
        opt.step()
    opt.clear_grad()
    sched.step()
    return float(loss.detach())


def _mask_ms():
    """One step's dropout masks: the attention probabilities' [8, 16,
    1024, 1024] (one a block) and the hidden states' [8, 1024, 1024] (two
    a block and the embedding's), each drawn by the threefry key walk
    on the card; returns (attention ms, hidden ms, a step's mask ms)."""
    import torch
    from paddle_tpu_torch.core import random as prng
    from paddle_tpu_torch.nn.functional import _mask
    dev = torch.device("cuda")
    key = prng.PRNGKey(3)
    att = time_ms(lambda: _mask(key, 0.9, (SUB_B, SUB_H, SUB_S, SUB_S),
                                dev), iters=5)
    hid = time_ms(lambda: _mask(key, 0.9, (SUB_B, SUB_S, SUB_H * SUB_D),
                                dev), iters=5)
    return att, hid, 24 * att + 49 * hid


def _gpt_leg(label, level, dtype, init):
    """Ten steps on a repeated seeded batch; the model, the optimizer
    (scheduler inside), the scaler and the RNG key saved after step 5 and
    loaded into a fresh model and optimizer (built from another seed),
    whose steps 6-10 must give the same losses bit for bit. It runs beside
    the kernel build, so its steps are not timed (``_gpt_steps`` is)."""
    import shutil
    import torch
    import paddle_tpu_torch as paddle
    _free()
    ids = _train_ids(SUB_VOCAB, SUB_B, SUB_S, seed=7)
    ckpt = ROOT / "build" / "substrate_ckpt"
    ckpt.mkdir(parents=True, exist_ok=True)
    model, opt, sched, scaler = _gpt_trainer(level, dtype, init, seed=19)
    losses, io_s = [], 0.0
    for i in range(SUB_STEPS):
        losses.append(_gpt_step(model, opt, sched, scaler, ids, level,
                                dtype))
        if i == SUB_SAVE_AT - 1:
            t0 = time.perf_counter()
            paddle.save(model.state_dict(), str(ckpt / "gpt.pdparams"))
            paddle.save(opt.state_dict(), str(ckpt / "gpt.pdopt"))
            paddle.save({"rng": paddle.get_rng_state(),
                         "scaler": scaler.state_dict() if scaler else None},
                        str(ckpt / "extra.pd"))
            io_s += time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scale = scaler.state_dict()["scale"] if scaler else None
    skipped = scaler.skipped_steps if scaler else None
    n_params = model.num_params()
    del model, opt, sched, scaler
    _free()
    model, opt, sched, scaler = _gpt_trainer(level, dtype, init, seed=20)
    t0 = time.perf_counter()
    model.set_state_dict(paddle.load(str(ckpt / "gpt.pdparams")))
    opt.set_state_dict(paddle.load(str(ckpt / "gpt.pdopt")))
    extra = paddle.load(str(ckpt / "extra.pd"))
    paddle.set_rng_state(extra["rng"])
    if scaler is not None:
        scaler.load_state_dict(extra["scaler"])
    io_s += time.perf_counter() - t0
    resumed = [_gpt_step(model, opt, sched, scaler, ids, level, dtype)
               for _ in range(SUB_STEPS - SUB_SAVE_AT)]
    del model, opt, sched, scaler
    shutil.rmtree(ckpt, ignore_errors=True)
    _free()
    row = {"phase": "substrate", "run": f"gpt3_345m_{label}",
           "amp": {"level": level, "dtype": dtype}, "params": n_params,
           "layers": 24, "B": SUB_B, "S": SUB_S, "losses": losses,
           "resumed_losses_6_10": resumed,
           "resume_bit_for_bit": resumed == losses[SUB_SAVE_AT:],
           "peak_mem_gb": peak, "loss_scale": scale,
           "skipped_steps": skipped,
           # beside the build: the host is contended
           "checkpoint_io_s_beside_build": io_s}
    emit(row)
    finite = all(map(math.isfinite, losses + resumed))
    if not finite or not losses[-1] < losses[0]:
        raise RuntimeError(f"substrate {label}: losses {losses} not finite "
                           f"and falling")
    if not row["resume_bit_for_bit"]:
        raise RuntimeError(f"substrate {label}: resumed {resumed} != "
                           f"{losses[SUB_SAVE_AT:]}")
    return row


def _gpt_steps(label, level, dtype, init):
    """A leg's step time on an uncontended host: a fresh model from the
    same seed, SUB_TIME_STEPS steps, the mean of steps 2 onward."""
    import torch
    _free()
    ids = _train_ids(SUB_VOCAB, SUB_B, SUB_S, seed=7)
    model, opt, sched, scaler = _gpt_trainer(level, dtype, init, seed=19)
    step_s = []
    for _ in range(SUB_TIME_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _gpt_step(model, opt, sched, scaler, ids, level, dtype)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, opt, sched, scaler
    _free()
    mean_s = sum(step_s[1:]) / len(step_s[1:])
    row = {"phase": "substrate", "check": "step_time",
           "run": f"gpt3_345m_{label}", "step_ms": [1e3 * t for t in step_s],
           f"mean_step_ms_2_{SUB_TIME_STEPS}": 1e3 * mean_s,
           "tokens_per_s": SUB_B * SUB_S / mean_s, "peak_mem_gb": peak}
    emit(row)
    return row


def _fa_run(fn, q, k, v, do):
    """Output and dQ, dK, dV of ``fn(q, k, v)`` through autograd."""
    import torch
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*qkv)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    return (out.detach(),) + tuple(grads)


def _fa_parity(fn, q, k, v, do, dtype_name, tag, expect):
    """``fn`` through the kernels (twice) and through the plain versions:
    O within ``TOL``, dQ/dK/dV within ``BWD_TOL``, the same bits twice,
    and the first call's launches equal to ``expect``. Returns the row's
    numbers."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    got = _fa_run(fn, q, k, v, do)
    launched = {n: c for n, c in LAUNCHES.items() if c}
    again = _fa_run(fn, q, k, v, do)
    set_flags({"FLAGS_use_cuda_kernels": False})
    try:
        want = _fa_run(fn, q, k, v, do)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    err_o = _compare(tag + " O", dtype_name, got[0], want[0])
    errs = [_compare_scaled(f"{tag} {n}", dtype_name, g, w)
            for n, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:])]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if launched != expect or not bitwise:
        raise RuntimeError(f"{tag} {dtype_name}: launches {launched} (want "
                           f"{expect}), bits twice {bitwise}")
    return {"o_max_abs_err": err_o,
            "grad_max_err_over_max": max(e[1] for e in errs),
            "same_bits_twice": bitwise, "launches": launched}


#: float16 through ``F.flash_attention`` (Queue C 8): GPT-345M's attention
#: and the 7B training shape, causal and not; then the RoPE mode
SUB_F16_SHAPES = ((SUB_B, SUB_S, SUB_H, SUB_D), (TRAIN_B, TRAIN_S, 32, 128))


def _substrate_flash(dev, gen):
    """``F.flash_attention`` at GPT-345M's attention shape and at the tail
    length, bf16 and fp32, causal and not: O and the gradients against
    the plain versions (``TOL``, ``BWD_TOL``), the same bits on a second
    call, one forward, one dK/dV and one dQ launch a call. Then float16
    (Queue C 8) at ``SUB_F16_SHAPES``, causal and not, and at each of
    them the RoPE mode (``flash_attention(..., rope=)``) with its two
    pre-pass launches, held the same way to fp16's bounds, and the
    pre-pass ``rope_qk`` on its own: bit for bit the plain rotation, in
    the inputs' strides."""
    import torch
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.nn import functional as F
    out = []
    cases = [(SUB_B, S, SUB_H, SUB_D, d, c)
             for S in (SUB_S, SUB_TAIL_S) for d in ("bfloat16", "float32")
             for c in (True, False)]
    cases += [shape + ("float16", c) for shape in SUB_F16_SHAPES
              for c in (True, False)]
    for B, S, H, D, dtype_name, causal in cases:
        mk = lambda: torch.randn(  # noqa: E731
            B, S, H, D, generator=gen,
            device=dev).to(getattr(torch, dtype_name))
        q, k, v, do = mk(), mk(), mk(), mk()
        sfx = "" if causal else ":full"
        tag = f"F.flash_attention B={B} S={S} {H}x{D} causal={causal}"
        row = {"phase": "substrate", "check": "flash_attention", "B": B,
               "S": S, "H": H, "D": D, "dtype": dtype_name,
               "causal": causal, **_fa_parity(
                   lambda a, b, c: F.flash_attention(a, b, c,
                                                     causal=causal)[0],
                   q, k, v, do, dtype_name, tag,
                   {f"{n}{sfx}": 1 for n in ("flash",) + BWD})}
        emit(row)
        out.append(row)
        del q, k, v, do
        torch.cuda.empty_cache()
    for B, S, H, D in SUB_F16_SHAPES:
        mk = lambda: torch.randn(B, S, H, D, generator=gen,  # noqa: E731
                                 device=dev).to(torch.float16)
        q, k, v, do = mk(), mk(), mk(), mk()
        rope = _rope_tables(S, D, 10000.0, device=dev)
        tag = f"flash[rope] B={B} S={S} {H}x{D}"
        row = {"phase": "substrate", "check": "flash_attention_rope",
               "B": B, "S": S, "H": H, "D": D, "dtype": "float16",
               "causal": True, **_fa_parity(
                   lambda a, b, c: flash.flash_attention(a, b, c,
                                                         rope=rope),
                   q, k, v, do, "float16", tag,
                   {**{n: 1 for n in ROPE}, PRE_PASS: 2})}
        gq, gk = flash.rope_qk(q, k, *rope)
        wq, wk = flash.rope_rotate(q, *rope), flash.rope_rotate(k, *rope)
        torch.cuda.synchronize()
        row["rope_qk_max_abs_err"] = max(
            (gq.float() - wq.float()).abs().max().item(),
            (gk.float() - wk.float()).abs().max().item())
        row["rope_qk_bit_for_bit"] = (
            torch.equal(gq, wq) and torch.equal(gk, wk)
            and gq.stride() == q.stride() and gk.stride() == k.stride())
        emit(row)
        if not row["rope_qk_bit_for_bit"]:
            raise RuntimeError(f"{tag} rope_qk float16: not rope_rotate's "
                               f"bits in the inputs' strides")
        out.append(row)
        del q, k, v, do, gq, gk, wq, wk
        torch.cuda.empty_cache()
    return out


def _user_net(causal, rope=False):
    """Two pre-LN blocks at GPT-345M widths (hidden 1024, 16 heads of 64,
    FFN 4096, vocabulary 50304, the head tied to an embedding drawn from
    normal(0, 0.02)) written
    as a user writes them on the substrate, attention by
    ``F.flash_attention`` — or, with ``rope``, a rotary block's: the
    head-major entry ``flash_attention_bhsd(..., rope=(sin, cos))``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels.flash import flash_attention_bhsd
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.nn import functional as F
    hidden = SUB_H * SUB_D
    tables = _rope_tables(SUB_S, SUB_D, 10000.0, device="cuda") \
        if rope else None

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.proj = nn.Linear(hidden, hidden)
            self.ln2 = nn.LayerNorm(hidden)
            self.fc1 = nn.Linear(hidden, 4 * hidden)
            self.fc2 = nn.Linear(4 * hidden, hidden)

        def forward(self, x):
            B, S = x.shape[0], x.shape[1]
            qkv = paddle.reshape(self.qkv(self.ln1(x)),
                                 [B, S, 3, SUB_H, SUB_D])
            q, k, v = paddle.unbind(qkv, axis=2)
            if tables is None:
                o, _ = F.flash_attention(q, k, v, causal=causal)
            else:
                o = flash_attention_bhsd(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, rope=tables).transpose(1, 2)
            x = x + self.proj(paddle.reshape(o, [B, S, hidden]))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            # normal(0, 0.02), as GPT initializes its embedding: at
            # Embedding's default normal(0, 1) the tied head's logits
            # reach ~1e3 and the softmax's saturation turns summation-
            # order differences into visible gradient differences
            self.emb = nn.Embedding(SUB_VOCAB, hidden, weight_attr=(
                paddle.framework.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, 0.02))))
            self.blocks = nn.LayerList([Block(), Block()])
            self.ln = nn.LayerNorm(hidden)

        def forward(self, ids, labels):
            x = self.emb(ids)
            for b in self.blocks:
                x = b(x)
            logits = paddle.matmul(self.ln(x), self.emb.weight,
                                   transpose_y=True)
            return F.cross_entropy(logits[:, :-1], labels[:, 1:])

    return Net()


def _user_layer_leg(causal, amp=None, rope=False):
    """Three AdamW steps of the two-block Layer, through the kernels and
    through the plain versions from the same seed: in fp32 losses within
    1e-5 relative and every gradient within 1e-4 of its largest entry;
    under ``auto_cast(level="O1", dtype="float16")`` (the attention's
    inputs in fp16) with ``GradScaler()`` at its default scale, as
    Paddle's fp16 scripts train, the losses within
    ``SUB_LAYER_F16_LOSS_RTOL`` and every unscaled gradient within
    ``BWD_TOL["float16"]``'s scaled form, no step skipped (the worst
    tensors' names reported beside them); the kernels launched once a
    block a step, in this leg's mode (``rope``: the rotary block, two
    ``rope_qk`` launches a block a step). Returns the kernels'
    launches."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    ids = _train_ids(SUB_VOCAB, SUB_B, SUB_S, seed=8)
    runs = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            paddle.set_device("gpu:0")
            paddle.seed(31)
            net = _user_net(causal, rope)
            opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                         parameters=net.parameters())
            scaler = paddle.amp.GradScaler() if amp else None
            reset_launches()
            losses, grads = [], []
            for _ in range(3):
                with paddle.amp.auto_cast(enable=amp is not None,
                                          level="O1",
                                          dtype=amp or "bfloat16"):
                    loss = net(ids, ids)
                if scaler is None:
                    loss.backward()
                    grads.append({n: p.grad.detach().clone()
                                  for n, p in net.named_parameters()})
                    opt.step()
                else:
                    inv = 1.0 / scaler.state_dict()["scale"]
                    scaler.scale(loss).backward()
                    grads.append({n: p.grad.detach().float() * inv
                                  for n, p in net.named_parameters()})
                    scaler.step(opt)
                    scaler.update()
                opt.clear_grad()
                losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            runs[use] = (losses, grads, {n: c for n, c in LAUNCHES.items()
                                         if c},
                         scaler.skipped_steps if scaler else 0)
            del net, opt, scaler
            _free()
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    (lk, gk, nk, sk), (lp, gp, npl, sp) = runs[True], runs[False]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    per = [{n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(
        min=1e-30)).item() for n in b} for a, b in zip(gk, gp)]
    step_errs = [max(e.values()) for e in per]
    grad_err = max(step_errs)
    worst = [sorted(e.items(), key=lambda kv: -kv[1])[:3] for e in per]
    if amp is None:
        ok = loss_err <= SUB_LAYER_LOSS_RTOL and grad_err <= \
            SUB_LAYER_GRAD_TOL
    else:
        atol, rtol = BWD_TOL[amp]
        within = all(bool(((a[n] - b[n]).abs() <= atol * b[n].abs().max()
                           + rtol * b[n].abs()).all())
                     for a, b in zip(gk, gp) for n in b)
        ok = (loss_err <= SUB_LAYER_F16_LOSS_RTOL and within
              and sk == sp == 0)
    sfx = "" if causal else ":full"
    want = {f"{n}{sfx}": 6 for n in (tuple(ROPE) if rope
                                     else ("flash",) + BWD)}
    if rope:
        want[PRE_PASS] = 12
    emit({"phase": "substrate", "run": "user_layer", "causal": causal,
          "amp": amp, "rope": rope,
          "layers": 2, "losses_kernels": lk, "losses_plain": lp,
          "loss_rel_err": loss_err, "grad_err_over_max": grad_err,
          "grad_err_over_max_by_step": step_errs,
          "worst_by_step": worst, "skipped_steps": [sk, sp],
          "launches_kernels": nk, "launches_plain": sum(npl.values())})
    if not ok:
        raise RuntimeError(f"user layer causal={causal} amp={amp} "
                           f"rope={rope}: loss err {loss_err}, grad err "
                           f"{grad_err}")
    if nk != want or npl:
        raise RuntimeError(f"user layer causal={causal} amp={amp} "
                           f"rope={rope}: launches {nk}, expected {want}, "
                           f"plain {npl}")
    return nk


def full_rows(dev, gen):
    """The non-causal kernels at GPT-345M's attention shape in bf16 against
    their plain versions: error, kernel / plain / library ms (library:
    non-causal SDPA, forward; forward + backward less forward for the
    backward pair), the bound over every (query, key) pair."""
    import torch
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash
    dtype_name = "bfloat16"
    dtype = torch.bfloat16
    isz = 2
    B, S, H, D = SUB_B, SUB_S, SUB_H, SUB_D
    mk = lambda: torch.randn(B, S, H, D, generator=gen,  # noqa: E731
                             device=dev).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    o, lse = flash.flash_attention_fwd(q, k, v, False)
    delta = flash.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: TF.scaled_dot_product_attention(qt, kt, vt)  # noqa
    with torch.no_grad():
        lib_f = time_ms(sdpa)
    lib_fb = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                     iters=5)
    pairs = B * H * S * S
    cases = {
        "flash:full": (lambda: flash.flash_attention_fwd(q, k, v, False),
                       lambda: flash.flash_attention_reference(q, k, v,
                                                               False),
                       4, 4 * q.numel() * isz + 4 * B * H * S, lib_f,
                       "SDPA non-causal"),
        "flash_bwd_dkv:full": (
            lambda: flash.flash_bwd_dkv(*args, causal=False),
            lambda: flash.flash_bwd_dkv_reference(*args, causal=False), 8,
            (2 * q.numel() + 2 * k.numel()) * isz + 2 * 4 * B * H * S
            + 2 * k.numel() * isz, lib_fb - lib_f,
            "SDPA non-causal fwd+bwd minus fwd (the pair)"),
        "flash_bwd_dq:full": (
            lambda: (flash.flash_bwd_dq(*args, causal=False),),
            lambda: (flash.flash_bwd_dq_reference(*args, causal=False),), 6,
            (2 * q.numel() + 2 * k.numel()) * isz + 2 * 4 * B * H * S
            + q.numel() * isz, lib_fb - lib_f,
            "SDPA non-causal fwd+bwd minus fwd (the pair)")}
    rows = {}
    for name, (run, plain, per_pair, nbytes, lib, lib_what) in \
            cases.items():
        got, want = run(), plain()
        torch.cuda.synchronize()
        if name == "flash:full":
            err = _compare(name, dtype_name, got[0], want[0])
        else:
            err = max(_compare_scaled(name, dtype_name, g, w)[0]
                      for g, w in zip(got, want))
        del got, want
        flops = per_pair * pairs * D
        row = {"phase": "kernels", "name": name, "mode": "full",
               "dtype": dtype_name,
               "shape": {"B": B, "S": S, "H": H, "Hk": H, "D": D},
               "max_abs_err": err, "ms": time_ms(run, iters=10),
               "device_ms": device_ms(run, iters=10),
               "plain_ms": time_ms(plain, iters=3), "library_ms": lib,
               "library": lib_what, "bytes": nbytes, "flops": flops,
               "bound_ms": bound_ms(nbytes, flops, dtype_name),
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / PEAK_FLOPS[dtype_name]
                            else "operations"),
               "route": route(name.split(":")[0], dtype_name)}
        row["tflops"] = flops / row["ms"] / 1e9
        emit(row)
        rows[name] = row
        torch.cuda.empty_cache()
    return rows


def phase_substrate_gpt():
    """GPT-3 345M trained eagerly through the Paddle surface in fp32, O1
    bf16 and O2 fp16 with the GradScaler: 10 steps, resumed from a
    checkpoint bit for bit. Its attention is the plain SDPA: no kernel of
    the port, so these checks run while the kernels build; nothing here
    is timed (nvcc holds every core)."""
    for leg in SUB_LEGS:
        _gpt_leg(*leg)


def phase_substrate_steps():
    """The GPT legs' step times and the dropout masks' share of a step,
    after the build, on an uncontended host."""
    legs = [_gpt_steps(*leg) for leg in SUB_LEGS]
    att, hid, per_step = _mask_ms()
    mean = f"mean_step_ms_2_{SUB_TIME_STEPS}"
    emit({"phase": "substrate", "check": "dropout_masks",
          "attention_mask_ms": att, "hidden_mask_ms": hid,
          "masks_ms_a_step": per_step,
          "share_of_step": {r["run"]: per_step / r[mean] for r in legs}})


def phase_substrate():
    """The rest of the Paddle-shaped substrate on the card (after
    ``train``): ``F.flash_attention`` on the flash kernels in both modes,
    the two-block user Layer (causal, then non-causal: the ``:full``
    kernels' main path) against plain, and the non-causal kernels' rows.
    Returns (rows, launches) for the kernels line."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    _substrate_flash(dev, gen)
    _free()
    _user_layer_leg(True)
    launches = _user_layer_leg(False)
    # float16 (Queue C 8): the same Layer under O1 float16, then its
    # rotary form — the main path of the kernels line's ``:f16`` rows
    f16 = {f"{n}:f16": c for n, c in _user_layer_leg(True, "float16")
           .items()}
    f16.update({f"{n}:f16": c for n, c in
                _user_layer_leg(True, "float16", rope=True).items()})
    rows = full_rows(dev, gen)
    _free()
    return rows, {**launches, **f16}


# ------------------------------------------------------------------ vision
#: ResNet-50 on ImageNet as PaddleClas trains it
#: (ppcls/configs/ImageNet/ResNet/ResNet50.yaml): batch 64 a card,
#: Momentum(0.9), L2Decay(1e-4), Piecewise from 0.1 at epochs 30/60/90,
#: CrossEntropyLoss, 224 x 224 crops; the data is FakeData at ImageNet's
#: image shape (HWC, as a decoded JPEG) through the training transforms
VIS_B, VIS_SIDE, VIS_CLASSES = 64, 224, 1000
VIS_STEPS = 12
VIS_WORKERS = 8
#: steps an ImageNet epoch at batch 64 (1,281,167 images)
VIS_EPOCH_STEPS = 1281167 // VIS_B
#: the legs: (label, AMP level or None, through jit.TrainStep)
VIS_LEGS = (("fp32_eager", None, False), ("o1_bf16", "O1", False),
            ("fp32_trainstep", None, True))
#: the process-worker leg: workers, steps (each batch through a ring)
VIS_PROC_WORKERS, VIS_PROC_STEPS = 2, 4
#: one training step at batch 4 on the card against the float64 step on
#: the CPU: loss relative, each gradient over its largest entry (the
#: train_parity bounds)
VIS_CPU_B, VIS_CPU_LOSS_RTOL, VIS_CPU_GRAD_TOL = 4, 1e-5, 1e-4
#: each residual branch's last BatchNorm scale (``bn3.weight``) in that
#: step, as the CPU tests condition ResNet (``BRANCH_SCALE``)
VIS_BRANCH_SCALE = 0.1


def _vision_loader(batches, workers, mode, seed, **kw):
    """``batches`` batches of 64 FakeData images (224 x 224 x 3, HWC)
    through RandomResizedCrop(224), a random flip, HWC -> CHW and the
    ImageNet mean/std, shuffled, from a DataLoader with ``workers``
    workers of ``mode``."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import datasets, transforms as T
    tf = T.Compose([T.RandomResizedCrop(VIS_SIDE), T.RandomHorizontalFlip(),
                    T.Transpose((2, 0, 1)),
                    T.Normalize([0.485, 0.456, 0.406],
                                [0.229, 0.224, 0.225])])
    ds = datasets.FakeData(batches * VIS_B, (VIS_SIDE, VIS_SIDE, 3),
                           VIS_CLASSES, transform=tf)
    np.random.seed(seed)
    return paddle.io.DataLoader(ds, batch_size=VIS_B, shuffle=True,
                                drop_last=True, num_workers=workers,
                                worker_mode=mode, **kw)


def _vision_trainer(seed, device="gpu:0"):
    """ResNet-50 from ``seed`` on ``device`` and PaddleClas's optimizer."""
    import paddle_tpu_torch as paddle
    paddle.set_device(device)
    paddle.seed(seed)
    model = paddle.vision.models.resnet50()
    sched = paddle.optimizer.lr.PiecewiseDecay(
        [e * VIS_EPOCH_STEPS for e in (30, 60, 90)],
        [0.1, 0.01, 0.001, 0.0001])
    opt = paddle.optimizer.Momentum(
        learning_rate=sched, momentum=0.9, parameters=model.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    return model, opt, sched


def _vision_step(model, opt, sched, x, y, amp=None, step=None):
    """One training step (eager, or ``step`` a ``jit.TrainStep``)."""
    import paddle_tpu_torch as paddle
    if step is not None:
        loss = step.step((x,), (y,))
    else:
        with paddle.amp.auto_cast(enable=amp is not None, level=amp or "O1",
                                  dtype="bfloat16"):
            loss = paddle.nn.CrossEntropyLoss()(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    sched.step()
    return loss.detach()


def _vision_leg(smi, label, amp, trainstep, workers=VIS_WORKERS,
                mode="thread", steps=VIS_STEPS):
    """``steps`` steps of ResNet-50 at batch 64 from the loader: step ms
    (from asking the loader for a batch to the step's end, synchronized),
    images/s, the ms a step waited on the loader, peak memory; losses
    finite. Returns the row."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    _free()
    torch.cuda.reset_peak_memory_stats()
    model, opt, sched = _vision_trainer(seed=3)
    step = (TrainStep(model, paddle.nn.CrossEntropyLoss(), opt)
            if trainstep else None)
    loader = _vision_loader(steps, workers, mode, seed=5)
    batches = iter(loader)
    losses, step_s, wait_s = [], [], []
    torch.cuda.synchronize()
    for _ in range(steps):
        t0 = time.perf_counter()
        x, y = next(batches)
        t1 = time.perf_counter()
        loss = _vision_step(model, opt, sched, x, y, amp, step)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        wait_s.append(t1 - t0)
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    row = {"phase": "vision", "run": f"resnet50_{label}", "card": smi,
           "B": VIS_B, "side": VIS_SIDE, "amp": amp,
           "trainstep": trainstep, "workers": workers, "worker_mode": mode,
           "params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "mean_step_ms_3_on": 1e3 * mean_s,
           "images_per_s": VIS_B / mean_s,
           "loader_wait_ms": [1e3 * t for t in wait_s],
           "mean_loader_wait_ms_3_on": 1e3 * sum(wait_s[2:])
           / len(wait_s[2:]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "transport": dict(loader.transport)}
    emit(row)
    del model, opt, sched, step, batches, loader
    _free()
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"vision {label}: losses {losses} not finite")
    return row


def _vision_resume(smi):
    """Two steps, ``paddle.save`` of the model (BatchNorm buffers
    included) and the optimizer (Momentum velocity, the scheduler), two
    more steps; a fresh model and optimizer from another seed, loaded,
    must give those steps' losses and weights bit for bit. cuDNN is made
    deterministic for this leg alone (its weight-gradient algorithms may
    sum in another order on each run)."""
    import shutil
    import torch
    import paddle_tpu_torch as paddle
    ckpt = ROOT / "build" / "vision_ckpt"
    ckpt.mkdir(parents=True, exist_ok=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        data = [(x.clone(), y.clone()) for x, y in
                _vision_loader(4, VIS_WORKERS, "thread", seed=6)]
        model, opt, sched = _vision_trainer(seed=3)
        for x, y in data[:2]:
            _vision_step(model, opt, sched, x, y)
        paddle.save(model.state_dict(), str(ckpt / "r50.pdparams"))
        paddle.save(opt.state_dict(), str(ckpt / "r50.pdopt"))
        want = [float(_vision_step(model, opt, sched, x, y))
                for x, y in data[2:]]
        final = {k: v.clone() for k, v in model.state_dict().items()}
        del model, opt, sched
        _free()
        model, opt, sched = _vision_trainer(seed=4)
        model.set_state_dict(paddle.load(str(ckpt / "r50.pdparams")))
        opt.set_state_dict(paddle.load(str(ckpt / "r50.pdopt")))
        got = [float(_vision_step(model, opt, sched, x, y))
               for x, y in data[2:]]
        same = got == want and all(torch.equal(v, final[k]) for k, v in
                                   model.state_dict().items())
        del model, opt, sched, data, final
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        shutil.rmtree(ckpt, ignore_errors=True)
        _free()
    emit({"phase": "vision", "check": "resume", "card": smi,
          "losses_3_4": want, "resumed_losses_3_4": got,
          "bit_for_bit": same})
    if not same:
        raise RuntimeError(f"vision resume: {got} != {want}")


def _vision_cpu_parity(smi):
    """One training step of the seeded ResNet-50 at batch 4, 224 x 224,
    its residual branches' last BatchNorm scales set to
    ``VIS_BRANCH_SCALE``, on the card and on the CPU. In float64 the card
    is held to the CPU: the loss within 1e-5 relative, the BatchNorm
    buffers after the step within 1e-5, every gradient within 1e-4 of its
    largest entry. In fp32 the card is held to the CPU's float64 step:
    the loss and the buffers the same way, and each gradient within 1e-4
    of its largest entry where fp32 can reach that (the CPU's own fp32
    step within a tenth of it); the other gradients are reported beside
    the CPU fp32 step's distance. (Training-mode BatchNorm under the
    global average pool cancels most of a late block's gradient: fp32
    gradients of those tensors part from float64 ones far past 1e-4 on
    any device, the CPU's included.)"""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    r = np.random.RandomState(8)
    x = r.randn(VIS_CPU_B, 3, VIS_SIDE, VIS_SIDE).astype(np.float32)
    y = r.randint(0, VIS_CLASSES, VIS_CPU_B).astype(np.int64)
    runs = {}
    for dev, dtype in (("cpu", "float64"), ("cpu", "float32"),
                       ("gpu:0", "float64"), ("gpu:0", "float32")):
        paddle.set_device(dev)
        paddle.seed(9)
        model = paddle.vision.models.resnet50().to(dtype=dtype)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.startswith("layer") and n.endswith(".bn3.weight"):
                    p.fill_(VIS_BRANCH_SCALE)
        loss = paddle.nn.CrossEntropyLoss()(
            model(paddle.to_tensor(x).to(getattr(torch, dtype))),
            paddle.to_tensor(y))
        loss.backward()
        runs[(dev, dtype)] = (
            float(loss), {n: p.grad.detach().double().cpu()
                          for n, p in model.named_parameters()},
            {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if b.is_floating_point()})
        del model, loss
    paddle.set_device("gpu:0")
    lt, gt, bt = runs[("cpu", "float64")]

    def errs(run):
        loss, g, b = run
        return (abs(loss - lt) / abs(lt),
                {n: float((g[n] - w).abs().max() / w.abs().max().clamp(
                    min=1e-30)) for n, w in gt.items()},
                max(float((b[n] - w).abs().max() / w.abs().max().clamp(
                    min=1.0)) for n, w in bt.items()))

    l64, g64, b64 = errs(runs[("gpu:0", "float64")])
    l32, g32, b32 = errs(runs[("gpu:0", "float32")])
    _, g_cpu, _ = errs(runs[("cpu", "float32")])
    held = [n for n, e in g_cpu.items() if e <= VIS_CPU_GRAD_TOL / 10]
    over = {**{f"{n} float64": e for n, e in g64.items()
               if e > VIS_CPU_GRAD_TOL},
            **{f"{n} float32": e for n in held
               if (e := g32[n]) > VIS_CPU_GRAD_TOL}}
    worst = sorted(((n, e, g_cpu[n]) for n, e in g32.items()
                    if n not in held), key=lambda t: -t[1])[:5]
    emit({"phase": "vision", "check": "card_vs_cpu", "card": smi,
          "B": VIS_CPU_B, "branch_scale": VIS_BRANCH_SCALE,
          "loss_float64_cpu": lt,
          "float64": {"loss_rel_err": l64,
                      "grad_err_over_max": max(g64.values()),
                      "bn_buffer_err": b64},
          "float32": {"loss_rel_err": l32,
                      "grad_err_over_max": max(g32.values()),
                      "bn_buffer_err": b32, "tensors_held": len(held),
                      "held_grad_err_over_max": max(
                          (g32[n] for n in held), default=None),
                      "tensors_within_1e-4": sum(
                          e <= VIS_CPU_GRAD_TOL for e in g32.values()),
                      "cpu_fp32_grad_err_over_max": max(g_cpu.values()),
                      "worst_unheld_card_cpu_fp32": worst},
          "tensors": len(g32), "over_bound": over})
    if (max(l64, l32) > VIS_CPU_LOSS_RTOL or over
            or max(b64, b32) > 1e-5):
        raise RuntimeError(f"vision card vs CPU: loss {l64}, {l32}; "
                           f"buffers {b64}, {b32}; gradients over the "
                           f"bound {over}")


def phase_vision(smi):
    """ResNet-50 (25.56 M parameters, 1000 classes) trained on one card
    from a DataLoader over FakeData through the ImageNet training
    transforms, batch 64, PaddleClas's optimizer: fp32 eager, O1 bf16 and
    ``jit.TrainStep``, 12 steps each on 8 thread workers; then a short leg
    on process workers whose every batch came through the native ring;
    the resume bit for bit; one step at batch 4 on the card in float64 and
    in fp32 against float64 on the CPU."""
    import os
    rows = [_vision_leg(smi, *leg) for leg in VIS_LEGS]
    shm = os.statvfs("/dev/shm")
    proc = _vision_leg(smi, "fp32_process_workers", None, False,
                       workers=VIS_PROC_WORKERS, mode="process",
                       steps=VIS_PROC_STEPS)
    if proc["transport"] != {"ring": VIS_PROC_STEPS, "queue": 0}:
        raise RuntimeError(f"vision process workers: transport "
                           f"{proc['transport']} (the native ring must "
                           f"carry every batch; /dev/shm free "
                           f"{shm.f_bavail * shm.f_frsize / 2 ** 30:.1f} "
                           f"GiB)")
    _vision_resume(smi)
    _vision_cpu_parity(smi)
    return rows + [proc]


# ------------------------------------------------------------ sequences
#: Transformer base, the WMT14 en-de recipe of PaddleNLP
#: (examples/machine_translation/transformer/configs/transformer.base.yaml,
#: after Vaswani et al. 2017): d_model 512, 8 heads, 6 + 6 post-norm
#: layers, FFN 2048, dropout 0.1 (attention and activation too), one
#: embedding shared by source, target and output, 33,712 rows (the
#: recipe's 33,708-entry joint BPE padded to a multiple of 8)
SEQ_TF = dict(vocab=33712, d=512, heads=8, layers=6, ffn=2048, dropout=0.1)
#: 64 pairs padded to 64 tokens (4096 a side, the recipe's token budget),
#: each side's lengths drawn from 33..64; token 0 pads (and begins the
#: target), as the recipe's bos/pad id
SEQ_TF_B, SEQ_TF_S, SEQ_TF_MIN, SEQ_PAD = 64, 64, 33, 0
#: Adam(0.9, 0.997, 1e-9) on NoamDecay(512, 4000, learning_rate=2.0),
#: started at the warm-up's end (step 4000: the rate's peak, 1.4e-3): at
#: the schedule's first steps the rate is ~3.5e-7 a step and ten steps do
#: not move the loss past the dropout noise
SEQ_TF_WARMUP, SEQ_TF_START = 4000, 3999
#: the PTB "medium" LSTM LM of Zaremba et al. 2014 (PaddleNLP's
#: examples/language_model/rnnlm defaults): vocabulary 10,000, embedding
#: and 2 LSTM layers of 650, dropout 0.5, uniform init +-0.05; batch 20 x
#: 35 steps, the hidden state carried (detached); SGD at 1.0 with
#: ClipGradByGlobalNorm(5.0)
SEQ_LM = dict(vocab=10000, hidden=650, layers=2, dropout=0.5, init=0.05)
SEQ_LM_B, SEQ_LM_T = 20, 35
#: each leg: 10 steps, the mean of steps 3-10
SEQ_STEPS = 10
#: card against CPU in float64, the models at 2 layers and narrow widths
#: with dropout on: loss relative, each gradient over its largest entry
SEQ_CPU_LOSS_RTOL, SEQ_CPU_GRAD_TOL = 1e-5, 1e-4
#: the ops' and functionals' bounds (the substrate's): ops 1e-6 of their max,
#: functionals and losses 1e-5 (gradients 1e-4); optimizers 1e-6 after 3
#: steps; autograd.functional 1e-10 of the max (float64)
SEQ_OP_TOL, SEQ_FN_TOL, SEQ_FN_GRAD_TOL = 1e-6, 1e-5, 1e-4
SEQ_OPT_TOL, SEQ_AD_TOL = 1e-6, 1e-10


def _sinusoid(n, d):
    """PaddleNLP's ``position_encoding_init``: sin of the first half of the
    channels, cos of the second, timescales from 1 to 1e4."""
    import numpy as np
    half = d // 2
    inc = math.log(1e4) / (half - 1)
    inv = np.exp(np.arange(half) * -inc)
    t = np.arange(n)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _seq_models():
    """The two models as user code over the port's layers."""
    import torch
    import paddle_tpu_torch as paddle
    nn = paddle.nn

    class TransformerBase(nn.Layer):
        def __init__(self, vocab, d, heads, layers, ffn, dropout):
            super().__init__()
            self.d = d
            self.emb = nn.Embedding(vocab, d, weight_attr=nn.ParamAttr(
                initializer=nn.initializer.Normal(0.0, d ** -0.5)))
            self.drop = nn.Dropout(dropout)
            self.net = nn.Transformer(d, heads, layers, layers, ffn,
                                      dropout, attn_dropout=dropout,
                                      act_dropout=dropout)
            self.pos = _sinusoid(256, d)

        def _embed(self, ids):
            pos = torch.as_tensor(self.pos[:ids.shape[1]],
                                  device=ids.device,
                                  dtype=self.emb.weight.dtype)
            return self.drop(self.emb(ids) * self.d ** 0.5 + pos)

        def forward(self, src, tgt, src_mask, tgt_mask):
            out = self.net(self._embed(src), self._embed(tgt), src_mask,
                           tgt_mask, src_mask)
            return paddle.matmul(out, self.emb.weight, transpose_y=True)

    class PTBLM(nn.Layer):
        def __init__(self, vocab, hidden, layers, dropout, init,
                     mode="LSTM", **kw):
            super().__init__()
            u = nn.initializer.Uniform(-init, init)

            def attr():
                return nn.ParamAttr(initializer=u)

            self.emb = nn.Embedding(vocab, hidden, weight_attr=attr())
            self.rnn = getattr(nn, mode)(
                hidden, hidden, layers, dropout=dropout,
                weight_ih_attr=attr(), weight_hh_attr=attr(),
                bias_ih_attr=attr(), bias_hh_attr=attr(), **kw)
            self.drop = nn.Dropout(dropout)
            self.fc = nn.Linear(hidden, vocab, weight_attr=attr(),
                                bias_attr=attr())

        def forward(self, ids, states=None):
            y, states = self.rnn(self.drop(self.emb(ids)), states)
            return self.fc(self.drop(y)), states

    return TransformerBase, PTBLM


def _seq_tf_batch(B, S, vocab, seed, device):
    """Seeded random pairs: lengths from SEQ_TF_MIN..S a side, tokens from
    3..vocab, pads 0; the target input starts with 0 (bos); the source's
    additive pad mask ``[B, 1, 1, S]`` (-1e9), the causal target mask."""
    import numpy as np
    import paddle_tpu_torch as paddle
    r = np.random.RandomState(seed)
    lo = min(SEQ_TF_MIN, S)
    src = r.randint(3, vocab, (B, S))
    lab = r.randint(3, vocab, (B, S))
    sl = r.randint(lo, S + 1, B)
    tl = r.randint(lo, S + 1, B)
    ar = np.arange(S)[None, :]
    src = np.where(ar < sl[:, None], src, SEQ_PAD)
    lab = np.where(ar < tl[:, None], lab, SEQ_PAD)
    tgt = np.concatenate([np.full((B, 1), SEQ_PAD), lab[:, :-1]], axis=1)
    mask = np.where(src == SEQ_PAD, -1e9, 0.0).astype(np.float32)
    t = {k: paddle.to_tensor(v, place=device) for k, v in (
        ("src", src), ("tgt", tgt), ("lab", lab),
        ("src_mask", mask[:, None, None, :]))}
    t["tgt_mask"] = paddle.nn.Transformer.generate_square_subsequent_mask(
        S).to(t["src"].device)
    t["tokens"] = int((lab != SEQ_PAD).sum())
    return t


def _seq_tf_loss(model, batch, vocab):
    """Label-smoothed (0.1) soft-label cross entropy over the non-pad
    target tokens (PaddleNLP's ``CrossEntropyCriterion``)."""
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    logits = model(batch["src"], batch["tgt"], batch["src_mask"],
                   batch["tgt_mask"])
    soft = F.label_smooth(F.one_hot(batch["lab"], vocab), epsilon=0.1)
    tok = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = paddle.cast(batch["lab"] != SEQ_PAD, tok.dtype)
    return paddle.sum(tok.reshape(w.shape) * w) / paddle.sum(w)


def _seq_lm_loss(model, ids, states):
    """PaddleNLP's ``CrossEntropyLossForLm``: each step's mean over the
    batch, summed over the steps."""
    import paddle_tpu_torch as paddle
    logits, states = model(ids[:, :-1], states)
    tok = paddle.nn.functional.cross_entropy(logits, ids[:, 1:],
                                             reduction="none")
    return paddle.sum(paddle.mean(tok.reshape(ids.shape[0], -1), axis=0)), \
        states


def _seq_masks_ms(shapes):
    """The ms of one step's dropout masks, each drawn by the threefry key
    walk on the card as ``F.dropout`` draws it: ``shapes`` is ``[(shape,
    count a step), ...]``."""
    import torch
    from paddle_tpu_torch.core import random as prng
    from paddle_tpu_torch.nn.functional import _mask
    dev = torch.device("cuda")
    key = prng.PRNGKey(3)
    return sum(n * time_ms(lambda s=s: _mask(key, 0.9, s, dev), iters=5)
               for s, n in shapes)


def _seq_profile(step):
    """One step under ``torch.profiler``: the device kernels it ran and
    their summed device time (None where the profiler saw no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.device_time if hasattr(e, "device_time")
                 else e.cuda_time for e in evs)
    return {"device_kernels": len(evs),
            "device_ms": dev_us / 1e3 if evs else None,
            "wall_ms": 1e3 * wall,
            "busy_share": dev_us / 1e3 / (1e3 * wall) if evs else None}


def _seq_leg(smi, model_name, amp):
    """SEQ_STEPS steps of one model on a repeated seeded batch, fp32 eager
    or O1 bf16: step ms, tokens/s, peak memory, the masks' ms a step, the
    port's kernel launches a step (none: no kernel on this path) and one
    profiled step's device kernels. Losses finite and falling."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import kernels
    TransformerBase, PTBLM = _seq_models()
    _free()
    paddle.set_device("gpu:0")
    paddle.seed(11)
    if model_name == "transformer_base":
        model = TransformerBase(**SEQ_TF)
        sched = paddle.optimizer.lr.NoamDecay(
            SEQ_TF["d"], SEQ_TF_WARMUP, learning_rate=2.0,
            last_epoch=SEQ_TF_START)
        opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9,
                                    beta2=0.997, epsilon=1e-9,
                                    parameters=model.parameters())
        batch = _seq_tf_batch(SEQ_TF_B, SEQ_TF_S, SEQ_TF["vocab"], 5,
                              "gpu:0")
        tokens = batch["tokens"]
        L, B, S, D, H = (SEQ_TF["layers"], SEQ_TF_B, SEQ_TF_S, SEQ_TF["d"],
                         SEQ_TF["heads"])
        # per step: attention probabilities (L + 2L), the residual and
        # embedding dropouts (2L + 3L + 2), the FFN activations (2L)
        masks = [((B, H, S, S), 3 * L), ((B, S, D), 5 * L + 2),
                 ((B, S, SEQ_TF["ffn"]), 2 * L)]
        state = {}

        def step_loss():
            return _seq_tf_loss(model, batch, SEQ_TF["vocab"])
    else:
        model = PTBLM(**SEQ_LM)
        sched = None
        opt = paddle.optimizer.SGD(
            learning_rate=1.0, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(5.0))
        import numpy as np
        r = np.random.RandomState(5)
        ids = paddle.to_tensor(r.randint(0, SEQ_LM["vocab"],
                                         (SEQ_LM_B, SEQ_LM_T + 1)))
        tokens = SEQ_LM_B * SEQ_LM_T
        masks = [((SEQ_LM_B, SEQ_LM_T, SEQ_LM["hidden"]),
                  3 if SEQ_LM["layers"] > 1 else 2)]
        state = {"h": None}

        def step_loss():
            loss, st = _seq_lm_loss(model, ids, state["h"])
            state["h"] = tuple(s.detach() for s in st)
            return loss
    model.train()
    n_params = sum(p.numel() for p in model.parameters())

    def step():
        with paddle.amp.auto_cast(enable=amp is not None, level="O1",
                                  dtype="bfloat16"):
            loss = step_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    kernels.reset_launches()
    for _ in range(SEQ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = sum(kernels.LAUNCHES[n] for n in kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = _seq_profile(step)
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    mask_ms = _seq_masks_ms(masks)
    leg = "o1_bf16" if amp else "fp32"
    row = {"phase": "seq", "run": f"{model_name}_{leg}",
           "card": smi, "params": n_params, "amp": amp,
           "tokens_per_step": tokens, "losses": losses,
           "step_ms": [1e3 * t for t in step_s],
           "mean_step_ms_3_10": 1e3 * mean_s,
           "tokens_per_s": tokens / mean_s, "peak_mem_gb": peak,
           "mask_ms_per_step": mask_ms,
           "mask_share": mask_ms / (1e3 * mean_s),
           "port_kernel_launches_per_step": launches / SEQ_STEPS,
           "profiled_step": prof}
    emit(row)
    del model, opt, sched, state
    _free()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"seq {row['run']}: losses {losses} not finite "
                           f"and falling")
    if launches:
        raise RuntimeError(f"seq {row['run']}: {launches} kernel launches "
                           f"on a path that has no kernel of the port")
    return row


def _seq_grad_errs(a, b):
    """Each gradient's largest difference over its largest entry, from two
    ``{name: grad}`` maps (CPU float64 tensors). ``k_proj.bias``'s
    gradient is zero in exact arithmetic (it shifts all of a query's
    scores alike, which the softmax cancels): both sides are rounding
    noise there, held to the model's largest gradient instead."""
    top = max(float(w.abs().max()) for w in b.values())
    return {n: float((a[n] - w).abs().max()) / (
        top if n.endswith("k_proj.bias")
        else max(float(w.abs().max()), 1e-30)) for n, w in b.items()}


def _seq_step_on(dev, make, run, seed, state=None):
    """One forward + backward of ``make()`` in float64 on ``dev`` with
    ``state`` (a CPU state dict) loaded and ``seed`` set before the run (the
    dropout masks): the loss and every gradient, on the host."""
    import torch
    import paddle_tpu_torch as paddle
    paddle.set_device(dev)
    paddle.seed(seed)
    model = make().to(dtype=torch.float64)
    if state is not None:
        model.set_state_dict(state)
    model.train()
    paddle.seed(seed + 1)
    loss = run(model, dev)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return float(loss.detach()), grads, sd


def _seq_cpu_parity(smi):
    """Card against CPU in float64 at 2 layers and narrow widths, dropout
    on (the same masks: one seed): Transformer base's and the LSTM LM's
    training step; then GRU, SimpleRNN (tanh and relu) and a bidirectional
    LSTM with ``time_major=True``: loss within SEQ_CPU_LOSS_RTOL, every
    gradient within SEQ_CPU_GRAD_TOL of its largest entry."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    TransformerBase, PTBLM = _seq_models()
    tf_kw = dict(vocab=97, d=32, heads=4, layers=2, ffn=64, dropout=0.1)
    lm_kw = dict(vocab=53, hidden=24, layers=2, dropout=0.5, init=0.05)
    r = np.random.RandomState(12)
    lm_ids = r.randint(0, lm_kw["vocab"], (4, 9))
    x_tm = r.randn(7, 3, 16)

    def tf_run(model, dev):
        batch = _seq_tf_batch(4, 12, tf_kw["vocab"], 6, dev)
        return _seq_tf_loss(model, batch, tf_kw["vocab"])

    def lm_run(model, dev):
        ids = paddle.to_tensor(lm_ids, place=dev)
        return _seq_lm_loss(model, ids, None)[0]

    def rnn_run(model, dev):
        x = paddle.to_tensor(x_tm, dtype="float64", place=dev)
        y, _ = model(x)
        return (y * y).mean()

    cases = [
        ("transformer", lambda: TransformerBase(**tf_kw), tf_run),
        ("lstm_lm", lambda: PTBLM(**lm_kw), lm_run),
        ("gru_lm", lambda: PTBLM(**lm_kw, mode="GRU"), lm_run),
        ("simple_rnn_tanh", lambda: paddle.nn.SimpleRNN(
            16, 12, 2, dropout=0.3), lambda m, d: rnn_run(m, d)),
        ("simple_rnn_relu", lambda: paddle.nn.SimpleRNN(
            16, 12, 2, dropout=0.3, activation="relu"), rnn_run),
        ("bilstm_time_major", lambda: paddle.nn.LSTM(
            16, 12, 2, direction="bidirect", time_major=True, dropout=0.3),
         rnn_run),
    ]
    out, bad = {}, {}
    for name, make, run in cases:
        lc, gc_, sd = _seq_step_on("cpu", make, run, 31)
        lg, gg, _ = _seq_step_on("gpu:0", make, run, 31, sd)
        if gc_.keys() != gg.keys():
            raise RuntimeError(f"seq card vs CPU {name}: gradients of "
                               f"{sorted(gc_.keys() ^ gg.keys())} missing")
        errs = _seq_grad_errs(gg, gc_)
        le = abs(lg - lc) / abs(lc)
        out[name] = {"loss_cpu": lc, "loss_rel_err": le,
                     "grad_err_over_max": max(errs.values()),
                     "worst_tensor": max(errs, key=errs.get),
                     "tensors": len(errs)}
        if le > SEQ_CPU_LOSS_RTOL or max(errs.values()) > SEQ_CPU_GRAD_TOL:
            bad[name] = out[name]
    paddle.set_device("gpu:0")
    emit({"phase": "seq", "check": "card_vs_cpu_float64", "card": smi,
          "models": out})
    if bad:
        raise RuntimeError(f"seq card vs CPU: {bad}")
    return out


# the new ops on the card against the CPU: (args, kwargs) from seeded
# numpy; a float array becomes float64 (and float32 for the losses)
def _seq_op_cases():
    import numpy as np
    r = np.random.RandomState(0)
    X = r.randn(3, 4)
    Y = r.randn(3, 4)
    X3 = r.randn(2, 3, 4)
    POS = r.rand(3, 4) + 0.5
    PROB = r.rand(3, 4) * 0.9 + 0.05
    M = r.randn(4, 4)
    SPD = M @ M.T + 4 * np.eye(4)
    V = r.randn(5)
    I1 = r.randint(-5, 6, (3, 4))
    I2 = r.randint(-5, 6, (3, 4))
    NANS = np.array([[1.0, np.nan, 3.0, -2.0], [np.nan, 0.5, 0.5, 4.0]])
    MASK = r.rand(3, 4) > 0.5
    CONSEC = np.array([1, 1, 2, 2, 3, 1, 1])
    q, tau = np.linalg.qr(r.randn(5, 3), mode="raw")
    extra = {
        "bucketize": ((V, np.sort(r.randn(8))), {}),
        "mode": ((np.array([[1., 3, 3, 2, 1, 3], [4, 4, 2, 2, 5, 5]]),),
                 {}),
        "logaddexp": ((X, Y), {}), "copysign": ((X, Y), {}),
        "heaviside": ((X, Y), {}), "hypot": ((X, Y), {}),
        "angle": ((X,), {}), "sinc": ((X,), {}),
        "logcumsumexp": ((X,), {"axis": 1}), "renorm": ((X, 2.0, 0, 1.0),
                                                          {}),
        "diagonal": ((X3,), {"axis1": 1, "axis2": 2}),
        "diag_embed": ((X,), {"offset": 1}),
        "nanmean": ((NANS,), {"axis": 1}), "nansum": ((NANS,), {}),
        "quantile": ((X,), {"q": [0.25, 0.5], "axis": 1}),
        "nanquantile": ((NANS,), {"q": 0.3, "axis": 1}),
        "polar": ((POS, X), {}), "deg2rad": ((X,), {}),
        "rad2deg": ((X,), {}), "gcd": ((I1, I2), {}), "lcm": ((I1, I2), {}),
        "vander": ((V,), {"n": 4}), "trapezoid": ((X,), {"dx": 0.5}),
        "cdist": ((X, Y), {}), "pdist": ((X,), {}),
        "cholesky_solve": ((X[:, :3].T.copy(),
                            np.linalg.cholesky(SPD[:3, :3])), {}),
        "multi_dot": (([X, M, M.T.copy()],), {}),
        "lu": ((M + 0.5 * np.eye(4),), {"get_infos": True}),
        "eigvals": ((M + 4 * np.eye(4),), {}),
        "householder_product": ((np.ascontiguousarray(q.T), tau), {}),
        "ldexp": ((X, I1), {}), "frexp": ((X,), {}),
        "nextafter": ((X, Y), {}),
        "isneginf": ((np.array([1.0, -np.inf, np.inf]),), {}),
        "isposinf": ((np.array([1.0, -np.inf, np.inf]),), {}),
        "signbit": ((np.array([1.0, -0.0, -3.0]),), {}),
        "combinations": ((V,), {"r": 3}),
        "complex": ((X, Y), {}), "mv": ((X, r.randn(4)), {}),
        "sgn": ((X,), {}), "i0": ((X,), {}), "i0e": ((X,), {}),
        "i1": ((X,), {}), "i1e": ((X,), {}), "polygamma": ((POS, 1), {}),
        "nanmedian": ((NANS,), {"axis": 1}),
        "unflatten": ((X3, 2, [2, 2]), {}),
        "view_as": ((X, np.zeros((4, 3))), {}),
        "take": ((X, np.array([[0, -1], [13, 5]])), {"mode": "wrap"}),
        "index_sample": ((X, np.array([[0, 3], [1, 1], [2, 0]])), {}),
        "index_fill": ((X, np.array([0, 2]), 1, 9.5), {}),
        "select_scatter": ((X, r.randn(4), 0, 1), {}),
        "masked_scatter": ((X, MASK, r.randn(12)), {}),
        "multiplex": (([X, Y], np.array([[1], [0], [1]])), {}),
        "shard_index": ((np.array([[1], [6], [12], [19]]), 20, 2, 1), {}),
        "strided_slice": ((X3, [1, 2], [0, 3], [3, 0], [2, -2]), {}),
        "tensor_split": ((X3, 3), {"axis": 2}),
        "hsplit": ((X, [1, 3]), {}), "vsplit": ((X, 3), {}),
        "dsplit": ((X3, 2), {}),
        "unique_consecutive": ((CONSEC,), {"return_inverse": True,
                                           "return_counts": True}),
        "rank": ((X3,), {}), "is_empty": ((X,), {}),
    }
    tail = {
        "hstack": (([X, Y],), {}), "vstack": (([X, Y],), {}),
        "dstack": (([X, Y],), {}), "row_stack": (([X, Y],), {}),
        "column_stack": (([V, V],), {}), "atleast_1d": ((X, V), {}),
        "atleast_2d": ((V,), {}), "atleast_3d": ((X,), {}),
        "block_diag": (([X, M[:2, :3].copy()],), {}),
        "fill_diagonal": ((X, 7.0), {"offset": 1, "wrap": True}),
        "fill_diagonal_tensor": ((X, np.arange(3.0)), {}),
        "diagonal_scatter": ((M, V[:3].copy()), {"offset": 1}),
        "slice_scatter": ((X, np.zeros((2, 4)), [0], [0], [3], [2]), {}),
        "as_strided": ((X, [3, 2], [1, 4]), {"offset": 1}),
        "unfold": ((X3, 2, 2, 1), {}), "view": ((X3, [6, 4]), {}),
        "cummax": ((np.array([[1., 3, 3, 2, 5, 5]]),), {"axis": 1}),
        "cummin": ((np.array([[4., 3, 3, 5, 1, 1]]),), {"axis": 1}),
        "bitwise_left_shift": ((np.abs(I1), np.abs(I2) % 4), {}),
        "bitwise_right_shift": ((np.array([-64, -3, 17, 255],
                                          np.int32),
                                 np.array([1, 2, 3, 0], np.int32)),
                                {"is_arithmetic": False}),
        "gammaln": ((POS,), {}), "gammainc": ((POS, PROB), {}),
        "gammaincc": ((POS, PROB), {}), "multigammaln": ((POS + 1, 2), {}),
        "isreal": ((X,), {}), "positive": ((X,), {}),
        "negative": ((X,), {}), "logaddexp2": ((X, Y), {}),
        "erfc": ((X,), {}), "xlogy": ((X, POS), {}),
        "cumulative_trapezoid": ((X,), {"dx": 0.5, "axis": 1}),
        "histogramdd": ((r.rand(40, 2),), {"bins": [3, 4],
                                           "density": True}),
        "histogram_bin_edges": ((X,), {"bins": 6}),
        "increment": ((X, 2.5), {}), "clip_by_norm": ((X, 1.0), {}),
        "crop": ((X3, [1, -1, 2], [1, 0, 1]), {}),
        "isin": ((I1, np.array([0, 2, -3])), {}),
        "vecdot": ((X, Y), {}), "matrix_exp": ((0.3 * M,), {}),
        "exp2": ((X,), {}), "cartesian_prod": (([V[:2].copy(),
                                                 V[:3].copy()],), {}),
        "nanmin": ((NANS,), {"axis": 1}), "nanmax": ((NANS,), {"axis": 0}),
        "logdet": ((SPD,), {}), "vdot": ((X, Y), {}), "ravel": ((X3,), {}),
        "chain_matmul": (([X, M, M],), {}),
        "unique_with_counts": ((CONSEC,), {}),
    }
    inplace = {n: (X, (Y,)) for n in ("add_", "subtract_", "multiply_",
                                      "copysign_", "hypot_")}
    inplace.update({n: (POS, ()) for n in (
        "exp_", "sqrt_", "rsqrt_", "reciprocal_", "round_", "floor_",
        "ceil_", "abs_", "neg_", "trunc_", "frac_", "tanh_", "sigmoid_",
        "sin_", "cos_", "tan_", "atan_", "sinh_", "cosh_", "asinh_",
        "expm1_", "log_", "log2_", "log10_", "log1p_", "digamma_",
        "lgamma_", "i0_", "gammaln_", "nan_to_num_", "tril_", "triu_",
        "t_", "flatten_")})
    inplace.update({
        "divide_": (X, (POS,)), "remainder_": (X, (POS,)),
        "mod_": (X, (POS,)), "floor_divide_": (X, (POS,)),
        "pow_": (POS, (2.0,)), "clip_": (X, (-0.5, 0.5)),
        "scale_": (X, (2.0, 1.0)), "lerp_": (X, (Y, 0.3)),
        "erfinv_": (PROB - 0.5, ()), "logit_": (PROB, ()),
        "asin_": (PROB - 0.5, ()), "acos_": (PROB - 0.5, ()),
        "atanh_": (PROB - 0.5, ()), "acosh_": (POS + 1, ()),
        "gammainc_": (POS, (PROB,)), "gammaincc_": (POS, (PROB,)),
        "ldexp_": (X, (I1,)), "gcd_": (I1, (I2,)), "lcm_": (I1, (I2,)),
        "squeeze_": (X[None], ()), "unsqueeze_": (X, (1,)),
        "reshape_": (X, ([2, 6],)), "transpose_": (X, ([1, 0],)),
        "scatter_": (X, (np.array([2, 0]), np.ones((2, 4)))),
        "masked_fill_": (X, (MASK, -1.0)),
        "index_add_": (X, (np.array([0, 2]), 0, np.ones((2, 4)))),
        "index_put_": (X, ((np.array([0, 2]), np.array([1, 3])),
                           np.array([5.0, 6.0]))),
        "index_fill_": (X, (np.array([1]), 1, 4.0)),
        "masked_scatter_": (X, (MASK, r.randn(12))),
        "put_along_axis_": (X, (np.array([[0], [1], [3]]),
                                np.array([[1.0], [2.0], [3.0]]), 1)),
        "renorm_": (X, (2.0, 0, 1.0)), "cumsum_": (X, (1,)),
        "cumprod_": (X, (1,)), "fill_diagonal_": (X, (3.0,)),
        "fill_diagonal_tensor_": (X, (np.arange(3.0),)),
        "logical_and_": (MASK, (~MASK,)), "logical_or_": (MASK, (~MASK,)),
        "logical_xor_": (MASK, (~MASK,)), "logical_not_": (MASK, ()),
        "bitwise_and_": (I1, (I2,)), "bitwise_or_": (I1, (I2,)),
        "bitwise_xor_": (I1, (I2,)), "bitwise_not_": (I1, ()),
        "less_than_": (X, (Y,)), "less_equal_": (X, (Y,)),
        "greater_than_": (X, (Y,)), "greater_equal_": (X, (Y,)),
        "not_equal_": (X, (Y,)), "equal_": (X, (Y,)),
    })
    return extra, tail, inplace


def _seq_to(dev, v, dtype):
    import numpy as np
    import torch
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.array(v, copy=True))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(_seq_to(dev, e, dtype) for e in v)
    return v


def _seq_leaves(x):
    import torch
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _seq_leaves(e)]
    return [x] if isinstance(x, torch.Tensor) else []


def _seq_same(label, got, want, tol, bad):
    """Every tensor of ``got`` (the card) on the card and within ``tol``
    of the largest magnitude of ``want`` (the CPU); integers and bools
    equal. Returns the largest relative error."""
    import torch
    gl, wl = _seq_leaves(got), _seq_leaves(want)
    worst = 0.0
    if len(gl) != len(wl):
        bad[label] = f"{len(gl)} outputs, the CPU {len(wl)}"
        return worst
    for g, w in zip(gl, wl):
        if g.device.type != "cuda":
            bad[label] = f"an output on {g.device}"
            return worst
        g = g.detach().cpu()
        w = w.detach()
        if g.shape != w.shape or g.dtype != w.dtype:
            bad[label] = f"{tuple(g.shape)} {g.dtype} != {tuple(w.shape)} " \
                         f"{w.dtype}"
            return worst
        if w.is_floating_point() or w.is_complex():
            scale = float(w.abs().nan_to_num(0.0).max()) if w.numel() else 0
            diff = (g - w).abs()
            both_nan = torch.isnan(g) & torch.isnan(w)
            diff = torch.where(both_nan, torch.zeros_like(diff), diff)
            err = float(diff.max()) / max(scale, 1e-30) if w.numel() else 0
            if not math.isfinite(err) or err > tol:
                bad[label] = err
            worst = max(worst, err if math.isfinite(err) else float("inf"))
        elif not torch.equal(g, w):
            bad[label] = "integers differ"
    return worst


def _lex_sorted(t):
    """Complex values ordered by real part, then imaginary part (the
    eigenvalues' order is LAPACK's), on ``t``'s device."""
    import torch
    c = t.cpu()
    c = c[torch.sort(c.imag, stable=True).indices]
    return c[torch.sort(c.real, stable=True).indices].to(t.device)


def _seq_ops_parity(smi):
    """Every new op (``extra``, ``tail``, the in-place variants) in
    float64 on the card against the CPU: outputs on the card, within
    SEQ_OP_TOL of their max, integers equal; each in-place op returns its
    receiver, written. The random refills after one seed draw the CPU's
    values: the uniform bits equal."""
    import torch
    import paddle_tpu_torch as paddle
    extra, tail, inplace = _seq_op_cases()
    bad, worst = {}, {}
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name, (args, kw) in {**extra, **tail}.items():
        fn = getattr(paddle, name)
        want = fn(*_seq_to(cpu, list(args), torch.float64), **kw)
        got = fn(*_seq_to(cuda, list(args), torch.float64), **kw)
        if name == "eigvals":
            got, want = (_lex_sorted(t) for t in (got, want))
        worst[name] = _seq_same(name, got, want, SEQ_OP_TOL, bad)
    for name, (recv, args) in inplace.items():
        outs = []
        for dev in (cpu, cuda):
            x = _seq_to(dev, recv, torch.float64)
            y = getattr(paddle, name)(x, *_seq_to(dev, list(args),
                                                   torch.float64))
            if y is not x:
                bad[name] = "did not return its receiver"
            outs.append(x)
        worst[name] = _seq_same(name, outs[1], outs[0], SEQ_OP_TOL, bad)
    # (kwargs, bound): the uniform bits exactly; after log/tan the ops'
    # bound; after erfinv the functionals' (torch's two erfinv part in
    # the last place, which the tails magnify). geometric_'s ceil of a
    # log can step by one where the log parts in its last place: its bits
    # are uniform_'s, its values on the card only checked finite there
    refills = {"uniform_": ({"min": -2.0, "max": 3.0}, 0.0),
               "bernoulli_": ({"p": 0.3}, 0.0),
               "exponential_": ({"lam": 1.5}, SEQ_OP_TOL),
               "cauchy_": ({"loc": 0.5, "scale": 2.0}, SEQ_OP_TOL),
               "normal_": ({"mean": 0.5, "std": 2.0}, SEQ_FN_TOL),
               "log_normal_": ({"mean": 0.2, "std": 0.5}, SEQ_FN_TOL),
               "geometric_": ({"probs": 0.3}, None)}
    for name, (kw, tol) in refills.items():
        outs = []
        for dev in (cpu, cuda):
            paddle.seed(17)
            x = torch.zeros(256, 129, device=dev)
            getattr(paddle, name)(x, **kw)
            outs.append(x)
        if tol is None:
            if outs[1].device.type != "cuda" or not bool(
                    torch.isfinite(outs[1]).all()):
                bad[name] = "not finite on the card"
            continue
        worst[name] = _seq_same(name, outs[1], outs[0], tol, bad)
    emit({"phase": "seq", "check": "ops_card_vs_cpu_float64", "card": smi,
          "ops": len(worst), "worst": max(worst.values()),
          "worst_op": max(worst, key=worst.get)})
    if bad:
        raise RuntimeError(f"seq ops card vs CPU: {bad}")


def _seq_fn_cases():
    """(functional, [inputs: arrays or ("g", array) for a gradient], kw)
    from seeded numpy, for the card-vs-CPU check."""
    import numpy as np
    r = np.random.RandomState(1)
    N, C = 6, 5
    X, Y, Z = (r.randn(N, C) for _ in range(3))
    PROB = r.rand(N, C) * 0.9 + 0.05
    BIN = (r.rand(N, C) > 0.5).astype(np.float64)
    SIGN = np.where(r.rand(N) > 0.5, 1.0, -1.0)
    SIGN2 = np.where(r.rand(N, C) > 0.5, 1.0, -1.0)
    CLS = r.randint(0, C, (N,))

    def g(a):
        return ("g", a)

    red = ("mean", "sum", "none")
    cases = []
    for rd in red:
        cases += [
            ("soft_margin_loss", [g(X), SIGN2], {"reduction": rd}),
            ("poisson_nll_loss", [g(X), r.poisson(2.0, (N, C)) * 1.0],
             {"reduction": rd}),
            ("gaussian_nll_loss", [g(X), Y, g(PROB)],
             {"reduction": rd, "full": True}),
            ("cosine_embedding_loss", [g(X), g(Y), SIGN],
             {"reduction": rd, "margin": 0.2}),
            ("triplet_margin_loss", [g(X), g(Y), g(Z)],
             {"reduction": rd, "swap": True}),
            ("triplet_margin_with_distance_loss", [g(X), g(Y), g(Z)],
             {"reduction": rd}),
            ("multi_label_soft_margin_loss", [g(X), BIN], {"reduction": rd}),
            ("multi_margin_loss", [g(X), CLS], {"reduction": rd}),
            ("sigmoid_focal_loss", [g(X), BIN], {"reduction": rd}),
            ("margin_ranking_loss", [g(X), g(Y), SIGN2], {"reduction": rd}),
            ("hinge_embedding_loss", [g(X), SIGN2], {"reduction": rd}),
            ("margin_cross_entropy", [g(np.tanh(X)), CLS],
             {"reduction": rd}),
            ("ctc_loss", [g(r.randn(9, 3, 6)), r.randint(1, 5, (3, 4)),
                          np.array([9, 7, 8]), np.array([4, 2, 0])],
             {"reduction": rd}),
            ("rnnt_loss", [g(r.randn(2, 5, 4, 4)), r.randint(1, 4, (2, 3)),
                           np.array([5, 3]), np.array([3, 2])],
             {"reduction": rd}),
        ]
    cases += [
        ("square_error_cost", [g(X), Y], {}),
        ("log_loss", [g(PROB), BIN], {}),
        ("dice_loss", [g(r.rand(N, 4, C)), r.randint(0, C, (N, 4, 1))], {}),
        ("npair_loss", [g(X), g(Y), np.array([0, 1, 2, 0, 1, 3])], {}),
        ("label_smooth", [g(np.eye(C)[CLS])], {"epsilon": 0.2}),
        ("temporal_shift", [g(r.randn(6, 8, 2, 3)), 3], {}),
        ("affine_grid", [g(r.randn(2, 2, 3)), [2, 3, 4, 5]], {}),
        ("grid_sample", [g(r.randn(2, 3, 4, 5)),
                         g(r.rand(2, 3, 6, 2) * 2.4 - 1.2)], {}),
        ("grid_sample", [g(r.randn(2, 3, 4, 5)),
                         r.rand(2, 3, 6, 2) * 2.4 - 1.2],
         {"mode": "nearest", "padding_mode": "border"}),
        ("sparse_attention", [g(r.randn(1, 2, 5, 4)) for _ in range(3)] + [
            np.array([[[0, 2, 3, 3, 5, 7], [0, 1, 2, 4, 6, 8]]], np.int32),
            np.array([[[0, 2, 1, 1, 4, 0, 3, 0], [0, 1, 0, 2, 3, 4, 1, 4]]],
                     np.int32)], {}),
        ("sequence_mask", [np.array([3, 0, 5])], {"maxlen": 6}),
        ("gather_tree", [r.randint(0, 9, (5, 2, 3)),
                         r.randint(0, 3, (5, 2, 3))], {}),
    ]
    return cases


def _seq_fn_run(dev, name, spec, kw, dtype, seed=None):
    import torch
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    ins = []
    for a in spec:
        if isinstance(a, tuple) and a[0] == "g":
            ins.append(_seq_to(dev, a[1], dtype).requires_grad_(True))
        else:
            ins.append(_seq_to(dev, a, dtype))
    if seed is not None:
        paddle.seed(seed)
    out = getattr(F, name)(*ins, **kw) if isinstance(name, str) \
        else name(*ins, **kw)
    outs = [o for o in _seq_leaves(out)]
    floats = [o for o in outs if o.is_floating_point() and o.requires_grad]
    grads = []
    if floats:
        gen = torch.Generator().manual_seed(7)
        total = sum((o * torch.randn(o.shape, generator=gen,
                                     dtype=o.dtype).to(dev)).sum()
                    for o in floats)
        total.backward()
        grads = [t.grad for t in ins if isinstance(t, torch.Tensor)
                 and t.requires_grad]
    return outs, grads


def _seq_functional_parity(smi):
    """Every new functional and loss layer on the card against the CPU, in
    float64 and (the losses) float32: outputs on the card within
    SEQ_FN_TOL of their max, gradients within SEQ_FN_GRAD_TOL;
    ``gumbel_softmax``, the loss layers and ``flash_attn_unpadded`` (three
    packings, causal or not) too."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cases = _seq_fn_cases()
    r = np.random.RandomState(2)
    for cu in ([0, 5, 12, 16], [0, 16], [0, 1, 2, 9, 10, 16]):
        for causal in (False, True):
            qkv = [("g", r.randn(16, 2, 8)) for _ in range(3)]
            m = int(np.max(np.diff(cu)))
            cases.append((
                lambda q, k, v, c, causal=causal, m=m:
                paddle.nn.functional.flash_attn_unpadded(
                    q, k, v, c, c, m, m, causal=causal)[0],
                qkv + [np.array(cu, np.int32)], {}))
    X, Y = r.randn(6, 5), r.randn(6, 5)
    sign = np.where(r.rand(6, 5) > 0.5, 1.0, -1.0)
    nn = paddle.nn
    layers = [
        (lambda a, b, c: nn.MarginRankingLoss(0.2)(a, b, c),
         [("g", X), ("g", Y), sign]),
        (lambda a, b: nn.SoftMarginLoss()(a, b), [("g", X), sign]),
        (lambda a, b: nn.HingeEmbeddingLoss(0.3)(a, b), [("g", X), sign]),
        (lambda a, b: nn.PoissonNLLLoss(full=True)(a, b),
         [("g", X), np.abs(Y)]),
        (lambda a, b, c: nn.GaussianNLLLoss()(a, b, c),
         [("g", X), Y, ("g", np.abs(Y) + 0.1)]),
        (lambda a, b, c: nn.CosineEmbeddingLoss(0.1)(a, b, c),
         [("g", X), ("g", Y), sign[:, 0]]),
        (lambda a, b, c: nn.TripletMarginLoss()(a, b, c),
         [("g", X), ("g", Y), ("g", r.randn(6, 5))]),
        (lambda a, b, c: nn.TripletMarginWithDistanceLoss()(a, b, c),
         [("g", X), ("g", Y), ("g", r.randn(6, 5))]),
        (lambda a, b: nn.MultiLabelSoftMarginLoss()(a, b),
         [("g", X), (sign > 0) * 1.0]),
        (lambda a, b: nn.MultiMarginLoss(p=2)(a, b),
         [("g", X), r.randint(0, 5, 6)]),
        (lambda a, b, c, d: nn.CTCLoss()(a, b, c, d),
         [("g", r.randn(9, 3, 6)), r.randint(1, 5, (3, 4)),
          np.array([9, 7, 8]), np.array([4, 2, 1])]),
    ]
    cases += [(f, s, {}) for f, s in layers]
    bad, worst, n = {}, 0.0, 0
    for i, (name, spec, kw) in enumerate(cases):
        label = name if isinstance(name, str) else f"case{i}"
        for dtype in (torch.float64, torch.float32):
            if dtype == torch.float32 and isinstance(name, str) and \
                    not name.endswith("loss"):
                continue
            want, wg = _seq_fn_run(cpu, name, spec, kw, dtype)
            got, gg = _seq_fn_run(cuda, name, spec, kw, dtype)
            tag = f"{label}:{str(dtype)[6:]}"
            worst = max(worst, _seq_same(tag, got, want, SEQ_FN_TOL, bad))
            _seq_same(tag + ":grad", gg, wg, SEQ_FN_GRAD_TOL, bad)
            n += 1
    for hard in (False, True):
        outs = [_seq_fn_run(dev, "gumbel_softmax", [("g", X)],
                            {"hard": hard}, torch.float64, seed=5)
                for dev in (cpu, cuda)]
        _seq_same(f"gumbel_softmax:{hard}", outs[1][0], outs[0][0],
                  SEQ_FN_TOL, bad)
        n += 1
    emit({"phase": "seq", "check": "functionals_card_vs_cpu", "card": smi,
          "cases": n, "worst": worst})
    if bad:
        raise RuntimeError(f"seq functionals card vs CPU: {bad}")


def _seq_optim_parity(smi):
    """Adagrad, RMSProp (centered, momentum), Adadelta, Adamax, Lamb: 3
    steps each on a small Layer in float64, card against CPU, parameters
    within SEQ_OPT_TOL of their max; LBFGS with its closure (3 steps, the
    strong-Wolfe line search)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    r = np.random.RandomState(3)
    xs, ys = r.randn(16, 6), r.randn(16, 2)
    opts = [("Adagrad", {"learning_rate": 0.1}),
            ("RMSProp", {"learning_rate": 0.01, "momentum": 0.9,
                         "centered": True}),
            ("Adadelta", {"learning_rate": 1.0}),
            ("Adamax", {"learning_rate": 0.02}),
            ("Lamb", {"learning_rate": 0.01}),
            ("LBFGS", {"learning_rate": 1.0, "max_iter": 5,
                       "line_search_fn": "strong_wolfe"})]
    bad, worst = {}, {}
    for name, kw in opts:
        finals = []
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            paddle.seed(4)
            # LBFGS on least squares: its float32 curvature history
            # magnifies summation-order differences on a non-convex net
            net = paddle.nn.Linear(6, 2) if name == "LBFGS" else \
                paddle.nn.Sequential(paddle.nn.Linear(6, 8),
                                     paddle.nn.Tanh(),
                                     paddle.nn.Linear(8, 2))
            net = net.to(dtype=torch.float64)
            opt = getattr(paddle.optimizer, name)(
                parameters=net.parameters(), **kw)
            x = paddle.to_tensor(xs, dtype="float64")
            y = paddle.to_tensor(ys, dtype="float64")

            def closure():
                opt.clear_grad()
                loss = ((net(x) - y) ** 2).mean()
                loss.backward()
                return loss

            for _ in range(3):
                if name == "LBFGS":
                    opt.step(closure)
                else:
                    closure()
                    opt.step()
                    opt.clear_grad()
            finals.append([p.detach().cpu() for p in net.parameters()])
        worst[name] = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(finals[1], finals[0]))
        if worst[name] > SEQ_OPT_TOL:
            bad[name] = worst[name]
    paddle.set_device("gpu:0")
    emit({"phase": "seq", "check": "optimizers_card_vs_cpu_float64",
          "card": smi, "param_err_over_max": worst})
    if bad:
        raise RuntimeError(f"seq optimizers card vs CPU: {bad}")


def _seq_autograd_parity(smi):
    """``jacobian``, ``hessian``, ``jvp``, ``vjp`` (and ``batch_axis=0``)
    in float64 on the card against the CPU: within SEQ_AD_TOL of their
    max, on the card."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import autograd as A
    r = np.random.RandomState(4)
    x, y, w = r.randn(3), r.randn(3, 2), r.randn(3, 4)
    xb, yb, v4 = r.randn(5, 3), r.randn(5, 3), r.randn(4)

    def calls(dev):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        W = t(w)
        f1 = lambda a: paddle.tanh(paddle.matmul(a, W)) * 2.0 + a.sum()  # noqa
        f2 = lambda a, b: paddle.matmul(paddle.sin(a), b)  # noqa: E731
        s1 = lambda a: (paddle.tanh(paddle.matmul(a, W)) ** 2).sum()  # noqa
        fb = lambda a, b: paddle.tanh(a * b) + a  # noqa: E731
        sb = lambda a: (paddle.sin(a) * a).sum()  # noqa: E731
        return [A.jacobian(f1, t(x)), A.jacobian(f2, (t(x), t(y))),
                A.jacobian(fb, (t(xb), t(yb)), batch_axis=0),
                A.hessian(s1, t(x)), A.hessian(sb, t(xb), batch_axis=0),
                A.jvp(f1, t(x), t(x)), A.vjp(f1, t(x), t(v4)),
                A.Hessian(s1, t(x))[:], A.Jacobian(f2, (t(x), t(y)))[:]]

    bad = {}
    want, got = calls("cpu"), calls("cuda")
    errs = [_seq_same(f"autograd{i}", g, w_, SEQ_AD_TOL, bad)
            for i, (g, w_) in enumerate(zip(got, want))]
    emit({"phase": "seq", "check": "autograd_functional_card_vs_cpu",
          "card": smi, "calls": len(errs), "worst": max(errs)})
    if bad:
        raise RuntimeError(f"seq autograd.functional card vs CPU: {bad}")


def phase_seq(smi):
    """Transformer base (WMT14 en-de, PaddleNLP's recipe) and the PTB
    "medium" LSTM LM trained on the card through the port's layers, fp32
    eager and O1 bf16, SEQ_STEPS steps each; the card against the CPU in
    float64 for both models at 2 layers (and GRU, SimpleRNN tanh/relu, a
    time-major bidirectional LSTM), every new op, functional and loss
    layer, the six optimizers and ``autograd.functional``. No kernel of
    the port is on this path."""
    rows = [_seq_leg(smi, m, amp) for m in ("transformer_base", "ptb_lstm")
            for amp in (None, "O1")]
    _seq_cpu_parity(smi)
    _seq_ops_parity(smi)
    _seq_functional_parity(smi)
    _seq_optim_parity(smi)
    _seq_autograd_parity(smi)
    return rows


# ------------------------------------------------------------- incubate
#: FusedMultiTransformer at GPT-3 345M's widths (BASELINE.json config 2,
#: PaddleFleetX's gpt 345M: E 1024, 16 heads of 64, FF 4096, 24 pre-LN
#: layers, gelu) under a 50,304-row word embedding, 1,024 learned
#: positions, a final LayerNorm and the tied output projection: the user
#: code of a Paddle generation script around the fused stack
FMT = dict(E=1024, heads=16, ffn=4096, layers=24, vocab=50304, pos=1024)
#: 8 rows of distinct seeded 128-token prompts in a 1,024-row cache, then
#: 64 greedy tokens: the prefill's and 63 one-token decode steps
FMT_B, FMT_PROMPT, FMT_NEW, FMT_SMAX = 8, 128, 64, 1024
#: the GQA leg: 2 layers over 4 KV heads
FMT_GQA_LAYERS, FMT_GQA_KV = 2, 4
#: the functionals' card-against-CPU checks in float64 (the seq phase's
#: functional bound: their scores or norms are float32, as the
#: reference's)
FMT_FN_TOL = SEQ_FN_TOL


def _fmt_model(layers, kv, dtype):
    """The generation model around ``incubate.nn.FusedMultiTransformer``
    on the card, from a seed (embeddings Normal(0, 0.02))."""
    import paddle_tpu_torch as paddle
    nn = paddle.nn
    init = nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))

    class FusedLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(FMT["vocab"], FMT["E"], weight_attr=init)
            self.wpe = nn.Embedding(FMT["pos"], FMT["E"], weight_attr=init)
            self.stack = paddle.incubate.nn.FusedMultiTransformer(
                FMT["E"], FMT["heads"], FMT["ffn"], num_layers=layers,
                kv_num_heads=kv)
            self.ln_f = nn.LayerNorm(FMT["E"])

        def embed(self, ids, start):
            pos = paddle.arange(start, start + ids.shape[1])
            return self.wte(ids) + self.wpe(pos)[None]

        def logits(self, h):
            return paddle.matmul(self.ln_f(h), self.wte.weight,
                                 transpose_y=True)

    paddle.set_device("gpu:0")
    paddle.seed(23)
    return FusedLM().to(dtype=dtype).eval()


def _fmt_prompts():
    import torch
    gen = torch.Generator().manual_seed(29)
    return torch.randint(0, FMT["vocab"], (FMT_B, FMT_PROMPT),
                         generator=gen).cuda()


def _fmt_generate(model, prompts, decode_attention):
    """Greedy generation: the prompts' prefill at ``time_step`` 0, then
    FMT_NEW - 1 one-token steps, each writing the cache in place. Returns
    the tokens ``[B, FMT_NEW]``, the first decode step's logits (float32),
    the decode steps' seconds and their ``decode`` launches."""
    import torch
    from paddle_tpu_torch import kernels
    st = model.stack
    st.decode_attention = decode_attention
    B, P = prompts.shape
    cache = torch.zeros(st.num_layers, 2, B, FMT_SMAX, st.kv_num_heads,
                        st.head_dim, dtype=st.qkv_weight.dtype,
                        device="cuda")
    with torch.no_grad():
        h, cache = st(model.embed(prompts, 0), caches=cache, time_step=0)
        tok = model.logits(h[:, -1]).argmax(-1)
        toks, first = [tok], None
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for t in range(P, P + FMT_NEW - 1):
            h, cache = st(model.embed(tok[:, None], t), caches=cache,
                          time_step=t)
            logits = model.logits(h[:, -1])
            if first is None:
                first = logits.float()
            tok = logits.argmax(-1)
            toks.append(tok)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernels.LAUNCHES["decode"]
    return torch.stack(toks, 1).cpu(), first, secs, launches


def _fmt_leg(smi, label, model, dtype_name):
    """One model through the kernels, then its plain path: launches
    exactly layers x decode steps (0 plain), fp32 streams equal, bf16
    first decode step's logits within the scaled bound (partings
    reported); decode ms a step and tok/s of each."""
    import torch
    prompts = _fmt_prompts()
    layers = model.stack.num_layers
    runs = {mode: _fmt_generate(model, prompts, mode)
            for mode in ("pallas", "jnp")}
    (tk, fk, sk, lk), (tp, fp, sp, lp) = runs["pallas"], runs["jnp"]
    steps = FMT_NEW - 1
    want = layers * steps
    row = {"phase": "incubate", "run": label, "card": smi,
           "dtype": dtype_name, "layers": layers,
           "kv_heads": model.stack.kv_num_heads, "rows": FMT_B,
           "prompt": FMT_PROMPT, "new_tokens": FMT_NEW, "s_max": FMT_SMAX,
           "decode_launches": lk, "decode_launches_plain": lp,
           "decode_launches_expected": want,
           "streams_equal": bool(torch.equal(tk, tp)),
           "first_parting": _first_parting(tk.tolist(), tp.tolist()),
           "decode_ms_per_step": 1e3 * sk / steps,
           "decode_ms_per_step_plain": 1e3 * sp / steps,
           "tok_s": FMT_B * steps / sk, "tok_s_plain": FMT_B * steps / sp}
    if dtype_name == "bfloat16":
        err, rel = _compare_scaled("fmt first decode logits", dtype_name,
                                   fk, fp)
        row.update(first_logits_err=err, first_logits_err_over_max=rel)
    else:
        row["first_logits_err"] = _compare(
            "fmt first decode logits", dtype_name, fk, fp)
    emit(row)
    if lk != want or lp:
        raise RuntimeError(f"incubate {label}: decode launches {lk} "
                           f"(plain {lp}), want {want} (plain 0)")
    if dtype_name == "float32" and not row["streams_equal"]:
        raise RuntimeError(f"incubate {label}: greedy streams part, "
                           f"kernels vs plain, at {row['first_parting']}")
    return row


def _fmt_decode_row(dev, gen):
    """The dense decode kernel alone at the stack's decode shapes (bf16):
    8 rows over a 1,024-row cache, 16 heads of 64 over 16 KV heads,
    lengths 129..192, NaN past each length; against its plain version
    (``TOL``, the same bits twice), its events and profiler times, the
    plain version's and SDPA's on the same cache, and its byte bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import decode
    H, D = FMT["heads"], FMT["E"] // FMT["heads"]
    dtype = torch.bfloat16
    lo, hi = FMT_PROMPT + 1, FMT_PROMPT + FMT_NEW
    lengths = [lo + (hi - lo) * i // (FMT_B - 1) for i in range(FMT_B)]
    k = torch.randn(FMT_B, FMT_SMAX, H, D, generator=gen, device=dev) \
        .to(dtype)
    v = torch.randn(FMT_B, FMT_SMAX, H, D, generator=gen, device=dev) \
        .to(dtype)
    for b, n in enumerate(lengths):
        k[b, n:] = v[b, n:] = float("nan")
    q = torch.randn(FMT_B, H, D, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    run = lambda: decode.decode_attention(q, k, v, lens)  # noqa: E731
    plain = lambda: decode.decode_attention_reference(  # noqa: E731
        q, k, v, lens)
    got = run()
    err = _compare("decode:fmt", "bfloat16", got, plain())
    if not torch.equal(got, run()):
        raise RuntimeError("decode:fmt: two launches differ")
    kd = torch.nan_to_num(k).transpose(1, 2).contiguous()
    vd = torch.nan_to_num(v).transpose(1, 2).contiguous()
    mask = (torch.arange(FMT_SMAX, device=dev)[None, :]
            < lens.long()[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None, :], kd, vd, attn_mask=mask)
    isz = 2
    kv_rows = sum(lengths)
    nbytes = 2 * kv_rows * H * D * isz + 2 * q.numel() * isz \
        + 4 * len(lengths)
    flops = 4 * kv_rows * H * D
    g = dict(decode.LAST_GRID)
    row = {"name": "decode:fmt", "dtype": "bfloat16", "max_abs_err": err,
           "tol": dict(zip(("atol", "rtol"), TOL["bfloat16"])),
           "lengths": lengths, "s_max": FMT_SMAX, "heads": [H, H, D],
           "split_len": g["split_len"], "n_split": g["n_split"],
           "grid_blocks": g["blocks"], "bitwise_repeatable": True,
           "ms": time_ms(run), "device_ms": device_ms(run),
           "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib), "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, "bfloat16"),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS["bfloat16"] else "operations"),
           "route": route("decode", "bfloat16")}
    row["x_bound_device"] = row["device_ms"] / row["bound_ms"]
    emit({"phase": "incubate", "check": "decode_row", **row})
    return row


def _fmt_qkvpacked(smi, dev, gen):
    """``incubate.nn.functional.flash_attn_qkvpacked`` (the port's one
    flash entry) at B=4, S=2048, 16 heads of 64, bf16, causal and not,
    against the plain version (``TOL``): one forward launch a call, in
    its mode's count."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels.flash_attention import _ref_attention
    IF = paddle.incubate.nn.functional
    qkv = torch.randn(4, 2048, 3, FMT["heads"], FMT["E"] // FMT["heads"],
                      generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    for causal in (False, True):
        kernels.reset_launches()
        got, _ = IF.flash_attn_qkvpacked(qkv, causal=causal,
                                         training=False)
        torch.cuda.synchronize()
        name = "flash" if causal else "flash:full"
        n = kernels.LAUNCHES[name]
        want = _ref_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal)
        out[name] = {"max_abs_err": _compare(f"qkvpacked {name}",
                                             "bfloat16", got, want),
                     "launches": n}
        if n != 1:
            raise RuntimeError(f"flash_attn_qkvpacked causal={causal}: "
                               f"{n} {name} launches, want 1")
    emit({"phase": "incubate", "check": "flash_attn_qkvpacked",
          "card": smi, "shape": [4, 2048, 3, FMT["heads"],
                                 FMT["E"] // FMT["heads"]], **out})
    return out


def _fmt_functionals(smi):
    """``masked_multihead_attention`` (8 rows, 16 heads of 64, a 1,024-row
    cache, rows at their own lengths), ``variable_length_memory_efficient_
    attention`` (8 x 16 heads x 128 x 64, causal, lengths apart) and
    ``fused_bias_dropout_residual_layer_norm`` (8 x 128 x 1024, p 0.1) in
    float64, the card against the CPU: outputs and gradients within
    FMT_FN_TOL of their max, the written caches too, and the dropout's
    uniform bits equal."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import random as prng
    IF = paddle.incubate.nn.functional
    H, D, E = FMT["heads"], FMT["E"] // FMT["heads"], FMT["E"]
    r = np.random.RandomState(31)
    x_mm = r.randn(FMT_B, 3 * H * D)
    cache = r.randn(2, FMT_B, H, FMT_SMAX, D)
    seq = FMT_PROMPT + 1 + 8 * np.arange(FMT_B)
    qkv_vl = r.randn(3, FMT_B, H, FMT_PROMPT, D)
    lens_vl = np.linspace(FMT_PROMPT // 2, FMT_PROMPT, FMT_B).astype(int)
    x_ln, res_ln, b_ln = (r.randn(FMT_B, FMT_PROMPT, E), r.randn(
        FMT_B, FMT_PROMPT, E), r.randn(E))
    s_ln, c_ln = 1 + 0.1 * r.randn(E), 0.1 * r.randn(E)

    def run(dev):
        paddle.set_device(dev)
        t = lambda a, g=True: paddle.to_tensor(  # noqa: E731
            np.array(a), dtype="float64", stop_gradient=not g)
        xm, c = t(x_mm), t(cache, False)
        om, c = IF.masked_multihead_attention(
            xm, c, sequence_lengths=paddle.to_tensor(seq))
        q, k, v = (t(a) for a in qkv_vl)
        ov = IF.variable_length_memory_efficient_attention(
            q, k, v, paddle.to_tensor(lens_vl), paddle.to_tensor(lens_vl),
            causal=True)
        xl, rl, bl, sl, cl = (t(a) for a in (x_ln, res_ln, b_ln, s_ln,
                                             c_ln))
        paddle.seed(37)
        ol = IF.fused_bias_dropout_residual_layer_norm(
            xl, rl, bl, sl, cl, dropout_rate=0.1, training=True)
        loss = sum((o * o).sum() for o in (om, ov, ol))
        loss.backward()
        outs = {"mmha": om, "mmha_cache": c, "varlen": ov, "fbdrln": ol}
        grads = {"mmha_x": xm.grad, "varlen_q": q.grad, "varlen_k": k.grad,
                 "varlen_v": v.grad, "fbdrln_x": xl.grad,
                 "fbdrln_res": rl.grad, "fbdrln_scale": sl.grad}
        return {n: a.detach().cpu() for n, a in {**outs, **grads}.items()}

    got, want = run("gpu:0"), run("cpu")
    paddle.set_device("gpu:0")
    errs = {n: float((got[n] - w).abs().max()) / max(
        float(w.abs().max()), 1e-30) for n, w in want.items()}
    key = prng.PRNGKey(37)
    shape = (FMT_B, FMT_PROMPT, E)
    bits_equal = bool(torch.equal(
        prng.uniform_shaped(key, shape, device="cuda").cpu().view(
            torch.int32),
        prng.uniform_shaped(key, shape, device="cpu").view(torch.int32)))
    emit({"phase": "incubate", "check": "functionals_card_vs_cpu_float64",
          "card": smi, "tol": FMT_FN_TOL, "err_over_max": errs,
          "dropout_uniform_bits_equal": bits_equal})
    bad = {n: e for n, e in errs.items() if not e <= FMT_FN_TOL}
    if bad or not bits_equal:
        raise RuntimeError(f"incubate functionals card vs CPU: {bad}, "
                           f"uniform bits equal: {bits_equal}")
    return errs


def phase_incubate(smi):
    """``incubate``: FusedMultiTransformer generation at GPT-3 345M's
    widths, 24 layers, every decode step's attention on the dense decode
    kernel (``csrc/decode.cu``), in fp32 and bf16, kernels against the
    stack's plain path (``decode_attention="jnp"``), and the GQA leg at 2
    layers; the kernel alone at the path's shapes; the packed-QKV flash
    entry; the functionals in float64 against the CPU. Returns the
    ``decode:fmt`` row with its main path's launches (the bf16 leg's)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    _free()
    model = _fmt_model(FMT["layers"], None, torch.float32)
    legs = {"fp32": _fmt_leg(smi, "fp32", model, "float32")}
    model.to(dtype=torch.bfloat16)
    legs["bf16"] = _fmt_leg(smi, "bf16", model, "bfloat16")
    del model
    _free()
    legs["gqa_fp32"] = _fmt_leg(
        smi, "gqa_fp32", _fmt_model(FMT_GQA_LAYERS, FMT_GQA_KV,
                                    torch.float32), "float32")
    _free()
    row = _fmt_decode_row(dev, gen)
    row["launches"] = legs["bf16"]["decode_launches"]
    row["launches_fp32"] = legs["fp32"]["decode_launches"]
    row["launches_gqa"] = legs["gqa_fp32"]["decode_launches"]
    _fmt_qkvpacked(smi, dev, gen)
    _fmt_functionals(smi)
    return row


# ---------------------------------------------------------------- ernie
#: ERNIE-ViL base (BASELINE.json config 4: ViT-B/16 at 224², a 12 x 768
#: text tower of 64 tokens, embedding 512), 64 image-text pairs (one
#: card's share of a data-parallel job), AdamW(0.9, 0.98, 1e-6, weight
#: decay 0.2) at 5e-4, the CLIP recipe (Radford et al. 2021) that
#: ERNIE-ViL 2.0's contrastive training follows
VIL_B, VIL_LR = 64, 5e-4
#: ERNIE 1.0 base (``ErnieConfig()``: 18,000 words, 12 x 768, 12 heads,
#: FFN 3072) fine-tuned by ``ErnieForSequenceClassification`` with
#: PaddleNLP's text-classification defaults: 32 x 128 tokens, dropout
#: 0.1, AdamW at 5e-5
ERNIE_B, ERNIE_S, ERNIE_LR = 32, 128, 5e-5
#: each leg: 2 warm-up steps, then 3 timed steps, on a fresh model
ERNIE_WARM, ERNIE_STEPS = 2, 3
#: card against CPU in float64: float64 end to end (the CLIP loss, the
#: patch embedding) to 1e-10 relative, gradients 1e-8 of their max. The
#: models compute in float32 inside (``_sdpa``'s scores, every LayerNorm,
#: the cross entropy, as the reference does), which sets a floor: at
#: least 7.2e-7 (the seq phase's Transformer reads up to that), and
#: otherwise twice the CPU's own distance from the same step with those
#: casts kept in float64 (card and CPU each round that far from the
#: all-float64 step, so they may differ by the sum)
ERNIE_F64_LOSS_RTOL, ERNIE_F64_GRAD_TOL = 1e-10, 1e-8
ERNIE_F32_FLOOR = 7.2e-7


def _ernie_batch(name, dev):
    """One seeded batch on ``dev``: 64 FakeData images through the
    vision training transforms and 64-token ids for ERNIE-ViL; 32 x 128
    ids, lengths 64..128 (the rest padded), and labels for ERNIE."""
    import numpy as np
    import paddle_tpu_torch as paddle
    r = np.random.RandomState(43)
    if name == "ernie_vil":
        (x, _), = list(_vision_loader(1, VIS_WORKERS, "thread", 43))
        ids = r.randint(0, 30522, (VIL_B, 64))
        return {"pixel_values": paddle.to_tensor(x, place=dev),
                "input_ids": paddle.to_tensor(ids, place=dev)}
    lens = r.randint(ERNIE_S // 2, ERNIE_S + 1, ERNIE_B)
    mask = (np.arange(ERNIE_S)[None, :] < lens[:, None]).astype(np.int64)
    ids = np.where(mask, r.randint(1, 18000, (ERNIE_B, ERNIE_S)), 0)
    return {"input_ids": paddle.to_tensor(ids, place=dev),
            "attention_mask": paddle.to_tensor(mask, place=dev),
            "labels": paddle.to_tensor(r.randint(0, 2, ERNIE_B),
                                       place=dev)}


def _ernie_trainer(name, dev, **cfg):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import ernie, ernie_vil
    paddle.set_device(dev)
    paddle.seed(47)
    if name == "ernie_vil":
        model = ernie_vil.ErnieViLModel(ernie_vil.ernie_vil_base(**cfg))
        opt = paddle.optimizer.AdamW(
            learning_rate=VIL_LR, beta1=0.9, beta2=0.98, epsilon=1e-6,
            weight_decay=0.2, parameters=model.parameters())
    else:
        model = ernie.ErnieForSequenceClassification(
            ernie.ErnieConfig(**cfg), num_classes=2)
        opt = paddle.optimizer.AdamW(learning_rate=ERNIE_LR,
                                     parameters=model.parameters())
    return model, opt


def _ernie_leg(smi, name, amp):
    """One model's training steps on the card, fp32 or O1 bf16: step ms
    (ERNIE_STEPS after ERNIE_WARM), pairs/s or tokens/s, peak memory, one
    profiled step's busy share; losses finite, no port kernel."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import kernels
    _free()
    model, opt = _ernie_trainer(name, "gpu:0")
    batch = _ernie_batch(name, "gpu:0")
    model.train()

    def step():
        with paddle.amp.auto_cast(enable=amp is not None, level="O1",
                                  dtype="bfloat16"):
            loss = model(**batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_s = [], []
    for _ in range(ERNIE_WARM + ERNIE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = sum(kernels.LAUNCHES[n] for n in kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = _seq_profile(step)
    mean_s = sum(step_s[ERNIE_WARM:]) / ERNIE_STEPS
    c = getattr(model, "ernie", model).config
    # ERNIE's dropout masks a step (ERNIE-ViL's towers have none): the
    # attention probabilities, the residual and FFN activations of each
    # layer, the embeddings and the pooled output
    masks = [] if name == "ernie_vil" else [
        ((ERNIE_B, c.num_attention_heads, ERNIE_S, ERNIE_S),
         c.num_hidden_layers),
        ((ERNIE_B, ERNIE_S, c.hidden_size), 2 * c.num_hidden_layers + 1),
        ((ERNIE_B, ERNIE_S, c.intermediate_size), c.num_hidden_layers),
        ((ERNIE_B, c.hidden_size), 1)]
    mask_ms = _seq_masks_ms(masks)
    work = ({"pairs_per_s": VIL_B / mean_s} if name == "ernie_vil" else
            {"tokens_per_s": ERNIE_B * ERNIE_S / mean_s,
             "sequences_per_s": ERNIE_B / mean_s})
    row = {"phase": "ernie", "run": f"{name}_{'o1_bf16' if amp else 'fp32'}",
           "card": smi, "params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "mean_step_ms": 1e3 * mean_s, **work, "peak_mem_gb": peak,
           "mask_ms_per_step": mask_ms,
           "mask_share": mask_ms / (1e3 * mean_s),
           "port_kernel_launches": launches, "profiled_step": prof}
    emit(row)
    del model, opt, batch
    _free()
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"ernie {row['run']}: losses {losses}")
    if launches:
        raise RuntimeError(f"ernie {row['run']}: {launches} kernel launches "
                           f"on a path that has no kernel of the port")
    return row


def _ernie_cpu_parity(smi):
    """The card against the CPU in float64: ERNIE-ViL base at 2 + 2
    layers (2 pairs at 224²) and ERNIE 1.0 base at 2 layers, both heads
    (2 x 128 tokens, a padding mask, dropout 0.1 on: the same masks), at
    the float32 floor (ERNIE_F32_FLOOR, or twice the CPU step's own
    distance from its all-float64 twin); the CLIP loss and the patch
    embedding alone, float64 end to end, at ERNIE_F64_LOSS_RTOL /
    ERNIE_F64_GRAD_TOL."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import ernie, ernie_vil
    r = np.random.RandomState(53)
    px = r.randn(2, 3, 224, 224)
    txt = r.randint(0, 30522, (2, 64))
    lens = np.array([128, 77])
    mask = (np.arange(128)[None, :] < lens[:, None]).astype(np.int64)
    ids = np.where(mask, r.randint(1, 18000, (2, 128)), 0)
    labels = np.where(r.rand(2, 128) < 0.15, r.randint(0, 18000, (2, 128)),
                      -100)
    feats = r.randn(2, 16, 512)
    small = dict(num_hidden_layers=2)

    def t(a, dev, **kw):
        return paddle.to_tensor(a, place=dev, **kw)

    # (name, model, loss, whether float32 inside sets a floor)
    cases = [
        ("ernie_vil_2_2", lambda: ernie_vil.ErnieViLModel(
            ernie_vil.ernie_vil_base(vision_layers=2, text_layers=2)),
         lambda m, d: m(t(px, d, dtype="float64"), t(txt, d)), True),
        ("ernie_classify_2", lambda: ernie.ErnieForSequenceClassification(
            ernie.ErnieConfig(**small)),
         lambda m, d: m(t(ids, d), attention_mask=t(mask, d),
                        labels=t(np.array([1, 0]), d)), True),
        ("ernie_masked_lm_2", lambda: ernie.ErnieForMaskedLM(
            ernie.ErnieConfig(**small)),
         lambda m, d: m(t(ids, d), attention_mask=t(mask, d),
                        labels=t(labels, d)), True),
        ("clip_loss", _clip_head,
         lambda m, d: m(t(feats[0], d, dtype="float64"),
                        t(feats[1], d, dtype="float64")), False),
        ("patch_embed", lambda: paddle.nn.Conv2D(3, 768, 16, stride=16,
                                                 bias_attr=False),
         lambda m, d: (m(t(px, d, dtype="float64")) ** 2).mean(), False),
    ]
    out, bad = {}, {}
    for name, make, run, floored in cases:
        lc, gc_, sd = _seq_step_on("cpu", make, run, 59)
        lg, gg, _ = _seq_step_on("gpu:0", make, run, 59, sd)
        if gc_.keys() != gg.keys():
            raise RuntimeError(f"ernie card vs CPU {name}: gradients of "
                               f"{sorted(gc_.keys() ^ gg.keys())} missing")
        loss_tol, grad_tol = ERNIE_F64_LOSS_RTOL, ERNIE_F64_GRAD_TOL
        floor = {}
        if floored:
            with _float64_inside():
                le64, ge64, _ = _seq_step_on("cpu", make, run, 59, sd)
            own = _seq_grad_errs(gc_, ge64)
            floor = {"cpu_loss_vs_float64": abs(lc - le64) / abs(le64),
                     "cpu_grad_vs_float64": max(own.values()),
                     "cpu_worst_tensor": max(own, key=own.get)}
            loss_tol = max(ERNIE_F32_FLOOR, 2 * floor["cpu_loss_vs_float64"])
            grad_tol = max(ERNIE_F32_FLOOR, 2 * floor["cpu_grad_vs_float64"])
        errs = _seq_grad_errs(gg, gc_)
        le = abs(lg - lc) / abs(lc)
        out[name] = {"loss_cpu": lc, "loss_rel_err": le,
                     "grad_err_over_max": max(errs.values()),
                     "worst_tensor": max(errs, key=errs.get),
                     "tensors": len(errs), "loss_tol": loss_tol,
                     "grad_tol": grad_tol, **floor}
        if le > loss_tol or max(errs.values()) > grad_tol:
            bad[name] = out[name]
    paddle.set_device("gpu:0")
    emit({"phase": "ernie", "check": "card_vs_cpu_float64", "card": smi,
          "models": out})
    if bad:
        raise RuntimeError(f"ernie card vs CPU: {bad}")
    return out


@contextlib.contextmanager
def _float64_inside():
    """``.float()`` of a float64 tensor keeps it float64 inside: the
    port's float32 casts (LayerNorm, ``_sdpa``'s scores, the cross
    entropy) become no-ops, for the all-float64 step that measures the
    floor those casts set."""
    import torch
    cast = torch.Tensor.float

    def keep64(self, *a, **kw):
        return self if self.dtype == torch.float64 else cast(self, *a, **kw)
    torch.Tensor.float = keep64
    try:
        yield
    finally:
        torch.Tensor.float = cast


def _clip_head():
    """A Layer whose forward is ERNIE-ViL's CLIP loss on given features,
    with its own 0-d ``logit_scale``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.ernie_vil import _clip_loss

    class ClipHead(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.logit_scale = self.create_parameter(
                [], default_initializer=paddle.nn.initializer.Constant(
                    2.659))
            self.proj = paddle.nn.Linear(512, 512, bias_attr=False)

        def forward(self, img, txt):
            return _clip_loss(self.proj(img), self.proj(txt),
                              self.logit_scale)
    return ClipHead()


def phase_ernie(smi):
    """``ernie``: ERNIE-ViL base and ERNIE 1.0 base training steps on the
    card, fp32 and O1 bf16; the card against the CPU in float64. No
    kernel of the port is on this path."""
    rows = [_ernie_leg(smi, m, amp) for m in ("ernie_vil", "ernie")
            for amp in (None, "O1")]
    _ernie_cpu_parity(smi)
    return rows


# ------------------------------------------------- hapi and the vision zoo
#: the Paddle quick start through paddle.Model: LeNet on MNIST-shaped
#: FakeData (1 x 28 x 28, 10 classes), batch 64, one epoch of 20 batches
HAPI_B, HAPI_BATCHES, HAPI_EVAL_BATCHES = 64, 20, 4
#: mobilenet_v2 through Model.fit at ImageNet's shape: warm-up and timed
#: steps (batch VIS_B = 64, 224 x 224, the vision phase's optimizer)
HAPI_ZOO_WARM, HAPI_ZOO_STEPS = 2, 5
#: MobileNetV2's published multiply-adds at 224 x 224, width 1.0
#: (Sandler et al. 2018, Table 3: 300 M)
MOBILENET_V2_MACS = 300e6
#: the other new families, one constructor each, one fp32 step at batch
#: 16 at its own input side
HAPI_FAMILIES = (("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224),
                 ("mobilenet_v1", 224), ("mobilenet_v3_large", 224),
                 ("shufflenet_v2_x1_0", 224), ("densenet121", 224),
                 ("googlenet", 224), ("inception_v3", 299))
HAPI_FAMILY_B = 16
#: card against CPU in float64: (model, input side); batch 2
HAPI_F64_MODELS = (("LeNet", 28), ("mobilenet_v3_small", 64),
                   ("shufflenet_v2_x0_25", 64), ("densenet121", 64))
HAPI_F64_LOSS_RTOL, HAPI_F64_GRAD_TOL = 1e-10, 1e-8
#: the step the port runs, its cross entropy cast to float32: loss and
#: gradients card against CPU within 4 float32 ulps (2^-23 relative) of
#: the loss and of each gradient's largest entry
HAPI_F32_CAST_TOL = 4 * 2 ** -23
#: a gradient under this share of the model's largest is zero in exact
#: arithmetic (a BatchNorm's bias that feeds a convolution and another
#: BatchNorm, whose mean subtraction cancels it): rounding noise on both
#: sides, held to the model's largest gradient
HAPI_ZERO_GRAD = 1e-6
#: vision.ops card against CPU in float64: values and gradients of their
#: largest magnitude
VOPS_TOL, VOPS_GRAD_TOL = 1e-10, 1e-8


def _hapi_losses(pkg_loss, outs, label):
    """Cross entropy of a model's output, GoogLeNet's three heads summed
    with its aux weight 0.3."""
    if isinstance(outs, tuple):
        main, *aux = outs
        return pkg_loss(main, label) + 0.3 * sum(pkg_loss(a, label)
                                                 for a in aux)
    return pkg_loss(outs, label)


def _hapi_quick_start(smi, tmp):
    """LeNet through ``Model.prepare``/``fit``/``evaluate``/``predict``
    with every callback; the callbacks' effects; ``save``/``load``
    resuming bit for bit (deterministic cuDNN for that leg)."""
    import json
    import os
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import datasets

    class Recorder(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.evals, self.ms = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - self._t0))
            self.losses.append(logs["loss"])

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    paddle.set_device("gpu:0")
    paddle.seed(0)
    train = datasets.FakeData(HAPI_BATCHES * HAPI_B, (1, 28, 28), 10)
    evald = datasets.FakeData(HAPI_EVAL_BATCHES * HAPI_B, (1, 28, 28), 10)
    model = paddle.Model(paddle.vision.models.LeNet())
    sched = paddle.optimizer.lr.StepDecay(0.001, step_size=10, gamma=0.5)
    model.prepare(paddle.optimizer.Adam(learning_rate=sched,
                                        parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    rec = Recorder()
    stop = paddle.callbacks.EarlyStopping(monitor="acc", patience=1)
    plateau = paddle.callbacks.ReduceLROnPlateau(monitor="loss", patience=0,
                                                 verbose=0)
    ckpt, vdl = os.path.join(tmp, "ckpt"), os.path.join(tmp, "vdl")
    _free()
    t0 = time.perf_counter()
    import warnings
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        model.fit(train, evald, batch_size=HAPI_B, epochs=1, verbose=0,
                  callbacks=[rec, stop,
                             paddle.callbacks.ModelCheckpoint(save_dir=ckpt),
                             paddle.callbacks.LRScheduler(by_step=True),
                             plateau, paddle.callbacks.VisualDL(vdl)])
    fit_s = time.perf_counter() - t0
    logs = model.evaluate(evald, batch_size=HAPI_B, verbose=0)
    # predict feeds every field of an item to the network: images alone
    images = paddle.io.TensorDataset([np.stack(
        [evald[i][0] for i in range(len(evald))])])
    pred = model.predict(images, batch_size=HAPI_B, stack_outputs=True)
    files = sorted(os.listdir(ckpt))
    scalars = [json.loads(ln) for ln in open(os.path.join(vdl,
                                                          "scalars.jsonl"))]
    losses = rec.losses
    falling = float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "losses_falling": falling,
        # train_batch and the LRScheduler callback each step the rate
        "rate_steps": sched.last_epoch,
        "rate_double_stepped": sched.last_epoch == 2 * HAPI_BATCHES,
        "checkpoint_files": files,
        "checkpoints_written": files == ["0.pdopt", "0.pdparams",
                                         "final.pdopt", "final.pdparams"],
        "scalars_written": [r["step"] for r in scalars]
        == list(range(HAPI_BATCHES)) and np.allclose(
            [r["loss"] for r in scalars], losses),
        "early_stopping_best": stop.best,
        "plateau_best": plateau.best,
        "eval_logged": len(rec.evals) == 1
        and set(rec.evals[0]) == {"loss", "acc"},
        "evaluate_logs": logs,
        "predict_shape": list(pred[0].shape),
        "predict_ok": pred[0].shape == (HAPI_EVAL_BATCHES * HAPI_B, 10)
        and bool(np.isfinite(pred[0]).all())}
    # save, two more batches; a fresh Model loaded gives them bit for bit
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        xs = [paddle.to_tensor(np.random.RandomState(s).randn(
            HAPI_B, 1, 28, 28).astype(np.float32)) for s in (1, 2)]
        ys = [paddle.to_tensor(np.random.RandomState(s).randint(
            0, 10, (HAPI_B, 1))) for s in (3, 4)]
        model.save(os.path.join(tmp, "resume"))
        want = [model.train_batch(x, y)[0] for x, y in zip(xs, ys)]
        paddle.seed(77)
        again = paddle.Model(paddle.vision.models.LeNet())
        sched2 = paddle.optimizer.lr.StepDecay(0.001, step_size=10,
                                               gamma=0.5)
        again.prepare(paddle.optimizer.Adam(learning_rate=sched2,
                                            parameters=again.parameters()),
                      paddle.nn.CrossEntropyLoss())
        again.load(os.path.join(tmp, "resume"))
        got = [again.train_batch(x, y)[0] for x, y in zip(xs, ys)]
        same_w = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), again.state_dict().values()))
    finally:
        torch.backends.cudnn.deterministic = det
    checks["resume_bit_for_bit"] = got == want and same_w
    try:
        model.save(os.path.join(tmp, "inference"), training=False)
    except ValueError as e:               # no input spec was given
        checks["save_inference_refused"] = str(e)[:60]
    line = {"phase": "hapi", "check": "quick_start", "card": smi,
            "model": "LeNet", "batch": HAPI_B, "batches": HAPI_BATCHES,
            "fit_s": fit_s, "step_ms": float(np.mean(rec.ms[2:])),
            "losses": [round(v, 4) for v in losses], **checks}
    emit(line)
    bad = [k for k in ("losses_finite", "losses_falling",
                       "rate_double_stepped", "checkpoints_written",
                       "scalars_written", "eval_logged", "predict_ok",
                       "resume_bit_for_bit") if not checks[k]]
    if bad:
        raise RuntimeError(f"hapi quick start: {bad} failed: {line}")


def _hapi_zoo_fit(smi):
    """``mobilenet_v2()`` at 224², batch 64, from FakeData through the
    vision training transforms, through ``Model.fit``: the vision phase's
    optimizer, 2 warm-up and 5 timed steps in fp32; ``paddle.flops``
    beside the published multiply-adds."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    paddle.seed(0)
    net = paddle.vision.models.mobilenet_v2()
    sched = paddle.optimizer.lr.PiecewiseDecay(
        [e * VIS_EPOCH_STEPS for e in (30, 60, 90)],
        [0.1, 0.01, 0.001, 0.0001])
    opt = paddle.optimizer.Momentum(
        learning_rate=sched, momentum=0.9, parameters=net.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    macs = paddle.flops(net, [1, 3, VIS_SIDE, VIS_SIDE])
    with contextlib.redirect_stdout(None):      # its table: 158 rows
        params = paddle.summary(net)
    ms, losses = [], []

    class Timer(paddle.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - self._t0))
            losses.append(logs["loss"])

    _free()
    steps = HAPI_ZOO_WARM + HAPI_ZOO_STEPS
    loader = _vision_loader(steps, VIS_WORKERS, "thread", 5)
    model.fit(loader, epochs=1, verbose=0, callbacks=[Timer()],
              num_iters=steps)
    timed_ms = float(np.mean(ms[HAPI_ZOO_WARM:]))
    row = {"phase": "hapi", "check": "zoo_fit", "card": smi,
           "model": "mobilenet_v2", "batch": VIS_B, "side": VIS_SIDE,
           "dtype": "float32", "steps": len(ms),
           "step_ms": [round(t, 3) for t in ms],
           "mean_step_ms": timed_ms, "images_per_s": VIS_B / timed_ms * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": [round(v, 4) for v in losses],
           "flops_macs": macs, "published_macs": MOBILENET_V2_MACS,
           "flops_over_published": macs / MOBILENET_V2_MACS,
           "parameters": params["total_params"],
           "train_tflops": 6 * macs * VIS_B / timed_ms / 1e9}
    emit(row)
    if len(ms) != steps or not np.isfinite(losses).all():
        raise RuntimeError(f"hapi zoo fit: {row}")
    return row


def _hapi_families(smi):
    """One fp32 training step of each new family (batch 16 at its own
    input side) through ``Model.train_batch``, after one warm-up step:
    a finite loss, step ms, peak memory."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    out = {}
    for name, side in HAPI_FAMILIES:
        _free()
        paddle.set_device("gpu:0")
        paddle.seed(1)
        net = getattr(paddle.vision.models, name)()
        ce = paddle.nn.CrossEntropyLoss()
        model = paddle.Model(net).prepare(
            paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                      parameters=net.parameters()),
            lambda outs, y: _hapi_losses(ce, outs, y))
        r = np.random.RandomState(2)
        x = paddle.to_tensor(r.randn(HAPI_FAMILY_B, 3, side, side).astype(
            np.float32))
        y = paddle.to_tensor(r.randint(0, 1000, (HAPI_FAMILY_B, 1)))
        model.train_batch(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_batch(x, y)[0]
        torch.cuda.synchronize()
        out[name] = {"side": side, "loss": loss,
                     "step_ms": 1e3 * (time.perf_counter() - t0),
                     "peak_mem_gb": torch.cuda.max_memory_allocated()
                     / 2 ** 30}
        del model, net, x, y
    emit({"phase": "hapi", "check": "families", "card": smi,
          "batch": HAPI_FAMILY_B, "dtype": "float32", "models": out})
    bad = {n: r for n, r in out.items() if not math.isfinite(r["loss"])}
    if bad:
        raise RuntimeError(f"hapi families: non-finite losses {bad}")


def _zoo_grad_errs(a, b):
    """Each gradient's largest difference over its largest entry (a
    gradient that is zero in exact arithmetic over the model's largest
    times ``HAPI_ZERO_GRAD``)."""
    top = max(float(w.abs().max()) for w in b.values())
    return {n: float((a[n] - w).abs().max()) / max(
        float(w.abs().max()), HAPI_ZERO_GRAD * top) for n, w in b.items()}


def zoo_card_vs_cpu(name, side, dev="gpu:0"):
    """One training step of ``name`` (batch 2, ``side``², 10 classes) in
    float64 on the card and on the CPU from the same state, held at
    ``HAPI_F64_LOSS_RTOL`` / ``HAPI_F64_GRAD_TOL`` with the cross
    entropy's float32 cast made a no-op (``_float64_inside``: float64
    end to end). The step with the cast, the one the port runs, is held
    at ``HAPI_F32_CAST_TOL``, float32 ulps: the cast rounds the two
    devices' logits apart by up to an ulp (LeNet's loss: 9.1e-8 on an
    H100, 1.4e-10 on the CPU), which no float64 bound can hold; each
    device's own distance from its all-float64 step is reported beside
    it. Returns the row; raises past a bound."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import models
    r = np.random.RandomState(61)
    x = r.randn(2, 1 if name == "LeNet" else 3, side, side)
    y = r.randint(0, 10, (2, 1))

    def make():
        return getattr(models, name)(num_classes=10)

    def run(m, d):
        ce = paddle.nn.CrossEntropyLoss()
        return _hapi_losses(ce, m(paddle.to_tensor(x, dtype="float64",
                                                  place=d)),
                            paddle.to_tensor(y, place=d))

    lc, gc_, sd = _seq_step_on("cpu", make, run, 67)
    lg, gg, _ = _seq_step_on(dev, make, run, 67, sd)
    with _float64_inside():
        lc64, gc64, _ = _seq_step_on("cpu", make, run, 67, sd)
        lg64, gg64, _ = _seq_step_on(dev, make, run, 67, sd)
    paddle.set_device("gpu:0")
    if not (gg.keys() == gc_.keys() == gg64.keys() == gc64.keys()):
        raise RuntimeError(f"{name} card vs CPU: gradients missing")
    f64 = _zoo_grad_errs(gg64, gc64)
    cast = _zoo_grad_errs(gg, gc_)
    row = {"model": name, "side": side, "loss_cpu": lc64,
           "loss_rel_err": abs(lg64 - lc64) / abs(lc64),
           "grad_err_over_max": max(f64.values()),
           "worst_tensor": max(f64, key=f64.get), "tensors": len(f64),
           "float32_cast": {
               "loss_rel_err": abs(lg - lc) / abs(lc),
               "grad_err_over_max": max(cast.values()),
               "cpu_loss_vs_float64": abs(lc - lc64) / abs(lc64),
               "card_loss_vs_float64": abs(lg - lg64) / abs(lg64),
               "cpu_grad_vs_float64": max(
                   _zoo_grad_errs(gc_, gc64).values()),
               "card_grad_vs_float64": max(
                   _zoo_grad_errs(gg, gg64).values()),
               "tol": HAPI_F32_CAST_TOL}}
    c32 = row["float32_cast"]
    if row["loss_rel_err"] > HAPI_F64_LOSS_RTOL \
            or row["grad_err_over_max"] > HAPI_F64_GRAD_TOL \
            or c32["loss_rel_err"] > HAPI_F32_CAST_TOL \
            or c32["grad_err_over_max"] > HAPI_F32_CAST_TOL:
        raise RuntimeError(f"{name} card vs CPU float64: {row}")
    return row


def _vops_cases():
    """``vision.ops`` calls on seeded numpy inputs: name -> (inputs, the
    inputs that take gradients, the call on a dict of tensors)."""
    import numpy as np
    from paddle_tpu_torch.vision import ops as V
    r = np.random.RandomState(71)

    def boxes(n, side=40.0, lo=2.0, hi=20.0):
        xy = r.rand(n, 2) * side
        return np.concatenate([xy, xy + r.rand(n, 2) * (hi - lo) + lo], -1)

    rois = np.concatenate([boxes(4, 6, 1, 5), [[0, 0, 20, 20],
                                               [9, 9, 12, 12]]])
    num = np.array([3, 3])
    scores = np.round(r.rand(40), 1)
    off = r.randn(2, 2 * 2 * 9, 4, 3) * 1.5
    return {
        "box_iou": ({"a": boxes(7), "b": boxes(5)}, (),
                    lambda t: V.box_iou(t["a"], t["b"])),
        "box_area": ({"b": boxes(5)}, ("b",), lambda t: V.box_area(t["b"])),
        "nms": ({"b": boxes(40), "s": scores}, (),
                lambda t: V.nms(t["b"], 0.3, t["s"], top_k=45)),
        "nms_multiclass": (
            {"b": boxes(40), "s": scores, "c": r.randint(0, 3, 40)}, (),
            lambda t: V.nms(t["b"], 0.3, t["s"], category_idxs=t["c"])),
        "roi_align": (
            {"x": r.randn(2, 3, 12, 10), "b": rois, "n": num}, ("x", "b"),
            lambda t: V.roi_align(t["x"], t["b"], t["n"], (3, 2), 0.5, 2,
                                  False)),
        "box_coder": (
            {"p": boxes(6), "v": r.rand(6, 4) + 0.1, "t": boxes(6)}, ("t",),
            lambda t: (V.box_coder(t["p"], t["v"], t["t"]),
                       V.box_coder(t["p"], t["v"], t["t"] * 0.01,
                                   "decode_center_size", False))),
        "distribute_fpn_proposals": (
            {"b": boxes(30, 400, 4, 600)}, (),
            lambda t: V.distribute_fpn_proposals(t["b"], 2, 5, 4, 224)),
        "roi_pool": ({"x": r.randn(2, 3, 8, 8), "b": rois, "n": num},
                     ("x",),
                     lambda t: V.roi_pool(t["x"], t["b"], t["n"], (3, 2))),
        "psroi_pool": ({"x": r.randn(2, 18, 8, 8), "b": rois, "n": num},
                       ("x",),
                       lambda t: V.psroi_pool(t["x"], t["b"], t["n"], 3,
                                              0.75)),
        "prior_box": ({"f": np.zeros((1, 3, 4, 5)),
                       "i": np.zeros((1, 3, 32, 40))}, (),
                      lambda t: V.prior_box(t["f"], t["i"], [6.0, 12.0],
                                            [10.0, 20.0], [2.0], flip=True,
                                            clip=True)),
        "yolo_box": ({"x": r.randn(2, 27, 5, 6),
                      "s": np.array([[320, 400], [256, 300]])}, ("x",),
                     lambda t: V.yolo_box(t["x"], t["s"],
                                          [10, 13, 16, 30, 33, 23], 4, 0.3)),
        "deform_conv2d": (
            {"x": r.randn(2, 4, 7, 6), "o": off, "w": r.randn(6, 2, 3, 3),
             "bias": r.randn(6), "m": r.rand(2, 2 * 9, 4, 3)},
            ("x", "o", "w", "bias", "m"),
            lambda t: V.deform_conv2d(t["x"], t["o"], t["w"], t["bias"],
                                      stride=2, padding=1,
                                      deformable_groups=2, groups=2,
                                      mask=t["m"])),
        "matrix_nms": (
            {"b": np.stack([boxes(12, 30, 4, 16) for _ in range(2)]),
             "s": r.rand(2, 4, 12)}, (),
            lambda t: V.matrix_nms(t["b"], t["s"], 0.05, nms_top_k=8,
                                   keep_top_k=20, use_gaussian=True,
                                   return_index=True)),
        "generate_proposals": (
            {"s": r.rand(2, 3, 4, 5), "d": r.randn(2, 12, 4, 5) * 0.5,
             "i": np.array([[60.0, 70.0], [55.0, 65.0]]),
             "a": boxes(60, 50, 4, 30).reshape(4, 5, 3, 4),
             "v": np.full((4, 5, 3, 4), 0.5)}, (),
            lambda t: V.generate_proposals(t["s"], t["d"], t["i"], t["a"],
                                           t["v"], 30, 10, 0.5,
                                           return_rois_num=True)),
    }


def vision_ops_card_vs_cpu(dev="cuda"):
    """Every ``vision.ops`` function in float64 on ``dev`` and on the CPU
    from the same inputs: values within ``VOPS_TOL`` of their largest
    magnitude, integer outputs (``nms``, ``matrix_nms`` indices, levels,
    counts) equal, and a seeded cotangent's gradients within
    ``VOPS_GRAD_TOL`` of their largest where the op is differentiable.
    Returns each function's errors; raises past a bound."""
    import numpy as np
    import torch
    out, bad = {}, {}
    for name, (inputs, diff, call) in _vops_cases().items():
        res = {}
        for d in ("cpu", dev):
            t = {k: torch.from_numpy(np.array(v)).to(d)
                 for k, v in inputs.items()}
            for k in diff:
                t[k].requires_grad_(True)
            outs = call(t)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if diff:
                g = torch.Generator().manual_seed(5)
                loss = sum((o * torch.randn(o.shape, generator=g,
                                            dtype=o.dtype).to(d)).sum()
                           for o in outs if o.requires_grad)
                loss.backward()
            res[d] = ([o.detach().cpu() for o in outs],
                      [t[k].grad.detach().cpu() for k in diff],
                      outs[0].device.type)
        errs, grads, equal = [], [], True
        for a, b in zip(res[dev][0], res["cpu"][0]):
            if a.is_floating_point():
                errs.append(float((a - b).abs().max()
                                  / b.abs().max().clamp(min=1e-30))
                            if b.numel() else 0.0)
            else:
                equal = equal and torch.equal(a, b)
        for a, b in zip(res[dev][1], res["cpu"][1]):
            grads.append(float((a - b).abs().max()
                               / b.abs().max().clamp(min=1e-30)))
        out[name] = {"err": max(errs, default=0.0), "integers_equal": equal,
                     "grad_err": max(grads, default=None),
                     "device": res[dev][2]}
        if not equal or out[name]["err"] > VOPS_TOL or (
                grads and max(grads) > VOPS_GRAD_TOL):
            bad[name] = out[name]
    if bad:
        raise RuntimeError(f"vision.ops card vs CPU: {bad}")
    return out


def phase_hapi_checks(smi):
    """``hapi``'s checks, run beside the kernel build (no kernel of the
    port, nothing timed that a report compares): the Paddle quick start
    through ``paddle.Model`` (LeNet, every callback; its fit's seconds
    contended by nvcc), and the card against the CPU in float64 (four
    models, every ``vision.ops`` function)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        _hapi_quick_start(smi, tmp)
    f64 = {name: zoo_card_vs_cpu(name, side)
           for name, side in HAPI_F64_MODELS}
    emit({"phase": "hapi", "check": "card_vs_cpu_float64", "card": smi,
          "models": f64})
    ops = vision_ops_card_vs_cpu()
    emit({"phase": "hapi", "check": "vision_ops_card_vs_cpu_float64",
          "card": smi, "tol": VOPS_TOL, "grad_tol": VOPS_GRAD_TOL,
          "ops": ops})


def phase_hapi(smi):
    """``hapi``'s timed legs, after ``ernie`` on an uncontended host:
    ``mobilenet_v2`` at full size through ``Model.fit`` and one step of
    each other new family. No kernel of the port is on this path."""
    zoo = _hapi_zoo_fit(smi)
    _hapi_families(smi)
    return zoo


# ---------------------------------------------------------------- training
# the deepest llama_7b cut whose whole train phase fits one 80 GB H100:
# at 16 layers the accumulated step's update runs out of memory
TRAIN_LAYERS = 15
# kernels vs plain versions through a whole forward+backward. fp32: loss
# to 1e-5 relative, each gradient to 1e-4 of its largest entry. Both run
# fp32 and differ only in summation order, which the backward carries
# through two layers of matmuls; the first H100 run read 8.5e-8 and at
# most 3.6e-6, so the bounds keep a 28x margin. bf16: the flash kernels
# round P per 64-key tile against a running max where the plain forward
# rounds the normalised P, so attention outputs differ by an ulp here and
# there, and two layers of bf16 matmuls carry that into the loss and every
# gradient: loss to 2e-2 relative, each gradient in BWD_TOL's form.
PARITY_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARITY_GRAD_TOL = 1e-4


def _train_ids(vocab, B, S, seed):
    import numpy as np
    import torch
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S))
    return torch.as_tensor(ids, device="cuda")


def _grad_ok(dtype_name, got, want):
    """fp32: max|err| <= PARITY_GRAD_TOL * max|ref|; bf16: BWD_TOL's form,
    elementwise."""
    err = (got - want).abs()
    size = want.abs().max()
    if dtype_name == "float32":
        return bool(err.max() <= PARITY_GRAD_TOL * size)
    atol, rtol = BWD_TOL[dtype_name]
    return bool((err <= atol * size + rtol * want.abs()).all())


#: train_parity's legs: (dtype, LlamaConfig knobs)
PARITY_LEGS = (
    ("float32", {}), ("bfloat16", {}),
    ("float32", {"attention_layout": "bhsd"}),
    ("bfloat16", {"attention_layout": "bhsd"}),
    ("float32", {"attention_layout": "bhsd", "fuse_rope": True}),
    ("bfloat16", {"attention_layout": "bhsd", "fuse_rope": True}),
    ("float32", {"recompute_policy": "dots"}),
)


def _flash_launches(layers, micro, knobs):
    """The flash launches a window of ``micro`` forward+backward passes
    implies: a forward and its recompute (``full`` and ``dots`` alike:
    the kernels launch outside the dispatcher, so ``dots`` recomputes
    attention too), one dK/dV and one dQ a layer, counted as ``name[rope]``
    under ``bhsd`` with ``fuse_rope``, which adds one ``rope_qk`` pre-pass
    a forward (recomputed ones included) and one a layer's backward."""
    rope = (knobs.get("attention_layout") == "bhsd"
            and bool(knobs.get("fuse_rope")))
    sfx = "[rope]" if rope else ""
    fwd = 2 if knobs.get("use_recompute", True) else 1
    return {"flash" + sfx: fwd * layers * micro,
            "flash_bwd_dkv" + sfx: layers * micro,
            "flash_bwd_dq" + sfx: layers * micro,
            **({PRE_PASS: (fwd + 1) * layers * micro} if rope else {})}


#: train_parity's Queue C 7 legs (tag of BWD_DIMS, dtype, knobs): the
#: backward at D = 256 (16 heads over 8 KV heads at the 7B hidden width)
#: and 80 in the three layouts and both types, and at 16, 40 and 96 in
#: the bshd and the fused-RoPE head-major layouts in float32
PARITY_DIMS_LEGS = tuple(
    (tag, dtype_name, knobs) for tag in ("d256", "d80")
    for dtype_name, knobs in PARITY_LEGS[:6]) + tuple(
    (tag, "float32", knobs) for tag in ("d16", "d40", "d96")
    for knobs in ({}, {"attention_layout": "bhsd", "fuse_rope": True}))


def phase_train_parity():
    """2 layers at llama_7b widths, B=1, S=500 (a tail past the 64-row
    tiles): kernels against plain versions through the model, in fp32
    (the CUDA-core kernels) and in bf16 (the tensor-core forward, dK/dV
    and dQ), in the bshd and head-major layouts, with RoPE fused into the
    kernels, and under ``recompute_policy="dots"``; then the Queue C 7
    legs (``PARITY_DIMS_LEGS``). Returns each Queue C 7 dim's backward and
    pre-pass launches over its legs, keyed ``(name, tag)``."""
    for dtype_name, knobs in PARITY_LEGS:
        _train_parity(dtype_name, knobs)
    out = {}
    for tag, dtype_name, knobs in PARITY_DIMS_LEGS:
        got = _train_parity(dtype_name, knobs, heads=BWD_DIMS[tag])
        for name, n in got.items():
            out[(name, tag)] = out.get((name, tag), 0) + n
    return out


def _train_parity(dtype_name, knobs, heads=None):
    """One leg: kernels against plain versions (``heads``: the geometry of
    a Queue C 7 leg, hidden h * d); returns the kernels' launches."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_hidden_layers=2, dtype=dtype_name, **knobs,
                   **(_heads_kw(heads) if heads else {}))
    model = LlamaForCausalLM(cfg, device="cuda", seed=2)
    ids = _train_ids(cfg.vocab_size, 1, 500, seed=4)
    runs = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            model.zero_grad(set_to_none=True)
            reset_launches()
            loss = model(ids, ids)
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: p.grad.float() for n, p in model.named_parameters()}
            runs[use] = (float(loss.detach()), grads, dict(LAUNCHES))
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    (lk, gk, nk), (lp, gp, npl) = runs[True], runs[False]
    errs = {n: ((gk[n] - gp[n]).abs().max()
                / gp[n].abs().max().clamp(min=1e-30)).item() for n in gp}
    bad = [n for n in gp if not _grad_ok(dtype_name, gk[n], gp[n])]
    loss_rtol = PARITY_LOSS_RTOL[dtype_name]
    want = _flash_launches(2, 1, knobs)
    launched = {n: c for n, c in nk.items() if c}
    emit({"phase": "train_parity", "layers": 2, "dtype": dtype_name,
          "knobs": knobs, "head_dim": cfg.head_dim,
          "heads": cfg.num_attention_heads,
          "kv_heads": cfg.num_key_value_heads, "B": 1, "S": 500,
          "loss_kernels": lk,
          "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
          "grad_err_over_max": errs,
          "tol": {"loss_rtol": loss_rtol,
                  "grad": (f"{PARITY_GRAD_TOL} x max|ref|"
                           if dtype_name == "float32" else
                           "BWD_TOL: {} x max|ref| + {} x |ref|".format(
                               *BWD_TOL[dtype_name]))},
          "launches_kernels": launched,
          "launches_plain": sum(npl.values())})
    if not abs(lk - lp) <= loss_rtol * abs(lp):
        raise RuntimeError(f"train parity {dtype_name} {knobs}: loss {lk} "
                           f"vs plain {lp}")
    if bad:
        raise RuntimeError(f"train parity {dtype_name} {knobs}: gradients "
                           f"off: { {n: errs[n] for n in bad} }")
    if launched != want or sum(npl.values()):
        raise RuntimeError(f"train parity {knobs} launches: kernels {nk}, "
                           f"expected {want}, plain {npl}")
    del model, runs, gk, gp
    return launched


#: the 15-layer train runs (label, LlamaConfig knobs); each checks the
#: launches of its own mode
TRAIN_RUNS = (("bshd", {}), ("bhsd", {"attention_layout": "bhsd"}),
              ("bhsd_fuse_rope", {"attention_layout": "bhsd",
                                  "fuse_rope": True}))
#: Queue C 7's training run: bhsd with fused RoPE at head dim 256 (16
#: heads over 8 KV heads at the 7B hidden width), beside the D = 128 run
#: above in the same call
TRAIN_D256 = ("bhsd_fuse_rope_d256", {"attention_layout": "bhsd",
                                      "fuse_rope": True})
#: recompute_policy="dots" keeps the seven projections a layer (q, k, v,
#: o at 64 MiB each, gate and up at 172 MiB, down at 64 MiB at B=4,
#: S=2048: ~0.66 GiB) where full recompute keeps the layer's input; but
#: its backward recomputes less at a time, and 13 layers peaked at 63.71
#: GiB where full peaks at 72.67 at 15 (PERF.md §5). Tried from 15 layers
#: down until a step fits.
DOTS_LAYERS = (15, 14, 13, 12, 11, 10)
#: bench.py's first and third configs (CONFIGS[0] and CONFIGS[2]) at its
#: own ~350M shape (bench.py:114-118): B=8, S=2048, accum_step(..., 4)
BENCH_SHAPE = dict(vocab_size=32000, hidden_size=1024,
                   intermediate_size=2816, num_hidden_layers=24,
                   num_attention_heads=8, num_key_value_heads=8,
                   max_position_embeddings=2048, use_recompute=False,
                   loss_chunk=512, dtype="bfloat16")
BENCH_RUNS = (("bhsd+hd128+noremat+accum4+chunk",
               {"attention_layout": "bhsd"}),
              ("bhsd+hd128+noremat+accum4+chunk+fuserope",
               {"attention_layout": "bhsd", "fuse_rope": True}))


def _trainer(cfg, seed=0):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, TrainStep(model, lambda loss, _lab: loss, opt)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _train_run(label, layers, knobs, profile=False, heads=None):
    """One training run: ``layers`` layers of llama_7b in bf16, B=4,
    S=2048, with ``knobs`` (and head geometry ``heads``): a warm-up step,
    three timed steps and one ``accum_step(accum=2)``, the launches of the
    counted window checked against what the code implies. Returns the
    window's launches."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import llama_7b
    cfg = llama_7b(num_hidden_layers=layers, dtype="bfloat16", **knobs,
                   **(_heads_kw(heads) if heads else {}))
    model, trainer = _trainer(cfg)
    B, S = TRAIN_B, TRAIN_S
    ids = _train_ids(cfg.vocab_size, B, S, seed=0)
    batch = ((ids, ids), (ids,))
    t0 = time.perf_counter()
    warm = float(trainer.step(*batch))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    accum_loss = float(trainer.accum_step(*batch, 2))
    torch.cuda.synchronize()
    accum_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    mean_s = sum(step_s) / len(step_s)
    want = _flash_launches(layers, 3 + 2, knobs)   # microbatches counted
    got = {n: c for n, c in launches.items() if c}
    emit({"phase": "train", "run": label, "knobs": knobs, "layers": layers,
          "head_dim": cfg.head_dim, "heads": cfg.num_attention_heads,
          "kv_heads": cfg.num_key_value_heads,
          "dtype": "bfloat16", "B": B, "S": S, "params": model.num_params(),
          "warmup_loss": warm, "warmup_s": warm_s, "losses": losses,
          "accum2_loss": accum_loss, "step_ms": [1e3 * t for t in step_s],
          "mean_step_ms": 1e3 * mean_s, "tokens_per_s": B * S / mean_s,
          "accum2_step_ms": 1e3 * accum_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "warmup_peak_mem_gb": warm_peak,
          "launches": got, "launches_expected": want})
    finite = all(map(math.isfinite, losses + [warm, accum_loss]))
    if not finite or not losses[2] < losses[0]:
        raise RuntimeError(f"train {label}: losses {warm}, {losses}, "
                           f"{accum_loss} not finite and falling")
    if got != want:
        raise RuntimeError(f"train {label} launches {launches}, expected "
                           f"{want}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(*batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e6
        _profile_line("train_profile", rows, wall, run=label,
                      busy_share_of_unprofiled_step=busy / mean_s)
    del model, trainer
    _free()
    return launches


def _train_dots():
    """``recompute_policy="dots"`` at the deepest of ``DOTS_LAYERS`` whose
    steps fit the card (each depth tried that runs out of memory is
    listed)."""
    import torch
    out_of_memory = []
    for layers in DOTS_LAYERS:
        try:
            _train_run(f"dots_{layers}", layers,
                       {"recompute_policy": "dots"})
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:     # the failed run's frames are gone: free its memory
            out_of_memory.append(layers)
            _free()
            continue
        emit({"phase": "train", "run": "dots_depth", "layers": layers,
              "out_of_memory_at": out_of_memory})
        return
    raise RuntimeError(f"train dots: no depth of {DOTS_LAYERS} fits")


def _train_bench(iters=5):
    """bench.py's first and third configs at its own 350M shape: B=8,
    S=2048, ``accum_step(..., 4)``, 2 warm-up steps then ``iters`` timed;
    step ms, tokens/s and 6 * params * tokens/s over the bf16 peak
    (989 TFLOP/s), as bench.py reckons MFU."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaConfig
    B, S = 8, 2048
    for label, knobs in BENCH_RUNS:
        cfg = LlamaConfig(**BENCH_SHAPE, **knobs)
        model, trainer = _trainer(cfg)
        ids = _train_ids(cfg.vocab_size, B, S, seed=0)
        batch = ((ids, ids), (ids,))
        for _ in range(2):
            float(trainer.accum_step(*batch, 4))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(trainer.accum_step(*batch, 4)) for _ in range(iters)]
        dt = (time.perf_counter() - t0) / iters
        n = model.num_params()
        tok_s = B * S / dt
        got = {k: c for k, c in LAUNCHES.items() if c}
        want = _flash_launches(cfg.num_hidden_layers, 4 * iters,
                               {**BENCH_SHAPE, **knobs})
        emit({"phase": "train", "run": "bench", "config": label,
              "params": n, "B": B, "S": S, "accum": 4, "step_ms": 1e3 * dt,
              "tokens_per_s": tok_s,
              "six_n_tokens_per_s_over_989_tflops": 6 * n * tok_s / 989e12,
              "losses": losses,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches": got, "launches_expected": want})
        if not all(map(math.isfinite, losses)) or got != want:
            raise RuntimeError(f"bench {label}: losses {losses}, launches "
                               f"{got}, expected {want}")
        del model, trainer
        _free()


def phase_train(profile=False, layers=TRAIN_LAYERS):
    """The training runs: ``layers`` (15) layers of llama_7b in bf16,
    B=4, S=2048, in bshd, bhsd and bhsd with fused RoPE (each its main
    path, counted from 0); ``dots`` at the deepest depth that fits; then
    bench.py's two head-major configs at its 350M shape. Returns the
    launches of each kernel's own run (the rope kernels' and the
    pre-pass's from the fused RoPE run); the D = 256 run's, keyed
    ``(name, "d256")``."""
    launches = {}
    for label, knobs in TRAIN_RUNS:
        got = _train_run(label, layers, knobs, profile and label == "bshd")
        if label == "bshd":
            launches.update({n: got[n] for n in ("flash",) + BWD})
        if knobs.get("fuse_rope"):
            launches.update({n: got[n] for n in (*ROPE, PRE_PASS)})
    label, knobs = TRAIN_D256
    got = _train_run(label, layers, knobs, heads=D256)
    launches.update({(n, "d256"): c for n, c in got.items() if c})
    _train_dots()
    _train_bench()
    return launches


#: the phases that launch no kernel of the port
NO_KERNEL_PHASES = {"vision", "seq", "ernie", "hapi"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernels,engine,serve,generate,server,"
                            "fleet,tp,llama13b,train_parity,train,"
                            "substrate,vision,seq,incubate,ernie,hapi",
                    help="comma list of phases after device+build")
    ap.add_argument("--profile", action="store_true",
                    help="repeat the four serve runs and one train "
                         "step under torch.profiler and report device time "
                         "by kernel")
    ap.add_argument("--train-layers", type=int, default=TRAIN_LAYERS,
                    help="decoder layers of the train phase (default "
                         f"{TRAIN_LAYERS}, the deepest that fits)")
    ap.add_argument("--capture-probe", action="store_true",
                    help="only try capturing one fused tick into a CUDA "
                         "graph and print the outcome (the engine phase "
                         "runs this in a child process)")
    args = ap.parse_args(argv)
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.capture_probe:
        _capture_probe()
        return 0
    phases = set(args.phases.split(","))
    seconds = {}                  # wall seconds of each phase, for reports

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = phase_device()
    # the kernels build (nvcc on every core) while the card runs the checks
    # of the substrate's GPT-3 345M legs: no kernel of the port, and the
    # ops the train phase runs next anyway (other phases there load
    # libraries whose device memory the 15-layer train step cannot spare:
    # it ran out of memory after the seq checks); their steps are timed
    # after the build. hapi's checks follow them there. Phases that launch no kernel of the port alone
    # (``--phases seq``) skip the build.
    built = {}

    def build():
        if not phases - NO_KERNEL_PHASES:
            return
        try:
            timed("build", phase_build)
        except BaseException as e:  # re-raised in the main thread
            built["error"] = e

    build_thread = threading.Thread(target=build, name="kernel-build")
    build_thread.start()
    # one intra-op thread beside nvcc: the build alone takes ~200 s on
    # the card's 8 host cores, and every core the phases beside it hold
    # lengthens it (270-374 s with the GPT legs and hapi's float64 CPU
    # steps on the default pool)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if "substrate" in phases:
            timed("substrate_gpt", phase_substrate_gpt)
        # hapi's checks too (no port kernel, nothing timed): the card
        # idles for the rest of the build after the GPT legs
        if "hapi" in phases:
            timed("hapi_checks", phase_hapi_checks, smi)
    finally:
        build_thread.join()
        torch.set_num_threads(threads)
    if "error" in built:
        raise built["error"]
    # training next, on an emptied allocator: its 15 layers are the
    # deepest that fit the card, and the serving phases leave segments
    # reserved around live blocks that empty_cache cannot return, where
    # the same allocations can fail for fragmentation alone
    _free()
    train = (timed("train", phase_train, args.profile, args.train_layers)
             if "train" in phases else {})
    _free()
    sub_rows, sub_launches = {}, {}
    if "substrate" in phases:
        timed("substrate_steps", phase_substrate_steps)
        sub_rows, sub_launches = timed("substrate", phase_substrate)
    # the vision training path (no kernel of the port: conv and pooling
    # are cuDNN's, as XLA's are the JAX package's)
    if "vision" in phases:
        timed("vision", phase_vision, smi)
    # the sequence models and the long tail (no kernel of the port either)
    if "seq" in phases:
        timed("seq", phase_seq, smi)
    # the incubate package: FusedMultiTransformer generating through the
    # dense decode kernel (its second user path); then ERNIE and ERNIE-ViL
    # training (no kernel of the port)
    fmt_row = (timed("incubate", phase_incubate, smi)
               if "incubate" in phases else {})
    if "ernie" in phases:
        timed("ernie", phase_ernie, smi)
    # the high-level API (paddle.Model, metric, callbacks) training the
    # vision zoo, and vision.ops (no kernel of the port either)
    if "hapi" in phases:
        timed("hapi", phase_hapi, smi)
    rows = timed("kernels", phase_kernels) if "kernels" in phases else {}
    launches = {}
    if "engine" in phases:
        launches.update(timed("engine", phase_engine))
    if "fleet" in phases:
        timed("fleet_fp32", phase_fleet_fp32)
    if "tp" in phases:
        timed("tp", phase_tp)
    if phases & {"serve", "generate", "server", "fleet", "tp"}:
        # one llama_7b (32 layers, bf16, seed 0) for the three phases
        from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
        model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), device="cuda",
                                 seed=0)
        if "serve" in phases:
            launches.update(timed("serve", phase_serve, model, args.profile))
        if "generate" in phases:
            timed("generate", phase_generate, model)
        if "server" in phases:
            timed("server", phase_server, model)
        if "fleet" in phases:
            timed("fleet", _fleet_serve, model)
        if "tp" in phases:
            timed("tp_serve", phase_tp_serve, model, args.profile)
        del model
    # LLaMA-13B (26.0 GB of bf16 weights) once the 7B model is freed: the
    # two never live together
    _free()
    l13_rows, l13_launches = (timed("llama13b", phase_llama13b)
                              if "llama13b" in phases else ({}, {}))
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory", "check": "after_serving",
          "reserved_gb": torch.cuda.memory_reserved() / 2 ** 30,
          "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30})
    parity = (timed("train_parity", phase_train_parity)
              if "train_parity" in phases else {})
    emit({"phase": "timing", "seconds": seconds})
    kernels = []
    for name in REPLACES:
        row = rows.get((name, "bfloat16"), {})
        path = (train if name in BWD or name in ROPE or name == PRE_PASS
                else launches)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path.get(name, 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "tflops",
                                       "device_ms")},
            "math": route(name, "bfloat16")})
        # the quantized modes: launches on their main path (int8 pools and
        # weights: the quantized serve runs; the others: the engine
        # phase's engines)
        for mode in ((tuple(FUSED_QUANT_MODES) if name == "fused_decode_tick"
                      else QUANT_MODES) if name in QUANT_KERNELS else ()):
            row = rows.get((name, "bfloat16", mode), {})
            kernels.append({
                "name": f"{name}:{mode}", "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "mode": mode, "launches": launches.get((name, mode), 0),
                **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "base_ms",
                                           "device_ms")},
                "math": "cuda-core split-KV walk" + (
                    ", mma.sync GEMVs" + (
                        " from 8 KB int8 chunks (64 k rows x 128 columns), "
                        "A fragments built in registers"
                        if mode.endswith("w8") else "")
                    if name == "fused_decode_tick"
                    else ", " + QUANT_CHUNK_ROUTE["bfloat16"]
                    if name == "ragged_attention" else "")})
    # the three serving kernels at head dim 256 (Queue C 6): launches on
    # the engine phase's bf16 D = 256 leg, whose routes these rows time
    for name in D256_KERNELS:
        for mode in (None,) + ((tuple(FUSED_QUANT_MODES)
                                if name == "fused_decode_tick" else
                                QUANT_MODES) if name != "flash" else ()):
            key = (name, "bfloat16") + ((mode,) if mode else ()) + ("d256",)
            row = rows.get(key, {})
            kernels.append({
                "name": f"{name}{':' + mode if mode else ''}@d256",
                "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "head_dim": D256[2],
                **({"mode": mode} if mode else {}),
                "launches": launches.get(key[:1] + key[2:], 0),
                **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "base_ms",
                                           "device_ms")},
                "math": route(name, "bfloat16")})
    # Queue C 7: the serving kernels at each of DIMS (launches on the
    # engine phase's bf16 legs at those dims), the backward kernels and
    # the pre-pass at each of BWD_DIMS (launches on the train phase's
    # D = 256 run where it has them, else on the parity legs)
    bwd_path = {**parity, **{k: c for k, c in train.items()
                             if isinstance(k, tuple)}}
    dim_rows = [(name, mode, tag, heads, launches)
                for tag, heads in DIMS.items() for name in DIMS_KERNELS
                for mode in (None,) + (
                    tuple(FUSED_QUANT_MODES) if name == "fused_decode_tick"
                    else QUANT_MODES if name in QUANT_KERNELS else ())]
    dim_rows += [(name, None, tag, heads, bwd_path)
                 for tag, heads in BWD_DIMS.items()
                 for name in BWD + ("flash_bwd_dkv[rope]",
                                    "flash_bwd_dq[rope]", PRE_PASS)]
    for name, mode, tag, heads, path in dim_rows:
        m = (mode,) if mode else ()
        row = rows.get((name, "bfloat16") + m + (tag,), {})
        kernels.append({
            "name": f"{name}{':' + mode if mode else ''}@{tag}",
            "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "head_dim": heads.d,
            **({"mode": mode} if mode else {}),
            "launches": path.get((name,) + m + (tag,), 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "base_ms",
                                       "device_ms")},
            "math": route(name, "bfloat16")})
    # the flash kernels' non-causal mode (the substrate's F.flash_attention
    # with causal=False): launches on the non-causal user Layer's path
    for name in FULL:
        base = name.split(":")[0]
        row = sub_rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "mode": "full",
            "launches": sub_launches.get(name, 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "tflops",
                                       "device_ms")},
            "math": route(base, "bfloat16")})
    # float16 in the flash kernels: launches on the substrate's float16
    # user Layer legs (plain and rotary), times from the kernels phase
    for name in F16_ROWS:
        row = rows.get((name, F16), {})
        kernels.append({
            "name": f"{name}:f16", "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "dtype": F16,
            "launches": sub_launches.get(f"{name}:f16", 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "tflops",
                                       "device_ms")},
            "math": route(name, F16)})
    # dense decode's second user path: FusedMultiTransformer's decode
    # steps (launches: its bf16 24-layer kernel leg), timed at its shapes
    kernels.append({
        "name": "decode:fmt", "route": "cuda", "source": SOURCES["decode"],
        "replaces": REPLACES["decode"], "dtype": "bfloat16",
        "launches": fmt_row.get("launches", 0),
        **{k: fmt_row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "device_ms",
                                       "launches_fp32", "launches_gqa")},
        "math": route("decode", "bfloat16")})
    # LLaMA-13B's geometry (40 heads over 40 KV heads of 128, 13B widths):
    # launches on its 40-layer bf16 serve runs, times from its own rows
    for name in L13_KERNELS:
        row = l13_rows.get(name, {})
        kernels.append({
            "name": f"{name}@13b", "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "dtype": "bfloat16",
            "heads": H13.h, "kv_heads": H13.hkv, "head_dim": H13.d,
            "launches": l13_launches.get(name, 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "device_ms")},
            "math": route(name, "bfloat16")})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
