#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. Card: name and power limit, as ``nvidia-smi`` gives them.
  2. Build: every CUDA kernel of the port is compiled by ``nvcc``
     from ``src/repro_torch/csrc`` (one ``nvcc`` per source, started
     together) into ``src/repro_torch/_build``; the run fails if ptxas
     reports spill stores in an attention instantiation that bf16 data at
     Dh 128 runs (the flash one also runs bf16 Dh 80 and 96), in a Dh-32
     flash instantiation (both routes), in an f32 Dh-80/96 flash
     instantiation, or in any int8_matmul instantiation, and prints ptxas's
     notes that it serialized wgmma (C7515, C7520, ...) in int8_matmul;
     it fails on any spill store in an rg_lru entry (both routes).
  3. Kernel against plain version, at qwen3-14b's attention shapes (Hkv 8,
     G 5, Dh 128, block 16; 8 rows at ragged positions up to 1024 with
     scrambled tables and -1 tails): decode Tq = 1 and a prefill chunk
     Tq = 128; vanilla, clipped (alpha-resolved gamma), gated and int8
     pools; float32 at atol 2e-5 (the reference kernel's own) and bfloat16
     at atol 2e-2. Then device times of the kernel, its plain version and
     one PyTorch call computing the same attention
     (``F.scaled_dot_product_attention`` on the gathered, head-repeated
     K/V: a yardstick the port never calls), beside the bound (bytes of
     K/V visited / 3.35 TB/s, or flops / 989 TFLOP/s, the larger).
     A float32 query over a bfloat16 pool (the W8A8 tick without int8 KV)
     is held at the float32 tolerance. Further reads reach every route
     (bf16 tensor cores for Tq*G > 16, CUDA cores, split-KV for Tq*G <=
     16): decode rows of live lengths 1, 17, 255 and 1024 (across the
     split chunks), a row whose table is all -1 (exact zeros), window and
     softcap at Tq 1 and 128, int8 pools at both; OPT-125m's reads (8
     rows, Hq = Hkv = 12, Dh 64, max_len 2048; f32 queries over f32 and
     int8 pools; vanilla, clipped, gated; decode at live lengths up to
     2048, and Tq 128 and 256) at the float32 tolerance; gemma2-27b's
     reads (4 rows, 16 KV heads of 128 with 2 query heads each, bf16,
     softcap 50, max_len 4608; decode and Tq 128 at live lengths past 4096,
     with and without the 4096 window) and phi-3-vision's (8 rows of 32
     heads of 96, bf16, max_len 2048; decode and Tq 128) and phase 8's
     MoE models' (MOE_PAGED: granite-moe-1b-a400m's 8 rows of 8 KV heads
     of 64 with 2 query heads each, qwen2-moe-a2.7b's 16 of 128, bf16,
     max_len 1024; decode at LIVE lengths and Tq 128; vanilla, clipped,
     gated) at the bfloat16 tolerance, each MoE model's vanilla read timed
     beside SDPA and the bound; each line names the route and the number
     of KV splits. The tensor-core prefill read (Tq
     128, bf16 q; vanilla, clipped and gated over bf16 and int8 pools) is
     also held against the plain version (P in f32) within
     PAGED_TC_REL_RMS, and the plain version with P rounded to bf16 (the
     control: a kernel that dropped P's lo half) must land above it.
  3b. The W8A8 kernel against its plain version at every (M, K, N) of a
     layer's linears on the main path (decode M = 8 and the padded mixed
     tick M = 2048 over qwen3-14b's q/o, k/v, gate/up and down), M on both
     sides of the route boundary (16: mma.sync weight streaming; 17: TMA
     + wgmma), an N no tile divides (130, 5120, 1040) and two ragged
     shapes; static and dynamic activation ranges, x in float32 and in
     bfloat16; OPT-125m's linears (768x768, 768x3072, 3072x768) at M 8
     and 2048; phase 8's (MOE_LINEARS: granite-moe's q/o 1024x1024 and k/v
     1024x512, qwen2-moe's q/k/v/o 2048x2048 and shared experts'
     2048x5632 and 5632x2048) at M 8 and 2048, each also timed. The check
     is bitwise (max abs difference 0), and the
     pre-pass's codes are held bitwise against ``quantize_activations``
     on their own. Then device times at every tick shape of the kernel,
     its plain version and ``torch._int_mm`` (cuBLASLt, a yardstick the
     port never calls) on the same codes plus the f32 epilogue
     (``_int_mm`` needs M > 16, so decode is timed for it at M padded to
     32), and their sums over a layer's seven linears at M 8 and M 2048.
     Bound: max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s).
  3c. The flash-attention kernel against its plain version at qwen3-14b's
     attention shapes (B 1, Hq 40, Hkv 8, Dh 128, causal) at T 2048 (the
     evaluation's length) and 4096 (where the reference's CPU route turns
     to chunked attention): vanilla, clipped (alpha 4, gamma = -4/T),
     gated, clipped+gated; float32 at atol 3e-5 (the reference kernel's
     own) and bfloat16 at atol 2e-2; then a small set, in float32 and in
     bfloat16, with a window, a softcap, q_offset > 0 (scalar and per
     row), no causal mask and Dh 64/256, and a ragged T 1000 in bfloat16;
     then the dense cache's reads at qwen3-14b's heads over a row of 1024
     keys, vanilla, clipped (gamma = -4/1024) and gated, f32 and bf16:
     decode (8 rows, Tq 1) at per-row offsets DECODE_OFFSETS, a chunk (Tq
     256) at CHUNK_OFFSETS (two rows' last queries past Tk), and a prefill
     (Tq 512) at offset 0; then the paper models' shapes, f32 and bf16,
     vanilla, clipped and gated: Dh 32 (B 4, Hq = Hkv = 4, T 256) causal
     and not, Dh 32 ragged (T 1000, window 300), BERT-base's (8, 512,
     12/12, 64) without the causal mask and OPT-125m's (1, 2048, 12/12, 64)
     with it; Dh 80 and 96 (B 2, Hq 8, Hkv 2, T 256) on both routes, causal
     and not, vanilla, clipped and gated, and a window and a softcap at a
     ragged T 1000; the cache-free reads of phase 7's models at their
     shapes (``model_flash_shapes``: ViT-S/16 f32 (64, 197, 6/6, 64) and
     hubert-xlarge bf16 (2, 4096, 16/16, 80) without the causal mask,
     phi-3-vision bf16 (1, 2048, 32/32, 96), gemma2-27b bf16 (1, 4608,
     32/16, 128) with softcap 50, with and without the 4096 window, and
     phase 8's: granite-moe bf16 (1, 2048, 16/8, 64) and f32 (2, 1024, 16/8,
     64), its training read, and qwen2-moe bf16 (1, 2048, 16/16, 128), all
     causal, each also timed (MOE_FLASH_TIMED); each
     line names the route (bf16 Dh 32/64/80/96/128: tensor cores). Then device times at (1, 2048) bf16 of the kernel, its
     plain version and ``F.scaled_dot_product_attention(is_causal=True,
     enable_gqa=True)`` (vanilla only; a yardstick the port never calls),
     beside the bound (flops of the causally visible pairs / 989 TFLOP/s,
     or bytes of q, out and each row's visible K/V / 3.35 TB/s, the
     larger); and at the dense decode read (8, 1, 40/8, 128) over 1024 keys
     at DECODE_OFFSETS, vanilla and clipped, with SDPA on the same K/V
     (heads repeated, a mask of the visible keys), beside phase 3's paged
     decode read at the same live lengths. And at the paper models'
     shapes (PAPER_FLASH_TIMED: BERT-base's, OPT-125m's, and 4 heads of 32
     at (8, 512) with and without the causal mask), f32 (the CUDA-core
     route the f32 paper models run) and bf16, vanilla and clipped: the
     kernel, its plain version, SDPA (vanilla) and the bound; and, bf16,
     at hubert-xlarge's and phi-3-vision's reads (MODEL_FLASH_TIMED).
     Then bf16 Dh 256 (``phase_flash_dh256``, the CUDA-core route
     recurrentgemma-9b's evaluation takes): vanilla, clipped and gated,
     causal with window 2048 at (1, 2048, 16/1, 256) and window 300 at a
     ragged T 1000, against the plain version at the bf16 tolerance; the
     kernel, its plain version and SDPA timed at (1, 2048, 16/1, 256)
     beside the bound; the Dh-256 instantiations' ptxas spill stores
     printed (not gated).
  3d. The fake-quant kernel against its plain version, bitwise, at the
     evaluation's shapes (MLP activation (2048, 17408) bf16, residual
     (2048, 5120) f32, gate/up weight (5120, 17408) bf16) and ragged n
     777 / 1000; 4 and 8 bits; both forms (the TPU kernel's and the
     model sites' straight-through one); per-tensor and per-channel;
     inputs built to land exactly half-way between codes, and inputs
     holding NaN and infinities (NaN where the plain version gives NaN,
     all else bitwise). Then device
     times of the kernel, its plain version and
     ``torch.fake_quantize_per_tensor_affine`` (a yardstick for time only:
     it multiplies by 1/s), beside the bound (bytes / 3.35 TB/s).
  3e. ``kv_quant`` of 2^20 bf16 K and V tokens (Hkv 8, Dh 128) on the card
     and on the CPU: codes and scales bitwise equal (the scale divides by
     a device tensor; a multiplication by 1/127 would differ on the
     counted tokens).
  3f. The RG-LRU scan kernel against its plain version, bitwise (max abs
     difference 0), on the route ``kernels/rg_lru.py:plan`` gives each
     shape (printed with its plan): the serving prefill sub-step (B 8, T
     256, D 4096) and its smallest chunk (8, 32, 4096), a long one-shot
     (1, 4096, 4096), the evaluation's length (1, 2048, 4096), a T no ring
     tile divides (1, 1000, 4096) and T 1 (8, 1, 4096) on route 1 (TMA
     ring), a ragged D (3, 33, 777) on route 0 (direct loads), each
     without and with h0, and a state carried across two calls (T 9 then
     7 equals T 16). Then device times at (8, 256, 4096), (1, 4096, 4096),
     (1, 2048, 4096) and (8, 32, 4096) of the kernel and its plain version
     beside the bound (12 B T D bytes / 3.35 TB/s); no single PyTorch call
     computes a linear recurrence, so there is no library time.
  4. Serving: ``ContinuousBatcher(paged=True)`` at qwen3-14b's full width
     and QWEN_LAYERS (20 of its 40) layers in bfloat16 with random weights
     from a seed: 12 greedy requests (prompts of 32..512 tokens from a
     numpy seed, 32 new tokens each), batch 8, max_len 1024, token budget 256, on five engines one
     after another: vanilla, clipped softmax (alpha 4) and gated attention
     over an int8 KV pool, then W8A8 (``qconfig=QConfig()``): clipped
     softmax (alpha 4) over a bfloat16 pool (float32 queries) and gated
     attention over an int8 pool. Each must
     finish every request, pass ``audit()`` with no block leak, and
     launch the attention kernel once per layer per forward and, under
     W8A8, the int8 kernel 7 times per layer per forward. At one mixed
     prefill/decode tick the logits of the kernel path and of the plain
     path (``paged_backend="gather"``, and under W8A8 the int8 product's
     plain version) must agree within LOGIT_REL_RMS and LOGIT_MAX_ABS
     (W8A8: W8A8_LOGIT_REL_RMS); under W8A8 the tick through the gather
     read must give bitwise equal logits with the int8 kernel and with its
     plain version, and a W8A8 tick's logits must stay within
     W8A8_VS_FP_REL_RMS of the fp tick's on the same weights. Under W8A8
     every ``w_q8`` the engine reads must be K-major and the tree must
     hold one int8 copy of each weight; the mixed tick and the first
     all-decode tick are replayed once each under ``torch.profiler``
     (outside the counted run), which gives device time by kernel family
     (int8 GEMM with its pre-pass, paged read, the rest) and the device's
     idle share over the tick. Then, on the same weights, the dense cache
     (the paged engine freed first), on vanilla, clipped, gated and
     clipped-w8a8: ``generate`` on 4 prompts of 512 tokens, 32 new, greedy
     (fp engines: 32 forwards, one flash and no paged launch a layer), whose
     last decode step must agree with a prefill over the same tokens at
     the same max_len (gate (a)): logits within DENSE_LOGIT_REL_RMS, and
     every block, its input forced to the prefill's, within
     DENSE_LAYER_REL_RMS (the decode one position early and, clipped,
     gamma from the step's T must land above in some block); and
     ``ContinuousBatcher(paged=False)`` (batch 8, max_len 1024, budget
     256) over the 12 requests: every request done, one flash, no paged
     (and, W8A8, 7 int8) launches per layer and forward, its first mixed tick on
     the paged engine's tokens against the paged engine's tick (gate (b)):
     logits within DENSE_LOGIT_REL_RMS (W8A8: W8A8_LOGIT_REL_RMS), every
     block, its input forced to the paged tick's, within
     DENSE_LAYER_REL_RMS (the writes one slot late must land above).
     Greedy tokens of the dense engine against the paged engine's and
     generate's are printed, not held.
  5. Evaluation, the paper's protocol, at qwen3-14b's full width and
     QWEN_LAYERS layers in bfloat16 (random weights from seed 0, unrolled
     layers, as PTQ needs), for vanilla, clipped softmax (alpha 4) and gated
     attention, one model at a time: ``train.evaluate`` on 2 held-out
     ``SyntheticLM`` batches (vocab 151936, T 2048, batch 1) gives the FP
     perplexity, max inf-norm and average kurtosis; ``quant.calibrate``
     (``QConfig()``, 4 batches) then ``quant.evaluate_perplexity`` on the
     2 held-out batches gives the W8A8 fake-quant perplexity. Every value
     must be finite; the flash kernel must launch once per layer per
     forward and the fake-quant kernel once per site per W8A8 forward
     (sites counted on the CPU at a tiny width); in one FP forward each
     layer's flash output must agree with the kernel's plain version
     (``mha_flash_ref``, P in f32) on the same inputs within
     FLASH_LAYER_REL_RMS (and, in some layer, that plain version with P
     rounded to bf16 must land above it), and its logits with the same
     forward through
     that plain version within FLASH_VS_OWN_PLAIN_REL_RMS and through the
     model's plain attention (``dense_attention``, P rounded to bf16)
     within LOGIT_REL_RMS, and
     one W8A8 forward with only the fake-quant kernel swapped for its
     plain version must give bitwise equal logits.
  4b. Serving recurrentgemma-9b at full width and all 38 layers in
     bfloat16 (random weights from seed 0): ``ContinuousBatcher(paged=True)``
     with batch 8, max_len 4096 (so the ring holds the 2048-token window),
     block 16, token budget 256; 10 greedy requests of 32 new tokens,
     prompts of 32..3000 tokens from a numpy seed, three of them past
     2304 tokens; three engines one after another: vanilla, clipped softmax
     (alpha 4, so gamma = -4/2048 on the ring) and gated attention. Each
     must finish every request, pass ``audit()`` with no block leak, and
     launch the RG-LRU kernel once per Griffin layer (26) on every forward
     of T > 1 and never on a T = 1 forward. At the prefill sub-step where
     a row's last chunk starts past the window, the logits with the kernel
     and with its plain version swapped in must be bitwise equal, and
     that row's logits must agree with a cache-free ``model_apply`` over
     its whole prefix (the flash kernel, window 2048; for the clipped
     engine a static gamma = -4/2048, the ring's) within RG_LOGIT_REL_RMS;
     on the clipped engine the same sub-step with one fault put in (the
     ring emptied, the recurrent state or conv history lost, gamma from
     max_len) must land above that bound. On every engine the first
     local_attn layer's ring before that sub-step (ordered by pos_ids)
     must agree with the cache-free forward's post-RoPE keys at the same
     positions within RG_RING_REL_RMS, and the same ring rolled by one
     slot must land above it. On the vanilla engine that prefill
     sub-step, the prefill sub-step with the most live tokens and the
     decode sub-step with the most rows are replayed once each under
     torch.profiler (outside the counted run): device time by family
     (the RG-LRU scan's 26 kernels in prefill, none in decode),
     idle share, the rest's three largest kernels. On the vanilla
     engine's weights, ``generate`` (16 new tokens) on one prompt of 1024
     tokens (one-shot prefill through the shared-pos ring write) and one of
     3000 (chunked past the window): 26 RG-LRU launches on every forward of
     T > 1, none at T 1, no flash or paged launch, and gate (a) with the
     decode one position early and the recurrent state h lost as faults.
  4c. recurrentgemma-9b served in W8A8 at full width and all 38 layers
     (``phase_rg_w8a8``): ``ContinuousBatcher(paged=True,
     qconfig=QConfig())``, clipped softmax (alpha 4), batch 8, max_len
     4096, budget 256, phase 4b's 10 prompts (three past 2304 tokens), 16
     new tokens each, through ``phase_recurrent_serving`` (phase 9c's
     gates): every request done, no block leak, the RG-LRU kernel once per
     Griffin layer on every forward of T > 1 and never at T 1, the int8
     kernel the same number of times on every forward, no flash or paged
     launch; the longest prompt's last chunk (past the 2048-token window)
     against a cache-free W8A8 forward over its prefix (gamma at the
     ring's -4/2048) within RECURRENT_W8A8_ROW_REL_RMS, the row's recurrent
     state and ring reset to a fresh row's above it; that prefill sub-step
     and the fullest decode sub-step against the same sub-steps with the
     int8 products' plain version within W8A8_LOGIT_REL_RMS (bitwise
     printed), both traced under torch.profiler.
  5b. The paper's own models at their published widths, f32, random
     weights from seed 0. Evaluation by phase 5's protocol (2 FP batches,
     4 calibration batches, W8A8 on the 2) of BERT-base (masked LM, batch
     8 x T 512, non-causal) and OPT-125m (causal LM, batch 1 x T 2048) for
     vanilla, clipped softmax (alpha 4) and gated attention, with phase
     5's gates at f32 bounds (PAPER_LAYER_REL_RMS per layer,
     PAPER_LOGIT_REL_RMS for the logits). OPT-125m served by
     ``ContinuousBatcher`` (batch 8, max_len 2048, block 16, budget 256,
     ``opt_requests``: one row decodes up to position 2046, and ticks'
     padded tails run past the position table): paged fp vanilla, clipped,
     gated; paged W8A8 clipped (int8 pool); dense (``paged=False``)
     vanilla. Each must finish every request, leak no block, launch the
     paged kernel (dense: flash) once per layer per forward and, W8A8, the
     int8 kernel 6 times per layer per forward; at the first mixed tick
     and the first tick past the table, the live logits through the
     kernels must agree with the plain path's (OPT_TICK_REL_RMS; W8A8:
     OPT_W8A8_TICK_REL_RMS) and be finite, and two controls must land
     above that bound: the plain path with P rounded to bf16, and the
     tick one position early. These engines run through phase 4's
     ``phase_serving``, so the W8A8 one also passes phase 4's W8A8 checks
     at its mixed tick. Then the paper's mechanism: the
     W8A8 engine's calibration and int8 weights on OPT-125m and on the
     same weights with two fc1 channels amplified 300x (fc2 rows / 300,
     the fp function unchanged): W8A8 against fp logits of one cache-free
     8 x 512 forward; the injected model must read above the clean one by
     OUTLIER_MARGIN.
  5c. recurrentgemma-9b's evaluation (``rg_eval_cfg``: bf16, 38 layers,
     unrolled) by phase 5's protocol for vanilla, clipped (alpha 4) and
     gated: its 12 local_attn layers reach the flash kernel at bf16 Dh 256
     with window 2048 (the CUDA-core route), each held per layer against
     its plain version at FLASH_LAYER_REL_RMS; the RG-LRU kernel once per
     Griffin layer (26) on every forward.
  6. Training, through the hand-written flash-attention backward kernel
     (``csrc/flash_attention_bwd.cu``; the reference differentiates its
     plain attention with XLA, so no TPU kernel corresponds). (a) The
     forward kernel with the row statistics it saves for the backward
     (its output bitwise the plain forward call's; (m, Z) within
     STATS_REL_RMS of ``attention_stats_ref``, q in bf16 above), then the
     kernel on what the forward saved against ``attention_bwd_ref`` (the
     gradient as formulas, f32)
     at BWD_SHAPES (Dh 32 (8, 512, 4/4) causal and not, BERT-base's (8,
     512, 12/12, 64) non-causal, OPT-125m's (2, 2048, 12/12, 64) causal,
     GQA (1, 512, 8/2, 64), ViT-S/16's (64, 197, 6/6, 64) non-causal: a
     length no tile divides), vanilla, clipped (alpha 4) and gated: dq, dk,
     dv and dgate each within BWD_REL_RMS, the plain version with P and dS
     rounded to bf16 above it, two calls bitwise equal, and every clipped
     case with a share of unclipped entries. (b) BERT-base (masked LM, 8 x
     512) and OPT-125m (causal LM, 2 x 2048) trained at full width in f32
     from seed 0 through ``train.run_training`` for vanilla, clipped
     (alpha 4) and gated attention: step 1's loss and the whole gradient
     through the kernels against the plain attention path
     (``mha_flash_ref`` under autograd in the kernel's place) within
     STEP_GRAD_REL_RMS on weights whose q and k projections are sharpened
     (STEP_QK_SCALE: at random init every clipped probability clips; the
     gradient must reach every layer's k weights but STEP_DEAD_LAYERS'),
     the plain path with P in bf16 above the bound, and each attention
     leaf's gradient within STEP_ATTN_LEAF_REL and within
     STEP_ATTN_CONTROL_SHARE of that leaf's control; on a SyntheticLM
     chain over TRAIN_DATA_VOCAB token ids, 2 x TRAIN_HALF steps with
     one flash and one backward launch per layer and step, every loss
     finite and the last four steps' mean below the first four's; a
     checkpoint at TRAIN_HALF restored into a fresh run that must end
     bitwise equal to the uninterrupted one. Each run prints its median
     step time, trained tokens/s, peak memory, losses and its last
     evaluation's perplexity, max inf-norm and kurtosis; one vanilla step
     of each model is replayed under torch.profiler (device time of the
     flash backward, the flash forward and the rest; idle share). (c) Device times
     of the backward kernel, its plain version and torch autograd
     through ``F.scaled_dot_product_attention`` in f32 (vanilla; a
     yardstick the port never calls) beside the first design's time and the bound (10
     flops per visible pair and column in every variant; the route's:
     each f32 product three TF32 ones at 495 TFLOP/s; the f32 CUDA-core
     one at 67 TFLOP/s printed beside it); no time below its bound.
  7. Embeds inputs and sandwich norms at published widths and depths,
     random weights from seed 0; each sub-phase prints its wall.
     (a) ViT-S/16 (f32, 12 layers) over ``SeededEmbeds`` batches (64 x
     197 patches of 384, a class per position: the JAX package's
     ``frames`` batches are 24 wide): phase 5's protocol for vanilla,
     clipped (alpha 4) and gated at the paper models' gates, then phase
     6b's training (2 x TRAIN_HALF AdamW steps per method, the step-vs-plain gate,
     falling losses, a bitwise restart at step 8). (b) hubert-xlarge
     (bf16, 48 layers, 2 x 4096 frames of 512): phase 5's protocol,
     vanilla, at phase 5's bf16 gates. (c) phi-3-vision-4.2b (bf16, 32
     layers): one mixed forward (576 patch embeddings, then 1472 tokens)
     with each layer's flash output within FLASH_LAYER_REL_RMS of its
     plain version (the bf16-P control above); then
     ``ContinuousBatcher(paged=True)`` on 8 text prompts (batch 8, max_len
     2048) through phase 4's ``phase_serving``: its first mixed tick
     within LOGIT_REL_RMS of the plain path. (d) gemma2-27b (bf16, 46
     layers, local window 4096 and global layers alternating, softcaps
     50 / 30, sandwich norms): one cache-free forward at (1, 4608) held
     per layer as (c); then ``ContinuousBatcher(paged=True)`` (batch 4,
     max_len 4608, 400 blocks, budget 256) over six greedy requests (five
     prompts of 32..512 tokens, one of 4300 that wraps the local layers'
     ring), vanilla and clipped on one weight set, then gated: every
     request done, no block leak, one paged read per global layer per
     forward; the first mixed tick and the first tick past the window
     within LOGIT_REL_RMS of the plain path; at the latter, the long
     request's first local_attn ring (ordered by pos_ids) within
     RG_RING_REL_RMS of the cache-free forward's post-RoPE keys, the ring
     rolled one slot above; the vanilla engine's mixed and decode ticks
     traced (device time by family, the f32 head among the rest, idle
     share); peak memory printed.
  8. Mixture-of-Experts blocks (``repro_torch.nn.moe``) at published
     widths and depths, random weights from seed 0, unrolled layers, one
     model at a time (``phase_moe``). (a) The MoE layer alone, on the
     hidden states of a real evaluation forward (``phase_moe_layer``):
     every layer's claims dropped at the config's capacity, printed; on
     the first layer's input, dispatch at capacity factor E/k (no claim can
     drop) against the dense path on the same router outputs, dispatch at
     MOE_DROP_CF against ``dispatch_ref`` (a host loop replaying the
     slot-major claims, the dropped weights zeroed in the dense combine;
     the same number of drops), and a tick's worth of tokens (8 rows of
     256) with every other row dead against the live rows alone at the same
     capacity; each within MOE_LAYER_REL_RMS, each control above it (one
     slot's weight zeroed; the claims replayed token-major; the dead rows
     claiming). (b) granite-moe-1b-a400m (bf16, 24 layers, 32 experts,
     top-8): phase 5's evaluation for vanilla (with (a)), clipped (alpha 4)
     and gated, each attention layer held per layer at FLASH_LAYER_REL_RMS
     and the logits at MOE_LOGIT_REL_RMS;
     an fp and a W8A8 ``ContinuousBatcher(paged=True)`` on the vanilla
     weights (batch 8, max_len 1024, ``short_requests``' 12 requests at its
     vocabulary) through ``phase_serving``; then trained in f32
     (``phase_moe_train``: phase 6b's step-vs-plain gate at
     MOE_STEP_GRAD_REL_RMS / MOE_STEP_ATTN_LEAF_REL, MOE_TRAIN_STEPS AdamW
     steps at 2 x 1024, the loss falling, ``moe_lb`` and ``moe_z`` finite
     and printed). (c) qwen2-moe-a2.7b (bf16, 24 layers, 60 routed experts
     top-4 and 4 shared; 28.6 GB of weights): the evaluation, vanilla, with
     (a); an fp and a W8A8 engine (its shared experts through the int8
     kernel: 7 launches per layer and forward) on the same weights, each
     with its mixed and first decode tick traced: device time by family
     (``moe_annotations``: the router, the experts' batched products, the
     dispatch's index ops, the shared experts, the head; the paged reads
     and int8 GEMMs by name) and the idle share. Every end-to-end gate of a
     MoE model holds its second forward routed as the first one routed
     (``routing_taps``: a near-tie of the k-th and k+1-th router
     probabilities flips under another rounding, moves that token by a
     whole expert's share, and the moved residual flips later layers'
     choices: free, 29-58 % of the pairs flip), prints the (layer, token)
     pairs the two route to other experts when free, and has a fault
     control above its bound: the evaluation's logits every MoE layer at MOE_DROP_CF, the
     ticks every MoE layer at its least capacity ("MoE capacity 8"; the fp
     ticks also one position early). Peak memory is printed per engine.
  9. xlstm-1.3b (``phase_xlstm``) at its published width and depth (bf16,
     48 blocks, 7 mLSTM to 1 sLSTM, chunk 128; random weights from seed 0).
     (a) One mLSTM layer's cell (4 heads of 1024, T 512, f32): the
     chunkwise form against the recurrent oracle within MLSTM_REL_RMS (h
     and the final C, n, m), the halves without the state carried above
     it; then the sLSTM scan's eager kernels per step, counted in a
     torch.profiler trace. (b) Phase 5's evaluation (FP perplexity, max
     inf-norm, kurtosis, W8A8 perplexity) at XLSTM_EVAL_BATCH x
     XLSTM_EVAL_SEQ (the sLSTM runs one eager step a token), unrolled: no
     flash launch, the fake-quant kernel once per site. (c) fp and W8A8
     ``ContinuousBatcher(paged=True)`` engines on the same weights (batch
     8, max_len 1024, budget 256, ``short_requests``' 12 requests) through
     ``phase_recurrent_serving``: every request done, no block leak, no
     flash or paged launch, the int8 kernel the same number of times on
     every W8A8 forward; the longest prompt's last chunk against a
     cache-free forward over its prefix (fp XLSTM_ROW_REL_RMS, W8A8
     RECURRENT_W8A8_ROW_REL_RMS), the row's state reset above it; each
     W8A8 sub-step checked (prefill and decode) against the same sub-step
     with the int8 products' plain version within W8A8_LOGIT_REL_RMS
     (bitwise printed), and traced (device time by family: the int8 GEMMs,
     the mLSTM cells, the sLSTM scans, the rest; idle share); tokens/s.
  10. The kernels line (six kernels, the backward among them; the launch
     counts include phase 8's and phase 9's evaluations, engines and
     training, phase 4c's engine and phase 5c's evaluations), then the
     device line. Each phase from 3 on prints its start, in seconds into
     the run.

TF32 is switched off for matmuls and convolutions, so float32 compares
are full float32. Requires ``torch.cuda.is_available()``; exits non-zero
without a GPU or without the repository's ``src/``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12                # H100 SXM dense TF32 tensor-core peak
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Kernel path vs plain path at one mixed tick, 40 bf16 layers deep. Both are
# correct; they round in different places (the plain path scales q and casts
# the probabilities to bf16 before P.V, the kernel keeps both in f32), so each
# layer's attention output differs by about one bf16 ulp (2^-8 relative) and
# 40 bf16 residual updates carry it to the logits. The check is on the RMS
# of the difference relative to the RMS of the logits: a few ulp per layer
# keep it at the percent level, while a wrong read (a wrong block, mask or
# gamma) moves the logits by their own scale, a relative RMS near 1. The max
# over ~4e7 logits is an extreme value and is bounded loosely, at about 0.7
# of the logits' standard deviation (near 1.4 for these random weights).
LOGIT_REL_RMS = 0.05
LOGIT_MAX_ABS = 1.0
# W8A8 kernel path vs plain path. The int8 products are bitwise equal on
# equal inputs (checked at the tick itself: the int8 kernel alone leaves
# the logits bitwise unchanged), so the paths differ by the attention read
# as in the fp engines, but under W8A8 that difference moves activations
# across int8 code boundaries: the gather read rounds its output to bf16
# (~2^-9 relative), about a tenth of a code step s_x, so about a tenth of
# the o-projection's codes move by one step in every layer, a noise of
# the size of the quantization noise itself, compounded over 40 layers.
# Measured: relative RMS 0.164 on clipped-w8a8 (first run of this check,
# against 0.027 for the same model in fp); bounded at 0.3.
W8A8_LOGIT_REL_RMS = 0.3
# W8A8 tick vs fp tick on the same weights and cache: 280 int8
# quantizations of activations and weights per forward. A wrong scale or
# zero-point moves the logits by their own size (relative RMS near 1).
W8A8_VS_FP_REL_RMS = 0.6
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
# (M, K, N) of a layer's seven W8A8 linears on the main path over
# qwen3-14b's projections (q/o 5120x5120, k/v 5120x1024, gate/up
# 5120x17408, down 17408x5120), at decode (8 rows) and at the padded mixed
# tick (8 rows x 256 tokens); the weights each appears with in a layer
LAYER_LINEARS = [((5120, 5120), 2), ((5120, 1024), 2), ((5120, 17408), 2), ((17408, 5120), 1)]
INT8_TICK_SHAPES = [(m, k, n) for m in (8, 2048) for (k, n), _ in LAYER_LINEARS]
# then M on both sides of the route boundary (16: mma.sync streaming, 17:
# TMA + wgmma), an N no tile divides, and two shapes ragged against every
# tile
INT8_SHAPES = INT8_TICK_SHAPES + [(16, 5120, 5120), (17, 5120, 5120), (130, 5120, 1040),
                                  (5, 64, 16), (37, 96, 80)]
# and OPT-125m's W8A8 linears (q/k/v/o 768x768, up 768x3072, down
# 3072x768) at its decode and padded mixed ticks (phase 5b)
INT8_SHAPES += [(m, k, n) for m in (8, 2048) for k, n in ((768, 768), (768, 3072), (3072, 768))]
# and phase 8's: granite-moe-1b-a400m's q/o (1024x1024) and k/v (1024x512);
# qwen2-moe-a2.7b's q/k/v/o (2048x2048) and its shared experts' gate/up
# (2048x5632) and down (5632x2048); the routers and expert stacks stay fp
MOE_LINEARS = {"granite-moe": ((1024, 1024), (1024, 512)),
               "qwen2-moe": ((2048, 2048), (2048, 5632), (5632, 2048))}
MOE_INT8_SHAPES = [(m, k, n) for m in (8, 2048) for kns in MOE_LINEARS.values()
                   for k, n in kns]
INT8_SHAPES += MOE_INT8_SHAPES
KERNEL_SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu",
                  "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu",
                  "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
                  "fake_quant": "src/repro_torch/csrc/fake_quant.cu",
                  "rg_lru": "src/repro_torch/csrc/rg_lru.cu",
                  "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:177",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:61",
            "flash_attention": "src/repro/kernels/flash_attention.py:157",
            "fake_quant": "src/repro/kernels/fake_quant.py:22",
            "rg_lru": "src/repro/kernels/rg_lru.py:38",
            # no TPU kernel: the reference trains through this dispatcher's
            # plain attention and lets XLA differentiate it
            "flash_attention_bwd": "src/repro/core/attention.py:455"}
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# The evaluation forward's attention, held in two ways against the kernel's
# own plain version (mha_flash_ref: q scaled in bf16, P in f32, as the
# kernel). Per layer, on the same inputs: the two round the same f32 values
# (up to the order of f32 sums, and P carried as a hi/lo pair of bf16
# operands on the tensor-core route) to bf16, so only the rare element
# lying at a bf16 rounding edge differs, by one ulp. Measured on an H100
# 80GB HBM3 at 700 W with the tensor-core route: a layer's relative RMS at
# most 1.261e-4 (vanilla), 9.160e-5 (clipped), 1.296e-4 (gated); bounded
# at 5e-4, about 3.9x the largest. The same plain version with P rounded
# to bf16 (what a kernel feeding P to the tensor cores as one bf16
# operand would compute) is read beside it in every layer and must exceed
# the bound in some layer of each model, so the check tells the two
# apart: on the same card it read 6.280e-4..2.535e-3 (vanilla),
# 1.082e-3..2.545e-3 (clipped), 7.066e-4..2.559e-3 (gated), every layer
# above the bound. A wrong mask, gamma or scale moves a layer by
# percents. End to end, the logits of a forward with the plain version in
# the kernel's place: 40 random bf16 layers amplify those rare one-ulp
# differences about as much as the bf16 P of dense_attention does
# (relative RMS 0.0124 vanilla, 0.0393 clipped, 0.0221 gated, against
# 0.0131, 0.0479, 0.0245 for dense_attention; same card), so that bound
# cannot sit far below LOGIT_REL_RMS, and the per-layer bound is the
# tight one.
FLASH_LAYER_REL_RMS = 5e-4
FLASH_VS_OWN_PLAIN_REL_RMS = 0.05
# The paged tensor-core prefill read (Tq 128, bf16 q, bf16 or int8 pool)
# against paged_flash_attention_ref (P in f32) on the same inputs: as for
# the flash kernel, only elements at a bf16 rounding edge may differ. The
# plain version with P rounded to bf16 is the control that must land
# above the bound in every case (the gather path of phase 4 rounds P to
# bf16 itself, and the bf16 tolerance 2e-2 would pass either). Measured
# on an H100 80GB HBM3 at 700 W over vanilla, clipped and gated, bf16 and
# int8 pools: the kernel 8.798e-5..1.010e-4, the control 2.278e-3..2.609e-3;
# the bound sits 5x above the one and 4.5x below the other.
PAGED_TC_REL_RMS = 5e-4
# qwen3-14b's depth in phases 4 and 5 (of its 40 layers): the run's wall
# stays inside its limit with phases 4c, 5c and 9 added; every check there
# is per layer or per block, or gates a tick at a bound the 40 layers held
QWEN_LAYERS = 20
EVAL_SEQ, EVAL_BATCHES, CALIB_BATCHES = 2048, 2, 4
# the attention heads of BERT-base and OPT-125m (12 of 64, no GQA)
BERT_HEADS = dict(b=8, hq=12, hkv=12, dh=64)
OPT_HEADS = dict(b=1, hq=12, hkv=12, dh=64)
# (B, T, D) of the RG-LRU checks: the serving prefill step and its
# smallest chunk, a long one-shot, the evaluation's length, a T no tile
# divides, decode-sized T 1 (all route 1, the TMA ring), and a ragged D
# (route 0, direct loads)
RG_SHAPES = [(8, 256, 4096), (8, 32, 4096), (1, 4096, 4096), (1, 2048, 4096),
             (1, 1000, 4096), (8, 1, 4096), (3, 33, 777)]
# (B, T, D) timed: the serving prefill step, the long one-shot, the
# evaluation's length, and the smallest serving chunk
RG_TIMED = [(8, 256, 4096), (1, 4096, 4096), (1, 2048, 4096), (8, 32, 4096)]
# Phase 4b: a past-the-window row's last-chunk logits, served (ring read
# through dense_attention, P rounded to bf16, chunked recurrence carrying
# h) against a cache-free forward over its whole prefix (flash kernel, P
# in f32, one recurrence), 38 random bf16 layers. Measured on an H100 80GB
# HBM3 at 700 W: relative RMS 0.0280 (vanilla), 0.0302 (clipped), 0.0292
# (gated), the same in two calls. The clipped engine then serves the same
# sub-step with one fault put in (RG_FAULTS); the smallest reading among
# them, gamma resolved from max_len rather than the ring length, was
# 0.0809. Bounded at 0.05: 1.7x the largest correct reading, below every
# fault's, and each fault is checked to land above it.
RG_LOGIT_REL_RMS = 0.05
# faults the logits check must tell from a correct read: the ring emptied
# (pos_ids -1), the recurrent state h or the conv history lost, gamma
# resolved from max_len. A ring rolled by one slot is printed there but
# held by the ring check below: RoPE is baked into the cached keys, so in
# the logits it moves only the key at the window's edge (1 of 2048),
# below any bound the bf16 noise allows.
RG_FAULTS = ("ring emptied", "h lost", "conv lost", "gamma from max_len",
             "ring rolled one slot")
# Phase 4b's ring check: the first local_attn layer's ring K of the
# past-the-window row before its last chunk (2048 keys, ordered by
# pos_ids) against the post-RoPE keys of a cache-free forward over the
# row's prefix at the same positions. Both are bf16 keys computed by the
# same layers from the same tokens, through products of other shapes
# (8 rows x a chunk against 1 row x the prefix), so they can differ where a
# rounding edge falls differently (one bf16 ulp on every element would
# read ~3e-3). A ring rolled by one slot pairs every key with its
# neighbour's position. Measured on an H100 80GB HBM3 at 700 W, all three
# engines, two runs: correct 0 (bitwise equal), rolled one slot 1.400.
# Bounded at 0.05: 28x below the rolled reading, ~15x above keys one ulp
# apart everywhere.
RG_RING_REL_RMS = 0.05
RG_GRIFFIN_LAYERS = 26             # 12 groups x 2 griffin blocks + the 2-block tail
# Phase 3c's dense-cache reads (generate's decode, the paged=False
# batcher's tick): 8 rows over a dense row of 1024 keys. A decode row's
# offset (its query's position): the row's first key, both sides of a
# 16-key boundary, the middle, the last slot, and three more.
DECODE_OFFSETS = [0, 15, 16, 511, 1023, 100, 700, 300]
# a 256-token chunk at per-row offsets; the rows at 900 and 1000 put their
# last queries past Tk, as a near-full row's padded chunk does
CHUNK_OFFSETS = [0, 768, 900, 300, 512, 1000, 40, 128]
# Phase 4's gates on the dense cache: (a) generate's last decode step
# against a prefill over the same tokens at the same max_len; (b) the
# paged=False engine's first mixed tick against the paged engine's on the
# same tokens. Both sides are correct and round differently (other GEMM
# shapes; the flash kernel at Tq 1 against Tq 543, or against the paged
# kernel), and 40 random bf16 layers carry the ulps to the logits, as for
# LOGIT_REL_RMS, so the logits only catch gross faults: measured on an
# H100 80GB HBM3 at 700 W, gate (a) 0.0115 / 0.0501 / 0.0212 (vanilla,
# clipped, gated), 0.0260 / 0.0240 (recurrentgemma, prompts 1024 / 3000),
# gate (b) 0.0132 / 0.0274 / 0.0363 (the gated paged engine's pool is int8)
# and 0.1023 under W8A8 (held at W8A8_LOGIT_REL_RMS); bounded at 0.1, 2x
# the largest fp reading. A random-weight vanilla model attends almost
# uniformly, so a decode one position early moves its logits by 0.0289
# only. The tight check is per block, each block's input forced to the
# other run's (tapped_blocks): the relative RMS of its increment (output -
# input, both bf16-rounded residuals, so the late blocks, whose residual
# is largest, read the most). Measured, same card: correct 1.965e-3 ..
# 1.714e-2 (fp, both gates), 3.572e-2 (W8A8 dense vs paged); the faults
# 9.823e-2 (recurrentgemma's decode one position early, only 12 of 38
# blocks see positions) .. 1.299 (the clipped gamma from the step's T).
# Bounded at 0.06, 1.7x above the largest correct reading and 1.6x below
# the smallest fault; each gate checks that its faults land above it.
DENSE_LOGIT_REL_RMS = 0.1
DENSE_LAYER_REL_RMS = 0.06


def ptxas_report(log: str):
    """(entry function, registers, spill-store bytes) of each kernel in
    one build's ``ptxas -v`` output."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def bf16_dh128(name: str) -> bool:
    """Is this (mangled) attention kernel an instantiation that bf16 data
    at Dh 128 runs? Flash: the tensor-core kernel at Dh 128; paged: the
    tensor-core kernel at Dh 128 (bf16 q over bf16 or int8 pools) and the
    CUDA-core kernel for Dh <= 128 (one column per thread) with bf16 q or
    pool."""
    if "flash_kernel_tc" in name or "paged_attn_tc" in name:
        return "Li128E" in name
    if "paged_attn_cc" in name:
        return "__nv_bfloat16" in name and re.search(r"Lb[01]ELi1ELi", name) is not None
    return False


def flash_dh(name: str, dhs) -> bool:
    """Is this (mangled) kernel a flash instantiation at one of the head
    dims ``dhs`` (Dh 32: the tensor-core kernel for bf16, the CUDA-core one
    for f32; Dh 80 and 96: the CUDA-core one, f32; bf16 at those runs the
    Dh-128 tensor-core kernel)?"""
    return "flash_kernel_" in name and any(f"ELi{dh}EE" in name for dh in dhs)


def check(ok, msg: str) -> None:
    """A failed check ends the run (explicit, so it also holds under -O)."""
    if not ok:
        raise AssertionError(msg)


def rel_rms(a, b) -> float:
    """RMS of a - b relative to the RMS of b, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


def bf16_p(torch, matmuls=True):
    """A mode under which the plain versions round P to bf16 before P.V:
    what a kernel would compute that handed P to the tensor cores as one
    bf16 operand, the control a check of P's precision must tell from a
    sound kernel. It rounds the first operand of the plain versions' P.V
    products (``attention_ref``'s "bqk,bkd->bqd" and ``dense_attention``'s
    "bhgqk,bkhd->bqhgd" einsums, and ``paged_flash_attention_ref``'s
    matmul); their QK products are einsums of other equations and pass
    through. ``matmuls=False`` leaves every matmul alone, so that a whole
    forward (whose linears are matmuls) run under it rounds only P."""
    from torch.overrides import TorchFunctionMode

    class Bf16P(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.einsum and args[0] in ("bqk,bkd->bqd", "bhgqk,bkhd->bqhgd"):
                args = (args[0], args[1].bfloat16().float(), *args[2:])
            elif matmuls and func in (torch.matmul, torch.Tensor.matmul,
                                      torch.Tensor.__matmul__):
                args = (args[0].bfloat16().float(), *args[1:])
            return func(*args, **(kwargs or {}))

    return Bf16P()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------
def attention_case(torch, tq, dtype, variant, seed, b=8, hkv=8, g=5, dh=128,
                   bs=16, max_len=1024, copies=1, q_dtype=None, lengths=None,
                   dead_rows=(), **kw):
    """Inputs at qwen3-14b's shapes: rows at ragged positions up to
    max_len, scrambled prefix-dense tables with -1 tails. ``copies``
    independent pool sets let a timing loop find its K/V cold in L2.
    ``q_dtype`` (default: ``dtype``) lets f32 queries read a bf16 pool.
    ``lengths`` sets each row's live length (its last query's position
    + 1) instead; rows in ``dead_rows`` have tables of -1 only; ``kw``
    (window, softcap) goes to the read."""
    gen = torch.Generator().manual_seed(seed)
    w = max_len // bs
    nb = b * w + 8
    pos = torch.randint(0, max_len - tq + 1, (b,), generator=gen, dtype=torch.int32)
    if lengths is not None:
        pos = torch.tensor([n - tq for n in lengths], dtype=torch.int32)
    table = torch.full((b, w), -1, dtype=torch.int32)
    perm = torch.randperm(nb, generator=gen).to(torch.int32)
    nxt = 0
    for i in range(b):
        need = -(-(int(pos[i]) + tq) // bs)
        if i not in dead_rows:
            table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    int8 = variant == "int8" or dtype == torch.int8
    sets = []
    for _ in range(copies):
        if int8:
            kp = torch.randint(-127, 128, (nb, bs, hkv, dh), generator=gen, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb, bs, hkv, dh), generator=gen, dtype=torch.int8)
            ks = torch.rand(nb, bs, generator=gen) / 127
            vs = torch.rand(nb, bs, generator=gen) / 127
        else:
            kp = torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype)
            vp = torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype)
            ks = vs = None
        sets.append(tuple(None if x is None else x.cuda() for x in (kp, vp, ks, vs)))
    q = torch.randn(b, hkv, tq * g, dh, generator=gen).to(q_dtype or dtype).cuda()
    gate = torch.sigmoid(torch.randn(b, hkv, tq * g, generator=gen)).cuda() \
        if variant == "gated" else None
    gamma = -4.0 / max_len if variant == "clipped" else 0.0   # alpha 4, logical length
    return dict(q=q, sets=sets, table=table.cuda(), pos=pos.cuda(), gate=gate,
                gamma=gamma, group=g, bs=bs, kw=kw)


def run_kernel(pa, c, k=0):
    kp, vp, ks, vs = c["sets"][k]
    return pa.paged_flash_attention(c["q"], kp, vp, c["table"], c["pos"], c["gate"],
                                    group=c["group"], gamma=c["gamma"],
                                    k_scale=ks, v_scale=vs, **c["kw"])


def run_plain(pa, c, k=0):
    kp, vp, ks, vs = c["sets"][k]
    return pa.paged_flash_attention_ref(c["q"], kp, vp, c["table"], c["pos"], c["gate"],
                                        group=c["group"], gamma=c["gamma"],
                                        k_scale=ks, v_scale=vs, **c["kw"])


def paged_route(pa, c):
    """The route and split count the wrapper takes for case c."""
    q, kp = c["q"], c["sets"][0][0]
    b, hkv, tqg, dh = q.shape
    return pa.plan(q.dtype, kp.dtype, b, hkv, tqg, dh, c["table"].shape[1] * c["bs"],
                   pa.sm_count(q.device))


def library_inputs(torch, c, k=0):
    """Dense, head-repeated K/V and the boolean mask for one PyTorch
    ``scaled_dot_product_attention`` call computing the same (vanilla)
    attention. Built outside any timing."""
    kp, vp, _, _ = c["sets"][k]
    b, hkv, tqg, dh = c["q"].shape
    g, bs = c["group"], c["bs"]
    tq, w = tqg // g, c["table"].shape[1]
    safe = c["table"].clamp(min=0).long()
    kk = kp[safe].reshape(b, w * bs, hkv, dh).permute(0, 2, 1, 3)
    vv = vp[safe].reshape(b, w * bs, hkv, dh).permute(0, 2, 1, 3)
    kk = kk.repeat_interleave(g, dim=1).contiguous()
    vv = vv.repeat_interleave(g, dim=1).contiguous()
    q = c["q"].reshape(b, hkv, tq, g, dh).permute(0, 1, 3, 2, 4).reshape(b, hkv * g, tq, dh)
    q_pos = c["pos"].long()[:, None] + torch.arange(tq, device="cuda")
    k_pos = torch.arange(w * bs, device="cuda")
    valid = (c["table"] >= 0).repeat_interleave(bs, dim=1)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & valid[:, None, :]
    return q.contiguous(), kk, vv, mask[:, None]


def device_ms(torch, fns, reps):
    """Mean device time of one call: ``reps`` calls enqueued back to back
    behind a GPU sleep (so host overhead does not leave the device idle),
    cycling through ``fns`` (independent input copies, so K/V come from
    HBM rather than L2), between two CUDA events."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(c, elem_bytes):
    """Least time for one call on an H100: each input read once (the K/V
    of every row's live tokens, q, table, scales, gate), the output
    written once, against 3.35 TB/s; the QK and PV flops of every causally
    visible (query, key) pair against the dense bf16 (or f32) peak."""
    q = c["q"]
    b, hkv, tqg, dh = q.shape
    g = c["group"]
    tq = tqg // g
    pos = c["pos"].long().cpu()
    live = int((pos + tq).sum())                       # K/V tokens the rows need
    kv_elem = c["sets"][0][0].element_size()
    nbytes = 2 * live * hkv * dh * kv_elem             # K and V
    if c["sets"][0][2] is not None:
        nbytes += 2 * live * 4                         # per-token scales
    nbytes += 2 * q.numel() * q.element_size()         # q in, out
    nbytes += c["table"].numel() * 4 + b * 4
    if c["gate"] is not None:
        nbytes += c["gate"].numel() * 4
    pairs = int(sum(int(p) * tq + tq * (tq + 1) // 2 for p in pos))
    flops = 4 * dh * hkv * g * pairs
    peak = BF16_FLOPS if elem_bytes == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Phase 3's added reads: (name, Tq, variant, q dtype, pool dtype, extra
# arguments of attention_case). Decode rows whose live lengths cross the
# split-KV chunk boundaries (1, 17, 255 and 1024 tokens), a row whose
# table is all -1 (its output must be exact zeros), window and softcap at
# decode and at a prefill chunk (the split and the tensor-core routes),
# and int8 pools at both.
LIVE = [1, 17, 255, 1024, 1024, 255, 17, 1]
PAGED_EXTRA = [
    ("lengths", 1, "vanilla", "bfloat16", "bfloat16", dict(lengths=LIVE)),
    ("lengths", 1, "clipped", "bfloat16", "bfloat16", dict(lengths=LIVE)),
    ("lengths", 1, "gated", "float32", "float32", dict(lengths=LIVE)),
    ("lengths", 1, "clipped", "float32", "bfloat16", dict(lengths=LIVE)),
    ("lengths", 1, "int8", "bfloat16", "int8", dict(lengths=LIVE)),
    ("lengths", 1, "int8", "float32", "int8", dict(lengths=LIVE)),
    ("dead row", 1, "vanilla", "bfloat16", "bfloat16", dict(lengths=LIVE, dead_rows=(3,))),
    ("dead row", 1, "clipped", "float32", "float32", dict(lengths=LIVE, dead_rows=(3,))),
    ("dead row", 128, "vanilla", "bfloat16", "bfloat16", dict(dead_rows=(3,))),
    ("dead row", 128, "clipped", "bfloat16", "int8", dict(dead_rows=(3,))),
    ("window", 1, "vanilla", "bfloat16", "bfloat16", dict(lengths=LIVE, window=100)),
    ("window", 1, "clipped", "float32", "float32", dict(window=100)),
    ("window", 128, "vanilla", "bfloat16", "bfloat16", dict(window=100)),
    ("window", 128, "clipped", "bfloat16", "int8", dict(window=100)),
    ("softcap", 1, "clipped", "bfloat16", "bfloat16", dict(softcap=30.0)),
    ("softcap", 1, "gated", "float32", "bfloat16", dict(softcap=30.0)),
    ("softcap", 128, "clipped", "bfloat16", "bfloat16", dict(softcap=30.0)),
    ("softcap", 128, "gated", "bfloat16", "int8", dict(softcap=30.0)),
]
# OPT-125m's reads (phase 5b's engines): 8 rows of 12 heads, no GQA, Dh
# 64, max_len 2048, f32 queries over the fp engines' f32 pool and the
# W8A8 engine's int8 pool; decode rows whose live lengths reach the
# table's last row, and prefill chunks of 128 and 256 (the token budget)
OPT_PAGED = dict(b=8, hkv=12, g=1, dh=64, max_len=2048)
OPT_LIVE = [1, 17, 255, 2048, 1900, 1024, 17, 1]
PAGED_EXTRA += [("opt-125m", tq, variant, "float32", pool,
                 dict(OPT_PAGED, lengths=OPT_LIVE) if tq == 1 else OPT_PAGED)
                for tq in (1, 128, 256) for pool in ("float32", "int8")
                for variant in ("vanilla", "clipped", "gated")]
# gemma2-27b's reads (phase 7d's engines): 4 rows, 16 KV heads of 128
# with 2 query heads each, bf16, logit softcap 50, max_len 4608; decode
# and chunks of 128 at live lengths past 4096, with and without the
# local layers' 4096 window. phi-3-vision's (phase 7c): 8 rows of 32
# heads of 96 (no GQA: the CUDA-core route), bf16, max_len 2048.
GEMMA_PAGED = dict(b=4, hkv=16, g=2, dh=128, max_len=4608, softcap=50.0)
GEMMA_LIVE = {1: [4600, 4097, 1, 300], 128: [4608, 4224, 300, 4097]}
PHI_PAGED = dict(b=8, hkv=32, g=1, dh=96, max_len=2048)
PAGED_EXTRA += [("gemma2-27b", tq, variant, "bfloat16", "bfloat16",
                 dict(GEMMA_PAGED, lengths=GEMMA_LIVE[tq], **extra))
                for tq in (1, 128) for extra in ({}, dict(window=4096))
                for variant in ("vanilla", "clipped", "gated")]
PAGED_EXTRA += [("phi-3-vision", tq, variant, "bfloat16", "bfloat16",
                 dict(PHI_PAGED, lengths=OPT_LIVE) if tq == 1 else PHI_PAGED)
                for tq in (1, 128) for variant in ("vanilla", "clipped", "gated")]
# phase 8's MoE engines (batch 8, max_len 1024, bf16): granite-moe-1b-a400m
# reads 8 KV heads of 64 with 2 query heads each, qwen2-moe-a2.7b 16 of 128
# with one each (the CUDA-core route at decode); decode and chunks of 128
MOE_PAGED = {"granite-moe": dict(b=8, hkv=8, g=2, dh=64, max_len=1024),
             "qwen2-moe": dict(b=8, hkv=16, g=1, dh=128, max_len=1024)}
PAGED_EXTRA += [(name, tq, variant, "bfloat16", "bfloat16",
                 dict(shape, lengths=LIVE) if tq == 1 else shape)
                for name, shape in MOE_PAGED.items() for tq in (1, 128)
                for variant in ("vanilla", "clipped", "gated")]


def phase_kernel_checks(torch, pa):
    max_err = 0.0
    bad = []
    # (q dtype, pool dtype): matching pairs, and f32 queries over a bf16
    # pool, which compute in f32 and are held at the f32 tolerance
    pairs = (("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16"))
    cases = [("", tq, variant, q_dtype, dtype, {}) for tq in (1, 128)
             for variant in ("vanilla", "clipped", "gated", "int8")
             for q_dtype, dtype in pairs
             if variant != "int8" or q_dtype == dtype]   # int8 pools take either q
    cases += PAGED_EXTRA
    for i, (label, tq, variant, q_dtype, dtype, extra) in enumerate(cases):
        c = attention_case(torch, tq, getattr(torch, dtype), variant,
                           seed=tq + len(variant) + (100 + i if label else 0),
                           q_dtype=getattr(torch, q_dtype), **extra)
        out = run_kernel(pa, c)
        torch.cuda.synchronize()
        ref = run_plain(pa, c)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        name = q_dtype if q_dtype == dtype or variant == "int8" else \
            f"{q_dtype}/{dtype}-pool"
        tol = TOL[q_dtype]
        ok = err <= tol and bool(torch.isfinite(out).all())
        for r in extra.get("dead_rows", ()):   # nothing live: exact zeros
            ok = ok and not bool(out[r].any())
        max_err = max(max_err, err)
        route, splits = paged_route(pa, c)
        what = [f"live lengths {v}" if k == "lengths" else f"{k}={v}" for k, v in extra.items()]
        print(f"kernel check tq={tq:<3} {variant:<7} {name:<19} {label + ': ' if label else ''}"
              f"{''.join(w + ' ' for w in what)}route={route} splits={splits} "
              f"max_abs_err={err:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append((tq, variant, name, label, err))
    check(not bad, f"paged_attention kernel disagrees with its plain version: {bad}")
    return max_err


def phase_paged_tc_precision(torch, pa):
    """The tensor-core prefill read held tightly against its plain version
    (P in f32), beside the bf16-P control."""
    bad = []
    for i, (pool, variant) in enumerate((p, v) for p in ("bfloat16", "int8")
                                        for v in ("vanilla", "clipped", "gated")):
        c = attention_case(torch, 128, getattr(torch, pool), variant, seed=300 + i,
                           q_dtype=torch.bfloat16)
        route, _ = paged_route(pa, c)
        out = run_kernel(pa, c)
        ref = run_plain(pa, c)
        with bf16_p(torch):
            control = rel_rms(run_plain(pa, c), ref)
        sound = rel_rms(out, ref)
        ok = route == "tensor-core" and sound <= PAGED_TC_REL_RMS < control
        print(f"paged P precision tq=128 {variant:<7} {pool:<8} pool route={route}: kernel vs "
              f"plain relative RMS {sound:.3e}, plain with bf16 P {control:.3e} (bound "
              f"{PAGED_TC_REL_RMS:.0e}: kernel at or below, control above) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append((variant, pool, route, sound, control))
    check(not bad, f"paged tensor-core read: P's precision not told apart: {bad}")


def phase_kernel_times(torch, pa, heads=None, variants=("vanilla", "clipped", "gated", "int8"),
                       who=""):
    """Device times of the bf16 paged read at qwen3-14b's shapes, or at
    ``heads`` (attention_case's shape arguments; decode at LIVE lengths):
    kernel, plain version, SDPA (vanilla) and the bound."""
    import torch.nn.functional as F
    times = {}
    for tq, shape in ((1, "decode"), (128, "prefill")):
        for variant in variants:
            kw = {} if heads is None else dict(heads, lengths=LIVE) if tq == 1 else heads
            c = attention_case(torch, tq, torch.bfloat16, variant, seed=7 + tq, copies=4, **kw)
            reps = 40 if tq == 1 else 10
            kern = device_ms(torch, [lambda k=k: run_kernel(pa, c, k) for k in range(4)], reps)
            plain = device_ms(torch, [lambda k=k: run_plain(pa, c, k) for k in range(4)],
                              max(4, reps // 4))
            lib = None
            if variant == "vanilla":
                ins = [library_inputs(torch, c, k) for k in range(4)]
                lib = device_ms(torch, [
                    lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
                    for a in ins], reps)
                del ins
            bound, by = attention_bound_ms(c, 2)
            times[(shape, variant)] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                                           bound_ms=bound, bound_by=by)
            print(f"kernel time {who}{shape:<7} {variant:<7} bf16: kernel {kern:.4f} ms, "
                  f"plain {plain:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms "
                  f"({by})", flush=True)
            del c
            torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 3b: the W8A8 kernel against its plain version
# ---------------------------------------------------------------------------
def int8_case(torch, im, m, k, n, x_dtype, static, seed, copies=1):
    """x (M, K) and ``copies`` weight sets (K, N) int8 with their scales;
    a static range is taken slightly inside x's own so that some codes
    saturate, as they do under calibrated ranges."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, k, generator=gen) * 1.5 + 0.2).to(x_dtype).cuda()
    sets = [im.quantize_weights_int8((torch.randn(k, n, generator=gen) * 0.02).cuda())
            for _ in range(copies)]
    kw = {}
    if static:
        s, z = im.activation_qparams(x)
        kw = dict(x_scale=float(s) * 0.9, x_zero=float(z))
    return x, sets, kw


def int8_bound_ms(m, k, n, x_elem):
    """Least time on an H100: x, w_q and the scales read once, the f32
    output written once, against 3.35 TB/s; 2*M*K*N int8 operations
    against 1979 TOP/s. The larger of the two."""
    nbytes = m * k * x_elem + k * n + m * n * 4 + 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_int8_checks(torch, im):
    """The product against its plain version, bitwise, and the pre-pass's
    codes against ``quantize_activations`` on their own (the codes come
    from a second call through ``_launch``, which ``int8_matmul`` wraps)."""
    bad = []
    max_err = 0.0
    sms = im.sm_count(torch.device("cuda"))
    for m, k, n in INT8_SHAPES:
        p = im.plan(m, n, k, sms)
        for x_dtype in (torch.float32, torch.bfloat16):
            for static in (True, False):
                x, sets, kw = int8_case(torch, im, m, k, n, x_dtype, static, seed=m + k + n)
                wq, ws = sets[0]
                out = im.int8_matmul(x, wq, ws, **kw)
                _, codes = im._launch(x, wq, ws, kw.get("x_scale"), kw.get("x_zero"))
                torch.cuda.synchronize()
                ref = im.int8_matmul_ref(x, wq, ws, **kw)
                s_x, z_x = im.activation_qparams(x, kw.get("x_scale"), kw.get("x_zero"))
                ref_codes = im.quantize_activations(x, s_x, z_x)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                same = torch.equal(out, ref) and bool(torch.isfinite(out).all())
                codes_ok = torch.equal(codes[:m], ref_codes) and not bool(codes[m:].any())
                ok = same and codes_ok
                max_err = max(max_err, err)
                name = str(x_dtype).replace("torch.", "")
                print(f"int8 check ({m}, {k}, {n}) {name:<8} "
                      f"{'static ' if static else 'dynamic'} route {p.route} tile_n "
                      f"{p.tile_n} ctas {p.ctas}: max_abs_err={err:.3e} (bitwise) "
                      f"{'ok' if same else 'FAIL'}; pre-pass codes == quantize_activations: "
                      f"{'ok' if codes_ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append((m, k, n, name, static, err, codes_ok))
                del x, sets, out, ref, codes, ref_codes
    torch.cuda.empty_cache()
    check(not bad, f"int8_matmul kernel disagrees with its plain version: {bad}")
    return max_err


def phase_int8_times(torch, im, shapes=INT8_TICK_SHAPES, layer=LAYER_LINEARS):
    """Device times at every shape the tick runs (``shapes``), x in f32
    (what the tick feeds every linear after layer 0's first projections),
    static range: kernel, plain version, and torch._int_mm on the same
    codes plus the f32 epilogue (cuBLASLt wants its B K-contiguous: the
    kernel's K-major w_q as it is; decode runs it at M padded to 32, its
    least M), beside the bound. Then, with ``layer``, a layer's seven
    linears summed, at M 8 and M 2048."""
    times = {}
    for m, k, n in shapes:
        x, sets, kw = int8_case(torch, im, m, k, n, torch.float32, True, seed=3, copies=2)
        reps = 40 if m == 8 else 10
        kern = device_ms(torch, [lambda w=w: im.int8_matmul(x, w[0], w[1], **kw)
                                 for w in sets], reps)
        plain = device_ms(torch, [lambda w=w: im.int8_matmul_ref(x, w[0], w[1], **kw)
                                  for w in sets], 4)
        s_x, z_x = im.activation_qparams(x, kw["x_scale"], kw["x_zero"])
        codes = im.quantize_activations(x, s_x, z_x)
        m_lib = max(m, 32)
        if m_lib != m:
            codes = torch.cat([codes, codes.new_zeros(m_lib - m, k)])
        cols = [(w[0], s_x * w[1]) for w in sets]
        lib = device_ms(torch, [lambda c=c: torch._int_mm(codes, c[0]).float() * c[1]
                                for c in cols], reps)
        bound, by = int8_bound_ms(m, k, n, 4)
        times[(m, k, n)] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                bound_by=by)
        print(f"int8 time ({m}, {k}, {n}) f32 x: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, _int_mm+epilogue (M {m_lib}) {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        del x, sets, cols, codes
        torch.cuda.empty_cache()
    for m in (8, 2048) if layer else ():
        total = {key: sum(times[(m, k, n)][key] * c for (k, n), c in layer)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"int8 time, a layer's seven linears at M {m}: kernel {total['ms']:.4f} ms, "
              f"plain {total['plain_ms']:.4f} ms, _int_mm+epilogue "
              f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms; x 40 "
              f"layers: kernel {40 * total['ms']:.3f} ms", flush=True)
    return times


# ---------------------------------------------------------------------------
# phase 3c: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------
def flash_case(torch, t, dtype, variant, seed, b=1, hq=40, hkv=8, dh=128, tk=None,
               copies=1):
    """q (B, T, Hq, Dh), ``copies`` K/V sets (B, Tk, Hkv, Dh), the gate
    (B, T, Hq) for gated variants and the resolved (gamma, zeta). q is
    scaled by 2 so that attention is peaked rather than near uniform."""
    gen = torch.Generator().manual_seed(seed)
    tk = tk or t
    q = (torch.randn(b, t, hq, dh, generator=gen) * 2).to(dtype).cuda()
    sets = [tuple(torch.randn(b, tk, hkv, dh, generator=gen).to(dtype).cuda()
                  for _ in range(2)) for _ in range(copies)]
    gate = torch.sigmoid(torch.randn(b, t, hq, generator=gen)).cuda() \
        if "gated" in variant else None
    gamma, zeta = (-4.0 / tk, 1.0) if "clipped" in variant else (0.0, 1.0)
    return dict(q=q, sets=sets, gate=gate, kw=dict(gamma=gamma, zeta=zeta))


def flash_bound_ms(c, q_offset=0, causal=True):
    """Least time on an H100: q and the gate read once, the output written
    once, and the K/V of each row's causally visible keys read once (a
    dense cache pads a row to Tk; the keys past its last query are not
    needed), against 3.35 TB/s; the QK and PV flops of every causally
    visible (query, key) pair (the clipped softmax computes QK twice)
    against the dense bf16 (or f32) peak. The larger of the two.
    ``q_offset``: an int, or one per row. Without the causal mask every
    query sees all Tk keys."""
    q, (k, v) = c["q"], c["sets"][0]
    b, t, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    offs = [q_offset] * b if isinstance(q_offset, int) else list(q_offset)
    if causal:
        pairs = sum(max(0, min(tk, o + i + 1)) for o in offs for i in range(t))
        keys = sum(min(tk, o + t) for o in offs)
    else:
        pairs, keys = b * t * tk, b * tk
    per_pair = 6 if c["kw"]["gamma"] != 0.0 else 4
    flops = per_pair * dh * hq * pairs
    nbytes = (2 * q.numel() + 2 * keys * hkv * dh) * q.element_size()
    if c["gate"] is not None:
        nbytes += c["gate"].numel() * 4
    peak = BF16_FLOPS if q.element_size() == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash_checks(torch, fa):
    bad, max_err = [], 0.0
    cases = [(t, dtype, variant, {}) for t in (2048, 4096)
             for dtype in (torch.float32, torch.bfloat16)
             for variant in ("vanilla", "clipped", "gated", "clipped+gated")]
    # the paths the evaluation does not take, small, in f32 and in bf16:
    # window, softcap (with the clipped softmax), scalar and per-row
    # q_offset with Tq < Tk, no causal mask, the other head dims; and a
    # ragged T 1000 in bf16 (a last query block of 104 rows, a last key
    # tile of 40)
    small = dict(b=2, hq=8, hkv=2)
    cases += [(t, dtype, variant, extra) for dtype in (torch.float32, torch.bfloat16)
              for t, variant, extra in (
                  (256, "vanilla", dict(small, window=100)),
                  (256, "clipped", dict(small, softcap=30.0)),
                  (256, "gated", dict(small, tk=384, q_offset=128)),
                  (256, "clipped", dict(small, tk=384, q_offset="rows")),
                  (256, "vanilla", dict(small, tk=320, causal=False)),
                  (256, "clipped+gated", dict(small, dh=64)),
                  (200, "vanilla", dict(small, dh=256, window=64)))]
    cases += [(1000, torch.bfloat16, "vanilla", dict(small)),
              (1000, torch.bfloat16, "clipped+gated", dict(small, window=300))]
    # Dh 32 (the paper models' reduced widths: 4 heads of 32) on both
    # routes, causal (OPT) and not (BERT), and ragged under a window;
    # BERT-base's shape (8, 512, 12/12, 64) without the causal mask and
    # OPT-125m's (1, 2048, 12/12, 64) with it
    cases += [(256, dtype, variant, dict(b=4, hq=4, hkv=4, dh=32, causal=causal))
              for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)
              for variant in ("vanilla", "clipped", "gated")]
    cases += [(1000, dtype, "clipped+gated", dict(small, dh=32, window=300))
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(t, dtype, variant, dict(shape, **extra))
              for t, shape, extra in ((512, BERT_HEADS, dict(causal=False)),
                                      (EVAL_SEQ, OPT_HEADS, {}))
              for dtype in (torch.float32, torch.bfloat16)
              for variant in ("vanilla", "clipped", "gated")]
    # Dh 80 and 96 (hubert-xlarge, phi-3-vision) on both routes (bf16 runs
    # the Dh-128 tensor-core body over zero-filled boxes), causal and not;
    # a window and a softcap at a ragged T 1000
    cases += [(256, dtype, variant, dict(small, dh=dh, causal=causal))
              for dh in (80, 96) for dtype in (torch.float32, torch.bfloat16)
              for causal in (True, False) for variant in ("vanilla", "clipped", "gated")]
    cases += [(1000, dtype, variant, dict(small, dh=dh, **extra))
              for dh in (80, 96) for dtype in (torch.float32, torch.bfloat16)
              for variant, extra in (("clipped+gated", dict(window=300)),
                                     ("vanilla", dict(softcap=30.0)))]
    # the reads of this slice's models at their shapes (MODEL_FLASH_SHAPES)
    cases += [(t, dtype, variant, dict(shape, **extra))
              for _, t, dtype, shape, extra in model_flash_shapes(torch)
              for variant in ("vanilla", "clipped", "gated")]
    # the dense cache's reads at qwen3-14b's heads over a row of 1024 keys:
    # decode (Tq 1) and a chunk (Tq 256) at per-row offsets, a prefill at
    # offset 0
    dense = dict(b=8, tk=1024)
    cases += [(t, dtype, variant, extra) for dtype in (torch.float32, torch.bfloat16)
              for variant in ("vanilla", "clipped", "gated")
              for t, extra in ((1, dict(dense, q_offset=DECODE_OFFSETS)),
                               (256, dict(dense, q_offset=CHUNK_OFFSETS)),
                               (512, dict(dense, b=2, q_offset=0)))]
    for i, (t, dtype, variant, extra) in enumerate(cases):
        extra = dict(extra)
        shape = {k: extra.pop(k) for k in ("b", "hq", "hkv", "dh", "tk") if k in extra}
        c = flash_case(torch, t, dtype, variant, seed=100 + i, **shape)
        kw = dict(c["kw"], **extra)
        if kw.get("q_offset") == "rows":
            kw["q_offset"] = torch.tensor([0, 128], dtype=torch.int32, device="cuda")
        elif isinstance(kw.get("q_offset"), list):
            kw["q_offset"] = torch.tensor(kw["q_offset"], dtype=torch.int32, device="cuda")
        k, v = c["sets"][0]
        out = fa.mha_flash(c["q"], k, v, c["gate"], **kw)
        torch.cuda.synchronize()
        ref = fa.mha_flash_ref(c["q"], k, v, c["gate"], **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        name = str(dtype).replace("torch.", "")
        ok = err <= FLASH_TOL[name] and bool(torch.isfinite(out).all())
        max_err = max(max_err, err)
        desc = f"q {tuple(c['q'].shape)} kv {tuple(k.shape)} {variant} {name}" + \
            "".join(f" {key}={val if not hasattr(val, 'tolist') else val.tolist()}"
                    for key, val in extra.items()) + \
            f" route={fa.route(dtype, c['q'].shape[-1])}"
        print(f"flash check {desc}: max_abs_err={err:.3e} tol={FLASH_TOL[name]:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append((desc, err))
        del c, out, ref
    torch.cuda.empty_cache()
    check(not bad, f"flash_attention kernel disagrees with its plain version: {bad}")
    return max_err


def phase_flash_times(torch, fa):
    import torch.nn.functional as F
    times = {}
    for variant in ("vanilla", "clipped"):
        c = flash_case(torch, EVAL_SEQ, torch.bfloat16, variant, seed=7, copies=3)
        q, kw = c["q"], c["kw"]
        kern = device_ms(torch, [lambda s=s: fa.mha_flash(q, s[0], s[1], **kw)
                                 for s in c["sets"]], 10)
        plain = device_ms(torch, [lambda s=s: fa.mha_flash_ref(q, s[0], s[1], **kw)
                                  for s in c["sets"]], 3)
        lib = None
        if variant == "vanilla":
            ins = [(q.transpose(1, 2).contiguous(), s[0].transpose(1, 2).contiguous(),
                    s[1].transpose(1, 2).contiguous()) for s in c["sets"]]
            lib = device_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], is_causal=True, enable_gqa=True) for a in ins], 10)
            del ins
        bound, by = flash_bound_ms(c)
        times[variant] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by)
        print(f"flash time (1, {EVAL_SEQ}, 40/8, 128) {variant} bf16 causal: kernel "
              f"{kern:.4f} ms, plain {plain:.4f} ms, SDPA "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms ({by})",
              flush=True)
        del c
        torch.cuda.empty_cache()
    return times


# The cache-free attention reads of the four models of phase 7 at their
# shapes: (name, T, dtype, heads, mask) — ViT-S/16 f32 (64 images of 197
# patches, 6 heads of 64, no causal mask; the CUDA-core route),
# hubert-xlarge bf16 (2 x 4096 frames, 16 heads of 80, no causal mask),
# phi-3-vision bf16 (1 x 2048, 32 heads of 96, causal) and gemma2-27b bf16
# (1 x 4608, 32/16 heads of 128, logit softcap 50; the local layers with
# the 4096 window, the global ones without)
def model_flash_shapes(torch):
    return [("vit-s16", 197, torch.float32, dict(b=64, hq=6, hkv=6, dh=64), dict(causal=False)),
            ("hubert-xlarge", 4096, torch.bfloat16, dict(b=2, hq=16, hkv=16, dh=80),
             dict(causal=False)),
            ("phi-3-vision", 2048, torch.bfloat16, dict(b=1, hq=32, hkv=32, dh=96), {}),
            ("gemma2-27b local", 4608, torch.bfloat16, dict(b=1, hq=32, hkv=16, dh=128),
             dict(softcap=50.0, window=4096)),
            ("gemma2-27b global", 4608, torch.bfloat16, dict(b=1, hq=32, hkv=16, dh=128),
             dict(softcap=50.0)),
            ("granite-moe", 2048, torch.bfloat16, dict(b=1, hq=16, hkv=8, dh=64), {}),
            ("granite-moe training", 1024, torch.float32, dict(b=2, hq=16, hkv=8, dh=64), {}),
            ("qwen2-moe", 2048, torch.bfloat16, dict(b=1, hq=16, hkv=16, dh=128), {})]


# Phase 3c's timed shapes of the paper models: BERT-base's evaluation read
# (8, 512, 12/12, 64) without the causal mask, OPT-125m's (1, 2048, 12/12,
# 64) with it, and the reduced configs' 4 heads of 32 at BERT's batch and
# length, both masks. f32 is what the paper models run (f32 params and
# compute: the CUDA-core route); bf16 takes the tensor-core route.
PAPER_FLASH_TIMED = [("bert", 512, BERT_HEADS, False), ("opt", EVAL_SEQ, OPT_HEADS, True),
                     ("dh32", 512, dict(b=8, hq=4, hkv=4, dh=32), False),
                     ("dh32", 512, dict(b=8, hq=4, hkv=4, dh=32), True)]


# ... and hubert-xlarge's and phi-3-vision's reads (Dh 80 and 96), bf16
MODEL_FLASH_TIMED = [("hubert-xlarge", 4096, dict(b=2, hq=16, hkv=16, dh=80), False),
                     ("phi-3-vision", 2048, dict(b=1, hq=32, hkv=32, dh=96), True)]
# ... and phase 8's evaluation reads, bf16 (granite-moe GQA 2 at Dh 64,
# qwen2-moe Dh 128), and granite-moe's f32 training read (B 2, T 1024)
MOE_FLASH_TIMED = [("granite-moe", 2048, dict(b=1, hq=16, hkv=8, dh=64), True),
                   ("qwen2-moe", 2048, dict(b=1, hq=16, hkv=16, dh=128), True)]
MOE_FLASH_TIMED_F32 = [("granite-moe training", 1024, dict(b=2, hq=16, hkv=8, dh=64), True)]


def phase_flash_paper_times(torch, fa, timed=PAPER_FLASH_TIMED, dtypes=("float32", "bfloat16")):
    """Device times at ``timed`` (PAPER_FLASH_TIMED, MODEL_FLASH_TIMED) in
    ``dtypes``, vanilla and clipped: the kernel, its plain version and,
    vanilla, SDPA on the same inputs (a yardstick the port never calls),
    beside the bound."""
    import torch.nn.functional as F
    times = {}
    for name, t, shape, causal in timed:
        for dtype in (getattr(torch, d) for d in dtypes):
            for variant in ("vanilla", "clipped"):
                c = flash_case(torch, t, dtype, variant, seed=11, copies=3, **shape)
                q, kw = c["q"], dict(c["kw"], causal=causal)
                kern = device_ms(torch, [lambda s=s: fa.mha_flash(q, s[0], s[1], **kw)
                                         for s in c["sets"]], 10)
                plain = device_ms(torch, [lambda s=s: fa.mha_flash_ref(q, s[0], s[1], **kw)
                                          for s in c["sets"]], 3)
                lib = None
                if variant == "vanilla":
                    ins = [(q.transpose(1, 2).contiguous(), s[0].transpose(1, 2).contiguous(),
                            s[1].transpose(1, 2).contiguous()) for s in c["sets"]]
                    gqa = shape["hq"] != shape["hkv"]
                    lib = device_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
                        a[0], a[1], a[2], is_causal=causal, enable_gqa=gqa) for a in ins], 10)
                    del ins
                bound, by = flash_bound_ms(c, causal=causal)
                dt = str(dtype).replace("torch.", "")
                key = (name, tuple(q.shape), causal, dt, variant)
                times[key] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                  bound_by=by)
                print(f"flash time {name} {tuple(q.shape)} {'causal' if causal else 'non-causal'}"
                      f" {variant} {dt} route={fa.route(dtype, q.shape[-1])}: kernel "
                      f"{kern:.4f} ms, plain {plain:.4f} ms, SDPA "
                      f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms ({by})",
                      flush=True)
                del c
    torch.cuda.empty_cache()
    return times


def phase_flash_decode_times(torch, fa, pa):
    """Device times at the dense cache's decode read, bf16: q (8, 1, 40,
    128) over K/V (8, 1024, 8, 128) at DECODE_OFFSETS, vanilla and clipped:
    the kernel, its plain version and, vanilla, SDPA on the same dense K/V
    (heads repeated, a boolean mask of each row's visible keys; a yardstick
    the port never calls), beside the bound over the visible keys; and
    phase 3's paged decode read at the same live lengths."""
    import torch.nn.functional as F
    offs = torch.tensor(DECODE_OFFSETS, dtype=torch.int32, device="cuda")
    times = {}
    for variant in ("vanilla", "clipped"):
        c = flash_case(torch, 1, torch.bfloat16, variant, seed=9, b=8, tk=1024, copies=4)
        q, kw = c["q"], dict(c["kw"], q_offset=offs)
        kern = device_ms(torch, [lambda s=s: fa.mha_flash(q, s[0], s[1], **kw)
                                 for s in c["sets"]], 40)
        plain = device_ms(torch, [lambda s=s: fa.mha_flash_ref(q, s[0], s[1], **kw)
                                  for s in c["sets"]], 10)
        lib = None
        if variant == "vanilla":
            g = q.shape[2] // c["sets"][0][0].shape[2]
            mask = (torch.arange(1024, device="cuda")[None, :] <= offs.long()[:, None])
            ins = [(q.transpose(1, 2).contiguous(),
                    s[0].repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
                    s[1].repeat_interleave(g, dim=2).transpose(1, 2).contiguous())
                   for s in c["sets"]]
            lib = device_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=mask[:, None, None, :]) for a in ins], 40)
            del ins
        bound, by = flash_bound_ms(c, DECODE_OFFSETS)
        times[variant] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by)
        print(f"flash time (8, 1, 40/8, 128) over Tk 1024 at offsets {DECODE_OFFSETS} "
              f"{variant} bf16 route={fa.route(q.dtype, 128)}: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        del c
    pc = attention_case(torch, 1, torch.bfloat16, "vanilla", seed=19,
                        lengths=[o + 1 for o in DECODE_OFFSETS], copies=4)
    paged = device_ms(torch, [lambda k=k: run_kernel(pa, pc, k) for k in range(4)], 40)
    bound, by = attention_bound_ms(pc, 2)
    route, splits = paged_route(pa, pc)
    times["paged"] = dict(ms=paged, bound_ms=bound, bound_by=by)
    print(f"paged decode time at the same live lengths {[o + 1 for o in DECODE_OFFSETS]} "
          f"vanilla bf16 route={route} splits={splits}: kernel {paged:.4f} ms, bound "
          f"{bound:.4f} ms ({by})", flush=True)
    del pc
    torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 3d: the fake-quant kernel against its plain version
# ---------------------------------------------------------------------------
FQ_SHAPES = [((2048, 17408), "bfloat16"), ((2048, 5120), "float32"),
             ((5120, 17408), "bfloat16"), ((777,), "float32"), ((1000,), "bfloat16")]


def fq_case(torch, shape, dtype, bits, per_channel, kind, seed):
    """x and its (s, z): activation-like normals over a range that clips
    some values; ``kind`` "ties": s is a power of two and a third of x
    sits exactly half-way between codes after x / s + z; "specials": one
    element in 97 is NaN, one in 101 +inf, one in 103 -inf."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 1.5
    top = 2 ** bits - 1
    c = shape[-1] if per_channel else 1
    if kind == "ties":
        s = torch.full((c,), 2.0 ** -4)
        z = torch.full((c,), float(top // 2))
        flat = x.reshape(-1)
        n = flat.numel() // 3
        k = torch.randint(-2, top + 2, (n,), generator=gen).float()
        zc = z.expand(shape).reshape(-1)[:n]
        flat[:n] = (k + 0.5 - zc) * s[0]
    else:
        s = (torch.rand(c, generator=gen) * 0.02 + 3.0 / top)
        z = torch.randint(0, top + 1, (c,), generator=gen).float()
    if kind == "specials":
        flat = x.reshape(-1)
        for step, val in ((97, float("nan")), (101, float("inf")), (103, float("-inf"))):
            flat[step // 2::step] = val
    x = x.to(getattr(torch, dtype)).cuda()
    return x, s.cuda(), z.cuda()


def fq_same(torch, out, ref):
    """Bitwise equal values, and NaN exactly where the plain version has
    NaN (a NaN's payload is not compared)."""
    nan = out.isnan()
    return torch.equal(nan, ref.isnan()) and torch.equal(out[~nan], ref[~nan])


def phase_fq_checks(torch, fq):
    bad, max_err, n = [], 0.0, 0
    for shape, dtype in FQ_SHAPES:
        for bits in (4, 8):
            for ste in (False, True):
                for per_channel in (False, True):
                    for kind in ("normal", "ties", "specials"):
                        x, s, z = fq_case(torch, shape, dtype, bits, per_channel, kind,
                                          seed=n)
                        n += 1
                        out = fq.fake_quant(x, s, z, bits, ste=ste)
                        torch.cuda.synchronize()
                        ref = fq.fake_quant_ref(x, s, z, bits, ste=ste)
                        torch.cuda.synchronize()
                        # inf - inf and NaN - NaN read as 0; fq_same holds those
                        err = (out.float() - ref.float()).nan_to_num(nan=0.0).abs().max().item()
                        same = fq_same(torch, out, ref)
                        max_err = max(max_err, err)
                        if not same:
                            bad.append((shape, dtype, bits, ste, per_channel, kind, err))
                        del x, out, ref
        print(f"fake_quant check {shape} {dtype}: 24 cases (bits 4/8, both forms, "
              f"per-tensor/per-channel; normal, half-way ties, NaN/inf) bitwise "
              f"{'ok' if not bad else 'FAIL'}", flush=True)
    torch.cuda.empty_cache()
    check(not bad, f"fake_quant kernel disagrees with its plain version: {bad}")
    return max_err


def phase_fq_times(torch, fq):
    """Per-tensor model-site form at the evaluation's largest activation
    and weight, two copies each (L2-cold): kernel, plain version, and
    ``torch.fake_quantize_per_tensor_affine`` on the same bf16 tensor."""
    times = {}
    for shape in ((2048, 17408), (5120, 17408)):
        sets = [fq_case(torch, shape, "bfloat16", 8, False, "normal", seed=k)
                for k in range(2)]
        kern = device_ms(torch, [lambda a=a: fq.fake_quant(a[0], a[1], a[2], 8, ste=True)
                                 for a in sets], 20)
        plain = device_ms(torch, [lambda a=a: fq.fake_quant_ref(a[0], a[1], a[2], 8, ste=True)
                                  for a in sets], 5)
        zi = [a[2].to(torch.int32) for a in sets]
        lib = device_ms(torch, [lambda a=a, zz=zz: torch.fake_quantize_per_tensor_affine(
            a[0], a[1], zz, 0, 255) for a, zz in zip(sets, zi)], 20)
        nbytes = 2 * sets[0][0].numel() * sets[0][0].element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times[shape] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                            bound_by="bytes")
        print(f"fake_quant time {shape} bf16 (site form, 8 bits): kernel {kern:.4f} ms, "
              f"plain {plain:.4f} ms, fake_quantize_per_tensor_affine {lib:.4f} ms, "
              f"bound {bound:.4f} ms (bytes)", flush=True)
        del sets, zi
        torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 3e: kv_quant on the card and on the CPU
# ---------------------------------------------------------------------------
def phase_kv_quant(torch):
    """2^20 random bf16 tokens each of K and V (Hkv 8, Dh 128): codes and
    scales bitwise equal on the card and on the CPU (the CPU side in
    chunks of 2^16 tokens; each token is quantized on its own). Also
    counts the tokens whose scale a multiplication by 1/127 (what CUDA
    makes of a division by a python float) would change: the check can
    tell the two apart only if that count is not 0."""
    from repro_torch.quant.kv_cache import kv_quant
    n, chunk = 1 << 20, 1 << 16
    gen = torch.Generator(device="cuda").manual_seed(11)
    differ = 0
    for name in ("k", "v"):
        xc = (torch.randn(n, 8, 128, generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
        x = xc.cpu()
        q_d, s_d = kv_quant(xc)
        q_d, s_d = q_d.cpu(), s_d.cpu()
        amax = xc.float().abs().amax(dim=(-2, -1))
        recip = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
        differ += int((recip.cpu() != s_d).sum())
        del xc, amax, recip
        torch.cuda.empty_cache()
        for i in range(0, n, chunk):
            q_h, s_h = kv_quant(x[i:i + chunk])
            check(torch.equal(q_h, q_d[i:i + chunk]) and torch.equal(s_h, s_d[i:i + chunk]),
                  f"kv_quant on the card differs from the CPU ({name}, tokens {i}..)")
    print(f"kv_quant check: 2 x {n} bf16 tokens (8 x 128), card vs CPU codes and scales "
          f"bitwise equal; a reciprocal multiplication would change {differ} scales",
          flush=True)
    check(differ > 0, "no token tells a true division from a reciprocal multiplication")
    return differ


# ---------------------------------------------------------------------------
# phase 4: serving at qwen3-14b full width
# ---------------------------------------------------------------------------
# kernel families of a traced tick, by a substring of the kernel's name
TRACE_FAMILIES = (("int8 GEMM + pre-pass", "int8_"), ("paged read", "paged_attn"),
                  ("RG-LRU scan", "rglru"), ("flash backward", "::bwd_"),
                  ("flash forward", "flash_kernel_"))
# families by the host code that launched a kernel: the user annotations
# ``moe_annotations`` opens around the MoE layer's parts and the head, and
# ``xlstm_annotations`` around the xLSTM cells (a
# kernel belongs to the innermost one open when it was launched, unless
# its name already puts it in a family above)
TRACE_ANNOTATED = ("MoE router", "MoE experts", "MoE dispatch", "MoE shared", "head",
                   "mLSTM cell", "sLSTM scan")


def busy_us(spans):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_split(events, label):
    """From a Chrome trace's events: the wall of the ``label`` annotation,
    the device time (sum of kernel, memcpy and memset durations) of each
    kernel family and of the rest (with the rest's three largest kernels
    by name), and the device's idle share over the annotation (1 - the
    union of device intervals inside it / its wall). Times in ms."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == label
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise AssertionError(f"trace: {len(win)} annotations named {label!r}")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
    anns = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") in TRACE_ANNOTATED)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def annotated(e):
        ts = launched.get(e.get("args", {}).get("correlation"))
        inside = [a for a in anns if ts is not None and a[0] <= ts <= a[1]]
        return max(inside)[2] if inside else None      # the latest start: innermost

    fam = {name: 0.0 for name, _ in TRACE_FAMILIES}
    fam.update({name: 0.0 for name in TRACE_ANNOTATED if any(a[2] == name for a in anns)})
    fam["rest"] = 0.0
    count = dict.fromkeys(fam, 0)
    rest = {}
    for e in dev:
        key = next((name for name, sub in TRACE_FAMILIES if sub in e["name"]), None) \
            or annotated(e) or "rest"
        fam[key] += e["dur"] / 1e3
        count[key] += 1
        if key == "rest":
            rest[e["name"]] = rest.get(e["name"], 0.0) + e["dur"] / 1e3
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    return dict(wall_ms=(t1 - t0) / 1e3, device_ms=busy / 1e3, idle_share=1 - busy / (t1 - t0),
                family_ms=fam, family_kernels=count,
                rest_top=sorted(rest.items(), key=lambda kv: -kv[1])[:3])


def trace_tick(torch, fn, label):
    """Replay ``fn`` (one tick, warm) once under torch.profiler, inside an
    annotation ``label`` that ends after a device synchronize, and split
    its device time with ``trace_split``."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return trace_split(events, label)


def trace_replays(torch, forward, snaps, who, unit):
    """Each captured step of ``snaps`` (kind -> a snapshot holding its
    ``cache`` and ``args``), ``forward(cache, *args)`` over a fresh copy
    of its cache (made outside any timing): run once warm, once timed on
    the host clock, once under torch.profiler (``trace_tick``). Prints
    each and returns kind -> the trace's split, with the unprofiled
    replay's wall and the idle share over it added."""
    from repro_torch.nn.module import tree_map

    def replay(snap):
        cache = tree_map(lambda x: x.clone(), snap["cache"])

        def run():
            with torch.no_grad():
                forward(cache, *snap["args"])
        return run

    traces = {}
    for kind, snap in snaps.items():
        replay(snap)()   # warm
        run = replay(snap)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        del run     # its cache copy: one copy at a time (gemma2-27b leaves ~20 GB)
        tr = trace_tick(torch, replay(snap), f"{who} {kind} {unit}")
        # the profiled replay's device busy time over the unprofiled
        # replay's wall: two runs, so a busy time above that wall is
        # reported as it is (a negative share), with a warning
        tr.update(unprofiled_wall_ms=wall_ms, unprofiled_idle_share=1 - tr["device_ms"] / wall_ms)
        if tr["device_ms"] > wall_ms:
            print(f"WARNING {who}: the {kind} {unit}'s device busy time under the profiler "
                  f"({tr['device_ms']:.3f} ms) exceeds the unprofiled replay's wall "
                  f"({wall_ms:.3f} ms): the two replays disagree, read the profiled idle "
                  f"share", flush=True)
        t_tokens, t_counts = snap["args"][0], snap["args"][2]
        fam = ", ".join(f"{k} {v:.3f} ms ({tr['family_kernels'][k]} kernels)"
                        for k, v in tr["family_ms"].items())
        top = ", ".join(f"{n[:60]} {v:.3f} ms" for n, v in tr["rest_top"])
        print(f"{who}: the {kind} {unit} (counts {t_counts.tolist()}, T "
              f"{t_tokens.shape[1]}): wall {wall_ms:.3f} ms on the host clock; under "
              f"torch.profiler wall {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['device_ms']:.3f} ms, idle share {tr['idle_share']:.4f} of the "
              f"profiled wall, {tr['unprofiled_idle_share']:.4f} of the unprofiled one; "
              f"device time by family: {fam}; the rest's largest: {top}", flush=True)
        traces[kind] = tr
    return traces


# the ticks a serving phase captures, by kind: (config, tokens, positions,
# counts on the host) -> whether this tick is one
TICKS = {
    # decode rows beside prefill chunks
    "mixed": lambda cfg, tokens, pos, c: bool((c == 1).any() and (c > 1).any()),
    # a padded tail past the learned position table's last row
    "past the table": lambda cfg, tokens, pos, c:
        int(pos.max()) + tokens.shape[1] > cfg.max_seq_len,
    # every live row decoding
    "decode": lambda cfg, tokens, pos, c: bool((c == 1).any() and (c <= 1).all()),
    # a live row starting past the local layers' window: its ring is full
    # and has wrapped
    "past the window": lambda cfg, tokens, pos, c: cfg.window is not None and bool(
        ((pos.cpu() > cfg.window) & (c > 0)).any()),
}


def short_requests(np, vocab, n):
    """``n`` greedy requests from numpy seed 0: prompts of 32..512 tokens,
    32 new tokens each (phase 4's 12, phase 7's)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(k)).astype(np.int32), 32)
            for k in rng.integers(32, 513, size=n)]


def phase_serving(torch, np, pa, im, fa, name, cfg, requests, max_len, tick_tol,
                  max_abs=None, ticks=("mixed",), paged=True, kv_int8=None, w8a8=False,
                  controls=(), trace=False, dense=None, params=None, batch_size=8,
                  num_blocks=None, ring_ref=None):
    """One engine, ``ContinuousBatcher`` (batch ``batch_size``, block 16,
    budget 256, ``num_blocks`` pool blocks) on ``params`` or random weights
    from seed 0, over ``requests`` ((prompt, new tokens)).
    Gates: every request done with its tokens, no block leak, launches
    per forward; at the first tick of each kind in ``ticks`` (TICKS), the
    live logits through the kernels against the plain path's (the gather
    read or ``dense_attention``, the int8 product's plain version): finite,
    within ``tick_tol`` relative RMS (and ``max_abs``); each run named in
    ``controls`` must land above ``tick_tol``: "P in bf16" (the plain path
    with P rounded to bf16), "positions one early" (the tick one position
    early), "MoE capacity 8" (the kernel path with every MoE layer at its
    least capacity). A MoE config's tick lines print the (layer, token)
    pairs the kernel and the plain paths route to other experts when
    free, and hold the plain path routed as the kernel path routed
    (``routing_taps``). Under W8A8, at the mixed tick: the int8 kernel
    alone leaves the plain path's logits bitwise, and W8A8 stays
    within W8A8_VS_FP_REL_RMS of fp. ``trace``: the mixed and a decode
    tick replayed under torch.profiler. ``dense``: (method, method_kw) of
    ``phase_dense_serving``, run after on the same weights. ``ring_ref``:
    (uid, keys): at the "past the window" tick, the first local_attn
    layer's ring of the row serving request ``uid`` against ``keys``, the
    post-RoPE keys a cache-free forward over its prompt computed there
    (``ring_vs_keys``)."""
    from repro_torch.core.attention import dense_attention
    from repro_torch.models import transformer
    from repro_torch.models.transformer import model_init
    from repro_torch.nn import layers
    from repro_torch.nn.module import flatten_params, tree_map
    from repro_torch.quant.qconfig import NO_QUANT, QConfig
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving import scheduler as sched
    from repro_torch.serving.decode import step_rows_full

    t0 = time.perf_counter()
    if params is None:
        params = model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    setup = {}

    def timed(key, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            setup[key] = time.perf_counter() - t
            return out
        return run

    # time the two set-up steps of a W8A8 engine inside its constructor
    calibrate_engine, attach = sched._calibrate_engine, sched.attach_int8_weights
    sched._calibrate_engine = timed("calib_s", calibrate_engine)
    sched.attach_int8_weights = timed("quant_s", attach)
    try:
        b = timed("setup_s", ContinuousBatcher)(
            params, cfg, batch_size=batch_size, max_len=max_len, block_size=16,
            token_budget=256, num_blocks=num_blocks, paged=paged, kv_int8=kv_int8,
            qconfig=QConfig() if w8a8 else None, device="cuda")
    finally:
        sched._calibrate_engine, sched.attach_int8_weights = calibrate_engine, attach
    snaps, want, step_fn = {}, list(ticks), b._step_fn

    def capture(params_, cache, tokens, pos, counts, keys, lw, lws):
        # the first tick of each wanted kind: keep its inputs and a copy of
        # the cache it reads, for the comparisons and traces below,
        # outside the counted run
        c = counts.cpu()
        for kind in want:
            if kind not in snaps and TICKS[kind](cfg, tokens, pos, c):
                snaps[kind] = dict(cache=tree_map(lambda x: x.clone(), cache),
                                   args=(tokens.clone(), pos.clone(), counts.clone(), lw,
                                         None if lws is None else lws.clone()),
                                   uids=[-1 if s.req is None else s.req.uid for s in b.slots])
        return step_fn(params_, cache, tokens, pos, counts, keys, lw, lws)

    b._step_fn = capture
    for u, (p, n) in enumerate(requests):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=n))
    torch.cuda.reset_peak_memory_stats()
    pa.launches = im.launches = fa.launches = 0
    n_ticks = 0
    t0 = time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        n_ticks += 1
        check(n_ticks <= 2000, f"{name}: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(paged=pa.launches, int8=im.launches, flash=fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tokens = sum(len(o) for o in outs.values())
    fwd, nl = b.forward_calls, cfg.n_layers
    extra = (f", calibration {setup['calib_s']:.2f} s, weight quantization "
             f"{setup['quant_s']:.2f} s") if w8a8 else ""
    print(f"serving {name} ({'paged' if paged else 'dense'}, {nl} layers, "
          f"{str(cfg.compute_dtype).replace('torch.', '')}): {n_ticks} ticks, {fwd} forwards, "
          f"{n_tokens} generated tokens in {wall:.3f} s = {n_tokens / wall:.2f} tok/s, peak "
          f"memory {peak_gb:.2f} GB, weights init {init_s:.2f} s, engine set-up "
          f"{setup['setup_s']:.2f} s{extra}, launches {launches}", flush=True)
    check(len(outs) == len(requests) and
          all(len(outs[u]) == n for u, (_, n) in enumerate(requests)),
          f"{name}: not every request finished with its tokens")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs.values()),
          f"{name}: token ids outside the vocabulary")
    check(not b.failed, f"{name}: failed requests {[r.status for r in b.failed]}")
    if paged:
        b.audit()
        check(b.allocator.available == b.num_blocks and (b.tables == -1).all(),
              f"{name}: block leak")
    # attention: one read per global-attention layer per forward (a
    # local_attn layer reads its ring with dense_attention); W8A8: every
    # linear of a layer (q, k, v, o and the MLP's two or three)
    linears = 4 + (3 if "glu" in cfg.mlp_kind else 2)
    if cfg.moe is not None:
        # the router and the expert stacks stay fp; the shared experts' SwiGLU
        linears = 4 + (3 if cfg.moe.n_shared_experts else 0)
    n_glob = cfg.n_groups * cfg.pattern.count("attn") + cfg.tail_pattern.count("attn")
    expect = dict(paged=n_glob * fwd if paged else 0, flash=0 if paged else n_glob * fwd,
                  int8=linears * nl * fwd if w8a8 else 0)
    check(launches == expect, f"{name}: launches {launches}, expected {expect}")
    check(set(snaps) == set(ticks), f"{name}: ticks seen {sorted(snaps)}, wanted {ticks}")
    if w8a8:
        # every w_q8 the engine reads is K-major, and the tree holds one
        # int8 copy of each weight (no leaf owns more bytes than it shows)
        q8 = [t for path, t in flatten_params(b.params) if path.endswith("w_q8")]
        k_major = all(t.dim() in (2, 3) and t.stride()[-2:] == (1, t.shape[-2]) for t in q8)
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in q8}
        one_copy = sum(storages.values()) == sum(t.numel() for t in q8)
        print(f"serving {name}: {len(q8)} w_q8 leaves, all K-major: {k_major}; int8 bytes "
              f"{sum(storages.values()) / 1e9:.3f} GB in {len(storages)} storages, one copy "
              f"of each weight: {one_copy}", flush=True)
        check(q8 and k_major and one_copy, f"{name}: w_q8 layout or copies off")
        del q8      # the int8 weights go with the engine
    result = dict(engine=name, layers=nl, paged=paged, w8a8=w8a8, ticks=n_ticks,
                  forwards=fwd, tokens=n_tokens, wall_s=wall, tok_per_s=n_tokens / wall,
                  peak_gb=peak_gb, init_s=init_s, **setup,
                  **{f"{k}_launches": v for k, v in launches.items()})

    def replay(snap, run, force=None):
        """The tick's live logits through the kernels ("kernel"), through
        the plain path ("plain"), the plain attention with the int8
        kernel ("int8 kernel"), the fp tick ("fp"), or a control; a MoE
        config's routing recorded (and forced to ``force``)."""
        tokens, pos, counts, lw, lws = snap["args"]
        live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
        plain_attn = run not in ("kernel", "fp", "MoE capacity 8")
        c2 = dataclasses.replace(b.cfg, paged_backend="gather") if plain_attn else b.cfg
        if run == "MoE capacity 8":
            # every MoE layer at its least capacity, 8 claims an expert: most
            # live claims drop (a padded tick's dead tokens claim nothing, so
            # a capacity the padding sizes drops little at MOE_DROP_CF)
            c2 = dataclasses.replace(c2, moe=dataclasses.replace(c2.moe, capacity_factor=0.0))
        if run == "positions one early":
            pos = (pos - 1).clamp(min=0)
        real_attention = transformer.attention
        if plain_attn:
            transformer.attention = lambda q, k, v, c, q_offset=0, gate_pi=None: \
                dense_attention(q, k, v, c, q_offset=q_offset, gate_pi=gate_pi)
        if plain_attn and run != "int8 kernel":
            layers.int8_matmul = im.int8_matmul_ref
        cache = tree_map(lambda x: x.clone(), snap["cache"])
        try:
            with torch.no_grad(), (bf16_p(torch, matmuls=False) if run == "P in bf16"
                                   else contextlib.nullcontext()), \
                    (routing_taps(force) if cfg.moe is not None else
                     contextlib.nullcontext()) as routes:
                out = step_rows_full(b.params, c2, cache, tokens, pos, counts, lw, lws,
                                     ctx=NO_QUANT if run == "fp" else b._qctx)[0]
        finally:
            layers.int8_matmul = im.int8_matmul
            transformer.attention = real_attention
        pad_nan = int(torch.isnan(out[~live]).any(-1).sum())
        return out[live][:, :cfg.vocab_size], pad_nan, routes

    taps = None
    for kind in ticks:
        snap = snaps[kind]
        tokens, pos, counts = snap["args"][:3]
        # the kernel run at the mixed tick keeps each block's input and
        # increment at the live tokens, for the dense engine's gate (b)
        live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
        with tapped_blocks(live) if kind == "mixed" else contextlib.nullcontext() as t:
            kern, pad_nan, kern_routes = replay(snap, "kernel")
        taps = t if kind == "mixed" else taps
        # a MoE tick's plain path routes as the kernel path routed (its
        # free routing's flips are printed)
        plain = replay(snap, "plain", kern_routes)[0]
        flips = None if cfg.moe is None else \
            routing_flips(kern_routes, replay(snap, "plain")[2])
        finite = bool(torch.isfinite(kern).all())
        rms = rel_rms(kern, plain)
        diff = (kern - plain).abs().max().item()
        agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        ctl = {run: rel_rms(replay(snap, run)[0], plain) for run in controls}
        print(f"serving {name}: {kind} tick (counts {counts.tolist()}, positions up to "
              f"{int(pos.max()) + tokens.shape[1] - 1} with padding, T {tokens.shape[1]}): "
              f"kernel vs plain live logits relative RMS {rms:.3e} (tol {tick_tol}), "
              f"max_abs_diff {diff:.4f}{'' if max_abs is None else f' (tol {max_abs})'} "
              f"(logit std {plain.std().item():.3f}), argmax agreement {agree:.4f}, live "
              f"logits finite {finite}, padded tokens with NaN logits {pad_nan}" +
              ("" if flips is None else f"; the plain path routed as the kernel path (free, "
                                        f"it routes {flips[0]} of {flips[1]} (layer, token) "
                                        f"pairs to other experts)") +
              "".join(f"; control {k} {v:.3e} (must exceed the tol)" for k, v in ctl.items()),
              flush=True)
        check(finite and rms <= tick_tol and (max_abs is None or diff <= max_abs),
              f"{name}: {kind} tick, kernel and plain logits differ: relative RMS {rms}, "
              f"max {diff}, finite {finite}")
        check(all(v > tick_tol for v in ctl.values()),
              f"{name}: {kind} tick, a control lands within the bound: {ctl}")
        result.update({f"{kind} rel_rms": rms, f"{kind} max_abs_diff": diff,
                       f"{kind} argmax_agreement": agree, f"{kind} routing_flips": flips,
                       **{f"{kind} control {k}": v for k, v in ctl.items()}})
        if kind == "mixed":
            mixed_logits = kern
        if ring_ref is not None and kind == "past the window":
            uid, keys = ring_ref
            check(uid in snap["uids"], f"{name}: request {uid} is not in the tick past the "
                                       f"window (slots {snap['uids']})")
            r = snap["uids"].index(uid)
            ring = ring_vs_keys(torch, snap["cache"], r, keys)
            print(f"serving {name}: row {r}'s first local_attn ring at the tick past the window "
                  f"({ring['filled']} keys, positions {ring['first']}..{ring['last']}; the row "
                  f"starts at {int(pos[r])}) vs the cache-free forward's post-RoPE keys at the "
                  f"same positions, relative RMS: correct {ring['correct']:.3e} (tol "
                  f"{RG_RING_REL_RMS}), rolled one slot {ring['rolled one slot']:.3e}",
                  flush=True)
            check(ring["filled"] == cfg.window and ring["last"] == int(pos[r]) - 1,
                  f"{name}: the ring holds {ring['filled']} keys up to {ring['last']} before "
                  f"position {int(pos[r])}")
            check(ring["correct"] <= RG_RING_REL_RMS < ring["rolled one slot"],
                  f"{name}: ring keys vs the cache-free forward's: {ring}")
            result.update(ring=ring)
        if w8a8 and kind == "mixed":
            # the tick with only the int8 product swapped for its plain
            # version: every product is bitwise equal, so the logits are too
            same = torch.equal(replay(snap, "int8 kernel", kern_routes)[0], plain)
            print(f"serving {name}: mixed tick through the plain attention: int8 kernel vs "
                  f"its plain version, logits bitwise equal: {same}", flush=True)
            check(same, f"{name}: the int8 kernel changed the tick's logits")
            fp = replay(snap, "fp", kern_routes)[0]
            vs_fp = rel_rms(kern, fp)
            agree_fp = (kern.argmax(-1) == fp.argmax(-1)).float().mean().item()
            fp_flips = None if cfg.moe is None else \
                routing_flips(kern_routes, replay(snap, "fp")[2])
            print(f"serving {name}: W8A8 tick vs fp tick on the same weights: logits "
                  f"relative RMS {vs_fp:.4f} (tol {W8A8_VS_FP_REL_RMS}), argmax agreement "
                  f"{agree_fp:.4f}" + ("" if fp_flips is None else
                                       f"; the fp tick routed as the W8A8 tick (free, it "
                                       f"routes {fp_flips[0]} of {fp_flips[1]} (layer, "
                                       f"token) pairs to other experts)"), flush=True)
            check(vs_fp <= W8A8_VS_FP_REL_RMS,
                  f"{name}: W8A8 logits far from fp logits: relative RMS {vs_fp}")
            result.update(w8a8_vs_fp_rel_rms=vs_fp, w8a8_vs_fp_argmax_agreement=agree_fp)
            del fp
        del kern, plain
        if kind != "mixed":
            # the mixed tick's snapshot serves the trace and gate (b) below
            del snaps[kind], snap
            want.remove(kind)
    if trace:
        # the mixed tick, then the first all-decode tick of a second,
        # uncounted run of the first requests (its cache copy stays out of
        # the counted run's peak memory; the engine is left with them in
        # flight): each timed once on the host clock and replayed once
        # under torch.profiler (each warmed first). The mixed tick's cache
        # copy goes before the second run: one copy at a time
        def forward(cache, *args):
            return step_rows_full(b.params, b.cfg, cache, *args, ctx=b._qctx)

        torch.cuda.empty_cache()
        with moe_annotations(torch) if cfg.moe is not None else contextlib.nullcontext():
            traces = trace_replays(torch, forward, {"mixed": snaps["mixed"]},
                                   f"serving {name}", "tick")
        del snaps["mixed"]["cache"]
        want.append("decode")
        for u, (p, n) in enumerate(requests[:batch_size]):
            b.submit(Request(uid=100 + u, prompt=p, max_new_tokens=n))
        for _ in range(200):
            if "decode" in snaps:
                break
            b.step()
        check("decode" in snaps, f"{name}: no all-decode tick was seen")
        with moe_annotations(torch) if cfg.moe is not None else contextlib.nullcontext():
            traces.update(trace_replays(torch, forward, {"decode": snaps.pop("decode")},
                                        f"serving {name}", "tick"))
        for kind, tr in traces.items():
            check((tr["family_kernels"]["int8 GEMM + pre-pass"] > 0 or not w8a8) and
                  tr["family_kernels"]["paged read"] > 0,
                  f"{name}: the traced {kind} tick ran no int8 or paged kernel: {tr}")
            check(cfg.moe is None or min(tr["family_kernels"].get(f, 0) for f in
                                         ("MoE router", "MoE experts", "MoE dispatch")) > 0,
                  f"{name}: the traced {kind} tick shows no MoE kernel: {tr}")
        result.update(traces=traces)
    result.update(peak_gb_with_checks=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serving {name}: peak memory over the run, its checks and traces "
          f"{result['peak_gb_with_checks']:.2f} GB", flush=True)
    # the dense-cache paths on the same weights, the paged engine freed
    # first; gate (b) reads its first mixed tick and that tick's logits
    first = dict(args=snaps["mixed"]["args"][:3], logits=mixed_logits, outs=outs, taps=taps)
    del b, snaps, mixed_logits, taps
    torch.cuda.empty_cache()
    if dense is not None:
        method, method_kw = dense
        result.update(dense=phase_dense_serving(
            torch, np, pa, im, fa, name, method, method_kw, params, cfg,
            [p for p, _ in requests], first, w8a8))
    del params, first
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 4's dense-cache paths: generate and ContinuousBatcher(paged=False)
# ---------------------------------------------------------------------------
def run_generate(torch, params, cfg, prompt, n, counters):
    """``generate`` (greedy, ``n`` new tokens) over ``prompt`` (B, T) on the
    card, the launch counts of the ``counters`` modules at 0 just before
    it and read just after. Records each forward's T and launches, and
    keeps the logits of the last decode step (position T + n - 2) for
    gate (a). Returns (tokens, wall s, peak GB, [(T, launches...)], logits)."""
    from repro_torch.serving import GenerateConfig, decode

    p = prompt.shape[1] + n - 2
    per_forward, kept = [], {}
    real_apply, real_decode = decode.model_apply, decode.decode_one

    def counted_apply(*a, **kw):
        before = [m.launches for m in counters]
        out = real_apply(*a, **kw)
        per_forward.append((a[2]["tokens"].shape[1],
                            *(m.launches - x for m, x in zip(counters, before))))
        return out

    def keep_last(params_, cfg_, cache, tokens, pos, active=None):
        logits, cache = real_decode(params_, cfg_, cache, tokens, pos, active)
        if pos == p:
            kept["logits"] = logits.clone()
        return logits, cache

    decode.model_apply, decode.decode_one = counted_apply, keep_last
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in counters:
            m.launches = 0
        t0 = time.perf_counter()
        out = decode.generate(params, cfg, prompt, GenerateConfig(max_new_tokens=n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decode.model_apply, decode.decode_one = real_apply, real_decode
    return out, wall, torch.cuda.max_memory_allocated() / 1e9, per_forward, kept["logits"]


def prefill_as_generate(params, cfg, tokens, max_len):
    """The prefill ``generate`` runs for ``tokens`` at ``max_len``: one
    forward below the ring's chunk cap, chunks past it. Returns (last
    logits, cache)."""
    from repro_torch.serving import decode

    cap = decode._ring_chunk_cap(cfg, max_len)
    if cap is None or tokens.shape[1] <= cap:
        last, cache, _ = decode.prefill(params, cfg, tokens, max_len)
    else:
        last, cache, _ = decode.chunked_prefill(params, cfg, tokens, max_len)
    return last, cache


@contextlib.contextmanager
def tapped_blocks(sel, force=None):
    """Taps on every block of ``model_apply`` (``transformer._block_apply``):
    each call records the block's input and its increment (output - input,
    in f32) at the tokens ``sel`` selects: ``"last"``, each row's last
    position, or a (B, T) bool mask. With ``force``, another run's recorded
    inputs, block i's input there is first replaced by ``force[i]``
    (teacher forcing): every block then sees the other run's input, so
    its increment differs from the other run's only by what the block
    itself computes differently, without 40 layers of amplification.
    Yields the taps {"inp": [...], "inc": [...]}."""
    from repro_torch.models import transformer

    taps, real = {"inp": [], "inc": []}, transformer._block_apply

    def pick(x):
        return x[:, -1] if isinstance(sel, str) else x[sel]

    def block(p, x, *args):
        if force is not None:
            x = x.clone()
            f = force[len(taps["inp"])].to(x.dtype)
            if isinstance(sel, str):
                x[:, -1] = f
            else:
                x[sel] = f
        y, out = real(p, x, *args)
        taps["inp"].append(pick(x).clone())
        taps["inc"].append(pick(y).float() - pick(x).float())
        return y, out

    transformer._block_apply = block
    try:
        yield taps
    finally:
        transformer._block_apply = real


@contextlib.contextmanager
def routing_taps(force=None):
    """Records the routing of every MoE layer call of ``model_apply``: its
    top-k expert indices (N, k), in the order the layer claims them, and
    its live-token mask. Yields the list. With ``force`` (another run's
    list), each layer call routes to the experts recorded there for it
    (``moe._router``'s ``top_i``: their renormalized probabilities), so
    the two runs differ by what the layers compute, not by where tokens
    go: on random weights a near-tie of router probabilities flips under
    another rounding, moves that token by a whole expert's share, and the
    moved residual flips later layers' choices in turn."""
    from repro_torch.models import transformer
    from repro_torch.nn import moe

    taps, live = [], []
    real_apply, real_router = transformer.moe_apply, moe._router

    def apply(p, x, cfg, *args, active=None, **kw):
        live.append(moe._token_mask(active, x.shape[0], x.shape[1]))
        try:
            return real_apply(p, x, cfg, *args, active=active, **kw)
        finally:
            live.pop()

    def router(p, x2d, cfg):
        top_i = None if force is None else force[len(taps)]["top_i"]
        top_p, top_i, aux = real_router(p, x2d, cfg, top_i=top_i)
        taps.append(dict(top_i=top_i, live=live[-1] if live else None))
        return top_p, top_i, aux

    transformer.moe_apply, moe._router = apply, router
    try:
        yield taps
    finally:
        transformer.moe_apply, moe._router = real_apply, real_router


def routing_flips(a, b):
    """(the (layer, live token) pairs whose expert sets differ between two
    runs' ``routing_taps``, the pairs compared)."""
    check(len(a) == len(b), f"routing taps of {len(a)} and {len(b)} layer calls")
    flips = pairs = 0
    for x, y in zip(a, b):
        keep = x["live"]
        xs, ys = x["top_i"].sort(dim=-1).values, y["top_i"].sort(dim=-1).values
        if keep is not None:
            xs, ys = xs[keep], ys[keep]
        flips += int((xs != ys).any(-1).sum())
        pairs += xs.shape[0]
    return flips, pairs


@contextlib.contextmanager
def moe_annotations(torch):
    """Profiler annotations around the MoE layer's parts (router, experts,
    the dispatch's index ops, the shared experts) and the head, for
    ``trace_split``'s TRACE_ANNOTATED families."""
    from torch.profiler import record_function
    from repro_torch.models import transformer
    from repro_torch.nn import moe

    parts = {(moe, "_router"): "MoE router", (moe, "_experts"): "MoE experts",
             (moe, "_moe_dispatch"): "MoE dispatch", (moe, "mlp_apply"): "MoE shared"}
    heads = ((transformer, "linear_apply"),)      # an untied head (qwen2-moe's)
    real = {key: getattr(*key) for key in list(parts) + list(heads)}

    def wrap(key, label):
        def f(*a, **kw):
            if label is None and not (len(a) > 3 and a[3] == "lm_head"):
                return real[key](*a, **kw)
            with record_function(label or "head"):
                return real[key](*a, **kw)
        return f

    for key in real:
        setattr(*key, wrap(key, parts.get(key)))
    try:
        yield
    finally:
        for key, fn in real.items():
            setattr(*key, fn)


def layer_rms(taps, ref_inc):
    """(largest relative RMS of a block's increment against ``ref_inc``'s,
    the block's index)."""
    rms = [rel_rms(a, b) for a, b in zip(taps["inc"], ref_inc)]
    worst = max(range(len(rms)), key=rms.__getitem__)
    return rms[worst], worst


def gate_decode_vs_prefill(torch, params, cfg, out, t, n, served, faults, who):
    """Gate (a) on one ``generate`` run (tokens ``out``, prompt length t, n
    new): its last decode step (position p = t + n - 2) against a prefill
    over the same p + 1 tokens at the same max_len. Tight, per block: the
    decode step after a prefill of the first p tokens, each block's input
    forced to the prefill's at position p, each block's increment within
    DENSE_LAYER_REL_RMS of the prefill's; every fault of ``faults`` (name
    -> (config, position shift, a change made to the cache or None))
    must land above that in some block. Loose: ``served``, generate's own
    logits of that step (from ``run_generate``), within
    DENSE_LOGIT_REL_RMS of the prefill's last logits. Returns the
    readings."""
    from repro_torch.nn.module import tree_map
    from repro_torch.serving.decode import decode_one

    p, max_len, vocab, nl = t + n - 2, t + n, cfg.vocab_size, cfg.n_layers
    with torch.no_grad():
        with tapped_blocks("last") as ref_taps:
            ref = prefill_as_generate(params, cfg, out[:, :p + 1], max_len)[0][:, :vocab]
        ref_in, ref_inc = ref_taps["inp"][-nl:], ref_taps["inc"][-nl:]   # its last forward
        del ref_taps
        logits_rms = rel_rms(served[:, :vocab], ref)
        _, cache = prefill_as_generate(params, cfg, out[:, :p], max_len)
        layer = {}
        for name, (fcfg, shift, mutate) in {"correct": (cfg, 0, None), **faults}.items():
            c = tree_map(lambda x: x.clone(), cache)
            if mutate is not None:
                mutate(c)
            with tapped_blocks("last", force=ref_in) as taps:
                decode_one(params, fcfg, c, out[:, p:p + 1], p + shift)
            layer[name] = layer_rms(taps, ref_inc)
            del c, taps
        del cache, ref, ref_in, ref_inc
    print(f"{who}: gate (a), generate's decode step at position {p} vs a prefill over the "
          f"same {p + 1} tokens at max_len {max_len}: logits relative RMS {logits_rms:.4f} "
          f"(tol {DENSE_LOGIT_REL_RMS}); per block, inputs forced to the prefill's, the "
          f"largest relative RMS of a block's increment {layer['correct'][0]:.3e} (block "
          f"{layer['correct'][1]}; tol {DENSE_LAYER_REL_RMS:.0e}); with a fault put in: " +
          ", ".join(f"{k} {v[0]:.3e} (block {v[1]})" for k, v in layer.items()
                    if k != "correct"), flush=True)
    check(logits_rms <= DENSE_LOGIT_REL_RMS,
          f"{who}: decode and prefill logits differ: {logits_rms}")
    check(layer["correct"][0] <= DENSE_LAYER_REL_RMS,
          f"{who}: a block's decode step differs from the prefill: {layer['correct']}")
    check(all(v[0] > DENSE_LAYER_REL_RMS for k, v in layer.items() if k != "correct"),
          f"{who}: gate (a) cannot tell a fault from a correct decode: {layer}")
    return dict(logits=logits_rms, layer=layer)


def dense_faults(cfg, method, method_kw):
    """Gate (a)'s faults: the decode step one position early; for the
    clipped softmax, gamma resolved from the step's T (its one query)
    rather than from max_len."""
    faults = {"decode at pos - 1": (cfg, -1, None)}
    if method == "clipped_softmax":
        sm = dataclasses.replace(cfg.softmax_cfg, alpha=None, gamma=-method_kw["alpha"] / 1)
        faults["gamma from the step's T"] = (dataclasses.replace(cfg, softmax_cfg=sm), 0, None)
    return faults


def phase_dense_serving(torch, np, pa, im, fa, name, method, method_kw, params, cfg,
                        prompts, paged, w8a8):
    """Phase 4's dense-cache paths on one engine's weights: ``generate`` on
    4 prompts of 512 tokens (fp engines; the reference's generate takes no
    quantization) with gate (a); ContinuousBatcher(paged=False) over phase
    4's 12 requests with gate (b) against the paged engine's first mixed
    tick (``paged``: its args, logits and outputs); greedy tokens of the
    dense batcher against generate and the paged batcher, printed."""
    from repro_torch.models import transformer
    from repro_torch.nn.module import tree_map
    from repro_torch.quant.qconfig import QConfig
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.decode import step_rows_full

    held_gb = torch.cuda.memory_allocated() / 1e9
    result, vocab = {}, cfg.vocab_size
    gen_prompts = None
    if not w8a8:
        rng = np.random.default_rng(1)
        gen_prompts = torch.as_tensor(rng.integers(0, vocab, (4, 512)), device="cuda")
        out, wall, peak, per_forward, served = run_generate(torch, params, cfg, gen_prompts,
                                                            32, (fa, pa))
        n_tok = out.shape[0] * 32
        off = [f for f in per_forward if f[1:] != (cfg.n_layers, 0)]
        print(f"generate {name} ({cfg.n_layers} layers, 4 x 512 prompt tokens, 32 new): "
              f"{len(per_forward)} forwards, {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s, peak memory {peak:.2f} GB; launches per forward "
              f"(T, flash, paged): first {per_forward[0]}, last {per_forward[-1]}, "
              f"off {off[:4]}", flush=True)
        check(tuple(out.shape) == (4, 544) and bool(((out >= 0) & (out < vocab)).all()),
              f"{name}: generate gave {tuple(out.shape)} or ids outside the vocabulary")
        check(len(per_forward) == 32 and not off,
              f"{name}: generate's forwards or launches off: {per_forward}")
        gate = gate_decode_vs_prefill(torch, params, cfg, out, 512, 32, served,
                                      dense_faults(cfg, method, method_kw), f"generate {name}")
        gen_outs = out[:, 512:].cpu().numpy()
        result.update(gen_wall_s=wall, gen_tok_per_s=n_tok / wall, gen_peak_gb=peak,
                      gen_launches=sum(f[1] for f in per_forward), gate_a=gate)
        del out, served

    b = ContinuousBatcher(params, cfg, batch_size=8, max_len=1024, paged=False,
                          token_budget=256, qconfig=QConfig() if w8a8 else None,
                          device="cuda")
    snap, step_fn = {}, b._step_fn

    def capture(params_, cache, tokens, pos, counts, keys, lw, lws):
        c = counts.cpu()
        if not snap and bool((c == 1).any() and (c > 1).any()):
            snap.update(cache=tree_map(lambda x: x.clone(), cache),
                        args=(tokens.clone(), pos.clone(), counts.clone()))
        return step_fn(params_, cache, tokens, pos, counts, keys, lw, lws)

    b._step_fn = capture
    for u, pr in enumerate(prompts):
        b.submit(Request(uid=u, prompt=pr, max_new_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = pa.launches = im.launches = 0
    ticks, t0 = 0, time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        ticks += 1
        check(ticks <= 1000, f"{name}: the dense engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash=fa.launches, paged=pa.launches, int8=im.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tok = sum(len(o) for o in outs.values())
    fw = b.forward_calls
    same = sum(np.array_equal(outs[u], paged["outs"][u]) for u in outs)
    print(f"serving {name} dense (paged=False): {ticks} ticks, {fw} forwards, {n_tok} "
          f"generated tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s, peak memory "
          f"{peak:.2f} GB ({held_gb:.2f} GB held before the engine); launches {launches} = "
          f"per forward flash {launches['flash'] / fw:g}, paged {launches['paged'] / fw:g}, "
          f"int8 {launches['int8'] / fw:g}; greedy tokens equal to the paged engine's in "
          f"{same} of {len(outs)} requests (printed, not held: cuBLAS picks other "
          f"algorithms at other M, so the card gives no bitwise guarantee)", flush=True)
    check(len(outs) == 12 and all(len(o) == 32 for o in outs.values()) and not b.failed,
          f"{name}: the dense engine did not finish every request with 32 tokens")
    check(launches == dict(flash=cfg.n_layers * fw, paged=0,
                           int8=7 * cfg.n_layers * fw if w8a8 else 0),
          f"{name}: dense engine launches {launches} for {fw} forwards")
    check(snap, f"{name}: the dense engine saw no mixed prefill/decode tick")

    # gate (b): the dense engine's first mixed tick on the paged engine's
    # tokens (a decode row's token is its first sample, which the two
    # engines may draw differently; the cache holds the prompt only),
    # correct and with the dense writes one slot late (each token's K/V at
    # position p + 1); unforced logits, and per block with every block's
    # input forced to the paged tick's
    tokens, pos, counts = paged["args"]
    check(torch.equal(pos, snap["args"][1]) and torch.equal(counts, snap["args"][2]),
          f"{name}: the dense and paged engines' first mixed ticks differ: "
          f"{snap['args'][2].tolist()} vs {counts.tolist()}")
    differ = int((snap["args"][0] != tokens).any(dim=1).sum())
    live = torch.arange(tokens.shape[1], device="cuda")[None, :] < counts[:, None]
    bound = W8A8_LOGIT_REL_RMS if w8a8 else DENSE_LOGIT_REL_RMS
    gate, real_targets = {}, transformer._row_targets
    with torch.no_grad():
        for key in ("correct", "writes one slot late"):
            if key != "correct":
                transformer._row_targets = lambda tpos, *a, **kw: real_targets(tpos + 1, *a, **kw)
            try:
                cache = tree_map(lambda x: x.clone(), snap["cache"])
                out = step_rows_full(b.params, b.cfg, cache, tokens, pos, counts, None, None,
                                     ctx=b._qctx)[0]
                cache = tree_map(lambda x: x.clone(), snap["cache"])
                with tapped_blocks(live, force=paged["taps"]["inp"]) as taps:
                    step_rows_full(b.params, b.cfg, cache, tokens, pos, counts, None, None,
                                   ctx=b._qctx)
            finally:
                transformer._row_targets = real_targets
            gate[key] = (rel_rms(out[live][:, :vocab], paged["logits"]),
                         *layer_rms(taps, paged["taps"]["inc"]))
            del cache, out, taps
    print(f"serving {name} dense: gate (b), the first mixed tick (counts {counts.tolist()}; "
          f"{differ} rows' tokens taken from the paged tick) vs the paged engine's: logits "
          f"relative RMS {gate['correct'][0]:.4f} (tol {bound}); per block, inputs forced to "
          f"the paged tick's, the largest relative RMS of a block's increment "
          f"{gate['correct'][1]:.3e} (block {gate['correct'][2]}; tol "
          f"{DENSE_LAYER_REL_RMS:.0e}); with the writes one slot late: logits "
          f"{gate['writes one slot late'][0]:.4f}, per block "
          f"{gate['writes one slot late'][1]:.3e} (block {gate['writes one slot late'][2]})",
          flush=True)
    check(gate["correct"][0] <= bound,
          f"{name}: dense and paged tick logits differ: {gate['correct']}")
    check(gate["correct"][1] <= DENSE_LAYER_REL_RMS,
          f"{name}: a block of the dense tick differs from the paged tick's: {gate}")
    check(gate["writes one slot late"][1] > DENSE_LAYER_REL_RMS,
          f"{name}: gate (b) cannot tell writes one slot late: {gate}")
    result.update(wall_s=wall, tok_per_s=n_tok / wall, peak_gb=peak, forwards=fw,
                  flash_launches=launches["flash"], int8_launches=launches["int8"],
                  same_as_paged=same, gate_b=gate)
    b._step_fn = step_fn
    del snap
    if gen_prompts is not None:
        # generate's 4 prompts through the same dense engine, uncounted
        for u in range(4):
            b.submit(Request(uid=100 + u, prompt=gen_prompts[u].cpu().numpy(),
                             max_new_tokens=32))
        b.run()
        agree = [np.array_equal(r.output, gen_outs[r.uid - 100]) for r in b.done
                 if r.uid >= 100]
        print(f"serving {name} dense: generate's 4 prompts through the engine: greedy tokens "
              f"equal to generate's in {sum(agree)} of {len(agree)} (printed, not held)",
              flush=True)
        result.update(same_as_generate=sum(agree))
    del b
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 3f: the RG-LRU scan kernel against its plain version
# ---------------------------------------------------------------------------
def rg_case(torch, shape, seed, copies=1):
    """``copies`` sets of a (in (0, 1), as the RG-LRU's gates give it), b
    and h0 (B, D), f32 on the card."""
    gen = torch.Generator().manual_seed(seed)
    b, _, d = shape
    return [(torch.sigmoid(torch.randn(shape, generator=gen) * 2).cuda(),
             torch.randn(shape, generator=gen).cuda(),
             torch.randn(b, d, generator=gen).cuda()) for _ in range(copies)]


def rg_bound_ms(shape):
    """Least time on an H100: a and b read once and h written once (12
    bytes per element; h0 and h_last are 1/T of that) against 3.35 TB/s;
    2 flops per element are far below the f32 rate."""
    b, t, d = shape
    return 12 * b * t * d / HBM_BYTES_PER_S * 1e3


def phase_rg_checks(torch, rl):
    from repro_torch.device import sm_count

    bad, max_err, routes = [], 0.0, set()
    for n, shape in enumerate(RG_SHAPES):
        a, b, h0 = rg_case(torch, shape, seed=50 + n)[0]
        p = rl.plan(*shape, sm_count(a.device))
        routes.add(p.route)
        print(f"rg_lru plan {shape}: {p}", flush=True)
        for init in (None, h0):
            out, last = rl.rglru(a, b, init)
            torch.cuda.synchronize()
            ref, ref_last = rl.rglru_ref(a, b, init)
            torch.cuda.synchronize()
            same = torch.equal(out, ref) and torch.equal(last, ref_last)
            err = max((out - ref).abs().max().item(), (last - ref_last).abs().max().item())
            max_err = max(max_err, err)
            print(f"rg_lru check {shape} {'h0' if init is not None else 'zero state'}: "
                  f"max_abs_err={err:.3e} (bitwise) {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                bad.append((shape, init is not None, err))
        del a, b, h0
    # a state carried across two calls: T 9 then 7 equals T 16, bitwise
    a, b, h0 = rg_case(torch, (2, 16, 4096), seed=60)[0]
    whole, whole_last = rl.rglru(a, b, h0)
    h1, l1 = rl.rglru(a[:, :9], b[:, :9], h0)
    h2, l2 = rl.rglru(a[:, 9:], b[:, 9:], l1)
    torch.cuda.synchronize()
    ref, _ = rl.rglru_ref(a, b, h0)
    carry = torch.equal(torch.cat([h1, h2], 1), whole) and torch.equal(l2, whole_last) \
        and torch.equal(whole, ref)
    print(f"rg_lru check (2, 9 + 7, 4096) carried state == (2, 16, 4096) one call, "
          f"bitwise {'ok' if carry else 'FAIL'}", flush=True)
    check(carry, "rg_lru kernel: a carried state differs from one call")
    check(not bad, f"rg_lru kernel disagrees with its plain version: {bad}")
    check(routes == {0, 1}, f"rg_lru checks reached routes {routes}, not both")
    torch.cuda.empty_cache()
    return max_err


def phase_rg_times(torch, rl):
    times = {}
    for shape in RG_TIMED:
        # the plain loop launches 2 T kernels, so its runs are few; the
        # input copies together exceed the 50 MB L2
        reps, plain_reps = 20, max(1, 1024 // shape[1])
        sets = rg_case(torch, shape, seed=70, copies=2 if shape[0] * shape[1] >= 2048 else 8)
        kern = device_ms(torch, [lambda s=s: rl.rglru(s[0], s[1], s[2]) for s in sets], reps)
        plain = device_ms(torch, [lambda s=s: rl.rglru_ref(s[0], s[1], s[2]) for s in sets],
                          plain_reps)
        bound = rg_bound_ms(shape)
        times[shape] = dict(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bound,
                            bound_by="bytes")
        print(f"rg_lru time {shape} f32: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
              f"library n/a (no PyTorch call computes a linear recurrence), bound "
              f"{bound:.4f} ms (bytes)", flush=True)
        del sets
        torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# phase 4b: serving recurrentgemma-9b at full width
# ---------------------------------------------------------------------------
def rg_prompts(np, vocab):
    """10 prompts from numpy seed 0: three of 2305..3000 tokens (so their
    last chunk of at most 256 starts past the 2048-token window), seven of
    32..3000."""
    rng = np.random.default_rng(0)
    lengths = np.concatenate([rng.integers(2305, 3001, size=3),
                              rng.integers(32, 3001, size=7)])
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lengths]


def ring_vs_keys(torch, cache, r, keys):
    """Row r's ring of the first local_attn layer in ``cache`` (the first
    group's of a stacked (G, B, ...) leaf), each filled slot against
    ``keys`` (T, Hkv, Dh) at the position its pos_ids names, and the same
    ring rolled by one slot: the relative RMS of each, with the count and
    range of the filled positions."""
    from repro_torch.models.transformer import row_leaves

    def first_ring(name_):
        leaf, axis = next((leaf, axis) for path, leaf, axis in row_leaves(cache)
                          if path[-1] == name_)
        return (leaf[0] if axis == 1 else leaf)[r]

    ring_k, ids = first_ring("k"), first_ring("pos_ids").long()
    filled = ids >= 0
    want = keys[ids[filled]].float()
    return {"correct": rel_rms(ring_k[filled], want),
            "rolled one slot": rel_rms(torch.roll(ring_k, 1, dims=0)[filled], want),
            "filled": int(filled.sum()), "first": int(ids[filled].min()),
            "last": int(ids[filled].max())}


def phase_rg_serving(torch, np, rl, fa, pa, name, method, trace=False, gen=False,
                     **method_kw):
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.recurrentgemma_9b import full
    from repro_torch.models import transformer
    from repro_torch.models.transformer import model_apply, model_init, row_leaves
    from repro_torch.nn.module import tree_map
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.decode import step_rows_full

    cfg = apply_method(full(), method, **method_kw)
    t0 = time.perf_counter()
    params = model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = rg_prompts(np, cfg.vocab_size)
    b = ContinuousBatcher(params, cfg, batch_size=8, max_len=4096, block_size=16,
                          token_budget=256, device="cuda")
    step_fn, per_forward, snapshot = b._step_fn, [], {}
    decode_snap, fullest_snap = {}, {}

    def observe(params_, cache, tokens, pos, counts, keys, lw, lws):
        # the prefill sub-step where a row's last chunk starts past the
        # window: keep its inputs and a copy of the cache it reads, for
        # the comparisons below, outside the counted run; with ``trace``,
        # those of the decode sub-step with the most rows and of the
        # prefill sub-step with the most live tokens too
        t = tokens.shape[1]
        if trace:
            kept = decode_snap if t == 1 else fullest_snap
            live = int((counts > 0).sum() if t == 1 else counts.sum())
            if live > kept.get("live", 0):
                kept.update(cache=tree_map(lambda x: x.clone(), cache), live=live,
                            args=(tokens.clone(), pos.clone(), counts.clone(), lw,
                                  lws.clone()))
        if not snapshot and t > 1:
            c = counts.cpu()
            for i, s in enumerate(b.slots):
                st = s.prefill
                if c[i] > 1 and st is not None and s.pos >= cfg.window and \
                        st.done + int(c[i]) == len(st.feed):
                    snapshot.update(cache=tree_map(lambda x: x.clone(), cache), row=i,
                                    prefix=st.feed[:st.done + int(c[i])].copy(),
                                    args=(tokens.clone(), pos.clone(), counts.clone(), lw,
                                          lws.clone()))
                    break
        before = rl.launches
        out = step_fn(params_, cache, tokens, pos, counts, keys, lw, lws)
        per_forward.append((t, rl.launches - before))
        return out

    b._step_fn = observe
    for u, p in enumerate(prompts):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=32))
    torch.cuda.reset_peak_memory_stats()
    rl.launches = fa.launches = pa.launches = 0
    ticks = 0
    t0 = time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        ticks += 1
        if ticks > 2000:
            raise RuntimeError(f"{name}: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = rl.launches, (fa.launches, pa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tokens = sum(len(o) for o in outs.values())
    multi = sum(1 for t, _ in per_forward if t > 1)
    print(f"serving rg {name} ({cfg.n_layers} layers): {ticks} ticks, {b.forward_calls} "
          f"forwards ({multi} of T > 1), {n_tokens} generated tokens in {wall:.3f} s = "
          f"{n_tokens / wall:.2f} tok/s, peak memory {peak_gb:.2f} GB, weights init "
          f"{init_s:.2f} s, rg_lru kernel launches {launches}", flush=True)
    check(len(outs) == 10 and all(len(o) == 32 for o in outs.values()),
          f"{name}: not every request finished with 32 tokens")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs.values()),
          f"{name}: token ids outside the vocabulary")
    check(not b.failed, f"{name}: failed requests {[r.status for r in b.failed]}")
    b.audit()
    check(b.allocator.available == b.num_blocks and (b.tables == -1).all(),
          f"{name}: block leak")
    check(len(per_forward) == b.forward_calls and multi > 0,
          f"{name}: {len(per_forward)} observed forwards, {multi} of T > 1")
    wrong = [(t, n) for t, n in per_forward if n != (RG_GRIFFIN_LAYERS if t > 1 else 0)]
    check(not wrong, f"{name}: rg_lru launches per forward (T, launches) off: {wrong[:8]}")
    check(launches == RG_GRIFFIN_LAYERS * multi,
          f"{name}: {launches} rg_lru launches for {multi} forwards of T > 1")
    check(other == (0, 0), f"{name}: flash/paged kernels launched while serving: {other}")
    check(snapshot, f"{name}: no last chunk past the window was seen")
    check(not trace or (decode_snap and fullest_snap),
          f"{name}: no decode or no prefill sub-step was seen")

    # the snapshot sub-step again: with the kernel, and with only the
    # kernel swapped for its plain version
    tokens, pos, counts, lw, lws = snapshot["args"]
    live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    logits, real_rglru = {}, rl.rglru
    with torch.no_grad():
        for key in ("kernel", "plain"):
            cache = tree_map(lambda x: x.clone(), snapshot["cache"])
            if key == "plain":
                rl.rglru = rl.rglru_ref
            try:
                out = step_rows_full(b.params, b.cfg, cache, tokens, pos, counts, lw, lws)[0]
            finally:
                rl.rglru = real_rglru
            logits[key] = out
            del cache
    same = torch.equal(logits["kernel"][live], logits["plain"][live])
    r, prefix = snapshot["row"], snapshot["prefix"]
    c = int(counts[r])
    served = logits["kernel"][r, :c, :cfg.vocab_size].float()
    del logits
    # the row's whole prefix, cache-free; the clipped engine's reference
    # holds gamma at the ring's -alpha / 2048
    ref_cfg = cfg if method != "clipped_softmax" else \
        apply_method(full(), method, gamma=-method_kw["alpha"] / cfg.window)
    # ... keeping the first local_attn layer's post-RoPE keys, the first
    # attention() call's k (the griffin blocks before it call none)
    ref_keys = []
    real_attention = transformer.attention

    def keep_keys(q, k, v, *args, **kw):
        if not ref_keys:
            ref_keys.append(k[0].clone())
        return real_attention(q, k, v, *args, **kw)

    transformer.attention = keep_keys
    try:
        with torch.no_grad():
            full_logits, _ = model_apply(params, ref_cfg, {
                "tokens": torch.as_tensor(prefix, dtype=torch.long, device="cuda")[None]})
    finally:
        transformer.attention = real_attention
    ref = full_logits[0, -c:, :cfg.vocab_size].float()
    del full_logits
    def rel(a):
        return ((a - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()

    logit_rms = rel(served)
    agree = (served.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"serving rg {name}: prefill sub-step (counts {counts.tolist()}): logits with the "
          f"rg_lru kernel vs its plain version bitwise equal: {same}; row {r} (last chunk "
          f"of {c} at positions {int(pos[r])}..{int(pos[r]) + c - 1}, window {cfg.window}) vs "
          f"cache-free forward over its {len(prefix)}-token prefix: relative RMS "
          f"{logit_rms:.4f} (tol {RG_LOGIT_REL_RMS}), argmax agreement {agree:.4f}",
          flush=True)
    check(same, f"{name}: the rg_lru kernel changed the prefill logits")
    check(logit_rms <= RG_LOGIT_REL_RMS,
          f"{name}: served logits differ from the cache-free forward: relative RMS {logit_rms}")

    def leaves(cache, name_):
        return [leaf for path, leaf, _ in row_leaves(cache) if path[-1] == name_]

    # the first local_attn layer's ring of row r before the sub-step,
    # ordered by its pos_ids, against the cache-free keys at the same
    # positions; and the same ring rolled by one slot
    ring = ring_vs_keys(torch, snapshot["cache"], r, ref_keys[0])
    n_filled = ring["filled"]
    print(f"serving rg {name}: row {r}'s first local_attn ring ({n_filled} keys, positions "
          f"{ring['first']}..{ring['last']}) vs the cache-free forward's "
          f"post-RoPE keys at the same positions, relative RMS: correct "
          f"{ring['correct']:.3e} (tol {RG_RING_REL_RMS}), rolled one slot "
          f"{ring['rolled one slot']:.3e}", flush=True)
    check(n_filled == min(int(pos[r]), cfg.window),
          f"{name}: the ring holds {n_filled} keys before position {int(pos[r])}")
    check(ring["correct"] <= RG_RING_REL_RMS,
          f"{name}: the ring's keys differ from the cache-free forward's: {ring['correct']}")
    check(ring["rolled one slot"] > RG_RING_REL_RMS,
          f"{name}: the ring check cannot tell a ring rolled by one slot: {ring}")
    faults = {}
    if method == "clipped_softmax":
        def roll(cache):
            for k_or_v in ("k", "v"):
                for leaf in leaves(cache, k_or_v):
                    leaf.copy_(torch.roll(leaf, 1, dims=-3))

        mutate = {"ring emptied": lambda c: [x.fill_(-1) for x in leaves(c, "pos_ids")],
                  "h lost": lambda c: [x.zero_() for x in leaves(c, "h")],
                  "conv lost": lambda c: [x.zero_() for x in leaves(c, "conv")],
                  "gamma from max_len": None, "ring rolled one slot": roll}
        for fault in RG_FAULTS:
            cache = tree_map(lambda x: x.clone(), snapshot["cache"])
            run_cfg = b.cfg
            if mutate[fault] is None:
                run_cfg = apply_method(full(), method, gamma=-method_kw["alpha"] / b.L)
            else:
                mutate[fault](cache)
            with torch.no_grad():
                out = step_rows_full(b.params, run_cfg, cache, tokens, pos, counts, lw, lws)[0]
            faults[fault] = rel(out[r, :c, :cfg.vocab_size].float())
            del cache, out
        print(f"serving rg {name}: the same row with one fault put in, relative RMS: " +
              ", ".join(f"{k} {v:.4f}" for k, v in faults.items()), flush=True)
        # the ring rolled by one slot is held by the ring check above
        held = {k: v for k, v in faults.items() if k != "ring rolled one slot"}
        check(all(v > RG_LOGIT_REL_RMS for v in held.values()),
              f"{name}: the logits check cannot tell a fault from a correct read: {held}")
    result = dict(engine=name, layers=cfg.n_layers, ticks=ticks, forwards=len(per_forward),
                  multi_forwards=multi, tokens=n_tokens, wall_s=wall,
                  tok_per_s=n_tokens / wall, peak_gb=peak_gb, launches=launches,
                  logit_rel_rms=logit_rms, argmax_agreement=agree, init_s=init_s,
                  faults=faults, ring=ring)
    if trace:
        traces = trace_replays(
            torch, lambda cache, *args: step_rows_full(b.params, b.cfg, cache, *args),
            {"prefill": snapshot, "fullest prefill": fullest_snap, "decode": decode_snap},
            f"serving rg {name}", "sub-step")
        for kind, want in (("prefill", RG_GRIFFIN_LAYERS),
                           ("fullest prefill", RG_GRIFFIN_LAYERS), ("decode", 0)):
            ran = traces[kind]["family_kernels"]["RG-LRU scan"]
            check(ran == want, f"{name}: the traced {kind} sub-step ran {ran} RG-LRU "
                               f"kernels, not {want}")
        result.update(traces=traces)
    del b, snapshot, decode_snap, fullest_snap, served, ref, ref_keys
    torch.cuda.empty_cache()
    if gen:
        result.update(generate=phase_rg_generate(torch, np, rl, fa, pa, name, params, cfg))
    del params
    torch.cuda.empty_cache()
    return result


def phase_rg_generate(torch, np, rl, fa, pa, name, params, cfg):
    """``generate`` at recurrentgemma-9b's full width, 16 new tokens, on
    one prompt of 1024 tokens (one-shot prefill through the shared-pos
    ring write, ring of 1040) and one of 3000 (past the 2048-token window:
    chunked prefill, ring of 2048): the RG-LRU kernel once per Griffin
    layer on every forward of T > 1 and never at T = 1, no flash or paged
    launch (the ring reads are the reference's dense_attention), gate (a)
    with two faults: the decode step one position early, and the
    recurrent state h lost before it."""
    from repro_torch.models.transformer import row_leaves

    def lose_h(cache):
        for path, leaf, _ in row_leaves(cache):
            if path[-1] == "h":
                leaf.zero_()

    faults = {"decode at pos - 1": (cfg, -1, None), "h lost": (cfg, 0, lose_h)}
    rng = np.random.default_rng(2)
    out = {}
    for t in (1024, 3000):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, t)), device="cuda")
        toks, wall, peak, per_forward, served = run_generate(torch, params, cfg, prompt, 16,
                                                             (rl, fa, pa))
        want = [(f[0], RG_GRIFFIN_LAYERS if f[0] > 1 else 0, 0, 0) for f in per_forward]
        print(f"generate rg {name} ({cfg.n_layers} layers, 1 x {t} prompt tokens, 16 new): "
              f"{len(per_forward)} forwards (T {[f[0] for f in per_forward if f[0] > 1]} then "
              f"{sum(f[0] == 1 for f in per_forward)} of T 1), 16 tokens in {wall:.3f} s = "
              f"{16 / wall:.2f} tok/s, peak memory {peak:.2f} GB; (rg_lru, flash, paged) "
              f"launches per forward of T > 1: {sorted({f[1:] for f in per_forward if f[0] > 1})}, "
              f"of T 1: {sorted({f[1:] for f in per_forward if f[0] == 1})}", flush=True)
        check(tuple(toks.shape) == (1, t + 16) and
              bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"rg {name}: generate gave {tuple(toks.shape)} or ids outside the vocabulary")
        check(per_forward == want, f"rg {name}: generate's launches per forward off: "
                                   f"{per_forward}")
        gate = gate_decode_vs_prefill(torch, params, cfg, toks, t, 16, served, faults,
                                      f"generate rg {name} (prompt {t})")
        out[t] = dict(wall_s=wall, tok_per_s=16 / wall, peak_gb=peak, gate_a=gate,
                      forwards=len(per_forward),
                      rg_launches=sum(f[1] for f in per_forward))
        del toks, served
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the paper's evaluation at qwen3-14b full width
# ---------------------------------------------------------------------------
def count_fake_quant_sites(torch, cfg):
    """Fake-quant calls of one W8A8 forward of ``cfg``'s structure,
    counted on the CPU at a tiny width (the sites depend on the layer
    pattern, not on the widths): calibrate one batch, then count the calls
    of one 'apply'-mode forward."""
    from repro_torch.models.transformer import model_apply, model_init
    from repro_torch.quant import quantizer
    from repro_torch.quant.ptq import calibrate
    from repro_torch.quant.qconfig import QConfig

    tiny = dataclasses.replace(cfg, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                               d_ff=128, vocab_size=256, vocab_pad_to=1,
                               param_dtype=torch.float32, compute_dtype=torch.float32)
    if cfg.rglru is not None:
        tiny = dataclasses.replace(tiny, rglru=dataclasses.replace(cfg.rglru, width=64))
    if cfg.xlstm is not None:
        tiny = dataclasses.replace(tiny, xlstm=dataclasses.replace(cfg.xlstm, d_model=64))
    params = model_init(0, tiny, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if tiny.input_kind == "embeds":
        batch = {"embeds": torch.randn(1, 16, tiny.frontend_dim, generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, 256, (1, 16), generator=gen)}

    def apply_fn(p, b, ctx):
        return model_apply(p, tiny, b, ctx=ctx)[0]

    ctx = calibrate(apply_fn, params, [batch], QConfig(), num_batches=1)
    calls = []
    real = quantizer.fake_quant_kernel
    quantizer.fake_quant_kernel = lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    try:
        with torch.no_grad():
            apply_fn(params, batch, ctx)
    finally:
        quantizer.fake_quant_kernel = real
    return len(calls)


def qwen_cfg(method, **method_kw):
    """qwen3-14b at full width and QWEN_LAYERS layers with ``method``."""
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.qwen3_14b import full
    return apply_method(dataclasses.replace(full(), n_layers=QWEN_LAYERS), method, **method_kw)


def qwen_eval_cfg(method, **method_kw):
    """qwen3-14b at full width with ``method``, unrolled (as PTQ needs)."""
    return dataclasses.replace(qwen_cfg(method, **method_kw), scan_layers=False)


def held_layers(torch, fa, run):
    """``run()`` (a cache-free forward) with every flash call held against
    the kernel's plain version on the same inputs (P in f32), beside the
    plain version with P rounded to bf16 (the control). A layer whose
    plain output is exactly zero (the clipped softmax zeroes every
    probability of a near-uniform random-weight layer) must be exactly
    zero in the kernel too; it has no P to round. Returns (run's output,
    per-layer relative RMS, per-layer control, the zero layers)."""
    real_mha_flash, layer_rms, layer_control, zero_layers = fa.mha_flash, [], [], []

    def held(q, k, v, gate_pi=None, **kw):
        out = real_mha_flash(q, k, v, gate_pi, **kw)
        ref = fa.mha_flash_ref(q, k, v, gate_pi, **kw)
        if not ref.any():
            zero_layers.append(len(layer_rms))
            layer_rms.append(0.0 if not out.any() else float("inf"))
            layer_control.append(0.0)
            return out
        layer_rms.append(rel_rms(out, ref))
        with bf16_p(torch):
            layer_control.append(rel_rms(fa.mha_flash_ref(q, k, v, gate_pi, **kw), ref))
        return out

    fa.mha_flash = held
    try:
        out = run()
    finally:
        fa.mha_flash = real_mha_flash
    return out, layer_rms, layer_control, zero_layers


def phase_eval(torch, np, fa, fq, pa, im, name, cfg, kind="clm", seq=EVAL_SEQ, batch_size=1,
               layer_tol=FLASH_LAYER_REL_RMS, own_tol=FLASH_VS_OWN_PLAIN_REL_RMS,
               logit_tol=LOGIT_REL_RMS, data=None, params=None, moe_layer=False, rl=None):
    """The paper's evaluation protocol on ``cfg`` (``params``, or random
    weights from seed 0) over ``SyntheticLM`` batches of ``kind`` ("clm" or
    "mlm"), (batch_size, seq) each, or over ``data``'s ("frames":
    ``SeededEmbeds``, a per-position classification loss); the flash kernel
    held per layer (``layer_tol``) and in the logits (``own_tol`` against
    its plain version, ``logit_tol`` against dense_attention). A MoE
    config's logits gates hold the other forwards routed as the kernel's
    forward routed (``routing_taps``) and print the (layer, token) pairs
    they route to other experts when free; the forward with every MoE
    layer at capacity MOE_DROP_CF (claims dropped: a fault) must land above
    both bounds; with ``moe_layer``, phase 8a's checks of the MoE layer
    (``phase_moe_layer``) run on the first held-out batch. The flash
    checks cover the config's attention layers (recurrentgemma's
    local_attn; none in an xLSTM stack, whose three forwards would be one);
    with ``rl``, the RG-LRU kernel must launch once per Griffin layer on
    every forward."""
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import transformer
    from repro_torch.quant import quantizer
    from repro_torch.quant.ptq import calibrate, evaluate_perplexity
    from repro_torch.quant.qconfig import NO_QUANT, QConfig
    from repro_torch.train import TrainTask, evaluate
    from repro_torch.train.losses import loss_for
    from repro_torch.core.attention import dense_attention

    sites = count_fake_quant_sites(torch, cfg)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = transformer.model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    if data is None:
        data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                             batch_size=batch_size, seed=0))

    def batches(start, n):
        return [{k: torch.as_tensor(v).cuda() for k, v in data.batch(start + i, kind).items()}
                for i in range(n)]

    def apply_fn(p, batch, ctx):
        return transformer.model_apply(p, cfg, batch, ctx=ctx)[0]

    def loss_fn(p, batch, ctx):
        logits = apply_fn(p, batch, ctx if ctx is not None else NO_QUANT)
        return loss_for(kind)(logits, batch["labels"])

    cal, held_out = batches(5_000_000, CALIB_BATCHES), batches(10_000_000, EVAL_BATCHES)
    # the path, with every count at 0 just before it and read just after
    fa.launches = fq.launches = pa.launches = im.launches = 0
    if rl is not None:
        rl.launches = 0
    t0 = time.perf_counter()
    task = TrainTask(cfg=cfg, loss_kind="frames" if kind == "frames" else "clm")
    ppl, ostats = evaluate(task, params, data, EVAL_BATCHES, kind)
    torch.cuda.synchronize()
    fp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = calibrate(apply_fn, params, cal, QConfig(), num_batches=CALIB_BATCHES)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_ppl = evaluate_perplexity(loss_fn, params, held_out, ctx)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    launches = dict(flash=fa.launches, fake_quant=fq.launches, paged=pa.launches,
                    int8=im.launches)
    if rl is not None:
        launches["rg_lru"] = rl.launches
    n_attn = attn_layers(cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    forwards = 2 * EVAL_BATCHES + CALIB_BATCHES + EVAL_BATCHES
    tokens = EVAL_BATCHES * batch_size * seq
    print(f"eval {name} ({cfg.n_layers} layers, {kind}, batch {batch_size} x T {seq}): FP ppl "
          f"{ppl:.4f}, max "
          f"inf-norm {ostats['max_inf_norm']:.4f}, avg kurtosis {ostats['avg_kurtosis']:.4f}, "
          f"W8A8 ppl {q_ppl:.4f}; FP eval {fp_s:.3f} s ({tokens / fp_s:.1f} tok/s over "
          f"{2 * EVAL_BATCHES} forwards), calibration {calib_s:.3f} s, W8A8 eval {q_s:.3f} s "
          f"({tokens / q_s:.1f} tok/s); launches {launches} over {forwards} forwards, "
          f"{sites} fake-quant sites per W8A8 forward; weights init {init_s:.2f} s",
          flush=True)
    values = [ppl, q_ppl, ostats["max_inf_norm"], ostats["avg_kurtosis"]]
    check(all(np.isfinite(v) for v in values), f"{name}: non-finite evaluation {values}")
    check(ostats["max_inf_norm"] > 0, f"{name}: no attention-layer outputs were measured")
    check(launches["flash"] == n_attn * forwards,
          f"{name}: {launches['flash']} flash launches for {forwards} forwards")
    check(launches["fake_quant"] == sites * EVAL_BATCHES,
          f"{name}: {launches['fake_quant']} fake-quant launches, expected {sites} x "
          f"{EVAL_BATCHES}")
    check(launches["paged"] == 0 and launches["int8"] == 0,
          f"{name}: serving kernels launched during evaluation: {launches}")
    check(rl is None or launches["rg_lru"] == griffin_layers(cfg) * forwards,
          f"{name}: {launches.get('rg_lru')} rg_lru launches for {forwards} forwards")

    batch = held_out[0]
    moe = cfg.moe is not None
    flips = {}

    def routed(name, fn, force=None):
        # fn() with its MoE routing recorded (forced to ``force``); a
        # forced run is repeated free to count its routing flips
        if not moe:
            return fn(), None
        if force is not None:
            with routing_taps() as free:
                fn()
            flips[name] = routing_flips(force, free)
        with routing_taps(force) as taps:
            return fn(), taps

    with torch.no_grad():
        if n_attn:
            # one FP forward with the flash kernel (each layer held against the
            # plain version), one with the kernel's plain version in its place
            # (attention() reads fa.mha_flash at each call), and one with the
            # model's plain attention
            (kern, layer_rms, layer_control, zero_layers), kern_routes = routed(
                "kernel",
                lambda: held_layers(torch, fa, lambda: apply_fn(params, batch, NO_QUANT)))
            real_mha_flash = fa.mha_flash
            try:
                fa.mha_flash = fa.mha_flash_ref
                own, _ = routed("own", lambda: apply_fn(params, batch, NO_QUANT), kern_routes)
            finally:
                fa.mha_flash = real_mha_flash
            # over the real vocabulary: the padded columns hold -1e30 (hubert:
            # 504 classes padded to 512), which would swamp the RMS
            kern = kern[..., :cfg.vocab_size]
            own = own[..., :cfg.vocab_size]
            own_rms = rel_rms(kern, own)
            own_agree = (kern.argmax(-1) == own.argmax(-1)).float().mean().item()
            del own
            real_attention = transformer.attention
            transformer.attention = lambda q, k, v, c, q_offset=0, gate_pi=None: \
                dense_attention(q, k, v, c, q_offset=q_offset, gate_pi=gate_pi)
            try:
                plain, _ = routed("plain", lambda: apply_fn(params, batch, NO_QUANT),
                                  kern_routes)
            finally:
                transformer.attention = real_attention
            plain = plain[..., :cfg.vocab_size]
            logit_rms = rel_rms(kern, plain)
            agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        else:
            # no attention layer: the three forwards would be one
            kern = apply_fn(params, batch, NO_QUANT)[..., :cfg.vocab_size]
            layer_rms, layer_control, zero_layers = [], [], []
            own_rms = logit_rms = 0.0
            own_agree = agree = 1.0
        routing = ""
        if moe:
            fault_cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_DROP_CF))
            fault = transformer.model_apply(params, fault_cfg, batch)[0][..., :cfg.vocab_size]
            fault_rms = rel_rms(fault, plain)
            del fault
            routing = (f"; both plain forwards routed as the kernel's; free, they route "
                       f"(layer, token) pairs to other experts: its plain version "
                       f"{flips['own'][0]}, plain attention {flips['plain'][0]}, of "
                       f"{flips['own'][1]}; control, the kernel forward with every MoE layer "
                       f"at capacity {MOE_DROP_CF}, vs plain attention: relative RMS "
                       f"{fault_rms:.3e} (must exceed {max(own_tol, logit_tol)})")
        del kern
        if n_attn:
            del plain, kern_routes
        # one W8A8 forward with only the fake-quant kernel swapped for its
        # plain version: every site is bitwise, so the logits are
        q_kern = apply_fn(params, batch, ctx)
        quantizer.fake_quant_kernel = fq.fake_quant_ref
        try:
            q_plain = apply_fn(params, batch, ctx)
        finally:
            quantizer.fake_quant_kernel = fq.fake_quant
        same = torch.equal(q_kern, q_plain)
        del q_kern, q_plain
    wall = time.perf_counter() - t_phase
    print(f"eval {name}: attention per layer, flash kernel vs its plain version on the "
          f"same inputs: relative RMS max {max(layer_rms, default=0.0):.3e}, mean "
          f"{sum(layer_rms) / max(len(layer_rms), 1):.3e} over {len(layer_rms)} of "
          f"{n_attn} layers (tol {layer_tol:.3e}); the plain version with bf16 P: relative "
          f"RMS max {max(layer_control, default=0.0):.3e}, min "
          f"{min(layer_control, default=0.0):.3e}, "
          f"{sum(v > layer_tol for v in layer_control)} layers above the tol; layers whose "
          f"attention output is exactly zero: {zero_layers or 'none'}; "
          f"FP logits, flash kernel vs its plain version: "
          f"relative RMS {own_rms:.3e} (tol {own_tol}), argmax agreement "
          f"{own_agree:.4f}; flash kernel vs plain attention (dense_attention): relative "
          f"RMS {logit_rms:.3e} (tol {logit_tol}), argmax agreement {agree:.4f}{routing}; "
          f"W8A8 logits with the fake-quant kernel vs its plain version bitwise equal: "
          f"{same}; phase {wall:.1f} s, peak memory {peak_gb:.2f} GB", flush=True)
    check(len(layer_rms) == n_attn and max(layer_rms, default=0.0) <= layer_tol,
          f"{name}: a layer's flash output differs from its plain version: {layer_rms}")
    check(not n_attn or max(layer_control, default=0.0) > layer_tol or
          len(zero_layers) == n_attn,
          f"{name}: no layer tells bf16 P from f32 P at the bound: {layer_control}")
    check(own_rms <= own_tol,
          f"{name}: flash kernel and its plain version give different logits: relative "
          f"RMS {own_rms}")
    check(logit_rms <= logit_tol, f"{name}: flash and plain attention logits differ: "
                                    f"relative RMS {logit_rms}")
    check(same, f"{name}: the fake-quant kernel changed the W8A8 logits")
    extra = {}
    if moe:
        check(fault_rms > max(own_tol, logit_tol),
              f"{name}: the MoE fault (capacity {MOE_DROP_CF}) lands within the logits "
              f"bounds: {fault_rms}")
        extra = dict(routing_flips_own=flips["own"], routing_flips_plain=flips["plain"],
                     moe_fault_rel_rms=fault_rms)
        if moe_layer:
            extra["moe_layer"] = phase_moe_layer(torch, name, params, cfg, batch["tokens"])
    del params, ctx, cal, held_out, batch
    torch.cuda.empty_cache()
    return dict(model=name, layers=cfg.n_layers, fp_ppl=ppl, w8a8_ppl=q_ppl, **extra,
                max_inf_norm=ostats["max_inf_norm"], avg_kurtosis=ostats["avg_kurtosis"],
                fp_eval_s=fp_s, calib_s=calib_s, w8a8_eval_s=q_s,
                fp_tok_per_s=tokens / fp_s, w8a8_tok_per_s=tokens / q_s, wall_s=wall,
                peak_gb=peak_gb, init_s=init_s, sites=sites, forwards=forwards,
                logit_rel_rms=logit_rms, argmax_agreement=agree,
                own_plain_rel_rms=own_rms, own_plain_argmax_agreement=own_agree,
                layer_rel_rms_max=max(layer_rms, default=0.0),
                layer_bf16_p_rel_rms_max=max(layer_control, default=0.0), attn_layers=n_attn,
                **{
                    f"{k}_launches": v for k, v in launches.items()})


# ---------------------------------------------------------------------------
# phase 5b: the paper's own models at full width (BERT-base, OPT-125m)
# ---------------------------------------------------------------------------
# The paper models run in f32 (the reference's params and compute), so the
# flash kernel takes its CUDA-core route and its plain version computes the
# same f32 products summed in another order: a layer's output may differ by
# a few f32 ulps (relative RMS ~1e-7), where P rounded to bf16 (the
# control, which must land above) reads ~1e-3. Over 12 f32 layers the
# logits against the kernel's plain version or dense_attention: ~1e-6. A
# wrong mask, gamma or scale moves either by percents.
PAPER_LAYER_REL_RMS = 1e-5
PAPER_LOGIT_REL_RMS = 1e-4
# (family, data kind, T, batch) of the evaluation: BERT-base masked-LM at
# its max_seq_len 512, batch 8; OPT-125m causal LM at its 2048, batch 1
PAPER_EVALS = (("bert", "mlm", 512, 8), ("opt", "clm", EVAL_SEQ, 1))
METHODS = (("vanilla", "vanilla", {}), ("clipped", "clipped_softmax", {"alpha": 4.0}),
           ("gated", "gated_attention", {}))
# OPT-125m serving, kernel path against plain path at a tick: both f32
# (the paged kernel's CUDA-core route, or flash's on the dense cache,
# against dense_attention), so the logits differ by f32 ulps carried
# through 12 layers; a wrong block, mask, position or gamma moves them by
# their own scale. Under W8A8 those ulps move rare activations across an
# int8 code edge. Each gate reads two controls that must land above it:
# the plain path with P rounded to bf16, and the tick run one position
# early (every row's writes and reads one slot early). Measured on an
# H100 80GB HBM3 at 700 W, at the mixed tick and the tick past the table:
# fp engines 9.7e-7..1.21e-6, their bf16-P controls 1.82e-4..4.21e-4;
# W8A8 6.04e-3 / 7.88e-5, its bf16-P control 2.49e-2 / 2.42e-2; one
# position early 0.15..0.19 on every engine. Bounded at 1e-5 (8x above
# the largest fp reading, 18x below its smallest control) and 0.012 (2x
# above the W8A8 reading, 2x below its control).
OPT_TICK_REL_RMS = 1e-5
OPT_W8A8_TICK_REL_RMS = 0.012
OPT_MAX_LEN = 2048
# The paper's mechanism (Bondarenko et al., Sec. 3; tests/test_int8_
# serving_quality.py's injection): two fc1 channels amplified by M, the
# matching fc2 rows scaled by 1/M, in every layer. The fp function is
# unchanged, the fc2 input's per-tensor range grows about M-fold. The
# first run (H100 80GB HBM3, 700 W) read W8A8 vs fp logits 0.1412 clean,
# 1.4023 injected (9.9x; the fc2 input's int8 step 1.73e-2 -> 2.69): the
# margin is 4x, 2.5x under that reading, far above the 1x of a path that
# ignored the ranges.
OUTLIER_CHANNELS, OUTLIER_M = (3, 11), 300.0
OUTLIER_MARGIN = 4.0


def paper_cfg(family, method, **method_kw):
    from repro_torch.configs import paper_models
    from repro_torch.configs.base import apply_method
    make = {"bert": paper_models.bert_base, "opt": paper_models.opt_125m,
            "vit": paper_models.vit_s16}[family]
    return apply_method(make(), method, **method_kw)


def opt_requests(np, vocab):
    """One 1900-token prompt that decodes 148 tokens (positions up to
    2046, the position table's last rows); seven short prompts (32..128,
    32 new) that finish while it decodes; four long ones (1000..1800, 32
    new) that then prefill in chunks of up to 256 beside its decode, so
    those ticks' padded tails run past position 2047. (prompt, new)."""
    rng = np.random.default_rng(1)
    lengths = [1900] + rng.integers(32, 129, 7).tolist() + rng.integers(1000, 1801, 4).tolist()
    new = [OPT_MAX_LEN - 1900] + [32] * 11
    return [(rng.integers(0, vocab, size=int(n)).astype(np.int32), m)
            for n, m in zip(lengths, new)]


def inject_outliers(params):
    """The function-preserving channel amplification: a copy of the
    params tree whose every layer's mlp up (w columns, b entries) carry
    OUTLIER_CHANNELS times OUTLIER_M and mlp down (w rows) 1/OUTLIER_M."""
    from repro_torch.nn.module import tree_map
    out = tree_map(lambda x: x.clone(), params)
    for layer in out["layers"]:
        mlp = layer["b0"]["mlp"]
        for c in OUTLIER_CHANNELS:
            mlp["up"]["w"][:, c] *= OUTLIER_M
            mlp["up"]["b"][c] *= OUTLIER_M
            mlp["down"]["w"][c, :] *= 1.0 / OUTLIER_M
    return out


def phase_outlier_contrast(torch, np):
    """On OPT-125m (vanilla, random weights from seed 0) and on the same
    weights with outliers injected: the W8A8 engine's set-up (its
    calibration on synthetic batches, int8 weights attached) and one
    cache-free forward of 8 x 512 tokens through the int8 kernel, against
    the fp forward. Returns the two relative RMS values."""
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.models.transformer import model_apply, model_init
    from repro_torch.quant.int8_weights import attach_int8_weights
    from repro_torch.quant.qconfig import QConfig
    from repro_torch.serving import scheduler as sched

    cfg = paper_cfg("opt", "vanilla")
    clean = model_init(0, cfg, device="cuda")
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size,
                                         seq_len=min(512, cfg.max_seq_len), batch_size=8, seed=0))
    batch = {"tokens": torch.as_tensor(data.batch(20_000_000, "clm")["tokens"]).cuda()}
    res, fp = {}, {}
    with torch.no_grad():
        for name, params in (("clean", clean), ("injected", inject_outliers(clean))):
            ctx = sched._calibrate_engine(params, cfg, QConfig(), OPT_MAX_LEN, 4,
                                          params["embed"]["table"].device)
            fp[name] = model_apply(params, cfg, batch)[0][..., :cfg.vocab_size]
            q8 = model_apply(attach_int8_weights(params), cfg, batch, ctx=ctx)[0]
            q8 = q8[..., :cfg.vocab_size]
            agree = (q8.argmax(-1) == fp[name].argmax(-1)).float().mean().item()
            down = ctx.act_qparams("layer_attn0/mlp/down.in")
            res[name] = dict(rel_rms=rel_rms(q8, fp[name]), argmax_agreement=agree,
                             down_in_scale=down[0])
            print(f"outlier contrast, opt-125m {name}: W8A8 vs fp logits relative RMS "
                  f"{res[name]['rel_rms']:.4f}, argmax agreement {agree:.4f}; the fc2 input's "
                  f"int8 step {down[0]:.4e}", flush=True)
            del q8, ctx
    same_fp = rel_rms(fp["injected"], fp["clean"])
    ratio = res["injected"]["rel_rms"] / res["clean"]["rel_rms"]
    print(f"outlier contrast: fp logits injected vs clean relative RMS {same_fp:.3e} (the "
          f"injection preserves the fp function); W8A8 error injected / clean {ratio:.2f} "
          f"(margin {OUTLIER_MARGIN})", flush=True)
    check(same_fp <= PAPER_LOGIT_REL_RMS, f"the injection changed the fp function: {same_fp}")
    check(ratio > OUTLIER_MARGIN, f"the injected model's W8A8 error is not above the clean "
                                  f"one's by {OUTLIER_MARGIN}x: {res}")
    del clean, fp
    torch.cuda.empty_cache()
    return dict(res, fp_injected_vs_clean=same_fp, ratio=ratio)


# ---------------------------------------------------------------------------
# phase 6: training, through the flash-attention backward kernel
# ---------------------------------------------------------------------------
# (name, B, T, Hq, Hkv, Dh, causal) of phase 6a: Dh 32 both ways, BERT-base's
# and OPT-125m's training shapes, one GQA case, and ViT-S/16's (64 images
# of 197 patches: a length no tile of 64 divides)
BWD_SHAPES = [("dh32 causal", 8, 512, 4, 4, 32, True), ("dh32", 8, 512, 4, 4, 32, False),
              ("bert-base", 8, 512, 12, 12, 64, False), ("opt-125m", 2, 2048, 12, 12, 64, True),
              ("gqa", 1, 512, 8, 2, 64, True), ("vit-s16", 64, 197, 6, 6, 64, False)]
BWD_VARIANTS = ("vanilla", "clipped", "gated")
BWD_ALPHA = 4.0
# Phase 6a's bound on each gradient (dq, dk, dv, dgate): the relative RMS of
# the kernel's against attention_bwd_ref's on the same inputs, both f32. The
# control, the plain version with P and dS rounded to bf16 before their
# products (what a kernel feeding them to bf16 tensor cores as one operand
# would compute), must land above it in every case.
# Measured on an H100 80GB HBM3 at 700 W: the first, CUDA-core design
# 9.9e-8..5.9e-7 over every case and gradient, the 3xTF32 redesign
# 2.8e-7..1.3e-6, the control 1.52e-3..1.78e-3. Bounded at 1e-5: 7.7x
# above the redesign's largest, 150x below the control; a wrong mask,
# clip indicator or D_i moves a gradient by O(1).
BWD_REL_RMS = 1e-5
# Phase 6a's bound on the row statistics the forward saves for the
# backward ((m, max(Z, 1e-30)) of every row, each plane's relative RMS)
# against attention_stats_ref on the same inputs; the control, the same
# statistics of q rounded to bf16 (what a forward reading q in bf16 would
# save), must land above it. Measured on an H100 80GB HBM3 at 700 W: m
# 0 (bitwise), Z 6.4e-8..9.0e-8; the control 6.2e-4..1.8e-3.
STATS_REL_RMS = 1e-6
# The backward's times in its first design (f32 CUDA cores, three
# launches that recompute the forward), as PERF.md's kernel table records
# them (NVIDIA H100 80GB HBM3, 700 W), printed beside phase 6c's readings
# of the redesign
CUDA_CORE_BWD_MS = {("bert-base", "vanilla"): 1.5407, ("bert-base", "clipped"): 1.9160,
               ("opt-125m", "vanilla"): 3.4911, ("opt-125m", "clipped"): 4.3544,
               ("dh32 causal", "vanilla"): 0.2506, ("dh32", "vanilla"): 0.2536,
               ("gqa", "vanilla"): 0.5792}
# Phase 6b: the paper models trained at full width, f32, from seed 0
TRAIN_RUNS = (("bert", "mlm", 512, 8), ("opt", "clm", 2048, 2))
TRAIN_LR = 3e-4
TRAIN_HALF = 4                     # k: 2k uninterrupted steps, a restart at k
# The synthetic chain's token ids, the first 4096 of the model's
# vocabulary. Over the full vocabularies each id appears ~0.1 times a
# batch and 16 steps do not move the loss (measured on an H100 80GB HBM3
# at 700 W, lr 1e-4..1e-3 with and without warmup: BERT-base's mean of
# the last 4 losses 10.39..10.49 against 10.37..10.44 for the first 4,
# OPT-125m's 10.83..10.99 against 10.83..10.85); over 4096 ids at lr 3e-4
# it falls from 10.33 to 9.23 (BERT) and 10.56 to 8.53 (OPT).
TRAIN_DATA_VOCAB = 4096
# Phase 6b's step-vs-plain gate: step 1's loss and the whole gradient (all
# parameters at once; relative RMS) through the kernels against the same
# step with mha_flash_ref (the plain attention, differentiated by autograd)
# in the flash kernel's place, both f32; the control, that plain path with
# P rounded to bf16, must land above. The two forwards differ by f32 ulps,
# and where the model has a kink an ulp can decide a branch: a ReLU
# pre-activation near zero (OPT's MLP) or a probability near the clip's
# edge (the clipped softmax's indicator) takes the other side and moves
# the gradients below it far more than the backward kernel's own rounding
# does (per parameter up to 1.7e-3 on BERT clipped, 1.7e-3 on OPT; BERT's
# GELU has no kink: 5e-6); the whole gradient averages such rare jumps out.
# Measured on an H100 80GB HBM3 at 700 W, kernel / control: BERT vanilla
# 1.8e-6 / 4.9e-4, gated 1.8e-6 / 3.2e-4, clipped 1.2e-4 / 1.6e-3; OPT
# vanilla 4.0e-4 / 1.0e-2, clipped 4.4e-4 / 9.4e-3, gated 5.6e-4 / 7.4e-3.
# Each bound sits 3x or more above its readings and below its controls.
# ViT-S/16 (f32, pre-LN, GELU), measured on the same card: vanilla 3.9e-7 /
# 3.3e-5, gated 3.9e-7 / 1.9e-5, clipped 6.8e-6 / 2.7e-5; its bounds sit
# 13x above the first two readings and 2.2x above the clipped one, and
# 1.8x..6.6x below the controls.
STEP_GRAD_REL_RMS = {("bert", "vanilla"): 2e-5, ("bert", "gated_attention"): 2e-5,
                     ("bert", "clipped_softmax"): 4e-4, ("opt", "vanilla"): 2e-3,
                     ("opt", "clipped_softmax"): 2e-3, ("opt", "gated_attention"): 2e-3,
                     ("vit", "vanilla"): 5e-6, ("vit", "gated_attention"): 5e-6,
                     ("vit", "clipped_softmax"): 1.5e-5}
# BERT's layer 0 reads the raw embeddings (RMS ~0.03: the config has no
# embedding LayerNorm), so even sharpened its scores stay ~1e-3 and every
# clipped probability clips: no gradient reaches its q and k there.
STEP_DEAD_LAYERS = {("bert", "clipped_softmax")}
# The same comparison per attention leaf (each layer's q, k, v, o and gate
# weights and the biases but the key's, whose gradient is zero in exact
# arithmetic): the leaves the backward kernel's dq, dk, dv and dgate feed
# first, where an error confined to the attention would show and the
# whole gradient, led by the embedding, head and MLP gradients, would hide
# it. Every such leaf's relative RMS must stay within the run's bound and
# within STEP_ATTN_CONTROL_SHARE of its own control's reading. A single
# bound cannot sit below every leaf's control: the clip-edge and ReLU
# flips above move BERT clipped's layer-10 k weights by 1.7e-3 while
# layer 11's o bias reads 9.9e-5 under the control.
# Measured on an H100 80GB HBM3 at 700 W, the largest leaf reading and
# the least ratio control / reading over the leaves: BERT vanilla 4.7e-6,
# 153; gated 4.2e-6, 107 (the least control 6.5e-5); clipped 1.7e-3, 5.2;
# OPT vanilla 7.9e-4, 12.9; clipped 8.5e-4, 6.7; gated 1.3e-3, 5.2; ViT
# vanilla 1.7e-6, 41.6; gated 1.5e-6, 22.7; clipped 2.9e-3, 1.8. Each
# bound sits 2x or more above its largest reading (BERT vanilla and gated
# 3x below their least control too); the share leaves 2.6x.
STEP_ATTN_LEAF = re.compile(r"^layers/\d+/b0/((q|k|v|o|gate)/w|(q|v|o|gate)/b)$")
STEP_ATTN_LEAF_REL = {("bert", "vanilla"): 2e-5, ("bert", "gated_attention"): 2e-5,
                      ("bert", "clipped_softmax"): 5e-3, ("opt", "vanilla"): 3e-3,
                      ("opt", "clipped_softmax"): 3e-3, ("opt", "gated_attention"): 3e-3,
                      ("vit", "vanilla"): 1e-5, ("vit", "gated_attention"): 1e-5,
                      ("vit", "clipped_softmax"): 5e-3}
STEP_ATTN_CONTROL_SHARE = 0.5
# ViT-S/16 clipped: the clip-edge flips move five q/k leaves of layers 3 and
# 9 by 1.3e-3..2.9e-3, 0.53..0.56 of their controls (2.4e-3..5.1e-3; the
# BERT and OPT runs' flips stay below 0.2 of theirs); its share is 0.75.
# The other leaves read 1.4e-5 (median) against controls 50x above.
STEP_ATTN_CONTROL_SHARE_OF = {("vit", "clipped_softmax"): 0.75}
STEP_LOSS_REL = 1e-6
# Random init attends almost uniformly (scores of RMS ~0.3 for BERT-base,
# ~0.03 for OPT-125m's std 0.006), so at alpha 4 every clipped probability
# clips and the attention passes no gradient: the gate would compare
# nothing of the backward kernel. Its weights get every layer's q and k
# projections scaled by this factor (scores by its square), so that rows
# are peaked and some probabilities stay unclipped; the gate requires a
# nonzero gradient on every layer's k weights (which only the attention's
# dS reaches).
STEP_QK_SCALE = {"bert": 2.5, "opt": 7.0, "vit": 2.5}


def bwd_case(torch, b, t, hq, hkv, dh, causal, variant, seed):
    """Inputs of one backward call at (B, T, Hq/Hkv, Dh): q, k, v ~ N(0, 1)
    (s ~ N(0, 1), so a few percent of a clipped row's entries stay
    unclipped at alpha 4), gate sigmoid(N(0, 1)), dO ~ N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    gamma = -BWD_ALPHA / t if variant == "clipped" else 0.0
    return dict(q=rnd(b, t, hq, dh), k=rnd(b, t, hkv, dh), v=rnd(b, t, hkv, dh),
                gate=torch.sigmoid(rnd(b, t, hq)) if variant == "gated" else None,
                dout=rnd(b, t, hq, dh), causal=causal, gamma=gamma, zeta=1.0)


def bf16_ds(torch):
    """A mode under which attention_bwd_ref rounds the first operand of
    every product over keys or queries (P~ in u and dv, dS in dq and dk)
    to bf16: the control of phase 6a."""
    from torch.overrides import TorchFunctionMode

    class Bf16Ds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.einsum and args[0].startswith("bhgqk,"):
                args = (args[0], args[1].bfloat16().float(), *args[2:])
            return func(*args, **(kwargs or {}))

    return Bf16Ds()


def unclipped_share(torch, c):
    """Share of the visible (query, key) pairs whose clipped probability
    lies strictly inside (0, 1), where the clip passes a gradient."""
    b, t, hq, dh = c["q"].shape
    g = hq // c["k"].shape[2]
    qs = (c["q"] * dh ** -0.5).reshape(b, t, -1, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, c["k"])
    mask = torch.ones((t, t), dtype=torch.bool, device="cuda")
    if c["causal"]:
        mask = torch.tril(mask)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    x = (1.0 - c["gamma"]) * p + c["gamma"]
    return (((x > 0) & (x < 1) & mask).sum() / (mask.sum() * b * hq)).item()


def bwd_bound_ms(c):
    """Least time of one backward call on an H100, for the kernel's route
    and for f32 CUDA cores: 10 flops per visible (query, key) pair and head
    column (S, dP~ = gV^T, dv, dq, dk; every variant: D_i = sum_j p_ij
    dp_ij is a scalar per pair, and u and (m, Z) come saved from the
    forward), each f32 product three TF32 ones at 495 TFLOP/s (the route's
    3xTF32 wgmma: an effective 165 TFLOP/s), or the same at 67 TFLOP/s f32;
    against the bytes of q, k, v, dO, u, the statistics and gate in and dq,
    dk, dv, dgate out at 3.35 TB/s. Returns (route bound ms, bound_by, f32
    CUDA-core bound ms)."""
    b, t, hq, dh = c["q"].shape
    hkv = c["k"].shape[2]
    pairs = b * hq * (t * (t + 1) // 2 if c["causal"] else t * t)
    flops = 10 * pairs * dh
    nbytes = 4 * (4 * b * t * hq * dh + 4 * b * t * hkv * dh + 2 * b * t * hq
                  + (2 * b * t * hq if c["gate"] is not None else 0))
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            max(flops / F32_FLOPS, t_bytes) * 1e3)


def phase_bwd_checks(torch, fa):
    """Phase 6a: at BWD_SHAPES x BWD_VARIANTS the forward kernel with the
    row statistics (out bitwise the plain forward call's; the statistics
    against attention_stats_ref), then the backward kernel on what it
    saved, against attention_bwd_ref; bitwise repeatable; clipped cases
    with unclipped entries. Returns the largest max abs error."""
    worst = 0.0
    for (name, b, t, hq, hkv, dh, causal), variant in (
            (s, v) for s in BWD_SHAPES for v in BWD_VARIANTS):
        c = bwd_case(torch, b, t, hq, hkv, dh, causal, variant, seed=len(name) + t)
        args = (c["q"], c["k"], c["v"], c["gate"], c["dout"])
        kw = dict(causal=causal, gamma=c["gamma"], zeta=1.0)
        out, u, stats = fa._launch_saved(*args[:4], **kw)
        plain_call = fa._launch(*args[:4], 0, window=None, softcap=None, **kw)
        st_ref = fa.attention_stats_ref(c["q"], c["k"], causal=causal)
        st_ctrl = fa.attention_stats_ref(c["q"].bfloat16().float(), c["k"], causal=causal)
        st_err = [rel_rms(stats[i], st_ref[i]) for i in range(2)]
        st_ctl = [rel_rms(st_ctrl[i], st_ref[i]) for i in range(2)]
        check(torch.equal(out, plain_call), f"bwd {name} {variant}: the forward with statistics "
                                            f"differs from the plain forward call")
        check(max(st_err) <= STATS_REL_RMS < min(st_ctl),
              f"bwd {name} {variant}: statistics (m, Z) relative RMS {st_err} (control "
              f"{st_ctl}) against the bound {STATS_REL_RMS}")
        kern = fa._launch_bwd(*args[:4], u, c["dout"], stats, **kw)
        again = fa._launch_bwd(*args[:4], u, c["dout"], stats, **kw)
        torch.cuda.synchronize()
        ref = fa.attention_bwd_ref(*args, **kw)
        with bf16_ds(torch):
            ctrl = fa.attention_bwd_ref(*args, **kw)
        names = ("dq", "dk", "dv", "dgate")
        rows = []
        for gname, kg, ag, rg, cg in zip(names, kern, again, ref, ctrl):
            if rg is None:
                continue
            err, control = rel_rms(kg, rg), rel_rms(cg, rg)
            worst = max(worst, (kg - rg).abs().max().item())
            check(torch.isfinite(kg).all().item(), f"bwd {name} {variant}: {gname} not finite")
            check(torch.equal(kg, ag), f"bwd {name} {variant}: {gname} differs between calls")
            check(err <= BWD_REL_RMS < control,
                  f"bwd {name} {variant}: {gname} relative RMS {err:.3e} (control "
                  f"{control:.3e}) against the bound {BWD_REL_RMS}")
            rows.append(f"{gname} {err:.3e} (control {control:.3e})")
        share = ""
        if variant == "clipped":
            frac = unclipped_share(torch, c)
            check(frac > 0, f"bwd {name} clipped: every probability clips (vacuous)")
            share = f"; unclipped share {frac:.4f}"
        print(f"flash bwd {name} ({b}, {t}, {hq}/{hkv}, {dh}) "
              f"{'causal' if causal else 'non-causal'} {variant}: saved m {st_err[0]:.2e}, Z "
              f"{st_err[1]:.2e} (control {st_ctl[0]:.2e}, {st_ctl[1]:.2e}; bound "
              f"{STATS_REL_RMS}), the forward bitwise unchanged; {'; '.join(rows)}; "
              f"bitwise repeatable{share}", flush=True)
        del kern, again, ref, ctrl, c, out, u, stats, plain_call, st_ref, st_ctrl
    torch.cuda.empty_cache()
    return worst


def phase_bwd_times(torch, fa):
    """Phase 6c: device times of the backward kernel (on what the forward
    saved), its plain version and torch autograd through
    F.scaled_dot_product_attention in f32 (a yardstick the port never
    calls), beside the first design's time, the route's bound and the f32 CUDA-core
    bound, at BWD_SHAPES. Returns {(name, variant): times}."""
    import torch.nn.functional as F
    out = {}
    for (name, b, t, hq, hkv, dh, causal), variant in (
            (s, v) for s in BWD_SHAPES for v in ("vanilla", "clipped")):
        cs = [bwd_case(torch, b, t, hq, hkv, dh, causal, variant, seed=90 + i) for i in range(2)]
        kw = dict(causal=causal, gamma=cs[0]["gamma"], zeta=1.0)
        for c in cs:
            _, c["u"], c["stats"] = fa._launch_saved(c["q"], c["k"], c["v"], c["gate"], **kw)
        kern = lambda c: fa._launch_bwd(c["q"], c["k"], c["v"], c["gate"], c["u"],  # noqa: E731
                                        c["dout"], c["stats"], **kw)
        ms = device_ms(torch, [lambda c=c: kern(c) for c in cs], 10)
        plain = device_ms(torch, [lambda c=c: fa.attention_bwd_ref(
            c["q"], c["k"], c["v"], c["gate"], c["dout"], **kw) for c in cs], 3)
        lib = None
        if variant == "vanilla":
            def sdpa(c):
                q, k, v = (c[x].transpose(1, 2).detach().requires_grad_(True)
                           for x in ("q", "k", "v"))
                o = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                   enable_gqa=hq != hkv)
                return o, (q, k, v), c["dout"].transpose(1, 2)
            graphs = [sdpa(c) for c in cs]
            lib = device_ms(torch, [lambda g=g: torch.autograd.grad(g[0], g[1], g[2],
                                                                   retain_graph=True)
                                    for g in graphs], 10)
            del graphs
        bound, by, f32_bound = bwd_bound_ms(cs[0])
        out[(name, variant)] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                    library_ms=lib)
        was = CUDA_CORE_BWD_MS.get((name, variant))
        print(f"flash bwd time {name} ({b}, {t}, {hq}/{hkv}, {dh}) f32 {variant}: kernel "
              f"{ms:.4f} ms (the first design's: "
              f"{'not recorded' if was is None else f'{was:.4f} ms, {was / ms:.2f}x'}), plain "
              f"{plain:.4f} ms ({plain / ms:.2f}x), SDPA backward "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms ({by}; "
              f"3xTF32 at 495 TFLOP/s), f32 CUDA-core bound {f32_bound:.4f} ms", flush=True)
        check(ms >= bound, f"bwd {name} {variant}: {ms} ms below the route's bound {bound}")
        del cs
        torch.cuda.empty_cache()
    return out


def sharpen(params, c):
    """The params tree with every layer's q and k projections (weights and
    biases) multiplied by c, in place."""
    for layer in params["layers"]:
        for name in ("q", "k"):
            for leaf in layer["b0"][name].values():
                leaf.mul_(c)
    return params


def phase_train_step_vs_plain(torch, fa, task, params, batch, who, bound, leaf_bound,
                              min_live, share=STEP_ATTN_CONTROL_SHARE):
    """Phase 6b's first gate: step 1's loss and gradients through the
    kernels against the plain attention path (``mha_flash_ref`` under
    autograd in the flash kernel's place) on the same weights and batch,
    the whole gradient at ``bound`` and each attention leaf at
    ``leaf_bound``; the same plain path with P rounded to bf16 is the
    control. A MoE config's plain steps route as the kernel step routed
    (``routing_taps``)."""
    from repro_torch.nn.module import flatten_params
    from repro_torch.train.step import _grads
    moe = task.cfg.moe is not None
    real = fa.mha_flash
    fa.launches = fa.bwd_launches = 0
    with routing_taps() if moe else contextlib.nullcontext() as routes:
        loss_k, _, g_k = _grads(params, task, batch)
    launched = (fa.launches, fa.bwd_launches)
    try:
        fa.mha_flash = fa.mha_flash_ref
        with routing_taps(routes) if moe else contextlib.nullcontext():
            loss_p, _, g_p = _grads(params, task, batch)
        with bf16_p(torch, matmuls=False), \
                routing_taps(routes) if moe else contextlib.nullcontext():
            _, _, g_c = _grads(params, task, batch)
    finally:
        fa.mha_flash = real
    n_layers = task.cfg.n_layers
    check(launched == (n_layers, n_layers),
          f"{who}: step through the kernels launched (flash, bwd) {launched}")
    # each gradient's difference RMS relative to its own RMS, except the
    # key bias's: its gradient is zero in exact arithmetic (a shift common
    # to a row's scores leaves the softmax unchanged), rounding noise on
    # both paths, so its difference is taken relative to the RMS of the
    # whole gradient
    flat_p, flat_c = dict(flatten_params(g_p)), dict(flatten_params(g_c))
    total = torch.sqrt(sum(g.square().sum() for g in flat_p.values())
                       / sum(g.numel() for g in flat_p.values())).item()

    def rel(a, path):
        b = flat_p[path]
        if re.search(r"/k/b$", path):
            return (a - b).square().mean().sqrt().item() / total
        return rel_rms(a, b)

    def whole(tree):
        # the relative RMS of the whole gradient (every parameter at once)
        flat = dict(flatten_params(tree))
        num = sum((flat[p] - g).square().sum() for p, g in flat_p.items())
        return (num / sum(g.square().sum() for g in flat_p.values())).sqrt().item()

    errs = {p: rel(g, p) for p, g in flatten_params(g_k) if flat_p[p].abs().max().item() > 0}
    ctrl = {p: rel(flat_c[p], p) for p in errs}
    worst = max(errs, key=errs.get)
    err_all, ctrl_all = whole(g_k), whole(g_c)
    attn = [p for p in errs if STEP_ATTN_LEAF.match(p)]
    attn_worst = max(attn, key=errs.get)
    ratio = {p: ctrl[p] / max(errs[p], 1e-30) for p in attn}
    attn_near = min(attn, key=ratio.get)
    attn_out = [p for p in attn if not errs[p] <= min(leaf_bound, share * ctrl[p])]
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    live_k = sum(flat_p[p].abs().max().item() > 0 for p in flat_p if re.search(r"/k/w$", p))
    print(f"train {who}: step 1 through the kernels vs the plain attention path: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {loss_err:.2e}); the whole "
          f"gradient's relative RMS {err_all:.3e} (bound {bound}; control, P in bf16, "
          f"{ctrl_all:.3e}); per parameter max {errs[worst]:.3e} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e}, control max "
          f"{max(ctrl.values()):.3e}; attention leaves ({len(attn)}): max "
          f"{errs[attn_worst]:.3e} ({attn_worst}; its control {ctrl[attn_worst]:.3e}), "
          f"median {sorted(errs[p] for p in attn)[len(attn) // 2]:.3e}, bound {leaf_bound}; "
          f"control min {min(ctrl[p] for p in attn):.3e}, least control / reading "
          f"{ratio[attn_near]:.1f} ({attn_near}; at least "
          f"{1 / share:.2f}); layers whose k weights "
          f"receive a gradient: {live_k} of {n_layers} (at least {min_live})", flush=True)
    check(live_k >= min_live, f"{who}: the attention passes no gradient in some layer")
    check(loss_err <= STEP_LOSS_REL, f"{who}: step-1 loss differs from the plain path's")
    check(err_all <= bound < ctrl_all,
          f"{who}: gradient {err_all:.3e} vs bound {bound} (control {ctrl_all:.3e})")
    check(not attn_out,
          f"{who}: attention leaves above the bound {leaf_bound} or "
          f"{share} of their control (reading, control): "
          f"{[(p, f'{errs[p]:.3e}', f'{ctrl[p]:.3e}') for p in attn_out]}")
    del g_k, g_p, g_c
    return dict(loss_rel=loss_err, grad_rel_rms=err_all, control=ctrl_all,
                param_max=errs[worst], attn_leaf_max=errs[attn_worst],
                attn_leaf_control_ratio=ratio[attn_near])


def phase_train(torch, np, fa, family, kind, seq, bsz, method, method_kw, trace=False):
    """Phase 6b: one model and method trained through ``run_training`` at
    full width, f32: 2k steps uninterrupted (checkpoint at k), then a run
    resumed from that checkpoint to 2k, which must end bitwise equal;
    every loss finite and falling. With ``trace``, one more step from the
    final state is replayed under torch.profiler (outside the counted
    run): device time by family (flash backward, flash forward, the rest)
    and the idle share. Returns the run's numbers."""
    import shutil
    import tempfile
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.nn.module import flatten_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (LoopConfig, TrainTask, init_train_state, make_train_step,
                                   run_training)

    who = f"{family} {method}"
    cfg = paper_cfg(family, method, **method_kw)
    task = TrainTask(cfg=cfg, loss_kind=kind, optimizer=AdamWConfig(lr=TRAIN_LR))
    if cfg.input_kind == "embeds":
        data = SeededEmbeds(torch, cfg.vocab_size, cfg.frontend_dim, bsz, seq)
    else:
        data = SyntheticLM(SyntheticLMConfig(vocab_size=TRAIN_DATA_VOCAB, seq_len=seq,
                                             batch_size=bsz, seed=0))
    params0 = sharpen(init_train_state(0, task, device="cuda").params, STEP_QK_SCALE[family])
    batch0 = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0, kind).items()}
    gate = phase_train_step_vs_plain(torch, fa, task, params0, batch0, who,
                                     STEP_GRAD_REL_RMS[(family, method)],
                                     STEP_ATTN_LEAF_REL[(family, method)],
                                     cfg.n_layers - int((family, method) in STEP_DEAD_LAYERS),
                                     STEP_ATTN_CONTROL_SHARE_OF.get((family, method),
                                                                    STEP_ATTN_CONTROL_SHARE))
    del params0, batch0
    torch.cuda.empty_cache()

    k = TRAIN_HALF
    quiet = lambda _msg: None  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        full, half = f"{d}/full", f"{d}/half"
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_launches = 0
        run = run_training(task, data, LoopConfig(total_steps=2 * k, eval_every=2 * k,
                                                  eval_batches=1, ckpt_every=k, ckpt_dir=full,
                                                  keep_ckpts=3, log_every=0, seed=0),
                           batch_kind=kind, log=quiet, device="cuda")
        launches = (fa.launches, fa.bwd_launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        shutil.copytree(f"{full}/step_{k:08d}", f"{half}/step_{k:08d}")
        resumed = run_training(task, data, LoopConfig(total_steps=2 * k, eval_every=0,
                                                      ckpt_dir=half, log_every=0, seed=0),
                               batch_kind=kind, log=quiet, device="cuda")
    losses = run["losses"]
    a = dict(flatten_params(run["state"]))
    same = all(torch.equal(x, a[p]) for p, x in flatten_params(resumed["state"]))
    n = cfg.n_layers
    steps = 2 * k
    tok_s = bsz * seq / run["median_step_s"]
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    print(f"train {who} ({bsz} x {seq}, lr {TRAIN_LR}, {steps} steps): step "
          f"{run['median_step_s'] * 1e3:.1f} ms (median), {tok_s:.0f} trained tok/s, peak "
          f"{peak:.2f} GB; launches per step: flash bwd {launches[1] / steps:.2f}, flash fwd "
          f"{launches[0]}/{steps} steps + 2 eval forwards; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the first 4 {first:.4f}, last 4 {last:.4f}); eval ppl "
          f"{run['history']['eval_ppl'][-1]:.1f}, max inf-norm "
          f"{run['history']['max_inf_norm'][-1]:.3f}, kurtosis "
          f"{run['history']['kurtosis'][-1]:.3f}; restart at {k}: "
          f"{'bitwise equal' if same else 'DIFFERS'}, losses {resumed['losses'] == losses[k:]}",
          flush=True)
    check(all(np.isfinite(losses)), f"{who}: a loss is not finite: {losses}")
    check(last < first, f"{who}: the loss did not fall: {losses}")
    check(launches == (steps * n + 2 * n, steps * n),
          f"{who}: launches (flash, bwd) {launches}, expected {(steps * n + 2 * n, steps * n)}")
    check(same and resumed["losses"] == losses[k:],
          f"{who}: the resumed run is not bitwise the uninterrupted one")
    result = dict(step_ms=run["median_step_s"] * 1e3, tok_s=tok_s, peak_gb=peak,
                  losses=losses, flash_launches=launches[0], bwd_launches=launches[1],
                  eval=run["history"], restart_bitwise=same, **gate)
    if trace:
        step = make_train_step(task)
        batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(2 * k, kind).items()}
        tr = trace_tick(torch, lambda: step(run["state"], batch), f"train step {who}")
        fam = tr["family_ms"]
        print(f"train {who}: one step traced: host wall {tr['wall_ms']:.2f} ms, device busy "
              f"{tr['device_ms']:.2f} ms, idle share {tr['idle_share']:.3f}; flash backward "
              f"{fam['flash backward']:.2f} ms ({tr['family_kernels']['flash backward']} "
              f"kernels), flash forward {fam['flash forward']:.2f} ms, the rest "
              f"{fam['rest']:.2f} ms ({tr['family_kernels']['rest']} kernels; largest: "
              f"{'; '.join(f'{n[:40]} {ms:.2f}' for n, ms in tr['rest_top'])})", flush=True)
        result["trace"] = tr
    del run, resumed, a
    torch.cuda.empty_cache()
    return result

# ---------------------------------------------------------------------------
# phase 7: embeds inputs and sandwich norms at published widths
# ---------------------------------------------------------------------------
class SeededEmbeds:
    """Batches of embeddings at a model's frontend width with a class per
    position, for the models that take embeddings (ViT-S/16's 384-wide
    patches, hubert-xlarge's 512-wide frames): the JAX package's ``frames``
    batches are 24 wide, which neither takes. Batch ``i`` is a pure
    function of (seed, i), drawn by a seeded torch.Generator: labels
    uniform over the classes, each position's embedding a fixed random row
    of its label (the table from ``seed``) plus N(0, 0.5^2) noise, so a
    model can learn the labels. Returned as numpy arrays, as
    ``SyntheticLM.batch`` returns them."""

    def __init__(self, torch, vocab, dim, batch_size, seq_len, seed=0):
        self.torch, self.vocab, self.seed = torch, vocab, seed
        self.shape = (batch_size, seq_len)
        self.table = torch.randn(vocab, dim, generator=torch.Generator().manual_seed(seed))

    def batch(self, index, kind="frames"):
        torch = self.torch
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + index + 1)
        labels = torch.randint(0, self.vocab, self.shape, generator=gen)
        noise = torch.randn(*self.shape, self.table.shape[1], generator=gen)
        return {"embeds": (self.table[labels] + 0.5 * noise).numpy(),
                "labels": labels.to(torch.int32).numpy()}


# (B, T) of phase 7's runs: ViT-S/16 over 64 images of 197 patches (196 and
# the class token); hubert-xlarge over 2 clips of 4096 frames;
# phi-3-vision's mixed forward, 576 patch embeddings then 1472 tokens
VIT_BATCH, VIT_SEQ = 64, 197
HUBERT_BATCH, HUBERT_SEQ = 2, 4096
PHI_PATCHES, PHI_TOKENS = 576, 1472
# gemma2-27b's engines: batch 4 at max_len 4608 (the cache-free forward's
# length), a pool of 400 blocks of 16 (the 6 requests need at most 373
# at once: 271 for the long prompt, 34 for each of three others), five
# prompts of 32..512 tokens and one of 4300, which crosses the 4096 window
GEMMA_BATCH, GEMMA_MAX_LEN, GEMMA_BLOCKS, GEMMA_LONG = 4, 4608, 400, 4300


def phase_wall(name, t0):
    wall = time.perf_counter() - t0
    print(f"phase {name}: wall {wall:.1f} s", flush=True)
    return wall


def phase_vit(torch, np, fa, fq, pa, im):
    """Phase 7a: ViT-S/16 (f32, 12 layers) evaluated by phase 5's protocol
    for vanilla, clipped (alpha 4) and gated attention over SeededEmbeds
    batches (64 x 197 x 384) with the paper models' gates, then trained
    2 x TRAIN_HALF AdamW steps per method as phase 6b trains BERT and OPT."""
    t0 = time.perf_counter()
    cfg = paper_cfg("vit", "vanilla")
    out = dict(
        evals=[phase_eval(torch, np, fa, fq, pa, im, f"vit {name}",
                          paper_cfg("vit", method, **kw), kind="frames", seq=VIT_SEQ,
                          batch_size=VIT_BATCH, layer_tol=PAPER_LAYER_REL_RMS,
                          own_tol=PAPER_LOGIT_REL_RMS, logit_tol=PAPER_LOGIT_REL_RMS,
                          data=SeededEmbeds(torch, cfg.vocab_size, cfg.frontend_dim,
                                            VIT_BATCH, VIT_SEQ))
               for name, method, kw in METHODS],
        trains=[phase_train(torch, np, fa, "vit", "frames", VIT_SEQ, VIT_BATCH, method, kw,
                            trace=method == "vanilla") for _, method, kw in METHODS])
    out["wall_s"] = phase_wall("7a (vit-s16)", t0)
    return out


def phase_hubert(torch, np, fa, fq, pa, im):
    """Phase 7b: hubert-xlarge (bf16, 48 layers) evaluated by phase 5's
    protocol (vanilla) over SeededEmbeds frames (2 x 4096 x 512): FP and
    W8A8 fake-quant perplexity, each layer's flash output against its
    plain version (FLASH_LAYER_REL_RMS, the bf16-P control above)."""
    from repro_torch.configs.hubert_xlarge import full
    cfg = dataclasses.replace(full(), scan_layers=False)     # unrolled, as PTQ needs
    t0 = time.perf_counter()
    out = phase_eval(torch, np, fa, fq, pa, im, "hubert-xlarge vanilla", cfg, kind="frames",
                     seq=HUBERT_SEQ, batch_size=HUBERT_BATCH,
                     data=SeededEmbeds(torch, cfg.vocab_size, cfg.frontend_dim, HUBERT_BATCH,
                                       HUBERT_SEQ))
    out["phase_wall_s"] = phase_wall("7b (hubert-xlarge)", t0)
    return out


def held_forward(torch, fa, name, cfg, run, keep_keys=False):
    """One cache-free forward ``run()`` of ``cfg`` (logits, or a part of
    them) through the flash kernel, every layer held against its plain
    version (``held_layers``: FLASH_LAYER_REL_RMS, the bf16-P control
    above in some layer); one flash launch per layer. With ``keep_keys``,
    also the first attention call's post-RoPE keys of its first row."""
    from repro_torch.models import transformer
    keys, real_attention = [], transformer.attention

    def keep(q, k, v, *args, **kw):
        if not keys:
            keys.append(k[0].clone())
        return real_attention(q, k, v, *args, **kw)

    if keep_keys:
        transformer.attention = keep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            logits, rms, ctl, zero = held_layers(torch, fa, run)
        torch.cuda.synchronize()
    finally:
        transformer.attention = real_attention
    wall = time.perf_counter() - t0
    launches, peak = fa.launches, torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(logits).all())
    print(f"{name}: cache-free forward, logits {tuple(logits.shape)} finite {finite}; flash "
          f"per layer vs its plain version on the same inputs: relative RMS max "
          f"{max(rms):.3e}, mean {sum(rms) / len(rms):.3e} over {len(rms)} layers (tol "
          f"{FLASH_LAYER_REL_RMS:.0e}); the plain version with bf16 P: max {max(ctl):.3e}, "
          f"{sum(v > FLASH_LAYER_REL_RMS for v in ctl)} layers above the tol; zero layers "
          f"{zero or 'none'}; flash launches {launches}; {wall:.2f} s with the checks, peak "
          f"memory {peak:.2f} GB", flush=True)
    check(finite, f"{name}: non-finite logits")
    check(launches == cfg.n_layers, f"{name}: {launches} flash launches, not {cfg.n_layers}")
    check(len(rms) == cfg.n_layers and max(rms) <= FLASH_LAYER_REL_RMS,
          f"{name}: a layer's flash output differs from its plain version: {rms}")
    check(max(ctl) > FLASH_LAYER_REL_RMS,
          f"{name}: no layer tells bf16 P from f32 P at the bound: {ctl}")
    return dict(layer_rel_rms_max=max(rms), layer_bf16_p_rel_rms_max=max(ctl),
                flash_launches=launches, peak_gb=peak, wall_s=wall,
                keys=keys[0] if keys else None)


def phase_phi3v(torch, np, pa, im, fa):
    """Phase 7c: phi-3-vision-4.2b (bf16, 32 layers, random weights from
    seed 0): one mixed forward (576 patch embeddings at d_model, then 1472
    tokens: T 2048) held per layer; then ``ContinuousBatcher(paged=True)``
    on the same weights serving 8 text prompts (batch 8, max_len 2048), its
    first mixed tick against the plain path (LOGIT_REL_RMS)."""
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.phi_3_vision_4_2b import full
    from repro_torch.models.transformer import model_apply, model_init

    t0 = time.perf_counter()
    cfg = apply_method(full(), "vanilla")
    params = model_init(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"embeds": torch.randn(1, PHI_PATCHES, cfg.d_model, generator=gen, device="cuda"),
             "tokens": torch.randint(0, cfg.vocab_size, (1, PHI_TOKENS), generator=gen,
                                     device="cuda")}
    fwd = held_forward(torch, fa, "phi-3-vision mixed", cfg,
                       lambda: model_apply(params, cfg, batch)[0])
    check(cfg.n_prefix_embeds == PHI_PATCHES, "phi-3-vision's prefix is not 576 patches")
    del batch
    serving = phase_serving(torch, np, pa, im, fa, "phi-3-vision vanilla", cfg,
                            short_requests(np, cfg.vocab_size, 8), 2048, LOGIT_REL_RMS,
                            params=params)
    del params
    torch.cuda.empty_cache()
    return dict(forward=fwd, serving=serving, wall_s=phase_wall("7c (phi-3-vision)", t0))


def gemma_requests(np, vocab):
    """Phase 7d's 6 greedy requests of 32 new tokens: five prompts of
    32..512 tokens and, last, one of GEMMA_LONG."""
    return short_requests(np, vocab, 5) + [
        (np.random.default_rng(1).integers(0, vocab, size=GEMMA_LONG).astype(np.int32), 32)]


def phase_gemma2(torch, np, pa, im, fa):
    """Phase 7d: gemma2-27b (bf16, 46 layers: local window 4096 and global
    attention alternating, attention softcap 50, final softcap 30,
    sandwich norms, GeGLU, scaled embeddings; random weights from seed 0).
    One cache-free forward at (1, 4608) (the long request's prompt, then
    more tokens) held per layer; then ``ContinuousBatcher(paged=True)``
    (GEMMA_BATCH rows, max_len GEMMA_MAX_LEN, GEMMA_BLOCKS pool blocks)
    over ``gemma_requests``: vanilla and clipped on these weights, then
    gated on its own. Gates: the first tick past the window and the first
    mixed tick against the plain path (LOGIT_REL_RMS), and at the former
    the long request's first local_attn ring against the cache-free
    forward's keys (RG_RING_REL_RMS; rolled one slot above); checked in
    that order, so the past-window snapshot is freed before the mixed
    tick's replays (the checks peak at 78.9 GB of the card's 79.2 with
    both held). The vanilla engine's mixed and decode ticks are traced."""
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.gemma2_27b import full
    from repro_torch.models.transformer import model_apply, model_init

    t0 = time.perf_counter()
    cfg = apply_method(full(), "vanilla")
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params = model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    print(f"gemma2-27b: weights {weights_gb:.2f} GB ({before_gb:.2f} GB held before them), "
          f"init {init_s:.2f} s", flush=True)
    requests = gemma_requests(np, cfg.vocab_size)
    long_uid = len(requests) - 1
    extra = np.random.default_rng(2).integers(0, cfg.vocab_size, GEMMA_MAX_LEN - GEMMA_LONG)
    tokens = torch.as_tensor(np.concatenate([requests[long_uid][0], extra]),
                             dtype=torch.long, device="cuda")[None]
    fwd = held_forward(torch, fa, "gemma2-27b", cfg,
                       lambda: model_apply(params, cfg, {"tokens": tokens})[0][:, -1].clone(),
                       keep_keys=True)
    keys = fwd.pop("keys")
    engines = []
    for name, method, kw in METHODS:
        ecfg = apply_method(full(), method, **kw)
        if method == "gated_attention":
            del params
            torch.cuda.empty_cache()
            params = model_init(0, ecfg, device="cuda")
        engines.append(phase_serving(
            torch, np, pa, im, fa, f"gemma2-27b {name}", ecfg, requests, GEMMA_MAX_LEN,
            LOGIT_REL_RMS, ticks=("past the window", "mixed"), trace=method == "vanilla",
            params=params, batch_size=GEMMA_BATCH, num_blocks=GEMMA_BLOCKS,
            ring_ref=(long_uid, keys)))
    del params, keys
    torch.cuda.empty_cache()
    return dict(forward=fwd, engines=engines, weights_gb=weights_gb, init_s=init_s,
                wall_s=phase_wall("7d (gemma2-27b)", t0))


# ---------------------------------------------------------------------------
# phase 8: Mixture-of-Experts blocks (granite-moe-1b-a400m, qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------
GRANITE_MOE, QWEN2_MOE = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
MOE_SHORT = {GRANITE_MOE: "granite-moe", QWEN2_MOE: "qwen2-moe"}
# Phase 8a's bound on the MoE layer's routed output, dispatch against its
# plain yardstick on the same router outputs, bf16 (relative RMS): the two
# run the same expert products over buffers of other shapes and combine in
# another order (dense: an einsum over every expert; dispatch: each kept
# claim's output times its weight, summed over the k slots), so they differ
# by bf16 roundings. Its controls must land above it: one slot's weight
# zeroed (no drops), the claims replayed token-major (drops), the dead rows
# claiming capacity (dead rows). Measured on an H100 80GB HBM3 at 700 W
# (granite-moe / qwen2-moe, layer 0 of a T-2048 forward): no drops
# 2.643e-3 / 2.682e-3, drops 2.707e-3 / 2.388e-3, dead rows 1.067e-4 / 0
# (the router's GEMM over other row counts); the controls 0.176 / 0.338,
# 0.787 / 0.784, 0.207 / 0.167. Bounded at 1e-2: 3.7x above the largest
# reading, 17x below the least control.
MOE_LAYER_REL_RMS = 1e-2
# the lowered capacity factor at which claims drop (phase 8a) and every MoE
# layer's fault (phase 8's logits gates)
MOE_DROP_CF = 0.5
# Phase 8's logits gates of the evaluation (a MoE model's forward through
# the flash kernel against its plain version and against dense_attention,
# both routed as the kernel's forward). Free, the plain forwards route
# 29-58 % of the (layer, token) pairs elsewhere (a near-tie flips, the
# moved residual flips later layers), and the logits read 0.21-0.56;
# routed alike, measured on an H100 80GB HBM3 at 700 W: granite-moe
# vanilla / clipped / gated 0.0198 / 0.0480 / 0.0595 (own plain version),
# 0.0237 / 0.0666 / 0.0833 (dense_attention); qwen2-moe 0.0266 / 0.0316;
# the fault (every MoE layer at capacity MOE_DROP_CF) 0.73-1.31. The
# random routers make 24 MoE layers amplify a layer's one-ulp attention
# differences more than qwen3-14b's 40 dense ones (0.012-0.048), so the
# bound is MoE's own: 1.8x the largest reading, 4.9x below the least fault.
# The per-layer flash gate (FLASH_LAYER_REL_RMS) is the tight one.
MOE_LOGIT_REL_RMS = 0.15
# Phase 8b: granite-moe-1b-a400m trained in f32 (the backward kernel takes
# f32 only), vanilla, B 2 x T 1024, 8 AdamW steps on the SyntheticLM chain.
# At phase 6's lr 3e-4 the mean of the last four losses sat only 0.4 %
# under the first four's (11.054 -> 11.009; H100 80GB HBM3, 700 W); at
# 1e-3 the fall is clear of the step-to-step noise.
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_LR = 8, 2, 1024, 1e-3
# Its step-vs-plain gate (phase 6b's, on the whole gradient and each
# attention leaf), the plain steps routed as the kernel step: free, 76 of
# 49152 (layer, token) pairs route elsewhere in f32, which moved the loss
# by 1.6e-5 and the gradient by 1.9e-2. Routed alike, measured on an H100
# 80GB HBM3 at 700 W: the whole gradient 6.358e-6 (control, P in bf16,
# 6.368e-3), attention leaves at most 7.424e-6 (least control 1.482e-3).
# Bounded at 5e-5: 6.7x above the largest leaf, 30x below the least
# control.
MOE_STEP_GRAD_REL_RMS = 5e-5
MOE_STEP_ATTN_LEAF_REL = 5e-5


def moe_arch_cfg(arch, method="vanilla", **method_kw):
    """``arch``'s published config with ``method``, unrolled (as PTQ and the
    train-step gate's per-layer paths need)."""
    from repro_torch.configs.base import apply_method, get_arch
    return dataclasses.replace(apply_method(get_arch(arch).full(), method, **method_kw),
                               scan_layers=False)


def phase_moe_layer(torch, name, params, cfg, tokens):
    """Phase 8a: the MoE layer alone on the card, on hidden states of a real
    forward over ``tokens`` (1, T): every layer's claims dropped at the
    config's capacity (printed), then on the first layer's input:
    (no drops) dispatch at capacity factor E/k, where no claim can drop,
    against the dense path on the same router outputs, the control one
    slot's weight zeroed; (drops) dispatch at MOE_DROP_CF against
    ``dispatch_ref`` (a host loop replaying the slot-major claims, the
    dropped weights zeroed in the dense combine), the same number of drops,
    the control the claims replayed token-major; (dead rows) the T tokens
    as 8 rows of T / 8 with every other row dead, the live rows against the
    same rows alone at the same capacity (the factor doubled, since ``cap``
    follows the group's size), the control the dead rows claiming."""
    from repro_torch.models import transformer
    from repro_torch.nn import moe

    t0 = time.perf_counter()
    layers, real = [], transformer.moe_apply

    def keep(p, x, c, *args, **kw):
        layers.append((p, x.clone()))
        return real(p, x, c, *args, **kw)

    transformer.moe_apply = keep
    try:
        with torch.no_grad():
            transformer.model_apply(params, cfg, {"tokens": tokens})
    finally:
        transformer.moe_apply = real
    mc, d = cfg.moe, cfg.d_model
    n = tokens.numel()
    gsz, n_groups, cap = moe.dispatch_capacity(mc, n)
    drops = [moe.dropped_claims(p, x, mc) for p, x in layers]
    print(f"moe layer {name}: {len(layers)} MoE layers, {n} tokens x top-{mc.top_k} of "
          f"{mc.n_experts} experts, groups of {gsz}, capacity {cap} per expert "
          f"(factor {mc.capacity_factor}); claims dropped per layer {drops} "
          f"({sum(drops) / (len(layers) * n * mc.top_k):.4f} of all)", flush=True)
    check(len(layers) == cfg.n_layers, f"{name}: {len(layers)} MoE layer calls")
    p, x = layers[0]
    del layers
    x2d = x.reshape(n, d)
    e, k = mc.n_experts, mc.top_k
    with torch.no_grad():
        top_p, top_i, _ = moe._router(p, x2d, mc)
        # (no drops) capacity factor E / k: cap = the group's size
        slack = dataclasses.replace(mc, exec_mode="dispatch", capacity_factor=e / k)
        dense = moe._moe_dense(p, x2d, top_p, top_i, mc)
        got = moe._moe_dispatch(p, x2d, top_p, top_i, slack)
        zeroed = top_p.clone()
        zeroed[:, -1] = 0
        ctl = moe._moe_dispatch(p, x2d, zeroed, top_i, slack)
        slack_drops = moe.dropped_claims(p, x, slack)
        r_slack, r_slack_ctl = rel_rms(got, dense), rel_rms(ctl, dense)
        # (drops) against the host replay of the slot-major claims
        low = dataclasses.replace(mc, exec_mode="dispatch", capacity_factor=MOE_DROP_CF)
        got = moe._moe_dispatch(p, x2d, top_p, top_i, low)
        ref, ref_drops = moe.dispatch_ref(p, x, low)
        tok, tok_drops = moe.dispatch_ref(p, x, low, order="token")
        low_drops = moe.dropped_claims(p, x, low)
        ref = ref.reshape(n, d)
        r_low, r_low_ctl = rel_rms(got, ref), rel_rms(tok.reshape(n, d), ref)
        bitwise = torch.equal(got, ref)
        # (dead rows) 8 rows of n / 8, every other one dead
        rows = x.reshape(8, n // 8, d)
        active = torch.tensor([True, False] * 4, device=x.device)
        alone_cfg = dataclasses.replace(mc, capacity_factor=2 * mc.capacity_factor)
        same_cap = moe.dispatch_capacity(alone_cfg, n // 2)[2] == cap
        masked = moe.moe_apply(p, rows, mc, active=active)[0][active]
        alone = moe.moe_apply(p, rows[active], alone_cfg)[0]
        opened = moe.moe_apply(p, rows, mc)[0][active]
        r_dead, r_dead_ctl = rel_rms(masked, alone), rel_rms(opened, alone)
        dead_drops = (moe.dropped_claims(p, rows, mc, active=active),
                      moe.dropped_claims(p, rows[active], alone_cfg),
                      moe.dropped_claims(p, rows, mc))
    wall = time.perf_counter() - t0
    print(f"moe layer {name} (layer 0, bf16): (no drops) dispatch at capacity factor "
          f"{e / k:g} ({slack_drops} drops) vs the dense path: relative RMS {r_slack:.3e} "
          f"(bound {MOE_LAYER_REL_RMS:.0e}), control (slot {k - 1}'s weight zeroed) "
          f"{r_slack_ctl:.3e}; (drops) dispatch at capacity factor {MOE_DROP_CF} "
          f"({low_drops} of {n * k} claims dropped; the host replay {ref_drops}) vs the "
          f"replay: relative RMS {r_low:.3e}, bitwise {bitwise}, control (claims "
          f"token-major: {tok_drops} dropped) {r_low_ctl:.3e}; (dead rows) 8 rows x "
          f"{n // 8}, 4 dead: the live rows vs the same rows alone (capacity {cap} in both: "
          f"{same_cap}) relative RMS {r_dead:.3e}, control (the dead rows claiming) "
          f"{r_dead_ctl:.3e}; drops masked / alone / open {dead_drops}; {wall:.1f} s",
          flush=True)
    check(slack_drops == 0 and r_slack <= MOE_LAYER_REL_RMS < r_slack_ctl,
          f"{name}: MoE dispatch without drops vs dense: {r_slack} (control {r_slack_ctl}, "
          f"drops {slack_drops})")
    check(low_drops == ref_drops > 0 and r_low <= MOE_LAYER_REL_RMS < r_low_ctl,
          f"{name}: MoE dispatch with drops vs the replayed claims: {r_low} (control "
          f"{r_low_ctl}, drops {low_drops} / {ref_drops})")
    check(same_cap and dead_drops[0] == dead_drops[1] and
          r_dead <= MOE_LAYER_REL_RMS < r_dead_ctl,
          f"{name}: MoE dead rows: {r_dead} (control {r_dead_ctl}, drops {dead_drops})")
    return dict(drops_per_layer=drops, cap=cap, slack_rel_rms=r_slack,
                slack_control=r_slack_ctl, drops_rel_rms=r_low, drops_bitwise=bitwise,
                drops_control=r_low_ctl, drops=low_drops, dead_rel_rms=r_dead,
                dead_control=r_dead_ctl, wall_s=wall)


def phase_moe_train(torch, np, fa):
    """Phase 8b's training: granite-moe-1b-a400m at full width and depth in
    f32 (params and compute: the flash backward takes f32), vanilla, from
    seed 0: step 1 through the kernels against the plain attention path
    (phase 6b's gate: the whole gradient, each attention leaf, the bf16-P
    control above; the plain steps routed as the kernel step, the (layer,
    token) pairs the two forwards route to other experts when free
    printed), then MOE_TRAIN_STEPS AdamW steps at MOE_TRAIN_BATCH x
    MOE_TRAIN_SEQ on the SyntheticLM chain (TRAIN_DATA_VOCAB ids): one flash
    and one backward launch per layer and step, every loss, ``moe_lb`` and
    ``moe_z`` finite and printed, the mean of the last four losses below the
    first four's."""
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.models.transformer import model_apply
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainTask, init_train_state, make_train_step

    t0 = time.perf_counter()
    who = "granite-moe vanilla"
    cfg = dataclasses.replace(moe_arch_cfg(GRANITE_MOE), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    task = TrainTask(cfg=cfg, loss_kind="clm", optimizer=AdamWConfig(lr=MOE_TRAIN_LR))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=TRAIN_DATA_VOCAB, seq_len=MOE_TRAIN_SEQ,
                                         batch_size=MOE_TRAIN_BATCH, seed=0))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(0, task, device="cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0, "clm").items()}
    gate = phase_train_step_vs_plain(torch, fa, task, state.params, batch, who,
                                     MOE_STEP_GRAD_REL_RMS, MOE_STEP_ATTN_LEAF_REL,
                                     cfg.n_layers)
    real = fa.mha_flash
    with torch.no_grad(), routing_taps() as kern_routes:
        model_apply(state.params, cfg, batch)
    try:
        fa.mha_flash = fa.mha_flash_ref
        with torch.no_grad(), routing_taps() as plain_routes:
            model_apply(state.params, cfg, batch)
    finally:
        fa.mha_flash = real
    flips = routing_flips(kern_routes, plain_routes)
    del kern_routes, plain_routes
    print(f"train {who}: step 1's forward through the kernels vs the plain attention "
          f"path: (layer, token) pairs routed to other experts {flips[0]} of {flips[1]}",
          flush=True)
    step = make_train_step(task)
    fa.launches = fa.bwd_launches = 0
    losses, lbs, zs, times = [], [], [], []
    for i in range(MOE_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(i, "clm").items()}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        lbs.append(float(metrics["moe_lb"]))
        zs.append(float(metrics["moe_z"]))
        times.append(time.perf_counter() - ts)
    launches = (fa.launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n, steps = cfg.n_layers, MOE_TRAIN_STEPS
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    step_ms = float(np.median(times)) * 1e3
    tok_s = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (step_ms / 1e3)
    print(f"train {who} (f32, {n} layers, {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, lr {MOE_TRAIN_LR}, "
          f"{steps} steps): step {step_ms:.1f} ms (median), {tok_s:.0f} trained tok/s, peak "
          f"{peak:.2f} GB; launches (flash, bwd) {launches}; losses "
          f"{[round(v, 4) for v in losses]} (mean of the first 4 {first:.4f}, last 4 "
          f"{last:.4f}); moe_lb {[round(v, 4) for v in lbs]} (top_k {cfg.moe.top_k} when "
          f"the load is even); moe_z {[round(v, 3) for v in zs]}", flush=True)
    values = losses + lbs + zs
    check(all(np.isfinite(v) for v in values), f"{who}: a loss or MoE term is not finite")
    check(last < first, f"{who}: the loss did not fall: {losses}")
    check(launches == (steps * n, steps * n),
          f"{who}: launches (flash, bwd) {launches}, expected {(steps * n, steps * n)}")
    del state, batch, step
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, tok_s=tok_s, peak_gb=peak, losses=losses, moe_lb=lbs,
                moe_z=zs, flash_launches=launches[0], bwd_launches=launches[1],
                routing_flips=flips, wall_s=time.perf_counter() - t0, **gate)


def phase_moe(torch, np, pa, im, fa, fq):
    """Phase 8: the MoE archs at their published widths and depths, random
    weights from seed 0, one model at a time (each freed before the next),
    peak memory printed. (b) granite-moe-1b-a400m, bf16: phase 5's
    evaluation for vanilla (with phase 8a's layer checks), clipped (alpha 4)
    and gated; an fp and a W8A8 paged engine (batch 8, max_len 1024,
    ``short_requests``' 12 requests at its vocabulary) whose tick gates
    print their routing flips, the control the tick one position early;
    training (``phase_moe_train``). (c) qwen2-moe-a2.7b, bf16 (28.6 GB of
    weights): the evaluation, vanilla, with phase 8a's checks; an fp and a
    W8A8 engine (its shared experts through the int8 kernel) on the same
    weights, each with a mixed and a decode tick traced (device time by
    family: the router, the experts' batched products, the dispatch's index
    ops, the shared experts, the paged reads, the int8 GEMMs, the head)."""
    from repro_torch.models.transformer import model_init

    out = dict(evals=[], engines=[])
    for arch in (GRANITE_MOE, QWEN2_MOE):
        t0 = time.perf_counter()
        short = MOE_SHORT[arch]
        methods = METHODS if arch == GRANITE_MOE else METHODS[:1]
        for name, method, kw in methods:
            cfg = moe_arch_cfg(arch, method, **kw)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated() / 1e9
            params = model_init(0, cfg, device="cuda")
            weights_gb = torch.cuda.memory_allocated() / 1e9 - before
            out["evals"].append(phase_eval(torch, np, fa, fq, pa, im, f"{short} {name}", cfg,
                                           own_tol=MOE_LOGIT_REL_RMS,
                                           logit_tol=MOE_LOGIT_REL_RMS, params=params,
                                           moe_layer=method == "vanilla"))
            if method == "vanilla":
                print(f"{arch}: weights {weights_gb:.2f} GB", flush=True)
                reqs = short_requests(np, cfg.vocab_size, 12)
                out["engines"] += [
                    phase_serving(torch, np, pa, im, fa, f"{short} {'w8a8' if w8a8 else 'fp'}",
                                  cfg, reqs, 1024,
                                  W8A8_LOGIT_REL_RMS if w8a8 else LOGIT_REL_RMS,
                                  w8a8=w8a8, controls=("MoE capacity 8",) if w8a8 else
                                  ("positions one early", "MoE capacity 8"),
                                  trace=arch == QWEN2_MOE, params=params)
                    for w8a8 in (False, True)]
            del params
            torch.cuda.empty_cache()
        if arch == GRANITE_MOE:
            out["train"] = phase_moe_train(torch, np, fa)
        out[f"{short} wall_s"] = phase_wall(f"8 ({arch})", t0)
    return out


# ---------------------------------------------------------------------------
# phases 3c (bf16 Dh 256), 4c, 5c: recurrentgemma-9b's W8A8 serving and
# evaluation; phase 9: xlstm-1.3b
# ---------------------------------------------------------------------------
# recurrentgemma-9b's local_attn read in its cache-free forward (the
# evaluation): 16 query heads over one KV head of 256, window 2048
RG_FLASH_HEADS = dict(b=1, hq=16, hkv=1, dh=256)
RG_WINDOW = 2048
# phase 4c's served last chunk against a cache-free W8A8 forward over the
# row's prefix, at phase 4's W8A8 bound: the chunked and the one-shot
# forwards quantize activations that differ by f32 roundings, so codes at
# a rounding edge flip and 38 layers carry that on (on an H100 80GB HBM3
# at 700 W: 0.114, argmax agreement 1.0; the row's state reset to a fresh
# row's, the control: 1.31)
RECURRENT_W8A8_ROW_REL_RMS = W8A8_LOGIT_REL_RMS
# xLSTM's row check: in bf16 the served chunks and the one-shot forward
# round in other places (GEMMs of other M, the chunkwise form's other
# chunks), and 48 random-weight xLSTM blocks grow that to the size of the
# signal (on the CPU at xlstm-1.3b's width: one block 1.5e-3, eight 8e-2;
# on the card, 48 blocks: 0.98, the reset-state control 1.03); int8 codes
# flipped at rounding edges do the same under W8A8 (f32, eight blocks:
# 0.05-0.16). So the gated check runs an fp engine in f32 at the published
# width over one pattern group (eight blocks; on the CPU: 4e-5), and the
# published depth's readings are printed
XLSTM_ROW_REL_RMS = 1e-3
# phase 9a: the mLSTM chunkwise form against its recurrent oracle in f32 on
# the card (sums in another order: ~1e-6); the control drops the state
# between two halves
MLSTM_REL_RMS = 1e-4
XLSTM_EVAL_SEQ, XLSTM_EVAL_BATCH = 512, 2


def phase_flash_dh256(torch, fa, build):
    """bf16 Dh 256 (the CUDA-core route; recurrentgemma's evaluation):
    vanilla, clipped and gated, causal with window 2048 at T 2048 and a
    window that binds (300) at a ragged T 1000, against the plain version
    at the bf16 tolerance; then the kernel, its plain version and SDPA
    (vanilla; at T 2048 a 2048 window hides no causal key, so is_causal
    computes the same function) timed at (1, 2048, 16/1, 256) beside the
    bound; the ptxas spill stores of the Dh-256 instantiations printed
    (not gated)."""
    import torch.nn.functional as F
    bad = []
    for t, window in ((2048, RG_WINDOW), (1000, 300)):
        for variant in ("vanilla", "clipped", "gated"):
            c = flash_case(torch, t, torch.bfloat16, variant, seed=31, **RG_FLASH_HEADS)
            q, (k, v) = c["q"], c["sets"][0]
            kw = dict(c["kw"], causal=True, window=window)
            out = fa.mha_flash(q, k, v, c["gate"], **kw)
            ref = fa.mha_flash_ref(q, k, v, c["gate"], **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= FLASH_TOL["bfloat16"] and bool(torch.isfinite(out).all())
            print(f"flash check Dh 256 {tuple(q.shape)} window {window} {variant} bfloat16 "
                  f"route={fa.route(q.dtype, 256)}: max |kernel - plain| {err:.3e} (tol "
                  f"{FLASH_TOL['bfloat16']})", flush=True)
            if not ok:
                bad.append((t, window, variant, err))
            del c, out, ref
    check(not bad, f"flash kernel at bf16 Dh 256 disagrees with its plain version: {bad}")
    for variant in ("vanilla", "clipped"):
        c = flash_case(torch, 2048, torch.bfloat16, variant, seed=11, copies=3, **RG_FLASH_HEADS)
        q, kw = c["q"], dict(c["kw"], causal=True, window=RG_WINDOW)
        kern = device_ms(torch, [lambda s=s: fa.mha_flash(q, s[0], s[1], **kw)
                                 for s in c["sets"]], 10)
        plain = device_ms(torch, [lambda s=s: fa.mha_flash_ref(q, s[0], s[1], **kw)
                                  for s in c["sets"]], 3)
        lib = None
        if variant == "vanilla":
            ins = [(q.transpose(1, 2).contiguous(), s[0].transpose(1, 2).contiguous(),
                    s[1].transpose(1, 2).contiguous()) for s in c["sets"]]
            lib = device_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], is_causal=True, enable_gqa=True) for a in ins], 10)
            del ins
        bound, by = flash_bound_ms(c)
        print(f"flash time recurrentgemma-9b local_attn {tuple(q.shape)} window {RG_WINDOW} "
              f"{variant} bfloat16 route={fa.route(q.dtype, 256)}: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, SDPA {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        del c
    spills = [("bf16" if "bfloat16" in fn else "f32", regs, sp)
              for fn, regs, sp in ptxas_report(build.BUILD_LOG.get("flash_attention", ""))
              if "flash_kernel_" in fn and "ELi256EE" in fn]
    print(f"ptxas Dh-256 flash instantiations (reported, not gated): (data type, "
          f"registers, spill-store bytes) {spills}", flush=True)
    torch.cuda.empty_cache()


def attn_layers(cfg):
    """Attention blocks of ``cfg`` (the flash kernel's launches per
    cache-free forward)."""
    kinds = cfg.pattern * cfg.n_groups + cfg.tail_pattern
    return sum(k in ("attn", "local_attn") for k in kinds)


def griffin_layers(cfg):
    return sum(k == "griffin" for k in cfg.pattern * cfg.n_groups + cfg.tail_pattern)


@contextlib.contextmanager
def xlstm_annotations(torch):
    """Profiler annotations around the xLSTM cells (the mLSTM chunkwise and
    recurrent forms, the sLSTM scan), for ``trace_split``'s TRACE_ANNOTATED
    families."""
    from torch.profiler import record_function
    from repro_torch.nn import xlstm

    parts = {"mlstm_chunkwise": "mLSTM cell", "mlstm_recurrent_ref": "mLSTM cell",
             "slstm_scan": "sLSTM scan"}
    real = {name: getattr(xlstm, name) for name in parts}

    def wrap(name):
        def f(*a, **kw):
            with record_function(parts[name]):
                return real[name](*a, **kw)
        return f

    for name in parts:
        setattr(xlstm, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(xlstm, name, fn)


def phase_recurrent_serving(torch, np, rl, im, fa, pa, name, cfg, requests, max_len,
                            params=None, w8a8=False, trace=False, row_tol=RG_LOGIT_REL_RMS,
                            min_pos=1):
    """One ``ContinuousBatcher(paged=True)`` engine (batch 8, block 16,
    budget 256) of a recurrent config (uniform sub-steps) over
    ``requests`` ((prompt, new tokens)), fp or W8A8 (``qconfig=QConfig()``).
    Gates: every request done, no block leak, no flash or paged launch, the
    RG-LRU kernel once per Griffin layer on every forward of T > 1 and
    never at T 1, the int8 kernel the same number of times on every
    forward (W8A8). At the first prefill sub-step where a row runs a last
    chunk (of more than one token) starting at position ``min_pos`` or
    later, that chunk's logits against a cache-free forward over its
    prefix (the same ``ctx``; a clipped ring's gamma at -alpha / window,
    the ring's) within ``row_tol`` (None: printed, not gated), and the same
    chunk with the row's recurrent state and ring reset to a fresh row's
    (the control) above it. W8A8: that sub-step and the decode sub-step with the
    most rows again with the int8 products on ``int8_matmul_ref``, each
    within W8A8_LOGIT_REL_RMS (bitwise printed). ``trace``: both replayed
    under torch.profiler."""
    from repro_torch.models.transformer import model_apply, model_init, row_leaves
    from repro_torch.nn import layers
    from repro_torch.nn.module import flatten_params, tree_map
    from repro_torch.quant.qconfig import NO_QUANT, QConfig
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.decode import step_rows_full

    t0 = time.perf_counter()
    own_params = params is None
    if own_params:
        params = model_init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = ContinuousBatcher(params, cfg, batch_size=8, max_len=max_len, block_size=16,
                          token_budget=256, qconfig=QConfig() if w8a8 else None,
                          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_griffin = griffin_layers(cfg)
    step_fn, per_forward, snaps = b._step_fn, [], {}

    def observe(params_, cache, tokens, pos, counts, keys, lw, lws):
        t = tokens.shape[1]
        live = int((counts > 0).sum())
        if t == 1 and live > snaps.get("decode", {}).get("live", 0):
            snaps["decode"] = dict(cache=tree_map(lambda x: x.clone(), cache), live=live,
                                   args=(tokens.clone(), pos.clone(), counts.clone(), lw,
                                         lws.clone()))
        if t > 1 and "prefill" not in snaps:
            c = counts.cpu()
            for i, s in enumerate(b.slots):
                st = s.prefill
                if c[i] > 1 and st is not None and s.pos >= min_pos and \
                        st.done + int(c[i]) == len(st.feed):
                    snaps["prefill"] = dict(
                        cache=tree_map(lambda x: x.clone(), cache), row=i,
                        prefix=st.feed[:st.done + int(c[i])].copy(),
                        args=(tokens.clone(), pos.clone(), counts.clone(), lw, lws.clone()))
                    break
        before = (im.launches, rl.launches, fa.launches, pa.launches)
        out = step_fn(params_, cache, tokens, pos, counts, keys, lw, lws)
        per_forward.append((t, im.launches - before[0], rl.launches - before[1],
                            fa.launches - before[2], pa.launches - before[3]))
        return out

    b._step_fn = observe
    for u, (p, n) in enumerate(requests):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=n))
    im.launches = rl.launches = fa.launches = pa.launches = 0
    ticks = 0
    t0 = time.perf_counter()
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
        ticks += 1
        if ticks > 4000:
            raise RuntimeError(f"{name}: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(int8=im.launches, rg_lru=rl.launches, flash=fa.launches, paged=pa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = {r.uid: r.output for r in b.done}
    n_tokens = sum(len(o) for o in outs.values())
    multi = sum(1 for f in per_forward if f[0] > 1)
    int8_per = sorted({f[1] for f in per_forward})
    q8 = sum(1 for path, _ in flatten_params(b.params) if path.endswith("w_q8"))
    print(f"serving {name} ({cfg.n_layers} layers, {'W8A8' if w8a8 else 'fp'}, paged, "
          f"kv_int8 {b.kv_int8}): {ticks} ticks, {len(per_forward)} forwards ({multi} of "
          f"T > 1), {n_tokens} generated tokens in {wall:.3f} s = {n_tokens / wall:.2f} tok/s, "
          f"peak memory {peak_gb:.2f} GB, weights init {init_s:.2f} s, engine set-up "
          f"(calibration, int8 weights) {setup_s:.2f} s; launches {launches}; int8 launches "
          f"per forward {int8_per} ({q8} int8 weight leaves)", flush=True)
    check(len(outs) == len(requests) and
          all(len(outs[u]) == n for u, (_, n) in enumerate(requests)),
          f"{name}: not every request finished with its tokens")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs.values()),
          f"{name}: token ids outside the vocabulary")
    check(not b.failed, f"{name}: failed requests {[r.status for r in b.failed]}")
    b.audit()
    check(b.allocator.available == b.num_blocks and (b.tables == -1).all(),
          f"{name}: block leak")
    check(launches["flash"] == 0 and launches["paged"] == 0,
          f"{name}: flash/paged kernels launched while serving: {launches}")
    wrong = [f for f in per_forward if f[2] != (n_griffin if f[0] > 1 else 0)]
    check(not wrong, f"{name}: rg_lru launches per forward (T, int8, rg_lru, ...) off: "
                     f"{wrong[:6]}")
    check(int8_per == ([int8_per[0]] if w8a8 else [0]) and (not w8a8 or int8_per[0] > 0),
          f"{name}: int8 launches per forward {int8_per}")
    check("prefill" in snaps and "decode" in snaps,
          f"{name}: no last chunk from position {min_pos} on or no decode sub-step was seen")
    ctx = b._qctx if w8a8 else NO_QUANT

    def sub_step(snap, int8_plain=False, fresh_row=None):
        tokens, pos, counts, lw, lws = snap["args"]
        live = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
        cache = tree_map(lambda x: x.clone(), snap["cache"])
        if fresh_row is not None:
            for path, leaf, ax in row_leaves(cache):
                src = b._row_template[path]
                leaf[(slice(None),) * ax + (fresh_row,)] = src[(slice(None),) * ax + (0,)]
        if int8_plain:
            layers.int8_matmul = im.int8_matmul_ref
        try:
            with torch.no_grad():
                out = step_rows_full(b.params, b.cfg, cache, tokens, pos, counts, lw, lws,
                                     ctx=ctx)[0]
        finally:
            layers.int8_matmul = im.int8_matmul
        del cache
        return out, live

    snap = snaps["prefill"]
    r, prefix = snap["row"], snap["prefix"]
    tokens, pos, counts = snap["args"][:3]
    c = int(counts[r])
    served, live = sub_step(snap)
    reset, _ = sub_step(snap, fresh_row=r)
    ref_cfg = b.cfg
    if not cfg.softmax_cfg.is_vanilla and cfg.window:
        ref_cfg = dataclasses.replace(b.cfg, softmax_cfg=dataclasses.replace(
            cfg.softmax_cfg, alpha=None, gamma=cfg.softmax_cfg.resolve_gamma(cfg.window)))
    with torch.no_grad():
        full_logits, _ = model_apply(b.params, ref_cfg, {
            "tokens": torch.as_tensor(prefix, dtype=torch.long, device=b.device)[None]}, ctx=ctx)
    ref = full_logits[0, -c:, :cfg.vocab_size].float()
    del full_logits
    row = served[r, :c, :cfg.vocab_size].float()
    row_rms, reset_rms = rel_rms(row, ref), rel_rms(reset[r, :c, :cfg.vocab_size], ref)
    agree = (row.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"serving {name}: row {r}'s last chunk ({c} tokens at positions "
          f"{int(pos[r])}..{int(pos[r]) + c - 1}) vs a cache-free forward over its "
          f"{len(prefix)}-token prefix: relative RMS {row_rms:.4e} (tol "
          f"{'none: printed' if row_tol is None else row_tol}), argmax agreement "
          f"{agree:.4f}; control, the row's state reset to a fresh row's: {reset_rms:.4e}",
          flush=True)
    if row_tol is not None:
        check(row_rms <= row_tol,
              f"{name}: the served chunk differs from the cache-free forward: {row_rms}")
        check(reset_rms > row_tol,
              f"{name}: the row check cannot tell a lost state: {reset_rms}")
    result = dict(engine=name, layers=cfg.n_layers, w8a8=w8a8, ticks=ticks,
                  forwards=len(per_forward), multi_forwards=multi, tokens=n_tokens,
                  wall_s=wall, tok_per_s=n_tokens / wall, peak_gb=peak_gb, init_s=init_s,
                  setup_s=setup_s, row_rel_rms=row_rms, row_reset_rel_rms=reset_rms,
                  int8_per_forward=int8_per[0], **{f"{k}_launches": v
                                                   for k, v in launches.items()})
    del served, reset, ref, row
    if w8a8:
        ticks_rms = {}
        for kind in ("prefill", "decode"):
            kern, live = sub_step(snaps[kind])
            plain, _ = sub_step(snaps[kind], int8_plain=True)
            kern, plain = kern[live][:, :cfg.vocab_size], plain[live][:, :cfg.vocab_size]
            ticks_rms[kind] = rel_rms(kern, plain)
            same = torch.equal(kern, plain)
            print(f"serving {name}: the {kind} sub-step (counts "
                  f"{snaps[kind]['args'][2].tolist()}) with the int8 kernel vs the int8 "
                  f"products' plain version: relative RMS {ticks_rms[kind]:.3e} (tol "
                  f"{W8A8_LOGIT_REL_RMS}), bitwise equal {same}, finite "
                  f"{bool(torch.isfinite(kern).all())}", flush=True)
            check(bool(torch.isfinite(kern).all()) and ticks_rms[kind] <= W8A8_LOGIT_REL_RMS,
                  f"{name}: the {kind} sub-step's int8 kernel path differs from the plain "
                  f"one: {ticks_rms[kind]}")
            del kern, plain
        result.update(tick_rel_rms=ticks_rms)
    if trace:
        with xlstm_annotations(torch) if cfg.xlstm is not None else contextlib.nullcontext():
            traces = trace_replays(
                torch, lambda cache, *args: step_rows_full(b.params, b.cfg, cache, *args,
                                                           ctx=ctx),
                {k: snaps[k] for k in ("prefill", "decode")}, f"serving {name}", "sub-step")
        result.update(traces=traces)
    del b, snaps, snap
    if own_params:
        del params
    torch.cuda.empty_cache()
    return result


def rg_w8a8_requests(np, vocab):
    """Phase 4b's 10 prompts (three past 2304 tokens), 16 new tokens each."""
    return [(p, 16) for p in rg_prompts(np, vocab)]


def phase_rg_w8a8(torch, np, rl, im, fa, pa):
    """4c: recurrentgemma-9b (bf16, 38 layers) served by a clipped-softmax
    (alpha 4) W8A8 engine: ``phase_recurrent_serving`` with its sub-steps
    traced."""
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.recurrentgemma_9b import full
    cfg = apply_method(full(), "clipped_softmax", alpha=4.0)
    t0 = time.perf_counter()
    out = phase_recurrent_serving(torch, np, rl, im, fa, pa, "rg clipped-w8a8", cfg,
                                  rg_w8a8_requests(np, cfg.vocab_size), 4096, w8a8=True,
                                  trace=True, row_tol=RECURRENT_W8A8_ROW_REL_RMS,
                                  min_pos=cfg.window)
    phase_wall("4c", t0)
    return out


def rg_eval_cfg(method, **method_kw):
    """recurrentgemma-9b at full width with ``method``, unrolled (as PTQ
    needs)."""
    from repro_torch.configs.base import apply_method
    from repro_torch.configs.recurrentgemma_9b import full
    return dataclasses.replace(apply_method(full(), method, **method_kw), scan_layers=False)


def xlstm_cfg():
    from repro_torch.configs.xlstm_1_3b import full
    return full()


def phase_mlstm_cell(torch):
    """9a: one mLSTM layer's cell at xlstm-1.3b's shapes (4 heads of 1024),
    T 512, f32 from a seed: the chunkwise form (chunk 128) against the
    recurrent oracle within MLSTM_REL_RMS, h and the final (C, n, m); the
    chunkwise form over two halves without the state carried (the
    control) above it; both forms timed. Then the sLSTM scan's eager
    kernels per step, counted in a torch.profiler trace at (8, 64, 2048)."""
    from repro_torch.nn import xlstm

    xc = xlstm_cfg().xlstm
    h, d, t = xc.n_heads, xc.dh_inner, 512
    gen = torch.Generator().manual_seed(41)
    q, k, v = (torch.randn(1, t, h, d, generator=gen).cuda() for _ in range(3))
    logi = torch.randn(1, t, h, generator=gen).cuda()
    logf = torch.nn.functional.logsigmoid(torch.randn(1, t, h, generator=gen) + 3.0).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hc, sc = xlstm.mlstm_chunkwise(q, k, v, logi, logf, xc.chunk_size)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        hr, sr = xlstm.mlstm_recurrent_ref(q, k, v, logi, logf)
        torch.cuda.synchronize()
        rec_ms = (time.perf_counter() - t0) * 1e3
        half = t // 2
        h1, _ = xlstm.mlstm_chunkwise(*(x[:, :half] for x in (q, k, v, logi, logf)),
                                      xc.chunk_size)
        h2, _ = xlstm.mlstm_chunkwise(*(x[:, half:] for x in (q, k, v, logi, logf)),
                                      xc.chunk_size)
        lost = torch.cat([h1, h2], dim=1)
    errs = {"h": rel_rms(hc, hr), "C": rel_rms(sc[0], sr[0]), "n": rel_rms(sc[1], sr[1]),
            "m": rel_rms(sc[2], sr[2])}
    control = rel_rms(lost, hr)
    print(f"xlstm mLSTM cell (1, {t}, {h}, {d}) f32, chunk {xc.chunk_size}: chunkwise vs the "
          f"recurrent oracle, relative RMS {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
          f"(tol {MLSTM_REL_RMS}); control, the state not carried across the halves: "
          f"{control:.3e}; host wall chunkwise {chunk_ms:.2f} ms, recurrent {rec_ms:.2f} ms",
          flush=True)
    check(max(errs.values()) <= MLSTM_REL_RMS and bool(torch.isfinite(hc).all()),
          f"mLSTM chunkwise differs from its recurrent oracle: {errs}")
    check(control > MLSTM_REL_RMS, f"the mLSTM check cannot tell a dropped state: {control}")
    del q, k, v, hc, hr, sc, sr, lost, h1, h2
    # the sLSTM scan's eager kernels per step
    bsz, steps, dm = 8, 64, xc.d_model
    zifo = [torch.randn(bsz, steps, dm, generator=gen).cuda() for _ in range(4)]
    r = {n: (0.1 * xc.dh_model ** -0.5 * torch.randn(
        xc.n_heads, xc.dh_model, xc.dh_model, generator=gen)).cuda()
        for n in ("rz", "ri", "rf", "ro")}
    with torch.no_grad():
        xlstm.slstm_scan(*zifo, r, xc.n_heads)         # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xlstm.slstm_scan(*zifo, r, xc.n_heads)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) * 1e3
        tr = trace_tick(torch, lambda: xlstm.slstm_scan(*zifo, r, xc.n_heads), "sLSTM scan")
    kernels = sum(tr["family_kernels"].values())
    per_step = kernels / steps
    print(f"xlstm sLSTM scan ({bsz}, {steps}, {dm}) f32: {kernels} device kernels under "
          f"torch.profiler = {per_step:.2f} per step; host wall {scan_ms:.2f} ms = "
          f"{scan_ms / steps:.4f} ms per step", flush=True)
    return dict(errs=errs, control=control, chunk_ms=chunk_ms, recurrent_ms=rec_ms,
                slstm_kernels_per_step=per_step, slstm_ms_per_step=scan_ms / steps)


def phase_xlstm(torch, np, rl, im, fa, fq, pa):
    """9: xlstm-1.3b at its published width and depth (bf16, 48 blocks,
    7:1 mLSTM:sLSTM, random weights from seed 0): (a) ``phase_mlstm_cell``;
    (b) phase 5's evaluation (XLSTM_EVAL_BATCH x XLSTM_EVAL_SEQ: the sLSTM
    runs one eager step a token), unrolled; (c) fp and W8A8 paged engines
    on the same weights over ``short_requests``' 12 requests, the W8A8
    one's sub-steps traced."""
    t0 = time.perf_counter()
    cell = phase_mlstm_cell(torch)
    cfg = dataclasses.replace(xlstm_cfg(), scan_layers=False)
    ev = phase_eval(torch, np, fa, fq, pa, im, "xlstm-1.3b", cfg, seq=XLSTM_EVAL_SEQ,
                    batch_size=XLSTM_EVAL_BATCH)
    from repro_torch.models.transformer import model_init
    reqs = short_requests(np, cfg.vocab_size, 12)
    # the row check, gated: f32, one pattern group (7 mLSTM + 1 sLSTM)
    f32 = dataclasses.replace(xlstm_cfg(), n_layers=len(cfg.pattern),
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    engines = [phase_recurrent_serving(torch, np, rl, im, fa, pa, "xlstm-1.3b fp f32 8 blocks",
                                       f32, reqs, 1024, row_tol=XLSTM_ROW_REL_RMS)]
    # published depth, bf16: the row check printed (see XLSTM_ROW_REL_RMS)
    params = model_init(0, xlstm_cfg(), device="cuda")
    engines += [phase_recurrent_serving(torch, np, rl, im, fa, pa, f"xlstm-1.3b {kind}",
                                        xlstm_cfg(), reqs, 1024, params=params, w8a8=w8a8,
                                        trace=w8a8, row_tol=None)
                for kind, w8a8 in (("fp", False), ("w8a8", True))]
    del params
    torch.cuda.empty_cache()
    phase_wall("9", t0)
    return dict(cell=cell, eval=ev, engines=engines)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch.kernels import build
        from repro_torch.kernels import fake_quant as fq
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import int8_matmul as im
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import rg_lru as rl
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and convolutions", flush=True)

    card = nvidia_smi()
    print(card, flush=True)
    t_run = time.perf_counter()

    def mark(phase):
        print(f"phase {phase} starts {time.perf_counter() - t_run:.1f} s into the run",
              flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:   # one nvcc per source
        built = dict(zip(KERNEL_SOURCES, ex.map(build.build, KERNEL_SOURCES)))
    for name, (path, secs) in built.items():
        ptxas = [line.split("ptxas info    :")[-1].strip()
                 for line in build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in line or "spill stores" in line]
        print(f"built {name}: {path.name} in {secs:.1f} s; ptxas per kernel: "
              f"{'; '.join(ptxas) or 'n/a'}", flush=True)
    print(f"build phase {time.perf_counter() - t0:.1f} s", flush=True)
    # the instantiations bf16 data at Dh 128 runs, and flash's Dh-32 ones
    # (both routes), must not spill
    held = [(name, fn, regs, spills) for name in ("flash_attention", "paged_attention")
            for fn, regs, spills in ptxas_report(build.BUILD_LOG.get(name, ""))
            if bf16_dh128(fn) or flash_dh(fn, (32, 80, 96))]
    n32 = sum(flash_dh(fn, (32,)) for _, fn, _, _ in held)
    n80 = sum(flash_dh(fn, (80, 96)) for _, fn, _, _ in held)
    print(f"ptxas spill check: {len(held) - n32 - n80} bf16 Dh-128 instantiations of "
          f"flash_attention and paged_attention (the flash ones also run bf16 Dh 80 and 96), "
          f"{n32} Dh-32 and {n80} f32 Dh-80/96 flash instantiations; registers "
          f"{sorted({r for _, _, r, _ in held})}; spill stores "
          f"{sorted({sp for _, _, _, sp in held})}", flush=True)
    check(len(held) - n32 - n80 >= 8 and n32 == 4 and n80 == 4,
          f"expected the bf16 Dh-128, the Dh-32 and the Dh-80/96 instantiations in the "
          f"build log: {held}")
    check(all(sp == 0 for _, _, _, sp in held),
          f"ptxas spills in bf16 Dh-128, Dh-32 or Dh-80/96 attention kernels: "
          f"{[(n, f) for n, f, _, sp in held if sp]}")
    # every int8 instantiation must not spill; ptxas's notes that it
    # serialized wgmma (C7515, C7520, ...) are printed
    int8_log = build.BUILD_LOG.get("int8_matmul", "")
    int8_fns = ptxas_report(int8_log)
    serial = sorted({line.split(":", 1)[-1].strip() for line in int8_log.splitlines()
                     if re.search(r"C75\d\d", line)})
    print(f"ptxas spill check: {len(int8_fns)} int8_matmul instantiations; registers "
          f"{[(re.sub(r'^_Z[^a-z]*', '', f)[:48], r) for f, r, _ in int8_fns]}; spill stores "
          f"{sorted({sp for _, _, sp in int8_fns})}; wgmma serialization notes: "
          f"{serial or 'none'}", flush=True)
    check(len(int8_fns) >= 6, f"expected the int8 instantiations in the build log: {int8_fns}")
    check(all(sp == 0 for _, _, sp in int8_fns),
          f"ptxas spills in int8 kernels: {[f for f, _, sp in int8_fns if sp]}")
    # both rg_lru routes (the TMA ring at 1, 2, 4 and 8 warps, direct
    # loads) must not spill
    rg_fns = ptxas_report(build.BUILD_LOG.get("rg_lru", ""))
    print(f"ptxas spill check: {len(rg_fns)} rg_lru entries; registers "
          f"{[(re.sub(r'^_Z[^a-z]*', '', f)[:40], r) for f, r, _ in rg_fns]}; spill stores "
          f"{sorted({sp for _, _, sp in rg_fns})}", flush=True)
    check(len(rg_fns) >= 5, f"expected the rg_lru entries in the build log: {rg_fns}")
    check(all(sp == 0 for _, _, sp in rg_fns),
          f"ptxas spills in rg_lru kernels: {[f for f, _, sp in rg_fns if sp]}")

    # the backward kernels (dq vanilla and clipped and dk/dv at each of Dh 32
    # and 64, and the GQA head sum) must not spill; ptxas's wgmma
    # serialization notes are printed
    bwd_log = build.BUILD_LOG.get("flash_attention_bwd", "")
    bwd_fns = ptxas_report(bwd_log)
    bwd_serial = sorted({line.split(":", 1)[-1].strip()[:120] for line in bwd_log.splitlines()
                         if re.search(r"C75\d\d", line)})
    print(f"ptxas spill check: {len(bwd_fns)} flash_attention_bwd entries; registers "
          f"{[(re.sub(r'^_Z[^a-z]*', '', f)[:32], r) for f, r, _ in bwd_fns]}; spill stores "
          f"{sorted({sp for _, _, sp in bwd_fns})}; wgmma serialization notes: "
          f"{bwd_serial or 'none'}", flush=True)
    check(len(bwd_fns) == 7, f"expected the 7 backward entries in the build log: {bwd_fns}")
    check(all(sp == 0 for _, _, sp in bwd_fns),
          f"ptxas spills in flash_attention_bwd: {[f for f, _, sp in bwd_fns if sp]}")

    mark("3")
    max_err = phase_kernel_checks(torch, pa)
    phase_paged_tc_precision(torch, pa)
    times = phase_kernel_times(torch, pa)
    mark("3b")
    int8_err = phase_int8_checks(torch, im)
    int8_times = phase_int8_times(torch, im)
    mark("3c")
    flash_err = phase_flash_checks(torch, fa)
    flash_times = phase_flash_times(torch, fa)
    phase_flash_paper_times(torch, fa)
    phase_flash_paper_times(torch, fa, MODEL_FLASH_TIMED, ("bfloat16",))
    phase_flash_decode_times(torch, fa, pa)
    phase_flash_paper_times(torch, fa, MOE_FLASH_TIMED, ("bfloat16",))
    phase_flash_paper_times(torch, fa, MOE_FLASH_TIMED_F32, ("float32",))
    for moe_name, heads in MOE_PAGED.items():
        phase_kernel_times(torch, pa, heads, ("vanilla",), f"{moe_name} ")
    phase_int8_times(torch, im, MOE_INT8_SHAPES, None)
    phase_flash_dh256(torch, fa, build)
    mark("3d")
    fq_err = phase_fq_checks(torch, fq)
    fq_times = phase_fq_times(torch, fq)
    phase_kv_quant(torch)
    mark("3f")
    rg_err = phase_rg_checks(torch, rl)
    rg_times = phase_rg_times(torch, rl)

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    mark("4")
    qwen_reqs = short_requests(np, qwen_cfg("vanilla").vocab_size, 12)
    engines = [
        phase_serving(torch, np, pa, im, fa, name, qwen_cfg(method, **kw), qwen_reqs, 1024,
                      W8A8_LOGIT_REL_RMS if w8a8 else LOGIT_REL_RMS,
                      max_abs=None if w8a8 else LOGIT_MAX_ABS, kv_int8=kv, w8a8=w8a8,
                      trace=w8a8, dense=(method, kw) if dense else None)
        for name, method, kw, kv, w8a8, dense in (
            ("vanilla", "vanilla", {}, False, False, True),
            ("clipped", "clipped_softmax", {"alpha": 4.0}, False, False, True),
            ("gated-int8kv", "gated_attention", {}, True, False, True),
            ("clipped-w8a8", "clipped_softmax", {"alpha": 4.0}, False, True, True),
            ("gated-w8a8-int8kv", "gated_attention", {}, None, True, False))]
    mark("4b")
    rg_engines = [
        phase_rg_serving(torch, np, rl, fa, pa, "vanilla", "vanilla", trace=True, gen=True),
        phase_rg_serving(torch, np, rl, fa, pa, "clipped", "clipped_softmax", alpha=4.0),
        phase_rg_serving(torch, np, rl, fa, pa, "gated", "gated_attention")]
    mark("4c")
    rg_w8a8 = phase_rg_w8a8(torch, np, rl, im, fa, pa)
    mark("5")
    evals = [phase_eval(torch, np, fa, fq, pa, im, name, qwen_eval_cfg(method, **kw))
             for name, method, kw in METHODS]
    mark("5b")
    evals += [phase_eval(torch, np, fa, fq, pa, im, f"{family} {name}",
                         paper_cfg(family, method, **kw), kind=kind, seq=seq, batch_size=bsz,
                         layer_tol=PAPER_LAYER_REL_RMS, own_tol=PAPER_LOGIT_REL_RMS,
                         logit_tol=PAPER_LOGIT_REL_RMS)
              for family, kind, seq, bsz in PAPER_EVALS for name, method, kw in METHODS]
    opt_reqs = opt_requests(np, paper_cfg("opt", "vanilla").vocab_size)
    opt_engines = [
        phase_serving(torch, np, pa, im, fa, f"opt-125m {name}",
                      paper_cfg("opt", method, **kw), opt_reqs, OPT_MAX_LEN,
                      OPT_W8A8_TICK_REL_RMS if w8a8 else OPT_TICK_REL_RMS,
                      ticks=("mixed", "past the table"), paged=paged, w8a8=w8a8,
                      controls=("P in bf16", "positions one early"))
        for name, method, kw, paged, w8a8 in (
            *((name, method, kw, True, False) for name, method, kw in METHODS),
            ("clipped-w8a8", "clipped_softmax", {"alpha": 4.0}, True, True),
            ("vanilla-dense", "vanilla", {}, False, False))]
    contrast = phase_outlier_contrast(torch, np)
    mark("5c")
    t0 = time.perf_counter()
    evals += [phase_eval(torch, np, fa, fq, pa, im, f"recurrentgemma-9b {name}",
                         rg_eval_cfg(method, **kw), rl=rl) for name, method, kw in METHODS]
    phase_wall("5c", t0)
    mark("6")
    bwd_err = phase_bwd_checks(torch, fa)
    bwd_times = phase_bwd_times(torch, fa)
    trains = [phase_train(torch, np, fa, family, kind, seq, bsz, method, kw,
                          trace=method == "vanilla")
              for family, kind, seq, bsz in TRAIN_RUNS for _, method, kw in METHODS]
    mark("7")
    vit = phase_vit(torch, np, fa, fq, pa, im)
    hubert = phase_hubert(torch, np, fa, fq, pa, im)
    phi = phase_phi3v(torch, np, pa, im, fa)
    gemma = phase_gemma2(torch, np, pa, im, fa)
    mark("8")
    moe = phase_moe(torch, np, pa, im, fa, fq)
    mark("9")
    xl = phase_xlstm(torch, np, rl, im, fa, fq, pa)
    mark("10")
    evals += vit["evals"] + [hubert] + moe["evals"] + [xl["eval"]]
    trains += vit["trains"] + [moe["train"]]
    forwards = [phi["forward"], gemma["forward"]]
    new_engines = [phi["serving"]] + gemma["engines"] + moe["engines"]
    recurrent = [rg_w8a8] + xl["engines"]

    dec = times[("decode", "vanilla")]
    i8 = int8_times[(8, 5120, 17408)]
    # launches on the main path: phase 4's engines with their dense paths
    # (generate and paged=False), phase 4b with recurrentgemma's generate,
    # phase 5
    dense = [e["dense"] for e in engines if "dense" in e]
    int8_launches = sum(e["int8_launches"]
                        for e in engines + dense + opt_engines + new_engines + recurrent)
    flash_launches = sum(e["flash_launches"] + e.get("gen_launches", 0)
                         for e in engines + evals + dense + opt_engines + trains + forwards)
    rg_launches = sum(e["launches"] for e in rg_engines) + sum(
        g["rg_launches"] for e in rg_engines for g in e.get("generate", {}).values()) + sum(
        e.get("rg_lru_launches", 0) for e in evals + recurrent)
    kernels = [dict(name="paged_attention", route="cuda",
                    source=KERNEL_SOURCES["paged_attention"],
                    replaces=REPLACES["paged_attention"],
                    launches=sum(e["paged_launches"]
                                 for e in engines + opt_engines + new_engines),
                    max_abs_err=max_err, ms=dec["ms"], plain_ms=dec["plain_ms"],
                    bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                    library_ms=dec["library_ms"]),
               dict(name="int8_matmul", route="cuda",
                    source=KERNEL_SOURCES["int8_matmul"],
                    replaces=REPLACES["int8_matmul"],
                    launches=int8_launches,
                    max_abs_err=int8_err, ms=i8["ms"], plain_ms=i8["plain_ms"],
                    bound_ms=i8["bound_ms"], bound_by=i8["bound_by"],
                    library_ms=i8["library_ms"]),
               dict(name="flash_attention", route="cuda",
                    source=KERNEL_SOURCES["flash_attention"],
                    replaces=REPLACES["flash_attention"],
                    launches=flash_launches,
                    max_abs_err=flash_err, **flash_times["vanilla"]),
               dict(name="fake_quant", route="cuda",
                    source=KERNEL_SOURCES["fake_quant"],
                    replaces=REPLACES["fake_quant"],
                    launches=sum(e["fake_quant_launches"] for e in evals),
                    max_abs_err=fq_err, **fq_times[(2048, 17408)]),
               dict(name="rg_lru", route="cuda", source=KERNEL_SOURCES["rg_lru"],
                    replaces=REPLACES["rg_lru"],
                    launches=rg_launches,
                    max_abs_err=rg_err, **rg_times[(8, 256, 4096)]),
               dict(name="flash_attention_bwd", route="cuda",
                    design="3xTF32 wgmma over a TMA ring on the forward's saved row "
                           "statistics: dq, then dk/dv (GQA: per query head, then a head sum)",
                    source=KERNEL_SOURCES["flash_attention_bwd"],
                    replaces=REPLACES["flash_attention_bwd"],
                    launches=sum(t["bwd_launches"] for t in trains),
                    max_abs_err=bwd_err, **bwd_times[("bert-base", "vanilla")])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
