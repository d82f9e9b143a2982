#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and ``nvidia-smi`` name / power limit;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a (all started together),
   printing the build seconds and the ``-Xptxas -v`` lines of each kernel
   (its mangled name, registers, stack frame, spills);
3. kernels: each kernel against its plain PyTorch version on the card, BITWISE
   (NaN positions matched), for every pack member, extrapolation on and off,
   bf16 and f32, at the main paths' shapes, a ragged size and edge inputs
   (every boundary and its neighbours, +-inf, NaN, -2e38, lo, +-0): the pack
   kernels (value, TableFlash, value + slope) and the single-table kernels
   (value, value + slope) over ``ApproxConfig.table_for`` of the six default
   functions, subnormal lanes included; the pack kernels (value, value +
   slope) also over stablelm's members at e_a 3e-7 and the table kernels
   over silu's table at e_a 3e-8 and 1e-8 (each staging image's bytes and
   the kernel that stages it logged: the pack's or table's image where it
   fits the 48 KB budget, pack_image_kernel; the member's row and the values
   past it, pack_kernel); TableFlash also over ("silu", "exp_neg") at e_a
   3e-8 (exp_neg's staging image of 23 KB staged) and at e_a 3e-9 (its image
   past the 48 KB budget: the pack kernel's staging), with subnormal lanes;
   and, on the same pack (the dense and MoE families' approx settings are
   stablelm's), phases 25-27's and 31-33's shapes: the gate member of each
   (``gelu`` at d_ff 12288 and 15360 up to gemma3's long prefill, ``silu``
   at 20480, and the MoE gates: deepseek-moe-16b's routed experts over
   their (64, C, 1408) buffer and its shared experts over (T, 2816),
   qwen3-moe-235b-a22b's experts over (128, C, 1536), C the capacity of T
   tokens) at its decode and prefill shapes, the exponents at each model's
   head layout and kv chunk (deepseek's 16 x 128, qwen3's 64 q / 4 kv,
   g_eff 16), and the training gates and exponent slopes of starcoder2,
   gemma3 and deepseek-moe-16b ((64, 61, 1408) and (512, 2816)); and phases
   35-37's: zamba2's softplus on dt (4, S, 64), silu on x and the gate
   (4, S, 4096), on B and C (4, S, 64) and its GLU's (4, S, 8192), xlstm's
   exp_neg over (4, 4, L, L), (4, 4, L), (4, 4) and (4, 768) (L = 1, S0, 128),
   sigmoid over (4, S, 768) and (4, 768) and tanh over (4, 768), at S = 1,
   S0 and the training micro-batch's 128; every member's inputs also hold
   -1e30 (the xLSTM stabilizers' start, far below exp_neg's lo); and phases
   39-40's: whisper-small's ``gelu`` over its encoder's (4, 1500, 3072) and
   its decoder's (4, S, 3072), the exponents of its encoder's 512 x 1024
   chunks, its cross-attention's (4, S, 16, 1, 1024) over the 1,500 frames
   and its self-attention's, internvl2-1b's ``silu`` over (4, 256 + S0,
   4864) and (4, 1, 4864) and its exponents over the 256 + 256 cache and
   the 256 + S0 prefix and tokens, and their training micro-batch's; the
   encoder's and cross-attention's last kv chunk holds 548 KV_PAD lanes
   after its 476 real keys, whose exponent input is -2e38;
4. serving path: full-width, full-depth stablelm-3b (random weights from seed
   0) serving the launcher's default traffic (8 requests, batch 4, cache 256,
   16 new tokens) through ContinuousEngine in ``table_pack`` with TableFlash;
   both kernels must have launched, and the same queue served through the
   plain versions (``table_pack_ref``) must give identical tokens; one
   prefill and decode step's logits equal ``table_pack_ref``'s (within
   1e-6), the decode step launching the gate once a layer and the exponent
   twice a layer and kv chunk;
5. reference: a reduced stablelm in float32 on the card against the same
   model on the CPU (logits within 1e-4, identical greedy tokens);
6. training path: full-width, full-depth stablelm-3b (2.80 B f32 parameters,
   random from seed 0) trained 4 steps in ``table_pack`` with TableFlash at
   the trainer's defaults (batch 8, seq 128, accum 2, AdamW, SyntheticLM
   batches); ``table_pack_grad`` and ``tableflash_exp`` must have launched,
   the losses must be finite, the last step's loss must be below the first
   and the first batch's loss must fall over the 4 steps, and step 0 must
   equal the plain versions' (``table_pack_ref``) loss bit for bit and grad
   norm within 1e-3.  (Each step's loss is printed beside the untrained
   model's loss on the same batch: at vocab 50,304 the batch-to-batch spread
   of the loss is larger than what 4 steps move a batch the model has not
   seen, so the first batch before and after the steps is what shows that
   the trainer learns.)
7. table_pallas path: full-width stablelm-3b cut to 4 layers, serving the
   same 8 requests token-identical to ``table_ref`` and training 2 steps with
   step-0 loss equal to ``table_ref``'s; ``table_lookup`` and
   ``table_lookup_grad`` must have launched, and the gate's table's staging
   image must fit the 48 KB budget (pack_image_kernel);
8. times: each kernel, its plain version and a PyTorch yardstick, at its
   path's shape, by CUDA events around a CUDA graph of repeated calls
   (device time, no host launch cost); TableFlash also at the prefill and
   training exponent shapes;
9. QuantPack / PolyPack kernels: the four kernels of the quantized and
   polynomial packs (value, value + slope) bitwise against their plain
   versions, NaN positions matched, over every member of stablelm-3b's quant
   and poly packs (e_a 1e-4), the mixed-degree / mixed-width poly pack
   (tanh d1 f32, exp_neg d3 int8, gelu d2 int16), the same at e_a 1e-8
   (each poly pack's bytes a block stages and the kernel that stages them
   logged: the whole staging image where it fits the 48 KB budget, the
   member's lanes and codes past it), the quant pack at e_a
   1e-6 (119 to 279 sub-intervals a member; its staging image staged,
   quant_image_kernel) and at e_a 3e-7 (its image past the budget,
   quant_kernel; the decode gate and two ragged sizes), f32 and bf16,
   extrapolation on and off, at the main paths' shapes, a ragged size and
   the edge inputs with subnormal lanes;
10. QuantPack / PolyPack serving: full-width, full-depth stablelm-3b (the
   same seed-0 weights) serving the same 8 requests in ``quant_pack`` and in
   ``poly_pack``, each with TableFlash; ``quant_pack_lookup`` /
   ``poly_pack_lookup`` and ``tableflash_exp`` must have launched and the
   tokens must equal the plain versions' (``quant_pack_ref`` /
   ``poly_pack_ref``);
11. QuantPack / PolyPack training: full width cut to 8 of the 32 layers
   (phases 15, 19 and 23 too: the run keeps to 900 s with phases 31-34;
   phase 6 trains the main path at full depth), 2 steps each in
   ``quant_pack`` and ``poly_pack`` with TableFlash at the trainer's
   defaults; ``quant_pack_grad`` / ``poly_pack_grad`` must have launched,
   step 0's loss must equal the ``_ref`` mode's bit for bit and its grad norm
   be within 1e-3;
12. their times, as in phase 8;
13. routed kernels: the four routed kernels (f32 pack and quantized pack,
   value and value + slope) bitwise against their plain versions AND, row by
   row, against the static kernel of the row's member, NaN positions
   matched, over every member of stablelm-3b's f32 pack (its staging image
   staged whole) and of the f32 pack at e_a 3e-7 (its image past the 48 KB
   budget: a row restaged per member), of stablelm-3b's quant pack, the
   reference's mixed int8/int16 pack and the quant pack at e_a 1e-6 (each
   quant pack's staging image staged whole) and at e_a 3e-7 (its image past
   the 48 KB budget: restaged per member), f32 and
   bf16, extrapolation off, on and per member, at the unary shapes of the
   paths (one id, the tensor one row), a routed_fn batch of 512 x 6912 rows
   cycling over the members, a ragged (70000, 3) (more rows than a grid's y
   or z extent) and the edge inputs; then a routed call captured in a CUDA
   graph whose ids tensor is rewritten in place between replays must follow
   the new routing (both f32 and both quant staging paths);
14. routed serving: full stablelm-3b serving the 8 requests in
   ``routed_pack`` and ``routed_quant_pack`` (+ TableFlash); the routed value
   kernel and ``tableflash_exp`` must have launched, and the tokens must
   equal the ``_ref`` mode's and the static mode's (``table_pack`` /
   ``quant_pack``, served in phases 4 and 10);
15. routed training: 2 steps each in ``routed_pack`` and
   ``routed_quant_pack`` (+ TableFlash) at the trainer's defaults, as phase 11
   (8 layers; step 0 also equal to the static mode's at 8 layers);
16. their times, as in phase 8, beside the static kernel of the same member
   at the same shape (the cost of dynamic dispatch), and the 512 x 6912 mixed
   batch against the six static launches it replaces;
17. RangeFold and routed PolyPack kernels: the folded kernels (value, value +
   slope) bitwise against their plain versions, NaN positions matched, for
   sin, cos, exp and log, f32 and bf16, at the rotary angle shapes and two
   ragged sizes, over the full-range samples of tests/harness/fullrange.py
   (every decade, both signs, near-multiples of pi/2 in both reduction
   regimes, powers of two, subnormals, +-0, +-inf, NaN), 200,000 draws
   with |x| >= 2048 (Payne-Hanek) and, for sin and cos, warps that mix
   Payne-Hanek lanes with small ones, over stablelm-3b's folded pack (each
   kind's staging image staged) and the cores at e_a 1e-10 (past the
   budget); the routed poly kernels as phase 13 does the other routed
   kernels, over stablelm-3b's poly pack and the mixed poly pack (the whole
   pack staged) and the mixed poly pack at e_a 1e-8 (past the budget:
   restaged per member), re-routed inside a CUDA graph too;
18. table-served RoPE and routed PolyPack serving: stablelm-3b at full
   width cut to 4 of its 32 layers (their ``_ref`` runs through the plain
   folded trig took ~46 s each at full depth) serving the 8 requests (+
   TableFlash) with ``rope_table`` in ``table_pack``, ``folded_pack`` and
   ``folded_routed_pack`` (tokens equal to the ``_ref`` mode's and to
   ``table_pack``'s with ``rope_table``), and full stablelm-3b in
   ``routed_poly_pack`` (tokens equal to ``routed_poly_pack_ref``'s and to
   phase 10's ``poly_pack``); ``folded_pack_lookup`` and
   ``routed_poly_pack_lookup`` must have launched;
19. their training (8 layers): 2 steps each at the trainer's defaults in
   ``table_pack`` with ``rope_table`` and in ``routed_poly_pack`` (+
   TableFlash), step 0 as in phase 11 and ``routed_poly_pack``'s step-0
   loss equal to ``poly_pack``'s of phase 11; then ``ApproxConfig(mode="folded_pack")
   .unary(name)`` under autograd for each of sin, cos, exp and log (the
   rotary angles carry no gradient, so the model's step does not reach the
   folded grad kernel): ``folded_pack_grad`` must launch and the gradient be
   bitwise the plain slope times dy;
20. their times, as in phase 16 (the folded kernels beside ``torch.sin`` /
   ``cos`` / ``exp`` / ``log``, also at the decode and prefill angles; the
   routed poly kernels beside the static poly kernel of the same member);
21. ShardedPack kernels: the static sharded kernels (value, its slope mode
   and value + slope, each one launch over all the shards) and each shard's
   single contribution bitwise against their plain versions, NaN positions
   matched, and the one-launch value, slope and value + slope bitwise equal
   to the S single-shard launches (value, slope) added in shard order in x's
   dtype (the S-launch path they replace), over every member of
   stablelm-3b's pack cut into 1, 2, 3, 4 and 8 shards and of ``("silu",
   "exp_neg")`` at e_a 1e-8 in 2 shards (slices past the kernels' 48 KB
   shared budget, read from global memory), f32 and bf16, extrapolation on
   and off, at the gate shapes of the paths, a ragged size and the edge
   inputs; the sum of the shards equal to the replicated kernel
   (``table_pack_lookup`` / ``table_pack_grad``) as values (a sum turns an
   owner's -0.0 into +0.0; at a NaN x the meaningless extrapolated slope
   reads another entry); the routed sharded kernels as phase 13 does the
   routed kernels (the static sharded kernels row by row, the one-launch
   value also against the S one-shard routed launches added, the
   value + slope at the training gate as one row too, the
   replicated routed kernels as values, the 512 x 6912 ``routed_fn``
   batch), re-routed inside a CUDA graph too;
22. ShardedPack serving: full stablelm-3b serving the 8 requests in
   ``sharded_pack`` at ``pack_shards=4`` (+ TableFlash), tokens equal to
   ``sharded_pack_ref``'s and to phase 4's ``table_pack``, 1 sharded launch
   for each gate call of phase 4, and the decode step ms of ``table_pack``,
   ``sharded_pack`` and ``sharded_pack_ref`` in alternating rounds; then
   ``routed_activation`` of ``sharded_pack`` over the 512 x 6912 batch, value
   and gradient (the routed sharded kernels: 1 value launch, 1 grad
   launch), bitwise the plain mode's;
23. ShardedPack training (8 layers): 2 steps at the trainer's defaults at
   ``pack_shards=4``, step-0 loss equal to ``sharded_pack_ref``'s and to
   ``table_pack``'s at 8 layers bit for bit, and a third step under the
   profiler (device busy time and its kernels, as phase 6's); one
   ``sharded_pack_grad`` launch a gate call;
24. their times: each sharded call at the decode and the training gate (the
   value one launch over 4 shards, beside the 4 single-shard launches and 3
   adds it replaces; the grads one launch over 4 shards, beside the 4
   single-shard value and 4 slope launches and 2 x 3 adds), a launch over the
   1-shard pack, the replicated static and routed kernels of the same
   member, the plain versions and ``F.silu``; the 512 x 6912 mixed batch as
   one routed sharded call against the six static sharded calls and the
   replicated routed kernel;
25. starcoder2-3b (plain 2-matrix ``gelu`` MLP, 24 q / 2 kv heads padded to
   32, d_head 128, d_ff 12288, vocab 49152; random weights from seed 0) at
   full width and depth serving the 8 requests in ``table_pack`` with
   TableFlash, token-identical to ``table_pack_ref``; prefill and decode
   logits and one decode step's launches as phase 4's; its decode-step
   times as phase 26's; then trained 2 steps at
   full depth at the trainer's defaults (3.37 B f32 parameters; AdamW
   moments and two grad trees at accum 2, ~63 GiB peak): step-0 loss equal
   to ``table_pack_ref``'s bit for bit, grad norm within 1e-3, and
   ``table_pack_grad`` launched as often a layer and micro-batch as phase 6's
   silu gate and flash slopes;
26. gemma3-12b at full width cut to 12 of its 48 layers (2 groups of 5
   local layers with a 1,024-token window and 1 global, d 3840, 16 q / 8 kv
   heads x 256, qk-norm, ``gelu_tanh`` GLU at d_ff 15360, tied embeddings,
   vocab 262144; 11.77 B f32 parameters at 48) serving the 8 requests
   as phase 25 does, then 2 prompts of 1,100-1,200 tokens in a 2,048-token
   cache, which wrap the local rings, token-identical to ``table_pack_ref``;
   the launches of one decode step at each cache; one round of
   ``table_pack``'s decode-step and prefill ms (phase 4 alone times
   ``table_pack_ref`` and ``exact`` beside it, in two rounds, and profiles
   the step); then one local:global group (6 of its 48 layers:
   the f32 AdamW state of all 48 does not fit one card) trained 2 steps as
   phase 25's starcoder2-3b, the tied embedding taking both uses' grads;
27. yi-34b (56 q / 8 kv heads padded to 64, d_head 128, rope theta 5e6,
   ``silu`` GLU at d_ff 20480) at full width cut to 12 of its 60 layers (24
   kept its f32 parameters under 3/4 of the card; 12 for the run's time)
   serving the 8 requests, with the logits, launches and times, as phase 25
   does;
28. reference: reduced gemma3-12b (its local window set to 8, so the
   prompts wrap the rings) and starcoder2-3b in float32 on the card against
   the same models on the CPU, as phase 5;
29. the paper's cells through the table kernel: Fig. 3 (log, reference
   spacing, Ea 1.25e-4), Figs. 4-5 (log, Ea 1.22e-4: reference, binary,
   hierarchical eps 0.015, sequential eps 0.3), Table 2's six cells (Ea
   9.5367e-7, hierarchical, omega 0.3) and Table 3's six (omega 0.1), each
   designed by ``run_flow(verify_error=True)`` on the host and built as a
   ``TorchTable`` on the card; ``table_lookup`` over the cell's edge inputs
   and 2^22 uniform f32 points in [lo, hi) bitwise equal to its plain
   version (NaN positions matched, extrapolation off and on), max |y - f(x)|
   (f in f64 on the same f32 x) within Ea plus the f32 rounding allowance
   ``rounding_allowance`` derives from the kernel's op order, the staging
   image's bytes equal to ``smem_cost``'s and staged, or past the 48 KB
   budget for Table 2 exp and Table 3 tan; one row a cell in the paper's
   Table 3 columns (M_F and BRAM18s of the reference and the split, image
   bytes, the error beside ``run_flow``'s) with the kernel's device time at
   2^24 f32 elements and its byte bound;
30. TableFlash's proven bound at full width: ``flash_attention`` with the
   ``tableflash_exp`` kernel over stablelm-3b's pack against exact exp on
   the same seeded f32 q, k, v, at stablelm-3b's decode and prefill (cache
   256) and gemma3-12b's global layer decoding at cache 2,048 (two kv
   chunks); each max row error within ``flash_abs_bound``;
31. deepseek-moe-16b (64 routed experts top-6 of d_ff 1408 + 2 shared, 16
   heads x 128 (MHA), vocab 102400; 16.88 B f32 parameters, random from
   seed 0) at full width cut to 7 of its 28 layers serving the 8 requests in
   ``table_pack`` + TableFlash, token-identical to ``table_pack_ref`` (the
   MoE's capacity is shared across the batch, so the oracle is the same
   queue, not each request alone); prefill and decode logits within 1e-6 of
   ``table_pack_ref``'s; one decode step launching the gate twice a layer
   (experts and shared experts) and the exponent twice a layer and kv
   chunk; the decode-step and prefill ms, the host time and op events of
   one decode step, and the peak memory, as phase 26;
32. deepseek-moe-16b trained 2 steps at full width cut to 4 of its 28
   layers (2.77 B f32 parameters: the f32 AdamW state of all 28 does not
   fit one card), as phase 25's training, each step's aux loss beside its
   loss, ``table_pack_grad`` launched 8 times a layer and micro-batch
   (stablelm's 6 and 2 for the shared experts' gate);
33. qwen3-moe-235b-a22b (128 experts top-8 of d_ff 1536, no shared expert,
   64 q / 4 kv heads x 128, qk-norm, vocab 151936) at full width cut to 6
   of its 94 layers (16.18 B f32 parameters) serving as phase 31, one gate
   launch a layer;
34. reference: reduced deepseek-moe-16b and qwen3-moe-235b-a22b in float32
   on the card against the same models on the CPU, as phase 5;
35. zamba2-1.2b (38 Mamba2 layers: 6 groups of 6 and 2 trailing, d 2048,
   expand 2, 64-wide heads, state 64, chunk 256; one shared attention + GLU
   block of 32 heads x 64 and d_ff 8192 used after each group; vocab 32000;
   1.17 B f32 parameters, random from seed 0) at full width and depth
   serving the 8 requests in ``table_pack`` + TableFlash, token-identical
   to ``table_pack_ref``; prefill and decode logits within 1e-6 of
   ``table_pack_ref``'s; one decode step launching the gates 5 times a
   Mamba2 layer (silu on x, B, C and the gate, softplus on dt, f32) and
   once a shared-block use (its GLU), 196 in all, and the exponent twice a
   use and kv chunk, 12; the decode-step and prefill ms, the host time and
   op events of one decode step and the peak memory, as phase 31;
36. zamba2-1.2b trained 2 steps at full width and depth as phase 25's
   training (remat: each group and each trailing layer checkpointed), step-0
   loss equal to ``table_pack_ref``'s bit for bit, grad norm within 1e-3,
   ``table_pack_grad`` launched twice for each gate call of a micro-batch
   (softplus slopes f32, silu gates; the shared block's as a stablelm layer's);
37. xlstm-125m (6 mLSTM/sLSTM pairs, d 768, 4 mLSTM heads, vocab 50304) at
   full width and depth serving the 8 requests as phase 35 (no attention:
   ``table_pack_lookup`` only, 10 launches a pair a decode step: 5 exp_neg
   and the output gate's sigmoid of the mLSTM, tanh, 2 exp_neg and sigmoid
   of the sLSTM step) and trained 2 steps as phase 36 at 3 of its 6 pairs
   (the sLSTM's 128-step loop over time in each layer);
38. reference: reduced zamba2-1.2b and xlstm-125m in float32 on the card
   against the same models on the CPU, as phase 5 (at least 2 refills);
39. whisper-small (12 bidirectional encoder layers over 1,500 stub frame
   embeddings with sinusoidal positions, 12 decoder layers of causal
   self-attention with RoPE, cross-attention into the encoder output and a
   ``gelu`` MLP at d_ff 3072; 12 heads x 64 padded to 16 kv groups; vocab
   51865; 0.278 B f32 parameters, random from seed 0) at full width and
   depth serving the 8 requests in groups of 4 through
   ``DecodeEngine.generate_batch`` with each group's frames (numpy seed),
   token-identical to ``table_pack_ref`` (ContinuousEngine serves
   token-only prompts); prefill and decode logits within 1e-6 of
   ``table_pack_ref``'s; one prefill launching 24 gates and 216 exponents
   and one decode step 12 and 72 (2 a kv chunk of each attention: 3 x 2
   chunk pairs of the encoder), as derived from the code; the decode-step
   and prefill ms, host time and op events and peak memory, as phase 31; then trained 2 steps at full depth as phase 25's training
   (step 0 bit-equal, grad norm within 1e-3, ``table_pack_grad`` 480 a
   micro-batch: 26 an encoder layer, 14 a decoder layer);
40. internvl2-1b (24 layers, 14 q / 2 kv heads x 64 repeated to 16 groups,
   ``silu`` GLU at d_ff 4864, vocab 151655, 256 stub patches of width 1024
   projected before the tokens; 0.631 B f32) served and trained as phase
   39, with patches (its cache 256 + 256 slots; 24 gates and 48 exponents a
   decode step; 144 grad launches a micro-batch);
41. reference: reduced whisper-small and internvl2-1b in float32 on the
   card against the CPU: prefill logits within 1e-4 and greedy tokens of 3
   groups through generate_batch identical;
42. device telemetry: stablelm-3b at full width cut to 8 of its 32 layers
   (seed-0 weights) serving the 8 requests (+ TableFlash) in
   ``table_pack``, ``quant_pack`` and ``routed_pack`` with the telemetry on,
   and their ``_ref`` modes too: each mode's tokens equal its ``_ref``
   mode's and its own telemetry-off run's, its whole counter dict equals
   its ``_ref`` mode's, each ``approx.lookups.*`` equals the count derived
   from the code (``served_lookups``: the gate's elements and flash
   attention's real keys and rows, per prefill and decode tick), and
   ``quant_pack``'s ``approx.quant_gathers.*`` is twice its lookups; a
   ``routed_fn`` over (gelu, silu, tanh, gelu) rows in ``routed_pack``, one
   launch, bitwise ``routed_pack_ref``'s, its dispatch counters equal; one
   ``table_pack`` training step's grads (batch 8 x 128, accum 2, remat) with
   the telemetry on: loss bit-equal to the off run's, counters equal to
   ``table_pack_ref``'s, the gate counted in the forward and again in
   remat's recompute; for each mode one decode step with the telemetry on
   and off: its ms in 2 rounds, host op events, kernel launches (equal) and
   device scalar reads (``aten::_local_scalar_dense`` / ``aten::item``),
   which must be 0; then the serve CLI (reduced, ``quant_pack``) and the
   train CLI (1 step, ``table_pack``) with ``--obs --trace`` as two
   processes, each trace valid by ``tools/check_trace.py``, its counters
   the ones ``--obs`` printed, rendered by ``tools/torch_obs_report.py``.
43. the mesh: stablelm-3b's pack (its approx settings) placed over a (1, S)
   ('data', 'model') mesh of S = 2 and then 4 gloo processes sharing the
   card (gloo all-reduces CUDA tensors; NCCL refuses two ranks on one GPU),
   each rank holding ONE values slice: first an all-reduce of a CUDA tensor
   (the probe), then ``eval_sharded_mesh``'s value and slope (the rank's
   ``tp_spack_lookup`` over its slice, all-reduced over 'model') BITWISE the
   off-mesh sharded kernels on the whole pack and equal to the replicated
   ones, for every member at phase 3's edge inputs and the gate at
   (4,1,6912) and (4,128,6912), bf16 and f32, extrapolation off and on, 2
   launches an evaluation in every rank (a rank that fails, or faults, fails
   the phase); then ``launch/train.py --mesh debug`` alone, a 1 x 1 NCCL
   mesh (weight-update sharding, ZeRO-1, the DTensor forward): stablelm-3b
   at full width cut to 8 of its 32 layers, 2 steps (batch 8 x 128, accum
   2) in ``sharded_pack`` at 1 shard, so that the pack is placed and its
   gate runs the mesh branch (``tp_spack_lookup`` 2 launches a gate call,
   ``tp_spack_grad`` none); the losses finite, step 0 within 0.05 and step
   1 (after the first update) within 1e-3 of the unmeshed port's two steps
   (the same init, data, optimizer and accumulation).

Each phase prints its wall seconds (``phase N: ...s``) and the run ends
with all of them in one line.  The line before the last is one JSON object
listing the kernels (each one's launches from the path it serves;
``table_lookup`` and ``tableflash_exp`` also carry ``paper_launches``,
theirs in phases 29-30, ``table_pack_lookup``, ``tableflash_exp`` and
``table_pack_grad`` ``moe_launches``, ``recurrent_launches`` and
``encdec_vlm_launches``, theirs in phases 31-33, 35-37 and 39-40, and the
kernels phase 42 runs ``obs_launches``, theirs with the telemetry on, and
``sharded_pack_lookup`` ``mesh_launches`` and ``mesh_rank_launches``,
phase 43's training and ranks'); the last line is ``{"ok": true, "device":
{...}}``.
Without a card, or outside a checkout of the repository, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MEM_BPS = 3.35e12  # H100 SXM HBM3, bytes/s
F32_OPS = 67e12  # H100 SXM f32 outside the tensor cores, op/s
BATCH, CACHE_LEN, N_REQ, MAX_NEW = 4, 256, 8, 16  # the launcher's defaults
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 128, 2  # the trainer's defaults, accum 2
TRAIN_STEPS, PALLAS_STEPS, PALLAS_LAYERS = 4, 2, 4
QP_STEPS = 2  # training steps of each of quant_pack, poly_pack and the routed modes
# the reference's tests/test_poly_pack.py MIXED pack: (member, degree, bits)
MIXED = (("tanh", 1, 32), ("exp_neg", 3, 8), ("gelu", 2, 16))
# the reference's tests/test_routed_pack.py mixed_width_pack: (member, code width)
MIXED_WIDTHS = (("gelu", "int8"), ("tanh", "int16"), ("log", "int16"),
                ("sigmoid", "int8"))
ROUTED_ROWS, ROUTED_COLS = 512, 6912  # a routed_fn batch: B*S rows of d_ff
RAGGED = (70_000, 3)  # more rows than a CUDA grid's y or z extent (65,535)
MICRO = TRAIN_BATCH // TRAIN_ACCUM
TIMING_REPS = 100
# each mode's served tokens (phases 4, 10, 14, 18; "+rope" marks rope_table): a
# routed or folded mode must serve its static mode's tokens
SERVED = {}
ROUTED_STATIC = {"routed_pack": "table_pack", "routed_quant_pack": "quant_pack",
                 "routed_poly_pack": "poly_pack",
                 "folded_pack+rope": "table_pack+rope",
                 "folded_routed_pack+rope": "table_pack+rope",
                 "sharded_pack": "table_pack"}
# each training mode's step-0 loss by (mode, depth) (phases 6, 11, 15, 19,
# 23): a routed or sharded mode must match its static mode's at its depth
STEP0 = {}
# phases 11, 15, 19 and 23 train stablelm-3b cut to 8 of its 32 layers, and
# phase 18 serves its three rope_table modes at 4 (their _ref runs through the
# plain folded trig took ~46 s each at 32 layers, ~12 s at 8), so that the run
# keeps to 900 s of its 1,200 s limit with the later phases; phases 4 and 6
# serve and train the main path at full depth
NON_MAIN_TRAIN_LAYERS, ROPE_SERVE_LAYERS = 8, 4
PACK_SHARDS = 4  # the sharded paths' shard count: silu, the gate, is split
SHARD_COUNTS = (1, 2, 3, 4, 8)  # the kernel checks'
SHARDED = ("sharded_pack", "sharded_pack_ref")
FOLDED = ("sin", "cos", "exp", "log")
SMEM_BUDGET = 48 * 1024  # a block's dynamic shared staging (kSmemBytes)
# stablelm-3b's rotary angles (d_head 80 -> 40 frequencies): decode, prefill
# (the queue's longest prompt, 27), training micro-batch
ROPE_SHAPES = ((BATCH, 1, 40), (BATCH, 27, 40), (MICRO, TRAIN_SEQ, 40))
# phases 25-27: yi-34b serves 24 of its 60 layers, the deepest multiple of 4
# whose f32 parameters (14.68 B, 58.7 GB; 28 layers 67.9 GB, 60 layers 141 GB)
# stay under 3/4 of the card's 80 GB; gemma3-12b trains one local:global group (6 of 48 layers:
# 2.35 B f32 parameters, 37.6 GB with grads and AdamW moments); its long
# queue: 2 prompts of 1,100-1,200 tokens in a 2,048-token cache, wrapping its
# 1,024-slot rings
# (phases 26, 27 and 31 serve gemma3-12b at 12 of 48 layers, two
# local:global periods, yi-34b at 12 of 60 and deepseek-moe-16b at 7 of 28, so
# that the run keeps to 900 s with phases 39-43: 939.0 s with the first two
# at full depth, 1,023.0 s at 24, 24 and 14, each on a slow host)
YI_LAYERS, GEMMA_TRAIN_LAYERS, GEMMA_SERVE_LAYERS = 12, 6, 12
LONG_REQ, LONG_LEN, LONG_CACHE = 2, (1100, 1200), 2048
DENSE_FAMILY = ("starcoder2-3b", "gemma3-12b", "yi-34b")
# phases 31-34: deepseek-moe-16b serves 14 of its 28 layers (16.88 B f32
# parameters, 62.9 GiB at 28) and trains 4 (2.77 B: the f32 AdamW state of all
# 28, ~270 GB, does not fit one card); qwen3-moe-235b-a22b serves 6 of its 94
# layers (16.18 B, 64.7 GB; each layer holds 2.49 B)
MOE_FAMILY = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
MOE_TRAIN_LAYERS, QWEN_LAYERS, DEEPSEEK_SERVE_LAYERS = 4, 6, 7
# phases 35-38: zamba2-1.2b (38 Mamba2 layers, 6 uses of one shared attention
# + GLU block; 1.17 B f32) and xlstm-125m (6 mLSTM/sLSTM pairs) at full width
# and depth.  The gate calls of their blocks, by the code: a Mamba2 layer
# silu on x, B, C and the gate z and softplus on dt; an mLSTM block 5 exp_neg
# a chunk (carry, intra-chunk, denominator, carry rescale, chunk-end weights)
# and its output gate's sigmoid; an sLSTM step tanh, 2 exp_neg and sigmoid
RECURRENT_FAMILY = ("zamba2-1.2b", "xlstm-125m")
# phase 37 trains xlstm-125m at 3 of its 6 pairs: an sLSTM step is a loop over
# time, ~13 s a step at all 6 on a slow host
XLSTM_TRAIN_LAYERS = 6
MAMBA_GATES, MLSTM_CHUNK_GATES, MLSTM_GATES, SLSTM_STEP_GATES = 5, 5, 1, 4
# phases 39-41: whisper-small (12 encoder layers over 1,500 stub frame
# embeddings, 12 decoder layers that cross-attend to them) and internvl2-1b
# (24 layers after 256 projected stub patches) at full width and depth,
# served in groups of BATCH through DecodeEngine.generate_batch with their
# frames / patches (ContinuousEngine serves token-only prompts), each group's
# drawn from numpy seed EXTRA_SEED + its index
ENCDEC_VLM_FAMILY = ("whisper-small", "internvl2-1b")
EXTRA_SEED = 7
NEG_INF = -2.0e38  # flash_attention's masked score: a KV_PAD lane's exponent
PHASE_S = {}  # each phase's wall seconds
Q_CHUNK, KV_CHUNK = 512, 1024  # flash_attention's query and kv chunks
OBS_ROUTING = ("gelu", "silu", "tanh", "gelu")  # phase 42's routed_fn rows
# phase 43: the mesh path on one card.  The sharded pack's mesh branch runs
# across MESH_RANKS gloo processes that share the card (gloo all-reduces CUDA
# tensors; NCCL refuses two ranks on one GPU), each holding one slice; then
# the launcher's --mesh debug run alone, a 1 x 1 NCCL mesh, trains stablelm-3b
# at full width cut to NON_MAIN_TRAIN_LAYERS layers in sharded_pack at one
# shard, so that the pack is placed and its gate runs the mesh branch
MESH_RANKS = (2, 4)
MESH_RANK_TIMEOUT = 240  # seconds a rank group may take


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(label):
    """Time the phases ``label`` ("4", "9-12", ...) on the host's wall clock."""
    t0 = time.perf_counter()
    yield
    PHASE_S[label] = round(time.perf_counter() - t0, 1)
    log(f"phase {label}: {PHASE_S[label]}s")


# --------------------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------------------


def device_info():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    return name, smi_line


def build_kernels():
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"build: {sources} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for s in sources:
        for line in _build.build_log(s).splitlines():
            if any(k in line for k in ("Function properties", "registers", "smem",
                                       "spill")):
                log(f"  ptxas[{s}]: {line.strip()}")


# --------------------------------------------------------------------------------------
# 3. kernel vs plain, bitwise
# --------------------------------------------------------------------------------------


def _bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def bitwise_diff(a, b):
    """(mismatches, max |a-b| over finite pairs) with NaN positions matched."""
    import torch

    both_nan = torch.isnan(a) & torch.isnan(b)
    bad = (_bits(a) != _bits(b)) & ~both_nan
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = (a.float() - b.float()).abs()[fin]
    return int(bad.sum()), float(err.max()) if err.numel() else 0.0


def edge_values(pack, fid):
    return row_edges(pack.boundaries[fid, : pack.n_intervals[fid] + 1].cpu().numpy())


def row_edges(row):
    """Every boundary of a metadata row and its f32 neighbours, then the
    specials (+-inf, NaN, -2e38, 2e38, lo, +-0)."""
    import numpy as np

    lo = row[0]
    up = np.nextafter(row, np.float32(np.inf))
    down = np.nextafter(row, np.float32(-np.inf))
    special = np.asarray([np.inf, -np.inf, np.nan, -2e38, 2e38, lo, 0.0, -0.0],
                         np.float32)
    return np.concatenate([row, up, down, special]).astype(np.float32)


def make_input(shape, lo, hi, edges, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=g, device="cuda") * (hi - lo + 8.0) + (lo - 4.0)
    flat = x.view(-1)
    k = min(flat.numel(), edges.size)
    flat[:k] = torch.as_tensor(edges[:k], device="cuda")
    return x.to(dtype)


def check_pair(tag, got, want, shape, dtype):
    """Bitwise check of a kernel's outputs (a tensor or a tuple) against its
    plain version's; returns the largest finite |difference|."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == tuple(shape) and g.dtype == dtype, f"{tag}: shape/dtype")
        bad, e = bitwise_diff(g, w)
        check(bad == 0, f"{tag}: {bad} mismatches (max err {e})")
        err = max(err, e)
    return err


def flash_packs(pack, approx):
    """(tag, pack) of phase 3's TableFlash checks: stablelm-3b's pack and
    ("silu", "exp_neg") at e_a 3e-8, whose exp_neg staging images fit a
    block's 48 KB (one round trip stages them), and the same at e_a 3e-9,
    whose image does not (the pack kernel stages the row, the values are
    read from global memory)."""
    from repro_torch.approx.table_pack import build_pack

    packs = [("image", pack, True)]
    for e_a, fits in ((3e-8, True), (3e-9, False)):
        packs.append((f"e_a {e_a}", build_pack(("silu", "exp_neg"), e_a,
                                               omega=approx.omega, device="cuda"), fits))
    for tag, pk, fits in packs:
        nbytes = 4 * pk.flash_image[0].numel()
        check((nbytes <= SMEM_BUDGET) == fits,
              f"{tag} pack: exp_neg's staging image of {nbytes} bytes on the wrong "
              f"side of the {SMEM_BUDGET}-byte budget")
        log(f"kernels: TableFlash [{tag}] exp_neg image {nbytes} bytes "
            f"({'staged' if fits else 'past the budget'})")
    return tuple((tag, pk) for tag, pk, _ in packs)


def static_staging(tag, image, fits, what):
    """Check that a static launch over a pack or table whose staging image
    has ``image`` 32-bit words stages it (``fits``) or is past the 48 KB
    budget, and log which kernel that takes (``what``: (image kernel, the
    kernel past the budget))."""
    nbytes = 4 * image
    check((nbytes <= SMEM_BUDGET) == fits, f"{tag}: its {nbytes}-byte staging image "
          f"is on the wrong side of the {SMEM_BUDGET}-byte budget")
    log(f"kernels: [{tag}] staging image {nbytes} bytes: "
        + (f"staged ({what[0]})" if fits else f"past the budget ({what[1]})"))


def static_f32_packs(pack, approx):
    """(tag, pack, shapes) of phase 3's static f32-pack checks: stablelm-3b's
    pack (its 4,080-byte staging image staged, pack_image_kernel) at every
    gate shape, and its members at e_a 3e-7 (61,328 bytes, past the budget:
    pack_kernel) at the decode gate and two ragged sizes."""
    past = dataclasses.replace(approx, e_a=3e-7, mode="table_pack").pack("cuda")
    packs = (("f32", pack, None), ("f32 e_a 3e-7", past, [(BATCH, 1, 6912), (12345,),
                                                         (1,)]))
    for tag, pk, short in packs:
        static_staging(tag, pk.image[0].numel(), short is None,
                       ("pack_image_kernel", "pack_kernel"))
    return packs


def static_tables(approx, names):
    """(tag, table, shapes) of phase 3's single-table checks: the tables of
    ``names``, the six default functions (each staging image staged), at
    every shape, and silu's table at e_a 3e-8 (41,712 bytes: staged, several
    batches of loads) and at e_a 1e-8 (72,064 bytes: past the budget) at the
    decode gate and two ragged sizes."""
    short = [(BATCH, 1, 6912), (12345,), (1,)]
    tables = [(name, approx.table_for(name, "cuda"), None) for name in names]
    for e_a, fits in ((3e-8, True), (1e-8, False)):
        jt = dataclasses.replace(approx, e_a=e_a).table_for("silu", "cuda")
        tables.append((f"silu e_a {e_a}", jt, short))
        static_staging(f"silu table e_a {e_a}", jt.image.numel(), fits,
                       ("pack_image_kernel", "pack_kernel"))
    for tag, jt, _ in tables[: len(names)]:
        static_staging(f"{tag} table", jt.image.numel(), True,
                       ("pack_image_kernel", "pack_kernel"))
    return tables


def with_subnormals(edges):
    """Edge values and a subnormal of each sign (one bf16 holds too)."""
    import numpy as np

    tiny = np.finfo(np.float32).smallest_normal / 8
    return np.concatenate([edges, [tiny, -tiny]]).astype(np.float32)


def phase3_edges(pack, fid):
    """A member's edge inputs for phase 3: -1e30 first (the xLSTM
    stabilizers' start reaches exp_neg far below its lo; first, so that every
    input holds it), then the edges and subnormals."""
    import numpy as np

    return np.concatenate([[-1e30], with_subnormals(edge_values(pack, fid))]
                          ).astype(np.float32)


def with_kv_pad(x, kv_pad):
    """x with the lanes past the real keys of its last kv chunk set to what
    flash_attention's exponent sees there: a masked score (NEG_INF) less the
    running max, -2e38 in f32.  ``kv_pad`` maps an exponent shape to the
    real keys of its last chunk (``family_shapes``)."""
    n = kv_pad.get(tuple(x.shape))
    if n is not None:
        x[..., n:] = NEG_INF
    return x


def kernel_phase(f32_packs, s0, flash, dense, kv_pad):
    """The value kernels bitwise against their plain versions: stablelm-3b's
    gate and TableFlash shapes, and ``dense`` (``family_shapes``'s
    serving half: phases 25-27's, 31-33's, 35-37's and 39-40's gate shapes by
    member, their exponent shapes, whisper's with KV_PAD lanes, ``kv_pad``)
    on the f32 pack that serves them all."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    dense_gates, dense_flash = dense
    gate_shapes = [(BATCH, s0, 6912), (BATCH, 1, 6912), (12345,), (1,)]
    flash_shapes = [(BATCH, 1, 32, 1, CACHE_LEN), (BATCH, s0, 32, 1, s0),
                    (12345,), (1,)] + dense_flash
    worst = {"table_pack_lookup": 0.0, "tableflash_exp": 0.0}
    cases = 0
    for tag, pack, shapes in f32_packs:
        for fid, name in enumerate(pack.names):
            lo, hi = pack.domains[fid]
            edges = phase3_edges(pack, fid)
            for dtype in (torch.bfloat16, torch.float32):
                for shape in shapes or gate_shapes + dense_gates.get(name, []):
                    x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                    for ex in (False, True):
                        got = K.table_pack_lookup(pack, fid, x, extrapolate=ex)
                        want = K.table_pack_lookup_plain(pack, fid, x, extrapolate=ex)
                        torch.cuda.synchronize()
                        worst["table_pack_lookup"] = max(
                            worst["table_pack_lookup"], check_pair(
                                f"table_pack_lookup [{tag}] {name} {dtype} {shape} "
                                f"extrapolate={ex}", got, want, shape, dtype))
                        cases += 1
    for tag, pk in flash:
        fid = pk.fn_id("exp_neg")
        lo = pk.domains[fid][0]
        edges = with_subnormals(edge_values(pk, fid))
        for dtype in (torch.bfloat16, torch.float32):
            for shape in flash_shapes:
                x = with_kv_pad(make_input(shape, -40.0, 0.0, edges, dtype, seed=99),
                                kv_pad)
                got = K.tableflash_exp(pk, x)
                want = K.tableflash_exp_plain(pk, x)
                torch.cuda.synchronize()
                worst["tableflash_exp"] = max(worst["tableflash_exp"], check_pair(
                    f"tableflash_exp [{tag}] {dtype} {shape}", got, want, shape, dtype))
                check(bool((got[x < lo] == 0).all()), "tableflash zero tail")
                cases += 1
    log(f"kernels: {cases} kernel-vs-plain cases bitwise equal "
        f"(packs {[tag for tag, _, _ in f32_packs]}, bf16+f32, extrapolate on/off, "
        f"edges, -1e30 and subnormals; TableFlash over {[tag for tag, _ in flash]}; "
        f"phases 25-27's, 31-33's, 35-37's and 39-40's gates {dense_gates} and "
        f"exponent shapes {dense_flash}, KV_PAD lanes at {kv_pad})")
    return worst


def grad_kernel_phase(f32_packs, tables, s0, dense, kv_pad):
    """The value + slope pack kernel over every member of each f32 pack, and
    the single-table kernels over each table, bitwise against their plain
    versions.  ``dense`` (``family_shapes``'s training half) adds the
    families' training gates by member and exponent shapes (``kv_pad``:
    the encoder's with KV_PAD lanes)."""
    import torch

    from repro_torch.kernels import table_grad as TG
    from repro_torch.kernels import table_lookup as TL
    from repro_torch.kernels import table_pack_lookup as K

    dense_gates, dense_flash = dense
    train_gate = (MICRO, TRAIN_SEQ, 6912)
    all_shapes = [train_gate, (BATCH, 1, 6912), (BATCH, s0, 6912), (12345,), (1,)]
    worst = {"table_pack_grad": 0.0, "table_lookup": 0.0, "table_lookup_grad": 0.0}
    cases = 0
    for tag, pack, shapes in f32_packs:
        for fid, name in enumerate(pack.names):
            lo, hi = pack.domains[fid]
            edges = phase3_edges(pack, fid)
            member_shapes = shapes or all_shapes + dense_gates.get(name, [])
            if name == "exp_neg" and not shapes:  # TableFlash's slope: the exponent, f32
                member_shapes = all_shapes + [(MICRO, TRAIN_SEQ, 32, 1, TRAIN_SEQ)
                                              ] + dense_flash + dense_gates.get(name, [])
            for dtype in (torch.bfloat16, torch.float32):
                for shape in member_shapes:
                    x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                    if name == "exp_neg":
                        x = with_kv_pad(x, kv_pad)
                    for ex in (False, True):
                        got = K.table_pack_grad(pack, fid, x, extrapolate=ex)
                        want = K.table_pack_grad_plain(pack, fid, x, extrapolate=ex)
                        torch.cuda.synchronize()
                        worst["table_pack_grad"] = max(
                            worst["table_pack_grad"], check_pair(
                                f"table_pack_grad [{tag}] {name} {dtype} {shape} "
                                f"extrapolate={ex}", got, want, shape, dtype))
                        cases += 1
    for name, jt, shapes in tables:
        lo, hi = float(jt.boundaries[0]), float(jt.boundaries[-1])
        edges = with_subnormals(row_edges(jt.boundaries.cpu().numpy()))
        for dtype in (torch.bfloat16, torch.float32):
            for shape in shapes or all_shapes:
                x = make_input(shape, lo, hi, edges, dtype, seed=7)
                for ex in (False, True):
                    for kname, kern, plain in (
                            ("table_lookup", TL.table_lookup, TL.table_lookup_plain),
                            ("table_lookup_grad", TG.table_lookup_grad,
                             TG.table_lookup_grad_plain)):
                        got = kern(jt, x, extrapolate=ex)
                        want = plain(jt, x, extrapolate=ex)
                        torch.cuda.synchronize()
                        worst[kname] = max(worst[kname], check_pair(
                            f"{kname} {name} {dtype} {shape} extrapolate={ex}",
                            got, want, shape, dtype))
                        cases += 1
    log(f"kernels: {cases} grad/table kernel-vs-plain cases bitwise equal "
        f"(table_pack_grad over {[tag for tag, _, _ in f32_packs]}; "
        f"table_lookup[_grad] over {[tag for tag, _, _ in tables]}; bf16+f32, "
        f"extrapolate on/off, edges, -1e30 and subnormals, training gate {train_gate}; "
        f"the dense, MoE and recurrent families' training gates {dense_gates} "
        f"and exponents {dense_flash})")
    return worst


# --------------------------------------------------------------------------------------
# 4-5. main path and reference
# --------------------------------------------------------------------------------------


def main_path(smi_line):
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config

    base = get_config("stablelm-3b")
    cfg = base.replace(approx=dataclasses.replace(
        base.approx, mode="table_pack", attn_table=True))
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"main: {cfg.name} {cfg.n_layers}L d={cfg.d_model} {cfg.n_heads}H x "
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} (padded "
        f"{cfg.vocab_pad}), {cfg.param_count() / 1e9:.2f}B params "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f}s")
    reqs = make_requests(cfg.vocab, N_REQ, MAX_NEW)
    ref = build_model(_with_mode(cfg, "table_pack_ref"), "cuda")
    out, counts = serve_against_plain("main", model, ref, params, reqs, BATCH,
                                      CACHE_LEN, smi_line)
    SERVED["table_pack"] = [r.tokens for r in out]

    rows = prompt_rows(reqs, BATCH)
    ck = logits_and_launches("main", model, ref, params, rows, CACHE_LEN)
    exact = build_model(_with_mode(cfg, "exact"), "cuda")
    step_breakdown({"table_pack": model, "table_pack_ref": ref, "exact": exact},
                   params, rows, ck, smi_line)
    del params
    torch.cuda.empty_cache()
    return counts


def _mean_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_breakdown(models, params, rows, cache, smi_line, tag="", extra=None,
                   rounds=2, profile=True):
    """Host-clock ms of one prefill (B, S0; with ``extra``, the prefill's
    frames or patches) and one decode step (B, cache 256) per approx mode,
    in ``rounds`` alternating rounds after a warm-up; then, with ``profile``,
    a profiler view of the table_pack decode step: device busy share of the
    wall time and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pos = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32,
                     device="cuda")
    tok = rows[:, -1:]
    step_ms = {}
    with torch.inference_mode():
        for rnd in range(rounds):
            order = list(models.items()) if rnd == 0 else list(models.items())[::-1]
            for mode, m in order:
                fresh = m.init_cache(rows.shape[0], CACHE_LEN)
                _mean_ms(lambda: m.decode_step(params, tok, pos, cache), 2)
                dec = _mean_ms(lambda: m.decode_step(params, tok, pos, cache), 10)
                pre = _mean_ms(lambda: m.prefill(params, {"tokens": rows, **(extra or {})},
                                                 fresh), 3)
                step_ms[mode] = dec
                log(f"step: {tag}round {rnd} {mode}: decode {dec:.3f} ms, prefill "
                    f"(S0={rows.shape[1]}) {pre:.3f} ms [{smi_line}]")
        if not profile:
            return
        m = models["table_pack"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                m.decode_step(params, tok, pos, cache)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator row repeats the device time of its kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evs)
    if not evs:
        log("profile: no device time in key_averages(): not measured")
        return
    busy_ms = busy_us / 5e3
    log(f"profile: {tag}table_pack decode x5: wall {wall_us / 5e3:.3f} ms/step under the "
        f"profiler, device busy {busy_ms:.3f} ms/step; idle share "
        f"{1 - busy_ms / step_ms['table_pack']:.3f} of the unprofiled "
        f"{step_ms['table_pack']:.3f} ms step")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 5e3:8.3f} ms/step "
            f"{e.count // 5:5d} calls/step  {e.key[:90]}")


def reference_check(arch="stablelm-3b", window=None):
    """Reduced ``arch`` in f32: the card against the CPU (plain versions),
    its prefill logits and the greedy tokens of a queue through
    ContinuousEngine (whisper and internvl: through generate_batch, in
    groups with their frames or patches).  ``window`` sets the local layers'
    ``LOCAL_WINDOW`` for the check, so that the queue's prompts wrap a
    local:global stack's rings on both devices."""
    import torch

    from repro_torch.approx import ApproxConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, reduced
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ContinuousEngine, DecodeEngine, pad_and_batch

    cfg = reduced(arch).replace(
        compute_dtype="float32",
        approx=ApproxConfig(mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True))
    cpu_model = build_model(cfg, "cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = build_model(cfg, "cuda")

    def to_cuda(t):
        if isinstance(t, dict):
            return {k: to_cuda(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cuda(v) for v in t]
        return t.to("cuda")

    gpu_params = to_cuda(cpu_params)
    reqs = make_requests(cfg.vocab, 6, 8, seed=3)
    s0 = max(len(r.prompt) for r in reqs)
    rows = torch.zeros((2, s0), dtype=torch.int64)
    for j, r in enumerate(reqs[:2]):
        rows[j, s0 - len(r.prompt):] = torch.as_tensor(r.prompt)
    kept = transformer.LOCAL_WINDOW
    transformer.LOCAL_WINDOW = window or kept
    extra = extra_inputs(cpu_model, 2, EXTRA_SEED)
    cpu_extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    try:
        with torch.inference_mode():
            lc, _ = cpu_model.prefill(cpu_params, {"tokens": rows, **cpu_extra},
                                      cpu_model.init_cache(2, 64))
            lg, _ = gpu_model.prefill(gpu_params, {"tokens": rows.cuda(), **to_cuda(
                cpu_extra)}, gpu_model.init_cache(2, 64))
        err = float((lc - lg.cpu()).abs()[:, :cfg.vocab].max())
        check(err <= 1e-4, f"reduced {arch} f32 logits card vs CPU: {err} > 1e-4")
        if extra:  # frames or patches: the static engine, one group at a time
            a, b = ([DecodeEngine(m, p, 2, 64).generate_batch(
                toks, 8, extra_inputs=extra_inputs(m, 2, EXTRA_SEED + g))[0]
                for g, (_, toks) in enumerate(pad_and_batch(reqs, 2))]
                for m, p in ((cpu_model, cpu_params), (gpu_model, gpu_params)))
            how = f"{len(a)} groups of 2 through generate_batch"
        else:
            a = [r.tokens for r in ContinuousEngine(cpu_model, cpu_params, 2, 64
                                                    ).serve(reqs)]
            engine = ContinuousEngine(gpu_model, gpu_params, 2, 64)
            b = [r.tokens for r in engine.serve(reqs)]
            check(engine.refills >= 2, f"reduced {arch}: {engine.refills} refills < 2")
            how = f"{len(a)} requests through {engine.refills} refills"
    finally:
        transformer.LOCAL_WINDOW = kept
    for i, (x, y) in enumerate(zip(a, b)):
        check((x == y).all(), f"reduced {arch} request {i}: card tokens differ from CPU")
    wl = f", local window {window} (prompts of up to {s0} tokens)" if window else ""
    log(f"reference: reduced {arch} ({cfg.n_layers}L) f32 table_pack+TableFlash{wl}, "
        f"card vs CPU: max |logit diff| {err:.3e} (<= 1e-4), {how} token-identical")


# --------------------------------------------------------------------------------------
# 6-7. training path and table_pallas path
# --------------------------------------------------------------------------------------


def _with_mode(cfg, mode, **kw):
    return cfg.replace(approx=dataclasses.replace(cfg.approx, mode=mode, **kw))


def _shard_kw(mode):
    return {"pack_shards": PACK_SHARDS} if mode in SHARDED else {}


def _trainer_data(cfg):
    from repro_torch.data.pipeline import SyntheticLM, data_config_for
    from repro_torch.models import ShapeSpec

    return SyntheticLM(data_config_for(cfg, ShapeSpec(
        "smoke", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train")))


def plain_step0(ref_model, params, batch):
    """The plain versions' step-0 loss and grad norm on ``params`` (no
    update); no kernel may launch."""
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.optim import adamw
    from repro_torch.train.loop import accumulated_grads

    K.reset_launches()
    loss, grads = accumulated_grads(ref_model, params, batch, TRAIN_ACCUM)
    gn = float(adamw.global_norm(grads))
    check(all(v == 0 for v in K.launches.values()),
          f"{ref_model.cfg.approx.mode} launched a kernel: {K.launches}")
    return float(loss), gn


def train_steps(model, params, data, n_steps, smi_line, tag, profile_last=False,
                aux_model=None):
    """``n_steps`` of make_train_step (AdamW at the launcher's settings for
    that many steps) from ``params``, updated in place.  Returns per-step
    rows, the kernel launch counts of the run and the peak memory (GiB).
    With ``profile_last`` the last step runs under torch.profiler and its
    device busy time is returned as well.  With ``aux_model`` (an MoE
    model's _ref twin: the plain versions, which launch nothing) each step's
    aux loss, the mean over its micro-batches at the step's parameters, is
    taken before the step, outside its time, and printed beside its loss."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, make_train_step

    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=max(1, n_steps // 20),
                            total_steps=n_steps)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = make_train_step(model, opt, TRAIN_ACCUM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    rows, busy_ms = [], None
    for s in range(n_steps):
        batch = batch_to(data.batch_at(s), "cuda")
        aux = ""
        if aux_model is not None:
            with torch.no_grad():
                toks = batch["tokens"]
                micro = toks.reshape(TRAIN_ACCUM, -1, toks.shape[1])
                aux = sum(float(aux_model.train_logits(state["params"], {"tokens": t})[1])
                          for t in micro) / TRAIN_ACCUM
            aux = f" aux {aux:.6f}"
        prof = s == n_steps - 1 and profile_last
        t0 = time.perf_counter()
        if prof:
            state, m, busy_ms = profiled(lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"loss": loss, "grad_norm": gn, "ms": ms})
        log(f"{tag}: step {s} loss {loss:.6f}{aux} grad_norm {gn:.6f} lr "
            f"{float(m['lr']):.3e} {ms:.1f} ms{' (under the profiler)' if prof else ''} "
            f"[{smi_line}]")
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    return rows, counts, peak, busy_ms


def profiled(fn):
    """Run ``fn`` under torch.profiler; returns its result and the device's
    busy ms (kernel rows only: an operator row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3 if evs else None
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls  "
            f"{e.key[:90]}")
    return (*out, busy)


def train_path(smi_line):
    """Full-width, full-depth stablelm-3b, table_pack + TableFlash, 4 steps."""
    import math

    import torch

    from repro_torch.models import build_model, get_config
    from repro_torch.train.loop import batch_to

    cfg = _with_mode(get_config("stablelm-3b"), "table_pack", attn_table=True)
    model = build_model(cfg, "cuda")
    ref = build_model(_with_mode(cfg, "table_pack_ref"), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    data = _trainer_data(cfg)
    log(f"train: {cfg.name} {cfg.n_layers}L d={cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B {cfg.param_dtype} params, remat={cfg.remat}, "
        f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, accum {TRAIN_ACCUM}, AdamW")
    batches = [batch_to(data.batch_at(s), "cuda") for s in range(TRAIN_STEPS)]
    ref_loss, ref_gn = plain_step0(ref, params, batches[0])
    with torch.no_grad():
        untrained = [float(model.loss(params, b)) for b in batches]
    rows, counts, peak, busy_ms = train_steps(model, params, data, TRAIN_STEPS,
                                              smi_line, "train", profile_last=True)
    with torch.no_grad():
        first_after = float(model.loss(params, batches[0]))
    losses = [r["loss"] for r in rows]
    log(f"train: kernel launches {counts}; peak memory {peak:.2f} GiB [{smi_line}]")
    log(f"train: step losses {losses}; the untrained model's loss on the same "
        f"batches {untrained}; first batch {losses[0]:.4f} at step 0 -> "
        f"{first_after:.4f} after {TRAIN_STEPS} steps")
    for k in ("table_pack_grad", "tableflash_exp"):
        check(counts[k] > 0, f"kernel {k} was not launched on the training path")
    check(all(math.isfinite(v) for v in losses + [first_after]),
          f"non-finite losses {losses} {first_after}")
    check(losses[-1] < losses[0], f"loss did not fall: step losses {losses}")
    check(first_after < losses[0], f"loss did not fall: first batch {losses[0]} "
          f"at step 0, {first_after} after {TRAIN_STEPS} steps")
    check(losses[0] == ref_loss, f"step-0 loss {losses[0]!r} != table_pack_ref's "
          f"{ref_loss!r}")
    gn_rel = abs(rows[0]["grad_norm"] - ref_gn) / ref_gn
    check(gn_rel <= 1e-3, f"step-0 grad norm {rows[0]['grad_norm']} vs "
          f"table_pack_ref's {ref_gn}: {gn_rel:.2e} > 1e-3")
    STEP0["table_pack", cfg.n_layers] = losses[0]
    steady = [r["ms"] for r in rows[1:-1]]
    idle = f"{1 - busy_ms / min(steady):.3f}" if busy_ms and steady else "not measured"
    log(f"train: step-0 loss equals table_pack_ref's bit for bit ({ref_loss!r}); "
        f"grad norm {rows[0]['grad_norm']:.6f} vs {ref_gn:.6f} ({gn_rel:.2e} rel); "
        f"steady step "
        f"{min(steady):.1f}-{max(steady):.1f} ms; device busy "
        f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms in the profiled "
        f"step, idle share {idle} [{smi_line}]")
    del params, model, ref
    torch.cuda.empty_cache()
    return counts


def table_pallas_path(smi_line):
    """Per-function tables through the single-table kernels: stablelm-3b at
    full width cut to 4 layers, serving and training against table_ref."""
    import math

    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config
    from repro_torch.train.loop import batch_to

    cfg = _with_mode(get_config("stablelm-3b").replace(n_layers=PALLAS_LAYERS),
                     "table_pallas")
    model = build_model(cfg, "cuda")
    ref = build_model(_with_mode(cfg, "table_ref"), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    reqs = make_requests(cfg.vocab, N_REQ, MAX_NEW)
    _, serve_counts = serve_against_plain("pallas", model, ref, params, reqs, BATCH,
                                          CACHE_LEN, smi_line, ("table_lookup",))
    # the gate's table stages its staging image (pack_image_kernel)
    static_staging(f"table_pallas {cfg.act} table",
                   cfg.approx.table_for(cfg.act, "cuda").image.numel(), True,
                   ("pack_image_kernel", "pack_kernel"))

    data = _trainer_data(cfg)
    ref_loss, ref_gn = plain_step0(ref, params, batch_to(data.batch_at(0), "cuda"))
    rows, train_counts, peak, _ = train_steps(model, params, data, PALLAS_STEPS,
                                              smi_line, "pallas")
    check(train_counts["table_lookup_grad"] > 0,
          "table_lookup_grad was not launched training")
    check(all(math.isfinite(r["loss"]) for r in rows), "non-finite table_pallas loss")
    check(rows[0]["loss"] == ref_loss, f"table_pallas step-0 loss "
          f"{rows[0]['loss']!r} != table_ref's {ref_loss!r}")
    gn_rel = abs(rows[0]["grad_norm"] - ref_gn) / ref_gn
    check(gn_rel <= 1e-3, f"table_pallas step-0 grad norm: {gn_rel:.2e} > 1e-3")
    log(f"pallas: trained {PALLAS_STEPS} steps, step-0 loss equals table_ref's bit "
        f"for bit ({ref_loss!r}), grad norm {gn_rel:.2e} rel; launches "
        f"{train_counts}; peak {peak:.2f} GiB")
    del params, model, ref
    torch.cuda.empty_cache()
    return serve_counts, train_counts


# --------------------------------------------------------------------------------------
# 8. times
# --------------------------------------------------------------------------------------


def graph_ms(fn, reps=TIMING_REPS):
    """Device ms per call: CUDA events around one replay of a CUDA graph that
    holds ``reps`` calls (warmed up first, so no build or allocation inside)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(5):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()  # warm replay
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def member_bytes(t, fid=0):
    """Bytes one member's lookup needs of its pack or table: its own n + 1
    boundaries, its per-interval f32 metadata (invd, base, segs; + scale,
    zero, ramp for a quant pack; + zero, ramp, scale on each of its degree + 1
    lanes for a poly pack), and its own values or codes, from base[0] to the
    end of its last cell, at their element size.  Other members' rows and
    codes are not counted: the function does not read them."""
    if hasattr(t, "bounds_offset"):  # quant or poly pack: ragged flat lanes
        lo, n = t.lane_offset(fid), t.n_intervals[fid]
        base, segs = t.base[lo: lo + n], t.seg_count[lo: lo + n]
        codes = t.codes_for(fid)
        if hasattr(t, "degrees"):
            lanes = t.degrees[fid] + 1
            meta, entries = 3 * n + 3 * n * lanes, segs * lanes
        else:
            meta, entries = 6 * n, segs + 1
        elem = codes.element_size()
    else:  # f32 pack row fid, or a single table
        row = (lambda a: a[fid]) if t.base.dim() == 2 else (lambda a: a)
        n = t.n_intervals[fid] if t.base.dim() == 2 else t.n_intervals
        base, segs = row(t.base)[:n], row(t.seg_count)[:n]
        meta, entries, elem = 3 * n, segs + 1, 4
    n_codes = int((base + entries).max().item() - base[0].item())
    return 4 * (n + 1 + meta) + n_codes * elem


def bound(n, elem_bytes, n_out, tbytes, ops_per_elem):
    """(bound_ms, bound_by): bytes N*(in + n_out*out) + the table read once
    at the memory rate, against N*ops f32 operations at the f32 rate."""
    t_bytes = (n * (1 + n_out) * elem_bytes + tbytes) / MEM_BPS * 1e3
    t_ops = n * ops_per_elem / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(pack, approx, smi_line):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import table_grad as TG
    from repro_torch.kernels import table_lookup as TL
    from repro_torch.kernels import table_pack_lookup as K

    g = torch.Generator(device="cuda").manual_seed(7)
    silu = pack.fn_id("silu")
    jt = approx.table_for("silu", "cuda")
    exp_neg = pack.fn_id("exp_neg")
    # per element: the member's n compares + ~14 address/lerp operations, +2
    # for the TableFlash tail, +2 for the slope (subtract, multiply)
    ops = pack.n_intervals[silu] + 14
    t_ops = jt.n_intervals + 14
    gate = (torch.randn((BATCH, 1, 6912), generator=g, device="cuda") * 2).to(torch.bfloat16)
    gate_t = (torch.randn((MICRO, TRAIN_SEQ, 6912), generator=g, device="cuda")
              * 2).to(torch.bfloat16)
    z = -30.0 * torch.rand((BATCH, 1, 32, 1, CACHE_LEN), generator=g, device="cuda")
    # the exponent at prefill (the queue's longest prompt, 27) and training
    zp = -30.0 * torch.rand((BATCH, 27, 32, 1, 27), generator=g, device="cuda")
    zt = -30.0 * torch.rand((MICRO, TRAIN_SEQ, 32, 1, TRAIN_SEQ), generator=g,
                            device="cuda")
    rows = {}
    tb_silu, tb_exp, tb_jt = (member_bytes(pack, silu), member_bytes(pack, exp_neg),
                              member_bytes(jt))
    # (name, x, n_out, table bytes, ops, kernel, plain, yardstick, what the yardstick is)
    for name, x, n_out, tbytes, n_ops, kern, plain, lib, lib_what in (
        ("table_pack_lookup", gate, 1, tb_silu, ops,
         lambda: K.table_pack_lookup(pack, silu, gate, extrapolate=True),
         lambda: K.table_pack_lookup_plain(pack, silu, gate, extrapolate=True),
         lambda: F.silu(gate), "F.silu"),
        ("tableflash_exp", z, 1, tb_exp, pack.n_intervals[exp_neg] + 16,
         lambda: K.tableflash_exp(pack, z),
         lambda: K.tableflash_exp_plain(pack, z),
         lambda: torch.exp(z), "torch.exp"),
        ("tableflash_exp prefill", zp, 1, tb_exp, pack.n_intervals[exp_neg] + 16,
         lambda: K.tableflash_exp(pack, zp),
         lambda: K.tableflash_exp_plain(pack, zp),
         lambda: torch.exp(zp), "torch.exp"),
        ("tableflash_exp train", zt, 1, tb_exp, pack.n_intervals[exp_neg] + 16,
         lambda: K.tableflash_exp(pack, zt),
         lambda: K.tableflash_exp_plain(pack, zt),
         lambda: torch.exp(zt), "torch.exp"),
        ("table_pack_grad", gate_t, 2, tb_silu, ops + 2,
         lambda: K.table_pack_grad(pack, silu, gate_t, extrapolate=True),
         lambda: K.table_pack_grad_plain(pack, silu, gate_t, extrapolate=True),
         lambda: F.silu(gate_t), "F.silu, value only: no one call gives value + slope"),
        ("table_lookup", gate, 1, tb_jt, t_ops,
         lambda: TL.table_lookup(jt, gate, extrapolate=True),
         lambda: TL.table_lookup_plain(jt, gate, extrapolate=True),
         lambda: F.silu(gate), "F.silu"),
        ("table_lookup_grad", gate_t, 2, tb_jt, t_ops + 2,
         lambda: TG.table_lookup_grad(jt, gate_t, extrapolate=True),
         lambda: TG.table_lookup_grad_plain(jt, gate_t, extrapolate=True),
         lambda: F.silu(gate_t), "F.silu, value only: no one call gives value + slope"),
    ):
        ms, plain_ms, lib_ms = graph_ms(kern), graph_ms(plain), graph_ms(lib)
        b_ms, b_by = bound(x.numel(), x.element_size(), n_out, tbytes, n_ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"time: {name} {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us, yardstick ({lib_what}) "
            f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------
# 9-12. QuantPack and PolyPack: kernels, serving, training, times
# --------------------------------------------------------------------------------------


def quant_poly_packs(approx):
    """(kind, tag, pack) of the five packs phase 9 checks: stablelm-3b's own
    quant and poly packs, the quant pack at e_a 1e-6 and the mixed poly pack
    (each staging image staged), and the quant pack at e_a 3e-7 (its image
    past the budget)."""
    from repro_torch.approx.table_pack import from_poly_layout
    from repro_torch.core import design
    from repro_torch.core.packing import poly_pack_layout

    members = [design.poly_member(n, approx.e_a, degree=d, bits=b) for n, d, b in MIXED]
    packs = (("quant", "quant", approx.quant_pack("cuda")),
             ("quant", "quant e_a 1e-6",
              dataclasses.replace(approx, e_a=1e-6).quant_pack("cuda")),
             ("poly", "poly", approx.poly_pack("cuda")),
             ("poly", "mixed poly", from_poly_layout(poly_pack_layout(members), "cuda")),
             ("quant", "quant e_a 3e-7",
              dataclasses.replace(approx, e_a=3e-7).quant_pack("cuda")))
    for kind, tag, pk in packs:
        if kind == "quant":
            static_staging(tag, pk.image.numel(), "3e-7" not in tag,
                           ("quant_image_kernel", "quant_kernel"))
    return packs


def ragged_edge_values(pack, fid):
    bo = pack.bounds_offset(fid)
    return row_edges(pack.boundaries[bo: bo + pack.n_intervals[fid] + 1].cpu().numpy())


def poly_staging(pack):
    """What a block of the static poly kernels stages over ``pack``: the
    pack's staging image where it fits the budget (poly_image_kernel),
    otherwise (poly_kernel) each member's lanes and code group, or its lanes
    alone, as the budget allows."""
    image = 4 * pack.image.numel()
    if image <= SMEM_BUDGET:
        return f"each block stages the {image}-byte image (poly_image_kernel)"
    per = []
    for fid, n in enumerate(pack.n_intervals):
        meta = 4 * (4 * n + 1 + 3 * n * pack.max_lanes)
        codes = pack.codes_for(fid)
        full = meta + codes.numel() * codes.element_size()
        per.append(full if full <= SMEM_BUDGET else meta if meta <= SMEM_BUDGET else 0)
    return (f"image {image} bytes past the budget: each block stages {per} bytes "
            f"by member (poly_kernel)")


def quant_poly_kernel_phase(packs, s0):
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    kernels = {
        "quant": (("quant_pack_lookup", K.quant_pack_lookup, K.quant_pack_lookup_plain),
                  ("quant_pack_grad", K.quant_pack_grad, K.quant_pack_grad_plain)),
        "poly": (("poly_pack_lookup", K.poly_pack_lookup, K.poly_pack_lookup_plain),
                 ("poly_pack_grad", K.poly_pack_grad, K.poly_pack_grad_plain))}
    shapes = [(MICRO, TRAIN_SEQ, 6912), (BATCH, 1, 6912), (BATCH, s0, 6912),
              (12345,), (1,)]
    worst = {k: 0.0 for pair in kernels.values() for k, _, _ in pair}
    cases = 0
    for kind, tag, pack in packs:
        # a quant pack past the budget: the decode gate and two ragged sizes
        past = kind == "quant" and 4 * pack.image.numel() > SMEM_BUDGET
        for fid, name in enumerate(pack.names):
            lo, hi = pack.domains[fid]
            edges = with_subnormals(ragged_edge_values(pack, fid))
            for dtype in (torch.bfloat16, torch.float32):
                for shape in shapes[1:2] + shapes[3:] if past else shapes:
                    x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                    for ex in (False, True):
                        for kname, kern, plain in kernels[kind]:
                            got = kern(pack, fid, x, extrapolate=ex)
                            want = plain(pack, fid, x, extrapolate=ex)
                            torch.cuda.synchronize()
                            worst[kname] = max(worst[kname], check_pair(
                                f"{kname} [{tag}] {name} {dtype} {shape} extrapolate={ex}",
                                got, want, shape, dtype))
                            cases += 1
        log(f"kernels: [{tag}] members {pack.names}, intervals {pack.n_intervals}, "
            f"code bits {pack.entry_bits}"
            + (f", degrees {pack.degrees}; {poly_staging(pack)}" if kind == "poly"
               else ""))
    log(f"kernels: {cases} quant/poly kernel-vs-plain cases bitwise equal "
        f"(bf16+f32, extrapolate on/off, edges and subnormals, shapes {shapes}; "
        f"a quant pack past the budget at {shapes[1:2] + shapes[3:]})")
    return worst


def pack_serving_paths(smi_line, modes, n_layers=None):
    """Full stablelm-3b (``n_layers`` cuts its depth) serving the 8 requests
    in each ``(mode, kernels)`` of ``modes`` (+ TableFlash; a mode ending in
    "+rope" with ``rope_table``), each against its _ref mode and a routed or
    folded mode also against its static mode's tokens (``SERVED``, served
    at the same depth).  Every kernel named must launch."""
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config

    base = get_config("stablelm-3b")
    base = base.replace(n_layers=n_layers or base.n_layers)
    params = build_model(base, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    reqs = make_requests(base.vocab, N_REQ, MAX_NEW)
    counts = {}
    for key, knames in modes:
        mode, rope = key.split("+")[0], key.endswith("+rope")
        cfg = _with_mode(base, mode, attn_table=True, rope_table=rope,
                         **_shard_kw(mode))
        model = build_model(cfg, "cuda")
        ref = build_model(_with_mode(cfg, mode + "_ref"), "cuda")
        out, c = serve_against_plain(key, model, ref, params, reqs, BATCH, CACHE_LEN,
                                     smi_line, knames + ("tableflash_exp",))
        SERVED[key] = [r.tokens for r in out]
        static = ROUTED_STATIC.get(key)
        if static:
            for i, (a, b) in enumerate(zip(out, SERVED[static])):
                check((a.tokens == b).all(), f"{key} request {i}: tokens "
                      f"{a.tokens.tolist()} != {static}'s {b.tolist()}")
            log(f"{key}: token-identical to {static}")
        for k in knames:
            counts[k] = counts.get(k, 0) + c[k]
        del model, ref
    del params
    torch.cuda.empty_cache()
    return counts


def static_step0(cfg, static, params, batch):
    """The step-0 loss of the kernel mode ``static`` ("+rope" as in
    pack_serving_paths) on ``params`` and ``batch`` at ``cfg``'s depth:
    its grads through accumulated_grads, no update."""
    from repro_torch.models import build_model
    from repro_torch.train.loop import accumulated_grads

    mode, rope = static.split("+")[0], static.endswith("+rope")
    model = build_model(_with_mode(cfg, mode, rope_table=rope, **_shard_kw(mode)),
                        "cuda")
    loss, _ = accumulated_grads(model, params, batch, TRAIN_ACCUM)
    return float(loss)


def pack_train_paths(smi_line, modes, profile=False):
    """stablelm-3b at full width cut to NON_MAIN_TRAIN_LAYERS layers, QP_STEPS
    steps in each ``(mode, kernels)`` of ``modes`` (+ TableFlash; "+rope" as
    in pack_serving_paths), step 0 against the _ref mode and a routed or
    sharded mode's against its static mode's at the same depth (``STEP0``;
    taken here where no earlier phase trained the static mode that deep).
    Every kernel named must launch.  With ``profile`` one more step runs
    under torch.profiler: its device busy time against the unprofiled
    steady step gives the idle share."""
    import math

    import torch

    from repro_torch.models import build_model, get_config
    from repro_torch.train.loop import batch_to

    counts = {}
    base = get_config("stablelm-3b").replace(n_layers=NON_MAIN_TRAIN_LAYERS)
    for key, knames in modes:
        mode, rope = key.split("+")[0], key.endswith("+rope")
        cfg = _with_mode(base, mode, attn_table=True, rope_table=rope,
                         **_shard_kw(mode))
        model = build_model(cfg, "cuda")
        ref = build_model(_with_mode(cfg, mode + "_ref"), "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        data = _trainer_data(cfg)
        batch0 = batch_to(data.batch_at(0), "cuda")
        ref_loss, ref_gn = plain_step0(ref, params, batch0)
        static = ROUTED_STATIC.get(key)
        if static and (static, cfg.n_layers) not in STEP0:
            STEP0[static, cfg.n_layers] = static_step0(cfg, static, params, batch0)
        rows, c, peak, busy_ms = train_steps(model, params, data,
                                             QP_STEPS + int(profile), smi_line, key,
                                             profile_last=profile)
        check(all(c[k] > 0 for k in knames + ("tableflash_exp",)),
              f"{key}: {knames} / tableflash_exp not launched training: {c}")
        check(all(math.isfinite(r["loss"]) for r in rows), f"non-finite {mode} loss")
        check(rows[0]["loss"] == ref_loss, f"{mode} step-0 loss {rows[0]['loss']!r} "
              f"!= {mode}_ref's {ref_loss!r}")
        gn_rel = abs(rows[0]["grad_norm"] - ref_gn) / ref_gn
        check(gn_rel <= 1e-3, f"{mode} step-0 grad norm {rows[0]['grad_norm']} vs "
              f"{ref_gn}: {gn_rel:.2e} > 1e-3")
        STEP0[key, cfg.n_layers] = rows[0]["loss"]
        same = f"{mode}_ref's"
        if static:
            want = STEP0[static, cfg.n_layers]
            check(rows[0]["loss"] == want, f"{key} step-0 loss "
                  f"{rows[0]['loss']!r} != {static}'s {want!r}")
            same += f" and {static}'s"
        log(f"{key}: trained {len(rows)} steps ({cfg.n_layers} of 32 layers), "
            f"step-0 loss equals {same} bit "
            f"for bit ({ref_loss!r}), grad norm {rows[0]['grad_norm']:.6f} vs "
            f"{ref_gn:.6f} ({gn_rel:.2e} rel); step ms "
            f"{[round(r['ms'], 1) for r in rows]}; launches {c}; peak {peak:.2f} GiB "
            f"[{smi_line}]")
        if profile:
            steady = rows[QP_STEPS - 1]["ms"]
            idle = f"{1 - busy_ms / steady:.3f}" if busy_ms else "not measured"
            log(f"{key}: device busy {busy_ms if busy_ms is None else round(busy_ms, 3)} "
                f"ms in the profiled step, idle share {idle} of the unprofiled "
                f"{steady:.1f} ms step {QP_STEPS - 1} [{smi_line}]")
        for k in knames:
            counts[k] = counts.get(k, 0) + c[k]
        del params, model, ref
        torch.cuda.empty_cache()
    return counts


def quant_poly_timing_phase(quant, poly, smi_line):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import table_pack_lookup as K

    g = torch.Generator(device="cuda").manual_seed(7)
    gate = (torch.randn((BATCH, 1, 6912), generator=g, device="cuda") * 2).to(torch.bfloat16)
    gate_t = (torch.randn((MICRO, TRAIN_SEQ, 6912), generator=g, device="cuda")
              * 2).to(torch.bfloat16)
    qs, ps = quant.fn_id("silu"), poly.fn_id("silu")
    # f32 operations per element: n compares, then ~22 (quant: four address,
    # seven gathers' use, dequant 6, lerp 4) and, for a degree-d member,
    # ~10 + 6 (d + 1) + 2 d (+ 3 d for the tangent); +4 for a slope
    q_ops = quant.n_intervals[qs] + 22
    d = poly.degrees[ps]
    p_ops = poly.n_intervals[ps] + 10 + 6 * (d + 1) + 5 * d
    rows = {}
    for name, x, n_out, tbytes, n_ops, kern, plain in (
        ("quant_pack_lookup", gate, 1, member_bytes(quant, qs), q_ops,
         lambda: K.quant_pack_lookup(quant, qs, gate, extrapolate=True),
         lambda: K.quant_pack_lookup_plain(quant, qs, gate, extrapolate=True)),
        ("quant_pack_grad", gate_t, 2, member_bytes(quant, qs), q_ops + 4,
         lambda: K.quant_pack_grad(quant, qs, gate_t, extrapolate=True),
         lambda: K.quant_pack_grad_plain(quant, qs, gate_t, extrapolate=True)),
        ("poly_pack_lookup", gate, 1, member_bytes(poly, ps), p_ops,
         lambda: K.poly_pack_lookup(poly, ps, gate, extrapolate=True),
         lambda: K.poly_pack_lookup_plain(poly, ps, gate, extrapolate=True)),
        ("poly_pack_grad", gate_t, 2, member_bytes(poly, ps), p_ops + 4,
         lambda: K.poly_pack_grad(poly, ps, gate_t, extrapolate=True),
         lambda: K.poly_pack_grad_plain(poly, ps, gate_t, extrapolate=True)),
    ):
        lib_what = "F.silu" if n_out == 1 else "F.silu, value only: no one call gives value + slope"
        ms, plain_ms, lib_ms = graph_ms(kern), graph_ms(plain), graph_ms(lambda: F.silu(x))
        b_ms, b_by = bound(x.numel(), x.element_size(), n_out, tbytes, n_ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"time: {name} {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us, yardstick ({lib_what}) "
            f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------
# 13-16. routed dispatch: kernels, serving, training, times
# --------------------------------------------------------------------------------------


def mixed_width_pack(approx):
    """The reference's mixed int8/int16 quant pack (e_a 1e-4, default omega)."""
    from repro_torch.approx.table_pack import from_quant_layout
    from repro_torch.core.packing import quant_pack_layout
    from repro_torch.core.quantize import plan_quant_member

    return from_quant_layout(quant_pack_layout(
        [plan_quant_member(n, approx.e_a, dtype=d) for n, d in MIXED_WIDTHS]), "cuda")


def routed_f32_packs(pack, past):
    """(tag, pack) of phase 13's f32 packs: stablelm-3b's pack, whose
    staging image and per-member scalars fit the 48 KB a block of the routed
    f32 kernels stages whole (routed_pack_image_kernel), and stablelm's
    members at e_a 3e-7 (``past``, phase 3's), whose image does not
    (routed_kernel restages a row per member)."""
    packs = (("f32", pack), ("f32 e_a 3e-7", past))
    for tag, p in packs:
        whole = 4 * (p.image[0].numel() + 3 * p.n_functions)
        check((whole <= SMEM_BUDGET) == (p is not past),
              f"{tag} pack: {whole} staging bytes on the wrong side of the "
              f"{SMEM_BUDGET}-byte budget")
        log(f"routed f32: {tag} pack stages {whole} bytes "
            + ("whole (routed_pack_image_kernel)" if whole <= SMEM_BUDGET else
               f"past the budget: a row of {4 * (4 * p.n_max + 1)} bytes per member "
               f"and the {4 * p.footprint}-byte values as they fit (routed_kernel)"))
    return packs


def routed_quant_packs(approx, quant, fine, past):
    """(tag, pack) of phase 13's quant packs: stablelm-3b's quant pack, the
    reference's mixed int8/int16 pack and the quant pack at e_a 1e-6
    (``fine``), whose staging images and flags fit the 48 KB a block of the
    routed quant kernels stages whole, and stablelm's members at e_a 3e-7
    (``past``, phase 9's), whose image does not (the kernels restage per
    member)."""
    packs = (("quant", quant), ("mixed widths", mixed_width_pack(approx)),
             ("quant e_a 1e-6", fine), ("quant e_a 3e-7", past))
    for tag, p in packs:
        whole = 4 * (p.image.numel() + p.n_functions)
        check((whole <= SMEM_BUDGET) == (p is not past),
              f"{tag} pack: {whole} staging bytes on the wrong side of the "
              f"{SMEM_BUDGET}-byte budget")
        log(f"routed quant: {tag} pack stages {whole} bytes "
            f"({'whole' if whole <= SMEM_BUDGET else 'per member'})")
    return packs


def routed_fns(pack):
    """((name, routed kernel, plain version, static kernel), ...) of the value
    and the value + slope kernels of the pack's family."""
    from repro_torch.kernels import routed_pack_lookup as R
    from repro_torch.kernels import table_pack_lookup as K

    if hasattr(pack, "owned"):
        return (("sharded_routed_pack_lookup", R.sharded_routed_pack_lookup,
                 R.sharded_routed_pack_lookup_plain, K.sharded_pack_lookup),
                ("sharded_routed_pack_grad", R.sharded_routed_pack_grad,
                 R.sharded_routed_pack_grad_plain, K.sharded_pack_grad))
    if hasattr(pack, "n_max"):
        return (("routed_pack_lookup", R.routed_pack_lookup,
                 R.routed_pack_lookup_plain, K.table_pack_lookup),
                ("routed_pack_grad", R.routed_pack_grad, R.routed_pack_grad_plain,
                 K.table_pack_grad))
    if hasattr(pack, "degrees"):
        return (("routed_poly_pack_lookup", R.routed_poly_pack_lookup,
                 R.routed_poly_pack_lookup_plain, K.poly_pack_lookup),
                ("routed_poly_pack_grad", R.routed_poly_pack_grad,
                 R.routed_poly_pack_grad_plain, K.poly_pack_grad))
    return (("routed_quant_pack_lookup", R.routed_quant_pack_lookup,
             R.routed_quant_pack_lookup_plain, K.quant_pack_lookup),
            ("routed_quant_pack_grad", R.routed_quant_pack_grad,
             R.routed_quant_pack_grad_plain, K.quant_pack_grad))


def member_edges(pack, fid):
    return edge_values(pack, fid) if hasattr(pack, "n_max") else \
        ragged_edge_values(pack, fid)


def routed_input(pack, ids, cols, dtype, seed):
    """(len(ids), cols) input whose row r spans member ids[r]'s domain +- 4,
    with that member's edge inputs at the row's start."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((len(ids), cols), generator=g, device="cuda")
    lo = torch.tensor([pack.domains[f][0] for f in ids], device="cuda")[:, None]
    hi = torch.tensor([pack.domains[f][1] for f in ids], device="cuda")[:, None]
    x = x * (hi - lo + 8.0) + (lo - 4.0)
    for f, rows in member_rows(pack, ids).items():
        e = torch.as_tensor(member_edges(pack, f), device="cuda")
        k = min(cols, e.numel())
        x[rows, :k] = e[:k]
    return x.to(dtype)


def member_rows(pack, ids):
    """{member: the rows routed to it} (host ids, clamped as the kernels do)."""
    import torch

    host = ids.tolist() if isinstance(ids, torch.Tensor) else list(ids)
    out = {}
    for r, f in enumerate(host):
        out.setdefault(min(max(int(f), 0), pack.n_functions - 1), []).append(r)
    return {f: torch.tensor(rows, device="cuda") for f, rows in out.items()}


def check_routed(tag, fns, pack, ids, x, ex, worst):
    """Each routed kernel bitwise against its plain version and, member by
    member, its rows against the static kernel of that member."""
    import torch

    from repro_torch.approx.table_pack import routed_extr_flags
    from repro_torch.kernels import routed_pack_lookup as R

    flags = routed_extr_flags(pack, ex)
    groups = member_rows(pack, ids)
    for kname, kern, plain, static in fns:
        got = kern(pack, ids, x, extrapolate=ex)
        want = plain(pack, ids, x, extrapolate=ex)
        torch.cuda.synchronize()
        worst[kname] = max(worst[kname], check_pair(
            f"{kname} [{tag}] vs plain", got, want, x.shape, x.dtype))
        if kname == "sharded_routed_pack_lookup":
            check_pair(f"{kname} [{tag}] vs the {pack.n_shards} one-shard launches "
                       f"added", got, shard_launches_summed(
                           lambda s: R.sharded_routed_shard_contrib(
                               pack, ids, s, x, extrapolate=ex), pack.n_shards),
                       x.shape, x.dtype)
        for f, rows in groups.items():
            xs = x[rows]
            s = static(pack, f, xs, extrapolate=bool(flags[f]))
            g = tuple(t[rows] for t in got) if isinstance(got, tuple) else got[rows]
            check_pair(f"{kname} [{tag}] rows of {pack.names[f]} vs the static kernel",
                       g, s, xs.shape, x.dtype)


def routed_kernel_phase(packs, s0, unary=None, reroute=True):
    """Phase 13: every member, f32 and bf16, extrapolation off / on / per
    member, at the unary shapes, the routed_fn batch, the ragged shape and
    the edge inputs; then (``reroute``) the CUDA-graph re-route check of the
    first two packs."""
    import torch

    if unary is None:
        unary = [(1, BATCH * 6912), (1, BATCH * s0 * 6912),
                 (1, MICRO * TRAIN_SEQ * 6912)]
    worst = {k: 0.0 for _, pack in packs for k, *_ in routed_fns(pack)}
    cases = 0
    for tag, pack in packs:
        fns = routed_fns(pack)
        F = pack.n_functions
        cyc = [r % F for r in range(ROUTED_ROWS)]
        for dtype in (torch.bfloat16, torch.float32):
            for which in ("off", "on", "per member"):
                ex = (tuple(f % 2 == 0 for f in range(F)) if which == "per member"
                      else which == "on")
                t = f"{tag}, {dtype}, extrapolate {which}"
                for fid in range(F):  # the unary path: one id, one row
                    lo, hi = pack.domains[fid]
                    ids = torch.full((1,), fid, dtype=torch.int32, device="cuda")
                    for shape in unary:
                        x = make_input(shape, lo, hi, member_edges(pack, fid), dtype,
                                       seed=fid)
                        check_routed(f"{t}, {pack.names[fid]} {shape}", fns, pack,
                                     ids, x, ex, worst)
                        cases += 2
                x = routed_input(pack, cyc, ROUTED_COLS, dtype, seed=1)
                check_routed(f"{t}, mixed {x.shape}", fns, pack, cyc, x, ex, worst)
                # the same rows routed by a device tensor with ids out of range
                dev_ids = torch.tensor([-3, 10_000] + cyc[2:], device="cuda")
                check_routed(f"{t}, mixed, device ids", fns, pack, dev_ids, x, ex, worst)
                rag = [r % F for r in range(RAGGED[0])]
                x = routed_input(pack, rag, RAGGED[1], dtype, seed=2)
                check_routed(f"{t}, ragged {RAGGED}", fns, pack, rag, x, ex, worst)
                edges = list(range(F))
                width = max(member_edges(pack, f).size for f in edges)
                x = routed_input(pack, edges, width, dtype, seed=3)
                check_routed(f"{t}, edge rows", fns, pack, edges, x, ex, worst)
                cases += 8
        log(f"routed: [{tag}] members {pack.names}, intervals {pack.n_intervals}"
            + (f", code bits {pack.entry_bits}" if hasattr(pack, "entry_bits") else ""))
    log(f"routed: {cases} routed kernel cases bitwise equal to the plain versions "
        f"and, row by row, to the static kernels (bf16+f32, extrapolate off/on/"
        f"per member, unary shapes {unary}, mixed ({ROUTED_ROWS}, {ROUTED_COLS}), "
        f"ragged {RAGGED}, edge rows)")
    if reroute:
        reroute_check(packs[0][1], packs[1][1])
    return worst


def reroute_check(*packs):
    """A routed call captured in a CUDA graph reads its ids at replay: the
    ids tensor rewritten in place re-routes the replay."""
    import torch

    for pk in packs:
        F = pk.n_functions
        ids = torch.arange(ROUTED_ROWS, device="cuda", dtype=torch.int32) % F
        x = routed_input(pk, [r % F for r in range(ROUTED_ROWS)], ROUTED_COLS,
                         torch.bfloat16, seed=4)
        fns = routed_fns(pk)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            for _, kern, _, _ in fns:
                kern(pk, ids, x, extrapolate=True)
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [kern(pk, ids, x, extrapolate=True) for _, kern, _, _ in fns]
        g = torch.Generator(device="cuda").manual_seed(5)
        for new in (torch.randint(0, F, (ROUTED_ROWS,), generator=g, device="cuda"),
                    torch.full((ROUTED_ROWS,), F - 1, device="cuda"),
                    torch.randint(-3, F + 3, (ROUTED_ROWS,), generator=g, device="cuda")):
            ids.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            for (kname, _, plain, _), got in zip(fns, outs):
                check_pair(f"{kname} graph replay after re-routing", got,
                           plain(pk, ids, x, extrapolate=True), x.shape, x.dtype)
        log(f"routed: {[f[0] for f in fns]} captured in a CUDA graph, ids rewritten "
            f"in place 3 times, each replay bitwise equal to the plain version of "
            f"the new routing")


def routed_bytes(pack, fid, rows):
    """member_bytes plus the routing vectors: the ids (one a row) and the
    per-member interval counts, extrapolate flags and (quant) offsets and
    code widths."""
    return member_bytes(pack, fid) + 4 * rows + 4 * pack.n_functions * (
        1 + len(pack.routing_scalars()))


def routed_timing_phase(packs_ops, smi_line):
    """Phases 16 and 20: for each ``(pack, f32 operations per element beyond
    the member's compares)`` of ``packs_ops``, each routed kernel, its plain
    version, F.silu and the static kernel of the same member at the path's
    shape; then the mixed 512 x 6912 batch against the six static launches
    it replaces."""
    import torch
    import torch.nn.functional as F

    from repro_torch.approx.table_pack import routed_extr_flags

    g = torch.Generator(device="cuda").manual_seed(7)
    gate = (torch.randn((1, BATCH * 6912), generator=g, device="cuda") * 2).to(
        torch.bfloat16)
    gate_t = (torch.randn((1, MICRO * TRAIN_SEQ * 6912), generator=g, device="cuda")
              * 2).to(torch.bfloat16)
    rows = {}
    for pk, ops0 in packs_ops:
        fid = pk.fn_id("silu")
        ids = torch.full((1,), fid, dtype=torch.int32, device="cuda")
        ops = pk.n_intervals[fid] + ops0
        for (kname, kern, plain, static), x, n_out in zip(
                routed_fns(pk), (gate, gate_t), (1, 2)):
            ms = graph_ms(lambda: kern(pk, ids, x, extrapolate=True))
            plain_ms = graph_ms(lambda: plain(pk, ids, x, extrapolate=True))
            static_ms = graph_ms(lambda: static(pk, fid, x, extrapolate=True))
            lib_ms = graph_ms(lambda: F.silu(x))
            b_ms, b_by = bound(x.numel(), x.element_size(), n_out,
                               routed_bytes(pk, fid, 1), ops + 2 * (n_out - 1))
            rows[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by)
            rows[f"{kname} static"] = dict(ms=static_ms)
            log(f"time: {kname} {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
                f"static kernel of the same member {static_ms * 1e3:.2f} us, plain "
                f"{plain_ms * 1e3:.2f} us, yardstick (F.silu"
                f"{'' if n_out == 1 else ', value only'}) {lib_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
        # the mixed batch: one routed launch against one static launch a member
        cyc = [r % pk.n_functions for r in range(ROUTED_ROWS)]
        cyc_ids = torch.tensor(cyc, dtype=torch.int32, device="cuda")  # no copy per call
        xb = routed_input(pk, cyc, ROUTED_COLS, torch.bfloat16, seed=6)
        ex = tuple(n in ("gelu", "silu", "softplus") for n in pk.names)
        flags = routed_extr_flags(pk, ex)
        parts = {f: xb[r].contiguous() for f, r in member_rows(pk, cyc).items()}
        # bound: every member's rows and values, the routing, and the rows'
        # mean compares
        tbytes = (sum(member_bytes(pk, f) for f in parts) + 4 * ROUTED_ROWS
                  + 4 * pk.n_functions * (1 + len(pk.routing_scalars())))
        mean_ops = statistics.mean(pk.n_intervals[f] for f in cyc) + ops0
        for (kname, kern, _, static), n_out in zip(routed_fns(pk), (1, 2)):
            ms = graph_ms(lambda: kern(pk, cyc_ids, xb, extrapolate=ex))
            six = graph_ms(lambda: [static(pk, f, p, extrapolate=bool(flags[f]))
                                    for f, p in parts.items()])
            b_ms, b_by = bound(xb.numel(), xb.element_size(), n_out, tbytes,
                               mean_ops + 2 * (n_out - 1))
            rows[f"{kname} mixed"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            log(f"time: {kname} mixed batch {tuple(xb.shape)} bf16 over "
                f"{pk.n_functions} members: one routed launch {ms * 1e3:.2f} us, "
                f"{len(parts)} static launches on the members' rows "
                f"{six * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------
# 17-20. RangeFold and routed PolyPack: kernels, serving, training, times
# --------------------------------------------------------------------------------------


def fullrange_input(shape, dtype, seed):
    """The full-range samples of tests/harness/fullrange.py (dense tier:
    every decade of both signs, subnormals, near-multiples of pi/2 in both
    reduction regimes, powers of two, +-0), with +-inf and NaN first, tiled
    to ``shape``."""
    import importlib.util

    import numpy as np
    import torch

    # loaded by path: the harness is numpy only, and a "tests" package of
    # another distribution may shadow the repository's directory
    spec = importlib.util.spec_from_file_location(
        "fullrange", REPO / "tests" / "harness" / "fullrange.py")
    fullrange = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fullrange)
    x = np.concatenate([np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0]),
                        fullrange.fullrange_samples(fast=False, seed=seed)])
    x = np.resize(x, int(np.prod(shape))).reshape(shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


def payne_hanek_by_warp(n, seed):
    """n angles, warp by warp (32 lanes): all below 2048 (a warp that skips
    Payne-Hanek); Payne-Hanek lanes (|x| >= 2048) interleaved with small
    ones; all Payne-Hanek; one Payne-Hanek lane among small ones; and so on
    cyclically (a ragged n leaves a partial last warp)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    small = rng.uniform(-2047.0, 2047.0, n)
    big = np.exp(rng.uniform(7.63, 87.0, n)) * rng.choice([-1.0, 1.0], n)
    lane, warp = np.arange(n) % 32, (np.arange(n) // 32) % 4
    take_big = np.select([warp == 0, warp == 1, warp == 2, warp == 3],
                         [False, lane % 2 == 1, True, lane == 17])
    return torch.from_numpy(np.where(take_big, big, small).astype(np.float32)).cuda()


def fold_packs(approx):
    """(tag, pack) of phase 17's folded checks: stablelm-3b's folded pack,
    whose staging images fit a block's 48 KB (one round trip stages what a
    kind reads), and the four cores at e_a 1e-10, whose images do not (the
    launch stages as the budget allows, the rest read from global memory)."""
    from repro_torch.approx.table_pack import build_pack

    big = build_pack(("sin_core", "cos_core", "exp_core", "log_core"), 1e-10,
                     omega=approx.omega, device="cuda")
    packs = (("image", dataclasses.replace(approx, mode="folded_pack").pack("cuda")),
             ("past budget", big))
    for tag, pk in packs:
        for name in FOLDED:
            fits = 4 * pk.fold_images[name][0].numel() <= SMEM_BUDGET
            check(fits == (tag == "image"), f"{tag} pack: {name}'s staging image of "
                  f"{4 * pk.fold_images[name][0].numel()} bytes on the wrong side of "
                  f"the {SMEM_BUDGET}-byte budget")
    return packs


def folded_kernel_phase(packs):
    """Phase 17, first half: the folded value and value + slope kernels
    bitwise against their plain versions over the full f32 range, and sin
    and cos over warps that mix Payne-Hanek lanes with small ones, for each
    ``(tag, pack)`` of ``packs``."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    shapes = list(ROPE_SHAPES) + [(12345,), (71_000,)]
    g = torch.Generator(device="cuda").manual_seed(17)
    big = torch.exp(torch.rand(200_000, generator=g, device="cuda") * 80 + 7.63)
    big = torch.where(torch.rand(200_000, generator=g, device="cuda") < 0.5, -big, big)
    worst = {"folded_pack_lookup": 0.0, "folded_pack_grad": 0.0}
    cases = 0
    for ptag, pack in packs:
        for name in FOLDED:
            for dtype in (torch.bfloat16, torch.float32):
                inputs = [(shape, fullrange_input(shape, dtype, seed=i))
                          for i, shape in enumerate(shapes)]
                inputs.append(((200_000,), big.to(dtype)))
                if name in ("sin", "cos"):
                    inputs += [(shape, payne_hanek_by_warp(
                        int(math.prod(shape)), seed=i).reshape(shape).to(dtype))
                        for i, shape in enumerate(list(ROPE_SHAPES) + [(32 * 37 + 13,)])]
                for i, (shape, x) in enumerate(inputs):
                    got = K.folded_pack_lookup(pack, name, x)
                    got_g = K.folded_pack_grad(pack, name, x)
                    torch.cuda.synchronize()
                    tag = f"[{ptag}] {name} {dtype} {shape} (input {i})"
                    worst["folded_pack_lookup"] = max(
                        worst["folded_pack_lookup"], check_pair(
                            f"folded_pack_lookup {tag}", got,
                            K.folded_pack_lookup_plain(pack, name, x), shape, dtype))
                    worst["folded_pack_grad"] = max(
                        worst["folded_pack_grad"], check_pair(
                            f"folded_pack_grad {tag}", got_g,
                            K.folded_pack_grad_plain(pack, name, x), shape, dtype))
                    cases += 2
        log(f"folded: [{ptag}] members {pack.names}, staging images "
            f"{ {k: 4 * v[0].numel() for k, v in pack.fold_images.items()} } bytes")
    log(f"folded: {cases} folded kernel cases bitwise equal to the plain versions "
        f"(sin, cos, exp, log; bf16+f32; shapes {shapes} of the full-range samples, "
        f"200,000 draws with |x| >= 2048 and, for sin and cos, warps mixing "
        f"Payne-Hanek lanes with small ones; packs {[t for t, _ in packs]})")
    return worst


def past_budget_poly_pack(approx):
    """The mixed poly pack at e_a 1e-8: its staging image is past the 48 KB
    a block of the routed poly kernels stages whole, so they restage per
    member, and past what a block of the static poly kernels stages, so
    they stage the member's lanes and code group (phases 9 and 17 check
    those paths too)."""
    from repro_torch.approx.table_pack import from_poly_layout
    from repro_torch.core import design
    from repro_torch.core.packing import poly_pack_layout

    pk = from_poly_layout(poly_pack_layout(
        [design.poly_member(n, 1e-8, degree=d, bits=b) for n, d, b in MIXED]), "cuda")
    for tag, p in (("stablelm-3b's", approx.poly_pack("cuda")), ("e_a 1e-8", pk)):
        whole = 4 * (p.image.numel() + p.n_functions)
        check((whole <= SMEM_BUDGET) == (p is not pk),
              f"{tag} poly pack: {whole} staging bytes on the wrong side of the "
              f"{SMEM_BUDGET}-byte budget")
        log(f"routed poly: {tag} pack stages {whole} bytes "
            f"({'whole' if whole <= SMEM_BUDGET else 'per member'})")
    return pk


def folded_autograd_check(smi_line):
    """Phase 19, second half: ApproxConfig(mode="folded_pack").unary(name)
    under autograd launches folded_pack_grad; the gradient is bitwise the
    plain slope times dy.  Returns the folded_pack_grad launches."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.models import get_config

    approx = dataclasses.replace(get_config("stablelm-3b").approx, mode="folded_pack")
    pack = approx.pack("cuda")
    fs = {name: approx.unary(name, "cuda") for name in FOLDED}
    g = torch.Generator(device="cuda").manual_seed(19)
    x0 = fullrange_input(ROPE_SHAPES[-1], torch.float32, seed=19)
    x0 = torch.where(torch.isfinite(x0), x0, 1.0)
    dy = torch.randn(x0.shape, generator=g, device="cuda")
    K.reset_launches()
    grads = {}
    for name, f in fs.items():
        x = x0.clone().requires_grad_(True)
        y = f(x)
        y.backward(dy)
        grads[name] = (y.detach(), x.grad)
    torch.cuda.synchronize()
    launches = K.launches["folded_pack_grad"]
    check(launches == len(FOLDED), f"folded_pack_grad launches {launches} != "
          f"{len(FOLDED)} (one a unary under autograd): {dict(K.launches)}")
    for name, (y, gx) in grads.items():
        want_y, want_s = K.folded_pack_grad_plain(pack, name, x0)
        check_pair(f"folded unary {name} value", y, want_y, x0.shape, x0.dtype)
        check_pair(f"folded unary {name} gradient", gx, want_s * dy, x0.shape, x0.dtype)
    log(f"folded: ApproxConfig(mode='folded_pack').unary(name) under autograd for "
        f"{FOLDED} launched folded_pack_grad {launches} times; values and gradients "
        f"bitwise the plain versions' [{smi_line}]")
    return launches


def folded_timing_phase(pack, smi_line):
    """Phase 20, first half: the folded kernels, their plain versions and
    torch.sin / cos / exp / log at the training micro-batch's rotary angles
    (4, 128, 40) f32; the JSON row is sin's (the rotary path's two trig
    kinds are one kernel)."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    g = torch.Generator(device="cuda").manual_seed(20)
    shape = ROPE_SHAPES[-1]
    ang = torch.rand(shape, generator=g, device="cuda") * CACHE_LEN  # |x| < 2048
    rows = {}
    for name in FOLDED:
        x = ang + 0.5 if name == "log" else (ang / 40.0 - 3.0 if name == "exp" else ang)
        cores = [pack.fn_id(c) for c in
                 (("sin_core", "cos_core") if name in ("sin", "cos") else (f"{name}_core",))]
        tbytes = sum(member_bytes(pack, c) for c in cores)
        # f32 operations per element: each core lookup's compares + ~14, the
        # fold (~12 trig Cody-Waite, ~8 exp, ~12 log) and the reconstruction
        # and edges (~6); the grad kernel adds ~4 a core and ~4 for the chain
        ops = sum(pack.n_intervals[c] + 14 for c in cores) + 18
        lib = getattr(torch, name)
        for kname, kern, plain, n_out in (
                ("folded_pack_lookup", K.folded_pack_lookup, K.folded_pack_lookup_plain, 1),
                ("folded_pack_grad", K.folded_pack_grad, K.folded_pack_grad_plain, 2)):
            ms = graph_ms(lambda: kern(pack, name, x))
            plain_ms = graph_ms(lambda: plain(pack, name, x))
            lib_ms = graph_ms(lambda: lib(x))
            b_ms, b_by = bound(x.numel(), 4, n_out, tbytes,
                               ops + (4 * len(cores) + 4) * (n_out - 1))
            if name == "sin":
                rows[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by)
            log(f"time: {kname} {name} {shape} f32: kernel {ms * 1e3:.2f} us, plain "
                f"{plain_ms * 1e3:.2f} us, yardstick (torch.{name}"
                f"{'' if n_out == 1 else ', value only'}) {lib_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    # a decode step's and a prefill's angles, (4, 1, 40) and (4, 27, 40): their
    # times also go into the rows (read by tools/torch_kernel_ab.py)
    for xs in (ang[:, :1].contiguous(), ang[:, :27].contiguous()):
        for kname, kern in (("folded_pack_lookup", K.folded_pack_lookup),
                            ("folded_pack_grad", K.folded_pack_grad)):
            ms = graph_ms(lambda: kern(pack, "sin", xs))
            rows[f"{kname} {tuple(xs.shape)}"] = dict(ms=ms)
            log(f"time: {kname} sin {tuple(xs.shape)} f32: kernel {ms * 1e3:.2f} us, "
                f"torch.sin {graph_ms(lambda: torch.sin(xs)) * 1e3:.2f} us [{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------
# 21-24. ShardedPack: kernels, serving, training, times
# --------------------------------------------------------------------------------------


def sharded_packs(approx):
    """(tag, sharded pack, the replicated pack it cuts) of phase 21:
    stablelm-3b's pack in each of SHARD_COUNTS shards, and ("silu",
    "exp_neg") at e_a 1e-8 in 2 shards, whose slices exceed the kernels'
    static shared budget of 10,240 f32 values."""
    from repro_torch.approx.table_pack import build_pack, build_sharded_pack

    rep = dataclasses.replace(approx, mode="table_pack").pack("cuda")
    out = [(f"S={n}", dataclasses.replace(approx, mode="sharded_pack",
                                          pack_shards=n).sharded_pack("cuda"), rep)
           for n in SHARD_COUNTS]
    names = ("silu", "exp_neg")
    big = build_sharded_pack(names, 1e-8, 2, omega=approx.omega, device="cuda")
    check(big.footprint_per_shard > 10240, f"the e_a 1e-8 slice holds "
          f"{big.footprint_per_shard} values, not past the shared budget")
    out.append(("silu+exp_neg e_a 1e-8 S=2", big,
                build_pack(names, 1e-8, omega=approx.omega, device="cuda")))
    return out


def equal_values(tag, got, want, x):
    """A shard sum against the replicated kernel: equal as values, NaN
    positions matched, where x is not NaN (see phase 21)."""
    import torch

    keep = ~torch.isnan(x)
    g, w = got[keep].float(), want[keep].float()
    bad = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
    check(not bool(bad.any()), f"{tag}: {int(bad.sum())} values differ from the "
          f"replicated kernel")


def shard_launches_summed(contrib, n_shards):
    """``contrib(s)`` (one single-shard launch) for each shard, added in shard
    order in x's dtype: the S-launch path a one-launch sharded call
    replaces."""
    out = None
    for s in range(n_shards):
        c = contrib(s)
        out = c if out is None else out + c
    return out


def sharded_kernel_phase(packs, s0):
    """Phase 21, static half: every member of each sharded pack, f32 and
    bf16, extrapolation off and on, at the gate shapes (the training gate at
    2 and 4 shards), a ragged size and the edge inputs."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    worst = {"sharded_pack_lookup": 0.0, "sharded_pack_grad": 0.0}
    cases = 0
    for tag, sp, rp in packs:
        shapes = [(BATCH, 1, 6912), (BATCH, s0, 6912), (12345,), (1,)]
        if sp.n_shards in (2, 4):
            shapes.insert(0, (MICRO, TRAIN_SEQ, 6912))
        for fid, name in enumerate(sp.names):
            lo, hi = sp.domains[fid]
            edges = edge_values(sp, fid)
            for dtype in (torch.bfloat16, torch.float32):
                for shape in shapes:
                    x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                    for ex in (False, True):
                        t = f"[{tag}] {name} {dtype} {shape} extrapolate={ex}"
                        y = K.sharded_pack_lookup(sp, fid, x, extrapolate=ex)
                        d = K.sharded_pack_slope(sp, fid, x, extrapolate=ex)
                        g = K.sharded_pack_grad(sp, fid, x, extrapolate=ex)
                        cs = [K.sharded_shard_contrib(sp, fid, k, x, extrapolate=ex)
                              for k in range(sp.n_shards)]
                        sy = shard_launches_summed(lambda k: cs[k], sp.n_shards)
                        sd = shard_launches_summed(
                            lambda k: K.sharded_shard_contrib(
                                sp, fid, k, x, extrapolate=ex, slope=True), sp.n_shards)
                        torch.cuda.synchronize()
                        want = K.sharded_pack_grad_plain(sp, fid, x, extrapolate=ex)
                        worst["sharded_pack_lookup"] = max(
                            worst["sharded_pack_lookup"],
                            check_pair(f"sharded_pack_lookup {t}", y, want[0], shape, dtype),
                            check_pair(f"sharded_pack_slope {t}", d, want[1], shape, dtype))
                        worst["sharded_pack_grad"] = max(
                            worst["sharded_pack_grad"],
                            check_pair(f"sharded_pack_grad {t}", g, want, shape, dtype))
                        for k, c in enumerate(cs):
                            check_pair(f"shard {k} contribution {t}", c,
                                       K.sharded_shard_contrib_plain(
                                           sp, fid, k, x, extrapolate=ex), shape, dtype)
                        check_pair(f"sharded_pack_lookup vs {sp.n_shards} launches "
                                   f"added {t}", y, sy, shape, dtype)
                        check_pair(f"sharded_pack_slope vs {sp.n_shards} launches "
                                   f"added {t}", d, sd, shape, dtype)
                        check_pair(f"sharded_pack_grad vs {sp.n_shards} value and "
                                   f"slope launches added {t}", g, (sy, sd), shape, dtype)
                        ry, rd = K.table_pack_grad(rp, fid, x, extrapolate=ex)
                        equal_values(f"sharded sum {t}", y, ry, x)
                        equal_values(f"sharded slope sum {t}", d, rd, x)
                        cases += 1
        log(f"sharded: [{tag}] members {sp.names}, {sp.n_shards} shards of "
            f"{sp.footprint_per_shard} values, shapes {shapes}")
    log(f"sharded: {cases} cases, each the value, slope and value + slope kernels "
        f"and every shard's contribution bitwise equal to the plain versions, the "
        f"one-launch value, slope and value + slope bitwise equal to the "
        f"single-shard launches added in shard order, the shard sums equal to the "
        f"replicated kernels (bf16+f32, extrapolate on/off, edges)")
    return worst


def sharded_routed_kernel_phase(packs, s0):
    """Phase 21, routed half: phase 13's checks over each sharded pack (the
    unary shapes at 2 and 4 shards), then each routed sharded call against
    the replicated routed kernel as values."""
    import torch

    from repro_torch.kernels import routed_pack_lookup as R

    worst = {"sharded_routed_pack_lookup": 0.0, "sharded_routed_pack_grad": 0.0}
    by_shards = {sp.n_shards: sp for _, sp, _ in packs[:len(SHARD_COUNTS)]}
    for tag, sp, _ in packs:
        unary = ([(1, BATCH * 6912), (1, BATCH * s0 * 6912)] if sp.n_shards in (2, 4)
                 and "e_a" not in tag else [(1, 12345)])
        w = routed_kernel_phase(((f"sharded {tag}", sp),), s0, unary=unary,
                                reroute=False)
        for k in worst:
            worst[k] = max(worst[k], w[k])
    # the sum of the shards against the replicated routed kernels
    for tag, sp, rp in packs:
        F = sp.n_functions
        cyc = [r % F for r in range(ROUTED_ROWS)]
        x = routed_input(sp, cyc, ROUTED_COLS, torch.bfloat16, seed=8)
        for ex in (False, True, tuple(f % 2 == 0 for f in range(F))):
            y = R.sharded_routed_pack_lookup(sp, cyc, x, extrapolate=ex)
            g = R.sharded_routed_pack_grad(sp, cyc, x, extrapolate=ex)
            ry, rd = R.routed_pack_grad(rp, cyc, x, extrapolate=ex)
            equal_values(f"sharded routed sum [{tag}] extrapolate={ex}", y, ry, x)
            equal_values(f"sharded routed grad sum [{tag}]", g[0], ry, x)
            equal_values(f"sharded routed slope sum [{tag}]", g[1], rd, x)
    log(f"sharded: the routed sharded sums equal the replicated routed kernels "
        f"({ROUTED_ROWS} x {ROUTED_COLS} bf16, extrapolate off/on/per member)")
    reroute_check(by_shards[PACK_SHARDS], by_shards[8])
    return worst


def sharded_serving_path(smi_line, gate_calls):
    """Phase 22: serving in sharded_pack at PACK_SHARDS shards, its decode
    step beside table_pack's, and routed_activation over the mixed batch.
    ``gate_calls`` is phase 4's table_pack_lookup count (one a gate call)."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.models import build_model, get_config
    from repro_torch.models.common import routed_activation

    counts = pack_serving_paths(smi_line, (("sharded_pack", ("sharded_pack_lookup",)),))
    check(counts["sharded_pack_lookup"] == gate_calls,
          f"sharded_pack_lookup launches {counts['sharded_pack_lookup']} != the "
          f"{gate_calls} gate calls of table_pack (one launch a call)")
    log(f"sharded_pack: 1 launch over {PACK_SHARDS} shards for each of the "
        f"{gate_calls} gate calls ({counts['sharded_pack_lookup']})")
    base = get_config("stablelm-3b")
    params = build_model(base, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    models = {m: build_model(_with_mode(base, m, attn_table=True, **_shard_kw(m)), "cuda")
              for m in ("table_pack",) + SHARDED}
    rows = torch.randint(0, base.vocab, (BATCH, 27), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    pos = torch.full((BATCH,), rows.shape[1], dtype=torch.int32, device="cuda")
    dec_ms = {m: [] for m in models}
    with torch.inference_mode():
        _, cache = models["table_pack"].prefill(
            params, {"tokens": rows}, models["table_pack"].init_cache(BATCH, CACHE_LEN))
        for rnd in range(4):
            order = list(models.items()) if rnd % 2 == 0 else list(models.items())[::-1]
            for mode, m in order:
                _mean_ms(lambda: m.decode_step(params, rows[:, -1:], pos, cache), 2)
                dec = _mean_ms(lambda: m.decode_step(params, rows[:, -1:], pos, cache), 10)
                dec_ms[mode].append(dec)
                log(f"step: round {rnd} {mode}: decode {dec:.3f} ms (B={BATCH}, cache "
                    f"{CACHE_LEN}, pack_shards {PACK_SHARDS}) [{smi_line}]")
        decode_host_costs(models, params, rows[:, -1:], pos, cache, dec_ms, smi_line)
    del params, models
    torch.cuda.empty_cache()

    # routed_activation over the MoE-style batch: the routed sharded kernels
    approx = dataclasses.replace(base.approx, pack_shards=PACK_SHARDS)
    names = ("silu", "gelu", "tanh", "sigmoid", "softplus", "exp")
    kern = routed_activation(dataclasses.replace(approx, mode="sharded_pack"),
                             names * (ROUTED_ROWS // len(names)) + names[:ROUTED_ROWS % 6],
                             "cuda")
    plain = routed_activation(dataclasses.replace(approx, mode="sharded_pack_ref"),
                              names * (ROUTED_ROWS // len(names)) + names[:ROUTED_ROWS % 6],
                              "cuda")
    g = torch.Generator(device="cuda").manual_seed(22)
    x0 = (torch.randn((ROUTED_ROWS, ROUTED_COLS), generator=g, device="cuda") * 4)
    dy = torch.randn(x0.shape, generator=g, device="cuda")
    out = {}
    K.reset_launches()
    for tag, f in (("kernel", kern), ("plain", plain)):
        x = x0.clone().requires_grad_(True)
        y = f(x)
        y.backward(dy)
        with torch.no_grad():
            out[tag] = (y.detach(), x.grad, f(x0))
        if tag == "kernel":
            torch.cuda.synchronize()
            routed = {k: K.launches[k] for k in ("sharded_routed_pack_lookup",
                                                 "sharded_routed_pack_grad")}
    check(routed == {"sharded_routed_pack_lookup": 1, "sharded_routed_pack_grad": 1},
          f"routed_activation(sharded_pack) launches {routed}")
    for a, b, what in zip(out["kernel"], out["plain"], ("value under autograd",
                                                        "gradient", "value")):
        check_pair(f"routed_activation(sharded_pack) {what}", a, b, x0.shape, x0.dtype)
    log(f"sharded_pack: routed_activation over ({ROUTED_ROWS}, {ROUTED_COLS}) f32, "
        f"value and gradient bitwise the plain mode's; launches {routed} "
        f"[{smi_line}]")
    counts.update(routed)
    return counts


def _host_cost(fn, reps):
    """Host us a call of ``fn`` takes to enqueue its work (no sync inside the
    loop: where the card keeps up this is the host's time a call), and the
    host operator events of one call under torch.profiler (CPU only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return host_us, len(prof.events())


def decode_host_costs(models, params, tok, pos, cache, dec_ms, smi_line):
    """Where sharded_pack's decode step differs from table_pack's: the
    rounds' spread of each mode's step, the host time and operator events of
    one step, and of one gate call (silu at the decode gate, through the
    mode's own closure) times the gate calls a step."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    K.reset_launches()
    models["table_pack"].decode_step(params, tok, pos, cache)
    torch.cuda.synchronize()
    calls = K.launches["table_pack_lookup"]  # one a gate call
    gate = (torch.randn((BATCH, 1, 6912), device="cuda") * 2).to(torch.bfloat16)
    cost = {}
    for mode in ("table_pack", "sharded_pack"):
        m = models[mode]
        act = m.act  # the model's own gate closure (silu)
        step_us, step_ops = _host_cost(lambda: m.decode_step(params, tok, pos, cache), 5)
        gate_us, gate_ops = _host_cost(lambda: act(gate), 200)
        cost[mode] = (step_us, step_ops, gate_us, gate_ops)
        d = dec_ms[mode]
        log(f"host: {mode} decode step {statistics.mean(d):.3f} ms over {len(d)} rounds "
            f"(min {min(d):.3f}, max {max(d):.3f}); one step: {step_us / 1e3:.3f} ms "
            f"host, {step_ops} host op events; one gate call: {gate_us:.2f} us host, "
            f"{gate_ops} op events [{smi_line}]")
    t, sh = cost["table_pack"], cost["sharded_pack"]
    log(f"host: sharded_pack - table_pack: decode step "
        f"{statistics.mean(dec_ms['sharded_pack']) - statistics.mean(dec_ms['table_pack']):+.3f}"
        f" ms (round means), one step's host {(sh[0] - t[0]) / 1e3:+.3f} ms and "
        f"{sh[1] - t[1]:+d} op events; {calls} gate calls x {sh[2] - t[2]:+.2f} us = "
        f"{calls * (sh[2] - t[2]) / 1e3:+.3f} ms, {calls * (sh[3] - t[3]):+d} op events")


def sharded_bytes(sp, fid, routed_rows=0):
    """Bytes one sharded call of member ``fid`` needs of its pack, each read
    once: the member's replicated rows (n + 1 boundaries, invd, segs), its
    owner and owner-rebased-base rows, and its values (from its first entry
    to the end of its last cell, across the slices); routed, the ids and the
    per-member interval counts and extrapolate flags too."""
    n = sp.n_intervals[fid]
    entries = int((sp.seg_count[fid, :n] + 1).sum().item())
    return (4 * (5 * n + 1) + 4 * entries
            + (4 * routed_rows + 4 * 2 * sp.n_functions if routed_rows else 0))


def sharded_timing_phase(approx, smi_line):
    """Phase 24: each sharded call at PACK_SHARDS shards, a launch over the
    1-shard pack, the replicated static and routed kernels of the same
    member, the plain version and F.silu, at the decode gate (4, 1, 6912)
    and the training gate (4, 128, 6912) bf16 (the routed calls view them as
    one row); beside each call the PACK_SHARDS single-shard launches added
    in shard order that it replaces (a value call's value launches, a grad
    call's value and slope launches of the static kernel, where the
    checkout has them); then the 512 x 6912 mixed batch as one routed
    sharded call against the six static sharded calls and the replicated
    routed kernel.  The rows ``*@train`` are the value calls at the
    training gate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.approx.table_pack import routed_extr_flags
    from repro_torch.kernels import routed_pack_lookup as R
    from repro_torch.kernels import table_pack_lookup as K

    rp = dataclasses.replace(approx, mode="table_pack").pack("cuda")
    sp = dataclasses.replace(approx, mode="sharded_pack",
                             pack_shards=PACK_SHARDS).sharded_pack("cuda")
    one = dataclasses.replace(approx, mode="sharded_pack", pack_shards=1).sharded_pack("cuda")
    fid = sp.fn_id("silu")
    ids = torch.full((1,), fid, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    gate = (torch.randn((BATCH, 1, 6912), generator=g, device="cuda") * 2).to(torch.bfloat16)
    gate_t = (torch.randn((MICRO, TRAIN_SEQ, 6912), generator=g, device="cuda")
              * 2).to(torch.bfloat16)
    row, row_t = gate.reshape(1, -1), gate_t.reshape(1, -1)
    # f32 operations per element: the member's compares + ~15 (address, lerp,
    # the owner test and select); +2 for the slope
    ops = sp.n_intervals[fid] + 15
    rows = {}
    S = sp.n_shards
    routed_contrib = getattr(R, "sharded_routed_shard_contrib", None)

    def static_value(name, x):
        return (name, x, 1,
                lambda: K.sharded_pack_lookup(sp, fid, x, extrapolate=True),
                lambda: K.sharded_pack_lookup(one, fid, x, extrapolate=True),
                lambda: K.sharded_pack_lookup_plain(sp, fid, x, extrapolate=True),
                (("table_pack_lookup", lambda: K.table_pack_lookup(rp, fid, x,
                                                                   extrapolate=True)),),
                lambda: shard_launches_summed(lambda s: K.sharded_shard_contrib(
                    sp, fid, s, x, extrapolate=True), S))

    def grad_summed(x):
        """The grad's S-launch path from the single-shard contributions:
        value and slope, each S launches + S - 1 adds."""
        return lambda: tuple(shard_launches_summed(lambda s: K.sharded_shard_contrib(
            sp, fid, s, x, extrapolate=True, slope=slope), S) for slope in (False, True))

    def routed_value(name, x):
        return (name, x, 1,
                lambda: R.sharded_routed_pack_lookup(sp, ids, x, extrapolate=True),
                lambda: R.sharded_routed_pack_lookup(one, ids, x, extrapolate=True),
                lambda: R.sharded_routed_pack_lookup_plain(sp, ids, x, extrapolate=True),
                (("routed_pack_lookup", lambda: R.routed_pack_lookup(rp, ids, x,
                                                                     extrapolate=True)),
                 ("sharded_pack_lookup", lambda: K.sharded_pack_lookup(sp, fid, x,
                                                                       extrapolate=True))),
                routed_contrib and (lambda: shard_launches_summed(
                    lambda s: routed_contrib(sp, ids, s, x, extrapolate=True), S)))

    for name, x, n_out, kern, single, plain, others, summed in (
        static_value("sharded_pack_lookup", gate),
        static_value("sharded_pack_lookup@train", gate_t),
        ("sharded_pack_grad", gate_t, 2,
         lambda: K.sharded_pack_grad(sp, fid, gate_t, extrapolate=True),
         lambda: K.sharded_pack_grad(one, fid, gate_t, extrapolate=True),
         lambda: K.sharded_pack_grad_plain(sp, fid, gate_t, extrapolate=True),
         (("table_pack_grad", lambda: K.table_pack_grad(rp, fid, gate_t,
                                                        extrapolate=True)),
          ("routed_pack_grad", lambda: R.routed_pack_grad(rp, ids, row_t,
                                                          extrapolate=True))),
         grad_summed(gate_t)),
        routed_value("sharded_routed_pack_lookup", row),
        routed_value("sharded_routed_pack_lookup@train", row_t),
        ("sharded_routed_pack_grad", row_t, 2,
         lambda: R.sharded_routed_pack_grad(sp, ids, row_t, extrapolate=True),
         lambda: R.sharded_routed_pack_grad(one, ids, row_t, extrapolate=True),
         lambda: R.sharded_routed_pack_grad_plain(sp, ids, row_t, extrapolate=True),
         (("routed_pack_grad", lambda: R.routed_pack_grad(rp, ids, row_t,
                                                          extrapolate=True)),
          ("table_pack_grad", lambda: K.table_pack_grad(rp, fid, gate_t,
                                                        extrapolate=True))),
         grad_summed(row_t)),
    ):
        ms, single_ms = graph_ms(kern), graph_ms(single)
        plain_ms, lib_ms = graph_ms(plain), graph_ms(lambda: F.silu(x))
        other = {k: graph_ms(f) for k, f in others}
        routed = 1 if name.startswith("sharded_routed") else 0
        b_ms, b_by = bound(x.numel(), x.element_size(), n_out,
                           sharded_bytes(sp, fid, routed), ops + 2 * (n_out - 1))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        how = f"{S} shards in one launch"
        if summed:
            key = f"{name} ({S} launches + {S - 1} adds{'' if n_out == 1 else ' x 2'})"
            rows[key] = dict(ms=graph_ms(summed))
            how += (f" (the {S} single-shard {'launches' if n_out == 1 else 'value and '}"
                    f"{'' if n_out == 1 else f'{S} slope launches'} + "
                    f"{(S - 1) * n_out} adds: {rows[key]['ms'] * 1e3:.2f} us)")
        beside = ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in other.items())
        log(f"time: {name} {tuple(x.shape)} {x.dtype}: {how} {ms * 1e3:.2f} us, one "
            f"launch (1 shard) {single_ms * 1e3:.2f} us, replicated: {beside}, plain "
            f"{plain_ms * 1e3:.2f} us, yardstick (F.silu"
            f"{'' if n_out == 1 else ', value only'}) {lib_ms * 1e3:.2f} us, bound "
            f"{b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    cyc = [r % sp.n_functions for r in range(ROUTED_ROWS)]
    cyc_ids = torch.tensor(cyc, dtype=torch.int32, device="cuda")
    xb = routed_input(sp, cyc, ROUTED_COLS, torch.bfloat16, seed=6)
    ex = tuple(n in ("gelu", "silu", "softplus") for n in sp.names)
    flags = routed_extr_flags(sp, ex)
    parts = {f: xb[r].contiguous() for f, r in member_rows(sp, cyc).items()}
    for (kname, kern, _, static), (_, replicated, _, _) in zip(routed_fns(sp),
                                                               routed_fns(rp)):
        ms = graph_ms(lambda: kern(sp, cyc_ids, xb, extrapolate=ex))
        six = graph_ms(lambda: [static(sp, f, q, extrapolate=bool(flags[f]))
                                for f, q in parts.items()])
        rep_ms = graph_ms(lambda: replicated(rp, cyc_ids, xb, extrapolate=ex))
        rows[f"{kname} mixed"] = dict(ms=ms)
        log(f"time: {kname} mixed batch {tuple(xb.shape)} bf16 over "
            f"{sp.n_functions} members, {S} shards: one routed call {ms * 1e3:.2f} us, "
            f"{len(parts)} static sharded calls on the members' rows "
            f"{six * 1e3:.2f} us, the replicated routed kernel {rep_ms * 1e3:.2f} us "
            f"[{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------
# 25-28. the rest of the dense family: starcoder2-3b, gemma3-12b, yi-34b
# --------------------------------------------------------------------------------------


def prompt_rows(reqs, batch):
    """The first ``batch`` prompts of ``reqs`` left-padded to the longest, on
    the card, as the engine's prefill sees them."""
    import torch

    s0 = max(len(r.prompt) for r in reqs)
    rows = torch.zeros((batch, s0), dtype=torch.int64, device="cuda")
    for j, r in enumerate(reqs[:batch]):
        rows[j, s0 - len(r.prompt):] = torch.as_tensor(r.prompt, device="cuda")
    return rows


def serve_against_plain(tag, model, ref, params, reqs, batch, cache_len, smi_line,
                        kernels=("table_pack_lookup", "tableflash_exp")):
    """Serve ``reqs`` through ContinuousEngine in ``model``'s mode and in
    ``ref``'s (its ``_ref`` mode: the plain versions) on the same ``params``:
    each of ``kernels`` must launch, the plain versions none, every request
    get its budget and the tokens be identical.  Returns the kernel run's
    results and launches."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.serving.engine import ContinuousEngine

    engine = ContinuousEngine(model, params, batch, cache_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = engine.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in kernels:
        check(counts[k] > 0, f"{tag}: kernel {k} was not launched serving: {counts}")
    check(all(o.steps == r.max_new_tokens for o, r in zip(out, reqs)),
          f"{tag}: every request gets its budget")
    ref_mode = ref.cfg.approx.mode
    K.reset_launches()
    t1 = time.perf_counter()
    ref_out = ContinuousEngine(ref, params, batch, cache_len).serve(reqs)
    torch.cuda.synchronize()
    ref_dt = time.perf_counter() - t1
    check(all(v == 0 for v in K.launches.values()), f"{tag}: {ref_mode} launched "
          "a kernel")
    for i, (a, b) in enumerate(zip(out, ref_out)):
        check((a.tokens == b.tokens).all(), f"{tag} request {i}: kernel tokens "
              f"{a.tokens.tolist()} != plain {b.tokens.tolist()}")
    tokens = sum(r.steps for r in out)
    lens = [len(r.prompt) for r in reqs]
    log(f"{tag}: served {len(out)} requests (prompts {min(lens)}..{max(lens)} "
        f"tokens, batch {batch}, cache {cache_len}), {tokens} tokens in {dt:.3f}s = "
        f"{tokens / dt:.1f} tok/s ({ref_mode} {tokens / ref_dt:.1f} tok/s), "
        f"{engine.prefills} prefills, {engine.batch_steps} rounds, token-identical "
        f"to {ref_mode}; peak memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{smi_line}]")
    return out, counts


def extra_inputs(model, batch, seed):
    """The prefill's frames (B, enc_len, d) or patches (B, n_vis, d_vis) of
    ``model``'s family, standard normal f32 from numpy ``seed``."""
    import numpy as np

    cfg = model.cfg
    shape = {"frames": (batch, cfg.enc_len, cfg.d_model),
             "patches": (batch, cfg.n_vis_tokens, cfg.d_vis)}
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape[k]).astype(np.float32)
            for k in model.extra_inputs}


def static_serve_against_plain(tag, model, ref, params, reqs, batch, cache_len,
                               smi_line):
    """Serve ``reqs`` in groups of ``batch`` (``pad_and_batch``) through
    ``DecodeEngine.generate_batch`` with each group's ``extra_inputs`` (seed
    EXTRA_SEED + the group's index), in ``model``'s mode and in ``ref``'s
    (the plain versions) on the same ``params``: both kernels must launch,
    the plain versions none, every request get its budget and the tokens be
    identical.  Returns the kernel run's results and launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.serving.engine import DecodeEngine, Result, _trim_at_eos, pad_and_batch

    groups = pad_and_batch(reqs, batch)

    def run(m):
        engine = DecodeEngine(m, params, batch, cache_len)
        out = []
        for g, (group, toks) in enumerate(groups):
            budgets = np.asarray([r.max_new_tokens for r in group], np.int64)
            gen, _ = engine.generate_batch(toks, budgets, extra_inputs=extra_inputs(
                m, batch, EXTRA_SEED + g))
            for i, r in enumerate(group):
                kept = _trim_at_eos(gen[i], r.max_new_tokens, r.eos_id)
                out.append(Result(tokens=kept, prompt_len=len(r.prompt), steps=len(kept)))
        torch.cuda.synchronize()
        return out[: len(reqs)], engine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out, engine = run(model)
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in ("table_pack_lookup", "tableflash_exp"):
        check(counts[k] > 0, f"{tag}: kernel {k} was not launched serving: {counts}")
    check(all(o.steps == r.max_new_tokens for o, r in zip(out, reqs)),
          f"{tag}: every request gets its budget")
    K.reset_launches()
    t1 = time.perf_counter()
    ref_out, _ = run(ref)
    ref_dt = time.perf_counter() - t1
    check(all(v == 0 for v in K.launches.values()), f"{tag}: {ref.cfg.approx.mode} "
          "launched a kernel")
    for i, (a, b) in enumerate(zip(out, ref_out)):
        check((a.tokens == b.tokens).all(), f"{tag} request {i}: kernel tokens "
              f"{a.tokens.tolist()} != plain {b.tokens.tolist()}")
    tokens = sum(r.steps for r in out)
    lens = [len(r.prompt) for r in reqs]
    log(f"{tag}: served {len(out)} requests (prompts {min(lens)}..{max(lens)} tokens, "
        f"{len(groups)} groups of {batch} through generate_batch with "
        f"{list(model.extra_inputs)}, cache {cache_len}), {tokens} tokens in "
        f"{dt:.3f}s = {tokens / dt:.1f} tok/s ({ref.cfg.approx.mode} "
        f"{tokens / ref_dt:.1f} tok/s), {engine.batch_steps} rounds, token-identical "
        f"to {ref.cfg.approx.mode}; peak memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{smi_line}]")
    return out, counts


def gate_calls(cfg):
    """The gate (``act``) calls of one layer's forward: the GLU's or MLP's
    one; an MoE layer's routed experts' one over its (E, C, d_ff) buffer and
    its shared experts' one, where it has them."""
    return 1 + int(cfg.family == "moe" and cfg.moe.n_shared > 0)


def logits_and_launches(tag, model, ref, params, rows, cache_len, extra=None):
    """One prefill of ``rows`` (with ``extra``, the prefill's frames or
    patches) and one decode step in ``model``'s table_pack and in ``ref``'s
    table_pack_ref on the same parameters: the logits of both equal (the
    kernels are bitwise their plain versions, the rest is the same code),
    finite and (B, vocab_pad); the table_pack decode step launches the gate
    once for each gate call of a layer (``gate_calls``) and the two
    running-softmax exponents once a layer and kv chunk; for whisper and
    internvl the prefill's launches also as ``prefill_launches`` derives
    them.  Returns the table_pack cache."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    B, s0 = rows.shape
    batch = {"tokens": rows, **(extra or {})}
    with torch.inference_mode():
        torch.cuda.synchronize()
        K.reset_launches()
        lk, ck = model.prefill(params, batch, model.init_cache(B, cache_len))
        torch.cuda.synchronize()
        cp = dict(K.launches)
        lr, cr = ref.prefill(params, batch, ref.init_cache(B, cache_len))
        tok = torch.argmax(lk, -1)[:, None]
        pos = torch.full((B,), s0, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        K.reset_launches()
        dk, _ = model.decode_step(params, tok, pos, ck)
        torch.cuda.synchronize()
        c = dict(K.launches)
        dr, _ = ref.decode_step(params, tok, pos, cr)
    cfg = model.cfg
    for what, a in (("prefill", lk), ("decode", dk)):
        check(a.shape == (B, cfg.vocab_pad) and bool(torch.isfinite(a[:, :cfg.vocab]).all()),
              f"{tag}: {what} logits finite, (B, vocab_pad)")
    diff = max(float((lk - lr).abs().max()), float((dk - dr).abs().max()))
    check(diff <= 1e-6, f"{tag}: table_pack logits differ from table_pack_ref's by "
          f"{diff} > 1e-6")
    (gates, why), flash = decode_launches(model, params, ck)
    check(c["table_pack_lookup"] == gates,
          f"{tag}: {c['table_pack_lookup']} gate launches a decode step, not {why}")
    check(c["tableflash_exp"] == flash, f"{tag}: {c['tableflash_exp']} exponent "
          f"launches a decode step, not 2 a layer (or shared-block use) and kv "
          f"chunk ({flash})")
    pre = prefill_launches(model, s0)
    if pre is not None:
        got = (cp["table_pack_lookup"], cp["tableflash_exp"])
        check(got == pre[:2], f"{tag}: the prefill launches the gates and exponent "
              f"{got}, not {pre[:2]} ({pre[2]})")
        log(f"{tag}: one prefill (B={B}, S0={s0}) launches the gates "
            f"{got[0]}x and the exponent {got[1]}x, as derived ({pre[2]})")
    widths = {n: ck[n].shape[1] for n in ck if n.endswith("pos")}
    log(f"{tag}: prefill (B={B}, S0={s0}) and decode logits equal table_pack_ref's "
        f"(max |diff| {diff}); one decode step (cache {cache_len}, position buffers "
        f"{widths}) launches the gates {c['table_pack_lookup']}x ({why}) and the "
        f"exponent {c['tableflash_exp']}x (2 a layer and kv chunk)")
    return ck


def decode_launches(model, params, cache):
    """One table_pack decode step's expected launches, from the code:
    ``((table_pack_lookup, how it is counted), tableflash_exp)``.  A decoder
    layer calls its gate ``gate_calls`` times and attends over its position
    buffer's width in kv chunks (2 exponents a chunk); zamba2's Mamba2 layer
    makes MAMBA_GATES calls and each use of the shared block 1 (its GLU) and
    2 exponents a kv chunk; an xLSTM pair at S = 1 makes one mLSTM chunk's
    gates and one sLSTM step's, and no exponent."""
    cfg = model.cfg
    if cfg.family == "encdec":  # self-attention over the cache, cross over the frames
        chunks = -(-cache["pos"].shape[1] // KV_CHUNK) + -(-cfg.enc_len // KV_CHUNK)
        return (cfg.n_layers, f"1 a decoder layer x {cfg.n_layers}"), \
            2 * cfg.n_layers * chunks
    if cfg.family == "vlm":
        model = model.backbone
    if cfg.family == "hybrid":
        chunks = -(-cache["attn_pos"].shape[1] // KV_CHUNK)
        gates = MAMBA_GATES * cfg.n_layers + model.n_groups
        return ((gates, f"{MAMBA_GATES} a Mamba2 layer x {cfg.n_layers} + 1 a shared-"
                 f"block use x {model.n_groups} = {gates}"),
                2 * model.n_groups * chunks)
    if cfg.family == "xlstm":
        per = MLSTM_CHUNK_GATES + MLSTM_GATES + SLSTM_STEP_GATES
        return (per * model.n_pairs, f"{per} a pair x {model.n_pairs}"), 0
    # each layer attends over its own position buffer's width in kv chunks
    chunks = sum(-(-cache[pre + "pos"].shape[1] // KV_CHUNK)
                 for _, _, pre, _ in model._stack(params))
    per = gate_calls(cfg)
    return (per * cfg.n_layers, f"{per} a layer x {cfg.n_layers}"), 2 * chunks


def attn_chunks(S, T):
    """flash_attention's (query chunk, kv chunk) pairs for S queries over T
    keys: each runs the two running-softmax exponents once."""
    return -(-S // Q_CHUNK) * -(-T // KV_CHUNK)


def prefill_launches(model, S):
    """whisper's and internvl's prefill launches of S prompt tokens, from
    the code: ``(table_pack_lookup, tableflash_exp, how)`` (None for the
    other families).  whisper: each encoder and decoder layer's MLP gate;
    2 exponents a chunk pair of the encoder over its enc_len frames, of the
    decoder's self-attention over the prompt and of its cross-attention over
    the frames.  internvl: each layer's gate, 2 exponents a chunk pair over
    the n_vis + S prefix and tokens."""
    cfg = model.cfg
    if cfg.family == "encdec":
        E, L = cfg.enc_len, cfg.n_layers
        enc, dec = cfg.n_enc_layers * attn_chunks(E, E), L * (attn_chunks(S, S)
                                                             + attn_chunks(S, E))
        return (cfg.n_enc_layers + L, 2 * (enc + dec),
                f"{cfg.n_enc_layers} encoder + {L} decoder gates; exponents 2 x "
                f"({enc} encoder + {dec} decoder chunk pairs)")
    if cfg.family == "vlm":
        n = attn_chunks(cfg.n_vis_tokens + S, cfg.n_vis_tokens + S) * cfg.n_layers
        return cfg.n_layers, 2 * n, f"{cfg.n_layers} gates; exponents 2 x {n} chunk pairs"
    return None


def grad_launches(model, per_layer):
    """table_pack_grad's launches a training micro-batch, from the code:
    every gate call of the forward launches once and once more in remat's
    recompute.  ``per_layer`` is phase 6's count a stablelm layer: its silu
    gate's 2 and the flash exponents' slopes (per_layer - 2, one kv chunk at
    TRAIN_SEQ), which zamba2's shared block has too; each further gate call
    of a decoder layer (an MoE layer's shared experts) adds 2."""
    cfg = model.cfg
    slopes = per_layer - 2  # the exponents' slopes of one chunk pair, recompute too
    if cfg.family == "encdec":  # whisper's encoder over its frames, the decoder
        E, S = cfg.enc_len, TRAIN_SEQ
        return (cfg.n_enc_layers * (2 + slopes * attn_chunks(E, E))
                + cfg.n_layers * (2 + slopes * (attn_chunks(S, S) + attn_chunks(S, E))))
    if cfg.family == "vlm":  # the prefix and the tokens in one sequence
        S = cfg.n_vis_tokens + TRAIN_SEQ
        return cfg.n_layers * (2 + slopes * attn_chunks(S, S))
    if cfg.family == "hybrid":
        return 2 * MAMBA_GATES * cfg.n_layers + per_layer * model.n_groups
    if cfg.family == "xlstm":
        chunks = -(-TRAIN_SEQ // 128)  # mlstm_block's chunk
        return 2 * model.n_pairs * (MLSTM_CHUNK_GATES * chunks + MLSTM_GATES
                                    + SLSTM_STEP_GATES * TRAIN_SEQ)
    return (per_layer + 2 * (gate_calls(cfg) - 1)) * cfg.n_layers


def long_requests(vocab):
    """gemma3-12b's long queue: LONG_REQ prompts of LONG_LEN tokens, from
    seed 1."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    lens = rng.integers(LONG_LEN[0], LONG_LEN[1] + 1, LONG_REQ)
    return [Request(prompt=rng.integers(0, vocab, (int(n),)).astype(np.int32),
                    max_new_tokens=MAX_NEW) for n in lens]


def flash_exp_shapes(cfg, B, S, T):
    """The shapes of flash_attention's two exponents for B rows of S queries
    over T keys in ``cfg``'s head layout: the scores (B, Sq, G, Qg, Tc) and
    the running max's step (B, Sq, G, Qg), Sq and Tc its chunks."""
    g = cfg.attn_geom
    q = (B, min(Q_CHUNK, S), g.g_eff, g.q_per_group)
    return [q + (min(KV_CHUNK, T),), q]


def gate_shapes(cfg, B, S):
    """The shapes ``act`` sees in one forward of B x S tokens: the GLU's or
    MLP's (B, S, d_ff); an MoE layer's (E, C, d_ff) expert buffer and its
    shared experts' (B*S, n_shared * d_ff)."""
    from repro_torch.models.mlp import moe_capacity

    if cfg.family != "moe":
        return [(B, S, cfg.d_ff)]
    m, T = cfg.moe, B * S
    C = moe_capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    shared = [(T, m.n_shared * cfg.d_ff)] if m.n_shared else []
    return [(m.n_experts, C, cfg.d_ff)] + shared


def recurrent_gate_shapes(cfg, B, S):
    """The shapes each pack member sees in one forward of B x S tokens of a
    recurrent family: zamba2's Mamba2 silu on x and z (B, S, inner), on B
    and C (B, S, N) and its shared GLU's (B, S, d_ff), softplus on dt
    (B, S, H); the mLSTM's exp_neg over a chunk's (B, H, L, L) weights, its
    (B, H, L) carry, denominator and chunk-end weights and (B, H) rescale,
    its output gate's sigmoid (B, S, d), the sLSTM step's exp_neg, sigmoid
    and tanh over (B, d)."""
    if cfg.family == "hybrid":
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        return {"silu": [(B, S, inner), (B, S, s.state_dim), (B, S, cfg.d_ff)],
                "softplus": [(B, S, inner // s.head_dim)]}
    H, d, L = cfg.n_heads, cfg.d_model, min(128, S)  # mlstm_block's chunk
    return {"exp_neg": [(B, H, L, L), (B, H, L), (B, H), (B, d)],
            "sigmoid_sym": [(B, S, d), (B, d)], "tanh": [(B, d)]}


def encdec_vlm_shapes(cfg, B, S, T):
    """The gate and exponent shapes of a forward of B x S tokens of whisper
    or internvl over a T-slot self-attention buffer: whisper's encoder over
    its enc_len frames (bidirectional: enc_len queries over enc_len keys),
    its decoder's MLP, self-attention and cross-attention over the frames;
    internvl's backbone over its n_vis patches and the S tokens (S = 1: a
    decode step, over the cache's T slots).  Returns (gate shapes, exponent
    shapes, the exponents' shapes whose last kv chunk holds KV_PAD lanes
    with the number of real keys in it)."""
    E = cfg.enc_len
    if cfg.family == "vlm":  # the cache holds the prefix too
        if S > 1:  # a prefill or training forward: the prefix, then the tokens
            S = T = cfg.n_vis_tokens + S
        else:
            T += cfg.n_vis_tokens
        return [(B, S, cfg.d_ff)], flash_exp_shapes(cfg, B, S, T), {}
    gates = [(B, S, cfg.d_ff)]
    flash = flash_exp_shapes(cfg, B, S, T) + flash_exp_shapes(cfg, B, S, E)
    pad = {}
    if S > 1:  # the encoder runs in a prefill and in training
        gates.append((B, E, cfg.d_ff))
        enc = flash_exp_shapes(cfg, B, E, E)
        flash += enc
        if E % KV_CHUNK:
            pad[enc[0]] = E % KV_CHUNK
    if E % KV_CHUNK:  # cross-attention's last chunk
        pad[flash_exp_shapes(cfg, B, S, E)[0]] = E % KV_CHUNK
    return gates, flash, pad


def family_shapes(s0):
    """Phases 25-27's, 31-33's, 35-37's and 39-40's kernel shapes, as
    ``((gates, exponents), (gates, exponents), kv_pad)`` for serving and
    training, gates by pack member, and the exponent shapes whose last kv
    chunk ends in KV_PAD lanes (whisper's encoder and cross-attention over
    1,500 keys: shape -> real keys in the chunk).  Serving: the gates of a
    decode step, of the queue's prefill (S0 = ``s0``) and of gemma3-12b's
    long prefill, and the exponents over the same queries and the caches'
    (and local rings') widths.  Training: a micro-batch of starcoder2-3b,
    gemma3-12b, deepseek-moe-16b, zamba2-1.2b, xlstm-125m, whisper-small and
    internvl2-1b."""
    from repro_torch.models import get_config

    serve_g, serve_f, train_g, train_f, kv_pad = {}, [], {}, [], {}
    approx = get_config("stablelm-3b").approx
    for arch in DENSE_FAMILY + MOE_FAMILY + RECURRENT_FAMILY + ENCDEC_VLM_FAMILY:
        cfg = get_config(arch)
        check(cfg.approx == approx, f"{arch}'s approx settings are not stablelm-3b's: "
              "phase 3's pack does not serve it")
        member = {"gelu_tanh": "gelu"}.get(cfg.act, cfg.act)  # gelu_tanh: gelu's table
        runs = [(BATCH, 1, CACHE_LEN), (BATCH, s0, s0)]
        if arch == "gemma3-12b":
            lmax = max(len(r.prompt) for r in long_requests(cfg.vocab))
            # a decode step's local ring (1,024 slots) is one kv chunk, as
            # each chunk of the 2,048-slot global buffer
            runs += [(LONG_REQ, 1, LONG_CACHE), (LONG_REQ, lmax, lmax)]
        if arch in ENCDEC_VLM_FAMILY:
            for B, S, T, g, f in ((BATCH, 1, CACHE_LEN, serve_g, serve_f),
                                  (BATCH, s0, s0, serve_g, serve_f),
                                  (MICRO, TRAIN_SEQ, TRAIN_SEQ, train_g, train_f)):
                gates, flash, pad = encdec_vlm_shapes(cfg, B, S, T)
                g.setdefault(member, []).extend(gates)
                f += flash
                kv_pad.update(pad)
            continue
        if arch in RECURRENT_FAMILY:
            for B, S in ((BATCH, 1), (BATCH, s0), (MICRO, TRAIN_SEQ)):
                for name, shapes in recurrent_gate_shapes(cfg, B, S).items():
                    (train_g if S == TRAIN_SEQ else serve_g).setdefault(
                        name, []).extend(shapes)
            if cfg.family == "hybrid":  # the shared block's exponents
                for B, S, T in runs:
                    serve_f += flash_exp_shapes(cfg, B, S, T)
                train_f += flash_exp_shapes(cfg, MICRO, TRAIN_SEQ, TRAIN_SEQ)
            continue
        for B, S, T in runs:
            serve_g.setdefault(member, []).extend(gate_shapes(cfg, B, S))
            serve_f += flash_exp_shapes(cfg, B, S, T)
        if arch not in ("yi-34b", "qwen3-moe-235b-a22b"):  # these serve only
            train_g.setdefault(member, []).extend(gate_shapes(cfg, MICRO, TRAIN_SEQ))
            train_f += flash_exp_shapes(cfg, MICRO, TRAIN_SEQ, TRAIN_SEQ)
    dedup = lambda shapes: list(dict.fromkeys(shapes))
    return (({k: dedup(v) for k, v in serve_g.items()}, dedup(serve_f)),
            ({k: dedup(v) for k, v in train_g.items()}, dedup(train_f)), kv_pad)


def dense_model(arch, n_layers=None):
    """``arch`` at full width in table_pack + TableFlash (``n_layers`` cuts its
    depth), its table_pack_ref twin and random f32 parameters from seed 0."""
    import torch

    from repro_torch.models import build_model, get_config
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = _with_mode(full.replace(n_layers=n_layers or full.n_layers), "table_pack",
                     attn_table=True)
    model = build_model(cfg, "cuda")
    ref = build_model(_with_mode(cfg, "table_pack_ref"), "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    g, m, sm = cfg.attn_geom, cfg.moe, cfg.ssm
    cut = (f" (cut from {full.n_layers})" if cfg.n_layers != full.n_layers else "")
    ffn = (f"moe {m.n_experts} experts top-{m.top_k} + {m.n_shared} shared, "
           f"capacity factor {m.capacity_factor}" if cfg.family == "moe"
           else cfg.mlp_kind)
    heads = (f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads (h_eff {g.h_eff}, g_eff "
             f"{g.g_eff}) x {cfg.head_dim}")
    if cfg.family == "hybrid":
        desc = (f"{model.n_groups} groups of {model.per_group} Mamba2 layers + "
                f"{model.trailing} trailing (expand {sm.expand}, {sm.head_dim}-wide "
                f"heads, state {sm.state_dim}, conv {sm.conv_width}, chunk "
                f"{sm.chunk}), one shared block of {heads} and a {cfg.act} GLU at "
                f"d_ff={cfg.d_ff}")
    elif cfg.family == "xlstm":
        desc = f"{model.n_pairs} mLSTM/sLSTM pairs, {cfg.n_heads} mLSTM heads"
    elif cfg.family == "encdec":
        desc = (f"decoder + {cfg.n_enc_layers} encoder layers over {cfg.enc_len} stub "
                f"frames, {heads}, {ffn} {cfg.act} d_ff={cfg.d_ff}, rope "
                f"{cfg.attn.rope_theta:g} (decoder self-attention)")
    elif cfg.family == "vlm":
        desc = (f"{heads}, {ffn} {cfg.act} d_ff={cfg.d_ff} after {cfg.n_vis_tokens} stub "
                f"patches of width {cfg.d_vis}, rope {cfg.attn.rope_theta:g}")
    else:
        desc = (f"{heads}, {ffn} {cfg.act} d_ff={cfg.d_ff}, period {model.period}, "
                f"qk_norm {cfg.attn.qk_norm}, rope {cfg.attn.rope_theta:g}")
    log(f"{arch}: {cfg.n_layers}L{cut} d={cfg.d_model} {desc}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_pad}), tied {cfg.tie_embeddings}: "
        f"{sum(t.numel() for t in leaves(params)) / 1e9:.3f}B f32 parameters "
        f"({cfg.param_count() / 1e9:.3f}B by param_count), init "
        f"{time.perf_counter() - t0:.1f}s")
    return model, ref, params


def dense_serving_path(arch, smi_line, n_layers=None, long_queue=False,
                       host_cost=False):
    """Phases 25-27, 31, 33, 35, 37, 39 and 40: ``arch`` serving the
    launcher's 8 requests against table_pack_ref (through ContinuousEngine;
    whisper and internvl, whose prefill reads frames or patches, in groups
    through DecodeEngine.generate_batch), the prefill and decode logits against
    table_pack_ref's with one decode step's launches, and one round of
    table_pack's decode-step and prefill ms (``step_breakdown``).  With ``long_queue``
    (gemma3-12b, phase 26) also ``long_requests`` in a LONG_CACHE cache,
    which wrap the local rings.  With ``host_cost`` also the host time and
    operator events of one table_pack decode step.  Returns the serving
    run's launches."""
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer

    model, ref, params = dense_model(arch, n_layers)
    cfg = model.cfg
    reqs = make_requests(cfg.vocab, N_REQ, MAX_NEW)
    kernels = ("table_pack_lookup",) + (("tableflash_exp",) if cfg.family != "xlstm"
                                        else ())
    extra = {}
    if model.extra_inputs:  # whisper's frames, internvl's patches
        _, counts = static_serve_against_plain(arch, model, ref, params, reqs, BATCH,
                                               CACHE_LEN, smi_line)
        extra = {k: torch.from_numpy(v).cuda()
                 for k, v in extra_inputs(model, BATCH, EXTRA_SEED).items()}
    else:
        _, counts = serve_against_plain(arch, model, ref, params, reqs, BATCH,
                                        CACHE_LEN, smi_line, kernels=kernels)
    rows = prompt_rows(reqs, BATCH)
    cache = logits_and_launches(arch, model, ref, params, rows, CACHE_LEN, extra)
    if long_queue:
        long_reqs = long_requests(cfg.vocab)
        check(min(len(r.prompt) for r in long_reqs) > transformer.LOCAL_WINDOW,
              "the long prompts wrap the local rings")
        serve_against_plain(f"{arch} long", model, ref, params, long_reqs, LONG_REQ,
                            LONG_CACHE, smi_line)
        logits_and_launches(f"{arch} long", model, ref, params,
                            prompt_rows(long_reqs, LONG_REQ), LONG_CACHE)
    # one round of table_pack's step alone: the three modes' two rounds and
    # the profiler view run on the main path (phase 4); here they took ~10-20
    # s a family, which phase 43 needs to keep the run under 900 s
    step_breakdown({"table_pack": model}, params, rows, cache, smi_line,
                   tag=f"{arch} ", extra=extra, rounds=1, profile=False)
    if host_cost:
        tok = rows[:, -1:]
        pos = torch.full((BATCH,), rows.shape[1], dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            host_us, n_ops = _host_cost(lambda: model.decode_step(params, tok, pos,
                                                                  cache), 5)
        log(f"host: {arch} table_pack decode step: {host_us / 1e3:.3f} ms host, "
            f"{n_ops} host op events ({n_ops / cfg.n_layers:.1f} a layer) [{smi_line}]")
    del model, ref, params, cache, extra
    torch.cuda.empty_cache()
    return counts


def dense_train_path(arch, smi_line, per_layer, n_layers=None):
    """Phases 25-26's and 32's training: ``arch`` at full width (``n_layers``
    cuts its depth), QP_STEPS steps at the trainer's defaults in table_pack +
    TableFlash, step 0 against table_pack_ref (an MoE model's aux printed
    beside each step's loss).  ``per_layer`` is phase 6's table_pack_grad
    launches a layer and micro-batch (stablelm's silu gate: 1 gate call,
    2 launches, the forward's and remat's recompute; flash's two exponent
    slopes: 4): each further gate call of a layer (an MoE layer's shared
    experts) adds 2.  Returns the training run's launches."""
    import torch

    from repro_torch.train.loop import batch_to

    model, ref, params = dense_model(arch, n_layers)
    data = _trainer_data(model.cfg)
    ref_loss, ref_gn = plain_step0(ref, params, batch_to(data.batch_at(0), "cuda"))
    moe = model.cfg.family == "moe"
    rows, c, peak, _ = train_steps(model, params, data, QP_STEPS, smi_line, arch,
                                   aux_model=ref if moe else None)
    kernels = ("table_pack_grad",) + (("tableflash_exp",)
                                      if model.cfg.family != "xlstm" else ())
    for k in kernels:
        check(c[k] > 0, f"{arch}: kernel {k} was not launched training")
    check(all(math.isfinite(r["loss"]) for r in rows), f"non-finite {arch} loss")
    check(rows[0]["loss"] == ref_loss, f"{arch} step-0 loss {rows[0]['loss']!r} != "
          f"table_pack_ref's {ref_loss!r}")
    gn_rel = abs(rows[0]["grad_norm"] - ref_gn) / ref_gn
    check(gn_rel <= 1e-3, f"{arch} step-0 grad norm {rows[0]['grad_norm']} vs "
          f"table_pack_ref's {ref_gn}: {gn_rel:.2e} > 1e-3")
    per = c["table_pack_grad"] / (QP_STEPS * TRAIN_ACCUM)
    want = grad_launches(model, per_layer)
    check(per == want, f"{arch}: {per} table_pack_grad launches a micro-batch, not "
          f"{want} (2 a gate call: the forward's and remat's recompute; stablelm's "
          f"layer {per_layer})")
    log(f"{arch}: trained {len(rows)} steps ({model.cfg.n_layers}L, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, accum {TRAIN_ACCUM}), step-0 loss equals "
        f"table_pack_ref's bit for bit ({ref_loss!r}), grad norm "
        f"{rows[0]['grad_norm']:.6f} vs {ref_gn:.6f} ({gn_rel:.2e} rel); step ms "
        f"{[round(r['ms'], 1) for r in rows]}; table_pack_grad {per:g} a micro-batch "
        f"({per / (model.cfg.n_layers + model.cfg.n_enc_layers):g} a layer), as derived; "
        f"launches "
        f"{ {k: v for k, v in c.items() if v} }; peak {peak:.2f} GiB [{smi_line}]")
    del model, ref, params
    torch.cuda.empty_cache()
    return c


# --------------------------------------------------------------------------------------
# 29-30. the paper's cells through the table kernel; TableFlash's bound
# --------------------------------------------------------------------------------------


def paper_cells():
    """(tag, run_flow arguments) of the paper's experiment cells: Fig. 3, the
    four tables of Figs. 4-5, Table 2 (hierarchical, omega 0.3) and Table 3
    (hierarchical, omega 0.1), from the port's configs/tabla_paper.py."""
    from repro_torch.configs import tabla_paper as P

    log_dom = (0.625, 15.625)
    cells = [("fig3 log reference", ("log", P.E_A_FIG3, *log_dom, "reference", 0.3, {}))]
    for alg, kw in (("reference", {}), ("binary", {}),
                    ("hierarchical", {"epsilon": 0.015}),
                    ("sequential", {"epsilon": 0.3})):
        cells.append((f"fig45 log {alg}",
                      ("log", P.E_A_WORKED, *log_dom, alg, 0.3, kw)))
    for table, grid, omega in (("table2", P.TABLE2_CELLS, 0.3),
                               ("table3", P.TABLE3_CELLS, 0.1)):
        for name, (lo, hi) in grid.items():
            cells.append((f"{table} {name}",
                          (name, P.E_A_TABLE2, lo, hi, "hierarchical", omega, {})))
    return cells


# 2^-24: half an f32 ulp, relative to the magnitude of a normal result
HALF_ULP = 2.0 ** -24


def rounding_allowance(spec):
    """Per sub-interval j, the most that the table kernel's f32 roundings add to
    the design flow's interpolation error (Ea) at an f32 x in [lo, hi).

    The kernel's op order (csrc/table_lookup.cuh, -fmad=false): p = f32(P_j),
    invd = f32(1 / delta_j), u = (x - p) * invd, i = clip(floor(u)), t = u - i
    (exact), y0, y1 = f32(v_a), f32(v_a+1), d = y1 - y0, y = y0 + t * d.  Each
    f32 rounding adds at most half an ulp of its result, <= 2^-24 |result|:
      * position (x units; the lerp is continuous with cell slopes <= S_j, so
        a position error e moves y by <= S_j e): P_j rounded, <= 2^-24 X_j
        (X_j = max(|P_j|, |P_j+1|), which also covers an x between P_j+1 and
        its f32 that the comparators give to j); invd rounded, x - p rounded
        and the product rounded, each <= 2^-24 W_j (W_j = P_j+1 - P_j >= |x - p|);
      * values: y0 and y1 stored in f32, <= 2^-24 Y_j for their convex
        combination (Y_j = max |f32 value| over j); d rounded and t * d
        rounded, each <= 2^-24 D_j (D_j = max |v_k+1 - v_k| over j, t <= 1);
        y0 + t * d rounded, <= 2^-24 Y_j.
    So A_j = 2^-24 (2 Y_j + 2 D_j + S_j (X_j + 3 W_j)), and the kernel's
    |y - f(x)| <= Ea + A_j for x in sub-interval j (f in f64 on the f32 x)."""
    import numpy as np

    v = spec.values.astype(np.float32).astype(np.float64)
    n = spec.n_intervals
    ends = np.append(spec.base[1:], spec.footprint)
    out = np.empty(n)
    for j in range(n):
        vj = v[int(spec.base[j]): int(ends[j])]
        steps = np.abs(np.diff(vj)) if vj.size > 1 else np.zeros(1)
        y, d = float(np.max(np.abs(vj))), float(np.max(steps))
        s = d / float(spec.delta[j])
        p0, p1 = float(spec.boundaries[j]), float(spec.boundaries[j + 1])
        out[j] = HALF_ULP * (2 * y + 2 * d + s * (max(abs(p0), abs(p1)) + 3 * (p1 - p0)))
    return out


PAPER_POINTS, PAPER_TIMED = 1 << 22, 1 << 24  # checked and timed elements a cell


def paper_phase(smi_line):
    """Phase 29: each paper cell's ``run_flow(verify_error=True)`` on the host, its
    ``TorchTable`` on the card, and ``table_lookup`` over the cell's edge inputs
    and PAPER_POINTS uniform f32 points in [lo, hi): bitwise its plain version
    (NaN positions matched), max |y - f(x)| within Ea + the derived rounding
    allowance, its staging image staged or past the budget, and its device
    time at PAPER_TIMED f32 elements; the cells' rows go to one
    ``PAPER_CELLS [...]`` JSON line.  Returns the path's table_lookup
    launches (one a cell, counted from 0 around each cell's lookup)."""
    import numpy as np
    import torch

    from repro_torch.approx.torch_table import from_spec
    from repro_torch.core import get_function, run_flow
    from repro_torch.kernels import _lib
    from repro_torch.kernels import table_lookup as TL

    past = {"table2 exp", "table3 tan"}  # the cells whose image is past 48 KB
    rows, launches = [], 0
    t0 = time.perf_counter()
    for tag, (name, e_a, lo, hi, alg, omega, kw) in paper_cells():
        rep = run_flow(name, e_a, lo, hi, alg, omega, verify_error=True, **kw)
        spec, fn = rep.spec, get_function(name)
        check(rep.measured_max_error <= e_a, f"paper {tag}: run_flow's measured error "
              f"{rep.measured_max_error:.3e} > Ea {e_a:g}")
        jt = from_spec(spec, "cuda")
        check(rep.smem.image_bytes == 4 * jt.image.numel(),
              f"paper {tag}: smem_cost {rep.smem.image_bytes} != the image's "
              f"{4 * jt.image.numel()} bytes")
        check(rep.smem.fits == (tag not in past),
              f"paper {tag}: image of {rep.smem.image_bytes} bytes on the wrong side "
              f"of the {SMEM_BUDGET}-byte budget")
        g = torch.Generator(device="cuda").manual_seed(29)
        x = torch.rand(PAPER_POINTS, generator=g, device="cuda") * (hi - lo) + lo
        x = torch.where(x < hi, x, torch.full_like(x, lo))  # [lo, hi) after rounding
        edges = torch.as_tensor(row_edges(jt.boundaries.cpu().numpy()), device="cuda")
        x = torch.cat([edges, x])
        _lib.reset_launches()
        y = TL.table_lookup(jt, x)  # the path: one launch over the cell's inputs
        torch.cuda.synchronize()
        launches += _lib.launches["table_lookup"]
        check(_lib.launches["table_lookup"] == 1, f"paper {tag}: table_lookup did not "
              "launch")
        check_pair(f"paper {tag} table_lookup", y, TL.table_lookup_plain(jt, x),
                   x.shape, torch.float32)
        check_pair(f"paper {tag} table_lookup extrapolate=True", TL.table_lookup(
            jt, x, extrapolate=True), TL.table_lookup_plain(jt, x, extrapolate=True),
            x.shape, torch.float32)
        xs = x.cpu().numpy().astype(np.float64)
        ys = y.cpu().numpy().astype(np.float64)
        inside = np.isfinite(xs) & (xs >= lo) & (xs < hi)
        xs, ys = xs[inside], ys[inside]
        err = np.abs(ys - np.asarray(fn.f(xs)))
        allow = rounding_allowance(spec)
        j = np.clip(np.searchsorted(spec.boundaries.astype(np.float32), xs,
                                    side="right") - 1, 0, spec.n_intervals - 1)
        limit = e_a + allow[j]
        worst = int(np.argmax(err - limit))
        check(bool(np.all(np.isfinite(ys))) and bool(np.all(err <= limit)),
              f"paper {tag}: |y - f(x)| {err[worst]:.4e} at x={xs[worst]!r} > Ea "
              f"{e_a:g} + allowance {allow[j[worst]]:.4e}")
        xt = torch.rand(PAPER_TIMED, generator=g, device="cuda") * (hi - lo) + lo
        ms = graph_ms(lambda: TL.table_lookup(jt, xt))
        b_ms, b_by = bound(PAPER_TIMED, 4, 1, member_bytes(jt), jt.n_intervals + 14)
        row = dict(cell=tag, fn=name, domain=[lo, hi], e_a=e_a, algorithm=alg,
                   omega=omega, mf_reference=rep.reference_footprint,
                   mf_split=rep.footprint, reduction_pct=rep.reduction_pct,
                   n_intervals=rep.n_intervals, bram_reference=rep.brams_reference,
                   bram_split=rep.brams, smem_bytes=rep.smem.image_bytes,
                   staged=rep.smem.fits, max_err=float(err.max()),
                   flow_max_err=rep.measured_max_error,
                   max_allowance=float(allow.max()), us=ms * 1e3,
                   bound_us=b_ms * 1e3, bound_by=b_by)
        rows.append(row)
        log(f"paper: [{tag}] {name}[{lo},{hi}) Ea={e_a:g} {alg} omega={omega}: M_F "
            f"{rep.reference_footprint} -> {rep.footprint} (-{rep.reduction_pct:.1f}%), "
            f"n={rep.n_intervals}, BRAM18 {rep.brams_reference} -> {rep.brams}, "
            f"smem {rep.smem.image_bytes} B "
            f"({'staged' if rep.smem.fits else 'past the budget'}); kernel bitwise its "
            f"plain version over {x.numel()} inputs; max |y - f| {err.max():.4e} "
            f"(run_flow's {rep.measured_max_error:.4e}; Ea {e_a:g}, allowance <= "
            f"{allow.max():.4e}); {ms * 1e3:.2f} us at {PAPER_TIMED} f32, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}) [{smi_line}]")
    log(f"paper: {len(rows)} cells, {launches} table_lookup launches on their path, "
        f"phase 29 in {time.perf_counter() - t0:.1f}s")
    print("PAPER_CELLS " + json.dumps(rows))
    return launches


def flash_bound_phase(smi_line):
    """Phase 30: ``flash_attention`` with ``exp_fn`` the ``tableflash_exp`` kernel
    over stablelm-3b's pack (e_a 1e-4, omega 0.2) against ``exp_fn=None`` on
    the same seeded f32 q, k, v: stablelm-3b's decode (per-row clocks, empty
    slots) and prefill (S0 = 27) at cache 256, and gemma3-12b's global layer
    decoding at cache 2,048 (two kv chunks of 1,024).  The max row error must
    be finite and within ``flash_abs_bound(EA_EFF, T, KV_CHUNK, max|v|)``, with
    the reference test's EA_EFF = Ea * 1.02 + 1e-5.  Returns the table runs'
    tableflash_exp launches."""
    import torch

    from repro_torch.core.attn_error import EXP_NEG_LO, flash_abs_bound
    from repro_torch.kernels import _lib
    from repro_torch.models import get_config
    from repro_torch.models.attention import flash_attention

    base = get_config("stablelm-3b")
    approx = dataclasses.replace(base.approx, mode="table_pack", attn_table=True)
    pack = approx.pack("cuda")
    fid = pack.fn_id("exp_neg")
    check(pack.domains[fid][0] == EXP_NEG_LO, f"exp_neg's lo {pack.domains[fid][0]} "
          f"is not the bound's {EXP_NEG_LO}")
    exp_fn = approx.attn_exp("cuda")
    ea_eff = approx.e_a * 1.02 + 1e-5
    g = torch.Generator(device="cuda").manual_seed(30)
    gem = get_config("gemma3-12b").attn_geom
    stl = base.attn_geom
    # (tag, B, S, T, G, Qg, D, query positions (B, S), live keys per row)
    cases = (("stablelm-3b decode", BATCH, 1, CACHE_LEN, stl.g_eff, stl.q_per_group,
              base.head_dim, [[100], [180], [255], [37]], [101, 181, 256, 38]),
             ("stablelm-3b prefill", BATCH, 27, CACHE_LEN, stl.g_eff, stl.q_per_group,
              base.head_dim, [list(range(27))] * BATCH, [27] * BATCH),
             ("gemma3-12b global decode", LONG_REQ, 1, LONG_CACHE, gem.g_eff,
              gem.q_per_group, get_config("gemma3-12b").head_dim, [[1500], [2047]],
              [1501, 2048]))
    launches = 0
    for tag, B, S, T, G, Qg, D, qpos, live in cases:
        q = torch.randn((B, S, G, Qg, D), generator=g, device="cuda")
        k = torch.randn((B, T, G, D), generator=g, device="cuda")
        v = torch.randn((B, T, G, D), generator=g, device="cuda")
        q_pos = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        k_pos = torch.arange(T, dtype=torch.int32, device="cuda").repeat(B, 1)
        k_pos = torch.where(k_pos < torch.tensor(live, device="cuda")[:, None], k_pos, -1)
        exact = flash_attention(q, k, v, q_pos, k_pos, kv_chunk=KV_CHUNK)
        _lib.reset_launches()
        table = flash_attention(q, k, v, q_pos, k_pos, kv_chunk=KV_CHUNK, exp_fn=exp_fn)
        torch.cuda.synchronize()
        n = _lib.launches["tableflash_exp"]
        n_chunks = -(-T // min(KV_CHUNK, T))
        check(n == 2 * n_chunks, f"flash bound [{tag}]: {n} tableflash_exp launches, "
              f"not 2 a kv chunk ({n_chunks} chunks)")
        launches += n
        err = float((table - exact).abs().max())
        bnd = flash_abs_bound(ea_eff, T, KV_CHUNK, float(v.abs().max()))
        check(math.isfinite(err) and math.isfinite(bnd) and err <= bnd,
              f"flash bound [{tag}]: max row error {err:.4e} > flash_abs_bound {bnd:.4e}")
        log(f"flash bound: [{tag}] q {tuple(q.shape)} k/v {tuple(k.shape)}, kv chunk "
            f"{min(KV_CHUNK, T)} x {n_chunks}: max |table - exact| {err:.4e} <= "
            f"flash_abs_bound {bnd:.4e} (EA_EFF {ea_eff:g}, max|v| "
            f"{float(v.abs().max()):.3f}); {n} tableflash_exp launches [{smi_line}]")
    return launches


# --------------------------------------------------------------------------------------
# 42. device telemetry and the observability tools
# --------------------------------------------------------------------------------------


def _built(cfg, telemetry):
    """``cfg``'s model on the card, its activation closures built with the
    device telemetry on or off (the flags are captured at build, then
    cleared: the engines record no host spans in either run)."""
    from repro_torch import obs
    from repro_torch.models import build_model

    obs.configure(enabled=telemetry, device_telemetry=telemetry)
    try:
        return build_model(cfg, "cuda")
    finally:
        obs.disable()


def _read_counters():
    """The global registry's counters (one transfer of every pending device
    count), then an empty registry."""
    from repro_torch import obs

    counters = obs.get_registry().summary()["counters"]
    obs.reset_registry()
    return counters


def served_lookups(cfg, engine, s0):
    """``approx.lookups.*`` of a ContinuousEngine serve of stablelm, from the
    code: each layer's gate over (B, S, d_ff) a prefill (S = s0) and a
    decode tick (S = 1); flash attention's p over every real key of its one
    chunk pair (s0 in a prefill, the cache's CACHE_LEN slots in a tick; no
    KV_PAD lane) and its alpha once a query row, for B x S x g_eff x
    q_per_group rows."""
    check(s0 <= Q_CHUNK and CACHE_LEN <= KV_CHUNK, "one chunk pair an attention")
    g = cfg.attn_geom
    rows, ticks = BATCH * g.g_eff * g.q_per_group, engine.batch_steps - engine.prefills
    return {cfg.act: cfg.n_layers * BATCH * cfg.d_ff * (engine.prefills * s0 + ticks),
            "attn_exp": cfg.n_layers * rows * (engine.prefills * s0 * (s0 + 1)
                                               + ticks * (CACHE_LEN + 1))}


def _decode_cost(fn):
    """Host operator events of one call of ``fn`` under torch.profiler (CPU
    activity only), and how many of them read a device scalar to the host
    (``aten::_local_scalar_dense`` / ``aten::item``: a sync)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    return len(names), sum(n in ("aten::_local_scalar_dense", "aten::item")
                           for n in names)


def run_clis(tmp):
    """The serve CLI (reduced stablelm, ``quant_pack`` + TableFlash) and the
    train CLI (1 step, ``table_pack`` + TableFlash) with ``--obs --trace``,
    as two processes at once on the card; each trace valid by
    ``tools/check_trace.py``, its counters the ones ``--obs`` printed,
    rendered by ``tools/torch_obs_report.py``."""
    import os

    sys.path.insert(0, str(REPO / "tools"))
    from check_trace import validate_trace

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    common = ["--arch", "stablelm-3b", "--reduced", "--attn-table", "--obs"]
    cmds = {
        "serve": [sys.executable, "-m", "repro_torch.launch.serve", *common,
                  "--approx-mode", "quant_pack", "--trace", str(tmp / "serve.json")],
        "train": [sys.executable, "-m", "repro_torch.launch.train", *common,
                  "--steps", "1", "--batch", "4", "--seq", "16", "--approx-mode",
                  "table_pack", "--trace", str(tmp / "train.json"), "--ckpt-dir",
                  str(tmp / "ckpt")]}
    procs = {k: subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, proc in procs.items():
            outs[k] = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"{k} CLI --obs --trace exited "
                  f"{proc.returncode}: {outs[k][1][-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, (out, _) in outs.items():
        with open(tmp / f"{k}.json") as f:
            doc = json.load(f)
        errors = validate_trace(doc)
        check(errors == [], f"{k} CLI trace invalid: {errors[:5]}")
        printed = json.loads(out[out.index("{"): out.rindex("}") + 1])
        printed = printed["metrics"] if k == "serve" else printed
        counters = doc["metadata"]["metrics"]["counters"]
        check(counters and counters == printed["counters"],
              f"{k} CLI: the trace's counters {counters} != --obs's")
        check(counters["approx.lookups.attn_exp"] > 0, f"{k} CLI: no TableFlash count")
        if k == "serve":
            check(counters["approx.quant_gathers.silu"]
                  == 2 * counters["approx.lookups.silu"], "serve CLI: quant gathers")
        report = subprocess.run(
            [sys.executable, str(REPO / "tools" / "torch_obs_report.py"),
             str(tmp / f"{k}.json")], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=120)
        check(report.returncode == 0 and "approx.oob.attn_exp" in report.stdout,
              f"torch_obs_report.py on the {k} trace: {report.stderr[-2000:]}")
        log(f"obs: {k} CLI --obs --trace: {len(doc['traceEvents'])} events, valid; "
            f"counters {counters}")
        for line in report.stdout.splitlines()[:14]:
            log(f"obs:   | {line}")


def telemetry_phase(smi_line):
    """Phase 42: full-width stablelm-3b at 8 of its 32 layers (seed-0
    weights) with the device telemetry on and off; see the module docstring.
    Returns the launches of the telemetry-on runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.train.loop import accumulated_grads, batch_to

    base = get_config("stablelm-3b").replace(n_layers=NON_MAIN_TRAIN_LAYERS)
    params = build_model(base, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    reqs = make_requests(base.vocab, N_REQ, MAX_NEW)
    s0 = max(len(r.prompt) for r in reqs)
    launches = {}

    def add(c):
        for k, v in c.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    def serve(model):
        K.reset_launches()
        engine = ContinuousEngine(model, params, BATCH, CACHE_LEN)
        out = engine.serve(reqs)
        torch.cuda.synchronize()
        return [r.tokens for r in out], engine, dict(K.launches), _read_counters()

    models = {}
    _read_counters()
    for mode, kname in (("table_pack", "table_pack_lookup"),
                        ("quant_pack", "quant_pack_lookup"),
                        ("routed_pack", "routed_pack_lookup")):
        cfg = _with_mode(base, mode, attn_table=True)
        off, on = _built(cfg, False), _built(cfg, True)
        ref = _built(_with_mode(cfg, mode + "_ref"), True)
        models[mode] = {False: off, True: on}
        toks_off, _, _, c_off = serve(off)
        toks, engine, c, counters = serve(on)
        toks_ref, _, c_ref, counters_ref = serve(ref)
        check(c_off == {} and c[kname] > 0 and c["tableflash_exp"] > 0
              and not any(c_ref.values()),
              f"{mode}: off run counted {c_off}; launches {c}, _ref {c_ref}")
        for i, (a, b, d) in enumerate(zip(toks, toks_ref, toks_off)):
            check((a == b).all() and (a == d).all(), f"{mode} request {i}: telemetry-on "
                  f"tokens {a.tolist()}, _ref {b.tolist()}, off {d.tolist()}")
        check(counters == counters_ref, f"{mode}: counters {counters} != "
              f"{mode}_ref's {counters_ref}")
        want = served_lookups(cfg, engine, s0)
        got = {k[len("approx.lookups."):]: v for k, v in counters.items()
               if k.startswith("approx.lookups.")}
        check(got == want, f"{mode}: lookups {got} != {want} derived from the code")
        if mode == "quant_pack":
            gathers = {k[len("approx.quant_gathers."):]: v for k, v in counters.items()
                       if k.startswith("approx.quant_gathers.")}
            check(gathers == {cfg.act: 2 * want[cfg.act]}, f"quant gathers {gathers}")
        add(c)
        log(f"obs: {mode} served {N_REQ} requests ({NON_MAIN_TRAIN_LAYERS} layers, "
            f"{engine.prefills} prefills, {engine.batch_steps - engine.prefills} ticks), "
            f"telemetry on: tokens equal to the off run's and {mode}_ref's, counters "
            f"equal to {mode}_ref's {counters}, lookups as derived; launches "
            f"{ {k: v for k, v in c.items() if v} } [{smi_line}]")
        del ref

    # routed dispatch: one mixed batch, a member a row
    x = (torch.randn((len(OBS_ROUTING), base.d_ff), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(42)) * 2
         ).to(torch.bfloat16)
    ys = {}
    for mode in ("routed_pack", "routed_pack_ref"):
        approx = dataclasses.replace(base.approx, mode=mode)
        obs.configure(enabled=True, device_telemetry=True)
        try:
            f = approx.routed_fn(OBS_ROUTING, "cuda")
        finally:
            obs.disable()
        K.reset_launches()
        ys[mode] = (f(x), dict(K.launches), _read_counters())
    (y, c, counters), (y_ref, _, counters_ref) = ys["routed_pack"], ys["routed_pack_ref"]
    want = {f"approx.routed.{n}": OBS_ROUTING.count(n) for n in set(OBS_ROUTING)}
    check(torch.equal(y, y_ref) and c["routed_pack_lookup"] == 1
          and counters == counters_ref == want,
          f"routed_fn {OBS_ROUTING}: launches {c}, counters {counters} / "
          f"{counters_ref}, want {want}")
    add(c)
    log(f"obs: routed_fn {OBS_ROUTING} over ({len(OBS_ROUTING)}, {base.d_ff}) bf16, one "
        f"routed_pack_lookup launch, bitwise routed_pack_ref's; dispatch counters "
        f"{counters}")

    # one training step's grads (remat: the recompute counts again)
    cfg = _with_mode(base, "table_pack", attn_table=True)
    batch0 = batch_to(_trainer_data(cfg).batch_at(0), "cuda")
    train = {}
    for key, model in (("off", _built(cfg, False)), ("on", _built(cfg, True)),
                       ("ref", _built(_with_mode(cfg, "table_pack_ref"), True))):
        K.reset_launches()
        loss, grads = accumulated_grads(model, params, batch0, TRAIN_ACCUM)
        torch.cuda.synchronize()
        train[key] = (loss, dict(K.launches), _read_counters())
        del grads, model
    (loss_off, _, c_off), (loss, c, counters), (loss_ref, _, counters_ref) = (
        train["off"], train["on"], train["ref"])
    # remat recomputes each checkpointed layer's forward, counted again
    want = (1 + base.remat) * base.n_layers * TRAIN_BATCH * TRAIN_SEQ * base.d_ff
    check(torch.equal(loss, loss_off) and c_off == {} and c["table_pack_grad"] > 0,
          f"train: telemetry-on loss {float(loss)!r} != off {float(loss_off)!r}, or "
          f"launches {c}, off counters {c_off}")
    check(counters == counters_ref and counters[f"approx.lookups.{base.act}"] == want,
          f"train: counters {counters} != table_pack_ref's {counters_ref} (gate "
          f"lookups {want}: the forward and remat's recompute)")
    add(c)
    log(f"obs: one table_pack step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, accum "
        f"{TRAIN_ACCUM}, remat), telemetry on: loss {float(loss)!r} bit-equal to the off "
        f"run's, counters equal to table_pack_ref's (loss {float(loss_ref)!r}) "
        f"{counters}; launches {c} [{smi_line}]")

    # host cost of one decode step, telemetry on and off
    rows = prompt_rows(reqs, BATCH)
    pos = torch.full((BATCH,), s0, dtype=torch.int32, device="cuda")
    tok = rows[:, -1:]
    for mode, pair in models.items():
        cost = {}
        with torch.inference_mode():
            for tele in (False, True, True, False):
                m = pair[tele]
                cache = m.prefill(params, {"tokens": rows},
                                  m.init_cache(BATCH, CACHE_LEN))[1]
                step = lambda: m.decode_step(params, tok, pos, cache)  # noqa: E731
                _mean_ms(step, 2)
                ms = _mean_ms(step, 10)
                events, scalar_reads = _decode_cost(step)
                K.reset_launches()
                step()
                torch.cuda.synchronize()
                n = sum(K.launches.values())
                c = cost.setdefault(tele, {"ms": []})
                c["ms"].append(ms)
                c.update(events=events, scalar_reads=scalar_reads, launches=n)
        _read_counters()
        for tele in (False, True):
            c = cost[tele]
            log(f"obs: {mode} decode step, telemetry {'on' if tele else 'off'}: "
                f"{', '.join(f'{v:.3f}' for v in c['ms'])} ms (2 rounds), "
                f"{c['events']} host op events, {c['launches']} kernel launches, "
                f"{c['scalar_reads']} scalar reads [{smi_line}]")
            check(c["scalar_reads"] == 0, f"{mode}: a decode step with telemetry "
                  f"{'on' if tele else 'off'} read {c['scalar_reads']} device scalars")
        check(cost[True]["launches"] == cost[False]["launches"],
              f"{mode}: the probes launched a kernel")
    del models, params
    torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        run_clis(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------------------


# --------------------------------------------------------------------------------------
# 43. the mesh path
# --------------------------------------------------------------------------------------


def _mesh_rank(rank, world, store, layout, out):
    """Phase 43, one of ``world`` spawned ranks sharing the card (gloo): the
    probe (an all-reduce of a CUDA tensor), then the sharded pack placed over a (1,
    world) mesh and ``eval_sharded_mesh``'s value and slope (this rank's
    ``tp_spack_lookup`` over its one slice, all-reduced) against the
    off-mesh kernels on the whole pack (bitwise) and the replicated
    ``table_pack_grad`` (as values): every member at phase 3's edge inputs,
    the gate at stablelm's decode and training shapes, bf16 and f32,
    extrapolation off and on.  Writes its result to ``out/rank<r>.json``."""
    import faulthandler
    import traceback

    res = {"rank": rank, "ok": False}
    # a fault in a collective or a launch kills the rank: its Python stack
    # goes to rank<r>.err, which the phase prints
    err = open(os.path.join(out, f"rank{rank}.err"), "w")
    faulthandler.enable(err)
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, str(REPO / "src"))
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.approx import table_pack
        from repro_torch.kernels import _lib
        from repro_torch.kernels import table_pack_lookup as K
        from repro_torch.parallel.sharding import place_sharded_pack

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        t = torch.full((8,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        res["probe"] = float(t[0])
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                          mesh_dim_names=("data", "model"))
        rp = table_pack.from_layout(layout, "cuda")
        sp = table_pack.shard_pack(layout, world, "cuda")
        placed = place_sharded_pack(sp, mesh)
        res["held"] = [tuple(placed.values.shape), tuple(placed.owned.shape),
                       placed.first_shard, placed.image is None]
        gate = sp.fn_id("silu")
        mesh_launches, cases = 0, 0
        for fid, name in enumerate(sp.names):
            lo, hi = sp.domains[fid]
            edges = phase3_edges(sp, fid)
            shapes = [(edges.size,)] + ([(BATCH, 1, 6912), (MICRO, TRAIN_SEQ, 6912)]
                                        if fid == gate else [])
            for dtype in (torch.bfloat16, torch.float32):
                for shape in shapes:
                    x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                    for ex in (False, True):
                        t = f"rank {rank}/{world} {name} {dtype} {shape} extrapolate={ex}"
                        before = _lib.launches["sharded_pack_lookup"]
                        y = table_pack.eval_sharded_mesh(placed, fid, x, mesh, extrapolate=ex,
                                                         use_kernel=True)
                        dy = table_pack.eval_sharded_mesh(placed, fid, x, mesh,
                                                          extrapolate=ex, use_kernel=True,
                                                          slope=True)
                        mesh_launches += _lib.launches["sharded_pack_lookup"] - before
                        check_pair(f"mesh value {t}", y,
                                   K.sharded_pack_lookup(sp, fid, x, extrapolate=ex),
                                   shape, dtype)
                        check_pair(f"mesh slope {t}", dy,
                                   K.sharded_pack_slope(sp, fid, x, extrapolate=ex),
                                   shape, dtype)
                        ry, rd = K.table_pack_grad(rp, fid, x, extrapolate=ex)
                        equal_values(f"mesh value vs replicated {t}", y, ry, x)
                        equal_values(f"mesh slope vs replicated {t}", dy, rd, x)
                        cases += 1
        check(mesh_launches == 2 * cases, f"rank {rank}: {mesh_launches} launches of "
              f"tp_spack_lookup for {cases} value + slope evaluations")
        res.update(ok=True, cases=cases, launches=mesh_launches)
        dist.destroy_process_group()
    except BaseException:
        res["error"] = traceback.format_exc()[-3000:]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    faulthandler.disable()
    err.close()


def _rank_faults(tmp, world):
    """The fault logs of the ranks that wrote one."""
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path) and os.path.getsize(path):
            with open(path) as f:
                out.append(f"rank {r}:\n{f.read()[-2000:]}")
    return "\n".join(out)


def mesh_pack_ranks(world, layout):
    """Phase 43's pack half on ``world`` ranks: spawn them, wait, and fail
    the phase if a rank failed or did not answer."""
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_mesh_rank, args=(world, os.path.join(tmp, "store"),
                                                   layout, tmp),
                                 nprocs=world, join=False, start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MESH_RANK_TIMEOUT:
                    for p in ctx.processes:
                        p.kill()
                    raise SmokeError(f"mesh ranks ({world}) did not finish in "
                                     f"{MESH_RANK_TIMEOUT} s\n{_rank_faults(tmp, world)}")
        except ProcessException as e:
            raise SmokeError(f"mesh ranks ({world}): {e}\n{_rank_faults(tmp, world)}") from None
        res = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            check(os.path.exists(path), f"mesh rank {r}/{world} wrote no result")
            with open(path) as f:
                res.append(json.load(f))
    for r in res:
        check(r["ok"], f"mesh rank {r['rank']}/{world} failed:\n{r.get('error')}")
    want = world * (world + 1) / 2
    check(all(r["probe"] == want for r in res),
          f"gloo all-reduce of CUDA tensors over {world} ranks: {[r['probe'] for r in res]}")
    log(f"mesh: {world} gloo ranks on one card: all-reduce of a CUDA tensor ok; "
        f"each rank "
        f"holds values {res[0]['held'][0]}, planes {res[0]['held'][1]} (its shard = its "
        f"'model' coordinate, no staging image); {res[0]['cases']} cases a rank, "
        f"eval_sharded_mesh value and slope bitwise the off-mesh sharded kernels and "
        f"equal to the replicated ones; tp_spack_lookup launches by rank "
        f"{[r['launches'] for r in res]}")
    return [r["launches"] for r in res]


def mesh_train_path(smi_line):
    """Phase 43's training half: ``launch/train.py --mesh debug`` run alone (a
    1 x 1 NCCL mesh), stablelm-3b at full width cut to NON_MAIN_TRAIN_LAYERS
    layers, QP_STEPS steps at the trainer's shapes in sharded_pack at one
    shard (the pack placed on the mesh: its gate takes the mesh branch, a
    value and a slope launch of tp_spack_lookup a gate call); its losses
    against the unmeshed port's two steps (the same init, data, optimizer
    and accumulation): step 0 within 0.05 (the reference's bound for its WUS
    step: the work copy is bf16), step 1, after the first update, within
    1e-3.  Returns the mesh run's launches."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _lib
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model, get_config
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, init_state, make_train_step

    cfg = _with_mode(get_config("stablelm-3b").replace(n_layers=NON_MAIN_TRAIN_LAYERS),
                     "sharded_pack", pack_shards=1)
    plain = build_model(cfg, "cuda")
    state = init_state(plain)
    data = _trainer_data(cfg)
    # the launcher's optimizer for QP_STEPS steps at its default lr
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=max(1, QP_STEPS // 20),
                            total_steps=QP_STEPS)
    step = make_train_step(plain, opt, TRAIN_ACCUM)
    plain_losses = []
    for i in range(QP_STEPS):
        state, metrics = step(state, batch_to(data.batch_at(i), "cuda"))
        plain_losses.append(float(metrics["loss"]))
    del plain, state, step, metrics
    torch.cuda.empty_cache()
    argv = ["--arch", "stablelm-3b", "--mesh", "debug", "--steps", str(QP_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum",
            str(TRAIN_ACCUM), "--approx-mode", "sharded_pack", "--pack-shards", "1"]
    get = cli.get_config
    cli.get_config = lambda arch: get(arch).replace(n_layers=NON_MAIN_TRAIN_LAYERS)
    try:
        with tempfile.TemporaryDirectory() as ck:
            _lib.reset_launches()
            t0 = time.perf_counter()
            out = cli.main(argv + ["--ckpt-dir", ck])
            torch.cuda.synchronize()
            c = dict(_lib.launches)
            wall = time.perf_counter() - t0
            check(os.listdir(ck), "the mesh run wrote no checkpoint")
    finally:
        cli.get_config = get
        if dist.is_initialized():
            dist.destroy_process_group()
    losses = out["losses"]
    check(len(losses) == QP_STEPS and all(math.isfinite(v) for v in losses),
          f"mesh training losses {losses}")
    diffs = [abs(a - b) for a, b in zip(losses, plain_losses)]
    check(diffs[0] < 0.05 and diffs[1] < 1e-3, f"mesh training losses {losses} vs the "
          f"unmeshed port's {plain_losses}")
    check(c["sharded_pack_lookup"] > 0 and c["sharded_pack_grad"] == 0,
          f"the mesh run's gate did not take the mesh branch: {c}")
    log(f"mesh: launch/train.py --mesh debug alone (1 x 1 NCCL mesh, WUS + ZeRO-1), "
        f"stablelm-3b {NON_MAIN_TRAIN_LAYERS}L full width, {QP_STEPS} steps (batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, accum {TRAIN_ACCUM}), sharded_pack at 1 shard "
        f"placed on the mesh: losses {losses}, the unmeshed port's {plain_losses} "
        f"(off by {diffs}); tp_spack_lookup "
        f"{c['sharded_pack_lookup']} launches (value and slope on the mesh), "
        f"sharded_pack_grad 0; {wall:.1f} s with the checkpoint [{smi_line}]")
    return c


def mesh_phase(smi_line):
    """Phase 43: the pack's mesh branch on 2 and 4 ranks sharing the card,
    then the --mesh debug training.  Returns (the training's launches, the
    ranks' launches by world)."""
    from repro_torch.core.flow import cached_table
    from repro_torch.core.packing import pack_layout
    from repro_torch.models import get_config

    a = get_config("stablelm-3b").approx
    layout = pack_layout([cached_table(n, a.e_a, omega=a.omega) for n in a.pack_functions])
    ranks = {world: mesh_pack_ranks(world, layout) for world in MESH_RANKS}
    return mesh_train_path(smi_line), ranks


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        with phase("1-2"):
            name, smi_line = device_info()
            build_kernels()
        from repro_torch.launch.serve import make_requests
        from repro_torch.models import get_config

        cfg = get_config("stablelm-3b")
        with phase("3"):
            # the pack stablelm-3b's own approx settings build (e_a 1e-4, omega 0.2)
            pack = dataclasses.replace(cfg.approx, mode="table_pack").pack("cuda")
            s0 = max(len(r.prompt) for r in make_requests(cfg.vocab, N_REQ, MAX_NEW))
            log(f"pack: {pack.names}, {pack.footprint} f32 entries, n_max {pack.n_max}, "
                f"intervals {pack.n_intervals}; main-path prefill width S0={s0}")
            approx = dataclasses.replace(cfg.approx, mode="table_pallas")
            f32_packs = static_f32_packs(pack, cfg.approx)
            # the dense and MoE families' shapes (phases 25-27, 31-33) on the same
            # pack: their approx settings are stablelm-3b's
            serve_shapes, train_shapes, kv_pad = family_shapes(s0)
            worst = kernel_phase(f32_packs, s0, flash_packs(pack, approx), serve_shapes,
                                 kv_pad)
            worst.update(grad_kernel_phase(f32_packs, static_tables(approx, pack.names),
                                           s0, train_shapes, kv_pad))
        # each kernel's launches come from the run of the path it serves,
        # counted from 0 just before that path and read just after it
        with phase("4"):
            counts = main_path(smi_line)
        with phase("5"):
            reference_check()
        with phase("6"):
            counts["table_pack_grad"] = train_path(smi_line)["table_pack_grad"]
        with phase("7"):
            serve_counts, train_counts = table_pallas_path(smi_line)
        counts["table_lookup"] = serve_counts["table_lookup"]
        counts["table_lookup_grad"] = train_counts["table_lookup_grad"]
        with phase("8"):
            times = timing_phase(pack, approx, smi_line)
        with phase("9"):
            qp_packs = quant_poly_packs(cfg.approx)
            big_poly = past_budget_poly_pack(cfg.approx)
            worst.update(quant_poly_kernel_phase(
                qp_packs + (("poly", "mixed poly e_a 1e-8", big_poly),), s0))
        with phase("10"):
            counts.update(pack_serving_paths(smi_line, (
                ("quant_pack", ("quant_pack_lookup",)),
                ("poly_pack", ("poly_pack_lookup",)))))
        with phase("11"):
            counts.update(pack_train_paths(smi_line, (
                ("quant_pack", ("quant_pack_grad",)),
                ("poly_pack", ("poly_pack_grad",)))))
        with phase("12"):
            times.update(quant_poly_timing_phase(qp_packs[0][2], qp_packs[2][2],
                                                 smi_line))
        with phase("13"):
            r_packs = (routed_f32_packs(pack, f32_packs[1][1])
                       + routed_quant_packs(cfg.approx, qp_packs[0][2], qp_packs[1][2],
                                            qp_packs[4][2]))
            worst.update(routed_kernel_phase(r_packs, s0))
            # (the phase re-routes both f32 packs) the quant pack staged whole and
            # restaged per member
            reroute_check(r_packs[2][1], r_packs[-1][1])
            del r_packs
        with phase("14"):
            counts.update(pack_serving_paths(smi_line, (
                ("routed_pack", ("routed_pack_lookup",)),
                ("routed_quant_pack", ("routed_quant_pack_lookup",)))))
        with phase("15"):
            counts.update(pack_train_paths(smi_line, (
                ("routed_pack", ("routed_pack_grad",)),
                ("routed_quant_pack", ("routed_quant_pack_grad",)))))
        with phase("16"):
            # per-element f32 operations beyond the compares, as phases 8 and 12
            times.update(routed_timing_phase(((pack, 14), (qp_packs[0][2], 22)),
                                             smi_line))
        # 17-20: RangeFold (table-served RoPE) and routed PolyPack
        with phase("17"):
            f_packs = fold_packs(cfg.approx)
            fold_pack = f_packs[0][1]
            log(f"fold pack: {fold_pack.names}, intervals {fold_pack.n_intervals}")
            worst.update(folded_kernel_phase(f_packs))
            del f_packs
            worst.update(routed_kernel_phase((("poly", qp_packs[2][2]),
                                              ("mixed poly", qp_packs[3][2]),
                                              ("mixed poly e_a 1e-8", big_poly)), s0))
            reroute_check(big_poly)
            del big_poly
        # each mode's launches, counted from 0 before it serves or trains
        with phase("18"):
            serve18 = pack_serving_paths(smi_line, (
                ("table_pack+rope", ("folded_pack_lookup", "table_pack_lookup")),
                ("folded_pack+rope", ("folded_pack_lookup", "table_pack_lookup")),
                ("folded_routed_pack+rope", ("folded_pack_lookup",
                                             "routed_pack_lookup"))),
                n_layers=ROPE_SERVE_LAYERS)
            serve18.update(pack_serving_paths(smi_line, (
                ("routed_poly_pack", ("routed_poly_pack_lookup",)),)))
        counts["folded_pack_lookup"] = serve18["folded_pack_lookup"]
        counts["routed_poly_pack_lookup"] = serve18["routed_poly_pack_lookup"]
        with phase("19"):
            train19 = pack_train_paths(smi_line, (
                ("table_pack+rope", ("folded_pack_lookup", "table_pack_grad")),
                ("routed_poly_pack", ("routed_poly_pack_grad",))))
            counts["folded_pack_grad"] = folded_autograd_check(smi_line)
        counts["routed_poly_pack_grad"] = train19["routed_poly_pack_grad"]
        with phase("20"):
            times.update(folded_timing_phase(fold_pack, smi_line))
            poly = qp_packs[2][2]
            d = poly.degrees[poly.fn_id("silu")]
            times.update(routed_timing_phase(((poly, 10 + 6 * (d + 1) + 5 * d),),
                                             smi_line))
        # 21-24: ShardedPack
        with phase("21"):
            s_packs = sharded_packs(cfg.approx)
            worst.update(sharded_kernel_phase(s_packs, s0))
            worst.update(sharded_routed_kernel_phase(s_packs, s0))
            del s_packs
        with phase("22"):
            counts.update(sharded_serving_path(smi_line, counts["table_pack_lookup"]))
        with phase("23"):
            train23 = pack_train_paths(smi_line, (("sharded_pack",
                                                   ("sharded_pack_grad",)),),
                                       profile=True)
        # the gate calls of its QP_STEPS + 1 steps: routed_pack's gate grad
        # launches once a call over QP_STEPS steps of the same trainer
        gate_calls23 = counts["routed_pack_grad"] // QP_STEPS * (QP_STEPS + 1)
        check(train23["sharded_pack_grad"] == gate_calls23,
              f"sharded_pack_grad launches {train23['sharded_pack_grad']} != the "
              f"{gate_calls23} gate calls (one launch a call)")
        log(f"sharded_pack: 1 grad launch over {PACK_SHARDS} shards for each of the "
            f"{gate_calls23} gate calls of {QP_STEPS + 1} training steps")
        counts["sharded_pack_grad"] = train23["sharded_pack_grad"]
        with phase("24"):
            times.update(sharded_timing_phase(cfg.approx, smi_line))
        # 25-28: the rest of the dense family, through the pack kernels
        per_layer = counts["table_pack_grad"] / (TRAIN_STEPS * cfg.n_layers * TRAIN_ACCUM)
        with phase("25"):
            dense_serving_path("starcoder2-3b", smi_line)
            dense_train_path("starcoder2-3b", smi_line, per_layer)
        with phase("26"):
            dense_serving_path("gemma3-12b", smi_line, n_layers=GEMMA_SERVE_LAYERS,
                               long_queue=True)
            dense_train_path("gemma3-12b", smi_line, per_layer,
                             n_layers=GEMMA_TRAIN_LAYERS)
        with phase("27"):
            dense_serving_path("yi-34b", smi_line, n_layers=YI_LAYERS)
        with phase("28"):
            reference_check("gemma3-12b", window=8)
            reference_check("starcoder2-3b")
        # 29-30: the paper's cells through the table kernel, TableFlash's bound;
        # their own launches, beside the kernels line's main-path counts
        with phase("29"):
            paper_launches = {"table_lookup": paper_phase(smi_line)}
        with phase("30"):
            paper_launches["tableflash_exp"] = flash_bound_phase(smi_line)
        # 31-34: the MoE family, through the pack kernels; their launches too
        moe_launches = {}

        def add(c):
            for k in ("table_pack_lookup", "tableflash_exp", "table_pack_grad"):
                moe_launches[k] = moe_launches.get(k, 0) + c[k]
        with phase("31"):
            add(dense_serving_path("deepseek-moe-16b", smi_line,
                                   n_layers=DEEPSEEK_SERVE_LAYERS, host_cost=True))
        with phase("32"):
            add(dense_train_path("deepseek-moe-16b", smi_line, per_layer,
                                 n_layers=MOE_TRAIN_LAYERS))
        with phase("33"):
            add(dense_serving_path("qwen3-moe-235b-a22b", smi_line, n_layers=QWEN_LAYERS,
                                   host_cost=True))
        with phase("34"):
            for arch in MOE_FAMILY:
                reference_check(arch)
        # 35-38: the recurrent families, through the pack kernels; their launches too
        recurrent_launches = {}

        def add_recurrent(c):
            for k in ("table_pack_lookup", "tableflash_exp", "table_pack_grad"):
                recurrent_launches[k] = recurrent_launches.get(k, 0) + c[k]
        with phase("35"):
            add_recurrent(dense_serving_path("zamba2-1.2b", smi_line, host_cost=True))
        with phase("36"):
            add_recurrent(dense_train_path("zamba2-1.2b", smi_line, per_layer))
        with phase("37"):
            add_recurrent(dense_serving_path("xlstm-125m", smi_line, host_cost=True))
            add_recurrent(dense_train_path("xlstm-125m", smi_line, per_layer,
                                           n_layers=XLSTM_TRAIN_LAYERS))
        with phase("38"):
            for arch in RECURRENT_FAMILY:
                reference_check(arch)
        # 39-41: the encoder-decoder and vision families; their launches too
        encdec_vlm_launches = {}

        def add_encdec_vlm(c):
            for k in ("table_pack_lookup", "tableflash_exp", "table_pack_grad"):
                encdec_vlm_launches[k] = encdec_vlm_launches.get(k, 0) + c[k]
        with phase("39"):
            add_encdec_vlm(dense_serving_path("whisper-small", smi_line, host_cost=True))
            add_encdec_vlm(dense_train_path("whisper-small", smi_line, per_layer))
        with phase("40"):
            add_encdec_vlm(dense_serving_path("internvl2-1b", smi_line, host_cost=True))
            add_encdec_vlm(dense_train_path("internvl2-1b", smi_line, per_layer))
        with phase("41"):
            for arch in ENCDEC_VLM_FAMILY:
                reference_check(arch)
        # 42: the device telemetry and the observability tools; its launches too
        with phase("42"):
            obs_launches = telemetry_phase(smi_line)
        # 43: the mesh path; its launches too
        with phase("43"):
            mesh_counts, mesh_ranks = mesh_phase(smi_line)
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for kname, replaces in (
            ("table_pack_lookup", "src/repro/kernels/table_pack_lookup.py:43"),
            ("tableflash_exp", "src/repro/kernels/table_pack_lookup.py:188"),
            ("table_pack_grad", "src/repro/kernels/table_pack_lookup.py:66"),
            ("table_lookup", "src/repro/kernels/table_lookup.py:66"),
            ("table_lookup_grad", "src/repro/kernels/table_grad.py:28"),
            ("quant_pack_lookup", "src/repro/kernels/table_pack_lookup.py:283"),
            ("quant_pack_grad", "src/repro/kernels/table_pack_lookup.py:309"),
            ("poly_pack_lookup", "src/repro/kernels/table_pack_lookup.py:503"),
            ("poly_pack_grad", "src/repro/kernels/table_pack_lookup.py:524"),
            ("routed_pack_lookup", "src/repro/kernels/routed_pack_lookup.py:101"),
            ("routed_pack_grad", "src/repro/kernels/routed_pack_lookup.py:126"),
            ("routed_quant_pack_lookup", "src/repro/kernels/routed_pack_lookup.py:300"),
            ("routed_quant_pack_grad", "src/repro/kernels/routed_pack_lookup.py:329"),
            ("folded_pack_lookup", "src/repro/kernels/table_pack_lookup.py:943"),
            ("folded_pack_grad", "src/repro/kernels/table_pack_lookup.py:953"),
            ("routed_poly_pack_lookup", "src/repro/kernels/routed_pack_lookup.py:641"),
            ("routed_poly_pack_grad", "src/repro/kernels/routed_pack_lookup.py:670"),
            ("sharded_pack_lookup", "src/repro/kernels/table_pack_lookup.py:663"),
            ("sharded_pack_grad", "src/repro/kernels/table_pack_lookup.py:697"),
            ("sharded_routed_pack_lookup", "src/repro/kernels/routed_pack_lookup.py:451"),
            ("sharded_routed_pack_grad", "src/repro/kernels/routed_pack_lookup.py:480")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/table_pack_lookup.cu",
            "replaces": replaces,
            "launches": counts[kname], "max_abs_err": worst[kname],
            **times[kname]})
        if kname in paper_launches:  # phases 29-30 drive these two again
            kernels[-1]["paper_launches"] = paper_launches[kname]
        if kname in moe_launches:  # and phases 31-33 these three
            kernels[-1]["moe_launches"] = moe_launches[kname]
        if kname in recurrent_launches:  # and phases 35-37
            kernels[-1]["recurrent_launches"] = recurrent_launches[kname]
        if kname in encdec_vlm_launches:  # and phases 39-40
            kernels[-1]["encdec_vlm_launches"] = encdec_vlm_launches[kname]
        if kname in obs_launches:  # and phase 42, with the telemetry on
            kernels[-1]["obs_launches"] = obs_launches[kname]
        if kname == "sharded_pack_lookup":  # and phase 43: the mesh path
            kernels[-1]["mesh_launches"] = mesh_counts[kname]
            kernels[-1]["mesh_rank_launches"] = {str(w): v for w, v in mesh_ranks.items()}
    log(f"phase seconds: {json.dumps(PHASE_S)}")
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
