#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

   1. device   — card name and power limit (nvidia-smi), torch/CUDA versions;
   2. build    — nvcc builds the twelve CUDA sources from
                 ``src/repro_torch`` (the eight kernels and the backwards of
                 flash, the two scans and the grouped matmul), one process
                 per source, all started together;
   3. kernels  — each kernel against its plain PyTorch version on the card,
                 bf16 and f32, with and without a window, at the shapes the
                 runs below give it: the paged kernels at phase 4's (H=14,
                 KV=2, D=64, block 16; decode B=16, prefill P=4, C=256 with a
                 filler row); flash at phase 6's Generator prefill (B=8,
                 S=1024) and with per-row q_offsets at phase 10's composed
                 prefill (P=4, C=256 over 64 x 16 gathered keys); dense
                 decode at phase 6's (B=8 over a 1096-entry cache, lengths
                 1025..1087), at phase 10's (8 seats over 1024 gathered
                 keys, one seat empty) and, as extra coverage, at B=16 over
                 1600 entries with lengths 100..1564; the dense kernels also
                 at llama3-8b's H=32, KV=8, D=128; the paged decode also
                 at phi4-mini's H=24, KV=8, D=128 (phase 4's seats and
                 table); and deepseek-v2-lite's
                 kernels at phase 12's shapes: the grouped matmul at a decode
                 step's 16 x 6 = 96 rows (some experts empty) and a prefill
                 call's 4 x 256 x 6 = 6144, for the w_gate/w_up (2048 ->
                 1408) and w_down (1408 -> 2048) stacks and with every row
                 in one expert; the MLA decode at 16 seats, block 16,
                 lengths 100..1532; flash at (Dk, Dv) = (192, 128) with
                 per-row offsets over 96 x 16 gathered keys; and mamba2-370m's
                 ssd_scan at phase 15's prefill call (4 rows x 256 with a
                 bf16 initial state, one row padded past its limit, a
                 filler row) and phase 17's Generator prefill (8 x 1024,
                 chunks of 256), and at S = 100, 1000, 1023 (chunks of 100,
                 8, 1); and recurrentgemma-2b's rglru_scan at phase 19's
                 prefill call (4 rows x 256 x 2560 with a bf16 initial
                 state, one row padded after 120 positions with a_gate = 0,
                 a filler row), at phase 21's Generator prefill (8 x 1024)
                 and at S = 1, 100, 1023, and the four attention kernels at
                 its (H, KV, D) = (10, 1, 256) with its window of 2048:
                 paged decode at 16 seats with lengths past the window and
                 the freed blocks null, ragged prefill with a row starting
                 past the window, dense decode over the Generator's 1096
                 entries, a full 2048-entry ring and the composed phase's
                 gathered keys, flash at 8 x 1024, at S = 3072 and with the
                 composed phase's per-row offsets; and the train step's:
                 flash with its lse output at phase 23's shape (B=4,
                 S=4096, (14, 2, 64)), at phase 26's (B=2, S=4096, (16,
                 16, 192/128)) and at phase 29's (B=2, 64 prefix + 4096
                 = 4160 positions, (32, 32, 64): the last 128-key tile
                 half full), flash's backward there, at (24, 8, 128),
                 S=2048, with and without a window, at the reduced MLA
                 pair (96, 64) and at phase 34's (1 x 4096, (10, 1, 256),
                 window 2048), against flash_attention_bwd_ref and, in
                 f32, autograd through the plain forward, each case
                 logging the backward's body (flash_bwd_body) and its
                 ptxas registers and spills; ssd_scan_bwd at phase 31's
                 shape (4 x 4096, H = 32, (64, 128), chunks of 256) and
                 rglru_scan_bwd at phase 34's (1 x 4096 x 2560), and both
                 at 2 x 1024 with an initial state and dfin, against their
                 plain versions, the SSD backward's log naming its body
                 (ssd_bwd_body), its kernels and their ptxas registers
                 and spills; the grouped matmul's backward (dx and dw, 6b)
                 at deepseek-v2-lite's train shape (2 x 4096 tokens, top-6:
                 49152 sorted rows, 2048 -> 1408) and at a decode step's
                 96 rows with empty experts, to the scan backwards' rule
                 with F32_TOL, an empty expert's dw exact zeros.  Each
                 kernel is timed in bf16 at its
                 main-path shape beside its plain version, a library
                 yardstick (SDPA; SDPA's backward; torch._grouped_mm, for
                 the backward's dx and dw too where this torch takes their
                 layouts; none for the two scans) and its bound;
   4. serve    — qwen2-0.5b at full width (24 layers, random weights from a
                 seed) in bf16 through HyperServe continuous batching; the
                 fused kernels must launch 24 times per decode step /
                 prefill call;
   5. profile  — torch.profiler over one prefill call and over steady
                 decode steps of the same server: device time by kernel
                 against wall time, and the device's idle share;
   6. dense    — the dense Generator (fixed-batch generation) on the same
                 model in bf16, 8 prompts x 1024 tokens, 64 greedy tokens:
                 exactly 24 flash_attention and 24 x 63 decode_attention
                 launches; generate's wall time, then a prefill and the
                 63 decode steps each timed alone between syncs;
   7. dense profile — torch.profiler over one Generator prefill and 8
                 decode steps;
   8. identity — HyperServe greedy tokens in float32 identical with the
                 kernels and with the plain versions (``ops.set_mode("ref")``);
   9. dense identity — float32 Generator tokens identical with the kernels
                 and the plain versions, with and without a 256-entry ring
                 cache, and identical to HyperServe's fused tokens;
  10. composed — HyperServe with ``kernels="composed"`` (gather, then the
                 dense kernels): tokens identical to the fused path's, 24
                 launches per decode step and per prefill call, no fused
                 launch;
  11. preempt  — a pool smaller than the working set preempts, spills and
                 restores, with tokens identical to an ample pool; then
                 through HyperMem's tiers (tier_runs): the same pool with
                 the host tier timed, with ``archive_host_bytes`` below
                 one spilled entry (every entry through the disk tier:
                 tokens identical, archive_evict_host >= 1 = mem.evict.host,
                 both tiers empty at the end, 24 paged decodes a step and
                 24 ragged prefills a call), each tier's spill and restore
                 wall per MB, and a 1-byte disk tier raising
                 MemCapacityError;
  12. moe serve — deepseek-v2-lite-16b (MLA + MoE, 27 layers, 64 routed
                 experts top-6, random weights from a seed) at full width
                 in bf16 through HyperServe: 16 requests of 100-1500 prompt
                 tokens, 32 new each; exactly 27 paged_mla_decode_attention
                 and 78 grouped_matmul launches per decode step, 27
                 flash_attention and 78 grouped_matmul per prefill call;
  13. moe profile — torch.profiler over one prefill call and 8 decode steps
                 of that server;
  14. moe identity — deepseek-v2-lite at full width, 4 layers, float32:
                 HyperServe greedy tokens identical with the kernels, the
                 plain versions and the composed lowering, and to the
                 Generator's; then phase 11 on it;
  15. ssm serve — mamba2-370m (Mamba-2 SSD, 48 layers, attention-free,
                 random weights from a seed) at full width in bf16 through
                 HyperServe (16 seats, prefill calls of 4 x 256): 16 requests
                 of 100-1500 prompt tokens, 64 new each; exactly 48 ssd_scan
                 launches per prefill call and none per decode step (the
                 decode recurrence is plain PyTorch, as in the reference);
                 no preemption and no block taken;
  16. ssm profile — torch.profiler over one prefill call and 8 decode steps
                 of that server;
  17. ssm Generator — the Generator on the same model, 8 x 1024 prompt
                 tokens, 64 new: exactly 48 ssd_scan launches (one prefill);
                 prefill and the decode loop each timed alone;
  18. ssm identity — mamba2-370m at full width, SSM_ID_LAYERS (16) of
                 its 48 layers, float32:
                 HyperServe greedy tokens identical with the kernel and the
                 plain versions, and to the Generator's; then forced
                 preemptions (forced_preemptions: a pure-slot model never
                 runs out of blocks) through the tiers as phase 11, one
                 ssd_scan launch a layer and prefill call;
  19. hybrid serve — recurrentgemma-2b (RG-LRU + LOCAL_ATTN, 26 layers: 18
                 RG-LRU and 8 local attention at head dim 256, 10 heads
                 over one kv head, window 2048; random weights from a seed)
                 at full width in bf16 through HyperServe (16 seats, prefill
                 calls of 4 x 256, 2048 blocks, a 194-block table): 16
                 requests of 100-3000 prompt tokens, four longer than the
                 window and a block, 64 new each; exactly 8
                 paged_decode_attention and no rglru_scan per decode step,
                 8 ragged_prefill_attention and 18 rglru_scan per prefill
                 call; blocks freed below the window, at most 129 live
                 blocks per running request;
  20. hybrid profile — torch.profiler over one prefill call and 8 decode
                 steps of that server;
  21. hybrid Generator — the Generator on the same model, 8 x 1024 prompt
                 tokens, 64 new: exactly 8 flash_attention and 18 rglru_scan
                 per prefill, 8 decode_attention per decode step;
  22. hybrid identity — recurrentgemma-2b at full width, RG_ID_LAYERS
                 (8) of its 26 layers (two LOCAL_ATTN), float32:
                 HyperServe greedy tokens identical with the
                 kernels, the plain versions and the composed lowering on 6
                 prompts of 100-2400 tokens (two past the window), to the
                 Generator's on prompts of at most the window (one exactly
                 it, so decode crosses it), and through a preemption that
                 spills and restores seat rows beside the pages, also
                 through the tiers as phase 11 (8 paged decodes a step, 8
                 ragged prefills and 18 rglru_scan a call);
  23. train    — qwen2-0.5b's train step at full width (all 24 layers,
                 random weights from a seed) in bf16 through
                 ``repro_torch.train.trainer.train``: 8 steps of 4 x 4096
                 tokens of the reference's synthetic corpus (its train_4k
                 with the global batch cut from 256 to 4); loss and grad
                 norm finite, exactly 48 flash_attention launches (24 and
                 24 remat) and 24 backward calls every step; step wall
                 time, train tok/s, peak device memory;
  24. train profile — torch.profiler over one train step;
  25. train identity — qwen2-0.5b at full width, all 24 layers, float32,
                 4 steps of 2 x 1024 with the kernels and with the plain
                 versions: losses and grad norms within 1e-4 relative, the
                 params within AdamW's bound;
  26. deepseek train — deepseek-v2-lite-16b's train step (MLA at (Dk, Dv)
                 = (192, 128) + GShard MoE, the reference's default
                 dispatch) at full width cut to 4 layers (the dense first
                 and three MoE layers, about 2.25 B params: 5 layers run
                 out of the card's memory) in bf16 through
                 ``trainer.train``: 8 steps of 2 x 4096 tokens; loss and
                 grad norm finite, exactly 8 flash_attention launches, 4
                 backward calls and no grouped_matmul a step; step wall,
                 tok/s, peak memory;
  27. deepseek train profile — torch.profiler over one such step;
  27a. deepseek ragged train — phase 26's run under the ragged dispatch
                 (``trainer.train(..., moe_dispatch="ragged")``, the path
                 of ``launch/train.py --moe-dispatch ragged``): the same 8
                 steps of 2 x 4096 tokens, 49152 expert rows a MoE layer;
                 exactly 8 flash forwards, 4 backwards, 18 grouped_matmul
                 (3 a MoE layer, its remat again) and 9 of each grouped
                 matmul backward kernel (dx, dw) a step; step wall, tok/s,
                 peak memory;
  27b. deepseek ragged train profile — torch.profiler over one such step,
                 with the grouped matmul backward's share (dx, dw) of the
                 step's device time;
  28. deepseek train identity — the same arch, 2 layers (dense + MoE),
                 float32, 4 steps of 1 x 1024, kernels against plain
                 versions, to phase 25's limits;
  29. musicgen train — musicgen-large at full width cut to 36 of its 48
                 layers, bf16, through ``make_train_step(multimodal=True)``:
                 8 steps of 2 x 4096 tokens after 64 seeded conditioning
                 frames of width 1024 (4160 positions, so flash's walks end
                 in a partial tile); loss and grad norm finite, exactly
                 72 forward and 36 backward flash calls and no
                 grouped_matmul a step; step wall, tok/s, peak memory;
  30. musicgen train identity — the same arch and prefix, 2 layers,
                 float32, 4 steps of 1 x (64 + 1024), kernels against plain
                 versions, to phase 25's limits;
  31. mamba2 train — mamba2-370m's train step at full width, all 48
                 layers, bf16, through ``trainer.train``: 8 steps of 4 x
                 4096 tokens (train_4k, its batch cut to 4 as qwen2's);
                 loss and grad norm finite, exactly 96 ssd_scan launches
                 (48 and 48 remat), 48 ssd_scan_bwd and no flash a step;
                 step wall, tok/s, peak memory;
  32. mamba2 train profile — torch.profiler over one such step: device
                 busy and idle share;
  33. mamba2 train identity — 2 layers, float32, 4 steps of 1 x 1024,
                 kernels against plain versions, to phase 25's limits;
  34. recurrentgemma train — recurrentgemma-2b's train step at full width,
                 all 26 layers (18 RG-LRU, 8 LOCAL_ATTN; no cut: its peak
                 fits at one row, train_depth.py), bf16: 8 steps of 1 x
                 4096 tokens, past the 2048 window; exactly 36
                 rglru_scan, 18 rglru_scan_bwd, 16 flash forward and 8
                 backward (at (256, 256), windowed) launches a step;
  35. recurrentgemma train profile — torch.profiler over one such step;
  36. recurrentgemma train identity — one group, float32, 4 steps of 1 x
                 2560 (past the window), kernels against plain versions, to
                 phase 25's limits;
  37. pool     — HyperOffload's KV pool (core/kvcache.KVCachePool) at
                 qwen2-0.5b's attention shapes, f32: 4 rows x 131072
                 tokens, a hot window of 8192 on the card, 60 blocks of
                 2048 (~503 MB) in pinned host memory; attend within 1e-4
                 of the decode_attention kernel over the flat cache, its
                 wall and host->card rate;
  38. train offload — phase 23's run for 4 steps without offload and
                 with params and optimizer state in host memory between
                 steps: loss and grad norm within a quarter bf16 step
                 (2^-8 / 4) relative of the run without (two of them:
                 the bf16 backward's dq atomics make runs differ), the
                 launch counts exact, the train.fetch / train.offload
                 spans, each leg's bytes and rate alone (a fetch, an
                 offload and a fetch again equal bit for bit), memory
                 allocated after an offload leg against without;
  38a. train mesh — HyperShard on the card: a one-rank NCCL process group
                 (file store in a temporary directory), ``make_host_mesh((1,
                 1))``, qwen2-0.5b under ``ShardingPlan()`` (fsdp_tp)
                 through ``trainer.train(mesh=, plan=)``: DTensor state and
                 batches, flash under ``local_map``.  The f32 identity at
                 phase 25's shapes against the run without a mesh (phase
                 25's limits, the distance printed), then 4 bf16 steps of
                 4 x 4096 with exactly 48 flash forwards and 24 backwards a
                 step, loss and grad norm within 2^-8 / 4 of phase 23's
                 first 4 steps, step wall, tok/s and peak beside phase
                 23's;
  38b. serve mesh — HyperServe on 38a's (1, 1) mesh (the same one-rank
                 group) under
                 ``ShardingPlan(fsdp=None)``: params and pool leaves
                 DTensors, the paged kernels and the scans under
                 ``local_map``.  qwen2-0.5b bf16, all 24 layers, phase 4's
                 config and 16 requests, exactly 24 paged decodes a decode
                 step and 24 ragged prefills a prefill call; decode tok/s,
                 median TTFT and the decode-step wall beside phase 4's;
                 torch.profiler over a prefill call and 8 decode steps.
                 Then f32 at full width, 32 new tokens, tokens identical
                 with and without the mesh and the mesh's launches exact:
                 qwen2-0.5b at MESH_QWEN_ID_LAYERS (phase 10's prompts,
                 and phase 11's preemption on the mesh against its ample
                 pool),
                 mamba2-370m at SSM_ID_LAYERS (one ``ssd_scan`` a layer and
                 prefill call, none a decode step), recurrentgemma-2b at
                 RG_ID_LAYERS (a paged decode a LOCAL_ATTN layer and no
                 ``rglru_scan`` a decode step, a ragged prefill or a scan a
                 layer and prefill call; two prompts past the window).  Last
                 the four serving kernels handed DTensors on the mesh: the
                 paged decode and ragged prefill at phase 4's shapes
                 (bf16), both scans at the identities' prefill calls (f32),
                 against their plain versions, timed;
  38c. deepseek mesh — MLA and MoE on the same (1, 1) mesh (the group is
                 destroyed after this phase): deepseek-v2-lite-16b bf16,
                 all 27 layers, one copy of its params, phase 13's config
                 and 16 requests, exactly 27 MLA decodes a decode step,
                 27 flash a prefill call and 3 x 26 = 78 grouped matmuls a
                 step and a call (the ragged MoE under ``local_map``);
                 decode tok/s, median TTFT, the decode-step wall and the
                 peak beside phase 13's, and a profile.  f32 at
                 DS_ID_LAYERS (4) layers: tokens identical with and
                 without the mesh, launches exact, then phase 11's
                 preemption on the mesh against its ample pool.  Then
                 deepseek-v2-lite cut to 4 layers, bf16, 4 steps of
                 2 x 4096 under fsdp_tp: gshard (8 flash forwards and 4
                 backwards a step, no grouped matmul) and ragged (18
                 grouped matmuls and 9 of each backward kernel a step),
                 each within 2^-8 / 4 of phases 26 and 27a's first 4 steps
                 (or twice a second run without the mesh's distance,
                 where that is larger: the dQ atomics),
                 wall, tok/s and peak beside theirs; the f32 identity at
                 phase 28's shape against no mesh.  Last the deepseek
                 path's kernels handed DTensors (the MLA decode, the
                 grouped matmul at decode and prefill rows, its backward's
                 dx and dw at the train rows, flash's forward and
                 backward at (192, 128)), against their plain versions,
                 timed;
  38d. recurrent mesh — SSD, RG-LRU, the multimodal prefix and the
                 composed lowering on the same (1, 1) mesh (the group is
                 destroyed after this phase).  bf16 fsdp_tp training, 4
                 steps each: mamba2-370m all 48 layers 4 x 4096 (exactly 96
                 ``ssd_scan`` and 48 ``ssd_scan_bwd`` a step, both scans'
                 backwards under ``local_map``), recurrentgemma-2b all 26
                 layers 1 x 4096 (36 scans, 18 scan backwards, 16 flash
                 and 8 flash backwards a step), musicgen-large at
                 MG_LAYERS with its 64 seeded prefix frames, 2 x (64 +
                 4096) (72 + 36 flash a step), each within 38c's rule of
                 phases 31, 34 and 29's first 4 steps, wall, tok/s and
                 peak beside theirs; the f32 identities against no mesh at
                 phases 32, 35 and 30's shapes.  qwen2-0.5b bf16 served
                 with ``kernels="composed"`` at phase 4's config and
                 requests (exactly 24 ``decode_attention`` a decode step
                 and 24 flash a prefill call, no fused kernel), decode
                 tok/s, TTFT and the decode-step wall beside phase 4's;
                 f32 tokens of the composed engine on the mesh identical
                 to the fused one without it for qwen2 at
                 MESH_QWEN_ID_LAYERS, recurrentgemma
                 at RG_ID_LAYERS (prompts past its window) and
                 deepseek-v2-lite at 4 layers (MLA composed), and
                 musicgen-large served
                 text-only on the mesh at MG_SERVE_LAYERS identical to no
                 mesh.  Last ``decode_attention`` (qwen2's composed
                 shapes; (10, 1, 256) windowed), both scans and both scan
                 backwards (the train shapes) handed DTensors, against
                 their plain versions, timed;
                 (Phases 39 and 40 run before 38a's one-rank group is
                 opened, and phase 43 inside it, after 38d.)
  39. rl       — HyperRL, colocated (repro_torch.rl.RLSession): qwen2-0.5b
                 at full width in bf16, 2 iterations of 2 prompts x 4
                 samples of 128 + 64 tokens at temperature 1 (the
                 launcher's diversity reward, lr 1e-5): weights_version 1
                 then 2; every engine step exactly 24 paged decodes a
                 decode step and 24 ragged prefills a prefill call, every
                 update 48 flash forwards and 24 backwards; iteration 1's
                 rollouts replayed bit for bit by a second session from the
                 same seed; rollout tok/s, the learner step's wall, the
                 publish wall, rl.stage_to_install_s, peak memory, and
                 torch.profiler over rollout decode steps (idle share);
  40. rl identity — the same in float32, one iteration: ratio_mean within
                 1e-3 of 1 and clip_fraction 0 (on policy), then a greedy
                 probe through the actor identical to a fresh Generator on
                 the learner's params; then a second update on the same
                 batch, for phase 43;
  41. rl moe   — deepseek-v2-lite-16b cut to 4 layers (phase 26's), ragged
                 actor and learner, bf16, one iteration of 1 x 4 samples of
                 64 + 32 tokens: per decode step 4 MLA decodes and 9
                 grouped matmuls, per prefill call 4 flash and 9, per
                 update 8 flash, 4 backwards, 18 grouped matmuls and 9 of
                 each grouped matmul backward kernel;
  41b. ragged train identity — deepseek-v2-lite at full width, 2 layers,
                 float32, 2 steps of 1 x 1024 under the ragged dispatch,
                 kernels against plain versions to phase 25's limits, both
                 backward kernels launched 3 times a MoE layer and step;
  42. disagg serve — HyperMPMD's prefill/decode disaggregation: a child
                 process on the same card (``--mpmd-child prefill``) is
                 the prefill group, this process the decode group, gloo
                 through a FileStore in a temporary directory (NCCL
                 refuses two ranks on one card), the hand-offs through
                 pinned host buffers.  qwen2-0.5b bf16 at phase 4's config
                 and requests: exactly 24 flash_attention a dense prefill
                 call in the child and nothing else, 24
                 paged_decode_attention a decode step here and no ragged
                 prefill; median TTFT, decode tok/s and the decode-step
                 wall beside phase 4's, the KV hand-off's ms and GB/s a
                 call; f32 at phase 10's config and prompts: tokens
                 identical to phase 10's aggregated engine and to the
                 Generator's; flash at the child's largest dense call
                 (Pb, padded) held to its plain version and timed.  A
                 child that fails fails the phase;
  43. rl mesh  — GRPO with the learner on 38a's one-rank NCCL (1, 1) mesh
                 under fsdp_tp: bf16 at phase 39's config with its exact
                 launches, the first update's ratio_mean within 1e-3 of 1
                 and clip_fraction 0, learner step and publish walls
                 beside phase 39's; f32 at phase 40's: iteration 1's
                 rollouts identical to phase 40's, the loss within 1e-5
                 relative, the greedy probe after the publish identical
                 to a fresh Generator's, the params after the update
                 within phase 25's limits of phase 40's, and a second
                 update on the same batch within 1e-5 relative of phase
                 40's second (loss, ratio_mean, grad_norm);
  44. rl disagg — ``rl_disagg`` with roles 1 + 1: this process the actor,
                 a child (``--mpmd-child learner``) the learner, as in
                 phase 42: f32 at phase 40's config, the rollouts, the
                 loss and every published param bit for bit phase 40's;
                 bf16 at phase 39's, 24 + 24 launches a decode step and
                 prefill call here and 48 + 24 an update in the child,
                 mpmd.tasks.actor and .learner exact on both, the publish
                 wall and GB/s, rollout tok/s, the learner step wall and
                 utilization_report() for both roles;
  45. pipeline — the 1F1B pipeline trainer colocated
                 (repro_torch.train.pipeline_trainer.train_pipeline):
                 qwen2-0.5b bf16 at full width, 2 stages of 12 layers, 4
                 micro-batches of 1 x 4096 (phase 23's batches from the
                 same seed), 8 steps: exactly 192 flash_attention and 96
                 flash_attention_bwd launches, 4 bubble slots and 8
                 hand-offs a step; step 1's loss and grad norm within
                 2^-8 / 4 relative of phase 23's, every step within
                 that or, only where a step is not, within twice phase
                 23's distance from a second non-pipelined run of the
                 same steps, made then; step wall,
                 tok/s and peak beside phase 23's, a profile of one
                 step; f32 at phase 25's
                 shapes (2 micro-batches of 1 x 1024, 4 steps, 8 of the
                 24 layers): the pipeline against ``trainer.train`` (phase
                 25's limits), and the sequential dispatch equal to 1F1B
                 bit for bit;
  46. pipeline mpmd — stage 1 in a child process on the same card
                 (``--mpmd-child pipeline``, gloo, the hand-offs through
                 pinned host memory), stage 0 here: f32 at phase 45's
                 identity config, the losses, grad norms and every merged
                 param bit for bit phase 45's colocated run; bf16 at
                 phase 45's config, 4 steps: exactly 96 + 48 flash
                 launches a step in each process, the same history on
                 both, the step wall beside phase 45's; the activation
                 (and cotangent) hand-off's and the tied ``embed`` sync's
                 ms and GB/s;
  47. result   — the nvidia-smi line, the kernel JSON line (twelve sources;
                 flash has a row for each run it is on: phase 6's (64, 64),
                 phase 12's (192, 128), phase 21's (256, 256), phase 23's
                 train shape with lse, phase 26's at (192, 128) and phase
                 29's at (32, 32, 64) over 4160 positions, each beside its
                 backward's at that shape, and the backward at
                 (24, 8, 128), 2 x 2048; ssd_scan
                 and rglru_scan one for their serving prefill calls and one
                 for their Generator prefill; the paged decode, ragged
                 prefill and dense decode a second row at (256, G = 10);
                 the grouped matmul one for each of its five cases, its
                 backward's dx and dw one each at the train shape with
                 phase 27a's launches; phase 23's two flash rows again
                 with phase 38a's launches, named ``_mesh``, and phase
                 38b's four ``_mesh`` rows with its runs' launches,
                 phase 38c's seven and phase 38d's six, phase 42's
                 flash row at its largest dense prefill call (Pb,
                 padded), checked and timed there, and phases 42-44's
                 repeats of phase 4's serving rows and phase 23's train
                 rows, named ``_disagg``, ``_rl_mesh`` and
                 ``_rl_disagg``; flash and its backward at phase 45's
                 micro-batch (1 x 4096, (14, 2, 64), lse), checked in
                 phase 3, with phase 45's launches, and again as
                 ``_pipeline_mpmd`` with both of phase 46's processes';
                 each with that run's launches), and
                 ``{"ok": true,
                 "device": {...}}`` as the last line.

Each phase prints its wall seconds.  It needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

SEED = 0
DEVICE = "cuda"
# serving shapes of the main path (ServeConfig below)
H, KV, D, BS = 14, 2, 64, 16
DEC_B, NUM_BLOCKS, TABLE_W = 16, 2048, 128
PRE_P, PRE_C = 4, 256
WINDOW = 256
SERVE_REQUESTS = 16                 # the serve phases' requests, at t=0
# the dense Generator run (bf16): B prompts of S tokens, NEW greedy tokens
# into a cache of S + NEW + 8 entries
GEN_B, GEN_S, GEN_NEW = 8, 1024, 64
GEN_CACHE = GEN_S + GEN_NEW + 8
# the float32 identity runs: HyperServe's seats and tables (the composed
# lowering gathers ID_TABLE_W * BS keys per row), the Generator's batch
ID_SLOTS, ID_TABLE_W = 8, 64
ID_B, ID_S = 4, 512
ID_NEW = 32
ID_PROMPT_MAX = 700
ROW_OFFSETS = (0, 256, 512, 768)    # composed prefill rows: whole chunks
MIX_CACHE = 1600                    # extra decode coverage: mixed lengths
LLAMA_H, LLAMA_KV, LLAMA_D = 32, 8, 128
# phi4-mini-3.8b's attention layout: the paged decode at the serving decode's
# seats and table, 3 query heads a kv head over 8 kv heads
PHI4_H, PHI4_KV, PHI4_D = 24, 8, 128
F32_TOL = 2e-5         # float32: the same sums in another order
# bfloat16: both the kernels and the plain versions compute in float32 and
# round once to bfloat16, so the kernel must be within one bfloat16 step of
# the plain version and within half a step (a correct rounding) of the
# plain version's float32 result on the same inputs; BF16_ABS covers the
# float32 differences (<= 1.1e-6 measured) where a step is smaller.
BF16_ABS = 4e-6
# the grouped matmul sums over D = 2048 (1408): its float32 sums differ from
# cuBLAS's by up to 1.335e-5 (this script's f32 parity on an H100 80GB
# HBM3 at 700 W), so its bf16 slack is the f32 limit
GM_ABS = F32_TOL
# the MLA decode kernel returns float32 from bfloat16 inputs; kernel and
# plain version both compute in float32
MLA_BF16_TOL = 1e-4
REPEATS = 30
SLEEP_CYCLES = 500_000  # ~0.3 ms of the card's clock: > a call's host time
# phase 38b's rows: a wrapper handed DTensors spends more host time a call
# (local_map, redistribution) than SLEEP_CYCLES covers
MESH_SLEEP_CYCLES = 5_000_000
PREEMPT_BLOCKS = 32
# deepseek-v2-lite-16b (MLA + MoE) served at full width in bf16: DS_REQUESTS
# prompts of DS_PROMPT tokens, DS_NEW greedy tokens each, through the
# serving shapes above (DEC_B seats, PRE_P x PRE_C prefill calls); the
# table covers the longest request
DS_ARCH = "deepseek-v2-lite-16b"
DS_REQUESTS, DS_NEW = 16, 32
DS_PROMPT = (100, 1500)
DS_TABLE_W = -(-(DS_PROMPT[1] + DS_NEW) // BS)        # 96 blocks
DS_NUM_BLOCKS = 2048
DS_ROW_OFFSETS = (0, 256, 768, 1280)   # its flash_rows prefill: whole chunks
# the float32 identity runs of deepseek-v2-lite: full width, cut depth (one
# dense layer and three MoE layers, about 9 GB)
DS_ID_LAYERS = 4
# mamba2-370m (Mamba-2 SSD, slot state) served at full width in bf16:
# SSM_REQUESTS prompts of SSM_PROMPT tokens, SSM_NEW greedy tokens each,
# DEC_B seats, PRE_P x PRE_C prefill calls; no pages are needed, so the pool
# keeps a token few blocks.  Its Generator runs GEN_B x GEN_S prompts.
SSM_ARCH = "mamba2-370m"
SSM_REQUESTS, SSM_NEW = 16, 64
# its float32 identity runs: full width, SSM_ID_LAYERS of the 48 layers
# (the depth cut keeps the script inside its time limit, PR 32)
SSM_ID_LAYERS = 16
SSM_PROMPT = (100, 1500)
SSM_NUM_BLOCKS = 64
# phase 3's ssd_scan at the prefill call: rows (start, limit) — a first
# chunk, a middle chunk of a long prompt, a final chunk padded past its
# limit (dt = 0 there) and a filler row (limit 0, the null seat's zeros)
SSM_ROWS = ((0, 900), (768, 1400), (1280, 1400), (0, 0))
SSM_EXTRA_S = (100, 1000, 1023)          # chunks of 100, 8 and 1
# the SSD scan's decays exp(cs_q - cs_k) are differences of running sums of
# dt * A that reach |cs| ~ 200 in a chunk of 256, so any float32 evaluation
# carries ~|cs| 2^-24 relative error in them, and two evaluations summing in
# different orders differ by about twice the plain version's own distance
# from a float64 evaluation: the float32 limit, and the bf16 slack, of each
# output tensor is SSM_REL x max(1, max |output|) + 2 x that distance
SSM_REL = 2e-5
# recurrentgemma-2b (RG-LRU + LOCAL_ATTN: 18 RG-LRU layers and 8 local
# attention layers at H=10, KV=1, D=256, window 2048) served at full width
# in bf16: RG_REQUESTS prompts of RG_PROMPT tokens (RG_LONG of them longer
# than the window and a block), RG_NEW greedy tokens each, DEC_B seats,
# PRE_P x PRE_C prefill calls, a table covering the longest request.  Its
# Generator runs GEN_B x GEN_S prompts.
RG_ARCH = "recurrentgemma-2b"
RG_REQUESTS, RG_NEW, RG_LONG = 16, 64, 4
RG_PROMPT = (100, 3000)
RG_TABLE_W = -(-3100 // BS)                    # 194 blocks
RG_NUM_BLOCKS = 2048
# phase 3's attention rows at the serving run's shapes: the ragged prefill's
# (start, limit) rows reach past the window (one starts above it), and the
# composed phase's rows and seats over RG_ID_TABLE_W x BS gathered keys
RG_PRE_ROWS = ((0, 900), (1792, 2900), (2304, 3000), (0, 0))
RG_ID_TABLE_W = 160                            # 2400 + 32 tokens, whole
RG_ROW_OFFSETS = (0, 1024, 1792, 2304)         # composed rows: whole chunks
RG_EXTRA_S = (1, 100, 1023)                    # rglru_scan at odd lengths
# the float32 identity runs: full width, RG_ID_LAYERS of the 26 layers
# ((RG-LRU, RG-LRU, LOCAL_ATTN) twice, then two RG-LRU: two windowed
# attention layers; the depth cut keeps the script inside its time limit,
# PR 32); RG_ID_PROMPT prompt lengths (two above the window) for the kernel, plain
# and composed runs, RG_GEN_PROMPTS (at most the window, one exactly it)
# for HyperServe against the Generator, whose ring seats a prompt right
# only when its length is at most the window or a multiple of it
RG_ID_LAYERS = 8
RG_ID_PROMPT = (100, 2400)
RG_GEN_PROMPTS = (2048, 1900, 700)
# the RG-LRU scan walks t in order and its plain version in a log-depth
# tree: their float32 carries differ by up to the float32 limit, which is
# also its bf16 slack
RG_ABS = F32_TOL
# qwen2-0.5b's train step on the card (phase 23, bf16, all 24 layers):
# TRAIN_B rows of TRAIN_S tokens, the reference's train_4k sequence length
# with its global batch of 256 cut to 4 (the one cut: the reference spreads
# 256 rows over a mesh's data axis, one card holds 4), TRAIN_STEPS steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4096, 8
# the f32 train identity (phase 25): kernels against plain versions on
# TRAIN_ID_B x TRAIN_ID_S tokens, TRAIN_ID_STEPS steps from one seed, all 24
# layers; losses and grad norms agree to TRAIN_ID_REL relative (the
# attention's f32 sums differ in order, ~1e-6 of a value, carried through
# 24 layers); the params' bound follows from AdamW (phase_train_identity)
TRAIN_ID_B, TRAIN_ID_S, TRAIN_ID_STEPS = 2, 1024, 4
TRAIN_ID_REL = 1e-4
# the 1F1B pipeline (phases 45-46): phase 23's PIPE_B x TRAIN_S batch in
# PIPE_MICRO micro-batches over PIPE_STAGES stages of 12 layers; its bf16
# run held to phase 23's within PIPE_REL (the dQ atomics, as phase 38a);
# its f32 identity at phase 25's shapes in PIPE_ID_MICRO micro-batches;
# phase 46 PIPE_MPMD_STEPS bf16 steps, each hand-off timed
# HANDOFF_REPEATS times.  The f32 identity (and phase 46's f32 run) at
# PIPE_ID_LAYERS of qwen2's 24 layers, 4 a stage: cut for time
PIPE_STAGES, PIPE_MICRO, PIPE_B = 2, 4, TRAIN_B
PIPE_REL = 2 ** -8 / 4
PIPE_ID_MICRO, PIPE_ID_LAYERS = 2, 8
PIPE_MPMD_STEPS = 4
HANDOFF_REPEATS = 5
# the flash backward also at the wider heads of phi4-mini, llama3-8b and
# granite, (H, KV, D) = (24, 8, 128), BWD_WIDE_B x BWD_WIDE_S, with and
# without a window
BWD_WIDE = (24, 8, 128)
BWD_WIDE_B, BWD_WIDE_S = 2, 2048
# deepseek-v2-lite-16b's train step (phase 26, bf16, MLA + GShard MoE): full
# width cut to DS_TRAIN_LAYERS layers, the dense first layer and three MoE
# layers, about 2.25 B params: AdamW keeps old and new params and the f32
# moments alive at once, about 22 bytes a param.  The deepest depth that
# trains on an 80 GB card: at 4 layers the peak is 59.21 GiB, and 5 layers
# run out of memory in their first step (train_depth.py on an H100 80GB
# HBM3).  DS_TRAIN_B x DS_TRAIN_S tokens (GShard groups of 512 tokens,
# capacity 60), the attention at (Dk, Dv) = (192, 128), G = 1 (BWD_MLA)
DS_TRAIN_LAYERS = 4
DS_TRAIN_B, DS_TRAIN_S, DS_TRAIN_STEPS = 2, 4096, 8
BWD_MLA = (16, 16, 192, 128)                   # (H, KV, Dk, Dv)
# the grouped matmul's backward (phase 3) at the rows phase 26's batch
# routes under the ragged dispatch: DS_TRAIN_B x DS_TRAIN_S tokens, top-6
GM_TRAIN_ROWS = DS_TRAIN_B * DS_TRAIN_S * 6
# the ragged train profile's shares of device time, by kernel name
GM_BWD_SHARES = {
    "grouped_matmul_bwd_dx": r"grouped_matmul_bf16_kernel<\d, true",
    "grouped_matmul_bwd_dw": r"grouped_matmul_dw_bf16_kernel",
    "grouped_matmul (forward)": r"grouped_matmul_bf16_kernel<\d, false"}
# phase 3 also holds the backward at the reduced config's pair (96, 64)
BWD_MLA_REDUCED = (16, 16, 96, 64)
BWD_MLA_REDUCED_B, BWD_MLA_REDUCED_S = 2, 1024
# its f32 identity (phase 28): DS_TRAIN_ID_LAYERS layers (dense + MoE),
# DS_TRAIN_ID_B x DS_TRAIN_ID_S tokens, DS_TRAIN_ID_STEPS steps
DS_TRAIN_ID_LAYERS, DS_TRAIN_ID_B, DS_TRAIN_ID_S = 2, 1, 1024
DS_TRAIN_ID_STEPS = 4
# musicgen-large's train step with its multimodal prefix (phase 29, bf16):
# full width cut to MG_LAYERS of its 48 layers (2.43 B params) by the same
# reckoning: 36 layers peak at 64.41 GiB and all 48 run out of memory
# (train_depth.py on an H100 80GB HBM3; depths between not measured).
# MG_B x MG_S tokens after num_prefix_tokens (64) seeded conditioning
# frames of frontend_dim (1024), so the attention sees 4160 positions
MG_ARCH = "musicgen-large"
MG_LAYERS = 36
MG_B, MG_S, MG_STEPS = 2, 4096, 8
# its f32 identity with the prefix (phase 30): MG_ID_LAYERS layers,
# MG_ID_B x (64 + MG_ID_S) positions, MG_ID_STEPS steps, phase 25's limits
MG_ID_LAYERS, MG_ID_B, MG_ID_S, MG_ID_STEPS = 2, 1, 1024, 4
# mamba2-370m's train step (phase 31, bf16, all 48 layers, attention-free):
# the reference's train_4k with its global batch cut to SSM_TRAIN_B, as
# qwen2's (phase 23); its f32 identity (phase 33): SSM_TRAIN_ID_LAYERS
# layers, SSM_TRAIN_ID_B x SSM_TRAIN_ID_S tokens, TRAIN_ID_STEPS steps
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = 4, 4096, 8
SSM_TRAIN_ID_LAYERS, SSM_TRAIN_ID_B, SSM_TRAIN_ID_S = 2, 1, 1024
# recurrentgemma-2b's train step (phase 34, bf16): full width, all 26
# layers (no cut; at 1 x 4096 the peak is 61.49 GiB, train_depth.py
# --batch 1 on an H100 80GB HBM3), RG_TRAIN_B x RG_TRAIN_S
# tokens (past the 2048 window, so that it cuts), RG_TRAIN_STEPS steps;
# its f32 identity (phase 36): one (RG-LRU, RG-LRU, LOCAL_ATTN) group,
# RG_TRAIN_ID_B x RG_TRAIN_ID_S tokens (past the window too)
RG_TRAIN_B, RG_TRAIN_S, RG_TRAIN_STEPS = 1, 4096, 8
RG_TRAIN_ID_LAYERS, RG_TRAIN_ID_B, RG_TRAIN_ID_S = 3, 1, 2560
RG_WINDOW = 2048
# HyperRL (phases 39-42), colocated on the card, the toy diversity reward
# of the reference's launcher: qwen2-0.5b at full width in bf16,
# RL_PROMPTS prompts x RL_GROUP samples (RL_PROMPTS x RL_GROUP seats) of
# RL_PROMPT_LEN tokens, RL_NEW new tokens at temperature 1, RL_ITERS
# iterations at lr RL_LR; its f32 identity (one iteration, then a greedy
# probe of RL_ID_PROMPT tokens, RL_ID_NEW new); deepseek-v2-lite-16b cut to
# DS_TRAIN_LAYERS layers, ragged on both sides, bf16, DS_RL_PROMPTS x
# DS_RL_GROUP samples of DS_RL_PROMPT_LEN tokens, DS_RL_NEW new, one
# iteration; and the ragged train identity (f32, full width,
# DS_RAGGED_ID_LAYERS layers, DS_RAGGED_ID_STEPS steps of 1 x
# DS_TRAIN_ID_S, kernels against plain versions, phase 25's limits)
RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW = 2, 4, 128, 64
RL_ITERS, RL_LR = 2, 1e-5
RL_ID_PROMPT, RL_ID_NEW = 64, 32
DS_RL_PROMPTS, DS_RL_GROUP, DS_RL_PROMPT_LEN, DS_RL_NEW = 1, 4, 64, 32
DS_RAGGED_ID_LAYERS, DS_RAGGED_ID_STEPS = 2, 2
RL_NUM_BLOCKS = 256
# phase 3's backward calls of the two scans beside the train shapes: an
# initial state and the final state's gradient, as a serving-sized call
# would hand them over (SCAN_BWD_B x SCAN_BWD_S)
SCAN_BWD_B, SCAN_BWD_S = 2, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, torch, repeats: int = REPEATS,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median device time of ``fn()`` in ms over ``repeats`` launches, each
    with a cold L2 (a 128 MB buffer is rewritten before every launch, as a
    serving step finds the previous layer's data evicted).  The launches
    are queued with no wait between them, and the card is held busy
    (``torch.cuda._sleep``, SLEEP_CYCLES) while the host enqueues each one,
    so the host's own time (a wrapper's checks, the launch call) is not
    counted even where it exceeds the flush, unless ``fn`` itself waits
    for the card (a plain version that reads sizes back)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()                                            # warm up
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    for t0, t1 in events:
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        t0.record()
        fn()
        t1.record()
    events[-1][1].synchronize()
    times = sorted(t0.elapsed_time(t1) for t0, t1 in events)
    return times[len(times) // 2]


def wall_us(fn, torch, calls: int = 50) -> float:
    """Host wall in microseconds a call of ``fn`` over ``calls`` calls
    queued back to back, between two syncs (after a warm-up call)."""
    fn()
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync(torch)
    return (time.perf_counter() - t0) / calls * 1e6


# ---------------------------------------------------------------------------
# kernel inputs at the serving shapes
# ---------------------------------------------------------------------------
def bf16_step(torch, x):
    """Spacing of the bfloat16 numbers (8 significant bits) at |x|."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def parity(torch, dtype_name, got, want, want32, slack=BF16_ABS):
    """(max abs error against the plain version, worst share of the
    allowed error; <= 1 passes).  A float32 result from bfloat16 inputs
    (the MLA decode kernel's) is held to MLA_BF16_TOL abs."""
    err = (got.float() - want.float()).abs()
    if dtype_name == "float32":
        return err.max().item(), err.max().item() / F32_TOL
    if got.dtype == torch.float32:
        return err.max().item(), err.max().item() / MLA_BF16_TOL
    step = bf16_step(torch, want)
    share = err / (step + slack)
    err32 = (got.float() - want32).abs()
    share32 = err32 / (0.5 * bf16_step(torch, want32) + slack)
    return err.max().item(), max(share.max().item(), share32.max().item())


def grad_parity(torch, dtype_name, got, want, want32):
    """The flash backward's rule: (max abs error against the plain
    version, worst share of the allowed error).  Its sums run over up to
    TRAIN_S keys, or G x TRAIN_S query rows, in another order, so the f32
    limit scales with the gradient, F32_TOL x max(1, max |grad|); in bf16
    that f32 limit is the slack beside one step of the plain version and
    half a step of its f32 result (the f32 rows print the differences it
    covers)."""
    lim = F32_TOL * max(1.0, want32.abs().max().item())
    err = (got.float() - want.float()).abs()
    if dtype_name == "float32":
        return err.max().item(), err.max().item() / lim
    share = err / (bf16_step(torch, want) + lim)
    err32 = (got.float() - want32).abs()
    share32 = err32 / (0.5 * bf16_step(torch, want32) + lim)
    return err.max().item(), max(share.max().item(), share32.max().item())


def decode_inputs(torch, dtype, device, heads=H, kv=KV, dim=D):
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # mixed lengths: prompts of 100..1500 plus up to 64 generated tokens;
    # most end in a partial page, one fills its last page exactly
    lengths = torch.randint(100, 1565, (DEC_B,), generator=g)
    lengths[0] = 16 * 40
    perm = torch.randperm(NUM_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(DEC_B, TABLE_W, dtype=torch.int32)
    used = 0
    for b in range(DEC_B):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn(DEC_B, 1, heads, dim, generator=g)
    k_pool = torch.randn(NUM_BLOCKS, BS, kv, dim, generator=g)
    v_pool = torch.randn(NUM_BLOCKS, BS, kv, dim, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to),
            lengths.to(torch.int32).to(**to))


def prefill_inputs(torch, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # rows: a first chunk, a middle chunk of a long prompt, a final partial
    # chunk (limit inside the chunk), and one filler row (limit 0)
    starts = torch.tensor([0, 768, 1280, 0], dtype=torch.int32)
    limits = torch.tensor([900, 1400, 1400, 0], dtype=torch.int32)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(PRE_P, TABLE_W, dtype=torch.int32)
    used = 0
    for p in range(PRE_P):
        n = -(-int(limits[p]) // BS)
        tables[p, :n] = perm[used:used + n]
        used += n
    q = torch.randn(PRE_P, PRE_C, H, D, generator=g)
    k_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    v_pool = torch.randn(NUM_BLOCKS, BS, KV, D, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k_pool.to(dtype=dtype, **to),
            v_pool.to(dtype=dtype, **to), tables.to(**to), starts.to(**to),
            limits.to(**to))


def dense_decode_inputs(torch, dtype, device, heads, kv, dim, batch, cache,
                        lengths, seed):
    """Dense decode: ``batch`` rows of a ``cache``-entry cache, each row's
    length drawn from the range ``lengths``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(lengths[0], lengths[1] + 1, (batch,), generator=g)
    q = torch.randn(batch, 1, heads, dim, generator=g)
    k = torch.randn(batch, cache, kv, dim, generator=g)
    v = torch.randn(batch, cache, kv, dim, generator=g)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            lengths.to(device, torch.int32))


def flash_inputs(torch, dtype, device, heads, kv, dim, batch, sq, sk):
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    return tuple(torch.randn(batch, s, n, dim, generator=g).to(device, dtype)
                 for s, n in ((sq, heads), (sk, kv), (sk, kv)))


def sdpa_decode(torch, q, k_pool, v_pool, tables, lengths):
    """Yardstick: one SDPA call over K/V gathered densely beforehand (the
    gather and the GQA head expansion are outside the call)."""
    B = q.shape[0]
    npg = -(-int(lengths.max()) // BS)
    S = npg * BS
    idx = tables[:, :npg].long()
    k = k_pool[idx].reshape(B, S, KV, D)
    v = v_pool[idx].reshape(B, S, KV, D)
    return sdpa_dense_decode(torch, q, k, v, lengths)


def sdpa_dense_decode(torch, q, k, v, lengths):
    """Yardstick: one SDPA call with a length mask (the GQA head expansion
    and the layout change are outside the call)."""
    import torch.nn.functional as F
    S, G = k.shape[1], q.shape[2] // k.shape[2]
    k = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                       # (B, H, 1, D)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def sdpa_prefill(torch, q, k_pool, v_pool, tables, starts, limits):
    import torch.nn.functional as F
    P, C = q.shape[:2]
    npg = -(-int((starts + C).max()) // BS)
    S = npg * BS
    idx = tables[:, :npg].long()
    k = k_pool[idx].reshape(P, S, KV, D).repeat_interleave(H // KV, 2)
    v = v_pool[idx].reshape(P, S, KV, D).repeat_interleave(H // KV, 2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                       # (P, H, C, D)
    qp = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qp[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def window_mask(torch, S, window, device):
    """(S, S) boolean mask of causal attention under a window: query i
    sees keys i - window < j <= i."""
    pos = torch.arange(S, device=device)
    return (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                             < window)


def sdpa_flash(torch, q, k, v, window=None):
    """Yardstick: one causal GQA SDPA call on the (B, H, S, D) layout (the
    transposes, and with a window its boolean mask, are outside the
    call)."""
    import torch.nn.functional as F
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is not None:
        mask = window_mask(torch, q.shape[1], window, q.device)
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)


def sdpa_flash_bwd(torch, q, k, v, o, lse, do, window=None):
    """Yardstick of the flash backward: (autograd.grad through one causal
    GQA SDPA call, that SDPA call alone); its backward's time is the first
    less the second.  The (B, H, S, D) transposes, and with a window its
    boolean mask, are outside the calls."""
    import torch.nn.functional as F
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    mask = (None if window is None
            else window_mask(torch, q.shape[1], window, q.device))

    def fwd():
        if mask is not None:
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    return (lambda: torch.autograd.grad(fwd(), (qh, kh, vh), doh)), fwd


def sdpa_flash_rows(torch, q, k, v, q_offset, scale):
    """Yardstick: one SDPA call with a boolean mask for per-row offsets
    (row b's query i sees the keys up to q_offset[b] + i; the transposes
    and the mask are outside the call)."""
    import torch.nn.functional as F
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = q_offset[:, None] + torch.arange(q.shape[1], device=q.device)
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]                   # (B, 1, Sq, Sk)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  scale=scale)


def gm_inputs(torch, dtype, cfg, rows, d_in, d_out, seed, one_expert=False):
    """``rows`` expert-sorted rows, an (E, d_in, d_out) expert stack at the
    model's init scale and the group sizes: each of rows / top_k tokens
    routed to top_k distinct experts drawn uniformly (at decode sizes some
    experts get none), or every row in one expert."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    if one_expert:
        sizes = torch.zeros(E, dtype=torch.int32, device=DEVICE)
        sizes[E // 2] = rows
    else:
        picks = torch.rand(rows // k, E, generator=g, device=DEVICE).topk(
            k, dim=-1).indices
        sizes = torch.bincount(picks.reshape(-1), minlength=E).to(torch.int32)
    scale = (2.0 / (cfg.d_model + cfg.moe.d_ff_expert)) ** 0.5
    x = torch.randn(rows, d_in, generator=g, device=DEVICE)
    w = torch.randn(E, d_in, d_out, generator=g, device=DEVICE) * scale
    return x.to(dtype), w.to(dtype), sizes


def mla_inputs(torch, dtype, cfg):
    """The absorbed MLA decode of the deepseek serving run: DEC_B seats,
    lengths of DS_PROMPT prompts plus up to DS_NEW tokens, block BS."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    m, H = cfg.mla, cfg.num_heads
    lengths = torch.randint(DS_PROMPT[0], DS_PROMPT[1] + DS_NEW + 1, (DEC_B,),
                            generator=g)
    perm = torch.randperm(DS_NUM_BLOCKS - 1, generator=g) + 1
    tables = torch.zeros(DEC_B, DS_TABLE_W, dtype=torch.int32)
    used = 0
    for b in range(DEC_B):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[used:used + n]
        used += n
    R, r = m.kv_lora_rank, m.qk_rope_head_dim
    arrays = [torch.randn(*s, generator=g) for s in
              ((DEC_B, H, R), (DEC_B, H, r), (DS_NUM_BLOCKS, BS, R),
               (DS_NUM_BLOCKS, BS, r))]
    return ([a.to(DEVICE, dtype) for a in arrays]
            + [tables.to(DEVICE), lengths.to(DEVICE, torch.int32)])


def mla_scale(cfg) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def flash_mla_inputs(torch, dtype, cfg):
    """The deepseek prefill call's flash_rows: PRE_P rows of PRE_C queries
    over DS_TABLE_W * BS gathered, decompressed keys, (Dk, Dv) = (nope +
    rope, v_head_dim)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    m, H = cfg.mla, cfg.num_heads
    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    S = DS_TABLE_W * BS
    return tuple(torch.randn(*s, generator=g).to(DEVICE, dtype) for s in
                 ((PRE_P, PRE_C, H, dk), (PRE_P, S, H, dk),
                  (PRE_P, S, H, m.v_head_dim)))


def ssd_inputs(torch, dtype, cfg, rows, S, seed, serving):
    """ssd_scan's inputs as the SSD layer hands them over: x, B and C
    column slices of one (rows, S, d_inner + 2N) tensor at the reference
    kernel test's 0.3 scale, dt = softplus(N(0, 1)) in float32, A =
    -exp(0.3 N(0, 1)).  ``serving``: SSM_ROWS' (start, limit) zero dt past
    each row's limit and a bf16 initial state per row (zeros for the
    filler row, as the null seat holds).  Returns (args, kwargs)."""
    import torch.nn.functional as F
    from repro_torch.models.mamba2 import _chunk
    s = cfg.ssm
    di, H = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)
    P, N = s.head_dim, s.d_state
    g = torch.Generator(device="cpu").manual_seed(seed)
    xbc = (torch.randn(rows, S, di + 2 * N, generator=g) * 0.3).to(
        DEVICE, dtype)
    x = xbc[..., :di].reshape(rows, S, H, P)
    dt = F.softplus(torch.randn(rows, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    init = None
    if serving:
        starts = torch.tensor([r[0] for r in SSM_ROWS])
        limits = torch.tensor([r[1] for r in SSM_ROWS])
        pos = starts[:, None] + torch.arange(S)[None, :]
        dt = dt * (pos < limits[:, None])[..., None]
        init = torch.randn(rows, H, P, N, generator=g)
        init[limits == 0] = 0.0
        init = init.to(DEVICE, dtype)
    args = (x, dt.to(DEVICE), A.to(DEVICE), xbc[..., di:di + N],
            xbc[..., di + N:])
    return args, dict(chunk=_chunk(s.chunk_size, S), init_state=init)


def ssd_cases(torch, dtype):
    """(case, args, kwargs) of ssd_scan at the mamba2-370m runs' shapes:
    phase 15's prefill call and phase 17's Generator prefill, then the
    extra sequence lengths."""
    from repro_torch.configs.base import get_config
    cfg = get_config(SSM_ARCH)
    cases = [("serving prefill",) + ssd_inputs(torch, dtype, cfg, PRE_P,
                                               PRE_C, SEED + 20, True),
             ("Generator prefill",) + ssd_inputs(torch, dtype, cfg, GEN_B,
                                                 GEN_S, SEED + 21, False)]
    cases += [(f"S={S}",) + ssd_inputs(torch, dtype, cfg, 2, S, SEED + 22 + i,
                                       False)
              for i, S in enumerate(SSM_EXTRA_S)]
    cases.append(("train",) + ssd_inputs(torch, dtype, cfg, SSM_TRAIN_B,
                                         SSM_TRAIN_S, SEED + 64, False))
    return cases


def ssd_parity(torch, dtype_name, got, want, want32, want64):
    """parity() for one ssd_scan output with SSM_REL's limit; ``want64``
    the plain version computed in float64 on the same inputs."""
    own = (want32.double() - want64).abs().max().item()
    tol = SSM_REL * max(1.0, want32.abs().max().item()) + 2 * own
    if dtype_name == "float32":
        err = (got - want).abs().max().item()
        return err, err / tol
    return parity(torch, dtype_name, got, want, want32, slack=tol)


def rg_scan_inputs(torch, dtype, W, rows, S, seed, serving):
    """rglru_scan's inputs as the RG-LRU layer hands them over: x (the conv
    output) at 0.5 N(0, 1), the gates sigmoid(N(0, 1)), log_a =
    -softplus(-lambda) over the layer's linspace(2, 6).  ``serving``:
    SSM_ROWS' (start, limit) zero a_gate past each row's limit and give
    each row an initial state in ``dtype``, the pool's (zeros for the
    filler row, as the null seat holds).  Returns (args, kwargs)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(rows, S, W, generator=g) * 0.5
    ig = torch.sigmoid(torch.randn(rows, S, W, generator=g))
    ag = torch.sigmoid(torch.randn(rows, S, W, generator=g))
    la = -F.softplus(-torch.linspace(2.0, 6.0, W))
    init = None
    if serving:
        starts = torch.tensor([r[0] for r in SSM_ROWS])
        limits = torch.tensor([r[1] for r in SSM_ROWS])
        pos = starts[:, None] + torch.arange(S)[None, :]
        ag = ag * (pos < limits[:, None])[..., None]
        init = torch.randn(rows, W, generator=g)
        init[limits == 0] = 0.0
        init = init.to(DEVICE, dtype)
    args = [t.to(DEVICE, dtype) for t in (x, ig, ag)] + [la.to(DEVICE)]
    return args, dict(init_state=init)


def rg_tables(torch, g, limits, blocks, window):
    """Block tables of rows with ``limits`` tokens, each block drawn once
    from ``blocks``, and the entries wholly below the window of the row's
    last query set to the null block, as the scheduler frees them."""
    perm = torch.randperm(blocks - 1, generator=g) + 1
    tables = torch.zeros(len(limits), RG_TABLE_W, dtype=torch.int32)
    used = 0
    for r, n in enumerate(limits):
        nb = -(-int(n) // BS)
        freed = max(0, int(n) - window) // BS
        tables[r, freed:nb] = perm[used:used + nb - freed]
        used += nb - freed
    return tables


def rg_cases(torch, dtype):
    """(kernel, case, window, wrapper, plain version, args, kwargs) for
    recurrentgemma-2b's kernels at the shapes its runs give them:
    rglru_scan at the hybrid serve phase's prefill call (PRE_P x PRE_C, a
    bf16 initial state, one row padded after 120 positions, a filler row),
    at the hybrid Generator's prefill (GEN_B x GEN_S) and at odd lengths;
    the attention kernels at (H, KV, D) = (10, 1, 256) with the window:
    paged decode at DEC_B seats (lengths up to RG_PROMPT[1] + RG_NEW, the
    freed blocks null), ragged prefill over RG_PRE_ROWS, dense decode at
    the Generator's cache (GEN_CACHE entries), over a full ring of the
    window and at the composed phase's gathered keys, flash at the
    Generator's prefill, at S = 3072 (past the window) and with the
    composed phase's per-row offsets."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.ragged_prefill_attention import (
        ragged_prefill_attention, ragged_prefill_attention_ref)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
    cfg = get_config(RG_ARCH)
    W, win = cfg.rglru.lru_width, cfg.sliding_window
    hd = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    cases = [("rglru_scan", "serving prefill", None, rglru_scan,
              rglru_scan_ref) + rg_scan_inputs(torch, dtype, W, PRE_P, PRE_C,
                                               SEED + 30, True),
             ("rglru_scan", "Generator prefill", None, rglru_scan,
              rglru_scan_ref) + rg_scan_inputs(torch, dtype, W, GEN_B, GEN_S,
                                               SEED + 31, False)]
    cases += [("rglru_scan", f"S={S}", None, rglru_scan, rglru_scan_ref)
              + rg_scan_inputs(torch, dtype, W, 2, S, SEED + 32 + i, False)
              for i, S in enumerate(RG_EXTRA_S)]
    cases.append(("rglru_scan", "train", None, rglru_scan, rglru_scan_ref)
                 + rg_scan_inputs(torch, dtype, W, RG_TRAIN_B, RG_TRAIN_S,
                                  SEED + 65, False))
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    nb = RG_NUM_BLOCKS * 2

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(DEVICE, dtype)
    Hq, KVh, Dh = hd
    k_pool, v_pool = rnd(nb, BS, KVh, Dh), rnd(nb, BS, KVh, Dh)
    top = RG_PROMPT[1] + RG_NEW
    lengths = torch.randint(RG_PROMPT[0], top + 1, (DEC_B,), generator=g)
    lengths[:RG_LONG] = torch.tensor([win + 1, win + BS, (win + top) // 2,
                                      top])[:RG_LONG]
    tables = rg_tables(torch, g, lengths.tolist(), nb, win)
    dec = (rnd(DEC_B, 1, Hq, Dh), k_pool, v_pool, tables.to(DEVICE),
           lengths.to(DEVICE, torch.int32))
    starts = torch.tensor([r[0] for r in RG_PRE_ROWS], dtype=torch.int32)
    limits = torch.tensor([r[1] for r in RG_PRE_ROWS], dtype=torch.int32)
    ptab = rg_tables(torch, g, [min(lim, st + PRE_C) for st, lim in
                                RG_PRE_ROWS], nb, win + PRE_C)
    pre = (rnd(PRE_P, PRE_C, Hq, Dh), k_pool, v_pool, ptab.to(DEVICE),
           starts.to(DEVICE), limits.to(DEVICE))
    kw = dict(block_size=BS, window=win)
    cases += [("paged_decode_attention", "recurrentgemma serving", win,
               paged_decode_attention, paged_decode_attention_ref, dec, kw),
              ("ragged_prefill_attention", "recurrentgemma serving", win,
               ragged_prefill_attention, ragged_prefill_attention_ref, pre,
               kw)]
    shape = (torch, dtype, DEVICE, Hq, KVh, Dh)
    gdec = dense_decode_inputs(*shape, GEN_B, GEN_CACHE,
                               (GEN_S + 1, GEN_S + GEN_NEW - 1), SEED + 41)
    ring = dense_decode_inputs(*shape, 4, win, (win, win), SEED + 42)
    cdec = dense_decode_inputs(*shape, ID_SLOTS, RG_ID_TABLE_W * BS,
                               (RG_ID_PROMPT[0] + 1, RG_ID_PROMPT[1] + ID_NEW),
                               SEED + 43)
    cdec[3][-1] = 1                 # an empty seat decodes at position 0
    cases += [("decode_attention", case, window, decode_attention,
               decode_attention_ref, args, dict(window=window))
              for case, window, args in (
                  ("recurrentgemma Generator", None, gdec),
                  ("recurrentgemma ring", None, ring),
                  ("recurrentgemma composed", win, cdec))]
    offsets = torch.tensor(RG_ROW_OFFSETS, dtype=torch.int32, device=DEVICE)
    cases += [("flash_attention", case, window, flash_attention,
               flash_attention_ref, flash_inputs(*shape, b, sq, sk), fkw)
              for case, window, b, sq, sk, fkw in (
                  ("recurrentgemma Generator prefill", win, GEN_B, GEN_S,
                   GEN_S, dict(causal=True, window=win)),
                  ("recurrentgemma S=3072", win, 2, 3072, 3072,
                   dict(causal=True, window=win)),
                  ("recurrentgemma composed rows", win, PRE_P, PRE_C,
                   RG_ID_TABLE_W * BS, dict(causal=True, window=win,
                                             q_offset=offsets)))]
    return cases


def sdpa_masked(torch, q, k, v, mask):
    """Yardstick: one SDPA call of q (B, Sq, H, D) over k, v (B, Sk, KV,
    D) under a boolean mask (B, Sq, Sk) (the GQA head expansion, the layout
    change and the mask are outside the call)."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    kh, vh = (t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
              for t in (k, v))
    qh = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask[:, None])


def rg_decode_mask(torch, lengths, S, window):
    pos = torch.arange(S, device=lengths.device)[None, :]
    lens = lengths.long()[:, None]
    mask = (pos < lens) & (pos >= lens - window if window else True)
    return mask[:, None, :]


def rg_table(torch, pm, timed):
    """Timing rows of recurrentgemma-2b's kernels at the hybrid runs'
    shapes, each with the path its launches are read from: (kernel, case,
    visible-work cost, yardstick, what it is, TPU kernel replaced, path).
    No PyTorch call computes the RG-LRU recurrence, so it has no
    yardstick; the attention rows have SDPA with the window's mask."""
    from repro_torch.configs.base import get_config
    cfg = get_config(RG_ARCH)
    win = cfg.sliding_window
    shape = dict(num_heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                 head_dim=cfg.resolved_head_dim, itemsize=2)
    rows = []
    for case, path in (("serving prefill", RG_ARCH),
                       ("Generator prefill", f"{RG_ARCH} Generator")):
        x = timed[("rglru_scan", case)][2][0]
        init = timed[("rglru_scan", case)][3]["init_state"]
        rows.append(("rglru_scan", case, pm.rglru_scan_cost(
            batch=x.shape[0], seq=x.shape[1], width=x.shape[2], itemsize=2,
            init_state=init is not None), None,
            "library call: none (no PyTorch call computes the RG-LRU "
            "recurrence)", "src/repro/kernels/rglru_scan.py:66", path))
    q, k_pool, v_pool, tables, lengths = timed[
        ("paged_decode_attention", "recurrentgemma serving")][2]
    S = RG_TABLE_W * BS
    kd, vd = (pool[tables.long()].reshape(DEC_B, S, *pool.shape[2:])
              for pool in (k_pool, v_pool))
    rows.append(("paged_decode_attention", "recurrentgemma serving",
                 pm.decode_visible_cost(lengths.tolist(), window=win,
                                        **shape),
                 sdpa_masked(torch, q, kd, vd, rg_decode_mask(
                     torch, lengths, S, win)),
                 "SDPA on pre-gathered K/V, window mask (gather excluded)",
                 "src/repro/kernels/paged_decode_attention.py:91", RG_ARCH))
    q, k_pool, v_pool, tables, starts, limits = timed[
        ("ragged_prefill_attention", "recurrentgemma serving")][2]
    kd, vd = (pool[tables.long()].reshape(PRE_P, S, *pool.shape[2:])
              for pool in (k_pool, v_pool))
    qp = starts.long()[:, None] + torch.arange(PRE_C, device=q.device)
    kp = torch.arange(S, device=q.device)[None, None, :]
    mask = (kp <= qp[:, :, None]) & (qp[:, :, None] - kp < win)
    rows.append(("ragged_prefill_attention", "recurrentgemma serving",
                 pm.prefill_visible_cost(starts.tolist(), limits.tolist(),
                                         PRE_C, window=win, **shape),
                 sdpa_masked(torch, q, kd, vd, mask),
                 "SDPA on pre-gathered K/V, causal window mask (gather "
                 "excluded)",
                 "src/repro/kernels/ragged_prefill_attention.py:89", RG_ARCH))
    q, k, v = timed[("flash_attention", "recurrentgemma Generator prefill")][2]
    qp = torch.arange(GEN_S, device=q.device)
    mask = ((qp[None, :] <= qp[:, None]) & (qp[:, None] - qp[None, :] < win))
    rows.append(("flash_attention", "recurrentgemma Generator prefill",
                 pm.prefill_visible_cost([0] * GEN_B, [GEN_S] * GEN_B, GEN_S,
                                         window=win, **shape),
                 sdpa_masked(torch, q, k, v, mask.expand(GEN_B, -1, -1)),
                 "SDPA with a causal window mask (head expansion excluded)",
                 "src/repro/kernels/flash_attention.py:87",
                 f"{RG_ARCH} Generator"))
    q, k, v, lengths = timed[("decode_attention",
                              "recurrentgemma Generator")][2]
    rows.append(("decode_attention", "recurrentgemma Generator",
                 pm.decode_visible_cost(lengths.tolist(), **shape),
                 sdpa_masked(torch, q, k, v, rg_decode_mask(
                     torch, lengths, k.shape[1], None)),
                 "SDPA with a length mask (head expansion excluded)",
                 "src/repro/kernels/decode_attention.py:67",
                 f"{RG_ARCH} Generator"))
    return tuple(rows)


def grouped_mm_yardstick(torch, x, w, sizes):
    """Yardstick: one torch._grouped_mm call where this torch has it (bf16),
    else None."""
    if not hasattr(torch, "_grouped_mm") or x.dtype != torch.bfloat16:
        return None
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    return lambda: torch._grouped_mm(x, w, offs=offs)


def sdpa_mla(torch, q_lat, q_rope, ckv_pool, krope_pool, tables, lengths,
             scale):
    """Yardstick: one SDPA call of the H heads over one shared key head,
    the gathered latents with their rope dims concatenated, values the
    latents, with a length mask (the gather and the concatenations are
    outside the call)."""
    import torch.nn.functional as F
    B = q_lat.shape[0]
    npg = -(-int(lengths.max()) // BS)
    S = npg * BS
    idx = tables[:, :npg].long()
    ckv = ckv_pool[idx].reshape(B, 1, S, ckv_pool.shape[-1])
    kr = krope_pool[idx].reshape(B, 1, S, krope_pool.shape[-1])
    k = torch.cat([ckv, kr], dim=-1)
    q = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]      # (B, H, 1, R + r)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q, k, ckv, attn_mask=mask, scale=scale, enable_gqa=True)


def moe_mla_cases(torch, dtype):
    """(kernel, case, window, wrapper, plain version, args, kwargs) for the
    deepseek-v2-lite path's kernels at the shapes its runs give them: the
    grouped matmul at a decode step's DEC_B x top_k rows and a prefill
    call's PRE_P x PRE_C x top_k, for the w_gate/w_up and the w_down
    shapes, and with every row in one expert; the MLA decode at the serving
    run's seats; flash at its prefill's (Dk, Dv) and per-row offsets."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    from repro_torch.kernels.paged_decode_attention import (
        paged_mla_decode_attention, paged_mla_decode_attention_ref)
    cfg = get_config(DS_ARCH)
    D, F, k = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.top_k
    dec, pre = DEC_B * k, PRE_P * PRE_C * k
    cases = [("grouped_matmul", case, None, grouped_matmul,
              grouped_matmul_ref,
              gm_inputs(torch, dtype, cfg, rows, d_in, d_out, SEED + 10 + i,
                        one), {})
             for i, (case, rows, d_in, d_out, one) in enumerate((
                 ("decode w_gate/w_up", dec, D, F, False),
                 ("decode w_down", dec, F, D, False),
                 ("prefill w_gate/w_up", pre, D, F, False),
                 ("prefill w_down", pre, F, D, False),
                 ("prefill, one expert", pre, D, F, True)))]
    cases.append(("paged_mla_decode_attention", "serving", None,
                  paged_mla_decode_attention, paged_mla_decode_attention_ref,
                  mla_inputs(torch, dtype, cfg),
                  dict(block_size=BS, scale=mla_scale(cfg))))
    offsets = torch.tensor(DS_ROW_OFFSETS, dtype=torch.int32, device=DEVICE)
    cases.append(("flash_attention", "MLA rows q_offset (192, 128)", None,
                  flash_attention, flash_attention_ref,
                  flash_mla_inputs(torch, dtype, cfg),
                  dict(causal=True, q_offset=offsets, scale=mla_scale(cfg))))
    return cases


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


# each source's ptxas report from phase 2: {source: [(instantiation,
# registers, spill-store bytes)]}
PTXAS = {}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["paged_decode_attention", "ragged_prefill_attention",
                        "flash_attention", "decode_attention",
                        "paged_mla_decode_attention", "grouped_matmul",
                        "ssd_scan", "rglru_scan", "flash_attention_bwd",
                        "ssd_scan_bwd", "rglru_scan_bwd",
                        "grouped_matmul_bwd"])
    log(f"[build] {time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
    for name, text in logs.items():
        log(f"[build] {name}: {text.splitlines()[0]}")
        PTXAS[name] = ptxas_report(text)
        for fn, regs, spill in PTXAS[name]:
            log(f"[build] {name}: {fn}: {regs} registers, {spill} bytes "
                "spill stores")


def ptxas_report(text):
    """(instantiation, registers, spill-store bytes) of each kernel in an
    ``nvcc -Xptxas -v`` log, the mangled names shortened to their kernel
    and template arguments, e.g. ``flash_kernel<bf16,256,256>``."""
    rows, fn, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((short_kernel_name(fn), int(m.group(1)), spill))
            fn = None
    return rows


def short_kernel_name(mangled: str) -> str:
    m = re.search(r"(\w+?)I((?:13__nv_bfloat16|f|Li\d+E|Lb[01]E)+)E",
                  mangled)
    if m is None:                   # no template: the last nested name
        pos, last = 3, mangled
        while mangled.startswith("_ZN") and mangled[pos:pos + 1].isdigit():
            d = re.match(r"\d+", mangled[pos:])
            pos += d.end()
            last = mangled[pos:pos + int(d.group())]
            pos += int(d.group())
        return last
    head, name = m.group(1), m.group(1)
    for i in reversed(range(len(head))):   # the last length-prefixed name
        d = re.match(r"\d+", head[i:])
        if d and int(d.group()) == len(head) - i - d.end() > 0:
            name = head[i + d.end():]
            break
    args = re.findall(r"13__nv_bfloat16|Lb[01]E|Li\d+E|f", m.group(2))
    # a bool argument is flash's LSE output, or the grouped matmul's
    # K-major weights (KB: the backward's dx), then its staged epilogue
    flags = ([("lse", "nolse")] if name.startswith("flash") else
             [("kb", "mn"), ("staged", "direct")])
    out, nb = [], 0
    for a in args:
        if a.startswith("Lb"):
            pair = flags[min(nb, len(flags) - 1)]
            out.append(pair[0] if a == "Lb1E" else pair[1])
            nb += 1
        else:
            out.append("bf16" if a.startswith("13") else
                       "f32" if a == "f" else a[2:-1])
    return name + "<" + ",".join(out) + ">"


def kernel_cases(torch, dtype, heads, kv, dim):
    """(kernel, case, window, wrapper, plain version, args, kwargs) for
    every kernel at the shapes the main path's runs give it, windowed or
    not.  The paged kernels run at qwen2-0.5b's layout only (their serving
    shapes); the dense ones at llama3-8b's too (H=32, KV=8, D=128)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.ragged_prefill_attention import (
        ragged_prefill_attention, ragged_prefill_attention_ref)
    paged = dim == D
    if paged:
        dec = decode_inputs(torch, dtype, DEVICE)
        pre = prefill_inputs(torch, dtype, DEVICE)
    shape = (torch, dtype, DEVICE, heads, kv, dim)
    dense = flash_inputs(*shape, GEN_B, GEN_S, GEN_S)
    rows = flash_inputs(*shape, PRE_P, PRE_C, ID_TABLE_W * BS)
    offsets = torch.tensor(ROW_OFFSETS, dtype=torch.int32, device=DEVICE)
    gdec = dense_decode_inputs(*shape, GEN_B, GEN_CACHE,
                               (GEN_S + 1, GEN_S + GEN_NEW - 1), SEED + 4)
    cdec = dense_decode_inputs(*shape, ID_SLOTS, ID_TABLE_W * BS,
                               (101, ID_PROMPT_MAX + ID_NEW), SEED + 5)
    cdec[3][-1] = 1                 # an empty seat decodes at position 0
    mdec = dense_decode_inputs(*shape, DEC_B, MIX_CACHE, (100, 1564),
                               SEED + 2)
    cases = []
    for window in (None, WINDOW):
        if paged:
            kw = dict(block_size=BS, window=window)
            cases += [("paged_decode_attention", "serving", window,
                       paged_decode_attention, paged_decode_attention_ref,
                       dec, kw),
                      ("ragged_prefill_attention", "serving", window,
                       ragged_prefill_attention, ragged_prefill_attention_ref,
                       pre, kw)]
        cases += [("flash_attention", "Generator prefill", window,
                   flash_attention, flash_attention_ref, dense,
                   dict(causal=True, window=window)),
                  ("flash_attention", "composed rows q_offset", window,
                   flash_attention, flash_attention_ref, rows,
                   dict(causal=True, window=window, q_offset=offsets))]
        cases += [("decode_attention", case, window, decode_attention,
                   decode_attention_ref, args, dict(window=window))
                  for case, args in (("Generator", gdec), ("composed", cdec),
                                     ("mixed lengths", mdec))]
    return cases


def paged_plan(torch, dtype_name, args, window):
    """The bf16 paged decode's split plan at these inputs, for the log."""
    if dtype_name != "bfloat16":
        return ""
    from repro_torch.kernels.decode_attention import paged_decode_splits
    q, k_pool, _, tables = args[:4]
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if DEVICE == "cuda" else 132)
    plan = paged_decode_splits(q.shape[0], k_pool.shape[2],
                               q.shape[2] // k_pool.shape[2], q.shape[3],
                               tables.shape[1] * BS, window, sms)
    return f", splits (count, keys) {plan}"


def phase_kernels(torch):
    timed = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        limit = (f"{F32_TOL} abs" if dtype_name == "float32" else
                 "one bf16 step of the plain version and half a step of its "
                 f"f32 result, + {BF16_ABS}")
        for heads, kv, dim in ((H, KV, D), (LLAMA_H, LLAMA_KV, LLAMA_D)):
            for name, case, window, fn, ref, args, kw in kernel_cases(
                    torch, dtype, heads, kv, dim):
                args32 = [t.float() if t.is_floating_point() else t
                          for t in args]
                got = fn(*args, **kw)
                err, share = parity(torch, dtype_name, got, ref(*args, **kw),
                                    ref(*args32, **kw))
                sync(torch)
                extra = ""
                if name == "ragged_prefill_attention":
                    filler_zero = bool((got[3] == 0).all().item())
                    extra = f", filler row exactly zero={filler_zero}"
                    share = share if filler_zero else float("inf")
                if name == "paged_decode_attention":
                    extra = paged_plan(torch, dtype_name, args, window)
                log(f"[kernels] {name} ({case}, H={heads} KV={kv} D={dim}) "
                    f"{dtype_name} window={window}: max_abs_err={err:.3e} "
                    f"({share:.3f} of allowed){extra} (limit: {limit})")
                if not share <= 1:
                    raise AssertionError(f"kernel parity failed: {name} "
                                         f"{case} {dtype_name} D={dim} "
                                         f"window={window}")
                if (dtype_name == "bfloat16" and dim == D and window is None
                        and (name, case) not in timed):
                    timed[(name, case)] = (fn, ref, args, kw, err)
        # the paged decode at phi4-mini's (H, KV, D) = (24, 8, 128)
        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_ref)
        dec = decode_inputs(torch, dtype, DEVICE, PHI4_H, PHI4_KV, PHI4_D)
        dec32 = [t.float() if t.is_floating_point() else t for t in dec]
        for window in (None, WINDOW):
            kw = dict(block_size=BS, window=window)
            got = paged_decode_attention(*dec, **kw)
            err, share = parity(torch, dtype_name, got,
                                paged_decode_attention_ref(*dec, **kw),
                                paged_decode_attention_ref(*dec32, **kw))
            sync(torch)
            plan = paged_plan(torch, dtype_name, dec, window)
            log(f"[kernels] paged_decode_attention (phi4-mini serving, H="
                f"{PHI4_H} KV={PHI4_KV} D={PHI4_D}) {dtype_name} window="
                f"{window}: max_abs_err={err:.3e} ({share:.3f} of allowed)"
                f"{plan} (limit: {limit})")
            if not share <= 1:
                raise AssertionError("kernel parity failed: paged_decode_"
                                     f"attention phi4-mini {dtype_name} "
                                     f"window={window}")
        # the deepseek-v2-lite path: grouped matmul (its bf16 slack covers
        # the f32 sums' differences over D = 2048), MLA decode (f32 out),
        # flash at (Dk, Dv) = (192, 128)
        for name, case, window, fn, ref, args, kw in moe_mla_cases(
                torch, dtype):
            args32 = [t.float() if t.is_floating_point() else t
                      for t in args]
            got = fn(*args, **kw)
            slack = GM_ABS if name == "grouped_matmul" else BF16_ABS
            err, share = parity(torch, dtype_name, got, ref(*args, **kw),
                                ref(*args32, **kw), slack)
            sync(torch)
            rule = (limit if dtype_name == "float32" else
                    f"{MLA_BF16_TOL} abs (f32 out)" if got.dtype ==
                    torch.float32 else
                    limit.replace(f"+ {BF16_ABS}", f"+ {slack}"))
            if name == "paged_mla_decode_attention" and \
                    dtype_name == "bfloat16":
                from repro_torch.kernels.decode_attention import (
                    mla_decode_splits)
                rule += (", splits (count, keys) %s" % (mla_decode_splits(
                    args[0].shape[0], args[4].shape[1] * BS,
                    torch.cuda.get_device_properties(0).multi_processor_count
                    if DEVICE == "cuda" else 132),))
            log(f"[kernels] {name} ({case}) {dtype_name}: max_abs_err="
                f"{err:.3e} ({share:.3f} of allowed) (limit: {rule})")
            if not share <= 1:
                raise AssertionError(f"kernel parity failed: {name} {case} "
                                     f"{dtype_name}")
            if dtype_name == "bfloat16":
                timed[(name, case)] = (fn, ref, args, kw, err)
        # mamba2-370m's SSD scan: y and the final state
        from repro_torch.kernels.ssd_scan import (ssd_body, ssd_scan,
                                                  ssd_scan_ref)
        for case, args, kw in ssd_cases(torch, dtype):
            args32 = [t.float() for t in args]
            kw32 = dict(kw, init_state=None if kw["init_state"] is None
                        else kw["init_state"].float())
            kw64 = dict(kw32, acc=torch.float64, init_state=None
                        if kw["init_state"] is None
                        else kw["init_state"].double())
            got = ssd_scan(*args, **kw)
            checks = [ssd_parity(torch, dtype_name, g, w, w32, w64)
                      for g, w, w32, w64 in zip(
                          got, ssd_scan_ref(*args, **kw),
                          ssd_scan_ref(*args32, **kw32),
                          ssd_scan_ref(*[t.double() for t in args], **kw64))]
            sync(torch)
            err, share = max(c[0] for c in checks), max(c[1] for c in checks)
            body = ssd_body(dtype, args[0].shape[-1], args[3].shape[-1],
                            kw["chunk"])
            log(f"[kernels] ssd_scan ({case}, Q={kw['chunk']}, init_state="
                f"{kw['init_state'] is not None}, {body} body) {dtype_name}: "
                "max_abs_err="
                f"{err:.3e} over y and the final state ({share:.3f} of "
                f"allowed) (limit: {SSM_REL} x max(1, max |output|) + 2 x the "
                f"plain version's own distance from float64"
                + ("" if dtype_name == "float32" else
                   " + one bf16 step of the plain version, half a step of "
                   "its f32 result") + ")")
            if not share <= 1:
                raise AssertionError(f"kernel parity failed: ssd_scan {case} "
                                     f"{dtype_name}")
            if dtype_name == "bfloat16":
                timed[("ssd_scan", case)] = (ssd_scan, ssd_scan_ref, args, kw,
                                             err)
        # recurrentgemma-2b's rglru_scan (h and the final state) and its
        # attention kernels at (H, KV, D) = (10, 1, 256), windowed
        for name, case, window, fn, ref, args, kw in rg_cases(torch, dtype):
            args32 = [t.float() if t.is_floating_point() else t
                      for t in args]
            got = fn(*args, **kw)
            wants, wants32 = ref(*args, **kw), ref(*args32, **kw)
            if name != "rglru_scan":
                got, wants, wants32 = (got,), (wants,), (wants32,)
            slack = RG_ABS if name == "rglru_scan" else BF16_ABS
            checks = [parity(torch, dtype_name, g, w, w32, slack)
                      for g, w, w32 in zip(got, wants, wants32)]
            sync(torch)
            err, share = max(c[0] for c in checks), max(c[1] for c in checks)
            extra = ""
            if name == "ragged_prefill_attention":
                filler_zero = bool((got[0][3] == 0).all().item())
                extra = f", filler row exactly zero={filler_zero}"
                share = share if filler_zero else float("inf")
            if name == "paged_decode_attention":
                extra = paged_plan(torch, dtype_name, args, window)
            if name == "rglru_scan":
                kw64 = dict(kw, acc=torch.float64)
                w64 = ref(*[t.double() for t in args], **kw64)
                own = max((w.double() - v).abs().max().item()
                          for w, v in zip(ref(*args32, **kw), w64))
                extra = (f", init_state={kw['init_state'] is not None}; the "
                         f"f32 plain version's own distance from float64 "
                         f"{own:.3e}")
            rule = (limit if dtype_name == "float32" else
                    limit.replace(f"+ {BF16_ABS}", f"+ {slack}"))
            what = ("B x S x W = " + " x ".join(map(str, args[0].shape))
                    if name == "rglru_scan" else
                    f"H={args[0].shape[-2]} KV={args[1].shape[-2]} "
                    f"D={args[0].shape[-1]}")
            log(f"[kernels] {name} ({case}, {what}) {dtype_name} window="
                f"{window}: max_abs_err={err:.3e} ({share:.3f} of allowed)"
                f"{extra} (limit: {rule})")
            if not share <= 1:
                raise AssertionError(f"kernel parity failed: {name} {case} "
                                     f"{dtype_name}")
            if dtype_name == "bfloat16":
                timed[(name, case)] = (fn, ref, args, kw, err)
        # the train steps: flash with lse, and its backward; the two
        # scans' backwards
        train_kernel_checks(torch, dtype_name, timed)
        scan_bwd_checks(torch, dtype_name, timed)
        grouped_bwd_checks(torch, dtype_name, timed)

    return time_kernels(torch, timed)


def bwd_inputs(torch, dtype, heads, kv, dk, dv, batch, seq, window, seed):
    """The flash backward's inputs as the train step hands them over: q,
    k, v, the forward kernel's output and lse on them, and dO."""
    from repro_torch.kernels.flash_attention import flash_attention_lse
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(batch, seq, n, dim, generator=g)
                   .to(DEVICE, dtype) for n, dim in ((heads, dk), (kv, dk),
                                                     (kv, dv), (heads, dv)))
    out, lse = flash_attention_lse(q, k, v, causal=True, window=window)
    return q, k, v, out, lse, do


def bwd_kernel_names(fa, dtype, dk, dv):
    """The instantiations flash_bwd_body's body launches for the backward's
    main kernels, as ptxas_report names them."""
    if fa.flash_bwd_body(dtype, dk, dv) == "wgmma":
        cols = "_cols" if (dk, dv) == (192, 128) else ""
        return [f"flash_bwd_wgmma{cols}<{dk},{dv}>"]
    if fa.flash_bwd_body(dtype, dk, dv) == "wide":
        return ["flash_bwd_wide_dkdv", "flash_bwd_wide_dq"]
    t = "f32" if dtype.itemsize == 4 else "bf16"
    if (dk, dv) == (256, 256):
        return [f"flash_bwd_dkdv_wide<{t},{dk}>", f"flash_bwd_dq_wide<{t},{dk}>"]
    return [f"flash_bwd_dkdv<{t},{dk},{dv}>", f"flash_bwd_dq<{t},{dk},{dv}>"]


# phase 3's flash cases at the shapes of the bf16 train runs (phases 23,
# 26 and 29): each also holds the forward with its lse and is timed
TRAIN_RUNS = ("train", "mla train", "musicgen train", "recurrentgemma train",
              "pipeline micro")


def rg_attention():
    """recurrentgemma-2b's LOCAL_ATTN heads: (H, KV, Dk, Dv)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(RG_ARCH)
    d = cfg.resolved_head_dim
    return cfg.num_heads, cfg.num_kv_heads, d, d


def mg_attention():
    """musicgen-large's attention in phase 29: (H, KV, Dk, Dv), and the
    positions of a row, num_prefix_tokens + MG_S."""
    from repro_torch.configs.base import get_config
    cfg = get_config(MG_ARCH)
    d = cfg.resolved_head_dim
    return ((cfg.num_heads, cfg.num_kv_heads, d, d),
            cfg.num_prefix_tokens + MG_S)


def train_kernel_checks(torch, dtype_name, timed):
    """The kernels of the train steps against their plain versions: the
    forward with its lse at qwen2's train shape (B = TRAIN_B, S = TRAIN_S,
    (14, 2, 64)), at deepseek-v2-lite's (DS_TRAIN_B x DS_TRAIN_S,
    BWD_MLA: (Dk, Dv) = (192, 128), G = 1) and at musicgen-large's with
    its prefix (MG_B x 4160 positions, (32, 32, 64), G = 1: the last
    128-key tile half full) and at recurrentgemma-2b's (RG_TRAIN_B x
    RG_TRAIN_S, (10, 1, 256), window RG_WINDOW), and the backward there, at
    (24, 8, 128), S = BWD_WIDE_S, with and without a window, and at the
    reduced MLA pair (96, 64), against ``flash_attention_bwd_ref`` and, in
    f32, against autograd through ``flash_attention_ref`` (in bf16 the
    saved output is rounded, so autograd of the f32 forward is another
    function)."""
    from repro_torch.kernels import flash_attention as fa
    dtype = getattr(torch, dtype_name)
    wide = BWD_WIDE + BWD_WIDE[2:]
    mg_heads, mg_positions = mg_attention()
    for case, (heads, kv, dk, dv), batch, seq, window in (
            ("train", (H, KV, D, D), TRAIN_B, TRAIN_S, None),
            ("wide", wide, BWD_WIDE_B, BWD_WIDE_S, None),
            ("wide windowed", wide, BWD_WIDE_B, BWD_WIDE_S, WINDOW),
            ("mla train", BWD_MLA, DS_TRAIN_B, DS_TRAIN_S, None),
            ("mla reduced", BWD_MLA_REDUCED, BWD_MLA_REDUCED_B,
             BWD_MLA_REDUCED_S, None),
            ("musicgen train", mg_heads, MG_B, mg_positions, None),
            ("recurrentgemma train", rg_attention(), RG_TRAIN_B, RG_TRAIN_S,
             RG_WINDOW),
            ("pipeline micro", (H, KV, D, D), PIPE_B // PIPE_MICRO, TRAIN_S,
             None)):
        args = bwd_inputs(torch, dtype, heads, kv, dk, dv, batch, seq,
                          window, SEED + 50)
        kw = dict(causal=True, window=window)
        what = f"B={batch} S={seq} H={heads} KV={kv} Dk={dk} Dv={dv}"
        if case in TRAIN_RUNS:
            q, k, v, out, lse = args[:5]
            want, want_lse = fa.flash_attention_lse_ref(q, k, v, **kw)
            want32 = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                            **kw)
            err, share = parity(torch, dtype_name, out, want, want32)
            lse_err = (lse - want_lse).abs().max().item()
            lse_share = lse_err / (F32_TOL * max(
                1.0, want_lse.abs().max().item()))
            sync(torch)
            log(f"[kernels] flash_attention with lse ({case}, {what}) "
                f"{dtype_name}: out max_abs_err={err:.3e} ({share:.3f} of "
                f"allowed), lse max_abs_err={lse_err:.3e} ({lse_share:.3f} "
                f"of {F32_TOL} x max(1, max |lse|), f32 in both dtypes)")
            if not max(share, lse_share) <= 1:
                raise AssertionError("kernel parity failed: flash_attention "
                                     f"with lse {dtype_name}")
            if dtype_name == "bfloat16":
                timed[("flash_attention", f"{case} lse")] = (
                    fa.flash_attention_lse, fa.flash_attention_lse_ref,
                    (q, k, v), kw, max(err, lse_err))
            del want, want_lse, want32
        body = fa.flash_bwd_body(dtype, dk, dv)
        kernels = bwd_kernel_names(fa, dtype, dk, dv)
        report = {fn: (regs, spill) for fn, regs, spill
                  in PTXAS.get("flash_attention_bwd", ())}
        log(f"[kernels] flash_attention_bwd ({case}) {dtype_name}: body "
            f"{body}: " + ", ".join(
                f"{fn} {report[fn][0]} registers, {report[fn][1]} bytes spill "
                "stores" if fn in report else f"{fn} (built before this run: "
                "no ptxas report)" for fn in kernels))
        n0 = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(*args, **kw)
        wants = fa.flash_attention_bwd_ref(*args, **kw)
        wants32 = fa.flash_attention_bwd_ref(
            *(t.float() for t in args), **kw)
        checks = [grad_parity(torch, dtype_name, g, w, w32)
                  for g, w, w32 in zip(got, wants, wants32)]
        sync(torch)
        if fa.flash_attention_bwd.launches != n0 + 1:
            raise AssertionError("flash_attention_bwd launched no kernel")
        scale_of = [max(1.0, w.abs().max().item()) for w in wants32]
        msg = ", ".join(f"d{n} {c[0]:.3e} ({c[1]:.3f}; max |grad| {m:.3g})"
                        for n, c, m in zip("qkv", checks, scale_of))
        share = max(c[1] for c in checks)
        del wants, wants32
        if dtype_name == "float32":
            leaves = [t.clone().requires_grad_() for t in args[:3]]
            auto = torch.autograd.grad(fa.flash_attention_ref(*leaves, **kw),
                                       leaves, args[5])
            auto_checks = [grad_parity(torch, dtype_name, g, a, a)
                           for g, a in zip(got, auto)]
            msg += "; against autograd through the plain forward " + \
                ", ".join(f"d{n} {c[0]:.3e} ({c[1]:.3f})"
                          for n, c in zip("qkv", auto_checks))
            share = max([share] + [c[1] for c in auto_checks])
            del leaves, auto
        log(f"[kernels] flash_attention_bwd ({case}, {what}) {dtype_name} "
            f"window={window}: max_abs_err {msg} (limit: {F32_TOL} x max(1, "
            "max |grad|)" + ("" if dtype_name == "float32" else
                             ", as slack beside one bf16 step of the plain "
                             "version and half a step of its f32 result")
            + ")")
        if not share <= 1:
            raise AssertionError(f"kernel parity failed: flash_attention_bwd "
                                 f"{case} {dtype_name}")
        if dtype_name == "bfloat16" and case in TRAIN_RUNS + (
                "wide", "mla reduced"):
            timed[("flash_attention_bwd", case)] = (
                fa.flash_attention_bwd, fa.flash_attention_bwd_ref, args, kw,
                max(c[0] for c in checks))
        del got
        torch.cuda.empty_cache()


def ssd_bwd_cases(torch, dtype):
    """(case, args, kwargs) of ssd_scan_bwd: mamba2-370m's train step
    (SSM_TRAIN_B x SSM_TRAIN_S, chunks of 256, x, B and C column slices of
    the layer's one tensor, dfin None as the train step hands it over), and
    SCAN_BWD_B x SCAN_BWD_S with an initial state and the final state's
    gradient; dy at N(0, 1)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(SSM_ARCH)
    s = cfg.ssm
    H, P, N = s.num_heads(cfg.d_model), s.head_dim, s.d_state
    out = []
    for case, B, S, seed, state in (
            ("train", SSM_TRAIN_B, SSM_TRAIN_S, SEED + 60, False),
            ("initial state and dfin", SCAN_BWD_B, SCAN_BWD_S, SEED + 61,
             True)):
        args, kw = ssd_inputs(torch, dtype, cfg, B, S, seed, False)
        g = torch.Generator(device="cpu").manual_seed(seed + 100)
        dy = torch.randn(B, S, H, P, generator=g).to(DEVICE, dtype)
        dfin = None
        if state:
            kw["init_state"] = torch.randn(B, H, P, N, generator=g).to(
                DEVICE, dtype)
            dfin = torch.randn(B, H, P, N, generator=g).to(DEVICE, dtype)
        out.append((case, (*args, dy, dfin), kw))
    return out


def rg_bwd_cases(torch, dtype):
    """(case, args, kwargs) of rglru_scan_bwd: recurrentgemma-2b's train
    step (RG_TRAIN_B x RG_TRAIN_S x 2560, dfin None) and SCAN_BWD_B x
    SCAN_BWD_S with an initial state and the final state's gradient; the
    inputs as rg_scan_inputs draws them, dh at N(0, 1)."""
    from repro_torch.configs.base import get_config
    W = get_config(RG_ARCH).rglru.lru_width
    out = []
    for case, B, S, seed, state in (
            ("train", RG_TRAIN_B, RG_TRAIN_S, SEED + 62, False),
            ("initial state and dfin", SCAN_BWD_B, SCAN_BWD_S, SEED + 63,
             True)):
        args, kw = rg_scan_inputs(torch, dtype, W, B, S, seed, False)
        g = torch.Generator(device="cpu").manual_seed(seed + 100)
        dh = torch.randn(B, S, W, generator=g).to(DEVICE, dtype)
        dfin = None
        if state:
            kw["init_state"] = torch.randn(B, W, generator=g).to(DEVICE,
                                                                 dtype)
            dfin = torch.randn(B, W, generator=g).to(DEVICE, dtype)
        out.append((case, (*args, dh, dfin), kw))
    return out


def ssd_bwd_kernel_names(ss, dtype, P, N):
    """The kernels ssd_bwd_body's body launches before ssd_bwd_dt, as
    ptxas_report names them."""
    if ss.ssd_bwd_body(dtype, P, N) == "mma":
        return ["ssd_bwd_states", "ssd_bwd_keys_mma", "ssd_bwd_queries_wg"]
    t = "f32" if dtype.itemsize == 4 else "bf16"
    return [f"{k}<{t},{P},{N}>" for k in ("ssd_bwd_chunk", "ssd_bwd_pass",
                                          "ssd_bwd_keys", "ssd_bwd_queries")]


def scan_grad_parity(torch, dtype_name, got, want, want32, want64, rel):
    """The two scans' backward rule: (max abs error against the plain
    version, worst share of the allowed error).  Every gradient sums over
    a chunk's or the sequence's positions (d log_a and dA over all of
    them) in another order, and the decays' running sums carry their own
    rounding, so the f32 limit is ``rel`` x max(1, max |grad|) plus twice
    the plain version's own distance from float64; in bf16 it is the slack
    beside one bf16 step of the plain version and half a step of its f32
    result.  A float32 gradient (ddt, dA, d log_a) is held to the f32 limit
    in both dtypes."""
    own = (want32.double() - want64).abs().max().item()
    tol = rel * max(1.0, want32.abs().max().item()) + 2 * own
    if dtype_name == "float32" or got.dtype == torch.float32:
        err = (got.float() - want.float()).abs().max().item()
        return err, err / tol
    return parity(torch, dtype_name, got, want, want32, slack=tol)


def scan_bwd_checks(torch, dtype_name, timed):
    """The two scans' backward kernels against their plain versions at the
    train steps' shapes and with an initial state and dfin: ssd_scan_bwd
    (dx, ddt, dA, dBm, dCm, d init_state) and rglru_scan_bwd (dx, d
    input_gate, d a_gate, d log_a, d init_state), to scan_grad_parity's
    limit (SSM_REL; the RG-LRU's F32_TOL)."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    dtype = getattr(torch, dtype_name)

    def cast(t, to):
        return (t.to(to) if torch.is_tensor(t) and t.is_floating_point()
                else t)
    for name, fn, ref, cases, rel, grads in (
            ("ssd_scan_bwd", ss.ssd_scan_bwd, ss.ssd_scan_bwd_ref,
             ssd_bwd_cases, SSM_REL, ("dx", "ddt", "dA", "dBm", "dCm",
                                      "dinit")),
            ("rglru_scan_bwd", rs.rglru_scan_bwd, rs.rglru_scan_bwd_ref,
             rg_bwd_cases, F32_TOL, ("dx", "dig", "dag", "dlog_a",
                                     "dinit"))):
        for case, args, kw in cases(torch, dtype):
            n0 = fn.launches
            got = fn(*args, **kw)
            sync(torch)
            if fn.launches != n0 + 1:
                raise AssertionError(f"{name} launched no kernel")
            want = ref(*args, **kw)
            kw32 = {k: cast(v, torch.float32) for k, v in kw.items()}
            want32 = ref(*(cast(t, torch.float32) for t in args), **kw32)
            kw64 = {k: cast(v, torch.float64) for k, v in kw.items()}
            want64 = ref(*(cast(t, torch.float64) for t in args),
                         acc=torch.float64, **kw64)
            checks = {n: scan_grad_parity(torch, dtype_name, g, w, w32, w64,
                                          rel)
                      for n, g, w, w32, w64 in zip(grads, got, want, want32,
                                                   want64) if g is not None}
            del want32, want64
            x = args[0]
            report = {k: (regs, spill) for k, regs, spill
                      in PTXAS.get(name, ())}
            if name == "ssd_scan_bwd":
                body = ", body " + ss.ssd_bwd_body(
                    dtype, x.shape[-1], args[3].shape[-1])
                kernels = ssd_bwd_kernel_names(ss, dtype, x.shape[-1],
                                               args[3].shape[-1])
            else:
                body, t = "", "f32" if dtype.itemsize == 4 else "bf16"
                kernels = [f"rglru_bwd_{k}<{t}>"
                           for k in ("chunks", "carries", "grads")]
            body += ": " + ", ".join(
                f"{k} {report[k][0]} registers, {report[k][1]} bytes spill "
                "stores" if k in report else f"{k} (built before this run: "
                "no ptxas report)" for k in kernels)
            log(f"[kernels] {name} ({case}, " + " x ".join(
                map(str, x.shape)) + f"{body}) {dtype_name}: max_abs_err "
                + ", ".join(f"{n} {e:.3e} ({sh:.3f})"
                            for n, (e, sh) in checks.items())
                + f" (limit: {rel} x max(1, max |grad|) + 2 x the plain "
                "version's own distance from float64"
                + ("" if dtype_name == "float32" else
                   ", as slack beside one bf16 step of the plain version "
                   "and half a step of its f32 result") + ")")
            if not max(sh for _, sh in checks.values()) <= 1:
                raise AssertionError(f"kernel parity failed: {name} {case} "
                                     f"{dtype_name}")
            if dtype_name == "bfloat16" and case == "train":
                timed[(name, case)] = (fn, ref, args, kw, max(
                    e for e, _ in checks.values()))
            del got, want
            torch.cuda.empty_cache()


def grouped_bwd_cases(torch, dtype):
    """(case, (x, w, group sizes, dy)) of the grouped matmul's backward at
    deepseek-v2-lite's train shape (GM_TRAIN_ROWS sorted rows of the
    w_gate/w_up stacks, as phase 26's 2 x 4096 tokens route them) and at a
    serving-sized mix of a decode step's DEC_B x top_k rows, where some
    experts get none."""
    from repro_torch.configs.base import get_config
    cfg = get_config(DS_ARCH)
    D, F = cfg.d_model, cfg.moe.d_ff_expert
    out = []
    for i, (case, rows) in enumerate((("train", GM_TRAIN_ROWS),
                                      ("serving", DEC_B * cfg.moe.top_k))):
        x, w, sizes = gm_inputs(torch, dtype, cfg, rows, D, F, SEED + 40 + i)
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 44 + i)
        dy = (torch.randn(rows, F, generator=g, device=DEVICE)
              * 0.01).to(dtype)
        out.append((case, (x, w, sizes, dy)))
    return out


def grouped_bwd_checks(torch, dtype_name, timed):
    """The grouped matmul's backward kernels (dx, dw) against its plain
    version (grouped_matmul_bwd_ref) at grouped_bwd_cases' shapes, to
    scan_grad_parity's rule with F32_TOL: dw sums a group's rows (~768 an
    expert at the train shape, all of them in one expert's case), so the
    f32 limit is F32_TOL x max(1, max |grad|) + twice the plain version's
    own distance from float64, and in bf16 that limit is the slack beside
    one step of the plain version and half a step of its f32 result.  An
    empty expert's dw must be exact zeros."""
    from repro_torch.kernels import grouped_matmul as gm
    dtype = getattr(torch, dtype_name)
    for case, args in grouped_bwd_cases(torch, dtype):
        x, w, sizes, dy = args
        n0 = (gm.grouped_matmul_bwd_dx.launches,
              gm.grouped_matmul_bwd_dw.launches)
        got = gm.grouped_matmul_bwd(*args)
        sync(torch)
        if (gm.grouped_matmul_bwd_dx.launches,
                gm.grouped_matmul_bwd_dw.launches) != (n0[0] + 1, n0[1] + 1):
            raise AssertionError("grouped_matmul_bwd launched no kernel")
        want = gm.grouped_matmul_bwd_ref(*args)
        f32 = [t.float() if t.is_floating_point() else t for t in args]
        want32 = gm.grouped_matmul_bwd_ref(*f32)
        f64 = [t.double() if t.is_floating_point() else t for t in args]
        want64 = gm.grouped_matmul_bwd_ref(*f64, acc=torch.float64)
        checks = {n: scan_grad_parity(torch, dtype_name, g, a, b, c, F32_TOL)
                  for n, g, a, b, c in zip(("dx", "dw"), got, want, want32,
                                           want64)}
        empty = (sizes == 0).nonzero()[:, 0]
        zeros = bool((got[1][empty] == 0).all().item())
        log(f"[kernels] grouped_matmul_bwd ({case}, T={x.shape[0]}, "
            f"D={x.shape[1]}, F={dy.shape[1]}, {len(empty)} of "
            f"{len(sizes)} experts empty, their dw exact zeros={zeros}) "
            f"{dtype_name}: max_abs_err "
            + ", ".join(f"{n} {e:.3e} ({sh:.3f})"
                        for n, (e, sh) in checks.items())
            + f" (limit: {F32_TOL} x max(1, max |grad|) + 2 x the plain "
            "version's own distance from float64"
            + ("" if dtype_name == "float32" else
               ", as slack beside one bf16 step of the plain version "
               "and half a step of its f32 result") + ")")
        if not max(sh for _, sh in checks.values()) <= 1 or not zeros:
            raise AssertionError(f"kernel parity failed: grouped_matmul_bwd "
                                 f"{case} {dtype_name}")
        if dtype_name == "bfloat16" and case == "train":
            timed[("grouped_matmul_bwd_dx", "train")] = (
                gm.grouped_matmul_bwd_dx, gm.grouped_matmul_bwd_dx_ref,
                (dy, w, sizes), {}, checks["dx"][0])
            timed[("grouped_matmul_bwd_dw", "train")] = (
                gm.grouped_matmul_bwd_dw, gm.grouped_matmul_bwd_dw_ref,
                (x, dy, sizes), {}, checks["dw"][0])
        del got, want, want32, want64, f32, f64
        torch.cuda.empty_cache()


def grouped_bwd_yardstick(torch, part, args):
    """One torch._grouped_mm call computing the same dx (dy against each
    expert's transposed weights) or dw (x's rows against dy's, the group
    sizes splitting the summed dimension) where this torch has it and
    takes that layout, else None; (call, what it is)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "library call: none (this torch has no torch._grouped_mm)"
    a, b, sizes = args
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    if part == "dx":
        call = lambda: torch._grouped_mm(a, b.transpose(1, 2), offs=offs)  # noqa: E731
        what = "torch._grouped_mm(dy, w^T, offs)"
    else:
        call = lambda: torch._grouped_mm(a.t(), b, offs=offs)  # noqa: E731
        what = "torch._grouped_mm(x^T, dy, offs) (K split by offs)"
    try:
        call()
    except RuntimeError as e:            # a layout this build refuses
        return None, (f"library call: none ({what} refused by this torch: "
                      f"{str(e).splitlines()[0][:120]})")
    return call, what


def grouped_bwd_table(torch, pm, timed):
    """Timing rows of the grouped matmul's backward at deepseek-v2-lite's
    train shape (grouped_bwd_checks' "train" case), dx and dw, their
    launches read from the ragged deepseek train run, which launches them
    at that shape."""
    rows = []
    for part in ("dx", "dw"):
        name = f"grouped_matmul_bwd_{part}"
        args = timed[(name, "train")][2]
        x_or_dy, _, sizes = args
        w = timed[("grouped_matmul_bwd_dx", "train")][2][1]
        lib, what = grouped_bwd_yardstick(torch, part, args)
        rows.append((
            name, "train",
            pm.grouped_matmul_bwd_cost(sizes.tolist(), d_in=w.shape[1],
                                       d_out=w.shape[2], itemsize=2,
                                       part=part),
            lib, what, "src/repro/kernels/grouped_matmul.py:58",
            f"{DS_ARCH} ragged train"))
    return tuple(rows)


def train_table(torch, pm, timed):
    """Timing rows of the train step's kernels at qwen2-0.5b's train
    shape, read from phase 23's run: flash with its lse (SDPA's forward
    beside) and the backward (SDPA's backward beside: autograd through
    SDPA less SDPA's forward); and the backward at the wide heads
    (BWD_WIDE, no window), which has no path (None): no run here trains a
    128-wide model, so its (128, 128) instantiation is launched on no
    main path and its row keeps 0 launches; then both at deepseek-v2-lite's
    train shape (BWD_MLA), read from phase 26's run, and at musicgen-large's
    with its prefix, read from phase 29's."""
    q, k, v = timed[("flash_attention", "train lse")][2]
    args = timed[("flash_attention_bwd", "train")][2]
    wide = timed[("flash_attention_bwd", "wide")][2]
    mq, mk, mv = timed[("flash_attention", "mla train lse")][2]
    margs = timed[("flash_attention_bwd", "mla train")][2]
    gq, gk, gv = timed[("flash_attention", "musicgen train lse")][2]
    gargs = timed[("flash_attention_bwd", "musicgen train")][2]
    (gh, gkv, gd, _), gs = mg_attention()
    mg_path = f"{MG_ARCH} train"
    rq, rk, rv = timed[("flash_attention", "recurrentgemma train lse")][2]
    rargs = timed[("flash_attention_bwd", "recurrentgemma train")][2]
    rh, rkv, rd, _ = rg_attention()
    rg_path = f"{RG_ARCH} train"
    nargs = timed[("flash_attention_bwd", "mla reduced")][2]
    pq, pk, pv = timed[("flash_attention", "pipeline micro lse")][2]
    pargs = timed[("flash_attention_bwd", "pipeline micro")][2]
    pb = PIPE_B // PIPE_MICRO
    nh, nkv, ndk, ndv = BWD_MLA_REDUCED
    shape = dict(num_heads=H, kv_heads=KV, itemsize=2)
    wh, wkv, wd = BWD_WIDE
    mh, mkv, mdk, mdv = BWD_MLA
    ds_path = f"{DS_ARCH} train"
    return (
        ("flash_attention", "train lse",
         pm.prefill_visible_cost([0] * TRAIN_B, [TRAIN_S] * TRAIN_B, TRAIN_S,
                                 head_dim=D, **shape),
         sdpa_flash(torch, q, k, v),
         "SDPA causal, enable_gqa (transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", "qwen2-0.5b train"),
        ("flash_attention_bwd", "train",
         pm.flash_attention_bwd_cost(batch=TRAIN_B, seq_q=TRAIN_S,
                                     seq_k=TRAIN_S, dk=D, dv=D, **shape),
         sdpa_flash_bwd(torch, *args),
         "SDPA backward (autograd.grad through SDPA causal, enable_gqa, less "
         "its forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", "qwen2-0.5b train"),
        ("flash_attention_bwd", "wide",
         pm.flash_attention_bwd_cost(batch=BWD_WIDE_B, seq_q=BWD_WIDE_S,
                                     seq_k=BWD_WIDE_S, num_heads=wh,
                                     kv_heads=wkv, dk=wd, dv=wd, itemsize=2),
         sdpa_flash_bwd(torch, *wide),
         "SDPA backward (autograd.grad through SDPA causal, enable_gqa, less "
         "its forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", None),
        # every row whole and causal, so the mean head dim (Dk + Dv) / 2
        # gives the exact visible work of (192, 128)
        ("flash_attention", "mla train lse",
         pm.prefill_visible_cost([0] * DS_TRAIN_B, [DS_TRAIN_S] * DS_TRAIN_B,
                                 DS_TRAIN_S, num_heads=mh, kv_heads=mkv,
                                 head_dim=(mdk + mdv) // 2, itemsize=2),
         sdpa_flash(torch, mq, mk, mv),
         "SDPA causal (transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", ds_path),
        ("flash_attention_bwd", "mla train",
         pm.flash_attention_bwd_cost(batch=DS_TRAIN_B, seq_q=DS_TRAIN_S,
                                     seq_k=DS_TRAIN_S, num_heads=mh,
                                     kv_heads=mkv, dk=mdk, dv=mdv,
                                     itemsize=2),
         sdpa_flash_bwd(torch, *margs),
         "SDPA backward (autograd.grad through SDPA causal, less its "
         "forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", ds_path),
        ("flash_attention", "musicgen train lse",
         pm.prefill_visible_cost([0] * MG_B, [gs] * MG_B, gs, num_heads=gh,
                                 kv_heads=gkv, head_dim=gd, itemsize=2),
         sdpa_flash(torch, gq, gk, gv),
         "SDPA causal (transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", mg_path),
        ("flash_attention_bwd", "musicgen train",
         pm.flash_attention_bwd_cost(batch=MG_B, seq_q=gs, seq_k=gs,
                                     num_heads=gh, kv_heads=gkv, dk=gd,
                                     dv=gd, itemsize=2),
         sdpa_flash_bwd(torch, *gargs),
         "SDPA backward (autograd.grad through SDPA causal, less its "
         "forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", mg_path),
        ("flash_attention", "recurrentgemma train lse",
         pm.prefill_visible_cost([0] * RG_TRAIN_B, [RG_TRAIN_S] * RG_TRAIN_B,
                                 RG_TRAIN_S, num_heads=rh, kv_heads=rkv,
                                 head_dim=rd, itemsize=2, window=RG_WINDOW),
         sdpa_flash(torch, rq, rk, rv, window=RG_WINDOW),
         "SDPA with the causal window's boolean mask, enable_gqa "
         "(transposes and mask excluded)",
         "src/repro/kernels/flash_attention.py:87", rg_path),
        ("flash_attention_bwd", "recurrentgemma train",
         pm.flash_attention_bwd_cost(batch=RG_TRAIN_B, seq_q=RG_TRAIN_S,
                                     seq_k=RG_TRAIN_S, num_heads=rh,
                                     kv_heads=rkv, dk=rd, dv=rd, itemsize=2,
                                     window=RG_WINDOW),
         sdpa_flash_bwd(torch, *rargs, window=RG_WINDOW),
         "SDPA backward (autograd.grad through SDPA with the causal "
         "window's mask, enable_gqa, less its forward; transposes and mask "
         "excluded)", "src/repro/kernels/flash_attention.py:87", rg_path),
        # phase 45's micro-batch: one row of qwen2's train shape
        ("flash_attention", "pipeline micro lse",
         pm.prefill_visible_cost([0] * pb, [TRAIN_S] * pb, TRAIN_S,
                                 head_dim=D, **shape),
         sdpa_flash(torch, pq, pk, pv),
         "SDPA causal, enable_gqa (transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", "qwen2-0.5b pipeline"),
        ("flash_attention_bwd", "pipeline micro",
         pm.flash_attention_bwd_cost(batch=pb, seq_q=TRAIN_S, seq_k=TRAIN_S,
                                     dk=D, dv=D, **shape),
         sdpa_flash_bwd(torch, *pargs),
         "SDPA backward (autograd.grad through SDPA causal, enable_gqa, less "
         "its forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", "qwen2-0.5b pipeline"),
        # the reduced MLA pair: no run here trains at it (0 launches)
        ("flash_attention_bwd", "mla reduced",
         pm.flash_attention_bwd_cost(batch=BWD_MLA_REDUCED_B,
                                     seq_q=BWD_MLA_REDUCED_S,
                                     seq_k=BWD_MLA_REDUCED_S, num_heads=nh,
                                     kv_heads=nkv, dk=ndk, dv=ndv,
                                     itemsize=2),
         sdpa_flash_bwd(torch, *nargs),
         "SDPA backward (autograd.grad through SDPA causal, less its "
         "forward; transposes excluded)",
         "src/repro/kernels/flash_attention.py:87", None))


def scan_train_table(pm, timed):
    """Timing rows of the two scans and their backwards at the train
    steps' shapes, read from phases 31 (mamba2-370m) and 34
    (recurrentgemma-2b).  No PyTorch call computes any of them, so none
    has a library time."""
    x = timed[("ssd_scan_bwd", "train")][2][0]
    N = timed[("ssd_scan_bwd", "train")][2][3].shape[-1]
    rx = timed[("rglru_scan_bwd", "train")][2][0]
    fx = timed[("ssd_scan", "train")][2][0]
    fkw = timed[("ssd_scan", "train")][3]
    return (
        ("ssd_scan", "train",
         pm.ssd_scan_cost(batch=fx.shape[0], seq=fx.shape[1],
                          heads=fx.shape[2], head_dim=fx.shape[3],
                          d_state=N, chunk=fkw["chunk"], itemsize=2,
                          init_state=False),
         None, "library call: none (no PyTorch call computes the SSD "
         "scan)", "src/repro/kernels/ssd_scan.py:70", f"{SSM_ARCH} train"),
        ("rglru_scan", "train",
         pm.rglru_scan_cost(batch=rx.shape[0], seq=rx.shape[1],
                            width=rx.shape[2], itemsize=2,
                            init_state=False),
         None, "library call: none (no PyTorch call computes the RG-LRU "
         "recurrence)", "src/repro/kernels/rglru_scan.py:66",
         f"{RG_ARCH} train"),
        ("ssd_scan_bwd", "train",
         pm.ssd_scan_bwd_cost(batch=x.shape[0], seq=x.shape[1],
                              heads=x.shape[2], head_dim=x.shape[3],
                              d_state=N,
                              chunk=timed[("ssd_scan_bwd", "train")][3][
                                  "chunk"],
                              itemsize=2, init_state=False, dfin=False),
         None, "library call: none (no PyTorch call computes the SSD "
         "scan's backward)", "src/repro/kernels/ssd_scan.py:70",
         f"{SSM_ARCH} train"),
        ("rglru_scan_bwd", "train",
         pm.rglru_scan_bwd_cost(batch=rx.shape[0], seq=rx.shape[1],
                                width=rx.shape[2], itemsize=2,
                                init_state=False, dfin=False),
         None, "library call: none (no PyTorch call computes the RG-LRU "
         "scan's backward)", "src/repro/kernels/rglru_scan.py:66",
         f"{RG_ARCH} train"))


def time_kernels(torch, timed):
    """Timing at the main path's dtype (bf16), no window, of the cases in
    ``timed``; the bound counts the work this run's inputs need (visible
    keys and pairs, live experts); for the paged kernels the reference's
    pages-visited model is printed beside it.  Returns the kernel JSON
    rows (none off the card), each with the ``path`` (qwen2-0.5b or
    deepseek-v2-lite-16b) whose run its launches are read from, or None
    for a row that no path's run launches (0 launches); flash has a row
    on each, at the shape that run gives it."""
    from repro_torch.kernels import perf_model as pm
    if DEVICE != "cuda":
        return []
    shape = dict(num_heads=H, kv_heads=KV, head_dim=D, itemsize=2)
    dec = timed[("paged_decode_attention", "serving")][2]
    pre = timed[("ragged_prefill_attention", "serving")][2]
    lengths = dec[4].tolist()
    starts, limits = pre[4].tolist(), pre[5].tolist()
    pages = {       # qwen2's serving rows only
        ("paged_decode_attention", "serving"): pm.paged_decode_cost(
            batch=DEC_B, block_size=BS, **shape,
            pages_visited=pm.decode_pages_visited(lengths, block_size=BS)),
        ("ragged_prefill_attention", "serving"): pm.ragged_prefill_cost(
            rows_live=sum(n > 0 for n in limits), chunk=PRE_C,
            block_size=BS, **shape, pages_visited=pm.prefill_pages_visited(
                starts, limits, PRE_C, block_size=BS, table_width=TABLE_W))}
    flash = timed[("flash_attention", "Generator prefill")][2]
    gdec = timed[("decode_attention", "Generator")][2]
    cdec = timed[("decode_attention", "composed")][2]
    table = (
        ("paged_decode_attention", "serving",
         pm.decode_visible_cost(lengths, **shape), sdpa_decode(torch, *dec),
         "SDPA on pre-gathered K/V (gather excluded)",
         "src/repro/kernels/paged_decode_attention.py:91"),
        ("ragged_prefill_attention", "serving",
         pm.prefill_visible_cost(starts, limits, PRE_C, **shape),
         sdpa_prefill(torch, *pre),
         "SDPA on pre-gathered K/V (gather excluded)",
         "src/repro/kernels/ragged_prefill_attention.py:89"),
        ("flash_attention", "Generator prefill",
         pm.prefill_visible_cost([0] * GEN_B, [GEN_S] * GEN_B, GEN_S,
                                 **shape),
         sdpa_flash(torch, *flash),
         "SDPA causal, enable_gqa (transposes excluded)",
         "src/repro/kernels/flash_attention.py:87"),
        ("flash_attention", "composed rows q_offset",
         pm.prefill_visible_cost(ROW_OFFSETS, [o + PRE_C for o in
                                               ROW_OFFSETS], PRE_C, **shape),
         None, None, None),
        ("decode_attention", "Generator",
         pm.decode_visible_cost(gdec[3].tolist(), **shape),
         sdpa_dense_decode(torch, *gdec),
         "SDPA with a length mask (head expansion excluded)",
         "src/repro/kernels/decode_attention.py:67"),
        ("decode_attention", "composed",
         pm.decode_visible_cost(cdec[3].tolist(), **shape),
         None, None, None))
    table = (tuple(t + ("qwen2-0.5b",) for t in table)
             + tuple(t + (DS_ARCH,) for t in moe_mla_table(torch, pm, timed))
             + ssm_table(pm, timed) + rg_table(torch, pm, timed)
             + train_table(torch, pm, timed) + scan_train_table(pm, timed)
             + grouped_bwd_table(torch, pm, timed))
    out = []
    for name, case, cost, lib, lib_what, replaces, path in table:
        fn, ref, args, kw, err = timed[(name, case)]
        ms = time_ms(lambda: fn(*args, **kw), torch)
        plain_ms = time_ms(lambda: ref(*args, **kw), torch)
        if isinstance(lib, tuple):    # (with the part to take away, part)
            library_ms = time_ms(lib[0], torch) - time_ms(lib[1], torch)
        else:
            library_ms = time_ms(lib, torch) if lib is not None else None
        bound_ms = cost.bound_seconds("bfloat16") * 1e3
        bound_by = cost.bound_by("bfloat16")
        msg = (f"[kernels] {name} ({case}) bf16: {ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
               f"visible work {cost.flops:.4g} flop, {cost.hbm_bytes:.4g} B)")
        if lib is not None:
            msg += f", {lib_what} {library_ms:.4f} ms"
        elif lib_what is not None:
            msg += f", {lib_what}"
        if (name, case) in pages:
            pc = pages[(name, case)]
            msg += (f"; the reference's pages-visited model: {pc.flops:.4g} "
                    f"flop, {pc.hbm_bytes:.4g} B, "
                    f"{pc.bound_seconds('bfloat16') * 1e3:.5f} ms")
        log(msg)
        if replaces is None:          # logged only
            continue
        out.append({"name": ROW_NAMES.get((name, case), name),
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              f"{SOURCE_OF.get(name, name)}.cu",
                    "replaces": replaces, "launches": 0, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "path": path})
    return out


# the CUDA source of a wrapper whose name is not its source's (the
# backward's two entry points); their launch counts are the wrappers' own
SOURCE_OF = {"grouped_matmul_bwd_dx": "grouped_matmul_bwd",
             "grouped_matmul_bwd_dw": "grouped_matmul_bwd"}

# JSON row names where a kernel has a second row
ROW_NAMES = {("flash_attention", "MLA rows q_offset (192, 128)"):
             "flash_attention_dk192_dv128",
             ("grouped_matmul", "decode w_down"):
             "grouped_matmul_decode_w_down",
             ("grouped_matmul", "prefill w_gate/w_up"):
             "grouped_matmul_prefill",
             ("grouped_matmul", "prefill w_down"):
             "grouped_matmul_prefill_w_down",
             ("grouped_matmul", "prefill, one expert"):
             "grouped_matmul_prefill_one_expert",
             ("ssd_scan", "Generator prefill"): "ssd_scan_generator_prefill",
             ("ssd_scan", "train"): "ssd_scan_train",
             ("rglru_scan", "train"): "rglru_scan_train",
             ("rglru_scan", "Generator prefill"):
             "rglru_scan_generator_prefill",
             ("paged_decode_attention", "recurrentgemma serving"):
             "paged_decode_attention_d256_g10",
             ("ragged_prefill_attention", "recurrentgemma serving"):
             "ragged_prefill_attention_d256_g10",
             ("flash_attention", "recurrentgemma Generator prefill"):
             "flash_attention_d256_g10",
             ("flash_attention", "train lse"): "flash_attention_train",
             ("flash_attention_bwd", "wide"): "flash_attention_bwd_d128",
             ("flash_attention", "mla train lse"):
             "flash_attention_train_dk192_dv128",
             ("flash_attention_bwd", "mla train"):
             "flash_attention_bwd_dk192_dv128",
             ("flash_attention", "musicgen train lse"):
             "flash_attention_train_musicgen",
             ("flash_attention_bwd", "musicgen train"):
             "flash_attention_bwd_musicgen",
             ("flash_attention", "recurrentgemma train lse"):
             "flash_attention_train_d256_g10",
             ("flash_attention_bwd", "recurrentgemma train"):
             "flash_attention_bwd_d256_g10",
             ("flash_attention_bwd", "mla reduced"):
             "flash_attention_bwd_dk96_dv64",
             ("flash_attention", "pipeline micro lse"):
             "flash_attention_pipeline_micro",
             ("flash_attention_bwd", "pipeline micro"):
             "flash_attention_bwd_pipeline_micro",
             ("decode_attention", "recurrentgemma Generator"):
             "decode_attention_d256_g10"}


def ssm_table(pm, timed):
    """Timing rows of ssd_scan at mamba2-370m's prefill call and Generator
    prefill, each with the path its launches are read from: (kernel, case,
    visible-work cost, yardstick, what it is, TPU kernel replaced, path).
    No PyTorch call computes the SSD scan, so there is no yardstick."""
    from repro_torch.configs.base import get_config
    s = get_config(SSM_ARCH).ssm
    rows = []
    for case, path in (("serving prefill", SSM_ARCH),
                       ("Generator prefill", f"{SSM_ARCH} Generator")):
        x, _, _, Bm, _ = timed[("ssd_scan", case)][2]
        kw = timed[("ssd_scan", case)][3]
        cost = pm.ssd_scan_cost(
            batch=x.shape[0], seq=x.shape[1], heads=x.shape[2],
            head_dim=x.shape[3], d_state=Bm.shape[-1], chunk=kw["chunk"],
            itemsize=2, init_state=kw["init_state"] is not None)
        rows.append(("ssd_scan", case, cost, None,
                     "library call: none (no PyTorch call computes the SSD "
                     "scan)", "src/repro/kernels/ssd_scan.py:70", path))
    return tuple(rows)


def moe_mla_table(torch, pm, timed):
    """Timing rows of the deepseek-v2-lite path's kernels, a tuple of
    (kernel, case, visible-work cost, yardstick, what it is, TPU kernel
    replaced or None for a row that is logged only)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(DS_ARCH)
    m, H = cfg.mla, cfg.num_heads
    rows = []
    for case in ("decode w_gate/w_up", "decode w_down", "prefill w_gate/w_up",
                 "prefill w_down", "prefill, one expert"):
        x, w, sizes = timed[("grouped_matmul", case)][2]
        lib = grouped_mm_yardstick(torch, x, w, sizes)
        rows.append((
            "grouped_matmul", case,
            pm.grouped_matmul_cost(sizes.tolist(), d_in=w.shape[1],
                                   d_out=w.shape[2], itemsize=2),
            lib, "torch._grouped_mm" if lib is not None else
            "library call: none (this torch has no torch._grouped_mm)",
            "src/repro/kernels/grouped_matmul.py:58"))
    mla = timed[("paged_mla_decode_attention", "serving")][2]
    rows.append((
        "paged_mla_decode_attention", "serving",
        pm.paged_mla_decode_cost(mla[5].tolist(), num_heads=H,
                                 kv_lora_rank=m.kv_lora_rank,
                                 rope_dim=m.qk_rope_head_dim, itemsize=2),
        sdpa_mla(torch, *mla, mla_scale(cfg)),
        "SDPA on pre-gathered latents + rope dims, one shared key head "
        "(gather excluded)",
        "src/repro/kernels/paged_decode_attention.py:189"))
    # every row live and whole, so the mean head dim (Dk + Dv) / 2 gives
    # the exact visible work of (Dk, Dv) = (192, 128)
    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    fl = timed[("flash_attention", "MLA rows q_offset (192, 128)")]
    rows.append((
        "flash_attention", "MLA rows q_offset (192, 128)",
        pm.prefill_visible_cost(DS_ROW_OFFSETS,
                                [o + PRE_C for o in DS_ROW_OFFSETS], PRE_C,
                                num_heads=H, kv_heads=H,
                                head_dim=(dk + m.v_head_dim) // 2,
                                itemsize=2),
        sdpa_flash_rows(torch, *fl[2], fl[3]["q_offset"], fl[3]["scale"]),
        "SDPA with a per-row offset mask (transposes excluded)",
        "src/repro/kernels/flash_attention.py:87"))
    return tuple(rows)


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def serve_all(serve, prompts, max_new):
    rids = [serve.submit(p, max_new) for p in prompts]
    out = serve.join()
    return [out[r] for r in rids], rids


def phase_serve(torch, np, mesh=None, summary=None, tag="serve",
                kernels="fused"):
    """qwen2-0.5b at full width in bf16 through HyperServe on the card (on
    ``mesh`` when given) under the ``kernels`` lowering: SERVE_REQUESTS
    requests after a warm-up, exactly one paged decode a layer and decode
    step and one ragged prefill a layer and prefill call (composed: one
    ``decode_attention`` and one flash, and no fused kernel).
    ``summary`` takes the run's decode tok/s, median TTFT, decode-step
    wall and tokens."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = get_config("qwen2-0.5b")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=NUM_BLOCKS,
                       max_blocks_per_req=TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P,
                       kernels=kernels)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE, mesh=mesh)
    rng = np.random.default_rng(SEED)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)  # warm
    prompts = make_prompts(rng, SERVE_REQUESTS, 100, 1500, cfg.vocab_size)
    eng = serve.engine
    m = eng.obs.metrics
    decode_key = f"serve.kernels.decode.{kernels}"
    before = {k: m.counter(k).value for k in
              (decode_key, "serve.prefill_calls", "serve.prefill_chunks",
               "serve.preemptions")}
    itl0 = m.histogram("serve.itl_s").sum
    tokens0 = eng.tokens_generated
    # the main path's run: every launch count starts at 0 here
    wrappers = (paged_decode_attention, ragged_prefill_attention,
                decode_attention, flash_attention)
    for w in wrappers:
        w.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    outs, rids = serve_all(serve, prompts, 64)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    d = {k: m.counter(k).value - v for k, v in before.items()}
    steps, calls = int(d[decode_key]), int(d["serve.prefill_calls"])
    tokens = eng.tokens_generated - tokens0
    decode_s = m.histogram("serve.itl_s").sum - itl0
    decode_tokens = tokens - len(prompts)      # first tokens come of prefill
    ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
    finished = sum(serve.state(r) == "finished" for r in rids)
    if summary is not None:
        summary.update(decode_tok_s=decode_tokens / decode_s,
                       ttft_s=ttfts[len(ttfts) // 2], step_s=decode_s / steps,
                       tokens=outs)
    log(f"[{tag}] qwen2-0.5b bf16 full width, {kernels}: {finished}/"
        f"{len(prompts)} "
        f"requests finished, {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s overall), decode {decode_tokens} tokens "
        f"in {steps} steps, {decode_s:.3f}s ({decode_tokens / decode_s:.1f} "
        f"decode tok/s), median TTFT {ttfts[len(ttfts) // 2]:.3f}s (all "
        f"submitted at t=0), prefill_calls={calls} prefill_chunks="
        f"{int(d['serve.prefill_chunks'])}, preemptions="
        f"{int(d['serve.preemptions'])}")
    n = cfg.num_layers
    dec, pre = (("paged_decode_attention", "ragged_prefill_attention")
                if kernels == "fused" else
                ("decode_attention", "flash_attention"))
    want = {k: 0 for k in launches}
    want.update({dec: n * steps, pre: n * calls})
    log(f"[{tag}] launches {launches}; expected decode {n} x {steps} = "
        f"{n * steps}, prefill {n} x {calls} = {n * calls}")
    if finished != len(prompts) or any(len(o) != 64 for o in outs):
        raise AssertionError("not every request finished with 64 tokens")
    if launches != want or steps == 0 or calls == 0:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{want} ({n} x (steps={steps}, "
                             f"calls={calls}))")
    return {k: v for k, v in launches.items() if k in (dec, pre)}, serve, \
        prompts


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:                                  # older torch
        us = evt.self_cuda_time_total
    return us / 1e3


def report_profile(tag, windows, shares=None):
    """Device time by kernel against wall time for each profiled window
    ``(name, profiler, wall seconds, steps)``, per step; ``shares``
    ({label: regex}) adds the device time of the kernels whose names match
    each regex and its share of the device's busy time."""
    for name, prof, wall, steps in windows:
        # device-side rows only (kernels, copies): an operator's row also
        # carries its kernels' time, which would count it twice
        rows = [(e.key, _device_ms(e) / steps) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_ms(e) > 0]
        rows.sort(key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        wall_ms = wall * 1e3 / steps
        log(f"[{tag}] {name}: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
        for key, ms in rows[:8]:
            log(f"[{tag}]   {ms:8.4f} ms  {ms / busy:6.1%}  {key[:70]}")
        for label, pattern in (shares or {}).items():
            ms = sum(t for k, t in rows if re.search(pattern, k))
            log(f"[{tag}] {name}: {label} {ms:.4f} ms a step, "
                f"{ms / max(busy, 1e-9):.1%} of device busy")
        if busy <= 0:
            raise AssertionError("the profiler saw no device time")


def phase_profile(torch, serve, prompts, max_new=64, tag="profile"):
    """Where a step's time goes: torch.profiler over one prefill call (the
    first step of a fresh batch) and over steady decode steps, device time
    by kernel against the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rids = [serve.submit(p, max_new) for p in prompts]
    windows = []
    with profile(activities=acts) as prof:
        sync(torch)
        t0 = time.perf_counter()
        serve.step_once()                    # admits 16, prefills 4 chunks
        sync(torch)
        windows.append(("prefill call", prof, time.perf_counter() - t0, 1))
    sched = serve.engine.scheduler
    while any(r.state.value == "prefilling" for r in sched.active):
        serve.step_once()
    n = 8
    with profile(activities=acts) as prof:
        sync(torch)
        t0 = time.perf_counter()
        for _ in range(n):
            serve.step_once()
        sync(torch)
        windows.append(("decode step", prof, time.perf_counter() - t0, n))
    report_profile(tag, windows)
    for r in rids:              # the rest of the run is not measured
        serve.cancel(r)
    serve.join()


def phase_identity(torch, np):
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=512,
                       max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    prompts = make_prompts(np.random.default_rng(SEED + 2), 6, 100,
                           ID_PROMPT_MAX, cfg.vocab_size)
    runs = {}
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            runs[mode], _ = serve_all(HyperServe(
                cfg, params, serve_cfg=scfg, device=DEVICE), prompts, ID_NEW)
        finally:
            ops.set_mode("auto")
    for i, (a, b) in enumerate(zip(runs["auto"], runs["ref"])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"request {i}: first divergence at token "
                                 f"{j}: kernels {a[j]} vs plain {b[j]}")
    log(f"[identity] f32 greedy tokens identical, kernels vs plain versions: "
        f"{len(prompts)} requests x {ID_NEW} tokens")
    return cfg, params, prompts, runs["auto"], scfg


def dense_prefill(torch, gen, prompts):
    """One Generator prefill between two syncs: (seconds, logits, prompt
    caches)."""
    sync(torch)
    t0 = time.perf_counter()
    logits, pcaches = gen.prefill(prompts)
    sync(torch)
    return time.perf_counter() - t0, logits, pcaches


def dense_decode(torch, gen, logits, pcaches, start, n):
    """Seat the prompt caches, then time ``n`` greedy Generator decode
    steps from position ``start`` between two syncs (the seating outside
    the window): seconds."""
    caches = gen.init_caches(logits.shape[0], pcaches)
    vocab = gen.cfg.vocab_size
    cur = torch.argmax(logits[:, -1:, :vocab], dim=-1)
    sync(torch)
    t0 = time.perf_counter()
    for i in range(n):
        lg = gen.decode(cur, start + i, caches)
        cur = torch.argmax(lg[:, -1, :vocab], dim=-1)[:, None]
    sync(torch)
    return time.perf_counter() - t0


def phase_dense(torch, np):
    """The dense Generator (fixed-batch generation) on qwen2-0.5b at full
    width in bf16: GEN_B prompts of GEN_S tokens, GEN_NEW greedy tokens.
    One flash_attention launch per layer for the prefill and one
    decode_attention launch per layer and decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = get_config("qwen2-0.5b")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = Generator(cfg, params, max_len=GEN_CACHE, device=DEVICE)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        1, cfg.vocab_size, size=(GEN_B, GEN_S))).to(DEVICE)
    gen.generate(prompts[:, :64], GenerateConfig(max_new_tokens=4))  # warm
    # the main path's run: every launch count starts at 0 here
    flash_attention.launches = 0
    decode_attention.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    out = gen.generate(prompts, GenerateConfig(max_new_tokens=GEN_NEW))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    n, steps = cfg.num_layers, GEN_NEW - 1
    decode_tokens = GEN_B * steps
    prefill_s, logits, pcaches = dense_prefill(torch, gen, prompts)
    decode_s = dense_decode(torch, gen, logits, pcaches, GEN_S, steps)
    del logits, pcaches
    log(f"[dense] qwen2-0.5b bf16 full width, Generator: {GEN_B} prompts x "
        f"{GEN_S} tokens, {GEN_NEW} new each: generate {wall:.3f}s "
        f"({GEN_B * GEN_NEW / wall:.1f} new tok/s overall); timed alone on "
        f"the same prompts: prefill {prefill_s:.3f}s, decode "
        f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f}s "
        f"({decode_tokens / decode_s:.1f} decode tok/s)")
    log(f"[dense] launches {launches}; expected flash {n} (one prefill), "
        f"decode {n} x {steps} = {n * steps}")
    new = out[:, GEN_S:]
    if (tuple(out.shape) != (GEN_B, GEN_S + GEN_NEW)
            or not torch.equal(out[:, :GEN_S], prompts)
            or not bool(((new >= 0) & (new < cfg.vocab_size)).all())):
        raise AssertionError(f"Generator output malformed: {out.shape}")
    if launches != {"flash_attention": n, "decode_attention": n * steps}:
        raise AssertionError(f"launch counts {launches} do not match {n} "
                             f"per prefill and {n} x {steps} decode steps")
    return launches, gen, prompts


def phase_dense_profile(torch, gen, prompts):
    """torch.profiler over one Generator prefill and 8 decode steps."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = 8
    with profile(activities=acts) as prof:
        wall, logits, pcaches = dense_prefill(torch, gen, prompts)
    windows = [("dense prefill", prof, wall, 1)]
    with profile(activities=acts) as prof:
        # the seating runs before the profiled window opens
        wall = dense_decode(torch, gen, logits, pcaches, GEN_S, n)
    windows.append(("dense decode step", prof, wall, n))
    report_profile("dense profile", windows)


def phase_dense_identity(torch, np, cfg, params):
    """float32 Generator tokens identical with the kernels and with the
    plain versions, with and without a 256-entry ring cache (prompts
    longer than the window), and identical to HyperServe's fused path."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import GenerateConfig, Generator
    prompts = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        1, cfg.vocab_size, size=(ID_B, ID_S)))
    runs = {}
    for window in (None, WINDOW):
        for mode in ("auto", "ref"):
            ops.set_mode(mode)
            try:
                gen = Generator(cfg, params, max_len=ID_S + ID_NEW + 8,
                                window_override=window, device=DEVICE)
                runs[window, mode] = gen.generate(
                    prompts, GenerateConfig(max_new_tokens=ID_NEW)).cpu()
            finally:
                ops.set_mode("auto")
        a, b = runs[window, "auto"], runs[window, "ref"]
        if not torch.equal(a, b):
            i, j = (a != b).nonzero()[0].tolist()
            raise AssertionError(f"window={window}: row {i} diverges at "
                                 f"{j}: kernels {a[i, j]} vs plain {b[i, j]}")
    scfg = ServeConfig(block_size=BS, num_blocks=512,
                       max_blocks_per_req=ID_TABLE_W, max_slots=ID_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    served, _ = serve_all(HyperServe(cfg, params, serve_cfg=scfg,
                                     device=DEVICE), prompts.tolist(), ID_NEW)
    same = served == runs[None, "auto"][:, ID_S:].tolist()
    log(f"[dense identity] f32 Generator greedy tokens identical, kernels vs "
        f"plain versions: {ID_B} prompts x {ID_S} tokens, {ID_NEW} new, "
        f"window None and {WINDOW} (the windowed tokens differ from the "
        f"unwindowed: {not torch.equal(runs[None, 'auto'], runs[WINDOW, 'auto'])}"
        f"); HyperServe fused tokens identical to the Generator's: {same}")
    if not same:
        raise AssertionError("HyperServe tokens differ from the Generator's")


def phase_composed(torch, cfg, params, prompts, fused, scfg):
    """HyperServe with kernels="composed" (gather, then the dense kernels)
    on the identity phase's workload: tokens identical to the fused path,
    one decode_attention per layer and decode step, one flash_attention
    per layer and prefill call, and no fused kernel launched."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.serve.api import HyperServe
    serve = HyperServe(cfg, params, device=DEVICE,
                       serve_cfg=dataclasses.replace(scfg, kernels="composed"))
    kernels = (flash_attention, decode_attention, paged_decode_attention,
               ragged_prefill_attention)
    for k in kernels:
        k.launches = 0
    got, _ = serve_all(serve, prompts, ID_NEW)
    sync(torch)
    launches = {k.__name__: k.launches for k in kernels}
    m = serve.engine.obs.metrics
    steps = int(m.counter("serve.kernels.decode.composed").value)
    calls = int(m.counter("serve.kernels.prefill.composed").value)
    n = cfg.num_layers
    log(f"[composed] f32 HyperServe kernels=composed: tokens identical to "
        f"the fused path: {got == fused} ({len(prompts)} requests x "
        f"{ID_NEW}); launches {launches}; expected decode {n} x {steps}, "
        f"flash {n} x {calls}, fused 0")
    if got != fused:
        raise AssertionError("composed tokens differ from the fused path's")
    if launches != {"flash_attention": n * calls,
                    "decode_attention": n * steps,
                    "paged_decode_attention": 0,
                    "ragged_prefill_attention": 0} or not steps or not calls:
        raise AssertionError(f"composed launch counts {launches} do not "
                             f"match {n} x (steps={steps}, calls={calls})")


def phase_preempt(torch, np, cfg, params, tag="preempt", tiers=False):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.api import HyperServe
    prompts = make_prompts(np.random.default_rng(SEED + 3), 4, 180, 220,
                           cfg.vocab_size)
    base = dict(block_size=BS, max_blocks_per_req=24, max_slots=4,
                prefill_chunk=PRE_C, enable_prefix_cache=False)
    ample, _ = serve_all(HyperServe(cfg, params, serve_cfg=ServeConfig(
        num_blocks=256, **base), device=DEVICE), prompts, 64)
    tight = HyperServe(cfg, params, device=DEVICE,
                       serve_cfg=ServeConfig(num_blocks=PREEMPT_BLOCKS, **base))
    got, _ = serve_all(tight, prompts, 64)
    st = tight.stats()
    m = tight.engine.obs.metrics
    spills, restores = (int(m.counter("serve.spills").value),
                        int(m.counter("serve.restores").value))
    log(f"[{tag}] pool {PREEMPT_BLOCKS - 1} blocks for a working set of "
        f"{sum(-(-(len(p) + 64) // BS) for p in prompts)}: preemptions="
        f"{st['preemptions']} spills={spills} restores={restores} "
        f"prefetch hits={st['prefetch_hits']}, tokens identical to the "
        f"ample pool: {got == ample}")
    if st["preemptions"] < 1 or spills < 1 or restores < 1 or got != ample:
        raise AssertionError("preemption phase failed")
    if tiers:
        tier_runs(torch, cfg, params, tag, ServeConfig(
            num_blocks=PREEMPT_BLOCKS, **base), prompts, 64, ample)


# ---------------------------------------------------------------------------
# HyperMem's archive tiers under preemption
# ---------------------------------------------------------------------------
def serve_launch_want(cfg, steps, calls, kernels="fused"):
    """Each serving kernel's launches over ``steps`` decode steps and
    ``calls`` prefill calls of ``cfg`` under the ``kernels`` lowering: per
    attention layer (ATTN, LOCAL_ATTN) one paged decode a step and one
    ragged prefill a call (composed: one decode_attention and one
    flash_attention), per MLA layer one MLA decode a step (composed: the
    plain absorbed form, no kernel) and one flash_attention a call (its
    prefill is composed either way), per MoE layer three grouped_matmul a
    step and a call, per RG-LRU layer one rglru_scan and per SSD layer one
    ssd_scan a call."""
    from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLA, MOE_FFN,
                                          RGLRU, SSD)
    kinds = [m for m, _ in cfg.block_kinds()]
    n_at = sum(m in (ATTN, LOCAL_ATTN) for m in kinds)
    moe = sum(f == MOE_FFN for _, f in cfg.block_kinds())
    fused = kernels == "fused"
    want = {"paged_decode_attention": n_at * steps * fused,
            "ragged_prefill_attention": n_at * calls * fused,
            "decode_attention": n_at * steps * (not fused),
            "paged_mla_decode_attention": kinds.count(MLA) * steps * fused,
            "flash_attention": (kinds.count(MLA) + n_at * (not fused))
            * calls,
            "grouped_matmul": 3 * moe * (steps + calls),
            "rglru_scan": kinds.count(RGLRU) * calls,
            "ssd_scan": kinds.count(SSD) * calls}
    return {k: v for k, v in want.items() if v}


def serve_wrappers():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_mla_decode_attention)
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {k.__name__: k for k in (paged_decode_attention,
                                    ragged_prefill_attention,
                                    paged_mla_decode_attention,
                                    decode_attention, flash_attention,
                                    grouped_matmul, rglru_scan, ssd_scan)}


def time_archive(torch, archive):
    """Time every spill into and restore out of ``archive`` (its ``put``
    and ``fetch``, each between two syncs of the card) and count their
    bytes: the wall a tier costs per MB, not what overlaps in a real run."""
    from repro_torch.mem import tree_nbytes
    acc = {"spill_s": 0.0, "spill_bytes": 0, "spills": 0,
           "restore_s": 0.0, "restore_bytes": 0, "restores": 0}
    put, fetch = archive.put, archive.fetch

    def timed_put(key, value, **kw):
        sync(torch)
        t0 = time.perf_counter()
        try:
            put(key, value, **kw)
        finally:
            sync(torch)
            acc["spill_s"] += time.perf_counter() - t0
            acc["spill_bytes"] += tree_nbytes(value)
            acc["spills"] += 1

    def timed_fetch(key, **kw):
        sync(torch)
        t0 = time.perf_counter()
        out = fetch(key, **kw)
        sync(torch)
        acc["restore_s"] += time.perf_counter() - t0
        acc["restore_bytes"] += tree_nbytes(out)
        acc["restores"] += 1
        return out
    archive.put, archive.fetch = timed_put, timed_fetch
    return acc


def per_mb(seconds, nbytes):
    return 1e3 * seconds / (nbytes / 2 ** 20) if nbytes else float("nan")


def tier_runs(torch, cfg, params, tag, scfg, prompts, max_new, want,
              drive=None):
    """The preemption of ``scfg`` through HyperMem's tiers, f32 at full
    width: with the unbounded host archive (the host tier), then with
    ``archive_host_bytes`` below one spilled entry, so every entry passes
    through the disk tier: tokens identical to ``want`` (the ample
    pool's), ``archive_evict_host`` >= 1 and equal to ``mem.evict.host``,
    both tiers empty at the end, the serving kernels' launch counts exact;
    the spill and restore wall per MB of each tier.  Then a disk budget
    below one entry must raise MemCapacityError and nothing else.
    ``drive(serve)`` serves the prompts (default: submit all and join)."""
    from repro_torch.mem import MemCapacityError
    from repro_torch.serve.api import HyperServe
    drive = drive or (lambda serve: serve_all(serve, prompts, max_new)[0])
    wrappers = serve_wrappers()
    walls = {}
    for tier, kw in (("host", {}), ("disk", dict(archive_host_bytes=1))):
        serve = HyperServe(cfg, params, device=DEVICE,
                           serve_cfg=dataclasses.replace(scfg, **kw))
        acc = time_archive(torch, serve.engine.blocks.archive)
        for w in wrappers.values():
            w.launches = 0
        got = drive(serve)
        sync(torch)
        st = serve.stats()
        m = serve.engine.obs.metrics
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        expect = serve_launch_want(
            cfg, int(m.counter("serve.kernels.decode.fused").value),
            int(m.counter("serve.kernels.prefill.fused").value))
        walls[tier] = acc
        log(f"[{tag} tiers] {tier} tier: preemptions={st['preemptions']} "
            f"archive_evict_host={st['archive_evict_host']} "
            f"archive_evict_disk={st['archive_evict_disk']} mem.evict.host="
            f"{int(m.counter('mem.evict.host').value)}, archive bytes at the "
            f"end host {st['archive_host_bytes']} disk "
            f"{st['archive_disk_bytes']}; {acc['spills']} spills "
            f"{acc['spill_bytes'] / 2 ** 20:.3f} MB in {acc['spill_s']:.4f}s "
            f"({per_mb(acc['spill_s'], acc['spill_bytes']):.3f} ms/MB), "
            f"{acc['restores']} restores {acc['restore_bytes'] / 2 ** 20:.3f}"
            f" MB in {acc['restore_s']:.4f}s "
            f"({per_mb(acc['restore_s'], acc['restore_bytes']):.3f} ms/MB); "
            f"launches {launches}, expected {expect}; tokens identical to "
            f"the ample pool: {got == want}")
        if got != want or st["preemptions"] < 1 or launches != expect:
            raise AssertionError(f"{tag}: the {tier} tier's run failed")
        if st["archive_host_bytes"] or st["archive_disk_bytes"]:
            raise AssertionError(f"{tag}: the archive is not empty at the end")
        if tier == "disk" and (
                st["archive_evict_host"] < 1
                or m.counter("mem.evict.host").value
                != st["archive_evict_host"]):
            raise AssertionError(f"{tag}: the disk tier was not used")
    serve = HyperServe(cfg, params, device=DEVICE, serve_cfg=dataclasses.replace(
        scfg, archive_host_bytes=1, archive_disk_bytes=1))
    try:
        drive(serve)
    except MemCapacityError as e:
        log(f"[{tag} tiers] disk budget of 1 byte: MemCapacityError "
            f"({str(e)[:60]}...)")
    else:
        raise AssertionError(f"{tag}: a 1-byte disk tier did not raise "
                             "MemCapacityError")
    return walls


def phase_moe_serve(torch, np, mesh=None, summary=None, tag="moe serve"):
    """deepseek-v2-lite-16b (MLA + MoE) at full width in bf16 through
    HyperServe, fused (on ``mesh`` when given): one
    paged_mla_decode_attention per layer and decode step, one
    flash_attention per layer and prefill call (MLA prefill is composed),
    three grouped_matmul per MoE layer and step or call.  ``summary``
    takes the run's decode tok/s, median TTFT, decode-step wall, tokens
    and peak device memory (reset before the params are drawn)."""
    from repro_torch.configs.base import MOE_FFN, ServeConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.paged_decode_attention import \
        paged_mla_decode_attention
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = get_config(DS_ARCH)
    if DEVICE == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    sync(torch)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    log(f"[{tag}] {DS_ARCH} bf16 full width: {n_params / 1e9:.3f} B "
        f"params drawn in {time.perf_counter() - t0:.1f}s")
    scfg = ServeConfig(block_size=BS, num_blocks=DS_NUM_BLOCKS,
                       max_blocks_per_req=DS_TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE, mesh=mesh)
    if mesh is not None:
        # one copy of the 16 B params: on the one-rank mesh every DTensor
        # leaf is a view of the tensor drawn above
        shared = sum(a.to_local().data_ptr() == b.data_ptr() for a, b in
                     zip(tree_leaves(serve.engine.params), leaves))
        log(f"[{tag}] {shared} of {len(leaves)} param leaves on the mesh "
            "share the storage of the tensors drawn above")
        if shared != len(leaves):
            raise AssertionError(f"{tag}: the mesh copied the params")
    del params, leaves
    rng = np.random.default_rng(SEED + 8)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)  # warm
    prompts = make_prompts(rng, DS_REQUESTS, *DS_PROMPT, cfg.vocab_size)
    eng = serve.engine
    m = eng.obs.metrics
    before = {k: m.counter(k).value for k in
              ("serve.kernels.decode.fused", "serve.prefill_calls",
               "serve.prefill_chunks", "serve.preemptions")}
    itl0 = m.histogram("serve.itl_s").sum
    tokens0 = eng.tokens_generated
    kernels = (paged_mla_decode_attention, flash_attention, grouped_matmul)
    # the main path's run: every launch count starts at 0 here
    for k in kernels:
        k.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    outs, rids = serve_all(serve, prompts, DS_NEW)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    d = {k: m.counter(k).value - v for k, v in before.items()}
    steps, calls = int(d["serve.kernels.decode.fused"]), \
        int(d["serve.prefill_calls"])
    tokens = eng.tokens_generated - tokens0
    decode_s = m.histogram("serve.itl_s").sum - itl0
    decode_tokens = tokens - len(prompts)
    ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
    finished = sum(serve.state(r) == "finished" for r in rids)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda"
            else 0.0)
    if summary is not None:
        summary.update(decode_tok_s=decode_tokens / decode_s,
                       ttft_s=ttfts[len(ttfts) // 2], step_s=decode_s / steps,
                       tokens=outs, peak_gib=peak)
    log(f"[{tag}] {finished}/{len(prompts)} requests finished, {tokens} "
        f"tokens in {wall:.3f}s ({tokens / wall:.1f} tok/s overall), decode "
        f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f}s "
        f"({decode_tokens / decode_s:.1f} decode tok/s, "
        f"{decode_s / steps * 1e3:.1f} ms a step), median TTFT "
        f"{ttfts[len(ttfts) // 2]:.3f}s (all submitted at t=0), "
        f"prefill_calls={calls} prefill_chunks="
        f"{int(d['serve.prefill_chunks'])}, preemptions="
        f"{int(d['serve.preemptions'])}, peak device memory {peak:.1f} GiB")
    n = cfg.num_layers
    moe = sum(f == MOE_FFN for _, f in cfg.block_kinds())
    want = {"paged_mla_decode_attention": n * steps,
            "flash_attention": n * calls,
            "grouped_matmul": 3 * moe * (steps + calls)}
    log(f"[{tag}] launches {launches}; expected MLA decode {n} x {steps}"
        f", flash {n} x {calls}, grouped matmul 3 x {moe} x ({steps} + "
        f"{calls}) = {want['grouped_matmul']} ({3 * moe} per decode step "
        f"and per prefill call)")
    if finished != len(prompts) or any(len(o) != DS_NEW for o in outs):
        raise AssertionError(f"not every request finished with {DS_NEW} "
                             "tokens")
    if launches != want or steps == 0 or calls == 0:
        raise AssertionError(f"launch counts {launches} do not match {want}")
    return launches, serve, prompts


def phase_moe_identity(torch, np):
    """deepseek-v2-lite-16b in float32 at full width, DS_ID_LAYERS layers:
    HyperServe greedy tokens identical with the kernels and with the plain
    versions, fused and composed (no MLA decode kernel launched, flash and
    the grouped matmul still), and the Generator's; then through a
    preemption."""
    from repro_torch.configs.base import MOE_FFN, ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.paged_decode_attention import \
        paged_mla_decode_attention
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = dataclasses.replace(get_config(DS_ARCH), dtype="float32",
                              num_layers=DS_ID_LAYERS)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=512,
                       max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    prompts = make_prompts(np.random.default_rng(SEED + 9), 6, 100,
                           ID_PROMPT_MAX, cfg.vocab_size)
    kernels = (paged_mla_decode_attention, flash_attention, grouped_matmul)
    runs, counts = {}, {}
    for name, mode, path in (("fused", "auto", "fused"),
                             ("plain", "ref", "fused"),
                             ("composed", "auto", "composed")):
        for k in kernels:
            k.launches = 0
        ops.set_mode(mode)
        try:
            serve = HyperServe(cfg, params, device=DEVICE,
                               serve_cfg=dataclasses.replace(scfg,
                                                             kernels=path))
            runs[name], _ = serve_all(serve, prompts, ID_NEW)
        finally:
            ops.set_mode("auto")
        sync(torch)
        m = serve.engine.obs.metrics
        counts[name] = ({k.__name__: k.launches for k in kernels},
                        int(m.counter(f"serve.kernels.decode.{path}").value),
                        int(m.counter(f"serve.kernels.prefill.{path}").value))
    gen = Generator(cfg, params, max_len=ID_PROMPT_MAX + ID_NEW + 8,
                    device=DEVICE)
    runs["Generator"] = [gen.generate(
        torch.tensor([p], device=DEVICE), GenerateConfig(
            max_new_tokens=ID_NEW))[0, len(p):].tolist() for p in prompts]
    n = cfg.num_layers
    moe = sum(f == MOE_FFN for _, f in cfg.block_kinds())
    for name, want_mla in (("fused", True), ("composed", False)):
        got, steps, calls = counts[name]
        want = {"paged_mla_decode_attention": n * steps if want_mla else 0,
                "flash_attention": n * calls,
                "grouped_matmul": 3 * moe * (steps + calls)}
        log(f"[moe identity] {name}: launches {got}, expected {want} "
            f"({steps} decode steps, {calls} prefill calls)")
        if got != want or not steps or not calls:
            raise AssertionError(f"{name} launch counts {got} != {want}")
    if counts["plain"][0] != {k.__name__: 0 for k in kernels}:
        raise AssertionError(f"the plain run launched {counts['plain'][0]}")
    same = {name: runs[name] == runs["fused"] for name in runs}
    log(f"[moe identity] f32 {DS_ARCH} at full width, {n} layers ({moe} "
        f"MoE): {len(prompts)} requests x {ID_NEW} tokens, greedy tokens "
        f"identical to the fused kernels' run: {same}")
    for name, ok in same.items():
        if not ok:
            a, b = runs["fused"], runs[name]
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            j = next(j for j, (x, y) in enumerate(zip(a[i], b[i])) if x != y)
            raise AssertionError(f"{name}: request {i} diverges at token {j}"
                                 f": fused {a[i][j]} vs {b[i][j]}")
    phase_preempt(torch, np, cfg, params, tag="moe preempt")


def phase_ssm_serve(torch, np):
    """mamba2-370m at full width in bf16 through HyperServe: one ssd_scan
    launch per layer and prefill call, none per decode step (the decode
    recurrence is plain PyTorch); slot state only, so no preemption and no
    block taken."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = get_config(SSM_ARCH)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    scfg = ServeConfig(block_size=BS, num_blocks=SSM_NUM_BLOCKS,
                       max_blocks_per_req=TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)  # warm
    prompts = make_prompts(rng, SSM_REQUESTS, *SSM_PROMPT, cfg.vocab_size)
    eng = serve.engine
    m = eng.obs.metrics
    before = {k: m.counter(k).value for k in
              ("serve.kernels.decode.fused", "serve.prefill_calls",
               "serve.prefill_chunks", "serve.preemptions")}
    itl0 = m.histogram("serve.itl_s").sum
    tokens0 = eng.tokens_generated
    # the main path's run: the launch count starts at 0 here
    ssd_scan.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    outs, rids = serve_all(serve, prompts, SSM_NEW)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_scan.launches}
    d = {k: m.counter(k).value - v for k, v in before.items()}
    steps, calls = int(d["serve.kernels.decode.fused"]), \
        int(d["serve.prefill_calls"])
    tokens = eng.tokens_generated - tokens0
    decode_s = m.histogram("serve.itl_s").sum - itl0
    decode_tokens = tokens - len(prompts)
    ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
    finished = sum(serve.state(r) == "finished" for r in rids)
    st = serve.stats()
    log(f"[ssm serve] {SSM_ARCH} bf16 full width ({n_params / 1e6:.1f} M "
        f"params): {finished}/{len(prompts)} requests finished, {tokens} "
        f"tokens in {wall:.3f}s ({tokens / wall:.1f} tok/s overall), decode "
        f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f}s "
        f"({decode_tokens / decode_s:.1f} decode tok/s, "
        f"{decode_s / steps * 1e3:.1f} ms a step), median TTFT "
        f"{ttfts[len(ttfts) // 2]:.3f}s (all submitted at t=0), "
        f"prefill_calls={calls} prefill_chunks="
        f"{int(d['serve.prefill_chunks'])}, preemptions="
        f"{int(d['serve.preemptions'])}, block_occupancy="
        f"{st['block_occupancy']}")
    n = cfg.num_layers
    log(f"[ssm serve] launches {launches}; expected ssd_scan {n} x {calls} "
        f"= {n * calls} ({n} per prefill call, none in {steps} decode steps)")
    if finished != len(prompts) or any(len(o) != SSM_NEW for o in outs):
        raise AssertionError(f"not every request finished with {SSM_NEW} "
                             "tokens")
    if launches != {"ssd_scan": n * calls} or not steps or not calls:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{n} x {calls} prefill calls")
    if d["serve.preemptions"] or st["block_occupancy"] != 0.0:
        raise AssertionError("a pure-SSD model preempted or took a block")
    return launches, serve, prompts


def phase_ssm_generator(torch, np):
    """The Generator on mamba2-370m at full width in bf16: GEN_B prompts of
    GEN_S tokens, GEN_NEW greedy tokens; one ssd_scan launch per layer for
    the prefill (chunks of 256) and none for the decode steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = get_config(SSM_ARCH)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = Generator(cfg, params, max_len=GEN_CACHE, device=DEVICE)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        1, cfg.vocab_size, size=(GEN_B, GEN_S))).to(DEVICE)
    gen.generate(prompts[:, :64], GenerateConfig(max_new_tokens=4))  # warm
    # the main path's run: the launch count starts at 0 here
    ssd_scan.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    out = gen.generate(prompts, GenerateConfig(max_new_tokens=GEN_NEW))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_scan.launches}
    n, steps = cfg.num_layers, GEN_NEW - 1
    prefill_s, logits, pcaches = dense_prefill(torch, gen, prompts)
    decode_s = dense_decode(torch, gen, logits, pcaches, GEN_S, steps)
    del logits, pcaches
    log(f"[ssm Generator] {SSM_ARCH} bf16 full width: {GEN_B} prompts x "
        f"{GEN_S} tokens, {GEN_NEW} new each: generate {wall:.3f}s "
        f"({GEN_B * GEN_NEW / wall:.1f} new tok/s overall); timed alone: "
        f"prefill {prefill_s:.3f}s, decode {GEN_B * steps} tokens in {steps} "
        f"steps, {decode_s:.3f}s ({GEN_B * steps / decode_s:.1f} decode "
        f"tok/s)")
    log(f"[ssm Generator] launches {launches}; expected ssd_scan {n} (one "
        "prefill), none per decode step")
    new = out[:, GEN_S:]
    if (tuple(out.shape) != (GEN_B, GEN_S + GEN_NEW)
            or not torch.equal(out[:, :GEN_S], prompts)
            or not bool(((new >= 0) & (new < cfg.vocab_size)).all())):
        raise AssertionError(f"Generator output malformed: {out.shape}")
    if launches != {"ssd_scan": n}:
        raise AssertionError(f"launch counts {launches} != {n}")
    return launches, gen, prompts


def phase_ssm_identity(torch, np):
    """mamba2-370m in float32 at full width, SSM_ID_LAYERS layers: HyperServe greedy
    tokens identical with the kernel and with the plain versions, and to
    the Generator's (prompt by prompt: chunks of min(256, S) halved until
    they divide S, so down to 1)."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32",
                              num_layers=SSM_ID_LAYERS)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=SSM_NUM_BLOCKS,
                       max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    prompts = make_prompts(np.random.default_rng(SEED + 13), 6, 100,
                           ID_PROMPT_MAX, cfg.vocab_size)
    runs, counts = {}, {}
    for name, mode in (("kernel", "auto"), ("plain", "ref")):
        ssd_scan.launches = 0
        ops.set_mode(mode)
        try:
            serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE)
            runs[name], _ = serve_all(serve, prompts, ID_NEW)
        finally:
            ops.set_mode("auto")
        sync(torch)
        counts[name] = (ssd_scan.launches, serve.stats()["prefill_calls"])
    gen = Generator(cfg, params, max_len=ID_PROMPT_MAX + ID_NEW + 8,
                    device=DEVICE)
    runs["Generator"] = [gen.generate(
        torch.tensor([p], device=DEVICE), GenerateConfig(
            max_new_tokens=ID_NEW))[0, len(p):].tolist() for p in prompts]
    n = cfg.num_layers
    log(f"[ssm identity] launches (ssd_scan, prefill calls): kernel "
        f"{counts['kernel']}, plain {counts['plain']}; expected {n} per "
        "call with the kernel, 0 plain")
    if (counts["kernel"][0] != n * counts["kernel"][1]
            or not counts["kernel"][1] or counts["plain"][0]):
        raise AssertionError(f"ssd_scan launch counts {counts}")
    same = {name: runs[name] == runs["kernel"] for name in runs}
    log(f"[ssm identity] f32 {SSM_ARCH} at full width, {n} layers: "
        f"{len(prompts)} requests x {ID_NEW} tokens, greedy tokens identical "
        f"to the kernel's run: {same}")
    for name, ok in same.items():
        if not ok:
            a, b = runs["kernel"], runs[name]
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            j = next(j for j, (x, y) in enumerate(zip(a[i], b[i])) if x != y)
            raise AssertionError(f"{name}: request {i} diverges at token {j}"
                                 f": kernel {a[i][j]} vs {b[i][j]}")
    tier_runs(torch, cfg, params, "ssm preempt", scfg, prompts, ID_NEW,
              runs["kernel"], drive=lambda serve: forced_preemptions(
                  serve, prompts, ID_NEW, scfg.restore_lookahead))


def forced_preemptions(serve, prompts, max_new, lookahead, every=8, n=3):
    """Serve ``prompts``, preempting the last running request every
    ``every`` engine steps, ``n`` times (a pure-slot model never runs out
    of blocks, so its preemption is forced, as the reference's own test of
    the SSD family forces it), staging near-head restores after each as
    the tail of an engine step does; then join."""
    from repro_torch.serve.scheduler import RequestState, StepPlan
    rids = [serve.submit(p, max_new) for p in prompts]
    sched = serve.engine.scheduler
    done, i = 0, 0
    while done < n and sched.has_work():
        serve.step_once()
        i += 1
        runners = [r for r in sched.active
                   if r.state is RequestState.RUNNING]
        if runners and i % every == 0:
            sched._preempt(runners[-1], StepPlan())
            serve.engine._stage_restores(
                [r for r in list(sched.queue)[:lookahead]
                 if r.state is RequestState.PREEMPTED])
            done += 1
    out = serve.join()
    return [out[r] for r in rids]


def leading_nulls(table) -> int:
    """Window-freed entries of a block table: its prefix of null blocks."""
    n = 0
    while n < len(table) and table[n] == 0:
        n += 1
    return n


def phase_rg_serve(torch, np):
    """recurrentgemma-2b at full width in bf16 through HyperServe, fused:
    one paged_decode_attention per LOCAL_ATTN layer and decode step, one
    ragged_prefill_attention per LOCAL_ATTN layer and one rglru_scan per
    RG-LRU layer and prefill call, and no rglru_scan in a decode step (the
    recurrence step is plain PyTorch, as in the reference).  Every paged
    layer is windowed: blocks wholly below the window are freed, and a
    running request never holds more than ceil(window / block) + 1."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.scheduler import RequestState
    cfg = get_config(RG_ARCH)
    t0 = time.perf_counter()
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    sync(torch)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[hybrid serve] {RG_ARCH} bf16 full width: {n_params / 1e9:.3f} B "
        f"params drawn in {time.perf_counter() - t0:.1f}s")
    scfg = ServeConfig(block_size=BS, num_blocks=RG_NUM_BLOCKS,
                       max_blocks_per_req=RG_TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE)
    eng = serve.engine
    win = cfg.sliding_window
    if eng.layout.free_window != win or not eng.layout.has_slot_state:
        raise AssertionError(f"state layout {eng.layout}: want slot state "
                             f"and window freeing at {win}")
    rng = np.random.default_rng(SEED + 14)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)  # warm
    prompts = (make_prompts(rng, RG_LONG, win + BS + 1, RG_PROMPT[1],
                            cfg.vocab_size)
               + make_prompts(rng, RG_REQUESTS - RG_LONG, *RG_PROMPT,
                              cfg.vocab_size))
    m = eng.obs.metrics
    before = {k: m.counter(k).value for k in
              ("serve.kernels.decode.fused", "serve.prefill_calls",
               "serve.prefill_chunks", "serve.preemptions")}
    itl0 = m.histogram("serve.itl_s").sum
    tokens0 = eng.tokens_generated
    kernels = (paged_decode_attention, ragged_prefill_attention, rglru_scan)
    bound = -(-win // BS) + 1
    freed, live = {}, 0
    # the main path's run: every launch count starts at 0 here
    for k in kernels:
        k.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    rids = [serve.submit(p, RG_NEW) for p in prompts]
    while eng.scheduler.has_work():
        serve.step_once()
        for rid in rids:
            r = eng.scheduler.requests[rid]
            freed[rid] = max(freed.get(rid, 0), leading_nulls(r.table))
            if r.state is RequestState.RUNNING:
                live = max(live, r.live_blocks)
    sync(torch)
    wall = time.perf_counter() - t0
    outs = [serve.result(r) for r in rids]
    launches = {k.__name__: k.launches for k in kernels}
    d = {k: m.counter(k).value - v for k, v in before.items()}
    steps, calls = int(d["serve.kernels.decode.fused"]), \
        int(d["serve.prefill_calls"])
    tokens = eng.tokens_generated - tokens0
    decode_s = m.histogram("serve.itl_s").sum - itl0
    decode_tokens = tokens - len(prompts)
    ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
    finished = sum(serve.state(r) == "finished" for r in rids)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda"
            else 0.0)
    log(f"[hybrid serve] {finished}/{len(prompts)} requests finished "
        f"(prompts {min(map(len, prompts))}..{max(map(len, prompts))} "
        f"tokens, {sum(len(p) > win + BS for p in prompts)} above the "
        f"window + a block), {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s overall), decode {decode_tokens} "
        f"tokens in {steps} steps, {decode_s:.3f}s "
        f"({decode_tokens / decode_s:.1f} decode tok/s, "
        f"{decode_s / steps * 1e3:.1f} ms a step), median TTFT "
        f"{ttfts[len(ttfts) // 2]:.3f}s (all submitted at t=0), "
        f"prefill_calls={calls} prefill_chunks="
        f"{int(d['serve.prefill_chunks'])}, preemptions="
        f"{int(d['serve.preemptions'])}, peak device memory {peak:.1f} GiB")
    n_rg = sum(mx == "rglru" for mx, _ in cfg.block_kinds())
    n_at = cfg.num_layers - n_rg
    want = {"paged_decode_attention": n_at * steps,
            "ragged_prefill_attention": n_at * calls,
            "rglru_scan": n_rg * calls}
    log(f"[hybrid serve] launches {launches}; expected paged decode {n_at} x "
        f"{steps}, ragged prefill {n_at} x {calls}, rglru_scan {n_rg} x "
        f"{calls} ({n_at} + 0 per decode step, {n_at} + {n_rg} per prefill "
        "call)")
    log(f"[hybrid serve] window-freed blocks: {sum(freed.values())} over "
        f"{sum(v > 0 for v in freed.values())} requests; most live blocks of "
        f"a running request {live} (bound ceil({win} / {BS}) + 1 = {bound})")
    if finished != len(prompts) or any(len(o) != RG_NEW for o in outs):
        raise AssertionError(f"not every request finished with {RG_NEW} "
                             "tokens")
    if launches != want or steps == 0 or calls == 0:
        raise AssertionError(f"launch counts {launches} do not match {want}")
    if not sum(freed.values()) or live > bound:
        raise AssertionError(f"window freeing: {sum(freed.values())} blocks "
                             f"freed, {live} live > {bound}")
    return launches, serve, prompts


def phase_rg_generator(torch, np):
    """The Generator on recurrentgemma-2b at full width in bf16: GEN_B
    prompts of GEN_S tokens, GEN_NEW greedy tokens; one flash_attention per
    LOCAL_ATTN layer and one rglru_scan per RG-LRU layer for the prefill,
    one decode_attention per LOCAL_ATTN layer and decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models import model as M
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = get_config(RG_ARCH)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = Generator(cfg, params, max_len=GEN_CACHE, device=DEVICE)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
        1, cfg.vocab_size, size=(GEN_B, GEN_S))).to(DEVICE)
    gen.generate(prompts[:, :64], GenerateConfig(max_new_tokens=4))  # warm
    kernels = (flash_attention, decode_attention, rglru_scan)
    # the main path's run: every launch count starts at 0 here
    for k in kernels:
        k.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    out = gen.generate(prompts, GenerateConfig(max_new_tokens=GEN_NEW))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = GEN_NEW - 1
    n_rg = sum(mx == "rglru" for mx, _ in cfg.block_kinds())
    n_at = cfg.num_layers - n_rg
    prefill_s, logits, pcaches = dense_prefill(torch, gen, prompts)
    decode_s = dense_decode(torch, gen, logits, pcaches, GEN_S, steps)
    del logits, pcaches
    log(f"[hybrid Generator] {RG_ARCH} bf16 full width: {GEN_B} prompts x "
        f"{GEN_S} tokens, {GEN_NEW} new each: generate {wall:.3f}s "
        f"({GEN_B * GEN_NEW / wall:.1f} new tok/s overall); timed alone: "
        f"prefill {prefill_s:.3f}s, decode {GEN_B * steps} tokens in {steps} "
        f"steps, {decode_s:.3f}s ({GEN_B * steps / decode_s:.1f} decode "
        f"tok/s)")
    want = {"flash_attention": n_at, "decode_attention": n_at * steps,
            "rglru_scan": n_rg}
    log(f"[hybrid Generator] launches {launches}; expected {want} ({n_at} "
        f"flash + {n_rg} rglru_scan per prefill, {n_at} decode per step)")
    new = out[:, GEN_S:]
    if (tuple(out.shape) != (GEN_B, GEN_S + GEN_NEW)
            or not torch.equal(out[:, :GEN_S], prompts)
            or not bool(((new >= 0) & (new < cfg.vocab_size)).all())):
        raise AssertionError(f"Generator output malformed: {out.shape}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches


def phase_rg_identity(torch, np):
    """recurrentgemma-2b in float32 at full width, RG_ID_LAYERS layers: HyperServe
    greedy tokens identical with the kernels, the plain versions and the
    composed lowering on prompts up to RG_ID_PROMPT[1] tokens (two above
    the window); HyperServe's identical to the Generator's on prompts of
    at most the window, one exactly the window, so decode crosses it;
    then through a preemption that spills seat rows beside the pages."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = dataclasses.replace(get_config(RG_ARCH), dtype="float32",
                              num_layers=RG_ID_LAYERS)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    win = cfg.sliding_window
    scfg = ServeConfig(block_size=BS, num_blocks=1024,
                       max_blocks_per_req=RG_ID_TABLE_W, max_slots=ID_SLOTS,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    rng = np.random.default_rng(SEED + 15)
    prompts = (make_prompts(rng, 2, win + BS + 1, RG_ID_PROMPT[1],
                            cfg.vocab_size)
               + make_prompts(rng, 4, RG_ID_PROMPT[0], win, cfg.vocab_size))
    kernels = (paged_decode_attention, ragged_prefill_attention, rglru_scan,
               flash_attention, decode_attention)
    runs, counts = {}, {}
    for name, mode, path in (("fused", "auto", "fused"),
                             ("plain", "ref", "fused"),
                             ("composed", "auto", "composed")):
        for k in kernels:
            k.launches = 0
        ops.set_mode(mode)
        try:
            serve = HyperServe(cfg, params, device=DEVICE,
                               serve_cfg=dataclasses.replace(scfg,
                                                             kernels=path))
            runs[name], _ = serve_all(serve, prompts, ID_NEW)
        finally:
            ops.set_mode("auto")
        sync(torch)
        m = serve.engine.obs.metrics
        counts[name] = ({k.__name__: k.launches for k in kernels},
                        int(m.counter(f"serve.kernels.decode.{path}").value),
                        int(m.counter(f"serve.kernels.prefill.{path}").value))
    n_rg = sum(mx == "rglru" for mx, _ in cfg.block_kinds())
    n_at = cfg.num_layers - n_rg
    for name, fused in (("fused", True), ("composed", False)):
        got, steps, calls = counts[name]
        want = {"paged_decode_attention": n_at * steps if fused else 0,
                "ragged_prefill_attention": n_at * calls if fused else 0,
                "rglru_scan": n_rg * calls,
                "flash_attention": 0 if fused else n_at * calls,
                "decode_attention": 0 if fused else n_at * steps}
        log(f"[hybrid identity] {name}: launches {got}, expected {want} "
            f"({steps} decode steps, {calls} prefill calls)")
        if got != want or not steps or not calls:
            raise AssertionError(f"{name} launch counts {got} != {want}")
    if counts["plain"][0] != {k.__name__: 0 for k in kernels}:
        raise AssertionError(f"the plain run launched {counts['plain'][0]}")
    gprompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                for n in RG_GEN_PROMPTS]
    runs["HyperServe, prompts <= window"], _ = serve_all(HyperServe(
        cfg, params, serve_cfg=scfg, device=DEVICE), gprompts, ID_NEW)
    gen = Generator(cfg, params, max_len=win + ID_NEW + 8, device=DEVICE)
    runs["Generator, prompts <= window"] = [gen.generate(
        torch.tensor([p], device=DEVICE), GenerateConfig(
            max_new_tokens=ID_NEW))[0, len(p):].tolist() for p in gprompts]
    del gen
    pairs = (("plain", "fused"), ("composed", "fused"),
             ("Generator, prompts <= window",
              "HyperServe, prompts <= window"))
    same = {a: runs[a] == runs[b] for a, b in pairs}
    log(f"[hybrid identity] f32 {RG_ARCH} at full width, {cfg.num_layers} "
        f"layers: {len(prompts)} requests of {sorted(map(len, prompts))} "
        f"tokens x {ID_NEW} new, and {len(gprompts)} of {RG_GEN_PROMPTS} "
        f"against the Generator; greedy tokens identical: {same}")
    for a, b in pairs:
        if not same[a]:
            x, y = runs[b], runs[a]
            i = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
            j = next(j for j, (u, v) in enumerate(zip(x[i], y[i])) if u != v)
            raise AssertionError(f"{a}: request {i} diverges at token {j}: "
                                 f"{b} {x[i][j]} vs {y[i][j]}")
    phase_preempt(torch, np, cfg, params, tag="hybrid preempt", tiers=True)


def prefix_train(torch, cfg, shape, adamw, train_cfg, hook=None, mesh=None,
                 plan=None):
    """``trainer.train``'s loop through ``make_train_step(multimodal=True)``
    (the trainer, as the reference's, makes no prefix): each batch of the
    reference's synthetic corpus gets num_prefix_tokens conditioning frames
    of frontend_dim from a generator seeded by ``train_cfg.seed``, so that
    flash sees num_prefix_tokens + seq_len positions; on ``mesh`` under
    ``plan`` the state, the batches and the prefix (its rows,
    ``data.pipeline.place_prefix``) are DTensors.  Returns (params,
    history) as the trainer does."""
    from repro_torch.data.pipeline import (DataConfig, make_loader,
                                           place_prefix)
    from repro_torch.train import steps
    step = steps.make_train_step(cfg, adamw, multimodal=True, mesh=mesh,
                                 plan=plan)
    params, opt = steps.init_state(cfg, seed=train_cfg.seed, device=DEVICE,
                                   mesh=mesh, plan=plan)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=shape.seq_len,
                                    global_batch=shape.global_batch,
                                    seed=train_cfg.seed), DEVICE, mesh=mesh)
    g = torch.Generator(device=DEVICE).manual_seed(train_cfg.seed + 11)
    history = []
    t0 = time.perf_counter()
    for i, batch in zip(range(train_cfg.num_steps), loader):
        batch["prefix_embeds"] = place_prefix(torch.randn(
            shape.global_batch, cfg.num_prefix_tokens, cfg.frontend_dim,
            generator=g, device=DEVICE), mesh)
        params, opt, metrics = step(params, opt, batch)
        m = {k: float(v) for k, v in metrics.items()}
        m.update(step=i + 1, wall_s=time.perf_counter() - t0)
        history.append(m)
        if hook:
            hook(m)
    return params, history


def run_train(torch, cfg, shape, n_steps, hook=None, offload_cfg=None,
              obs=None, moe_dispatch="gshard", mesh=None, plan=None):
    """``n_steps`` train steps from SEED with AdamWConfig(total_steps=
    n_steps), as the reference's launcher builds it: through
    ``trainer.train`` (with ``offload_cfg``, ``obs``, ``moe_dispatch`` and a
    HyperShard ``mesh`` and ``plan`` when given), or, for an arch with a
    multimodal frontend (frontend_dim), through prefix_train (on ``mesh``
    too)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer
    adamw = AdamWConfig(total_steps=n_steps)
    train_cfg = trainer.TrainConfig(num_steps=n_steps, log_every=1,
                                    seed=SEED)
    if cfg.frontend_dim:
        return prefix_train(torch, cfg, shape, adamw, train_cfg, hook, mesh,
                            plan)
    return trainer.train(cfg, shape, adamw=adamw, train_cfg=train_cfg,
                         hook=hook, device=DEVICE, offload_cfg=offload_cfg,
                         obs=obs, moe_dispatch=moe_dispatch, mesh=mesh,
                         plan=plan)


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "grouped_matmul",
                 "grouped_matmul_bwd_dx", "grouped_matmul_bwd_dw",
                 "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")


def train_wrappers():
    """The wrappers whose launches a train step counts, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "grouped_matmul": gm.grouped_matmul,
            "grouped_matmul_bwd_dx": gm.grouped_matmul_bwd_dx,
            "grouped_matmul_bwd_dw": gm.grouped_matmul_bwd_dw,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd,
            "rglru_scan": rs.rglru_scan,
            "rglru_scan_bwd": rs.rglru_scan_bwd}


def train_launches_per_step(cfg, moe_dispatch="gshard"):
    """Each kernel's launches in one remat'd train step of ``cfg``: every
    attention layer (ATTN, MLA, LOCAL_ATTN) two flash forwards (the
    forward and its recompute) and one backward, every SSD layer two
    ssd_scan and one ssd_scan_bwd, every RG-LRU layer two rglru_scan and
    one rglru_scan_bwd.  Every MoE layer under ``moe_dispatch="ragged"``
    (models/moe.py's ragged_moe_apply: w_gate, w_up and w_down each one
    grouped_matmul through GroupedMatmulFn) six grouped_matmul (the
    forward and its recompute) and three of each backward kernel, dx and
    dw; under gshard none (its experts are einsums)."""
    from repro_torch.configs.base import MOE_FFN, RGLRU, SSD
    kinds = [m for m, _ in cfg.block_kinds()]
    a = sum(m not in (SSD, RGLRU) for m in kinds)
    n_ssd, n_rg = kinds.count(SSD), kinds.count(RGLRU)
    moe = (sum(f == MOE_FFN for _, f in cfg.block_kinds())
           if moe_dispatch == "ragged" else 0)
    return {"flash_attention": 2 * a, "flash_attention_bwd": a,
            "grouped_matmul": 6 * moe, "grouped_matmul_bwd_dx": 3 * moe,
            "grouped_matmul_bwd_dw": 3 * moe, "ssd_scan": 2 * n_ssd,
            "ssd_scan_bwd": n_ssd, "rglru_scan": 2 * n_rg,
            "rglru_scan_bwd": n_rg}


def phase_train(torch, np, arch="qwen2-0.5b", layers=None, batch=TRAIN_B,
                seq=TRAIN_S, n_steps=TRAIN_STEPS, tag="train",
                offload_cfg=None, obs=None, record=None,
                moe_dispatch="gshard", mesh=None, plan=None, summary=None):
    """``arch``'s train step at full width (``layers`` of its layers, all
    when None; random weights from a seed) in bf16 through
    ``repro_torch.train.trainer.train`` (an arch with a multimodal frontend
    through ``make_train_step(multimodal=True)`` after seeded conditioning
    frames: prefix_train), MoE under ``moe_dispatch`` (the reference's
    default gshard, or ragged, as ``launch/train.py --moe-dispatch``
    passes it): ``n_steps`` steps of ``batch`` x ``seq`` tokens of the
    reference's synthetic corpus.  Every step: loss and grad norm finite,
    and exactly train_launches_per_step's launches of every train kernel
    (per attention layer two flash forwards and one backward, per SSD or
    RG-LRU layer two scans and one scan backward, per MoE layer under
    ragged six grouped matmuls and three of each of its backward kernels,
    none under gshard).  Step wall
    time (each step ends in a read of its metrics, which waits for the
    card), training tokens/s and the peak of allocated device memory, and
    the memory allocated when the peak is reset (what earlier phases left).
    ``offload_cfg`` and ``obs`` go to the trainer; ``record`` (a list)
    gets each step's (metrics, launches, memory allocated after the step
    and its offload leg); ``mesh`` and ``plan`` train it on a HyperShard
    mesh; ``summary`` (a dict) gets the median step, tok/s and peak."""
    from repro_torch.configs.base import ShapeConfig, get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig(f"train_{seq}_b{batch}", seq, batch, "train")
    n = cfg.num_layers
    wrappers = train_wrappers()
    want = train_launches_per_step(cfg, moe_dispatch)
    seen, last = [], {k: 0 for k in TRAIN_KERNELS}

    def hook(m):
        now = {k: wrappers[k].launches for k in TRAIN_KERNELS}
        step = {k: now[k] - last[k] for k in TRAIN_KERNELS}
        seen.append((m, step))
        if record is not None:
            record.append((m, step, torch.cuda.memory_allocated()
                           if DEVICE == "cuda" else 0))
        log(f"[{tag}] step {m['step']}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e} wall {m['wall_s']:.3f}s, "
            "launches: " + ", ".join(f"{k} {v}" for k, v in step.items()
                                     if v or want[k]))
        last.update(now)
    if DEVICE == "cuda":
        left = torch.cuda.memory_allocated()
        gc.collect()        # earlier phases' engines wait in reference cycles
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"[{tag}] allocated at the peak's reset (left by earlier "
            f"phases): {left / 2 ** 30:.3f} GiB, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB after a "
            "garbage collection (torch.cuda.memory_allocated)")
    # this path's run: every launch count starts at 0 here
    for w in wrappers.values():
        w.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    params, hist = run_train(torch, cfg, shape, n_steps, hook, offload_cfg,
                             obs, moe_dispatch, mesh, plan)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {k: wrappers[k].launches for k in TRAIN_KERNELS}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else float("nan"))
    del params
    walls = [m["wall_s"] for m, _ in seen]
    step_s = sorted(b - a for a, b in zip(walls, walls[1:]))
    med = step_s[len(step_s) // 2]
    rows = (f"{batch} x ({cfg.num_prefix_tokens} prefix + {seq}) positions"
            if cfg.frontend_dim else f"{batch} x {seq} tokens")
    log(f"[{tag}] {arch} bf16 full width, {n} layers, {moe_dispatch} "
        f"dispatch, {n_steps} steps of {rows}: {wall:.3f}s in all, first step "
        f"{walls[0]:.3f}s (with warm-up), median of steps 2-{n_steps} "
        f"{med:.4f}s ({batch * seq / med:.1f} train tok/s), range "
        f"{step_s[0]:.4f}..{step_s[-1]:.4f}s; peak device memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    if summary is not None:
        summary.update(median_s=med, tok_s=batch * seq / med, peak_gib=peak,
                       first_s=walls[0])
    log(f"[{tag}] launches {launches}; expected per step "
        + ", ".join(f"{k} {v}" for k, v in want.items())
        + f", {n_steps} steps")
    if len(hist) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            for m, _ in seen):
        raise AssertionError(f"{tag}: a step's loss or grad norm is not "
                             "finite")
    if any(step != want for _, step in seen) or launches != {
            k: v * n_steps for k, v in want.items()}:
        raise AssertionError(f"{tag} launch counts {launches}, per step "
                             f"{[x[1] for x in seen]}: expected {want} a "
                             "step")
    return launches


def phase_train_profile(torch, arch="qwen2-0.5b", layers=None,
                        batch=TRAIN_B, seq=TRAIN_S, tag="train profile",
                        moe_dispatch="gshard", shares=None):
    """torch.profiler over one train step (after a warm step) of the same
    configuration as phase_train's: device busy, idle share and top device
    items (and report_profile's ``shares``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params, opt = steps.init_state(cfg, seed=SEED, device=DEVICE)
    step = steps.make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS),
                                 moe_dispatch=moe_dispatch)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch,
                                    seed=SEED), DEVICE)
    params, opt, _ = step(params, opt, next(loader))          # warm
    batch = next(loader)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        sync(torch)
        wall = time.perf_counter() - t0
    report_profile(tag, [("train step", prof, wall, 1)], shares)


def adam_step_bound(b1: float, b2: float, t: int) -> float:
    """Largest |m_hat / sqrt(v_hat)| AdamW's step ``t`` can take for any
    gradients (Cauchy-Schwarz over the moments' weights):
    (1 - b1) / (1 - b1^t) x sqrt(sum_{j<t} (b1^2 / b2)^j) x
    sqrt((1 - b2^t) / (1 - b2)); 1 at t = 1."""
    return ((1 - b1) / (1 - b1 ** t)
            * sum((b1 * b1 / b2) ** j for j in range(t)) ** 0.5
            * ((1 - b2 ** t) / (1 - b2)) ** 0.5)


def phase_train_identity(torch, np, arch="qwen2-0.5b", layers=None,
                         batch=TRAIN_ID_B, seq=TRAIN_ID_S,
                         n_steps=TRAIN_ID_STEPS, tag="train identity",
                         moe_dispatch="gshard"):
    """``arch`` at full width (``layers`` of its layers, all when None),
    float32: ``n_steps`` train steps of ``batch`` x ``seq`` tokens from one
    seed (MoE under ``moe_dispatch``, gshard by default; under "ragged" the
    kernels' run must launch both grouped matmul backward kernels 3 times
    per MoE layer and step; a multimodal arch after the same seeded
    conditioning frames, prefix_train), once with the kernels and once
    with the plain versions (``ops.set_mode("ref")``, autograd through the
    plain forward).  Losses and grad norms agree to TRAIN_ID_REL at every
    step.  The params after the steps differ by at
    most what AdamW allows: a weight moves by lr_t x (its Adam ratio + wd x
    p) a step, the ratio at most adam_step_bound, so two runs whose
    gradients differ only in rounding (a gradient near zero may flip sign,
    and Adam's first steps are close to sign(g) lr) part by at most sum_t
    2 lr_t bound_t, plus an f32 rounding a step; the largest difference
    and how many weights come near the bound are printed."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig, schedule
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig("train_identity", seq, batch, "train")
    adamw = AdamWConfig(total_steps=n_steps)
    from repro_torch.configs.base import MOE_FFN
    from repro_torch.kernels import grouped_matmul as gm
    bwd = (gm.grouped_matmul_bwd_dx, gm.grouped_matmul_bwd_dw)
    n0 = [k.launches for k in bwd]
    runs = {}
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            runs[mode] = run_train(torch, cfg, shape, n_steps,
                                   moe_dispatch=moe_dispatch)
        finally:
            ops.set_mode("auto")
        torch.cuda.empty_cache()
    got = [k.launches - n for k, n in zip(bwd, n0)]
    moe = sum(f == MOE_FFN for _, f in cfg.block_kinds())
    want = [3 * moe * n_steps if moe_dispatch == "ragged" else 0] * 2
    if got != want:
        raise AssertionError(f"{tag}: grouped_matmul_bwd dx/dw launches "
                             f"{got}, expected {want}")
    if moe_dispatch == "ragged":
        log(f"[{tag}] ragged dispatch: grouped_matmul_bwd_dx and _dw "
            f"launched {got} times (3 x {moe} MoE layers x {n_steps} steps, "
            "the kernels' run; none in the plain versions' run)")
    worst = 0.0
    for a, b in zip(runs["auto"][1], runs["ref"][1]):
        for k in ("loss", "grad_norm"):
            rel = abs(a[k] - b[k]) / max(1.0, abs(b[k]))
            worst = max(worst, rel)
        log(f"[{tag}] step {a['step']}: loss {a['loss']:.7f} vs "
            f"plain {b['loss']:.7f}, grad_norm {a['grad_norm']:.6f} vs "
            f"{b['grad_norm']:.6f}")
    lrs = [float(schedule(adamw, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, n_steps + 1)]
    bound = sum(2 * lr * adam_step_bound(adamw.b1, adamw.b2, t)
                for t, lr in enumerate(lrs, 1))
    pa = dict(tree_flatten_with_path(runs["auto"][0]))
    pb = dict(tree_flatten_with_path(runs["ref"][0]))
    diffs = {k: (pa[k] - pb[k]).abs() for k in pa}
    # the decay multiplies a difference by 1 - lr wd < 1, so it only
    # shrinks it; each run rounds its f32 update once a step, an ulp of the
    # largest weight at most
    big = max(t.abs().max().item() for t in pb.values())
    bound += 2 * n_steps * big * 2.0 ** -23
    dmax = max(d.max().item() for d in diffs.values())
    near = sum(int((d > 0.5 * bound).sum()) for d in diffs.values())
    moved = sum(int((d > 0).sum()) for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    log(f"[{tag}] {arch} f32 full width, {cfg.num_layers} layers, "
        f"{n_steps} steps of {batch} x {seq}"
        + (f" after {cfg.num_prefix_tokens} prefix frames"
           if cfg.frontend_dim else "")
        + ", kernels vs plain versions: "
        f"losses and grad norms within {worst:.3e} relative (limit "
        f"{TRAIN_ID_REL}); params after the steps: max |diff| {dmax:.3e} "
        f"against AdamW's bound {bound:.3e} (lr_t {lrs}), {moved} of "
        f"{total} weights differ at all, {near} by more than half the "
        "bound")
    if not worst <= TRAIN_ID_REL or not dmax <= bound:
        raise AssertionError(f"{tag} failed: kernels and plain versions "
                             "part")


POOL_B, POOL_TOKENS = 4, 131072
POOL_HOT, POOL_BLOCK = 8192, 2048
POOL_ABS = 1e-4


def phase_pool(torch):
    """HyperOffload's KV pool at a long context, f32, at qwen2-0.5b's
    attention shapes (14 heads over 2 kv heads of 64): POOL_B rows,
    POOL_TOKENS tokens appended one at a time, a hot window of POOL_HOT
    on the card and every older window archived to pinned host memory in
    blocks of POOL_BLOCK (60 blocks, ~503 MB).  ``pool.attend(q)`` streams
    the blocks to the card and merges them by log-sum-exp; it must match
    the port's decode_attention kernel over the flat cache within POOL_ABS.
    The attend's wall (after a warm-up attend) and the host->card rate it
    reached (archive bytes over that wall)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.kvcache import KVCachePool, KVPoolConfig
    from repro_torch.kernels.decode_attention import decode_attention
    cfg = get_config("qwen2-0.5b")
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    k = torch.randn(POOL_B, POOL_TOKENS, KV, D, generator=g,
                    device=DEVICE) * 0.3
    v = torch.randn(POOL_B, POOL_TOKENS, KV, D, generator=g,
                    device=DEVICE) * 0.3
    q = torch.randn(POOL_B, H, D, generator=g, device=DEVICE) * 0.5
    pool = KVCachePool(cfg, POOL_B, POOL_TOKENS, KVPoolConfig(
        hot_window=POOL_HOT, block=POOL_BLOCK, dtype="float32"),
        device=DEVICE)
    sync(torch)
    t0 = time.perf_counter()
    for t in range(POOL_TOKENS):
        pool.append(k[:, t:t + 1], v[:, t:t + 1])
    sync(torch)
    t_append = time.perf_counter() - t0
    pool.attend(q)
    sync(torch)
    t0 = time.perf_counter()
    got = pool.attend(q)
    sync(torch)
    wall = time.perf_counter() - t0
    want = decode_attention(q[:, None], k, v, torch.full(
        (POOL_B,), POOL_TOKENS, dtype=torch.int32, device=DEVICE))[:, 0]
    err = float((got - want).abs().max())
    blocks = len(pool.archive_k)
    host = pool.host_bytes()
    log(f"[pool] f32 {POOL_B} rows x {POOL_TOKENS} tokens at (14, 2, 64), "
        f"hot window {POOL_HOT} on the card ({pool.hbm_bytes() / 1e6:.1f} "
        f"MB), {blocks} archived blocks of {POOL_BLOCK} in pinned host "
        f"memory ({host / 1e6:.1f} MB); appends {t_append:.3f}s; attend "
        f"{1e3 * wall:.3f} ms, host->card {host / wall / 1e9:.3f} GB/s over "
        f"its wall; max |attend - decode_attention kernel| {err:.3e} "
        f"(limit {POOL_ABS})")
    if blocks != (POOL_TOKENS - 1) // POOL_HOT * (POOL_HOT // POOL_BLOCK):
        raise AssertionError(f"pool: {blocks} archived blocks")
    if not err <= POOL_ABS:
        raise AssertionError(f"pool: attend differs by {err}")


OFF_STEPS = 4
# bf16 runs of the same code differ: the bf16 flash backward adds dQ by
# f32 atomics in no fixed order, and a flipped bf16 rounding of dq moves
# the grad norm by ~1e-4 relative at step 2 (three runs of one state on an
# H100 80GB HBM3 at 700 W read 8.6500, 8.6503 and 8.6509; PERF.md).  So
# the offloaded run is held to a quarter of a bf16 step (2^-8 / 4) of the
# run without offload, its spread beside it, and the legs bit for bit.
OFF_REL = 2 ** -8 / 4


def phase_train_offload(torch, np):
    """qwen2-0.5b's train step at full width (24 layers, bf16, 4 x 4096)
    with its params and optimizer state in pinned host memory between
    steps (``OffloadConfig(params_on_host=True, opt_state_on_host=True)``:
    every leaf of rank >= 2; HyperOffload's fetch and offload legs around
    each step), OFF_STEPS steps, beside two runs of the same OFF_STEPS
    steps without offload: loss and grad norm within OFF_REL relative of
    the first, the train launch counts exact every step (phase_train).
    Then the legs alone on a fresh host state: fetch, offload, fetch
    again, the two fetched states equal bit for bit.  Logged: the
    ``train.fetch`` / ``train.offload`` spans (host time: the legs'
    copies are asynchronous), the bytes a leg moves and each leg's rate
    between syncs, and the memory allocated after a step's offload leg
    against after a step without offload."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.offload import OffloadConfig
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.obs import Observability
    from repro_torch.train import steps
    both = OffloadConfig(params_on_host=True, opt_state_on_host=True)
    plain, plain2, offl = [], [], []
    for tag, rec in (("plain", plain), ("plain again", plain2)):
        phase_train(torch, np, n_steps=OFF_STEPS,
                    tag=f"train offload, {tag}", record=rec)
    obs = Observability()
    obs.trace.enable()
    phase_train(torch, np, n_steps=OFF_STEPS, tag="train offload",
                offload_cfg=both, obs=obs, record=offl)

    def rel(a, b):
        return max(abs(x[0][k] - y[0][k]) / max(1.0, abs(x[0][k]))
                   for x, y in zip(a, b) for k in ("loss", "grad_norm"))
    spans = {n: [e["dur"] / 1e3 for e in obs.trace.events()
                 if e.get("ph") == "X" and e["name"] == n]
             for n in ("train.fetch", "train.offload", "train.step")}
    cfg = get_config("qwen2-0.5b")
    host = steps.init_state(cfg, seed=SEED, device=DEVICE,
                            offload_cfg=both)
    nbytes = steps.state_nbytes(*host, both)
    dev_t = torch.device(DEVICE)
    sync(torch)
    t0 = time.perf_counter()
    dev = steps.fetch_state(*host, both, dev_t)
    sync(torch)
    t_fetch = time.perf_counter() - t0
    del host
    t0 = time.perf_counter()
    host = steps.offload_state(*dev, both)
    sync(torch)
    t_off = time.perf_counter() - t0
    again = steps.fetch_state(*host, both, dev_t)
    exact = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_path(dev), tree_flatten_with_path(again)))
    pinned = all(t.is_pinned() for _, t in tree_flatten_with_path(host)
                 if t.dim() >= 2)
    del dev, host, again
    gib = 2 ** 30
    diff, spread = rel(plain, offl), rel(plain, plain2)
    log(f"[train offload] {OFF_STEPS} steps with params and optimizer state "
        f"on the host against {OFF_STEPS} without: max relative difference "
        f"of loss and grad norm {diff:.3e} (limit {OFF_REL:.3e}); two runs "
        f"without offload differ by {spread:.3e}; spans (ms, host time) "
        + "; ".join(f"{n} " + ", ".join(f"{d:.3f}" for d in ds)
                    for n, ds in spans.items()))
    log(f"[train offload] a leg moves {nbytes / 1e9:.4f} GB (the rank >= 2 "
        f"leaves of params, mu and nu, pinned on the host: {pinned}): fetch "
        f"alone {t_fetch:.4f}s ({nbytes / t_fetch / 1e9:.3f} GB/s), offload "
        f"alone {t_off:.4f}s ({nbytes / t_off / 1e9:.3f} GB/s), fetched "
        f"again bit for bit: {exact}; memory allocated after each step, "
        "GiB: without offload "
        + ", ".join(f"{m / gib:.3f}" for _, _, m in plain)
        + "; after its offload leg "
        + ", ".join(f"{m / gib:.3f}" for _, _, m in offl))
    if not diff <= OFF_REL:
        raise AssertionError(f"train offload: the run differs by {diff}")
    if not exact or (DEVICE == "cuda" and not pinned):
        raise AssertionError("train offload: a leg changed the state or left "
                             "it in pageable memory")
    if len(spans["train.fetch"]) != OFF_STEPS or len(
            spans["train.offload"]) != OFF_STEPS:
        raise AssertionError(f"train offload: spans {spans}")
    if DEVICE == "cuda" and not all(b[2] < a[2]
                                    for a, b in zip(plain, offl)):
        raise AssertionError("train offload: the offloaded state still "
                             "takes the card's memory")


# the HyperShard mesh phase: qwen2-0.5b on a one-rank NCCL mesh, the f32
# identity at phase 25's shapes and limits, then MESH_STEPS bf16 steps of
# TRAIN_B x TRAIN_S against phase 23's first MESH_STEPS steps within
# MESH_BF16_REL (phase 38's allowance for the bf16 backward's dQ atomics);
# an f32 distance above MESH_F32_NOTE is logged as a finding
MESH_STEPS = 4
MESH_BF16_REL = 2 ** -8 / 4
MESH_F32_NOTE = 1e-6


def phase_train_mesh(torch, np, mesh, train_record, train_summary):
    """HyperShard on the card: qwen2-0.5b trained on ``mesh``, the (1, 1)
    mesh of :func:`one_rank_group`, under ``ShardingPlan()`` (fsdp_tp)
    through ``trainer.train``:
    params, moments and batches are DTensors, the step runs under the
    mesh, and flash's forward and backward kernels run under
    ``local_map``.  First the f32 identity at phase 25's shapes (all 24
    layers, TRAIN_ID_B x TRAIN_ID_S, TRAIN_ID_STEPS steps) against the same
    run without a mesh: losses and grad norms within TRAIN_ID_REL, params
    within AdamW's bound; the distance is printed.  Then MESH_STEPS bf16
    steps at full width (TRAIN_B x TRAIN_S) with phase_train's exact
    launch counts (48 flash forwards and 24 backwards a step), loss and
    grad norm within MESH_BF16_REL of phase 23's first MESH_STEPS steps in
    this process, the step wall, tok/s and peak printed beside phase 23's.
    Nothing here is caught."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.hypershard import ShardingPlan
    plan = ShardingPlan()
    log(f"[train mesh] mesh {tuple(mesh.shape)} "
        f"{tuple(mesh.mesh_dim_names)} on {mesh.device_type}, "
        f"{dist.get_backend()}, "
        f"plan {plan}")
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    mesh_train_identity(torch, cfg, ShapeConfig(
        "train_identity", TRAIN_ID_S, TRAIN_ID_B, "train"), TRAIN_ID_STEPS,
        mesh, plan, "train mesh")
    rec, summary = [], {}
    launches = phase_train(torch, np, batch=TRAIN_B, seq=TRAIN_S,
                           n_steps=MESH_STEPS, tag="train mesh",
                           record=rec, mesh=mesh, plan=plan,
                           summary=summary)
    base = train_record[:MESH_STEPS]
    rel = max(abs(a[0][k] - b[0][k]) / max(1.0, abs(b[0][k]))
              for a, b in zip(rec, base) for k in ("loss", "grad_norm"))
    log(f"[train mesh] bf16 {TRAIN_B} x {TRAIN_S} on the (1, 1) mesh "
        "against phase "
        f"23 (train) in this process: loss and grad norm within "
        f"{rel:.3e} relative (limit {MESH_BF16_REL:.3e}); median step "
        f"{summary['median_s']:.4f}s vs {train_summary['median_s']:.4f}s"
        f", {summary['tok_s']:.1f} vs {train_summary['tok_s']:.1f} train "
        f"tok/s, peak {summary['peak_gib']:.2f} vs "
        f"{train_summary['peak_gib']:.2f} GiB, first step "
        f"{summary['first_s']:.3f}s vs {train_summary['first_s']:.3f}s")
    if len(rec) != MESH_STEPS or not rel <= MESH_BF16_REL:
        raise AssertionError(f"train mesh: bf16 run differs by {rel}")
    return launches


def mesh_train_identity(torch, cfg, shape, n_steps, mesh, plan, tag,
                        moe_dispatch="gshard"):
    """The f32 identity of a mesh train run: ``n_steps`` steps of ``cfg``
    (float32) at ``shape`` through ``trainer.train`` without a mesh and on
    ``mesh`` under ``plan``: losses and grad norms within TRAIN_ID_REL,
    params within AdamW's bound; the distance is printed (above
    MESH_F32_NOTE it is a finding)."""
    from repro_torch.core.meshctx import full_tensor
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.optim.adamw import AdamWConfig, schedule
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        params, hist = run_train(torch, cfg, shape, n_steps,
                                 moe_dispatch=moe_dispatch, mesh=m,
                                 plan=plan if m else None)
        runs[name] = ({k: full_tensor(t) for k, t in
                       tree_flatten_with_path(params)}, hist)
        del params
        torch.cuda.empty_cache()
    worst = max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
                for a, b in zip(runs["mesh"][1], runs["plain"][1])
                for k in ("loss", "grad_norm"))
    adamw = AdamWConfig(total_steps=n_steps)
    lrs = [float(schedule(adamw, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, n_steps + 1)]
    pa, pb = runs["mesh"][0], runs["plain"][0]
    big = max(t.abs().max().item() for t in pb.values())
    bound = (sum(2 * lr * adam_step_bound(adamw.b1, adamw.b2, t)
                 for t, lr in enumerate(lrs, 1))
             + 2 * n_steps * big * 2.0 ** -23)
    dmax = max((pa[k] - pb[k]).abs().max().item() for k in pb)
    moved = sum(int((pa[k] != pb[k]).sum()) for k in pb)
    log(f"[{tag}] f32 identity, {cfg.name} {cfg.num_layers} layers, "
        f"{moe_dispatch if cfg.moe else 'dense'}, {n_steps} steps of "
        f"{shape.global_batch} x {shape.seq_len}, "
        f"{tuple(mesh.shape)} mesh vs no mesh: losses and grad norms within "
        f"{worst:.3e} relative (limit {TRAIN_ID_REL}; a distance above "
        f"{MESH_F32_NOTE} is a finding), params max |diff| {dmax:.3e} "
        f"against AdamW's bound {bound:.3e}, {moved} weights differ at "
        "all; losses "
        + ", ".join(f"{a['loss']:.7f}/{b['loss']:.7f}" for a, b in
                    zip(runs["mesh"][1], runs["plain"][1])))
    if not worst <= TRAIN_ID_REL or not dmax <= bound:
        raise AssertionError(f"{tag}: the f32 run on the mesh parts from "
                             "the run without one")


@contextlib.contextmanager
def one_rank_group():
    """A one-rank process group (NCCL on the card; initialised from a file
    in a temporary directory: no port, no network) and the (1, 1) mesh of
    ``make_host_mesh`` over it, for phases 38a-38d; the group is
    destroyed when they are done."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh((1, 1))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


# phase 38b's f32 identities on the mesh, each against the same engine
# without one: qwen2-0.5b (phase 10's config and prompts; phase 11's forced
# preemption, host tier), mamba2-370m (phase 17's) and recurrentgemma-2b
# (MESH_RG_PROMPTS prompts, two past the window, RG_ID_TABLE_W blocks a
# table); qwen2 at MESH_QWEN_ID_LAYERS of its 24 layers (cut for time:
# the mesh phases' host cost doubles on a slow host; its layers are all
# alike), the other two at phases 18 and 22's depths; phase 38d's
# composed qwen2 identity at the same depth
MESH_RG_PROMPTS = 4
MESH_QWEN_ID_LAYERS = 8


def mesh_identity(torch, np, tag, arch, scfg, prompts, mesh, layers=None,
                  kernels="fused"):
    """One f32 identity of phases 38b-38d: ``arch`` at full width
    (``layers`` of its layers, all when None) through HyperServe without a
    mesh (fused) and on ``mesh`` under the ``kernels`` lowering, greedy
    tokens identical (the same kernels on the same tensors; composed, the
    gathered pages through the dense ones), and on the mesh exactly the
    serving launches ``serve_launch_want`` gives for its decode steps and
    prefill calls.  Returns (launches, params, cfg)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    wrappers = serve_wrappers()
    runs, launches = {}, {}
    for name, m in (("no mesh", None), ("mesh", mesh)):
        for k in wrappers.values():
            k.launches = 0
        serve = HyperServe(cfg, params, device=DEVICE, mesh=m,
                           serve_cfg=dataclasses.replace(
                               scfg, kernels=kernels if m else "fused"))
        runs[name], _ = serve_all(serve, prompts, ID_NEW)
        sync(torch)
        launches[name] = {k: w.launches for k, w in wrappers.items()
                          if w.launches}
    m = serve.engine.obs.metrics
    steps = int(m.counter(f"serve.kernels.decode.{kernels}").value)
    calls = int(m.counter("serve.prefill_calls").value)
    want = serve_launch_want(cfg, steps, calls, kernels)
    log(f"[{tag}] f32 {arch} at full width, {cfg.num_layers} layers, "
        f"{len(prompts)} requests x {ID_NEW} tokens: mesh ({kernels}) "
        f"tokens identical to no mesh (fused): "
        f"{runs['mesh'] == runs['no mesh']}; launches on the "
        f"mesh {launches['mesh']}, expected {want} ({steps} decode steps, "
        f"{calls} prefill calls; no mesh {launches['no mesh']})")
    if runs["mesh"] != runs["no mesh"]:
        a, b = runs["no mesh"], runs["mesh"]
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        j = next(j for j, (x, y) in enumerate(zip(a[i], b[i])) if x != y)
        raise AssertionError(f"{tag}: request {i} diverges at token {j}: "
                             f"{a[i][j]} without the mesh, {b[i][j]} on it")
    if launches["mesh"] != want or not steps or not calls:
        raise AssertionError(f"{tag}: launches {launches['mesh']} != {want}")
    return launches["mesh"], params, cfg


def phase_serve_mesh(torch, np, mesh, serve_summary):
    """Phase 38b, HyperServe on the (1, 1) NCCL mesh of phase 38a under
    ``ShardingPlan(fsdp=None)``: params and pool leaves DTensors, both
    steps under the mesh, the paged kernels and the scans under
    ``local_map``.  qwen2-0.5b bf16, all 24 layers, phase 4's config and
    requests with exact launches, decode tok/s, median TTFT and the
    decode-step wall beside phase 4's in this process, and a profile of a
    prefill call and decode steps; then the f32 identities of
    ``mesh_identity`` (qwen2-0.5b also preempted), and the kernel rows of
    the four serving kernels on DTensor inputs (:func:`mesh_kernel_rows`).
    Nothing here is caught.  Returns (the launches of each run, rows)."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.core.hypershard import ShardingPlan
    from repro_torch.serve.api import HyperServe
    plan = ShardingPlan(fsdp=None)
    log(f"[serve mesh] mesh {tuple(mesh.shape)} "
        f"{tuple(mesh.mesh_dim_names)} on {mesh.device_type}, plan {plan}")
    summary = {}
    launches, serve, prompts = phase_serve(torch, np, mesh, summary,
                                           "serve mesh")
    b = serve_summary
    log(f"[serve mesh] against phase 4 (serve) in this process: decode "
        f"{summary['decode_tok_s']:.1f} vs {b['decode_tok_s']:.1f} tok/s, "
        f"median TTFT {summary['ttft_s']:.3f}s vs {b['ttft_s']:.3f}s, "
        f"decode-step wall {summary['step_s'] * 1e3:.3f} vs "
        f"{b['step_s'] * 1e3:.3f} ms ({summary['step_s'] / b['step_s']:.2f}"
        f"x); bf16 tokens identical to phase 4's: "
        f"{summary['tokens'] == b['tokens']}")
    phase_profile(torch, serve, prompts, tag="serve mesh profile")
    del serve
    torch.cuda.empty_cache()
    runs = {"qwen2-0.5b mesh": launches}
    id_scfg = ServeConfig(block_size=BS, num_blocks=512,
                          max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                          prefill_chunk=PRE_C, prefill_batch=PRE_P)
    vocab = get_config("qwen2-0.5b").vocab_size
    _, params, cfg = timed(
        "serve mesh identity qwen2-0.5b", lambda: mesh_identity(
            torch, np, "serve mesh identity", "qwen2-0.5b", id_scfg,
            make_prompts(np.random.default_rng(SEED + 2), 6, 100,
                         ID_PROMPT_MAX, vocab), mesh,
            layers=MESH_QWEN_ID_LAYERS))
    timed("serve mesh preempt", phase_preempt_mesh, torch, np, cfg, params,
          mesh)
    del params
    torch.cuda.empty_cache()
    runs[f"{SSM_ARCH} mesh"], params, _ = mesh_identity(
        torch, np, "serve mesh identity", SSM_ARCH,
        dataclasses.replace(id_scfg, num_blocks=SSM_NUM_BLOCKS),
        make_prompts(np.random.default_rng(SEED + 13), 6, 100, ID_PROMPT_MAX,
                     get_config(SSM_ARCH).vocab_size), mesh,
        layers=SSM_ID_LAYERS)
    del params
    torch.cuda.empty_cache()
    rg = get_config(RG_ARCH)
    rng = np.random.default_rng(SEED + 15)
    half = MESH_RG_PROMPTS // 2
    runs[f"{RG_ARCH} mesh"], params, _ = mesh_identity(
        torch, np, "serve mesh identity", RG_ARCH,
        dataclasses.replace(id_scfg, num_blocks=1024,
                            max_blocks_per_req=RG_ID_TABLE_W),
        make_prompts(rng, half, rg.sliding_window + BS + 1, RG_ID_PROMPT[1],
                     rg.vocab_size)
        + make_prompts(rng, MESH_RG_PROMPTS - half, RG_ID_PROMPT[0],
                       rg.sliding_window, rg.vocab_size), mesh,
        layers=RG_ID_LAYERS)
    del params
    torch.cuda.empty_cache()
    return runs, mesh_kernel_rows(torch, mesh)


def phase_preempt_mesh(torch, np, cfg, params, mesh,
                       tag="serve mesh preempt"):
    """Phase 11's forced preemption (PREEMPT_BLOCKS blocks for its four
    requests, the host tier) on the mesh: the archive holds each leaf's
    local shard and rebuilds the DTensor it spilled; tokens identical to
    the ample pool without a mesh."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.api import HyperServe
    prompts = make_prompts(np.random.default_rng(SEED + 3), 4, 180, 220,
                           cfg.vocab_size)
    base = dict(block_size=BS, max_blocks_per_req=24, max_slots=4,
                prefill_chunk=PRE_C, enable_prefix_cache=False)
    ample, _ = serve_all(HyperServe(cfg, params, serve_cfg=ServeConfig(
        num_blocks=256, **base), device=DEVICE), prompts, 64)
    tight = HyperServe(cfg, params, device=DEVICE, mesh=mesh,
                       serve_cfg=ServeConfig(num_blocks=PREEMPT_BLOCKS, **base))
    got, _ = serve_all(tight, prompts, 64)
    st = tight.stats()
    m = tight.engine.obs.metrics
    spills, restores = (int(m.counter("serve.spills").value),
                        int(m.counter("serve.restores").value))
    log(f"[{tag}] pool {PREEMPT_BLOCKS - 1} blocks on the "
        f"mesh: preemptions={st['preemptions']} spills={spills} "
        f"restores={restores}, archive host bytes now "
        f"{st['archive_host_bytes']}; tokens identical to the ample pool "
        f"without a mesh: {got == ample}")
    if st["preemptions"] < 1 or spills < 1 or restores < 1 or got != ample:
        raise AssertionError(f"{tag}: the preempted run failed")


def mesh_kernel_rows(torch, mesh):
    """The ``_mesh`` rows of the kernel JSON: the paged decode and ragged
    prefill at qwen2-0.5b's serving shapes in bf16 (phase 3's inputs) and
    both scans at phase 38b's f32 identity prefill calls (PRE_P x PRE_C
    rows with an initial state), each wrapper handed DTensors on ``mesh``
    (the side inputs plain, as the steps hand them over) and run under
    ``local_map``: its error against the plain version on the same local
    tensors (the limits of phase 3), its time through the DTensor path,
    the plain version's, the library call's where there is one, and the
    bound of the work these inputs need.  The card is held busy for
    MESH_SLEEP_CYCLES while each launch is queued, so the times are device
    times; the host's wall a call, on DTensors and on the plain local
    tensors, is logged beside them."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import perf_model as pm
    from repro_torch.kernels import ragged_prefill_attention as rpa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    rep = [Replicate()] * mesh.ndim

    def on_mesh(t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return t                    # side inputs and ints stay plain
        return DTensor.from_local(t, mesh, rep, run_check=False)
    shape = dict(num_heads=H, kv_heads=KV, head_dim=D, itemsize=2)
    dec = decode_inputs(torch, torch.bfloat16, DEVICE)
    pre = prefill_inputs(torch, torch.bfloat16, DEVICE)
    kw = dict(block_size=BS)
    ssm = get_config(SSM_ARCH)
    s_args, s_kw = ssd_inputs(torch, torch.float32, ssm, PRE_P, PRE_C,
                              SEED + 40, True)
    r_args, r_kw = rg_scan_inputs(torch, torch.float32,
                                  get_config(RG_ARCH).rglru.lru_width,
                                  PRE_P, PRE_C, SEED + 41, True)
    x, Bm = s_args[0], s_args[3]
    cases = (
        ("paged_decode_attention", pda.paged_decode_attention,
         pda.paged_decode_attention_ref, dec, kw, "bfloat16",
         pm.decode_visible_cost(dec[4].tolist(), **shape),
         sdpa_decode(torch, *dec),
         "src/repro/kernels/paged_decode_attention.py:91", "qwen2-0.5b mesh"),
        ("ragged_prefill_attention", rpa.ragged_prefill_attention,
         rpa.ragged_prefill_attention_ref, pre, kw, "bfloat16",
         pm.prefill_visible_cost(pre[4].tolist(), pre[5].tolist(), PRE_C,
                                 **shape),
         sdpa_prefill(torch, *pre),
         "src/repro/kernels/ragged_prefill_attention.py:89",
         "qwen2-0.5b mesh"),
        ("ssd_scan", ss.ssd_scan, ss.ssd_scan_ref, s_args, s_kw, "float32",
         pm.ssd_scan_cost(batch=PRE_P, seq=PRE_C, heads=x.shape[2],
                          head_dim=x.shape[3], d_state=Bm.shape[-1],
                          chunk=s_kw["chunk"], itemsize=4, init_state=True),
         None, "src/repro/kernels/ssd_scan.py:70", f"{SSM_ARCH} mesh"),
        ("rglru_scan", rs.rglru_scan, rs.rglru_scan_ref, r_args, r_kw,
         "float32",
         pm.rglru_scan_cost(batch=PRE_P, seq=PRE_C, width=r_args[0].shape[2],
                            itemsize=4, init_state=True),
         None, "src/repro/kernels/rglru_scan.py:66", f"{RG_ARCH} mesh"))
    rows = []
    for name, fn, ref, args, kwargs, dtype_name, cost, lib, replaces, path \
            in cases:
        m_args = [on_mesh(a) for a in args]
        m_kw = {k: on_mesh(v) for k, v in kwargs.items()}
        n0 = fn.launches
        got = fn(*m_args, **m_kw)
        if fn.launches != n0 + 1:
            raise AssertionError(f"{name} on the mesh: "
                                 f"{fn.launches - n0} launches, not 1")
        want = ref(*args, **kwargs)
        if name == "ssd_scan":
            want64 = ref(*[a.double() for a in args], chunk=kwargs["chunk"],
                         init_state=kwargs["init_state"].double(),
                         acc=torch.float64)
            errs = [ssd_parity(torch, dtype_name, g.to_local(), w, w, w64)
                    for g, w, w64 in zip(got, want, want64)]
        else:
            pairs = zip(got, want) if isinstance(got, tuple) else \
                [(got, want)]
            want32 = ref(*[a.float() if a.is_floating_point() else a
                           for a in args], **kwargs) \
                if dtype_name == "bfloat16" else want
            w32 = want32 if isinstance(want32, tuple) else (want32,)
            errs = [parity(torch, dtype_name, g.to_local(), w, w3,
                           slack=RG_ABS if name == "rglru_scan"
                           else BF16_ABS)
                    for (g, w), w3 in zip(pairs, w32)]
        rows.append(mesh_row(
            torch, "serve mesh kernels", f"{name}_mesh", name, errs,
            lambda: fn(*m_args, **m_kw), lambda: fn(*args, **kwargs),
            lambda: ref(*args, **kwargs), lib, cost, dtype_name, replaces,
            path))
    return rows


def mesh_row(torch, tag, name, source, errs, on_mesh, local, plain, lib,
             cost, dtype_name, replaces, path, calls=50):
    """One ``_mesh`` row of the kernel JSON: a wrapper called on DTensors
    (``on_mesh``) whose errors against its plain version, ``errs`` [(max
    abs error, share of the limit)], are checked here (a share above 1
    raises); its device time on DTensors, the plain version's
    (``plain``), the library call's (``lib``: a call, a pair to take the
    second's time from the first's, or None) with the card held busy
    MESH_SLEEP_CYCLES while each launch is queued, and the bound of
    ``cost``; the host wall a call on DTensors and on the plain local
    tensors (``local``) over ``calls`` calls is logged beside."""
    err, share = max(e for e, _ in errs), max(sh for _, sh in errs)
    if not share <= 1.0:
        raise AssertionError(f"{name} on the mesh: error share {share}")

    def device_ms(fn):
        return time_ms(fn, torch, sleep_cycles=MESH_SLEEP_CYCLES)
    ms, plain_ms = device_ms(on_mesh), device_ms(plain)
    if isinstance(lib, tuple):          # (with the part to take away, part)
        library_ms = device_ms(lib[0]) - device_ms(lib[1])
    else:
        library_ms = device_ms(lib) if lib is not None else None
    bound_ms = cost.bound_seconds(dtype_name) * 1e3
    walls = [wall_us(f, torch, calls) for f in (on_mesh, local)]
    log(f"[{tag}] {name} on DTensors ({dtype_name}): max abs err {err:.3e} "
        f"(share {share:.3f} of the limit), {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({cost.bound_by(dtype_name)})"
        + (f", library {library_ms:.4f} ms" if lib is not None else "")
        + f"; wall a call {walls[0]:.1f} us on DTensors, {walls[1]:.1f} us "
        "on the plain local tensors")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": cost.bound_by(dtype_name), "library_ms": library_ms,
            "path": path}


# phase 38c: deepseek-v2-lite-16b on the one-rank mesh of phases 38a and
# 38b (MLA and MoE under HyperShard): serving at phase 13's config and
# requests, the f32 identities at DS_ID_LAYERS and at phase 28's train
# shape, and MESH_STEPS bf16 train steps under each dispatch against
# phases 26 and 27a
def phase_deepseek_mesh(torch, np, mesh, moe_summary, ds_records):
    """Phase 38c.  deepseek-v2-lite-16b bf16, all 27 layers, through
    HyperServe on ``mesh`` under ``ShardingPlan(fsdp=None)`` at phase
    13's config and requests (phase_moe_serve: 27 MLA decodes a decode
    step, 27 flash a prefill call, 3 x 26 grouped matmuls a step and a
    call, exactly; one copy of the params, the peak printed), decode
    tok/s, median TTFT and the decode-step wall beside phase 13's in this
    process, and a profile; then the f32 identity at DS_ID_LAYERS against
    the same engine without a mesh (mesh_identity) and through phase 11's
    forced preemption on the mesh.  Then deepseek-v2-lite cut to
    DS_TRAIN_LAYERS, bf16, DS_TRAIN_B x DS_TRAIN_S, fsdp_tp: MESH_STEPS
    steps under gshard (8 flash forwards and 4 backwards a step, no
    grouped matmul) and under ragged (18 grouped matmuls and 9 of each
    backward kernel a step), loss and grad norm within MESH_BF16_REL of
    phases 26 and 27a's first MESH_STEPS steps (``ds_records``: dispatch
    -> record), or within twice the distance of a second run without the
    mesh where that is larger (the bf16 backward's dQ atomics), wall,
    tok/s and peak beside theirs; and the f32 identity at phase 28's
    shape against no mesh.  Nothing here is caught.
    Returns (the launches of each run, the kernel rows)."""
    from repro_torch.configs.base import ServeConfig, ShapeConfig, get_config
    from repro_torch.core.hypershard import ShardingPlan
    runs, summary = {}, {}
    launches, serve, prompts = phase_moe_serve(torch, np, mesh, summary,
                                               "deepseek mesh")
    b = moe_summary
    log(f"[deepseek mesh] against phase 13 (moe serve) in this process: "
        f"decode {summary['decode_tok_s']:.1f} vs {b['decode_tok_s']:.1f} "
        f"tok/s, median TTFT {summary['ttft_s']:.3f}s vs "
        f"{b['ttft_s']:.3f}s, decode-step wall {summary['step_s'] * 1e3:.3f}"
        f" vs {b['step_s'] * 1e3:.3f} ms "
        f"({summary['step_s'] / b['step_s']:.2f}x), peak "
        f"{summary['peak_gib']:.2f} vs {b['peak_gib']:.2f} GiB;"
        f" bf16 tokens identical to phase 13's: "
        f"{summary['tokens'] == b['tokens']}")
    phase_profile(torch, serve, prompts, DS_NEW, "deepseek mesh profile")
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    runs[f"{DS_ARCH} mesh"] = launches
    cfg = get_config(DS_ARCH)
    id_scfg = ServeConfig(block_size=BS, num_blocks=512,
                          max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                          prefill_chunk=PRE_C, prefill_batch=PRE_P)
    _, params, cfg32 = mesh_identity(
        torch, np, "deepseek mesh identity", DS_ARCH, id_scfg,
        make_prompts(np.random.default_rng(SEED + 9), 6, 100, ID_PROMPT_MAX,
                     cfg.vocab_size), mesh, layers=DS_ID_LAYERS)
    phase_preempt_mesh(torch, np, cfg32, params, mesh,
                       "deepseek mesh preempt")
    del params
    torch.cuda.empty_cache()
    plan = ShardingPlan()
    for dispatch, tag, base_tag in (
            ("gshard", "deepseek mesh train", "deepseek train"),
            ("ragged", "deepseek mesh ragged train", "deepseek ragged train")):
        rec, summ = [], {}
        runs[f"{DS_ARCH} mesh{' ragged' if dispatch == 'ragged' else ''} "
             "train"] = phase_train(
            torch, np, DS_ARCH, DS_TRAIN_LAYERS, DS_TRAIN_B, DS_TRAIN_S,
            MESH_STEPS, tag, record=rec, moe_dispatch=dispatch, mesh=mesh,
            plan=plan, summary=summ)
        base, base_summ = ds_records[dispatch]

        def dist(run):
            return max(abs(x[0][k] - y[0][k]) / max(1.0, abs(y[0][k]))
                       for x, y in zip(run, base[:MESH_STEPS])
                       for k in ("loss", "grad_norm"))
        rel, noise = dist(rec), 0.0
        if not rel <= MESH_BF16_REL:
            # two bf16 runs without a mesh part too (the flash backward's
            # dQ atomics, amplified through deepseek's routing: step 4's
            # grad norm of phase 26 spans 1.2e-3 relative over five runs
            # on the H100, PERF.md), so a second run without the mesh
            # measures that noise here, and the mesh run may part from the
            # first by twice it where that exceeds MESH_BF16_REL
            again = []
            phase_train(torch, np, DS_ARCH, DS_TRAIN_LAYERS, DS_TRAIN_B,
                        DS_TRAIN_S, MESH_STEPS, f"{base_tag} again",
                        record=again, moe_dispatch=dispatch)
            noise = dist(again)
        limit = max(MESH_BF16_REL, 2 * noise)
        log(f"[{tag}] bf16 {DS_TRAIN_B} x {DS_TRAIN_S} on the "
            f"{tuple(mesh.shape)} mesh against {base_tag} in this process: "
            f"loss and grad norm within {rel:.3e} relative (a second run "
            f"without the mesh, run only where the first limit is not met: "
            f"{noise:.3e}; limit {limit:.3e}, the larger "
            f"of {MESH_BF16_REL:.3e} and twice that); median step "
            f"{summ['median_s']:.4f}s vs {base_summ['median_s']:.4f}s, "
            f"{summ['tok_s']:.1f} vs {base_summ['tok_s']:.1f} train tok/s, "
            f"peak {summ['peak_gib']:.2f} vs {base_summ['peak_gib']:.2f} GiB")
        if len(rec) != MESH_STEPS or not rel <= limit:
            raise AssertionError(f"{tag}: bf16 run differs by {rel}")
        torch.cuda.empty_cache()
    mesh_train_identity(
        torch, dataclasses.replace(cfg, dtype="float32",
                                   num_layers=DS_TRAIN_ID_LAYERS),
        ShapeConfig("train_identity", DS_TRAIN_ID_S, DS_TRAIN_ID_B, "train"),
        DS_TRAIN_ID_STEPS, mesh, plan, "deepseek mesh train identity")
    torch.cuda.empty_cache()
    return runs, ds_mesh_kernel_rows(torch, mesh)


def ds_mesh_kernel_rows(torch, mesh):
    """The ``_mesh`` rows of phase 38c: each wrapper of the deepseek path
    handed DTensors on ``mesh`` (the side inputs and the group sizes
    plain, as the steps hand them over) and run under ``local_map``, in
    bf16: the MLA decode at the serving run's seats (phase 3's inputs),
    the grouped matmul at a decode step's and a prefill call's w_gate/w_up
    rows, its backward's dx and dw at the ragged train rows, and flash's
    forward with its lse and its backward at (192, 128), the train shape.
    Each: one launch a call, its error against the plain version on the
    same local tensors (phase 3's limits), its time through the DTensor
    path (the card held MESH_SLEEP_CYCLES while each is queued), the plain
    version's, the library call's and the bound of the work these inputs
    need; the host's wall a call, on DTensors and on plain tensors,
    logged beside."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import perf_model as pm
    rep = [Replicate()] * mesh.ndim

    def on_mesh(t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return t                    # side inputs and ints stay plain
        return DTensor.from_local(t, mesh, rep, run_check=False)
    bf16 = torch.bfloat16
    cfg = get_config(DS_ARCH)
    m, H = cfg.mla, cfg.num_heads
    D, F, k = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.top_k
    mla = mla_inputs(torch, bf16, cfg)
    dec = gm_inputs(torch, bf16, cfg, DEC_B * k, D, F, SEED + 10)
    pre = gm_inputs(torch, bf16, cfg, PRE_P * PRE_C * k, D, F, SEED + 12)
    x, w, sizes, dy = grouped_bwd_cases(torch, bf16)[0][1]
    mh, mkv, mdk, mdv = BWD_MLA
    fl = bwd_inputs(torch, bf16, mh, mkv, mdk, mdv, DS_TRAIN_B, DS_TRAIN_S,
                    None, SEED + 50)
    serve_path, train_path = f"{DS_ARCH} mesh", f"{DS_ARCH} mesh train"
    gm_src, gm_tpu = "grouped_matmul", "src/repro/kernels/grouped_matmul.py:58"
    fa_tpu = "src/repro/kernels/flash_attention.py:87"
    cases = (
        ("paged_mla_decode_attention_mesh", "paged_mla_decode_attention",
         pda.paged_mla_decode_attention, pda.paged_mla_decode_attention_ref,
         mla, dict(block_size=BS, scale=mla_scale(cfg)),
         pda.paged_mla_decode_attention,
         pm.paged_mla_decode_cost(mla[5].tolist(), num_heads=H,
                                  kv_lora_rank=m.kv_lora_rank,
                                  rope_dim=m.qk_rope_head_dim, itemsize=2),
         sdpa_mla(torch, *mla, mla_scale(cfg)),
         "src/repro/kernels/paged_decode_attention.py:189", serve_path),
        ("grouped_matmul_mesh", gm_src, gm.grouped_matmul,
         gm.grouped_matmul_ref, dec, {}, gm.grouped_matmul,
         pm.grouped_matmul_cost(dec[2].tolist(), d_in=D, d_out=F,
                                itemsize=2),
         grouped_mm_yardstick(torch, *dec), gm_tpu, serve_path),
        ("grouped_matmul_prefill_mesh", gm_src, gm.grouped_matmul,
         gm.grouped_matmul_ref, pre, {}, gm.grouped_matmul,
         pm.grouped_matmul_cost(pre[2].tolist(), d_in=D, d_out=F,
                                itemsize=2),
         grouped_mm_yardstick(torch, *pre), gm_tpu, serve_path),
        ("grouped_matmul_bwd_dx_mesh", "grouped_matmul_bwd",
         gm.grouped_matmul_bwd_dx, gm.grouped_matmul_bwd_dx_ref,
         (dy, w, sizes), {}, gm.grouped_matmul_bwd_dx,
         pm.grouped_matmul_bwd_cost(sizes.tolist(), d_in=D, d_out=F,
                                    itemsize=2, part="dx"),
         grouped_bwd_yardstick(torch, "dx", (dy, w, sizes))[0], gm_tpu,
         f"{DS_ARCH} mesh ragged train"),
        ("grouped_matmul_bwd_dw_mesh", "grouped_matmul_bwd",
         gm.grouped_matmul_bwd_dw, gm.grouped_matmul_bwd_dw_ref,
         (x, dy, sizes), {}, gm.grouped_matmul_bwd_dw,
         pm.grouped_matmul_bwd_cost(sizes.tolist(), d_in=D, d_out=F,
                                    itemsize=2, part="dw"),
         grouped_bwd_yardstick(torch, "dw", (x, dy, sizes))[0], gm_tpu,
         f"{DS_ARCH} mesh ragged train"),
        ("flash_attention_train_dk192_dv128_mesh", "flash_attention",
         fa.flash_attention_lse, fa.flash_attention_lse_ref, fl[:3],
         dict(causal=True), fa.flash_attention,
         pm.prefill_visible_cost([0] * DS_TRAIN_B, [DS_TRAIN_S] * DS_TRAIN_B,
                                 DS_TRAIN_S, num_heads=mh, kv_heads=mkv,
                                 head_dim=(mdk + mdv) // 2, itemsize=2),
         sdpa_flash(torch, *fl[:3]), fa_tpu, train_path),
        ("flash_attention_bwd_dk192_dv128_mesh", "flash_attention_bwd",
         fa.flash_attention_bwd, fa.flash_attention_bwd_ref, fl,
         dict(causal=True), fa.flash_attention_bwd,
         pm.flash_attention_bwd_cost(batch=DS_TRAIN_B, seq_q=DS_TRAIN_S,
                                     seq_k=DS_TRAIN_S, num_heads=mh,
                                     kv_heads=mkv, dk=mdk, dv=mdv,
                                     itemsize=2),
         sdpa_flash_bwd(torch, *fl), fa_tpu, train_path))
    rows = []
    for (name, source, fn, ref, args, kwargs, counter, cost, lib, replaces,
         path) in cases:
        m_args = [on_mesh(a) for a in args]
        n0 = counter.launches
        got = fn(*m_args, **kwargs)
        if counter.launches != n0 + 1:
            raise AssertionError(f"{name}: {counter.launches - n0} "
                                 "launches, not 1")
        got = [g.to_local() for g in (got if isinstance(got, tuple)
                                      else (got,))]
        want = ref(*args, **kwargs)
        want = want if isinstance(want, tuple) else (want,)
        f32 = [a.float() if a.is_floating_point() else a for a in args]
        want32 = ref(*f32, **kwargs)
        want32 = want32 if isinstance(want32, tuple) else (want32,)
        if "bwd" in name and "grouped" in name:
            f64 = [a.double() if a.is_floating_point() else a for a in args]
            errs = [scan_grad_parity(torch, "bfloat16", got[0], want[0],
                                     want32[0], ref(*f64, acc=torch.float64),
                                     F32_TOL)]
        elif "bwd" in name:
            errs = [grad_parity(torch, "bfloat16", g, a, b)
                    for g, a, b in zip(got, want, want32)]
        else:               # the output (flash's lse is held in phase 3)
            errs = [parity(torch, "bfloat16", got[0], want[0], want32[0],
                           slack=GM_ABS if source == gm_src else BF16_ABS)]
        del got, want, want32
        rows.append(mesh_row(
            torch, "deepseek mesh kernels", name, source, errs,
            lambda: fn(*m_args, **kwargs), lambda: fn(*args, **kwargs),
            lambda: ref(*args, **kwargs), lib, cost, "bfloat16", replaces,
            path, calls=10))
        torch.cuda.empty_cache()
    return rows


# phase 38d: the recurrent and multimodal families and the composed
# lowering on the one-rank mesh of phases 38a-38c.  musicgen-large serves
# text-only on the mesh at MG_SERVE_LAYERS (its f32 identity: the fused
# kernels at its (32, 32, 64) against no mesh)
MG_SERVE_LAYERS = 4


def phase_recurrent_mesh(torch, np, mesh, serve_summary, train_records):
    """Phase 38d.  bf16 fsdp_tp training on ``mesh``, MESH_STEPS steps
    each through phase_train (its exact launches a step): mamba2-370m at
    phase 31's shape (96 ``ssd_scan`` and 48 ``ssd_scan_bwd`` a step, the
    scans' backwards under ``local_map``), recurrentgemma-2b at phase 34's
    (36 scans, 18 scan backwards, 16 flash and 8 flash backwards a step)
    and musicgen-large at phase 29's, its seeded prefix placed as the
    batch's rows (72 + 36 flash a step), loss and grad norm within
    MESH_BF16_REL of those phases' first MESH_STEPS steps
    (``train_records``: arch -> (record, summary)), or within twice the
    distance of a second run without the mesh where that is larger (run
    only when the first limit is not met), wall, tok/s and peak beside
    theirs; the f32 identities against no mesh at phases 32, 35 and 30's
    shapes.  Then qwen2-0.5b bf16 served composed on the mesh at phase 4's
    config and requests (24 ``decode_attention`` a decode step and 24
    flash a prefill call, exactly), decode tok/s, TTFT and the decode-step
    wall beside phase 4's (``serve_summary``); the f32 identities of the
    composed engine on the mesh against the fused one without it (qwen2,
    recurrentgemma at RG_ID_LAYERS with two prompts past its window,
    deepseek-v2-lite at DS_ID_LAYERS: MLA's composed decode), and
    musicgen-large text-only on
    the mesh at MG_SERVE_LAYERS against no mesh.  Nothing here is caught.
    Returns (the launches of each run, the kernel rows)."""
    from repro_torch.configs.base import ServeConfig, ShapeConfig, get_config
    from repro_torch.core.hypershard import ShardingPlan
    runs = {}
    plan = ShardingPlan()
    for arch, layers, batch, seq, tag, base_tag in (
            (SSM_ARCH, None, SSM_TRAIN_B, SSM_TRAIN_S, "mamba2 mesh train",
             "mamba2 train"),
            (RG_ARCH, None, RG_TRAIN_B, RG_TRAIN_S,
             "recurrentgemma mesh train", "recurrentgemma train"),
            (MG_ARCH, MG_LAYERS, MG_B, MG_S, "musicgen mesh train",
             "musicgen train")):
        rec, summ = [], {}
        runs[f"{arch} mesh train"] = phase_train(
            torch, np, arch, layers, batch, seq, MESH_STEPS, tag, record=rec,
            mesh=mesh, plan=plan, summary=summ)
        base, base_summ = train_records[arch]

        def dist(run):
            return max(abs(x[0][k] - y[0][k]) / max(1.0, abs(y[0][k]))
                       for x, y in zip(run, base[:MESH_STEPS])
                       for k in ("loss", "grad_norm"))
        rel, noise = dist(rec), None
        if not rel <= MESH_BF16_REL:
            # 38c's rule: two bf16 runs without a mesh part too (the
            # flash backward's dQ atomics), so a second one measures that
            again = []
            torch.cuda.empty_cache()
            phase_train(torch, np, arch, layers, batch, seq, MESH_STEPS,
                        f"{base_tag} again", record=again)
            noise = dist(again)
        limit = MESH_BF16_REL if noise is None else max(MESH_BF16_REL,
                                                        2 * noise)
        log(f"[{tag}] bf16 on the {tuple(mesh.shape)} mesh against "
            f"{base_tag} in this process: loss and grad norm within "
            f"{rel:.3e} relative (limit {limit:.3e}"
            + ("" if noise is None else
               f", a second run without the mesh {noise:.3e}")
            + f"); median step {summ['median_s']:.4f}s vs "
            f"{base_summ['median_s']:.4f}s "
            f"({summ['median_s'] / base_summ['median_s']:.2f}x), "
            f"{summ['tok_s']:.1f} vs {base_summ['tok_s']:.1f} train tok/s, "
            f"peak {summ['peak_gib']:.2f} vs {base_summ['peak_gib']:.2f} "
            f"GiB, first step {summ['first_s']:.3f}s vs "
            f"{base_summ['first_s']:.3f}s")
        if len(rec) != MESH_STEPS or not rel <= limit:
            raise AssertionError(f"{tag}: bf16 run differs by {rel}")
        torch.cuda.empty_cache()
    for arch, layers, batch, seq, n_steps in (
            (SSM_ARCH, SSM_TRAIN_ID_LAYERS, SSM_TRAIN_ID_B, SSM_TRAIN_ID_S,
             TRAIN_ID_STEPS),
            (RG_ARCH, RG_TRAIN_ID_LAYERS, RG_TRAIN_ID_B, RG_TRAIN_ID_S,
             TRAIN_ID_STEPS),
            (MG_ARCH, MG_ID_LAYERS, MG_ID_B, MG_ID_S, MG_ID_STEPS)):
        mesh_train_identity(
            torch, dataclasses.replace(get_config(arch), dtype="float32",
                                       num_layers=layers),
            ShapeConfig("train_identity", seq, batch, "train"), n_steps,
            mesh, plan, f"{arch} mesh train identity")
        torch.cuda.empty_cache()
    summary = {}
    runs["qwen2-0.5b composed mesh"], serve, _ = phase_serve(
        torch, np, mesh, summary, "composed mesh", kernels="composed")
    b = serve_summary
    log(f"[composed mesh] against phase 4 (serve, fused, no mesh) in this "
        f"process: decode {summary['decode_tok_s']:.1f} vs "
        f"{b['decode_tok_s']:.1f} tok/s, median TTFT {summary['ttft_s']:.3f}s"
        f" vs {b['ttft_s']:.3f}s, decode-step wall "
        f"{summary['step_s'] * 1e3:.3f} vs {b['step_s'] * 1e3:.3f} ms "
        f"({summary['step_s'] / b['step_s']:.2f}x); bf16 tokens identical "
        f"to phase 4's: {summary['tokens'] == b['tokens']}")
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    id_scfg = ServeConfig(block_size=BS, num_blocks=512,
                          max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                          prefill_chunk=PRE_C, prefill_batch=PRE_P)
    timed("composed mesh identity qwen2-0.5b", lambda: mesh_identity(
        torch, np, "composed mesh identity", "qwen2-0.5b", id_scfg,
        make_prompts(np.random.default_rng(SEED + 2), 6, 100, ID_PROMPT_MAX,
                     get_config("qwen2-0.5b").vocab_size),
        mesh, layers=MESH_QWEN_ID_LAYERS, kernels="composed"))
    torch.cuda.empty_cache()
    rg = get_config(RG_ARCH)
    rng = np.random.default_rng(SEED + 15)
    half = MESH_RG_PROMPTS // 2
    runs[f"{RG_ARCH} composed mesh"], params, _ = mesh_identity(
        torch, np, "composed mesh identity", RG_ARCH,
        dataclasses.replace(id_scfg, num_blocks=1024,
                            max_blocks_per_req=RG_ID_TABLE_W),
        make_prompts(rng, half, rg.sliding_window + BS + 1, RG_ID_PROMPT[1],
                     rg.vocab_size)
        + make_prompts(rng, MESH_RG_PROMPTS - half, RG_ID_PROMPT[0],
                       rg.sliding_window, rg.vocab_size), mesh,
        layers=RG_ID_LAYERS, kernels="composed")
    del params
    torch.cuda.empty_cache()
    mesh_identity(torch, np, "composed mesh identity", DS_ARCH, id_scfg,
                  make_prompts(np.random.default_rng(SEED + 9), 6, 100,
                               ID_PROMPT_MAX, get_config(DS_ARCH).vocab_size),
                  mesh, layers=DS_ID_LAYERS, kernels="composed")
    torch.cuda.empty_cache()
    mesh_identity(torch, np, "prefix mesh identity", MG_ARCH, id_scfg,
                  make_prompts(np.random.default_rng(SEED + 17), 6, 100,
                               ID_PROMPT_MAX, get_config(MG_ARCH).vocab_size),
                  mesh, layers=MG_SERVE_LAYERS)
    torch.cuda.empty_cache()
    return runs, recurrent_mesh_kernel_rows(torch, mesh)


def recurrent_mesh_kernel_rows(torch, mesh):
    """The ``_mesh`` rows of phase 38d, each wrapper handed DTensors on
    ``mesh`` (the lengths plain, as the composed decode hands them over)
    and run under ``local_map``, in bf16: ``decode_attention`` at qwen2's
    composed serving shapes (phase 4's 16 seats over TABLE_W gathered
    pages) and at (10, 1, 256) with the window (phase 3's recurrentgemma
    composed inputs), both scans and both scan backwards at the train
    steps' shapes (phase 3's inputs).  Each row: its error against the
    plain version (phase 3's limits), its device time on DTensors, the
    plain version's, the library call's where there is one and the bound
    (mesh_row)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import perf_model as pm
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    rep = [Replicate()] * mesh.ndim
    bf16 = torch.bfloat16

    def on_mesh(t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return t                    # side inputs and ints stay plain
        return DTensor.from_local(t, mesh, rep, run_check=False)
    qdec = dense_decode_inputs(torch, bf16, DEVICE, H, KV, D, DEC_B,
                               TABLE_W * BS, (100, 1564), SEED + 70)
    rdec = dense_decode_inputs(torch, bf16, DEVICE, 10, 1, 256, ID_SLOTS,
                               RG_ID_TABLE_W * BS,
                               (RG_ID_PROMPT[0] + 1, RG_ID_PROMPT[1] + ID_NEW),
                               SEED + 71)
    ssm = get_config(SSM_ARCH)
    s_args, s_kw = ssd_inputs(torch, bf16, ssm, SSM_TRAIN_B, SSM_TRAIN_S,
                              SEED + 72, False)
    _, sb_args, sb_kw = ssd_bwd_cases(torch, bf16)[0]
    W = get_config(RG_ARCH).rglru.lru_width
    r_args, r_kw = rg_scan_inputs(torch, bf16, W, RG_TRAIN_B, RG_TRAIN_S,
                                  SEED + 73, False)
    _, rb_args, rb_kw = rg_bwd_cases(torch, bf16)[0]
    x, Bm = s_args[0], s_args[3]
    ssd_shape = dict(batch=SSM_TRAIN_B, seq=SSM_TRAIN_S, heads=x.shape[2],
                     head_dim=x.shape[3], d_state=Bm.shape[-1],
                     chunk=s_kw["chunk"], itemsize=2, init_state=False)
    rg_shape = dict(batch=RG_TRAIN_B, seq=RG_TRAIN_S, width=W, itemsize=2,
                    init_state=False)
    S = rdec[1].shape[1]
    cases = (
        ("decode_attention", da.decode_attention, da.decode_attention_ref,
         qdec, {}, pm.decode_visible_cost(qdec[3].tolist(), num_heads=H,
                                          kv_heads=KV, head_dim=D,
                                          itemsize=2),
         sdpa_dense_decode(torch, *qdec),
         "src/repro/kernels/decode_attention.py:67",
         "qwen2-0.5b composed mesh"),
        ("decode_attention", da.decode_attention, da.decode_attention_ref,
         rdec, dict(window=RG_WINDOW),
         pm.decode_visible_cost(rdec[3].tolist(), num_heads=10, kv_heads=1,
                                head_dim=256, itemsize=2, window=RG_WINDOW),
         sdpa_masked(torch, rdec[0], rdec[1], rdec[2], rg_decode_mask(
             torch, rdec[3], S, RG_WINDOW)),
         "src/repro/kernels/decode_attention.py:67",
         f"{RG_ARCH} composed mesh"),
        ("ssd_scan", ss.ssd_scan, ss.ssd_scan_ref, s_args, s_kw,
         pm.ssd_scan_cost(**ssd_shape), None,
         "src/repro/kernels/ssd_scan.py:70", f"{SSM_ARCH} mesh train"),
        ("ssd_scan_bwd", ss.ssd_scan_bwd, ss.ssd_scan_bwd_ref, sb_args,
         sb_kw, pm.ssd_scan_bwd_cost(**ssd_shape, dfin=False), None,
         "src/repro/kernels/ssd_scan.py:70", f"{SSM_ARCH} mesh train"),
        ("rglru_scan", rs.rglru_scan, rs.rglru_scan_ref, r_args, r_kw,
         pm.rglru_scan_cost(**rg_shape), None,
         "src/repro/kernels/rglru_scan.py:66", f"{RG_ARCH} mesh train"),
        ("rglru_scan_bwd", rs.rglru_scan_bwd, rs.rglru_scan_bwd_ref,
         rb_args, rb_kw, pm.rglru_scan_bwd_cost(**rg_shape, dfin=False),
         None, "src/repro/kernels/rglru_scan.py:66",
         f"{RG_ARCH} mesh train"))
    rows = []
    for name, fn, ref, args, kwargs, cost, lib, replaces, path in cases:
        m_args = [on_mesh(a) for a in args]
        m_kw = {k: on_mesh(v) for k, v in kwargs.items()}
        n0 = fn.launches
        got = fn(*m_args, **m_kw)
        if fn.launches != n0 + 1:
            raise AssertionError(f"{name} on the mesh: "
                                 f"{fn.launches - n0} launches, not 1")
        got = got if isinstance(got, tuple) else (got,)
        got = [g.to_local() for g in got if g is not None]

        def up(a, dtype):
            return a.to(dtype) if torch.is_tensor(a) \
                and a.is_floating_point() else a
        want = ref(*args, **kwargs)
        want32 = ref(*[up(a, torch.float32) for a in args],
                     **{k: up(v, torch.float32) for k, v in kwargs.items()})
        want = want if isinstance(want, tuple) else (want,)
        want32 = want32 if isinstance(want32, tuple) else (want32,)
        if name.startswith(("ssd", "rglru")):
            want64 = ref(*[up(a, torch.float64) for a in args],
                         **{k: up(v, torch.float64)
                            for k, v in kwargs.items()}, acc=torch.float64)
            rel = SSM_REL if name.startswith("ssd") else F32_TOL
            check = ssd_parity if name == "ssd_scan" else (
                lambda t, d, g, w, w3, w6: scan_grad_parity(
                    t, d, g, w, w3, w6, rel))
            errs = [check(torch, "bfloat16", g, w, w3, w6)
                    for g, w, w3, w6 in zip(got, want, want32, want64)
                    if w is not None]
        else:
            errs = [parity(torch, "bfloat16", g, w, w3)
                    for g, w, w3 in zip(got, want, want32)]
        rows.append(mesh_row(
            torch, "recurrent mesh kernels", f"{name}_mesh", name, errs,
            lambda: fn(*m_args, **m_kw), lambda: fn(*args, **kwargs),
            lambda: ref(*args, **kwargs), lib, cost, "bfloat16", replaces,
            path))
    return rows


# ---------------------------------------------------------------------------
# HyperRL: the port's colocated GRPO loop (repro_torch.rl)
# ---------------------------------------------------------------------------
def rl_session(torch, cfg, prompts, group, prompt_len, new, iters,
               mesh=None, roles=None):
    """An RLSession on the card: ``prompts`` x ``group`` seats, random
    weights from SEED, the launcher's serving leg (no prefix cache),
    PRE_P x PRE_C prefill calls, lr RL_LR, temperature 1; colocated on one
    device, on ``mesh``, or as ``roles`` of the process group's ranks."""
    from repro_torch.configs.base import RLConfig, ServeConfig
    from repro_torch.models import model as M
    from repro_torch.rl import RLSession
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=RL_NUM_BLOCKS,
                       max_blocks_per_req=-(-(prompt_len + new) // BS) + 1,
                       max_slots=prompts * group, prefill_chunk=PRE_C,
                       prefill_batch=PRE_P, enable_prefix_cache=False)
    rcfg = RLConfig(group_size=group, prompts_per_iter=prompts,
                    max_new_tokens=new, temperature=1.0, lr=RL_LR,
                    iterations=iters)
    return RLSession(cfg, rl_cfg=rcfg, serve_cfg=scfg, params=params,
                     seed=SEED, device=DEVICE, mesh=mesh, roles=roles)


def rl_prompts(np, cfg, n, length, it):
    """Iteration ``it``'s prompts, seeded: the same in every session."""
    rng = np.random.default_rng(SEED + 100 + it)
    return [rng.integers(1, cfg.vocab_size, size=length).tolist()
            for _ in range(n)]


def diversity(prompt, tokens):
    """The reference launcher's toy reward: distinct tokens a rollout."""
    return float(len(set(tokens)))


def count_rl_launches(torch, rl, kernels):
    """Wrap the session's engine step and learner update (on the objects
    themselves) so that each call records the launches it made of every
    kernel in ``kernels`` ({name: wrapper}) with what it ran: ("step",
    decode steps, prefill calls, launches, 0) or ("update", 0, 0,
    launches, wall seconds to the card's end).  Returns the record list."""
    eng, learner = rl.actor.engine, rl.learner
    m = eng.obs.metrics
    step, update = eng.step, learner.update
    records = []

    def snap():
        return {k: w.launches for k, w in kernels.items()}

    def counted_step():
        n0, d0, c0 = snap(), m.counter("serve.kernels.decode.fused").value, \
            eng.prefill_calls
        out = step()
        n1 = snap()
        records.append(("step",
                        int(m.counter("serve.kernels.decode.fused").value
                            - d0), eng.prefill_calls - c0,
                        {k: n1[k] - n0[k] for k in n1}, 0.0))
        return out

    def counted_update(batch):
        n0 = snap()
        sync(torch)
        t0 = time.perf_counter()
        out = update(batch)
        sync(torch)
        wall = time.perf_counter() - t0
        n1 = snap()
        records.append(("update", 0, 0, {k: n1[k] - n0[k] for k in n1},
                        wall))
        return out
    eng.step, learner.update = counted_step, counted_update
    return records


def check_rl_launches(tag, records, want_step, want_update):
    """Every engine step's launches equal ``want_step(decode steps,
    prefill calls)``, every update's ``want_update``; returns the totals."""
    totals = {}
    for kind, steps, calls, got, _ in records:
        want = want_step(steps, calls) if kind == "step" else want_update
        if got != want:
            raise AssertionError(f"{tag}: a {kind} ({steps} decode steps, "
                                 f"{calls} prefill calls) launched {got}, "
                                 f"expected {want}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def phase_rl(torch, np, summary=None):
    """qwen2-0.5b's colocated GRPO loop at full width in bf16 (phase 39):
    RL_ITERS iterations of RL_PROMPTS prompts x RL_GROUP samples through
    RLSession.iterate (rollout on HyperServe's paged kernels with the
    batched sampler, the diversity reward, one GRPO update through flash
    and its backward, publish).  weights_version ticks once an iteration;
    every engine step launches exactly 24 paged decodes a decode step and
    24 ragged prefills a prefill call, every update 48 flash forwards (24
    and 24 remat) and 24 backwards, nothing else; iteration 1's rollouts
    (tokens and logprobs, the learner batch) replay bit for bit in a second
    session from the same seed.  Rollout tokens/s, the learner step's wall,
    the publish wall, rl.stage_to_install_s, peak device memory, then
    torch.profiler over rollout decode steps (the device's idle share).
    ``summary`` takes each iteration's learner step and publish walls and
    rollout tok/s, and the first update's ratio_mean and clip_fraction."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    cfg = get_config("qwen2-0.5b")
    n = cfg.num_layers
    kernels = {"paged_decode_attention": paged_decode_attention,
               "ragged_prefill_attention": ragged_prefill_attention,
               "flash_attention": fa.flash_attention,
               "flash_attention_bwd": fa.flash_attention_bwd}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rl = rl_session(torch, cfg, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    RL_ITERS)
    records = count_rl_launches(torch, rl, kernels)
    # the main path's run: every launch count starts at 0 here
    for w in kernels.values():
        w.launches = 0
    hist, batches = [], []
    for it in range(RL_ITERS):
        m = rl.iterate(rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, it),
                       diversity)
        batches.append(rl.buffer.batch(pad_len_to=16))
        hist.append(m)
        upd = [r for r in records if r[0] == "update"][-1][4]
        if summary is not None:
            summary.setdefault("update_s", []).append(upd)
            summary.setdefault("publish_s", []).append(m["publish_s"])
            summary.setdefault("rollout_tok_s", []).append(
                m["rollout_tokens"] / m["rollout_s"])
            summary.setdefault("ratio_clip", []).append(
                (m["ratio_mean"], m["clip_fraction"]))
        log(f"[rl] iteration {it + 1}: loss {m['loss']:+.6f} reward "
            f"{m['reward_mean']:.3f} ratio_mean {m['ratio_mean']:.6f} "
            f"clip_fraction {m['clip_fraction']:.4f} grad_norm "
            f"{m['grad_norm']:.4f}; rollout {m['rollout_tokens']} tokens in "
            f"{m['rollout_s']:.3f}s ({m['rollout_tokens'] / m['rollout_s']:.1f}"
            f" rollout tok/s), learner step {upd:.4f}s, publish "
            f"{m['publish_s'] * 1e3:.3f} ms, weights_version "
            f"{int(m['weights_version'])}")
        if int(m["weights_version"]) != it + 1 or not np.isfinite(m["loss"]):
            raise AssertionError(f"rl: iteration {it + 1} left weights "
                                 f"version {m['weights_version']}, loss "
                                 f"{m['loss']}")
    launches = check_rl_launches(
        "rl", records,
        lambda d, c: {"paged_decode_attention": n * d,
                      "ragged_prefill_attention": n * c,
                      "flash_attention": 0, "flash_attention_bwd": 0},
        {"paged_decode_attention": 0, "ragged_prefill_attention": 0,
         "flash_attention": 2 * n, "flash_attention_bwd": n})
    steps = sum(r[1] for r in records)
    calls = sum(r[2] for r in records)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = rl.obs.metrics.histogram("rl.stage_to_install_s")
    log(f"[rl] qwen2-0.5b bf16 full width, {RL_ITERS} iterations of "
        f"{RL_PROMPTS} x {RL_GROUP} rollouts of {RL_PROMPT_LEN} + {RL_NEW} "
        f"tokens: launches {launches} over {steps} decode steps, {calls} "
        f"prefill calls and {RL_ITERS} updates (exactly {n} paged decodes "
        f"a decode step, {n} ragged prefills a call, {2 * n} flash and {n} "
        f"flash backwards an update); rl.stage_to_install_s mean "
        f"{st.sum / max(st.count, 1) * 1e3:.3f} ms over {st.count}; "
        f"compile keys {rl.obs.compiled_keys('sampler')} (sampler), "
        f"{len(rl.obs.compiled_keys('rl_step'))} rl_step; peak device "
        f"memory {peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    rl_profile(torch, np, rl, cfg)
    del rl
    gc.collect()
    torch.cuda.empty_cache()
    again = rl_session(torch, cfg, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN,
                       RL_NEW, 1)
    again.iterate(rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, 0),
                  diversity)
    replay = again.buffer.batch(pad_len_to=16)
    same = all(np.array_equal(replay[k], batches[0][k]) for k in replay)
    log(f"[rl] iteration 1 replayed in a second session from seed {SEED}: "
        f"tokens and logprobs bit-identical={same} ({int(batches[0]['mask'].sum())}"
        " response tokens)")
    if not same:
        raise AssertionError("rl: iteration 1's rollouts did not replay")
    return launches


def rl_profile(torch, np, rl, cfg):
    """torch.profiler over RL rollout decode steps: a group's seats all
    decoding, each step sampling every seat with the batched sampler."""
    from torch.profiler import ProfilerActivity, profile
    actor = rl.actor
    for p in rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, 9):
        actor.submit_group(p)
    sched = actor.engine.scheduler
    for _ in range(64):                  # until every seat decodes
        if sched.active and not sched.queue and all(
                r.state.value == "running" for r in sched.active):
            break
        actor.step()
    else:
        raise AssertionError("rl profile: the group never reached decode")
    n = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        for _ in range(n):
            actor.step()
        sync(torch)
        wall = time.perf_counter() - t0
    report_profile("rl profile", [("rollout decode step", prof, wall, n)])
    actor.drain()
    for g in list(actor.groups.values()):
        actor.release(g)


def phase_rl_identity(torch, np):
    """qwen2-0.5b at full width in float32 (phase 40): one iteration of the
    loop; the update's ratio_mean within 1e-3 of 1 and clip_fraction 0 (on
    policy: the actor's logprobs from the paged kernels, the learner's from
    the flash forward); then, after the publish, a greedy rollout_greedy
    probe through the actor identical to a fresh Generator built on the
    learner's params, token for token."""
    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")
    rl = rl_session(torch, cfg, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    1)
    m = rl.iterate(rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, 0),
                   diversity)
    probe = rl_prompts(np, cfg, 1, RL_ID_PROMPT, 7)[0]
    got = rl.rollout_greedy(probe, RL_ID_NEW)
    gen = Generator(cfg, rl.learner.params,
                    max_len=RL_ID_PROMPT + RL_ID_NEW + 8, device=DEVICE)
    want = gen.generate(torch.tensor([probe], device=DEVICE),
                        GenerateConfig(max_new_tokens=RL_ID_NEW))
    want = want[0, RL_ID_PROMPT:].tolist()
    log(f"[rl identity] f32 full width, one iteration of {RL_PROMPTS} x "
        f"{RL_GROUP} rollouts: ratio_mean {m['ratio_mean']:.9f} (limit 1 +- "
        f"1e-3), clip_fraction {m['clip_fraction']}, weights_version "
        f"{int(m['weights_version'])}; greedy probe of {RL_ID_PROMPT} + "
        f"{RL_ID_NEW} tokens through the actor identical to a fresh "
        f"Generator on the learner's params={got == want}")
    if not abs(m["ratio_mean"] - 1) <= 1e-3 or m["clip_fraction"] != 0:
        raise AssertionError("rl identity: the first update is not on policy")
    if got != want or int(m["weights_version"]) != 1:
        raise AssertionError("rl identity: the published weights are not "
                             "the learner's")
    # phases 43 and 44 are held to this run: its batch (the rollouts'
    # tokens and logprobs), its loss, the learner's params and the probe;
    # phase 43 also to a second update on the same batch, whose metrics
    # are read off the params and AdamW state the first update left
    batch = rl.buffer.batch(pad_len_to=16)
    params = rl.learner.params
    m2 = rl.learner.update(batch)
    log(f"[rl identity] a second update on the same batch: loss "
        f"{m2['loss']:+.9e} (the first's {m['loss']:+.9e}), ratio_mean "
        f"{m2['ratio_mean']:.9f}, grad_norm {m2['grad_norm']:.9e} (the "
        f"first's {m['grad_norm']:.9e})")
    return dict(batch=batch, loss=m["loss"], metrics=m, metrics2=m2,
                params=params, probe=probe, probe_tokens=got)


def phase_rl_moe(torch, np):
    """deepseek-v2-lite-16b cut to DS_TRAIN_LAYERS layers (the dense first
    and three MoE), ragged on both sides, bf16 (phase 41): one iteration of
    DS_RL_PROMPTS x DS_RL_GROUP rollouts.  Exactly 4 MLA decodes and 9
    grouped matmuls a decode step, 4 flash and 9 grouped matmuls a prefill
    call; an update 8 flash forwards, 4 backwards, 18 grouped matmuls (3 a
    MoE layer and forward, the remat's included) and 9 of each grouped
    matmul backward kernel."""
    from repro_torch.configs.base import MOE_FFN, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.paged_decode_attention import \
        paged_mla_decode_attention
    cfg = dataclasses.replace(get_config(DS_ARCH),
                              num_layers=DS_TRAIN_LAYERS)
    n = cfg.num_layers
    moe = sum(f == MOE_FFN for _, f in cfg.block_kinds())
    kernels = {"paged_mla_decode_attention": paged_mla_decode_attention,
               "flash_attention": fa.flash_attention,
               "flash_attention_bwd": fa.flash_attention_bwd,
               "grouped_matmul": gm.grouped_matmul,
               "grouped_matmul_bwd_dx": gm.grouped_matmul_bwd_dx,
               "grouped_matmul_bwd_dw": gm.grouped_matmul_bwd_dw}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rl = rl_session(torch, cfg, DS_RL_PROMPTS, DS_RL_GROUP,
                    DS_RL_PROMPT_LEN, DS_RL_NEW, 1)
    records = count_rl_launches(torch, rl, kernels)
    for w in kernels.values():
        w.launches = 0
    m = rl.iterate(rl_prompts(np, cfg, DS_RL_PROMPTS, DS_RL_PROMPT_LEN, 0),
                   diversity)
    launches = check_rl_launches(
        "rl moe", records,
        lambda d, c: {"paged_mla_decode_attention": n * d,
                      "flash_attention": n * c, "flash_attention_bwd": 0,
                      "grouped_matmul": 3 * moe * (d + c),
                      "grouped_matmul_bwd_dx": 0,
                      "grouped_matmul_bwd_dw": 0},
        {"paged_mla_decode_attention": 0, "flash_attention": 2 * n,
         "flash_attention_bwd": n, "grouped_matmul": 6 * moe,
         "grouped_matmul_bwd_dx": 3 * moe,
         "grouped_matmul_bwd_dw": 3 * moe})
    upd = [r for r in records if r[0] == "update"][-1][4]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[rl moe] {DS_ARCH} bf16 full width, {n} layers ({moe} MoE), "
        f"ragged actor and learner: loss {m['loss']:+.6f} ratio_mean "
        f"{m['ratio_mean']:.6f} grad_norm {m['grad_norm']:.4f}, rollout "
        f"{m['rollout_tokens']} tokens in {m['rollout_s']:.3f}s, learner "
        f"step {upd:.4f}s, publish {m['publish_s'] * 1e3:.3f} ms, "
        f"weights_version {int(m['weights_version'])}; launches {launches} "
        f"(per decode step {n} MLA decodes and {3 * moe} grouped matmuls, "
        f"per prefill call {n} flash and {3 * moe}, per update {2 * n} "
        f"flash, {n} backwards, {6 * moe} grouped matmuls, {3 * moe} of each "
        f"backward kernel); peak device memory {peak:.2f} GiB")
    if int(m["weights_version"]) != 1 or not np.isfinite(m["loss"]) \
            or not np.isfinite(m["grad_norm"]):
        raise AssertionError("rl moe: the iteration did not publish a "
                             "finite update")
    return launches


# ---------------------------------------------------------------------------
# phases 42-44: HyperMPMD on the card.  Phases 42 and 44 run two processes
# on the one card, this one and a child (``python3 chip_smoke.py
# --mpmd-child ROLE DIR RANK``), joined by gloo through a FileStore in a
# temporary directory (NCCL refuses two ranks on one card); the hand-offs
# go through pinned host buffers (repro_torch.core.mpmd).  Both processes
# make the same calls in the same order (the port's contract for role
# groups); the child writes what it measured to DIR/child.json.
# ---------------------------------------------------------------------------
MPMD_TIMEOUT_S = 300     # gloo's bound on a receive: a dead peer fails fast


@contextlib.contextmanager
def mpmd_pair(child_role, main_rank):
    """A two-rank gloo world of this process (``main_rank``) and a child
    running ``child_role`` on the same card.  Yields a function that waits
    for the child (with a deadline) and returns its report, raising if it
    exited with another code than 0; a failure here kills the child, and
    the child is always waited for."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mpmd_")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mpmd-child",
         child_role, tmp, str(1 - main_rank)])

    def report():
        try:
            rc = child.wait(timeout=MPMD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            child.kill()
            raise AssertionError(f"{child_role} child did not exit within "
                                 f"{MPMD_TIMEOUT_S} s")
        if rc != 0:
            raise AssertionError(f"{child_role} child exited with {rc}")
        with open(os.path.join(tmp, "child.json")) as f:
            return json.load(f)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=main_rank,
            world_size=2, timeout=datetime.timedelta(seconds=MPMD_TIMEOUT_S))
        try:
            yield report
        finally:
            dist.destroy_process_group()
    except BaseException:
        child.kill()
        raise
    finally:
        child.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def mpmd_child(role, tmp, rank):
    """The child's side of phase 42 (``prefill``), 44 (``learner``) or 46
    (``pipeline``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=int(rank),
        world_size=2, timeout=datetime.timedelta(seconds=MPMD_TIMEOUT_S))
    try:
        out = (disagg_serve_runs(torch, np) if role == "prefill"
               else pipeline_mpmd_runs(torch, np) if role == "pipeline"
               else rl_disagg_runs(torch, np, None))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, "child.json"), "w") as f:
        json.dump(out, f)
    return 0


def disagg_serve_runs(torch, np):
    """Phase 42's calls, the same on both processes (rank 0 the prefill
    group, rank 1 the decode group): qwen2-0.5b bf16 at phase 4's config,
    its warm-up and its SERVE_REQUESTS requests, then the f32 identity at
    phase 10's config and prompts.  On the prefill rank returns the flash launches of every dense prefill call and the
    launches of every other serving kernel; on the decode rank the
    decode side's records."""
    from repro_torch.configs.base import ServeConfig, get_config
    from repro_torch.core import mpmd
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.models import model as M
    from repro_torch.serve.api import HyperServe
    wrappers = (paged_decode_attention, ragged_prefill_attention,
                decode_attention, flash_attention)
    groups = mpmd.serving_groups(1, 1)
    decode = groups["decode"].has()
    cfg = get_config("qwen2-0.5b")
    params = M.init_model(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg = ServeConfig(block_size=BS, num_blocks=NUM_BLOCKS,
                       max_blocks_per_req=TABLE_W, max_slots=DEC_B,
                       prefill_chunk=PRE_C, prefill_batch=PRE_P)
    serve = HyperServe(cfg, params, serve_cfg=scfg, device=DEVICE,
                       prefill_group=groups["prefill"],
                       decode_group=groups["decode"])
    rng = np.random.default_rng(SEED)
    serve_all(serve, make_prompts(rng, 2, 50, 60, cfg.vocab_size), 4)
    prompts = make_prompts(rng, SERVE_REQUESTS, 100, 1500, cfg.vocab_size)
    eng = serve.engine
    out = {"calls": []}
    hand = []
    if decode:
        m = eng.obs.metrics
        before = {k: m.counter(k).value for k in
                  ("serve.kernels.decode.fused", "serve.prefill_calls",
                   "serve.prefill_chunks", "mpmd.tasks.prefill")}
        itl0, tokens0 = m.histogram("serve.itl_s").sum, eng.tokens_generated
        transfer = mpmd.transfer

        def timed_transfer(*a, **kw):
            # the KV hand-off of one prefill call, from the decode side:
            # the child's copy off the card, gloo, the copy onto it
            t0 = time.perf_counter()
            got = transfer(*a, **kw)
            sync(torch)
            hand.append((time.perf_counter() - t0, sum(
                t.numel() * t.element_size() for t in tree_leaves(got))))
            return got
        mpmd.transfer = timed_transfer
    else:
        prefill = eng._prefill

        def counted_prefill(toks, lens):
            n0 = {w.__name__: w.launches for w in wrappers}
            prefill(toks, lens)
            out["calls"].append(
                [list(toks.shape), {w.__name__: w.launches - n0[w.__name__]
                                    for w in wrappers}])
        eng._prefill = counted_prefill
    # the main path's run: every launch count starts at 0 here
    for w in wrappers:
        w.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    try:
        outs, rids = serve_all(serve, prompts, 64)
        sync(torch)
    finally:
        if decode:
            mpmd.transfer = transfer
    wall = time.perf_counter() - t0
    out["launches"] = {w.__name__: w.launches for w in wrappers}
    st = serve.stats()
    if decode:
        d = {k: m.counter(k).value - v for k, v in before.items()}
        steps = int(d["serve.kernels.decode.fused"])
        tokens = eng.tokens_generated - tokens0
        decode_s = m.histogram("serve.itl_s").sum - itl0
        ttfts = sorted(serve.request_meta(r)["ttft_s"] for r in rids)
        out.update(steps=steps, calls=int(d["serve.prefill_calls"]),
                   chunks=int(d["serve.prefill_chunks"]), wall=wall,
                   tokens=tokens, decode_s=decode_s,
                   decode_tokens=tokens - len(prompts),
                   ttft_s=ttfts[len(ttfts) // 2], hand=hand,
                   finished=sum(serve.state(r) == "finished" for r in rids),
                   lengths=[len(o) for o in outs],
                   prefix_hits=st["prefix_hits"],
                   tasks=int(d["mpmd.tasks.prefill"]))
    del serve, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init_model(
        cfg32, torch.Generator(device=DEVICE).manual_seed(SEED))
    scfg32 = ServeConfig(block_size=BS, num_blocks=512,
                         max_blocks_per_req=ID_TABLE_W, max_slots=ID_SLOTS,
                         prefill_chunk=PRE_C, prefill_batch=PRE_P)
    prompts32 = make_prompts(np.random.default_rng(SEED + 2), 6, 100,
                             ID_PROMPT_MAX, cfg.vocab_size)
    out["f32"], _ = serve_all(HyperServe(
        cfg32, params32, serve_cfg=scfg32, device=DEVICE,
        prefill_group=groups["prefill"], decode_group=groups["decode"]),
        prompts32, ID_NEW)
    if decode:
        from repro_torch.serve.engine import GenerateConfig, Generator
        out["generator"] = [Generator(
            cfg32, params32, max_len=len(p) + ID_NEW + 8, device=DEVICE)
            .generate(torch.tensor([p], device=DEVICE),
                      GenerateConfig(max_new_tokens=ID_NEW))[0, len(p):]
            .tolist() for p in prompts32]
    return out


def phase_disagg_serve(torch, np, serve_summary, fused):
    """Phase 42: qwen2-0.5b served disaggregated, the prefill group a child
    process on the same card (rank 0), this process the decode group (rank
    1).  bf16 at phase 4's config and requests: exactly 24 flash_attention
    a dense prefill call in the child and nothing else there, exactly 24
    paged_decode_attention a decode step here and no ragged prefill; every
    request finished with 64 tokens; median TTFT, decode tok/s, the
    decode-step wall beside phase 4's, the KV hand-off's ms and GB/s a
    call.  f32 at phase 10's config and prompts: greedy tokens identical
    to the aggregated engine's (phase 10's) and to the Generator's.
    Returns {kernel: launches} of the run, both processes', and the
    kernel JSON's flash row at the child's largest call
    (:func:`disagg_flash_row`)."""
    from repro_torch.configs.base import get_config
    n = get_config("qwen2-0.5b").num_layers
    with mpmd_pair("prefill", 1) as child_report:
        got = disagg_serve_runs(torch, np)
        child = child_report()
    steps, calls = got["steps"], got["calls"]
    hand = got["hand"]
    ms = [t * 1e3 for t, _ in hand]
    gbs = [b / t / 1e9 for t, b in hand]
    mean_gb = sum(b for _, b in hand) / max(len(hand), 1) / 1e9
    step_s = got["decode_s"] / steps
    log(f"[disagg serve] qwen2-0.5b bf16 full width, prefill in a child "
        f"process (rank 0), decode here (rank 1), gloo through pinned host "
        f"buffers: {got['finished']}/{SERVE_REQUESTS} requests finished, "
        f"{got['tokens']} tokens in {got['wall']:.3f}s, decode "
        f"{got['decode_tokens']} tokens in {steps} steps, "
        f"{got['decode_s']:.3f}s ({got['decode_tokens'] / got['decode_s']:.1f}"
        f" decode tok/s; phase 4: {serve_summary['decode_tok_s']:.1f}), "
        f"median TTFT {got['ttft_s']:.3f}s (phase 4: "
        f"{serve_summary['ttft_s']:.3f}s), decode-step wall "
        f"{step_s * 1e3:.3f} ms (phase 4: {serve_summary['step_s'] * 1e3:.3f}"
        f" ms); prefill_calls={calls} prefill_chunks={got['chunks']}, "
        f"prefix_hits={got['prefix_hits']}, mpmd.tasks.prefill="
        f"{got['tasks']}")
    log(f"[disagg serve] KV hand-off per call ({len(hand)} calls, "
        f"{mean_gb:.4f} GB mean): ms {[round(x, 3) for x in ms]}, GB/s "
        f"{[round(x, 3) for x in gbs]}")
    log(f"[disagg serve] prefill child's dense calls (Pb, padded) and "
        f"launches: {child['calls']}; child total {child['launches']}, "
        f"decode side {got['launches']}")
    for shape, la in child["calls"]:
        if la != {"paged_decode_attention": 0, "ragged_prefill_attention": 0,
                  "decode_attention": 0, "flash_attention": n}:
            raise AssertionError(f"disagg serve: a dense prefill call "
                                 f"{shape} launched {la}")
    want = {"paged_decode_attention": n * steps, "ragged_prefill_attention": 0,
            "decode_attention": 0, "flash_attention": 0}
    if got["launches"] != want or len(child["calls"]) != calls \
            or calls == 0 or got["tasks"] != calls:
        raise AssertionError(f"disagg serve: decode side launched "
                             f"{got['launches']}, expected {want}; "
                             f"{len(child['calls'])} child calls for {calls}")
    if got["finished"] != SERVE_REQUESTS or set(got["lengths"]) != {64}:
        raise AssertionError("disagg serve: not every request finished "
                             "with 64 tokens")
    same_agg = got["f32"] == fused == child["f32"]
    same_gen = got["f32"] == got["generator"]
    log(f"[disagg serve] f32 identity, phase 10's {len(fused)} prompts x "
        f"{ID_NEW} tokens: tokens identical to the aggregated engine's "
        f"(phase 10) on both ranks={same_agg}, to the Generator's="
        f"{same_gen}")
    if not (same_agg and same_gen):
        raise AssertionError("disagg serve: f32 tokens differ")
    launches = {"flash_attention": sum(la["flash_attention"]
                                       for _, la in child["calls"]),
                "paged_decode_attention": got["launches"][
                    "paged_decode_attention"]}
    return launches, [disagg_flash_row(torch, [s for s, _ in
                                               child["calls"]])]


def disagg_flash_row(torch, shapes):
    """The ``flash_attention_disagg`` row of the kernel JSON: the kernel at
    the largest (Pb, padded) dense prefill call of phase 42's prefill
    child, bf16 at qwen2-0.5b's heads, on seeded inputs: its error against
    the plain version (phase 3's limits; a share above 1 raises), its
    time, the plain version's, SDPA's, and the bound of the whole padded
    block (the dense prefill computes every padded position of every
    row)."""
    from repro_torch.kernels import perf_model as pm
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    Pb, S = max(shapes, key=lambda s: s[0] * s[1])
    q, k, v = flash_inputs(torch, torch.bfloat16, DEVICE, H, KV, D, Pb, S, S)
    want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=True)
    err, share = parity(torch, "bfloat16", flash_attention(q, k, v,
                                                           causal=True),
                        flash_attention_ref(q, k, v, causal=True), want32)
    del want32
    if not share <= 1.0:
        raise AssertionError(f"flash_attention at the disaggregated "
                             f"prefill's ({Pb}, {S}): error share {share}")
    cost = pm.prefill_visible_cost([0] * Pb, [S] * Pb, S, num_heads=H,
                                   kv_heads=KV, head_dim=D, itemsize=2)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), torch)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       torch)
    library_ms = time_ms(sdpa_flash(torch, q, k, v), torch)
    bound_ms = cost.bound_seconds("bfloat16") * 1e3
    log(f"[disagg serve] flash_attention at the child's largest dense "
        f"prefill call ({Pb}, {S}) bf16: max abs err {err:.3e} (share "
        f"{share:.3f} of the limit), {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({cost.bound_by('bfloat16')}), SDPA "
        f"causal, enable_gqa (transposes excluded) {library_ms:.4f} ms")
    return {"name": "flash_attention_disagg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:87",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": cost.bound_by("bfloat16"), "library_ms": library_ms,
            "path": "qwen2-0.5b disagg"}


def phase_rl_mesh(torch, np, mesh, rl_summary, rl_id):
    """Phase 43: GRPO with the learner on the one-rank NCCL (1, 1) mesh of
    ``one_rank_group`` under fsdp_tp and the actor on the same mesh's
    serving view.  bf16 at phase 39's config: phase 39's exact launches
    (24 paged decodes a decode step, 24 ragged prefills a call, 48 flash
    and 24 backwards an update), the first update's ratio_mean within
    1e-3 of 1 and clip_fraction 0, the learner step and publish walls
    beside phase 39's.  f32 at phase 40's config: iteration 1's rollouts
    (tokens and logprobs) identical to phase 40's without the mesh, the
    loss within 1e-5 relative, the greedy probe after the publish
    identical to a fresh Generator's on the learner's params, the params
    after the update within phase 25's limits of phase 40's (AdamW's bound
    of one step, 2 lr, and an f32 rounding), and a second update on the
    same batch (its metrics read off the params and AdamW state the first
    left on the mesh) within 1e-5 relative of phase 40's second."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.models.bridge import full_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import GenerateConfig, Generator
    cfg = get_config("qwen2-0.5b")
    n = cfg.num_layers
    kernels = {"paged_decode_attention": paged_decode_attention,
               "ragged_prefill_attention": ragged_prefill_attention,
               "flash_attention": fa.flash_attention,
               "flash_attention_bwd": fa.flash_attention_bwd}
    rl = rl_session(torch, cfg, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    RL_ITERS, mesh=mesh)
    records = count_rl_launches(torch, rl, kernels)
    for w in kernels.values():
        w.launches = 0
    hist = []
    for it in range(RL_ITERS):
        m = rl.iterate(rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, it),
                       diversity)
        upd = [r for r in records if r[0] == "update"][-1][4]
        hist.append((m, upd))
        log(f"[rl mesh] iteration {it + 1}: loss {m['loss']:+.6f} "
            f"ratio_mean {m['ratio_mean']:.6f} clip_fraction "
            f"{m['clip_fraction']:.4f}; rollout {m['rollout_tokens']} "
            f"tokens in {m['rollout_s']:.3f}s "
            f"({m['rollout_tokens'] / m['rollout_s']:.1f} rollout tok/s; "
            f"phase 39: {rl_summary['rollout_tok_s'][it]:.1f}), learner "
            f"step {upd:.4f}s (phase 39: {rl_summary['update_s'][it]:.4f}s)"
            f", publish {m['publish_s'] * 1e3:.3f} ms (phase 39: "
            f"{rl_summary['publish_s'][it] * 1e3:.3f} ms), weights_version "
            f"{int(m['weights_version'])}")
        if int(m["weights_version"]) != it + 1 or not np.isfinite(m["loss"]):
            raise AssertionError(f"rl mesh: iteration {it + 1} left version "
                                 f"{m['weights_version']}, loss {m['loss']}")
    launches = check_rl_launches(
        "rl mesh", records,
        lambda d, c: {"paged_decode_attention": n * d,
                      "ragged_prefill_attention": n * c,
                      "flash_attention": 0, "flash_attention_bwd": 0},
        {"paged_decode_attention": 0, "ragged_prefill_attention": 0,
         "flash_attention": 2 * n, "flash_attention_bwd": n})
    first = hist[0][0]
    log(f"[rl mesh] launches {launches} (phase 39's per step and update); "
        f"first update ratio_mean {first['ratio_mean']:.6f} (limit 1 +- "
        f"1e-3; phase 39: {rl_summary['ratio_clip'][0][0]:.6f}), "
        f"clip_fraction {first['clip_fraction']} (phase 39: "
        f"{rl_summary['ratio_clip'][0][1]})")
    if not abs(first["ratio_mean"] - 1) <= 1e-3 \
            or first["clip_fraction"] != 0:
        raise AssertionError("rl mesh: the first update is not on policy")
    del rl, records
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rl = rl_session(torch, cfg32, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    1, mesh=mesh)
    m = rl.iterate(rl_prompts(np, cfg32, RL_PROMPTS, RL_PROMPT_LEN, 0),
                   diversity)
    batch = rl.buffer.batch(pad_len_to=16)
    same = {k: bool(np.array_equal(batch[k], rl_id["batch"][k]))
            for k in batch}
    rel = abs(m["loss"] - rl_id["loss"]) / max(abs(rl_id["loss"]), 1e-30)
    got = rl.rollout_greedy(rl_id["probe"], RL_ID_NEW)
    params = full_params(rl.learner.params)
    gen = Generator(cfg32, params, max_len=RL_ID_PROMPT + RL_ID_NEW + 8,
                    device=DEVICE)
    want = gen.generate(torch.tensor([rl_id["probe"]], device=DEVICE),
                        GenerateConfig(max_new_tokens=RL_ID_NEW))
    want = want[0, RL_ID_PROMPT:].tolist()
    log(f"[rl mesh] f32, one iteration on the mesh: rollouts identical to "
        f"phase 40's without it {same}; loss {m['loss']:+.9f} vs "
        f"{rl_id['loss']:+.9f} (relative {rel:.3g}, limit 1e-5); ratio_mean "
        f"{m['ratio_mean']:.9f}; greedy probe after the publish identical "
        f"to a fresh Generator on the learner's params={got == want}")
    if not all(same.values()) or not rel <= 1e-5 or got != want:
        raise AssertionError("rl mesh: the f32 identity failed")
    # the update itself: the params after it against phase 40's at phase
    # 25's limits (AdamW's bound of one step and an f32 rounding), and a
    # second update on the same batch, whose metrics are read off the
    # params and AdamW state the first left on the mesh, against phase
    # 40's second within 1e-5 relative
    want_p = dict(tree_flatten_with_path(rl_id["params"]))
    diffs = {k: (t - want_p[k]).abs() for k, t in
             tree_flatten_with_path(params)}
    big = max(t.abs().max().item() for t in want_p.values())
    adamw = AdamWConfig()
    bound = (2 * m["lr"] * adam_step_bound(adamw.b1, adamw.b2, 1)
             + 2 * big * 2.0 ** -23)
    dmax = max(d.max().item() for d in diffs.values())
    differ = sum(int((d > 0).sum()) for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    del diffs, params
    m2 = rl.learner.update(batch)
    w2 = rl_id["metrics2"]
    rel2 = {k: abs(m2[k] - w2[k]) / max(abs(w2[k]), 1e-30)
            for k in ("loss", "ratio_mean", "grad_norm")}
    moved = {k: abs(w2[k] - rl_id["metrics"][k]) / max(abs(w2[k]), 1e-30)
             for k in rel2}
    log(f"[rl mesh] f32 params after the update vs phase 40's: max |diff| "
        f"{dmax:.3e} against AdamW's bound {bound:.3e} (lr {m['lr']:.3e}), "
        f"{differ} of {total} weights differ at all; a second update on the "
        f"same batch: loss {m2['loss']:+.9e} vs {w2['loss']:+.9e}, relative "
        f"differences {rel2} (limit 1e-5; phase 40's second update moved "
        f"them from its first by {moved}, relative)")
    if not dmax <= bound or not all(v <= 1e-5 for v in rel2.values()):
        raise AssertionError("rl mesh: the update on the mesh is not phase "
                             "40's")
    return launches


def rl_disagg_runs(torch, np, rl_id):
    """Phase 44's calls, the same on both processes (rank 0 the actor,
    rank 1 the learner): ``rl_disagg`` with roles 1 + 1, one f32 iteration
    at phase 40's config, then RL_ITERS bf16 iterations at phase 39's.
    On the learner rank (``rl_id`` None) returns each update's launches
    and wall; on the actor rank its side's records."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.ragged_prefill_attention import \
        ragged_prefill_attention
    roles = {"actor": 1, "learner": 1}
    cfg = get_config("qwen2-0.5b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {}
    rl = rl_session(torch, cfg32, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    1, roles=roles)
    m = rl.iterate(rl_prompts(np, cfg32, RL_PROMPTS, RL_PROMPT_LEN, 0),
                   diversity)
    tasks = {k: rl.obs.metrics.counter(f"mpmd.tasks.{k}").value
             for k in ("actor", "learner")}
    out["f32"] = dict(loss=m["loss"], tasks=tasks)
    if rl.actor is not None:
        batch = rl.buffer.batch(pad_len_to=16)
        out["f32"]["same_batch"] = {
            k: bool(np.array_equal(batch[k], rl_id["batch"][k]))
            for k in batch}
        want = dict(tree_flatten_with_path(rl_id["params"]))
        got = tree_flatten_with_path(rl.actor.engine.params)
        out["f32"]["same_params"] = all(torch.equal(t, want[k])
                                        for k, t in got)
        out["f32"]["leaves"] = len(got)
    del rl
    gc.collect()
    torch.cuda.empty_cache()
    kernels = {"paged_decode_attention": paged_decode_attention,
               "ragged_prefill_attention": ragged_prefill_attention,
               "flash_attention": fa.flash_attention,
               "flash_attention_bwd": fa.flash_attention_bwd}
    rl = rl_session(torch, cfg, RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW,
                    RL_ITERS, roles=roles)
    records = []

    def snap():
        return {k: w.launches for k, w in kernels.items()}
    if rl.actor is not None:
        eng = rl.actor.engine
        step, mt = eng.step, eng.obs.metrics

        def counted_step():
            n0, d0, c0 = snap(), mt.counter(
                "serve.kernels.decode.fused").value, eng.prefill_calls
            res = step()
            n1 = snap()
            records.append(("step", int(mt.counter(
                "serve.kernels.decode.fused").value - d0),
                eng.prefill_calls - c0, {k: n1[k] - n0[k] for k in n1}, 0.0))
            return res
        eng.step = counted_step
    else:
        update = rl.learner.update

        def counted_update(batch):
            n0 = snap()
            sync(torch)
            t0 = time.perf_counter()
            res = update(batch)
            sync(torch)
            wall = time.perf_counter() - t0
            n1 = snap()
            records.append(("update", 0, 0, {k: n1[k] - n0[k] for k in n1},
                            wall))
            return res
        rl.learner.update = counted_update
    # the main path's run: every launch count starts at 0 here
    for w in kernels.values():
        w.launches = 0
    out["iters"] = []
    for it in range(RL_ITERS):
        m = rl.iterate(rl_prompts(np, cfg, RL_PROMPTS, RL_PROMPT_LEN, it),
                       diversity)
        out["iters"].append({k: float(v) for k, v in m.items()})
    out["util"] = rl.utilization_report()
    out["tasks"] = {k: rl.obs.metrics.counter(f"mpmd.tasks.{k}").value
                    for k in ("actor", "learner")}
    out["records"] = records
    out["nbytes"] = sum(t.numel() * t.element_size() for _, t in
                        tree_flatten_with_path(
                            rl.actor.engine.params if rl.actor is not None
                            else rl.learner.params))
    return out


def phase_rl_disagg(torch, np, rl_summary, rl_id):
    """Phase 44: ``rl_disagg`` with roles 1 + 1: this process the actor
    (rank 0), a child process on the same card the learner (rank 1),
    gloo through pinned host buffers.  f32 at phase 40's config: the
    rollouts, the loss and every param after the update identical, bit for
    bit, to phase 40's colocated run.  bf16 at phase 39's config: exactly
    24 paged decodes a decode step and 24 ragged prefills a call here, 48
    flash and 24 backwards an update in the child; mpmd.tasks.actor and
    .learner equal to the iterations on both ranks; the publish wall and
    GB/s, rollout tok/s, the learner step wall and utilization_report()
    for both roles.  Returns {kernel: launches}, both processes'."""
    from repro_torch.configs.base import get_config
    n = get_config("qwen2-0.5b").num_layers
    with mpmd_pair("learner", 0) as child_report:
        got = rl_disagg_runs(torch, np, rl_id)
        child = child_report()
    f32 = got["f32"]
    log(f"[rl disagg] f32 at phase 40's config: rollouts identical to "
        f"phase 40's {f32['same_batch']}; loss {f32['loss']:+.9f} vs "
        f"{rl_id['loss']:+.9f} (the learner child's {child['f32']['loss']:+.9f}"
        f"); all {f32['leaves']} published params equal to phase 40's "
        f"learner's, bit for bit={f32['same_params']}; mpmd.tasks {f32['tasks']}"
        f" (child {child['f32']['tasks']})")
    if not (all(f32["same_batch"].values()) and f32["same_params"]
            and f32["loss"] == rl_id["loss"] == child["f32"]["loss"]
            and f32["tasks"] == child["f32"]["tasks"]
            == {"actor": 1, "learner": 1}):
        raise AssertionError("rl disagg: the f32 run is not phase 40's")
    upd = [r for r in child["records"] if r[0] == "update"]
    for it, (m, u) in enumerate(zip(got["iters"], upd)):
        log(f"[rl disagg] iteration {it + 1}: loss {m['loss']:+.6f} "
            f"ratio_mean {m['ratio_mean']:.6f}; rollout "
            f"{int(m['rollout_tokens'])} tokens in {m['rollout_s']:.3f}s "
            f"({m['rollout_tokens'] / m['rollout_s']:.1f} rollout tok/s; "
            f"phase 39: {rl_summary['rollout_tok_s'][it]:.1f}), learner "
            f"step {u[4]:.4f}s in the child (phase 39: "
            f"{rl_summary['update_s'][it]:.4f}s), publish "
            f"{m['publish_s'] * 1e3:.3f} ms for {got['nbytes'] / 1e9:.4f} GB "
            f"({got['nbytes'] / m['publish_s'] / 1e9:.3f} GB/s; phase 39's "
            f"rebind {rl_summary['publish_s'][it] * 1e3:.3f} ms), "
            f"weights_version {int(m['weights_version'])}")
        if int(m["weights_version"]) != it + 1 or not np.isfinite(m["loss"]):
            raise AssertionError(f"rl disagg: iteration {it + 1}")
    log(f"[rl disagg] utilization_report() here {got['util']}, in the child "
        f"{child['util']}; mpmd.tasks here {got['tasks']}, in the child "
        f"{child['tasks']}")
    want_tasks = {"actor": RL_ITERS, "learner": RL_ITERS}
    if got["tasks"] != want_tasks or child["tasks"] != want_tasks \
            or got["util"] != child["util"] \
            or set(got["util"]) != {"actor", "learner"}:
        raise AssertionError("rl disagg: tasks or utilization differ")
    actor = check_rl_launches(
        "rl disagg actor", [tuple(r) for r in got["records"]],
        lambda d, c: {"paged_decode_attention": n * d,
                      "ragged_prefill_attention": n * c,
                      "flash_attention": 0, "flash_attention_bwd": 0}, None)
    learner = check_rl_launches(
        "rl disagg learner", [tuple(r) for r in child["records"]], None,
        {"paged_decode_attention": 0, "ragged_prefill_attention": 0,
         "flash_attention": 2 * n, "flash_attention_bwd": n})
    if len(upd) != RL_ITERS:
        raise AssertionError(f"rl disagg: {len(upd)} updates")
    log(f"[rl disagg] launches: actor {actor}, learner {learner}")
    return {"paged_decode_attention": actor["paged_decode_attention"],
            "ragged_prefill_attention": actor["ragged_prefill_attention"],
            "flash_attention": learner["flash_attention"],
            "flash_attention_bwd": learner["flash_attention_bwd"]}


# ---------------------------------------------------------------------------
# Phases 45-46: the 1F1B pipeline trainer (repro_torch.train.
# pipeline_trainer) on qwen2-0.5b, colocated and with stage 1 in a child
# process on the same card (``--mpmd-child pipeline``, as phases 42 and 44)
# ---------------------------------------------------------------------------
PIPE_COUNTERS = ("bubble_steps", "handoffs", "microbatches",
                 "tied_embed_syncs")


def run_pipeline(torch, cfg, shape, n_steps, micro, hook=None, obs=None):
    """``n_steps`` pipelined steps from SEED with AdamWConfig(total_steps=
    n_steps), PIPE_STAGES stages of ``micro`` micro-batches, through
    ``train_pipeline`` (colocated, or one process a stage inside
    :func:`mpmd_pair`'s world)."""
    from repro_torch.configs.base import PipelineConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer
    from repro_torch.train.pipeline_trainer import train_pipeline
    return train_pipeline(
        cfg, shape, pipeline=PipelineConfig(stages=PIPE_STAGES,
                                            micro_batches=micro),
        adamw=AdamWConfig(total_steps=n_steps), hook=hook, obs=obs,
        train_cfg=trainer.TrainConfig(num_steps=n_steps, log_every=1,
                                      seed=SEED),
        device=DEVICE)


def pipeline_bf16(torch, np, tag, n_steps, want):
    """qwen2-0.5b bf16 at full width through :func:`run_pipeline`:
    ``n_steps`` steps of phase 23's PIPE_B x TRAIN_S batches in PIPE_MICRO
    micro-batches.  Every step: loss and grad norm finite, exactly
    ``want`` launches of flash and its backward (this process's), and the
    schedule's counters (PIPE_STAGES stages: 2 S (S - 1) bubble slots,
    2 M (S - 1) hand-offs, M micro-batches and one tied-embedding sync).
    Returns (history, launches of the run, summary: median step, tok/s,
    peak, first step)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.obs import Observability
    cfg = get_config("qwen2-0.5b")
    shape = ShapeConfig(f"train_{TRAIN_S}_b{PIPE_B}", TRAIN_S, PIPE_B,
                        "train")
    S, M = PIPE_STAGES, PIPE_MICRO
    want_c = {"bubble_steps": 2 * S * (S - 1), "handoffs": 2 * M * (S - 1),
              "microbatches": M, "tied_embed_syncs": 1}
    wrappers = {k: train_wrappers()[k] for k in want}
    obs = Observability()
    seen = []
    last = {k: 0 for k in want}
    last_c = {k: 0 for k in PIPE_COUNTERS}

    def hook(m):
        now = {k: w.launches for k, w in wrappers.items()}
        c = {k: obs.metrics.counter(f"train.pipeline.{k}").value
             for k in PIPE_COUNTERS}
        step = {k: now[k] - last[k] for k in want}
        cstep = {k: c[k] - last_c[k] for k in PIPE_COUNTERS}
        seen.append((m, step, cstep))
        log(f"[{tag}] step {m['step']}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e} wall {m['wall_s']:.3f}s, "
            f"launches {step}, counters {cstep}")
        last.update(now)
        last_c.update(c)
    if DEVICE == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # this path's run: every launch count starts at 0 here
    for w in wrappers.values():
        w.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    params, hist = run_pipeline(torch, cfg, shape, n_steps, M, hook, obs)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else float("nan"))
    del params
    walls = [m["wall_s"] for m, _, _ in seen]
    step_s = sorted(b - a for a, b in zip(walls, walls[1:]))
    med = step_s[len(step_s) // 2]
    summary = dict(median_s=med, tok_s=PIPE_B * TRAIN_S / med, peak_gib=peak,
                   first_s=walls[0])
    log(f"[{tag}] qwen2-0.5b bf16 full width, {S} stages, {M} micro-batches "
        f"of {PIPE_B // M} x {TRAIN_S}, {n_steps} steps: {wall:.3f}s in all, "
        f"first step {walls[0]:.3f}s, median of steps 2-{n_steps} "
        f"{med:.4f}s ({summary['tok_s']:.1f} train tok/s), range "
        f"{step_s[0]:.4f}..{step_s[-1]:.4f}s; peak device memory "
        f"{peak:.2f} GiB; launches {launches}, expected per step {want}")
    if len(hist) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            for m, _, _ in seen):
        raise AssertionError(f"{tag}: a step's loss or grad norm is not "
                             "finite")
    if any(step != want or cstep != want_c for _, step, cstep in seen) \
            or launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(f"{tag}: launches or counters "
                             f"{[x[1:] for x in seen]}, expected {want} and "
                             f"{want_c} a step")
    return [m for m, _, _ in seen], launches, summary


def pipeline_profile(torch):
    """torch.profiler over one colocated pipeline step (after a warm step)
    of phase 45's bf16 configuration: device busy, idle share and the top
    device items, flash's forward and backward shares."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import PipelineConfig, get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.pipeline_trainer import PipelineTrainer
    cfg = get_config("qwen2-0.5b")
    tr = PipelineTrainer(cfg, PipelineConfig(stages=PIPE_STAGES,
                                             micro_batches=PIPE_MICRO),
                         adamw=AdamWConfig(total_steps=TRAIN_STEPS),
                         seed=SEED, device=DEVICE)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, global_batch=PIPE_B,
                                    seed=SEED), DEVICE)
    tr.step(next(loader))                                   # warm
    batch = next(loader)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        tr.step(batch)
        sync(torch)
        wall = time.perf_counter() - t0
    report_profile("pipeline profile", [("pipeline step", prof, wall, 1)],
                   {"flash forward": r"flash_kernel",
                    "flash backward": r"flash_bwd"})


def params_bound(torch, n_steps, ref):
    """AdamW's bound on two runs whose gradients differ only in rounding
    (phase_train_identity): sum_t 2 lr_t adam_step_bound(t), plus an f32
    rounding of the largest weight of ``ref`` a step."""
    from repro_torch.optim.adamw import AdamWConfig, schedule
    adamw = AdamWConfig(total_steps=n_steps)
    lrs = [float(schedule(adamw, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, n_steps + 1)]
    big = max(t.abs().max().item() for t in ref.values())
    return (sum(2 * lr * adam_step_bound(adamw.b1, adamw.b2, t)
                for t, lr in enumerate(lrs, 1))
            + 2 * n_steps * big * 2.0 ** -23)


def pipeline_f32_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32",
                               num_layers=PIPE_ID_LAYERS)


def pipeline_f32(torch):
    """The f32 pipeline at phase 25's shapes (PIPE_ID_LAYERS layers,
    TRAIN_ID_B x TRAIN_ID_S in PIPE_ID_MICRO micro-batches, TRAIN_ID_STEPS
    steps): the history and {path: param} of the merged params."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import tree_flatten_with_path
    params, hist = run_pipeline(
        torch, pipeline_f32_cfg(), ShapeConfig(
            "train_identity", TRAIN_ID_S, TRAIN_ID_B, "train"),
        TRAIN_ID_STEPS, PIPE_ID_MICRO)
    return hist, dict(tree_flatten_with_path(params))


def pipeline_f32_sequential(torch):
    """:func:`pipeline_f32`'s steps in the no-overlap order: the trainer's
    ``step(batch, dispatch="sequential")`` over the batches
    ``train_pipeline`` reads.  Each step's (loss, grad norm) and {path:
    param} of the merged params."""
    from repro_torch.configs.base import PipelineConfig
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.pipeline_trainer import PipelineTrainer
    cfg = pipeline_f32_cfg()
    tr = PipelineTrainer(cfg, PipelineConfig(stages=PIPE_STAGES,
                                             micro_batches=PIPE_ID_MICRO),
                         adamw=AdamWConfig(total_steps=TRAIN_ID_STEPS),
                         seed=SEED, device=DEVICE)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_ID_S,
                                    global_batch=TRAIN_ID_B, seed=SEED),
                         DEVICE)
    hist = []
    for _, batch in zip(range(TRAIN_ID_STEPS), loader):
        m = tr.step(batch, dispatch="sequential")
        hist.append((m["loss"], m["grad_norm"]))
    return hist, dict(tree_flatten_with_path(tr.merged_params()))


def phase_pipeline(torch, np, train_record, train_summary):
    """Phase 45: the 1F1B pipeline colocated (this process runs both
    stages).  bf16 (pipeline_bf16, TRAIN_STEPS steps): 192 flash and 96
    backward launches a step; step 1's loss and grad norm within PIPE_REL
    of phase 23's (``train_record``), every step within PIPE_REL or, where
    a step is not, within twice the distance between phase 23 and a second
    run of phase 23's steps made here only then (the bf16 backward's dQ
    atomics); the step wall,
    tok/s and peak beside phase 23's; a profile of one step
    (pipeline_profile).  f32 at phase 25's shapes, PIPE_ID_LAYERS layers:
    the pipeline against ``trainer.train`` (losses and grad norms within
    TRAIN_ID_REL, params within AdamW's bound) and the sequential dispatch
    equal to 1F1B bit for bit.  Returns (the f32 1F1B run's history and
    params, on the host, for phase 46; the bf16 run's launches; its
    summary)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.tree import tree_flatten_with_path
    n = get_config("qwen2-0.5b").num_layers
    want = {"flash_attention": 2 * n * PIPE_MICRO,
            "flash_attention_bwd": n * PIPE_MICRO}
    hist, launches, summary = pipeline_bf16(torch, np, "pipeline",
                                            TRAIN_STEPS, want)
    base = [m for m, _, _ in train_record[:TRAIN_STEPS]]

    def rel(a, b, k):
        return abs(a[k] - b[k]) / max(1.0, abs(b[k]))
    keys = ("loss", "grad_norm")
    first = max(rel(hist[0], base[0], k) for k in keys)
    worst = max(rel(a, b, k) for a, b in zip(hist, base) for k in keys)
    rerun, twice = [], None
    if worst > PIPE_REL:
        # phase 23's own spread, wanted only past PIPE_REL: a second
        # non-pipelined run of its steps
        run_train(torch, get_config("qwen2-0.5b"), ShapeConfig(
            f"train_{TRAIN_S}_b{TRAIN_B}", TRAIN_S, TRAIN_B, "train"),
            TRAIN_STEPS, rerun.append)
        twice = 2 * max(rel(a, b, k) for a, b in zip(rerun, base)
                        for k in keys)
    limit = PIPE_REL if twice is None else max(PIPE_REL, twice)
    for i, (a, b) in enumerate(zip(hist, base)):
        c = rerun[i] if rerun else None
        log(f"[pipeline] step {a['step']}: loss {a['loss']:.6f} vs phase 23 "
            f"{b['loss']:.6f}"
            + (f" (rerun {c['loss']:.6f})" if c else "")
            + f", grad_norm {a['grad_norm']:.6f} vs {b['grad_norm']:.6f}"
            + (f" (rerun {c['grad_norm']:.6f})" if c else ""))
    spread = (f"not run: every step within {PIPE_REL:.3e}" if twice is None
              else f"{twice:.3e}")
    log(f"[pipeline] bf16 against phase 23 (train) in this process: step 1 "
        f"within {first:.3e} relative (limit {PIPE_REL:.3e}), all "
        f"{TRAIN_STEPS} steps within {worst:.3e} (limit {limit:.3e}: the "
        f"larger of {PIPE_REL:.3e} and twice phase 23's distance from a "
        f"second non-pipelined run, {spread}); median step "
        f"{summary['median_s']:.4f}s vs {train_summary['median_s']:.4f}s "
        f"({summary['median_s'] / train_summary['median_s']:.3f}x), "
        f"{summary['tok_s']:.1f} vs {train_summary['tok_s']:.1f} train "
        f"tok/s, peak {summary['peak_gib']:.2f} vs "
        f"{train_summary['peak_gib']:.2f} GiB, first step "
        f"{summary['first_s']:.3f}s vs {train_summary['first_s']:.3f}s")
    if not first <= PIPE_REL or not worst <= limit:
        raise AssertionError(f"pipeline: the bf16 run parts from phase 23 "
                             f"(step 1 {first}, worst {worst})")
    del rerun
    torch.cuda.empty_cache()
    pipeline_profile(torch)
    torch.cuda.empty_cache()

    plain, plain_hist = run_train(torch, pipeline_f32_cfg(), ShapeConfig(
        "train_identity", TRAIN_ID_S, TRAIN_ID_B, "train"), TRAIN_ID_STEPS)
    plain = dict(tree_flatten_with_path(plain))
    pipe_hist, pipe = pipeline_f32(torch)
    id_worst = max(rel(a, b, k) for a, b in zip(pipe_hist, plain_hist)
                   for k in keys)
    bound = params_bound(torch, TRAIN_ID_STEPS, plain)
    dmax = max((pipe[k] - plain[k]).abs().max().item() for k in plain)
    moved = sum(int((pipe[k] != plain[k]).sum()) for k in plain)
    same_keys = sorted(pipe) == sorted(plain)
    del plain
    torch.cuda.empty_cache()
    seq_hist, seq = pipeline_f32_sequential(torch)
    seq_same = (seq_hist == [(m["loss"], m["grad_norm"]) for m in pipe_hist]
                and all(torch.equal(seq[k], pipe[k]) for k in pipe))
    del seq
    log(f"[pipeline] f32 identity, {PIPE_ID_LAYERS} of {n} layers, "
        f"{TRAIN_ID_STEPS} steps of "
        f"{TRAIN_ID_B} x {TRAIN_ID_S} in {PIPE_ID_MICRO} micro-batches, "
        f"{PIPE_STAGES} stages, against trainer.train: losses and grad "
        f"norms within {id_worst:.3e} relative (limit {TRAIN_ID_REL}), "
        f"params max |diff| {dmax:.3e} against AdamW's bound {bound:.3e}, "
        f"{moved} weights differ at all; the sequential dispatch equal to "
        f"1F1B bit for bit={seq_same}; losses "
        + ", ".join(f"{a['loss']:.7f}/{b['loss']:.7f}"
                    for a, b in zip(pipe_hist, plain_hist)))
    if not (same_keys and id_worst <= TRAIN_ID_REL and dmax <= bound
            and seq_same):
        raise AssertionError("pipeline: the f32 pipeline parts from the "
                             "non-pipelined trainer or from its sequential "
                             "dispatch")
    f32 = {"history": pipe_hist,
           "params": {k: t.cpu() for k, t in pipe.items()}}
    return f32, launches, summary


def time_handoffs(torch):
    """Both processes of phase 46 (rank 0 stage 0, rank 1 stage 1): each
    hand-off the pipeline makes, timed as a round trip through
    ``mpmd.Handoff`` (the sender's pinned host copy, the gloo send, the
    receiver's copy onto the card): the activation (1 x TRAIN_S x d_model
    bf16) goes to rank 1 and comes back as the cotangent (the same shape),
    the tied ``embed`` (padded_vocab x d_model bf16, the sync after each
    step) the same way.  On rank 0 returns, for each, the bytes, the
    median round trip over HANDOFF_REPEATS (after one warm-up) and whether
    every echo was exact."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import mpmd
    cfg = get_config("qwen2-0.5b")
    gm = mpmd.groups_from_mapping({"stage0": 1, "stage1": 1})
    a, b = gm["stage0"], gm["stage1"]
    me = mpmd.my_rank()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 46)
    wire = mpmd.Handoff()
    out = {}
    for name, shape in (("activation", (1, TRAIN_S, cfg.d_model)),
                        ("embed", (cfg.padded_vocab, cfg.d_model))):
        x = torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        times, exact = [], True
        for i in range(HANDOFF_REPEATS + 1):
            sync(torch)
            t0 = time.perf_counter()
            if me == a.leader:
                wire.send(x, a, b)
                y = wire.recv(shape, torch.bfloat16, b, a, DEVICE)
                sync(torch)
                wire.wait()
                exact &= bool(torch.equal(y, x))
            else:
                y = wire.recv(shape, torch.bfloat16, a, b, DEVICE)
                wire.send(y, b, a)
                wire.wait()
            if i:
                times.append(time.perf_counter() - t0)
        times.sort()
        out[name] = {"bytes": x.numel() * x.element_size(),
                     "round_trip_s": times[len(times) // 2],
                     "exact": exact}
    return out


def pipeline_mpmd_runs(torch, np):
    """Phase 46's calls, the same on both processes (rank 0 stage 0, rank
    1 stage 1): the f32 pipeline of phase 45's identity, the bf16 pipeline
    for PIPE_MPMD_STEPS steps, then the hand-off timings.  Each process's
    bf16 launches must be its stage's: 12 layers x PIPE_MICRO x (2 + 1).
    Returns what the parent checks (the f32 params on rank 0 only)."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    n = get_config("qwen2-0.5b").num_layers // PIPE_STAGES
    hist, params = pipeline_f32(torch)
    out = {"f32": hist}
    if dist.get_rank() == 0:
        out["f32_params"] = params
    del params
    torch.cuda.empty_cache()
    want = {"flash_attention": 2 * n * PIPE_MICRO,
            "flash_attention_bwd": n * PIPE_MICRO}
    out["bf16"], out["launches"], out["summary"] = pipeline_bf16(
        torch, np, "pipeline mpmd", PIPE_MPMD_STEPS, want)
    out["handoffs"] = time_handoffs(torch)
    return out


def phase_pipeline_mpmd(torch, np, pipe_f32, pipe_summary):
    """Phase 46: the pipeline with one process a stage: this process stage
    0 (rank 0), a child on the same card stage 1 (rank 1), gloo through
    pinned host memory.  f32: the losses, grad norms and every merged
    param bit for bit phase 45's colocated f32 run (the same kernels, the
    hand-offs exact copies, the norm's partial sums added in stage order),
    the child's history the same.  bf16: each process's launches exact
    (96 + 48 a step), the same history in both, the step wall beside
    phase 45's; the activation and embed hand-offs' ms and GB/s.
    Returns {kernel: launches} of both processes' bf16 runs."""
    with mpmd_pair("pipeline", 0) as child_report:
        got = pipeline_mpmd_runs(torch, np)
        child = child_report()
    want = pipe_f32["params"]
    params = got.pop("f32_params")
    same = (sorted(params) == sorted(want)
            and all(torch.equal(params[k].cpu(), want[k]) for k in want))
    keys = ("loss", "grad_norm", "lr")
    hist_same = ([[m[k] for k in keys] for m in got["f32"]]
                 == [[m[k] for k in keys] for m in child["f32"]]
                 == [[m[k] for k in keys] for m in pipe_f32["history"]])
    log(f"[pipeline mpmd] f32 at phase 45's identity config, stage 1 in the "
        f"child: losses {[m['loss'] for m in got['f32']]} (phase 45 "
        f"{[m['loss'] for m in pipe_f32['history']]}); losses, grad norms "
        f"and lr equal to phase 45's and the child's, bit for bit="
        f"{hist_same}; all {len(want)} merged params equal to phase 45's, "
        f"bit for bit={same}")
    if not (same and hist_same):
        raise AssertionError("pipeline mpmd: the f32 run is not phase 45's")
    bf_same = ([[m[k] for k in keys] for m in got["bf16"]]
               == [[m[k] for k in keys] for m in child["bf16"]])
    s, c = got["summary"], child["summary"]
    log(f"[pipeline mpmd] bf16: launches here {got['launches']}, in the "
        f"child {child['launches']}; the same history in both={bf_same}; "
        f"median step {s['median_s']:.4f}s here, {c['median_s']:.4f}s in "
        f"the child, phase 45 {pipe_summary['median_s']:.4f}s "
        f"({s['median_s'] / pipe_summary['median_s']:.3f}x); "
        f"{s['tok_s']:.1f} train tok/s vs {pipe_summary['tok_s']:.1f}; peak "
        f"{s['peak_gib']:.2f} GiB here, {c['peak_gib']:.2f} GiB in the "
        f"child (each process's own allocator), phase 45 "
        f"{pipe_summary['peak_gib']:.2f} GiB")
    if not bf_same:
        raise AssertionError("pipeline mpmd: the two processes' bf16 "
                             "histories differ")
    for name, h in got["handoffs"].items():
        leg = h["round_trip_s"] / 2
        log(f"[pipeline mpmd] hand-off {name}: {h['bytes'] / 1e6:.3f} MB, "
            f"round trip {h['round_trip_s'] * 1e3:.3f} ms (median of "
            f"{HANDOFF_REPEATS}), {leg * 1e3:.3f} ms a leg, "
            f"{h['bytes'] / leg / 1e9:.3f} GB/s; echoes exact={h['exact']}")
        if not h["exact"]:
            raise AssertionError(f"pipeline mpmd: the {name} hand-off is "
                                 "not exact")
    return {k: got["launches"][k] + child["launches"][k]
            for k in got["launches"]}


def path_rows(rows, src_path, names, suffix, path):
    """Rows of the kernel JSON repeated for a new path: for each kernel in
    ``names``, the first row of ``src_path`` whose source it is, renamed
    ``{kernel}_{suffix}`` and read from ``path``'s run."""
    out = []
    for k in names:
        row = next((r for r in rows if r["path"] == src_path
                    and os.path.basename(r["source"])[:-len(".cu")] == k),
                   None)
        if row is not None:
            out.append(dict(row, name=f"{k}_{suffix}", path=path))
        elif DEVICE == "cuda":        # off the card there are no rows
            raise AssertionError(f"no {src_path} row of {k} to repeat for "
                                 f"{path}")
    return out


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    # this script alone: it runs every phase in one process, and without
    # expandable segments the caching allocator's blocks of the earlier
    # phases fragment the card, so that recurrentgemma-2b's train step
    # (61.49 GiB at its peak) ran out of memory with 25.89 GiB reserved and
    # unallocated.  Set before torch is imported; the port's entry points
    # and train_depth.py (which imports this module) leave the allocator
    # as it is.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import repro_torch  # noqa: F401  (the port must be here, card or not)
    import numpy as np
    import torch
    t0 = time.perf_counter()
    smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch)
    serve_summary = {}
    launches, serve, prompts = timed("serve", phase_serve, torch, np, None,
                                     serve_summary)
    timed("profile", phase_profile, torch, serve, prompts)
    del serve
    dense_launches, gen, gen_prompts = timed("dense", phase_dense, torch, np)
    timed("dense profile", phase_dense_profile, torch, gen, gen_prompts)
    del gen
    launches.update(dense_launches)
    cfg32, params32, id_prompts, fused, scfg = timed(
        "identity", phase_identity, torch, np)
    timed("dense identity", phase_dense_identity, torch, np, cfg32, params32)
    timed("composed", phase_composed, torch, cfg32, params32, id_prompts,
          fused, scfg)
    timed("preempt", phase_preempt, torch, np, cfg32, params32, "preempt",
          True)
    del params32
    moe_summary = {}
    moe_launches, serve, ds_prompts = timed("moe serve", phase_moe_serve,
                                            torch, np, None, moe_summary)
    timed("moe profile", phase_profile, torch, serve, ds_prompts, DS_NEW,
          "moe profile")
    del serve
    torch.cuda.empty_cache()
    timed("moe identity", phase_moe_identity, torch, np)
    torch.cuda.empty_cache()
    ssm_launches, serve, ssm_prompts = timed("ssm serve", phase_ssm_serve,
                                             torch, np)
    timed("ssm profile", phase_profile, torch, serve, ssm_prompts, SSM_NEW,
          "ssm profile")
    del serve
    ssm_gen_launches, gen, gen_prompts = timed(
        "ssm Generator", phase_ssm_generator, torch, np)
    del gen
    timed("ssm identity", phase_ssm_identity, torch, np)
    torch.cuda.empty_cache()
    rg_launches, serve, rg_prompts = timed("hybrid serve", phase_rg_serve,
                                           torch, np)
    timed("hybrid profile", phase_profile, torch, serve, rg_prompts, RG_NEW,
          "hybrid profile")
    del serve
    torch.cuda.empty_cache()
    rg_gen_launches = timed("hybrid Generator", phase_rg_generator, torch, np)
    torch.cuda.empty_cache()
    timed("hybrid identity", phase_rg_identity, torch, np)
    torch.cuda.empty_cache()
    train_record, train_summary = [], {}
    train_launches = timed("train", phase_train, torch, np, "qwen2-0.5b",
                           None, TRAIN_B, TRAIN_S, TRAIN_STEPS, "train", None,
                           None, train_record, "gshard", None, None,
                           train_summary)
    timed("train profile", phase_train_profile, torch)
    torch.cuda.empty_cache()
    timed("train identity", phase_train_identity, torch, np)
    torch.cuda.empty_cache()
    ds_train = (DS_ARCH, DS_TRAIN_LAYERS, DS_TRAIN_B, DS_TRAIN_S)
    ds_records = {"gshard": ([], {}), "ragged": ([], {})}
    ds_train_launches = timed("deepseek train", phase_train, torch, np,
                              *ds_train, DS_TRAIN_STEPS, "deepseek train",
                              None, None, ds_records["gshard"][0], "gshard",
                              None, None, ds_records["gshard"][1])
    torch.cuda.empty_cache()
    timed("deepseek train profile", phase_train_profile, torch, *ds_train,
          "deepseek train profile")
    torch.cuda.empty_cache()
    ds_ragged_launches = timed(
        "deepseek ragged train", phase_train, torch, np, *ds_train,
        DS_TRAIN_STEPS, "deepseek ragged train", None, None,
        ds_records["ragged"][0], "ragged", None, None,
        ds_records["ragged"][1])
    torch.cuda.empty_cache()
    timed("deepseek ragged train profile", phase_train_profile, torch,
          *ds_train, "deepseek ragged train profile", "ragged",
          GM_BWD_SHARES)
    torch.cuda.empty_cache()
    timed("deepseek train identity", phase_train_identity, torch, np,
          DS_ARCH, DS_TRAIN_ID_LAYERS, DS_TRAIN_ID_B, DS_TRAIN_ID_S,
          DS_TRAIN_ID_STEPS, "deepseek train identity")
    torch.cuda.empty_cache()
    # phases 29, 31 and 34's records: phase 38d's mesh runs are held to them
    train_records = {a: ([], {}) for a in (MG_ARCH, SSM_ARCH, RG_ARCH)}
    mg_train_launches = timed("musicgen train", phase_train, torch, np,
                              MG_ARCH, MG_LAYERS, MG_B, MG_S, MG_STEPS,
                              "musicgen train", None, None,
                              train_records[MG_ARCH][0], "gshard", None, None,
                              train_records[MG_ARCH][1])
    torch.cuda.empty_cache()
    timed("musicgen train identity", phase_train_identity, torch, np,
          MG_ARCH, MG_ID_LAYERS, MG_ID_B, MG_ID_S, MG_ID_STEPS,
          "musicgen train identity")
    torch.cuda.empty_cache()
    ssm_train = (SSM_ARCH, None, SSM_TRAIN_B, SSM_TRAIN_S)
    ssm_train_launches = timed("mamba2 train", phase_train, torch, np,
                               *ssm_train, SSM_TRAIN_STEPS, "mamba2 train",
                               None, None, train_records[SSM_ARCH][0],
                               "gshard", None, None,
                               train_records[SSM_ARCH][1])
    torch.cuda.empty_cache()
    timed("mamba2 train profile", phase_train_profile, torch, *ssm_train,
          "mamba2 train profile")
    torch.cuda.empty_cache()
    timed("mamba2 train identity", phase_train_identity, torch, np,
          SSM_ARCH, SSM_TRAIN_ID_LAYERS, SSM_TRAIN_ID_B, SSM_TRAIN_ID_S,
          TRAIN_ID_STEPS, "mamba2 train identity")
    torch.cuda.empty_cache()
    rg_train = (RG_ARCH, None, RG_TRAIN_B, RG_TRAIN_S)
    rg_train_launches = timed("recurrentgemma train", phase_train, torch, np,
                              *rg_train, RG_TRAIN_STEPS,
                              "recurrentgemma train", None, None,
                              train_records[RG_ARCH][0], "gshard", None,
                              None, train_records[RG_ARCH][1])
    torch.cuda.empty_cache()
    timed("recurrentgemma train profile", phase_train_profile, torch,
          *rg_train, "recurrentgemma train profile")
    torch.cuda.empty_cache()
    timed("recurrentgemma train identity", phase_train_identity, torch, np,
          RG_ARCH, RG_TRAIN_ID_LAYERS, RG_TRAIN_ID_B, RG_TRAIN_ID_S,
          TRAIN_ID_STEPS, "recurrentgemma train identity")
    torch.cuda.empty_cache()
    timed("pool", phase_pool, torch)
    torch.cuda.empty_cache()
    timed("train offload", phase_train_offload, torch, np)
    torch.cuda.empty_cache()
    # phases 39-40 before the one-rank group: phase 43 runs in it, held to
    # their records
    rl_summary = {}
    rl_launches = timed("rl", phase_rl, torch, np, rl_summary)
    torch.cuda.empty_cache()
    rl_id = timed("rl identity", phase_rl_identity, torch, np)
    torch.cuda.empty_cache()
    with one_rank_group() as mesh:
        mesh_launches = timed("train mesh", phase_train_mesh, torch, np,
                              mesh, train_record, train_summary)
        torch.cuda.empty_cache()
        serve_mesh_runs, serve_mesh_rows = timed(
            "serve mesh", phase_serve_mesh, torch, np, mesh, serve_summary)
        torch.cuda.empty_cache()
        ds_mesh_runs, ds_mesh_rows = timed(
            "deepseek mesh", phase_deepseek_mesh, torch, np, mesh,
            moe_summary, ds_records)
        torch.cuda.empty_cache()
        rec_mesh_runs, rec_mesh_rows = timed(
            "recurrent mesh", phase_recurrent_mesh, torch, np, mesh,
            serve_summary, train_records)
        torch.cuda.empty_cache()
        rl_mesh_launches = timed("rl mesh", phase_rl_mesh, torch, np, mesh,
                                 rl_summary, rl_id)
    torch.cuda.empty_cache()
    ds_rl_launches = timed("rl moe", phase_rl_moe, torch, np)
    torch.cuda.empty_cache()
    timed("ragged train identity", phase_train_identity, torch, np,
          DS_ARCH, DS_RAGGED_ID_LAYERS, DS_TRAIN_ID_B, DS_TRAIN_ID_S,
          DS_RAGGED_ID_STEPS, "ragged train identity", "ragged")
    torch.cuda.empty_cache()
    disagg_launches, disagg_rows = timed("disagg serve", phase_disagg_serve,
                                         torch, np, serve_summary, fused)
    torch.cuda.empty_cache()
    rl_disagg_launches = timed("rl disagg", phase_rl_disagg, torch, np,
                               rl_summary, rl_id)
    del rl_id
    torch.cuda.empty_cache()
    pipe_f32, pipe_launches, pipe_summary = timed(
        "pipeline", phase_pipeline, torch, np, train_record, train_summary)
    torch.cuda.empty_cache()
    pipe_mpmd_launches = timed("pipeline mpmd", phase_pipeline_mpmd, torch,
                               np, pipe_f32, pipe_summary)
    del pipe_f32
    runs = {"qwen2-0.5b": launches, DS_ARCH: moe_launches,
            SSM_ARCH: ssm_launches, f"{SSM_ARCH} Generator": ssm_gen_launches,
            RG_ARCH: rg_launches, f"{RG_ARCH} Generator": rg_gen_launches,
            "qwen2-0.5b train": train_launches,
            f"{DS_ARCH} train": ds_train_launches,
            f"{DS_ARCH} ragged train": ds_ragged_launches,
            f"{MG_ARCH} train": mg_train_launches,
            f"{SSM_ARCH} train": ssm_train_launches,
            f"{RG_ARCH} train": rg_train_launches,
            "qwen2-0.5b rl": rl_launches, f"{DS_ARCH} rl": ds_rl_launches,
            "qwen2-0.5b mesh train": mesh_launches, **serve_mesh_runs,
            **ds_mesh_runs, **rec_mesh_runs,
            "qwen2-0.5b disagg": disagg_launches,
            "qwen2-0.5b rl mesh": rl_mesh_launches,
            "qwen2-0.5b rl disagg": rl_disagg_launches,
            "qwen2-0.5b pipeline": pipe_launches,
            "qwen2-0.5b pipeline mpmd": pipe_mpmd_launches}
    # the mesh run launches flash at phase 23's shapes: its rows are phase
    # 3's rows of that shape, with the mesh run's launches
    rows += [dict(row, name=row["name"] + "_mesh",
                  path="qwen2-0.5b mesh train")
             for row in rows if row["path"] == "qwen2-0.5b train"]
    rows += serve_mesh_rows + ds_mesh_rows + rec_mesh_rows + disagg_rows
    # phases 42-44 launch the kernels of phase 4's serving and of phase
    # 23's train step at those shapes: their rows, with these runs'
    # launches (phase 42's dense prefill has its own flash row, above)
    serving, train = ("paged_decode_attention", "ragged_prefill_attention"), \
        ("flash_attention", "flash_attention_bwd")
    rows += path_rows(rows, "qwen2-0.5b", ("paged_decode_attention",),
                      "disagg", "qwen2-0.5b disagg")
    for tag, path in (("rl_mesh", "qwen2-0.5b rl mesh"),
                      ("rl_disagg", "qwen2-0.5b rl disagg")):
        rows += (path_rows(rows, "qwen2-0.5b", serving, tag, path)
                 + path_rows(rows, "qwen2-0.5b train", train, tag, path))
    # phase 46 launches flash at phase 45's micro-batch: those rows, with
    # both processes' launches
    rows += path_rows(rows, "qwen2-0.5b pipeline", train, "pipeline_mpmd",
                      "qwen2-0.5b pipeline mpmd")
    for row in rows:
        if row["path"] is not None:     # None: timed in phase 3 only
            name = row["name"].removesuffix("_mesh")
            key = (name if name in SOURCE_OF else
                   os.path.basename(row["source"])[:-len(".cu")])
            row["launches"] = runs[row["path"]][key]
    log(f"[time] all phases: {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mpmd-child"]:
        sys.exit(mpmd_child(*sys.argv[2:5]))
    sys.exit(main())
